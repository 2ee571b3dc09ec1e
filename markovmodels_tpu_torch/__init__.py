"""markovmodels_tpu_torch — the lattice-inference engine on PyTorch and CUDA.

The port of ``markovmodels_tpu`` to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  The JAX-free host layer (FSMs, semirings, labels, FSM
operations, n-gram LMs, host sparse algebra, the native host runtime and
the benchmark workload graphs) is shared with the JAX package and
re-exported here; this package adds the device side: ``compile_fsm`` to
tensors and the batched denominator forward-backward (``pdfposteriors``,
``forward``) over the blocked operator.

This package imports ``torch`` and never ``jax``.
"""

from markovmodels_tpu import (  # noqa: F401  (host layer, re-exported)
    algorithms,
    fsm,
    fsmops,
    hostsparse,
    labels,
    lmfsm,
    native,
    semiring,
    workloads,
)

from .inference import (
    CompiledFSM,
    compile_fsm,
    compiled_from_numpy,
    fast_path_report,
    forward,
    pdfposteriors,
)

__version__ = "0.1.0"

__all__ = [
    "algorithms", "fsm", "fsmops", "hostsparse", "labels", "lmfsm",
    "native", "semiring", "workloads",
    "CompiledFSM", "compile_fsm", "compiled_from_numpy",
    "pdfposteriors", "forward", "fast_path_report",
]
