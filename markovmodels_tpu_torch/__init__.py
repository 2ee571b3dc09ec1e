"""markovmodels_tpu_torch — the lattice-inference engine on PyTorch and CUDA.

The port of ``markovmodels_tpu`` to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  The JAX-free host layer (FSMs, semirings, labels, FSM
operations, n-gram LMs, host sparse algebra, the native host runtime and
the benchmark workload graphs) is shared with the JAX package and
re-exported here; this package adds the device side: ``compile_fsm`` to
tensors ('dense', 'block' and 'banded'; 'auto', the default, picks 'dense'
for graphs of up to 4,096 states as the JAX package does), ``stack`` /
``batch`` of 'banded' numerator graphs and of 'dense' graphs, the batched
forward-backward (``pdfposteriors``, ``forward``), and the LF-MMI training
step: ``logmarginal`` and ``lfmmi_loss``, differentiable in the
log-likelihoods with the posterior gradient γ_den - γ_num.  On the GPU the
step runs through hand-written CUDA kernels: the dense denominator scan
(K6a/K6b) or the blocked one (K2-K4), and the stacked-banded numerator scan
(K5a/K5b).

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
    batch,
    compile_fsm,
    compiled_from_numpy,
    fast_path_report,
    forward,
    lfmmi_loss,
    logmarginal,
    pdfposteriors,
    stack,
)

__version__ = "0.1.0"

__all__ = [
    "algorithms", "fsm", "fsmops", "hostsparse", "labels", "lmfsm",
    "native", "semiring", "workloads",
    "CompiledFSM", "compile_fsm", "compiled_from_numpy", "stack", "batch",
    "pdfposteriors", "forward", "logmarginal", "lfmmi_loss",
    "fast_path_report",
]
