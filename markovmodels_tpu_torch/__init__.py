"""markovmodels_tpu_torch — the lattice-inference engine on PyTorch and CUDA.

The port of ``markovmodels_tpu`` to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  The host layer (FSMs, semirings, labels, FSM
operations, n-gram LMs, host sparse algebra, the native host runtime and
the benchmark workload graphs) is the package's own copy of the JAX
package's, and ``oracle`` its own copy of the benchmark's float64 host
oracles; this package adds the device side: ``compile_fsm`` to tensors on
the card, or on the CPU when asked ('dense', 'block' and 'banded'; 'auto', the default, picks 'dense'
for graphs of up to 4,096 states as the JAX package does), ``stack`` /
``batch`` of 'banded' numerator graphs and of 'dense' graphs, the batched
forward-backward (``pdfposteriors``, ``forward``), and the LF-MMI training
step: ``logmarginal`` and ``lfmmi_loss``, differentiable in the
log-likelihoods with the posterior gradient γ_den - γ_num.  On the GPU the
step runs through hand-written CUDA kernels: the dense denominator scan
(K6a/K6b) or the blocked one (K2-K4), and the stacked-banded numerator scan
(K5a/K5b).  ``viterbi`` (alias ``best_path``) decodes the best path of a
'block' graph through the fused tropical sweep (K7) and a backtrace walk.

This package imports ``torch`` and never ``jax`` nor the JAX package.
"""

from . import (  # noqa: F401  (host layer)
    algorithms,
    fsm,
    fsmops,
    hostsparse,
    labels,
    lmfsm,
    native,
    oracle,
    semiring,
    workloads,
)
from .semiring import LOG, PROB, TROPICAL  # noqa: F401

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
from .viterbi import best_path, viterbi

__version__ = "0.1.0"

__all__ = [
    "algorithms", "fsm", "fsmops", "hostsparse", "labels", "lmfsm",
    "native", "oracle", "semiring", "workloads", "LOG", "PROB", "TROPICAL",
    "CompiledFSM", "compile_fsm", "compiled_from_numpy", "stack", "batch",
    "pdfposteriors", "forward", "logmarginal", "lfmmi_loss",
    "fast_path_report", "viterbi", "best_path",
]
