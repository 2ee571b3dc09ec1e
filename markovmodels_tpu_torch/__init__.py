"""markovmodels_tpu_torch — the lattice-inference engine on PyTorch and CUDA.

The port of ``markovmodels_tpu`` to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  The host layer (FSMs, semirings, labels, FSM
operations, n-gram LMs, host sparse algebra, the native host runtime and
the benchmark workload graphs) is the package's own copy of the JAX
package's, and ``oracle`` its own copy of the benchmark's float64 host
oracles; this package adds the device side: ``compile_fsm`` to tensors on
the card, or on the CPU when asked ('dense', 'block', 'banded', 'ell' and 'segment', in
the probability or the log domain; 'auto', the default, picks 'dense' for
graphs of up to 4,096 states as the JAX package does), ``stack`` /
``batch`` of graphs of any strategy but 'block' (e.g. per-utterance
numerator lattices), the batched forward-backward (``pdfposteriors``,
``forward``), and the LF-MMI training step: ``logmarginal`` and
``lfmmi_loss``, differentiable in the log-likelihoods with the posterior
gradient γ_den - γ_num.  On the GPU the probability-domain step runs
through hand-written CUDA kernels: the dense denominator scan (K6a/K6b) or
the blocked one (K2-K4), and the stacked-banded numerator scan (K5a/K5b).
Log-domain graphs, 'segment' and 'ell' graphs and the per-graph route of
stacked graphs take the plain PyTorch log-space scan on every device, as
the JAX package runs them outside any Pallas kernel.  ``viterbi`` (alias
``best_path``) decodes the best path: of a 'dense' or 'block' graph
through the fused tropical sweeps (K7, K7n, K6t) and their walks, of any
other graph, and per graph of a stacked one (forced alignment of stacked
numerators), through the log-domain tropical scan with int32
backpointers; ``maxstateposteriors`` gives every state's tropical α⊙β.
``expand``, ``alpha_recursion`` and ``beta_recursion`` are the reference's
expansion and full log-domain messages.

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
    alpha_recursion,
    batch,
    beta_recursion,
    compile_fsm,
    compiled_from_numpy,
    expand,
    fast_path_report,
    forward,
    lfmmi_loss,
    logmarginal,
    pdfposteriors,
    stack,
)
from .viterbi import best_path, maxstateposteriors, viterbi

__version__ = "0.1.0"

__all__ = [
    "algorithms", "fsm", "fsmops", "hostsparse", "labels", "lmfsm",
    "native", "oracle", "semiring", "workloads", "LOG", "PROB", "TROPICAL",
    "CompiledFSM", "compile_fsm", "compiled_from_numpy", "stack", "batch",
    "pdfposteriors", "forward", "logmarginal", "lfmmi_loss",
    "fast_path_report", "expand", "alpha_recursion", "beta_recursion",
    "viterbi", "best_path", "maxstateposteriors",
]
