#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``markovmodels_tpu_torch``).

Drives the port's main paths at B=128 sequences × N=700 frames: first the
LF-MMI training step, ``lfmmi_loss`` of 128 stacked 'banded' numerator lattices
(78 states each, the shape ``bench.py`` builds) against the 2M-arc
trigram-LM ∘ HMM denominator (49,153 states, 2,195,457 arcs, 384 pdfs),
with the gradient in the log-likelihoods, through the hand-written CUDA
kernels K2-K4 of ``markovmodels_tpu_torch/ops/csrc/block_scan.cu`` (the
denominator) and K5a/K5b of ``.../csrc/banded_scan.cu`` (the numerators);
then the same step against a 'dense' denominator (the V=32 LM ∘ HMM graph:
3,073 states, 38,913 arcs, 96 pdfs, within 6 % of the WSJ denominator's
padded width) through K6a/K6b of ``.../csrc/dense_scan.cu``; then the
Viterbi decode of the 2M-arc graph through K7 and the backtrace walk of
``.../csrc/vit_scan.cu``; then the training step against the separate-state
backoff LM ∘ HMM denominator (V=128, 10 % of the trigrams kept: 49,537
states, 339,895 arcs, 384 pdfs), which ``compile_fsm``'s default lowers to
the capped/overflow layout, through the overflow branch of K2-K4, in
phases:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from the sources in the checkout (nvcc, sm_90a);
3. build the graph and compile it onto the card (strategy 'block',
   precision 'high');
4. each kernel against its plain PyTorch twin on the same inputs, at the
   main-path graph with B=128 and N=128 (a mid-sequence chunk boundary,
   mixed lengths, ±30-nat emission cliffs), K2, K3 and K4 run twice:
   bit-equal;
5. ``pdfposteriors`` at B=2, N=40 against the exact float64 host oracle
   (the port's ``oracle.host_oracle``): |ΔlogZ| and |Δposts| ≤ 1e-4;
6. the denominator ``pdfposteriors`` at B=128, N=700 with launch counters,
   output checks, and the kernel path timed beside the plain PyTorch scan;
7. K5a and K5b against their plain twins at the numerators' main shape
   (G=128 lattices, Sp=80, N=700; ragged lengths with infeasible ones and
   a length of 1, ±30-nat emission cliffs), each run twice and bit-equal,
   K5b's posteriors outside each graph's plan exactly 0, and the
   admission's shared-memory figures equal to the kernels' own;
8. stacked-numerator ``pdfposteriors`` against the f64 oracle: 4 chain
   lattices at N=40, then 4 with skip arcs (three band offsets, up to 130
   states) at N=150, where K5a and K5b are held to their twins too;
9. the training step at B=128, N=700 with launch counters (K2-K5b), the
   gradient against γ_den - γ_num, and its time beside the denominator's;
   a ``torch.profiler`` breakdown of one step (K5a's and K5b's device
   time and share) and of one den-only ``pdfposteriors``:
   exactly one K2 launch and one K3 and one K4 launch per 64-frame chunk
   (the persistent ``fwd_chunk_kernel`` and ``bwd_chunk_kernel``) and no
   per-frame step or finalize launch; K2 over the N=700 sweep, K3 and K4
   over its last chunk, each split into its parts (the whole operator, no
   tier, no bands or families, neither: the frame without work);
10. the V=32 graph compiled with the default strategy ('auto' -> 'dense',
    precision 'high');
11. K6a and K6b against their plain twins at B=128, N=700, Sp=3,200 (mixed
    lengths with 1 and N, ±30-nat emission cliffs), each run twice and
    bit-equal; then on a random fully dense operator at Sp=4,096, whose
    tiles do not fit shared memory and stream every frame: whole sweeps
    in float32 at N=128, and the bf16 kernels one frame at a time;
12. dense ``pdfposteriors`` at B=2, N=40 against the f64 oracle;
13. phase 7's checks and the K5 timings on the dense step's numerators
    (P=96); the training step with the dense denominator and 128 stacked
    numerators at B=128, N=700: exactly one launch each of K5a, K5b, K6a and
    K6b and no other kernel, the gradient against γ_den - γ_num, its time
    beside the denominator's, and a ``torch.profiler`` breakdown (one
    sweep launch per direction, no finalize launch); then K6a/K6b timed
    beside ``torch.matmul`` and ``torch.sparse.mm`` of their product, the
    bounds, and a frame without the product (an all-zero operator);
14. four stacked non-banded 'dense' graphs (B = G = 4) through the
    per-graph route on the card against the f64 oracle;
15. K7 and the walk against their plain twins at the 2M-arc graph, B=128,
    N=128 (mixed lengths with 1 and N, ±30-nat cliffs): ids and omega
    argmaxes bit-equal, scores within 1e-5;
16. ``viterbi`` at B=2, N=40 against the f64 max-plus optimum
    (``oracle.host_viterbi_score``): |Δscore| ≤ 1e-3, the decoded paths'
    f64 weight within 1e-4 of it;
17. the decode at B=128, N=700 with launch counters, every path walked in
    float64 (``oracle.validate_paths``, gap < 2e-3), the sweep and the walk
    timed apart, audio-s/s, and the plain twins timed beside them and held
    to the kernels at this shape (ids, omega argmaxes and walked states
    bit-equal, scores within 1e-5);
18. the separate-state graph compiled with the default arguments onto the
    card ('block', ``ov_layout`` (128, 3)) and its fast-path report;
19. K2, K3 and K4 against their plain twins on it at B=128, N=128 (lengths
    1 and N mixed, ±30-nat cliffs), each run twice: bit-equal;
20. its ``pdfposteriors`` at B=2, N=40 against the f64 oracle;
21. the training step with it and the 128 stacked numerators at B=128,
    N=700: exact launch counts (K2 1, K3 and K4 once per chunk, K5a 1,
    K5b 1, no other kernel), the gradient against γ_den - γ_num, its time
    beside den-only ``pdfposteriors`` and beside the embedded layout's
    den-only ``pdfposteriors`` (the same LM with its backoff states on the
    diagonal of the trigram rows), and the separate/embedded ratio
    (printed; ``bench.py`` holds the JAX package's under 1.2); the
    den-only profile and the frame splits of phase 9 on this graph;

then ``precision='bf16'`` (``BASELINE.json`` config 4, the mixed-precision
scan): the tier of K2-K4 and the product of K6a/K6b on bf16 operands on
the tensor cores, float32 everywhere else:

22. the 2M-arc, separate-state and V=32 graphs compiled with
    ``precision='bf16'``; their fast-path reports;
23. the bf16 K2, K3 and K4 against their plain twins (which round the same
    operands), on the 2M-arc graph and on the separate-state graph (the
    overflow branch), with the bf16 launch counters: one frame at a time
    from the same state, where both round the same values (1e-4), then
    over whole sweeps at B=128, N=128, where each rounds its own float32
    state (TOL_KERNEL_BF16; K2-K4 twice, bit-equal, on both graphs);
24. the bf16 K6a and K6b likewise, the sweeps at B=128, N=128 and N=700;
25. ``pdfposteriors`` at B=2, N=700 (lengths N and 2N/3, ``bench.py``'s
    shape) against the f64 oracle, run once per graph for its 'high' and
    its bf16 compile: 'high' within 1e-3 in logZ and 1e-4 in the
    posteriors (``bench.py:380-392``), bf16 within 2e-3 / 1e-3 on the
    'block' graphs (``bench.py:507-525``) and 2e-2 / 5e-3 on the 'dense'
    one; every reading printed beside the 1e-4 contract;
26. the training step with the bf16 2M-arc denominator at B=128, N=700:
    only bf16 K2-K4 launched (and K5a/K5b), the gradient against
    γ_den - γ_num;
27. the same with the bf16 separate-state denominator, and 28. with the
    bf16 dense one (K6a/K6b, exact counts and profiled as in 13);
29. the step and den-only ``pdfposteriors``, bf16 beside f32, medians of 5
    warm runs in turns, and their ratios (printed: ``bench.py`` requires
    bf16 < f32 of the JAX package; here a slow kernel stays and is
    written down), a ``torch.profiler`` breakdown of the bf16 den-only
    runs (on the block graphs with phase 9's launch checks); then each bf16
    kernel and its twin timed and held to it at N=700, the frame splits on both
    bf16 block graphs, and the bf16 ``torch.mm`` yardstick of K6;
30. Viterbi of the bf16 2M-arc graph: K7's ids, ω argmaxes and scores
    bit-equal to the 'high' graph's at B=128, N=128 (K7 takes float32
    panels on any graph).

Every kernel's entry in the JSON line carries its bound: the larger of its
operations over the card's peak rate for their type and its bytes over the
memory bandwidth (H100 SXM data sheet), computed from this run's shapes.

Needs one CUDA card; exits non-zero before printing any result when there
is none or when any phase fails.  Run from the root of the checkout:

    python3 chip_smoke.py

The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

FRAME_SHIFT_S = 0.03
# Kernel vs plain twin (phase 4): the same math with float32 sums taken in
# another order (the tier's 128-term products, per-tile partial sums, the
# atomic posterior group sums), compounded over up to 129 frames.  States
# are compared after normalising each column to max 1..2.
TOL_KERNEL = 1e-4
TOL_ORACLE = 1e-4  # the repo's f64-oracle gate (bench.py, BASELINE.md)
TOL_POST_SUM = 1e-4  # per-frame posterior mass of a feasible sequence
# K5 vs plain twin (phase 7): float32 sums in another order (fused
# multiply-adds, the warp-shuffle omega dot and gamma sum, shared-memory
# atomics for repeated pdfs), compounded over 701 frames; states compared
# after normalising each column to max 1
TOL_K5 = 1e-4
TOL_GRAD = 1e-5  # lhs.grad vs posts_den - posts_num from separate calls
TOL_GRAD_SUM = 1e-4  # the gradient's sum over pdfs on an active frame
# K6 vs plain twin (phase 11): float32 sums of the 3,200-term products and
# of the per-pdf posterior sums in another order, compounded over 701
# frames; states compared after normalising each (frame, column) to max 1
TOL_K6 = 1e-4
# K7 vs plain twin (phase 15): the same float32 products and compares, so
# the ids and the omega argmaxes must be bit-equal; the scores are then
# equal too (the bound allows for the log and the ksum·ln2 split only)
TOL_VIT = 1e-5
TOL_VIT_ORACLE = 1e-3  # |dscore| vs the f64 max-plus optimum (bench.py gate)
TOL_VIT_PATH = 1e-4  # a decoded path's f64 weight vs that optimum
TOL_VIT_WALK = 2e-3  # path weight vs the device score over 700 frames
# 'high' logZ at B=2 N=700 against the f64 oracle: float32 round-off grows
# ~linearly in N (bench.py:380-392 gates the JAX package at 1e-3); the
# posteriors keep TOL_ORACLE
TOL_ORACLE_700 = 1e-3
# bf16 at B=2 N=700 against the f64 oracle: bench.py:507-525's gate of the
# mixed-precision mode on 'block' graphs, whose bf16 tier carries only the
# word-to-word arcs ...
TOL_BF16_LOGZ, TOL_BF16_POSTS = 2e-3, 1e-3
# ... while a 'dense' graph rounds every arc weight and state every frame:
# ~7e-3 in logZ on the WSJ graph by the JAX package's own account
# (semiring_ops.py:119-121)
TOL_DENSE_BF16_LOGZ, TOL_DENSE_BF16_POSTS = 2e-2, 5e-3
# A bf16 kernel against its twin over a whole sweep: the two round their own
# float32 states, which differ in the last bits (sums in another order), so
# now and then a state element rounds to the neighbouring bf16 value, a
# step of up to 2^-7 of its term; where one term dominates a posterior
# (<= 1) or a normalised state, that moves it by up to ~7.8e-3.  The same
# kernels from the same inputs, one frame at a time, where both round the
# same values, are held to TOL_KERNEL (phases 23 and 24, first).
TOL_KERNEL_BF16 = 1e-2

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense, outside
# the tensor cores for the float types the kernels compute in) for the
# kernels' bounds: the larger of operations / peak and bytes / bandwidth.
PEAK_F32 = 67e12  # float32 FLOP/s
PEAK_F64 = 34e12  # float64 FLOP/s (K5a/K5b keep their state in float64)
# float32 instructions that are not FMAs (a multiply, a compare, a select):
# one per lane and clock, half the FMA FLOP rate
PEAK_F32_OPS = PEAK_F32 / 2
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s


def bound(flops, nbytes, peak=PEAK_F32, tc_flops=0):
    """(bound_ms, bound_by): the least time the card could take for work of
    ``flops`` operations at ``peak`` plus ``tc_flops`` bf16 tensor-core
    operations on ``nbytes`` bytes (each input read once, each output
    written once)."""
    t_ops, t_bytes = flops / peak + tc_flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def block_bounds(cf, B, Npad, chunk):
    """K2 over Npad frames, K3 and K4 over one chunk, as timed: the tier's
    multiply-adds, the bands, the overflow-family terms, the omega dot, the
    emission and the rescale (forward), plus gamma and its pdf sums
    (backward).  The operator's bytes include the per-row pdf table (the
    per-lane emissions of the overflow rows), the family terms and, for
    K4, each pdf's list of overflow rows.  A bf16 graph's tier runs on the
    tensor cores (PEAK_BF16) over panels of 2 bytes."""
    from markovmodels_tpu_torch.ops import block_scan as bs

    kop = bs.kernel_operator(cf)
    K, Sm, D = kop.fwd.W.shape
    nO, Sp, P1 = len(kop.fwd.offsets), kop.Sp, kop.P1
    nf_f, nf_b = kop.fwd.fam_dst.numel(), kop.bwd.fam_dst.numel()
    n_ov = kop.ov_hi - kop.ov_lo
    wb = kop.fwd.W.element_size()
    tier = B * 2 * K * Sm * D

    def op(nf):
        return wb * K * Sm * D + 4 * (nO * Sp + Sp + 2 * Sp + 1 + 2 * nf)

    fwd = B * (2 * nO * Sp + 2 * nf_f + 4 * Sp)
    bwd = B * (2 * nO * Sp + 2 * nf_b + 6 * Sp)
    tc = wb == 2  # the tier on the tensor cores
    fwd, bwd, ttc = ((fwd, bwd, tier) if tc
                     else (fwd + tier, bwd + tier, 0))
    C = Npad // chunk
    return {
        "K2": bound(Npad * fwd, op(nf_f) + 4 * (Sp * B + Npad * (P1 + 1) * B
                                                + C * (Sp + 1) * B + Sp * B
                                                + 3 * B),
                    tc_flops=Npad * ttc),
        "K3": bound(chunk * fwd, op(nf_f) + 4 * (Sp * B + B + chunk * P1 * B
                                                 + chunk * (Sp + 1) * B),
                    tc_flops=chunk * ttc),
        "K4": bound(chunk * bwd, op(nf_b) + 4 * (Sp * B + B
                                                 + chunk * (Sp + 1) * B
                                                 + 2 * chunk * P1 * B
                                                 + Sp * B + B + P1 + 1
                                                 + n_ov),
                    tc_flops=chunk * ttc),
    }


def banded_bounds(num_cf, Nf):
    """K5a and K5b over the Nf-frame sweep of G lattices: float64 state;
    each state's emission gathered once per frame."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    Sp, G, P1, nO = kop.Sp, kop.G, kop.P1, len(kop.offsets)
    op = 4 * (2 * nO * Sp * G + 3 * Sp * G)
    emis = 4 * Nf * Sp * G
    return {
        "K5a": bound(Nf * G * (2 * nO * Sp + 4 * Sp),
                     op + emis + 4 * Nf * G + 8 * Nf * Sp * G + 24 * G,
                     PEAK_F64),
        "K5b": bound(Nf * G * (2 * nO * Sp + 5 * Sp),
                     op + emis + 8 * Nf * Sp * G + 4 * Nf * P1 * G,
                     PEAK_F64),
    }


def dense_bounds(dcf, B, Nf, dense=False):
    """K6a and K6b over the Nf-frame sweep: per frame the product over the
    operator's non-zero entries (what these inputs need: a zero weight adds
    nothing), the emission, rescale and posterior work; a bf16 graph's
    product on the tensor cores (PEAK_BF16).  The operator is read once as
    a CSR (each non-zero with a 4-byte column index, the row pointers).
    With ``dense``: the dense-equivalent bound of the full (Sp, Sp)
    product over the dense operator, as if no entry were zero."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    Sp, P1 = kop.Sp, kop.P1
    wb = kop.wf.element_size()
    out = {}
    for name, w, extra, state_bytes in (
            ("K6a", kop.wf, 3, Sp * B + Nf * (P1 + 1) * B
             + Nf * (Sp + 1) * B + 3 * B),
            ("K6b", kop.wb, 5, Nf * (Sp + 1) * B + 2 * Nf * P1 * B)):
        nnz = Sp * Sp if dense else int(torch.count_nonzero(w))
        op = wb * nnz if dense else (wb + 4) * nnz + 4 * (Sp + 1)
        prod = Nf * B * 2 * nnz
        f32, tc = (0, prod) if wb == 2 else (prod, 0)
        out[name] = bound(f32 + Nf * B * extra * Sp, op + 4 * state_bytes,
                          tc_flops=tc)
    return out


def vit_bounds(cf, B, Nf):
    """K7 over the Nf-frame sweep: per candidate (tier, bands over the main
    region) four instructions, none of which fuses into an FMA: the
    multiply, the compare, and the selects of the running max and of the
    winning id (a max instruction can take the value's select, but the id
    still needs the compare's predicate, so four is the least); per state
    the omega product and max, the emission multiply and the rescale; the
    ids written once.  The walk: per frame and sequence one id, two table
    reads and one state written (what this decode reads)."""
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs

    kop = bs.kernel_operator(cf)
    K, Sm, D = kop.fwd.W.shape
    nO, Sp, P1 = len(kop.fwd.offsets), kop.Sp, kop.P1
    RW = vs._main_region(cf)
    ops = Nf * B * (4 * K * Sm * D + 4 * nO * RW + 2 * Sp + 2 * Sp)
    nbytes = (4 * (K * Sm * D + nO * Sp + 2 * Sp + Nf * (P1 + 1) * B)
              + Nf * RW * B + 4 * Nf * B + 12 * B)
    return {"K7": bound(ops, nbytes, PEAK_F32_OPS),
            "K7w": bound(0, (Nf - 1) * B * (1 + 4 + 4 + 4) + 8 * B)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1, warm=True):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    (unless ``warm`` is False), timed with CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(fn):
    """Where one warm call of ``fn`` spends the card's time, from
    torch.profiler's device events: ({kernel: ms}, busy ms, span ms,
    {kernel: launches}), the span running from the first device event's
    start to the last one's end; None when the profiler records no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    def short(name):  # "void ns::k<...>(args)" -> "k<...>"
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
        return (m.group(1) if m else name)[:60]

    spans = sorted((e.time_range.start, e.time_range.end, short(e.name))
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    by_name, counts = {}, {}
    for t0, t1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
        counts[name] = counts.get(name, 0) + 1
    busy, (lo, hi) = 0.0, spans[0][:2]
    for t0, t1, _ in spans[1:]:
        if t0 > hi:
            busy, lo, hi = busy + hi - lo, t0, t1
        else:
            hi = max(hi, t1)
    busy += hi - lo
    span = max(t1 for _, t1, _ in spans) - spans[0][0]
    return by_name, busy / 1e3, span / 1e3, counts


def make_inputs(rng, B, N, P, cliffs=False):
    lhs = (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)
    if cliffs:
        # +30 nats on plane-2 pdfs, unreachable before frame 2 (left-to-
        # right HMMs), on frames 0-1; -30 nats on every pdf but plane 0 at
        # one frame mid-sequence
        planes = np.arange(P).reshape(-1, 3)
        lhs[:, 0:2, planes[:, 2]] += 30.0
        lhs[:, N // 2, planes[:, 1:].ravel()] -= 30.0
    return lhs


def phase_kernels(cf, P, dev, B=128, N=128, chunk=64, label="phase 4",
                  twice=False, tol=TOL_KERNEL):
    """Phase 4 (19, 23): K2, K3 and K4 against their plain twins on one
    input; with ``twice``, every K2, K3 and K4 call runs again and must
    give bit-equal results (which CTA of a persistent grid runs an item
    changes from run to run)."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens_np = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens_np[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    lens = torch.from_numpy(lens_np).to(dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P)
    Nf = N + 1
    K = min(chunk, Nf)
    C = -(-Nf // K)
    Npad = C * K
    assert C >= 3, "need a mid-sequence chunk boundary"
    ext, msh = pad_emissions(ext, msh, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()

    def again(fn, out, name):
        """``fn`` run once more: bit-equal to ``out``."""
        if twice:
            assert all(torch.equal(x, y) for x, y in zip(out, fn())), \
                f"{name} differs run to run"
        return out

    errs = {}
    fn = lambda: bs.fwd_sweep(kop, a0, ext, msh, K)
    fk = again(fn, fn(), "K2")
    torch.cuda.synchronize()
    fp = bs.fwd_sweep_plain(kop, a0, ext, msh, K)
    zk, zp = sweep_logz(kop, fk), sweep_logz(kop, fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K2: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1], "K2: unexpected -inf pattern"
    errs["K2"] = sweep_err(kop, fk, fp)

    c = C // 2  # a chunk in the middle of the sequence
    sl = slice(c * K, (c + 1) * K)
    fn = lambda: bs.recompute(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    ak, sk = again(fn, fn(), "K3")
    torch.cuda.synchronize()
    ap, sp = bs.recompute_plain(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    errs["K3"] = float((scaled(ak, sk) - scaled(ap, sp)).abs().max())

    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev)
    for cc in reversed(range(C)):  # the backward over every chunk
        slc = slice(cc * K, (cc + 1) * K)
        fn = lambda: bs.recompute(kop, fk[0][cc], fk[1][cc], ext[slc], cc * K)
        al, asc = again(fn, fn(), "K3")
        fn = lambda: bs.backward(kop, beta, bsc, al, asc, ext[slc], cc * K,
                                 Npad)
        pk, bk, bsk = again(fn, fn(), "K4")
        torch.cuda.synchronize()
        pp, bp, bsp = bs.backward_plain(kop, beta, bsc, al, asc, ext[slc],
                                        cc * K, Npad)
        errs["K4"] = max(errs.get("K4", 0.0),
                         bwd_err((pk, bk, bsk), (pp, bp, bsp)))
        beta, bsc = bk, bsk
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain max |err| = {e:.3e} "
              f"(tol {tol:g})")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    if twice:
        print(f"{label}: K2 run twice, K3 and K4 twice on each of {C} "
              "chunks: bit-equal")
    return errs


def sweep_logz(kop, out):
    """logZ (B,) from a K2 sweep's outputs, as a numpy array, combined in
    float64: the shift and ksum·ln2 reach ~1e3 over 700 frames, where one
    float32 rounding of their sum (1.2e-4) would swamp the sweeps'
    difference."""
    from markovmodels_tpu_torch import inference as tinf

    _, _, a, s, ksum, shift = out
    v = a[kop.fin].double() * s.double()
    return tinf._combine_shift(tinf._log_final(v), ksum.double(),
                               shift.double()).cpu().numpy()


def scaled(a, s):
    """An unscaled state (.., Sp, B) times its scale (.., B)."""
    return a * s[..., None, :] if a.dim() == 3 else a * s[None, :]


def sweep_err(kop, fk, fp):
    """K2 against its twin: logZ where finite, checkpoints and last state."""
    zk, zp = sweep_logz(kop, fk), sweep_logz(kop, fp)
    fin = np.isfinite(zp)
    return max(
        float(np.abs(zk[fin] - zp[fin]).max(initial=0.0)),
        float((scaled(fk[0], fk[1]) - scaled(fp[0], fp[1])).abs().max()),
        float((scaled(fk[2], fk[3]) - scaled(fp[2], fp[3])).abs().max()),
    )


def bwd_err(k, p):
    """K4 against its twin: posteriors and the outgoing beta."""
    return max(float((k[0] - p[0]).abs().max()),
               float((scaled(k[1], k[2]) - scaled(p[1], p[2])).abs().max()))


def phase_oracle(fsm, spdf, cf, P, dev, n=40, label="phase 5"):
    """Phase 5 (12): pdfposteriors at B=2 against the exact f64 host
    oracle."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref_z, ref_p = mt.oracle.host_oracle(fsm, spdf, P,
                                         lhs.astype(np.float64), lens)
    posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                torch.from_numpy(lens).to(dev))
    err = float(np.abs(z.cpu().numpy() - ref_z).max())
    perr = float(np.abs(posts.cpu().numpy() - ref_p).max())
    print(f"{label}: B=2 N={n} vs f64 oracle |dlogZ| = {err:.3e}, "
          f"|dposts| = {perr:.3e} (tol {TOL_ORACLE:g})")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"


def phase_main(cf, P, dev, B=128, N=700):
    """Phase 6: the main path through the kernels, checked and timed."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import block_scan as bs

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    bs.reset_launch_counts()
    posts, logz = mt.pdfposteriors(cf, lhs, lengths)
    torch.cuda.synchronize()
    launches = dict(bs.LAUNCHES)
    print(f"phase 6: launches {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), "a kernel never launched"

    z = logz.cpu().numpy()
    p = posts.cpu().numpy()
    assert p.shape == (B, N, P) and z.shape == (B,), "output shapes"
    assert np.isfinite(z).all(), "non-finite logZ"
    assert np.isfinite(p).all() and (p >= 0).all(), "bad posteriors"
    mass = np.abs(p.sum(axis=2) - 1.0).max()
    print(f"phase 6: logZ in [{z.min():.3f}, {z.max():.3f}], "
          f"max |sum_p posts - 1| = {mass:.3e}")
    assert mass <= TOL_POST_SUM, "posteriors do not sum to 1"

    # ragged copy: zeros past each length
    lens2 = torch.from_numpy(
        rng.integers(N // 2, N + 1, size=B).astype(np.int32)).to(dev)
    p2, _ = mt.pdfposteriors(cf, lhs, lens2)
    p2 = p2.cpu().numpy()
    for b, L in enumerate(lens2.cpu().numpy()):
        assert (p2[b, L:] == 0).all(), "posteriors past the length"

    t_kern = cuda_ms(lambda: mt.pdfposteriors(cf, lhs, lengths), reps=2)
    t_plain = cuda_ms(
        lambda: tinf._fb_prob(cf, lhs, lengths, tinf._auto_chunk(cf, lhs),
                              True))
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 6: pdfposteriors B={B} N={N}: kernel path "
          f"{t_kern / 1e3:.4f} s = {audio / (t_kern / 1e3):.1f} audio-s/s; "
          f"plain torch path {t_plain / 1e3:.4f} s = "
          f"{audio / (t_plain / 1e3):.1f} audio-s/s")
    return launches, t_kern, t_plain


def time_kernels(cf, P, dev, B=128, N=700, chunk=64, tol=TOL_KERNEL):
    """Each kernel and its plain twin at the main path's shapes: K2 over
    all Npad frames, K3 and K4 over one 64-frame chunk; then each kernel
    held to its twin on these inputs.  Returns ({name: (kernel ms, plain
    ms)}, {name: max |err|})."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P)
    Nf = N + 1
    K = min(chunk, Nf)
    C = -(-Nf // K)
    ext, msh = pad_emissions(ext, msh, C * K)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, K)[:2]
    c = C - 1
    sl = slice(c * K, (c + 1) * K)
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev)
    calls = {
        "K2": (lambda: bs.fwd_sweep(kop, a0, ext, msh, K),
               lambda: bs.fwd_sweep_plain(kop, a0, ext, msh, K)),
        "K3": (lambda: bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K),
               lambda: bs.recompute_plain(kop, bounds[c], bscale[c], ext[sl],
                                          c * K)),
        "K4": (lambda: bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K,
                                   C * K),
               lambda: bs.backward_plain(kop, beta, bsc, al, asc, ext[sl],
                                         c * K, C * K)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: both orders on one card in one call
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms")
    res = {name: (kern(), plain()) for name, (kern, plain) in calls.items()}
    errs = {
        "K2": sweep_err(kop, *res["K2"]),
        "K3": float((scaled(*res["K3"][0]) - scaled(*res["K3"][1]))
                    .abs().max()),
        "K4": bwd_err(*res["K4"]),
    }
    for name, e in errs.items():
        print(f"timing: {name} kernel vs plain at B={B} N={N} (K2 over "
              f"{C * K} frames) max |err| = {e:.3e} (tol {tol:g})")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    return out, errs


def cut_operator(kop, tier=True, bands=True, direction="bwd"):
    """A copy of ``kop`` whose ``direction`` operator ('fwd': K2/K3's,
    'bwd': K4's) keeps the tier (``tier``) and the band offsets and family
    terms (``bands``): a timing probe of a kernel's parts, not the graph's
    function.  Without the tier, its rows become band rows (tiles of 64
    rows that skip the product)."""
    import torch

    kd = getattr(kop, direction)
    dev = kd.band_rows.device
    if not tier:
        rows = np.sort(np.concatenate([kd.band_rows.cpu().numpy(),
                                       kd.dst_rows.cpu().numpy().ravel()]))
        kd = kd._replace(W=kd.W[:0], src_rows=kd.src_rows[:0],
                         dst_rows=kd.dst_rows[:0],
                         band_rows=torch.from_numpy(
                             rows.astype(np.int32)).to(dev))
    if not bands:
        kd = kd._replace(offsets=(), band_w=kd.band_w[:0],
                         fam_ptr=torch.zeros_like(kd.fam_ptr),
                         fam_src=kd.fam_src[:0], fam_w=kd.fam_w[:0],
                         fam_dst=kd.fam_dst[:0])
    # a fresh plan cache; a copy of the package from before K4 kept plans
    # (timed by ab_block.py) has none
    extra = {"plans": {}} if "plans" in kop._fields else {}
    return kop._replace(**{direction: kd}, **extra)


def frame_split(cf, P, dev, label, B=128, N=700, chunk=64):
    """K2 over the N=700 sweep, and K3 and K4 over its last chunk
    (time_kernels' input), each on its whole operator and on three cut
    copies of it: without the tier product, without the bands and family
    terms, and without either (the frame without work: the epilogue, the
    statistics and the frame-to-frame dependency).  Prints and returns
    {kernel: {part: us per frame}}, CUDA events, mean of 3 warm runs
    each."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P)
    C = -(-(N + 1) // chunk)
    ext, msh = pad_emissions(ext, msh, C * chunk)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, chunk)[:2]
    c = C - 1
    sl = slice(c * chunk, (c + 1) * chunk)
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * chunk)
    beta, bsc = torch.ones_like(a0), torch.ones(B, device=dev)
    calls = {
        "K2": ("fwd", C * chunk, lambda op: bs.fwd_sweep(op, a0, ext, msh,
                                                         chunk)),
        "K3": ("fwd", chunk, lambda op: bs.recompute(
            op, bounds[c], bscale[c], ext[sl], c * chunk)),
        "K4": ("bwd", chunk, lambda op: bs.backward(
            op, beta, bsc, al, asc, ext[sl], c * chunk, C * chunk)),
    }
    out = {}
    for name, (direction, frames, call) in calls.items():
        out[name] = {}
        for part, cut in (
                ("whole", kop),
                ("no tier", cut_operator(kop, tier=False,
                                         direction=direction)),
                ("no bands/families", cut_operator(kop, bands=False,
                                                   direction=direction)),
                ("without work", cut_operator(kop, False, False,
                                              direction))):
            out[name][part] = 1e3 * cuda_ms(lambda: call(cut),
                                            reps=3) / frames
        grid = (bs._bwd_grid if direction == "bwd" else bs._fwd_grid)(
            kop, dev, B, kop.fwd.W.dtype)
        print(f"timing: {name} frame split on the {label}: " + "; ".join(
            f"{k} {v:.2f} us" for k, v in out[name].items())
            + f" per frame (over {frames} frames, {grid} CTAs)")
    return out


def profile_block_den(cf, P, dev, label, B=128, N=700, chunk=64):
    """One block den-only pdfposteriors under torch.profiler: its device
    time by kernel and idle share, printed; asserts exactly one K2 and one
    K3 launch per chunk (the persistent ``fwd_chunk_kernel``), one K4
    launch per chunk (``bwd_chunk_kernel``), and no per-frame step or
    finalize launch."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    prof = profile_device(lambda: mt.pdfposteriors(cf, lhs, lens))
    if prof is None:
        print(f"{label}: profile of the den-only pdfposteriors: not measured "
              "(no device events recorded)")
        return None
    by_name, busy, span, counts = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: profile of one den-only pdfposteriors: device busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle "
          f"{1 - busy / span:.1%}); " + "; ".join(
              f"{k} {v:.3f} ms ({counts[k]} launches)" for k, v in top))
    C = -(-(N + 1) // chunk)
    n = lambda prefix: sum(v for k, v in counts.items()
                           if k.startswith(prefix))
    assert n("fwd_chunk_kernel") == 1 + C, f"K2/K3 launches {counts}"
    assert n("bwd_chunk_kernel") == C, f"K4 launches {counts}"
    assert not any("finalize" in k or "step_kernel" in k for k in counts), \
        f"a per-frame launch: {counts}"
    return prof


def build_numerators(P, G=128, Lp=78, seed=3):
    """``bench.py``'s numerators: G linear lattices over random Lp-pdf
    sequences, self-loop and chain arcs at 0.5, final weight 0.5.
    Returns [(fsm, spdf)]."""
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(G):
        seq = rng.integers(0, P, size=Lp)
        arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)]
        fsm = mt.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [mt.labels.Label(int(s)) for s in seq], mt.semiring.LOG)
        out.append((fsm, np.append(seq, P).astype(np.int32)))
    return out


def stack_numerators(graphs, P, dev):
    import markovmodels_tpu_torch as mt

    return mt.stack([mt.compile_fsm(f, sp, P, strategy="banded", device=dev)
                     for f, sp in graphs])


def banded_inputs(num_cf, P, dev, N=700, seed=11):
    """Phase 7's input: ragged lengths with a length of 1 and a length of 60
    (both shorter than the 78-state lattice: infeasible) and one of exactly
    78 (a single path), ±30-nat cliffs."""
    import torch

    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    G = num_cf.alpha_hat.shape[0]
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, G, N, P, cliffs=True)).to(dev)
    lens = rng.integers(N // 2, N + 1, size=G).astype(np.int32)
    lens[:4] = [N, 1, 60, 78]
    ext, msh = prepare_emissions(lhs, torch.from_numpy(lens).to(dev), P)
    return ext, msh


def plan_mask(kop):
    """(P1, G) bool: the pdfs of each graph's K5b plan (its own pdfs)."""
    import torch

    from markovmodels_tpu_torch.ops import banded_scan as bsc

    n, pdf = (x.long() for x in bsc.plan_fields(kop.plan, kop.Sp)[:2])
    valid = torch.arange(kop.Sp, device=n.device)[None, :] < n[:, None]
    graph = torch.arange(kop.G, device=n.device)[:, None].expand_as(pdf)
    mask = torch.zeros((kop.P1, kop.G), dtype=torch.bool, device=n.device)
    mask[pdf[valid], graph[valid]] = True
    return mask


def phase_banded_kernels(num_cf, P, dev, label="phase 7"):
    """Phase 7 (and 13, on the dense step's numerators): K5a and K5b
    against their plain twins on one input, each run twice and bit-equal;
    K5b's posteriors outside each graph's plan exactly 0; the admission's
    shared-memory figures equal the kernels'."""
    import torch

    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    ext, msh = banded_inputs(num_cf, P, dev)

    def logz(vfin, shift, ksum):
        return tinf._combine_shift(tinf._log_final(vfin), ksum,
                                   shift).cpu().numpy()

    def norm(a):  # each (frame, graph) column over its max
        m = a.amax(dim=1, keepdim=True)
        return a / torch.where(m > 0, m, torch.ones_like(m))

    ak, *fk = bsc.fwd_sweep(kop, ext, msh)
    again = bsc.fwd_sweep(kop, ext, msh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((ak, *fk), again)), (
        "K5a: two runs differ")
    del again
    ap, *fp = bsc.fwd_sweep_plain(kop, ext, msh)
    zk, zp = logz(*fk), logz(*fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K5a: -inf pattern differs"
    assert fin[0] and fin[3] and not fin[1] and not fin[2], (
        "K5a: unexpected -inf pattern")
    errs = {"K5a": max(float(np.abs(zk[fin] - zp[fin]).max()),
                       float((norm(ak) - norm(ap)).abs().max()))}
    pk = bsc.backward(kop, ext, ak)
    torch.cuda.synchronize()
    assert torch.equal(pk, bsc.backward(kop, ext, ak)), "K5b: two runs differ"
    pp = bsc.backward_plain(kop, ext, ak)
    assert torch.isfinite(pk).all(), "K5b: non-finite posteriors"
    assert (pk[:, :, 1:3] == 0).all(), "K5b: infeasible graphs not zero"
    outside = ~plan_mask(kop)
    assert (pk[:, outside] == 0).all(), (
        "K5b: a posterior outside its graph's plan is not 0")
    lib = _build.library()
    nO = len(kop.offsets)
    smem = [lib.mm_banded_smem(kop.Sp, nO, bwd) for bwd in (0, 1)]
    assert smem == [4 * w for w in bsc._smem_words(kop.Sp, nO)], (
        f"admission's shared memory {bsc._smem_words(kop.Sp, nO)} words, "
        f"the kernels' {smem} bytes")
    print(f"{label}: P={P}: K5a and K5b run twice, bit-equal; K5b's "
          f"posteriors at the {int(outside.sum())} of {outside.numel()} "
          f"(pdf, graph) pairs outside the graphs' plans exactly 0 in all "
          f"{pk.shape[0]} frames; shared memory per CTA K5a {smem[0]} B, "
          f"K5b {smem[1]} B (the admission's figures)")
    errs["K5b"] = float((pk - pp).abs().max())
    for name, e in errs.items():
        print(f"{label}: P={P}: {name} kernel vs plain max |err| = {e:.3e} "
              f"(tol {TOL_K5:g})")
        assert np.isfinite(e) and e <= TOL_K5, f"{name} disagrees: {e}"
    return errs


def skip_numerators(P, lengths, seed):
    """Numerator lattices with skip arcs (i -> i + 2 besides the self-loop
    and the chain: three band offsets), the last over 3 pdfs only (each
    repeated).  Returns [(fsm, spdf)]."""
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(seed)
    out = []
    for g, Lp in enumerate(lengths):
        seq = rng.integers(0, 3 if g == len(lengths) - 1 else P, size=Lp)
        arcs = ([((i, i), np.log(0.5)) for i in range(Lp)]
                + [((i, i + 1), np.log(0.3)) for i in range(Lp - 1)]
                + [((i, i + 2), np.log(0.2)) for i in range(Lp - 2)])
        fsm = mt.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [mt.labels.Label(int(s)) for s in seq], mt.semiring.LOG)
        out.append((fsm, np.append(seq, P).astype(np.int32)))
    return out


def phase_banded_oracle(P, dev):
    """Phase 8: stacked-numerator pdfposteriors through K5a/K5b against
    the exact f64 host oracle: 4 lattices of 10-38 states at N=40, then 4
    lattices with skip arcs (offsets (0, 1, 2): the kernels' loop over
    the offsets past the second) of 10-130 states (Sp = 136: 5 states per
    lane) at N=150, where K5a and K5b are also held to their twins."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(5)
    chains = []
    for Lp in (10, 20, 30, 38):
        chains += build_numerators(P, G=1, Lp=Lp, seed=int(rng.integers(99)))
    for graphs, n, lens in (
            (chains, 40, [40, 35, 40, 39]),
            (skip_numerators(P, (10, 60, 130, 40), seed=6), 150,
             [150, 120, 150, 9])):
        num_cf = stack_numerators(graphs, P, dev)
        lhs = rng.normal(size=(4, n, P)).astype(np.float32)
        lens = np.array(lens, dtype=np.int32)
        tl, tn = torch.from_numpy(lhs).to(dev), torch.from_numpy(lens).to(dev)
        posts, z = mt.pdfposteriors(num_cf, tl, tn)
        z, posts = z.cpu().numpy(), posts.cpu().numpy()
        err = perr = 0.0
        for g, (fsm, spdf) in enumerate(graphs):
            rz, rp = mt.oracle.host_oracle(fsm, spdf, P,
                                           lhs[g:g + 1].astype(np.float64),
                                           lens[g:g + 1])
            fin = np.isfinite(rz[0])
            assert np.isfinite(z[g]) == fin, "feasibility differs"
            if fin:
                err = max(err, float(np.abs(z[g] - rz[0])))
            perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
        kop = bsc.kernel_operator(num_cf)
        tag = (f"G=4 N={n}, Sp = {kop.Sp}, offsets {kop.offsets}")
        print(f"phase 8: numerators {tag} vs f64 oracle |dlogZ| = "
              f"{err:.3e}, |dposts| = {perr:.3e} (tol {TOL_ORACLE:g})")
        assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"
        if len(kop.offsets) > 2:
            ext, msh = prepare_emissions(tl, tn, P)
            fk = bsc.fwd_sweep(kop, ext, msh)
            fp = bsc.fwd_sweep_plain(kop, ext, msh)
            ka = float((fk[0] - fp[0]).abs().max())
            kb = float((bsc.backward(kop, ext, fk[0])
                        - bsc.backward_plain(kop, ext, fk[0])).abs().max())
            print(f"phase 8: {tag}: K5a alphas vs plain max |err| = "
                  f"{ka:.3e}, K5b {kb:.3e} (tol {TOL_K5:g})")
            assert ka <= TOL_K5 and kb <= TOL_K5, "K5 disagrees with its twin"


def launch_counts(mods, bf16=False):
    """The launch counts of the ops modules ``mods``; with ``bf16``, those of
    the bf16 instantiations (``LAUNCHES_BF16``, keys suffixed ``_bf16``)
    where a module has them, after asserting that its float32 ones stayed
    0 (no float32 kernel ran for a bf16 graph)."""
    out = {}
    for m in mods:
        if bf16 and hasattr(m, "LAUNCHES_BF16"):
            assert not any(m.LAUNCHES.values()), (
                f"a float32 kernel ran for a bf16 graph: {m.LAUNCHES}")
            out.update({f"{k}_bf16": v for k, v in m.LAUNCHES_BF16.items()})
        else:
            out.update(m.LAUNCHES)
    return out


def phase_step(num_cf, cf, P, dev, mods, label, B=128, N=700, bf16=False):
    """Phase 9 (13, 21, 26-28): the LF-MMI training step through the kernels
    of the ops modules ``mods`` (with ``bf16``: their bf16 instantiations),
    checked and timed beside the denominator-only pdfposteriors."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)

    def step():
        x = lhs.clone().requires_grad_()
        loss = mt.lfmmi_loss(num_cf, cf, x, lengths)
        loss.sum().backward()
        return loss.detach(), x.grad

    torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    loss, grad = step()
    torch.cuda.synchronize()
    launches = launch_counts(mods, bf16)
    print(f"{label}: launches {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), "a kernel never launched"

    assert torch.isfinite(loss).all(), "non-finite LF-MMI loss"
    pn, zn = mt.pdfposteriors(num_cf, lhs, lengths)
    pd, zd = mt.pdfposteriors(cf, lhs, lengths)
    assert torch.isfinite(zn).all(), "infeasible numerator"
    lerr = float((loss - (zd - zn)).abs().max())
    gerr = float((grad - (pd - pn)).abs().max())
    gsum = float(grad.sum(dim=2).abs().max())
    print(f"{label}: loss sum {float(loss.sum()):.4f}; |loss - (logZ_den - "
          f"logZ_num)| = {lerr:.3e}; |grad - (posts_den - posts_num)| = "
          f"{gerr:.3e} (tol {TOL_GRAD:g}); max |sum_p grad| = {gsum:.3e} "
          f"(tol {TOL_GRAD_SUM:g})")
    assert lerr <= TOL_ORACLE, "loss differs from the separate logZ"
    assert gerr <= TOL_GRAD, "gradient is not posts_den - posts_num"
    assert gsum <= TOL_GRAD_SUM, "gradient does not sum to 0 over pdfs"

    t_step = cuda_ms(step, reps=2)
    t_den = cuda_ms(lambda: mt.pdfposteriors(cf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"{label}: LF-MMI step B={B} N={N} (num + den + grad): "
          f"{t_step / 1e3:.4f} s = {audio / (t_step / 1e3):.1f} audio-s/s; "
          f"den-only pdfposteriors {t_den / 1e3:.4f} s = "
          f"{audio / (t_den / 1e3):.1f} audio-s/s; ratio "
          f"{t_step / t_den:.3f}")
    return launches, t_step, t_den


def time_banded(num_cf, P, dev):
    """K5a and K5b and their plain twins over the whole 701-frame sweep at
    the numerators' main shape, ``P`` pdfs."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    ext, msh = banded_inputs(num_cf, P, dev)
    alphas = bsc.fwd_sweep(kop, ext, msh)[0]
    calls = {
        "K5a": (lambda: bsc.fwd_sweep(kop, ext, msh),
                lambda: bsc.fwd_sweep_plain(kop, ext, msh)),
        "K5b": (lambda: bsc.backward(kop, ext, alphas),
                lambda: bsc.backward_plain(kop, ext, alphas)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern, reps=5),
                          cuda_ms(kern, reps=5), cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} at P={P}: kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms")
    return out


def dense_inputs(P, dev, B=128, N=700, seed=2):
    """Phase 11's input: mixed lengths with 1 and N, ±30-nat cliffs."""
    import torch

    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    return prepare_emissions(lhs, torch.from_numpy(lens).to(dev), P)


def phase_dense_kernels(kop, P, dev, N=700, label="phase 11", tol=TOL_K6):
    """Phase 11 (24): K6a and K6b on the operator ``kop`` against their
    plain twins on one input, each kernel run twice and bit-equal."""
    import torch

    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import dense_scan as ds

    ext, msh = dense_inputs(P, dev, N=N)
    B = ext.shape[2]
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()

    def logz(out):
        _, _, a, s, ksum, shift = out
        return tinf._combine_shift(tinf._log_final(a[kop.fin] * s), ksum,
                                   shift).cpu().numpy()

    def norm(a):  # each (frame, column) over its max
        m = a.amax(dim=1, keepdim=True)
        return a / torch.where(m > 0, m, torch.ones_like(m))

    fk = ds.fwd_sweep(kop, a0, ext, msh)
    again = ds.fwd_sweep(kop, a0, ext, msh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(fk, again)), (
        "K6a is not bit-equal run to run")
    del again
    fp = ds.fwd_sweep_plain(kop, a0, ext, msh)
    zk, zp = logz(fk), logz(fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K6a: -inf pattern differs"
    assert fin.sum() > B // 2 and fin[0], "K6a: unexpected -inf pattern"
    errs = {"K6a": max(float(np.abs(zk[fin] - zp[fin]).max()),
                       float((norm(fk[0]) - norm(fp[0])).abs().max()))}
    del fp
    pk = ds.backward(kop, ext, fk[0], fk[1])
    again = ds.backward(kop, ext, fk[0], fk[1])
    torch.cuda.synchronize()
    assert torch.equal(pk, again), "K6b is not bit-equal run to run"
    del again
    pp = ds.backward_plain(kop, ext, fk[0], fk[1])
    assert torch.isfinite(pk).all(), "K6b: non-finite posteriors"
    errs["K6b"] = float((pk - pp).abs().max())
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain at N={N} max |err| = {e:.3e} "
              f"(tol {tol:g}); run twice: bit-equal")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    return errs


def full_dense_op(dev, Sp=4096, P=96, bf16=False, seed=12):
    """A DenseOp with a random fully dense (Sp, Sp) operator (every 32 x 32
    tile non-zero; rows summing to ~0.5), random pdfs with the phony pdf P
    on the final state Sp - 1, random initial probabilities: its tiles
    cannot stay in shared memory, so K6a/K6b stream them every frame."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(
        (rng.uniform(0.01, 1.0, size=(Sp, Sp)) / Sp).astype(np.float32))
    spdf = np.append(rng.integers(0, P, size=Sp - 1), P)
    a0 = torch.from_numpy(rng.uniform(size=Sp).astype(np.float32))
    wdt = torch.bfloat16 if bf16 else torch.float32
    w = w.to(dev, wdt)
    return ds.dense_op(a0.to(dev), w, w.T.contiguous(),
                       torch.from_numpy(spdf).to(dev),
                       torch.arange(Sp, device=dev), P + 1, Sp - 1)


def phase_dense_full(dev, P=96, N=128):
    """Phase 11, second part: K6a and K6b on a fully dense operator at
    Sp = 4,096 (the largest 'dense' graph of compile_fsm's 'auto' rule),
    whose ranges are streamed, against their twins: whole sweeps in
    float32, then the bf16 instantiations one frame at a time."""
    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = full_dense_op(dev, P=P)
    pl = kop.pf
    print(f"phase 11: fully dense Sp = {kop.Sp}: {pl.tile_k.numel()} tiles "
          f"over {pl.lo.numel() - 1} CTAs, up to {pl.max_tiles} per range "
          f"({pl.max_tiles * 4608 / 1024:.0f} KB of float32 tiles per CTA: "
          "streamed)")
    errs = phase_dense_kernels(kop, P, dev, N=N,
                               label="phase 11 (fully dense Sp = 4,096)")
    errs.update(phase_dense_frames(full_dense_op(dev, P=P, bf16=True), P, dev,
                                   "phase 11 (fully dense Sp = 4,096, bf16)",
                                   N=N))
    return errs


def random_graph(rng, S, P):
    """A non-banded graph: S states, three random out-arcs each (mass
    0.8), initial state 0, final weight 0.2 on every state, random pdfs.
    Returns (fsm, spdf)."""
    import markovmodels_tpu_torch as mt

    arcs = []
    for i in range(S):
        js = rng.choice(S, size=3, replace=False)
        w = rng.uniform(0.1, 1.0, size=3)
        w *= 0.8 / w.sum()
        arcs += [((i, int(j)), float(np.log(x))) for j, x in zip(js, w)]
    pdfs = rng.integers(0, P, size=S)
    fsm = mt.fsm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(i, np.log(0.2)) for i in range(S)],
        [mt.labels.Label(int(p)) for p in pdfs], mt.semiring.LOG)
    return fsm, np.append(pdfs, P).astype(np.int32)


def phase_dense_stack(dev, P=24, n=40):
    """Phase 14: four stacked non-banded graphs (the default strategy picks
    'dense') through the per-graph route on the card, against the f64
    oracle; no K6 launch (the JAX package runs this route outside its
    dense kernels)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import dense_scan as ds

    rng = np.random.default_rng(9)
    graphs = [random_graph(rng, S, P) for S in (10, 25, 40, 57)]
    cf = mt.stack([mt.compile_fsm(f, sp, P, device=dev) for f, sp in graphs])
    assert cf.strategy == "dense" and cf.batched
    report = mt.fast_path_report(cf, 4)
    assert "per-graph" in report, report
    lhs = rng.normal(size=(4, n, P)).astype(np.float32)
    lens = np.array([n, 33, n, 21], dtype=np.int32)
    ds.reset_launch_counts()
    posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                torch.from_numpy(lens).to(dev))
    z, posts = z.cpu().numpy(), posts.cpu().numpy()
    assert sum(ds.LAUNCHES.values()) == 0, "the per-graph route launched K6"
    err = perr = 0.0
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = mt.oracle.host_oracle(fsm, spdf, P,
                                       lhs[g:g + 1].astype(np.float64),
                                       lens[g:g + 1])
        err = max(err, float(np.abs(z[g] - rz[0])))
        perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
    print(f"phase 14: stacked dense G=4 N={n} on {dev} ({report}) vs f64 "
          f"oracle |dlogZ| = {err:.3e}, |dposts| = {perr:.3e} "
          f"(tol {TOL_ORACLE:g})")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"


def time_dense(cf, P, dev):
    """K6a and K6b and their plain twins over the whole 701-frame sweep at
    the main shape (B=128, Sp=3,200)."""
    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(cf)
    ext, msh = dense_inputs(P, dev)
    B = ext.shape[2]
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    alphas, ascale = ds.fwd_sweep(kop, a0, ext, msh)[:2]
    calls = {
        "K6a": (lambda: ds.fwd_sweep(kop, a0, ext, msh),
                lambda: ds.fwd_sweep_plain(kop, a0, ext, msh)),
        "K6b": (lambda: ds.backward(kop, ext, alphas, ascale),
                lambda: ds.backward_plain(kop, ext, alphas, ascale)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms")
    return out


def matmul_yardstick(dcf, dev, B=128, Nf=701):
    """The dense scan's product alone as one PyTorch call per frame: the
    (Sp, Sp) @ (Sp, B) float32 ``torch.matmul`` times Nf (a yardstick for
    K6a/K6b, which also rescale, emit and reduce; not a kernel of the
    port)."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    a = torch.rand((kop.Sp, B), device=dev)
    return Nf * cuda_ms(lambda: torch.matmul(kop.wf, a), reps=50)


def sparse_yardstick(dcf, dev, B=128, Nf=701):
    """A second yardstick for K6a/K6b: ``torch.sparse.mm`` of the forward
    operator as a CSR matrix by a (Sp, B) state, one PyTorch call per
    frame, times Nf (the product alone; not a kernel of the port).  In the
    operator's dtype; None where this PyTorch build does not multiply a
    CSR matrix of that dtype."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    csr = kop.wf.to_sparse_csr()
    a = torch.rand((kop.Sp, B), device=dev).to(kop.wf.dtype)
    try:
        torch.sparse.mm(csr, a)
    except RuntimeError as e:
        print(f"timing: torch.sparse.mm of a {kop.wf.dtype} CSR matrix: "
              f"not measured ({str(e).splitlines()[0]})")
        return None
    return Nf * cuda_ms(lambda: torch.sparse.mm(csr, a), reps=50)


def ms_or_not(t):
    return "not measured" if t is None else f"{t:.3f}"


def frame_floor(dcf, P, dev, N=700):
    """K6a and K6b on the graph's emissions and pdfs with an all-zero
    operator: no tile, so no product; what is left of a frame is the
    epilogue, the per-frame statistics and the grid barrier.  Returns
    (K6a, K6b) microseconds per frame, CUDA events."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    zero = ds.dense_op(kop.alpha0, torch.zeros_like(kop.wf),
                       torch.zeros_like(kop.wb), kop.spdf, kop.perm.long(),
                       kop.P1, kop.fin)
    assert zero.pf.tile_k.numel() == zero.pb.tile_k.numel() == 0
    ext, msh = dense_inputs(P, dev, N=N)
    B = ext.shape[2]
    a0 = zero.alpha0[:, None].expand(zero.Sp, B).contiguous()
    alphas, ascale = ds.fwd_sweep(zero, a0, ext, msh)[:2]
    Nf = N + 1
    return (1e3 * cuda_ms(lambda: ds.fwd_sweep(zero, a0, ext, msh),
                          reps=3) / Nf,
            1e3 * cuda_ms(lambda: ds.backward(zero, ext, alphas, ascale),
                          reps=3) / Nf)


def profile_step(num_cf, cf, P, dev, label, B=128, N=700):
    """The LF-MMI step under torch.profiler: its device time by kernel and
    idle share, and the numerator kernels' device time and share of the
    busy time, printed; asserts one launch each of K5a and K5b.  Returns
    profile_device's result, or None."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)

    def step():
        x = lhs.clone().requires_grad_()
        mt.lfmmi_loss(num_cf, cf, x, lens).sum().backward()

    prof = profile_device(step)
    if prof is None:
        print(f"{label}: profile of the step: not measured (no device "
              "events recorded)")
        return None
    by_name, busy, span, counts = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: profile of one LF-MMI step: device busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle {1 - busy / span:.1%})"
          f"; " + "; ".join(f"{k} {v:.3f} ms ({counts[k]} launches)"
                            for k, v in top))
    k5 = {k: v for k, v in by_name.items() if k.startswith("banded_")}
    assert sorted(counts[k] for k in k5) == [1, 1] and any(
        k.startswith("banded_fwd") for k in k5), f"K5 launches {counts}"
    print(f"{label}: numerator kernels in the step: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(k5.items()))
        + f"; K5a + K5b {sum(k5.values()):.3f} ms = "
        f"{sum(k5.values()) / busy:.1%} of the busy time")
    return prof


def profile_dense_step(num_cf, cf, P, dev, label):
    """profile_step with a dense denominator; asserts one launch of each
    sweep kernel (K6a and K6b: one per sweep, the frame loop inside) and no
    finalize launch."""
    prof = profile_step(num_cf, cf, P, dev, label)
    if prof is None:
        return
    counts = prof[3]
    sweeps = {k: v for k, v in counts.items() if k.startswith("sweep_kernel")}
    assert len(sweeps) == 2 and set(sweeps.values()) == {1}, sweeps
    assert not any("finalize" in k for k in counts), counts


def vit_inputs(P, dev, B=128, N=128, seed=4):
    """Phase 15's input: mixed lengths with 1 and N, ±30-nat cliffs."""
    import torch

    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    return lhs, torch.from_numpy(lens).to(dev)


def vit_score(out):
    from markovmodels_tpu_torch import inference as tinf

    _, _, vfin, shift, ksum = out
    return tinf._combine_shift(tinf._log_final(vfin), ksum,
                               shift).cpu().numpy()


def phase_vit_kernels(cf, P, dev, B=128, N=128):
    """Phase 15: K7 and the walk against their plain twins on one input at
    the main graph, B=128, N=128."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    lhs, lens = vit_inputs(P, dev, B, N)
    ext, msh = prepare_emissions(lhs, lens, P)
    out_k = vs.viterbi_fwd(cf, ext, msh)
    torch.cuda.synchronize()
    out_p = vs.viterbi_fwd_plain(cf, ext, msh)
    n_bp = int((out_k[0] != out_p[0]).sum())
    n_fin = int((out_k[1] != out_p[1]).sum())
    zk, zp = vit_score(out_k), vit_score(out_p)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K7: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1], "K7: unexpected -inf pattern"
    serr = float(np.abs(zk[fin] - zp[fin]).max())
    wt = vs.walk_tables(cf)
    sk = vs.walk(wt, out_k[0], out_k[1], lens)
    torch.cuda.synchronize()
    sp = vs.walk_plain(wt, out_k[0], out_k[1], lens)
    werr = float((sk - sp).abs().max())
    print(f"phase 15: K7 vs plain: {n_bp} of {out_k[0].numel()} ids and "
          f"{n_fin} of {out_k[1].numel()} omega argmaxes differ; max |dscore|"
          f" = {serr:.3e} (tol {TOL_VIT:g}); walk kernel vs plain max "
          f"|dstate| = {werr:g}")
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    return {"K7": serr, "K7w": werr}


def phase_vit_oracle(fsm, spdf, cf, P, dev, n=40):
    """Phase 16: viterbi at B=2 against the exact f64 max-plus optimum
    (the gate bench.py holds the JAX package to)."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(11)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref = mt.oracle.host_viterbi_score(fsm, spdf, P, lhs.astype(np.float64),
                                       lens)
    states, score = mt.viterbi(cf, torch.from_numpy(lhs).to(dev),
                               torch.from_numpy(lens).to(dev))
    serr = float(np.abs(score.cpu().numpy() - ref).max())
    # the decoded paths' f64 weight against the optimum itself
    gap = mt.oracle.validate_paths(fsm, spdf, lhs, lens,
                                   states.cpu().numpy(), ref,
                                   atol=TOL_VIT_PATH)
    print(f"phase 16: viterbi B=2 N={n} vs f64 oracle |dscore| = "
          f"{serr:.3e} (tol {TOL_VIT_ORACLE:g}); path-weight gap = "
          f"{gap:.3e} (tol {TOL_VIT_PATH:g})")
    assert serr <= TOL_VIT_ORACLE, "Viterbi score gate failed"


def phase_vit_main(fsm, spdf, cf, P, dev, B=128, N=700):
    """Phase 17: the full decode through K7 and the walk, checked and
    timed: the sweep and the walk separately, the decode end to end, and
    the plain twins beside them, whose outputs are held to the kernels'."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    for m in (vs, bs, bsc, ds):
        m.reset_launch_counts()
    states, score = mt.viterbi(cf, lhs, lengths)
    torch.cuda.synchronize()
    launches = dict(vs.LAUNCHES)
    others = {k: v for m in (bs, bsc, ds) for k, v in m.LAUNCHES.items()}
    print(f"phase 17: launches {json.dumps(launches)}; other kernels "
          f"{json.dumps(others)}")
    assert all(v > 0 for v in launches.values()), "a kernel never launched"
    assert not any(others.values()), "the decode launched another kernel"

    st, sc = states.cpu().numpy(), score.cpu().numpy()
    assert st.shape == (B, N) and st.dtype == np.int32, "output shapes"
    assert sc.shape == (B,) and np.isfinite(sc).all(), "non-finite score"
    assert ((st >= 0) & (st < len(fsm.alpha_hat))).all(), "bad state ids"
    gap = mt.oracle.validate_paths(fsm, spdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(), st, sc,
                                   atol=TOL_VIT_WALK)
    print(f"phase 17: all {B} paths walked in float64: max |path weight - "
          f"score| = {gap:.3e} (tol {TOL_VIT_WALK:g}); score in "
          f"[{sc.min():.3f}, {sc.max():.3f}]")

    ext, msh = prepare_emissions(lhs, lengths, P)
    wt = vs.walk_tables(cf)
    out = vs.viterbi_fwd(cf, ext, msh)
    t_sweep = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh), reps=2)
    t_walk = cuda_ms(lambda: vs.walk(wt, out[0], out[1], lengths), reps=10)
    t_dec = cuda_ms(lambda: mt.viterbi(cf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 17: viterbi B={B} N={N}: decode {t_dec:.3f} ms = "
          f"{audio / (t_dec / 1e3):.1f} audio-s/s; K7 sweep {t_sweep:.3f} ms "
          f"({1e3 * t_sweep / (N + 1):.2f} us/frame), walk {t_walk:.3f} ms")
    prof = profile_device(lambda: mt.viterbi(cf, lhs, lengths))
    if prof is None:
        print("phase 17: profile of the decode: not measured (no device "
              "events recorded)")
    else:
        by_name, busy, span, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase 17: profile of one decode: device busy {busy:.3f} ms "
              f"of a {span:.3f} ms span (idle {1 - busy / span:.1%}); "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))

    # plain twins beside the kernels: plain, kernel, kernel, plain at
    # N=128, then once each at the full N=700
    n2 = min(128, N)
    lhs2, len2 = lhs[:, :n2].contiguous(), torch.full_like(lengths, n2)
    ext2, msh2 = prepare_emissions(lhs2, len2, P)
    kern2 = lambda: vs.viterbi_fwd(cf, ext2, msh2)
    plain2 = lambda: vs.viterbi_fwd_plain(cf, ext2, msh2)
    p1, k1, k2, p2 = (cuda_ms(plain2), cuda_ms(kern2), cuda_ms(kern2),
                      cuda_ms(plain2))
    print(f"timing: K7 at B={B} N={n2}: kernel {k1:.3f}/{k2:.3f} ms, plain "
          f"{p1:.3f}/{p2:.3f} ms")
    plain, walked = [], []
    t_plain = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(cf, ext, msh)),
                      warm=False)
    t_walk_plain = cuda_ms(lambda: walked.append(
        vs.walk_plain(wt, out[0], out[1], lengths)), warm=False)
    print(f"timing: K7 at B={B} N={N}: kernel {t_sweep:.3f} ms, plain "
          f"{t_plain:.3f} ms; walk kernel {t_walk:.3f} ms, plain "
          f"{t_walk_plain:.3f} ms")

    # the same plain runs hold K7 and the walk to their twins at this shape
    # (the ids past 2^32 bytes included)
    out_p = plain[0]
    n_bp = int((out[0] != out_p[0]).sum())
    n_fin = int((out[1] != out_p[1]).sum())
    zk, zp = vit_score(out), vit_score(out_p)
    assert np.isfinite(zk).all() and np.isfinite(zp).all(), "K7: -inf score"
    serr = float(np.abs(zk - zp).max())
    werr = float((vs.walk(wt, out[0], out[1], lengths) - walked[0])
                 .abs().max())
    print(f"phase 17: K7 vs plain at B={B} N={N}: {n_bp} of {out[0].numel()} "
          f"ids and {n_fin} of {out[1].numel()} omega argmaxes differ; max "
          f"|dscore| = {serr:.3e} (tol {TOL_VIT:g}); walk kernel vs plain "
          f"max |dstate| = {werr:g}")
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    times = {"K7": (t_sweep, t_plain), "K7w": (t_walk, t_walk_plain)}
    return launches, times, t_dec, {"K7": serr, "K7w": werr}


def phase_ov_step(num_cf, cf, ecf, P, dev, B=128, N=700, chunk=64):
    """Phase 21: the training step with the separate-state denominator
    (phase_step's checks), its exact launch counts, and the den-only time
    of the embedded layout of the same LM beside it."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    ds.reset_launch_counts()
    vs.reset_launch_counts()
    launches, t_step, t_den = phase_step(num_cf, cf, P, dev, (bs, bsc),
                                         "phase 21", B, N)
    C = -(-(N + 1) // chunk)
    want = {"block_fwd": 1, "block_recompute": C, "block_bwd": C,
            "banded_fwd": 1, "banded_bwd": 1}
    others = {k: v for m in (ds, vs) for k, v in m.LAUNCHES.items()}
    assert launches == want, f"launches {launches}, expected {want}"
    assert not any(others.values()), f"another kernel launched: {others}"
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    t_emb = cuda_ms(lambda: mt.pdfposteriors(ecf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 21: embedded layout den-only pdfposteriors {t_emb / 1e3:.4f}"
          f" s = {audio / (t_emb / 1e3):.1f} audio-s/s; separate/embedded "
          f"den-only ratio {t_den / t_emb:.3f} (bench.py holds the JAX "
          f"package's under 1.2; printed only)")
    return launches, t_step, t_den, t_emb


def phase_block_frames(cf, P, dev, label, B=128, N=128, chunk=64):
    """Phase 23's frame checks: K2, K3 and K4 against their twins one frame
    at a time from the same input (the kernels' own states of a
    mid-sequence chunk), so that both round the same float32 values and
    only the order of the float32 sums differs: K3 and K4 on every frame
    of the chunk, K2 over two frames (the first, which skips the matvec,
    and one step) from every 8th.  Returns {name: max |err|}."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens_np = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens_np[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, torch.from_numpy(lens_np).to(dev), P)
    K = min(chunk, N + 1)
    C = -(-(N + 1) // K)
    Npad = C * K
    ext, msh = pad_emissions(ext, msh, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, K)[:2]
    c = C // 2
    t0 = c * K
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[t0:t0 + K], t0)
    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    for j in range(1, K):
        t = t0 + j
        args = (kop, al[j - 1], asc[j - 1], ext[t:t + 1], t)
        k, p = bs.recompute(*args), bs.recompute_plain(*args)
        errs["K3"] = max(errs["K3"],
                         float((scaled(*k) - scaled(*p)).abs().max()))
    for j in range(0, K - 2, 8):
        t = t0 + j
        args = (kop, al[j].contiguous(), ext[t:t + 2], msh[t:t + 2], 2)
        errs["K2"] = max(errs["K2"], sweep_err(kop, bs.fwd_sweep(*args),
                                               bs.fwd_sweep_plain(*args)))
    beta, bsc = torch.ones_like(a0), torch.ones(B, device=dev)
    for cc in reversed(range(c + 1, C)):  # the kernels' beta after chunk c
        sl = slice(cc * K, (cc + 1) * K)
        a_, s_ = bs.recompute(kop, bounds[cc], bscale[cc], ext[sl], cc * K)
        _, beta, bsc = bs.backward(kop, beta, bsc, a_, s_, ext[sl], cc * K,
                                   Npad)
    for j in reversed(range(K)):
        t = t0 + j
        args = (kop, beta, bsc, al[j:j + 1], asc[j:j + 1], ext[t:t + 1], t,
                Npad)
        k = bs.backward(*args)
        errs["K4"] = max(errs["K4"], bwd_err(k, bs.backward_plain(*args)))
        beta, bsc = k[1], k[2]
    torch.cuda.synchronize()
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain one frame at a time from the "
              f"same state max |err| = {e:.3e} (tol {TOL_KERNEL:g})")
        assert np.isfinite(e) and e <= TOL_KERNEL, f"{name} disagrees: {e}"
    return errs


def phase_dense_frames(kop, P, dev, label, N=128):
    """Phase 24's frame checks on the bf16 operator ``kop``: K6a over two
    frames (the first skips the product) from the kernel's own state of
    every 8th frame, and K6b over two frames (the last starts from beta =
    1, the other multiplies it) on the kernel's alphas: the same float32
    values rounded on both sides.  Returns {name: max |err|}."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    ext, msh = dense_inputs(P, dev, N=N)
    B = ext.shape[2]
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    al, asc = ds.fwd_sweep(kop, a0, ext, msh)[:2]
    errs = {"K6a": 0.0, "K6b": 0.0}
    for t in range(1, N - 1, 8):
        args = (kop, al[t].contiguous(), ext[t:t + 2], msh[t:t + 2])
        k, p = ds.fwd_sweep(*args), ds.fwd_sweep_plain(*args)
        errs["K6a"] = max(errs["K6a"], float(
            (scaled(k[0], k[1]) - scaled(p[0], p[1])).abs().max()))
        args = (kop, ext[t:t + 2], al[t:t + 2].contiguous(),
                asc[t:t + 2].contiguous())
        errs["K6b"] = max(errs["K6b"], float(
            (ds.backward(*args) - ds.backward_plain(*args)).abs().max()))
    torch.cuda.synchronize()
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain one frame at a time from the "
              f"same state max |err| = {e:.3e} (tol {TOL_K6:g})")
        assert np.isfinite(e) and e <= TOL_K6, f"{name} disagrees: {e}"
    return errs


def phase_oracle_700(fsm, spdf, P, dev, cfs, label, n=700):
    """Phase 25: ``pdfposteriors`` at B=2, N=700 (lengths N and 2N/3, the
    inputs of ``bench.py``'s parity gate) against the exact f64 host
    oracle, which runs once for the graph; ``cfs`` maps a name to (compile
    of the graph, logZ gate, posterior gate).  Every reading is printed
    beside the 1e-4 contract.  Returns {name: (|dlogZ|, |dposts|)} and the
    oracle's seconds."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    t0 = time.perf_counter()
    ref_z, ref_p = mt.oracle.host_oracle(fsm, spdf, P,
                                         lhs.astype(np.float64), lens)
    t_oracle = time.perf_counter() - t0
    out = {}
    for name, (cf, tz, tp) in cfs.items():
        posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                    torch.from_numpy(lens).to(dev))
        err = float(np.abs(z.cpu().numpy() - ref_z).max())
        perr = float(np.abs(posts.cpu().numpy() - ref_p).max())
        met = lambda e: "met" if e <= TOL_ORACLE else "missed"
        print(f"{label}: {name} B=2 N={n} vs f64 oracle |dlogZ| = {err:.3e} "
              f"(gate {tz:g}; contract {TOL_ORACLE:g} {met(err)}), |dposts| "
              f"= {perr:.3e} (gate {tp:g}; contract {TOL_ORACLE:g} "
              f"{met(perr)})")
        assert err <= tz and perr <= tp, f"{name}: N={n} oracle gate failed"
        out[name] = (err, perr)
    print(f"{label}: the f64 oracle took {t_oracle:.1f} s")
    return out, t_oracle


def bf16_checks(label, mods, fn):
    """Run ``fn`` (a check of bf16 kernels against their twins) with every
    launch count of ``mods`` set to 0, and assert that it launched only
    bf16 instantiations, each at least once."""
    import torch

    for m in mods:
        m.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts(mods, bf16=True)
    print(f"{label}: bf16 launches of the check {json.dumps(counts)}")
    assert all(counts.values()), "a bf16 kernel never launched"
    return out


def median_ms(fns, reps=5):
    """{name: median ms of ``reps`` warm runs} of the callables ``fns``,
    run in turns (one of each per round, after one warm-up each), each
    timed with CUDA events."""
    import torch

    for fn in fns.values():
        fn()
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in ts.items()}


def time_bf16_paths(pairs, dev, B=128, N=700):
    """Phase 29: each (f32, bf16) pair of callables on the same inputs,
    medians of 5 warm runs in turns; prints the bf16/f32 ratio.  Returns
    {name: (f32 ms, bf16 ms)}."""
    out = {}
    for name, (f32, b16) in pairs.items():
        t = median_ms({"f32": f32, "bf16": b16})
        out[name] = (t["f32"], t["bf16"])
        audio = B * N * FRAME_SHIFT_S
        print(f"phase 29: {name} B={B} N={N}: f32 {t['f32']:.2f} ms, bf16 "
              f"{t['bf16']:.2f} ms = {audio / (t['bf16'] / 1e3):.1f} "
              f"audio-s/s; bf16/f32 {t['bf16'] / t['f32']:.3f} (medians of "
              f"5; printed, not gated)")
    return out


def matmul_yardstick_bf16(dcf, dev, B=128, Nf=701):
    """K6's bf16 yardstick: the (Sp, Sp) bf16 operator by a (Sp, B) bf16
    state with a float32 result (``torch.mm(..., out_dtype=float32)``, one
    PyTorch call per frame) times Nf; not a kernel of the port."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    a = torch.rand((kop.Sp, B), device=dev).to(torch.bfloat16)
    y = torch.mm(kop.wf, a, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and kop.wf.dtype == torch.bfloat16
    return Nf * cuda_ms(lambda: torch.mm(kop.wf, a, out_dtype=torch.float32),
                        reps=50)


def phase_bf16_decode(cf, cf16, P, dev, B=128, N=128):
    """Phase 30: K7 on the bf16 graph takes the float32 panels (the TPU K7
    ignores the precision): its ids, ω argmaxes and scores equal the
    'high' graph's bit for bit, and so do the decoded paths."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    lhs, lens = vit_inputs(P, dev, B, N)
    ext, msh = prepare_emissions(lhs, lens, P)
    vs.reset_launch_counts()
    hi, lo = vs.viterbi_fwd(cf, ext, msh), vs.viterbi_fwd(cf16, ext, msh)
    torch.cuda.synchronize()
    assert vs.LAUNCHES["vit_fwd"] == 2, vs.LAUNCHES
    same = [torch.equal(x, y) for x, y in zip(hi, lo)]
    s_hi, z_hi = mt.viterbi(cf, lhs, lens)
    s_lo, z_lo = mt.viterbi(cf16, lhs, lens)
    paths = torch.equal(s_hi, s_lo) and torch.equal(z_hi, z_lo)
    print(f"phase 30: K7 on the bf16 graph vs the 'high' graph at B={B} "
          f"N={N}: ids, omega argmaxes, vfin, shift, ksum bit-equal "
          f"{same}; decoded paths and scores bit-equal {paths}")
    assert all(same) and paths, "the bf16 graph decodes differently"


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # full float32 everywhere, in the plain twins' matmuls too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    card = card_line()
    print(card)

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}")
    if _build.PTXAS_LOG:
        print(_build.PTXAS_LOG, file=sys.stderr)

    t0 = time.perf_counter()
    fsm, spdf, P, info = mt.workloads.make_lm_hmm_graph(V=128)
    cf = mt.compile_fsm(fsm, spdf, P, strategy="block", precision="high",
                        device=dev)
    print(f"phase 3: graph {info} compiled in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {cf.padded_states}; "
          f"path: {mt.fast_path_report(cf, 128)}")

    t0 = time.perf_counter()
    num_cf = stack_numerators(build_numerators(P), P, dev)
    print(f"phase 3: 128 numerators compiled and stacked in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {num_cf.padded_states}, "
          f"offsets {num_cf.banded_offsets}; path: "
          f"{mt.fast_path_report(num_cf, 128)}")

    errs = phase_kernels(cf, P, dev, twice=True)
    phase_oracle(fsm, spdf, cf, P, dev)
    _, t_kern, t_plain = phase_main(cf, P, dev)
    errs.update(phase_banded_kernels(num_cf, P, dev))
    phase_banded_oracle(P, dev)
    launches, t_step, t_den = phase_step(num_cf, cf, P, dev, (bs, bsc),
                                         "phase 9")
    profile_step(num_cf, cf, P, dev, "phase 9")
    profile_block_den(cf, P, dev, "phase 9")
    times, terrs = time_kernels(cf, P, dev)
    errs.update({k: max(errs[k], v) for k, v in terrs.items()})
    splits = {"2M-arc": frame_split(cf, P, dev, "2M-arc graph")}
    times.update(time_banded(num_cf, P, dev))
    bounds = block_bounds(cf, 128, -(-701 // 64) * 64, 64)
    bounds.update(banded_bounds(num_cf, 701))

    t0 = time.perf_counter()
    dfsm, dspdf, dP, dinfo = mt.workloads.make_lm_hmm_graph(V=32)
    dcf = mt.compile_fsm(dfsm, dspdf, dP, device=dev)  # default: 'auto'
    assert dcf.strategy == "dense" and dcf.precision == "high", dcf.strategy
    print(f"phase 10: graph {dinfo} compiled (strategy {dcf.strategy!r}, "
          f"precision {dcf.precision!r}) in {time.perf_counter() - t0:.1f} "
          f"s; Sp = {dcf.padded_states}; path: "
          f"{mt.fast_path_report(dcf, 128)}")
    dnum_cf = stack_numerators(build_numerators(dP), dP, dev)
    errs.update(phase_dense_kernels(ds.kernel_operator(dcf), dP, dev))
    phase_dense_full(dev)
    phase_oracle(dfsm, dspdf, dcf, dP, dev, label="phase 12")
    bs.reset_launch_counts()
    vs.reset_launch_counts()
    e96 = phase_banded_kernels(dnum_cf, dP, dev, "phase 13")
    times96 = time_banded(dnum_cf, dP, dev)
    bounds96 = banded_bounds(dnum_cf, 701)
    dlaunches, t_dstep, t_dden = phase_step(dnum_cf, dcf, dP, dev,
                                            (bsc, ds), "phase 13")
    assert dlaunches == {"banded_fwd": 1, "banded_bwd": 1, "dense_fwd": 1,
                         "dense_bwd": 1}, dlaunches
    assert not any(bs.LAUNCHES.values()) and not any(vs.LAUNCHES.values())
    profile_dense_step(dnum_cf, dcf, dP, dev, "phase 13")
    phase_dense_stack(dev)
    times.update(time_dense(dcf, dP, dev))
    bounds.update(dense_bounds(dcf, 128, 701))
    dense_eq = dense_bounds(dcf, 128, 701, dense=True)
    t_mm = matmul_yardstick(dcf, dev)
    t_sp = sparse_yardstick(dcf, dev)
    floor = frame_floor(dcf, dP, dev)
    print(f"timing: K6 yardsticks x701 frames: torch.matmul of the (3200, "
          f"3200) operator by the (3200, 128) state {t_mm:.3f} ms; "
          f"torch.sparse.mm of its CSR ({int(ds.kernel_operator(dcf).wf.count_nonzero())} "
          f"non-zeros) {ms_or_not(t_sp)} ms; bounds from the non-zeros K6a "
          f"{bounds['K6a'][0]:.4f} ms, K6b {bounds['K6b'][0]:.4f} ms, "
          f"dense-equivalent {dense_eq['K6a'][0]:.2f} / "
          f"{dense_eq['K6b'][0]:.2f} ms; a frame without the product "
          f"(epilogue, statistics, grid barrier): K6a {floor[0]:.2f} us, "
          f"K6b {floor[1]:.2f} us")

    errs.update(phase_vit_kernels(cf, P, dev))
    phase_vit_oracle(fsm, spdf, cf, P, dev)
    vlaunches, vtimes, t_dec, verrs = phase_vit_main(fsm, spdf, cf, P, dev)
    errs.update({k: max(errs[k], v) for k, v in verrs.items()})
    times.update(vtimes)
    bounds.update(vit_bounds(cf, 128, 701))

    t0 = time.perf_counter()
    sfsm, sspdf, sP, sinfo = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate")
    scf = mt.compile_fsm(sfsm, sspdf, sP, device=dev)  # the defaults
    report = mt.fast_path_report(scf, 128)
    print(f"phase 18: graph {sinfo} compiled (strategy {scf.strategy!r}, "
          f"ov_layout {scf.ov_layout}) in {time.perf_counter() - t0:.1f} s; "
          f"Sp = {scf.padded_states}; path: {report}")
    assert scf.strategy == "block" and scf.ov_layout == (128, 3), "layout"
    assert report.startswith("cuda-block-scan"), report
    ov_errs = phase_kernels(scf, sP, dev, label="phase 19", twice=True)
    phase_oracle(sfsm, sspdf, scf, sP, dev, label="phase 20")
    efsm, espdf, eP, _ = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="embedded")
    ecf = mt.compile_fsm(efsm, espdf, eP, device=dev)
    assert ecf.pdf_group and mt.fast_path_report(ecf, 128).startswith(
        "cuda-block-scan"), "embedded layout"
    ov_launches, t_ostep, t_oden, t_emb = phase_ov_step(num_cf, scf, ecf, sP,
                                                        dev)
    del ecf
    profile_block_den(scf, sP, dev, "phase 21")
    ov_times, terrs = time_kernels(scf, sP, dev)
    ov_errs.update({k: max(ov_errs[k], v) for k, v in terrs.items()})
    splits["separate-state"] = frame_split(scf, sP, dev,
                                           "separate-state graph")
    ov_bounds = block_bounds(scf, 128, -(-701 // 64) * 64, 64)

    # ---- precision='bf16' -------------------------------------------------
    t0 = time.perf_counter()
    cf16 = mt.compile_fsm(fsm, spdf, P, strategy="block", precision="bf16",
                          device=dev)
    scf16 = mt.compile_fsm(sfsm, sspdf, sP, precision="bf16", device=dev)
    dcf16 = mt.compile_fsm(dfsm, dspdf, dP, precision="bf16", device=dev)
    for c, want in ((cf16, "cuda-block-scan"), (scf16, "cuda-block-scan"),
                    (dcf16, "cuda-dense-scan")):
        report = mt.fast_path_report(c, 128)
        assert c.precision == "bf16" and report.startswith(want), report
    assert scf16.ov_layout == (128, 3) and dcf16.strategy == "dense"
    assert bs.kernel_operator(cf16).fwd.W.dtype == torch.bfloat16
    assert ds.kernel_operator(dcf16).wf.dtype == torch.bfloat16
    print(f"phase 22: the 2M-arc, separate-state and V=32 graphs compiled "
          f"with precision='bf16' in {time.perf_counter() - t0:.1f} s; "
          f"paths: {mt.fast_path_report(cf16, 128)}; "
          f"{mt.fast_path_report(dcf16, 128)}")

    bf16_checks("phase 23", (bs,), lambda: phase_block_frames(
        cf16, P, dev, "phase 23"))
    bf16_checks("phase 23", (bs,), lambda: phase_block_frames(
        scf16, sP, dev, "phase 23 (separate)"))
    b_errs = bf16_checks("phase 23", (bs,), lambda: phase_kernels(
        cf16, P, dev, label="phase 23", twice=True, tol=TOL_KERNEL_BF16))
    sb_errs = bf16_checks("phase 23", (bs,), lambda: phase_kernels(
        scf16, sP, dev, label="phase 23 (separate)", twice=True,
        tol=TOL_KERNEL_BF16))

    def dense_checks():
        kop16 = ds.kernel_operator(dcf16)
        e128 = phase_dense_kernels(kop16, dP, dev, N=128, label="phase 24",
                                   tol=TOL_KERNEL_BF16)
        e700 = phase_dense_kernels(kop16, dP, dev, label="phase 24",
                                   tol=TOL_KERNEL_BF16)
        return {k: max(e128[k], e700[k]) for k in e128}

    bf16_checks("phase 24", (ds,), lambda: phase_dense_frames(
        ds.kernel_operator(dcf16), dP, dev, "phase 24"))
    d_errs = bf16_checks("phase 24", (ds,), dense_checks)

    t0 = time.perf_counter()
    oracle = {}
    for gname, (g, sp_, P_, hi, lo, (tz, tp)) in {
            "2M-arc": (fsm, spdf, P, cf, cf16,
                       (TOL_BF16_LOGZ, TOL_BF16_POSTS)),
            "separate-state": (sfsm, sspdf, sP, scf, scf16,
                               (TOL_BF16_LOGZ, TOL_BF16_POSTS)),
            "V=32 dense": (dfsm, dspdf, dP, dcf, dcf16,
                           (TOL_DENSE_BF16_LOGZ, TOL_DENSE_BF16_POSTS)),
    }.items():
        res, _ = phase_oracle_700(g, sp_, P_, dev, {
            f"{gname} high": (hi, TOL_ORACLE_700, TOL_ORACLE),
            f"{gname} bf16": (lo, tz, tp)}, "phase 25")
        oracle.update(res)
    print(f"phase 25: N=700 oracle gates in {time.perf_counter() - t0:.1f} s")

    b_launches, _, _ = phase_step(num_cf, cf16, P, dev, (bs, bsc),
                                  "phase 26", bf16=True)
    sb_launches, _, _ = phase_step(num_cf, scf16, sP, dev, (bs, bsc),
                                   "phase 27", bf16=True)
    d_launches, _, _ = phase_step(dnum_cf, dcf16, dP, dev, (bsc, ds),
                                  "phase 28", bf16=True)
    assert d_launches == {"banded_fwd": 1, "banded_bwd": 1,
                          "dense_fwd_bf16": 1, "dense_bwd_bf16": 1}, d_launches
    profile_dense_step(dnum_cf, dcf16, dP, dev, "phase 28")

    def step(num, den, P_):
        """(the training step, den-only pdfposteriors) on phase 9's input"""
        rng = np.random.default_rng(0)
        lhs = torch.from_numpy(make_inputs(rng, 128, 700, P_)).to(dev)
        lens = torch.full((128,), 700, dtype=torch.int32, device=dev)

        def run():
            x = lhs.clone().requires_grad_()
            mt.lfmmi_loss(num, den, x, lens).sum().backward()
        return run, lambda: mt.pdfposteriors(den, lhs, lens)

    (s32, p32), (s16, p16) = step(num_cf, cf, P), step(num_cf, cf16, P)
    (ds32, dp32), (ds16, dp16) = (step(dnum_cf, dcf, dP),
                                  step(dnum_cf, dcf16, dP))
    (ss32, sp32), (ss16, sp16) = (step(num_cf, scf, sP),
                                  step(num_cf, scf16, sP))
    paths16 = time_bf16_paths({
        "2M-arc LF-MMI step": (s32, s16),
        "2M-arc den-only pdfposteriors": (p32, p16),
        "dense LF-MMI step": (ds32, ds16),
        "dense den-only pdfposteriors": (dp32, dp16),
        "separate-state LF-MMI step": (ss32, ss16),
        "separate-state den-only pdfposteriors": (sp32, sp16),
    }, dev)
    for name, c16, P_ in (("2M-arc", cf16, P), ("separate-state", scf16, sP)):
        profile_block_den(c16, P_, dev, f"phase 29 ({name} bf16)")
    for name, fn in (("dense", dp16),):
        prof = profile_device(fn)
        if prof is None:
            print(f"phase 29: profile of the {name} bf16 den-only "
                  "pdfposteriors: not measured (no device events recorded)")
            continue
        by_name, busy, span, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase 29: profile of one {name} bf16 den-only pdfposteriors: "
              f"device busy {busy:.3f} ms of a {span:.3f} ms span (idle "
              f"{1 - busy / span:.1%}); "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    b_times, terrs = time_kernels(cf16, P, dev, tol=TOL_KERNEL_BF16)
    b_errs.update({k: max(b_errs[k], v) for k, v in terrs.items()})
    sb_times, terrs = time_kernels(scf16, sP, dev, tol=TOL_KERNEL_BF16)
    sb_errs.update({k: max(sb_errs[k], v) for k, v in terrs.items()})
    splits["2M-arc bf16"] = frame_split(cf16, P, dev, "2M-arc graph (bf16)")
    splits["separate-state bf16"] = frame_split(
        scf16, sP, dev, "separate-state graph (bf16)")
    d_times = time_dense(dcf16, dP, dev)
    t_mm16 = matmul_yardstick_bf16(dcf16, dev)
    t_sp16 = sparse_yardstick(dcf16, dev)
    print(f"timing: K6 bf16 yardstick, torch.mm of the bf16 (3200, 3200) "
          f"operator by a bf16 (3200, 128) state into float32, x701 frames: "
          f"{t_mm16:.3f} ms (float32: {t_mm:.3f} ms); torch.sparse.mm of "
          f"its bf16 CSR x701: {ms_or_not(t_sp16)} ms")
    b_bounds = block_bounds(cf16, 128, -(-701 // 64) * 64, 64)
    sb_bounds = block_bounds(scf16, 128, -(-701 // 64) * 64, 64)
    d_bounds = dense_bounds(dcf16, 128, 701)
    phase_bf16_decode(cf, cf16, P, dev)

    block_src = "markovmodels_tpu_torch/ops/csrc/block_scan.cu"
    banded_src = "markovmodels_tpu_torch/ops/csrc/banded_scan.cu"
    dense_src = "markovmodels_tpu_torch/ops/csrc/dense_scan.cu"
    vit_src = "markovmodels_tpu_torch/ops/csrc/vit_scan.cu"
    launches.update({k: v for k, v in dlaunches.items()
                     if k in ds.LAUNCHES})
    launches.update(vlaunches)
    table = {  # name: (counter, source, the TPU kernel it replaces)
        "K2": ("block_fwd", block_src,
               "markovmodels_tpu/ops/pallas_block.py:862"),
        "K3": ("block_recompute", block_src,
               "markovmodels_tpu/ops/pallas_block.py:907"),
        "K4": ("block_bwd", block_src,
               "markovmodels_tpu/ops/pallas_block.py:945"),
        "K5a": ("banded_fwd", banded_src,
                "markovmodels_tpu/ops/pallas_banded.py:180"),
        "K5b": ("banded_bwd", banded_src,
                "markovmodels_tpu/ops/pallas_banded.py:215"),
        "K6a": ("dense_fwd", dense_src,
                "markovmodels_tpu/ops/pallas_scan.py:220"),
        "K6b": ("dense_bwd", dense_src,
                "markovmodels_tpu/ops/pallas_scan.py:269"),
        "K7": ("vit_fwd", vit_src,
               "markovmodels_tpu/ops/pallas_block.py:1387"),
        # the walk replaces XLA code, no Pallas kernel: the line of wstep
        "K7w": ("vit_walk", vit_src, "markovmodels_tpu/viterbi.py:382"),
    }
    library = {"K6a": t_mm, "K6b": t_mm}  # the torch.matmul yardstick
    kernels = [
        {"name": f"{name} {counter}", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[counter],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name, (counter, source, replaces) in table.items()
    ]
    kernels += [  # the dense step's numerators: P = 96
        {"name": f"{name} {counter} (numerators at P=96, dense step)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": dlaunches[counter], "max_abs_err": e96[name],
         "ms": times96[name][0], "plain_ms": times96[name][1],
         "bound_ms": bounds96[name][0], "bound_by": bounds96[name][1],
         "library_ms": None}
        for name, (counter, source, replaces) in table.items()
        if name in times96
    ]
    kernels += [  # the overflow branch, on the separate-state graph
        {"name": f"{name} {counter} (separate-state backoff graph)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": ov_launches[counter], "max_abs_err": ov_errs[name],
         "ms": ov_times[name][0], "plain_ms": ov_times[name][1],
         "bound_ms": ov_bounds[name][0], "bound_by": ov_bounds[name][1],
         "library_ms": None}
        for name, (counter, source, replaces) in table.items()
        if name in ov_times
    ]
    for tag, l16, e16, t16, bd16, lib in (
            ("2M-arc graph", b_launches, b_errs, b_times, b_bounds, {}),
            ("separate-state backoff graph", sb_launches, sb_errs, sb_times,
             sb_bounds, {}),
            ("V=32 dense graph", d_launches, d_errs, d_times, d_bounds,
             {"K6a": t_mm16, "K6b": t_mm16})):
        kernels += [  # the bf16 branches: the tier / product on tensor cores
            {"name": f"{name} {counter} (bf16, {tag})", "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": l16[f"{counter}_bf16"], "max_abs_err": e16[name],
             "ms": t16[name][0], "plain_ms": t16[name][1],
             "bound_ms": bd16[name][0], "bound_by": bd16[name][1],
             "library_ms": lib.get(name)}
            for name, (counter, source, replaces) in table.items()
            if name in t16
        ]
    print(f"card: {card}; pdfposteriors B=128 N=700 kernel path "
          f"{t_kern:.2f} ms, plain path {t_plain:.2f} ms; LF-MMI step "
          f"{t_step:.2f} ms, den-only {t_den:.2f} ms; dense-den LF-MMI step "
          f"{t_dstep:.2f} ms, dense den-only {t_dden:.2f} ms; viterbi "
          f"B=128 N=700 {t_dec:.2f} ms; K6 matmul yardstick {t_mm:.2f} ms; "
          f"separate-state LF-MMI step {t_ostep:.2f} ms, den-only "
          f"{t_oden:.2f} ms, embedded den-only {t_emb:.2f} ms; bf16 (f32) "
          f"medians: " + "; ".join(f"{k} {b:.2f} ({a:.2f}) ms"
                                   for k, (a, b) in paths16.items())
          + f"; K6 bf16 yardstick {t_mm16:.2f} ms; per frame, whole / "
          f"without work: " + "; ".join(
              f"{k} {name} {v['whole']:.2f} / {v['without work']:.2f} us"
              for k, sp in splits.items() for name, v in sp.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
