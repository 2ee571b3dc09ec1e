"""A/B timing of the blocked scan's kernels K2, K3 and K4 and of the dense
scan's K6a and K6b, for comparing two versions on one card within one
process each (a development script beside ``chip_smoke.py``, not part of
the package):

    python ab_block.py . separate
    python ab_block.py build/vA 2m separate 2m-bf16 separate-bf16
    python ab_block.py build/vA dense-bf16
    python ab_block.py build/vA 2m-f64 separate-f64
    python ab_block.py build/vP banded banded-trace
    python ab_block.py build/vP banded-wide

The first argument is the root of a copy of the package (its parent
directory); that copy builds its own library under ``<root>/build/``.  For
an A/B against the parent commit, unpack its package into a gitignored
directory (``git archive HEAD markovmodels_tpu_torch | tar -x -C build/vP``)
and run the two in turns P, C, C, P, P, C in one call.  The
others name denominators: ``2m`` (the 2M-arc trigram graph), ``separate``
(the separate-state backoff graph, V=128, 10 % of the trigrams kept, in the
capped/overflow layout), each also as ``-bf16`` (compiled with precision
'bf16': the tensor-core tier) or ``-f64`` (compiled float64: K2-K4's
float64 instantiation), ``dense`` or ``dense-bf16`` (the V=32 LM o HMM
graph, Sp = 3,200, compiled 'dense' with precision 'high' or 'bf16'), or
``dense-f64`` (the same compiled float64: K6's float64 instantiation).
Run the versions in turns (A, B, B, A) in one call.  Prints one JSON line
per graph: the root, the graph, and three warm times in ms each of K2 over
the 704 padded frames and of K3 and K4 over the last 64-frame chunk, or of
K6a and K6b over all 701 frames, at B=128, N=700; for a dense graph also
``floor_us``, K6a's and K6b's µs per frame on an all-zero operator (no
product: the epilogue, the statistics and the barrier;
``chip_smoke.frame_floor``), and except in bf16 ``K6t_ms``, three warm times
of K6t over the 701 frames from the initial state, ``K6t_split_us``, its µs
per frame whole and on an all-zero operator
(``chip_smoke.trop_frame_split``), ``K6t_sum``, the float64 sum of its
outputs (equal between two versions that compute bit for bit the same),
``K6t_bitequal``, two runs, and ``decode_ms``, the median of 5 warm
``viterbi`` calls on the same input (the chunk-recompute decode: K6t and
W2).  For a block graph also:

* ``K4_split``: K4's ms over the same chunk on three cut copies of the
  backward operator (``chip_smoke.cut_operator``), beside the whole one:
  ``no_tier`` (the tier's rows taken as band rows: no tier product),
  ``no_bands`` (no band offsets, no family terms), ``neither`` (both cut:
  the frame without work, its epilogue, statistics and the frame-to-frame
  dependency);
* ``K4_err``: K4 against its plain twin on the chunk (posteriors and the
  outgoing beta), and ``K4_bitequal``: two K4 runs bit-equal;
* ``K2_err``, ``K3_err``: K2 against its plain twin over the sweep (its
  checkpoints, last state, shift and ksum: ``chip_smoke.sweep_err``) and
  K3 against its twin on the last chunk (the scaled alphas);
* ``K2_split``, ``K3_split``: the same four cuts of the forward operator
  (``cut_operator(..., direction="fwd")``), K2 over the 704 frames and K3
  over the last chunk, in us per frame (``K4_split`` is in ms per chunk);
* ``K2_graph_ms``, ``K3_graph_ms``: the same K2 and K3 calls captured once
  in a CUDA graph and replayed (a yardstick of what the launches and the
  gaps between them cost; null where the capture fails);
* ``K2_sum``, ``K3_sum``: sums of K2's and K3's outputs in float64, equal
  between two versions whose K2 and K3 compute bit for bit the same, and
  ``K23_bitequal``: K2 and K3 run twice, bit-equal.

``banded`` (the LF-MMI step's 128 stacked 78-state numerators, Sp = 80,
offsets (0, 1), through K5a and K5b) prints one line per pdf count, P = 384
(the 2M-arc step's) and P = 96 (the dense step's), on ``chip_smoke``'s
phase-7 input (ragged lengths, ±30-nat cliffs), N = 700: three warm times
in ms each of K5a and K5b over the 701-frame sweep, and of K5a without its
alpha stores (``save_alphas=False``, logZ only); ``K5a_sum`` and
``K5b_sum``, float64 sums of their outputs (equal between two versions
whose kernels compute bit for bit the same); ``K5_bitequal``: both run
twice, bit-equal; ``K5a_err`` and ``K5b_err`` against their plain twins.

``banded-wide`` (``chip_smoke`` phase 8b's G=128 stack of four ~1,200-state
skip-arc lattices, Sp = 1,208, offsets (0, 1, 2), P = 384, N = 700,
lengths 700, 690, 640, 700, through K5a's and K5b's wide instantiation)
prints one line per dtype, float32 and float64: the root's instantiations
(``banded_scan.instantiations``), three warm times in ms each of K5a and
K5b over the 701-frame sweep and of K5a without its alpha stores,
``K5a_sum`` and ``K5b_sum``,
``K5_bitequal`` and ``K5a_err`` and ``K5b_err`` against the twins, as
``banded``.

``banded-trace`` builds a traced copy of the root's ``banded_scan.cu`` into
``<root>/build/trace/`` (``clock64`` and ``%globaltimer`` stamps at the
anchors of ``_ANCHORS``, or ``_PARENT_ANCHORS`` in the kernels of PRs 2-9,
written by lane 0 of graph 0 for every frame) and prints, for K5a and K5b
at P = 384 and P = 96, the mean ns per frame between consecutive stamps.
The stamps' own stores slow a traced kernel (the PR 2-9 K5b by ~50 %).

``--sums`` (before the graphs) runs only the bit-for-bit part on each
block graph: ``K2_sum``, ``K3_sum``, ``K4_sum`` (K4's posteriors, outgoing
beta and scale over the last chunk, in float64) and the run-twice checks,
no timing; on a dense graph ``K6a_sum`` (K6a's outputs over the 701
frames), ``K6b_sum`` (K6b's posteriors), with 'high' ``K6t_sum`` (K6t's
states, scales and sums from the initial state), and ``K6_bitequal``; the
library's ``ptxas`` report (registers, spills, shared memory of every
instantiation) goes to stderr.  Two versions whose kernels compute bit for
bit the same print the same sums.

Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys


def _ms(fn, reps=3):
    """Three warm times of ``fn`` in ms (one warm-up), CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return ts


def _graph_ms(fn, reps=3):
    """Three times in ms of ``fn`` captured once in a CUDA graph and
    replayed, or None where the capture fails."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return _ms(g.replay, reps)
    except RuntimeError as e:
        print(f"CUDA graph capture failed: {e}", file=sys.stderr)
        return None


def run_graph(graph: str, sums_only: bool = False) -> dict:
    import numpy as np
    import torch

    import markovmodels_tpu_torch as mt
    from chip_smoke import (cut_operator, frame_floor, median_ms, scaled,
                            sweep_err, trop_frame_split)
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    dev = torch.device("cuda:0")
    B, N, K = 128, 700, 64
    prec = "bf16" if graph.endswith("-bf16") else "high"
    dt = torch.float64 if graph.endswith("-f64") else torch.float32
    if graph.startswith("dense"):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=32)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="dense", device=dev,
                            precision=prec,
                            **({"dtype": dt} if dt == torch.float64 else {}))
    elif graph.startswith("2m"):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev,
                            precision=prec,
                            **({"dtype": dt} if dt == torch.float64 else {}))
    else:
        fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
            V=128, keep=0.1, layout="separate")
        cf = mt.compile_fsm(fsm, spdf, P, device=dev, precision=prec,
                            **({"dtype": dt} if dt == torch.float64 else {}))
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    out = {"graph": graph}
    if graph.startswith("dense"):
        kop = ds.kernel_operator(cf)
        a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
        fwd = ds.fwd_sweep(kop, a0, ext, msh)
        alphas, ascale = fwd[:2]
        if sums_only:
            posts = ds.backward(kop, ext, alphas, ascale)
            out["K6a_sum"] = sum(float(t.double().sum()) for t in fwd)
            out["K6b_sum"] = float(posts.double().sum())
            again = ds.fwd_sweep(kop, a0, ext, msh)
            out["K6_bitequal"] = (
                all(torch.equal(x, y) for x, y in zip(fwd, again))
                and torch.equal(posts, ds.backward(kop, ext, alphas, ascale)))
            if prec == "high":
                top = ds.trop_operator(cf)
                tk = ds.trop_sweep(top, a0, torch.ones(B, device=dev,
                                                       dtype=dt), ext, msh,
                                   first=True)
                out["K6t_sum"] = sum(float(t.double().sum()) for t in tk)
            return out
        out["K6a_ms"] = _ms(lambda: ds.fwd_sweep(kop, a0, ext, msh))
        out["K6b_ms"] = _ms(lambda: ds.backward(kop, ext, alphas, ascale))
        out["floor_us"] = frame_floor(cf, P, dev, N)
        if prec == "high":
            top = ds.trop_operator(cf)
            one = torch.ones(B, device=dev, dtype=dt)
            tk = ds.trop_sweep(top, a0, one, ext, msh, first=True)
            out["K6t_sum"] = sum(float(t.double().sum()) for t in tk)
            out["K6t_bitequal"] = all(torch.equal(x, y) for x, y in zip(
                tk, ds.trop_sweep(top, a0, one, ext, msh, first=True)))
            del tk
            out["K6t_ms"] = _ms(lambda: ds.trop_sweep(top, a0, one, ext, msh,
                                                      first=True))
            out["K6t_split_us"] = trop_frame_split(top, ext, msh)
            out["decode_ms"] = median_ms(
                {"decode": lambda: mt.viterbi(cf, lhs, lens)})["decode"]
        return out
    kop = bs.kernel_operator(cf)
    C = -(-(N + 1) // K)
    ext, msh = pad_emissions(ext, msh, C * K)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    fwd = bs.fwd_sweep(kop, a0, ext, msh, K)
    bounds, bscale = fwd[:2]
    c = C - 1
    sl = slice(c * K, (c + 1) * K)
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev, dtype=dt)
    out["K2_sum"] = sum(float(t.double().sum()) for t in fwd)
    out["K3_sum"] = float(al.double().sum()) + float(asc.double().sum())
    fwd2 = bs.fwd_sweep(kop, a0, ext, msh, K)
    al2, asc2 = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
    out["K23_bitequal"] = all(torch.equal(x, y) for x, y in
                              zip(fwd + (al, asc), fwd2 + (al2, asc2)))
    del fwd2, al2, asc2
    if sums_only:
        k1 = bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K, C * K)
        k2 = bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K, C * K)
        out["K4_sum"] = sum(float(t.double().sum()) for t in k1)
        out["K4_bitequal"] = all(torch.equal(x, y) for x, y in zip(k1, k2))
        return out
    out["K2_err"] = sweep_err(kop, fwd, bs.fwd_sweep_plain(kop, a0, ext, msh,
                                                           K))
    ap, sp = bs.recompute_plain(kop, bounds[c], bscale[c], ext[sl], c * K)
    out["K3_err"] = float((scaled(al, asc) - scaled(ap, sp)).abs().max())
    del ap, sp
    out["K2_ms"] = _ms(lambda: bs.fwd_sweep(kop, a0, ext, msh, K))
    out["K3_ms"] = _ms(lambda: bs.recompute(kop, bounds[c], bscale[c],
                                            ext[sl], c * K))
    for name, frames, call in (
            ("K2", C * K, lambda op: bs.fwd_sweep(op, a0, ext, msh, K)),
            ("K3", K, lambda op: bs.recompute(op, bounds[c], bscale[c],
                                              ext[sl], c * K))):
        split = {}
        for part, cut in (
                ("full", kop),
                ("no_tier", cut_operator(kop, tier=False, direction="fwd")),
                ("no_bands", cut_operator(kop, bands=False,
                                          direction="fwd")),
                ("neither", cut_operator(kop, False, False, "fwd"))):
            ts = _ms(lambda: call(cut))
            split[part] = 1e3 * sum(ts) / len(ts) / frames
        out[f"{name}_split"] = split
        out[f"{name}_graph_ms"] = _graph_ms(lambda: call(kop))
    split = {}
    for name, cut in (("full", kop),
                      ("no_tier", cut_operator(kop, tier=False)),
                      ("no_bands", cut_operator(kop, bands=False)),
                      ("neither", cut_operator(kop, False, False))):
        ts = _ms(lambda: bs.backward(cut, beta, bsc, al, asc, ext[sl], c * K,
                                     C * K))
        if name == "full":
            out["K4_ms"] = ts
        split[name] = sum(ts) / len(ts)
    out["K4_split"] = split
    k1 = bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K, C * K)
    k2 = bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K, C * K)
    out["K4_bitequal"] = all(torch.equal(x, y) for x, y in zip(k1, k2))
    pp, bp, sp = bs.backward_plain(kop, beta, bsc, al, asc, ext[sl], c * K,
                                   C * K)
    out["K4_err"] = max(float((k1[0] - pp).abs().max()),
                        float((k1[1] * k1[2] - bp * sp).abs().max()))
    return out


def _banded_setup(P: int):
    """The step's numerators at ``P`` pdfs on the card, their kernels'
    operator, and ``chip_smoke``'s phase-7 input."""
    import torch

    from chip_smoke import banded_inputs, build_numerators, stack_numerators
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    dev = torch.device("cuda:0")
    num_cf = stack_numerators(build_numerators(P), P, dev)
    ext, msh = banded_inputs(num_cf, P, dev)
    return bsc, bsc.kernel_operator(num_cf), ext, msh


def run_banded(P: int) -> dict:
    import torch

    bsc, kop, ext, msh = _banded_setup(P)
    fwd = bsc.fwd_sweep(kop, ext, msh)
    posts = bsc.backward(kop, ext, fwd[0])
    fwd2 = bsc.fwd_sweep(kop, ext, msh)
    posts2 = bsc.backward(kop, ext, fwd[0])
    out = {"graph": f"banded-{P}",
           "K5a_sum": sum(float(t.double().sum()) for t in fwd),
           "K5b_sum": float(posts.double().sum()),
           "K5_bitequal": all(torch.equal(x, y) for x, y in
                              zip(fwd + (posts,), fwd2 + (posts2,)))}
    del fwd2, posts2
    ap, vp, sp, kp = bsc.fwd_sweep_plain(kop, ext, msh)
    ak, vk, sk, kk = fwd
    # alphas are rescaled to a column max in [1, 2): absolute differences
    out["K5a_err"] = max(float((ak - ap).abs().max()),
                         float((sk - sp).abs().max()),
                         float((kk - kp).abs().max()),
                         float(((vk - vp).abs() / vp.abs().clamp_min(
                             1e-300)).max()))
    out["K5b_err"] = float((posts - bsc.backward_plain(kop, ext, ak)).abs()
                           .max())
    out["K5a_ms"] = _ms(lambda: bsc.fwd_sweep(kop, ext, msh))
    out["K5a_logz_only_ms"] = _ms(lambda: bsc.fwd_sweep(kop, ext, msh,
                                                        save_alphas=False))
    out["K5b_ms"] = _ms(lambda: bsc.backward(kop, ext, ak))
    return out


def run_banded_wide(dtype_name: str) -> dict:
    import numpy as np
    import torch

    from chip_smoke import make_inputs, skip_numerators
    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    dev, P, N = torch.device("cuda:0"), 384, 700
    dt = getattr(torch, dtype_name)
    graphs = skip_numerators(P, (1200, 1180, 1150, 1199), seed=7)
    num = mt.stack([mt.compile_fsm(f, sp, P, strategy="banded", device=dev,
                                   dtype=dt) for f, sp in graphs] * 32)
    kop = bsc.kernel_operator(num)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(0), 128, N,
                                       P)).to(dev, dt)
    lens = torch.from_numpy(np.tile(np.array([N, N - 10, N - 60, N],
                                             dtype=np.int32), 32)).to(dev)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    fwd = bsc.fwd_sweep(kop, ext, msh)
    posts = bsc.backward(kop, ext, fwd[0])
    fwd2 = bsc.fwd_sweep(kop, ext, msh)
    posts2 = bsc.backward(kop, ext, fwd[0])
    out = {"graph": f"banded-wide-{dtype_name}",
           "instantiations": bsc.instantiations(num),
           "K5a_sum": sum(float(t.double().sum()) for t in fwd),
           "K5b_sum": float(posts.double().sum()),
           "K5_bitequal": all(torch.equal(x, y) for x, y in
                              zip(fwd + (posts,), fwd2 + (posts2,)))}
    del fwd2, posts2
    fp = bsc.fwd_sweep_plain(kop, ext, msh)
    out["K5a_err"] = max(float((a - b).abs().max())
                         for a, b in zip(fwd, fp))
    out["K5b_err"] = float((posts - bsc.backward_plain(kop, ext, fwd[0]))
                           .abs().max())
    del fp, posts
    al = fwd[0]
    out["K5a_ms"] = _ms(lambda: bsc.fwd_sweep(kop, ext, msh))
    out["K5a_logz_only_ms"] = _ms(lambda: bsc.fwd_sweep(kop, ext, msh,
                                                        save_alphas=False))
    out["K5b_ms"] = _ms(lambda: bsc.backward(kop, ext, al))
    return out


# Stamps of the traced copy of banded_scan.cu: (kernel section, the exact
# text of a line of the source, "before" or "after" it, table K, stamp I,
# what runs from stamp I to stamp I + 1).  Stamp I of table K records
# clock64 and %globaltimer for frame t on lane 0 of graph 0.  The first hit
# of an anchor in its section takes the stamp; an anchor that the root's
# source lacks is skipped.  Tables 0 and 1: the chains of K5a and K5b;
# table 2: K5b's posterior warp.
_PARENT_ANCHORS = [  # the one-warp-per-graph kernels of PRs 2-9
    ("fwd", "    const float* e = ext + static_cast<size_t>(t) * m.P1 * G + g;",
     "after", 0, 0, "band pass + omega dot"),
    ("fwd", "    dot = warp_sum(dot);", "before", 0, 1, "dot reduction"),
    ("fwd", "    dot = warp_sum(dot);", "after", 0, 2,
     "emission gather + fin + max"),
    ("fwd", "    mx = warp_max(mx);", "before", 0, 3, "max reduction"),
    ("fwd", "    mx = warp_max(mx);", "after", 0, 4,
     "rescale + alpha stores"),
    ("fwd", "    ksum += k;  // every lane keeps the same sums", "before", 0,
     5, "ksum, mshift, syncwarp"),
    ("fwd", "    cur ^= 1;", "before", 0, 6, "loop back"),
    ("bwd", "    const bool last = t == m.Nf - 1;", "after", 1, 0,
     "band pass + alpha/emission loads + pdf atomics"),
    ("bwd", "    tot = warp_sum(tot);", "before", 1, 1,
     "tot and max reductions"),
    ("bwd", "    __syncwarp();  // every pdf sum of frame t is in", "before", 1,
     2, "syncwarp"),
    ("bwd", "    __syncwarp();  // every pdf sum of frame t is in", "after", 1,
     3, "posterior loop (P1 divisions and stores)"),
    ("bwd", "    const double sc = pow2_scale(pow2_exponent(mx));", "before",
     1, 4, "rescale + syncwarp"),
    ("bwd", "    cur ^= 1;", "before", 1, 5, "loop back"),
]
_ANCHORS = [  # this tree's kernels
    ("fwd", "    mbar_wait(full + r, (t / DEPTH) & 1);  // frame t's emissions "
     "are in", "before", 0, 0, "wait for the helper's slot"),
    ("fwd", "    mbar_wait(full + r, (t / DEPTH) & 1);  // frame t's emissions "
     "are in", "after", 0, 1, "state and emission loads + dot partial"),
    ("fwd", "      dot = warp_sum(dot);", "before", 0, 2, "dot reduction"),
    ("fwd", "      dot = warp_sum(dot);", "after", 0, 3,
     "band pass + key max"),
    ("fwd", "      const double vf = dot * double(ef);", "before", 0, 4,
     "phony row + rescale + state and ring stores"),
    ("fwd", "    ksum += k;  // every lane keeps the same exponent sum",
     "before", 0, 5, "ksum, shift, syncwarp, release"),
    ("fwd", "    cur ^= 1;", "before", 0, 6, "loop back"),
    ("bwd", "      mbar_wait(efull + i % DEPTH, (i / DEPTH) & 1);  // the "
     "emissions", "before", 1, 0, "wait for the helper's slot"),
    ("bwd", "      mbar_wait(efull + i % DEPTH, (i / DEPTH) & 1);  // the "
     "emissions", "after", 1, 1, "band pass"),
    ("bwd", "      // hand beta of frame t to the posterior warp", "before", 1,
     2, "wait for a free beta slot"),
    ("bwd", "      if (i >= YRING) mbar_wait(empty + r, ((i / YRING) - 1) & 1);",
     "after", 1, 3, "beta handed + emission + local key"),
    ("bwd", "      mbar_arrive(edone + i % DEPTH);  // the emission slot "
     "is free", "after", 1, 4, "key max"),
    ("bwd", "          pow2_scale(key_exponent(__reduce_max_sync(FULL, key)));",
     "after", 1, 5, "rescale + syncwarp"),
    ("bwd", "      cur ^= 1;", "before", 1, 6, "loop back"),
    ("bwd", "      mbar_wait(full + r, (i / YRING) & 1);", "before", 2, 0,
     "wait for the chain's beta"),
    ("bwd", "      mbar_wait(full + r, (i / YRING) & 1);", "after", 2, 1,
     "gamma + tot reduction + syncwarp"),
    ("bwd", "      const double rt = tot > 0.0 ? 1.0 / tot : 1.0;", "before", 2,
     2, "reciprocal + pdf sums + stores"),
    ("bwd", "      __syncwarp();  // gm is rewritten next time", "before", 2,
     3, "loop back (fetch ahead, alpha wait; frames alternate between the "
     "posterior warps)"),
]
_TRACE_PRELUDE = r"""
#define MM_TRACE_NF 1024
__device__ long long mm_trace_clk[4][MM_TRACE_NF][8];
__device__ long long mm_trace_gt[4][MM_TRACE_NF][8];
#define MM_STAMP(K, I)                                                    \
  if (g == 0 && lane == 0 && t < MM_TRACE_NF) {                           \
    long long gt_;                                                        \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt_));               \
    mm_trace_clk[K][t][I] = clock64();                                    \
    mm_trace_gt[K][t][I] = gt_;                                           \
  }
"""
_TRACE_READ = r"""
extern "C" int mm_trace_read(long long* clk, long long* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, mm_trace_clk, sizeof(mm_trace_clk));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(gt, mm_trace_gt, sizeof(mm_trace_gt));
  return static_cast<int>(e);
}
extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


_TRACED = {}


def _traced_library(root: str):
    """Build the traced copy of the root's banded_scan.cu and load it (once
    per process)."""
    import ctypes
    import subprocess

    from markovmodels_tpu_torch.ops import _build

    if root in _TRACED:
        return _TRACED[root]
    csrc = os.path.join(root, "markovmodels_tpu_torch", "ops", "csrc")
    text = open(os.path.join(csrc, "banded_scan.cu")).read()
    cut = text.index("banded_bwd_kernel(")
    parts = {"fwd": text[:cut].split("\n"), "bwd": text[cut:].split("\n")}
    names = {}
    ours = "cp_async_wait<DEPTH" in text
    for part, anchor, where, k, i, label in (_ANCHORS if ours
                                             else _PARENT_ANCHORS):
        lines = parts[part]
        hits = [n for n, ln in enumerate(lines) if ln == anchor]
        if not hits:
            continue
        stmt = f"MM_STAMP({k}, {i});"
        if k in (1, 2) and ours:
            # this tree's K5b counts iterations i, frame t = Nf - 1 - i
            stmt = f"{{ const int t = Nf - 1 - i; {stmt} }}"
        lines.insert(hits[0] + (1 if where == "after" else 0), stmt)
        names[k, i] = label
    print(f"trace: stamps placed: {sorted(names)}", file=sys.stderr)
    out_dir = os.path.join(root, "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "banded_trace.cu")
    with open(src, "w") as f:
        f.write(_TRACE_PRELUDE + "\n".join(parts["fwd"]) + "\n"
                + "\n".join(parts["bwd"]) + _TRACE_READ)
    lib_path = os.path.join(out_dir, "libbanded_trace.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-I", csrc,
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    for name, args in _build._SIGNATURES.items():
        if name.startswith("mm_banded"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    lib.mm_error_string.argtypes = [ctypes.c_int]
    lib.mm_error_string.restype = ctypes.c_char_p
    _TRACED[root] = lib, names
    return lib, names


def trace_banded(root: str, P: int) -> dict:
    """Per-frame intervals between the traced copy's stamps, K5a and K5b at
    ``P`` pdfs: mean ns over the frames 1 .. Nf - 2 of graph 0."""
    import ctypes

    import numpy as np
    import torch

    from markovmodels_tpu_torch.ops import _build

    lib, names = _traced_library(root)
    _build._LIB = lib  # the wrappers launch it
    bsc, kop, ext, msh = _banded_setup(P)
    Nf = ext.shape[0]
    for _ in range(2):
        alphas = bsc.fwd_sweep(kop, ext, msh)[0]
        bsc.backward(kop, ext, alphas)
    torch.cuda.synchronize()
    clk = np.zeros((4, 1024, 8), dtype=np.int64)
    gt = np.zeros_like(clk)
    rc = lib.mm_trace_read(ctypes.c_void_p(clk.ctypes.data),
                           ctypes.c_void_p(gt.ctypes.data))
    assert rc == 0, rc
    out = {"graph": f"banded-trace-{P}"}
    for k, name in ((0, "K5a"), (1, "K5b"), (2, "K5b_posterior")):
        n = max((i for i in range(8) if clk[k, 1, i]), default=-1) + 1
        if n == 0:
            continue
        c = clk[k, 1:Nf - 1, :n].astype(np.float64)
        step = -1 if k else 1  # K5b runs its frames backwards
        nxt = clk[k, 1 + step:Nf - 1 + step, 0].astype(np.float64)
        ns_per_clk = ((gt[k, Nf - 2, 0] - gt[k, 1, 0])
                      / (clk[k, Nf - 2, 0] - clk[k, 1, 0]))
        segs = {names[k, i]: float(np.mean(c[:, i + 1] - c[:, i])
                                   * ns_per_clk) for i in range(n - 1)}
        segs[names[k, n - 1]] = float(np.mean(nxt - c[:, n - 1])
                                      * ns_per_clk)
        segs["frame"] = float(np.mean(np.abs(nxt - c[:, 0])) * ns_per_clk)
        segs["frame_globaltimer"] = float(
            abs(gt[k, Nf - 2, 0] - gt[k, 1, 0]) / (Nf - 3))
        segs["ns_per_clock"] = float(ns_per_clk)
        out[name] = segs
    return out


def main(root: str, graphs) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    _build.library()
    sums_only = graphs[:1] == ["--sums"]
    if sums_only:
        graphs = graphs[1:]
        print(_build.PTXAS_LOG, file=sys.stderr)
    for graph in graphs:
        if graph == "banded":
            rows = [run_banded(P) for P in (384, 96)]
        elif graph == "banded-wide":
            rows = [run_banded_wide(d) for d in ("float32", "float64")]
        elif graph == "banded-trace":
            rows = [trace_banded(root, P) for P in (384, 96)]
        else:
            rows = [run_graph(graph, sums_only)]
        for row in rows:
            print(json.dumps({"version": root, **row}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
