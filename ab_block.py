"""A/B timing of the blocked scan's kernels K2, K3 and K4 and of the dense
scan's K6a and K6b, for comparing two versions on one card within one
process each (a development script beside ``chip_smoke.py``, not part of
the package):

    python ab_block.py . separate
    python ab_block.py build/vA 2m separate 2m-bf16 separate-bf16
    python ab_block.py build/vA dense-bf16

The first argument is the root of a copy of the package (its parent
directory); that copy builds its own library under ``<root>/build/``.  The
others name denominators: ``2m`` (the 2M-arc trigram graph), ``separate``
(the separate-state backoff graph, V=128, 10 % of the trigrams kept, in the
capped/overflow layout), each also as ``-bf16`` (compiled with precision
'bf16': the tensor-core tier), ``dense`` or ``dense-bf16`` (the V=32 LM o HMM
graph, Sp = 3,200, compiled 'dense' with precision 'high' or 'bf16').  Run
the versions in turns (A, B, B, A) in one call.  Prints one JSON line per
graph: the root, the graph, and three warm times in ms each of K2 over the
704 padded frames and of K3 and K4 over the last 64-frame chunk, or of K6a
and K6b over all 701 frames, at B=128, N=700.  For a block graph also:

* ``K4_split``: K4's ms over the same chunk on three cut copies of the
  backward operator (``chip_smoke.cut_operator``), beside the whole one:
  ``no_tier`` (the tier's rows taken as band rows: no tier product),
  ``no_bands`` (no band offsets, no family terms), ``neither`` (both cut:
  the frame without work, its epilogue, statistics and the frame-to-frame
  dependency);
* ``K4_err``: K4 against its plain twin on the chunk (posteriors and the
  outgoing beta), and ``K4_bitequal``: two K4 runs bit-equal;
* ``K2_sum``, ``K3_sum``: sums of K2's and K3's outputs in float64, equal
  between two versions whose K2 and K3 compute bit for bit the same.

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


def run_graph(graph: str) -> dict:
    import numpy as np
    import torch

    import markovmodels_tpu_torch as mt
    from chip_smoke import cut_operator
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    dev = torch.device("cuda:0")
    B, N, K = 128, 700, 64
    prec = "bf16" if graph.endswith("-bf16") else "high"
    if graph.startswith("dense"):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=32)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="dense", device=dev,
                            precision=prec)
    elif graph.startswith("2m"):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev,
                            precision=prec)
    else:
        fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
            V=128, keep=0.1, layout="separate")
        cf = mt.compile_fsm(fsm, spdf, P, device=dev, precision=prec)
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P)
    out = {"graph": graph}
    if graph.startswith("dense"):
        kop = ds.kernel_operator(cf)
        a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
        alphas, ascale = ds.fwd_sweep(kop, a0, ext, msh)[:2]
        out["K6a_ms"] = _ms(lambda: ds.fwd_sweep(kop, a0, ext, msh))
        out["K6b_ms"] = _ms(lambda: ds.backward(kop, ext, alphas, ascale))
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
    bsc = torch.ones(B, device=dev)
    out["K2_sum"] = sum(float(t.double().sum()) for t in fwd)
    out["K3_sum"] = float(al.double().sum()) + float(asc.double().sum())
    out["K2_ms"] = _ms(lambda: bs.fwd_sweep(kop, a0, ext, msh, K))
    out["K3_ms"] = _ms(lambda: bs.recompute(kop, bounds[c], bscale[c],
                                            ext[sl], c * K))
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


def main(root: str, graphs) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    _build.library()
    for graph in graphs:
        print(json.dumps({"version": root, **run_graph(graph)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
