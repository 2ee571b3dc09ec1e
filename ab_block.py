"""A/B timing of the blocked scan's kernels K2, K3 and K4 and of the dense
scan's K6a and K6b, for comparing two versions on one card within one
process each (a development script beside ``chip_smoke.py``, not part of
the package):

    python ab_block.py . separate
    python ab_block.py build/vA 2m
    python ab_block.py build/vA dense-bf16

The first argument is the root of a copy of the package (its parent
directory); that copy builds its own library under ``<root>/build/``.  The
second names the denominator: ``2m`` (the 2M-arc trigram graph),
``separate`` (the separate-state backoff graph, V=128, 10 % of the
trigrams kept, in the capped/overflow layout), ``dense`` or ``dense-bf16``
(the V=32 LM o HMM graph, Sp = 3,200, compiled 'dense' with precision
'high' or 'bf16').  Run the versions in turns (A, B, B, A) in one call.
Prints one JSON line: the root, the graph, and three warm times in ms
each of K2 over the 704 padded frames and of K3 and K4 over the last
64-frame chunk, or of K6a and K6b over all 701 frames, at B=128, N=700.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys


def main(root: str, graph: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    dev = torch.device("cuda:0")
    _build.library()
    B, N, K = 128, 700, 64
    if graph.startswith("dense"):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=32)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="dense", device=dev,
                            precision="bf16" if graph == "dense-bf16"
                            else "high")
    elif graph == "2m":
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev)
    else:
        fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
            V=128, keep=0.1, layout="separate")
        cf = mt.compile_fsm(fsm, spdf, P, device=dev)
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P)
    if graph.startswith("dense"):
        kop = ds.kernel_operator(cf)
        a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
        alphas, ascale = ds.fwd_sweep(kop, a0, ext, msh)[:2]
        calls = {
            "K6a": lambda: ds.fwd_sweep(kop, a0, ext, msh),
            "K6b": lambda: ds.backward(kop, ext, alphas, ascale),
        }
    else:
        kop = bs.kernel_operator(cf)
        C = -(-(N + 1) // K)
        ext, msh = pad_emissions(ext, msh, C * K)
        a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
        bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, K)[:2]
        c = C - 1
        sl = slice(c * K, (c + 1) * K)
        al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
        beta = torch.ones_like(a0)
        bsc = torch.ones(B, device=dev)
        calls = {
            "K2": lambda: bs.fwd_sweep(kop, a0, ext, msh, K),
            "K3": lambda: bs.recompute(kop, bounds[c], bscale[c], ext[sl],
                                       c * K),
            "K4": lambda: bs.backward(kop, beta, bsc, al, asc, ext[sl],
                                      c * K, C * K),
        }
    out = {"version": root, "graph": graph}
    for name, fn in calls.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        out[f"{name}_ms"] = ts
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2])))
