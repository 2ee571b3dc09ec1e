"""A/B timing of the K7 sweep, for comparing two versions of the kernel on
one card within one process each (a development script beside
``chip_smoke.py``, not part of the package):

    python ab_vit.py .
    python ab_vit.py build/vA

The argument is the root of a copy of the package (its parent directory);
that copy builds its own library under ``<root>/build/``.  Run the versions
in turns (A, B, B, A) in one call.  Prints one JSON line: the root, three
warm sweep times in ms at the 2M-arc graph with B=128, N=700, and the ids
plus ω argmaxes that differ between the kernel and its plain twin at N=16.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys


def main(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    dev = torch.device("cuda:0")
    _build.library()
    fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128)
    cf = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev)
    rng = np.random.default_rng(0)
    B, N, n = 128, 700, 16
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P)
    e2, m2 = prepare_emissions(lhs[:, :n].contiguous(),
                               torch.full_like(lens, n), P)
    k, p = vs.viterbi_fwd(cf, e2, m2), vs.viterbi_fwd_plain(cf, e2, m2)
    diff = int((k[0] != p[0]).sum()) + int((k[1] != p[1]).sum())
    vs.viterbi_fwd(cf, ext, msh)  # warm-up
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        vs.viterbi_fwd(cf, ext, msh)
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return {"version": root, "sweep_ms": ts, "id_diffs": diff}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")))
