"""A/B timing of the K7 sweep, for comparing two versions of the kernel on
one card within one process each (a development script beside
``chip_smoke.py``, not part of the package):

    python ab_vit.py . --split
    for v in P C C P P C; do python ab_vit.py build/v$v; done

The argument is the root of a copy of the package (its parent directory);
that copy builds its own library under ``<root>/build/``.  For an A/B
against the parent commit, unpack its package into a gitignored directory
(``git archive HEAD markovmodels_tpu_torch | tar -x -C build/vP``) and run
the versions in turns P, C, C, P, P, C in one call.  Prints one JSON line
at the 2M-arc graph with B=128, N=700 (``normal·0.5`` log-likelihoods from
seed 0, every length N):

* ``sweep_ms``: ``--runs`` warm times of the sweep (default 9), CUDA
  events, and their ``mean``, ``min`` and ``max``;
* ``sums``: float64 sums of the sweep's five outputs (the ids, the ω
  argmaxes, the final value, the shift, the exponent sum), equal between
  two versions whose kernels compute bit for bit the same, and
  ``bitequal``: two runs bit-equal;
* ``id_diffs``: the ids plus ω argmaxes that differ between the kernel and
  its plain twin at N=16;
* ``ctas``: the persistent grid's CTAs (a version with a persistent K7);
* with ``--graph separate``, all of it on the separate-state backoff graph
  (V=128, keep 0.1, the default capped layout): K7's family branch;
* with ``--f64``, all of it on the graph compiled float64 (the
  log-likelihoods in float64): K7's float64 instantiation;
* with ``--noid``, K7n at N=1,024 (``normal·0.5`` from seed 1): ``noid_ms``
  the checkpoint sweep over 1,025 frames (stride 64) and ``rec_ms`` one
  64-frame recompute from checkpoint 8 (``--runs`` warm times each, CUDA
  events), ``noid_sums`` float64 sums of both sweeps' outputs (the saved
  states and scales, the last state and scale, the carried sums), and
  ``noid_twin``: the recompute bit-equal to its plain twin; with
  ``--split`` too, ``noid_split_us``: K7n's frame split on that input
  (the checkpoint sweep's form, stride 64);
* with ``--decode``, ``decode_ms``: ``viterbi`` at B=128, N=1,024 past the
  id budget (the chunk-recompute decode: K7n and W2; ``normal·0.5`` from
  seed 1), one warm-up and ``--runs`` runs on the host clock to a
  synchronize, and their ``decode_median``;
* with ``--walk``, the two walks, ``--runs`` times each (CUDA events, each
  the mean of 10 launches back to back after 30 warm ones) and float64
  sums of their outputs (equal between versions whose
  walks give the same states): ``walk_ms``, the walk over the ids of this
  graph's K7 sweep above (700 frames); ``w2_chunk_ms``, W2 over one
  64-frame chunk (chunk 8) of the graph's recompute decode at N=1,024
  (``normal·0.5`` from seed 1), from the states the decode gives the
  frame after it; ``w2_dense_ms``, W2 over the 701 frames of the V=32
  dense graph's K6t sweep at B=128, N=700 (seed 0), from the phony state;
  with ``--f64`` the float64 graphs and inputs;
* with ``--ptxas FILE``, the library's ``ptxas -v`` report written to
  FILE where this process built the library (a fresh copy builds its
  own; a later process finds it built and writes nothing);
* with ``--split``, ``split_us``: µs per frame of the sweep on the whole
  forward operator and on three cut copies of it
  (``chip_smoke.vit_frame_split``): no tier (the tier's rows taken as band
  rows), no bands (no band offsets), and without work (neither), three
  warm runs each.  A cut operator is a timing probe, not the graph's
  function;
* with ``--trace``, ``trace``: a traced copy of the root's persistent
  ``vit_scan.cu`` built into ``<root>/build/trace/`` (``%globaltimer``
  stamps by thread 0 of each CTA in frame ``_TRACE_T``, at the anchors of
  ``_ITEM_ANCHORS`` and ``_CTA_ANCHORS``): µs from the frame's first start
  of the frame's end-of-frame work, of each part of the tier and band
  items (staging, group loop with the id recovery, epilogue), when the
  last tier and band items end, the barrier arrivals (median, last), and
  the share of the frame the CTAs spend in items.  The stamps slow the
  traced frame a little.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _ms(fn, reps):
    """``reps`` warm times of ``fn`` in ms (one warm-up), CUDA events."""
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


def _ms_steady(fn, reps, inner=10, warm=30):
    """``reps`` times of ``fn`` in ms, each the mean of ``inner`` launches
    back to back, after ``warm`` launches: a walk launch is ~0.1–1 ms, too
    short alone to bring the card's clocks up from the host work before
    it (single launches read 1.5–3x slow, falling run by run)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return ts


_TRACE_T = 350  # the traced frame
# (anchor: the start of a line, insert before/after, stamp index) in
# vit_item: item start,
# staged, group loop and ids done, epilogue start, epilogue end
_ITEM_ANCHORS = [
    ("    long long j = -1;", "before2", 0, ""),
    ("      const long long nS = m.Sm - s0 < SC ? m.Sm - s0 : SC;", "before", 1,
     ""),
    ("      tier_max_arg(s, ", "after", 2, ""),
    ("  float scv[4], pfv[4];", "before", 3, ""),
    ("    s.u.ep.rm[ty][tx * 4 + c] = __float_as_uint(colmax[c]);",
     "before3", 4, ""),
]
_ITEM_END = ("  __syncthreads();  // the tables and the union are free for the "
             "next item")
# in the kernel: frame start, end-of-frame work done, barrier arrive, leave
_CTA_ANCHORS = [
    ("  for (int t = 0; t < p.Nf; ++t) {", "after", 0),
    ("    if (tid == 0) s.next[0] = take();", "before", 1),
    ("    grid_sync<SYNC_GEN, 256, true>(p.sync);", "before", 2),
    ("    grid_sync<SYNC_GEN, 256, true>(p.sync);", "after", 3),
]
_TRACE_PRELUDE = r"""
#define MM_TRACE_T %d
__device__ long long mm_tr_item[8192][6];
__device__ long long mm_tr_cta[2048][4];
__device__ unsigned mm_tr_n;
__device__ __forceinline__ long long mm_gt() {
  long long v;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(v));
  return v;
}
""" % _TRACE_T
_TRACE_READ = r"""
extern "C" int mm_vit_trace_read(long long* items, long long* ctas,
                                 unsigned* n) {
  cudaError_t e = cudaMemcpyFromSymbol(items, mm_tr_item, sizeof(mm_tr_item));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(ctas, mm_tr_cta, sizeof(mm_tr_cta));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, mm_tr_n, sizeof(unsigned));
  return static_cast<int>(e);
}
extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def _traced_library(root: str):
    """Build the traced copy of the root's vit_scan.cu and load it."""
    import ctypes
    import subprocess

    from markovmodels_tpu_torch.ops import _build

    csrc = os.path.join(root, "markovmodels_tpu_torch", "ops", "csrc")
    lines = open(os.path.join(csrc, "vit_scan.cu")).read().split("\n")
    on = "if (t == MM_TRACE_T && threadIdx.x == 0)"

    def insert(anchor, where, stmt):  # the first line starting so
        n = next(k for k, ln in enumerate(lines) if ln.startswith(anchor))
        at = {"before": n, "after": n + 1, "before2": n - 1,
              "before3": n - 2}[where]
        lines.insert(at, stmt)

    for anchor, where, i, cond in _ITEM_ANCHORS:
        insert(anchor, where, on.replace("if (", "if (" + cond)
               + f" mm_st[{i}] = mm_gt();")
    insert(_ITEM_END, "after",
           f"{on} {{ const unsigned n_ = atomicAdd(&mm_tr_n, 1u);"
           " if (n_ < 8192) { for (int q = 0; q < 5; ++q)"
           " mm_tr_item[n_][q] = mm_st[q]; mm_tr_item[n_][5] ="
           " (static_cast<long long>(blockIdx.x) << 32) | (is_tier ? 1 : 0);"
           " } }")
    n = lines.index("  const bool is_tier = tile < m.n_tier_tiles;")
    lines.insert(n + 1, "  long long mm_st[5] = {0, 0, 0, 0, 0};")
    for anchor, where, i in _CTA_ANCHORS:
        hits = [k for k, ln in enumerate(lines) if ln == anchor]
        at = hits[0] + (1 if where == "after" else 0)
        lines.insert(at, f"{on} mm_tr_cta[blockIdx.x][{i}] = mm_gt();")
    out_dir = os.path.join(root, "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "vit_trace.cu")
    with open(src, "w") as f:
        f.write(_TRACE_PRELUDE + "\n".join(lines) + _TRACE_READ)
    lib_path = os.path.join(out_dir, "libvit_trace.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-I", csrc,
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    for name, args in _build._SIGNATURES.items():
        if name.startswith("mm_vit"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    lib.mm_error_string.argtypes = [ctypes.c_int]
    lib.mm_error_string.restype = ctypes.c_char_p
    return lib


def _trace(root, vs, cf, ext, msh) -> dict:
    """One sweep of the traced copy: the parts of frame _TRACE_T in µs."""
    import ctypes

    import numpy as np
    import torch

    from markovmodels_tpu_torch.ops import _build

    lib = _traced_library(root)
    saved, _build._LIB = _build._LIB, lib  # the wrapper launches it
    try:
        vs.viterbi_fwd(cf, ext, msh)
        torch.cuda.synchronize()
    finally:
        _build._LIB = saved
    items = np.zeros((8192, 6), np.int64)
    ctas = np.zeros((2048, 4), np.int64)
    n = np.zeros(1, np.uint32)
    rc = lib.mm_vit_trace_read(ctypes.c_void_p(items.ctypes.data),
                               ctypes.c_void_p(ctas.ctypes.data),
                               ctypes.c_void_p(n.ctypes.data))
    assert rc == 0, rc
    it = items[:int(n[0])]
    c = ctas[ctas[:, 0] > 0]
    t0 = c[:, 0].min()
    us = lambda x: float(x) / 1e3
    tier = it[(it[:, 5] & 1) == 1]
    band = it[(it[:, 5] & 1) == 0]
    busy = (it[:, 4] - it[:, 0]).sum() / (len(c) * (c[:, 3].max() - t0))
    out = {"frame_us": us(c[:, 3].max() - t0),
           "end_of_frame_us": us(np.mean(c[:, 1] - c[:, 0])),
           "n_tier": int(len(tier)), "n_band": int(len(band)),
           "tier_item_us": us(np.mean(tier[:, 4] - tier[:, 0])),
           "tier_staging_us": us(np.mean(tier[:, 1] - tier[:, 0])),
           "tier_loop_ids_us": us(np.mean(tier[:, 2] - tier[:, 1])),
           "tier_epilogue_us": us(np.mean(tier[:, 4] - tier[:, 3])),
           "band_item_us": us(np.mean(band[:, 4] - band[:, 0])),
           "last_tier_end_us": us(tier[:, 4].max() - t0),
           "last_band_end_us": us(band[:, 4].max() - t0),
           "arrive_median_us": us(np.median(c[:, 2]) - t0),
           "arrive_last_us": us(c[:, 2].max() - t0),
           "cta_busy_share": float(busy)}
    return out


def _noid(vs, cf, P, dt, dev, runs, split=False) -> dict:
    """K7n's checkpoint sweep and one recompute at B=128, N=1,024 (with
    ``split``, its frame split)."""
    import numpy as np
    import torch

    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(1)
    B, N, K = 128, 1024, 64
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    ck = vs.viterbi_fwd(cf, ext, msh, ids=False, stride=K)
    t_ck = _ms(lambda: vs.viterbi_fwd(cf, ext, msh, ids=False, stride=K),
               runs)
    rec = dict(a0=ck[0][7], s0=ck[1][7], t0=8 * K)
    e_c, m_c = ext[8 * K:9 * K], msh[8 * K:9 * K]
    out = vs.viterbi_fwd(cf, e_c, m_c, ids=False, **rec)
    t_rec = _ms(lambda: vs.viterbi_fwd(cf, e_c, m_c, ids=False, **rec),
                runs)
    plain = vs.viterbi_fwd_plain(cf, e_c, m_c, ids=False, **rec)
    torch.cuda.synchronize()
    twin = all(torch.equal(x, y) for x, y in zip(out, plain))
    sums = [float(t.double().sum()) for t in (*ck, *out)]
    row = {"noid_ms": t_ck, "noid_mean": sum(t_ck) / len(t_ck),
           "rec_ms": t_rec, "rec_mean": sum(t_rec) / len(t_rec),
           "noid_sums": sums, "noid_twin": twin}
    if split:
        from chip_smoke import vit_frame_split

        del ck, out, plain
        row["noid_split_us"] = vit_frame_split(cf, ext, msh, ids=False,
                                               stride=K)
    return row


def _walks(mt, vs, cf, out, lens, P, dt, dev, runs) -> dict:
    """The walk over ``out``'s ids, W2 on a chunk of the recompute decode
    at N=1,024, and W2 on the V=32 dense decode: times and sums."""
    import importlib

    import numpy as np
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    wt = vs.walk_tables(cf)
    walked = vs.walk(wt, out[0], out[1], lens)
    row = {"walk_ms": _ms_steady(lambda: vs.walk(wt, out[0], out[1], lens),
                                 runs)}
    sums = [float(walked.double().sum())]
    del out, walked

    rng = np.random.default_rng(1)
    B, N, K = 128, 1024, 64
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev, dt)
    ln = torch.full((B,), N, dtype=torch.int32, device=dev)
    states, _ = tvit._viterbi_recompute(cf, lhs, ln, K)
    real = torch.nonzero(cf.orig_state >= 0)[:, 0]
    to_compiled = torch.empty_like(cf.orig_state)
    to_compiled[cf.orig_state[real].long()] = real.to(torch.int32)
    t0 = 8 * K
    s_end = to_compiled[states[:, t0 + K].long()].contiguous()
    ext, msh = prepare_emissions(lhs, ln, P, dt)
    ck = vs.viterbi_fwd(cf, ext, msh, ids=False, stride=K)
    rec = vs.viterbi_fwd(cf, ext[t0:t0 + K], msh[t0:t0 + K], ids=False,
                         a0=ck[0][7], s0=ck[1][7], t0=t0)
    del ck
    rw = vs.rec_walk_tables(cf)
    path = vs.rec_walk(rw, rec[0], rec[1], ln, t0, s_end)
    row["w2_chunk_ms"] = _ms_steady(lambda: vs.rec_walk(
        rw, rec[0], rec[1], ln, t0, s_end), runs)
    row["w2_chunk_twin"] = torch.equal(path, vs.rec_walk_plain(
        rw, rec[0], rec[1], ln, t0, s_end))
    sums.append(float(path.double().sum()))
    del rec, ext, msh

    kw = {"dtype": dt} if dt == torch.float64 else {}
    dfsm, dspdf, dP, _ = mt.workloads.make_lm_hmm_graph(V=32)
    dcf = mt.compile_fsm(dfsm, dspdf, dP, device=dev, **kw)
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(
        (rng.normal(size=(B, 700, dP)) * 0.5).astype(np.float32)).to(dev, dt)
    ln = torch.full((B,), 700, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, ln, dP, dt)
    kop = ds.trop_operator(dcf)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    sw = ds.trop_sweep(kop, a0, torch.ones(B, device=dev, dtype=dt), ext,
                       msh, first=True)
    dw = vs.rec_walk_tables(dcf)
    s_fin = torch.full((B,), dw.fin, dtype=torch.int32, device=dev)
    path = vs.rec_walk(dw, sw[0], sw[1], ln, 0, s_fin)
    row["w2_dense_ms"] = _ms_steady(lambda: vs.rec_walk(
        dw, sw[0], sw[1], ln, 0, s_fin), runs)
    row["w2_dense_twin"] = torch.equal(path, vs.rec_walk_plain(
        dw, sw[0], sw[1], ln, 0, s_fin))
    sums.append(float(path.double().sum()))
    for k in ("walk_ms", "w2_chunk_ms", "w2_dense_ms"):
        row[k.replace("_ms", "_mean")] = sum(row[k]) / len(row[k])
    row["walk_sums"] = sums
    return row


def _decode(mt, cf, P, dt, dev, runs) -> dict:
    """``viterbi`` at B=128, N=1,024 (past the id budget), host ms."""
    import time

    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    B, N = 128, 1024
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ts = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mt.viterbi(cf, lhs, lens)
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    ts = ts[1:]  # the first is the warm-up
    return {"decode_ms": ts, "decode_median": sorted(ts)[len(ts) // 2]}


def main(root: str, runs: int, split: bool, trace: bool = False,
         graph: str = "2m", f64: bool = False, noid: bool = False,
         ptxas: str = "", decode: bool = False, walk: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    import markovmodels_tpu_torch as mt
    from chip_smoke import vit_frame_split
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    dev = torch.device("cuda:0")
    _build.library()
    if ptxas and _build.PTXAS_LOG:  # this process built the library
        with open(ptxas, "w") as f:
            f.write(_build.PTXAS_LOG)
    dt = torch.float64 if f64 else torch.float32
    kw = {"dtype": dt} if f64 else {}
    if graph == "separate":  # the capped layout: K7's family branch
        fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
            V=128, keep=0.1, layout="separate")
        cf = mt.compile_fsm(fsm, spdf, P, device=dev, **kw)
    else:
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128)
        cf = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev,
                            **kw)
    rng = np.random.default_rng(0)
    B, N, n = 128, 700, 16
    lhs = torch.from_numpy(
        (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    e2, m2 = prepare_emissions(lhs[:, :n].contiguous(),
                               torch.full_like(lens, n), P, dt)
    k, p = vs.viterbi_fwd(cf, e2, m2), vs.viterbi_fwd_plain(cf, e2, m2)
    diff = int((k[0] != p[0]).sum()) + int((k[1] != p[1]).sum())
    del k, p
    out = vs.viterbi_fwd(cf, ext, msh)
    again = vs.viterbi_fwd(cf, ext, msh)
    torch.cuda.synchronize()
    bitequal = all(torch.equal(x, y) for x, y in zip(out, again))
    sums = [float(t.double().sum()) for t in out]
    del again
    if walk:
        walks = _walks(mt, vs, cf, out, lens, P, dt, dev, runs)
    del out
    ts = _ms(lambda: vs.viterbi_fwd(cf, ext, msh), runs)
    row = {"version": root, "graph": graph + (" f64" if f64 else ""),
           "sweep_ms": ts,
           "mean": sum(ts) / len(ts),
           "min": min(ts), "max": max(ts), "sums": sums,
           "bitequal": bitequal, "id_diffs": diff}
    if hasattr(vs, "_vit_grid"):  # the persistent kernel's CTAs
        row["ctas"] = vs._vit_grid(bs.kernel_operator(cf, dt), dev, B)
    if split:
        row["split_us"] = vit_frame_split(cf, ext, msh)
    if trace:
        row["trace"] = _trace(root, vs, cf, ext, msh)
    if noid:
        del ext, msh, e2, m2
        row.update(_noid(vs, cf, P, dt, dev, runs, split))
    if decode:
        row.update(_decode(mt, cf, P, dt, dev, runs))
    if walk:
        row.update(walks)
    return row


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--graph", choices=("2m", "separate"), default="2m")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--noid", action="store_true")
    ap.add_argument("--ptxas", default="")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--walk", action="store_true")
    a = ap.parse_args()
    print(json.dumps(main(a.root, a.runs, a.split, a.trace, a.graph, a.f64,
                          a.noid, a.ptxas, a.decode, a.walk)), flush=True)
