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


def main(root: str, runs: int, split: bool, trace: bool = False,
         graph: str = "2m", f64: bool = False) -> dict:
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
    del out, again
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
    return row


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--graph", choices=("2m", "separate"), default="2m")
    ap.add_argument("--f64", action="store_true")
    a = ap.parse_args()
    print(json.dumps(main(a.root, a.runs, a.split, a.trace, a.graph, a.f64)),
          flush=True)
