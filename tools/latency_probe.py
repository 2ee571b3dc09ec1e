"""The latency of one dependent load on the card: a pointer chase by one
thread, for the chain floors of the walks (``PERF.md`` §6: frames × round
trips × latency).  A development probe beside ``chip_smoke.py``, not part
of the package:

    python tools/latency_probe.py [--steps 20000]

Builds a small CUDA kernel with nvcc into ``build/latency_probe/`` and
chases ``j = p[j]`` with one thread of one CTA, timing ``steps`` loads with
``%globaltimer`` (ns) and ``clock64`` (SM cycles):

* ``shared``: a random cycle over 4,096 words of the CTA's shared memory;
* ``L2``: a random cycle over 4 MB (past L1, inside the 50 MB L2), read
  through L2 only (``ld.global.cg``) after one warm pass;
* ``device``: a random cycle over 2 GiB, 256 bytes apart (an L2 hit is
  rare: ~2 % of the lines), the first pass, so every line comes from
  device memory;
* ``device, warp gather (1 warp)`` / ``(128 warps)``: each lane of one
  warp (of 128 warps, one a CTA) chases its own random cycle over 2 GiB:
  every step one load instruction of 32 scattered sectors, as W2 gathers
  its alphas;
* ``device, frame stride``: as the walk over the ids reads them, each load
  ~6.3 MB (one 2M-arc frame of ids, 49,152 × 128 bytes) before the
  previous one at a random offset inside the frame, over 700 frames.

Prints the card's ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` line, then one JSON line: per chase the ns and
cycles per load, and the SM clock the cycles imply.  Imports nothing of
the JAX package.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long gtime() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
// one thread: j = p[j] for steps loads (mode 0: through L2 only, 1: a
// random cycle over n words of shared memory built from p), out[0] the
// last j, out[1] ns, out[2] cycles
__global__ void chase(const unsigned* __restrict__ p, int n, int steps,
                      int mode, unsigned start, long long* out) {
  __shared__ unsigned sm[4096];
  unsigned j = start;
  long long t0, c0, t1, c1;
  if (mode == 1) {
    for (int i = 0; i < n; ++i) sm[i] = p[i];
    __syncthreads();
    t0 = gtime();
    c0 = clock64();
    for (int i = 0; i < steps; ++i) j = *(volatile unsigned*)(sm + j);
  } else {
    t0 = gtime();
    c0 = clock64();
    for (int i = 0; i < steps; ++i) j = __ldcg(p + j);
  }
  c1 = clock64();
  t1 = gtime();
  out[0] = j;
  out[1] = t1 - t0;
  out[2] = c1 - c0;
}
// one warp per CTA, each lane its own chain from start + lane * n: each
// step one load instruction of 32 scattered addresses; block 0's lane 0
// times the steps
__global__ void gather(const unsigned* __restrict__ p, int n, int steps,
                       unsigned start, long long* out) {
  unsigned j = start + (blockIdx.x * 32 + threadIdx.x) * n;
  __syncwarp();
  const long long t0 = gtime(), c0 = clock64();
  for (int i = 0; i < steps; ++i) j = __ldcg(p + j);
  __syncwarp();
  const long long c1 = clock64(), t1 = gtime();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[1] = t1 - t0;
    out[2] = c1 - c0;
  }
  if (j == 0xffffffffu) out[0] = j;
}
extern "C" int run(const unsigned* p, int n, int steps, int mode,
                   unsigned start, long long* out) {
  if (mode >= 2)  // mode - 1 warps, one per CTA
    gather<<<mode - 1, 32>>>(p, n, steps, start, out);
  else
    chase<<<1, 1>>>(p, n, steps, mode, start, out);
  return (int)cudaGetLastError();
}
"""


def _cycle(torch, dev, n_words, nodes, seed):
    """A buffer of ``n_words`` uint32 whose ``nodes`` (word indices) form
    one random cycle: p[node_i] = node_{i+1}."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    order = nodes[torch.randperm(len(nodes), generator=g)]
    p = torch.zeros(n_words, dtype=torch.int32, device=dev)
    p[order.to(dev)] = torch.roll(order, -1).to(dev, torch.int32)
    return p, int(order[0])


def measure(steps: int = 20000) -> dict:
    """{chase: {"ns", "cycles", "sm_ghz"}} on the current card."""
    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from markovmodels_tpu_torch.ops import _build

    out_dir = os.path.join(root, "build", "latency_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f) for f in ("probe.cu", "probe.so"))
    with open(src, "w") as f:
        f.write(_SRC)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    dev = torch.device("cuda:0")
    out = torch.zeros(3, dtype=torch.int64, device=dev)

    def chase(p, n, mode, start, k=steps):
        assert so.run(p.data_ptr(), n, k, mode, start, out.data_ptr()) == 0
        torch.cuda.synchronize()
        ns, cyc = int(out[1]), int(out[2])
        return {"ns": ns / k, "cycles": cyc / k}

    rows = {}
    p, s0 = _cycle(torch, dev, 4096, torch.arange(4096), 1)
    chase(p, 4096, 1, s0, 100)
    rows["shared"] = chase(p, 4096, 1, s0)
    n = (4 << 20) // 4  # 4 MB: one node per 128-byte line
    p, s0 = _cycle(torch, dev, n, torch.arange(0, n, 32), 2)
    chase(p, n, 0, s0, n // 32)  # warm pass: every line into L2
    rows["L2"] = chase(p, n, 0, s0)
    n = (2 << 30) // 4  # 2 GiB, one node per 256 bytes
    p, s0 = _cycle(torch, dev, n, torch.arange(0, n, 64), 3)
    rows["device"] = chase(p, n, 0, s0)
    del p
    # warp gathers: lane l of 32 × warps chases a random cycle through the
    # 256-byte nodes of its own slice [l S, (l + 1) S) of 2 GiB, from node 0
    n = (2 << 30) // 4
    for warps in (1, 128):
        lanes = 32 * warps
        per = n // lanes // 64  # nodes a chain
        S = per * 64
        g = torch.Generator(device="cpu").manual_seed(5 + warps)
        perm = torch.argsort(torch.rand(lanes, per, generator=g), dim=1)
        base = (torch.arange(lanes) * S)[:, None]
        at = base + 64 * perm
        to = base + 64 * torch.roll(perm, -1, dims=1)
        p = torch.zeros(n, dtype=torch.int32, device=dev)
        p[at.reshape(-1).to(dev)] = to.reshape(-1).to(dev, torch.int32)
        name = f"device, warp gather ({warps} warp{'s' * (warps > 1)})"
        rows[name] = chase(p, S, 1 + warps, 0, min(steps, per - 1))
        del p, at, to
    frame = 49_152 * 128 // 4  # words of one frame of ids
    nf = 700
    g = torch.Generator(device="cpu").manual_seed(4)
    offs = torch.randint(0, frame // 32, (nf,), generator=g) * 32
    nodes = (torch.arange(nf - 1, -1, -1) * frame + offs).to(torch.int64)
    p = torch.zeros(nf * frame, dtype=torch.int32, device=dev)
    p[nodes.to(dev)] = torch.roll(nodes, -1).to(dev, torch.int32)
    rows["device, frame stride"] = chase(p, nf * frame, 0, int(nodes[0]),
                                         nf - 1)
    del p
    torch.cuda.empty_cache()
    for r in rows.values():
        r["sm_ghz"] = r["cycles"] / r["ns"]
    return rows


def main(steps: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("latency_probe: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"card": card, "latency": measure(steps)}), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    sys.exit(main(ap.parse_args().steps))
