"""Throughput of the double max on the card: a development probe beside
``ab_vit.py`` (not part of the package), for choosing how K7's float64 tier
takes its maxima (``markovmodels_tpu_torch/ops/csrc/vit_scan.cu``
tier_dbl).

    python tools/fp64_max_probe.py [--iters 20000]

Builds a small CUDA kernel with nvcc into ``build/fp64_max_probe/`` and
runs it on 2 CTAs of 256 threads per SM: each thread keeps 16 independent
chains, each step one DMUL (``p = w * x``) and one way of folding p into
the chain's value:

* ``DMUL + DFMA``: a dependent DFMA (the full FP64 rate, two operations);
* ``DMUL + fmax``: ``fmax(m, p)``;
* ``DMUL + int64 max``: the max of the products' bits as signed 64-bit
  integers (non-negative doubles order as their bits);
* ``DMUL + compare``: ``p > m ? p : m``;
* ``fmax only``: ``fmax`` without the DMUL.

Prints the candidates (steps) per second per SM of each, the card's name,
power limit and SM clock, and the instruction mix of each kernel's SASS
(``cuobjdump -sass``), so that what ``fmax`` compiles to on sm_90 shows.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

_SRC = r"""
#include <cuda_runtime.h>
template <int OP>
__global__ void __launch_bounds__(256, 2) probe(const double* in, double* out,
                                               int iters) {
  double acc[16], w[16];
  long long ib[16];
  for (int i = 0; i < 16; ++i) {
    acc[i] = -1.0;
    w[i] = in[(threadIdx.x + i) & 63];
    ib[i] = -1;
  }
  double x = in[threadIdx.x & 63];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const double p = __dmul_rn(w[i], x);
      if (OP == 0) acc[i] = p + 0.0 * acc[i];
      if (OP == 1) acc[i] = fmax(acc[i], p);
      if (OP == 2) ib[i] = max(ib[i], __double_as_longlong(p));
      if (OP == 3) acc[i] = p > acc[i] ? p : acc[i];
      if (OP == 4)
        acc[i] = fmax(acc[i],
                      __longlong_as_double(__double_as_longlong(w[i]) ^ it));
    }
    x = x * 1.0000001;
  }
  double s = 0;
  for (int i = 0; i < 16; ++i) s += acc[i] + (double)ib[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int op, const double* in, double* out, int blocks,
                   int iters) {
  switch (op) {
    case 0: probe<0><<<blocks, 256>>>(in, out, iters); break;
    case 1: probe<1><<<blocks, 256>>>(in, out, iters); break;
    case 2: probe<2><<<blocks, 256>>>(in, out, iters); break;
    case 3: probe<3><<<blocks, 256>>>(in, out, iters); break;
    case 4: probe<4><<<blocks, 256>>>(in, out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""
_NAMES = ["DMUL + DFMA", "DMUL + fmax", "DMUL + int64 max", "DMUL + compare",
          "fmax only"]


def main(iters: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp64_max_probe: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from markovmodels_tpu_torch.ops import _build

    out_dir = os.path.join(root, "build", "fp64_max_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(_SRC)
    nvcc = _build._nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3"]
    lib = os.path.join(out_dir, "probe.so")
    cubin = os.path.join(out_dir, "probe.cubin")
    subprocess.run([nvcc, *arch, "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                    src], check=True)
    subprocess.run([nvcc, *arch, "-cubin", "-o", cubin, src], check=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int]
    dev = torch.device("cuda:0")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    inp = torch.rand(64, dtype=torch.float64, device=dev)
    blocks = 2 * n_sm
    out = torch.empty(blocks * 256, dtype=torch.float64, device=dev)
    for op, name in enumerate(_NAMES):
        assert so.run(op, inp.data_ptr(), out.data_ptr(), blocks, 10) == 0
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        assert so.run(op, inp.data_ptr(), out.data_ptr(), blocks, iters) == 0
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        n = blocks * 256 * iters * 16
        print(f"{name}: {ms:.3f} ms, {n / ms / 1e6 / n_sm:.2f} G candidates/s "
              "per SM", flush=True)
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        op = int(re.search(r"probeILi(\d)E", fn.split("\n")[0]).group(1))
        mix = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?P\d\s+)?([A-Z0-9_.]+)", fn))
        print(f"SASS of {_NAMES[op]}: " + ", ".join(
            f"{k} {v}" for k, v in mix.most_common(8)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    sys.exit(main(ap.parse_args().iters))
