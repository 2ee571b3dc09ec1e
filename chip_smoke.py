#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``markovmodels_tpu_torch``).

Drives the port's main path, ``pdfposteriors`` on the 2M-arc trigram-LM ∘
HMM denominator (49,153 states, 2,195,457 arcs, 384 pdfs) at B=128
sequences × N=700 frames, through the hand-written CUDA kernels K2-K4 of
``markovmodels_tpu_torch/ops/csrc/block_scan.cu``, in phases:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from the sources in the checkout (nvcc, sm_90a);
3. build the graph, compile it (strategy 'block', precision 'high') and
   move it to the card;
4. each kernel against its plain PyTorch twin on the same inputs, at the
   main-path graph with B=128 and N=128 (a mid-sequence chunk boundary,
   mixed lengths, ±30-nat emission cliffs);
5. ``pdfposteriors`` at B=2, N=40 against the exact float64 host oracle
   (``bench.host_oracle``): |ΔlogZ| and |Δposts| ≤ 1e-4;
6. the main path at B=128, N=700 with launch counters, output checks, and
   the kernel path timed beside the plain PyTorch scan on the card.

Needs one CUDA card; exits non-zero before printing any result when there
is none or when any phase fails.  Run from the root of the checkout:

    python3 chip_smoke.py

The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.
"""
import json
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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    import torch

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


def phase_kernels(cf, P, dev, B=128, N=128, chunk=64):
    """Phase 4: K2, K3 and K4 against their plain twins on one input."""
    import torch

    from markovmodels_tpu_torch import inference as tinf
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

    def logz(out):
        _, _, a, s, ksum, shift = out
        return tinf._combine_shift(tinf._log_final(a[kop.fin] * s), ksum,
                                   shift)

    def norm(a, s):
        return a * s[..., None, :] if a.dim() == 3 else a * s[None, :]

    errs = {}
    fk = bs.fwd_sweep(kop, a0, ext, msh, K)
    torch.cuda.synchronize()
    fp = bs.fwd_sweep_plain(kop, a0, ext, msh, K)
    zk, zp = logz(fk).cpu().numpy(), logz(fp).cpu().numpy()
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K2: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1], "K2: unexpected -inf pattern"
    errs["K2"] = max(
        float(np.abs(zk[fin] - zp[fin]).max()),
        float((norm(fk[0], fk[1]) - norm(fp[0], fp[1])).abs().max()),
        float((norm(fk[2], fk[3]) - norm(fp[2], fp[3])).abs().max()),
    )

    c = C // 2  # a chunk in the middle of the sequence
    sl = slice(c * K, (c + 1) * K)
    ak, sk = bs.recompute(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    torch.cuda.synchronize()
    ap, sp = bs.recompute_plain(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    errs["K3"] = float((norm(ak, sk) - norm(ap, sp)).abs().max())

    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev)
    for cc in reversed(range(C)):  # the backward over every chunk
        slc = slice(cc * K, (cc + 1) * K)
        al, asc = bs.recompute(kop, fk[0][cc], fk[1][cc], ext[slc], cc * K)
        pk, bk, bsk = bs.backward(kop, beta, bsc, al, asc, ext[slc], cc * K,
                                  Npad)
        torch.cuda.synchronize()
        pp, bp, bsp = bs.backward_plain(kop, beta, bsc, al, asc, ext[slc],
                                        cc * K, Npad)
        errs["K4"] = max(
            errs.get("K4", 0.0),
            float((pk - pp).abs().max()),
            float((norm(bk, bsk) - norm(bp, bsp)).abs().max()),
        )
        beta, bsc = bk, bsk
    for name, e in errs.items():
        print(f"phase 4: {name} kernel vs plain max |err| = {e:.3e} "
              f"(tol {TOL_KERNEL:g})")
        assert np.isfinite(e) and e <= TOL_KERNEL, f"{name} disagrees: {e}"
    return errs


def phase_oracle(fsm, spdf, cf, P, dev, n=40):
    """Phase 5: pdfposteriors at B=2 against the exact f64 host oracle."""
    import torch

    import bench
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref_z, ref_p = bench.host_oracle(fsm, spdf, P, lhs.astype(np.float64),
                                     lens)
    posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                torch.from_numpy(lens).to(dev))
    err = float(np.abs(z.cpu().numpy() - ref_z).max())
    perr = float(np.abs(posts.cpu().numpy() - ref_p).max())
    print(f"phase 5: B=2 N={n} vs f64 oracle |dlogZ| = {err:.3e}, "
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


def time_kernels(cf, P, dev, B=128, N=700, chunk=64):
    """Each kernel and its plain twin at the main path's shapes: K2 over
    all Npad frames, K3 and K4 over one 64-frame chunk."""
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
    return out


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
    cf = mt.compile_fsm(fsm, spdf, P, strategy="block",
                        precision="high").to(dev)
    print(f"phase 3: graph {info} compiled in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {cf.padded_states}; "
          f"path: {mt.fast_path_report(cf, 128)}")

    errs = phase_kernels(cf, P, dev)
    phase_oracle(fsm, spdf, cf, P, dev)
    launches, t_kern, t_plain = phase_main(cf, P, dev)
    times = time_kernels(cf, P, dev)

    sources = "markovmodels_tpu_torch/ops/csrc/block_scan.cu"
    replaces = {"K2": "markovmodels_tpu/ops/pallas_block.py:862",
                "K3": "markovmodels_tpu/ops/pallas_block.py:907",
                "K4": "markovmodels_tpu/ops/pallas_block.py:945"}
    counters = {"K2": "block_fwd", "K3": "block_recompute",
                "K4": "block_bwd"}
    kernels = [
        {"name": f"{name} {counters[name]}", "route": "cuda",
         "source": sources, "replaces": replaces[name],
         "launches": launches[counters[name]], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("K2", "K3", "K4")
    ]
    print(f"card: {card}; pdfposteriors B=128 N=700 kernel path "
          f"{t_kern:.2f} ms, plain path {t_plain:.2f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
