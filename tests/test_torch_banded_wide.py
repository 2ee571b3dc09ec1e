"""The wide and global instantiations of K5a/K5b (stacked numerators past
the narrow K5's 1,024 states): the host's partition of a lattice's states
over the chain's threads, and torch emulations of the kernels' fixed-order
reductions held to the plain twins, which the kernels are held to on the
card (``chip_smoke.py`` phase 8b).

The wide kernels run one graph's chain on 256 threads (8 warps): thread i
owns states i, i + 256, ..., J of them (``banded_scan._wide_j``); the
global ones loop over the same states in the same order.  A frame's omega
dot (K5a) and gamma sum (K5b) are each thread's partial over its states in
order, a butterfly over the warp's lanes, then the 8 warps' partials added
in warp order; the rescale's exponent is the max of the states' exponent
keys.  Inputs: numerator lattices with skip arcs (three band offsets; the
generator of ``chip_smoke.skip_numerators``, copied), made from numpy
seeds; a stack of ~2,500-state lattices, which only the global
instantiation takes, runs through the port's plain stacked scan against
the JAX package's stacked scan in float64 (logZ, and the posteriors as its
gradient) and the float64 host oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu_torch.ops import banded_scan as bsc
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import compile_port

P = 40
WT = bsc._WT
TOL = 1e-4  # logZ and posteriors against the f64 oracle (the contract)


def skip_numerators(P, lengths, seed, lib):
    """Numerator lattices with skip arcs (i -> i + 2 besides the self-loop
    and the chain: three band offsets), the last over 3 pdfs only (each
    repeated), built by ``lib`` (``chip_smoke.skip_numerators``)."""
    rng = np.random.default_rng(seed)
    out = []
    for g, Lp in enumerate(lengths):
        seq = rng.integers(0, 3 if g == len(lengths) - 1 else P, size=Lp)
        arcs = ([((i, i), np.log(0.5)) for i in range(Lp)]
                + [((i, i + 1), np.log(0.3)) for i in range(Lp - 1)]
                + [((i, i + 2), np.log(0.2)) for i in range(Lp - 2)])
        fsm = lib.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [lib.labels.Label(int(s)) for s in seq], lib.semiring.LOG)
        out.append((fsm, np.append(seq, P).astype(np.int32)))
    return out


def _stack(lengths, seed, dtype=torch.float64):
    return mt.stack([compile_port(f, sp, P, strategy="banded", dtype=dtype)
                     for f, sp in skip_numerators(P, lengths, seed, mt)])


@pytest.mark.parametrize("Sp", [8, 255, 256, 257, 1024, 1025, 1208, 1280])
def test_wide_partition_owns_every_state_once(Sp):
    """Thread i of the chain owns states i + 256 j, j < J: every state of
    the lattice once, and J the smallest instantiated count that covers
    Sp; a band source of any offset is read from the previous frame's
    state, so no halo bounds the offsets (any |offset| < Sp)."""
    J = bsc._wide_j(Sp)
    assert J in bsc._WIDE_J and J * WT >= Sp
    assert all(j * WT < Sp for j in bsc._WIDE_J if j < J)
    assert bsc._modes(Sp, 3)[0] == ("wide" if Sp > 1024 else "narrow")
    owner = np.full(J * WT, -1)
    for tid in range(WT):
        for j in range(J):
            s = tid + WT * j
            if s < Sp:
                assert owner[s] == -1
                owner[s] = tid
    assert (owner[:Sp] >= 0).all() and (owner[Sp:] == -1).all()
    for off in (0, 1, 2, Sp - 1, -(Sp - 1)):
        src = np.clip(np.arange(J * WT) - off, 0, Sp - 1)
        assert src.min() >= 0 and src.max() < Sp


def _butterfly(w):
    """(..., 32, G) lane partials -> (..., G): the xor butterfly 16 .. 1
    over the lanes (every lane ends with the same sum; lane 0's)."""
    lanes = torch.arange(32)
    for d in (16, 8, 4, 2, 1):
        w = w + w[..., lanes ^ d, :]
    return w[..., 0, :]


def _lanes_then_warps(part):
    """A (WT, G) array of per-thread partial sums reduced as the kernels
    do: the butterfly over each warp's 32 lanes, then the warps' sums
    added in warp order."""
    w = _butterfly(part.reshape(WT // 32, 32, -1))
    out = w[0]
    for k in range(1, WT // 32):
        out = out + w[k]
    return out


def _threads(x, J):
    """(Sp, G) -> (J, WT, G): thread i's states i + WT j along j, zero
    past Sp."""
    Sp, G = x.shape
    pad = x.new_zeros((J * WT, G))
    pad[:Sp] = x
    return pad.reshape(J, WT, G)


def _exp_key(v):
    """The kernels' exponent key of non-negative float64 values: 0 for 0,
    else the biased exponent, at least 1 (a subnormal counts as the
    smallest normal)."""
    _, e = torch.frexp(v)
    return torch.where(v > 0, (e - 1 + 1023).clamp(min=1),
                       torch.zeros_like(e))


def emulate_k5a_wide(kop, ext, mshift):
    """K5a's wide (and global) forward in float64, in the kernels' order:
    each frame's omega dot over the previous frame's states by thread,
    lane and warp (``_lanes_then_warps``), the band terms in the offsets'
    order from 0, and the exponent from the max of the states' keys (the
    phony final row's band value left out) and the final row's.  A fused
    multiply-add is a multiply then an add here.  Returns the sweep's
    (alphas, vfin, shift, ksum)."""
    Nf, _, G = ext.shape
    Sp, J = kop.Sp, -(-kop.Sp // WT)
    fin = kop.fin.long()
    cols = torch.arange(G)
    om = kop.om.double()
    alphas = torch.empty((Nf, Sp, G), dtype=torch.float64)
    ksum = torch.zeros(G, dtype=torch.float64)
    shift = torch.zeros(G, dtype=torch.float64)
    a = None
    for t in range(Nf):
        e = bsc._emission(kop, ext[t]).double()
        notfin = torch.ones((Sp, G), dtype=torch.bool)
        if t == 0:
            y = kop.a0.double() * e
            vf = None
        else:
            part = torch.zeros((WT, G), dtype=torch.float64)
            prod = _threads(om * a, J)
            for j in range(J):
                part = part + prod[j]
            dot = _lanes_then_warps(part)
            y = torch.zeros((Sp, G), dtype=torch.float64)
            for o, off in enumerate(kop.offsets):
                y = y + kop.bf[o].double() * bsc._shift_rows(a, off)
            y = y * e
            vf = dot * e[fin, cols]
            notfin[fin, cols] = False
        key = torch.where(notfin, _exp_key(y), 0).amax(dim=0)
        if vf is not None:
            key = torch.maximum(key, _exp_key(vf))
            y[fin, cols] = vf
        k = torch.where(key > 0, key - 1023, 0).double()
        a = y * torch.ldexp(torch.ones(G, dtype=torch.float64), -k)
        alphas[t] = a
        ksum = ksum + k
        shift = shift + mshift[t, 0].double()
    return alphas, a[fin, cols], shift, ksum


def emulate_k5b_wide(kop, ext, alphas):
    """K5b's wide (and global) posteriors in float64, in the kernels'
    order: each frame's gamma sum by thread, lane and warp, and each plan
    pdf's gamma summed over the plan's states, in order from the first
    where the pdf has up to 32 states, else by a warp (lane l over the
    states l, l + 32, ... in order from 0, then the butterfly), times the
    reciprocal of the gamma sum (divided by it where it is subnormal, left
    as it is where it is 0)."""
    Nf, P1, G = ext.shape
    Sp, J = kop.Sp, -(-kop.Sp // WT)
    n, pdf, seg, state = (x.long() for x in bsc.plan_fields(kop.plan, Sp))
    length = seg[:, 1:] - seg[:, :-1]
    longest = int(length.max())
    lg, le = (length > bsc._LONG).nonzero(as_tuple=True)  # warp-summed
    kmax = -(-longest // 32)
    entry = torch.arange(Sp)[None, :] < n[:, None]
    posts = torch.zeros((Nf, P1, G), dtype=torch.float64)
    for t, gam in bsc.gammas_plain(kop, ext, alphas):
        part = torch.zeros((WT, G), dtype=torch.float64)
        th = _threads(gam, J)
        for j in range(J):
            part = part + th[j]
        tot = _lanes_then_warps(part)
        rt = torch.where(tot > 0, 1.0 / tot, torch.ones_like(tot))
        small = (tot > 0) & (tot < 2.0 ** -1022)
        ordered = gam.T.gather(1, state)
        first = ordered.gather(1, seg[:, :-1].clamp(max=Sp - 1))
        acc = first
        for k in range(1, min(longest, bsc._LONG)):
            idx = seg[:, :-1] + k
            ok = idx < seg[:, 1:]
            acc = acc + torch.where(
                ok, ordered.gather(1, idx.clamp(max=Sp - 1)),
                torch.zeros_like(acc))
        if lg.numel():  # lane l: states l, l + 32, ... of the pdf, from 0
            lanes = torch.zeros((len(lg), 32), dtype=torch.float64)
            for k in range(kmax):
                pos = seg[lg, le][:, None] + 32 * k + torch.arange(32)
                ok = pos < seg[lg, le + 1][:, None]
                lanes = lanes + torch.where(
                    ok, ordered[lg[:, None], pos.clamp(max=Sp - 1)], 0.0)
            acc[lg, le] = _butterfly(lanes[..., None])[:, 0]
        acc = torch.where(small[:, None], acc / tot[:, None],
                          acc * rt[:, None])
        vals = torch.where(entry, acc, torch.zeros_like(acc))
        posts[t].T.scatter_add_(1, torch.where(entry, pdf, 0), vals)
    return posts


@pytest.fixture(scope="module", params=[(1200, 150, 100, 40),
                                        (2500, 150, 100, 40)])
def emulated(request):
    """A float64 stack (Sp = 1,208: the wide instantiation; 2,504: the
    global one) at N = 90 with ragged lengths and cliffs, its twin's
    sweep and K5b twin in float64, and the emulations.  The long lattice
    cannot reach its end in 90 frames (its column falls to 0 past its
    length); the others can."""
    cf = _stack(request.param, seed=7)
    kop = bsc.kernel_operator(cf)
    rng = np.random.default_rng(9)
    N = 90
    lhs = (rng.normal(size=(4, N, P)) * 0.5)
    lhs[:, 0:2, ::3] += 30.0
    lhs[:, N // 2, 1::3] -= 30.0
    lens = np.array([N, 77, 60, 85], dtype=np.int32)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P, torch.float64)
    twin = bsc.fwd_sweep_plain(kop, ext, msh)
    return (kop, ext, twin, emulate_k5a_wide(kop, ext, msh),
            bsc.backward_plain(kop, ext, twin[0], dtype=torch.float64),
            emulate_k5b_wide(kop, ext, twin[0]))


def test_emulated_stacks_take_the_wide_and_global_instantiations(emulated):
    kop = emulated[0]
    want = (("wide", "wide") if kop.Sp <= WT * bsc._WIDE_J[-1]
            else ("global", "global"))
    assert bsc._modes(kop.Sp, len(kop.offsets), 2) == want
    assert kop.offsets == (0, 1, 2)


def test_emulated_k5a_wide_matches_fwd_sweep_plain(emulated):
    """The fixed-order omega dot and the CTA key max give the twin's
    alphas and logZ pieces within 1e-12, and its exponents exactly."""
    _, _, (ap, vp, sp, kp), (ae, ve, se, ke), _, _ = emulated
    assert torch.equal(ke, kp)
    assert torch.equal(se, sp)
    assert float((ae - ap).abs().max()) <= 1e-12
    assert float(((ve - vp).abs() / vp.abs().clamp_min(1e-300)).max()) \
        <= 1e-12
    peak = ap.amax(dim=1)
    assert torch.isfinite(ap).all() and ((peak >= 1) | (peak == 0)).all()
    assert torch.isfinite(vp[1:]).all() and (vp[1:] > 0).all()


def test_emulated_k5b_wide_matches_backward_plain(emulated):
    """The fixed-order gamma sum and the plan's order move the float64
    posteriors by a few ulps of 1: within 1e-12 of the twin's."""
    *_, ref, emu = emulated
    assert float((emu - ref).abs().max()) <= 1e-12
    assert (ref.sum(dim=1) > 0).any()


@pytest.fixture(scope="module")
def long_stack():
    """(JAX graphs, the port's float32 stack, lhs, lens) of a ~2,500-state
    skip-arc lattice (Sp = 2,504) beside a short one: N = 2,000 frames.  A
    path crosses at most two states a frame, but with fewer frames the
    skips' share makes the final state's mass fall past float64's range
    against the frame's max (the oracle's logZ is -inf at 1,460 frames)."""
    lengths, N = (2500, 150), 2000
    gj = skip_numerators(P, lengths, 11, mm)
    ct = mt.stack([compile_port(f, sp, P, strategy="banded")
                   for f, sp in skip_numerators(P, lengths, 11, mt)])
    rng = np.random.default_rng(12)
    lhs = rng.normal(size=(len(lengths), N, P)).astype(np.float32)
    return gj, ct, lhs, np.array([N, 900], dtype=np.int32)


def test_long_stack_takes_the_global_instantiation(long_stack):
    _, ct, _, _ = long_stack
    assert ct.padded_states == 2504 and ct.banded_offsets == (0, 1, 2)
    assert bsc._modes(2504, 3) == ("global", "global")
    assert bsc.banded_scan_reject_reason(ct, 2, n_frames=2000) is None


def test_long_stack_twin_matches_jax_f64_and_the_oracle(long_stack):
    """The port's plain stacked scan (the kernels' twin) on the ~2,500-
    state stack against the JAX package's ``_fb_prob_banded_stacked`` in
    float64 (its XLA scan: the fused kernel takes float32 only) and the
    float64 host oracle: logZ, and the posteriors, JAX's as the gradient
    of its logZ."""
    gj, ct, lhs, lens = long_stack
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    pt, zt = pt.numpy(), zt.numpy()
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
            mp.delenv(k, raising=False)
        mp.setenv("MMTPU_NO_PALLAS", "1")
        cj = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded")
                        for f, sp in gj])
        with jax.enable_x64():
            c64 = jax.tree.map(
                lambda x: x.astype(jnp.float64)
                if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
                cj)
            x64 = jnp.asarray(lhs, dtype=jnp.float64)
            jl = jnp.asarray(lens)

            def logz(x):
                return inf._fb_prob_banded_stacked(c64, x, jl, 64,
                                                   False)[1]

            z64, vjp = jax.vjp(logz, x64)
            g64 = np.asarray(vjp(jnp.ones_like(z64))[0])
            z64 = np.asarray(z64)
    assert np.isfinite(z64).all() and np.isfinite(zt).all()
    np.testing.assert_allclose(zt, z64, atol=TOL, rtol=0)
    np.testing.assert_allclose(pt, g64, atol=TOL, rtol=0)
    # both scans read the compiled graph's float32 arc weights (0.3 and 0.2
    # rounded), the oracle the FSM's: over 2,000 frames logZ moves by a few
    # 1e-5, so JAX's float64 scan meets the oracle at the contract's 1e-4
    for g, (f, sp) in enumerate(gj):
        rz, rp = bench.host_oracle(f, sp, P, lhs[g:g + 1].astype(np.float64),
                                   lens[g:g + 1])
        assert abs(zt[g] - rz[0]) <= TOL and abs(z64[g] - rz[0]) <= TOL
        np.testing.assert_allclose(pt[g], rp[0], atol=TOL, rtol=0)
        np.testing.assert_allclose(g64[g], rp[0], atol=TOL, rtol=0)
