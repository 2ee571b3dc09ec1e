"""The port's 'banded' strategy, ``stack`` and the stacked-banded scan
(ops/banded_scan.py) against the JAX package: compile and stack arrays
bit for bit, the K5a/K5b plain twins against the fused Pallas kernels
(``pallas_banded.banded_fused_fb``, interpret mode), the plain stacked scan
against the JAX XLA stacked path and the exact float64 host oracle, and the
admission and dispatch rules.

Inputs are numerator lattices (self-loop and chain arcs, some with skip
arcs) over random pdf sequences, made from numpy seeds.  The CUDA kernels
themselves are held against these twins on the card by ``chip_smoke.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu.ops import pallas_banded as pband
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import banded_scan as bsc
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import (assert_same_compiled, compile_port, jax_compiled,
                         numerator, numerators, port_from_jax)

P = 24


def _compile(graphs, package, p=P):
    """Compile each graph 'banded' with ``inf`` (the JAX package) or ``mt``
    (the port, on the CPU); each package takes graphs of its own host
    layer."""
    compile_fsm = compile_port if package is mt else package.compile_fsm
    return [compile_fsm(f, sp, p, strategy="banded") for f, sp in graphs]


def _both(seed, make):
    """``make(rng, lib)`` run for each package's host layer from the same
    seed: (JAX package's graphs, port's graphs, what follows in the rng)."""
    rng = np.random.default_rng(seed)
    graphs = make(rng, mm)
    return graphs, make(np.random.default_rng(seed), mt), rng


@pytest.fixture(scope="module")
def mixed():
    """Five lattices of different lengths; graph 2 has skip arcs, so the
    stacked offsets are (0, 1, 2) with zero bands for the other graphs."""
    gj, gt, _ = _both(21, lambda rng, lib: numerators(
        rng, 5, P, [6, 9, 4, 7, 5], skip=(2,), lib=lib))
    return gj, _compile(gj, inf), _compile(gt, mt)


def _no_pallas(mp, interpret=False):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
        mp.delenv(k, raising=False)
    mp.setenv("MMTPU_PALLAS_INTERPRET" if interpret else "MMTPU_NO_PALLAS",
              "1")


def _assert_logz(z, ref, atol):
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref[fin], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# compile, stack, compiled_from_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", range(5))
def test_compile_banded_matches_jax(mixed, g):
    _, cjs, cts = mixed
    assert cts[g].padded_states % 8 == 0 and cts[g].strategy == "banded"
    assert_same_compiled(cjs[g], cts[g])


def test_stack_matches_jax(mixed):
    _, cjs, cts = mixed
    sj, st = inf.stack(cjs), mt.stack(cts)
    assert st.banded_offsets == (0, 1, 2) and st.batched
    assert_same_compiled(sj, st)
    # graphs without skip arcs get a zero band at offset 2
    assert not st.banded_fwd[[0, 1, 3, 4], 2].any()
    assert st.banded_fwd[2, 2].any()
    assert mt.batch is mt.stack
    moved = st.to("meta")  # the per-graph final states move too
    assert moved.final_state.device.type == "meta"
    assert moved.banded_fwd.device.type == "meta" and moved.block_fwd is None


def test_compiled_from_numpy_stacked_gives_the_same_outputs(mixed):
    graphs, cjs, cts = mixed
    ct = port_from_jax(inf.stack(cjs))
    assert_same_compiled(inf.stack(cjs), ct)
    assert_same_compiled(inf.stack(cjs), ct.to("cpu"))
    rng = np.random.default_rng(4)
    lhs = torch.from_numpy(rng.normal(size=(5, 12, P)).astype(np.float32))
    lens = torch.tensor([12, 10, 12, 9, 3], dtype=torch.int32)
    pa, za = mt.pdfposteriors(ct, lhs, lens)
    pb, zb = mt.pdfposteriors(mt.stack(cts), lhs, lens)
    assert torch.equal(pa, pb) and torch.equal(za, zb)


def test_compile_rejects_more_than_eight_offsets():
    """Arcs 0 -> d for d = 1..10: ten offsets, not a banded lattice."""
    arcs = [((0, d), np.log(0.1)) for d in range(1, 11)]
    spdf = np.append(np.arange(11) % P, P).astype(np.int32)
    for lib, package in ((mt, mt), (mm, inf)):
        f = lib.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(10, 0.0)],
            [lib.labels.Label(i % P) for i in range(11)], lib.semiring.LOG)
        with pytest.raises(ValueError, match="10 distinct arc offsets"):
            _compile([(f, spdf)], package)


# ---------------------------------------------------------------------------
# the K5 twins against the fused Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked128():
    """The JAX fused kernel's target shape: G = 128 lattices of 4-8 states,
    N = 10, ragged lengths 3-10 (some shorter than their lattice: -inf).
    The inputs of tests/test_inference.py's fused banded test."""
    gj, gt, rng = _both(3, lambda rng, lib: numerators(
        rng, 128, P, [4 + g % 5 for g in range(128)], lib=lib))
    lhs = rng.normal(size=(128, 10, P)).astype(np.float32)
    lens = np.clip(3 + rng.integers(0, 8, size=128), 0, 10).astype(np.int32)
    return (inf.stack(_compile(gj, inf)), mt.stack(_compile(gt, mt)),
            lhs, lens)


@pytest.fixture(scope="module")
def fused_pair(stacked128):
    cj, ct, lhs, lens = stacked128
    with pytest.MonkeyPatch.context() as mp:
        _no_pallas(mp, interpret=True)
        assert pband.banded_scan_supported(cj, 128) is None
        pj, vj, sj, kj = pband.banded_fused_fb(cj, jnp.asarray(lhs),
                                               jnp.asarray(lens), True)
        zj = np.asarray(inf._combine_shift(
            jnp.where(vj > 0, jnp.log(jnp.maximum(vj, 1e-38)), -jnp.inf),
            kj, sj))
    bsc.reset_launch_counts()
    pt, vt, st, kt = bsc.banded_fused_fb(ct, torch.from_numpy(lhs),
                                         torch.from_numpy(lens), True)
    launches = dict(bsc.LAUNCHES)
    zt = tinf._combine_shift(tinf._log_final(vt), kt, st).numpy()
    return (np.asarray(pj), zj), (pt.numpy(), zt), launches


def test_twins_logz_match_fused_pallas(fused_pair):
    (_, zj), (_, zt), _ = fused_pair
    fin = np.isfinite(zj)
    assert 0 < fin.sum() < len(zj)  # feasible and infeasible graphs
    _assert_logz(zt, zj, 1e-5)


def test_twins_posteriors_match_fused_pallas(fused_pair):
    (pj, zj), (pt, _), _ = fused_pair
    assert pt.shape == pj.shape == (11, P + 1, 128)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    # infeasible graphs: all-zero posteriors, no NaN
    assert np.isfinite(pt).all()
    assert (pt[:, :, ~np.isfinite(zj)] == 0).all()


def test_twins_launch_no_kernel_on_cpu(fused_pair):
    assert fused_pair[2] == {"banded_fwd": 0, "banded_bwd": 0}


def test_forward_twin_without_alphas_gives_the_same_logz(stacked128):
    _, ct, lhs, lens = stacked128
    kop = bsc.kernel_operator(ct)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P)
    a, *rest = bsc.fwd_sweep(kop, ext, msh, save_alphas=True)
    none, *rest2 = bsc.fwd_sweep(kop, ext, msh, save_alphas=False)
    assert none is None and a.shape == (11, kop.Sp, 128)
    assert all(torch.equal(x, y) for x, y in zip(rest, rest2))
    # alphas are rescaled per frame: column max in [1, 2) where feasible
    m = a.amax(dim=1)
    assert ((m == 0) | ((m >= 1) & (m < 2))).all()


def test_kernel_path_matches_plain_stacked_scan(stacked128):
    """banded_fused_fb (the CUDA route's twins) and the CPU dispatch's
    plain stacked scan agree."""
    _, ct, lhs, lens = stacked128
    pt, zt = tinf._fb_banded_cuda(ct, torch.from_numpy(lhs),
                                  torch.from_numpy(lens), True)
    pp, zp = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    _assert_logz(zt.numpy(), zp.numpy(), 1e-5)
    np.testing.assert_allclose(pt.numpy(), pp.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the plain stacked scan against the JAX XLA path and the f64 oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked6():
    """tests/test_inference.py's banded-vs-dense inputs: G = 6 lattices of
    10-15 states, N = 30, one infeasible length (9 < 13)."""
    gj, gt, rng = _both(3, lambda rng, lib: [
        numerator(rng.integers(0, P, size=10 + b), P, lib=lib)
        for b in range(6)])
    lhs = rng.normal(size=(6, 30, P)).astype(np.float32)
    lens = np.array([30, 25, 30, 9, 30, 20], dtype=np.int32)
    return (gj, gt), lhs, lens


@pytest.mark.parametrize("chunk", [None, 4])
def test_stacked_pdfposteriors_match_jax_xla(stacked6, chunk, monkeypatch):
    graphs, lhs, lens = stacked6
    _no_pallas(monkeypatch)
    pj, zj = inf.pdfposteriors(inf.stack(_compile(graphs[0], inf)),
                               jnp.asarray(lhs), jnp.asarray(lens),
                               chunk_size=chunk)
    pt, zt = mt.pdfposteriors(mt.stack(_compile(graphs[1], mt)),
                              torch.from_numpy(lhs), torch.from_numpy(lens),
                              chunk_size=chunk)
    assert not np.isfinite(zt.numpy()[3])
    _assert_logz(zt.numpy(), np.asarray(zj), 1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("path", ["plain", "twins"])
def test_stacked_pdfposteriors_match_f64_oracle(stacked6, path):
    (gj, gt), lhs, lens = stacked6
    ct = mt.stack(_compile(gt, mt))
    args = (ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    pt, zt = (mt.pdfposteriors(*args) if path == "plain"
              else tinf._fb_banded_cuda(*args, True))
    for g, (fsm, spdf) in enumerate(gj):
        rz, rp = bench.host_oracle(fsm, spdf, P,
                                   lhs[g:g + 1].astype(np.float64),
                                   lens[g:g + 1])
        _assert_logz(zt.numpy()[g:g + 1], rz, 1e-4)
        np.testing.assert_allclose(pt.numpy()[g:g + 1], rp, atol=1e-4,
                                   rtol=0)
        assert (pt.numpy()[g, lens[g]:] == 0).all()


def test_single_banded_graph_matches_jax_xla(stacked6, monkeypatch):
    """One unstacked banded graph shared by a batch of 3 sequences."""
    (gj, gt), lhs, _ = stacked6
    lens = np.array([30, 17, 12], dtype=np.int32)
    _no_pallas(monkeypatch)
    pj, zj = inf.pdfposteriors(
        _compile(gj[2:3], inf)[0],
        jnp.asarray(lhs[:3]), jnp.asarray(lens), chunk_size=8)
    pt, zt = mt.pdfposteriors(_compile(gt[2:3], mt)[0],
                              torch.from_numpy(lhs[:3]),
                              torch.from_numpy(lens), chunk_size=8)
    _assert_logz(zt.numpy(), np.asarray(zj), 1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def long_lattices():
    """Two of the LF-MMI step's numerators (78 states, self-loop and chain
    at 0.5) at N = 700: alpha runs ahead of the sequence and beta behind
    it, so at mid-sequence both factors of gamma sit 1e-27 .. 1e-40 below
    their maxima and their product near 1e-54."""
    gj, gt, _ = _both(3, lambda rng, lib: [
        numerator(rng.integers(0, 384, size=78), 384, lib=lib)
        for _ in range(2)])
    lhs = (np.random.default_rng(0).normal(size=(2, 700, 384)) * 0.5
           ).astype(np.float32)
    lens = np.array([700, 650], dtype=np.int32)
    refs = [bench.host_oracle(f, sp, 384, lhs[g:g + 1].astype(np.float64),
                              lens[g:g + 1])
            for g, (f, sp) in enumerate(gj)]
    return (gj, gt), lhs, lens, refs


@pytest.mark.parametrize("path", ["plain", "twins"])
def test_long_lattice_posteriors_match_f64_oracle(long_lattices, path):
    """The repair of a float32 underflow: the port keeps the banded state in
    float64, so every active frame keeps its posterior mass."""
    graphs, lhs, lens, refs = long_lattices
    ct = mt.stack(_compile(graphs[1], mt, 384))
    args = (ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    pt, zt = (mt.pdfposteriors(*args) if path == "plain"
              else tinf._fb_banded_cuda(*args, True))
    for g, (rz, rp) in enumerate(refs):
        _assert_logz(zt.numpy()[g:g + 1], rz, 1e-4)
        np.testing.assert_allclose(pt.numpy()[g], rp[0], atol=1e-4, rtol=0)
        np.testing.assert_allclose(pt.numpy()[g, :lens[g]].sum(axis=1), 1.0,
                                   atol=1e-5)


def test_float32_gamma_loses_long_lattice_posteriors_in_jax(long_lattices,
                                                            monkeypatch):
    """The fault the float64 state repairs, in the JAX package's float32
    stacked-banded scan on the same input: frames whose posteriors sum to
    ~0 instead of 1."""
    graphs, lhs, lens, _ = long_lattices
    _no_pallas(monkeypatch)
    cj = inf.stack(_compile(graphs[0], inf, 384))
    pj, _ = inf.pdfposteriors(cj, jnp.asarray(lhs), jnp.asarray(lens))
    mass = np.asarray(pj)[0].sum(axis=1)
    assert (mass < 0.5).sum() > 100


# ---------------------------------------------------------------------------
# admission and dispatch
# ---------------------------------------------------------------------------

def _variants(cj, ct):
    """(name, jax graph, port graph, batch) for each rejected predicate the
    two packages share, in their order."""
    G = ct.alpha_hat.shape[0]
    rep = dataclasses.replace
    single_j = inf.compile_fsm(*numerator(np.arange(5), P), P,
                               strategy="banded")
    single_t = compile_port(*numerator(np.arange(5), P, lib=mt), P,
                            strategy="banded")
    return [
        ("unstacked", single_j, single_t, 1),
        ("domain", rep(cj, domain="log"), rep(ct, domain="log"), G),
        ("multi-pdf", rep(cj, multi_pdf=True), rep(ct, multi_pdf=True), G),
        ("batch", cj, ct, G - 1),
    ]


def test_reject_reasons_match_jax(mixed, monkeypatch):
    _, cjs, cts = mixed
    cj, ct = inf.stack(cjs), mt.stack(cts)
    _no_pallas(monkeypatch, interpret=True)
    for name, vj, vt, B in _variants(cj, ct):
        want = pband.banded_scan_supported(vj, B)
        assert want is not None, name
        assert bsc.banded_scan_reject_reason(vt, B) == want, name


def test_reject_reasons_name_each_port_predicate(mixed):
    _, _, cts = mixed
    ct = mt.stack(cts)
    G, Sp = 5, ct.padded_states
    rep = dataclasses.replace
    assert bsc.banded_scan_reject_reason(ct, G) is None
    cases = [
        (rep(ct, alpha_hat=ct.alpha_hat.double()), "operator dtype"),
        (rep(ct, banded_offsets=(0, Sp)), "band offset exceeds"),
        (rep(ct, banded_offsets=tuple(range(9))), "9 band offsets"),
    ]
    for cf, match in cases:
        assert match in bsc.banded_scan_reject_reason(cf, G), match
    # past the narrow K5 the wide one takes them, past a CTA's shared
    # memory the global one: no length is refused (the card's memory is
    # checked where a card is present)
    for S in (1000, 1544, 2400, 24576):
        assert bsc.banded_scan_reject_reason(
            rep(ct, alpha_hat=ct.alpha_hat.new_zeros((G, S))), G) is None


def test_dispatch_raises_for_unported_batched_graphs(mixed):
    """A batched 'block' graph (which ``stack`` never builds) and a batch
    that is not one sequence per graph (the JAX package's vmap fails on
    the sizes) raise ValueError."""
    _, _, cts = mixed
    ct = mt.stack(cts)
    lhs = torch.zeros((5, 4, P))
    with pytest.raises(ValueError, match="batched 'block'"):
        mt.pdfposteriors(dataclasses.replace(ct, strategy="block"), lhs)
    with pytest.raises(ValueError, match="one sequence per graph"):
        mt.pdfposteriors(ct, lhs[:4])  # B != G


def test_cuda_route_raises_for_a_single_banded_graph(mixed):
    _, _, cts = mixed
    ct = mt.stack(cts)
    assert tinf._kernel_route(ct, "cpu", 5) is False
    assert tinf._kernel_route(ct, "cuda", 5) is True
    with pytest.raises(ValueError, match="not a stacked 'banded'"):
        tinf._kernel_route(cts[0], "cuda", 3)
    with pytest.raises(ValueError, match="batch 4 != graph count 5"):
        tinf._kernel_route(ct, "cuda", 4)
    assert "plain" in tinf.fast_path_report(cts[0], 3)
    assert "K5a" in tinf.fast_path_report(ct, 5, device="cuda")
    assert "not a stacked" in tinf.fast_path_report(cts[0], 3, device="cuda")


def test_stack_rejects_what_it_does_not_stack(mixed):
    """'block' graphs and stacks do not stack; the same lattices compiled
    'ell' stack as the JAX package stacks them."""
    _, _, cts = mixed
    with pytest.raises(ValueError, match="'block'"):
        mt.stack([port_from_jax(jax_compiled(16))] * 2)
    with pytest.raises(ValueError, match="unbatched"):
        mt.stack([mt.stack(cts)])
    gj, gt, _ = _both(21, lambda rng, lib: numerators(
        rng, 5, P, [6, 9, 4, 7, 5], skip=(2,), lib=lib))
    assert_same_compiled(
        inf.stack([inf.compile_fsm(f, s, P, strategy="ell") for f, s in gj]),
        mt.stack([compile_port(f, s, P, strategy="ell") for f, s in gt]))


def test_wrappers_refuse_other_devices(mixed):
    _, _, cts = mixed
    kop = bsc.kernel_operator(mt.stack(cts))
    ext = torch.empty((4, P + 1, 5), device="meta")
    with pytest.raises(ValueError, match="no banded-scan kernel"):
        bsc.fwd_sweep(kop, ext, ext[:, :1])
    with pytest.raises(ValueError, match="no banded-scan kernel"):
        bsc.backward(kop, ext, ext)
