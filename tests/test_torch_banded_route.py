"""The route of stacked numerators past the narrow K5's 1,024 states: on a
CUDA device the stacked-banded scan takes them with its wide instantiation
(the state in shared memory), and raises, as for every other graph it
refuses, past a CTA's shared memory or on a predicate it shares with the
JAX package; on the CPU the plain stacked scan runs.

Inputs: numerator lattices of ~1,200 states with skip arcs (three band
offsets: a path crosses up to two states per frame, so N=700 frames reach
the end) and the LF-MMI step's 78-state chains, made from numpy seeds.  The
route is decided on a ``cuda`` device without a card (the admission reads
the graph only).  The plain stacked scan, the kernels' twin, runs here on
the CPU against the exact float64 host oracle (``bench.host_oracle``) and
the JAX package's stacked scan on the same inputs: the JAX float32 scan
loses these lattices (logZ -inf, every posterior 0), so it runs with its
operator and inputs in float64, and its posteriors are the gradient of its
logZ.  On the card, ``chip_smoke.py`` (phase 8b) runs K5's wide
instantiation end to end against the oracle and the twins."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import banded_scan as bsc
from _torch_port import compile_port, numerator

P = 48
G, N = 4, 700
LENGTHS = [1200, 1180, 1150, 1199]
LENS = [700, 690, 640, 700]
TOL = 1e-4  # logZ and posteriors against the f64 oracle (the contract)
K5_LINE = ("cuda-banded-scan (hand-written CUDA kernels K5a/K5b, one CTA "
           "per graph)")


def _lattices(lib):
    rng = np.random.default_rng(31)
    return [numerator(rng.integers(0, P, size=L), P, skip=True, lib=lib)
            for L in LENGTHS]


@pytest.fixture(scope="module")
def big():
    """(JAX graphs, the port's stack, lhs, lens): the ~1,200-state
    lattices, Sp > 1,024."""
    gj = _lattices(mm)
    ct = mt.stack([compile_port(f, sp, P, strategy="banded")
                   for f, sp in _lattices(mt)])
    rng = np.random.default_rng(32)
    lhs = rng.normal(size=(G, N, P)).astype(np.float32)
    return gj, ct, lhs, np.array(LENS, dtype=np.int32)


@pytest.fixture(scope="module")
def small():
    """Four of the LF-MMI step's 78-state chains (Sp = 80)."""
    rng = np.random.default_rng(33)
    return mt.stack([compile_port(*numerator(rng.integers(0, P, size=78), P,
                                            lib=mt), P, strategy="banded")
                     for _ in range(G)])


def _sized(cf, S):
    return dataclasses.replace(cf, alpha_hat=cf.alpha_hat.new_zeros((G, S)))


def test_big_stack_has_three_offsets_and_more_than_1024_states(big):
    _, ct, _, _ = big
    assert ct.banded_offsets == (0, 1, 2)
    assert ct.padded_states > bsc._NARROW_STATES
    assert bsc._wide(ct.padded_states, 3) == (True, True)
    assert bsc.banded_scan_reject_reason(ct, G, n_frames=N) is None


def test_big_stack_routes_to_k5_on_cuda(big):
    _, ct, _, _ = big
    assert tinf._kernel_route(ct, "cpu", G, N) is False
    assert tinf._kernel_route(ct, "cuda", G, N) is True
    assert tinf._kernel_route(ct, "cuda:0", G) is True


def test_report_names_the_route_and_the_instantiations(big, small):
    _, ct, _, _ = big
    Sp = ct.padded_states
    assert tinf.fast_path_report(ct, G, device="cuda:0") == (
        f"{K5_LINE}; K5a wide, K5b wide (Sp = {Sp}, 3 offsets)")
    assert tinf.fast_path_report(small, G, device="cuda") == (
        f"{K5_LINE}; K5a narrow, K5b narrow (Sp = 80, 2 offsets)")
    # past K5b's narrow shared memory (~816 states at two offsets) only
    assert tinf.fast_path_report(_sized(small, 900), G, device="cuda") == (
        f"{K5_LINE}; K5a narrow, K5b wide (Sp = 900, 2 offsets)")
    assert tinf.fast_path_report(ct, G, device="cpu").startswith(
        "plain torch scan (stacked 'banded' graphs")


@pytest.mark.parametrize("S", [1032, 1544, 1936])
def test_wide_instantiation_takes_past_1024_states(small, S):
    """Up to a CTA's shared memory: 1,936 states at two offsets."""
    cf = _sized(small, S)
    assert bsc._wide(S, 2) == (True, True)
    assert tinf._kernel_route(cf, "cuda", G, N) is True


def test_main_path_numerators_take_the_narrow_k5(small):
    assert small.padded_states == 80
    assert bsc._wide(80, 2) == (False, False)
    assert tinf._kernel_route(small, "cuda", G, N) is True


@pytest.mark.parametrize("variant", ["unstacked", "domain", "multi-pdf",
                                     "dtype", "batch", "offsets",
                                     "shared memory"])
def test_refused_stacks_raise_on_cuda(big, variant):
    """No stack runs the plain scan on the card: the predicates shared with
    the JAX package, and a CTA's shared memory (past 1,936 states at two
    offsets, 1,808 at three), raise with their reason."""
    _, ct, _, _ = big
    rep = dataclasses.replace
    cf, B, match = {
        "unstacked": (compile_port(*numerator(np.arange(5), P, lib=mt), P,
                                   strategy="banded"), 1,
                      "not a stacked 'banded'"),
        "domain": (rep(ct, domain="log"), G, "domain"),
        "multi-pdf": (rep(ct, multi_pdf=True), G, "multi-pdf"),
        "dtype": (rep(ct, alpha_hat=ct.alpha_hat.double()), G,
                  "operator dtype"),
        "batch": (ct, G - 1, "batch 3 != graph count 4"),
        "offsets": (rep(ct, banded_offsets=tuple(range(9))), G,
                    "9 band offsets"),
        "shared memory": (_sized(ct, 1816), G,
                          "shared-memory working set 232544 B for Sp = "
                          "1816, 3 offsets"),
    }[variant]
    with pytest.raises(ValueError, match=match):
        tinf._kernel_route(cf, "cuda", B, N)
    assert tinf.fast_path_report(cf, B, device="cuda").startswith("error - ")


@pytest.fixture(scope="module")
def big_results(big):
    """The port's plain stacked scan, the JAX package's stacked scan in
    float32 and in float64 (logZ, and posteriors as the gradient of logZ),
    and the f64 oracle on the ~1,200-state stack at N=700."""
    gj, ct, lhs, lens = big
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
            mp.delenv(k, raising=False)
        mp.setenv("MMTPU_NO_PALLAS", "1")
        cj = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded")
                        for f, sp in gj])
        jl = jnp.asarray(lens)
        pj, zj = inf.pdfposteriors(cj, jnp.asarray(lhs), jl)
        with jax.enable_x64():
            c64 = jax.tree.map(
                lambda x: x.astype(jnp.float64)
                if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
                cj)
            x64 = jnp.asarray(lhs, dtype=jnp.float64)
            z64 = np.asarray(inf.forward(c64, x64, jl))
            g64 = np.asarray(jax.grad(
                lambda x: inf.forward(c64, x, jl).sum())(x64))
    refs = [bench.host_oracle(f, sp, P, lhs[g:g + 1].astype(np.float64),
                              lens[g:g + 1])
            for g, (f, sp) in enumerate(gj)]
    return ((pt.numpy(), zt.numpy()), (np.asarray(pj), np.asarray(zj)),
            (g64, z64), refs)


def test_plain_stacked_scan_matches_the_f64_oracle(big, big_results):
    _, _, _, lens = big
    (pt, zt), _, _, refs = big_results
    for g, (rz, rp) in enumerate(refs):
        assert np.isfinite(rz[0]) and np.isfinite(zt[g])
        assert abs(zt[g] - rz[0]) <= TOL
        np.testing.assert_allclose(pt[g], rp[0], atol=TOL, rtol=0)
        np.testing.assert_allclose(pt[g, :lens[g]].sum(axis=1), 1.0,
                                   atol=1e-5)
        assert (pt[g, lens[g]:] == 0).all()


def test_plain_stacked_scan_matches_jax_in_float64(big_results):
    """The JAX package's stacked-banded scan with its operator and inputs in
    float64: logZ, and the posteriors as the gradient of logZ."""
    (pt, zt), _, (g64, z64), refs = big_results
    assert np.isfinite(z64).all()
    np.testing.assert_allclose(zt, z64, atol=TOL, rtol=0)
    np.testing.assert_allclose(pt, g64, atol=TOL, rtol=0)
    for g, (rz, rp) in enumerate(refs):  # float64 on both sides
        assert abs(z64[g] - rz[0]) <= 1e-7
        np.testing.assert_allclose(g64[g], rp[0], atol=1e-7, rtol=0)


def test_jax_float32_stacked_scan_loses_this_input(big_results):
    """The JAX package's float32 stacked-banded scan returns logZ -inf and
    all-zero posteriors on these lattices: alpha at the final state falls
    below float32's range relative to the frame's max, and gamma's pdf sums
    run in float32.  A constant added to every frame's log-likelihoods
    does not help, since the scan subtracts each frame's max first.  The
    port's float64 state is the repair."""
    (pt, zt), (pj, zj), _, refs = big_results
    assert np.isneginf(zj).all() and (pj == 0).all()
    assert np.isfinite(zt).all()
    assert all(np.isfinite(rz[0]) for rz, _ in refs)


def test_loss_and_gradient_take_the_same_route(big, small):
    """``logmarginal`` and ``lfmmi_loss`` on the stack: the gradient in the
    log-likelihoods is the posteriors."""
    _, ct, lhs, lens = big
    x = torch.from_numpy(lhs).requires_grad_()
    tl = torch.from_numpy(lens)
    z = mt.logmarginal(ct, x, tl)
    z.sum().backward()
    posts, z2 = mt.pdfposteriors(ct, torch.from_numpy(lhs), tl)
    assert torch.equal(z.detach(), z2)
    assert torch.equal(x.grad, posts)
    x.grad = None
    loss = mt.lfmmi_loss(ct, small, x, tl)
    loss.sum().backward()
    den, _ = mt.pdfposteriors(small, torch.from_numpy(lhs), tl)
    np.testing.assert_allclose(x.grad.numpy(), (den - posts).numpy(),
                               atol=1e-6, rtol=0)
