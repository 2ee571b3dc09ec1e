"""The port's log-space path against the JAX package's, on the CPU: the
semiring operations, the 'segment' and 'ell' strategies and the log domain
(compile and ``stack``, array for array), the log-space scan ``_fb_run``
(full-memory and chunked, float32 and float64, one graph or per graph of a
stack), ``logmarginal``'s gradient, ``expand`` and the full α/β
recursions, and the routes that take this scan on every device.

Inputs are seeded numpy arrays; the HMMs are ``tests/test_inference.py``'s
``make_hmm``, built once by each package's own host layer.  Float32
results are held to the JAX package's within TOL (logZ relative to its
magnitude, posteriors absolute): the two compute the same operations in
the same order but for XLA's and torch's exp and log, which differ in the
last bit.  Float64 results are held to the float64 host oracle."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu.ops import semiring_ops as jsops
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import semiring_ops as sops
from _torch_port import (assert_same_compiled, both, compile_port, hmm_pair,
                         numerators, port_from_jax, port_lm_graph, lm_graph)
from tests.test_inference import oracle_fb

TOL = 1e-5  # float32 port vs JAX: logZ relative (to max(1, |logZ|)), posts
TOL_F64 = 1e-9  # float64 port vs JAX's float64 XLA scan
TOL_ORACLE = 1e-4  # the repo's f64-oracle contract
F64 = torch.float64


def assert_logz(zt, zj, tol):
    zt, zj = np.asarray(zt), np.asarray(zj)
    assert (np.isneginf(zt) == np.isneginf(zj)).all()
    fin = np.isfinite(zj)
    err = np.abs(zt[fin] - zj[fin]) / np.maximum(1.0, np.abs(zj[fin]))
    assert err.max(initial=0) <= tol, err.max()


def run_both(cj, ct, lhs, lens, chunk=None, dtype=torch.float32, **kw):
    """pdfposteriors of both packages on the same numpy inputs."""
    if dtype == F64:
        with jax.enable_x64(True):
            pj, zj = inf.pdfposteriors(cj, jnp.asarray(lhs, jnp.float64),
                                       jnp.asarray(lens), chunk_size=chunk)
            pj, zj = np.asarray(pj), np.asarray(zj)
    else:
        pj, zj = inf.pdfposteriors(cj, jnp.asarray(lhs), jnp.asarray(lens),
                                   chunk_size=chunk)
        pj, zj = np.asarray(pj), np.asarray(zj)
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs).to(dtype),
                              torch.from_numpy(lens), chunk_size=chunk)
    return pj, zj, pt.numpy(), zt.numpy()


# ---------------------------------------------------------------------------
# (a) the semiring operations
# ---------------------------------------------------------------------------

def _edges(rng, S, E, B):
    """A dst-sorted edge list with an empty segment (state 2), an
    all--inf segment (state 4), tied weights, and a state x with ties."""
    dst = np.sort(rng.integers(0, S, size=E))
    dst[dst == 2] = 3
    src = rng.integers(0, S, size=E)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    w = np.round(rng.normal(size=E), 1).astype(np.float32)  # ties
    w[dst == 4] = -np.inf
    x = np.round(rng.normal(size=(S, B)), 1).astype(np.float32)
    x[1] = -np.inf
    return src.astype(np.int32), dst.astype(np.int32), w, x


@pytest.mark.parametrize("op", ["logsumexp", "max"])
def test_segment_matvec_matches_jax(op):
    rng = np.random.default_rng(0)
    S, B = 9, 4
    src, dst, w, x = _edges(rng, S, 40, B)
    want = jsops.segment_matvec(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w), jnp.asarray(x), S, op=op)
    got = sops.segment_matvec(*(torch.from_numpy(a) for a in (src, dst, w,
                                                              x)), S, op=op)
    if op == "max":
        (yj, bj), (yt, bt) = want, got
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        assert bt[2].eq(torch.iinfo(torch.int32).min).all()  # empty
        assert (bt[4] == src[dst == 4].max()).all()  # all -inf: largest
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert torch.isneginf(got[2]).all() and torch.isneginf(got[4]).all()


@pytest.mark.parametrize("op", ["logsumexp", "max"])
def test_ell_matvec_matches_jax(op):
    rng = np.random.default_rng(1)
    S, D, B = 7, 4, 3
    es = rng.integers(0, S, size=(S, D)).astype(np.int32)
    ew = np.round(rng.normal(size=(S, D)), 1).astype(np.float32)
    ew[2] = -np.inf  # an all-pad row
    es[2] = 0
    ew[3, 2:] = -np.inf
    x = np.round(rng.normal(size=(S, B)), 1).astype(np.float32)
    want = jsops.ell_matvec(jnp.asarray(es), jnp.asarray(ew), jnp.asarray(x),
                            op=op)
    got = sops.ell_matvec(torch.from_numpy(es), torch.from_numpy(ew),
                          torch.from_numpy(x), op=op)
    if op == "max":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert torch.isneginf(got[2]).all()


def test_segment_and_masked_logsumexp_match_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(12, 3)).astype(np.float32)
    data[5:7] = -np.inf
    ids = np.array([3, 0, 3, 1, 0, 4, 4, 1, 0, 3, 1, 0], dtype=np.int32)
    want = jsops.segment_logsumexp(jnp.asarray(data), jnp.asarray(ids), 6)
    got = sops.segment_logsumexp(torch.from_numpy(data),
                                 torch.from_numpy(ids), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.isneginf(got[4]).all() and torch.isneginf(got[5]).all()
    x = rng.normal(size=(4, 5)).astype(np.float32)
    x[:, 1] = -np.inf
    for dim in (0, 1):
        want = jsops.masked_logsumexp(jnp.asarray(x), dim)
        got = sops.masked_logsumexp(torch.from_numpy(x), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("precision", ["high", "f32", "bf16"])
def test_dense_log_matvec(precision):
    """'high' and 'f32' equal the JAX package's product (float32 on the
    CPU); 'bf16' equals an explicit product of bf16-rounded operands (the
    JAX package's DEFAULT precision rounds only on a TPU)."""
    rng = np.random.default_rng(3)
    W = rng.normal(size=(6, 6)).astype(np.float32)
    W[rng.random((6, 6)) < 0.4] = -np.inf
    W[2] = -np.inf  # an empty row
    x = rng.normal(size=(6, 3)).astype(np.float32)
    x[:, 1] = -np.inf
    ej, mj = jsops.make_dense_operator(jnp.asarray(W))
    et, mt_ = sops.make_dense_operator(torch.from_numpy(W))
    np.testing.assert_array_equal(mt_.numpy(), np.asarray(mj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=2e-7)
    got = sops.dense_log_matvec(et, mt_, torch.from_numpy(x), precision)
    assert torch.isneginf(got[2]).all() and torch.isneginf(got[:, 1]).all()
    if precision == "bf16":
        cm = np.max(x, axis=0)
        cm = np.where(np.isfinite(cm), cm, 0.0)
        ex = torch.from_numpy(np.exp(x - cm)).bfloat16().float()
        p = (et.bfloat16().float() @ ex).numpy()
        with np.errstate(divide="ignore"):
            want = np.log(p) + mt_.numpy()[:, None] + cm[None, :]
        want[p <= 0] = -np.inf
    else:
        want = np.asarray(jsops.dense_log_matvec(ej, mj, jnp.asarray(x),
                                                 precision))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) the compiles and stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,domain,dtype", [
    ("segment", "prob", torch.float32),
    ("ell", "prob", torch.float32),
    ("segment", "log", torch.float32),
    ("ell", "log", F64),
    ("dense", "log", torch.float32),
    ("block", "log", torch.float32),
    ("banded", "log", F64),
])
def test_compile_matches_jax(strategy, domain, dtype):
    """Every array equal to the JAX compile's: the lm_graph(8) LM ∘ HMM
    graph, and for 'banded' a numerator lattice."""
    if strategy == "banded":
        (fj, spdf), = numerators(np.random.default_rng(4), 1, 12, [7])
        (ft, _), = numerators(np.random.default_rng(4), 1, 12, [7], lib=mt)
        P = 12
    else:
        fj, spdf, P, _ = lm_graph(8)
        ft = port_lm_graph(8)[0]
    cj, ct = both(fj, ft, spdf, P, dtype, strategy=strategy, domain=domain)
    assert ct.domain == domain and ct.strategy == strategy
    if strategy in ("ell", "segment"):
        assert ct.padded_states % 8 == 0 and ct.omega_prob is None
    assert_same_compiled(cj, ct)
    assert_same_compiled(cj, port_from_jax(cj))


@pytest.mark.parametrize("strategy,domain", [
    ("segment", "prob"), ("ell", "prob"), ("banded", "log"), ("dense", "log"),
])
def test_stack_matches_jax(strategy, domain):
    """Numerator lattices of 3-9 states (one with skip arcs, so the 'ell'
    in-degrees differ) stacked by both packages."""
    lens = [5, 9, 3, 7]
    gj = numerators(np.random.default_rng(5), 4, 10, lens, skip=(1,))
    gt = numerators(np.random.default_rng(5), 4, 10, lens, skip=(1,),
                    lib=mt)
    cj = inf.stack([inf.compile_fsm(f, s, 10, strategy=strategy,
                                    domain=domain) for f, s in gj])
    ct = mt.stack([compile_port(f, s, 10, strategy=strategy, domain=domain)
                   for f, s in gt])
    assert_same_compiled(cj, ct)


def test_the_jax_refusals_stay():
    """A general Ĉ keeps the JAX package's rules; unknown names raise."""
    fsm, spdf, P, _ = port_lm_graph(8)
    C = mt.hostsparse.spmat_from_coo(
        np.r_[np.arange(len(spdf)), 0], np.r_[spdf, (spdf[0] + 1) % P],
        np.zeros(len(spdf) + 1), (len(spdf), P + 1), mt.LOG)
    with pytest.raises(ValueError, match="general Ĉ requires domain='prob'"):
        compile_port(fsm, C, P, strategy="dense", domain="log")
    with pytest.raises(ValueError, match="'dense' or 'block'"):
        compile_port(fsm, C, P, strategy="segment")
    with pytest.raises(ValueError, match="unknown strategy"):
        compile_port(fsm, spdf, P, strategy="csr")
    with pytest.raises(ValueError, match="unknown domain"):
        compile_port(fsm, spdf, P, domain="tropical")


# ---------------------------------------------------------------------------
# (c) the log-space scan against the JAX package's _fb_run
# ---------------------------------------------------------------------------

SCAN_CASES = [  # (strategy, domain, lr, chunk)
    ("segment", "prob", True, None),
    ("segment", "log", False, 4),
    ("ell", "prob", False, None),
    ("ell", "log", True, 7),
    ("dense", "log", False, None),
    ("dense", "log", True, 5),
    ("block", "log", False, None),
    ("banded", "log", True, 6),
]


@pytest.mark.parametrize("strategy,domain,lr,chunk", SCAN_CASES)
def test_scan_matches_jax(strategy, domain, lr, chunk):
    """B=5 at N=20 with lengths 1 (infeasible for most HMMs) .. N; chunk
    None is the full-memory mode, a small chunk the checkpointed one."""
    P, N = 3, 20
    fj, ft, spdf, _ = hmm_pair(10 + len(strategy), 6, P, lr=lr,
                               to_final=not lr)
    cj, ct = both(fj, ft, spdf, P, strategy=strategy, domain=domain)
    lhs = np.random.default_rng(11).normal(size=(5, N, P)).astype(np.float32)
    lens = np.array([N, 1, 13, 7, N], dtype=np.int32)
    pj, zj, pt, zt = run_both(cj, ct, lhs, lens, chunk)
    assert_logz(zt, zj, TOL)
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    for b, L in enumerate(lens):
        assert (pt[b, L:] == 0).all()
    zf = mt.forward(ct, torch.from_numpy(lhs), torch.from_numpy(lens),
                    chunk_size=chunk)
    np.testing.assert_array_equal(zf.numpy(), zt)


@pytest.mark.parametrize("strategy,domain", [
    ("segment", "prob"), ("ell", "log"), ("dense", "log"), ("block", "log"),
    ("banded", "log")])
def test_float64_scan_matches_jax_and_the_oracle(strategy, domain):
    P, N = 3, 30
    # a 'banded' graph must keep its arcs on <= 8 offsets: left-to-right
    fj, ft, spdf, (alpha, T, omega) = hmm_pair(
        21, 7, P, lr=strategy == "banded", to_final=True)
    cj, ct = both(fj, ft, spdf, P, F64, strategy=strategy, domain=domain)
    rng = np.random.default_rng(22)
    lhs = rng.normal(size=(3, N, P))
    lens = np.array([N, 11, 2], dtype=np.int32)
    pj, zj, pt, zt = run_both(cj, ct, lhs, lens, 8, dtype=F64)
    assert pt.dtype == zt.dtype == np.float64
    # the JAX 'dense' log matvec rounds its products to float32, and its
    # one-hot pdf reduction its posteriors (preferred_element_type)
    tol = 1e-5 if strategy == "dense" else TOL_F64
    assert_logz(zt, zj, tol)
    np.testing.assert_allclose(pt, pj, atol=max(tol, 1e-6), rtol=0)
    for b, L in enumerate(lens):
        rp, rz = oracle_fb(alpha, T, omega, spdf, lhs[b, :L])
        assert abs(zt[b] - rz) <= 1e-8 * max(1.0, abs(rz))
        np.testing.assert_allclose(pt[b, :L], rp, atol=1e-8, rtol=0)


def test_float64_segment_graph_against_the_host_oracle():
    """lm_graph(8) compiled 'segment' in float64 against the port's f64
    host oracle at the 1e-4 contract, N=40."""
    fsm, spdf, P, _ = port_lm_graph(8)
    ct = compile_port(fsm, spdf, P, strategy="segment", dtype=F64)
    rng = np.random.default_rng(23)
    lhs = rng.normal(size=(2, 40, P))
    lens = np.array([40, 26], dtype=np.int32)
    rz, rp = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    assert np.abs(zt.numpy() - rz).max() <= TOL_ORACLE
    assert np.abs(pt.numpy() - rp).max() <= TOL_ORACLE


@pytest.mark.parametrize("strategy,domain", [
    ("segment", "prob"), ("ell", "prob"), ("banded", "log"),
    ("dense", "log")])
def test_stacked_per_graph_route_matches_jax(strategy, domain):
    """One sequence per graph (B = G = 4) through the per-graph route,
    against the JAX package's vmap over the graphs, chunked and not."""
    P, N = 10, 16
    lens_g = [5, 9, 3, 7]
    gj = numerators(np.random.default_rng(5), 4, P, lens_g, skip=(1,))
    gt = numerators(np.random.default_rng(5), 4, P, lens_g, skip=(1,),
                    lib=mt)
    cj = inf.stack([inf.compile_fsm(f, s, P, strategy=strategy,
                                    domain=domain) for f, s in gj])
    ct = mt.stack([compile_port(f, s, P, strategy=strategy, domain=domain)
                   for f, s in gt])
    lhs = np.random.default_rng(24).normal(size=(4, N, P)).astype(np.float32)
    lens = np.array([N, 2, 11, N], dtype=np.int32)  # graph 1 infeasible
    for chunk in (None, 5):
        pj, zj, pt, zt = run_both(cj, ct, lhs, lens, chunk)
        assert_logz(zt, zj, TOL)
        np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert np.isneginf(zt[1]) and (pt[1] == 0).all()
    with pytest.raises(ValueError, match="one sequence per graph"):
        mt.pdfposteriors(ct, torch.from_numpy(lhs[:3]))


def test_logmarginal_gradient_is_the_posteriors():
    """On a 'segment' graph and a stack of log-domain numerators: the
    gradient of sum(logZ) equals the posteriors (the step's gradient
    identity), and lfmmi_loss's equals γ_den - γ_num, against the JAX
    package's value and gradient."""
    P, N, B = 4, 12, 3
    fj, ft, spdf, _ = hmm_pair(30, 8, P, lr=False, to_final=True)
    dj, dt = both(fj, ft, spdf, P, strategy="segment")
    gj = numerators(np.random.default_rng(31), B, P, [4, 3, 5])
    gt = numerators(np.random.default_rng(31), B, P, [4, 3, 5], lib=mt)
    nj = inf.stack([inf.compile_fsm(f, s, P, strategy="banded",
                                    domain="log") for f, s in gj])
    nt = mt.stack([compile_port(f, s, P, strategy="banded", domain="log")
                   for f, s in gt])
    lhs = np.random.default_rng(32).normal(size=(B, N, P)).astype(np.float32)
    lens = np.array([N, 7, 9], dtype=np.int32)
    x = torch.from_numpy(lhs).requires_grad_()
    z = mt.logmarginal(dt, x, torch.from_numpy(lens))
    z.sum().backward()
    posts, _ = mt.pdfposteriors(dt, torch.from_numpy(lhs),
                                torch.from_numpy(lens))
    torch.testing.assert_close(x.grad, posts, rtol=0, atol=0)
    lj, gradj = jax.value_and_grad(lambda v: inf.lfmmi_loss(
        nj, dj, v, jnp.asarray(lens)).sum())(jnp.asarray(lhs))
    x = torch.from_numpy(lhs).requires_grad_()
    loss = mt.lfmmi_loss(nt, dt, x, torch.from_numpy(lens)).sum()
    loss.backward()
    assert abs(loss.item() - float(lj)) <= TOL * max(1.0, abs(float(lj)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gradj), atol=TOL)


# ---------------------------------------------------------------------------
# (d) expand and the full recursions
# ---------------------------------------------------------------------------

def test_expand_matches_jax():
    V = np.arange(6, dtype=np.float32).reshape(2, 3)
    for L in (None, 2, 0):
        want = np.asarray(inf.expand(jnp.asarray(V), L))
        got = mt.expand(torch.from_numpy(V), L).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy,direction", [
    ("segment", "alpha"), ("segment", "beta"), ("ell", "alpha"),
    ("dense", "beta")])
def test_recursions_match_jax(strategy, direction):
    """α and β (B, N+1, Sp), unrescaled, against the JAX package's, and
    logZ from either end against the scan's."""
    P, N = 3, 10
    fj, ft, spdf, _ = hmm_pair(40, 5, P, lr=False, to_final=True)
    cj, ct = both(fj, ft, spdf, P, strategy=strategy, domain="log")
    lhs = np.random.default_rng(41).normal(size=(2, N, P)).astype(np.float32)
    lens = np.array([N, 6], dtype=np.int32)
    fn = {"alpha": (inf.alpha_recursion, mt.alpha_recursion),
          "beta": (inf.beta_recursion, mt.beta_recursion)}[direction]
    want = np.asarray(fn[0](cj, jnp.asarray(lhs), jnp.asarray(lens)))
    got = fn[1](ct, torch.from_numpy(lhs), torch.from_numpy(lens)).numpy()
    assert got.shape == (2, N + 1, ct.padded_states)
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    z = mt.forward(ct, torch.from_numpy(lhs), torch.from_numpy(lens)).numpy()
    if direction == "alpha":
        ends = got[np.arange(2), lens, ct.final_state]
    else:
        a = mt.alpha_recursion(ct, torch.from_numpy(lhs),
                               torch.from_numpy(lens)).numpy()
        ends = np.logaddexp.reduce(a[:, 0] + got[:, 0], axis=1)
    np.testing.assert_allclose(ends, z, rtol=1e-5)


def test_recursions_refuse_a_general_c_hat():
    fsm, spdf, P, _ = port_lm_graph(8)
    C = mt.hostsparse.spmat_from_coo(
        np.r_[np.arange(len(spdf)), 0], np.r_[spdf, (spdf[0] + 1) % P],
        np.zeros(len(spdf) + 1), (len(spdf), P + 1), mt.LOG)
    ct = compile_port(fsm, C, P, strategy="dense")
    with pytest.raises(NotImplementedError, match="general Ĉ"):
        mt.alpha_recursion(ct, torch.zeros((1, 3, P)))


# ---------------------------------------------------------------------------
# (e) the routes
# ---------------------------------------------------------------------------

def test_log_space_routes_on_every_device():
    """Log-domain graphs of every strategy, 'segment' and 'ell' graphs and
    their stacks name the plain log-space scan on the CPU and the card
    (decided without a card); no kernel admission is consulted.  The
    probability-domain routes are as before."""
    fsm, spdf, P, _ = port_lm_graph(8)
    nums = numerators(np.random.default_rng(6), 3, P, [4, 6, 5], lib=mt)
    graphs = [compile_port(fsm, spdf, P, strategy=s, domain=d)
              for s, d in (("segment", "prob"), ("ell", "prob"),
                           ("dense", "log"), ("block", "log"))]
    graphs += [mt.stack([compile_port(f, s, P, strategy=st, domain=d)
                         for f, s in nums])
               for st, d in (("banded", "log"), ("segment", "prob"),
                             ("dense", "log"))]
    for ct in graphs:
        scan, _ = tinf._plain_everywhere(ct)
        assert scan is tinf._fb_log, (ct.strategy, ct.domain)
        for dev in ("cpu", "cuda"):
            rep = mt.fast_path_report(ct, 3, device=dev)
            assert rep.startswith("plain torch log-space scan"), rep
            assert "outside any Pallas kernel" in rep
    prob = [compile_port(fsm, spdf, P, strategy="dense"),
            compile_port(fsm, spdf, P, strategy="block"),
            mt.stack([compile_port(f, s, P, strategy="banded")
                      for f, s in nums])]
    assert [tinf._plain_everywhere(c) for c in prob] == [None] * 3
    assert "K6a" in mt.fast_path_report(prob[0], 3, device="cuda")
    assert "K5a" in mt.fast_path_report(prob[2], 3, device="cuda")
    stacked = mt.stack([compile_port(f, s, P, strategy="dense")
                        for f, s in nums])
    assert tinf._plain_everywhere(stacked)[0] is tinf._fb_prob_dense_stacked


def test_kernel_admissions_refuse_the_log_domain():
    """Were a log-domain graph to reach a sum recursion's admission (K2-K4,
    K6a/K6b), it would be refused, as the JAX package's Pallas admissions
    refuse it.  The Viterbi sweeps' admissions (K6t, K7 / K7n) answer for
    it as for the same graph in the probability domain: the tropical
    decode does not depend on the domain (JAX's K7 admission has no
    domain predicate)."""
    from markovmodels_tpu_torch.ops import block_scan, dense_scan, vit_scan
    fsm, spdf, P, _ = port_lm_graph(8)
    for strategy, reject in (("dense", dense_scan.dense_scan_reject_reason),
                             ("block", block_scan.block_scan_reject_reason)):
        ct = compile_port(fsm, spdf, P, strategy=strategy, domain="log")
        cp = dataclasses.replace(ct, domain="prob", _cache={})
        assert reject(ct, 4) == "domain 'log' != 'prob'"
        prob = reject(cp, 4)
        assert prob is None or "domain" not in prob
        assert reject(ct, 4, tropical=True) == reject(cp, 4, tropical=True)
        if strategy == "block":
            assert (vit_scan.vit_scan_reject_reason(ct, 4)
                    == vit_scan.vit_scan_reject_reason(cp, 4))
