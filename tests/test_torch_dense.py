"""The port's 'dense' strategy (ops/dense_scan.py and the dense paths of
inference.py) against the JAX package: the compile field by field, the
K6a/K6b plain twins against the fused Pallas kernels
(``pallas_scan.fused_forward`` / ``fused_backward``, interpret mode), the
dense ``pdfposteriors`` / ``forward`` against the JAX fused and XLA paths
and the exact float64 host oracle, ``stack`` of dense graphs and the
per-graph route, the LF-MMI step with a dense denominator, and the
admission and dispatch rules.

Graphs: the LM ∘ HMM generator at V=8 (193 states, Sp=256, 24 pdfs) and
V=16 (769 states, Sp=896, 48 pdfs), and small random non-banded graphs.
Inputs are made from numpy seeds.  The CUDA kernels themselves are held
against these twins on the card by ``chip_smoke.py``."""
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
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import dense_scan as ds
from _torch_port import (EXP_ULPS, assert_same_compiled, compile_port,
                         inputs, jax_compiled, lm_graph, numerators,
                         port_from_jax, port_lm_graph, random_graph, ulps)

TOL = 1e-5  # port vs the JAX package: float32 sums in another order
TOL_ORACLE = 2e-4  # vs the f64 oracle (tests/test_pallas_scan.py's bound)


def _env(mp, name):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
        mp.delenv(k, raising=False)
    if name:
        mp.setenv(name, "1")


def _assert_logz(z, ref, atol):
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref[fin], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# (a) compile and compiled_from_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [8, 16])
def test_dense_compile_matches_jax(V):
    """Row maxima and index arrays bit-equal; exp(W - row_max) within
    EXP_ULPS (torch's float32 exp against XLA's)."""
    fsm, spdf, P, _ = port_lm_graph(V)
    cj = jax_compiled(V, strategy="dense")
    ct = compile_port(fsm, spdf, P, strategy="dense")
    assert ct.strategy == "dense" and ct.padded_states % 128 == 0
    assert ct.omega_prob is None and ct.block_fwd is None
    assert ct.pdf_onehot is not None and ct.pdf_group == ()
    assert_same_compiled(cj, ct)
    for d in ("fwd", "bwd"):
        e = getattr(ct, f"dense_{d}_exp")
        assert e.dtype == torch.float32 and e.shape == (ct.padded_states,) * 2
        assert ulps(getattr(cj, f"dense_{d}_exp"), e) <= EXP_ULPS


@pytest.mark.parametrize("V", [8, 16])
def test_dense_compiled_from_numpy_carries_the_jax_arrays(V):
    cj = jax_compiled(V, strategy="dense")
    ct = port_from_jax(cj)
    assert_same_compiled(cj, ct)
    assert_same_compiled(cj, ct.to("cpu"))
    assert ulps(cj.dense_fwd_exp, ct.dense_fwd_exp) == 0
    moved = ct.to("meta")
    assert all(getattr(moved, f"dense_{d}_{k}").device.type == "meta"
               for d in ("fwd", "bwd") for k in ("exp", "max"))


# ---------------------------------------------------------------------------
# (b) the K6 twins against the fused Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_pair():
    """One ragged, cliffed input (lengths 9 .. 1) through
    ``pallas_scan.fused_forward`` / ``fused_backward`` and the port's
    twins, on the same operator, emissions and initial state."""
    cj = jax_compiled(8, strategy="dense")
    ct = port_from_jax(cj)
    kop = ds.kernel_operator(ct)
    P = ct.num_pdfs
    lhs, lens = inputs(6, 9, P, seed=31, lens=[9, 1, 5, 9, 3, 7],
                       cliffs=True)
    ext_j, msh_j = ps.prepare_emissions(jnp.asarray(lhs), jnp.asarray(lens),
                                        P)
    a0 = kop.alpha0[:, None].expand(kop.Sp, 6).contiguous()
    oh_state = jnp.asarray(cj.pdf_onehot).T
    alphas_j, afin_j, shift_j, ksum_j = ps.fused_forward(
        jnp.asarray(kop.wf.numpy()), oh_state, ext_j, msh_j,
        jnp.asarray(a0.numpy()), save_alphas=True, precision="high")
    posts_j = ps.fused_backward(jnp.asarray(kop.wb.numpy()), cj.pdf_onehot,
                                oh_state, ext_j, alphas_j, precision="high")
    ext_t = torch.from_numpy(np.array(ext_j))
    msh_t = torch.from_numpy(np.array(msh_j))
    ds.reset_launch_counts()
    fwd_t = ds.fwd_sweep(kop, a0, ext_t, msh_t)
    alphas_from_jax = torch.from_numpy(np.array(alphas_j))
    posts_t = ds.backward(kop, ext_t, alphas_from_jax,
                          torch.ones((10, 6)))
    posts_own = ds.backward(kop, ext_t, fwd_t[0], fwd_t[1])
    launches = dict(ds.LAUNCHES)
    jax_out = tuple(np.asarray(x) for x in (alphas_j, afin_j, shift_j,
                                            ksum_j, posts_j))
    return (kop, ext_t, msh_t, a0, jax_out, fwd_t, posts_t.numpy(),
            posts_own.numpy(), launches)


def _colnorm(a):
    a = np.asarray(a, dtype=np.float64)
    m = a.max(axis=-2, keepdims=True)
    return a / np.where(m > 0, m, 1.0)


def test_twin_forward_matches_fused_pallas(fused_pair):
    kop, _, _, _, (alphas_j, afin_j, shift_j, ksum_j, _), fwd_t = \
        fused_pair[:6]
    alphas, ascale, a_last, s_last, ksum, shift = fwd_t
    assert alphas.shape == alphas_j.shape == (10, kop.Sp, 6)
    # unscaled states times their scales are JAX's rescaled alphas
    np.testing.assert_allclose(
        (alphas * ascale[:, None, :]).numpy(), alphas_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(_colnorm(alphas.numpy()), _colnorm(alphas_j),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(ksum.numpy(), ksum_j)
    np.testing.assert_allclose(shift.numpy(), shift_j, atol=TOL, rtol=0)
    vj = afin_j[kop.fin]
    zj = np.asarray(inf._combine_shift(
        jnp.where(vj > 0, jnp.log(jnp.maximum(vj, 1e-38)), -jnp.inf),
        ksum_j, shift_j))
    zt = tinf._combine_shift(tinf._log_final(a_last[kop.fin] * s_last),
                             ksum, shift).numpy()
    assert np.isfinite(zj).sum() >= 4 and not np.isfinite(zj[1])
    _assert_logz(zt, zj, TOL)


@pytest.mark.parametrize("alphas", ["jax", "own"])
def test_twin_backward_matches_fused_pallas(fused_pair, alphas):
    """Posteriors from JAX's alphas (the same inputs) and from the twin's
    own forward, against ``fused_backward``."""
    posts_j = fused_pair[4][4]
    posts_t = fused_pair[6] if alphas == "jax" else fused_pair[7]
    assert posts_t.shape == posts_j.shape == (10, 25, 6)
    np.testing.assert_allclose(posts_t, posts_j, atol=TOL, rtol=0)
    assert np.isfinite(posts_t).all()
    assert (posts_t[:, :, 1] == 0).all()  # the infeasible L=1 sequence


def test_twins_launch_no_kernel_on_cpu(fused_pair):
    assert fused_pair[8] == {"dense_fwd": 0, "dense_bwd": 0,
                             "dense_trop": 0}


def test_forward_twin_without_alphas_gives_the_same_logz(fused_pair):
    """forward() keeps no state tensor: the same last state, scale and
    logZ pieces."""
    kop, ext, msh, a0, _, fwd_t = fused_pair[:6]
    out = ds.fwd_sweep(kop, a0, ext, msh, save_alphas=False)
    assert out[0] is None and out[1] is None
    assert all(torch.equal(x, y) for x, y in zip(out[2:], fwd_t[2:]))


# ---------------------------------------------------------------------------
# (c) dense pdfposteriors / forward against the JAX package and the oracle
# ---------------------------------------------------------------------------

B, N = 5, 8
LENS = [8, 6, 1, 8, 4]


@pytest.fixture(scope="module")
def graphs16():
    fsm, spdf, P, _ = port_lm_graph(16)
    return jax_compiled(16, strategy="dense"), compile_port(fsm, spdf, P)


@pytest.fixture(scope="module")
def data16(graphs16):
    return inputs(B, N, graphs16[1].num_pdfs, seed=41, lens=LENS,
                  cliffs=True)


def _jax_run(cf, lhs, lens, env, chunk_size=None, want_posts=True):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, env)
        if env == "MMTPU_PALLAS_INTERPRET":
            assert inf._pallas_ok(cf, jnp.asarray(lhs))
        args = (cf, jnp.asarray(lhs), jnp.asarray(lens))
        if not want_posts:
            return np.asarray(inf.forward(*args, chunk_size=chunk_size))
        posts, z = inf.pdfposteriors(*args, chunk_size=chunk_size)
        return np.asarray(posts), np.asarray(z)


@pytest.fixture(scope="module")
def refs16(graphs16, data16):
    cj = graphs16[0]
    return {"jax_fused": _jax_run(cj, *data16, "MMTPU_PALLAS_INTERPRET"),
            "jax_xla": _jax_run(cj, *data16, "MMTPU_NO_PALLAS")}


@pytest.fixture(scope="module")
def ports16(graphs16, data16):
    """The plain scan (the CPU dispatch) and the kernel route's twins
    (``_fb_dense_cuda`` on CPU tensors)."""
    ct = graphs16[1]
    lhs, lens = (torch.from_numpy(x) for x in data16)
    plain = mt.pdfposteriors(ct, lhs, lens)
    twins = tinf._fb_dense_cuda(ct, lhs, lens, True)
    return {p: (x[0].numpy(), x[1].numpy())
            for p, x in (("plain", plain), ("twins", twins))}


@pytest.mark.parametrize("path", ["plain", "twins"])
@pytest.mark.parametrize("ref", ["jax_fused", "jax_xla"])
def test_dense_pdfposteriors_match_jax(ports16, refs16, path, ref):
    posts, z = ports16[path]
    pj, zj = refs16[ref]
    assert posts.shape == (B, N, 48)
    _assert_logz(z, zj, TOL)
    np.testing.assert_allclose(posts, pj, atol=TOL, rtol=0)


@pytest.mark.parametrize("path", ["plain", "twins"])
def test_dense_pdfposteriors_match_f64_oracle(ports16, data16, path):
    fsm, spdf, P, _ = lm_graph(16)
    lhs, lens = data16
    ref_z, ref_p = bench.host_oracle(fsm, spdf, P, lhs.astype(np.float64),
                                     lens)
    posts, z = ports16[path]
    assert np.isneginf(z[2]) and np.isfinite(np.delete(z, 2)).all()
    _assert_logz(z, ref_z, TOL_ORACLE)
    np.testing.assert_allclose(posts, ref_p, atol=TOL_ORACLE, rtol=0)
    for b, L in enumerate(lens):
        assert (posts[b, L:] == 0).all()


@pytest.mark.parametrize("ref", ["jax_fused", "jax_xla"])
def test_dense_forward_matches_jax(graphs16, data16, ref):
    cj, ct = graphs16
    lhs, lens = data16
    env = {"jax_fused": "MMTPU_PALLAS_INTERPRET",
           "jax_xla": "MMTPU_NO_PALLAS"}[ref]
    zj = _jax_run(cj, lhs, lens, env, want_posts=False)
    z = mt.forward(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    zk = tinf._fb_dense_cuda(ct, torch.from_numpy(lhs),
                             torch.from_numpy(lens), False)
    assert zk[0] is None
    _assert_logz(z.numpy(), zj, TOL)
    _assert_logz(zk[1].numpy(), zj, TOL)


def test_dense_chunked_plain_scan_matches_jax_xla(graphs16, data16):
    """chunk_size=3: chunk checkpointing with pad frames."""
    cj, ct = graphs16
    lhs, lens = data16
    pj, zj = _jax_run(cj, lhs, lens, "MMTPU_NO_PALLAS", chunk_size=3)
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens), chunk_size=3)
    _assert_logz(zt.numpy(), zj, TOL)
    np.testing.assert_allclose(pt.numpy(), pj, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# (d) stack of dense graphs and the per-graph route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked():
    """lm_graph(8) (Sp=256) and three random non-banded graphs (Sp=128)
    over its 24 pdfs: the stack pads the small operators."""
    P = 24

    def graphs_of(lib, graph8):
        rng = np.random.default_rng(51)
        graphs = [random_graph(rng, S, P, lib) for S in (11, 30)]
        graphs.insert(1, graph8(8)[:2])
        graphs.append(random_graph(rng, 57, P, lib))
        return graphs, rng

    graphs, rng = graphs_of(mm, lm_graph)
    graphs_t, _ = graphs_of(mt, port_lm_graph)
    lhs = (rng.normal(size=(4, 12, P)) * 0.7).astype(np.float32)
    lens = np.array([12, 9, 12, 5], dtype=np.int32)
    cjs = [inf.compile_fsm(f, sp, P) for f, sp in graphs]
    cts = [compile_port(f, sp, P) for f, sp in graphs_t]
    return graphs, cjs, cts, lhs, lens


def test_stack_dense_matches_jax(stacked):
    _, cjs, cts, _, _ = stacked
    assert all(c.strategy == "dense" for c in cjs + cts)
    sj, st = inf.stack(cjs), mt.stack(cts)
    assert st.batched and st.padded_states == 256
    assert_same_compiled(sj, st)
    # padding: zero operator rows and columns, -inf row maxima
    assert not st.dense_fwd_exp[0, 128:].any()
    assert not st.dense_fwd_exp[0, :, 128:].any()
    assert torch.isneginf(st.dense_bwd_max[3, 128:]).all()
    moved = st.to("meta")
    assert moved.dense_fwd_exp.device.type == "meta"
    assert moved.final_state.device.type == "meta"


@pytest.mark.parametrize("chunk", [None, 4])
def test_stacked_dense_pdfposteriors_match_jax(stacked, chunk):
    _, cjs, cts, lhs, lens = stacked
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_NO_PALLAS")
        pj, zj = inf.pdfposteriors(inf.stack(cjs), jnp.asarray(lhs),
                                   jnp.asarray(lens), chunk_size=chunk)
    pt, zt = mt.pdfposteriors(mt.stack(cts), torch.from_numpy(lhs),
                              torch.from_numpy(lens), chunk_size=chunk)
    _assert_logz(zt.numpy(), np.asarray(zj), TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)


def test_stacked_dense_matches_f64_oracle(stacked):
    graphs, _, cts, lhs, lens = stacked
    pt, zt = mt.pdfposteriors(mt.stack(cts), torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = bench.host_oracle(fsm, spdf, 24,
                                   lhs[g:g + 1].astype(np.float64),
                                   lens[g:g + 1])
        _assert_logz(zt.numpy()[g:g + 1], rz, TOL_ORACLE)
        np.testing.assert_allclose(pt.numpy()[g:g + 1], rp, atol=TOL_ORACLE,
                                   rtol=0)
        assert (pt.numpy()[g, lens[g]:] == 0).all()


def test_stacked_dense_route_on_every_device(stacked):
    """The per-graph route is the designated path on CPU and CUDA alike
    (the JAX package's dense kernels reject batched graphs); a batch that
    is not one sequence per graph still raises."""
    _, _, cts, lhs, _ = stacked
    st = mt.stack(cts)
    for dev in ("cpu", "cuda"):
        assert "per-graph" in tinf.fast_path_report(st, 4, device=dev)
    with pytest.raises(ValueError, match="batched CompiledFSM"):
        tinf._kernel_route(st, "cuda", 4)
    with pytest.raises(ValueError, match="one sequence per graph"):
        mt.pdfposteriors(st, torch.from_numpy(lhs[:3]))


# ---------------------------------------------------------------------------
# (e) the LF-MMI step with a dense denominator
# ---------------------------------------------------------------------------

def test_lfmmi_with_dense_denominator_matches_jax():
    """Value and gradient of ``lfmmi_loss`` (stacked banded numerators,
    lm_graph(8) 'dense' denominator) against ``jax.value_and_grad`` of the
    JAX package's, and the gradient against γ_den - γ_num."""
    fsm, spdf, P, _ = port_lm_graph(8)
    nums = numerators(np.random.default_rng(61), 4, P, [5, 3, 6, 4])
    nums_t = numerators(np.random.default_rng(61), 4, P, [5, 3, 6, 4],
                        lib=mt)
    num_j = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded")
                       for f, sp in nums])
    num_t = mt.stack([compile_port(f, sp, P, strategy="banded")
                      for f, sp in nums_t])
    den_j = jax_compiled(8, strategy="dense")
    den_t = compile_port(fsm, spdf, P)
    assert den_t.strategy == "dense"
    lhs, lens = inputs(4, 8, P, seed=67, lens=[8, 7, 8, 5])
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_NO_PALLAS")
        loss_j, grad_j = jax.value_and_grad(
            lambda x: inf.lfmmi_loss(num_j, den_j, x,
                                     jnp.asarray(lens)).sum()
        )(jnp.asarray(lhs))
    x = torch.from_numpy(lhs).requires_grad_()
    L = torch.from_numpy(lens)
    loss = mt.lfmmi_loss(num_t, den_t, x, L)
    loss.sum().backward()
    assert torch.isfinite(loss).all()
    np.testing.assert_allclose(float(loss.detach().sum()), float(loss_j),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=TOL,
                               rtol=0)
    pn, _ = mt.pdfposteriors(num_t, torch.from_numpy(lhs), L)
    pd, _ = mt.pdfposteriors(den_t, torch.from_numpy(lhs), L)
    np.testing.assert_allclose(x.grad.numpy(), (pd - pn).numpy(), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# (f) admission and dispatch
# ---------------------------------------------------------------------------

def _shared_variants(cj, ct, stacked):
    """(name, JAX graph, port graph) for each rejected predicate the two
    packages share, in their order."""
    rep = dataclasses.replace
    _, cjs, cts, _, _ = stacked
    return [
        ("strategy", jax_compiled(16), port_from_jax(jax_compiled(16))),
        ("domain", rep(cj, domain="log"), rep(ct, domain="log")),
        ("one-hot", rep(cj, pdf_onehot=None), rep(ct, pdf_onehot=None)),
        ("batched", inf.stack(cjs), mt.stack(cts)),
        ("multi-pdf", rep(cj, multi_pdf=True), rep(ct, multi_pdf=True)),
    ]


def test_reject_reasons_match_jax(stacked, monkeypatch):
    cj = jax_compiled(8, strategy="dense")
    ct = port_from_jax(cj)
    _env(monkeypatch, "MMTPU_PALLAS_INTERPRET")
    assert inf._pallas_dense_reject_reason(cj, 4) is None
    assert ds.dense_scan_reject_reason(ct, 4) is None
    for name, vj, vt in _shared_variants(cj, ct, stacked):
        want = inf._pallas_dense_reject_reason(vj, 4)
        assert want is not None, name
        assert ds.dense_scan_reject_reason(vt, 4) == want, name
    # float64: the TPU kernels refuse it, the port's float64 instantiation
    # takes it; another dtype: the same predicate, the port's own words
    # after it
    vj = dataclasses.replace(cj, alpha_hat=np.asarray(cj.alpha_hat,
                                                      np.float64))
    vt = dataclasses.replace(ct, alpha_hat=ct.alpha_hat.double())
    assert inf._pallas_dense_reject_reason(vj, 4).startswith(
        "operator dtype float64")
    assert ds.dense_scan_reject_reason(vt, 4) is None
    vj = dataclasses.replace(cj, alpha_hat=np.asarray(cj.alpha_hat,
                                                      np.float16))
    vt = dataclasses.replace(ct, alpha_hat=ct.alpha_hat.half())
    head = "operator dtype float16"
    assert inf._pallas_dense_reject_reason(vj, 4).startswith(head)
    assert ds.dense_scan_reject_reason(vt, 4).startswith(head)


def test_reject_reasons_name_each_port_predicate(stacked, monkeypatch):
    ct = port_from_jax(jax_compiled(8, strategy="dense"))
    rep = dataclasses.replace
    cases = [
        (mt.stack(stacked[2]), "batched CompiledFSM"),
        (rep(ct, multi_pdf=True), "general multi-pdf C-hat"),
        (rep(ct, alpha_hat=ct.alpha_hat.half()), "operator dtype float16"),
        (rep(ct, alpha_hat=ct.alpha_hat.double(), precision="bf16"),
         "precision 'bf16' with dtype float64"),
        (rep(ct, alpha_hat=torch.zeros(200)), "not a multiple of"),
    ]
    for cf, match in cases:
        assert match in ds.dense_scan_reject_reason(cf, 4), match
    # the device-memory predicate, against a card with 1 MB free
    monkeypatch.setattr(ds, "_free_bytes", lambda device: 1 << 20)
    assert ds.dense_scan_reject_reason(ct, 4) is None  # no frame count
    reason = ds.dense_scan_reject_reason(ct, 4, n_frames=700, device="cuda")
    assert reason.startswith("device memory") and "Sp = 256" in reason
    need = ds._device_bytes(ct, 4, 700)
    assert need == 4 * (2 * 256 * 256 + 701 * 257 * 4 + 2 * 701 * 25 * 4
                        + 3 * 256 * 4)


def test_dense_dispatch_and_report(monkeypatch):
    """CPU -> plain scan, CUDA + accepted -> K6a/K6b, CUDA + rejected ->
    raises naming the predicate; no quiet fallback."""
    ct = port_from_jax(jax_compiled(8, strategy="dense"))
    assert tinf._kernel_route(ct, "cpu", 4) is False
    assert tinf._kernel_route(ct, "cuda", 4) is True
    assert "plain" in tinf.fast_path_report(ct, 4)
    assert tinf.fast_path_report(ct, 4, device="cuda") == (
        "cuda-dense-scan (hand-written CUDA kernels K6a/K6b)")
    bad = dataclasses.replace(ct, multi_pdf=True)
    with pytest.raises(ValueError, match="dense scan rejects this graph: "
                                         "general multi-pdf"):
        tinf._kernel_route(bad, "cuda", 4)
    assert "general multi-pdf" in tinf.fast_path_report(bad, 4,
                                                        device="cuda")
    monkeypatch.setattr(ds, "_free_bytes", lambda device: 1 << 20)
    with pytest.raises(ValueError, match="device memory"):
        tinf._kernel_route(ct, "cuda", 4, 700)


def test_wrappers_refuse_other_devices():
    kop = ds.kernel_operator(port_from_jax(jax_compiled(8, strategy="dense")))
    ext = torch.empty((4, kop.P1, 2), device="meta")
    a0 = torch.empty((kop.Sp, 2), device="meta")
    with pytest.raises(ValueError, match="no dense-scan kernel"):
        ds.fwd_sweep(kop, a0, ext, ext[:, :1])
    with pytest.raises(ValueError, match="no dense-scan kernel"):
        ds.backward(kop, ext, ext, ext[:, 0])


def test_kernel_operator_pdf_lists():
    """The CSR list behind K6b's deterministic pdf sums: pdf p owns
    perm[off[p]:off[p+1]], in increasing state order; the padding states
    (never any mass) are in no list."""
    ct = port_from_jax(jax_compiled(8, strategy="dense"))
    kop = ds.kernel_operator(ct)
    assert ds.kernel_operator(ct) is kop  # cached on the graph
    spdf = ct.state_pdf.numpy()
    perm, off = kop.perm.numpy(), kop.off.numpy()
    assert off[0] == 0 and off[-1] == ct.num_states == 193 < kop.Sp
    assert np.array_equal(np.sort(perm), np.arange(193))
    for p in range(kop.P1):
        rows = perm[off[p]:off[p + 1]]
        assert (np.diff(rows) > 0).all() and (spdf[rows] == p).all()
    assert torch.equal(kop.wf, torch.exp(ct.dense_fwd_max)[:, None]
                       * ct.dense_fwd_exp)
