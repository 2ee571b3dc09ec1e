"""float64 graphs (``compile_fsm(dtype=torch.float64)``) in the port
against the JAX package on the CPU:

* the compile of 'dense', 'block' (the pdf-grouped layout and the capped
  layout of a separate-state graph) and 'banded' graphs, field by field,
  against the JAX package's float64 compile;
* the plain scan (``pdfposteriors``, ``logmarginal`` with its gradient,
  ``lfmmi_loss`` with float64 stacked numerators and a float64 'block'
  denominator) against the float64 oracle (``mt.oracle.host_oracle``) and
  the JAX package's float64 XLA scan; one 'block' graph at N=700;
* Viterbi scores and paths against the float64 max-plus optimum and the
  JAX package's float64 decode;
* the K2-K4 twins in float64 on the 2M-arc graph against the plain scan,
  and the K5a/K5b twins on float64 numerators;
* the float64 operators of K6a/K6b and K6t (the plain decode route's
  operator), the shared memory of their tile plans at 8 bytes a value,
  the K6a/K6b twins in float64 against the plain scan and the oracle, and
  the W2 twin inside a chunked float64 dense decode against the JAX
  package's float64 decode;
* the routes on a ``cuda`` device (decided without a card): K2-K4's
  float64 instantiation for a 'block' graph, K6a/K6b's for a 'dense' one,
  K5a/K5b's for a stack of numerators, the float64 decode admitted by K7
  and K7n, a stacked float64 'dense' graph on the plain per-graph route,
  and the ``ValueError`` for float32 log-likelihoods.

The JAX package runs inside ``jax.enable_x64()``: outside it, its compile
builds float32 arrays whatever the dtype.  Its 'dense' route multiplies
with ``preferred_element_type=float32`` (``inference.py:1261-1264``), so
each frame's product is rounded to float32 there; the port computes in
float64 end to end, and is held to the JAX 'dense' route at the error that
rounding leaves (the reading is printed).  Inputs are made from numpy
seeds."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import banded_scan as bsc
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import dense_scan as ds
from markovmodels_tpu_torch.ops import vit_scan as vs
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import (assert_same_compiled, compile_port, jax_fields,
                         lm_graph, numerators, port_lm_graph)

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

F64 = torch.float64
TOL_ORACLE = 1e-8  # float64 end to end against the float64 oracle
TOL_JAX = 1e-9  # against the JAX package's float64 XLA 'block' route
# against its 'dense' route, whose products are rounded to float32 per
# frame (4.4e-7 in logZ on this graph at N=300)
TOL_JAX_DENSE = 1e-5
# posteriors against a JAX route that reduces them through a float32
# product (the one-hot pdf sums of a capped layout, the stacked numerators)
TOL_JAX_F32_SUMS = 1e-6
B, N = 3, 40
LENS = [40, 27, 1]  # the length-1 sequence is infeasible: logZ -inf


def _jax64(fn, *args, **kw):
    """``fn`` of the JAX package inside ``jax.enable_x64()`` (numpy
    arguments become JAX arrays there, float64 ones staying float64), the
    result as numpy."""
    with jax.enable_x64():
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        return jax.tree.map(np.asarray, fn(*args, **kw))


def _compile_jax64(fsm, spdf, P, **kw):
    with jax.enable_x64():
        return inf.compile_fsm(fsm, spdf, P, dtype=jnp.float64, **kw)


def _separate(lib_make):
    return lib_make(layout="separate", V=8, hmm_states=3, keep=0.3)


# (JAX graph, port graph, compile kwargs) per case
CASES = {
    "dense": (lambda: lm_graph(8), lambda: port_lm_graph(8),
              dict(strategy="dense")),
    "block": (lambda: lm_graph(8), lambda: port_lm_graph(8),
              dict(strategy="block")),
    "block capped": (lambda: _separate(make_backoff_lm_hmm_graph),
                     lambda: _separate(mt.workloads.make_backoff_lm_hmm_graph),
                     dict(strategy="block", ov_cap=8)),
}


def _pair(name):
    gj, gt, kw = CASES[name]
    (fj, sj, P, _), (ft, st, _, _) = gj(), gt()
    return (fj, sj), (ft, st), P, kw


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, JAX float64 compile, port float64 compile, host graph, P)."""
    (fj, sj), (ft, st), P, kw = _pair(request.param)
    cj = _compile_jax64(fj, sj, P, **kw)
    ct = compile_port(ft, st, P, dtype=F64, **kw)
    return request.param, cj, ct, (ft, st), P


def test_compile_matches_jax(case):
    name, cj, ct, _, _ = case
    assert ct.alpha_hat.dtype == F64 and np.asarray(cj.alpha_hat).dtype == \
        np.float64
    if name == "block":
        assert ct.pdf_group and ct.block_fwd.tiers[0][2].dtype == F64
    if name == "block capped":
        assert ct.ov_layout and ct.block_fwd.ov_w[0].dtype == F64
    if name == "dense":
        assert ct.dense_fwd_exp.dtype == F64
    assert ct.pdf_onehot is None or ct.pdf_onehot.dtype == torch.float32
    assert_same_compiled(cj, ct)
    # the JAX package's float64 fields carried across as they are
    assert_same_compiled(cj, mt.compiled_from_numpy(*jax_fields(cj),
                                                    device="cpu"))


def test_banded_compile_and_stack_match_jax():
    rng = np.random.default_rng(5)
    lens = [5, 7, 4]
    P = 6
    gj = numerators(rng, 3, P, lens)
    gt = numerators(np.random.default_rng(5), 3, P, lens, lib=mt)
    cjs = [_compile_jax64(f, sp, P, strategy="banded") for f, sp in gj]
    cts = [compile_port(f, sp, P, strategy="banded", dtype=F64)
           for f, sp in gt]
    for cj, ct in zip(cjs, cts):
        assert ct.banded_fwd.dtype == F64
        assert_same_compiled(cj, ct)
    with jax.enable_x64():
        sj = inf.stack(cjs)
    st = mt.stack(cts)
    assert st.banded_fwd.dtype == st.omega_prob.dtype == F64
    assert_same_compiled(sj, st)


def _inputs(P, n=N, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(len(lens), n, P)) * 2.0  # float64
    return lhs, np.asarray(lens, dtype=np.int32)


@pytest.fixture(scope="module")
def scans(case):
    """The port's plain scan, the JAX package's float64 scan and the
    float64 oracle on one ragged input."""
    name, cj, ct, (fsm, spdf), P = case
    lhs, lens = _inputs(P)
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    assert pt.dtype == zt.dtype == F64
    pj, zj = _jax64(inf.pdfposteriors, cj, lhs, lens)
    zo, po = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    return name, (pt.numpy(), zt.numpy()), (pj, zj), (po, zo), lens


def test_plain_scan_matches_the_f64_oracle(scans):
    _, (pt, zt), _, (po, zo), lens = scans
    fin = np.isfinite(zo)
    assert (np.isfinite(zt) == fin).all() and not fin[2]
    assert np.abs(zt[fin] - zo[fin]).max() <= TOL_ORACLE
    for b in np.flatnonzero(fin):
        assert np.abs(pt[b] - po[b]).max() <= TOL_ORACLE
        assert (pt[b, lens[b]:] == 0).all()


def test_plain_scan_matches_jax_float64(scans):
    name, (pt, zt), (pj, zj), _, _ = scans
    fin = np.isfinite(zj)
    assert (np.isfinite(zt) == fin).all()
    dz = np.abs(zt[fin] - zj[fin]).max()
    dp = np.abs(pt[fin] - pj[fin]).max()
    print(f"{name}: port vs JAX float64 |dlogZ| = {dz:.3e}, "
          f"|dposts| = {dp:.3e}")
    if name == "dense":
        assert dz <= TOL_JAX_DENSE and dp <= TOL_JAX_DENSE
    else:
        assert dz <= TOL_JAX
        # the capped layout's JAX posteriors are one-hot products rounded
        # to float32 (inference.py:986-990)
        assert dp <= (TOL_JAX if name == "block" else TOL_JAX_F32_SUMS)


def test_logmarginal_gradient_is_the_f64_posteriors(case, scans):
    _, _, ct, _, P = case
    _, (pt, zt), _, (po, zo), _ = scans
    lhs, lens = _inputs(P)
    x = torch.from_numpy(lhs).requires_grad_()
    z = mt.logmarginal(ct, x, torch.from_numpy(lens))
    fin = torch.isfinite(z)
    z[fin].sum().backward()
    np.testing.assert_array_equal(z.detach().numpy(), zt)
    g = x.grad.numpy()
    for b in np.flatnonzero(fin.numpy()):
        assert np.abs(g[b] - po[b]).max() <= TOL_ORACLE


def test_block_graph_at_n700_matches_the_f64_oracle():
    fsm, spdf, P, _ = port_lm_graph(8)
    ct = compile_port(fsm, spdf, P, strategy="block", dtype=F64)
    lhs, lens = _inputs(P, n=700, lens=[700, 467], seed=9)
    lhs *= 1.5
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    zo, po = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    assert np.isfinite(zo).all()
    assert np.abs(zt.numpy() - zo).max() <= TOL_ORACLE
    assert np.abs(pt.numpy() - po).max() <= TOL_ORACLE


@pytest.fixture(scope="module")
def lfmmi():
    """float64 stacked numerators and the float64 V=8 'block'
    denominator, in both packages, and one input."""
    fsm_t, spdf_t, P, _ = port_lm_graph(8)
    fsm_j, spdf_j, _, _ = lm_graph(8)
    num_lens = [6, 4, 7]
    nums_j = numerators(np.random.default_rng(23), 3, P, num_lens)
    nums_t = numerators(np.random.default_rng(23), 3, P, num_lens, lib=mt)
    num_t = mt.stack([compile_port(f, sp, P, strategy="banded", dtype=F64)
                      for f, sp in nums_t])
    den_t = compile_port(fsm_t, spdf_t, P, strategy="block", dtype=F64)
    with jax.enable_x64():
        num_j = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded",
                                           dtype=jnp.float64)
                           for f, sp in nums_j])
    den_j = _compile_jax64(fsm_j, spdf_j, P, strategy="block")
    lhs, lens = _inputs(P, n=12, lens=[12, 9, 11], seed=29)
    return (num_j, den_j), (num_t, den_t), nums_t, (fsm_t, spdf_t), P, \
        lhs, lens


def test_lfmmi_loss_and_gradient_in_float64(lfmmi):
    (num_j, den_j), (num_t, den_t), nums_t, (fsm, spdf), P, lhs, lens = lfmmi
    report = tinf.fast_path_report(num_t, 3, device="cuda")
    assert report.startswith("cuda-banded-scan (hand-written CUDA kernels "
                             "K5a/K5b") and report.endswith(", float64)")
    x = torch.from_numpy(lhs).requires_grad_()
    loss = mt.lfmmi_loss(num_t, den_t, x, torch.from_numpy(lens))
    loss.sum().backward()
    assert loss.dtype == x.grad.dtype == F64
    loss_j = _jax64(inf.lfmmi_loss, num_j, den_j, lhs, lens)
    grad_j = _jax64(jax.grad(lambda v: inf.lfmmi_loss(num_j, den_j, v,
                                                      lens).sum()), lhs)
    assert np.abs(loss.detach().numpy() - loss_j).max() <= TOL_JAX
    # the JAX stacked numerators sum their posteriors through a float32
    # product (inference.py:1098-1102)
    assert np.abs(x.grad.numpy() - grad_j).max() <= TOL_JAX_F32_SUMS
    zd, pd = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    for g, (f, sp) in enumerate(nums_t):
        zn, pn = mt.oracle.host_oracle(f, sp, P, lhs[g:g + 1],
                                       lens[g:g + 1])
        assert abs(loss[g].item() - (zd[g] - zn[0])) <= TOL_ORACLE
        assert np.abs(x.grad.numpy()[g] - (pd[g] - pn[0])).max() \
            <= TOL_ORACLE


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_viterbi_in_float64(strategy):
    (fj, sj), (ft, st), P, _ = _pair(strategy)
    cj = _compile_jax64(fj, sj, P, strategy=strategy)
    ct = compile_port(ft, st, P, strategy=strategy, dtype=F64)
    lhs, lens = _inputs(P, n=30, lens=[30, 19, 1], seed=41)
    states, score = mt.viterbi(ct, torch.from_numpy(lhs),
                               torch.from_numpy(lens))
    assert score.dtype == F64
    sj_, zj = _jax64(jvit.viterbi, cj, lhs, lens)
    ref = mt.oracle.host_viterbi_score(ft, st, P, lhs, lens)
    z = score.numpy()
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all() and not fin[2]
    assert np.abs(z[fin] - ref[fin]).max() <= TOL_ORACLE
    assert np.abs(z[fin] - zj[fin]).max() <= TOL_ORACLE
    gap = mt.oracle.validate_paths(ft, st, lhs[fin], lens[fin],
                                   states.numpy()[fin], z[fin],
                                   atol=TOL_ORACLE)
    assert gap <= TOL_ORACLE
    np.testing.assert_array_equal(states.numpy()[fin], sj_[fin])


@pytest.fixture(scope="module")
def big64():
    """The 2M-arc graph compiled float64 ('block')."""
    fsm, spdf, P, _ = port_lm_graph(128)
    return compile_port(fsm, spdf, P, strategy="block", dtype=F64)


def test_block_twins_in_float64_match_the_plain_scan(big64):
    """K2-K4's plain twins on the float64 2M-arc graph (the float64
    kernel operator) against the float64 plain scan."""
    ct, P = big64, big64.num_pdfs
    assert bs.block_scan_reject_reason(ct, 2) is None
    kop = bs.kernel_operator(ct)
    for t in (kop.alpha0, kop.omega, kop.fwd.W, kop.fwd.band_w, kop.bwd.W,
              kop.bwd.band_w):
        assert t.dtype == F64
    lhs, lens = _inputs(P, n=6, lens=[6, 4], seed=43)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P, F64)
    assert ext.dtype == msh.dtype == F64
    bs.reset_launch_counts()
    posts, vfin, shift, ksum = bs.block_fused_fb(ct, ext, msh, True, chunk=3)
    assert not any(bs.LAUNCHES_F64.values())  # CPU: the twins
    zk = tinf._combine_shift(tinf._log_final(vfin), ksum, shift).numpy()
    pp, zp = tinf._fb_prob(ct, torch.from_numpy(lhs), torch.from_numpy(lens),
                           3, True)
    np.testing.assert_allclose(zk, zp.numpy(), rtol=1e-12, atol=0)
    pk = posts.permute(2, 0, 1)[:, :6, :P].numpy()
    assert np.abs(pk - pp.numpy()).max() <= 1e-10


def test_routes_on_the_card(big64):
    """Decided on a ``cuda`` device without a card: a float64 'block'
    graph takes K2-K4's float64 instantiation and a float64 'dense' graph
    K6a/K6b's (``fast_path_report`` names it); a stacked float64 'dense'
    graph takes the plain per-graph route, as a stacked float32 one does;
    the float64 decode passes K7's and K7n's admission and is no longer
    refused; only general Ĉ is (``test_torch_multipdf.py``)."""
    fsm, spdf, P, _ = port_lm_graph(8)
    dense = compile_port(fsm, spdf, P, strategy="dense", dtype=F64)
    assert tinf._unported_on_card(dense) is None
    assert tvit._unported_decode(dense) is None
    assert ds.dense_scan_reject_reason(dense, 4) is None
    assert tinf._kernel_route(dense, "cuda", 4) is True
    assert tinf.fast_path_report(dense, 4, device="cuda") == (
        "cuda-dense-scan (hand-written CUDA kernels K6a/K6b); float64 "
        "instantiation")
    assert "CPU tensors take the plain path" in tinf.fast_path_report(
        dense, 4, device="cpu")
    stacked = mt.stack([dense, dense])
    for dev in ("cuda", "cpu"):
        assert tinf.fast_path_report(stacked, 2, device=dev).startswith(
            "plain torch per-graph scan (stacked 'dense' graphs")
    ct = big64
    assert tinf._kernel_route(ct, "cuda", 8) is True
    assert tinf.fast_path_report(ct, 8, device="cuda") == (
        "cuda-block-scan (hand-written CUDA kernels K2-K4); float64 "
        "instantiation")
    assert tinf._unported_on_card(ct) is None
    assert bs._tier_dtype(ct) == F64 and bs._prec(F64) == 2
    # every value of the working set at 8 bytes: more than the float32 one
    c32 = compile_port(*port_lm_graph(128)[:3], strategy="block")
    assert (bs._working_set_bytes(ct, 128, 700, 64)
            > 1.9 * bs._working_set_bytes(c32, 128, 700, 64))
    for saved in (None, 17):
        assert vs.vit_scan_reject_reason(ct, 8, saved=saved) is None
    assert tvit._unported_decode(ct) is None
    assert vs._vit_dtype(ct) == F64 and vs._vit_dtype(c32) == torch.float32


def test_float32_lhs_on_a_float64_graph_raises():
    fsm, spdf, P, _ = port_lm_graph(8)
    ct = compile_port(fsm, spdf, P, strategy="block", dtype=F64)
    lhs = torch.zeros((2, 5, P), dtype=torch.float32)
    for fn in (mt.pdfposteriors, mt.forward, mt.viterbi):
        with pytest.raises(ValueError, match="torch.float32.*float64"):
            fn(ct, lhs)


def test_bf16_with_float64_is_the_remainder():
    """The one mix of item 9 left out: the compile and a carried-across
    JAX compile both raise and name it."""
    (fj, sj), (ft, st), P, _ = _pair("dense")
    with pytest.raises(NotImplementedError,
                       match="'bf16' with dtype float64.*item 9"):
        compile_port(ft, st, P, precision="bf16", dtype=F64)
    cj = _compile_jax64(fj, sj, P, strategy="dense", precision="bf16")
    with pytest.raises(NotImplementedError,
                       match="'bf16' with dtype float64.*item 9"):
        mt.compiled_from_numpy(*jax_fields(cj), device="cpu")


def test_banded_twins_in_float64(lfmmi):
    """K5a/K5b's float64 instantiation as the admission and the twins see
    it: a float64 stack is admitted, its shared memory counts 8-byte
    inputs, and the twins (the CPU route of the wrappers) keep float64
    from the emissions to the posteriors, equal to the plain stacked
    scan; no kernel launches on the CPU."""
    _, (num_t, _), _, _, P, lhs, lens = lfmmi
    G, Sp = 3, num_t.padded_states
    assert bsc.banded_scan_reject_reason(num_t, G) is None
    assert bsc.instantiations(num_t).endswith(", float64)")
    for wide in (False, True):
        D = bsc._WDEPTH if wide else bsc._DEPTH
        w1, w2 = (bsc._variant_words(Sp, 2, wide, tw) for tw in (1, 2))
        assert (w2[0] - w1[0], w2[1] - w1[1]) == (D * Sp + D, D * Sp)
    assert bsc._smem_words(80, 2, 2) == (3408, 6384)
    x = torch.from_numpy(lhs)
    ln = torch.from_numpy(lens)
    bsc.reset_launch_counts()
    posts, vfin, shift, ksum = bsc.banded_fused_fb(num_t, x, ln, True)
    assert not any(bsc.LAUNCHES.values()) and not any(
        bsc.LAUNCHES_F64.values())
    assert posts.dtype == vfin.dtype == F64
    z = tinf._combine_shift(tinf._log_final(vfin), ksum, shift)
    pp, zp = tinf._fb_prob_banded_stacked(num_t, x, ln, 13, True)
    np.testing.assert_allclose(z.numpy(), zp.numpy(), rtol=1e-12, atol=0)
    pk = posts.permute(2, 0, 1)[:, :lhs.shape[1], :P]
    assert float((pk - pp).abs().max()) <= 1e-12


def _cliff_graph():
    """Two states and the phony one: 0 -> 0, 0 -> 1, 1 -> 1, only state 1
    ends; state s emits pdf s.  Returns (fsm, spdf, P)."""
    arcs = [((0, 0), np.log(0.5)), ((0, 1), np.log(0.5)),
            ((1, 1), np.log(0.5))]
    fsm = mt.fsm.FSM.from_pairs([(0, 0.0)], arcs, [(1, np.log(0.5))],
                                [mt.labels.Label(0), mt.labels.Label(1)],
                                mt.semiring.LOG)
    return fsm, np.array([0, 1, 2], dtype=np.int32), 2


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_final_states_far_below_the_best_keep_their_log(strategy):
    """At the last frame the only state that can end emits 100 nats below
    the frame's best, ~e^-100 of it: logZ and the posteriors still hold
    the float64 oracle (the frame past the end, where only the phony state
    emits, rescales the final value into [1, 2) before its log)."""
    fsm, spdf, P = _cliff_graph()
    n = 6
    lhs = np.zeros((2, n, P))
    lhs[:, :, 1] = -3.0
    lhs[:, -1, 1] = -100.0  # the last frame of the first sequence ...
    lhs[1, 3, 1] = -100.0  # ... and of the second, of length 4
    lens = np.array([n, 4], dtype=np.int32)
    ct = compile_port(fsm, spdf, P, strategy=strategy, dtype=F64)
    posts, z = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                                torch.from_numpy(lens))
    zo, po = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    assert (zo < -95).all()
    np.testing.assert_allclose(z.numpy(), zo, rtol=0, atol=TOL_ORACLE)
    assert np.abs(posts.numpy() - po).max() <= TOL_ORACLE


def test_log_final_clamps_by_the_dtype_computed_in():
    """A float64 final value below 1e-38 keeps its log; a float32 one is
    clamped at 1e-38 as the JAX package clamps it, also where the float32
    CUDA routes combine logZ in float64."""
    v = torch.tensor([1e-60, 0.5, 0.0], dtype=F64)
    got = tinf._log_final(v).numpy()
    assert got[0] == np.log(1e-60) and got[1] == np.log(0.5)
    assert got[2] == -np.inf
    v32 = torch.tensor([1e-40, 0.0], dtype=torch.float32)
    assert tinf._log_final(v32)[0].item() == pytest.approx(np.log(1e-38))
    z = tinf._combine_f64(v32, torch.zeros(2), torch.zeros(2), F64)
    assert z[0].item() == pytest.approx(np.log(1e-38), abs=1e-12)
    assert z[1].item() == -np.inf


@pytest.fixture(scope="module")
def dense64():
    """The V=8 graph compiled 'dense' in float64 (JAX and port)."""
    (fj, sj), (ft, st), P, _ = _pair("dense")
    return (_compile_jax64(fj, sj, P, strategy="dense"),
            compile_port(ft, st, P, strategy="dense", dtype=F64), (ft, st), P)


def test_dense_kernel_operators_in_float64(dense64):
    """``kernel_operator`` and ``trop_operator`` of a float64 'dense' graph
    are float64 (their plans' tiles too) and equal to the operator the
    plain decode route builds (``viterbi._sweeps``, plain branch); the
    plans judge the tiles in float64 and rebuild the operator exactly."""
    _, ct, _, _ = dense64
    kop, top = ds.kernel_operator(ct), ds.trop_operator(ct)
    plain = torch.exp(ct.dense_fwd_max)[:, None] * ct.dense_fwd_exp
    assert top is kop
    for t in (kop.alpha0, kop.wf, kop.wb, kop.pf.tiles, kop.pb.tiles):
        assert t.dtype == F64
    assert torch.equal(kop.wf, plain)
    assert torch.equal(kop.wb, torch.exp(ct.dense_bwd_max)[:, None]
                       * ct.dense_bwd_exp)
    for w, pl in ((kop.wf, kop.pf), (kop.wb, kop.pb)):
        n = kop.Sp // 32
        rebuilt = torch.zeros((n, n, 32, 32), dtype=F64)
        rt = torch.repeat_interleave(torch.arange(n),
                                     torch.diff(pl.row_ptr.long()))
        rebuilt[rt, pl.tile_k.long()] = pl.tiles.reshape(-1, 32, 32)
        assert torch.equal(rebuilt.transpose(1, 2).reshape(w.shape), w)


def test_tile_plan_shared_memory_at_8_bytes(dense64):
    """``smem_bytes`` counts a float64 tile (32 rows of 36 values) and a
    32 x 128 state stage at 8 bytes a value: twice the float32 plan's of
    the same operator, and as csrc/dense_scan.cu's Layout::bytes counts
    them (resident: the largest range's tiles and two stages; streaming:
    two stages of a state block and a tile)."""
    _, ct, _, _ = dense64
    w = ds.kernel_operator(ct).wf
    for G in (4, 264):
        p64, p32 = ds.tile_plan(w, G), ds.tile_plan(w.float(), G)
        assert p64.max_tiles == p32.max_tiles
        r64, s64 = ds.smem_bytes(p64)
        assert r64 == p64.max_tiles * 32 * 36 * 8 + 2 * 32 * 128 * 8
        assert s64 == 2 * (32 * 128 * 8 + 32 * 36 * 8)
        assert (r64, s64) == tuple(2 * x for x in ds.smem_bytes(p32))
    p16 = ds.tile_plan(w.to(torch.bfloat16), 4)
    assert ds.smem_bytes(p16)[1] == 2 * (2048 + 8704) + 16896


def test_dense_twins_in_float64_match_the_plain_scan(dense64):
    """K6a/K6b's float64 twins (``dense_fused_fb`` on CPU tensors, no
    launch) against the float64 plain scan (1e-12) and the f64 oracle."""
    _, ct, (fsm, spdf), P = dense64
    lhs, lens = _inputs(P, n=12, lens=[12, 7, 1], seed=44)
    x, ln = torch.from_numpy(lhs), torch.from_numpy(lens)
    ext, msh = prepare_emissions(x, ln, P, F64)
    ds.reset_launch_counts()
    posts, vfin, shift, ksum = ds.dense_fused_fb(ct, ext, msh, True)
    assert posts.dtype == F64 and not any(ds.LAUNCHES_F64.values())
    zk = tinf._combine_shift(tinf._log_final(vfin), ksum, shift).numpy()
    pp, zp = tinf._fb_prob(ct, x, ln, 13, True)
    fin = np.isfinite(zp.numpy())
    assert (np.isfinite(zk) == fin).all() and not fin[2]
    np.testing.assert_allclose(zk[fin], zp.numpy()[fin], rtol=1e-12, atol=0)
    pk = posts.permute(2, 0, 1)[:, :12, :P].numpy()
    assert np.abs(pk - pp.numpy()).max() <= 1e-12
    zo, po = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
    assert np.abs(zk[fin] - zo[fin]).max() <= TOL_ORACLE


def test_rec_walk_twin_in_a_chunked_float64_dense_decode(dense64):
    """W2's twin in float64 (its tables float64) inside the chunked
    float64 dense decode (K6t's twin, chunks of 7 frames) against the JAX
    package's float64 decode: the states equal; the scores within the
    float64 contract."""
    cj, ct, _, P = dense64
    wt = vs.rec_walk_tables(ct)
    assert wt.w.dtype == wt.omega.dtype == F64
    lhs, lens = _inputs(P, n=30, lens=[30, 19, 1], seed=45)
    x, ln = torch.from_numpy(lhs), torch.from_numpy(lens)
    calls = []
    real = vs.rec_walk_plain

    def spy(wt_, states, scales, *rest):
        calls.append(states.dtype)
        return real(wt_, states, scales, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vs, "rec_walk_plain", spy)
        states, score = tvit._viterbi_recompute(ct, x, ln, chunk_size=7)
    assert calls and set(calls) == {F64} and len(calls) == -(-31 // 7)
    sj_, zj = _jax64(jvit.viterbi, cj, lhs, lens)
    fin = np.isfinite(zj)
    z = score.numpy()
    assert (np.isfinite(z) == fin).all() and not fin[2]
    assert np.abs(z[fin] - zj[fin]).max() <= TOL_ORACLE
    np.testing.assert_array_equal(states.numpy()[fin], sj_[fin])
