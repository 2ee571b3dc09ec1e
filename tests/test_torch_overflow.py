"""The capped/overflow layout of a separate-state backoff LM ∘ HMM graph in
the port, against the JAX package on the CPU:

* ``compile_fsm`` field by field, the overflow-family weights and their
  descriptors included, on small separate graphs with forced caps, the
  shape-fuzz pair of ``test_backoff_workload.py``, the V=128 graph with the
  default cap and the 2M-arc trigram graph capped at 64 (two tiers: both
  packages' admissions name the same first predicate);
* ``block_matvec`` with overflow families, both directions;
* the plain scan (``pdfposteriors``) against the JAX XLA block path and
  the f64 oracle, ragged lengths with 1;
* the K2-K4 plain twins against the JAX fused kernel (Pallas interpret
  mode) at V=128, and the plans;
* the LF-MMI step with this denominator, the port-side admission
  predicates, and a Viterbi decode against the JAX package's (the decode
  itself: tests/test_torch_vit_overflow.py).

Each package builds its graphs with its own host layer; inputs are made
from numpy seeds.  The CUDA kernels are held against these twins on the
card by ``chip_smoke.py`` (phases 18-21)."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu.ops import blocked as jbl
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import (assert_same_compiled, compile_port, inputs,
                         lm_graph, numerators, port_lm_graph)

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

# (graph kwargs of make_backoff_lm_hmm_graph, ov_cap); None: the default
SMALL = {
    "V8": (dict(V=8, hmm_states=3, keep=0.3), 8),
    "V16": (dict(V=16, hmm_states=3, keep=0.3), 16),
    "fuzz-K5": (dict(V=8, hmm_states=5, keep=0.2, seed=3), 8),
    "fuzz-cap4": (dict(V=8, hmm_states=3, keep=0.3, seed=3), 4),
    "V128": (dict(V=128, keep=0.1), None),
}


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(JAX graph, JAX compile, port graph, port compile) of one case."""
    kw, cap = SMALL[name]
    gj = make_backoff_lm_hmm_graph(layout="separate", **kw)
    gt = mt.workloads.make_backoff_lm_hmm_graph(layout="separate", **kw)
    cj = inf.compile_fsm(*gj[:3], strategy="block", ov_cap=cap)
    ct = compile_port(*gt[:3], strategy="block", ov_cap=cap)
    return gj, cj, gt, ct


def _env(mp, *names):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
        mp.delenv(k, raising=False)
    for name in names:
        mp.setenv(name, "1")


@pytest.mark.parametrize("name", list(SMALL))
def test_compile_matches_jax(name):
    _, cj, _, ct = graphs(name)
    assert cj.ov_layout and not cj.pdf_group
    assert ct.block_fwd.ov_w and ct.block_bwd.ov_w
    assert_same_compiled(cj, ct)
    assert (bs.block_scan_reject_reason(ct, 8)
            == pb.block_scan_reject_reason(cj, 8))


def test_default_cap_layout_at_v128():
    """The V=128 graph under the default arguments: auto cap 128, three
    overflow groups, one 128x128x128 tier per direction, and the kernels
    accept it on the card."""
    _, cj, _, ct = graphs("V128")
    assert ct.strategy == "block" and ct.ov_layout == (128, 3)
    assert ct.padded_states == 49664 and ct.final_state == 49536
    assert ct.block_fwd_offsets[3] == (
        ("in", 49152, "col", 49408, 0, 1), ("in", 49152, "win", 256, 384, 128),
        ("out", 49408, "col", 0, 384, 128))
    assert ct.block_bwd_offsets[3] == (
        ("in", 49408, "col", 0, 384, 129), ("out", 49152, "win", 256, 384, 128))
    assert bs.block_scan_reject_reason(ct, 128) is None
    assert pb.block_scan_reject_reason(cj, 128) is None
    assert tinf._kernel_route(ct, "cuda", 128) is True
    assert tinf.fast_path_report(ct, 128, device="cuda").startswith(
        "cuda-block-scan")


def test_trigram_graph_capped_at_64_names_the_jax_predicate():
    """The 2M-arc graph with a forced cap of 64: 384 overflow groups, 190
    forward families, two tiers; both packages refuse it with the same
    first predicate."""
    fj, sj, P, _ = lm_graph(128)
    cj = inf.compile_fsm(fj, sj, P, strategy="block", ov_cap=64)
    ct = compile_port(*port_lm_graph(128)[:3], strategy="block", ov_cap=64)
    assert ct.ov_layout == (64, 384) and len(ct.block_fwd.ov_w) == 190
    assert_same_compiled(cj, ct)
    reason = pb.block_scan_reject_reason(cj, 8)
    assert reason == "2 tiers (kernel supports exactly 1)"
    assert bs.block_scan_reject_reason(ct, 8) == reason


@pytest.mark.parametrize("name", ["V8", "fuzz-cap4", "V128"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_block_matvec_with_families_matches_jax(name, direction):
    _, cj, _, ct = graphs(name)
    op_j, meta_j = getattr(cj, f"block_{direction}"), getattr(
        cj, f"block_{direction}_offsets")
    op_t, meta_t = getattr(ct, f"block_{direction}"), getattr(
        ct, f"block_{direction}_offsets")
    rng = np.random.default_rng(len(name))
    x = rng.uniform(size=(cj.padded_states, 4)).astype(np.float32)
    yj = np.asarray(jbl.block_matvec(op_j, meta_j, jnp.asarray(x),
                                     jax.lax.Precision.HIGHEST))
    yt = tbl.block_matvec(op_t, meta_t, torch.from_numpy(x)).numpy()
    assert (yj > 0).any()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    # the families alone, as the kernels' per-row term lists
    dst, src, w = bs._family_terms(op_t, meta_t)
    xt = torch.from_numpy(x)
    fam = torch.zeros_like(xt).index_add_(
        0, torch.from_numpy(dst), torch.from_numpy(w)[:, None] * xt[src])
    no_fam = tbl.block_matvec(op_t, meta_t[:3] + ((),), xt)
    np.testing.assert_allclose((no_fam + fam).numpy(), yt, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["V8", "V16", "fuzz-K5"])
def test_plain_scan_matches_jax_xla_and_oracle(name, monkeypatch):
    gj, cj, gt, ct = graphs(name)
    P = ct.num_pdfs
    lhs, lens = inputs(4, 20, P, seed=5, lens=[20, 13, 7, 1])
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens), chunk_size=6)
    pt, zt = pt.numpy(), zt.numpy()
    _env(monkeypatch, "MMTPU_NO_PALLAS")
    pj, zj = inf.pdfposteriors(cj, jnp.asarray(lhs), jnp.asarray(lens),
                               chunk_size=6)
    zj = np.asarray(zj)
    fin = np.isfinite(zj)
    assert fin[:3].all() and (np.isfinite(zt) == fin).all()
    np.testing.assert_allclose(zt[fin], zj[fin], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-5, rtol=0)
    rz, rp = mt.oracle.host_oracle(*gt[:3], lhs.astype(np.float64), lens)
    np.testing.assert_allclose(zt[fin], rz[fin], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pt, rp, atol=1e-4, rtol=0)
    for b, n in enumerate(lens):
        assert (pt[b, n:] == 0).all()


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX fused Pallas kernel, port plain twins) at V=128 on one ragged,
    cliffed input with an infeasible L=1 sequence and chunk 2."""
    _, cj, _, ct = graphs("V128")
    P = ct.num_pdfs
    lhs, lens = inputs(8, 5, P, seed=11, lens=[5, 4, 5, 1, 3, 5, 2, 4],
                       cliffs=True)
    ext_j, msh_j = ps.prepare_emissions(jnp.asarray(lhs), jnp.asarray(lens),
                                        P)
    posts_j, vfin, shift, ksum = pb.block_fused_fb(cj, ext_j, msh_j, True,
                                                   chunk=2)
    v = np.asarray(vfin)
    zj = np.asarray(inf._combine_shift(
        jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), -jnp.inf), ksum,
        shift))
    ext_t, msh_t = prepare_emissions(torch.from_numpy(lhs),
                                     torch.from_numpy(lens), P)
    bs.reset_launch_counts()
    posts_t, vt, st, kt = bs.block_fused_fb(ct, ext_t, msh_t, True, chunk=2)
    launches = dict(bs.LAUNCHES)
    zt = tinf._combine_shift(tinf._log_final(vt), kt, st).numpy()
    return (np.asarray(posts_j), zj), (posts_t.numpy(), zt), launches


def test_plain_twins_match_fused_pallas(fused_pair):
    (pj, zj), (pt, zt), launches = fused_pair
    fin = np.isfinite(zj)
    assert not fin[3] and fin.sum() >= 5  # L=1 is infeasible: -inf
    assert (np.isfinite(zt) == fin).all()
    np.testing.assert_allclose(zt[fin], zj[fin], atol=1e-5, rtol=0)
    assert pt.shape == pj.shape == (6, 385, 8)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    assert launches == {"block_fwd": 0, "block_recompute": 0,
                        "block_bwd": 0}


def test_plans_and_kernel_tables():
    """The port's plan is JAX's ``_full_plan``; every row's pdf, each pdf's
    overflow rows and the per-row family lists follow the layout."""
    _, cj, _, ct = graphs("V128")
    (W, R, pf, pbk), reason = bs._full_plan_explain(ct)
    assert reason is None and (W, R, pf, pbk) == pb._full_plan(cj)
    kop = bs.kernel_operator(ct)
    spdf = ct.state_pdf.numpy()
    row_pdf = kop.row_pdf.numpy()
    assert (kop.ov_lo, kop.ov_hi, kop.cmax) == (49152, 49536, 128)
    assert (row_pdf[:49152] == np.arange(49152) // 128).all()
    assert (row_pdf[49152:49536] == spdf[49152:49536]).all()
    assert (row_pdf[49536:] == ct.num_pdfs).all()
    ptr, lanes = kop.ovp_ptr.numpy(), kop.ovp_lane.numpy()
    assert ptr[-1] == 384 and sorted(lanes) == list(range(384))
    for p in range(kop.P1):
        ls = lanes[ptr[p]:ptr[p + 1]]
        assert (np.diff(ls) > 0).all() and (row_pdf[49152 + ls] == p).all()
    for kd in (kop.fwd, kop.bwd):
        fp = kd.fam_ptr.numpy()
        assert fp[-1] == kd.fam_dst.numel() == 32767
        assert (np.repeat(np.arange(ct.padded_states), np.diff(fp))
                == kd.fam_dst.numpy()).all()
    # the heavy rows (128 'in' terms or more) take a tile each
    for kd in (kop.fwd, kop.bwd):
        heavy = kd.heavy_rows.numpy()
        n_terms = np.diff(kd.fam_ptr.numpy())
        assert len(heavy) == 128 and (n_terms[heavy] >= 128).all()
        assert n_terms.max(initial=0) <= 129
        assert not np.isin(heavy, kd.band_rows.numpy()).any()
        rows = np.concatenate([kd.band_rows.numpy(), heavy,
                               kd.dst_rows.numpy().ravel()])
        assert np.array_equal(np.sort(rows), np.arange(ct.padded_states))
    assert bs._posterior_tiles(kop) == 2
    meta = bs._imeta(kop, kop.fwd)
    assert meta[bs._N_TILES] == 256 + 518 + 128 and meta[-2:].tolist() == [
        32767, 128]


def test_port_side_predicates():
    """After JAX's predicates, the port refuses a family whose group lies
    outside the overflow region (JAX's plan checks alignment only) or whose
    window leaves the grid (JAX's plan implies it; checked on its own)."""
    _, _, _, ct = graphs("V128")
    meta = ct.block_fwd_offsets
    fams = list(meta[3])
    fams[0] = ("in", 0) + fams[0][2:]
    bad = dataclasses.replace(ct, block_fwd_offsets=meta[:3] + (tuple(fams),),
                              _cache={})
    assert bs._full_plan_explain(bad)[1] is None
    assert bs.block_scan_reject_reason(bad, 8) == (
        "forward operator: ov group base 0 outside the overflow region "
        "[49152, 49536)")
    fams = list(meta[3])
    fams[1] = fams[1][:3] + (49152,) + fams[1][4:]
    bad = dataclasses.replace(ct, block_fwd_offsets=meta[:3] + (tuple(fams),),
                              _cache={})
    assert bs._kernel_checks(bad, 384, 129) == (
        "forward operator: ov family window outside the grid [0, 49536)")


def test_tier_rows_with_many_family_terms_keep_their_tier_tile():
    """A tier row whose family list is long is not made a heavy row: two
    tiles would then write it.  Moved onto 128 tier rows, the forward 'in'
    window gives each 128 terms; every row still has exactly one tile."""
    _, _, _, ct = graphs("V128")
    op, meta = ct.block_fwd, ct.block_fwd_offsets
    dst = bs._dir_index_maps(op, meta)[3]
    lanes = dst[:, 0]
    assert np.array_equal(lanes, lanes[0] + np.arange(128))
    fams = list(meta[3])
    i = [f[:3] for f in fams].index(("in", 49152, "win"))
    fams[i] = ("in", int(lanes[0])) + fams[i][2:]
    moved = meta[:3] + (tuple(fams),)
    _, _, _, dst, (fdst, _, _), band, heavy = bs._dir_rows(
        op, moved, ct.padded_states)
    assert (np.bincount(fdst, minlength=ct.padded_states)[lanes] >= 16).all()
    assert len(heavy) == 0
    rows = np.concatenate([band, heavy, dst.ravel()])
    assert np.array_equal(np.sort(rows), np.arange(ct.padded_states))


def test_lfmmi_step_with_the_separate_denominator():
    """The training step on the CPU: lhs.grad equals γ_den − γ_num."""
    _, _, _, den = graphs("V128")
    P = den.num_pdfs
    nums = numerators(np.random.default_rng(13), 4, P, [5, 3, 6, 4], lib=mt)
    num = mt.stack([compile_port(f, sp, P, strategy="banded")
                    for f, sp in nums])
    lhs, lens = inputs(4, 8, P, seed=17, lens=[8, 7, 8, 5])
    x = torch.from_numpy(lhs).requires_grad_()
    L = torch.from_numpy(lens)
    loss = mt.lfmmi_loss(num, den, x, L)
    loss.sum().backward()
    pn, zn = mt.pdfposteriors(num, torch.from_numpy(lhs), L)
    pd, zd = mt.pdfposteriors(den, torch.from_numpy(lhs), L)
    assert torch.isfinite(loss).all()
    np.testing.assert_allclose(loss.detach().numpy(), (zd - zn).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), (pd - pn).numpy(), atol=1e-6,
                               rtol=0)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(x.grad[b, :n].sum(dim=1).numpy(), 0.0,
                                   atol=1e-5)


def test_viterbi_names_the_overflow_decode():
    """The overflow-family decode, once refused, now answers as the JAX
    package does: the same states and scores within 1e-5 (the V=8 graph's
    tier writes overflow rows, so both packages name the same predicate
    and take the chunk-recompute route; tests/test_torch_vit_overflow.py
    holds both routes)."""
    _, cj, _, ct = graphs("V8")
    lhs, lens = inputs(2, 6, ct.num_pdfs, seed=3, lens=[6, 4])
    reason = tvit._bp_vit_reject_reason(ct, lhs)
    assert reason == jvit._bp_vit_reject_reason(cj, jnp.asarray(lhs))
    assert reason.startswith("operator not a single affine tier")
    states, score = tvit.viterbi(ct, torch.from_numpy(lhs),
                                 torch.from_numpy(lens))
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        sj, zj = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens))
    np.testing.assert_array_equal(states.numpy(), np.asarray(sj))
    np.testing.assert_allclose(score.numpy(), np.asarray(zj), atol=1e-5,
                               rtol=0)
