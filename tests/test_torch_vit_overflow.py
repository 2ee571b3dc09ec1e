"""The port's Viterbi decode of graphs with overflow families (the capped
layout ``compile_fsm`` gives a separate-state backoff LM ∘ HMM graph)
against the JAX package on the CPU:

* ``_ov_cand_layout`` and ``block_max_arg_supported`` against the JAX
  package's, the walk's decode tables ``ov_dec`` / ``ovout`` against the
  arrays the JAX package builds inside ``_viterbi_scale_bp``;
* ``block_matvec_max_arg(..., ov_span=)`` against the JAX package's:
  values bit-equal, ids equal (random continuous states: no exact tie),
  and on a tie-heavy state the port's rule against a brute-force
  reference of it; K7's family tables (``vit_scan.fam_tables``) and a
  torch emulation of the kernel's family candidate (the max over a row's
  terms, the smallest id among equal ones) equal to the twin's ids;
* ``viterbi`` states equal to the JAX package's and scores within 1e-5:
  the V=128 graph on the compressed-backpointer route (the only size
  whose default cap gives a single tier that writes no overflow row) and,
  with both packages' budgets lowered, on the chunk-recompute route; the
  small graphs, which both packages send to the chunk-recompute route;
  every decoded path within 1e-3 of its float64 weight
  (``oracle.validate_paths``); sequences of infeasible lengths;
* the walk's rule for ids without a source on an overflow row;
* the band-only capped graph of ``tests/test_viterbi.py`` (overflow rows
  fed by bands alone, no families), which the port decodes on the CPU
  through the compressed-backpointer twins;
* the admission: the port's K7 takes the families that the TPU K7
  refuses, and a graph the card kernels refuse raises naming the
  predicate.

Inputs are made from numpy seeds.  The CUDA kernels (K7's and K7n's family
branch, the walk with its tables) are held against these twins on the card
by ``chip_smoke.py`` (phases 34-37)."""
import dataclasses
import functools
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import hostsparse as jhs
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu.ops import blocked as jbl
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import compile_port, inputs

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

TOL = 1e-5  # scores, port vs the JAX package
TOL_PATH = 1e-3  # a decoded path's f64 weight vs its score

# (graph kwargs of make_backoff_lm_hmm_graph, ov_cap); None: the default
GRAPHS = {
    "V8": (dict(V=8, hmm_states=3, keep=0.3), 8),
    "V16": (dict(V=16, hmm_states=3, keep=0.3), 16),
    "fuzz-K5": (dict(V=8, hmm_states=5, keep=0.2, seed=3), 8),
    "fuzz-cap4": (dict(V=8, hmm_states=3, keep=0.3, seed=3), 4),
    "V128": (dict(V=128, keep=0.1), None),
}
SMALL = ["V8", "V16", "fuzz-K5", "fuzz-cap4"]
SINGLE_TIER = ["V8", "fuzz-K5", "fuzz-cap4", "V128"]


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(JAX compile, port graph (fsm, spdf, P), port compile) of a case."""
    kw, cap = GRAPHS[name]
    gj = make_backoff_lm_hmm_graph(layout="separate", **kw)
    gt = mt.workloads.make_backoff_lm_hmm_graph(layout="separate", **kw)
    cj = inf.compile_fsm(*gj[:3], strategy="block", ov_cap=cap)
    ct = compile_port(*gt[:3], strategy="block", ov_cap=cap)
    return cj, gt[:3], ct


def _span(ct):
    span = vs.ov_span(ct)
    assert span is not None
    return span


def _no_env(mp):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS", "MMTPU_VIT_PALLAS",
              "MMTPU_NO_VITBP", "MMTPU_VIT_PACKED"):
        mp.delenv(k, raising=False)


def _jax_viterbi(cj, lhs, lens):
    with pytest.MonkeyPatch.context() as mp:
        _no_env(mp)
        states, score = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens))
        return np.asarray(states), np.asarray(score)


def _assert_same_decode(port, ref):
    (st, zt), (sj, zj) = ((np.asarray(s), np.asarray(z)) for s, z in
                          (port, ref))
    assert st.dtype == sj.dtype == np.int32 and st.shape == sj.shape
    np.testing.assert_array_equal(st, sj)
    fin = np.isfinite(zj)
    assert (np.isfinite(zt) == fin).all()
    np.testing.assert_allclose(zt[fin], zj[fin], atol=TOL, rtol=0)


def _assert_paths(name, lhs, lens, states, score):
    """Every feasible sequence's path weighs its score in float64."""
    fsm, spdf, _ = graphs(name)[1]
    fin = np.isfinite(np.asarray(score))
    gap = mt.oracle.validate_paths(
        fsm, spdf, lhs[fin], lens[fin], np.asarray(states)[fin],
        np.asarray(score)[fin].astype(np.float64), atol=TOL_PATH)
    assert gap < TOL_PATH


# ---------------------------------------------------------------------------
# the candidate layout, the admission and the decode tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_ov_cand_layout_and_support_match_jax(name):
    cj, _, ct = graphs(name)
    ov_lo, nOv, cmax = _span(ct)
    assert (ov_lo, nOv, cmax) == (cj.num_pdfs * cj.ov_layout[0],
                                  cj.ov_layout[1], cj.ov_layout[0])
    meta = ct.block_fwd_offsets
    assert tbl._ov_cand_layout(meta, ov_lo, cmax, ov_lo + nOv * cmax) == \
        jbl._ov_cand_layout(cj.block_fwd_offsets, ov_lo, cmax)
    want = jbl.block_max_arg_supported(cj.block_fwd, cj.block_fwd_offsets,
                                       ov_lo=ov_lo, cmax=cmax)
    got = tbl.block_max_arg_supported(ct.block_fwd, meta, ov_lo, cmax,
                                      ov_lo + nOv * cmax)
    assert got == want, name
    assert want == (name == "V128")
    # without the layout's bounds an operator with families is refused
    assert not tbl.block_max_arg_supported(ct.block_fwd, meta)
    lhs = np.zeros((2, 3, ct.num_pdfs), np.float32)
    assert tvit._bp_vit_reject_reason(ct, lhs) == \
        jvit._bp_vit_reject_reason(cj, jnp.asarray(lhs))


def test_cand_layout_checks_the_in_groups():
    """The JAX package's ``_ov_cand_layout`` ignores ``ov_lo``; the port's
    refuses an 'in' group outside the overflow rows, and the admission
    names it."""
    _, _, ct = graphs("V8")
    ov_lo, nOv, cmax = _span(ct)
    meta = ct.block_fwd_offsets
    with pytest.raises(ValueError, match="outside the overflow rows"):
        tbl._ov_cand_layout(meta, ov_lo + cmax, cmax)
    with pytest.raises(ValueError, match="outside the overflow rows"):
        tbl._ov_cand_layout(meta, ov_lo, cmax, ov_lo)
    _, _, c128 = graphs("V128")
    ov_lo, nOv, cmax = _span(c128)
    reason = tbl.block_max_arg_reason(c128.block_fwd, c128.block_fwd_offsets,
                                      ov_lo + cmax, cmax)
    assert reason.startswith("'in' family group 49152 outside"), reason


def _capture_jax_tables(cj, lhs, lens):
    """The int32 arrays the JAX package's ``_viterbi_scale_bp`` hands to
    ``jnp.asarray`` while it decodes (its ``ov_dec`` and ``ovout_tab``
    among them), captured through a stand-in for its ``jnp``."""
    seen = []

    def asarray(a, *args, **kw):
        if isinstance(a, np.ndarray) and a.dtype == np.int32:
            seen.append(a.copy())
        return jnp.asarray(a, *args, **kw)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.asarray = asarray
    with pytest.MonkeyPatch.context() as mp:
        _no_env(mp)
        mp.setattr(jvit, "jnp", proxy)
        jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens))
    return seen


def test_decode_tables_match_jax():
    cj, _, ct = graphs("V128")
    ov_lo, nOv, cmax = _span(ct)
    lhs, lens = inputs(2, 3, ct.num_pdfs, seed=5, lens=[3, 2])
    seen = _capture_jax_tables(cj, lhs, lens)
    dec = [a for a in seen if a.shape == (nOv * cmax, 256)]
    oo = [a for a in seen if a.shape == (ct.padded_states,)
          and a.min() == -1 and a.max() >= ov_lo]
    assert len(dec) == 1 and len(oo) == 1
    wt = vs.walk_tables(ct)
    assert vs.walk_tables(ct) is wt  # cached
    np.testing.assert_array_equal(wt.ov_dec.numpy(), dec[0])
    np.testing.assert_array_equal(wt.ovout.numpy(), oo[0])
    assert (wt.ov_lo, wt.ov_hi) == (ov_lo, ov_lo + nOv * cmax)
    assert wt.fin == ct.final_state


def test_walk_tables_of_a_uniform_graph_decode_nothing():
    cf = compile_port(*mt.workloads.make_lm_hmm_graph(V=16)[:3],
                      strategy="block")
    wt = vs.walk_tables(cf)
    Sp = cf.padded_states
    assert (wt.ov_lo, wt.ov_hi) == (Sp, Sp)
    assert wt.ov_dec.shape == (1, 256) and (wt.ov_dec == -1).all()
    assert wt.ovout.shape == (Sp,) and (wt.ovout == -1).all()


# ---------------------------------------------------------------------------
# the tropical matvec with family candidates
# ---------------------------------------------------------------------------

def _state(ct, B, seed, levels=None):
    """(Sp, B) float32: random continuous values, or drawn from ``levels``
    (ties); the tail past R·W zero, as the sweep's twin masks it."""
    rng = np.random.default_rng(seed)
    Sp = ct.padded_states
    x = (rng.uniform(0.1, 2.0, size=(Sp, B)) if levels is None
         else rng.choice(levels, size=(Sp, B))).astype(np.float32)
    x[vs._main_region(ct):] = 0.0
    x[rng.random(Sp) < 0.05] = 0.0  # rows without mass
    return x


@pytest.mark.parametrize("name", SINGLE_TIER)
def test_block_matvec_max_arg_with_families_matches_jax(name):
    cj, _, ct = graphs(name)
    span = _span(ct)
    x = _state(ct, 3, seed=7)
    yj, aj = jbl.block_matvec_max_arg(cj.block_fwd, cj.block_fwd_offsets,
                                      jnp.asarray(x), ov_span=span)
    yt, at = tbl.block_matvec_max_arg(ct.block_fwd, ct.block_fwd_offsets,
                                      torch.from_numpy(x), ov_span=span)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    with pytest.raises(ValueError, match="ov_span"):
        tbl.block_matvec_max_arg(ct.block_fwd, ct.block_fwd_offsets,
                                 torch.from_numpy(x))


def _rule_reference(ct, x):
    """The port's tie rule by brute force, from the operator's parts: per
    destination the candidates in the order bands (offset order), tier
    (position order), families (descriptor order, index order), each with
    its id in the final encoding; the first one attaining the max wins, 255
    where the max is 0."""
    op, meta = ct.block_fwd, ct.block_fwd_offsets
    ov_lo, nOv, cmax = _span(ct)
    Sp, B = x.shape
    _, csize = tbl._ov_cand_layout(meta, ov_lo, cmax)
    sidx, didx, W = (t.numpy() for t in op.tiers[0])
    Sm, nO = sidx.shape[1], len(meta[0])
    cands = [[] for _ in range(Sp)]  # (value (B,), id)
    for j in range(Sp):
        base = csize.get(ov_lo + (j - ov_lo) // cmax * cmax, 0) \
            if ov_lo <= j < ov_lo + nOv * cmax else Sm
        for oi, off in enumerate(meta[0]):
            src = (j - off) % Sp  # the roll's wrap meets zero weights
            cands[j].append((op.band_w[oi, j].item() * x[src], base + oi))
    for k in range(sidx.shape[0]):
        for d in range(didx.shape[1]):
            for s in range(Sm):
                cands[didx[k, d]].append((W[k, s, d] * x[sidx[k, s]], s))
    cum = {}
    for desc, Wf in zip(meta[3], op.ov_w):
        kind, g0, form, fbase, stride, D = desc
        Wn = Wf.numpy()
        if kind == "in":
            first = cum.get(g0, 0)
            n = D if form == "col" else cmax
            cum[g0] = first + n
            for l in range(cmax):
                for r in range(n):
                    src, w = ((fbase + r * stride + l, Wn[r, l]) if form == "col"
                              else (fbase + l * stride + r, Wn[l, r]))
                    cands[g0 + l].append((w * x[src], first + r))
        else:
            grid = tbl.family_grid(desc, cmax)
            for idx in np.ndindex(grid.shape):
                lane = idx[1] if form == "col" else idx[0]
                cands[grid[idx]].append((Wn[idx] * x[g0 + lane], Sm + nO))
    want = np.full((Sp, B), 255, np.int32)
    for j in range(Sp):
        if not cands[j]:
            continue
        vals = np.stack([v for v, _ in cands[j]])  # (n, B)
        ids = np.array([i for _, i in cands[j]])
        top = vals.max(axis=0)
        first = np.argmax(vals == top[None], axis=0)
        want[j] = np.where(top > 0, ids[first], 255)
    return want


@pytest.mark.parametrize("name", ["V8", "fuzz-cap4"])
def test_block_matvec_max_arg_tie_rule(name):
    """On a state of a few levels (exact ties everywhere) the ids follow
    the port's stated rule: bands in offset order with a strict >, the
    tier's smallest position merged with a strict >, the families in
    descriptor order each merged with a strict >, the smallest index
    within a family."""
    _, _, ct = graphs(name)
    x = _state(ct, 2, seed=3, levels=np.float32([0.0, 0.5, 1.0]))
    _, at = tbl.block_matvec_max_arg(ct.block_fwd, ct.block_fwd_offsets,
                                     torch.from_numpy(x),
                                     ov_span=_span(ct))
    np.testing.assert_array_equal(at.numpy(), _rule_reference(ct, x))


@pytest.fixture(scope="module")
def v128():
    return graphs("V128")


def test_k7_family_tables(v128):
    """Each forward family term's candidate id in K7's table decodes back
    to the term's source through the walk's tables; the groups' band id
    bases are their C_g; the queue takes the heavy rows first."""
    _, _, ct = v128
    ov_lo, nOv, cmax = _span(ct)
    kop = bs.kernel_operator(ct, torch.float32)
    ft = vs.fam_tables(ct, kop)
    assert vs.fam_tables(ct, kop) is ft  # cached
    kd = kop.fwd
    dst, src = kd.fam_dst.numpy(), kd.fam_src.numpy().astype(np.int64)
    cid = ft.cid.numpy().astype(np.int64)
    assert cid.shape == dst.shape == (32767,)
    wt = vs.walk_tables(ct)
    ov = dst >= ov_lo
    Sm, nO = kd.W.shape[1], len(kd.offsets)
    assert (cid[~ov] == Sm + nO).all()
    np.testing.assert_array_equal(wt.ovout.numpy()[dst[~ov]], src[~ov])
    np.testing.assert_array_equal(
        wt.ov_dec.numpy()[dst[ov] - ov_lo, cid[ov]], src[ov])
    _, csize = tbl._ov_cand_layout(ct.block_fwd_offsets, ov_lo, cmax)
    assert ft.cbase.tolist() == [csize.get(ov_lo + g * cmax, 0)
                                 for g in range(nOv)] == [129, 0, 0]
    assert bs._row_pdf(ct)[kop.fin] == kop.P1 - 1  # the kernel's phony pdf
    assert kd.heavy_rows.numel() == 128
    pl = vs.vit_plan(kop, 128)
    items = pl.queue[:, 0].numpy() // pl.ncb
    nh, nt = 128, kd.W.shape[0] * -(-kd.W.shape[2] // 64)
    np.testing.assert_array_equal(items[:nh * pl.ncb],
                                  np.repeat(np.arange(nh), pl.ncb))
    assert (items[nh * pl.ncb:(nh + nt) * pl.ncb] < nh + nt).all()
    assert vs._is_fam(kop)


def test_recompute_walk_takes_every_in_arc_of_the_heavy_rows(v128):
    """W2 reads the dst-sorted in-arc lists of the graph's edges, family
    arcs included, up to Dmax of them per state: Dmax covers the heavy
    rows' in-arcs (an 'in' window, an 'in' column and the bands)."""
    _, _, ct = v128
    wt = vs.rec_walk_tables(ct)
    heavy = bs.kernel_operator(ct, torch.float32).fwd.heavy_rows.long()
    indeg = (wt.rowptr[1:] - wt.rowptr[:-1]).long()
    assert int(indeg[heavy].min()) >= 129
    assert wt.dmax >= int(indeg[heavy].max())


def test_kernel_family_rule_gives_the_twins_ids(v128):
    """A torch emulation of K7's family branch on a tie-heavy state: bands
    and tier (the twin without its families, the overflow rows' band ids
    from their group's base), then per row the max over its terms from
    K2's per-row lists and the smallest id in K7's table among the terms
    equal to it, merged with a strict >; equal to the twin's ids."""
    _, _, ct = v128
    kop = bs.kernel_operator(ct, torch.float32)
    ft = vs.fam_tables(ct, kop)
    ov_lo, nOv, cmax = _span(ct)
    x = torch.from_numpy(_state(ct, 4, seed=9,
                                levels=np.float32([0.0, 0.25, 0.5, 1.0])))
    op, meta = ct.block_fwd, ct.block_fwd_offsets
    y, cand = tbl.block_matvec_max_arg(op, meta, x, ov_span=(ov_lo, nOv, cmax))
    y0, c0 = tbl.block_matvec_max_arg(op._replace(ov_w=()), meta[:3] + ((),),
                                      x)
    Sm, nO = kop.fwd.W.shape[1], len(meta[0])
    rows = torch.arange(ov_lo, ov_lo + nOv * cmax)
    band = (c0[rows] >= Sm) & (c0[rows] < Sm + nO)
    base = ft.cbase.long()[(rows - ov_lo) // cmax][:, None]
    c0[rows] = torch.where(band, c0[rows] - Sm + base.int(), c0[rows])
    kd = kop.fwd
    v = kd.fam_w[:, None] * x[kd.fam_src.long()]  # (nfam, B)
    dst = kd.fam_dst
    fmax = torch.full_like(x, -1.0).scatter_reduce_(
        0, dst[:, None].expand_as(v), v, "amax")
    cid = ft.cid.long()[:, None].expand_as(v)
    eq = v == fmax[dst]
    fid = torch.full(x.shape, 256, dtype=torch.long).scatter_reduce_(
        0, dst[:, None].expand_as(v), torch.where(eq, cid, 256), "amin")
    sel = fmax > y0
    want = torch.where(sel, fid.int(), c0)
    assert torch.equal(torch.where(sel, fmax, y0), y)
    assert torch.equal(want, cand)
    assert int(sel.sum()) > 100  # the families win somewhere


# ---------------------------------------------------------------------------
# the decode against the JAX package
# ---------------------------------------------------------------------------

def test_v128_decode_matches_jax(v128):
    """The compressed-backpointer route of both packages: lengths 1 and 2
    (infeasible: shorter than the 3-state HMMs) and N mixed, ±30-nat
    emission cliffs."""
    cj, _, ct = v128
    lhs, lens = inputs(4, 9, ct.num_pdfs, seed=3, lens=[9, 1, 2, 6],
                       cliffs=True)
    assert tvit._bp_vit_reject_reason(ct, lhs) is None
    assert jvit._bp_vit_reject_reason(cj, jnp.asarray(lhs)) is None
    port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens))
    assert np.isneginf(port[1].numpy()[[1, 2]]).all()
    _assert_paths("V128", lhs, lens, *port)


def test_v128_recompute_decode_matches_jax(v128, monkeypatch):
    """Both packages' id budgets lowered below this call's id stream: both
    take the chunk-recompute route (here in chunks of 4 frames, so the
    port's K7n twin runs its checkpoints and restarts), and it agrees with
    the compressed-backpointer route's scores."""
    cj, _, ct = v128
    lhs, lens = inputs(3, 9, ct.num_pdfs, seed=4, lens=[9, 4, 7])
    need = 10 * ct.padded_states * 3
    for mod in (jvit, tvit):
        monkeypatch.setattr(mod, "_BP_MEM_BYTES", need - 1)
    reason = tvit._bp_vit_reject_reason(ct, lhs)
    assert "budget" in reason
    assert reason.split(" (")[0] == jvit._bp_vit_reject_reason(
        cj, jnp.asarray(lhs)).split(" (")[0]
    port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens),
                      chunk_size=4)
    states, score = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens),
                                 chunk_size=4)
    _assert_same_decode(port, (np.asarray(states), np.asarray(score)))
    _assert_paths("V128", lhs, lens, *port)
    bp = tvit._viterbi_scale_bp(ct, torch.from_numpy(lhs),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(port[1].numpy(), bp[1].numpy(), atol=TOL)


@pytest.mark.parametrize("name", SMALL)
def test_small_decodes_match_jax(name):
    """The small graphs' tiers write overflow rows (or they have two), so
    both packages send them to the chunk-recompute route."""
    cj, _, ct = graphs(name)
    P = ct.num_pdfs
    lhs, lens = inputs(4, 12, P, seed=3, lens=[12, 1, 7, 10],
                       cliffs=P % 3 == 0)  # the cliffs take 3-state HMMs
    assert "not a single affine tier" in tvit._bp_vit_reject_reason(ct, lhs)
    port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens))
    _assert_paths(name, lhs, lens, *port)


def test_walk_sends_ids_without_a_source_to_the_phony_state(v128):
    """On an overflow row an id past C_g + nO (a stray Sm + nO on a group
    without in-families among them) and 255 decode to the phony state; a
    window family's id and a band id decode to their sources; on a core
    row Sm + nO decodes through the out-family table.  (On the first group,
    C_g = 129, Sm + nO = 130 is that group's own band id: the admission
    keeps out-families off the overflow rows, so no out-family id lands
    there.)"""
    _, _, ct = v128
    wt = vs.walk_tables(ct)
    ov_lo, fin, Sm, nO = wt.ov_lo, wt.fin, wt.Sm, wt.nO
    assert (Sm, nO) == (128, 2)
    core = int(torch.nonzero(wt.ovout >= 0)[0])
    g1 = ov_lo + 128  # the second group: C_g = 0, its bands at 0 and 1
    rows = [ov_lo, g1, ov_lo, ov_lo, g1, core]
    ids = [255, Sm + nO, 129 + nO, 1 + 5, 1, Sm + nO]
    B, Nf = len(rows), 3
    bps = torch.full((Nf, wt.ov_hi, B), 255, dtype=torch.uint8)
    bps[1, rows, torch.arange(B)] = torch.tensor(ids, dtype=torch.uint8)
    fins = torch.zeros((Nf, B), dtype=torch.int32)
    fins[2] = torch.tensor(rows, dtype=torch.int32)
    lens = torch.full((B,), 2, dtype=torch.int32)
    states = vs.walk_plain(wt, bps, fins, lens)
    assert states[1].tolist() == rows  # frame 2's ω argmax at t == L
    window = 256 + 5  # lane 0's window position 5
    offset = ct.block_fwd_offsets[0][1]
    assert states[0].tolist() == [fin, fin, fin, window, g1 - offset,
                                  int(wt.ovout[core])]


# ---------------------------------------------------------------------------
# the band-only capped graph (tests/test_viterbi.py's)
# ---------------------------------------------------------------------------

def _band_only(lib):
    """The capped graph of ``test_ov_layout_band_only_overflow_bp_decode``
    built by ``lib``'s host layer: 8 uniform states per pdf and one
    overflow state each, fed only by band arcs."""
    P = 16
    S = P * 8 + P
    rows = list(range(S)) + list(range(S - 1))
    cols = list(range(S)) + list(range(1, S))
    data = [np.log(0.4)] * S + [np.log(0.5)] * (S - 1)
    for i in range(8):
        rows.append(i)
        cols.append(64 + i)
        data.append(np.log(0.3))
    alpha = np.full(S, -np.inf)
    alpha[0] = 0.0
    omega = np.full(S, -np.inf)
    omega[S - 1] = np.log(0.3)
    omega[71] = np.log(0.2)
    spdf = np.array([i // 8 for i in range(P * 8)] + list(range(P)) + [P],
                    dtype=np.int32)
    labels = [lib.labels.Label(int(p)) for p in spdf[:S]]
    hs = jhs if lib is mm else mt.hostsparse
    T = hs.spmat_from_coo(np.array(rows), np.array(cols), np.array(data),
                          (S, S), lib.LOG)
    fsm = (mm.FSM if lib is mm else mt.fsm.FSM).from_parts(
        alpha, T, omega, labels, lib.LOG)
    return fsm, spdf, P


def test_band_only_capped_graph_decodes_on_the_cpu():
    fj, spdf, P = _band_only(mm)
    ft, _, _ = _band_only(mt)
    cj = inf.compile_fsm(fj, spdf, P, strategy="block", ov_cap=8)
    ct = compile_port(ft, spdf, P, strategy="block", ov_cap=8)
    assert ct.ov_layout == (8, 2) and not ct.block_fwd.ov_w
    assert vs.ov_span(ct) is None
    rng = np.random.default_rng(23)
    lhs = rng.normal(size=(3, 160, P)).astype(np.float32)
    lens = np.asarray([160, 150, 144], dtype=np.int32)
    assert tvit._bp_vit_reject_reason(ct, lhs) is None
    assert vs.vit_scan_reject_reason(ct, 3) == \
        "tier stride 1 not a multiple of 128 lanes"
    states, score = mt.viterbi(ct, torch.from_numpy(lhs),
                               torch.from_numpy(lens))
    _, zj = _jax_viterbi(cj, lhs, lens)
    np.testing.assert_allclose(score.numpy(), zj, atol=TOL, rtol=0)
    gap = mt.oracle.validate_paths(ft, spdf, lhs, lens, states.numpy(),
                                   score.numpy().astype(np.float64),
                                   atol=TOL_PATH)
    assert gap < TOL_PATH
    # on the card K7's plan refuses it, naming the predicate (the route
    # reads only the shape and the device of lhs)
    fake = types.SimpleNamespace(shape=lhs.shape, device=torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="K7.*tier stride 1"):
        tvit._viterbi_scale_bp(ct, fake, torch.from_numpy(lens))


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_port_k7_takes_the_families_the_tpu_k7_refuses(v128):
    """The TPU K7 refuses overflow families (``pallas_block.py:1348-1351``);
    the port's K7 is the card kernel of the compressed-backpointer route,
    which takes them, so its admission accepts the graph, K7n's too."""
    cj, _, ct = v128
    assert not pb.vit_scan_supported(cj, 8)
    assert vs.vit_scan_reject_reason(ct, 8) is None
    assert vs.vit_scan_reject_reason(ct, 8, saved=4) is None


def _with_meta(ct, descs):
    """A copy of ``ct`` with other forward family descriptors and a cache
    of its own (the admission caches its answers on the graph)."""
    meta = ct.block_fwd_offsets
    return dataclasses.replace(ct, block_fwd_offsets=meta[:3] + (descs,),
                               _cache={})


def test_family_predicates_are_named(v128):
    """A graph that K7 or K7n would refuse for its families names the
    predicate (the admission runs on a CPU-built graph); the id-free K7n
    skips the predicates on the ids' range only."""
    _, _, ct = v128
    descs = ct.block_fwd_offsets[3]
    # the out-family moved down one grid row: its last row of destinations
    # is the first overflow group
    out = tuple(d if d[0] != "out" else d[:3] + (384,) + d[4:]
                for d in descs)
    bad = _with_meta(ct, out)
    want = "overflow families: an out-family writes an overflow row"
    assert tvit._bp_vit_reject_reason(bad, np.zeros((2, 3, 384))) \
        .startswith("operator not a single affine tier")
    for saved in (None, 4):
        reason = vs._fam_reason(bad, ids=saved is None)
        assert f"overflow families: {reason}" == want
    # two out-families onto one destination
    dup = _with_meta(ct, descs + tuple(d for d in descs if d[0] == "out"))
    assert vs._fam_reason(dup, ids=True) == \
        "a destination takes two out-family candidates"
    # an in-family too wide for the uint8 ids: K7 refuses, K7n does not
    wide = _with_meta(ct, descs + (("in", 49152, "win", 256, 384, 128),))
    assert vs._fam_reason(wide, ids=True).startswith(
        "overflow group 49152: 257 in-family")
    assert vs._fam_reason(wide, ids=False) is None
    assert vs.vit_scan_reject_reason(bad, 8, saved=4) == want
    assert vs.vit_scan_reject_reason(bad, 8) == want
    # the card's recompute route asks K7n's admission and raises (no card
    # is read: the admission checks the card's memory only where one is)
    with pytest.raises(ValueError, match="K7n.*an out-family writes"):
        tvit._sweeps(bad, 8, 41, 41, torch.device("cuda"))
