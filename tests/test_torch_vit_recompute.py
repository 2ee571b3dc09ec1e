"""The port's chunk-recompute Viterbi decode (viterbi.py ``_viterbi_recompute``,
the K6t twin of ops/dense_scan.py, the K7n and W2 twins of ops/vit_scan.py
and the tropical ``block_matvec``) against the JAX package on the CPU:

* ``block_matvec(..., op_kind="max")`` against the JAX package's on the
  V=16 pdf-grouped, the V=32 two-tier and a separate-state (overflow
  family) operator, both directions;
* the decode against the JAX package's ``viterbi``: a 'dense' graph (the
  route of every 'dense' graph), the V=32 'block' graph (two tiers, so JAX
  takes its recompute route by itself), a single-tier 'block' graph with
  the JAX package forced onto the route by ``MMTPU_NO_VITBP`` (the port by
  calling its recompute function) and one past the id budget (both
  packages' budgets lowered), each with ``chunk_size`` None and 7, lengths
  mixed with 1 and N, ±30-nat emission cliffs;
* BASELINE.json config 1 (a left-to-right 5-state HMM, T=100) and the JAX
  package's own ``test_viterbi_scale_exact`` graphs against the float64
  max-plus DP oracle of ``tests/test_viterbi.py``: exact paths;
* the walk twin's rules (ties to the largest in-arc position, the park on
  the phony state, the ω step at L - 1, the frames past the length) and
  the scale applied before the log;
* the K7n twin against K7's (the same final value, ksum and shift), its
  checkpoints and restarts, K6t's restart, chunked decodes against one
  chunk, and the route predicates.

Inputs are made from numpy seeds.  The CUDA kernels K6t, K7n and W2 are held
against these twins on the card by ``chip_smoke.py`` (phases 31-33)."""
import importlib
import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu.ops import blocked as jbl
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import dense_scan as ds
from markovmodels_tpu_torch.ops import vit_scan as vs
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from tests.test_inference import make_hmm
from tests.test_viterbi import oracle_viterbi
from _torch_port import (compile_port, inputs, jax_compiled, port_from_jax,
                         port_lm_graph)

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

B, N = 6, 24
LENS = [N, 1, 2 * N // 3, N - 5, 2, N]
# scores, port vs the JAX package: the same float32 operations on the same
# operator; the two frameworks' exp and log round the last bit differently
TOL = 1e-4
TOL_ORACLE = 1e-4  # a score vs the float64 DP oracle (test_viterbi.py's)


def _no_env(mp):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS", "MMTPU_VIT_PALLAS",
              "MMTPU_NO_VITBP", "MMTPU_VIT_PACKED"):
        mp.delenv(k, raising=False)


def _jax_viterbi(cj, lhs, lens, chunk, env=()):
    with pytest.MonkeyPatch.context() as mp:
        _no_env(mp)
        for name in env:
            mp.setenv(name, "1")
        states, score = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens),
                                     chunk_size=chunk)
        return np.asarray(states), np.asarray(score)


def _assert_same_decode(port, ref):
    (st, zt), (sj, zj) = ((np.asarray(s), np.asarray(z)) for s, z in
                          (port, ref))
    assert st.dtype == sj.dtype == np.int32 and st.shape == sj.shape
    np.testing.assert_array_equal(st, sj)
    fin = np.isfinite(zj)
    assert (np.isfinite(zt) == fin).all()
    np.testing.assert_allclose(zt[fin], zj[fin], atol=TOL, rtol=0)


def _data(P, seed=3):
    return inputs(B, N, P, seed=seed, lens=LENS, cliffs=True)


# ---------------------------------------------------------------------------
# the tropical block_matvec
# ---------------------------------------------------------------------------

def _separate():
    fsm, spdf, P, _ = make_backoff_lm_hmm_graph(layout="separate", V=8,
                                                hmm_states=3, keep=0.3)
    return inf.compile_fsm(fsm, spdf, P, strategy="block", ov_cap=8)


@pytest.mark.parametrize("graph", ["V16", "V32", "separate"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_block_matvec_max_matches_jax(graph, direction):
    cj = {"V16": lambda: jax_compiled(16), "V32": lambda: jax_compiled(32),
          "separate": _separate}[graph]()
    assert bool(cj.pdf_group) == (graph != "separate")
    assert (len(cj.block_fwd.tiers) == 2) == (graph == "V32")
    assert bool(cj.block_fwd.ov_w) == (graph == "separate")
    ct = port_from_jax(cj)
    op_j, meta_j = getattr(cj, f"block_{direction}"), getattr(
        cj, f"block_{direction}_offsets")
    op_t, meta_t = getattr(ct, f"block_{direction}"), getattr(
        ct, f"block_{direction}_offsets")
    rng = np.random.default_rng(len(graph))
    x = rng.uniform(size=(cj.padded_states, 3)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = 0.0
    yj = np.asarray(jbl.block_matvec(op_j, meta_j, jnp.asarray(x), None,
                                     op_kind="max"))
    yt = tbl.block_matvec(op_t, meta_t, torch.from_numpy(x),
                          op_kind="max").numpy()
    assert (yj > 0).any()
    # the same float32 products and exact maxima: bit-equal
    np.testing.assert_array_equal(yt, yj)
    ysum = tbl.block_matvec(op_t, meta_t, torch.from_numpy(x)).numpy()
    assert (ysum >= yt).all() and (ysum > yt).any()


def test_block_matvec_max_takes_float32_only():
    ct = port_from_jax(jax_compiled(16))
    x = torch.ones((ct.padded_states, 2))
    with pytest.raises(ValueError, match="float32"):
        tbl.block_matvec(ct.block_fwd, ct.block_fwd_offsets, x, bf16=True,
                         op_kind="max")
    with pytest.raises(ValueError, match="op_kind"):
        tbl.block_matvec(ct.block_fwd, ct.block_fwd_offsets, x,
                         op_kind="min")


# ---------------------------------------------------------------------------
# the decode against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 7])
def test_dense_decode_matches_jax(chunk):
    """The route of every 'dense' graph, which
    ``test_unported_routes_raise`` no longer expects to raise."""
    cj = jax_compiled(16, strategy="dense")
    ct = port_from_jax(cj)
    lhs, lens = _data(ct.num_pdfs)
    assert tvit._bp_vit_reject_reason(ct, lhs) == "strategy 'dense' != 'block'"
    port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens),
                      chunk_size=chunk)
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens, chunk))
    assert np.isneginf(port[1].numpy()[[1, 4]]).all()  # lengths 1 and 2


@pytest.mark.parametrize("chunk", [None, 7])
def test_two_tier_block_decode_matches_jax(chunk, caplog):
    cj = jax_compiled(32)
    ct = port_from_jax(cj)
    lhs, lens = _data(ct.num_pdfs, seed=4)
    reason = tvit._bp_vit_reject_reason(ct, lhs)
    assert reason.startswith("operator not a single affine tier")
    assert "2 tiers" in vs.vit_scan_reject_reason(ct, B)
    with caplog.at_level(logging.WARNING, logger="markovmodels_tpu_torch"):
        port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens),
                          chunk_size=chunk)
        mt.viterbi(ct, torch.from_numpy(lhs[:2]), torch.from_numpy(lens[:2]))
    warned = [r for r in caplog.records if "chunk-recompute" in r.message]
    assert len(warned) == 1 and reason in warned[0].message  # once a graph
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens, chunk))


@pytest.mark.parametrize("chunk", [None, 7])
def test_single_tier_block_recompute_matches_jax(chunk, monkeypatch):
    """The JAX package forced onto its recompute route by MMTPU_NO_VITBP
    (on its side only: the port reads no environment flag), the port by
    calling its recompute function."""
    cj = jax_compiled(8)
    ct = port_from_jax(cj)
    lhs, lens = _data(ct.num_pdfs, seed=5)
    _no_env(monkeypatch)
    assert jvit._bp_vit_reject_reason(cj, lhs) is None
    monkeypatch.setenv("MMTPU_NO_VITBP", "1")
    assert tvit._bp_vit_reject_reason(ct, lhs) is None
    port = tvit._viterbi_recompute(ct, torch.from_numpy(lhs),
                                   torch.from_numpy(lens), chunk)
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens, chunk,
                                           env=("MMTPU_NO_VITBP",)))


def test_over_budget_block_decode_matches_jax(monkeypatch):
    """A 'block' graph whose id stream passes the budget (a route
    ``test_unported_routes_raise`` no longer expects to raise): both
    packages' budgets lowered to below this call's stream, so both take the
    recompute route through their public ``viterbi``."""
    cj = jax_compiled(8)
    ct = port_from_jax(cj)
    lhs, lens = _data(ct.num_pdfs, seed=6)
    need = (N + 1) * ct.padded_states * B
    monkeypatch.setattr(jvit, "_BP_MEM_BYTES", need - 1)
    monkeypatch.setattr(tvit, "_BP_MEM_BYTES", need - 1)
    reason = tvit._bp_vit_reject_reason(ct, lhs)
    assert "budget" in reason
    assert reason.split(" (")[0] == jvit._bp_vit_reject_reason(
        cj, jnp.asarray(lhs)).split(" (")[0]
    port = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    _assert_same_decode(port, _jax_viterbi(cj, lhs, lens, None))


# ---------------------------------------------------------------------------
# against the float64 DP oracle
# ---------------------------------------------------------------------------

def _port_fsm(alpha, T, omega, P):
    labels = [mt.labels.Label(i % P) for i in range(len(alpha))]
    return mt.fsm.FSM.from_parts(alpha, mt.hostsparse.spmat_from_dense(
        T, mt.LOG), omega, labels, mt.LOG)


def _assert_oracle(states, score, fsm_parts, state_pdf, loglik, lengths,
                   num_states):
    alpha, T, omega = fsm_parts
    for b, L in enumerate(lengths):
        path, ref = oracle_viterbi(alpha, T, omega, state_pdf,
                                   loglik[b, :L].astype(np.float64))
        np.testing.assert_allclose(float(score[b]), ref, atol=TOL_ORACLE)
        np.testing.assert_array_equal(np.asarray(states[b, :L]), path)
        assert (np.asarray(states[b, L:]) == num_states - 1).all()


@pytest.mark.parametrize("chunk", [None, 7])
def test_baseline_config1_hmm_path_is_the_oracles(chunk):
    """BASELINE.json config 1: a single-utterance left-to-right 5-state
    HMM, T=100 ('auto' compiles it 'dense')."""
    S, P, T_ = 5, 5, 100
    _, state_pdf, parts = make_hmm(np.random.default_rng(21), S, P)
    ct = compile_port(_port_fsm(*parts, P), state_pdf, P)
    assert ct.strategy == "dense"
    loglik = np.random.default_rng(22).normal(size=(1, T_, P)).astype(
        np.float32)
    states, score = mt.viterbi(ct, torch.from_numpy(loglik),
                               chunk_size=chunk)
    _assert_oracle(states.numpy(), score.numpy(), parts, state_pdf, loglik,
                   [T_], S + 1)


@pytest.mark.parametrize("strategy", ["dense", "block"])
@pytest.mark.parametrize("chunk", [None, 7])
def test_scale_exact_graphs_match_the_oracle(strategy, chunk):
    """The graphs of the JAX package's ``test_viterbi_scale_exact``.  A
    'block' one takes the compressed-backpointer route in both packages,
    which the port runs only through K7's plan (not this graph's), so its
    recompute function is called directly."""
    rng = np.random.default_rng(15)
    S, P, N_, B_ = 9, 4, 30, 3
    _, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    T = T.copy()
    T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
    ct = compile_port(_port_fsm(alpha, T, omega, P), state_pdf, P,
                      strategy=strategy)
    loglik = rng.normal(size=(B_, N_, P)).astype(np.float32)
    lengths = np.array([30, 13, 21], dtype=np.int32)
    args = (ct, torch.from_numpy(loglik), torch.from_numpy(lengths))
    decode = (mt.viterbi(*args, chunk_size=chunk) if strategy == "dense"
              else tvit._viterbi_recompute(*args, chunk))
    _assert_oracle(decode[0].numpy(), decode[1].numpy(), (alpha, T, omega),
                   state_pdf, loglik, lengths, S + 1)


# ---------------------------------------------------------------------------
# the walk twin's rules
# ---------------------------------------------------------------------------

def _tables(edges, Sp, fin, omega, dmax=None):
    """RecWalkTables of (dst, src, log w) edges sorted by dst."""
    dst = np.array([e[0] for e in edges])
    rowptr = np.searchsorted(dst, np.arange(Sp + 1)).astype(np.int32)
    indeg = np.diff(rowptr)
    indeg[[fin, Sp - 1]] = 0
    return vs.RecWalkTables(
        rowptr=torch.from_numpy(rowptr),
        src=torch.tensor([e[1] for e in edges], dtype=torch.int32),
        w=torch.tensor([e[2] for e in edges], dtype=torch.float32),
        omega=torch.tensor(omega, dtype=torch.float32),
        dmax=dmax or int(indeg.max()), fin=fin)


def test_walk_twin_rules():
    """Sp = 8, fin = 6.  Column 0: state 3's in-arcs (positions 0-2:
    sources 1, 2, 5) tie between sources 1 and 5 (position 2 wins);
    column 1: state 4's sources hold no mass (park on fin); columns 2 and
    3 (length 2): past the length fin, at t = L - 1 the ω argmax, by value
    (column 2) and at a tie between states 2 and 5 (5 wins, column 3)."""
    Sp, fin = 8, 6
    lw = np.log(0.5)
    edges = [(3, 1, lw), (3, 2, lw), (3, 5, lw), (4, 0, 0.0), (4, 7, 0.0),
             (fin, 5, 0.0)]
    omega = [0.0, 0.0, 1.0, 0.0, 0.0, 0.5, 0.0, 0.0]
    wt = _tables(edges, Sp, fin, omega)
    a = torch.zeros((4, Sp, 4))
    a[:, 1], a[:, 2], a[:, 5] = 0.4, 0.2, 0.4  # 1 and 5 tie, 2 lower
    a[:, 2, 2] = 0.1  # column 2: ω 0.1·1.0 < 0.4·0.5
    a[:, 5, 3] = 0.8  # column 3: ω tie 0.4·1.0 == 0.8·0.5
    a[:, 2, 3] = 0.4
    scales = torch.ones((4, 4))
    lengths = torch.tensor([5, 5, 2, 2], dtype=torch.int32)
    s_next = torch.tensor([3, 4, fin, fin], dtype=torch.int32)
    out = vs.rec_walk_plain(wt, a, scales, lengths, 0, s_next)
    assert out.dtype == torch.int32 and out.shape == (4, 4)
    assert out[3, 0] == 5  # the tie: the largest position (source 5)
    assert out[3, 1] == fin  # no candidate with mass: parked on fin
    assert (out[2:, 2] == fin).all() and (out[2:, 3] == fin).all()  # t >= L
    assert out[1, 3] == 5  # t = L - 1: the ω tie to the largest state
    assert out[1, 2] == 5  # 0.4·0.5 > 0.1·1.0: the value decides
    # a Dmax below the in-degree truncates the list: position 2 is out
    wt2 = _tables(edges, Sp, fin, omega, dmax=2)
    assert vs.rec_walk_plain(wt2, a, scales, lengths, 0, s_next)[3, 0] == 1


def _near_tie():
    """(a1, a2, w1, w2, k): two candidates whose order by log(a·2^-k) + w
    (the scaled alpha, in torch and in the JAX package alike) differs from
    their order by log(a) + w - k·ln2 (the scale after the log).  Found by
    a seeded search over float32 values."""
    rng = np.random.default_rng(0)
    ln2 = torch.tensor(np.log(2.0), dtype=torch.float32)
    for _ in range(200):
        k = float(rng.integers(-60, 60))
        a = torch.from_numpy(rng.uniform(0.01, 1.0, size=(4096, 2))
                             .astype(np.float32))
        w1 = torch.from_numpy(rng.uniform(-3, 0, size=4096)
                              .astype(np.float32))
        w2 = torch.log(a[:, 0]) + w1 - torch.log(a[:, 1])
        sc = torch.tensor(2.0 ** -k, dtype=torch.float32)
        before = [torch.log(a[:, i] * sc) + w for i, w in ((0, w1), (1, w2))]
        after = [torch.log(a[:, i]) + w - k * ln2
                 for i, w in ((0, w1), (1, w2))]
        jax = [np.asarray(jnp.log(jnp.asarray(a[:, i].numpy()) * float(sc))
                          + jnp.asarray(w.numpy()))
               for i, w in ((0, w1), (1, w2))]
        flip = (before[0] > before[1]) != (after[0] > after[1])
        flip &= before[0] != before[1]
        flip &= torch.from_numpy((jax[0] > jax[1])) == (before[0] > before[1])
        if flip.any():
            j = int(torch.nonzero(flip)[0, 0])
            return (float(a[j, 0]), float(a[j, 1]), float(w1[j]),
                    float(w2[j]), k)
    raise AssertionError("no near-tie found")


def test_walk_twin_scales_before_the_log():
    a1, a2, w1, w2, k = _near_tie()
    Sp, fin = 4, 2
    wt = _tables([(0, 1, w1), (0, 3, w2)], Sp, fin, [0.0] * 4, dmax=2)
    st = torch.zeros((1, Sp, 1))
    st[0, 1, 0], st[0, 3, 0] = float(a1), float(a2)
    sc = torch.tensor([[2.0 ** -k]])
    out = vs.rec_walk_plain(wt, st, sc, torch.tensor([5], dtype=torch.int32),
                            0, torch.tensor([0], dtype=torch.int32))
    # the JAX package's candidates: log of the scaled alpha, plus w
    cand = [float(jnp.log(jnp.float32(a) * jnp.float32(2.0 ** -k))
                  + jnp.float32(w)) for a, w in ((a1, w1), (a2, w2))]
    late = [np.log(np.float32(a)) + np.float32(w)
            - np.float32(k) * np.float32(np.log(2.0))
            for a, w in ((a1, w1), (a2, w2))]
    assert cand[0] != cand[1] and (cand[0] > cand[1]) != (late[0] > late[1])
    assert int(out[0, 0]) == (1 if cand[0] > cand[1] else 3)


# ---------------------------------------------------------------------------
# the sweeps' twins: K7n against K7, restarts, chunks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k7_graph():
    fsm, spdf, P, _ = port_lm_graph(128)
    ct = compile_port(fsm, spdf, P, strategy="block")
    lhs, lens = inputs(2, 5, P, seed=8, lens=[5, 4], cliffs=True)
    return ct, prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P)


def test_k7n_twin_ends_as_k7(k7_graph):
    ct, (ext, msh) = k7_graph
    _, _, vfin, shift, ksum = vs.viterbi_fwd_plain(ct, ext, msh)
    save, scales, a_last, s_last, acc = vs.viterbi_fwd(ct, ext, msh,
                                                       ids=False)
    assert save.shape == (6, ct.padded_states, 2) and scales.shape == (6, 2)
    assert torch.equal(a_last[ct.final_state] * s_last, vfin)
    assert torch.equal(acc[0], ksum) and torch.equal(acc[1], shift)
    assert torch.equal(save[-1], a_last) and torch.equal(scales[-1], s_last)
    assert (vfin > 0).all()
    # every 2nd frame as checkpoints: frames 1, 3 and 5, the same end
    ck = vs.viterbi_fwd_plain(ct, ext, msh, ids=False, stride=2)
    assert ck[0].shape[0] == 3 and torch.equal(ck[0], save[1::2])
    assert torch.equal(ck[1], scales[1::2])
    assert torch.equal(ck[2], a_last) and torch.equal(ck[4], acc)
    # restarted at frame 3 from frame 2's saved state and scale
    r = vs.viterbi_fwd_plain(ct, ext[3:], msh[3:], ids=False, a0=save[2],
                             s0=scales[2], t0=3)
    assert torch.equal(r[0], save[3:]) and torch.equal(r[1], scales[3:])


def test_k6t_twin_restart_and_the_ones_decode():
    cj = jax_compiled(16, strategy="dense")
    ct = port_from_jax(cj)
    lhs, lens = _data(ct.num_pdfs, seed=9)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), ct.num_pdfs)
    kop = ds.trop_operator(ct)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B)
    states, scales, a_last, s_last, acc = ds.trop_sweep(
        kop, a0, torch.ones(B), ext, msh, first=True)
    assert states.shape == (N + 1, kop.Sp, B)
    h = 10
    r = ds.trop_sweep(kop, states[h - 1], scales[h - 1], ext[h:], msh[h:],
                      first=False)
    assert torch.equal(r[0], states[h:]) and torch.equal(r[1], scales[h:])
    ring = ds.trop_sweep(kop, a0, torch.ones(B), ext, msh, first=True,
                         save=False)
    assert ring[0] is None and torch.equal(ring[2], a_last)
    assert torch.equal(ring[4], acc)
    # the walk over the whole sweep is the decode's path
    wt = vs.rec_walk_tables(ct)
    path = vs.rec_walk(wt, states, scales, torch.from_numpy(lens), 0,
                       torch.full((B,), wt.fin, dtype=torch.int32))
    dec, _ = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    assert torch.equal(ct.orig_state[path[:N].long()].T, dec)


@pytest.mark.parametrize("graph", ["dense16", "block32"])
def test_chunked_decode_equals_one_chunk(graph):
    cj = (jax_compiled(16, strategy="dense") if graph == "dense16"
          else jax_compiled(32))
    ct = port_from_jax(cj)
    lhs, lens = (torch.from_numpy(x) for x in _data(ct.num_pdfs, seed=10))
    one = mt.viterbi(ct, lhs, lens)
    for k in (1, 5, 7, N, N + 1, 100):
        got = mt.viterbi(ct, lhs, lens, chunk_size=k)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]), k


# ---------------------------------------------------------------------------
# route predicates and wrappers
# ---------------------------------------------------------------------------

def test_chunk_rule_is_the_jax_packages():
    """Nf frames in one chunk while Nf·Sp·B·4 bytes fit 4 GB, else 64."""
    cf = types.SimpleNamespace(padded_states=49280)
    lhs = lambda b, n: torch.empty((b, n, 1), device="meta")
    assert tvit._chunk_frames(cf, lhs(128, 100), None) == 101
    assert tvit._chunk_frames(cf, lhs(128, 1024), None) == 64
    assert 170 * 49280 * 128 * 4 <= 4 << 30 < 171 * 49280 * 128 * 4
    assert tvit._chunk_frames(cf, lhs(128, 169), None) == 170
    assert tvit._chunk_frames(cf, lhs(128, 170), None) == 64
    assert tvit._chunk_frames(cf, lhs(2, 30), 7) == 7
    assert tvit._chunk_frames(cf, lhs(2, 30), 500) == 31


def test_card_route_refuses_two_tiers(caplog):
    """On a CUDA device the recompute route asks K7n's admission before any
    launch (checked without a card: the admission reads no device here):
    the V=32 graph's two tiers are refused with K7n's words, so the decode
    takes the plain twins, the counterpart of the JAX package's XLA sweep,
    and logs the predicate once; on the CPU the wrappers' own twins run."""
    ct = port_from_jax(jax_compiled(32))
    reason = vs.vit_scan_reject_reason(ct, 8, saved=41)
    assert reason == "2 tiers (kernel supports exactly 1)"
    card = types.SimpleNamespace(shape=(8, 40, ct.num_pdfs),
                                 device=torch.device("cuda"))
    with caplog.at_level(logging.WARNING, logger="markovmodels_tpu_torch"):
        for _ in range(2):
            got = tvit._plain_decode(ct, card, saved=41)
            assert got == ("the id-free Viterbi sweep (K7n) refuses this "
                           f"graph: {reason}")
    assert [r.getMessage() for r in caplog.records] == [
        f"block-strategy Viterbi fell off the sweep kernels: {got}"]
    cpu = types.SimpleNamespace(shape=card.shape, device=torch.device("cpu"))
    assert tvit._plain_decode(ct, cpu, saved=41) is None
    # the kernels' sweeps are no longer guarded inside ``_sweeps``: the
    # rule above decided the route
    sweep, _ = tvit._sweeps(ct, 8, 41, 41, torch.device("cuda"), plain=True)
    assert callable(sweep)


def test_wrappers_refuse_other_devices():
    ct = port_from_jax(jax_compiled(16, strategy="dense"))
    kop = ds.trop_operator(ct)
    ext = torch.empty((4, ct.num_pdfs + 1, 2), device="meta")
    a = torch.empty((kop.Sp, 2), device="meta")
    with pytest.raises(ValueError, match="no dense-tropical-sweep kernel"):
        ds.trop_sweep(kop, a, a[0], ext, ext[:, :1], first=True)
    with pytest.raises(ValueError, match="no Viterbi-sweep kernel"):
        vs.viterbi_fwd(ct, ext, ext[:, :1], ids=False)
    with pytest.raises(ValueError, match="no recompute-walk kernel"):
        vs.rec_walk(vs.rec_walk_tables(ct), a[None], a[:1], a[0].int(), 0,
                    a[0].int())


def test_walk_tables_match_the_jax_packages():
    """rowptr over the dst-sorted edges, Dmax without the phony state and
    row Sp - 1, ω from the rank-1 split ('block') or the operator's phony
    row ('dense')."""
    for cj in (jax_compiled(16, strategy="dense"), jax_compiled(32)):
        ct = port_from_jax(cj)
        wt = vs.rec_walk_tables(ct)
        assert vs.rec_walk_tables(ct) is wt  # cached
        Sp, fin = ct.padded_states, int(cj.final_state)
        dst = np.asarray(cj.fwd_dst)
        rowptr = np.searchsorted(dst, np.arange(Sp + 1))
        np.testing.assert_array_equal(wt.rowptr.numpy(), rowptr)
        indeg = np.diff(rowptr)
        indeg[[fin, Sp - 1]] = 0
        assert wt.dmax == max(int(indeg.max()), 1) and wt.fin == fin
        om = (np.asarray(cj.omega_prob) if cj.strategy == "block" else
              np.asarray(jnp.exp(cj.dense_fwd_max[fin])
                         * cj.dense_fwd_exp[fin]))
        np.testing.assert_allclose(wt.omega.numpy(), om, rtol=1e-6, atol=0)


def test_trop_operator_is_float32_on_a_bf16_graph():
    fsm, spdf, P, _ = port_lm_graph(16)
    hi = compile_port(fsm, spdf, P, strategy="dense")
    lo = compile_port(fsm, spdf, P, strategy="dense", precision="bf16")
    assert ds.kernel_operator(lo).wf.dtype == torch.bfloat16
    k_hi, k_lo = ds.trop_operator(hi), ds.trop_operator(lo)
    assert k_hi.wf is ds.kernel_operator(hi).wf
    assert k_lo.wf.dtype == torch.float32 and torch.equal(k_lo.wf, k_hi.wf)
    assert all(torch.equal(x, y) for x, y in zip(k_lo.pt[:5], k_hi.pt[:5]))
    lhs, lens = (torch.from_numpy(x) for x in _data(P, seed=11))
    s_hi, z_hi = mt.viterbi(hi, lhs, lens)
    s_lo, z_lo = mt.viterbi(lo, lhs, lens)
    assert torch.equal(s_hi, s_lo) and torch.equal(z_hi, z_lo)


def test_recompute_on_the_cpu_launches_no_kernel():
    ct = port_from_jax(jax_compiled(32))
    lhs, lens = (torch.from_numpy(x) for x in _data(ct.num_pdfs, seed=12))
    vs.reset_launch_counts()
    ds.reset_launch_counts()
    mt.viterbi(ct, lhs, lens, chunk_size=5)
    assert not any(vs.LAUNCHES.values()) and not any(ds.LAUNCHES.values())
