"""The port's Viterbi decode (viterbi.py, ops/vit_scan.py and the tropical
matvec of ops/blocked.py) against the JAX package on the CPU.

* the port's ``viterbi`` against the JAX package's default decode (the XLA
  compressed-backpointer sweep) and its fused K7 form (Pallas interpret
  mode) on the V=128 'block' graph (the 2M-arc graph) at tiny B and N, with
  mixed lengths including 1 and ±30-nat emission cliffs, every decoded
  path checked optimal in float64 against the port's oracle;
* K7's plain twin against ``pallas_block.block_fused_viterbi_fwd`` in
  interpret mode: ids and ω argmaxes bit-equal;
* ``block_matvec_max_arg`` against the JAX package's on random states with
  ties, and its tie rule;
* the route predicates against the JAX package's, and the routes the port
  does not have yet (the chunk-recompute decode of 'dense' graphs and of
  'block' graphs past the id budget: tests/test_torch_vit_recompute.py).

Inputs are made from numpy seeds.  The CUDA kernels themselves are held
against these twins on the card by ``chip_smoke.py`` (phases 15-17)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu.ops import blocked as jbl
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import vit_scan as vs
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import (compile_port, inputs, jax_compiled, jax_fields,
                         numerators, port_lm_graph)

# the module (the package's ``viterbi`` attribute is the function)
tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

B, N = 8, 7
LENS = [7, 1, 5, 7, 2, 6, 4, 3]
TOL = 1e-5  # port vs the JAX package: scores (float32, same operations)
TOL_PATH = 1e-4  # a decoded path's f64 weight vs the f64 optimum


def _env(mp, *names):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS", "MMTPU_VIT_PALLAS",
              "MMTPU_NO_VITBP", "MMTPU_VIT_PACKED"):
        mp.delenv(k, raising=False)
    for name in names:
        mp.setenv(name, "1")


@pytest.fixture(scope="module")
def graphs():
    fsm, spdf, P, _ = port_lm_graph(128)
    return jax_compiled(128), compile_port(fsm, spdf, P, strategy="block")


@pytest.fixture(scope="module")
def data(graphs):
    return inputs(B, N, graphs[1].num_pdfs, seed=23, lens=LENS, cliffs=True)


@pytest.fixture(scope="module")
def port(graphs, data):
    vs.reset_launch_counts()
    states, score = mt.viterbi(graphs[1], *(torch.from_numpy(x) for x in data))
    return states.numpy(), score.numpy(), dict(vs.LAUNCHES)


def _jax_viterbi(cj, lhs, lens, *env):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, *env)
        states, score = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens))
        return np.asarray(states), np.asarray(score)


@pytest.fixture(scope="module")
def jax_refs(graphs, data):
    cj = graphs[0]
    assert jvit._bp_vit_ok(cj, jnp.asarray(data[0]))
    return {"xla": _jax_viterbi(cj, *data),
            "k7": _jax_viterbi(cj, *data, "MMTPU_VIT_PALLAS",
                               "MMTPU_PALLAS_INTERPRET")}


@pytest.fixture(scope="module")
def optimum(data):
    fsm, spdf, P, _ = port_lm_graph(128)
    lhs, lens = data
    return mt.oracle.host_viterbi_score(fsm, spdf, P, lhs.astype(np.float64),
                                        lens)


def _assert_scores(z, ref, atol):
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("ref", ["xla", "k7"])
def test_viterbi_scores_match_jax(port, jax_refs, ref):
    _assert_scores(port[1], jax_refs[ref][1], TOL)


def test_viterbi_paths_are_optimal_in_f64(port, data, optimum):
    """Every feasible sequence's decoded path weighs the f64 max-plus
    optimum; the infeasible ones (lengths 1 and 2, shorter than the
    3-state HMMs) score -inf."""
    fsm, spdf, _, _ = port_lm_graph(128)
    lhs, lens = data
    states, score, _ = port
    assert np.isneginf(score[[1, 4]]).all()
    assert np.isneginf(optimum[[1, 4]]).all()
    _assert_scores(score, optimum, TOL_PATH)
    fin = np.isfinite(optimum)
    gap = mt.oracle.validate_paths(fsm, spdf, lhs[fin], lens[fin],
                                   states[fin], optimum[fin], atol=TOL_PATH)
    assert gap < TOL_PATH


def test_viterbi_states_equal_jax_k7_form(port, jax_refs, data):
    """The port's ids are K7's (bit-equal twin), so its walk retraces the
    JAX package's K7-form decode state for state, past the lengths too."""
    assert port[0].dtype == np.int32 and port[0].shape == (B, N)
    np.testing.assert_array_equal(port[0], jax_refs["k7"][0])
    fin_host = len(port_lm_graph(128)[0].alpha_hat) - 1
    for b, L in enumerate(data[1]):
        assert (port[0][b, L:] == fin_host).all()


def test_viterbi_on_the_cpu_launches_no_kernel(port):
    assert port[2] == {"vit_fwd": 0, "vit_walk": 0, "vit_fwd_noid": 0,
                       "rec_walk": 0}


def test_viterbi_lengths_default_and_clamp(graphs, data):
    lhs = torch.from_numpy(data[0][:2])
    s0, z0 = mt.viterbi(graphs[1], lhs)
    s1, z1 = mt.best_path(graphs[1], lhs, torch.tensor([N + 4, N]))
    assert torch.equal(s0, s1) and torch.equal(z0, z1)


# ---------------------------------------------------------------------------
# K7's plain twin against the fused Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k7_pair(graphs, data):
    cj, ct = graphs
    lhs, lens = data
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_PALLAS_INTERPRET")
        assert pb.vit_scan_supported(cj, B)
        ext, msh = ps.prepare_emissions(jnp.asarray(lhs), jnp.asarray(lens),
                                        ct.num_pdfs)
        out_j = [np.asarray(x) for x in pb.block_fused_viterbi_fwd(cj, ext,
                                                                   msh)]
    ext_t = torch.from_numpy(np.array(ext))
    msh_t = torch.from_numpy(np.array(msh))
    out_t = [x.numpy() for x in vs.viterbi_fwd(ct, ext_t, msh_t)]
    return out_j, out_t, (ext_t, msh_t)


def test_k7_twin_ids_are_bit_equal_to_pallas(k7_pair):
    (bj, fj, *_), (bt, ft, *_), _ = k7_pair
    assert bt.dtype == bj.dtype == np.uint8 and bt.shape == bj.shape
    assert bt.shape == (N + 1, 49152, B)
    np.testing.assert_array_equal(bt, bj)
    assert ft.dtype == fj.dtype == np.int32
    np.testing.assert_array_equal(ft, fj)
    assert (bt == 255).any() and (bt < 128).any() and (bt >= 128).any()


def test_k7_twin_final_value_and_shift_match_pallas(k7_pair):
    """vfin·2^ksum and the shift agree; ksum alone may not (the twin's
    exponent comes from the float's bits, the kernel's from log2).

    The JAX kernel rescales by ``exp2(-k)``, which XLA's CPU backend does
    not compute exactly at integers: its relative error ``e2`` (measured
    here, a few 1e-6) compounds over the Nf frames, while the port scales
    by exact powers of two.  That, not the sweep, sets the tolerance."""
    (_, _, vj, sj, kj), (_, _, vt, st, kt), _ = k7_pair
    ks = np.arange(-120, 121)
    e2 = float(np.abs(np.asarray(jnp.exp2(jnp.asarray(ks, jnp.float32)),
                                 np.float64) / np.exp2(ks) - 1).max())
    assert 0 < e2 < 1e-5
    fj = vj.astype(np.float64) * np.exp2(kj.astype(np.float64))
    ft = vt.astype(np.float64) * np.exp2(kt.astype(np.float64))
    # lengths 1 and 2: shorter than the 3-state HMMs, no path
    np.testing.assert_array_equal(ft == 0, np.isin(np.arange(B), [1, 4]))
    np.testing.assert_array_equal(fj == 0, ft == 0)
    np.testing.assert_allclose(ft, fj, rtol=(N + 1) * e2, atol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)


def test_walk_twin_retraces_jax_k7_decode(graphs, k7_pair, jax_refs, data):
    _, (bt, ft, *_), _ = k7_pair
    ct = graphs[1]
    states = vs.walk_plain(vs.walk_tables(ct), torch.from_numpy(bt),
                           torch.from_numpy(ft), torch.from_numpy(data[1]))
    assert states.shape == (N, B)
    host = ct.orig_state[states.long()].T.numpy()
    np.testing.assert_array_equal(host, jax_refs["k7"][0])


# ---------------------------------------------------------------------------
# the tropical matvec with candidate ids
# ---------------------------------------------------------------------------

def _cand_values(op, meta, x, cand):
    """The product each candidate id stands for, per (dst, column)."""
    Sp, Bc = x.shape
    sidx, didx, W = (np.asarray(t) for t in op.tiers[0])
    K, Sm = sidx.shape
    k_of = tbl.tier_dst_inverse(op, Sp)
    d_of = np.full(Sp, -1)
    d_of[didx.reshape(-1)] = np.tile(np.arange(didx.shape[1]), K)
    band = np.asarray(op.band_w)
    out = np.zeros((Sp, Bc), np.float32)
    for j, b in zip(*np.nonzero(cand != 255)):
        c = cand[j, b]
        if c < Sm:
            k = k_of[j]
            out[j, b] = W[k, c, d_of[j]] * x[sidx[k, c], b]
        else:
            out[j, b] = band[c - Sm, j] * x[(j - meta[0][c - Sm]) % Sp, b]
    return out


def test_block_matvec_max_arg_matches_jax_with_ties(graphs):
    """States drawn from {0, 1/4, 1/2, 1}: many exact ties.  Values equal
    JAX's bit for bit; where the two pick different candidates (XLA's
    reduction picks some maximiser), both stand for the maximum."""
    cj, ct = graphs
    Sp = ct.padded_states
    rng = np.random.default_rng(9)
    x = rng.choice(np.float32([0, 0.25, 0.5, 1]), size=(Sp, 3))
    x[ct.final_state:] = 0
    yj, cjd = jbl.block_matvec_max_arg(cj.block_fwd, cj.block_fwd_offsets,
                                       jnp.asarray(x))
    yt, ctd = tbl.block_matvec_max_arg(ct.block_fwd, ct.block_fwd_offsets,
                                       torch.from_numpy(x))
    yj, cjd, yt, ctd = (np.asarray(a) for a in (yj, cjd, yt, ctd))
    assert ctd.dtype == np.int32
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(ctd == 255, cjd == 255)
    differ = ctd != cjd
    for cand in (ctd, cjd):
        vals = _cand_values(ct.block_fwd, ct.block_fwd_offsets, x,
                            np.where(differ, cand, 255))
        np.testing.assert_array_equal(vals[differ], yt[differ])


def test_tier_max_arg_takes_the_smallest_position_among_ties():
    rng = np.random.default_rng(2)
    W = rng.choice(np.float32([0.5, 1.0]), size=(3, 6, 5))
    X = rng.choice(np.float32([0.0, 1.0, 2.0]), size=(3, 6, 4))
    Y, A = tbl._tier_max_arg(torch.from_numpy(W), torch.from_numpy(X))
    prod = W[:, :, :, None] * X[:, :, None, :]
    np.testing.assert_array_equal(Y.numpy(), prod.max(axis=1))
    np.testing.assert_array_equal(A.numpy(), prod.argmax(axis=1))


def test_max_arg_support_and_dst_inverse_match_jax(graphs):
    for V in (16, 32, 64, 128):
        cj = jax_compiled(V)
        ct = mt.compiled_from_numpy(*jax_fields(cj), device="cpu")
        assert tbl.block_max_arg_supported(
            ct.block_fwd, ct.block_fwd_offsets) == jbl.block_max_arg_supported(
            cj.block_fwd, cj.block_fwd_offsets), V
    cj, ct = graphs
    np.testing.assert_array_equal(
        tbl.tier_dst_inverse(ct.block_fwd, ct.padded_states),
        jbl.tier_dst_inverse(cj.block_fwd, cj.padded_states))


# ---------------------------------------------------------------------------
# route predicates and the routes not ported yet
# ---------------------------------------------------------------------------

def _dense16():
    fsm, spdf, P, _ = port_lm_graph(16)
    return jax_compiled(16, strategy="dense"), compile_port(fsm, spdf, P)


def _head(reason):
    return None if reason is None else reason.split(" (")[0]


def test_bp_reject_reasons_match_jax(graphs, monkeypatch):
    _env(monkeypatch)
    cj, ct = graphs
    P = ct.num_pdfs
    small = np.zeros((2, 3, P), np.float32)
    huge = np.broadcast_to(np.float32(0), (128, 1200, P))  # ~7.6 GB of ids
    dj, dt = _dense16()
    cases = [
        ("accepted", cj, ct, small),
        ("strategy", dj, dt, small[..., :48]),
        ("omega", dataclasses.replace(cj, omega_prob=None),
         dataclasses.replace(ct, omega_prob=None), small),
        ("tiers", jax_compiled(32), compile_port(*port_lm_graph(32)[:3],
                                                 strategy="block"),
         small[..., :96]),
        ("memory", cj, ct, huge),
    ]
    for name, vj, vt, lhs in cases:
        want = jvit._bp_vit_reject_reason(vj, lhs)
        got = tvit._bp_vit_reject_reason(vt, lhs)
        assert (want is None) == (name == "accepted"), name
        assert _head(got) == _head(want), name


def test_vit_scan_reject_reason_matches_jax_admission(graphs):
    for V in (32, 64, 128):
        cj = jax_compiled(V)
        ct = graphs[1] if V == 128 else compile_port(*port_lm_graph(V)[:3],
                                                     strategy="block")
        assert (vs.vit_scan_reject_reason(ct, 8) is None) == \
            pb.vit_scan_supported(cj, 8), V
    assert "2 tiers" in vs.vit_scan_reject_reason(
        compile_port(*port_lm_graph(32)[:3], strategy="block"), 8)


def test_unported_routes_raise(graphs):
    """Batched graphs (the vmapped per-graph decode) and 'banded' graphs
    (_viterbi_single) raise NotImplementedError naming the route; nothing
    falls back.  ('dense' graphs and 'block' graphs past the id budget
    decode through the chunk-recompute route: tests/
    test_torch_vit_recompute.py.)"""
    _, dt = _dense16()
    lhs = torch.zeros((2, 3, 48))
    with pytest.raises(NotImplementedError, match="batched 'dense'"):
        mt.viterbi(mt.stack([dt, dt]), lhs)
    nums = numerators(np.random.default_rng(1), 2, 48, [4, 5], lib=mt)
    band = compile_port(*nums[0], 48, strategy="banded")
    with pytest.raises(NotImplementedError, match="'banded' graph.*_viterbi_single"):
        mt.viterbi(band, lhs)
    with pytest.raises(NotImplementedError, match="batched 'banded'"):
        mt.viterbi(mt.stack([compile_port(*g, 48, strategy="banded")
                             for g in nums]), lhs)


def test_viterbi_checks_its_inputs(graphs):
    ct = graphs[1]
    with pytest.raises(ValueError, match="pdfs"):
        mt.viterbi(ct, torch.zeros((2, 3, 5)))
    with pytest.raises(ValueError, match="graph on cpu"):
        mt.viterbi(ct, torch.zeros((2, 3, 384), device="meta"))


def test_wrappers_refuse_other_devices(graphs):
    ct = graphs[1]
    ext = torch.empty((4, 385, 2), device="meta")
    with pytest.raises(ValueError, match="no Viterbi-sweep kernel"):
        vs.viterbi_fwd(ct, ext, ext[:, :1])
    bps = torch.empty((4, 49152, 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no Viterbi-walk kernel"):
        vs.walk(vs.walk_tables(ct), bps, bps[:, 0].int(), bps[0, 0].int())


def test_plain_sweep_on_the_emissions_of_prepare_emissions(graphs, data):
    """The twin and the port's own emission prep give the K7 run of the
    decode (the inputs ``mt.viterbi`` feeds it)."""
    ct = graphs[1]
    lhs, lens = (torch.from_numpy(x) for x in data)
    ext, msh = prepare_emissions(lhs, lens, ct.num_pdfs)
    bps, fins, vfin, shift, ksum = vs.viterbi_fwd_plain(ct, ext, msh)
    assert bps.shape == (N + 1, 49152, B) and fins.shape == (N + 1, B)
    assert vfin.shape == shift.shape == ksum.shape == (B,)
    assert (fins < ct.padded_states).all()
