"""The port's ``_viterbi_single`` (the log-domain tropical scan with int32
backpointers) and ``maxstateposteriors`` against the JAX package's, on the
CPU: 'segment', 'ell' and single 'banded' graphs, the per-graph decode of
stacked graphs (stacked numerators: forced alignment), the log-domain
'dense' and 'block' decodes, the 6 GB guards, and the max-plus oracle of
``tests/test_viterbi.py``.

The decoded states must equal the JAX package's exactly, ties (the largest
source among equal maxima) and infeasible sequences included; scores are
held within TOL_SCORE."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from _torch_port import both, compile_port, hmm_pair, numerators
from tests.test_viterbi import oracle_viterbi

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

TOL_SCORE = 1e-5


def decode_both(cj, ct, lhs, lens):
    sj, zj = jvit.viterbi(cj, jnp.asarray(lhs), jnp.asarray(lens))
    st, zt = mt.viterbi(ct, torch.from_numpy(lhs), torch.from_numpy(lens))
    return np.asarray(sj), np.asarray(zj), st.numpy(), zt.numpy()


def assert_same_decode(sj, zj, st, zt):
    assert st.dtype == np.int32
    np.testing.assert_array_equal(st, sj)
    assert (np.isneginf(zt) == np.isneginf(zj)).all()
    fin = np.isfinite(zj)
    assert np.abs(zt[fin] - zj[fin]).max(initial=0) <= TOL_SCORE


@pytest.mark.parametrize("strategy,domain,lr", [
    ("segment", "prob", False), ("segment", "log", True),
    ("ell", "prob", True), ("ell", "log", False), ("banded", "prob", True),
])
def test_viterbi_single_matches_jax_and_the_oracle(strategy, domain, lr):
    """B=5, N=24, lengths 1 (infeasible for a left-to-right HMM) .. N;
    rounded log-likelihoods make ties; the feasible paths are also the
    f64 max-plus oracle's."""
    P, N, S = 3, 24, 6
    fj, ft, spdf, (alpha, T, omega) = hmm_pair(50, S, P, lr=lr,
                                               to_final=not lr)
    cj, ct = both(fj, ft, spdf, P, strategy=strategy, domain=domain)
    rng = np.random.default_rng(51)
    lhs = np.round(rng.normal(size=(5, N, P)), 1).astype(np.float32)
    lens = np.array([N, 1, 17, 9, N], dtype=np.int32)
    sj, zj, st, zt = decode_both(cj, ct, lhs, lens)
    assert_same_decode(sj, zj, st, zt)
    for b, L in enumerate(lens):
        if not np.isfinite(zt[b]):
            continue
        path, score = oracle_viterbi(alpha, T, omega, spdf,
                                     lhs[b, :L].astype(np.float64))
        assert abs(zt[b] - score) <= 1e-4
        np.testing.assert_array_equal(st[b, :L], path)
        assert (st[b, L:] == S).all()  # parked on the phony final state


@pytest.mark.parametrize("strategy,domain", [
    ("banded", "prob"), ("banded", "log"), ("segment", "prob"),
    ("dense", "prob"), ("ell", "log")])
def test_stacked_decode_matches_jax(strategy, domain):
    """Forced alignment: one sequence per numerator lattice (3-9 states,
    one with skip arcs), through the per-graph decode, against the JAX
    package's vmap over the graphs; graph 1's length is infeasible."""
    P, N = 10, 16
    lens_g = [5, 9, 3, 7]
    gj = numerators(np.random.default_rng(5), 4, P, lens_g, skip=(1,))
    gt = numerators(np.random.default_rng(5), 4, P, lens_g, skip=(1,),
                    lib=mt)
    cj = inf.stack([inf.compile_fsm(f, s, P, strategy=strategy,
                                    domain=domain) for f, s in gj])
    ct = mt.stack([compile_port(f, s, P, strategy=strategy, domain=domain)
                   for f, s in gt])
    lhs = np.round(np.random.default_rng(52).normal(size=(4, N, P)),
                   1).astype(np.float32)
    lens = np.array([N, 2, 11, N], dtype=np.int32)
    sj, zj, st, zt = decode_both(cj, ct, lhs, lens)
    assert_same_decode(sj, zj, st, zt)
    assert np.isneginf(zt[1])
    with pytest.raises(ValueError, match="one sequence per graph"):
        mt.viterbi(ct, torch.from_numpy(lhs[:3]))


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_log_domain_dense_and_block_decodes(strategy):
    """A log-domain 'dense' or 'block' graph decodes as the JAX package
    decodes it, through the at-scale route of the probability domain: the
    kernels' route on a CUDA device (the admissions of K6t and K7 / K7n
    answer as for the probability-domain graph), their plain twins on the
    CPU, with the same output as the probability-domain graph's."""
    from markovmodels_tpu_torch.ops import dense_scan, vit_scan
    P, N = 4, 20
    fj, ft, spdf, _ = hmm_pair(53, 9, P, lr=False, to_final=True)
    cj, ct = both(fj, ft, spdf, P, strategy=strategy, domain="log")
    cp = compile_port(ft, spdf, P, strategy=strategy)
    assert not tvit._plain_decode(ct) and not tvit._plain_decode(cp)
    if strategy == "dense":
        assert dense_scan.dense_scan_reject_reason(ct, 3, tropical=True) \
            is None
    else:
        assert (vit_scan.vit_scan_reject_reason(ct, 3)
                == vit_scan.vit_scan_reject_reason(cp, 3))
    lhs = np.random.default_rng(54).normal(size=(3, N, P)).astype(np.float32)
    lens = np.array([N, 13, 5], dtype=np.int32)
    sj, zj, st, zt = decode_both(cj, ct, lhs, lens)
    assert_same_decode(sj, zj, st, zt)
    sp, zp = mt.viterbi(cp, torch.from_numpy(lhs), torch.from_numpy(lens))
    np.testing.assert_array_equal(st, sp.numpy())
    np.testing.assert_array_equal(zt, zp.numpy())


def test_backpointer_guard(monkeypatch):
    """Past the int32 backpointer budget the call raises naming it, as the
    JAX package's does (its own test monkeypatches the same constant)."""
    fj, ft, spdf, _ = hmm_pair(55, 6, 3)
    ct = compile_port(ft, spdf, 3, strategy="segment")
    monkeypatch.setattr(tvit, "_BP_MEM_BYTES", 100)
    with pytest.raises(ValueError, match="backpointer stream.*Nf=31 x Sp=8"):
        mt.viterbi(ct, torch.zeros((1, 30, 3)))


@pytest.mark.parametrize("strategy,stacked", [
    ("segment", False), ("ell", False), ("block", False), ("banded", True)])
def test_maxstateposteriors_matches_jax(strategy, stacked):
    """(B, N, Sp) against the JAX package's, and the best path's states at
    0 with nothing above it."""
    P, N = 3, 15
    if stacked:
        gj = numerators(np.random.default_rng(6), 3, P, [4, 6, 5])
        gt = numerators(np.random.default_rng(6), 3, P, [4, 6, 5], lib=mt)
        cj = inf.stack([inf.compile_fsm(f, s, P, strategy=strategy)
                        for f, s in gj])
        ct = mt.stack([compile_port(f, s, P, strategy=strategy)
                       for f, s in gt])
    else:
        fj, ft, spdf, _ = hmm_pair(56, 5, P, lr=False, to_final=True)
        cj, ct = both(fj, ft, spdf, P, strategy=strategy)
    lhs = np.random.default_rng(57).normal(size=(3, N, P)).astype(np.float32)
    lens = np.array([N, 9, 12], dtype=np.int32)
    gj, zj = jvit.maxstateposteriors(cj, jnp.asarray(lhs), jnp.asarray(lens))
    gt, zt = mt.maxstateposteriors(ct, torch.from_numpy(lhs),
                                   torch.from_numpy(lens))
    gj, gt = np.asarray(gj), gt.numpy()
    assert gt.shape == (3, N, ct.padded_states)
    assert (np.isneginf(gt) == np.isneginf(gj)).all()
    fin = np.isfinite(gj)
    np.testing.assert_allclose(gt[fin], gj[fin], atol=1e-4, rtol=0)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL_SCORE)
    if strategy != "block":  # block decodes report host ids
        states, score = mt.viterbi(ct, torch.from_numpy(lhs),
                                   torch.from_numpy(lens))
        np.testing.assert_allclose(score.numpy(), zt.numpy(), atol=1e-5)
        for b, L in enumerate(lens):
            on = gt[b, np.arange(L), states[b, :L].numpy()]
            np.testing.assert_allclose(on, 0.0, atol=1e-4)
            assert gt[b, :L].max() <= 1e-4


def test_maxstateposteriors_guard(monkeypatch):
    """The (B, N, Sp) result is checked against the 6 GB budget before
    anything is allocated; the error names Nf, Sp and B."""
    fj, ft, spdf, _ = hmm_pair(58, 6, 3)
    ct = compile_port(ft, spdf, 3, strategy="segment")
    monkeypatch.setattr(tvit, "_BP_MEM_BYTES", 1000)
    with pytest.raises(ValueError, match=r"Nf=31 x Sp=8 x B=2"):
        mt.maxstateposteriors(ct, torch.zeros((2, 30, 3)))
    g, _ = mt.maxstateposteriors(ct, torch.zeros((1, 3, 3)))
    assert g.shape == (1, 3, 8)
