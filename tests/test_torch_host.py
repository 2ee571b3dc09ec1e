"""The port's own host layer and f64 oracle against the JAX package's.

The port keeps its own copies of the host layer (FSMs, semirings, labels,
FSM operations, n-gram LMs, host sparse algebra, the native runtime, the
workload graphs) and of the benchmark's float64 oracles
(``markovmodels_tpu_torch.oracle``).  Each package builds its own graphs
here from the same inputs, and the results must be bit-equal."""
import os

import numpy as np
import pytest

import bench
import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from _torch_port import lm_graph, numerator, port_lm_graph


def _assert_same_fsm(fj, ft):
    """alpha_hat, the T_hat triplets, omega, labels and semiring equal."""
    assert type(ft) is mt.fsm.FSM and type(fj) is mm.fsm.FSM
    assert ft.sr.name == fj.sr.name
    assert ft.alpha_hat.dtype == fj.alpha_hat.dtype
    assert np.array_equal(ft.alpha_hat, fj.alpha_hat)
    for a, b in zip(mt.hostsparse.findnz(ft.T_hat),
                    mm.hostsparse.findnz(fj.T_hat)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ft.T_hat.shape == fj.T_hat.shape
    assert np.array_equal(ft.omega, fj.omega)
    assert [tuple(x) for x in ft.labels] == [tuple(x) for x in fj.labels]


@pytest.mark.parametrize("V", [8, 16, 128])
def test_workload_graphs_are_bit_equal(V):
    fj, sj, pj, ij = lm_graph(V)
    ft, st, pt, it = port_lm_graph(V)
    _assert_same_fsm(fj, ft)
    assert st.dtype == sj.dtype and np.array_equal(st, sj)
    assert pt == pj and it == ij


def test_port_host_layer_is_its_own():
    """The port's host modules are its copies, not the JAX package's, and
    the native runtime caches its build apart from the JAX package's."""
    for name in ("algorithms", "fsm", "fsmops", "hostsparse", "labels",
                 "lmfsm", "native", "semiring", "workloads", "oracle"):
        mod = getattr(mt, name)
        assert mod.__name__ == f"markovmodels_tpu_torch.{name}", name
    assert mt.native._cache_dir() != mm.native._cache_dir()
    assert os.path.basename(mt.native._cache_dir()) == "markovmodels_tpu_torch"


def _hmm(lib, pdf0, sr):
    arcs = [((i, i), np.log(0.5)) for i in range(3)]
    arcs += [((i, i + 1), np.log(0.5)) for i in range(2)]
    return lib.fsm.FSM.from_pairs(
        [(0, sr.one)], arcs, [(2, np.log(0.5))],
        [lib.labels.Label(pdf0 + k) for k in range(3)], sr)


def _sentence(lib, words, sr):
    n = len(words)
    return lib.fsm.FSM.from_pairs(
        [(0, sr.one)], [((i, i + 1), sr.one) for i in range(n - 1)],
        [(n - 1, sr.one)], [lib.labels.Label(w) for w in words], sr)


def _lm(lib, order):
    sr = lib.semiring.LOG
    stats = {}
    for words in (["a", "b", "a"], ["a", "b"], ["b", "a", "a"], ["b"]):
        stats = lib.lmfsm.merge_ngrams(
            stats, lib.lmfsm.totalngramsum(_sentence(lib, words, sr), order),
            sr)
    return lib.lmfsm.language_model_fsm(stats, sr)


@pytest.mark.parametrize("op", ["union", "concat", "compose", "lm2", "lm3"])
def test_fsmops_and_lmfsm_are_bit_equal(op):
    def build(lib):
        sr = lib.semiring.LOG
        a = numerator(np.array([3, 1, 4, 1]), 8, lib=lib)[0]
        b = numerator(np.array([5, 9, 2]), 8, skip=True, lib=lib)[0]
        if op == "union":
            return lib.fsmops.union(a, b)
        if op == "concat":
            return lib.fsmops.concat(a, b, a)
        if op == "compose":
            hmms = {lib.labels.Label("a"): _hmm(lib, 0, sr),
                    lib.labels.Label("b"): _hmm(lib, 3, sr)}
            return lib.fsmops.compose(_lm(lib, 2), hmms)
        return _lm(lib, int(op[-1]))

    _assert_same_fsm(build(mm), build(mt))


@pytest.fixture(scope="module")
def small_graph():
    return lm_graph(8), port_lm_graph(8)


def test_host_oracle_matches_the_benchmarks(small_graph):
    (fj, sj, P, _), (ft, st, _, _) = small_graph
    rng = np.random.default_rng(3)
    lhs = rng.normal(size=(3, 9, P))
    lens = np.array([9, 4, 1], dtype=np.int32)
    zj, pj = bench.host_oracle(fj, sj, P, lhs, lens)
    zt, pt = mt.oracle.host_oracle(ft, st, P, lhs, lens)
    assert np.array_equal(zt, zj) and np.array_equal(pt, pj)
    assert np.isneginf(zt[2]) and np.isfinite(zt[:2]).all()


def test_host_viterbi_score_and_path_check_match_the_benchmarks(small_graph):
    (fj, sj, P, _), (ft, st, _, _) = small_graph
    rng = np.random.default_rng(4)
    lhs = rng.normal(size=(2, 7, P))
    lens = np.array([7, 5], dtype=np.int32)
    vj = bench.host_viterbi_score(fj, sj, P, lhs, lens)
    vt = mt.oracle.host_viterbi_score(ft, st, P, lhs, lens)
    assert np.array_equal(vt, vj) and np.isfinite(vt).all()
    # valid paths through the HMM of history 0 (plane-major layout: state
    # k·H + h, H = V² = 64): both checks return the same (finite) gap
    path = np.array([[0, 0, 64, 64, 128, 128, 128],
                     [0, 64, 128, 128, 128, 0, 0]], dtype=np.int64)
    w = bench._validate_paths_full(fj, sj, lhs, lens, path,
                                   np.zeros(2), atol=np.inf)
    assert np.isfinite(w)
    assert mt.oracle.validate_paths(ft, st, lhs, lens, path, np.zeros(2),
                                    atol=np.inf) == w
    with pytest.raises(AssertionError, match="decoded path weight"):
        mt.oracle.validate_paths(ft, st, lhs, lens, path, np.zeros(2))
