"""General Ĉ (a state emitting several pdfs, reference src/inference.jl:7-8)
in the port, against the JAX package on the CPU, on the graphs of the JAX
package's own tests (``tests/test_inference.py``
``test_general_statemap_multi_pdf`` and ``tests/test_viterbi.py``
``test_viterbi_general_statemap_multi_pdf``), 'dense' and 'block':

* the compile equals the JAX package's, the binary Ĉᵀ (several ones per
  column) and the representative pdfs included;
* posteriors and logZ against the JAX package and against the pdf-set
  oracle (a state's emission the logsumexp over its set, a pdf's
  posterior the sum of the gammas of the states whose set holds it, over
  the pdf-space total), at the JAX test's tolerances; the same in
  float64 at the float64 bound;
* the Viterbi decode (a state's emission the max over its set) against the
  JAX package's, paths exact, and against the max-plus oracle;
* stacked general-Ĉ 'dense' graphs; the plain route on the card (no
  kernel takes a general Ĉ), decided before any launch; and the
  ``ValueError``s of the JAX package's rules ('banded', the log domain,
  the phony row, the shape, the size of the binary Ĉᵀ).

Each package builds the FSM from the same numpy arrays with its own host
layer."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import hostsparse as hs
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as jvit
from markovmodels_tpu_torch import inference as tinf
from tests.test_inference import make_hmm
from _torch_port import assert_same_compiled, compile_port

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

S, P = 6, 4
# state 1 emits pdfs {0, 2}, state 3 {1, 2, 3}, the rest one pdf each, the
# phony state the phony pdf
PDF_SETS = [[2], [0, 2], [3], [1, 2, 3], [0], [1], [P]]
TOL_LOGZ, TOL_LOGZ_REL, TOL_POSTS = 2e-4, 1e-5, 1e-5  # the JAX test's
TOL_SCORE = 1e-4  # test_viterbi.py's
TOL_F64 = 1e-8


def _graphs(seed, viterbi=False):
    """(JAX FSM, port FSM, JAX Ĉ, port Ĉ, (alpha, T, omega)) of the JAX
    test's graph."""
    rng = np.random.default_rng(seed)
    fsm, _, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    if viterbi:  # test_viterbi.py's variant: every state reaches S-1
        T = T.copy()
        T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
        fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG),
                                omega, fsm.labels, mm.LOG)
    fsm_t = mt.fsm.FSM.from_parts(
        alpha, mt.hostsparse.spmat_from_dense(T, mt.LOG), omega,
        [mt.labels.Label(i % P) for i in range(S)], mt.LOG)
    rows = np.repeat(np.arange(S + 1), [len(s) for s in PDF_SETS])
    cols = np.concatenate([np.array(s) for s in PDF_SETS])
    Cj = hs.spmat_from_coo(rows, cols, np.zeros(len(rows)), (S + 1, P + 1),
                           mm.LOG)
    Ct = mt.hostsparse.spmat_from_coo(rows, cols, np.zeros(len(rows)),
                                      (S + 1, P + 1), mt.LOG)
    return fsm, fsm_t, Cj, Ct, (alpha, T, omega)


def _oracle(alpha, T, omega, ll):
    """(logZ, posteriors (L, P)) of one sequence ``ll`` (L, P), float64:
    the JAX test's pdf-set oracle."""
    L = len(ll)
    lhs_state = np.array([logsumexp(ll[:, ps], axis=1)
                          for ps in PDF_SETS[:S]]).T
    logA = np.full((L, S), -np.inf)
    logA[0] = alpha + lhs_state[0]
    for t in range(1, L):
        logA[t] = logsumexp(logA[t - 1][:, None] + T, axis=0) + lhs_state[t]
    logB = np.full((L, S), -np.inf)
    logB[L - 1] = omega
    for t in range(L - 2, -1, -1):
        logB[t] = logsumexp(T + (lhs_state[t + 1] + logB[t + 1])[None, :],
                            axis=1)
    z = logsumexp(logA[L - 1] + omega)
    gamma = np.exp(logA + logB - z)
    gp = np.zeros((L, P + 1))
    for s_, ps in enumerate(PDF_SETS[:S]):
        for p in ps:
            gp[:, p] += gamma[:, s_]
    return z, gp[:, :P] / gp.sum(axis=1, keepdims=True)


def _viterbi_oracle(alpha, T, omega, ll):
    """The best score of one sequence under the max emission."""
    emis = np.stack([np.max(ll[:, PDF_SETS[s]], axis=1) for s in range(S)],
                    axis=1)
    delta = alpha + emis[0]
    for t in range(1, len(ll)):
        delta = np.max(delta[:, None] + T, axis=0) + emis[t]
    return np.max(delta + omega)


@pytest.fixture(scope="module", params=["dense", "block"])
def compiled(request):
    fsm, fsm_t, Cj, Ct, arrays = _graphs(31)
    cj = inf.compile_fsm(fsm, Cj, P, strategy=request.param)
    ct = compile_port(fsm_t, Ct, P, strategy=request.param)
    return request.param, cj, ct, fsm_t, Ct, arrays


def test_compile_matches_jax(compiled):
    strategy, cj, ct, _, _, _ = compiled
    assert cj.multi_pdf and ct.multi_pdf and ct.strategy == strategy
    assert not ct.pdf_group and not ct.ov_layout  # reorder='none'
    oh = ct.pdf_onehot.numpy()
    for s_, ps in enumerate(PDF_SETS):
        assert set(np.flatnonzero(oh[:, s_])) == set(ps)
    assert (ct.state_pdf.numpy()[:S + 1] == [2, 0, 3, 1, 0, 1, P]).all()
    assert_same_compiled(cj, ct)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_posteriors_match_jax_and_the_pdf_set_oracle(compiled, dtype):
    strategy, cj, ct, fsm_t, Ct, (alpha, T, omega) = compiled
    if dtype == torch.float64:
        ct = compile_port(fsm_t, Ct, P, strategy=strategy, dtype=dtype)
    rng = np.random.default_rng(31)
    make_hmm(rng, S, P, lr=False)  # the JAX test's draws, in its order
    loglik = rng.normal(size=(2, 18, P)).astype(np.float32)
    lengths = np.array([18, 9], dtype=np.int32)
    posts, logz = mt.pdfposteriors(ct, torch.from_numpy(loglik).to(dtype),
                                   torch.from_numpy(lengths), chunk_size=8)
    posts, logz = posts.numpy(), logz.numpy()
    pj, zj = inf.pdfposteriors(cj, jnp.asarray(loglik), jnp.asarray(lengths),
                               chunk_size=8)
    for b, L in enumerate(lengths):
        z, p = _oracle(alpha, T, omega, loglik[b, :L].astype(np.float64))
        if dtype == torch.float64:
            assert abs(logz[b] - z) <= TOL_F64
            assert np.abs(posts[b, :L] - p).max() <= TOL_F64
        else:
            np.testing.assert_allclose(logz[b], z, atol=TOL_LOGZ,
                                       rtol=TOL_LOGZ_REL)
            np.testing.assert_allclose(posts[b, :L], p, atol=TOL_POSTS)
        np.testing.assert_allclose(logz[b], np.asarray(zj)[b],
                                   atol=TOL_LOGZ, rtol=TOL_LOGZ_REL)
        np.testing.assert_allclose(posts[b], np.asarray(pj)[b],
                                   atol=TOL_POSTS)
        assert (posts[b, L:] == 0).all()


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_viterbi_max_lift_matches_jax(strategy):
    fsm, fsm_t, Cj, Ct, (alpha, T, omega) = _graphs(19, viterbi=True)
    rng = np.random.default_rng(19)
    make_hmm(rng, S, P, lr=False)
    loglik = rng.normal(size=(2, 20, P)).astype(np.float32)
    lengths = np.array([20, 11], dtype=np.int32)
    cj = inf.compile_fsm(fsm, Cj, P, strategy=strategy)
    sj, zj = jvit.viterbi(cj, jnp.asarray(loglik), jnp.asarray(lengths))
    for dtype, tol in ((torch.float32, TOL_SCORE), (torch.float64, TOL_F64)):
        ct = compile_port(fsm_t, Ct, P, strategy=strategy, dtype=dtype)
        states, score = mt.viterbi(ct, torch.from_numpy(loglik).to(dtype),
                                   torch.from_numpy(lengths))
        np.testing.assert_array_equal(states.numpy(), np.asarray(sj))
        np.testing.assert_allclose(score.numpy(), np.asarray(zj),
                                   atol=TOL_SCORE)
        for b, L in enumerate(lengths):
            ll = loglik[b, :L].astype(np.float64)
            ref = _viterbi_oracle(alpha, T, omega, ll)
            assert abs(score[b].item() - ref) <= tol
            path = states[b, :L].numpy()
            emis = [max(ll[t, q] for q in PDF_SETS[path[t]])
                    for t in range(L)]
            w = alpha[path[0]] + emis[0] + omega[path[L - 1]] + sum(
                T[path[t - 1], path[t]] + emis[t] for t in range(1, L))
            assert abs(w - ref) <= tol
            assert (states[b, L:].numpy() == ct.num_states - 1).all()


def test_stacked_dense_graphs_keep_the_pdf_sets():
    """A stack of general-Ĉ 'dense' graphs (the JAX package's stack drops
    the flag; the port keeps it): each column equals its graph alone."""
    _, fsm_t, _, Ct, _ = _graphs(31)
    ct = compile_port(fsm_t, Ct, P, strategy="dense", dtype=torch.float64)
    st = mt.stack([ct, ct])
    assert st.multi_pdf and st.batched
    rng = np.random.default_rng(7)
    lhs = torch.from_numpy(rng.normal(size=(2, 10, P)))
    lens = torch.tensor([10, 6], dtype=torch.int32)
    ps, zs = mt.pdfposteriors(st, lhs, lens)
    p1, z1 = mt.pdfposteriors(ct, lhs, lens)
    np.testing.assert_allclose(zs.numpy(), z1.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ps.numpy(), p1.numpy(), rtol=0, atol=1e-12)


def test_the_card_refuses_general_c_hat(compiled):
    """Decided without a card: no kernel takes a general-Ĉ graph, so on
    the card the scan takes the plain route ``_fb_prob`` (the JAX
    package's XLA scan), naming the kernels' first refused predicate, and
    the decode the plain twins on the lifted inputs; the kernels' own
    admissions refuse it."""
    strategy, _, ct, _, _, _ = compiled
    reason = tinf._plain_on_card(ct, "cuda", 2)
    want = ("general multi-pdf C-hat" if strategy == "dense" else
            "no uniform pdf-grouped layout (compile_fsm reorder declined or "
            "disabled)")
    assert reason == want
    assert tinf._plain_on_card(ct, "cpu", 2) is None
    report = tinf.fast_path_report(ct, 2, device="cuda")
    assert report == tinf._plain_on_card_line(ct, want)
    assert report.startswith(f"plain torch scan on the card (one "
                             f"{strategy!r} graph") and not \
        report.startswith("error - ")
    with pytest.raises(ValueError):
        tinf._kernel_route(ct, "cuda", 2)
    lhs = torch.empty((2, 5, P), device="meta")
    assert tvit._plain_decode(ct, lhs).startswith(
        "general multi-pdf C-hat graph")
    cpu = torch.empty((2, 5, P))
    assert tvit._plain_decode(ct, cpu) == tvit._plain_decode(ct, lhs)


@pytest.mark.parametrize("case", ["banded", "log", "phony row", "two phony",
                                  "shape", "size"])
def test_the_jax_rules_raise(case):
    """The JAX package's ValueErrors, in its words, from both packages."""
    fsm, fsm_t, Cj, Ct, _ = _graphs(31)
    kw, num_pdfs = dict(strategy="dense"), P
    sets = list(PDF_SETS)
    if case == "banded":
        kw = dict(strategy="banded")
    elif case == "log":
        kw = dict(domain="log")
    elif case == "phony row":
        sets[S] = [0]
    elif case == "two phony":
        sets[S] = [0, P]
    elif case == "size":  # (P+1)·Sp past 64 Mi: 128 padded states
        num_pdfs = 64 * 1024 * 1024 // 128
        sets[S] = [num_pdfs]
    rows = np.repeat(np.arange(S + 1), [len(s) for s in sets])
    cols = np.concatenate([np.array(s) for s in sets])
    shape = (S + 1, num_pdfs + 1) if case != "shape" else (S + 1, P + 2)
    Cj = hs.spmat_from_coo(rows, cols, np.zeros(len(rows)), shape, mm.LOG)
    Ct = mt.hostsparse.spmat_from_coo(rows, cols, np.zeros(len(rows)), shape,
                                      mt.LOG)
    match = {"banded": "'dense' or 'block' strategy", "log": "domain='prob'",
             "phony row": "phony row", "two phony": "phony row",
             "shape": "must have shape", "size": "exceeds the size limit"}
    with pytest.raises(ValueError, match=match[case]) as ej:
        inf.compile_fsm(fsm, Cj, num_pdfs, **kw)
    with pytest.raises(ValueError, match=match[case]) as et:
        compile_port(fsm_t, Ct, num_pdfs, **kw)
    assert str(ej.value) == str(et.value)
