"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: graphs (each package builds its own from its own host layer),
seeded inputs, compiling for the CPU, and the conversion of a JAX
CompiledFSM into numpy fields for ``compiled_from_numpy``.

The port compiles to the card by default; every helper here asks for the
CPU, where the port's kernels take their plain PyTorch twins."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import markovmodels_tpu as mm
import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu.workloads import make_lm_hmm_graph
from tests.test_inference import make_hmm

DATA_FIELDS = (
    "alpha_hat", "final_state", "state_pdf", "fwd_src", "fwd_dst", "fwd_w",
    "bwd_src", "bwd_dst", "bwd_w", "pdf_onehot", "block_fwd", "block_bwd",
    "omega_prob", "orig_state", "banded_fwd", "banded_bwd", "dense_fwd_exp",
    "dense_fwd_max", "dense_bwd_exp", "dense_bwd_max", "ell_fwd_src",
    "ell_fwd_w", "ell_bwd_src", "ell_bwd_w",
)
META_FIELDS = (
    "num_states", "num_pdfs", "strategy", "batched", "precision", "domain",
    "block_fwd_offsets", "block_bwd_offsets", "pdf_group", "multi_pdf",
    "ov_layout", "banded_offsets",
)
# The port computes the 'dense' exp-shifted operators with torch's float32
# exp, the JAX package with XLA's: on the lm_graph(8) and lm_graph(16)
# operators they differ by at most 1 ulp, in 5-7 % of the non-zero
# entries (the row maxima and every index array are bit-equal).
EXP_ULPS = 1


@functools.lru_cache(maxsize=None)
def lm_graph(V):
    """The JAX package's V-word LM ∘ HMM graph."""
    return make_lm_hmm_graph(V=V)


@functools.lru_cache(maxsize=None)
def port_lm_graph(V):
    """The same graph built by the port's own host layer."""
    return mt.workloads.make_lm_hmm_graph(V=V)


def compile_port(fsm, spdf, P, **kw):
    """The port's compile_fsm, on the CPU."""
    return mt.compile_fsm(fsm, spdf, P, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def jax_compiled(V, reorder="auto", strategy="block"):
    fsm, spdf, P, _ = lm_graph(V)
    return inf.compile_fsm(fsm, spdf, P, strategy=strategy, reorder=reorder)


def jax_fields(cf):
    fields = {n: jax.tree.map(np.asarray, getattr(cf, n)) for n in DATA_FIELDS}
    meta = {n: getattr(cf, n) for n in META_FIELDS}
    return fields, meta


def port_from_jax(cf):
    return mt.compiled_from_numpy(*jax_fields(cf), device="cpu")


def numerator(seq, P, skip=False, lib=mm):
    """A linear numerator lattice over the pdf sequence ``seq`` (self-loop
    and chain arcs at 0.5, final weight 0.5; the shape ``bench.py`` builds)
    and its state->pdf map; ``skip`` adds arcs i -> i+2 at 0.25.  ``lib``:
    the package whose host layer builds the FSM (``mm`` or ``mt``)."""
    L = len(seq)
    arcs = [((i, i), np.log(0.5)) for i in range(L)]
    arcs += [((i, i + 1), np.log(0.5)) for i in range(L - 1)]
    if skip:
        arcs += [((i, i + 2), np.log(0.25)) for i in range(L - 2)]
    fsm = lib.fsm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(L - 1, np.log(0.5))],
        [lib.labels.Label(int(s)) for s in seq], lib.semiring.LOG)
    return fsm, np.append(seq, P).astype(np.int32)


def numerators(rng, G, P, lengths, skip=(), lib=mm):
    """G random numerators of the given lattice lengths (graph indices in
    ``skip`` get skip arcs): [(fsm, spdf)], built by ``lib``."""
    return [numerator(rng.integers(0, P, size=lengths[g]), P, g in skip, lib)
            for g in range(G)]


def random_graph(rng, S, P, lib=mm):
    """A non-banded graph: S states, three random out-arcs each (mass
    0.8), initial state 0, final weight 0.2 on every state, random pdfs.
    Returns (fsm, spdf), built by ``lib``."""
    arcs = []
    for i in range(S):
        js = rng.choice(S, size=3, replace=False)
        w = rng.uniform(0.1, 1.0, size=3)
        w *= 0.8 / w.sum()
        arcs += [((i, int(j)), float(np.log(x))) for j, x in zip(js, w)]
    pdfs = rng.integers(0, P, size=S)
    fsm = lib.fsm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(i, np.log(0.2)) for i in range(S)],
        [lib.labels.Label(int(p)) for p in pdfs], lib.semiring.LOG)
    return fsm, np.append(pdfs, P).astype(np.int32)


def hmm_pair(seed, S, P, lr=True, to_final=False):
    """``make_hmm`` for both packages: (JAX fsm, port fsm, spdf, (alpha, T,
    omega)); ``to_final`` adds an arc of weight 0.05 from every state to
    the last one (every state then reaches the end)."""
    rng = np.random.default_rng(seed)
    fj, spdf, (alpha, T, omega) = make_hmm(rng, S, P, lr=lr)
    if to_final:
        T = T.copy()
        T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
        fj = mm.FSM.from_parts(alpha, mm.hostsparse.spmat_from_dense(
            T, mm.LOG), omega, fj.labels, mm.LOG)
    ft = mt.fsm.FSM.from_parts(
        alpha, mt.hostsparse.spmat_from_dense(T, mt.LOG), omega,
        [mt.labels.Label(i % P) for i in range(S)], mt.LOG)
    return fj, ft, spdf, (alpha, T, omega)


def both(fj, ft, spdf, P, dtype=torch.float32, **kw):
    """(JAX compile, port compile) of one graph; float64 inside
    ``jax.enable_x64``."""
    if dtype == torch.float64:
        with jax.enable_x64(True):
            cj = inf.compile_fsm(fj, spdf, P, dtype=jnp.float64, **kw)
    else:
        cj = inf.compile_fsm(fj, spdf, P, **kw)
    return cj, compile_port(ft, spdf, P, dtype=dtype, **kw)


def inputs(B, N, P, seed, lens, cliffs=False):
    """Seeded (lhs (B, N, P) float32, lengths (B,) int32) as numpy; with
    ``cliffs``, ±30-nat emission cliffs (+30 on plane-2 pdfs, unreachable
    before frame 2, on frames 0-1; -30 on planes 1-2 mid-sequence)."""
    rng = np.random.default_rng(seed)
    lhs = (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)
    if cliffs:
        planes = np.arange(P).reshape(-1, 3)
        lhs[:, 0:2, planes[:, 2]] += 30.0
        lhs[:, N // 2, planes[:, 1:].ravel()] -= 30.0
    return lhs, np.asarray(lens, dtype=np.int32)


def assert_tensor_equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True), what


def ulps(a, b):
    """Largest distance in units in the last place between two arrays of
    non-negative finite values of one dtype, float32 or float64."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.dtype in (np.float32, np.float64)
    assert a.shape == b.shape
    assert (a >= 0).all() and (b >= 0).all()
    it = np.int32 if a.dtype == np.float32 else np.int64
    # non-negative floats order as their bits: the difference of the bits
    # counts the representable values between them
    d = a.view(it).astype(np.int64) - b.view(it).astype(np.int64)
    return int(np.abs(d).max(initial=0))


def assert_same_compiled(cj, ct):
    """Every field of the port's CompiledFSM equals the JAX one's, dtype
    included (float32 or float64, the one-hot Ĉᵀ float32 in both), the
    domain among the metadata; the 'dense' exp-shifted operators within
    EXP_ULPS of their dtype."""
    if cj.batched:
        assert_tensor_equal(cj.final_state, ct.final_state, "final_state")
    else:
        assert isinstance(ct.final_state, int)
        assert ct.final_state == int(cj.final_state)
    for n in ("alpha_hat", "state_pdf", "fwd_src", "fwd_dst", "fwd_w",
              "bwd_src", "bwd_dst", "bwd_w", "orig_state"):
        assert_tensor_equal(getattr(cj, n), getattr(ct, n), n)
    for n in ("pdf_onehot", "omega_prob", "banded_fwd", "banded_bwd",
              "dense_fwd_max", "dense_bwd_max", "ell_fwd_src", "ell_fwd_w",
              "ell_bwd_src", "ell_bwd_w"):
        if getattr(cj, n) is None:
            assert getattr(ct, n) is None, n
        else:
            assert_tensor_equal(getattr(cj, n), getattr(ct, n), n)
    for n in ("dense_fwd_exp", "dense_bwd_exp"):
        if getattr(cj, n) is None:
            assert getattr(ct, n) is None, n
        else:
            assert ulps(getattr(cj, n), getattr(ct, n)) <= EXP_ULPS, n
    for n in ("block_fwd", "block_bwd"):
        oj, ot = getattr(cj, n), getattr(ct, n)
        assert (oj is None) == (ot is None), n
        if oj is None:
            continue
        for part in ("band_w", "res_src", "res_dst", "res_w"):
            a, b = getattr(oj, part), getattr(ot, part)
            assert (a is None) == (b is None), (n, part)
            if a is not None:
                assert_tensor_equal(a, b, f"{n}.{part}")
        assert len(oj.tiers) == len(ot.tiers), n
        for i, (tj, tt) in enumerate(zip(oj.tiers, ot.tiers)):
            for a, b, part in zip(tj, tt, ("src", "dst", "W")):
                assert_tensor_equal(a, b, f"{n}.tiers[{i}].{part}")
        assert len(oj.ov_w) == len(ot.ov_w), n
        for i, (a, b) in enumerate(zip(oj.ov_w, ot.ov_w)):
            assert_tensor_equal(a, b, f"{n}.ov_w[{i}]")
    for n in META_FIELDS:
        assert getattr(ct, n) == getattr(cj, n), n
