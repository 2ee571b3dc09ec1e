"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: graphs, seeded inputs, and the conversion of a JAX CompiledFSM
into numpy fields for ``compiled_from_numpy``."""
import functools

import jax
import numpy as np
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu.workloads import make_lm_hmm_graph

DATA_FIELDS = (
    "alpha_hat", "final_state", "state_pdf", "fwd_src", "fwd_dst", "fwd_w",
    "bwd_src", "bwd_dst", "bwd_w", "pdf_onehot", "block_fwd", "block_bwd",
    "omega_prob", "orig_state",
)
META_FIELDS = (
    "num_states", "num_pdfs", "strategy", "batched", "precision", "domain",
    "block_fwd_offsets", "block_bwd_offsets", "pdf_group", "multi_pdf",
    "ov_layout", "banded_offsets",
)
# fields of the JAX CompiledFSM that the 'block' strategy leaves empty
JAX_ONLY_NONE = (
    "ell_fwd_src", "ell_fwd_w", "ell_bwd_src", "ell_bwd_w", "dense_fwd_exp",
    "dense_fwd_max", "dense_bwd_exp", "dense_bwd_max", "banded_fwd",
    "banded_bwd",
)


@functools.lru_cache(maxsize=None)
def lm_graph(V):
    return make_lm_hmm_graph(V=V)


@functools.lru_cache(maxsize=None)
def jax_compiled(V, reorder="auto"):
    fsm, spdf, P, _ = lm_graph(V)
    return inf.compile_fsm(fsm, spdf, P, strategy="block", reorder=reorder)


def jax_fields(cf):
    fields = {n: jax.tree.map(np.asarray, getattr(cf, n)) for n in DATA_FIELDS}
    meta = {n: getattr(cf, n) for n in META_FIELDS}
    return fields, meta


def port_from_jax(cf):
    return mt.compiled_from_numpy(*jax_fields(cf))


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


def assert_same_compiled(cj, ct):
    """Every field of the port's CompiledFSM equals the JAX one's."""
    for n in JAX_ONLY_NONE:
        assert getattr(cj, n) is None, n
    assert ct.final_state == int(cj.final_state)
    for n in ("alpha_hat", "state_pdf", "fwd_src", "fwd_dst", "fwd_w",
              "bwd_src", "bwd_dst", "bwd_w", "omega_prob", "orig_state"):
        assert_tensor_equal(getattr(cj, n), getattr(ct, n), n)
    if cj.pdf_onehot is None:
        assert ct.pdf_onehot is None
    else:
        assert_tensor_equal(cj.pdf_onehot, ct.pdf_onehot, "pdf_onehot")
    for n in ("block_fwd", "block_bwd"):
        oj, ot = getattr(cj, n), getattr(ct, n)
        for part in ("band_w", "res_src", "res_dst", "res_w"):
            a, b = getattr(oj, part), getattr(ot, part)
            assert (a is None) == (b is None), (n, part)
            if a is not None:
                assert_tensor_equal(a, b, f"{n}.{part}")
        assert len(oj.tiers) == len(ot.tiers), n
        for i, (tj, tt) in enumerate(zip(oj.tiers, ot.tiers)):
            for a, b, part in zip(tj, tt, ("src", "dst", "W")):
                assert_tensor_equal(a, b, f"{n}.tiers[{i}].{part}")
        assert tuple(oj.ov_w) == tuple(ot.ov_w) == ()
    for n in META_FIELDS:
        assert getattr(ct, n) == getattr(cj, n), n
