"""The port's compile_fsm against the JAX package's: every field, the plan
metadata included, exactly equal; and compiled_from_numpy round trips.

V=128 takes the affine tier descriptors of the fused path; V=16, 32 and 64
take the gather/scatter, two-tier and stride-192 branches."""
import pytest
import torch

import markovmodels_tpu_torch as mt
from _torch_port import (assert_same_compiled, jax_compiled, lm_graph,
                         port_from_jax)


@pytest.mark.parametrize("V", [16, 32, 64, 128])
def test_compile_matches_jax(V):
    fsm, spdf, P, _ = lm_graph(V)
    ct = mt.compile_fsm(fsm, spdf, P, strategy="block", precision="high")
    assert_same_compiled(jax_compiled(V), ct)


def test_compile_matches_jax_without_reorder():
    """reorder='none' keeps host order and builds the one-hot Ĉᵀ."""
    fsm, spdf, P, _ = lm_graph(16)
    ct = mt.compile_fsm(fsm, spdf, P, reorder="none")
    assert ct.pdf_group == () and ct.pdf_onehot is not None
    assert_same_compiled(jax_compiled(16, "none"), ct)


@pytest.mark.parametrize("V", [32, 128])
def test_compiled_from_numpy_round_trips(V):
    cj = jax_compiled(V)
    ct = port_from_jax(cj)
    assert_same_compiled(cj, ct)
    assert_same_compiled(cj, ct.to("cpu"))


@pytest.mark.parametrize("kw", [
    dict(precision="bf16"),
    dict(dtype=torch.float64),
    dict(strategy="dense"),
    dict(domain="log"),
    dict(ov_cap=64),
])
def test_compile_names_what_is_not_ported(kw):
    fsm, spdf, P, _ = lm_graph(128 if "ov_cap" in kw else 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.compile_fsm(fsm, spdf, P, **kw)


def test_compiled_to_moves_every_tensor():
    ct = port_from_jax(jax_compiled(16))
    moved = ct.to("meta")
    tensors = [moved.alpha_hat, moved.state_pdf, moved.fwd_w,
               moved.omega_prob, moved.orig_state, moved.block_fwd.band_w,
               *moved.block_fwd.tiers[0], *moved.block_bwd.tiers[0]]
    assert all(t.device.type == "meta" for t in tensors)
    assert moved.device.type == "meta" and ct.device.type == "cpu"
    assert moved.final_state == ct.final_state
    assert moved.block_fwd_offsets == ct.block_fwd_offsets
