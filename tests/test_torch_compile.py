"""The port's compile_fsm against the JAX package's: every field, the plan
metadata included, exactly equal; compiled_from_numpy round trips; and the
default strategy ('auto') picks what the JAX package picks.

V=128 takes the affine tier descriptors of the fused path; V=16, 32 and 64
take the gather/scatter, two-tier and stride-192 branches."""
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from _torch_port import (assert_same_compiled, compile_port, jax_compiled,
                         jax_fields, lm_graph, port_from_jax, port_lm_graph)


@pytest.mark.parametrize("V", [16, 32, 64, 128])
def test_compile_matches_jax(V):
    fsm, spdf, P, _ = port_lm_graph(V)
    ct = compile_port(fsm, spdf, P, strategy="block", precision="high")
    assert_same_compiled(jax_compiled(V), ct)


def test_compile_matches_jax_without_reorder():
    """reorder='none' keeps host order and builds the one-hot Ĉᵀ."""
    fsm, spdf, P, _ = port_lm_graph(16)
    ct = compile_port(fsm, spdf, P, strategy="block", reorder="none")
    assert ct.pdf_group == () and ct.pdf_onehot is not None
    assert_same_compiled(jax_compiled(16, "none"), ct)


@pytest.mark.parametrize("V", [16, 128])
def test_default_strategy_matches_jax(V):
    """compile_fsm's default is the JAX package's 'auto': 'dense' up to
    4,096 states (V=16: 769), 'block' beyond (V=128: 49,153)."""
    cj = inf.compile_fsm(*lm_graph(V)[:3])
    ct = compile_port(*port_lm_graph(V)[:3])
    assert ct.strategy == cj.strategy == ("dense" if V == 16 else "block")
    assert_same_compiled(cj, ct)


@pytest.mark.parametrize("V", [32, 128])
def test_compiled_from_numpy_round_trips(V):
    cj = jax_compiled(V)
    ct = port_from_jax(cj)
    assert_same_compiled(cj, ct)
    assert_same_compiled(cj, ct.to("cpu"))


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float64),
    dict(strategy="ell"),
    dict(domain="log"),
    dict(strategy="segment"),
])
def test_compile_names_what_is_not_ported(kw):
    """What is not ported raises and names its ROADMAP item; float64, ported
    since, compiles every float array in float64 (the one-hot Ĉᵀ stays
    float32, as in the JAX package)."""
    fsm, spdf, P, _ = port_lm_graph(16)
    if kw.get("dtype") == torch.float64:
        ct = compile_port(fsm, spdf, P, **kw)
        assert ct.strategy == "dense"
        for t in (ct.alpha_hat, ct.fwd_w, ct.bwd_w, ct.dense_fwd_exp,
                  ct.dense_fwd_max, ct.dense_bwd_exp, ct.dense_bwd_max):
            assert t.dtype == torch.float64
        assert ct.pdf_onehot.dtype == torch.float32
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_port(fsm, spdf, P, **kw)


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


@pytest.mark.parametrize("entry", ["compile_fsm", "compiled_from_numpy"])
def test_entry_points_target_the_card_by_default(entry):
    """Without ``device``, the graph lands on the card; without a card the
    call raises instead of staying on the CPU; ``device="cpu"`` is the
    CPU."""
    fsm, spdf, P, _ = port_lm_graph(16)
    if entry == "compile_fsm":
        build = lambda **kw: mt.compile_fsm(fsm, spdf, P, strategy="block",
                                            **kw)
    else:
        fields = jax_fields(jax_compiled(16))
        build = lambda **kw: mt.compiled_from_numpy(*fields, **kw)
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
