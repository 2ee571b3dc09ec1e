"""The port's plain block_matvec against the JAX package's, forward and
backward, on operators that exercise every tier form: V=128 (affine
k-major/s-major gathers, d_pad/k_pad scatters), V=64 (gather + d_pad,
s-major + scatter), V=32 (two tiers, generic gather/scatter)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from markovmodels_tpu.ops import blocked as jbl
from markovmodels_tpu_torch.ops import blocked as tbl
from _torch_port import jax_compiled, port_from_jax


@pytest.mark.parametrize("V", [32, 64, 128])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_block_matvec_matches_jax(V, direction):
    cj = jax_compiled(V)
    ct = port_from_jax(cj)
    op_j, meta_j = getattr(cj, f"block_{direction}"), getattr(
        cj, f"block_{direction}_offsets")
    op_t, meta_t = getattr(ct, f"block_{direction}"), getattr(
        ct, f"block_{direction}_offsets")
    rng = np.random.default_rng(V)
    x = rng.uniform(size=(cj.padded_states, 4)).astype(np.float32)
    yj = np.asarray(jbl.block_matvec(op_j, meta_j, jnp.asarray(x),
                                     jax.lax.Precision.HIGHEST))
    yt = tbl.block_matvec(op_t, meta_t, torch.from_numpy(x)).numpy()
    assert (yj > 0).any()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=0)


def _affine(base, a, b, K, M):
    return (base + np.arange(K)[:, None] * a + np.arange(M)[None, :] * b)


@pytest.mark.parametrize("idx", [
    _affine(7, 64, 1, 4, 8),
    _affine(7, 1, 64, 4, 8),
    _affine(3, 0, 5, 1, 8),
    _affine(64, 8, 1, 4, 8),
    _affine(64, 1, 4, 4, 8),
    _affine(64, 32, 1, 4, 8),
    _affine(64, 1, 32, 4, 8),
    _affine(2, 0, 7, 1, 8),
    _affine(4096 - 4 * 64, 64, 1, 4, 8) + 56,
    np.random.default_rng(0).integers(0, 4096, size=(4, 8)),
])
def test_descriptor_classifiers_match_jax(idx):
    assert tbl._gather_desc(idx, 4096) == jbl._gather_desc(idx, 4096)
    assert tbl._scatter_desc(idx, 4096) == jbl._scatter_desc(idx, 4096)
