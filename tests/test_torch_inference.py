"""The slice as a whole: the port's pdfposteriors and forward on the 2M-arc
graph (V=128) at tiny B and N, against the JAX package's fused Pallas path
(interpret mode), its XLA path, and the exact float64 host oracle.

Inputs: ragged lengths with an infeasible L=1 sequence, ±30-nat emission
cliffs, chunk_size=2 (chunk checkpointing with pad frames) and the automatic
chunk (one chunk, all alphas kept)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from _torch_port import inputs, jax_compiled, lm_graph

B, N = 8, 6
LENS = [6, 5, 6, 1, 3, 6, 4, 5]


@pytest.fixture(scope="module")
def graphs():
    fsm, spdf, P, _ = lm_graph(128)
    return jax_compiled(128), mt.compile_fsm(fsm, spdf, P, strategy="block")


@pytest.fixture(scope="module")
def data(graphs):
    return inputs(B, N, graphs[1].num_pdfs, seed=5, lens=LENS, cliffs=True)


@pytest.fixture(scope="module")
def port(graphs, data):
    lhs, lens = data
    posts, z = mt.pdfposteriors(graphs[1], torch.from_numpy(lhs),
                                torch.from_numpy(lens), chunk_size=2)
    return posts.numpy(), z.numpy()


def _jax_run(cf, lhs, lens, env, chunk_size=2):
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
            mp.delenv(k, raising=False)
        mp.setenv(env, "1")
        if env == "MMTPU_PALLAS_INTERPRET":
            assert inf._pallas_block_ok(cf, jnp.asarray(lhs))
        posts, z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens),
                                     chunk_size=chunk_size)
        return np.asarray(posts), np.asarray(z)


@pytest.fixture(scope="module")
def jax_fused(graphs, data):
    return _jax_run(graphs[0], *data, "MMTPU_PALLAS_INTERPRET")


@pytest.fixture(scope="module")
def jax_xla(graphs, data):
    return _jax_run(graphs[0], *data, "MMTPU_NO_PALLAS")


def _assert_logz(z, ref, atol):
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("ref", ["jax_fused", "jax_xla"])
def test_logz_matches_jax(port, ref, request):
    _assert_logz(port[1], request.getfixturevalue(ref)[1], 1e-5)


@pytest.mark.parametrize("ref", ["jax_fused", "jax_xla"])
def test_posteriors_match_jax(port, ref, request):
    np.testing.assert_allclose(port[0], request.getfixturevalue(ref)[0],
                               atol=1e-5, rtol=0)


def test_matches_f64_oracle(port, data):
    fsm, spdf, P, _ = lm_graph(128)
    lhs, lens = data
    ref_z, ref_p = bench.host_oracle(fsm, spdf, P, lhs.astype(np.float64),
                                     lens)
    _assert_logz(port[1], ref_z, 1e-4)
    np.testing.assert_allclose(port[0], ref_p, atol=1e-4, rtol=0)


def test_posterior_shape_mass_and_zeros(port, data):
    posts, z = port
    lens = data[1]
    assert posts.shape == (B, N, 384) and z.shape == (B,)
    assert np.isneginf(z[3]) and np.isfinite(np.delete(z, 3)).all()
    for b, L in enumerate(lens):
        assert (posts[b, L:] == 0.0).all()
        if np.isfinite(z[b]):
            np.testing.assert_allclose(posts[b, :L].sum(axis=1), 1.0,
                                       atol=1e-5)


def test_forward_matches_jax(graphs, data, jax_xla):
    lhs, lens = data
    z = mt.forward(graphs[1], torch.from_numpy(lhs), torch.from_numpy(lens),
                   chunk_size=2).numpy()
    _assert_logz(z, jax_xla[1], 1e-5)


def test_auto_chunk_and_default_lengths_match_jax(graphs, data):
    """chunk_size=None (one chunk: every alpha kept) and lengths=None."""
    lhs = data[0]
    pj, zj = _jax_run(graphs[0], lhs, np.full(B, N, np.int32),
                      "MMTPU_NO_PALLAS", chunk_size=None)
    pt, zt = mt.pdfposteriors(graphs[1], torch.from_numpy(lhs))
    _assert_logz(zt.numpy(), zj, 1e-5)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-5, rtol=0)


def test_lengths_beyond_n_are_clamped(graphs, data):
    lhs = torch.from_numpy(data[0][:2])
    z_long = mt.forward(graphs[1], lhs, torch.tensor([N + 5, N]))
    z_full = mt.forward(graphs[1], lhs, torch.tensor([N, N]))
    assert torch.equal(z_long, z_full)


def test_lhs_on_another_device_than_the_graph_raises(graphs, data):
    lhs = torch.from_numpy(data[0]).to("meta")
    with pytest.raises(ValueError, match="graph on cpu"):
        mt.pdfposteriors(graphs[1], lhs)


@pytest.mark.parametrize("V, reorder", [(16, "none"), (32, "auto"),
                                        (64, "auto")])
def test_plain_scan_on_other_layouts_matches_jax(V, reorder):
    """Graphs off the kernels' path (one-hot reduction, two tiers, generic
    gather/scatter) through the plain scan, against the JAX XLA path."""
    fsm, spdf, P, _ = lm_graph(V)
    cj = jax_compiled(V, reorder)
    ct = mt.compile_fsm(fsm, spdf, P, reorder=reorder)
    lhs, lens = inputs(4, 5, P, seed=V, lens=[5, 4, 2, 5])
    pj, zj = _jax_run(cj, lhs, lens, "MMTPU_NO_PALLAS")
    pt, zt = mt.pdfposteriors(ct, torch.from_numpy(lhs),
                              torch.from_numpy(lens), chunk_size=2)
    _assert_logz(zt.numpy(), zj, 1e-5)
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-5, rtol=0)
