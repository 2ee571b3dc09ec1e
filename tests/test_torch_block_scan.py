"""The port's blocked scan (ops/block_scan.py) against the JAX package's
fused Pallas scan (ops/pallas_block.py, interpret mode on the CPU).

On CPU tensors the K2-K4 wrappers run their plain PyTorch twins; the same
emission inputs go through ``pallas_block.block_fused_fb``, and the
combined logZ and the posteriors must agree at atol 1e-5.  The CUDA kernels
themselves are held against these twins on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from markovmodels_tpu import inference as inf
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import inputs, jax_compiled, port_from_jax


@pytest.fixture(scope="module")
def graphs():
    cj = jax_compiled(128)
    return cj, port_from_jax(cj)


def _logz_jax(vfin, shift, ksum):
    v = np.asarray(vfin)
    logv = jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), -jnp.inf)
    return np.asarray(inf._combine_shift(logv, ksum, shift))


@pytest.fixture(scope="module")
def fused_pair(graphs):
    """(JAX fused Pallas, port plain twins) on one ragged, cliffed input
    with an infeasible L=1 sequence and chunk 2 (mid-sequence chunk
    boundaries and phony-absorb pad frames)."""
    cj, ct = graphs
    P = ct.num_pdfs
    lhs, lens = inputs(8, 5, P, seed=11, lens=[5, 4, 5, 1, 3, 5, 2, 4],
                       cliffs=True)
    ext_j, msh_j = ps.prepare_emissions(jnp.asarray(lhs), jnp.asarray(lens),
                                        P)
    posts_j, vfin, shift, ksum = pb.block_fused_fb(cj, ext_j, msh_j, True,
                                                   chunk=2)
    ext_t, msh_t = prepare_emissions(torch.from_numpy(lhs),
                                     torch.from_numpy(lens), P)
    bs.reset_launch_counts()
    posts_t, vt, st, kt = bs.block_fused_fb(ct, ext_t, msh_t, True, chunk=2)
    launches = dict(bs.LAUNCHES)
    zt = tinf._combine_shift(tinf._log_final(vt), kt, st).numpy()
    return ((np.asarray(posts_j), _logz_jax(vfin, shift, ksum)),
            (posts_t.numpy(), zt), lens, launches)


def test_plans_match_jax(graphs):
    cj, ct = graphs
    W, R, pf, pbk = pb._full_plan(cj)
    (Wt, Rt, pft, pbt), reason = bs._full_plan_explain(ct)
    assert reason is None
    assert (Wt, Rt, pft, pbt) == (W, R, pf, pbk)
    # the kernels' index maps, read from the same descriptors
    kop = bs.kernel_operator(ct)
    assert kop.fwd.src_map == (256, 384, 1) and kop.fwd.dst_map == (0, 1, 384)
    assert kop.bwd.src_map == (0, 1, 384) and kop.bwd.dst_map == (256, 384, 1)
    for kd, op in ((kop.fwd, cj.block_fwd), (kop.bwd, cj.block_bwd)):
        np.testing.assert_array_equal(kd.src_rows.numpy(),
                                      np.asarray(op.tiers[0][0]))
        np.testing.assert_array_equal(kd.dst_rows.numpy(),
                                      np.asarray(op.tiers[0][1]))
        rows = np.concatenate([kd.band_rows.numpy(),
                               kd.dst_rows.numpy().ravel()])
        assert np.array_equal(np.sort(rows), np.arange(ct.padded_states))


def test_plain_twins_logz_match_fused_pallas(fused_pair):
    (_, zj), (_, zt), lens, _ = fused_pair
    fin = np.isfinite(zj)
    assert not fin[3] and fin.sum() >= 5  # L=1 is infeasible: -inf
    assert (np.isfinite(zt) == fin).all()
    np.testing.assert_allclose(zt[fin], zj[fin], atol=1e-5, rtol=0)


def test_plain_twins_posteriors_match_fused_pallas(fused_pair):
    (pj, _), (pt, _), lens, _ = fused_pair
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)


def test_plain_twins_launch_no_kernel_on_cpu(fused_pair):
    assert fused_pair[3] == {"block_fwd": 0, "block_recompute": 0,
                             "block_bwd": 0}


def test_recompute_reproduces_forward_states(graphs):
    """K3's twin from a checkpoint gives K2's twin's states bit for bit."""
    _, ct = graphs
    kop = bs.kernel_operator(ct)
    lhs, lens = inputs(3, 5, ct.num_pdfs, seed=2, lens=[5, 4, 5])
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), ct.num_pdfs)
    a0 = kop.alpha0[:, None].expand(kop.Sp, 3).contiguous()
    bounds, bscale, a_last, s_last, _, _ = bs.fwd_sweep(kop, a0, ext[:6],
                                                        msh[:6], 3)
    alphas, ascale = bs.recompute(kop, bounds[1], bscale[1], ext[3:6], 3)
    assert torch.equal(alphas[-1], a_last) and torch.equal(ascale[-1], s_last)


@pytest.mark.parametrize("V", [16, 32, 64, 128])
def test_reject_reason_matches_jax(V):
    cj = jax_compiled(V)
    ct = port_from_jax(cj)
    assert bs.block_scan_reject_reason(ct, 8) == pb.block_scan_reject_reason(
        cj, 8)


def test_fast_path_report_names_the_jax_predicate(monkeypatch):
    cj = jax_compiled(64)
    ct = port_from_jax(cj)
    reason = pb.block_scan_reject_reason(cj, 8)
    assert reason == "tier stride 192 not a multiple of 128 lanes"
    monkeypatch.setenv("MMTPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MMTPU_NO_PALLAS", raising=False)
    assert reason in inf.fast_path_report(cj, 8)
    assert reason in tinf.fast_path_report(ct, 8, device="cuda")
    assert "plain" in tinf.fast_path_report(ct, 8)


def test_cuda_dispatch_raises_for_a_rejected_graph():
    """The dispatch rule: CPU -> plain scan, CUDA + accepted -> kernels,
    CUDA + rejected -> raises naming the predicate; no quiet fallback."""
    ct64 = port_from_jax(jax_compiled(64))
    ct128 = port_from_jax(jax_compiled(128))
    assert tinf._kernel_route(ct128, "cpu", 8) is False
    assert tinf._kernel_route(ct64, "cpu", 8) is False
    assert tinf._kernel_route(ct128, "cuda", 8) is True
    with pytest.raises(ValueError, match="tier stride 192"):
        tinf._kernel_route(ct64, "cuda", 8)
    with pytest.raises(ValueError, match="no forward-backward path"):
        tinf._kernel_route(ct128, "meta", 8)


def test_wrappers_refuse_other_devices(graphs):
    _, ct = graphs
    kop = bs.kernel_operator(ct)
    a0 = torch.empty((kop.Sp, 2), device="meta")
    ext = torch.empty((4, kop.P1, 2), device="meta")
    with pytest.raises(ValueError, match="no blocked-scan kernel"):
        bs.fwd_sweep(kop, a0, ext, ext[:, :1], 2)
    with pytest.raises(ValueError, match="no blocked-scan kernel"):
        bs.recompute(kop, a0, ext[0, 0], ext, 0)
