"""precision='bf16' in the port against the JAX package on the CPU.

* ``compile_fsm(precision='bf16')`` field by field (the compiled arrays are
  those of 'high'; the panels are cast at the call, as in the JAX
  package);
* the K2-K4 plain twins on a bf16 'block' graph against
  ``pallas_block.block_fused_fb`` in interpret mode, which does round the
  tier's operands to bf16: the V=128 graph (the 2M-arc one) and the
  separate-state backoff graph (the overflow-family branch), at N=12 with
  ragged lengths, ±30-nat cliffs and chunk boundaries, where bf16 and
  'high' differ by more than the tolerance (at N=5 the tier carries too
  little mass to tell them apart);
* the K6 twins on a bf16 'dense' graph against an explicit reference (the
  float32 twin with both product operands rounded to bf16) bit for bit,
  and the dense paths against JAX's 'bf16' (float32 on the CPU) and the
  f64 oracle;
* the plain CPU paths (``block_matvec``, the dense and stacked-dense
  scans) rounding what the kernels round, the LF-MMI step with a bf16
  denominator against ``jax.value_and_grad`` in interpret mode, Viterbi
  on a bf16 graph, and the admission of bf16 panels.

Inputs are made from numpy seeds.  The CUDA kernels are held against these
twins on the card by ``chip_smoke.py`` (phases 22 on)."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import dense_scan as ds
from markovmodels_tpu_torch.ops import vit_scan as vs
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import (assert_same_compiled, compile_port, inputs,
                         lm_graph, numerators, port_from_jax, port_lm_graph,
                         random_graph)

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

TOL = 1e-5  # port vs the JAX package: the same roundings, sums reordered
# a bf16 'dense' graph against the f64 oracle and JAX's float32: every arc
# weight and state is rounded each frame, ~7e-3 in logZ on the WSJ graph by
# the JAX package's own account (semiring_ops.py:119-121), measured 4.6e-3
# / 8.9e-4 here (1.4e-3 / 1.3e-3 with ±30-nat cliffs); bench.py's 2e-3 / 1e-3 (:507-525) holds 'block' graphs,
# whose bf16 tier carries only the word-to-word arcs
TOL_DENSE_BF16_LOGZ, TOL_DENSE_BF16_POSTS = 1e-2, 5e-3


def _env(mp, *names):
    for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
        mp.delenv(k, raising=False)
    for name in names:
        mp.setenv(name, "1")


def _logz(v, shift, ksum):
    v = np.asarray(v)
    logv = jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), -jnp.inf)
    return np.asarray(inf._combine_shift(logv, ksum, shift))


def _assert_logz(z, ref, atol):
    fin = np.isfinite(ref)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref[fin], atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_graph(name, precision):
    """The JAX compile of the V=128 graph ('2m') or of the separate-state
    backoff graph at V=128 ('separate')."""
    if name == "2m":
        fsm, spdf, P, _ = lm_graph(128)
    else:
        fsm, spdf, P, _ = make_backoff_lm_hmm_graph(V=128, keep=0.1,
                                                    layout="separate")
    return inf.compile_fsm(fsm, spdf, P, strategy="block",
                           precision=precision)


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [16, 128])
def test_compile_bf16_matches_jax(V):
    fsm, spdf, P, _ = port_lm_graph(V)
    ct = compile_port(fsm, spdf, P, strategy="block", precision="bf16")
    cj = inf.compile_fsm(*lm_graph(V)[:3], strategy="block", precision="bf16")
    assert ct.precision == cj.precision == "bf16"
    assert_same_compiled(cj, ct)


def test_other_modes_keep_raising():
    fsm, spdf, P, _ = port_lm_graph(16)
    with pytest.raises(NotImplementedError,
                       match="'bf16' with dtype float64 .ROADMAP queue 1 "
                             "item 9, its remainder"):
        compile_port(fsm, spdf, P, precision="bf16", dtype=torch.float64)
    with pytest.raises(NotImplementedError,
                       match="precision 'fp8'.*ROADMAP queue 1 item 9"):
        compile_port(fsm, spdf, P, precision="fp8")


# ---------------------------------------------------------------------------
# the K2-K4 twins against the fused Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["2m", "separate"])
def block_runs(request):
    """One ragged, cliffed N=12 input (an infeasible L=1 sequence, chunk 4:
    chunk boundaries mid-sequence and pad frames) through
    ``pallas_block.block_fused_fb`` on the bf16 and the 'high' compile,
    and through the port's twins on the bf16 one."""
    name = request.param
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_PALLAS_INTERPRET")
        for prec in ("bf16", "high"):
            cj = jax_graph(name, prec)
            P = cj.num_pdfs
            lhs, lens = inputs(4, 12, P, seed=11, lens=[12, 9, 1, 12],
                               cliffs=True)
            ext, msh = ps.prepare_emissions(jnp.asarray(lhs),
                                            jnp.asarray(lens), P)
            posts, vfin, shift, ksum = pb.block_fused_fb(cj, ext, msh, True,
                                                         chunk=4)
            out[prec] = (np.asarray(posts), _logz(vfin, shift, ksum))
    ct = port_from_jax(jax_graph(name, "bf16"))
    assert ct.precision == "bf16"
    ext_t, msh_t = prepare_emissions(torch.from_numpy(lhs),
                                     torch.from_numpy(lens), P)
    bs.reset_launch_counts()
    posts_t, vt, st, kt = bs.block_fused_fb(ct, ext_t, msh_t, True, chunk=4)
    launches = dict(bs.LAUNCHES), dict(bs.LAUNCHES_BF16)
    zt = tinf._combine_shift(tinf._log_final(vt), kt, st).numpy()
    return name, out, (posts_t.numpy(), zt), launches


def test_bf16_twins_match_fused_pallas(block_runs):
    name, out, (pt, zt), _ = block_runs
    pj, zj = out["bf16"]
    assert not np.isfinite(zj[2]) and np.isfinite(np.delete(zj, 2)).all()
    _assert_logz(zt, zj, TOL)
    assert pt.shape == pj.shape == (16, 385, 4)
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)


def test_bf16_differs_from_high_at_this_shape(block_runs):
    """bf16 and 'high' differ by more than TOL here, so a twin that skipped
    the rounding would fail test_bf16_twins_match_fused_pallas."""
    _, out, _, _ = block_runs
    (p16, z16), (phi, zhi) = out["bf16"], out["high"]
    fin = np.isfinite(zhi)
    assert np.abs(z16[fin] - zhi[fin]).max() > TOL
    assert np.abs(p16 - phi).max() > TOL


def test_bf16_twins_launch_no_kernel_on_cpu(block_runs):
    zero = {"block_fwd": 0, "block_recompute": 0, "block_bwd": 0}
    assert block_runs[3] == (zero, zero)


# ---------------------------------------------------------------------------
# the kernels' operator, the plain block path and admission
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs128():
    """The port's compiles of the V=128 graph, bf16 and 'high'."""
    fsm, spdf, P, _ = port_lm_graph(128)
    return (compile_port(fsm, spdf, P, strategy="block", precision="bf16"),
            compile_port(fsm, spdf, P, strategy="block", precision="high"))


def test_kernel_operator_panels(graphs128):
    """A bf16 graph's K2-K4 operator has the panels in bf16 and shares every
    other table with the float32 operator, which K7 takes."""
    ct16, cthi = graphs128
    k16 = bs.kernel_operator(ct16)
    k32 = bs.kernel_operator(ct16, torch.float32)
    assert bs.kernel_operator(ct16) is k16
    for a, b, op in ((k16.fwd, k32.fwd, ct16.block_fwd),
                     (k16.bwd, k32.bwd, ct16.block_bwd)):
        assert a.W.dtype == torch.bfloat16 and b.W.dtype == torch.float32
        assert torch.equal(b.W, op.tiers[0][2])
        assert torch.equal(a.W, op.tiers[0][2].to(torch.bfloat16))
        assert a.band_w is b.band_w and a.src_rows is b.src_rows
    assert bs.kernel_operator(cthi).fwd.W.dtype == torch.float32
    assert k16.row_pdf is k32.row_pdf


def test_working_set_charges_bf16_panels_at_two_bytes(graphs128):
    ct16, cthi = graphs128
    panels = sum(op.tiers[0][2].numel() for op in (ct16.block_fwd,
                                                   ct16.block_bwd))
    assert (bs._working_set_bytes(cthi, 128, 700, 64)
            - bs._working_set_bytes(ct16, 128, 700, 64)) == 2 * panels


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_block_matvec_rounds_what_the_twin_rounds(graphs128, direction):
    """The plain path's matvec of a bf16 graph against K1's twin on the
    kernels' operator (the rank-1 ω row aside): the same bf16 tier
    operands; and unlike the float32 matvec."""
    ct16, _ = graphs128
    op = getattr(ct16, f"block_{direction}")
    meta = getattr(ct16, f"block_{direction}_offsets")
    kd = getattr(bs.kernel_operator(ct16), direction)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        rng.uniform(size=(ct16.padded_states, 4)).astype(np.float32))
    y = tbl.block_matvec(op, meta, x, bf16=True)
    np.testing.assert_allclose(y.numpy(), bs._matvec_plain(kd, x).numpy(),
                               rtol=1e-6, atol=1e-6)
    y32 = tbl.block_matvec(op, meta, x)
    assert (y - y32).abs().max() > 1e-4 * y32.abs().max()


def test_bf16_reject_reasons(graphs128):
    """The V=128 bf16 graph passes admission for K2-K4 and K7; panels the
    bf16 tier tile cannot stage name the predicate, and the dispatch
    raises for them on CUDA instead of falling back."""
    ct16, _ = graphs128
    assert bs.block_scan_reject_reason(ct16, 128) is None
    assert vs.vit_scan_reject_reason(ct16, 128) is None
    assert tinf._kernel_route(ct16, "cuda", 128) is True
    kop = bs.kernel_operator(ct16)
    bad = kop._replace(bwd=kop.bwd._replace(W=kop.bwd.W[:, :120]))
    reason = ("backward operator: bf16 tier depth Sm = 120 not a multiple "
              "of the tensor-core step 16")
    assert bs._bf16_tile_reason(bad) == reason
    cf = dataclasses.replace(ct16, _cache={})
    cf._cache[("block_scan", torch.bfloat16)] = bad
    assert bs.block_scan_reject_reason(cf, 128) == reason
    assert bs.block_scan_reject_reason(cf, 128,
                                       tier_dtype=torch.float32) is None
    with pytest.raises(ValueError, match="bf16 tier depth Sm = 120"):
        tinf._kernel_route(cf, "cuda", 128)
    assert "bf16 tier depth" in tinf.fast_path_report(cf, 128, device="cuda")


# ---------------------------------------------------------------------------
# the LF-MMI step and Viterbi with a bf16 block denominator
# ---------------------------------------------------------------------------

def test_lfmmi_with_bf16_denominator_matches_jax():
    """Loss and gradient against ``jax.value_and_grad`` with the fused
    kernels in interpret mode (the JAX path that rounds), N=12."""
    B, N, lens_ = 4, 12, [12, 11, 12, 9]
    cj = jax_graph("2m", "bf16")
    P = cj.num_pdfs
    nl = [5, 3, 6, 4]
    nums_j = numerators(np.random.default_rng(13), B, P, nl)
    nums_t = numerators(np.random.default_rng(13), B, P, nl, lib=mt)
    num_j = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded")
                       for f, sp in nums_j])
    num_t = mt.stack([compile_port(f, sp, P, strategy="banded")
                      for f, sp in nums_t])
    den_t = compile_port(*port_lm_graph(128)[:3], strategy="block",
                         precision="bf16")
    lhs, lens = inputs(B, N, P, seed=17, lens=lens_)
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_PALLAS_INTERPRET")
        assert inf._pallas_block_ok(cj, jnp.asarray(lhs))
        loss_j, grad_j = jax.value_and_grad(
            lambda x: inf.lfmmi_loss(num_j, cj, x, jnp.asarray(lens)).sum()
        )(jnp.asarray(lhs))
    x = torch.from_numpy(lhs).requires_grad_()
    loss = mt.lfmmi_loss(num_t, den_t, x, torch.from_numpy(lens))
    loss.sum().backward()
    assert torch.isfinite(loss).all()
    np.testing.assert_allclose(float(loss.sum()), float(loss_j), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=TOL,
                               rtol=0)


def test_viterbi_of_a_bf16_graph_equals_high(graphs128):
    """Viterbi ignores the precision, as the TPU K7 does: the same paths
    and scores as the 'high' graph, and K7 gets float32 panels."""
    ct16, cthi = graphs128
    lhs, lens = inputs(4, 7, ct16.num_pdfs, seed=23, lens=[7, 1, 5, 7],
                       cliffs=True)
    args = (torch.from_numpy(lhs), torch.from_numpy(lens))
    s16, z16 = mt.viterbi(ct16, *args)
    shi, zhi = mt.viterbi(cthi, *args)
    assert torch.equal(s16, shi) and torch.equal(z16, zhi)
    assert np.isfinite(z16.numpy()[[0, 2, 3]]).all()
    assert tvit._bp_vit_reject_reason(ct16, args[0]) is None


# ---------------------------------------------------------------------------
# dense: the K6 twins, the plain paths, stacking
# ---------------------------------------------------------------------------

def _round(x):
    return x.to(torch.bfloat16).float()


def _reference_fwd(wf, spdf, a0, ext, mshift):
    """fwd_sweep_plain written out with a float32 product of bf16-rounded
    operands: the explicit reference of K6a's bf16 twin."""
    Nf, _, B = ext.shape
    alphas = a0.new_empty((Nf,) + a0.shape)
    ascale = a0.new_empty((Nf, B))
    a, s = a0, a0.new_ones(B)
    ksum, shift, comp = (a0.new_zeros(B) for _ in range(3))
    w = _round(wf)
    for t in range(Nf):
        e = ext[t].index_select(0, spdf)
        y = a * e if t == 0 else (w @ _round(a)) * s[None, :] * e
        k = bs._pow2_exponent(y.amax(dim=0))
        a, s = y, bs._pow2_scale(k)
        alphas[t], ascale[t] = a, s
        ksum = ksum + k
        xc = mshift[t, 0] - comp
        tsum = shift + xc
        comp = (tsum - shift) - xc
        shift = tsum
    return alphas, ascale, a, s, ksum, shift


def _reference_bwd(wb, spdf, P1, ext, alphas, ascale):
    """backward_plain written out with the bf16-rounded product."""
    Nf, _, B = ext.shape
    posts = ext.new_empty((Nf, P1, B))
    w = _round(wb)
    b = s = None
    for t in reversed(range(Nf)):
        y = (torch.ones_like(alphas[t]) if t == Nf - 1
             else (w @ _round(b)) * s[None, :])
        g = alphas[t] * ascale[t][None, :] * y
        sums = g.new_zeros((P1, B)).index_add_(0, spdf, g)
        tot = g.sum(dim=0)
        posts[t] = sums / torch.where(tot > 0, tot, torch.ones_like(tot))
        b = y * ext[t].index_select(0, spdf)
        s = bs._pow2_scale(bs._pow2_exponent(b.amax(dim=0)))
    return posts


@pytest.fixture(scope="module")
def dense8():
    """The V=8 'dense' graph in bf16 and 'high', one cliffed ragged input."""
    fsm, spdf, P, _ = port_lm_graph(8)
    c16 = compile_port(fsm, spdf, P, strategy="dense", precision="bf16")
    chi = compile_port(fsm, spdf, P, strategy="dense")
    lhs, lens = inputs(6, 9, P, seed=31, lens=[9, 1, 5, 9, 3, 7],
                       cliffs=True)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P)
    return c16, chi, ext, msh


def test_dense_operator_in_bf16(dense8):
    c16, chi, _, _ = dense8
    k16, khi = ds.kernel_operator(c16), ds.kernel_operator(chi)
    assert k16.wf.dtype == k16.wb.dtype == torch.bfloat16
    assert khi.wf.dtype == torch.float32
    assert torch.equal(k16.wf, khi.wf.to(torch.bfloat16))
    assert torch.equal(k16.wb, khi.wb.to(torch.bfloat16))
    Sp = c16.padded_states
    assert (ds._device_bytes(chi, 128, 700) - ds._device_bytes(c16, 128, 700)
            == 2 * 2 * Sp * Sp)


def test_dense_bf16_twins_equal_the_explicit_reference(dense8):
    c16, chi, ext, msh = dense8
    kop = ds.kernel_operator(c16)
    khi = ds.kernel_operator(chi)
    a0 = kop.alpha0[:, None].expand(kop.Sp, 6).contiguous()
    ds.reset_launch_counts()
    fwd = ds.fwd_sweep(kop, a0, ext, msh)
    ref = _reference_fwd(khi.wf, khi.spdf.long(), a0, ext, msh)
    assert all(torch.equal(x, y) for x, y in zip(fwd, ref))
    posts = ds.backward(kop, ext, fwd[0], fwd[1])
    assert torch.equal(posts, _reference_bwd(khi.wb, khi.spdf.long(), kop.P1,
                                             ext, fwd[0], fwd[1]))
    zero = {"dense_fwd": 0, "dense_bwd": 0}
    assert (ds.LAUNCHES, ds.LAUNCHES_BF16) == ({**zero, "dense_trop": 0},
                                               zero)
    # and not the float32 twin
    assert not torch.equal(ds.fwd_sweep(khi, a0, ext, msh)[0], fwd[0])


@pytest.fixture(scope="module")
def dense16():
    """V=16 'dense' (Sp=896): the port's bf16 paths and the references."""
    fsm, spdf, P, _ = port_lm_graph(16)
    ct = compile_port(fsm, spdf, P, precision="bf16")
    assert ct.strategy == "dense"
    lhs, lens = inputs(5, 8, P, seed=41, lens=[8, 6, 1, 8, 4])
    x, L = torch.from_numpy(lhs), torch.from_numpy(lens)
    ports = {"plain": mt.pdfposteriors(ct, x, L),
             "twins": tinf._fb_dense_cuda(ct, x, L, True)}
    ports = {k: (p.numpy(), z.numpy()) for k, (p, z) in ports.items()}
    cj = inf.compile_fsm(*lm_graph(16)[:3], precision="bf16")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, "MMTPU_PALLAS_INTERPRET")
        assert inf._pallas_ok(cj, jnp.asarray(lhs))
        pj, zj = inf.pdfposteriors(cj, jnp.asarray(lhs), jnp.asarray(lens))
    rz, rp = mt.oracle.host_oracle(fsm, spdf, P, lhs.astype(np.float64),
                                   lens)
    refs = {"jax_bf16": (np.asarray(pj), np.asarray(zj)), "oracle": (rp, rz)}
    return ct, lhs, lens, ports, refs


@pytest.mark.parametrize("path", ["plain", "twins"])
@pytest.mark.parametrize("ref", ["jax_bf16", "oracle"])
def test_dense_bf16_paths_within_the_dense_bf16_bound(dense16, path, ref):
    _, _, lens, ports, refs = dense16
    posts, z = ports[path]
    pr, zr = refs[ref]
    assert np.isneginf(z[2]) and np.isfinite(np.delete(z, 2)).all()
    _assert_logz(z, zr, TOL_DENSE_BF16_LOGZ)
    np.testing.assert_allclose(posts, pr, atol=TOL_DENSE_BF16_POSTS, rtol=0)
    for b, n in enumerate(lens):
        assert (posts[b, n:] == 0).all()


def test_dense_plain_path_rounds_what_the_twins_round(dense16):
    """The plain scan and the kernel route's twins of one bf16 graph: the
    same bf16 operands, so they agree like the float32 pair does."""
    _, _, _, ports, _ = dense16
    (pp, zp), (pk, zk) = ports["plain"], ports["twins"]
    _assert_logz(zp, zk, TOL)
    np.testing.assert_allclose(pp, pk, atol=TOL, rtol=0)


def test_stacked_bf16_dense_rounds_per_graph():
    """The stacked-dense route of bf16 graphs equals each graph's own bf16
    plain scan (the operands of the K6 kernels), and differs from the
    float32 stack."""
    rng = np.random.default_rng(9)
    P = 12
    graphs = [random_graph(rng, S, P, lib=mt) for S in (10, 25, 40)]
    cfs = [compile_port(f, sp, P, precision="bf16") for f, sp in graphs]
    st = mt.stack(cfs)
    assert st.precision == "bf16" and st.batched
    lhs, lens = inputs(3, 9, P, seed=4, lens=[9, 7, 9])
    posts, z = mt.pdfposteriors(st, torch.from_numpy(lhs),
                                torch.from_numpy(lens))
    for g, cf in enumerate(cfs):
        pg, zg = mt.pdfposteriors(cf, torch.from_numpy(lhs[g:g + 1]),
                                  torch.from_numpy(lens[g:g + 1]))
        np.testing.assert_allclose(z[g:g + 1].numpy(), zg.numpy(), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(posts[g:g + 1].numpy(), pg.numpy(),
                                   atol=TOL, rtol=0)
    st32 = mt.stack([compile_port(f, sp, P) for f, sp in graphs])
    _, z32 = mt.pdfposteriors(st32, torch.from_numpy(lhs),
                              torch.from_numpy(lens))
    assert (z - z32).abs().max() > 1e-6


# ---------------------------------------------------------------------------
# logZ of the CUDA routes, combined in float64
# ---------------------------------------------------------------------------

def test_cuda_routes_combine_logz_in_float64(dense8):
    """log v + ksum·ln2 + shift in float64, returned in float32: at N=700
    the last two pass 1,024, where one float32 rounding is 1.2e-4."""
    vfin = torch.tensor([0.73, 1.9, 0.0])
    ksum = torch.tensor([-1391.0, -1390.0, -12.0])
    shift = torch.tensor([1035.1234, 1034.9, 3.5])
    z = tinf._combine_f64(vfin, ksum, shift, torch.float32)
    ref = (np.log(vfin[:2].double().numpy()) + ksum[:2].double().numpy()
           * np.log(2.0) + shift[:2].double().numpy())
    assert z.dtype == torch.float32 and np.isneginf(z[2].item())
    np.testing.assert_array_equal(z[:2].numpy(), ref.astype(np.float32))
    # the dense route of the twins combines its pieces so
    c16, _, ext, msh = dense8
    lhs, lens = inputs(6, 9, c16.num_pdfs, seed=31, lens=[9, 1, 5, 9, 3, 7])
    _, zr = tinf._fb_dense_cuda(c16, torch.from_numpy(lhs),
                                torch.from_numpy(lens), False)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), c16.num_pdfs)
    _, v, sh, k = ds.dense_fused_fb(c16, ext, msh, False)
    assert torch.equal(zr, tinf._combine_f64(v, k, sh, torch.float32))
