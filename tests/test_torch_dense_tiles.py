"""The host plan of the block-sparse K6a/K6b (ops/dense_scan.py
``tile_plan``): the packed non-zero 32 x 32 tiles of a 'dense' graph's
operators, their CSR by row tile, the balanced per-CTA ranges with their
segments and partial slots, and a torch reference of the product the
kernels compute from the plan, in the kernels' combine order, against the
dense product.

Operators: the LM ∘ HMM graphs at V=8, 16 and 32 (Sp = 256, 896, 3,200),
the V=16 separate-state backoff graph, a random fully dense operator and
a random one with an all-zero row tile, each in float32 and in bf16 (the
plan judges the tiles in the dtype the kernels read).  Inputs are made
from numpy seeds.  The CUDA kernels are held against the plain twins on
the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import dense_scan as ds
from markovmodels_tpu_torch.ops.blocked import round_bf16
from _torch_port import compile_port, port_lm_graph

T_ = 32
TOL_REL = 1e-6  # the tiled product vs the float64 product, relative


def _graph_op(make):
    fsm, spdf, P, _ = make()
    cf = compile_port(fsm, spdf, P, strategy="dense")
    return (torch.exp(cf.dense_fwd_max)[:, None] * cf.dense_fwd_exp,
            torch.exp(cf.dense_bwd_max)[:, None] * cf.dense_bwd_exp)


def _random_op(Sp, zero_row_tile=None, density=1.0, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.01, 1.0, size=(Sp, Sp)) / Sp
    w *= rng.uniform(size=(Sp, Sp)) < density
    if zero_row_tile is not None:
        w[zero_row_tile * T_:(zero_row_tile + 1) * T_] = 0.0
    w = torch.from_numpy(w.astype(np.float32))
    return w, w.T.contiguous()


_MAKERS = {
    "lm8": lambda: _graph_op(lambda: port_lm_graph(8)),
    "lm16": lambda: _graph_op(lambda: port_lm_graph(16)),
    "lm32": lambda: _graph_op(lambda: port_lm_graph(32)),
    "backoff16": lambda: _graph_op(
        lambda: mt.workloads.make_backoff_lm_hmm_graph(V=16, keep=0.1,
                                                       layout="separate")),
    "dense256": lambda: _random_op(256, seed=1),
    "zero_row_tile": lambda: _random_op(192, zero_row_tile=2, density=0.05,
                                        seed=2),
}
# CTAs of the plan's grid: the default (2 per SM of an H100), and a few
# for the random operators, whose ranges then hold many tiles
_GRIDS = {"dense256": 5, "zero_row_tile": 3}
CASES = [(name, dt) for name in _MAKERS for dt in ("f32", "bf16")]


@pytest.fixture(scope="module")
def ops():
    return {}


def _case(ops, name, dt):
    """(w, plan) of the forward and backward operators of one case."""
    key = (name, dt)
    if key not in ops:
        if name not in ops:
            ops[name] = _MAKERS[name]()
        G = _GRIDS.get(name, ds._grid("cpu"))
        ws = [w.to(torch.bfloat16) if dt == "bf16" else w
              for w in ops[name]]
        ops[key] = [(w, ds.tile_plan(w, G)) for w in ws]
    return ops[key]


def _unpack(pl, dtype):
    """The packed tiles as (T, 32, 32) of ``dtype``, row-major."""
    T = pl.tile_k.numel()
    t = pl.tiles
    if dtype == torch.bfloat16:
        # [mb][ks][g][q][c][h][e] -> rows (mb, h, g), columns (ks, c, q, e)
        t = t.reshape(T, 2, 2, 8, 4, 2, 2, 2).permute(0, 1, 6, 3, 2, 5, 4, 7)
    return t.reshape(T, T_, T_)


def _tile_rows(pl):
    """The row tile of each packed tile, from the CSR."""
    rp = pl.row_ptr.long()
    return torch.repeat_interleave(torch.arange(rp.numel() - 1),
                                   rp[1:] - rp[:-1])


def _tiled_product(pl, w, x):
    """y = w @ x as the kernels compute it from the plan: per CTA and
    segment, the segment's tiles in order; a row tile in one range written
    at once, a straddling one from its partials added in range order.  A
    bf16 plan multiplies the state rounded to bf16."""
    tiles = _unpack(pl, w.dtype).float()
    if w.dtype == torch.bfloat16:
        x = round_bf16(x)
    kt = pl.tile_k.long()
    y = torch.full((w.shape[0], x.shape[1]), float("nan"))
    partials = {}
    lo, sp = pl.lo.tolist(), pl.seg_ptr.tolist()
    for c in range(len(lo) - 1):
        for rt, a, b, slot in pl.segs[sp[c]:sp[c + 1]].tolist():
            acc = torch.zeros((T_, x.shape[1]))
            for i in range(a, b):
                acc += tiles[i] @ x[kt[i] * T_:(kt[i] + 1) * T_]
            if slot < 0:
                assert torch.isnan(y[rt * T_]).all(), "row tile written twice"
                y[rt * T_:(rt + 1) * T_] = acc
            else:
                partials[slot] = acc
    for rt, (p0, n) in enumerate(pl.rt_parts.tolist()):
        if n:
            acc = partials[p0]
            for q in range(1, n):
                acc = acc + partials[p0 + q]
            y[rt * T_:(rt + 1) * T_] = acc
    return y


@pytest.mark.parametrize("name,dt", CASES)
def test_packed_tiles_rebuild_the_operator(ops, name, dt):
    for w, pl in _case(ops, name, dt):
        rebuilt = torch.zeros_like(w)
        tiles = _unpack(pl, w.dtype)
        for i, (rt, kt) in enumerate(zip(_tile_rows(pl).tolist(),
                                         pl.tile_k.tolist())):
            rebuilt[rt * T_:(rt + 1) * T_, kt * T_:(kt + 1) * T_] = tiles[i]
        assert torch.equal(rebuilt, w)
        assert pl.tiles.dtype == w.dtype and pl.tiles.is_contiguous()


@pytest.mark.parametrize("name,dt", CASES)
def test_every_nonzero_tile_once_and_no_zero_tile(ops, name, dt):
    for d, (w, pl) in enumerate(_case(ops, name, dt)):
        n = w.shape[0] // T_
        nz = (w.reshape(n, T_, n, T_) != 0).any(dim=3).any(dim=1)
        pairs = list(zip(_tile_rows(pl).tolist(), pl.tile_k.tolist()))
        assert pairs == sorted(set(pairs))  # (row, k) order, each once
        assert set(pairs) == {tuple(p) for p in torch.nonzero(nz).tolist()}
        assert (_unpack(pl, w.dtype) != 0).flatten(1).any(dim=1).all()
        counts = pl.row_ptr[1:] - pl.row_ptr[:-1]
        assert torch.equal(counts.long(), nz.sum(dim=1))
        if name == "zero_row_tile" and d == 0:  # forward: row tile 2
            assert counts[2] == 0 and counts.min() == 0
        if name == "dense256":
            assert pl.tile_k.numel() == n * n


@pytest.mark.parametrize("name,dt", CASES)
def test_ranges_and_segments_cover_the_tiles_in_order(ops, name, dt):
    for w, pl in _case(ops, name, dt):
        T, n = pl.tile_k.numel(), w.shape[0] // T_
        lo = pl.lo.tolist()
        G = len(lo) - 1
        sizes = np.diff(lo)
        assert lo[0] == 0 and lo[-1] == T and sizes.max() - sizes.min() <= 1
        assert pl.max_tiles == sizes.max()
        rp = pl.row_ptr.tolist()
        epilogues = [0] * n
        sp = pl.seg_ptr.tolist()
        slots = []
        for c in range(G):
            pos = lo[c]
            for rt, a, b, slot in pl.segs[sp[c]:sp[c + 1]].tolist():
                assert a == pos and a <= b <= lo[c + 1]  # in order, no gap
                pos = b
                if a == b:  # a row tile without a non-zero tile
                    assert rp[rt] == rp[rt + 1] and slot == -1
                else:
                    assert rp[rt] <= a and b <= rp[rt + 1]
                if slot < 0:
                    assert a == b or (a, b) == (rp[rt], rp[rt + 1])
                    epilogues[rt] += 1
                else:
                    slots.append((rt, slot))
            assert pos == lo[c + 1]
        parts = pl.rt_parts.tolist()
        for rt, (p0, k) in enumerate(parts):
            own = [s for r, s in slots if r == rt]
            if k:
                assert k >= 2 and own == list(range(p0, p0 + k))
                epilogues[rt] += 1
            else:
                assert (p0, own) == (-1, [])
        assert epilogues == [1] * n  # one epilogue per row tile and frame
        assert sorted(s for _, s in slots) == list(range(pl.n_partials))


@pytest.mark.parametrize("name,dt", CASES)
def test_tiled_product_matches_the_dense_product(ops, name, dt):
    """The plan's product in the kernels' combine order against w @ a
    (float32: of the float32 state; bf16: of the state rounded to bf16,
    what the twins multiply), within float32 reordering."""
    rng = np.random.default_rng(7)
    for w, pl in _case(ops, name, dt):
        Sp = w.shape[0]
        x = torch.from_numpy(
            rng.uniform(0.0, 1.0, size=(Sp, 6)).astype(np.float32))
        x[rng.integers(0, Sp, size=Sp // 4)] = 0.0
        y = _tiled_product(pl, w, x)
        xr = round_bf16(x) if w.dtype == torch.bfloat16 else x
        ref = w.double() @ xr.double()
        assert not torch.isnan(y).any()
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=TOL_REL,
                                   atol=0)
        twin = ds._product(w)(x)  # the plain twins' product
        np.testing.assert_allclose(y.numpy(), twin.numpy(), rtol=2 * TOL_REL,
                                   atol=0)


def test_bf16_plan_judges_tiles_after_rounding():
    """A tile whose only non-zero rounds to 0 in bf16 is packed for a
    float32 operator and left out of the bf16 one."""
    w = torch.zeros((96, 96))
    w[5, 70] = 1.4e-45  # the smallest float32 subnormal: 0 in bf16
    w[40, 3] = 0.5
    p32, p16 = (ds.tile_plan(w, 4), ds.tile_plan(w.to(torch.bfloat16), 4))
    assert p32.tile_k.tolist() == [2, 0] and p16.tile_k.tolist() == [0]
    assert p16.row_ptr.tolist() == [0, 0, 1, 1]


def test_all_zero_operator_has_only_empty_segments():
    pl = ds.tile_plan(torch.zeros((128, 128)), 3)
    assert pl.tile_k.numel() == 0 and pl.max_tiles == 0
    # the empty row tiles round robin over the CTAs
    assert pl.segs.tolist() == [[0, 0, 0, -1], [3, 0, 0, -1],
                                [1, 0, 0, -1], [2, 0, 0, -1]]
    assert pl.seg_ptr.tolist() == [0, 2, 3, 4]
    y = _tiled_product(pl, torch.zeros((128, 128)), torch.ones((128, 2)))
    assert torch.equal(y, torch.zeros((128, 2)))


@pytest.mark.parametrize("precision", ["high", "bf16"])
def test_kernel_operator_carries_both_plans(precision):
    """kernel_operator builds the plans of wf and wb once (cached with the
    rest of the DenseOp), in the operators' dtype, for the default grid."""
    fsm, spdf, P, _ = port_lm_graph(8)
    cf = compile_port(fsm, spdf, P, strategy="dense", precision=precision)
    kop = ds.kernel_operator(cf)
    assert ds.kernel_operator(cf) is kop
    for w, pl in ((kop.wf, kop.pf), (kop.wb, kop.pb)):
        assert pl.tiles.dtype == w.dtype
        assert pl.lo.numel() - 1 == ds._grid("cpu") == 264
        ref = ds.tile_plan(w, 264)
        assert all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                   for a, b in zip(pl, ref))


def test_v32_operator_sparsity():
    """The V=32 denominator (Sp = 3,200): 1,217 non-zero 32 x 32 tiles of
    10,000 in each direction, one row tile with 33 (34 backward), and at
    most 5 tiles per CTA over the default grid (264 CTAs), so the float32
    ranges stay in shared memory (5 x 4.5 KB)."""
    (wf, pf), (wb, pb) = _case({}, "lm32", "f32")
    assert pf.tile_k.numel() == pb.tile_k.numel() == 1217
    assert (pf.row_ptr.diff().max(), pb.row_ptr.diff().max()) == (33, 34)
    assert pf.max_tiles == pb.max_tiles == 5
