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


# ---------------------------------------------------------------------------
# K6a/K6b in float64: the DMMA layout of csrc/dense_scan.cu
# ---------------------------------------------------------------------------

# the float64 K6a/K6b: column block, stages of the ring, stage pitch, 8-column
# groups of a warp
TBD, NSD = 64, 3
XLDD, NBD = TBD + 4, TBD // 16
SM_BYTES = 233_472  # shared memory of an H100 SM (228 KB)
CTA_RESERVED = 1024  # what the card reserves per resident CTA
# the kernel's static shared memory in double: red [2][4][TBD], rsum
# [2][8][32], the ticket flag; K6t's (trop_kernel) its warps' column maxima,
# red [8][128], and the column scales, scs [128]
STATIC_F64 = 2 * 4 * TBD * 8 + 2 * 8 * 32 * 8 + 4
STATIC_TROP = 8 * 128 * 8 + 128 * 8
TOL_DMMA = 1e-13  # the emulated tensor-core product vs w @ x in float64


def _f64_plan(name):
    """(w, plan) of the forward operator of a float64 case: the V=32 graph
    on the default grid, or a fully dense Sp = 4,096 operator (every tile
    non-zero)."""
    if name == "lm32":
        w = _graph_op(lambda: port_lm_graph(32))[0].double()
    else:
        w = torch.full((4096, 4096), 1.0 / 4096, dtype=torch.float64)
    return w, ds.tile_plan(w, ds._grid("cpu"))


@pytest.mark.parametrize("name", ["lm32", "full4096"])
def test_f64_layout_smem_bytes(name):
    """``smem_bytes`` of a float64 plan equals a reckoning of the kernel's
    ``Layout::bytes``: K6a/K6b keep 8 KB tiles (32 x 32 doubles, in
    A-fragment order, unpadded) beside a ring of three stages of 32 k rows
    x 64 columns at a pitch of 68 doubles and the column block's scales
    (2 x 64 doubles); K6t keeps no tile and no stage: its only shared
    memory is the warps' column maxima and the column scales (static, 9 KB
    in double), so it runs at 2 CTAs per SM on any operator.  The V=32 ranges (5 tiles) stay resident at 2 CTAs
    per SM on K6a/K6b; the fully dense Sp = 4,096 operator (128 MiB of
    tiles, against the card's ~29 MiB of shared memory) streams, at 2 CTAs
    per SM."""
    w, pl = _f64_plan(name)
    tile, stage, scales = 32 * 32 * 8, 32 * XLDD * 8, 2 * TBD * 8
    assert (tile, stage, scales) == (8192, 17408, 1024)
    want = (pl.max_tiles * tile + NSD * stage + scales,
            NSD * (stage + tile) + scales)
    assert ds.smem_bytes(pl) == want

    def per_sm(dyn, static=STATIC_F64):
        return 2 * (dyn + static + CTA_RESERVED)

    assert per_sm(0, STATIC_TROP) <= SM_BYTES  # K6t at 2 CTAs per SM
    res, stream = ds.smem_bytes(pl)
    if name == "lm32":
        assert pl.max_tiles == 5 and res == 94_208
        assert per_sm(res) <= SM_BYTES  # resident at 2 CTAs per SM
    else:
        assert pl.tile_k.numel() == 128 * 128 and pl.max_tiles == 63
        assert res > 232_448  # more than one CTA may take
        assert per_sm(stream) <= SM_BYTES


def _dm_chunk(w):
    """The kernel's ``dm_chunk``: the shared-memory byte offset of the
    16-byte chunk w of a row-major packed double tile, in the A-fragment
    order of mma.m8n8k4."""
    r, k = w // 16, (w % 16) * 2
    return (((r // 8) * 8 + k // 4) * 32 + (r % 8) * 4 + k % 4) * 8


def _dmma_pass(acc, S, X):
    """acc (4 row blocks, 2 column halves, NBD groups, 8, 8) += the tile
    whose shared-memory image is S (1024 doubles) times the stage X
    (32, XLDD), as the kernel's warps issue it: per k step ks of 4, the A
    fragment of lane l is S[(mb * 8 + ks) * 32 + l]
    (row l / 4, column l % 4), the B fragment X[ks * 4 + l % 4,
    h * TBD / 2 + n * 8 + l / 4], and the 8 x 8 accumulator takes one
    m8n8k4 product after another."""
    A = S.reshape(4, 8, 8, 4)  # [mb][ks][g][q]
    Bf = X[:, :TBD].reshape(8, 4, 2, NBD, 8)  # [ks][k][h][n][c]
    for ks in range(8):
        acc += torch.einsum("mgq,qhnc->mhngc", A[:, ks], Bf[ks])
    return acc


def _dmma_tiled_product(pl, x):
    """y = w @ x as K6a/K6b in float64 compute it from the plan: per
    column block of TBD, per CTA and segment, the segment's tiles, each in
    one pass through :func:`_dmma_pass`, each tile placed in shared
    memory chunk by chunk (``dm_chunk``) and each state block staged at
    the padded pitch; a straddling row tile from its partials added in
    range order."""
    Sp, Bn = x.shape
    perm = torch.zeros(1024, dtype=torch.long)
    for w in range(512):
        d = _dm_chunk(w) // 8
        perm[2 * w], perm[2 * w + 1] = d, d + 1
    kt = pl.tile_k.long()
    images = torch.zeros((kt.numel(), 1024), dtype=torch.float64)
    images[:, perm] = pl.tiles  # images[i, perm[v]] = tile i's value v
    y = torch.full((Sp, Bn), float("nan"), dtype=torch.float64)
    lo, sp = pl.lo.tolist(), pl.seg_ptr.tolist()
    for b0 in range(0, Bn, TBD):
        cols = min(TBD, Bn - b0)
        partials = {}
        for c in range(len(lo) - 1):
            for rt, a, b, slot in pl.segs[sp[c]:sp[c + 1]].tolist():
                acc = torch.zeros((4, 2, NBD, 8, 8), dtype=torch.float64)
                for i in range(a, b):
                    X = torch.zeros((32, XLDD), dtype=torch.float64)
                    r0 = kt[i] * 32
                    X[:, :cols] = x[r0:r0 + 32, b0:b0 + cols]
                    _dmma_pass(acc, images[i], X)
                # row mb * 8 + g, column h * TBD / 2 + n * 8 + c
                blk = acc.permute(0, 3, 1, 2, 4).reshape(32, TBD)[:, :cols]
                if slot < 0:
                    y[rt * 32:(rt + 1) * 32, b0:b0 + cols] = blk
                else:
                    partials[slot] = blk
        for rt, (p0, n) in enumerate(pl.rt_parts.tolist()):
            if n:
                acc = partials[p0]
                for q in range(1, n):
                    acc = acc + partials[p0 + q]
                y[rt * 32:(rt + 1) * 32, b0:b0 + cols] = acc
    return y


@pytest.mark.parametrize("name", ["lm16", "dense256"])
def test_dmma_product_matches_the_twins_product(ops, name):
    """A torch emulation of the float64 K6a/K6b product (the tiles in
    A-fragment order, the B fragments from the padded stage, the k order
    of the m8n8k4 sums over the tile, the column blocks, the
    ranges' partials) within 1e-13 of ``dense_scan._product`` in float64,
    at a batch of 140 (full and ragged column blocks)."""
    rng = np.random.default_rng(11)
    if name not in ops:
        ops[name] = _MAKERS[name]()
    G = _GRIDS.get(name, ds._grid("cpu"))
    assert (ds._TILE_COLS_F64, ds._STAGES_F64) == (TBD, NSD)
    for w in ops[name]:
        w = w.double()
        pl = ds.tile_plan(w, G)
        x = torch.from_numpy(rng.uniform(0.0, 1.0, size=(w.shape[0], 140)))
        x[rng.integers(0, w.shape[0], size=w.shape[0] // 4)] = 0.0
        y = _dmma_tiled_product(pl, x)
        assert not torch.isnan(y).any()
        twin = ds._product(w)(x)
        np.testing.assert_allclose(y.numpy(), twin.numpy(), rtol=0,
                                   atol=TOL_DMMA)
