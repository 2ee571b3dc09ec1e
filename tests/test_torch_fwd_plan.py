"""The host plan of the persistent K2 and K3 (ops/block_scan.py
``fwd_plan``): the queue of work items (row tile x 64-column tile) that the
CTAs of the cooperative grid take in every frame, the phony row's tile; and
a torch emulation of the kernels' omega dot, the one grid-wide sum that a
frame needs of the frame before, against the per-frame finalize's order and
the plain twin.

Graphs: the 2M-arc LM ∘ HMM graph (V=128) and the separate-state backoff
graph (V=128, keep 0.1, the capped/overflow layout), each compiled 'high'
and 'bf16'.  Inputs are made from numpy seeds.  The CUDA kernels themselves
are held against the plain twins on the card by ``chip_smoke.py``."""
import functools

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import block_scan as bs
from _torch_port import compile_port, port_lm_graph

GRAPHS = [(g, dt) for g in ("2M", "separate") for dt in ("f32", "bf16")]
FR = 128  # the finalize's threads per column (csrc/block_scan.cu)
# the emulated omega dot against fwd_sweep_plain's phony row: a sum of
# ~49k positive float32 terms in another order, ~1e-7 relative in practice
TOL_REL = 1e-6


@functools.lru_cache(maxsize=None)
def _kop(graph, dt):
    prec = "bf16" if dt == "bf16" else "high"
    if graph == "2M":
        cf = compile_port(*port_lm_graph(128)[:3], strategy="block",
                          precision=prec)
    else:
        g = mt.workloads.make_backoff_lm_hmm_graph(V=128, keep=0.1,
                                                   layout="separate")
        cf = compile_port(*g[:3], precision=prec)
    assert bs.block_scan_reject_reason(cf, 128) is None
    return bs.kernel_operator(cf)


def _tile_rows(kop):
    """(n_tiles, 64) state rows of each forward row tile in the kernels'
    tile order (heavy rows, tier tiles, band tiles), -1 where a tile has
    fewer rows."""
    kd = kop.fwd
    K, _, D = kd.W.shape
    nh = kd.heavy_rows.numel()
    dt = -(-D // 64)
    band = kd.band_rows.numpy().astype(np.int64)
    nb = -(-len(band) // 64)
    rows = np.full((nh + K * dt + nb, 64), -1, np.int64)
    rows[:nh, 0] = kd.heavy_rows.numpy()
    dst = np.full((K, dt * 64), -1, np.int64)
    dst[:, :D] = kd.dst_rows.numpy()
    rows[nh:nh + K * dt] = dst.reshape(K * dt, 64)
    pad = np.full(nb * 64, -1, np.int64)
    pad[:len(band)] = band
    rows[nh + K * dt:] = pad.reshape(nb, 64)
    return rows


def _counts(kop):
    """(heavy tiles, tier tiles) of the forward step."""
    kd = kop.fwd
    return kd.heavy_rows.numel(), kd.W.shape[0] * -(-kd.W.shape[2] // 64)


@pytest.mark.parametrize("B", [128, 200])
@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_every_row_and_column_tile_once_per_frame(graph, dt, B):
    kop = _kop(graph, dt)
    pl = bs.fwd_plan(kop, B)
    items = pl.queue[:, 0].numpy().astype(np.int64)
    rows = _tile_rows(kop)
    assert pl.ncb == -(-B // 64) and len(items) == len(rows) * pl.ncb
    assert len(rows) == int(bs._imeta(kop, kop.fwd)[bs._N_TILES])
    kd = kop.fwd
    tile_of = bs._row_tiles(kd.dst_rows.numpy(), kd.band_rows.numpy(),
                            kd.heavy_rows.numpy(), kop.Sp)
    assert (tile_of[rows[rows >= 0]] == np.nonzero(rows >= 0)[0]).all()
    cover = np.zeros((kop.Sp, pl.ncb), np.int64)
    for r, c in zip(rows[items // pl.ncb], items % pl.ncb):
        np.add.at(cover[:, c], r[r >= 0], 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_queue_order_and_first_rows(graph, dt):
    """Heavy rows first; then the tier items spread evenly among the first
    _FWD_TIER_SPAN of the band items, each kind in tile, then column tile
    order; a band tile whose rows are consecutive is queued with its first
    row, every other tile with -1."""
    kop = _kop(graph, dt)
    pl = bs.fwd_plan(kop, 128)
    item, row0 = (pl.queue[:, k].numpy().astype(np.int64) for k in (0, 1))
    nh, nt = (n * pl.ncb for n in _counts(kop))
    assert sorted(item) == list(range(len(item)))
    np.testing.assert_array_equal(item[:nh], np.arange(nh))
    rest = item[nh:]
    is_tier = rest < nh + nt
    for kind in (is_tier, ~is_tier):
        assert (np.diff(rest[kind]) > 0).all()
    bands_before = np.cumsum(~is_tier)[is_tier]
    want = bs._FWD_TIER_SPAN * (len(rest) - nt) * np.arange(nt) / nt
    assert np.abs(bands_before - want).max() <= 1
    rows = _tile_rows(kop)[item // pl.ncb]
    run = (rows == rows[:, :1] + np.arange(64)) | (rows < 0)
    band = item >= nh + nt
    np.testing.assert_array_equal(
        row0, np.where(band & run.all(axis=1), rows[:, 0], -1))
    assert (row0[band] >= 0).mean() > 0.9


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_phony_row_tile(graph, dt):
    """The plan names the tile that holds the phony final row and that
    tile's first row as the queue carries it."""
    kop = _kop(graph, dt)
    pl = bs.fwd_plan(kop, 128)
    rows = _tile_rows(kop)
    assert kop.fin in rows[pl.fin_tile]
    item, row0 = (pl.queue[:, k].numpy() for k in (0, 1))
    at = item // pl.ncb == pl.fin_tile
    assert at.sum() == pl.ncb and (row0[at] == pl.fin_row0).all()
    if pl.fin_row0 >= 0:
        np.testing.assert_array_equal(
            rows[pl.fin_tile][rows[pl.fin_tile] >= 0],
            pl.fin_row0 + np.arange((rows[pl.fin_tile] >= 0).sum()))


def test_plan_is_cached_per_shape():
    kop = _kop("2M", "f32")
    assert bs.fwd_plan(kop, 128) is bs.fwd_plan(kop, 100)
    assert bs.fwd_plan(kop, 128) is not bs.fwd_plan(kop, 129)
    assert bs.fwd_plan(kop, 128) is not bs.bwd_plan(kop, 128)
    assert bs._fwd_grid(kop, "cpu", 128, torch.float32) == 396


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding of
    the sum to float32 (after float64's, which can differ from a single
    rounding only at a float32 halfway point)."""
    return (a.double() * b.double() + c.double()).float()


def _tile_partials(kop, rows, x):
    """Each tile's partial of omega . x per column (n_tiles, B), as an item
    sums it: thread row ty's 4 rows by fused multiply-adds in row order,
    then the 16 thread rows in order from 0."""
    n, B = len(rows), x.shape[1]
    om = torch.cat([kop.omega, kop.omega.new_zeros(1)])[rows]  # (n, 64)
    xr = torch.cat([x, x.new_zeros((1, B))])[rows]  # (n, 64, B)
    valid = torch.from_numpy(rows >= 0)
    th = torch.zeros((n, 16, B))
    for i in range(4):
        r = torch.arange(16) * 4 + i
        v = _fma(om[:, r, None], xr[:, r], th)
        th = torch.where(valid[:, r, None], v, th)
    sm = torch.zeros((n, B))
    for q in range(16):
        sm = sm + th[:, q]
    return sm


def _finalize_sum(part):
    """The per-frame finalize's reduction of (n_tiles, B) partials: thread
    ry sums every FR-th tile from ry in order from 0, then a tree of FR
    halving steps."""
    n, B = part.shape
    r = torch.zeros((FR, B))
    for t in range(n):
        r[t % FR] = r[t % FR] + part[t]
    h = FR // 2
    while h:
        r[:h] = r[:h] + r[h:2 * h]
        h //= 2
    return r[0]


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_omega_dot_order(graph, dt):
    """The phony row of frame t+1 from a state of frame t (four plain
    frames in from a seeded start, B=72: a partial column tile): the
    kernels' sum, each tile's partial from the rows its item has just
    computed (the phony row's own value there is the item's provisional
    (M a)·s·e) but the phony row's tile's taken again from the final rows,
    reduced in the finalize's order, is bit-equal to the per-frame
    finalize's sum of partials taken from the final rows; times the scale
    and the emission, within TOL_REL of fwd_sweep_plain's phony row."""
    kop = _kop(graph, dt)
    B, t = 72, 4
    pl = bs.fwd_plan(kop, B)
    rng = np.random.default_rng(9)
    ext = torch.from_numpy(rng.uniform(0.2, 1.0, size=(t + 2, kop.P1, B))
                           .astype(np.float32))
    msh = torch.zeros((t + 2, 1, B))
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    prev, s_prev = bs.fwd_sweep_plain(kop, a0, ext[:t], msh[:t], t)[2:4]
    a_t, s_t = bs.fwd_sweep_plain(kop, a0, ext[:t + 1], msh[:t + 1],
                                  t + 1)[2:4]
    want = bs.fwd_sweep_plain(kop, a0, ext, msh, t + 2)[2][kop.fin]
    rows = _tile_rows(kop)
    items_y = a_t.clone()  # the rows as the items computed them
    e = bs._emissions(kop, ext[t])
    items_y[kop.fin] = (bs._matvec_plain(kop.fwd, prev)[kop.fin]
                        * s_prev * e[kop.fin])
    part = _tile_partials(kop, rows, items_y)
    part[pl.fin_tile] = _tile_partials(kop, rows[pl.fin_tile:pl.fin_tile + 1],
                                       a_t)[0]
    got = _finalize_sum(part)
    ref = _finalize_sum(_tile_partials(kop, rows, a_t))
    assert torch.equal(got, ref)
    pfin = int(kop.row_pdf[kop.fin])
    yfin = got * s_t * ext[t + 1, pfin]
    assert (want > 0).all()
    np.testing.assert_allclose(yfin.numpy(), want.numpy(), rtol=TOL_REL,
                               atol=0)
