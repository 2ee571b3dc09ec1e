"""The host plan of the persistent K4 (ops/block_scan.py ``bwd_plan``): the
queue of work items (row tile x 64-column tile) that the CTAs of the
cooperative grid take in every frame of a chunk; and a torch emulation of
the kernel's sums, in the kernel's order, against the plain twin.

Graphs: the 2M-arc LM ∘ HMM graph (V=128) and the separate-state backoff
graph (V=128, keep 0.1, the capped/overflow layout), each compiled 'high'
and 'bf16'.  The V=8 and V=16 LM ∘ HMM graphs and the V=16 separate-state
graph are refused by the blocked kernels' admission (a non-affine tier, or
two tiers), so they have no K4 plan.  Grids of 8 to 528 CTAs (up to 4 per
SM of an H100).  Inputs are made from numpy seeds.  The CUDA kernel itself
is held against the plain twin on the card by ``chip_smoke.py``."""
import functools

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops.blocked import round_bf16
from _torch_port import compile_port, port_lm_graph

GRIDS = (8, 132, 264, 396, 528)
GRAPHS = [(g, dt) for g in ("2M", "separate") for dt in ("f32", "bf16")]
TOL_REL = 1e-6  # the emulated kernel order vs the plain twin: posteriors
# beta: a row's y sums up to 129 terms (a heavy row's family) in another
# order than the twin's, ~129 * 2^-24 = 7.7e-6 relative at worst
TOL_BETA = 1e-5


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
    kop = bs.kernel_operator(cf)
    assert kop.bwd.W.dtype == (torch.bfloat16 if dt == "bf16"
                               else torch.float32)
    return kop


def _counts(kop):
    """(heavy tiles, tier tiles, all row tiles) of the backward step."""
    kd = kop.bwd
    nh, nt = kd.heavy_rows.numel(), kd.W.shape[0] * -(-kd.W.shape[2] // 64)
    return nh, nt, nh + nt + -(-kd.band_rows.numel() // 64)


def _items(pl):
    """The queued items: tile * ncb + column tile."""
    return pl.queue[:, 0].numpy().astype(np.int64)


def _tile_rows(kop):
    """(n_tiles, 64) state rows of each row tile in the kernel's tile row
    order, -1 where a tile has fewer rows."""
    kd = kop.bwd
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


@pytest.mark.parametrize("B", [128, 200])
@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_every_row_and_column_tile_once_per_frame(graph, dt, B):
    kop = _kop(graph, dt)
    pl = bs.bwd_plan(kop, B)
    items = _items(pl)
    rows = _tile_rows(kop)
    assert pl.ncb == -(-B // 64) and len(items) == len(rows) * pl.ncb
    kd = kop.bwd
    tile_of = bs._row_tiles(kd.dst_rows.numpy(), kd.band_rows.numpy(),
                            kd.heavy_rows.numpy(), kop.Sp)
    assert (tile_of[rows[rows >= 0]] == np.nonzero(rows >= 0)[0]).all()
    cover = np.zeros((kop.Sp, pl.ncb), np.int64)
    for r, c in zip(rows[items // pl.ncb], items % pl.ncb):
        np.add.at(cover[:, c], r[r >= 0], 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_queue_names_the_first_row_of_consecutive_band_tiles(graph, dt):
    """A band tile whose rows are consecutive is queued with its first row
    (the kernel then reads no row list); every other tile with -1."""
    kop = _kop(graph, dt)
    pl = bs.bwd_plan(kop, 128)
    item, row0 = (pl.queue[:, k].numpy().astype(np.int64) for k in (0, 1))
    rows = _tile_rows(kop)[item // pl.ncb]
    nh, nt, _ = _counts(kop)
    run = (rows == rows[:, :1] + np.arange(64)) | (rows < 0)
    band = item // pl.ncb >= nh + nt
    want = np.where(band & run.all(axis=1), rows[:, 0], -1)
    np.testing.assert_array_equal(row0, want)
    assert ((rows >= 0).sum(axis=1) > 0).all()
    assert (row0[band] >= 0).mean() > 0.9


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_queue_interleaves_tier_and_band_items(graph, dt):
    """Heavy rows first; then the tier items spread evenly among the first
    _TIER_SPAN of the band items, and the tail band items only; each kind
    in tile, then column tile order."""
    kop = _kop(graph, dt)
    pl = bs.bwd_plan(kop, 128)
    items = _items(pl)
    nh, nt, _ = _counts(kop)
    nh, nt = nh * pl.ncb, nt * pl.ncb
    assert sorted(items) == list(range(len(items)))
    np.testing.assert_array_equal(items[:nh], np.arange(nh))
    rest = items[nh:]
    is_tier = rest < nh + nt
    for kind in (is_tier, ~is_tier):
        assert (np.diff(rest[kind]) > 0).all()
    nb = len(rest) - nt
    bands_before = np.cumsum(~is_tier)[is_tier]  # band items ahead of each
    want = bs._TIER_SPAN * nb * np.arange(nt) / nt
    assert np.abs(bands_before - want).max() <= 1


@pytest.mark.parametrize("n_ctas", GRIDS)
@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_cost_per_cta_is_balanced(graph, dt, n_ctas):
    """The queue ends on short items: after its last long one (a heavy row's
    or a tier tile's, up to twice a band item's time as traced, PERF.md
    §6) come at least as many band items as the grid has CTAs (or half of
    all band items, the most a tier span of 0.5 would leave), so a CTA that
    takes a long item late still finds the others busy with short ones."""
    kop = _kop(graph, dt)
    pl = bs.bwd_plan(kop, 128)
    items = _items(pl)
    nh, nt, _ = _counts(kop)
    long_ = items // pl.ncb < nh + nt
    tail = len(items) - 1 - np.nonzero(long_)[0].max()
    assert tail >= min(n_ctas, (~long_).sum() // 2)


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_at_most_two_posterior_contributions(graph, dt):
    """Every (pdf group, column) of a frame takes at most two atomic adds:
    one per item that holds a uniform (non-overflow) row of the pdf, so
    the sum is the same in either order."""
    kop = _kop(graph, dt)
    pl = bs.bwd_plan(kop, 128)
    items = _items(pl)
    rows = _tile_rows(kop)
    pdf = kop.row_pdf.numpy().astype(np.int64)
    n = np.zeros((kop.P1, pl.ncb), np.int64)
    for r, c in zip(rows[items // pl.ncb], items % pl.ncb):
        r = r[(r >= 0) & ((r < kop.ov_lo) | (r >= kop.ov_hi))]
        n[np.unique(pdf[r]), c] += 1
    assert n.max() <= 2
    assert n.max() == bs._posterior_tiles(kop)


def test_plan_is_cached_per_shape():
    kop = _kop("2M", "f32")
    assert bs.bwd_plan(kop, 128) is bs.bwd_plan(kop, 100)
    assert bs.bwd_plan(kop, 128) is not bs.bwd_plan(kop, 129)
    assert bs._bwd_grid(kop, "cpu", 128, torch.float32) == 528


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding of
    the sum to float32 (after float64's, which can differ from a single
    rounding only at a float32 halfway point)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_y(kop, b, s):
    """y = (M b + omega * b[fin]) * s with K4's sums in K4's order
    (csrc/block_scan.cu bwd_item): the float32 capped layout's tier rows
    start from their family terms (the first a product, the rest fused
    multiply-adds in list order), then the tier product in s order (bf16:
    16-deep tensor-core steps, float32 accumulation); a heavy row's terms
    in 16 partial sums (thread row ty every 16th term), added after its
    bands; every row's bands in offset order; the other rows' family terms
    after the bands; then fma(omega, b[fin], v) * s."""
    kd = kop.bwd
    Sp, B = b.shape
    acc = torch.zeros_like(b)
    ptr = kd.fam_ptr.long()
    n_terms = ptr[1:] - ptr[:-1]
    fam = kop.ov_lo < kop.ov_hi
    bf16 = kd.W.dtype == torch.bfloat16
    is_tier = torch.zeros(Sp, dtype=torch.bool)
    is_tier[kd.dst_rows.reshape(-1)] = True
    is_heavy = torch.zeros(Sp, dtype=torch.bool)
    is_heavy[kd.heavy_rows.long()] = True

    def terms(rows, first_product):
        """Each row's family terms into acc, in list order."""
        for r in range(int(n_terms[rows].max()) if len(rows) else 0):
            sel = rows[n_terms[rows] > r]
            q = ptr[sel] + r
            w = kd.fam_w[q][:, None]
            x = b[kd.fam_src[q].long()]
            acc[sel] = (w * x if first_product and r == 0
                        else _fma(w, x, acc[sel]))

    if fam and not bf16:
        terms(torch.nonzero(is_tier).ravel(), True)
    dst = kd.dst_rows
    X = b[kd.src_rows]  # (K, Sm, B)
    if bf16:
        W, X = kd.W.float(), round_bf16(X)
        T = torch.zeros((dst.shape[0], dst.shape[1], B))
        for s0 in range(0, W.shape[1], 16):
            step = torch.einsum("ksd,ksb->kdb", W[:, s0:s0 + 16].double(),
                                X[:, s0:s0 + 16].double())
            T = (T.double() + step).float()
    else:
        T = acc[dst]
        for si in range(kd.W.shape[1]):
            T = _fma(kd.W[:, si, :, None], X[:, si, None, :], T)
    acc[dst] = T
    heavy = kd.heavy_rows.long()
    part = torch.zeros((16, len(heavy), B))
    for ty in range(16):
        for r in range(ty, int(n_terms[heavy].max()) if len(heavy) else 0, 16):
            m = n_terms[heavy] > r
            q = ptr[heavy[m]] + r
            part[ty, m] = _fma(kd.fam_w[q][:, None],
                               b[kd.fam_src[q].long()], part[ty, m])
    rows = torch.arange(Sp)
    for o, off in enumerate(kd.offsets):
        src = rows - off
        ok = (src >= 0) & (src < Sp)
        acc[ok] = _fma(kd.band_w[o][ok][:, None], b[src[ok]], acc[ok])
    if fam:
        pulled = ~is_heavy if bf16 else ~is_heavy & ~is_tier
        terms(torch.nonzero(pulled & (n_terms > 0)).ravel(), False)
    for ty in range(16):
        acc[heavy] = acc[heavy] + part[ty]
    return _fma(kop.omega[:, None], b[kop.fin][None, :], acc) * s


def emulate(kop, pl, beta, bscale, alphas, ascale, ext_c, t0, npad):
    """K4's frames and its combine order in torch: per frame, y as
    _kernel_y sums it; gamma = (alpha * ascale) * y; each item's column sum
    of gamma (each thread row's 4 rows, then its 16 thread rows in order),
    kept per item; an item whose rows all lie in one pdf group adds that
    sum to the group's posterior, any other item the sums of its runs of
    rows of one group (rows in order), at most two adds per (group,
    column), so order-free; the overflow rows' gammas kept.  After the
    chunk: each column's sum over the items of its column tile (8 thread
    rows, each every 8th row tile in order, then the 8 in order), the
    overflow rows' gammas added to their pdfs in lane order, the
    division."""
    K, P1, B = ext_c.shape
    ncb, W = pl.ncb, pl.ncb * 64
    rows = torch.from_numpy(_tile_rows(kop))
    n_tiles = len(rows)
    pdf = kop.row_pdf.long()
    grp = torch.where((torch.arange(kop.Sp) >= kop.ov_lo)
                      & (torch.arange(kop.Sp) < kop.ov_hi), -1, pdf)
    grp = torch.cat([grp, torch.tensor([-1])])[rows]  # (n_tiles, 64)
    valid = grp >= 0
    first = grp[:, 0]
    one_group = (first >= 0) & ((grp == first[:, None]) | (rows < 0)).all(1)
    ptr, lane = kop.ovp_ptr.numpy(), kop.ovp_lane.numpy()
    posts = beta.new_zeros((K, P1, W))
    csum = beta.new_zeros((K, n_tiles, W))
    ovg = beta.new_zeros((K, kop.ov_hi - kop.ov_lo, B))
    b, s = beta, bscale
    for j in reversed(range(K)):
        y = (torch.ones_like(b) if t0 + j == npad - 1
             else _kernel_y(kop, b, s))
        g = alphas[j] * ascale[j] * y
        gz = torch.cat([g, g.new_zeros((1, B))])  # row -1: zeros
        gt = torch.nn.functional.pad(gz[rows], (0, W - B))  # (n, 64, W)
        part = gt.reshape(n_tiles, 16, 4, W)
        th = torch.zeros((n_tiles, 16, W))
        for i in range(4):
            th = th + part[:, :, i]
        for q in range(16):
            csum[j] = csum[j] + th[:, q]
        posts[j].index_add_(0, first[one_group], csum[j][one_group])
        mixed = torch.nonzero(~one_group).ravel()
        cur = torch.full((len(mixed),), -1)
        run = torch.zeros((len(mixed), W))
        for q in range(65):
            gq = grp[mixed, q] if q < 64 else torch.full_like(cur, -2)
            flush = (gq != -1) & (gq != cur) & (cur >= 0)
            posts[j].index_add_(0, cur[flush], run[flush])
            new = (gq >= 0) & (gq != cur)
            cur = torch.where(new, gq, cur)
            run[new] = 0.0
            if q < 64:
                add = valid[mixed, q]
                run[add] = run[add] + gt[mixed[add], q]
        ovg[j] = g[kop.ov_lo:kop.ov_hi]
        b = y * bs._emissions(kop, ext_c[j])
        s = bs._pow2_scale(bs._pow2_exponent(b.amax(dim=0)))
    out = beta.new_empty((K, P1, B))
    for j in range(K):
        rs = torch.zeros((8, W))
        for t in range(n_tiles):
            rs[t % 8] = rs[t % 8] + csum[j, t]
        tot = torch.zeros(W)
        for q in range(8):
            tot = tot + rs[q]
        tot = tot[:B]
        den = torch.where(tot > 0, tot, torch.ones_like(tot))
        for p in range(P1):
            v = posts[j, p, :B].clone()
            for ln in lane[ptr[p]:ptr[p + 1]]:
                v = v + ovg[j, ln]
            out[j, p] = v / den
    return out, b, s


@pytest.mark.parametrize("graph,dt", GRAPHS)
def test_combine_order_matches_the_twin(graph, dt):
    """The emulated kernel order against ``backward_plain`` over two chunks
    of 3 frames (the last padded frame, which starts from beta = 1, then
    one in the middle of a sweep) at B=72 (a partial column tile): the
    posteriors within TOL_REL of the twin's, beta_out times its scale
    within TOL_BETA."""
    kop = _kop(graph, dt)
    B, K, npad = 72, 3, 9
    pl = bs.bwd_plan(kop, B)
    rng = np.random.default_rng(5)
    f32 = lambda *shape: torch.from_numpy(
        rng.uniform(0.5, 1.5, size=shape).astype(np.float32))
    beta, bsc = torch.ones((kop.Sp, B)), torch.ones(B)
    for t0 in (npad - K, npad - 2 * K):
        alphas = f32(K, kop.Sp, B)
        ascale = torch.from_numpy(
            2.0 ** rng.integers(-3, 4, size=(K, B)).astype(np.float32))
        ext_c = f32(K, kop.P1, B)
        want = bs.backward_plain(kop, beta, bsc, alphas, ascale, ext_c, t0,
                                 npad)
        got = emulate(kop, pl, beta, bsc, alphas, ascale, ext_c, t0, npad)
        assert (want[0].sum(dim=1) - 1).abs().max() < 1e-5
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   rtol=TOL_REL, atol=TOL_REL)
        np.testing.assert_allclose((got[1] * got[2]).numpy(),
                                   (want[1] * want[2]).numpy(),
                                   rtol=TOL_BETA, atol=0)
        beta, bsc = want[1], want[2]
