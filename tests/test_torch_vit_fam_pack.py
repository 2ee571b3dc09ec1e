"""K7's family branch in float32 with its heavy rows four to an item
(ops/vit_scan.py ``vit_plan(packed=True)``, csrc/vit_scan.cu ``heavy_ids``)
and its core rows' family terms merged as they come, on the separate-state
backoff graph (V=128, keep 0.1: 128 heavy rows of 128-129 terms, one term
on each of 16,256 other rows).

A torch emulation of the kernel's heavy items: thread row ty of a packed
item takes heavy row ty / 4 and its terms q ≡ ty (mod 4), keeping per
column the max of w · (a · s) and the smallest id among the terms equal to
it (``fam_beats``); the four partials merged by the same rule.  It equals
the one-row item's 16-way merge and the twin's family candidate.  The core
rows' rule (each term taken where it is larger than the candidate so far,
or equal to a family term's of a larger id) after the bands and the tier
gives the twin's ids (``block_matvec_max_arg``).  Inputs are made from
numpy seeds on a tie-heavy state with per-column power-of-two scales.  The
CUDA kernel is held against its twin on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import compile_port

F32 = torch.float32
HP = vs._HEAVY_PACK
NO_CAND = 255


@pytest.fixture(scope="module")
def sep():
    g = mt.workloads.make_backoff_lm_hmm_graph(V=128, keep=0.1,
                                               layout="separate")
    ct = compile_port(*g[:3], strategy="block")
    kop = bs.kernel_operator(ct, F32)
    return ct, kop, vs.fam_tables(ct, kop)


def _inputs(ct, B=8, seed=5):
    """A tie-heavy state (the main region; zero past it) and per-column
    power-of-two scales."""
    rng = np.random.default_rng(seed)
    a = rng.choice(np.array([0, 0.25, 0.5, 1], np.float32),
                   size=(ct.padded_states, B))
    a[vs._main_region(ct):] = 0.0
    sc = np.exp2(rng.integers(-3, 4, size=B)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(sc)


def _beats(v, i, bv, bi):
    """fam_beats: a larger product, or an equal one of a smaller id."""
    return (v > bv) | ((v == bv) & (i < bi))


def _partial(kd, cid, a, sc, j, start, step):
    """One thread row's (max, smallest id) over row j's terms start,
    start + step, .. (from -1 and no id: the first term enters)."""
    ptr, src = kd.fam_ptr, kd.fam_src.long()
    B = a.shape[1]
    bv = torch.full((B,), -1.0, dtype=F32)
    bi = torch.full((B,), NO_CAND, dtype=torch.long)
    for q in range(int(ptr[j]) + start, int(ptr[j + 1]), step):
        v = kd.fam_w[q] * (a[src[q]] * sc)
        take = _beats(v, int(cid[q]), bv, bi)
        bv = torch.where(take, v, bv)
        bi = torch.where(take, int(cid[q]), bi)
    return bv, bi


def _merge(parts):
    """The partials merged in thread-row order by fam_beats."""
    bv, bi = parts[0]
    for v, i in parts[1:]:
        take = _beats(v, i, bv, bi)
        bv, bi = torch.where(take, v, bv), torch.where(take, i, bi)
    return bv, bi


def test_k7_takes_the_packed_queue(sep):
    """The packed queue K7 and K7n take in float32 leads with ceil(128 /
    4) heavy items per column tile and holds the library's item count; the
    one-row queue (float64) one heavy item per row and column tile."""
    ct, kop, _ = sep
    kd = kop.fwd
    nh = kd.heavy_rows.numel()
    assert nh == 128 and vs._is_fam(kop)
    for B in (128, 126):
        pk, one = vs.vit_plan(kop, B, packed=True), vs.vit_plan(kop, B)
        _, _, _, n_tiles = bs._tile_counts(kd, B)
        assert pk.queue.shape[0] == (n_tiles - nh + -(-nh // HP)) * pk.ncb
        assert one.queue.shape[0] == n_tiles * one.ncb
        heavy_items = pk.queue[:, 0].numpy() < -(-nh // HP) * pk.ncb
        assert heavy_items[:-(-nh // HP) * pk.ncb].all()
        assert heavy_items.sum() == -(-nh // HP) * pk.ncb


def test_k7_row_table(sep):
    """``fam_tables``' per-row table, which K7 reads in the epilogue: each
    row's terms [fam_ptr[j], fam_ptr[j + 1]), its band ids' base (its
    overflow group's C_g, else Sm) and its emission row (its pdf group,
    the phony pdf on the tail)."""
    ct, kop, ft = sep
    fr = ft.frow.long()
    ptr = kop.fwd.fam_ptr.long()
    assert fr.shape == (kop.Sp, 4) and ft.frow.dtype == torch.int32
    assert torch.equal(fr[:, 0], ptr[:-1]) and torch.equal(fr[:, 1], ptr[1:])
    j = torch.arange(kop.Sp)
    ov = (j >= kop.ov_lo) & (j < kop.ov_hi)
    Sm = kop.fwd.W.shape[1]
    assert (fr[~ov, 2] == Sm).all()
    assert torch.equal(fr[ov, 2],
                       ft.cbase.long()[(j[ov] - kop.ov_lo) // kop.cmax])
    core, tail = j < kop.ov_lo, j >= kop.ov_hi
    assert torch.equal(fr[core, 3], j[core] // kop.cmax)
    assert (fr[tail, 3] == kop.P1 - 1).all()
    assert torch.equal(fr[:, 3], kop.row_pdf.long())


def test_packed_heavy_ids_equal_the_16_way_merge_and_the_twin(sep):
    """Every packed heavy item's rows: the 4-way merge of heavy_ids equals
    the 16-way merge of heavy_max_arg, value and id, and the twin's family
    candidate (the max over the row's terms and the smallest id in K7's
    table among the terms equal to it), bit for bit."""
    ct, kop, ft = sep
    kd = kop.fwd
    a, sc = _inputs(ct)
    heavy = kd.heavy_rows.long()
    cid = ft.cid.long()
    th = 16 // HP
    ptr, src = kd.fam_ptr.long(), kd.fam_src.long()
    for tile in range(-(-heavy.numel() // HP)):
        for r in range(HP):
            if tile * HP + r >= heavy.numel():
                continue
            j = int(heavy[tile * HP + r])
            got = _merge([_partial(kd, cid, a, sc, j, u, th)
                          for u in range(th)])
            one = _merge([_partial(kd, cid, a, sc, j, u, 16)
                          for u in range(16)])
            q = torch.arange(int(ptr[j]), int(ptr[j + 1]))
            v = kd.fam_w[q, None] * (a[src[q]] * sc)
            m = v.amax(dim=0)
            want = torch.where(v == m, cid[q, None], 256).amin(dim=0)
            assert torch.equal(got[0].view(torch.int32),
                               one[0].view(torch.int32))
            assert torch.equal(got[1], one[1])
            assert torch.equal(got[0].view(torch.int32), m.view(torch.int32))
            assert torch.equal(got[1], want)


def test_core_rows_merged_as_they_come_give_the_twins_ids(sep):
    """The core and overflow rows' family terms (at most one a row here),
    their ranges from the per-row table, merged after the bands and the
    tier by the kernel's rule, the heavy rows' candidates merged with a
    strict >, give the twin's values and ids on every row."""
    ct, kop, ft = sep
    kd = kop.fwd
    a, sc = _inputs(ct, seed=9)
    x = a * sc  # the rescaled state the twin reads
    ov_lo, nOv, cmax = vs.ov_span(ct)
    op, meta = ct.block_fwd, ct.block_fwd_offsets
    y, cand = tbl.block_matvec_max_arg(op, meta, x,
                                       ov_span=(ov_lo, nOv, cmax))
    # bands and tier alone, the overflow rows' band ids from their base
    y0, c0 = tbl.block_matvec_max_arg(op._replace(ov_w=()), meta[:3] + ((),),
                                      x)
    Sm, nO = kd.W.shape[1], len(meta[0])
    rows = torch.arange(ov_lo, ov_lo + nOv * cmax)
    band = (c0[rows] >= Sm) & (c0[rows] < Sm + nO)
    base = ft.cbase.long()[(rows - ov_lo) // cmax][:, None]
    c0[rows] = torch.where(band, c0[rows] - Sm + base.int(), c0[rows])
    vb, cb = y0.clone(), c0.long()
    fr = ft.frow.long()  # each row's terms, as the kernel reads them
    ptr, src, cid = fr[:, 0], kd.fam_src.long(), ft.cid.long()
    n = fr[:, 1] - fr[:, 0]
    is_heavy = torch.zeros(n.numel(), dtype=torch.bool)
    is_heavy[kd.heavy_rows.long()] = True
    fam = torch.zeros_like(vb, dtype=torch.bool)
    for k in range(int(n[~is_heavy].max())):
        r = torch.nonzero((n > k) & ~is_heavy)[:, 0]
        q = ptr[r] + k
        v = kd.fam_w[q, None] * (a[src[q]] * sc)
        i = cid[q, None]
        take = (v > vb[r]) | ((v == vb[r]) & fam[r] & (i < cb[r]))
        vb[r] = torch.where(take, v, vb[r])
        cb[r] = torch.where(take, i, cb[r])
        fam[r] |= take
    for j in kd.heavy_rows.long().tolist():
        hv, hi = _merge([_partial(kd, cid, a, sc, j, u, 16 // HP)
                         for u in range(16 // HP)])
        take = hv > vb[j]
        vb[j] = torch.where(take, hv, vb[j])
        cb[j] = torch.where(take, hi, cb[j])
    assert torch.equal(vb.view(torch.int32), y.view(torch.int32))
    assert torch.equal(cb.int(), cand)
    assert int((cb != c0.long()).sum()) > 100  # the families win somewhere
