"""The float64 tier of K7 and K7n (csrc/vit_scan.cu ``tier_dbl``): a torch
emulation of what the kernel computes for one work item, held bit for bit
to the plain twin's rule (``blocked._tier_max_arg``: the largest product
and the smallest position attaining it) in float64.

What is emulated, with the kernel's constants read from its source: which
16-byte chunk of a ring stage each thread copies (row, column pair) from
the untransposed panel and the gathered state rows, where it lands at the
stage's padded pitch, and the thread's in-place rescale of its own state
chunks once they have landed; the ring's schedule (stage st in slot st %
NVS, the copies of the stage NVS - 1 ahead issued after a stage's
barrier); the values each thread reads for its 4 x 4 outputs (rows ty*4 +
i, columns 2tx + {0, 1, 32, 33}); the running max and first position of
each output, candidate by candidate in position order, "product > max"
compared as doubles (the kernel's DSETP), or without ids the running max
alone; where each output lands in the epilogue's table.  Inputs are made
from numpy seeds: products from {0, 1/4, 1/2, 1} (many exact ties),
signed zeros, an all-zero column, denormal products, per-column
power-of-two scales, at B = 128, 126 and 5 (B % 4 != 0: the kernel's
scalar branch), Sm = 128 and 200 (a partial last stage), D = 128 and 100
(a partial row tile).  The bank map of the loop's 16-byte reads, of the
copies and of the rescale pass is checked conflict-free, lane by lane.
The double epilogue's family rule (each term merged as it comes) is held
to the float epilogue's (the family's candidate merged after the bands).
The CUDA kernels are held against the twins on the card by
``chip_smoke.py`` (phases 44 and 53)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import compile_port, inputs, port_lm_graph

CSRC = Path(mt.__file__).parent / "ops" / "csrc"


def _constants():
    """The integer constants of block_common.cuh and vit_scan.cu, each
    ``constexpr int NAME = expr;`` evaluated in order."""
    env = {}
    for name in ("block_common.cuh", "vit_scan.cu"):
        for k, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                  (CSRC / name).read_text(), re.M):
            env[k] = eval(expr, {}, dict(env))
    return env


C_ = _constants()
TR, TB, NT = C_["TR"], C_["TB"], C_["NT"]
DV, DVP, NVS, DVSTAGE = C_["DV"], C_["DVP"], C_["NVS"], C_["DVSTAGE"]
SM_BYTES = 233_472  # shared memory of an H100 SM (228 KB)
CTA_RESERVED = 1024  # what the card reserves per resident CTA
F64 = torch.float64


def test_constants_of_the_double_tier():
    """The layout the emulation below reads: stages of 16 positions at a
    pitch of 66 doubles, four in the ring, 256 threads on 64 x 64 items,
    2 CTAs per SM."""
    assert (TR, TB, NT, C_["VIT_BLOCKS"]) == (64, 64, 256, 2)
    assert (DV, DVP, NVS, DVSTAGE) == (16, 66, 4, 2 * 16 * 66)
    assert DV % 8 == 0 and DVP % 2 == 0


# ---------------------------------------------------------------------------
# the thread maps
# ---------------------------------------------------------------------------

_TID = torch.arange(NT)
_TX, _TY = _TID % 16, _TID // 16
_CR, _CC = _TID // 32, (_TID % 32) * 2  # the copy map: row, column pair
_I4 = torch.arange(4)


def _wcol():
    """(NT, 4): the panel column (row d of the item) of output i."""
    return _TY[:, None] * 4 + _I4[None, :]


def _dcol():
    """(NT, 4): the item column of output c (``dcol``)."""
    return 2 * _TX[:, None] + (_I4[None, :] & 1) + 32 * (_I4[None, :] >> 1)


def test_outputs_cover_the_item_once():
    """The 256 threads' 4 x 4 outputs are the 64 x 64 outputs of the item,
    each once."""
    hits = torch.zeros((TR, TB), dtype=torch.int64)
    d = _wcol()[:, :, None].expand(-1, -1, 4)
    b = _dcol()[:, None, :].expand(-1, 4, -1)
    hits.index_put_((d.reshape(-1), b.reshape(-1)),
                    torch.ones(d.numel(), dtype=torch.int64), accumulate=True)
    assert (hits == 1).all()


def test_copies_cover_each_half_once():
    """Every (row, column) of a DV x 64 half of a stage is copied by
    exactly one thread, as a 16-byte pair on a 16-byte boundary; the
    pitch, the halves and the slots keep 16-byte alignment."""
    seen = torch.zeros((DV, TB), dtype=torch.int64)
    for u in range(DV // 8):
        for e in range(2):
            seen.index_put_((_CR + 8 * u, _CC + e),
                            torch.ones(NT, dtype=torch.int64),
                            accumulate=True)
        assert (((_CR + 8 * u) * DVP + _CC) * 8 % 16 == 0).all()
    assert (seen == 1).all()
    assert DVP * 8 % 16 == 0 and DV * DVP * 8 % 16 == 0
    assert DVSTAGE * 8 % 16 == 0


def _wavefronts(byte_addr, width):
    """Shared-memory wavefronts of one warp access (``byte_addr`` (32,)
    the first byte of each lane's ``width``-byte access): the warp splits
    into phases of 128 / width lanes; in each, a bank (4-byte word mod 32)
    that holds k distinct words takes k wavefronts.  Returns the most that
    any phase needs (1: conflict-free)."""
    lanes = 128 // width
    worst = 0
    for p0 in range(0, 32, lanes):
        words = set()
        for a in byte_addr[p0:p0 + lanes].tolist():
            words.update(range(a // 4, a // 4 + width // 4))
        per_bank = {}
        for w in words:
            per_bank.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(v) for v in per_bank.values()))
    return worst


@pytest.mark.parametrize("slot", range(NVS))
def test_loop_reads_are_free_of_bank_conflicts(slot):
    """Per position r of a stage, each warp's four 16-byte reads in the
    tier loop (its rows' weights w01, w23 and its columns' states x01,
    x23) need one wavefront
    per quarter warp: a row's weights share one address per quarter warp,
    the columns' pairs are 16 distinct chunks of one row."""
    base = slot * DVSTAGE
    for warp in range(NT // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        tx, ty = _TX[lanes], _TY[lanes]
        for r in range(DV):
            for off in (ty * 4, ty * 4 + 2, DV * DVP + 2 * tx,
                        DV * DVP + 2 * tx + 32):
                addr = (base + r * DVP + off) * 8
                assert (addr % 16 == 0).all()
                assert _wavefronts(addr, 16) == 1, (warp, r)


@pytest.mark.parametrize("half", [0, 1])
def test_copies_and_rescale_are_free_of_bank_conflicts(half):
    """The 16-byte chunks each warp writes (cp.async) into the panel's or
    the states' half of a stage, and the states' chunks it reads and
    writes back in the rescale pass: one wavefront per quarter warp."""
    for warp in range(NT // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        for u in range(DV // 8):
            addr = (half * DV * DVP + (_CR[lanes] + 8 * u) * DVP
                    + _CC[lanes]) * 8
            assert _wavefronts(addr, 16) == 1


# ---------------------------------------------------------------------------
# the ring's schedule
# ---------------------------------------------------------------------------

def _schedule(nst):
    """The ring as the kernel runs it: per iteration st, (the slot that
    lands and is reduced, the slot the copies issued after the barrier
    fill, or None past the last stage)."""
    return [(st % NVS, (st + NVS - 1) % NVS if st + NVS - 1 < nst else None)
            for st in range(nst)]


@pytest.mark.parametrize("nst", range(1, 12))
def test_ring_schedule(nst):
    """Stages NVS - 1 ahead are in flight; the copies issued in an
    iteration never fill the slot it reduces, and fill a slot only after
    the barrier that follows that slot's last read (the iteration
    before)."""
    holder, last_read = {}, {}
    for st in range(min(NVS - 1, nst)):  # the prologue's copies
        holder[st % NVS] = st
    for st, (slot, nxt) in enumerate(_schedule(nst)):
        assert holder[slot] == st  # landed in its slot, not overwritten
        last_read[slot] = st
        if nxt is not None:
            assert nxt != slot
            assert last_read.get(nxt, -1) < st
            holder[nxt] = st + NVS - 1


# ---------------------------------------------------------------------------
# one work item, emulated
# ---------------------------------------------------------------------------

def _stage_image(Wk, Xu, sc, st, dbase, b0):
    """Slot image (DVSTAGE doubles) of stage ``st`` once it has landed and
    been rescaled: the chunk map's copies of the panel Wk (Sm, D) and of
    the gathered, unscaled state rows Xu (Sm, Bn), zero past Sm, D and Bn
    (the copies' zero fill), each state value times its column's scale
    ``sc`` (Bn,) by the thread that copied it; the pitch's padding is
    never written."""
    Sm, D = Wk.shape
    Bn = Xu.shape[1]
    img = torch.full((DVSTAGE,), float("nan"), dtype=F64)
    for u in range(DV // 8):
        r = _CR + 8 * u
        s = st * DV + r
        for e in range(2):
            d, b = dbase + _CC + e, b0 + _CC + e
            sok = s < Sm
            w = torch.where(sok & (d < D),
                            Wk[s.clamp(max=Sm - 1), d.clamp(max=D - 1)],
                            torch.zeros((), dtype=F64))
            x = torch.where(sok & (b < Bn),
                            Xu[s.clamp(max=Sm - 1), b.clamp(max=Bn - 1)],
                            torch.zeros((), dtype=F64))
            scb = torch.where(b < Bn, sc[b.clamp(max=Bn - 1)],
                              torch.zeros((), dtype=F64))
            img[r * DVP + _CC + e] = w
            img[DV * DVP + r * DVP + _CC + e] = x * scb
    return img


def emulate_item(Wk, Xu, sc, dbase, b0, ids=True):
    """The double tier of one item as tier_dbl computes it: every stage
    through its ring slot, each thread's reads of its rows' weights and
    its columns' states (every row of a stage: the rows past Sm are
    zero), each output's running max and first position moving where a
    product is strictly greater (doubles), or without ``ids`` the running
    max alone.  Returns the epilogue's table (val (64, 64), id (64, 64) or
    None) as the epilogue reads it."""
    Sm = Wk.shape[0]
    nst = -(-Sm // DV)
    wcol, dcol = _wcol(), _dcol()
    best = torch.full((NT, 4, 4), -1.0, dtype=F64)
    pos = torch.zeros((NT, 4, 4), dtype=torch.int64)
    ring = {}
    for st in range(min(NVS - 1, nst)):
        ring[st % NVS] = (st, _stage_image(Wk, Xu, sc, st, dbase, b0))
    for st, (slot, nxt) in enumerate(_schedule(nst)):
        held, img = ring[slot]
        assert held == st
        if nxt is not None:  # issued after the barrier, lands later
            ring[nxt] = (st + NVS - 1, _stage_image(Wk, Xu, sc, st + NVS - 1,
                                                    dbase, b0))
        for r in range(DV):
            w = img[r * DVP + wcol]
            x = img[DV * DVP + r * DVP + dcol]
            pr = w[:, :, None] * x[:, None, :]
            upd = pr > best
            best = torch.where(upd, pr, best)
            pos = torch.where(upd, st * DV + r, pos)
    val = torch.full((TR, TB), float("nan"), dtype=F64)
    idt = torch.full((TR, TB), -1, dtype=torch.int64)
    d = wcol[:, :, None].expand(-1, -1, 4)
    b = dcol[:, None, :].expand(-1, 4, -1)
    val[d, b] = best
    if ids:
        idt[d, b] = pos
        assert (idt >= 0).all() and (idt < Sm).all()
    return val, (idt if ids else None)


def _tied(Sm, D, Bn, seed):
    """Panels (Sm, D) and unscaled state rows (Sm, Bn) from {0, 1/4, 1/2,
    1} with signed zeros; column 1 of the states all zero; column 2 of
    values near 1e-160 against weights near 1e-150 in panel column 3
    (denormal products); per-column scales 2^k, k in [-3, 3]."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, -0.0, 0.25, 0.5, 1.0])
    W = rng.choice(vals, size=(Sm, D))
    X = rng.choice(vals, size=(Sm, Bn))
    if Bn > 2:
        X[:, 1] = 0.0
        X[:, 2] = rng.choice(np.array([0.0, 1.0, 2.0, 3.0]) * 1e-160,
                             size=Sm)
    W[:, 3] *= 1e-150
    sc = np.exp2(rng.integers(-3, 4, size=Bn).astype(np.float64))
    return (torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(sc))


@pytest.mark.parametrize("ids", [True, False])
@pytest.mark.parametrize("Sm,D", [(128, 128), (200, 100)])
@pytest.mark.parametrize("Bn", [128, 126, 5])
def test_emulated_items_match_the_twin(Bn, Sm, D, ids):
    """Every item (64-row tile x 64-column tile) of a random tie-heavy
    tier block: the emulated table's values equal ``_tier_max_arg``'s
    maxima of the rescaled products (a positive one bit for bit; a zero
    one in value), its ids the twin's smallest position attaining them;
    the all-zero column takes id 0, and denormal products are compared as
    they are."""
    Wk, Xu, sc = _tied(Sm, D, Bn, seed=Sm + D + Bn)
    Xg = Xu * sc
    prod = Wk[:, 3, None] * Xg[:, 2]
    if Bn > 2:
        assert ((prod > 0) & (prod < torch.finfo(F64).tiny)).any()
    assert (torch.signbit(Wk[:, :, None] * Xg[:, None, :])
            & ((Wk[:, :, None] * Xg[:, None, :]) == 0)).any()  # -0 products
    Y, A = tbl._tier_max_arg(Wk[None], Xg[None])
    Y, A = Y[0], A[0]
    Yr, Ar = tier_rule_f64(Wk[None], Xg[None])
    assert torch.equal(Yr[0], Y) and torch.equal(Ar[0], A)
    for dbase in range(0, D, TR):
        for b0 in range(0, Bn, TB):
            val, idt = emulate_item(Wk, Xu, sc, dbase, b0, ids=ids)
            nd, nb = min(TR, D - dbase), min(TB, Bn - b0)
            y = Y[dbase:dbase + nd, b0:b0 + nb]
            v = val[:nd, :nb]
            assert torch.equal(v, y)
            pos = y > 0
            assert torch.equal(v[pos].view(torch.int64),
                               y[pos].view(torch.int64))
            if ids:
                assert torch.equal(idt[:nd, :nb], A[dbase:dbase + nd,
                                                    b0:b0 + nb].long())
    if Bn > 2:
        assert (A[:, 1] == 0).all() and (Y[:, 1] == 0).all()
    assert (A > 0).any()


def tier_rule_f64(W, Xg):
    """The double tier's rule over whole (K, Sm, D) panels and (K, Sm, B)
    gathered, rescaled states, in the outputs' layout (the maps above
    place each output's operands): per output the running max and first
    position, moving where a product is strictly greater (doubles), in
    position order."""
    K, Sm, D = W.shape
    B = Xg.shape[2]
    best = torch.full((K, D, B), -1.0, dtype=W.dtype)
    pos = torch.zeros((K, D, B), dtype=torch.int32)
    for s in range(Sm):
        pr = W[:, s, :, None] * Xg[:, s, None, :]
        upd = pr > best
        best = torch.where(upd, pr, best)
        pos = torch.where(upd, s, pos)
    return best, pos


def test_float64_tier_rule_in_the_float64_sweep():
    """The float64 plain sweep with the tier rule replaced by the double
    tier's gives the float64 twin's ids, ω argmaxes, final values, shift
    and exponent sums bit for bit, and K7n's saved states, on the 2M-arc
    graph compiled float64 (B=5, N=7, mixed lengths with 1, ±30-nat
    cliffs)."""
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    ct = compile_port(*port_lm_graph(128)[:3], strategy="block",
                      dtype=torch.float64)
    lhs, lens = inputs(5, 7, ct.num_pdfs, seed=29, lens=[7, 1, 5, 7, 2],
                       cliffs=True)
    ext, msh = prepare_emissions(torch.from_numpy(lhs).double(),
                                 torch.from_numpy(lens), ct.num_pdfs, F64)
    want = vs.viterbi_fwd_plain(ct, ext, msh)
    want_n = vs.viterbi_fwd_plain(ct, ext, msh, ids=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbl, "_tier_max_arg", tier_rule_f64)
        got = vs.viterbi_fwd_plain(ct, ext, msh)
        got_n = vs.viterbi_fwd_plain(ct, ext, msh, ids=False)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(x, y) for x, y in zip(got_n, want_n))
    assert (want[0] < 128).any() and (want[0] == 255).any()


# ---------------------------------------------------------------------------
# shared memory, panels, bounds
# ---------------------------------------------------------------------------

def test_shared_memory_of_the_double_sweep():
    """The double CTA's shared memory, reckoned from VitSmem<double>: the
    ring (four stages of two 16 x 66 halves) holds the epilogue's tables
    (the tier's values at a pitch of 65, its ids, the thread rows' column
    maxima and ω pairs) and a heavy row's partials past the values and
    ids; with the row tables, the queue entries, the family ranges and
    two rows of B doubles (B = 128), 2 CTAs (their registers' limit) fit
    the 164 KB carve-out, which leaves L1 92 KB of the SM's 256 KB (the
    float64 sweep's shared memory of the resident-pass design: the ring
    takes its place byte for byte)."""
    ring = NVS * DVSTAGE * 8
    ep = TR * (TB + 1) * 8 + TR * TB + 16 * TB * 8 + 16 * TB * 16
    hv = TR * (TB + 1) * 8 + TR * TB + 16 * TB * 8 + 16 * TB * 4
    assert (ring, ep, hv) == (67_584, 61_952, 49_664)
    assert ep <= ring and hv <= ring
    cta = ring + 2 * TR * 4 + 16 + TR * 12 + 2 * 128 * 8
    assert ring == 2 * TR * (TB + 2) * 8  # the resident W[64][66], X[64][66]
    assert 2 * (cta + CTA_RESERVED) <= 164 * 1024 <= SM_BYTES


def test_float64_panels_as_they_are():
    """The float64 sweep stages the panels untransposed: ``_panels_t``
    gives (K, Sm, D) as the operator holds it, contiguous, cached; the
    float32 one keeps its transposed, padded copy."""
    ct = compile_port(*port_lm_graph(128)[:3], strategy="block",
                      dtype=torch.float64)
    kop = bs.kernel_operator(ct, torch.float64)
    Wt = vs._panels_t(kop)
    assert Wt.dtype == F64 and Wt.is_contiguous()
    assert Wt.shape == kop.fwd.W.shape and torch.equal(Wt, kop.fwd.W)
    assert vs._panels_t(kop) is Wt and kop.plans["vit_panels"] is Wt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vit_bounds_count_the_state_past_l2(dtype):
    """``vit_bounds`` and ``noid_bounds``: where two state slots (2 Sp B
    values) pass L2, every frame reads its predecessor's state and writes
    its own: K7 gains 2 Nf Sp B values; K7n (Nf frames, ``saved`` of them
    saved) gains the Nf - 1 reads beyond its start state and, where it
    runs in its two work slots (saved < Nf), Nf writes beside the saves.
    The operations stay.  At B=128 the float64 state (2 x 50.5 MB) passes
    the H100's 50 MiB L2, the float32 one (50.5 MB) fits it; the bounds
    there stay operations-bound."""
    ct = compile_port(*port_lm_graph(128)[:3], strategy="block", dtype=dtype)
    kop = bs.kernel_operator(ct, vs._vit_dtype(ct))
    f = kop.alpha0.element_size()
    B, Nf = 128, 701
    SB = kop.Sp * B
    fits, past = 2 * SB * f, 2 * SB * f - 1
    traffic = chip_smoke.vit_traffic
    a, b = traffic(ct, B, Nf, l2_bytes=fits, g=8), traffic(
        ct, B, Nf, l2_bytes=past, g=8)
    assert a["K7"][0] == b["K7"][0]
    assert b["K7"][1] - a["K7"][1] == 2 * Nf * SB * f
    for n, saved, extra in ((1025, 16, 1024 + 1025), (64, 64, 63)):
        a = chip_smoke.noid_traffic(ct, B, n, saved, l2_bytes=fits)
        b = chip_smoke.noid_traffic(ct, B, n, saved, l2_bytes=past)
        assert a[0] == b[0] and b[1] - a[1] == extra * SB * f
    l2_h100 = 50 * 2 ** 20
    assert (2 * SB * f > l2_h100) == (dtype == torch.float64)
    for bd in (chip_smoke.vit_bounds(ct, B, Nf, l2_bytes=l2_h100,
                                     g=8)["K7"],
               chip_smoke.noid_bounds(ct, B, 1025, 16, l2_bytes=l2_h100),
               chip_smoke.noid_bounds(ct, B, 64, 64, l2_bytes=l2_h100)):
        assert bd[1] == "operations"


# ---------------------------------------------------------------------------
# the double epilogue's family terms
# ---------------------------------------------------------------------------

def _merge_after(vb, cb, terms):
    """The float epilogue's rule: the family's candidate (its max, the
    smallest id among the terms equal to it; ``fam_beats``) merged after
    the bands and the tier with a strict >."""
    fv, fid = -1.0, 255
    for v, i in terms:
        if v > fv or (v == fv and i < fid):
            fv, fid = v, i
    return (fv, fid) if fv > vb else (vb, cb)


def _merge_each(vb, cb, terms):
    """The double epilogue's: each term merged as it comes, taking the
    candidate where it is larger, or equal to a family term's of a larger
    id."""
    fam = False
    for v, i in terms:
        if v > vb or (v == vb and fam and i < cb):
            vb, cb, fam = v, i, True
    return vb, cb


@pytest.mark.parametrize("seed", range(4))
def test_family_terms_merged_as_they_come(seed):
    """The double epilogue merges a row's family terms one at a time
    without holding the family's own candidate: the same (value, id) as
    the float epilogue's family candidate merged with a strict >, on
    values from {0, 1/4, 1/2, 1} (ties with the bands' candidate and among
    the terms), the band candidate 0 (no mass) or not, 0-6 terms."""
    rng = np.random.default_rng(seed)
    vals = [0.0, 0.25, 0.5, 1.0]
    for _ in range(2000):
        vb = float(rng.choice(vals))
        cb = 255 if vb == 0 else int(rng.integers(0, 128))
        n = int(rng.integers(0, 7))
        terms = [(float(rng.choice(vals)), int(rng.integers(0, 200)))
                 for _ in range(n)]
        assert _merge_each(vb, cb, terms) == _merge_after(vb, cb, terms)
