"""The float32 K7n (csrc/vit_scan.cu ``tier_noid``, ``heavy_noid`` and its
shared layout ``VitSmemN``): a torch emulation of what the kernel computes
for one work item, held bit for bit to the plain twin's tier
(``blocked._tier_max``, which ``vit_scan._noid_plain`` runs).

What is emulated, with the kernel's constants read from its source: which
16-byte chunks of a ring stage each thread copies (rows tid / 16 + 16u,
columns 4 (tid % 16) ..) from the untransposed panel and the gathered
state rows, zero past Sm, D and B; the thread's in-place rescale of its
own state chunks once they have landed; the ring's schedule, the first
NFS - 1 stages issued by the item itself or by the CTA's item before it
during that item's epilogue; the values each thread reads for its 4 x 4
outputs (rows ty*4 + i, columns tx*4 + c: the outputs its epilogue
reduces) and the max of each output taken on the products' bits as
int32, two positions per 3-input max, stage by stage.
Inputs are made from numpy seeds: products from {0, 1/4, 1/2, 1} (many
exact ties), an all-zero column, denormal products, per-column
power-of-two scales, at B = 128, 126 and 5 (B % 4 != 0: the kernel's
scalar branch), Sm = 128 and 200 (a partial last stage), D = 128 and 100.
The bank map of the loop's reads, the copies and the rescale is checked
conflict-free.  The family branch's packed heavy items (four heavy rows
to an item, ``vit_plan(packed=True)``) are held to the one-row plan on the
separate-state graph, and the admission's shared-memory reckoning
(``vit_scan.smem_bytes``) to the kernel's layouts.  The CUDA kernel is
held against the twins on the card by ``chip_smoke.py`` (phases 31-37 and
54)."""
import functools
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
    ``constexpr int NAME = expr;`` evaluated in order (integer division,
    as in C++)."""
    env = {}
    for name in ("block_common.cuh", "vit_scan.cu"):
        for k, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                  (CSRC / name).read_text(), re.M):
            env[k] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


C_ = _constants()
TR, TB, NT = C_["TR"], C_["TB"], C_["NT"]
FV, NFS, FSTAGE, HP = C_["FV"], C_["NFS"], C_["FSTAGE"], C_["HP"]
FU = C_["FU"]  # chunks of each half a thread copies per stage
F32 = torch.float32
SM_BYTES = 233_472  # shared memory of an H100 SM (228 KB)
CTA_RESERVED = 1024  # what the card reserves per resident CTA


def test_constants_of_the_float_noid_tier():
    """The layout the emulation reads, and the host's mirror of it:
    stages of FV positions at a pitch of 64 floats, NFS in the ring, 256
    threads on 64 x 64 items (FU chunks of each half per thread and
    stage), four heavy rows to an item, 2 CTAs per SM."""
    assert (TR, TB, NT, C_["VIT_BLOCKS"]) == (64, 64, 256, 2)
    assert (FSTAGE, HP) == (2 * FV * TB, 4) and FV % 2 == 0 and NFS >= 2
    assert FU * NT * 4 == FV * TB and NT // TB == HP
    assert (vs._FV, vs._NFS, vs._HEAVY_PACK, vs._TB) == (FV, NFS, HP, TB)
    assert (vs._SC, vs._DV, vs._DVP, vs._NVS) == (
        C_["SC"], C_["DV"], C_["DVP"], C_["NVS"])
    assert C_["ST"] == vs._SC + 4


# ---------------------------------------------------------------------------
# the thread maps
# ---------------------------------------------------------------------------

_TID = torch.arange(NT)
_TX, _TY = _TID % 16, _TID // 16
_CR, _CC = _TID // 16, (_TID % 16) * 4  # the copy map: row, first column
_CROWS = [_CR + u * (NT // 16) for u in range(FU)]  # rows of chunk u
_I4 = torch.arange(4)


def _wcol():
    """(NT, 4): the item row (panel column d) of output i."""
    return _TY[:, None] * 4 + _I4[None, :]


def _bcol():
    """(NT, 4): the item column of output c: the epilogue's columns."""
    return _TX[:, None] * 4 + _I4[None, :]


def test_outputs_cover_the_item_once():
    """The 256 threads' 4 x 4 outputs are the 64 x 64 outputs of the
    item, each once, and each is the output its thread's epilogue reduces
    (rows ty*4 + i, columns tx*4 + c)."""
    hits = torch.zeros((TR, TB), dtype=torch.int64)
    d = _wcol()[:, :, None].expand(-1, -1, 4)
    b = _bcol()[:, None, :].expand(-1, 4, -1)
    hits.index_put_((d.reshape(-1), b.reshape(-1)),
                    torch.ones(d.numel(), dtype=torch.int64), accumulate=True)
    assert (hits == 1).all()


def test_copies_cover_each_half_once():
    """Every (row, column) of an FV x 64 half of a stage is copied by
    exactly one thread, as a 16-byte chunk on a 16-byte boundary; the
    halves and the slots keep 16-byte alignment."""
    seen = torch.zeros((FV, TB), dtype=torch.int64)
    for cr in _CROWS:
        for e in range(4):
            seen.index_put_((cr, _CC + e), torch.ones(NT, dtype=torch.int64),
                            accumulate=True)
        assert ((cr * TB + _CC) * 4 % 16 == 0).all()
    assert (seen == 1).all()
    assert FV * TB * 4 % 16 == 0 and FSTAGE * 4 % 16 == 0


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


@pytest.mark.parametrize("slot", range(NFS))
def test_loop_reads_are_free_of_bank_conflicts(slot):
    """Per position r of a stage, each warp's two 16-byte reads (its rows'
    weights: one address per quarter warp; its columns' states: 16
    distinct chunks of one row) need one wavefront per quarter warp."""
    base = slot * FSTAGE
    for warp in range(NT // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        tx, ty = _TX[lanes], _TY[lanes]
        for r in range(FV):
            for off in (ty * 4, FV * TB + tx * 4):
                addr = (base + r * TB + off) * 4
                assert (addr % 16 == 0).all()
                assert _wavefronts(addr, 16) == 1, (warp, r)


@pytest.mark.parametrize("half", [0, 1])
def test_copies_and_rescale_are_free_of_bank_conflicts(half):
    """The 16-byte chunks each warp writes (cp.async) into the panel's or
    the states' half of a stage, and the states' chunk each thread reads
    and writes back in the rescale: one wavefront per quarter warp."""
    for warp in range(NT // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        for cr in _CROWS:
            addr = (half * FV * TB + cr[lanes] * TB + _CC[lanes]) * 4
            assert _wavefronts(addr, 16) == 1


# ---------------------------------------------------------------------------
# the ring's schedule, across the items of a CTA
# ---------------------------------------------------------------------------

def _schedule(nst):
    """The ring within an item: per iteration st, (the slot that lands and
    is reduced, the slot the copies issued after the barrier fill, or None
    past the last stage)."""
    return [(st % NFS, (st + NFS - 1) % NFS if st + NFS - 1 < nst else None)
            for st in range(nst)]


@pytest.mark.parametrize("kinds", ["ttbt", "tttb", "btbt", "hhtt"])
@pytest.mark.parametrize("nst", [1, 2, 3, 4, 8, 13])
def test_ring_schedule_across_items(kinds, nst):
    """A CTA's items in turn ('t' tier, 'b' band, 'h' heavy): a tier item
    whose item before issued its first NFS - 1 stages (once that item's
    own loop was done: the block barrier before its epilogue) finds them
    in their slots; within an item the copies issued after a stage's
    barrier never fill the slot it reduces nor one read since the
    barrier before; every issued stage is reduced by its own item."""
    holder, last_read = {}, {}
    staged = False
    clock = 0
    for n, kind in enumerate(kinds):
        item = n
        if kind == "t":
            if not staged:
                for st in range(min(NFS - 1, nst)):
                    holder[st % NFS] = (item, st)
            for st, (slot, nxt) in enumerate(_schedule(nst)):
                clock += 1  # the barrier of iteration st
                assert holder.pop(slot) == (item, st)
                last_read[slot] = clock
                if nxt is not None:
                    assert nxt != slot and last_read.get(nxt, -1) < clock
                    holder[nxt] = (item, st + NFS - 1)
        clock += 1  # the barrier after the tier or heavy work
        assert not holder  # every stage reduced
        nxt_kind = kinds[n + 1] if n + 1 < len(kinds) else None
        staged = nxt_kind == "t"
        if staged:  # issued before this item's epilogue
            for st in range(min(NFS - 1, nst)):
                assert last_read.get(st % NFS, -1) < clock
                holder[st % NFS] = (item + 1, st)
    assert not holder


# ---------------------------------------------------------------------------
# one work item, emulated
# ---------------------------------------------------------------------------

def _stage_image(Wk, Xu, sc, st, dbase, b0):
    """Slot image (FSTAGE floats) of stage ``st`` once it has landed and
    been rescaled: the chunk map's copies of the panel Wk (Sm, D) and of
    the gathered, unscaled state rows Xu (Sm, Bn), zero past Sm, D and Bn,
    each state value times its column's scale ``sc`` (Bn,) (0 past Bn) by
    the thread that copied it."""
    Sm, D = Wk.shape
    Bn = Xu.shape[1]
    img = torch.full((FSTAGE,), float("nan"), dtype=F32)
    zero = torch.zeros((), dtype=F32)
    for cr in _CROWS:
        s = st * FV + cr
        sok = s < Sm
        for e in range(4):
            d, b = dbase + _CC + e, b0 + _CC + e
            w = torch.where(sok & (d < D),
                            Wk[s.clamp(max=Sm - 1), d.clamp(max=D - 1)], zero)
            x = torch.where(sok & (b < Bn),
                            Xu[s.clamp(max=Sm - 1), b.clamp(max=Bn - 1)],
                            zero)
            scb = torch.where(b < Bn, sc[b.clamp(max=Bn - 1)], zero)
            img[cr * TB + _CC + e] = w
            img[FV * TB + cr * TB + _CC + e] = x * scb
    assert not img.isnan().any()  # every word of the stage is written
    return img


def _bits(v):
    return v.contiguous().view(torch.int32)


def emulate_item(Wk, Xu, sc, dbase, b0, staged=False):
    """The float K7n tier of one item as tier_noid computes it: every
    stage through its ring slot (the first NFS - 1 issued by the item, or
    already there: ``staged``), each thread's reads of its rows' weights
    and its columns' states per position, and each output's max on the
    products' bits as int32, two positions per 3-input max, from -1 (below
    every product).  Returns the epilogue's table ep.val (64, 64)."""
    Sm = Wk.shape[0]
    nst = -(-Sm // FV)
    wcol, bcol = _wcol(), _bcol()
    best = torch.full((NT, 4, 4), -1, dtype=torch.int32)
    ring = {st % NFS: (st, _stage_image(Wk, Xu, sc, st, dbase, b0))
            for st in range(min(NFS - 1, nst))}
    for st, (slot, nxt) in enumerate(_schedule(nst)):
        held, img = ring[slot]
        assert held == st
        if nxt is not None:
            ring[nxt] = (st + NFS - 1, _stage_image(Wk, Xu, sc, st + NFS - 1,
                                                    dbase, b0))
        for r in range(0, FV, 2):
            p = []
            for q in (r, r + 1):
                w = img[q * TB + wcol]
                x = img[FV * TB + q * TB + bcol]
                p.append(_bits(w[:, :, None] * x[:, None, :]))
            best = torch.maximum(torch.maximum(best, p[0]), p[1])
    val = torch.full((TR, TB), float("nan"), dtype=F32)
    d = wcol[:, :, None].expand(-1, -1, 4)
    b = bcol[:, None, :].expand(-1, 4, -1)
    val[d, b] = best.view(F32)
    return val


def _tied(Sm, D, Bn, seed):
    """Panels (Sm, D) and unscaled state rows (Sm, Bn) from {0, 1/4, 1/2,
    1}; column 1 of the states all zero; column 2 of values near 1e-20
    against weights near 1e-19 in panel column 3 (denormal products);
    per-column scales 2^k, k in [-3, 3]."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    W = rng.choice(vals, size=(Sm, D))
    X = rng.choice(vals, size=(Sm, Bn))
    if Bn > 2:
        X[:, 1] = 0.0
        X[:, 2] = rng.choice(np.array([0, 1, 2, 3], np.float32) * 1e-20,
                             size=Sm)
    W[:, 3] *= np.float32(1e-19)
    sc = np.exp2(rng.integers(-3, 4, size=Bn)).astype(np.float32)
    return (torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(sc))


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("Sm,D", [(128, 128), (200, 100)])
@pytest.mark.parametrize("Bn", [128, 126, 5])
def test_emulated_items_match_the_twin(Bn, Sm, D, staged):
    """Every item (64-row tile x 64-column tile) of a random tie-heavy
    tier block: the emulated table equals the twin's tier maxima of the
    rescaled products (``_tier_max`` on a * s) bit for bit, the all-zero
    column +0, the denormal products compared as they are."""
    Wk, Xu, sc = _tied(Sm, D, Bn, seed=Sm + D + Bn)
    Xg = Xu * sc
    if Bn > 2:
        prod = Wk[:, 3] * Xg[:, 2]
        assert ((prod > 0) & (prod < torch.finfo(F32).tiny)).any()
    Y = tbl._tier_max(Wk[None], Xg[None])[0]
    assert torch.equal(Y, tbl._tier_max_arg(Wk[None], Xg[None])[0][0])
    for dbase in range(0, D, TR):
        for b0 in range(0, Bn, TB):
            val = emulate_item(Wk, Xu, sc, dbase, b0, staged=staged)
            nd, nb = min(TR, D - dbase), min(TB, Bn - b0)
            y = Y[dbase:dbase + nd, b0:b0 + nb]
            assert torch.equal(_bits(val[:nd, :nb]), _bits(y))
    if Bn > 2:
        assert (_bits(Y[:, 1]) == 0).all()  # +0
    assert (Y > 0).any()


def tier_rule_noid(W, Xg):
    """The float K7n tier's rule over whole (K, Sm, D) panels and (K, Sm,
    B) gathered, rescaled states: per output the max of the products'
    bits as int32, FV positions a stage (the rows past Sm zero), two
    positions per 3-input max, from -1."""
    K, Sm, D = W.shape
    B = Xg.shape[2]
    nst = -(-Sm // FV)
    Wp = W.new_zeros((K, nst * FV, D))
    Xp = Xg.new_zeros((K, nst * FV, B))
    Wp[:, :Sm], Xp[:, :Sm] = W, Xg
    best = torch.full((K, D, B), -1, dtype=torch.int32)
    for s in range(0, nst * FV, 2):
        p0 = _bits(Wp[:, s, :, None] * Xp[:, s, None, :])
        p1 = _bits(Wp[:, s + 1, :, None] * Xp[:, s + 1, None, :])
        best = torch.maximum(torch.maximum(best, p0), p1)
    return best.view(W.dtype)


@pytest.mark.parametrize("B,lens", [(5, [7, 1, 5, 7, 2]), (4, [7, 7, 2, 1])])
def test_noid_rule_in_the_plain_sweep(B, lens):
    """The plain K7n sweep with its tier replaced by the float K7n's rule
    gives the twin's saved states and scales, last state, scale and
    carried sums bit for bit, from frame 0 and restarted from a saved
    frame with a stride, on the 2M-arc graph (N=7, mixed lengths with 1
    and 2, ±30-nat cliffs)."""
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    ct = _graph_2m()
    lhs, ln = inputs(B, 7, ct.num_pdfs, seed=31 + B, lens=lens, cliffs=True)
    ext, msh = prepare_emissions(torch.from_numpy(lhs), torch.from_numpy(ln),
                                 ct.num_pdfs)
    want = vs.viterbi_fwd_plain(ct, ext, msh, ids=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbl, "_tier_max", tier_rule_noid)
        got = vs.viterbi_fwd_plain(ct, ext, msh, ids=False)
        mid = dict(a0=got[0][3], s0=got[1][3], t0=4)
        got_r = vs.viterbi_fwd_plain(ct, ext[4:], msh[4:], ids=False,
                                     stride=2, **mid)
    want_r = vs.viterbi_fwd_plain(ct, ext[4:], msh[4:], ids=False, stride=2,
                                  **mid)
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(got, want))
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(got_r, want_r))
    assert (want[0] > 0).any()


@functools.lru_cache(maxsize=None)
def _graph_2m():
    return compile_port(*port_lm_graph(128)[:3], strategy="block")


# ---------------------------------------------------------------------------
# the family branch's packed heavy items (the separate-state graph)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _separate():
    g = mt.workloads.make_backoff_lm_hmm_graph(V=128, keep=0.1,
                                               layout="separate")
    return compile_port(*g[:3], strategy="block")


def _plan_items(pl):
    return pl.queue[:, 0].numpy().astype(np.int64)


@pytest.mark.parametrize("B", [128, 126, 5])
def test_packed_plan_takes_every_heavy_row_once(B):
    """The float K7n's queue on the separate-state graph (128 heavy rows):
    ceil(128 / 4) heavy tiles first, each in every column tile, tile h
    holding heavy rows 4h .. 4h + 3, so every heavy row is in exactly one
    heavy tile (once per column tile); then the one-row plan's tier and
    band items in its order, their tiles moved down by 128 - 32, first
    rows kept; every item once; the item count is the library's check
    (n_tiles - nheavy + ceil(nheavy / 4)) x ncb."""
    ct = _separate()
    kop = bs.kernel_operator(ct, F32)
    kd = kop.fwd
    nh = kd.heavy_rows.numel()
    assert nh == 128 and vs._is_fam(kop)
    one, pk = vs.vit_plan(kop, B), vs.vit_plan(kop, B, packed=True)
    assert vs.vit_plan(kop, B, packed=True) is pk and pk is not one
    ncb = one.ncb
    assert pk.ncb == ncb == -(-B // TB)
    nhp = -(-nh // HP)
    q1, qp = one.queue.numpy(), pk.queue.numpy()
    _, _, _, n_tiles = bs._tile_counts(kd, B)
    assert len(qp) == (n_tiles - nh + nhp) * ncb
    assert sorted(qp[:, 0].tolist()) == list(range(len(qp)))
    np.testing.assert_array_equal(qp[:nhp * ncb, 0], np.arange(nhp * ncb))
    assert (qp[:nhp * ncb, 1] == -1).all()
    np.testing.assert_array_equal(qp[nhp * ncb:, 0],
                                  q1[nh * ncb:, 0] - (nh - nhp) * ncb)
    np.testing.assert_array_equal(qp[nhp * ncb:, 1], q1[nh * ncb:, 1])
    # the heavy rows of each packed tile, as the kernel takes them
    seen = np.zeros(nh, np.int64)
    for code in qp[:nhp * ncb, 0]:
        tile = code // ncb
        for r in range(HP):
            if tile * HP + r < nh:
                seen[tile * HP + r] += 1
    assert (seen == ncb).all()


def test_packed_heavy_merge_equals_the_one_row_plan():
    """A torch emulation of heavy_noid on every packed heavy item of the
    separate-state graph (a tie-heavy state, per-column power-of-two
    scales): thread row ty of the item takes heavy row ty / 4 and its
    terms q ≡ ty % 4 (mod 4) from K2's per-row lists, keeping per column
    the max of w · (a · s); the four partials merged by the max alone.
    Every term is read exactly once, and each row's candidate equals the
    one-row item's (16 thread rows, every 16th term) and the twin's max
    over the row's family terms, bit for bit."""
    ct = _separate()
    kop = bs.kernel_operator(ct, F32)
    kd = kop.fwd
    heavy = kd.heavy_rows.numpy().astype(np.int64)
    ptr = kd.fam_ptr.numpy().astype(np.int64)
    src = kd.fam_src.numpy().astype(np.int64)
    w = kd.fam_w
    rng = np.random.default_rng(5)
    B = 8
    a = torch.from_numpy(rng.choice(np.array([0, 0.25, 0.5, 1], np.float32),
                                    size=(kop.Sp, B)))
    sc = torch.from_numpy(np.exp2(rng.integers(-3, 4, size=B))
                          .astype(np.float32))
    th = 16 // HP
    reads = np.zeros(len(src), np.int64)

    def partial(j, start, step, count=True):
        bv = torch.full((B,), -1.0, dtype=F32)
        for q in range(ptr[j] + start, ptr[j + 1], step):
            if count:
                reads[q] += 1
            v = w[q] * (a[src[q]] * sc)
            bv = torch.where(v > bv, v, bv)
        return bv

    for tile in range(-(-len(heavy) // HP)):
        for r in range(HP):
            if tile * HP + r >= len(heavy):
                continue
            j = heavy[tile * HP + r]
            packed = torch.stack([partial(j, u, th) for u in range(th)])
            got = packed.max(dim=0).values
            one = torch.stack([partial(j, u, 16, False)
                               for u in range(16)]).max(dim=0).values
            terms = w[ptr[j]:ptr[j + 1], None] * (a[src[ptr[j]:ptr[j + 1]]]
                                                  * sc)
            assert ptr[j + 1] - ptr[j] >= 16
            assert torch.equal(_bits(got), _bits(one))
            assert torch.equal(_bits(got), _bits(terms.amax(dim=0)))
    on_heavy = np.zeros(len(src), bool)
    for j in heavy:
        on_heavy[ptr[j]:ptr[j + 1]] = True
    assert (reads[on_heavy] == 1).all() and (reads[~on_heavy] == 0).all()


# ---------------------------------------------------------------------------
# shared memory
# ---------------------------------------------------------------------------

def _reckon(ids, fam, f64):
    """A CTA's shared memory without the two rows of B values, reckoned
    from the structs of vit_scan.cu with the constants read from it."""
    ST, SC, DV, DVP, NVS = C_["ST"], C_["SC"], C_["DV"], C_["DVP"], C_["NVS"]
    if f64:
        union = NVS * 2 * DV * DVP * 8  # the ring holds ep and hv
        ep = TR * (TB + 1) * 8 + TR * TB + 16 * TB * 8 + 16 * TB * 16
        assert ep <= union
    elif ids:
        union = 2 * TR * ST * 4  # the resident W and X
        ep = TR * (TB + 1) * 4 + TR * TB + 16 * TB * 4 + 16 * TB * 8
        hv = TR * ST * 4 + 16 * TB * 4 + 16 * TB * 4
        assert ep <= union and hv <= union
    else:
        ep = TR * (TB + 1) * 4 + 16 * TB * 4 + 16 * TB * 8  # no ids
        hv = TR * (TB + 1) * 4 + 16 * TB * 4
        assert hv <= ep and ep % 16 == 0  # the ring stays 16-byte aligned
        union = ep + NFS * FSTAGE * 4
    # the family rows' ranges, but in the float32 K7 (read from frow)
    n = union + 2 * TR * 4 + 2 * 8 + (TR * 12 if fam and (f64 or not ids)
                                      else 0)
    return -(-n // 8) * 8


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("fam", [False, True])
@pytest.mark.parametrize("ids", [True, False])
def test_shared_memory_reckoning(ids, fam, f64):
    """``vit_scan.smem_bytes`` (the admission's, ``mm_vit_smem`` on the
    card) is the kernel's struct plus two rows of B values, for every
    instantiation; the float K7n's tables and its ring beside them (95 KB
    at B=128) leave room for 2 CTAs (the registers' limit) on an SM."""
    for B in (1, 124, 128, 4096):
        assert vs.smem_bytes(B, ids, fam, f64) == (
            _reckon(ids, fam, f64) + 2 * B * (8 if f64 else 4))
    cta = vs.smem_bytes(128, ids, fam, f64)
    assert 2 * (cta + CTA_RESERVED) <= SM_BYTES


def test_admission_refuses_a_batch_past_the_shared_memory():
    """K7 and K7n refuse to launch a batch whose two rows of B values take
    a CTA's shared memory past the card's 227 KB (``_check_batch``, the
    port's own limit: the JAX package has its VMEM budget instead); the
    largest batch that fits, ``max_batch``, launches.  The admission no
    longer refuses such a batch: ``viterbi`` decodes it in slices of at
    most ``max_batch`` sequences."""
    ct = _graph_2m()
    for saved in (None, 4):
        ids = saved is None
        base = vs.smem_bytes(0, ids, False, False)
        fit = (vs._SMEM_CTA - base) // 8
        assert vs.max_batch(ids) == fit
        assert vs.smem_bytes(fit, ids) <= vs._SMEM_CTA
        assert vs.smem_bytes(fit + 1, ids) > vs._SMEM_CTA
        vs._check_batch(fit, ids, False, False)
        with pytest.raises(ValueError, match="shared memory"):
            vs._check_batch(fit + 1, ids, False, False)
        for B in (fit, fit + 1):
            assert vs.vit_scan_admission(ct, B, n_frames=7,
                                         saved=saved) == (None, True)


# ---------------------------------------------------------------------------
# the bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_noid_bound_counts_the_three_input_max(dtype):
    """``noid_traffic`` counts the float32 tier at 1.5 instructions a
    candidate (an FMUL and half a 3-input integer max), the float64 one at
    2 (no such max in float64), the rest as before."""
    ct = compile_port(*port_lm_graph(128)[:3], strategy="block", dtype=dtype)
    kop = bs.kernel_operator(ct, vs._vit_dtype(ct))
    K, Sm, D = kop.fwd.W.shape
    nO, Sp = len(kop.fwd.offsets), kop.Sp
    RW = vs._main_region(ct)
    B, Nf = 128, 1025
    ops = chip_smoke.noid_traffic(ct, B, Nf, 16, l2_bytes=50 * 2 ** 20)[0]
    per = 1.5 if dtype == torch.float32 else 2
    assert ops == Nf * B * (per * K * Sm * D + 2 * nO * RW + 4 * Sp)
