"""The float64 tier of K2-K4 (csrc/block_scan.cu ``tier_tile_dm``) on the
FP64 tensor cores: a torch emulation of the index maps each thread uses,
held against a plain (d, s) x (s, b) product in float64.

What is emulated, with the kernel's constants read from its source:
which 16-byte chunk of a ring stage each thread copies (k row, column
pair) and where it lands at the stage's padded pitch; which stage
element each lane reads into which A and B fragment slot of
``mma.sync.m16n8k4.f64`` (two per k step of 8, ``dmma_k8``); which
accumulator lands on which (d, b) of the tile in C (written, or added to
K4's family sums), where each thread's epilogue reads its 4 x 4 outputs;
K4's alpha block staged into the ring in 16-byte
chunks; a heavy row's 16 partial sums in the ring's other use.  Shapes:
random panels with partial tiles (D % 64 != 0, B % 64 != 0, Sm % 16 !=
0), the 2M-arc graph's float64 operator and the separate-state graph's
(the capped layout: its tier tiles and its heavy rows), both directions.
The CUDA kernels are held against the plain twins on the card by
``chip_smoke.py`` (phases 38 and 52)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import block_scan as bs
from _torch_port import compile_port, port_lm_graph

CSRC = Path(mt.__file__).parent / "ops" / "csrc"
TOL = 1e-13  # the emulated tensor-core tile vs the float64 product


def _constants():
    """The integer constants of block_scan.cu and block_common.cuh, each
    ``constexpr int NAME = expr;`` evaluated in order."""
    env = {}
    for name in ("block_common.cuh", "block_scan.cu"):
        for k, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                  (CSRC / name).read_text(), re.M):
            env[k] = eval(expr, {}, dict(env))
    return env


C_ = _constants()
TR, TB, NT = C_["TR"], C_["TB"], C_["NT"]
DS, DP, NDS, DSTAGE = C_["DS"], C_["DP"], C_["NDS"], C_["DSTAGE"]
SM_BYTES = 233_472  # shared memory of an H100 SM (228 KB)
CTA_RESERVED = 1024  # what the card reserves per resident CTA


def test_constants_of_the_double_tier():
    """The layout the emulation below reads: 16-row stages at a pitch of
    68 doubles, three in the ring, 256 threads on 64 x 64 tiles."""
    assert (TR, TB, NT) == (64, 64, 256)
    assert (DS, DP, NDS, DSTAGE) == (16, 68, 3, 2 * 16 * 68)


# ---------------------------------------------------------------------------
# the thread maps
# ---------------------------------------------------------------------------

def _chunks():
    """(k row, column) of the 16-byte chunks tid + u NT, u = 0, 1, that
    thread tid copies into each half of a stage: (NT, 2) each."""
    ch = torch.arange(NT)[:, None] + NT * torch.arange(2)[None, :]
    return ch // 32, (ch % 32) * 2


def _lanes():
    """Per warp w and lane l: g, q and the warp's first row and column."""
    w = torch.arange(NT // 32)[:, None].expand(-1, 32)
    lane = torch.arange(32)[None, :].expand(NT // 32, -1)
    return lane // 4, lane % 4, (w % 4) * 16, (w // 4) * 32


def test_stage_chunks_cover_each_half_once():
    """Every (k row, column) of a DS x 64 half is copied by exactly one
    thread, as a 16-byte pair that starts on a 16-byte boundary of the
    padded stage; the halves and the stages stay 16-byte aligned."""
    r, c2 = _chunks()
    seen = torch.zeros((DS, TB), dtype=torch.int64)
    for e in range(2):
        seen.index_put_((r.reshape(-1), c2.reshape(-1) + e),
                        torch.ones(r.numel(), dtype=torch.int64),
                        accumulate=True)
    assert (seen == 1).all()
    assert ((r * DP + c2) * 8 % 16 == 0).all()
    assert (DS * DP * 8) % 16 == 0 and (DSTAGE * 8) % 16 == 0


def test_fragment_reads_are_free_of_bank_conflicts():
    """A warp's fragment loads (8 bytes a lane) go out as two half-warp
    requests; within each, the 16 lanes' doubles fall on 16 distinct
    pairs of banks at the padded pitch (68), for the A and the B reads."""
    g, q, r0, c0 = _lanes()
    for base in (r0 + g, c0 + g):  # A (rows g, g + 8 alike) and B reads
        words = 2 * ((q * DP + base) % 16)  # bank pair of each lane
        for half in (slice(0, 16), slice(16, 32)):
            w = words[:, half]
            assert all(len(set(row.tolist())) == 16 for row in w)


def _stage_image(Wk, Xg, st, d0, b0):
    """The ring slot's image (DSTAGE doubles) of stage ``st`` of a tile:
    Wk (Sm, D) the panel, Xg (Sm, B) the gathered state rows, copied by
    the chunk map, zero past Sm, D and B (cp.async's zero fill)."""
    Sm, D = Wk.shape
    Bn = Xg.shape[1]
    img = torch.full((DSTAGE,), float("nan"), dtype=torch.float64)
    r, c2 = _chunks()
    for e in range(2):
        s, dc, bc = st * DS + r, d0 + c2 + e, b0 + c2 + e
        w = torch.where((s < Sm) & (dc < D),
                        Wk[s.clamp(max=Sm - 1), dc.clamp(max=D - 1)],
                        torch.zeros(()))
        x = torch.where((s < Sm) & (bc < Bn),
                        Xg[s.clamp(max=Sm - 1), bc.clamp(max=Bn - 1)],
                        torch.zeros(()))
        img[r * DP + c2 + e] = w
        img[DS * DP + r * DP + c2 + e] = x
    # a padded pitch leaves 4 doubles a row that no copy writes, and no
    # fragment reads
    return img


def _dmma_k8(stage, kk):
    """One k step of 8 of every warp: the lanes' A and B fragments read
    from the stage as the kernel reads them, assembled into the 16 x 8
    and 8 x 8 operands by the fragment layout of m16n8k4 (two products,
    k 0..3 then 4..7).  Returns (8 warps, 4 blocks, 16, 8) products and
    asserts that the lanes fill each operand exactly once."""
    g, q, r0, c0 = _lanes()
    nw = NT // 32
    Wst, Xst = stage[:DS * DP], stage[DS * DP:]
    w = (kk + q) * DP + r0 + g
    a = torch.stack([Wst[w], Wst[w + 8], Wst[w + 4 * DP],
                     Wst[w + 4 * DP + 8]], -1)  # (warps, lanes, 4)
    A = torch.full((nw, 16, 8), float("nan"), dtype=torch.float64)
    hits = torch.zeros((nw, 16, 8), dtype=torch.int64)
    wi = torch.arange(nw)[:, None].expand(-1, 32)
    for slot, (row, col) in enumerate(((g, q), (g + 8, q), (g, q + 4),
                                       (g + 8, q + 4))):
        A[wi, row, col] = a[..., slot]
        hits[wi, row, col] += 1
    assert (hits == 1).all()
    out = []
    for n in range(4):
        x = (kk + q) * DP + c0 + n * 8 + g
        Bm = torch.full((nw, 8, 8), float("nan"), dtype=torch.float64)
        hb = torch.zeros((nw, 8, 8), dtype=torch.int64)
        for slot, (row, col) in enumerate(((q, g), (q + 4, g))):
            Bm[wi, row, col] = Xst[x + slot * 4 * DP]
            hb[wi, row, col] += 1
        assert (hb == 1).all()
        out.append(A[:, :, :4] @ Bm[:, :4] + A[:, :, 4:] @ Bm[:, 4:])
    return torch.stack(out, 1)


def _to_c(Dacc, ldc, C0=None):
    """The accumulators of every lane written to C (row pitch ldc) at rows
    r0 + g (+ 8), columns c0 + 8 n + 2 q (+ 1), or added to C0's elements
    there (ADD); asserts that every element of the 64 x 64 tile is
    written once."""
    g, q, r0, c0 = _lanes()
    nw = NT // 32
    wi = torch.arange(nw)[:, None].expand(-1, 32)
    C = (torch.full((TR * ldc,), float("nan"), dtype=torch.float64)
         if C0 is None else C0.clone())
    hits = torch.zeros(TR * ldc, dtype=torch.int64)
    for n in range(4):
        for dr, dc in ((0, 0), (0, 1), (8, 0), (8, 1)):
            # the lane's d[n][dr / 4 + dc]: its own slot of the block
            val = Dacc[wi, n, g + dr, 2 * q + dc]
            at = (r0 + g + dr) * ldc + c0 + n * 8 + 2 * q + dc
            C[at] = val if C0 is None else C[at] + val
            hits[at] += 1
    assert (hits.reshape(TR, ldc)[:, :TB] == 1).all()
    assert (hits.reshape(TR, ldc)[:, TB:] == 0).all()
    return C


def _acc(C, ldc):
    """What each thread's epilogue reads for its row ty*4 + i, column
    tx*4 + c: C[(ty*4 + i) ldc + tx*4 + c], laid out as the (64, 64) tile
    it stands for."""
    tid = torch.arange(NT)
    tx, ty = tid % 16, tid // 16
    i = torch.arange(4)[None, :, None]
    c = torch.arange(4)[None, None, :]
    vals = C[(ty[:, None, None] * 4 + i) * ldc + tx[:, None, None] * 4 + c]
    tile = torch.empty((TR, TB), dtype=torch.float64)
    tile[(ty[:, None, None] * 4 + i).expand(-1, -1, 4),
         (tx[:, None, None] * 4 + c).expand(-1, 4, -1)] = vals
    return tile


def emulate_tile(Wk, Xg, d0, b0, ldc=DP, C0=None):
    """One tier tile (rows d0 .. d0+63 of the panel's D, columns b0 ..
    b0+63) as tier_tile_dm computes it: every stage through its ring slot,
    the k steps' products summed in order, the accumulators into C (added
    to C0, ADD), read back as the epilogue reads it."""
    Sm = Wk.shape[0]
    nst = -(-Sm // DS)
    # the ring: stage st waits in slot st % NDS; the copies of stage st +
    # NDS - 1 go after the barrier of stage st, into the slot of st - 1
    committed = NDS - 1
    Dacc = torch.zeros((NT // 32, 4, 16, 8), dtype=torch.float64)
    for st in range(nst):
        assert committed - (NDS - 2) >= st + 1  # wait_group: st is in
        committed += 1
        assert (st + NDS - 1) % NDS != st % NDS
        img = _stage_image(Wk, Xg, st, d0, b0)
        for kk in range(0, DS, 8):
            Dacc += _dmma_k8(img, kk)
    return _acc(_to_c(Dacc, ldc, C0), ldc)


@pytest.mark.parametrize("Sm,D,Bn,ldc,add", [(40, 100, 70, DP, False),
                                             (128, 128, 64, DP, False),
                                             (16, 64, 130, TB + 1, True),
                                             (37, 7, 5, TB + 1, True)])
def test_emulated_tile_matches_the_plain_product(Sm, D, Bn, ldc, add):
    """Random panels and state rows, partial tiles included (D % 64,
    B % 64, Sm % 16 not 0): every tile of the emulated kernel within 1e-13
    of W^T X in float64, for C at the forward's pitch (the ring, DP) and
    K4's (its gamma tile, TB + 1), there added to the family sums that C
    holds on entry (ADD)."""
    rng = np.random.default_rng(Sm * 1000 + D)
    Wk = torch.from_numpy(rng.uniform(0, 1, size=(Sm, D)))
    Xg = torch.from_numpy(rng.uniform(0, 1, size=(Sm, Bn)))
    ref = Wk.T @ Xg
    for d0 in range(0, D, TR):
        for b0 in range(0, Bn, TB):
            C0 = (torch.from_numpy(rng.uniform(0, 1, size=TR * ldc))
                  if add else None)
            got = _acc_crop(emulate_tile(Wk, Xg, d0, b0, ldc, C0), d0, b0,
                            D, Bn)
            want = ref[d0:d0 + TR, b0:b0 + TB]
            if add:
                want = want + _acc_crop(_acc(C0, ldc), d0, b0, D, Bn)
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _acc_crop(tile, d0, b0, D, Bn):
    return tile[:min(TR, D - d0), :min(TB, Bn - b0)]


def test_shared_memory_of_the_double_blocks():
    """The double CTAs' dynamic shared memory, reckoned from the structs:
    the forward's (ring, reductions, row tables, scales, queue entries,
    the omega reduction, the phony row's partials, the frame index, padded
    to 8 bytes) would let 3 CTAs share an SM (registers keep it at 2) and
    K4's (ring, reductions, gamma tile, row tables, normalisation sums,
    queue entries, the three per-column scale rows) 2; the tier's outputs
    (64 rows at the pitch DP), K4's alpha block and a heavy row's partials
    fit the ring."""
    ring = NDS * DSTAGE * 8
    fwd = ring + 2 * 16 * TB * 8 + 2 * TR * 4 + TB * 8 + 16 + 2 * 128 * 8 \
        + 2 * 16 * 8 + 8
    bwd = ring + 2 * 16 * TB * 8 + TR * (TB + 1) * 8 + 3 * TR * 4 \
        + 8 * 32 * 8 + 16 + 3 * TB * 8
    assert (ring, fwd, bwd) == (52_224, 71_960, 106_256)
    assert 3 * (fwd + CTA_RESERVED) <= SM_BYTES < 4 * (fwd + CTA_RESERVED)
    assert 2 * (bwd + CTA_RESERVED) <= SM_BYTES < 3 * (bwd + CTA_RESERVED)
    assert TR * DP <= NDS * DSTAGE  # the forward's C
    assert TR * TB <= NDS * DSTAGE and 16 * TB <= NDS * DSTAGE


def test_alpha_block_chunks():
    """K4's double alpha block: thread tid copies the 16-byte chunks tid +
    u NT (u < 8: two doubles each) of the 64 x 64 block to row c / 32,
    column 2 (c % 32) of the ring at a pitch of 64; every value once, and
    the epilogue's four-column reads (row ty*4 + i, column tx*4) find the
    block's own values."""
    CV = 2
    rng = np.random.default_rng(5)
    alpha = torch.from_numpy(rng.uniform(size=(TR, TB)))
    A = torch.full((NDS * DSTAGE,), float("nan"), dtype=torch.float64)
    hits = torch.zeros(TR * TB, dtype=torch.int64)
    for u in range(TR * TB // CV // NT):
        c = torch.arange(NT) + u * NT
        r, c4 = c // (TB // CV), (c % (TB // CV)) * CV
        assert ((r * TB + c4) * 8 % 16 == 0).all()
        for e in range(CV):
            A[r * TB + c4 + e] = alpha[r, c4 + e]
            hits[r * TB + c4 + e] += 1
    assert (hits == 1).all()
    tid = torch.arange(NT)
    tx, ty = tid % 16, tid // 16
    for i in range(4):
        for c in range(4):
            torch.testing.assert_close(A[(ty * 4 + i) * TB + tx * 4 + c],
                                       alpha[ty * 4 + i, tx * 4 + c],
                                       rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the graphs' operators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ops64():
    """The float64 kernel operators of the 2M-arc graph and of the
    separate-state backoff graph (V=128, keep 0.1, capped layout)."""
    out = {}
    fsm, spdf, P, _ = port_lm_graph(128)
    out["2m"] = bs.kernel_operator(compile_port(
        fsm, spdf, P, strategy="block", dtype=torch.float64))
    fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate")
    out["separate"] = bs.kernel_operator(compile_port(
        fsm, spdf, P, dtype=torch.float64))
    return out


@pytest.mark.parametrize("name", ["2m", "separate"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_emulated_tier_on_the_graphs(ops64, name, direction):
    """The emulated tiles of tier blocks k = 0, 63 and K-1, both 64-row
    halves of D, at B = 70 (a full and a 6-column tile), each placed at
    its destination rows dst(k, d) = d0 + k dk + d dd, against the plain
    gathered product of the direction's operator: within 1e-13."""
    kd = getattr(ops64[name], direction)
    K, Sm, D = kd.W.shape
    assert kd.W.dtype == torch.float64
    Bn = 70
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, size=(ops64[name].Sp, Bn)))
    (g0, gk, gs), (d0_, dk, dd) = kd.src_map, kd.dst_map
    for k in sorted({0, 63, K - 1}):
        src = g0 + k * gk + gs * torch.arange(Sm)
        np.testing.assert_array_equal(src.numpy(), kd.src_rows[k].numpy())
        Xg = x[src]
        ref = kd.W[k].T @ Xg
        for dbase in range(0, D, TR):
            for b0 in range(0, Bn, TB):
                got = _acc_crop(emulate_tile(kd.W[k], Xg, dbase, b0),
                                dbase, b0, D, Bn)
                torch.testing.assert_close(
                    got, ref[dbase:dbase + TR, b0:b0 + TB], rtol=TOL,
                    atol=TOL)
        dst = d0_ + k * dk + dd * torch.arange(D)
        np.testing.assert_array_equal(dst.numpy(), kd.dst_rows[k].numpy())


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_heavy_rows_partials_in_the_ring(ops64, direction):
    """The capped layout's heavy rows (a tile each): thread row ty sums
    every 16th of the row's family terms for its 4 columns into P[ty][tx*4
    + c] (the ring's other use in double: 16 x 64 doubles), and the
    epilogue adds P[0..15] in order; every (ty, column) written once, the
    sum within 1e-13 of the row's plain family sum."""
    kop = ops64["separate"]
    kd = getattr(kop, direction)
    heavy = kd.heavy_rows.long()
    assert heavy.numel() == 128
    assert 16 * TB <= NDS * DSTAGE
    ptr, fsrc, fw = kd.fam_ptr.long(), kd.fam_src.long(), kd.fam_w
    Bn = 64
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, size=(kop.Sp, Bn)))
    tid = torch.arange(NT)
    tx, ty = tid % 16, tid // 16
    for j in heavy[[0, 1, 64, 127]].tolist():
        q0, q1 = int(ptr[j]), int(ptr[j + 1])
        assert q1 - q0 >= 16
        P = torch.full((16, TB), float("nan"), dtype=torch.float64)
        hits = torch.zeros((16, TB), dtype=torch.int64)
        for t in range(NT):
            s = torch.zeros(4, dtype=torch.float64)
            for qq in range(q0 + int(ty[t]), q1, NT // 16):
                s = fw[qq] * x[fsrc[qq], tx[t] * 4:tx[t] * 4 + 4] + s
            P[ty[t], tx[t] * 4:tx[t] * 4 + 4] = s
            hits[ty[t], tx[t] * 4:tx[t] * 4 + 4] += 1
        assert (hits == 1).all()
        v = torch.zeros(Bn, dtype=torch.float64)
        for gi in range(16):
            v = v + P[gi]
        want = (fw[q0:q1, None] * x[fsrc[q0:q1]]).sum(0)
        torch.testing.assert_close(v, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the bound (chip_smoke.block_traffic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_bound_counts_the_state_past_l2(ops64, dtype):
    """``block_traffic``: where two state slots (2 Sp B values) fit L2 the
    state counts once per call; where they pass it, every frame's state is
    read and written: K2 gains (2 Npad - 2) Sp B values, K3 (chunk - 1)
    Sp B and K4 (2 chunk - 2) Sp B; the operations stay.  At B=128 the
    float64 state (2 x 50.9 MB) passes the H100's 50 MiB L2, the float32
    one (50.9 MB) fits it."""
    fsm, spdf, P, _ = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate")
    cf = compile_port(fsm, spdf, P, dtype=dtype)
    B, Npad, chunk = 128, 704, 64
    kop = bs.kernel_operator(cf)
    f = kop.alpha0.element_size()
    SB = kop.Sp * B
    fits = chip_smoke.block_traffic(cf, B, Npad, chunk, l2_bytes=2 * SB * f)
    past = chip_smoke.block_traffic(cf, B, Npad, chunk,
                                    l2_bytes=2 * SB * f - 1)
    extra = {"K2": 2 * Npad - 2, "K3": chunk - 1, "K4": 2 * chunk - 2}
    for k, n in extra.items():
        assert past[k][0] == fits[k][0] and past[k][2:] == fits[k][2:]
        assert past[k][1] - fits[k][1] == n * SB * f
    l2_h100 = 50 * 2 ** 20
    assert (2 * SB * f > l2_h100) == (dtype == torch.float64)
    b = chip_smoke.block_bounds(cf, B, Npad, chunk, l2_bytes=l2_h100)
    assert all(v[1] == "bytes" for v in b.values()) or dtype == torch.float32
    if dtype == torch.float64:  # ~100 MB of state a frame through HBM
        want = 2 * Npad * SB * f / chip_smoke.PEAK_BYTES * 1e3
        assert want < b["K2"][0] < 1.05 * want
