"""The tables the two walks of the port's Viterbi decodes read on the card,
and the decode of a batch past K7's shared memory in slices, on the CPU:

* W2's packed tables (``vit_scan._w2_tables``, cached on the graph by
  ``rec_walk_tables``): each edge's (source, weight) record, each state's
  (begin, count) pair, and the ω support's (state, ω) records, against
  ``rowptr`` / ``src`` / ``w`` / ``dmax`` / ``nonzero(omega)`` element by
  element on a 'dense' and a 'block' graph, float32 and float64;
* the walk's narrowed tier-block table ``kt`` against
  ``clip(k_of, 0, K - 1)`` (uint8, uint16 as int16 bits, int32);
* ``vit_scan.max_batch``, the largest batch whose K7 / K7n CTA fits the
  card's 227 KB, for all eight (ids, fam, f64) cases, and the admission
  that no longer refuses a batch past it;
* the decode over slices (``viterbi._viterbi_scale`` with a small
  ``width``) bit-equal to the unsliced decode through both routes;
* numpy emulations of the two redesigned kernels' rules (W2: the packed
  rows, the count cap, ties, the park on fin, the ω step over the support
  with the full scan where its maximum is 0; the walk: the decode from
  the narrowed tier-block table) against the plain twins
  ``rec_walk_plain`` and ``walk_plain``, on inputs built to hit each
  branch.

The CUDA kernels are held bit for bit to the same twins on the card by
``chip_smoke.py`` (phase 56).  Inputs are made from numpy seeds."""
import importlib

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import compile_port, inputs, port_lm_graph

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

NO_CAND = 255


def _small_k7_graph():
    """A 'block' graph K7 admits at a small size: one HMM state per
    history, 5 % of the trigram arcs (Sp = 16,512, 128 tier blocks)."""
    fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128, hmm_states=1,
                                                     keep=0.05)
    return compile_port(fsm, spdf, P, strategy="block"), P


# ---------------------------------------------------------------------------
# W2's packed tables
# ---------------------------------------------------------------------------

def _values(rec: np.ndarray) -> np.ndarray:
    """The values of packed records: float32 bits in word 1, or a float64
    in words 2-3."""
    if rec.shape[1] == 4:
        return rec[:, 2:4].copy().view(np.float64)[:, 0]
    return rec[:, 1].copy().view(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_w2_records_and_rows_equal_the_edge_lists(strategy, dtype):
    """Edge e's record is (src[e], w[e]) in the graph's dtype (8 bytes, 16
    in float64); state s's pair is (rowptr[s], min(rowptr[s+1] - rowptr[s],
    dmax)), 0 for fin; the ω support records are (j, ω[j]) of
    ``nonzero(omega)`` in ascending j."""
    ct = compile_port(*port_lm_graph(16)[:3], strategy=strategy,
                      dtype=dtype)
    wt = vs.rec_walk_tables(ct)
    assert vs.rec_walk_tables(ct) is wt and wt.rec is not None  # cached
    rowptr, src = wt.rowptr.numpy().astype(np.int64), wt.src.numpy()
    w, om = wt.w.numpy(), wt.omega.numpy()
    rec, rows, sup = wt.rec.numpy(), wt.rows.numpy(), wt.sup.numpy()
    f64 = dtype == torch.float64
    assert rec.dtype == rows.dtype == sup.dtype == np.int32
    assert rec.shape == (src.shape[0], 4 if f64 else 2)
    np.testing.assert_array_equal(rec[:, 0], src)
    np.testing.assert_array_equal(_values(rec), w)
    if f64:
        assert not rec[:, 1].any()  # the pad word
    Sp = ct.padded_states
    cnt = np.minimum(np.diff(rowptr), wt.dmax)
    cnt[wt.fin] = 0
    assert rows.shape == (Sp, 2)
    np.testing.assert_array_equal(rows[:, 0], rowptr[:-1])
    np.testing.assert_array_equal(rows[:, 1], cnt)
    nz = np.nonzero(om)[0]
    assert 0 < len(nz) < Sp
    assert sup.shape == (len(nz), 4 if f64 else 2)
    np.testing.assert_array_equal(sup[:, 0], nz)
    np.testing.assert_array_equal(_values(sup), om[nz])


def test_w2_tables_of_hand_made_tables():
    """A ``RecWalkTables`` made without its packed forms gets them from
    ``_w2_tables`` (the wrapper packs such tables itself): an empty ω
    support gives no record."""
    wt = _toy_tables(np.float32, omega=np.zeros(8, np.float32))
    p = vs._w2_tables(wt)
    assert p["sup"].shape == (0, 2) and p["rows"].shape == (8, 2)
    assert p["rows"][wt.fin, 1] == 0


# ---------------------------------------------------------------------------
# the walk's narrowed tier-block table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,dtype,bits", [(200, np.uint8, 8),
                                          (300, np.int16, 16),
                                          (70_000, np.int32, 32)])
def test_narrowed_k_of_is_the_clamped_k_of(K, dtype, bits):
    """-1 (a state no tier block writes) becomes 0, never 255; the entries
    are ``clip(k_of, 0, K - 1)`` in 8, 16 (uint16 bits in an int16) or 32
    bits."""
    rng = np.random.default_rng(K)
    k_of = rng.integers(-1, K, size=500).astype(np.int32)
    k_of[:3] = (-1, K - 1, 0)
    kt = vs._narrow_k(k_of, K)
    assert kt.dtype == dtype and kt.dtype.itemsize * 8 == bits
    want = np.clip(k_of, 0, K - 1)
    got = kt.view(np.uint16) if bits == 16 else kt
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_walk_tables_carry_the_clamped_uint8_k_of():
    ct, _ = _small_k7_graph()
    wt = vs.walk_tables(ct)
    k_of = wt.k_of.numpy()
    assert wt.K == 128 and (k_of == -1).any()
    assert wt.kt.dtype == torch.uint8 and wt.kt.shape == k_of.shape
    np.testing.assert_array_equal(wt.kt.numpy(), np.clip(k_of, 0, wt.K - 1))


# ---------------------------------------------------------------------------
# the largest batch and the sliced decode
# ---------------------------------------------------------------------------

# (ids, fam, f64): the largest batch of each K7 / K7n instantiation
MAX_BATCH = {(True, False, False): 20_542, (True, False, True): 10_271,
             (True, True, False): 20_542, (True, True, True): 10_223,
             (False, False, False): 17_182, (False, False, True): 10_271,
             (False, True, False): 17_086, (False, True, True): 10_223}


@pytest.mark.parametrize("case", sorted(MAX_BATCH))
def test_max_batch_is_the_largest_batch_smem_bytes_admits(case):
    B = vs.max_batch(*case)
    assert B == MAX_BATCH[case]
    assert vs.smem_bytes(B, *case) <= vs._SMEM_CTA < vs.smem_bytes(B + 1,
                                                                   *case)


def test_admission_takes_a_batch_past_the_shared_memory():
    """A small graph at B = 24,576, past every instantiation's largest
    batch: neither K7's nor K7n's admission refuses it (the decode slices
    it on the card), while a launch at that batch would raise."""
    ct, _ = _small_k7_graph()
    B = 24_576
    for saved in (None, 4):
        assert vs.vit_scan_admission(ct, B, n_frames=8,
                                     saved=saved) == (None, True)
        with pytest.raises(ValueError, match="slices"):
            vs._check_batch(B, saved is None, False, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["bp", "recompute"])
def test_sliced_decode_equals_the_unsliced_one(route, dtype, monkeypatch):
    """``_viterbi_scale`` over slices of 3 sequences (8 sequences: slices
    of 3, 3, 2) gives the unsliced decode's states and scores bit for bit,
    through the compressed-backpointer route and the chunk-recompute route
    (the id budget lowered to 0, chunks of 5 frames: the whole batch's
    chunk is every slice's)."""
    fsm, spdf, P, _ = port_lm_graph(8)
    ct = compile_port(fsm, spdf, P, strategy="block", dtype=dtype)
    lhs, lens = inputs(8, 14, P, seed=5, lens=[14, 1, 9, 14, 2, 13, 14, 7],
                       cliffs=True)
    lhs, lens = torch.from_numpy(lhs).to(dtype), torch.from_numpy(lens)
    if route == "recompute":
        monkeypatch.setattr(tvit, "_BP_MEM_BYTES", 0)
    assert (tvit._bp_vit_reject_reason(ct, lhs) is None) == (route == "bp")
    chunk = 5 if route == "recompute" else None
    whole = tvit._viterbi_scale(ct, lhs, lens, chunk)
    sliced = tvit._viterbi_scale(ct, lhs, lens, chunk, width=3)
    assert tvit._slice_width(ct, lhs, True) == 8  # the CPU: no slice
    for a, b in zip(whole, sliced):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the lengths 1 and 2 are infeasible (-inf), the others decode
    assert whole[0].shape == (8, 14)
    assert torch.isfinite(whole[1]).tolist() == [True, False, True, True,
                                                 False, True, True, True]


def test_slice_width_on_the_card_is_max_batch():
    """On a ``cuda`` device (decided without a card) a 'block' graph on
    the kernels' route takes slices of K7's or K7n's largest batch, a
    general Ĉ and a 'dense' graph the whole batch."""
    ct, P = _small_k7_graph()

    class _Lhs:  # the shape and device, as _slice_width reads them
        shape = (30_000, 4, P)
        device = torch.device("cuda")

    assert tvit._slice_width(ct, _Lhs, True) == 20_542
    assert tvit._slice_width(ct, _Lhs, False) == 17_182
    dense = compile_port(*port_lm_graph(8)[:3], strategy="dense")
    assert tvit._slice_width(dense, _Lhs, False) == 30_000


# ---------------------------------------------------------------------------
# W2's rules, emulated from the packed tables
# ---------------------------------------------------------------------------

def _toy_tables(dt, omega=None, dmax=None):
    """Sp = 8 states, fin = 6: state 3's in-arcs from 1, 2, 5 (equal
    weights: ties), state 4's from 0 and 7, state 2's 70 in-arcs from
    every state in turn (more than two rounds of 32; Dmax caps them where
    given), state 7 (row Sp - 1) two in-arcs, fin's from 5."""
    Sp, fin = 8, 6
    lw = np.log(0.5)
    edges = [(2, i % Sp, -0.01 * (i % 5)) for i in range(70)]
    edges += [(3, 1, lw), (3, 2, lw), (3, 5, lw), (4, 0, 0.0), (4, 7, 0.0),
              (fin, 5, 0.0), (7, 3, -1.0), (7, 4, -2.0)]
    edges.sort(key=lambda e: e[0])
    dst = np.array([e[0] for e in edges])
    rowptr = np.searchsorted(dst, np.arange(Sp + 1)).astype(np.int32)
    indeg = np.diff(rowptr)
    indeg[[fin, Sp - 1]] = 0
    if omega is None:
        omega = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    tdt = torch.float64 if dt == np.float64 else torch.float32
    return vs.RecWalkTables(
        rowptr=torch.from_numpy(rowptr),
        src=torch.tensor([e[1] for e in edges], dtype=torch.int32),
        w=torch.tensor([e[2] for e in edges], dtype=tdt),
        omega=torch.tensor(omega, dtype=tdt),
        dmax=dmax or int(indeg.max()), fin=fin)


def _w2_emulate(wt, states, scales, lengths, t0, s_next):
    """W2 as ``csrc/rec_walk.cu`` computes it, from the packed tables: per
    frame the (begin, count) pair of the state after (carried from the
    frame before), the candidates log(α·scale) + w of its records, the
    largest value at the largest position, fin where all are -inf; at
    t = L - 1 the argmax of (α·scale)·ω over the support, over every
    state where the support's maximum is not positive.  The log is the
    plain twin's (torch's), so that the rules, not two libraries' logs,
    are compared."""
    p = vs._w2_tables(wt)
    rows, rec, sup = (p[k].numpy() for k in ("rows", "rec", "sup"))
    rsrc, rw, sj, sw = rec[:, 0], _values(rec), sup[:, 0], _values(sup)
    A, S, om = states.numpy(), scales.numpy(), wt.omega.numpy()
    nK, Sp, B = A.shape
    out = np.empty((nK, B), np.int32)

    def argmax(vals, idx):  # the largest value at the largest index
        best, bi = None, -1
        for v, i in zip(vals, idx):
            if not np.isnan(v) and (best is None or v > best
                                    or (v == best and i > bi)):
                best, bi = v, i
        return best, bi

    for b in range(B):
        L = int(lengths[b])
        row = rows[s_next[b]]
        for i in reversed(range(nK)):
            t = t0 + i
            a, sc = A[i, :, b], S[i, b]
            st, nrow = wt.fin, (0, 0)
            if t == L - 1:
                best, st = argmax((a[sj] * sc) * sw, sj)
                if best is None or not best > 0:  # every state
                    _, st = argmax((a * sc) * om, np.arange(Sp))
                nrow = rows[st]
            elif t < L:
                e = row[0] + np.arange(row[1])
                x = a[rsrc[e]] * sc
                logx = torch.log(torch.from_numpy(np.where(x > 0, x, 1)))
                v = np.where(x > 0, logx.numpy() + rw[e], -np.inf)
                best, d = argmax(v, np.arange(row[1]))
                if best is not None and best != -np.inf:
                    st = rsrc[e[d]]
                    nrow = rows[st]
            out[i, b] = st
            row = nrow
    return torch.from_numpy(out)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("dmax", [None, 40])
def test_w2_rules_from_the_packed_tables_equal_the_twin(dt, dmax):
    """Columns: 0 ties among state 3's in-arcs; 1 no mass on state 4's
    sources (park on fin); 2 state 2's 70 in-arcs (three rounds of 32,
    capped at 40 with ``dmax``); 3-4 lengths 2 and 1 (the ω step, by value
    and by a tie); 5 the ω support's maximum 0 (its states hold no mass):
    the full scan takes the largest state, 7; 6 the state after is fin;
    7 length N, random mass.  Two chunks (t0 0 and 4) of a 9-frame walk."""
    rng = np.random.default_rng(2)
    wt = _toy_tables(dt, dmax=dmax)
    Sp, B, nK = 8, 8, 4
    a = rng.uniform(0.1, 1.0, size=(2 * nK, Sp, B)).astype(dt)
    a[:, 1, 0] = a[:, 5, 0] = 0.7  # tie: position 2 (source 5) wins
    a[:, 2, 0] = 0.1
    a[:, [0, 7], 1] = 0.0  # no mass on state 4's sources
    a[:, [2, 5], 3] = (0.5, 1.0)  # by value: 0.5 * 1.0 == 1.0 * 0.5
    a[:, [2, 5], 5] = 0.0  # the support's maximum is 0
    a[:, 3:5, 5] = 0.3
    scales = rng.choice([0.5, 1.0, 2.0, 4.0], size=(2 * nK, B)).astype(dt)
    lengths = torch.tensor([2 * nK] * 3 + [2, 1, 3, 2 * nK, 2 * nK],
                           dtype=torch.int32)
    nxt = torch.tensor([3, 4, 2, 6, 6, 6, 6, 3], dtype=torch.int32)
    states, sc = torch.from_numpy(a), torch.from_numpy(scales)
    for t0 in (nK, 0):
        want = vs.rec_walk_plain(wt, states[t0:t0 + nK], sc[t0:t0 + nK],
                                 lengths, t0, nxt)
        got = _w2_emulate(wt, states[t0:t0 + nK], sc[t0:t0 + nK], lengths,
                          t0, nxt)
        assert torch.equal(got, want), (t0, got, want)
        nxt = want[0]
    assert want[2, 5] == 7  # the full scan's largest state among the 0s
    assert want[1, 3] == 5  # the ω step's tie: the largest state
    assert want[0, 3] == wt.fin  # state 5 has no in-arc


# ---------------------------------------------------------------------------
# the walk over the ids, emulated from the narrowed table
# ---------------------------------------------------------------------------

def _toy_walk_tables(rng, Sp=96, RW=80, K=3, Sm=8, nO=2, fam=True):
    """A hand-made decode layout: tier sources in [0, RW + 4), some
    states in no tier block (k_of -1), band offsets 1 and 3, the overflow
    rows [64, 72) with random sources and -1 entries, out-family sources
    on half the core rows."""
    k_of = rng.integers(-1, K, size=Sp).astype(np.int32)
    sidx = rng.integers(0, RW + 4, size=K * Sm).astype(np.int32)
    offs = np.array([1, 3], np.int32)[:nO]
    ov_lo, ov_hi = (64, 72) if fam else (Sp, Sp)
    n_dec = max(ov_hi - ov_lo, 1)
    dec = np.where(rng.random((n_dec, 256)) < 0.1, -1,
                   rng.integers(0, RW, size=(n_dec, 256))).astype(np.int32)
    if not fam:
        dec[:] = -1
    oo = np.where(rng.random(Sp) < 0.5, rng.integers(0, RW, size=Sp), -1)
    oo = oo.astype(np.int32) if fam else np.full(Sp, -1, np.int32)
    return vs.WalkTables(
        k_of=torch.from_numpy(k_of), sidx=torch.from_numpy(sidx),
        offs=torch.from_numpy(offs if nO else np.zeros(1, np.int32)),
        ov_dec=torch.from_numpy(dec), ovout=torch.from_numpy(oo), K=K,
        Sm=Sm, nO=nO, fin=RW + 4, ov_lo=ov_lo, ov_hi=ov_hi,
        kt=torch.from_numpy(vs._narrow_k(k_of, K)))


def _toy_ids(rng, wt, RW, Nf, B):
    """Ids of every kind: tier positions, band ids (on rows whose band
    sources are states), the out-family id, a stray id and 255; fins
    anywhere in the main region or past it."""
    Sm, nO = wt.Sm, wt.nO
    c = rng.integers(0, Sm, size=(Nf, RW, B))
    r = rng.random((Nf, RW, B))
    band = rng.integers(Sm, Sm + max(nO, 1), size=(Nf, RW, B))
    rows = np.arange(RW)[None, :, None]
    c = np.where((r < 0.25) & (rows >= 3) & (nO > 0), band, c)
    c = np.where((r >= 0.25) & (r < 0.35), Sm + nO, c)
    c = np.where((r >= 0.35) & (r < 0.38), Sm + nO + 7, c)
    c = np.where(r >= 0.97, NO_CAND, c)
    fins = rng.integers(0, RW + 8, size=(Nf, B)).astype(np.int32)
    return torch.from_numpy(c.astype(np.uint8)), torch.from_numpy(fins)


def _decode(wt, kt, s, c):
    """The source of state s under id c (``csrc/vit_scan.cu``
    walk_decode), from the narrowed tier-block table."""
    Sp = kt.shape[0]
    sc = min(max(s, 0), Sp - 1)
    if c < wt.Sm:
        src = int(wt.sidx[int(kt[sc]) * wt.Sm + c])
    else:
        src = s - int(wt.offs[min(c - wt.Sm, max(wt.nO, 1) - 1)])
    if c == wt.Sm + wt.nO:
        o = int(wt.ovout[sc])
        src = o if o >= 0 else wt.fin
    if wt.ov_lo <= s < wt.ov_hi:
        od = int(wt.ov_dec[s - wt.ov_lo, c])
        src = od if od >= 0 else wt.fin
    return wt.fin if c == NO_CAND else src


def _walk_emulate(wt, bps, fins, lengths):
    """The walk as the kernel computes it, frame by frame from the narrowed
    tier-block table: past the length fin, at the length the fins, else
    the id of the current state decoded to its source."""
    Nf, RW, B = bps.shape
    ids, kt = bps.numpy(), vs._narrow_k(wt.k_of.numpy(), wt.K)
    kt = kt.view(np.uint16) if kt.dtype == np.int16 else kt
    out = np.empty((Nf - 1, B), np.int32)
    for b in range(B):
        L, s = int(lengths[b]), wt.fin
        for t in range(Nf - 1, 0, -1):
            c = int(ids[t, s, b]) if s < RW else NO_CAND
            sp = int(fins[t, b]) if t == L else _decode(wt, kt, s, c)
            s = wt.fin if t > L else sp
            out[t - 1, b] = s
    return torch.from_numpy(out)


@pytest.mark.parametrize("fam", [True, False])
def test_walk_emulation_equals_the_twin(fam):
    """The walk, from the narrowed table, on every kind of id (tier, band,
    out-family, stray, 255), overflow rows, lengths 0, 1, N and in
    between, and fins past the main region, equals ``walk_plain``."""
    rng = np.random.default_rng(7 + fam)
    RW, Nf, B = 80, 13, 12
    wt = _toy_walk_tables(rng, RW=RW, fam=fam)
    bps, fins = _toy_ids(rng, wt, RW, Nf, B)
    lengths = torch.tensor([12, 1, 0, 7, 12, 2, 11, 12, 5, 12, 3, 12],
                           dtype=torch.int32)
    want = vs.walk_plain(wt, bps, fins, lengths)
    got = _walk_emulate(wt, bps, fins, lengths)
    assert torch.equal(got, want)
    # the walks left the phony state: real chains were decoded
    assert (want[:10] != wt.fin).float().mean() > 0.3
