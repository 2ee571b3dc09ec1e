"""Fused tropical Viterbi sweep (K7) and the backtrace walk on the GPU:
hand-written CUDA kernels with plain PyTorch twins.

Counterpart of ``_make_vit_kernel`` / ``vit_scan_supported`` /
``block_fused_viterbi_fwd`` in ``markovmodels_tpu/ops/pallas_block.py`` and
of the walk of ``markovmodels_tpu/viterbi.py``'s ``_viterbi_scale_bp``.
One shared 'block' graph (the 2M-arc denominator) runs over a (Sp, B)
probability state in the max-product semiring:

* K7 ``viterbi_fwd``: one forward sweep over all frames, one persistent
  cooperative launch whose CTAs take every frame's work items from the
  queue of :func:`vit_plan`.  Per frame and main-region state [0, R·W) it
  records the winning uint8 candidate id (< Sm: tier source position,
  Sm + oi: band offset oi, 255: no incoming mass), per frame the argmax
  source of the rank-1 ω arcs into the phony final state, and at the end
  the final value, the Kahan-compensated emission shift and the
  power-of-two exponent sum.  A capped layout with overflow families
  (the separate-state backoff graph) takes the kernel's family branch
  (FAM): a core row's out-family candidate is Sm + nO, an overflow row of
  group g takes its in-families at [0, C_g) and its bands at C_g + oi
  (``blocked._ov_cand_layout``), the rows with many terms get a work item
  each, and every row's emission comes from its own pdf;
* ``walk``: the backtrace, decoding the ids to source states through the
  tier's destination inverse and the band offsets, and with families
  through the tables ``ov_dec`` and ``ovout`` (the JAX package leaves this
  walk to XLA); the tier sources and the narrowed tier-block table ``kt``
  staged in each CTA's shared memory.

and for the chunk-recompute decode (``markovmodels_tpu/viterbi.py``'s
``_viterbi_scale``, XLA there), which takes every 'dense' graph and the
'block' graphs the compressed-backpointer decode refuses:

* K7n ``viterbi_fwd(..., ids=False)``: K7 without the ids (the tier keeps
  its max only, no id and no ω argmax stored), from a given state and
  scale at a given global frame, saving every frame's state (a chunk's
  recompute) or every stride-th one (the first sweep's checkpoints), the
  phony row included, unscaled with its scale.  Its twin is also the CPU
  route for any 'block' graph, multi-tier ones included;
* W2 ``rec_walk``: the walk of one chunk, one warp per sequence: the state
  of frame t is the best in-arc source of the state of frame t + 1 under
  the frame's alphas (log α + w over the dst-sorted edge list, ties to the
  largest position), the ω arc's source at t = L - 1, the phony state past
  the length.  It reads packed tables (``RecWalkTables.rec``, ``rows``,
  ``sup``): per frame one round of in-arc records, then their alphas, and
  the ω argmax over the ω support.  Shared with the 'dense' decode
  (ops/dense_scan.py K6t).

K7's and K7n's CTA keeps two rows of B values in shared memory: a launch
past :func:`max_batch` raises, and ``viterbi`` decodes such a batch in
slices of at most that many sequences.

The CUDA sources are ``csrc/vit_scan.cu``; ``_build.py`` compiles them with
nvcc at first use.  Each wrapper takes its plain twin for CPU tensors and
launches the kernel for CUDA tensors; anything else raises.

A float64 graph (``compile_fsm(dtype=torch.float64)``; the JAX package
decodes those in XLA, its K7 takes float32) takes the float64 instantiation
of K7, K7n and W2: the panels, bands, family weights, ω, states, scales and
emissions in float64, the ω argmax as a pair of words, the tier's running
(max, position) compared on the FP64 pipe through a stage ring of its own
(``csrc/vit_scan.cu`` tier_dbl); the ids, the queue, the walk over the ids
and its tables do not depend on the dtype.  A float32 graph keeps float32 panels in every
precision mode.

Values: the state is stored unscaled with a per-column power-of-two scale
applied when the next frame reads it, as in K2 (ops/block_scan.py).  The
read gives exactly K7's rescaled state (a product by a power of two is
exact), so the products, and hence the ids, are K7's.  The exponent comes
from the float's exponent bits (``frexp``); the JAX kernel's
``floor(log2 m)`` may differ by one next to a power of two, which moves
only where the scale sits (compare scores, not ``ksum``).

The kernel finds each tier output's max before its id: the value-only max
over groups of g consecutive source positions (g = 8, the library's
``mm_vit_layout``), the running value
and group moving only where a group's max is strictly greater, then the
first position of the winning group whose product equals the max.  It
gives the ids of "strict >, smallest position among equal maxima" bit for
bit (``tests/test_torch_vit_plan.py`` holds a torch emulation of the rule
to ``block_matvec_max_arg`` and to the JAX kernel).  The float64 tier
keeps a running (max, first position) per output candidate by candidate,
its compares as doubles on the FP64 pipe, and stages the untransposed
panels and the state rows through a ``cp.async`` ring
(``tests/test_torch_vit_f64_tier.py`` emulates its maps and its rule).
The float32 K7n needs no id, so its tier streams the untransposed panels
and the state rows through a ring of its own beside the epilogue's tables,
the first stages of a CTA's next item issued before the current item's
epilogue.  In float32 (K7 and K7n) a capped layout's heavy rows go four to
a work item (``vit_plan(packed=True)``; ``tests/test_torch_vit_noid_tier.py``,
``tests/test_torch_vit_fam_pack.py``), K7's partials merged by the family
rule (the max, then the smallest id), which gives the same ids however the
terms are split.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import block_scan as bs
from .blocked import (_ov_cand_layout, block_matvec, block_matvec_max_arg,
                      block_max_arg_reason, family_grid, family_grids,
                      tier_dst_inverse)

__all__ = [
    "vit_scan_admission",
    "vit_scan_reject_reason",
    "viterbi_fwd",
    "viterbi_fwd_plain",
    "walk_tables",
    "walk",
    "walk_plain",
    "rec_walk_tables",
    "rec_walk",
    "rec_walk_plain",
    "vit_plan",
    "ov_span",
    "LAUNCHES",
    "LAUNCHES_FAM",
    "LAUNCHES_F64",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper: the
# float32 instantiations in LAUNCHES, the float64 ones (a float64 graph) in
# LAUNCHES_F64 (the walk over the ids has one instantiation, in LAUNCHES)
LAUNCHES = {"vit_fwd": 0, "vit_walk": 0, "vit_fwd_noid": 0, "rec_walk": 0}
LAUNCHES_F64 = {"vit_fwd": 0, "vit_fwd_noid": 0, "rec_walk": 0}
# the launches of K7 and K7n that took the family branch (also counted in
# LAUNCHES or LAUNCHES_F64)
LAUNCHES_FAM = {"vit_fwd": 0, "vit_fwd_noid": 0}

_NO_CAND = 255
# the JAX kernel's tier chunk (pallas_block._VIT_KC): kept as an admission
# predicate so that both packages take the same route for the same graph
_VIT_KC = 8
# csrc/vit_scan.cu's layout constants (the tests read them from the source):
# 64 x 64 items; K7's resident pass of _SC positions at a pitch of _SC + 4
# floats; the double ring of _DV-position stages at a pitch of _DVP doubles
# (_NVS slots); the float K7n's ring of _FV-position stages at a pitch of
# 64 floats (_NFS slots); the float instantiations' _HEAVY_PACK heavy rows to
# an item
_TB = 64
_SC = 128
_DV, _DVP, _NVS = 16, _TB + 2, 4
_FV, _NFS = 32, 4
_HEAVY_PACK = 4
# a CTA's shared memory on the card (cudaDevAttrMaxSharedMemoryPerBlockOptin
# of an H100: 227 KB)
_SMEM_CTA = 232_448


def reset_launch_counts():
    for d in (LAUNCHES, LAUNCHES_FAM, LAUNCHES_F64):
        for k in d:
            d[k] = 0


def _counts(f64: bool) -> dict:
    return LAUNCHES_F64 if f64 else LAUNCHES


def _vit_dtype(cf):
    """The dtype of K7's and K7n's panels and values: float64 for a float64
    graph, else float32 (a bf16 graph decodes with float32 panels, as the
    TPU K7 ignores the precision)."""
    return (torch.float64 if cf.alpha_hat.dtype == torch.float64
            else torch.float32)


def _main_region(cf) -> int:
    """R·W: the states K7 records ids for; the tail [R·W, Sp) holds the
    phony final state (and padding), whose only arcs are the ω ones.  A
    graph without K7's plan (the plain twins' CPU route) takes all Sp."""
    plan, _ = bs._full_plan_explain(cf)
    return plan[0] * plan[1] if plan is not None else cf.padded_states


def ov_span(cf):
    """(ov_lo, nOv, cmax) of a graph with overflow families, the JAX
    package's ``ov_span`` (``viterbi.py:256-263``), else None: a capped
    layout whose overflow rows are fed by bands alone keeps the core
    encoding on them."""
    if cf.ov_layout and cf.block_fwd.ov_w:
        cmax, nOv = cf.ov_layout
        return cf.num_pdfs * cmax, nOv, cmax
    return None


def _fam_reason(cf, ids: bool):
    """The first family predicate of :func:`block_max_arg_reason` that
    the graph fails (``ids``: the uint8 ones too), or None; cached on the
    graph (the admission runs before every launch)."""
    span = ov_span(cf)
    if span is None:
        return None
    key = ("vit_fam_reason", ids)
    if key not in cf._cache:
        ov_lo, nOv, cmax = span
        cf._cache[key] = block_max_arg_reason(
            cf.block_fwd, cf.block_fwd_offsets, ov_lo, cmax,
            ov_lo + nOv * cmax, ids=ids)
    return cf._cache[key]


def layout(B: int, n_frames: int, f64: bool = False) -> tuple:
    """(scratch bytes, g) of K7 at batch ``B`` over ``n_frames`` frames in
    float32 or (``f64``) float64, from the library (``mm_vit_layout``): the
    zeroed scratch the sweep carves its per-frame column maxima, omega keys
    (in float64 also the ω pairs' j-words, the zero j-words and the pairs'
    locks), queue positions and barrier words from, and the tier
    candidates per id compare (float32 a max group; float64 1: every
    candidate is compared with the running max)."""
    from . import _build

    out = (ctypes.c_longlong * 2)()
    bs._raise_on(_build.library().mm_vit_layout(B, n_frames + 1, int(f64),
                                                out), "mm_vit_layout")
    return int(out[0]), int(out[1])


def smem_bytes(B: int, ids: bool = True, fam: bool = False,
               f64: bool = False) -> int:
    """Dynamic shared memory of one K7 (``ids``) or K7n CTA at batch ``B``,
    reckoned as ``csrc/vit_scan.cu`` lays it out (``vit_smem_bytes``; the
    library's ``mm_vit_smem`` gives the same on the card): a union of the
    tier's operands (K7 in float32: the resident W and X of _SC positions
    at a pitch of _SC + 4; float64: the ring of _NVS stages of 2 x _DV x
    _DVP doubles), the epilogue's tables and a heavy row's partials, or in
    the float32 K7n the union of the tables (no ids) and the partials
    beside its ring of _NFS stages of 2 x _FV x 64 floats; then the row
    and pdf tables of the item's 64 rows and two queue entries, with
    ``fam`` the rows' family ranges (but in the float32 K7, which reads
    them from ``FamTables.frow``), and two rows of B values (the columns'
    scales and the phony state of the frame before)."""
    w = 8 if f64 else 4
    if f64:
        u = _NVS * 2 * _DV * _DVP * 8
    elif ids:
        u = 2 * _TB * (_SC + 4) * 4
    else:
        ep = _TB * (_TB + 1) * 4 + 16 * _TB * 4 + 16 * _TB * 8
        u = ep + _NFS * 2 * _FV * _TB * 4
    # the family rows' ranges (int3 each), but in the float32 K7
    n = u + 2 * _TB * 4 + 16 + (_TB * 12 if fam and (f64 or not ids) else 0)
    return -(-n // 8) * 8 + 2 * B * w


def max_batch(ids: bool = True, fam: bool = False, f64: bool = False) -> int:
    """The largest batch whose CTA of K7 (``ids``) or K7n takes at most the
    card's 227 KB of shared memory (:func:`smem_bytes`): the columns of one
    slice of the decode past it (``viterbi._viterbi_scale``)."""
    return (_SMEM_CTA - smem_bytes(0, ids, fam, f64)) // (16 if f64 else 8)


def _check_batch(B: int, ids: bool, fam: bool, f64: bool):
    """A launch of K7 or K7n past :func:`max_batch` raises: its two rows
    of B values would not fit the CTA's shared memory (the decode runs such
    a batch in slices)."""
    most = max_batch(ids, fam, f64)
    if B > most:
        raise ValueError(
            f"shared memory of a CTA at B = {B} ~"
            f"{smem_bytes(B, ids, fam, f64)} bytes exceeds the card's "
            f"{_SMEM_CTA}: decode in slices of at most {most} columns")


def _device_bytes(cf, B: int, n_frames: int, saved=None) -> int:
    """Device bytes of one K7 sweep, every buffer sized by its dtype: the
    uint8 id stream (K7n: ``saved`` frames of state and scale instead),
    the initial state and the ping-pong pair, the emissions, the operator
    (with the float32 K7's transposed panels), the family branch's tables
    (the row pdfs, the per-row terms with their candidate ids, the heavy
    rows, the groups' band id bases) and the walk's decode tables, and the
    scratch (:func:`layout`)."""
    Sp, P1 = cf.padded_states, cf.num_pdfs + 1
    f = cf.alpha_hat.element_size()
    Nf = n_frames + 1
    op = cf.block_fwd
    tens = [cf.omega_prob, cf.alpha_hat, op.tiers[0][2]]
    if saved is None and f == 4:
        tens.append(op.tiers[0][2])  # _panels_t's transposed copy
    if op.band_w is not None:
        tens.append(op.band_w)
    need = sum(t.numel() * t.element_size() for t in tens)
    if saved is None:
        need += Nf * _main_region(cf) * B  # ids
    else:
        need += saved * (Sp + 1) * B * f  # saved states and scales
    need += 3 * Sp * B * f + Nf * (P1 + 1) * B * f
    if cf.ov_layout:
        cmax, nOv = cf.ov_layout
        n_w = sum(t.numel() for t in op.ov_w)
        need += 4 * (2 * Sp + 1 + nOv) + (5 + f) * n_w  # pdfs, terms, cids
        need += 4 * (Sp + nOv * cmax * 256)  # ovout, ov_dec
    need += layout(B, n_frames, f == 8)[0]
    return need


def vit_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                           device=None, saved: int | None = None):
    """None when K7 accepts this graph, else a one-line reason naming the
    FIRST rejected predicate (the first element of
    :func:`vit_scan_admission`)."""
    return vit_scan_admission(cf, B, n_frames=n_frames, device=device,
                              saved=saved)[0]


def vit_scan_admission(cf, B: int, *, n_frames: int | None = None,
                       device=None, saved: int | None = None):
    """(reason, shared): the FIRST predicate of K7 that this graph fails
    (None when K7 accepts it), and whether the JAX package refuses the
    graph for it too (its XLA decode then runs the graph).  The uniform
    predicates are the JAX package's (``vit_scan_supported``) in its
    order: the blocked scan's (:func:`block_scan.block_scan_admission`,
    whose own predicates of the port are the only ones not shared), uint8
    candidate ids, the tier-chunk divisibility.  Where the JAX package
    refuses overflow families (the TPU K7 has no branch for them), the
    port's K7 takes them in its family branch, under the predicates of
    ``blocked.block_max_arg_reason`` (the compressed-backpointer decode's
    admission, whose route K7 is the card's kernel for); a graph these
    refuse, the JAX package refuses too.  Instead of its VMEM budget, the
    working set (``_device_bytes``) must fit the memory of ``device`` when
    that is a CUDA device (checked where a card is present).  With
    ``saved`` (K7n, which saves that many frames' states and stores no id)
    the predicates on the ids' range are skipped and the working set
    counts the saved states in place of the ids.  A float64 graph takes
    the float64 instantiation (the JAX package's K7 refuses it, its XLA
    route decodes it).  No batch is refused for the CTA's shared memory:
    ``viterbi`` decodes a batch past :func:`max_batch` in slices."""
    reason, shared = bs.block_scan_admission(
        cf, B, tier_dtype=_vit_dtype(cf), tropical=True)
    if reason is not None:
        return reason, shared
    (_, _, pf, _), _ = bs._full_plan_explain(cf)
    reason = _fam_reason(cf, ids=saved is None)
    if reason is not None:
        return f"overflow families: {reason}", True
    nO = len(pf["band_offsets"])
    if saved is None and pf["Sm"] + nO >= _NO_CAND:
        return (f"tier width {pf['Sm']} + {nO} band offsets: candidate ids "
                "do not fit a uint8"), True
    if not (pf["K"] % _VIT_KC == 0 or pf["K"] < _VIT_KC):
        return f"{pf['K']} tier blocks not a multiple of {_VIT_KC}", True
    if (device is not None and n_frames is not None
            and torch.device(device).type == "cuda"
            and torch.cuda.is_available()):
        need = _device_bytes(cf, B, n_frames, saved)
        have = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
        if need > have:
            return (f"device working set ~{need / 1e9:.1f} GB exceeds the "
                    f"card's {have / 1e9:.1f} GB (Sp = {cf.padded_states}, "
                    f"B = {B}, {n_frames} frames)"), True
    return None, True


def _check_graph(cf, B: int, n_frames: int, device, saved=None):
    reason = vit_scan_reject_reason(cf, B, n_frames=n_frames, device=device,
                                    saved=saved)
    if reason is not None:
        raise ValueError(f"the Viterbi sweep rejects this graph: {reason}")


# ---------------------------------------------------------------------------
# the host plan of the persistent sweep
# ---------------------------------------------------------------------------

class VitPlan(NamedTuple):
    """The queue of K7's work items, the same in every frame: one row tile
    of the forward operator (a heavy row's tile, then the tier tiles, then
    the 64-row band tiles, in the order of ``block_scan._row_tiles``) times
    one 64-column tile, coded tile·ncb + column tile: every heavy item (the
    family branch's rows with many terms, none on a uniform layout), every
    tier item, then every band item, each in tile, then column-tile order
    (``block_scan._queue`` with no spread: the tier items interleaved with
    the band items, or taken first by one CTA of each SM, measured slower,
    PERF.md §6).  Each entry also carries
    the first row of a band tile whose rows are consecutive (-1 for any
    other tile).  The CTAs of the persistent grid take the items in queue
    order; which CTA runs an item shows in no result (the frame's two
    reductions are maxima).  The float32 queue (``packed``, K7's and
    K7n's) takes _HEAVY_PACK heavy rows to an item: heavy tile h holds
    heavy rows h·_HEAVY_PACK .., and the tier and band tiles follow from
    ceil(nheavy / _HEAVY_PACK)."""
    ncb: int  # 64-column tiles: ceil(B / 64)
    queue: torch.Tensor  # (n_tiles * ncb, 2) int32: item, first row or -1


def vit_plan(kop, B: int, packed: bool = False) -> VitPlan:
    """K7's queue for batch ``B`` (``packed``: the float32 one, its heavy
    rows _HEAVY_PACK to an item), built once per shape of the forward
    operator's tiles and cached on ``kop``."""
    kd = kop.fwd
    counts = bs._tile_counts(kd, B)
    key = ("vit_plan", packed) + counts
    pl = kop.plans.get(key)
    if pl is None:
        queue, _ = bs._queue(kd, B, 0.0)
        if packed:
            queue = _pack_heavy(queue, counts[0], counts[1])
        pl = VitPlan(ncb=counts[0], queue=bs._i32(queue, kd.W.device))
        kop.plans[key] = pl
    return pl


def _pack_heavy(queue: np.ndarray, ncb: int, nh: int) -> np.ndarray:
    """The queue with its nh·ncb one-row heavy items (first, in tile then
    column-tile order) replaced by ceil(nh / _HEAVY_PACK)·ncb packed ones
    in the same order, every later item's tile moved down to follow
    them."""
    nhp = -(-nh // _HEAVY_PACK)
    heavy = queue[:, 0] < nh * ncb
    assert heavy[:nh * ncb].all(), "the heavy items lead the queue"
    rest = queue[~heavy].copy()
    rest[:, 0] -= (nh - nhp) * ncb
    head = np.stack([np.arange(nhp * ncb), np.full(nhp * ncb, -1)], axis=1)
    return np.concatenate([head, rest]).astype(queue.dtype)


def _panels_t(kop) -> torch.Tensor:
    """The tier panels as K7 stages them, cached on ``kop``: float32 (K, D,
    Sm4) transposed, each destination's column contiguous and zero-padded
    to a multiple of 4 positions (copied to shared memory 16 bytes at a
    time); float64 (K, Sm, D) as they are (the double tier stages [s][d]
    rows, ``csrc/vit_scan.cu`` tier_dbl).  K7n takes (K, Sm, D) as they
    are in both dtypes (its float32 tier, tier_noid, stages [s][d] rows
    too)."""
    Wt = kop.plans.get("vit_panels")
    if Wt is None:
        K, Sm, D = kop.fwd.W.shape
        if kop.fwd.W.dtype == torch.float64:
            Wt = kop.fwd.W.contiguous()
        else:
            Wt = kop.fwd.W.new_zeros((K, D, -(-Sm // 4) * 4))
            Wt[:, :, :Sm] = kop.fwd.W.transpose(1, 2)
        kop.plans["vit_panels"] = Wt
    return Wt


def _is_fam(kop) -> bool:
    """The capped layout takes the kernels' family branch (FAM), as K2's
    ``is_fam``: overflow rows or family terms."""
    return kop.ov_lo < kop.ov_hi or kop.fwd.fam_dst.numel() > 0


class FamTables(NamedTuple):
    """K7's tables of the family branch beside K2's (built once per
    operator): the candidate id of each forward family term, in the order
    of ``KernelDir.fam_src``, the band id base of each overflow group
    (C_g with families, else Sm: a capped layout fed by bands alone keeps
    the core encoding), and per state row its terms' range, band id base
    and emission row in one int4 (the float32 K7 reads it with the row's
    state in the epilogue)."""
    cid: torch.Tensor  # (nfam,) uint8 (one zero where there is none)
    cbase: torch.Tensor  # (nOv,) int32 (one Sm where there is none)
    # (Sp, 4) int32 per row: its terms [x, y), band id base, emission row
    frow: torch.Tensor


def fam_tables(cf, kop) -> FamTables:
    """K7's family tables of a graph (cached on ``kop``): an 'in' term of
    a column family takes cum + its row r, of a window cum + its position
    j (cum: the family's first id in its group, ``_ov_cand_layout``), an
    'out' term Sm + nO."""
    ft = kop.plans.get("vit_fam")
    if ft is None:
        dev = kop.row_pdf.device
        meta = cf.block_fwd_offsets
        Sm, nO = kop.fwd.W.shape[1], len(meta[0])
        span = ov_span(cf)
        cid = np.zeros(0, np.int64)
        cbase = [Sm] * max(1, (kop.ov_hi - kop.ov_lo) // kop.cmax)
        if span is not None:
            ov_lo, nOv, cmax = span
            _, csize = _ov_cand_layout(meta, ov_lo, cmax, ov_lo + nOv * cmax)
            cbase = [csize.get(ov_lo + g * cmax, 0) for g in range(nOv)]
            first, cum = [], {}
            for kind, g0, form, _, _, D in meta[3]:
                first.append(cum.get(g0, 0))
                if kind == "in":
                    cum[g0] = first[-1] + (cmax if form == "win" else D)

            def cid_of(i, desc, shape):
                if desc[0] == "out":
                    return np.full(shape, Sm + nO)
                pos = np.arange(shape[0] if desc[2] == "col" else shape[1])
                return first[i] + (pos[:, None] if desc[2] == "col"
                                   else pos[None, :])

            fdst, fsrc, _, cid = bs._family_terms(cf.block_fwd, meta, cid_of)
            # the id of each of the operator's terms, found by (dst, src):
            # the same order, or a subset of it (a cut copy of the operator)
            Sp = kop.Sp
            key = fdst * Sp + fsrc
            want = (kop.fwd.fam_dst.cpu().numpy() * Sp
                    + kop.fwd.fam_src.cpu().numpy())
            at = np.searchsorted(key, want)
            if not np.array_equal(key[at], want):
                raise ValueError("the operator's family terms are not the "
                                 "graph's")
            cid = cid[at]
        # per row: its terms, its band ids' base, its emission row
        ptr = kop.fwd.fam_ptr.cpu().numpy().astype(np.int64)
        j = np.arange(kop.Sp)
        ov = (j >= kop.ov_lo) & (j < kop.ov_hi)
        z = np.full(kop.Sp, Sm, np.int64)
        z[ov] = np.asarray(cbase, np.int64)[(j[ov] - kop.ov_lo) // kop.cmax]
        frow = np.stack([ptr[:-1], ptr[1:], z, kop.row_pdf.cpu().numpy()], 1)
        ft = FamTables(
            cid=torch.from_numpy((cid if len(cid) else np.zeros(1))
                                 .astype(np.uint8)).to(dev),
            cbase=bs._i32(cbase, dev), frow=bs._i32(frow, dev))
        kop.plans["vit_fam"] = ft
    return ft


def _vlayout(cf, kop) -> np.ndarray:
    """Host int64 array of the family branch's table addresses, read by
    csrc/vit_scan.cu (layout: VitFam)."""
    kd, ft = kop.fwd, fam_tables(cf, kop)
    tables = (kop.row_pdf, kd.fam_ptr, kd.fam_src, kd.fam_w, ft.cid,
              kd.heavy_rows, ft.cbase, ft.frow)
    bs._check("cid", ft.cid, ft.cid.shape, kd.W.device, torch.uint8)
    bs._check("cbase", ft.cbase, ft.cbase.shape, kd.W.device, torch.int32)
    bs._check("frow", ft.frow, (kop.Sp, 4), kd.W.device, torch.int32)
    # an empty table passes an address that is never read
    return np.array([(t if t.numel() else kop.row_pdf).data_ptr()
                     for t in tables], dtype=np.int64)


def _vit_grid(kop, device, B: int, ids: bool = True) -> int:
    """CTAs of K7's (``ids``) or K7n's persistent grid, in the uniform or
    the family instantiation, float32 or float64 (the panels' dtype): as
    many as can be co-resident on the CUDA ``device`` at batch ``B`` (the
    library asks the occupancy API with the dynamic shared memory of that
    batch; cached on ``kop``)."""
    from . import _build

    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    fam = _is_fam(kop)
    f64 = kop.fwd.W.dtype == torch.float64
    key = ("vit_grid", idx, B, ids, fam, f64)
    if key not in kop.plans:
        with torch.cuda.device(idx):
            n = _build.library().mm_vit_ctas(int(B % 4 == 0), int(ids),
                                             int(fam), int(f64), B)
        if n < 0:
            bs._raise_on(-n, "mm_vit_ctas")
        if n == 0:
            raise ValueError("the persistent K7 kernel cannot keep its CTAs "
                             f"co-resident on {device}")
        kop.plans[key] = n
    return kop.plans[key]


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _save_slot(f: int, stride: int) -> int:
    """The slot K7n saves launch frame f in, or -1."""
    return (f + 1) // stride - 1 if (f + 1) % stride == 0 else -1


def _noid_plain(cf, ext, mshift, a0, s0, t0, stride, acc):
    """K7n's twin (see :func:`viterbi_fwd_plain`), and the plain sweep of
    any 'block' graph with a rank-1 ω split: without K7's plan (several
    tiers) nothing is masked, which changes no value (no core arc leaves
    the tail of phony and padding states)."""
    Nf, _, B = ext.shape
    Sp, fin = cf.padded_states, cf.final_state
    RW = _main_region(cf)
    spdf = cf.state_pdf.long()
    om = cf.omega_prob[:, None]
    n_save = Nf // stride
    save = ext.new_empty((n_save, Sp, B))
    save_scale = ext.new_empty((n_save, B))
    acc = ext.new_zeros((3, B)) if acc is None else acc
    grids = family_grids(cf.block_fwd, cf.block_fwd_offsets, ext.device)
    a = a0 * s0[None, :]  # the scaled state the next frame reads
    for f in range(Nf):
        if t0 + f == 0:
            p = a
        else:
            x = a.clone()
            x[RW:] = 0.0  # the kernel's tier and bands read [0, RW) only
            y = block_matvec(cf.block_fwd, cf.block_fwd_offsets, x,
                             op_kind="max", grids=grids)
            p = torch.zeros_like(a)
            p[:RW] = y[:RW]
            p[fin] = (om * a).amax(dim=0)  # the rank-1 ω arcs
        u = p * ext[f].index_select(0, spdf)
        k = bs._pow2_exponent(u.amax(dim=0))
        sc = bs._pow2_scale(k)
        a = u * sc[None, :]
        slot = _save_slot(f, stride)
        if slot >= 0:
            save[slot], save_scale[slot] = u, sc
        bs._kahan_step(acc, k, mshift[f, 0])
    return save, save_scale, u, sc, acc


def viterbi_fwd_plain(cf, ext, mshift, *, ids: bool = True, a0=None,
                      s0=None, t0: int = 0, stride: int = 1, acc=None):
    """Plain twin of K7 (``ids``) and of K7n.  ``ext`` / ``mshift`` from
    ops.emissions.prepare_emissions ((Nf, P1, B) / (Nf, 1, B)).

    K7 returns (bps (Nf, R·W, B) uint8, fins (Nf, B) int32, vfin (B,),
    shift (B,), ksum (B,)); the best-path score is log(vfin) + ksum·ln2 +
    shift.  The ids are ``block_matvec_max_arg``'s, the overflow families
    included (``ov_span``); the ω argmax runs over every row.  It is also
    the CPU route of the compressed-backpointer decode for any graph that
    decode admits: without K7's plan R·W is Sp.

    K7n (``ids=False``) runs global frames t0 .. t0 + Nf - 1 (frame 0
    skips the product only where t0 is 0) from ``a0`` (Sp, B) unscaled
    with the scale ``s0`` (B,) (by default the initial probabilities with
    scale 1), and saves frame f, unscaled with its phony row, when
    (f + 1) % ``stride`` == 0, in slot (f + 1) // stride - 1.  ``acc``
    (3, B): ksum, shift and its Kahan compensation, carried on in place
    (zeros when None).  Returns (save (Nf // stride, Sp, B), save_scale
    (Nf // stride, B), a_last (Sp, B) unscaled, s_last (B,), acc): the
    score is log(a_last[fin]·s_last) + ksum·ln2 + shift, the same final
    value, scale, ksum and shift as K7 from the same start."""
    if not ids:
        if a0 is None:
            a0 = torch.exp(cf.alpha_hat)[:, None].expand(
                cf.padded_states, ext.shape[2])
        s0 = torch.ones_like(ext[0, 0]) if s0 is None else s0
        return _noid_plain(cf, ext, mshift, a0, s0, t0, stride, acc)
    Nf, _, B = ext.shape
    RW = _main_region(cf)
    Sp, fin = cf.padded_states, cf.final_state
    spdf = cf.state_pdf.long()
    span = ov_span(cf)
    om = cf.omega_prob[:, None]
    a = torch.exp(cf.alpha_hat)[:, None].expand(Sp, B)  # scale 1
    flat = torch.arange(Sp, dtype=torch.int32, device=ext.device)[:, None]
    bps = torch.empty((Nf, RW, B), dtype=torch.uint8, device=ext.device)
    fins = torch.empty((Nf, B), dtype=torch.int32, device=ext.device)
    ksum, shift, comp = (ext.new_zeros(B) for _ in range(3))
    grids = family_grids(cf.block_fwd, cf.block_fwd_offsets, ext.device)
    for t in range(Nf):
        # rank-1 ω arcs into the phony state: value and smallest argmax
        omc = om * a
        fin_v = omc.amax(dim=0)
        fins[t] = torch.where(omc == fin_v, flat, Sp).amin(dim=0)
        x = a.clone()
        x[RW:] = 0.0  # the tier and the bands read the main region only
        y, cand = block_matvec_max_arg(cf.block_fwd, cf.block_fwd_offsets, x,
                                       ov_span=span, grids=grids)
        bps[t] = cand[:RW].to(torch.uint8)
        if t == 0:
            p = a
        else:
            p = torch.zeros_like(a)
            p[:RW] = y[:RW]
            p[fin] = fin_v
        u = p * ext[t].index_select(0, spdf)
        k = bs._pow2_exponent(u.amax(dim=0))
        a = u * bs._pow2_scale(k)[None, :]
        ksum = ksum + k
        # Kahan-compensated accumulation of the factored emission shift
        xc = mshift[t, 0] - comp
        tsum = shift + xc
        comp = (tsum - shift) - xc
        shift = tsum
    return bps, fins, a[fin], shift, ksum


class WalkTables(NamedTuple):
    """Decode tables of the backtrace, built once per graph."""

    k_of: torch.Tensor  # (Sp,) int32 tier block writing each state, -1
    sidx: torch.Tensor  # (K·Sm,) int32 tier source of (k, position)
    offs: torch.Tensor  # (max(nO, 1),) int32 band offsets
    # overflow families: the source of (overflow row ov_lo + u, id c) at
    # ov_dec[u, c], -1 for none ((1, 256) of -1 without families), and the
    # out-family source of each core row, -1 for none
    ov_dec: torch.Tensor  # (nOv·cmax, 256) int32
    ovout: torch.Tensor  # (Sp,) int32
    K: int
    Sm: int
    nO: int
    fin: int
    ov_lo: int  # the overflow rows [ov_lo, ov_hi) of a graph with
    ov_hi: int  # families (Sp, Sp: none)
    # k_of clamped to [0, K - 1] and narrowed as the kernel stages it in
    # shared memory: uint8 where K <= 256, else uint16 (its bits in an
    # int16 tensor) where K <= 65,536, else int32
    kt: torch.Tensor


def _ov_decode_tables(cf, Sp: int):
    """(ov_dec, ovout) as numpy int32, built as the JAX package builds them
    (``viterbi.py:265-310``): an overflow row's band ids C_g + oi decode
    to row - offset (-1 outside [0, Sp)), a column family's id cum + r to
    base + r·stride + lane, a window's cum + j to base + lane·stride + j;
    every other entry is -1.  ``ovout`` maps each destination of an
    out-family to its source lane."""
    ov_lo, nOv, cmax = ov_span(cf)
    meta = cf.block_fwd_offsets
    fam, csize = _ov_cand_layout(meta, ov_lo, cmax, ov_lo + nOv * cmax)
    band = np.asarray(meta[0], dtype=np.int64)
    lanes = np.arange(cmax)
    dec = np.full((nOv * cmax, 256), -1, dtype=np.int64)
    for gi in range(nOv):
        g0 = ov_lo + gi * cmax
        C = csize.get(g0, 0)
        rows = gi * cmax + lanes
        for oi, off in enumerate(band):
            srcs = (g0 + lanes) - off
            dec[rows, C + oi] = np.where((srcs >= 0) & (srcs < Sp), srcs, -1)
        for desc, cum in fam.get(g0, []):
            _, _, form, base, stride, D = desc
            if form == "win":
                dec[rows[:, None], cum + lanes[None, :]] = (
                    base + lanes[:, None] * stride + lanes[None, :])
            else:
                dec[rows[:, None], cum + np.arange(D)[None, :]] = (
                    base + np.arange(D)[None, :] * stride + lanes[:, None])
    oo = np.full(Sp, -1, dtype=np.int64)
    for desc in meta[3]:
        if desc[0] == "out":
            grid = family_grid(desc, cmax)
            lane = lanes[None, :] if desc[2] == "col" else lanes[:, None]
            oo[grid.ravel()] = np.broadcast_to(desc[1] + lane,
                                               grid.shape).ravel()
    return dec.astype(np.int32), oo.astype(np.int32)


def _narrow_k(k_of: np.ndarray, K: int) -> np.ndarray:
    """k_of clamped to [0, K - 1] (a state no tier block writes, -1, reads
    block 0, as the walk's ``max(k_of, 0)`` does), then narrowed: uint8
    for K <= 256, uint16 for K <= 65,536 (as int16, which torch stores),
    else int32."""
    k = np.clip(k_of, 0, K - 1)
    if K <= 256:
        return k.astype(np.uint8)
    if K <= 65536:
        return k.astype(np.uint16).view(np.int16)
    return k.astype(np.int32)


def walk_tables(cf) -> WalkTables:
    """The walk's decode tables for a graph the compressed-backpointer
    decode admits (cached on it)."""
    wt = cf._cache.get("vit_walk")
    if wt is None:
        dev = cf.alpha_hat.device
        Sp = cf.padded_states
        sidx = cf.block_fwd.tiers[0][0]
        K, Sm = sidx.shape
        offs = np.asarray(cf.block_fwd_offsets[0], dtype=np.int32)
        nO = len(offs)
        span = ov_span(cf)
        if span is None:
            ov_lo = ov_hi = Sp
            dec = np.full((1, 256), -1, np.int32)
            oo = np.full(Sp, -1, np.int32)
        else:
            ov_lo = span[0]
            ov_hi = ov_lo + span[1] * span[2]
            dec, oo = _ov_decode_tables(cf, Sp)
        k_of = tier_dst_inverse(cf.block_fwd, Sp)
        wt = WalkTables(
            k_of=torch.from_numpy(k_of).to(dev),
            sidx=sidx.reshape(-1).to(device=dev, dtype=torch.int32)
            .contiguous(),
            offs=torch.from_numpy(offs if nO else np.zeros(1, np.int32))
            .to(dev),
            ov_dec=torch.from_numpy(dec).to(dev),
            ovout=torch.from_numpy(oo).to(dev),
            K=K, Sm=Sm, nO=nO, fin=int(cf.final_state), ov_lo=ov_lo,
            ov_hi=ov_hi, kt=torch.from_numpy(_narrow_k(k_of, K)).to(dev),
        )
        cf._cache["vit_walk"] = wt
    return wt


def walk_plain(wt: WalkTables, bps, fins, lengths):
    """Plain twin of the walk.  From the phony final state at frame Nf-1
    back to frame 1: decode the id c of the current state s (255 outside
    the main region) to its source.  A core row: c < Sm the tier source,
    then the band offsets, Sm + nO the out-family source (``ovout``); an
    overflow row [ov_lo, ov_hi): ``ov_dec``.  Any id without a source (255,
    a stray Sm + nO, an overflow row's id past C_g + nO) decodes to the
    phony state fin.  At t == length the source is the frame's ω argmax,
    past the length the phony state.  Returns (Nf-1, B) int32 states in
    compiled numbering (frame t-1's state at row t-1)."""
    Nf, RW, B = bps.shape
    Sp = wt.k_of.shape[0]
    L = lengths.long()
    bcol = torch.arange(B, device=bps.device)
    s = torch.full((B,), wt.fin, dtype=torch.long, device=bps.device)
    states = torch.empty((Nf - 1, B), dtype=torch.int32, device=bps.device)
    n_dec = wt.ov_dec.shape[0]
    for t in range(Nf - 1, 0, -1):
        c = bps[t][s.clamp(max=RW - 1), bcol].long()
        c = torch.where(s < RW, c, _NO_CAND)
        k = wt.k_of[s.clamp(0, Sp - 1)].long().clamp(0, wt.K - 1)
        tier_src = wt.sidx[k * wt.Sm + c.clamp(0, wt.Sm - 1)].long()
        band_src = s - wt.offs[(c - wt.Sm).clamp(0, len(wt.offs) - 1)].long()
        src = torch.where(c < wt.Sm, tier_src, band_src)
        oo = wt.ovout[s.clamp(0, Sp - 1)].long()
        src = torch.where(c == wt.Sm + wt.nO,
                          torch.where(oo >= 0, oo, wt.fin), src)
        od = wt.ov_dec[(s - wt.ov_lo).clamp(0, n_dec - 1), c].long()
        ov = (s >= wt.ov_lo) & (s < wt.ov_hi)
        src = torch.where(ov, torch.where(od >= 0, od, wt.fin), src)
        src = torch.where(c == _NO_CAND, wt.fin, src)
        s = torch.where(t == L, fins[t].long(), src)
        s = torch.where(t > L, wt.fin, s)
        states[t - 1] = s
    return states


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def viterbi_fwd(cf, ext, mshift, *, ids: bool = True, a0=None, s0=None,
                t0: int = 0, stride: int = 1, acc=None):
    """K7 (``ids``) or K7n: the fused tropical sweep over all Nf frames of
    ``ext``, one cooperative launch.  Same inputs and outputs as
    :func:`viterbi_fwd_plain`.  A ``precision='bf16'`` graph decodes with
    its float32 panels, exactly as a 'high' one: the TPU K7 ignores the
    precision (``pallas_block.py:1169``); a float64 graph takes the
    float64 instantiation."""
    kw = dict(a0=a0, s0=s0, t0=t0, stride=stride, acc=acc)
    if not bs._route(ext, "Viterbi-sweep"):
        return viterbi_fwd_plain(cf, ext, mshift, ids=ids, **kw)
    if not ids:
        return _noid_fwd(cf, ext, mshift, **kw)
    from . import _build

    Nf, P1, B = ext.shape
    dev = ext.device
    _check_graph(cf, B, Nf - 1, dev)
    vdt = _vit_dtype(cf)
    f64 = vdt == torch.float64
    _check_batch(B, True, bool(cf.ov_layout), f64)
    kop = bs.kernel_operator(cf, vdt)  # f32 panels on any float32 graph
    Sp, RW = kop.Sp, _main_region(cf)
    bs._check_op(kop, kop.fwd, dev, vdt)
    bs._check("ext", ext, (Nf, kop.P1, B), dev, vdt)
    bs._check("mshift", mshift, (Nf, 1, B), dev, vdt)
    meta, lay = bs._imeta(kop, kop.fwd), _vlayout(cf, kop)
    pl, Wt = vit_plan(kop, B, packed=not f64), _panels_t(kop)
    G = _vit_grid(kop, dev, B)
    a0 = kop.alpha0[:, None].expand(Sp, B).contiguous()
    bps = torch.empty((Nf, RW, B), dtype=torch.uint8, device=dev)
    fins = torch.empty((Nf, B), dtype=torch.int32, device=dev)
    work = torch.empty((2, Sp, B), device=dev, dtype=vdt)
    scale, ksum, shift, comp = (torch.zeros(B, device=dev, dtype=vdt)
                                for _ in range(4))
    # zeroed scratch, carved by the library (int64 words: 8-byte aligned)
    n_scratch = layout(B, Nf - 1, f64)[0]
    scratch = torch.zeros(-(-n_scratch // 8), dtype=torch.int64, device=dev)
    kd = kop.fwd
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_vit_fwd(
            bs._p(a0), bs._p(ext), bs._p(mshift), bs._p(kd.band_w),
            bs._p(Wt), bs._p(kop.omega), bs._p(kd.band_rows),
            ctypes.c_void_p(meta.ctypes.data),
            ctypes.c_void_p(lay.ctypes.data), bs._p(pl.queue),
            pl.queue.shape[0], G, B, Nf, RW, int(f64), bs._p(work),
            bs._p(bps), bs._p(fins), bs._p(scale), bs._p(ksum),
            bs._p(shift), bs._p(comp), bs._p(scratch), n_scratch,
            bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_fwd")
    _counts(f64)["vit_fwd"] += 1
    LAUNCHES_FAM["vit_fwd"] += _is_fam(kop)
    vfin = work[(Nf - 1) % 2, kop.fin] * scale
    return bps, fins, vfin, shift, ksum


def _noid_fwd(cf, ext, mshift, *, a0, s0, t0, stride, acc):
    """K7n on CUDA tensors (:func:`viterbi_fwd` with ``ids=False``)."""
    from . import _build

    if t0 < 0 or stride < 1:
        raise ValueError(f"t0 {t0}, stride {stride}: need t0 >= 0, "
                         "stride >= 1")
    Nf, P1, B = ext.shape
    dev = ext.device
    n_save = Nf // stride
    _check_graph(cf, B, Nf - 1, dev, saved=n_save)
    vdt = _vit_dtype(cf)
    f64 = vdt == torch.float64
    _check_batch(B, False, bool(cf.ov_layout), f64)
    kop = bs.kernel_operator(cf, vdt)
    Sp, RW = kop.Sp, _main_region(cf)
    bs._check_op(kop, kop.fwd, dev, vdt)
    bs._check("ext", ext, (Nf, kop.P1, B), dev, vdt)
    bs._check("mshift", mshift, (Nf, 1, B), dev, vdt)
    if a0 is None:
        a0 = kop.alpha0[:, None].expand(Sp, B).contiguous()
    s0 = torch.ones(B, device=dev, dtype=vdt) if s0 is None else s0
    acc = torch.zeros((3, B), device=dev, dtype=vdt) if acc is None else acc
    bs._check("a0", a0, (Sp, B), dev, vdt)
    bs._check("s0", s0, (B,), dev, vdt)
    bs._check("acc", acc, (3, B), dev, vdt)
    meta, lay = bs._imeta(kop, kop.fwd), _vlayout(cf, kop)
    pl = vit_plan(kop, B, packed=not f64)
    Wt = kop.fwd.W  # (K, Sm, D) as it is, checked by _check_op
    G = _vit_grid(kop, dev, B, ids=False)
    save = torch.empty((n_save, Sp, B), device=dev, dtype=vdt)
    save_scale = torch.empty((n_save, B), device=dev, dtype=vdt)
    work = (torch.empty((2, Sp, B), device=dev, dtype=vdt) if stride > 1
            else None)
    scale = torch.zeros(B, device=dev, dtype=vdt)
    n_scratch = layout(B, Nf - 1, f64)[0]
    scratch = torch.zeros(-(-n_scratch // 8), dtype=torch.int64, device=dev)
    kd = kop.fwd
    ptr = lambda t: None if t is None else bs._p(t)
    with torch.cuda.device(dev):
        rc = _build.library().mm_vit_fwd_noid(
            bs._p(a0), bs._p(s0), bs._p(ext), bs._p(mshift),
            bs._p(kd.band_w), bs._p(Wt), bs._p(kop.omega),
            bs._p(kd.band_rows), ctypes.c_void_p(meta.ctypes.data),
            ctypes.c_void_p(lay.ctypes.data), bs._p(pl.queue),
            pl.queue.shape[0], G, B, Nf, RW, t0, stride, int(f64),
            ptr(work), ptr(save), ptr(save_scale), n_save, bs._p(scale),
            bs._p(acc[0]), bs._p(acc[1]), bs._p(acc[2]), bs._p(scratch),
            n_scratch, bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_fwd_noid")
    _counts(f64)["vit_fwd_noid"] += 1
    LAUNCHES_FAM["vit_fwd_noid"] += _is_fam(kop)
    a_last = save[Nf - 1] if stride == 1 else work[(Nf - 1) % 2]
    return save, save_scale, a_last, scale, acc


def walk(wt: WalkTables, bps, fins, lengths):
    """The backtrace walk, one CUDA thread per sequence.  Same inputs and
    output as :func:`walk_plain`; ``lengths`` (B,) int32."""
    if not bs._route(bps, "Viterbi-walk"):
        return walk_plain(wt, bps, fins, lengths)
    from . import _build

    Nf, RW, B = bps.shape
    dev = bps.device
    bs._check("bps", bps, (Nf, RW, B), dev, torch.uint8)
    bs._check("fins", fins, (Nf, B), dev, torch.int32)
    bs._check("lengths", lengths, (B,), dev, torch.int32)
    for name, t in (("k_of", wt.k_of), ("sidx", wt.sidx), ("offs", wt.offs),
                    ("ov_dec", wt.ov_dec), ("ovout", wt.ovout)):
        bs._check(name, t, t.shape, dev, torch.int32)
    Sp = wt.k_of.shape[0]
    if wt.ov_dec.shape[1] != 256 or wt.ovout.shape != (Sp,):
        raise ValueError(f"ov_dec {tuple(wt.ov_dec.shape)}, ovout "
                         f"{tuple(wt.ovout.shape)} for {Sp} states")
    kb = _narrow_k(np.zeros(0, np.int32), wt.K).itemsize
    bs._check("kt", wt.kt, (Sp,), dev,
              {1: torch.uint8, 2: torch.int16, 4: torch.int32}[kb])
    states = torch.empty((Nf - 1, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_vit_walk(
            bs._p(bps), bs._p(fins), bs._p(lengths), bs._p(wt.kt),
            bs._p(wt.sidx), bs._p(wt.offs), bs._p(wt.ov_dec),
            bs._p(wt.ovout), Nf, RW, B, Sp, wt.K, wt.Sm, wt.nO, wt.fin,
            wt.ov_lo, wt.ov_hi, wt.ov_dec.shape[0], kb, bs._p(states),
            bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_walk")
    LAUNCHES["vit_walk"] += 1
    return states


# ---------------------------------------------------------------------------
# W2: the walk of the chunk-recompute decode
# ---------------------------------------------------------------------------

class RecWalkTables(NamedTuple):
    """The in-arc lists the recompute walk reads, built once per graph
    (the JAX package's ``_viterbi_scale``, ``viterbi.py:445-471``)."""

    rowptr: torch.Tensor  # (Sp + 1,) int32 over the dst-sorted edges
    src: torch.Tensor  # (E,) int32 source of each edge
    w: torch.Tensor  # (E,) log weight of each edge, in the graph's dtype
    omega: torch.Tensor  # (Sp,) probabilities of the arcs into fin
    dmax: int  # in-arcs a state takes: the largest in-degree but fin's
    fin: int
    # W2's packed forms (:func:`_w2_tables`; built from the fields above
    # where None): each edge's (src, w) record, each state's (begin, count
    # <= dmax) pair in them (count 0 for fin), and the (state, omega)
    # records of the states with omega != 0, in ascending order
    rec: torch.Tensor | None = None  # (E, 2) int32; float64: (E, 4)
    rows: torch.Tensor | None = None  # (Sp, 2) int32
    sup: torch.Tensor | None = None  # (nS, 2) int32; float64: (nS, 4)


def rec_walk_tables(cf) -> RecWalkTables:
    """The walk's tables of a 'dense' or 'block' graph (cached on it).
    Dmax leaves out the phony final state (its in-arcs are the ω arcs,
    taken at t = L - 1 from ``omega``) and row Sp - 1 (where the padding
    edges park); ``omega`` is the rank-1 ω column of a 'block' graph and
    the phony row of the probability operator of a 'dense' one."""
    wt = cf._cache.get("rec_walk")
    if wt is None:
        Sp, fin = cf.padded_states, int(cf.final_state)
        dst = cf.fwd_dst.cpu().numpy()
        rowptr = np.searchsorted(dst, np.arange(Sp + 1)).astype(np.int32)
        indeg = np.diff(rowptr)
        indeg[fin] = 0
        indeg[Sp - 1] = 0
        if cf.strategy == "dense":
            omega = torch.exp(cf.dense_fwd_max[fin]) * cf.dense_fwd_exp[fin]
        else:
            omega = cf.omega_prob
        dev, dt = cf.alpha_hat.device, cf.alpha_hat.dtype
        wt = RecWalkTables(
            rowptr=torch.from_numpy(rowptr).to(dev),
            src=cf.fwd_src.to(device=dev, dtype=torch.int32).contiguous(),
            w=cf.fwd_w.to(device=dev, dtype=dt).contiguous(),
            omega=omega.to(dt).contiguous(),
            dmax=max(int(indeg.max()), 1), fin=fin)
        wt = wt._replace(**_w2_tables(wt))
        cf._cache["rec_walk"] = wt
    return wt


def _records(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """W2's packed records: (n, 2) int32 rows (index, the float32 value's
    bits), or for float64 values (n, 4) rows (index, 0, the value's low
    and high words), as ``csrc/rec_walk.cu`` load_rec reads them."""
    n = idx.shape[0]
    if val.dtype == torch.float64:
        out = torch.zeros((n, 4), dtype=torch.int32, device=idx.device)
        out[:, 2:] = val.contiguous().view(torch.int32).view(n, 2)
    else:
        out = torch.empty((n, 2), dtype=torch.int32, device=idx.device)
        out[:, 1] = val.contiguous().view(torch.int32)
    out[:, 0] = idx
    return out


def _w2_tables(wt: RecWalkTables) -> dict:
    """The packed tables W2 reads (``rec``, ``rows``, ``sup``) from the
    plain ones: per state the begin of its in-arcs and their count
    min(in-degree, dmax), 0 for fin (what ``rec_walk_plain`` reads from
    ``rowptr``); the ω support in ascending state order."""
    rowptr = wt.rowptr.long()
    cnt = (rowptr[1:] - rowptr[:-1]).clamp(max=wt.dmax)
    cnt[wt.fin] = 0
    rows = torch.stack([rowptr[:-1], cnt], dim=1).to(torch.int32)
    sj = torch.nonzero(wt.omega != 0)[:, 0].to(torch.int32)
    return dict(rec=_records(wt.src, wt.w), rows=rows.contiguous(),
                sup=_records(sj, wt.omega[sj.long()]))


def rec_walk_plain(wt: RecWalkTables, states, scales, lengths, t0: int,
                   s_next):
    """Plain twin of W2: the states of frames t0 .. t0 + nK - 1 from the
    chunk's unscaled alphas ``states`` (nK, Sp, B) with their ``scales``
    (nK, B), walking back from ``s_next`` (B,), the states of frame
    t0 + nK.  Per frame (s the state of t + 1): the best of the first Dmax
    in-arcs of s by log(α·scale) + w (the scale before the log, as the JAX
    package's scaled α), ties to the largest position, the phony state
    where all are -inf (or s is it); at t = L - 1 the argmax of
    (α·scale)·ω over all states, ties to the largest; past the length the
    phony state.  Returns (nK, B) int32 in compiled numbering."""
    nK, Sp, B = states.shape
    E = wt.src.shape[0]
    dev = states.device
    L = lengths.long()
    bcol = torch.arange(B, device=dev)[:, None]
    offs = torch.arange(wt.dmax, device=dev)
    out = torch.empty((nK, B), dtype=torch.int32, device=dev)
    s = s_next.long()
    rowptr = wt.rowptr.long()
    last_t = set((L - 1).tolist())  # one host read, not one per frame
    for i in reversed(range(nK)):
        t = t0 + i
        a = states[i] * scales[i][None, :]
        rp = rowptr[s]
        cnt = torch.where(s == wt.fin, 0, rowptr[s + 1] - rp)
        eidx = (rp[:, None] + offs[None, :]).clamp(max=E - 1)
        src = wt.src[eidx].long()  # (B, Dmax)
        av = a[src, bcol]
        valid = (offs[None, :] < cnt[:, None]) & (av > 0)
        cand = torch.where(valid, torch.log(av) + wt.w[eidx],
                           torch.full_like(av, -float("inf")))
        best = wt.dmax - 1 - cand.flip(1).argmax(dim=1)
        st = src.gather(1, best[:, None])[:, 0]
        st = torch.where(cand.amax(dim=1) == -float("inf"), wt.fin, st)
        last = t == L - 1
        if t in last_t:
            oc = a * wt.omega[:, None]
            st = torch.where(last, Sp - 1 - oc.flip(0).argmax(dim=0), st)
        st = torch.where(t >= L, wt.fin, st)
        out[i] = st
        s = st
    return out


def rec_walk(wt: RecWalkTables, states, scales, lengths, t0: int, s_next):
    """W2: the walk of one chunk, one CUDA warp per sequence.  Same inputs
    and output as :func:`rec_walk_plain`; ``lengths`` and ``s_next`` (B,)
    int32; the states, scales and tables float32, or float64 (the float64
    instantiation) for a float64 graph's."""
    if not bs._route(states, "recompute-walk"):
        return rec_walk_plain(wt, states, scales, lengths, t0, s_next)
    from . import _build

    nK, Sp, B = states.shape
    dev = states.device
    vdt = wt.w.dtype
    if vdt not in (torch.float32, torch.float64):
        raise ValueError(f"w: dtype {vdt} (W2 takes float32 or float64)")
    f64 = vdt == torch.float64
    bs._check("states", states, (nK, Sp, B), dev, vdt)
    bs._check("scales", scales, (nK, B), dev, vdt)
    for name, t in (("lengths", lengths), ("s_next", s_next)):
        bs._check(name, t, (B,), dev, torch.int32)
    for name, t in (("rowptr", wt.rowptr), ("src", wt.src)):
        bs._check(name, t, t.shape, dev, torch.int32)
    bs._check("w", wt.w, wt.src.shape, dev, vdt)
    bs._check("omega", wt.omega, (Sp,), dev, vdt)
    if wt.rowptr.shape != (Sp + 1,) or t0 < 0:
        raise ValueError(f"rowptr {tuple(wt.rowptr.shape)} for {Sp} states, "
                         f"t0 {t0}")
    if wt.rec is None:  # tables made by hand: pack them here
        wt = wt._replace(**_w2_tables(wt))
    nw = 4 if f64 else 2
    bs._check("rec", wt.rec, (wt.src.shape[0], nw), dev, torch.int32)
    bs._check("rows", wt.rows, (Sp, 2), dev, torch.int32)
    bs._check("sup", wt.sup, (wt.sup.shape[0], nw), dev, torch.int32)
    out = torch.empty((nK, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_rec_walk(
            bs._p(states), bs._p(scales), bs._p(lengths), bs._p(wt.rows),
            bs._p(wt.rec), bs._p(wt.sup), wt.sup.shape[0], bs._p(wt.omega),
            nK, t0, Sp, B, wt.dmax, wt.fin, int(f64), bs._p(s_next),
            bs._p(out), bs._stream(dev),
        )
    bs._raise_on(rc, "mm_rec_walk")
    _counts(f64)["rec_walk"] += 1
    return out
