"""Blocked gather-matmul-scatter (GMS) operator for large sparse graphs.

PyTorch counterpart of ``markovmodels_tpu/ops/blocked.py``.  The lowering
itself is host numpy and mirrors the JAX package line for line, so both
packages build bit-identical operators from the same edge list:

* a **band** part: edge offsets (dst - src) shared by many states (HMM
  self-loops and chain arcs in the plane-major layout), applied as shifted
  elementwise multiply-adds;
* a **blocked** part: destinations tiled into blocks of 128, each block's
  union of sources gathered into a dense (Smax, 128) weight panel, so the
  update is a batched matrix product;
* a **residue**: edges of blocks with too many distinct sources, applied
  as a plain scatter-add.

Weights are stored as probabilities.  Overflow families (the capped
pdf-grouped layout of a separate-state backoff graph) are not ported yet:
``compile_fsm`` raises ``NotImplementedError`` before reaching them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "BlockOperator",
    "build_block_operator",
    "block_matvec",
]


class BlockOperator(NamedTuple):
    """Edge-set parts as tensors; the static metadata (band offsets, tier
    descriptors, band extent) travels beside it as plain Python tuples."""

    band_w: Optional[torch.Tensor]  # (nOffsets, Sp) probabilities
    tiers: tuple  # of (src_idx (K, Sm), dst_idx (K, D), W (K, Sm, D))
    res_src: Optional[torch.Tensor]  # (R,)
    res_dst: Optional[torch.Tensor]
    res_w: Optional[torch.Tensor]
    ov_w: tuple = ()

    def to(self, device) -> "BlockOperator":
        mv = lambda t: None if t is None else t.to(device)
        return BlockOperator(
            band_w=mv(self.band_w),
            tiers=tuple(tuple(mv(x) for x in t) for t in self.tiers),
            res_src=mv(self.res_src),
            res_dst=mv(self.res_dst),
            res_w=mv(self.res_w),
            ov_w=tuple(mv(w) for w in self.ov_w),
        )


def _affine_params(idx: np.ndarray):
    """Return (base, dk, dm) if idx[k, m] == base + k*dk + m*dm, else None."""
    K, M = idx.shape
    base = int(idx[0, 0])
    dk = int(idx[1, 0] - idx[0, 0]) if K > 1 else 1
    dm = int(idx[0, 1] - idx[0, 0]) if M > 1 else 1
    expect = base + np.arange(K)[:, None] * dk + np.arange(M)[None, :] * dm
    return (base, dk, dm) if np.array_equal(idx, expect) else None


def _window(base, rows, stride, width, limit):
    """Fit the strided view x[base' : base' + rows*stride].reshape(rows,
    stride)[:, col0:col0+width] inside [0, limit): returns (base', col0) or
    None.  col0 shifts the window left when the naive view would overrun."""
    col0 = max(0, base + rows * stride - limit)
    base2 = base - col0
    if base2 >= 0 and col0 + width <= stride and base2 + rows * stride <= limit:
        return base2, col0
    return None


def _gather_desc(idx: np.ndarray, limit: int):
    """Classify a (K, Sm) gather index pattern:
      ('affine_k_major', base, dk, col0)  view (K, dk)[:, col0:col0+Sm]
      ('affine_s_major', base, ds, col0)  view (Sm, ds)[:, col0:col0+K] swap
      ('diag', base, dm)                  K == 1, arbitrary stride
      ('gather',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dm = p
        K, Sm = idx.shape
        if dm == 1 and dk >= Sm and base >= 0:
            w = _window(base, K, dk, Sm, limit)
            if w is not None:
                return ("affine_k_major", w[0], dk, w[1])
        if dk == 1 and dm >= K and base >= 0:
            w = _window(base, Sm, dm, K, limit)
            if w is not None:
                return ("affine_s_major", w[0], dm, w[1])
        if K == 1 and dm > 1 and base >= 0 and base + (Sm - 1) * dm < limit:
            return ("diag", base, dm)
    return ("gather",)


def _scatter_desc(idx: np.ndarray, limit: int):
    """Classify a (K, D) scatter index pattern:
      ('contig', base)                  idx = base + k*D + d
      ('affine_d', base)                idx = base + k + d*K
      ('affine_k_pad', base, dk, col0)  view (K, dk)[:, col0:+D]
      ('affine_d_pad', base, dd, col0)  view (D, dd)[:, col0:+K] swap
      ('diag', base, dd)                K == 1, arbitrary stride
      ('scatter',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dd = p
        K, D = idx.shape
        if dk == D and dd == 1 and 0 <= base and base + K * D <= limit:
            return ("contig", base)
        if dk == 1 and dd == K and 0 <= base and base + D * K <= limit:
            return ("affine_d", base)
        if dd == 1 and dk > D and base >= 0:
            w = _window(base, K, dk, D, limit)
            if w is not None:
                return ("affine_k_pad", w[0], dk, w[1])
        if dk == 1 and dd > K and base >= 0:
            w = _window(base, D, dd, K, limit)
            if w is not None:
                return ("affine_d_pad", w[0], dd, w[1])
        if K == 1 and dd > 1 and base >= 0 and base + (D - 1) * dd < limit:
            return ("diag", base, dd)
    return ("scatter",)


_BLOCK = 128  # destination (or source) block width of the tiers
_TIER_SIZES = (128, 256, 512)  # panel heights a block's source set may take
_BAND_MAX = 8  # most shared offsets kept as bands


def build_block_operator(src, dst, w_log, num_states: int):
    """Build (BlockOperator, meta) from a COO edge list of T̂, with
    meta = (band_offsets, tier_descs, band_nz_hi, ov_descs), float32
    weights, and the JAX package's default block, tier and band sizes.

    ``w_log``: log-domain weights; stored as exp().  ``num_states``: padded
    state count Sp (multiple of 128).
    """
    block, tier_sizes, band_max = _BLOCK, _TIER_SIZES, _BAND_MAX
    dtype = np.float32
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.exp(np.asarray(w_log, dtype=np.float64)).astype(dtype)
    Sp = num_states
    assert Sp % block == 0

    # --- band extraction ------------------------------------------------
    offs = dst - src
    uniq, counts = np.unique(offs, return_counts=True)
    thresh = max(Sp // 8, 64)
    cand = uniq[counts >= thresh]
    if len(cand) > band_max:
        cand = cand[np.argsort(-counts[np.isin(uniq, cand)])][:band_max]
    band_offsets = tuple(int(o) for o in sorted(cand))
    in_band = np.isin(offs, cand) if band_offsets else np.zeros(len(offs), bool)

    band_w = None
    if band_offsets:
        band_w = np.zeros((len(band_offsets), Sp), dtype=dtype)
        omap = {o: i for i, o in enumerate(band_offsets)}
        bo = offs[in_band]
        bd = dst[in_band]
        bw = w[in_band]
        oi = np.array([omap[int(o)] for o in bo], dtype=np.int64)
        band_w[oi, bd] = bw

    src, dst, w = src[~in_band], dst[~in_band], w[~in_band]

    # --- blocked part ---------------------------------------------------
    def pad_unique(u, size):
        """Pad a sorted unique index list to ``size`` entries, continuing an
        affine stride with zero-weight slots when possible (keeps near-affine
        blocks on the affine descriptors), else zero padding."""
        out = np.zeros(size, dtype=np.int64)
        out[: len(u)] = u
        pad = size - len(u)
        if pad and len(u) >= 2:
            d = np.diff(u)
            if (d == d[0]).all() and d[0] > 0:
                ext = u[-1] + d[0] * np.arange(1, pad + 1)
                if ext[-1] < Sp:
                    out[len(u):] = ext
        return out

    def group(src, dst, w, by):
        """Tile edges into 128-wide blocks along ``by`` ('dst' grouped:
        dense (tier_srcs x block) panels; 'src' grouped: (block x tier_dsts)).
        Returns ({tier: [(sidx, didx, W)]}, overflow edges)."""
        key = dst if by == "dst" else src
        other = src if by == "dst" else dst
        order = np.lexsort((other, key))
        s, d, ww, kk, oo = (
            src[order], dst[order], w[order], key[order] // block,
            other[order],
        )
        acc = {}
        over = []
        starts = np.searchsorted(kk, np.arange(Sp // block))
        ends = np.searchsorted(kk, np.arange(Sp // block) + 1)
        for b in range(Sp // block):
            lo, hi = starts[b], ends[b]
            if lo == hi:
                continue
            uoth = np.unique(oo[lo:hi])
            # affine gap-fill onto the minimal grid anchored at the residue
            # class, only while it stays within the raw set's tier size
            if len(uoth) >= 2:
                du = np.diff(uoth)
                g = int(np.gcd.reduce(du))
                tier0 = next(
                    (t for t in tier_sizes if len(uoth) <= t), None
                )
                if g > 0 and tier0 is not None:
                    start = int(uoth[0]) % g
                    span = (int(uoth[-1]) - start) // g + 1
                    if span > len(uoth) and span <= tier0:
                        uoth = start + g * np.arange(span, dtype=np.int64)
            tier = next((t for t in tier_sizes if len(uoth) <= t), None)
            if tier is None:
                over.append((s[lo:hi], d[lo:hi], ww[lo:hi]))
                continue
            pos = np.searchsorted(uoth, oo[lo:hi])
            inblk = (key[order][lo:hi] - b * block).astype(np.int64)
            pad = tier - len(uoth)
            if pad and len(uoth) >= 2:
                du = np.diff(uoth)
                affine = (du == du[0]).all() and du[0] > 0
                if affine and uoth[-1] + du[0] * pad >= Sp:
                    # keep the exact length: an odd-width affine descriptor
                    # beats a zero-padded one that degrades to a gather
                    tier = len(uoth)
            upad = pad_unique(uoth, tier)
            acc.setdefault(tier, [])
            if by == "dst":
                W = np.zeros((tier, block), dtype=dtype)
                W[pos, inblk] = ww[lo:hi]
                sidx = upad.astype(np.int32)
                didx = (b * block + np.arange(block)).astype(np.int32)
            else:
                W = np.zeros((block, tier), dtype=dtype)
                W[inblk, pos] = ww[lo:hi]
                sidx = (b * block + np.arange(block)).astype(np.int32)
                didx = upad.astype(np.int32)
            acc[tier].append((sidx, didx, W))
        return acc, over

    def stack_tiers(accs):
        out = []
        for acc in accs:
            for t, items in acc.items():
                if not items:
                    continue
                out.append(
                    (
                        np.stack([x[0] for x in items]),
                        np.stack([x[1] for x in items]),
                        np.stack([x[2] for x in items]),
                    )
                )
        return out

    def all_affine(ts):
        return all(
            _gather_desc(sidx, Sp)[0] != "gather"
            and _scatter_desc(didx, Sp)[0] != "scatter"
            for sidx, didx, _ in ts
        )

    def majority_lane_split(esrc, edst, ew):
        """Mask of edges whose destination lane (dst % block) is their
        source block's modal lane: isolates the dominant structural family
        when mixed families destroy each other's affine patterns."""
        blk = esrc // block
        lane = edst % block
        pair = blk * block + lane
        up, cnt = np.unique(pair, return_counts=True)
        ub = up // block
        order = np.lexsort((-cnt, ub))
        first = np.searchsorted(ub[order], np.unique(ub))
        modal = {int(ub[order][f]): int(up[order][f] % block) for f in first}
        return np.array(
            [lane[i] == modal[int(blk[i])] for i in range(len(esrc))]
        )

    def dense_pool(esrc, edst, ew, max_side=512):
        """Collapse a small leftover edge family into one dense
        (1, Su, Du) tier.  Returns the tier or None."""
        us = np.unique(esrc)
        ud = np.unique(edst)
        if len(us) > max_side or len(ud) > max_side:
            return None
        ps = np.searchsorted(us, esrc)
        pd = np.searchsorted(ud, edst)
        W = np.zeros((1, len(us), len(ud)), dtype=dtype)
        W[0, ps, pd] = ew
        return (
            us[None, :].astype(np.int32),
            ud[None, :].astype(np.int32),
            W,
        )

    tiers_np = []
    res = []
    if len(src):
        acc_d, over = group(src, dst, w, "dst")
        tiers_np = stack_tiers([acc_d])
        if over:
            osrc = np.concatenate([o[0] for o in over])
            odst = np.concatenate([o[1] for o in over])
            ow = np.concatenate([o[2] for o in over])
            acc_s, over2 = group(osrc, odst, ow, "src")
            src_tiers = stack_tiers([acc_s])
            if not (all_affine(src_tiers) and not over2):
                maj = majority_lane_split(osrc, odst, ow)
                if maj.any() and not maj.all():
                    acc_m, over_m = group(osrc[maj], odst[maj], ow[maj],
                                          "src")
                    maj_tiers = stack_tiers([acc_m])
                    rest = (osrc[~maj], odst[~maj], ow[~maj])
                    pool = dense_pool(*rest)
                    if all_affine(maj_tiers) and not over_m and pool is not None:
                        src_tiers = maj_tiers + [pool]
                        over2 = []
            tiers_np.extend(src_tiers)
            res = over2

    tier_descs = tuple(
        (_gather_desc(sidx, Sp), _scatter_desc(didx, Sp))
        for sidx, didx, _ in tiers_np
    )
    tiers = tuple(
        (torch.from_numpy(s_), torch.from_numpy(d_), torch.from_numpy(W_))
        for s_, d_, W_ in tiers_np
    )

    res_src = res_dst = res_w = None
    if res:
        res_src = torch.from_numpy(
            np.concatenate([r[0] for r in res]).astype(np.int32))
        res_dst = torch.from_numpy(
            np.concatenate([r[1] for r in res]).astype(np.int32))
        res_w = torch.from_numpy(np.concatenate([r[2] for r in res]))

    # highest state row with any nonzero band weight + 1 (static metadata)
    band_nz_hi = 0
    if band_w is not None:
        nz = np.flatnonzero(band_w.any(axis=0))
        band_nz_hi = int(nz[-1]) + 1 if len(nz) else 0

    op = BlockOperator(
        band_w=torch.from_numpy(band_w) if band_w is not None else None,
        tiers=tiers,
        res_src=res_src,
        res_dst=res_dst,
        res_w=res_w,
    )
    return op, (band_offsets, tier_descs, band_nz_hi, ())


def block_matvec(op: BlockOperator, meta, x):
    """Probability-domain y = T̂ᵀ x (or T̂ x for the reversed operator):
    y[j, b] = Σ_e w[e] · x[src[e], b] over the op's edges.  x: (Sp, B).

    ``meta``: (band_offsets, tier_descs, ...) from build_block_operator.
    The tier contraction runs in full float32 (the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off on the GPU).
    """
    band_offsets, tier_descs = meta[0], meta[1]
    if len(meta) > 3 and meta[3]:
        raise NotImplementedError(
            "overflow families are not ported yet "
            "(ROADMAP: port the overflow families)"
        )
    Sp, B = x.shape
    y = torch.zeros_like(x)
    if op.band_w is not None:
        for oi, off in enumerate(band_offsets):
            # band edge src = dst - off; wrapped rolls hit zero weights
            xs = x if off == 0 else torch.roll(x, off, dims=0)
            y = y + op.band_w[oi][:, None] * xs
    for (sidx, didx, W), (gdesc, ddesc) in zip(op.tiers, tier_descs):
        K, Sm = sidx.shape
        D = didx.shape[1]
        if gdesc[0] == "affine_s_major":
            _, base, ds, c0 = gdesc
            view = x[base : base + Sm * ds]
            Xg = view.reshape(Sm, ds, B)[:, c0 : c0 + K].transpose(0, 1)
        elif gdesc[0] == "affine_k_major":
            _, base, dk, c0 = gdesc
            view = x[base : base + K * dk]
            Xg = view.reshape(K, dk, B)[:, c0 : c0 + Sm]
        else:
            Xg = x[sidx.reshape(-1).long()].reshape(K, Sm, B)
        Y = torch.einsum("ksd,ksb->kdb", W, Xg)
        if ddesc[0] == "contig":
            base = ddesc[1]
            y[base : base + K * D] += Y.reshape(-1, B)
        elif ddesc[0] == "affine_d":
            base = ddesc[1]
            y[base : base + K * D] += Y.transpose(0, 1).reshape(-1, B)
        elif ddesc[0] in ("affine_k_pad", "affine_d_pad"):
            # strided row-chunks: a column window of a (rows, stride, B)
            # view of y, updated in place
            _, base, stride, c0 = ddesc
            if ddesc[0] == "affine_k_pad":
                rows, width, Yv = K, D, Y
            else:
                rows, width, Yv = D, K, Y.transpose(0, 1)
            seg = y[base : base + rows * stride].view(rows, stride, B)
            seg[:, c0 : c0 + width] += Yv
        else:
            y.index_add_(0, didx.reshape(-1).long(), Y.reshape(-1, B))
    if op.res_src is not None:
        contrib = op.res_w[:, None] * x[op.res_src.long()]
        y.index_add_(0, op.res_dst.long(), contrib)
    return y
