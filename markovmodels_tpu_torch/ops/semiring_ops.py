"""Log-domain and tropical semiring linear algebra on tensors.

PyTorch counterpart of ``markovmodels_tpu/ops/semiring_ops.py``.  The
per-frame update of the log-space scans, ``y = T̂ᵀ ⊗ x`` over a batched
state ``x`` (S, B), state axis first, in three forms:

* ``segment_matvec``: gather the sources of a COO edge list sorted by
  destination, then a per-destination logsumexp (or max);
* ``ell_matvec``: padded incoming-arc lists (S, D), a gather and a
  logsumexp (or max) over the in-degree axis;
* ``dense_log_matvec``: the exp-shifted (S, S) operator of
  ``make_dense_operator`` times exp(x - colmax), one matmul.

Everything treats -inf as the semiring zero: an empty row or segment gives
exactly -inf (log of a zero sum is -inf, and -inf plus the finite shift
stays -inf, so no mask is needed).  The segments are reduced with
``torch.segment_reduce`` over their lengths, which each output computes
in a fixed order on every device (no float atomics), so two runs on the
card agree bit for bit.  The
tropical forms (``op='max'``) also return the backpointer, unless the
caller asks for the values alone (``arg=False``): the source of the winning
arc, the LARGEST source among tied maxima, as in the JAX
package; an empty segment's backpointer is the int32 minimum (the identity
of the JAX package's integer segment max).
"""
from __future__ import annotations

import torch

from .blocked import round_bf16

__all__ = [
    "masked_logsumexp",
    "segment_lengths",
    "segment_logsumexp",
    "segment_matvec",
    "ell_matvec",
    "make_dense_operator",
    "dense_log_matvec",
]

INT32_MIN = torch.iinfo(torch.int32).min


def _safe(m):
    """-inf (an empty group's max) replaced by 0, so subtraction stays
    finite (every non-finite value, as the JAX package's ``_safe``)."""
    return torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0)


def masked_logsumexp(x, dim):
    """logsumexp over ``dim`` that is exactly -inf for an all--inf slice."""
    ms = _safe(x.amax(dim=dim, keepdim=True))
    s = (x - ms).exp_().sum(dim=dim)
    return s.log_().add_(ms.squeeze(dim))


def segment_lengths(segment_ids, num_segments):
    """(num_segments,) int64 sizes of the segments of sorted ``segment_ids``
    (the lengths ``torch.segment_reduce`` takes; compute once per graph,
    the count reads the ids back to the host)."""
    return torch.bincount(segment_ids.long(), minlength=num_segments)


def _segment_reduce(data, lengths, reduce):
    return torch.segment_reduce(data, reduce, lengths=lengths, axis=0,
                                unsafe=True)


def segment_logsumexp(data, segment_ids, num_segments,
                      indices_are_sorted=False, lengths=None):
    """Per-segment logsumexp along the leading axis of ``data``; an empty
    segment gives -inf.  Unsorted ids are sorted first (stable)."""
    if not indices_are_sorted:
        order = torch.argsort(segment_ids, stable=True)
        data, segment_ids = data[order], segment_ids[order]
    if lengths is None:
        lengths = segment_lengths(segment_ids, num_segments)
    ms = _safe(_segment_reduce(data, lengths, "max"))
    e = (data - ms[segment_ids.long()]).exp_()
    return _segment_reduce(e, lengths, "sum").log_().add_(ms)


def segment_matvec(src, dst, w, x, num_states, *, op="logsumexp",
                   lengths=None, arg=True):
    """y[j, b] = ⊕_{e: dst[e] = j} w[e] + x[src[e], b].

    ``x``: (S, B); edges sorted by ``dst``; padding edges carry w = -inf;
    ``lengths``: the segments' sizes (:func:`segment_lengths`), computed
    when None.  ``op``: 'logsumexp' (log semiring) or 'max' (tropical).
    Returns (S, B), or for 'max' with ``arg`` ((S, B), backpointer (S, B)
    int32); 'max' without ``arg`` returns the values alone."""
    if lengths is None:
        lengths = segment_lengths(dst, num_states)
    contrib = x[src.long()] + w[:, None]  # (E, B)
    if op == "max":
        y = _segment_reduce(contrib, lengths, "max")
        if not arg:
            return y
        # the largest source among the maxima; float64 holds every index
        hit = torch.where(contrib == y[dst.long()],
                          src.to(torch.float64)[:, None],
                          torch.full_like(contrib, -1, dtype=torch.float64))
        bp = _segment_reduce(hit, lengths, "max")
        bp = torch.where(torch.isfinite(bp), bp,
                         torch.full_like(bp, INT32_MIN))
        return y, bp.to(torch.int32)
    ms = _safe(_segment_reduce(contrib, lengths, "max"))
    contrib -= ms[dst.long()]
    return _segment_reduce(contrib.exp_(), lengths, "sum").log_().add_(ms)


def ell_matvec(ell_src, ell_w, x, *, op="logsumexp", arg=True):
    """y[j, b] = ⊕_d ell_w[j, d] + x[ell_src[j, d], b].

    ``ell_src`` / ``ell_w``: (S, D) padded incoming-arc lists (w = -inf
    pads).  Returns as :func:`segment_matvec`."""
    contrib = x[ell_src.long()]  # (S, D, B), added to in place
    contrib += ell_w[:, :, None]
    if op == "max":
        y = contrib.amax(dim=1)
        if not arg:
            return y
        hit = torch.where(contrib == y[:, None, :], ell_src[:, :, None],
                          torch.full_like(ell_src, -1)[:, :, None])
        return y, hit.amax(dim=1).to(torch.int32)
    return masked_logsumexp(contrib, dim=1)


def make_dense_operator(dense_w):
    """The exp-shifted operator of the dense log-matvec.  ``dense_w``:
    (S, S) log weights, -inf for absent arcs, contracted over axis 1
    (W[j, i] = weight of arc i -> j forward).  Returns (exp_w, row_max):
    exp_w = exp(W - row_max) with 0 for absent arcs, row_max = -inf for an
    empty row."""
    row_max = dense_w.amax(dim=1)
    exp_w = torch.where(torch.isfinite(dense_w),
                        torch.exp(dense_w - _safe(row_max)[:, None]),
                        torch.zeros_like(dense_w))
    return exp_w, row_max


def dense_log_matvec(exp_w, row_max, x, precision: str = "high"):
    """y[j, b] = logsumexp_i(W[j, i] + x[i, b]) as one matmul.  ``exp_w``
    (S, S), or (G, S, S) with ``row_max`` (G, S) and ``x`` (S, G): each
    column by its own graph's operator.  'high' and 'f32' multiply in the
    operands' dtype (float32 in full: the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off on the GPU, as for
    ``blocked.block_matvec``; or float64); 'bf16' rounds both operands to
    bf16 and sums in float32.

    The max-rescaling bound is per (row, column): contributions more than
    ~88 nats below row max + column max underflow in float32."""
    col_max = _safe(x.amax(dim=0))  # (B,)
    ex = (x - col_max[None, :]).exp_()
    if precision == "bf16":
        exp_w, ex = round_bf16(exp_w), round_bf16(ex)
    if exp_w.dim() == 3:
        p = (exp_w @ ex.T[:, :, None])[:, :, 0].T
        row_max = row_max.T
    else:
        p = exp_w @ ex
        row_max = row_max[:, None]
    # an empty row (row max -inf) has p = 0: log 0 + (-inf) = -inf
    return p.log_().add_(row_max).add_(col_max[None, :])
