"""Per-frame emission inputs of the probability-domain scans.

Counterpart of ``prepare_emissions`` / ``pad_emissions`` in
``markovmodels_tpu/ops/pallas_scan.py``, with the same layouts: the
extended emission matrix ``ext`` (Nf, P1, B) and the factored-out
per-frame log-shift ``mshift`` (Nf, 1, B), Nf = N + 1.
"""
from __future__ import annotations

import torch

__all__ = ["prepare_emissions", "pad_emissions"]


def prepare_emissions(lhs: torch.Tensor, lengths: torch.Tensor,
                      num_pdfs: int, dtype=torch.float32):
    """``lhs``: (B, N, P) log-likelihoods; ``lengths``: (B,) int.

    ext[t, p, b] = exp(lhs[b, t, p] - max_p lhs[b, t, :]) while t < len_b,
    ext[t, P, b] = 1 past the end (the phony-pdf row of the reference's
    ``expand``), zero elsewhere; mshift[t, 0, b] carries the factored-out
    per-frame max (zero past the end) so logZ stays exact.  Both in
    ``dtype``: the graph's (float32, or float64 for a float64 graph).
    """
    B, N, P = lhs.shape
    if P != num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {num_pdfs}")
    Nf = N + 1
    m_l = lhs.amax(dim=2)  # (B, N)
    el = torch.exp(lhs - m_l[:, :, None]).permute(1, 2, 0)  # (N, P, B)
    el = torch.nn.functional.pad(el, (0, 0, 0, 1, 0, 1))  # (Nf, P1, B)
    t = torch.arange(Nf, device=lhs.device)
    active = t[:, None] < lengths.to(lhs.device)[None, :]  # (Nf, B)
    ext = torch.where(active[:, None, :], el, torch.zeros_like(el))
    ext[:, P, :] = (~active).to(ext.dtype)
    msh = torch.nn.functional.pad(m_l.T, (0, 0, 0, 1))  # (Nf, B)
    mshift = torch.where(active, msh, torch.zeros_like(msh))
    return (ext.to(dtype).contiguous(),
            mshift.to(dtype)[:, None, :].contiguous())


def pad_emissions(ext: torch.Tensor, mshift: torch.Tensor, n_total: int):
    """Extend prepare_emissions outputs to ``n_total`` frames with
    phony-absorb pad frames (emission 1 on the phony pdf row, 0 elsewhere,
    zero shift): the semantics every frame past a sequence's length already
    has, so chunked sweeps can assume a frame count that is a multiple of
    the chunk size."""
    Nf, P1, B = ext.shape
    pad = n_total - Nf
    if pad <= 0:
        return ext, mshift
    extp = ext.new_zeros((pad, P1, B))
    extp[:, P1 - 1, :] = 1.0
    return (
        torch.cat([ext, extp], dim=0),
        torch.cat([mshift, mshift.new_zeros((pad, 1, B))], dim=0),
    )
