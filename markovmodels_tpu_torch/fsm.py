"""Host-side FSM representation.

Mirrors the reference's ``FSM{K,L}`` (reference src/fsm.jl:7-28): a weighted
finite-state machine with labels on *states*, stored as the extended matrix

    α̂ = [α; 0]          (initial weights plus a phony final state)
    T̂ = [T ω; 0 1]      (transitions with the final-weight vector ω folded in
                         as arcs to the phony final state, which self-loops
                         with weight one)

The extended form is what makes ragged batching and the fixed-shape TPU scan
clean: after a sequence ends, all probability mass parks on the phony final
state (see reference src/inference.jl:54-60 and ops/recursions here).

Weights are stored in the semiring's *internal representation* (log-domain
floats for the log semiring), matching the reference where ``K(x)`` wraps the
raw value (e.g. ``K(log(silprob))`` in examples/prepare-lfmmi-graphs.jl:29).
"""
from __future__ import annotations

import dataclasses
import json as _json
from typing import Sequence

import numpy as np

from . import hostsparse as hs
from .labels import Label, show_label
from .semiring import Semiring, get_semiring, semiring_name

__all__ = ["FSM", "from_json", "to_json"]


@dataclasses.dataclass
class FSM:
    sr: Semiring
    alpha_hat: np.ndarray  # (S+1,) dense semiring values
    T_hat: hs.SpMat  # (S+1, S+1)
    labels: list  # length S, python tuples (state labels)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_parts(cls, alpha, T: hs.SpMat, omega, labels, sr) -> "FSM":
        """Build the extended storage from (α, T, ω, λ)
        (reference src/fsm.jl:19-28)."""
        sr = get_semiring(sr)
        S = len(labels)
        alpha = np.asarray(alpha, dtype=np.float64)
        omega = np.asarray(omega, dtype=np.float64)
        assert alpha.shape == (S,) and omega.shape == (S,)
        assert T.shape == (S, S)
        rows, cols, data = hs.findnz(T)
        wnz = np.flatnonzero(~sr.is_zero(omega))
        ext_rows = np.concatenate([rows, wnz, [S]])
        ext_cols = np.concatenate([cols, np.full(len(wnz), S, dtype=np.int64), [S]])
        ext_data = np.concatenate([data, omega[wnz], [sr.one]])
        T_hat = hs.spmat_from_coo(ext_rows, ext_cols, ext_data, (S + 1, S + 1), sr)
        alpha_hat = np.append(alpha, sr.zero)
        return cls(sr, alpha_hat, T_hat, list(labels))

    @classmethod
    def from_pairs(cls, initws, arcs, finalws, labels, sr) -> "FSM":
        """Pair-list constructor (reference src/fsm.jl:50-71).

        ``initws``/``finalws``: [(state, weight)]; ``arcs``: [((src, dst), w)].
        States are 0-based here (the reference is 1-based Julia).
        """
        sr = get_semiring(sr)
        S = len(labels)
        alpha = sr.zeros(S)
        for i, w in initws:
            alpha[i] = sr.add(alpha[i], w)
        omega = sr.zeros(S)
        for i, w in finalws:
            omega[i] = sr.add(omega[i], w)
        if arcs:
            rows = [a[0][0] for a in arcs]
            cols = [a[0][1] for a in arcs]
            data = np.asarray([a[1] for a in arcs], dtype=np.float64)
            T = hs.spmat_from_coo(rows, cols, data, (S, S), sr)
        else:
            T = hs.spmat_zeros((S, S), sr)
        return cls.from_parts(alpha, T, omega, labels, sr)

    # ------------------------------------------------------------------
    # virtual accessors (reference src/fsm.jl:30-40)
    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return len(self.alpha_hat) - 1

    @property
    def alpha(self) -> np.ndarray:
        return self.alpha_hat[:-1]

    @property
    def omega(self) -> np.ndarray:
        S = self.num_states
        return hs.getcol(self.T_hat, S, self.sr)[:S]

    @property
    def T(self) -> hs.SpMat:
        S = self.num_states
        return hs.submatrix(self.T_hat, S, S, self.sr)

    def arcs(self):
        """Iterate (src, dst, weight) over T (excluding final-state arcs)."""
        rows, cols, data = hs.findnz(self.T)
        return list(zip(rows.tolist(), cols.tolist(), data.tolist()))

    # ------------------------------------------------------------------
    # rendering (reference src/fsm.jl:95-159)
    # ------------------------------------------------------------------
    def to_dot(self) -> str:
        lines = ["Digraph {", "rankdir=LR;"]
        omega = self.omega
        for i in range(self.num_states):
            label = show_label(self.labels[i])
            penwidth = "1"
            if not self.sr.is_zero(self.alpha[i]):
                label += "/%.3f" % self.alpha[i]
                penwidth = "2"
            shape = "circle"
            if not self.sr.is_zero(omega[i]):
                label += "/%.3f" % omega[i]
                shape = "doublecircle"
            lines.append(f'{i} [ shape={shape} penwidth={penwidth} label="{label}" ];')
        for i, j, w in self.arcs():
            lines.append(f'{i} -> {j} [ label="%.3f" ];' % w)
        lines.append("}")
        return "\n".join(lines)

    def _repr_svg_(self):  # pragma: no cover - needs graphviz
        import subprocess

        try:
            out = subprocess.run(
                ["dot", "-Tsvg"], input=self.to_dot().encode(), capture_output=True
            )
            return out.stdout.decode() if out.returncode == 0 else None
        except FileNotFoundError:
            return None

    def __repr__(self):
        return (
            f"FSM(semiring={self.sr.name}, states={self.num_states}, "
            f"arcs={self.T_hat.nnz})"
        )


def nstates(fsm: FSM) -> int:
    return fsm.num_states


# ---------------------------------------------------------------------------
# JSON serialization (reference src/fsm.jl:73-82, with a safe semiring
# registry instead of eval-parsing the type name)
# ---------------------------------------------------------------------------

def from_json(s, sr=None) -> FSM:
    data = _json.loads(s) if isinstance(s, str) else s
    sr = get_semiring(sr if sr is not None else data["semiring"])
    initws = [(int(a) , float(b)) for a, b in data["initstates"]]
    arcs = [((int(a), int(b)), float(c)) for a, b, c in data["arcs"]]
    finalws = [(int(a), float(b)) for a, b in data["finalstates"]]
    labels = [Label(a) for a in data["labels"]]
    one_based = bool(data.get("one_based", True))
    if one_based:
        # Reference JSON graphs are 1-based Julia state ids.
        initws = [(i - 1, w) for i, w in initws]
        arcs = [((i - 1, j - 1), w) for (i, j), w in arcs]
        finalws = [(i - 1, w) for i, w in finalws]
    return FSM.from_pairs(initws, arcs, finalws, labels, sr)


def to_json(fsm: FSM, one_based: bool = True) -> str:
    off = 1 if one_based else 0
    sr = fsm.sr
    alpha, omega = fsm.alpha, fsm.omega
    payload = {
        "semiring": semiring_name(sr),
        "one_based": one_based,
        "initstates": [
            [int(i) + off, float(alpha[i])]
            for i in np.flatnonzero(~sr.is_zero(alpha))
        ],
        "arcs": [[int(i) + off, int(j) + off, float(w)] for i, j, w in fsm.arcs()],
        "finalstates": [
            [int(i) + off, float(omega[i])]
            for i in np.flatnonzero(~sr.is_zero(omega))
        ],
        "labels": [list(l) if len(l) != 1 else l[0] for l in fsm.labels],
    }
    return _json.dumps(payload)
