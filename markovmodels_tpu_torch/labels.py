"""Label monoid and object-valued (label) semirings.

The reference attaches labels to *states* (a SequenceMonoid element per state,
reference src/fsm.jl:3-5) and lifts label *sets* into semirings for
determinization and total-label sums (UnionConcatSemiring, reference
src/fsmops.jl:162, src/algorithms.jl:43-51).

Here a label is simply a python tuple of atoms (str/int); monoid product is
tuple concatenation; ``Label()`` is the empty tuple (monoid identity).  The
union-concat semiring value is a frozenset of such tuples with
⊕ = set-union and ⊗ = pairwise concatenation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

__all__ = [
    "Label",
    "label_mul",
    "show_label",
    "LabelSet",
    "PySemiring",
    "UNION_CONCAT",
    "APPEND_CONCAT",
    "append_concat_over",
    "product_semiring",
]


def Label(*atoms) -> tuple:
    """Construct a label (SequenceMonoid element).  ``Label()`` is identity."""
    out = []
    for a in atoms:
        if isinstance(a, (tuple, list)):
            out.extend(a)
        else:
            out.append(a)
    return tuple(out)


def label_mul(a: tuple, b: tuple) -> tuple:
    """Monoid product = sequence concatenation."""
    return tuple(a) + tuple(b)


def show_label(label: tuple) -> str:
    """Mirror of the reference's ``showlabel`` (src/fsm.jl:99)."""
    return ":".join(str(a) for a in label)


class LabelSet(frozenset):
    """A set of label sequences — value type of the union-concat semiring."""

    def __repr__(self):  # pragma: no cover - debugging aid
        return "LabelSet({%s})" % ", ".join(sorted(map(show_label, self)))


@dataclasses.dataclass(frozen=True)
class PySemiring:
    """A semiring over arbitrary python objects (scalar, non-vectorized).

    Used by the host graph compiler for label-lifted computations
    (determinize / totallabelsum / n-gram counting oracles).
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Any], Any]
    zero: Any
    one: Any

    def is_zero(self, x) -> bool:
        return x == self.zero

    def add_reduce(self, xs: Iterable[Any]):
        out = self.zero
        for x in xs:
            out = self.add(out, x)
        return out

    def dot(self, xs, ys):
        out = self.zero
        for x, y in zip(xs, ys):
            out = self.add(out, self.mul(x, y))
        return out


def _union(a: LabelSet, b: LabelSet) -> LabelSet:
    return LabelSet(frozenset(a) | frozenset(b))


def _concat_all(a: LabelSet, b: LabelSet) -> LabelSet:
    return LabelSet(label_mul(x, y) for x in a for y in b)


# UnionConcatSemiring{SequenceMonoid} analog: ⊕ = union, ⊗ = pairwise concat,
# zero = {} (empty set), one = {()} (set holding the empty label).
UNION_CONCAT = PySemiring(
    name="union_concat",
    add=_union,
    mul=_concat_all,
    zero=LabelSet(),
    one=LabelSet([()]),
)


def append_concat_over(inner: PySemiring | None = None,
                       name: str = "append_concat") -> PySemiring:
    """AppendConcatSemiring analog (reference src/lmfsm.jl:37-52, via the
    Semirings.jl package): values are *tuples* (multisets with order) of
    ``inner`` elements; ⊕ = tuple append, ⊗ = pairwise inner-product of all
    combinations.  Unlike UNION_CONCAT, multiplicity is preserved — the
    n-gram lift depends on it.

    ``inner=None`` gives the plain label-monoid instance (elements are
    labels, pairwise product = concatenation).
    """
    mul1 = label_mul if inner is None else inner.mul
    one1 = () if inner is None else inner.one
    return PySemiring(
        name=name,
        add=lambda a, b: tuple(a) + tuple(b),
        mul=lambda a, b: tuple(mul1(x, y) for x in a for y in b),
        zero=(),
        one=(one1,),
    )


# AppendConcatSemiring{LabelMonoid} analog (values: tuples of labels).
APPEND_CONCAT = append_concat_over(None)


def product_semiring(s1: PySemiring, s2: PySemiring,
                     name: str | None = None) -> PySemiring:
    """ProductSemiring{S1, S2} analog (reference src/lmfsm.jl:37-39):
    component-wise pairs."""
    return PySemiring(
        name=name or f"product({s1.name},{s2.name})",
        add=lambda a, b: (s1.add(a[0], b[0]), s2.add(a[1], b[1])),
        mul=lambda a, b: (s1.mul(a[0], b[0]), s2.mul(a[1], b[1])),
        zero=(s1.zero, s2.zero),
        one=(s1.one, s2.one),
    )
