"""Semiring algebra of the host layer (the port's own copy of
``markovmodels_tpu/semiring.py``).

The reference (MarkovModels.jl) parameterizes every operation over Julia
scalar semiring types from Semirings.jl (see reference src/MarkovModels.jl:12,
usage e.g. src/fsmops.jl:71-80).  On TPU we want plain float arrays that XLA
can tile, so a semiring here is a small *algebra object*: a set of closed
operations (``add``, ``mul``, reductions, division, ...) acting on ordinary
numpy / jax arrays whose float values are the semiring's internal
representation (log-domain weights for the log semiring, probabilities for the
prob semiring, ...).

Numeric semirings (log / tropical / prob / boolean) work on both numpy (host
graph compiler) and jax.numpy (device inference).  Label semirings used by
determinization and n-gram counting are object-valued and live in
``labels.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

__all__ = [
    "Semiring",
    "LOG",
    "TROPICAL",
    "PROB",
    "BOOL",
    "get_semiring",
    "register_semiring",
    "semiring_name",
]


def _np_logaddexp_reduce(x, axis=None):
    # numpy's logaddexp is a ufunc, so reduce is available and exact.
    x = np.asarray(x)
    if x.size == 0:
        return np.float64(-np.inf)
    return np.logaddexp.reduce(x, axis=axis)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A numeric semiring over float arrays.

    Attributes
    ----------
    name: identifier used by the serialization registry (safe replacement for
        the reference's ``eval(Meta.parse(...))`` JSON semiring parsing,
        reference src/fsm.jl:75).
    add / mul: binary elementwise ops (the semiring ⊕ / ⊗).
    zero / one: the neutral elements as python floats.
    add_reduce: reduction with ⊕ along an axis (numpy path).
    divide: ⊗-division (only for divisible semirings; None otherwise).
    npy_add / npy_mul: the underlying numpy *ufuncs* (used for ``ufunc.at`` /
        ``ufunc.reduceat`` style segment reductions in the host sparse layer).
    from_real / to_real: map a real probability weight into/out of the
        semiring's internal representation (log for LOG/TROPICAL, identity for
        PROB, 0/1 threshold for BOOL).
    idempotent_add: True when x ⊕ x == x (tropical / bool).
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Any], Any]
    zero: float
    one: float
    add_reduce: Callable[..., Any]
    divide: Callable[[Any, Any], Any] | None
    npy_add: Any
    npy_mul: Any
    from_real: Callable[[Any], Any]
    to_real: Callable[[Any], Any]
    idempotent_add: bool = False

    # -- convenience -----------------------------------------------------
    @property
    def divisible(self) -> bool:
        """Mirror of the reference's ``IsDivisible`` trait
        (used to gate renorm, reference src/fsmops.jl:71-80)."""
        return self.divide is not None

    def zeros(self, shape, dtype=np.float64):
        return np.full(shape, self.zero, dtype=dtype)

    def ones(self, shape, dtype=np.float64):
        return np.full(shape, self.one, dtype=dtype)

    def is_zero(self, x):
        x = np.asarray(x)
        if math.isnan(self.zero):  # pragma: no cover - no nan zeros today
            return np.isnan(x)
        return x == self.zero

    def dot(self, x, y):
        """⊕-sum of elementwise ⊗ products (semiring inner product)."""
        return self.add_reduce(self.mul(np.asarray(x), np.asarray(y)))

    def sum(self, x, axis=None):
        return self.add_reduce(np.asarray(x), axis=axis)

    def power(self, x, n: int):
        """x ⊗ x ⊗ ... (n times); n >= 0."""
        out = self.one
        for _ in range(n):
            out = self.mul(out, x)
        return out

    def from_counts(self, n):
        """one ⊕ one ⊕ ... (n times) — multiplicity as a semiring value."""
        n = np.asarray(n, dtype=np.float64)
        if self.name in ("log", "tropical"):
            with np.errstate(divide="ignore"):
                return np.where(n > 0, np.log(np.maximum(n, 1e-300)), -np.inf) \
                    if self.name == "log" else np.where(n > 0, 0.0, -np.inf)
        if self.name == "prob":
            return n
        if self.name == "bool":
            return (n > 0).astype(np.float64)
        raise NotImplementedError(self.name)


def _safe_div_log(x, y):
    return np.asarray(x) - np.asarray(y)


def _safe_div_prob(x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = x / y
    return np.where((x == 0.0) & (y == 0.0), 0.0, out)


LOG = Semiring(
    name="log",
    add=np.logaddexp,
    mul=np.add,
    zero=-np.inf,
    one=0.0,
    add_reduce=_np_logaddexp_reduce,
    divide=_safe_div_log,
    npy_add=np.logaddexp,
    npy_mul=np.add,
    from_real=lambda p: np.log(np.asarray(p, dtype=np.float64)),
    to_real=lambda x: np.exp(np.asarray(x, dtype=np.float64)),
)

TROPICAL = Semiring(
    name="tropical",
    add=np.maximum,
    mul=np.add,
    zero=-np.inf,
    one=0.0,
    add_reduce=lambda x, axis=None: np.max(np.asarray(x), axis=axis)
    if np.asarray(x).size
    else np.float64(-np.inf),
    divide=_safe_div_log,
    npy_add=np.maximum,
    npy_mul=np.add,
    from_real=lambda p: np.log(np.asarray(p, dtype=np.float64)),
    to_real=lambda x: np.exp(np.asarray(x, dtype=np.float64)),
    idempotent_add=True,
)

PROB = Semiring(
    name="prob",
    add=np.add,
    mul=np.multiply,
    zero=0.0,
    one=1.0,
    add_reduce=lambda x, axis=None: np.sum(np.asarray(x), axis=axis),
    divide=_safe_div_prob,
    npy_add=np.add,
    npy_mul=np.multiply,
    from_real=lambda p: np.asarray(p, dtype=np.float64),
    to_real=lambda x: np.asarray(x, dtype=np.float64),
)

BOOL = Semiring(
    name="bool",
    add=np.maximum,
    mul=np.minimum,
    zero=0.0,
    one=1.0,
    add_reduce=lambda x, axis=None: np.max(np.asarray(x), axis=axis)
    if np.asarray(x).size
    else np.float64(0.0),
    divide=None,
    npy_add=np.maximum,
    npy_mul=np.minimum,
    from_real=lambda p: (np.asarray(p, dtype=np.float64) > 0).astype(np.float64),
    to_real=lambda x: np.asarray(x, dtype=np.float64),
    idempotent_add=True,
)


_REGISTRY: dict[str, Semiring] = {}


def register_semiring(sr: Semiring) -> None:
    _REGISTRY[sr.name] = sr


for _sr in (LOG, TROPICAL, PROB, BOOL):
    register_semiring(_sr)

# Aliases matching the reference's Julia type names so that JSON graphs written
# for MarkovModels.jl load directly (reference src/fsm.jl:73-82), without the
# eval() security hazard noted in SURVEY.md §7.
_ALIASES = {
    "LogSemiring{Float32}": "log",
    "LogSemiring{Float64}": "log",
    "LogSemiring": "log",
    "TropicalSemiring{Float32}": "tropical",
    "TropicalSemiring{Float64}": "tropical",
    "TropicalSemiring": "tropical",
    "ProbSemiring{Float32}": "prob",
    "ProbSemiring{Float64}": "prob",
    "ProbSemiring": "prob",
    "BoolSemiring": "bool",
}


def get_semiring(name) -> Semiring:
    """Resolve a semiring by registry name (or a reference Julia alias)."""
    if isinstance(name, Semiring):
        return name
    key = _ALIASES.get(str(name), str(name))
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown semiring {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def semiring_name(sr: Semiring) -> str:
    return sr.name
