"""Frontend expression DSL (reference src/expr.rs).

Expression trees describe a circuit; constraints.py orders them and
evaluates them at ζ.  Variables reference a
two-row window (Current/Next) over three trace segments: Preprocessed, Main,
Stage2 (reference src/expr.rs:14-35).

Operators fold constants eagerly (reference src/expr.rs:179-285); constants
are plain Python ints reduced modulo the field at compile time.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Sequence, Tuple


class Source(Enum):
    PREPROCESSED = 0
    MAIN = 1
    STAGE2 = 2


class RowOffset(Enum):
    CURRENT = 0
    NEXT = 1


class Expr:
    """Base-field expression node."""

    # -- operator overloads with eager constant folding -------------------
    def __add__(self, other) -> "Expr":
        other = _coerce(other)
        if isinstance(self, Const) and isinstance(other, Const):
            return Const(self.value + other.value)
        if isinstance(self, Const) and self.value == 0:
            return other
        if isinstance(other, Const) and other.value == 0:
            return self
        return Add(self, other)

    def __radd__(self, other) -> "Expr":
        return _coerce(other) + self

    def __sub__(self, other) -> "Expr":
        other = _coerce(other)
        if isinstance(self, Const) and isinstance(other, Const):
            return Const(self.value - other.value)
        if isinstance(other, Const) and other.value == 0:
            return self
        return Sub(self, other)

    def __rsub__(self, other) -> "Expr":
        return _coerce(other) - self

    def __mul__(self, other) -> "Expr":
        other = _coerce(other)
        if isinstance(self, Const) and isinstance(other, Const):
            return Const(self.value * other.value)
        if isinstance(self, Const):
            if self.value == 0:
                return Const(0)
            if self.value == 1:
                return other
        if isinstance(other, Const):
            if other.value == 0:
                return Const(0)
            if other.value == 1:
                return self
        return Mul(self, other)

    def __rmul__(self, other) -> "Expr":
        return _coerce(other) * self

    def __neg__(self) -> "Expr":
        if isinstance(self, Const):
            return Const(-self.value)
        return Neg(self)


def _coerce(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Const(v)
    raise TypeError(f"cannot use {type(v)} in an Expr")


@dataclass(frozen=True)
class Const(Expr):
    value: int


@dataclass(frozen=True)
class Var(Expr):
    source: Source
    column: int
    offset: RowOffset


@dataclass(frozen=True)
class Public(Expr):
    index: int


@dataclass(frozen=True)
class IsFirstRow(Expr):
    pass


@dataclass(frozen=True)
class IsLastRow(Expr):
    pass


@dataclass(frozen=True)
class IsTransition(Expr):
    pass


@dataclass(frozen=True)
class Add(Expr):
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Sub(Expr):
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Mul(Expr):
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Neg(Expr):
    arg: Expr


# -- smart constructors (reference src/expr.rs:102-165) -----------------------

def main(col: int) -> Expr:
    return Var(Source.MAIN, col, RowOffset.CURRENT)


def main_next(col: int) -> Expr:
    return Var(Source.MAIN, col, RowOffset.NEXT)


def preprocessed(col: int) -> Expr:
    return Var(Source.PREPROCESSED, col, RowOffset.CURRENT)


def preprocessed_next(col: int) -> Expr:
    return Var(Source.PREPROCESSED, col, RowOffset.NEXT)


def stage2(col: int) -> Expr:
    return Var(Source.STAGE2, col, RowOffset.CURRENT)


def stage2_next(col: int) -> Expr:
    return Var(Source.STAGE2, col, RowOffset.NEXT)


def public(idx: int) -> Expr:
    return Public(idx)


# --- extension-field expressions ---------------------------------------------

class ExtExpr:
    """Extension-field expression; compiled to D base-coordinate roots
    (reference src/expr.rs:56-66)."""

    def __add__(self, other) -> "ExtExpr":
        return ExtAdd(self, _ecoerce(other))

    def __radd__(self, other) -> "ExtExpr":
        return _ecoerce(other) + self

    def __sub__(self, other) -> "ExtExpr":
        return ExtSub(self, _ecoerce(other))

    def __rsub__(self, other) -> "ExtExpr":
        return _ecoerce(other) - self

    def __mul__(self, other) -> "ExtExpr":
        return ExtMul(self, _ecoerce(other))

    def __rmul__(self, other) -> "ExtExpr":
        return _ecoerce(other) * self

    def __neg__(self) -> "ExtExpr":
        return ExtNeg(self)

    def is_purely_base(self) -> bool:
        """True when the expression never leaves the base field — such a
        constraint must be authored as a base constraint instead
        (reference src/expr.rs:287-301)."""
        if isinstance(self, ExtBase):
            return True
        if isinstance(self, ExtCoords):
            return False
        if isinstance(self, (ExtAdd, ExtSub, ExtMul)):
            return self.lhs.is_purely_base() and self.rhs.is_purely_base()
        if isinstance(self, ExtNeg):
            return self.arg.is_purely_base()
        raise TypeError(type(self))


def _ecoerce(v) -> ExtExpr:
    if isinstance(v, ExtExpr):
        return v
    if isinstance(v, Expr):
        return ExtBase(v)
    if isinstance(v, int):
        return ExtBase(Const(v))
    raise TypeError(f"cannot use {type(v)} in an ExtExpr")


@dataclass(frozen=True)
class ExtBase(ExtExpr):
    arg: Expr


@dataclass(frozen=True)
class ExtCoords(ExtExpr):
    coords: Tuple[Expr, ...]


@dataclass(frozen=True)
class ExtAdd(ExtExpr):
    lhs: ExtExpr
    rhs: ExtExpr


@dataclass(frozen=True)
class ExtSub(ExtExpr):
    lhs: ExtExpr
    rhs: ExtExpr


@dataclass(frozen=True)
class ExtMul(ExtExpr):
    lhs: ExtExpr
    rhs: ExtExpr


@dataclass(frozen=True)
class ExtNeg(ExtExpr):
    arg: ExtExpr


def stage2_ext(slot: int, degree: int) -> ExtExpr:
    """The slot-th stage-2 extension element: D adjacent base columns
    (flatten_to_base layout, reference src/lookup.rs:13-26)."""
    return ExtCoords(tuple(stage2(slot * degree + d) for d in range(degree)))


def stage2_ext_next(slot: int, degree: int) -> ExtExpr:
    return ExtCoords(tuple(stage2_next(slot * degree + d) for d in range(degree)))


def public_ext(slot: int, degree: int) -> ExtExpr:
    """The slot-th public extension value: D adjacent public inputs
    (publics layout: beta, gamma, acc_initial, acc_final — reference
    src/lookup.rs:78-99)."""
    return ExtCoords(tuple(public(slot * degree + d) for d in range(degree)))


# --- lookups -----------------------------------------------------------------

@dataclass(frozen=True)
class Lookup:
    """One multiset-channel interaction: push adds `multiplicity` copies of
    the argument tuple to the global channel multiset; pull = push with
    negated multiplicity (reference src/lookup.rs:39-74).  By convention the
    first argument is the channel index constant."""

    multiplicity: Expr
    args: Tuple[Expr, ...]

    @staticmethod
    def push(multiplicity, args: Sequence) -> "Lookup":
        return Lookup(_coerce(multiplicity), tuple(_coerce(a) for a in args))

    @staticmethod
    def pull(multiplicity, args: Sequence) -> "Lookup":
        return Lookup(-_coerce(multiplicity), tuple(_coerce(a) for a in args))
