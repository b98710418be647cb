"""AIR authoring adapter (reference src/p3_adapter.rs).

Circuit authors implement :class:`Air` (the p3_air::Air/BaseAir equivalent);
its ``eval`` runs against a *recording builder* that captures every
``assert_zero`` as an :class:`expr.Expr` constraint.  :class:`LookupAir`
bundles an Air with its lookups and converts into
:class:`system.CircuitInputs`.

Publics are owned by the lookup argument (β, γ, accumulators), so AIRs
cannot declare their own public values (reference p3_adapter.rs:328-339).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

import numpy as np

from . import expr as ex
from .system import CircuitInputs


class RowWindow:
    """Two-row window over one trace segment (reference p3_adapter.rs:215-243)."""

    def __init__(self, source: ex.Source, width: int):
        self._source = source
        self._width = width

    def row(self, offset: int) -> List[ex.Expr]:
        assert offset in (0, 1), "only a two-row window is supported"
        off = ex.RowOffset.CURRENT if offset == 0 else ex.RowOffset.NEXT
        return [ex.Var(self._source, c, off) for c in range(self._width)]

    def __getitem__(self, offset: int) -> List[ex.Expr]:
        return self.row(offset)


class AirBuilder:
    """Recording builder: Air.eval() calls assert_* and the constraints are
    captured (reference P3AirBuilder, p3_adapter.rs:246-288)."""

    def __init__(self, main_width: int, preprocessed_width: int = 0):
        self._main = RowWindow(ex.Source.MAIN, main_width)
        self._preprocessed = (
            RowWindow(ex.Source.PREPROCESSED, preprocessed_width)
            if preprocessed_width
            else None
        )
        self.constraints: List[ex.Expr] = []
        self._condition: Optional[ex.Expr] = None

    # -- windows ----------------------------------------------------------
    def main(self) -> RowWindow:
        return self._main

    def preprocessed(self) -> RowWindow:
        assert self._preprocessed is not None, "AIR has no preprocessed trace"
        return self._preprocessed

    # -- selectors --------------------------------------------------------
    def is_first_row(self) -> ex.Expr:
        return ex.IsFirstRow()

    def is_last_row(self) -> ex.Expr:
        return ex.IsLastRow()

    def is_transition(self) -> ex.Expr:
        return ex.IsTransition()

    # -- assertions -------------------------------------------------------
    def assert_zero(self, e) -> None:
        e = e if isinstance(e, ex.Expr) else ex.Const(int(e))
        if self._condition is not None:
            e = self._condition * e
        self.constraints.append(e)

    def assert_eq(self, a, b) -> None:
        self.assert_zero(_co(a) - _co(b))

    def assert_one(self, e) -> None:
        self.assert_zero(_co(e) - 1)

    def assert_bool(self, e) -> None:
        e = _co(e)
        self.assert_zero(e * (e - 1))

    def assert_bools(self, es: Sequence) -> None:
        for e in es:
            self.assert_bool(e)

    # -- filtering --------------------------------------------------------
    def when(self, condition) -> "AirBuilder":
        sub = AirBuilder.__new__(AirBuilder)
        sub._main = self._main
        sub._preprocessed = self._preprocessed
        sub.constraints = self.constraints  # shared sink
        cond = _co(condition)
        if self._condition is not None:
            cond = self._condition * cond
        sub._condition = cond
        return sub

    def when_transition(self) -> "AirBuilder":
        return self.when(ex.IsTransition())

    def when_first_row(self) -> "AirBuilder":
        return self.when(ex.IsFirstRow())

    def when_last_row(self) -> "AirBuilder":
        return self.when(ex.IsLastRow())


def _co(v) -> ex.Expr:
    return v if isinstance(v, ex.Expr) else ex.Const(int(v))


class Air(ABC):
    """Base AIR protocol (p3_air::BaseAir + Air equivalents)."""

    @property
    @abstractmethod
    def width(self) -> int: ...

    def preprocessed_trace(self) -> Optional[np.ndarray]:
        """(height, width) uint64 row-major, or None."""
        return None

    @abstractmethod
    def eval(self, builder: AirBuilder) -> None: ...


class LookupAir:
    """An Air plus its multiset-channel interactions
    (reference p3_adapter.rs:295-319)."""

    def __init__(self, air: Air, lookups: Sequence[ex.Lookup]):
        self.air = air
        self.lookups = list(lookups)

    def to_circuit_inputs(self) -> CircuitInputs:
        return circuit_inputs_from_air(self.air, self.lookups)


def circuit_inputs_from_air(air: Air, lookups: Sequence[ex.Lookup] = ()) -> CircuitInputs:
    """Run eval() against the recording builder and package the result
    (reference p3_adapter.rs:328-354)."""
    pre = air.preprocessed_trace()
    pre_width = pre.shape[1] if pre is not None else 0
    builder = AirBuilder(air.width, pre_width)
    air.eval(builder)
    return CircuitInputs(
        main_width=air.width,
        constraints=builder.constraints,
        ext_constraints=[],
        lookups=list(lookups),
        preprocessed=pre,
    )
