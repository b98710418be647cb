"""Bitwise-operations table circuit (reference
src/test_circuits/byte_operations.rs).

A single circuit with a preprocessed table of every (A, B) pair and their
XOR/AND/OR, plus four multiplicity main columns; all semantics are enforced
via four PULL lookups on distinct indexed channels.  External claims look
like [op_channel, a, b, result] ([RANGE_CHAN, a, b] for a range claim).

``bits`` parameterizes the operand width: 8 reproduces the reference's
65536-row byte table; tests use 4 (256 rows) to keep CPU runtime sane.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import expr as ex
from ..system import CircuitInputs

XOR_CHAN = 10
AND_CHAN = 11
OR_CHAN = 12
RANGE_CHAN = 13


def byte_operations_inputs(bits: int = 8) -> CircuitInputs:
    n = 1 << bits
    a = np.repeat(np.arange(n, dtype=np.uint64), n)
    b = np.tile(np.arange(n, dtype=np.uint64), n)
    table = np.stack([a, b, a ^ b, a & b, a | b], axis=1)  # (n^2, 5)
    pre = (ex.preprocessed(0), ex.preprocessed(1), ex.preprocessed(2),
           ex.preprocessed(3), ex.preprocessed(4))
    lookups = [
        ex.Lookup.pull(ex.main(0), [ex.Const(XOR_CHAN), pre[0], pre[1], pre[2]]),
        ex.Lookup.pull(ex.main(1), [ex.Const(AND_CHAN), pre[0], pre[1], pre[3]]),
        ex.Lookup.pull(ex.main(2), [ex.Const(OR_CHAN), pre[0], pre[1], pre[4]]),
        ex.Lookup.pull(ex.main(3), [ex.Const(RANGE_CHAN), pre[0], pre[1]]),
    ]
    return CircuitInputs(
        main_width=4,
        constraints=[],
        ext_constraints=[],
        lookups=lookups,
        preprocessed=table,
    )


def byte_operations_witness(claims: Sequence[Sequence[int]], bits: int = 8) -> np.ndarray:
    """Multiplicity trace counting how often each table row is consumed.
    `claims` is a list of claims (ragged: a RANGE claim may have 3 values)
    or an (n, 4) integer array; one np.add.at per channel."""
    n = 1 << bits
    mult = np.zeros((n * n, 4), np.uint64)
    if isinstance(claims, np.ndarray):
        head = claims[:, :3].astype(np.uint64)
        result = claims[:, 3].astype(np.uint64) if claims.shape[1] > 3 else np.zeros(len(claims), np.uint64)
    else:
        head = np.asarray([c[:3] for c in claims], np.uint64).reshape(-1, 3)
        result = np.asarray([c[3] if len(c) > 3 else 0 for c in claims], np.uint64)
    chan, a, b = head.T
    known = np.isin(chan, (XOR_CHAN, AND_CHAN, OR_CHAN, RANGE_CHAN))
    if not known.all():
        raise ValueError(f"unknown channel {int(chan[np.argmin(known)])}")
    row = (a * np.uint64(n) + b).astype(np.int64)
    for col, (ch, op) in enumerate(((XOR_CHAN, np.bitwise_xor), (AND_CHAN, np.bitwise_and),
                                    (OR_CHAN, np.bitwise_or), (RANGE_CHAN, None))):
        sel = chan == ch
        if op is not None:
            assert np.array_equal(result[sel], op(a[sel], b[sel]))
        np.add.at(mult[:, col], row[sel], np.uint64(1))
    return mult
