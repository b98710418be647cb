"""U32 addition + preprocessed byte-range table — the reference's benchmark
workload (reference src/test_circuits/u32_add.rs, benches/multi_stark.rs).

Two circuits:
  - ByteTable: preprocessed 256-row table of byte values, one multiplicity
    main column, PULLs (BYTE_CHAN, b).
  - U32Add: 14 columns = x bytes (4) ‖ y bytes (4) ‖ z bytes (4) ‖ carry ‖
    multiplicity.  Constraints: carry is boolean; the byte-composed addition
    identity x + y = z + carry·2^32.  Lookups: one PULL of
    (U32_CHAN, x, y, z) with the multiplicity column (consuming externally
    pushed claims) and 12 byte-range PUSHes with multiplicity 1.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import expr as ex
from ..air import Air, AirBuilder, LookupAir
from ..system import CircuitInputs

BYTE_CHAN = 0
U32_CHAN = 1


class ByteTableAir(Air):
    width = 1  # multiplicity

    def preprocessed_trace(self):
        return np.arange(256, dtype=np.uint64).reshape(256, 1)

    def eval(self, builder: AirBuilder) -> None:
        pass  # semantics are entirely in the lookup


def byte_table_lookups() -> List[ex.Lookup]:
    return [ex.Lookup.pull(ex.main(0), [ex.Const(BYTE_CHAN), ex.preprocessed(0)])]


class U32AddAir(Air):
    width = 14

    def eval(self, builder: AirBuilder) -> None:
        m = builder.main().row(0)
        x, y, z = m[0:4], m[4:8], m[8:12]
        carry, mult = m[12], m[13]
        builder.assert_bool(carry)
        builder.assert_bool(mult)
        lhs = ex.Const(0)
        for i in range(4):
            w = 1 << (8 * i)
            lhs = lhs + w * x[i] + w * y[i] - w * z[i]
        builder.assert_zero(lhs - carry * (1 << 32))


def u32_add_lookups() -> List[ex.Lookup]:
    def compose(cols):
        acc = ex.Const(0)
        for i, c in enumerate(cols):
            acc = acc + (1 << (8 * i)) * c
        return acc

    lookups = [
        ex.Lookup.pull(
            ex.main(13),
            [
                ex.Const(U32_CHAN),
                compose([ex.main(i) for i in range(0, 4)]),
                compose([ex.main(i) for i in range(4, 8)]),
                compose([ex.main(i) for i in range(8, 12)]),
            ],
        )
    ]
    for i in range(12):
        lookups.append(ex.Lookup.push(ex.Const(1), [ex.Const(BYTE_CHAN), ex.main(i)]))
    return lookups


def u32_add_system_inputs() -> List[CircuitInputs]:
    return [
        LookupAir(U32AddAir(), u32_add_lookups()).to_circuit_inputs(),
        LookupAir(ByteTableAir(), byte_table_lookups()).to_circuit_inputs(),
    ]


def u32_add_witness(pairs: Sequence[Tuple[int, int]], height: int):
    """Build (traces, claims) for the 2-circuit system from (x, y) pairs.

    Returns ([u32_trace (height, 14), byte_trace (256, 1)], claims).
    The byte table multiplicities count every byte of every row, including
    the all-zero padding rows (whose pushes still fire with multiplicity 1).
    """
    assert len(pairs) <= height and height & (height - 1) == 0
    rows = np.zeros((height, 14), np.uint64)
    k = len(pairs)
    if k:
        xs = np.fromiter((p[0] for p in pairs), np.uint64, count=k)
        ys = np.fromiter((p[1] for p in pairs), np.uint64, count=k)
        s = xs + ys
        zs = s & np.uint64(0xFFFFFFFF)
        for i in range(4):
            sh = np.uint64(8 * i)
            rows[:k, i] = (xs >> sh) & np.uint64(0xFF)
            rows[:k, 4 + i] = (ys >> sh) & np.uint64(0xFF)
            rows[:k, 8 + i] = (zs >> sh) & np.uint64(0xFF)
        rows[:k, 12] = s >> np.uint64(32)
        rows[:k, 13] = 1
        # (k, 4) ndarray claims: the vectorized transcript/accumulator paths
        # consume these without any per-claim Python conversion
        claims = np.stack(
            [np.full(k, U32_CHAN, np.uint64), xs, ys, zs], axis=1
        )
    else:
        claims = []
    byte_mult = np.zeros(256, np.uint64)
    byte_cols = rows[:, 0:12].astype(np.int64).reshape(-1)
    np.add.at(byte_mult, byte_cols, 1)
    byte_trace = byte_mult.reshape(256, 1)
    return [rows, byte_trace], claims
