"""U32 addition with a preprocessed byte-range table, the upstream bench
system (reference src/test_circuits/u32_add.rs, benches/multi_stark.rs:
73-165): the plain reference's copy of its circuits, the seeded traffic's
input generator (a frozen copy of the witness builder) and the program's
circuits.

Two circuits:
  - U32Add: 14 columns = x bytes (4) ‖ y bytes (4) ‖ z bytes (4) ‖ carry ‖
    multiplicity.  Constraints: carry is boolean; the multiplicity is
    boolean; the byte-composed addition x + y = z + carry·2^32.  Lookups:
    one PULL of (U32_CHAN, x, y, z) with the multiplicity column (the
    claims) and 12 byte-range PUSHes with multiplicity 1.
  - ByteTable: the preprocessed 256-row table of byte values, one
    multiplicity column, PULLs (BYTE_CHAN, b).
"""

from __future__ import annotations

from typing import List

import numpy as np

from plainref import expr as ex
from plainref.air import Air, AirBuilder, LookupAir
from plainref.system import CircuitInputs

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


def u32_add_witness(xs: np.ndarray, ys: np.ndarray, height: int):
    """(traces, claims) for the 2-circuit system from the (n,) uint64 words
    xs and ys: [the (height, 14) U32Add trace, the (256, 1) ByteTable
    multiplicities], and the (n, 4) claims (U32_CHAN, x, y, x + y mod 2^32).
    The table's multiplicities count every byte of every row, the all-zero
    padding rows included (their pushes fire with multiplicity 1)."""
    n = xs.shape[0]
    rows = np.zeros((height, 14), np.uint64)
    s = xs + ys
    zs = s & np.uint64(0xFFFFFFFF)
    for i in range(4):
        sh = np.uint64(8 * i)
        rows[:n, i] = (xs >> sh) & np.uint64(0xFF)
        rows[:n, 4 + i] = (ys >> sh) & np.uint64(0xFF)
        rows[:n, 8 + i] = (zs >> sh) & np.uint64(0xFF)
    rows[:n, 12] = s >> np.uint64(32)
    rows[:n, 13] = 1
    claims = np.stack([np.full(n, U32_CHAN, np.uint64), xs, ys, zs], axis=1)
    byte_mult = np.bincount(rows[:, 0:12].astype(np.int64).reshape(-1), minlength=256).astype(np.uint64)
    return [rows, byte_mult.reshape(256, 1)], claims


# --- the benchmark's interface --------------------------------------------------

def reference_inputs(cfg: dict) -> List[CircuitInputs]:
    return u32_add_system_inputs()


def program_inputs(cfg: dict) -> list:
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs as program_system

    return program_system()


def make_input(cfg: dict, traffic: dict, rng: np.random.Generator):
    """One job's input: traffic["rows"] random additions of 32-bit words,
    one claim per row."""
    n = traffic["rows"]
    xs = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return u32_add_witness(xs, ys, n)
