"""Fiat-Shamir challengers (host-side: tiny serial state; the device work
happens in the big prover stages between transcript interactions).

Equivalent of p3-challenger (reference src/types.rs:10-13, 28-81):

  - ``ByteHashChallenger``: duplex-over-hash on bytes (HashChallenger<u8,
    Blake3, 32> semantics: observe clears the output buffer and appends to
    the input buffer; flush hashes the drained input, the output is also fed
    back as chaining input; sample pops from the end of the output buffer).
  - ``SerializingChallenger64``: field adapter over the byte challenger —
    u64 little-endian observation, rejection-sampled canonical field draws.
  - ``DuplexChallenger``: field-native sponge challenger for the Poseidon2
    config (p3 DuplexChallenger<F, Perm, 16, 8>), its permutation, bulk
    absorb and grind in the host C helper (csrc/host/poseidon2.c).
  - deterministic grinding: sequential witness search from 0, so a 0-bit
    grind returns witness 0 — run-to-run proof determinism (the reference's
    DeterministicPow wrapper, src/types.rs:31-81).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from .fields.host import HostExtField, HostField
from .hash.blake3_host import blake3_hash
from .hash.poseidon2_host import CONSTANTS_U32, u32_ptr as _u32p
from .native import lib as native_lib


def _claims_array(claims) -> np.ndarray:
    """Homogeneous claims -> (n, L) uint64, preferring NumPy's C-side
    conversion over a Python comprehension (1M claims at 2^20 rows)."""
    try:
        return np.asarray(claims, dtype=np.uint64)
    except (TypeError, OverflowError, ValueError):
        return np.asarray([[int(v) % (1 << 64) for v in c] for c in claims], np.uint64)


def _canonical_claims_array(claims, p: int):
    """(n, L) canonical-uint64 claims array, or None if `claims` is not a
    homogeneous batch worth vectorizing.  Never iterates ndarray rows in
    Python (that alone costs seconds at 2^20 rows)."""
    if isinstance(claims, np.ndarray):
        if claims.ndim != 2 or claims.shape[0] == 0:
            return None
        arr = claims.astype(np.uint64, copy=False)
    else:
        if len(claims) < 32 or len({len(c) for c in claims}) != 1:
            return None
        arr = _claims_array(claims)
    pp = np.uint64(p)
    if (arr >= pp).any():
        arr = arr % pp
    return arr


def observe_claims(ch, claims) -> None:
    """Observe length-prefixed claims (reference prover.rs:353-373):
    u64(len(claims)), then per claim u64(len) + each value as a field
    element.  Dispatches to the challenger's vectorized bulk path when it
    has one."""
    fast = getattr(ch, "observe_claims", None)
    if fast is not None:
        fast(claims)
        return
    ch.observe_u64(len(claims))
    for claim in claims:
        ch.observe_u64(len(claim))
        for v in claim:
            ch.observe_field(int(v))


class ByteHashChallenger:
    OUT_LEN = 32

    def __init__(self):
        self.input_buffer = bytearray()
        self.output_buffer: List[int] = []

    def clone(self) -> "ByteHashChallenger":
        c = ByteHashChallenger()
        c.input_buffer = bytearray(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def observe(self, byte: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(byte & 0xFF)

    def observe_slice(self, data: bytes) -> None:
        self.output_buffer.clear()
        self.input_buffer.extend(data)

    def _flush(self) -> None:
        out = blake3_hash(bytes(self.input_buffer))
        self.input_buffer.clear()
        self.output_buffer = list(out)
        self.input_buffer.extend(out)  # chaining values

    def sample(self) -> int:
        if not self.output_buffer:
            self._flush()
        return self.output_buffer.pop()

    def sample_array(self, n: int) -> bytes:
        return bytes(self.sample() for _ in range(n))


class SerializingChallenger64:
    """Field challenger over a byte challenger for 64-bit fields."""

    def __init__(self, field: HostField, ext: HostExtField, inner: ByteHashChallenger | None = None):
        self.F = field
        self.E = ext
        self.inner = inner or ByteHashChallenger()

    def clone(self) -> "SerializingChallenger64":
        return SerializingChallenger64(self.F, self.E, self.inner.clone())

    # -- observation ------------------------------------------------------
    def observe_bytes(self, data: bytes) -> None:
        self.inner.observe_slice(data)

    def observe_u64(self, v: int) -> None:
        self.inner.observe_slice(int(v).to_bytes(8, "little"))

    def observe_field(self, v: int) -> None:
        self.observe_u64(v % self.F.p)

    def observe_ext(self, v: Sequence[int]) -> None:
        for c in v:
            self.observe_field(c)

    def observe_commitment(self, cap: np.ndarray) -> None:
        """cap: (k, 8) uint32 digest words -> observed as raw bytes."""
        for row in np.atleast_2d(cap):
            self.observe_bytes(b"".join(int(w).to_bytes(4, "little") for w in row))

    def observe_claims(self, claims) -> None:
        """Length-prefixed claims, byte-identical to the per-element loop
        (observe_u64(len) then each value as canonical u64-LE) but built as
        ONE NumPy serialization for homogeneous claim lists — the bench
        workload has one claim per trace row (benches/multi_stark.rs:220-238),
        so this is O(rows) Python-call-free."""
        self.observe_u64(len(claims))
        arr = _canonical_claims_array(claims, self.F.p)
        if arr is not None:
            buf = np.empty((arr.shape[0], arr.shape[1] + 1), dtype="<u8")
            buf[:, 0] = arr.shape[1]
            buf[:, 1:] = arr
            self.inner.observe_slice(buf.tobytes())
            return
        for claim in claims:
            self.observe_u64(len(claim))
            for v in claim:
                self.observe_field(int(v))

    # -- sampling ---------------------------------------------------------
    def sample_field(self) -> int:
        while True:
            v = int.from_bytes(self.inner.sample_array(8), "little")
            if v < self.F.p:
                return v

    def sample_ext(self) -> Tuple[int, ...]:
        return tuple(self.sample_field() for _ in range(self.E.D))

    def sample_bits(self, bits: int) -> int:
        assert 0 <= bits < 64
        return self.sample_field() & ((1 << bits) - 1)

    # -- grinding (deterministic; reference src/types.rs:43-81) ----------
    def grind(self, bits: int) -> int:
        """Sequential-semantics witness search (witness = smallest passing
        u64), executed by the native C helper: each candidate's flush
        hashes (input_buffer ‖ witness_le8) and the sample pops the last 8
        digest bytes.  Falls back to the scalar path when the helper finds
        no witness in its range."""
        if bits == 0:
            ok = self.check_witness(0, 0)
            assert ok
            return 0
        w = self._grind_batch(bits)
        if w is not None and self.clone().check_witness(bits, w):
            self.observe_field(w)
            took = self.sample_bits(bits)
            assert took == 0
            return w
        # scalar fallback (handles >2^64-p rejection edge cases)
        w = 0
        while True:
            probe = self.clone()
            probe.observe_field(w)
            if probe.sample_bits(bits) == 0:
                ok = self.check_witness(bits, w)
                assert ok
                return w
            w += 1

    def _grind_batch(self, bits: int):
        """The native helper's search over the first 256·2^bits witnesses;
        None if it found none or the prefix exceeds its 4 KiB buffer."""
        prefix = bytes(self.inner.input_buffer)
        w = native_lib().msb3_grind(prefix, len(prefix), 0, 256 << bits, bits, self.F.p)
        return None if w == (1 << 64) - 1 else int(w)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe_field(witness)
        return self.sample_bits(bits) == 0


class DuplexChallenger:
    """Field-native sponge challenger (p3 DuplexChallenger<F, Perm, 16, 8>)
    over the Poseidon2 permutation, with the JAX package's semantics
    (multistark_tpu/challenger.py DuplexChallenger):

      - observing a value clears the output buffer and appends the value
        (mod p) to the input buffer; a full buffer of RATE values
        overwrites the first RATE lanes of the state and permutes;
      - sampling with pending input (or an empty output buffer) does the
        same duplex, and pops from the END of the output buffer (lanes
        0..7 after the permutation);
      - observe_u64 is two 32-bit limbs (lo, hi); observe_bytes one field
        element per byte (TranscriptProfile.duplex_observe_bytes);
      - a commitment's digest words are observed one field element each.

    The state is a uint32 array; the permutation, the bulk absorb of the
    claims and the grind run in the host C helper."""

    WIDTH = 16
    RATE = 8

    def __init__(self, field: HostField, ext: HostExtField):
        self.F = field
        self.E = ext
        self._consts = _u32p(CONSTANTS_U32)
        self.state = np.zeros(self.WIDTH, np.uint32)
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger(self.F, self.E)
        c.state = self.state.copy()
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplex(self) -> None:
        self.state[: len(self.input_buffer)] = self.input_buffer
        self.input_buffer.clear()
        native_lib().msp2_permute(_u32p(self.state), self._consts)
        self.output_buffer = [int(x) for x in self.state[: self.RATE]]

    # -- observation ------------------------------------------------------
    def observe_field(self, v: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(v) % self.F.p)
        if len(self.input_buffer) == self.RATE:
            self._duplex()

    def observe_u64(self, v: int) -> None:
        # two 32-bit limbs (lo, hi), injective for any 31-bit field
        self.observe_field(int(v) & 0xFFFFFFFF)
        self.observe_field(int(v) >> 32)

    def observe_ext(self, v: Sequence[int]) -> None:
        for c in v:
            self.observe_field(c)

    def observe_commitment(self, cap: np.ndarray) -> None:
        """Poseidon2 commitments are field-element digests: (k, 8) canonical."""
        for row in np.atleast_2d(cap):
            for w in row:
                self.observe_field(int(w))

    def observe_bytes(self, data: bytes) -> None:
        for b in data:
            self.observe_field(b)

    def _observe_values(self, vals: np.ndarray) -> None:
        """observe_field of each canonical value in order, in one C pass."""
        vals = np.ascontiguousarray(vals, np.uint32).reshape(-1)
        if vals.size == 0:
            return
        buf = np.zeros(self.RATE, np.uint32)
        buf[: len(self.input_buffer)] = self.input_buffer
        in_len = ctypes.c_uint32(len(self.input_buffer))
        duplexed = native_lib().msp2_absorb(
            _u32p(self.state), _u32p(buf), ctypes.byref(in_len), _u32p(vals), vals.size, self._consts,
        )
        self.input_buffer = [int(x) for x in buf[: in_len.value]]
        self.output_buffer = [int(x) for x in self.state[: self.RATE]] if duplexed else []

    def observe_claims(self, claims) -> None:
        """Length-prefixed claims, the same field sequence as the
        per-element loop of `observe_claims` (u64(len) as two limbs, then
        each value mod p), absorbed in one C pass for homogeneous claim
        lists (the bench has one claim per trace row)."""
        self.observe_u64(len(claims))
        arr = _canonical_claims_array(claims, self.F.p)
        if arr is not None:
            L = arr.shape[1]
            buf = np.empty((arr.shape[0], L + 2), np.uint32)
            buf[:, 0], buf[:, 1] = L & 0xFFFFFFFF, L >> 32
            buf[:, 2:] = arr
            self._observe_values(buf)
            return
        for claim in claims:
            self.observe_u64(len(claim))
            for v in claim:
                self.observe_field(int(v))

    # -- sampling ---------------------------------------------------------
    def sample_field(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> Tuple[int, ...]:
        return tuple(self.sample_field() for _ in range(self.E.D))

    def sample_bits(self, bits: int) -> int:
        return self.sample_field() & ((1 << bits) - 1)

    # -- grinding (deterministic: the smallest passing witness) -----------
    def grind(self, bits: int) -> int:
        """The smallest witness w such that observing w and sampling gives
        `bits` zero low bits, searched by the C helper; then observed and
        checked here, as the sequential search would leave the state."""
        buf = np.zeros(self.RATE, np.uint32)
        buf[: len(self.input_buffer)] = self.input_buffer
        w = native_lib().msp2_grind(
            _u32p(self.state), _u32p(buf), len(self.input_buffer), bits, 1 << min(bits + 8, 40), self._consts,
        )
        if w == (1 << 64) - 1:
            raise RuntimeError(f"no {bits}-bit proof-of-work witness found")
        ok = self.check_witness(bits, int(w))
        assert ok
        return int(w)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe_field(witness)
        return self.sample_bits(bits) == 0
