"""Fiat-Shamir challengers (host-side: tiny serial state; the device work
happens in the big prover stages between transcript interactions).

Equivalent of p3-challenger (reference src/types.rs:10-13, 28-81):

  - ``ByteHashChallenger``: duplex-over-hash on bytes (HashChallenger<u8,
    Blake3, 32> semantics: observe clears the output buffer and appends to
    the input buffer; flush hashes the drained input, the output is also fed
    back as chaining input; sample pops from the end of the output buffer).
  - ``SerializingChallenger64``: field adapter over the byte challenger —
    u64 little-endian observation, rejection-sampled canonical field draws;
    a homogeneous batch of claims enters the byte buffer as a claims
    segment (its array), which the host C helper hashes 16 chunks at a time
    with no byte image (``CLAIMS_ABSORBED`` counts the path taken).
  - ``DuplexChallenger``: field-native sponge challenger for the Poseidon2
    config (p3 DuplexChallenger<F, Perm, 16, 8>), its permutation, bulk
    absorb and grind in the host C helper (csrc/host/poseidon2.c).
  - deterministic grinding: sequential witness search from 0, so a 0-bit
    grind returns witness 0 — run-to-run proof determinism (the reference's
    DeterministicPow wrapper, src/types.rs:31-81).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from .fields.host import HostExtField, HostField
from .hash.blake3_host import ClaimsSegment, parts_bytes, parts_hash
from .hash.poseidon2_host import CONSTANTS_U32, u32_ptr as _u32p
from .native import lib as native_lib

# Claims absorbed by the BLAKE3 transcripts' observe_claims, by (side, path):
# side "challenger" (SerializingChallenger64: the host-transcript prove, the
# device-transcript prove's replay, the verifier) or "duplex" (the device
# duplex, dt_prover); path "array" (a claims segment, hashed from the array)
# or "bytes" (few or ragged claims, observed value by value).  native.lanes()
# names the lane clone that hashes the segments.
CLAIMS_ABSORBED: Counter = Counter()


def _claims_array(claims) -> np.ndarray:
    """Homogeneous claims -> (n, L) uint64, preferring NumPy's C-side
    conversion over a Python comprehension (1M claims at 2^20 rows)."""
    try:
        return np.asarray(claims, dtype=np.uint64)
    except (TypeError, OverflowError, ValueError):
        return np.asarray([[int(v) % (1 << 64) for v in c] for c in claims], np.uint64)


def _claims_rows(claims):
    """Homogeneous claims as a C-contiguous (n, L) uint64 array (an ndarray
    that already is one, itself), or None if `claims` is not a homogeneous
    batch worth vectorizing.  Never iterates ndarray rows in Python (that
    alone costs seconds at 2^20 rows)."""
    if isinstance(claims, np.ndarray):
        if claims.ndim != 2 or claims.shape[0] == 0:
            return None
        return np.ascontiguousarray(claims, np.uint64)
    if len(claims) < 32 or len({len(c) for c in claims}) != 1:
        return None
    return _claims_array(claims)


def _canonical_claims_array(claims, p: int):
    """`_claims_rows` with every value reduced mod p (a new array only if
    one is not canonical)."""
    arr = _claims_rows(claims)
    if arr is None:
        return None
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
    """The input buffer is held as parts in observation order: bytearrays
    and claims segments (blake3_host.ClaimsSegment).  A flush hashes the
    parts as they are; `input_buffer` joins them into one bytearray for a
    reader that needs the bytes (a grind's prefix, the FRI entry words)."""

    OUT_LEN = 32

    def __init__(self):
        self._parts: list = []
        self.output_buffer: List[int] = []

    @property
    def input_buffer(self) -> bytearray:
        if len(self._parts) != 1 or not isinstance(self._parts[0], bytearray):
            self._parts = [parts_bytes(self._parts)]
        return self._parts[0]

    @input_buffer.setter
    def input_buffer(self, data) -> None:
        self._parts = [bytearray(data)]

    def clone(self) -> "ByteHashChallenger":
        c = ByteHashChallenger()
        c._parts = [bytearray(part) if isinstance(part, bytearray) else part for part in self._parts]
        c.output_buffer = list(self.output_buffer)
        return c

    def _tail(self) -> bytearray:
        if not self._parts or not isinstance(self._parts[-1], bytearray):
            self._parts.append(bytearray())
        return self._parts[-1]

    def observe(self, byte: int) -> None:
        self.output_buffer.clear()
        self._tail().append(byte & 0xFF)

    def observe_slice(self, data: bytes) -> None:
        self.output_buffer.clear()
        self._tail().extend(data)

    def observe_claims(self, segment: ClaimsSegment) -> None:
        """A claims segment, whose bytes are hashed from its array."""
        self.output_buffer.clear()
        self._parts.append(segment)

    def _flush(self) -> None:
        out = parts_hash(self._parts)
        self.output_buffer = list(out)
        self._parts = [bytearray(out)]  # chaining values

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
        (observe_u64(len) then each value as canonical u64-LE).  A
        homogeneous batch (the bench workload has one claim per trace row,
        benches/multi_stark.rs:220-238) enters the buffer as a claims
        segment over its array, which the flush hashes with no byte image,
        no copy and no Python call per claim, reducing the values mod p as
        it reads them.  The array is read when the buffer is hashed or
        read, at the latest at the next sample, and is read-only until then
        (blake3_host.ClaimsSegment)."""
        self.observe_u64(len(claims))
        arr = _claims_rows(claims)
        if arr is not None:
            CLAIMS_ABSORBED["challenger", "array"] += arr.shape[0]
            self.inner.observe_claims(ClaimsSegment(arr, self.F.p))
            return
        CLAIMS_ABSORBED["challenger", "bytes"] += len(claims)
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
