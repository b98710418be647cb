"""The Fiat-Shamir transcript of the GoldilocksBlake3 configuration: a
duplex over BLAKE3 on bytes (observe appends to the input buffer and clears
the output; a sample hashes the input when the output is empty, feeds the
digest back as the next input and pops bytes from the end of the digest)
with u64 little-endian observation and rejection-sampled field draws.  The
claims are observed length-prefixed: u64(number of claims), then per claim
u64(its length) and each value as a canonical field element."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .blake3 import hash_bytes
from .field_host import HostExtField, HostField


class ByteHashChallenger:
    def __init__(self):
        self.input_buffer = bytearray()
        self.output_buffer = []

    def clone(self) -> "ByteHashChallenger":
        c = ByteHashChallenger()
        c.input_buffer = bytearray(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def observe_slice(self, data: bytes) -> None:
        self.output_buffer.clear()
        self.input_buffer.extend(data)

    def sample(self) -> int:
        if not self.output_buffer:
            out = hash_bytes(bytes(self.input_buffer))
            self.input_buffer.clear()
            self.output_buffer = list(out)
            self.input_buffer.extend(out)
        return self.output_buffer.pop()


class SerializingChallenger64:
    def __init__(self, field: HostField, ext: HostExtField, inner: ByteHashChallenger = None):
        self.F = field
        self.E = ext
        self.inner = inner or ByteHashChallenger()

    def clone(self) -> "SerializingChallenger64":
        return SerializingChallenger64(self.F, self.E, self.inner.clone())

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
        """cap: (k, 8) uint32 digest words, observed as their bytes."""
        self.observe_bytes(np.ascontiguousarray(np.atleast_2d(cap), "<u4").tobytes())

    def observe_claims(self, claims: np.ndarray) -> None:
        """claims: an (n, L) uint64 array."""
        arr = np.asarray(claims, np.uint64) % np.uint64(self.F.p)
        self.observe_u64(arr.shape[0])
        buf = np.empty((arr.shape[0], arr.shape[1] + 1), "<u8")
        buf[:, 0] = arr.shape[1]
        buf[:, 1:] = arr
        self.observe_bytes(buf.tobytes())

    def sample_field(self) -> int:
        while True:
            v = int.from_bytes(bytes(self.inner.sample() for _ in range(8)), "little")
            if v < self.F.p:
                return v

    def sample_ext(self) -> Tuple[int, ...]:
        return tuple(self.sample_field() for _ in range(self.E.D))

    def sample_bits(self, bits: int) -> int:
        return self.sample_field() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        """Observe a proof-of-work witness; true when the next draw has its
        low `bits` bits zero."""
        self.observe_field(witness)
        return self.sample_bits(bits) == 0
