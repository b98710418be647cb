"""The claims segment of the port's BLAKE3 transcripts: a homogeneous batch
of claims kept as its (n, L) uint64 array and hashed by the host C helper
straight from the array, 16 chunks at a time (csrc/host/b3.c `msb3_parts`).

Each piece is held against the bytes the claims stand for (u64(L), then the
values mod p, per row), built here with NumPy: the C entry against the
scalar `msb3_chunk_cvs` and the JAX package's own BLAKE3 (its csrc/b3.c);
`SerializingChallenger64` against the same challenger fed those bytes;
`DeviceDuplex` against the host challenger; a 2^8-row U32Add prove against
its golden digest, with `CLAIMS_ABSORBED` showing the array path on both
the duplex and the replay."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from multistark_tpu.hash.blake3 import blake3_hash as jax_blake3
from multistark_tpu_torch import device_transcript as dt, dt_prover, native
from multistark_tpu_torch.challenger import CLAIMS_ABSORBED, SerializingChallenger64
from multistark_tpu_torch.fields.host import GOLDILOCKS, GOLDILOCKS_EXT2
from multistark_tpu_torch.hash.blake3_host import (ClaimsSegment, blake3_hash, parts_bytes, parts_chunk_cvs,
                                                   parts_hash)

P = GOLDILOCKS.p
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _claims(rng, n: int, L: int) -> np.ndarray:
    """(n, L) uint64 with values >= p mixed in (p itself, p + k, 2^64 - 1)."""
    arr = rng.integers(0, 1 << 63, (n, L), dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, (n, L),
                                                                                         dtype=np.uint64)
    flat = arr.reshape(-1)
    big = rng.choice(flat.shape[0], min(flat.shape[0], 3), replace=False)
    flat[big] = np.asarray([P, P + 12345, (1 << 64) - 1], np.uint64)[: big.shape[0]]
    return arr


def _claims_bytes(arr: np.ndarray) -> bytes:
    n, L = arr.shape
    rows = np.empty((n, L + 1), "<u8")
    rows[:, 0] = L
    rows[:, 1:] = arr % np.uint64(P)
    return rows.tobytes()


def _scalar_chunk_cvs(data: bytes) -> np.ndarray:
    import ctypes

    out = np.empty((max(1, -(-len(data) // 1024)), 8), np.uint32)
    native.lib().msb3_chunk_cvs(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


# --- the C entry -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 15, 16, 17, 4351, (1 << 12) + 3])
@pytest.mark.parametrize("L", [1, 4, 45])
@pytest.mark.parametrize("offset", [0, 1, 7, 1023, 1029])
def test_parts_match_the_bytes_they_stand_for(offset, L, n):
    """Host bytes, a claims segment starting `offset` bytes in, a run of
    zero bytes and more host bytes: the chunk chaining values equal the
    scalar msb3_chunk_cvs of the built bytes, the digest msb3_hash's and the
    JAX package's, and the parts' bytes the built ones."""
    rng = np.random.default_rng(1000 * offset + 10 * L + n)
    arr = _claims(rng, n, L)
    pre, post = bytes(rng.integers(0, 256, offset, dtype=np.uint8)), b"tail-bytes"
    parts = [pre, ClaimsSegment(arr, P), 12, post]
    data = pre + _claims_bytes(arr) + bytes(12) + post
    assert bytes(parts_bytes(parts)) == data
    assert bytes(parts_bytes(parts, offset + 5, offset + 2000)) == data[offset + 5 : offset + 2000]
    assert np.array_equal(parts_chunk_cvs(parts), _scalar_chunk_cvs(data))
    assert parts_hash(parts) == blake3_hash(data) == jax_blake3(data)


@pytest.mark.parametrize("length", [0, 1, 1024, 1025, 2 * 1024 + 3, 7 * 1024, 15 * 1024 + 9, 16 * 1024 - 1, 16 * 1024,
                                    16 * 1024 + 1, 33 * 1024 + 5, 1 << 20])
def test_messages_of_every_length_keep_the_digest(length):
    """msb3_hash is the parts' stream over one part: one chunk is the root,
    up to 16 keep their chaining values on the stack, whole groups of 16
    take the lanes.  The same digest as the JAX package's scalar BLAKE3."""
    data = bytes(np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8))
    assert blake3_hash(data) == parts_hash([data]) == jax_blake3(data)


def test_the_build_names_no_cpu_and_picks_a_clone_at_load(tmp_path, monkeypatch):
    """A build passes no -march: the library the other tests load, built
    by the same command, runs on any x86-64 host, and the loader picks the
    lane clone (native.lanes).  The spy records the command in place of
    running the compiler."""
    calls = []

    def spy(args, **kwargs):
        calls.append(list(args))
        open(args[args.index("-o") + 1], "wb").close()

    monkeypatch.setattr(native.subprocess, "run", spy)
    native.build(str(tmp_path), force=True)
    assert len(calls) == 1 and calls[0][0] == "cc"
    assert not any(a.startswith("-march") or a.startswith("-mcpu") or a.startswith("-mtune") for a in calls[0])
    assert native.lanes() in ("avx512f", "avx2", "default")


# --- SerializingChallenger64 --------------------------------------------------------

def _pair(n: int, L: int, seed: int):
    """(claims, a challenger that observed them, one fed their bytes)."""
    rng = np.random.default_rng(seed)
    arr = _claims(rng, n, L)
    seg, raw = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2), SerializingChallenger64(GOLDILOCKS,
                                                                                          GOLDILOCKS_EXT2)
    for ch in (seg, raw):
        ch.observe_bytes(b"prefix")
    seg.observe_claims(arr)
    raw.observe_u64(n)
    raw.observe_bytes(_claims_bytes(arr))
    return arr, seg, raw


@pytest.mark.parametrize("n, L", [(40, 4), (4351, 45), ((1 << 12) + 3, 1)])
def test_challenger_segment_draws_what_the_bytes_draw(n, L):
    """Draws, a clone's draws, the bytes a reader gets, and a grind right
    after the claims (its prefix past the helper's 4 KiB: the scalar search
    over clones), then more draws."""
    CLAIMS_ABSORBED.clear()
    arr, seg, raw = _pair(n, L, n + L)
    assert dict(CLAIMS_ABSORBED) == {("challenger", "array"): n}
    assert seg.clone().sample_ext() == raw.clone().sample_ext()
    assert bytes(seg.clone().inner.input_buffer) == bytes(raw.inner.input_buffer)
    assert seg.grind(3) == raw.grind(3)
    assert [seg.sample_ext() for _ in range(3)] == [raw.sample_ext() for _ in range(3)]
    seg.observe_claims(arr[:, :0])  # L = 0
    raw.observe_u64(n)
    raw.observe_bytes(np.zeros(n, "<u8").tobytes())
    assert seg.sample_ext() == raw.sample_ext()


def test_a_segment_holds_its_array_read_only_until_it_is_hashed():
    """The claims are not copied: while a buffer (or its clone) holds them
    a write raises, and the flush that hashes the last holder gives the
    array back writeable."""
    arr, seg, raw = _pair(40, 4, 7)
    other = seg.clone()
    with pytest.raises(ValueError, match="read-only"):
        arr[0, 0] = 1
    first = seg.sample_ext()
    assert first == raw.sample_ext()
    assert not arr.flags.writeable  # the clone still holds it
    assert other.sample_ext() == first
    assert arr.flags.writeable
    arr[0, 0] = 1


def test_few_or_ragged_claims_take_the_bytes():
    CLAIMS_ABSORBED.clear()
    few, ragged = [[1, 2, 3]] * 31, [[1, 2], [3]] * 20
    for claims in (few, ragged):
        seg, raw = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2), SerializingChallenger64(GOLDILOCKS,
                                                                                              GOLDILOCKS_EXT2)
        seg.observe_claims(claims)
        raw.observe_u64(len(claims))
        for claim in claims:
            raw.observe_u64(len(claim))
            for v in claim:
                raw.observe_field(v)
        assert seg.sample_ext() == raw.sample_ext()
    assert dict(CLAIMS_ABSORBED) == {("challenger", "bytes"): 71}


# --- DeviceDuplex -------------------------------------------------------------------

def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("pad, n, L", [(5, 40, 4), (1000, 17, 45), (3, 4351, 45)])
def test_duplex_flush_with_a_claims_segment_between_device_runs(pad, n, L):
    """Device words, host bytes, the claims segment, device words in the
    segment's last chunk: K7's plain version over the host parts' chaining
    values gives the draws of the host challenger fed the same bytes."""
    rng = np.random.default_rng(pad + n)
    host, tdd = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2), dt.DeviceDuplex("cpu")
    cap = rng.integers(0, 1 << 32, (1, 8), dtype=np.uint64).astype(np.uint32)
    host.observe_commitment(cap)
    tdd.observe_cap_device(_words(cap))
    data = bytes(rng.integers(0, 256, pad, dtype=np.uint8))
    host.observe_bytes(data)
    tdd.observe_bytes(data)
    arr = _claims(rng, n, L)
    host.observe_u64(n)
    host.observe_bytes(_claims_bytes(arr))
    got = dt_prover._observe_claims_dd(tdd, np.ascontiguousarray(arr), P)
    assert np.array_equal(got, arr % np.uint64(P))
    vals = rng.integers(0, P, 3, dtype=np.uint64)
    for v in vals:
        host.observe_field(int(v))
    tdd.observe_words_device(_words(vals))
    draws = [tuple(int(v) for v in tdd.sample_ext(2).numpy().view(np.uint64))]
    draws.append(tuple(int(v) for v in tdd.sample_ext(2).numpy().view(np.uint64)))
    assert draws == [host.sample_ext(), host.sample_ext()]
    assert tdd.entry_words() is tdd.chain


# --- a prove ------------------------------------------------------------------------

def test_u32_add_2e8_prove_takes_the_array_path_on_both_sides():
    """The device-transcript prove at 2^8 rows (the bench's FRI parameters)
    gives fixtures/torch_port_golden.json's digest, its duplex and its
    replay each absorbing the 256 claims as an array."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_port_golden as golden

    import multistark_tpu_torch as mt
    from multistark_tpu_torch.config import CommitmentParameters, FriParameters
    from multistark_tpu_torch.configs import GoldilocksBlake3Config
    from multistark_tpu_torch.prover import prove_multiple_claims
    from multistark_tpu_torch.system import System, SystemWitness
    from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

    with open(golden.GOLDEN_PATH) as f:
        want = json.load(f)["goldilocks_blake3"]["8"]
    config = GoldilocksBlake3Config(CommitmentParameters(**golden.BENCH_COMMIT), FriParameters(**golden.BENCH_FRI),
                                    device="cpu")
    system, key = System.new(config, u32_add_system_inputs())
    traces, claims = mt.witness_from_numpy(*u32_add_witness(golden.bench_witness(8), 1 << 8), config.device)
    CLAIMS_ABSORBED.clear()
    dt.FALLBACKS.clear()
    data = prove_multiple_claims(system, key, SystemWitness.from_stage_1(traces, system, key), claims).to_bytes()
    assert not dt.FALLBACKS
    assert dict(CLAIMS_ABSORBED) == {("duplex", "array"): 256, ("challenger", "array"): 256}
    assert {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)} == want
