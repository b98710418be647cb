"""The port's workload circuits and witness builders
(multistark_tpu_torch/test_circuits/byte_operations.py and blake3_circuit.py,
the host compression of hash/blake3_host.py) against the JAX package's on
the same inputs: circuit definitions term for term, traces and claims
exactly."""

import os
import sys

import numpy as np
import pytest

from multistark_tpu.hash import blake3 as jax_b3
from multistark_tpu.test_circuits import blake3_circuit as jax_b3c, byte_operations as jax_bo
from multistark_tpu_torch.hash import blake3_host
from multistark_tpu_torch.test_circuits import blake3_circuit as b3c, byte_operations as bo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_port_golden as golden  # noqa: E402


def assert_same_inputs(got, want):
    """Two CircuitInputs (port, JAX) describe the same circuit: widths, the
    constraints and lookups term for term (their dataclass reprs), the
    preprocessed table."""
    assert got.main_width == want.main_width
    assert repr(got.constraints) == repr(want.constraints)
    assert repr(got.ext_constraints) == repr(want.ext_constraints)
    assert repr(got.lookups) == repr(want.lookups)
    if want.preprocessed is None:
        assert got.preprocessed is None
    else:
        assert got.preprocessed.dtype == want.preprocessed.dtype
        assert np.array_equal(got.preprocessed, want.preprocessed)


def assert_same_witness(got, want):
    (traces, claims), (jtraces, jclaims) = got, want
    assert len(traces) == len(jtraces)
    for i, (t, j) in enumerate(zip(traces, jtraces)):
        assert t.dtype == j.dtype == np.uint64 and t.shape == j.shape, i
        assert np.array_equal(t, j), f"trace {i}"
    assert isinstance(claims, np.ndarray) and claims.dtype == np.uint64
    assert claims.shape == (len(jclaims), 45)
    assert np.array_equal(claims, np.asarray(jclaims, np.uint64).reshape(-1, 45))


# --- byte_operations ------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_byte_operations_inputs_match_jax(bits):
    got, want = bo.byte_operations_inputs(bits), jax_bo.byte_operations_inputs(bits)
    assert_same_inputs(got, want)
    assert got.preprocessed.shape == (1 << (2 * bits), 5)
    assert [int(lk.args[0].value) for lk in got.lookups] == [bo.XOR_CHAN, bo.AND_CHAN, bo.OR_CHAN, bo.RANGE_CHAN]
    assert (bo.XOR_CHAN, bo.AND_CHAN, bo.OR_CHAN, bo.RANGE_CHAN) == (
        jax_bo.XOR_CHAN, jax_bo.AND_CHAN, jax_bo.OR_CHAN, jax_bo.RANGE_CHAN)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("claims", ["ragged", "seeded"])
def test_byte_operations_witness_matches_jax(bits, claims):
    """tests/test_byte_operations.py's ragged claims (a RANGE claim of three
    values, a duplicate) and 2^12 seeded claims over XOR/AND/OR, as a list
    of lists and (when rectangular) as an (n, 4) array."""
    c = golden.byte_operations_claims(0 if claims == "ragged" else 1 << 12, bits, seed=bits)
    rows = c if isinstance(c, list) else c.tolist()
    want = jax_bo.byte_operations_witness(rows, bits)
    got = bo.byte_operations_witness(rows, bits)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if not isinstance(c, list):
        assert np.array_equal(bo.byte_operations_witness(c, bits), want)
        assert int(want.sum()) == 1 << 12
    else:
        assert int(want[(5 << bits) + 9, 0]) == 2  # the duplicate XOR claim


@pytest.mark.parametrize("claims", [[[99, 1, 2, 3]], [[10, 1, 2, 3], [14, 0, 0]]])
def test_byte_operations_unknown_channel_raises(claims):
    with pytest.raises(ValueError, match="unknown channel"):
        jax_bo.byte_operations_witness(claims, 4)
    with pytest.raises(ValueError, match="unknown channel"):
        bo.byte_operations_witness(claims, 4)


def test_byte_operations_wrong_result_is_refused():
    with pytest.raises(AssertionError):
        bo.byte_operations_witness([[bo.AND_CHAN, 7, 12, 5]], 4)


# --- the host compression -----------------------------------------------------------

def test_compress_and_compress_batch_match_jax():
    rng = np.random.default_rng(11)
    n = 40
    cv = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
    block = rng.integers(0, 1 << 32, (n, 16), dtype=np.uint64)
    counter = rng.integers(0, 1 << 40, n, dtype=np.uint64)
    blen, flags = rng.integers(0, 65, n), rng.integers(0, 16, n)
    batch = blake3_host.compress_batch(cv, block, counter, blen, flags)
    assert batch.shape == (n, 16) and batch.dtype == np.uint32
    for i in range(n):
        args = (cv[i].tolist(), block[i].tolist(), int(counter[i]), int(blen[i]), int(flags[i]))
        want = jax_b3.compress(*args)
        assert blake3_host.compress(*args) == want
        assert batch[i].tolist() == want
    for data in (b"", b"abc", bytes(range(64))):
        assert blake3_host._words_of(data) == jax_b3._words_of(data)


# --- the BLAKE3 family ---------------------------------------------------------------

@pytest.mark.parametrize("limb_bits", [4, 8])
def test_blake3_system_inputs_match_jax(limb_bits):
    got, want = b3c.blake3_system_inputs(limb_bits), jax_b3c.blake3_system_inputs(limb_bits)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert_same_inputs(g, w)
    k = 32 // limb_bits
    widths = [269, 21, 3 * k + 2, 3 * k + 1]
    for r in (16, 12, 8, 7):
        widths.append(-(-r // limb_bits) + -(-(32 - r) // limb_bits) + 1)
    assert [c.main_width for c in got] == widths + [1, 1]
    assert len(got[0].lookups) == 73 and len(got[0].lookups[-1].args) == 45
    assert (b3c.RANGE_CHAN, b3c.LXOR_CHAN, b3c.ADD_CHAN, b3c.XOR_CHAN, b3c.ROT_CHANS, b3c.G_CHAN,
            b3c.COMPRESS_CHAN) == (jax_b3c.RANGE_CHAN, jax_b3c.LXOR_CHAN, jax_b3c.ADD_CHAN, jax_b3c.XOR_CHAN,
                                   jax_b3c.ROT_CHANS, jax_b3c.G_CHAN, jax_b3c.COMPRESS_CHAN)


@pytest.mark.parametrize("size", [0, 65, 1024, 2148, 4096])
def test_hasher_compressions_match_jax(size):
    """The recorded compressions in the JAX invocation order: each chunk's
    blocks in turn, the left subtree before the right, each parent after
    its two children."""
    data = bytes(i % 251 for i in range(size))
    digest, comps = b3c.blake3_hasher_compressions(data)
    assert (digest, comps) == jax_b3c.blake3_hasher_compressions(data)
    assert digest == blake3_host.blake3_hash(data)
    if size > 1024:
        assert comps[-1][4] == blake3_host.PARENT | blake3_host.ROOT


def one_block_compression(data: bytes):
    """tests/test_blake3_circuit.py's single compression of blake3(data)."""
    words = [int.from_bytes(data.ljust(64, b"\0")[4 * i : 4 * i + 4], "little") for i in range(16)]
    return (list(blake3_host.IV), words, 0, len(data),
            blake3_host.CHUNK_START | blake3_host.CHUNK_END | blake3_host.ROOT)


@pytest.mark.parametrize("limb_bits", [4, 8])
@pytest.mark.parametrize("case", ["3 chunks + 77 bytes", "one block", "no compression"])
def test_blake3_witness_matches_jax(limb_bits, case):
    """Traces and claims of the 10-circuit witness: the hasher-driven one on
    tests/test_blake3_circuit.py's 3·1024 + 77-byte message, and
    blake3_witness on its single-block compression and on none (every trace
    one padded row; the rotations keep their widths)."""
    if case == "3 chunks + 77 bytes":
        data = bytes((7 * i) % 256 for i in range(3 * 1024 + 77))
        digest, *got = b3c.blake3_hasher_witness(data, limb_bits)
        jdigest, *want = jax_b3c.blake3_hasher_witness(data, limb_bits)
        assert digest == jdigest == blake3_host.blake3_hash(data)
        assert b"".join(int(w).to_bytes(4, "little") for w in got[1][-1, -16:-8]) == digest
        _, comps = b3c.blake3_hasher_compressions(data)
        assert_same_witness(b3c.blake3_witness(comps, limb_bits), want)
    else:
        comps = [one_block_compression(b"multistark blake3 circuit family")] if case == "one block" else []
        got, want = b3c.blake3_witness(comps, limb_bits), jax_b3c.blake3_witness(comps, limb_bits)
    assert_same_witness(got, want)
    assert [t.shape[1] for t in got[0]] == [c.main_width for c in b3c.blake3_system_inputs(limb_bits)]


def test_blake3_witness_refuses_a_wrong_compression(monkeypatch):
    """The cross-check against the host compression catches a G step that
    disagrees with it."""
    rotr = b3c._rotr
    monkeypatch.setattr(b3c, "_rotr", lambda x, r: rotr(x, 11) if r == 12 else rotr(x, r))
    with pytest.raises(AssertionError, match="disagrees with host blake3"):
        b3c.blake3_witness([one_block_compression(b"abc")], 4)


def test_pad_rows_matches_jax():
    rows = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    for r in (rows, rows[:1], []):
        assert np.array_equal(b3c._pad_rows(r, 3), jax_b3c._pad_rows(r, 3))
    assert b3c._pad_rows(np.asarray(rows, np.uint64), 3).shape == (4, 3)


def test_xor_subfamily_witness_matches_the_jax_test():
    """scripts/torch_port_golden.py's NumPy witness of the limb-xor + U32Xor
    subfamily equals tests/test_blake3_subfamily.py's `xor_witness`."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_blake3_subfamily as sub

    traces, claims = golden.xor_subfamily_witness(sub.LIMB_BITS, golden.XOR_PAIRS)
    jtraces, jclaims = sub.xor_witness(golden.XOR_PAIRS)
    assert claims == jclaims
    for t, j in zip(traces, jtraces):
        assert t.dtype == j.dtype and np.array_equal(t, j)
