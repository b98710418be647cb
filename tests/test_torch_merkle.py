"""K3 (blake3_merkle): the port's Merkle commitments on CPU tensors against
the JAX package's MerkleMmcs, bit-exact: mixed heights with injection, caps,
rows wider than one BLAKE3 chunk, openings, and the sub-cap guard."""

import numpy as np
import pytest

from multistark_tpu.fields.device import GL_OPS
from multistark_tpu.merkle import Blake3FieldHasher as JaxHasher, MerkleMmcs as JaxMmcs
from multistark_tpu_torch.fields.device import GL_OPS as TGL
from multistark_tpu_torch.fields.host import GOLDILOCKS
from multistark_tpu_torch.hash import blake3 as b3
from multistark_tpu_torch.hash.blake3_host import native_hash_words
from multistark_tpu_torch.merkle import Blake3FieldHasher, MerkleMmcs


def _mats(dims, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GOLDILOCKS.p, (w, h), dtype=np.uint64) for w, h in dims]


def _both(mats_np, cap_height):
    jax_cap, jax_data = JaxMmcs(JaxHasher(GL_OPS), cap_height).commit([GL_OPS.from_np(m) for m in mats_np])
    cap, data = MerkleMmcs(Blake3FieldHasher(), cap_height).commit([TGL.from_np(m, "cpu") for m in mats_np])
    return (jax_cap, jax_data), (cap, data)


MIXED = [
    [(3, 64)],
    [(3, 64), (2, 16)],  # injection below the leaves
    [(1, 64), (4, 64), (2, 32), (5, 4)],  # two leaf matrices, two injections
    [(14, 256), (1, 1024)],  # the bench's shape: ByteTable taller than U32Add
]


@pytest.mark.parametrize("cap_height", [0, 2])
@pytest.mark.parametrize("case", range(len(MIXED)))
def test_mixed_height_caps_match_jax(case, cap_height):
    (jax_cap, _), (cap, data) = _both(_mats(MIXED[case], case), cap_height)
    assert cap.shape == (1 << cap_height, 8) and cap.dtype == np.uint32
    np.testing.assert_array_equal(cap, jax_cap)
    assert len(data.layers) == data.log_max - cap_height + 1


@pytest.mark.parametrize("width", [128, 130, 300, 520])
def test_rows_wider_than_a_chunk(width):
    """1024-byte rows are one chunk; wider ones take the BLAKE3 chunk tree."""
    m = _mats([(width, 8)], width)[0]
    got = b3.hash_rows([TGL.from_np(m, "cpu")]).numpy().view(np.uint32)
    words = np.stack([m & np.uint64(0xFFFFFFFF), m >> np.uint64(32)], axis=1).reshape(2 * width, 8)
    want = native_hash_words(words.T.astype(np.uint32))
    np.testing.assert_array_equal(got, want)
    (jax_cap, _), (cap, _) = _both([m], 0)
    np.testing.assert_array_equal(cap, jax_cap)


def test_openings_match_jax():
    mats = _mats([(3, 64), (2, 16)], 9)
    (_, jax_data), (_, data) = _both(mats, 1)
    idx = np.asarray([0, 5, 63, 31, 5])
    jax_open = JaxMmcs(JaxHasher(GL_OPS), 1).open_batch(jax_data, idx)
    got = MerkleMmcs(Blake3FieldHasher(), 1).open_batch(data, idx)
    for a, b in zip(got, jax_open):
        np.testing.assert_array_equal(a.path, b.path)
        for ra, rb in zip(a.opened_rows, b.opened_rows):
            np.testing.assert_array_equal(ra, rb)


def test_sub_cap_matrices_are_rejected():
    mats = _mats([(2, 64), (1, 4)], 3)
    with pytest.raises(AssertionError):
        JaxMmcs(JaxHasher(GL_OPS), 3).commit([GL_OPS.from_np(m) for m in mats])
    with pytest.raises(ValueError, match="below cap size"):
        MerkleMmcs(Blake3FieldHasher(), 3).commit([TGL.from_np(m, "cpu") for m in mats])
