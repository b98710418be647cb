"""K3 (blake3_merkle), the FRI entry: a FRI round's committed matrix and
its leaf digests (`hash.blake3.fri_leaves`, on CPU tensors its plain
version) against the JAX package's `_ext_slices_matrix` (pcs.py:1336) and
`Blake3FieldHasher.hash_matrices` (merkle.py:44), bit-exact, for arity 2 to
16 over GL2 vectors of 2^3 to 2^8 positions; and the level's cap
(`TwoAdicFriPcs._fri_level`) against the JAX commit of the same matrix."""

import jax
import numpy as np
import pytest

from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.fields.device import GL2_OPS, GL_OPS
from multistark_tpu.merkle import Blake3FieldHasher as JaxHasher, MerkleMmcs as JaxMmcs
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import GoldilocksBlake3Config
from multistark_tpu_torch.fields.device import GL_OPS as TGL
from multistark_tpu_torch.fields.host import GOLDILOCKS
from multistark_tpu_torch.hash import blake3 as b3
from multistark_tpu_torch.merkle import digest_layer_to_np

FRI = dict(log_final_poly_len=0, max_log_arity=4, num_queries=4, commit_proof_of_work_bits=1,
           query_proof_of_work_bits=1)
CASES = [(1, 3), (1, 8), (2, 5), (3, 8), (4, 4), (4, 6)]  # (a_bits, log2 positions)


def _vector(log_n: int, seed: int) -> np.ndarray:
    """(N, 2) GL2 values: element i's coordinates in row i."""
    return np.random.default_rng(seed).integers(0, GOLDILOCKS.p, (1 << log_n, 2), dtype=np.uint64)


def _jax_matrix(jpcs, vec: np.ndarray, a_bits: int):
    ext = GL2_OPS.from_np(vec)
    A = 1 << a_bits
    return jpcs._ext_slices_matrix([jax.tree.map(lambda t, j=j: t[j::A], ext) for j in range(A)])


@pytest.mark.parametrize("a_bits, log_n", CASES)
def test_fri_leaves_match_jax_matrix_and_digests(a_bits, log_n):
    vec = _vector(log_n, 40 + 8 * a_bits + log_n)
    jmat = _jax_matrix(JaxConfig(JaxCommit(log_blowup=1), JaxFri(**FRI)).pcs, vec, a_bits)
    mat, leaves = b3.fri_leaves(TGL.from_np(np.ascontiguousarray(vec.T), "cpu"), a_bits)
    np.testing.assert_array_equal(TGL.to_np(mat), GL_OPS.to_np(jmat))
    want = np.asarray(JaxHasher(GL_OPS).hash_matrices([jmat]), np.uint32).T  # (8, n) -> (n, 8)
    np.testing.assert_array_equal(leaves.numpy().view(np.uint32), want)


@pytest.mark.parametrize("a_bits, cap_height", [(1, 0), (2, 1), (4, 0)])
def test_fri_round_cap_matches_jax_commit(a_bits, cap_height):
    log_n = 7
    vec = _vector(log_n, 90 + a_bits)
    jcfg = JaxConfig(JaxCommit(log_blowup=1, cap_height=cap_height), JaxFri(**FRI))
    jcap, _ = JaxMmcs(JaxHasher(GL_OPS), cap_height).commit([_jax_matrix(jcfg.pcs, vec, a_bits)])
    tcfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=1, cap_height=cap_height),
                                  FriParameters(**FRI), device="cpu")
    _, cap, data = tcfg.pcs._fri_level(TGL.from_np(np.ascontiguousarray(vec.T), "cpu"), log_n, a_bits)
    np.testing.assert_array_equal(digest_layer_to_np(cap), np.asarray(jcap, np.uint32))
    assert data.dims == [(2 << a_bits, 1 << (log_n - a_bits))]
