"""K10 (fri_fold) and K9 (claims_fp) after their redesign, on CPU tensors
(their plain versions), against the JAX package on the same inputs made
from a seed with numpy; all arithmetic and hashing is exact, so every
comparison is equality.

K10: `pcs.fri_fold_level`, one fold round written as the next level's
matrix and leaves, against JAX `_fold_absorb_np` (pcs.py:1353), then
`_ext_slices_matrix` (:1336) and the JAX hasher's `hash_matrices`, from the
level's committed matrix and from its vector.  K9: the claims accumulator
from the (n, L) claims as uploaded, against the JAX and the port's host
accumulators, and with a zero message among the claims against JAX
`claims_accumulator_device` (which maps it to zero)."""

import jax
import numpy as np
import pytest

from multistark_tpu import lookup as jlk
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBBConfig, GoldilocksBlake3Config as JaxGLConfig
from multistark_tpu.merkle import Blake3FieldHasher as JaxHasher
from multistark_tpu_torch import lookup as lk
from multistark_tpu_torch import pcs as tpcs
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields.host import BABYBEAR_EXT4, GOLDILOCKS_EXT2
from multistark_tpu_torch.merkle import Blake3FieldHasher

LOG_MAX = 11  # the fold start the shifts are taken from
# (field, a_bits, next_a_bits, log2 positions of the level, absorb)
FOLD_CASES = [
    ("goldilocks", 1, 1, 9, False),
    ("goldilocks", 1, 1, 6, True),
    ("goldilocks", 1, 2, 8, True),
    ("goldilocks", 2, 1, 7, False),
    ("goldilocks", 1, 0, 5, True),  # the last round: the (D, M) final vector, no leaves
    ("babybear", 2, 1, 7, True),  # the matrix only (K6 hashes it)
]


def _configs(field: str):
    commit, fri = dict(log_blowup=2), dict(log_final_poly_len=0, max_log_arity=2, num_queries=4,
                                           commit_proof_of_work_bits=1, query_proof_of_work_bits=1)
    if field == "goldilocks":
        return (GoldilocksBlake3Config(CommitmentParameters(**commit), FriParameters(**fri), device="cpu"),
                JaxGLConfig(JaxCommit(**commit), JaxFri(**fri)))
    return (BabyBearPoseidon2Config(CommitmentParameters(**commit), FriParameters(**fri), device="cpu"),
            JaxBBConfig(JaxCommit(**commit), JaxFri(**fri)))


def _jax_matrix(jcfg, ext, a_bits: int):
    A = 1 << a_bits
    return jcfg.pcs._ext_slices_matrix([jax.tree.map(lambda t, j=j: t[j::A], ext) for j in range(A)])


@pytest.mark.parametrize("field, a_bits, next_a, log_size, absorb", FOLD_CASES)
def test_fri_fold_level_matches_jax_fold_slices_and_leaves(field, a_bits, next_a, log_size, absorb):
    tcfg, jcfg = _configs(field)
    E, F, hf, jE = tcfg.ext, tcfg.field, tcfg.host_field, jcfg.ext
    D = E.D
    rng = np.random.default_rng(7 * a_bits + next_a + log_size + 100 * absorb)
    cur = rng.integers(0, hf.p, (1 << log_size, D), dtype=np.uint64)  # element i's coordinates in row i
    beta = rng.integers(0, hf.p, D, dtype=np.uint64)
    ab = rng.integers(0, hf.p, (1 << (log_size - a_bits), D), dtype=np.uint64) if absorb else None
    shift = tcfg.pcs._shift_at(LOG_MAX, log_size)

    folded = jcfg.pcs._fold_absorb_np(jE.from_np(cur), tuple(jE.base.from_np(np.uint64(c)) for c in beta),
                                      None if ab is None else jE.from_np(ab), log_size, a_bits, shift)
    jmat_in = jcfg.field.to_np(_jax_matrix(jcfg, jE.from_np(cur), a_bits))
    hasher = Blake3FieldHasher() if field == "goldilocks" else None
    args = (F.from_np(beta, "cpu"), tcfg.pcs.inv_x_even(log_size, shift), hf.inv(2), a_bits, next_a,
            None if ab is None else F.from_np(np.ascontiguousarray(ab.T), "cpu"))
    mat, leaves = tpcs.fri_fold_level(E, F.from_np(jmat_in, "cpu"), *args, hasher=hasher)
    vec_mat, vec_leaves = tpcs.fri_fold_level(E, F.from_np(np.ascontiguousarray(cur.T), "cpu"), *args, hasher=hasher)
    assert (mat == vec_mat).all()  # the level's matrix and its vector fold alike
    if next_a == 0:
        assert leaves is None and vec_leaves is None
        np.testing.assert_array_equal(F.to_np(mat), np.asarray(jE.to_np(folded), np.uint64).T)
        return
    jmat = _jax_matrix(jcfg, folded, next_a)
    np.testing.assert_array_equal(F.to_np(mat), jcfg.field.to_np(jmat))
    if hasher is None:
        assert leaves is None
        return
    want = np.asarray(JaxHasher(jcfg.field).hash_matrices([jmat]), np.uint32).T  # (8, n) -> (n, 8)
    np.testing.assert_array_equal(leaves.numpy().view(np.uint32), want)
    assert (leaves == vec_leaves).all()


def test_fri_layout_matches_jax_slices():
    """a_bits = 0: the BabyBear first level's vector laid out as its matrix."""
    tcfg, jcfg = _configs("babybear")
    hf = tcfg.host_field
    cur = np.random.default_rng(3).integers(0, hf.p, (1 << 6, 4), dtype=np.uint64)
    mat, leaves = tpcs.fri_fold_level(tcfg.ext, tcfg.field.from_np(np.ascontiguousarray(cur.T), "cpu"), None, None,
                                      0, 0, 2)
    assert leaves is None
    np.testing.assert_array_equal(tcfg.field.to_np(mat),
                                  jcfg.field.to_np(_jax_matrix(jcfg, jcfg.ext.from_np(cur), 2)))


# --- K9: the claims accumulator ------------------------------------------------------

@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("n, L, zero", [(40, 4, False), (300, 1, False), (64, 0, False), (40, 4, True)])
def test_claims_acc_matches_jax_and_the_host(field, n, L, zero):
    """zero: β = -fingerprint(claim 3), so claim 3's message is zero and
    contributes zero, as in the JAX device accumulator's batch inverse
    (the host accumulators raise on it and take the other claims)."""
    tcfg, jcfg = _configs(field)
    he = GOLDILOCKS_EXT2 if field == "goldilocks" else BABYBEAR_EXT4
    D, p = tcfg.ext.D, tcfg.host_field.p
    rng = np.random.default_rng(n + 10 * L + 1000 * zero + (field == "babybear"))
    claims = rng.integers(0, p, (n, L), dtype=np.uint64)
    gamma = tuple(int(v) for v in rng.integers(0, p, D, dtype=np.uint64))
    beta = tuple(int(v) for v in rng.integers(0, p, D, dtype=np.uint64))
    if zero:
        beta = he.neg(lk.fingerprint(he, gamma, [int(v) for v in claims[3]]))
    F, E = tcfg.field, tcfg.ext
    got = lk.claims_accumulator_device(F, E, claims, E.const(beta, "cpu"), E.const(gamma, "cpu"))
    others = np.delete(claims, 3, axis=0) if zero else claims
    host = lk.claims_accumulator(he, beta, gamma, others)
    if zero:
        jF, jE = jcfg.field, jcfg.ext
        want = jlk.claims_accumulator_device(jF, jE, claims, tuple(jF.from_np(np.uint64(c)) for c in beta),
                                             tuple(jF.from_np(np.uint64(c)) for c in gamma))
        want = tuple(int(np.asarray(jF.to_np(c)).reshape(())) for c in want)
    else:
        want = tuple(jlk.claims_accumulator(jcfg.host_ext, beta, gamma, claims))
    assert tuple(int(v) for v in F.to_np(got)) == want == host
    # the plain version of K9 called directly on the row-major claims
    direct = lk.claims_acc_plain(E, F.from_np(claims, "cpu"), E.const(beta, "cpu"), E.const(gamma, "cpu"))
    assert (direct == got).all()
