"""K4 (gl_scan): the port's batch inverse, mod-p sum and prefix sum on CPU
tensors against the JAX package's utils (_batch_inv_impl, field_sum,
cumsum), bit-exact, for base and GL2 values, zeros included; and its two
fused entries, the stage-2 chain (against JAX batch_inv + lookup._stage2_scan)
and the sum of inverses (against JAX field_sum of batch_inv), for GL2 and
BB4."""

import numpy as np
import pytest

from multistark_tpu import lookup as jax_lk, utils as jax_utils
from multistark_tpu.fields import device as jax_fd
from multistark_tpu.fields.device import GL2_OPS, GL_OPS
from multistark_tpu_torch import utils
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import GL2_OPS as TGL2, GL_OPS as TGL
from multistark_tpu_torch.fields.host import GOLDILOCKS

SIZES = [1, 5, 300]


def _base(n, seed, rows=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, GOLDILOCKS.p, (rows, n), dtype=np.uint64)
    x[0, :: max(1, n // 3)] = 0  # zeros map to zero in the batch inverse
    return x


def _ext(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, GOLDILOCKS.p, (n, 2), dtype=np.uint64)
    x[:: max(1, n // 4)] = 0
    x[1 % n, 1] = 5  # a nonzero element with a zero base coordinate
    return x


def _te(x):  # (n, 2) host -> (2, n) tensor
    return TGL.from_np(np.ascontiguousarray(x.T), "cpu")


@pytest.mark.parametrize("n", SIZES)
def test_base_batch_inverse_matches_jax(n):
    x = _base(n, n)
    want = np.stack([GL_OPS.to_np(jax_utils._batch_inv_impl(GL_OPS, GL_OPS.from_np(row))) for row in x])
    np.testing.assert_array_equal(fd.to_np(utils.batch_inv(TGL.from_np(x, "cpu"), TGL)), want)


@pytest.mark.parametrize("n", SIZES)
def test_ext_batch_inverse_matches_jax(n):
    x = _ext(n, n)
    want = GL2_OPS.to_np(jax_utils._batch_inv_impl(GL2_OPS, GL2_OPS.from_np(x), axis=0))
    np.testing.assert_array_equal(fd.to_np(utils.batch_inv(_te(x), TGL2)).T, want)


@pytest.mark.parametrize("n", SIZES)
def test_sum_and_cumsum_match_jax(n):
    x = _base(n, 10 + n, rows=3)
    jx = GL_OPS.from_np(x)
    np.testing.assert_array_equal(
        fd.to_np(utils.field_sum(TGL.from_np(x, "cpu"), TGL)), GL_OPS.to_np(jax_utils.field_sum(GL_OPS, jx, axis=-1))
    )
    np.testing.assert_array_equal(
        fd.to_np(utils.cumsum(TGL.from_np(x, "cpu"), TGL)), GL_OPS.to_np(jax_utils.cumsum(GL_OPS, jx, axis=-1))
    )


@pytest.mark.parametrize("n", SIZES)
def test_ext_sum_and_cumsum_match_jax(n):
    x = _ext(n, 20 + n)
    jx = GL2_OPS.from_np(x)
    np.testing.assert_array_equal(
        fd.to_np(utils.field_sum(_te(x), TGL2)), GL2_OPS.to_np(jax_utils.field_sum(GL2_OPS, jx, axis=0))
    )
    np.testing.assert_array_equal(
        fd.to_np(utils.cumsum(_te(x), TGL2)).T, GL2_OPS.to_np(jax_utils.cumsum(GL2_OPS, jx, axis=0))
    )


# --- the fused entries: the stage-2 chain and the sum of inverses -----------------

_EXT = {"GL2": (GL_OPS, GL2_OPS, TGL2), "BB4": (jax_fd.BB_OPS, jax_fd.BB4_OPS, fd.BB4_OPS)}


@pytest.mark.parametrize("L", [1, 13])
@pytest.mark.parametrize("ext", list(_EXT))
def test_stage2_chain_matches_jax_batch_inv_and_stage2_scan(ext, L):
    """utils.stage2_chain (its plain version on a CPU tensor) against JAX
    batch_inv + lookup._stage2_scan on the same messages, multiplicities and
    accumulator, one message zero (it maps to a zero term)."""
    JF, JE, TE = _EXT[ext]
    D, p = JE.D, TE.base.p
    n = 24
    rng = np.random.default_rng(40 + L + D)
    msgs = rng.integers(0, p, (n * L, D), dtype=np.uint64)
    msgs[7] = 0
    mults = rng.integers(0, p, n * L, dtype=np.uint64)
    acc = tuple(int(c) for c in rng.integers(0, p, D, dtype=np.uint64))
    inv = jax_utils.batch_inv(JE, JE.from_np(msgs), axis=0)
    jmat, jtotal = jax_lk._stage2_scan(JF, JE, L, inv, JF.from_np(mults), jax_utils.ext_scalar(JE, acc))
    tmsgs = TE.base.from_np(np.concatenate([msgs.T, mults[None]]), "cpu")
    mat, total = utils.stage2_chain(TE, L, tmsgs, TE.const(acc, "cpu"))
    np.testing.assert_array_equal(fd.to_np(mat), JF.to_np(jmat))
    np.testing.assert_array_equal(fd.to_np(total), [int(JF.to_np(c)) for c in jtotal])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ext", list(_EXT))
def test_inv_sum_matches_jax_field_sum_of_batch_inv(ext, n):
    JF, JE, TE = _EXT[ext]
    rng = np.random.default_rng(70 + n)
    x = rng.integers(0, TE.base.p, (n, JE.D), dtype=np.uint64)
    x[:: max(1, n // 3)] = 0
    want = JE.to_np(jax_utils.field_sum(JE, jax_utils.batch_inv(JE, JE.from_np(x), axis=0), axis=0))
    got = utils.inv_sum(TE.base.from_np(np.ascontiguousarray(x.T), "cpu"), TE)
    np.testing.assert_array_equal(fd.to_np(got), want)
