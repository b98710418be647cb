"""K2 (ntt_stage): the port's LDE transforms on CPU tensors against the JAX
package's NttEngine, bit-exact, at log_n 4..10 over w=3 polynomials."""

import numpy as np
import pytest

from multistark_tpu.fields.device import GL_OPS
from multistark_tpu.ntt import get_engine
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import GL_OPS as TGL
from multistark_tpu_torch.fields.host import GOLDILOCKS
from multistark_tpu_torch.ntt import NttEngine

LOG_NS = list(range(4, 11))
W = 3


def _mat(log_n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, GOLDILOCKS.p, (W, 1 << log_n), dtype=np.uint64)


@pytest.fixture(scope="module")
def engines():
    return get_engine(GL_OPS), NttEngine(TGL, GOLDILOCKS, "cpu")


@pytest.mark.parametrize("log_n", LOG_NS)
def test_coset_lde_bitrev_matches_jax(engines, log_n):
    jax_eng, eng = engines
    m = _mat(log_n, log_n)
    shift = GOLDILOCKS.mul(GOLDILOCKS.generator, 5)
    want = GL_OPS.to_np(jax_eng.coset_lde_bitrev(GL_OPS.from_np(m), log_n, 2, shift))
    got = fd.to_np(eng.coset_lde_bitrev(TGL.from_np(m, "cpu"), log_n, 2, shift))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_lde_bitrev_from_coeffs_matches_jax(engines, log_n):
    jax_eng, eng = engines
    m = _mat(log_n, 100 + log_n)
    want = GL_OPS.to_np(jax_eng.lde_bitrev_from_coeffs(GL_OPS.from_np(m), log_n + 2))
    got = fd.to_np(eng.lde_bitrev_from_coeffs(TGL.from_np(m, "cpu"), log_n + 2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_icoset_from_natural_matches_jax(engines, log_n):
    jax_eng, eng = engines
    m = _mat(log_n, 200 + log_n)
    shift = GOLDILOCKS.generator
    want = GL_OPS.to_np(jax_eng.icoset_from_natural(GL_OPS.from_np(m), log_n, shift))
    got = fd.to_np(eng.icoset_from_natural(TGL.from_np(m, "cpu"), log_n, shift))
    np.testing.assert_array_equal(got, want)


def test_prefix_is_the_same_shift_subcoset(engines):
    """The first 2^k stored entries of a bit-reversed LDE, un-reversed, are
    the evaluations on the same-shift coset of size 2^k."""
    jax_eng, eng = engines
    log_n = 6
    m = _mat(log_n, 7)
    lde = eng.coset_lde_bitrev(TGL.from_np(m, "cpu"), log_n, 2, GOLDILOCKS.generator)
    want = GL_OPS.to_np(jax_eng.prefix_to_natural(GL_OPS.from_np(fd.to_np(lde)), log_n + 1))
    np.testing.assert_array_equal(fd.to_np(eng.prefix_to_natural(lde, log_n + 1)), want)
    unshifted = eng.coset_lde_bitrev(TGL.from_np(m, "cpu"), log_n, 2, 1)
    np.testing.assert_array_equal(fd.to_np(eng.prefix_to_natural(unshifted, log_n)), m)  # H_n itself
