"""K2 (ntt_stage): the port's LDE transforms on CPU tensors against the JAX
package's NttEngine, bit-exact, at log_n 4..10 over w=3 polynomials; and
the multi-stage pass plan (K2 passes of at most pass_max stages above a K14
tile: the DIF's tail, the DIT's head) against the JAX DIF and DIT for both
fields."""

import numpy as np
import pytest

from multistark_tpu.fields.device import BB_OPS, GL_OPS
from multistark_tpu.ntt import get_engine
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import BB_OPS as TBB, GL_OPS as TGL
from multistark_tpu_torch.fields.host import BABYBEAR, GOLDILOCKS
from multistark_tpu_torch.ntt import NttEngine
from multistark_tpu_torch.ntt import ntt as ntt_module
from multistark_tpu_torch.ntt.ntt import PASS_MAX, PASS_STAGES, pass_plan

LOG_NS = list(range(4, 11))
W = 3


def _mat(log_n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, GOLDILOCKS.p, (W, 1 << log_n), dtype=np.uint64)


@pytest.fixture(scope="module")
def engines():
    return get_engine(GL_OPS), NttEngine(TGL, GOLDILOCKS, "cpu")


FIELDS = {"gl": (GL_OPS, TGL, GOLDILOCKS), "bb": (BB_OPS, TBB, BABYBEAR)}


@pytest.fixture(scope="module")
def field_engines():
    return {name: (get_engine(jf), NttEngine(tf, host, "cpu")) for name, (jf, tf, host) in FIELDS.items()}


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


@pytest.mark.parametrize("pass_max", [1, 3, PASS_MAX])
@pytest.mark.parametrize("log_n", [4, 7, 10])
@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_passes_match_jax(field_engines, monkeypatch, field, dif, log_n, pass_max):
    """A DIF (K2 passes, then K14's tail of 2^2) or a DIT (K14's head of
    2^2, then K2 passes) against the JAX package's, forward at odd log_n and
    inverse at even: 2, 5 and 8 stages above the tile, so with 3 or 6 stages
    per pass the count is not a multiple of the pass size."""
    jf, tf, host = FIELDS[field]
    jax_eng, eng = field_engines[field]
    monkeypatch.setattr(ntt_module, "PASS_STAGES", pass_max)
    m = np.random.default_rng(300 + log_n).integers(0, host.p, (W, 1 << log_n), dtype=np.uint64)
    inverse = log_n % 2 == 0
    want = jf.to_np((jax_eng._dif if dif else jax_eng._dit)(jf.from_np(m), log_n, inverse))
    got = fd.to_np((eng._dif if dif else eng._dit)(tf.from_np(m, "cpu"), log_n, inverse, tile_log=2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top, bottom, pass_max, want", [
    (20, 8, PASS_STAGES, [(17, 4), (13, 4), (9, 4)]),  # the stage-1 LDE at 2^18 rows above its 2^8 tile
    (20, 7, PASS_STAGES, [(16, 5), (12, 4), (8, 4)]),  # the stage-2 LDE above its 2^7 tile: 13 stages
    (18, 11, PASS_STAGES, [(15, 4), (12, 3)]),  # the quotient iDFT above its 2^11 DIT head
    (12, 0, PASS_MAX, [(7, 6), (1, 6)]),
    (8, 2, 3, [(6, 3), (3, 3)]),
    (5, 0, 1, [(5, 1), (4, 1), (3, 1), (2, 1), (1, 1)]),
    (9, 9, 6, []),
])
def test_pass_plan(top, bottom, pass_max, want):
    """The fewest passes of at most pass_max stages, as even as they come,
    top pass first, covering stages bottom+1..top exactly."""
    plan = pass_plan(top, bottom, pass_max)
    assert plan == want
    stages = [s for s_lo, r in plan for s in range(s_lo + r - 1, s_lo - 1, -1)]
    assert stages == list(range(top, bottom, -1))


@pytest.mark.parametrize("log_n", [1, 4, 7, 10])
@pytest.mark.parametrize("transform", ["dft_natural", "idft_natural", "coset_eval_bitrev"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_natural_order_transforms_match_jax(field_engines, field, transform, log_n):
    """dft_natural, idft_natural and coset_eval_bitrev (shift: the field's
    generator) against the JAX engine's, bit for bit (tests/test_ntt.py pins
    the JAX side against naive evaluation); idft_natural undoes
    dft_natural."""
    jax_eng, eng = field_engines[field]
    jf, tf, host = FIELDS[field]
    m = np.random.default_rng(300 + log_n).integers(0, host.p, (W, 1 << log_n), dtype=np.uint64)
    args = (host.generator,) if transform == "coset_eval_bitrev" else ()
    want = jf.to_np(getattr(jax_eng, transform)(jf.from_np(m), log_n, *args))
    got = getattr(eng, transform)(tf.from_np(m, "cpu"), log_n, *args)
    np.testing.assert_array_equal(fd.to_np(got), want)
    if transform == "dft_natural":
        np.testing.assert_array_equal(fd.to_np(eng.idft_natural(got, log_n)), m)
