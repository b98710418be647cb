"""The port's device transcript pieces against the JAX package, on CPU
tensors (their plain versions): the FRI grind and β (K8's function), the
whole-prove duplex (K7's), the device claims accumulator (K9 + K4) and the
FRI fold (K10), each on the same inputs made from a seed with numpy.  All
arithmetic and hashing is exact, so every comparison is equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multistark_tpu import device_transcript as jdt
from multistark_tpu import lookup as jlk
from multistark_tpu.challenger import SerializingChallenger64 as JaxChallenger
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBBConfig, GoldilocksBlake3Config as JaxGLConfig
from multistark_tpu.fields.host import BABYBEAR as JBB, BABYBEAR_EXT4 as JBB4
from multistark_tpu.fields.host import GOLDILOCKS as JF, GOLDILOCKS_EXT2 as JE2
from multistark_tpu_torch import device_transcript as dt
from multistark_tpu_torch import lookup as lk
from multistark_tpu_torch import pcs as tpcs
from multistark_tpu_torch.challenger import SerializingChallenger64
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields.device import BB4_OPS, BB_OPS, GL2_OPS, GL_OPS
from multistark_tpu_torch.fields.host import BABYBEAR_EXT4, GOLDILOCKS, GOLDILOCKS_EXT2

SEED_BYTES = b"seed-bytes-0123456789abcdef-pad!"


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u64s(t: torch.Tensor) -> tuple:
    return tuple(int(v) for v in t.reshape(-1).numpy().view(np.uint64))


# --- K8: grind and β --------------------------------------------------------

@pytest.mark.parametrize("bits", [0, 1, 4, 8])
def test_grind_and_beta_match_jax_and_the_host_challenger(bits):
    cap = np.arange(8, dtype=np.uint32)[None, :] * np.uint32(0x01010101)
    jch = JaxChallenger(JF, JE2)
    jch.observe_bytes(SEED_BYTES)
    jch.sample_ext()  # input buffer = the 32 chaining bytes
    entry = jdt.entry_buffer_words(bytes(jch.inner.input_buffer))
    inp = np.concatenate([entry, cap.reshape(-1)])

    host = jch.clone()
    host.observe_commitment(cap)
    w_host = host.grind(bits)
    beta_host = host.sample_ext()
    w_j, digest_j, found_j = jdt.grind_round(jnp.asarray(inp), bits)
    beta_j, valid_j = jdt.sample_ext_from_digest(digest_j, 2)

    w, ok, beta, digest = dt.fri_grind(_words(inp), bits, 2)
    assert int(ok) == 1 and bool(found_j) and bool(valid_j)
    assert int(w) == w_host == jdt.u64_of_pair(int(w_j[0]), int(w_j[1]))
    assert _u64s(beta) == beta_host == tuple(jdt.u64_of_pair(int(lo), int(hi)) for lo, hi in beta_j)
    assert np.array_equal(digest.numpy().view(np.uint32), np.asarray(digest_j))
    # the port's own host challenger grinds to the same witness
    pch = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2)
    pch.observe_bytes(SEED_BYTES)
    pch.sample_ext()
    pch.observe_commitment(cap)
    assert pch.grind(bits) == w_host and pch.sample_ext() == beta_host


_GRINDS = {}


def _grind_at_length(L: int, bits: int):
    """A duplex input of L words (the chain after a flush, then L - 8 random
    words observed as bytes), the host challenger that holds it and JAX
    grind_round's (w, digest, found) on it, made once per length."""
    if L not in _GRINDS:
        rng = np.random.default_rng(40 + L)
        jch = JaxChallenger(JF, JE2)
        jch.observe_bytes(SEED_BYTES)
        jch.sample_ext()  # input buffer = the 32 chaining bytes
        jch.observe_bytes(rng.integers(0, 1 << 32, L - 8, dtype=np.uint64).astype("<u4").tobytes())
        inp = jdt.entry_buffer_words(bytes(jch.inner.input_buffer))
        assert inp.shape == (L,)
        _GRINDS[L] = inp, jch, jdt.grind_round(jnp.asarray(inp), bits)
    return _GRINDS[L]


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("L", [8, 15, 16, 17, 30])
def test_grind_and_beta_at_every_input_length_and_degree(L, degree):
    """K8's function at duplex inputs of L words (w's low word at the start
    of a block, in its middle, at its last word so that its high word starts
    the next block) and β of D = 1..3 coordinates: the port's grind equals
    JAX grind_round and sample_ext_from_digest, and the host challenger
    grinds the same witness and draws the same β."""
    bits = 4
    inp, jch, (w_j, digest_j, found_j) = _grind_at_length(L, bits)
    beta_j, valid_j = jdt.sample_ext_from_digest(digest_j, degree)
    host = jch.clone()
    w_host = host.grind(bits)
    beta_host = tuple(host.sample_field() for _ in range(degree))

    w, ok, beta, digest = dt.fri_grind(_words(inp), bits, degree)
    assert int(ok) == 1 and bool(found_j) and bool(valid_j)
    assert int(w) == w_host == jdt.u64_of_pair(int(w_j[0]), int(w_j[1]))
    assert tuple(beta.shape) == (degree,)
    assert _u64s(beta) == beta_host == tuple(jdt.u64_of_pair(int(lo), int(hi)) for lo, hi in beta_j)
    assert np.array_equal(digest.numpy().view(np.uint32), np.asarray(digest_j))


def test_draw_layout_and_the_p_boundary():
    digest = (np.arange(8, dtype=np.uint64) * 0x11223344 % (1 << 32)).astype(np.uint32)
    got = dt.digest_draws(_words(digest))
    want = jdt.digest_draws(jnp.asarray(digest))
    for (lo, hi), (jlo, jhi) in zip(got, want):
        assert int(lo) == int(jlo) and int(hi) == int(jhi)
    m = torch.tensor(0xFFFFFFFF)
    assert not bool(dt.draw_lt_p(torch.tensor(1), m))
    assert bool(dt.draw_lt_p(torch.tensor(0), m))
    assert bool(dt.draw_lt_p(torch.tensor(5), torch.tensor(7)))


# --- K7: the duplex -----------------------------------------------------------

def _run_duplex(schedule, seed, with_jax=True):
    """schedule: ('h', nbytes) | ('d', n_u64) | ('cap', k) | ('sample',).
    Returns the draws of the JAX host challenger, the JAX DeviceDuplex and
    the port's DeviceDuplex."""
    rng = np.random.default_rng(seed)
    host, jdd, tdd = JaxChallenger(JF, JE2), jdt.DeviceDuplex(), dt.DeviceDuplex("cpu")
    host_draws, jax_draws, port_draws = [], [], []
    for step in schedule:
        if step[0] == "h":
            data = bytes(rng.integers(0, 256, step[1], dtype=np.uint8))
            host.observe_bytes(data)
            jdd.observe_bytes(data)
            tdd.observe_bytes(data)
        elif step[0] == "d":
            vals = rng.integers(0, JF.p, step[1], dtype=np.uint64)
            for v in vals:
                host.observe_field(int(v))
            words = vals.view(np.uint32)  # (lo, hi) per value, little-endian
            jdd.observe_words_device(jnp.asarray(words))
            tdd.observe_words_device(_words(words))
        elif step[0] == "cap":
            cap = rng.integers(0, 1 << 32, (step[1], 8), dtype=np.uint64).astype(np.uint32)
            host.observe_commitment(cap)
            jdd.observe_cap_device(tuple(jnp.asarray(cap[:, i]) for i in range(8)))
            tdd.observe_cap_device(_words(cap))
        else:
            host_draws.append(host.sample_ext())
            if with_jax:
                jax_draws.append(tuple(jdt.u64_of_pair(int(lo), int(hi)) for lo, hi in jdd.sample_ext(2)))
            port_draws.append(_u64s(tdd.sample_ext(2)))
    assert all(int(v) == 1 for flags in tdd.valids for v in flags)
    return host_draws, (jax_draws if with_jax else host_draws), port_draws


@pytest.mark.parametrize("name, schedule, with_jax", [
    ("single chunk", [("h", 14), ("d", 7), ("sample",), ("cap", 1), ("sample",)], True),
    ("unaligned caps", [("h", 5), ("cap", 2), ("h", 3), ("sample",), ("d", 3), ("sample",)], True),
    ("consecutive samples", [("h", 40), ("sample",), ("sample",), ("h", 8), ("sample",)], True),
    ("multi-chunk claims", [("h", 6), ("cap", 1), ("h", 3000), ("sample",), ("cap", 1), ("d", 2), ("sample",),
                            ("sample",)], False),
    ("cap across a chunk boundary", [("h", 1000), ("cap", 2), ("h", 500), ("sample",)], False),
])
def test_duplex_draws_match_jax_and_the_host_challenger(name, schedule, with_jax):
    """Multi-chunk layouts are held against the host challenger only: the
    JAX DeviceDuplex compiles one program per layout (tens of seconds on the
    CPU each), and tests/test_device_transcript.py pins it to the same host
    challenger on these schedules."""
    host, jax_draws, port = _run_duplex(schedule, seed=len(name), with_jax=with_jax)
    assert port == host == jax_draws


@pytest.mark.parametrize("suffix, pad", [(1024, 0), (5000, 1023), (1100, 1000), (40000, 13)])
def test_duplex_claims_prefix_shapes_match_the_host_challenger(suffix, pad):
    """The β/γ flush's shape at more offsets (host prefix, device cap, a
    large host suffix): chunk CVs and parent levels precomputed on the host,
    the cap's chunks and the root path hashed by K7's function."""
    host, _, port = _run_duplex([("h", pad), ("cap", 1), ("h", suffix), ("sample",), ("cap", 1), ("d", 2),
                                 ("sample",), ("sample",)], seed=suffix + pad, with_jax=False)
    assert port == host


def test_entry_words_match_the_host_buffer():
    rng = np.random.default_rng(6)
    host, tdd = SerializingChallenger64(GOLDILOCKS, GOLDILOCKS_EXT2), dt.DeviceDuplex("cpu")
    data = bytes(rng.integers(0, 256, 36, dtype=np.uint8))
    host.observe_bytes(data)
    tdd.observe_bytes(data)
    host.sample_ext()
    tdd.sample_ext(2)
    assert np.array_equal(tdd.entry_words().numpy().view(np.uint32),
                          dt.entry_buffer_words(bytes(host.inner.input_buffer)))
    cap = rng.integers(0, 1 << 32, (1, 8), dtype=np.uint64).astype(np.uint32)
    host.observe_commitment(cap)
    tdd.observe_cap_device(_words(cap))
    assert np.array_equal(tdd.entry_words().numpy().view(np.uint32),
                          dt.entry_buffer_words(bytes(host.inner.input_buffer)))
    tdd.observe_bytes(b"\x01")
    assert tdd.entry_words() is None  # not word-aligned


# --- K9 + K4: the device claims accumulator --------------------------------------

@pytest.mark.parametrize("n, L", [(40, 4), (300, 1), (64, 0)])
def test_claims_accumulator_device_matches_jax_and_the_host(n, L):
    rng = np.random.default_rng(n + L)
    claims = rng.integers(0, JF.p, (n, L), dtype=np.uint64)
    beta = tuple(int(v) for v in rng.integers(0, JF.p, 2, dtype=np.uint64))
    gamma = tuple(int(v) for v in rng.integers(0, JF.p, 2, dtype=np.uint64))
    got = lk.claims_accumulator_device(GL_OPS, GL2_OPS, claims, GL2_OPS.const(beta, "cpu"),
                                       GL2_OPS.const(gamma, "cpu"))
    jcfg = JaxGLConfig(JaxCommit(log_blowup=1), JaxFri.standard_fast())
    jE, jF = jcfg.ext, jcfg.field
    want = jlk.claims_accumulator_device(
        jF, jE, claims, tuple(jF.from_np(np.uint64(c)) for c in beta), tuple(jF.from_np(np.uint64(c)) for c in gamma)
    )
    want = tuple(int(np.asarray(jF.to_np(c)).reshape(())) for c in want)
    host = lk.claims_accumulator(GOLDILOCKS_EXT2, beta, gamma, claims)
    assert _u64s(got) == want == host


@pytest.mark.parametrize("n, L", [(40, 4), (33, 1)])
def test_babybear_claims_accumulator_device_matches_jax_and_the_host(n, L):
    """BabyBear^4 (the BabyBearPoseidon2 host transcript's accumulator)."""
    rng = np.random.default_rng(7 * n + L)
    claims = rng.integers(0, JBB.p, (n, L), dtype=np.uint64)
    beta = tuple(int(v) for v in rng.integers(0, JBB.p, 4, dtype=np.uint64))
    gamma = tuple(int(v) for v in rng.integers(0, JBB.p, 4, dtype=np.uint64))
    got = lk.claims_accumulator_device(BB_OPS, BB4_OPS, claims, BB4_OPS.const(beta, "cpu"),
                                       BB4_OPS.const(gamma, "cpu"))
    want = jlk.claims_accumulator(JBB4, beta, gamma, claims)
    host = lk.claims_accumulator(BABYBEAR_EXT4, beta, gamma, claims)
    assert _u64s(got) == tuple(want) == host


# --- K10: the FRI fold -------------------------------------------------------------

@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("a_bits", [1, 2])
@pytest.mark.parametrize("absorb", [False, True])
def test_fold_matches_jax_fold_absorb_np(field, a_bits, absorb):
    if field == "goldilocks":
        tcfg = GoldilocksBlake3Config(CommitmentParameters(log_blowup=2), FriParameters.standard_fast(), device="cpu")
        jcfg = JaxGLConfig(JaxCommit(log_blowup=2), JaxFri.standard_fast())
    else:
        tcfg = BabyBearPoseidon2Config(CommitmentParameters(log_blowup=2), FriParameters.standard_fast(),
                                       device="cpu")
        jcfg = JaxBBConfig(JaxCommit(log_blowup=2), JaxFri.standard_fast())
    E, hf = tcfg.ext, tcfg.host_field
    D, log_size, log_max = E.D, 9, 11
    rng = np.random.default_rng(a_bits + 10 * absorb + (field == "babybear"))
    cur = rng.integers(0, hf.p, (1 << log_size, D), dtype=np.uint64)
    beta = rng.integers(0, hf.p, D, dtype=np.uint64)
    ab = rng.integers(0, hf.p, (1 << (log_size - a_bits), D), dtype=np.uint64) if absorb else None
    shift = tcfg.pcs._shift_at(log_max, log_size)

    got = tcfg.pcs._fold_multi(
        E.base.from_np(cur.T, "cpu"), E.base.from_np(beta, "cpu"), log_size, a_bits, log_max,
        None if ab is None else E.base.from_np(ab.T, "cpu"),
    )
    jpcs, jE = jcfg.pcs, jcfg.ext
    want = jpcs._fold_absorb_np(
        jE.from_np(cur), tuple(jE.base.from_np(np.uint64(c)) for c in beta),
        None if ab is None else jE.from_np(ab), log_size, a_bits, shift,
    )
    assert np.array_equal(GL_OPS.to_np(got).T, np.asarray(jE.to_np(want), np.uint64))
    # the kernel's plain version, called directly with the port's tables
    tabs = [tcfg.pcs.x_table_storage(log_size - s, hf.exp_power_of_2(shift, s), inverse=True) for s in range(a_bits)]
    direct = tpcs.fri_fold(E, E.base.from_np(cur.T, "cpu"), E.base.from_np(beta, "cpu"), tabs, hf.inv(2),
                           None if ab is None else E.base.from_np(ab.T, "cpu"))
    assert torch.equal(direct, got)


# --- device ext scalars against (D, n) vectors --------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("scalar_shape", [(2,), (2, 1)])
def test_ext_scalar_broadcasts_against_vectors(op, scalar_shape):
    """A transcript scalar ((D,) or (D, 1)) against a (D, n) vector, either
    side, under the field ops' broadcasting rule, equals the op on the
    scalar expanded to (D, n)."""
    rng = np.random.default_rng(len(op) + len(scalar_shape))
    vec = GL_OPS.from_np(rng.integers(0, JF.p, (2, 33), dtype=np.uint64), "cpu")
    s = GL_OPS.from_np(rng.integers(0, JF.p, 2, dtype=np.uint64), "cpu").reshape(scalar_shape)
    full = s.reshape(2, 1).expand(2, 33).contiguous()
    fn = getattr(GL2_OPS, op)
    assert torch.equal(fn(vec, s), fn(vec, full))
    assert torch.equal(fn(s, vec), fn(full, vec))
    base = GL_OPS.from_np(rng.integers(0, JF.p, 33, dtype=np.uint64), "cpu")
    assert torch.equal(GL2_OPS.scale(s.reshape(2), base), GL2_OPS.scale(full, base))
