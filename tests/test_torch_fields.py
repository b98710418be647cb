"""K1 (gl_arith): the port's Goldilocks / GL2 ops (GL_OPS / GL2_OPS) on CPU
tensors (their plain PyTorch versions) against the JAX package's GL_OPS /
GL2_OPS, bit-exact, on random values and on the edge values 0, 1, p-1, 2^32
and 2^32-1."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from multistark_tpu.fields.device import GL2_OPS, GL_OPS
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.device import GL2_OPS as TGL2, GL_OPS as TGL

P = TGL.p
EDGES = np.asarray([0, 1, P - 1, 1 << 32, (1 << 32) - 1], np.uint64)


def _operands(seed: int, n: int = 400):
    """Random canonical values plus every pair of edge values."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), np.repeat(EDGES, len(EDGES))])
    b = np.concatenate([rng.integers(0, P, n, dtype=np.uint64), np.tile(EDGES, len(EDGES))])
    return a, b


def _t(x):
    return TGL.from_np(x, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_base_binary_ops_match_jax(op):
    a, b = _operands(1)
    want = GL_OPS.to_np(getattr(GL_OPS, op)(GL_OPS.from_np(a), GL_OPS.from_np(b)))
    got = fd.to_np(getattr(TGL, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, want)


def test_neg_and_inverse_match_jax():
    a, _ = _operands(2, n=60)
    np.testing.assert_array_equal(fd.to_np(TGL.neg(_t(a))), GL_OPS.to_np(GL_OPS.neg(GL_OPS.from_np(a))))
    np.testing.assert_array_equal(fd.to_np(TGL.inv(_t(a))), GL_OPS.to_np(GL_OPS.inv(GL_OPS.from_np(a))))
    assert fd.to_np(TGL.inv(_t(np.zeros(1, np.uint64))))[0] == 0  # 0 maps to 0


def test_pow_and_broadcast_scalar():
    a, b = _operands(3, n=50)
    e = 0xDEADBEEF12345
    np.testing.assert_array_equal(
        fd.to_np(TGL.pow(_t(a), e)), GL_OPS.to_np(GL_OPS.pow_const(GL_OPS.from_np(a), e))
    )
    s = TGL.const(int(b[0]), "cpu")
    np.testing.assert_array_equal(
        fd.to_np(TGL.mul(_t(a), s)), GL_OPS.to_np(GL_OPS.mul(GL_OPS.from_np(a), GL_OPS.const(int(b[0]), a.shape)))
    )


def _ext_pair(seed: int, n: int = 200):
    a, b = _operands(seed, n)
    rng = np.random.default_rng(seed + 100)
    a1, b1 = rng.permutation(a), rng.permutation(b)
    return np.stack([a, a1], axis=-1), np.stack([b, b1], axis=-1)  # (N, 2)


def _te(x):  # (N, 2) host -> coordinate-major (2, N) tensor
    return TGL.from_np(np.ascontiguousarray(x.T), "cpu")


def _ne(t):
    return fd.to_np(t).T


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ext_binary_ops_match_jax(op):
    a, b = _ext_pair(4)
    want = GL2_OPS.to_np(getattr(GL2_OPS, op)(GL2_OPS.from_np(a), GL2_OPS.from_np(b)))
    got = _ne(getattr(TGL2, op)(_te(a), _te(b)))
    np.testing.assert_array_equal(got, want)


def test_ext_square_scale_inverse_match_jax():
    a, b = _ext_pair(5, n=60)
    ja, jb = GL2_OPS.from_np(a), GL2_OPS.from_np(b)
    np.testing.assert_array_equal(_ne(TGL2.square(_te(a))), GL2_OPS.to_np(GL2_OPS.square(ja)))
    np.testing.assert_array_equal(
        _ne(TGL2.scale(_te(a), _t(b[:, 0]))), GL2_OPS.to_np(GL2_OPS.scale(ja, jb[0]))
    )
    np.testing.assert_array_equal(_ne(TGL2.inv(_te(a))), GL2_OPS.to_np(GL2_OPS.inv(ja)))


def test_ext_scalar_broadcasts_by_period():
    a, b = _ext_pair(6, n=30)
    z = TGL2.const((int(b[0, 0]), int(b[0, 1])), "cpu")
    got = _ne(TGL2.mul(_te(a), z))
    want = GL2_OPS.to_np(GL2_OPS.mul(GL2_OPS.from_np(a), GL2_OPS.from_np(np.broadcast_to(b[0], a.shape))))
    np.testing.assert_array_equal(got, want)
    # a (3, 1) column broadcasts (one element per row); a middle axis does not
    col = np.arange(1, 4, dtype=np.uint64).reshape(3, 1)
    mat = np.arange(12, dtype=np.uint64).reshape(3, 4)
    np.testing.assert_array_equal(TGL.to_np(TGL.mul(_t(mat), _t(col))), mat * col)
    with pytest.raises(ValueError):
        TGL.mul(torch.zeros((2, 3, 4), dtype=torch.int64), torch.zeros((2, 1, 1), dtype=torch.int64))


def test_unsupported_device_raises():
    with pytest.raises(ValueError):
        TGL.add(torch.zeros(2, dtype=torch.int64, device="meta"), torch.zeros(2, dtype=torch.int64, device="meta"))


def test_import_leaves_jax_out():
    code = (
        "import sys, multistark_tpu_torch, multistark_tpu_torch.prover, multistark_tpu_torch.configs, "
        "multistark_tpu_torch.serialization, multistark_tpu_torch.test_circuits, multistark_tpu_torch.profiling, "
        "multistark_tpu_torch.fixtures; "
        "assert 'jax' not in sys.modules and 'multistark_tpu' not in sys.modules"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=repo)


def _k1_cases():
    powers = [("powers", f, c) for f in ("GL2", "BB4") for c in (1, 2, 3, 7, 64, 100, 257)]
    periods = [("period", f, s) for f in ("GL", "BB") for s in ("matrix x row", "scalar", "full", "column")]
    return powers + periods


@pytest.mark.parametrize("kind, field, arg", _k1_cases(), ids=lambda v: str(v).replace(" ", "_"))
def test_k1_powers_and_period_broadcasts_match_jax(kind, field, arg):
    """K1 / K5 on CPU tensors (the plain versions): ExtOps.powers against the
    JAX package's `_host_ext_powers` (pcs.py:1327), and every base and
    extension op at the period shapes the prove uses ((w, n) x (n,), a
    scalar, two full operands, a (w, 1) column: the opening points against
    the coset's x) against the JAX package's field ops."""
    from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
    from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
    from multistark_tpu.fields.device import BB4_OPS as JBB4, BB_OPS as JBB
    from multistark_tpu_torch.fields.device import BB4_OPS as TBB4, BB_OPS as TBB

    gl = field.startswith("GL")
    TF, TE, JF, JE = (TGL, TGL2, GL_OPS, GL2_OPS) if gl else (TBB, TBB4, JBB, JBB4)
    rng = np.random.default_rng(zlib.crc32(f"{kind} {field} {arg}".encode()))
    if kind == "powers":
        fri = JaxFri(log_final_poly_len=0, max_log_arity=1, num_queries=4, commit_proof_of_work_bits=1,
                     query_proof_of_work_bits=1)
        jpcs = (JaxGL if gl else JaxBB)(JaxCommit(log_blowup=1), fri).pcs
        alpha = tuple(int(v) for v in rng.integers(0, TF.p, TE.D, dtype=np.uint64))
        want = np.asarray(jpcs._host_ext_powers(alpha, arg), np.uint64).reshape(arg, TE.D)
        got = TE.powers(TE.const(alpha, "cpu"), arg)
        assert tuple(got.shape) == (TE.D, arg)
        np.testing.assert_array_equal(fd.to_np(got).T, want)
        return
    w, n = 3, 16
    out_shape = (w, n)
    shape_b = {"matrix x row": (n,), "scalar": (), "full": (w, n), "column": (w, 1)}[arg]
    a = rng.integers(0, TF.p, out_shape, dtype=np.uint64)
    b = rng.integers(0, TF.p, shape_b, dtype=np.uint64)
    bb = np.ascontiguousarray(np.broadcast_to(b, out_shape))
    ja, jb = JF.from_np(a), JF.from_np(bb)
    for op in ("add", "sub", "mul"):
        want = JF.to_np(getattr(JF, op)(ja, jb))
        np.testing.assert_array_equal(fd.to_np(getattr(TF, op)(TF.from_np(a, "cpu"), TF.from_np(b, "cpu"))), want)
    np.testing.assert_array_equal(fd.to_np(TF.neg(TF.from_np(a, "cpu"))), JF.to_np(JF.neg(ja)))
    np.testing.assert_array_equal(fd.to_np(TF.inv(TF.from_np(a, "cpu"))), JF.to_np(JF.inv(ja)))
    D = TE.D
    ea = rng.integers(0, TF.p, out_shape + (D,), dtype=np.uint64)  # JAX: coordinates last
    eb = rng.integers(0, TF.p, shape_b + (D,), dtype=np.uint64)
    jea, jeb = JE.from_np(ea), JE.from_np(np.ascontiguousarray(np.broadcast_to(eb, out_shape + (D,))))
    tea = TF.from_np(np.ascontiguousarray(np.moveaxis(ea, -1, 0)), "cpu")
    teb = TF.from_np(np.ascontiguousarray(np.moveaxis(eb, -1, 0)), "cpu")
    for op in ("add", "sub", "mul"):
        got = np.moveaxis(fd.to_np(getattr(TE, op)(tea, teb)), 0, -1)
        np.testing.assert_array_equal(got, JE.to_np(getattr(JE, op)(jea, jeb)))
    got = np.moveaxis(fd.to_np(TE.scale(tea, TF.from_np(b, "cpu"))), 0, -1)
    np.testing.assert_array_equal(got, JE.to_np(JE.scale(jea, jb)))
    np.testing.assert_array_equal(np.moveaxis(fd.to_np(TE.inv(tea)), 0, -1), JE.to_np(JE.inv(jea)))
