"""K13 (reduced_open) per LDE height on the CPU against the JAX package,
exact (tolerance zero: everything is mod p): the port's per-height plain
version (pcs.reduced_open_height_plain, which a CPU tensor takes through
pcs.reduced_open_height) equals JAX pcs._ro_kernel summed over the
height's matrices, as the JAX package's merged program (_ro_all_kern) sums
them, for GL2 and BB4, at LDE heights 2^3 and 2^6: one matrix at one
point; three matrices at two points (the bench's 2^20 height in small);
four matrices whose point sets differ (the bench's 2^10 height: the
quotient matrix at ζ only); and the same with a running sum added."""

import numpy as np
import pytest

from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.utils import ext_scalar
from multistark_tpu_torch import pcs as tpcs
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd

CONFIGS = {
    "goldilocks_blake3": (JaxGL, GoldilocksBlake3Config),
    "babybear_poseidon2": (JaxBB, BabyBearPoseidon2Config),
}
# name: (log LDE height, [(width, the matrix's points as indices into the height's points)], number of points)
CASES = {
    "one matrix at one point": (3, [(3, (0,))], 1),
    "three matrices at two points": (6, [(4, (0, 1)), (5, (0, 1)), (2, (0,))], 2),
    "four matrices, point sets differ": (6, [(1, (0, 1)), (3, (1, 0)), (2, (0, 1)), (2, (1,))], 2),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def configs(request):
    jax_cls, torch_cls = CONFIGS[request.param]
    fri = FriParameters.standard_fast()
    jcfg = jax_cls(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**vars(fri)))
    tcfg = torch_cls(CommitmentParameters(log_blowup=2, cap_height=0), fri, device="cpu")
    return jcfg, tcfg


def _rand(rng, p, *shape):
    return rng.integers(0, p, shape, dtype=np.uint64)


_JAX = {}


def _case(jcfg, tcfg, case):
    """The case's operands on the port's side and the JAX contributions of
    its matrices summed ((D, N) numpy), made once per (config, case)."""
    key = (jcfg.host_field.name, case)
    if key not in _JAX:
        _JAX[key] = _make_case(jcfg, tcfg, case)
    return _JAX[key]


def _make_case(jcfg, tcfg, case):
    log_lde, mats_spec, n_points = CASES[case]
    hf, he, D = jcfg.host_field, jcfg.host_ext, jcfg.extension_params.degree
    F, E, JF, JE = tcfg.field, tcfg.ext, jcfg.field, jcfg.ext
    N = 1 << log_lde
    rng = np.random.default_rng(log_lde + 10 * n_points)
    zs = [tuple(int(c) for c in _rand(rng, hf.p, D)) for _ in range(n_points)]
    alpha = tuple(int(c) for c in _rand(rng, hf.p, D))
    count = 5 + sum(w * len(pts) for w, pts in mats_spec)
    apow_host = [he.one]
    for _ in range(count - 1):
        apow_host.append(he.mul(apow_host[-1], alpha))
    apows = F.from_np(np.asarray(apow_host, np.uint64).T.copy(), "cpu")  # (D, count)
    x = tcfg.pcs.x_table_storage(log_lde, hf.generator)
    invs = [E.inv(tpcs._ext_minus_base(F, E, E.const(z, "cpu"), x)) for z in zs]

    mats, openings, want, off = [], [], None, 5
    for w, pts in mats_spec:
        mat = _rand(rng, hf.p, w, N)
        vals = [_rand(rng, hf.p, D, w) for _ in pts]
        offs = [off + k * w for k in range(len(pts))]
        off += w * len(pts)
        mats.append(F.from_np(mat, "cpu"))
        openings.append([(p, o, F.from_np(v, "cpu")) for p, o, v in zip(pts, offs, vals)])
        ap = np.asarray(apow_host[:w], np.uint64)
        contrib = jcfg.pcs._ro_kernel(
            JF.from_np(mat), tuple(tuple(JF.from_np(v[d]) for d in range(D)) for v in vals),
            tuple(ext_scalar(JE, zs[p]) for p in pts), tuple(JF.from_np(ap[:, d]) for d in range(D)),
            tuple(ext_scalar(JE, he.neg(apow_host[o])) for o in offs), log_lde,
        )
        want = contrib if want is None else JE.add(want, contrib)
    return mats, apows, openings, invs, np.stack([JF.to_np(c) for c in want]), _rand(rng, hf.p, D, N)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_reduced_open_height_matches_jax(configs, case, add):
    """The height's reduced opening, α offsets laid out as the prover lays
    them (each matrix's points in turn, after a first offset of 5), against
    the JAX contributions of its matrices summed; with add, into a running
    sum."""
    jcfg, tcfg = configs
    F, E, D, N = tcfg.field, tcfg.ext, jcfg.extension_params.degree, 1 << CASES[case][0]
    mats, apows, openings, invs, want_np, before = _case(jcfg, tcfg, case)
    if add:
        want_np = fd.to_np(E.add(F.from_np(before, "cpu"), F.from_np(want_np, "cpu")))
    got = tpcs.reduced_open_height(E, mats, apows, openings, invs, F.from_np(before, "cpu") if add else None)
    assert tuple(got.shape) == (D, N)
    np.testing.assert_array_equal(fd.to_np(got), want_np)
    plain = tpcs.reduced_open_height_plain(E, mats, apows, openings, invs, F.from_np(before, "cpu") if add else None)
    np.testing.assert_array_equal(fd.to_np(plain), want_np)


def test_reduced_open_height_rejects_bad_openings(configs):
    """A point index beyond the inverses, an offset beyond the α powers or a
    matrix opened at no point raises before any launch."""
    _, tcfg = configs
    F, E = tcfg.field, tcfg.ext
    rng = np.random.default_rng(3)
    mat = F.from_np(_rand(rng, F.p, 2, 8), "cpu")
    apows = F.from_np(_rand(rng, F.p, E.D, 4), "cpu")
    inv = F.from_np(_rand(rng, F.p, E.D, 8), "cpu")
    vals = F.from_np(_rand(rng, F.p, E.D, 2), "cpu")
    for openings in ([[(1, 0, vals)]], [[(0, 4, vals)]], [[]]):
        with pytest.raises(ValueError):
            tpcs.reduced_open_height(E, [mat], apows, openings, [inv])
