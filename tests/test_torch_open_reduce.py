"""K13 (reduced_open) and K12 (bary_eval) per height on the CPU against the
JAX package, exact (tolerance zero: everything is mod p), for GL2 and BB4.

K13: the port's per-height plain version (pcs.reduced_open_height_plain,
which a CPU tensor takes through pcs.reduced_open_height) equals JAX
pcs._ro_kernel summed over the height's matrices, as the JAX package's
merged program (_ro_all_kern) sums them, at LDE heights 2^3 and 2^6: one
matrix at one point; three matrices at two points (the bench's 2^20 height
in small); four matrices whose point sets differ (the bench's 2^10 height:
the quotient matrix at ζ only); and the same with a running sum added.

K12: the claimed evaluations of one trace height (pcs `_eval_height`: the
batch inverse, then pcs.bary_eval_height, whose plain version a CPU tensor
takes) equal JAX pcs._eval_kernel per matrix, at trace heights 2^3 to 2^8:
one matrix at one point; several matrices of different widths at two
points, their point sets differing; stored prefixes shorter than their
matrices (the stored LDE) and equal to them (the gathered prefix of the
sharded path).  And `_claimed_evaluations` of a small prove of the bench
system, as the prover calls it, equals JAX pcs._eval_kernel on every
matrix it opens."""

import numpy as np
import pytest

import multistark_tpu_torch as mt

from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.utils import ext_scalar
from multistark_tpu_torch import pcs as tpcs
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.prover import prove_multiple_claims
from multistark_tpu_torch.system import System, SystemWitness
from multistark_tpu_torch.test_circuits import u32_add_system_inputs, u32_add_witness

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


# --- K12: the claimed evaluations of one trace height ------------------------------

# name: (log trace height, log LDE rows stored (the trace height: a gathered prefix), [(width, the matrix's
# points as indices into the height's points)], number of points)
EVAL_CASES = {
    "one matrix at one point": (3, 5, [(3, (0,))], 1),
    "three matrices at two points, the quotient at one": (6, 8, [(3, (0, 1)), (1, (0, 1)), (2, (0,))], 2),
    "four matrices, point sets differ": (5, 7, [(1, (0, 1)), (3, (1, 0)), (2, (1,)), (2, (0,))], 2),
    "the bench's 2^8 height: four matrices": (8, 10, [(1, (0, 1)), (1, (0, 1)), (2, (0, 1)), (2, (0,))], 2),
    "gathered prefixes (rows = the trace height)": (4, 4, [(2, (0, 1)), (3, (1,))], 2),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_claimed_evaluations_per_height_match_jax(configs, case):
    """Every matrix of the height at each of its points through one
    `_eval_height` call, against JAX _eval_kernel on that matrix alone."""
    jcfg, tcfg = configs
    log_n, log_rows, mats_spec, n_points = EVAL_CASES[case]
    hf, D, F, JF = jcfg.host_field, jcfg.extension_params.degree, tcfg.field, jcfg.field
    rng = np.random.default_rng(100 + log_n + 7 * len(mats_spec))
    zs = [tuple(int(c) for c in _rand(rng, hf.p, D)) for _ in range(n_points)]
    points = [(k, tcfg.ext.const(z, "cpu")) for k, z in enumerate(zs)]
    mats = [_rand(rng, hf.p, w, 1 << log_rows) for w, _ in mats_spec]
    got = tcfg.pcs._eval_height(log_n, [F.from_np(m, "cpu") for m in mats], [list(pts) for _, pts in mats_spec],
                                points)
    assert len(got) == len(mats)
    for mat, (w, pts), vals in zip(mats, mats_spec, got):
        want = jcfg.pcs._eval_kernel(JF.from_np(mat), tuple(ext_scalar(jcfg.ext, zs[p]) for p in pts), log_n)
        assert len(vals) == len(pts)
        for v, jv in zip(vals, want):
            assert tuple(v.shape) == (D, w)
            np.testing.assert_array_equal(fd.to_np(v), np.stack([JF.to_np(c) for c in jv]))


def test_bary_eval_height_rejects_bad_openings(configs):
    """A point index beyond the points, a matrix shorter than the prefix or
    opened at no point, or inverses of the wrong length raise."""
    _, tcfg = configs
    F, E = tcfg.field, tcfg.ext
    rng = np.random.default_rng(4)
    mat = F.from_np(_rand(rng, F.p, 2, 8), "cpu")
    inv, x = F.from_np(_rand(rng, F.p, E.D, 8), "cpu"), F.from_np(_rand(rng, F.p, 8), "cpu")
    z = F.from_np(_rand(rng, F.p, E.D), "cpu")
    for mats, openings, invs in (([mat], [[1]], [inv]), ([mat[:, :4]], [[0]], [inv]), ([mat], [[]], [inv]),
                                 ([mat], [[0]], [inv[:, :4]])):
        with pytest.raises(ValueError):
            tpcs.bary_eval_height(E, mats, 3, openings, [z], invs, x, 1, 1)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_claimed_evaluations_of_a_small_prove_match_jax(config):
    """The bench system (U32Add at 2^4 rows, ByteTable at 2^8) proved with
    `prove_multiple_claims`: every matrix that `_claimed_evaluations` opens
    (preprocessed, stage 1, stage 2 and quotient rounds, grouped by trace
    height across rounds), at each of its points, against JAX
    _eval_kernel on the same stored LDE and points."""
    jax_cls, torch_cls = CONFIGS[config]
    fri = FriParameters(log_final_poly_len=0, max_log_arity=1, num_queries=4, commit_proof_of_work_bits=1,
               query_proof_of_work_bits=1)
    jcfg = jax_cls(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**vars(fri)))
    tcfg = torch_cls(CommitmentParameters(log_blowup=2, cap_height=0), fri, device="cpu")
    system, key = System.new(tcfg, u32_add_system_inputs())
    rng = np.random.default_rng(11)
    n = 1 << 4
    pairs = list(zip(rng.integers(0, 1 << 32, n).tolist(), rng.integers(0, 1 << 32, n).tolist()))
    traces, claims = mt.witness_from_numpy(*u32_add_witness(pairs, n), "cpu")
    pcs = tcfg.pcs
    seen = []

    def capture(rounds):
        vals = tpcs.TwoAdicFriPcs._claimed_evaluations(pcs, rounds)
        seen.append((rounds, vals))
        return vals

    pcs._claimed_evaluations = capture
    prove_multiple_claims(system, key, SystemWitness.from_stage_1(traces, system, key), claims)
    ((rounds, vals),) = seen
    JF, D = jcfg.field, jcfg.extension_params.degree
    opened = 0
    for (data, points_list), round_vals in zip(rounds, vals):
        for m_idx, points in enumerate(points_list):
            if not points:
                continue
            zs = tuple(ext_scalar(jcfg.ext, tuple(int(c) for c in fd.to_np(z))) for _, z in points)
            want = jcfg.pcs._eval_kernel(JF.from_np(fd.to_np(data.mmcs_data.mats[m_idx])), zs,
                                         data.log_trace_heights[m_idx])
            for v, jv in zip(round_vals[m_idx], want):
                np.testing.assert_array_equal(fd.to_np(v), np.stack([JF.to_np(c) for c in jv]))
                opened += 1
    assert opened >= 8 and {ln for data, _ in rounds for ln in data.log_trace_heights} == {4, 8}
