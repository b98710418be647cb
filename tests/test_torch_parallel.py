"""The port's row-sharded prove (multistark_tpu_torch/parallel.py,
ntt/distributed.py) against the JAX package, bit for bit: two groups of
gloo ranks on the CPU (D = 4 and D = 2, started together with the spawn
method, joined through a file:// store) run the cases of
`multistark_tpu_torch.spmd_cases` while this process computes the JAX side
(the sharded DIF and LDE on the conftest 8-device mesh, the MMCS commit,
stage 2, the DFT reference and a small prove).  Each rank's blocks are
concatenated in rank order; every rank's proof bytes must be the JAX ones
(the golden 2^10 entries of fixtures/torch_port_golden.json for the bench
workload; GoldilocksBlake3 at D = 2 through the entry point
`parallel.dryrun_multichip(2, device="cpu")`).  Tolerance: exact
(arithmetic mod p, exact hashing)."""

import hashlib
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from multistark_tpu import lookup as jlk
from multistark_tpu import parallel as jpar
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import GoldilocksBlake3Config as JaxConfig
from multistark_tpu.fields.device import GL2_OPS as JGL2, GL_OPS as JGL
from multistark_tpu.fields.host import GOLDILOCKS, GOLDILOCKS_EXT2
from multistark_tpu.merkle import Blake3FieldHasher as JaxHasher, MerkleMmcs as JaxMmcs
from multistark_tpu.ntt import get_engine
from multistark_tpu.prover import prove_multiple_claims as jax_prove
from multistark_tpu.system import System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu.test_circuits import u32_add_system_inputs, u32_add_witness
from multistark_tpu_torch import parallel, spmd_cases
from multistark_tpu_torch.examples.sharded_proof import BENCH_FRI, WITNESS_SEED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = GOLDILOCKS.p
RNG = np.random.default_rng(27)
WORLDS = (4, 2)
DIF_LOGS = (6, 8, 11)  # tests/test_parallel.py:36, on the 8-device mesh
J_EQUALS_D = {4: 4, 2: 2}  # per world, the log_n whose residue classes have exactly D rows (n = D^2)
FRI4 = dict(log_final_poly_len=0, max_log_arity=1, num_queries=4, commit_proof_of_work_bits=1,
            query_proof_of_work_bits=1)
SMALL = ("goldilocks_blake3", 6, 40, 17, FRI4)  # a 2^6 U32Add prove with 4 queries
BENCH = {4: ("goldilocks_blake3",), 2: ("babybear_poseidon2",)}  # GoldilocksBlake3 at D = 2: dryrun_multichip


def _mat(w, h):
    return RNG.integers(0, P, size=(w, h), dtype=np.uint64)


# commits: the mixed heights of the JAX test; a height below D = 4 (injected
# above the subtrees); a cap of 8 digests (more than D: each rank's part of it)
COMMITS = [
    (0, [_mat(5, 1 << 9), _mat(3, 1 << 7), _mat(2, 4)]),
    (0, [_mat(5, 1 << 9), _mat(2, 2)]),
    (3, [_mat(3, 1 << 6), _mat(2, 1 << 3)]),
]
STAGE2_N, STAGE2_ARITIES = 128, (2, 2, 2)  # tests/test_parallel.py:109
INPUTS = {
    "dif": [(log_n, _mat(3, 1 << log_n)) for log_n in DIF_LOGS + tuple(J_EQUALS_D.values())],
    "lde": (_mat(4, 512), 9, 2),
    "commits": COMMITS,
    "stage2": (STAGE2_N, STAGE2_ARITIES, _mat(9, STAGE2_N), (3, 5), (7, 11), (1, 2)),
    "dft": (_mat(3, 1 << 7), 3, 4),
}


def _fri(log_final, arity):
    return dict(FRI4, log_final_poly_len=log_final, max_log_arity=arity)


# sharded against single-device proves of the port: a trace of D rows (blocks
# of one row), a cap larger than D with FRI arity 8, FRI arity 16 at blowup 2
VARIANTS = [
    ("goldilocks_blake3", 2, 4, 3, _fri(0, 1), dict(log_blowup=3, cap_height=0)),
    ("babybear_poseidon2", 5, 20, 4, _fri(2, 3), dict(log_blowup=2, cap_height=3)),
    ("goldilocks_blake3", 7, 100, 5, _fri(1, 4), dict(log_blowup=1, cap_height=1)),
]


def _inputs(world):
    proves = [(name, 10, 1 << 10, WITNESS_SEED, BENCH_FRI) for name in BENCH[world]]
    dif = [(log_n, x) for log_n, x in INPUTS["dif"] if (1 << log_n) >= world * world]
    return dict(INPUTS, dif=dif, proves=proves + [SMALL], variants=VARIANTS)


@pytest.fixture(scope="module")
def started():
    """Both groups of ranks, started before the JAX side is computed."""
    return {world: parallel.Ranks(spmd_cases.cases_rank, world, (_inputs(world),), backend="gloo")
            for world in WORLDS}


@pytest.fixture(scope="module")
def jax_side(started):
    """The JAX references; the small prove's compiles run in a thread
    beside the sharded DIF's."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        small = pool.submit(_jax_small_prove)
        ref = _jax_refs()
        ref["small"] = small.result()
    return ref


def _mesh(d):
    return jpar.ProverMesh(Mesh(np.array(jax.devices()[:d]), ("rows",)), "rows")


def _jax_small_prove() -> dict:
    name, log_n, n_pairs, seed, fri = SMALL
    config = JaxConfig(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**fri))
    system, key = JaxSystem.new(config, u32_add_system_inputs())
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, n_pairs, dtype=np.uint64)
    traces, claims = u32_add_witness(list(zip(xs.tolist(), ys.tolist())), 1 << log_n)
    data = jax_prove(system, key, JaxWitness.from_stage_1(traces, system, key), claims).to_bytes(config)
    return {"sha256": hashlib.sha256(data).hexdigest(), "n_bytes": len(data)}


def _jax_refs() -> dict:
    pm = _mesh(8)
    eng = get_engine(JGL)
    ref = {"dif": {}}
    for log_n, x in INPUTS["dif"]:
        on = pm if log_n in DIF_LOGS else _mesh(1 << (log_n // 2))  # n = D^2 on a D-device mesh
        for inverse in (False, True):
            ref["dif"][log_n, inverse] = JGL.to_np(jpar.sharded_dif(eng, on, JGL.from_np(x), log_n, inverse))
    x, log_n, log_blowup = INPUTS["lde"]
    ref["lde"] = JGL.to_np(jpar.sharded_coset_lde_bitrev(eng, pm, JGL.from_np(x), log_n, log_blowup,
                                                         JGL.host.generator))
    ref["caps"] = [np.asarray(JaxMmcs(JaxHasher(JGL), cap).commit([JGL.from_np(m) for m in mats])[0])
                   for cap, mats in COMMITS]
    n, arities, matrix, beta, gamma, acc0 = INPUTS["stage2"]
    rows = iter(JGL.from_np(r) for r in matrix)
    mults, args = [], []
    for a in arities:
        mults.append(next(rows))
        args.append([next(rows) for _ in range(a)])
    lv = jlk.LookupValues(height=n, mults=mults, args=args)
    mats, accs = jlk.stage_2_traces(JGL, JGL2, GOLDILOCKS, GOLDILOCKS_EXT2, [lv], beta, gamma, acc0)
    ref["stage2"] = (JGL.to_np(mats[0]), tuple(int(c) for c in accs[0]))
    x, log_n1, log_n2 = INPUTS["dft"]
    ref["dft"] = JGL.to_np(eng.dft_natural(JGL.from_np(x), log_n1 + log_n2)).reshape(3, 1 << log_n1, 1 << log_n2)
    with open(os.path.join(ROOT, "fixtures", "torch_port_golden.json")) as f:
        ref["golden"] = {name: entries["10"] for name, entries in json.load(f).items()}
    return ref


@pytest.fixture(scope="module")
def ranks(started, jax_side):
    return {world: started[world].results() for world in WORLDS}


@pytest.fixture(scope="module")
def dryrun(ranks):
    """The entry point on the CPU: two gloo ranks prove the bench workload
    at 2^10 (GoldilocksBlake3), checked inside against a single-device prove
    and for the row-27 calls; every rank's report."""
    return parallel.dryrun_multichip(2, device="cpu")


def _blocks(rank_results, get):
    return np.concatenate([get(r) for r in rank_results], axis=-1)


@pytest.mark.parametrize("world, log_n", [(w, ln) for w in WORLDS for ln in (J_EQUALS_D[w],) + DIF_LOGS])
@pytest.mark.parametrize("inverse", (False, True))
def test_sharded_dif_matches_jax(ranks, jax_side, world, log_n, inverse):
    got = _blocks(ranks[world], lambda r: r["dif"][log_n, inverse])
    np.testing.assert_array_equal(got, jax_side["dif"][log_n, inverse])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_coset_lde_matches_jax(ranks, jax_side, world):
    np.testing.assert_array_equal(_blocks(ranks[world], lambda r: r["lde"]), jax_side["lde"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(COMMITS)))
def test_sharded_commit_caps_and_openings_match(ranks, jax_side, world, case):
    for r in ranks[world]:
        got = r["commits"][case]
        np.testing.assert_array_equal(got["cap"], jax_side["caps"][case])
        assert got["openings_equal"]  # every rank's openings equal the single-device tree's


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stage2_matches_jax(ranks, jax_side, world):
    mat, acc = jax_side["stage2"]
    np.testing.assert_array_equal(_blocks(ranks[world], lambda r: r["stage2"][0]), mat)
    assert all(r["stage2"][1] == acc for r in ranks[world])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_dft_matches_the_jax_reference(ranks, jax_side, world):
    np.testing.assert_array_equal(_blocks(ranks[world], lambda r: r["dft"]), jax_side["dft"])


@pytest.mark.parametrize("world, config", [(4, "goldilocks_blake3"), (2, "goldilocks_blake3"),
                                           (2, "babybear_poseidon2")])
def test_bench_prove_on_every_rank_equals_the_golden_entry(ranks, dryrun, jax_side, world, config):
    if config in BENCH[world]:
        proves = [r["proves"][BENCH[world].index(config)] for r in ranks[world]]
        proves = [(p["digest"], p["sharded_calls"]) for p in proves]
    else:  # dryrun_multichip's ranks
        proves = [(r["proofs"][f"{config}/10"]["digest"], r["counts"][config]["sharded_calls"]) for r in dryrun]
    assert len(proves) == world
    for digest, calls in proves:
        assert digest == jax_side["golden"][config]
        ran = {k for k, v in calls.items() if v > 0}
        assert set(parallel.ROW27) <= ran, f"not sharded: {set(parallel.ROW27) - ran}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(VARIANTS)))
def test_sharded_prove_variants_equal_the_single_device_prove(ranks, world, case):
    for r in ranks[world]:
        got = r["variants"][case]
        assert got["digest"] == got["single"] == ranks[world][0]["variants"][case]["digest"]


@pytest.mark.parametrize("world", WORLDS)
def test_small_prove_on_every_rank_equals_jax(ranks, jax_side, world):
    for r in ranks[world]:
        assert r["proves"][-1]["digest"] == jax_side["small"]


def test_dryrun_multichip_on_the_cpu(dryrun):
    """dryrun_multichip(2, device="cpu") runs two gloo ranks on the CPU (the
    bench case above holds their bytes to the golden entry)."""
    assert [(r["rank"], r["world"], r["backend"], r["device"]) for r in dryrun] == [
        (0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]
    assert all(r["proofs"]["goldilocks_blake3/10"]["warm_s"] > 0 for r in dryrun)


def test_cuda_tensors_on_an_unnamed_gloo_group_raise(monkeypatch):
    """gloo carries CUDA tensors only when the caller named it at the join;
    NCCL takes no CPU tensor."""
    cuda_like = type("T", (), {"is_cuda": True})()
    cpu_like = type("T", (), {"is_cuda": False})()
    gloo = type("M", (), {"backend": "gloo"})()
    monkeypatch.setattr(parallel, "_GLOO_NAMED", False)
    with pytest.raises(ValueError, match="only when named"):
        parallel._staged(gloo, cuda_like)
    assert parallel._staged(gloo, cpu_like) is False
    monkeypatch.setattr(parallel, "_GLOO_NAMED", True)
    assert parallel._staged(gloo, cuda_like) is True
    with pytest.raises(ValueError, match="CUDA tensors"):
        parallel._staged(type("M", (), {"backend": "nccl"})(), cpu_like)


def test_concurrent_host_builds_wait_for_the_build_lock(tmp_path):
    """Two native.py builds into one directory, started together while this
    process holds the directory's lock: neither writes the library before
    the lock is released, then both build, load it and hash with it."""
    import subprocess
    import sys
    import time

    from multistark_tpu_torch import native

    prog = ("import sys; from multistark_tpu_torch import native; from multistark_tpu_torch.hash import blake3_host;"
            "lib = native.load(native.build(sys.argv[1], force=True)); native._LIB = lib;"
            "print(blake3_host.blake3_hash(b'abc').hex())")
    env = dict(os.environ, PYTHONPATH=ROOT)
    lib_path = tmp_path / "libmshost.so"
    with native.build_lock(str(tmp_path)):
        procs = [subprocess.Popen([sys.executable, "-c", prog, str(tmp_path)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
        time.sleep(3)
        assert not lib_path.exists() and all(p.poll() is None for p in procs)
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    want = "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85"  # BLAKE3("abc")
    assert [out.strip() for out, _ in outs] == [want, want] and lib_path.exists()
