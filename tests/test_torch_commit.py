"""K14 (lde_tile) and K15 (merkle_levels): the port's stage and quotient
commits on CPU tensors against the JAX package's TwoAdicFriPcs.commit /
commit_from_coeffs, bit for bit (tolerance zero: everything is mod p and
hashing is exact): every stored LDE, every digest layer and the cap, with
K14's tile forced to 2^2 or 2^3 so that small heights reach every geometry
(heights below, at and above the tile; shorter rows injected inside the
tile, exactly at its top and above it; caps of 1, 2 and 4 digests), plus
openings, the tile policy and the plan the commits follow at the bench's
shapes, K14's no-hash DIF tail and DIT head against the JAX transforms of
its tiles, and the sub-cap rejection.  The JAX side runs eagerly, as its own CPU tests do (its
fused commit program is not compiled on the CPU: test_fused_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.fields.device import BB_OPS, GL_OPS
from multistark_tpu.merkle import digest_planes_to_np
from multistark_tpu.ntt import get_engine
from multistark_tpu_torch import commit_tile
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.host import BABYBEAR, GOLDILOCKS
from multistark_tpu_torch.merkle import digest_layer_to_np
from multistark_tpu_torch.ntt import NttEngine
from multistark_tpu_torch.pcs import commit_plan

LOG_BLOWUP = 2
FRI = dict(log_final_poly_len=0, max_log_arity=1, num_queries=2, commit_proof_of_work_bits=0,
           query_proof_of_work_bits=0)
CONFIGS = {"gl": (JaxGL, GoldilocksBlake3Config, GL_OPS), "bb": (JaxBB, BabyBearPoseidon2Config, BB_OPS)}

# (width, log trace height) per matrix; the LDE is 4x taller.  With a tile of
# 2^3 (2^2): 2^2 below the tile (and at it), 2^3 at it, 2^6 above it; a
# shorter group at LDE 16 is injected inside a 2^3 tile, at 8 exactly at its
# top, at 4 above it (K15)
GL_CASES = {
    "below": ([(3, 0)], 0),
    "at": ([(3, 1)], 1),
    "above": ([(3, 4)], 1),
    "inject inside": ([(2, 4), (3, 2)], 0),
    "inject at the top": ([(2, 4), (1, 1)], 1),
    "inject above": ([(2, 4), (1, 0)], 0),
    "two groups, two injections, cap 4": ([(1, 4), (4, 4), (2, 3), (5, 1)], 2),
    "a row wider than one chunk": ([(130, 3)], 1),
    "a row too wide for three tiles per SM": ([(600, 4)], 1),  # default tile 2^5 under an LDE of 2^6
}
BB_CASES = {  # LDE heights <= 2^5 (the JAX side's eager Poseidon2 trees are slow); with a tile of 2^2,
    # LDE 16 is injected inside it, 8 at its top, 4 above it
    "inject inside, at the top and above": ([(9, 3), (1, 2), (3, 1), (2, 0)], 2),
}


def _pcs_pair(name: str, cap_height: int):
    jax_cls, cls, _ = CONFIGS[name]
    jax_pcs = jax_cls(JaxCommit(log_blowup=LOG_BLOWUP, cap_height=cap_height), JaxFri(**FRI)).pcs
    pcs = cls(CommitmentParameters(log_blowup=LOG_BLOWUP, cap_height=cap_height), FriParameters(**FRI),
              device="cpu").pcs
    return jax_pcs, pcs


def _mats(name: str, dims, seed: int):
    p = (BABYBEAR if name == "bb" else GOLDILOCKS).p
    rng = np.random.default_rng(seed)
    return [rng.integers(0, p, (w, 1 << ln), dtype=np.uint64) for w, ln in dims]


@functools.lru_cache(maxsize=None)
def _jax_commit(name: str, case: str, from_coeffs: bool):
    """The JAX package's commit of a case (whatever the port's tile): its
    cap, stored LDEs, digest layers and prover data."""
    dims, cap_height = (GL_CASES if name == "gl" else BB_CASES)[case]
    mats = _mats(name, dims, len(case))
    F = CONFIGS[name][2]
    jax_pcs, _ = _pcs_pair(name, cap_height)
    if from_coeffs:
        cap, data = jax_pcs.commit_from_coeffs([F.from_np(m) for m in mats])
    else:
        cap, data = jax_pcs.commit([(jax_pcs.natural_domain_for_degree(m.shape[1]), F.from_np(m)) for m in mats])
    ldes = [F.to_np(m) for m in data.mmcs_data.mats]
    layers = [digest_planes_to_np(layer) for layer in data.mmcs_data.layers]
    return mats, cap, ldes, layers, data


def _port_commit(name: str, case: str, from_coeffs: bool, tile_log):
    dims, cap_height = (GL_CASES if name == "gl" else BB_CASES)[case]
    mats = _mats(name, dims, len(case))
    _, pcs = _pcs_pair(name, cap_height)
    t = [pcs.F.from_np(m, "cpu") for m in mats]
    if from_coeffs:
        return pcs, pcs.commit_from_coeffs(t, tile_log=tile_log)
    return pcs, pcs.commit([(pcs.natural_domain_for_degree(m.shape[1]), m) for m in t], tile_log=tile_log)


def _assert_same_commit(name, case, from_coeffs, tile_log):
    _, jax_cap, jax_ldes, jax_layers, _ = _jax_commit(name, case, from_coeffs)
    _, (cap, data) = _port_commit(name, case, from_coeffs, tile_log)
    assert len(data.mmcs_data.mats) == len(jax_ldes)
    for got, want in zip(data.mmcs_data.mats, jax_ldes):
        np.testing.assert_array_equal(fd.to_np(got), want)
    assert len(data.mmcs_data.layers) == len(jax_layers)
    for got, want in zip(data.mmcs_data.layers, jax_layers):
        np.testing.assert_array_equal(digest_layer_to_np(got), want)
    np.testing.assert_array_equal(cap, jax_cap)
    return data


@pytest.mark.parametrize("from_coeffs", [False, True], ids=["evals", "coeffs"])
@pytest.mark.parametrize("tile_log", [2, 3])
@pytest.mark.parametrize("case", list(GL_CASES))
def test_goldilocks_commit_matches_jax(case, tile_log, from_coeffs):
    _assert_same_commit("gl", case, from_coeffs, tile_log)


@pytest.mark.parametrize("case", list(BB_CASES))
def test_babybear_commit_matches_jax(case):
    """From evaluations (the coefficient path: the test below)."""
    _assert_same_commit("bb", case, False, 2)


@pytest.mark.parametrize("case", list(BB_CASES))
def test_babybear_commit_from_coeffs_matches_jax(case):
    """The quotient commit's path for BabyBear (about 11 s of the JAX
    side's eager Poseidon2 trees)."""
    _assert_same_commit("bb", case, True, 2)


@pytest.mark.parametrize("name, case", [("gl", "two groups, two injections, cap 4"), ("gl", "above"),
                                        ("bb", "inject inside, at the top and above"),
                                        ("gl", "a row too wide for three tiles per SM")])
def test_default_tile_matches_jax(name, case):
    """The tile and in-tile levels the commits pick themselves (the whole
    height at most of these sizes; a K2 pass above a tile of 2^5 for the
    wide row) give the same commitment."""
    _assert_same_commit(name, case, False, None)


@pytest.mark.parametrize("name, case", [("gl", "two groups, two injections, cap 4"),
                                        ("bb", "inject inside, at the top and above")])
def test_openings_match_jax(name, case):
    *_, jax_data = _jax_commit(name, case, False)
    pcs, (_, data) = _port_commit(name, case, False, 2)
    jax_pcs, _ = _pcs_pair(name, GL_CASES[case][1] if name == "gl" else BB_CASES[case][1])
    idx = np.asarray([0, 5, 63, 17, 5] if name == "gl" else [0, 5, 31, 17])
    want = jax_pcs.mmcs.open_batch(jax_data.mmcs_data, idx)
    for a, b in zip(pcs.mmcs.open_batch(data.mmcs_data, idx), want):
        np.testing.assert_array_equal(a.path, b.path)
        for ra, rb in zip(a.opened_rows, b.opened_rows):
            np.testing.assert_array_equal(ra, rb)


def test_merkle_levels_fold_many_levels_with_injections():
    """K15 over more levels than one block folds (a second tier), with
    injections below, at and above the first tier's top, against the plain
    fold of merkle.py's loop."""
    _, pcs = _pcs_pair("gl", 0)
    hasher = pcs.mmcs.hasher
    rng = np.random.default_rng(5)

    def digests(h):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (h, 8)).astype(np.int32))

    leaves = digests(1 << 12)
    inject = {lv: digests(1 << (12 - lv)) for lv in (3, 10, 11)}
    got = commit_tile.merkle_levels(hasher, leaves, 12, inject)
    assert [t.shape[0] for t in got] == [1 << (12 - lv) for lv in range(1, 13)]
    want = leaves
    for lv, layer in enumerate(got, start=1):
        want = hasher.compress_plain(want[0::2], want[1::2])
        if lv in inject:
            want = hasher.compress_plain(want, inject[lv])
        assert torch.equal(layer, want)


@pytest.mark.parametrize("log_size", [16, 17, 18, 19])
@pytest.mark.parametrize("cap_height", range(5))
def test_levels_plan_spreads_the_first_level_over_every_sm(log_size, cap_height):
    """From 2^16 nodes up (the stage trees above K14's tile start at 2^17,
    the FRI trees at 2^19) the first tier's blocks cover all 132 SMs, each
    folding a subtree of at most 2^10 nodes with a thread per first-level
    node (at most 256); the tiers above fold the rest up to the cap."""
    levels = log_size - cap_height
    plan = commit_tile.levels_plan(log_size, levels)
    assert plan.blocks >= commit_tile.SMS and plan.blocks == 1 << (log_size - plan.tiers[0])
    assert sum(plan.tiers) == levels and all(1 <= t <= commit_tile.MAX_GROUP_LOG for t in plan.tiers)
    assert plan.threads == min(256, 1 << (max(plan.tiers) - 1))
    groups = [plan.blocks >> sum(plan.tiers[1:t + 1]) for t in range(1, len(plan.tiers))]
    assert plan.counters == sum(groups) and (not groups or groups[-1] == 1 << cap_height)


@pytest.mark.parametrize("log_size, levels, want", [
    (1, 1, ((1,), 1, 32, 0)),  # a 2^1-leaf tree: one block, one warp
    (2, 2, ((2,), 1, 32, 0)),  # a 2^2-leaf tree
    (2, 1, ((1,), 2, 32, 0)),  # 2^2 leaves under a cap of 2: a block per cap node
    (9, 9, ((9,), 1, 256, 0)),  # the largest tree one block folds whole
    (10, 10, ((6, 4), 16, 32, 1)),  # the smallest spread tree: 2^6-node subtrees
    (17, 17, ((9, 8), 256, 256, 1)),  # a stage tree above K14's three in-tile levels
    (19, 19, ((10, 9), 512, 256, 1)),  # the first FRI round's tree
    (19, 15, ((10, 5), 512, 256, 16)),  # the same under a cap of 2^4
    (30, 30, ((10, 10, 10), 1 << 20, 256, 1025)),
])
def test_levels_plan(log_size, levels, want):
    plan = commit_tile.levels_plan(log_size, levels)
    assert (plan.tiers, plan.blocks, plan.threads, plan.counters) == want


@pytest.mark.parametrize("log_size, want_threads", [(2, 32), (5, 64), (7, 256), (10, 128), (19, 256)])
def test_levels_plan_gives_poseidon2_a_group_of_lanes_per_node(log_size, want_threads):
    """Poseidon2's narrow levels run a node on four lanes (NODE_LANES): the
    same tiers, four times the threads (up to 256)."""
    lanes = commit_tile.NODE_LANES[1]
    plan, plain = commit_tile.levels_plan(log_size, log_size, lanes), commit_tile.levels_plan(log_size, log_size)
    assert (plan.tiers, plan.blocks, plan.counters) == (plain.tiers, plain.blocks, plain.counters)
    assert plan.threads == want_threads


def test_node_chain_plain_is_repeated_compression():
    """K15's latency chain (a measurement on the card) on a CPU tensor: the
    digest compressed with itself n times."""
    _, pcs = _pcs_pair("gl", 0)
    hasher = pcs.mmcs.hasher
    d = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    want = d
    for _ in range(3):
        want = hasher.compress_plain(want, want)
    assert torch.equal(commit_tile.node_chain(hasher, d, 3), want)
    assert torch.equal(commit_tile.node_chain(hasher, d, 0), d)


@pytest.mark.parametrize("cols, log_n, hashed, want", [
    (14, 20, True, 8),  # the stage-1 LDE at 2^18 rows
    (14, 18, False, 9),  # its iDFT
    (1, 10, True, 8),  # ByteTable's LDE: a row per thread
    (26, 20, True, 8),  # a stage-2 width
    (130, 20, True, 6),  # a row wider than one BLAKE3 chunk
    (600, 20, True, 5),  # a row too wide for three tiles per SM: raised to a warp of rows
    (3, 2, True, 2),  # a height below the tile
])
def test_tile_log_fits_shared_memory(cols, log_n, hashed, want):
    """The largest tile that leaves room for BLOCKS_PER_SM blocks on an SM
    (a hashed tile at most a row per thread), raised towards a warp of rows
    while one block's opt-in allows it."""
    k = commit_tile.tile_log_for(cols, log_n, hashed)
    assert k == want

    def fits(k, room):
        return commit_tile.tile_bytes(cols, k, hashed) <= room

    top = min(log_n, commit_tile.MAX_TILE_LOG, commit_tile.HASHED_ROWS_LOG if hashed else commit_tile.MAX_TILE_LOG)
    assert fits(k, commit_tile.TILE_BUDGET) or (k <= commit_tile.WARP_LOG and fits(k, commit_tile.SMEM_BYTES))
    assert k == top or not fits(k + 1, commit_tile.TILE_BUDGET)
    assert k == top or k >= commit_tile.WARP_LOG or not fits(k + 1, commit_tile.SMEM_BYTES)
    assert commit_tile.BLOCKS_PER_SM * (commit_tile.TILE_BUDGET + 1024) <= commit_tile.SM_SMEM_BYTES


def test_commit_plan_of_the_bench_stage_1():
    """U32Add (14, 2^18) and ByteTable (1, 2^8) at blowup 4: K14 tiles of
    2^8 rows (a row per thread); the tall one folds the three levels that
    keep a warp busy, with twelve K2 stages above it; K15 has seventeen
    levels left and takes ByteTable's 1024 leaves at its level 7 (tree
    level 10)."""
    tall, short = commit_plan([14, 1], [18, 8], LOG_BLOWUP, 0)
    assert (tall.members, tall.cols, tall.log_lde, tall.tile, tall.levels, tall.inject_level) == ((0,), 14, 20, 8,
                                                                                                  3, 0)
    assert tall.idft_tile == 9
    assert (short.members, short.log_lde, short.tile, short.levels, short.inject_level) == ((1,), 10, 8, 0, 10)
    assert short.idft_tile == 8


@pytest.mark.parametrize("widths, logs, want", [
    ([26, 2], [18, 8], [(8, 8, 3, 0), (8, 8, 0, 10)]),  # the stage-2 commit at 2^18 rows
    ([2, 2], [18, 8], [(8, 12, 3, 0), (8, 8, 0, 10)]),  # the quotient commit's chunks
    ([14, 1], [14, 8], [(8, 9, 3, 0), (8, 8, 0, 6)]),  # the stage-1 commit at 2^14 rows
])
def test_commit_plan_tile_policy(widths, logs, want):
    """The bench's other commits: (tile, iDFT tile, in-tile levels, injection
    level) per group; every hashed tile leaves room for BLOCKS_PER_SM blocks
    on an SM."""
    plan = commit_plan(widths, logs, LOG_BLOWUP, 0)
    assert [(g.tile, g.idft_tile, g.levels, g.inject_level) for g in plan] == want
    for g in plan:
        assert commit_tile.tile_bytes(g.cols, g.tile, True) <= commit_tile.TILE_BUDGET


@pytest.mark.parametrize("k", [0, 3, 6])
@pytest.mark.parametrize("dif", [True, False], ids=["dif tail", "dit head"])
@pytest.mark.parametrize("name", ["gl", "bb"])
def test_lde_tile_without_hashing_matches_jax(name, dif, k):
    """K14 with hashing off: a DIF's last k stages (or a DIT's first k) on
    each tile of 2^k positions are the JAX package's DIF (DIT) of that tile
    as a transform of its own size, forward or inverse; DIT mode hashes
    nothing."""
    F = CONFIGS[name][2]
    host = BABYBEAR if name == "bb" else GOLDILOCKS
    tf = GoldilocksBlake3Config if name == "gl" else BabyBearPoseidon2Config
    pcs = tf(CommitmentParameters(log_blowup=LOG_BLOWUP, cap_height=0), FriParameters(**FRI), device="cpu").pcs
    eng = NttEngine(pcs.F, host, "cpu")
    m = np.random.default_rng(40 + k).integers(0, host.p, (3, 1 << 6), dtype=np.uint64)
    inverse = k % 2 == 1
    blocks = m.reshape(-1, 1 << k)
    jax_eng = get_engine(F)
    want = F.to_np((jax_eng._dif if dif else jax_eng._dit)(F.from_np(blocks), k, inverse)).reshape(m.shape)
    x = pcs.F.from_np(m, "cpu")
    assert commit_tile.lde_tile(pcs.F, None, x, k, eng.tail_table(k, inverse), hashed=False, dif=dif) == []
    np.testing.assert_array_equal(fd.to_np(x), want)
    with pytest.raises(ValueError, match="DIF only"):
        commit_tile.lde_tile(pcs.F, pcs.mmcs.hasher, x, k, eng.tail_table(k, inverse), hashed=True, dif=False)


def test_sub_cap_matrices_are_rejected():
    _, pcs = _pcs_pair("gl", 3)
    mats = [pcs.F.from_np(m, "cpu") for m in _mats("gl", [(2, 4), (1, 0)], 3)]
    with pytest.raises(ValueError, match="below cap size"):
        pcs.commit([(pcs.natural_domain_for_degree(m.shape[1]), m) for m in mats])
