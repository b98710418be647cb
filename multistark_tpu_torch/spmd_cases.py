"""The sharded functions of parallel.py and ntt/distributed.py at small
shapes, as one rank's program: `cases_rank` runs on every rank of a group
started by `parallel.Ranks` (CPU tensors, gloo, the kernels' plain
versions) and returns what each case gives on that rank.  Its caller (the
CPU tests) compares the results of all ranks with the JAX package; a child
process imports torch and this package only.

    inputs = {"dif": [(log_n, x)], "lde": (x, log_n, log_blowup),
              "commits": [(cap_height, [mat]), ...], "stage2": (n, arities, matrix, beta, gamma, acc0),
              "dft": (x, log_n1, log_n2), "proves": [(config, log_n, n_pairs, seed, fri)],
              "variants": [(config, log_n, n_pairs, seed, fri, commit)]}

with u64 numpy matrices (w, h).  Each prove case returns the proof digest
and the rank's sharded calls; each variant the digests of the sharded
prove and of a single-device prove in the rank.  `chip_rank` is the rank's program of
chip_smoke.py's sharded phase: the bench proves of
examples/sharded_proof.py on the card, then, if asked, distributed_dft on
the card against the same function on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import parallel
from .examples.sharded_proof import BENCH_COMMIT, bench_config, bench_witness, digest


def _gl():
    from .fields.device import GL_OPS
    from .ntt import NttEngine

    return GL_OPS, NttEngine(GL_OPS, GL_OPS.host, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64).copy()


def _prove(config_name: str, log_n: int, n_pairs: int, seed: int, fri: dict, commit=BENCH_COMMIT,
           single=False) -> dict:
    from .prover import prove_multiple_claims
    from .system import System
    from .test_circuits import u32_add_system_inputs

    system, key = System.new(bench_config(config_name, "cpu", commit, fri), u32_add_system_inputs())
    witness, claims = bench_witness(system, key, log_n, "cpu", n_pairs, seed)
    parallel.SHARDED_CALLS.clear()
    with parallel.use_mesh():
        proof = prove_multiple_claims(system, key, witness, claims)
    out = {"digest": digest(proof.to_bytes()), "sharded_calls": dict(parallel.SHARDED_CALLS)}
    if single:
        out["single"] = digest(prove_multiple_claims(system, key, witness, claims).to_bytes())
    return out


def cases_rank(rank: int, inputs: dict) -> dict:
    from .fields.device import GL2_OPS
    from .fields.host import ExtensionParams
    from .lookup import LookupValues, stage2_program
    from .merkle import Blake3FieldHasher, MerkleMmcs, digest_layer_to_np
    from .ntt.distributed import distributed_dft

    F, eng = _gl()
    out: dict = {}
    with parallel.use_mesh() as pm:
        out["dif"] = {}
        for log_n, x in inputs.get("dif", []):
            xt = F.from_np(x, "cpu")
            for inverse in (False, True):
                blk = parallel.sharded_dif(eng, pm, parallel.cyclic_slice(pm, xt, (1 << log_n) // pm.n), log_n, inverse)
                out["dif"][log_n, inverse] = _np(blk)
        if "lde" in inputs:
            x, log_n, log_blowup = inputs["lde"]
            out["lde"] = _np(parallel.sharded_coset_lde_bitrev(eng, pm, F.from_np(x, "cpu"), log_n, log_blowup,
                                                               F.host.generator))
        out["commits"] = []
        for cap_height, mats in inputs.get("commits", []):
            mmcs = MerkleMmcs(Blake3FieldHasher(), cap_height)
            full = [F.from_np(m, "cpu") for m in mats]
            heights = [m.shape[1] for m in mats]
            blocks = [parallel.shard_rows(pm, m) if h >= pm.n else m for m, h in zip(full, heights)]
            cap, data = parallel.sharded_mmcs_commit(mmcs, pm, blocks, heights)
            _, ref = mmcs.commit_device(full)
            idx = list(range(0, max(heights), 3))
            sharded = mmcs.fetch(parallel.gather_openings(mmcs, [data], [idx]))[0]
            single = mmcs.gather_many([ref], [idx])[0]
            openings_equal = np.array_equal(sharded[0], single[0]) and all(
                np.array_equal(a, b) for a, b in zip(sharded[1], single[1]))
            out["commits"].append({"cap": digest_layer_to_np(cap), "openings_equal": openings_equal,
                                   "local_levels": data.shard.local_levels})
        if "stage2" in inputs:
            n, arities, matrix, beta, gamma, acc0 = inputs["stage2"]
            E = GL2_OPS
            ep = ExtensionParams(degree=2, w=7, karatsuba=True)
            lv = LookupValues(height=n, matrix=F.from_np(matrix, "cpu"), arities=tuple(arities),
                              stage2_program=stage2_program(F.p, ep, arities, "stage-2 case"))
            blk, total = parallel.sharded_stage2(E, pm, lv, E.const(beta, "cpu"), E.const(gamma, "cpu"),
                                                 E.const(acc0, "cpu"))
            out["stage2"] = (_np(blk), tuple(int(c) for c in _np(E.add(E.const(acc0, "cpu"), total))))
        if "dft" in inputs:
            x, log_n1, log_n2 = inputs["dft"]
            out["dft"] = _np(distributed_dft(eng, pm, F.from_np(x, "cpu"), log_n1, log_n2))
    out["proves"] = [_prove(*case) for case in inputs.get("proves", [])]
    out["variants"] = [_prove(*case, single=True) for case in inputs.get("variants", [])]
    return out


def chip_rank(rank: int, cases, device: str, dft=None) -> dict:
    """`prove_rank` on this rank's card, then (dft = (log_n1, log_n2, width,
    seed)) distributed_dft of a seeded (width, n1·n2) matrix on the card
    (K2, K1, the all_to_all) against the same call on CPU tensors (the
    kernels' plain versions), with its warm time on the card and on the
    CPU.  The DFT's launches come after the report's counts were read."""
    import time

    from .examples.sharded_proof import prove_rank, rank_device
    from .fields.device import GL_OPS
    from .ntt import NttEngine
    from .ntt.distributed import distributed_dft

    rep = prove_rank(rank, cases, device)
    if dft is not None:
        log_n1, log_n2, width, seed = dft
        dev = rank_device(rank, device)
        x = np.random.default_rng(seed).integers(0, GL_OPS.p, (width, 1 << (log_n1 + log_n2)), dtype=np.uint64)
        with parallel.use_mesh() as pm:
            runs = {}
            for where in (dev, torch.device("cpu")):
                eng, xt = NttEngine(GL_OPS, GL_OPS.host, where), GL_OPS.from_np(x, where)
                distributed_dft(eng, pm, xt, log_n1, log_n2)  # warm-up
                if where.type == "cuda":
                    torch.cuda.synchronize(where)
                t0 = time.perf_counter()
                out = distributed_dft(eng, pm, xt, log_n1, log_n2)
                if where.type == "cuda":
                    torch.cuda.synchronize(where)
                runs[where.type] = (out.cpu(), 1e3 * (time.perf_counter() - t0))
        (got, ms), (ref, plain_ms) = runs[dev.type], runs["cpu"]
        rep["dft"] = {"equal": bool(torch.equal(got, ref)), "shape": list(got.shape), "ms": ms, "plain_ms": plain_ms}
    return rep
