#!/usr/bin/env python3
"""Time variants of K12 (bary_eval), K8 (fri_grind), K9 (claims_fp), K6
(poseidon2_merkle) and K14 (lde_tile) on one CUDA card.

    python3 scripts/variant_sweep.py [KERNEL ...]

(KERNEL: bary_eval, fri_grind, claims_fp, poseidon2_merkle, lde_tile; all
of them by default.)

A variant is a kernel source with text substitutions, built alone by nvcc
into its own shared library (under build/variants/, with its `-Xptxas -v`
report), which stands in for the kernel library while that kernel runs:
K12 on the bench's 2^18 trace height (U32Add's stage-1, stage-2 and
quotient matrices, both fields), K8 on one round and on 18 chained rounds
at 10 bits over a 16-word chain ‖ cap, K9 on the claims accumulator of 2^14
and 2^18 claims of 4 values, both fields, K6 on the first FRI level of the
BabyBear 2^18 prove (8, 2^19), on the stage-1 width (14, 2^20) and on the
prove's 18 levels in a row, K14 on BabyBear's stage-1 (14, 2^20) and
stage-2 (52, 2^20) hashed tiles.  A variant may also set attributes of the
kernel's Python module while it runs (K6's grid: RESIDENT).  Every
variant's output must equal the built library's.  Times: the profiler's device ms of the kernel's
functions (the sessions' kernel events counted against the launches), two
turns.  A substitution that no longer matches the source raises.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

_K12_LOADS = "constexpr int BARY_UNROLL = 16;"
_K12_BOUNDS = "template <class F, int P>\n__global__ void __launch_bounds__(THREADS, 2)\n    bary_height_kernel"
_K8_FIRST = "const int64_t first = (int64_t)16 << bits < n ? (int64_t)16 << bits : n;"
_K9_ITEMS = "constexpr int ITEMS = 4;"
_K9_THREADS = "constexpr int THREADS = 128;"
_K6_BANK = "  const uint32_t* c = MONT_CONSTS;\n"
# K6's thread mode with its constants staged in shared memory per block
_K6_STAGED = ("  __shared__ uint32_t c[N_CONST];\n"
              "  for (int i = threadIdx.x; i < N_CONST; i += blockDim.x) c[i] = MONT_CONSTS[i];\n"
              "  __syncthreads();\n")
_K6_MIN = "constexpr int MIN_BLOCKS = 8;"
_K14_ROLLED = "constexpr bool LEAF_ROLLED = true;"
# kernel name -> (source, {variant: [(text, replacement)]})
VARIANTS = {
    "bary_eval": ("open_reduce.cu", {
        "as built: 16 loads ahead, at most 128 registers": [],
        "8 loads ahead": [(_K12_LOADS, "constexpr int BARY_UNROLL = 8;")],
        "32 loads ahead, no register cap": [(_K12_LOADS, "constexpr int BARY_UNROLL = 32;"),
                                            (_K12_BOUNDS, _K12_BOUNDS.replace("(THREADS, 2)", "(THREADS)"))],
    }),
    "fri_grind": ("dt_blake3.cu", {
        "as built: first wave 16·2^bits": [],
        "first wave 4·2^bits": [(_K8_FIRST, "const int64_t first = (int64_t)4 << bits < n ? (int64_t)4 << bits : n;")],
        "first wave every candidate": [(_K8_FIRST, "const int64_t first = n;")],
        "no early exit (every candidate hashed)": [
            ("    if (w != first && ~*least < w) break;  // a smaller candidate passed (the first is hashed regardless)\n",
             "")],
    }),
    "claims_fp": ("claims_fp.cu", {
        "as built: 4 claims a thread, 128 threads a block": [],
        "2 claims a thread": [(_K9_ITEMS, "constexpr int ITEMS = 2;")],
        "8 claims a thread": [(_K9_ITEMS, "constexpr int ITEMS = 8;")],
        "16 claims a thread": [(_K9_ITEMS, "constexpr int ITEMS = 16;")],
        "256 threads a block": [(_K9_THREADS, "constexpr int THREADS = 256;")],
    }),
    "poseidon2_merkle": ("poseidon2_merkle.cu", {
        "as built: constants in constant memory, 8 blocks per SM (at most 64 registers)": [],
        "constants staged in shared memory": [(_K6_BANK, _K6_STAGED)],
        "4 blocks per SM (at most 128 registers)": [(_K6_MIN, "constexpr int MIN_BLOCKS = 4;")],
        "16 blocks per SM (at most 32 registers)": [(_K6_MIN, "constexpr int MIN_BLOCKS = 16;")],
    }),
    "lde_tile": ("commit_tile.cu", {
        "as built: the leaf's partial rounds rolled": [],
        "the leaf's partial rounds unrolled": [(_K14_ROLLED, "constexpr bool LEAF_ROLLED = false;")],
    }),
}
# (kernel, variant) -> {attribute of the kernel's Python module: value while the variant runs}
OVERRIDES = {
    ("poseidon2_merkle", "4 blocks per SM (at most 128 registers)"): {"RESIDENT": 4},
    ("poseidon2_merkle", "16 blocks per SM (at most 32 registers)"): {"RESIDENT": 16},
}


def build_variants(kernels, only) -> dict:
    """{(kernel, variant): library path}: one nvcc per variant of the
    kernels `only`, all at once."""
    jobs = {}
    for kname, (source, variants) in VARIANTS.items():
        if kname not in only:
            continue
        text = open(os.path.join(kernels.CSRC_DIR, source)).read()
        for i, (vname, subs) in enumerate(variants.items()):
            out = text
            for old, new in subs:
                if old not in out:
                    raise SystemExit(f"variant_sweep: {kname} / {vname}: the source no longer holds {old!r}")
                out = out.replace(old, new)
            d = os.path.join(kernels.BUILD_DIR, "variants", f"{kname}_{i}")
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(kernels.CSRC_DIR, d)
            with open(os.path.join(d, source), "w") as f:
                f.write(out)
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", os.path.join(d, "lib.so"),
                   os.path.join(d, source)]
            jobs[kname, vname] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (d, proc) in jobs.items():
        report, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"variant_sweep: {key} did not build:\n{report}")
        with open(os.path.join(d, "ptxas.log"), "w") as f:
            f.write(report)
        libs[key] = os.path.join(d, "lib.so")
    return libs


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from multistark_tpu_torch import commit_tile as ct, device_transcript as dt, kernels, lookup as lk, pcs
    from multistark_tpu_torch.fields.device import BB4_OPS, BB_OPS, GL2_OPS, GL_OPS
    from multistark_tpu_torch.hash import poseidon2 as p2
    from multistark_tpu_torch.merkle import Poseidon2FieldHasher
    from multistark_tpu_torch.ntt import ntt as nt
    from tile_sweep import device_ms

    if not torch.cuda.is_available():
        raise SystemExit("variant_sweep: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[variants] {smi}", flush=True)
    kernels.library()
    built = kernels._LIB
    t0 = time.perf_counter()
    only = argv or list(VARIANTS)
    unknown = set(only) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"variant_sweep: no variants of {sorted(unknown)}")
    libs = build_variants(kernels, only)
    print(f"[variants] built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    cases = {}  # kernel -> [(label, fn, profiled kernel)]
    for F, E in ((GL_OPS, GL2_OPS), (BB_OPS, BB4_OPS)):
        D, hf, n = E.D, F.host, 1 << 18
        mats = [F.from_np(rng.integers(0, F.p, (w, 4 * n), dtype=np.uint64), dev) for w in (14, 13 * D, D)]
        zs = [F.from_np(rng.integers(0, F.p, D, dtype=np.uint64), dev) for _ in range(2)]
        invs = [F.from_np(rng.integers(0, F.p, (D, n), dtype=np.uint64), dev) for _ in range(2)]
        x = F.from_np(rng.integers(0, F.p, n, dtype=np.uint64), dev)
        s_n = hf.pow(hf.generator, n)
        inv_ns = hf.inv(hf.mul(n % hf.p, s_n))
        cases.setdefault("bary_eval", []).append((
            f"{F.name} trace height 2^18, matrices (14, 2), ({13 * D}, 2), ({D}, 1)",
            lambda E=E, mats=mats, zs=zs, invs=invs, x=x, s_n=s_n, inv_ns=inv_ns: pcs.bary_eval_height(
                E, mats, 18, [[0, 1], [0, 1], [0]], zs, invs, x, s_n, inv_ns), kernels.BARY_EVAL))
        b, g = (F.from_np(rng.integers(0, F.p, D, dtype=np.uint64), dev) for _ in range(2))
        for log_c in (14, 18):
            claims = F.from_np(rng.integers(0, F.p, (1 << log_c, 4), dtype=np.uint64), dev)
            cases.setdefault("claims_fp", []).append((
                f"{F.name} 2^{log_c} claims of 4 values",
                lambda E=E, claims=claims, b=b, g=g: lk.claims_acc(E, claims, b, g), kernels.CLAIMS_FP))
    inp = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 16).astype(np.int32)).to(dev)

    def rounds():
        chain = inp[:8]
        for _ in range(18):
            chain = dt.fri_grind(torch.cat([chain, inp[8:]]), 10, 2)[3]
        return chain

    cases["fri_grind"] = [("one round, L = 16, 10 bits", lambda: dt.fri_grind(inp, 10, 2), kernels.FRI_GRIND),
                          ("18 chained rounds", rounds, kernels.FRI_GRIND)]
    levels = [BB_OPS.from_np(rng.integers(0, BB_OPS.p, (8, 1 << k), dtype=np.uint64), dev) for k in range(19, 1, -1)]
    lde = BB_OPS.from_np(rng.integers(0, BB_OPS.p, (14, 1 << 20), dtype=np.uint64), dev)
    cases["poseidon2_merkle"] = [
        ("(8, 2^19), the first FRI level", lambda: p2.hash_rows([levels[0]]), kernels.POSEIDON2_MERKLE),
        ("(14, 2^20)", lambda: p2.hash_rows([lde]), kernels.POSEIDON2_MERKLE),
        ("the 2^18 prove's 18 FRI levels in a row", lambda: [p2.hash_rows([m]) for m in levels],
         kernels.POSEIDON2_MERKLE)]
    eng, hasher = nt.NttEngine(BB_OPS, BB_OPS.host, dev), Poseidon2FieldHasher()
    cases["lde_tile"] = []
    for cols in (14, 52):
        x = BB_OPS.from_np(rng.integers(0, BB_OPS.p, (cols, 1 << 20), dtype=np.uint64), dev)
        k = ct.tile_log_for(cols, 20, True)
        levels_in = pcs.commit_plan([cols], [20], 0, 0)[0].levels
        tw = eng.tail_table(k, False)
        cases["lde_tile"].append((
            f"BabyBear ({cols}, 2^20) hashed, tile 2^{k}, {levels_in} levels",
            lambda x=x, k=k, tw=tw, levels_in=levels_in: ct.lde_tile(BB_OPS, hasher, x.clone(), k, tw, levels_in, {},
                                                                     True), kernels.LDE_TILE))

    def flat(out):
        items = out if isinstance(out, (list, tuple)) else [out]
        return torch.cat([flat(t) if isinstance(t, (list, tuple)) else t.reshape(-1).to(torch.int64) for t in items])

    for kname, runs in cases.items():
        if kname not in only:
            continue
        wants = [flat(fn()) for _, fn, _ in runs]
        for turn in (1, 2):
            for (k, vname), path in libs.items():
                if k != kname:
                    continue
                lib = ctypes.CDLL(path)
                for entry in ("bary_height", "fri_grind", "claims_acc", "p2_hash_rows", "p2_load_constants", "p2_chain",
                              "lde_tile"):
                    if hasattr(lib, entry):
                        getattr(lib, entry).argtypes = kernels._SIGNATURES[entry]
                        getattr(lib, entry).restype = ctypes.c_int
                for entry, (argtypes, restype) in kernels._HELPERS.items():
                    if hasattr(lib, entry):
                        getattr(lib, entry).argtypes = argtypes
                        getattr(lib, entry).restype = restype
                kernels._LIB = lib
                p2._CONSTANT_BANK.clear()  # a library's constant memory is its own
                saved = {a: getattr(p2, a) for a in OVERRIDES.get((kname, vname), {})}
                for a, val in OVERRIDES.get((kname, vname), {}).items():
                    setattr(p2, a, val)
                try:
                    for (label, fn, kernel), want in zip(runs, wants):
                        if not torch.equal(flat(fn()), want):
                            raise AssertionError(f"variant_sweep: {kname} / {vname} disagrees with the built library")
                        print(f"[variants] {kname} turn {turn}, {vname}: {label}: device {device_ms(fn, kernel)} ms",
                              flush=True)
                finally:
                    kernels._LIB = built
                    p2._CONSTANT_BANK.clear()
                    for a, val in saved.items():
                        setattr(p2, a, val)
        for (k, vname), path in libs.items():
            if k == kname:
                report = chip_smoke.ptxas_kernels(os.path.join(os.path.dirname(path), "ptxas.log"),
                                                  getattr(kernels, kname.upper()).functions)
                print(f"[variants] {kname}, {vname}: ptxas {report}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
