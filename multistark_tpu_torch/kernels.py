"""Build, load and count the port's fifteen hand-written CUDA kernels.

Each source under csrc/ compiles with its own nvcc process (all started
together) into an object, and the objects link into one shared library with
a plain C interface, loaded with ctypes.  The build runs at first use into
build/torch_kernels/ (listed in .gitignore) and again whenever a source or
header is newer than the library, under an exclusive flock on that
directory, so that ranks started together build once and never load a
half-written library.  Nothing here runs at import: the CPU
tests import every module on a machine without nvcc.

Each kernel is a `CudaKernel` whose `launches` counter rises by one each
time one of its C entry points is launched, and only there; its
`functions` name the CUDA functions it runs, as a profiler reports them
(spans.py groups device time by them).  Each launch site states the bytes
its launch must move (each operand read once, each output written once)
and, where hashing, grinding or an inversion dominates, its 32-bit integer
operations, and where a chain of dependent BLAKE3 compressions or
Poseidon2 permutations is longer than either, that chain's latency; `bound_ms` sums the least time those
take on one H100 over the kernel's launches (spans.py prints it per warm
prove).  Launch sites that count bytes only give a bound that is still a
least time.

K11's kernels are not in the library: program.py builds one per recorded
program from the template csrc/expr_sweep.cu.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from .native import build_lock

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libmstorch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_vp, _i32, _i64, _u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s,
# and 32-bit operations/s on the CUDA cores (the float32 non-tensor rate;
# integer instructions run no faster, so this gives the least time).  32-bit
# operations per modular product by field id (the 32x32 partial products
# and the reduction's multiplies), per BLAKE3 compression (7 rounds x 8 G
# functions x 14 add/xor/rotate) and per Poseidon2 permutation (772
# BabyBear products).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
OPS_PER_MUL = (12, 6)
OPS_PER_BLAKE3 = 7 * 8 * 14
OPS_PER_POSEIDON2 = 772 * OPS_PER_MUL[1]
OPS_PER_HASH = (OPS_PER_BLAKE3, OPS_PER_POSEIDON2)  # by hasher kernel_id
# One BLAKE3 compression's latency on one thread (ms): chip_smoke.py's chain
# of 4096 dependent compressions (commit_tile.node_chain) on an NVIDIA H100
# 80GB HBM3 at 700 W.  A chain of k dependent compressions takes at least k
# times this.
BLAKE3_LATENCY_MS = 0.7484e-3
# One extension product's latency on one thread (ms) by field id (GL2, BB4):
# chip_smoke.py's chain of 4096 dependent squarings (ExtOps.chain) on an
# NVIDIA H100 80GB HBM3 at 700 W.  The powers entry's floor is
# ceil(log2 count) times this.
EXT_MUL_LATENCY_MS = (0.1907e-3, 0.4940e-3)
# One extension inversion's latency on one thread (ms) by field id (GL2,
# BB4): chip_smoke.py's chain of 1024 dependent inversions
# (lookup.ext_inv_chain) on an NVIDIA H100 80GB HBM3 at 700 W: K9's
# latency floor.
EXT_INV_LATENCY_MS = (6.2193e-3, 3.3828e-3)
# One Poseidon2 permutation's latency (ms) on one thread and on one group of
# four lanes, K6's two modes (hash/poseidon2.MODE_THREAD, MODE_LANES):
# chip_smoke.py's chains of 4096 dependent permutations
# (hash/poseidon2.permute_chain) on an NVIDIA H100 80GB HBM3 at 700 W.  A
# row of c chunks takes at least c times the lesser, whichever mode runs it.
POSEIDON2_LATENCY_MS = (9.2161e-3, 3.7300e-3)


def least_ms(n_bytes: float, ops: float = 0, latency_ms: float = 0) -> float:
    """The least milliseconds one H100 takes to move n_bytes, do ops and run
    a dependency chain of latency_ms."""
    return max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S, latency_ms)

# C entry point -> argument types (the stream is always the last c_void_p)
_SIGNATURES = {
    "gl_arith": [_i32, _vp, _i64, _i64, _vp, _i64, _i64, _i32, _vp, _i64, _i64, _u64, _vp],
    "bb_arith": [_i32, _vp, _i64, _i64, _vp, _i64, _i64, _i32, _vp, _i64, _i64, _u64, _vp],
    "gl_powers": [_vp, _vp, _i64, _vp],
    "bb_powers": [_vp, _vp, _i64, _vp],
    "gl_ext_chain": [_vp, _i32, _vp],
    "bb_ext_chain": [_vp, _i32, _vp],
    "ntt_pass": [_i32, _vp, _i64, _i32, _i32, _i32, _vp, _i32, _vp],
    "b3_hash_rows": [_vp, _vp, _i32, _i64, _vp, _vp],
    "b3_fri_leaves": [_vp, _i32, _i32, _i64, _vp, _vp, _vp],
    "p2_hash_rows": [_vp, _vp, _i32, _i64, _i32, _i64, _i32, _vp, _vp, _vp],
    "p2_load_constants": [_vp, _vp],
    "p2_chain": [_i32, _vp, _i32, _vp, _vp],
    "gls_batch_inv": [_i32, _i32, _vp, _vp, _i64, _i64, _vp],
    "gls_inv_sum": [_i32, _i32, _vp, _vp, _i64, _i64, _vp, _vp, _vp],
    "gls_sum": [_i32, _vp, _vp, _i64, _i64, _vp, _vp, _vp],
    "gls_cumsum": [_i32, _vp, _vp, _i64, _i64, _vp, _u64, _u64, _vp],
    "gls_stage2_chain": [_i32, _vp, _i64, _i32, _vp, _vp, _vp, _vp, _u64, _u64, _vp],
    "dt_flush": [_vp, _vp, _vp, _vp, _i64, _vp, _vp, _vp],
    "fri_grind": [_vp, _i64, _i32, _i32, _vp, _vp, _vp, _vp],
    "claims_acc": [_i32, _vp, _i64, _i64, _vp, _vp, _vp, _vp, _vp, _vp],
    "claims_inv_chain": [_i32, _vp, _i32, _vp],
    "fri_fold_level": [_i32, _vp, _i64, _i64, _i64, _i32, _i32, _i64, _vp, _vp, _u64, _vp, _vp, _vp, _vp],
    "bary_height": [_i32, _vp, _vp, _vp, _vp, _i32, _vp, _i32, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _u64, _u64,
                    _vp, _vp, _vp],
    "ro_scalars": [_i32, _vp, _vp, _i32, _vp, _vp, _vp, _i32, _i32, _vp, _i64, _vp, _vp],
    "ro_rows": [_i32, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _i32, _i64, _vp, _i32, _i64, _vp, _i32, _vp, _vp],
    "lde_tile": [_i32, _i32, _vp, _i32, _i32, _i32, _vp, _i32, _vp, _vp, _i32, _vp, _vp],
    "merkle_levels": [_i32, _vp, _i32, _i32, _vp, _vp, _vp, _i32, _i32, _vp, _i64, _vp, _vp],
    "node_chain": [_i32, _vp, _i32, _vp, _vp],
}

# host helpers of the library that launch nothing: (argument types, return type)
_HELPERS = {"gls_tiles": ([_i32, _i32, _i32, _i64], _i64), "claims_acc_blocks": ([_i64], _i64)}
# K11's template: every recorded program builds its own kernel from it (program.py), not the library
PROGRAM_TEMPLATE = os.path.join(CSRC_DIR, "expr_sweep.cu")

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Dict[str, float] = {}  # source file name -> seconds from the build's start to its nvcc's end


def sources() -> list:
    return sorted(p for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")) if p != PROGRAM_TEMPLATE)


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def nvcc_path() -> str:
    """CUDA_HOME's nvcc (default /usr/local/cuda), else the one on PATH."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def ptxas_log(source: str) -> str:
    """Where the build keeps a source's `-Xptxas -v` report (registers and
    spills of each kernel)."""
    return os.path.join(BUILD_DIR, f"{os.path.basename(source)}.ptxas.log")


def build(force: bool = False) -> float:
    """Compile csrc/*.cu into the shared library if it is missing or stale:
    one nvcc per source, all at once, then one link, under an exclusive
    flock on build/torch_kernels/ (native.build_lock).  Returns the seconds
    spent (0 if nothing was built); BUILD_SECONDS keeps when each source's
    nvcc finished.  Raises CalledProcessError with nvcc's output if a step
    fails."""
    with build_lock(BUILD_DIR):
        return _build(force)


def _build(force: bool) -> float:
    if not (force or _stale()):
        return 0.0
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs = {s: os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in sources()}
    logs = {s: open(ptxas_log(s), "w") for s in sources()}
    procs = {s: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                                 stdout=logs[s], stderr=subprocess.STDOUT, text=True)
             for s, o in objs.items()}
    try:
        pending = dict(procs)
        while pending:
            for src, proc in list(pending.items()):
                if proc.poll() is None:
                    continue
                del pending[src]
                BUILD_SECONDS[os.path.basename(src)] = time.perf_counter() - t0
                logs[src].close()
                if proc.returncode != 0:
                    with open(ptxas_log(src)) as f:
                        report = f.read()
                    sys.stderr.write(f"nvcc failed on {src}:\n{report}")
                    raise subprocess.CalledProcessError(proc.returncode, proc.args, output=report)
            if pending and time.perf_counter() - t0 > 900:
                raise subprocess.TimeoutExpired(next(iter(pending.values())).args, 900)
            time.sleep(0.05)
        tmp = f"{LIB_PATH}.{tag}"
        subprocess.run([nvcc_path(), "-shared", "-o", tmp, *objs.values()], check=True, capture_output=True,
                       text=True, timeout=900)
        os.replace(tmp, LIB_PATH)
    finally:
        for src, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logs[src].close()
        for o in objs.values():
            if os.path.exists(o):
                os.remove(o)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        with build_lock(BUILD_DIR):
            _build(False)
            lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _HELPERS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def use_kernel(t: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper: True for a CUDA tensor
    (launch the kernel), False for a CPU tensor (its plain PyTorch version);
    any other device raises.  Never falls back from CUDA to the plain path."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class CudaKernel:
    """One hand-written kernel: its source, the TPU program it replaces, the
    CUDA functions it runs (name fragments of the profiler's kernel names),
    how many of them one launch of an entry point runs, and a count of its
    launches."""

    def __init__(self, name: str, source: str, replaces: str, functions: Tuple[str, ...], per_launch: int = 1):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.functions = functions
        self.per_launch = per_launch
        self.launches = 0
        self.bound_ms = 0.0

    def launch(self, entry: str, *args, cost: Tuple[float, ...], lib: Optional[ctypes.CDLL] = None) -> None:
        """Call C entry point `entry` of the kernel library (or of `lib`) on
        the current stream; raise on a CUDA error code.  cost: (bytes the
        launch must move, its 32-bit operations or 0[, the latency in ms of
        its longest chain of dependent steps]), added to bound_ms."""
        rc = getattr(lib or library(), entry)(*args, current_stream())
        if rc != 0:
            raise RuntimeError(f"{self.name}: {entry} failed with cudaError_t {rc}")
        self.launches += 1
        self.bound_ms += least_ms(*cost)


GL_ARITH = CudaKernel(
    "gl_arith", "multistark_tpu_torch/csrc/gl_arith.cu",
    "multistark_tpu/fields/device.py:129",
    ("arith_kernel<Goldilocks", "powers_kernel<Goldilocks"),
)
NTT_STAGE = CudaKernel(
    "ntt_stage", "multistark_tpu_torch/csrc/ntt_stage.cu",
    "multistark_tpu/ntt/ntt.py:405",
    ("ntt_pass_kernel",),
)
BLAKE3_MERKLE = CudaKernel(
    "blake3_merkle", "multistark_tpu_torch/csrc/blake3_merkle.cu",
    "multistark_tpu/hash/blake3.py:222",
    ("b3_hash_rows_kernel", "b3_fri_leaves_kernel"),
)
GL_SCAN = CudaKernel(
    "gl_scan", "multistark_tpu_torch/csrc/gl_scan.cu",
    "multistark_tpu/utils.py:219",
    ("batch_inv_kernel<", "::sum_kernel<", "cumsum_kernel<", "stage2_chain_kernel<"),
)
BB_ARITH = CudaKernel(
    "bb_arith", "multistark_tpu_torch/csrc/bb_arith.cu",
    "multistark_tpu/fields/device.py:208",
    ("arith_kernel<BabyBear", "powers_kernel<BabyBear"),
)
POSEIDON2_MERKLE = CudaKernel(
    "poseidon2_merkle", "multistark_tpu_torch/csrc/poseidon2_merkle.cu",
    "multistark_tpu/hash/poseidon2.py:295",
    ("p2_hash_rows_kernel", "p2_hash_rows4_kernel"),
)
DT_FLUSH = CudaKernel(
    "dt_flush", "multistark_tpu_torch/csrc/dt_blake3.cu",
    "multistark_tpu/device_transcript.py:358",
    ("flush_chunks_kernel", "flush_root_kernel"), per_launch=2,
)
FRI_GRIND = CudaKernel(
    "fri_grind", "multistark_tpu_torch/csrc/dt_blake3.cu",
    "multistark_tpu/device_transcript.py:74",
    ("fri_grind_kernel",),
)
CLAIMS_FP = CudaKernel(
    "claims_fp", "multistark_tpu_torch/csrc/claims_fp.cu",
    "multistark_tpu/lookup.py:507",
    ("claims_acc_kernel",),
)
FRI_FOLD = CudaKernel(
    "fri_fold", "multistark_tpu_torch/csrc/fri_fold.cu",
    "multistark_tpu/pcs.py:1379",
    ("fri_fold_level_kernel",),
)
EXPR_SWEEP = CudaKernel(
    "expr_sweep", "multistark_tpu_torch/csrc/expr_sweep.cu",
    "multistark_tpu/prover.py:640",
    ("expr_sweep_kernel",),
)
BARY_EVAL = CudaKernel(
    "bary_eval", "multistark_tpu_torch/csrc/open_reduce.cu",
    "multistark_tpu/pcs.py:1256",
    ("bary_height_kernel",),
)
REDUCED_OPEN = CudaKernel(
    "reduced_open", "multistark_tpu_torch/csrc/open_reduce.cu",
    "multistark_tpu/pcs.py:1284",
    ("ro_scalars_kernel", "ro_rows_kernel"),
)
LDE_TILE = CudaKernel(
    "lde_tile", "multistark_tpu_torch/csrc/commit_tile.cu",
    "multistark_tpu/pcs.py:189",
    ("lde_tile_kernel",),
)
MERKLE_LEVELS = CudaKernel(
    "merkle_levels", "multistark_tpu_torch/csrc/commit_tile.cu",
    "multistark_tpu/merkle.py:275",
    ("merkle_tree_kernel",),
)
KERNELS = (GL_ARITH, NTT_STAGE, BLAKE3_MERKLE, GL_SCAN, BB_ARITH, POSEIDON2_MERKLE, DT_FLUSH, FRI_GRIND, CLAIMS_FP,
           FRI_FOLD, EXPR_SWEEP, BARY_EVAL, REDUCED_OPEN, LDE_TILE, MERKLE_LEVELS)


# Layout copies that a kernel could have made itself, by name, counted where
# they run beside the kernels' launches: "fold_rows" is a FRI level's
# (A·D, N/A) matrix built by PyTorch (utils.fold_rows) and not by K3's FRI
# entry or K10.
COPIES: Dict[str, int] = defaultdict(int)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def bounds_ms() -> Dict[str, float]:
    return {k.name: k.bound_ms for k in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launches, and the layout copies, to 0."""
    for k in KERNELS:
        k.launches = 0
    COPIES.clear()


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(*tensors: torch.Tensor) -> None:
    """Validate kernel operands: int64 (or int32 digests), contiguous, on
    one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"kernel operand of dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operand must be contiguous")
