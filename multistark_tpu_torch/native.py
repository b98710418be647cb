"""The port's host C helper: csrc/host/*.c (BLAKE3 with its grind, the
chunk chaining values of a device-duplex flush and the verifier's batched
row hashes and pair compressions; the Poseidon2 permutation with the duplex
absorb and grind and the verifier's batched row hashes and compressions),
built with `cc` into
build/torch_kernels/libmshost.so at first use and again whenever a source
is newer than the library, under an exclusive flock on that directory
(`build_lock`, which kernels.py takes too).

The Fiat-Shamir transcripts and the verifier of both configs run on the
host; at 2^18 claims they are not worth running in pure Python, so a failed
build raises (there is no Python fallback).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import subprocess
from contextlib import contextmanager
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
HOST_SRC_DIR = os.path.join(PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libmshost.so")

_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64, _u32 = ctypes.c_uint64, ctypes.c_uint32

# C entry point -> (argument types, return type)
_SIGNATURES = {
    "msb3_hash": ([ctypes.c_char_p, _u64, ctypes.POINTER(ctypes.c_uint8)], None),
    "msb3_grind": ([ctypes.c_char_p, _u64, _u64, _u64, _u32, _u64], _u64),
    "msb3_hash_batch": ([ctypes.c_char_p, _u64, _u64, _u64, _u32p], None),
    "msb3_compress_pairs": ([_u32p, _u32p, _u64, _u32p], None),
    "msb3_chunk_cvs": ([ctypes.c_char_p, _u64, _u32p], None),
    "msb3_parent_level": ([_u32p, _u64, _u32p], None),
    "msp2_permute": ([_u32p, _u32p], None),
    "msp2_absorb": ([_u32p, _u32p, _u32p, _u32p, _u64, _u32p], ctypes.c_int),
    "msp2_grind": ([_u32p, _u32p, _u32, _u32, _u64, _u32p], _u64),
    "msp2_hash_rows": ([_u32p, _u64, _u64, _u32p, _u32p], None),
    "msp2_compress_pairs": ([_u32p, _u32p, _u64, _u32p, _u32p], None),
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(HOST_SRC_DIR, "*.c")))


@contextmanager
def build_lock(build_dir: str):
    """An exclusive flock on the build directory itself: processes started
    together (the ranks of a mesh) build and load one at a time, so none
    loads a library another is still writing."""
    os.makedirs(build_dir, exist_ok=True)
    fd = os.open(build_dir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


def build(build_dir: str = BUILD_DIR, force: bool = False) -> str:
    """Compile csrc/host/*.c into build_dir/libmshost.so if it is missing or
    stale (or force), under `build_lock`; returns the library's path."""
    path = os.path.join(build_dir, os.path.basename(LIB_PATH))
    with build_lock(build_dir):
        srcs = sources()
        if force or not os.path.exists(path) or any(os.path.getmtime(s) > os.path.getmtime(path) for s in srcs):
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, *srcs], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, path)
    return path


def load(path: str) -> ctypes.CDLL:
    handle = ctypes.CDLL(path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle


def lib() -> ctypes.CDLL:
    """The loaded host helper, built first if missing or stale."""
    global _LIB
    if _LIB is None:
        path = build()
        with build_lock(BUILD_DIR):
            _LIB = load(path)
    return _LIB
