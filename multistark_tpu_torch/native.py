"""The port's host C helper: csrc/host/*.c (BLAKE3 with its grind and the
chunk chaining values of a device-duplex flush; the Poseidon2 permutation
with the duplex absorb and grind), built with `cc` into
build/torch_kernels/libmshost.so at first use and again whenever a source
is newer than the library.

The Fiat-Shamir transcripts of both configs run on the host; at 2^18
claims they are not worth running in pure Python, so a failed build
raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
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
    "msb3_chunk_cvs": ([ctypes.c_char_p, _u64, _u32p], None),
    "msb3_parent_level": ([_u32p, _u64, _u32p], None),
    "msp2_permute": ([_u32p, _u32p], None),
    "msp2_absorb": ([_u32p, _u32p, _u32p, _u32p, _u64, _u32p], ctypes.c_int),
    "msp2_grind": ([_u32p, _u32p, _u32, _u32, _u64, _u32p], _u64),
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(HOST_SRC_DIR, "*.c")))


def lib() -> ctypes.CDLL:
    """The loaded host helper, built first if missing or stale."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sources()
    if not os.path.exists(LIB_PATH) or any(os.path.getmtime(s) > os.path.getmtime(LIB_PATH) for s in srcs):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"  # concurrent processes each rename atomically
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, *srcs], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, LIB_PATH)
    handle = ctypes.CDLL(LIB_PATH)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = handle
    return handle
