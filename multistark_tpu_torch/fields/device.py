"""Goldilocks and GL2 arithmetic on torch tensors: kernel K1 (gl_arith).

An element is one ``torch.int64`` holding the canonical u64 bit pattern (the
JAX package's two u32 planes exist only because the TPU lacks a 64-bit
multiply).  An extension array is coordinate-major: shape ``(2, ...)`` with
coordinate d of every element in ``x[d]``.

Each op dispatches on the device of its operands: a CUDA tensor launches the
hand-written kernel (csrc/gl_arith.cu), a CPU tensor takes the plain PyTorch
version beside it, anything else raises.  The plain versions compute in
int64 with wrapping add/mul, masked logical shifts and sign-flipped unsigned
compares (CPU torch has no u64 add, shift or compare); they run on any
device, which is how the kernel is held against them on the card.

Broadcasting follows the kernel's rule on every device: an operand must
have the output's shape, or the output's trailing dimensions (repeated over
the leading ones), or a single element.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .host import GOLDILOCKS, GOLDILOCKS_EXT2

P = GOLDILOCKS.p
P_I64 = P - (1 << 64)  # p's bit pattern as an int64
EPS = 0xFFFFFFFF  # 2^64 - p
W = GOLDILOCKS_EXT2.w
_SIGN = -(1 << 63)


# --- plain PyTorch versions (any device) --------------------------------------

def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _hi32(a: torch.Tensor) -> torch.Tensor:
    return (a >> 32) & EPS


def _canon(r: torch.Tensor) -> torch.Tensor:
    return torch.where(_ult(r, P_I64), r, r - P_I64)


def add_plain(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + EPS, s)
    return _canon(s)


def sub_plain(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - EPS, d)


def neg_plain(a):
    return torch.where(a == 0, a, P_I64 - a)


def mul_plain(a, b):
    a0, a1 = a & EPS, _hi32(a)
    b0, b1 = b & EPS, _hi32(b)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _hi32(p00) + (p01 & EPS) + (p10 & EPS)  # < 3·2^32
    lo = (p00 & EPS) | ((mid & EPS) << 32)
    hi = p11 + _hi32(p01) + _hi32(p10) + (mid >> 32)  # exact high word
    x2, x3 = hi & EPS, _hi32(hi)
    t0 = lo - x3
    t0 = torch.where(_ult(lo, x3), t0 - EPS, t0)
    r = t0 + x2 * EPS
    r = torch.where(_ult(r, t0), r + EPS, r)
    return _canon(r)


def pow_plain(a, e: int):
    r = torch.ones_like(a)
    while e:
        if e & 1:
            r = mul_plain(r, a)
        a = mul_plain(a, a)
        e >>= 1
    return r


def inv_plain(a):
    """Fermat inverse; 0 maps to 0."""
    return pow_plain(a, P - 2)


def ext_mul_plain(a, b):
    c0 = add_plain(mul_plain(a[0], b[0]), mul_plain(mul_plain(a[1], b[1]), W))
    c1 = add_plain(mul_plain(a[0], b[1]), mul_plain(a[1], b[0]))
    return torch.stack(torch.broadcast_tensors(c0, c1))


def ext_scale_plain(a, s):
    return torch.stack(torch.broadcast_tensors(mul_plain(a[0], s), mul_plain(a[1], s)))


def ext_inv_plain(a):
    """(a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2); 0 maps to 0."""
    norm = sub_plain(mul_plain(a[0], a[0]), mul_plain(mul_plain(a[1], a[1]), W))
    ninv = inv_plain(norm)
    return torch.stack([mul_plain(a[0], ninv), neg_plain(mul_plain(a[1], ninv))])


# --- dispatch -------------------------------------------------------------------

_OPS = {
    "add": (0, add_plain), "sub": (1, sub_plain), "neg": (2, neg_plain),
    "mul": (3, mul_plain), "pow": (4, pow_plain), "inv": (5, inv_plain),
    # the extension adds and subtracts coordinatewise
    "ext_add": (10, add_plain), "ext_sub": (11, sub_plain),
    "ext_mul": (13, ext_mul_plain), "ext_scale": (14, ext_scale_plain),
    "ext_inv": (15, ext_inv_plain),
}


def _elem_shape(t: torch.Tensor, ext: bool) -> Tuple[int, ...]:
    if ext:
        if t.dim() == 0 or t.shape[0] != 2:
            raise ValueError(f"extension operand needs a leading axis of 2, got {tuple(t.shape)}")
        return tuple(t.shape[1:])
    return tuple(t.shape)


def _period(shape: Tuple[int, ...], out: Tuple[int, ...]) -> int:
    """Elements of an operand of `shape` broadcast to `out` by period."""
    n = int(np.prod(shape, dtype=np.int64))
    trimmed = list(shape)
    while trimmed and trimmed[0] == 1:
        trimmed.pop(0)
    if n == 1 or tuple(trimmed) == tuple(out[len(out) - len(trimmed):]):
        return n
    raise ValueError(f"operand of shape {shape} does not broadcast by period to {out}")


def _apply(name: str, a: torch.Tensor, b: Optional[torch.Tensor] = None, e: int = 0):
    code, plain = _OPS[name]
    ext = name.startswith("ext_")
    sa = _elem_shape(a, ext)
    sb = None if b is None else _elem_shape(b, ext and name != "ext_scale")
    out_shape = tuple(torch.broadcast_shapes(sa, sb)) if sb is not None else sa
    _period(sa, out_shape)
    if sb is not None:
        _period(sb, out_shape)
    if b is not None and b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != torch.int64 or (b is not None and b.dtype != torch.int64):
        raise TypeError("field operands are int64 tensors")
    if not kernels.use_kernel(a):
        if name == "pow":
            return plain(a, e)
        if ext:  # align the per-coordinate shapes behind the coordinate axis
            a = a.reshape((2,) + (1,) * (len(out_shape) - len(sa)) + sa)
            if sb is not None and name != "ext_scale":
                b = b.reshape((2,) + (1,) * (len(out_shape) - len(sb)) + sb)
        return plain(a) if b is None else plain(a, b)
    return _launch(code, ext, a, b, out_shape, e)


def _launch(code, ext, a, b, out_shape, e):
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    kernels.check_cuda(a, *(() if b is None else (b,)))
    n = int(np.prod(out_shape, dtype=np.int64))
    out = torch.empty(((2,) if ext else ()) + tuple(out_shape), dtype=torch.int64, device=a.device)
    na = a.numel() // (2 if ext else 1)
    if b is None:
        bp, nb, cb = None, 1, 0
    else:
        nb = b.numel() // (2 if (ext and code != 14) else 1)
        bp, cb = kernels.ptr(b), nb
    kernels.GL_ARITH.launch(
        "gl_arith", code, kernels.ptr(a), na, na, bp, nb, cb, kernels.ptr(out), n, e % (1 << 64),
    )
    return out


def add(a, b):
    return _apply("add", a, b)


def sub(a, b):
    return _apply("sub", a, b)


def neg(a):
    return _apply("neg", a)


def mul(a, b):
    return _apply("mul", a, b)


def square(a):
    return _apply("mul", a, a)


def pow(a, e: int):  # noqa: A001 - the field op's name
    return _apply("pow", a, e=e)


def inv(a):
    return _apply("inv", a)


def ext_add(a, b):
    return _apply("ext_add", a, b)


def ext_sub(a, b):
    return _apply("ext_sub", a, b)


def ext_mul(a, b):
    return _apply("ext_mul", a, b)


def ext_square(a):
    return _apply("ext_mul", a, a)


def ext_scale(a, s):
    """Extension array times a base array."""
    return _apply("ext_scale", a, s)


def ext_inv(a):
    return _apply("ext_inv", a)


# --- host boundary ----------------------------------------------------------------

def from_np(arr, device) -> torch.Tensor:
    """uint64 numpy (canonical values) -> int64 tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def const(value: int, device) -> torch.Tensor:
    """A base scalar (shape ()) on `device`."""
    return from_np(np.uint64(value % P), device).reshape(())


def ext_const(coords: Sequence[int], device) -> torch.Tensor:
    """A host extension value as a (2,) tensor on `device`."""
    return from_np(np.asarray([int(c) % P for c in coords], np.uint64), device)


def ext_from_base(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, torch.zeros_like(a)])


def ext_to_host(t: torch.Tensor) -> list:
    """(2, ...) tensor -> nested host ext tuples along the trailing axes."""
    arr = to_np(t)
    return [tuple(int(c) for c in v) for v in np.moveaxis(arr, 0, -1).reshape(-1, arr.shape[0])]
