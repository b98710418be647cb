"""Field arithmetic on torch tensors: kernels K1 (gl_arith, Goldilocks and
GL2) and K5 (bb_arith, BabyBear and BB4).

`GL_OPS`, `BB_OPS` (base fields) and `GL2_OPS`, `BB4_OPS` (their binomial
extensions) are named as in the JAX package.  An element of either base
field is one ``torch.int64`` holding its canonical value (the u64 bit
pattern for Goldilocks; the JAX package's u32 planes and BabyBear's
Montgomery form exist only inside the TPU programs).  An extension array is
coordinate-major: shape ``(D, ...)`` with coordinate d of every element in
``x[d]``.

Each op dispatches on the device of its operands: a CUDA tensor launches
the field's hand-written kernel (csrc/gl_arith.cu, csrc/bb_arith.cu), a CPU
tensor takes the plain PyTorch version beside it, anything else raises.
The Goldilocks plain versions compute in int64 with wrapping add/mul,
masked logical shifts and sign-flipped unsigned compares (CPU torch has no
u64 add, shift or compare); the BabyBear ones are exact in int64.  They run
on any device, which is how the kernels are held against them on the card.

Broadcasting follows the kernels' rule on every device: an operand must
have the output's shape, or the output's trailing dimensions (repeated over
the leading ones), or a single element.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .host import BABYBEAR, BABYBEAR_EXT4, GOLDILOCKS, GOLDILOCKS_EXT2, HostExtField, HostField

# --- plain PyTorch versions: Goldilocks ------------------------------------------

_GL_P_I64 = GOLDILOCKS.p - (1 << 64)  # p's bit pattern as an int64
_EPS = 0xFFFFFFFF  # 2^64 - p
_SIGN = -(1 << 63)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _hi32(a: torch.Tensor) -> torch.Tensor:
    return (a >> 32) & _EPS


def _gl_canon(r: torch.Tensor) -> torch.Tensor:
    return torch.where(_ult(r, _GL_P_I64), r, r - _GL_P_I64)


def _gl_add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + _EPS, s)
    return _gl_canon(s)


def _gl_sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - _EPS, d)


def _gl_neg(a):
    return torch.where(a == 0, a, _GL_P_I64 - a)


def _gl_mul(a, b):
    a0, a1 = a & _EPS, _hi32(a)
    b0, b1 = b & _EPS, _hi32(b)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _hi32(p00) + (p01 & _EPS) + (p10 & _EPS)  # < 3·2^32
    lo = (p00 & _EPS) | ((mid & _EPS) << 32)
    hi = p11 + _hi32(p01) + _hi32(p10) + (mid >> 32)  # exact high word
    x2, x3 = hi & _EPS, _hi32(hi)
    t0 = lo - x3
    t0 = torch.where(_ult(lo, x3), t0 - _EPS, t0)
    r = t0 + x2 * _EPS
    r = torch.where(_ult(r, t0), r + _EPS, r)
    return _gl_canon(r)


# --- plain PyTorch versions: BabyBear (values < 2^31, products exact in int64) --

_BB_P = BABYBEAR.p


def _bb_add(a, b):
    s = a + b
    return torch.where(s >= _BB_P, s - _BB_P, s)


def _bb_sub(a, b):
    d = a - b
    return torch.where(d < 0, d + _BB_P, d)


def _bb_neg(a):
    return torch.where(a == 0, a, _BB_P - a)


def _bb_mul(a, b):
    return torch.remainder(a * b, _BB_P)


# --- op codes (csrc/gl_arith.cu and csrc/bb_arith.cu share them) ----------------

_ADD, _SUB, _NEG, _MUL, _POW, _INV = 0, 1, 2, 3, 4, 5
_EXT_ADD, _EXT_SUB, _EXT_MUL, _EXT_SCALE, _EXT_INV = 10, 11, 13, 14, 15


def _period(shape: Tuple[int, ...], out: Tuple[int, ...]) -> Tuple[int, bool]:
    """Elements of an operand of `shape` broadcast to `out` by period, and
    whether it is a column: one element per row of out's last axis, as a
    (k, 1) operand against (..., k, P)."""
    n = int(np.prod(shape, dtype=np.int64))
    trimmed = tuple(shape[next((i for i, s in enumerate(shape) if s != 1), len(shape)):])
    if n == 1 or trimmed == tuple(out[len(out) - len(trimmed):]):
        return n, False
    if len(trimmed) >= 2 and trimmed[-1] == 1 and trimmed[:-1] == tuple(out[len(out) - len(trimmed):-1]):
        return n, True
    raise ValueError(f"operand of shape {shape} does not broadcast by period to {out}")


class FieldOps:
    """A prime field's elementwise ops over int64 tensors of canonical
    values, with the field's kernel and the plain versions beside it.
    `field_id` names the field to the kernels that serve both (K2, K4)."""

    def __init__(self, host: HostField, field_id: int, kernel, plain):
        self.host = host
        self.name = host.name
        self.p = host.p
        self.field_id = field_id
        self.kernel = kernel
        self.add_plain, self.sub_plain, self.neg_plain, self.mul_plain = plain
        self._consts = {}  # (value, device) -> the shape-() tensor `const` made

    # -- plain versions (any device) ---------------------------------------
    def pow_plain(self, a, e: int):
        r = torch.ones_like(a)
        while e:
            if e & 1:
                r = self.mul_plain(r, a)
            a = self.mul_plain(a, a)
            e >>= 1
        return r

    def inv_plain(self, a):
        """Fermat inverse; 0 maps to 0."""
        return self.pow_plain(a, self.p - 2)

    # -- dispatch ------------------------------------------------------------
    def _apply(self, code: int, plain, a, b=None, e: int = 0, D: int = 0, b_ext: bool = False):
        """Op `code` on a (D-coordinate extension if D) and b (an extension
        operand too if b_ext); the kernel for CUDA tensors, `plain` for CPU."""
        sa = _elem_shape(a, D)
        sb = None if b is None else _elem_shape(b, D if b_ext else 0)
        out_shape = tuple(torch.broadcast_shapes(sa, sb)) if sb is not None else sa
        na, a_col = _period(sa, out_shape)
        nb, b_col = (0, False) if sb is None else _period(sb, out_shape)
        if b is not None and b.device != a.device:
            raise ValueError(f"operands on {a.device} and {b.device}")
        if a.dtype != torch.int64 or (b is not None and b.dtype != torch.int64):
            raise TypeError("field operands are int64 tensors")
        if not kernels.use_kernel(a):
            if code == _POW:
                return plain(a, e)
            if D:  # align the per-coordinate shapes behind the coordinate axis
                a = a.reshape((D,) + (1,) * (len(out_shape) - len(sa)) + sa)
                if b_ext:
                    b = b.reshape((D,) + (1,) * (len(out_shape) - len(sb)) + sb)
            return plain(a) if b is None else plain(a, b)
        a = a.contiguous()
        b = None if b is None else b.contiguous()
        kernels.check_cuda(a, *(() if b is None else (b,)))
        n = int(np.prod(out_shape, dtype=np.int64))
        out = torch.empty(((D,) if D else ()) + tuple(out_shape), dtype=torch.int64, device=a.device)
        if n == 0:
            return out
        # the output as reps rows of P elements: P its last axis if an
        # operand is a column, else the smallest period above 1
        P = out_shape[-1] if a_col or b_col else min([k for k in (na, nb) if k > 1] or [n])
        if P >= 1 << 31 or n // P >= 1 << 31:
            raise ValueError(f"{self.kernel.name} takes at most 2^31 - 1 rows of at most 2^31 - 1 elements")
        n_bytes = 8 * (a.numel() + (0 if b is None else b.numel()) + out.numel())
        mul_ops = kernels.OPS_PER_MUL[self.field_id]
        if code in (_POW, _INV, _EXT_INV):  # square-and-multiply, then for an extension the norm map
            exp = (e if code == _POW else self.p - 2) % (1 << 64)
            muls = exp.bit_length() + bin(exp).count("1") + (4 * D * D if code == _EXT_INV else 0)
            ops = muls * mul_ops * n
        else:
            ops = 0
        self.kernel.launch(
            self.kernel.name, code, kernels.ptr(a), na, na, None if b is None else kernels.ptr(b), max(nb, 1),
            nb, a_col | b_col << 1, kernels.ptr(out), P, n // P, e % (1 << 64), cost=(n_bytes, ops),
        )
        return out

    def add(self, a, b):
        return self._apply(_ADD, self.add_plain, a, b)

    def sub(self, a, b):
        return self._apply(_SUB, self.sub_plain, a, b)

    def neg(self, a):
        return self._apply(_NEG, self.neg_plain, a)

    def mul(self, a, b):
        return self._apply(_MUL, self.mul_plain, a, b)

    def square(self, a):
        return self._apply(_MUL, self.mul_plain, a, a)

    def pow(self, a, e: int):  # noqa: A003 - the field op's name
        return self._apply(_POW, self.pow_plain, a, e=e)

    def inv(self, a):
        return self._apply(_INV, self.inv_plain, a)

    # -- host boundary ---------------------------------------------------------
    def from_np(self, arr, device) -> torch.Tensor:
        """uint64 numpy -> int64 tensor on `device`.  Goldilocks keeps the
        bit patterns; BabyBear reduces mod p, as the JAX package's from_np
        does (a u32 trace value ≥ p is its residue)."""
        from ..utils import to_device

        a = np.asarray(arr, np.uint64)
        if self.p < (1 << 32):
            a = a % np.uint64(self.p)
        return to_device(np.ascontiguousarray(a).view(np.int64), device)

    @staticmethod
    def to_np(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().contiguous().numpy().view(np.uint64)

    def const(self, value: int, device) -> torch.Tensor:
        """A base scalar (shape ()) on `device`, uploaded once per value and
        device and shared afterwards (callers never write to it).  Every
        caller passes a fixed value of the circuit or domain (a constraint
        constant, a generator, an inverse size), so a warm prove uploads
        none of them."""
        key = (value % self.p, str(torch.device(device)))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = self.from_np(np.uint64(key[0]), device).reshape(())
        return t

    def canonical(self, t: torch.Tensor) -> torch.Tensor:
        """A trace tensor's values as field elements (BabyBear reduces
        non-negative int64 values mod p; Goldilocks keeps bit patterns)."""
        return torch.remainder(t, self.p) if self.p < (1 << 32) else t


def _elem_shape(t: torch.Tensor, D: int) -> Tuple[int, ...]:
    if D:
        if t.dim() == 0 or t.shape[0] != D:
            raise ValueError(f"extension operand needs a leading axis of {D}, got {tuple(t.shape)}")
        return tuple(t.shape[1:])
    return tuple(t.shape)


class ExtOps:
    """The binomial extension F[X]/(X^D - W) over a FieldOps, on
    coordinate-major (D, ...) tensors.  Products are schoolbook (every
    method gives the same canonical values); the D=4 inverse goes through
    the X -> -X conjugate tower, as the JAX package's does."""

    def __init__(self, base: FieldOps, host: HostExtField):
        self.base = base
        self.host = host
        self.D = host.D
        self.w = host.w
        self.name = host.name

    # -- plain versions (any device) ---------------------------------------
    def add_plain(self, a, b):
        return self.base.add_plain(a, b)

    def sub_plain(self, a, b):
        return self.base.sub_plain(a, b)

    def mul_plain(self, a, b):
        F, D = self.base, self.D
        out = [None] * D
        for i in range(D):
            for j in range(D):
                t = F.mul_plain(a[i], b[j])
                k = i + j
                if k >= D:
                    k -= D
                    t = F.mul_plain(t, self.w)
                out[k] = t if out[k] is None else F.add_plain(out[k], t)
        return torch.stack(torch.broadcast_tensors(*out))

    def scale_plain(self, a, s):
        return torch.stack(torch.broadcast_tensors(*(self.base.mul_plain(c, s) for c in a)))

    def inv_plain(self, a):
        """Norm-map inverse; 0 maps to 0 (the base inverse is Fermat)."""
        F, w = self.base, self.w
        if self.D == 2:
            norm = F.sub_plain(F.mul_plain(a[0], a[0]), F.mul_plain(F.mul_plain(a[1], a[1]), w))
            ninv = F.inv_plain(norm)
            return torch.stack([F.mul_plain(a[0], ninv), F.neg_plain(F.mul_plain(a[1], ninv))])
        # b = a·conj(a), conj negating odd coordinates, has only even
        # coordinates: c0 + c2·u with u = X^2, u^2 = W
        conj = torch.stack([a[0], F.neg_plain(a[1]), a[2], F.neg_plain(a[3])])
        b = self.mul_plain(a, conj)
        c0, c2 = b[0], b[2]
        ninv = F.inv_plain(F.sub_plain(F.mul_plain(c0, c0), F.mul_plain(F.mul_plain(c2, c2), w)))
        zero = torch.zeros_like(c0)
        d = torch.stack([F.mul_plain(c0, ninv), zero, F.neg_plain(F.mul_plain(c2, ninv)), zero])
        return self.mul_plain(conj, d)

    # -- dispatch ------------------------------------------------------------
    def add(self, a, b):
        return self.base._apply(_EXT_ADD, self.add_plain, a, b, D=self.D, b_ext=True)

    def sub(self, a, b):
        return self.base._apply(_EXT_SUB, self.sub_plain, a, b, D=self.D, b_ext=True)

    def mul(self, a, b):
        return self.base._apply(_EXT_MUL, self.mul_plain, a, b, D=self.D, b_ext=True)

    def square(self, a):
        return self.mul(a, a)

    def scale(self, a, s):
        """Extension array times a base array."""
        return self.base._apply(_EXT_SCALE, self.scale_plain, a, s, D=self.D)

    def inv(self, a):
        return self.base._apply(_EXT_INV, self.inv_plain, a, D=self.D)

    def powers_plain(self, alpha, count: int) -> torch.Tensor:
        """The sequential product α^i = α^(i-1)·α on the host field, as a
        (D, count) tensor on α's device."""
        a = tuple(int(c) for c in FieldOps.to_np(alpha.reshape(self.D)))
        pows = [self.host.one]
        for _ in range(1, count):
            pows.append(self.host.mul(pows[-1], a))
        arr = np.asarray(pows[:count], np.uint64).reshape(count, self.D)
        return self.base.from_np(np.ascontiguousarray(arr.T), alpha.device)

    def powers(self, alpha, count: int) -> torch.Tensor:
        """[α^0, ..., α^(count-1)] of an extension scalar α ((D,) or (D, 1))
        as a (D, count) tensor.  On a CUDA tensor one launch of the field's
        kernel, α never leaving the device: each thread raises α to its own
        index, its longest chain ceil(log2 count) dependent products; on a
        CPU tensor the plain version."""
        if alpha.numel() != self.D or alpha.dtype != torch.int64:
            raise ValueError(f"powers takes an int64 extension scalar of {self.D} coordinates")
        if not kernels.use_kernel(alpha):
            return self.powers_plain(alpha, count)
        alpha = alpha.reshape(self.D).contiguous()
        kernels.check_cuda(alpha)
        out = torch.empty((self.D, count), dtype=torch.int64, device=alpha.device)
        if count == 0:
            return out
        F, bits = self.base, (count - 1).bit_length()
        products = count * (bits + 1) * (self.D * self.D + self.D)  # at most two extension products per bit
        F.kernel.launch(
            F.kernel.name.replace("arith", "powers"), kernels.ptr(alpha), kernels.ptr(out), count,
            cost=(8 * self.D * (count + 1), products * kernels.OPS_PER_MUL[F.field_id],
                  bits * kernels.EXT_MUL_LATENCY_MS[F.field_id]),
        )
        return out

    def chain(self, x, n: int) -> torch.Tensor:
        """x ((D,)) squared n times in a row in one thread on the card: n
        dependent extension products' latency (a measurement, not a launch
        of the field's kernel: not counted).  The plain version on a CPU
        tensor."""
        if x.numel() != self.D or n < 0:
            raise ValueError(f"chain takes {self.D} coordinates and n >= 0")
        x = x.reshape(self.D)
        if not kernels.use_kernel(x):
            for _ in range(n):
                x = self.mul_plain(x.reshape(self.D, 1), x.reshape(self.D, 1)).reshape(self.D)
            return x
        out = x.clone()
        kernels.check_cuda(out)
        entry = self.base.kernel.name.replace("arith", "ext_chain")
        rc = getattr(kernels.library(), entry)(kernels.ptr(out), n, kernels.current_stream())
        if rc != 0:
            raise RuntimeError(f"{entry} failed with cudaError_t {rc}")
        return out

    # -- host boundary ---------------------------------------------------------
    def const(self, coords: Sequence[int], device) -> torch.Tensor:
        """A host extension value as a (D,) tensor on `device`."""
        return self.base.from_np(np.asarray([int(c) % self.base.p for c in coords], np.uint64), device)

    def to_host(self, t: torch.Tensor) -> list:
        """(D, ...) tensor -> host ext tuples along the trailing axes."""
        arr = FieldOps.to_np(t)
        return [tuple(int(c) for c in v) for v in np.moveaxis(arr, 0, -1).reshape(-1, arr.shape[0])]


GL_OPS = FieldOps(GOLDILOCKS, 0, kernels.GL_ARITH, (_gl_add, _gl_sub, _gl_neg, _gl_mul))
BB_OPS = FieldOps(BABYBEAR, 1, kernels.BB_ARITH, (_bb_add, _bb_sub, _bb_neg, _bb_mul))
GL2_OPS = ExtOps(GL_OPS, GOLDILOCKS_EXT2)
BB4_OPS = ExtOps(BB_OPS, BABYBEAR_EXT4)


def to_np(t: torch.Tensor) -> np.ndarray:
    """Any field's tensor -> its uint64 values."""
    return FieldOps.to_np(t)


def from_u64(arr, device) -> torch.Tensor:
    """uint64 numpy -> int64 tensor with the same bit patterns (no
    reduction: the caller's values are already canonical)."""
    from ..utils import to_device

    return to_device(np.ascontiguousarray(np.asarray(arr, np.uint64)).view(np.int64), device)
