"""Distributed four-step DFT over the ranks of a mesh (the counterpart of
multistark_tpu/ntt/distributed.py).

A length-n DFT as an (n1, n2) matrix transform with the row-block axis
sharded across the D ranks of a parallel.ProverMesh:

    x[a + n1·b]  (a < n1, b < n2), stored as the (n1, n2) matrix; rank r
                 owns the rows a of its block
    1. local DFT_n2 along b (K2: bit reversal, then the DIT stages)
    2. multiply by the twiddles w_n^{a·k2} (K1/K5)
    3. all_to_all: the shard axis moves from a to k2
    4. local DFT_n1 along a (K2)

    output: X[k2 + n2·k1] = out[k1, k2], sharded along k2.

Only its tests and chip_smoke.py call it; the prover's LDEs run the
sharded DIF of parallel.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.host import HostField
from ..fields.npref import np_mul, np_powers


def four_step_twiddles(host: HostField, log_n1: int, log_n2: int) -> np.ndarray:
    """(n1, n2) table of w_n^{a·k2} (uint64)."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    row = np_powers(host, host.two_adic_generator(log_n1 + log_n2), n2)  # w^k2
    out = np.ones((n1, n2), np.uint64)
    cur = row
    for a in range(1, n1):
        out[a] = cur
        cur = np_mul(host, cur, row)
    return out


def distributed_dft(engine, pm, x: torch.Tensor, log_n1: int, log_n2: int) -> torch.Tensor:
    """DFT of each row polynomial of x ((w, n) natural coefficients, whole
    on every rank), the n1 axis sharded over the mesh.  Returns this rank's
    (w, n1, n2/D) block of out[:, k1, k2] = X[k2 + n2·k1]."""
    from ..parallel import SHARDED_CALLS, all_to_all

    SHARDED_CALLS["distributed_dft"] += 1
    F = engine.F
    n1, n2, D = 1 << log_n1, 1 << log_n2, pm.n
    assert n1 % D == 0 and n2 % D == 0
    a = n1 // D
    w = x.shape[0]
    rows = slice(pm.rank * a, (pm.rank + 1) * a)
    x3 = x.reshape(w, n2, n1).transpose(1, 2)[:, rows, :]  # (w, n1/D, n2): x3[., a, b] = x[a + n1·b]
    y = engine._dit(engine._unbrev(x3.contiguous(), log_n2), log_n2, inverse=False).reshape(w, a, n2)
    tw = F.from_np(np.ascontiguousarray(four_step_twiddles(engine.host, log_n1, log_n2)[rows]), y.device)
    y = F.mul(y, tw)
    # the shard axis moves from a to k2: chunk s = the k2 of rank s's block
    recv = all_to_all(pm, y.reshape(w, a, D, n2 // D).permute(2, 0, 1, 3), "dft")  # (D, w, a, n2/D), from rank s
    y = recv.permute(1, 0, 2, 3).reshape(w, n1, n2 // D).transpose(1, 2)  # (w, n2/D, n1)
    y = engine._dit(engine._unbrev(y.contiguous(), log_n1), log_n1, inverse=False).reshape(w, n2 // D, n1)
    return y.transpose(1, 2).contiguous()


def reference_dft_natural(engine, x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Single-device natural-order DFT for cross-checking: the DIF, then the
    un-reversal."""
    return engine._unbrev(engine._dif(x, log_n, inverse=False), log_n)
