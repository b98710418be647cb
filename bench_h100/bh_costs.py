"""The yardstick: one H100's published peaks, and the least bytes a
prove's stages must move, reckoned from the cell's shapes alone (each input
byte read once, each output byte written once; field elements are 8 bytes,
digests 32).

The shapes come from the plain reference's system (widths, lookups,
quotient degrees, preprocessed tables, the FRI arity schedule) and from the
heights of the benchmark's own traces, never from the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# NVIDIA H100 SXM5 80GB, NVIDIA's data sheet: HBM3 bandwidth at the card's
# full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12

ELEM = 8  # a Goldilocks element, u64
DIGEST = 32  # a BLAKE3 digest


def _tree_bytes(lde_heights: Sequence[int], cap_height: int) -> int:
    """A mixed-height Merkle tree's stored layers, each digest written once:
    the tallest matrices' leaf digests and every layer above them up to the
    cap (a shorter matrix's row digests fold into the layer of its height
    and need not be stored)."""
    return DIGEST * (2 * max(lde_heights) - (1 << cap_height))


def stage_bytes(system, heights: List[int]) -> Dict[str, float]:
    """Least bytes per prove of the stages a roofline reads, for the
    reference `system` and its circuits' trace heights:

    commit: the stage-1 and stage-2 commits.  Reads each main trace and
        each stage-2 trace once, writes each one's LDE (blowup B) and the
        two trees.
    open:   the opening.  Reads every committed LDE once (preprocessed,
        stage 1, stage 2, quotient chunks: the claimed evaluations and the
        reduced openings together), writes every FRI level's committed
        vector and its tree.
    """
    pcs = system.config.pcs
    B = 1 << pcs.log_blowup
    D = system.config.extension_params.degree
    cap = pcs.fri.cap_height
    active = [(c, h) for c, h in zip(system.circuits, heights) if h]
    s1 = sum(h * c.main_width for c, h in active) * ELEM
    s2 = sum(h * c.stage2_width for c, h in active) * ELEM
    q = sum(h * c.quotient_degree * D for c, h in active) * ELEM
    pre = sum(c.preprocessed_dims[0] * c.preprocessed_dims[1] for c in system.circuits
              if c.preprocessed_dims is not None) * ELEM
    ldes = [B * h for _, h in active]
    commit = (s1 + s2) * (1 + B) + 2 * _tree_bytes(ldes, cap)

    log_max_ro = max(ldes).bit_length() - 1
    pre_ldes = {B * c.preprocessed_dims[0] for c in system.circuits if c.preprocessed_dims is not None}
    schedule = pcs.fri_schedule({h.bit_length() - 1 for h in set(ldes) | pre_ldes}, log_max_ro)
    fri = 0
    ls = log_max_ro
    for a_bits in schedule:
        leaves = 1 << (ls - a_bits)
        fri += (1 << ls) * D * ELEM + DIGEST * (2 * leaves - (1 << cap))
        ls -= a_bits
    opening = B * (s1 + s2 + q + pre) + fri
    return {"commit": float(commit), "open": float(opening)}


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S
