"""The verifier's view of a system: the circuits (their constraints in fold
order, lookups, widths, degrees), the shape the transcript observes, and the
verifying key, the commitment to the preprocessed traces, which the
verifier makes itself from the circuits' tables."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import lookup as lk
from .challenger import SerializingChallenger64
from .constraints import ConstraintOrder, order
from .expr import Expr, ExtExpr, Lookup
from .field_host import GOLDILOCKS, GOLDILOCKS_EXT2, ExtensionParams
from .pcs import FriParameters, TwoAdicFriPcs

DOMAIN_TAG = b"multi-stark/v0"


@dataclass
class CircuitInputs:
    """What a circuit author provides."""

    main_width: int
    constraints: List[Expr]
    ext_constraints: List[ExtExpr]
    lookups: List[Lookup]
    preprocessed: Optional[np.ndarray] = None  # (height, width) u64 row-major


@dataclass
class Circuit:
    constraints: ConstraintOrder
    lookups: List[Lookup]
    main_width: int
    stage2_width: int
    num_lookups: int
    preprocessed_dims: Optional[Tuple[int, int]]  # (height, width)
    constraint_count: int
    max_constraint_degree: int

    @property
    def quotient_degree(self) -> int:
        """next power of two of max(degree, 2) - 1."""
        d = max(self.max_constraint_degree, 2) - 1
        return 1 << (d - 1).bit_length() if d > 1 else 1


class GoldilocksBlake3:
    """Goldilocks, its degree-2 extension (X^2 = 7, Karatsuba products),
    BLAKE3 trees and the BLAKE3 byte transcript."""

    def __init__(self, fri: FriParameters):
        self.host_field = GOLDILOCKS
        self.host_ext = GOLDILOCKS_EXT2
        self.extension_params = ExtensionParams(degree=2, w=7, karatsuba=True)
        self.fri = fri
        self.pcs = TwoAdicFriPcs(GOLDILOCKS, GOLDILOCKS_EXT2, fri)

    def max_log_degree(self) -> int:
        return self.host_field.two_adicity - self.fri.log_blowup

    def initialise_challenger(self) -> SerializingChallenger64:
        """Seed: the domain tag, then the seven parameters as u64 LE."""
        ch = SerializingChallenger64(self.host_field, self.host_ext)
        ch.observe_bytes(DOMAIN_TAG)
        f = self.fri
        for v in (f.log_blowup, f.cap_height, f.log_final_poly_len, f.max_log_arity, f.num_queries,
                  f.commit_proof_of_work_bits, f.query_proof_of_work_bits):
            ch.observe_u64(v)
        return ch


class System:
    def __init__(self, config: GoldilocksBlake3, inputs: Sequence[CircuitInputs]):
        hf, ep = config.host_field, config.extension_params
        self.config = config
        self.circuits: List[Circuit] = []
        for ci in inputs:
            if ci.ext_constraints:
                raise ValueError("extension constraints: no circuit of the benchmark has one")
            g = order(hf.p, ci.constraints, ci.lookups)
            L = len(ci.lookups)
            self.circuits.append(Circuit(
                constraints=g,
                lookups=list(ci.lookups),
                main_width=ci.main_width,
                stage2_width=lk.stage2_width(L, ep.degree),
                num_lookups=L,
                preprocessed_dims=tuple(ci.preprocessed.shape) if ci.preprocessed is not None else None,
                constraint_count=len(g.roots) + lk.logup_constraint_count(L, ep.degree),
                max_constraint_degree=max(g.max_constraint_degree, lk.logup_max_degree(g.lookup_degrees)),
            ))
        tables = [ci.preprocessed for ci in inputs if ci.preprocessed is not None]
        self.preprocessed_index: List[Optional[int]] = []
        for ci in inputs:
            self.preprocessed_index.append(None if ci.preprocessed is None else
                                           sum(x is not None for x in self.preprocessed_index))
        self.preprocessed_commit = config.pcs.commit(tables) if tables else None

    def observe_shape(self, challenger) -> None:
        challenger.observe_u64(len(self.circuits))
        for c in self.circuits:
            challenger.observe_u64(c.constraint_count)
            challenger.observe_u64(c.max_constraint_degree)
            ph, pw = c.preprocessed_dims if c.preprocessed_dims else (0, 0)
            challenger.observe_u64(ph)
            challenger.observe_u64(pw)
            challenger.observe_u64(c.main_width)
            challenger.observe_u64(c.stage2_width)
