"""System setup + witness (the counterpart of multistark_tpu/system.py).

`System.new` compiles every circuit's constraint graph, derives the shared
publics/stage-2 layout from its lookups, enforces the quotient-degree-vs-
blowup guard, and commits ALL preprocessed traces in one PCS commitment that
is reused across proofs (ProverKey)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import lookup as lk
from .evaluator import sweep_lookup_prefix
from .expr import Expr, ExtExpr, Lookup, Source
from .fields.npref import NpField, np_powers
from .graph import ConstraintGraph, compile_graph
from . import program
from .profiling import span
from .program import SELECTORS, Operands, Program, Recorder, expr_sweep


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
    """Compiled circuit."""

    graph: ConstraintGraph
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


@dataclass
class ProverKey:
    """Setup-time preprocessed commitment, reused across proofs."""

    preprocessed_data: Optional[object]  # PcsProverData or None
    preprocessed_mats_device: List[torch.Tensor]  # original (w, h) mats


class System:
    def __init__(self, config, circuits, preprocessed_commit, preprocessed_index):
        self.config = config
        self.circuits: List[Circuit] = circuits
        self.preprocessed_commit = preprocessed_commit  # cap or None
        # circuit idx -> position inside the preprocessed commitment (or None)
        self.preprocessed_index: List[Optional[int]] = preprocessed_index
        # quotient-domain selectors per (log_n, q) and trace-domain ones per
        # ("trace", log_n), built once on the device
        self.selector_cache: Dict[tuple, dict] = {}
        # K11 programs per (kind, circuit, ...), recorded once
        self.program_cache: Dict[tuple, Program] = {}

    def cached_program(self, key: tuple, record) -> Program:
        """The program cached under key, recorded by record() at first use."""
        if key not in self.program_cache:
            self.program_cache[key] = record()
        return self.program_cache[key]

    def lookup_values_program(self, c_idx: int) -> Program:
        return self.cached_program(("lookup values", c_idx), lambda: _lookup_values_program(self, c_idx))

    def stage2_program(self, c_idx: int) -> Optional[Program]:
        """The stage-2 slot messages of circuit c_idx (None without lookups)."""
        arities = tuple(len(args) for _, args in self.circuits[c_idx].graph.lookups)
        if not arities:
            return None
        return self.cached_program(
            ("stage-2 messages", c_idx),
            lambda: lk.stage2_program(self.config.host_field.p, self.config.extension_params, arities,
                                      f"stage-2 messages of circuit {c_idx}"),
        )

    def quotient_program(self, c_idx: int, log_n: int) -> Program:
        from .prover import _quotient_program

        return self.cached_program(("quotient", c_idx, log_n), lambda: _quotient_program(self, c_idx, log_n))

    def programs(self, heights: Sequence[int]) -> List[Program]:
        """Every K11 program a prove of a witness with these trace heights
        runs: per active circuit its lookup values and stage-2 messages (if
        it has lookups) and its quotient."""
        out = []
        for c_idx, h in enumerate(heights):
            if h:
                if self.circuits[c_idx].graph.lookups:
                    out += [self.lookup_values_program(c_idx), self.stage2_program(c_idx)]
                out.append(self.quotient_program(c_idx, h.bit_length() - 1))
        return out

    @staticmethod
    def new(config, inputs: Sequence[CircuitInputs]) -> Tuple["System", ProverKey]:
        hf = config.host_field
        ep = config.extension_params
        circuits = []
        for ci in inputs:
            g = compile_graph(hf.p, ci.constraints, ci.ext_constraints, ci.lookups, ep)
            L = len(ci.lookups)
            max_deg = max(g.max_constraint_degree, lk.logup_max_degree(g))
            circuit = Circuit(
                graph=g,
                main_width=ci.main_width,
                stage2_width=lk.stage2_width(L, ep.degree),
                num_lookups=L,
                preprocessed_dims=(
                    tuple(ci.preprocessed.shape) if ci.preprocessed is not None else None
                ),
                constraint_count=len(g.zeros) + lk.logup_constraint_count(L, ep.degree),
                max_constraint_degree=max_deg,
            )
            # quotient degree must not exceed the PCS blowup
            if circuit.quotient_degree > config.max_quotient_degree():
                raise ValueError(
                    f"constraint degree {max_deg} needs quotient degree "
                    f"{circuit.quotient_degree} > max {config.max_quotient_degree()}; "
                    f"raise log_blowup"
                )
            circuits.append(circuit)

        # one commitment over all preprocessed traces
        pre_pairs = []
        pre_mats = []
        pre_index: List[Optional[int]] = []
        for ci in inputs:
            if ci.preprocessed is None:
                pre_index.append(None)
                continue
            h, _ = ci.preprocessed.shape
            if h & (h - 1) or h == 0:
                raise ValueError("preprocessed height must be a power of two")
            mat = config.field.from_np(np.asarray(ci.preprocessed, np.uint64).T, config.device)  # (w, h)
            pre_index.append(len(pre_pairs))
            pre_pairs.append((config.pcs.natural_domain_for_degree(h), mat))
            pre_mats.append(mat)
        cap, data = config.pcs.commit(pre_pairs) if pre_pairs else (None, None)
        system = System(config, circuits, cap, pre_index)
        return system, ProverKey(preprocessed_data=data, preprocessed_mats_device=pre_mats)

    # -- prove and verify --------------------------------------------------
    def prove(self, key: ProverKey, witness: "SystemWitness", claims=None):
        from .prover import prove_multiple_claims

        return prove_multiple_claims(self, key, witness, [] if claims is None else [claims])

    def prove_multiple_claims(self, key: ProverKey, witness: "SystemWitness", claims):
        """prover.prove_multiple_claims: the device transcript where the
        config allows it, else the host transcript."""
        from .prover import prove_multiple_claims

        return prove_multiple_claims(self, key, witness, claims)

    def verify(self, proof, claims=None) -> None:
        from .verifier import verify_multiple_claims

        verify_multiple_claims(self, [] if claims is None else [claims], proof)

    def verify_multiple_claims(self, claims, proof) -> None:
        """verifier.verify_multiple_claims: returns, or raises
        VerificationError."""
        from .verifier import verify_multiple_claims

        verify_multiple_claims(self, claims, proof)

    # -- transcript shape binding ----------------------------------------
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


def domain_selector_arrays(hf, log_n: int) -> dict:
    """Unnormalized selector VALUES on the trace domain itself (for witness
    generation): is_first = [n, 0...], is_last = [0..., n·g],
    is_transition = g^r - g^{-1}."""
    n = 1 << log_n
    g = hf.two_adic_generator(log_n)
    first = np.zeros(n, np.uint64)
    first[0] = n % hf.p
    last = np.zeros(n, np.uint64)
    last[-1] = hf.mul(n % hf.p, g)
    trans = NpField(hf).sub(np_powers(hf, g, n), np.uint64(hf.inv(g)))
    return {"first": first, "last": last, "transition": trans}


@dataclass
class SystemWitness:
    """Stage-1 traces + per-circuit lookup witness."""

    traces: List[Optional[torch.Tensor]]  # (w, h) int64 tensors, None if inactive
    heights: List[int]
    lookup_values: List[Optional[lk.LookupValues]]

    @staticmethod
    def from_stage_1(traces: Sequence, system: System, key: ProverKey) -> "SystemWitness":
        """traces: per circuit a (h, w) uint64 numpy array or int64 tensor
        (as `witness_from_numpy` returns them); values become field elements
        as the config's `from_np` makes them (BabyBear reduces mod p)."""
        with span("stark/witness"):
            F, device = system.config.field, system.config.device
            if torch.device(device).type == "cuda":  # the compiled K11 programs of this prove, built together
                program.build(F, system.programs([t.shape[0] for t in traces]))
            dev_traces: List[Optional[torch.Tensor]] = []
            heights: List[int] = []
            lvs: List[Optional[lk.LookupValues]] = []
            for c_idx, (circuit, trace) in enumerate(zip(system.circuits, traces)):
                if isinstance(trace, torch.Tensor):
                    trace = F.canonical(trace)
                else:
                    trace = F.from_np(np.asarray(trace, np.uint64), device)
                h = trace.shape[0]
                heights.append(h)
                if h == 0:
                    dev_traces.append(None)
                    lvs.append(None)
                    continue
                if h & (h - 1):
                    raise ValueError(f"trace height {h} not a power of two")
                if trace.shape[1] != circuit.main_width:
                    raise ValueError(f"trace width {trace.shape[1]} != {circuit.main_width}")
                if circuit.preprocessed_dims is not None and circuit.preprocessed_dims[0] != h:
                    raise ValueError(f"preprocessed height {circuit.preprocessed_dims[0]} != main height {h}")
                mat = trace.to(device).T.contiguous()  # (w, h)
                dev_traces.append(mat)
                lvs.append(_compute_lookup_values(system, key, c_idx, mat, h))
            return SystemWitness(traces=dev_traces, heights=heights, lookup_values=lvs)


def _compute_lookup_values(system: System, key: ProverKey, c_idx: int, main_mat, height: int) -> lk.LookupValues:
    """Run the circuit's lookup-values program (K11) over the whole trace:
    one row of the output per multiplicity and argument, next row = the
    following one (cyclic)."""
    circuit = system.circuits[c_idx]
    config = system.config
    pre_idx = system.preprocessed_index[c_idx]
    pre_mat = key.preprocessed_mats_device[pre_idx] if pre_idx is not None else None
    log_n = height.bit_length() - 1
    sel_key = ("trace", log_n)
    if sel_key not in system.selector_cache:
        system.selector_cache[sel_key] = {
            k: config.field.from_np(v, config.device)
            for k, v in domain_selector_arrays(config.host_field, log_n).items()
        }
    sels = system.selector_cache[sel_key]
    arities = tuple(len(args) for _, args in circuit.graph.lookups)
    prog = system.lookup_values_program(c_idx)
    sources = [None, None, None]
    sources[Source.MAIN.value] = main_mat
    sources[Source.PREPROCESSED.value] = pre_mat
    if Source.PREPROCESSED.value in prog.sources and pre_mat is None:
        raise ValueError("circuit has no preprocessed trace")
    n_out = sum(1 + a for a in arities)
    ops = Operands(sources=sources, rows=height, selectors=[sels.get(name) for name in SELECTORS[:3]])
    matrix = expr_sweep(config.field, prog, ops, (n_out, height), height, 1) if n_out else None
    return lk.LookupValues(height=height, matrix=matrix, arities=arities, stage2_program=system.stage2_program(c_idx))


def _lookup_values_program(system: System, c_idx: int) -> Program:
    """Record the lookup prefix of circuit c_idx's graph as a K11 program
    over the main and preprocessed traces; out plane = multiplicity of slot
    0, its arguments, multiplicity of slot 1, ..."""
    graph = system.circuits[c_idx].graph
    rec = Recorder(system.config.host_field.p, sources=(Source.MAIN.value, Source.PREPROCESSED.value),
                   publics=False)
    buf = sweep_lookup_prefix(graph, rec)
    plane = 0
    for mult, args in graph.lookups:
        for node in (mult, *args):
            rec.out(buf[node], plane)
            plane += 1
    return rec.compile(f"lookup values of circuit {c_idx}")
