"""The prover (the counterpart of multistark_tpu/prover.py).

`prove_multiple_claims` takes the whole-prove device transcript
(dt_prover.py) whenever `dt_prover.eligible(config)` holds (the
GoldilocksBlake3 config, on any device, with no active mesh) and the host
transcript otherwise (the BabyBearPoseidon2 config, or a sharded prove under
parallel.use_mesh), or when the device transcript's host replay cannot
adopt its result.  Under a mesh the quotient of a circuit with m = n·q >= D²
quotient rows and q <= m/D runs `_quotient_chunk_sharded`.  `prove_host_transcript` is the host-transcript
prove: device work happens in the big stages (stage-1 commit, stage-2 lookup
traces + commit, quotient evaluation + commit, FRI open) and the Fiat-Shamir
challenger runs on the host between them.  Both give the JAX package's proof
bytes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import lookup as lk
from . import parallel
from .challenger import observe_claims as _observe_claims
from .domains import TwoAdicCoset
from .evaluator import constraint_values, lookup_values as graph_lookup_values, sweep
from .expr import Source
from .pcs import FriProof
from .profiling import span
from .program import SELECTORS, Operands, Program, Recorder, expr_sweep
from .system import ProverKey, System, SystemWitness
from .utils import ext_pack_device, ext_powers_device, fetch

ExtVal = Tuple[int, ...]


@dataclass
class Commitments:
    stage_1_trace: np.ndarray
    stage_2_trace: np.ndarray
    quotient_chunks: np.ndarray


@dataclass
class Proof:
    active: List[bool]
    commitments: Commitments
    intermediate_accumulators: List[ExtVal]
    log_degrees: List[int]  # per ACTIVE circuit
    # opened values: per matrix, per point, per column (ext coords)
    preprocessed_opened: List[List[List[ExtVal]]]
    stage1_opened: List[List[List[ExtVal]]]
    stage2_opened: List[List[List[ExtVal]]]
    quotient_opened: List[List[List[ExtVal]]]
    fri_proof: FriProof
    field_bytes: int = 8  # serialized width of a base element: 8 Goldilocks, 4 BabyBear

    def to_bytes(self) -> bytes:
        from .serialization import proof_to_bytes

        with span("stark/to_bytes"):
            return proof_to_bytes(self)

    @staticmethod
    def from_bytes(data: bytes, system: System) -> "Proof":
        """Read a proof `to_bytes` wrote (this port's or the JAX package's:
        the bytes are the same) for `system`; malformed bytes raise
        VerificationError("InvalidProofShape")."""
        from .serialization import proof_from_bytes

        return proof_from_bytes(data, system)


def prove(system: System, key: ProverKey, witness: SystemWitness, claims=None) -> Proof:
    return prove_multiple_claims(system, key, witness, [] if claims is None else [claims])


def prove_multiple_claims(
    system: System, key: ProverKey, witness: SystemWitness, claims: Sequence[Sequence[int]]
) -> Proof:
    """The device transcript where the config allows it, else (or when its
    replay falls back, counted in device_transcript.FALLBACKS) the host
    transcript; the same proof bytes either way."""
    from . import dt_prover

    if dt_prover.eligible(system.config):
        proof = dt_prover.prove_device_transcript(system, key, witness, claims)
        if proof is not None:
            return proof
    return prove_host_transcript(system, key, witness, claims)


def prove_host_transcript(
    system: System, key: ProverKey, witness: SystemWitness, claims: Sequence[Sequence[int]]
) -> Proof:
    """The prove with its Fiat-Shamir challenger on the host: every cap,
    accumulator and claimed value is fetched before the next challenge (the
    FRI commit phase still runs its rounds on the device where the
    challenger allows, pcs.py)."""
    config = system.config
    hf, he = config.host_field, config.host_ext
    pcs = config.pcs

    with span("stark/prove"):
        ch = config.initialise_challenger()
        system.observe_shape(ch)

        # activation bitmap, observed before any commitment
        active = [h > 0 for h in witness.heights]
        if not any(active):
            raise ValueError("at least one circuit must be active")
        for b in active:
            ch.observe_bytes(bytes([1 if b else 0]))
        active_idx = [i for i, b in enumerate(active) if b]
        log_degrees = [witness.heights[i].bit_length() - 1 for i in active_idx]

        # STAGE-1 COMMIT
        with span("stark/stage1_commit"):
            s1_cap, s1_data = pcs.commit(
                [(pcs.natural_domain_for_degree(witness.heights[i]), witness.traces[i]) for i in active_idx]
            )
        if system.preprocessed_commit is not None:
            ch.observe_commitment(system.preprocessed_commit)
        ch.observe_commitment(s1_cap)
        for ld in log_degrees:
            ch.observe_bytes(bytes([ld]))
        with span("stark/claims"):
            _observe_claims(ch, claims)  # length-prefixed claims
            beta = ch.sample_ext()
            gamma = ch.sample_ext()
            E, dev = config.ext, config.device
            beta_d, gamma_d = E.const(beta, dev), E.const(gamma, dev)
            claims_arr = lk.claims_matrix(claims, hf.p)
            if claims_arr is not None:
                acc0_d = lk.claims_accumulator_device(config.field, E, claims_arr, beta_d, gamma_d)
            else:  # no claims, or ragged ones
                acc0_d = E.const(lk.claims_accumulator(he, beta, gamma, claims), dev)

        # STAGE-2: lookup traces (the cap and the accumulators fetched together)
        with span("stark/lookup_construction"):
            s2_mats, accs_dev = lk.stage_2_traces_device(
                E, [witness.lookup_values[i] for i in active_idx], beta_d, gamma_d, acc0_d
            )
        with span("stark/stage2_commit"):
            s2_cap_dev, s2_data = pcs.commit_device(
                [(pcs.natural_domain_for_degree(witness.heights[i]), m) for i, m in zip(active_idx, s2_mats)]
            )
            s2_cap, *accs_np = fetch([s2_cap_dev] + accs_dev)
        accs = [tuple(int(c) for c in a) for a in accs_np]
        ch.observe_commitment(s2_cap)
        for a in accs:
            ch.observe_ext(a)

        alpha = ch.sample_ext()

        # QUOTIENT per active circuit
        alpha_d = E.const(alpha, dev)
        accs_d = [acc0_d] + accs_dev
        with span("stark/quotient"):
            chunk_mats = [
                _quotient_chunk_coeffs(
                    system, key, witness, s1_data, s2_data, i, k, beta_d, gamma_d, alpha_d, accs_d[k], accs_d[k + 1],
                )
                for k, i in enumerate(active_idx)
            ]
            q_cap, q_data = pcs.commit_from_coeffs(chunk_mats)
        ch.observe_commitment(q_cap)

        zeta = ch.sample_ext()

        # opening rounds: preprocessed?, stage1, stage2, quotient
        rounds = []
        if key.preprocessed_data is not None:
            pre_points = []
            for c_idx, p_idx in enumerate(system.preprocessed_index):
                if p_idx is None:
                    continue
                if active[c_idx]:
                    g = hf.two_adic_generator(witness.heights[c_idx].bit_length() - 1)
                    pre_points.append([zeta, he.scale(zeta, g)])
                else:
                    pre_points.append([])
            rounds.append((key.preprocessed_data, pre_points))
        two_pt = []
        for i in active_idx:
            g = hf.two_adic_generator(witness.heights[i].bit_length() - 1)
            two_pt.append([zeta, he.scale(zeta, g)])
        rounds.append((s1_data, two_pt))
        rounds.append((s2_data, [list(p) for p in two_pt]))
        rounds.append((q_data, [[zeta] for _ in active_idx]))

        with span("stark/fri_open"):
            opened, fri_proof = pcs.open(rounds, ch)

        r = 0
        pre_opened = []
        if key.preprocessed_data is not None:
            pre_opened = opened[0]
            r = 1
        return Proof(
            active=active,
            commitments=Commitments(s1_cap, s2_cap, q_cap),
            intermediate_accumulators=list(accs),
            log_degrees=log_degrees,
            preprocessed_opened=pre_opened,
            stage1_opened=opened[r],
            stage2_opened=opened[r + 1],
            quotient_opened=opened[r + 2],
            fri_proof=fri_proof,
            field_bytes=8 if hf.p.bit_length() > 32 else 4,
        )


def _quotient_chunk_coeffs(
    system, key, witness, s1_data, s2_data, c_idx, active_ord, beta, gamma, alpha, acc_prev, acc_final,
) -> torch.Tensor:
    """Evaluate the α-folded constraint composition on the disjoint quotient
    domain, divide by Z_H, and return the chunked coefficient matrix
    (q·D, n) for the quotient commit.  β, γ, α and the accumulators are (D,)
    device scalars."""
    config = system.config
    hf = config.host_field
    pcs = config.pcs
    circuit = system.circuits[c_idx]
    n = witness.heights[c_idx]
    log_n = n.bit_length() - 1
    q = circuit.quotient_degree
    log_m = log_n + (q.bit_length() - 1)
    D = config.extension_params.degree

    mats = {
        Source.MAIN.value: s1_data.mmcs_data.mats[active_ord],
        Source.STAGE2.value: s2_data.mmcs_data.mats[active_ord],
    }
    p_idx = system.preprocessed_index[c_idx]
    if p_idx is not None:
        mats[Source.PREPROCESSED.value] = key.preprocessed_data.mmcs_data.mats[p_idx]
    selectors = _selectors_device(system, log_n, q)
    pubs = ext_pack_device((beta, gamma, acc_prev, acc_final))  # (4, D): the publics' layout
    pm = parallel.current_mesh()
    if pm is not None:
        m = n * q
        datas = {Source.MAIN.value: (s1_data, active_ord), Source.STAGE2.value: (s2_data, active_ord)}
        if p_idx is not None:
            datas[Source.PREPROCESSED.value] = (key.preprocessed_data, p_idx)
        # the stored quotient-domain prefixes (m rows), whole on every rank (JAX prover.py:267)
        mats = {src: parallel.whole_prefix(d.mmcs_data, i, m, "quotient") for src, (d, i) in datas.items()}
        if m >= pm.n * pm.n and q <= m // pm.n:
            return _quotient_chunk_sharded(system, c_idx, log_n, q, mats, selectors, pubs, alpha, pm)
    qmat = _quotient_sweep_only(system, c_idx, log_n, q, mats, selectors, pubs, alpha)
    coeffs = pcs.engine.icoset_from_bitrev(qmat, log_m, hf.generator)  # (D, m)
    # chunk i·D + d = coordinate d of coefficients [i·n, (i+1)·n)
    return coeffs.reshape(D, q, n).permute(1, 0, 2).reshape(q * D, n).contiguous()


def _quotient_chunk_sharded(system, c_idx, log_n, q, prefixes, selectors, pubs, alpha, pm) -> torch.Tensor:
    """The quotient under a mesh (JAX prover.py:394-545): K11 in its natural
    mode on this rank's block of m/D quotient rows plus the q rows after it
    (the next-row window's halo, read from the gathered prefixes; the last
    q outputs, which would wrap, are dropped), the block-to-cyclic
    all_to_all, the inverse sharded DIF, one all_gather of the (D, m)
    bit-reversed result, then un-reversal, 1/m, the shift and the chunking
    replicated.  prefixes: source id -> the stored quotient-domain prefix
    (w, m), whole."""
    parallel.SHARDED_CALLS["quotient_chunk_sharded"] += 1
    config = system.config
    hf, F, eng = config.host_field, config.field, config.pcs.engine
    D = config.extension_params.degree
    n = 1 << log_n
    log_m = log_n + (q.bit_length() - 1)
    m, b = n * q, (n * q) // pm.n
    # natural quotient row j sits at storage position bitrev(j) of the prefix
    natural = (pm.rank * b + torch.arange(b + q, device=eng.device)) % m
    take = eng.brev(log_m).index_select(0, natural)
    prog = system.quotient_program(c_idx, log_n)
    ops = Operands(
        sources=[None if prefixes.get(s) is None else prefixes[s].index_select(1, take) for s in range(3)],
        rows=b + q, step=q, selectors=[selectors[name].index_select(0, take) for name in SELECTORS],
        pubs=pubs.reshape(-1),
        apows=ext_powers_device(config.ext, alpha, system.circuits[c_idx].constraint_count).contiguous(),
    )
    qblk = expr_sweep(F, prog, ops, (D, b + q), b + q, 1)[:, :b]
    cb = parallel.sharded_dif(eng, pm, parallel.cyclic_from_blocks(pm, qblk, "quotient"), log_m, inverse=True)
    full = parallel.gather_blocks(pm, cb, "quotient")  # (D, m) bit-reversed
    tab = eng.scale_table(log_m, hf.inv(hf.generator), hf.inv(m % hf.p))
    coeffs = F.mul(eng._unbrev(full, log_m), tab)
    return coeffs.reshape(D, q, n).permute(1, 0, 2).reshape(q * D, n).contiguous()


def _selectors_device(system, log_n: int, q: int) -> dict:
    """The trace domain's unnormalized selectors on the quotient coset in
    storage (bit-reversed) order, the order of a stored LDE prefix, built on
    the device through the field's elementwise kernel and cached on the
    system: with v = x/shift,  first = Z_H/(v-1), last = Z_H/(v-g^-1),
    transition = v - g^-1, inv_vanishing = 1/Z_H, where Z_H = v^n - 1 has
    period q over the coset (natural order)."""
    key = (log_n, q)
    if key not in system.selector_cache:
        config = system.config
        F, hf, dev = config.field, config.host_field, config.device
        trace_dom = TwoAdicCoset(hf, log_n, 1)
        qdom = trace_dom.create_disjoint_domain((1 << log_n) * q)
        v = config.pcs.x_table_natural(qdom.log_n, hf.mul(qdom.shift, hf.inv(trace_dom.shift)))
        n = 1 << log_n
        head = [hf.sub(hf.pow(int(x), n), 1) for x in F.to_np(v[:q])]
        z_h = F.from_np(np.tile(np.asarray(head, np.uint64), n), dev)
        inv_z_h = F.from_np(np.tile(np.asarray([hf.inv(h) for h in head], np.uint64), n), dev)
        g_inv = F.const(hf.inv(trace_dom.gen), dev)
        trans = F.sub(v, g_inv)
        natural = {
            "first": F.mul(z_h, F.inv(F.sub(v, F.const(1, dev)))),
            "last": F.mul(z_h, F.inv(trans)),
            "transition": trans,
            "inv_vanishing": inv_z_h,
        }
        brev = config.pcs.engine.brev(qdom.log_n)
        system.selector_cache[key] = {name: col.index_select(0, brev) for name, col in natural.items()}
    return system.selector_cache[key]


def _quotient_program(system, c_idx: int, log_n: int) -> Program:
    """Record the quotient composition of circuit c_idx at 2^log_n rows as a
    K11 program: the constraint sweep, the logUp constraints over the stage-2
    columns (publics β, γ, acc_initial, acc_final at 0, D, 2D, 3D), the
    α-fold (value i times α^(K-1-i), read from the (D, K) α-power table) and
    the division by Z_H; out plane d = coordinate d."""
    config = system.config
    hf, ep = config.host_field, config.extension_params
    D = ep.degree
    circuit = system.circuits[c_idx]
    rec = Recorder(hf.p)
    buf = sweep(circuit.graph, rec)
    values = list(constraint_values(circuit.graph, buf))
    pubs = tuple(tuple(rec.public(i * D + d) for d in range(D)) for i in range(4))
    logup_vals = lk.logup_constraint_values(
        rec, ep, hf, circuit.num_lookups, lambda col, off: rec.var(Source.STAGE2.value, col, off),
        graph_lookup_values(circuit.graph, buf), rec.last(), pubs, log_n,
    )
    for lv in logup_vals:
        values.extend(lv)
    if len(values) != circuit.constraint_count:
        raise AssertionError("constraint count mismatch")
    K = len(values)
    coords = [None] * D
    for i, v in enumerate(values):
        for d in range(D):
            term = rec.mul(v, rec.apow(d * K + K - 1 - i))
            coords[d] = term if coords[d] is None else rec.add(coords[d], term)
            rec.anchor(coords[d])  # fold each value as soon as it is computed
    inv_van = rec.selector("inv_vanishing")
    for d in range(D):
        rec.out(rec.mul(coords[d], inv_van), d)
    return rec.compile(f"quotient of circuit {c_idx} at 2^{log_n} rows")


def _quotient_sweep_only(system, c_idx, log_n, q, mats, selectors, pubs, alpha) -> torch.Tensor:
    """The constraint sweep + α-fold + Z_H division on the quotient domain
    (K11 running the circuit's quotient program), returning the (D, m)
    composition in storage (bit-reversed) order.  mats: source id -> the
    stored bit-reversed LDE (w, N >= m); selectors: `_selectors_device`'s;
    pubs: the (4, D) device publics (β, γ, acc_initial, acc_final); alpha: a
    (D,) device scalar (its powers come by doubling)."""
    config = system.config
    D = config.extension_params.degree
    log_m = log_n + (q.bit_length() - 1)
    m = 1 << log_m
    prog = system.quotient_program(c_idx, log_n)
    K = system.circuits[c_idx].constraint_count
    ops = Operands(
        sources=[mats.get(s) for s in range(3)], rows=m, step=q, brev_log=log_m,
        selectors=[selectors[name] for name in SELECTORS], pubs=pubs.reshape(-1),
        apows=ext_powers_device(config.ext, alpha, K).contiguous(),
    )
    return expr_sweep(config.field, prog, ops, (D, m), m, 1)
