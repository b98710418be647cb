"""The whole-prove device transcript (the counterpart of
multistark_tpu/dt_prover.py).

The host-transcript prove (prover.prove_host_transcript) fetches at every
commit and sample boundary: each cap, the stage-2 accumulators and the
claimed evaluations go to the host challenger before β γ, α, ζ and the FRI
batching α can be sampled.  Here the transcript runs on the device through
device_transcript.DeviceDuplex: caps, accumulators and claimed values are
observed as device words, every challenge is a device scalar that flows
straight into the next stage (the claims accumulator, stage 2, the quotient,
the openings), and the FRI commit phase grinds and folds on the device too.
The prove fetches ONCE before the query phase (every cap, accumulator,
claimed value, challenge, draw flag and FRI artifact together), and once
more for the query openings.

The host challenger then replays the whole byte transcript from the fetched
values and compares every device draw with its own: it is the authority.  A
draw >= p (about 2^-32 per draw, not modelled on the device), a grind miss,
ragged claims, an unaligned FRI entry buffer or a degenerate FRI raises
device_transcript.Fallback; `prove_device_transcript` counts the reason in
device_transcript.FALLBACKS and returns None, and the caller reruns the
prove on the host transcript.  A draw the replay gets otherwise than the
device did is a fault of the device path: it raises
device_transcript.TranscriptDivergence, which names the draw.  Proof bytes
are therefore the host path's whenever the device path succeeds.  Any other
exception propagates.

Scope: a Goldilocks SerializingChallenger64 over BLAKE3 trees with the
degree-2 extension (the GoldilocksBlake3 config), on any device.  The
BabyBearPoseidon2 config keeps the host transcript.

Transcript schedule mirrored from prover.prove_host_transcript.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import device_transcript as dt
from . import lookup as lk
from . import prover
from .challenger import SerializingChallenger64, _canonical_claims_array, observe_claims as _observe_claims_host
from .merkle import Blake3FieldHasher
from .pcs import FriProof
from .profiling import span
from .utils import fetch


def eligible(config) -> bool:
    """The device transcript replicates a Goldilocks SerializingChallenger64
    over BLAKE3 trees with the degree-2 extension; a sharded prove (an
    active parallel mesh) takes the host transcript, as in the JAX
    package."""
    from . import parallel

    return (
        parallel.current_mesh() is None
        and isinstance(config.initialise_challenger(), SerializingChallenger64)
        and isinstance(config.pcs.mmcs.hasher, Blake3FieldHasher)
        and config.host_field.p == dt.GOLDILOCKS_P
        and config.ext.D == 2
    )


def _cap_bytes(cap: np.ndarray) -> bytes:
    """Host cap (k, 8) uint32 -> the observe_commitment byte stream."""
    return np.ascontiguousarray(np.atleast_2d(cap).astype("<u4")).tobytes()


def _observe_claims_dd(dd: dt.DeviceDuplex, claims, p: int) -> Optional[np.ndarray]:
    """DeviceDuplex mirror of SerializingChallenger64.observe_claims; returns
    the canonical (n, L) array (None for no claims)."""
    dd.observe_u64(len(claims))
    if len(claims) == 0:
        return None
    arr = _canonical_claims_array(claims, p)
    if arr is None:
        # few or ragged claims: observe one by one, rectangularize if possible
        for claim in claims:
            dd.observe_u64(len(claim))
            for v in claim:
                dd.observe_u64(int(v) % p)
        arr = lk.claims_matrix(claims, p)
        if arr is None:
            raise dt.Fallback("ragged claims")
        return arr
    buf = np.empty((arr.shape[0], arr.shape[1] + 1), dtype="<u8")
    buf[:, 0] = arr.shape[1]
    buf[:, 1:] = arr
    dd.observe_bytes(buf.tobytes())
    return arr


def _zps(config, zeta: torch.Tensor, specs) -> dict:
    """The opening points from the device ζ: spec ("z",) is ζ, ("zg", g) is
    ζ·g for the trace domain's generator g (one K1 product each)."""
    F, E = config.field, config.ext
    out = {}
    for spec in specs:
        if spec not in out:
            out[spec] = zeta if spec[0] == "z" else E.scale(zeta, F.const(spec[1], config.device))
    return out


def _obs_words(vals) -> torch.Tensor:
    """Every claimed value flattened to int32 words in the host's observation
    order: per round, matrix, point, column, coordinate, u64 LE."""
    parts = [v.T.contiguous().reshape(-1).view(torch.int32)
             for round_vals in vals for mat_vals in round_vals for v in mat_vals]
    return torch.cat(parts)


@dataclass
class _DevicePhase:
    """What the device phase leaves for the fetch and the replay."""

    active: List[bool]
    log_degrees: List[int]
    datas: list  # PcsProverData: preprocessed (if any), stage 1, stage 2, quotient
    points: list  # per round, per matrix: the point specs
    caps: list  # stage-1, stage-2, quotient caps (device)
    accs: list  # (D,) device accumulators
    vals: list  # [round][matrix] = (D, w) device claimed values per point
    challenges: list  # β, γ, α, ζ, FRI α: (D,) device scalars
    valids: list  # the draws' `< p` flags
    fri: tuple  # caps, witnesses, βs, ok flags, commit datas, last fold, its log size
    schedule: List[int]
    log_max: int
    log_max_ro: int


def prove_device_transcript(system, key, witness, claims):
    """The whole-prove device-transcript path: a Proof with the host path's
    bytes, or None after a Fallback (its reason counted in
    device_transcript.FALLBACKS; the caller reruns the host transcript)."""
    try:
        return _prove_dt(system, key, witness, claims)
    except dt.Fallback as reason:
        dt.FALLBACKS[str(reason)] += 1
        return None


def _prove_dt(system, key, witness, claims):
    with span("stark/prove"), contextlib.ExitStack() as fri_open:
        return _fetch_and_replay(system, key, witness, claims, _device_phase(system, key, witness, claims, fri_open))


def _device_phase(system, key, witness, claims, fri_open: Optional[contextlib.ExitStack] = None) -> _DevicePhase:
    """Everything up to the global fetch: no op here waits for the device
    (chip_smoke.py runs it under torch.cuda.set_sync_debug_mode("error")).
    The "stark/fri_open" span, which the JAX package keeps around the open
    and the replay together, is entered into `fri_open` at the claimed
    evaluations and closes with that stack."""
    config = system.config
    F, E = config.field, config.ext
    hf, pcs, D = config.host_field, config.pcs, config.ext.D

    dd = dt.DeviceDuplex(config.device)
    dd.observe_bytes(bytes(config.initialise_challenger().inner.input_buffer))
    system.observe_shape(dd)
    active = [h > 0 for h in witness.heights]
    if not any(active):
        raise ValueError("at least one circuit must be active")
    for b in active:
        dd.observe_bytes(bytes([1 if b else 0]))
    active_idx = [i for i, b in enumerate(active) if b]
    log_degrees = [witness.heights[i].bit_length() - 1 for i in active_idx]

    # STAGE-1 COMMIT (the cap stays on the device)
    with span("stark/stage1_commit"):
        s1_cap, s1_data = pcs.commit_device(
            [(pcs.natural_domain_for_degree(witness.heights[i]), witness.traces[i]) for i in active_idx]
        )
    if system.preprocessed_commit is not None:
        dd.observe_bytes(_cap_bytes(system.preprocessed_commit))
    dd.observe_cap_device(s1_cap)
    for ld in log_degrees:
        dd.observe_bytes(bytes([ld]))
    with span("stark/claims"):
        claims_arr = _observe_claims_dd(dd, claims, hf.p)
        beta = dd.sample_ext(D)
        gamma = dd.sample_ext(D)
        if claims_arr is None:
            acc0 = torch.zeros(D, dtype=torch.int64, device=config.device)
        else:
            acc0 = lk.claims_accumulator_device(F, E, claims_arr, beta, gamma)

    # STAGE-2 (device β γ acc₀)
    with span("stark/lookup_construction"):
        s2_mats, accs = lk.stage_2_traces_device(E, [witness.lookup_values[i] for i in active_idx], beta, gamma, acc0)
    with span("stark/stage2_commit"):
        s2_cap, s2_data = pcs.commit_device(
            [(pcs.natural_domain_for_degree(witness.heights[i]), m) for i, m in zip(active_idx, s2_mats)]
        )
    dd.observe_cap_device(s2_cap)
    for a in accs:
        dd.observe_ext_device(a)

    alpha = dd.sample_ext(D)

    # QUOTIENT (device β, γ, accumulators and α)
    with span("stark/quotient"):
        chunk_mats = [
            prover._quotient_chunk_coeffs(
                system, key, witness, s1_data, s2_data, i, k, beta, gamma, alpha, acc0 if k == 0 else accs[k - 1],
                accs[k],
            )
            for k, i in enumerate(active_idx)
        ]
        q_cap, q_data = pcs.commit_from_coeffs_device(chunk_mats)
    dd.observe_cap_device(q_cap)

    zeta = dd.sample_ext(D)

    # opening rounds: preprocessed?, stage 1, stage 2, quotient (point specs)
    def two_pt(c_idx):
        return [("z",), ("zg", hf.two_adic_generator(witness.heights[c_idx].bit_length() - 1))]

    datas, points = [], []
    if key.preprocessed_data is not None:
        datas.append(key.preprocessed_data)
        points.append([two_pt(c) if active[c] else [] for c, p in enumerate(system.preprocessed_index)
                       if p is not None])
    datas += [s1_data, s2_data, q_data]
    points += [[two_pt(i) for i in active_idx], [two_pt(i) for i in active_idx], [[("z",)] for _ in active_idx]]
    if fri_open is not None:
        fri_open.enter_context(span("stark/fri_open"))

    # claimed evaluations, observed as one device segment
    with span("stark/fri_open/eval"):
        zps = _zps(config, zeta, [s for pts in points for mat in pts for s in mat])
        rounds = [(data, [[(s, zps[s]) for s in mat] for mat in pts]) for data, pts in zip(datas, points)]
        vals = pcs._claimed_evaluations(rounds)
        dd.observe_words_device(_obs_words(vals))
    alpha_fri = dd.sample_ext(D)

    with span("stark/fri_open/ro"):
        ro = pcs._reduced_openings(rounds, vals, alpha_fri)
    if not ro:
        raise dt.Fallback("no reduced openings")
    log_max = max(data.log_max_lde for data in datas)
    log_max_ro = max(ro.keys())
    schedule = pcs.fri_schedule(ro.keys(), log_max_ro)
    if not schedule:
        raise dt.Fallback("degenerate FRI (no folds)")
    with span("stark/fri_open/fold"):
        entry = dd.entry_words()
        if entry is None:
            raise dt.Fallback("unaligned duplex buffer at FRI entry")
        fri = pcs._commit_phase_device_core(ro, schedule, log_max_ro, entry)
    return _DevicePhase(
        active, log_degrees, datas, points, [s1_cap, s2_cap, q_cap], accs, vals,
        [beta, gamma, alpha, zeta, alpha_fri], dd.valids, fri, schedule, log_max, log_max_ro,
    )


def _fetch_and_replay(system, key, witness, claims, ph: _DevicePhase):
    """THE global fetch, then the authoritative host replay, the transcript
    tail and the query phase."""
    config = system.config
    pcs = config.pcs
    fri_caps, ws, betas, oks, commit_datas, current, log_size = ph.fri
    flat_vals = [v for round_vals in ph.vals for mat_vals in round_vals for v in mat_vals]
    groups = [ph.caps, ph.accs, flat_vals, ph.challenges, ph.valids, fri_caps, ws, betas, oks, [current]]
    got = iter(fetch([t for g in groups for t in g]))
    with span("stark/replay"):
        caps, accs, vals_np, challenges, valids, fri_caps_np, ws_np, betas_np, oks_np, (current_np,) = (
            [next(got) for _ in g] for g in groups
        )
        if not all(int(v) == 1 for flags in valids for v in flags):
            raise dt.Fallback("non-canonical draw on the device")

        def ext(a):
            return tuple(int(c) for c in a)

        accs_host = [ext(a) for a in accs]
        vals_it = iter(vals_np)
        opened = [[[[ext(col) for col in next(vals_it).T] for _ in mat_vals] for mat_vals in round_vals]
                  for round_vals in ph.vals]

        # the host challenger replays the byte transcript and checks every draw
        ch = config.initialise_challenger()
        system.observe_shape(ch)
        for b in ph.active:
            ch.observe_bytes(bytes([1 if b else 0]))
        if system.preprocessed_commit is not None:
            ch.observe_commitment(system.preprocessed_commit)
        ch.observe_commitment(caps[0])
        for ld in ph.log_degrees:
            ch.observe_bytes(bytes([ld]))
        _observe_claims_host(ch, claims)
        beta, gamma, alpha, zeta, alpha_fri = (ext(c) for c in challenges)

        def replay_draw(name, device_value):
            host_value = ch.sample_ext()
            if host_value != device_value:
                raise dt.TranscriptDivergence(f"replay: the device drew {name} = {device_value}, the host {host_value}")

        replay_draw("β", beta)
        replay_draw("γ", gamma)
        ch.observe_commitment(caps[1])
        for a in accs_host:
            ch.observe_ext(a)
        replay_draw("α", alpha)
        ch.observe_commitment(caps[2])
        replay_draw("ζ", zeta)
        for round_vals in opened:
            for mat_vals in round_vals:
                for pt_vals in mat_vals:
                    for v in pt_vals:
                        ch.observe_ext(v)
        replay_draw("FRI α", alpha_fri)
        fri_caps_host, commit_pows = pcs.replay_commit_phase_host(ch, ph.schedule, fri_caps_np, ws_np, betas_np, oks_np)
        final_poly, query_pow, indices = pcs._commit_tail(
            [ext(col) for col in current_np.T], log_size, ph.log_max_ro, ph.log_max, ch
        )
    with span("stark/fri_open/queries"):
        query_proofs = pcs._query_phase(
            [(data, None) for data in ph.datas], commit_datas, indices, ph.schedule, ph.log_max, ph.log_max_ro
        )
    fri_proof = FriProof(
        commit_caps=fri_caps_host,
        commit_pow_witnesses=commit_pows,
        final_poly=final_poly,
        query_pow_witness=query_pow,
        query_proofs=query_proofs,
    )
    r = 1 if key.preprocessed_data is not None else 0
    return prover.Proof(
        active=ph.active,
        commitments=prover.Commitments(caps[0], caps[1], caps[2]),
        intermediate_accumulators=accs_host,
        log_degrees=ph.log_degrees,
        preprocessed_opened=opened[0] if r else [],
        stage1_opened=opened[r],
        stage2_opened=opened[r + 1],
        quotient_opened=opened[r + 2],
        fri_proof=fri_proof,
        field_bytes=8,
    )
