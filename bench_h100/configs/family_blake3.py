"""The 10-circuit BLAKE3 compression family (reference
src/test_circuits/blake3.rs; the bench workload at blake3.rs:2216-2340):
the plain reference's copy of its circuits, the seeded traffic's input
generator (a frozen copy of the hasher-driven witness builder: hash the
message with the full BLAKE3 chunk and parent tree, record every
compression as a claim, and derive the ten traces from the claims in
batched NumPy, rows in the reference builders' order), and the program's
circuits.

Ten circuits decompose one BLAKE3 compression into channel-connected pieces:

  limb range table   pulls (RANGE_CHAN, v)                    [2^B rows]
  limb xor table     pulls (LXOR_CHAN, a, b, a^b)             [2^(2B) rows]
  U32Add             pulls (ADD_CHAN, x, y, z), pushes limb ranges
  U32Xor             pulls (XOR_CHAN, x, y, z), pushes limb xors
  U32RotateRight{16,12,8,7}
                     pull (ROTk_CHAN, x, z), push limb ranges
  GFunction          pulls (G_CHAN, a,b,c,d,mx,my, a',b',c',d'),
                     pushes 6 adds + 4 xors + 4 rotates
  Compression        pulls (COMPRESS_CHAN, cv[8], block[16], t0, t1, blen,
                     flags, out[16]), pushes 56 G calls + 16 final xors

The order of the lookups and of their expressions decides the proof bytes,
so the circuits are the program's term for term.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from plainref import expr as ex
from plainref.blake3 import (BLOCK_LEN, CHUNK_END, CHUNK_LEN, CHUNK_START, IV as _IV_WORDS, MSG_PERM, PARENT, ROOT,
                             _G as _G_IDX, compress as compress_batch, hash_bytes as blake3_hash)
from plainref.system import CircuitInputs

IV = tuple(int(v) for v in _IV_WORDS)  # Python integers: the circuits take them as constants

RANGE_CHAN = 20
LXOR_CHAN = 21
ADD_CHAN = 22
XOR_CHAN = 23
ROT_CHANS = {16: 24, 12: 25, 8: 26, 7: 27}
G_CHAN = 28
COMPRESS_CHAN = 29

M32 = 0xFFFFFFFF


# --- circuit definitions -----------------------------------------------------

def limb_range_table(limb_bits: int) -> CircuitInputs:
    n = 1 << limb_bits
    table = np.arange(n, dtype=np.uint64).reshape(n, 1)
    return CircuitInputs(
        main_width=1,
        constraints=[],
        ext_constraints=[],
        lookups=[ex.Lookup.pull(ex.main(0), [ex.Const(RANGE_CHAN), ex.preprocessed(0)])],
        preprocessed=table,
    )


def limb_xor_table(limb_bits: int) -> CircuitInputs:
    n = 1 << limb_bits
    a = np.repeat(np.arange(n, dtype=np.uint64), n)
    b = np.tile(np.arange(n, dtype=np.uint64), n)
    table = np.stack([a, b, a ^ b], axis=1)
    return CircuitInputs(
        main_width=1,
        constraints=[],
        ext_constraints=[],
        lookups=[
            ex.Lookup.pull(
                ex.main(0),
                [ex.Const(LXOR_CHAN), ex.preprocessed(0), ex.preprocessed(1), ex.preprocessed(2)],
            )
        ],
        preprocessed=table,
    )


def _compose(cols: Sequence[ex.Expr], limb_bits: int) -> ex.Expr:
    acc = ex.Const(0)
    for i, c in enumerate(cols):
        acc = acc + (1 << (limb_bits * i)) * c
    return acc


def u32_add_circuit(limb_bits: int) -> CircuitInputs:
    """x + y = z + carry·2^32 in limbs; limbs range-checked."""
    k = 32 // limb_bits
    x = [ex.main(i) for i in range(k)]
    y = [ex.main(k + i) for i in range(k)]
    z = [ex.main(2 * k + i) for i in range(k)]
    carry, mult = ex.main(3 * k), ex.main(3 * k + 1)
    lhs = _compose(x, limb_bits) + _compose(y, limb_bits) - _compose(z, limb_bits)
    constraints = [carry * (carry - 1), mult * (mult - 1), lhs - carry * (1 << 32)]
    lookups = [
        ex.Lookup.pull(
            mult,
            [ex.Const(ADD_CHAN), _compose(x, limb_bits), _compose(y, limb_bits), _compose(z, limb_bits)],
        )
    ]
    for c in x + y + z:
        lookups.append(ex.Lookup.push(mult, [ex.Const(RANGE_CHAN), c]))
    return CircuitInputs(3 * k + 2, constraints, [], lookups)


def u32_xor_circuit(limb_bits: int) -> CircuitInputs:
    """x ^ y = z via per-limb xor-table pushes."""
    k = 32 // limb_bits
    x = [ex.main(i) for i in range(k)]
    y = [ex.main(k + i) for i in range(k)]
    z = [ex.main(2 * k + i) for i in range(k)]
    mult = ex.main(3 * k)
    lookups = [
        ex.Lookup.pull(
            mult,
            [ex.Const(XOR_CHAN), _compose(x, limb_bits), _compose(y, limb_bits), _compose(z, limb_bits)],
        )
    ]
    for i in range(k):
        lookups.append(ex.Lookup.push(mult, [ex.Const(LXOR_CHAN), x[i], y[i], z[i]]))
    return CircuitInputs(3 * k + 1, [mult * (mult - 1)], [], lookups)


def rotate_circuit(r: int, limb_bits: int) -> CircuitInputs:
    """z = rotr(x, r): x = hi·2^r + lo (lo r bits), z = lo·2^(32-r) + hi.
    lo and hi are decomposed into B-bit limbs (partial top limbs are
    range-checked by the scaling trick v·2^(B-bits) < 2^B)."""

    def limb_split(bits: int, base_col: int):
        cols = []
        sizes = []
        rem = bits
        i = 0
        while rem > 0:
            take = min(limb_bits, rem)
            cols.append(ex.main(base_col + i))
            sizes.append(take)
            rem -= take
            i += 1
        return cols, sizes

    lo_cols, lo_sizes = limb_split(r, 0)
    hi_cols, hi_sizes = limb_split(32 - r, len(lo_cols))
    width = len(lo_cols) + len(hi_cols) + 1
    mult = ex.main(width - 1)

    def compose_sized(cols, sizes):
        acc = ex.Const(0)
        shift = 0
        for c, s in zip(cols, sizes):
            acc = acc + (1 << shift) * c
            shift += s
        return acc

    lo = compose_sized(lo_cols, lo_sizes)
    hi = compose_sized(hi_cols, hi_sizes)
    x = hi * (1 << r) + lo
    z = lo * (1 << (32 - r)) + hi
    lookups = [ex.Lookup.pull(mult, [ex.Const(ROT_CHANS[r]), x, z])]
    for c, s in zip(lo_cols + hi_cols, lo_sizes + hi_sizes):
        scaled = c * (1 << (limb_bits - s)) if s < limb_bits else c
        lookups.append(ex.Lookup.push(mult, [ex.Const(RANGE_CHAN), scaled]))
    return CircuitInputs(width, [mult * (mult - 1)], [], lookups)


def g_function_circuit() -> CircuitInputs:
    """One BLAKE3 G evaluation in u32 words; every arithmetic step is
    delegated to a primitive circuit through its channel
    (reference blake3.rs GFunction)."""
    names = [
        "a", "b", "c", "d", "mx", "my",
        "t1", "a1", "xd1", "d1", "c1", "xb1", "b1",
        "t2", "a2", "xd2", "d2", "c2", "xb2", "b2",
    ]
    col = {n: ex.main(i) for i, n in enumerate(names)}
    mult = ex.main(len(names))
    L = ex.Lookup
    v = col
    lookups = [
        L.pull(
            mult,
            [ex.Const(G_CHAN), v["a"], v["b"], v["c"], v["d"], v["mx"], v["my"],
             v["a2"], v["b2"], v["c2"], v["d2"]],
        ),
        L.push(mult, [ex.Const(ADD_CHAN), v["a"], v["b"], v["t1"]]),
        L.push(mult, [ex.Const(ADD_CHAN), v["t1"], v["mx"], v["a1"]]),
        L.push(mult, [ex.Const(XOR_CHAN), v["d"], v["a1"], v["xd1"]]),
        L.push(mult, [ex.Const(ROT_CHANS[16]), v["xd1"], v["d1"]]),
        L.push(mult, [ex.Const(ADD_CHAN), v["c"], v["d1"], v["c1"]]),
        L.push(mult, [ex.Const(XOR_CHAN), v["b"], v["c1"], v["xb1"]]),
        L.push(mult, [ex.Const(ROT_CHANS[12]), v["xb1"], v["b1"]]),
        L.push(mult, [ex.Const(ADD_CHAN), v["a1"], v["b1"], v["t2"]]),
        L.push(mult, [ex.Const(ADD_CHAN), v["t2"], v["my"], v["a2"]]),
        L.push(mult, [ex.Const(XOR_CHAN), v["d1"], v["a2"], v["xd2"]]),
        L.push(mult, [ex.Const(ROT_CHANS[8]), v["xd2"], v["d2"]]),
        L.push(mult, [ex.Const(ADD_CHAN), v["c1"], v["d2"], v["c2"]]),
        L.push(mult, [ex.Const(XOR_CHAN), v["b1"], v["c2"], v["xb2"]]),
        L.push(mult, [ex.Const(ROT_CHANS[7]), v["xb2"], v["b2"]]),
    ]
    return CircuitInputs(len(names) + 1, [mult * (mult - 1)], [], lookups)


# G-call wiring per round (column/diagonal order): hash/blake3_host.G_INDEX


def compression_circuit() -> CircuitInputs:
    """One BLAKE3 compression per row: 28 input words, 56 G-call output
    windows (4 words each), 16 output words, multiplicity.  The message
    permutation schedule is applied symbolically (reference blake3.rs:722-754)."""
    cv = [ex.main(i) for i in range(8)]
    block = [ex.main(8 + i) for i in range(16)]
    t0, t1, blen, flags = (ex.main(24 + i) for i in range(4))
    n_fixed = 28
    g_out_base = n_fixed
    out_base = g_out_base + 56 * 4
    out = [ex.main(out_base + i) for i in range(16)]
    mult = ex.main(out_base + 16)
    width = out_base + 17

    state: List[ex.Expr] = list(cv) + [ex.Const(IV[i]) for i in range(4)] + [t0, t1, blen, flags]
    msg: List[ex.Expr] = list(block)
    lookups: List[ex.Lookup] = []
    g_call = 0
    for rnd in range(7):
        for gi, (ia, ib, ic, id_) in enumerate(_G_IDX):
            mx, my = msg[2 * gi], msg[2 * gi + 1]
            outs = [ex.main(g_out_base + 4 * g_call + j) for j in range(4)]
            lookups.append(
                ex.Lookup.push(
                    mult,
                    [ex.Const(G_CHAN), state[ia], state[ib], state[ic], state[id_],
                     mx, my, outs[0], outs[1], outs[2], outs[3]],
                )
            )
            state[ia], state[ib], state[ic], state[id_] = outs[0], outs[1], outs[2], outs[3]
            g_call += 1
        msg = [msg[p] for p in MSG_PERM]
    for i in range(8):
        lookups.append(ex.Lookup.push(mult, [ex.Const(XOR_CHAN), state[i], state[i + 8], out[i]]))
        lookups.append(ex.Lookup.push(mult, [ex.Const(XOR_CHAN), state[i + 8], cv[i], out[i + 8]]))
    lookups.append(
        ex.Lookup.pull(
            mult,
            [ex.Const(COMPRESS_CHAN)] + cv + block + [t0, t1, blen, flags] + out,
        )
    )
    return CircuitInputs(width, [mult * (mult - 1)], [], lookups)


def blake3_system_inputs(limb_bits: int = 8) -> List[CircuitInputs]:
    return [
        compression_circuit(),
        g_function_circuit(),
        u32_add_circuit(limb_bits),
        u32_xor_circuit(limb_bits),
        rotate_circuit(16, limb_bits),
        rotate_circuit(12, limb_bits),
        rotate_circuit(8, limb_bits),
        rotate_circuit(7, limb_bits),
        limb_xor_table(limb_bits),
        limb_range_table(limb_bits),
    ]




# --- input generation ---------------------------------------------------------
#
# Every G call's 20 words are NumPy arrays over the compressions: a round's
# four column calls, then its four diagonal calls, are one vectorized step
# each over (n, 4) words, 14 steps whatever n is.  The rows come out in the
# JAX builders' order (compression by compression, G call by G call), which
# the traces' bytes depend on.

# a GFunction row's words (its trace columns 0-19)
_G_WORDS = ("a", "b", "c", "d", "mx", "my", "t1", "a1", "xd1", "d1", "c1", "xb1", "b1",
            "t2", "a2", "xd2", "d2", "c2", "xb2", "b2")
_W = {name: i for i, name in enumerate(_G_WORDS)}
# per G call, in this order: its six adds, four xors, the rotations and its outputs
_ADDS = [[_W[x], _W[y], _W[z]] for x, y, z in (("a", "b", "t1"), ("t1", "mx", "a1"), ("c", "d1", "c1"),
                                                ("a1", "b1", "t2"), ("t2", "my", "a2"), ("c1", "d2", "c2"))]
_XORS = [[_W[x], _W[y], _W[z]] for x, y, z in (("d", "a1", "xd1"), ("b", "c1", "xb1"), ("d1", "a2", "xd2"),
                                                ("b1", "c2", "xb2"))]
_ROTS = {16: [_W["xd1"], _W["d1"]], 12: [_W["xb1"], _W["b1"]], 8: [_W["xd2"], _W["d2"]], 7: [_W["xb2"], _W["b2"]]}
_G_OUT = [_W["a2"], _W["b2"], _W["c2"], _W["d2"]]


def _rotr(x: np.ndarray, r: int) -> np.ndarray:
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _g_words(cv, block, counter, blen, flags):
    """Run the 56 G calls of n compressions at once.  Returns (the (n, 56,
    20) uint32 words of every G call, in _G_WORDS order, and the (n, 16)
    final state)."""
    n = cv.shape[0]
    st = np.empty((n, 16), np.uint32)
    st[:, :8] = cv
    st[:, 8:12] = np.asarray(IV[:4], np.uint32)
    st[:, 12] = (counter & np.uint64(M32)).astype(np.uint32)
    st[:, 13] = (counter >> np.uint64(32)).astype(np.uint32)
    st[:, 14], st[:, 15] = blen, flags
    msg = block
    g = np.empty((n, 56, len(_G_WORDS)), np.uint32)
    for rnd in range(7):
        for half in (0, 1):  # the four column calls, then the four diagonal calls
            idx = np.asarray(_G_IDX[4 * half : 4 * half + 4]).T  # (4 words, 4 calls)
            w = {"a": st[:, idx[0]], "b": st[:, idx[1]], "c": st[:, idx[2]], "d": st[:, idx[3]],
                 "mx": msg[:, 8 * half : 8 * half + 8 : 2], "my": msg[:, 8 * half + 1 : 8 * half + 8 : 2]}
            w["t1"] = w["a"] + w["b"]
            w["a1"] = w["t1"] + w["mx"]
            w["xd1"] = w["d"] ^ w["a1"]
            w["d1"] = _rotr(w["xd1"], 16)
            w["c1"] = w["c"] + w["d1"]
            w["xb1"] = w["b"] ^ w["c1"]
            w["b1"] = _rotr(w["xb1"], 12)
            w["t2"] = w["a1"] + w["b1"]
            w["a2"] = w["t2"] + w["my"]
            w["xd2"] = w["d1"] ^ w["a2"]
            w["d2"] = _rotr(w["xd2"], 8)
            w["c2"] = w["c1"] + w["d2"]
            w["xb2"] = w["b1"] ^ w["c2"]
            w["b2"] = _rotr(w["xb2"], 7)
            g[:, 8 * rnd + 4 * half : 8 * rnd + 4 * half + 4] = np.stack([w[k] for k in _G_WORDS], axis=-1)
            for j, k in enumerate(("a2", "b2", "c2", "d2")):
                st[:, idx[j]] = w[k]
        msg = msg[:, list(MSG_PERM)]
    return g, st


def _pad_rows(rows, width: int) -> np.ndarray:
    """rows ((m, width) array or list of rows) below zeros up to the next
    power of two of max(1, m) rows."""
    rows = np.asarray(rows, np.uint64).reshape(-1, width)
    h = 1 << (max(1, rows.shape[0]) - 1).bit_length()
    out = np.zeros((h, width), np.uint64)
    out[: rows.shape[0]] = rows
    return out


def _limbs(words: np.ndarray, limb_bits: int) -> np.ndarray:
    """(..., 32 // limb_bits) limbs of u32 words, lowest first."""
    shifts = np.uint64(limb_bits) * np.arange(32 // limb_bits, dtype=np.uint64)
    return (words.astype(np.uint64)[..., None] >> shifts) & np.uint64((1 << limb_bits) - 1)


def _as_arrays(compressions):
    """(cv (n, 8), block (n, 16) uint32, counter (n,) uint64, blen, flags
    (n,) uint32) from a list of (cv[8], block[16], counter, blen, flags)."""
    n = len(compressions)
    cv = np.asarray([c[0] for c in compressions], np.uint32).reshape(n, 8)
    block = np.asarray([c[1] for c in compressions], np.uint32).reshape(n, 16)
    counter = np.asarray([c[2] for c in compressions], np.uint64).reshape(n)
    blen = np.asarray([c[3] for c in compressions], np.uint32).reshape(n)
    flags = np.asarray([c[4] for c in compressions], np.uint32).reshape(n)
    return cv, block, counter, blen, flags


def blake3_witness(
    compressions: Sequence[Tuple[Sequence[int], Sequence[int], int, int, int]],
    limb_bits: int = 8,
):
    """compressions: list of (cv[8], block[16], counter, blen, flags).
    Returns (traces ordered as blake3_system_inputs, claims as an (n, 45)
    uint64 array)."""
    return _witness(*_as_arrays(compressions), limb_bits)


def _witness(cv, block, counter, blen, flags, limb_bits: int):
    k = 32 // limb_bits
    n = cv.shape[0]
    g, st = _g_words(cv, block, counter, blen, flags)
    out = np.concatenate([st[:, :8] ^ st[:, 8:], st[:, 8:] ^ cv], axis=1)
    # cross-check against the host compression, all compressions at once
    assert np.array_equal(out, compress_batch(cv, block, counter, blen, flags)), \
        "instrumented compression disagrees with host blake3"
    t = np.stack([counter & np.uint64(M32), counter >> np.uint64(32)], axis=1)
    fixed = np.concatenate([cv, block, t, blen[:, None], flags[:, None]], axis=1, dtype=np.uint64)  # (n, 28)
    ones = np.ones((n, 1), np.uint64)
    comp_rows = np.concatenate([fixed, g[:, :, _G_OUT].reshape(n, 224), out, ones], axis=1, dtype=np.uint64)
    claims = np.concatenate([np.full((n, 1), COMPRESS_CHAN, np.uint64), fixed, out], axis=1, dtype=np.uint64)

    adds = g[:, :, _ADDS].reshape(-1, 3).astype(np.uint64)
    # per compression its 56 x 4 G xors, then (state[i], state[i+8], out[i]),
    # (state[i+8], cv[i], out[i+8]) for i = 0..7
    final = np.stack([np.stack([st[:, :8], st[:, 8:], out[:, :8]], axis=-1),
                      np.stack([st[:, 8:], cv, out[:, 8:]], axis=-1)], axis=2).reshape(n, 16, 3)
    xors = np.concatenate([g[:, :, _XORS].reshape(n, 224, 3), final], axis=1).reshape(-1, 3).astype(np.uint64)

    range_mult = np.zeros(1 << limb_bits, np.uint64)

    def count(values, into):
        into += np.bincount(values.reshape(-1).astype(np.int64), minlength=into.shape[0]).astype(np.uint64)

    add_limbs = _limbs(adds, limb_bits)  # (m, 3, k)
    count(add_limbs, range_mult)
    carry = (adds[:, 0] + adds[:, 1]) >> np.uint64(32)
    add_rows = np.concatenate([add_limbs.reshape(-1, 3 * k), carry[:, None], np.ones_like(carry)[:, None]], axis=1)
    xor_limbs = _limbs(xors, limb_bits)
    lxor_mult = np.zeros(1 << (2 * limb_bits), np.uint64)
    count((xor_limbs[:, 0] << np.uint64(limb_bits)) | xor_limbs[:, 1], lxor_mult)
    xor_rows = np.concatenate([xor_limbs.reshape(-1, 3 * k), np.ones((xors.shape[0], 1), np.uint64)], axis=1)
    rot_ts = {}
    for r in (16, 12, 8, 7):
        x = g[:, :, _ROTS[r][0]].reshape(-1).astype(np.uint64)
        cols = []
        for bits, val in ((r, x & np.uint64((1 << r) - 1)), (32 - r, x >> np.uint64(r))):
            rem = bits
            while rem > 0:
                take = min(limb_bits, rem)
                limb = val & np.uint64((1 << take) - 1)
                cols.append(limb)
                count(limb << np.uint64(limb_bits - take), range_mult)
                val = val >> np.uint64(take)
                rem -= take
        rows = np.stack(cols + [np.ones_like(x)], axis=1)
        rot_ts[r] = _pad_rows(rows, rows.shape[1])

    # inert padding rows still fire table pulls?  no: pushes are mult-gated,
    # and table circuits pull with computed multiplicities only.
    traces = [
        _pad_rows(comp_rows, 28 + 56 * 4 + 16 + 1),
        _pad_rows(np.concatenate([g.reshape(-1, 20), np.ones((n * 56, 1), np.uint32)], axis=1), 21),
        _pad_rows(add_rows, 3 * k + 2),
        _pad_rows(xor_rows, 3 * k + 1),
        rot_ts[16],
        rot_ts[12],
        rot_ts[8],
        rot_ts[7],
        lxor_mult.reshape(-1, 1),
        range_mult.reshape(-1, 1),
    ]
    return traces, claims


# --- hasher-driven claim generation -------------------------------------------
#
# The reference ships a from-scratch hasher whose chunk/parent tree generates
# compression claims from hashing real messages (blake3.rs:32-351, the bench
# workload at blake3.rs:2216-2340).  Mirror: run the full BLAKE3 tree on a
# message, record EVERY compression, and turn the recording into the
# 10-circuit witness.  The compressions run batched (every chunk's block b
# in one call, then the parents by their height in the tree) and are emitted
# in the order of the recursive hasher: each chunk's blocks in turn, the left
# subtree before the right, each parent after its two children.

def _hasher_arrays(data: bytes):
    """(digest, cv, block, counter, blen, flags) of every compression that
    hashing `data` performs, in invocation order (as `_as_arrays`)."""
    n_chunks = max(1, -(-len(data) // CHUNK_LEN))
    padded = np.zeros(n_chunks * CHUNK_LEN, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    words = padded.view("<u4").astype(np.uint32).reshape(n_chunks, CHUNK_LEN // BLOCK_LEN, 16)
    chunk_len = np.clip(len(data) - CHUNK_LEN * np.arange(n_chunks), 0, CHUNK_LEN)
    n_blocks = np.maximum(1, -(-chunk_len // BLOCK_LEN))
    per_chunk = CHUNK_LEN // BLOCK_LEN
    rec_cv = np.zeros((n_chunks, per_chunk, 8), np.uint32)
    rec_blen = np.zeros((n_chunks, per_chunk), np.uint32)
    rec_flags = np.zeros((n_chunks, per_chunk), np.uint32)
    cv = np.tile(np.asarray(IV, np.uint32), (n_chunks, 1))
    last_flags = CHUNK_END | (ROOT if n_chunks == 1 else 0)
    for b in range(int(n_blocks.max())):
        act = np.nonzero(n_blocks > b)[0]
        blen = np.clip(chunk_len[act] - BLOCK_LEN * b, 0, BLOCK_LEN).astype(np.uint32)
        flags = np.where(n_blocks[act] - 1 == b, last_flags, 0).astype(np.uint32) | (CHUNK_START if b == 0 else 0)
        rec_cv[act, b], rec_blen[act, b], rec_flags[act, b] = cv[act], blen, flags
        cv[act] = compress_batch(cv[act], words[act, b], act.astype(np.uint64), blen, flags)[:, :8]

    # the parents: (left, right) children as chunk i or parent n_chunks + j,
    # each parent's height, and the post-order of the recursion
    kids, height, order = [], [], []

    def build(c0: int, count: int) -> Tuple[int, int]:
        if count == 1:
            order.append(c0)
            return c0, 0
        split = _left_len(count)
        left, hl = build(c0, split)
        right, hr = build(c0 + split, count - split)
        kids.append((left, right))
        height.append(1 + max(hl, hr))
        order.append(n_chunks + len(kids) - 1)
        return order[-1], height[-1]

    build(0, n_chunks)
    kids_a, height_a = np.asarray(kids, np.int64).reshape(-1, 2), np.asarray(height, np.int64)
    all_cv = np.concatenate([cv, np.zeros((len(kids), 8), np.uint32)])
    par_flags = np.full(len(kids), PARENT, np.uint32)
    if kids:
        par_flags[-1] |= ROOT  # the top parent is built last
    for h in range(1, int(height_a.max(initial=0)) + 1):
        sel = np.nonzero(height_a == h)[0]
        blocks = np.concatenate([all_cv[kids_a[sel, 0]], all_cv[kids_a[sel, 1]]], axis=1)
        all_cv[n_chunks + sel] = compress_batch(np.tile(np.asarray(IV, np.uint32), (len(sel), 1)), blocks, 0,
                                                BLOCK_LEN, par_flags[sel])[:, :8]
    digest = all_cv[n_chunks + len(kids) - 1 if kids else 0].astype("<u4").tobytes()
    assert digest == blake3_hash(data), "instrumented hasher disagrees with blake3_hash"

    # one table of every compression (chunk blocks, then parents), read in
    # the recursion's order
    blocks_par = np.concatenate([all_cv[kids_a[:, 0]], all_cv[kids_a[:, 1]]], axis=1)
    t_cv = np.concatenate([rec_cv.reshape(-1, 8), np.tile(np.asarray(IV, np.uint32), (len(kids), 1))])
    t_block = np.concatenate([words.reshape(-1, 16), blocks_par])
    t_counter = np.concatenate([np.repeat(np.arange(n_chunks, dtype=np.uint64), per_chunk),
                                np.zeros(len(kids), np.uint64)])
    t_blen = np.concatenate([rec_blen.reshape(-1), np.full(len(kids), BLOCK_LEN, np.uint32)])
    t_flags = np.concatenate([rec_flags.reshape(-1), par_flags])
    rows = np.concatenate([np.arange(i * per_chunk, i * per_chunk + n_blocks[i]) if i < n_chunks
                           else [n_chunks * per_chunk + i - n_chunks] for i in order]).astype(np.int64)
    return digest, t_cv[rows], t_block[rows], t_counter[rows], t_blen[rows], t_flags[rows]


def blake3_hasher_compressions(
    data: bytes,
) -> Tuple[bytes, List[Tuple[List[int], List[int], int, int, int]]]:
    """Hash ``data`` with the full BLAKE3 chunk/parent tree, recording every
    compression as a claim tuple (cv, block, counter, blen, flags) in
    invocation order.  Returns (digest, compressions); the digest is
    asserted against the standalone ``blake3_hash``."""
    digest, cv, block, counter, blen, flags = _hasher_arrays(data)
    return digest, [(c, b, int(t), int(n), int(f)) for c, b, t, n, f in
                    zip(cv.tolist(), block.tolist(), counter, blen, flags)]


def blake3_hasher_witness(data: bytes, limb_bits: int = 8):
    """Hasher-driven witness: the 10-circuit traces + claims for every
    compression performed while hashing ``data``.
    Returns (digest, traces, claims as an (n, 45) uint64 array)."""
    digest, *arrays = _hasher_arrays(data)
    traces, claims = _witness(*arrays, limb_bits)
    return digest, traces, claims

def _left_len(n_chunks: int) -> int:
    """Largest power-of-two number of chunks strictly less than the total."""
    p = 1
    while p * 2 < n_chunks:
        p *= 2
    return p


# --- the benchmark's interface --------------------------------------------------

def reference_inputs(cfg: dict) -> List[CircuitInputs]:
    return blake3_system_inputs(cfg["limb_bits"])


def program_inputs(cfg: dict) -> list:
    from multistark_tpu_torch.test_circuits import blake3_circuit

    return blake3_circuit.blake3_system_inputs(cfg["limb_bits"])


def make_input(cfg: dict, traffic: dict, rng: np.random.Generator):
    """One job's input: a message of traffic["message_bytes"] random bytes
    and its witness.  Returns (traces, claims as an (n, 45) uint64 array)."""
    msg = rng.bytes(traffic["message_bytes"])
    _, traces, claims = blake3_hasher_witness(msg, cfg["limb_bits"])
    return traces, claims
