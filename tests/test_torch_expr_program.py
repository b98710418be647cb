"""The per-row constraint programs and the opening reductions on the CPU
against the JAX package, exact (tolerance zero: everything is mod p):

  - each circuit's quotient program, run by kernel K11's plain version
    (program.expr_sweep_plain), equals JAX prover._quotient_sweep_only on
    the same stored LDEs, publics and α, for U32Add, ByteTable and a MulAir,
    at 2^4 and 2^6 rows, under GoldilocksBlake3 and BabyBearPoseidon2;
  - K12's and K13's plain versions (pcs.bary_eval_height_plain through
    `_eval_height`, pcs.reduced_open_height_plain on one matrix) equal JAX
    pcs._eval_kernel and _ro_kernel for one and two points under both
    fields;
  - a program whose live set exceeds K11's register file raises
    RegisterFileExceeded, which names the program, on the plain path too;
  - K11's generator (program.program_body, cuda_source, host_source): the
    same program gives the same source and key, a changed constant, field
    or template a different key, the body covers every opcode, and the
    generated code itself, built with `cc` from the host C template, equals
    expr_sweep_plain and the JAX sweeps (prover._quotient_sweep_only,
    lookup._stage2_msgs) on U32Add's quotient and stage-2 programs at 2^4
    rows under both fields.

The lookup-values and stage-2 message programs are held against the JAX
package by test_torch_system.py (`test_lookup_values_are_equal`,
`test_stage_2_traces_and_accumulators_are_equal`) and every proof-bytes
test.  The systems are built without their preprocessed commitment (the
quotient sweep reads the preprocessed LDE it is given), once per module."""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from multistark_tpu import expr as jex
from multistark_tpu import lookup as jax_lk
from multistark_tpu import prover as jax_prover
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.domains import TwoAdicCoset as JaxCoset
from multistark_tpu.system import CircuitInputs as JaxCircuitInputs, System as JaxSystem
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs
from multistark_tpu.utils import ext_scalar
from multistark_tpu_torch import expr as tex, lookup as tlk, pcs as tpcs, program, prover
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.fields.host import ExtensionParams
from multistark_tpu_torch.system import CircuitInputs, System
from multistark_tpu_torch.test_circuits import u32_add_system_inputs
from multistark_tpu_torch.utils import bit_reverse_indices, ext_powers_device

CONFIGS = {
    "goldilocks_blake3": (JaxGL, GoldilocksBlake3Config),
    "babybear_poseidon2": (JaxBB, BabyBearPoseidon2Config),
}
CIRCUITS = ("u32_add", "byte_table", "mul_air")


def _mul_air(ex):
    a, b, c = ex.main(0), ex.main(1), ex.main(2)
    return dict(
        main_width=3,
        constraints=[a * b - c, ex.main_next(0) - b],
        ext_constraints=[],
        lookups=[ex.Lookup.push(ex.Const(1), [ex.Const(9), a, c]), ex.Lookup.pull(ex.Const(1), [ex.Const(9), a, c])],
    )


def _no_preprocessed(inputs):
    return [dataclasses.replace(ci, preprocessed=None) for ci in inputs]


@pytest.fixture(scope="module", params=list(CONFIGS))
def systems(request):
    """(JAX config, JAX circuits, port system) with circuits U32Add,
    ByteTable, MulAir, built without the preprocessed commitment."""
    jax_cls, torch_cls = CONFIGS[request.param]
    fri = FriParameters.standard_fast()
    jcfg = jax_cls(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**vars(fri)))
    tcfg = torch_cls(CommitmentParameters(log_blowup=2, cap_height=0), fri, device="cpu")
    jsys, _ = JaxSystem.new(jcfg, _no_preprocessed(jax_u32_inputs() + [JaxCircuitInputs(**_mul_air(jex))]))
    tsys, _ = System.new(tcfg, _no_preprocessed(u32_add_system_inputs() + [CircuitInputs(**_mul_air(tex))]))
    return jcfg, jsys, tsys


def _rand(rng, p, *shape):
    return rng.integers(0, p, shape, dtype=np.uint64)


_QUOTIENT_CASES = {}


def _quotient_case(systems, circuit, log_n):
    """The operands of circuit's quotient sweep at 2^log_n rows (stored
    bit-reversed LDEs twice as tall as the quotient domain, publics, α) and
    JAX prover._quotient_sweep_only's result on their natural-order prefix;
    made once per (config, circuit, log_n)."""
    jcfg, jsys, tsys = systems
    key = (jcfg.host_field.name, circuit, log_n)
    if key in _QUOTIENT_CASES:
        return _QUOTIENT_CASES[key]
    c_idx = CIRCUITS.index(circuit)
    jc, tc = jsys.circuits[c_idx], tsys.circuits[c_idx]
    hf, D = jcfg.host_field, jcfg.extension_params.degree
    F, JF = tsys.config.field, jcfg.field
    q = tc.quotient_degree
    log_m = log_n + (q.bit_length() - 1)
    m = 1 << log_m
    rng = np.random.default_rng(1000 * c_idx + log_n)
    widths = {0: 1 if circuit == "byte_table" else 0, 1: tc.main_width, 2: tc.stage2_width}
    natural = {src: _rand(rng, hf.p, w, m) for src, w in widths.items() if w}
    brev = bit_reverse_indices(log_m)
    # the port reads stored bit-reversed LDEs, twice as tall as the quotient domain
    stored = {src: F.from_np(np.concatenate([a[:, brev], _rand(rng, hf.p, a.shape[0], m)], axis=1), "cpu")
              for src, a in natural.items()}
    pubs = [tuple(int(c) for c in _rand(rng, hf.p, D)) for _ in range(4)]
    alpha = tuple(int(c) for c in _rand(rng, hf.p, D))

    trace_dom = JaxCoset(hf, log_n, 1)
    qdom = trace_dom.create_disjoint_domain((1 << log_n) * q)
    want = jax_prover._quotient_sweep_only(
        jcfg, jc, log_n, q, {src: JF.from_np(a) for src, a in natural.items()},
        jax_prover._selectors_device(jcfg, trace_dom, qdom, log_n, q),
        tuple(ext_scalar(jcfg.ext, v) for v in pubs), ext_scalar(jcfg.ext, alpha),
    )
    case = dict(c_idx=c_idx, q=q, m=m, log_m=log_m, D=D, brev=brev, stored=stored, want=JF.to_np(want),
                pubs=F.from_np(np.asarray(pubs, np.uint64), "cpu"), alpha=F.from_np(np.asarray(alpha, np.uint64), "cpu"))
    _QUOTIENT_CASES[key] = case
    return case


@pytest.mark.parametrize("log_n", [4, 6])
@pytest.mark.parametrize("circuit", CIRCUITS)
def test_quotient_program_matches_jax_quotient_sweep(systems, circuit, log_n):
    _, _, tsys = systems
    k = _quotient_case(systems, circuit, log_n)
    got = prover._quotient_sweep_only(
        tsys, k["c_idx"], log_n, k["q"], k["stored"], prover._selectors_device(tsys, log_n, k["q"]), k["pubs"],
        k["alpha"],
    )
    assert tuple(got.shape) == (k["D"], k["m"])
    np.testing.assert_array_equal(fd.to_np(got)[:, k["brev"]], k["want"])  # storage order -> natural


@pytest.mark.parametrize("n_points", [1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_opening_reductions_match_jax(config, n_points):
    """K12 through `_eval_height` against _eval_kernel, and K13 against
    _ro_kernel, on a (3, 2^6) stored LDE of a 2^4-row trace."""
    jax_cls, torch_cls = CONFIGS[config]
    fri = FriParameters.standard_fast()
    jcfg = jax_cls(JaxCommit(log_blowup=2, cap_height=0), JaxFri(**vars(fri)))
    tcfg = torch_cls(CommitmentParameters(log_blowup=2, cap_height=0), fri, device="cpu")
    hf, he, D = jcfg.host_field, jcfg.host_ext, jcfg.extension_params.degree
    F, E, JF = tcfg.field, tcfg.ext, jcfg.field
    log_n, log_lde, w = 4, 6, 3
    rng = np.random.default_rng(7 + n_points)
    mat = _rand(rng, hf.p, w, 1 << log_lde)
    zs = [tuple(int(c) for c in _rand(rng, hf.p, D)) for _ in range(n_points)]
    jzs = tuple(ext_scalar(jcfg.ext, z) for z in zs)
    tzs = [(k, E.const(z, "cpu")) for k, z in enumerate(zs)]

    want = jcfg.pcs._eval_kernel(JF.from_np(mat), jzs, log_n)
    (got,) = tcfg.pcs._eval_height(log_n, [F.from_np(mat, "cpu")], [list(range(n_points))], tzs)
    assert len(got) == n_points
    for g, v in zip(got, want):
        np.testing.assert_array_equal(fd.to_np(g), np.stack([JF.to_np(c) for c in v]))

    # K13: the same matrix as the second one at its height (offset 5), added to a running sum
    alpha = tuple(int(c) for c in _rand(rng, hf.p, D))
    off, count = 5, 5 + w * n_points
    apow_host = [he.one]
    for _ in range(count - 1):
        apow_host.append(he.mul(apow_host[-1], alpha))
    vals = [_rand(rng, hf.p, D, w) for _ in range(n_points)]
    offs = [off + k * w for k in range(n_points)]
    ap = np.asarray(apow_host[:w], np.uint64)
    want = jcfg.pcs._ro_kernel(
        JF.from_np(mat), tuple(tuple(JF.from_np(v[d]) for d in range(D)) for v in vals), jzs,
        tuple(JF.from_np(ap[:, d]) for d in range(D)),
        tuple(ext_scalar(jcfg.ext, he.neg(apow_host[o])) for o in offs), log_lde,
    )
    x = tcfg.pcs.x_table_storage(log_lde, hf.generator)
    invs = [tcfg.pcs.E.inv(tpcs._ext_minus_base(F, E, z, x)) for _, z in tzs]
    apows = F.from_np(np.asarray(apow_host, np.uint64).T.copy(), "cpu")
    before = _rand(rng, hf.p, D, 1 << log_lde)
    opened = [[(k, o, F.from_np(v, "cpu")) for k, (o, v) in enumerate(zip(offs, vals))]]
    got = tpcs.reduced_open_height(E, [F.from_np(mat, "cpu")], apows, opened, invs, F.from_np(before, "cpu"))
    want_np = np.stack([JF.to_np(c) for c in want])
    np.testing.assert_array_equal(fd.to_np(got), fd.to_np(E.add(F.from_np(before, "cpu"), F.from_np(want_np, "cpu"))))
    got0 = tpcs.reduced_open_height(E, [F.from_np(mat, "cpu")], apows, opened, invs)
    np.testing.assert_array_equal(fd.to_np(got0), want_np)


def test_a_program_beyond_the_register_file_raises_and_names_it():
    """200 products that all stay live (their sum is taken first, their
    product after) need 200 registers: more than K11's largest register
    file.  The error names the program and nothing falls back."""
    from multistark_tpu_torch.fields.device import GL_OPS

    k = 200
    rec = program.Recorder(GL_OPS.p, sources=(0,), publics=False)
    xs = [rec.mul(rec.var(0, i, 0), rec.var(0, i, 1)) for i in range(k)]
    total, prod = xs[0], xs[-1]
    for x in xs[1:]:
        total = rec.add(total, x)
    for x in reversed(xs[:-1]):
        prod = rec.mul(prod, x)
    rec.out(rec.add(total, prod), 0)
    prog = rec.compile("the wide test program")
    assert prog.n_regs > program.REGISTER_FILES[-1]
    ops = program.Operands(sources=[torch.zeros((k, 8), dtype=torch.int64)], rows=8)
    with pytest.raises(program.RegisterFileExceeded, match="the wide test program"):
        program.expr_sweep(GL_OPS, prog, ops, (1, 8), 8, 1)


# --- K11's generator: the compiled program kernels -------------------------------

def _every_opcode_program(p: int) -> program.Program:
    rec = program.Recorder(p)
    x, y = rec.var(1, 0, 0), rec.var(1, 0, 1)  # this row, the next row
    e = rec.add(rec.mul(x, rec.const(5)), rec.sub(y, rec.public(1)))
    e = rec.add(rec.mul(rec.neg(e), rec.selector("first")), rec.apow(2))
    rec.out(e, 0, 0)
    rec.out(rec.mul(e, x), 1, 0)
    return rec.compile("every opcode")


def _stage2(p: int, ext_params, const_arity: int = 2) -> program.Program:
    return tlk.stage2_program(p, ext_params, (const_arity, 1), "stage-2 messages")


def test_the_same_program_gives_the_same_source_and_key():
    ep = ExtensionParams(degree=2, w=7, karatsuba=True)
    a, b = _stage2(fd.GL_OPS.p, ep), _stage2(fd.GL_OPS.p, ep)
    assert a.cuda_source(0) == b.cuda_source(0)
    assert program.host_source(a, 0) == program.host_source(b, 0)
    assert a.cuda_source(0)[0] in a.cuda_source(0)[1]  # the key names the kernel


def test_a_changed_constant_field_or_template_changes_the_key(tmp_path, monkeypatch):
    p = fd.GL_OPS.p

    def prog(c):
        rec = program.Recorder(p, sources=(0,), publics=False)
        rec.out(rec.mul(rec.var(0, 0, 0), rec.const(c)), 0)
        return rec.compile("one product")

    key = program.cuda_source(prog(3), 0)[0]
    assert program.cuda_source(prog(3), 0)[0] == key
    assert program.cuda_source(prog(4), 0)[0] != key
    assert program.cuda_source(prog(3), 1)[0] != key
    template = tmp_path / "expr_sweep.cu"
    template.write_text(open(program.TEMPLATE).read() + "\n// another template\n")
    monkeypatch.setattr(program, "TEMPLATE", str(template))
    assert program.cuda_source(prog(3), 0)[0] != key


def test_the_emitted_body_covers_every_opcode(tmp_path):
    prog = _every_opcode_program(fd.GL_OPS.p)
    assert set(prog.code[:, 0].tolist()) == set(range(10))
    body = program.program_body(prog)
    for macro in ("VAR(1, 0, 0)", "VAR(1, 0, 1)", "PUB(1)", "SEL(0)", "APOW(2)", "0x5ull", "ADD(", "SUB(", "MUL(",
                  "NEG(", "OUT(0, 0, ", "OUT(1, 0, "):
        assert macro in body, macro
    assert body.count("VAR(1, 0, 0)") == 1  # a leaf is loaded once
    for F in (fd.GL_OPS, fd.BB_OPS):
        prog = _every_opcode_program(F.p)
        rng = np.random.default_rng(F.field_id)
        n = 16
        ops = program.Operands(
            sources=[None, F.from_np(_rand(rng, F.p, 1, n), "cpu")], rows=n, step=1,
            selectors=[F.from_np(_rand(rng, F.p, n), "cpu")], pubs=F.from_np(_rand(rng, F.p, 2), "cpu"),
            apows=F.from_np(_rand(rng, F.p, 3), "cpu"),
        )
        want = program.expr_sweep_plain(F, prog, ops, (2, n), n, 1)
        np.testing.assert_array_equal(_run_host(prog, F, ops, (2, n), n, 1, tmp_path), fd.to_np(want))


def _run_host(prog, F, ops, out_shape, plane_stride, row_stride, tmp_path) -> np.ndarray:
    """The program's generated body in the host C template, built with cc
    and run over the operands."""
    src = tmp_path / f"expr_{F.field_id}_{abs(hash(prog.name))}_{len(prog.code)}.c"
    src.write_text(program.host_source(prog, F.field_id))
    lib_path = str(src)[:-2] + ".so"
    subprocess.run(["cc", "-O1", "-shared", "-fPIC", "-o", lib_path, str(src)], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(lib_path)
    keep = []

    def arr(t):
        a = np.ascontiguousarray(fd.to_np(t.reshape(-1)))
        keep.append(a)
        return a.ctypes.data

    srcs = list(ops.sources) + [None] * (program.MAX_SOURCES - len(ops.sources))
    sels = list(ops.selectors) + [None] * (len(program.SELECTORS) - len(ops.selectors))
    bases = (ctypes.c_void_p * program.MAX_SOURCES)(*[None if t is None else arr(t) for t in srcs])
    strides = (ctypes.c_int64 * program.MAX_SOURCES)(*[0 if t is None else t.shape[1] for t in srcs])
    sel_ptrs = (ctypes.c_void_p * len(sels))(*[None if t is None else arr(t) for t in sels])
    out = np.zeros(out_shape, np.uint64)
    fn = lib.expr_sweep_host
    fn.argtypes = program.ENTRY_ARGS
    fn.restype = ctypes.c_int
    rc = fn(ctypes.cast(bases, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p), ops.rows, ops.step,
            ops.brev_log, ctypes.cast(sel_ptrs, ctypes.c_void_p), None if ops.pubs is None else arr(ops.pubs),
            None if ops.apows is None else arr(ops.apows), out.ctypes.data, plane_stride, row_stride)
    assert rc == 0
    return out


def test_the_generated_quotient_code_matches_plain_and_jax(systems, tmp_path):
    """U32Add's quotient program at 2^4 rows, built from the host C template:
    equal to expr_sweep_plain and to JAX prover._quotient_sweep_only."""
    _, _, tsys = systems
    log_n = 4
    k = _quotient_case(systems, "u32_add", log_n)
    F = tsys.config.field
    prog = tsys.quotient_program(k["c_idx"], log_n)
    sels = prover._selectors_device(tsys, log_n, k["q"])
    ops = program.Operands(
        sources=[k["stored"].get(s) for s in range(3)], rows=k["m"], step=k["q"], brev_log=k["log_m"],
        selectors=[sels[name] for name in program.SELECTORS], pubs=k["pubs"].reshape(-1),
        apows=ext_powers_device(tsys.config.ext, k["alpha"], tsys.circuits[k["c_idx"]].constraint_count),
    )
    got = _run_host(prog, F, ops, (k["D"], k["m"]), k["m"], 1, tmp_path)
    np.testing.assert_array_equal(got, fd.to_np(program.expr_sweep_plain(F, prog, ops, (k["D"], k["m"]), k["m"], 1)))
    np.testing.assert_array_equal(got[:, k["brev"]], k["want"])


def test_the_generated_stage2_message_code_matches_plain_and_jax(systems, tmp_path):
    """U32Add's stage-2 message program at 2^4 rows (13 slots per row),
    built from the host C template: equal to expr_sweep_plain and to JAX
    lookup._stage2_msgs on the same lookup values, β and γ."""
    jcfg, _, tsys = systems
    F, E, JF, JE = tsys.config.field, tsys.config.ext, jcfg.field, jcfg.ext
    D, n = E.D, 16
    c_idx = CIRCUITS.index("u32_add")
    arities = tuple(len(a) for _, a in tsys.circuits[c_idx].graph.lookups)
    L, n_out = len(arities), sum(1 + a for a in arities)
    rng = np.random.default_rng(5 + D)
    values = _rand(rng, F.p, n_out, n)
    beta, gamma = (tuple(int(c) for c in _rand(rng, F.p, D)) for _ in range(2))
    prog = tsys.stage2_program(c_idx)
    ops = program.Operands(sources=[F.from_np(values, "cpu")], rows=n,
                           pubs=F.from_np(np.asarray(beta + gamma, np.uint64), "cpu"))
    got = _run_host(prog, F, ops, (D + 1, n * L), n * L, L, tmp_path)
    np.testing.assert_array_equal(got, fd.to_np(program.expr_sweep_plain(F, prog, ops, (D + 1, n * L), n * L, L)))
    starts = np.cumsum([0] + [1 + a for a in arities])[:-1]
    msgs, mults = jax_lk._stage2_msgs(
        JF, JE, [[JF.from_np(values[s + 1 + i]) for i in range(a)] for s, a in zip(starts, arities)],
        [JF.from_np(values[s]) for s in starts], ext_scalar(JE, beta), ext_scalar(JE, gamma),
    )
    np.testing.assert_array_equal(got[:D], JE.to_np(msgs).T)
    np.testing.assert_array_equal(got[D], JF.to_np(mults))
