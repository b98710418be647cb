"""The per-row constraint programs and the opening reductions on the CPU
against the JAX package, exact (tolerance zero: everything is mod p):

  - each circuit's quotient program, run by kernel K11's plain version
    (program.expr_sweep_plain), equals JAX prover._quotient_sweep_only on
    the same stored LDEs, publics and α, for U32Add, ByteTable and a MulAir,
    at 2^4 and 2^6 rows, under GoldilocksBlake3 and BabyBearPoseidon2;
  - K12's and K13's plain versions (pcs.bary_eval_plain through
    `_eval_matrix`, pcs.reduced_open_plain) equal JAX pcs._eval_kernel and
    _ro_kernel for one and two points under both fields;
  - a program whose live set exceeds K11's register file raises
    RegisterFileExceeded, which names the program, on the plain path too.

The lookup-values and stage-2 message programs are held against the JAX
package by test_torch_system.py (`test_lookup_values_are_equal`,
`test_stage_2_traces_and_accumulators_are_equal`) and every proof-bytes
test.  The systems are built without their preprocessed commitment (the
quotient sweep reads the preprocessed LDE it is given), once per module."""

import dataclasses

import numpy as np
import pytest
import torch

from multistark_tpu import expr as jex
from multistark_tpu import prover as jax_prover
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.domains import TwoAdicCoset as JaxCoset
from multistark_tpu.system import CircuitInputs as JaxCircuitInputs, System as JaxSystem
from multistark_tpu.test_circuits import u32_add_system_inputs as jax_u32_inputs
from multistark_tpu.utils import ext_scalar
from multistark_tpu_torch import expr as tex, pcs as tpcs, program, prover
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.fields import device as fd
from multistark_tpu_torch.system import CircuitInputs, System
from multistark_tpu_torch.test_circuits import u32_add_system_inputs
from multistark_tpu_torch.utils import bit_reverse_indices

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


@pytest.mark.parametrize("log_n", [4, 6])
@pytest.mark.parametrize("circuit", CIRCUITS)
def test_quotient_program_matches_jax_quotient_sweep(systems, circuit, log_n):
    jcfg, jsys, tsys = systems
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
    got = prover._quotient_sweep_only(
        tsys, c_idx, log_n, q, stored, prover._selectors_device(tsys, log_n, q),
        F.from_np(np.asarray(pubs, np.uint64), "cpu"), F.from_np(np.asarray(alpha, np.uint64), "cpu"),
    )
    assert tuple(got.shape) == (D, m)
    np.testing.assert_array_equal(fd.to_np(got)[:, brev], JF.to_np(want))  # storage order -> natural


@pytest.mark.parametrize("n_points", [1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_opening_reductions_match_jax(config, n_points):
    """K12 through `_eval_matrix` against _eval_kernel, and K13 against
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
    got = tcfg.pcs._eval_matrix(F.from_np(mat, "cpu"), log_n, tzs, {})
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
    got = tpcs.reduced_open(E, F.from_np(mat, "cpu"), apows, [F.from_np(v, "cpu") for v in vals], invs, offs,
                            F.from_np(before, "cpu"))
    want_np = np.stack([JF.to_np(c) for c in want])
    np.testing.assert_array_equal(fd.to_np(got), fd.to_np(E.add(F.from_np(before, "cpu"), F.from_np(want_np, "cpu"))))
    got0 = tpcs.reduced_open(E, F.from_np(mat, "cpu"), apows, [F.from_np(v, "cpu") for v in vals], invs, offs)
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
