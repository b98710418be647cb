"""The port's test-only spec helpers against the JAX package's, and the
port's direct logUp evaluation and device stage 2 against them, on the CPU
(mirrors of tests/test_lookup.py:50-75, tests/test_graph.py:98-116 and
tests/test_domains.py:48-63): `lookup.synthesize_lookups` and
`num_publics`, `evaluator.eval_expr`, `domains.TwoAdicCoset.
selectors_on_coset` and the NumPy `lookup.stage_2_traces`, at 2^3-2^6
rows.  Tolerance: exact."""

import numpy as np
import pytest
import torch

from multistark_tpu import expr as jex
from multistark_tpu import lookup as jlk
from multistark_tpu.config import CommitmentParameters as JaxCommit, FriParameters as JaxFri
from multistark_tpu.configs import BabyBearPoseidon2Config as JaxBB, GoldilocksBlake3Config as JaxGL
from multistark_tpu.domains import TwoAdicCoset as JaxCoset
from multistark_tpu.evaluator import HostBaseAlgebra as JaxBaseAlgebra, eval_expr as jax_eval_expr, sweep as jax_sweep
from multistark_tpu.graph import ConstraintGraph as JaxGraph, Interner as JaxInterner
from multistark_tpu.system import CircuitInputs as JaxInputs, System as JaxSystem, SystemWitness as JaxWitness
from multistark_tpu_torch import expr as tex
from multistark_tpu_torch import lookup as tlk
from multistark_tpu_torch import prover
from multistark_tpu_torch.config import CommitmentParameters, FriParameters
from multistark_tpu_torch.configs import BabyBearPoseidon2Config, GoldilocksBlake3Config
from multistark_tpu_torch.domains import TwoAdicCoset
from multistark_tpu_torch.evaluator import eval_expr, sweep
from multistark_tpu_torch.fields.device import FieldOps
from multistark_tpu_torch.fields.host import BABYBEAR, BABYBEAR_EXT4, GOLDILOCKS, GOLDILOCKS_EXT2, ExtensionParams
from multistark_tpu_torch.fields.npref import reverse_bits_vec
from multistark_tpu_torch.graph import ConstraintGraph, Interner
from multistark_tpu_torch.system import CircuitInputs, System, SystemWitness

FIELDS = {
    "goldilocks": (GOLDILOCKS, GOLDILOCKS_EXT2, ExtensionParams(degree=2, w=7, karatsuba=True)),
    "babybear": (BABYBEAR, BABYBEAR_EXT4, ExtensionParams(degree=4, w=11, karatsuba=False)),
}
CONFIGS = {"goldilocks": (JaxGL, GoldilocksBlake3Config), "babybear": (JaxBB, BabyBearPoseidon2Config)}
SMALL_FRI = dict(log_final_poly_len=0, max_log_arity=1, num_queries=2, commit_proof_of_work_bits=0,
                 query_proof_of_work_bits=0)


class _BaseAlgebra:
    """Scalar evaluation over the base field on host ints (the JAX
    package's HostBaseAlgebra, for the port's sweep and direct evaluation)."""

    def __init__(self, hf, var_fn, publics, selectors):
        self.hf, self._var, self._publics, self._sel = hf, var_fn, publics, selectors

    def const(self, v):
        return v % self.hf.p

    def var(self, source, column, offset):
        return self._var(source, column, offset)

    def public(self, index):
        return self._publics[index]

    def first(self):
        return self._sel["first"]

    def last(self):
        return self._sel["last"]

    def transition(self):
        return self._sel["transition"]

    def add(self, a, b):
        return self.hf.add(a, b)

    def sub(self, a, b):
        return self.hf.sub(a, b)

    def mul(self, a, b):
        return self.hf.mul(a, b)

    def neg(self, a):
        return self.hf.neg(a)


def _env(hf, D, seed):
    """A random environment: trace cells on demand, 4·D publics, selectors."""
    rng = np.random.default_rng(seed)
    vals = {}

    def rand():
        return int(rng.integers(0, hf.p, dtype=np.uint64))

    def var_fn(src, col, off):
        return vals.setdefault((src, col, off), rand())

    publics = [rand() for _ in range(4 * D)]
    return var_fn, publics, {"first": rand(), "last": rand(), "transition": rand()}


def _lookups(ex, which):
    """tests/test_lookup.py's two lookups (main columns only), one of them, or none."""
    both = [
        ex.Lookup.pull(ex.main(0), [ex.Const(7), ex.main(1), ex.main(2) * ex.main(3)]),
        ex.Lookup.push(ex.main(3) + 1, [ex.Const(3), ex.main_next(1)]),
    ]
    return {"two": both, "one": both[:1], "none": []}[which]


def _eval_ext(e, he, ev):
    """An ExtExpr tree evaluated recursively in the extension field, its
    base leaves by `ev` (the package's eval_expr); dispatch by class name,
    so one walk serves both packages' trees."""
    kind = type(e).__name__
    if kind == "ExtBase":
        return he.from_base(ev(e.arg))
    if kind == "ExtCoords":
        return tuple(ev(c) for c in e.coords)
    if kind == "ExtNeg":
        return he.neg(_eval_ext(e.arg, he, ev))
    a, b = _eval_ext(e.lhs, he, ev), _eval_ext(e.rhs, he, ev)
    return {"ExtAdd": he.add, "ExtSub": he.sub, "ExtMul": he.mul}[kind](a, b)


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("which, log_n", [("two", 3), ("one", 4), ("none", 5), ("two", 6)])
def test_direct_logup_equals_synthesized_spec(field, which, log_n):
    """The port's logup_constraint_values == its synthesize_lookups compiled
    and swept == the same ExtExprs evaluated recursively through eval_expr
    == the JAX synthesize_lookups swept and evaluated through the JAX
    eval_expr, on one random environment."""
    hf, he, ep = FIELDS[field]
    D = ep.degree
    assert tlk.num_publics(D) == jlk.num_publics(D) == 4 * D
    var_fn, publics, sel = _env(hf, D, 21 + log_n)
    alg = _BaseAlgebra(hf, var_fn, publics, sel)
    lookups = _lookups(tex, which)

    specs = tlk.synthesize_lookups(lookups, ep, hf, log_n)
    it = Interner(hf.p)
    roots = [it.intern_ext(c, ep) for c in specs]
    buf = sweep(ConstraintGraph(hf.p, it.nodes, it.degrees, [], [], 0), alg)
    swept = [tuple(buf[i] for i in coords) for coords in roots]

    def ev(e):
        return eval_expr(e, hf, var_fn, publics, sel)

    recursive = [_eval_ext(c, he, ev) for c in specs]
    lookup_vals = [(ev(lk.multiplicity), tuple(ev(a) for a in lk.args)) for lk in lookups]
    pubs = tuple(tuple(publics[k * D : (k + 1) * D]) for k in range(4))
    def stage2(col, off):
        return var_fn(tex.Source.STAGE2.value, col, off)

    direct = tlk.logup_constraint_values(alg, ep, hf, len(lookups), stage2, lookup_vals, sel["last"], pubs, log_n)
    assert [tuple(d) for d in direct] == swept == recursive
    assert len(swept) == max(len(lookups), 1)

    jspecs = jlk.synthesize_lookups(_lookups(jex, which), ep, hf, log_n)
    jit = JaxInterner(hf.p)
    jroots = [jit.intern_ext(c, ep) for c in jspecs]
    jbuf = jax_sweep(JaxGraph(hf.p, jit.nodes, jit.degrees, [], [], 0), JaxBaseAlgebra(hf, var_fn, publics, sel))
    assert [tuple(jbuf[i] for i in coords) for coords in jroots] == swept
    assert [_eval_ext(c, he, lambda e: jax_eval_expr(e, hf, var_fn, publics, sel)) for c in jspecs] == swept


def _random_tree(rng, depth, pair):
    """The same random expression tree in both packages: (port, JAX)."""
    ex_t, ex_j = pair
    if depth == 0 or rng.random() < 0.2:
        kind = int(rng.integers(0, 6))
        if kind == 0:
            v = int(rng.integers(0, 1 << 62))
            return ex_t.Const(v), ex_j.Const(v)
        if kind == 1:
            i = int(rng.integers(0, 8))
            return ex_t.public(i), ex_j.public(i)
        if kind == 2:
            col, nxt = int(rng.integers(0, 4)), bool(rng.integers(0, 2))
            return (ex_t.main_next(col), ex_j.main_next(col)) if nxt else (ex_t.main(col), ex_j.main(col))
        if kind == 3:
            col = int(rng.integers(0, 3))
            return ex_t.preprocessed(col), ex_j.preprocessed(col)
        sel = ["IsFirstRow", "IsLastRow", "IsTransition"][int(rng.integers(0, 3))]
        return getattr(ex_t, sel)(), getattr(ex_j, sel)()
    op = int(rng.integers(0, 4))
    a_t, a_j = _random_tree(rng, depth - 1, pair)
    if op == 3:
        return -a_t, -a_j
    b_t, b_j = _random_tree(rng, depth - 1, pair)
    return [(a_t + b_t, a_j + b_j), (a_t - b_t, a_j - b_j), (a_t * b_t, a_j * b_j)][op]


@pytest.mark.parametrize("seed", range(6))
def test_eval_expr_matches_jax_on_random_trees(seed):
    """eval_expr against the JAX eval_expr on seeded random trees of every
    node kind (constants up to 2^62, publics, main, next-row and
    preprocessed cells, the three selectors, +, -, ·, negation), and
    against the port's sweep of the same constraints."""
    hf = GOLDILOCKS if seed % 2 == 0 else BABYBEAR
    rng = np.random.default_rng(900 + seed)
    trees = [_random_tree(rng, 5, (tex, jex)) for _ in range(8)]
    var_fn, publics, sel = _env(hf, 2, seed)
    got = [eval_expr(t, hf, var_fn, publics, sel) for t, _ in trees]
    assert got == [jax_eval_expr(j, hf, var_fn, publics, sel) for _, j in trees]
    it = Interner(hf.p)
    roots = [it.intern(t, allow_stage2=False) for t, _ in trees]
    buf = sweep(ConstraintGraph(hf.p, it.nodes, it.degrees, [], [], 0), _BaseAlgebra(hf, var_fn, publics, sel))
    assert [buf[r] for r in roots] == got


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("log_n, q", [(3, 1), (3, 2), (4, 4), (6, 2)])
def test_selectors_on_coset_match_jax_and_device(field, log_n, q):
    """selectors_on_coset on the quotient coset against the JAX one, and
    against prover._selectors_device (on CPU tensors, storage order: bit
    reversed), which the prover takes."""
    hf = FIELDS[field][0]
    dom = TwoAdicCoset(hf, log_n, 1)
    qdom = dom.create_disjoint_domain((1 << log_n) * q)
    got = dom.selectors_on_coset(qdom)
    assert dom.selectors_on_coset(qdom) is got  # cached
    want = JaxCoset(hf, log_n, 1).selectors_on_coset(JaxCoset(hf, qdom.log_n, qdom.shift))
    names = ("is_first_row", "is_last_row", "is_transition", "inv_vanishing")
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    config = CONFIGS[field][1](CommitmentParameters(log_blowup=1), FriParameters(**SMALL_FRI), device="cpu")
    system, _ = System.new(config, [CircuitInputs(main_width=2, constraints=[tex.main(0) * tex.main(1)],
                                                  ext_constraints=[], lookups=[])])
    dev = prover._selectors_device(system, log_n, q)
    natural = reverse_bits_vec(np.arange(1 << qdom.log_n), qdom.log_n).astype(np.int64)
    for name, key in zip(names, ("first", "last", "transition", "inv_vanishing")):
        np.testing.assert_array_equal(FieldOps.to_np(dev[key])[natural], getattr(got, name))


def _stage2_systems(field):
    """The same two-circuit system in both packages: tests/test_lookup.py's two
    lookups at 2^4 rows, then a circuit without lookups at 2^3 rows (the
    pass-through); returns (JAX config, its witness, port config, its
    witness)."""
    jcls, tcls = CONFIGS[field]
    hf = FIELDS[field][0]
    rng = np.random.default_rng(77)
    traces = [rng.integers(0, hf.p, (16, 4), dtype=np.uint64), rng.integers(0, hf.p, (8, 2), dtype=np.uint64)]
    out = []
    for ex, Inputs, Sys, Wit, cfg in (
        (jex, JaxInputs, JaxSystem, JaxWitness, jcls(JaxCommit(log_blowup=1), JaxFri(**SMALL_FRI))),
        (tex, CircuitInputs, System, SystemWitness,
         tcls(CommitmentParameters(log_blowup=1), FriParameters(**SMALL_FRI), device="cpu")),
    ):
        inputs = [Inputs(main_width=4, constraints=[], ext_constraints=[], lookups=_lookups(ex, "two")),
                  Inputs(main_width=2, constraints=[ex.main(0) * ex.main(1)], ext_constraints=[], lookups=[])]
        system, key = Sys.new(cfg, inputs)
        out += [cfg, Wit.from_stage_1(traces, system, key)]
    return out


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_stage_2_traces_matches_jax_and_device(field):
    """The NumPy stage_2_traces against the JAX stage_2_traces and the port's
    stage_2_traces_device on CPU tensors: every stage-2 matrix and the
    accumulator after each circuit, threaded through the pass-through
    circuit."""
    hf, he, _ = FIELDS[field]
    jcfg, jwit, tcfg, twit = _stage2_systems(field)
    rng = np.random.default_rng(5)
    beta, gamma, acc0 = (tuple(int(v) for v in rng.integers(0, hf.p, he.D, dtype=np.uint64)) for _ in range(3))
    mats, accs = tlk.stage_2_traces(hf, he, twit.lookup_values, beta, gamma, acc0)
    assert [m.shape for m in mats] == [(2 * he.D, 16), (he.D, 8)]
    assert accs[1] == accs[0] != acc0

    jmats, jaccs = jlk.stage_2_traces(jcfg.field, jcfg.ext, hf, he, jwit.lookup_values, beta, gamma, acc0)
    assert [tuple(a) for a in jaccs] == accs
    for m, jm in zip(mats, jmats):
        np.testing.assert_array_equal(m, np.asarray(jcfg.field.to_np(jm), np.uint64).reshape(m.shape))

    E = tcfg.ext
    dmats, daccs = tlk.stage_2_traces_device(E, twit.lookup_values, *(E.const(v, "cpu") for v in (beta, gamma, acc0)))
    assert [tuple(int(c) for c in FieldOps.to_np(a)) for a in daccs] == accs
    for m, dm in zip(mats, dmats):
        assert isinstance(dm, torch.Tensor)
        np.testing.assert_array_equal(FieldOps.to_np(dm), m)
