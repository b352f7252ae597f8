"""The rest of petsc_tpu_torch's core surface against petsc_tpu's on the same
inputs (numpy arrays from a seed): Vec's arithmetic, reductions, values,
random draw, sub-vectors and strides; Mat's multAdd, block size and
(near-)nullspace; KSP.setPC and matSolve; PC jacobi variants, pbjacobi,
shell and setCoordinates; the options database; the profiler's stages,
events, nested views and -info; the -log_view formats; comm_world and the
converged-reason enums.

Tolerances: elementwise results equal, or within 1e-15 relative where two
roundings meet; reductions 1e-12 relative; setRandom bit for bit in
float64 and float32; the flamegraph and XML texts equal; solves the
reference's iteration counts and reasons, histories to 1e-6 relative.
"""

import io

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu import config as cfg_jax
from petsc_tpu.mat.mat import MatStructure as MatStructureJax
from petsc_tpu.sys import logging as logging_jax
from petsc_tpu.sys.options import Options as OptionsJax
from petsc_tpu_torch import config as cfg_port
from petsc_tpu_torch.ops import stencil_build
from petsc_tpu_torch.sys import logging as logging_port
from petsc_tpu_torch.sys.options import Options

torch.set_num_threads(1)

N = 1000
ELEM_RTOL = 1e-15
RED_RTOL = 1e-12
HIST_RTOL = 1e-6
PKGS = {"jax": pt_jax, "port": ptt}


def _init(pkg, args=()):
    if pkg is ptt:
        ptt.init(args=list(args), device="cpu")
    else:
        pt_jax.init(args=list(args))
        # the reference keeps an earlier -real_dtype (ROADMAP §3): reset it
        cfg_jax.set_real_dtype(cfg_jax.state().options.get_string("real_dtype",
                                                                   default="f64"))


@pytest.fixture(autouse=True)
def _both_float64():
    yield
    cfg_jax.set_real_dtype("f64")
    ptt.init(device="cpu")


@pytest.fixture(autouse=True)
def fresh_logs(monkeypatch):
    """A new Profiler in each package's state for each test, its total time
    fixed at 1 s so that the texts do not depend on the host's clock. The
    packages' own profilers are left as they were: the reference's tests
    that run later in the same process read its global profiler."""
    logs = {}
    for name, cfg, mod in (("jax", cfg_jax, logging_jax), ("port", cfg_port, logging_port)):
        prof = mod.Profiler()
        monkeypatch.setattr(prof, "total_time", lambda: 1.0)
        monkeypatch.setattr(cfg.state(), "log", prof)
        logs[name] = prof
    return logs


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N)
    x[::17] = 0.0                      # zeros for reciprocal, log, divide
    y = rng.standard_normal(N)
    y[::23] = 0.0
    z = rng.standard_normal(N)
    return x, y, z


def _arr(v):
    return np.asarray(v.getArray())[: v.getSize()]


def _run_both(fn, seed=0, args=()):
    """fn(pkg, x, y, z) on fresh Vecs of both packages; returns (jax, port)."""
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg, args)
        vecs = [pkg.Vec.from_array(a) for a in _inputs(seed)]
        out[name] = fn(pkg, *vecs)
    return out["jax"], out["port"]


# ---------------- Vec: elementwise ----------------

IDX = [3, 1, 4, 1, 5, 9, 2, 6]

ELEMENTWISE = {
    "axpby": lambda pkg, x, y, z: y.axpby(2.5, -0.75, x),
    "axpbypcz": lambda pkg, x, y, z: z.axpbypcz(2.0, 3.0, 0.5, x, y),
    "maxpy": lambda pkg, x, y, z: z.maxpy([0.3, -1.7, 2.1], [x, y, x]),
    "shift": lambda pkg, x, y, z: x.shift(-0.25),
    "abs": lambda pkg, x, y, z: x.abs(),
    "sqrtabs": lambda pkg, x, y, z: x.sqrtabs(),
    "exp": lambda pkg, x, y, z: x.exp(),
    "log": lambda pkg, x, y, z: x.log(),
    "reciprocal": lambda pkg, x, y, z: x.reciprocal(),
    "pointwiseMult": lambda pkg, x, y, z: z.pointwiseMult(x, y),
    "pointwiseDivide": lambda pkg, x, y, z: z.pointwiseDivide(x, z),
    "pointwiseMax": lambda pkg, x, y, z: z.pointwiseMax(x, y),
    "pointwiseMin": lambda pkg, x, y, z: z.pointwiseMin(x, y),
    "setValues_insert": lambda pkg, x, y, z: (
        x.setValues([3, 7, 11], [10.0, 20.0, 30.0]), x.assemblyBegin(), x.assemblyEnd(), x)[-1],
    "setValues_add": lambda pkg, x, y, z: (
        x.setValues(IDX, np.arange(8.0), pkg.InsertMode.ADD_VALUES), x)[-1],
    "setValue": lambda pkg, x, y, z: (
        x.setValue(5, 2.5, pkg.InsertMode.ADD_VALUES), x.setValue(6, -1.5), x)[-1],
    "zeroEntries": lambda pkg, x, y, z: x.zeroEntries(),
    "strideGather": lambda pkg, x, y, z: x.strideGather(1, bs=4),
    "strideScatter": lambda pkg, x, y, z: x.strideScatter(2, y.strideGather(0, bs=4), bs=4),
}


@pytest.mark.parametrize("op", sorted(ELEMENTWISE))
def test_elementwise_matches_jax(op):
    vj, vp = _run_both(lambda pkg, x, y, z: _arr(ELEMENTWISE[op](pkg, x, y, z)))
    np.testing.assert_allclose(vp, vj, rtol=ELEM_RTOL, atol=0)


def test_swap_and_sub_vectors_borrow_until_restore():
    def run(pkg, x, y, z):
        x.swap(y)
        idx = np.array([2, 40, 7, 999])
        sub = x.getSubVector(idx)
        sub.scale(3.0)
        before = _arr(x).copy()          # unchanged until the restore
        x.restoreSubVector(idx, sub)
        return _arr(x), _arr(y), before

    (xj, yj, bj), (xp, yp, bp) = _run_both(run)
    for a, b in ((xp, xj), (yp, yj), (bp, bj)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(bj, xj)


def test_sub_vector_takes_an_object_with_indices():
    class IS:
        indices = np.array([5, 1, 3])

    (aj, bj) = _run_both(lambda pkg, x, y, z: _arr(x.getSubVector(IS())))
    np.testing.assert_array_equal(bj, aj)


# ---------------- Vec: reductions ----------------

REDUCTIONS = {
    "sum": lambda pkg, x, y, z: x.sum(),
    "mean": lambda pkg, x, y, z: x.mean(),
    "max": lambda pkg, x, y, z: x.max(),
    "min": lambda pkg, x, y, z: x.min(),
    "normalize": lambda pkg, x, y, z: (x.normalize(), *_arr(x)[:50]),
    "tDot": lambda pkg, x, y, z: x.tDot(y),
    "maxPointwiseDivide": lambda pkg, x, y, z: x.maxPointwiseDivide(y),
    "strideNorm": lambda pkg, x, y, z: (x.strideNorm(1, bs=4),
                                        x.strideNorm(3, pkg.NormType.NORM_1, bs=4)),
    "split_phase": lambda pkg, x, y, z: tuple(
        (x.dotBegin(y), x.normBegin(), x.dotEnd(y))[-1]),
    "norm_types": lambda pkg, x, y, z: (x.norm(pkg.NormType.NORM_1),
                                        x.norm(pkg.NormType.NORM_INFINITY),
                                        *x.norm(pkg.NormType.NORM_1_AND_2)),
}


@pytest.mark.parametrize("op", sorted(REDUCTIONS))
def test_reductions_match_jax(op):
    rj, rp = _run_both(lambda pkg, x, y, z: REDUCTIONS[op](pkg, x, y, z))
    np.testing.assert_allclose(np.atleast_1d(rp), np.atleast_1d(rj), rtol=RED_RTOL, atol=0)


@pytest.mark.parametrize("pkg", PKGS.values(), ids=PKGS.keys())
def test_max_min_take_the_first_index_on_ties(pkg):
    _init(pkg)
    v = pkg.Vec.from_array(np.array([3.0, 7.0, -2.0, 7.0, -2.0, 1.0]))
    assert v.max() == (1, 7.0) and v.min() == (2, -2.0)


def test_equal_is_exact():
    def run(pkg, x, y, z):
        w = x.duplicate()
        w.setArray(_arr(x))
        same = x.equal(w)
        w.setValue(1, float(np.nextafter(_arr(x)[1], 1.0)))  # one ulp
        return same, x.equal(w), x.equal(y)

    rj, rp = _run_both(run)
    assert rp == rj == (True, False, False)


def test_equal_is_exact_where_xla_flushes_denormals():
    """A reference fault (ROADMAP §3): XLA on the CPU flushes denormals, so
    the reference finds 0 and the smallest denormal equal."""
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        a, b = pkg.Vec.from_array(np.zeros(3)), pkg.Vec.from_array(np.array([0.0, 5e-324, 0.0]))
        out[name] = a.equal(b)
    assert out == {"jax": True, "port": False}


# ---------------- Vec: random, the rest ----------------

@pytest.mark.parametrize("dtype,bits", [("f64", np.uint64), ("f32", np.uint32)])
def test_set_random_equals_jax_bit_for_bit(dtype, bits):
    def run(pkg, x, y, z):
        v = pkg.Vec().setSizes(N).setUp()
        v.setRandom()
        return _arr(v)

    aj, ap = _run_both(run, args=["-real_dtype", dtype])
    assert ap.dtype == aj.dtype == (np.float64 if dtype == "f64" else np.float32)
    np.testing.assert_array_equal(ap.view(bits), aj.view(bits))


def test_set_random_takes_an_interval():
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        v = pkg.Vec().setSizes(N).setUp()
        v.setRandom(interval=(-2.0, 3.0))
        out[name] = _arr(v)
    # u (hi - lo) + lo: XLA fuses the multiply and the add, the port rounds
    # twice, so an entry may differ by one ulp of the interval's scale (3)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=3.0 * np.finfo(float).eps)
    assert out["port"].min() >= -2.0 and out["port"].max() < 3.0


def test_vec_type_block_size_and_view(capsys):
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        v = pkg.Vec().setSizes(6, bs=2).setType("standard").setFromOptions().setUp()
        v.setArray(np.array([1.0, -2.5, 3.0, 0.0, 1e-3, 7.0]))
        capsys.readouterr()
        v.view()
        out[name] = (v.getBlockSize(), capsys.readouterr().out)
    assert out["port"] == out["jax"]


# the reference's own Vec contract (tests/test_vec.py), through both packages

@pytest.mark.parametrize("pkg", PKGS.values(), ids=PKGS.keys())
def test_vec_contract_of_the_reference(pkg):
    _init(pkg)
    x = pkg.Vec.from_array(np.array([1.0, 2.0, 4.0]))
    y = pkg.Vec.from_array(np.array([2.0, 2.0, 2.0]))
    w = x.duplicate()
    w.pointwiseMult(x, y)
    np.testing.assert_allclose(_arr(w), [2, 4, 8])
    w.pointwiseDivide(x, y)
    np.testing.assert_allclose(_arr(w), [0.5, 1, 2])
    x.reciprocal()
    np.testing.assert_allclose(_arr(x), [1, 0.5, 0.25])
    z = pkg.Vec.from_array(np.array([2.0, 0.0, 4.0]))
    z.reciprocal()
    np.testing.assert_allclose(_arr(z), [0.5, 0.0, 0.25])
    v = pkg.Vec().setSizes(6).setUp()
    v.setValues([1, 3], [10.0, 30.0])
    v.setValues([1], [5.0], pkg.InsertMode.ADD_VALUES)
    assert _arr(v)[1] == 15.0 and _arr(v)[3] == 30.0
    m = pkg.Vec.from_array(np.array([3.0, -7.0, 5.0]))
    assert m.max() == (2, 5.0) and m.min() == (1, -7.0)
    a = pkg.Vec.from_array(np.array([1.0, 2.0, 3.0, 4.0]))
    b = pkg.Vec.from_array(np.array([4.0, 3.0, 2.0, 1.0]))
    z = pkg.Vec.from_array(np.ones(4))
    z.axpbypcz(2.0, 3.0, 0.5, a, b)
    np.testing.assert_allclose(_arr(z), 2 * np.arange(1, 5) + 3 * np.arange(4, 0, -1) + 0.5)
    d, n2 = a.dotNorm2(b)
    assert np.isclose(d, 20.0) and np.isclose(n2, 30.0)
    sub = a.getSubVector([1, 3])
    sub.scale(10.0)
    a.restoreSubVector([1, 3], sub)
    np.testing.assert_allclose(_arr(a), [1, 20, 3, 40])
    s = pkg.Vec.from_array(np.array([1.0, 10.0, 2.0, 20.0, 3.0, 30.0]))
    g = s.strideGather(1, bs=2)
    np.testing.assert_allclose(_arr(g), [10, 20, 30])
    g.scale(0.1)
    s.strideScatter(1, g, bs=2)
    np.testing.assert_allclose(_arr(s), [1, 1, 2, 2, 3, 3])
    assert np.isclose(s.strideNorm(0, bs=2), np.sqrt(14.0))


# ---------------- Mat ----------------

def _box27(n):
    return stencil_build.poisson3d_27pt(n)


def test_mat_surface_matches_jax():
    A_sp = _box27(6)
    rng = np.random.default_rng(4)
    xs, vs = rng.standard_normal(216), rng.standard_normal(216)
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        x, v = pkg.Vec.from_array(xs), pkg.Vec.from_array(vs)
        y = A.createVecLeft()
        A.multAdd(x, v, y)
        A.setBlockSize(1)
        out[name] = (_arr(y), A.isAssembled(), A.getBlockSize())
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=RED_RTOL, atol=1e-13)
    assert out["port"][1:] == out["jax"][1:] == (True, 1)
    assert {m.name: m.value for m in ptt.MatStructure} == \
        {m.name: m.value for m in MatStructureJax}
    ptt.init(device="cpu")
    stencil = stencil_build.as_mat(*stencil_build.build_dnd((4,) * 3, kind="box"))
    assert stencil.isAssembled() and not ptt.MatAIJ().isAssembled()
    # block sizes above 1: a Mat without a host CSR only records it,
    # as the reference's does
    assert stencil.setBlockSize(2).getBlockSize() == 2


def _gamg_solve(pkg, A_sp, near=None):
    _init(pkg, ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"])
    A = pkg.MatAIJ.from_scipy(A_sp)
    A.setNullSpace(None)
    if near is not None:
        A.setNearNullSpace(near)
        assert A.getNearNullSpace() is near
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp.getIterationNumber(), ksp.getConvergedReason().name, \
        ksp.getConvergenceHistory()


def test_a_one_vector_near_nullspace_reaches_gamg_as_in_jax():
    n = 12
    A_sp = _box27(n)
    i = np.arange(n ** 3)
    near = (1.0 + 0.5 * np.sin(0.3 * (i % n)) + 0.01 * (i // (n * n))).reshape(-1, 1)
    ij, rj, hj = _gamg_solve(pt_jax, A_sp, near)
    ip, rp, hp = _gamg_solve(ptt, A_sp, near)
    assert (ip, rp) == (ij, rj)
    np.testing.assert_allclose(hp, hj, rtol=HIST_RTOL, atol=0)
    # the constant one takes another hierarchy: the vector was used
    ic, _, hc = _gamg_solve(ptt, A_sp)
    assert ic != ip or not np.allclose(hc, hp, rtol=1e-3)


# ---------------- KSP ----------------

def test_mat_solve_matches_jax_column_by_column():
    A_sp = _box27(8)
    rng = np.random.default_rng(5)
    B = A_sp @ rng.random((512, 3))
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setType("cg")
        pc = pkg.PC().create()
        pc.setOperators(A)
        pc.setType("jacobi")
        ksp.setPC(pc)
        assert ksp.getPC() is pc
        ksp.setTolerances(rtol=1e-10, max_it=500)
        X = ksp.matSolve(B)
        X = X.getDenseArray() if hasattr(X, "getDenseArray") else X
        its = [None] * 3
        for j in range(3):       # each column alone, from zero
            b, x = pkg.Vec.from_array(B[:, j]), A.createVecRight()
            ksp.solve(b, x)
            its[j] = ksp.getIterationNumber()
        ksp.matSolve(B)
        out[name] = (np.asarray(X), ksp.getIterationNumber(), ksp.getConvergedReason().name, its)
    (Xj, ij, rj, cj), (Xp, ip, rp, cp) = out["jax"], out["port"]
    assert (ip, rp, cp) == (ij, rj, cj) and ip == max(cp)
    np.testing.assert_allclose(Xp, Xj, rtol=0, atol=1e-10 * np.abs(Xj).max())


# ---------------- PC ----------------

def _pc_solve(pkg, A_sp, args, configure=None):
    _init(pkg, ["-ksp_type", "cg", "-ksp_rtol", "1e-8", "-ksp_max_it", "3000", *args])
    A = pkg.MatAIJ.from_scipy(A_sp)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    if configure is not None:
        configure(pkg, ksp.getPC(), A_sp)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return (ksp.getIterationNumber(), ksp.getConvergedReason().name,
            ksp.getConvergenceHistory(), _arr(x))


def _assert_same(pj, pp):
    assert pp[:2] == pj[:2]
    np.testing.assert_allclose(pp[2], pj[2], rtol=HIST_RTOL, atol=0)
    np.testing.assert_allclose(pp[3], pj[3], rtol=0, atol=1e-7 * np.abs(pj[3]).max())


@pytest.mark.parametrize("bs", (1, 2, 4))
def test_pbjacobi_matches_jax(bs):
    A_sp = _box27(16)
    args = ["-pc_type", "pbjacobi", "-pc_pbjacobi_block_size", str(bs)]
    pj, pp = _pc_solve(pt_jax, A_sp, args), _pc_solve(ptt, A_sp, args)
    _assert_same(pj, pp)
    if bs == 1:       # the 1 x 1 blocks are Jacobi's diagonal
        _assert_same(_pc_solve(ptt, A_sp, ["-pc_type", "jacobi"]), pp)


def _shell_jacobi(pkg, pc, A_sp):
    inv = 1.0 / A_sp.diagonal()
    inv = torch.as_tensor(inv) if pkg is ptt else pt_jax.Vec.from_array(inv).array
    pc.setShellApply(lambda x: inv * x)


def test_shell_pc_doing_jacobi_matches_jax():
    A_sp = _box27(16)
    pj = _pc_solve(pt_jax, A_sp, [], _shell_jacobi)
    pp = _pc_solve(ptt, A_sp, [], _shell_jacobi)
    _assert_same(pj, pp)
    assert pp[0] == 24           # CG+Jacobi's count on box27 16^3
    _assert_same(_pc_solve(ptt, A_sp, ["-pc_type", "jacobi"]), pp)


def test_shell_pc_threads_its_context():
    A_sp = _box27(8)
    ctx = {"inv": torch.as_tensor(1.0 / A_sp.diagonal())}
    pp = _pc_solve(ptt, A_sp, [], lambda pkg, pc, A: pc.setShellApply(
        lambda c, x: c["inv"] * x, context=ctx))
    _assert_same(_pc_solve(ptt, A_sp, ["-pc_type", "jacobi"]), pp)
    ptt.init(device="cpu")
    with pytest.raises(ptt.Error, match="setShellApply"):
        ptt.PC().setType("shell").setUp()


@pytest.mark.parametrize("variant", ("rowmax", "rowsum", "rowl1"))
@pytest.mark.parametrize("use_abs", (False, True))
def test_jacobi_variants_match_jax(variant, use_abs):
    rng = np.random.default_rng(6)
    A_sp = _box27(10).tolil()
    A_sp.setdiag(A_sp.diagonal() * (2.0 + rng.random(1000)))   # unequal rows, rowsum > 0
    A_sp = A_sp.tocsr()
    args = ["-pc_type", "jacobi", "-pc_jacobi_type", variant] + \
        (["-pc_jacobi_abs"] if use_abs else [])
    _assert_same(_pc_solve(pt_jax, A_sp, args), _pc_solve(ptt, A_sp, args))


def test_set_coordinates_keeps_float64_host_coordinates():
    ptt.init(device="cpu")
    pc = ptt.PC().create()
    xy = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert pc.setCoordinates(xy) is pc
    assert pc._coords.dtype == np.float64 and np.array_equal(pc._coords, xy)


# ---------------- options ----------------

YAML = """# a comment
ksp_type: cg
mg_levels:
  ksp_type: chebyshev
  pc:
    type: jacobi
pc_type: mg
"""


def test_options_surface_matches_jax(tmp_path, capsys):
    path = tmp_path / "opts.yaml"
    path.write_text(YAML)
    out = {}
    for name, db in (("jax", OptionsJax()), ("port", Options())):
        db.insert_args(["-ksp_rtol", "1e-9", "-sub_pc_type", "ilu", "-flag"])
        db.insert_yaml(str(path))
        db.delete_value("-flag")
        db.register_help("my_opt", "an option the program registered")
        got = [db.get_string("ksp_type"), db.get_real("ksp_rtol"),
               db.prefixed("sub_").get_string("pc_type"),
               db.prefixed("mg_levels_").has_name("pc_type")]
        capsys.readouterr()
        db.print_help()
        got += [capsys.readouterr().out, db.used(), db.all(), db.view(), db.unused()]
        db.clear()
        got += [db.all(), db.used()]
        out[name] = got
    assert out["port"] == out["jax"]
    assert out["port"][2:4] == ["ilu", True]


def test_help_in_init_and_print_help_match_jax(capsys):
    out = {}
    for name, (pkg, cfg) in {"jax": (pt_jax, cfg_jax), "port": (ptt, cfg_port)}.items():
        _init(pkg, ["-help", "-ksp_type", "cg"])
        pkg.options().get_string("ksp_type")
        capsys.readouterr()
        cfg.print_help()
        text = capsys.readouterr().out
        # the reference's init also queries its XLA settings, which the port lacks
        for only_jax in ("  -compile_cache_dir\n", "  -fp_trap\n"):
            text = text.replace(only_jax, "")
        out[name] = (pkg.options()._help_requested, text)
    assert out["port"] == out["jax"]
    assert out["port"][0] and "-ksp_type" in out["port"][1]


# ---------------- profiler ----------------

def _fill(log):
    log.event_push("KSPSolve")
    log.log_event("MatMult", 0.003, count=5)
    log.log_event("VecDot", 0.001, count=2)
    log.event_push("PCApply")
    log.log_event("MatMult", 0.002, count=3)
    log.event_pop()
    log.event_pop()
    log.log_event("KSPSolve", 0.010)
    log.log_event("PCSetUp", 0.004)


def test_flamegraph_and_xml_text_equal_jax(fresh_logs):
    texts = {}
    for name, log in fresh_logs.items():
        _fill(log)
        f, x = io.StringIO(), io.StringIO()
        log.view_flamegraph(file=f)
        log.view_nested_xml(file=x)
        texts[name] = (f.getvalue(), x.getvalue())
    assert texts["port"] == texts["jax"]
    assert "KSPSolve;PCApply;MatMult 2000" in texts["port"][0]


@pytest.mark.parametrize("fmt", ("ascii_flamegraph", "ascii_xml"))
def test_log_view_file_format_writes_what_jax_writes(fresh_logs, tmp_path, fmt):
    texts = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.txt"
        _init(pkg, ["-log_view", f":{path}:{fmt}"])
        _fill(pkg.log())
        pkg.finalize()
        texts[name] = path.read_text()
    assert texts["port"] == texts["jax"]
    assert texts["port"].startswith("<?xml" if fmt == "ascii_xml" else "KSPSolve ")


# the reference's own contract (tests/test_hdf5_log.py), through both packages

@pytest.mark.parametrize("pkg", PKGS.values(), ids=PKGS.keys())
def test_flamegraph_and_xml_handlers_contract(pkg):
    _init(pkg)
    log = pkg.log()
    with log.nested("KSPSolve"):
        log.log_event("MatMult", 0.003, count=5)
    buf = io.StringIO()
    log.view_flamegraph(file=buf)
    assert "KSPSolve;MatMult 3000" in buf.getvalue()
    buf = io.StringIO()
    log.view_nested_xml(file=buf)
    assert "<name>KSPSolve</name>" in buf.getvalue() and "<ncalls>5</ncalls>" in buf.getvalue()


@pytest.mark.parametrize("pkg", PKGS.values(), ids=PKGS.keys())
def test_log_view_file_option_contract(pkg, tmp_path):
    p = str(tmp_path / "flame.txt")
    _init(pkg, ["-log_view", f":{p}:ascii_flamegraph"])
    pkg.log().log_event("VecNorm", 0.001)
    pkg.finalize()
    assert "VecNorm 1000" in open(p).read()
    _init(pkg)


def test_plain_log_view_file_is_the_table(fresh_logs, tmp_path):
    path = tmp_path / "table.txt"
    _init(ptt, ["-log_view", f":{path}"])
    _fill(ptt.log())
    ptt.finalize()
    text = path.read_text()
    assert "petsc_tpu_torch -log_view" in text and "--- Stage: Main Stage" in text


def test_stages_and_events_match_jax(fresh_logs):
    got = {}
    for name, log in fresh_logs.items():
        with log.stage("Solve"):
            with log.event("VecAXPY", flops=200.0, sync=torch.ones(3)):
                pass
            log.log_event("MatMult", 0.5, flops=10.0, count=2)
        with log.event("Outer", flops=1.0):
            pass
        ev, mm, outer = (log.get_event("VecAXPY", "Solve"), log.get_event("MatMult", "Solve"),
                         log.get_event("Outer"))
        got[name] = (ev.count, ev.flops, mm.count, mm.time, mm.flops, outer.count,
                     sorted(log._nested))
        log.enabled = False
        with log.event("Off"):
            pass
        assert log.get_event("Off") is None
    assert got["port"] == got["jax"]


def test_reset_drops_the_nested_records(fresh_logs):
    """A reference fault (ROADMAP §3): its reset keeps the nested records,
    so its flamegraph still shows events from before the reset."""
    texts = {}
    for name, log in fresh_logs.items():
        _fill(log)
        log.reset()
        buf = io.StringIO()
        log.view_flamegraph(file=buf)
        texts[name] = buf.getvalue()
    assert texts["port"] == ""
    assert "KSPSolve;MatMult" in texts["jax"]


def test_info_matches_jax_and_follows_dash_info(capsys):
    out = {}
    for name, mod, pkg in (("jax", logging_jax, pt_jax), ("port", logging_port, ptt)):
        mod.set_info(True)
        capsys.readouterr()
        mod.info(pkg.Vec(), "assembled 3 rows")
        mod.info(None, "no object")
        mod.set_info(False)
        mod.info(pkg.Vec(), "hidden")
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] == "[0] Vec: assembled 3 rows\n[0] None: no object\n"
    ptt.init(args=["-info"], device="cpu")
    ptt.Vec().log_info("on")
    assert capsys.readouterr().out == "[0] Vec: on\n"
    ptt.init(device="cpu")
    ptt.Vec().log_info("off")
    assert capsys.readouterr().out == ""


# ---------------- comm_world and the reasons ----------------

def test_comm_world_and_reason_enums_match_jax():
    ptt.init(device="cpu")
    comm = ptt.comm_world()
    assert comm.size == comm.nshards == 1 and ptt.comm_world(1) is comm
    # more ranks than the process group has (none was started here) raise,
    # naming how to start one
    with pytest.raises(ptt.Error, match="process group has 1 ranks"):
        ptt.comm_world(2)
    for name in ("KSPConvergedReason", "SNESConvergedReason", "TSConvergedReason",
                 "TaoConvergedReason", "PCFailedReason"):
        ours, ref = getattr(ptt, name), getattr(pt_jax, name)
        assert {m.name: m.value for m in ours} == {m.name: m.value for m in ref}, name
    assert ptt.SNESConvergedReason.CONVERGED_ITS.converged
    assert ptt.SNESConvergedReason.DIVERGED_MAX_IT.diverged
    assert ptt.TaoConvergedReason.CONVERGED_GATOL.converged
    assert not ptt.TSConvergedReason.DIVERGED_STEP_REJECTED.converged
