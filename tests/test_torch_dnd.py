"""petsc_tpu_torch's variable-coefficient grid stencil against petsc_tpu's,
on the CPU: the aij_dnd binder's product (V1's plain version) and its
gather-form transpose on random stencils whose planes are all variable,
variable mixed with constants, or all constant on offsets that are
neither box nor star; build_dnd(variable=True); MatAIJ on a declared grid
(setStencilGrid, -mat_spmv_kind dnd, COO values scattered into the
planes, a host_only Pmat). Both packages compute on the same operator
(carried across with ``interop``) and the same numpy vectors.

Tolerances: 1e-13 relative in float64 for the products (the same sums in
the same offset order; XLA may fuse a product into an add, the port
rounds each); the planes and the assembled values are equal."""

from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.mat import aij as aij_jax
from petsc_tpu.ops import operator as op_jax
from petsc_tpu.ops import stencil_build as sb_jax
from petsc_tpu_torch import interop
from petsc_tpu_torch.ops import grid_kernels, operator, stencil_build

torch.set_num_threads(1)

SHAPES = ((9, 8, 7), (8, 8), (7, 7), (6, 9), (12, 12, 12))
KINDS = ("box", "star", "mixed", "generic")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ptt.init(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _stencil(shape, kind, seed=0):
    """The reference's (meta, data) of a random stencil on `shape`: every
    plane variable (box or star offsets), every other offset of the box
    constant (mixed), or constants on a pattern that is neither box nor
    star (generic)."""
    rng = np.random.default_rng(seed)
    nd, N = len(shape), int(np.prod(shape))
    box = list(product((-1, 0, 1), repeat=nd))
    if kind == "star":
        offs = sb_jax.stencil_offsets(nd, "star")
    elif kind == "generic":
        offs = [(0,) * nd, (0,) * (nd - 1) + (1,), (0,) * (nd - 1) + (-1,), (1,) * nd,
                (-1,) + (1,) * (nd - 1)]
    else:
        offs = box
    if kind in ("box", "star"):
        cvals = None
    elif kind == "mixed":
        cvals = tuple(None if k % 2 else float(rng.standard_normal()) for k in range(len(offs)))
    else:
        cvals = tuple(float(rng.standard_normal()) + (4.0 if not any(o) else 0.0) for o in offs)
    nvar = len(offs) if cvals is None else sum(c is None for c in cvals)
    coef = rng.standard_normal((nvar,) + tuple(shape))
    u = np.asarray(offs)
    lpad = tuple(int(max(0, -u[:, ax].min())) for ax in range(nd))
    rpad = tuple(int(max(0, u[:, ax].max())) for ax in range(nd))
    meta = ("aij_dnd", tuple(shape), tuple(tuple(o) for o in offs), lpad, rpad, N)
    if cvals is not None:
        meta = meta + (cvals,)
    return meta, {"coef": jnp.asarray(coef), "diag": jnp.asarray(rng.random(N))}


def _port(meta, data):
    A = interop.mat_from_meta_data(meta, {k: np.asarray(v) for k, v in data.items()})
    return A, operator.bind(A.meta, A.device_data())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mult_matches_the_reference(shape, kind):
    meta, data = _stencil(shape, kind)
    x = np.random.default_rng(1).random(int(np.prod(shape)))
    ref = np.asarray(op_jax.bind(meta, data).mult(jnp.asarray(x)))
    A, op = _port(meta, data)
    y = op.mult(torch.from_numpy(x))
    assert y.dtype == torch.float64 and _rel(y.numpy(), ref) <= 1e-13
    # the binder's product is V1's plain version on a CPU tensor
    cvals = meta[6] if len(meta) > 6 else (None,) * len(meta[2])
    plain = grid_kernels.dnd_stencil_plain(torch.from_numpy(x), meta[1], meta[2], cvals,
                                           A.device_data()["coef"])
    assert torch.equal(y, plain)
    assert torch.equal(op.diag(), torch.as_tensor(np.array(data["diag"])))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mult_t_matches_the_reference(shape, kind):
    meta, data = _stencil(shape, kind, seed=2)
    x = np.random.default_rng(3).random(int(np.prod(shape)))
    ref = np.asarray(op_jax.bind(meta, data).mult_t(jnp.asarray(x)))
    _, op = _port(meta, data)
    assert _rel(op.mult_t(torch.from_numpy(x)).numpy(), ref) <= 1e-13
    # the transpose's definition: <A^T x, v> = <x, A v>
    v = np.random.default_rng(4).random(x.size)
    lhs = float(op.mult_t(torch.from_numpy(x)) @ torch.from_numpy(v))
    rhs = float(torch.from_numpy(x) @ op.mult(torch.from_numpy(v)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


@pytest.mark.parametrize("kind", ("box", "star"))
@pytest.mark.parametrize("shape", ((6, 5, 4), (7, 7), (12, 12, 12)))
def test_build_dnd_variable_planes_equal_the_reference(shape, kind):
    meta_j, data_j = sb_jax.build_dnd(shape, kind=kind, variable=True)
    meta, data = stencil_build.build_dnd(shape, kind=kind, variable=True)
    assert meta == meta_j and len(meta) == 6
    assert np.array_equal(data["coef"].numpy(), np.asarray(data_j["coef"]))
    assert np.array_equal(data["diag"].numpy(), np.asarray(data_j["diag"]))
    # the same operator as the constant stencil, through V1's plain version
    x = torch.from_numpy(np.random.default_rng(5).random(int(np.prod(shape))))
    const = operator.bind(*stencil_build.build_dnd(shape, kind=kind))
    var = operator.bind(meta, data)
    assert _rel(var.mult(x).numpy(), const.mult(x).numpy()) <= 1e-13
    assert _rel(var.mult_t(x).numpy(), const.mult(x).numpy()) <= 1e-13


def test_variable_coef_slab_path_matches_generic():
    """tests/test_stencil_const.py's slab test: the reference's slab-blocked
    variable mult (forced at test size, also with a clamped last chunk)
    and its generic branch against the port's one product and S1's."""
    n = 12
    meta_c, data_c = stencil_build.build_dnd((n,) * 3, kind="box")
    meta_v, data_v = stencil_build.build_dnd((n,) * 3, kind="box", variable=True)
    mj, dj = sb_jax.build_dnd((n,) * 3, kind="box", variable=True)
    x = np.random.default_rng(4).random(n ** 3)
    y = operator.bind(meta_v, data_v).mult(torch.from_numpy(x)).numpy()
    assert _rel(y, operator.bind(meta_c, data_c).mult(torch.from_numpy(x)).numpy()) <= 1e-13
    old = aij_jax._SLAB_TARGET_BYTES
    try:
        for planes in (None, 2, 5):
            if planes:
                aij_jax._SLAB_TARGET_BYTES = n * n * 8 * planes
            ref = np.asarray(op_jax.bind(mj, dj).mult(jnp.asarray(x)))
            assert _rel(y, ref) <= 1e-13
    finally:
        aij_jax._SLAB_TARGET_BYTES = old


def _random_grid_csr(shape, seed=0):
    """tests/test_gamg_device.py's variable-coefficient {-1,0,1}^d stencil
    as a scipy CSR."""
    rng = np.random.default_rng(seed)
    nd, N = len(shape), int(np.prod(shape))
    idx = np.indices(shape).reshape(nd, -1)
    strides = np.array([int(np.prod(shape[d + 1:])) for d in range(nd)])
    rows_l, cols_l, vals_l = [], [], []
    for o in product((-1, 0, 1), repeat=nd):
        tgt = idx + np.asarray(o)[:, None]
        ok = np.ones(N, bool)
        for d in range(nd):
            ok &= (tgt[d] >= 0) & (tgt[d] < shape[d])
        v = rng.standard_normal(N) + (6.0 if not any(o) else 0.0)
        rows_l.append(np.nonzero(ok)[0])
        cols_l.append((strides @ tgt)[ok])
        vals_l.append(v[ok])
    return sp.csr_matrix((np.concatenate(vals_l),
                          (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(N, N))


@pytest.mark.parametrize("shape", ((9, 8, 7), (8, 8), (6, 9)))
def test_a_declared_grid_gives_the_dnd_layout_and_the_same_product(shape):
    A_sp = _random_grid_csr(shape)
    pt_jax.init()
    Aj = pt_jax.MatAIJ.from_scipy(A_sp)
    Aj.setStencilGrid(shape)
    A = ptt.MatAIJ.from_scipy(A_sp)
    assert A.meta[0] == "aij_csr"
    A.setStencilGrid(shape)
    assert A.meta == Aj.meta and A.meta[0] == "aij_dnd"
    dj = Aj.device_data()
    for key in ("coef", "dnd_scatter", "diag"):
        assert np.array_equal(A.device_data()[key].numpy(), np.asarray(dj[key])), key
    x = np.random.default_rng(6).random(A_sp.shape[0])
    y = A.op().mult(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(Aj.op().mult(jnp.asarray(x)))) <= 1e-13
    assert _rel(y, A_sp @ x) <= 1e-13
    assert _rel(A.op().mult_t(torch.from_numpy(x)).numpy(), A_sp.T @ x) <= 1e-13
    # the host CSR stays the canonical one
    assert (A.to_scipy() != A_sp).nnz == 0


@pytest.mark.parametrize("shape", ((9, 8, 7), (6, 9)))
def test_from_scipy_on_a_grid_builds_the_planes_once(shape, monkeypatch):
    """from_scipy(A, grid=shape) declares the grid before the one device
    build (the host head's coarse levels) and equals from_scipy followed
    by setStencilGrid."""
    A_sp = _random_grid_csr(shape, seed=3)
    two_step = ptt.MatAIJ.from_scipy(A_sp).setStencilGrid(shape)
    builds = []
    real = ptt.MatAIJ._build_device
    monkeypatch.setattr(ptt.MatAIJ, "_build_device",
                        lambda self: builds.append(1) or real(self))
    A = ptt.MatAIJ.from_scipy(A_sp, grid=shape)
    assert len(builds) == 1 and A.meta == two_step.meta and A.meta[0] == "aij_dnd"
    for key in ("coef", "dnd_scatter", "diag"):
        assert torch.equal(A.device_data()[key], two_step.device_data()[key]), key


def test_coo_values_reach_the_planes():
    """setPreallocationCOO/setValuesCOO on a declared grid: the values are
    scattered into the planes on the device, the diagonal refreshed, and the
    host CSR read back from the planes."""
    shape = (6, 5, 4)
    A_sp = _random_grid_csr(shape, seed=7).tocoo()
    perm = np.random.default_rng(8).permutation(A_sp.nnz)
    i, j, v = A_sp.row[perm], A_sp.col[perm], A_sp.data[perm]
    A = ptt.MatAIJ()
    A.setSizes(A_sp.shape[0])
    A.setStencilGrid(shape)
    A.setPreallocationCOO(i, j)
    assert A.meta[0] == "aij_dnd" and not A.device_data()["coef"].any()
    A.setValuesCOO(v)
    x = np.random.default_rng(9).random(A_sp.shape[0])
    assert _rel(A.op().mult(torch.from_numpy(x)).numpy(), A_sp.tocsr() @ x) <= 1e-13
    assert np.array_equal(A.op().diag().numpy(), A_sp.tocsr().diagonal())
    assert (A.to_scipy() != A_sp.tocsr()).nnz == 0


def test_mat_spmv_kind_dnd_and_its_absence():
    shape = (6, 6)
    A_sp = _random_grid_csr(shape, seed=1)
    ptt.init(args=["-mat_spmv_kind", "dnd"], device="cpu")
    with pytest.raises(ptt.Error, match="declares no grid"):
        ptt.MatAIJ.from_scipy(sp.eye(36, format="csr"))
    with pytest.raises(ptt.Error, match="declares no grid"):
        A = ptt.MatAIJ()
        A.setSizes(36)
        A.setStencilGrid((36,))                           # a 1-D grid takes no planes
        A.setValuesCSR(A_sp.indptr, A_sp.indices, A_sp.data)
        A.assemble()
    A = ptt.MatAIJ()
    A.setSizes(36)
    A.setStencilGrid(shape)
    A.setValuesCSR(A_sp.indptr, A_sp.indices, A_sp.data)
    assert A.assemble().meta[0] == "aij_dnd"
    # an explicit CSR kind keeps CSR on a grid
    ptt.init(args=["-mat_spmv_kind", "csr"], device="cpu")
    B = ptt.MatAIJ.from_scipy(A_sp).setStencilGrid(shape)
    assert B.meta[0] == "aij_csr"


def test_host_only_defers_the_device_build():
    A_sp = _random_grid_csr((5, 6), seed=3)
    A = ptt.MatAIJ.from_scipy(A_sp, host_only=True)
    assert A._dev is None
    A.setStencilGrid((5, 6))
    assert A._dev is None and A.nnz() == A_sp.nnz
    assert A.meta[0] == "aij_dnd" and A._dev is not None      # built when asked for
    x = np.random.default_rng(2).random(30)
    assert _rel(A.op().mult(torch.from_numpy(x)).numpy(), A_sp @ x) <= 1e-13


@pytest.mark.parametrize("shape,offs", (((33,), ((-1,), (0,), (1,))),
                                        ((12, 11), ((0, 0), (1, -1), (-1, 1))),
                                        ((4, 5, 6), ((1, 0, -1), (0, 0, 0)))))
def test_v1_launch_plan_pads_grids_to_3d(shape, offs):
    """V1's launch arguments, which only the card reads: a 1-D or 2-D grid
    takes leading unit axes and its offsets leading zeros (a leading
    nonzero would put every neighbour outside the grid), the taps'
    planes count up through the variable ones and constants pass as they
    are."""
    consts = (None,) + (2.5,) * (len(offs) - 1)
    grid, n, coef_shape, args, (off3, planes, cvals) = \
        grid_kernels._dnd_plan(shape, offs, consts)
    pad = 3 - len(shape)
    assert grid == shape and n == int(np.prod(shape)) and coef_shape == (1,) + shape
    assert args[:4] == (1,) * pad + shape + (len(offs),)
    assert list(off3) == [v for o in offs for v in (0,) * pad + o]
    assert list(planes) == [0] + [-1] * (len(offs) - 1)
    assert list(cvals) == [0.0] + [2.5] * (len(offs) - 1)


def _shift_sum_by_slots(x, shape, coef, window):
    """The window kernel's sum rebuilt from its plan alone: over the 27
    slots of {-1,0,1}^3 in order, each tap's plane (its index counted
    through the plane bitmask) or constant (from the plan's array) times
    x shifted by the slot's offset, zeros outside the grid."""
    grid = (1,) * (3 - len(shape)) + tuple(shape)
    present, plane = window["args"][:2]
    xp = torch.nn.functional.pad(x.reshape(grid), (1, 1, 1, 1, 1, 1))
    acc = torch.zeros(grid, dtype=x.dtype)
    for k, (d0, d1, d2) in enumerate(product((-1, 0, 1), repeat=3)):
        if not present >> k & 1:
            continue
        if plane >> k & 1:
            c = coef[bin(plane & ((1 << k) - 1)).count("1")].reshape(grid)
        else:
            c = window["consts"][k]
        acc = acc + c * xp[1 + d0:1 + d0 + grid[0], 1 + d1:1 + d1 + grid[1],
                           1 + d2:1 + d2 + grid[2]]
    return acc.reshape(-1)


_BOX3 = tuple(product((-1, 0, 1), repeat=3))
_STAR3 = tuple(tuple(o) for o in stencil_build.stencil_offsets(3, "star"))
V1_PLANS = (
    ("window", (6, 5, 4), _BOX3, "planes"),
    ("window", (6, 5, 4), _BOX3, "mixed"),
    ("window", (5, 6, 7), tuple(sorted(_STAR3)), "planes"),
    ("window", (33,), ((-1,), (0,), (1,)), "planes"),
    ("window", (7, 9), tuple(product((-1, 0, 1), repeat=2)), "mixed"),
    ("window", (8, 8), ((-1, -1), (0, 0), (1, 0)), "constants"),
    ("generic", (6, 5, 4), _BOX3[::-1], "planes"),
    ("generic", (5, 6, 7), _STAR3, "planes"),
    ("generic", (9, 8, 7), ((0, 0, 0), (0, 0, 2), (0, 0, -2), (2, 0, 0)), "planes"),
    ("generic", (6, 5, 4), ((0, 0, 0), (0, 0, 0)), "planes"),
    ("generic", (12, 11), ((0, 0), (1, -1), (-2, 1)), "mixed"),
)


@pytest.mark.parametrize("want,shape,offs,coefs", V1_PLANS)
def test_v1_takes_the_window_or_the_generic_kernel_at_plan_time(want, shape, offs, coefs):
    """V1's kernel is chosen once, where the operator is bound: the window
    kernel for offsets that, padded to 3-D, are slots of {-1,0,1}^3 in
    increasing order (the whole box, a subsequence, on 1-D and 2-D grids,
    planes mixed with constants), the generic kernel for another order, a
    radius of 2 or a repeated offset. The window's bitmasks and constants
    rebuild the plain version's sum bit for bit."""
    rng = np.random.default_rng(11)
    consts = tuple(None if coefs == "planes" or (coefs == "mixed" and k % 2)
                   else float(rng.standard_normal()) for k in range(len(offs)))
    nvar = sum(c is None for c in consts)
    coef = torch.from_numpy(rng.standard_normal((nvar,) + shape))
    x = torch.from_numpy(rng.random(int(np.prod(shape))))
    fn = grid_kernels.dnd_stencil_fn(shape, offs, consts, coef)
    assert fn.kernel == want and (fn.window is None) == (want == "generic")
    y = fn(x)
    assert torch.equal(y, grid_kernels.dnd_stencil_plain(x, shape, offs, consts, coef))
    if want == "window":
        present, plane = fn.window["args"][:2]
        slots = [_BOX3.index((0,) * (3 - len(shape)) + o) for o in offs]
        assert present == sum(1 << s for s in slots)
        assert plane == sum(1 << s for s, c in zip(slots, consts) if c is None)
        assert torch.equal(_shift_sum_by_slots(x, shape, coef, fn.window), y)


@pytest.mark.parametrize("n2,dtype,vector", ((64, torch.float32, True),
                                             (65, torch.float32, False),
                                             (6, torch.float32, False),
                                             (8, torch.float32, True),
                                             (2, torch.float64, True),
                                             (3, torch.float64, False),
                                             (64, torch.float64, True),
                                             (65, torch.float64, False)))
def test_v1_window_variant_follows_n2_and_the_planes_alignment(n2, dtype, vector):
    """The window kernel loads planes and stores y 16 bytes at a time only
    where n2 * itemsize is a multiple of 16 and the planes start on a
    16-byte edge; an odd grid, or planes one element past an edge, take
    the scalar variant. The launch covers the grid, with at most 128
    threads and 48 KB of ring per block."""
    shape = (5, 7, n2)
    n = int(np.prod(shape))
    coef = torch.zeros((27,) + shape, dtype=dtype)
    plan = grid_kernels.dnd_stencil_fn(shape, _BOX3, (None,) * 27, coef).window
    assert plan["vector"] == vector and plan["args"][3] == int(vector)
    (nx, ny), chunk, grid = plan["block"], plan["chunk"], plan["grid"]
    w = 16 // coef.element_size()
    assert plan["args"][4:] == (nx, ny, chunk) and nx * ny <= 128
    assert grid[0] * nx * w >= n2 > (grid[0] - 1) * nx * w
    assert grid[1] * ny >= 7 and grid[2] * chunk >= 5
    assert 4 * (ny + 2) * (nx * w + 2 * w) * coef.element_size() <= 48 * 1024
    past_edge = torch.zeros(27 * n + 1, dtype=dtype)[1:].view((27,) + shape)
    assert not grid_kernels.dnd_stencil_fn(shape, _BOX3, (None,) * 27,
                                           past_edge).window["vector"]


@pytest.mark.parametrize("dtype,block,grid", ((torch.float32, (16, 8), (1, 8, 64)),
                                              (torch.float64, (32, 4), (1, 16, 64))))
def test_v1_window_geometry_on_the_path_level(dtype, block, grid):
    """The probed 64^3 level: 16-byte packs along i2 cover its 64 points
    with 16 (f32) or 32 (f64) threads, rows fill 128 threads, and one
    plane per block gives 512 or 1024 blocks on 132 SMs."""
    coef = torch.zeros((27, 64, 64, 64), dtype=dtype)
    plan = grid_kernels.dnd_stencil_fn((64,) * 3, _BOX3, (None,) * 27, coef).window
    assert plan["vector"] and plan["block"] == block and plan["chunk"] == 1
    assert plan["grid"] == grid
