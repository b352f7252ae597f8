"""petsc_tpu_torch on a CUDA card: each hand kernel against its plain
PyTorch version on the card, COO assembly on the card against the CPU
port, and small CG solves through the kernels (stencil and CSR).

Every test is marked ``cuda`` and skips where there is no card. The file
imports neither jax nor petsc_tpu, so it also runs on a machine without
them; there run it without the suite's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: 1e-12 relative in float64, 1e-5 in float32 (the kernels sum
in another order than PyTorch); the gathers are exact."""

from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import chip_smoke
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import gather_kernels as gk
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.ops import stencil_build

DATA = Path(__file__).resolve().parent / "data"

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(k, p):
    return float((k - p).abs().max() / p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", (70001, 65536 + 3, 5))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_vector_kernels_match_plain(cuda_device, dtype, n):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(n, generator=gen, device=cuda_device, dtype=dtype)
    y = torch.rand(n, generator=gen, device=cuda_device, dtype=dtype)
    a = torch.tensor(-0.37, dtype=dtype, device=cuda_device)
    pk.reset_launches()
    assert _rel(pk.triad(x, y, a), pk.triad_plain(x, y, a)) <= TOL[dtype]
    kv, kn = pk.axpy_normsq(a, x, y)
    pv, pn = pk.axpy_normsq_plain(a, x, y)
    assert _rel(kv, pv) <= TOL[dtype] and _rel(kn, pn) <= TOL[dtype]
    for k, p in zip(pk.dot2(x, y), pk.dot2_plain(x, y)):
        assert _rel(k, p) <= TOL[dtype]
    # views off 16 bytes by one element: a scalar head, then the packs
    assert _rel(pk.triad(x[1:], y[1:], a), pk.triad_plain(x[1:], y[1:], a)) <= TOL[dtype]
    # in place, as the CG body uses them
    want = pk.triad_plain(x, y, a)
    pk.triad(x, y, a, out=x)
    assert _rel(x, want) <= TOL[dtype]
    torch.cuda.synchronize()
    assert pk.LAUNCHES == {"probe": 0, "triad": 3, "axpy_normsq": 1, "dot2": 1,
                           "const_stencil": 0, "csr_spmv": 0, "csr_spmm": 0, "cheby_update": 0,
                           "cheby_update_z": 0}


def _edge_lengths(dtype, device):
    """1, 5, one 16-byte pack, one pack + 1, and the edge of each kernel's
    full wave (SMs x blocks per SM x threads x packs per thread x pack
    width) +- 1."""
    w = 16 // torch.empty((), dtype=dtype).element_size()
    ns = {1, 5, w, w + 1}
    for name in ("triad", "dot2"):
        c = pk.launch_config(name, dtype, 1 << 24, device)
        edge = c["sms"] * c["blocks_per_sm"] * c["threads"] * c["packs_per_thread"] * w
        ns |= {edge - 1, edge, edge + 1}
    return sorted(ns)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_triad_and_dot2_at_their_edges(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.tensor(0.61, dtype=dtype, device=cuda_device)
    pk.reset_launches()
    launches = 0
    for n in _edge_lengths(dtype, cuda_device):
        x = torch.rand(n + 1, generator=gen, device=cuda_device, dtype=dtype)
        y = torch.rand(n + 1, generator=gen, device=cuda_device, dtype=dtype)
        # aligned; both off 16 bytes by one element; off by different amounts
        for sx, sy in ((slice(0, n), slice(0, n)), (slice(1, None), slice(1, None)),
                       (slice(1, None), slice(0, n))):
            xv, yv = x[sx], y[sy]
            want = pk.triad_plain(xv, yv, a)
            assert _rel(pk.triad(xv, yv, a), want) <= TOL[dtype], n
            for k, p in zip(pk.dot2(xv, yv), pk.dot2_plain(xv, yv)):
                assert _rel(k, p) <= TOL[dtype], n
            # in place over b, then over c (fresh copies keep the views' offsets)
            for over_b in (True, False):
                xc, yc = x.clone()[sx], y.clone()[sy]
                got = pk.triad(xc, yc, a, out=xc if over_b else yc)
                assert got is (xc if over_b else yc) and _rel(got, want) <= TOL[dtype], n
            launches += 1
    torch.cuda.synchronize()
    assert pk.LAUNCHES["triad"] == 3 * launches and pk.LAUNCHES["dot2"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_dot2_gives_equal_bits_on_reruns(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.rand((1 << 21) + 3, generator=gen, device=cuda_device, dtype=dtype)
    y = torch.rand((1 << 21) + 3, generator=gen, device=cuda_device, dtype=dtype)
    p = pk.dot2_plain(x, y)
    first = torch.stack(pk.dot2(x, y))
    runs = [torch.stack(pk.dot2(x, y)) for _ in range(200)]
    # calls on other lengths leave the ticket's counter at 0
    for n in (5, 1000, 70001):
        pk.dot2(x[:n], y[:n])
    runs += [torch.stack(pk.dot2(x, y)) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(_rel(k, q) <= TOL[dtype] for k, q in zip(first, p))
    assert all(torch.equal(r, first) for r in runs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_dot2_on_two_streams_at_once(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xs = [torch.rand(n, generator=gen, device=cuda_device, dtype=dtype) for n in (1 << 21, 70001)]
    ys = [torch.rand(x.numel(), generator=gen, device=cuda_device, dtype=dtype) for x in xs]
    want = [torch.stack(pk.dot2_plain(x, y)) for x, y in zip(xs, ys)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    got = ([], [])
    for _ in range(50):
        for s, x, y, g in zip(streams, xs, ys, got):
            with torch.cuda.stream(s):
                g.append(torch.stack(pk.dot2(x, y)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g[0], w) <= TOL[dtype]
        assert all(torch.equal(r, g[0]) for r in g)
    keys = {(cuda_device.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(pk._WORKSPACE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((17, 9, 40), (12, 33), (70,), (33, 17, 130)))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_stencil_kernel_matches_plain(cuda_device, dtype, shape):
    m = int(np.prod(shape))
    x = torch.rand(m, generator=torch.Generator(device=cuda_device).manual_seed(1),
                   device=cuda_device, dtype=dtype)
    pk.reset_launches()
    for is_box in (True, False):
        k = pk.const_stencil(x, shape, 26.0, -1.0, is_box)
        p = pk.const_stencil_plain(x, shape, 26.0, -1.0, is_box)
        assert _rel(k, p) <= TOL[dtype]
        if len(shape) == 3:
            assert torch.equal(k, p)     # same order of sums, no fused multiply-add
    torch.cuda.synchronize()
    assert pk.LAUNCHES["const_stencil"] == 2


# S1 on both load paths: n0 not a multiple of the chunk, n1 and n2 not
# multiples of the tile, one plane, and grids 1-2 points wide in i1 or i2,
# where every TMA box reaches past a face of the grid
S1_SHAPES = ((128, 128, 128), (37, 20, 64), (19, 11, 36), (1, 24, 40), (5, 1, 64), (5, 2, 64),
             (6, 40, 4), (6, 40, 2), (7, 2, 1), (1, 1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", S1_SHAPES)
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_stencil_kernel_equals_plain_on_both_load_paths(cuda_device, dtype, shape):
    m = int(np.prod(shape))
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    buf = 2 * torch.rand(m + 1, generator=gen, device=cuda_device, dtype=dtype) - 1
    paths = []
    pk.reset_launches()
    # x aligned, then x one element past a 16-byte edge (always cp.async)
    for x in (buf[:m], buf[1:]):
        paths.append(pk.const_stencil_plan(shape, dtype, x.data_ptr())["path"])
        for is_box in (True, False):
            k = pk.const_stencil(x, shape, 26.0, -1.0, is_box)
            p = pk.const_stencil_plain(x, shape, 26.0, -1.0, is_box)
            assert torch.equal(k, p), (paths[-1], is_box)
    torch.cuda.synchronize()
    isz = buf.element_size()
    assert paths == ["tma" if shape[-1] * isz % 16 == 0 else "cp.async", "cp.async"]
    assert pk.LAUNCHES["const_stencil"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_stencil_kernel_gives_equal_bits_on_reruns(cuda_device, dtype):
    shape = (128,) * 3
    m = 128 ** 3
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    buf = torch.rand(m + 1, generator=gen, device=cuda_device, dtype=dtype)
    for x in (buf[:m], buf[1:]):
        for is_box in (True, False):
            p = pk.const_stencil_plain(x, shape, 26.0, -1.0, is_box)
            runs = [pk.const_stencil(x, shape, 26.0, -1.0, is_box) for _ in range(50)]
            torch.cuda.synchronize()
            assert all(torch.equal(r, p) for r in runs)


@pytest.mark.cuda
def test_stencil_plan_on_the_card(cuda_device):
    x = torch.zeros(128 ** 3, dtype=torch.float64, device=cuda_device)
    plan = pk.const_stencil_plan((128,) * 3, x.dtype, x.data_ptr(), cuda_device)
    assert plan["path"] == "tma" and plan["grid"] == (4, 16, 8)
    assert plan["blocks_per_sm"] >= 1 and plan["sms"] >= 1 and plan["registers"] > 0


@pytest.mark.cuda
def test_cg_runs_through_the_kernels(cuda_device):
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"])
    assert ptt.config.device().type == "cuda"
    meta, data = stencil_build.build_dnd((16,) * 3, kind="box")
    A = stencil_build.as_mat(meta, data)
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    pk.reset_launches()
    x = ksp.solve(b)
    its = ksp.getIterationNumber()
    assert its == 24 and ksp.getConvergedReason().name == "CONVERGED_RTOL"
    assert x.array.is_cuda
    for name in ("const_stencil", "triad", "axpy_normsq", "dot2"):
        assert pk.LAUNCHES[name] >= its, name
    A_csr = stencil_build.poisson3d_27pt(16)
    r = np.ones(16 ** 3) - A_csr @ x.getArray()
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(np.ones(16 ** 3))


def _csr_on(A, device, dtype):
    A = A.tocsr()
    return (torch.as_tensor(A.indptr.astype(np.int64), device=device),
            torch.as_tensor(A.indices.astype(np.int32), device=device),
            torch.as_tensor(A.data, dtype=dtype, device=device))


def _rows(lengths, n, rng, low):
    """A CSR matrix with the given row lengths, random columns in [0, n)
    and values in [low, low + 1)."""
    indptr = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    nnz = int(indptr[-1])
    return sp.csr_matrix((rng.random(nnz) + low, rng.integers(0, n, nnz), indptr),
                         shape=(len(lengths), n))


def _csr_cases():
    rng = np.random.default_rng(5)
    cases = {f"rand_{m}x{n}_{d}": sp.random(m, n, density=d, format="csr", random_state=rng)
             for m, n, d in ((7, 5, 0.3), (40, 60, 0.3), (60, 40, 0.3), (3000, 2000, 0.002),
                             (500, 500, 0.05), (300, 4000, 0.02))}
    # empty rows, one long row, an empty matrix
    skew = sp.random(1000, 1000, density=0.003, format="lil", random_state=rng)
    skew[17, :] = rng.random(1000)
    skew[400:450, :] = 0
    cases["skewed"] = skew.tocsr()
    cases["empty"] = sp.csr_matrix((9, 4))
    cases["box27_24"] = stencil_build.poisson3d_27pt(24)
    cases["box27_48"] = stencil_build.poisson3d_27pt(48)     # many tiles per block
    for f in ("LFAT5.mtx", "m_05_05_crk.mtx", "amesos2_test_mat0.mtx"):
        cases[f] = sp.csr_matrix(scipy.io.mmread(DATA / f))
    # rows cut around the kernel's tiles (chip_smoke.py holds the same cases)
    for name, (lengths, low) in chip_smoke.tile_edge_cases(chip_smoke.csr_tile()).items():
        cases[name] = _rows(lengths, 3000, rng, low)
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_csr_spmv_matches_plain_and_scipy(cuda_device, dtype):
    for name, A in _csr_cases().items():
        ip, col, vals = _csr_on(A, cuda_device, dtype)
        x_np = np.random.default_rng(1).random(A.shape[1])
        x = torch.as_tensor(x_np, dtype=dtype, device=cuda_device)
        pk.reset_launches()
        k = pk.csr_spmv(ip, col, vals, x)
        # the plain version in float64 on the same inputs: its atomic adds
        # sum a row in no fixed order, which in float32 moves a long row by
        # up to about 1e-5
        p = pk.csr_spmv_plain(ip, col, vals.double(), x.double())
        torch.cuda.synchronize()
        assert pk.LAUNCHES["csr_spmv"] == (1 if A.shape[0] else 0), name
        assert k.shape == (A.shape[0],) and k.dtype == dtype
        if A.nnz == 0:
            assert torch.count_nonzero(k) == 0
            continue
        assert _rel(k, p) <= TOL[dtype], name
        ref = torch.as_tensor(A @ x_np)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert _rel(k.double().cpu(), ref) <= tol, name
        assert torch.equal(k, pk.csr_spmv(ip, col, vals, x)), name    # no atomics
        # vals and col only element-aligned (one element past a 16-byte edge)
        col1 = torch.cat([col[:1], col])[1:]
        vals1 = torch.cat([vals[:1], vals])[1:]
        assert vals1.data_ptr() % 16 != 0 and col1.data_ptr() % 16 != 0
        assert torch.equal(k, pk.csr_spmv(ip, col1, vals1, x)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_gather_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    gk.reset_launches()
    for n, m in ((1, 1), (1000, 4099), (524_288 // 64, 65_536 + 5)):
        x = torch.rand(n, generator=g, device=cuda_device, dtype=dtype)
        idx = torch.randint(0, n, (m,), generator=g, device=cuda_device, dtype=torch.int32)
        assert torch.equal(gk.gather(x, idx), gk.gather_plain(x, idx))
        assert torch.equal(gk.gather(x, idx.view(-1, 1)), gk.gather_plain(x, idx.view(-1, 1)))
    for B, w, C in ((1, 128, 3), (64, 128, 1024 + 7), (5, 33, 77)):
        x2 = torch.rand((B, w), generator=g, device=cuda_device, dtype=dtype)
        q = torch.randint(0, B, (C,), generator=g, device=cuda_device, dtype=torch.int32)
        assert torch.equal(gk.row_gather(x2, q), gk.row_gather_plain(x2, q))
        q2 = torch.randint(0, B, (C, 3), generator=g, device=cuda_device, dtype=torch.int32)
        s2 = torch.randint(0, w, (C, 3), generator=g, device=cuda_device, dtype=torch.int32)
        assert torch.equal(gk.gather2(x2, q2, s2), gk.gather2_plain(x2, q2, s2))
    for C in (1, 1024 + 3):
        V = torch.rand((C, 128), generator=g, device=cuda_device, dtype=dtype)
        s = torch.randint(0, 128, (C, 128), generator=g, device=cuda_device, dtype=torch.int32)
        assert torch.equal(gk.lane_shuffle(V, s), gk.lane_shuffle_plain(V, s))
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gather": 6, "gather2": 3, "row_gather": 3, "lane_shuffle": 2}
    with pytest.raises(IndexError):
        gk.gather(x, torch.full((4,), n, dtype=torch.int32, device=cuda_device))
    with pytest.raises(IndexError):
        gk.lane_shuffle(V, torch.full_like(s, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_gather_covers_every_output_of_its_steps(cuda_device, dtype):
    """K8's grid-stride loop: lengths around a block's 256 and 2048
    outputs, and past one grid's worth (8 blocks of 256 threads per SM, so
    the grid strides), on values unique per entry, the diagonal refresh's
    shape among them (every 27th entry)."""
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.arange(1 << 23, dtype=bits, device=cuda_device).view(dtype)
    for m in (1, 255, 2047, 2048, 2049, 3 * 2048 + 7, 8 * 2048 * 1056 + 3):
        idx = torch.randint(0, x.numel(), (m,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        assert torch.equal(gk.gather(x, idx).view(bits), gk.gather_plain(x, idx).view(bits))
    idx = torch.arange(0, x.numel(), 27, dtype=torch.int32, device=cuda_device)
    assert torch.equal(gk.gather(x, idx).view(bits), gk.gather_plain(x, idx).view(bits))


def _box27_coo(n, seed):
    """box27 triplets in shuffled order, each diagonal split into two halves."""
    A = stencil_build.poisson3d_27pt(n).tocoo()
    d = A.row == A.col
    i = np.concatenate([A.row, A.row[d]])
    j = np.concatenate([A.col, A.col[d]])
    v = np.concatenate([np.where(d, 13.0, A.data), np.full(int(d.sum()), 13.0)])
    p = np.random.default_rng(seed).permutation(len(i))
    return i[p], j[p], v[p]


@pytest.mark.cuda
def test_coo_assembly_on_the_card_equals_the_cpu_port(cuda_device):
    i, j, v = _box27_coo(12, 0)
    i = i.copy()
    i[::97] = -1                                    # dropped entries
    mats = []
    for dev in ("cpu", None):
        ptt.init(device=dev)
        A = ptt.MatAIJ()
        A.setSizes(12 ** 3)
        A.setPreallocationCOO(i, j)
        gk.reset_launches()
        A.setValuesCOO(v)
        A.setValuesCOO(2 * v)
        mats.append(A)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gather"] == 4               # values and diagonal, twice
    assert mats[1].device_data()["vals"].is_cuda
    c, g = mats[0].to_scipy(), mats[1].to_scipy()
    assert np.array_equal(c.indptr, g.indptr) and np.array_equal(c.indices, g.indices)
    assert np.array_equal(c.data, g.data)           # at most two terms per slot
    assert np.array_equal(mats[0].getDiagonal().getArray(), mats[1].getDiagonal().getArray())


@pytest.mark.cuda
def test_cg_on_the_csr_operator_runs_through_the_kernels(cuda_device):
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"])
    i, j, v = _box27_coo(32, 1)
    pk.reset_launches()
    gk.reset_launches()
    A = ptt.Mat.createAIJ(32 ** 3, coo=(i, j, v))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = ksp.solve(b)
    its = ksp.getIterationNumber()
    assert A.meta[0] == "aij_csr" and ksp.getConvergedReason().name == "CONVERGED_RTOL"
    assert pk.LAUNCHES["csr_spmv"] == its and pk.LAUNCHES["const_stencil"] == 0
    assert gk.LAUNCHES["gather"] == 2
    r = np.ones(32 ** 3) - stencil_build.poisson3d_27pt(32) @ x.getArray()
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(np.ones(32 ** 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2 ** 20 + 37, 4096, 3))
@pytest.mark.parametrize("mode", ("first", "step"))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_cheby_update_matches_plain(cuda_device, dtype, mode, n):
    """C1 in place on r, p and x against its plain version on the same
    inputs, on aligned vectors and on views one element past a 16-byte
    edge (a scalar head, then the packs)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    pk.reset_launches()
    for off in (0, 1):
        b, w, dinv, r, p, x = (torch.rand(n + 1, generator=gen, device=cuda_device,
                                          dtype=dtype)[off:off + n] for _ in range(6))
        kw = {"b": b} if mode == "first" else {"a": 0.6}
        k = [t.clone() for t in (r, p, x)]
        q = [t.clone() for t in (r, p, x)]
        if off:
            k = [torch.cat([t[:1], t])[1:] for t in k]       # one element past the edge
        pk.cheby_update(mode, *k, w, dinv, 0.3, 0.9, **kw)
        pk.cheby_update_plain(mode, *q, w, dinv, 0.3, 0.9, **kw)
        torch.cuda.synchronize()
        for a, c in zip(k, q):
            assert _rel(a, c) <= TOL[dtype]
    assert pk.LAUNCHES["cheby_update"] == 2


@pytest.mark.cuda
def test_cg_pcmg_on_the_card_equals_the_cpu_port(cuda_device):
    """32^3 box27 CG+PCMG with the Q1 Galerkin hierarchy: its and history
    on the card equal the CPU port's (1e-6 relative), every step through
    the kernels."""
    n = 32
    grids, Ps = chip_smoke.q1_hierarchy(n)
    A_sp = stencil_build.poisson3d_27pt(n)
    res = {}
    for dev in ("cpu", "cuda"):
        ptt.init(args=["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"],
                 device=dev)
        pk.reset_launches()
        A = ptt.MatAIJ.from_scipy(A_sp)
        ksp = chip_smoke.mg_ksp(ptt, A, Ps)
        b = A.createVecLeft()
        b.set(1.0)
        x = ksp.solve(b)
        res[dev] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                    ksp.getConvergenceHistory(), dict(pk.LAUNCHES))
    its, reason, hist, launches = res["cuda"]
    assert its == res["cpu"][0] == 8 and reason == res["cpu"][1] == "CONVERGED_RTOL"
    np.testing.assert_allclose(hist, res["cpu"][2], rtol=1e-6, atol=0)
    need = chip_smoke.mg_launches_needed(its, len(grids))
    assert {k: launches[k] for k in need} == need


@pytest.mark.cuda
def test_cg_gamg_on_the_card_equals_the_cpu_port(cuda_device):
    """32^3 box27 CG+GAMG (every GAMG option at its default): the same
    hierarchy, its and history on the card as in the CPU port (history to
    1e-10 relative: the set-up is the same host code, only the cycle's
    sums are taken in another order), every step through the kernels."""
    A_sp = stencil_build.poisson3d_27pt(32)
    res = {}
    for dev in ("cpu", "cuda"):
        ptt.init(args=["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"],
                 device=dev)
        pk.reset_launches()
        A = ptt.MatAIJ.from_scipy(A_sp)
        ksp = chip_smoke.gamg_ksp(ptt, A)
        b = A.createVecLeft()
        b.set(1.0)
        ksp.solve(b)
        levels = ksp.getPC()._impl.levels
        res[dev] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                    ksp.getConvergenceHistory(), dict(pk.LAUNCHES),
                    [lev.A.nnz() for lev in levels], [lev.emax for lev in levels])
    its, reason, hist, launches, nnz, emax = res["cuda"]
    assert its == res["cpu"][0] == 8 and reason == res["cpu"][1] == "CONVERGED_RTOL"
    assert nnz == res["cpu"][4] == [830584, 26996, 3430, 9] and emax == res["cpu"][5]
    np.testing.assert_allclose(hist, res["cpu"][2], rtol=1e-10, atol=0)
    need = chip_smoke.mg_launches_needed(its, len(nnz))
    assert {k: launches[k] for k in need} == need


def _grid_stencil(shape, kind, dtype, device, seed=0):
    """(offsets, constants, planes) of a random stencil: every plane
    variable (box or star), planes mixed with constants, or constants on
    offsets that are neither box nor star (generic)."""
    from itertools import product
    rng = np.random.default_rng(seed)
    nd = len(shape)
    if kind == "star":
        offs = stencil_build.stencil_offsets(nd, "star")
    elif kind == "generic":
        offs = [(0,) * nd, (0,) * (nd - 1) + (1,), (1,) * nd, (-1,) + (1,) * (nd - 1)]
    else:
        offs = list(product((-1, 0, 1), repeat=nd))
    consts = tuple(None if kind in ("box", "star") or (kind == "mixed" and k % 2)
                   else float(rng.standard_normal()) for k in range(len(offs)))
    nvar = sum(c is None for c in consts)
    coef = torch.as_tensor(rng.standard_normal((nvar,) + tuple(shape)), dtype=dtype,
                           device=device)
    return offs, consts, coef


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind", (((64, 64, 64), "box"), ((9, 8, 7), "mixed"),
                                        ((12, 11), "star"), ((7, 9, 5), "generic"),
                                        ((33,), "box")))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_dnd_stencil_matches_plain(cuda_device, dtype, shape, kind):
    """V1 against its plain version on the card (1e-13 in f64, 1e-6 in
    f32: the kernel rounds each product and sum as the plain version does)."""
    from petsc_tpu_torch.ops import grid_kernels as gridk
    offs, consts, coef = _grid_stencil(shape, kind, dtype, cuda_device)
    x = torch.rand(int(np.prod(shape)), dtype=dtype, device=cuda_device)
    gridk.reset_launches()
    k = gridk.dnd_stencil(x, shape, offs, consts, coef)
    p = gridk.dnd_stencil_plain(x, shape, offs, consts, coef)
    torch.cuda.synchronize()
    assert _rel(k, p) <= (1e-13 if dtype == torch.float64 else 1e-6)
    assert gridk.LAUNCHES == {"dnd_stencil": 1, "dnd_stencil_t": 0, "q1_prolong": 0, "q1_restrict": 0}


def _random_grid_csr(shape, box, seed):
    """A random-coefficient star7 or box27 stencil on `shape` as a scipy CSR
    (neighbours outside the grid dropped)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows, cols = [], []
    for o in [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
              if box or abs(a) + abs(b) + abs(c) <= 1]:
        rows.append(idx[tuple(slice(max(0, -d), m - max(0, d)) for d, m in zip(o, shape))].ravel())
        cols.append(idx[tuple(slice(max(0, d), m - max(0, -d)) for d, m in zip(o, shape))].ravel())
    r, c = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(len(r)), (r, c)), shape=(n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((22, 33, 39), (5, 6, 7)))
@pytest.mark.parametrize("box", (False, True), ids=("star7", "box27"))
@pytest.mark.parametrize("real", ("f64", "f32"))
def test_dnd_stencil_t_matches_plain(cuda_device, real, box, shape):
    """V1T (a grid operator's mult_t on the card: V1's generic kernel on the
    transposed stencil's planes) equals its plain version, the gather form,
    bit for bit; in float64 it is A^T x of the assembled matrix to 1e-12.
    One launch, counted as dnd_stencil_t."""
    from petsc_tpu_torch.ops import grid_kernels as gridk
    A_sp = _random_grid_csr(shape, box, seed=4)
    ptt.init(args=["-real_dtype", real])
    A = ptt.MatAIJ.from_scipy(A_sp)
    A.setStencilGrid(shape)
    assert A.meta[0] == "aij_dnd"
    meta, data = A.meta, A.device_data()
    consts = meta[6] if len(meta) > 6 else (None,) * len(meta[2])
    dtype = torch.float64 if real == "f64" else torch.float32
    x = torch.rand(A_sp.shape[0], dtype=dtype, device=cuda_device) - 0.5
    op = A.op()
    gridk.reset_launches()
    y = op.mult_t(x)
    torch.cuda.synchronize()
    assert gridk.LAUNCHES == {"dnd_stencil": 0, "dnd_stencil_t": 1, "q1_prolong": 0,
                              "q1_restrict": 0}
    assert torch.equal(y, gridk.dnd_stencil_t(x, meta[1], meta[2], consts, data["coef"]))
    if dtype == torch.float64:
        want = A_sp.T @ x.cpu().numpy()
        assert np.abs(y.cpu().numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("fshape", ((64, 64, 64), (65, 65, 65), (9, 8, 6), (8, 6), (128,),
                                    (17,), (128, 128, 128), (129, 129, 129), (2, 2, 2),
                                    (3, 5, 130)))
@pytest.mark.parametrize("view", ("fresh", "one element past a 16-byte edge"))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_q1_kernels_match_plain(cuda_device, dtype, view, fshape):
    """Q1P and Q1R against their plain versions (the per-axis composition)
    on the card, even and odd sizes: Q1R bit for bit in both of its
    variants (the fine vector fresh, or a view one element past a 16-byte
    edge, which takes the scalar variant), Q1P to 1e-13 in f64 and 1e-6 in
    f32; both against the assembled P in float64."""
    from petsc_tpu_torch.dm.interp import MatInterpQ1
    from petsc_tpu_torch.ops import grid_kernels as gridk
    cshape = tuple((s + 1) // 2 for s in fshape)
    xc = torch.rand(int(np.prod(cshape)), dtype=dtype, device=cuda_device)
    nf = int(np.prod(fshape))
    buf = torch.rand(nf + 1, dtype=dtype, device=cuda_device)
    xf = buf[:nf] if view == "fresh" else buf[1:]
    plan = gridk._q1_restrict_plan(fshape, xf.element_size(), xf.data_ptr() % 16 == 0)
    assert plan["vector"] == (view == "fresh" and fshape[-1] * xf.element_size() % 16 == 0)
    gridk.reset_launches()
    kp, kr = gridk.q1_prolong(xc, fshape), gridk.q1_restrict(xf, fshape)
    pp, pr = gridk.q1_prolong_plain(xc, fshape), gridk.q1_restrict_plain(xf, fshape)
    torch.cuda.synchronize()
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    assert _rel(kp, pp) <= tol and torch.equal(kr, pr)
    P = MatInterpQ1(fshape, cshape).to_scipy()
    assert _rel(kp.double(), torch.as_tensor(P @ xc.double().cpu().numpy(),
                                             device=cuda_device)) <= tol
    assert _rel(kr.double(), torch.as_tensor(P.T @ xf.double().cpu().numpy(),
                                             device=cuda_device)) <= tol
    assert gridk.LAUNCHES == {"dnd_stencil": 0, "dnd_stencil_t": 0, "q1_prolong": 1, "q1_restrict": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("cycle", ("f64", "f32"))
def test_cg_gamg_structured_on_the_card_equals_the_cpu_port(cuda_device, cycle):
    """32^3 box27 stencil CG+GAMG with the structured device head (bench.py's
    solve at 32^3): the same hierarchy and its on the card as in the CPU
    port, the history to 1e-10 relative in f64 (1e-4 in f32, whose head is
    probed in float32), and every launch, set-up included, as
    chip_smoke.grid_launches_needed counts them."""
    from petsc_tpu_torch.ops import gather_kernels as gk2
    from petsc_tpu_torch.ops import grid_kernels as gridk
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8", "-ksp_max_it", "60"]
    if cycle == "f32":
        args += ["-pc_mg_dtype", "single"]
    res = {}
    for dev in ("cpu", "cuda"):
        ptt.init(args=args, device=dev)
        chip_smoke.reset_launches()
        A = stencil_build.as_mat(*stencil_build.build_dnd((32,) * 3, kind="box"))
        ksp = chip_smoke.gamg_ksp(ptt, A)
        b = A.createVecLeft()
        b.set(1.0)
        ksp.solve(b)
        levels = ksp.getPC()._impl.levels
        res[dev] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                    ksp.getConvergenceHistory(), chip_smoke.launch_counts(),
                    [lev.A.getSize()[0] for lev in levels], [lev.A.meta[0] for lev in levels],
                    [lev.emax for lev in levels[:-1]], levels)
    its, reason, hist, launches, rows, kinds, emax, levels = res["cuda"]
    assert its == res["cpu"][0] == 8 and reason == res["cpu"][1] == "CONVERGED_RTOL"
    assert rows == res["cpu"][4] == [32768, 4096, 512, 56, 5] and kinds == res["cpu"][5]
    np.testing.assert_allclose(hist, res["cpu"][2], rtol=1e-10 if cycle == "f64" else 1e-4,
                               atol=0)
    np.testing.assert_allclose(emax, res["cpu"][6], rtol=1e-10 if cycle == "f64" else 1e-4)
    need = chip_smoke.grid_launches_needed(its, levels)
    assert {k: launches[k] for k in need} == need
    assert need["dnd_stencil"] > 0 and need["q1_prolong"] > 0 and need["q1_restrict"] > 0
    assert launches["gather"] == 0 and gk2.LAUNCHES["gather"] == 0
    assert gridk.LAUNCHES["dnd_stencil"] == need["dnd_stencil"]


def _v1_plan_stencil(shape, kind, dtype, device, seed=1):
    """(offsets, constants, planes) of the stencils that pick V1's kernel:
    the box in slot order (all planes; planes mixed with constants; planes
    one element past a 16-byte edge), the 3-D star sorted into slot order,
    and for the generic kernel the box reversed, the star in build order
    and a radius-2 star."""
    from itertools import product
    rng = np.random.default_rng(seed)
    nd = len(shape)
    box = list(product((-1, 0, 1), repeat=nd))
    star = [tuple(o) for o in stencil_build.stencil_offsets(nd, "star")]
    offs = {"box": box, "mixed": box, "misaligned": box, "sorted star": sorted(star),
            "reversed": box[::-1], "star": star,
            "radius 2": [(0,) * nd] + [tuple(d if a == ax else 0 for a in range(nd))
                                       for ax in range(nd) for d in (-2, -1, 1, 2)]}[kind]
    consts = tuple(float(rng.standard_normal()) if kind == "mixed" and k % 2 else None
                   for k in range(len(offs)))
    nvar = sum(c is None for c in consts)
    vals = torch.as_tensor(rng.standard_normal(nvar * int(np.prod(shape)) + 1), dtype=dtype,
                           device=device)
    coef = (vals[1:] if kind == "misaligned" else vals[:-1]).view((nvar,) + tuple(shape))
    return offs, consts, coef


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind,kernel", (
    ((64, 64, 64), "box", "window"), ((32, 32, 32), "box", "window"),
    ((16, 16, 16), "box", "window"), ((65, 65, 65), "box", "window"),
    ((9, 8, 7), "mixed", "window"), ((12, 11), "box", "window"), ((33,), "box", "window"),
    ((5, 6, 7), "sorted star", "window"), ((8, 8, 8), "misaligned", "window"),
    ((9, 8, 7), "reversed", "generic"), ((16, 16, 16), "radius 2", "generic"),
    ((12, 11), "star", "generic")))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_v1_kernels_equal_plain_bit_for_bit(cuda_device, dtype, shape, kind, kernel):
    """Both V1 kernels, as the plan picks them, equal the plain version bit
    for bit on the card: the window kernel (vector and scalar variants,
    1-D to 3-D grids, planes and constants) and the generic kernel."""
    from petsc_tpu_torch.ops import grid_kernels as gridk
    offs, consts, coef = _v1_plan_stencil(shape, kind, dtype, cuda_device)
    fn = gridk.dnd_stencil_fn(shape, offs, consts, coef)
    assert fn.kernel == kernel
    x = torch.rand(int(np.prod(shape)), dtype=dtype, device=cuda_device)
    gridk.reset_launches()
    k = fn(x)
    p = gridk.dnd_stencil_plain(x, shape, offs, consts, coef)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert gridk.LAUNCHES == {"dnd_stencil": 1, "dnd_stencil_t": 0, "q1_prolong": 0, "q1_restrict": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("fshape", ((128, 128, 128), (129, 129, 129), (64, 64, 64), (9, 8, 6),
                                    (9, 8, 7), (8, 6), (9, 7), (1, 5), (128,), (17,), (1,)))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_q1_prolong_equals_plain_bit_for_bit(cuda_device, dtype, fshape):
    """Q1P's per-cell kernel equals the per-axis composition bit for bit on
    the card, with pair stores (even f2) and scalar ones (odd f2)."""
    from petsc_tpu_torch.ops import grid_kernels as gridk
    cshape = tuple((s + 1) // 2 for s in fshape)
    xc = torch.rand(int(np.prod(cshape)), dtype=dtype, device=cuda_device)
    gridk.reset_launches()
    k = gridk.q1_prolong(xc, fshape)
    p = gridk.q1_prolong_plain(xc, fshape)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert gridk.LAUNCHES == {"dnd_stencil": 0, "dnd_stencil_t": 0, "q1_prolong": 1, "q1_restrict": 0}


def _trisolve_plans(case, device):
    """{name: Sweep} of one case's factors on `device`."""
    from petsc_tpu_torch.mat import factor
    from petsc_tpu_torch.ops import trisolve
    if case in ("cluster capacity", "one row over"):
        width = trisolve._CLUSTER_BLOCKS * trisolve._CLUSTER_THREADS + (case == "one row over")
        return {"wide": chip_smoke.wide_sweep(width, device)}
    if case == "one level":
        m = 300_001        # more rows than one wave of T1's grid holds threads
        return {"diag": trisolve.make_sweep(np.zeros(m + 1, dtype=np.int64),
                                            np.zeros(0, dtype=np.int64), np.zeros(0),
                                            lower=True, scale=np.linspace(0.5, 2.0, m),
                                            device=device)}
    if case == "ILU(2) random":
        n = 700
        R = sp.random(n, n, density=0.01, format="csr", random_state=4)
        A = (R + sp.diags(np.full(n, 5.0))).tocsr()
    else:
        shape = {"LU": (3, 8, 9), "498 levels": (22, 40, 438)}.get(case, (5, 13, 17))
        i, j, v = stencil_build.stencil7_coo(*shape)
        n = int(np.prod(shape))
        A = sp.csr_matrix((v, (i, j)), shape=(n, n))
    A.sort_indices()
    if case == "LU":
        L, U, dinv = factor.splu_factors(A)[:3]
    else:
        L, U, dinv = factor.iluk(A.indptr, A.indices, A.data, 2 if "ILU(2)" in case else 0)
    if case == "float32 factor":      # SOR's sweeps under -real_dtype f32
        return {"L32": trisolve.make_sweep(*L, lower=True, dtype=torch.float32, device=device)}
    _, data = trisolve.make_trisolve_plan(L, U, dinv, device=device)
    data.update(trisolve.make_transpose_tables(L, U, dinv, device=device))
    return data


# the variant that the plan gives each case's sweeps
_TRISOLVE_VARIANT = {"stencil7 ILU(0)": "cluster", "ILU(2) random": "cluster", "LU": "cluster",
                     "one level": "grid", "float32 factor": "cluster",
                     "cluster capacity": "cluster", "one row over": "grid",
                     "498 levels": "cluster"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", tuple(_TRISOLVE_VARIANT))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_trisolve_kernel_equals_plain(cuda_device, dtype, case):
    """T1 equals its plain version bit for bit on every sweep of a case
    (ILU's two, the transpose's two), one launch per sweep, and a rerun
    gives the same bits; each sweep takes the case's variant, and the
    grid variant, where the plan gives the cluster, also equals the plain
    version with equal bits on reruns. The 498-level case has config 2's
    depth (22 + 40 + 438 - 2 levels)."""
    from petsc_tpu_torch.ops import trisolve
    for name, sw in _trisolve_plans(case, cuda_device).items():
        plan = trisolve.sweep_plan(sw)
        assert plan.variant == _TRISOLVE_VARIANT[case], name
        if case == "498 levels":
            assert sw.nlev == 498
        b = torch.rand(sw.m, device=cuda_device, dtype=torch.float64).to(dtype) + 0.5
        trisolve.reset_launches()
        k = trisolve.trisolve_sweep(sw, b)
        torch.cuda.synchronize()
        assert trisolve.LAUNCHES["trisolve"] == 1
        p = trisolve.trisolve_sweep_plain(sw, b)
        assert k.dtype == dtype and torch.equal(k, p), (name, _rel(k.double(), p.double()))
        for _ in range(5):
            assert torch.equal(trisolve.trisolve_sweep(sw, b), k)
        if plan.variant == "cluster":
            grid = trisolve.sweep_plan(sw, max_blocks=0)
            scratch = {"trisolve": 0}
            for _ in range(6):
                g = torch.empty_like(b)
                trisolve._launch(scratch, sw, b, g, grid)
                assert torch.equal(g, p), (name, "grid", _rel(g.double(), p.double()))
            assert scratch["trisolve"] == 6 and trisolve.LAUNCHES["trisolve"] == 6


@pytest.mark.cuda
def test_trisolve_launch_config_reports_the_plan(cuda_device):
    """launch_config reports the plan's variant and what the card makes of
    it: a sweep at the cluster's capacity in one placeable cluster of 16
    blocks of 512 threads, one row per thread, no spills (config 2's widest
    level, 5,137 rows, takes 15 blocks of 352); the one-level diagonal in
    the grid variant, capped at what the card holds at once."""
    from petsc_tpu_torch.ops import trisolve
    sw = _trisolve_plans("cluster capacity", cuda_device)["wide"]
    for dtype in (torch.float64, torch.float32):
        cfg = trisolve.launch_config(sw, dtype, cuda_device)
        assert (cfg["variant"], cfg["cluster"], cfg["grid"], cfg["threads"],
                cfg["rows_per_thread"]) == ("cluster", 16, 16, 512, 1)
        assert cfg["clusters_that_fit"] >= 1 and cfg["spill_bytes"] == 0
    plan = trisolve._plan(5137, 3, trisolve._CLUSTER_BLOCKS)
    assert (plan.variant, plan.blocks, plan.threads) == ("cluster", 15, 352)
    diag = _trisolve_plans("one level", cuda_device)["diag"]
    cfg = trisolve.launch_config(diag, torch.float64, cuda_device)
    assert cfg["variant"] == "grid" and cfg["cluster"] == 0 and cfg["threads"] == 256
    assert cfg["grid"] <= cfg["sms"] * cfg["blocks_per_sm"]
    assert cfg["rows_per_thread"] == -(-diag.width // (cfg["grid"] * 256))


@pytest.mark.cuda
def test_gmres_ilu_on_the_card_equals_the_cpu_port(cuda_device):
    """stencil7 6 x 60 x 60 with PETSc's defaults (GMRES(30) + ILU(0)) and the
    small iterative variants of chip_smoke.GMRES_SMALL: its, reason and
    history on the card equal the CPU port's (1e-10 relative: the same host
    set-up, sums in another order), the defaults' launches exact; the
    direct solve (preonly + lu, thousands of levels: too slow for the CPU's
    plain sweeps) to 1e-13 of b on the card alone."""
    import types
    from petsc_tpu_torch.ops import trisolve
    small = dict(chip_smoke.GMRES_SMALL)
    lu_opts = small.pop("preonly_lu")[0]
    cases = (("default", ((), 11, "CONVERGED_RTOL", 0, 0, 0)), *small.items())

    def port(dev):
        pt = types.SimpleNamespace(**{k: getattr(ptt, k) for k in dir(ptt)
                                      if not k.startswith("__")})
        pt.init = lambda args=None: ptt.init(args=args, device=dev)
        return pt

    for name, (opts, its, reason, _, _, _) in cases:
        res = {}
        for dev in ("cpu", "cuda"):
            chip_smoke.reset_launches()
            ksp = chip_smoke.config2_solve(port(dev), chip_smoke.CONFIG2_SMALL, opts)[0]
            res[dev] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                        ksp.getConvergenceHistory(), chip_smoke.launch_counts())
        assert res["cuda"][:2] == res["cpu"][:2] == (its, reason), name
        np.testing.assert_allclose(res["cuda"][2], res["cpu"][2], rtol=1e-10, atol=0)
        if name == "default":
            need = chip_smoke.config2_launches_needed(its)
            assert {k: res["cuda"][3][k] for k in need} == need
    chip_smoke.reset_launches()
    ksp, _, b, x, A_sp, _ = chip_smoke.config2_solve(port("cuda"), chip_smoke.CONFIG2_SMALL,
                                                    lu_opts)
    bh, xh = b.array.cpu().numpy(), x.array.cpu().numpy()
    assert ksp.getConvergedReason().name == "CONVERGED_ITS"
    assert np.linalg.norm(bh - A_sp @ xh) <= 1e-13 * np.linalg.norm(bh)
    assert trisolve.LAUNCHES["trisolve"] == 2


# ------------------------------------------------------------------ block systems

@pytest.mark.cuda
@pytest.mark.parametrize("bs", (2, 3, 4, 6, 5, 8))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_bsr_spmv_equals_plain(cuda_device, dtype, bs):
    """B1 against its plain version: equal bits (both round each step), on
    a random BSR with a row of 500 blocks and an empty row; the transpose
    through the block transpose against the dense product (1e-12 / 1e-5)."""
    from petsc_tpu_torch.ops import block_kernels as bk
    ip, bc, v, x = chip_smoke._random_bsr(700, bs, dtype, 0, long_row=(3, 500), empty_row=11)
    bk.reset_launches()
    y = bk.bsr_spmv(ip, bc, v, x)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bsr_spmv"] == 1
    assert torch.equal(y, bk.bsr_spmv_plain(ip, bc, v, x))
    assert float(y.view(-1, bs)[11].abs().max()) == 0.0
    tp, tc, tv = bk.bsr_transpose(ip, bc, v, 700)
    yt = bk.bsr_spmv(tp, tc, tv, x)
    rows = torch.repeat_interleave(torch.arange(700, device=cuda_device), ip[1:] - ip[:-1])
    dense = torch.zeros(700, bs, 700, bs, dtype=torch.float64, device=cuda_device)
    dense[rows, :, bc.long(), :] = v.double()
    want = dense.reshape(700 * bs, 700 * bs).T @ x.double()
    assert _rel(yt.double(), want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_agg_block_apply_equals_plain(cuda_device, dtype):
    """A1 against its plain version (1e-12 / 1e-5: the warp sums in another
    order than the batched product) on ragged blocks of 1 to 700 dofs,
    aggregates of a random graph with removed nodes (1 x 1 blocks)."""
    from petsc_tpu_torch.ops import block_kernels as bk
    from petsc_tpu_torch.pc.mg import _agg_blocks_host
    rng = np.random.default_rng(3)
    nnode, bs = 600, 3
    agg = rng.integers(-1, 4, nnode)
    agg[agg >= 0] = rng.integers(0, 40, int((agg >= 0).sum()))
    agg[:700 // bs] = 40                      # one aggregate of 699 dofs
    n = nnode * bs
    A = sp.random(n, n, density=0.02, random_state=4, format="csr")
    A = (A + A.T + n * sp.eye(n)).tocsr()
    dof_lists, inv = _agg_blocks_host(A, agg, bs)
    tab = bk.agg_block_tables(dof_lists, inv, cuda_device, dtype)
    r = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda_device)
    bk.reset_launches()
    z = bk.agg_block_apply(tab, r)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["agg_block_apply"] == 1
    assert _rel(z, bk.agg_block_apply_plain(tab, r)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("bs", (2, 3, 4, 5, 6))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_bsr_spmv_chunk_edges_equal_bits(cuda_device, dtype, bs):
    """B1 on 30,000 block rows (a full grid of thread blocks): rows of 1
    to 7 blocks, one of 500 blocks across several chunks, an empty row;
    equal bits with the plain version, on two launches, one launch counted
    per call; the card's chunk is the plan's, and rows cross its edges."""
    from petsc_tpu_torch.ops import block_kernels as bk
    ip, bc, v, x = chip_smoke._random_bsr(30000, bs, dtype, bs, long_row=(777, 500),
                                          empty_row=4321)
    cfg = bk.bsr_launch_config(bc.numel(), bs, dtype, cuda_device)
    assert cfg["chunk"] == bk.bsr_chunk(bs) and cfg["grid"] > 1
    plan = bk.bsr_plan(ip.cpu().numpy(), bs, cfg["grid"])
    edges = {b for ch in plan["chunks"] for _, b in ch}
    ptr = ip.cpu().numpy()
    assert any(ptr[i] < e < ptr[i + 1] for e in edges for i in (np.searchsorted(ptr, e) - 1,))
    bk.reset_launches()
    y1 = bk.bsr_spmv(ip, bc, v, x)
    y2 = bk.bsr_spmv(ip, bc, v, x)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bsr_spmv"] == 2
    assert torch.equal(y1, bk.bsr_spmv_plain(ip, bc, v, x)) and torch.equal(y1, y2)
    assert float(y1.view(-1, bs)[4321].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_agg_block_apply_large_and_unit_blocks(cuda_device, dtype):
    """A1 on blocks of 1 (loose dofs), 3, 17, 300 and 1,900 dofs: one
    launch per call, within 1e-12 / 1e-5 of its plain version."""
    from petsc_tpu_torch.ops import block_kernels as bk
    rng = np.random.default_rng(7)
    ks = [1] * 50 + [3] * 40 + [17] * 5 + [300] * 2 + [1900]
    perm = rng.permutation(sum(ks))
    dptr = np.concatenate([[0], np.cumsum(ks)])
    dof_lists = [np.sort(perm[a:b]) for a, b in zip(dptr[:-1], dptr[1:])]
    inv = np.concatenate([rng.standard_normal(k * k) for k in ks])
    tab = bk.agg_block_tables(dof_lists, inv, cuda_device, dtype)
    r = torch.as_tensor(rng.standard_normal(sum(ks)), dtype=dtype, device=cuda_device)
    bk.reset_launches()
    z = bk.agg_block_apply(tab, r)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["agg_block_apply"] == 1
    assert _rel(z, bk.agg_block_apply_plain(tab, r)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_cheby_z_modes_equal_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n = 65536 + 7
    p, x, z = (torch.rand(n, generator=gen, device=cuda_device, dtype=dtype) for _ in range(3))
    pk.reset_launches()
    for mode, kw in (("first_z", {}), ("step_z", {"a": 0.7})):
        pk_, xk = p.clone(), x.clone()
        pp, xp = p.clone(), x.clone()
        pk.cheby_update_z(mode, pk_, xk, z, 0.3, beta=0.9, **kw)
        pk.cheby_update_z_plain(mode, pp, xp, z, 0.3, beta=0.9, **kw)
        assert _rel(pk_, pp) <= TOL[dtype] and _rel(xk, xp) <= TOL[dtype]
    torch.cuda.synchronize()
    assert pk.LAUNCHES["cheby_update_z"] == 2 and pk.LAUNCHES["cheby_update"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("first_z", "step_z"))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_agg_block_cheby_equals_a1_then_c1z(cuda_device, dtype, mode):
    """A1's fused Chebyshev step on blocks of 1 to 700 dofs (every mapping
    of the kernel): one launch per call and no other, equal bits with A1
    followed by C1's z mode, within 1e-12 / 1e-5 of its plain version on
    p and x."""
    from petsc_tpu_torch.ops import block_kernels as bk
    tab = chip_smoke.ragged_agg_tables(cuda_device, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    r, p0, x0 = (torch.rand(tab["dofs"].numel(), generator=gen, device=cuda_device,
                            dtype=dtype) for _ in range(3))
    kw = chip_smoke.AGG_CHEBY_KW[mode]
    p, x = p0.clone(), x0.clone()
    chip_smoke.reset_launches()
    bk.agg_block_cheby(tab, r, mode, p, x, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in chip_smoke.launch_counts().items() if v} == {"agg_block_cheby": 1}
    p2, x2 = p0.clone(), x0.clone()
    pk.cheby_update_z(mode, p2, x2, bk.agg_block_apply(tab, r), **kw)
    assert torch.equal(p, p2) and torch.equal(x, x2)
    pp, xp = p0.clone(), x0.clone()
    bk.agg_block_cheby_plain(tab, r, mode, pp, xp, **kw)
    assert _rel(p, pp) <= TOL[dtype] and _rel(x, xp) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("defaults", "knobs"))
def test_ex56_on_the_card_equals_the_cpu_port(cuda_device, mode):
    """ex56 at ne 6 through the port's example program on the card and on the CPU:
    the same iterations and history to 1e-10 relative; the block product
    launched and, with the knob set, the aggregate-block smoother's fused
    step, two per level and application, with no A1 alone and no C1z."""
    from petsc_tpu_torch.examples import ex56
    args = ["-ne", "6"] + (["-ksp_type", "cg", "-pc_type", "gamg"] if mode == "defaults"
                           else chip_smoke.EX56_KNOBS)
    out = {}
    for dev in ("cpu", None):
        chip_smoke.reset_launches()
        ksp = ex56.main(list(args), device=dev)
        out[dev] = (ksp.getIterationNumber(), np.asarray(ksp.getConvergenceHistory()),
                    chip_smoke.launch_counts())
    assert out["cpu"][0] == out[None][0]
    assert np.max(np.abs(out[None][1] - out["cpu"][1]) / out["cpu"][1]) <= 1e-10
    assert out[None][2]["bsr_spmv"] >= out[None][0]
    if mode == "knobs":
        fine = len(ksp.getPC()._impl.levels) - 1
        assert out[None][2]["agg_block_cheby"] == 2 * fine * (out[None][0] + 1)
        assert out[None][2]["agg_block_apply"] == out[None][2]["cheby_update_z"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fshape,dof", (((65, 65, 65), 3), ((9, 8, 6), 3), ((9, 9), 2),
                                        ((8, 6), 2), ((17,), 2), ((2, 2, 2), 4),
                                        ((3, 5, 130), 2)))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_q1_dof_kernels_match_plain(cuda_device, dtype, fshape, dof):
    """Q1P and Q1R with dof > 1 components per point (the kernels' dof
    entries) against their plain versions on the card, even and odd sizes
    (1e-13 in f64, 1e-6 in f32), and against the assembled kron(P, I_dof)
    in float64; one launch each, counted as Q1P and Q1R."""
    from petsc_tpu_torch.dm.interp import MatInterpQ1
    from petsc_tpu_torch.ops import grid_kernels as gridk
    cshape = tuple((s + 1) // 2 for s in fshape)
    xc = torch.rand(int(np.prod(cshape)) * dof, dtype=dtype, device=cuda_device)
    xf = torch.rand(int(np.prod(fshape)) * dof, dtype=dtype, device=cuda_device)
    gridk.reset_launches()
    kp, kr = gridk.q1_prolong(xc, fshape, dof), gridk.q1_restrict(xf, fshape, dof)
    pp, pr = gridk.q1_prolong_plain(xc, fshape, dof), gridk.q1_restrict_plain(xf, fshape, dof)
    torch.cuda.synchronize()
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    assert _rel(kp, pp) <= tol and _rel(kr, pr) <= tol
    P = MatInterpQ1(fshape, cshape, dof=dof).to_scipy()
    assert _rel(kp.double(), torch.as_tensor(P @ xc.double().cpu().numpy(),
                                             device=cuda_device)) <= tol
    assert _rel(kr.double(), torch.as_tensor(P.T @ xf.double().cpu().numpy(),
                                             device=cuda_device)) <= tol
    assert gridk.LAUNCHES == {"dnd_stencil": 0, "dnd_stencil_t": 0, "q1_prolong": 1, "q1_restrict": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("pc", ("mg", "gamg", "dof3"))
def test_ex45_on_the_card_equals_the_cpu_port(cuda_device, pc):
    """PETSc's ex45 at 17^3 (mg: PCMG from the DM, rediscretized; gamg: the
    structured head on the DM's grid) and its dof-3 form at 9^3 (PCMG from
    the DM, Galerkin): the same its, hierarchy and history (1e-10) on the
    card as in the CPU port, and every launch as
    chip_smoke.ex45_launches_needed counts it."""
    from petsc_tpu_torch.examples import ex45
    res = {}
    for dev in ("cpu", "cuda"):
        chip_smoke.reset_launches()
        if pc == "dof3":
            ptt.init(args=["-ksp_type", "cg", "-ksp_rtol", "1e-8", "-pc_type", "mg"], device=dev)
            da = ptt.DMDA.create(3, (9, 9, 9), dof=3)
            A = da.createMatrix()
            i, j, v = ex45.component_laplacian(da)
            A.setPreallocationCOO(i, j)
            A.setValuesCOO(v)
            ksp = ptt.KSP().create()
            ksp.setOperators(A)
            ksp.setFromOptions()
            b = A.createVecLeft()
            b.set(1.0)
            ksp.solve(b)
        else:
            ksp = ex45.main(["-da_grid_x", "17", "-da_grid_y", "17", "-da_grid_z", "17",
                             "-ksp_type", "cg", "-ksp_rtol", "1e-8", "-pc_type", pc],
                            device=dev)
        levels = ksp.getPC()._impl.levels
        res[dev] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                    ksp.getConvergenceHistory(), chip_smoke.launch_counts(),
                    [lev.A.getSize()[0] for lev in levels], [lev.A.meta[0] for lev in levels],
                    levels)
    its, reason, hist, launches, rows, kinds, levels = res["cuda"]
    assert its == res["cpu"][0] and reason == res["cpu"][1] == "CONVERGED_RTOL"
    assert rows == res["cpu"][4] and kinds == res["cpu"][5]
    np.testing.assert_allclose(hist, res["cpu"][2], rtol=1e-10, atol=0)
    need = chip_smoke.ex45_launches_needed(its, levels, pc)
    if pc != "dof3":
        need["dnd_stencil"] += 1          # ex45's main: A x for the printed residual
    assert {k: launches[k] for k in need} == need


def _spmm_csr(m, n, seed, dtype, device):
    """A random m x n CSR, row 1 longer than a warp (100 entries), rows 2
    and m - 1 empty, on the card."""
    A = sp.random(m, n, density=min(1.0, 7.0 / n), random_state=seed, format="lil")
    rng = np.random.default_rng(seed)
    A[1, :] = 0
    A[1, rng.choice(n, min(100, n), replace=False)] = 1.0
    A[2, :] = 0
    A[m - 1, :] = 0
    A = A.tocsr()
    A.sort_indices()
    A.data = rng.standard_normal(A.nnz)
    return A, (torch.as_tensor(A.indptr.astype(np.int64), device=device),
               torch.as_tensor(A.indices.astype(np.int32), device=device),
               torch.as_tensor(A.data, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 2, 3, 4, 5, 8, 9, 11, 16))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_csr_spmm_matches_plain(cuda_device, dtype, k):
    """M1 against its plain version in float64 on the same inputs (f64 to
    1e-12, f32 to 1e-5), scipy in f64, equal bits on a rerun; one launch
    per tile of 8 columns."""
    A, (ip, col, vals) = _spmm_csr(3001, 2003, k, dtype, cuda_device)
    X_np = np.random.default_rng(k).standard_normal((2003, k))
    X = torch.as_tensor(X_np, dtype=dtype, device=cuda_device)
    pk.reset_launches()
    Y = pk.csr_spmm(ip, col, vals, X)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["csr_spmm"] == -(-k // pk.SPMM_TILE)
    assert Y.shape == (3001, k) and Y.dtype == dtype
    p = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
    assert _rel(Y.double(), p) <= TOL[dtype]
    if dtype == torch.float64:
        assert _rel(Y.cpu(), torch.as_tensor(A @ X_np)) <= 1e-12
    assert torch.count_nonzero(Y[2]) == 0 and torch.count_nonzero(Y[-1]) == 0
    assert torch.equal(Y, pk.csr_spmm(ip, col, vals, X))


@pytest.mark.cuda
@pytest.mark.parametrize("k", chip_smoke.M1_EDGE_KS)
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_csr_spmm_at_its_chunk_edges(cuda_device, dtype, k):
    """M1 on chip_smoke.m1_edge_cases: rows across several chunk edges,
    a row of 50 chunks, empty rows at a chunk edge and in runs, entries that
    end on an edge, nnz = 0 and m = 0; each against the plain version in
    float64 (f64 1e-12, f32 1e-5), with equal bits on a rerun and with vals
    and col one element past a 16-byte edge, one launch per tile of 8
    columns (none for m = 0); and with X one element (f32: also two) past a
    16-byte edge, the one-value and 8-byte loads."""
    for name in chip_smoke.m1_edge_cases(k, dtype.itemsize):
        chip_smoke.m1_edge_check(pk, name, k, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 3, 4, 8))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_csr_spmm_on_the_explicit_transpose(cuda_device, dtype, k):
    """M1 on the explicit transpose of csr_transpose_of (columns from a
    device sort, values one K8 gather) against scipy's A^T X and the plain
    version in float64, equal bits on a rerun, one launch."""
    from petsc_tpu_torch.mat.aij import csr_transpose_of
    A, (ip, col, vals) = _spmm_csr(3001, 2003, 7 + k, dtype, cuda_device)
    tip, tcol, tvals = csr_transpose_of({"indptr": ip, "col": col, "vals": vals}, 2003)
    X_np = np.random.default_rng(k).standard_normal((3001, k))
    X = torch.as_tensor(X_np, dtype=dtype, device=cuda_device)
    pk.reset_launches()
    Y = pk.csr_spmm(tip, tcol, tvals, X)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["csr_spmm"] == 1 and Y.shape == (2003, k)
    assert _rel(Y.double(), pk.csr_spmm_plain(tip, tcol, tvals.double(), X.double())) <= TOL[dtype]
    if dtype == torch.float64:
        assert _rel(Y.cpu(), torch.as_tensor(A.T @ X_np)) <= 1e-12
    assert torch.equal(Y, pk.csr_spmm(tip, tcol, tvals, X))


@pytest.mark.cuda
def test_csr_mult_transpose_runs_s2_on_the_explicit_transpose(cuda_device):
    """The CSR transpose product on the card is S2 on A^T (its pattern
    built once, its values one K8 gather refreshed after setValuesCOO),
    never index_add_; MatMAIJ's transpose is M1 on the same arrays."""
    ptt.init(device="cuda")
    A_sp, _ = _spmm_csr(500, 300, 4, torch.float64, "cpu")
    coo = A_sp.tocoo()
    A = ptt.MatAIJ()
    A.setSizes((500, 300))
    A.setPreallocationCOO(coo.row, coo.col)
    A.setValuesCOO(coo.data)
    x = np.random.default_rng(2).standard_normal(500)
    y = A.createVecRight()
    pk.reset_launches()
    gk.reset_launches()
    A.multTranspose(ptt.Vec.from_array(x), y)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["csr_spmv"] == 1 and gk.LAUNCHES["gather"] == 1
    assert _rel(y.array.cpu(), torch.as_tensor(A_sp.T @ x)) <= 1e-12
    A.multTranspose(ptt.Vec.from_array(x), y)
    assert gk.LAUNCHES["gather"] == 1          # the transposed values are kept
    v2 = np.random.default_rng(3).standard_normal(coo.nnz)
    A.setValuesCOO(v2)
    gk.reset_launches()
    A.multTranspose(ptt.Vec.from_array(x), y)
    B = sp.csr_matrix((v2, (coo.row, coo.col)), shape=(500, 300))
    assert gk.LAUNCHES["gather"] == 1
    assert _rel(y.array.cpu(), torch.as_tensor(B.T @ x)) <= 1e-12
    from petsc_tpu_torch.mat.utility import MatMAIJ
    M = MatMAIJ.create(A, 3)
    xm = np.random.default_rng(5).standard_normal(1500)
    ym = M.createVecRight()
    pk.reset_launches()
    M.multTranspose(ptt.Vec.from_array(xm), ym)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["csr_spmm"] == 1 and pk.LAUNCHES["csr_spmv"] == 0
    assert _rel(ym.array.cpu(), torch.as_tensor((B.T @ xm.reshape(500, 3)).reshape(-1))) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("fischer", "pod"))
def test_guess_on_the_card_equals_the_cpu_port(cuda_device, kind):
    """KSPGuess over five solves (the guess keeps two, so the oldest is
    dropped) on the card and on the CPU: the same iterations, histories to
    1e-10 relative; the stored vectors stay on the card, and an update
    launches one product and, for Fischer with n stored pairs, n + 2 dot2
    and 2 n triads (POD: its Gram rows on torch.mv)."""
    i, j, v = stencil_build.stencil7_coo(4, 10, 10)
    n = 400
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    k = np.arange(n)
    rhs = [A_sp @ (np.cos(0.01 * k) + 0.01 * np.sin(0.05 * s * k)) for s in range(5)]
    out = {}
    for dev in ("cpu", "cuda"):
        ptt.init(args=["-ksp_type", "gmres", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"],
                 device=dev)
        A = ptt.MatAIJ()
        A.setSizes(n)
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        ksp = ptt.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        guess = ksp.setGuessType(kind, 2)
        runs = []
        for b in rhs:
            x = A.createVecRight()
            ksp.solve(ptt.Vec.from_array(b), x)
            runs.append((ksp.getIterationNumber(), np.asarray(ksp.getConvergenceHistory())))
        out[dev] = runs
    for (ic, hc), (ig, hg) in zip(out["cpu"], out["cuda"]):
        assert ic == ig
        assert np.max(np.abs(hg - hc) / hc) <= 1e-10
    blocks = (guess._S, guess._AS) if kind == "pod" else (guess._Q, guess._X)
    assert all(blk.is_cuda for blk in blocks) and guess._n == 2
    chip_smoke.reset_launches()
    guess.update(x.array, ptt.Vec.from_array(rhs[-1]).array)
    torch.cuda.synchronize()
    counts = {key: c for key, c in chip_smoke.launch_counts().items() if c}
    want = {"csr_spmv": 1} if kind == "pod" else {"csr_spmv": 1, "dot2": 4, "triad": 4}
    assert counts == want


# ---- X1, D1 and N1 (the domain-decomposition PCs' kernels) ----

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["add", "set", "signed"])
def test_dst_scatter_equals_its_plain_version_bit_for_bit(cuda_device, mode):
    from petsc_tpu_torch.ops import pc_kernels as pck
    rng = np.random.default_rng(31)
    n, nsrc, k = 5000, 7000, 20000
    if mode == "set":
        dst, sel, w = rng.permutation(n)[:3000], rng.integers(0, nsrc, 3000), None
    else:
        dst, sel = rng.integers(0, n, k), rng.integers(0, nsrc, k)
        w = rng.choice([-1.0, 1.0], k) if mode == "signed" else None
    for dtype in (torch.float64, torch.float32):
        tab = pck.scatter_table(dst, sel, n, nsrc, w, device=cuda_device, dtype=dtype)
        src = torch.as_tensor(rng.random(nsrc) - 0.5, dtype=dtype, device=cuda_device)
        out = torch.as_tensor(rng.random(n), dtype=dtype, device=cuda_device) \
            if mode == "set" else None
        pck.reset_launches()
        y = pck.dst_scatter(tab, src, None if out is None else out.clone())
        yp = pck.dst_scatter_plain(tab, src, None if out is None else out.clone())
        assert pck.LAUNCHES["dst_scatter"] == 1
        assert torch.equal(y, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_subdomain_apply_matches_its_plain_version(cuda_device, transposed, dtype):
    from petsc_tpu_torch.ops import pc_kernels as pck
    rng = np.random.default_rng(32)
    ns, R, C, nx = 37, 1089, 70 if transposed else 1089, 30000
    M = torch.as_tensor(rng.random((ns, R, C)) - 0.5, dtype=dtype, device=cuda_device)
    K = R if transposed else C
    G = rng.integers(0, nx, (ns, K))
    nr = rng.integers(R // 2, R + 1, ns)
    nc = rng.integers(C // 2, C + 1, ns)
    Mh = M.cpu().numpy()
    for s in range(ns):                 # padding is zero, as the tables lay it out
        Mh[s, nr[s]:, :] = 0
        Mh[s, :, nc[s]:] = 0
    M = torch.as_tensor(Mh, device=cuda_device)
    tab = pck.subdomain_table(G, rng.random((ns, K)), nr=nr, nc=nc, device=cuda_device,
                              dtype=dtype)
    x = torch.as_tensor(rng.random(nx), dtype=dtype, device=cuda_device)
    y = pck.subdomain_apply(M, tab, x, transposed)
    yp = pck.subdomain_apply_plain(M, tab, x, transposed)
    assert _rel(y, yp) <= TOL[dtype]
    if not transposed:                  # an output map, accumulated into a buffer
        out = np.stack([rng.permutation(R + 5)[:R] for _ in range(ns)])
        out[:, ::7] = -1
        tab = pck.subdomain_table(G, None, out=out, nr=nr, nc=nc, device=cuda_device,
                                  dtype=dtype)
        base = torch.as_tensor(rng.random((ns, R + 5)), dtype=dtype, device=cuda_device)
        y = pck.subdomain_apply(M, tab, x, y=base.clone(), accumulate=True)
        yp = pck.subdomain_apply_plain(M, tab, x, y=base.clone(), accumulate=True)
        assert _rel(y, yp) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(chip_smoke.D1_EDGES))
def test_subdomain_apply_at_the_shapes_where_its_design_breaks(cuda_device, name, dtype):
    """D1 on chip_smoke.D1_EDGES: rows of 1,089 (8 mod 16 bytes in f64, 4
    in f32), subdomain bases and M off a 16-byte edge, a one-row tail, one
    row, C = 1, 4, 16, 17, 33 and 70 in both forms, nr < R and nc < C with
    NaN padding, an output map with -1 slots and accumulate; to 1e-12 /
    1e-5 of the plain version in float64, one launch, equal bits on a
    rerun and under another grid."""
    from petsc_tpu_torch.ops import pc_kernels as pck
    chip_smoke.d1_edge_check(pck, name, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(chip_smoke.X1_EDGES))
def test_dst_scatter_at_the_shapes_where_its_design_breaks(cuda_device, name, dtype):
    """X1 on chip_smoke.X1_EDGES: random entries in each mode, a
    destination of 5,000 entries (a warp of the long part), runs at the
    long-run threshold, runs of 0 to 40, destinations that no entry reaches
    in set mode; equal bits with the plain version, one launch, equal bits
    on a rerun and under another grid."""
    from petsc_tpu_torch.ops import pc_kernels as pck
    chip_smoke.x1_edge_check(pck, name, dtype)


@pytest.mark.cuda
def test_neumann_step_equals_its_plain_version_bit_for_bit(cuda_device):
    from petsc_tpu_torch.ops import pc_kernels as pck
    rng = np.random.default_rng(33)
    for dtype in (torch.float64, torch.float32):
        d, y, w = (torch.as_tensor(rng.random(100003), dtype=dtype, device=cuda_device)
                   for _ in range(3))
        assert torch.equal(pck.neumann_step(d, y, w), pck.neumann_step_plain(d, y, w))


@pytest.mark.cuda
def test_matis_on_the_card_equals_the_cpu_port(cuda_device):
    """One MatIS product on the card (D1 then X1, nothing else) against the
    port's run on the CPU (gather, einsum, index_add_)."""
    mats, maps, n = stencil_build.matis_poisson(64, 4)
    x = np.random.default_rng(34).random(n)
    out = {}
    for dev in ("cpu", "cuda"):
        ptt.init(device=dev)
        M = ptt.MatIS.create(n, mats, maps)
        xt = torch.as_tensor(x, device=dev)
        chip_smoke.reset_launches()
        out[dev] = M.op().mult(xt).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k: c for k, c in chip_smoke.launch_counts().items() if c}
            assert counts == {"subdomain_apply": 1, "dst_scatter": 1}
    assert _rel(out["cuda"], out["cpu"]) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dst_scatter_min_mode_equals_its_plain_version_bit_for_bit(cuda_device, dtype):
    """X1's min mode (FVPlex's limiter): out[d] = min(out[d], its entries)
    in one launch, equal bits with the plain version, on random entries,
    a destination of 5,000 entries (the long part), NaN sources and
    destinations no entry reaches (they keep out)."""
    from petsc_tpu_torch.ops import pc_kernels as pck
    rng = np.random.default_rng(35)
    n, nsrc = 5000, 7000
    dst = rng.permutation(np.r_[np.full(5000, 17), rng.integers(0, n // 2, 20000)])
    sel = rng.integers(0, nsrc, len(dst))
    for w in (None, rng.random(len(dst)) - 0.5):
        tab = pck.scatter_table(dst, sel, n, nsrc, w, device=cuda_device, dtype=dtype)
        src = torch.as_tensor(rng.random(nsrc) - 0.5, dtype=dtype, device=cuda_device)
        src[::997] = float("nan")
        out = torch.as_tensor(rng.random(n), dtype=dtype, device=cuda_device)
        pck.reset_launches()
        y = pck.dst_scatter(tab, src, out.clone(), mode="min")
        yp = pck.dst_scatter_plain(tab, src, out.clone(), "min")
        assert pck.LAUNCHES["dst_scatter"] == 1
        assert torch.equal(torch.nan_to_num(y, nan=7.0), torch.nan_to_num(yp, nan=7.0))
        assert torch.equal(y[n // 2:], out[n // 2:])      # reached by no entry


@pytest.mark.cuda
def test_ds_assembly_on_the_card_equals_the_cpu_port(cuda_device):
    """The DS's residual (K8, the batched element kernel, X1 add), element
    Jacobians and COO Jacobian (ex12's route: K8, X1, setValuesCOO) on the
    card against the port on the CPU, 1e-12 relative; the residual's
    launches one K8 and one X1."""
    from petsc_tpu_torch.dm.fe import DS, lagrange_fe
    from petsc_tpu_torch.dm.plex import DMPlex
    from petsc_tpu_torch.examples import ex12
    out = {}
    for dev in ("cpu", "cuda"):
        ptt.init(device=dev)
        ds = DS(DMPlex.createBoxMesh((16, 16)), lagrange_fe(2, 2))
        ds.setResidual(f0=lambda u, gu, x: -ex12.forcing(x),
                       f1=lambda u, gu, x: (1.0 + u * u) * gu)
        u = torch.as_tensor(np.random.default_rng(36).standard_normal(ds.ndof), device=dev)
        chip_smoke.reset_launches()
        F = ds.assembleResidual(u)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: c for k, c in chip_smoke.launch_counts().items() if c} == \
                {"gather": 1, "dst_scatter": 1}
        P = ptt.MatAIJ()
        P.setSizes((ds.ndof, ds.ndof))
        bnd = ds.boundary_dofs(lambda x: x.min() < 1e-9 or x.max() > 1 - 1e-9)
        ds.assembleJacobianCOO(u, P, bnd)
        out[dev] = (F.cpu(), ds.elementJacobians(u).cpu(), P.to_scipy())
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-12
    assert _rel(out["cuda"][1], out["cpu"][1]) <= 1e-12
    d = (out["cuda"][2] - out["cpu"][2]).tocsr()
    assert abs(d).max() <= 1e-12 * abs(out["cpu"][2]).max()
    assert out["cuda"][2].nnz == out["cpu"][2].nnz


@pytest.mark.cuda
def test_fvplex_rhs_on_the_card_equals_the_cpu_port(cuda_device):
    """FVPlex's second-order right-hand side (eleven K8, X1 min and signed)
    on the card against the port on the CPU: 1e-12 of max|du|."""
    from petsc_tpu_torch.dm.fv_plex import FVPlex
    from petsc_tpu_torch.dm.plex import DMPlex
    out = {}
    for dev in ("cpu", "cuda"):
        ptt.init(device=dev)
        fv = FVPlex(DMPlex.createBoxMesh((40, 30)), lambda u: (u, 0.5 * u),
                    lambda uL, uR, n: n[:, 0] + 0.5 * n[:, 1], riemann="upwind", order=2)
        u = torch.as_tensor(np.random.default_rng(37).random(2400), device=dev)
        rhs = fv.makeRHS()
        rhs(0.0, u)
        chip_smoke.reset_launches()
        out[dev] = rhs(0.0, u).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: c for k, c in chip_smoke.launch_counts().items() if c} == \
                {"gather": 11, "dst_scatter": 2}
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-12 * float(out["cpu"].abs().max())


@pytest.mark.cuda
def test_cic_deposit_within_its_bound_of_the_plain_version(cuda_device):
    """W1 on chip_smoke's edge cases (cell edges, particles outside the box
    clipped to the boundary cells, 1-D to 3-D, six fields in two launches
    with the weight sum, one particle), f64 and f32: equal in bits to its
    plain version run on the host's CPU (the reference's order), given the
    cell order or building it, and with the tiles left to the dense kernel
    (every tile, a particle a node a round; the denser tiles, 66 a round);
    one launch per four fields."""
    from petsc_tpu_torch.ops import particle_kernels as ppk
    for dtype in (torch.float64, torch.float32):
        for label, X, grid, fields, v in chip_smoke.cic_edge_cases(cuda_device, dtype):
            ppk.reset_launches()
            got, err = chip_smoke.w1_check(X, grid, fields, wsum=True)
            assert ppk.LAUNCHES["cic_deposit"] == (len(fields) + 3) // 4, label
            assert got.shape == (len(fields) + 1, grid.nnodes) and err == 0.0
            order = ppk.cell_order(X, grid)
            chip_smoke.w1_check(X, grid, fields[:1], order=order)
            for capacity in (0, 600):
                chip_smoke.w1_check(X, grid, fields, wsum=True, order=order, capacity=capacity)
            with pytest.raises(ValueError, match="cell order"):
                ppk.cic_deposit(X, grid, fields[:1], order=ppk.cell_order(X.clone(), grid))


@pytest.mark.cuda
def test_cic_interp_equals_its_plain_version_bit_for_bit(cuda_device):
    """W2 on chip_smoke's edge cases, f64 and f32, in each shape it ships
    (the corner-pair table in 2-D, the aligned pairs in 1-D and 3-D, also
    with nodal values that are not 16-byte aligned): equal bits with its
    plain version (the reference's corner loop, each step rounded alone),
    one launch each."""
    from petsc_tpu_torch.ops import particle_kernels as ppk
    for dtype in (torch.float64, torch.float32):
        for label, X, grid, fields, v in chip_smoke.cic_edge_cases(cuda_device, dtype):
            shifted = torch.cat([v[:1], v])[1:]          # one element past a 16-byte edge
            for vals in (v, shifted):
                ppk.reset_launches()
                out, err = chip_smoke.w2_check(X, grid, vals)
                assert err == 0.0 and ppk.LAUNCHES["cic_interp"] == 1, label


@pytest.mark.cuda
def test_cell_order_of_a_view_at_an_odd_offset(cuda_device):
    """Two-column coordinates that are a contiguous view at an odd storage
    offset (which cannot be viewed as complex numbers) give the same cell
    order and deposit as a fresh copy."""
    from petsc_tpu_torch.ops import particle_kernels as ppk
    label, X, grid, fields, v = chip_smoke.cic_edge_cases(cuda_device, torch.float64)[1]
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=X.device)
    view = buf[1:].view(X.shape)
    view.copy_(X)
    assert view.is_contiguous() and view.storage_offset() == 1
    got, want = ppk.cell_order(view, grid), ppk.cell_order(X, grid)
    assert torch.equal(got.perm, want.perm) and torch.equal(got.offsets, want.offsets)
    assert chip_smoke.same_bits(got.Xs, want.Xs)
    chip_smoke.w1_check(view, grid, fields, wsum=True, order=got)


@pytest.mark.cuda
def test_swarm_on_the_card_equals_the_cpu_port(cuda_device):
    """A permuted 2-D swarm through depositSum, projectFields,
    interpolateToParticles and migrate on the card (W1 twice, W2 once,
    nothing else: the cell order is library torch) against the port's run
    on the CPU, every output equal in bits."""
    out = {}
    for dev in ("cpu", "cuda"):
        ptt.init(device=dev)
        da = ptt.DMDA.create(2, (65, 65))
        sw = ptt.DMSwarm.create()
        sw.setCellDM(da)
        sw.insertPointsUsingCellDM(ppcell=3)
        n = sw.getLocalSize()
        rng = np.random.default_rng(53)
        sw.setPointCoordinates(sw.getField("DMSwarmPIC_coor")[rng.permutation(n)])
        sw.registerField("w", 1)
        sw.restoreField("w", rng.random(n))
        chip_smoke.reset_launches()
        dep = sw.depositSum("w").getArray()
        proj = sw.projectFields(["w"])[0].getArray()
        it = sw.interpolateToParticles(ptt.Vec.from_array(rng.standard_normal(65 * 65)))
        sw.migrate()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: c for k, c in chip_smoke.launch_counts().items() if c} == \
                {"cic_deposit": 2, "cic_interp": 1}
        out[dev] = (dep, proj, it, sw.getField("w"))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert chip_smoke.same_bits(torch.as_tensor(a), torch.as_tensor(b))
    assert np.array_equal(out["cuda"][2], out["cpu"][2])
    assert np.array_equal(out["cuda"][3], out["cpu"][3])
