"""Hand-written Hopper kernels of the CG path, beside their plain versions.

Counterpart of ``petsc_tpu/ops/pallas_kernels.py`` (the module keeps the
reference's name so a reader finds each counterpart). The TPU package
wrote triad, axpy_normsq and dot2 as Pallas kernels and left the stencil
SpMV to XLA fusion; eager PyTorch fuses nothing, so here all of them are
CUDA C++ kernels for sm_90a (sources in ``petsc_tpu_torch/csrc``, built
and loaded by :mod:`.cuda_build`):

  probe          K1  csrc/probe.cu          pallas_kernels.py:31 _probe
  triad          K2  csrc/triad.cu          pallas_kernels.py:108 triad
  axpy_normsq    K3  csrc/axpy_normsq.cu    pallas_kernels.py:151 axpy_normsq
  dot2           K4  csrc/dot2.cu           pallas_kernels.py:198 dot2
  const_stencil  S1  csrc/const_stencil.cu  mat/aij.py:1346-1379 (separable mult)
  csr_spmv       S2  csrc/csr_spmv.cu       mat/aij.py:1554-1561 _bind_aij_csr mult
  csr_spmm       M1  csrc/csr_spmm.cu       mat/utility.py:356-372, extra_formats.py:59-70
                                            (A times a node-major block; ops/spmv.py:40)
  cheby_update   C1  csrc/cheby.cu          ksp/cheby.py:40-44, 73-78 (Chebyshev step tail)

(The four gather kernels K5-K8 are in :mod:`.gather_kernels`.)

Every wrapper checks device, dtype (float64 or float32), shape and
contiguity and raises on what its kernel does not take; allocates outputs
and scratch with ``torch.empty`` (dot2 keeps its scratch per stream, see
``_WORKSPACE``); launches on the current stream without
synchronising; takes its scalar as a 0-d tensor on the same device, which
the kernel reads on the card; and adds one to ``LAUNCHES[name]`` for each
launch. For a tensor on the CPU it runs the plain PyTorch version beside
it (the CPU tests run that path); for a CUDA tensor it launches the
kernel or raises. There is no fallback from the kernel to the plain version.

Inside a distributed solve (``parallel.mesh.reducing``), dot2's and
axpy_normsq's sums are this rank's partials: the wrappers all-reduce them
over the ranks after the kernel (one collective each, outside the kernel).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..parallel.mesh import active_comm
from ..sys.error import Error
from . import cuda_build, spmv

# launches of each kernel since the last reset_launches()
LAUNCHES = {"probe": 0, "triad": 0, "axpy_normsq": 0, "dot2": 0, "const_stencil": 0,
            "csr_spmv": 0, "csr_spmm": 0, "cheby_update": 0, "cheby_update_z": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# scratch capacity for the per-block partial sums of the reductions (the
# kernels use at most 8 blocks per SM: 1056 on a 132-SM card)
_NPARTS = 4096
_PROBE_SHAPE = (16, 128)
# (device index, stream) -> dot2's scratch: _NPARTS partials for each of
# its two sums, then the 32-bit counter of its last-block ticket, zeroed
# once; every launch leaves the counter at 0, so no call needs a memset
_WORKSPACE = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_vectors(name, *ts):
    t0 = ts[0]
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name}: dtype {t.dtype} is not supported "
                            "(float64 or float32)")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: mixed dtypes {t0.dtype} and {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and {t.device}")
        if t.dim() != 1 or t.shape != t0.shape:
            raise ValueError(f"{name}: expected 1-D tensors of one length, got "
                             f"{tuple(t0.shape)} and {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t0.device}")


def _check_scalar(name, alpha, like):
    if not isinstance(alpha, torch.Tensor) or alpha.dim() != 0:
        raise TypeError(f"{name}: alpha must be a 0-d tensor on the vectors' device")
    if alpha.dtype != like.dtype or alpha.device != like.device:
        raise TypeError(f"{name}: alpha is {alpha.dtype} on {alpha.device}, "
                        f"vectors are {like.dtype} on {like.device}")


def _launch(name, like, *args):
    cuda_build.launch(LAUNCHES, name, like, *args)


# ---------------------------------------------------------------------
# K1: the one-launch check of the built library
# ---------------------------------------------------------------------

def probe_plain(x):
    return x + 1.0


def probe(x):
    """o = x + 1 on a (16, 128) float32 tensor (the Pallas probe's shape)."""
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
            or tuple(x.shape) != _PROBE_SHAPE or not x.is_contiguous()):
        raise ValueError("probe: expects a contiguous (16, 128) float32 tensor")
    if x.device.type == "cpu":
        return probe_plain(x)
    o = torch.empty_like(x)
    rc = cuda_build.library().ptt_probe(
        o.data_ptr(), x.data_ptr(), _PROBE_SHAPE[0], x.get_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check("probe", rc)
    LAUNCHES["probe"] += 1
    return o


def kernels_available(device="cuda"):
    """Build the kernel library if needed and run one probe launch on
    `device`, checking its values. Raises on any failure; returns True."""
    x = torch.zeros(_PROBE_SHAPE, dtype=torch.float32, device=device)
    if x.device.type != "cuda":
        raise Error("kernels_available: the kernels run only on a CUDA device")
    if not bool(torch.all(probe(x) == 1.0)):
        raise Error("kernels_available: the probe kernel returned wrong values")
    return True


# ---------------------------------------------------------------------
# K2: triad  a = b + alpha * c
# ---------------------------------------------------------------------

def triad_plain(b, c, alpha, out=None):
    a = b + alpha * c
    if out is None:
        return a
    return out.copy_(a)


def triad(b, c, alpha, out=None):
    """a = b + alpha * c. `out` may be b or c (an in-place update)."""
    _check_vectors("triad", b, c, *(() if out is None else (out,)))
    _check_scalar("triad", alpha, b)
    if b.device.type == "cpu":
        return triad_plain(b, c, alpha, out)
    a = torch.empty_like(b) if out is None else out
    if b.numel():
        _launch("triad", b, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                alpha.data_ptr(), b.numel())
    return a


# ---------------------------------------------------------------------
# K3: axpy_normsq  v = y + alpha * x, ||v||^2
# ---------------------------------------------------------------------

def axpy_normsq_plain(alpha, x, y, out=None):
    v = y + alpha * x
    nsq = torch.sum(v * v)
    if out is not None:
        v = out.copy_(v)
    return v, nsq


def axpy_normsq(alpha, x, y, out=None):
    """(y + alpha x, ||y + alpha x||^2) in one pass; the norm is a 0-d
    tensor, summed over the ranks of a distributed solve. `out` may be y
    (y is then updated in place)."""
    v, nsq = _axpy_normsq_local(alpha, x, y, out)
    comm = active_comm()
    if comm is not None:
        comm.allreduce_(nsq)
    return v, nsq


def _axpy_normsq_local(alpha, x, y, out=None):
    _check_vectors("axpy_normsq", x, y, *(() if out is None else (out,)))
    _check_scalar("axpy_normsq", alpha, x)
    if x.device.type == "cpu":
        return axpy_normsq_plain(alpha, x, y, out)
    v = torch.empty_like(y) if out is None else out
    nsq = torch.empty((), dtype=x.dtype, device=x.device)
    if not x.numel():
        return v, nsq.zero_()
    partial = torch.empty(_NPARTS, dtype=torch.float64, device=x.device)
    _launch("axpy_normsq", x, v.data_ptr(), partial.data_ptr(), nsq.data_ptr(),
            alpha.data_ptr(), x.data_ptr(), y.data_ptr(), x.numel(), _NPARTS)
    return v, nsq


# ---------------------------------------------------------------------
# K4: dot2  (<x, y>, <y, y>)
# ---------------------------------------------------------------------

def dot2_plain(x, y):
    return torch.sum(x * y), torch.sum(y * y)


def dot2(x, y):
    """(<x, y>, <y, y>) in one pass, as two 0-d tensors, summed over the
    ranks of a distributed solve (one all-reduce of both)."""
    d, n2 = _dot2_local(x, y)
    comm = active_comm()
    if comm is None:
        return d, n2
    res = comm.allreduce_(torch.stack([d, n2]))
    return res[0], res[1]


def _dot2_local(x, y):
    _check_vectors("dot2", x, y)
    if x.device.type == "cpu":
        return dot2_plain(x, y)
    res = torch.empty(2, dtype=x.dtype, device=x.device)
    if not x.numel():
        res.zero_()
        return res[0], res[1]
    ws = _workspace(x.device)
    _launch("dot2", x, res.data_ptr(), ws.data_ptr(), ws.data_ptr() + 2 * _NPARTS * 8,
            x.data_ptr(), y.data_ptr(), x.numel(), _NPARTS)
    return res[0], res[1]


def _workspace(dev):
    """dot2's scratch on `dev` for the current stream, zeroed when first
    made (a dict lookup after that: no launch, no allocation)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = torch.zeros(2 * _NPARTS + 1, dtype=torch.float64, device=dev)
    return ws


def launch_config(name, dtype, n, device):
    """The launch shape that K2 ("triad") or K4 ("dot2") takes for n
    elements of `dtype` on CUDA `device`: blocks, threads per block,
    16-byte packs per thread and round, blocks per SM (from the occupancy
    calculator) and the card's SMs."""
    dev = torch.device(device)
    cfg = (ctypes.c_int * 5)()
    args = (int(dtype == torch.float64), int(n)) + ((_NPARTS,) if name == "dot2" else ()) \
        + (dev.index if dev.index is not None else torch.cuda.current_device(),
           ctypes.addressof(cfg))
    cuda_build.check(name, getattr(cuda_build.library(), f"ptt_{name}_config")(*args))
    return dict(zip(("grid", "threads", "packs_per_thread", "blocks_per_sm", "sms"), cfg))


# ---------------------------------------------------------------------
# S1: constant-coefficient box/star stencil SpMV (mat/aij.py separable mult)
# ---------------------------------------------------------------------

def _box1(v, ax):
    """3-tap sum along axis `ax` with zeros outside the grid."""
    n_ax = v.shape[ax]
    pads = [0] * (2 * v.dim())
    k = 2 * (v.dim() - 1 - ax)          # F.pad lists the last axis first
    pads[k] = pads[k + 1] = 1
    vp = F.pad(v, pads)
    return vp.narrow(ax, 0, n_ax) + vp.narrow(ax, 1, n_ax) + vp.narrow(ax, 2, n_ax)


def const_stencil_plain(x, shape, cd, co, is_box):
    """The separable form of mat/aij.py:1353-1374:
    box  y = (cd - co) x + co (B_0 ... B_{nd-1}) x,
    star y = (cd - nd co) x + co (B_0 + ... + B_{nd-1}) x."""
    nd = len(shape)
    v = x.reshape(shape)
    if is_box:
        s = v
        for ax in range(nd):
            s = _box1(s, ax)
        y = (cd - co) * v + co * s
    else:
        s = _box1(v, 0)
        for ax in range(1, nd):
            s = s + _box1(v, ax)
        y = (cd - nd * co) * v + co * s
    return y.reshape(-1)


# S1's launch geometry; csrc/const_stencil.cu holds the same constants
# (kTileY x kTileX outputs per block, kStages ring slots), and
# tests/test_torch_stencil_plan.py checks that they agree
S1_TILE = (8, 32)          # (i1, i2) outputs per block
S1_STAGES = 2              # planes of x in the ring
S1_CHUNK = 16              # i0 planes per block
S1_THREADS = 8 * 32 + 32   # a thread per output column, and a warp for the halo columns
_GRID_YZ = 65535           # CUDA's limit on gridDim.y and gridDim.z
# (device, data pointer, n0, n1, n2, dtype) -> (chunk, the tensor map's
# 128-byte buffer or None, its address): the TMA path encodes a map once per
# buffer and shape (CG multiplies the same p every iteration); the oldest
# entry goes first
_S1_MAPS = {}
_S1_MAPS_MAX = 64


def _grid3(shape):
    """`shape` padded to 3-D with leading unit axes."""
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"const_stencil: the kernel takes 1-3 grid axes, got {len(shape)}")
    return (1,) * (3 - len(shape)) + tuple(int(s) for s in shape)


def const_stencil_plan(shape, dtype, data_ptr, device=None):
    """How S1 runs on grid `shape` for an x of `dtype` at address
    `data_ptr`. The load path follows from the shape and the alignment
    alone: "tma" when x starts on a 16-byte edge and a row of the grid
    (n2 itemsize bytes) is a multiple of 16 bytes, as the TMA unit needs;
    "cp.async" otherwise. Returns the path, the launch grid (i2 tiles, i1
    tiles, i0 chunks), the tile, the chunk, the ring's stages, the threads
    per block and the TMA box (i0, i1, i2 elements: the tile's rows and
    their halo; along i2 16 bytes before the tile, which is where a box
    must start, to past its halo column); with a CUDA `device`
    also the blocks per SM, the SMs and the registers per thread that the
    card reports for the kernel."""
    n0, n1, n2 = _grid3(shape)
    isz = torch.empty((), dtype=dtype).element_size()
    ty, tx = S1_TILE
    tma = data_ptr % 16 == 0 and n2 * isz % 16 == 0
    chunk = max(1, min(S1_CHUNK, n0))
    plan = {"path": "tma" if tma else "cp.async",
            "grid": (-(-n2 // tx), -(-n1 // ty), -(-n0 // chunk)),
            "tile": S1_TILE, "chunk": chunk, "stages": S1_STAGES, "threads": S1_THREADS,
            "box": (1, ty + 2, -(-(tx + 1 + 16 // isz) * isz // 16) * 16 // isz)}
    if device is not None:
        dev = torch.device(device)
        cfg = (ctypes.c_int * 5)()
        rc = cuda_build.library().ptt_const_stencil_config(
            int(dtype == torch.float64), 1, int(tma),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            ctypes.addressof(cfg))
        cuda_build.check("const_stencil", rc)
        if cfg[0] != S1_THREADS:
            raise Error(f"const_stencil: the library's kernel has {cfg[0]} threads a block, "
                        f"the plan {S1_THREADS}")
        plan.update(blocks_per_sm=cfg[1], sms=cfg[2], registers=cfg[3], static_smem_bytes=cfg[4])
    return plan


def _s1_launch(x, n0, n1, n2):
    """(chunk, address of the tensor map or None) for x on grid (n0, n1,
    n2), from the cache; a miss plans the launch and, on the TMA path,
    encodes the map (raising if the driver refuses it)."""
    key = (x.get_device(), x.data_ptr(), n0, n1, n2, x.dtype)
    hit = _S1_MAPS.get(key)
    if hit is not None:
        return hit[0], hit[2]
    plan = const_stencil_plan((n0, n1, n2), x.dtype, x.data_ptr())
    _, gy, gz = plan["grid"]
    if max(n0, n1, n2) >= 2 ** 31 or gy > _GRID_YZ or gz > _GRID_YZ:
        raise ValueError(f"const_stencil: grid {(n0, n1, n2)} exceeds the kernel's launch grid "
                         f"{plan['grid']}")
    buf = None
    if plan["path"] == "tma":
        buf = ctypes.create_string_buffer(128)
        rc = cuda_build.library().ptt_const_stencil_map(
            buf, x.data_ptr(), n0, n1, n2, int(x.dtype == torch.float64))
        if rc != 0:
            raise Error(f"const_stencil: cuTensorMapEncodeTiled refused grid {(n0, n1, n2)} "
                        f"{x.dtype} at {x.data_ptr():#x} (CUresult {rc}; -1: no driver entry point)")
    if len(_S1_MAPS) >= _S1_MAPS_MAX:
        del _S1_MAPS[next(iter(_S1_MAPS))]
    entry = _S1_MAPS[key] = (plan["chunk"], buf, None if buf is None else ctypes.addressof(buf))
    return entry[0], entry[2]


def const_stencil(x, shape, cd, co, is_box):
    """y = A x for the constant-coefficient box (3^nd-point) or star
    (2 nd + 1-point) stencil on grid `shape` (C order), diagonal `cd`,
    every off-diagonal `co`, zeros outside the grid. The operator is
    symmetric, so this is also A^T x."""
    shape = tuple(int(s) for s in shape)
    _check_vectors("const_stencil", x)
    n = 1
    for s in shape:
        n *= s
    if x.numel() != n:
        raise ValueError(f"const_stencil: x has {x.numel()} entries, grid {shape} has {n}")
    if x.device.type == "cpu":
        return const_stencil_plain(x, shape, cd, co, is_box)
    n0, n1, n2 = _grid3(shape)
    y = torch.empty_like(x)
    # the kernel always sums three axes; a grid padded to 3-D with unit
    # axes adds x once per unit axis to the star sum, which the 3-D centre
    # factor cd - 3 co takes back out
    c0 = cd - co if is_box else cd - 3 * co
    if n:
        chunk, tmap = _s1_launch(x, n0, n1, n2)
        _launch("const_stencil", x, y.data_ptr(), x.data_ptr(), n0, n1, n2,
                float(c0), float(co), int(bool(is_box)), chunk, tmap)
    return y


# ---------------------------------------------------------------------
# S2: general CSR SpMV (mat/aij.py _bind_aij_csr mult)
# ---------------------------------------------------------------------

csr_spmv_plain = spmv.csr_spmv


def csr_spmv(indptr, col, vals, x):
    """y = A x for A in CSR form: int64 `indptr` (m + 1), int32 `col` and
    `vals` (nnz), x of the columns' length. The columns are not checked
    against len(x) here (that would read the card): the assembly that made
    them checked them on the host. indptr[0] is 0 and indptr[m] the
    number of entries. The kernel copies 16-byte aligned windows around
    vals and col, so views that start at any element (``vals[1:]``) are
    taken as they are. Nothing is cached between calls."""
    for t, dt, nm in ((indptr, torch.int64, "indptr"), (col, torch.int32, "col")):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError(f"csr_spmv: {nm} must be a contiguous 1-D {dt} tensor")
    _check_vectors("csr_spmv", x)
    _check_vectors("csr_spmv", vals)
    if vals.dtype != x.dtype:
        raise TypeError(f"csr_spmv: vals are {vals.dtype}, x is {x.dtype}")
    if not (indptr.device == col.device == vals.device == x.device):
        raise ValueError("csr_spmv: the CSR arrays and x lie on different devices")
    if indptr.numel() < 1 or col.numel() != vals.numel():
        raise ValueError(f"csr_spmv: {indptr.numel()} row pointers, {col.numel()} "
                         f"columns and {vals.numel()} values")
    if x.numel() >= 2 ** 31:
        raise ValueError("csr_spmv: the kernel's int32 columns take fewer than 2^31 columns")
    if x.device.type == "cpu":
        return csr_spmv_plain(indptr, col, vals, x)
    m = indptr.numel() - 1
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _launch("csr_spmv", x, y.data_ptr(), indptr.data_ptr(), col.data_ptr(),
                vals.data_ptr(), x.data_ptr(), m, vals.numel())
    return y


# ---------------------------------------------------------------------
# M1: CSR times a row-major block (MatMAIJ's and MatKAIJ's A X)
# ---------------------------------------------------------------------

csr_spmm_plain = spmv.csr_spmm
SPMM_TILE = 8          # columns per launch; a wider X takes one launch per tile


def csr_spmm(indptr, col, vals, X):
    """Y = A X for A in CSR form (as :func:`csr_spmv` takes it) and X an
    (n, k) row-major block, k >= 1: Y[i, c] = sum over row i's entries of
    vals[p] X[col[p], c], shape (m, k). One launch per tile of up to
    SPMM_TILE columns (one for MatMAIJ's dof <= 8). X and Y are contiguous;
    vals and col may start at any element (as :func:`csr_spmv`'s). Each
    launch adds one to ``LAUNCHES["csr_spmm"]``."""
    for t, dt, nm in ((indptr, torch.int64, "indptr"), (col, torch.int32, "col")):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError(f"csr_spmm: {nm} must be a contiguous 1-D {dt} tensor")
    _check_vectors("csr_spmm", vals)
    if not isinstance(X, torch.Tensor) or X.dim() != 2 or not X.is_contiguous() \
            or X.shape[1] < 1:
        raise ValueError("csr_spmm: X must be a contiguous (n, k) tensor with k >= 1")
    if X.dtype != vals.dtype:
        raise TypeError(f"csr_spmm: vals are {vals.dtype}, X is {X.dtype}")
    if not (indptr.device == col.device == vals.device == X.device):
        raise ValueError("csr_spmm: the CSR arrays and X lie on different devices")
    if indptr.numel() < 1 or col.numel() != vals.numel():
        raise ValueError(f"csr_spmm: {indptr.numel()} row pointers, {col.numel()} "
                         f"columns and {vals.numel()} values")
    if X.shape[0] >= 2 ** 31:
        raise ValueError("csr_spmm: the kernel's int32 columns take fewer than 2^31 rows of X")
    if X.device.type == "cpu":
        return csr_spmm_plain(indptr, col, vals, X)
    m, k = indptr.numel() - 1, X.shape[1]
    Y = torch.empty((m, k), dtype=X.dtype, device=X.device)
    if m:
        step = Y.element_size()
        for c0 in range(0, k, SPMM_TILE):
            _launch("csr_spmm", X, Y.data_ptr() + c0 * step, indptr.data_ptr(), col.data_ptr(),
                    vals.data_ptr(), X.data_ptr() + c0 * step, m, vals.numel(), k,
                    min(SPMM_TILE, k - c0))
    return Y


# ---------------------------------------------------------------------
# C1: the fused Chebyshev step tail (ksp/cheby.py cheby_smooth, cheby_smooth4)
# ---------------------------------------------------------------------

_CHEBY_MODES = {"first": 0, "step": 1}


def cheby_update_plain(mode, r, p, x, w, dinv, c, beta=1.0, a=0.0, b=None):
    """C1's function in PyTorch ops, in place on r, p and x:
    first: r = b - w; p = c (dinv r); x += beta p;
    step:  r -= w;    p = a p + c (dinv r); x += beta p."""
    if mode == "first":
        torch.sub(b, w, out=r)
        torch.mul(dinv * r, c, out=p)
    else:
        r.sub_(w)
        p.mul_(a).add_(c * (dinv * r))
    x.add_(beta * p)
    return r, p, x


def cheby_update(mode, r, p, x, w, dinv, c, beta=1.0, a=0.0, b=None):
    """One Chebyshev step after its SpMV w, in one pass over the vectors
    (see cheby_update_plain; `b` only in mode "first", `a` only in mode
    "step"). Overwrites r, p and x, which must be three distinct buffers:
    the smoother owns them. `dinv` is a vector; the scalars are host
    numbers. Returns (r, p, x)."""
    if mode not in _CHEBY_MODES:
        raise ValueError(f"cheby_update: mode must be 'first' or 'step', got {mode!r}")
    if (b is None) != (mode == "step"):
        raise ValueError("cheby_update: b is given in mode 'first' and only there")
    vecs = (r, p, x, w, dinv) + ((b,) if b is not None else ())
    _check_vectors("cheby_update", *vecs)
    if len({r.data_ptr(), p.data_ptr(), x.data_ptr()}) < 3 and r.numel():
        raise ValueError("cheby_update: r, p and x must be distinct buffers")
    if r.device.type == "cpu":
        return cheby_update_plain(mode, r, p, x, w, dinv, c, beta, a, b)
    if r.numel():
        _launch("cheby_update", r, _CHEBY_MODES[mode], r.data_ptr(), p.data_ptr(),
                x.data_ptr(), 0 if b is None else b.data_ptr(), w.data_ptr(), dinv.data_ptr(),
                float(a), float(c), float(beta), r.numel())
    return r, p, x


def cheby_update_z_plain(mode, p, x, z, c, beta=1.0, a=0.0):
    """C1's z modes in PyTorch ops, in place on p and x:
    first_z: p = c z; x += beta p;  step_z: p = a p + c z; x += beta p."""
    if mode == "first_z":
        torch.mul(z, c, out=p)
    else:
        p.mul_(a).add_(c * z)
    x.add_(beta * p)
    return p, x


def cheby_update_z(mode, p, x, z, c, beta=1.0, a=0.0):
    """The tail of a Chebyshev step whose smoothing PC gave z = M^-1 r
    (the aggregate-block smoother; r was formed before it), in one pass
    (see cheby_update_z_plain; `a` only in mode "step_z"). Overwrites p
    and x, two distinct buffers. A kernel of C1's library entry point,
    counted apart as ``cheby_update_z``. Returns (p, x)."""
    if mode not in ("first_z", "step_z"):
        raise ValueError(f"cheby_update_z: mode must be 'first_z' or 'step_z', got {mode!r}")
    _check_vectors("cheby_update_z", p, x, z)
    if p.data_ptr() == x.data_ptr() and p.numel():
        raise ValueError("cheby_update_z: p and x must be distinct buffers")
    if p.device.type == "cpu":
        return cheby_update_z_plain(mode, p, x, z, c, beta, a)
    if p.numel():
        cuda_build.launch(LAUNCHES, "cheby_update_z", p, 2 if mode == "first_z" else 3, 0,
                          p.data_ptr(), x.data_ptr(), 0, 0, z.data_ptr(), float(a), float(c),
                          float(beta), p.numel(), entry="cheby_update")
    return p, x


# ---------------------------------------------------------------------
# roofline anchor
# ---------------------------------------------------------------------

def streams_triad_bandwidth(n=(1 << 24), dtype=torch.float32, reps=5, device="cuda"):
    """Measured triad bandwidth in GB/s on the card: 3 n itemsize over the
    best of `reps` launches timed with CUDA events (the methodology of
    the STREAMS benchmark, BasicVersion.c)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise Error("streams_triad_bandwidth measures a CUDA device only")
    b = torch.ones(n, dtype=dtype, device=dev)
    c = torch.full((n,), 2.0, dtype=dtype, device=dev)
    alpha = torch.tensor(3.14, dtype=dtype, device=dev)
    out = triad(b, c, alpha)
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        triad(b, c, alpha, out=out)
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / 1e3)
    return 3.0 * n * b.element_size() / best / 1e9
