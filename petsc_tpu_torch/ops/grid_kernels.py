"""Hand-written Hopper kernels of the structured GAMG head, beside their
plain versions.

The JAX package left these device functions to XLA fusion; eager PyTorch
fuses nothing, so here they are CUDA C++ kernels for sm_90a (sources in
``petsc_tpu_torch/csrc``, built and loaded by :mod:`.cuda_build`):

  dnd_stencil  V1   csrc/dnd_stencil.cu  mat/aij.py:1381-1436 (variable-coefficient mult)
  dnd_stencil_t V1T csrc/dnd_stencil.cu  mat/aij.py:1438-1451 (its mult_t: V1 on the
                                         transposed stencil)
  q1_prolong   Q1P  csrc/q1.cu           dm/interp.py:21-46 _interp_axis, composed at :219-227
  q1_restrict  Q1R  csrc/q1.cu           dm/interp.py:49-71 _restrict_axis, composed at :229-235

V1 is the product of every ``aij_dnd`` operator but the separable constant
box and star (S1): the probed coarse levels, a MatAIJ on a declared grid,
and constant stencils of other offsets. It has two kernels, chosen once per
bound operator by :func:`dnd_stencil_fn` (``_window_plan``): the window
kernel for a stencil whose offsets, padded to 3-D, lie in {-1,0,1}^3 in the
lexicographic order of ``product((-1, 0, 1), repeat=3)`` (a subsequence of
it is fine; every probed level is the whole of it), each tap a plane or a
constant; the generic kernel for every other stencil. The window kernel's
16-byte variant needs n2 * itemsize to be a multiple of 16 and aligned
planes; otherwise it takes its scalar variant. Both count as
``dnd_stencil``. Q1P and Q1R are the structured levels' transfers and the
probe's P and P^T; Q1P writes one coarse cell's fine points per thread,
each row's pair along i2 as one vector store at an even f2
(``_q1_prolong_plan``); Q1R gives each thread the coarse points of one
plane and row whose fine points along i2 one 16-byte load holds (where
f2 * itemsize is a multiple of 16 and x is aligned, else one coarse point
and two scalar loads), all of its 9 fine rows' loads in flight before it
sums (``_q1_restrict_plan``). A field of ``dof > 1`` components per point
(a DMDA's, the components innermost) takes the kernels' dof entries
(``q1_prolong_dof``, ``q1_restrict_dof``: one thread per fine, or coarse,
point of a row, the same sums per component); they count as Q1P and Q1R.

Every wrapper checks device, dtype (float64 or float32), shape and
contiguity and raises on what its kernel does not take; allocates its
output with ``torch.empty``; launches on the current stream without
synchronising; and adds one to ``LAUNCHES[name]`` for each launch. For a
tensor on the CPU it runs the plain PyTorch version beside it (the CPU
tests run that path); for a CUDA tensor it launches the kernel or raises.
There is no fallback from the kernel to the plain version. The kernels
round each product and sum on their own, in the plain versions' order, so
the two give equal bits.

V1T is the transpose's product, y(i) = sum_k c_k(i - o_k) x(i - o_k): V1's
generic kernel on the transposed stencil, offsets -o_k in the same order
and planes c_k shifted by o_k (zero where i - o_k leaves the grid; a
constant tap stays constant, since x is zero outside the grid). The
shifted planes are built on the card at the first product
(:func:`dnd_stencil_t_fn`), as many as the stencil has planes. The sum runs
over k in the reference's order (its scatter form adds the terms in the
offsets' order), so V1T equals its plain version, the gather form
:func:`dnd_stencil_t`, bit for bit. It counts as ``dnd_stencil_t``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from itertools import product

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"dnd_stencil": 0, "dnd_stencil_t": 0, "q1_prolong": 0, "q1_restrict": 0}

_VALUES = (torch.float64, torch.float32)
_MAX_TAPS = 128            # csrc/dnd_stencil.cu kMaxTaps
_INT32_MAX = 2 ** 31 - 1
# the window kernel's 27 slots, {-1,0,1}^3 in lexicographic order
_SLOTS = {o: k for k, o in enumerate(product((-1, 0, 1), repeat=3))}
_WINDOW_THREADS = 128      # threads of a window block
_WINDOW_BLOCKS_PER_SM = 4  # blocks per SM the chunking of i0 aims at
_GRID_YZ_MAX = 65535
_H100_SMS = 132            # the SMs a plan assumes for planes that are not on a card
_Q1R_THREADS = 128         # threads of a Q1R block at most (csrc/common.cuh kThreads: 256)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_vector(name, x, n):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype not in _VALUES:
        raise TypeError(f"{name}: dtype {x.dtype} is not supported (float64 or float32)")
    if x.dim() != 1 or x.numel() != n or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D tensor of {n} entries, got "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if n > _INT32_MAX:
        raise ValueError(f"{name}: the kernel's int32 indices take fewer than 2^31 points")


def _grid3(shape):
    """`shape` padded to 3-D with leading unit axes."""
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"the grid kernels take 1-3 grid axes, got {len(shape)}")
    return (1,) * (3 - len(shape)) + tuple(int(s) for s in shape)


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------
# V1: the variable-coefficient stencil (mat/aij.py _bind_aij_dnd mult)
# ---------------------------------------------------------------------

def _pads(offsets, nd):
    lpad = tuple(max(0, -min(o[ax] for o in offsets)) for ax in range(nd))
    rpad = tuple(max(0, max(o[ax] for o in offsets)) for ax in range(nd))
    return lpad, rpad


def _pad_grid(v, lpad, rpad):
    """v zero-padded by lpad before and rpad after each axis."""
    pads = []
    for ax in range(v.dim() - 1, -1, -1):     # F.pad lists the last axis first
        pads += [lpad[ax], rpad[ax]]
    return F.pad(v, pads)


def dnd_stencil_plain(x, shape, offsets, consts, coef):
    """The generic branch of mat/aij.py:1427-1436: y(i) = sum_k c_k(i)
    x(i + o_k) over the offsets in their order, x zero outside the grid;
    c_k is the constant consts[k], or where that is None the next plane
    of coef (variable planes in offset order)."""
    nd = len(shape)
    lpad, rpad = _pads(offsets, nd)
    vp = _pad_grid(x.reshape(shape), lpad, rpad)
    acc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    ci = 0
    for k, off in enumerate(offsets):
        if consts[k] is None:
            c = coef[ci]
            ci += 1
        else:
            c = consts[k]
        sl = tuple(slice(lpad[ax] + off[ax], lpad[ax] + off[ax] + shape[ax]) for ax in range(nd))
        acc = acc + c * vp[sl]
    return acc.reshape(-1)


def _dnd_plan(shape, offsets, consts):
    """V1's plan for one stencil, checked: (grid, points, planes, the launch
    arguments of the taps: their count and the addresses of the ctypes
    arrays of offsets padded to 3-D, plane index or -1, constant; the
    arrays themselves, which the addresses point into)."""
    shape = tuple(int(s) for s in shape)
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    consts = tuple(None if c is None else float(c) for c in consts)
    if len(consts) != len(offsets) or any(len(o) != len(shape) for o in offsets):
        raise ValueError(f"dnd_stencil: {len(offsets)} offsets, {len(consts)} constants, "
                         f"grid {shape}")
    if len(offsets) > _MAX_TAPS:
        raise ValueError(f"dnd_stencil: the kernel takes at most {_MAX_TAPS} offsets")
    K = len(offsets)
    planes, ci = [], 0
    for c in consts:
        planes.append(-1 if c is not None else ci)
        ci += c is None
    arrays = ((ctypes.c_int * (3 * K))(*[v for o in offsets for v in (0,) * (3 - len(o)) + o]),
              (ctypes.c_int * K)(*planes),
              (ctypes.c_double * K)(*[0.0 if c is None else c for c in consts]))
    taps = (K, *(ctypes.addressof(a) for a in arrays))
    return shape, _numel(shape), (ci,) + shape, _grid3(shape) + taps, arrays


def _window_plan(grid, offsets, consts, itemsize, coef_ptr, sms=_H100_SMS):
    """The window kernel's plan for a stencil on the 3-D `grid`, or None
    when the stencil takes the generic kernel: its offsets, padded to 3-D,
    must be slots of {-1,0,1}^3 in increasing order (the sum's order is the
    offsets' order, so another order keeps the generic kernel).

    Returns a dict: the launch arguments after (n0, n1, n2) (the tap and
    plane bitmasks, the address of the 27 constants, the 16-byte variant,
    the block's nx x ny threads, the i0 planes per block), the ctypes array
    of constants, the variant, the block, the chunk and the grid. Each
    thread takes 16 / itemsize points along i2; the chunk of i0 is as long
    as keeps _WINDOW_BLOCKS_PER_SM blocks per SM busy."""
    off3 = [(0,) * (3 - len(o)) + tuple(o) for o in offsets]
    slots = [_SLOTS.get(o) for o in off3]
    if not slots or None in slots or any(b <= a for a, b in zip(slots, slots[1:])):
        return None
    n0, n1, n2 = grid
    w = 16 // itemsize
    # tiles of at most 32 threads along i2 and _WINDOW_THREADS in all, each
    # axis cut into tiles of equal size (65 points in f32: one tile of 17
    # threads, not 32 with 15 idle)
    threads2 = -(-n2 // w)
    nx = -(-threads2 // -(-threads2 // 32))
    rows = max(1, _WINDOW_THREADS // nx)
    ny = -(-n1 // -(-n1 // rows))
    tiles = -(-n2 // (nx * w)) * -(-n1 // ny)
    chunk = max(1, n0 * tiles // (sms * _WINDOW_BLOCKS_PER_SM))
    launch_grid = (-(-n2 // (nx * w)), -(-n1 // ny), -(-n0 // chunk))
    if max(launch_grid[1:]) > _GRID_YZ_MAX:
        return None
    present = sum(1 << s for s in slots)
    plane = sum(1 << s for s, c in zip(slots, consts) if c is None)
    c27 = [0.0] * len(_SLOTS)
    for s, c in zip(slots, consts):
        if c is not None:
            c27[s] = c
    c27 = (ctypes.c_double * len(_SLOTS))(*c27)
    vec = (n2 * itemsize) % 16 == 0 and coef_ptr % 16 == 0
    return {"args": (present, plane, ctypes.addressof(c27), int(vec), nx, ny, chunk),
            "consts": c27, "vector": vec, "block": (nx, ny), "chunk": chunk,
            "grid": launch_grid}


def _sms(device):
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


def dnd_stencil_fn(shape, offsets, consts, coef, counter="dnd_stencil"):
    """x -> A x for the grid stencil with `offsets` on grid `shape` (C order,
    zeros outside the grid): per offset k the constant consts[k] or, where
    that is None, the next plane of `coef` (a contiguous (planes, *shape)
    float64 or float32 tensor). The stencil is checked and its launch
    planned once here, where a binder binds the operator: the window
    kernel where _window_plan takes the stencil, else the generic one
    (``apply.kernel`` says which, ``apply.window`` holds the window's plan).
    Each launch adds one to ``LAUNCHES[counter]``."""
    shape, n, coef_shape, args, arrays = _dnd_plan(shape, offsets, consts)
    if (not isinstance(coef, torch.Tensor) or coef.dtype not in _VALUES
            or coef.shape != coef_shape or not coef.is_contiguous()):
        raise ValueError(f"dnd_stencil: coef must be a contiguous {coef_shape} float64 or "
                         f"float32 tensor, got {getattr(coef, 'shape', coef)}")
    window = _window_plan(_grid3(shape), offsets, consts, coef.element_size(),
                          coef.data_ptr(), _sms(coef.device))
    entry = "dnd_stencil"
    if window is not None:
        entry, args = "dnd_window", _grid3(shape) + window["args"]

    def apply(x):
        _check_vector("dnd_stencil", x, n)
        if x.dtype != coef.dtype or x.device != coef.device:
            raise ValueError(f"dnd_stencil: x is {x.dtype} on {x.device}, the planes "
                             f"{coef.dtype} on {coef.device}")
        if x.device.type == "cpu":
            return dnd_stencil_plain(x, shape, offsets, consts, coef)
        y = torch.empty_like(x)
        if n:
            cuda_build.launch(LAUNCHES, counter, x, y.data_ptr(), x.data_ptr(),
                              coef.data_ptr(), *args, entry=entry)
        return y

    apply.taps = arrays          # the ctypes arrays that args point into
    apply.kernel = "generic" if window is None else "window"
    apply.window = window
    return apply


def dnd_window_config(dtype, vector, full, block, device):
    """The window kernel's launch shape on `device` for an nx x ny block:
    threads, blocks per SM, SMs, registers per thread, dynamic shared bytes,
    local (spill) bytes per thread."""
    cfg = (ctypes.c_int * 6)()
    cuda_build.check("dnd_window_config", cuda_build.library().ptt_dnd_window_config(
        int(dtype == torch.float64), int(vector), int(full), *block,
        torch.device(device).index or 0, cfg))
    return dict(zip(("threads", "blocks_per_sm", "sms", "registers", "smem_bytes",
                     "local_bytes"), cfg))


def dnd_stencil(x, shape, offsets, consts, coef):
    """y = A x for one stencil (see dnd_stencil_fn)."""
    return dnd_stencil_fn(shape, offsets, consts, coef)(x)


def dnd_stencil_t(x, shape, offsets, consts, coef):
    """V1T's plain version: y = A^T x for the same stencil, in gather form
    (no atomics): y(i) = sum_k c_k(i - o_k) x(i - o_k), each term c_k x
    shifted by o_k. The reference's scatter form (mat/aij.py:1438-1451)
    sums the same terms in the same order."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    _check_vector("dnd_stencil_t", x, _numel(shape))
    # shifting by +o_k reads u at i - o_k: pad by the negated offsets' extent
    lpad, rpad = _pads([tuple(-v for v in o) for o in offsets], nd)
    v = x.reshape(shape)
    acc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    ci = 0
    for k, off in enumerate(offsets):
        if consts[k] is None:
            u = coef[ci] * v
            ci += 1
        else:
            u = consts[k] * v
        up = _pad_grid(u, lpad, rpad)
        sl = tuple(slice(lpad[ax] - off[ax], lpad[ax] - off[ax] + shape[ax]) for ax in range(nd))
        acc = acc + up[sl]
    return acc.reshape(-1)


def transposed_stencil(shape, offsets, consts, coef):
    """(offsets, planes) of A^T's stencil: -o_k in the same order, and each
    plane c_k shifted by o_k, c_k(i - o_k) where i - o_k is in the grid and
    0 elsewhere (one new tensor of coef's shape, dtype and device)."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    planes = torch.zeros_like(coef)
    ci = 0
    for k, off in enumerate(offsets):
        if consts[k] is not None:
            continue
        dst = tuple(slice(max(0, off[ax]), shape[ax] + min(0, off[ax])) for ax in range(nd))
        src = tuple(slice(max(0, -off[ax]), shape[ax] - max(0, off[ax])) for ax in range(nd))
        planes[ci][dst] = coef[ci][src]
        ci += 1
    return tuple(tuple(-int(v) for v in o) for o in offsets), planes


def dnd_stencil_t_fn(shape, offsets, consts, coef):
    """x -> A^T x for the stencil of dnd_stencil_fn: on a CPU tensor its
    plain version dnd_stencil_t; on a CUDA tensor V1T, V1's generic kernel on
    transposed_stencil's planes, built at the first call on the card and
    kept in the closure. The negated offsets are in decreasing order, so the window kernel
    (increasing order only) never takes a stencil of two taps or more."""
    shape = tuple(int(s) for s in shape)
    state = {}

    def apply(x):
        if x.device.type == "cpu":
            return dnd_stencil_t(x, shape, offsets, consts, coef)
        fn = state.get("fn")
        if fn is None:
            offs_t, planes = transposed_stencil(shape, offsets, consts, coef)
            fn = state["fn"] = dnd_stencil_fn(shape, offs_t, consts, planes,
                                              counter="dnd_stencil_t")
        return fn(x)

    return apply


# ---------------------------------------------------------------------
# Q1P / Q1R: the factor-2 vertex Q1 transfers (dm/interp.py)
# ---------------------------------------------------------------------

def _ax(nd, axis, s):
    sl = [slice(None)] * nd
    sl[axis] = s
    return tuple(sl)


def _interp_axis(c, axis, nf):
    """1-D vertex-subsampled linear prolongation along `axis`:
    nc = (nf+1)//2 -> nf. Even fine points inject the coarse values; odd
    points average their two coarse neighbours. Odd nf is the classical
    vertex-centred Q1 (nf = 2nc-1, dainterp.c); even nf clamps the last
    odd point to its single in-range neighbour (weight 1)."""
    nc, nd = c.shape[axis], c.dim()
    shape = list(c.shape)
    shape[axis] = nf
    f = torch.zeros(shape, dtype=c.dtype, device=c.device)
    f[_ax(nd, axis, slice(0, nf, 2))] = c[_ax(nd, axis, slice(0, (nf + 1) // 2))]
    nodd = nf // 2
    if nf % 2:
        mid = 0.5 * (c[_ax(nd, axis, slice(0, nodd))] + c[_ax(nd, axis, slice(1, nodd + 1))])
    else:
        mid = 0.5 * (c + torch.cat([c[_ax(nd, axis, slice(1, nc))],
                                    c[_ax(nd, axis, slice(nc - 1, nc))]], dim=axis))
    f[_ax(nd, axis, slice(1, nf, 2))] = mid
    return f


def _restrict_axis(f, axis, nc):
    """Adjoint of _interp_axis: nf -> nc = (nf+1)//2."""
    nf, nd = f.shape[axis], f.dim()
    c = f[_ax(nd, axis, slice(0, nf, 2))].clone()
    mid = f[_ax(nd, axis, slice(1, nf, 2))]           # the odd fine points
    nodd = nf // 2
    if nf % 2:                                         # vertex-centred, nodd = nc - 1
        c[_ax(nd, axis, slice(0, nc - 1))] += 0.5 * mid
        c[_ax(nd, axis, slice(1, nc))] += 0.5 * mid
    else:                                              # even: nodd = nc, the last clamped
        c = c + 0.5 * mid
        c[_ax(nd, axis, slice(1, nc))] += 0.5 * mid[_ax(nd, axis, slice(0, nodd - 1))]
        c[_ax(nd, axis, slice(nc - 1, nc))] += 0.5 * mid[_ax(nd, axis, slice(nodd - 1, nodd))]
    return c


def _coarse_of(fshape):
    return tuple((int(s) + 1) // 2 for s in fshape)


def _with_dof(shape, dof):
    return tuple(int(s) for s in shape) + ((int(dof),) if dof > 1 else ())


def q1_prolong_plain(x, fshape, dof=1):
    """P x: the per-axis composition of mat/interp.py:219-227 (axes 0, 1, ...;
    dof > 1 components ride along as a trailing axis)."""
    v = x.reshape(_with_dof(_coarse_of(fshape), dof))
    for ax in range(len(fshape)):
        v = _interp_axis(v, ax, int(fshape[ax]))
    return v.reshape(-1)


def q1_restrict_plain(x, fshape, dof=1):
    """P^T x: the per-axis composition of mat/interp.py:229-235 (the last
    grid axis first; dof > 1 components ride along as a trailing axis)."""
    cshape = _coarse_of(fshape)
    v = x.reshape(_with_dof(fshape, dof))
    for ax in range(len(fshape) - 1, -1, -1):
        v = _restrict_axis(v, ax, cshape[ax])
    return v.reshape(-1)


def _q1_prolong_plan(fshape):
    """Q1P's launch: the fine and the coarse grid padded to 3-D, and
    whether each cell's pair (2 j2, 2 j2 + 1) is one vector store (an even
    f2: every cell has both points and every row starts on an even
    element; an odd f2 takes scalar stores, the last cell only its even
    point)."""
    f3 = _grid3(fshape)
    return f3, _coarse_of(f3), f3[2] % 2 == 0


@lru_cache(maxsize=None)
def _q1_restrict_plan(fshape, itemsize, aligned, threads=_Q1R_THREADS):
    """Q1R's launch for the fine grid `fshape` (both grids padded to 3-D):
    the 16-byte variant (a thread's 16 / itemsize fine points along i2,
    half as many coarse ones) where f2 * itemsize is a multiple of 16 and
    x is 16-byte `aligned`, else the scalar one (2 fine points, one coarse);
    a block of nx x ny threads, at most 32 along i2 and `threads` in all,
    each axis cut into tiles of equal size; the grid (coarse planes along
    z). Returns a dict; "args" are the launch's arguments after y and x."""
    f3 = _grid3(fshape)
    c3 = _coarse_of(f3)
    vec = (f3[2] * itemsize) % 16 == 0 and aligned
    points = -(-f3[2] // (16 // itemsize if vec else 2))
    nx = -(-points // -(-points // 32))
    ny = max(1, min(threads // nx, c3[1]))
    ny = -(-c3[1] // -(-c3[1] // ny))
    grid = (-(-points // nx), min(-(-c3[1] // ny), _GRID_YZ_MAX), min(c3[0], _GRID_YZ_MAX))
    return {"fine": f3, "coarse": c3, "vector": vec, "block": (nx, ny), "grid": grid,
            "args": (*f3, *c3, int(vec), nx, ny)}


def _q1(name, plain, x, fshape, prolong, dof=1):
    fshape = tuple(int(s) for s in fshape)
    cshape = _coarse_of(fshape)
    dof = int(dof)
    if dof < 1:
        raise ValueError(f"{name}: dof {dof} < 1")
    nf, nc = _numel(fshape) * dof, _numel(cshape) * dof
    nin, nout = (nc, nf) if prolong else (nf, nc)
    _check_vector(name, x, nin)
    if x.device.type == "cpu":
        return plain(x, fshape, dof)
    y = torch.empty(nout, dtype=x.dtype, device=x.device)
    if nout and dof > 1:
        f3 = _grid3(fshape)
        cuda_build.launch(LAUNCHES, name, x, y.data_ptr(), x.data_ptr(), *f3, *_coarse_of(f3),
                          dof, entry=f"{name}_dof")
    elif nout:
        if prolong:
            f3, c3, pair = _q1_prolong_plan(fshape)
            args = (*f3, *c3, int(pair))
        else:
            args = _q1_restrict_plan(fshape, x.element_size(), x.data_ptr() % 16 == 0,
                                     _Q1R_THREADS)["args"]
        cuda_build.launch(LAUNCHES, name, x, y.data_ptr(), x.data_ptr(), *args)
    return y


def q1_prolong(x, fshape, dof=1):
    """The coarse vector x ((nf + 1) // 2 points per axis of the fine grid
    `fshape`, `dof` components per point, innermost) prolongated to the
    fine grid."""
    return _q1("q1_prolong", q1_prolong_plain, x, fshape, True, dof)


def q1_restrict(x, fshape, dof=1):
    """The fine vector x (grid `fshape`, `dof` components per point,
    innermost) restricted to the coarse grid by the exact adjoint of
    q1_prolong."""
    return _q1("q1_restrict", q1_restrict_plain, x, fshape, False, dof)
