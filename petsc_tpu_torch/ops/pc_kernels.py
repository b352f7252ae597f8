"""Hand-written Hopper kernels of the domain-decomposition PCs, beside their
plain versions.

The JAX package leaves these three functions to XLA on the TPU (jnp code,
no Pallas): scatter-adds by ``.at[].add``, padded batched products by
``einsum`` and the Neumann step by fusion. Here each is a CUDA C++ kernel
for sm_90a (sources in ``petsc_tpu_torch/csrc``, built and loaded by
:mod:`.cuda_build`):

  dst_scatter      X1  csrc/dst_scatter.cu  y[d] = sum_{dst_k = d} w_k src[sel_k]
                                            (MatIS, ASM, patch, gasm, NN, BDDC,
                                            fieldsplit, fetidp's B and B^T, the
                                            DS residual, FVPlex's face fluxes),
                                            or min(y[d], min_k w_k src[sel_k])
                                            (FVPlex's limiter)
  subdomain_apply  D1  csrc/subdomain.cu    Y[s] = M[s] (w * x[G[s]]), or M[s]^T
                                            (MatIS, NN, BDDC, fetidp)
  neumann_step     N1  csrc/neumann_step.cu z = dinv * (y - w)
                                            (-pc_factor_trisolve neumann)

X1 sums each destination's own entries in their order (tables sorted by
destination once, at set-up), so it needs no atomics and equals its plain
version bit for bit; N1 does too. D1 sums in another order than
``torch.bmm`` and is held to it at 1e-12 relative in f64, 1e-5 in f32.
Every wrapper checks device, dtype and shape, launches on the current
stream without synchronising and adds one to ``LAUNCHES[name]``. A tensor
on the CPU takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"dst_scatter": 0, "subdomain_apply": 0, "neumann_step": 0}

_VALUES = (torch.float64, torch.float32)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, t, ndim=None):
    if not isinstance(t, torch.Tensor) or t.dtype not in _VALUES:
        raise TypeError(f"{name}: expected a float64 or float32 tensor, got "
                        f"{getattr(t, 'dtype', type(t).__name__)}")
    if (ndim is not None and t.dim() != ndim) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------
# X1: the deterministic scatter by destination
# ---------------------------------------------------------------------

# destinations with more entries than this are summed by a warp each (the
# table's long list); the others by a thread each. The kernel holds the
# same number as kLongRun (csrc/dst_scatter.cu).
LONG_RUN = 32


@dataclass
class ScatterTable:
    """Entries sorted by destination (stably): ptr (n + 1), sel and w of
    each entry, int32 on the device; `steps` the plain version's schedule
    (the rows with more than j entries and their j-th entry, j = 0, 1, ...);
    `longs` the destinations with more than LONG_RUN entries as rows
    (destination, first entry, end), int32, or None when there are none."""
    n: int
    ptr: torch.Tensor
    sel: torch.Tensor
    w: torch.Tensor | None
    steps: list
    nsrc: int
    longs: torch.Tensor | None = None

    @property
    def entries(self):
        return int(self.sel.numel())

    @property
    def nlong(self):
        return 0 if self.longs is None else int(self.longs.shape[0])


def scatter_table(dst, sel, n, nsrc, w=None, device=None, dtype=torch.float64):
    """The table of y[d] = sum_{dst_k = d} w_k src[sel_k] over n
    destinations from a source of nsrc entries; entry k's order among
    those of its destination is its order here."""
    dst = np.asarray(dst, dtype=np.int64).ravel()
    sel = np.asarray(sel, dtype=np.int64).ravel()
    if len(dst) != len(sel) or (w is not None and len(np.ravel(w)) != len(dst)):
        raise ValueError("scatter_table: dst, sel and w differ in length")
    if len(dst) and (dst.min() < 0 or dst.max() >= n or sel.min() < 0 or sel.max() >= nsrc):
        raise IndexError("scatter_table: an index is out of range")
    if max(n, nsrc, len(dst)) >= 2 ** 31:
        raise ValueError("scatter_table: int32 indices reach fewer than 2^31 entries")
    order = np.argsort(dst, kind="stable")
    cnt = np.bincount(dst, minlength=n)
    ptr = np.concatenate([[0], np.cumsum(cnt)])
    steps = []
    for j in range(int(cnt.max()) if n and len(dst) else 0):
        rows = np.nonzero(cnt > j)[0]
        steps.append((torch.as_tensor(rows, device=device),
                      torch.as_tensor(ptr[rows] + j, device=device)))
    wt = None if w is None else torch.as_tensor(
        np.asarray(w, dtype=np.float64).ravel()[order], dtype=dtype, device=device)
    long_d = np.flatnonzero(cnt > LONG_RUN)
    longs = None if not len(long_d) else torch.as_tensor(
        np.stack([long_d, ptr[long_d], ptr[long_d + 1]], 1).astype(np.int32), device=device)
    return ScatterTable(n, torch.as_tensor(ptr.astype(np.int32), device=device),
                        torch.as_tensor(sel[order].astype(np.int32), device=device), wt,
                        steps, int(nsrc), longs)


# the kernel's modes (kModeAdd, kModeSet, kModeMin in csrc/dst_scatter.cu)
X1_MODES = {"add": 0, "set": 1, "min": 2}


def dst_scatter_plain(tab: ScatterTable, src, out=None, mode=None):
    """The same segment sum: y[d] = ((0 + v_1) + v_2) + ... in entry order;
    in min mode y[d] = min(out[d], v_1, v_2, ...) (torch.minimum, as
    ``.at[].min``), out updated in place and returned."""
    if mode == "min":
        sel = tab.sel.long()
        for rows, ent in tab.steps:
            v = src[sel[ent]]
            if tab.w is not None:
                v = tab.w[ent] * v
            out[rows] = torch.minimum(out[rows], v)
        return out
    y = torch.zeros(tab.n, dtype=src.dtype, device=src.device)
    sel = tab.sel.long()
    for rows, ent in tab.steps:
        v = src[sel[ent]]
        if tab.w is not None:
            v = tab.w[ent] * v
        y[rows] = y[rows] + v
    if out is None:
        return y
    if tab.steps:
        rows = tab.steps[0][0]
        out[rows] = y[rows]
    return out


def dst_scatter(tab: ScatterTable, src, out=None, mode=None):
    """y over tab's destinations. With `out` (set mode) a destination that
    no entry reaches keeps out's value and out is returned; without it every
    destination is written (add mode; signed where the weights are +-1).
    mode="min" (out required) takes out[d] = min(out[d], its entries)."""
    if mode not in (None, "min"):
        raise ValueError(f"dst_scatter: mode {mode!r} (None or 'min')")
    if mode == "min" and out is None:
        raise ValueError("dst_scatter: the min mode updates out, which is required")
    _check("dst_scatter", src, 1)
    if src.numel() != tab.nsrc:
        raise ValueError(f"dst_scatter: source of {src.numel()} entries, table for {tab.nsrc}")
    if tab.w is not None and (tab.w.dtype != src.dtype or tab.w.device != src.device):
        raise TypeError("dst_scatter: weights and source differ in dtype or device")
    if out is not None:
        _check("dst_scatter", out, 1)
        if out.numel() != tab.n or out.dtype != src.dtype or out.device != src.device:
            raise ValueError("dst_scatter: out does not match the table and the source")
    if src.device.type == "cpu":
        return dst_scatter_plain(tab, src, out, mode)
    if tab.ptr.device != src.device:
        raise ValueError(f"dst_scatter: table on {tab.ptr.device}, source on {src.device}")
    y = torch.empty(tab.n, dtype=src.dtype, device=src.device) if out is None else out
    if tab.n:
        cuda_build.launch(LAUNCHES, "dst_scatter", src, y.data_ptr(), src.data_ptr(),
                          tab.ptr.data_ptr(), tab.sel.data_ptr(), _ptr(tab.w), _ptr(tab.longs),
                          tab.n, tab.nlong,
                          X1_MODES["min" if mode == "min" else "add" if out is None else "set"])
    return y


# ---------------------------------------------------------------------
# D1: the batched dense subdomain apply
# ---------------------------------------------------------------------

@dataclass
class SubdomainTable:
    """The gather of one D1 form: G (ns, K) int32 into x, w (ns, K) or
    None, the output map out (ns, R) int32 (-1 skips) or None, the counts
    nr, nc (ns,) int32 of real rows and columns of M, or None."""
    G: torch.Tensor
    w: torch.Tensor | None = None
    out: torch.Tensor | None = None
    nr: torch.Tensor | None = None
    nc: torch.Tensor | None = None


def subdomain_table(G, w=None, out=None, nr=None, nc=None, device=None, dtype=torch.float64):
    def ints(a):
        return None if a is None else torch.as_tensor(np.asarray(a, dtype=np.int32),
                                                      device=device).contiguous()
    return SubdomainTable(ints(G), None if w is None else torch.as_tensor(
        np.asarray(w, dtype=np.float64), dtype=dtype, device=device).contiguous(),
        ints(out), ints(nr), ints(nc))


def subdomain_apply_plain(M, tab: SubdomainTable, x, transposed=False, y=None,
                          accumulate=False):
    t = x[tab.G.long()]
    if tab.w is not None:
        t = tab.w * t
    Mt = M.transpose(1, 2) if transposed else M
    r = torch.bmm(Mt, t.unsqueeze(-1)).squeeze(-1)
    if tab.out is None:
        if y is None:
            return r
        return y.add_(r) if accumulate else y.copy_(r)
    o = tab.out.long()
    keep = o >= 0
    ns = r.shape[0]
    flat = (torch.arange(ns, device=r.device).unsqueeze(1) * y.shape[1] + o)[keep]
    yv = y.view(-1)
    if accumulate:
        yv.index_add_(0, flat, r[keep])
    else:
        yv[flat] = r[keep]
    return y


def subdomain_apply(M, tab: SubdomainTable, x, transposed=False, y=None, accumulate=False):
    """Y[s, i] = sum_j M[s, i, j] w[s, j] x[G[s, j]] (M[s, j, i] when
    transposed), into y (ns x ldy) at tab.out's slots, else into a new
    (ns, R) buffer (R = M's rows, or its columns when transposed); with
    `accumulate` added to y's values."""
    name = "subdomain_apply"
    _check(name, M, 3)
    _check(name, x)
    ns, R, C = M.shape
    R_out, K = (C, R) if transposed else (R, C)
    if tuple(tab.G.shape) != (ns, K) or (tab.w is not None and tuple(tab.w.shape) != (ns, K)):
        raise ValueError(f"{name}: gather tables of shape {tuple(tab.G.shape)} for M "
                         f"{tuple(M.shape)} (transposed={transposed})")
    if tab.out is not None and (y is None or tuple(tab.out.shape) != (ns, R_out)):
        raise ValueError(f"{name}: an output map needs y and shape {(ns, R_out)}")
    if x.dtype != M.dtype or x.device != M.device or (
            tab.w is not None and (tab.w.dtype != M.dtype or tab.w.device != M.device)):
        raise TypeError(f"{name}: M, x and w differ in dtype or device")
    if y is None:
        if accumulate:
            raise ValueError(f"{name}: accumulate needs y")
        y = torch.empty((ns, R_out), dtype=M.dtype, device=M.device)
    else:
        _check(name, y, 2)
        if y.shape[0] != ns or (tab.out is None and y.shape[1] != R_out) \
                or y.dtype != M.dtype or y.device != M.device:
            raise ValueError(f"{name}: y of shape {tuple(y.shape)} for {(ns, R_out)}")
    if M.device.type == "cpu":
        return subdomain_apply_plain(M, tab, x, transposed, y, accumulate)
    if tab.G.device != M.device:
        raise ValueError(f"{name}: tables on {tab.G.device}, M on {M.device}")
    if ns and R_out:
        cuda_build.launch(LAUNCHES, name, M, int(transposed), y.data_ptr(), M.data_ptr(),
                          x.data_ptr(), tab.G.data_ptr(), _ptr(tab.w), _ptr(tab.out),
                          _ptr(tab.nr), _ptr(tab.nc), ns, R, C, y.shape[1], int(accumulate))
    return y


# ---------------------------------------------------------------------
# N1: the Neumann step
# ---------------------------------------------------------------------

def neumann_step_plain(dinv, y, w):
    return dinv * (y - w)


def neumann_step(dinv, y, w):
    """z = dinv * (y - w) in one pass."""
    for t in (dinv, y, w):
        _check("neumann_step", t, 1)
        if t.shape != y.shape or t.dtype != y.dtype or t.device != y.device:
            raise ValueError("neumann_step: dinv, y and w differ in shape, dtype or device")
    if y.device.type == "cpu":
        return neumann_step_plain(dinv, y, w)
    z = torch.empty_like(y)
    if y.numel():
        cuda_build.launch(LAUNCHES, "neumann_step", y, z.data_ptr(), dinv.data_ptr(),
                          y.data_ptr(), w.data_ptr(), y.numel())
    return z
