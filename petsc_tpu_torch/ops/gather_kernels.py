"""Hand-written Hopper gather kernels, beside their plain versions.

Counterparts of the four gather probes that the JAX package wrote as
Pallas kernels for the TPU (CUDA C++ for sm_90a, sources in
``petsc_tpu_torch/csrc``, built and loaded by :mod:`.cuda_build`):

  lane_shuffle  K5  csrc/lane_shuffle.cu  examples/pallas_shuffle_probe.py:60 probe_s1
  row_gather    K6  csrc/row_gather.cu    examples/pallas_shuffle_probe.py:92 probe_s2
  gather2       K7  csrc/gather.cu        examples/pallas_shuffle_probe.py:125 probe_s3
  gather        K8  csrc/gather.cu        examples/pallas_gather_probe.py:50 probe_g1

``gather`` is on the assembled-matrix path: the COO numeric assembly's
``v[perm]`` and the diagonal refresh ``csr_vals[diag_pos]``
(:meth:`petsc_tpu_torch.mat.aij.MatAIJ.setValuesCOO`).

Every wrapper checks device, dtype (float64 or float32 values, int32
indices), shape and contiguity, and that the gathered array holds fewer
than 2^31 entries (the indices are int32); with ``check=True`` (the
default) it also checks the indices' bounds, which reads two numbers
back from the card. A caller that made the indices itself passes
``check=False`` and vouches that they are in range: no kernel checks or
wraps an index, so one out of range reads outside its array on the card
(the plain version raises). Outputs are allocated with ``torch.empty``; the kernel
launches on the current stream without synchronising and adds one to
``LAUNCHES[name]``. A tensor on the CPU takes the plain PyTorch version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"lane_shuffle": 0, "row_gather": 0, "gather2": 0, "gather": 0}

_VALUES = (torch.float64, torch.float32)
_ROW = 128     # the lane shuffle's row width (the TPU's lane count)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_values(name, x, ndim):
    if not isinstance(x, torch.Tensor) or x.dtype not in _VALUES:
        raise TypeError(f"{name}: values must be a float64 or float32 tensor")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: values must be a contiguous {ndim}-D tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: int32 indices reach fewer than 2^31 entries, "
                         f"the values hold {x.numel()}")


def _check_index(name, idx, like, bound, check):
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be an int32 tensor")
    if not idx.is_contiguous():
        raise ValueError(f"{name}: indices must be contiguous")
    if idx.device != like.device:
        raise ValueError(f"{name}: indices on {idx.device}, values on {like.device}")
    if check and idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= bound:
            raise IndexError(f"{name}: index range [{lo}, {hi}] outside [0, {bound})")


# ---------------------------------------------------------------------
# K8: gather  o = x[idx]
# ---------------------------------------------------------------------

def gather_plain(x, idx):
    return x[idx.long()]


def gather(x, idx, check=True):
    """o[i] = x[idx[i]] for a 1-D x; o has idx's shape."""
    _check_values("gather", x, 1)
    _check_index("gather", idx, x, x.numel(), check)
    if x.device.type == "cpu":
        return gather_plain(x, idx)
    o = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if idx.numel():
        cuda_build.launch(LAUNCHES, "gather", x, o.data_ptr(), x.data_ptr(),
                          idx.data_ptr(), idx.numel())
    return o


# ---------------------------------------------------------------------
# K7: gather2  o = x2.flat[w q + s]
# ---------------------------------------------------------------------

def gather2_plain(x2, q, s):
    return x2.reshape(-1)[q.long() * x2.shape[1] + s.long()]


def gather2(x2, q, s, check=True):
    """o[c] = x2[q[c], s[c]] for a 2-D x2 (B, w); q and s have one shape,
    which o takes."""
    _check_values("gather2", x2, 2)
    if not isinstance(q, torch.Tensor) or not isinstance(s, torch.Tensor) \
            or q.shape != s.shape:
        raise ValueError("gather2: q and s must be tensors of one shape")
    _check_index("gather2", q, x2, x2.shape[0], check)
    _check_index("gather2", s, x2, x2.shape[1], check)
    if x2.device.type == "cpu":
        return gather2_plain(x2, q, s)
    o = torch.empty(q.shape, dtype=x2.dtype, device=x2.device)
    if q.numel():
        cuda_build.launch(LAUNCHES, "gather2", x2, o.data_ptr(), x2.data_ptr(),
                          q.data_ptr(), s.data_ptr(), q.numel(), x2.shape[1])
    return o


# ---------------------------------------------------------------------
# K6: row_gather  o[c, :] = x2[q[c], :]
# ---------------------------------------------------------------------

def row_gather_plain(x2, q):
    return x2[q.long()]


def row_gather(x2, q, check=True):
    """o[c, :] = x2[q[c], :] for a 2-D x2 (B, w) and a 1-D q (C,)."""
    _check_values("row_gather", x2, 2)
    if not isinstance(q, torch.Tensor) or q.dim() != 1:
        raise ValueError("row_gather: q must be a 1-D tensor")
    _check_index("row_gather", q, x2, x2.shape[0], check)
    if x2.device.type == "cpu":
        return row_gather_plain(x2, q)
    o = torch.empty((q.numel(), x2.shape[1]), dtype=x2.dtype, device=x2.device)
    if o.numel():
        cuda_build.launch(LAUNCHES, "row_gather", x2, o.data_ptr(), x2.data_ptr(),
                          q.data_ptr(), q.numel(), x2.shape[1])
    return o


# ---------------------------------------------------------------------
# K5: lane_shuffle  o[r, l] = V[r, s[r, l]]
# ---------------------------------------------------------------------

def lane_shuffle_plain(V, s):
    return torch.gather(V, 1, s.long())


def lane_shuffle(V, s, check=True):
    """o[r, l] = V[r, s[r, l]] for V and s of shape (C, 128)."""
    _check_values("lane_shuffle", V, 2)
    if V.shape[1] != _ROW or not isinstance(s, torch.Tensor) or s.shape != V.shape:
        raise ValueError(f"lane_shuffle: V and s must both be (C, {_ROW}), got "
                         f"{tuple(V.shape)} and {tuple(getattr(s, 'shape', ()))}")
    _check_index("lane_shuffle", s, V, _ROW, check)
    if V.device.type == "cpu":
        return lane_shuffle_plain(V, s)
    o = torch.empty_like(V)
    if V.numel():
        cuda_build.launch(LAUNCHES, "lane_shuffle", V, o.data_ptr(), V.data_ptr(),
                          s.data_ptr(), V.shape[0])
    return o
