"""petsc_tpu_torch kernel module: the plain path (CPU tensors) against the
Pallas kernels of petsc_tpu (interpret mode), the wrappers' input checks
and the loader. The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py.

Tolerances: 1e-12 relative in float64, 1e-5 in float32 (sums are taken in
another order than the Pallas tiles take them)."""

import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsc_tpu.ops import pallas_kernels as pk_jax
from petsc_tpu_torch.ops import block_kernels
from petsc_tpu_torch.ops import cuda_build
from petsc_tpu_torch.ops import gather_kernels as gk
from petsc_tpu_torch.ops import grid_kernels
from petsc_tpu_torch.ops import particle_kernels
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.ops import pc_kernels
from petsc_tpu_torch.ops import trisolve
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)

LENGTHS = (70001, 65536 + 3)
DTYPES = (np.float64, np.float32)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.random(n).astype(dtype), rng.random(n).astype(dtype), dtype(-0.37)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_triad_matches_pallas(n, dtype):
    b, c, alpha = _inputs(n, dtype, 0)
    ref = pk_jax.triad(jnp.asarray(b), jnp.asarray(c), alpha, interpret=True)
    out = pk.triad(torch.from_numpy(b), torch.from_numpy(c), torch.tensor(alpha))
    assert out.dtype == torch.from_numpy(b).dtype
    assert _rel(out.numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_axpy_normsq_matches_pallas(n, dtype):
    x, y, alpha = _inputs(n, dtype, 1)
    ref_v, ref_n = pk_jax.axpy_normsq(alpha, jnp.asarray(x), jnp.asarray(y),
                                      interpret=True)
    v, nsq = pk.axpy_normsq(torch.tensor(alpha), torch.from_numpy(x),
                            torch.from_numpy(y))
    assert nsq.dim() == 0 and nsq.dtype == v.dtype
    assert _rel(v.numpy(), ref_v) <= TOL[dtype]
    assert _rel(nsq.numpy(), ref_n) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_dot2_matches_pallas(n, dtype):
    x, y, _ = _inputs(n, dtype, 2)
    r1, r2 = pk_jax.dot2(jnp.asarray(x), jnp.asarray(y), interpret=True)
    d1, d2 = pk.dot2(torch.from_numpy(x), torch.from_numpy(y))
    assert d1.dim() == 0 and d2.dim() == 0
    assert _rel(d1.numpy(), r1) <= TOL[dtype]
    assert _rel(d2.numpy(), r2) <= TOL[dtype]


def test_in_place_updates_match_out_of_place():
    x, y, alpha = _inputs(1001, np.float64, 3)
    a = torch.tensor(alpha)
    xt, yt = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    want = pk.triad(xt, yt, a)
    got = pk.triad(xt, yt, a, out=xt)
    assert got is xt and torch.equal(xt, want)
    xt, yt = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    want_v, want_n = pk.axpy_normsq(a, xt, yt)
    got_v, got_n = pk.axpy_normsq(a, xt, yt, out=yt)
    assert got_v is yt and torch.equal(yt, want_v) and torch.equal(got_n, want_n)


def _bad_calls():
    v = torch.ones(8, dtype=torch.float64)
    a = torch.tensor(2.0, dtype=torch.float64)
    return {
        "alpha_float": lambda: pk.triad(v, v, 2.0),
        "alpha_1d": lambda: pk.triad(v, v, a.reshape(1)),
        "alpha_dtype": lambda: pk.axpy_normsq(a.float(), v, v),
        "mixed_dtype": lambda: pk.dot2(v, v.float()),
        "half": lambda: pk.dot2(v.half(), v.half()),
        "length": lambda: pk.triad(v, torch.ones(9, dtype=torch.float64), a),
        "two_d": lambda: pk.dot2(v.reshape(2, 4), v.reshape(2, 4)),
        "strided": lambda: pk.triad(torch.ones(16, dtype=torch.float64)[::2], v, a),
        "out_length": lambda: pk.triad(v, v, a, out=torch.empty(7, dtype=torch.float64)),
        "stencil_length": lambda: pk.const_stencil(v, (3, 3), 8.0, -1.0, True),
        "probe_shape": lambda: pk.probe(torch.zeros(8, 128)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    pk.reset_launches()
    v = torch.arange(8, dtype=torch.float64)
    a = torch.tensor(0.5, dtype=torch.float64)
    pk.triad(v, v, a)
    pk.axpy_normsq(a, v, v)
    pk.dot2(v, v)
    pk.const_stencil(v, (2, 2, 2), 26.0, -1.0, True)
    assert torch.equal(pk.probe(torch.zeros(16, 128)), torch.ones(16, 128))
    assert all(n == 0 for n in pk.LAUNCHES.values())


def test_device_measurements_refuse_the_cpu():
    with pytest.raises(Error):
        pk.kernels_available("cpu")
    with pytest.raises(Error):
        pk.streams_triad_bandwidth(n=16, device="cpu")


def test_every_csrc_source_is_built():
    csrc = Path(cuda_build.CSRC)
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(cuda_build.SOURCES)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(cuda_build.HEADERS)
    # the entry points the sources define are the ones declared to ctypes,
    # and they are the ones the wrappers call (ptt_<kernel>_<dtype>)
    defined = set()
    for src in cuda_build.SOURCES:
        defined |= set(re.findall(r'extern "C" int (ptt_\w+)\(', (csrc / src).read_text()))
    assert defined == set(cuda_build.SIGNATURES)
    # (V1's window kernel counts its launches as dnd_stencil, Q1P's and Q1R's
    # dof entries as q1_prolong and q1_restrict; C1's z modes launch through
    # C1's entry point and count apart, as cheby_update_z; V1T launches V1's
    # generic entry and counts apart, as dnd_stencil_t)
    kernels = [k for k in (*pk.LAUNCHES, *gk.LAUNCHES, *grid_kernels.LAUNCHES,
                           *trisolve.LAUNCHES, *block_kernels.LAUNCHES, *pc_kernels.LAUNCHES,
                           *particle_kernels.LAUNCHES, "dnd_window",
                           "q1_prolong_dof", "q1_restrict_dof")
               if k not in ("probe", "cheby_update_z", "dnd_stencil_t")]
    called = {"ptt_probe", "ptt_triad_config", "ptt_dot2_config", "ptt_const_stencil_map",
              "ptt_const_stencil_config", "ptt_dnd_window_config", "ptt_trisolve_config",
              "ptt_bsr_spmv_config"} \
        | {f"ptt_{k}_{s}" for k in kernels for s in ("f64", "f32")}
    assert called == defined


def test_loader_raises_without_nvcc(monkeypatch):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "BUILD", Path("/nonexistent-build-dir"))
    with pytest.raises(Error, match="nvcc not found"):
        cuda_build.library()
