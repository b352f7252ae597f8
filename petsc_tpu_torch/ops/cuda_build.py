"""Build and load the port's CUDA kernels (``petsc_tpu_torch/csrc``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``. The build
happens at first use, into ``petsc_tpu_torch/_build/<hash of sources and
flags>/``, so a changed source never loads a stale library. Nothing is
built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..sys.error import Error

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("probe.cu", "triad.cu", "axpy_normsq.cu", "dot2.cu", "const_stencil.cu",
           "csr_spmv.cu", "gather.cu", "row_gather.cu", "lane_shuffle.cu", "cheby.cu",
           "dnd_stencil.cu", "q1.cu", "trisolve.cu", "bsr_spmv.cu", "agg_block.cu",
           "csr_spmm.cu", "dst_scatter.cu", "subdomain.cu", "neumann_step.cu",
           "swarm_cic.cu")
HEADERS = ("common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBNAME = "libpetsc_tpu_torch_kernels.so"

_vp, _i32, _i64, _f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# entry point -> argument types; every entry point returns a cudaError_t as int
SIGNATURES = {
    "ptt_probe": (_vp, _vp, _i32, _i32, _vp),
    "ptt_triad_f64": (_vp, _vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_triad_f32": (_vp, _vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_triad_config": (_i32, _i64, _i32, _vp),
    "ptt_axpy_normsq_f64": (_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_axpy_normsq_f32": (_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_dot2_f64": (_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_dot2_f32": (_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_dot2_config": (_i32, _i64, _i32, _i32, _vp),
    "ptt_const_stencil_f64": (_vp, _vp, _i32, _i32, _i32, _f64, _f64, _i32, _i32, _vp, _i32, _vp),
    "ptt_const_stencil_f32": (_vp, _vp, _i32, _i32, _i32, _f64, _f64, _i32, _i32, _vp, _i32, _vp),
    "ptt_const_stencil_map": (_vp, _vp, _i32, _i32, _i32, _i32),
    "ptt_const_stencil_config": (_i32, _i32, _i32, _i32, _vp),
    "ptt_csr_spmv_f64": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _vp),
    "ptt_csr_spmv_f32": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _vp),
    "ptt_csr_spmm_f64": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _i32, _vp),
    "ptt_csr_spmm_f32": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _i32, _vp),
    "ptt_gather_f64": (_vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_gather_f32": (_vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_gather2_f64": (_vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_gather2_f32": (_vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_row_gather_f64": (_vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_row_gather_f32": (_vp, _vp, _vp, _i64, _i32, _i32, _vp),
    "ptt_lane_shuffle_f64": (_vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_lane_shuffle_f32": (_vp, _vp, _vp, _i64, _i32, _vp),
    "ptt_cheby_update_f64": (_i32, _vp, _vp, _vp, _vp, _vp, _vp, _f64, _f64, _f64, _i64, _i32, _vp),
    "ptt_cheby_update_f32": (_i32, _vp, _vp, _vp, _vp, _vp, _vp, _f64, _f64, _f64, _i64, _i32, _vp),
    "ptt_dnd_stencil_f64": (_vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _i32, _vp),
    "ptt_dnd_stencil_f32": (_vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _i32, _vp),
    "ptt_dnd_window_f64": (_vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp, _i32, _i32, _i32,
                           _i32, _i32, _vp),
    "ptt_dnd_window_f32": (_vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp, _i32, _i32, _i32,
                           _i32, _i32, _vp),
    "ptt_dnd_window_config": (_i32, _i32, _i32, _i32, _i32, _i32, _vp),
    "ptt_q1_prolong_f64": (_vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp),
    "ptt_q1_prolong_f32": (_vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp),
    "ptt_q1_restrict_f64": (_vp, _vp, *(_i32,) * 10, _vp),
    "ptt_q1_restrict_f32": (_vp, _vp, *(_i32,) * 10, _vp),
    "ptt_q1_prolong_dof_f64": (_vp, _vp, *(_i32,) * 8, _vp),
    "ptt_q1_prolong_dof_f32": (_vp, _vp, *(_i32,) * 8, _vp),
    "ptt_q1_restrict_dof_f64": (_vp, _vp, *(_i32,) * 8, _vp),
    "ptt_q1_restrict_dof_f32": (_vp, _vp, *(_i32,) * 8, _vp),
    "ptt_trisolve_f64": (_vp, _vp, _vp, _vp, _i32, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32,
                         _i32, _vp, _i32, _vp),
    "ptt_trisolve_f32": (_vp, _vp, _vp, _vp, _i32, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32,
                         _i32, _vp, _i32, _vp),
    "ptt_trisolve_config": (_i32, _i32, _i32, _i32, _i32, _i32, _vp),
    "ptt_bsr_spmv_f64": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _vp),
    "ptt_bsr_spmv_f32": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i32, _i32, _vp),
    "ptt_bsr_spmv_config": (_i64, _i32, _i32, _i32, _vp),
    "ptt_agg_block_apply_f64": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _vp),
    "ptt_agg_block_apply_f32": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _vp),
    "ptt_agg_block_cheby_f64": (_i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32,
                                _f64, _f64, _f64, _i32, _vp),
    "ptt_agg_block_cheby_f32": (_i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32,
                                _f64, _f64, _f64, _i32, _vp),
}
for _t in ("f64", "f32"):
    SIGNATURES[f"ptt_dst_scatter_{_t}"] = (_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32,
                                           _i32, _vp)
    SIGNATURES[f"ptt_subdomain_apply_{_t}"] = (_i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                               *(_i32,) * 5, _i32, _vp)
    SIGNATURES[f"ptt_neumann_step_{_t}"] = (_vp, _vp, _vp, _vp, _i64, _i32, _vp)
    SIGNATURES[f"ptt_cic_deposit_{_t}"] = (_vp, _vp, _vp, _i64, _i32, _vp, _vp, _vp, _vp, _i32,
                                           _i32, _vp, _i64, _f64, _f64, _f64, *(_i32,) * 7,
                                           _vp, _i32, _vp)
    SIGNATURES[f"ptt_cic_interp_{_t}"] = (_vp, _i64, _i32, _vp, _vp, _vp, _f64, _f64, _f64,
                                          *(_i32,) * 6, _i32, _vp)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

_lib = None
build_seconds = None      # wall time of this process's build, None if loaded from disk


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise Error("nvcc not found (searched PATH and $CUDA_HOME/bin): the port's "
                "kernels are built from petsc_tpu_torch/csrc at first use")


def _tag() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / _tag() / LIBNAME


def _build(dest: Path):
    """Compile every source in parallel, link, and move the library to
    `dest` in one rename (so a concurrent process never loads half a file)."""
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    dest.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dest.parent) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(f"{src} (exit {p.returncode}):\n{out}")
        (dest.parent / "nvcc.log").write_text("\n".join(logs))
        if failed:
            raise Error("nvcc failed on " + "\n".join(failed))
        lib_tmp = tmp / LIBNAME
        link = subprocess.run([nvcc, "-shared", "-o", str(lib_tmp),
                               *[str(o) for _, o, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise Error(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, dest)
    build_seconds = time.perf_counter() - t0


def library():
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, rc: int):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().ptt_error_string(rc).decode()
        raise Error(f"{name}: CUDA error {rc} ({msg})")


def launch(counts: dict, name: str, like, *args, entry: str | None = None):
    """Call entry point ``ptt_<entry>_<f64|f32>`` (entry defaults to name;
    the dtype of tensor `like`) on like's device and current stream, raise
    on a CUDA error, and add one to ``counts[name]``."""
    fn = getattr(library(), f"ptt_{entry or name}_{_SUFFIX[like.dtype]}")
    rc = fn(*args, like.get_device(), torch.cuda.current_stream(like.device).cuda_stream)
    check(name, rc)
    counts[name] += 1
