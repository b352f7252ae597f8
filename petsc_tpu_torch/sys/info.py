"""PetscInfo: -info verbose runtime introspection per class
(reference src/sys/info/verboseinfo.c).

Counterpart of ``petsc_tpu/sys/info.py``: the class-list filter of
``-info KSP,PC`` and ``warn_full_gather``, the one-time warning where a
distributed operator falls back to a serial full gather. On one device
(every operator of the port until distribution is ported) it never
fires."""

from __future__ import annotations


def info_enabled(cls_name: str | None = None) -> bool:
    from .. import config
    st = config.state()
    flag = st.options.get_string("info", default=None)
    if flag is None and not st.options.has_name("info"):
        return False
    if flag in (None, "", "true"):
        return True
    # -info <classlist> filters by class name(s)
    if cls_name is None:
        return True
    return cls_name.lower() in {c.strip().lower() for c in flag.split(",")}


def info(obj, msg: str):
    """PetscInfo(obj, ...) analog: print when -info is active (optionally
    filtered by class list: -info KSP,PC)."""
    cls = getattr(obj, "_class_name", None) or type(obj).__name__
    if info_enabled(cls):
        print(f"[0] {cls} {msg}")


_GATHER_WARNED: set[str] = set()


def warn_full_gather(A, where: str, threshold_rows: int = 200_000):
    """One-time warning when a DISTRIBUTED operator falls back to a serial
    full-matrix gather (the to_scipy() scaffolding paths in ASM /
    fieldsplit / GAMG): fine as scaffolding on small problems, but a
    512^3-class run must never hit it. Emits -info always; a Python warning once per site above
    `threshold_rows`."""
    nsh = getattr(getattr(A, "comm", None), "nshards", 1)
    if nsh <= 1:
        return
    n = A.row_layout.N if hasattr(A, "row_layout") else 0
    info(A, f"{where}: serial fallback gathers the FULL distributed "
            f"operator ({n} rows over {nsh} shards)")
    if n >= threshold_rows and where not in _GATHER_WARNED:
        _GATHER_WARNED.add(where)
        import warnings
        warnings.warn(
            f"petsc_tpu_torch {where}: distributed operator ({n} rows, {nsh} "
            f"shards) fell back to a serial full gather — this path is "
            f"scaffolding and will not scale; use the distributed setup "
            f"(default block counts / sharded operators) instead",
            RuntimeWarning, stacklevel=3)
