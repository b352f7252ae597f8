"""Profiling: stages, events, flop counts, the -log_view table, the
nested (flamegraph and XML) views and -info.

Counterpart of ``petsc_tpu/sys/logging.py`` (reference
src/sys/logging/plog.c:2057 PetscLogView, include/petsclog.h:422
PetscLogEventBegin): events are host-side timed regions with hand-counted
flops. The card runs asynchronously, so an event times the card's work
only where it synchronizes: ``event(..., sync=t)`` waits for the device of
the CUDA tensor (or Vec) ``t`` before the clock stops, and KSP.solve
synchronizes before it logs. Kernel-level detail comes from
``torch.profiler``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class _EventPerf:
    count: int = 0
    time: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    messages: float = 0.0
    reductions: float = 0.0


@dataclass
class _Stage:
    name: str
    events: dict = field(default_factory=dict)
    time: float = 0.0
    started: float = 0.0


class Profiler:
    def __init__(self):
        self.enabled = True
        self._stages: dict[str, _Stage] = {}
        self._stage_stack: list[_Stage] = []
        self._event_stack: list[str] = []       # nested-handler call path
        self._nested: dict[str, _EventPerf] = {}  # "a;b;c" -> perf
        self._t0 = time.perf_counter()
        self.stage_push("Main Stage")

    # ---------------- stages ----------------

    def stage_push(self, name: str):
        st = self._stages.get(name)
        if st is None:
            st = self._stages[name] = _Stage(name)
        st.started = time.perf_counter()
        self._stage_stack.append(st)

    def stage_pop(self):
        st = self._stage_stack.pop()
        st.time += time.perf_counter() - st.started

    @contextmanager
    def stage(self, name):
        self.stage_push(name)
        try:
            yield
        finally:
            self.stage_pop()

    def _cur(self) -> _Stage:
        return self._stage_stack[-1] if self._stage_stack else self._stages["Main Stage"]

    # ---------------- events ----------------

    @contextmanager
    def event(self, name: str, flops: float = 0.0, bytes: float = 0.0,
              messages: float = 0.0, reductions: float = 0.0, sync=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(sync)
            dt = time.perf_counter() - t0
            ev = self._cur().events.setdefault(name, _EventPerf())
            ev.count += 1
            ev.time += dt
            ev.flops += flops
            ev.bytes += bytes
            ev.messages += messages
            ev.reductions += reductions
            self._record_nested(name, dt)

    def log_flops(self, name: str, flops: float):
        ev = self._cur().events.setdefault(name, _EventPerf())
        ev.flops += flops

    def log_event(self, name: str, time_s: float, flops: float = 0.0,
                  bytes: float = 0.0, count: int = 1, reductions: float = 0.0):
        """Record a pre-timed event (e.g. measured around a jitted solve)."""
        ev = self._cur().events.setdefault(name, _EventPerf())
        ev.count += count
        ev.time += time_s
        ev.flops += flops
        ev.bytes += bytes
        ev.reductions += reductions
        self._record_nested(name, time_s, count)

    # ---------------- nested handler (xmllogevent.c analog) ----------------

    def _record_nested(self, name, dt, count=1):
        path = ";".join(self._event_stack + [name])
        ev = self._nested.setdefault(path, _EventPerf())
        ev.count += count
        ev.time += dt

    def event_push(self, name: str):
        """Enter a nested timing scope: events logged until the matching
        event_pop are attributed to the call path (PetscLogHandlerNested)."""
        self._event_stack.append(name)

    def event_pop(self):
        self._event_stack.pop()

    @contextmanager
    def nested(self, name: str):
        t0 = time.perf_counter()
        self.event_push(name)
        try:
            yield
        finally:
            self.event_pop()
            self._record_nested(name, time.perf_counter() - t0)

    def view_flamegraph(self, file=None):
        """Collapsed-stack output consumable by speedscope/flamegraph.pl —
        PETSc's -log_view :f.txt:ascii_flamegraph (plog.c flamegraph
        handler). SELF time per path in microseconds."""
        import builtins
        p = (lambda *a: print(*a, file=file)) if file else builtins.print
        for path, ev in sorted(self._nested.items()):
            child_t = sum(e.time for pth, e in self._nested.items()
                          if pth.startswith(path + ";")
                          and ";" not in pth[len(path) + 1:])
            self_us = max(ev.time - child_t, 0.0) * 1e6
            p(f"{path} {int(round(self_us))}")

    def view_nested_xml(self, file=None):
        """Nested timing tree as XML, the shape PETSc's ascii_xml nested
        log handler emits (src/sys/logging/handler/impls/nested)."""
        import builtins
        p = (lambda *a: print(*a, file=file)) if file else builtins.print
        total = max(self.total_time(), 1e-300)
        p('<?xml version="1.0" encoding="UTF-8"?>')
        p('<root>')
        p(f'  <totaltime>{total:.6f}</totaltime>')
        p('  <timertree>')

        def emit(prefix, depth):
            pad = "    " * (depth + 1)
            kids = {pth: e for pth, e in self._nested.items()
                    if pth.startswith(prefix) and
                    ";" not in pth[len(prefix):]}
            for pth, e in sorted(kids.items(), key=lambda kv: -kv[1].time):
                name = pth.rsplit(";", 1)[-1]
                p(f"{pad}<event>")
                p(f"{pad}  <name>{name}</name>")
                p(f"{pad}  <time>{e.time:.6f}</time>")
                p(f"{pad}  <ncalls>{e.count}</ncalls>")
                p(f"{pad}  <fraction>{e.time / total:.4f}</fraction>")
                emit(pth + ";", depth + 1)
                p(f"{pad}</event>")

        emit("", 1)
        p('  </timertree>')
        p('</root>')

    # ---------------- reporting ----------------

    def total_time(self):
        return time.perf_counter() - self._t0

    def view(self, file=None):
        """Print a -log_view-style summary table (plog.c:2057 analog)."""
        import builtins
        p = (lambda *a: print(*a, file=file)) if file else builtins.print
        total = self.total_time()
        p("=" * 100)
        p("petsc_tpu_torch -log_view   (host wall clock; flops hand-counted per event)")
        p(f"Total wall time: {total:.4e} s")
        p("=" * 100)
        hdr = f"{'Event':<28}{'Count':>7}{'Time (s)':>12}{'Flops':>12}{'MF/s':>10}{'GB':>10}{'Red.':>8}{'%T':>6}"
        for st in self._stages.values():
            if not st.events:
                continue
            p(f"\n--- Stage: {st.name}")
            p(hdr)
            for name, ev in sorted(st.events.items(), key=lambda kv: -kv[1].time):
                mfs = ev.flops / ev.time / 1e6 if ev.time > 0 else 0.0
                pct = 100.0 * ev.time / total if total > 0 else 0.0
                p(f"{name:<28}{ev.count:>7}{ev.time:>12.4e}{ev.flops:>12.3e}{mfs:>10.1f}"
                  f"{ev.bytes / 1e9:>10.3f}{ev.reductions:>8.0f}{pct:>6.1f}")
        p("=" * 100)

    def get_event(self, name, stage="Main Stage"):
        return self._stages[stage].events.get(name)

    def reset(self):
        # the nested records go too (the reference keeps them across a
        # reset, so its flamegraph still shows events from before it)
        self._stages.clear()
        self._stage_stack.clear()
        self._event_stack.clear()
        self._nested.clear()
        self._t0 = time.perf_counter()
        self.stage_push("Main Stage")


def _synchronize(sync):
    """Wait for the device that `sync` (a tensor, or a Vec) lives on, if it
    is a card."""
    t = getattr(sync, "array", sync)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def torch_trace(dirname=None):
    """The counterpart of the reference's ``jax_trace`` (sys/logging.py:
    226), a bridge to the framework's profiler: records the block under
    ``torch.profiler`` (the host, and the card's kernels where CUDA is
    available) and writes a Chrome trace, ``trace.json``, into `dirname`
    (by default ``petsc_tpu_torch_trace`` in the temporary directory).
    Yields the directory."""
    import os
    import tempfile
    dirname = dirname or os.path.join(tempfile.gettempdir(), "petsc_tpu_torch_trace")
    os.makedirs(dirname, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield dirname
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


jax_trace = torch_trace   # the reference's name, for scripts written against it


# ---------------- verbose info (-info, reference src/sys/info/verboseinfo.c)

_info_enabled = False


def set_info(flag: bool):
    global _info_enabled
    _info_enabled = bool(flag)


def info(obj, msg: str):
    if _info_enabled:
        cls = type(obj).__name__ if obj is not None else "None"
        print(f"[0] {cls}: {msg}")
