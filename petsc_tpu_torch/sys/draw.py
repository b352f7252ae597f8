"""PetscDraw: lightweight visualization (line graphs, 2-D contours).

Counterpart of ``petsc_tpu/sys/draw.py``. Behavioral reference: src/sys/classes/draw (PetscDrawLG line graphs used
by -ksp_monitor_lg_residualnorm, PetscDrawTensorContour used by
VecView_MPI_Draw_DA2d). No X11 windows; the backends are: ascii (terminal braille-free block rendering, always
available) and file (PPM image dump) — both dependency-free.
"""

from __future__ import annotations

import numpy as np


class DrawLG:
    """PetscDrawLG: accumulate (x, y) points per curve, render as an
    ASCII line graph (semilogy when values span decades)."""

    def __init__(self, dim=1, width=60, height=16):
        self.dim = dim
        self._pts: list[list] = [[] for _ in range(dim)]
        self.width, self.height = width, height

    def addPoint(self, x, y):
        ys = np.atleast_1d(y)
        for k in range(self.dim):
            self._pts[k].append((float(x), float(ys[k])))
        return self

    def reset(self):
        self._pts = [[] for _ in range(self.dim)]

    def draw(self, file=None):
        import builtins
        p = (lambda *a: print(*a, file=file)) if file else builtins.print
        allpts = [pt for c in self._pts for pt in c]
        if not allpts:
            return
        ys = np.array([y for _, y in allpts])
        xs = np.array([x for x, _ in allpts])
        logy = ys.min() > 0 and ys.max() / max(ys.min(), 1e-300) > 100
        fy = np.log10(ys) if logy else ys
        ylo, yhi = float(fy.min()), float(fy.max())
        if yhi == ylo:
            yhi = ylo + 1
        xlo, xhi = float(xs.min()), float(xs.max())
        if xhi == xlo:
            xhi = xlo + 1
        grid = [[" "] * self.width for _ in range(self.height)]
        marks = "*+xo#@"
        for k, curve in enumerate(self._pts):
            for x, y in curve:
                v = np.log10(y) if logy else y
                c = int((x - xlo) / (xhi - xlo) * (self.width - 1))
                r = int((yhi - v) / (yhi - ylo) * (self.height - 1))
                grid[r][c] = marks[k % len(marks)]
        scale = "log10 " if logy else ""
        p(f"  {scale}y: [{ys.min():.3e}, {ys.max():.3e}]  "
          f"x: [{xlo:g}, {xhi:g}]")
        for row in grid:
            p("  |" + "".join(row) + "|")
        p("  +" + "-" * self.width + "+")


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else a


def tensor_contour(arr2d, levels=" .:-=+*#%@", file=None):
    """PetscDrawTensorContour analog: ASCII density plot of a 2-D field
    (numpy or a tensor on any device)."""
    import builtins
    p = (lambda *a: print(*a, file=file)) if file else builtins.print
    a = np.asarray(_host(arr2d), dtype=np.float64)
    lo, hi = float(a.min()), float(a.max())
    rng = hi - lo if hi > lo else 1.0
    q = ((a - lo) / rng * (len(levels) - 1)).astype(int)
    for row in q[::-1]:
        p("".join(levels[v] for v in row))
    p(f"[{lo:.3e} '{levels[0]}' .. {hi:.3e} '{levels[-1]}']")


def ppm_save(path, arr2d):
    """Dump a 2-D field as a grayscale binary PPM (P5) image."""
    a = np.asarray(_host(arr2d), dtype=np.float64)
    lo, hi = a.min(), a.max()
    g = ((a - lo) / (hi - lo if hi > lo else 1.0) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{g.shape[1]} {g.shape[0]}\n255\n".encode())
        f.write(g[::-1].tobytes())
