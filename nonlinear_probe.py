#!/usr/bin/env python3
"""Host cost of the nonlinear loops' derivative actions.

    python nonlinear_probe.py [--device cpu|cuda] [--reps N]

Times one J v of the ported heat step's residual (x - dt/2
Laplacian(x), 33^2) and of ex19's (25^2 x 4) through ``torch.func.jvp``
and through ``ops.autodiff.Linearization`` (its build at a point, then
each product), and one Hessian-vector product of the chained Rosenbrock
(n = 2^10) through the jvp of ``torch.func.grad`` and through
``HessianAction``: milliseconds of wall time per call on the given device,
after a warm-up, and the largest difference of the results, with the
card's nvidia-smi name and power limit on CUDA. One JSON line.
"""

import json
import sys
import time


def _card():
    """nvidia-smi's name and power limit of the card, or None without one."""
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _ms(fn, reps):
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def host_costs(device, reps):
    import torch
    import petsc_tpu_torch as pt
    from petsc_tpu_torch.examples import ex19, heat
    from petsc_tpu_torch.ops.autodiff import HessianAction, Linearization
    pt.init(device=device)
    rhs = heat.make_rhs(pt.DMDA.create(2, (33, 33)))
    cases = {"heat_33": (lambda x: x - 0.5 * rhs(0.0, x), 33 * 33),
             "ex19_25": (ex19.make_residual(25, 25, 1.0 / 625, 1.0, 1.0), 25 * 25 * 4)}
    gen = torch.Generator().manual_seed(7)
    out = {"device": str(pt.config.device()), "reps": reps,
           "nvidia_smi": _card() if pt.config.device().type == "cuda" else None}
    for name, (f, n) in cases.items():
        x = torch.rand(n, generator=gen, dtype=torch.float64).to(pt.config.device())
        v = torch.rand(n, generator=gen, dtype=torch.float64).to(pt.config.device())
        t_func, a = _ms(lambda: torch.func.jvp(f, (x,), (v,))[1], reps)
        t_build, lin = _ms(lambda: Linearization(f, x), reps)
        t_call, b = _ms(lambda: lin(v), reps)
        out[name] = {"func_jvp_ms": t_func, "linearize_ms": t_build, "product_ms": t_call,
                     "max_abs_diff": float((a - b).abs().max())}

    def rosen(z):
        return torch.sum(100.0 * (z[1::2] - z[0::2] ** 2) ** 2 + (1.0 - z[0::2]) ** 2)

    x = torch.rand(1024, generator=gen, dtype=torch.float64).to(pt.config.device())
    v = torch.rand(1024, generator=gen, dtype=torch.float64).to(pt.config.device())
    g = torch.func.grad(rosen)
    t_func, a = _ms(lambda: torch.func.jvp(g, (x,), (v,))[1], reps)
    t_build, hess = _ms(lambda: HessianAction(rosen, x), reps)
    t_call, b = _ms(lambda: hess(v), reps)
    out["rosenbrock_1024"] = {"func_jvp_of_grad_ms": t_func, "build_ms": t_build,
                              "product_ms": t_call, "max_abs_diff": float((a - b).abs().max())}
    print(json.dumps(out), flush=True)


def main(argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cpu"
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 50
    host_costs(device, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
