"""petsc_tpu_torch's PetscDraw, PetscBag, -info, PF, PetscRandom and the
profiler trace against petsc_tpu, on the CPU, after tests/test_bag_draw.py,
tests/test_compat.py's test_random and tests/test_api_extras.py's
test_pf_types.

Tolerances: text and files equal; Random's values equal in bits (f64 and
f32); PF equal but where XLA fuses a product and a sum into one FMA, there
within one rounding (2.3e-16 relative)."""

import io
import json

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
import importlib

from petsc_tpu.sys import bag as rbag, draw as rdraw
from petsc_tpu.sys.pf import PF as RPF
from petsc_tpu.sys.random import Random as RRandom
from petsc_tpu_torch.sys import bag, draw
from petsc_tpu_torch.sys.logging import jax_trace, torch_trace
from petsc_tpu_torch.sys.pf import PF
from petsc_tpu_torch.sys.random import Random

torch.set_num_threads(1)

# the modules (each package's sys namespace exports a function `info`)
info = importlib.import_module("petsc_tpu_torch.sys.info")
rinfo = importlib.import_module("petsc_tpu.sys.info")


def _init(args=()):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


def test_bag_options_view_and_cross_load(tmp_path):
    _init(["-params_rho", "2.5", "-params_scheme", "upwind", "-params_w", "1,2,3"])
    views = []
    for mod, tag in ((rbag, "r"), (bag, "p")):
        b = mod.Bag("params", "problem parameters")
        b.setOptionsPrefix("params_")
        b.registerReal("rho", 1.0, "density")
        b.registerInt("steps", 10, "time steps")
        b.registerBool("verbose", False, "chatter")
        b.registerString("name", "run", "label")
        b.registerEnum("scheme", ("centered", "upwind"), 0, "advection")
        b.registerRealArray("w", [0.0], "weights")
        b.setFromOptions()
        assert b.rho == 2.5 and b.steps == 10 and b.scheme == "upwind"
        b.steps = 20
        buf = io.StringIO()
        b.view(file=buf)
        views.append(buf.getvalue())
        b.save(str(tmp_path / f"{tag}.npz"))
    assert views[0] == views[1] and "rho = 2.5; density" in views[1]
    for mod, tag in ((bag, "r"), (rbag, "p")):
        b2 = mod.Bag("params")
        b2.registerReal("rho", 0.0)
        b2.registerInt("steps", 0)
        b2.registerEnum("scheme", ("centered", "upwind"), 0)
        b2.load(str(tmp_path / f"{tag}.npz"))
        assert b2.rho == 2.5 and b2.steps == 20 and b2.scheme == "upwind"
    ptt.init(args=["-params_scheme", "sideways"], device="cpu")
    b3 = bag.Bag("params").setOptionsPrefix("params_")
    b3.registerEnum("scheme", ("centered", "upwind"), 0)
    with pytest.raises(ptt.Error):
        b3.setFromOptions()


def test_draw_text_and_ppm_are_the_references(tmp_path):
    lg, rlg = draw.DrawLG(dim=2), rdraw.DrawLG(dim=2)
    for i in range(30):
        for g in (lg, rlg):
            g.addPoint(i, [10.0 ** (-0.3 * i), 10.0 ** (-0.2 * i)])
    bufs = [io.StringIO(), io.StringIO()]
    lg.draw(file=bufs[0])
    rlg.draw(file=bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue() and "log10" in bufs[0].getvalue()
    x = np.linspace(0, 1, 24)
    f = np.sin(3 * x)[None, :] * np.cos(2 * x)[:, None]
    bufs = [io.StringIO(), io.StringIO()]
    draw.tensor_contour(torch.as_tensor(f), file=bufs[0])
    rdraw.tensor_contour(f, file=bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue() and "@" in bufs[0].getvalue()
    draw.ppm_save(str(tmp_path / "p.ppm"), torch.as_tensor(f))
    rdraw.ppm_save(str(tmp_path / "r.ppm"), f)
    assert (tmp_path / "p.ppm").read_bytes() == (tmp_path / "r.ppm").read_bytes()


@pytest.mark.parametrize("flag", [None, "", "KSP,PC", "vec"])
def test_info_class_filter_is_the_references(flag, capsys):
    args = [] if flag is None else (["-info"] if flag == "" else ["-info", flag])
    _init(args)
    for cls in ("KSP", "PC", "Vec", "Mat", None):
        assert info.info_enabled(cls) == rinfo.info_enabled(cls), cls

    class KSP:
        _class_name = "KSP"
    info.info(KSP(), "hello")
    rinfo.info(KSP(), "hello")
    out = capsys.readouterr().out.splitlines()
    assert len(out) in (0, 2) and (not out or out[0] == out[1] == "[0] KSP hello")


def test_warn_full_gather_is_silent_on_one_device():
    _init(["-info"])
    A = ptt.MatAIJ.from_scipy(__import__("scipy.sparse").sparse.eye(4, format="csr"))
    info.warn_full_gather(A, "PCASM(nblocks != nshards)")      # one device: nothing to say


def test_pf_types_against_the_reference():
    _init()
    x = np.random.default_rng(28).standard_normal(4097)
    v, rv = ptt.Vec.from_array(x), pt_jax.Vec.from_array(x)
    for t, ctx in (("identity", None), ("constant", 7.0), ("string", "x*x + 1"),
                   ("string", "np.abs(x) * 2 + jnp.exp(0 * x)")):
        a = PF.create().setType(t, ctx).apply(v)
        b = np.asarray(RPF.create().setType(t, ctx).apply(rv))
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        assert np.all(np.abs(a - b) <= 2.3e-16 * np.abs(b)), (t, ctx)
    y = ptt.Vec.from_array(np.zeros(4097))
    out = PF.create().setType("string", "x*x + 1").apply(v, y)
    assert out is y and torch.equal(y.array, v.array * v.array + 1)
    t = PF.create().setApply(lambda z: torch.sin(z)).apply(torch.as_tensor(x))
    assert isinstance(t, torch.Tensor) and np.allclose(t.numpy(), np.sin(x))
    with pytest.raises(KeyError):
        PF.create().setType("lua")


@pytest.fixture
def real_dtype_reset():
    """The reference keeps an earlier init's -real_dtype: float64 again after."""
    yield
    pt_jax.set_real_dtype("f64")
    ptt.set_real_dtype("f64")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_random_equals_jax_in_bits(dtype, real_dtype_reset):
    _init(["-real_dtype", dtype])
    a, b = RRandom.create(), Random.create()
    for step in range(3):
        if step == 1:
            a.setInterval((2.0, 4.0))
            b.setInterval((2.0, 4.0))
        if step == 2:
            a.setSeed(42).seed()
            b.setSeed(42).seed()
        for n in (1, 5, 1000):
            x, y = np.asarray(a.getValues(n)), b.getValues(n).numpy()
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a.getValue() == b.getValue()
    assert b.getInterval() == (2.0, 4.0)
    vals = b.getValues(1000).numpy()
    assert (vals >= 2.0).all() and (vals <= 4.0).all()


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with torch_trace(str(tmp_path / "tr")) as d:
        (torch.ones(64) * 2).sum()
    ev = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "tr") and any("mul" in e.get("name", "") for e in ev)
    assert jax_trace is torch_trace
