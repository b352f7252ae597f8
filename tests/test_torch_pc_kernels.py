"""The plain versions of X1 (the scatter by destination), D1 (the batched
subdomain apply) and N1 (the Neumann step) against the reference's
expressions (jnp .at[].add / .at[].set, einsum, dinv * (y - w)) at 1e-12;
X1's tables and modes; stencil_build.matis_poisson against the reference test's
build_matis_poisson; MatIS's product and ASM's domains against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.mat.utility import MatIS as MatIS_jax
from petsc_tpu.ops import operator as op_jax
from petsc_tpu_torch.ops import pc_kernels as pck
from petsc_tpu_torch.ops.stencil_build import matis_poisson
from tests.test_bddc import build_matis_poisson
from tests.test_mg_gamg import poisson2d

torch.set_num_threads(1)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("weighted", [False, True])
def test_x1_add_equals_the_references_scatter_add(weighted):
    rng = np.random.default_rng(3)
    n, nsrc, k = 50, 80, 400
    dst, sel = rng.integers(0, n, k), rng.integers(0, nsrc, k)
    w = rng.choice([-1.0, 1.0], k) if not weighted else rng.random(k)
    src = rng.random(nsrc) - 0.5
    tab = pck.scatter_table(dst, sel, n, nsrc, w)
    y = pck.dst_scatter(tab, torch.as_tensor(src))
    ref = jnp.zeros(n).at[jnp.asarray(dst)].add(jnp.asarray(w) * jnp.asarray(src)[sel])
    assert _rel(y.numpy(), ref) <= 1e-12
    # the plain version sums each destination's entries from 0 in their order
    want = np.zeros(n)
    for d, s_, ww in zip(dst, sel, w):
        want[d] = want[d] + ww * src[s_]
    assert np.array_equal(y.numpy(), want)


def test_x1_set_mode_keeps_the_rows_no_entry_reaches():
    rng = np.random.default_rng(4)
    idx = rng.permutation(30)[:12]
    vals = rng.random(12)
    tab = pck.scatter_table(idx, np.arange(12), 30, 12)
    out = torch.as_tensor(rng.random(30))
    keep = out.clone()
    y = pck.dst_scatter(tab, torch.as_tensor(vals), out=out)
    ref = jnp.asarray(keep.numpy()).at[jnp.asarray(idx)].set(jnp.asarray(vals))
    assert y is out and np.array_equal(y.numpy(), np.asarray(ref))


def test_x1_checks_its_table():
    with pytest.raises(IndexError):
        pck.scatter_table([0, 5], [0, 1], 5, 2)
    tab = pck.scatter_table([0, 1], [0, 1], 2, 2)
    with pytest.raises(ValueError):
        pck.dst_scatter(tab, torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("transposed, with_out", [(False, False), (True, False), (False, True)])
def test_d1_equals_the_references_einsum(transposed, with_out):
    rng = np.random.default_rng(5)
    ns, R, C, nx = 6, 9, 7, 40
    M = rng.random((ns, R, C)) - 0.5
    K = R if transposed else C
    G = rng.integers(0, nx, (ns, K))
    w = rng.random((ns, K))
    x = rng.random(nx)
    t = x[G] * w
    ref = np.asarray(jnp.einsum("sij,si->sj" if transposed else "sij,sj->si",
                                jnp.asarray(M), jnp.asarray(t)))
    tab = pck.subdomain_table(G, w)
    if not with_out:
        y = pck.subdomain_apply(torch.as_tensor(M), tab, torch.as_tensor(x), transposed)
        assert _rel(y.numpy(), ref) <= 1e-12
        return
    out = np.stack([rng.permutation(R + 3)[:R] for _ in range(ns)])
    out[:, -1] = -1
    base = rng.random((ns, R + 3))
    tab = pck.subdomain_table(G, w, out=out)
    y = pck.subdomain_apply(torch.as_tensor(M), tab, torch.as_tensor(x),
                            y=torch.as_tensor(base.copy()), accumulate=True)
    want = jnp.asarray(base).at[jnp.arange(ns)[:, None], jnp.asarray(out[:, :-1])].add(
        jnp.asarray(ref[:, :-1]))
    assert _rel(y.numpy(), want) <= 1e-12


def test_n1_equals_the_references_step():
    rng = np.random.default_rng(6)
    d, y, w = (rng.random(100) for _ in range(3))
    z = pck.neumann_step(*(torch.as_tensor(v) for v in (d, y, w)))
    assert np.array_equal(z.numpy(), np.asarray(jnp.asarray(d) * (jnp.asarray(y) - jnp.asarray(w))))


@pytest.mark.parametrize("ne, nsub", [(8, 2), (16, 4)])
def test_matis_poisson_equals_the_reference_tests_build_matis_poisson(ne, nsub):
    M, n = build_matis_poisson(ne, nsub)
    mats, maps = M.getLocalMats()
    m2, g2, n2 = matis_poisson(ne, nsub)
    assert n == n2 and len(mats) == len(m2)
    for a, b, ga, gb in zip(mats, m2, maps, g2):
        assert np.array_equal(ga, gb) and np.array_equal(a, b)


def test_matis_product_matches_the_reference():
    mats, maps, n = matis_poisson(16, 4)
    ptt.init(device="cpu")
    x = np.random.default_rng(8).random(n)
    y = ptt.MatIS.create(n, mats, maps).op().mult(torch.as_tensor(x)).numpy()
    Mj = MatIS_jax.create(n, mats, maps)
    yr = np.asarray(op_jax.bind(Mj.meta, Mj.device_data()).mult(jnp.asarray(x)))
    assert _rel(y, yr) <= 1e-12
    # its D1 + X1 tables give the same product
    d = ptt.MatIS.create(n, mats, maps).device_data()
    yl = pck.subdomain_apply(d["Ab"], d["d1"], torch.as_tensor(x))
    assert _rel(pck.dst_scatter(d["x1"], yl.view(-1)).numpy(), yr) <= 1e-12


@pytest.mark.parametrize("nblocks, overlap", [(2, 1), (4, 2), (3, 0)])
def test_asm_domains_equal_the_references(nblocks, overlap):
    A_sp = poisson2d(12)
    ptt.init(device="cpu")
    pt_jax.init()
    pcs = []
    for pkg in (ptt, pt_jax):
        pc = pkg.PC().create()
        pc.setOperators(pkg.MatAIJ.from_scipy(A_sp))
        pc.setType("asm")
        pc._impl.nblocks, pc._impl.overlap = nblocks, overlap
        pcs.append(pc)
    S = sp.csr_matrix(A_sp)
    port = pcs[0]._impl._default_domains(S, S.shape[0])
    ref = pcs[1]._impl._default_domains(S, S.shape[0])
    assert len(port) == len(ref)
    for (o1, d1), (o2, d2) in zip(port, ref):
        assert np.array_equal(o1, o2) and np.array_equal(np.sort(d1), np.sort(d2))
