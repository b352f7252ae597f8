"""D1's and X1's plain versions at the shapes where the Hopper designs
change (the narrow and wide forms, padded tables, output maps, long
runs) against the reference's expressions (jnp einsum, .at[].add,
.at[].set), with the same numpy inputs from a seed; and the split of
X1's table into short destinations and the long list.

D1's tables are made with NaN padding, as the card tests give them to
the kernel, which must not read it; the plain version, like the
reference's einsum, sums the padding, so both run on the zero-padded copy
(chip_smoke.zero_padding, the card tests' reference input). Tolerance
1e-12 relative in float64 (the sums run in another order than XLA's); X1
also equals an in-order loop over its entries bit for bit."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from petsc_tpu_torch.ops import pc_kernels as pck

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _d1_reference(M, G, w, x, nr, nc, transposed):
    """The reference's einsum on the zero-padded table."""
    ns, R, C = M.shape
    keep = (np.arange(R)[None, :, None] < nr[:, None, None]) & \
        (np.arange(C)[None, None, :] < nc[:, None, None])
    Mz = np.where(keep, M, 0.0)
    t = x[G] * (1.0 if w is None else w)
    return np.asarray(jnp.einsum("sij,si->sj" if transposed else "sij,sj->si",
                                 jnp.asarray(Mz), jnp.asarray(t)))


def _nan_padded(rng, ns, R, C):
    nr = rng.integers(R // 2, R + 1, ns)
    nc = rng.integers(C // 2, C + 1, ns)
    nr[0], nc[0] = R, C
    nr[-1] = 0
    M = rng.random((ns, R, C)) - 0.5
    M[(np.arange(R)[None, :, None] >= nr[:, None, None])
      | (np.arange(C)[None, None, :] >= nc[:, None, None])] = np.nan
    return M, nr, nc


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("C", [1, 4, 33])
def test_d1_plain_version_on_padded_tables(C, transposed):
    rng = np.random.default_rng(100 + C)
    ns, R, nx = 6, 37, 50
    M, nr, nc = _nan_padded(rng, ns, R, C)
    K = R if transposed else C
    G = rng.integers(0, nx, (ns, K))
    w = rng.random((ns, K)) + 0.5
    x = rng.random(nx) - 0.5
    tab = pck.subdomain_table(G, w, nr=nr, nc=nc)
    Mz = chip_smoke.zero_padding(torch.as_tensor(M), tab)
    assert torch.isfinite(Mz).all()
    y = pck.subdomain_apply(Mz, tab, torch.as_tensor(x), transposed).numpy()
    ref = _d1_reference(M, G, w, x, nr, nc, transposed)
    assert np.isfinite(y).all() and y.shape == ref.shape
    assert _rel(y, ref) <= 1e-12


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("C", [4, 33])
def test_d1_output_map_with_skips_accumulates(C, transposed):
    rng = np.random.default_rng(200 + C)
    ns, R, nx = 5, 29, 40
    M, nr, nc = _nan_padded(rng, ns, R, C)
    K, R_out = (R, C) if transposed else (C, R)
    G = rng.integers(0, nx, (ns, K))
    x = rng.random(nx) - 0.5
    ld = R_out + 4
    out = np.stack([rng.permutation(ld)[:R_out] for _ in range(ns)])
    out[:, ::3] = -1
    base = rng.random((ns, ld))
    tab = pck.subdomain_table(G, None, out=out, nr=nr, nc=nc)
    Mz = chip_smoke.zero_padding(torch.as_tensor(M), tab)
    y = pck.subdomain_apply(Mz, tab, torch.as_tensor(x), transposed,
                            y=torch.as_tensor(base.copy()), accumulate=True).numpy()
    ref = _d1_reference(M, G, None, x, nr, nc, transposed)
    keep = out >= 0
    s_idx = np.broadcast_to(np.arange(ns)[:, None], out.shape)[keep]
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(s_idx), jnp.asarray(out[keep])].add(
        jnp.asarray(ref[keep])))
    assert _rel(y, want) <= 1e-12


@pytest.mark.parametrize("name", list(chip_smoke.D1_EDGES))
def test_d1_card_edge_cases_agree_with_the_reference_on_the_cpu(name):
    """The card tests' D1 cases (chip_smoke.D1_EDGES), here through the
    plain version, against the reference's einsum (and .at[].add)."""
    M, tab, x, transposed, y0 = chip_smoke.d1_edge_operands(name, torch.float64, "cpu")
    Mh, G = M.numpy(), tab.G.numpy()
    M = chip_smoke.zero_padding(M, tab)
    w = None if tab.w is None else tab.w.numpy()
    nr, nc = tab.nr.numpy(), tab.nc.numpy()
    ref = _d1_reference(Mh, G, w, x.numpy(), nr, nc, transposed)
    if y0 is None:
        y = pck.subdomain_apply(M, tab, x, transposed).numpy()
        assert _rel(y, ref) <= 1e-12
        return
    y = pck.subdomain_apply(M, tab, x, transposed, y=y0.clone(), accumulate=True).numpy()
    out = tab.out.numpy()
    keep = out >= 0
    s_idx = np.broadcast_to(np.arange(out.shape[0])[:, None], out.shape)[keep]
    want = np.asarray(jnp.asarray(y0.numpy()).at[jnp.asarray(s_idx),
                                                 jnp.asarray(out[keep])].add(
        jnp.asarray(ref[keep])))
    assert _rel(y, want) <= 1e-12


def _in_order(dst, sel, w, src, n):
    want = np.zeros(n)
    for d, s_, ww in zip(dst, sel, w):
        want[d] = want[d] + ww * src[s_]
    return want


@pytest.mark.parametrize("name", list(chip_smoke.X1_EDGES))
def test_x1_card_edge_cases_agree_with_the_reference_on_the_cpu(name):
    """The card tests' X1 cases (chip_smoke.X1_EDGES) through the plain
    version: equal bits with an in-order loop over the entries, and the
    reference's .at[].add / .at[].set to 1e-12 (.at[].min, the min cases,
    bit for bit)."""
    tab, src, out = chip_smoke.x1_edge_operands(name, torch.float64, "cpu")
    n = tab.n
    ptr, sel = tab.ptr.numpy(), tab.sel.numpy()
    dst = np.repeat(np.arange(n), np.diff(ptr))
    w = np.ones(len(sel)) if tab.w is None else tab.w.numpy()
    s = src.numpy()
    if chip_smoke.X1_EDGES[name] == "min":
        y = pck.dst_scatter(tab, src, out.clone(), mode="min").numpy()
        want = out.numpy().copy()
        for d, s_, ww in zip(dst, sel, w):
            want[d] = min(want[d], ww * s[s_])
        assert np.array_equal(y, want)
        ref = jnp.asarray(out.numpy()).at[jnp.asarray(dst)].min(jnp.asarray(w * s[sel]))
        assert np.array_equal(y, np.asarray(ref))
        return
    y = pck.dst_scatter(tab, src, None if out is None else out.clone()).numpy()
    if out is None:
        assert np.array_equal(y, _in_order(dst, sel, w, s, n))
        ref = jnp.zeros(n).at[jnp.asarray(dst)].add(jnp.asarray(w * s[sel]))
    else:
        reached = np.diff(ptr) > 0
        want = out.numpy().copy()
        want[reached] = _in_order(dst, sel, w, s, n)[reached]
        assert np.array_equal(y, want)
        # each reached row has one entry in the set cases but the long one
        one = np.diff(ptr)[dst] == 1
        ref = jnp.asarray(want).at[jnp.asarray(dst[one])].set(jnp.asarray((w * s[sel])[one]))
    assert _rel(y, np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_x1_table_splits_every_destination_once_in_entry_order(seed):
    rng = np.random.default_rng(300 + seed)
    n, nsrc = 400, 900
    L = pck.LONG_RUN
    lens = rng.choice([0, 1, 2, 4, L - 1, L, L + 1, 3 * L, 5000 if seed == 0 else 70], n,
                      p=[.2, .3, .2, .1, .05, .05, .05, .04, .01])
    dst = rng.permutation(np.repeat(np.arange(n), lens))
    sel = rng.integers(0, nsrc, len(dst))
    tab = pck.scatter_table(dst, sel, n, nsrc, rng.random(len(dst)))
    ptr = tab.ptr.numpy()
    cnt = np.bincount(dst, minlength=n)
    assert np.array_equal(np.diff(ptr), cnt)
    longs = np.zeros((0, 3), dtype=np.int64) if tab.longs is None else tab.longs.numpy()
    assert tab.nlong == len(longs)
    # the long list: the destinations of more than LONG_RUN entries, in
    # order, each with its own run of entries
    assert np.array_equal(longs[:, 0], np.flatnonzero(cnt > L))
    assert np.array_equal(longs[:, 1], ptr[longs[:, 0]])
    assert np.array_equal(longs[:, 2], ptr[longs[:, 0] + 1])
    # short and long cover every destination once
    short = np.flatnonzero(cnt <= L)
    assert len(np.union1d(short, longs[:, 0])) == n and not len(np.intersect1d(short, longs[:, 0]))
    # each run holds its destination's entries in their input order
    order = np.argsort(dst, kind="stable")
    assert np.array_equal(tab.sel.numpy(), sel[order])
    for d in longs[:, 0]:
        assert np.array_equal(tab.sel.numpy()[ptr[d]:ptr[d + 1]], sel[dst == d])


def test_x1_long_run_threshold_is_the_kernels():
    """The table's split (pc_kernels.LONG_RUN) and the kernel's short part
    (kLongRun in csrc/dst_scatter.cu) draw the line at the same run length:
    a run between the two would be written by neither part."""
    src = (Path(pck.__file__).parent.parent / "csrc" / "dst_scatter.cu").read_text()
    found = re.findall(r"constexpr int kLongRun = (\d+);", src)
    assert found == [str(pck.LONG_RUN)]


@pytest.mark.parametrize("weighted", [False, True])
def test_x1_run_of_5000_entries_equals_the_references_scatter_add(weighted):
    rng = np.random.default_rng(400 + weighted)
    n, nsrc = 60, 3000
    dst = rng.permutation(np.r_[np.full(5000, 7), rng.integers(0, n, 500)])
    sel = rng.integers(0, nsrc, len(dst))
    w = rng.random(len(dst)) - 0.5 if weighted else np.ones(len(dst))
    src = rng.random(nsrc) - 0.5
    tab = pck.scatter_table(dst, sel, n, nsrc, w if weighted else None)
    assert tab.nlong == 1 and tab.longs.numpy()[0, 0] == 7
    y = pck.dst_scatter(tab, torch.as_tensor(src)).numpy()
    assert np.array_equal(y, _in_order(dst, sel, w, src, n))
    ref = jnp.zeros(n).at[jnp.asarray(dst)].add(jnp.asarray(w * src[sel]))
    assert _rel(y, np.asarray(ref)) <= 1e-12
