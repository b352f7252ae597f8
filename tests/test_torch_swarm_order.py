"""The swarm's cell order (particle_kernels.cell_order, DMSwarm.cellOrder)
and W1's deposit by cell order, on the CPU.

- cell_order equals numpy's stable argsort of the reference's binToCells,
  and migrate's permutation, with particles below 0, on cell edges, at 1
  and above 1.
- A pure-Python model of W1's kernel (csrc/swarm_cic.cu
  cic_deposit_kernel: its tiles, the boxes of cells they stage, the
  staged slots and the node-by-node, corner-by-corner sums over each cell's
  particles in the order's sequence, or streamed corner by corner in
  rounds when a tile does not fit) on edge cases, permuted swarms and
  Gaussian clusters equals cic_deposit_plain and the JAX package's depositSum
  and projectFields bit for bit, in f64 and f32 (numpy scalars round every
  step as the kernel's __dmul_rn / __fmul_rn do).
- The order kept on a DMSwarm is rebuilt after every change of the
  coordinates or of the cell DM, migrate reuses it, and a mismatched order
  is refused.

Every comparison is in bits: no tolerance."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import particle_kernels as pk

torch.set_num_threads(1)

COOR = "DMSwarmPIC_coor"


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


# ---- the kernel's model ----

# the kernel's tiles of nodes a block, per (dim, shape)
TILE = {(dim, shape): pk.W1_TILES[dim][shape] for dim in (1, 2, 3) for shape in (0, 1)}


def _fraction(x, h, ncell, T):
    """The kernel's fraction(): x / h rounded in T, floor, clamp, x / h - i."""
    g = T(x) / T(h)
    i = min(max(math.floor(g), 0), ncell - 1)
    return g - T(i)


def _weight(c, t, dim, T):
    w = T(1)
    for ax in range(dim):
        bit = (c >> (dim - 1 - ax)) & 1
        w = w * (t[ax] if bit else T(1) - t[ax])
    return w


def model_deposit(order, grid, fields, wsum, cap=None, shape=None, totals=None):
    """W1's kernels in Python: a block per tile of nodes (the shape the
    kernel takes: 128 nodes for a swarm in cell order, else 256). A tile
    whose box of cells needs at most `cap` slots (all, by default) is
    staged (runs and their prefix sums, each staged particle's run found by
    binary search, its slot i + i // 16) and each node summed corner by
    corner from the slots; any other tile is a dense one, streamed in items
    of 8 nodes: corner by corner, in rounds of m = max(cap, 9) // 9
    particles of each node's cell, each round's weights formed before the
    node multiplies and adds them in order. Every sum starts from +0."""
    dim, sizes, ncell = grid.dim, grid.sizes, [int(c) for c in grid.ncell]
    Xs = order.Xs.numpy()
    T = Xs.dtype.type
    perm = None if order.perm is None else order.perm.numpy()
    off = order.offsets.numpy()
    fs = [f.numpy() for f in fields]
    nf = len(fs)
    shape = (1 if order.perm is None else 0) if shape is None else shape
    if cap is None:
        cap = 1 << 30                      # every tile staged
    E = TILE[dim, shape]
    m = max(cap, 9) // 9
    nt = [(sizes[ax] + E[ax] - 1) // E[ax] for ax in range(dim)]
    cstride = [int(np.prod(ncell[ax + 1:])) for ax in range(dim)]
    acc = np.zeros((nf + int(wsum), grid.nnodes), dtype=T)

    def particle(q, c):
        """particle q's (weight, products) for corner c"""
        p = q if perm is None else int(perm[q])
        t = [_fraction(Xs[q, ax], grid.h[ax], ncell[ax], T) for ax in range(dim)]
        w = _weight(c, t, dim, T)
        return w, [w * f[p] for f in fs]

    for tile in np.ndindex(*nt):
        lo, B = [], []
        for ax in range(dim):
            start = tile[ax] * E[ax]
            lo.append(max(start - 1, 0))
            B.append(min(start + E[ax] - 1, ncell[ax] - 1) - lo[-1] + 1)
        nruns, blast = int(np.prod(B[:-1])), B[-1]
        nbox = nruns * blast

        def run_cid(r):
            cid = lo[-1]
            for ax in range(dim - 2, -1, -1):
                cid += (lo[ax] + r % B[ax]) * cstride[ax]
                r //= B[ax]
            return cid
        runq0 = [int(off[run_cid(r)]) for r in range(nruns)]
        runbase = [0]
        for r in range(nruns):
            runbase.append(runbase[-1] + int(off[run_cid(r) + blast]) - runq0[r])
        total = runbase[nruns]
        if totals is not None:
            totals.append(total)
        nodes = [[tile[ax] * E[ax] + loc[ax] for ax in range(dim)] for loc in np.ndindex(*E)]
        sums = [([T(0)] * nf, T(0)) for _ in nodes]

        def add(k, w, prods):
            a_k, aw = sums[k]
            sums[k] = ([a_k[kf] + prods[kf] for kf in range(nf)], aw + w)

        def cell_of(j, c):
            cj = [j[ax] - ((c >> (dim - 1 - ax)) & 1) for ax in range(dim)]
            if any(cj[ax] < 0 or cj[ax] > ncell[ax] - 1 for ax in range(dim)):
                return None
            return cj

        if total + (total >> 4) <= cap:
            # staged: the box's particles in the runs' sequence, then each
            # node's cells from their slots
            cstart = []
            for k in range(nbox):
                r = k // blast
                cstart.append(runbase[r] + int(off[run_cid(r) + k - r * blast]) - runq0[r])
            cstart.append(total)
            slot_q = {}
            for i in range(total):
                a, b = 0, nruns
                while b - a > 1:
                    mid = (a + b) >> 1
                    a, b = (mid, b) if runbase[mid] <= i else (a, mid)
                slot_q[i + (i >> 4)] = runq0[a] + i - runbase[a]
            for k, j in enumerate(nodes):
                if any(j[ax] >= sizes[ax] for ax in range(dim)):
                    continue
                for c in range(1 << dim):
                    cj = cell_of(j, c)
                    if cj is None:
                        continue
                    kb = 0
                    for ax in range(dim):
                        kb = kb * B[ax] + cj[ax] - lo[ax]
                    for i in range(cstart[kb], cstart[kb + 1]):
                        add(k, *particle(slot_q[i + (i >> 4)], c))
        else:
            # dense: items of 8 nodes, corner by corner, rounds of m
            # particles a node
            for item in range(0, len(nodes), 8):
                for c in range(1 << dim):
                    rng = []
                    for j in nodes[item:item + 8]:
                        cj = None if any(j[ax] >= sizes[ax] for ax in range(dim)) \
                            else cell_of(j, c)
                        cid = None if cj is None else sum(cj[ax] * cstride[ax]
                                                          for ax in range(dim))
                        rng.append((0, 0) if cid is None else (int(off[cid]), int(off[cid + 1])))
                    most = max(q1 - q0 for q0, q1 in rng)
                    for base in range(0, most, m):
                        rnd = [[particle(q, c) for q in range(q0 + base, min(q0 + base + m, q1))]
                               for q0, q1 in rng]
                        for k, parts in enumerate(rnd):
                            for w, prods in parts:
                                add(item + k, w, prods)
        for (a_k, aw), j in zip(sums, nodes):
            if any(j[ax] >= sizes[ax] for ax in range(dim)):
                continue
            nid = 0
            for ax in range(dim):
                nid = nid * sizes[ax] + j[ax]
            for kf in range(nf):
                acc[kf, nid] = a_k[kf]
            if wsum:
                acc[nf, nid] = aw
    return acc


# ---- inputs ----

def _edge(dim, dtype):
    return next((X, grid, fields) for label, X, grid, fields, _ in
                chip_smoke.cic_edge_cases("cpu", dtype) if label == f"{dim}d")


def _permuted_swarm(dim, n, ppc, seed):
    """insertPointsUsingCellDM's particles, permuted, with two seeded fields,
    as (X, grid, [w, q], perm, w, q)."""
    ptt.init(args=[], device="cpu")
    da = ptt.DMDA.create(dim, (n,) * dim)
    sw = ptt.DMSwarm.create()
    sw.setCellDM(da)
    sw.insertPointsUsingCellDM(ppcell=ppc)
    m = sw.getLocalSize()
    rng = np.random.default_rng(seed)
    perm, w, q = rng.permutation(m), rng.random(m), rng.standard_normal(m)
    X = sw.getFieldTensor(COOR)[torch.as_tensor(perm)].contiguous()
    return X, sw._grid(), [torch.as_tensor(w), torch.as_tensor(q)], perm, w, q


def _ref_swarm(X, sizes, fields=()):
    pt_jax.init(args=[])
    da = pt_jax.DMDA.create(dim=len(sizes), sizes=tuple(sizes))
    sw = pt_jax.DMSwarm.create()
    sw.setCellDM(da)
    sw.setPointCoordinates(np.asarray(X, dtype=np.float64))
    for k, f in enumerate(fields):
        sw.registerField(f"f{k}", 1)
        sw.restoreField(f"f{k}", np.asarray(f, dtype=np.float64).reshape(-1, 1))
    return sw


# ---- cell_order ----

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cell_order_is_the_stable_argsort_of_the_references_cells(dim):
    X, grid, _ = _edge(dim, torch.float64)
    Xn = X.numpy()
    assert (Xn < 0).any() and (Xn > 1).any() and (Xn == 1).any()
    ref_cells = np.asarray(_ref_swarm(Xn, grid.sizes).binToCells())
    o = pk.cell_order(X, grid)
    want = np.argsort(ref_cells, kind="stable")
    assert np.array_equal(pk.cell_ids(X, grid).numpy(), ref_cells)
    assert np.array_equal(o.perm.numpy(), want) and o.perm.dtype == torch.int32
    counts = np.bincount(ref_cells, minlength=int(np.prod(grid.ncell)))
    assert np.array_equal(o.offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert _same_bits(o.Xs.numpy(), Xn[want])
    # migrate's permutation is the same order, and leaves the identity
    ptt.init(args=[], device="cpu")
    sw = ptt.DMSwarm.create()
    sw.setCellDM(ptt.DMDA.create(dim, grid.sizes))
    sw.setPointCoordinates(X)
    sw.registerField("i", 1)
    sw.restoreField("i", np.arange(X.shape[0], dtype=np.float64))
    sw.migrate()
    assert np.array_equal(sw.getField("i")[:, 0], want.astype(np.float64))
    assert sw.cellOrder().perm is None
    assert np.array_equal(sw.cellOrder().offsets.numpy(), o.offsets.numpy())


# ---- the kernel's model ----

def _cases():
    out = []
    for dtype in (torch.float64, torch.float32):
        for dim in (1, 2, 3):
            out.append((f"edge{dim}d", dtype))
        out += [("swarm2d", dtype), ("swarm3d", dtype), ("cluster2d", dtype),
                ("cluster3d", dtype)]
    return out


def _inputs(label, dtype):
    if label.startswith("edge"):
        X, grid, fields = _edge(int(label[4]), dtype)
        return X, grid, fields[:4]
    if label.startswith("cluster"):
        # chip_smoke's Gaussian cluster on a coarse grid: a few cells hold
        # hundreds of particles each, the rest few or none
        dim = int(label[7])
        grid = pk.Grid((17, 17) if dim == 2 else (9, 9, 9))
        X = chip_smoke.clustered_coordinates(2000, dim, "cpu").to(dtype)
        rng = np.random.default_rng(9)
        return X, grid, [torch.as_tensor(rng.random(2000), dtype=dtype),
                         torch.as_tensor(rng.standard_normal(2000), dtype=dtype)]
    dim = 2 if label == "swarm2d" else 3
    X, grid, fields, *_ = _permuted_swarm(dim, 17 if dim == 2 else 6, 3 if dim == 2 else 2, 7)
    return X.to(dtype), grid, [f.to(dtype) for f in fields]


@pytest.mark.parametrize("label,dtype", _cases())
def test_kernel_model_equals_the_plain_version_in_bits(label, dtype):
    """The model, given the cell order, equals cic_deposit_plain bit for
    bit in both tile shapes, with every tile staged, with none (every tile
    dense, one particle a node a round, and two), and with a capacity that
    the denser tiles overflow."""
    X, grid, fields = _inputs(label, dtype)
    order = pk.cell_order(X, grid)
    plain = pk.cic_deposit_plain(X, grid, fields, wsum=True).numpy()
    for shape in (0, 1):
        totals = []
        got = model_deposit(order, grid, fields, True, None, shape, totals)
        assert _same_bits(got, plain), (label, shape)
        mid = sorted(totals)[len(totals) // 2]
        # none staged (rounds of 1, then 2); the denser half not
        for cap in (0, 18, mid + (mid >> 4)):
            got = model_deposit(order, grid, fields, True, cap, shape)
            assert _same_bits(got, plain), (label, cap, shape)
    one = model_deposit(order, grid, fields[:1], False)
    assert _same_bits(one, pk.cic_deposit_plain(X, grid, fields[:1]).numpy())


@pytest.mark.parametrize("label", ["edge1d", "edge2d", "edge3d", "swarm2d", "swarm3d",
                                   "cluster2d", "cluster3d"])
def test_kernel_model_equals_the_references_deposit_and_projection(label):
    """The model's sums equal the JAX package's depositSum bit for bit, and
    divided by the weight sum (1 where it is 0) its projectFields."""
    X, grid, fields = _inputs(label, torch.float64)
    fields = fields[:2]
    sw = _ref_swarm(X.numpy(), grid.sizes, fields)
    got = model_deposit(pk.cell_order(X, grid), grid, fields, True)
    assert _same_bits(got[0], np.asarray(sw.depositSum("f0").getArray()))
    wsafe = np.where(got[-1] == 0, 1.0, got[-1])
    for k, v in enumerate(sw.projectFields(["f0", "f1"])):
        assert _same_bits(got[k] / wsafe, np.asarray(v.getArray()))


@pytest.mark.parametrize("dim", [2, 3])
def test_the_ports_swarm_equals_the_reference_in_bits(dim):
    """A permuted swarm through the port's depositSum and projectFields
    (the plain versions, given the kept order) and the reference's: equal
    bits."""
    X, grid, fields, perm, w, q = _permuted_swarm(dim, 9 if dim == 2 else 5, 2, 3)
    sw = ptt.DMSwarm.create()
    sw.setCellDM(ptt.DMDA.create(dim, grid.sizes))
    sw.setPointCoordinates(X)
    for name, f in (("f0", w), ("f1", q)):
        sw.registerField(name, 1)
        sw.restoreField(name, f)
    ref = _ref_swarm(X.numpy(), grid.sizes, [w, q])
    assert _same_bits(sw.depositSum("f0").array.numpy(),
                      np.asarray(ref.depositSum("f0").getArray()))
    for a, b in zip(sw.projectFields(["f0", "f1"]), ref.projectFields(["f0", "f1"])):
        assert _same_bits(a.array.numpy(), np.asarray(b.getArray()))


# ---- the order kept on a DMSwarm ----

@pytest.fixture
def modelled(monkeypatch):
    """cic_deposit through the kernel's model, with the order it is given,
    so that a stale order shows in the sums."""
    calls = []
    real = pk.cic_deposit

    def deposit(X, grid, fields, wsum=False, order=None):
        real(X, grid, fields, wsum, order)       # the wrapper's checks
        calls.append(order)
        return torch.as_tensor(model_deposit(order, grid, list(fields), wsum))
    monkeypatch.setattr(pk, "cic_deposit", deposit)
    return calls


def _swarm(n=7, ppc=2):
    ptt.init(args=[], device="cpu")
    da = ptt.DMDA.create(2, (n, n))
    sw = ptt.DMSwarm.create()
    sw.setCellDM(da)
    sw.insertPointsUsingCellDM(ppcell=ppc)
    m = sw.getLocalSize()
    rng = np.random.default_rng(2)
    sw.setPointCoordinates(sw.getFieldTensor(COOR)[torch.as_tensor(rng.permutation(m))])
    sw.registerField("w", 1)
    sw.restoreField("w", rng.random(m))
    return sw


def _fresh(sw):
    """A fresh plain deposit of w on the swarm's coordinates now."""
    grid = sw._grid()
    return pk.cic_deposit_plain(sw.getFieldTensor(COOR), grid, [sw.getFieldTensor("w")[:, 0]])[0]


def _moved(sw):
    return sw.getFieldTensor(COOR) * 0.9 + 0.05


CHANGES = {
    "setPointCoordinates": lambda sw: sw.setPointCoordinates(_moved(sw)),
    "setPointCoordinates_same_tensor": lambda sw: (
        sw.getFieldTensor(COOR).data.mul_(0.9).add_(0.05),       # no version bump
        sw.setPointCoordinates(sw.getFieldTensor(COOR))),
    "restoreField_coordinates": lambda sw: sw.restoreField(COOR, _moved(sw).numpy()),
    "restoreField_borrowed": lambda sw: (sw.getField(COOR).__imul__(0.9), sw.restoreField(COOR)),
    "in_place_getFieldTensor": lambda sw: sw.getFieldTensor(COOR).mul_(0.9),
    "addNPoints": lambda sw: (sw.addNPoints(np.array([[0.31, 0.77], [0.5, 0.5]])),
                              sw.getFieldTensor("w").fill_(0.5)),
    "removePoints": lambda sw: sw.removePoints(np.arange(sw.getLocalSize()) % 3 == 0),
    "setCellDM": lambda sw: sw.setCellDM(ptt.DMDA.create(2, (5, 9))),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_every_change_of_the_coordinates_or_cell_dm_rebuilds_the_order(modelled, change):
    sw = _swarm()
    assert _same_bits(sw.depositSum("w").array.numpy(), _fresh(sw).numpy())
    first = sw.cellOrder()
    assert sw.cellOrder() is first                     # kept while nothing changes
    CHANGES[change](sw)
    assert sw.cellOrder() is not first
    got = sw.depositSum("w").array.numpy()
    assert _same_bits(got, _fresh(sw).numpy()) and modelled[-1] is sw.cellOrder()


def test_a_stale_order_would_show(modelled):
    """The check above can fail: the model on the first order after the
    coordinates moved gives other sums."""
    sw = _swarm()
    sw.depositSum("w")
    stale = sw.cellOrder()
    sw.getFieldTensor(COOR).data.mul_(0.9)
    grid = sw._grid()
    got = model_deposit(stale, grid, [sw.getFieldTensor("w")[:, 0]], False)[0]
    assert not _same_bits(got, _fresh(sw).numpy())


def test_migrate_reuses_the_order_and_gives_the_references_order(monkeypatch):
    sw = _swarm(n=9, ppc=3)
    X = sw.getFieldTensor(COOR).numpy().copy()
    w = sw.getFieldTensor("w").numpy().copy()
    sw.depositSum("w")
    kept = sw.cellOrder()

    def refuse(*a, **k):
        raise AssertionError("migrate sorted again")
    monkeypatch.setattr(pk, "cell_order", refuse)
    sw.migrate()
    ref = _ref_swarm(X, (9, 9), [w[:, 0]])
    ref.migrate()
    assert np.array_equal(sw.getFieldTensor("w").numpy()[:, 0],
                          np.asarray(ref.getField("f0"))[:, 0])
    assert np.array_equal(sw.binToCells().numpy(), np.asarray(ref.binToCells()))
    o = sw.cellOrder()
    assert o.perm is None and o.offsets is kept.offsets and o.Xs is sw.getFieldTensor(COOR)
    sw.migrate()                                       # already in order: nothing moves
    assert np.array_equal(sw.binToCells().numpy(), np.asarray(ref.binToCells()))


def _mismatched():
    X, grid, fields = _edge(2, torch.float64)
    o = pk.cell_order(X, grid)
    Y = X.clone()
    oy = pk.cell_order(Y, grid)
    Y.mul_(1.0)                                   # the version counter moves
    return {
        "other_coordinates": (X.clone(), grid, o),
        "other_grid": (X, pk.Grid((9, 17)), o),
        "edited_in_place": (Y, grid, oy),
        "short_perm": (X, grid, o._replace(perm=o.perm[:-1])),
        "int64_offsets": (X, grid, o._replace(offsets=o.offsets.long())),
        "f32_coordinates": (X, grid, o._replace(Xs=o.Xs.float())),
        "not_an_order": (X, grid, (o.perm, o.offsets, o.Xs)),
    }, fields


@pytest.mark.parametrize("case", ["other_coordinates", "other_grid", "edited_in_place",
                                  "short_perm", "int64_offsets", "f32_coordinates",
                                  "not_an_order"])
def test_a_mismatched_order_is_refused(case):
    cases, fields = _mismatched()
    X, grid, order = cases[case]
    with pytest.raises(ValueError, match="cell order"):
        pk.cic_deposit(X, grid, fields[:1], order=order)


def test_take_rows_of_a_view_at_an_odd_offset():
    """take_rows gives X[idx] for two-column coordinates that are a
    contiguous view at an odd storage offset (which cannot be viewed as
    complex numbers), and cell_order on such a view equals a copy's."""
    X, grid, _ = _edge(2, torch.float64)
    buf = torch.empty(X.numel() + 1, dtype=X.dtype)
    view = buf[1:].view(X.shape)
    view.copy_(X)
    assert view.is_contiguous() and view.storage_offset() == 1
    idx = torch.as_tensor(np.random.default_rng(4).permutation(X.shape[0]))
    assert _same_bits(pk.take_rows(view, idx).numpy(), X.numpy()[idx.numpy()])
    got, want = pk.cell_order(view, grid), pk.cell_order(X, grid)
    assert torch.equal(got.perm, want.perm) and _same_bits(got.Xs.numpy(), want.Xs.numpy())
