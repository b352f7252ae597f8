"""DMSwarm: particle ("swarm") data management + PIC coupling to a mesh.

Counterpart of ``petsc_tpu/dm/swarm.py`` (reference src/dm/impls/swarm:
DMSwarmRegisterPetscDatatypeField, DMSwarmMigrate, DMSwarmProjectFields,
DMSwarmSetCellDM). A swarm is a struct of arrays: one (n, bs) tensor per
field on the device, so every PIC operation is a vectorised map:
  - binning a particle to a cell of a DMDA is a floor-divide and a clip;
  - deposition (particle -> grid) is the cloud-in-cell scatter-add, W1
    (``ops/particle_kernels.py``);
  - interpolation (grid -> particle) is the adjoint gather with the same
    weights, W2;
  - migration on one device is a stable sort by cell id (``torch.sort``,
    stable), as the reference's ``np.argsort(kind="stable")``.

The swarm keeps its particles' cell order (``particle_kernels.cell_order``:
the stable permutation by cell, each cell's offsets and the coordinates in
that order; PETSc's DMSwarmSortGetAccess) with its coordinates: W1 sums
each node in the reference's order from it, and ``migrate`` applies it
instead of sorting again (after which the order is the identity). Like
PETSc's sort context it goes stale with the coordinates: every change of
them or of the cell DM drops it (``setPointCoordinates``, even of the same
tensor, ``restoreField`` of the coordinates, ``addNPoints``,
``removePoints``, ``setLocalSizes``, ``setCellDM``), and an in-place write
through ``getFieldTensor`` shows in the coordinate tensor's version
counter, which the cached order is keyed on with its storage.

``getField`` gives a host numpy copy of a field and ``restoreField`` writes
it (or the array given) back, PETSc's DMSwarmGetField/RestoreField
contract; the reference hands out its own numpy array, so there a change
shows without the restore (ROADMAP section 3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import particle_kernels as pk
from ..parallel.layout import Layout
from ..sys.error import Error
from ..vec.vec import Vec
from .dm import DM

_COOR = "DMSwarmPIC_coor"


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class DMSwarm(DM):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._fields: dict[str, int] = {}      # name -> blocksize
        self._data: dict[str, torch.Tensor] = {}
        self._borrowed: dict[str, np.ndarray] = {}
        self._n = 0
        self._order = None        # the coordinates' cell order, or None
        self.cell_dm = None
        self.swarm_type = "basic"              # basic | pic

    # ---- setup (swarm.c registration API) ----

    @classmethod
    def create(cls, comm=None):
        sw = cls(comm)
        sw.registerField(_COOR, 0)   # placeholder, sized later
        return sw

    def _device(self):
        return config.device()

    def setType(self, t):
        self.swarm_type = t
        return self

    def setCellDM(self, dm):
        self.cell_dm = dm
        self._order = None
        if _COOR in self._fields:
            self._fields[_COOR] = dm.dim
        return self

    def registerField(self, name, bs, dtype=np.float64):
        self._fields[name] = int(bs)
        if name == _COOR:
            self._order = None
        if self._n and bs:
            self._data[name] = torch.zeros((self._n, bs), dtype=_torch_dtype(dtype),
                                           device=self._device())
        return self

    def finalizeFieldRegister(self):
        return self

    def setLocalSizes(self, n, buffer=-1):
        self._n = int(n)
        self._order = None
        for name, bs in self._fields.items():
            if bs:
                self._data[name] = torch.zeros((self._n, bs), dtype=torch.float64,
                                               device=self._device())
        return self

    def getLocalSize(self):
        return self._n

    getSize = getLocalSize

    # ---- field access (DMSwarmGetField / RestoreField) ----

    def getField(self, name):
        """A host numpy copy of the field, (n, bs); restoreField writes it
        back."""
        if name not in self._data:
            raise Error(f"DMSwarm: unknown field '{name}'")
        arr = self._data[name].cpu().numpy().copy()
        self._borrowed[name] = arr
        return arr

    def getFieldTensor(self, name):
        """The field's device tensor itself, (n, bs)."""
        if name not in self._data:
            raise Error(f"DMSwarm: unknown field '{name}'")
        return self._data[name]

    def restoreField(self, name, arr=None):
        """Write the field back from `arr` (numpy or a tensor), or from the
        copy that getField gave."""
        if arr is None:
            arr = self._borrowed.pop(name, None)
            if arr is None:
                return self
        else:
            self._borrowed.pop(name, None)
        if name == _COOR:
            self._order = None
        dt = self._data[name].dtype if name in self._data else torch.float64
        self._data[name] = torch.as_tensor(arr, dtype=dt).to(self._device()).reshape(
            self._n, -1).contiguous()
        return self

    def setPointCoordinates(self, coords):
        coords = torch.as_tensor(coords, dtype=torch.float64).to(self._device())
        coords = torch.atleast_2d(coords).contiguous()
        if self._n != len(coords):
            self.setLocalSizes(len(coords))
        self._fields[_COOR] = coords.shape[1]
        self._data[_COOR] = coords
        self._order = None        # PETSc: restoring the coordinates makes the sort stale
        return self

    def insertPointsUsingCellDM(self, ppcell=1, layout="regular"):
        """DMSwarmInsertPointsUsingCellDM: ppcell^dim equispaced particles
        per cell of the DMDA cell DM (made on the device)."""
        da = self.cell_dm
        if da is None:
            raise Error("DMSwarm: setCellDM first")
        axes, dev = [], self._device()
        for ax in range(da.dim):
            m = (da.sizes[ax] - 1) * ppcell
            # divided by a tensor: a CUDA division by a host scalar multiplies
            # by its reciprocal, which rounds otherwise than numpy's division
            axes.append((torch.arange(m, dtype=torch.float64, device=dev) + 0.5)
                        / torch.tensor(float(m), dtype=torch.float64, device=dev))
        grids = torch.meshgrid(*axes, indexing="ij")
        self.setPointCoordinates(torch.stack([g.reshape(-1) for g in grids], dim=1))
        return self

    def addNPoints(self, coords):
        coords = torch.atleast_2d(torch.as_tensor(coords, dtype=torch.float64)).to(
            self._device())
        old = self._data.get(_COOR, torch.zeros((0, coords.shape[1]), dtype=torch.float64,
                                                device=self._device()))
        self._n += len(coords)
        self._order = None
        for name, bs in self._fields.items():
            if name == _COOR:
                self._data[name] = torch.cat([old, coords])
            elif bs:
                cur = self._data.get(name, torch.zeros((0, bs), dtype=torch.float64,
                                                       device=self._device()))
                self._data[name] = torch.cat([cur, torch.zeros((len(coords), bs),
                                                               dtype=cur.dtype,
                                                               device=cur.device)])
        return self

    def removePoints(self, mask):
        """Remove particles where mask is True (DMSwarmRemovePoint)."""
        keep = ~torch.as_tensor(np.asarray(mask, dtype=bool)).to(self._device())
        for name in list(self._data):
            self._data[name] = self._data[name][keep]
        self._n = int(keep.sum())
        self._order = None
        return self

    # ---- PIC coupling ----

    def _grid(self):
        da = self.cell_dm
        if da is None or da.dim is None:
            raise Error("DMSwarm: setCellDM with a DMDA first")
        return pk.Grid(da.sizes[: da.dim])

    def _coords(self, grid):
        X = self._data[_COOR]
        if X.shape[1] != grid.dim:
            raise Error(f"DMSwarm: {X.shape[1]}-D coordinates on a {grid.dim}-D cell DM")
        return X

    def binToCells(self):
        """Cell id per particle on the unit-box DMDA (a floor-divide, the
        replacement for DMSwarmMigrate's point location walk), a device
        int64 tensor."""
        grid = self._grid()
        return pk.cell_ids(self._coords(grid), grid)

    def cellOrder(self):
        """The particles' cell order (particle_kernels.CellOrder), built at
        first need and kept until the coordinates or the cell DM change."""
        grid = self._grid()
        X = self._coords(grid)
        o = self._order
        if o is None or o.key != pk.coords_key(X) or tuple(o.sizes) != grid.sizes:
            o = self._order = pk.cell_order(X, grid)
        return o

    def migrate(self, remove_sent_points=True):
        """Stable sort by owning cell: re-establishes locality (the
        single-device analog of DMSwarmMigrate's rank exchange), by the
        kept cell order; the order is the identity after."""
        order = self.cellOrder()
        if order.perm is not None:
            for name in list(self._data):
                # the coordinates in cell order are the order's own copy
                self._data[name] = order.Xs if name == _COOR else self._data[name].index_select(
                    0, order.perm)
            self._order = pk.identity_order(order, self._data[_COOR])
        return self

    def _vec(self, t):
        v = Vec(self.comm)
        v.layout = Layout(t.shape[0], axis=v.comm.axis)
        v._array = t
        v._setup_called = True
        return v

    def projectFields(self, names, mode="cic"):
        """Particle -> mesh deposition (DMSwarmProjectFields). CIC
        (multilinear) weights on W1, one launch with the weight sums;
        returns one node-based Vec per field, normalized by the deposited
        weight sum per node (1 where it is 0)."""
        grid = self._grid()
        X = self._coords(grid)
        names_l = [names] if isinstance(names, str) else list(names)
        acc = pk.cic_deposit(X, grid, [self._data[nm][:, 0].contiguous() for nm in names_l],
                             wsum=True, order=self.cellOrder())
        wsum = acc[-1]
        wsafe = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
        outs = [self._vec(acc[k] / wsafe) for k in range(len(names_l))]
        return outs[0] if isinstance(names, str) else outs

    def depositSum(self, name):
        """Conservative deposition: raw weighted sums per node (what a
        charge-deposition step needs; the total is conserved), on W1."""
        grid = self._grid()
        X = self._coords(grid)
        acc = pk.cic_deposit(X, grid, [self._data[name][:, 0].contiguous()],
                             order=self.cellOrder())
        return self._vec(acc[0])

    def interpolateToParticles(self, vec):
        """Mesh -> particle gather with the same CIC weights (the adjoint
        of deposition), on W2; a host numpy array, as the reference's."""
        return self.interpolateToParticlesTensor(vec).cpu().numpy()

    def interpolateToParticlesTensor(self, vec):
        """interpolateToParticles, left on the device."""
        grid = self._grid()
        X = self._coords(grid)
        v = vec.array if isinstance(vec, Vec) else torch.as_tensor(vec).to(X.device)
        return pk.cic_interp(X, grid, v[: grid.nnodes].to(X.dtype).contiguous())
