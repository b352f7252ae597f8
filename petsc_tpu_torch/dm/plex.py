"""DMPlex (lite): unstructured meshes as a stratified point DAG + P1 FEM.

Counterpart of ``petsc_tpu/dm/plex.py``. Behavioral reference: src/dm/impls/plex (plex.c cone/support/closure on the
CW-complex DAG; plexcreate.c DMPlexCreateFromCellList / box meshes;
plexfem.c FEM assembly) and src/vec/is/section (PetscSection dof layout).
This is the round-1 slice of the Plex stack: simplicial/tensor cells in
2-D/3-D, cone/support queries, boundary detection, a Section mapping
points -> dofs, and vectorized P1 (linear simplex) stiffness/mass assembly
feeding the framework's solvers (higher-order FE spaces are in fe.py).

The mesh is host data (numpy), numbered as the reference numbers it, so
PCMG's interpolations, the FE dof layout and every history agree; the
refinement of triangles is vectorised with the reference's numbering (the
first occurrence of each edge over the cells, in cell order). The
operators it assembles are MatAIJs on the device :func:`init` chose.
Distribution over several cards (``distribute`` on more than one shard,
the distributed P1 assembly) comes with ROADMAP queue 1 item 12, the HDF5
mesh I/O with item 11b (with item 13's ``sys/hdf5.py``); they raise.
"""

from __future__ import annotations

import numpy as np

from ..sys.error import Error
from ..vec.vec import Vec
from .dm import DM


class Section:
    """PetscSection: dofs per point + prefix-sum offsets, with named
    FIELDS (sub-layouts) and per-point constrained dofs
    (src/vec/is/section/interface/section.c: PetscSectionSetDof/
    SetFieldDof/SetConstraintDof/GetOffset/GetFieldOffset/Chart)."""

    def setNumFields(self, nf):
        self._fields = [np.zeros(len(self.ndof), dtype=np.int64)
                        for _ in range(nf)]
        return self

    def getNumFields(self):
        return len(getattr(self, "_fields", []))

    def setFieldDof(self, point, field, n):
        self._fields[field][np.asarray(point)] = n
        self._off = None

    def getFieldDof(self, point, field):
        return int(self._fields[field][point])

    def getFieldOffset(self, point, field):
        """Offset of a field's dofs within the point's block (fields are
        laid out consecutively per point, the reference default)."""
        base = self.getOffset(point)
        return base + int(sum(self._fields[f][point]
                              for f in range(field)))

    def setConstraintDof(self, point, n):
        if not hasattr(self, "_cdof"):
            self._cdof = np.zeros(len(self.ndof), dtype=np.int64)
        self._cdof[np.asarray(point)] = n

    def getConstraintDof(self, point):
        return int(getattr(self, "_cdof",
                           np.zeros(len(self.ndof)))[point])

    def getChart(self):
        return 0, len(self.ndof)

    def getConstrainedStorageSize(self):
        return self.getStorageSize() - int(
            getattr(self, "_cdof", np.zeros(1)).sum())

    def __init__(self, npoints):
        self.ndof = np.zeros(npoints, dtype=np.int64)
        self._off = None

    def setDof(self, point, n):
        self.ndof[np.asarray(point)] = n
        self._off = None

    def setUp(self):
        self._off = np.concatenate([[0], np.cumsum(self.ndof)])
        return self

    def getOffset(self, point):
        if self._off is None:
            self.setUp()
        return self._off[point]

    def getStorageSize(self):
        if self._off is None:
            self.setUp()
        return int(self._off[-1])


class DMPlex(DM):
    """Points are numbered cells first, then vertices (interpolated edges/
    faces omitted in the lite version — P1 needs only cells+vertices)."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self.dim = 0
        self.cells = None        # (ncell, nverts_per_cell) vertex ids
        self.coords = None       # (nvert, dim)
        self.section = None

    # ---- creation (plexcreate.c) ----

    @classmethod
    def createFromCellList(cls, dim, cells, coords, comm=None):
        p = cls(comm)
        p.dim = int(dim)
        p.cells = np.asarray(cells, dtype=np.int64)
        p.coords = np.asarray(coords, dtype=np.float64)
        return p

    @classmethod
    def createBoxMesh(cls, faces, simplex=True, comm=None):
        """Unit box mesh: `faces` cells per axis; 2-D tri/quad or 3-D
        tet/hex (DMPlexCreateBoxMesh)."""
        faces = tuple(int(f) for f in np.atleast_1d(faces))
        dim = len(faces)
        if dim == 2:
            nx, ny = faces
            xs = np.linspace(0, 1, nx + 1)
            ys = np.linspace(0, 1, ny + 1)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            coords = np.stack([X.ravel(), Y.ravel()], axis=1)
            vid = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
            q00 = vid[:-1, :-1].ravel()
            q10 = vid[1:, :-1].ravel()
            q11 = vid[1:, 1:].ravel()
            q01 = vid[:-1, 1:].ravel()
            if simplex:
                cells = np.concatenate([
                    np.stack([q00, q10, q11], axis=1),
                    np.stack([q00, q11, q01], axis=1)])
            else:
                cells = np.stack([q00, q10, q11, q01], axis=1)
            return cls.createFromCellList(2, cells, coords, comm)
        if dim == 3:
            nx, ny, nz = faces
            xs = [np.linspace(0, 1, n + 1) for n in faces]
            X, Y, Z = np.meshgrid(*xs, indexing="ij")
            coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
            vid = np.arange((nx + 1) * (ny + 1) * (nz + 1)) \
                .reshape(nx + 1, ny + 1, nz + 1)
            c = {}
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        c[(dx, dy, dz)] = vid[dx:nx + dx, dy:ny + dy,
                                              dz:nz + dz].ravel()
            hexes = np.stack([c[(0, 0, 0)], c[(1, 0, 0)], c[(1, 1, 0)],
                              c[(0, 1, 0)], c[(0, 0, 1)], c[(1, 0, 1)],
                              c[(1, 1, 1)], c[(0, 1, 1)]], axis=1)
            if not simplex:
                return cls.createFromCellList(3, hexes, coords, comm)
            # split each hex into 6 tets (standard Kuhn triangulation)
            t = [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                 [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]]
            cells = np.concatenate([hexes[:, tt] for tt in t])
            return cls.createFromCellList(3, cells, coords, comm)
        raise Error(f"createBoxMesh: dim {dim}")

    @classmethod
    def createFromGmsh(cls, path, comm=None):
        """Read a Gmsh ASCII .msh file, format v2.2 OR v4.1
        (DMPlexCreateGmsh role, plexgmsh.c): highest-dimensional elements
        become cells; physical tags are kept as labels (DMLabel-lite dict
        name -> cell ids). v4.1 entity-block physical tags come from the
        $Entities section."""
        nodes = {}
        elems = []           # (etype, tag, [verts])
        with open(path) as f:
            text = f.read()
        version = 2.2
        lines = iter(text.splitlines())
        for line in lines:
            if line.startswith("$MeshFormat"):
                version = float(next(lines).split()[0])
                break
        if version >= 4.0:
            nodes, elems = cls._parse_gmsh41(text)
            return cls._gmsh_finish(nodes, elems, comm)
        lines = iter(text.splitlines())
        for line in lines:
            if line.startswith("$Nodes"):
                nn = int(next(lines))
                for _ in range(nn):
                    parts = next(lines).split()
                    nodes[int(parts[0])] = [float(v) for v in parts[1:4]]
            elif line.startswith("$Elements"):
                ne = int(next(lines))
                for _ in range(ne):
                    parts = [int(v) for v in next(lines).split()]
                    etype = parts[1]
                    ntags = parts[2]
                    tag = parts[3] if ntags else 0
                    verts = parts[3 + ntags:]
                    elems.append((etype, tag, verts))
        return cls._gmsh_finish(nodes, elems, comm)

    @staticmethod
    def _parse_gmsh41(text):
        """MSH 4.1 ASCII: $Entities (dim/tag -> physical tag),
        block-structured $Nodes and $Elements (gmsh.info MSH 4.1 spec;
        plexgmsh.c GmshReadMSH4*)."""
        lines = iter(text.splitlines())
        ent_phys = {}        # (dim, entity_tag) -> physical tag
        nodes = {}
        elems = []
        for line in lines:
            if line.startswith("$Entities"):
                np_, nc_, ns_, nv_ = (int(v) for v in next(lines).split())
                for dim, cnt in ((0, np_), (1, nc_), (2, ns_), (3, nv_)):
                    for _ in range(cnt):
                        parts = next(lines).split()
                        tag = int(parts[0])
                        # points: tag x y z nphys [phys...]; higher dims:
                        # tag 6-bbox nphys [phys...] nbound [...]
                        base = 4 if dim == 0 else 7
                        nphys = int(parts[base])
                        phys = (int(parts[base + 1]) if nphys else 0)
                        ent_phys[(dim, tag)] = phys
            elif line.startswith("$Nodes"):
                nblocks, _, _, _ = (int(v) for v in next(lines).split())
                for _ in range(nblocks):
                    _, _, _, nn = (int(v) for v in next(lines).split())
                    tags = [int(next(lines)) for _ in range(nn)]
                    for t in tags:
                        nodes[t] = [float(v) for v in next(lines).split()[:3]]
            elif line.startswith("$Elements"):
                nblocks, _, _, _ = (int(v) for v in next(lines).split())
                for _ in range(nblocks):
                    edim, etag, etype, ne = (int(v)
                                             for v in next(lines).split())
                    phys = ent_phys.get((edim, etag), 0)
                    for _ in range(ne):
                        parts = [int(v) for v in next(lines).split()]
                        elems.append((etype, phys, parts[1:]))
        return nodes, elems

    @classmethod
    def _gmsh_finish(cls, nodes, elems, comm):
        # element types: 2 tri, 3 quad, 4 tet, 5 hex (gmsh numbering)
        dim_of = {2: 2, 3: 2, 4: 3, 5: 3}
        present = [e for e in elems if e[0] in dim_of]
        if not present:
            raise Error("gmsh file has no 2-D/3-D elements")
        dim = max(dim_of[e[0]] for e in present)
        cell_types = {t for t, d in dim_of.items() if d == dim}
        cells_raw = [e for e in present if e[0] in cell_types]
        # renumber vertices contiguously
        used = sorted({v for _, _, vs in cells_raw for v in vs})
        remap = {g: i for i, g in enumerate(used)}
        coords = np.asarray([nodes[g][:dim] for g in used])
        cells = np.asarray([[remap[v] for v in vs]
                            for _, _, vs in cells_raw], dtype=np.int64)
        p = cls.createFromCellList(dim, cells, coords, comm)
        p.labels = {}
        for ci, (_, tag, _) in enumerate(cells_raw):
            p.labels.setdefault(f"physical_{tag}", []).append(ci)
        p.labels = {k: np.asarray(v) for k, v in p.labels.items()}
        return p

    # ---- DAG queries (plex.c) ----

    @property
    def ncells(self):
        return len(self.cells)

    @property
    def nvertices(self):
        return len(self.coords)

    def getChart(self):
        """(pStart, pEnd): cells [0, ncells), vertices [ncells, ncells+nv)."""
        return 0, self.ncells + self.nvertices

    def getHeightStratum(self, h):
        if h == 0:
            return 0, self.ncells
        if h == self.dim:
            return self.ncells, self.ncells + self.nvertices
        raise Error("lite plex: only cells (h=0) and vertices (h=dim)")

    getDepthStratum = None  # overridden below

    def getCone(self, cell):
        """Vertex points of a cell (closure in the uninterpolated DAG)."""
        return self.cells[cell] + self.ncells

    def getSupport(self, vertex_point):
        v = vertex_point - self.ncells
        return np.nonzero((self.cells == v).any(axis=1))[0]

    def getConeClosure(self, cell):
        return np.concatenate([[cell], self.getCone(cell)])

    def interpolate(self):
        """DMPlexInterpolate (plexinterpolate.c): generate the
        intermediate strata so the chart becomes a full CW-complex DAG.
        2-D simplex: cells -> edges -> vertices (.edges (ne,2),
        .cell2edge (nc,3)); 3-D tets additionally get the FACE stratum
        (.faces (nf,3), .cell2face (nc,4), .face2edge (nf,3)) so cones
        run cells -> faces -> edges -> vertices. Edge points start at
        ncells + nvertices; face points follow the edges."""
        if self.dim == 3 and self.cells.shape[1] == 4:
            pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
            emap = {}
            c2e = np.zeros((self.ncells, 6), dtype=np.int64)
            for c, cell in enumerate(self.cells):
                for k, (a, b) in enumerate(pairs):
                    key = tuple(sorted((int(cell[a]), int(cell[b]))))
                    c2e[c, k] = emap.setdefault(key, len(emap))
            self.edges = np.asarray(sorted(emap, key=emap.get),
                                    dtype=np.int64)
            self.cell2edge = c2e
            triples = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
            fmap = {}
            c2f = np.zeros((self.ncells, 4), dtype=np.int64)
            for c, cell in enumerate(self.cells):
                for k, tri in enumerate(triples):
                    key = tuple(sorted(int(cell[v]) for v in tri))
                    c2f[c, k] = fmap.setdefault(key, len(fmap))
            self.faces = np.asarray(sorted(fmap, key=fmap.get),
                                    dtype=np.int64)
            self.cell2face = c2f
            f2e = np.zeros((len(self.faces), 3), dtype=np.int64)
            for fi, (a, b, c_) in enumerate(self.faces):
                f2e[fi] = [emap[(int(a), int(b))], emap[(int(b), int(c_))],
                           emap[(int(a), int(c_))]]
            self.face2edge = f2e
            self._interpolated = True
            return self
        from .fe import build_edges
        self.edges, self.cell2edge = build_edges(self.cells)
        self._interpolated = True
        return self

    def getDepth(self):
        if not getattr(self, "_interpolated", False):
            return 1
        return 3 if self.dim == 3 else 2

    def getFaceCone(self, face_point):
        """Cone of a face point (3-D interpolated): its three edge
        points."""
        base_f = self.ncells + self.nvertices + len(self.edges)
        base_e = self.ncells + self.nvertices
        return self.face2edge[face_point - base_f] + base_e

    def getConeInterpolated(self, cell):
        """Cone of a cell AFTER interpolate(): 2-D its three edge points,
        3-D its four face points."""
        if not getattr(self, "_interpolated", False):
            raise Error("call interpolate() first")
        base = self.ncells + self.nvertices
        if self.dim == 3:
            return self.cell2face[cell] + base + len(self.edges)
        return self.cell2edge[cell] + base

    def getEdgeCone(self, edge_point):
        """Cone of an edge point: its two vertex points."""
        base = self.ncells + self.nvertices
        return self.edges[edge_point - base] + self.ncells

    def distribute(self, overlap=0, partitioner=None):
        """DMPlexDistribute (plexdistribute.c:DMPlexDistribute): with a
        one-shard communicator the mesh itself (the mpiuni path). Several
        shards come with ROADMAP queue 1 item 12, and raise."""
        nsh = self.comm.nshards if self.comm is not None else 1
        if nsh <= 1:
            return self
        raise Error("DMPlex.distribute over several shards comes with ROADMAP "
                    "queue 1 item 12 (distribution over several cards)")

    distribution = None
    migration = None

    def extrude(self, layers, height=1.0):
        """DMPlexExtrude (plexextrude.c role): extrude a 2-D triangle
        mesh `layers` steps in z into a conforming TET mesh (3 tets per
        prism, Dompierre splitting: every quad face takes the diagonal
        through its globally smallest vertex, so neighboring prisms
        always agree)."""
        if self.dim != 2 or self.cells.shape[1] != 3:
            raise Error("extrude: 2-D triangle meshes only")
        nv = self.nvertices
        zs = np.linspace(0.0, float(height), layers + 1)
        coords3 = np.concatenate([
            np.concatenate([self.coords, np.full((nv, 1), z)], axis=1)
            for z in zs])
        tets = []
        for k in range(layers):
            base = self.cells + k * nv
            for tri in base:
                # rotate so the globally smallest bottom vertex leads
                r = int(np.argmin(tri))
                a, b, c = (int(tri[(r + i) % 3]) for i in range(3))
                a2, b2, c2 = a + nv, b + nv, c + nv
                if min(b, c2) <= min(c, b2):     # face(bc) diag (b, c')
                    tets += [(a, b, c, c2), (a, b, c2, b2),
                             (a, b2, c2, a2)]
                else:                            # face(bc) diag (c, b')
                    tets += [(a, b, c, b2), (a, c, b2, c2),
                             (a, b2, c2, a2)]
        return DMPlex.createFromCellList(
            3, np.asarray(tets, dtype=np.int64), coords3, self.comm)

    def curveBoundary(self, project):
        """High-order (quadratic) geometry: attach an isoparametric P2
        coordinate field whose boundary-edge midpoints are snapped onto
        the true boundary by `project(x) -> x_on_boundary` (the
        DMPlexCreateCoordinateSpace degree-2 / DMPlexRemapGeometry role,
        plexgeometry.c).  Interior midpoints stay straight.  The DS
        assembly then computes per-quadrature-point Jacobians through
        the curved map, restoring O(h^{k+1}) convergence for P_k
        elements on curved domains (straight P1 geometry caps it at
        O(h^2))."""
        if self.dim != 2 or self.cells.shape[1] != 3:
            raise Error("curveBoundary: 2-D triangle meshes only")
        from .fe import build_edges
        edges, c2e = build_edges(self.cells)
        mids = 0.5 * (self.coords[edges[:, 0]] + self.coords[edges[:, 1]])
        # boundary edges: appear in exactly one cell
        counts = np.bincount(c2e.reshape(-1), minlength=len(edges))
        bnd = counts == 1
        for e in np.nonzero(bnd)[0]:
            mids[e] = np.asarray(project(mids[e]), dtype=np.float64)
        self.p2_geom = (
            np.concatenate([self.cells, self.nvertices + c2e], axis=1),
            np.vstack([self.coords, mids]))
        return self

    def extrudeToPrisms(self, layers, height=1.0):
        """DMPlexExtrude with tensor cells (plexextrude.c's default
        production: DM_POLYTOPE_TRI_PRISM columns): extrude a 2-D
        triangle mesh into wedge/prism cells (corners 0-2 bottom, 3-5
        top) — the mesh family for lagrange_fe(3, k, cell='prism')."""
        if self.dim != 2 or self.cells.shape[1] != 3:
            raise Error("extrudeToPrisms: 2-D triangle meshes only")
        nv = self.nvertices
        zs = np.linspace(0.0, float(height), layers + 1)
        coords3 = np.concatenate([
            np.concatenate([self.coords, np.full((nv, 1), z)], axis=1)
            for z in zs])
        prisms = np.concatenate([
            np.concatenate([self.cells + k * nv,
                            self.cells + (k + 1) * nv], axis=1)
            for k in range(layers)])
        return DMPlex.createFromCellList(3, prisms, coords3, self.comm)

    def getLabel(self, name):
        """DMGetLabel: cell labels (e.g. Gmsh physical groups parsed by
        createFromGmsh) as a first-class DMLabel object. A
        physical_<tag> group is inserted under value <tag> whichever way
        it is queried; an unknown name returns None (DMGetLabel NULL
        semantics)."""
        from .label import DMLabel
        raw = getattr(self, "labels", {})
        lbl = DMLabel(name)
        if name in raw:
            val = (int(name.split("_", 1)[1])
                   if name.startswith("physical_")
                   and name.split("_", 1)[1].isdigit() else 1)
            lbl.insertIS(np.asarray(raw[name]), val)
            return lbl
        if name == "physical":
            # aggregate: every physical_<tag> group -> value tag
            for key, cells in raw.items():
                if key.startswith("physical_"):
                    lbl.insertIS(np.asarray(cells),
                                 int(key.split("_", 1)[1]))
            return lbl
        return None

    def refine(self):
        """DMRefine: regular "red" refinement of tri/quad/tet/hex cells
        (plexrefine.c / transform/impls/refine regular role). New
        vertices sit at edge midpoints (plus face centers and the cell
        center for tensor cells); each tri/quad splits into 4 children,
        each tet (Bey's scheme, diagonal m01-m23) and hex into 8; cell
        labels are inherited by children. The refined plex records its
        coarse parent and the exact P1/Q1 coarse-to-fine interpolation
        (vertex weights = average over the defining parent vertices), so
        `coarsen()` / `createInterpolation()` drive PCMG geometric
        hierarchies on unstructured meshes (the DMDA dainterp.c role).
        Tensor children at far corners come out mirrored (negative
        Jacobian) — volume-magnitude assembly is unaffected."""
        import scipy.sparse as sp
        dim, cells, nv = self.dim, self.cells, self.nvertices
        nvl = cells.shape[1]
        if dim == 2 and nvl == 3:
            return self._refine_tri()
        key2id = {}

        def vid(*verts):
            if len(verts) == 1:
                return int(verts[0])
            key = tuple(sorted(int(v) for v in verts))
            if key not in key2id:
                key2id[key] = nv + len(key2id)
            return key2id[key]

        newcells = []
        if dim == 2 and nvl == 3:
            for a, b, c in cells:
                m01, m12, m20 = vid(a, b), vid(b, c), vid(c, a)
                newcells += [[a, m01, m20], [m01, b, m12],
                             [m20, m12, c], [m01, m12, m20]]
        elif dim == 3 and nvl == 4:
            for v0, v1, v2, v3 in cells:
                m01, m02, m03 = vid(v0, v1), vid(v0, v2), vid(v0, v3)
                m12, m13, m23 = vid(v1, v2), vid(v1, v3), vid(v2, v3)
                newcells += [
                    [v0, m01, m02, m03], [m01, v1, m12, m13],
                    [m02, m12, v2, m23], [m03, m13, m23, v3],
                    [m01, m02, m03, m23], [m01, m02, m12, m23],
                    [m01, m03, m13, m23], [m01, m12, m13, m23]]
        elif nvl == 2 ** dim and dim in (2, 3):
            # tensor cells: vertex k has local coords L[k]; child per
            # corner spans [corner, center]
            L2 = [(0, 0), (1, 0), (1, 1), (0, 1)]
            L3 = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                  (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
            L = L2 if dim == 2 else L3

            def pos_key(cell, q):
                # parent vertices consistent with local position q
                # (q_d in {0, 0.5, 1}); 1/2/4/8 of them
                return [int(cell[k]) for k in range(len(L))
                        if all(q[d] == 0.5 or L[k][d] == q[d]
                               for d in range(dim))]

            for cell in cells:
                for ck in range(len(L)):
                    child = []
                    for j in range(len(L)):
                        q = tuple(L[ck][d] if L[j][d] == 0 else 0.5
                                  for d in range(dim))
                        child.append(vid(*pos_key(cell, q)))
                    newcells.append(child)
        else:
            raise Error(f"refine: unsupported cell (dim={dim}, nv={nvl})")

        nnew = len(key2id)
        new_coords = np.zeros((nv + nnew, dim))
        new_coords[:nv] = self.coords
        rows, cols, vals = list(range(nv)), list(range(nv)), [1.0] * nv
        for key, idx in key2id.items():
            new_coords[idx] = self.coords[list(key)].mean(axis=0)
            w = 1.0 / len(key)
            for pv in key:
                rows.append(idx); cols.append(pv); vals.append(w)
        fine = DMPlex.createFromCellList(
            dim, np.asarray(newcells, dtype=np.int64), new_coords,
            self.comm)
        nch = 4 if dim == 2 else 8
        if getattr(self, "labels", None):
            fine.labels = {
                name: (np.asarray(ids)[:, None] * nch
                       + np.arange(nch)).reshape(-1)
                for name, ids in self.labels.items()}
        fine._coarse_plex = self
        fine._interp = sp.csr_matrix(
            (vals, (rows, cols)), shape=(nv + nnew, nv))
        return fine

    def _refine_tri(self):
        """refine() of a triangle mesh, vectorised: each edge's midpoint is
        numbered in the order of its first occurrence over the cells'
        (01, 12, 20) edges, as the reference's dict numbers it, so the
        vertex ids, the children and the interpolation are the
        reference's."""
        import scipy.sparse as sp
        cells, nv, coords = self.cells, self.nvertices, self.coords
        nc = len(cells)
        a, b, c = cells[:, 0], cells[:, 1], cells[:, 2]
        pairs = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                          np.stack([c, a], 1)], 1)              # (nc, 3, 2)
        key = np.sort(pairs, axis=2).reshape(-1, 2)
        uniq, first, inv = np.unique(key[:, 0] * nv + key[:, 1], return_index=True,
                                     return_inverse=True)
        by_first = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[by_first] = np.arange(len(uniq))
        mid = nv + rank[inv.reshape(-1)].reshape(nc, 3)
        m01, m12, m20 = mid[:, 0], mid[:, 1], mid[:, 2]
        newcells = np.stack([a, m01, m20, m01, b, m12, m20, m12, c, m01, m12, m20],
                            axis=1).reshape(-1, 3)
        ekeys = key[first[by_first]]                            # (nnew, 2), id order
        nnew = len(ekeys)
        new_coords = np.zeros((nv + nnew, self.dim))
        new_coords[:nv] = self.coords
        new_coords[nv:] = (coords[ekeys[:, 0]] + coords[ekeys[:, 1]]) / 2
        ids = nv + np.arange(nnew)
        rows = np.concatenate([np.arange(nv), np.repeat(ids, 2)])
        cols = np.concatenate([np.arange(nv), ekeys.reshape(-1)])
        vals = np.concatenate([np.ones(nv), np.full(2 * nnew, 0.5)])
        fine = DMPlex.createFromCellList(2, newcells, new_coords, self.comm)
        if getattr(self, "labels", None):
            fine.labels = {
                name: (np.asarray(ids_)[:, None] * 4 + np.arange(4)).reshape(-1)
                for name, ids_ in self.labels.items()}
        fine._coarse_plex = self
        fine._interp = sp.csr_matrix((vals, (rows, cols)), shape=(nv + nnew, nv))
        return fine

    def adaptLabel(self, marked, value=None):
        """DMAdaptLabel (plexadapt.c): conforming red-green refinement
        of the marked cells — see dm.plex_transform.adapt_label."""
        from .plex_transform import adapt_label
        return adapt_label(self, marked, value=value)

    def adaptMetric(self, metric, max_passes=6):
        """DMAdaptMetric role (plexadapt.c/plexmetric.c), in-tree
        refinement-only fallback — see dm.plex_transform.adapt_metric."""
        from .plex_transform import adapt_metric
        return adapt_metric(self, metric, max_passes)

    def transform(self, ttype, **options):
        """Apply a DMPlexTransform by registry name
        (plextransform.c role) — see dm.plex_transform.PlexTransform."""
        from .plex_transform import PlexTransform
        return PlexTransform(ttype, **options).apply(self)

    def coarsen(self):
        """The refinement parent (DMCoarsen on a refined plex); PCMG's
        DM-driven hierarchy walks this chain."""
        parent = getattr(self, "_coarse_plex", None)
        if parent is None:
            raise Error("DMPlex.coarsen: no refinement parent recorded "
                        "(build the mesh by DMPlex.refine)")
        return parent

    def createInterpolation(self, coarse):
        """Coarse-to-fine P1/Q1 interpolation recorded by refine()
        (DMCreateInterpolation role)."""
        from ..mat.aij import MatAIJ
        if getattr(self, "_coarse_plex", None) is not coarse:
            raise Error("DMPlex.createInterpolation: `coarse` must be "
                        "this plex's refinement parent")
        return MatAIJ.from_scipy(self._interp.tocsr(), comm=self.comm)

    def createSubmesh(self, cell_ids):
        """DMPlexCreateSubmesh role (plexsubmesh.c, filter flavor):
        extract the mesh induced by `cell_ids` — vertices renumbered
        contiguously; parent maps kept in .parent_cells/.parent_vertices
        so fields restrict/prolong by plain indexing."""
        cell_ids = np.asarray(cell_ids, dtype=np.int64)
        sub_cells_g = self.cells[cell_ids]
        used = np.unique(sub_cells_g)
        remap = -np.ones(self.nvertices, dtype=np.int64)
        remap[used] = np.arange(len(used))
        sub = DMPlex.createFromCellList(self.dim, remap[sub_cells_g],
                                        self.coords[used], self.comm)
        sub.parent_cells = cell_ids
        sub.parent_vertices = used
        return sub

    def markBoundaryVertices(self):
        """Vertex ids on the domain boundary (facets shared by one cell —
        DMPlexMarkBoundaryFaces role)."""
        nv = self.cells.shape[1]
        if self.dim == 2 and nv == 3:
            fac = [[0, 1], [1, 2], [2, 0]]
        elif self.dim == 2 and nv == 4:
            fac = [[0, 1], [1, 2], [2, 3], [3, 0]]
        elif self.dim == 3 and nv == 4:
            fac = [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
        elif self.dim == 3 and nv == 8:
            fac = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
                   [2, 3, 7, 6], [0, 3, 7, 4], [1, 2, 6, 5]]
        elif self.dim == 3 and nv == 6:
            # prism: 2 triangle + 3 quad faces, counted per face family
            out = []
            for fac in ([[0, 1, 2], [3, 4, 5]],
                        [[0, 1, 4, 3], [1, 2, 5, 4], [0, 2, 5, 3]]):
                faces = np.concatenate([np.sort(self.cells[:, f], axis=1)
                                        for f in fac])
                uniq, counts = np.unique(faces, axis=0,
                                         return_counts=True)
                out.append(uniq[counts == 1].ravel())
            return np.unique(np.concatenate(out))
        else:
            raise Error("unknown cell shape")
        faces = np.concatenate([np.sort(self.cells[:, f], axis=1)
                                for f in fac])
        from .fv_plex import _unique_rows
        uniq, _, _, counts = _unique_rows(faces, self.nvertices)
        bnd_faces = uniq[counts == 1]
        return np.unique(bnd_faces.ravel())

    # ---- section / vectors ----

    def createSection(self, dof_per_vertex=1):
        pS, pE = self.getChart()
        s = Section(pE - pS)
        s.setDof(np.arange(self.ncells, pE), dof_per_vertex)
        s.setUp()
        self.section = s
        return s

    @property
    def N(self):
        if self.section is None:
            self.createSection()
        return self.section.getStorageSize()

    def createGlobalVector(self):
        v = Vec(self.comm)
        v.setSizes(self.N)
        v.setUp()
        v._dm = self
        return v

    def createMatrix(self):
        from ..mat.aij import MatAIJ
        A = MatAIJ(self.comm)
        A.setSizes((self.N, self.N))
        A._dm = self
        return A

    # ---- P1 FEM assembly (plexfem.c role, vectorized) ----

    def p1_gradients(self, cells=None):
        """Per-cell P1 basis gradients and volumes (affine simplices)."""
        cells = self.cells if cells is None else cells
        if cells.shape[1] != self.dim + 1:
            raise Error("P1 assembly needs simplicial cells")
        return _p1_cell_gradients(self.coords, cells, self.dim)

    def _dirichlet_values(self, bnd, dirichlet_value):
        """Per-boundary-vertex Dirichlet data: scalar, (nv,) array, or a
        callable g(x) evaluated at vertex coordinates."""
        if callable(dirichlet_value):
            return np.asarray([float(dirichlet_value(x))
                               for x in self.coords[bnd]])
        dv = np.asarray(dirichlet_value, dtype=np.float64)
        if dv.ndim == 0:
            return np.full(len(bnd), float(dv))
        return dv[bnd]

    def assemblePoissonP1(self, f=1.0, dirichlet_value=0.0):
        """(A, b): P1 stiffness for -Lap u = f with Dirichlet boundary rows
        replaced by identity (the ex45-style BC convention;
        MatZeroRowsColumns semantics — nonzero data is lifted into the
        interior rhs). `dirichlet_value` may be a scalar, a per-vertex
        array, or a callable g(x). On a distributed plex (after
        distribute()) assembly runs per shard over owned cells with an
        off-process row stash into a per-shard-block MPIAIJ — no global
        CSR is formed (ROADMAP queue 1 item 12: raises here)."""
        if self.distribution is not None:
            raise Error("the distributed P1 assembly comes with ROADMAP queue 1 "
                        "item 12 (distribution over several cards)")
        import scipy.sparse as sp
        g, vol = self.p1_gradients()
        nvl = self.cells.shape[1]
        Ke = np.einsum("cve,cwe,c->cvw", g, g, vol)  # (nc, d+1, d+1)
        rows = np.repeat(self.cells, nvl, axis=1).reshape(-1)
        cols = np.tile(self.cells, (1, nvl)).reshape(-1)
        A = sp.csr_matrix((Ke.reshape(-1), (rows, cols)),
                          shape=(self.nvertices, self.nvertices))
        b = np.zeros(self.nvertices)
        np.add.at(b, self.cells.reshape(-1),
                  np.repeat(f * vol / nvl, nvl))
        bnd = self.markBoundaryVertices()
        ub = np.zeros(self.nvertices)
        ub[bnd] = self._dirichlet_values(bnd, dirichlet_value)
        # lift: b_interior -= A[:, bnd] @ ub  (MatZeroRowsColumns)
        b -= A @ ub
        # Dirichlet: each bc row the unit diagonal alone, the bc columns of
        # the interior rows zeroed (kept as stored zeros, as the
        # reference's lil edit leaves them), bc value in rhs; vectorised
        isb = np.zeros(self.nvertices, dtype=bool)
        isb[bnd] = True
        Ad = A.tocoo()
        rows_in = ~isb[Ad.row]
        data = np.where(isb[Ad.col], 0.0, Ad.data)[rows_in]
        A = sp.csr_matrix((np.concatenate([data, np.ones(len(bnd))]),
                           (np.concatenate([Ad.row[rows_in], bnd]),
                            np.concatenate([Ad.col[rows_in], bnd]))), shape=A.shape)
        b[bnd] = ub[bnd]
        from ..mat.aij import MatAIJ
        M = MatAIJ.from_scipy(A, comm=self.comm)
        M._dm = self
        return M, Vec.from_array(b, comm=self.comm)

    def view(self, viewer=None):
        print(f"DMPlex Object (lite): dim={self.dim} cells={self.ncells} "
              f"vertices={self.nvertices}")

    # ---- mesh I/O (plexexodusii.c; plexhdf5.c comes with item 11b) ----

    @classmethod
    def createFromExodus(cls, path, comm=None):
        """DMPlexCreateExodusFromFile (plexexodusii.c): ExodusII meshes
        read through scipy's netCDF-3 reader — no netCDF-C needed
        (Exodus files ARE netCDF-3 classic containers)."""
        from .plex_exodus import plex_load_exodus
        return plex_load_exodus(path, comm=comm)

    def viewExodus(self, path, title="petsc_tpu_torch plex"):
        """DMView to ExodusII (TRI3/QUAD4/TETRA4/HEX8 single block)."""
        from .plex_exodus import plex_view_exodus
        return plex_view_exodus(self, path, title=title)

    def viewHDF5(self, path, name="plex", mode="w"):
        """DMView to HDF5 (plexhdf5.c; the reference's layout, plex_io.py)."""
        from .plex_io import plex_view_hdf5
        return plex_view_hdf5(self, path, name=name, mode=mode)

    @classmethod
    def createFromHDF5(cls, path, name=None, comm=None):
        """DMLoad / DMPlexCreateFromFile(.h5)."""
        from .plex_io import plex_load_hdf5
        return plex_load_hdf5(path, name=name, comm=comm)

    def vecViewHDF5(self, path, vname, vec, name="plex"):
        """VecView of a section vector to HDF5 under the mesh's group."""
        from .plex_io import plex_vec_view_hdf5
        return plex_vec_view_hdf5(self, path, vname, vec, name=name)

    def vecLoadHDF5(self, path, vname, name="plex"):
        """VecLoad of a section vector from HDF5 (a host numpy array, as
        the reference's)."""
        from .plex_io import plex_vec_load_hdf5
        return plex_vec_load_hdf5(self, path, vname, name=name)


def _p1_cell_gradients(coords, cells, dim):
    """Per-cell P1 basis gradients and volumes for a cell subset (the
    vectorized plexfem.c geometry kernel: DMPlexComputeCellGeometryFEM)."""
    import math
    v = coords[cells]                            # (nc, d+1, d)
    J = v[:, 1:, :] - v[:, :1, :]                # (nc, d, d)
    detJ = np.linalg.det(J)
    vol = np.abs(detJ) / math.factorial(dim)
    Jinv = np.linalg.inv(J)                      # (nc, d, d)
    # reference gradients: phi_0 = 1-sum(xi) -> -1s; phi_i = xi_i
    gref = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    # d/dx_e phi_v = sum_d gref[v,d] * (J^{-T})[d,e] = gref @ Jinv^T
    g = np.einsum("vd,ced->cve", gref, Jinv)     # (nc, d+1, d)
    return g, vol


class PlexDistribution:
    """The products of DMPlexDistribute (plexdistribute.c:1-60): ROADMAP
    queue 1 item 12."""

    def __init__(self, plex, cell_part, overlap=0):
        raise Error("PlexDistribution comes with ROADMAP queue 1 item 12 "
                    "(distribution over several cards)")


class PetscPartitioner:
    """PetscPartitioner (dm/partitioner): partition a DMPlex's cells.
    Types: 'simple' (contiguous chunks, partitioner impls/simple) and
    'bisection' (recursive graph bisection over the cell adjacency — the
    in-tree replacement for the metis bridge)."""

    def __init__(self, ptype="bisection"):
        self.ptype = ptype

    def setType(self, t):
        self.ptype = t
        return self

    def partition(self, plex, nparts):
        ncell = len(plex.cells)
        if self.ptype == "simple":
            sizes = np.full(nparts, ncell // nparts)
            sizes[: ncell % nparts] += 1
            return np.repeat(np.arange(nparts), sizes)
        # cell adjacency: cells sharing >= dim vertices (face neighbors)
        import scipy.sparse as sp
        nv = len(plex.coords)
        rows = np.repeat(np.arange(ncell), plex.cells.shape[1])
        cols = np.asarray(plex.cells).reshape(-1)
        C = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(ncell, nv))
        CC = (C @ C.T).tocsr()
        dim = plex.coords.shape[1]
        CC.data = (CC.data >= dim).astype(np.float64)
        CC.eliminate_zeros()
        CC.setdiag(0)
        CC.eliminate_zeros()
        from ..mat.partition import MatPartitioning
        from ..mat.aij import MatAIJ
        mp = MatPartitioning.create()
        mp.setAdjacency(MatAIJ.from_scipy(CC))
        mp.setNParts(nparts)
        mp.setType("rb")
        return np.asarray(mp.apply())
