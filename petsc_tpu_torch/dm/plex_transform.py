"""DMPlexTransform — the mesh-transform family and label/metric-driven
adaptation (reference: src/dm/impls/plex/transform/interface/
plextransform.c, transform/impls/*, plexadapt.c).

The reference organizes mesh surgery as "transforms": a source plex plus
a per-cell production rule yields a new plex (regular refinement,
barycentric/Alfeld splits, simplex<->box conversions, extrusion,
filtering, and adaptive refinement driven by a DMLabel or a Riemannian
metric).  This module is the port's copy of ``petsc_tpu/dm/plex_transform.py``
(the same numbering, so the same meshes): mesh surgery is
HOST setup code (numpy, integer maps) that runs once, exactly like
`DMPlex.refine`; everything it produces (cells, coords, the recorded
coarse-to-fine interpolation) then feeds the device assembly/solve
paths unchanged.

Implemented transform types vs the reference inventory
(src/dm/impls/plex/transform/impls/):

  regular    -> DMPlex.refine (plex.py; refine/regular/plexrefregular.c)
  alfeld     -> alfeld_split: tri->3 / tet->4 barycentric
                (refine/alfeld/plexrefalfeld.c)
  tobox      -> to_box: tri->3 quads / tet->4 hexes
                (refine/tobox/plexreftobox.c)
  tosimplex  -> to_simplex: quad->2 tris / hex->6 tets
                (refine/tosimplex/plexreftosimplex.c)
  1d         -> refine_1d: segment bisection (refine/1d/plexref1d.c)
  sbr        -> adapt_label: conforming adaptive refinement of marked
                cells (refine/sbr/plexrefsbr.c role — the skeleton-
                based adaptor): red-green for triangles, global-order
                marked-edge bisection with Rivara closure for tets
  extrude    -> DMPlex.extrude (plex.py; extrude/plextrextrude.c)
  filter     -> DMPlex.createSubmesh (plex.py; filter/plextrfilter.c)
  bl         -> deferred: boundary-layer tensor refinement targets
                extruded prism stacks; the extrude+refine composition
                covers the use case at lowest order.

DMAdaptLabel / DMAdaptMetric (plexadapt.c) are `adapt_label` /
`adapt_metric`.  The reference's metric adaptation delegates remeshing
to external packages (pragmatic/mmg/parmmg — plexadapt.c routes to
DMAdaptMetric_Pragmatic_Plex etc.); those bridges are out of scope by
SURVEY plan, so `adapt_metric` implements the in-tree fallback the same
way DMAdaptLabel does: iterative conforming refinement until every edge
is short enough in the metric (refinement-only — no coarsening/node
motion, documented).
"""

import numpy as np

from ..sys.error import Error


# ---------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------

_EDGE_LOCAL = {3: [(0, 1), (1, 2), (2, 0)],
               4: [(0, 1), (1, 2), (2, 3), (3, 0)]}
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TET_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


class _NewVerts:
    """Midpoint/centroid vertex factory: one id per sorted parent-vertex
    key, plus the coordinate (parent average) and the interpolation row
    (uniform weights) for the recorded coarse-to-fine P1 transfer."""

    def __init__(self, coords):
        self.coords = coords
        self.nv = len(coords)
        self.key2id = {}

    def vid(self, *verts):
        if len(verts) == 1:
            return int(verts[0])
        key = tuple(sorted(int(v) for v in verts))
        if key not in self.key2id:
            self.key2id[key] = self.nv + len(self.key2id)
        return self.key2id[key]

    def finish(self):
        """Returns (all_coords, interp csr (nv_new, nv_old))."""
        import scipy.sparse as sp
        nnew = len(self.key2id)
        out = np.zeros((self.nv + nnew, self.coords.shape[1]))
        out[: self.nv] = self.coords
        rows = list(range(self.nv))
        cols = list(range(self.nv))
        vals = [1.0] * self.nv
        for key, idx in self.key2id.items():
            out[idx] = self.coords[list(key)].mean(axis=0)
            w = 1.0 / len(key)
            for pv in key:
                rows.append(idx)
                cols.append(pv)
                vals.append(w)
        return out, sp.csr_matrix((vals, (rows, cols)),
                                  shape=(self.nv + nnew, self.nv))


def _child_plex(plex, newcells, nverts, child_of, dim=None):
    """Assemble the transformed plex: inherit labels through the
    parent-cell map `child_of` (len == n new cells), record the parent
    and the P1/Q1 interpolation so PCMG/createInterpolation work on the
    result exactly as on DMPlex.refine output."""
    from .plex import DMPlex
    coords, interp = nverts.finish()
    out = DMPlex.createFromCellList(
        plex.dim if dim is None else dim,
        np.asarray(newcells, dtype=np.int64), coords, plex.comm)
    child_of = np.asarray(child_of, dtype=np.int64)
    if getattr(plex, "labels", None):
        out.labels = {}
        for name, ids in plex.labels.items():
            mask = np.zeros(plex.ncells, dtype=bool)
            mask[np.asarray(ids, dtype=np.int64)] = True
            out.labels[name] = np.nonzero(mask[child_of])[0]
    out._coarse_plex = plex
    out._interp = interp
    out.parent_cells = child_of
    return out


# ---------------------------------------------------------------------
# alfeld — barycentric split (refine/alfeld/plexrefalfeld.c)
# ---------------------------------------------------------------------

def alfeld_split(plex):
    """Barycentric (Alfeld) split: each triangle -> 3 triangles, each
    tetrahedron -> 4 tets, through the cell centroid.  No new boundary
    vertices, so the trace mesh is unchanged — the split used to make
    Scott-Vogelius pairs inf-sup stable (the reference cites the same
    use, plexrefalfeld.c)."""
    cells = plex.cells
    nvl = cells.shape[1]
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []
    if plex.dim == 2 and nvl == 3:
        for ci, (a, b, c) in enumerate(cells):
            z = nv.vid(a, b, c)
            newcells += [[a, b, z], [b, c, z], [c, a, z]]
            child_of += [ci] * 3
    elif plex.dim == 3 and nvl == 4:
        for ci, cell in enumerate(cells):
            z = nv.vid(*cell)
            # child per face, apex at the centroid; face order/verts
            # chosen so each child keeps the parent's orientation sign
            v0, v1, v2, v3 = (int(v) for v in cell)
            newcells += [[v0, v1, v2, z], [v0, v3, v1, z],
                         [v0, v2, v3, z], [v1, v3, v2, z]]
            child_of += [ci] * 4
    else:
        raise Error(f"alfeld_split: simplex meshes only "
                    f"(dim={plex.dim}, nv={nvl})")
    return _child_plex(plex, newcells, nv, child_of)


# ---------------------------------------------------------------------
# tobox — simplex -> tensor cells (refine/tobox/plexreftobox.c)
# ---------------------------------------------------------------------

def to_box(plex):
    """Split every triangle into 3 quads (tet into 4 hexes) around the
    centroid: vertex corner + two edge midpoints + centroid (3-D adds
    three face centroids).  The output is a conforming all-quad/all-hex
    mesh — the reference's route to tensor-product elements on simplex
    geometries."""
    cells = plex.cells
    nvl = cells.shape[1]
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []
    if plex.dim == 2 and nvl == 3:
        for ci, (a, b, c) in enumerate(cells):
            z = nv.vid(a, b, c)
            mab, mbc, mca = nv.vid(a, b), nv.vid(b, c), nv.vid(c, a)
            # ccw quads (plex corner order 00,10,11,01)
            newcells += [[a, mab, z, mca],
                         [b, mbc, z, mab],
                         [c, mca, z, mbc]]
            child_of += [ci] * 3
    elif plex.dim == 3 and nvl == 4:
        for ci, cell in enumerate(cells):
            v = [int(x) for x in cell]
            z = nv.vid(*v)
            for k in range(4):
                a = v[k]
                others = [v[j] for j in range(4) if j != k]
                b, c, d = others
                # hex corner order (0,0,0),(1,0,0),(1,1,0),(0,1,0),
                # (0,0,1),(1,0,1),(1,1,1),(0,1,1); axes a->b, a->c, a->d
                newcells.append([
                    a, nv.vid(a, b), nv.vid(a, b, c), nv.vid(a, c),
                    nv.vid(a, d), nv.vid(a, b, d), z, nv.vid(a, c, d)])
            child_of += [ci] * 4
    else:
        raise Error(f"to_box: simplex meshes only (dim={plex.dim}, "
                    f"nv={nvl})")
    return _child_plex(plex, newcells, nv, child_of)


# ---------------------------------------------------------------------
# tosimplex — tensor -> simplex cells (refine/tosimplex/plexreftosimplex.c)
# ---------------------------------------------------------------------

def to_simplex(plex):
    """Split quads into 2 triangles (hexes into 6 tets).  Quad diagonals
    run through the globally smallest vertex of the cell, so the two
    cells sharing a face always pick the same diagonal — conforming on
    arbitrary quad meshes.  Hexes use the Kuhn 6-tet template around the
    local 0-6 diagonal (the same template createBoxMesh uses); that is
    conforming for logically-aligned hex meshes (every structured grid),
    the same contract as the reference's fixed production template."""
    cells = plex.cells
    nvl = cells.shape[1]
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []
    if plex.dim == 2 and nvl == 4:
        for ci, q in enumerate(cells):
            q = [int(x) for x in q]
            r = int(np.argmin(q))              # rotate: min vertex leads
            a, b, c, d = (q[(r + i) % 4] for i in range(4))
            newcells += [[a, b, c], [a, c, d]]
            child_of += [ci] * 2
    elif plex.dim == 3 and nvl == 8:
        kuhn = [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]]
        for ci, h in enumerate(cells):
            h = [int(x) for x in h]
            for t in kuhn:
                newcells.append([h[j] for j in t])
            child_of += [ci] * 6
    else:
        raise Error(f"to_simplex: tensor meshes only (dim={plex.dim}, "
                    f"nv={nvl})")
    return _child_plex(plex, newcells, nv, child_of)


# ---------------------------------------------------------------------
# 1d — segment bisection (refine/1d/plexref1d.c)
# ---------------------------------------------------------------------

def refine_1d(plex):
    """Bisect every segment of a 1-D plex."""
    if plex.dim != 1 or plex.cells.shape[1] != 2:
        raise Error("refine_1d: 1-D segment meshes only")
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []
    for ci, (a, b) in enumerate(plex.cells):
        m = nv.vid(a, b)
        newcells += [[a, m], [m, b]]
        child_of += [ci] * 2
    return _child_plex(plex, newcells, nv, child_of)


# ---------------------------------------------------------------------
# sbr / DMAdaptLabel — conforming adaptive refinement
# ---------------------------------------------------------------------

# DMAdaptFlag values (petscdm.h DM_ADAPT_*): labels carrying these mark
# what to do with each cell; only REFINE triggers refinement here
# (coarsening lives in external remeshers the reference bridges to).
DM_ADAPT_KEEP = 0
DM_ADAPT_REFINE = 1
DM_ADAPT_COARSEN = 2


def adapt_label(plex, marked, value=None):
    """DMAdaptLabel (plexadapt.c) / the SBR transform role
    (refine/sbr/plexrefsbr.c): conforming refinement of the cells in
    `marked` (a DMLabel, or an array of cell ids).

    When `marked` is a DMLabel, `value` selects the stratum to refine:
    None (default) refines cells from every stratum EXCEPT those
    labeled DM_ADAPT_KEEP or DM_ADAPT_COARSEN (the reference's
    DMAdaptLabel only refines DM_ADAPT_REFINE-flagged cells —
    plexadapt.c); pass an explicit value to refine just that stratum.

    Triangles use red-green refinement: marked cells split regularly
    into 4 (all three edges bisected); edge splits propagate, any cell
    with >= 2 split edges is promoted to red (so only 0- or 1-split
    cells remain after the fixed point), and 1-split cells close with a
    green bisection (opposite vertex to the midpoint).  The result has
    no hanging nodes, every marked cell has 4 regular children, and the
    recorded interpolation/parent maps drive PCMG exactly like uniform
    refinement.

    Tetrahedra use marked-edge bisection in a single GLOBAL edge order
    (the Plaza-Carey/SBR idea, plexrefsbr.c): the split set starts from
    each marked tet's longest edge, closes under Rivara longest-edge
    propagation (any tet owning a split edge also splits its own
    longest edge — the quality guard; terminates because propagation
    only moves to strictly longer edges), and every tet is then
    recursively bisected by its split edges processed in one global
    deterministic order (length desc, vertex-id tiebreak).  Two tets
    sharing a face apply the same order to the face's split edges, so
    the induced face triangulations agree — the mesh is conforming by
    construction (asserted by the face-count test).
    """
    from .label import DMLabel
    if isinstance(marked, DMLabel):
        if value is not None:
            vals = [v for v in marked.getValueIS() if v == value]
        else:
            vals = [v for v in marked.getValueIS()
                    if v not in (DM_ADAPT_KEEP, DM_ADAPT_COARSEN)]
        ids = np.unique(np.concatenate(
            [np.asarray(marked.getStratumIS(v), dtype=np.int64)
             for v in vals] or
            [np.zeros(0, dtype=np.int64)]))
    else:
        ids = np.unique(np.asarray(marked, dtype=np.int64))
    cells = plex.cells
    if plex.dim == 3 and cells.shape[1] == 4:
        return _adapt_tets(plex, ids)
    if plex.dim != 2 or cells.shape[1] != 3:
        raise Error("adapt_label: simplex meshes only "
                    f"(dim={plex.dim}, nv={cells.shape[1]})")
    nc = len(cells)
    red = np.zeros(nc, dtype=bool)
    red[ids] = True
    ekey = lambda a, b: (min(int(a), int(b)), max(int(a), int(b)))
    # fixed point: red cells split all edges; >=2 split edges -> red
    split = set()
    while True:
        for ci in np.nonzero(red)[0]:
            a, b, c = cells[ci]
            split.update((ekey(a, b), ekey(b, c), ekey(c, a)))
        promoted = False
        for ci in np.nonzero(~red)[0]:
            a, b, c = cells[ci]
            k = sum(e in split for e in
                    (ekey(a, b), ekey(b, c), ekey(c, a)))
            if k >= 2:
                red[ci] = True
                promoted = True
        if not promoted:
            break
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []
    for ci, (a, b, c) in enumerate(cells):
        a, b, c = int(a), int(b), int(c)
        if red[ci]:
            mab, mbc, mca = nv.vid(a, b), nv.vid(b, c), nv.vid(c, a)
            newcells += [[a, mab, mca], [mab, b, mbc],
                         [mca, mbc, c], [mab, mbc, mca]]
            child_of += [ci] * 4
            continue
        onsplit = [(ekey(a, b) in split, (a, b, c)),
                   (ekey(b, c) in split, (b, c, a)),
                   (ekey(c, a) in split, (c, a, b))]
        hits = [t for s, t in onsplit if s]
        if not hits:
            newcells.append([a, b, c])
            child_of.append(ci)
            continue
        # exactly one split edge (>=2 was promoted): green bisection
        p, q, r = hits[0]                  # split edge (p, q), apex r
        m = nv.vid(p, q)
        newcells += [[p, m, r], [m, q, r]]
        child_of += [ci] * 2
    return _child_plex(plex, newcells, nv, child_of)


def _adapt_tets(plex, ids):
    """Conforming adaptive bisection of marked tetrahedra (see
    adapt_label docstring for the algorithm and the conformity
    argument)."""
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = plex.coords
    nc = len(cells)
    ekey = lambda a, b: (min(int(a), int(b)), max(int(a), int(b)))

    def edge_len2(e):
        d = coords[e[0]] - coords[e[1]]
        return float(np.dot(d, d))

    # global deterministic edge order: longer first, vertex-id tiebreak
    def rank(e):
        return (-edge_len2(e), e)

    cell_edges = [[ekey(cells[c, a], cells[c, b]) for a, b in _TET_EDGES]
                  for c in range(nc)]
    longest = [min(es, key=rank) for es in cell_edges]
    split = {longest[c] for c in ids}
    # Rivara closure: a tet owning any split edge splits its longest
    # edge too (moves strictly up the global order -> terminates)
    changed = True
    while changed:
        changed = False
        for c in range(nc):
            if longest[c] not in split \
                    and any(e in split for e in cell_edges[c]):
                split.add(longest[c])
                changed = True
    nv = _NewVerts(plex.coords)
    newcells, child_of = [], []

    def bisect(tet, es, ci):
        """Recursively bisect `tet` by its split edges `es`, processed
        in the global order."""
        if not es:
            newcells.append(list(tet))
            child_of.append(ci)
            return
        e = min(es, key=rank)
        p, q = e
        m = nv.vid(p, q)
        for drop, add in ((q, m), (p, m)):
            child = tuple(add if v == drop else v for v in tet)
            ces = [ee for ee in es if ee != e
                   and ee[0] in child and ee[1] in child]
            bisect(child, ces, ci)

    for c in range(nc):
        es = [e for e in cell_edges[c] if e in split]
        bisect(tuple(int(v) for v in cells[c]), es, c)
    return _child_plex(plex, newcells, nv, child_of)


def adapt_metric(plex, metric, max_passes=6):
    """DMAdaptMetric role (plexadapt.c / plexmetric.c): refine until
    every edge has metric length <= sqrt(2) (the standard L_M in
    [1/sqrt(2), sqrt(2)] unit-mesh band — plexmetric.c's a_max).

    `metric` is per-vertex: scalar target edge length h(v) (isotropic),
    an (nv,) array, or an (nv, d, d) SPD tensor field M(v) with
    L_M(e)^2 = e^T M e (anisotropic).  Refinement-only in-tree fallback:
    the reference's full metric adaptation (node motion, coarsening,
    swaps) lives in external remeshers it bridges to (pragmatic/mmg),
    which SURVEY scopes out.  Each pass marks every cell owning a long
    edge and calls adapt_label, so the result is conforming at every
    intermediate step.  Returns the adapted plex (chain of parents
    recorded per pass)."""
    def _long_cells(out):
        cells = out.cells
        coords = out.coords
        nvert = len(coords)
        m = metric
        if np.isscalar(m):
            minv = np.full(nvert, 1.0 / float(m) ** 2)
        else:
            m = np.asarray(m, dtype=np.float64)
            if m.ndim == 1:
                if len(m) != nvert:
                    # metric given on the ORIGINAL mesh: evaluate by
                    # nearest original vertex (refined verts average)
                    m = _transfer_vertex_field(plex, out, m)
                minv = 1.0 / m ** 2
            else:
                if m.shape[0] != nvert:
                    m = _transfer_vertex_field(plex, out, m)
                minv = m                                  # tensor
        long_cells = set()
        pairs = _TET_EDGES if (out.dim == 3 and cells.shape[1] == 4) \
            else _EDGE_LOCAL[cells.shape[1]]
        for (la, lb) in pairs:
            va, vb = cells[:, la], cells[:, lb]
            e = coords[vb] - coords[va]
            if np.ndim(minv) == 1:
                l2 = ((minv[va] + minv[vb]) / 2) * (e ** 2).sum(axis=1)
            else:
                Mavg = (minv[va] + minv[vb]) / 2
                l2 = np.einsum("cd,cde,ce->c", e, Mavg, e)
            long_cells.update(np.nonzero(l2 > 2.0)[0].tolist())
        return long_cells

    out = plex
    long_cells = _long_cells(out)
    for _ in range(max_passes):
        if not long_cells:
            break
        out = adapt_label(out, np.asarray(sorted(long_cells)))
        long_cells = _long_cells(out)   # re-measure AFTER the pass, so
        # a mesh resolved on the final allowed pass reads as converged
    if long_cells:
        # pass limit exhausted with long edges still present: callers can
        # distinguish converged from truncated adaptation
        import warnings
        warnings.warn("adapt_metric: max_passes reached with edges still "
                      "above the unit-mesh band", stacklevel=2)
    out.metric_converged = not long_cells
    return out


def _transfer_vertex_field(src, dst, field):
    """Carry a per-vertex field through the recorded refinement chain
    (each new vertex averages its defining parents — the same weights
    as the recorded interpolation)."""
    chain = []
    p = dst
    while p is not src and getattr(p, "_coarse_plex", None) is not None:
        chain.append(p)
        p = p._coarse_plex
    out = np.asarray(field, dtype=np.float64)
    for plx in reversed(chain):
        I = plx._interp
        if out.ndim == 1:
            out = I @ out
        else:
            flat = out.reshape(len(out), -1)
            out = (I @ flat).reshape((I.shape[0],) + out.shape[1:])
    return out


# ---------------------------------------------------------------------
# the transform object (DMPlexTransformCreate/SetType/Apply)
# ---------------------------------------------------------------------

class PlexTransform:
    """DMPlexTransform object API (plextransform.c): create, set a type
    from the reference's registry names, apply to a plex.  `options`
    carry the per-type inputs (marked label, extrude layers, filter
    cell set)."""

    TYPES = ("refine_regular", "refine_alfeld", "refine_tobox",
             "refine_tosimplex", "refine_1d", "refine_sbr",
             "extrude", "transform_filter")

    def __init__(self, ttype="refine_regular", **options):
        self.setType(ttype)
        self.options = options

    def setType(self, t):
        if t not in self.TYPES:
            raise Error(f"PlexTransform type '{t}' (known: {self.TYPES})")
        self.ttype = t
        return self

    def getType(self):
        return self.ttype

    def apply(self, plex):
        t = self.ttype
        if t == "refine_regular":
            return plex.refine()
        if t == "refine_alfeld":
            return alfeld_split(plex)
        if t == "refine_tobox":
            return to_box(plex)
        if t == "refine_tosimplex":
            return to_simplex(plex)
        if t == "refine_1d":
            return refine_1d(plex)
        if t == "refine_sbr":
            return adapt_label(plex, self.options.get("active",
                                                      np.zeros(0)))
        if t == "extrude":
            return plex.extrude(self.options.get("layers", 1),
                                self.options.get("height", 1.0))
        if t == "transform_filter":
            return plex.createSubmesh(self.options["cells"])
        raise Error(t)
