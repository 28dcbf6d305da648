"""Isosurface extraction: vectorized marching tetrahedra (numpy).

The port's copy of the JAX package's ``fusion/mesher.py`` (numpy only;
the port keeps its own copy so that it imports nothing of that package).
Mesh export for the TSDF volume and the NeRF density: NeRF-SLAM extracts
meshes from its voxel grid with a weight threshold through Open3D.
Marching tetrahedra splits each cube into 6 tets; each tet has only 3
nontrivial sign-pattern classes, so no 256-entry tables are needed and
the whole extraction vectorizes over the grid.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# 6-tetrahedra Kuhn decomposition of the unit cube (corner indices 0..7
# with corner c at bit-coded coords ((c>>2)&1, (c>>1)&1, c&1)); all tets
# share the main diagonal 0-7, which tiles space consistently
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int64)

_CORNER_OFFSETS = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)],
    dtype=np.int64)

# tet edges as corner-index pairs (local 0..3)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# triangulation per sign case (bit i set = vertex i inside).  Each entry
# lists triangles as triples of tet-edge indices; -1 padding.
_CASES = -np.ones((16, 2, 3), dtype=np.int64)


def _set_case(mask, tris):
    _CASES[mask, : len(tris)] = np.asarray(tris, dtype=np.int64)


# single vertex inside: one triangle on the three edges from that vertex
_set_case(0b0001, [[0, 1, 2]])
_set_case(0b0010, [[0, 4, 3]])
_set_case(0b0100, [[1, 3, 5]])
_set_case(0b1000, [[2, 5, 4]])
# single vertex outside (complement): same edges, flipped orientation
_set_case(0b1110, [[0, 2, 1]])
_set_case(0b1101, [[0, 3, 4]])
_set_case(0b1011, [[1, 5, 3]])
_set_case(0b0111, [[2, 4, 5]])
# two inside / two outside: quad -> two triangles
_set_case(0b0011, [[1, 2, 4], [1, 4, 3]])
_set_case(0b1100, [[1, 4, 2], [1, 3, 4]])
_set_case(0b0101, [[0, 3, 5], [0, 5, 2]])
_set_case(0b1010, [[0, 5, 3], [0, 2, 5]])
_set_case(0b0110, [[0, 4, 5], [0, 5, 1]])
_set_case(0b1001, [[0, 5, 4], [0, 1, 5]])


def marching_tetrahedra(sdf: np.ndarray, mask: Optional[np.ndarray] = None,
                        origin=(0.0, 0.0, 0.0), voxel_size: float = 1.0,
                        level: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a dense scalar field.

    sdf: (X, Y, Z) values; mask: optional validity (invalid cells are
    skipped).  Returns (vertices (V, 3), faces (F, 3)).  Vertices are
    NOT deduplicated (each triangle owns its corners) -- fine for export
    and rendering; weld later if needed.
    """
    f = np.asarray(sdf, np.float64) - level
    X, Y, Z = f.shape
    if mask is None:
        mask = np.ones_like(f, bool)

    # cell corner values: (X-1, Y-1, Z-1, 8)
    cv = np.empty((X - 1, Y - 1, Z - 1, 8), np.float64)
    ok = np.ones((X - 1, Y - 1, Z - 1), bool)
    for c, (dx, dy, dz) in enumerate(_CORNER_OFFSETS):
        cv[..., c] = f[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        ok &= mask[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    # candidate cells: sign change somewhere + valid
    inside_any = (cv < 0).any(-1)
    outside_any = (cv >= 0).any(-1)
    cells = np.argwhere(ok & inside_any & outside_any)
    if cells.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    cell_vals = cv[cells[:, 0], cells[:, 1], cells[:, 2]]   # (C, 8)
    base = cells.astype(np.float64)                          # (C, 3)

    verts_out = []
    for tet in _TETS:
        tv = cell_vals[:, tet]                               # (C, 4)
        tpos = base[:, None, :] + _CORNER_OFFSETS[tet][None]  # (C,4,3)
        case = ((tv < 0) << np.arange(4)).sum(-1)            # (C,)
        tris = _CASES[case]                                  # (C, 2, 3)
        has = tris[:, :, 0] >= 0                             # (C, 2)
        ci, ti = np.nonzero(has)
        if ci.size == 0:
            continue
        edges = tris[ci, ti]                                 # (M, 3) edge ids
        ea = _TET_EDGES[edges][..., 0]                       # (M, 3)
        eb = _TET_EDGES[edges][..., 1]
        va = tv[ci[:, None], ea]                             # (M, 3)
        vb = tv[ci[:, None], eb]
        den = va - vb
        den = np.where(np.abs(den) < 1e-12,
                       np.where(den < 0, -1e-12, 1e-12), den)
        t = np.clip(va / den, 0.0, 1.0)
        pa = tpos[ci[:, None], ea]                           # (M, 3, 3)
        pb = tpos[ci[:, None], eb]
        p = pa + t[..., None] * (pb - pa)                    # (M, 3, 3)
        verts_out.append(p.reshape(-1, 3))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_out)
    verts = np.asarray(origin) + verts * voxel_size
    faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    with open(path, "w") as fh:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                fh.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f} "
                         f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}\n")
            else:
                fh.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for f in faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")
