"""Isosurface extraction and mesh utilities.

Replaces the reference's ``skimage.measure.marching_cubes_lewiner`` path
(``data_utils.py:2272-2333``) and the trimesh mesh-splitting cleanup
(``visualizer.py:930-944``), neither of which is available here, with a
vectorized numpy **marching tetrahedra** extractor: each cell splits into 6
tetrahedra, every sign-crossing tet emits 1-2 triangles with edge-
interpolated vertices, and triangle orientation is fixed robustly by
pointing each face normal away from its tet's inside corner — no 256-entry
case tables to transcribe, identical isosurface topology guarantees.

The port's copy of the JAX package's ``recon/isosurface.py``, with one
difference: nothing falls back. ``impl="native"`` (the default, and what
reconstruction asks for) builds and runs the streaming C++ extractor and
raises where it cannot be built; ``impl="numpy"`` is an explicit choice.
"""

from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of a unit cell (corner ids 0..7 with corner c
# at offset bits (z, y, x) = (c>>2 & 1, c>>1 & 1, c & 1)); every tet shares
# the main diagonal 0-7 so neighboring cells stitch consistently.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int32,
)

_CORNER_OFFSETS = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=np.int32
)  # (z, y, x) per corner

# Per-tet triangulation: for each of the 16 inside-masks, triangles as
# triples of local edges; edges index the 6 tet edge pairs below.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)
_CASES: dict[int, list[tuple[int, int, int]]] = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 3), (2, 4, 3)],
    0b0101: [(0, 2, 3), (3, 2, 5)],
    0b1001: [(0, 1, 4), (1, 5, 4)],
    0b0110: [(0, 4, 1), (1, 4, 5)],
    0b1010: [(0, 3, 2), (2, 3, 5)],
    0b1100: [(1, 2, 3), (3, 2, 4)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 5, 3)],
    0b1101: [(0, 4, 3)],
    0b1110: [(0, 2, 1)],
}
# Inside corner used to orient each case's triangles (any inside vertex).
_CASE_INSIDE = {m: int(np.flatnonzero([m >> i & 1 for i in range(4)])[0])
                for m in _CASES}


def marching_tetrahedra_native(
    volume: np.ndarray, level: float = 0.0, spacing=(1.0, 1.0, 1.0)
) -> tuple[np.ndarray, np.ndarray]:
    """C++ streaming extractor (``native/isosurface.cpp``): O(output)
    memory — required at the visualizer's default 512^3 resolution, where
    the vectorized numpy path would materialize tens of GB of per-cell
    corner tensors. Raises where the library cannot be built or the
    extractor fails."""
    import ctypes

    from point2cyl_torch import native

    lib = native.load("isosurface")
    lib.march_tets.restype = ctypes.c_int
    lib.march_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.p2c_free.restype = None
    lib.p2c_free.argtypes = [ctypes.c_void_p]
    vol = np.ascontiguousarray(volume, np.float32)
    if vol.ndim != 3:
        raise ValueError(f"marching tetrahedra needs a (D, H, W) volume, got {vol.shape}")
    d, h, w = vol.shape
    verts_ptr = ctypes.POINTER(ctypes.c_float)()
    faces_ptr = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.march_tets(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        d, h, w, ctypes.c_float(level),
        spacing[0], spacing[1], spacing[2],
        ctypes.byref(verts_ptr), ctypes.byref(nv),
        ctypes.byref(faces_ptr), ctypes.byref(nf),
    )
    try:
        if rc != 0:
            raise RuntimeError(f"native march_tets failed with status {rc}")
        verts = np.ctypeslib.as_array(verts_ptr, (nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(faces_ptr, (nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        lib.p2c_free(verts_ptr)
        lib.p2c_free(faces_ptr)
    return verts.astype(np.float32), faces.astype(np.int32)


def marching_tetrahedra(
    volume: np.ndarray,
    level: float = 0.0,
    spacing=(1.0, 1.0, 1.0),
    impl: str = "native",
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a (D, H, W) scalar volume.

    Returns (vertices (V, 3) in (z, y, x)*spacing coordinates — matching
    skimage's marching-cubes convention that the reference's PLY export
    unflips at ``data_utils.py:2300-2304`` — and faces (F, 3), consistently
    oriented with normals pointing toward higher values (outside)).

    ``impl``: "native", the streaming C++ extractor, or "numpy", the
    vectorized one (small volumes only). The two emit the same triangles
    in another vertex order.
    """
    if impl == "native":
        return marching_tetrahedra_native(volume, level, spacing)
    if impl != "numpy":
        raise ValueError(f"impl must be 'native' or 'numpy', got {impl!r}")
    volume = np.asarray(volume, np.float64)
    d, h, w = volume.shape
    if min(d, h, w) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Corner values/coords for every cell: (D-1, H-1, W-1, 8)
    base = np.stack(
        np.meshgrid(
            np.arange(d - 1), np.arange(h - 1), np.arange(w - 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 1, 3)  # (C, 1, 3)
    corners = base + _CORNER_OFFSETS[None, :, :]  # (C, 8, 3)
    vals = volume[
        corners[..., 0], corners[..., 1], corners[..., 2]
    ]  # (C, 8)

    # Skip cells with no crossing at all.
    inside8 = vals < level
    active = np.flatnonzero(inside8.any(1) & ~inside8.all(1))
    if active.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    corners = corners[active].astype(np.float64)
    vals = vals[active]

    tri_pts = []
    inside_pts = []
    # (C, 6, 4) tet corner values / coords
    tvals = vals[:, _TETS]  # (C, 6, 4)
    tcoords = corners[:, _TETS]  # (C, 6, 4, 3)
    tvals = tvals.reshape(-1, 4)
    tcoords = tcoords.reshape(-1, 4, 3)
    mask = (tvals < level).astype(np.int32)
    case_id = mask @ np.array([1, 2, 4, 8])

    for cid, tris in _CASES.items():
        sel = np.flatnonzero(case_id == cid)
        if sel.size == 0:
            continue
        v = tvals[sel]  # (S, 4)
        p = tcoords[sel]  # (S, 4, 3)
        # interpolated point on each of the 6 tet edges
        a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        va, vb = v[:, a], v[:, b]  # (S, 6)
        denom = vb - va
        safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
        t = np.where(np.abs(denom) > 1e-12, (level - va) / safe, 0.5)
        t = np.clip(t, 0.0, 1.0)
        epts = p[:, a] + t[..., None] * (p[:, b] - p[:, a])  # (S, 6, 3)
        inside_corner = p[:, _CASE_INSIDE[cid]]  # (S, 3)
        for tri in tris:
            tri_pts.append(epts[:, list(tri)])  # (S, 3, 3)
            inside_pts.append(inside_corner)

    tris = np.concatenate(tri_pts, axis=0)  # (T, 3, 3)
    inside = np.concatenate(inside_pts, axis=0)  # (T, 3)
    # Orient: normal must point AWAY from the inside (lower-value) corner.
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    centroid = tris.mean(axis=1)
    flip = np.einsum("td,td->t", n, centroid - inside) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]

    # Drop degenerate (zero-area) triangles, then weld duplicate vertices.
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    keep = np.einsum("td,td->t", n, n) > 1e-24
    tris = tris[keep]
    flat = tris.reshape(-1, 3)
    quant = np.round(flat * 1e7).astype(np.int64)
    _, idx, inv = np.unique(
        quant, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # weld can re-degenerate a face
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    verts = verts * np.asarray(spacing, np.float64)
    return verts.astype(np.float32), faces


def convert_sdf_samples_to_ply(
    sdf_volume: np.ndarray,
    voxel_grid_origin,
    voxel_size: float,
    ply_path: str,
    offset=None,
    scale=None,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """API twin of ``data_utils.py:2272-2333``: isosurface the SDF volume
    (the native extractor), unflip (z, y, x) -> (x, y, z), shift by the
    grid origin, optionally rescale, write PLY. Returns (vertices,
    faces)."""
    verts, faces = marching_tetrahedra(
        sdf_volume, level=level, spacing=(voxel_size,) * 3
    )
    mesh_points = np.empty_like(verts)
    mesh_points[:, 0] = voxel_grid_origin[0] + verts[:, 2]
    mesh_points[:, 1] = voxel_grid_origin[1] + verts[:, 1]
    mesh_points[:, 2] = voxel_grid_origin[2] + verts[:, 0]
    if scale is not None:
        mesh_points = mesh_points / scale
    if offset is not None:
        mesh_points = mesh_points - offset
    from point2cyl_torch.recon.ply import write_ply

    write_ply(ply_path, mesh_points, faces)
    return mesh_points, faces


def mesh_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """Signed volume via the divergence theorem (replaces trimesh.volume)."""
    v = verts[faces]  # (F, 3, 3)
    return float(
        np.abs(np.einsum("fi,fi->f", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum())
        / 6.0
    )


def split_components(
    verts: np.ndarray, faces: np.ndarray
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Split a mesh into vertex-connected components (replaces
    trimesh ``mesh.split()`` in the cut-op cleanup, visualizer.py:932)."""
    parent = np.arange(len(verts))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for f in faces:
        a = find(f[0])
        for v in (f[1], f[2]):
            b = find(v)
            if a != b:
                parent[b] = a
    roots = np.array([find(v) for v in range(len(verts))])
    comps = []
    for root in np.unique(roots[faces[:, 0]]):
        fsel = faces[roots[faces[:, 0]] == root]
        used = np.unique(fsel)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        comps.append((verts[used], remap[fsel].astype(np.int32)))
    return comps


def drop_small_components(
    verts: np.ndarray, faces: np.ndarray, volume_thresh: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Keep components with volume above ``volume_thresh`` x total volume
    (the cut-op artifact cleanup, ``visualizer.py:930-944``)."""
    total = mesh_volume(verts, faces)
    kept_v, kept_f = [], []
    offset = 0
    for cv, cf in split_components(verts, faces):
        if mesh_volume(cv, cf) > total * volume_thresh:
            kept_v.append(cv)
            kept_f.append(cf + offset)
            offset += len(cv)
    if not kept_v:
        return verts, faces
    return (
        np.concatenate(kept_v, axis=0),
        np.concatenate(kept_f, axis=0),
    )
