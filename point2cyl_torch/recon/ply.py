"""Minimal PLY mesh I/O (replaces the reference's plyfile dependency,
``data_utils.py:2299-2331``): the port's copy of the JAX package's
``recon/ply.py``, byte for byte in what it writes."""

from __future__ import annotations

import numpy as np


def write_ply(
    path: str, vertices: np.ndarray, faces: np.ndarray, binary: bool = True
) -> None:
    """Write a triangle mesh. vertices (V, 3) float; faces (F, 3) int."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(vertices.astype("<f4").tobytes())
            face_block = np.empty(
                len(faces),
                dtype=[("n", "u1"), ("idx", "<i4", (3,))],
            )
            face_block["n"] = 3
            face_block["idx"] = faces
            f.write(face_block.tobytes())
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a PLY written by ``write_ply`` (both formats)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    nv = nf = 0
    binary = False
    for line in header:
        if line.startswith("format binary"):
            binary = True
        elif line.startswith("element vertex"):
            nv = int(line.split()[-1])
        elif line.startswith("element face"):
            nf = int(line.split()[-1])
    if binary:
        verts = np.frombuffer(
            data, dtype="<f4", count=nv * 3, offset=end
        ).reshape(nv, 3)
        face_block = np.frombuffer(
            data,
            dtype=[("n", "u1"), ("idx", "<i4", (3,))],
            count=nf,
            offset=end + nv * 12,
        )
        faces = face_block["idx"].copy()
    else:
        lines = data[end:].decode().split("\n")
        verts = np.array(
            [list(map(float, ln.split())) for ln in lines[:nv]], np.float32
        )
        faces = np.array(
            [list(map(int, ln.split()))[1:4] for ln in lines[nv : nv + nf]],
            np.int32,
        )
    return verts.astype(np.float32), faces
