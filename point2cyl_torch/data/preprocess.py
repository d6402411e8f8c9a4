"""Offline preprocessing: Autodesk Fusion 360 Gallery JSON/OBJ -> packed h5
(the port of the JAX ``data/preprocess.py``).

    python -m point2cyl_torch.data.preprocess --raw_dir <dir> --out train.h5

Capability twin of the reference's offline pipeline (``utils.py:16-951``,
status "offline" in SURVEY.md C31 — its entry-point scripts don't ship with the
reference). Pure numpy; the trimesh graph/sampling/proximity dependencies
are replaced by ``data.meshutil``. Stages:

1. JSON sequence parsing: ordered extrude OBJs/entities
   (``utils.py:18-40``), per-entity axis/distance/operation with taper and
   two-extent filtering (``utils.py:46-90``).
2. Face-group -> extrusion-id mapping with split-face recovery
   (``utils.py:95-315``).
3. OBJ loading with `g`-group parsing (``utils.py:669-758``).
4. Sanity checks: non-increasing group areas, group-count deltas, normals
   consistency (``utils.py:318-375``).
5. Base/barrel labeling by |normal . axis| (``utils.py:377-418``),
   per-point operation labels (``utils.py:421-434``).
6. Multi-loop relabeling via barrel face-adjacency connected components,
   with base reassignment to the furthest-barrel loop in donut cases
   (``utils.py:450-656``).
7. Surface sampling, per-instance centers/extents, center + unit-sphere
   normalization (``utils.py:798-950``).
8. Sketch extraction per instance (projection to the sketch plane,
   centered, max-norm normalized) for the `_sk` datasets.

Every stage is numpy, as in JAX, but the sketch plane's rotation
(``ops/geometry.py:rotation_to_z``, float32 on ``device``). The random
draws come from numpy's ``default_rng(seed)``, so every array equals
JAX's but the sketches, which differ only through that float32
rotation. The pack is written without h5py (``data/h5_writer.py``),
uncompressed.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

import torch

from point2cyl_torch.core.config import EXTRUSION_OPERATIONS, ZERO_TOL
from point2cyl_torch.core.device import resolve_device
from point2cyl_torch.data import meshutil
from point2cyl_torch.data.h5_io import PackedDataset, save_h5
from point2cyl_torch.ops.geometry import rotation_to_z


# ------------------------- JSON parsing -------------------------


def collect_objs(json_sequence: list) -> tuple[list, list]:
    """Ordered extrude OBJ files + entity ids (``utils.py:30-40``)."""
    objs, entities = [], []
    for entry in json_sequence:
        if "obj" in entry:
            if entry.get("type") != "ExtrudeFeature":
                raise ValueError("non-extrude obj entry in sequence")
            objs.append(entry["obj"])
            entities.append(entry["entity"])
    return objs, entities


def parse_files(root_dir: str, model_id: str):
    with open(os.path.join(root_dir, model_id + ".json")) as f:
        data = json.load(f)
    objs, entities = collect_objs(data["sequence"])
    return objs, entities, data["sequence"], data["timeline"], data["entities"]


def _axis_from_sketch(sketch_entity: dict) -> np.ndarray:
    n = sketch_entity["reference_plane"]["plane"]["normal"]
    axis = np.array([float(n["x"]), float(n["y"]), float(n["z"])])
    norm = np.linalg.norm(axis)
    if abs(1.0 - norm) > ZERO_TOL:
        axis = axis / norm
    return axis


def get_extrude_infos(
    ordered_entities: list,
    json_entities: dict,
    filter_two_extents: bool = False,
    filter_tapered: bool = True,
) -> Optional[dict]:
    """Per-entity {distance, axis, operation, face groups}
    (``utils.py:46-90``); None when a filter rejects the model."""
    info = {}
    for entity in ordered_entities:
        e = json_entities[entity]
        if filter_two_extents and "extent_two" in e:
            return None
        if filter_tapered:
            if e["extent_one"]["taper_angle"]["value"] > ZERO_TOL:
                return None
            if (
                "extent_two" in e
                and e["extent_two"]["taper_angle"]["value"] > ZERO_TOL
            ):
                return None
        sketch = e["profiles"][0]["sketch"]
        info[entity] = {
            "distance": e["extent_one"]["distance"]["value"],
            "axis": _axis_from_sketch(json_entities[sketch]),
            "operation": e["operation"],
            "all_faces": e["extrude_faces"],
            "side_faces": e.get("extrude_side_faces", []),
            "start_faces": e.get("extrude_start_faces", []),
            "end_faces": e.get("extrude_end_faces", []),
        }
    return info


def face_groups_to_extrusion_id(ordered_entities: list, json_entities: dict):
    """Map face-group ids to the extrusion step that created them, and
    track new/deleted group counts for the sanity checks
    (``utils.py:95-146``)."""
    group_to_id: dict = {}
    entity_to_group: dict = {}
    num_new_groups, num_deleted_group = [], []
    for i, entity in enumerate(ordered_entities):
        e = json_entities[entity]
        new_group = [
            g for g in e["extrude_faces"] if group_to_id.setdefault(g, i) == i
            and g not in entity_to_group.get(entity, [])
        ]
        body_faces = []
        for body in e.get("bodies", {}):
            body_faces += e["bodies"][body]["faces"]
        num_deleted = sum(1 for g in group_to_id if g not in body_faces)
        if not num_deleted_group:
            num_deleted_group.append(num_deleted)
        else:
            num_deleted_group.append(num_deleted - num_deleted_group[-1])
        entity_to_group[entity] = new_group
        num_new_groups.append(len(new_group))
    return group_to_id, entity_to_group, num_new_groups, num_deleted_group


def collect_split_faces(ordered_entities: list, json_entities: dict) -> dict:
    """Face groups that appear in a body without being created by an
    extrusion — split faces (``utils.py:150-186``). Maps group id -> step."""
    created: set = set()
    split: dict = {}
    for i, entity in enumerate(ordered_entities):
        e = json_entities[entity]
        created.update(e["extrude_faces"])
        for body in e.get("bodies", {}):
            for f in e["bodies"][body]["faces"]:
                if f not in created:
                    split[f] = i
    return split


def get_split_face_assignments(
    root_dir: str,
    ordered_objs: list,
    split_faces: dict,
    group_to_id: dict,
) -> Optional[dict]:
    """Recover the parent group of split faces by nearest-surface lookup in
    earlier design steps (``utils.py:219-298``)."""
    meshes = []
    for obj in ordered_objs:
        v, f, _, groups, _ = load_obj(os.path.join(root_dir, obj))
        meshes.append((v, f, groups))
    out = {}
    for face_group, step in split_faces.items():
        v, f, groups = meshes[step]
        centers = v[f[groups[face_group]]].mean(axis=1)
        assignment = None
        for prev in range(step - 1, -1, -1):
            pv, pf, pgroups = meshes[prev]
            dist, fid = meshutil.on_surface(centers, pv, pf)
            if (dist >= ZERO_TOL).any():
                continue
            labels = set()
            for i in range(len(centers)):
                for gid, gfaces in pgroups.items():
                    if fid[i] in gfaces and gid in group_to_id:
                        labels.add(gid)
            if len(labels) == 1:
                assignment = labels.pop()
                break
        if assignment is None:
            return None  # unrecoverable split face (utils.py:289-291)
        out[face_group] = assignment
    return out


def update_grouptoid_from_splitface(group_to_id: dict, split_face_groupid: dict):
    for face, parent_group in split_face_groupid.items():
        group_to_id[face] = group_to_id[parent_group]
    return group_to_id


# ------------------------- OBJ loading -------------------------


def load_obj(filename: str, group_to_id: Optional[dict] = None):
    """OBJ loader with `g`-group parsing (``utils.py:669-758``).

    Returns (vertices, faces, face_normals, groups {gid: face idx array},
    face_to_ids (F,) extrusion step per face — zeros when group_to_id is
    None).
    """
    vertices, faces = [], []
    groups: dict = {}
    face_to_ids = []
    group_id = None
    with open(filename) as f:
        for line in f:
            if line.startswith("v "):
                vertices.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("g "):
                group_id = line.split()[1]
                groups.setdefault(group_id, [])
            elif line.startswith("f "):
                faces.append(
                    [int(t.split("/")[0]) - 1 for t in line.split()[1:4]]
                )
                if group_id is not None:
                    groups[group_id].append(len(faces) - 1)
                    face_to_ids.append(
                        group_to_id[group_id] if group_to_id else 0
                    )
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    tri = vertices[faces]
    normals = np.cross(tri[:, 0] - tri[:, 1], tri[:, 0] - tri[:, 2])
    normals /= np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30
    )
    groups = {g: np.asarray(ix) for g, ix in groups.items()}
    return vertices, faces, normals, groups, np.asarray(face_to_ids)


# ------------------------- checks + labels -------------------------


def group_surface_areas_check(group_areas: list) -> bool:
    """Group surface areas must be non-increasing over the sequence
    (``utils.py:318-345``)."""
    current: dict = {}
    for areas in group_areas:
        for g, a in areas.items():
            if g in current and a > current[g] + ZERO_TOL:
                return False
            current[g] = a
    return True


def group_delta_check(num_groups_objs, num_new, num_deleted) -> bool:
    """New-minus-deleted group counts must match the obj deltas
    (``utils.py:347-364``)."""
    if num_groups_objs[0] != num_new[0]:
        return False
    for i in range(1, len(num_groups_objs)):
        if num_new[i] - num_deleted[i] != (
            num_groups_objs[i] - num_groups_objs[i - 1]
        ):
            return False
    return True


def normals_extrusions_check(normals, extrusion_labels, axes) -> bool:
    """Every normal must be parallel or perpendicular to its instance axis
    (``utils.py:366-375``)."""
    dots = np.abs(
        np.einsum("nd,nd->n", normals, axes[extrusion_labels])
    )
    return bool(np.all((dots <= ZERO_TOL) | (1 - dots < ZERO_TOL)))


def get_base_barrel_label(normals, extrusion_labels, axes) -> Optional[np.ndarray]:
    """0=barrel (normal perpendicular to axis), 1=base (parallel)
    (``utils.py:377-401``); None when a normal is neither."""
    dots = np.abs(np.einsum("nd,nd->n", normals, axes[extrusion_labels]))
    barrel = dots <= ZERO_TOL
    base = (1 - dots) < ZERO_TOL
    if not np.all(barrel | base):
        return None
    return base.astype(np.int32)


def get_operation_label(extrusion_labels, operations) -> np.ndarray:
    """Per-point CSG op codes (``utils.py:421-434``)."""
    return np.asarray(operations)[extrusion_labels]


def operation_code(op_name: str) -> int:
    return EXTRUSION_OPERATIONS.get(op_name, 0)


# ------------------------- multi-loop relabel -------------------------


def check_and_relabel_multiloop(vertices, faces, face_bb_labels, face_to_ids):
    """Split disconnected barrel loops of one extrusion into separate
    instance labels and reassign each base loop to the loop whose barrel
    reaches furthest from the base centroid (donut handling)
    (``utils.py:450-656``). Returns (face_to_ids, split_label_mapping)."""
    face_to_ids = np.asarray(face_to_ids).copy()
    vertices, faces = meshutil.merge_vertices(
        np.asarray(vertices), np.asarray(faces)
    )
    rng = np.random.default_rng(0)
    unique_ids = np.unique(face_to_ids)
    curr_max = int(face_to_ids.max())
    split_mapping = {}

    for e_id in unique_ids:
        barrel_fid = np.flatnonzero(
            (face_to_ids == e_id) & (face_bb_labels == 0)
        )
        if barrel_fid.size == 0:
            return None, None  # base without barrel (utils.py:563-564)
        comp = meshutil.connected_component_labels(
            meshutil.face_adjacency(faces[barrel_fid]), len(barrel_fid)
        )
        labels = [int(e_id)]
        if comp.max() > 0:
            for c in range(1, comp.max() + 1):
                new_label = curr_max + c
                face_to_ids[barrel_fid[comp == c]] = new_label
                labels.append(new_label)
            curr_max += comp.max()
        for lab in labels:
            split_mapping[lab] = int(e_id)

        if comp.max() == 0:
            continue
        # reassign this extrusion's base loops to the furthest barrel loop
        base_fid = np.flatnonzero(
            (face_to_ids == e_id) & (face_bb_labels == 1)
        )
        if base_fid.size == 0:
            continue
        base_comp = meshutil.connected_component_labels(
            meshutil.face_adjacency(faces[base_fid]), len(base_fid)
        )
        for bc in np.unique(base_comp):
            sel = base_fid[base_comp == bc]
            pc_base, _ = meshutil.sample_surface(
                vertices, faces[sel], 512, rng
            )
            centroid = pc_base.mean(axis=0)
            best_label, best_dist = None, -1.0
            for lab in labels:
                bsel = np.flatnonzero(
                    (face_to_ids == lab) & (face_bb_labels == 0)
                )
                if bsel.size == 0:
                    continue
                pc_barrel, _ = meshutil.sample_surface(
                    vertices, faces[bsel], 512, rng
                )
                d = np.max(np.sum((pc_barrel - centroid) ** 2, axis=1))
                if d > best_dist:
                    best_dist, best_label = d, lab
            if best_label is not None:
                face_to_ids[sel] = best_label
    return face_to_ids, split_mapping


# ------------------------- per-instance attributes -------------------------


def get_barrel_extents(point_cloud, bb_labels, extrusion_labels, axes):
    """Per-instance extent range along the axis from barrel points
    (``utils.py:798-852``). Returns (ext_dists (K',), counts, extents
    (K', 2))."""
    k = int(extrusion_labels.max()) + 1
    dists, counts, extents = [], [], []
    for i in range(k):
        sel = np.flatnonzero((extrusion_labels == i) & (bb_labels == 0))
        counts.append(sel.size)
        if sel.size == 0:
            dists.append(0.0)
            extents.append([0.0, 0.0])
            continue
        pc = point_cloud[sel]
        dot = (pc - pc.mean(axis=0)) @ axes[i]
        extents.append([dot.min(), dot.max()])
        dists.append(np.ptp(dot))
    return np.asarray(dists), np.asarray(counts), np.asarray(extents)


def get_extrusion_centers_np(point_cloud, extrusion_labels):
    """Per-instance point means (``utils.py:856-871``)."""
    k = int(extrusion_labels.max()) + 1
    return np.stack(
        [point_cloud[extrusion_labels == i].mean(axis=0) for i in range(k)]
    )


def extract_sketch(points2d: np.ndarray, normals2d: np.ndarray,
                   num_points: int, rng: np.random.Generator):
    """Centered, max-norm-normalized 2D sketch samples (the packed-`sk`
    dataset format)."""
    sel = rng.integers(0, len(points2d), num_points)
    p = points2d[sel] - points2d.mean(axis=0)
    scale = max(np.linalg.norm(p, axis=-1).max(), 1e-12)
    return np.concatenate([p / scale, normals2d[sel]], axis=-1), scale


# ------------------------- entry points -------------------------


def preprocess_model(
    root_dir: str,
    model_id: str,
    num_points: int = 16384,
    max_instances: int = 8,
    num_sketch_points: int = 2048,
    seed: int = 0,
    sample_even: bool = False,
    device: str | torch.device | None = None,
) -> Optional[dict]:
    """Full single-model pipeline JSON/OBJ -> packed sample dict; None when
    a filter/sanity check rejects the model (the reference's behavior for
    its dataset curation). The sketch plane's rotation runs on ``device``
    (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    objs, entities, _, _, json_entities = parse_files(root_dir, model_id)
    if not objs:
        return None
    info = get_extrude_infos(entities, json_entities)
    if info is None:
        return None
    group_to_id, _, num_new, num_deleted = face_groups_to_extrusion_id(
        entities, json_entities
    )
    split = collect_split_faces(entities, json_entities)
    if split:
        assignments = get_split_face_assignments(
            root_dir, objs, split, group_to_id
        )
        if assignments is None:
            return None
        group_to_id = update_grouptoid_from_splitface(group_to_id, assignments)

    final_obj = os.path.join(root_dir, objs[-1])
    vertices, faces, face_normals, groups, face_to_ids = load_obj(
        final_obj, group_to_id=group_to_id
    )
    if len(faces) == 0:
        return None

    axes = np.stack([info[e]["axis"] for e in entities])
    ops = np.array([operation_code(info[e]["operation"]) for e in entities])
    distances = np.array([info[e]["distance"] for e in entities])

    face_bb = get_base_barrel_label(face_normals, face_to_ids, axes)
    if face_bb is None:
        return None
    face_to_ids, split_mapping = check_and_relabel_multiloop(
        vertices, faces, face_bb, face_to_ids
    )
    if face_to_ids is None:
        return None
    n_inst = int(face_to_ids.max()) + 1
    if n_inst > max_instances:
        return None
    # propagate per-instance attributes through multiloop splits
    inst_axes = np.stack(
        [axes[split_mapping.get(i, i)] for i in range(n_inst)]
    )
    inst_ops = np.array(
        [ops[split_mapping.get(i, i)] for i in range(n_inst)]
    )
    inst_dist = np.array(
        [distances[split_mapping.get(i, i)] for i in range(n_inst)]
    )

    pts, sampled_faces = meshutil.sample_surface(
        vertices, faces, num_points, rng, even=sample_even
    )
    labels = face_to_ids[sampled_faces].astype(np.int32)
    normals = face_normals[sampled_faces]
    bb = get_base_barrel_label(normals, labels, inst_axes)
    if bb is None:
        return None
    if not normals_extrusions_check(normals, labels, inst_axes):
        return None

    # center + unit-sphere normalize (utils.py:922-950)
    centroid = pts.mean(axis=0)
    pts = pts - centroid
    norm_factor = np.linalg.norm(pts, axis=-1).max()
    pts = pts / norm_factor

    centers = get_extrusion_centers_np(pts, labels)
    _, _, extents = get_barrel_extents(pts, bb, labels, inst_axes)

    # per-instance sketches: project barrel points onto the sketch plane
    sketches = np.zeros((max_instances, num_sketch_points, 4), np.float32)
    sk_norms = np.ones(max_instances, np.float32)
    rots = rotation_to_z(torch.as_tensor(inst_axes, dtype=torch.float32,
                                         device=device)).cpu().numpy()
    for i in range(n_inst):
        sel = np.flatnonzero((labels == i) & (bb == 0))
        if sel.size < 2:
            continue
        p2 = (rots[i] @ pts[sel].T).T[:, :2]
        n2 = (rots[i] @ normals[sel].T).T[:, :2]
        sketches[i], sk_norms[i] = extract_sketch(
            p2, n2, num_sketch_points, rng
        )

    def pad_k(arr, fill=0.0):
        out = np.full((max_instances,) + arr.shape[1:], fill, np.float32)
        out[: len(arr)] = arr
        return out

    return dict(
        point_cloud=pts.astype(np.float32),
        normals=normals.astype(np.float32),
        extrusion_labels=labels,
        base_barrel_labels=bb,
        n_instances=n_inst,
        extrusion_axes=pad_k(inst_axes),
        extrusion_distances=pad_k(inst_dist / norm_factor),
        extrusion_operation=get_operation_label(labels, inst_ops).astype(
            np.int32
        ),
        extrusion_centers=pad_k(centers),
        extrusion_extents=pad_k(extents),
        sketches=sketches,
        sketches_norms=sk_norms,
        norm_factor=norm_factor,
    )


def cli_main(argv: list[str] | None = None) -> list[str]:
    """Preprocess a directory of Fusion JSON/OBJ models into an h5 pack
    (the entry point the reference's offline pipeline lacks); returns
    the ids kept."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--raw_dir", required=True,
                   help="directory with <model_id>.json + OBJ files")
    p.add_argument("--out", required=True, help="output h5 path")
    p.add_argument("--model_ids", nargs="*", default=None,
                   help="ids to process (default: every *.json in raw_dir)")
    p.add_argument("--num_points", type=int, default=16384)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--num_sk_point", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the sketch plane's rotation (default: the card)")
    args = p.parse_args(argv)
    ids = args.model_ids
    if not ids:
        ids = sorted(
            f[:-5] for f in os.listdir(args.raw_dir) if f.endswith(".json")
        )
    ds, kept = build_dataset(
        args.raw_dir, ids, args.num_points, args.K, args.num_sk_point,
        args.seed, device=args.device,
    )
    save_h5(args.out, ds)
    print(f"Preprocessed {len(kept)}/{len(ids)} models -> {args.out}")
    return kept


def build_dataset(
    root_dir: str,
    model_ids: list[str],
    num_points: int = 16384,
    max_instances: int = 8,
    num_sketch_points: int = 2048,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[PackedDataset, list[str]]:
    """Preprocess many models into one packed dataset; returns the dataset
    and the ids that survived filtering."""
    device = resolve_device(device)
    samples, kept = [], []
    for mid in model_ids:
        try:
            s = preprocess_model(
                root_dir, mid, num_points, max_instances,
                num_sketch_points, seed, device=device,
            )
        except (KeyError, ValueError, FileNotFoundError):
            s = None
        if s is not None:
            s.pop("norm_factor")
            samples.append(s)
            kept.append(mid)
    if not samples:
        raise ValueError("no models survived preprocessing")
    stack = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    stack["n_instances"] = stack["n_instances"].astype(np.int32)
    return PackedDataset(**stack), kept


if __name__ == "__main__":
    cli_main()
