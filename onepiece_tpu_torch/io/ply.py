"""PLY mesh / point-cloud IO (binary little-endian + ascii).

The port's own copy of `onepiece_tpu/io/ply.py` (numpy only); the changes
are that `dedup_triangle_soup` takes each vertex's first occurrence from
`np.unique(..., return_index=True)` instead of a Python loop, and that
`read_ply` reads a binary face list of triangles only as one array of fixed
records instead of face by face (same results).

Replacement for the reference's tinyply/rply wrappers
(ref: src/Tool/{PLYManager,RPLYManager}.{h,cpp}) in pure numpy — struct
layouts are written directly, no third-party dependency.
"""

from __future__ import annotations

import numpy as np


def write_ply_mesh(
    path: str,
    vertices: np.ndarray,  # (V, 3) float
    faces: np.ndarray,  # (F, 3) int
    colors: np.ndarray | None = None,  # (V, 3) float in [0,1] or uint8
    normals: np.ndarray | None = None,  # (V, 3) float
    binary: bool = True,
    labels: dict[str, np.ndarray] | None = None,  # extra int32 elements
) -> None:
    """labels: named extra PLY elements (e.g. instance ids), one int32
    property per element — the reference's AdditionalElement mechanism
    (ref: src/Tool/PLYManager.h:15-34), used by its ScanNet label
    workflow instead of squeezing labels through vertex colors."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    props = ["property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = None
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(cols * 255.0, 0, 255).astype(np.uint8)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

    header = (
        ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0"]
        + [f"element vertex {len(v)}"]
        + props
        + [f"element face {len(f)}", "property list uchar int vertex_indices"]
    )
    label_arrays = {}
    if labels:
        for name, arr in labels.items():
            la = np.asarray(arr, np.int32)
            label_arrays[name] = la
            header += [f"element {name} {len(la)}", f"property int {name}"]
    header += ["end_header"]
    vdata = np.zeros(len(v), dtype=fields)
    vdata["x"], vdata["y"], vdata["z"] = v[:, 0], v[:, 1], v[:, 2]
    if normals is not None:
        n = np.asarray(normals, np.float32)
        vdata["nx"], vdata["ny"], vdata["nz"] = n[:, 0], n[:, 1], n[:, 2]
    if cols is not None:
        vdata["red"], vdata["green"], vdata["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]

    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        if binary:
            fh.write(vdata.tobytes())
            fdata = np.zeros(len(f), dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            fdata["n"] = 3
            fdata["a"], fdata["b"], fdata["c"] = f[:, 0], f[:, 1], f[:, 2]
            fh.write(fdata.tobytes())
            for la in label_arrays.values():
                fh.write(la.astype("<i4").tobytes())
        else:
            for row in vdata:
                fh.write((" ".join(str(x) for x in row) + "\n").encode())
            for row in f:
                fh.write(f"3 {row[0]} {row[1]} {row[2]}\n".encode())
            for la in label_arrays.values():
                for x in la:
                    fh.write(f"{int(x)}\n".encode())


def write_ply_pointcloud(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    write_ply_mesh(path, points, np.zeros((0, 3), np.int32), colors, normals, binary)


def read_ply(path: str) -> dict:
    """Minimal PLY reader (binary LE / ascii) -> dict with 'vertices',
    optional 'colors', 'normals', 'faces'."""
    with open(path, "rb") as fh:
        data = fh.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    body = data[head_end:]
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
    cur = None
    for line in header:
        parts = line.split()
        if parts[0] == "element":
            cur = {"name": parts[1], "count": int(parts[2]), "props": []}
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur["props"].append((parts[2], parts[1]))  # (name, type)

    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    }
    out: dict = {}
    offset = 0
    if fmt == "ascii":
        lines = body.decode().split("\n")
        li = 0
        for el in elements:
            rows = []
            for _ in range(el["count"]):
                rows.append(lines[li].split())
                li += 1
            if el["name"] == "vertex":
                names = [p[0] for p in el["props"]]
                arr = np.array(rows, np.float64)
                out.update(_vertex_dict(arr, names))
            elif el["name"] == "face":
                out["faces"] = np.array([r[1:4] for r in rows], np.int64)
        return out

    for el in elements:
        if all(p[0] != "list" for p in el["props"]):
            dt = np.dtype([(p[0], type_map[p[1]]) for p in el["props"]])
            arr = np.frombuffer(body, dt, count=el["count"], offset=offset)
            offset += dt.itemsize * el["count"]
            if el["name"] == "vertex":
                names = [p[0] for p in el["props"]]
                stacked = np.stack([arr[n].astype(np.float64) for n in names], -1)
                out.update(_vertex_dict(stacked, names))
            else:
                # extra label elements (ref: PLYManager.h AdditionalElement)
                names = [p[0] for p in el["props"]]
                col = arr[names[0]] if len(names) == 1 else arr
                out.setdefault("labels", {})[el["name"]] = np.asarray(col)
        else:
            # face element with a single list property (the common case):
            # all triangles read as fixed records at once, else face by face
            count_t, index_t = (np.dtype(type_map[t]) for t in el["props"][0][1:3])
            tri = np.dtype([("n", count_t), ("idx", index_t, (3,))])
            if len(body) - offset >= tri.itemsize * el["count"]:
                fixed = np.frombuffer(body, tri, count=el["count"], offset=offset)
                if (fixed["n"] == 3).all():
                    out["faces"] = fixed["idx"].astype(np.int64)
                    offset += tri.itemsize * el["count"]
                    continue
            faces = []
            for _ in range(el["count"]):
                (n,) = np.frombuffer(body, type_map[el["props"][0][1]], 1, offset)
                offset += np.dtype(type_map[el["props"][0][1]]).itemsize
                idx = np.frombuffer(body, type_map[el["props"][0][2]], int(n), offset)
                offset += np.dtype(type_map[el["props"][0][2]]).itemsize * int(n)
                faces.append(idx[:3])
            out["faces"] = np.array(faces, np.int64) if faces else np.zeros((0, 3), np.int64)
    return out


def _vertex_dict(arr: np.ndarray, names: list[str]) -> dict:
    out = {"vertices": np.stack([arr[:, names.index(k)] for k in "xyz"], -1).astype(np.float32)}
    if "nx" in names:
        out["normals"] = np.stack(
            [arr[:, names.index(k)] for k in ("nx", "ny", "nz")], -1
        ).astype(np.float32)
    if "red" in names:
        out["colors"] = np.stack(
            [arr[:, names.index(k)] for k in ("red", "green", "blue")], -1
        ).astype(np.float32) / 255.0
    return out


def dedup_triangle_soup(
    tri_verts: np.ndarray,  # (T, 3, 3)
    tri_colors: np.ndarray | None = None,  # (T, 3, 3)
    quantum: float = 1e-5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Merge identical (quantised) vertices -> (vertices, faces, colors)."""
    flat = tri_verts.reshape(-1, 3)
    keys = np.round(flat / quantum).astype(np.int64)
    # representative positions: first occurrence
    _, first, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    cols = None
    if tri_colors is not None:
        cols = tri_colors.reshape(-1, 3)[first]
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[ok], cols
