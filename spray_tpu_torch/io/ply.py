"""PLY triangle-mesh reader/writer: a numpy copy of ``spray_tpu/io/ply.py``.

Supports the formats scientific-viz pipelines actually emit: binary little/big
endian and ascii, vertex x/y/z (+optional red/green/blue), face
vertex_indices (list).  Pure numpy, vectorized parsing for binary bodies.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read a PLY mesh -> dict(vertices (V,3) f32, faces (F,3) i32,
    colors (V,3) f32 in [0,1] or None).  Quads are triangulated."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: no end_header")
    body_off = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", "replace").splitlines()

    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) | ('list', ct, t, name)])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    if fmt == "ascii":
        return _read_ascii(data[body_off:], elements)
    endian = "<" if fmt == "binary_little_endian" else ">"
    return _read_binary(data[body_off:], elements, endian)


def _finish(vprops, vdata, fdata):
    names = [p[-1] for p in vprops]
    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
    verts = np.stack(
        [vdata[:, xi], vdata[:, yi], vdata[:, zi]], axis=1
    ).astype(np.float32)
    colors = None
    if "red" in names:
        ri, gi, bi = names.index("red"), names.index("green"), names.index("blue")
        colors = np.stack([vdata[:, ri], vdata[:, gi], vdata[:, bi]], axis=1)
        if colors.max() > 1.0:
            colors = colors / 255.0
        colors = colors.astype(np.float32)
    faces = []
    for idx in fdata:
        for k in range(1, len(idx) - 1):  # fan-triangulate
            faces.append((idx[0], idx[k], idx[k + 1]))
    return {
        "vertices": verts,
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "colors": colors,
    }


def _read_binary(body, elements, endian):
    off = 0
    vdata = fdata = vprops = None
    for name, count, props in elements:
        if name == "vertex":
            vprops = props
            if any(p[0] == "list" for p in props):
                raise ValueError("list property on vertex element unsupported")
            dt = np.dtype(
                [(p[1], endian + _PLY_TO_NP[p[0]]) for p in props]
            )
            arr = np.frombuffer(body, dt, count, off)
            off += dt.itemsize * count
            vdata = np.stack(
                [arr[p[1]].astype(np.float64) for p in props], axis=1
            )
        elif name == "face":
            lp = props[0]
            assert lp[0] == "list"
            ct = np.dtype(endian + _PLY_TO_NP[lp[1]])
            it = np.dtype(endian + _PLY_TO_NP[lp[2]])
            fdata = _read_face_lists(body, off, count, ct, it)
            off = fdata.pop()  # last element = new offset
            fdata = fdata[0]
        else:
            # skip unknown fixed-size elements
            dt = np.dtype(
                [(p[1], endian + _PLY_TO_NP[p[0]]) for p in props
                 if p[0] != "list"]
            )
            off += dt.itemsize * count
    return _finish(vprops, vdata, fdata)


def _read_face_lists(body, off, count, ct, it):
    """Parse `count` list-properties.  Returns [face_list, new_offset].

    Fast path when every list has the same arity (the overwhelmingly common
    case): one vectorized frombuffer.  Falls back to a per-record loop.
    """
    if count == 0:
        return [[], off]
    n0 = int(np.frombuffer(body, ct, 1, off)[0])
    rec = ct.itemsize + n0 * it.itemsize
    if len(body) - off >= rec * count:
        cand = np.frombuffer(body, np.uint8, rec * count, off).reshape(
            count, rec
        )
        counts = np.frombuffer(cand[:, : ct.itemsize].tobytes(), ct)
        if (counts == n0).all():
            idx = np.frombuffer(
                cand[:, ct.itemsize :].tobytes(), it
            ).reshape(count, n0).astype(np.int64)
            return [[tuple(r) for r in idx], off + rec * count]
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(body, ct, 1, off)[0])
        off += ct.itemsize
        idx = np.frombuffer(body, it, n, off)
        off += it.itemsize * n
        faces.append(tuple(int(i) for i in idx))
    return [faces, off]


def _read_ascii(body, elements):
    lines = body.decode("ascii", "replace").split("\n")
    li = 0
    vdata = fdata = vprops = None
    for name, count, props in elements:
        rows = []
        for _ in range(count):
            while li < len(lines) and not lines[li].strip():
                li += 1
            rows.append(lines[li].split())
            li += 1
        if name == "vertex":
            vprops = props
            vdata = np.asarray(rows, np.float64)
        elif name == "face":
            fdata = [tuple(int(x) for x in r[1 : 1 + int(r[0])]) for r in rows]
    return _finish(vprops, vdata, fdata)


def write_ply(path, vertices, faces, colors=None, binary=True):
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    v, f = len(vertices), len(faces)
    hdr = ["ply"]
    hdr.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    hdr += [f"element vertex {v}", "property float x", "property float y",
            "property float z"]
    if colors is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
    hdr += [f"element face {f}", "property list uchar int vertex_indices",
            "end_header", ""]
    with open(path, "wb") as out:
        out.write("\n".join(hdr).encode())
        if binary:
            if colors is not None:
                c8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
                dt = np.dtype(
                    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                     ("r", "u1"), ("g", "u1"), ("b", "u1")]
                )
                rec = np.empty(v, dt)
                rec["x"], rec["y"], rec["z"] = vertices.T
                rec["r"], rec["g"], rec["b"] = c8.T
                out.write(rec.tobytes())
            else:
                out.write(vertices.astype("<f4").tobytes())
            fdt = np.dtype([("n", "u1"), ("i", "<i4", 3)])
            frec = np.empty(f, fdt)
            frec["n"] = 3
            frec["i"] = faces
            out.write(frec.tobytes())
        else:
            for i in range(v):
                row = "%g %g %g" % tuple(vertices[i])
                if colors is not None:
                    c8 = (np.clip(colors[i], 0, 1) * 255).astype(int)
                    row += " %d %d %d" % tuple(c8)
                out.write((row + "\n").encode())
            for i in range(f):
                out.write(("3 %d %d %d\n" % tuple(faces[i])).encode())
