"""Host-side asset loaders: OBJ, PLY, Mitsuba .serialized, Mitsuba .vol; a
numpy copy of gdpt_tpu/scene/loaders.py.

Replaces reference: src/parsers/parse_obj.cpp, parse_ply.cpp (tinyply),
load_serialized.cpp (miniz inflate) and src/volume.cpp, using
numpy + Python zlib. All loaders return numpy arrays in world space.
"""

import struct
import zlib

import numpy as np


def _apply_to_world(positions, normals, to_world):
    if to_world is None:
        return positions, normals
    to_world = np.asarray(to_world, np.float64)
    pos = positions @ to_world[:3, :3].T + to_world[:3, 3]
    nrm = None
    if normals is not None and len(normals):
        inv_t = np.linalg.inv(to_world)[:3, :3]  # use transpose-of-inverse
        nrm = normals @ inv_t
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-20)
    return pos, nrm


def compute_smooth_normals(positions, indices):
    """Nelson Max's weighted vertex normals (reference:
    src/parsers/shape_utils.h:15-50): each face corner contributes
    cross(e1, e2) / (|e1|^2 |e2|^2)."""
    normals = np.zeros_like(positions)
    p = positions
    for k in range(3):
        i0 = indices[:, k]
        i1 = indices[:, (k + 1) % 3]
        i2 = indices[:, (k + 2) % 3]
        e1 = p[i1] - p[i0]
        e2 = p[i2] - p[i0]
        n = np.cross(e1, e2)
        w = np.maximum(
            (e1 * e1).sum(1) * (e2 * e2).sum(1), 1e-20
        )
        np.add.at(normals, i0, n / w[:, None])
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(ln, 1e-20)


def load_obj(filename, to_world=None, face_normals=False):
    """Wavefront OBJ with v/vt/vn index remapping
    (reference: src/parsers/parse_obj.cpp). Returns
    (positions, indices, normals, uvs) with normals/uvs possibly None."""
    v_pool, vt_pool, vn_pool = [], [], []
    verts = {}
    out_pos, out_uv, out_nrm, tris = [], [], [], []

    def vertex_id(token):
        parts = token.split("/")
        v = int(parts[0])
        vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        v = v - 1 if v > 0 else len(v_pool) + v
        vt = vt - 1 if vt > 0 else (len(vt_pool) + vt if vt else -1)
        vn = vn - 1 if vn > 0 else (len(vn_pool) + vn if vn else -1)
        key = (v, vt, vn)
        if key in verts:
            return verts[key]
        idx = len(out_pos)
        verts[key] = idx
        out_pos.append(v_pool[v])
        out_uv.append(vt_pool[vt] if vt >= 0 else (0.0, 0.0))
        out_nrm.append(vn_pool[vn] if vn >= 0 else None)
        return idx

    with open(filename, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                v_pool.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vt":
                vt_pool.append(tuple(map(float, tok[1:3])))
            elif tok[0] == "vn":
                vn_pool.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "f":
                ids = [vertex_id(t) for t in tok[1:]]
                for i in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[i], ids[i + 1]))

    positions = np.asarray(out_pos, np.float64)
    indices = np.asarray(tris, np.int64)
    has_any_normal = any(n is not None for n in out_nrm)
    normals = None
    if has_any_normal and not face_normals:
        normals = np.asarray(
            [n if n is not None else (0.0, 0.0, 0.0) for n in out_nrm], np.float64
        )
    uvs = np.asarray(out_uv, np.float64) if vt_pool else None
    positions, normals = _apply_to_world(positions, normals, to_world)
    if normals is None and not face_normals:
        # The reference computes smooth normals for obj meshes without
        # vn entries (reference: src/parsers/parse_obj.cpp + shape_utils.h).
        normals = compute_smooth_normals(positions, indices)
    return positions, indices, normals, uvs


def load_ply(filename, to_world=None, face_normals=False):
    """Minimal PLY reader (ascii + binary little/big endian), vertex
    x/y/z[/nx/ny/nz][/u/v] + face lists (reference: src/parsers/parse_ply.cpp)."""
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{filename}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(proptype, name) or ('list', idx_t, cnt_t, name)])
        while True:
            line = f.readline().split()
            if not line:
                continue
            if line[0] == b"format":
                fmt = line[1].decode()
            elif line[0] == b"element":
                elements.append([line[1].decode(), int(line[2]), []])
            elif line[0] == b"property":
                if line[1] == b"list":
                    elements[-1][2].append(
                        ("list", line[2].decode(), line[3].decode(), line[4].decode())
                    )
                else:
                    elements[-1][2].append((line[1].decode(), line[2].decode()))
            elif line[0] == b"end_header":
                break
        type_map = {
            "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        }
        endian = "<" if "little" in fmt else ">"
        positions = normals = uvs = None
        indices = []
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    data = np.loadtxt(
                        [f.readline() for _ in range(count)], dtype=np.float64
                    ).reshape(count, -1)
                    cols = [p[-1] for p in props]
                else:
                    dt = np.dtype([(p[1], endian + type_map[p[0]]) for p in props])
                    raw = f.read(dt.itemsize * count)
                    rec = np.frombuffer(raw, dtype=dt, count=count)
                    cols = [p[1] for p in props]
                    data = np.stack(
                        [rec[c].astype(np.float64) for c in cols], axis=1
                    )
                ci = {c: i for i, c in enumerate(cols)}
                positions = data[:, [ci["x"], ci["y"], ci["z"]]]
                if all(k in ci for k in ("nx", "ny", "nz")):
                    normals = data[:, [ci["nx"], ci["ny"], ci["nz"]]]
                for uk, vk in (("u", "v"), ("s", "t")):
                    if uk in ci and vk in ci:
                        uvs = data[:, [ci[uk], ci[vk]]]
                        break
            elif name == "face":
                lp = props[0]
                if fmt == "ascii":
                    for _ in range(count):
                        vals = list(map(int, f.readline().split()))
                        n = vals[0]
                        for i in range(1, n - 1):
                            indices.append((vals[1], vals[1 + i], vals[2 + i]))
                else:
                    cnt_t = np.dtype(endian + type_map[lp[1]])
                    idx_t = np.dtype(endian + type_map[lp[2]])
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_t.itemsize), cnt_t)[0])
                        ids = np.frombuffer(f.read(idx_t.itemsize * n), idx_t)
                        for i in range(1, n - 1):
                            indices.append((ids[0], ids[i], ids[i + 1]))
    indices = np.asarray(indices, np.int64)
    if face_normals:
        normals = None
    positions, normals = _apply_to_world(positions, normals, to_world)
    if normals is None and not face_normals:
        normals = compute_smooth_normals(positions, indices)
    return positions, indices, normals, uvs


_SER_HAS_NORMALS = 0x0001
_SER_HAS_TEXCOORDS = 0x0002
_SER_HAS_COLORS = 0x0008
_SER_DOUBLE = 0x2000


def load_serialized(filename, shape_index=0, to_world=None, face_normals=False):
    """Mitsuba .serialized mesh (v3/v4): zlib-compressed per-mesh streams
    with an offset table at EOF (reference: src/parsers/load_serialized.cpp)."""
    with open(filename, "rb") as f:
        buf = f.read()
    version = struct.unpack("<H", buf[2:4])[0]
    offset = 4
    if shape_index > 0:
        count = struct.unpack("<I", buf[-4:])[0]
        if version == 0x0004:
            table = np.frombuffer(
                buf[-4 - 8 * count : -4], dtype="<u8"
            )
            offset = int(table[shape_index]) + 4  # skip per-mesh header
        else:
            table = np.frombuffer(buf[-4 - 4 * count : -4], dtype="<u4")
            offset = int(table[shape_index]) + 4
    # decompressobj stops cleanly at the end of this mesh's stream even
    # though more meshes / the offset table follow in the file.
    data = zlib.decompressobj().decompress(buf[offset:])
    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos : pos + n]
        pos += n
        return out

    flags = struct.unpack("<I", take(4))[0]
    if version == 0x0004:
        end = data.index(b"\x00", pos)
        pos = end + 1
    n_verts, n_tris = struct.unpack("<QQ", take(16))
    ftype = np.dtype("<f8") if flags & _SER_DOUBLE else np.dtype("<f4")
    fs = ftype.itemsize

    positions = np.frombuffer(take(3 * fs * n_verts), ftype).reshape(-1, 3).astype(np.float64)
    normals = None
    if flags & _SER_HAS_NORMALS:
        normals = np.frombuffer(take(3 * fs * n_verts), ftype).reshape(-1, 3).astype(np.float64)
    uvs = None
    if flags & _SER_HAS_TEXCOORDS:
        uvs = np.frombuffer(take(2 * fs * n_verts), ftype).reshape(-1, 2).astype(np.float64)
    if flags & _SER_HAS_COLORS:
        take(3 * fs * n_verts)
    indices = np.frombuffer(take(12 * n_tris), "<u4").reshape(-1, 3).astype(np.int64)

    if face_normals:
        normals = None
    positions, normals = _apply_to_world(positions, normals, to_world)
    return positions, indices, normals, uvs


def load_vol(filename):
    """Mitsuba .vol grid (VOL v3, float32, 1 or 3 channels)
    (reference: src/volume.cpp:6-114). Returns (data (z,y,x,c), p_min, p_max)."""
    with open(filename, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError(f"{filename}: not a VOL file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{filename}: unsupported VOL version {version}")
        vtype, xres, yres, zres, channels = struct.unpack("<5i", f.read(20))
        if vtype != 1:
            raise ValueError(f"{filename}: only float32 volumes supported")
        if channels not in (1, 3):
            raise ValueError(f"{filename}: unsupported channel count {channels}")
        bbox = struct.unpack("<6f", f.read(24))
        data = np.frombuffer(
            f.read(4 * xres * yres * zres * channels), "<f4"
        ).reshape(zres, yres, xres, channels)
    p_min = np.array(bbox[:3], np.float64)
    p_max = np.array(bbox[3:], np.float64)
    return data.astype(np.float32), p_min, p_max
