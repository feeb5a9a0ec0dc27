"""Host image I/O: OpenEXR (self-contained reader/writer), PFM, LDR; a
numpy copy of gdpt_tpu/core/image.py.

Replaces the reference's stb_image + tinyexr layer
(reference: src/image.h/.cpp). The EXR codec here is a minimal scanline
implementation (NONE / ZIPS / ZIP compression, HALF / FLOAT channels)
sufficient for the reference's scene assets and render outputs; LDR
formats go through PIL and are linearized with gamma 2.2 to match
stb_image's ``stbi_loadf`` behavior (reference: src/image.cpp:43).
"""

import struct
import zlib

import numpy as np

_EXR_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP, _PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32}


def _read_cstr(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _exr_unpredict(data):
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int16)
    deltas = arr.copy()
    deltas[1:] -= 128
    out = np.cumsum(deltas, dtype=np.int64).astype(np.uint8)
    half = (len(out) + 1) // 2
    inter = np.empty(len(out), dtype=np.uint8)
    inter[0::2] = out[:half]
    inter[1::2] = out[half:]
    return inter.tobytes()


def _exr_predict(data):
    arr = np.frombuffer(data, dtype=np.uint8)
    half = (len(arr) + 1) // 2
    tmp = np.empty(len(arr), dtype=np.uint8)
    tmp[:half] = arr[0::2]
    tmp[half:] = arr[1::2]
    t = tmp.astype(np.int16)
    d = np.empty_like(t)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + 128
    return d.astype(np.uint8).tobytes()


def read_exr(filename):
    """Read a scanline EXR to an (h, w, c) float32 array (channels sorted
    R,G,B[,A] when present, else alphabetical)."""
    with open(filename, "rb") as f:
        buf = f.read()
    if buf[:4] != _EXR_MAGIC:
        raise ValueError(f"{filename}: not an EXR file")
    version = struct.unpack("<I", buf[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{filename}: tiled EXR not supported")
    pos = 8
    channels = []
    compression = None
    data_window = None
    while True:
        name, pos = _read_cstr(buf, pos)
        if name == "":
            break
        atype, pos = _read_cstr(buf, pos)
        size = struct.unpack("<i", buf[pos : pos + 4])[0]
        pos += 4
        val = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cname, cpos = _read_cstr(val, cpos)
                ptype = struct.unpack("<i", val[cpos : cpos + 4])[0]
                cpos += 16  # type, pLinear+pad, xSampling, ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(
            f"{filename}: unsupported EXR compression {compression}"
        )
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    nblocks = (h + lpb - 1) // lpb
    # EXR stores channels per scanline sorted by name.
    channels_sorted = sorted(channels, key=lambda c: c[0])
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32, _PT_UINT: np.uint32}
    offsets = struct.unpack(f"<{nblocks}Q", buf[pos : pos + 8 * nblocks])

    planes = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y0, dsize = struct.unpack("<iI", buf[off : off + 8])
        raw = buf[off + 8 : off + 8 + dsize]
        ny = min(lpb, ymax + 1 - y0)
        expect = sum(
            w * ny * np.dtype(dtypes[pt]).itemsize for _, pt in channels
        )
        if compression == _PIZ:
            if dsize < expect:
                from gdpt_tpu_torch.core import exr_piz

                raw = exr_piz.piz_uncompress(raw, channels_sorted, w, ny, dtypes)
        elif compression != _NO_COMPRESSION and dsize < expect:
            raw = _exr_unpredict(zlib.decompress(raw))
        cpos = 0
        for line in range(ny):
            for cname, ptype in channels_sorted:
                dt = dtypes[ptype]
                nbytes = w * np.dtype(dt).itemsize
                row = np.frombuffer(raw[cpos : cpos + nbytes], dtype=dt)
                planes[cname][y0 - ymin + line] = row.astype(np.float32)
                cpos += nbytes

    names = [c[0] for c in channels_sorted]
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([planes[n] for n in order], axis=-1)


def write_exr(filename, img):
    """Write an (h, w) or (h, w, 3) float array as a ZIPS-compressed
    float32 scanline EXR."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    names = ["R", "G", "B"] if c == 3 else [f"C{i}" for i in range(c)]
    # EXR channel order within a scanline is alphabetical.
    chan_order = sorted(range(c), key=lambda i: names[i])

    def attr(name, atype, payload):
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for i in chan_order:
        chlist += (
            names[i].encode() + b"\x00"
            + struct.pack("<i", _PT_FLOAT)
            + b"\x00\x00\x00\x00"
            + struct.pack("<ii", 1, 1)
        )
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = _EXR_MAGIC + struct.pack("<I", 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([_ZIPS]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    chunks = []
    for y in range(h):
        raw = b"".join(img[y, :, i].tobytes() for i in chan_order)
        comp = zlib.compress(_exr_predict(raw))
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<iI", y, len(comp)) + comp)

    table_start = len(header)
    data_start = table_start + 8 * h
    offsets, acc = [], data_start
    for ch in chunks:
        offsets.append(acc)
        acc += len(ch)
    with open(filename, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for ch in chunks:
            f.write(ch)


def read_pfm(filename):
    with open(filename, "rb") as f:
        kind = f.readline().strip()
        if kind not in (b"PF", b"Pf"):
            raise ValueError(f"{filename}: not a PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if kind == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), dtype="<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)
    return img.astype(np.float32)


def write_pfm(filename, img):
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    with open(filename, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")
        f.write(img.astype("<f4").tobytes())


def imread(filename):
    """Read an image to a linear (h, w, 3) float32 array."""
    name = str(filename).lower()
    if name.endswith(".exr"):
        img = read_exr(filename)[..., :3]
    elif name.endswith(".pfm"):
        img = read_pfm(filename)
    else:
        from PIL import Image

        with Image.open(filename) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        # stb_image's loadf applies gamma 2.2 when promoting LDR to HDR
        # (reference: src/image.cpp uses stbi_loadf).
        img = arr ** 2.2
    if img.shape[-1] == 1:
        img = img.repeat(3, axis=-1)
    return np.ascontiguousarray(img[..., :3], dtype=np.float32)


def imread1(filename):
    """Read to single channel: EXR averages RGB (reference: src/image.cpp:72),
    LDR converts via stb's luminance-free 1-channel path (here: mean)."""
    return imread(filename).mean(axis=-1)


def imwrite(filename, img):
    name = str(filename).lower()
    if name.endswith(".exr"):
        write_exr(filename, img)
    elif name.endswith(".pfm"):
        write_pfm(filename, img)
    else:
        from PIL import Image

        arr = np.clip(np.asarray(img), 0.0, 1.0) ** (1 / 2.2)
        Image.fromarray((arr * 255).astype(np.uint8)).save(filename)
