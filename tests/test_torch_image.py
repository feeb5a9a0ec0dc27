"""The port's image I/O (core/image.py, core/exr_piz.py) against gdpt_tpu's.

Both are numpy host code, so the written files are compared byte for
byte and the decoded arrays bit for bit.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from gdpt_tpu.core import exr_piz as jpiz
from gdpt_tpu.core import image as jimage
from gdpt_tpu_torch.core import exr_piz as tpiz
from gdpt_tpu_torch.core import image as timage

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
NAMES = ["cbox_path", "cbox_depth", "furnace", "volpath_v5", "cbox_gdpt"]


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 4.0).astype(np.float32)
    img.reshape(-1)[:: 7] = 0.0  # runs that compress
    return img


@pytest.mark.parametrize("shape", [(8, 12, 3), (9, 5), (6, 7, 4)])
def test_write_exr_is_byte_identical(tmp_path, shape):
    img = _image(shape, sum(shape))
    jimage.write_exr(str(tmp_path / "j.exr"), img)
    timage.write_exr(str(tmp_path / "t.exr"), img)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    back = timage.read_exr(str(tmp_path / "t.exr"))
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("shape", [(8, 12, 3), (9, 5)])
def test_write_pfm_is_byte_identical(tmp_path, shape):
    img = _image(shape, 3)
    jimage.write_pfm(str(tmp_path / "j.pfm"), img)
    timage.write_pfm(str(tmp_path / "t.pfm"), img)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(timage.read_pfm(str(tmp_path / "t.pfm")),
                                  jimage.read_pfm(str(tmp_path / "j.pfm")))


@pytest.mark.parametrize("name", NAMES)
def test_read_exr_of_the_goldens(name):
    path = os.path.join(GOLDENS, f"{name}.exr")
    a, b = timage.read_exr(path), jimage.read_exr(path)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _write_exr_raw(path, planes, compression, ptype):
    """A scanline EXR with the given compression (0 NONE, 3 ZIP) and pixel
    type (1 HALF, 2 FLOAT), channels B, G, R."""
    h, w = planes[0].shape
    dt = np.float16 if ptype == 1 else np.float32
    lpb = 16 if compression == 3 else 1

    def attr(name, atype, payload):
        return name.encode() + b"\0" + atype.encode() + b"\0" + struct.pack("<i", len(payload)) \
            + payload

    chlist = b"".join(c.encode() + b"\0" + struct.pack("<i", ptype) + b"\0" * 4
                      + struct.pack("<ii", 1, 1) for c in "BGR") + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"\x76\x2f\x31\x01" + struct.pack("<I", 2) + attr("channels", "chlist", chlist) \
        + attr("compression", "compression", bytes([compression])) \
        + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box) \
        + attr("lineOrder", "lineOrder", b"\0") + b"\0"
    chunks = []
    for y0 in range(0, h, lpb):
        raw = b"".join(planes[c][y].astype(dt).tobytes()
                       for y in range(y0, min(h, y0 + lpb)) for c in (2, 1, 0))
        if compression == 3:  # kept raw where compression does not pay, as EXR does
            comp = zlib.compress(timage._exr_predict(raw))
            raw = comp if len(comp) < len(raw) else raw
        chunks.append(struct.pack("<iI", y0, len(raw)) + raw)
    offsets, at = [], len(header) + 8 * len(chunks)
    for ch in chunks:
        offsets.append(at)
        at += len(ch)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks))


@pytest.mark.parametrize("compression,ptype", [(0, 1), (0, 2), (3, 1), (3, 2)])
def test_read_exr_compressions_and_types(tmp_path, compression, ptype):
    img = _image((21, 11, 3), compression + ptype)
    path = str(tmp_path / "x.exr")
    _write_exr_raw(path, [img[..., c] for c in range(3)], compression, ptype)
    a, b = timage.read_exr(path), jimage.read_exr(path)
    np.testing.assert_array_equal(a, b)
    want = img.astype(np.float16).astype(np.float32) if ptype == 1 else img
    np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("nx,ny,mx", [(16, 16, 1000), (13, 7, 1000), (9, 22, 1 << 15),
                                      (32, 5, 1 << 15), (1, 1, 5)])
def test_wav_2d_decode(nx, ny, mx):
    buf = np.random.default_rng(nx * ny + mx).integers(0, min(mx, 1 << 16), (ny, nx),
                                                        dtype=np.uint16)
    np.testing.assert_array_equal(tpiz.wav_2d_decode(buf.copy(), nx, ny, mx),
                                  jpiz.wav_2d_decode(buf.copy(), nx, ny, mx))


@pytest.mark.parametrize("ext", ["exr", "pfm", "png"])
def test_imwrite_imread(tmp_path, ext):
    img = np.clip(_image((6, 9, 3), 11), 0, 1)
    if ext == "png":
        pytest.importorskip("PIL")
    timage.imwrite(str(tmp_path / f"t.{ext}"), img)
    jimage.imwrite(str(tmp_path / f"j.{ext}"), img)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(timage.imread(str(tmp_path / f"t.{ext}")),
                                  jimage.imread(str(tmp_path / f"j.{ext}")))
    np.testing.assert_array_equal(timage.imread1(str(tmp_path / f"t.{ext}")),
                                  jimage.imread1(str(tmp_path / f"j.{ext}")))


def test_pillow_only_in_the_ldr_branches():
    """core/image.py imports PIL only inside the LDR branches of imread
    and imwrite: the card's machine has no Pillow."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(timage))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            pil = [n for n in ast.walk(node) if isinstance(n, ast.ImportFrom)
                   and n.module == "PIL"]
            assert len(pil) == (node.name in ("imread", "imwrite")), node.name
    assert not any(isinstance(n, (ast.Import, ast.ImportFrom)) and "PIL" in ast.dump(n)
                   for n in tree.body)
