"""PIZ decompression for OpenEXR (Huffman + 2D wavelet); a numpy copy of
gdpt_tpu/core/exr_piz.py.

A self-contained Python implementation of the PIZ scheme used by OpenEXR
(bitmap-based value LUT, canonical Huffman coding of 16-bit symbols with
a run-length escape, and a reversible 2D wavelet per channel). Needed to
read reference scene assets (e.g. scenes/matpreview/envmap.exr).
"""

import struct

import numpy as np

HUF_DECBITS = 14
HUF_ENCSIZE = (1 << 16) + 1

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def get_bits(self, n):
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(reader, im, i_m):
    """6-bit packed code lengths with zero-run escapes -> canonical codes."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= i_m:
        l = reader.get_bits(6)
        if l == _LONG_ZEROCODE_RUN:
            i += reader.get_bits(8) + _SHORTEST_LONG_RUN
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    # Partial byte at the end of the table is discarded (the encoder pads).
    reader.c = 0
    reader.lc = 0
    return _canonical_code_table(lengths)


def _canonical_code_table(lengths):
    """lengths -> packed (code << 6) | length (OpenEXR ImfHuf.cpp)."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    n[0] = 0
    c = 0
    start = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        start[i] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    counters = start.copy()
    nz = np.nonzero(lengths)[0]
    for i in nz:
        l = lengths[i]
        hcode[i] = l | (counters[l] << 6)
        counters[l] += 1
    return hcode


def _huf_decode(hcode, reader, n_bits, rlc, n_out):
    """Decode n_out 16-bit symbols; table-accelerated for codes up to
    HUF_DECBITS bits, linear search for longer codes."""
    fast_len = np.zeros(1 << HUF_DECBITS, np.int32)
    fast_lit = np.zeros(1 << HUF_DECBITS, np.int32)
    long_codes = {}
    nz = np.nonzero(hcode & 63)[0]
    for sym in nz:
        packed = int(hcode[sym])
        l = packed & 63
        code = packed >> 6
        if l <= HUF_DECBITS:
            base = code << (HUF_DECBITS - l)
            fast_len[base : base + (1 << (HUF_DECBITS - l))] = l
            fast_lit[base : base + (1 << (HUF_DECBITS - l))] = sym
        else:
            long_codes.setdefault(code >> (l - HUF_DECBITS), []).append(
                (sym, l, code)
            )

    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    data = reader.data
    pos = reader.pos
    end_pos = pos + (n_bits + 7) // 8
    fl = fast_len
    fi = fast_lit
    mask = (1 << HUF_DECBITS) - 1

    while pos < end_pos and oi < n_out:
        c = ((c << 8) | data[pos]) & ((1 << (lc + 8)) - 1)
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS and oi < n_out:
            idx = (c >> (lc - HUF_DECBITS)) & mask
            l = int(fl[idx])
            if l:
                lc -= l
                sym = int(fi[idx])
            else:
                sym = -1
                for s, cl, code in long_codes.get(idx, ()):
                    while lc < cl and pos < end_pos:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= cl and ((c >> (lc - cl)) & ((1 << cl) - 1)) == code:
                        lc -= cl
                        sym = s
                        break
                if sym < 0:
                    raise ValueError("PIZ: invalid huffman code")
            if sym == rlc:
                while lc < 8:
                    c = (c << 8) | data[pos]
                    pos += 1
                    lc += 8
                lc -= 8
                cs = (c >> lc) & 0xFF
                out[oi : oi + cs] = out[oi - 1]
                oi += cs
            else:
                out[oi] = sym
                oi += 1

    # Flush the final partial byte (OpenEXR discards the pad bits).
    i = (8 - n_bits) & 7
    c >>= i
    lc -= i
    while lc > 0 and oi < n_out:
        idx = (c << (HUF_DECBITS - lc)) & mask
        l = int(fl[idx])
        if l and l <= lc:
            lc -= l
            sym = int(fi[idx])
            if sym == rlc:
                raise ValueError("PIZ: RLE in terminal bits")
            out[oi] = sym
            oi += 1
        else:
            break
    if oi != n_out:
        raise ValueError(f"PIZ: decoded {oi} of {n_out} symbols")
    return out


def huf_uncompress(data, n_out):
    im, i_m, _table_len, n_bits, _room = struct.unpack_from("<IIIII", data, 0)
    reader = _BitReader(data, 20)
    hcode = _unpack_enc_table(reader, im, i_m)
    return _huf_decode(hcode, reader, n_bits, i_m, n_out)


# ---------------------------------------------------------------------------
# 2D wavelet (ImfWav.cpp wav2Decode), vectorized over blocks per level
# ---------------------------------------------------------------------------

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hs = h.astype(np.int16).astype(np.int64)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def wav_2d_decode(buf, nx, ny, mx):
    """In-place inverse 2D wavelet on a (ny, nx) uint16 array."""
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2) if ny - p2 >= 0 else np.arange(0)
        xs = np.arange(0, nx - p2 + 1, p2) if nx - p2 >= 0 else np.arange(0)
        if len(ys) and len(xs):
            y0 = ys[:, None]
            x0 = xs[None, :]
            # Vertical pairs first, then horizontal (inverse of encode).
            i00, i10 = wdec(buf[y0, x0], buf[y0 + p, x0])
            i01, i11 = wdec(buf[y0, x0 + p], buf[y0 + p, x0 + p])
            o00, o01 = wdec(i00, i01)
            o10, o11 = wdec(i10, i11)
            buf[y0, x0] = o00
            buf[y0, x0 + p] = o01
            buf[y0 + p, x0] = o10
            buf[y0 + p, x0 + p] = o11
        if (nx & p) and len(ys):
            # Odd trailing column: vertical-only pairs.
            xe = (xs[-1] + p2) if len(xs) else 0
            if xe < nx:
                a, b = wdec(buf[ys, xe], buf[ys + p, xe])
                buf[ys, xe] = a
                buf[ys + p, xe] = b
        if (ny & p) and len(xs):
            # Odd trailing row: horizontal-only pairs.
            ye = (ys[-1] + p2) if len(ys) else 0
            if ye < ny:
                a, b = wdec(buf[ye, xs], buf[ye, xs + p])
                buf[ye, xs] = a
                buf[ye, xs + p] = b
        p2 = p
        p >>= 1
    return buf


# ---------------------------------------------------------------------------
# PIZ chunk
# ---------------------------------------------------------------------------


def piz_uncompress(raw, channels_sorted, nx, ny, dtypes):
    """Decompress one PIZ chunk into the standard scanline layout
    (per line, per channel). channels_sorted: [(name, ptype)] in file
    order; dtypes maps ptype -> numpy dtype."""
    min_nz, max_nz = struct.unpack_from("<HH", raw, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(raw[pos : pos + count], np.uint8)
        pos += count
    bits = np.unpackbits(bitmap, bitorder="little")
    # Value 0 is always present implicitly (OpenEXR reverseLutFromBitmap).
    bits[0] = 1
    lut_small = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(lut_small) - 1
    lut = np.zeros(1 << 16, np.uint16)
    lut[: len(lut_small)] = lut_small

    (huf_len,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    sizes = [np.dtype(dtypes[pt]).itemsize // 2 for _, pt in channels_sorted]
    n_u16 = sum(nx * ny * s for s in sizes)
    decoded = huf_uncompress(raw[pos : pos + huf_len], n_u16)

    planes = []
    off = 0
    for (name, ptype), size in zip(channels_sorted, sizes):
        plane = decoded[off : off + nx * ny * size].copy()
        off += nx * ny * size
        for j in range(size):
            sub = np.ascontiguousarray(plane[j::size].reshape(ny, nx))
            wav_2d_decode(sub, nx, ny, max_value)
            plane[j::size] = sub.ravel()
        planes.append(lut[plane])

    out = bytearray()
    for y in range(ny):
        for plane, size in zip(planes, sizes):
            out += plane[y * nx * size : (y + 1) * nx * size].tobytes()
    return bytes(out)
