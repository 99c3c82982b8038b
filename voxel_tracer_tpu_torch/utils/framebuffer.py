"""Surface: CPU framebuffer + image IO (template/surface.{h,cpp} analog).

The reference blits a u32 CPU framebuffer to OpenGL each frame
(template/template.cpp:327-356); headless rendering writes PNGs instead.
The drawing helpers (line / box / bar / print) mirror Surface's API for the
debug-draw overlay and the HUD.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 5x8 bitmap glyphs for the HUD print() (Surface::Print analog) — digits,
# uppercase and a few symbols, each row a 5-bit mask.
_GLYPHS = {}


def _def_glyph(ch, rows):
    _GLYPHS[ch] = np.array(
        [[(r >> (4 - c)) & 1 for c in range(5)] for r in rows], np.uint8)


for ch, rows in {
    "0": [0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E, 0x00],
    "1": [0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E, 0x00],
    "2": [0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F, 0x00],
    "3": [0x0E, 0x11, 0x01, 0x06, 0x01, 0x11, 0x0E, 0x00],
    "4": [0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02, 0x00],
    "5": [0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E, 0x00],
    "6": [0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E, 0x00],
    "7": [0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08, 0x00],
    "8": [0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E, 0x00],
    "9": [0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C, 0x00],
    ".": [0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C, 0x00],
    ":": [0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00, 0x00],
    " ": [0] * 8,
    "-": [0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00, 0x00],
    "F": [0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10, 0x00],
    "P": [0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10, 0x00],
    "S": [0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E, 0x00],
    "M": [0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11, 0x00],
    "R": [0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11, 0x00],
    "A": [0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11, 0x00],
    "Y": [0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04, 0x00],
    "C": [0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E, 0x00],
    "O": [0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E, 0x00],
    "E": [0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F, 0x00],
    "G": [0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F, 0x00],
    "V": [0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04, 0x00],
    "X": [0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11, 0x00],
    "L": [0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F, 0x00],
    "T": [0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04, 0x00],
    "N": [0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11, 0x00],
    "U": [0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E, 0x00],
    "I": [0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E, 0x00],
    "D": [0x1E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x1E, 0x00],
    "B": [0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E, 0x00],
    "H": [0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11, 0x00],
    "W": [0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11, 0x00],
    "K": [0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11, 0x00],
}.items():
    _def_glyph(ch, rows)


class Surface:
    """RGB8 framebuffer with simple raster ops (surface.h:48-78 analog)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.pixels = np.zeros((height, width, 3), np.uint8)

    def clear(self, color=(0, 0, 0)):
        self.pixels[:] = np.asarray(color, np.uint8)

    def from_float(self, img):
        """Set from a (H, W, 3) float [0,1] image."""
        self.pixels = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        self.height, self.width = self.pixels.shape[:2]
        return self

    def plot(self, x, y, color):
        if 0 <= x < self.width and 0 <= y < self.height:
            self.pixels[int(y), int(x)] = color

    def line(self, x0, y0, x1, y1, color):
        """Bresenham line (Surface::Line analog)."""
        x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
        dx, dy = abs(x1 - x0), -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        while True:
            self.plot(x0, y0, color)
            if x0 == x1 and y0 == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x0 += sx
            if e2 <= dx:
                err += dx
                y0 += sy

    def box(self, x0, y0, x1, y1, color):
        self.line(x0, y0, x1, y0, color)
        self.line(x1, y0, x1, y1, color)
        self.line(x1, y1, x0, y1, color)
        self.line(x0, y1, x0, y0, color)

    def bar(self, x0, y0, x1, y1, color):
        x0, x1 = max(0, int(x0)), min(self.width, int(x1) + 1)
        y0, y1 = max(0, int(y0)), min(self.height, int(y1) + 1)
        self.pixels[y0:y1, x0:x1] = color

    def print(self, text, x, y, color=(255, 255, 255), scale=1):
        """Bitmap text (Surface::Print analog) — used by the headless HUD."""
        cx = int(x)
        for ch in str(text).upper():
            glyph = _GLYPHS.get(ch)
            if glyph is not None:
                for gy in range(8):
                    for gx in range(5):
                        if glyph[gy, gx]:
                            self.bar(cx + gx * scale, int(y) + gy * scale,
                                     cx + gx * scale + scale - 1,
                                     int(y) + gy * scale + scale - 1, color)
            cx += 6 * scale

    def save_png(self, path: str):
        write_png(path, self.pixels)


def write_png(path: str, img: np.ndarray):
    """Minimal dependency-free PNG writer (8-bit RGB)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        c = tag + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA/gray, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitdepth, coltype = struct.unpack_from(">IIBB", payload)[:4]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    assert bitdepth == 8, "only 8-bit PNGs supported"
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[coltype]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ft == 1:  # sub
            for i in range(channels, stride):
                row[i] = (row[i] + row[i - channels]) & 0xFF
        elif ft == 2:  # up
            row = (row + prev) & 0xFF
        elif ft == 3:  # average
            for i in range(stride):
                left = row[i - channels] if i >= channels else 0
                row[i] = (row[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for i in range(stride):
                a = int(row[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        prev = row
        out[y] = row
    return out.reshape(h, w, channels)
