"""Image files: binary PPM (P6) output, PNG output and read-back.

PPM parity with the reference writer (include/static.cpp:135-147): rows are
written from j = height-1 down to 0 (vertical flip) and channels are
clamped to [0,1] then scaled by 255.
"""

from __future__ import annotations

import numpy as np


def to_uint8(image: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float image as binary P6 PPM, vertically flipped
    like the reference (static.cpp:135-147)."""
    data = to_uint8(image)[::-1]  # rows j = H-1 .. 0
    h, w = data.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6 {w} {h} 255\n".encode())
        fh.write(data.tobytes())


def write_png(path: str, image: np.ndarray, flip: bool = True) -> None:
    """Write an (H, W, 3) float image as PNG (pure-python, zlib-based)."""
    import struct
    import zlib

    data = to_uint8(image)
    if flip:
        data = data[::-1]
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[row].tobytes() for row in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", header))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as write_png writes it -> (H, W, 3) uint8.

    Rows come back in file order (top row first), i.e. the vertically
    flipped array that write_png(flip=True) stored.
    """
    import struct
    import zlib

    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    w = h = ch = None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or color not in (2, 6) or interlace:
                raise ValueError(f"{path}: only 8-bit RGB/RGBA "
                                 f"non-interlaced PNGs are supported")
            ch = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only unfiltered scanlines (as write_png "
                         f"writes them) are supported")
    return raw[:, 1:].reshape(h, w, ch)[..., :3].copy()


def write_image(path: str, image: np.ndarray) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, image)
    elif path.endswith(".png"):
        write_png(path, image)
    else:
        raise ValueError(f"unsupported image format: {path}")
