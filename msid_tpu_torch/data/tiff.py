"""Multiband TIFF reader and writer (numpy only): counterpart of
``msid_tpu/data/tiff.py``.

Reads the subset of TIFF 6.0 that GDAL writes for Sentinel-2 tiles and
scenes: little or big endian, strips or tiles, contiguous or planar
configuration, no compression, Deflate or PackBits, the horizontal
predictor, 8/16/32-bit integer and 16/32/64-bit float samples. Returns
HWC arrays (band-last, the port's NHWC layout without the batch axis).
``write_tiff`` writes an uncompressed contiguous striped file that
``read_tiff`` reads back bit for bit.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_ifd_entries(data: bytes, offset: int, endian: str):
    (count,) = struct.unpack_from(endian + "H", data, offset)
    entries = {}
    pos = offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", data, pos)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            raw = data[pos + 8 : pos + 8 + size]
        else:
            (value_offset,) = struct.unpack_from(endian + "I", data, pos + 8)
            raw = data[value_offset : value_offset + size]
        fmt = _TYPE_FMT.get(typ)
        if fmt is not None:
            values = struct.unpack(endian + fmt * n, raw[: struct.calcsize(fmt) * n])
            entries[tag] = values
        pos += 12
    return entries


def _unpackbits(data: bytes) -> bytes:
    """PackBits (RLE) decompression."""
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _decompress(chunk: bytes, compression: int) -> bytes:
    if compression == 1:
        return chunk
    if compression in (8, 32946):  # Deflate / zlib
        return zlib.decompress(chunk)
    if compression == 32773:  # PackBits
        return _unpackbits(chunk)
    raise NotImplementedError(f"TIFF compression {compression} not supported")


def read_tiff(path: str | Path) -> np.ndarray:
    """Read the first IFD of a TIFF into an HWC numpy array."""
    data = Path(path).read_bytes()
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"Not a TIFF file: {path}")
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic != 42:
        raise ValueError(f"Unsupported TIFF magic {magic} in {path}")
    (ifd_offset,) = struct.unpack_from(endian + "I", data, 4)
    tags = _read_ifd_entries(data, ifd_offset, endian)

    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    bits = tags.get(_BITS_PER_SAMPLE, (8,))[0]
    compression = tags.get(_COMPRESSION, (1,))[0]
    planar = tags.get(_PLANAR_CONFIG, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    sample_format = tags.get(_SAMPLE_FORMAT, (1,))[0]

    if sample_format == 3:
        dtype = {16: np.float16, 32: np.float32, 64: np.float64}[bits]
    elif sample_format == 2:
        dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    else:
        dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    dtype = np.dtype(dtype).newbyteorder(endian)

    tiled = _TILE_OFFSETS in tags

    if tiled:
        tw, tl = tags[_TILE_WIDTH][0], tags[_TILE_LENGTH][0]
        offsets, counts = tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS]
        tiles_across = (width + tw - 1) // tw
        tiles_down = (height + tl - 1) // tl
        planes = spp if planar == 2 else 1
        chans = 1 if planar == 2 else spp
        img = np.zeros((height, width, spp), dtype=dtype.newbyteorder("="))
        idx = 0
        for plane in range(planes):
            for ty in range(tiles_down):
                for tx in range(tiles_across):
                    raw = _decompress(
                        data[offsets[idx] : offsets[idx] + counts[idx]], compression
                    )
                    tile = np.frombuffer(raw, dtype=dtype, count=tl * tw * chans)
                    tile = tile.reshape(tl, tw, chans)
                    if predictor == 2:
                        tile = np.cumsum(tile.astype(np.int64), axis=1).astype(dtype)
                    y0, x0 = ty * tl, tx * tw
                    y1, x1 = min(y0 + tl, height), min(x0 + tw, width)
                    if planar == 2:
                        img[y0:y1, x0:x1, plane] = tile[: y1 - y0, : x1 - x0, 0]
                    else:
                        img[y0:y1, x0:x1, :] = tile[: y1 - y0, : x1 - x0, :]
                    idx += 1
        return img

    offsets = tags[_STRIP_OFFSETS]
    counts = tags[_STRIP_BYTE_COUNTS]
    rows_per_strip = tags.get(_ROWS_PER_STRIP, (height,))[0]

    if planar == 2:
        # Band-sequential: strips cycle per plane.
        strips_per_plane = (height + rows_per_strip - 1) // rows_per_strip
        planes = []
        idx = 0
        for _ in range(spp):
            rows = []
            for _ in range(strips_per_plane):
                raw = _decompress(data[offsets[idx] : offsets[idx] + counts[idx]], compression)
                rows.append(np.frombuffer(raw, dtype=dtype))
                idx += 1
            plane = np.concatenate(rows)[: height * width].reshape(height, width)
            if predictor == 2:  # horizontal differencing, per row per band
                plane = np.cumsum(plane.astype(np.int64), axis=1).astype(dtype)
            planes.append(plane)
        img = np.stack(planes, axis=-1)
    else:
        raw = b"".join(
            _decompress(data[off : off + cnt], compression)
            for off, cnt in zip(offsets, counts)
        )
        img = np.frombuffer(raw, dtype=dtype, count=height * width * spp)
        img = img.reshape(height, width, spp)
        if predictor == 2:
            img = np.cumsum(img.astype(np.int64), axis=1).astype(dtype)

    return np.ascontiguousarray(img.astype(dtype.newbyteorder("=")))


def write_tiff(path: str | Path, img: np.ndarray) -> None:
    """Write an HWC array as an uncompressed contiguous striped TIFF.

    Used by tests and the synthetic-dataset materializer; round-trips with
    `read_tiff`.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    dtype = img.dtype
    bits = dtype.itemsize * 8
    if dtype.kind == "f":
        sample_format = 3
    elif dtype.kind == "i":
        sample_format = 2
    else:
        sample_format = 1

    pixel_data = np.ascontiguousarray(img.astype(dtype.newbyteorder("<"))).tobytes()

    header = struct.pack("<2sHI", b"II", 42, 8)
    tags = []

    def tag(tid, typ, values):
        tags.append((tid, typ, values))

    tag(_IMAGE_WIDTH, 4, [w])
    tag(_IMAGE_LENGTH, 4, [h])
    tag(_BITS_PER_SAMPLE, 3, [bits] * c)
    tag(_COMPRESSION, 3, [1])
    tag(262, 3, [1])  # PhotometricInterpretation = BlackIsZero
    tag(_STRIP_OFFSETS, 4, [0])  # patched below
    tag(_SAMPLES_PER_PIXEL, 3, [c])
    tag(_ROWS_PER_STRIP, 4, [h])
    tag(_STRIP_BYTE_COUNTS, 4, [len(pixel_data)])
    tag(_PLANAR_CONFIG, 3, [1])
    tag(_SAMPLE_FORMAT, 3, [sample_format] * c)

    num_tags = len(tags)
    ifd_offset = 8
    ifd_size = 2 + num_tags * 12 + 4
    extra_offset = ifd_offset + ifd_size
    extra = bytearray()
    entries = bytearray()

    for tid, typ, values in sorted(tags):
        fmt = _TYPE_FMT[typ]
        size = struct.calcsize(fmt) * len(values)
        if tid == _STRIP_OFFSETS:
            values = [0xDEADBEEF]  # placeholder, patched after layout
        packed = struct.pack("<" + fmt * len(values), *values)
        if size <= 4:
            entries += struct.pack("<HHI", tid, typ, len(values)) + packed.ljust(4, b"\0")
        else:
            entries += struct.pack("<HHII", tid, typ, len(values), extra_offset + len(extra))
            extra += packed

    data_offset = extra_offset + len(extra)
    # Patch the strip offset (it always fits inline).
    out = bytearray(header)
    out += struct.pack("<H", num_tags) + entries + struct.pack("<I", 0)
    out += extra
    # Find and patch StripOffsets entry value in place.
    for i in range(num_tags):
        pos = 8 + 2 + i * 12
        tid = struct.unpack_from("<H", out, pos)[0]
        if tid == _STRIP_OFFSETS:
            struct.pack_into("<I", out, pos + 8, data_offset)
    out += pixel_data
    Path(path).write_bytes(bytes(out))
