"""The port's TIFF reader and writer (``msid_tpu_torch/data/tiff.py``) and
the restore CLI's scene I/O against the JAX package's, on the CPU.

Bit for bit, no tolerance: the same bytes must decode to the same array.
A file written by either package's ``write_tiff`` reads back equal
through both readers, and the two writers write the same bytes; files in
the layouts GDAL writes (big endian, tiles, planar bands, Deflate,
PackBits, the horizontal predictor) are written here by a small encoder
and decoded by both readers to the array they were made from."""

import struct
import zlib

import numpy as np
import pytest

from msid_tpu.data.tiff import read_tiff as jax_read_tiff
from msid_tpu.data.tiff import write_tiff as jax_write_tiff
from msid_tpu_torch.data.tiff import read_tiff, write_tiff
from msid_tpu_torch.scripts.restore import AUTO_STREAM_PIXELS, load_scene, save_scene
from scripts.restore import AUTO_STREAM_PIXELS as JAX_AUTO_STREAM_PIXELS
from scripts.restore import load_scene as jax_load_scene
from scripts.restore import save_scene as jax_save_scene


def sample(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 1, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype,shape", [
    (np.uint16, (64, 64, 13)),     # a EuroSAT-MS tile
    (np.float32, (32, 16, 3)),
    (np.float16, (16, 24, 13)),    # what --output-dtype float16 writes
    (np.uint8, (40, 56, 1)),
    (np.int16, (7, 9, 2)),
    (np.int32, (5, 3, 4)),
])
def test_either_writer_reads_back_equal_through_both_readers(tmp_path, dtype, shape):
    img = sample(dtype, shape)
    ours, theirs = tmp_path / "ours.tif", tmp_path / "theirs.tif"
    write_tiff(ours, img)
    jax_write_tiff(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours, theirs):
        for read in (read_tiff, jax_read_tiff):
            back = read(path)
            assert back.dtype == img.dtype and back.shape == img.shape
            assert np.array_equal(back, img)


def test_a_2d_array_gets_a_band_axis(tmp_path):
    img = sample(np.uint16, (12, 10))
    write_tiff(tmp_path / "g.tif", img)
    assert np.array_equal(read_tiff(tmp_path / "g.tif"), img[:, :, None])


def test_pil_written_file_reads_as_pil_wrote_it(tmp_path):
    """Cross-check the reader against PIL on a PIL-written file."""
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 255, (40, 56), dtype=np.uint8)
    p = tmp_path / "gray.tif"
    Image.fromarray(img).save(p)
    assert np.array_equal(read_tiff(p).squeeze(-1), img)
    assert np.array_equal(read_tiff(p), jax_read_tiff(p))


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3+ equal bytes as repeats, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def encode_tiff(path, img, endian="<", tiles=None, planar=False, compression=1,
                predictor=False, rows_per_strip=5):
    """A TIFF of ``img`` [H, W, C] in the named layout: strips of
    ``rows_per_strip`` rows or ``tiles`` (height, width); bands interleaved
    or in planes; compression 8 (Deflate), 32773 (PackBits) or none (any
    other code is written as the tag says, the data left as it is);
    horizontal differencing before it (integers only)."""
    h, w, c = img.shape
    planes = [img[:, :, k:k + 1] for k in range(c)] if planar else [img]
    chunks = []
    for plane in planes:
        if tiles:
            tl, tw = tiles
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    block = np.zeros((tl, tw, plane.shape[2]), img.dtype)
                    part = plane[y:y + tl, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(block)
        else:
            chunks += [plane[y:y + rows_per_strip] for y in range(0, h, rows_per_strip)]
    if predictor:                                    # each chunk's rows from their left edge
        chunks = [np.concatenate([ch[:, :1], ch[:, 1:] - ch[:, :-1]], axis=1)
                  for ch in chunks]                  # wraps in the integer dtype
    raw = [np.ascontiguousarray(ch.astype(img.dtype.newbyteorder(endian))).tobytes()
           for ch in chunks]
    raw = [zlib.compress(r) if compression == 8 else packbits(r) if compression == 32773
           else r for r in raw]
    fmt = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [img.dtype.itemsize * 8] * c),
            259: (3, [compression]), 262: (3, [1]), 277: (3, [c]), 284: (3, [2 if planar else 1]),
            339: (3, [fmt] * c)}
    if predictor:
        tags[317] = (3, [2])
    if tiles:
        tags.update({322: (3, [tiles[1]]), 323: (3, [tiles[0]]), 324: (4, [0] * len(raw)),
                     325: (4, [len(r) for r in raw])})
        offsets_tag = 324
    else:
        tags.update({273: (4, [0] * len(raw)), 278: (4, [rows_per_strip]),
                     279: (4, [len(r) for r in raw])})
        offsets_tag = 273
    sizes = {3: ("H", 2), 4: ("I", 4)}
    ifd_size = 2 + 12 * len(tags) + 4
    extra_at = 8 + ifd_size
    extra_len = sum(sizes[t][1] * len(v) for t, v in tags.values()
                    if sizes[t][1] * len(v) > 4)
    data_at = extra_at + extra_len
    offsets = list(np.cumsum([0] + [len(r) for r in raw[:-1]]) + data_at)
    tags[offsets_tag] = (4, [int(o) for o in offsets])
    entries, extra = bytearray(), bytearray()
    for tid in sorted(tags):
        typ, values = tags[tid]
        code, size = sizes[typ]
        packed = struct.pack(endian + code * len(values), *values)
        if len(packed) <= 4:
            entries += struct.pack(endian + "HHI", tid, typ, len(values)) + packed.ljust(4, b"\0")
        else:
            entries += struct.pack(endian + "HHII", tid, typ, len(values), extra_at + len(extra))
            extra += packed
    magic = b"II" if endian == "<" else b"MM"
    out = magic + struct.pack(endian + "HI", 42, 8) + struct.pack(endian + "H", len(tags))
    out += bytes(entries) + struct.pack(endian + "I", 0) + bytes(extra) + b"".join(raw)
    path.write_bytes(out)


@pytest.mark.parametrize("layout", [
    dict(endian=">"),
    dict(tiles=(16, 16)),
    dict(tiles=(16, 32), planar=True),
    dict(planar=True),
    dict(compression=8),
    dict(compression=32773),
    dict(compression=8, predictor=True),
    dict(endian=">", tiles=(16, 16), compression=32773, predictor=True),
    dict(planar=True, compression=8, predictor=True),
])
def test_gdal_layouts_decode_to_the_array_in_both_readers(tmp_path, layout):
    img = sample(np.uint16, (37, 45, 13), seed=3)
    img[10:20] = 7                                   # runs for PackBits to repeat
    p = tmp_path / "scene.tif"
    encode_tiff(p, img, **layout)
    ours, theirs = read_tiff(p), jax_read_tiff(p)
    assert ours.dtype == np.uint16 and np.array_equal(ours, img)
    assert np.array_equal(theirs, img)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_big_endian_samples_of_each_kind(tmp_path, dtype):
    img = sample(dtype, (9, 11, 3), seed=4)
    encode_tiff(tmp_path / "be.tif", img, endian=">", compression=8)
    ours = read_tiff(tmp_path / "be.tif")
    assert ours.dtype == np.dtype(dtype) and np.array_equal(ours, img)
    assert np.array_equal(ours, jax_read_tiff(tmp_path / "be.tif"))


def test_not_a_tiff_and_an_unknown_compression_raise(tmp_path):
    (tmp_path / "x.tif").write_bytes(b"GIF89a" + bytes(16))
    for read in (read_tiff, jax_read_tiff):
        with pytest.raises(ValueError, match="Not a TIFF"):
            read(tmp_path / "x.tif")
    encode_tiff(tmp_path / "lzw.tif", sample(np.uint16, (4, 4, 1)), compression=5)
    for read in (read_tiff, jax_read_tiff):
        with pytest.raises(NotImplementedError, match="compression 5"):
            read(tmp_path / "lzw.tif")


@pytest.mark.parametrize("suffix,dtype", [(".tif", np.uint16), (".npy", np.float32),
                                          (".tiff", np.float16)])
def test_scene_io_equals_the_jax_clis(tmp_path, suffix, dtype):
    scene = sample(dtype, (40, 50, 13), seed=5)
    ours, theirs = tmp_path / f"ours{suffix}", tmp_path / f"theirs{suffix}"
    save_scene(str(ours), scene)
    jax_save_scene(str(theirs), scene)
    assert ours.read_bytes() == theirs.read_bytes()
    for load in (load_scene, jax_load_scene):
        back = load(str(ours))
        assert back.dtype == scene.dtype and np.array_equal(back, scene)
    np.save(tmp_path / "g.npy", scene[:, :, 0])
    assert load_scene(str(tmp_path / "g.npy")).shape == (40, 50, 1)


def test_scene_io_rejects_unknown_formats_as_the_jax_cli(tmp_path):
    np.save(tmp_path / "bad.npy", np.zeros((2, 3, 4, 5)))
    for load, save in ((load_scene, save_scene), (jax_load_scene, jax_save_scene)):
        with pytest.raises(SystemExit, match="unsupported input"):
            load(str(tmp_path / "scene.jp2"))
        with pytest.raises(SystemExit, match="unsupported output"):
            save(str(tmp_path / "scene.jp2"), np.zeros((4, 4, 2)))
        with pytest.raises(SystemExit, match="H,W,C"):
            load(str(tmp_path / "bad.npy"))


def test_auto_stream_threshold_is_the_jax_clis():
    assert AUTO_STREAM_PIXELS == JAX_AUTO_STREAM_PIXELS
    assert 10980 * 10980 > AUTO_STREAM_PIXELS > 1024 * 1024
