"""The port's PNG codec (``polyphonicformer_torch/data/png.py`` and the
native unfilter of ``polyphonicformer_torch/native/png_unfilter.cpp``)
against cv2 and PIL, which the CPU test environment has and the port's
card environment does not.

``read_png`` must equal ``cv2.imread(..., IMREAD_UNCHANGED)`` bit for bit
(cv2 orders colour channels BGR, ``read_png`` as stored) and ``imread_rgb``
``cv2.cvtColor(cv2.imread(..., IMREAD_COLOR), BGR2RGB)``, on files cv2 and
PIL wrote and on files ``write_png`` wrote with each filter type.  The
native unfilter must equal the numpy plain version.  The last test decodes
and evaluates a split with ``cv2`` and ``PIL`` unimportable.
"""
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from polyphonicformer_torch.data import png
from polyphonicformer_torch.ops import native

# (dtype, channels) of every sample layout write_png takes: bytes a pixel 1-8
LAYOUTS = {1: (np.uint8, 1), 2: (np.uint16, 1), 3: (np.uint8, 3), 4: (np.uint8, 4),
           6: (np.uint16, 3), 8: (np.uint16, 4)}


def _random(rng, h, w, bpp):
    dtype, ch = LAYOUTS[bpp]
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _cv2_unchanged(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:  # BGR(A) -> RGB(A)
        img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]
    return img


def _assert_like_cv2(path):
    got = png.read_png(str(path))
    want = _cv2_unchanged(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    rgb = png.imread_rgb(str(path))
    want_rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb, want_rgb)
    return got


@pytest.mark.parametrize("level", range(10))
def test_read_png_matches_cv2_written_by_cv2(tmp_path, level):
    rng = np.random.RandomState(level)
    for bpp in (1, 2, 3, 4, 6):
        arr = _random(rng, 23 + level, 41, bpp)
        # smooth rows too, so libpng's adaptive filter picks Sub/Up/Average/Paeth
        if arr.ndim == 3:
            arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
        path = tmp_path / f"cv2_{bpp}.png"
        bgr = arr[:, :, [2, 1, 0, 3][:arr.shape[2]]] if arr.ndim == 3 else arr
        assert cv2.imwrite(str(path), bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(_assert_like_cv2(path), arr)


@pytest.mark.parametrize("kind", ["palette2", "palette4", "palette16", "palette200", "rgba",
                                  "gray16", "rgb", "gray1"])
def test_read_png_matches_cv2_written_by_pil(tmp_path, kind):
    """PIL with optimize=True: palettes of <= 16 colours are written at 1, 2
    or 4 bits, mode '1' as 1-bit grey."""
    rng = np.random.RandomState(len(kind))
    path = tmp_path / f"{kind}.png"
    if kind.startswith("palette"):
        n = int(kind[len("palette"):])
        im = Image.fromarray(rng.randint(0, n, (19, 31)).astype(np.uint8), mode="P")
        im.putpalette(rng.randint(0, 256, 3 * n).tolist())
    elif kind == "rgba":
        im = Image.fromarray(rng.randint(0, 256, (19, 31, 4)).astype(np.uint8), mode="RGBA")
    elif kind == "gray16":
        im = Image.fromarray(rng.randint(0, 65536, (19, 31)).astype(np.uint16))
    elif kind == "rgb":
        im = Image.fromarray(np.cumsum(rng.randint(0, 9, (19, 31, 3)), axis=1).astype(np.uint8))
    else:
        im = Image.fromarray(rng.rand(19, 31) > 0.5)
    im.save(path, optimize=True)
    _assert_like_cv2(path)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 37), w=st.integers(1, 53), bpp=st.sampled_from(sorted(LAYOUTS)),
       filter_type=st.integers(0, 4), level=st.integers(0, 9), seed=st.integers(0, 2 ** 16))
def test_write_png_reads_back_like_cv2(tmp_path_factory, h, w, bpp, filter_type, level, seed):
    """write_png -> read_png is the identity, and cv2 reads the same file the
    same way; cv2's own file of the same array reads the same too."""
    arr = _random(np.random.RandomState(seed), h, w, bpp)
    d = tmp_path_factory.mktemp("hyp")
    path = d / "ours.png"
    png.write_png(str(path), arr, level=level, filter_type=filter_type)
    np.testing.assert_array_equal(_assert_like_cv2(path), arr)
    bgr = arr[:, :, [2, 1, 0, 3][:arr.shape[2]]] if arr.ndim == 3 else arr
    assert cv2.imwrite(str(d / "cv2.png"), bgr)
    np.testing.assert_array_equal(png.read_png(str(d / "cv2.png")), arr)


@pytest.mark.parametrize("bpp", range(1, 9))
def test_native_unfilter_matches_plain(bpp):
    """Random rows of random filter types (0-4), row lengths that are and are
    not multiples of bpp, against the numpy plain version."""
    rng = np.random.RandomState(bpp)
    for row_bytes in (1, bpp, 3 * bpp + 1, 97):
        rows = 12
        raw = rng.randint(0, 256, (rows, row_bytes + 1)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, rows)
        raw[0, 0], raw[1, 0], raw[2, 0], raw[3, 0], raw[4, 0] = 4, 3, 2, 1, 0
        got = native.png_unfilter(raw.reshape(-1), rows, row_bytes, bpp)
        want = png.unfilter_plain(raw.reshape(-1), rows, row_bytes, bpp)
        np.testing.assert_array_equal(got, want, err_msg=f"row_bytes {row_bytes}")


@pytest.mark.parametrize("filter_type", range(5))
def test_filter_rows_inverts(filter_type):
    """write_png's numpy filter and the native unfilter are inverses."""
    rng = np.random.RandomState(filter_type)
    rows = rng.randint(0, 256, (9, 60)).astype(np.uint8)
    raw = png.filter_rows(rows, 3, filter_type)
    assert (raw[:, 0] == filter_type).all()
    np.testing.assert_array_equal(native.png_unfilter(raw.reshape(-1), 9, 60, 3), rows)


def _patched(data: bytes, ctype: bytes, payload: bytes) -> bytes:
    """``data`` with the first chunk of type ``ctype`` given a new payload."""
    pos = 8
    while True:
        length, = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == ctype:
            chunk = (struct.pack(">I", len(payload)) + ctype + payload
                     + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype))))
            return data[:pos] + chunk + data[pos + 12 + length:]
        pos += 12 + length


def _insert_before_idat(data: bytes, ctype: bytes, payload: bytes) -> bytes:
    pos = data.index(b"IDAT") - 4
    chunk = (struct.pack(">I", len(payload)) + ctype + payload
             + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype))))
    return data[:pos] + chunk + data[pos:]


def test_unsupported_and_damaged_files_raise():
    data = png.encode_png(np.zeros((4, 5, 3), np.uint8))
    ihdr = struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 1)  # interlace method 1: Adam7
    with pytest.raises(NotImplementedError, match="Adam7"):
        png.decode_png(_patched(data, b"IHDR", ihdr))
    with pytest.raises(NotImplementedError, match="tRNS"):
        png.decode_png(_insert_before_idat(data, b"tRNS", b"\x00\x00\x00\x00\x00\x00"))
    with pytest.raises(NotImplementedError, match="colour type 4"):
        png.decode_png(_patched(data, b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 4, 0, 0, 0)))
    with pytest.raises(NotImplementedError, match="critical chunk"):
        png.decode_png(_insert_before_idat(data, b"ABCD", b""))
    bad_crc = bytearray(data)
    bad_crc[data.index(b"IDAT") + 6] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + data[6:])
    raw = np.zeros((2, 4), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        native.png_unfilter(raw.reshape(-1), 2, 3, 1)


def test_decodes_and_evaluates_a_split_without_cv2_or_pil(tmp_path, monkeypatch):
    """The machine with the card has neither cv2 nor PIL: with both
    unimportable, the port writes a split, its dataset decodes every frame
    to what the JAX dataset (cv2) decodes, and the image-mode evaluation
    of those frames runs."""
    from polyphonicformer_tpu.data.cityscapes_dvps import CityscapesDVPSDataset as JaxDataset
    from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
    from polyphonicformer_torch.data.synthetic_split import write_dvps_split
    from polyphonicformer_torch.evalutils import evaluate_image

    root = str(tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    write_dvps_split(root, "val", num_seqs=2, frames_per_seq=2, h=48, w=96, filter_type=4)
    ds = CityscapesDVPSDataset(root, split="val", ref_sample_mode="img")
    frames = [ds.load_frame(info) for info in ds.images]
    pans = [f["pan"] for f in frames]
    depths = [f["depth"] for f in frames]
    metrics = evaluate_image(pans, pans, depths, depths)
    monkeypatch.undo()
    from polyphonicformer_tpu.evalutils import evaluate_image as jax_evaluate_image

    assert metrics == jax_evaluate_image(pans, pans, depths, depths)
    assert metrics["pq@inf"] > 0

    jds = JaxDataset(root, split="val", ref_sample_mode="img")
    for info, frame in zip(jds.images, frames):
        want = jds.load_frame(info)
        for key in ("img", "pan", "depth", "masks", "labels", "inst_ids"):
            assert frame[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(frame[key], want[key], err_msg=key)


def test_port_sources_import_no_cv2_or_pil():
    """Not even lazily: no import statement of the port or of chip_smoke.py
    names cv2 or PIL."""
    import pathlib
    import re

    repo = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((repo / "polyphonicformer_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(cv2|PIL)\b")
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert len(files) > 40 and not bad, bad
