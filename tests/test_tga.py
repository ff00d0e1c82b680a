"""TGA I/O tests (scene/tga.py vs the reference writer common.h:80-122)."""

import numpy as np

from rays1bench.scene import tga


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    path = str(tmp_path / "t.tga")
    tga.write_rgb24(path, img)
    back = tga.read_rgb24(path)
    np.testing.assert_array_equal(img, back)


def test_write_does_not_mutate(tmp_path):
    img = np.full((4, 4, 3), 7, dtype=np.uint8)
    img[0, 0] = (1, 2, 3)
    copy = img.copy()
    tga.write_rgb24(str(tmp_path / "t.tga"), img)
    np.testing.assert_array_equal(img, copy)  # unlike common.h:86 (in-place swap)


def test_reads_reference_golden(golden_dir):
    """Our reader parses the reference binary's own output byte-exactly."""
    img = tga.read_rgb24(str(golden_dir / "latest_quick_small.tga"))
    assert img.shape == (60, 80, 3)
    assert img.dtype == np.uint8
    # Sky in the top rows: blue channel dominates.
    top = img[-5:].reshape(-1, 3).mean(axis=0)
    assert top[2] > top[0]


def test_header_matches_reference_writer(golden_dir, tmp_path):
    """Writing a reference-read image back reproduces identical bytes."""
    src = str(golden_dir / "latest_quick_small.tga")
    img = tga.read_rgb24(src)
    out = str(tmp_path / "copy.tga")
    tga.write_rgb24(out, img)
    with open(src, "rb") as f:
        a = f.read()
    with open(out, "rb") as f:
        b = f.read()
    assert a == b
