"""Native host-runtime tests (C++ imageio via ctypes vs Python fallbacks)."""

import numpy as np
import pytest

from rays1bench.runtime import native
from rays1bench.scene import tga


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.skip("g++ unavailable; native runtime not built")


def test_tonemap_matches_reference_formula():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.4, size=(37, 53, 3)).astype(np.float32)
    out = native.tonemap_u8(x)
    exp = (np.sqrt(np.clip(x, 0, 1)) * 255.99).astype(np.uint8)
    np.testing.assert_array_equal(out, exp)


def test_accumulate_mean():
    rng = np.random.default_rng(1)
    shards = [rng.normal(size=(1000,)).astype(np.float32) for _ in range(5)]
    out = native.accumulate_mean(shards)
    np.testing.assert_allclose(out, np.mean(shards, axis=0), rtol=1e-6)


def test_tga_roundtrip_and_python_compat(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(45, 67, 3), dtype=np.uint8)
    p_native = str(tmp_path / "native.tga")
    p_python = str(tmp_path / "python.tga")
    native.tga_write_rgb24(p_native, img)
    tga.write_rgb24(p_python, img)
    with open(p_native, "rb") as a, open(p_python, "rb") as b:
        assert a.read() == b.read()       # byte-identical encoders
    np.testing.assert_array_equal(native.tga_read_rgb24(p_native), img)
    np.testing.assert_array_equal(tga.read_rgb24(p_native), img)


def test_tga_reads_reference_golden(golden_dir):
    ref = tga.read_rgb24(str(golden_dir / "latest_quick_small.tga"))
    nat = native.tga_read_rgb24(str(golden_dir / "latest_quick_small.tga"))
    np.testing.assert_array_equal(ref, nat)
