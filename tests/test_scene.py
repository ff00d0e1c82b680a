"""Scene builder tests: the three scenes match the reference's definitions
(rayweek1.cpp:552-719) at the data level."""

import numpy as np

from rays1bench.scene import builders
from rays1bench.scene.crt_colors import CRT_COLOR_BYTES
from rays1bench.scene.spheres import LAMBERTIAN, METAL, DIELECTRIC

ASPECT = 1280.0 / 720.0


def _real(scene):
    r = np.asarray(scene.spheres.radius)
    return r != 0


def test_small_scene():
    s = builders.create_small_scene(ASPECT)
    assert s.spheres.count == 128          # 5 padded to 128
    assert _real(s).sum() == 5
    r = np.asarray(s.spheres.radius)
    # Hollow glass inner sphere keeps its negative radius (rayweek1.cpp:572).
    assert np.isclose(r[4], -0.45)
    mt = np.asarray(s.spheres.mat_type)[:5]
    assert list(mt) == [LAMBERTIAN, LAMBERTIAN, METAL, DIELECTRIC, DIELECTRIC]
    assert s.camera.vfov == 60.0 and s.camera.focus_dist == 5.0


def test_medium_scene():
    s = builders.create_medium_scene(ASPECT)
    assert _real(s).sum() == 46            # rayweek1.cpp:590 reserve(46+...)
    mt = np.asarray(s.spheres.mat_type)[:46]
    assert (mt == DIELECTRIC).sum() == 1   # one glass sphere (rayweek1.cpp:597)
    assert (mt == METAL).sum() == 4 + 9 + 9 + 1
    # Last added sphere (rayweek1.cpp:648): lambertian blue-ish at (1.5,1.5,-2).
    assert np.isclose(np.asarray(s.spheres.center_x)[45], 1.5)
    assert np.isclose(np.asarray(s.spheres.albedo_z)[45], 0.5)
    assert np.isclose(s.camera.aperture, 0.02)


def test_large_scene():
    s = builders.create_large_scene(ASPECT)
    assert _real(s).sum() == 484           # 30*16 + ground + 3 big
    assert s.spheres.count == 512
    mt = np.asarray(s.spheres.mat_type)
    cx = np.asarray(s.spheres.center_x)
    cy = np.asarray(s.spheres.center_y)
    # Material pattern over the grid (rayweek1.cpp:683-696).
    for i in [0, 20, 40]:
        assert mt[i] == DIELECTRIC
    for i in [10, 30, 50]:
        assert mt[i] == METAL
        assert np.isclose(cy[i], 0.1)      # metals raised +0.1 in y
    for i in [1, 2, 11]:
        assert mt[i] == LAMBERTIAN
    # Grid colors come from the CRT rand table (rayweek1.cpp:676-678).
    ax = np.asarray(s.spheres.albedo_x)
    assert np.isclose(ax[1], CRT_COLOR_BYTES[3] / 255.0)
    # Ground sphere (rayweek1.cpp:708).
    assert np.isclose(np.asarray(s.spheres.radius)[480], 1000.0)
    assert np.isclose(cy[480], -1000.5)
    # Big glass sphere (rayweek1.cpp:711).
    assert mt[482] == DIELECTRIC and np.isclose(np.asarray(s.spheres.radius)[482], 2.0)
    # Dielectric grid spheres have the i-dependent index (rayweek1.cpp:686).
    ri = np.asarray(s.spheres.ref_idx)
    assert np.isclose(ri[20], 1.2 + 20 * 0.05)


def test_crt_color_table_head():
    """First draws of glibc rand() after srand(111) — pinned so a regenerated
    table can't silently drift."""
    assert CRT_COLOR_BYTES[:6] == (197, 69, 151, 81, 238, 221)
