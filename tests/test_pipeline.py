"""Pipeline tests: chunk invariance, layout, quantization, and statistical
golden-image comparison against the reference C++ renderer's TGA output."""

import numpy as np
import pytest

from rays1bench.core.config import RenderConfig
from rays1bench.render.pipeline import render_image, render_scene, to_srgb_u8
from rays1bench.scene import builders, tga

# Small + fast: 80x60 like QUICKBENCH, modest bounces for CPU compile time.
CFG = RenderConfig(width=80, height=60, spp=4, max_bounces=12, ray_chunk=8192)


def test_chunking_does_not_change_the_image():
    """Stateless per-ray RNG makes the image independent of chunk split
    (the property the reference's mutable streams cannot have)."""
    scene = builders.create_small_scene(CFG.aspect)
    cam = scene.camera.build()
    img_a, n_a = render_image(scene.spheres, cam, CFG)
    img_b, n_b = render_image(scene.spheres, cam, CFG.replace(ray_chunk=2048))
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b), atol=1e-6)
    assert int(n_a) == int(n_b)


def test_to_srgb_u8():
    x = np.zeros((1, 2, 3), np.float32)
    x[0, 0] = 0.25   # sqrt -> 0.5 -> 127.995 -> 127
    x[0, 1] = 1.5    # clipped to 1 -> 255
    out = np.asarray(to_srgb_u8(x))
    assert out[0, 0, 0] == 127 and out[0, 1, 0] == 255


@pytest.mark.parametrize("name,tol_mean,tol_block", [
    ("medium", 5.0, 6.0),
    ("large", 5.0, 6.0),
])
def test_golden_statistical(golden_dir, name, tol_mean, tol_block):
    """Statistical allclose vs the reference 'latest' binary at 100 spp.

    Our 4-spp render is noisy, so the comparison uses (a) whole-image mean
    error and (b) 8x8 block means, which average out per-pixel sample noise
    but catch any systematic shading/geometry difference."""
    cfg = RenderConfig(width=80, height=60, spp=4, max_bounces=12,
                       ray_chunk=8192)
    scene = builders.SCENES[name](cfg.aspect)
    img, _ = render_scene(scene, cfg)
    ours = np.asarray(img).astype(np.float64)
    ref = tga.read_rgb24(str(golden_dir / f"latest_quick_{name}.tga")).astype(np.float64)
    assert abs(ours.mean() - ref.mean()) < tol_mean
    bo = ours.reshape(60 // 4, 4, 80 // 8, 8, 3).mean(axis=(1, 3))
    br = ref.reshape(60 // 4, 4, 80 // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bo - br).mean() < tol_block


def test_golden_small_vs_step1(golden_dir):
    """The small scene is compared against *step1* (which renders the hollow
    glass sphere correctly — the optimized reference does not, SURVEY.md §7.1)."""
    cfg = RenderConfig(width=80, height=60, spp=16, max_bounces=12,
                       ray_chunk=8192)
    scene = builders.create_small_scene(cfg.aspect)
    img, _ = render_scene(scene, cfg)
    ours = np.asarray(img).astype(np.float64)
    ref = tga.read_rgb24(str(golden_dir / "step1_quick_small.tga")).astype(np.float64)
    # step1 golden is 4 spp -> noisy; block means only.
    bo = ours.reshape(60 // 4, 4, 80 // 8, 8, 3).mean(axis=(1, 3))
    br = ref.reshape(60 // 4, 4, 80 // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bo - br).mean() < 8.0


def test_ray_count_tracks_reference_scale():
    """Ray-count invariance (SURVEY.md §4) at the reference's own quick MT
    workload with matched bounce depth: the reference compiled on this box
    with -DQUICKBENCH and MAX_BOUNCES 10 counts 1,263,296 rays on medium
    (80x60 @ 100 spp, avg of 3 runs); we measure +0.02%. RNG streams differ
    by construction, so the tolerance is statistical: per-sample bounce-count
    std ~2 over 480K samples -> ~0.1% fluctuation; 0.3% is 3 sigma.

    Full-workload counts (1280x720 @ 4 spp @ 10 bounces) are pinned in
    RESULTS.md: large 0.04%, medium 0.02%; small diverges 2.6% by design
    (correct hollow glass vs the reference's placeholder skip,
    SURVEY.md §7.1-5a)."""
    cfg = RenderConfig(width=80, height=60, spp=100, max_bounces=10,
                       ray_chunk=65536)
    scene = builders.create_medium_scene(cfg.aspect)
    _, num = render_scene(scene, cfg)
    expected = 1263296
    assert abs(int(num) - expected) / expected < 0.003
