"""Respawn kernel tests (kernels/respawn.py, kernels/pipeline.py).

The kernel runs here in the Pallas interpreter. Its per-ray math is the XLA
renderer's own code, so against render/pipeline.render_image ray counts are
EXACT and pixels agree up to the order in which a pixel's samples are
summed. The lowering tests build the CUDA form of the kernel without a card,
which catches primitives the Triton route does not implement.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rays1bench.core.config import RenderConfig
from rays1bench.kernels import respawn as rk
from rays1bench.kernels.pipeline import BLOCK, render_image_pallas
from rays1bench.render.pipeline import render_image
from rays1bench.scene import builders
from rays1bench.scene.soa_spheres import SphereSOABuilder
from rays1bench.scene.spheres import LAMBERTIAN, prepare

CASES = [(scene, spp, mb) for scene in ("small", "medium", "large")
         for spp, mb in ((1, 3), (3, 6))]


@pytest.mark.parametrize("scene_name,spp,max_bounces", CASES)
def test_respawn_matches_xla_renderer(scene_name, spp, max_bounces):
    cfg = RenderConfig(width=32, height=16, spp=spp, max_bounces=max_bounces,
                       seed=11, ray_chunk=2048)
    scene = builders.SCENES[scene_name](cfg.aspect)
    cam = scene.camera.build()
    ref, n_ref = render_image(scene.spheres, cam, cfg)
    img, n = render_image_pallas(scene.spheres, cam, cfg, n_real=scene.n_real,
                                 interpret=True)
    assert int(n) == int(n_ref)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


def _trace(cfg, scene, span, block=BLOCK, **kw):
    gy, gx, _, _ = rk.tile_grid(cfg, block)
    return rk.trace_respawn(prepare(scene.spheres), scene.camera.build(),
                            jnp.asarray(span, jnp.int32), cfg, gy * gx,
                            block, 1, 4, interpret=True, **kw)


def _lane_pixels(cfg, block):
    """Pixel id of every kernel lane in tile order, -1 outside the image
    (numpy twin of the kernel's tile arithmetic)."""
    gy, gx, th, tw = rk.tile_grid(cfg, block)
    t, lane = np.divmod(np.arange(gy * gx * block), block)
    x = (t % gx) * tw + lane % tw
    y = (t // gx) * th + lane // tw
    return np.where((x < cfg.width) & (y < cfg.height), y * cfg.width + x, -1)


def test_respawn_padding_lanes_inactive():
    """Lanes of edge tiles that overhang the image never trace, never
    count, and leave zero radiance."""
    cfg = RenderConfig(width=50, height=30, spp=2, max_bounces=4, seed=3)
    scene = builders.create_small_scene(cfg.aspect)
    (rr, rg, rb), n = _trace(cfg, scene, [0, 0, cfg.spp, 0], block=64)
    pad = _lane_pixels(cfg, 64) < 0
    assert pad.any()  # the overhang is actually exercised
    for a in (rr, rg, rb):
        assert np.asarray(a)[pad].sum() == 0
    _, n_ref = render_image(scene.spheres, scene.camera.build(), cfg)
    assert int(n) == int(n_ref)


def test_sample_span_slices_sum_to_full():
    """Sample slices [0, 1) + [1, 3) trace exactly the rays of [0, 3): the
    counts add up and so do the per-pixel sums."""
    cfg = RenderConfig(width=32, height=16, spp=3, max_bounces=5, seed=7)
    scene = builders.create_medium_scene(cfg.aspect)
    full, n_full = _trace(cfg, scene, [0, 0, 3, 0])
    a, n_a = _trace(cfg, scene, [0, 0, 1, 0])
    b, n_b = _trace(cfg, scene, [0, 1, 3, 0])
    assert int(n_a) + int(n_b) == int(n_full)
    for f, x, y in zip(full, a, b):
        np.testing.assert_allclose(np.asarray(x) + np.asarray(y),
                                   np.asarray(f), atol=1e-6)


@pytest.mark.parametrize("block", [16, 64, 128])
def test_block_size_invariance(block):
    """The launch shape never changes the image: each lane sums its own
    pixel's samples in the same order whatever tile it sits in."""
    cfg = RenderConfig(width=40, height=24, spp=2, max_bounces=4, seed=5)
    scene = builders.create_medium_scene(cfg.aspect)
    span = [0, 0, cfg.spp, 0]
    (ref, _, _), n_ref = _trace(cfg, scene, span)
    (got, _, _), n = _trace(cfg, scene, span, block=block)
    assert int(n) == int(n_ref)
    assert (np.asarray(rk.untile(got, cfg, block))
            == np.asarray(rk.untile(ref, cfg, BLOCK))).all()


def test_prepare_trimmed_drops_placeholders():
    """n_real trims the placeholder rows and keeps the real rows in order
    (so first-minimum ties resolve as in the untrimmed scene)."""
    from rays1bench.kernels.pipeline import prepare_trimmed
    scene = builders.create_medium_scene(16 / 9)
    full = prepare(scene.spheres)
    trimmed = prepare_trimmed(scene.spheres, scene.n_real)
    real = np.asarray(full.valid) > 0
    assert trimmed.count == scene.n_real == int(real.sum())
    for name in ("center_x", "radius_sq", "albedo_y", "mat_type"):
        assert (np.asarray(getattr(trimmed, name))
                == np.asarray(getattr(full, name))[real]).all(), name
    assert prepare_trimmed(scene.spheres, None).count == full.count


def test_giant_scene_matches_xla():
    """The 4096-sphere stress scene (builders.create_giant_scene — 8.5x the
    reference's largest; no reference analog) through the kernel matches
    the dense-XLA renderer with EXACT ray counts."""
    cfg = RenderConfig(width=48, height=24, spp=1, max_bounces=3,
                       early_exit=False, ray_chunk=2048)
    scene = builders.create_giant_scene(cfg.aspect)
    assert scene.n_real == 4096
    camera = scene.camera.build()
    ref, n_ref = render_image(scene.spheres, camera, cfg)
    img, n = render_image_pallas(scene.spheres, camera, cfg,
                                 n_real=scene.n_real, interpret=True)
    assert int(n) == int(n_ref)
    assert np.abs(np.asarray(img) - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("w,h,block", [(64, 32, 32), (1280, 720, 32),
                                       (50, 30, 64)])
def test_untile_matches_kernel_tile_order(w, h, block):
    """untile() inverts the kernel's lane -> pixel map exactly, overhanging
    edge tiles included."""
    cfg = RenderConfig(width=w, height=h)
    tw, th = rk.tile_shape(block)
    assert tw * th == block and tw >= th
    lanes = jnp.asarray(_lane_pixels(cfg, block), jnp.int32)
    out = np.asarray(rk.untile(lanes, cfg, block))
    assert (out == np.arange(w * h).reshape(h, w)).all()


def test_pack_spheres_placeholder_poison():
    prep = prepare(builders.create_small_scene(16 / 9).spheres)
    table = np.asarray(rk.pack_spheres(prep))
    assert table.shape == (rk.TABLE_ROWS, 128)
    # placeholder rows: radius_sq poisoned so the discriminant is always < 0
    assert (table[3, 5:] < -1e29).all()
    assert np.isclose(table[3, 0], np.asarray(prep.radius_sq)[0])
    wide = np.asarray(rk.pack_spheres(prep, rows=132))
    assert wide.shape == (rk.TABLE_ROWS, 256) and (wide[3, 128:] < -1e29).all()


def _random_spheres(rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b = SphereSOABuilder()
    for _ in range(rows):
        b.add(*rng.uniform(-5, 5, 3), rng.uniform(0.1, 1.0), LAMBERTIAN,
              *rng.uniform(0, 1, 3), 0.0, 1.0)
    return b.finalize(pad_multiple=8)


@pytest.mark.parametrize("rows", [8, 128, 512, 4096])
def test_respawn_lowers_for_cuda(rows):
    """The kernel as the GPU compiles it, lowered here without a card."""
    cfg = RenderConfig(width=256, height=128, spp=4, max_bounces=10)
    prep = prepare(_random_spheres(rows))
    cam = builders.create_small_scene(cfg.aspect).camera.build()
    gy, gx, _, _ = rk.tile_grid(cfg, BLOCK)
    span = jnp.asarray([0, 0, cfg.spp, 0], jnp.int32)
    f = jax.jit(lambda p, c, s: rk.trace_respawn(p, c, s, cfg, gy * gx,
                                                 BLOCK, 1, 4))
    text = f.trace(prep, cam, span).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "respawn_path_tracer" in text


def test_respawn_compiled_matches_xla(gpu):
    """The kernel compiled for the card against the XLA renderer (exact
    rays within the FMA-contraction tolerance of chip_smoke.py)."""
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=6)
    scene = builders.create_large_scene(cfg.aspect)
    cam = scene.camera.build()
    img, n = render_image_pallas(scene.spheres, cam, cfg, n_real=scene.n_real)
    ref, n_ref = render_image(scene.spheres, cam, cfg)
    assert abs(int(n) - int(n_ref)) <= 5e-4 * int(n_ref)
    assert np.abs(np.asarray(img) - np.asarray(ref)).mean() < 1e-3
