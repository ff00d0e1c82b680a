"""Closest-hit index kernel tests (kernels/intersect_pallas.py, Triton
route): in the Pallas interpreter, the kernel's indices must equal XLA's
fused argmin sweep (render/intersect.closest_index) bitwise, so forward
values and gradients of the differentiable path are unchanged; the lowering
tests build the kernel's CUDA form without a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rays1bench.core.config import RenderConfig
from rays1bench.grad.inverse import image_loss, params_of
from rays1bench.kernels import intersect_pallas
from rays1bench.render.pipeline import render_image
from rays1bench.scene.builders import (create_large_scene,
                                       create_medium_scene,
                                       create_small_scene)
from rays1bench.scene.spheres import prepare

CFG = RenderConfig(width=64, height=32, spp=2, max_bounces=5, ray_chunk=4096,
                   seed=9, early_exit=False)


_ORIG = intersect_pallas.closest_hit_index


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Route the pipeline's pallas_intersect sweep through the interpreter
    (on a CPU the route refuses the compiled kernel — core/route.py)."""
    from rays1bench.render import pipeline

    def sweep(cfg):
        if not cfg.pallas_intersect:
            return pipeline.closest_index
        return lambda ox, oy, oz, dx, dy, dz, sph, t_min, t_max: _ORIG(
            sph, ox, oy, oz, dx, dy, dz, t_min, 128, 4, True)

    monkeypatch.setattr(pipeline, "_index_sweep", sweep)
    render_image.clear_cache()
    yield
    render_image.clear_cache()


@pytest.mark.parametrize("builder", [create_small_scene, create_medium_scene,
                                     create_large_scene])
def test_forward_bitwise_identical(builder, interpreted_kernel):
    scene = builder(CFG.aspect)
    cam = scene.camera.build()
    a, na = render_image(scene.spheres, cam, CFG.replace(pallas_intersect=False))
    b, nb = render_image(scene.spheres, cam, CFG.replace(pallas_intersect=True))
    assert int(na) == int(nb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gradients_bitwise_identical(interpreted_kernel):
    scene = create_small_scene(CFG.aspect)
    cam = scene.camera.build()
    params = params_of(scene.spheres, ("center_x", "radius", "albedo_x"))
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    ga = jax.grad(image_loss)(params, scene.spheres, cam, target,
                              CFG.replace(pallas_intersect=False))
    gb = jax.grad(image_loss)(params, scene.spheres, cam, target,
                              CFG.replace(pallas_intersect=True))
    for k in ga:
        np.testing.assert_array_equal(np.asarray(ga[k]), np.asarray(gb[k]))


def test_padding_rays_handled():
    """Ray counts not divisible by the kernel block are padded internally."""
    prep = prepare(create_small_scene(CFG.aspect).spheres)
    n = 777  # deliberately awkward
    z = jnp.zeros((n,), jnp.float32)
    o = jnp.ones((n,), jnp.float32)
    idx, hit = _ORIG(prep, z, z, z + 2.0, z, z, -o, 1e-3, 128, 4, True)
    assert idx.shape == (n,) and hit.shape == (n,)
    assert bool(hit.all())  # camera axis through the scene hits something


@pytest.mark.parametrize("rows", [8, 128, 512, 4096])
def test_index_kernel_lowers_for_cuda(rows):
    rng = np.random.default_rng(rows)
    scene = create_small_scene(CFG.aspect)
    prep = prepare(scene.spheres)
    cols = {f: jnp.asarray(rng.uniform(0.1, 1.0, rows), jnp.float32)
            for f in ("center_x", "center_y", "center_z", "radius_sq",
                      "inv_radius", "valid", "albedo_x", "albedo_y",
                      "albedo_z", "fuzz", "ref_idx")}
    prep = type(prep)(mat_type=jnp.zeros(rows, jnp.int32), **cols)
    rays = [jnp.zeros((4096,), jnp.float32)] * 6
    f = jax.jit(lambda p, *r: _ORIG(p, *r, 1e-3))
    text = f.trace(prep, *rays).lower(lowering_platforms=("cuda",)).as_text()
    assert "closest_hit_index" in text
