"""Wavefront integrator tests (render/integrator.py)."""

import numpy as np
import jax.numpy as jnp

from rays1bench.render.integrator import trace, sky_color
from rays1bench.scene.soa_spheres import SphereSOABuilder
from rays1bench.scene.spheres import prepare, LAMBERTIAN, METAL


def _prep(spheres):
    b = SphereSOABuilder()
    for (c, r, mat, alb) in spheres:
        b.add(c[0], c[1], c[2], r, mat, alb[0], alb[1], alb[2], 0.0, 1.0)
    if not spheres:
        b.add(0, 0, 0, 0.0, LAMBERTIAN, 0, 0, 0, 0, 1)  # placeholder only
    return prepare(b.finalize(pad_multiple=8))


def _rays(n, d):
    z = jnp.zeros((n,), jnp.float32)
    o = jnp.ones((n,), jnp.float32)
    return z, z, z, o * d[0], o * d[1], o * d[2]


def test_all_miss_gives_sky_and_counts_one_ray_each():
    prep = _prep([])
    n = 64
    rays = _rays(n, (0, 0.6, 0.8))
    (rr, rg, rb), num = trace(prep, *rays, 1, jnp.arange(n), max_bounces=10)
    er, eg, eb = sky_color(jnp.float32(0), jnp.float32(0.6), jnp.float32(0.8))
    np.testing.assert_allclose(np.asarray(rr), float(er), atol=1e-6)
    np.testing.assert_allclose(np.asarray(rb), float(eb), atol=1e-6)
    assert int(num) == n  # one radiance eval per primary, no bounces


def test_mirror_floor_counts_two_rays():
    """A perfect metal plane reflects once, then the ray escapes to the sky:
    exactly 2 radiance evaluations per primary (reference counting,
    rayweek1.cpp:517)."""
    prep = _prep([((0, -1000, 0), 1000.0, METAL, (1.0, 1.0, 1.0))])
    n = 32
    # straight down from above the sphere's north pole -> reflects straight up
    z = jnp.zeros((n,), jnp.float32)
    o = jnp.ones((n,), jnp.float32)
    rays = (z, o * 2.0, z, z, -o, z)
    (rr, rg, rb), num = trace(prep, *rays, 1, jnp.arange(n), max_bounces=10)
    assert int(num) == 2 * n
    er, eg, eb = sky_color(jnp.float32(0), jnp.float32(1.0), jnp.float32(0))
    np.testing.assert_allclose(np.asarray(rg), float(eg), rtol=1e-5)


def test_absorbing_black_sphere():
    """Albedo 0 lambertian: the first bounce multiplies attenuation to zero,
    so whatever happens next contributes nothing."""
    prep = _prep([((0, 0, -3), 1.0, LAMBERTIAN, (0.0, 0.0, 0.0))])
    n = 32
    rays = _rays(n, (0, 0, -1))
    (rr, rg, rb), num = trace(prep, *rays, 1, jnp.arange(n), max_bounces=10)
    np.testing.assert_allclose(np.asarray(rr), 0.0, atol=1e-7)


def test_max_bounces_zero_kills_hits():
    """max_bounces=0 forbids scattering (depth < MAX_BOUNCES check,
    rayweek1.cpp:523): hits return black."""
    prep = _prep([((0, 0, -3), 1.0, LAMBERTIAN, (0.9, 0.9, 0.9))])
    n = 8
    rays = _rays(n, (0, 0, -1))
    (rr, rg, rb), num = trace(prep, *rays, 1, jnp.arange(n), max_bounces=0)
    np.testing.assert_allclose(np.asarray(rr), 0.0, atol=1e-7)
    assert int(num) == n


def test_active_mask_excludes_padding():
    prep = _prep([])
    n = 16
    rays = _rays(n, (0, 1, 0))
    active = jnp.arange(n) < 10
    (rr, _, _), num = trace(prep, *rays, 1, jnp.arange(n), max_bounces=5,
                            active=active)
    assert int(num) == 10
    assert np.asarray(rr)[10:].sum() == 0


def test_early_exit_matches_fixed_trip():
    """while_loop and fori_loop paths must produce identical radiance."""
    prep = _prep([((0, 0, -3), 1.0, LAMBERTIAN, (0.7, 0.5, 0.3)),
                  ((0, -1000, 0), 999.0, METAL, (0.9, 0.9, 0.9))])
    n = 256
    rays = _rays(n, (0, -0.1, -0.995))
    out_w, num_w = trace(prep, *rays, 7, jnp.arange(n), max_bounces=6,
                         early_exit=True)
    out_f, num_f = trace(prep, *rays, 7, jnp.arange(n), max_bounces=6,
                         early_exit=False)
    for a, b in zip(out_w, out_f):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    assert int(num_w) == int(num_f)
