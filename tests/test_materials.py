"""Material scatter tests (render/materials.py) against the reference
behaviors (rayweek1.cpp:396-512)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from rays1bench.render.intersect import HitRecord
from rays1bench.render.materials import scatter
from rays1bench.scene.spheres import LAMBERTIAN, METAL, DIELECTRIC


def _rec(n, mat, normal=(0, 0, 1), albedo=(0.5, 0.5, 0.5), fuzz=0.0, ref_idx=1.5):
    z = jnp.zeros((n,), jnp.float32)
    o = jnp.ones((n,), jnp.float32)
    return HitRecord(
        hit=jnp.ones((n,), bool), t=o,
        px=z, py=z, pz=z,
        nx=o * normal[0], ny=o * normal[1], nz=o * normal[2],
        mat_type=jnp.full((n,), mat, jnp.int32),
        albedo_x=o * albedo[0], albedo_y=o * albedo[1], albedo_z=o * albedo[2],
        fuzz=o * fuzz, ref_idx=o * ref_idx)


def _dirs(n, d):
    o = jnp.ones((n,), jnp.float32)
    return o * d[0], o * d[1], o * d[2]


def test_lambertian_cosine_ish_and_always_scatters():
    n = 50000
    dx, dy, dz = _dirs(n, (0, 0, -1))
    rec = _rec(n, LAMBERTIAN, normal=(0, 0, 1), albedo=(0.1, 0.2, 0.5))
    (sx, sy, sz), (ar, ag, ab), ok = scatter(dx, dy, dz, rec, 1, jnp.arange(n), 0)
    assert bool(jnp.all(ok))
    # attenuation = albedo (rayweek1.cpp:407)
    assert np.isclose(float(ar[0]), 0.1) and np.isclose(float(ab[0]), 0.5)
    # normalize(n + ball): z-component mean for cosine-ish lobe is positive
    # and the lobe is symmetric about the normal.
    z = np.asarray(sz)
    assert (z > -1e-6).sum() > 0.97 * n  # nearly all above the surface
    assert abs(np.asarray(sx).mean()) < 5e-3
    assert abs(np.asarray(sy).mean()) < 5e-3
    assert z.mean() > 0.5
    norms = np.sqrt(np.asarray(sx)**2 + np.asarray(sy)**2 + z**2)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_metal_perfect_mirror():
    n = 4
    d = np.array([0.6, 0.0, -0.8])
    dx, dy, dz = _dirs(n, d)
    rec = _rec(n, METAL, normal=(0, 0, 1), fuzz=0.0)
    (sx, sy, sz), _, ok = scatter(dx, dy, dz, rec, 1, jnp.arange(n), 0)
    assert bool(jnp.all(ok))
    np.testing.assert_allclose(np.asarray(sx), 0.6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sz), 0.8, atol=1e-6)


def test_metal_grazing_absorption():
    """With strong fuzz at grazing incidence some scattered rays go below the
    surface and are absorbed (rayweek1.cpp:433 returns false)."""
    n = 20000
    d = np.array([0.9999, 0.0, -0.0141])
    d = d / np.linalg.norm(d)
    dx, dy, dz = _dirs(n, d)
    rec = _rec(n, METAL, normal=(0, 0, 1), fuzz=1.0)
    _, _, ok = scatter(dx, dy, dz, rec, 1, jnp.arange(n), 0)
    frac = float(jnp.mean(ok.astype(jnp.float32)))
    assert 0.01 < frac < 0.99  # a real mix of absorbed and scattered


def test_dielectric_tir():
    """Total internal reflection: ray exiting glass at a grazing angle must
    reflect (can_refract false -> reflect_prob 1, rayweek1.cpp:499-502)."""
    n = 1000
    # Inside the sphere going outward at a steep angle: d.n > 0, exiting.
    d = np.array([0.9, 0.0, 0.436])
    d = d / np.linalg.norm(d)
    dx, dy, dz = _dirs(n, d)
    # Dielectric rows store albedo (1,1,1) by builder convention — that IS the
    # reference's "attenuation = (1,1,1)" (rayweek1.cpp:470).
    rec = _rec(n, DIELECTRIC, normal=(0, 0, 1), albedo=(1, 1, 1), ref_idx=1.5)
    (sx, sy, sz), (ar, ag, ab), ok = scatter(dx, dy, dz, rec, 1, jnp.arange(n), 0)
    assert bool(jnp.all(ok))
    assert float(ar[0]) == 1.0
    # all rays mirror-reflect: z flips sign
    np.testing.assert_allclose(np.asarray(sz), -d[2], atol=1e-5)


def test_dielectric_normal_incidence_mostly_refracts():
    n = 50000
    dx, dy, dz = _dirs(n, (0, 0, -1))
    rec = _rec(n, DIELECTRIC, normal=(0, 0, 1), ref_idx=1.5)
    (sx, sy, sz), _, _ = scatter(dx, dy, dz, rec, 1, jnp.arange(n), 0)
    # Schlick at normal incidence for 1.5: r0 = 0.04 -> ~4% reflect.
    refract_frac = float(jnp.mean((sz < 0).astype(jnp.float32)))
    assert 0.93 < refract_frac < 0.99
    # Refracted direction at normal incidence is unchanged.
    idx = np.asarray(sz) < 0
    np.testing.assert_allclose(np.asarray(sz)[idx], -1.0, atol=1e-5)
