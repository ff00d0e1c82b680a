"""Intersection tests: the dense masked closest-hit (render/intersect.py)
against a straightforward NumPy oracle implementing the reference's pass-2
semantics (rayweek1.cpp:284-314)."""

import numpy as np
import jax.numpy as jnp

from rays1bench.render.intersect import closest_hit
from rays1bench.scene.soa_spheres import SphereSOABuilder
from rays1bench.scene.spheres import prepare, LAMBERTIAN

T_MIN, T_MAX = 1e-3, 3.4e38


def _oracle(o, d, centers, radii, t_min=T_MIN, t_max=T_MAX):
    """Scalar closest-hit: near root first, then far root, sequential shrink."""
    best_t, best_i = None, -1
    for i, (c, r) in enumerate(zip(centers, radii)):
        if r == 0:
            continue
        co = np.asarray(c) - o
        nb = float(co @ d)
        cc = float(co @ co) - r * r
        disc = nb * nb - cc
        if disc <= 0:
            continue
        sq = np.sqrt(disc)
        for t in (nb - sq, nb + sq):
            if t_min < t < t_max:
                if best_t is None or t < best_t:
                    best_t, best_i = t, i
                break  # reference takes the first in-range root per sphere
    return best_t, best_i


def _build(centers, radii):
    b = SphereSOABuilder()
    for c, r in zip(centers, radii):
        b.add(c[0], c[1], c[2], r, LAMBERTIAN, 0.5, 0.5, 0.5, 0.0, 1.0)
    return prepare(b.finalize(pad_multiple=8))


def _hit(prep, o, d):
    rec = closest_hit(jnp.float32([o[0]]), jnp.float32([o[1]]), jnp.float32([o[2]]),
                      jnp.float32([d[0]]), jnp.float32([d[1]]), jnp.float32([d[2]]),
                      prep, T_MIN, T_MAX)
    return rec


def test_random_scenes_match_oracle():
    rng = np.random.default_rng(42)
    centers = rng.uniform(-5, 5, size=(40, 3))
    radii = rng.uniform(0.2, 1.5, size=40)
    prep = _build(centers, radii)

    for _ in range(200):
        o = rng.uniform(-8, 8, size=3)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        ot, oi = _oracle(o, d, centers, radii)
        rec = _hit(prep, o, d)
        hit = bool(rec.hit[0])
        assert hit == (oi != -1)
        if hit:
            assert np.isclose(float(rec.t[0]), ot, rtol=2e-4, atol=2e-4)
            # p = o + t*d
            p = o + ot * d
            np.testing.assert_allclose(
                [float(rec.px[0]), float(rec.py[0]), float(rec.pz[0])], p,
                rtol=1e-3, atol=1e-3)
            # outward unit normal
            n = (p - centers[oi]) / radii[oi]
            np.testing.assert_allclose(
                [float(rec.nx[0]), float(rec.ny[0]), float(rec.nz[0])], n,
                rtol=1e-2, atol=1e-3)


def test_inside_sphere_uses_far_root():
    prep = _build([(0, 0, 0)], [2.0])
    rec = _hit(prep, (0, 0, 0), (0, 0, -1))
    assert bool(rec.hit[0])
    assert np.isclose(float(rec.t[0]), 2.0, atol=1e-5)
    # Normal points outward from center — against the ray here.
    assert float(rec.nz[0]) < 0


def test_negative_radius_flips_normal():
    """Hollow-glass semantics (step1, SURVEY.md §7.1): geometry identical,
    normal flipped inward."""
    pos = _build([(0, 0, -2)], [0.5])
    neg = _build([(0, 0, -2)], [-0.5])
    d = (0, 0, -1)
    rp = _hit(pos, (0, 0, 0), d)
    rn = _hit(neg, (0, 0, 0), d)
    assert bool(rp.hit[0]) and bool(rn.hit[0])
    assert np.isclose(float(rp.t[0]), float(rn.t[0]))
    assert np.isclose(float(rp.nz[0]), -float(rn.nz[0]))
    assert np.isclose(float(rp.nz[0]), 1.0, atol=1e-5)


def test_placeholder_spheres_ignored():
    """Padding rows (radius 0) must never hit — the analog of the reference's
    inv_radius == 0 skip (rayweek1.cpp:291)."""
    prep = _build([(0, 0, -2)], [0.5])  # pads to 8 with radius-0 rows
    rec = _hit(prep, (0, 0, 0), (0, 0, 1))  # looking away
    assert not bool(rec.hit[0])


def test_t_window_respected():
    prep = _build([(0, 0, -2)], [0.5])
    # Sphere surface at t=1.5 and t=2.5.
    rec = closest_hit(jnp.float32([0]), jnp.float32([0]), jnp.float32([0]),
                      jnp.float32([0]), jnp.float32([0]), jnp.float32([-1]),
                      prep, t_min=2.0, t_max=3.0)
    # Near root excluded by t_min -> far root taken.
    assert bool(rec.hit[0]) and np.isclose(float(rec.t[0]), 2.5, atol=1e-5)
    rec2 = closest_hit(jnp.float32([0]), jnp.float32([0]), jnp.float32([0]),
                       jnp.float32([0]), jnp.float32([0]), jnp.float32([-1]),
                       prep, t_min=1e-3, t_max=1.0)
    assert not bool(rec2.hit[0])


def test_closest_of_two():
    prep = _build([(0, 0, -5), (0, 0, -3)], [0.5, 0.5])
    rec = _hit(prep, (0, 0, 0), (0, 0, -1))
    assert np.isclose(float(rec.t[0]), 2.5, atol=1e-5)


def test_soft_near_miss_promotion():
    """Two-sided soft silhouette (render/intersect._near_miss_index): a ray
    passing just OUTSIDE a sphere's silhouette is promoted to a soft hit of
    that sphere — at the closest-approach point, with cover < 1/2 — even
    when it hits other geometry BEHIND the graze; a ray grazing a sphere
    BEHIND its hit is not."""
    eps = 0.01
    # Sphere A at z=-2 (r=0.5), big backstop B at z=-10 (r=2).
    prep = _build([(0, 0, -2), (0, 0, -10)], [0.5, 2.0])

    def soft_hit(oy):
        rec = closest_hit(jnp.float32([0]), jnp.float32([oy]), jnp.float32([0]),
                          jnp.float32([0]), jnp.float32([0]), jnp.float32([-1]),
                          prep, T_MIN, T_MAX, soft_eps=eps)
        return rec

    # Ray at y = 0.5 + 2*eps: misses A by 2*eps (inside the 9.2*eps band),
    # would hit B. Promoted to a soft graze of A at t = nb = 2 (closest
    # approach), cover = sigmoid(-2) ~ 0.12, pass-through point ahead of A.
    rec = soft_hit(0.5 + 2 * eps)
    assert bool(rec.hit[0])
    assert np.isclose(float(rec.t[0]), 2.0, atol=1e-4)
    c = float(rec.cover[0])
    assert 0.05 < c < 0.5, c
    assert np.isclose(float(rec.pz2[0]), -2.0, atol=1e-3)
    # Normal is renormalized to unit length even at the graze point.
    nlen = float(rec.nx[0]**2 + rec.ny[0]**2 + rec.nz[0]**2)
    assert np.isclose(nlen, 1.0, atol=1e-5)

    # Ray at y = 0.5 + 20*eps: outside the band -> plain hit of B.
    rec = soft_hit(0.5 + 20 * eps)
    assert bool(rec.hit[0])
    assert float(rec.t[0]) > 7.0
    assert float(rec.cover[0]) > 0.99  # saturated interior hit of B

    # Ray through A's interior: hits A, cover saturates to 1 (exact render)
    # and the far-exit point is A's back surface.
    rec = soft_hit(0.0)
    assert np.isclose(float(rec.t[0]), 1.5, atol=1e-5)
    assert float(rec.cover[0]) > 0.999
    assert np.isclose(float(rec.pz2[0]), -2.5, atol=1e-4)
