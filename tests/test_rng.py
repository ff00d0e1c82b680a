"""Stateless RNG tests (core/rng.py).

The reference's RNG contract (mymath.h:17-73): uniform floats in [0,1)/[0,2)
with 24-bit resolution, plus uniform-in-ball and uniform-in-disk samplers
(mymath.h:224-235, rayweek1.cpp:353-362). Ours must match the distributions
(not the streams) and add determinism-by-coordinates.
"""

import jax.numpy as jnp
import numpy as np

from rays1bench.core import rng


def _ids(n=20000):
    return jnp.arange(n, dtype=jnp.int32)


def test_uniform01_range_and_determinism():
    u1 = np.asarray(rng.uniform01(7, _ids(), 0, 0))
    u2 = np.asarray(rng.uniform01(7, _ids(), 0, 0))
    assert (u1 >= 0).all() and (u1 < 1).all()
    np.testing.assert_array_equal(u1, u2)


def test_uniform01_decorrelated_across_axes():
    base = np.asarray(rng.uniform01(7, _ids(), 0, 0))
    for other in [rng.uniform01(8, _ids(), 0, 0),
                  rng.uniform01(7, _ids(), 1, 0),
                  rng.uniform01(7, _ids(), 0, 1)]:
        other = np.asarray(other)
        assert not np.array_equal(base, other)
        corr = np.corrcoef(base, other)[0, 1]
        assert abs(corr) < 0.03


def test_uniform01_moments():
    u = np.asarray(rng.uniform01(3, _ids(200000), 0, 0))
    assert abs(u.mean() - 0.5) < 2e-3
    assert abs(u.var() - 1.0 / 12.0) < 2e-3


def test_uniform02_range():
    u = np.asarray(rng.uniform02(3, _ids(), 0, 0))
    assert (u >= 0).all() and (u < 2).all()


def test_in_unit_ball_uniform():
    x, y, z = rng.in_unit_ball(11, _ids(100000), 0)
    r = np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2 + np.asarray(z) ** 2)
    assert (r <= 1.0 + 1e-6).all()
    # Uniform in ball: E[r] = 3/4, and r^3 ~ U(0,1).
    assert abs(r.mean() - 0.75) < 3e-3
    assert abs((r ** 3).mean() - 0.5) < 4e-3
    # Isotropy: component means ~ 0.
    for c in (x, y, z):
        assert abs(np.asarray(c).mean()) < 3e-3


def test_in_unit_disk_uniform():
    x, y = rng.in_unit_disk(13, _ids(100000), 0)
    r2 = np.asarray(x) ** 2 + np.asarray(y) ** 2
    assert (r2 <= 1.0 + 1e-6).all()
    # Uniform in disk: r^2 ~ U(0,1).
    assert abs(r2.mean() - 0.5) < 4e-3


def test_broadcasting_scalars():
    u = rng.uniform01(1, 5, 2, 3)
    assert u.shape == ()


def test_sincos2pi_accuracy():
    """The shared-reduction sincos pair (rng.sincos2pi, the round-5
    fixed-cost harvest) stays within ~3 f32 ulp of the exact functions on
    a dense [0, 1) grid (fit error 5e-8 plus f32 evaluation rounding) — pins the polynomial constants and the quadrant
    rotation (including the exact quadrant boundaries)."""
    import jax.numpy as jnp
    t = np.concatenate([np.linspace(0, 1, 200001, endpoint=False),
                        np.asarray([0.0, 0.25, 0.5, 0.75, 0.999999])])
    s, c = rng.sincos2pi(jnp.asarray(t, jnp.float32))
    ref_s = np.sin(2 * np.pi * t.astype(np.float64))
    ref_c = np.cos(2 * np.pi * t.astype(np.float64))
    assert np.abs(np.asarray(s) - ref_s).max() < 5e-7
    assert np.abs(np.asarray(c) - ref_c).max() < 5e-7
    # Unit circle to float tolerance.
    assert np.abs(np.asarray(s) ** 2 + np.asarray(c) ** 2 - 1.0).max() < 1e-6
