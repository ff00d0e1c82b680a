"""Derived device-side view of the sphere SoA.

The reference precomputes radius_sq and inv_radius at scene-build time
(reference: src/latest/soa_sphere.cpp:80-82) because its hot loop reads them
directly (rayweek1.cpp:196-199, 291, 321). Here they're derived *inside* the
traced render function from the signed `radius` leaf: XLA constant-folds them
for a fixed scene (so the hot loop still sees precomputed columns), while
gradients w.r.t. radius flow through both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from rays1bench.scene.soa_spheres import SphereSOA

# Material codes (replaces virtual Material* dispatch, rayweek1.cpp:131-136).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedSpheres:
    """Hot-loop view: original columns + derived ones + validity mask."""

    center_x: jax.Array
    center_y: jax.Array
    center_z: jax.Array
    radius_sq: jax.Array     # radius^2 (same for signed radii)
    inv_radius: jax.Array    # 1/radius, signed — flips normals for hollow glass
    valid: jax.Array         # float32 1.0 for real spheres, 0.0 for placeholders
    mat_type: jax.Array
    albedo_x: jax.Array
    albedo_y: jax.Array
    albedo_z: jax.Array
    fuzz: jax.Array
    ref_idx: jax.Array

    @property
    def count(self) -> int:
        return self.center_x.shape[0]


def prepare(s: SphereSOA) -> PreparedSpheres:
    """Build the derived view. Placeholder rows have radius == 0
    (rayweek1.cpp:575-576); they get inv_radius = 0 and valid = 0, matching the
    reference's placeholder skip (rayweek1.cpp:291-292)."""
    is_real = s.radius != 0.0
    # where() keeps the 1/0 out of both value and gradient paths.
    safe_r = jnp.where(is_real, s.radius, 1.0)
    return PreparedSpheres(
        center_x=s.center_x,
        center_y=s.center_y,
        center_z=s.center_z,
        radius_sq=s.radius * s.radius,
        inv_radius=jnp.where(is_real, 1.0 / safe_r, 0.0),
        valid=is_real.astype(jnp.float32),
        mat_type=s.mat_type,
        albedo_x=s.albedo_x,
        albedo_y=s.albedo_y,
        albedo_z=s.albedo_z,
        fuzz=s.fuzz,
        ref_idx=s.ref_idx,
    )
