"""SphereSOA: generated SoA container. DO NOT EDIT BY HAND.

Generated by tools/soa_codegen.py from tools/soa_spheres_spec.py.

Sphere scene storage: centers, signed radii, and flattened material columns.
The device-side derived view (radius_sq, inv_radius, validity mask) is built
by rays1bench.scene.spheres.prepare().
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SphereSOA:
    """Structure-of-arrays container; every column is a length-N device array.

    Rows whose `radius` equals its placeholder default (0.0)
    are padding ("placeholder spheres" in the reference, rayweek1.cpp:575-576)
    and must be masked out by consumers.
    """

    center_x: jax.Array
    center_y: jax.Array
    center_z: jax.Array
    radius: jax.Array
    mat_type: jax.Array
    albedo_x: jax.Array
    albedo_y: jax.Array
    albedo_z: jax.Array
    fuzz: jax.Array
    ref_idx: jax.Array

    @property
    def count(self) -> int:
        """Padded row count (a static Python int under jit)."""
        return self.center_x.shape[0]

    def astype(self, dtype) -> "SphereSOA":
        """Cast all float columns to `dtype` (int columns untouched)."""
        kw = {}
        kw["center_x"] = self.center_x.astype(dtype)
        kw["center_y"] = self.center_y.astype(dtype)
        kw["center_z"] = self.center_z.astype(dtype)
        kw["radius"] = self.radius.astype(dtype)
        kw["albedo_x"] = self.albedo_x.astype(dtype)
        kw["albedo_y"] = self.albedo_y.astype(dtype)
        kw["albedo_z"] = self.albedo_z.astype(dtype)
        kw["fuzz"] = self.fuzz.astype(dtype)
        kw["ref_idx"] = self.ref_idx.astype(dtype)
        return dataclasses.replace(self, **kw)


class SphereSOABuilder:
    """Host-side mutable builder mirroring the reference container's mutation
    surface (add/reserve/remove/copy, soa_sphere.h:22-63). `finalize()` pads
    to a multiple of 128 rows and returns the frozen pytree."""

    __slots__ = ("center_x", "center_y", "center_z", "radius", "mat_type", "albedo_x", "albedo_y", "albedo_z", "fuzz", "ref_idx",)

    def __init__(self):
        self.center_x = []
        self.center_y = []
        self.center_z = []
        self.radius = []
        self.mat_type = []
        self.albedo_x = []
        self.albedo_y = []
        self.albedo_z = []
        self.fuzz = []
        self.ref_idx = []

    def reserve(self, n: int) -> None:
        """No-op capacity hint (reference grows 1+2*cap, soa_sphere.cpp:90;
        Python lists manage capacity themselves)."""

    @property
    def count(self) -> int:
        return len(self.center_x)

    def add(self, center_x: float, center_y: float, center_z: float, radius: float, mat_type: float, albedo_x: float, albedo_y: float, albedo_z: float, fuzz: float, ref_idx: float) -> int:
        """Append one row; returns its index."""
        self.center_x.append(center_x)
        self.center_y.append(center_y)
        self.center_z.append(center_z)
        self.radius.append(radius)
        self.mat_type.append(mat_type)
        self.albedo_x.append(albedo_x)
        self.albedo_y.append(albedo_y)
        self.albedo_z.append(albedo_z)
        self.fuzz.append(fuzz)
        self.ref_idx.append(ref_idx)
        return len(self.center_x) - 1

    def remove(self, index: int) -> None:
        """Remove row by swapping in the last row (reference semantics,
        soa_sphere.cpp:108-121)."""
        last = len(self.center_x) - 1
        self.center_x[index] = self.center_x[last]; self.center_x.pop()
        self.center_y[index] = self.center_y[last]; self.center_y.pop()
        self.center_z[index] = self.center_z[last]; self.center_z.pop()
        self.radius[index] = self.radius[last]; self.radius.pop()
        self.mat_type[index] = self.mat_type[last]; self.mat_type.pop()
        self.albedo_x[index] = self.albedo_x[last]; self.albedo_x.pop()
        self.albedo_y[index] = self.albedo_y[last]; self.albedo_y.pop()
        self.albedo_z[index] = self.albedo_z[last]; self.albedo_z.pop()
        self.fuzz[index] = self.fuzz[last]; self.fuzz.pop()
        self.ref_idx[index] = self.ref_idx[last]; self.ref_idx.pop()

    def copy_from(self, other: "SphereSOABuilder") -> None:
        self.center_x = list(other.center_x)
        self.center_y = list(other.center_y)
        self.center_z = list(other.center_z)
        self.radius = list(other.radius)
        self.mat_type = list(other.mat_type)
        self.albedo_x = list(other.albedo_x)
        self.albedo_y = list(other.albedo_y)
        self.albedo_z = list(other.albedo_z)
        self.fuzz = list(other.fuzz)
        self.ref_idx = list(other.ref_idx)

    def finalize(self, pad_multiple: int = 128) -> SphereSOA:
        n = len(self.center_x)
        padded = n if n % pad_multiple == 0 else (n // pad_multiple + 1) * pad_multiple
        pad = padded - n
        return SphereSOA(
            center_x=jnp.asarray(np.asarray(self.center_x + [0.0] * pad, dtype=np.float32)),
            center_y=jnp.asarray(np.asarray(self.center_y + [0.0] * pad, dtype=np.float32)),
            center_z=jnp.asarray(np.asarray(self.center_z + [0.0] * pad, dtype=np.float32)),
            radius=jnp.asarray(np.asarray(self.radius + [0.0] * pad, dtype=np.float32)),
            mat_type=jnp.asarray(np.asarray(self.mat_type + [0] * pad, dtype=np.int32)),
            albedo_x=jnp.asarray(np.asarray(self.albedo_x + [0.0] * pad, dtype=np.float32)),
            albedo_y=jnp.asarray(np.asarray(self.albedo_y + [0.0] * pad, dtype=np.float32)),
            albedo_z=jnp.asarray(np.asarray(self.albedo_z + [0.0] * pad, dtype=np.float32)),
            fuzz=jnp.asarray(np.asarray(self.fuzz + [0.0] * pad, dtype=np.float32)),
            ref_idx=jnp.asarray(np.asarray(self.ref_idx + [1.0] * pad, dtype=np.float32)),
        )
