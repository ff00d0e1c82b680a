from rays1bench.scene.soa_spheres import SphereSOA, SphereSOABuilder
from rays1bench.scene.spheres import PreparedSpheres, prepare, LAMBERTIAN, METAL, DIELECTRIC
from rays1bench.scene.builders import (
    Scene, create_small_scene, create_medium_scene, create_large_scene, SCENES,
)
from rays1bench.scene import tga

__all__ = [
    "SphereSOA", "SphereSOABuilder", "PreparedSpheres", "prepare",
    "LAMBERTIAN", "METAL", "DIELECTRIC",
    "Scene", "create_small_scene", "create_medium_scene", "create_large_scene",
    "SCENES", "tga",
]
