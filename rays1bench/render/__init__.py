from rays1bench.render.camera import CameraSpec, Camera
from rays1bench.render.pipeline import render_image, render_scene

__all__ = ["CameraSpec", "Camera", "render_image", "render_scene"]
