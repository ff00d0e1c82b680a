from rays1bench.core.config import RenderConfig, PRESETS
from rays1bench.core import rng, vecmath

__all__ = ["RenderConfig", "PRESETS", "rng", "vecmath"]
