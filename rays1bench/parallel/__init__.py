"""SPMD sharding, device meshes, and multi-host runtime.

Imports are LAZY (module __getattr__): `multihost.init()` must run before
anything initializes the XLA backend (jax.distributed.initialize refuses
otherwise), so importing this package — or `parallel.multihost` itself —
must not pull in the renderer modules, whose pytree registrations touch the
backend at import time.
"""

_LAZY = {
    "make_mesh": "rays1bench.parallel.mesh",
    "make_mesh2d": "rays1bench.parallel.mesh",
    "render_image_sharded": "rays1bench.parallel.shard",
    "render_image_pallas_sharded": "rays1bench.parallel.shard",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
