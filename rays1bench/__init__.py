"""rays1bench — a differentiable path-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of montib/rays1bench
(reference: a CPU "Ray Tracing in One Weekend" benchmark evolved through SoA /
SIMD / multithreading optimization steps). This framework keeps the reference's
semantic contract — the RTiOW shading model, the three benchmark scenes, the
mrays/s metric — but is architected for an accelerator:

- the recursive radiance function becomes an iterative masked wavefront loop
  (`render/integrator.py`),
- the AVX2 two-pass sphere-intersection kernel becomes a dense masked running-min
  sweep (`render/intersect.py`), and the whole path trace a Pallas kernel
  on the GPU (`kernels/`),
- mutable xorshift RNG streams become stateless counter-based hashing
  (`core/rng.py`),
- std::thread tile scheduling becomes SPMD sharding over a `jax.sharding.Mesh`
  (`parallel/`),
- and the whole pipeline is differentiable end-to-end for inverse rendering
  (`grad/`).
"""

from rays1bench.version import __version__, VERSION_NAME

__all__ = ["__version__", "VERSION_NAME"]
