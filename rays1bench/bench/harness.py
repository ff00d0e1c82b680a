"""Benchmark driver + result logging.

The analog of the reference's benchmark() driver and RESULT/log_results
records (reference: src/latest/rayweek1.cpp:845-927, src/common/common.h:36-77):
time a full render, count rays by the reference metric, average over N runs,
and persist `version|time|rays|mrays/s|` pipe-delimited records to
out_<scene>.txt — byte-compatible with the reference's files so the report
generator can mix both.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax

from rays1bench.core.config import RenderConfig
from rays1bench.version import VERSION_NAME


@dataclasses.dataclass
class BenchResult:
    """Mirror of RESULT (common.h:36-45)."""
    elapsed_seconds: float
    num_rays: int

    @property
    def mrays_per_sec(self) -> float:
        return (self.num_rays / self.elapsed_seconds / 1e6
                if self.elapsed_seconds else 0.0)


def benchmark(scene, cfg: RenderConfig, num_runs: int = 1,
              write_tga: Optional[str] = None, render_fn=None,
              warmup: bool = True) -> List[BenchResult]:
    """Run the renderer num_runs times; returns one BenchResult per run.

    render_fn(spheres, camera, cfg) -> (image, num_rays) defaults to the
    kernel pipeline; pass the XLA/sharded variant to benchmark it. Each run
    is one dispatch, timed to block_until_ready."""
    if render_fn is None:
        render_fn = _default_render_fn(scene)
    camera = scene.camera.build()

    if warmup:  # compile outside the timed region (benchmark() times only
        # the render, rayweek1.cpp:866-891)
        jax.block_until_ready(render_fn(scene.spheres, camera, cfg))

    results = []
    for _ in range(num_runs):
        t0 = time.perf_counter()
        img, num_rays = jax.block_until_ready(
            render_fn(scene.spheres, camera, cfg))
        dt = time.perf_counter() - t0
        results.append(BenchResult(dt, int(num_rays)))
    if write_tga:
        import numpy as np
        from rays1bench.runtime import native
        # Host-side finishing via the native runtime: tonemap + TGA encode
        # (C++; falls back to Python automatically).
        native.tga_write_rgb24(write_tga, native.tonemap_u8(np.asarray(img)))
    return results


def _default_render_fn(scene):
    """Kernel pipeline with the scene's real-sphere trim applied."""
    from rays1bench.kernels.pipeline import render_image_pallas
    n_real = getattr(scene, "n_real", None) or None
    return (lambda sph, cam, cfg_, _nr=n_real:
            render_image_pallas(sph, cam, cfg_, n_real=_nr))


def benchmark_sustained(scene, cfg: RenderConfig, frames: int = 8,
                        num_runs: int = 3, render_fn=None) -> BenchResult:
    """Sustained throughput: `frames` renders inside ONE jit dispatch
    (lax.scan), timed to block_until_ready, best of num_runs.

    Each frame shifts the scene by a sub-visible salt (1e-7 world units per
    frame index), so XLA cannot hoist the render out of the loop as
    loop-invariant; counts are summed per frame. Returns the BenchResult of
    the whole batch (divide by `frames` for per-frame time)."""
    import dataclasses as _dc
    import jax.numpy as jnp

    if render_fn is None:
        render_fn = _default_render_fn(scene)
    camera = scene.camera.build()

    @jax.jit
    def bench_n(spheres, salts):
        def body(carry, salt):
            sph = _dc.replace(spheres, center_x=spheres.center_x + salt)
            img, nrays = render_fn(sph, camera, cfg)
            # per-frame counts out via ys: a uint32 total would wrap past
            # 2^32 rays (e.g. 8 frames of the 250-spp profile)
            return carry + img.sum(), nrays.astype(jnp.uint32)
        return jax.lax.scan(body, jnp.float32(0), salts)

    salts = jnp.arange(1, frames + 1, dtype=jnp.float32) * 1e-7
    jax.block_until_ready(bench_n(scene.spheres, salts))  # compile + warm
    best = None
    for _ in range(num_runs):
        t0 = time.perf_counter()
        _, per_frame = jax.block_until_ready(bench_n(scene.spheres, salts))
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best = dt
            rays = int(sum(int(x) for x in per_frame))
    return BenchResult(best, rays)


def log_results(scene_name: str, results: List[BenchResult],
                version: str = VERSION_NAME, directory: str = ".") -> str:
    """Average runs and write out_<scene>.txt in the reference's pipe format
    (common.h:47-77). Returns the record string."""
    n = len(results)
    avg_t = sum(r.elapsed_seconds for r in results) / n
    avg_rays = sum(r.num_rays for r in results) // n
    mrays = avg_rays / avg_t / 1e6 if avg_t else 0.0
    record = f"{version}|{avg_t:.3f}s|{avg_rays}|{mrays:0.3f} mrays/s|"
    import os
    with open(os.path.join(directory, f"out_{scene_name}.txt"), "w") as f:
        f.write(record)
    return record
