"""Render configuration.

The reference configures everything at compile time with preprocessor macros
(reference: src/common/common.h:3-31 — SCREEN_W/H, NUM_SAMPLES_PER_PIXEL,
MAX_BOUNCES, QUICKBENCH, MULTITHREADED). In JAX this becomes a hashable frozen
dataclass: every field is static under `jax.jit`, so changing a config
recompiles exactly like rebuilding the C++ did, and the hot path sees only
compile-time constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (jit-static; hashable).

    Mirrors the reference's macro config (src/common/common.h:3-31) plus the
    runtime knobs the JAX rebuild needs.
    """

    width: int = 1280              # SCREEN_W (common.h:20)
    height: int = 720              # SCREEN_H (common.h:21)
    spp: int = 10                  # NUM_SAMPLES_PER_PIXEL (common.h:24-28)
    # Reference MAX_BOUNCES is 50 (common.h:19): scatter is allowed while
    # depth < max_bounces, so a path traces at most max_bounces+1 segments.
    max_bounces: int = 50
    t_min: float = 1e-3            # world->hit(r, 0.001f, FLT_MAX) (rayweek1.cpp:519)
    t_max: float = 3.4e38          # FLT_MAX

    # Knobs with no reference analog:
    # Rays processed per device-side chunk of the XLA renderer; the wavefront
    # loop runs per chunk. A multiple of 1024.
    ray_chunk: int = 131072
    # Seed for the stateless counter-based RNG (replaces the reference's fixed
    # xorshift seeds, e.g. state=10001 in the ST path, rayweek1.cpp:880).
    seed: int = 10001
    # If True the radiance loop exits early once every ray in the chunk is
    # dead (lax.while_loop); if False it runs a fixed-trip scan, which is what
    # reverse-mode AD needs.
    early_exit: bool = True
    # Run the XLA renderer's closest-hit index sweep as the Triton kernel
    # (kernels/intersect_pallas.py) instead of XLA's fused reduction.
    # Gradients are unaffected (hit topology is stop_gradient'ed either way).
    # None = auto: off in the plain forward render, and in the gradient path
    # (grad/inverse._grad_cfg) on exactly when running on a GPU
    # (core/route.index_kernel_default). Pass a bool to override either way.
    pallas_intersect: Optional[bool] = None
    # Soft-silhouette relaxation width for inverse rendering (0 = off, the
    # exact renderer), in WORLD units of the silhouette edge coordinate
    # edge = |r| - b (b = ray-to-center distance; linear in the impact
    # parameter, 0 at the silhouette, positive inside). When > 0, every
    # lane grazing a sphere (|edge| within ~9.2 * soft_silhouette, in front
    # of its current hit) becomes a soft hit with
    # cover = sigmoid(edge / soft_silhouette), and the integrator runs the
    # DETACHED TWO-BRANCH estimator: bounce off the sphere with probability
    # stop_grad(cover) or pass through it from the far-exit point, with
    # ratio weights cover/sg(cover) and (1-cover)/sg(1-cover) — weights are
    # exactly 1 at evaluation (the render equals the hard image in
    # expectation) but their derivative carries the two-sided silhouette
    # term against the TRUE occluded background. Interior hits saturate to
    # cover = 1 (always bounce, weight 1: the exact render). This makes
    # silhouette motion differentiable (d cover / d center, radius != 0 at
    # the edge), which the fixed-topology gradient (SURVEY.md §7.3)
    # structurally lacks — the enabler for fitting sphere GEOMETRY to images
    # (examples/inverse_rendering.py --fit-geometry). Calibration
    # (seed-averaged finite differences, 2026-08-20): the analytic
    # gradient matches the seed-averaged FD of its own estimator to ~1.0 at
    # every width, and the HARD render's FD silhouette derivative to
    # 0.66-0.72 at width 0.02 / 0.94-0.96 at width 0.005 — use ~0.005
    # (1% of the RTiOW unit sphere radius) unless the fit needs a wider
    # basin. Fitting with a stochastic render needs the cross-seed
    # U-statistic loss (grad/inverse.image_loss, automatic). Affects the
    # XLA/grad pipeline only; the respawn kernel renders hard images.
    soft_silhouette: float = 0.0

    @property
    def aspect(self) -> float:
        """Camera aspect ratio, SCREEN_W / SCREEN_H (rayweek1.cpp:566)."""
        return float(self.width) / float(self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def num_primary_rays(self) -> int:
        return self.num_pixels * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Named presets. "full"/"quick" match the reference's two compile profiles
# (common.h:3-31); "baseline_*" are the rebuild's benchmark configs from
# BASELINE.json.
PRESETS = {
    # Reference single-threaded profile: 1280x720 @ 10 spp (common.h:20-28).
    "full": RenderConfig(),
    # Reference multithreaded profile renders 25x more samples (common.h:25).
    "full_mt": RenderConfig(spp=250),
    # QUICKBENCH: 80x60 @ 4 spp (common.h:8-15).
    "quick": RenderConfig(width=80, height=60, spp=4),
    "quick_mt": RenderConfig(width=80, height=60, spp=100),
    # BASELINE.json configs for the rebuild.
    "baseline_small": RenderConfig(width=200, height=100, spp=4, max_bounces=10),
    "baseline_medium": RenderConfig(width=400, height=200, spp=16, max_bounces=10),
    "baseline_large": RenderConfig(width=1280, height=720, spp=16, max_bounces=10),
    "baseline_large_4spp": RenderConfig(width=1280, height=720, spp=4, max_bounces=10),
}


def get_config(name: str, **overrides) -> RenderConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
