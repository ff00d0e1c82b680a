"""Inverse rendering: differentiate the renderer w.r.t. scene parameters.

The reference has no gradient capability — this subsystem is the rebuild's
extension target (BASELINE.json config 4): fit sphere centers / radii /
albedos to a target image by gradient descent through the full wavefront
renderer.

Differentiation notes (SURVEY.md §7.3):
* the hit-selection argmin is discontinuous in scene parameters; its index is
  stop_gradient'ed (render/intersect.py), so gradients flow through the hit
  *distance/normal/albedo* at fixed hit topology — the standard
  reparameterization for sphere-scene inverse rendering away from silhouettes;
* safe_sqrt keeps the VJP finite at grazing discriminants;
* the radiance loop must be the fixed-trip variant (cfg.early_exit=False):
  reverse-mode AD cannot differentiate lax.while_loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from rays1bench.core import route
from rays1bench.core.config import RenderConfig
from rays1bench.render.camera import Camera
from rays1bench.render.pipeline import render_image
from rays1bench.parallel.shard import render_image_sharded
from rays1bench.scene.soa_spheres import SphereSOA


@dataclasses.dataclass(frozen=True)
class InverseConfig:
    """Optimization hyperparameters for fit_scene."""
    learning_rate: float = 2e-2
    steps: int = 200
    # Which SphereSOA float columns are optimized; the rest stay fixed.
    optimize: Tuple[str, ...] = ("center_x", "center_y", "center_z",
                                 "radius", "albedo_x", "albedo_y", "albedo_z")
    # Optional sphere-row mask: only these rows of the optimized columns
    # receive updates (None = all rows). Weakly-observed rows (a glass
    # sphere's depth, anything near a flat loss direction) otherwise walk
    # along their gradient bias/noise under Adam's normalization.
    rows: Optional[Tuple[int, ...]] = None
    # Per-column overrides of `rows` (e.g. fit ALL albedos but only three
    # spheres' centers — the medium-scene multi-sphere fit). Columns absent
    # here fall back to `rows`. Tuple-of-pairs so the config stays hashable
    # for jit static args.
    rows_by: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None


def _grad_cfg(cfg: RenderConfig) -> RenderConfig:
    """Gradient-path config: the fixed-trip loop (reverse-mode AD cannot
    differentiate lax.while_loop) and, unless the config says otherwise,
    the index sweep the route picks (core/route.index_kernel_default): the
    sweep is gradient-free by design (stop_gradient'ed hit topology), and
    the backward replays only the O(N) chain (render/integrator.py)."""
    if cfg.early_exit:
        cfg = cfg.replace(early_exit=False)
    if cfg.pallas_intersect is None:
        cfg = cfg.replace(pallas_intersect=route.index_kernel_default())
    return cfg


def params_of(spheres: SphereSOA, names: Tuple[str, ...]) -> Dict[str, jax.Array]:
    """Extract the differentiable parameter dict from the scene SoA."""
    return {n: getattr(spheres, n) for n in names}


def with_params(spheres: SphereSOA, params: Dict[str, jax.Array]) -> SphereSOA:
    return dataclasses.replace(spheres, **params)


def render_for_loss(spheres: SphereSOA, camera: Camera, cfg: RenderConfig,
                    mesh=None) -> jax.Array:
    """Differentiable linear-radiance render (fixed-trip loop): the XLA
    renderer, sharded over `mesh`'s rays axis when one is given."""
    if mesh is None:
        img, _ = render_image(spheres, camera, _grad_cfg(cfg))
    else:
        img, _ = render_image_sharded(spheres, camera, _grad_cfg(cfg), mesh)
    return img


def image_loss(params: Dict[str, jax.Array], spheres: SphereSOA,
               camera: Camera, target: jax.Array, cfg: RenderConfig,
               mesh=None) -> jax.Array:
    """MSE in linear radiance between a render with `params` applied and the
    target image.

    With cfg.soft_silhouette > 0 the render is a STOCHASTIC estimator (the
    detached two-branch silhouette sampler, render/integrator.py), and the
    naive squared error decomposes as
        E[(img - target)^2] = (E[img] - target)^2 + Var(img):
    the variance term's gradient is a spurious force that pushes silhouettes
    away from high-contrast backgrounds regardless of the target (measured:
    it stalls the geometry fit outright). The U-statistic form used here —
    the cross product of TWO INDEPENDENT renders,
        E[(imgA - target) * (imgB - target)] = (E[img] - target)^2
    — is unbiased for the squared bias alone, with no variance term, at the
    cost of a second forward. The hard renderer is deterministic
    (imgA == imgB), where this reduces to the plain MSE."""
    sph = with_params(spheres, params)
    img = render_for_loss(sph, camera, cfg, mesh)
    if not cfg.soft_silhouette:
        return jnp.mean((img - target) ** 2)
    img_b = render_for_loss(sph, camera,
                            cfg.replace(seed=cfg.seed + 101), mesh)
    return jnp.mean((img - target) * (img_b - target))


def make_train_step(spheres_template: SphereSOA, camera: Camera,
                    cfg: RenderConfig, inv: InverseConfig, mesh=None,
                    scan_steps: int = 1):
    """Build (step_fn, optimizer) over the selected parameter dict.

    step_fn(params, opt_state, target) -> (params, opt_state, loss) is
    jittable; with a mesh the forward is shard_map'd over rays and the
    gradient reduction onto the replicated scene parameters rides the
    shard_map transpose's psum — the gradient all-reduce (SURVEY.md §5,
    "distributed communication backend").

    scan_steps > 1 chains that many Adam steps inside ONE dispatch via
    lax.scan (the training loop stays on the device), and `loss` comes back
    as f32[scan_steps] (per-chained-step losses) instead of a scalar."""
    optimizer = optax.adam(inv.learning_rate)
    n_rows = spheres_template.radius.shape[0]
    to_mask = lambda rows: jnp.zeros(n_rows).at[jnp.asarray(rows)].set(1.0)
    default_mask = None if inv.rows is None else to_mask(inv.rows)
    masks = {}
    if inv.rows_by is not None or default_mask is not None:
        by = dict(inv.rows_by or ())
        for name in inv.optimize:
            m = to_mask(by[name]) if name in by else default_mask
            if m is not None:
                masks[name] = m

    def one_step(params, opt_state, target):
        loss, grads = jax.value_and_grad(image_loss)(
            params, spheres_template, camera, target, cfg, mesh)
        if masks:
            grads = {k: g * masks[k] if k in masks else g
                     for k, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    if scan_steps <= 1:
        return jax.jit(one_step), optimizer

    @jax.jit
    def step(params, opt_state, target):
        def body(carry, _):
            params, opt_state = carry
            params, opt_state, loss = one_step(params, opt_state, target)
            return (params, opt_state), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=scan_steps)
        return params, opt_state, losses

    return step, optimizer


def fit_scene(spheres0: SphereSOA, camera: Camera, target: jax.Array,
              cfg: RenderConfig, inv: Optional[InverseConfig] = None,
              mesh=None, verbose: bool = False,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 50, scan_steps: int = 1):
    """Adam-fit scene parameters to a target image.

    With checkpoint_path set, optimizer state persists every
    `checkpoint_every` steps and the fit resumes from an existing checkpoint
    (grad/checkpoint.py). scan_steps > 1 chains that many Adam steps per
    dispatch (make_train_step) — per-step losses are still returned;
    checkpoints land on chunk boundaries. Returns (fitted_spheres,
    losses list)."""
    import os
    from rays1bench.grad import checkpoint as ckpt

    inv = inv or InverseConfig()
    scan_steps = max(1, min(scan_steps, inv.steps))
    step, optimizer = make_train_step(spheres0, camera, cfg, inv, mesh,
                                      scan_steps)
    params = params_of(spheres0, inv.optimize)
    opt_state = optimizer.init(params)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start = ckpt.restore(checkpoint_path, opt_state)
        if verbose:
            print(f"resumed from {checkpoint_path} at step {start}")
    import numpy as _np
    losses = []
    i = start
    step_rem = None
    while i < inv.steps:
        n_chunk = min(scan_steps, inv.steps - i)
        if n_chunk == scan_steps:
            step_n = step
        else:
            # Remainder chunk: rebuild the scan at the leftover length so
            # the fit lands EXACTLY on inv.steps (at most one extra compile,
            # on the final chunk of a non-dividing scan_steps).
            if step_rem is None:
                step_rem, _ = make_train_step(spheres0, camera, cfg, inv,
                                              mesh, n_chunk)
            step_n = step_rem
        params, opt_state, loss = step_n(params, opt_state, target)
        chunk = [float(x) for x in _np.asarray(loss).reshape(-1)]
        losses.extend(chunk)
        i += len(chunk)
        if verbose and (any(s % 10 == 0 for s in range(i - len(chunk), i))
                        or i >= inv.steps):
            print(f"step {i - 1:4d}  loss {losses[-1]:.6g}")
        if checkpoint_path and (i % checkpoint_every < len(chunk)
                                or i >= inv.steps):
            ckpt.save(checkpoint_path, params, opt_state, i)
    return with_params(spheres0, params), losses


def fit_camera(spheres: SphereSOA, spec, target: jax.Array,
               cfg: RenderConfig, learning_rate: float = 5e-3,
               steps: int = 100, optimize: Tuple[str, ...] = ("lookfrom",
                                                              "vfov"),
               verbose: bool = False):
    """Adam-fit CAMERA parameters (lookfrom and/or vfov) to a target image.

    Gradients reach the camera through the renderer's ray generation:
    `spec` (a render.camera.CameraSpec) provides the initial guess
    and the fixed parameters (lookat, vup, aperture, focus_dist, aspect);
    the differentiable constructor render/camera.build_camera re-derives
    the ray-gen basis from the fitted leaves every step, so gradients flow
    target -> image -> rays -> basis -> (lookfrom, vfov). The scene is held
    fixed. Returns (fitted_params dict, losses list). Reference camera
    parameters being recovered: rayweek1.cpp:364-394 (Camera::init args).
    """
    from rays1bench.render.camera import build_camera

    all_params = {"lookfrom": jnp.asarray(spec.lookfrom, jnp.float32),
                  "vfov": jnp.asarray(spec.vfov, jnp.float32)}
    params = {k: all_params[k] for k in optimize}

    def loss_fn(p):
        full = dict(all_params, **p)
        cam = build_camera(full["lookfrom"], spec.lookat, spec.vup,
                           full["vfov"], spec.aspect, spec.aperture,
                           spec.focus_dist)
        img = render_for_loss(spheres, cam, cfg)
        return jnp.mean((img - target) ** 2)

    optimizer = optax.adam(learning_rate)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = optimizer.init(params)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"camera step {i:4d}  loss {losses[-1]:.6g}")
    return params, losses
