"""Auxiliary subsystem tests: metrics, checkpoint/resume, fault retry,
scaling sweep, profiling hooks (SURVEY.md §5 coverage)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from rays1bench.core.config import RenderConfig
from rays1bench.utils.metrics import (ScalingPoint, mrays_per_sec,
                                      scaling_efficiency)
from rays1bench.utils import profiling
from rays1bench.grad import checkpoint as ckpt
from rays1bench.parallel.multihost import render_with_retry


def test_mrays_metric_definition():
    # reference: rays / seconds / 1e6 (common.h:41-44)
    assert mrays_per_sec(25_236_618, 58.601) == pytest.approx(0.4306, abs=1e-3)
    assert mrays_per_sec(100, 0.0) == 0.0


def test_scaling_efficiency():
    pts = [ScalingPoint(1, 1000, 1.0), ScalingPoint(2, 2000, 1.0),
           ScalingPoint(4, 4000, 1.25)]
    effs = scaling_efficiency(pts)
    assert effs[0] == pytest.approx(1.0)
    assert effs[1] == pytest.approx(1.0)
    assert effs[2] == pytest.approx(0.8)


def test_checkpoint_roundtrip(tmp_path):
    params = {"center_x": jnp.arange(4.0), "radius": jnp.ones(4)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    # advance one step so the state is nontrivial
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, state = opt.update(grads, state, params)
    params = optax.apply_updates(params, updates)

    path = str(tmp_path / "ck.npz")
    ckpt.save(path, params, state, step=7)
    p2, s2, step = ckpt.restore(path, state)
    assert step == 7
    np.testing.assert_allclose(np.asarray(p2["center_x"]),
                               np.asarray(params["center_x"]))
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_fit_scene_resumes(tmp_path):
    """fit_scene picks up where the checkpoint left off."""
    from rays1bench.grad.inverse import InverseConfig, fit_scene
    from rays1bench.render.camera import CameraSpec
    from rays1bench.scene.soa_spheres import SphereSOABuilder
    from rays1bench.scene.spheres import METAL

    cfg = RenderConfig(width=32, height=16, spp=1, max_bounces=2,
                       early_exit=False, seed=5)
    b = SphereSOABuilder()
    b.add(0, 0, 0, 2.0, METAL, 0.9, 0.8, 0.7, 0.0, 1.0)
    spheres = b.finalize(pad_multiple=8)
    cam = CameraSpec(lookfrom=(0, 0, 2.4), lookat=(0, 0, 0), vfov=45,
                     aspect=cfg.aspect, aperture=0.0, focus_dist=3.0).build()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    path = str(tmp_path / "fit.npz")
    inv = InverseConfig(steps=4, optimize=("albedo_x",), learning_rate=1e-2)
    _, losses1 = fit_scene(spheres, cam, target, cfg, inv,
                           checkpoint_path=path, checkpoint_every=2)
    assert len(losses1) == 4 and os.path.exists(path)
    # resume: steps already done -> no further loss entries
    inv2 = InverseConfig(steps=6, optimize=("albedo_x",), learning_rate=1e-2)
    _, losses2 = fit_scene(spheres, cam, target, cfg, inv2,
                           checkpoint_path=path, checkpoint_every=2)
    assert len(losses2) == 2  # resumed at step 4 of 6


def test_render_with_retry_recovers():
    calls = {"n": 0}

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] == 2:  # second shard fails once
            raise RuntimeError("simulated device failure")
        return ids.astype(np.float32) * 2.0

    shards = [np.arange(4), np.arange(4, 8)]
    out, retried = render_with_retry(flaky, shards)
    np.testing.assert_allclose(out, np.arange(8) * 2.0)
    assert retried == 1


def test_render_image_with_retry_recovers_bit_exactly(tmp_path):
    """The WIRED fault-recovery path: a full image through
    render_image_with_retry with injected transient shard failures is
    BITWISE identical to the same sharded render with no failures (a
    retried shard is indistinguishable from a never-failed one — stateless
    RNG), counts exactly the rays of render_image(), and matches its image
    to the same 1-ULP bound as any other chunk-split (XLA may fuse a
    2048-wide chunk differently than a 5120-wide one)."""
    from rays1bench.parallel.multihost import render_image_with_retry
    from rays1bench.render.pipeline import render_image
    from rays1bench.scene.builders import create_small_scene

    cfg = RenderConfig(width=64, height=40, spp=2, max_bounces=6,
                       ray_chunk=8192)
    scene = create_small_scene(cfg.aspect)
    camera = scene.camera.build()
    ref, n_ref = render_image(scene.spheres, camera, cfg)
    clean, n_clean, r0 = render_image_with_retry(scene.spheres, camera, cfg,
                                                 num_shards=4)
    assert r0 == 0

    fails = {"left": 2}

    def inject(fn):
        def wrapped(ids):
            if fails["left"] > 0:
                fails["left"] -= 1
                raise RuntimeError("simulated device failure")
            return fn(ids)
        return wrapped

    img, n, retried = render_image_with_retry(scene.spheres, camera, cfg,
                                              num_shards=4,
                                              _render_shard=inject)
    assert retried == 2 and fails["left"] == 0
    assert int(n) == int(n_ref) == int(n_clean)
    assert (np.asarray(img) == np.asarray(clean)).all()
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


def test_profiling_trace_produces_artifact(tmp_path):
    """profiling.trace actually captures a profile: the logdir gains a
    plugins/profile/<ts>/*.xplane.pb artifact (the TensorBoard/Perfetto
    input — the VTune-analog evidence SURVEY.md §5 asks for)."""
    import glob
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("test-span"):
            jax.block_until_ready(jnp.arange(128.0) * 2.0)
    found = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    assert found, f"no xplane.pb under {logdir}"


def test_profiling_hooks_smoke(tmp_path):
    with profiling.annotate("test-span"):
        pass
    stats = profiling.device_memory_stats()
    assert stats is None or isinstance(stats, dict)


def test_fit_scene_scan_steps_equivalent():
    """fit_scene(scan_steps=N) — N Adam steps chained per dispatch via
    lax.scan (the on-device training loop) — produces the same per-step
    losses and the same fitted parameters as the per-step loop."""
    import dataclasses
    from rays1bench.grad.inverse import (InverseConfig, fit_scene,
                                         render_for_loss)
    from rays1bench.scene.builders import create_small_scene

    cfg = RenderConfig(width=48, height=24, spp=1, max_bounces=2,
                       early_exit=False, ray_chunk=4096)
    scene = create_small_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()
    target = render_for_loss(scene.spheres, camera, cfg)
    pert = dataclasses.replace(scene.spheres,
                               albedo_x=scene.spheres.albedo_x * 0.7)
    inv = InverseConfig(learning_rate=1e-2, steps=12, optimize=("albedo_x",))
    f1, l1 = fit_scene(pert, camera, target, cfg, inv)
    f2, l2 = fit_scene(pert, camera, target, cfg, inv, scan_steps=4)
    assert len(l1) == len(l2) == 12
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f1.albedo_x),
                               np.asarray(f2.albedo_x), rtol=1e-6)
    # Non-dividing scan_steps (12 = 5 + 5 + 2): the remainder chunk clamps
    # to inv.steps — no overshoot in losses, params, or step count.
    f3, l3 = fit_scene(pert, camera, target, cfg, inv, scan_steps=5)
    assert len(l3) == 12
    np.testing.assert_allclose(l1, l3, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f1.albedo_x),
                               np.asarray(f3.albedo_x), rtol=1e-6)
