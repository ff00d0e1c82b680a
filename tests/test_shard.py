"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: distributed tests runnable on a CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rays1bench.core.config import RenderConfig
from rays1bench.parallel.mesh import make_mesh
from rays1bench.parallel.shard import render_image_sharded
from rays1bench.render.pipeline import render_image
from rays1bench.scene.builders import create_small_scene

CFG = RenderConfig(width=64, height=40, spp=2, max_bounces=6, ray_chunk=1024)


@pytest.fixture(scope="module")
def scene_and_camera():
    scene = create_small_scene(CFG.aspect)
    return scene, scene.camera.build()


def test_eight_virtual_devices_present():
    assert len(jax.devices()) >= 8


def test_sharded_matches_single_device(scene_and_camera):
    """Stateless RNG + static sharding => the sharded render is numerically
    identical to the single-device one (the property the reference's
    per-thread RNG streams explicitly lack, README.md:1188)."""
    scene, camera = scene_and_camera
    ref, n_ref = render_image(scene.spheres, camera, CFG)
    for n_dev in (2, 8):
        mesh = make_mesh(n_dev)
        img, n = render_image_sharded(scene.spheres, camera, CFG, mesh)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6)
        assert int(n) == int(n_ref)


def test_graft_entry_dryrun():
    """The driver's multichip dry-run path."""
    import importlib.util, os
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), os.pardir,
                                    "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    img, n = jax.jit(fn)(*args)
    assert img.shape[2] == 3
    mod.dryrun_multichip(8)


def test_high_spp_sample_sharding(scene_and_camera):
    """BASELINE config 5's shape at test scale: a high-spp render (sample
    axis folded into the ray stream) sharded over all 8 devices, ray counts
    and image identical to single-device."""
    scene, camera = scene_and_camera
    cfg = CFG.replace(width=32, height=16, spp=64, ray_chunk=4096)
    ref, n_ref = render_image(scene.spheres, camera, cfg)
    img, n = render_image_sharded(scene.spheres, camera, cfg, make_mesh(8))
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)
    assert int(n) == int(n_ref)


def _pallas_single_ref(scene, camera, cfg):
    """Single-device respawn-kernel render in the interpreter (CPU)."""
    from rays1bench.kernels.pipeline import render_image_pallas
    return render_image_pallas(scene.spheres, camera, cfg,
                               n_real=scene.n_real, interpret=True)


def test_pallas_sharded_matches_single_device(scene_and_camera):
    """The multi-device path (the respawn kernel under shard_map) is
    bit-identical to the single-device kernel render: whole pixels per
    device, the same serial sample order per lane."""
    from rays1bench.parallel.shard import render_image_pallas_sharded

    scene, camera = scene_and_camera
    ref, n_ref = _pallas_single_ref(scene, camera, CFG)
    for n_dev in (2, 8):
        img, n = render_image_pallas_sharded(
            scene.spheres, camera, CFG, make_mesh(n_dev),
            n_real=scene.n_real, interpret=True)
        assert int(n) == int(n_ref)
        assert (np.asarray(img) == np.asarray(ref)).all()


def test_pallas_sharded_untrimmed_scene(scene_and_camera):
    """Without n_real the kernel sweeps the placeholder rows too (poisoned,
    never hit): same rays and a bit-identical image, sharded or not."""
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.parallel.shard import render_image_pallas_sharded

    scene, camera = scene_and_camera
    ref, n_ref = _pallas_single_ref(scene, camera, CFG)
    one, n_one = render_image_pallas(scene.spheres, camera, CFG,
                                     interpret=True)
    img, n = render_image_pallas_sharded(scene.spheres, camera, CFG,
                                         make_mesh(4), interpret=True)
    assert int(n) == int(n_one) == int(n_ref)
    assert (np.asarray(img) == np.asarray(one)).all()
    assert (np.asarray(one) == np.asarray(ref)).all()


def test_pallas_sharded_respawn(scene_and_camera):
    """The sharded kernel against the XLA renderer (the plain reference)
    at several device counts: identical per-ray trajectories, so the ray
    counts are EXACT and pixels agree up to sample-summation order."""
    from rays1bench.parallel.shard import render_image_pallas_sharded

    scene, camera = scene_and_camera
    cfg = CFG.replace(spp=4)
    ref, n_ref = render_image(scene.spheres, camera, cfg)
    for n_dev in (1, 3, 8):
        img, n = render_image_pallas_sharded(
            scene.spheres, camera, cfg, make_mesh(n_dev),
            n_real=scene.n_real, interpret=True)
        assert int(n) == int(n_ref), n_dev
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6, err_msg=str(n_dev))


def test_pallas_sharded_2d_mesh(scene_and_camera):
    """(tiles, samples) 2-D mesh factorizations (SURVEY.md §7.2-6) render
    the same image: per-ray radiance is identical (stateless RNG on global
    ray ids), ray counts are exact; pixel means agree to float rounding
    (sample slices are summed in another order), and bitwise when the
    sample axis has size 1."""
    from rays1bench.parallel.mesh import make_mesh2d
    from rays1bench.parallel.shard import render_image_pallas_sharded

    scene, camera = scene_and_camera
    cfg = CFG.replace(spp=4)
    ref, n_ref = _pallas_single_ref(scene, camera, cfg)
    for n_tiles, n_samp in ((2, 4), (4, 2), (8, 1), (1, 4)):
        mesh = make_mesh2d(n_tiles, n_samp)
        img, n = render_image_pallas_sharded(
            scene.spheres, camera, cfg, mesh, axis_name="tiles",
            sample_axis="samples", n_real=scene.n_real, interpret=True)
        assert int(n) == int(n_ref), (n_tiles, n_samp)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-7, err_msg=str((n_tiles, n_samp)))
        if n_samp == 1:
            assert (np.asarray(img) == np.asarray(ref)).all(), (n_tiles,
                                                                n_samp)


def test_sharded_telemetry(scene_and_camera):
    """telemetry=True returns per-DEVICE ray counts and kernel step counts
    (the SPMD analog of the reference's per-thread ray counters,
    rayweek1.cpp:79-95, 809-813): counts sum to the psum'd total, busy
    devices report steps, and the image is unchanged."""
    from rays1bench.parallel.mesh import make_mesh2d
    from rays1bench.parallel.shard import render_image_pallas_sharded

    scene, camera = scene_and_camera
    cfg = CFG.replace(width=48, height=24, max_bounces=4)
    mesh = make_mesh(4)
    base_img, base_n = render_image_pallas_sharded(
        scene.spheres, camera, cfg, mesh, n_real=scene.n_real,
        interpret=True)
    img, n, telem = render_image_pallas_sharded(
        scene.spheres, camera, cfg, mesh, n_real=scene.n_real,
        interpret=True, telemetry=True)
    assert (np.asarray(img) == np.asarray(base_img)).all()
    assert int(n) == int(base_n)
    rays = np.asarray(telem["device_rays"])
    iters = np.asarray(telem["device_iters"])
    assert rays.shape == (4,) and iters.shape == (4,)
    assert int(rays.sum()) == int(n), (rays, int(n))
    assert (iters[rays > 0] > 0).all(), (iters, rays)

    # 2-D (tiles, samples) mesh: telemetry comes back mesh-shaped.
    img2, n2, telem2 = render_image_pallas_sharded(
        scene.spheres, camera, cfg, make_mesh2d(2, 2), axis_name="tiles",
        sample_axis="samples", n_real=scene.n_real, interpret=True,
        telemetry=True)
    rays2 = np.asarray(telem2["device_rays"])
    assert rays2.shape == (2, 2)
    assert int(rays2.sum()) == int(n2) == int(n)


def test_sharded_grad_matches_single():
    """One sharded training step's loss and gradient (the XLA renderer
    under shard_map, gradient reduced by the shard_map transpose's psum)
    against the single-device ones."""
    from rays1bench.grad.inverse import image_loss, params_of

    cfg = CFG.replace(width=32, height=16, max_bounces=3, early_exit=False)
    scene = create_small_scene(cfg.aspect)
    camera = scene.camera.build()
    params = params_of(scene.spheres, ("center_y", "radius", "albedo_x"))
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    l1, g1 = jax.value_and_grad(image_loss)(params, scene.spheres, camera,
                                            target, cfg)
    l4, g4 = jax.value_and_grad(image_loss)(params, scene.spheres, camera,
                                            target, cfg, make_mesh(4))
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g4[k]), np.asarray(g1[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
