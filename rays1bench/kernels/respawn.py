"""Persistent-lane sample-respawn path tracer: one Pallas kernel on the
Triton route.

The reference's hot region — the per-ray recursion of intersection
(reference: src/latest/rayweek1.cpp:152-339), scatter (:396-512) and radiance
(:515-536) — runs as ONE kernel. Each program owns a tile of `block` pixels
(a tw x th pixel rectangle, both powers of two); each lane owns one pixel and
traces that pixel's samples one after another:

* ray state, the per-pixel radiance sums and the ray counter are loop
  carries — they stay in registers for the whole program, and the outputs
  are written once, at the end;
* the moment a lane's path ends (sky miss, absorption, bounce cap) the lane
  regenerates its pixel's next sample in place — the stateless RNG and the
  thin-lens camera make ray generation pure per-lane arithmetic, so a lane
  retires each ray the instant it dies, as the recursion does, with no queue
  and no compaction. A program ends when every lane has used up its samples,
  so the slowest ray of a whole chunk no longer holds the others back;
* the sphere table (at most 16 x 4096 f32 = 256 KB for the giant scene, 32 KB
  for the 512-row large scene) is read by every program with scalar loads
  and stays L1/L2 resident. The closest-hit sweep carries only
  (best_t, best_index) per lane; the winner's payload columns are gathered
  once per bounce after the sweep, exactly (no packing).

Scatter, the RNG and the camera are the same jnp code the XLA renderer runs
(render/materials.py, core/rng.py, render/camera.py), traced into the kernel,
so per-ray math matches render/pipeline.render_image (tested in interpret
mode with exact ray counts). Only the order in which a pixel's samples are
summed differs.
"""

from __future__ import annotations

import functools
import types
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rays1bench.core import rng as rng_mod
from rays1bench.core.config import RenderConfig
from rays1bench.render.camera import Camera
from rays1bench.render.intersect import HitRecord
from rays1bench.render.integrator import sky_color
from rays1bench.render.materials import scatter
from rays1bench.scene.spheres import PreparedSpheres

_BIG = np.float32(3.0e38)
_INF = np.float32(np.inf)

# Sphere-table rows (see pack_spheres). Row count is padded to a power of
# two: the Triton route takes power-of-two block shapes only.
_COLUMNS = ("center_x", "center_y", "center_z", "radius_sq", "inv_radius",
            "albedo_x", "albedo_y", "albedo_z", "fuzz", "ref_idx", "mat_type")
(_CX, _CY, _CZ, _RSQ, _INVR, _ALBX, _ALBY, _ALBZ, _FUZZ, _REFIDX,
 _MAT) = range(len(_COLUMNS))
TABLE_ROWS = 16
_CAM_SLOTS = 32


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pack_spheres(prep: PreparedSpheres, rows: int = 0) -> jax.Array:
    """Stack the sphere columns into one (16, S') f32 table, S' the next
    power of two >= max(S, rows). radius_sq of placeholder rows (and of the
    padding columns) is poisoned to -1e30, which makes their discriminant
    negative for every ray — no validity mask in the sweep."""
    cols = [getattr(prep, name).astype(jnp.float32) for name in _COLUMNS]
    cols[_RSQ] = jnp.where(prep.valid > 0.0, prep.radius_sq, -1e30)
    table = jnp.stack(cols)
    width = _pow2_at_least(max(prep.count, rows, 8))
    pad = jnp.zeros((TABLE_ROWS - len(_COLUMNS), prep.count), jnp.float32)
    table = jnp.concatenate([table, pad])
    return jnp.pad(table, ((0, 0), (0, width - prep.count))).at[
        _RSQ, prep.count:].set(-1e30)


def pack_camera(camera: Camera) -> jax.Array:
    """Flatten the Camera pytree into one f32[32] vector: origin(3),
    lower_left(3), horizontal(3), vertical(3), u(3), v(3), lens_radius(1),
    zero padding. Read back by _camera_view."""
    flat = jnp.concatenate([
        camera.origin, camera.lower_left, camera.horizontal, camera.vertical,
        camera.u, camera.v, camera.lens_radius.reshape(1)])
    return jnp.pad(flat, (0, _CAM_SLOTS - flat.shape[0]))


def _camera_view(cam_ref):
    """A Camera-shaped view over scalar loads. generate_rays only indexes
    its fields with [i], so tuples of scalars stand in for the arrays and the
    traced ray generation is the XLA renderer's own code."""
    g = lambda i: cam_ref[i]
    return types.SimpleNamespace(
        origin=(g(0), g(1), g(2)), lower_left=(g(3), g(4), g(5)),
        horizontal=(g(6), g(7), g(8)), vertical=(g(9), g(10), g(11)),
        u=(g(12), g(13), g(14)), v=(g(15), g(16), g(17)), lens_radius=g(18))


def closest_index(table_ref, ox, oy, oz, dx, dy, dz, *, count: int,
                  unroll: int, t_min: float):
    """Dense closest-hit sweep over the first `count` table columns.

    Returns (best_t, best_index) per lane; best_t >= 3e38 means a miss.
    Misses rely on IEEE NaN: sqrt of a negative discriminant is NaN, every
    comparison with NaN is false, so a missed sphere never wins. '<' keeps
    the first minimum, the tie order of the XLA renderer's argmin."""
    tmin_c = np.float32(t_min)

    def one_sphere(s, carry):
        bt, bi = carry
        cox = table_ref[_CX, s] - ox
        coy = table_ref[_CY, s] - oy
        coz = table_ref[_CZ, s] - oz
        nb = cox * dx + coy * dy + coz * dz
        c = cox * cox + coy * coy + coz * coz - table_ref[_RSQ, s]
        sq = jnp.sqrt(nb * nb - c)
        t1 = nb - sq
        t = jnp.where(t1 > tmin_c, t1, nb + sq)
        better = (t < bt) & (t > tmin_c)
        return jnp.where(better, t, bt), jnp.where(better, s, bi)

    def group(g, carry):
        for k in range(unroll):
            carry = one_sphere(g * unroll + k, carry)
        return carry

    init = (jnp.zeros_like(ox) + _INF, jnp.zeros(ox.shape, jnp.int32))
    return jax.lax.fori_loop(0, -(-count // unroll), group, init)


def _closest_hit(table_ref, ox, oy, oz, dx, dy, dz, **sweep) -> HitRecord:
    """HitRecord of the closest hit: the sweep, then one gather per payload
    column of the winner (exact columns, no packing)."""
    bt, bi = closest_index(table_ref, ox, oy, oz, dx, dy, dz, **sweep)
    col = lambda row: plgpu.load(table_ref.at[row, bi])
    hit = bt < _BIG
    t = jnp.where(hit, bt, 1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    cx, cy, cz, inv_r = col(_CX), col(_CY), col(_CZ), col(_INVR)
    return HitRecord(
        hit=hit, t=t, px=px, py=py, pz=pz,
        nx=(px - cx) * inv_r, ny=(py - cy) * inv_r, nz=(pz - cz) * inv_r,
        mat_type=col(_MAT).astype(jnp.int32),
        albedo_x=col(_ALBX), albedo_y=col(_ALBY), albedo_z=col(_ALBZ),
        fuzz=col(_FUZZ), ref_idx=col(_REFIDX))


def _respawn_kernel(span_ref, table_ref, cam_ref, rr_ref, rg_ref, rb_ref,
                    cnt_ref, *iters_ref, count: int, unroll: int, spp: int,
                    width: int, height: int, tw: int, th: int, gx: int,
                    max_bounces: int, t_min: float, seed: int):
    """One program: the tw x th pixel tile number span[0] + program_id,
    every pixel tracing samples [span[1], span[2])."""
    tile = span_ref[0] + pl.program_id(0)
    s_lo = span_ref[1]
    s_hi = span_ref[2]
    lane = jax.lax.iota(jnp.int32, tw * th)
    x = (tile % gx) * tw + lane % tw
    y = (tile // gx) * th + lane // tw
    valid = (x < width) & (y < height)
    pid = y * width + x
    xf = x.astype(jnp.float32)
    yf = y.astype(jnp.float32)
    seed_c = np.uint32(seed)
    spp_c = np.int32(spp)
    cam = _camera_view(cam_ref)
    zero = jnp.zeros(lane.shape, jnp.float32)
    one = zero + 1.0

    def make_ray(s_idx):
        # The XLA renderer's raygen (render/pipeline._trace_chunk), keyed on
        # the true ray id, so a respawned sample draws exactly its rays.
        rid = pid * spp_c + s_idx
        ju, jv = rng_mod.pixel_jitter(seed_c, rid)
        return Camera.generate_rays(cam, (xf + ju) * np.float32(1.0 / width),
                                    (yf + jv) * np.float32(1.0 / height),
                                    seed_c, rid)

    def step(carry):
        (it, _, ox, oy, oz, dx, dy, dz, ar, ag, ab, alive, s_idx, b,
         rr, rg, rb, cnt) = carry
        cnt = cnt + alive.astype(jnp.int32)
        rec = _closest_hit(table_ref, ox, oy, oz, dx, dy, dz, count=count,
                           unroll=unroll, t_min=t_min)

        # Miss -> sky, straight into the pixel sums (rayweek1.cpp:530-534).
        skr, skg, skb = sky_color(dx, dy, dz)
        miss = alive & ~rec.hit
        rr = rr + jnp.where(miss, ar * skr, 0.0)
        rg = rg + jnp.where(miss, ag * skg, 0.0)
        rb = rb + jnp.where(miss, ab * skb, 0.0)

        (sx, sy, sz), (mr, mg, mb), ok = scatter(dx, dy, dz, rec, seed_c,
                                                 pid * spp_c + s_idx, b)
        cont = alive & rec.hit & ok & (b < max_bounces)
        ox = jnp.where(cont, rec.px, ox)
        oy = jnp.where(cont, rec.py, oy)
        oz = jnp.where(cont, rec.pz, oz)
        dx = jnp.where(cont, sx, dx)
        dy = jnp.where(cont, sy, dy)
        dz = jnp.where(cont, sz, dz)
        ar = jnp.where(cont, ar * mr, ar)
        ag = jnp.where(cont, ag * mg, ag)
        ab = jnp.where(cont, ab * mb, ab)
        b = jnp.where(cont, b + 1, b)

        # Respawn: a lane whose path just ended starts its next sample.
        resp = alive & ~cont & (s_idx < s_hi - 1)
        s_idx = jnp.where(resp, s_idx + 1, s_idx)
        nox, noy, noz, ndx, ndy, ndz = make_ray(s_idx)
        ox = jnp.where(resp, nox, ox)
        oy = jnp.where(resp, noy, oy)
        oz = jnp.where(resp, noz, oz)
        dx = jnp.where(resp, ndx, dx)
        dy = jnp.where(resp, ndy, dy)
        dz = jnp.where(resp, ndz, dz)
        ar = jnp.where(resp, one, ar)
        ag = jnp.where(resp, one, ag)
        ab = jnp.where(resp, one, ab)
        b = jnp.where(resp, 0, b)
        alive = cont | resp
        # jnp.any has no lowering on this route (reduce_or).
        any_alive = jnp.max(jnp.where(alive, 1, 0)) > 0
        return (it + 1, any_alive, ox, oy, oz, dx, dy, dz, ar, ag, ab, alive,
                s_idx, b, rr, rg, rb, cnt)

    s_idx = jnp.zeros(lane.shape, jnp.int32) + s_lo
    alive = valid & (s_lo < s_hi)
    init = ((jnp.int32(0), jnp.max(jnp.where(alive, 1, 0)) > 0)
            + tuple(make_ray(s_idx)) + (one, one, one, alive, s_idx,
                                        jnp.zeros(lane.shape, jnp.int32),
                                        zero, zero, zero,
                                        jnp.zeros(lane.shape, jnp.int32)))
    # A counted loop whose steps turn into no-ops once every lane is done:
    # the payload gather inside a while loop crashes the Triton compiler.
    fin = jax.lax.fori_loop(
        0, spp * (max_bounces + 1),
        lambda _, c: jax.lax.cond(c[1], step, lambda c: c, c), init)
    rr_ref[...] = fin[14]
    rg_ref[...] = fin[15]
    rb_ref[...] = fin[16]
    cnt_ref[...] = fin[17]
    if iters_ref:
        iters_ref[0][...] = jnp.zeros(lane.shape, jnp.int32) + fin[0]


def tile_shape(block: int) -> Tuple[int, int]:
    """(tw, th) of a block-pixel tile: powers of two, tw >= th, tw/th <= 2."""
    assert block >= 1 and block & (block - 1) == 0, block
    th = 1 << ((block.bit_length() - 1) // 2)
    return block // th, th


def tile_grid(cfg: RenderConfig, block: int) -> Tuple[int, int, int, int]:
    """(gy, gx, th, tw): the pixel-tile grid covering the image (edge tiles
    overhang; their outside lanes are padding)."""
    tw, th = tile_shape(block)
    return -(-cfg.height // th), -(-cfg.width // tw), th, tw


def untile(a: jax.Array, cfg: RenderConfig, block: int) -> jax.Array:
    """Tile-order per-pixel values (first gy*gx*block entries) -> (H, W)."""
    gy, gx, th, tw = tile_grid(cfg, block)
    a = a[:gy * gx * block].reshape(gy, gx, th, tw).transpose(0, 2, 1, 3)
    return a.reshape(gy * th, gx * tw)[:cfg.height, :cfg.width]


@functools.partial(jax.jit, static_argnames=(
    "cfg", "num_tiles", "block", "num_warps", "unroll", "interpret",
    "debug_iters"))
def trace_respawn(spheres: PreparedSpheres, camera: Camera, span: jax.Array,
                  cfg: RenderConfig, num_tiles: int, block: int,
                  num_warps: int, unroll: int, interpret: bool = False,
                  debug_iters: bool = False):
    """Run the respawn kernel over `num_tiles` pixel tiles.

    span: int32[4] = [first tile, first sample, end sample, 0] — a sharded
    caller passes its own tile range and sample slice (ray ids stay global,
    so any split draws the same rays). Returns ((rr, rg, rb) f32[num_tiles *
    block] per-pixel SAMPLE SUMS in tile order, the uint32 ray count), plus
    int32[num_tiles] loop steps per tile with debug_iters."""
    assert not cfg.soft_silhouette, "the respawn kernel renders hard images"
    gy, gx, th, tw = tile_grid(cfg, block)
    kernel = functools.partial(
        _respawn_kernel, count=spheres.count, unroll=unroll, spp=cfg.spp,
        width=cfg.width, height=cfg.height, tw=tw, th=th, gx=gx,
        max_bounces=cfg.max_bounces, t_min=cfg.t_min, seed=cfg.seed)
    table = pack_spheres(spheres, rows=-(-spheres.count // unroll) * unroll)
    cam = pack_camera(camera)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    n_out = 5 if debug_iters else 4
    dtypes = (jnp.float32,) * 3 + (jnp.int32,) * (n_out - 3)
    outs = pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        in_specs=[whole(span), whole(table), whole(cam)],
        out_specs=[lanes] * n_out,
        out_shape=[jax.ShapeDtypeStruct((num_tiles * block,), d)
                   for d in dtypes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="respawn_path_tracer",
    )(span, table, cam)
    res = (tuple(outs[:3]), jnp.sum(outs[3].astype(jnp.uint32)))
    if debug_iters:
        return res + (outs[4][::block],)
    return res
