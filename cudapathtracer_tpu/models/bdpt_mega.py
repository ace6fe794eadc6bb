"""Persistent mega-wavefront BDPT — the "bdpt" flavor of the
vcm_mega lane machine.

Same estimator as models/bdpt.py (the reference BDPT,
deviceCode.cu:622-1956): light pass + t=1 light-trace splat + eye pass
with s=0 implicit hits, s=1 NEE and s>=2 vertex connections under the
recursive d_vcm/d_vc MIS — but the eye pass runs as the persistent
phase machine of models/vcm_mega.py (flavor="bdpt": no eta_vcm terms,
linear NEE bsdfRatio, the t==2 camera-trace-pdf implicit-hit case,
firefly clamp only on deep implicit hits, no photon merge), so there are
no per-bounce or per-connection lockstep traversal tails.

The light pass and splat are the classic scan implementations
(models/paths.py, models/bdpt.py) per pixel chunk, light path i paired
with chunk pixel i like the reference pairs them by thread index.
models/bdpt.py remains the oracle implementation and the tile-sharded
path.
"""

from __future__ import annotations

from functools import partial

import os

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops import traverse8 as _t8

from cudapathtracer_tpu.models import paths
from cudapathtracer_tpu.models.bdpt import BDPTConfig, light_trace_splat
from cudapathtracer_tpu.models.vcm import VCMConfig
from cudapathtracer_tpu.models.vcm_mega import (_machine_init,
                                                _mk_eye_machine,
                                                _pack_conn_table)
from cudapathtracer_tpu.utils import packing, rng

STEPS_PER_ITER = 0   # 0 = inherit vcm_mega's env-tunable defaults
MINI_SPLITS = 0


def _as_machine_cfg(cfg: BDPTConfig) -> VCMConfig:
    """Map BDPTConfig onto the machine's config surface (merge off)."""
    return VCMConfig(
        eye_depth=cfg.eye_depth, light_depth=cfg.light_depth,
        light_trace=cfg.light_trace, nee=cfg.nee, naive=cfg.naive,
        connection=cfg.connection, do_mis=cfg.do_mis,
        do_merge=False, do_sppm=False, paint_weight=cfg.paint_weight,
        sample_environment=cfg.sample_environment)


@partial(jax.jit, static_argnames=("cfg", "width", "chunk_pixels",
                                   "steps_per_iter", "mini_splits",
                                   "debug_counters", "grid_w"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: BDPTConfig, width: int = 0, chunk_pixels: int = 0,
                  steps_per_iter: int = 0, mini_splits: int = 0,
                  debug_counters: bool = False, grid_w: int = 0):
    """One progressive BDPT sample -> (radiance [P,3], rays).

    grid_w: raveled row-major grid fast path — see vcm_mega."""
    from cudapathtracer_tpu.models import vcm_mega as vm

    steps_per_iter = steps_per_iter or vm.STEPS_PER_ITER
    mini_splits = mini_splits or vm.MINI_SPLITS
    mcfg = _as_machine_cfg(cfg)

    p_total = px.shape[0]
    # conn-table memory bounds the chunk like vcm_mega
    c_pix0 = min(chunk_pixels or max(p_total // max(
        1, -(-p_total // (1 << 20))), 1), p_total)
    w = min(width or vm.MEGA_WIDTH, c_pix0)
    gens = -(-c_pix0 // w)
    c_pix = gens * w
    n_chunks = -(-p_total // c_pix)
    from cudapathtracer_tpu.models.unidirectional_mega import RETIRE
    _scatter_ret = RETIRE == "scatter"
    k_slots = 1 if _scatter_ret else int(gens * vm.KSLOTS_FACTOR) + 8

    skey = rng.sample_key(base_key, sample_idx)
    key_l = jax.random.fold_in(skey, 1)
    key_e = jax.random.fold_in(skey, 2)
    cam_key = jax.random.fold_in(key_e, 2 ** 20)

    pxi = px.astype(jnp.int32)
    pyi = py.astype(jnp.int32)
    pad = n_chunks * c_pix - p_total
    if pad:
        pxi = jnp.concatenate([pxi, jnp.broadcast_to(pxi[-1:], (pad,))])
        pyi = jnp.concatenate([pyi, jnp.broadcast_to(pyi[-1:], (pad,))])

    fb0 = jnp.zeros((n_chunks * c_pix, 3), jnp.float32)

    def chunk_body(carry, ci):
        fb_full, rays_tot, its, fires = carry
        if grid_w:
            # pad slots clamp to the last pixel — see vcm_mega.chunk_body
            gidx = jnp.minimum(
                ci * c_pix + jnp.arange(c_pix, dtype=jnp.int32),
                p_total - 1)
            pxc, pyc = gidx % grid_w, gidx // grid_w
        else:
            pxc = jax.lax.dynamic_slice_in_dim(pxi, ci * c_pix, c_pix)
            pyc = jax.lax.dynamic_slice_in_dim(pyi, ci * c_pix, c_pix)
        pid_g = rng.pixel_ids(pxc, pyc)
        cnt = jnp.minimum(p_total - ci * c_pix, c_pix)
        lane_ok = jnp.arange(c_pix, dtype=jnp.int32) < cnt

        # ---- light pass (vertices 0..light_depth-1) ----
        # classic scan walk by default — faster than the persistent machine on
        # the previous accelerator at these shapes (see vcm_mega.chunk_body);
        # TPT_MEGA_LIGHT=1 selects the machine (vertex 0 then comes from the
        # endpoint math alone, no traversal)
        if os.environ.get("TPT_MEGA_LIGHT"):
            from cudapathtracer_tpu.models import light_mega
            _start, lv0 = paths.start_light_walk(scene, key_l, c_pix,
                                                 ids=pid_g)
            lbufs, lrays = light_mega.light_walk_mega(
                scene, key_l, c_pix, cfg.light_depth, 1,
                eta_vcm=None,
                pxc=None if grid_w else pxc, pyc=None if grid_w else pyc,
                width=w, steps_per_iter=steps_per_iter,
                mini_splits=mini_splits, grid_w=grid_w,
                gbase=ci * c_pix, gmax=p_total - 1)
        else:
            lbufs, lv0, lrays = paths.generate_light_path(
                scene, key_l, c_pix, cfg.light_depth, ids=pid_g)
        lbufs = lbufs._replace(valid=lbufs.valid & lane_ok[None, :])
        lpath_len = jnp.sum(lbufs.valid.astype(jnp.int32), axis=0)

        fb = jnp.zeros_like(fb_full)
        rays_s = jnp.int32(0)
        if cfg.light_trace:
            fb, rays_s = light_trace_splat(scene, camera, lbufs, lv0, cfg,
                                           fb, active=lane_ok)
        fb_full = fb_full + fb

        conn_table = _pack_conn_table(lbufs)

        cond, make_body = _mk_eye_machine(
            scene, camera, mcfg, key_e, cam_key, w, gens, k_slots, cnt,
            eta_vcm=0.0, mr=0.0, merge_norm=0.0, grid=None,
            conn_table=conn_table, lpath_len=lpath_len,
            steps_per_iter=steps_per_iter, mini_splits=mini_splits,
            flavor="bdpt", grid_w=grid_w)

        init = _machine_init(camera, cam_key, w, k_slots, cnt, pxc, pyc,
                             gbase=ci * c_pix, grid_w=grid_w,
                             c_img=c_pix if _scatter_ret else 1,
                             stack_dt=_t8.stack_dtype(scene))
        out = jax.lax.while_loop(
            cond, make_body(pxc.astype(jnp.float32),
                            pyc.astype(jnp.float32), ci * c_pix), init)
        rays_tot = rays_tot + lrays + rays_s + out.rays
        if _scatter_ret:  # paths landed in the carried image directly
            chunk_img = out.img
        else:
            # resolve retire slots to pixels: ONE scatter per chunk
            rows = packing.unpack_rgb9e5(out.acc).reshape(-1, 3)
            pids = out.ret_pid.reshape(-1)
            chunk_img = jnp.zeros((c_pix, 3), jnp.float32).at[
                jnp.where(pids >= 0, pids, c_pix)].add(rows, mode="drop")
        return ((fb_full, rays_tot, its + out.it, fires + out.fires),
                chunk_img)

    carry0 = (fb0, jnp.int32(0), jnp.int32(0), jnp.int32(0))
    (fb_full, rays, its, fires), accs = jax.lax.scan(
        chunk_body, carry0, jnp.arange(n_chunks, dtype=jnp.int32))
    li = accs.reshape(-1, 3)[:p_total] + fb_full[:p_total]
    if debug_counters:
        return li, rays, its, fires
    return li, rays
