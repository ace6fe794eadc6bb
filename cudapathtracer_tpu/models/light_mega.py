"""Persistent mega-wavefront LIGHT walk — LANE-MAJOR (opt-in).

Alternative to the classic per-bounce lockstep light pass
(models/paths.py random_walk over [C] lanes x light_depth scan steps)
for the mega VCM/BDPT engines, selected with TPT_MEGA_LIGHT=1. Built to
kill the scan's full-width dead-lane shading; on the previous accelerator
it lost to the classic scan at the reference-shipped 800^2 eye16/light10
shape, so the classic scan stays the default — the machine's
per-transition vertex scatter and drain windows outweighed the lockstep
waste it removes at these path counts. Kept tested: it may win
on workloads with strongly varying light-path lengths or much deeper
walks. Reference counterpart: generateLightPath,
deviceCode.cu:1081-1287.

Design: the same persistent lane-machine shape as the eye engines
(ops/traverse8.make_fused_step in a while loop + transitions), but
simpler — every lane is always in the CLOSEST phase:

  * lane l walks light path p (dynamic queue for load balance); at a
    transition, drained lanes shade (one packed-row gather), advance the
    d_vcm/d_vc/d_vm recursion, EMIT their vertex, sample the BSDF and
    relaunch — or retire and refill with a fresh endpoint;
  * vertex emission writes ONE packed u32 row per lane into the
    depth-major [rows*C, 15] table with a single scatter per transition
    (a scatter into a while-loop carry aliases in place — the
    per-iteration cost scales with the W update rows, not the table);
  * endpoints are recomputed arithmetically at refill (the exact
    start_light_walk formulas) instead of gathering [C]-sized start
    tables — per-transition random gathers on launch-width tables were a
    dominant transition cost on the previous accelerator;
  * per-lane draw keys: the classic walk keys draws by
    (bounce_key(key, depth), draw, pixel id); lanes here sit at
    DIFFERENT depths, so the scalar fold chain is precomputed per
    (bounce, draw) into a tiny table (rng.draw_key_table) and each lane
    selects its pair — the resulting uniforms are bit-identical to the
    classic walk's.

The emitted vertices equal the classic walk's up to lane-major float
association (same draws, same estimator; tests/test_light_mega.py pins
per-vertex agreement and exact schedule invariance). Consumers receive
the same depth-major PathBuffers views, so the splat, photon grid,
connection table and lpath_len plumbing are unchanged.
"""

from __future__ import annotations

import os as _os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.models import mis
from cudapathtracer_tpu.models.paths import PathBuffers
from cudapathtracer_tpu.ops import lanemajor as lm
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.ops.intersect import BIG_T
from cudapathtracer_tpu.ops import traverse8 as t8
from cudapathtracer_tpu.ops.traverse8 import (make_fused_step, trav_idle,
                                              trav_start)
from cudapathtracer_tpu.utils import packing, rng
from cudapathtracer_tpu.utils.math import EPSILON, PI, RAY_EPSILON

STEPS_PER_ITER = int(_os.environ.get("TPT_MEGA_STEPS_PER_ITER", "6"))
MINI_SPLITS = int(_os.environ.get("TPT_MEGA_MINI_SPLITS", "6"))
MEGA_WIDTH = int(_os.environ.get("TPT_MEGA_WIDTH", "9720"))

# packed vertex row (u32 columns) scattered into the depth-major table:
#   [0:3] pt (f32 bits)  [3] n oct  [4] wo oct  [5] uv (2xf16)
#   [6:8] beta (3xf16, last half unused)  [8] pdf_fwd  [9] d_vcm
#   [10] d_vc  [11] d_vm  [12] flags  [13] valid
_VROW = 14


class _LState(NamedTuple):
    rays: jax.Array      # scalar i32
    it: jax.Array        # scalar i32
    next_p: jax.Array    # scalar i32 path queue head
    table: jax.Array     # [rows*C, _VROW] u32 vertex store (scatter target)
    ts: object           # TravState [W]
    o: jax.Array         # [3,W]
    d: jax.Array
    inv_d: jax.Array
    pid: jax.Array       # [W] i32 path id; -1 idle
    ids: jax.Array       # [W] u32 draw id (pixel id of the paired pixel)
    depth: jax.Array     # [W] i32 bounce being traced (1-based)
    thr: jax.Array       # [3,W]
    prev_pdf_sa: jax.Array
    prev_cos: jax.Array
    prev_pt: jax.Array   # [3,W]
    first_vc: jax.Array  # [W] endpoint 1/pdf0 (first_vc_scale)
    ms_dvcm: jax.Array
    ms_dvc: jax.Array
    ms_dvm: jax.Array
    ms_prev_rev: jax.Array
    ms_prev_delta: jax.Array


def _f32b(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


@partial(jax.jit, static_argnames=("c_pix", "max_depth", "transport_mode",
                                   "width", "steps_per_iter",
                                   "mini_splits", "grid_w"))
def light_walk_mega(scene, key, c_pix: int, max_depth: int,
                    transport_mode: int, eta_vcm=None,
                    pxc=None, pyc=None, *,
                    width: int = 0, steps_per_iter: int = 0,
                    mini_splits: int = 0, grid_w: int = 0, gbase=0,
                    gmax=None):
    """Walk c_pix light paths -> (PathBuffers [max_depth-1, c_pix], rays).

    Drop-in for paths.start_light_walk + paths.random_walk on light
    walks: same draw streams (keyed by the paired pixel id and bounce),
    same estimator, depth-major output views. eta_vcm enables the VCM
    d_vm chain (the per-lane first_vm seed is recomputed as
    first_vc / eta_vcm exactly like the classic caller); None = pure
    BDPT weights.

    grid_w + gbase: paths pair with pixels gbase+p of a row-major grid
    (ids arithmetic); otherwise pxc/pyc [C] tables provide the pairing.
    """
    steps_per_iter = steps_per_iter or STEPS_PER_ITER
    mini_splits = mini_splits or MINI_SPLITS
    w = min(width or MEGA_WIDTH, c_pix)
    rows = max_depth - 1
    fstep = make_fused_step(scene).lane_major
    lobes = getattr(scene, "mat_type_mask", lm.ALL_LOBES)
    num_lights = max(scene.num_lights, 1)
    use_vm = eta_vcm is not None

    # per-(bounce, draw) key pairs for the walk draws (bsdf_sample uses
    # draw ids 0..3 under bounce_key(key, depth)) — [rows+1, 4, 2] u32
    ktab = rng.draw_key_table(key, range(max_depth), range(4))
    # endpoint draws 100..104 keyed on `key` directly (no bounce fold)
    ketab = rng.draw_key_table(key, None, range(100, 105))[0]

    def ids_of(p):
        if grid_w:
            gp = gbase + p
            if gmax is not None:  # pad paths clamp to the last pixel,
                gp = jnp.minimum(gp, gmax)  # like the classic pairing
            return rng.pixel_ids(gp % grid_w, gp // grid_w)
        pc = jnp.minimum(p, c_pix - 1)
        return rng.pixel_ids(pxc[pc].astype(jnp.int32),
                             pyc[pc].astype(jnp.int32))

    def endpoint(ids):
        """start_light_walk per lane, lane-major, bit-identical draws."""
        ids = ids.astype(jnp.uint32)
        ul = rng.uniform_keyed(ketab[0, 0], ketab[0, 1], ids)
        li = jnp.minimum((ul * num_lights).astype(jnp.int32),
                         num_lights - 1)
        a = scene.light_p0[li].T
        b = scene.light_p1[li].T
        c = scene.light_p2[li].T
        tri = scene.light_tri[li]
        n3 = scene.tri_n[tri]                        # [W,3,3]
        u = jnp.sqrt(rng.uniform_keyed(ketab[1, 0], ketab[1, 1], ids))
        v = rng.uniform_keyed(ketab[2, 0], ketab[2, 1], ids)
        w0, w1, w2 = (1.0 - u), u * (1.0 - v), u * v
        pt = w0[None, :] * a + w1[None, :] * b + w2[None, :] * c
        nrm = lm.normalizeT(w0[None, :] * n3[:, 0].T
                            + w1[None, :] * n3[:, 1].T
                            + w2[None, :] * n3[:, 2].T)
        area = scene.light_area[li]
        pdf0 = (1.0 / num_lights) / jnp.maximum(area, 1e-20)
        le = scene.light_emission[li].T
        beta0 = le * (PI / pdf0)[None, :]
        u1 = rng.uniform_keyed(ketab[3, 0], ketab[3, 1], ids)
        u2 = rng.uniform_keyed(ketab[4, 0], ketab[4, 1], ids)
        out_local = lm.cosine_sampleT(u1, u2)
        out_world = lm.to_worldT(out_local, nrm)
        cos_emit = jnp.abs(out_local[2])
        return dict(o=pt + nrm * RAY_EPSILON, d=out_world, thr=beta0,
                    prev_pdf_sa=cos_emit / PI, prev_cos=cos_emit,
                    prev_pt=pt,
                    first_vc=1.0 / jnp.maximum(pdf0, 1e-20))

    def transition(s: _LState) -> _LState:
        ts = s.ts
        drained = (ts.flag < 0) & (s.pid >= 0)
        hit = traverse.Hit(t=ts.t_cut,
                           tri=jnp.where(drained, ts.tri, -1),
                           u=ts.u, v=ts.v)
        info, mat = lm.shade_dataT(scene, s.o, s.d, hit)
        reached = drained & hit.valid
        normal = info["normal"]
        wo_local = lm.to_localT(s.d, normal)
        albedo = lm.resolve_albedoT(scene, mat, info["uv"])
        trans = lm.resolve_transmissionT(scene, mat, info["uv"])
        cur_delta = mat.is_specular

        d2p = jnp.maximum(lm.length_sqT(info["point"] - s.prev_pt),
                          RAY_EPSILON)
        pdf_fwd_area = s.prev_pdf_sa * jnp.abs(wo_local[2]) / d2p
        g = s.prev_cos / d2p

        # per-lane depth-keyed draws (bit-identical to the classic walk)
        dix = jnp.clip(s.depth, 1, max_depth - 1)
        kl = ktab[dix]                               # [W,4,2]
        draws = tuple(
            rng.uniform_keyed(kl[:, j, 0], kl[:, j, 1], s.ids)
            for j in range(4))
        ones = jnp.ones_like(ts.t_cut)
        wi_local, f_val, pdf_sa = lm.bsdf_sampleT(
            None, 0, mat, albedo, -wo_local, info["backface"], ones,
            transport_mode, transmission=trans, lobe_mask=lobes,
            draws=draws)
        pdf_rev_sa = lm.bsdf_pdfT(mat, wi_local, -wo_local, ones,
                                  transmission=trans, lobe_mask=lobes)

        first = s.depth == 1
        first_d_vcm = 1.0 / jnp.maximum(pdf_fwd_area, 1e-20)
        gof = g / jnp.maximum(pdf_fwd_area, 1e-20)
        first_d_vc = s.first_vc * gof
        first_d_vm = (s.first_vc / jnp.maximum(eta_vcm, 1e-30) * gof
                      if use_vm else None)
        mstate = mis.MisState(s.ms_dvcm, s.ms_dvc, s.ms_dvm,
                              s.ms_prev_rev, s.ms_prev_delta)
        d_vcm, d_vc, d_vm, mstate2 = mis.advance(
            mstate, first, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
            first_d_vcm, first_d_vc, first_d_vm,
            eta_vcm if use_vm else None)

        valid = reached & (pdf_sa >= EPSILON)

        # ---- vertex emission: ONE scatter of <=W packed rows ----------
        ptT = info["point"]
        woT = lm.normalizeT(-s.d)
        flags = packing.pack_flags(cur_delta, info["backface"],
                                   info["light_ind"], info["mat_id"])
        uv_u32 = jax.lax.bitcast_convert_type(
            info["uv"].T.astype(jnp.float16), jnp.uint32)
        beta_h = packing.to_half3(s.thr.T)            # [W,3] f16
        beta4 = jnp.concatenate(
            [beta_h, jnp.zeros((beta_h.shape[0], 1), jnp.float16)], axis=1)
        beta_u32 = jax.lax.bitcast_convert_type(
            beta4.reshape(-1, 2, 2), jnp.uint32)      # [W,2]
        vrow = jnp.stack([
            _f32b(ptT[0]), _f32b(ptT[1]), _f32b(ptT[2]),
            packing.pack_oct(normal.T).astype(jnp.uint32),
            packing.pack_oct(woT.T).astype(jnp.uint32),
            uv_u32,
            beta_u32[:, 0], beta_u32[:, 1],
            _f32b(pdf_fwd_area), _f32b(d_vcm), _f32b(d_vc),
            _f32b(d_vm if use_vm else jnp.zeros_like(d_vcm)),
            flags.astype(jnp.uint32),
            jnp.ones_like(flags, jnp.uint32),
        ], axis=1)                                    # [W, _VROW]
        tidx = jnp.where(valid, (s.depth - 1) * c_pix + s.pid,
                         rows * c_pix)                # OOB -> dropped
        table = s.table.at[tidx].set(vrow, mode="drop")

        # ---- continue / retire / refill -------------------------------
        cont = valid & (s.depth + 1 < max_depth)
        dead = drained & ~cont
        pid = jnp.where(dead, -1, s.pid)
        want = (pid < 0) & (s.next_p < c_pix)
        rank = jnp.cumsum(want.astype(jnp.int32))
        new_p = s.next_p + rank - 1
        got = want & (new_p < c_pix)
        next_p = s.next_p + jnp.sum(got.astype(jnp.int32))
        pid = jnp.where(got, new_p, pid)
        ids = jnp.where(got, ids_of(jnp.where(got, new_p, 0)),
                        s.ids).astype(jnp.uint32)
        ep = endpoint(ids)

        new_thr = s.thr * f_val * (jnp.abs(wi_local[2])
                                   / jnp.maximum(pdf_sa, 1e-20))[None, :]
        wi_world = lm.normalizeT(lm.to_worldT(wi_local, normal))
        transmitting = lm.dotT(wi_world, normal) < 0.0
        side = jnp.where(transmitting, -1.0, 1.0)
        new_o = info["point"] + normal * (side * RAY_EPSILON)[None, :]

        c3, g3 = cont[None, :], got[None, :]
        o2 = jnp.where(g3, ep["o"], jnp.where(c3, new_o, s.o))
        d2 = jnp.where(g3, ep["d"], jnp.where(c3, wi_world, s.d))
        thr = jnp.where(g3, ep["thr"], jnp.where(c3, new_thr, s.thr))
        prev_pdf_sa = jnp.where(got, ep["prev_pdf_sa"],
                                jnp.where(cont, pdf_sa, s.prev_pdf_sa))
        prev_cos = jnp.where(got, ep["prev_cos"],
                             jnp.where(cont, jnp.abs(wi_local[2]),
                                       s.prev_cos))
        prev_pt = jnp.where(g3, ep["prev_pt"],
                            jnp.where(c3, info["point"], s.prev_pt))
        first_vc = jnp.where(got, ep["first_vc"], s.first_vc)
        depth = jnp.where(got, 1, jnp.where(cont, s.depth + 1, s.depth))
        upd = cont  # classic: mstate advances only on valid lanes
        mstate = jax.tree.map(
            lambda a2, a1: jnp.where(upd, a2, a1), mstate2, mstate)
        mstate = jax.tree.map(
            lambda a, z: jnp.where(got, z, a), mstate,
            mis.MisState.zeros(w))

        start_any = cont | got
        ts = trav_start(ts, start_any,
                        jnp.full((w,), BIG_T, jnp.float32))
        ts = ts._replace(flag=jnp.where(drained & ~start_any, -1,
                                        ts.flag))
        inv_d = jnp.where(start_any[None, :], lm.safe_inv_dirT(d2),
                          s.inv_d)
        rays = s.rays + jnp.sum(start_any.astype(jnp.int32))
        return _LState(rays, s.it, next_p, table, ts, o2, d2, inv_d, pid,
                       ids, depth, thr, prev_pdf_sa, prev_cos, prev_pt,
                       first_vc, mstate.d_vcm, mstate.d_vc, mstate.d_vm,
                       mstate.pdf_rev_prev, mstate.prev_was_delta)

    def cond(s: _LState):
        return (jnp.any(s.pid >= 0) | (s.next_p < c_pix)) \
            & (s.it < 1 << 26)

    def body(s: _LState):
        # No mini-transitions: every lane is a closest-phase lane, so the
        # only useful transition is the FULL one (shade + emit + next
        # launch). Firing it at mini cadence was slower on the shipped
        # 800^2 workload — shade-row gathers and the vertex scatter at
        # every node-step swamped the walk.
        skip = jnp.full((w,), -1, jnp.int32)
        shadow = jnp.zeros((w,), bool)
        ts = s.ts
        for _ in range(max(1, steps_per_iter)):
            ts = fstep(ts, s.o, s.d, s.inv_d, skip, shadow)
        s = s._replace(ts=ts, it=s.it + 1)
        return transition(s)

    # ---- init: lane l starts path l ------------------------------------
    lane = jnp.arange(w, dtype=jnp.int32)
    live = lane < c_pix
    pid0 = jnp.where(live, lane, -1)
    ids0 = ids_of(jnp.maximum(pid0, 0)).astype(jnp.uint32)
    ep0 = endpoint(ids0)
    init = _LState(
        rays=jnp.sum(live.astype(jnp.int32)), it=jnp.int32(0),
        next_p=jnp.minimum(jnp.int32(w), jnp.int32(c_pix)),
        table=jnp.zeros((rows * c_pix, _VROW), jnp.uint32),
        ts=trav_start(trav_idle(w, t8.stack_dtype(scene)), live,
                      jnp.full((w,), BIG_T, jnp.float32)),
        o=ep0["o"], d=ep0["d"], inv_d=lm.safe_inv_dirT(ep0["d"]),
        pid=pid0, ids=ids0,
        depth=jnp.ones((w,), jnp.int32),
        thr=ep0["thr"],
        prev_pdf_sa=ep0["prev_pdf_sa"], prev_cos=ep0["prev_cos"],
        prev_pt=ep0["prev_pt"], first_vc=ep0["first_vc"],
        ms_dvcm=jnp.zeros((w,), jnp.float32),
        ms_dvc=jnp.zeros((w,), jnp.float32),
        ms_dvm=jnp.zeros((w,), jnp.float32),
        ms_prev_rev=jnp.zeros((w,), jnp.float32),
        ms_prev_delta=jnp.zeros((w,), bool))
    out = jax.lax.while_loop(cond, body, init)

    # ---- decode the table into depth-major PathBuffers views -----------
    tb = out.table
    f32c = lambda j: jax.lax.bitcast_convert_type(tb[:, j], jnp.float32)
    pt = jnp.stack([f32c(0), f32c(1), f32c(2)],
                   axis=-1).reshape(rows, c_pix, 3)
    uv_h = jax.lax.bitcast_convert_type(
        tb[:, 5], jnp.float16).reshape(rows, c_pix, 2)
    beta_h = jax.lax.bitcast_convert_type(
        tb[:, 6:8], jnp.float16).reshape(rows, c_pix, 4)[..., :3]
    bufs = PathBuffers(
        pt=pt,
        n_oct=tb[:, 3].reshape(rows, c_pix),
        wo_oct=tb[:, 4].reshape(rows, c_pix),
        uv_h=uv_h,
        beta_h=beta_h,
        pdf_fwd=f32c(8).reshape(rows, c_pix),
        d_vcm=f32c(9).reshape(rows, c_pix),
        d_vc=f32c(10).reshape(rows, c_pix),
        d_vm=f32c(11).reshape(rows, c_pix),
        flags=tb[:, 12].reshape(rows, c_pix),
        valid=(tb[:, 13] > 0).reshape(rows, c_pix))
    return bufs, out.rays
