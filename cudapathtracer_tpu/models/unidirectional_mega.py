"""Persistent mega-wavefront unidirectional path tracer — LANE-MAJOR.

Same estimator as models/unidirectional.py (Li_unidirectional,
deviceCode.cu:285-542: NEE + power-2 MIS, nested-dielectric priority
stack, Beer-Lambert absorption, Russian roulette), reorganized around the
cost model of the accelerator it was first tuned on:

  * per-bounce and per-traversal lockstep tails burn most of the machine
    in the classic design (a closest call runs as many full-width steps
    as its deepest lane needs) — persistence removes the tails;
  * the traversal step cost was elementwise work, not the row gather, so
    per-lane state is LANE-MAJOR;
  * the TRANSITION (shade/NEE/BSDF/refill) was the second-largest cost
    in row-major [W,3]/[W,16] layout — every per-lane vector now rides
    the minor axis as [3,W] / [S,W] via ops/lanemajor.py, the same
    transposition the traversal step uses.

Design: ONE fixed-width lane machine. Every loop iteration advances a
mixed closest/shadow BVH8 node-step for all lanes
(ops/traverse8.make_fused_step). When enough lanes have drained their
traversal, a TRANSITION block fires: it shades completed closest hits
(one packed-row gather), resolves NEE shadows, advances paths, retires
finished paths' radiance, and REFILLS dead lanes with fresh pixels — so
the wavefront stays full of useful traversal work from the first pixel
to the global drain. There are no per-bounce barriers and no per-call
tails. Pixel assignment is STATIC (lane l owns pixels g*W + l), so
retiring is a handful of masked row-writes into a [G,3,W] buffer instead
of a [W]-indexed scatter (scattered rows serialized on the previous
accelerator; not yet measured on the GPU).

Sampling is keyed by (pixel index, per-lane bounce counter) via the
layout-independent id streams (utils/rng.py), so the image is independent
of lane scheduling, wavefront width, and transition timing; it is a
different (equally valid) noise realization than the classic integrator.
"""

from __future__ import annotations

import os as _os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops import lanemajor as lm
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.ops.intersect import BIG_T
from cudapathtracer_tpu.ops import traverse8 as _t8
from cudapathtracer_tpu.ops.traverse8 import (TravState, make_fused_step,
                                              trav_idle, trav_start)
from cudapathtracer_tpu.utils import packing, rng
from cudapathtracer_tpu.utils.math import EPSILON, RAY_EPSILON

HARD_DEPTH_CAP = 100   # deviceCode.cu:318
LIT_CAP = HARD_DEPTH_CAP + 32
# draw-id stride per path: ids2 = pid * _ID_STRIDE + lit must stay unique
# and fit int32 -> frames up to ~11M pixels
_ID_STRIDE = 191

_D_NEE = 0
_D_BSDF = 4
_D_RR = 8

# Default schedule (steps_per_iter traversal node-steps per while
# iteration, grouped into mini_splits transition checks). XLA:CPU compile
# time is super-linear in the unrolled body size, so the test suite dials
# these down via the environment exactly like ops/traverse.py — the image
# is invariant to the schedule (RNG is keyed by global pixel id + per-lane
# bounce counter). spi=6/mini=3 with MEGA_WIDTH=12960 won a 1080p sweep of
# (spi, mini, width) on the previous accelerator: fewer steps per
# iteration refill drained lanes sooner, more amortize the transition.
# Not yet re-swept on the GPU (ROADMAP Queue 1 item 5).
STEPS_PER_ITER = int(_os.environ.get("TPT_MEGA_STEPS_PER_ITER", "6"))
MINI_SPLITS = int(_os.environ.get("TPT_MEGA_MINI_SPLITS", "3"))
# Default lane count of the persistent machine: full-frame lanes ride the
# pixel queue with long idle drain tails, too few lanes leave the device
# underfed; the value is the previous accelerator's 1080p optimum (see
# STEPS_PER_ITER). Width never changes the image (RNG keyed by global
# pixel id).
MEGA_WIDTH = int(_os.environ.get("TPT_MEGA_WIDTH", "12960"))
# Retire-slot capacity factor: k_slots = factor*gens + 8. Any factor >= 1
# is exact (all lanes slot-full while queue pixels remain is impossible:
# W*(gens+8) > gens*W = queue length, so some lane always has a free slot
# and the queue drains); the factor only trades load-balance tail time
# against the [K,3,W] retirement sweep per transition.
KSLOTS_FACTOR = float(_os.environ.get("TPT_MEGA_KSLOTS_FACTOR", "1.0"))
# Early-NEE overlap (see mini()): launch a drained closest lane's NEE
# shadow at a mini instead of idling until the full transition. OFF by
# default: on the previous accelerator the mini-side draw + light sample
# + launch block cost more than the drain-wait it removes at the spi=6
# cadence. The machinery stays (bit-identical images,
# tests/test_mega.py::test_mega_early_nee_overlap_invariant) for
# schedules/scenes where shadow latency dominates; the extra state rides
# the carry measurably free when off.
EARLY_NEE = _os.environ.get("TPT_MEGA_EARLY_NEE", "0") not in ("0", "")
# Retirement scheme. "slots" (default): the per-lane [K,W] RGB9E5 slot
# lists + end-of-loop resolve scatter. The slot sweep is a visible share
# of each iteration, which motivated "scatter": finished paths flush
# (pid, radiance) straight into a chunk-image carry via one compacted
# scatter-add of <= RETIRE_CAP rows per transition, overflow lanes
# deferring one transition (exact — li/pid just wait). Rejected as the
# default on the previous accelerator, where the top_k compaction (a full
# sort) and serialized scatter rows cost more than the sweep. The path
# stays selectable (TPT_MEGA_RETIRE=scatter) and tested; the GPU's
# scatter-add may change the verdict (ROADMAP Queue 1 item 7).
RETIRE = _os.environ.get("TPT_MEGA_RETIRE", "slots")
RETIRE_CAP = int(_os.environ.get("TPT_MEGA_RETIRE_CAP", "0"))
# "window" retirement: the [K,W] one-hot sweep only ever WRITES rows in the
# narrow band of ret_count values that are actually retiring this transition,
# so sweep a [R,W] dynamic-slice window based at min(ret_count | retiring)
# instead of all K rows. Lanes whose ret_count falls beyond the window (spread
# > R generations — rare) defer exactly like the scatter mode's pend lanes and
# flush on a later transition once the window advances (the window base is the
# min over DEFERRED-OR-DEAD lanes, so progress is guaranteed).
# Image-identical: same slots, same values, only the write schedule changes.
RETIRE_WIN = int(_os.environ.get("TPT_MEGA_RETIRE_WIN", "32"))
# Slot-retirement flush cadence: with F > 1, only every F-th transition
# runs the [K,W] slot sweep; finished lanes in between park on the
# `pend` flag (pid/li held, excluded from
# shading and refill) — each lane holds at most ONE finished path, so
# the flush stays a single one-hot sweep. Costs a little refill latency
# (a dead lane idles <= F-1 windows); the F=2 A/B decides the default.
RETIRE_EVERY = int(_os.environ.get("TPT_MEGA_RETIRE_EVERY", "1"))


class _MState(NamedTuple):
    rays: jax.Array        # scalar i32
    it: jax.Array          # scalar i32 loop counter
    fires: jax.Array       # scalar i32 transition-firing counter
    busy: jax.Array        # scalar i32 busy lane-step counter (debug)
    ts: TravState          # [W] traversal registers (lane-major stack/scale)
    o: jax.Array           # [3,W] current traversal ray
    d: jax.Array
    inv_d: jax.Array
    is_shadow: jax.Array   # [W] bool traversal mode
    early: jax.Array       # [W] bool: NEE shadow launched at a mini BEFORE
    #                        the shade (early-NEE overlap); the closest-hit
    #                        record is saved in h_* until the next full
    #                        transition shades the lane and computes the
    #                        pending weight from the SAME counter-keyed
    #                        draws (bit-identical image)
    h_point: jax.Array     # [3,W] saved hit point (o + d*t, computed at
    #                        the mini with the exact shade formula)
    h_d: jax.Array         # [3,W] saved closest ray direction
    h_t: jax.Array         # [W] saved closest-hit record of early lanes
    h_tri: jax.Array       # [W] i32
    h_u: jax.Array         # [W]
    h_v: jax.Array         # [W]
    next_px: jax.Array     # scalar i32 pixel queue head
    ret_count: jax.Array   # [W] i32 paths this lane has retired
    prays: jax.Array       # [W] i32 rays launched by the CURRENT path
    #                        (subtracted when a straggler is handed to the
    #                        narrow tail stage, which replays it in full)
    pid: jax.Array         # [W] i32 pixel index into px/py; -1 = idle lane
    lit: jax.Array         # [W] i32 per-lane bounce/draw counter
    depth: jax.Array       # [W] i32 path depth (false hits do not advance)
    beta: jax.Array        # [3,W]
    li: jax.Array          # [3,W] current path radiance
    path_alive: jax.Array  # [W] bool (false while flushing a final shadow)
    prev_pdf: jax.Array
    hit_nonspec: jax.Array
    prev_point: jax.Array  # [3,W]
    eta_i: jax.Array
    eta_t: jax.Array
    ms_stack: jax.Array    # [S,W]
    ms_top: jax.Array
    pending: jax.Array     # [3,W] unshadowed weighted NEE contribution
    nxt_o: jax.Array       # [3,W] BSDF-sampled next ray (waits on shadow)
    nxt_d: jax.Array
    pend: jax.Array        # [W] bool: path finished, radiance awaiting a
    #                        flush slot (scatter retirement only; the
    #                        lane idles — excluded from shading — until
    #                        a compacted flush takes it)
    img: jax.Array         # [c_pix,3] f32 chunk image (scatter
    #                        retirement; [1,3] dummy in slots mode):
    #                        finished paths scatter-add (pid, li) rows
    #                        directly — carry-aliased in place
    ret_pid: jax.Array     # [K,W] i32 pixel of each retired slot; -1 empty
    acc: jax.Array         # [K,W] u32 per-slot retired radiance, RGB9E5
    #                        shared-exponent packed (utils/packing.py): the
    #                        lane's k-th retired path lives at [k, lane] —
    #                        retiring is a one-hot select over [K,W], NOT a
    #                        scatter; one big scatter after the loop
    #                        resolves slots to pixels. Packed because the
    #                        select sweeps the whole buffer every
    #                        transition: u32 vs 3xf32 cuts the sweep's
    #                        memory traffic 2x. RGB9E5's 9-bit
    #                        mantissa costs <0.2% on a single path's
    #                        radiance, zero-mean across paths; values clip
    #                        at 65408 (extreme-firefly cap).


@partial(jax.jit, static_argnames=("max_depth", "width", "use_mis",
                                   "sample_environment", "steps_per_iter",
                                   "mini_splits", "chunk_pixels",
                                   "debug_counters", "grid_w",
                                   "early_nee", "retire"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, width: int = 0, use_mis: bool = True,
                  sample_environment: bool = False,
                  steps_per_iter: int = 0, mini_splits: int = 0,
                  chunk_pixels: int = 0,
                  debug_counters: bool = False, grid_w: int = 0,
                  early_nee: bool | None = None,
                  retire: str | None = None):
    """One full sample over pixels (px, py) [P] -> (radiance [P,3], rays).

    width: lane count W of the persistent wavefront (0 = P, capped).

    grid_w: declare that px/py form a raveled row-major grid of this
    width (px[i] = i % grid_w, py[i] = i // grid_w — what the driver and
    bench always pass). The refill path then derives pixel coordinates
    and queue ids ARITHMETICALLY from the pixel id instead of gathering
    the [P]-sized px/py/qidx tables per transition — per-transition
    random gathers on frame-sized tables were a dominant transition cost
    on the previous accelerator.
    Bit-identical to grid_w=0 (same floats, same RNG ids).

    chunk_pixels: pixel-queue chunk size (0 = auto). The persistent while
    loop runs once per chunk with a CHUNK-LOCAL accumulator; chunk images
    are emitted as scan outputs and concatenated. The in-loop state is
    kept small: on the previous accelerator a full-image [P,3]
    accumulator in the while carry spilled out of on-chip memory every
    iteration. The image is invariant to the
    chunking because every RNG stream is keyed by GLOBAL pixel id.
    """
    steps_per_iter = steps_per_iter or STEPS_PER_ITER
    mini_splits = mini_splits or MINI_SPLITS
    p_total = px.shape[0]
    if chunk_pixels:
        c_pix0 = min(chunk_pixels, p_total)
    else:
        # ONE machine over the whole frame: each chunk pays its own global
        # drain tail (deep RR survivors bounce once per full transition), so
        # several chunks at 1080p ran slower than one. The [G,3,W] accumulator
        # keeps the carry streamable at any frame size, so chunking is now
        # only an explicit override.
        c_pix0 = p_total
    w = min(width or MEGA_WIDTH, c_pix0)
    gens = -(-c_pix0 // w)       # mean paths per lane per chunk
    c_pix = gens * w
    n_chunks = -(-p_total // c_pix)
    retire = retire or RETIRE
    scatter_ret = retire == "scatter"
    window_ret = retire == "window"
    k_slots = 1 if scatter_ret else int(gens * KSLOTS_FACTOR) + 8
    ret_win = min(RETIRE_WIN, k_slots)
    # flush capacity: steady-state retires/transition are ~W/18 at the
    # 1080p defaults; 1/4 width covers bursts with slack (overflow only
    # defers, never drops)
    ret_cap = min(w, RETIRE_CAP or max(-(-(w // 4) // 128) * 128, 256))
    skey = rng.sample_key(base_key, sample_idx)
    cam_key = jax.random.fold_in(skey, 2 ** 20)
    if grid_w:
        pxf = pyf = None
    else:
        pxf = px.astype(jnp.float32)
        pyf = py.astype(jnp.float32)
        pad = n_chunks * c_pix - p_total
        if pad:
            pxf = jnp.concatenate([pxf,
                                   jnp.broadcast_to(pxf[-1:], (pad,))])
            pyf = jnp.concatenate([pyf,
                                   jnp.broadcast_to(pyf[-1:], (pad,))])
    fstep = make_fused_step(scene).lane_major
    mats = scene.materials
    do_nee_stage = use_mis and scene.num_lights > 0
    early_nee = EARLY_NEE if early_nee is None else early_nee
    lobes = getattr(scene, "mat_type_mask", lm.ALL_LOBES)

    def ids2(pid, lit):
        return pid * _ID_STRIDE + lit

    def pix_coords(pxc, pyc, gbase, pids):
        """Chunk-local pixel ids -> float pixel coordinates: arithmetic in
        grid mode, [P]-table gathers otherwise."""
        if grid_w:
            gp = gbase + pids
            return ((gp % grid_w).astype(jnp.float32),
                    (gp // grid_w).astype(jnp.float32))
        return pxc[pids], pyc[pids]

    # The machine below is width-agnostic (every shape derives from the
    # state), so the same functions serve the full-width stage AND the
    # narrow tail stage; chunk-local pixel arrays, the queue length, the
    # queue->pixel map `qidx` and the global-id base are threaded
    # explicitly so one trace serves every chunk.
    def transition(s: _MState, pxc, pyc, gbase, cnt, qidx,
                   flush: bool = True) -> _MState:
        ts = s.ts
        # pend lanes already finished their path; they idle awaiting a
        # flush slot and must not re-shade
        drained = (ts.flag < 0) & (s.pid >= 0) & ~s.pend
        pid, lit, depth = s.pid, s.lit, s.depth
        beta, li = s.beta, s.li
        alive = s.path_alive
        prev_pdf, hit_nonspec = s.prev_pdf, s.hit_nonspec
        prev_point = s.prev_point
        eta_i, eta_t = s.eta_i, s.eta_t
        ms = lm.MediumStackT(s.ms_stack, s.ms_top)
        pending, nxt_o, nxt_d = s.pending, s.nxt_o, s.nxt_d
        rays = s.rays
        did = ids2(gbase + pid, lit)

        # ------ 1. resolve drained shadow lanes ---------------------------
        # (early-NEE lanes are excluded: their pending weight is not
        # computed yet — they resolve after the shade below)
        sh_done = drained & s.is_shadow & ~s.early
        li = li + jnp.where(sh_done[None, :], pending * ts.scale, 0.0)
        pending = jnp.where(sh_done[None, :], 0.0, pending)
        # alive shadow lanes continue with the stored BSDF ray
        cont = sh_done & alive
        dead = sh_done & ~alive

        # ------ 2. shade drained closest lanes + early-NEE lanes ----------
        # Early lanes' closest-hit record was saved at launch (h_*); their
        # NEE shadow is in flight (or already drained) on ts.
        was_early = s.early
        cl_done = (drained & ~s.is_shadow) | was_early
        hit_t = jnp.where(was_early, s.h_t, ts.t_cut)
        hit = traverse.Hit(t=hit_t,
                           tri=jnp.where(cl_done,
                                         jnp.where(was_early, s.h_tri,
                                                   ts.tri), -1),
                           u=jnp.where(was_early, s.h_u, ts.u),
                           v=jnp.where(was_early, s.h_v, ts.v))
        # early lanes' o/d registers now hold the in-flight SHADOW ray;
        # shade from the saved closest ray/point instead (bit-identical:
        # h_point was computed with the exact o + d*t formula at launch)
        sd_d = jnp.where(was_early[None, :], s.h_d, s.d)
        point_pre = jnp.where(was_early[None, :], s.h_point,
                              s.o + s.d * hit_t[None, :])
        info, mat = lm.shade_dataT(scene, s.o, sd_d, hit, point=point_pre)
        miss = cl_done & ~hit.valid
        li = li + jnp.where(miss[None, :],
                            beta * lm.sample_skyT(s.d, sample_environment),
                            0.0)
        dead = dead | miss
        hitv = cl_done & hit.valid

        mat_id = info["mat_id"]
        backface = info["backface"]
        normal = info["normal"]
        wi_local = lm.to_localT(sd_d, normal)
        albedo = lm.resolve_albedoT(scene, mat, info["uv"])
        trans = lm.resolve_transmissionT(scene, mat, info["uv"])
        is_specular = mat.is_specular

        # dominant medium + Beer (deviceCode.cu:345-369)
        dom_id, dom_pri = lm.dominant_mediumT(ms)
        absorb = lm.table_lookup3T(mats.absorption, dom_id)
        att = jnp.exp(-absorb * hit.t[None, :])
        beta = jnp.where((hitv & (hit.t > EPSILON))[None, :], beta * att,
                         beta)

        # boundary / priority logic (deviceCode.cu:372-432)
        is_boundary = mat.boundary
        true_hit = ~(is_boundary & (mat.priority > dom_pri)) | ~hitv
        false_hit = hitv & ~true_hit

        dom_ior = mats.ior[dom_id]
        second = lm.second_lowest_mediumT(ms, mat_id)
        eta_t_exit = jnp.where(ms.top == 1, 1.0, mats.ior[second])
        is_dielectric_hit = (hitv & true_hit & is_boundary
                             & (mat.type == 2))
        eta_i = jnp.where(is_dielectric_hit, dom_ior, eta_i)
        eta_t = jnp.where(is_dielectric_hit,
                          jnp.where(backface, eta_t_exit, mat.ior), eta_t)
        non_boundary = hitv & ~is_boundary
        eta_i = jnp.where(non_boundary, dom_ior, eta_i)

        ms = lm.stack_pushT(ms, mat_id, mat.priority,
                            false_hit & ~backface)
        ms = lm.stack_removeT(ms, mat_id, false_hit & backface)

        # emission (deviceCode.cu:438-455)
        emissive = lm.length_sqT(info["emission"]) > EPSILON
        direct_view = (depth == 0) | ~hit_nonspec
        shade = hitv & true_hit
        add_direct = shade & emissive & direct_view
        li = li + jnp.where(add_direct[None, :], beta * info["emission"],
                            0.0)

        start_shadow = jnp.zeros_like(drained)
        has_shadow = jnp.zeros_like(drained)
        if use_mis:
            light_pdf_hit = lm.nee_pdfT(
                scene, prev_point, info["point"],
                info["normal_a"], info["area"])
            w_bsdf = lm.power2_weight(prev_pdf, light_pdf_hit)
            add_mis = (shade & emissive & ~direct_view & ~is_specular
                       & (light_pdf_hit > EPSILON))
            li = li + jnp.where(add_mis[None, :],
                                beta * info["emission"] * w_bsdf[None, :],
                                0.0)

        if do_nee_stage:
            do_nee = shade & ~emissive & ~is_specular
            ns = lm.nee_sampleT(
                scene, skey, _D_NEE, info["point"], normal, wi_local, mat,
                albedo, eta_i, do_nee, ids=did, transmission=trans,
                lobe_mask=lobes)
            bsdf_pdf_nee = lm.bsdf_pdfT(mat, -wi_local, ns.wo_local,
                                        eta_i, transmission=trans,
                                        lobe_mask=lobes)
            w_nee = lm.power2_weight(ns.light_pdf, bsdf_pdf_nee)
            pending = jnp.where(ns.active[None, :],
                                beta * ns.contrib * w_nee[None, :], pending)
            # early lanes already launched this exact shadow at a mini
            start_shadow = ns.active & ~was_early
            has_shadow = ns.active
            rays = rays + jnp.sum(ns.active.astype(jnp.int32))

        # BSDF sampling (deviceCode.cu:476-479)
        wo_local, f_val, pdf = lm.bsdf_sampleT(
            skey, _D_BSDF, mat, albedo, -wi_local, backface, eta_i, ids=did,
            transmission=trans, lobe_mask=lobes)
        pdf = jnp.maximum(pdf, 0.01)  # deviceCode.cu:481

        refracted = wo_local[2] < 0.0
        ms = lm.stack_pushT(ms, mat_id, mat.priority,
                            shade & refracted & ~backface)
        ms = lm.stack_removeT(ms, mat_id, shade & refracted & backface)

        new_beta = beta * f_val * (jnp.abs(wo_local[2]) / pdf)[None, :]
        beta = jnp.where(shade[None, :], new_beta, beta)

        wo_world = lm.normalizeT(lm.to_worldT(wo_local, normal))
        side = jnp.where(wo_local[2] > 0.0, 1.0, -1.0)
        o_true = info["point"] + normal * (side * EPSILON)[None, :]
        o_false = info["point"] + sd_d * RAY_EPSILON
        cand_o = jnp.where(shade[None, :], o_true, o_false)
        cand_d = jnp.where(shade[None, :], wo_world, sd_d)
        nxt_o = jnp.where(hitv[None, :], cand_o, nxt_o)
        nxt_d = jnp.where(hitv[None, :], cand_d, nxt_d)

        prev_pdf = jnp.where(shade, pdf, prev_pdf)
        prev_point = jnp.where(shade[None, :], info["point"], prev_point)
        new_depth = depth + jnp.where(false_hit, 0, 1)
        depth = jnp.where(hitv, new_depth, depth)

        # Russian roulette past maxDepth (deviceCode.cu:523-532)
        rr_zone = hitv & (depth > max_depth + 1)
        p_surv = jnp.clip(lm.luminanceT(beta), 0.05, 0.99)
        u_rr = rng.uniform_id(skey, _D_RR, did)
        killed = rr_zone & (u_rr > p_surv)
        beta = jnp.where((rr_zone & ~killed)[None, :],
                         beta / p_surv[None, :], beta)
        hit_nonspec = jnp.where(hitv, hit_nonspec | (hitv & ~is_specular),
                                hit_nonspec)
        lane_dead = killed | (depth >= HARD_DEPTH_CAP) | (lit >= LIT_CAP)
        path_on = hitv & ~lane_dead
        alive = jnp.where(cl_done, path_on, alive)
        # a killed/capped lane with a pending NEE shadow still flushes it
        dead = dead | (cl_done & ~path_on & ~has_shadow)
        lit = jnp.where(cl_done, lit + 1, lit)

        # ------ 2b. early-NEE settlement -------------------------------
        # res_early: the early shadow already drained — resolve the now-
        # weighted pending immediately and fall through to the normal
        # next-ray launch. fly_early & has_shadow: keep the flight, the
        # mini resolves it once the early flag is cleared. cancel: the
        # speculative launch turned out non-NEE (specular/emissive/false
        # hit) — the flight is either overwritten by the next launch
        # (path continues) or force-drained (path dead).
        res_early = was_early & (ts.flag < 0)
        fly_early = was_early & (ts.flag >= 0)
        cancel = fly_early & ~has_shadow
        li = li + jnp.where((res_early & has_shadow)[None, :],
                            pending * ts.scale, 0.0)
        pending = jnp.where(res_early[None, :], 0.0, pending)
        dead = dead | (res_early & ~path_on) | (cancel & ~path_on)

        # ------ 3. retire finished paths + refill from the pixel queue ----
        # A retired path's radiance lands in the lane's own SLOT LIST
        # (acc[k, :, lane] + ret_pid[k, lane], k = the lane's retire
        # count): masked row-writes instead of the [W]-indexed
        # scatter-add this replaces (scattered rows serialized on the
        # previous accelerator); run_chunk resolves the slots to
        # pixels with ONE scatter after the loop. The pixel QUEUE is
        # dynamic for load balance: a lane that drew several deep-RR
        # paths must not serialize them while other lanes idle (a static
        # per-lane pixel assignment ran a much longer drain tail).
        # one fused one-hot select over [K,W] instead of K sequential
        # masked at[k].set ops (each update re-traverses the buffer);
        # radiance packs to one RGB9E5 word so the sweep reads/writes
        # 2 [K,W] i32 planes, not [K,3,W]+[K,W] floats
        if scatter_ret:
            # compacted flush: <= ret_cap finished lanes scatter-add
            # (pid, li) rows into the chunk-image carry (aliased in
            # place); overflow lanes keep pend=True and their li/pid
            # until a later transition — exact, just deferred
            cap = min(ret_cap, s.pid.shape[0])  # the narrow tail stage
            #                                     runs this code too
            pendA = s.pend | dead
            rank = jnp.cumsum(pendA.astype(jnp.int32))
            m_sel = pendA & (rank <= cap)
            if _os.environ.get("TPT_MEGA_ABLATE_RETIRE"):
                img, pend = s.img, pendA  # cost probe: never flush...
                pend = pendA & ~m_sel     # ...but keep the loop finite
                pid = jnp.where(m_sel, -1, pid)
            else:
                lane_i = jnp.arange(pid.shape[0], dtype=jnp.int32)
                mkey = jnp.where(m_sel, pid.shape[0] - lane_i, 0)
                mval, m_idx = jax.lax.top_k(mkey, cap)
                sub_ok = mval > 0
                tgt = jnp.where(sub_ok, pid[m_idx], c_pix)
                rows = jnp.where(sub_ok[:, None], li[:, m_idx].T, 0.0)
                img = s.img.at[tgt].add(rows, mode="drop")
                pend = pendA & ~m_sel
                pid = jnp.where(m_sel, -1, pid)
            acc, ret_pid = s.acc, s.ret_pid
            ret_count = s.ret_count
            want = (pid < 0) & (s.next_px < cnt)
        elif not flush:
            # deferred-flush window: finished lanes park on `pend` (pid
            # and li held for the next flushing transition); nothing is
            # written to the slot buffers and no lane refills from them
            pend = s.pend | dead
            acc, ret_pid, ret_count = s.acc, s.ret_pid, s.ret_count
            img = s.img
            want = (pid < 0) & (s.next_px < cnt) & (ret_count < k_slots)
        elif window_ret:
            # windowed slot sweep (see RETIRE_WIN): one-hot over a
            # [ret_win, W] dynamic-slice of the slot buffers based at the
            # lowest retiring ret_count; out-of-window lanes (> ret_win
            # generations ahead of the lagging retiree — rare) park on
            # `pend` like the scatter mode and flush once the window
            # advances. Same slots, same values as the full sweep.
            retire_set = s.pend | dead
            rc = s.ret_count
            if _os.environ.get("TPT_MEGA_ABLATE_RETIRE"):
                acc, ret_pid = s.acc, s.ret_pid
                ret_count = rc + retire_set.astype(jnp.int32)
                pid = jnp.where(retire_set, -1, pid)
                pend = jnp.zeros_like(s.pend)
            else:
                k_lo = jnp.min(jnp.where(retire_set, rc,
                                         jnp.int32(k_slots)))
                k_lo = jnp.clip(k_lo, 0, max(k_slots - ret_win, 0))
                in_win = retire_set & (rc < k_lo + ret_win)
                rel = rc - k_lo
                kk_ar = jnp.arange(ret_win, dtype=jnp.int32)
                mg = in_win[None, :] & (rel[None, :] == kk_ar[:, None])
                li_pk = packing.pack_rgb9e5_cols(li)
                acc_w = jax.lax.dynamic_slice(
                    s.acc, (k_lo, 0), (ret_win, s.acc.shape[1]))
                pid_w = jax.lax.dynamic_slice(
                    s.ret_pid, (k_lo, 0), (ret_win, s.ret_pid.shape[1]))
                acc_w = jnp.where(mg, li_pk[None, :], acc_w)
                pid_w = jnp.where(mg, pid[None, :], pid_w)
                acc = jax.lax.dynamic_update_slice(s.acc, acc_w, (k_lo, 0))
                ret_pid = jax.lax.dynamic_update_slice(s.ret_pid, pid_w,
                                                       (k_lo, 0))
                ret_count = rc + in_win.astype(jnp.int32)
                pid = jnp.where(in_win, -1, pid)
                pend = retire_set & ~in_win
            img = s.img
            want = (pid < 0) & (s.next_px < cnt) & (ret_count < k_slots)
        else:
            retire_set = s.pend | dead  # each lane holds <= 1 finished
            kk_ar = jnp.arange(k_slots, dtype=jnp.int32)
            mg = (retire_set[None, :]
                  & (s.ret_count[None, :] == kk_ar[:, None]))
            if _os.environ.get("TPT_MEGA_ABLATE_RETIRE"):
                acc, ret_pid = s.acc, s.ret_pid
            else:
                li_pk = packing.pack_rgb9e5_cols(li)
                acc = jnp.where(mg, li_pk[None, :], s.acc)
                ret_pid = jnp.where(mg, pid[None, :], s.ret_pid)
            ret_count = s.ret_count + retire_set.astype(jnp.int32)
            pid = jnp.where(retire_set, -1, pid)
            img, pend = s.img, jnp.zeros_like(s.pend)
            want = (pid < 0) & (s.next_px < cnt) & (ret_count < k_slots)
        rank = jnp.cumsum(want.astype(jnp.int32))
        new_q = s.next_px + rank - 1
        got = want & (new_q < cnt)
        next_px = s.next_px + jnp.sum(got.astype(jnp.int32))
        if qidx is None:  # identity queue (main stage): no table gather
            new_pid = jnp.where(got, new_q, 0)
        else:
            new_pid = qidx[jnp.where(got, new_q, 0)]
        pid = jnp.where(got, new_pid, pid)
        gp = jnp.where(got, new_pid, 0)
        gpx, gpy = pix_coords(pxc, pyc, gbase, gp)
        # camera jitter is keyed by PIXEL id (same stream as the classic
        # engine and vcm_mega): primary rays are engine-invariant
        go, gd = lm.generate_raysT(camera, cam_key, gpx, gpy,
                                   ids=rng.pixel_ids(gpx, gpy))
        # fresh path registers for refilled lanes
        g2 = got[None, :]
        li = jnp.where(g2, 0.0, li)
        beta = jnp.where(g2, 1.0, beta)
        depth = jnp.where(got, 0, depth)
        lit = jnp.where(got, 0, lit)
        alive = jnp.where(got, True, alive)
        prev_pdf = jnp.where(got, EPSILON, prev_pdf)
        hit_nonspec = jnp.where(got, False, hit_nonspec)
        prev_point = jnp.where(g2, 0.0, prev_point)
        eta_i = jnp.where(got, EPSILON, eta_i)
        eta_t = jnp.where(got, EPSILON, eta_t)
        ms = lm.MediumStackT(
            jnp.where(g2, 0, ms.stack).astype(ms.stack.dtype),
            jnp.where(got, 0, ms.top))
        pending = jnp.where(g2, 0.0, pending)

        # ------ 4. launch the next traversal per lane ---------------------
        #   shadow first when NEE is pending; else the stored/new closest.
        #   Early lanes whose legit shadow is still flying launch NOTHING
        #   (the flight continues; the mini resolves it); canceled early
        #   flights are overwritten (path continues) or force-drained
        #   (path dead, no refill).
        go_shadow = start_shadow
        go_closest = (got | cont
                      | (cl_done & path_on & ~start_shadow
                         & ~(fly_early & has_shadow)))
        o2 = jnp.where(go_shadow[None, :],
                       ns.origin if do_nee_stage else s.o,
                       jnp.where(got[None, :], go,
                                 jnp.where((cont | cl_done)[None, :], nxt_o,
                                           s.o)))
        d2 = jnp.where(go_shadow[None, :],
                       ns.dir if do_nee_stage else s.d,
                       jnp.where(got[None, :], gd,
                                 jnp.where((cont | cl_done)[None, :], nxt_d,
                                           s.d)))
        start_any = go_shadow | go_closest
        t_lim = jnp.where(go_shadow,
                          ns.max_t if do_nee_stage else BIG_T, BIG_T)
        is_shadow = jnp.where(start_any, go_shadow, s.is_shadow)
        kill_fly = cancel & ~path_on
        ts = ts._replace(flag=jnp.where(kill_fly, -1, ts.flag))
        is_shadow = is_shadow & ~kill_fly
        ts = trav_start(ts, start_any, t_lim)
        # drained lanes that launched nothing go idle
        ts = ts._replace(flag=jnp.where(drained & ~start_any, -1, ts.flag))
        rays = rays + jnp.sum(go_closest.astype(jnp.int32))

        o2 = jnp.where(start_any[None, :], o2, s.o)
        d2 = jnp.where(start_any[None, :], d2, s.d)
        inv_d = jnp.where(start_any[None, :], lm.safe_inv_dirT(d2), s.inv_d)
        prays = (jnp.where(got, 0, s.prays)
                 + start_any.astype(jnp.int32)
                 # early lanes' shadow counts HERE (where rays counts it)
                 + (was_early & has_shadow & ~got).astype(jnp.int32))

        # every early lane was shaded above — the flag resets until a mini
        # sets it again
        early0 = jnp.zeros_like(was_early)
        return _MState(rays, s.it, s.fires + 1, s.busy, ts, o2, d2,
                       inv_d, is_shadow, early0, s.h_point, s.h_d, s.h_t,
                       s.h_tri, s.h_u, s.h_v, next_px, ret_count, prays,
                       pid, lit, depth, beta, li, alive, prev_pdf,
                       hit_nonspec, prev_point, eta_i, eta_t, ms.stack,
                       ms.top, pending, nxt_o, nxt_d, pend, img, ret_pid,
                       acc)

    def mini(s: _MState, gbase, do_early: bool = True) -> _MState:
        """Mini-transition between full transitions, two cheap jobs:

        1. resolve drained NEE shadow lanes (they already hold their next
           closest ray, stored at shade — no gathers, draws or shading);
        2. EARLY-NEE overlap: a drained CLOSEST lane with a hit launches
           its NEE shadow ray NOW instead of idling until the full
           transition. The light sample needs only the hit point
           (o + d*t, pure arithmetic) and its counter-keyed draws — the
           shade later recomputes the identical sample for the weight
           math, so the image is bit-identical; only the launch timing
           changes. Speculative launches on lanes that turn out
           specular/emissive/false-hit are canceled at shade (wasted
           steps only — rare on real scenes; ray counts still tally at
           shade, so the rays metric is schedule-invariant).
        """
        ts = s.ts
        done_sh = ((ts.flag < 0) & (s.pid >= 0) & s.is_shadow
                   & s.path_alive & ~s.early)
        li = s.li + jnp.where(done_sh[None, :], s.pending * ts.scale, 0.0)
        pending = jnp.where(done_sh[None, :], 0.0, s.pending)
        ts = trav_start(ts, done_sh,
                        jnp.full(s.pid.shape, BIG_T, jnp.float32))
        o = jnp.where(done_sh[None, :], s.nxt_o, s.o)
        d = jnp.where(done_sh[None, :], s.nxt_d, s.d)
        is_shadow = s.is_shadow & ~done_sh
        rays = s.rays + jnp.sum(done_sh.astype(jnp.int32))
        prays = s.prays + done_sh.astype(jnp.int32)
        early = s.early
        h_point, h_d = s.h_point, s.h_d
        h_t, h_tri, h_u, h_v = s.h_t, s.h_tri, s.h_u, s.h_v

        if do_nee_stage and early_nee and do_early:
            el = ((ts.flag < 0) & (s.pid >= 0) & ~s.pend & ~is_shadow
                  & (ts.tri >= 0))
            gpid = gbase + jnp.maximum(s.pid, 0)
            did = ids2(gpid, s.lit)
            point = o + d * ts.t_cut[None, :]
            lp, _ln, _le, _la, _lt = lm.sample_light_pointT(
                scene, skey, _D_NEE, s.pid.shape[0], ids=did)
            # EXACT nee_sampleT ray formulas (ops/lanemajor.py) — the
            # shade recomputes these bits identically
            stl = lp - point
            wi = lm.normalizeT(stl)
            dist = jnp.sqrt(jnp.maximum(lm.length_sqT(stl), 0.0))
            origin = point + wi * EPSILON
            max_t = (dist - EPSILON) * (1.0 - EPSILON)

            h_point = jnp.where(el[None, :], point, h_point)
            h_d = jnp.where(el[None, :], d, h_d)
            h_t = jnp.where(el, ts.t_cut, h_t)
            h_tri = jnp.where(el, ts.tri, h_tri)
            h_u = jnp.where(el, ts.u, h_u)
            h_v = jnp.where(el, ts.v, h_v)
            ts = trav_start(ts, el, max_t)
            o = jnp.where(el[None, :], origin, o)
            d = jnp.where(el[None, :], wi, d)
            is_shadow = is_shadow | el
            early = early | el
            # NOTE prays is NOT incremented here: it mirrors the `rays`
            # tally, which counts NEE shadows at shade (ns.active) so the
            # metric stays schedule-invariant; the transition adds the
            # early lanes' shadow there
            relaunched = done_sh | el
        else:
            relaunched = done_sh

        inv_d = jnp.where(relaunched[None, :], lm.safe_inv_dirT(d),
                          s.inv_d)
        return s._replace(ts=ts, o=o, d=d, inv_d=inv_d, is_shadow=is_shadow,
                          early=early, h_point=h_point, h_d=h_d, h_t=h_t,
                          h_tri=h_tri, h_u=h_u, h_v=h_v,
                          li=li, pending=pending, rays=rays, prays=prays)

    def make_cond(cnt, tail_w: int = 0):
        """Loop condition; with tail_w set, the loop ALSO stops once the
        queue is exhausted and at most tail_w lanes remain busy (the
        stragglers are then handed to the narrow tail machine)."""
        def cond(s: _MState):
            more_px = (s.next_px < cnt) & jnp.any(s.ret_count < k_slots)
            n_act = jnp.sum((s.pid >= 0).astype(jnp.int32))
            go = (n_act > 0) if not tail_w else (n_act > tail_w)
            return (go | more_px) & (s.it < 1 << 26)
        return cond

    def make_body(pxc, pyc, gbase, cnt, qidx):
        # RETIRE_EVERY > 1 unrolls that many windows per while iteration
        # so the flush/no-flush alternation stays STATIC (a lax.cond
        # around the transition breaks the while-carry aliasing)
        f_every = max(1, RETIRE_EVERY) if not scatter_ret else 1

        def body(s: _MState):
            # straight-line body: steps_per_iter traversal node-steps, then
            # the transition UNCONDITIONALLY.
            skip = jnp.full(s.pid.shape, -1, jnp.int32)
            msplit = max(1, min(mini_splits, steps_per_iter))
            per_group = max(1, steps_per_iter // msplit)
            for f in range(f_every):
                for g in range(msplit):
                    ts = s.ts
                    for _ in range(per_group):
                        ts = fstep(ts, s.o, s.d, s.inv_d, skip,
                                   s.is_shadow)
                        if debug_counters:
                            s = s._replace(busy=s.busy + jnp.sum(
                                (ts.flag >= 0).astype(jnp.int32)))
                    s = s._replace(ts=ts)
                    if g + 1 < msplit:
                        # the early-NEE block (draws + light math) is too
                        # costly for every mini; fire it once mid-window
                        s = mini(s, gbase,
                                 do_early=(g == (msplit - 1) // 2))
                s = s._replace(it=s.it + 1)
                s = transition(s, pxc, pyc, gbase, cnt, qidx,
                               flush=(f == f_every - 1))
            return s
        return body

    def make_init(pxc, pyc, gbase, cnt, qidx, mw):
        """Launch state at width mw: lane l starts on queue slot l."""
        z3 = jnp.zeros((3, mw), jnp.float32)
        ms0 = lm.MediumStackT.make(mw, mats.priority[0])
        dx0 = jnp.concatenate([jnp.ones((1, mw)), jnp.zeros((2, mw))],
                              axis=0)
        lane = jnp.arange(mw, dtype=jnp.int32)
        live = lane < cnt
        if qidx is None:
            pid0 = jnp.where(live, lane, -1)
        else:
            pid0 = jnp.where(live,
                             qidx[jnp.minimum(lane, qidx.shape[0] - 1)], -1)
        gp = jnp.maximum(pid0, 0)
        gpx, gpy = pix_coords(pxc, pyc, gbase, gp)
        go, gd = lm.generate_raysT(camera, cam_key, gpx, gpy,
                                   ids=rng.pixel_ids(gpx, gpy))
        return _MState(
            rays=jnp.sum(live.astype(jnp.int32)), it=jnp.int32(0),
            fires=jnp.int32(0), busy=jnp.int32(0),
            ts=trav_start(trav_idle(mw, _t8.stack_dtype(scene)), live,
                          jnp.full((mw,), BIG_T, jnp.float32)),
            o=go, d=gd,
            inv_d=lm.safe_inv_dirT(gd),
            is_shadow=jnp.zeros((mw,), bool),
            early=jnp.zeros((mw,), bool),
            h_point=z3, h_d=dx0,
            h_t=jnp.zeros((mw,), jnp.float32),
            h_tri=jnp.full((mw,), -1, jnp.int32),
            h_u=jnp.zeros((mw,), jnp.float32),
            h_v=jnp.zeros((mw,), jnp.float32),
            next_px=jnp.minimum(jnp.int32(mw), cnt),
            ret_count=jnp.zeros((mw,), jnp.int32),
            prays=live.astype(jnp.int32),
            pid=pid0,
            lit=jnp.zeros((mw,), jnp.int32),
            depth=jnp.zeros((mw,), jnp.int32),
            beta=jnp.ones((3, mw), jnp.float32),
            li=z3,
            path_alive=jnp.ones((mw,), bool),
            prev_pdf=jnp.full((mw,), EPSILON, jnp.float32),
            hit_nonspec=jnp.zeros((mw,), bool),
            prev_point=z3,
            eta_i=jnp.full((mw,), EPSILON, jnp.float32),
            eta_t=jnp.full((mw,), EPSILON, jnp.float32),
            ms_stack=ms0.stack, ms_top=ms0.top,
            pending=z3, nxt_o=z3, nxt_d=dx0,
            pend=jnp.zeros((mw,), bool),
            img=jnp.zeros((c_pix if scatter_ret else 1, 3), jnp.float32),
            ret_pid=jnp.full((k_slots, mw), -1, jnp.int32),
            acc=jnp.zeros((k_slots, mw), jnp.uint32))

    def _slots_to_image(out):
        if scatter_ret:  # paths landed in the carried image directly
            return out.img
        rows = packing.unpack_rgb9e5(out.acc).reshape(-1, 3)
        pids = out.ret_pid.reshape(-1)
        return jnp.zeros((c_pix, 3), jnp.float32).at[
            jnp.where(pids >= 0, pids, c_pix)].add(rows, mode="drop")

    # narrow tail stage: after the queue drains, the few straggling deep
    # paths would otherwise ride full-width lockstep steps for ~a hundred
    # iterations. Instead the full-width loop stops once <= tail_w lanes
    # are busy, and the stragglers' PIXELS are re-rendered from scratch by
    # a tail_w-wide copy of the same machine — the replay is exact because
    # every draw is keyed by (pixel index, bounce), and the stragglers'
    # stage-1 partial radiance is simply never retired (their per-path ray
    # counts are subtracted to keep ray totals schedule-invariant).
    _tail_env = int(_os.environ.get("TPT_MEGA_TAIL_W", "0"))
    tail_w = _tail_env or max(w // 8, 1 << 11)
    two_stage = (w > 4 * tail_w) or (bool(_tail_env) and w > tail_w)

    def run_chunk(pxc, pyc, gbase):
        cnt = jnp.minimum(p_total - gbase, c_pix)
        # main stage queue is the identity map — no qidx table
        out = jax.lax.while_loop(
            make_cond(cnt, tail_w if two_stage else 0),
            make_body(pxc, pyc, gbase, cnt, None),
            make_init(pxc, pyc, gbase, cnt, None, w))
        img = _slots_to_image(out)
        rays, it, fires, busy = out.rays, out.it, out.fires, out.busy
        if two_stage:
            strag = out.pid >= 0
            n_strag = jnp.sum(strag.astype(jnp.int32))
            sidx = jnp.nonzero(strag, size=tail_w, fill_value=0)[0]
            spid = out.pid[sidx]
            rays = rays - jnp.sum(jnp.where(strag, out.prays, 0))
            out2 = jax.lax.while_loop(
                make_cond(n_strag),
                make_body(pxc, pyc, gbase, n_strag, spid),
                make_init(pxc, pyc, gbase, n_strag, spid, tail_w))
            img = img + _slots_to_image(out2)
            rays = rays + out2.rays
            it = it + out2.it
            fires = fires + out2.fires
            busy = busy + out2.busy
        return img, rays, it, fires, busy

    def chunk_body(_, ci):
        if grid_w:
            pxc = pyc = None
        else:
            pxc = jax.lax.dynamic_slice_in_dim(pxf, ci * c_pix, c_pix)
            pyc = jax.lax.dynamic_slice_in_dim(pyf, ci * c_pix, c_pix)
        return 0, run_chunk(pxc, pyc, ci * c_pix)

    if n_chunks == 1:
        acc, rays, it, fires, busy = run_chunk(pxf, pyf, jnp.int32(0))
        acc = acc[:p_total]
    else:
        _, (accs, rayss, its, firess, busys) = jax.lax.scan(
            chunk_body, 0, jnp.arange(n_chunks, dtype=jnp.int32))
        acc = accs.reshape(-1, 3)[:p_total]
        rays, it, fires = rayss.sum(), its.sum(), firess.sum()
        busy = busys.sum()
    if debug_counters:
        return acc, rays, it, fires, busy
    return acc, rays
