"""Persistent mega-wavefront VCM/SPPM eye pass — LANE-MAJOR.

Same estimator as models/vcm.py (the reference's doEyePass,
deviceCode.cu:2386-3065: implicit hit, NEE, vertex connections against the
stored light path, photon merging, all under the VCM d_vcm/d_vc/d_vm MIS
recursion), reorganized as ONE persistent lane machine:

  * the classic eye pass pays a lockstep traversal tail per bounce per
    connection — eye_depth closest calls + eye_depth NEE shadows +
    eye_depth*light_depth connection shadows each run full-width while
    most lanes are drained (the dominant waste on the previous
    accelerator);
  * here every lane cycles through its own phase sequence
    closest -> NEE shadow -> conn(j..L-1) shadows -> next closest with no
    barriers: a drained lane relaunches on its next ray at the next
    transition while other lanes keep traversing, and invalid
    connections (light path shorter than j) are skipped wholesale via
    the per-path valid-vertex count;
  * all per-lane shading/connection math is lane-major ([3,W] vectors,
    ops/lanemajor.py), the layout of the traversal step and the
    unidirectional mega transition.

Two transition flavors ride the fused node-step loop
(ops/traverse8.make_fused_step):
  LIGHT transition — resolve finished shadows, launch the lane's next
    connection (one generic connection computation serves every lane's
    own j via a single packed-row gather), commit finished bounces,
    retire finished paths and refill from the pixel queue;
  FULL transition — LIGHT plus the shade block for drained closest
    lanes: shade-row decode, VCM MIS advance, implicit-hit (s=0), photon
    merge fold, BSDF sampling for the next bounce, and the NEE launch.
Shadow phases outnumber the closest phase per bounce, so firing several
LIGHT transitions per FULL transition keeps the expensive shade/merge
block off the fast path — the same mini/full cadence the unidirectional
mega engine uses.

The light pass, t=1 light-trace splat and photon-grid build are the
classic scan implementations (models/paths.py, models/vcm.py) run per
pixel CHUNK: light path i pairs with chunk pixel i exactly like the
reference pairs light path and pixel by thread index
(deviceCode.cu:1780), and eta_vcm / merge normalization use the chunk's
TRUE path count (the estimator is per-path-count normalized, so any
chunk size is unbiased — the reference's own count is just "however many
pixels the launch covered"; tail-padding lanes are masked out of the
light pass so they add no energy).

Sampling is keyed by (global pixel index, bounce) via the
layout-independent id streams, so the image is invariant to lane
scheduling, wavefront width and transition cadence — a different
(equally valid) noise realization than the classic integrator, exactly
like models/unidirectional_mega.py.
"""

from __future__ import annotations

import os as _os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.models import mis, paths
from cudapathtracer_tpu.models.vcm import VCMConfig, vcm_light_splat
from cudapathtracer_tpu.ops import hashgrid
from cudapathtracer_tpu.ops import lanemajor as lm
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.ops.intersect import BIG_T
from cudapathtracer_tpu.ops import traverse8 as _t8
from cudapathtracer_tpu.ops.traverse8 import (make_fused_step, trav_idle,
                                              trav_start)
from cudapathtracer_tpu.utils import packing, rng
from cudapathtracer_tpu.utils.math import (EPSILON, MAX_FIREFLY_LUM, PI,
                                           RAY_EPSILON, merge_radius)

MAX_G_NEE = 15.0      # deviceCode.cu:683
MAX_G_CONNECT = 2.0   # deviceCode.cu:1753

# lane phases (what the in-flight traversal is)
_PH_CLOSEST = 0
_PH_NEE = 1
_PH_CONN = 2

# draw-id roles (draw_base offsets under the eye key)
_D_BSDF = 0    # 4 draws
_D_NEE = 16    # 3 draws

_ID_STRIDE = 64  # ids = global_pixel_index * 64 + depth; eye_depth < 64

# (steps_per_iter, mini_splits, width) = (8, 2, 12960) won a sweep on the
# shipped 800^2 eye16/light10 workload on the previous accelerator, where
# connections were nearly free, the merge was a large share, and the
# transition cadence (mini_splits) mattered most. Not yet re-swept on the
# GPU (ROADMAP Queue 1 item 5).
STEPS_PER_ITER = int(_os.environ.get("TPT_MEGA_STEPS_PER_ITER", "8"))
MINI_SPLITS = int(_os.environ.get("TPT_MEGA_MINI_SPLITS", "2"))
# tuned default lane count + retire-slot factor — see unidirectional_mega
MEGA_WIDTH = int(_os.environ.get("TPT_MEGA_WIDTH", "12960"))
KSLOTS_FACTOR = float(_os.environ.get("TPT_MEGA_KSLOTS_FACTOR", "1.0"))
# photon-merge sub-wavefront capacity (lanes merged per FULL transition).
# The merge fold's gathers cost ~per-row, so folding at the full width W
# wastes most of the HBM traffic on lanes with nothing to merge. Too small
# a capacity throttles instead (deferral stalls). W/4 was the optimum of a
# sweep on the shipped 800^2 workload on the previous accelerator.
# 0 = auto (W/4, >=512, rounded up to a multiple of 128 lanes).
MERGE_W = int(_os.environ.get("TPT_MEGA_MERGE_W", "0"))

# Batched-slot merge (default on): evaluate the merge BSDF/MIS math once
# over all 8x8 candidate slots flattened to [64*mw] lanes instead of a
# 128-iteration slot fold — at the compacted sub-wavefront width the
# fold's tiny [mw] vectors were dominated by per-op overhead.
# Changes float summation order (a [64]-axis tree sum replaces the
# sequential fold), so images differ from the fold path by ~ulps; the
# candidate set and MIS math are identical. TPT_MEGA_MERGE_BATCH=0
# restores the sequential fold. (Read at trace time so tests can A/B.)
def _merge_batch_enabled():
    return _os.environ.get("TPT_MEGA_MERGE_BATCH", "1") != "0"


def _clampT(c):
    """Lane-major firefly clamp (util.cuh:31 semantics)."""
    lum = lm.luminanceT(c)
    s = jnp.where(lum > MAX_FIREFLY_LUM,
                  MAX_FIREFLY_LUM / jnp.maximum(lum, 1e-20), 1.0)
    return c * s[None, :]


def _weightedT(contrib, weight, cfg: VCMConfig):
    if cfg.paint_weight:
        return jnp.broadcast_to(weight[None, :], contrib.shape)
    if cfg.do_mis:
        return contrib * weight[None, :]
    return contrib


# conn-table row layout [32]: pt(0:3) n(3:6) wo(6:9) beta(9:12) uv(12:14)
# d_vcm(14) d_vc(15) ok(16) mat_id(17, bitcast i32)
_CONN_ROW = 32


def _pack_conn_table(lbufs):
    """Flatten the light-path vertex fields the connection stage reads into
    one [L*C, 32] float row table — the per-lane dynamic (j, light column)
    access in the persistent machine then costs ONE gather."""
    l, c = lbufs.valid.shape
    flat = lambda a: a.reshape((l * c,) + a.shape[2:])
    ok = (lbufs.valid & ~lbufs.is_delta).reshape(-1)
    mat_f = jax.lax.bitcast_convert_type(
        lbufs.mat_id.reshape(-1).astype(jnp.int32), jnp.float32)
    cols = [flat(lbufs.pt), flat(lbufs.n), flat(lbufs.wo), flat(lbufs.beta),
            flat(lbufs.uv),
            flat(lbufs.d_vcm)[:, None], flat(lbufs.d_vc)[:, None],
            ok.astype(jnp.float32)[:, None], mat_f[:, None]]
    rows = jnp.concatenate(cols, axis=1)
    pad = _CONN_ROW - rows.shape[1]
    return jnp.concatenate(
        [rows, jnp.zeros((l * c, pad), jnp.float32)], axis=1)


def _mat_from_ids(scene, mat_id):
    """Gather lane-major MaterialTable rows by material id (tiny table —
    every gather is over the [24] material registry)."""
    m = scene.materials
    g = lambda a: a[mat_id]
    g3 = lambda a: a[mat_id].T
    return lm.MatT(
        type=g(m.type), albedo=g3(m.albedo), roughness=g(m.roughness),
        eta=g3(m.eta), k=g3(m.k), ior=g(m.ior),
        transmission=g(m.transmission), is_specular=g(m.is_specular),
        boundary=g(m.boundary), thin_walled=g(m.thin_walled),
        absorption=g3(m.absorption), priority=g(m.priority),
        tex_start=g(m.tex_start), tex_width=g(m.tex_width),
        tex_height=g(m.tex_height), trans_tex_start=g(m.trans_tex_start),
        trans_tex_width=g(m.trans_tex_width),
        trans_tex_height=g(m.trans_tex_height))


def _eye_vertex(scene, s):
    """Re-derive the current eye vertex's shading data from the stored hit
    record (cur_tri/u/v + pos): one packed-row gather. The interpolated
    normal is oriented toward the PREVIOUS eye vertex (interpolate_hit
    flips against the incoming ray; prev_pt - pos is that direction)."""
    hit = traverse.Hit(t=jnp.zeros_like(s.cur_u), tri=s.cur_tri,
                       u=s.cur_u, v=s.cur_v)
    info, mat_e = lm.shade_dataT(scene, s.pos, s.d, hit)
    to_prev = lm.normalizeT(s.prev_pt - s.pos)
    normal = info["normal"]
    flip = lm.dotT(normal, to_prev) < 0.0
    normal = jnp.where(flip[None, :], -normal, normal)
    albedo = lm.resolve_albedoT(scene, mat_e, info["uv"])
    trans = lm.resolve_transmissionT(scene, mat_e, info["uv"])
    return normal, to_prev, mat_e, albedo, trans


class _VState(NamedTuple):
    rays: jax.Array       # scalar i32
    it: jax.Array
    fires: jax.Array
    next_px: jax.Array    # scalar i32 pixel queue head (dynamic queue —
    #                       load balance; see unidirectional_mega)
    ret_count: jax.Array  # [W] i32 paths this lane has retired
    ts: object            # TravState [W]
    o: jax.Array          # [3,W] in-flight ray
    d: jax.Array
    inv_d: jax.Array
    skip: jax.Array       # [W] i32 per-lane skip triangle (NEE light tri)
    phase: jax.Array      # [W] i32 _PH_*
    conn_j: jax.Array     # [W] i32 current connection index
    pid: jax.Array        # [W] i32 chunk-local pixel index; -1 idle
    depth: jax.Array      # [W] i32 eye bounce (0-based)
    li: jax.Array         # [3,W] accumulated path radiance
    pending: jax.Array    # [3,W] weighted contribution awaiting shadow
    thr: jax.Array        # [3,W] throughput at the CURRENT vertex
    prev_pdf_sa: jax.Array
    prev_cos: jax.Array
    prev_pt: jax.Array    # [3,W]
    prev_delta: jax.Array
    pos: jax.Array        # [3,W] current vertex position
    cur_tri: jax.Array    # [W] current vertex hit record
    cur_u: jax.Array
    cur_v: jax.Array
    conn_ok: jax.Array    # [W] current vertex can connect (valid & ~delta)
    d_vcm: jax.Array      # [W] current vertex MIS accumulators
    d_vc: jax.Array
    d_vm: jax.Array
    ms_dvcm: jax.Array    # MisState carry (applies to the NEXT vertex)
    ms_dvc: jax.Array
    ms_dvm: jax.Array
    ms_prev_rev: jax.Array
    ms_prev_delta: jax.Array
    alive: jax.Array      # [W] may continue after this bounce's phases
    nxt_o: jax.Array      # [3,W] staged next-bounce ray + registers
    nxt_d: jax.Array
    nxt_thr: jax.Array    # [3,W]
    nxt_pdf_sa: jax.Array
    nxt_cos: jax.Array
    ret_pid: jax.Array    # [K,W] i32 pixel of each retired slot; -1 empty
    acc: jax.Array        # [K,W] u32 per-slot retired radiance (RGB9E5
    #                       packed): retiring is a one-hot select over
    #                       [K,W], not a scatter (see
    #                       unidirectional_mega); one scatter per chunk
    #                       after the loop
    #                       resolves slots to pixels — see
    #                       unidirectional_mega._MState.acc for the
    #                       packing rationale
    dropped: jax.Array    # scalar i32: candidate photons truncated by the
    #                       static max_per_cell merge cap (the reference's
    #                       merge visits cells unboundedly,
    #                       deviceCode.cu:2968-3048) — always counted
    #                       (one cheap [mw] op per fold), surfaced by
    #                       render_sample(count_merge_dropped=True)
    pend: jax.Array       # [W] bool: path finished, radiance awaiting a
    #                       compacted flush slot (scatter retirement)
    img: jax.Array        # [c_pix,3] f32 chunk image (scatter
    #                       retirement; [1,3] dummy in slots mode) —
    #                       see unidirectional_mega._MState.img


def _machine_init(camera, cam_key, w, k_slots, cnt, pxc, pyc,
                  gbase=0, grid_w: int = 0, c_img: int = 1,
                  stack_dt=jnp.int32) -> "_VState":
    """Launch state: lane l starts on queue pixel l (lanes beyond the
    chunk's true count start idle). Shared by the VCM and BDPT flavors of
    the machine. grid_w: derive pixel coords arithmetically (see
    unidirectional_mega.render_sample)."""
    z3 = jnp.zeros((3, w), jnp.float32)
    dx0 = jnp.concatenate([jnp.ones((1, w)), jnp.zeros((2, w))], axis=0)
    zw = jnp.zeros((w,), jnp.float32)
    lane = jnp.arange(w, dtype=jnp.int32)
    lane_live = lane < cnt
    if grid_w:
        gidx = gbase + lane
        pxl, pyl = gidx % grid_w, gidx // grid_w
    else:
        pxl, pyl = pxc[lane], pyc[lane]
    gpix0 = rng.pixel_ids(pxl, pyl)
    go0, gd0 = lm.generate_raysT(camera, cam_key, pxl.astype(jnp.float32),
                                 pyl.astype(jnp.float32), ids=gpix0)
    aspect = camera.width / camera.height
    plane_area = 4.0 * aspect * camera.fov_scale * camera.fov_scale
    cos_cam0 = jnp.abs(lm.dotT(jnp.broadcast_to(
        jnp.reshape(camera.forward, (3, 1)), gd0.shape), gd0))
    return _VState(
        rays=jnp.sum(lane_live.astype(jnp.int32)), it=jnp.int32(0),
        fires=jnp.int32(0),
        next_px=jnp.minimum(jnp.int32(w), cnt),
        ret_count=jnp.zeros((w,), jnp.int32),
        ts=trav_start(trav_idle(w, stack_dt), lane_live,
                      jnp.full((w,), BIG_T, jnp.float32)),
        o=go0, d=gd0, inv_d=lm.safe_inv_dirT(gd0),
        skip=jnp.full((w,), -1, jnp.int32),
        phase=jnp.zeros((w,), jnp.int32),
        conn_j=jnp.zeros((w,), jnp.int32),
        pid=jnp.where(lane_live, lane, -1),
        depth=jnp.zeros((w,), jnp.int32),
        li=z3, pending=z3, thr=jnp.ones((3, w), jnp.float32),
        prev_pdf_sa=1.0 / (plane_area * cos_cam0 ** 3),
        prev_cos=cos_cam0,
        prev_pt=go0, prev_delta=jnp.ones((w,), bool),
        pos=z3, cur_tri=jnp.full((w,), -1, jnp.int32),
        cur_u=zw, cur_v=zw,
        conn_ok=jnp.zeros((w,), bool),
        d_vcm=zw, d_vc=zw, d_vm=zw,
        ms_dvcm=zw, ms_dvc=zw, ms_dvm=zw, ms_prev_rev=zw,
        ms_prev_delta=jnp.zeros((w,), bool),
        alive=jnp.ones((w,), bool),
        nxt_o=z3, nxt_d=dx0, nxt_thr=jnp.ones((3, w), jnp.float32),
        nxt_pdf_sa=zw, nxt_cos=zw,
        ret_pid=jnp.full((k_slots, w), -1, jnp.int32),
        acc=jnp.zeros((k_slots, w), jnp.uint32),
        dropped=jnp.int32(0),
        pend=jnp.zeros((w,), bool),
        img=jnp.zeros((c_img, 3), jnp.float32))


def _mk_eye_machine(scene, camera, cfg: VCMConfig, skey_e, cam_key, w,
                    gens, k_slots, cnt, eta_vcm, mr, merge_norm, grid,
                    conn_table, lpath_len, steps_per_iter, mini_splits,
                    flavor: str = "vcm", grid_w: int = 0,
                    merge_w: int = 0):
    """Build (cond, make_body) for one chunk's persistent eye machine.
    Lane l statically owns pixels g*w + l (see _VState.acc).

    cnt: traced true pixel/path count of this chunk (<= gens*w static);
    lpath_len: [C] i32 valid-vertex count of each paired light path.

    flavor selects the estimator family the phases implement:
      "vcm"  — VCM/SPPM weights (eta_vcm terms, d_vm chain, squared NEE
               bsdfRatio quirk, firefly-clamped weighted contributions,
               photon merge) — deviceCode.cu:2386-3065;
      "bdpt" — classic BDPT weights (no eta terms, linear NEE ratio, the
               t==2 camera-trace-pdf implicit-hit case, clamp only the
               implicit hit, no merge) — deviceCode.cu:1444-1766.
    """
    c_pix = gens * w
    is_bdpt = flavor == "bdpt"
    from cudapathtracer_tpu.models.unidirectional_mega import (RETIRE,
                                                               RETIRE_CAP,
                                                               RETIRE_WIN)
    scatter_ret = RETIRE == "scatter"
    window_ret = RETIRE == "window"
    ret_win = min(RETIRE_WIN, k_slots)
    ret_cap = min(w, RETIRE_CAP or max(-(-(w // 4) // 128) * 128, 256))
    fstep = make_fused_step(scene).lane_major
    num_lights = max(scene.num_lights, 1)
    do_nee = cfg.nee and scene.num_lights > 0
    do_conn = cfg.connection
    # stored light vertices available to the conn chain: the VCM walk
    # stores light_depth vertices, the BDPT walk light_depth-1
    l_depth = cfg.light_depth - 1 if is_bdpt else cfg.light_depth
    do_conn = do_conn and l_depth > 0
    # merge sub-wavefront capacity (see MERGE_W); capacity >= w disables
    # compaction and runs the legacy full-width masked fold
    if cfg.do_merge:
        mw = merge_w or MERGE_W
        if mw <= 0:
            mw = max(512, -(-(w // 4) // 128) * 128)
        mw = min(mw, w)
    else:
        mw = 0
    compact_merge = cfg.do_merge and mw < w
    plane_area = (4.0 * (camera.width / camera.height)
                  * camera.fov_scale * camera.fov_scale)
    # skip BSDF lobes no triangle references (bit-exact; see lanemajor)
    _lobes = getattr(scene, "mat_type_mask", lm.ALL_LOBES)
    bsdf_fT = partial(lm.bsdf_fT, lobe_mask=_lobes)
    bsdf_pdfT = partial(lm.bsdf_pdfT, lobe_mask=_lobes)
    bsdf_sampleT = partial(lm.bsdf_sampleT, lobe_mask=_lobes)
    nee_sampleT = partial(lm.nee_sampleT, lobe_mask=_lobes)

    def ids3(gpid, depth):
        return gpid * _ID_STRIDE + depth

    # -----------------------------------------------------------------
    def launch_conn(s: _VState, lanes, j):
        """Connection j for `lanes` (weights + unshadowed contribution,
        connectGeneral deviceCode.cu:2551-2755) -> launch bundle."""
        pos, thr = s.pos, s.thr
        normal, to_prev, mat_e, albedo_e, trans_e = _eye_vertex(scene, s)

        jc = jnp.clip(j, 0, l_depth - 1)
        row = conn_table[jc * c_pix + jnp.maximum(s.pid, 0)].T
        lpt, lnrm, lwo, lbeta = row[0:3], row[3:6], row[6:9], row[9:12]
        luv = row[12:14]
        l_dvcm, l_dvc = row[14], row[15]
        l_ok = row[16] > 0.5
        l_mat_id = jax.lax.bitcast_convert_type(row[17], jnp.int32)

        do = lanes & s.conn_ok & l_ok
        e2l = lpt - pos
        d2 = jnp.maximum(lm.length_sqT(e2l), RAY_EPSILON)
        dist = jnp.sqrt(d2)
        e2l_u = e2l / dist[None, :]
        cos_l = jnp.abs(lm.dotT(lnrm, -e2l_u))
        cos_e = jnp.abs(lm.dotT(normal, e2l_u))
        do = do & (cos_l >= EPSILON) & (cos_e >= EPSILON)

        mat_l = _mat_from_ids(scene, jnp.maximum(l_mat_id, 0))
        albedo_l = lm.resolve_albedoT(scene, mat_l, luv)
        trans_l = lm.resolve_transmissionT(scene, mat_l, luv)
        ones = jnp.ones_like(cos_l)

        l2e_loc_l = lm.to_localT(-e2l_u, lnrm)
        to_l_from_prev_loc = lm.to_localT(-lwo, lnrm)
        l2e_loc_e = lm.to_localT(-e2l_u, normal)
        to_prev_loc_e = lm.to_localT(to_prev, normal)

        pdf_eye_rev_sa = bsdf_pdfT(mat_l, -to_l_from_prev_loc, l2e_loc_l,
                                      ones, transmission=trans_l)
        pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2
        pdf_bef_eye_rev_sa = bsdf_pdfT(mat_e, -l2e_loc_e, to_prev_loc_e,
                                          ones, transmission=trans_e)
        pdf_light_rev_sa = bsdf_pdfT(mat_e, to_prev_loc_e, -l2e_loc_e,
                                        ones, transmission=trans_e)
        pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2
        pdf_bef_light_rev_sa = bsdf_pdfT(mat_l, l2e_loc_l,
                                            -to_l_from_prev_loc, ones,
                                            transmission=trans_l)

        w_eye = pdf_eye_rev_area * (eta_vcm + s.d_vcm
                                    + pdf_bef_eye_rev_sa * s.d_vc)
        w_light = pdf_light_rev_area * (eta_vcm + l_dvcm
                                        + pdf_bef_light_rev_sa * l_dvc)
        weight = 1.0 / (1.0 + w_eye + w_light)

        f_eye = bsdf_fT(mat_e, albedo_e, -l2e_loc_e, to_prev_loc_e,
                           ones, transmission=trans_e)
        f_light = bsdf_fT(mat_l, albedo_l, l2e_loc_l,
                             -to_l_from_prev_loc, ones, transmission=trans_l)
        gg = jnp.minimum(cos_e * cos_l / d2, MAX_G_CONNECT)
        contrib = thr * lbeta * f_eye * f_light * gg[None, :]
        pending = jnp.where(do[None, :],
                            _weightedT(contrib, weight, cfg), 0.0)
        origin = pos + normal * RAY_EPSILON
        # gated-off lanes start NO traversal (they stay drained with a
        # zero pending and advance the phase chain at the next transition)
        return pending, origin, e2l_u, dist - RAY_EPSILON, do

    # -----------------------------------------------------------------
    def launch_nee(s: _VState, lanes, gpid):
        """VCM NEE (connectNEE deviceCode.cu:2460-2549) minus the shadow
        trace; MIS weight computed up front. Returns the launch bundle +
        sampled light triangle for the per-lane skip."""
        pos, thr = s.pos, s.thr
        normal, to_prev, mat_e, albedo_e, trans_e = _eye_vertex(scene, s)
        ones = jnp.ones_like(s.cur_u)
        did = ids3(gpid, s.depth)

        n = pos.shape[1]
        ul = rng.uniform_any(skey_e, _D_NEE + 0, n, did)
        li_idx = jnp.minimum((ul * num_lights).astype(jnp.int32),
                             num_lights - 1)
        a = scene.light_p0[li_idx].T
        b = scene.light_p1[li_idx].T
        c = scene.light_p2[li_idx].T
        tri = scene.light_tri[li_idx]
        n3 = scene.tri_n[tri]                       # [N,3,3]
        u = jnp.sqrt(rng.uniform_any(skey_e, _D_NEE + 1, n, did))
        v = rng.uniform_any(skey_e, _D_NEE + 2, n, did)
        w0, w1, w2 = 1.0 - u, u * (1.0 - v), u * v
        p = w0[None, :] * a + w1[None, :] * b + w2[None, :] * c
        lnrm = lm.normalizeT(w0[None, :] * n3[:, 0].T
                             + w1[None, :] * n3[:, 1].T
                             + w2[None, :] * n3[:, 2].T)

        stl = p - pos
        d2 = jnp.maximum(lm.length_sqT(stl), RAY_EPSILON)
        dist = jnp.sqrt(d2)
        stl_u = stl / dist[None, :]

        cos_light = lm.dotT(lnrm, -stl_u)
        cos_surf = jnp.abs(lm.dotT(normal, stl_u))
        g = jnp.minimum(cos_light * cos_surf / d2, MAX_G_NEE)

        area = scene.light_area[li_idx]
        pdf_connect = (1.0 / num_lights) / jnp.maximum(area, 1e-20)
        pdf_emit_sa = cos_light / PI

        stl_local = lm.to_localT(stl_u, normal)
        to_prev_loc = lm.to_localT(to_prev, normal)
        f_val = bsdf_fT(mat_e, albedo_e, to_prev_loc, stl_local, ones,
                           transmission=trans_e)
        le = scene.light_emission[li_idx].T
        contrib = f_val * le * (g / pdf_connect)[None, :]

        pdf_bsdf_sa = bsdf_pdfT(mat_e, to_prev_loc, stl_local, ones,
                                   transmission=trans_e)
        pdf_bsdf_area = pdf_bsdf_sa * jnp.abs(cos_light) / d2
        ratio = pdf_bsdf_area / jnp.maximum(pdf_connect, 1e-20)
        if is_bdpt:
            w_light = ratio            # deviceCode.cu:1520 (linear)
        else:
            w_light = ratio * ratio    # VCM quirk: squared (2533)
        pdf_curr_rev_area = pdf_emit_sa * jnp.abs(stl_local[2]) / d2
        pdf_prev_rev_sa = bsdf_pdfT(mat_e, stl_local, to_prev_loc, ones,
                                       transmission=trans_e)
        w_eye = pdf_curr_rev_area * (eta_vcm + s.d_vcm
                                     + pdf_prev_rev_sa * s.d_vc)
        weight = 1.0 / (1.0 + w_light + w_eye)

        do = lanes & s.conn_ok & (cos_light >= EPSILON)
        pending = jnp.where(do[None, :],
                            _weightedT(contrib * thr, weight, cfg), 0.0)
        origin = pos + normal * RAY_EPSILON
        return pending, origin, stl_u, dist - EPSILON, tri, do

    # -----------------------------------------------------------------
    def transition(s: _VState, pxc, pyc, gbase, full: bool) -> _VState:
        ts = s.ts
        # pend lanes already finished their path; they idle awaiting a
        # compacted flush slot and must not re-enter any phase
        drained = (ts.flag < 0) & (s.pid >= 0) & ~s.pend
        gpid = gbase + jnp.maximum(s.pid, 0)
        rays = s.rays
        dropped = s.dropped
        n_conn = lpath_len[jnp.maximum(s.pid, 0)]  # valid light verts/lane

        # ---- 1. resolve finished shadow phases -------------------------
        sh_done = drained & (s.phase != _PH_CLOSEST)
        if cfg.paint_weight:
            # PAINTWEIGHT renders the MIS weight itself: the occlusion
            # test only gates, it must not scale the painted weight
            clear = jnp.max(ts.scale, axis=0) > 0.0
            resolved = jnp.where(clear[None, :], s.pending, 0.0)
        elif is_bdpt:
            # classic BDPT clamps only the implicit hit, not NEE/conn
            resolved = s.pending * ts.scale
        else:
            resolved = _clampT(s.pending * ts.scale)
        li = s.li + jnp.where(sh_done[None, :], resolved, 0.0)
        pending = jnp.where(sh_done[None, :], 0.0, s.pending)

        # what each resolved lane does next (invalid tail js are skipped
        # wholesale: light-path validity is a prefix, so j >= n_conn is
        # never worth a phase)
        conn_more = jnp.where(s.phase == _PH_NEE,
                              do_conn & s.conn_ok & (n_conn > 0),
                              s.conn_j + 1 < jnp.minimum(n_conn, l_depth))
        conn_next = sh_done & conn_more
        nextj = jnp.where(s.phase == _PH_NEE, 0, s.conn_j + 1)
        commit = sh_done & ~conn_next

        # ---- 2. shade drained closest lanes (FULL only) ----------------
        depth, thr = s.depth, s.thr
        prev_pdf_sa, prev_cos = s.prev_pdf_sa, s.prev_cos
        prev_pt, prev_delta = s.prev_pt, s.prev_delta
        pos = s.pos
        cur_tri, cur_u, cur_v = s.cur_tri, s.cur_u, s.cur_v
        conn_ok = s.conn_ok
        d_vcm, d_vc, d_vm = s.d_vcm, s.d_vc, s.d_vm
        mstate = mis.MisState(s.ms_dvcm, s.ms_dvc, s.ms_dvm,
                              s.ms_prev_rev, s.ms_prev_delta)
        alive = s.alive
        nxt_o, nxt_d = s.nxt_o, s.nxt_d
        nxt_thr = s.nxt_thr
        nxt_pdf_sa, nxt_cos = s.nxt_pdf_sa, s.nxt_cos
        dead = jnp.zeros_like(drained)
        nee_go = jnp.zeros_like(drained)

        if full:
            cl_done = drained & (s.phase == _PH_CLOSEST)
            hit = traverse.Hit(t=ts.t_cut,
                               tri=jnp.where(cl_done, ts.tri, -1),
                               u=ts.u, v=ts.v)
            info, mat = lm.shade_dataT(scene, s.o, s.d, hit)
            reached = cl_done & hit.valid
            missed = cl_done & ~hit.valid
            dead = dead | missed
            if cfg.sample_environment:
                # escape -> sky, MIS weight 1 (models/bdpt.py module doc);
                # the reference leaves env endpoints unimplemented (2386)
                out = _weightedT(thr * lm.sample_skyT(s.d, True),
                                 jnp.ones_like(s.cur_u), cfg)
                li = li + jnp.where(missed[None, :], out, 0.0)
            did = ids3(gpid, depth)
            ones = jnp.ones_like(cur_u)

            normal = info["normal"]
            npos = info["point"]
            wo_local = lm.to_localT(s.d, normal)
            albedo = lm.resolve_albedoT(scene, mat, info["uv"])
            trans = lm.resolve_transmissionT(scene, mat, info["uv"])
            cur_delta = mat.is_specular

            d2p = jnp.maximum(lm.length_sqT(npos - prev_pt), RAY_EPSILON)
            pdf_fwd_area = prev_pdf_sa * jnp.abs(wo_local[2]) / d2p
            g = prev_cos / d2p

            wi_local, f_val, pdf_sa = bsdf_sampleT(
                skey_e, _D_BSDF, mat, albedo, -wo_local, info["backface"],
                ones, 0, ids=did, transmission=trans)
            pdf_rev_sa = bsdf_pdfT(mat, wi_local, -wo_local, ones,
                                      transmission=trans)
            valid = reached & (pdf_sa >= EPSILON)

            first_d_vcm = 1.0 / jnp.maximum(pdf_fwd_area, 1e-20)
            zw = jnp.zeros_like(pdf_sa)
            n_dvcm, n_dvc, n_dvm, mstate2 = mis.advance(
                mstate, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
                first_d_vcm, zw, zw, None if is_bdpt else eta_vcm)

            n_conn_ok = valid & ~cur_delta

            # ---- merge capacity selection (compacted deferred merge).
            # Lanes needing a photon fold beyond the sub-wavefront's
            # capacity DEFER the whole shade to the next full transition:
            # they stay drained in _PH_CLOSEST with the hit record intact,
            # and the recompute is bit-identical because every draw is
            # counter-keyed by (pixel, depth). Steady-state demand is far
            # below capacity; deferral only bites on the refill burst.
            defer = jnp.zeros_like(cl_done)
            if compact_merge:
                m_rank = jnp.cumsum(n_conn_ok.astype(jnp.int32))
                m_sel = n_conn_ok & (m_rank <= mw)
                defer = n_conn_ok & ~m_sel

            # ---- s=0 implicit hit (VCM connectImplicitHit 2389-2446;
            # BDPT deviceCode.cu:1552-1646)
            if cfg.naive:
                is_light = (n_conn_ok & ~defer & (info["light_ind"] >= 0)
                            & ~info["backface"])
                lidx = jnp.maximum(info["light_ind"], 0)
                le = scene.light_emission[lidx].T
                area = scene.light_area[lidx]
                to_prev_u = lm.normalizeT(prev_pt - npos)
                cos_l = lm.dotT(normal, to_prev_u)
                pdf_connect0 = ((1.0 / num_lights)
                                / jnp.maximum(area, 1e-20))
                pdf_connect = jnp.where(prev_delta, 0.0, pdf_connect0)
                if is_bdpt:
                    # t == 2: weigh against the camera trace pdf; deeper
                    # hits use the recursion + firefly clamp on the
                    # CONTRIBUTION (deviceCode.cu:1585-1623)
                    cos_la = jnp.abs(cos_l)
                    cos_cam = jnp.abs(lm.dotT(jnp.broadcast_to(
                        jnp.reshape(camera.forward, (3, 1)),
                        to_prev_u.shape), -to_prev_u))
                    d2n = jnp.maximum(lm.length_sqT(npos - prev_pt),
                                      1e-20)   # deviceCode.cu:1600
                    pdf_trace_cam = cos_la / (
                        d2n * plane_area * cos_cam ** 3)
                    w_eye_first = pdf_connect0 / jnp.maximum(
                        pdf_trace_cam, 1e-20)
                    w_eye_gen = (pdf_connect * n_dvcm
                                 + pdf_connect * (cos_la / PI) * n_dvc)
                    first_t = depth == 0
                    w_eye = jnp.where(first_t, w_eye_first, w_eye_gen)
                    contrib = le * thr
                    lum = lm.luminanceT(contrib)
                    csc = jnp.where(
                        (lum > MAX_FIREFLY_LUM) & ~first_t,
                        MAX_FIREFLY_LUM / jnp.maximum(lum, 1e-20), 1.0)
                    contrib = contrib * csc[None, :]
                    weight = 1.0 / (1.0 + w_eye)
                    out = _weightedT(contrib, weight, cfg)
                else:
                    # NOTE: no eta_vcm term (reference quirk, 2436-2446)
                    w_eye = (pdf_connect * n_dvcm
                             + pdf_connect * (cos_l / PI) * n_dvc)
                    weight = 1.0 / (1.0 + w_eye)
                    out = _weightedT(le * thr, weight, cfg)
                    # directly-visible emission is exempt from the firefly
                    # clamp (deviation from deviceCode.cu:2953, mirrored on
                    # the BDPT t==2 exemption above; see models/vcm.py) —
                    # the unconditional clamp cost 40% of image energy on
                    # diffuse scenes (tools/debug_vcm_split.py)
                    out = jnp.where(depth == 0, out, _clampT(out))
                li = li + jnp.where(is_light[None, :], out, 0.0)

            # ---- photon merge (deviceCode.cu:2968-3048) at this vertex.
            # The fold's per-cell gathers cost ~per-row, so it runs on a
            # COMPACTED sub-wavefront of the <=mw selected lanes instead
            # of masked full width (the selection above guarantees every
            # processed lane fits).
            if cfg.do_merge:
                if compact_merge:
                    # top_k on (w - lane | 0) picks the selected lanes in
                    # ascending lane order, deterministically
                    mkey = jnp.where(
                        m_sel, w - jnp.arange(w, dtype=jnp.int32), 0)
                    mvals, m_idx = jax.lax.top_k(mkey, mw)
                    sub_ok = mvals > 0
                    tk = lambda a: jnp.take(a, m_idx, axis=-1)
                    npos_m, normal_m = tk(npos), tk(normal)
                    prev_dir_m = tk(lm.normalizeT(prev_pt - npos))
                    thr_m = tk(thr)
                    dvcm_m, dvm_m = tk(n_dvcm), tk(n_dvm)
                    albedo_m, trans_m = tk(albedo), tk(trans)
                    mat_m = jax.tree.map(tk, mat)
                    active_m = sub_ok
                else:
                    npos_m, normal_m = npos, normal
                    prev_dir_m = lm.normalizeT(prev_pt - npos)
                    thr_m, dvcm_m, dvm_m = thr, n_dvcm, n_dvm
                    albedo_m, trans_m, mat_m = albedo, trans, mat
                    active_m = n_conn_ok
                eye_prev_loc = lm.to_localT(prev_dir_m, normal_m)
                ones_m = jnp.ones_like(dvcm_m)

                def merge_fold(csum, row, in_range, w_cell):
                    _, p_wi, p_beta, p_d_vcm, p_d_vm = \
                        hashgrid.photon_fields(row)
                    photon_wi = p_wi.T
                    wi_loc = lm.to_localT(photon_wi, normal_m)
                    f_m = bsdf_fT(mat_m, albedo_m, wi_loc, eye_prev_loc,
                                     ones_m, transmission=trans_m)
                    pdf_eye_rev = bsdf_pdfT(mat_m, wi_loc, eye_prev_loc,
                                               ones_m, transmission=trans_m)
                    pdf_light_rev = bsdf_pdfT(mat_m, eye_prev_loc, wi_loc,
                                                 ones_m, transmission=trans_m)
                    w_eye = dvcm_m / jnp.maximum(eta_vcm, 1e-30) \
                        + pdf_eye_rev * dvm_m
                    w_light = p_d_vcm / jnp.maximum(eta_vcm, 1e-30) \
                        + pdf_light_rev * p_d_vm
                    wt = 1.0 / (1.0 + w_eye + w_light)
                    contrib = (p_beta.T * f_m * thr_m
                               * (merge_norm * w_cell)[None, :])
                    out = _weightedT(contrib, wt, cfg)
                    return csum + jnp.where(in_range[None, :], out, 0.0)

                # HBM guard mirroring fold_neighbors' batched-gather cap:
                # neighbor_slots materializes [8, nm, 128] rows_cat plus
                # [8*cap*nm]-lane BSDF intermediates, all linear in the
                # merge sub-wavefront width — fall back to the fold path
                # rather than OOM on very large wavefront configs
                nm_w = npos_m.shape[1]
                use_batch = (_merge_batch_enabled()
                             and 1 <= cfg.max_per_cell <= 8
                             and 8 * nm_w * 2 * 64 * 4 <= (192 << 20))
                if use_batch:
                    # one wide evaluation over all M candidate slots:
                    # flatten [M, mw] -> [M*mw] lanes (slot-major,
                    # matching rows.reshape), run the identical per-slot
                    # math of merge_fold once at full vector width, then
                    # tree-sum over the slot axis. With
                    # TPT_MEGA_MERGE_CAPQ=N (read at trace time) the
                    # candidate stream is compacted per QUERY to its
                    # first N entries (hashgrid.neighbor_slots_compact):
                    # M drops from 8*cap to N, cutting the merge BSDF
                    # work proportionally; the truncated tail lands in
                    # the dropped counter.
                    nm = npos_m.shape[1]
                    cap_q = int(_os.environ.get("TPT_MEGA_MERGE_CAPQ",
                                                "0"))
                    if cap_q > 0:
                        rows_s, ok_s, wgt_s, drop_add = \
                            hashgrid.neighbor_slots_compact(
                                grid, npos_m.T, mr, cfg.max_per_cell,
                                cap_q, active=active_m)
                    else:
                        rows_s, ok_s, wgt_s, drop_add = \
                            hashgrid.neighbor_slots(
                                grid, npos_m.T, mr, cfg.max_per_cell,
                                active=active_m)
                    mslots = rows_s.shape[0]
                    def btn(x):
                        # tile any [..., nm] lane array across the slot
                        # axis -> [..., mslots*nm], slot-major to match
                        # rows_s.reshape
                        shp = x.shape
                        y = jnp.broadcast_to(
                            x[..., None, :], shp[:-1] + (mslots, nm))
                        return y.reshape(shp[:-1] + (mslots * nm,))
                    bt1 = bt3 = btn
                    flat = rows_s.reshape(mslots * nm, rows_s.shape[2])
                    _, p_wi, p_beta, p_d_vcm, p_d_vm = \
                        hashgrid.photon_fields(flat)
                    normal_b = bt3(normal_m)
                    wi_loc = lm.to_localT(p_wi.T, normal_b)
                    eye_prev_b = bt3(eye_prev_loc)
                    mat_b = jax.tree.map(bt1, mat_m)
                    albedo_b, trans_b = bt3(albedo_m), bt1(trans_m)
                    ones_b = jnp.ones((mslots * nm,), albedo_b.dtype)
                    f_m = bsdf_fT(mat_b, albedo_b, wi_loc, eye_prev_b,
                                  ones_b, transmission=trans_b)
                    pdf_eye_rev = bsdf_pdfT(mat_b, wi_loc, eye_prev_b,
                                            ones_b, transmission=trans_b)
                    pdf_light_rev = bsdf_pdfT(mat_b, eye_prev_b, wi_loc,
                                              ones_b,
                                              transmission=trans_b)
                    w_eye = bt1(dvcm_m) / jnp.maximum(eta_vcm, 1e-30) \
                        + pdf_eye_rev * bt1(dvm_m)
                    w_light = p_d_vcm / jnp.maximum(eta_vcm, 1e-30) \
                        + pdf_light_rev * p_d_vm
                    wt = 1.0 / (1.0 + w_eye + w_light)
                    contrib = (p_beta.T * f_m * bt3(thr_m)
                               * (merge_norm
                                  * wgt_s.reshape(mslots * nm))[None, :])
                    out = _weightedT(contrib, wt, cfg)
                    out = jnp.where(ok_s.reshape(mslots * nm)[None, :],
                                    out, 0.0)
                    li_m = jnp.sum(out.reshape(3, mslots, nm), axis=1)
                    if compact_merge:
                        li = li.at[:, m_idx].add(
                            jnp.where(sub_ok[None, :], li_m, 0.0))
                    else:
                        li = li + li_m
                elif compact_merge:
                    li_m, drop_add = hashgrid.fold_neighbors(
                        grid, npos_m.T, mr, cfg.max_per_cell, merge_fold,
                        jnp.zeros_like(npos_m), active=active_m,
                        count_dropped=True)
                    li = li.at[:, m_idx].add(
                        jnp.where(sub_ok[None, :], li_m, 0.0))
                else:
                    li, drop_add = hashgrid.fold_neighbors(
                        grid, npos_m.T, mr, cfg.max_per_cell, merge_fold,
                        li, active=active_m, count_dropped=True)
                dropped = dropped + drop_add

            # ---- stage next-bounce registers
            w_thr = thr * f_val * (jnp.abs(wi_local[2])
                                   / jnp.maximum(pdf_sa, 1e-20))[None, :]
            wi_world = lm.normalizeT(lm.to_worldT(wi_local, normal))
            transmitting = lm.dotT(wi_world, normal) < 0.0
            side = jnp.where(transmitting, -1.0, 1.0)
            n_o = npos + normal * (side * RAY_EPSILON)[None, :]

            keep = valid & (depth + 1 < cfg.eye_depth)
            if cfg.do_sppm and cfg.do_merge:
                keep = keep & cur_delta  # first-surface break (3046)

            # deferred lanes commit NOTHING: they stay drained in
            # _PH_CLOSEST (ts keeps the hit record) and re-shade next time
            up = cl_done & ~defer
            up3 = up[None, :]
            pos = jnp.where(up3, npos, pos)
            cur_tri = jnp.where(up, hit.tri, cur_tri)
            cur_u = jnp.where(up, hit.u, cur_u)
            cur_v = jnp.where(up, hit.v, cur_v)
            conn_ok = jnp.where(up, n_conn_ok, conn_ok)
            d_vcm = jnp.where(up, n_dvcm, d_vcm)
            d_vc = jnp.where(up, n_dvc, d_vc)
            d_vm = jnp.where(up, n_dvm, d_vm)
            mstate = jax.tree.map(
                lambda a2, a1: jnp.where(up, a2, a1), mstate2, mstate)
            alive = jnp.where(up, keep, alive)
            nxt_o = jnp.where(up3, n_o, nxt_o)
            nxt_d = jnp.where(up3, wi_world, nxt_d)
            nxt_thr = jnp.where(up3, w_thr, nxt_thr)
            nxt_pdf_sa = jnp.where(up, pdf_sa, nxt_pdf_sa)
            nxt_cos = jnp.where(up, jnp.abs(wi_local[2]), nxt_cos)
            prev_delta = jnp.where(reached & ~defer, cur_delta, prev_delta)

            # shaded lanes enter the phase chain
            can_shadow = valid & n_conn_ok & ~defer
            if do_nee:
                nee_go = can_shadow
            conn_from_shade = jnp.zeros_like(can_shadow)
            if do_conn:
                conn_from_shade = can_shadow & ~nee_go & (n_conn > 0)
            conn_next = conn_next | conn_from_shade
            nextj = jnp.where(conn_from_shade, 0, nextj)
            # valid lanes with no shadow work commit straight away
            commit = commit | (up & valid & ~nee_go & ~conn_from_shade)
            dead = dead | (cl_done & reached & ~valid)

        # ---- 3. conn launches (both transition kinds) ------------------
        s_cur = s._replace(pos=pos, prev_pt=prev_pt, thr=thr,
                           cur_tri=cur_tri, cur_u=cur_u, cur_v=cur_v,
                           conn_ok=conn_ok, d_vcm=d_vcm, d_vc=d_vc)
        p_c, o_c, d_c, t_c, trace_c = launch_conn(s_cur, conn_next, nextj)

        # ---- 4. NEE launches (FULL only; nee_go nonzero only then) -----
        if full and do_nee:
            p_n, o_n, d_n, t_n, skip_n, trace_n = launch_nee(
                s_cur._replace(depth=depth), nee_go, gpid)
        else:
            p_n = jnp.zeros_like(pending)
            o_n, d_n = s.o, s.d
            t_n = jnp.zeros_like(t_c)
            skip_n = jnp.full_like(s.skip, -1)
            trace_n = jnp.zeros_like(nee_go)

        # ---- 5. commit finished bounces / retire / refill --------------
        go_next = commit & alive
        dead = dead | (commit & ~alive)

        pid = s.pid
        if scatter_ret:
            # compacted scatter-add flush into the chunk-image carry —
            # see unidirectional_mega (RETIRE)
            cap = min(ret_cap, pid.shape[0])
            pendA = s.pend | dead
            rank = jnp.cumsum(pendA.astype(jnp.int32))
            m_sel = pendA & (rank <= cap)
            lane_i = jnp.arange(pid.shape[0], dtype=jnp.int32)
            mkey = jnp.where(m_sel, pid.shape[0] - lane_i, 0)
            mval, m_idx = jax.lax.top_k(mkey, cap)
            sub_ok = mval > 0
            tgt = jnp.where(sub_ok, pid[m_idx], c_pix)
            rows_f = jnp.where(sub_ok[:, None], li[:, m_idx].T, 0.0)
            img = s.img.at[tgt].add(rows_f, mode="drop")
            pend = pendA & ~m_sel
            pid = jnp.where(m_sel, -1, pid)
            acc, ret_pid, ret_count = s.acc, s.ret_pid, s.ret_count
            want = (pid < 0) & (s.next_px < cnt)
        elif window_ret:
            # windowed slot sweep — see unidirectional_mega RETIRE_WIN:
            # one-hot over a [ret_win, W] dynamic-slice based at the
            # lowest retiring ret_count; out-of-window lanes park on
            # pend and flush once the window advances. Bit-identical.
            retire_set = s.pend | dead
            rc = s.ret_count
            k_lo = jnp.min(jnp.where(retire_set, rc, jnp.int32(k_slots)))
            k_lo = jnp.clip(k_lo, 0, max(k_slots - ret_win, 0))
            in_win = retire_set & (rc < k_lo + ret_win)
            rel = rc - k_lo
            kk_ar = jnp.arange(ret_win, dtype=jnp.int32)
            mg = in_win[None, :] & (rel[None, :] == kk_ar[:, None])
            acc_w = jax.lax.dynamic_slice(
                s.acc, (k_lo, 0), (ret_win, s.acc.shape[1]))
            pid_w = jax.lax.dynamic_slice(
                s.ret_pid, (k_lo, 0), (ret_win, s.ret_pid.shape[1]))
            acc_w = jnp.where(mg, packing.pack_rgb9e5_cols(li)[None, :],
                              acc_w)
            pid_w = jnp.where(mg, pid[None, :], pid_w)
            acc = jax.lax.dynamic_update_slice(s.acc, acc_w, (k_lo, 0))
            ret_pid = jax.lax.dynamic_update_slice(s.ret_pid, pid_w,
                                                   (k_lo, 0))
            ret_count = rc + in_win.astype(jnp.int32)
            pid = jnp.where(in_win, -1, pid)
            img, pend = s.img, retire_set & ~in_win
            want = (pid < 0) & (s.next_px < cnt) & (ret_count < k_slots)
        else:
            # fused one-hot packed retirement — see unidirectional_mega
            kk_ar = jnp.arange(k_slots, dtype=jnp.int32)
            mg = dead[None, :] & (s.ret_count[None, :] == kk_ar[:, None])
            acc = jnp.where(mg, packing.pack_rgb9e5_cols(li)[None, :],
                            s.acc)
            ret_pid = jnp.where(mg, pid[None, :], s.ret_pid)
            ret_count = s.ret_count + dead.astype(jnp.int32)
            pid = jnp.where(dead, -1, pid)
            img, pend = s.img, s.pend
            want = (pid < 0) & (s.next_px < cnt) & (ret_count < k_slots)
        rank = jnp.cumsum(want.astype(jnp.int32))
        new_pid = s.next_px + rank - 1
        got = want & (new_pid < cnt)
        next_px = s.next_px + jnp.sum(got.astype(jnp.int32))
        pid = jnp.where(got, new_pid, pid)
        gp = jnp.where(got, new_pid, 0)
        if grid_w:  # arithmetic pixel coords — no frame-table gathers
            gidx = gbase + gp
            gpx_i, gpy_i = gidx % grid_w, gidx // grid_w
        else:
            gpx_i = pxc[gp].astype(jnp.int32)
            gpy_i = pyc[gp].astype(jnp.int32)
        gpixid = rng.pixel_ids(gpx_i, gpy_i)
        go_o, go_d = lm.generate_raysT(camera, cam_key,
                                       gpx_i.astype(jnp.float32),
                                       gpy_i.astype(jnp.float32),
                                       ids=gpixid)
        # fresh eye-endpoint registers (paths.start_eye_walk semantics)
        cos_cam = jnp.abs(lm.dotT(jnp.broadcast_to(
            jnp.reshape(camera.forward, (3, 1)), go_d.shape), go_d))
        pdf0 = 1.0 / (plane_area * cos_cam ** 3)
        g2 = got[None, :]
        li = jnp.where(g2, 0.0, li)
        pending = jnp.where(g2, 0.0, pending)
        thr = jnp.where(g2, 1.0, thr)
        depth = jnp.where(got, 0, depth)
        prev_pdf_sa = jnp.where(got, pdf0, prev_pdf_sa)
        prev_cos = jnp.where(got, cos_cam, prev_cos)
        prev_pt = jnp.where(g2, go_o, prev_pt)
        prev_delta = jnp.where(got, True, prev_delta)
        conn_ok = jnp.where(got, False, conn_ok)
        alive = jnp.where(got, True, alive)
        mstate = jax.tree.map(
            lambda a, z: jnp.where(got, z, a), mstate,
            mis.MisState.zeros(w))
        d_vcm = jnp.where(got, 0.0, d_vcm)
        d_vc = jnp.where(got, 0.0, d_vc)
        d_vm = jnp.where(got, 0.0, d_vm)

        # commit staged registers on lanes advancing to the next bounce
        cm = go_next
        cm3 = cm[None, :]
        thr = jnp.where(cm3, nxt_thr, thr)
        prev_pdf_sa = jnp.where(cm, nxt_pdf_sa, prev_pdf_sa)
        prev_cos = jnp.where(cm, nxt_cos, prev_cos)
        prev_pt = jnp.where(cm3, pos, prev_pt)
        depth = jnp.where(cm, depth + 1, depth)

        # ---- 6. launch ------------------------------------------------
        go_closest = got | go_next
        # phase/pending update on the full masks; the TRAVERSAL only
        # starts where the connection/NEE is actually traceable — other
        # lanes stay drained and fall through at the next transition
        start_any = go_closest | (conn_next & trace_c) | (nee_go & trace_n)
        o2 = jnp.where(nee_go[None, :], o_n,
                       jnp.where(conn_next[None, :], o_c,
                                 jnp.where(got[None, :], go_o, nxt_o)))
        d2 = jnp.where(nee_go[None, :], d_n,
                       jnp.where(conn_next[None, :], d_c,
                                 jnp.where(got[None, :], go_d, nxt_d)))
        t_lim = jnp.where(nee_go, t_n,
                          jnp.where(conn_next, t_c, BIG_T))
        pending = jnp.where(nee_go[None, :], p_n,
                            jnp.where(conn_next[None, :], p_c, pending))
        phase = jnp.where(nee_go, _PH_NEE,
                          jnp.where(conn_next, _PH_CONN,
                                    jnp.where(go_closest, _PH_CLOSEST,
                                              s.phase)))
        conn_j = jnp.where(conn_next, nextj, s.conn_j)
        skip = jnp.where(nee_go, skip_n,
                         jnp.where(start_any, -1, s.skip))

        ts = trav_start(ts, start_any, t_lim)
        ts = ts._replace(flag=jnp.where(drained & ~start_any, -1, ts.flag))
        rays = rays + jnp.sum(start_any.astype(jnp.int32))

        o2 = jnp.where(start_any[None, :], o2, s.o)
        d2 = jnp.where(start_any[None, :], d2, s.d)
        inv_d = jnp.where(start_any[None, :], lm.safe_inv_dirT(d2), s.inv_d)

        return _VState(rays, s.it, s.fires + 1, next_px, ret_count, ts,
                       o2, d2, inv_d,
                       skip, phase, conn_j, pid, depth, li, pending, thr,
                       prev_pdf_sa, prev_cos, prev_pt, prev_delta, pos,
                       cur_tri, cur_u, cur_v, conn_ok, d_vcm, d_vc, d_vm,
                       mstate.d_vcm, mstate.d_vc, mstate.d_vm,
                       mstate.pdf_rev_prev, mstate.prev_was_delta, alive,
                       nxt_o, nxt_d, nxt_thr, nxt_pdf_sa, nxt_cos,
                       ret_pid, acc, dropped, pend, img)

    def cond(s: _VState):
        more_px = (s.next_px < cnt) & jnp.any(s.ret_count < k_slots)
        return (jnp.any(s.pid >= 0) | more_px) & (s.it < 1 << 26)

    def make_body(pxc, pyc, gbase):
        def body(s: _VState):
            msplit = max(1, min(mini_splits, steps_per_iter))
            per_group = max(1, steps_per_iter // msplit)
            for gi in range(msplit):
                ts = s.ts
                for _ in range(per_group):
                    ts = fstep(ts, s.o, s.d, s.inv_d, s.skip,
                               s.phase != _PH_CLOSEST)
                s = s._replace(ts=ts)
                if gi + 1 < msplit:
                    s = transition(s, pxc, pyc, gbase, full=False)
            s = s._replace(it=s.it + 1)
            return transition(s, pxc, pyc, gbase, full=True)
        return body

    return cond, make_body


@partial(jax.jit, static_argnames=("cfg", "width", "chunk_pixels",
                                   "steps_per_iter", "mini_splits",
                                   "debug_counters", "grid_w", "merge_w",
                                   "count_merge_dropped"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, width: int = 0, chunk_pixels: int = 0,
                  steps_per_iter: int = 0, mini_splits: int = 0,
                  debug_counters: bool = False, grid_w: int = 0,
                  merge_w: int = 0, count_merge_dropped: bool = False):
    """One progressive VCM/SPPM sample -> (radiance [P,3], rays).

    Persistent-eye-pass counterpart of models/vcm.render_sample (which
    remains the oracle implementation and the tile-sharded path).

    grid_w: px/py form a raveled row-major grid of this width; the eye
    machine then derives pixel coords arithmetically instead of per-
    transition frame-table gathers (see unidirectional_mega).

    merge_w: photon-merge sub-wavefront capacity (lanes folded per FULL
    transition). 0 = auto (W/4); >= width disables compaction (legacy
    full-width masked fold). Pure scheduling knob — the image is
    invariant to it (tests/test_vcm_mega.py)."""
    steps_per_iter = steps_per_iter or STEPS_PER_ITER
    mini_splits = mini_splits or MINI_SPLITS
    p_total = px.shape[0]
    # default: ONE machine per frame (a chunk pays its own drain tail —
    # see unidirectional_mega), except the conn-table/photon-grid memory
    # bounds the chunk at very large frames (rows ~ L*c_pix*32 floats)
    c_pix0 = min(chunk_pixels or max(p_total // max(
        1, -(-p_total // (1 << 20))), 1), p_total)
    w = min(width or MEGA_WIDTH, c_pix0)
    gens = -(-c_pix0 // w)
    c_pix = gens * w
    n_chunks = -(-p_total // c_pix)
    from cudapathtracer_tpu.models.unidirectional_mega import RETIRE
    _scatter_ret = RETIRE == "scatter"
    k_slots = 1 if _scatter_ret else int(gens * KSLOTS_FACTOR) + 8

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

    # progressive merge radius (util.cuh:415-418, deviceCode.cu:3328)
    r0 = scene.scene_radius * cfg.r0_multiplier
    mr = merge_radius(r0, jnp.asarray(sample_idx, jnp.float32),
                      cfg.merge_alpha)

    fb0 = jnp.zeros((n_chunks * c_pix, 3), jnp.float32)

    def chunk_body(carry, ci):
        fb_full, rays_tot, its, fires, drops = carry
        if grid_w:
            # once-per-chunk arrays (light-path pairing ids); the eye
            # machine itself never gathers them — coords are arithmetic.
            # Clamp pad slots to the LAST pixel: identical RNG ids (and
            # identical pad light-walk ray counts) to the repeated-pixel
            # padding of the gather path — keeps grid_w bit-exact.
            gidx = jnp.minimum(
                ci * c_pix + jnp.arange(c_pix, dtype=jnp.int32),
                p_total - 1)
            pxc, pyc = gidx % grid_w, gidx // grid_w
        else:
            pxc = jax.lax.dynamic_slice_in_dim(pxi, ci * c_pix, c_pix)
            pyc = jax.lax.dynamic_slice_in_dim(pyi, ci * c_pix, c_pix)
        pid_g = rng.pixel_ids(pxc, pyc)
        # true (unpadded) path/pixel count of this chunk
        cnt = jnp.minimum(p_total - ci * c_pix, c_pix)
        lane_ok = jnp.arange(c_pix, dtype=jnp.int32) < cnt
        eta_vcm = cnt.astype(jnp.float32) * PI * mr * mr
        merge_norm = 1.0 / (PI * mr * mr
                            * jnp.maximum(cnt.astype(jnp.float32), 1.0))

        # ---- light pass for this chunk's paired light paths ----
        # The classic depth-scan walk is the default. The persistent light
        # machine
        # (models/light_mega.py — same draw streams, per-vertex-equal output)
        # was built to kill per-bounce lockstep waste, but on the previous
        # accelerator it lost at this exact shape: the scan's compacted
        # traversal already amortizes well and the machine's per-transition
        # vertex scatter + drain windows cost more than the dead-lane shading
        # they remove. TPT_MEGA_LIGHT=1 selects the machine (kept tested — it
        # may win on scenes with wildly varying light-path lengths).
        if _os.environ.get("TPT_MEGA_LIGHT"):
            from cudapathtracer_tpu.models import light_mega
            lbufs, lrays = light_mega.light_walk_mega(
                scene, key_l, c_pix, cfg.light_depth + 1, 1,
                eta_vcm=eta_vcm,
                pxc=None if grid_w else pxc, pyc=None if grid_w else pyc,
                width=w, steps_per_iter=steps_per_iter,
                mini_splits=mini_splits, grid_w=grid_w,
                gbase=ci * c_pix, gmax=p_total - 1)
        else:
            start, _lv0 = paths.start_light_walk(scene, key_l, c_pix,
                                                 ids=pid_g)
            first_vm_seed = start.first_vc_scale / jnp.maximum(
                eta_vcm, 1e-30)
            lbufs, _lesc, lrays = paths.random_walk(
                scene, key_l, start, cfg.light_depth + 1, 1,
                eta_vcm=eta_vcm, first_vm_seed=first_vm_seed, ids=pid_g)
        # mask padded lanes' paths out of every consumer
        lbufs = lbufs._replace(valid=lbufs.valid & lane_ok[None, :])
        lpath_len = jnp.sum(lbufs.valid.astype(jnp.int32), axis=0)

        fb = jnp.zeros_like(fb_full)
        rays_s = jnp.int32(0)
        if cfg.light_trace:
            fb, rays_s = vcm_light_splat(scene, camera, lbufs, cfg,
                                         eta_vcm, fb)
        fb_full = fb_full + fb

        grid = None
        if cfg.do_merge:
            pmask = (lbufs.valid & ~lbufs.is_delta).reshape(-1)
            flat = lambda a: a.reshape((-1,) + a.shape[2:])
            rows = hashgrid.pack_photons(flat(lbufs.pt), flat(lbufs.wo),
                                         flat(lbufs.beta),
                                         flat(lbufs.d_vcm),
                                         flat(lbufs.d_vm))
            table = hashgrid.photon_table_size(rows.shape[0])
            salt = (jnp.asarray(sample_idx, jnp.uint32)
                    * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
            grid = hashgrid.build_grid(rows, pmask,
                                       scene.node_bounds[0, 0:3], mr,
                                       table, salt=salt)

        conn_table = _pack_conn_table(lbufs)

        # ---- persistent eye machine ----
        cond, make_body = _mk_eye_machine(
            scene, camera, cfg, key_e, cam_key, w, gens, k_slots, cnt,
            eta_vcm, mr, merge_norm, grid, conn_table, lpath_len,
            steps_per_iter, mini_splits, grid_w=grid_w, merge_w=merge_w)

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
        return ((fb_full, rays_tot, its + out.it, fires + out.fires,
                 drops + out.dropped), chunk_img)

    carry0 = (fb0, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0))
    (fb_full, rays, its, fires, drops), accs = jax.lax.scan(
        chunk_body, carry0, jnp.arange(n_chunks, dtype=jnp.int32))
    li = accs.reshape(-1, 3)[:p_total] + fb_full[:p_total]
    if debug_counters:
        return li, rays, its, fires
    if count_merge_dropped:
        return li, rays, drops
    return li, rays
