"""BVH8 wavefront traversal with a vectorized per-lane stack — LANE-MAJOR.

Companion engine to ops/traverse.py (threaded binary): each while-loop step
pops ONE entry per lane, gathers ONE unified HYBRID row (scene/bvh8.py
CBVH layout: sibling rows contiguous, child = base + slot) and runs BOTH
stages on it: slab-test the (up to 8) children at once — a single packed
int key per child is distance-sorted with an odd-even network; the nearest
is entered directly, the rest pushed far->near — and Möller-Trumbore-test
the row's (up to leaf_tris) INLINE triangles. Small subtrees live inline
in their parent's row (emission-time knapsack, scene/bvh8.py), so most
leaf visits cost zero extra steps; a pure leaf row is just a row with no
children. There is no leaf bit: every traversal entry is a plain row id.

LAYOUT: the wavefront axis N is the MINOR axis of every multi-row array
(stack [D,N], gathered row transposed to [64,N], ray components as
separate [N] rows). On the previous accelerator the row-major
[N,8]/[N,4]/[N,28] formulation wasted most of every vector register on
lane padding, and the row gather itself was nearly free next to the
elementwise work around it. The GPU's costs differ; the layout has not
been re-measured there (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops.intersect import (BIG_T, DET_EPS,
                                              safe_inv_dir)
from cudapathtracer_tpu.ops.traverse import (Hit, _compacted_while, _i32,
                                             LEAF_MAT_FLAG)

# Stack depth: with descend-direct traversal (the nearest hit child is
# entered immediately instead of being pushed) the worst-case occupancy
# seen on 82k-tri torture rays is 19. Correctness does NOT depend on
# the constant: an overflowing push marks the lane `lost` and, once its
# stack drains, the lane RESTARTS from the root with its tightened t_best
# (closest-hit) / accumulated scale (shadow), up to MAX_RESTARTS times —
# after which remaining losses would be silent (never observed; each restart
# prunes far harder than the last). The [D,N] stack rides every pop/push
# shift, so depth is memory traffic, traded against restarts, which blow
# up below ~14 entries. D=16 was the optimum of a 1080p sweep on the
# previous accelerator (one-hot top-pointer stacks were no better than
# shifts there); it is not yet re-swept on the GPU (ROADMAP Queue 1
# item 5). Images are bit-identical across D.
STACK_D = int(_os.environ.get("TPT_STACK_D", "16"))
MAX_RESTARTS = 3

# Stack ELEMENT dtype. A u16 variant exists (row ids fit 16 bits for
# tables under 65535 rows; entries stored BIASED by +1 so zeros = empty)
# on the theory that halving the [D,N] stack's bytes halves its
# pop/push shift traffic. Rejected as the default on the previous
# accelerator, where 16-bit lanes needed extra pack/convert work that
# outweighed the bytes. TPT_STACK_U16=1 opts in (kept: the GPU, wider
# machines or deeper stacks may tip the balance).
_WANT_U16 = _os.environ.get("TPT_STACK_U16", "0") not in ("0", "")


def stack_dtype(scene) -> jnp.dtype:
    """Per-scene stack element dtype (i32 default; u16 biased opt-in)."""
    if _WANT_U16 and scene.bvh8_table.shape[0] < 65535:
        return jnp.uint16
    return jnp.int32

# Batcher odd-even merge sort network for 8 elements (19 comparators)
_SORT8 = [(0, 1), (2, 3), (4, 5), (6, 7),
          (0, 2), (1, 3), (4, 6), (5, 7),
          (1, 2), (5, 6),
          (0, 4), (1, 5), (2, 6), (3, 7),
          (2, 4), (3, 5),
          (1, 2), (3, 4), (5, 6)]

_KEY_INVALID = 0x7FFFFFFF  # sorts last ascending; unreachable by real keys

# lax.sort over the [8,N] slot axis vs the hand-rolled 19-comparator
# odd-even network (identical ascending int results). Read at trace time.
_SORT_LAX = _os.environ.get("TPT_SORT_LAX", "0") not in ("0", "")


def _pop(stack, top, want):
    """Pop the top entry on `want` lanes. Returns (entry [N], stack, top).

    Top-at-ROW-0 discipline: the popped value is a free row slice and the
    shift is a contiguous masked copy of full-lane rows. Unlike a pointer
    bump, the shift MUTATES the stack, so the caller must pass the true pop
    condition — lanes that keep their descend-direct entry must not
    shift. Entries are stored BIASED by +1 (see stack_dtype): an empty
    row (0) pops to -1."""
    has = want & (top > 0)
    entry = jnp.where(has, stack[0].astype(jnp.int32) - 1, -1)
    shifted = jnp.concatenate([stack[1:], stack[:1]], axis=0)
    stack = jnp.where(has[None, :], shifted, stack)
    return entry, stack, jnp.where(has, top - 1, top)


def _sort8_keys(ks):
    """Odd-even network sort of 8 packed int32 [N] keys, ASCENDING — one
    min/max pair per comparator (the CBVH layout lets metas be
    reconstructed arithmetically after the sort, so only the key array is
    permuted)."""
    ks = list(ks)
    for a, b in _SORT8:
        lo = jnp.minimum(ks[a], ks[b])
        hi = jnp.maximum(ks[a], ks[b])
        ks[a], ks[b] = lo, hi
    return ks


def _node_stage(rowT, oT, inv_dT, t_cut, active):
    """Ordered CBVH child stage on the transposed row: slab-test all 8
    child slots ([3,8,N] math — full lanes), sort a single packed key
    (tmin bits | slot) per slot, reconstruct child rows as
    child_base + slot. Empty/absorbed slots carry +inf degenerate boxes
    and never hit. Returns (direct — nearest hit child row or -1;
    deferred — 7 near-first deferred [N] entries; count [N])."""
    n = rowT.shape[1]
    b = rowT[0:48].reshape(6, 8, n)
    t1 = (b[0:3] - oT[:, None, :]) * inv_dT[:, None, :]   # [3,8,N]
    t2 = (b[3:6] - oT[:, None, :]) * inv_dT[:, None, :]
    tmin8 = jnp.max(jnp.minimum(t1, t2), axis=0)          # [8,N]
    tmax8 = jnp.min(jnp.maximum(t1, t2), axis=0)
    hit8 = (tmax8 >= tmin8) & (tmax8 > 0.0) & (tmin8 < t_cut[None, :])

    base = _i32(rowT[48])                                 # [N]
    slots = jnp.arange(8, dtype=jnp.int32)[:, None]       # [8,1]
    # IEEE total-order trick: int bits sort like the float once negative
    # patterns have their low 31 bits flipped — NEGATIVE tmins (boxes
    # straddling the origin, common for secondary rays) must keep their
    # true order: clamping them to 0 measured +20% lockstep iterations.
    # The low 3 bits are recycled for the slot — ties within an 8-ulp
    # bucket break arbitrarily, which only affects visit order.
    tb = jax.lax.bitcast_convert_type(tmin8, jnp.int32)
    tb = jnp.where(tb >= 0, tb, tb ^ jnp.int32(0x7FFFFFFF))
    key = (tb & jnp.int32(~7)) | slots                    # [8,N]
    live = active[None, :] & hit8
    key = jnp.where(live, key, jnp.int32(_KEY_INVALID))
    if _SORT_LAX:
        ks = jnp.sort(key, axis=0)                        # [8,N] one HLO
    else:
        ks = jnp.stack(_sort8_keys([key[i] for i in range(8)]))  # [8,N]
    # tensorized meta reconstruction (round 5: the step is op-COUNT bound
    # at the production width, so per-slot python loops became [8,N] ops)
    g = ks != _KEY_INVALID
    metas = jnp.where(g, base[None, :] + (ks & 7), -1)    # [8,N]
    count = jnp.sum(g[1:].astype(jnp.int32), axis=0)
    return metas[0], metas[1:], count


def _push_block(stack, top, deferred, count):
    """Push `count[n]` of the (up to 7) NEAR-FIRST `deferred` [7,N] entries
    per lane in one block: shift the stack down by count via three masked
    power-of-two row shifts, then write the new entries into FIXED rows
    0..count-1 — contiguous full-lane copies and row writes only. Overflow
    drops the DEEPEST entries (shifted off the end) and flags `lost`;
    callers restart those lanes from the root."""
    d_rows = stack.shape[0]
    dt = stack.dtype
    for bit in (4, 2, 1):
        m = (count & bit) != 0
        shifted = jnp.concatenate([stack[:bit], stack[:-bit]], axis=0)
        stack = jnp.where(m[None, :], shifted, stack)
    # entries stored biased by +1 in the stack's (possibly u16) dtype;
    # one [7,N] select instead of 7 per-row ops (round-5 tensorization)
    sl = jnp.arange(7, dtype=count.dtype)[:, None]
    head = jnp.where(sl < count[None, :], (deferred + 1).astype(dt),
                     stack[:7])
    stack = jnp.concatenate([head, stack[7:]], axis=0)
    new_top = top + count
    lost = new_top > d_rows
    return stack, jnp.minimum(new_top, d_rows), lost


_TRI_OFF = 50  # scene/bvh8.py TRI_OFF: inline triangles start here


def _leaf_tris(rowT, oT, dT, t_cut, skip_tri, active, lt):
    """Batched Möller-Trumbore over the row's `lt` INLINE triangles in ONE
    [lt,N] tensor pass (round 5: the per-slot python-loop form emitted
    ~30 HLO ops PER SLOT and the step is op-count bound at the production
    width; the [lt,N] form keeps the lane dimension minor, so there is no
    minor-dim padding — unlike the rejected [N,lt,3] layout).
    Runs on every row (hybrid layout): pure inner rows carry -1 ids.

    Returns (tt, uu, vv, ok, tid, raw), each [lt,N]."""
    raw = _i32(rowT[_TRI_OFF + 9 * lt:_TRI_OFF + 10 * lt])  # [lt,N]
    n = rowT.shape[1]
    tri = rowT[_TRI_OFF:_TRI_OFF + 9 * lt].reshape(lt, 9, n)
    tid = jnp.where(raw < 0, -1, raw & ~LEAF_MAT_FLAG)      # [lt,N]
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]         # [lt,N]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    ox, oy, oz = oT[0], oT[1], oT[2]                        # [N] broadcast
    dx, dy, dz = dT[0], dT[1], dT[2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = hx * e1x + hy * e1y + hz * e1z
    ok_det = jnp.abs(a) >= DET_EPS
    f = 1.0 / jnp.where(ok_det, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & active[None, :] & (tid >= 0) & (t < t_cut[None, :])
          & (tid != skip_tri[None, :]))
    return t, u, v, ok, tid, raw


def _leaf_closest(tt, uu, vv, ok, tid, t_best, tri, u, v):
    """Fold the row's best triangle hit into (t_best, tri, u, v) via a
    packed-key min over the [lt,N] slot axis (slot index in the low
    mantissa bits — unique winner, so a masked sum extracts the winning
    slot's values exactly). Exact t ties resolve to the first slot like
    the sequential reference loop."""
    lt = tt.shape[0]
    mask_bits = jnp.int32(~3) if lt <= 4 else jnp.int32(~15)
    sl = jnp.arange(lt, dtype=jnp.int32)[:, None]
    tb = jax.lax.bitcast_convert_type(jnp.maximum(tt, 0.0), jnp.int32)
    keys = jnp.where(ok, (tb & mask_bits) | sl, jnp.int32(_KEY_INVALID))
    kmin = jnp.min(keys, axis=0)
    hit = kmin != _KEY_INVALID
    sel = keys == kmin[None, :]   # exactly one True per hit column
    pick = lambda a: jnp.sum(jnp.where(sel, a, a.dtype.type(0)), axis=0)
    nt = jnp.where(hit, pick(tt), t_best)
    ntri = jnp.where(hit, pick(tid), tri)
    nu = jnp.where(hit, pick(uu), u)
    nv = jnp.where(hit, pick(vv), v)
    return nt, ntri, nu, nv


def _leaf_shadow(scene, with_leaf, dT, uu, vv, ok, tid, raw, scale, blocked):
    """Fold the row's triangle occlusions into (scale [3,N], blocked [N]) —
    per-slot full-lane math. MAT_LEAF transmissions multiply commutatively;
    the darkness early-out (<0.01) is applied after the row's full product
    (BVHShadowRay applies it per hit in traversal order — same fixpoint,
    the running scale only ever shrinks)."""
    lt = ok.shape[0]
    if with_leaf:
        factor = [jnp.ones_like(scale[0]) for _ in range(3)]
        opaque = jnp.zeros_like(blocked)
        any_leaf = jnp.zeros_like(blocked)
        for j in range(lt):
            okj = ok[j] & ~blocked
            is_leaf_mat = (raw[j] >= 0) & ((raw[j] & LEAF_MAT_FLAG) != 0)
            srowT = scene.tri_shadow[jnp.maximum(tid[j], 0)].T   # [16,N]
            w0 = 1.0 - uu[j] - vv[j]
            nx = srowT[0] * w0 + srowT[3] * uu[j] + srowT[6] * vv[j]
            ny = srowT[1] * w0 + srowT[4] * uu[j] + srowT[7] * vv[j]
            nz = srowT[2] * w0 + srowT[5] * uu[j] + srowT[8] * vv[j]
            inv_len = jax.lax.rsqrt(
                jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
            cos_t = jnp.abs(dT[0] * nx + dT[1] * ny + dT[2] * nz) * inv_len
            ior = srowT[13]
            r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
            fres = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
            pass_leaf = okj & is_leaf_mat
            tmul = srowT[12] * (1.0 - fres)
            for c in range(3):
                factor[c] = factor[c] * jnp.where(pass_leaf,
                                                  srowT[9 + c] * tmul, 1.0)
            opaque = opaque | (okj & ~is_leaf_mat)
            any_leaf = any_leaf | pass_leaf
        scale = scale * jnp.stack(factor, axis=0)
        dark = jnp.max(scale, axis=0) < 0.01
        blocked = blocked | opaque | (any_leaf & dark)
    else:
        blocked = blocked | jnp.any(ok, axis=0)
    scale = jnp.where(blocked[None, :], 0.0, scale)
    return scale, blocked


def closest_hit8(scene, o, d, max_t=None, skip_tri=None, active=None) -> Hit:
    """BVH8 closest-hit traversal; drop-in for traverse.closest_hit."""
    n = o.shape[0]
    if max_t is None:
        max_t = jnp.full((n,), BIG_T, jnp.float32)
    else:
        max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (n,))
    if skip_tri is None:
        skip_tri = jnp.full((n,), -1, jnp.int32)
    oT, dT, inv_dT = o.T, d.T, safe_inv_dir(d).T
    table = scene.bvh8_table
    lt = getattr(scene, 'bvh8_leaf_tris', 4)

    # descend-direct: `direct` holds the next entry to process without
    # touching the stack; the stack only holds deferred siblings
    direct0 = jnp.zeros((n,), jnp.int32)  # root row = 0
    if active is not None:
        direct0 = jnp.where(active, direct0, -1)
    top0 = jnp.zeros((n,), jnp.int32)
    stack0 = jnp.zeros((STACK_D, n), stack_dtype(scene))

    def step(flag, direct, stack, top, lostc, t_best, tri, u, v, oT, dT,
             inv_dT, skip_tri):
        use_direct = direct >= 0
        popped, stack, top = _pop(stack, top, ~use_direct)
        entry = jnp.where(use_direct, direct, popped)

        valid = entry >= 0
        rowid = jnp.maximum(entry, 0)
        rowT = table[rowid].T   # THE gather, transposed to [W,N]

        # ---- child stage: packed-key sort, descend nearest,
        # push deferred siblings far->near
        new_direct, deferred, kpush = _node_stage(rowT, oT, inv_dT, t_best,
                                                  valid)
        stack, top, lost = _push_block(stack, top, deferred, kpush)
        # encode pending loss in lostc's low bit; restarts in higher bits
        lostc = jnp.where(lost, lostc | 1, lostc)

        # ---- inline-triangle stage: per-slot full-lane tests
        tt, uu, vv, ok, tid, _raw = _leaf_tris(rowT, oT, dT, t_best,
                                               skip_tri, valid, lt)
        t_best, tri, u, v = _leaf_closest(tt, uu, vv, ok, tid,
                                          t_best, tri, u, v)

        direct = new_direct
        # drained with a pending loss -> restart from the root (t_best kept,
        # so the retraversal prunes hard); bounded by MAX_RESTARTS
        drained = (direct < 0) & (top <= 0)
        restarts = lostc >> 1
        redo = drained & ((lostc & 1) == 1) & (restarts < MAX_RESTARTS)
        direct = jnp.where(redo, 0, direct)
        lostc = jnp.where(redo, (restarts + 1) << 1, lostc)
        flag = jnp.where((direct >= 0) | (top > 0), 1, -1).astype(jnp.int32)
        return (flag, direct, stack, top, lostc, t_best, tri, u, v, oT, dT,
                inv_dT, skip_tri)

    init = (jnp.where(direct0 >= 0, 1, -1).astype(jnp.int32), direct0,
            stack0, top0, jnp.zeros((n,), jnp.int32),
            max_t, jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32),
            oT, dT, inv_dT, skip_tri)
    out = _compacted_while(step, init, n)
    return Hit(t=out[5], tri=out[6], u=out[7], v=out[8])


def shadow_factor8(scene, o, d, max_t, skip_tri=None, active=None):
    """BVH8 any-hit shadow traversal with MAT_LEAF transmission; drop-in for
    traverse.shadow_factor. Returns scale [N,3]."""
    n = o.shape[0]
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (n,))
    if skip_tri is None:
        skip_tri = jnp.full((n,), -1, jnp.int32)
    oT, dT, inv_dT = o.T, d.T, safe_inv_dir(d).T
    table = scene.bvh8_table
    lt = getattr(scene, 'bvh8_leaf_tris', 4)
    with_leaf = scene.has_leaf_materials

    direct0 = jnp.zeros((n,), jnp.int32)
    if active is not None:
        direct0 = jnp.where(active, direct0, -1)
    top0 = jnp.zeros((n,), jnp.int32)
    stack0 = jnp.zeros((STACK_D, n), stack_dtype(scene))

    def step(flag, direct, stack, top, lostc, scale, oT, dT, inv_dT, max_t,
             skip_tri):
        use_direct = direct >= 0
        popped, stack, top = _pop(stack, top, ~use_direct)
        entry = jnp.where(use_direct, direct, popped)

        valid = entry >= 0
        rowid = jnp.maximum(entry, 0)
        rowT = table[rowid].T

        # ordered stage for any-hit too: the sort is ~38 cheap wide ops
        # and the block push requires the near-first prefix order
        new_direct, deferred, kpush = _node_stage(rowT, oT, inv_dT, max_t,
                                                  valid)
        stack, top, lost = _push_block(stack, top, deferred, kpush)
        lostc = jnp.where(lost, lostc | 1, lostc)

        tt, uu, vv, ok, tid, raw = _leaf_tris(rowT, oT, dT, max_t, skip_tri,
                                              valid, lt)
        blocked = jnp.zeros_like(entry, dtype=bool)
        scale, blocked = _leaf_shadow(scene, with_leaf, dT, uu, vv, ok,
                                      tid, raw, scale, blocked)

        direct = new_direct
        top = jnp.where(blocked, 0, top)
        direct = jnp.where(blocked, -1, direct)
        lostc = jnp.where(blocked, 0, lostc)  # occlusion is final
        # restart lost, unblocked lanes from the root with scale reset to 1
        # (leaf transmission re-accumulates from scratch — idempotent)
        drained = (direct < 0) & (top <= 0)
        restarts = lostc >> 1
        redo = drained & ((lostc & 1) == 1) & (restarts < MAX_RESTARTS)
        direct = jnp.where(redo, 0, direct)
        scale = jnp.where(redo[None, :], 1.0, scale)
        lostc = jnp.where(redo, (restarts + 1) << 1, lostc)
        flag = jnp.where((direct >= 0) | (top > 0), 1, -1).astype(jnp.int32)
        return (flag, direct, stack, top, lostc, scale, oT, dT, inv_dT,
                max_t, skip_tri)

    init = (jnp.where(direct0 >= 0, 1, -1).astype(jnp.int32), direct0,
            stack0, top0, jnp.zeros((n,), jnp.int32),
            jnp.ones((3, n), jnp.float32), oT, dT, inv_dT, max_t, skip_tri)
    out = _compacted_while(step, init, n)
    return out[5].T


class TravState(NamedTuple):
    """Per-lane mixed-mode traversal registers (make_fused_step). flag < 0
    means the lane's traversal is drained (or was never started)."""
    flag: jax.Array     # [N] i32: 1 in flight, -1 drained/idle
    direct: jax.Array   # [N] i32 next entry (descend-direct), -1 none
    stack: jax.Array    # [STACK_D, N] i32 (lane-major)
    top: jax.Array      # [N] i32
    lostc: jax.Array    # [N] i32 pending-loss bit + restart count
    t_cut: jax.Array    # [N] closest: running t_best; shadow: max_t
    tri: jax.Array      # [N] i32 best hit (closest lanes)
    u: jax.Array        # [N]
    v: jax.Array        # [N]
    scale: jax.Array    # [3,N] shadow transmission product (lane-major)


def trav_idle(n, stack_dt=jnp.int32) -> TravState:
    """Idle traversal registers (flag=-1 everywhere). stack_dt: pass
    stack_dtype(scene) to opt into the u16 biased stack (the machine
    keeps whatever dtype the stack was created with)."""
    z = jnp.zeros((n,), jnp.float32)
    return TravState(
        flag=jnp.full((n,), -1, jnp.int32),
        direct=jnp.full((n,), -1, jnp.int32),
        stack=jnp.zeros((STACK_D, n), stack_dt),
        top=jnp.zeros((n,), jnp.int32),
        lostc=jnp.zeros((n,), jnp.int32),
        t_cut=jnp.full((n,), BIG_T, jnp.float32),
        tri=jnp.full((n,), -1, jnp.int32),
        u=z, v=z,
        scale=jnp.ones((3, n), jnp.float32))


def trav_start(ts: TravState, mask, t_lim) -> TravState:
    """(Re)start traversal from the root on `mask` lanes with fresh
    registers; t_lim is the initial t_best (closest) / max_t (shadow)."""
    sel = lambda a, b: jnp.where(mask, a, b)
    return TravState(
        flag=sel(1, ts.flag).astype(jnp.int32),
        direct=sel(0, ts.direct).astype(jnp.int32),
        stack=ts.stack,
        top=sel(0, ts.top).astype(jnp.int32),
        lostc=sel(0, ts.lostc).astype(jnp.int32),
        t_cut=sel(t_lim, ts.t_cut),
        tri=sel(-1, ts.tri).astype(jnp.int32),
        u=sel(0.0, ts.u), v=sel(0.0, ts.v),
        scale=jnp.where(mask[None, :], 1.0, ts.scale))


def make_fused_step(scene):
    """Build the one-node-step transition for mixed closest/shadow lanes.

    Returns step(ts, o, d, inv_d, skip_tri, is_shadow) -> TravState with
    o/d/inv_d as [N,3] (transposed internally once per call). Lanes with
    ts.flag < 0 are no-ops (they still ride the lockstep ops). The
    mega-wavefront integrator embeds this step directly in its path loop;
    trace_fused8 wraps it with the straggler-compacted while."""
    table = scene.bvh8_table
    lt = getattr(scene, 'bvh8_leaf_tris', 4)
    with_leaf = scene.has_leaf_materials

    def step(ts: TravState, o, d, inv_d, skip_tri, is_shadow) -> TravState:
        oT, dT, inv_dT = o.T, d.T, inv_d.T
        return step_t(ts, oT, dT, inv_dT, skip_tri, is_shadow)

    def step_t(ts: TravState, oT, dT, inv_dT, skip_tri,
               is_shadow) -> TravState:
        """Lane-major variant: oT/dT/inv_dT are [3,N] (callers that keep
        their ray registers lane-major skip the per-step transposes)."""
        (flag, direct, stack, top, lostc, t_cut, tri, u, v, scale) = ts
        use_direct = direct >= 0
        popped, stack, top = _pop(stack, top, ~use_direct)
        entry = jnp.where(use_direct, direct, popped)

        valid = entry >= 0
        rowid = jnp.maximum(entry, 0)
        # THE gather [N,W] -> [W,N]. Alternatives that were neutral on the
        # previous accelerator: a pre-transposed [W,R] table gathered along
        # axis 1, and an optimization_barrier forcing one materialization.
        rowT = table[rowid].T

        # ---- child stage: closest lanes benefit from the near-first
        # descent order; shadow lanes ride along (order-agnostic)
        new_direct, deferred, kpush = _node_stage(rowT, oT, inv_dT, t_cut,
                                                  valid)
        stack, top, lost = _push_block(stack, top, deferred, kpush)
        lostc = jnp.where(lost, lostc | 1, lostc)

        # ---- inline triangles: one [lt,N] tensor pass, mode-split
        tt, uu, vv, ok, tid, raw = _leaf_tris(rowT, oT, dT, t_cut, skip_tri,
                                              valid, lt)
        t_cut, tri, u, v = _leaf_closest(tt, uu, vv, ok & ~is_shadow[None, :],
                                         tid, t_cut, tri, u, v)
        blocked = jnp.zeros_like(entry, dtype=bool)
        scale, blocked = _leaf_shadow(scene, with_leaf, dT, uu, vv,
                                      ok & is_shadow[None, :],
                                      tid, raw, scale, blocked)

        direct = new_direct
        top = jnp.where(blocked, 0, top)
        direct = jnp.where(blocked, -1, direct)
        lostc = jnp.where(blocked, 0, lostc)  # occlusion is final
        # restart lost lanes from the root: closest keeps its tightened
        # t_cut; shadow resets scale to 1 (re-accumulates — idempotent)
        drained = (direct < 0) & (top <= 0)
        restarts = lostc >> 1
        redo = drained & ((lostc & 1) == 1) & (restarts < MAX_RESTARTS)
        direct = jnp.where(redo, 0, direct)
        scale = jnp.where((redo & is_shadow)[None, :], 1.0, scale)
        lostc = jnp.where(redo, (restarts + 1) << 1, lostc)
        flag = jnp.where((direct >= 0) | (top > 0), 1, -1).astype(jnp.int32)
        return TravState(flag, direct, stack, top, lostc, t_cut, tri, u, v,
                         scale)

    step.lane_major = step_t
    return step


def trace_fused8(scene, o, d, t_lim, is_shadow, skip_tri=None, active=None):
    """Mixed-mode traversal: closest-hit lanes and any-hit shadow lanes in
    ONE wavefront loop.

    Per lane, `is_shadow` selects semantics:
      False — closest-hit: t_lim is the initial t_best; returns Hit fields.
      True  — any-hit with MAT_LEAF transmission (BVHShadowRay,
              integratorUtilities.cuh:188-288): t_lim is max_t; returns
              `scale` (1 clear / 0 occluded / transmission product).

    Returns (Hit, scale [N,3]) — Hit rows meaningful on closest lanes,
    scale rows on shadow lanes.
    """
    n = o.shape[0]
    t_lim = jnp.broadcast_to(jnp.asarray(t_lim, jnp.float32), (n,))
    if skip_tri is None:
        skip_tri = jnp.full((n,), -1, jnp.int32)
    oT, dT, inv_dT = o.T, d.T, safe_inv_dir(d).T
    fstep = make_fused_step(scene).lane_major

    act = jnp.ones((n,), bool) if active is None else active
    ts0 = trav_start(trav_idle(n, stack_dtype(scene)), act, t_lim)

    def step(flag, direct, stack, top, lostc, t_cut, tri, u, v, scale,
             oT, dT, inv_dT, skip_tri, is_shadow):
        ts = TravState(flag, direct, stack, top, lostc, t_cut, tri, u, v,
                       scale)
        ts = fstep(ts, oT, dT, inv_dT, skip_tri, is_shadow)
        return (*ts, oT, dT, inv_dT, skip_tri, is_shadow)

    init = (*ts0, oT, dT, inv_dT, skip_tri, is_shadow)
    out = _compacted_while(step, init, n)
    return Hit(t=out[5], tri=out[6], u=out[7], v=out[8]), out[9].T
