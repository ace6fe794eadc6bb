"""Shared integrator machinery: light sampling, NEE pdf, sky, medium stack.

Wavefront (batched [N]) equivalents of the helpers every reference integrator
leans on: nextEventEstimation/neePDF (deviceCode.cu:63-156), sampleSky
(integratorUtilities.cuh:436-461, disabled upstream — gated by a flag here),
and the priority-based nested-dielectric medium stack
(deviceCode.cu:306-432, integratorUtilities.cuh:414-434) vectorized as a
[N, S] int32 array + top counter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops import bsdf as bsdf_ops
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import EPSILON, dot, length_sq, normalize

MEDIUM_STACK_SIZE = 16  # deviceCode.cu:305
AIR_INDEX = 0           # material 0 is always air (main.cu:448)


# ---------------------------------------------------------------------------
# Bounce-level straggler compaction (shared by the classic wavefront
# integrators; the persistent mega engines have their own slot machinery)
# ---------------------------------------------------------------------------

def compacted_loop(cond, body, init, n: int, min_width: int, frac: int = 4):
    """Run a bounce `while_loop` with straggler compaction: at full width
    only while the live-lane count exceeds n/frac, then gather survivors
    into an n/frac-wide wavefront and recurse — dead lanes stop paying for
    traversal, shading and RNG (the lockstep-tail cost of a wavefront).
    `init` is a NamedTuple whose [n]-leading
    arrays are per-lane state and which has a bool `alive` field; scalar
    fields continue through the sub-loop. Bit-transparent as long as every
    sampling stream is keyed by per-pixel ids (utils/rng.py), never lane
    position.

    Fill slots get an OUT-OF-RANGE index: their gathers clip to garbage
    (the lane is marked dead) and their scatters are dropped — an in-range
    fill index would collide with a live lane and could overwrite its
    update with a stale value (duplicate-scatter order is unspecified)."""
    if n <= min_width:
        return jax.lax.while_loop(cond, body, init)
    m = n // frac

    def cond1(s):
        return cond(s) & (jnp.sum(s.alive.astype(jnp.int32)) > m)

    s = jax.lax.while_loop(cond1, body, init)
    idx = jnp.nonzero(s.alive, size=m, fill_value=n)[0]
    live = idx < n

    def take(a):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == n:
            return jnp.take(a, idx, axis=0, mode="clip")
        return a

    cls = type(s)
    sub = cls(*(take(f) for f in s))
    sub = sub._replace(alive=sub.alive & live)
    out = compacted_loop(cond, body, sub, m, min_width, frac)

    def put(a, b):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] == n:
            return a.at[idx].set(b, mode="drop")
        return b   # scalars continue from the sub-loop
    return cls(*(put(a, b) for a, b in zip(s, out)))


# ---------------------------------------------------------------------------
# Sky (environment light) — disabled by default like the reference
# ---------------------------------------------------------------------------


def sample_sky(d, enabled: bool = False):
    """Gradient sky + sun; the reference ships this disabled (its first line
    returns black, integratorUtilities.cuh:437). enabled=True revives the
    dead gradient code for capability parity."""
    if not enabled:
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    unit = normalize(d)
    t = 0.5 * (unit[..., 1] + 1.0)
    c_horizon = jnp.asarray([1.0, 0.4, 0.2])
    c_zenith = jnp.asarray([0.3, 0.4, 0.8])
    return (1.0 - t)[..., None] * c_horizon + t[..., None] * c_zenith


# ---------------------------------------------------------------------------
# Light sampling (deviceCode.cu:104-115) + NEE pdf (deviceCode.cu:63-86)
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    point: jax.Array      # [N,3]
    normal: jax.Array     # [N,3]
    emission: jax.Array   # [N,3]
    area: jax.Array       # [N]
    tri: jax.Array        # [N] permuted triangle index of the light


def sample_light_point(scene, key, draw_base, n, ids=None):
    """Uniform light pick + area sample with the reference's sqrt warp:
    p = (1-u)a + u(1-v)b + u v c with u = sqrt(rand) (deviceCode.cu:107-115).
    """
    ul = rng.uniform_any(key, draw_base + 0, n, ids)
    u = jnp.sqrt(rng.uniform_any(key, draw_base + 1, n, ids))
    v = rng.uniform_any(key, draw_base + 2, n, ids)
    num = max(scene.num_lights, 1)
    idx = jnp.minimum((ul * num).astype(jnp.int32), num - 1)
    # all light columns in ONE lookup (one-hot for small light lists, row
    # gather otherwise) — 7 separate gathers each paid the per-row floor
    rows = jnp.concatenate([
        scene.light_p0, scene.light_p1, scene.light_p2, scene.light_normal,
        scene.light_emission, scene.light_area[:, None],
        scene.light_tri.astype(jnp.float32)[:, None]], axis=1)
    r = table_lookup(rows, idx) if num <= 64 else rows[idx]
    a, b, c = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    p = (1.0 - u)[:, None] * a + (u * (1.0 - v))[:, None] * b + (u * v)[:, None] * c
    return LightSample(point=p, normal=r[:, 9:12],
                       emission=r[:, 12:15],
                       area=r[:, 15], tri=r[:, 16].astype(jnp.int32))


def nee_pdf(scene, from_point, light_point, light_normal, light_area):
    """Solid-angle pdf of NEE having sampled this light point from
    `from_point` (neePDF, deviceCode.cu:63-86): d^2/(cos_l * numLights * A).
    Negative when the light faces away (the reference then skips the MIS
    term via its `pdf > EPSILON` check)."""
    stl = light_point - from_point
    wi = normalize(stl)
    d2 = length_sq(stl)
    cos_l = dot(light_normal, -wi)
    denom = cos_l * max(scene.num_lights, 1) * light_area
    sign = jnp.where(denom >= 0, 1.0, -1.0)
    return d2 / (sign * jnp.maximum(jnp.abs(denom), 1e-20))


class NEESample(NamedTuple):
    """An NEE connection with everything except the shadow trace resolved —
    lets integrators defer the occlusion test into a fused traversal
    (ops/traverse.trace_fused)."""
    contrib: jax.Array    # [N,3] f*Le*cos/pdf, pdf/active-gated, UNSHADOWED
    light_pdf: jax.Array  # [N]
    wo_local: jax.Array   # [N,3] light dir in shading space (MIS counter-pdf)
    origin: jax.Array     # [N,3] shadow ray origin
    dir: jax.Array        # [N,3] shadow ray direction
    max_t: jax.Array      # [N]
    active: jax.Array     # [N] worth tracing (active & pdf > eps)


def nee_sample(scene, key, draw_base, point, normal, wi_local,
               mat, albedo, eta_i, active, ids=None,
               transmission=None) -> NEESample:
    """Light sample + unshadowed NEE contribution (deviceCode.cu:87-156
    minus the shadow ray, which the caller traces — possibly fused)."""
    n = point.shape[0]
    if scene.num_lights == 0:
        z = jnp.zeros((n, 3), jnp.float32)
        return NEESample(z, jnp.full((n,), -1.0), z, point, z,
                         jnp.zeros((n,), jnp.float32),
                         jnp.zeros((n,), bool))

    ls = sample_light_point(scene, key, draw_base, n, ids)
    stl = ls.point - point
    wi = normalize(stl)
    dist = jnp.sqrt(jnp.maximum(length_sq(stl), 0.0))

    origin = point + wi * EPSILON
    # max_t measured from the offset origin (the reference re-intersects the
    # light triangle from there, deviceCode.cu:124-127); the extra EPSILON
    # keeps the light itself strictly outside the occlusion test
    max_t = (dist - EPSILON) * (1.0 - EPSILON)

    light_pdf = nee_pdf(scene, point, ls.point, ls.normal, ls.area)
    cos_surf = jnp.abs(dot(normal, wi))

    wo_local = jnp.stack([dot(wi, t) for t in _frame3(normal)], axis=-1)
    f_val = bsdf_ops.bsdf_f(mat, albedo, -wi_local, wo_local, eta_i,
                            transmission=transmission)

    contrib = f_val * ls.emission * (cos_surf / _safe(light_pdf))[:, None]
    gate = (light_pdf > EPSILON) & active
    contrib = jnp.where(gate[:, None], contrib, 0.0)
    return NEESample(contrib, light_pdf, wo_local, origin, wi, max_t, gate)


def next_event_estimation(scene, key, draw_base, point, normal, wi_local,
                          mat, albedo, eta_i, active, ids=None,
                          transmission=None):
    """One NEE shadow connection per lane (deviceCode.cu:87-156).

    Returns (contribution [N,3] — f*Le*cos/pdf*shadow, light_pdf [N],
    wo_local [N,3] — the light direction in shading space, for the BSDF-pdf
    MIS counter-weight).
    """
    ns = nee_sample(scene, key, draw_base, point, normal, wi_local, mat,
                    albedo, eta_i, active, ids, transmission=transmission)
    if scene.num_lights == 0:
        return ns.contrib, ns.light_pdf, ns.wo_local
    shadow = traverse.shadow_factor(scene, ns.origin, ns.dir, ns.max_t,
                                    active=ns.active)
    clear = jnp.max(shadow, axis=-1) > 0.0
    contrib = jnp.where(clear[:, None], ns.contrib * shadow, 0.0)
    return contrib, ns.light_pdf, ns.wo_local


def _safe(x, eps=1e-20):
    sign = jnp.where(x >= 0, 1.0, -1.0)
    return sign * jnp.maximum(jnp.abs(x), eps)


def _frame3(nrm):
    from cudapathtracer_tpu.utils.math import build_frame
    t, b = build_frame(nrm)
    return t, b, nrm


def power2_weight(p, q):
    """Power-2 MIS heuristic p^2/(p^2+q^2) (deviceCode.cu:449-450), in the
    overflow-safe ratio form 1/(1+(q/p)^2): near-grazing light samples drive
    the area->solid-angle pdf beyond float range and the naive form yields
    inf/inf = NaN (the reference has the same overflow — its NaN pixels get
    painted magenta by the scrub; we avoid creating them)."""
    r = q / jnp.maximum(p, 1e-30)
    w = 1.0 / (1.0 + r * r)
    return jnp.where(p > 0.0, w, 0.0)


# ---------------------------------------------------------------------------
# Medium stack (nested dielectrics), vectorized
# ---------------------------------------------------------------------------


class MediumStack(NamedTuple):
    """[N, S] medium stack + [N] top counter. Slot 0 is always AIR.

    Entries are PACKED (priority << 10 | mat_id): the dominant-medium scan
    is then a single min-reduce over the stack — looking priorities up per
    slot cost an [N, S, M] one-hot contraction in every shade (profiled as
    a top non-gather cost)."""
    stack: jax.Array
    top: jax.Array

    @staticmethod
    def make(n: int, air_priority=0,
             size: int = MEDIUM_STACK_SIZE) -> "MediumStack":
        stack = jnp.zeros((n, size), jnp.int32)
        air = (jnp.asarray(air_priority, jnp.int32) << 10).astype(jnp.int32)
        stack = stack.at[:, 0].set(air)
        return MediumStack(stack=stack, top=jnp.ones((n,), jnp.int32))


def _pack_medium(mat_id, priority):
    return (priority.astype(jnp.int32) << 10) | mat_id


def stack_push(ms: MediumStack, mat_id, priority, mask) -> MediumStack:
    s = ms.stack.shape[1]
    slots = jnp.arange(s)[None, :]
    can = mask & (ms.top < s)
    put = can[:, None] & (slots == ms.top[:, None])
    stack = jnp.where(put, _pack_medium(mat_id, priority)[:, None], ms.stack)
    return MediumStack(stack=stack, top=ms.top + can.astype(jnp.int32))


def stack_remove(ms: MediumStack, mat_id, mask) -> MediumStack:
    """Remove the topmost occurrence of mat_id (never slot 0), shifting the
    entries above it down (removeMaterialFromStack semantics)."""
    s = ms.stack.shape[1]
    slots = jnp.arange(s)[None, :]
    live = (slots > 0) & (slots < ms.top[:, None])
    match = ((ms.stack & 1023) == mat_id[:, None]) & live
    i_found = jnp.max(jnp.where(match, slots, -1), axis=1)
    found = (i_found >= 0) & mask
    shift_from = slots >= i_found[:, None]
    shifted = jnp.roll(ms.stack, -1, axis=1)
    stack = jnp.where(found[:, None] & shift_from, shifted, ms.stack)
    return MediumStack(stack=stack, top=ms.top - found.astype(jnp.int32))



def table_lookup(col, ids):
    """col[ids] — direct row gather (a one-hot contraction was tried
    first, on the belief that random gathers paid a large latency floor;
    its [N,24]-shaped intermediates cost more)."""
    return col[ids]


def dominant_medium(ms: MediumStack):
    """Lowest-priority-value medium on the stack (deviceCode.cu:345-356):
    ONE min-reduce over the packed entries. Ties: the packed min picks the
    lowest mat_id among equal priorities — the reference scan picks the
    deepest slot; both are stable, and equal-priority overlapping media is
    already undefined behavior in the reference. Returns (mat_id [N],
    priority [N])."""
    s = ms.stack.shape[1]
    slots = jnp.arange(s)[None, :]
    live = slots < ms.top[:, None]
    packed = jnp.where(live, ms.stack, jnp.int32(2 ** 30))
    best = jnp.min(packed, axis=1)
    return best & 1023, best >> 10


def second_lowest_medium(ms: MediumStack, exclude_mat):
    """The dominant medium pretending `exclude_mat` isn't on the stack —
    determines etaT when exiting the dominant medium (deviceCode.cu:397-420).
    Faithfully reproduces the reference quirk of also skipping priority-0
    entries in this scan (deviceCode.cu:404: `if (priority)`), and defaults
    to slot 0 (air)."""
    s = ms.stack.shape[1]
    slots = jnp.arange(s)[None, :]
    live = slots < ms.top[:, None]
    consider = (live & ((ms.stack & 1023) != exclude_mat[:, None])
                & ((ms.stack >> 10) != 0))
    packed = jnp.where(consider, ms.stack, jnp.int32(2 ** 30))
    best = jnp.min(packed, axis=1)
    none_found = best == 2 ** 30
    return jnp.where(none_found, ms.stack[:, 0] & 1023, best & 1023)
