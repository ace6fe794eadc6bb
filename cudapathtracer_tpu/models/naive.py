"""Naive unidirectional path tracer.

Wavefront re-design of Li_naive_unidirectional (deviceCode.cu:158-283): the
whole pixel batch advances one bounce per iteration of a lax.while_loop;
dead lanes are masked. BSDF sampling with no NEE/MIS/RR; emission picked up
on every hit; fixed max depth.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.models import common
from cudapathtracer_tpu.ops import bsdf as bsdf_ops
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import (EPSILON, RAY_EPSILON, length_sq,
                                           to_local, to_world)

# rng draw ids within a bounce
_D_BSDF = 0  # ..3


class _State(NamedTuple):
    depth: jax.Array       # scalar bounce counter (lockstep)
    o: jax.Array
    d: jax.Array
    beta: jax.Array
    li: jax.Array
    alive: jax.Array
    pid: jax.Array         # [N] stable pixel ids (rng *_id streams)
    rays: jax.Array


@partial(jax.jit, static_argnames=("max_depth", "sample_environment",
                                   "compact_min_width"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, sample_environment: bool = False,
                  compact_min_width: int = 1 << 20):
    """Trace one sample for pixels (px, py) [N]; returns radiance [N,3].

    compact_min_width: bounce-level straggler compaction threshold
    (common.compacted_loop, bit-transparent). Default OFF: neutral to
    slightly negative for this integrator on the previous accelerator —
    traversal already compacts internally and naive shading is too cheap
    for dead lanes to matter.
    Kept as a knob for deep-depth workloads."""
    n = px.shape[0]
    skey = rng.sample_key(base_key, sample_idx)
    o, d = camera.generate_rays(jax.random.fold_in(skey, 2 ** 20),
                                px.astype(jnp.float32), py.astype(jnp.float32),
                                ids=rng.pixel_ids(px, py))

    def cond(s):
        return (s.depth < max_depth) & jnp.any(s.alive)

    def body(s):
        depth, o, d, beta, li, alive, pid, rays = s
        bkey = rng.bounce_key(skey, depth)
        rays = rays + jnp.sum(alive.astype(jnp.int32))

        hit = traverse.closest_hit(scene, o, d, active=alive)
        info, mat = traverse.shade_data(scene, o, d, hit)
        miss = alive & ~hit.valid
        li = li + jnp.where(miss[:, None],
                            beta * common.sample_sky(d, sample_environment), 0.0)
        alive = alive & hit.valid

        wi_local = to_local(d, info["normal"])
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])

        # naive kernel passes etaI = etaT = 1 (deviceCode.cu:189)
        # (width = the CURRENT lane count — narrower after compaction)
        eta_i = jnp.ones(alive.shape, jnp.float32)
        wo_local, f_val, pdf = bsdf_ops.bsdf_sample(
            bkey, _D_BSDF, mat, albedo, -wi_local, info["backface"], eta_i,
            ids=pid, transmission=trans)

        bad = (pdf <= 0.0) | (length_sq(f_val) < EPSILON)
        alive2 = alive & ~bad

        # emission collected after the sampling-validity break (deviceCode.cu:193)
        li = li + jnp.where(alive2[:, None], info["emission"] * beta, 0.0)

        beta = jnp.where(alive2[:, None],
                         beta * f_val * (jnp.abs(wo_local[..., 2])
                                         / jnp.maximum(pdf, 1e-20))[:, None],
                         beta)

        wo_world = to_world(wo_local, info["normal"])
        side = jnp.where(wo_local[..., 2] > 0.0, 1.0, -1.0)
        new_o = info["point"] + info["normal"] * (side * RAY_EPSILON)[:, None]
        o = jnp.where(alive2[:, None], new_o, o)
        d = jnp.where(alive2[:, None], wo_world, d)
        return _State(depth + 1, o, d, beta, li, alive2, pid, rays)

    init = _State(jnp.int32(0), o, d, jnp.ones((n, 3), jnp.float32),
                  jnp.zeros((n, 3), jnp.float32), jnp.ones((n,), bool),
                  rng.pixel_ids(px, py), jnp.int32(0))
    out = common.compacted_loop(cond, body, init, n, compact_min_width)
    return out.li, out.rays
