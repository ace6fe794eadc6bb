"""Ray-triangle and ray-AABB intersection, batched over ray wavefronts.

Wavefront counterparts of the reference's per-thread tests
(integratorUtilities.cuh:8-82): every function takes [N,...] ray batches and
is pure elementwise math (no gathers), so XLA fuses it into the traversal loop.
Also provides the O(T) brute-force intersector (the reference's own oracle,
integratorUtilities.cuh:290-335) used by tests to validate BVH traversal.
"""

from __future__ import annotations

import jax.numpy as jnp

from cudapathtracer_tpu.utils.math import cross, dot

BIG_T = 999999.0  # reference default max_t (integratorUtilities.cuh:84)
DET_EPS = 1e-12   # |det| cutoff (integratorUtilities.cuh:19)


def moller_trumbore(o, d, v0, e1, e2):
    """Möller-Trumbore on packed triangle data.

    o, d: [N,3] ray origins/directions; v0, e1, e2: [N,3] per-lane triangle
    (vertex a, b-a, c-a). Returns (t, u, v, ok) each [N]. Barycentric
    convention: point = v0*(1-u-v) + v1*u + v2*v (matches the reference's
    (u, v, 1-u-v) weights, integratorUtilities.cuh:31, 119-133).
    """
    h = cross(d, e2)
    a = dot(h, e1)
    ok_det = jnp.abs(a) >= DET_EPS
    f = 1.0 / jnp.where(ok_det, a, 1.0)
    s = o - v0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, ok


def aabb_intersect(o, inv_d, bmin, bmax):
    """Branchless slab test (integratorUtilities.cuh:44-82).

    o, inv_d: [N,3]; bmin, bmax: [N,3]. Returns (tmin, tmax, hit)."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return tmin, tmax, (tmax >= tmin) & (tmax > 0.0)


def safe_inv_dir(d):
    """1/d with sign-preserving huge values instead of inf (keeps the slab
    test well-defined for axis-parallel rays)."""
    s = jnp.where(d >= 0.0, 1.0, -1.0)
    return s / jnp.maximum(jnp.abs(d), 1e-30)


def brute_force_closest_hit(o, d, tri_v0, tri_e1, tri_e2, max_t=BIG_T,
                            skip_tri=None):
    """O(T) closest-hit over all triangles — the traversal test oracle
    (sceneIntersection, integratorUtilities.cuh:290-335).

    o, d: [N,3]; tri_*: [T,3]. Returns (t, tri_idx, u, v); tri_idx = -1 on
    miss and t = max_t there.
    """
    n = o.shape[0]
    tcount = tri_v0.shape[0]
    # broadcast: [N, T, 3]
    ob = o[:, None, :]
    db = d[:, None, :]
    t, u, v, ok = moller_trumbore(ob, db, tri_v0[None], tri_e1[None], tri_e2[None])
    if skip_tri is not None:
        tri_ids = jnp.arange(tcount, dtype=jnp.int32)[None, :]
        ok = ok & (tri_ids != skip_tri[:, None])
    t = jnp.where(ok & (t < max_t), t, BIG_T * 2)
    best = jnp.argmin(t, axis=1)
    lane = jnp.arange(n)
    bt = t[lane, best]
    hit = bt < BIG_T * 2
    tri_idx = jnp.where(hit, best.astype(jnp.int32), -1)
    out_t = jnp.where(hit, bt, max_t if jnp.ndim(max_t) == 0 else max_t)
    return out_t, tri_idx, u[lane, best], v[lane, best]
