"""Counter-based Threefry RNG streams.

Counter-based replacement for the reference's per-pixel curand XORWOW state
that is round-tripped through global memory every sample (deviceCode.cu:53-61,
215). Here a render is bit-reproducible by construction: every random draw is
keyed by (seed, stream, sample, bounce, draw_id) and the array *lane* provides
the per-pixel decorrelation (Threefry is counter-based, so one key -> one
deterministic stream indexed by output position).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_SEED = 103033  # the reference's fixed seed (deviceCode.cu:57)


def base_key(seed: int = DEFAULT_SEED, stream: int = 0) -> jax.Array:
    """Root key for a render. `stream` separates logical streams, e.g. the
    BDPT light pass vs eye pass, or per-chip streams in a sharded render."""
    return jax.random.fold_in(jax.random.PRNGKey(seed), stream)


def sample_key(key: jax.Array, sample_idx) -> jax.Array:
    """Derive the key for one progressive sample (spp index)."""
    return jax.random.fold_in(key, sample_idx)


def bounce_key(skey: jax.Array, bounce) -> jax.Array:
    """Derive the key for one bounce within a sample."""
    return jax.random.fold_in(skey, bounce)


def uniform(key: jax.Array, draw_id: int, shape, dtype=jnp.float32) -> jax.Array:
    """One labelled uniform draw in [0,1). draw_id distinguishes the several
    independent uniforms consumed within a single bounce (pick-light, light-uv,
    bsdf-lobe, bsdf-uv, russian-roulette, ...)."""
    return jax.random.uniform(jax.random.fold_in(key, draw_id), shape, dtype=dtype)


def uniform2(key: jax.Array, draw_id: int, shape) -> tuple[jax.Array, jax.Array]:
    """Two independent uniforms (the (u1,u2) pattern for 2D warps)."""
    u = jax.random.uniform(jax.random.fold_in(key, draw_id), shape + (2,))
    return u[..., 0], u[..., 1]


# --- layout-independent per-lane streams -----------------------------------
# The positional streams above key every draw by array LANE, which ties a
# pixel's sample sequence to the wavefront layout: chunk size, straggler
# compaction, and shard topology all change the image. The *_id variants key
# each lane by a STABLE id (pixel / path id) instead, making renders
# bit-identical under any partitioning — the property the reference cannot
# have with per-thread curand state (deviceCode.cu:53-61).

def pixel_ids(px, py) -> jax.Array:
    """Stable sampling ids from pixel coordinates (width-independent)."""
    return (py.astype(jnp.int32) << 14) + px.astype(jnp.int32)


def lane_keys(key: jax.Array, draw_id: int, ids: jax.Array) -> jax.Array:
    """Per-lane keys: fold (draw_id, lane id) into the bounce key."""
    k = jax.random.fold_in(key, draw_id)
    return jax.vmap(lambda i: jax.random.fold_in(k, i))(ids)


# Raw vectorized Threefry-2x32 (Salmon et al., the same primitive JAX's PRNG
# uses). vmapping jax.random.fold_in + uniform per lane was far off the
# elementwise roofline on the previous accelerator; this elementwise
# formulation of the identical cipher runs the whole draw as ~50 wide
# uint32 ops.

_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 over [N] uint32 vectors -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _draw_key(key: jax.Array, draw_id: int):
    kd = jax.random.key_data(jax.random.fold_in(key, draw_id))
    kd = kd.astype(jnp.uint32)
    return kd[0], kd[1]


def _bits_to_unit(bits):
    # 23 mantissa bits -> [0, 1)
    return (bits >> jnp.uint32(9)).astype(jnp.float32) * jnp.float32(2 ** -23)


def uniform_id(key: jax.Array, draw_id: int, ids: jax.Array,
               dtype=jnp.float32) -> jax.Array:
    """One labelled uniform in [0,1) per lane, keyed by stable ids."""
    k0, k1 = _draw_key(key, draw_id)
    x0, x1 = _threefry2x32(k0, k1, ids.astype(jnp.uint32),
                           jnp.zeros_like(ids, jnp.uint32))
    return _bits_to_unit(x0).astype(dtype)


def uniform2_id(key: jax.Array, draw_id: int, ids: jax.Array):
    """Two independent uniforms per lane, keyed by stable ids."""
    k0, k1 = _draw_key(key, draw_id)
    x0, x1 = _threefry2x32(k0, k1, ids.astype(jnp.uint32),
                           jnp.zeros_like(ids, jnp.uint32))
    return _bits_to_unit(x0), _bits_to_unit(x1)


def draw_key_table(key: jax.Array, bounces, draw_ids) -> jax.Array:
    """Precompute the (k0, k1) pairs of uniform_id for every (bounce,
    draw_id) combination: returns u32 [len(bounces), len(draw_ids), 2].

    The persistent light machine (models/light_mega.py) keys each lane's
    draws by the lane's OWN depth; folding per lane is far off the
    elementwise roofline (see _threefry2x32 note), so the scalar fold chain
    bounce_key -> _draw_key runs HERE once per (bounce, draw) and lanes
    select their pair with a tiny-table gather."""
    rows = []
    for b in (bounces if bounces is not None else [None]):
        bkey = key if b is None else bounce_key(key, b)
        rows.append(jnp.stack([jnp.stack(_draw_key(bkey, d))
                               for d in draw_ids]))
    return jnp.stack(rows).astype(jnp.uint32)


def uniform_keyed(k0, k1, ids, dtype=jnp.float32) -> jax.Array:
    """uniform_id with PER-LANE key pairs ([N] u32 each, e.g. gathered
    from draw_key_table): bit-identical to uniform_id(key, draw_id, ids)
    when (k0, k1) = _draw_key(key, draw_id) broadcast."""
    x0, _ = _threefry2x32(k0, k1, ids.astype(jnp.uint32),
                          jnp.zeros_like(ids, jnp.uint32))
    return _bits_to_unit(x0).astype(dtype)


def uniform_any(key: jax.Array, draw_id: int, n: int, ids=None,
                dtype=jnp.float32) -> jax.Array:
    """uniform_id when stable ids are provided, positional uniform
    otherwise (legacy callers)."""
    if ids is None:
        return uniform(key, draw_id, (n,), dtype=dtype)
    return uniform_id(key, draw_id, ids, dtype=dtype)
