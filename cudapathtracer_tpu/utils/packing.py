"""Compact encodings for HBM economy on path-vertex / photon SoA buffers.

Ports the *semantics* (not the code) of the reference's packed VCM vertex
layout: octahedral unit-vector codec (util.cuh:342-391), RGB9E5 shared-exponent
color codec (util.cuh:308-337), and the packed flag word
(delta | backface | lightID | matID) of objects.cuh:945-1004. All ops are
batched jnp so they vectorize.
"""

from __future__ import annotations

import jax.numpy as jnp


def _oct_wrap(v: jnp.ndarray) -> jnp.ndarray:
    # fold the lower hemisphere over the diamond edges
    x, y = v[..., 0], v[..., 1]
    wx = (1.0 - jnp.abs(y)) * jnp.where(x >= 0.0, 1.0, -1.0)
    wy = (1.0 - jnp.abs(x)) * jnp.where(y >= 0.0, 1.0, -1.0)
    return jnp.stack([wx, wy], axis=-1)


def pack_oct(n: jnp.ndarray) -> jnp.ndarray:
    """Encode unit vectors [...,3] -> uint32 octahedral (2x16-bit snorm).

    Same capability as the reference's packOct (util.cuh:342-369).
    """
    denom = jnp.abs(n[..., 0]) + jnp.abs(n[..., 1]) + jnp.abs(n[..., 2])
    p = n[..., :2] / jnp.maximum(denom, 1e-20)[..., None]
    p = jnp.where((n[..., 2] < 0.0)[..., None], _oct_wrap(p), p)
    # snorm16 quantize
    q = jnp.clip(jnp.round(p * 32767.0), -32767.0, 32767.0).astype(jnp.int32)
    u = (q & 0xFFFF).astype(jnp.uint32)
    return u[..., 0] | (u[..., 1] << 16)


def unpack_oct(u: jnp.ndarray) -> jnp.ndarray:
    """Decode uint32 octahedral -> unit vectors [...,3]."""
    ux = (u & jnp.uint32(0xFFFF)).astype(jnp.int32)
    uy = ((u >> 16) & jnp.uint32(0xFFFF)).astype(jnp.int32)
    # sign-extend 16-bit
    ux = jnp.where(ux > 32767, ux - 65536, ux)
    uy = jnp.where(uy > 32767, uy - 65536, uy)
    f = jnp.stack([ux, uy], axis=-1).astype(jnp.float32) / 32767.0
    z = 1.0 - jnp.abs(f[..., 0]) - jnp.abs(f[..., 1])
    t = jnp.maximum(-z, 0.0)
    xy = f - jnp.where(f >= 0.0, t[..., None], -t[..., None])
    v = jnp.concatenate([xy, z[..., None]], axis=-1)
    n = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
    return n


def pack_rgb9e5(c: jnp.ndarray) -> jnp.ndarray:
    """RGB [...,3] (non-negative) -> uint32 shared-exponent 9/9/9/e5.

    Capability parity with util.cuh:308-337 (the reference leaves it unused in
    favor of half3; we provide both — see to_half3/from_half3).
    """
    c = jnp.clip(c, 0.0, 65408.0)
    maxc = jnp.maximum(jnp.maximum(c[..., 0], c[..., 1]), c[..., 2])
    # exponent: shared e such that max mantissa fits in 9 bits
    e = jnp.ceil(jnp.log2(jnp.maximum(maxc, 1e-10)))
    e = jnp.clip(e, -15.0, 16.0)
    scale = jnp.exp2(9.0 - e)
    m = jnp.clip(jnp.round(c * scale[..., None]), 0, 511).astype(jnp.uint32)
    eb = (e + 15.0).astype(jnp.uint32)
    return m[..., 0] | (m[..., 1] << 9) | (m[..., 2] << 18) | (eb << 27)


def pack_rgb9e5_cols(c: jnp.ndarray) -> jnp.ndarray:
    """RGB [3,...] (lane-major, non-negative) -> uint32 [...]: the
    column-major twin of pack_rgb9e5 for [3,W] wavefront registers (the
    mega engines' retirement accumulator). Decode with unpack_rgb9e5."""
    c = jnp.clip(c, 0.0, 65408.0)
    maxc = jnp.maximum(jnp.maximum(c[0], c[1]), c[2])
    e = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(maxc, 1e-10))), -15.0, 16.0)
    scale = jnp.exp2(9.0 - e)
    m = jnp.clip(jnp.round(c * scale[None]), 0, 511).astype(jnp.uint32)
    eb = (e + 15.0).astype(jnp.uint32)
    return m[0] | (m[1] << 9) | (m[2] << 18) | (eb << 27)


def unpack_rgb9e5(u: jnp.ndarray) -> jnp.ndarray:
    r = (u & jnp.uint32(0x1FF)).astype(jnp.float32)
    g = ((u >> 9) & jnp.uint32(0x1FF)).astype(jnp.float32)
    b = ((u >> 18) & jnp.uint32(0x1FF)).astype(jnp.float32)
    e = ((u >> 27) & jnp.uint32(0x1F)).astype(jnp.float32) - 15.0
    scale = jnp.exp2(e - 9.0)
    return jnp.stack([r, g, b], axis=-1) * scale[..., None]


def to_half3(c: jnp.ndarray) -> jnp.ndarray:
    """float32 [...,3] -> float16 [...,3] (the reference's chosen beta codec,
    objects.cuh:1123-1133)."""
    return c.astype(jnp.float16)


def from_half3(c: jnp.ndarray) -> jnp.ndarray:
    return c.astype(jnp.float32)


def pack_half2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Two float32 [...] -> one uint32 (a in low 16 bits as f16, b high).

    The word-level form of the reference's half3 codec, for packing halves
    into mixed u32 rows (objects.cuh:1123-1133 semantics)."""
    import jax
    lo = jax.lax.bitcast_convert_type(a.astype(jnp.float16),
                                      jnp.uint16).astype(jnp.uint32)
    hi = jax.lax.bitcast_convert_type(b.astype(jnp.float16),
                                      jnp.uint16).astype(jnp.uint32)
    return lo | (hi << 16)


def unpack_half2(u: jnp.ndarray):
    """uint32 [...] -> (a, b) float32."""
    import jax
    lo = (u & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    hi = ((u >> 16) & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    a = jax.lax.bitcast_convert_type(lo, jnp.float16).astype(jnp.float32)
    b = jax.lax.bitcast_convert_type(hi, jnp.float16).astype(jnp.float32)
    return a, b


# Packed VCM flag word layout (objects.cuh:945-1004 semantics):
#   bit 31: isDelta, bit 30: backface, bits 29..10: lightInd+1 (20 bits, 0 = none),
#   bits 9..0: materialID (10 bits).
def pack_flags(is_delta: jnp.ndarray, backface: jnp.ndarray,
               light_ind: jnp.ndarray, mat_id: jnp.ndarray) -> jnp.ndarray:
    li = jnp.clip(light_ind + 1, 0, (1 << 20) - 1).astype(jnp.uint32)
    w = (is_delta.astype(jnp.uint32) << 31) | (backface.astype(jnp.uint32) << 30)
    w = w | (li << 10) | (jnp.clip(mat_id, 0, 1023).astype(jnp.uint32))
    return w


def unpack_flags(w: jnp.ndarray):
    is_delta = (w >> 31) & jnp.uint32(1)
    backface = (w >> 30) & jnp.uint32(1)
    light_ind = ((w >> 10) & jnp.uint32((1 << 20) - 1)).astype(jnp.int32) - 1
    mat_id = (w & jnp.uint32(1023)).astype(jnp.int32)
    return is_delta.astype(bool), backface.astype(bool), light_ind, mat_id
