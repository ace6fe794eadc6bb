"""Vector-math substrate for batched [N, 3] arrays.

Wavefront equivalent of the reference's float4 register math (util.cuh:35-185):
instead of per-thread float4 with a dead w component, every op here is over
SoA batches of shape [..., 3].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1e-5          # reference util.cuh:27
RAY_EPSILON = 1e-4      # offset along normal to avoid self-intersection (util.cuh:28)
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
SKY_RADIUS = 1e4        # util.cuh:30
MAX_FIREFLY_LUM = 5.0   # firefly clamp used by BDPT/VCM (util.cuh:31)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis, keepdims dropped: [...,3]x[...,3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    """Like dot() but keeps the last axis for broadcasting: [...] -> [...,1]."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length_sq(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize: returns a * rsqrt(|a|^2). Zero vectors stay ~zero."""
    return a * jax.lax.rsqrt(jnp.maximum(dot3(a, a), eps))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luminance (reference util.cuh:283-286)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def build_frame(n: jnp.ndarray):
    """Build an orthonormal tangent frame (t, b, n) from unit normals [...,3].

    Matches the reference's branch on |n.x| vs |n.z| (util.cuh:163-185) but
    branch-free via jnp.where so all lanes stay lockstep.
    Returns (tangent, bitangent) with shapes like n.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = jnp.abs(nx) > jnp.abs(nz)
    # h1 = normalize(cross(n, x_axis-ish)): two candidate helper vectors
    # candidate A (|n.x| dominant): t = (-ny, nx, 0)/sqrt(nx^2+ny^2)
    inv_a = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny, 1e-20))
    ta = jnp.stack([-ny * inv_a, nx * inv_a, jnp.zeros_like(nx)], axis=-1)
    # candidate B: t = (0, -nz, ny)/sqrt(ny^2+nz^2)
    inv_b = jax.lax.rsqrt(jnp.maximum(ny * ny + nz * nz, 1e-20))
    tb = jnp.stack([jnp.zeros_like(nx), -nz * inv_b, ny * inv_b], axis=-1)
    t = jnp.where(use_x[..., None], ta, tb)
    b = cross(n, t)
    return t, b


def to_local(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """World -> local shading space where z = normal (util.cuh:163-173)."""
    t, b = build_frame(n)
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_world(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Local shading space -> world (util.cuh:175-185)."""
    t, b = build_frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflect v about n (both pointing away from surface convention:
    returns 2*dot(v,n)*n - v for v = wo)."""
    return 2.0 * dot3(v, n) * n - v


def refract(wi: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Refract wi (pointing away from surface, same side as n) through n.

    eta = etaI / etaT. Returns (wt, total_internal_reflection_mask).
    """
    cos_i = dot(wi, n)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = (eta * eta) * sin2_i
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = -wi * eta[..., None] + (eta * cos_i - cos_t)[..., None] * n
    return normalize(wt), tir


def rotate_x(v: jnp.ndarray, a) -> jnp.ndarray:
    """Rotate [...,3] about X by angle a (radians). Reference util.cuh:237-244."""
    c, s = jnp.cos(a), jnp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([x, c * y - s * z, s * y + c * z], axis=-1)


def rotate_y(v: jnp.ndarray, a) -> jnp.ndarray:
    c, s = jnp.cos(a), jnp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


def rotate_z(v: jnp.ndarray, a) -> jnp.ndarray:
    c, s = jnp.cos(a), jnp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x - s * y, s * x + c * y, z], axis=-1)


def offset_ray_origin(p: jnp.ndarray, n: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Offset hit point along the geometric normal toward the ray direction side,
    the reference's RAY_EPSILON self-intersection guard."""
    side = jnp.sign(dot3(d, n))
    side = jnp.where(side == 0.0, 1.0, side)
    return p + n * side * RAY_EPSILON


def is_prime(n: int) -> bool:
    """Host-side primality helper for hash-table sizing (util.cuh:393-405)."""
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n (util.cuh:407-413)."""
    while not is_prime(n):
        n += 1
    return n


def merge_radius(initial_radius: float, sample_idx, alpha: float):
    """VCM/SPPM progressive merge-radius schedule (util.cuh:415-418):
    r_i = r0 * sqrt((1/(i+1))^alpha)."""
    return initial_radius * jnp.sqrt(jnp.power(1.0 / (sample_idx + 1.0), alpha))
