"""Sample batching: run k samples in ONE device dispatch.

The reference amortizes launch overhead by recording its per-sample
kernel sequence into a CUDA Graph and replaying it (main.cu:538-599,
cudaGraphLaunch per sample). The JAX equivalent of *replay* is the
cached jitted executable — but each replay still pays a host dispatch
cost, which matters at small frames where a sample computes quickly.
This module is the equivalent of batching several graph replays into one
launch: a
`lax.fori_loop` over the per-sample integrator body accumulates k
samples device-side and returns once.

The image is bit-identical to k single dispatches summed: every RNG
stream is keyed by (sample index, pixel id) — positional Threefry
counters, no sequential state — so sample s computes the same floats
whether dispatched alone or as iteration i of a batch (tested:
tests/test_batch.py).

Ray counts accumulate in int32: callers should keep k * rays_per_sample
below 2^31 (a 1080p sample is ~10^7 rays — thousands of samples per
batch before overflow; the driver batches <= 64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def make_batched(inner):
    """Wrap a per-sample integrator step into a k-sample single dispatch.

    inner(scene, camera, base_key, sample_idx, px, py) -> (li [P,3], rays)
    — optionally with extra trailing scalar i32 counters (e.g. the VCM
    merge-cap dropped count), which accumulate across the batch — with
    sample_idx traced (every shipped integrator satisfies this).

    Returns batched(scene, camera, base_key, s0, px, py, k) ->
    (li_sum [P,3], rays_total, *counter_totals) accumulating samples
    s0 .. s0+k-1. The start index s0 is traced, so consecutive batches
    reuse one executable; only distinct k values recompile.
    """
    @partial(jax.jit, static_argnames=("k",))
    def batched(scene, camera, base_key, s0, px, py, k: int):
        s0 = jnp.asarray(s0, jnp.int32)

        def body(i, carry):
            acc = carry[0]
            out = inner(scene, camera, base_key, s0 + i, px, py)
            counters = tuple(c + jnp.asarray(o, jnp.int32)
                             for c, o in zip(carry[1:], out[1:]))
            return (acc + out[0],) + counters

        # abstract trace only (no ops added); cached per jit specialization
        n_counters = len(jax.eval_shape(
            lambda *a: inner(*a), scene, camera, base_key, s0, px, py)) - 1
        acc0 = jnp.zeros((px.shape[0], 3), jnp.float32)
        zeros = tuple(jnp.zeros((), jnp.int32) for _ in range(n_counters))
        return lax.fori_loop(0, k, body, (acc0,) + zeros)

    return batched
