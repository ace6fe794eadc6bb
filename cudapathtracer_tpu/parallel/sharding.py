"""Multi-chip rendering: image-tile x spp sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.9/§5.8 — no NCCL/MPI
anywhere); this module is the multi-device scaling layer it never had, built
the JAX way: a 2-D `jax.sharding.Mesh` with axes

  "tile" — pixel rows of the wavefront are sharded across chips (each chip
           owns a contiguous pixel block; the scene/BVH/material tables are
           replicated, like the reference replicates them in one GPU's HBM)
  "spp"  — independent progressive samples run on different chips and are
           summed with a `psum` collective (the "data parallelism" of
           rendering)

Per-chip Threefry streams are derived by folding both mesh coordinates into
the render key, so every chip draws an independent, reproducible stream
(deterministic for a fixed mesh shape).

Scope note: pixel-local integrators (naive, unidirectional) shard exactly.
The splat-based strategies (BDPT/VCM light tracing) scatter into GLOBAL
pixel indices; under tile sharding pass `splat=True` — each shard then
scatters its light paths into a full-image replicated buffer which is
psum-reduced over the tile axis (SURVEY §2.9 "atomicAdd scatter ->
scatter-add + psum across shards") and every shard keeps its own tile
slice. Because all integrator RNG streams are keyed by pixel id (layout
independent), the tile-sharded image equals the single-chip image up to
scatter-order float addition (tested in tests/test_sharding.py).

VCM with merging under tile sharding additionally needs the PHOTON
exchange (SURVEY §5.8): pass `photon_axis="tile"` through to
vcm.render_sample — each shard all-gathers the packed 32-B photon rows
over the tile axis, builds the hash grid on the union, and normalizes by
the global path count, reproducing the reference's single shared photon
grid (deviceCode.cu:3359) across chips. Tested against the single-chip
render in tests/test_sharding.py::test_tile_sharded_vcm_merge.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from cudapathtracer_tpu.utils import rng as rng_mod


def make_mesh(n_tile: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """Build a ("tile", "spp") mesh. Defaults to all devices on the tile
    axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tile is None:
        n_tile = len(devices) // n_spp
    use = np.array(devices[: n_tile * n_spp]).reshape(n_tile, n_spp)
    return Mesh(use, ("tile", "spp"))


def replicated_specs(tree):
    return jax.tree.map(lambda _: P(), tree)


def make_sharded_sample_fn(sample_fn, mesh: Mesh, scene, camera, splat=False,
                           **static_kw):
    """Wrap a per-sample integrator fn (scene, camera, key, sample_idx, px,
    py, **static) into a shard_mapped version over `mesh`.

    Returns fn(key, sample_idx, px, py) -> (radiance [N,3] tile-sharded,
    rays scalar). px/py must be divisible by the tile axis size. Each spp
    shard renders `sample_idx * n_spp + spp_coord` and results are psum-med
    over the spp axis, so one call advances n_spp samples at once.

    splat=True (BDPT/VCM light tracing): the integrator is called with a
    full-image `splat_shape` and returns (li_local, splat_full, rays); the
    splat buffer is psum-reduced over BOTH mesh axes and each shard adds
    its own contiguous tile slice — the collective replacement for the
    reference's atomicAdd framebuffer splat (deviceCode.cu:1426-1428).
    Integrator RNG is pixel-id keyed, so per-chip keys are NOT folded for
    splat integrators: every shard generates exactly the light paths of
    its own pixel block and the union reproduces the single-chip render.
    """
    n_spp = mesh.shape["spp"]
    n_tile = mesh.shape["tile"]

    def inner(scene_r, camera_r, key, sample_idx, px, py):
        ti = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("spp")
        my_sample = sample_idx * n_spp + si
        if splat:
            n_local = px.shape[0]
            li, fb, rays = sample_fn(scene_r, camera_r, key, my_sample, px,
                                     py, splat_shape=n_local * n_tile,
                                     **static_kw)
            # reduce over tile ONLY: each spp shard's fb is its own
            # sample's splat and joins li before the spp-axis psum below
            fb = jax.lax.psum(fb, "tile")
            li = li + jax.lax.dynamic_slice_in_dim(fb, ti * n_local, n_local)
        else:
            # independent per-chip stream; deterministic for fixed mesh
            shard_key = jax.random.fold_in(jax.random.fold_in(key, ti), si)
            li, rays = sample_fn(scene_r, camera_r, shard_key, my_sample, px,
                                 py, **static_kw)
        # sum independent samples across devices; tile axis stays sharded
        li = jax.lax.psum(li, "spp")
        rays = jax.lax.psum(rays, ("tile", "spp"))
        return li, rays

    # check_vma=False: the integrators' while_loop carries start replicated
    # and become device-varying after the first iteration; the varying-axis
    # type system would demand pvary casts inside every integrator, so we opt
    # out of the check here (collective semantics are unchanged).
    shard_fn = jax.jit(jax.shard_map(
        inner, mesh=mesh,
        in_specs=(replicated_specs(scene), replicated_specs(camera),
                  P(), P(), P("tile"), P("tile")),
        out_specs=(P("tile"), P()),
        check_vma=False,
    ))

    def call(key, sample_idx, px, py):
        return shard_fn(scene, camera, key, sample_idx, px, py)

    call.samples_per_call = n_spp
    return call


def render_sharded(sample_fn, mesh, scene, camera, width, height,
                   num_samples, seed=rng_mod.DEFAULT_SEED, **static_kw):
    """Convenience loop: full sharded progressive render. Returns
    (accumulated radiance [H*W,3] numpy, samples_done, rays)."""
    n_tile = mesh.shape["tile"]
    n = width * height
    assert n % n_tile == 0, "pixel count must divide the tile axis"
    px, py = jnp.meshgrid(jnp.arange(width), jnp.arange(height))
    px, py = px.ravel(), py.ravel()
    fn = make_sharded_sample_fn(sample_fn, mesh, scene, camera, **static_kw)
    key = rng_mod.base_key(seed)
    acc = jnp.zeros((n, 3), jnp.float32)
    total_rays = 0
    done = 0
    call_idx = 0
    while done < num_samples:
        li, rays = fn(key, call_idx, px, py)
        acc = acc + li
        done += fn.samples_per_call
        call_idx += 1
        total_rays += int(rays)
    return np.asarray(acc), done, total_rays
