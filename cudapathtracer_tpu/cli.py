"""Command-line entry point.

The reference's main() hard-codes "configs/config.rendertron" and loops 75
renders with a per-render Y offset on emissive meshes (main.cu:925-933);
here the config path, render count, sample override, integrator override and
checkpointing are proper arguments, with the same defaults.

Usage:
    python -m cudapathtracer_tpu [configs/config.rendertron]
        [--renders N] [--samples N] [--integrator NAME]
        [--checkpoint PATH] [--no-progressive] [--devices tile,spp]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _assert_platform_env() -> None:
    """Apply JAX_PLATFORMS to the live JAX config before any backend
    starts. JAX reads the variable when it is imported; a program that
    imported JAX earlier (a test runner, an embedding interpreter) would
    otherwise keep its own platform order, and JAX_PLATFORMS=cpu must
    still mean the CPU."""
    want = os.environ.get("JAX_PLATFORMS")
    if want:
        import jax

        jax.config.update("jax_platforms", want)


def main(argv=None) -> int:
    _assert_platform_env()
    ap = argparse.ArgumentParser(prog="cudapathtracer_tpu",
                                 description=__doc__)
    ap.add_argument("config", nargs="?", default="configs/config.rendertron")
    ap.add_argument("--renders", type=int, default=1,
                    help="number of animated renders (reference runs 75)")
    ap.add_argument("--samples", type=int, default=None,
                    help="override Sample Count")
    ap.add_argument("--integrator", default=None,
                    help="override the config integrator")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path (enables exact resume)")
    ap.add_argument("--no-progressive", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--samples-per-dispatch", type=int, default=None,
                    help="samples accumulated per device dispatch "
                         "(bit-identical to 1)")
    args = ap.parse_args(argv)

    import jax

    from cudapathtracer_tpu.driver import Renderer, mesh_from_config
    from cudapathtracer_tpu.utils.compile_cache import enable_compile_cache
    from cudapathtracer_tpu.utils.config import load_config

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"Rendering on {dev.platform} ({dev.device_kind}), "
          f"{len(jax.devices())} device(s)")

    cfg = load_config(args.config)
    if args.integrator:
        cfg = dataclasses.replace(cfg, integrator=args.integrator)
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width)
    if args.height:
        cfg = dataclasses.replace(cfg, height=args.height)
    if args.samples_per_dispatch:
        cfg = dataclasses.replace(
            cfg, samples_per_dispatch=args.samples_per_dispatch)

    for rn in range(args.renders):
        print(f'Began render number {rn}: "{cfg.name}"')
        mesh = mesh_from_config(cfg.normalized(), rn)
        r = Renderer(cfg, mesh=mesh)
        from cudapathtracer_tpu.scene.bvh import bvh_stats
        st = bvh_stats(r.bvh)
        print(f"  {mesh.num_triangles} triangles, {mesh.num_lights} lights; "
              f"BVH: {st['num_nodes']} nodes, {st['num_leaves']} leaves, "
              f"depth mean {st['depth_mean']:.1f} / max {st['depth_max']}")
        r.render(num_samples=args.samples,
                 checkpoint_path=args.checkpoint,
                 progressive=not args.no_progressive)
        img = r.save_final(rn)
        print(f"  saved {cfg.output_dir}/{cfg.name}{rn}.bmp")
        print(r.metrics.summary())
        print(f"  {r.checks.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
