"""Render driver: config -> scene -> progressive render -> image artifacts.

The framework's equivalent of the reference's initRender + launchers
(main.cu:235-933): builds the scene (OBJ meshes or builtin procedural
scenes), constructs the camera, dispatches the configured integrator as a
jitted per-sample step, accumulates radiance in a device framebuffer,
progressively saves BMP/CSV on a wall-clock cadence (deviceCode.cu:226), and
— unlike the reference (SURVEY.md §5.4: no resume) — checkpoints the
accumulation buffer + sample counter so renders restart exactly (Threefry
keying makes the resumed sample stream identical).
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from cudapathtracer_tpu.models import naive as naive_mod
from cudapathtracer_tpu.models import unidirectional as uni_mod
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera
from cudapathtracer_tpu.scene.materials import builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.checks import CheckLog
from cudapathtracer_tpu.utils.compile_cache import enable_compile_cache
from cudapathtracer_tpu.utils.config import RenderConfig
from cudapathtracer_tpu.utils.image import Image, scrub
from cudapathtracer_tpu.utils.metrics import RenderMetrics
from cudapathtracer_tpu.utils.obj import MeshData, load_obj

BUILTIN_SCENES = {
    "builtin:cornell": builtin.cornell_box,
    "builtin:cornell_blocks": builtin.cornell_with_blocks,
    "builtin:cornell_spheres": builtin.cornell_with_spheres,
    "builtin:cornell_bunny": builtin.cornell_with_bunny,
}


def mesh_from_config(cfg: RenderConfig, render_number: int = 0) -> MeshData:
    """Assemble the scene triangle soup from the config's mesh list.
    Paths may be OBJ files or builtin:<name> procedural scenes. Emissive
    meshes get the reference's per-render animation offset of
    (0, -0.01 * renderNumber, 0) (main.cu:478, 925-933)."""
    mesh = MeshData()
    for mc in cfg.meshes:
        if mc.path in BUILTIN_SCENES:
            sub = BUILTIN_SCENES[mc.path]()
            # builtin scenes carry their own per-triangle material ids;
            # splice their soup in wholesale
            off = len(mesh.positions)
            noff = len(mesh.normals)
            toff = len(mesh.uvs)
            lbase = 0 if mesh.light_ind.size == 0 else int(mesh.light_ind.max()) + 1
            sub_light = np.where(sub.light_ind >= 0, sub.light_ind + lbase, -1)
            mesh.positions = np.concatenate([mesh.positions, sub.positions])
            mesh.normals = np.concatenate([mesh.normals, sub.normals])
            mesh.uvs = np.concatenate([mesh.uvs, sub.uvs])
            mesh.pos_idx = np.concatenate([mesh.pos_idx, sub.pos_idx + off])
            mesh.nrm_idx = np.concatenate([mesh.nrm_idx, sub.nrm_idx + noff])
            mesh.uv_idx = np.concatenate([mesh.uv_idx, sub.uv_idx + toff])
            mesh.mat_id = np.concatenate([mesh.mat_id, sub.mat_id])
            mesh.emission = np.concatenate([mesh.emission, sub.emission])
            mesh.light_ind = np.concatenate([mesh.light_ind, sub_light])
        else:
            emissive = sum(e * e for e in mc.emission) > 0.0
            offset = ((0.0, -0.01 * render_number, 0.0) if emissive
                      else (0.0, 0.0, 0.0))
            load_obj(mc.path, mesh, mc.material_id, mc.emission,
                     offset=offset)
    return mesh


def resolve_samples_per_dispatch(cfg: RenderConfig,
                                 backend: str | None = None) -> int:
    """Samples accumulated per device dispatch. Explicit config wins; 0 =
    auto: small frames (<= 512^2) on an accelerator batch min(8,
    2^21/pixels) samples into one dispatch (models/batch.py), so the
    per-dispatch host overhead is paid once per batch. Large frames and
    the CPU backend stay per-sample (prompt progressive saves). The
    thresholds were set on the previous accelerator and are not yet
    re-derived for the GPU."""
    if cfg.samples_per_dispatch > 0:
        return cfg.samples_per_dispatch
    n = cfg.width * cfg.height
    backend = backend or jax.default_backend()
    if backend == "cpu" or n > (1 << 18):
        return 1
    return max(1, min(8, (1 << 21) // max(n, 1)))


class Renderer:
    """One configured render (scene + camera + integrator + framebuffer)."""

    def __init__(self, config: RenderConfig, mesh: MeshData | None = None,
                 materials=None, textures=None):
        self.cfg = config.normalized()
        self.metrics = RenderMetrics()
        self.checks = CheckLog()
        cfg = self.cfg

        if mesh is None:
            if len(cfg.meshes) == 1 and cfg.meshes[0].path in BUILTIN_SCENES:
                mesh = BUILTIN_SCENES[cfg.meshes[0].path]()
            else:
                mesh = mesh_from_config(cfg)
        if materials is None:
            # the reference's 24-material registry with its 4-texture atlas
            # (placeholders for textures missing from the reference repo)
            from cudapathtracer_tpu.scene.textures import reference_atlas
            atlas, wins = reference_atlas()
            materials = builtin_materials(wins)
            if cfg.materials:  # `Materials` config section (extension)
                from cudapathtracer_tpu.scene.materials import (
                    apply_material_configs)
                materials = apply_material_configs(materials, cfg.materials)
            if textures is None:
                textures = atlas

        enable_compile_cache()
        # pay the device's first-transfer init outside the build timers
        jnp.zeros((8,), jnp.float32).block_until_ready()

        with self.metrics.phase("scene_build"):
            self.mesh = mesh
        with self.metrics.phase("bvh_build"):
            self.scene, self.bvh = build_scene(
                mesh, materials, textures,
                max_leaf_size=max(cfg.bvh_leaf_size, 1))

        self.camera = Camera.from_config(cfg)
        self.key = rng.base_key(cfg.seed)
        n = cfg.width * cfg.height
        px, py = jnp.meshgrid(jnp.arange(cfg.width), jnp.arange(cfg.height))
        self.px = px.ravel()
        self.py = py.ravel()
        self.metrics.pixels = n
        self.accum = jnp.zeros((n, 3), jnp.float32)
        self.sample_count = 0
        self._overlay = None  # BDPT_DRAWPATH channel, built lazily
        # jitted dispatch steps, built once (see _step)
        self._inner = self._single = self._batched = None

    # ------------------------------------------------------------------
    def _sample_fn(self):
        """Per-sample integrator step with EXPLICIT array args:
        inner(scene, camera, key, sample_idx, px, py) -> (li [P,3], rays).
        Arrays stay jit arguments (not captured constants) so the step can
        also be traced inside the k-sample batch dispatch (models/batch.py)
        without re-staging the scene as constants."""
        cfg = self.cfg
        integ = cfg.integrator
        if integ == "NAIVE_UNIDIRECTIONAL":
            def inner(scene, camera, key, sample_idx, px, py):
                return naive_mod.render_sample(
                    scene, camera, key, sample_idx, px, py,
                    max_depth=max(cfg.max_depth, 1),
                    sample_environment=cfg.sample_environment)
            return inner
        if integ == "UNIDIRECTIONAL":
            if cfg.engine == "mega":
                from cudapathtracer_tpu.models import unidirectional_mega
                def inner(scene, camera, key, sample_idx, px, py):
                    return unidirectional_mega.render_sample(
                        scene, camera, key, sample_idx, px, py,
                        max_depth=max(cfg.max_depth, 1),
                        sample_environment=cfg.sample_environment,
                        grid_w=cfg.width)
                return inner
            def inner(scene, camera, key, sample_idx, px, py):
                return uni_mod.render_sample(
                    scene, camera, key, sample_idx, px, py,
                    max_depth=max(cfg.max_depth, 1),
                    sample_environment=cfg.sample_environment)
            return inner
        if integ == "BIDIRECTIONAL":
            from cudapathtracer_tpu.models import bdpt as bdpt_mod
            bcfg = bdpt_mod.BDPTConfig.from_config(cfg)
            if cfg.engine == "mega":
                from cudapathtracer_tpu.models import bdpt_mega
                def inner(scene, camera, key, sample_idx, px, py):
                    return bdpt_mega.render_sample(
                        scene, camera, key, sample_idx, px, py,
                        cfg=bcfg, grid_w=cfg.width)
                return inner
            def inner(scene, camera, key, sample_idx, px, py):
                return bdpt_mod.render_sample(
                    scene, camera, key, sample_idx, px, py, cfg=bcfg)
            return inner
        if integ in ("VCM", "SPPM"):
            from cudapathtracer_tpu.models import vcm as vcm_mod
            vcfg = vcm_mod.VCMConfig.from_config(cfg)
            if cfg.engine == "mega":
                from cudapathtracer_tpu.models import vcm_mega
                count_drop_m = vcfg.do_merge

                def inner(scene, camera, key, sample_idx, px, py):
                    # merge-cap observability, as on the classic path
                    return vcm_mega.render_sample(
                        scene, camera, key, sample_idx, px, py,
                        cfg=vcfg, grid_w=cfg.width,
                        count_merge_dropped=count_drop_m)
                return inner
            count_drop = vcfg.do_merge

            def inner(scene, camera, key, sample_idx, px, py):
                # merge-cap observability: the extra scalar counts photons
                # truncated by max_per_cell (accumulated by the render
                # loop into metrics.merge_dropped)
                return vcm_mod.render_sample(
                    scene, camera, key, sample_idx, px, py, cfg=vcfg,
                    count_merge_dropped=count_drop)
            return inner
        raise ValueError(f"integrator {integ} not wired")

    def _step(self, k: int):
        """(jitted fn, static kwargs) of the dispatch advancing k samples:
        fn(scene, camera, key, s0, px, py, **kw) -> (li, rays, *counters).
        The functions live as long as the Renderer, so every render() call
        and compile() share one compiled program per k."""
        if self._inner is None:
            self._inner = self._sample_fn()
        if k == 1:
            if self._single is None:
                self._single = jax.jit(self._inner)
            return self._single, {}
        if self._batched is None:
            from cudapathtracer_tpu.models.batch import make_batched
            self._batched = make_batched(self._inner)
        return self._batched, {"k": k}

    def compile(self, samples_per_dispatch: int | None = None):
        """Compile the per-dispatch step ahead of time without running it
        (callable from another thread while this one renders); render()
        then reuses the program. Returns the jax Compiled."""
        k = samples_per_dispatch or resolve_samples_per_dispatch(self.cfg)
        fn, kw = self._step(k)
        return fn.lower(self.scene, self.camera, self.key, self.sample_count,
                        self.px, self.py, **kw).compile()

    # ------------------------------------------------------------------
    def render(self, num_samples: int | None = None,
               checkpoint_path: str | None = None, resume: bool = True,
               progressive: bool = True, verbose: bool = True):
        """Run the progressive sample loop. Returns the final Image."""
        cfg = self.cfg
        total = num_samples if num_samples is not None else cfg.sample_count
        spd = resolve_samples_per_dispatch(cfg)

        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)
            if verbose:
                print(f"resumed at sample {self.sample_count}")

        last_save = time.monotonic()
        rtot = jnp.zeros((), jnp.int32)  # device-side; fetched only on saves
        dtot = jnp.zeros((), jnp.int32)  # merge-cap dropped photons (VCM)
        with self.metrics.phase("render"):
            while self.sample_count < total:
                k = min(spd, total - self.sample_count)
                fn, kw = self._step(k)
                out = fn(self.scene, self.camera, self.key,
                         self.sample_count, self.px, self.py, **kw)
                li, rays = out[0], out[1]
                if len(out) > 2:
                    dtot = dtot + out[2]
                self.accum = self.accum + li
                rtot = rtot + rays
                self.sample_count += k
                self.metrics.samples_done += k

                now = time.monotonic()
                if (progressive
                        and now - last_save >= cfg.save_interval_seconds):
                    self.checks.check(f"sample {self.sample_count}", li)
                    self.save_progressive()
                    if checkpoint_path:
                        self.save_checkpoint(checkpoint_path)
                    last_save = time.monotonic()
                    if verbose:
                        print(f"saved progress at {self.sample_count} samples")
            self.metrics.add_rays(int(rtot))
            dropped = int(dtot)
            if dropped:
                self.metrics.merge_dropped = dropped
                if verbose:
                    if os.environ.get("TPT_MERGE_REWEIGHT", "1") != "0":
                        # salted count/kept reweighting makes the capped
                        # visit an unbiased subsample (ops/hashgrid.py)
                        print(f"note: photon merge subsampled {dropped:,} "
                              f"candidate photons (max_per_cell="
                              f"{cfg.vcm_max_per_cell}; unbiased "
                              "reweighting — adds merge variance, not "
                              "energy loss; raise 'VCM Max Photons Per "
                              "Cell' to trade speed for variance)")
                    else:
                        print(f"WARNING: photon merge cap truncated "
                              f"{dropped:,} candidate photons "
                              f"(max_per_cell={cfg.vcm_max_per_cell}; "
                              "'VCM Max Photons Per Cell' in the config "
                              "raises it if caustics look dim)")
        return self.finish()

    # ------------------------------------------------------------------
    def framebuffer(self) -> np.ndarray:
        """Scrubbed, normalized [H,W,3] image (cleanAndFormatImage path).
        With BDPT_DRAWPATH set (bidirectional family only), the eye-path
        overlay is composited over the render exactly like the reference's
        overlay buffer (integratorUtilities.cuh:368-372)."""
        cfg = self.cfg
        acc = np.asarray(self.accum).reshape(cfg.height, cfg.width, 3)
        img = scrub(acc, max(self.sample_count, 1))
        if (cfg.bdpt_draw_path
                and cfg.integrator in ("BIDIRECTIONAL", "VCM", "SPPM")):
            if self._overlay is None:
                from cudapathtracer_tpu.utils import debugviz
                self._overlay = debugviz.bdpt_path_overlay(
                    self.scene, self.camera, rng.sample_key(self.key, 0),
                    self.px, self.py, eye_depth=max(cfg.bdpt_eye_depth, 2))
            from cudapathtracer_tpu.utils.debugviz import composite_overlay
            img = composite_overlay(img, self._overlay)
        return img

    def finish(self) -> Image:
        cfg = self.cfg
        img = Image(cfg.width, cfg.height, self.framebuffer(),
                    post_process=cfg.post_process)
        return img

    def save_progressive(self):
        cfg = self.cfg
        img = self.finish()
        img.save_bmp(os.path.join(cfg.output_dir, "render.bmp"))
        img.save_csv_mono(os.path.join(cfg.output_dir, "renderCSV.csv"))

    def save_final(self, render_number: int = 0):
        cfg = self.cfg
        img = self.finish()
        img.save_bmp(os.path.join(cfg.output_dir,
                                  f"{cfg.name}{render_number}.bmp"))
        img.save_csv_mono(os.path.join(cfg.output_dir,
                                       f"{cfg.name}{render_number}.csv"))
        return img

    # ------------------------------------------------------------------
    # Checkpoint formats: "<path>.npz" = single-file numpy (default);
    # any other path = an Orbax directory checkpoint (async-capable,
    # restores sharded accumulation buffers natively under a device mesh
    # — the right format for multi-chip progressive renders). Both hold
    # the same exact-resume state: accumulation buffer + sample counter
    # (+config echo). RNG needs no state — Threefry streams are positional.
    def _meta(self) -> dict:
        return {"w": self.cfg.width, "h": self.cfg.height,
                "seed": self.cfg.seed, "integrator": self.cfg.integrator}

    def _check_meta(self, meta: dict):
        if (meta["w"], meta["h"]) != (self.cfg.width, self.cfg.height):
            raise ValueError("checkpoint resolution mismatch")
        if (meta["seed"] != self.cfg.seed
                or meta["integrator"] != self.cfg.integrator):
            raise ValueError("checkpoint config mismatch")

    def save_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            return self._save_checkpoint_orbax(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp[:-4],  # savez appends .npz
            accum=np.asarray(self.accum),
            sample_count=self.sample_count,
            config=json.dumps(self._meta()))
        os.replace(tmp, path)

    def load_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            return self._load_checkpoint_orbax(path)
        data = np.load(path, allow_pickle=False)
        self._check_meta(json.loads(str(data["config"])))
        self.accum = jnp.asarray(data["accum"])
        self.sample_count = int(data["sample_count"])

    def _save_checkpoint_orbax(self, path: str):
        ocp = _orbax()
        path = os.path.abspath(path)
        with ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(path,
                       {"accum": self.accum,
                        "sample_count": np.int64(self.sample_count)},
                       force=True)
        with open(os.path.join(path, "render_meta.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self._meta(), f)

    def _load_checkpoint_orbax(self, path: str):
        ocp = _orbax()
        path = os.path.abspath(path)
        with open(os.path.join(path, "render_meta.json"),
                  encoding="utf-8") as f:
            self._check_meta(json.load(f))
        with ocp.PyTreeCheckpointer() as ckptr:
            # restore with the live accum's sharding/dtype as the target so
            # a mesh-sharded progressive render resumes sharded
            data = ckptr.restore(
                path, item={"accum": self.accum,
                            "sample_count": np.int64(0)})
        self.accum = data["accum"]
        self.sample_count = int(data["sample_count"])


def _orbax():
    """orbax.checkpoint, imported only for directory checkpoints."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "checkpoint paths not ending in .npz are Orbax directory "
            "checkpoints and need the 'orbax-checkpoint' package; install "
            "it or use a .npz checkpoint path") from e
    return ocp


def render_from_config(path_or_cfg, num_samples=None, **kw) -> Image:
    from cudapathtracer_tpu.utils.config import load_config
    cfg = (path_or_cfg if isinstance(path_or_cfg, RenderConfig)
           else load_config(path_or_cfg))
    r = Renderer(cfg)
    return r.render(num_samples=num_samples, **kw)
