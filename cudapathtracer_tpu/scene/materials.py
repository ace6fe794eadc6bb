"""Material system: tagged SoA table + factory constructors.

Re-design of the reference's Material struct + factories
(objects.cuh:595-792). Instead of an array-of-structs uploaded to device
memory, materials live in a struct-of-arrays `MaterialTable` pytree whose
columns are gathered per-hit inside integrator kernels — the wavefront
layout for vectorized dispatch (no per-lane struct loads).

Material type ids match the reference enum (objects.cuh:595-603).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np

MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_SMOOTHDIELECTRIC = 2
MAT_MICROFACETDIELECTRIC = 3
MAT_LEAF = 4
MAT_FLOWER = 5
MAT_DELTAMIRROR = 6

AIR_PRIORITY = 99  # priority of the ambient medium (main.cu:435: air, pri 99)

# Transport modes (objects.cuh:578-581)
TRANSPORT_RADIANCE = 0
TRANSPORT_IMPORTANCE = 1


@dataclass
class Material:
    """Host-side material description (one row of the table)."""
    type: int = MAT_DIFFUSE
    albedo: tuple = (0.8, 0.8, 0.8)
    roughness: float = 0.5
    eta: tuple = (0.0, 0.0, 0.0)    # conductor IOR real part
    k: tuple = (0.0, 0.0, 0.0)      # conductor IOR imaginary part
    ior: float = 1.5                # dielectric IOR
    transmission: float = 0.0
    is_specular: bool = False
    boundary: bool = False          # participates in the medium stack
    thin_walled: bool = False
    absorption: tuple = (0.0, 0.0, 0.0)  # Beer-Lambert sigma_a
    priority: int = 0               # nested-dielectric priority (lower wins)
    # texture atlas window (reference: startInd/width/height); -1 = no texture
    tex_start: int = -1
    tex_width: int = 0
    tex_height: int = 0
    trans_tex_start: int = -1
    trans_tex_width: int = 0
    trans_tex_height: int = 0

    # ---- factories (objects.cuh:645-792 semantics) ----
    @staticmethod
    def diffuse(color) -> "Material":
        return Material(type=MAT_DIFFUSE, albedo=tuple(color), roughness=1.0)

    @staticmethod
    def diffuse_textured(start: int, w: int, h: int) -> "Material":
        return Material(type=MAT_DIFFUSE, roughness=1.0,
                        tex_start=start, tex_width=w, tex_height=h)

    @staticmethod
    def metal(eta, k, roughness: float = 0.1) -> "Material":
        return Material(type=MAT_METAL, eta=tuple(eta), k=tuple(k),
                        roughness=roughness, albedo=(1.0, 1.0, 1.0))

    @staticmethod
    def smooth_dielectric(ior: float = 1.5, absorption=(0.0, 0.0, 0.0),
                          priority: int = 0) -> "Material":
        return Material(type=MAT_SMOOTHDIELECTRIC, ior=ior,
                        albedo=(1.0, 1.0, 1.0), absorption=tuple(absorption),
                        priority=priority, is_specular=True, boundary=True)

    @staticmethod
    def leaf(ior: float = 1.5, roughness: float = 0.7, albedo=(0.0, 0.0, 0.0),
             transmission: float = 0.05, tex_start: int = -1, tex_width: int = 0,
             tex_height: int = 0, trans_tex_start: int = -1,
             trans_tex_width: int = 0, trans_tex_height: int = 0) -> "Material":
        return Material(type=MAT_LEAF, ior=ior, roughness=roughness,
                        albedo=tuple(albedo), transmission=transmission,
                        thin_walled=True, tex_start=tex_start,
                        tex_width=tex_width, tex_height=tex_height,
                        trans_tex_start=trans_tex_start,
                        trans_tex_width=trans_tex_width,
                        trans_tex_height=trans_tex_height)

    @staticmethod
    def mirror() -> "Material":
        return Material(type=MAT_DELTAMIRROR, is_specular=True)

    @staticmethod
    def air() -> "Material":
        """The ambient medium, always material index 0 (main.cu:435, 448)."""
        return Material.smooth_dielectric(1.0, (0.0, 0.0, 0.0), AIR_PRIORITY)


@jax.tree_util.register_dataclass
@dataclass
class MaterialTable:
    """Device SoA of all scene materials. All fields are [M] or [M,3] arrays."""
    type: jax.Array
    albedo: jax.Array
    roughness: jax.Array
    eta: jax.Array
    k: jax.Array
    ior: jax.Array
    transmission: jax.Array
    is_specular: jax.Array
    boundary: jax.Array
    thin_walled: jax.Array
    absorption: jax.Array
    priority: jax.Array
    tex_start: jax.Array
    tex_width: jax.Array
    tex_height: jax.Array
    trans_tex_start: jax.Array
    trans_tex_width: jax.Array
    trans_tex_height: jax.Array

    @property
    def count(self) -> int:
        return self.type.shape[0]

    def gather(self, ids: jax.Array) -> "MaterialTable":
        """Gather per-hit material rows: ids [N] -> MaterialTable of [N] rows."""
        take = lambda a: a[ids]
        return MaterialTable(**{f.name: take(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


def build_table(mats: list[Material], device: bool = True) -> MaterialTable:
    """Build the material SoA. device=True uploads with ONE batched
    jax.device_put of the whole pytree. device=False keeps numpy columns (used
    by build_scene, which packs per-triangle rows host-side and uploads
    everything at once)."""

    def col(name, dtype, dim=None):
        vals = [getattr(m, name) for m in mats]
        arr = np.asarray(vals, dtype=dtype)
        if dim is not None:
            arr = arr.reshape(len(mats), dim)
        return arr

    table = MaterialTable(
        type=col("type", np.int32),
        albedo=col("albedo", np.float32, 3),
        roughness=col("roughness", np.float32),
        eta=col("eta", np.float32, 3),
        k=col("k", np.float32, 3),
        ior=col("ior", np.float32),
        transmission=col("transmission", np.float32),
        is_specular=col("is_specular", np.bool_),
        boundary=col("boundary", np.bool_),
        thin_walled=col("thin_walled", np.bool_),
        absorption=col("absorption", np.float32, 3),
        priority=col("priority", np.int32),
        tex_start=col("tex_start", np.int32),
        tex_width=col("tex_width", np.int32),
        tex_height=col("tex_height", np.int32),
        trans_tex_start=col("trans_tex_start", np.int32),
        trans_tex_width=col("trans_tex_width", np.int32),
        trans_tex_height=col("trans_tex_height", np.int32),
    )
    return jax.device_put(table) if device else table


def builtin_materials(tex_windows: list[tuple[int, int, int]] | None = None) -> list[Material]:
    """The reference's hard-coded 24-material registry (main.cu:397-446),
    index-compatible with config materialIDs.

    tex_windows: up to 4 (start, width, height) atlas windows for the textured
    materials (indices 11, 12, 13, 16); procedural placeholders are used when
    absent (the reference's textures/*.bmp are not in its repo either).
    """
    tw = tex_windows or [(-1, 0, 0)] * 4
    while len(tw) < 4:
        tw.append((-1, 0, 0))

    eta_steel = (0.14, 0.16, 0.13)
    # NOTE(reference quirk, main.cu:420): gold is constructed as
    # Metal(eta_gold, eta_gold) — k set to eta — and steel likewise. Kept.
    eta_gold = (0.17, 0.35, 1.5)

    mats = [
        Material.air(),                                         # 0
        Material.diffuse((0.4, 0.4, 0.8)),                      # 1  blue
        Material.diffuse((0.9, 0.9, 0.9)),                      # 2  white
        Material.diffuse((0.2, 0.6, 0.6)),                      # 3  green
        Material.metal(eta_gold, eta_gold, 0.05),               # 4  gold
        Material.smooth_dielectric(1.5, (0.0, 0.0, 0.0), 1),    # 5  glass
        Material.diffuse((0.90, 0.1, 0.1)),                     # 6  red
        Material.metal(eta_steel, eta_steel, 0.15),             # 7  steel
        Material.smooth_dielectric(1.333, (2.5 * 0.180, 2.5 * 1.5, 2.5 * 2.996), 2),  # 8 tea
        Material.smooth_dielectric(1.31, (0.2, 0.2, 0.2), 0),   # 9  ice
        Material.smooth_dielectric(1.333, (0.0, 0.0, 0.0), 2),  # 10 water
        Material.diffuse_textured(*tw[0]),                      # 11
        Material.diffuse_textured(*tw[1]),                      # 12
        Material.leaf(1.5, 0.10, (0.22, 0.75, 0.28), 0.15,
                      tw[2][0], tw[2][1], tw[2][2]),            # 13 leaf
        Material.diffuse((0.90, 0.9, 0.83)),                    # 14 leafStem
        Material.diffuse((0.4, 0.4, 1.0)),                      # 15 sky
        Material.leaf(1.5, 0.8, (0.22, 0.75, 0.28), 0.6,
                      tw[3][0], tw[3][1], tw[3][2]),            # 16 leafAutumn
        Material.diffuse((0.8, 0.8, 0.8)),                      # 17 grey
        Material.smooth_dielectric(2.42, (0.0, 0.0, 0.0), 1),   # 18 diamond
        Material.mirror(),                                      # 19
        Material.diffuse((0.0, 0.0, 0.0)),                      # 20 black
        Material.diffuse((0.95, 0.95, 0.95)),                   # 21
        Material.diffuse((0.5, 0.5, 0.5)),                      # 22
        Material.diffuse((0.1, 0.9, 0.1)),                      # 23 very green
    ]
    return mats


# `Materials` config-section kinds -> constructors (framework extension;
# the reference hard-codes its registry, main.cu:397-446). Every kind maps
# onto an existing factory so config-built materials carry exactly the same
# invariants (specular/boundary/thin-walled flags) as builtin ones.
_MATERIAL_KINDS = {
    "diffuse": lambda albedo=(0.8, 0.8, 0.8): Material.diffuse(albedo),
    "metal": lambda eta=(0.17, 0.35, 1.5), k=None, roughness=0.1:
        Material.metal(eta, eta if k is None else k, roughness),
    "dielectric": lambda ior=1.5, absorption=(0.0, 0.0, 0.0), priority=0:
        Material.smooth_dielectric(ior, absorption, priority),
    "glass": lambda ior=1.5, absorption=(0.0, 0.0, 0.0), priority=0:
        Material.smooth_dielectric(ior, absorption, priority),
    "leaf": Material.leaf,
    "mirror": lambda: Material.mirror(),
    "raw": lambda **kw: Material(**{
        k: tuple(v) if isinstance(v, tuple) else v for k, v in kw.items()}),
}


def apply_material_configs(base: list[Material], entries) -> list[Material]:
    """Apply `Materials` config-section overrides onto a registry copy.

    entries: iterable with .material_id / .kind / .params
    (utils.config.MaterialConfig). Ids beyond the registry grow it (gaps
    filled with grey diffuse). Material 0 is the ambient medium and may only
    be replaced by another boundary material (the medium stack's bottom
    entry must stay a medium, models/common.py)."""
    mats = list(base)
    for e in entries:
        kind = e.kind.lower()
        ctor = _MATERIAL_KINDS.get(kind)
        if ctor is None:
            raise ValueError(
                f"Materials line: unknown kind {e.kind!r}; expected one of "
                f"{sorted(_MATERIAL_KINDS)}")
        mat = ctor(**e.params)
        if e.material_id < 0:
            raise ValueError(f"Materials line: bad id {e.material_id}")
        if e.material_id == 0 and not mat.boundary:
            raise ValueError(
                "Materials line: id 0 is the ambient medium and must be a "
                "boundary material (dielectric)")
        while len(mats) <= e.material_id:
            mats.append(Material.diffuse((0.5, 0.5, 0.5)))
        mats[e.material_id] = mat
    return mats
