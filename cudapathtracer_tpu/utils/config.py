"""Render configuration: dataclass + parser for the `.rendertron` text format.

Same semantic surface as the reference's RenderConfig/loadConfig
(objects.cuh:794-943): `key: value` lines plus a trailing mesh section of
`path; mult * (r,g,b); materialID` lines. SPPM is realized as VCM with
strategies forced off and merging on (main.cu:314-333) — `normalized()`
applies that override here, in the config layer, so integrators never
special-case it.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field, replace
from typing import List

INTEGRATORS = ("UNIDIRECTIONAL", "BIDIRECTIONAL", "NAIVE_UNIDIRECTIONAL", "VCM", "SPPM")


@dataclass
class MeshConfig:
    path: str
    emission_multiplier: float = 1.0
    emission_color: tuple = (0.0, 0.0, 0.0)
    material_id: int = 0

    @property
    def emission(self) -> tuple:
        m = self.emission_multiplier
        r, g, b = self.emission_color
        return (m * r, m * g, m * b)


@dataclass
class MaterialConfig:
    """One `Materials` section line (framework extension): replaces the
    builtin registry entry at `material_id` with a factory-built material.

    Line format:  id; kind; key=value; key=value; ...
    e.g.          12; metal; eta=(0.2,0.9,1.1); k=(3.9,2.4,2.1); roughness=0.05
    Kinds: diffuse, metal, dielectric, leaf, mirror, raw (raw = any
    Material field verbatim). The reference hard-codes its 24 materials
    (main.cu:397-446); this section makes them configurable while keeping
    the builtin registry as the base so existing configs are unchanged."""
    material_id: int
    kind: str
    params: dict = field(default_factory=dict)


@dataclass
class RenderConfig:
    # Window / system
    width: int = 0
    height: int = 0
    name: str = "render"

    # Integrator settings
    integrator: str = "UNIDIRECTIONAL"
    # framework extension ("Engine" key): "mega" = persistent lane-machine
    # integrators (fast path, default); "classic" = per-bounce scan
    # integrators (the oracle implementations; also the sharded path)
    engine: str = "mega"
    sample_count: int = 0
    max_depth: int = 0                 # "Unidirectional Max Depth"
    bvh_leaf_size: int = 2
    sample_environment: bool = False
    post_process: bool = False

    # BDPT settings
    bdpt_eye_depth: int = 0
    bdpt_light_depth: int = 0
    bdpt_light_trace: bool = False
    bdpt_nee: bool = False
    bdpt_naive: bool = False
    bdpt_connection: bool = False
    bdpt_draw_path: bool = False
    bdpt_do_mis: bool = False
    bdpt_paint_weight: bool = False
    vcm_do_merge: bool = False
    do_sppm: bool = False

    vcm_merge_const: float = 0.0       # alpha of the radius schedule
    vcm_initial_merge_radius_multiplier: float = 0.0
    # framework extension (no reference key): static bounded-gather merge
    # cap per grid cell — the reference visits every photon in a cell
    # unboundedly (deviceCode.cu:2992-3048); the driver reports how many
    # candidates the cap truncated so this can be raised from data
    vcm_max_per_cell: int = 8

    # Camera
    pinhole_camera: bool = False
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_rot: tuple = (0.0, 0.0, 0.0)
    cam_fov: float = 60.0
    cam_aperture: float = 0.0
    cam_focal_dist: float = 0.0

    # Assets
    meshes: List[MeshConfig] = field(default_factory=list)
    materials: List[MaterialConfig] = field(default_factory=list)

    # Framework extensions (not in the reference format; defaults preserve
    # reference behavior)
    seed: int = 103033                 # deviceCode.cu:57
    save_interval_seconds: float = 5.0  # progressive save cadence (deviceCode.cu:226)
    output_dir: str = "renders"
    # samples accumulated per device dispatch (lax.fori_loop over the
    # per-sample body — the analogue of batching CUDA-Graph replays,
    # main.cu:538-599). Bit-identical to 1 (positional RNG); amortizes
    # the host's per-dispatch cost at small frames. 0 = auto
    # (driver.resolve_samples_per_dispatch).
    samples_per_dispatch: int = 0

    def normalized(self) -> "RenderConfig":
        """Resolve integrator aliases + apply the SPPM flag override
        (main.cu:325-333)."""
        cfg = replace(self)
        cfg.integrator = match_integrator(cfg.integrator)
        if cfg.integrator == "SPPM":
            cfg.bdpt_connection = False
            cfg.bdpt_naive = False
            cfg.bdpt_nee = False
            cfg.bdpt_light_trace = False
            cfg.bdpt_do_mis = False
            cfg.vcm_do_merge = True
            cfg.do_sppm = True
        elif cfg.integrator == "VCM":
            # the shipped reference config never sets VCM_DOMERGE; VCM still
            # merges — the flag gates *disabling* merge experiments
            cfg.vcm_do_merge = True
        return cfg

    def asdict(self):
        return dataclasses.asdict(self)


def match_integrator(s: str) -> str:
    """String -> canonical integrator name (objects.cuh:570-593)."""
    k = s.strip().upper().replace(" ", "_").replace("-", "_")
    aliases = {
        "UNIDIRECTIONAL": "UNIDIRECTIONAL",
        "PT": "UNIDIRECTIONAL",
        "PATH": "UNIDIRECTIONAL",
        "BIDIRECTIONAL": "BIDIRECTIONAL",
        "BDPT": "BIDIRECTIONAL",
        "NAIVE_UNIDIRECTIONAL": "NAIVE_UNIDIRECTIONAL",
        "NAIVE": "NAIVE_UNIDIRECTIONAL",
        "VCM": "VCM",
        "SPPM": "SPPM",
    }
    if k not in aliases:
        raise ValueError(f"Unknown integrator {s!r}; expected one of {INTEGRATORS}")
    return aliases[k]


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("true", "1", "yes", "on")


def _parse_vec3(v: str) -> tuple:
    nums = re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", v)
    if len(nums) < 3:
        raise ValueError(f"Cannot parse vec3 from {v!r}")
    return (float(nums[0]), float(nums[1]), float(nums[2]))


# key -> (field, converter). Mirrors loadConfig's mapping (objects.cuh:906-941),
# including BOTH spellings of "Multipl(i)er" (the shipped config has the typo
# "Multipler" which the reference parser silently drops; we accept both so the
# value actually takes effect).
_KEYMAP = {
    "width": ("width", int),
    "height": ("height", int),
    "Integrator": ("integrator", str),
    "Name": ("name", str),
    "Sample Count": ("sample_count", int),
    "Unidirectional Max Depth": ("max_depth", int),
    "BVH recommended leaf size": ("bvh_leaf_size", int),
    "Bidirectional Eye Depth": ("bdpt_eye_depth", int),
    "Bidirectional Light Depth": ("bdpt_light_depth", int),
    "BDPT_LIGHTTRACE": ("bdpt_light_trace", _parse_bool),
    "BDPT_NEE": ("bdpt_nee", _parse_bool),
    "BDPT_NAIVE": ("bdpt_naive", _parse_bool),
    "BDPT_CONNECTION": ("bdpt_connection", _parse_bool),
    "BDPT_DRAWPATH": ("bdpt_draw_path", _parse_bool),
    "BDPT_DOMIS": ("bdpt_do_mis", _parse_bool),
    "BDPT_PAINTWEIGHT": ("bdpt_paint_weight", _parse_bool),
    "Pinhole Camera": ("pinhole_camera", _parse_bool),
    "SAMPLE_ENVIRONMENT": ("sample_environment", _parse_bool),
    "Post Process": ("post_process", _parse_bool),
    "VCM_DOMERGE": ("vcm_do_merge", _parse_bool),
    "Camera Position": ("cam_pos", _parse_vec3),
    "Camera Rotation": ("cam_rot", _parse_vec3),
    "Camera FOV": ("cam_fov", float),
    "Camera Apeture": ("cam_aperture", float),   # reference spelling
    "Camera Aperture": ("cam_aperture", float),
    "Camera FocalDist": ("cam_focal_dist", float),
    "VCM Merge Radius Power Factor": ("vcm_merge_const", float),
    "VCM Initial Merge Radius Multiplier": ("vcm_initial_merge_radius_multiplier", float),
    "VCM Initial Merge Radius Multipler": ("vcm_initial_merge_radius_multiplier", float),
    "VCM Max Photons Per Cell": ("vcm_max_per_cell", int),
    # framework extensions
    "Seed": ("seed", int),
    "Engine": ("engine", lambda s: s.strip().lower()),
    "Save Interval Seconds": ("save_interval_seconds", float),
    "Samples Per Dispatch": ("samples_per_dispatch", int),
    "Output Dir": ("output_dir", str),
}


def load_config(path: str) -> RenderConfig:
    """Parse a `.rendertron` config file (format of configs/config.rendertron)."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_config(f.read())


def _parse_material_value(v: str):
    """Typed value for a `Materials` line param: vec3, bool, or number."""
    v = v.strip()
    if "(" in v:
        return _parse_vec3(v)
    low = v.lower()
    if low in ("true", "false", "yes", "no", "on", "off"):
        return _parse_bool(v)
    f = float(v)
    return int(f) if f.is_integer() and "." not in v and "e" not in low \
        else f


def _parse_material_line(line: str) -> MaterialConfig | None:
    parts = [p.strip() for p in line.split(";")]
    if len(parts) < 2 or not parts[0].lstrip("+-").isdigit():
        return None
    params = {}
    for p in parts[2:]:
        if not p or "=" not in p:
            continue
        k, _, v = p.partition("=")
        params[k.strip()] = _parse_material_value(v)
    return MaterialConfig(material_id=int(parts[0]),
                          kind=parts[1].lower(), params=params)


def parse_config(text: str) -> RenderConfig:
    cfg = RenderConfig()
    parsing_meshes = False
    parsing_materials = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("Meshes"):
            parsing_meshes, parsing_materials = True, False
            continue
        if line.startswith("Materials"):
            parsing_materials, parsing_meshes = True, False
            continue
        if parsing_materials:
            mc = _parse_material_line(line)
            if mc is not None:
                cfg.materials.append(mc)
            continue
        if parsing_meshes:
            parts = [p.strip() for p in line.split(";")]
            if len(parts) < 3:
                continue
            mesh = MeshConfig(path=parts[0])
            m = re.match(r"\s*([-+eE\d.]+)\s*\*\s*\((.*)\)", parts[1])
            if m:
                mesh.emission_multiplier = float(m.group(1))
                mesh.emission_color = _parse_vec3(m.group(2))
            mesh.material_id = int(parts[2])
            cfg.meshes.append(mesh)
        else:
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if not value:
                continue  # section headers like "BDPT Specifc Settings:"
            entry = _KEYMAP.get(key)
            if entry is None:
                continue  # unknown keys are ignored, like the reference
            fname, conv = entry
            setattr(cfg, fname, conv(value))
    return cfg
