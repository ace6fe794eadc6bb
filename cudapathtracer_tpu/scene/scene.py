"""Device scene representation: SoA triangle/BVH/light/material arrays.

The upload step of the framework — the equivalent of the reference's explicit
cudaMalloc/Memcpy of Vertices/Triangle/BVH arrays (main.cu:484-557). Triangles
are *permuted into BVH leaf order* at build time and denormalized per-corner
(no vertex indirection on device), so traversal leaf reads and shading
interpolation are pure row gathers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from cudapathtracer_tpu.scene import bvh as bvh_mod
from cudapathtracer_tpu.scene.materials import MaterialTable, build_table
from cudapathtracer_tpu.utils.obj import MeshData


@jax.tree_util.register_dataclass
@dataclass
class Scene:
    # --- triangles, BVH-permuted order: ONE consolidated f32 block (the
    # layout was chosen on the previous accelerator, where every distinct leaf
    # shape paid a one-time transfer setup; a few wide blocks upload as a few
    # copies on any device). Consumers read the old names through properties —
    # inside jit the slices trace for free. Column layout of tri_f32:
    #   [0:9]   tri_pack: v0.xyz, e1.xyz, e2.xyz (traversal hot data)
    #   [9:18]  vertex normals a,b,c (flattened [T,3,3])
    #   [18:24] vertex uvs (flattened [T,3,2])
    #   [24:27] emission
    #   [27]    area
    #   [28:76] shade row (see tri_shade_row property comment below)
    #   [76]    mat_id (i32 bitcast)
    #   [77]    light_ind (i32 bitcast; -1 = not a light)
    #   [78:94] shadow detail row (only when has_leaf_materials)
    tri_f32: jax.Array      # [T, 78 or 94] f32

    # --- BVH root bounds row [1, 6] f32 (min xyz, max xyz). Device
    # consumers only ever need the ROOT AABB (hash-grid scene_min,
    # models/vcm*.py); both traversal engines read their own packed tables
    # (node_packed / bvh8_table), so uploading the full [M,6]/[M,2]/[M*8,2]
    # node arrays was ~9 MB of dead transfer weight at 82k tris. The full
    # host-side arrays remain on the returned bvh object for stats/tests.
    node_bounds: jax.Array  # [1, 6] f32 (root row)
    node_leaf: jax.Array    # [1, 2] i32 sentinel (host data: bvh.leaf)
    node_links: jax.Array   # [1, 2] i32 sentinel (host data: bvh.links)

    # --- packed traversal table: ONE wide row gather per traversal step.
    # Row layout (float32, ints bitcast):
    #   [0:6]   node AABB (min xyz, max xyz)
    #   [6:14]  hit link per octant (i32)
    #   [14:22] miss link per octant (i32)
    #   [22]    leaf triangle count (i32; 0 = inner)
    #   [23]    pad
    #   [24+9k : 33+9k]  inline leaf triangle k: v0, e1, e2   (k < K)
    #   [24+9K + k]      triangle id (i32; bit30 = leaf-material flag; -1 empty)
    # Rationale: folding bounds, links and leaf triangles into one row
    # turns ~5 gathers/step into 1 (chosen on the previous accelerator,
    # whose gather cost was per row, nearly independent of row width).
    node_packed: jax.Array  # [M, W] f32

    # --- BVH8 unified table (scene/bvh8.py): the default traversal engine
    bvh8_table: jax.Array   # [R, W] f32

    # --- lights (emissive triangles; deviceCode.cu:955-1010 sampling),
    # consolidated like the triangle block (per-new-shape upload cost):
    # [0:3] p0  [3:6] p1  [6:9] p2  [9:12] vertex-a normal (as the
    # reference uses)  [12:15] emission  [15] area
    # [16] permuted triangle index (i32 bitcast)
    light_f32: jax.Array    # [L, 17] f32

    # --- materials + textures ---
    materials: MaterialTable
    textures: jax.Array     # [A, 3] f32 flat atlas

    # --- bounds ---
    scene_radius: jax.Array  # scalar f32 (half diagonal of root AABB)

    # --- static metadata ---
    num_lights: int = field(metadata=dict(static=True), default=0)
    max_leaf_size: int = field(metadata=dict(static=True), default=2)
    has_leaf_materials: bool = field(metadata=dict(static=True), default=False)
    # any triangle's material carries a transmission map (gates the
    # trans-map texture fetch out of the hot shade path when False)
    has_trans_maps: bool = field(metadata=dict(static=True), default=False)
    traversal: str = field(metadata=dict(static=True), default="bvh8")
    bvh8_leaf_tris: int = field(metadata=dict(static=True), default=4)
    # bitmask (1 << material type) of the types any triangle references:
    # compute-all-and-select BSDF dispatch skips absent lobes at trace
    # time (bit-exact — no lane ever selects a missing lobe)
    mat_type_mask: int = field(metadata=dict(static=True), default=0x7f)

    @property
    def num_triangles(self) -> int:
        return self.tri_f32.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_bounds.shape[0]

    # --- consolidated-block views (free slices inside jit) ---
    @property
    def tri_pack(self):
        return self.tri_f32[:, 0:9]

    @property
    def tri_n(self):
        return self.tri_f32[:, 9:18].reshape(-1, 3, 3)

    @property
    def tri_uv(self):
        return self.tri_f32[:, 18:24].reshape(-1, 3, 2)

    @property
    def tri_emission(self):
        return self.tri_f32[:, 24:27]

    @property
    def tri_area(self):
        return self.tri_f32[:, 27]

    @property
    def tri_shade_row(self):
        """Packed shading row: ONE [T,48] gather at a hit replaces the ~13
        separate gathers of interpolate_hit + MaterialTable.gather (on
        the previous accelerator a random-row gather cost about the same
        at any width, so gather COUNT, not bytes, set shading cost).
        Layout (f32, ints/bools bitcast i32):
          [0:9] n3 a,b,c  [9:15] uv3  [15:18] emission  [18] light_ind
          [19] mat_id  [20] type  [21:24] albedo  [24] roughness
          [25:28] eta  [28:31] k  [31] ior  [32] transmission
          [33] is_specular  [34] boundary  [35] thin_walled
          [36:39] absorption  [39] priority  [40:43] tex start/w/h
          [43:46] trans_tex start/w/h  [46] tri area  [47] pad"""
        return self.tri_f32[:, 28:76]

    @property
    def tri_shadow(self):
        """Shadow detail rows for MAT_LEAF transmission (one gather per
        hit): [0:9] vertex normals a,b,c; [9:12] albedo;
        [12] transmission; [13] ior. Only materialized (gathered) when
        has_leaf_materials."""
        if self.tri_f32.shape[1] >= 94:
            return self.tri_f32[:, 78:94]
        return jnp.zeros((1, 16), jnp.float32)

    @property
    def tri_mat(self):
        return jax.lax.bitcast_convert_type(self.tri_f32[:, 76],
                                            jnp.int32)

    @property
    def tri_light(self):
        return jax.lax.bitcast_convert_type(self.tri_f32[:, 77],
                                            jnp.int32)

    @property
    def light_p0(self):
        return self.light_f32[:, 0:3]

    @property
    def light_p1(self):
        return self.light_f32[:, 3:6]

    @property
    def light_p2(self):
        return self.light_f32[:, 6:9]

    @property
    def light_normal(self):
        return self.light_f32[:, 9:12]

    @property
    def light_emission(self):
        return self.light_f32[:, 12:15]

    @property
    def light_area(self):
        return self.light_f32[:, 15]

    @property
    def light_tri(self):
        return jax.lax.bitcast_convert_type(self.light_f32[:, 16],
                                            jnp.int32)

    # traversal views
    @property
    def tri_v0(self):
        return self.tri_f32[:, 0:3]

    @property
    def tri_e1(self):
        return self.tri_f32[:, 3:6]

    @property
    def tri_e2(self):
        return self.tri_f32[:, 6:9]


def build_scene(mesh: MeshData, materials: list | MaterialTable,
                textures: np.ndarray | None = None,
                **kw) -> tuple[Scene, bvh_mod.BVH]:
    """Build the BVH and upload everything as a Scene pytree (one batched
    jax.device_put of the host blocks from pack_scene).

    Returns (scene, host_bvh) — the host BVH is kept for stats/tests.
    """
    host, bvh = pack_scene(mesh, materials, textures, **kw)
    return jax.device_put(host), bvh


UPLOAD_BLOCKS = ("tri_f32", "light_f32", "node_packed", "bvh8_table")


def upload_mismatches(host: Scene, dev: Scene) -> dict:
    """Per packed block, the number of 32-bit words whose device copy
    differs from the host array. The blocks carry int32 columns as
    bitcast float32 (ids, links, -1 as an all-ones NaN pattern), so the
    comparison is on raw bits: a transfer that canonicalized NaNs or
    flushed denormals would show here, where a float compare would not."""
    out = {}
    for name in UPLOAD_BLOCKS:
        want = np.ascontiguousarray(getattr(host, name)).view(np.uint32)
        got = np.ascontiguousarray(
            np.asarray(getattr(dev, name))).view(np.uint32)
        out[name] = (int(np.count_nonzero(got != want))
                     if got.shape == want.shape else int(want.size))
    return out


def pack_scene(mesh: MeshData, materials: list | MaterialTable,
               textures: np.ndarray | None = None, max_leaf_size: int = 2,
               use_native_bvh: bool = True,
               traversal: str = "bvh8",
               bvh8_leaf_tris: int = 4,
               bvh8_policy: str | None = None,
               use_sbvh: bool | None = None) -> tuple[Scene, bvh_mod.BVH]:
    """Build the BVH and pack the scene into host (numpy) blocks.

    Returns (host_scene, host_bvh); build_scene uploads host_scene.
    """
    if mesh.num_triangles == 0:
        raise ValueError("scene has no triangles")

    pos = mesh.positions
    p0 = pos[mesh.pos_idx[:, 0]]
    p1 = pos[mesh.pos_idx[:, 1]]
    p2 = pos[mesh.pos_idx[:, 2]]

    centroids, amins, amaxs = bvh_mod.triangle_bounds(p0, p1, p2)
    # the threaded-link table and the packed binary-node rows are consumed
    # only by the binary "threaded" engine — skip their Python-loop build
    # cost (the dominant host cost at ~100k tris) under the default BVH8
    want_threaded = traversal == "threaded"
    # SBVH spatial splits: duplicated references with clipped bounds cut
    # visited rows on overlap-heavy meshes. Forbidden with transmissive
    # (MAT_LEAF) materials: any-hit shadow transmission multiplies per
    # intersected REFERENCE, so a duplicated leaf triangle would attenuate
    # twice (bvh.build_sbvh docstring).
    if isinstance(materials, MaterialTable):
        # caller-provided table may hold device columns; pull ONE host
        # copy for the row packers
        table = materials
        htab = jax.device_get(table)
    else:
        # keep columns on host; they ride the single scene device_put
        table = htab = build_table(materials, device=False)
    any_leaf_mat = bool(
        (np.asarray(htab.type)[np.asarray(mesh.mat_id)] == 4).any())
    # On by default (fewer visited rows on the headline scene; goldens
    # unchanged): TPT_BVH_SBVH=0 restores the reference-parity
    # object-split build. Auto-disabled on scenes with
    # transmissive MAT_LEAF materials and for the threaded engine.
    if use_sbvh is None:
        use_sbvh = os.environ.get("TPT_BVH_SBVH", "1") != "0"
    use_sbvh = use_sbvh and not want_threaded and not any_leaf_mat
    if use_sbvh:
        # spatial splits only in the top levels (where the giant-triangle
        # overlap lives: the 82k-tri headline scene keeps the full-depth
        # SBVH's expected visited rows at depth 6); the native object
        # builder splices in below, far faster than a full-depth Python
        # SBVH.
        bvh = bvh_mod.build_sbvh(
            p0, p1, p2, max_leaf_size,
            spatial_depth=int(os.environ.get("TPT_BVH_SBVH_DEPTH", "6")),
            native_below=True,
            no_split=np.asarray(mesh.light_ind) >= 0)
    else:
        bvh = bvh_mod.build_bvh(centroids, amins, amaxs, max_leaf_size,
                                use_native=use_native_bvh,
                                thread=want_threaded)
    perm = bvh.perm

    p0, p1, p2 = p0[perm], p1[perm], p2[perm]
    e1, e2 = p1 - p0, p2 - p0
    tri_pack = np.concatenate([p0, e1, e2], axis=1).astype(np.float32)

    nrm = mesh.normals
    tri_n = np.stack([nrm[mesh.nrm_idx[perm, k]] for k in range(3)], axis=1)
    uvs = mesh.uvs
    tri_uv = np.stack([uvs[mesh.uv_idx[perm, k]] for k in range(3)], axis=1)

    tri_mat = mesh.mat_id[perm]
    tri_emission = mesh.emission[perm]
    tri_light = mesh.light_ind[perm]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    # light table ordered by light index (light_ind values are dense 0..L-1).
    # One row per light_ind even when the builder duplicated references
    # (SBVH): a duplicated emissive triangle must not double its area
    # weight in light sampling or break the light_ind -> row mapping.
    lmask = tri_light >= 0
    lvals = tri_light[lmask]
    lrows = np.nonzero(lmask)[0]
    _, lfirst = np.unique(lvals, return_index=True)  # sorted by light_ind
    lsel = lrows[lfirst].astype(np.int32)
    num_lights = int(lsel.size)
    if num_lights:
        light_p0, light_p1, light_p2 = p0[lsel], p1[lsel], p2[lsel]
        light_normal = tri_n[lsel, 0]
        light_emission = tri_emission[lsel]
        light_area = area[lsel]
    else:  # keep shapes non-empty for jit friendliness
        z3 = np.zeros((1, 3), np.float32)
        light_p0 = light_p1 = light_p2 = z3
        light_normal = np.array([[0.0, 1.0, 0.0]], np.float32)
        light_emission = z3
        light_area = np.zeros((1,), np.float32)
        lsel = np.zeros((1,), np.int32)

    if textures is None:
        textures = np.zeros((1, 3), np.float32)

    root_min = bvh.bounds[0, 0:3]
    root_max = bvh.bounds[0, 3:6]
    radius = 0.5 * float(np.linalg.norm(root_max - root_min))

    mat_types = np.asarray(htab.type)  # table/htab built before the BVH
    tri_is_leaf_mat = mat_types[tri_mat] == 4  # MAT_LEAF
    if want_threaded:
        node_packed = _pack_nodes(bvh, tri_pack, tri_is_leaf_mat)
    else:
        node_packed = np.zeros((1, 8), np.float32)  # sentinel, never read
    tri_shade_row = _pack_shade_rows(htab, tri_n, tri_uv, tri_emission,
                                     tri_light, tri_mat, area)

    from cudapathtracer_tpu.scene import bvh8 as bvh8_mod
    policy = bvh8_policy or os.environ.get("TPT_BVH8_POLICY", "sah")
    bvh8 = bvh8_mod.collapse(bvh, tri_pack, tri_is_leaf_mat,
                             leaf_tris=bvh8_leaf_tris, policy=policy)

    # assemble the whole scene host-side into CONSOLIDATED blocks that
    # build_scene uploads with ONE batched jax.device_put (the reference's
    # analogous upload is the cudaMemcpy block, main.cu:484-557).
    t = tri_pack.shape[0]
    tcols = 94 if tri_is_leaf_mat.any() else 78
    tri_f32 = np.empty((t, tcols), np.float32)
    tri_f32[:, 0:9] = tri_pack
    tri_f32[:, 9:18] = tri_n.reshape(t, 9)
    tri_f32[:, 18:24] = tri_uv.reshape(t, 6)
    tri_f32[:, 24:27] = tri_emission
    tri_f32[:, 27] = area
    tri_f32[:, 28:76] = tri_shade_row
    tri_f32[:, 76] = np.asarray(tri_mat, np.int32).view(np.float32)
    tri_f32[:, 77] = np.asarray(tri_light, np.int32).view(np.float32)
    if tcols == 94:
        tri_f32[:, 78:87] = tri_n.reshape(t, 9)
        tri_f32[:, 87:90] = htab.albedo[tri_mat]
        tri_f32[:, 90] = htab.transmission[tri_mat]
        tri_f32[:, 91] = htab.ior[tri_mat]
        tri_f32[:, 92:94] = 0.0
    nl = light_p0.shape[0]
    light_f32 = np.empty((nl, 17), np.float32)
    light_f32[:, 0:3] = light_p0
    light_f32[:, 3:6] = light_p1
    light_f32[:, 6:9] = light_p2
    light_f32[:, 9:12] = light_normal
    light_f32[:, 12:15] = light_emission
    light_f32[:, 15] = light_area
    light_f32[:, 16] = np.asarray(lsel, np.int32).view(np.float32)

    f32 = lambda a: np.asarray(a, np.float32)
    node_packed = f32(node_packed)
    bvh8_table = f32(bvh8.table)
    scene = Scene(
        tri_f32=tri_f32,
        node_bounds=f32(bvh.bounds[0:1]),
        node_leaf=np.zeros((1, 2), np.int32),
        node_links=np.zeros((1, 2), np.int32),
        node_packed=node_packed,
        bvh8_table=bvh8_table,
        light_f32=light_f32,
        materials=table,
        textures=f32(textures),
        scene_radius=np.float32(radius),
        num_lights=num_lights,
        max_leaf_size=int(bvh.leaf[:, 1].max()),
        has_leaf_materials=bool(tri_is_leaf_mat.any()),
        has_trans_maps=bool(
            (np.asarray(table.trans_tex_start)[tri_mat] >= 0).any()),
        traversal=traversal,
        bvh8_leaf_tris=bvh8.leaf_tris,
        mat_type_mask=int(np.bitwise_or.reduce(
            np.int64(1) << np.unique(mat_types[tri_mat]).astype(np.int64))),
    )
    return scene, bvh


LEAF_MAT_FLAG = 1 << 30  # bit30 of a packed triangle id: material is MAT_LEAF


def _pack_nodes(bvh, tri_pack: np.ndarray, tri_is_leaf_mat: np.ndarray) -> np.ndarray:
    """Build the single-gather traversal table (see Scene.node_packed)."""
    m = bvh.num_nodes
    k = max(int(bvh.leaf[:, 1].max()), 1)
    width = 24 + 9 * k + k
    width = (width + 7) // 8 * 8
    packed = np.zeros((m, width), np.float32)
    packed[:, 0:6] = bvh.bounds
    packed[:, 6:14] = bvh.links[:, :, 0].astype(np.int32).view(np.float32)
    packed[:, 14:22] = bvh.links[:, :, 1].astype(np.int32).view(np.float32)
    packed[:, 22] = bvh.leaf[:, 1].astype(np.int32).view(np.float32)

    ids = np.full((m, k), -1, np.int32)
    first, count = bvh.leaf[:, 0], bvh.leaf[:, 1]
    for j in range(k):
        sel = count > j
        tidx = first[sel] + j
        packed[sel, 24 + 9 * j: 33 + 9 * j] = tri_pack[tidx]
        tid = tidx.astype(np.int32)
        tid = np.where(tri_is_leaf_mat[tidx], tid | LEAF_MAT_FLAG, tid)
        ids[sel, j] = tid
    packed[:, 24 + 9 * k: 24 + 9 * k + k] = ids.view(np.float32)
    return packed


def _pack_shade_rows(table, tri_n, tri_uv, tri_emission, tri_light,
                     tri_mat, tri_area) -> np.ndarray:
    """Build Scene.tri_shade_row (see the field comment for the layout)."""
    t = tri_mat.shape[0]
    row = np.zeros((t, 48), np.float32)
    iv = lambda a: np.asarray(a, np.int32).view(np.float32)
    m = tri_mat
    g = lambda name: np.asarray(getattr(table, name))[m]
    row[:, 0:9] = tri_n.reshape(t, 9)
    row[:, 9:15] = tri_uv.reshape(t, 6)
    row[:, 15:18] = tri_emission
    row[:, 18] = iv(tri_light)
    row[:, 19] = iv(tri_mat)
    row[:, 20] = iv(g("type"))
    row[:, 21:24] = g("albedo")
    row[:, 24] = g("roughness")
    row[:, 25:28] = g("eta")
    row[:, 28:31] = g("k")
    row[:, 31] = g("ior")
    row[:, 32] = g("transmission")
    row[:, 33] = iv(g("is_specular").astype(np.int32))
    row[:, 34] = iv(g("boundary").astype(np.int32))
    row[:, 35] = iv(g("thin_walled").astype(np.int32))
    row[:, 36:39] = g("absorption")
    row[:, 39] = iv(g("priority"))
    row[:, 40] = iv(g("tex_start"))
    row[:, 41] = iv(g("tex_width"))
    row[:, 42] = iv(g("tex_height"))
    row[:, 43] = iv(g("trans_tex_start"))
    row[:, 44] = iv(g("trans_tex_width"))
    row[:, 45] = iv(g("trans_tex_height"))
    row[:, 46] = tri_area
    return row
