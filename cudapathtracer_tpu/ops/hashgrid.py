"""Photon hash grid: sort-based build + bounded neighborhood queries.

Sort-based re-design of the reference's CUB-radix-sort hash grid
(deviceCode.cu:3067-3198): photons are hashed by quantized cell
(HashGridIndex primes, integratorUtilities.cuh:406-412), sorted with
jax.lax-backed argsort (the XLA equivalent of DeviceRadixSort::SortPairs),
and bucket boundaries become cell_start/cell_end tables built with
scatter-min/max instead of the reference's boundary-detection kernel.

Query-side difference (documented design choice): the reference scans a
3x3x3 neighborhood of cells sized mergeRadius with unbounded per-cell
loops; we use cells sized 2*mergeRadius and the 8-cell corner neighborhood
(the classic trick — the r-ball around any point is covered by the 2x2x2
block of 2r-cells it touches), with a STATIC per-cell photon cap so shapes
stay fixed for XLA. The exact distance^2 test makes both candidate supersets
equivalent up to cap truncation.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.utils import packing
from cudapathtracer_tpu.utils.math import next_prime

P1, P2, P3 = 73856093, 19349663, 83492791  # integratorUtilities.cuh:407-409

# Cap REWEIGHTING (round 5; read at trace time): the static max_per_cell
# cap visits only a cell's first `kept = min(count, cap)` photons where
# the reference's merge visits every photon unboundedly
# (deviceCode.cu:2992-3048). With a per-sample SALT randomizing the
# within-bucket order (build_grid), that prefix is a uniform random
# subset, so scaling each kept photon's contribution by count/kept makes
# the capped estimator an UNBIASED subsample of the reference's
# unbounded visit — the cap now trades variance, not energy. Set
# TPT_MERGE_REWEIGHT=0 for the legacy biased truncation (w=1, unsalted
# deterministic order).
_REWEIGHT = os.environ.get("TPT_MERGE_REWEIGHT", "1") != "0"


def _cell_weight(count, max_per_cell):
    if not _REWEIGHT:
        return jnp.ones(count.shape, jnp.float32)
    kept = jnp.maximum(jnp.minimum(count, max_per_cell), 1)
    return count.astype(jnp.float32) / kept.astype(jnp.float32)


# ONE-BRICK merge window (round 5; read at TRACE time like the toggles
# below): the standard query fetches n_wide=2 consecutive 8-photon bricks
# per cell because a cell's <=cap photon window starts at an arbitrary
# offset within the sorted buffer. The merge stage was gather-ROW bound on
# the previous accelerator (row width and BSDF slot work were free, total
# brick rows fetched were the cost), so instead this mode
# visits ONLY the photons of the single brick containing cell_start:
# kept = min(count, cap, 8 - (start & 7)). With the per-sample SALT
# randomizing each bucket's order (build_grid), those kept photons are a
# uniform random subset of the cell, so the count/kept reweighting keeps
# the estimator an exact-expectation subsample of the reference's
# unbounded per-cell visit (deviceCode.cu:2992-3048) — same argument as
# the cap reweighting above, with a salt-independent random window size.
# Cost: 8 brick rows per query instead of 16 (and no 2-brick rotate
# selects); price: more subsampling variance in dense cells (expected
# kept ~4.5 instead of 8 when count >= 8). Requires reweighting: with
# TPT_MERGE_REWEIGHT=0 the window would simply lose energy, so the mode
# silently disables itself there and on unsalted grids the subset is
# deterministic (still correct in expectation over photon order only).
def one_brick_active(max_per_cell: int) -> bool:
    # On by default (faster on the shipped VCM workload on the previous
    # accelerator; all photon-family gates green under the mode):
    # TPT_GRID_ONE_BRICK=0 restores the full 2-brick window.
    return (os.environ.get("TPT_GRID_ONE_BRICK", "1") != "0"
            and _REWEIGHT and 1 <= max_per_cell <= 8)


def _window_weight(count, kept):
    if not _REWEIGHT:
        return jnp.ones(count.shape, jnp.float32)
    return (count.astype(jnp.float32)
            / jnp.maximum(kept, 1).astype(jnp.float32))

# Packed photon row layout [8] (32 B/photon — the hash-grid analogue of the
# reference's compressed VCM vertex, objects.cuh:958-1157): pos(0:3) f32 —
# precision-critical for cell hashing and the exact distance^2 test;
# wi_oct(3) u32 octahedral direction toward the photon's previous vertex;
# beta halves (4: r|g, 5: b|0 — the reference's half3 beta codec,
# objects.cuh:1123-1133); d_vcm(6), d_vm(7) f32 — the recursive MIS weights
# stay full precision like PathBuffers'. The photon's surface normal is NOT
# stored: the merge estimator (deviceCode.cu:2968-3048) evaluates the BSDF
# entirely in the EYE vertex frame, so no consumer ever read it.
PHOTON_ROW = 8


class PhotonGrid(NamedTuple):
    rows: jax.Array        # [P8, 8] packed sorted photon rows
    #                        (pack_photons), padded to a multiple of 8 so
    #                        they reshape to [P8/8, 64] brick rows
    cell_se: jax.Array     # [T+1, 2] i32 (start, end) — FUSED into one
    #                        row table so each cell lookup is a single
    #                        8-byte row gather instead of two element
    #                        gathers (the merge query pays 8 of these
    #                        per lane)
    scene_min: jax.Array   # [3]
    cell_size: jax.Array   # scalar (= 2 * merge_radius)
    table_size: int        # static

    @property
    def cell_start(self):
        return self.cell_se[:, 0]

    @property
    def cell_end(self):
        return self.cell_se[:, 1]


def pack_photons(pos, wi, beta, d_vcm, d_vm):
    """Assemble packed photon rows [P, 8] from SoA components [P, ...]."""
    f32 = lambda u: jax.lax.bitcast_convert_type(u, jnp.float32)
    wi_oct = f32(packing.pack_oct(wi))
    b_rg = f32(packing.pack_half2(beta[:, 0], beta[:, 1]))
    b_b = f32(packing.pack_half2(beta[:, 2], jnp.zeros_like(beta[:, 2])))
    return jnp.concatenate(
        [pos, wi_oct[:, None], b_rg[:, None], b_b[:, None],
         d_vcm[:, None], d_vm[:, None]], axis=1)


def photon_fields(row):
    """Decode packed photon rows [N, 8] -> (pos [N,3], wi [N,3], beta [N,3],
    d_vcm [N], d_vm [N])."""
    u32 = lambda f: jax.lax.bitcast_convert_type(f, jnp.uint32)
    pos = row[:, 0:3]
    wi = packing.unpack_oct(u32(row[:, 3]))
    br, bg = packing.unpack_half2(u32(row[:, 4]))
    bb, _ = packing.unpack_half2(u32(row[:, 5]))
    beta = jnp.stack([br, bg, bb], axis=-1)
    return pos, wi, beta, row[:, 6], row[:, 7]


def _cell_of(pos, scene_min, cell_size):
    return jnp.floor((pos - scene_min) / cell_size).astype(jnp.int32)


def _hash_cells(cell, table_size):
    h = (cell[..., 0] * P1) ^ (cell[..., 1] * P2) ^ (cell[..., 2] * P3)
    return jnp.mod(h.astype(jnp.uint32), jnp.uint32(table_size)).astype(jnp.int32)


def build_grid(rows, valid, scene_min, merge_radius, table_size: int,
               salt=None) -> PhotonGrid:
    """Sort photon rows by cell hash and record bucket boundaries.

    rows: [P,8] packed (pack_photons); valid: [P] bool (invalid photons land in a sentinel bucket
    that queries never touch). table_size: static, e.g.
    next_prime(2 * max_photons) like the reference (deviceCode.cu:3290).

    salt (u32 scalar, optional): randomizes the WITHIN-bucket order per
    sample via an 8-bit multiplicative-hash tiebreak in the sort key —
    required for the cap-reweighting estimator (_cell_weight) to be
    unbiased: the capped prefix of each bucket is then a uniform random
    subset instead of a buffer-order (depth-correlated) one. Bucket
    membership and boundaries are unchanged.
    """
    p = rows.shape[0]
    cell_size = 2.0 * merge_radius
    h = _hash_cells(_cell_of(rows[:, 0:3], scene_min, cell_size), table_size)
    h = jnp.where(valid, h, table_size)  # sentinel bucket

    if salt is not None and _REWEIGHT:
        idx = jnp.arange(p, dtype=jnp.uint32)
        r = ((idx * jnp.uint32(2654435761))
             ^ jnp.asarray(salt, jnp.uint32)) * jnp.uint32(2246822519)
        key = h.astype(jnp.uint32) * jnp.uint32(256) + (r >> 24)
        order = jnp.argsort(key)
    else:
        order = jnp.argsort(h)
    h_sorted = h[order]
    rows_sorted = rows[order]
    # pad the row count to a multiple of 8 (+8 guard): fold_neighbors fetches
    # photons in 8-photon "bricks" (the [P,8] buffer reshaped [P/8, 64]) so
    # one wide gather replaces 8 narrow ones (gather cost was per ROW and
    # width-flat on the previous accelerator, so brick fetches cut the merge
    # stage's gather rows ~4x at cap 8). Pad rows land beyond every cell's
    # [start, end) range and are masked out arithmetically.
    pad = (-p) % 8 + 8
    rows_sorted = jnp.concatenate(
        [rows_sorted, jnp.zeros((pad, rows.shape[1]), rows.dtype)], axis=0)

    idx = jnp.arange(p, dtype=jnp.int32)
    cell_start = jnp.full((table_size + 1,), p, jnp.int32)
    cell_end = jnp.zeros((table_size + 1,), jnp.int32)
    cell_start = cell_start.at[h_sorted].min(idx)
    cell_end = cell_end.at[h_sorted].max(idx + 1)

    return PhotonGrid(rows=rows_sorted,
                      cell_se=jnp.stack([cell_start, cell_end], axis=-1),
                      scene_min=scene_min,
                      cell_size=cell_size, table_size=table_size)


def gather_neighbors(grid: PhotonGrid, query_pos, merge_radius,
                     max_per_cell: int, active=None):
    """Yield (packed photon_row [N,8], in_range [N]) for every candidate slot.

    Iterates the 8 corner-neighborhood cells x max_per_cell slots (static
    python loops -> fixed shapes). in_range already includes the exact
    distance^2 <= r^2 test. Intended use: the caller folds contributions
    over the yielded slots.
    """
    n = query_pos.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    r2 = merge_radius * merge_radius
    base = _cell_of(query_pos, grid.scene_min, grid.cell_size)
    # corner selection: which half of its 2r-cell the point is in
    frac = (query_pos - grid.scene_min) / grid.cell_size - base
    step = jnp.where(frac >= 0.5, 1, -1).astype(jnp.int32)

    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                off = jnp.stack([step[:, 0] * dx, step[:, 1] * dy,
                                 step[:, 2] * dz], axis=-1)
                h = _hash_cells(base + off, grid.table_size)
                se = grid.cell_se[h]           # one fused row gather
                start = se[..., 0]
                count = jnp.maximum(se[..., 1] - start, 0)
                for k in range(max_per_cell):
                    valid_slot = active & (k < count)
                    i = jnp.where(valid_slot, start + k, 0)
                    row = grid.rows[i]
                    diff = query_pos - row[:, 0:3]
                    d2 = jnp.sum(diff * diff, axis=-1)
                    in_range = valid_slot & (d2 <= r2)
                    yield row, in_range


def fold_neighbors(grid: PhotonGrid, query_pos, merge_radius,
                   max_per_cell: int, fold, init, active=None,
                   count_dropped: bool = False):
    """Rolled-control-flow variant of gather_neighbors: scan over the 8
    corner cells with an inner fori over slots, folding
    fold(carry, packed photon_row [N,8], in_range [N], w [N]) -> carry,
    where w is the cap-reweighting factor count/kept of the slot's cell
    (1.0 everywhere with TPT_MERGE_REWEIGHT=0; see _cell_weight).

    Identical candidate set to the generator form, but the fold body
    compiles ONCE instead of 8*max_per_cell times (inside the VCM eye-pass
    scan that is the difference between minutes and seconds of compile
    time), and each cell's slots are fetched with ONE batched gather
    instead of per-slot gathers (each gather has a fixed cost, which k
    separate gathers pay k times).

    With count_dropped=True returns (carry, dropped) where dropped is the
    total number of candidate photons the static max_per_cell cap
    truncated away across all active queries — an upper bound on in-range
    photons silently dropped (the reference's merge visits every photon in
    a cell unboundedly, deviceCode.cu:2968-3048; the cap is our
    static-shape concession, and this counter makes it observable instead
    of silent).
    """
    n = query_pos.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    r2 = merge_radius * merge_radius
    base = _cell_of(query_pos, grid.scene_min, grid.cell_size)
    frac = (query_pos - grid.scene_min) / grid.cell_size - base
    step = jnp.where(frac >= 0.5, 1, -1).astype(jnp.int32)

    # brick fetch geometry: a cell's first max_per_cell photons start at
    # an arbitrary offset within the 8-photon bricks, so they span at most
    # (cap + 7)//8 + 1 consecutive bricks; each brick is ONE wide gather
    # (64 floats) instead of 8 narrow ones — 4x fewer gathered rows at
    # cap 8, which dominated the VCM merge stage on the previous
    # accelerator.
    rw = grid.rows.shape[1]
    bricks = grid.rows.reshape(-1, 8 * rw)        # [P8/8, 64]
    one_brick = one_brick_active(max_per_cell)
    n_wide = 1 if one_brick else (max_per_cell + 7) // 8 + 1
    n_slots = 8 * n_wide
    max_brick = bricks.shape[0] - 1

    # ---- batched cross-cell gathers. Each gather has a fixed cost (the
    # previous accelerator did not pipeline them), so the per-cell
    # formulation's 8 x (cell_start + cell_end + n_wide bricks) = 32
    # sequential gathers paid it 32 times per fold call. Fusing them
    # across the cell axis ([8,N] index tensors) keeps the row traffic
    # identical but pays the fixed cost 2 + n_wide times instead.
    # Peak HBM for the pre-gathered bricks is 8*N*n_wide*256 B; huge
    # query batches (classic engine at big frames) fall back to the
    # per-cell gathers to bound it. Fold order (cells outer, ascending
    # slots inner) and every gathered value are unchanged either way —
    # the two paths are bit-identical.
    # NOTE: both env toggles are read at TRACE time (like
    # TPT_MEGA_MERGE_BATCH) — flipping them after a jitted caller cached
    # its trace has no effect until caches are cleared.
    batched = (8 * n * n_wide * 8 * rw * 4 <= (192 << 20)
               and os.environ.get("TPT_GRID_BATCH_GATHER", "1") != "0")
    aligned8 = (not one_brick and 1 <= max_per_cell <= 8
                and os.environ.get("TPT_GRID_ALIGN_ROTATE", "1") != "0")
    if batched:
        cs = jnp.arange(8, dtype=jnp.int32)
        dxyz = jnp.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1],
                         axis=-1)                                # [8,3]
        off_all = step[None, :, :] * dxyz[:, None, :]            # [8,N,3]
        h_all = _hash_cells(base[None, :, :] + off_all,
                            grid.table_size)                     # [8,N]
        se_all = grid.cell_se[h_all]           # one fused row gather
        start_all = se_all[..., 0]
        count_all = jnp.maximum(se_all[..., 1] - start_all, 0)
        w0_all = start_all >> 3
        rows_all = jnp.concatenate(
            [bricks[jnp.minimum(w0_all + k, max_brick)]
             for k in range(n_wide)], axis=-1)       # [8, N, n_wide*64]

    def cell_body(carry_drop, c):
        carry, dropped = carry_drop
        if batched:
            pick = lambda a: jax.lax.dynamic_index_in_dim(
                a, c, 0, keepdims=False)
            start, count = pick(start_all), pick(count_all)
            w0 = pick(w0_all)
            rows_cat = pick(rows_all)                # [N, n_wide*64]
        else:
            off = jnp.stack([step[:, 0] * ((c >> 0) & 1),
                             step[:, 1] * ((c >> 1) & 1),
                             step[:, 2] * ((c >> 2) & 1)], axis=-1)
            h = _hash_cells(base + off, grid.table_size)
            se = grid.cell_se[h]               # one fused row gather
            start = se[..., 0]
            count = jnp.maximum(se[..., 1] - start, 0)
            w0 = start >> 3
            rows_cat = jnp.concatenate(
                [bricks[jnp.minimum(w0 + k, max_brick)]
                 for k in range(n_wide)], axis=1)    # [N, n_wide*64]

        # re-slice the covering bricks into photon rows. Candidate set,
        # slot order (ascending photon index) and masking are identical
        # to the per-slot form; masked adds contribute exact 0.0 so the
        # fold is bit-identical to it.
        if one_brick:
            # visit only cell_start's own brick: kept is the part of the
            # (salt-randomized) bucket prefix that lands in it; the
            # count/kept weight below keeps the expectation exact.
            kept = jnp.minimum(jnp.minimum(count, max_per_cell),
                               8 - (start & 7))
        else:
            kept = jnp.minimum(count, max_per_cell)
        if aligned8:
            # rotate each lane's 2-brick window by (start & 7) rows with
            # 8 static-slice selects, so the cell's first <=8 photons
            # land in slots 0..7 and the fold body runs 8 slot
            # iterations instead of 16 — the fold body (3 BSDF evals on
            # the full sub-wavefront per slot) is the merge stage's
            # elementwise cost, and half its iterations were guaranteed-masked
            # padding. Same candidates in the same ascending order;
            # masked adds are exact 0.0 — bit-identical either way.
            a = (start & 7)[:, None]                 # [N,1]
            aligned = rows_cat[:, 0:8 * rw]
            for rr in range(1, 8):
                aligned = jnp.where(a == rr,
                                    rows_cat[:, rr * rw:(rr + 8) * rw],
                                    aligned)
            rows_k = aligned.reshape(
                n, 8, rw).transpose(1, 0, 2)         # [8, N, 8]
            ks = jnp.arange(8, dtype=jnp.int32)
            rel = jnp.broadcast_to(ks[:, None], (8, n))  # slot k == rel
            slot_ok = active[None, :] & (rel < kept[None, :])
            n_loop = 8
        else:
            rows_k = rows_cat.reshape(
                n, n_slots, rw).transpose(1, 0, 2)   # [S, N, 8]
            ks = jnp.arange(n_slots, dtype=jnp.int32)
            p_idx = (w0 << 3)[None, :] + ks[:, None]  # photon index [S,N]
            rel = p_idx - start[None, :]
            slot_ok = (active[None, :] & (rel >= 0)
                       & (rel < kept[None, :]))
            n_loop = n_slots

        wc = _window_weight(count, kept)

        def slot_body(k, carry):
            row = jax.lax.dynamic_index_in_dim(rows_k, k, 0,
                                               keepdims=False)
            valid_slot = jax.lax.dynamic_index_in_dim(slot_ok, k, 0,
                                                      keepdims=False)
            diff = query_pos - row[:, 0:3]
            d2 = jnp.sum(diff * diff, axis=-1)
            return fold(carry, row, valid_slot & (d2 <= r2), wc)

        carry = jax.lax.fori_loop(0, n_loop, slot_body, carry)
        if count_dropped:
            # == max(count - cap, 0) on the standard path; additionally
            # counts the brick-window truncation in one-brick mode (the
            # reweighting makes either a variance cost, not an energy
            # loss, but the counter keeps the subsampling observable).
            over = jnp.where(active, count - kept, 0)
            dropped = dropped + jnp.sum(over)
        return (carry, dropped), None

    (carry, dropped), _ = jax.lax.scan(
        cell_body, (init, jnp.zeros((), jnp.int32)),
        jnp.arange(8, dtype=jnp.int32))
    if count_dropped:
        return carry, dropped
    return carry


def neighbor_slots(grid: PhotonGrid, query_pos, merge_radius,
                   max_per_cell: int, active=None):
    """Materialize EVERY candidate photon for each query in one batch:
    returns (rows [M, N, 8], ok [M, N], wgt [M, N], dropped) with M =
    8 cells x max_per_cell aligned slots; wgt is the cap-reweighting
    factor of each slot's cell (_cell_weight). Requires
    max_per_cell <= 8.

    Rationale: at the compacted merge's sub-wavefront width (~3k lanes)
    the scan/fori fold runs 8x16 slot iterations whose per-op fixed overhead
    dominates. Callers should instead flatten [M,N] -> [M*N] and run the merge
    BSDF/MIS math ONCE at proper vector width, then reduce over the slot axis.
    `ok` already includes the exact distance^2 <= r^2
    test; `dropped` counts cap-truncated candidates exactly like
    fold_neighbors(count_dropped=True). Candidate set and per-slot
    ascending order match fold_neighbors; only the caller's summation
    order differs.
    """
    assert max_per_cell <= 8, "neighbor_slots requires max_per_cell <= 8"
    n = query_pos.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    r2 = merge_radius * merge_radius
    base = _cell_of(query_pos, grid.scene_min, grid.cell_size)
    frac = (query_pos - grid.scene_min) / grid.cell_size - base
    step = jnp.where(frac >= 0.5, 1, -1).astype(jnp.int32)

    rw = grid.rows.shape[1]
    bricks = grid.rows.reshape(-1, 8 * rw)        # [P8/8, 64]
    max_brick = bricks.shape[0] - 1

    cs = jnp.arange(8, dtype=jnp.int32)
    dxyz = jnp.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1],
                     axis=-1)                                # [8,3]
    off_all = step[None, :, :] * dxyz[:, None, :]            # [8,N,3]
    h_all = _hash_cells(base[None, :, :] + off_all,
                        grid.table_size)                     # [8,N]
    se_all = grid.cell_se[h_all]               # one fused row gather
    start_all = se_all[..., 0]
    count_all = jnp.maximum(se_all[..., 1] - start_all, 0)
    w0_all = start_all >> 3

    if one_brick_active(max_per_cell):
        # single-brick window (see one_brick_active): fetch ONLY the
        # brick containing cell_start — 8 brick rows per query instead
        # of 16 and no rotate selects; the kept = min(count, cap,
        # 8 - start&7) photons are a salt-uniform subset of the cell,
        # reweighted by count/kept so the expectation is unchanged.
        rows_cat = bricks[jnp.minimum(w0_all, max_brick)]    # [8,N,64]
        rows = rows_cat.reshape(8, n, 8, rw).transpose(
            0, 2, 1, 3).reshape(64, n, rw)                   # [M=64,N,8]
        a = start_all & 7                                    # [8,N]
        kept = jnp.minimum(jnp.minimum(count_all, max_per_cell),
                           8 - a)                            # [8,N]
        ks = jnp.arange(8, dtype=jnp.int32)
        rel = ks[None, :, None] - a[:, None, :]              # [8,8,N]
        ok = (active[None, None, :] & (rel >= 0)
              & (rel < kept[:, None, :])).reshape(64, n)
        diff = query_pos[None, :, :] - rows[:, :, 0:3]
        ok = ok & (jnp.sum(diff * diff, axis=-1) <= r2)
        wgt = jnp.broadcast_to(
            _window_weight(count_all, kept)[:, None, :],
            (8, 8, n)).reshape(64, n)
        over = jnp.where(active[None, :], count_all - kept, 0)
        return rows, ok, wgt, jnp.sum(over)

    rows_cat = jnp.concatenate(
        [bricks[jnp.minimum(w0_all + k, max_brick)] for k in (0, 1)],
        axis=-1)                                             # [8,N,128]

    # rotate each lane's 2-brick window by (start & 7) rows so the
    # cell's first <=8 photons land in slots 0..7 (static-slice selects)
    a = (start_all & 7)[:, :, None]                          # [8,N,1]
    aligned = rows_cat[:, :, 0:8 * rw]
    for rr in range(1, 8):
        aligned = jnp.where(a == rr,
                            rows_cat[:, :, rr * rw:(rr + 8) * rw],
                            aligned)                         # [8,N,64]
    rows = aligned.reshape(8, n, 8, rw)[:, :, :max_per_cell, :]
    rows = rows.transpose(0, 2, 1, 3).reshape(
        8 * max_per_cell, n, rw)                             # [M,N,8]

    ks = jnp.arange(max_per_cell, dtype=jnp.int32)
    lim = jnp.minimum(count_all, max_per_cell)               # [8,N]
    ok = (active[None, None, :]
          & (ks[None, :, None] < lim[:, None, :])).reshape(
              8 * max_per_cell, n)
    diff = query_pos[None, :, :] - rows[:, :, 0:3]
    ok = ok & (jnp.sum(diff * diff, axis=-1) <= r2)
    wgt = jnp.broadcast_to(_cell_weight(count_all, max_per_cell)
                           [:, None, :],
                           (8, max_per_cell, n)).reshape(
                               8 * max_per_cell, n)

    over = jnp.where(active[None, :],
                     jnp.maximum(count_all - max_per_cell, 0), 0)
    return rows, ok, wgt, jnp.sum(over)


def neighbor_slots_compact(grid: PhotonGrid, query_pos, merge_radius,
                           max_per_cell: int, cap_q: int, active=None):
    """Per-QUERY compacted candidate slots: the same 8-cell candidate
    stream as neighbor_slots (per-cell capped at max_per_cell, cell-major
    order, ascending photon index within a cell), but flattened per query
    and truncated to its first cap_q entries. Returns
    (rows [cap_q, N, 8], ok [cap_q, N], wgt [cap_q, N], dropped); wgt
    is the cap-reweighting factor of each slot's cell (_cell_weight; the
    per-QUERY cap_q truncation is counted, not reweighted).

    Rationale: neighbor_slots materializes 8*max_per_cell slots per query
    and the caller's merge math runs at that full slot width, yet typical
    occupancy is ~0-4 in-range photons — most of the wide BSDF work is
    masked padding. Compacting the stream to cap_q slots cuts the merge's
    elementwise work 8*max_per_cell/cap_q x and gathers thin [8]-float rows
    instead of 64-float bricks. The candidate SET equals neighbor_slots'
    whenever a query's total candidate count <= cap_q; beyond that the
    tail is truncated and counted in `dropped` (alongside the per-cell
    cap truncation, exactly like fold_neighbors' counter — the reference
    visits cells unboundedly, deviceCode.cu:2968-3048).

    The per-slot cell resolution is 8 compares + two one-hot sums over
    the cell axis — O(8*cap_q*N) elementwise, trivial next to the
    gathers it replaces.
    """
    n = query_pos.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    r2 = merge_radius * merge_radius
    base = _cell_of(query_pos, grid.scene_min, grid.cell_size)
    frac = (query_pos - grid.scene_min) / grid.cell_size - base
    step = jnp.where(frac >= 0.5, 1, -1).astype(jnp.int32)

    cs = jnp.arange(8, dtype=jnp.int32)
    dxyz = jnp.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1],
                     axis=-1)                                # [8,3]
    off_all = step[None, :, :] * dxyz[:, None, :]            # [8,N,3]
    h_all = _hash_cells(base[None, :, :] + off_all,
                        grid.table_size)                     # [8,N]
    se_all = grid.cell_se[h_all]               # one fused row gather
    start_all = se_all[..., 0]
    count_all = jnp.maximum(se_all[..., 1] - start_all, 0)

    if one_brick_active(max_per_cell):
        # compose with the one-brick window: the compact stream samples
        # the SAME per-cell subset (the salted-prefix run inside
        # cell_start's brick) with the same count/kept weights, so
        # CAPQ results stay consistent with neighbor_slots/fold_neighbors
        # under the mode. (The compact path gathers thin rows, so it
        # gains no bandwidth from it — this is consistency, not speed.)
        kept_all = jnp.minimum(jnp.minimum(count_all, max_per_cell),
                               8 - (start_all & 7))
    else:
        kept_all = jnp.minimum(count_all, max_per_cell)
    cnt = kept_all                                           # [8,N]
    cum = jnp.cumsum(cnt, axis=0)                            # [8,N]
    total = cum[7]                                           # [N]
    cum0 = jnp.concatenate([jnp.zeros((1, n), cum.dtype), cum[:-1]],
                           axis=0)                           # [8,N]

    ks = jnp.arange(cap_q, dtype=jnp.int32)                  # [cap_q]
    # cell of slot k = #cells whose cumulative count is <= k
    cmp = (cum[None, :, :] <= ks[:, None, None])             # [cap_q,8,N]
    c_idx = jnp.sum(cmp.astype(jnp.int32), axis=1)           # [cap_q,N]
    onehot = (c_idx[:, None, :] == cs[None, :, None])        # [cap_q,8,N]
    prev = jnp.sum(jnp.where(onehot, cum0[None], 0), axis=1)
    st = jnp.sum(jnp.where(onehot, start_all[None], 0), axis=1)
    p_idx = st + (ks[:, None] - prev)                        # [cap_q,N]
    ok = active[None, :] & (ks[:, None]
                            < jnp.minimum(total, cap_q)[None, :])

    rows = grid.rows[jnp.where(ok, p_idx, 0)]                # [cap_q,N,8]
    diff = query_pos[None, :, :] - rows[:, :, 0:3]
    ok = ok & (jnp.sum(diff * diff, axis=-1) <= r2)
    count_sel = jnp.sum(jnp.where(onehot, count_all[None], 0), axis=1)
    kept_sel = jnp.sum(jnp.where(onehot, kept_all[None], 0), axis=1)
    wgt = _window_weight(count_sel, kept_sel)                # [cap_q,N]

    over = jnp.where(active,
                     jnp.sum(count_all - kept_all, axis=0)
                     + jnp.maximum(total - cap_q, 0), 0)
    return rows, ok, wgt, jnp.sum(over)


def photon_table_size(max_photons: int) -> int:
    """nextPrime(2 * maxPhotons), the reference's sizing (deviceCode.cu:3290)."""
    return next_prime(2 * max_photons)
