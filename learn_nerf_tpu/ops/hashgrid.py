"""Multiresolution hash-grid encoding (Instant NGP, arXiv:2201.05989).

Semantics parity with the reference (``learn_nerf/instant_ngp.py:121-224``):

* per level, trilinear interpolation over the 8 cell corners of a virtual
  ``grid^3`` lattice normalized to the scene bbox,
* levels whose dense lattice fits the table (``grid^3 <= table_size``) index
  directly (x-major: ``x + g*(y + g*z)``); larger levels use the spatial
  hash ``x ^ (19349663*y) ^ (83492791*z) mod T`` in uint32 arithmetic,
* optional ``smooth`` mode shifts the lattice by half a cell
  (``0.5 + (g-2)*frac``) and applies smoothstep to the interpolation
  weights so the encoding is C1 — required for Ref-NeRF analytic normals
  (``instant_ngp.py:143-155``).

Shape discipline: corners are a broadcast axis (``[..., 8, 3]``) and each
level is one batched gather; gradients to the tables lower to XLA
scatter-adds (atomics on a GPU).  Hash models are accelerated by
evaluating fewer points (occupancy culling), not by reformulating the
lookups (docs/DESIGN.md section 3).
"""

from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

HASH_PRIME_Y = np.uint32(19_349_663)
HASH_PRIME_Z = np.uint32(83_492_791)

# The 8 cell corners as binary offsets, x fastest (parity with the loop
# nesting order in instant_ngp.py:161-176: x outer, z inner — order only
# matters for summation order, which is associative here).
_CORNERS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
    dtype=np.float32,
)


def corner_weights_and_coords(
    x: Array,
    grid_size: int,
    bbox_min: Array,
    bbox_max: Array,
    smooth: bool,
) -> Tuple[Array, Array]:
    """Trilinear corner lattice coordinates and interpolation weights.

    :param x: ``[..., 3]`` world-space points.
    :param grid_size: lattice resolution ``g``.
    :param bbox_min: ``[3]``.
    :param bbox_max: ``[3]``.
    :param smooth: half-cell shift + smoothstep weights.
    :return: ``(coords [..., 8, 3] uint32, weights [..., 8])``.
    """
    frac = jnp.clip((x - bbox_min) / (bbox_max - bbox_min), 0.0, 1.0)
    if smooth:
        findex = 0.5 + (grid_size - 2) * frac
    else:
        findex = (grid_size - 1) * frac
    floored = jnp.floor(findex)
    floored = jnp.minimum(floored, float(grid_size - 2))
    cf = findex - floored
    if smooth:
        cf = cf * cf * (3.0 - 2.0 * cf)

    offs = jnp.asarray(_CORNERS)  # [8, 3]
    coords = floored[..., None, :].astype(jnp.uint32) + offs[..., :, :].astype(
        jnp.uint32
    )
    # weight per axis: cf if corner offset 1 else (1 - cf)
    wpa = jnp.where(offs > 0, cf[..., None, :], 1.0 - cf[..., None, :])
    weights = jnp.prod(wpa, axis=-1)
    return coords, weights


def level_indices(coords: Array, grid_size: int, table_size: int) -> Array:
    """Table row index for integer lattice coordinates.

    Dense when the lattice fits; hashed otherwise (reference
    ``instant_ngp.py:178-204``, ``:211-224``).

    :param coords: ``[..., 3]`` uint32 lattice coordinates.
    :param grid_size: lattice resolution.
    :param table_size: hash table rows.
    :return: ``[...]`` int32 row indices.
    """
    cx = coords[..., 0]
    cy = coords[..., 1]
    cz = coords[..., 2]
    if grid_size**3 > table_size:
        idx = (cx ^ (HASH_PRIME_Y * cy) ^ (HASH_PRIME_Z * cz)) % np.uint32(table_size)
    else:
        g = np.uint32(grid_size)
        idx = cx + g * (cy + g * cz)
    return idx.astype(jnp.int32)


def dense_level_rows(grid_size: int, table_size: int) -> int:
    """Number of table rows a level allocates (dense lattice or hashed)."""
    return grid_size**3 if grid_size**3 <= table_size else table_size


def _level_groups(
    grid_sizes: Sequence[int], table_sizes: Sequence[int]
) -> List[Tuple[int, int]]:
    """Runs ``[i, j)`` of consecutive levels with identical (grid, table).

    The standard NGP schedule ``grid = 2^(4 + i//2)`` produces levels in
    PAIRS with the same lattice resolution and table size: their corner
    indices and interpolation weights are identical, so the pair can share
    ONE gather over a feature-concatenated ``[rows, 2F]`` table instead of
    two ``[rows, F]`` gathers: grouping halves the gather and scatter-add
    count of the hash encoding at identical numerics.  That this count is
    the dominant cost is a premise not yet measured on the H100
    (docs/DESIGN.md section 3).
    """
    groups: List[Tuple[int, int]] = []
    i = 0
    while i < len(grid_sizes):
        j = i + 1
        while (
            j < len(grid_sizes)
            and grid_sizes[j] == grid_sizes[i]
            and table_sizes[j] == table_sizes[i]
        ):
            j += 1
        groups.append((i, j))
        i = j
    return groups


def hash_grid_encode(
    tables: Sequence[Array],
    x: Array,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Array,
    bbox_max: Array,
    smooth: bool = False,
    fuse_levels: bool = False,
    group_levels: bool = True,
) -> Array:
    """Encode points with all hash-grid levels, concatenated.

    ``group_levels=True`` (default) shares one gather among consecutive
    levels with equal (grid, table) size — see :func:`_level_groups`;
    bit-identical to per-level gathers, ~half the gather/scatter count on
    the standard pairwise NGP schedule.

    ``fuse_levels=True`` runs ONE gather over the per-level tables
    concatenated with row offsets instead of L separate gathers.  Kept for
    experimentation but OFF by default: the end-to-end occupancy train
    step measured slower fused than per-group (premise not yet measured
    on the H100).

    :param tables: per-level ``[rows_l, F]`` feature tables.
    :param x: ``[..., 3]`` points.
    :param grid_sizes: per-level lattice resolutions.
    :param table_sizes: per-level maximum table rows.
    :param bbox_min: ``[3]``.
    :param bbox_max: ``[3]``.
    :param smooth: C1 interpolation mode.
    :return: ``[..., L * F]`` features.
    """
    if not (len(tables) == len(grid_sizes) == len(table_sizes)):
        # zip/slice below would silently drop the surplus levels — a model
        # quietly encoding with fewer levels than its parameter tables.
        raise ValueError(
            f"level lists disagree: {len(tables)} tables, "
            f"{len(grid_sizes)} grid_sizes, {len(table_sizes)} table_sizes"
        )
    for level, (table, g, t) in enumerate(zip(tables, grid_sizes, table_sizes)):
        rows = dense_level_rows(g, t)
        if table.shape[0] != rows:
            # The fused path gathers with promise_in_bounds over
            # concatenated tables: an undersized table would silently
            # read the NEXT level's rows (the non-fused path would NaN).
            raise ValueError(
                f"level {level}: table has {table.shape[0]} rows, but "
                f"grid {g} / table_size {t} implies {rows}"
            )
    if not fuse_levels:
        groups = (
            _level_groups(grid_sizes, table_sizes)
            if group_levels
            else [(i, i + 1) for i in range(len(tables))]
        )
        outs: List[Array] = []
        for i, j in groups:
            coords, weights = corner_weights_and_coords(
                x, grid_sizes[i], bbox_min, bbox_max, smooth
            )
            idx = level_indices(coords, grid_sizes[i], table_sizes[i])  # [..., 8]
            table = (
                tables[i] if j == i + 1 else jnp.concatenate(tables[i:j], axis=-1)
            )  # [rows, (j-i)*F]
            feats = jnp.take(table, idx, axis=0)  # [..., 8, (j-i)*F]
            outs.append(jnp.sum(weights[..., None] * feats, axis=-2))
        return jnp.concatenate(outs, axis=-1)

    lead = x.shape[:-1]
    levels = len(tables)
    f = tables[0].shape[-1]

    all_idx = []
    all_weights = []
    offset = 0
    for table, g, t in zip(tables, grid_sizes, table_sizes):
        coords, weights = corner_weights_and_coords(x, g, bbox_min, bbox_max, smooth)
        all_idx.append(level_indices(coords, g, t) + offset)  # [..., 8]
        all_weights.append(weights)
        offset += table.shape[0]

    big_table = jnp.concatenate(list(tables), axis=0)  # [sum rows, F]
    idx = jnp.stack(all_idx, axis=-2)  # [..., L, 8]
    weights = jnp.stack(all_weights, axis=-2)  # [..., L, 8]
    feats = big_table.at[idx].get(
        mode="promise_in_bounds"
    )  # [..., L, 8, F] — the single fused gather
    out = jnp.sum(weights[..., None] * feats, axis=-2)  # [..., L, F]
    return out.reshape(*lead, levels * f)
