"""Occupancy-grid accelerated sampling (the fast path).

The reference densely evaluates 64 coarse + 192 fine samples per ray
through the full model (``learn_nerf/render.py``), which for hash-grid
models means ~100M table gathers per 4096-ray step.  This module implements the
standard occupancy-grid acceleration (Instant NGP section 3 /
NerfAcc, arXiv:2305.04966) in a fully static-shape formulation:

* a binary occupancy grid over the scene bbox, maintained as an EMA of
  sampled model densities (updated every few steps outside the hot loop),
* per ray: generate cheap stratified *candidate* ts, test each candidate's
  cell occupancy (one small gather per candidate), then **compact K
  strided samples over the occupied span** (searchsorted-on-cumsum +
  gather, :func:`compact_occupied_strided`) — a fixed-size tensor of
  surviving samples, so the expensive field model runs on ``[N, K]``
  points instead of ``[N, 192]``.  (Keeping the first K occupied
  candidates instead fails: fog in front of a surface soaks up all K
  samples; see docs/DESIGN.md section 3.)

Everything is jit-friendly: no dynamic shapes, no host round-trips.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

BIG = 1e9


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class OccupancyGridState:
    """EMA density estimates per cell, flattened ``[resolution^3]``."""

    densities: Array
    step: Array  # int32 update counter

    replace = dataclasses.replace


@dataclass(frozen=True)
class OccupancyGrid:
    """Static configuration for the occupancy grid."""

    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    resolution: int = 128
    decay: float = 0.95
    # Density threshold above which a cell counts as occupied.  Instant NGP
    # uses 0.01 * 1024 / sqrt(3) / diag in its unit parameterization; for
    # bbox scenes a small absolute density works (sigma*delta ~ opacity).
    threshold: float = 0.01
    # For the first ``warmup_updates`` grid updates every cell tests
    # occupied and decay is suppressed (updates only max densities in).
    # Guards against the young-model failure loop: a true surface whose
    # density the model has not yet raised above ``threshold`` would
    # otherwise cull, stop receiving ray samples, and never recover
    # (refreshes read the model, which only learns where samples fall).
    # 16 updates x the training loop's default update_interval 16 = 256
    # unbiased steps, matching Instant NGP's warmup.
    warmup_updates: int = 16

    def init(self) -> OccupancyGridState:
        """All cells start occupied, but only just (2x threshold): once the
        warmup window passes, an empty cell culls after
        ~log(0.5)/log(decay) updates (~14 at decay 0.95) instead of the
        ~90 a 1.0 init would need against a 0.01 threshold.  Decay is
        suppressed during warmup, so cells the partial refresh never
        visited leave warmup still at 2x threshold with the full ~14-update
        grace ahead of them."""
        n = self.resolution**3
        return OccupancyGridState(
            densities=jnp.full((n,), 2.0 * self.threshold, dtype=jnp.float32),
            step=jnp.zeros((), dtype=jnp.int32),
        )

    def cell_indices(self, x: Array) -> Array:
        """Flat cell index for each point, ``[...]`` int32."""
        cell = self._cell_coords(x)
        r = self.resolution
        return cell[..., 0] + r * (cell[..., 1] + r * cell[..., 2])

    def _cell_coords(self, x: Array) -> Array:
        """Integer (x, y, z) cell coordinates — the ONE quantization rule
        (cell_indices and the block-word path must agree bit-exactly)."""
        bbox_min = jnp.asarray(self.bbox_min, dtype=jnp.float32)
        bbox_max = jnp.asarray(self.bbox_max, dtype=jnp.float32)
        frac = jnp.clip((x - bbox_min) / (bbox_max - bbox_min), 0.0, 1.0 - 1e-7)
        return (frac * self.resolution).astype(jnp.int32)

    def block_indices(self, x: Array) -> Tuple[Array, Array]:
        """(flat block-word index, bit index) per point for the packed
        occupancy table (:func:`pack_block_table`).  Same quantization as
        :meth:`cell_indices`."""
        cell = self._cell_coords(x)
        dx, dy, dz = BLOCK_DIMS
        r = self.resolution
        nbx, nby = r // dx, r // dy
        widx = (
            cell[..., 0] // dx
            + nbx * (cell[..., 1] // dy + nby * (cell[..., 2] // dz))
        )
        bit = (
            cell[..., 0] % dx
            + dx * (cell[..., 1] % dy)
            + dx * dy * (cell[..., 2] % dz)
        )
        return widx, bit

    def occupied_from_densities(
        self, state: OccupancyGridState, d: Array
    ) -> Array:
        """Occupancy test on already-gathered cell densities.

        All-true while ``state.step < warmup_updates`` (see the field
        docstring); thereafter a threshold test on the EMA densities.
        The single definition of the warmup-or-threshold rule — every
        occupancy consumer (renderer, pooled paths, demand estimator)
        must route through here.
        """
        return (d > self.threshold) | (state.step < self.warmup_updates)

    def occupied(self, state: OccupancyGridState, x: Array) -> Array:
        """Boolean occupancy per point (stop-gradient semantics)."""
        idx = self.cell_indices(x)
        d = jax.lax.stop_gradient(state.densities)[idx]
        return self.occupied_from_densities(state, d)

    def state_from_checkpoint(self, params: dict) -> OccupancyGridState:
        """Grid state for rendering from a params checkpoint.

        A checkpointed grid (``occupancy_densities`` present) is trained:
        mark it past warmup so culling applies.  Otherwise fall back to
        :meth:`init` (everything occupied) at step 0.  Use this instead
        of hand-assembling the state — forgetting the step marking
        silently disables culling (or, at step 0, re-enters warmup).
        """
        if "occupancy_densities" in params:
            # The density vector's own length is the ground truth for the
            # checkpointed resolution — the occupancy_resolution key is
            # newer than some checkpoints, and a legacy mismatch must not
            # slip past just because the key is absent.
            n = int(np.size(params["occupancy_densities"]))
            ckpt_res = int(round(n ** (1.0 / 3.0)))
            ckpt_res = int(params.get("occupancy_resolution", ckpt_res))
            if ckpt_res**3 != n:
                raise ValueError(
                    f"corrupt occupancy grid: {n} densities is not a cube "
                    f"of the recorded resolution {ckpt_res}"
                )
            if ckpt_res != self.resolution:
                # A 256^3 density vector indexed with 128-stride
                # cell_indices reads garbage cells and can cull real
                # surfaces — refuse instead.  (The render CLIs avoid this
                # by letting the checkpointed resolution win,
                # scripts/common.py; the train-resume path builds the grid
                # from flags and must match.)
                raise ValueError(
                    f"checkpoint occupancy grid is {ckpt_res}^3 but this "
                    f"grid is configured {self.resolution}^3; pass "
                    f"--occ_grid {ckpt_res} to resume this checkpoint"
                )
            return OccupancyGridState(
                densities=jnp.asarray(params["occupancy_densities"]),
                step=jnp.asarray(self.warmup_updates, jnp.int32),
            )
        return self.init()

    def cell_positions(self, key: jax.Array, ids: Array) -> Array:
        """World-space positions of cells ``ids``, jittered within the cell."""
        r = self.resolution
        coords = jnp.stack([ids % r, (ids // r) % r, ids // (r * r)], axis=-1)
        jitter = jax.random.uniform(key, coords.shape)
        bbox_min = jnp.asarray(self.bbox_min, dtype=jnp.float32)
        bbox_max = jnp.asarray(self.bbox_max, dtype=jnp.float32)
        frac = (coords.astype(jnp.float32) + jitter) / r
        return bbox_min + frac * (bbox_max - bbox_min)

    def update(
        self,
        state: OccupancyGridState,
        model,
        params: Any,
        key: jax.Array,
        num_cells: Optional[int] = None,
        num_samples: int = 1,
    ) -> OccupancyGridState:
        """One EMA update (Instant NGP rule, partial-sampling variant).

        All cells decay by ``decay``; a random subset of ``num_cells``
        (default: all) is re-evaluated through the model and maxed in:
        ``d[c] <- max(decay * d[c], density(jittered sample in c))``.
        Partial updates keep the amortized cost negligible — unvisited
        dense cells survive ~``log(threshold)/log(decay)`` updates before
        a refresh is needed.  Call under jit every N training steps.

        ``num_samples`` jittered points per cell (max taken): a single
        sample misses a thin density shell inside the cell with
        probability ``1 - shell_fraction`` per refresh, and once the
        model sharpens (late training), a missed surface cell decays,
        culls, and stops receiving ray samples — measured as a loss
        excursion from ~5e-5 to ~5e-3 over the last ~70 of 1600 cosine
        steps.  S samples drop the miss probability exponentially; the
        refresh runs off the hot path (every ``update_interval`` steps),
        so S=4 costs ~4x a negligible amount.  ``num_samples=1``
        reproduces the original key stream bit-for-bit.
        """
        cell_key, jitter_key = jax.random.split(key)
        n = self.resolution**3
        if num_cells is None or num_cells >= n:
            ids = jnp.arange(n, dtype=jnp.int32)
        else:
            ids = jax.random.randint(cell_key, (num_cells,), 0, n)

        def density_at(jkey):
            pts = self.cell_positions(jkey, ids)
            dirs = jnp.zeros_like(pts)
            d, _, _ = model.apply(dict(params=params), pts, dirs)
            return jax.lax.stop_gradient(d[..., 0])

        if num_samples <= 1:
            density = density_at(jitter_key)
        else:
            density = jnp.max(
                jnp.stack(
                    [
                        density_at(jax.random.fold_in(jitter_key, s))
                        for s in range(num_samples)
                    ]
                ),
                axis=0,
            )

        # No decay during warmup: partial refreshes may not visit a cell at
        # all in the warmup window, and an unvisited cell must leave warmup
        # at its init value, not eroded below threshold.
        decay = jnp.where(state.step < self.warmup_updates, 1.0, self.decay)
        decayed = state.densities * decay
        densities = decayed.at[ids].max(density)
        return OccupancyGridState(densities=densities, step=state.step + 1)


def superpool_densities(densities: Array, resolution: int, factor: int) -> Array:
    """Max-pool the flat ``[resolution^3]`` cell densities by ``factor``.

    A supercell's value is the max over its ``factor^3`` children, so a
    threshold test on the pooled grid is CONSERVATIVE: occupied children
    can never hide.  Flat index convention matches
    :meth:`OccupancyGrid.cell_indices` (``x + r*(y + r*z)``) at the
    pooled resolution.
    """
    r, f = resolution, factor
    rs = r // f
    cube = densities.reshape(rs, f, rs, f, rs, f)  # [z, y, x] blocks
    return cube.max(axis=(1, 3, 5)).reshape(-1)


#: Cells per packed occupancy word, (x, y, z).  4*4*2 = 32 cells = one
#: uint32: packing a whole block's occupancy plus its max density into ONE
#: 8-byte row lets a single gather answer the occupancy test for every
#: candidate that lands in the block (premise that gather count sets the
#: cost: not yet measured on the H100, docs/DESIGN.md section 3).
BLOCK_DIMS = (4, 4, 2)


def pack_block_table(densities: Array, resolution: int, threshold: float) -> Array:
    """Pack flat ``[r^3]`` cell densities into a ``[r^3/32, 2]`` float32
    gather table: column 0 = the block's 32 occupancy bits (``d >
    threshold``) bitcast from uint32, column 1 = the block's max density
    (drives the approximate-transmittance prune).

    Block flat index = ``bx + (r/4)*(by + (r/4)*bz)``; bit index =
    ``x%4 + 4*(y%4) + 16*(z%2)`` — both produced by
    :meth:`OccupancyGrid.block_indices`, the only other place that knows
    this layout.  Cheap elementwise/reduce work (~r^3 elements), so
    callers recompute it inside the jitted program instead of threading a
    cache through the API.
    """
    r = resolution
    dx, dy, dz = BLOCK_DIMS
    if r % dx or r % dy or r % dz:
        raise ValueError(
            f"occupancy grid resolution {r} is not divisible by the "
            f"block dims {BLOCK_DIMS} (block-word selection needs it)"
        )
    # Flat layout x-fastest -> the [z, y, x] cube (same as superpool).
    cube = densities.reshape(r // dz, dz, r // dy, dy, r // dx, dx)
    bits = (cube > threshold).astype(jnp.uint32)
    zi = jnp.arange(dz, dtype=jnp.uint32)
    yi = jnp.arange(dy, dtype=jnp.uint32)
    xi = jnp.arange(dx, dtype=jnp.uint32)
    weight = (
        jnp.uint32(1)
        << (
            xi[None, None, :]
            + dx * yi[None, :, None]
            + dx * dy * zi[:, None, None]
        )
    )  # [dz, dy, dx]
    words = jnp.sum(
        bits * weight[:, None, :, None, :], axis=(1, 3, 5), dtype=jnp.uint32
    )  # [bz, by, bx]
    dmax = cube.max(axis=(1, 3, 5))  # [bz, by, bx]
    table = jnp.stack(
        [
            jax.lax.bitcast_convert_type(words.reshape(-1), jnp.float32),
            dmax.reshape(-1),
        ],
        axis=-1,
    )
    return table  # [nblocks, 2] float32; flatten order bx-fastest


def dilate_supercells(sup: Array, rs: int) -> Array:
    """Max-dilate flat ``[rs^3]`` supercell densities by one cell (3^3).

    Used by two-phase span selection so that a probe point landing in a
    supercell *adjacent* to an occupied one still tests positive.  This is
    what makes phase-1 conservative for corner-grazing rays: with probe
    spacing <= half a supercell side, every chord through an occupied
    supercell — however short — has a probe within a quarter-side of it,
    i.e. within the dilated neighborhood (occ_render._occupied_span has
    the full argument).  Same flat layout as :func:`superpool_densities`.
    """
    cube = sup.reshape(rs, rs, rs)
    cube = jax.lax.reduce_window(
        cube,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(3, 3, 3),
        window_strides=(1, 1, 1),
        padding="SAME",
    )
    return cube.reshape(-1)


#: Quantized per-ray pool budgets for "auto" modes: resolved budgets snap
#: up to one of these, so distinct compiled programs are bounded by the
#: few buckets a run crosses.
AUTO_BUDGET_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

#: Safety margin over the measured mean per-ray demand for "auto" pool
#: sizing — ONE policy for training (train._resolve_pool_budget) and
#: rendering (occ_render.resolve_auto_budget).
AUTO_BUDGET_MARGIN = 1.3


def auto_budget_from_demand(demand: float, cap: int) -> int:
    """Measured mean per-ray demand -> quantized budget (margin applied)."""
    return quantize_budget(demand * AUTO_BUDGET_MARGIN, cap)


def quantize_budget(per_ray: float, cap: int) -> int:
    """Snap a measured per-ray demand up to the next budget bucket, capped
    at ``cap`` (the per-ray sample limit K).

    The cap is the FINAL bucket: demand above the largest tabulated bucket
    keeps snapping up through geometrically extended buckets (96, 128,
    192, ... — same 1.5x/1.33x ladder, so distinct compiled programs stay
    bounded even with ``cap`` > 64) instead of silently returning a
    bucket below demand — sizing stays lossless whenever ``cap`` itself
    is enough (K per-ray samples can never demand more than K slots each).
    """
    for b in AUTO_BUDGET_BUCKETS:
        if b >= per_ray:
            return min(b, cap)
    # Extend the ladder geometrically above the table: alternate x1.5 /
    # x1.33 like the tabulated tail (48, 64, 96, 128, 192, 256, ...).
    b = AUTO_BUDGET_BUCKETS[-1]
    while b < per_ray and b < cap:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, cap)


def next_budget_bucket(budget: int, cap: int) -> int:
    """The next bucket above ``budget`` (for overflow escalation), capped."""
    for b in AUTO_BUDGET_BUCKETS:
        if b > budget:
            return min(b, cap)
    b = max(budget, AUTO_BUDGET_BUCKETS[-1])
    b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, cap)


def compact_occupied_strided(
    ts: Array,
    occupied: Array,
    count: int,
) -> Tuple[Array, Array, Array]:
    """Select ``count`` occupied candidates per ray, evenly strided.

    Keeping the *first* K occupied
    candidates truncates coverage on rays with more than K occupied
    cells: everything behind the K-th occupied cell is never sampled.
    During training that is a failure loop — low-density "fog" cells in
    front soak up all K samples, the real surface behind them never gets
    gradient, so the fog never clears.  Here rays with ``c > count``
    occupied candidates instead keep every ``c/count``-th one, covering the
    whole occupied span; each kept sample then represents ``c/count``
    candidate bins, returned as a per-ray delta scale for compositing.
    Rays with ``c <= count`` keep all occupied candidates exactly
    (identical to keeping the first K).

    :param ts: ``[N, C]`` sorted candidate positions.
    :param occupied: ``[N, C]`` bool.
    :param count: K survivors per ray (static).
    :return: ``(sel_ts [N, K], sel_mask [N, K], delta_scale [N, 1])`` —
             valid entries are t-sorted and lead each row.
    """
    n, _ = ts.shape
    cum = jnp.cumsum(occupied.astype(jnp.int32), axis=1)  # [N, C]
    c = cum[:, -1:]  # [N, 1] occupied count
    k = jnp.arange(count, dtype=jnp.int32)[None, :]  # [1, K]
    # Rank of the candidate each slot should take: k when c <= K (first-K
    # semantics), floor(k*c/K) when c > K (even stride over the span).
    ranks = k * jnp.maximum(c, count) // count  # [N, K]
    sel_mask = ranks < c
    # Index of the (rank+1)-th occupied candidate: first position where the
    # running count exceeds the rank.  cum is row-wise non-decreasing.
    idx = jax.vmap(jnp.searchsorted)(cum, jnp.minimum(ranks + 1, c))
    idx = jnp.minimum(idx, ts.shape[1] - 1)
    sel_ts = jnp.take_along_axis(ts, idx, axis=1)
    delta_scale = jnp.maximum(c.astype(ts.dtype) / count, 1.0)
    return sel_ts, sel_mask, delta_scale
