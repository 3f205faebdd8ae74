"""Occupancy-grid accelerated renderer — the fast path.

Replaces the coarse/fine hierarchy (two full model evaluations over
64 + 192 samples per ray, ``learn_nerf/render.py:39-91``) with a single
field model evaluated only where the occupancy grid says matter exists:

1. stratify C cheap candidate ts per ray over the bbox range,
2. occupancy-test every candidate (one tiny gather per candidate — no
   field-model cost, no gradient),
3. compact K occupied candidates per ray, evenly strided over the whole
   occupied span (static shapes; ``acceleration.compact_occupied_strided``),
4. evaluate the field model on ``[N, K]`` points and composite, each
   survivor representing ``c/K`` candidate bins.

At inference, :meth:`OccupancyRenderer.render_rays_pooled` additionally
pools a whole tile's survivors into one static buffer (average-case model
cost) with optional grid-based early ray termination; see its docstring
and docs/DESIGN.md section 4.2.

At K=32 and C=192 this evaluates ~6x fewer field points per ray than the
reference's fine pass alone; for hash-grid models, whose cost is their
per-point gathers, the saving is nearly proportional.  Quality matches dense sampling
once the grid converges because skipped cells genuinely have ~zero density
(Instant NGP section 3; NerfAcc arXiv:2305.04966).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .acceleration import OccupancyGrid, OccupancyGridState, compact_occupied_strided
from .models.base import FieldModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import stratified_ts
from .ops.volume import average_aux, composite, composite_alpha, termination_weights

Array = jnp.ndarray


def _bracketed_block_words(
    widx_c: Array, bit_c: Array, table: Array, stride: int
) -> Tuple[Array, Array, Array]:
    """Answer per-column block-word lookups from strided probe gathers.

    Gathers ONE packed row (:func:`~.acceleration.pack_block_table`
    layout: 32 occupancy bits + block-max density) per ``stride`` columns
    and answers every column from whichever bracketing probe's word
    matches its block index; the rest is static indexing and elementwise
    work.  Shared by candidate selection (``block_gather_stride``) and
    span probing (``span_block_gather``).

    :param widx_c: ``[N, C]`` flat block-word index per column.
    :param bit_c: ``[N, C]`` bit index within the word.
    :param table: ``[nblocks, 2]`` packed table.
    :return: ``(bit, dmax, matched)``, each ``[N, C]`` — ``bit`` is the
        column's occupancy bit (valid where ``matched``), ``dmax`` the
        answering probe's block-max density, ``matched`` whether either
        bracketing probe shares the column's block (callers treat
        unmatched as occupied — conservative).
    """
    n_cand = widx_c.shape[1]
    probe_sel = np.arange(0, n_cand, stride)  # static
    n_probe = probe_sel.shape[0]
    widx_p = widx_c[:, probe_sel]
    rows = table[widx_p]  # [N, P, 2] — THE gather
    words_p = jax.lax.bitcast_convert_type(rows[..., 0], jnp.uint32)
    dmax_p = rows[..., 1]

    j0 = np.minimum(np.arange(n_cand) // stride, n_probe - 1)  # static
    j1 = np.minimum(j0 + 1, n_probe - 1)
    m0 = widx_c == widx_p[:, j0]
    m1 = widx_c == widx_p[:, j1]
    words_c = jnp.where(m0, words_p[:, j0], words_p[:, j1])
    dmax = jnp.where(m0, dmax_p[:, j0], dmax_p[:, j1])
    matched = m0 | m1
    bit = ((words_c >> bit_c.astype(jnp.uint32)) & jnp.uint32(1)).astype(
        jnp.bool_
    )
    return bit, dmax, matched


def min_span_candidates(
    resolution: int,
    span_pool_factor: int,
    bbox_min,
    bbox_max,
) -> int:
    """Minimum phase-1 probe count for conservative two-phase span
    selection: probe spacing must be <= half the SHORTEST supercell side
    over the worst-case bbox-diagonal chord (the dilation argument in
    :meth:`OccupancyRenderer._occupied_span`).  Reduces to
    ``ceil(2*sqrt(3)*rs)`` for a cubic bbox; anisotropic bboxes need
    more.  The ONE definition — the renderer's validation and any tool
    that wants to auto-size ``span_candidates`` must both call this.
    """
    rs = resolution // span_pool_factor
    span = np.asarray(bbox_max, np.float64) - np.asarray(bbox_min, np.float64)
    diag = float(np.linalg.norm(span))
    return math.ceil(2.0 * diag * rs / float(span.min()))


@dataclass(frozen=True)
class OccupancyRenderer:
    model: FieldModel
    grid: OccupancyGrid
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    candidates: int = 192
    samples: int = 32
    min_t_range: float = 1e-3
    # Two-phase hierarchical selection (inference lever; 0 = off): first
    # test `span_candidates` cheap midpoints against a CONSERVATIVE
    # max-pooled supergrid (factor `span_pool_factor`) to bound the
    # occupied span, then place all `candidates` inside that span — fewer
    # grid gathers per ray at FINER effective resolution along the
    # occupied region.  The span pads by one supercell diagonal so
    # corner-grazing supercells cannot clip it.  Needs
    # span_candidates >= 2 * (grid.resolution/span_pool_factor) * sqrt(3)
    # so coarse sampling cannot step over a supercell (64 at 128/8).
    span_candidates: int = 0
    span_pool_factor: int = 8
    # Block-word occupancy gathers (inference lever; 0 = off): gather ONE
    # packed 8-byte row — a 4x4x2 block's 32 occupancy bits + its max
    # density — at every k-th candidate, then answer each candidate's
    # occupancy from the bracketing probes' words (gathers are
    # count-bound, docs/DESIGN.md section 3, so one row per k candidates
    # replaces k per-cell gathers).  A candidate whose block matches
    # neither bracketing probe (a block-boundary corner inside one probe
    # gap — rare at k <= 4) conservatively counts OCCUPIED, so geometry is
    # never dropped; the transmittance prune sees the block-MAX density
    # instead of the per-cell value — both estimate the same EMA field,
    # but the max accumulates opacity faster, so with eps > 0 the prune
    # can cut later candidates earlier than the per-cell path (quality
    # pinned by the stride-4 eval row, docs/DESIGN.md 4.3c).  With the
    # prune off, stride 1 is bit-identical to the per-cell path (every
    # candidate is its own probe) — tested.
    block_gather_stride: int = 0
    # Same trick for the phase-1 SPAN probes (0 = off; requires
    # span_candidates > 0): the dilated supergrid is packed into block
    # words and probed at this stride.  A block-mismatch probe counts
    # occupied, which can only WIDEN the detected span (phase-2 still
    # occupancy-tests every candidate at full resolution), so
    # conservativeness is preserved by construction; stride 1 is
    # bit-identical to the per-cell span.  At the production geometry
    # (grid 128, factor 8, 64 probes) span probes are ~40M of the
    # frame's ~56M selection gathers once block_gather_stride=4 — this
    # is the next count-bound lever after it.  Degrades to per-cell span
    # probing (exact, tested) when the supergrid is too small to tile
    # into 4x4x2 blocks — at that size the probe table is tiny and the
    # lever is moot anyway.
    span_block_gather: int = 0

    def __post_init__(self):
        # The renderer bbox drives ray t-ranges and span probes; the
        # grid's bbox drives cell/block quantization.  If they disagree,
        # candidates quantize into border cells and the span-probe
        # conservativeness bound silently stops holding (occupied
        # supercells can be skipped, geometry rendering as background
        # with no error) — so disagreement is a constructor error.
        if tuple(map(float, self.bbox_min)) != tuple(
            map(float, self.grid.bbox_min)
        ) or tuple(map(float, self.bbox_max)) != tuple(
            map(float, self.grid.bbox_max)
        ):
            raise ValueError(
                f"OccupancyRenderer bbox {self.bbox_min}..{self.bbox_max} "
                f"must equal its grid's bbox "
                f"{self.grid.bbox_min}..{self.grid.bbox_max}"
            )

    def render_rays(
        self,
        key: jax.Array,
        rays: Array,
        params: Any,
        background: Array,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        tables: Optional[Dict[str, Array]] = None,
    ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        """Render rays with occupancy-culled sampling (fixed ``[N, K]``).

        Candidate selection is shared with the pooled path
        (:meth:`_select_candidates`), so the two-phase span lever and the
        grid-transmittance prune apply here too; both default off.

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param tables: optional precomputed :meth:`selection_tables`
            (per-frame callers hoist them out of their tile loop).
        :return: ``(out, aux_means)`` — out keys: ``outputs [N,3]``,
                 ``densities [N,K]``, ``alphas [N,1]``, ``coords [N,3]``,
                 ``weights [N,K+1]``, ``ts [N,K]``, ``sample_mask [N,K]``,
                 ``rgbs [N,K,3]``.
        """
        origins, dirs = rays[:, 0], rays[:, 1]
        cand_ts, occ, dt0, mask = self._select_candidates(
            key, rays, grid_state, transmittance_eps, tables=tables
        )

        sel_ts, sel_mask, delta_scale = compact_occupied_strided(
            cand_ts, occ, self.samples
        )

        points = origins[:, None, :] + dirs[:, None, :] * sel_ts[..., None]
        dirs_b = jnp.broadcast_to(dirs[:, None, :], points.shape)
        density, rgbs, aux = self.model.apply(dict(params=params), points, dirs_b)
        densities = density[..., 0] * sel_mask  # padding slots contribute 0

        # Every survivor represents delta_scale candidate bins (1 when the
        # ray has <= K occupied candidates, c/K on strided rays).
        dt = dt0 * delta_scale
        deltas = jnp.broadcast_to(dt, densities.shape)
        weights = termination_weights(densities, deltas)

        outputs = composite(weights, rgbs, background, mask)
        alphas = composite_alpha(weights, mask)
        coords = composite(weights, points, jnp.zeros(3, dtype=rgbs.dtype), mask)
        aux_means = average_aux(weights, aux, mask)

        return (
            dict(
                outputs=outputs,
                densities=densities,
                alphas=alphas,
                coords=coords,
                weights=weights,
                ts=sel_ts,
                sample_mask=sel_mask,
                rgbs=rgbs,
            ),
            aux_means,
        )

    def selection_tables(self, grid_state: OccupancyGridState) -> Dict[str, Array]:
        """Precompute the frame-invariant selection tables.

        The packed block-word table and the dilated span supergrid (plus
        its packed variant) are pure ~``resolution^3`` reductions of
        ``grid_state.densities``.  Built inline they sit inside
        :func:`render_frame_occupancy`'s ``lax.map`` body, where avoiding
        a per-tile recompute depends on XLA hoisting them out of the scan
        loop; building them once per frame here and passing the dict
        through ``tables=`` makes the saving certain.  Returns exactly
        the keys the configured levers need (empty when none are on) —
        every consumer rebuilds inline when its key is absent, so the
        parameter is always optional.
        """
        tables: Dict[str, Array] = {}
        densities = jax.lax.stop_gradient(grid_state.densities)
        if self.block_gather_stride > 0:
            from .acceleration import pack_block_table

            tables["block"] = pack_block_table(
                densities, self.grid.resolution, self.grid.threshold
            )
        if self.span_candidates > 0 and self.grid.resolution % self.span_pool_factor == 0:
            from .acceleration import (
                BLOCK_DIMS,
                dilate_supercells,
                pack_block_table,
                superpool_densities,
            )

            rs = self.grid.resolution // self.span_pool_factor
            sup = superpool_densities(
                densities, self.grid.resolution, self.span_pool_factor
            )
            tables["span_sup"] = dilate_supercells(sup, rs)
            if self.span_block_gather > 0 and all(rs % d == 0 for d in BLOCK_DIMS):
                tables["span_block"] = pack_block_table(
                    tables["span_sup"], rs, self.grid.threshold
                )
        return tables

    def _select_candidates(
        self,
        key: jax.Array,
        rays: Array,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        tables: Optional[Dict[str, Array]] = None,
    ):
        """THE pooled-path candidate selection, in one place.

        Stratified candidates, occupancy test (incl. warmup), optional
        grid-transmittance prune, bbox mask.  Both
        :meth:`render_rays_pooled` and :meth:`mean_sample_demand` route
        through here, so the demand estimator cannot drift from the
        selection it sizes.

        :return: ``(cand_ts [N,C], occ [N,C] bool, dt [N,1], mask [N])``.
        """
        bbox_min = jnp.asarray(self.bbox_min, dtype=jnp.float32)
        bbox_max = jnp.asarray(self.bbox_max, dtype=jnp.float32)
        origins, dirs = rays[:, 0], rays[:, 1]
        t_min, t_max, mask = ray_bbox_range(
            origins, dirs, bbox_min, bbox_max, self.min_t_range
        )
        if self.span_candidates > 0:
            t_min, t_max, span_hit = self._occupied_span(
                origins, dirs, t_min, t_max, grid_state, tables=tables
            )
            mask = mask & span_hit
        cand_ts = stratified_ts(key, t_min, t_max, self.candidates)
        cand_pts = origins[:, None, :] + dirs[:, None, :] * cand_ts[..., None]
        if self.block_gather_stride > 0:
            occ, d_grid = self._block_word_occupancy(
                cand_pts, grid_state, table=(tables or {}).get("block")
            )
        else:
            cell_idx = self.grid.cell_indices(cand_pts)
            d_grid = jax.lax.stop_gradient(grid_state.densities)[cell_idx]
            occ = self.grid.occupied_from_densities(grid_state, d_grid)
        dt = (t_max - t_min)[:, None] / self.candidates  # [N, 1]
        if transmittance_eps > 0.0:
            # The grid holds an EMA-max of true densities per cell, so the
            # scanned opacity is an estimate; a small eps only prunes
            # candidates behind essentially opaque matter.
            approx = jnp.where(occ, d_grid, 0.0) * dt
            acc_prev = jnp.cumsum(approx, axis=1) - approx
            occ = occ & (jnp.exp(-acc_prev) > transmittance_eps)
        occ = occ & mask[:, None]
        return cand_ts, occ, dt, mask

    def _block_word_occupancy(
        self,
        cand_pts: Array,
        grid_state: OccupancyGridState,
        table: Optional[Array] = None,
    ) -> Tuple[Array, Array]:
        """Candidate occupancy + prune densities from packed block words.

        One dynamic gather of ``ceil(C/k)`` 8-byte rows per ray replaces C
        per-cell gathers; all the bracketing/bit logic below is static
        indexing and elementwise work.  See the ``block_gather_stride``
        field docstring for the scheme and its conservativeness argument.

        :param cand_pts: ``[N, C, 3]`` candidate points.
        :return: ``(occ [N, C] bool, d_grid [N, C])`` — d_grid is the
            block-max density (0 where unoccupied), feeding the same
            transmittance prune as the per-cell path.
        """
        if table is None:
            from .acceleration import pack_block_table

            densities = jax.lax.stop_gradient(grid_state.densities)
            table = pack_block_table(
                densities, self.grid.resolution, self.grid.threshold
            )
        widx_c, bit_c = self.grid.block_indices(cand_pts)  # [N, C] each
        bit, d_c, matched = _bracketed_block_words(
            widx_c, bit_c, table, self.block_gather_stride
        )
        # Unmatched -> conservatively occupied, with the nearest probe's
        # block max standing in for the prune density.  Warmup mirrors
        # occupied_from_densities: every cell tests occupied.
        occ = jnp.where(matched, bit, True)
        occ = occ | (grid_state.step < self.grid.warmup_updates)
        d_grid = jnp.where(occ, d_c, 0.0)
        return occ, d_grid

    def _occupied_span(
        self,
        origins: Array,
        dirs: Array,
        t_min: Array,
        t_max: Array,
        grid_state: OccupancyGridState,
        tables: Optional[Dict[str, Array]] = None,
    ) -> Tuple[Array, Array, Array]:
        """Phase-1 of two-phase selection: tighten ``[t_min, t_max]`` to
        the occupied span per the max-pooled supergrid.

        Conservative by construction, including for corner-grazing rays
        whose chord through an occupied supercell is shorter than the
        probe spacing, and for anisotropic bboxes.  The argument (with
        ``s`` = the SHORTEST supercell side):

        * probe spacing ``w <= s/2`` (enforced below via the bbox
          diagonal and the min axis), so any chord's midpoint has a
          probe within ``w/2 <= s/4`` along the ray — within a quarter
          of every axis's supercell side;
        * the supergrid is max-DILATED by one cell (3^3), so that probe —
          at most a quarter-side from a point inside the occupied
          supercell along each axis, hence inside its one-cell
          neighborhood — tests positive;
        * the detected first/last probes are therefore within ``3w/2`` of
          every chord's endpoints, so their bin boundaries are within
          ``w`` — which the one-bin pad covers exactly.

        Dilation only ever *adds* detections, so interior holes and
        false-positive neighbors merely widen the span; phase-2
        candidates inside it are occupancy-tested against the
        FULL-resolution grid as usual.  During grid warmup every test
        passes, so the span degenerates to the full range (single-phase
        behavior).

        :return: ``(t_lo [N], t_hi [N], hit [N] bool)`` — rays with no
            occupied supercell return their original range and hit=False.
        """
        from .acceleration import dilate_supercells, superpool_densities

        factor = self.span_pool_factor
        if self.grid.resolution % factor:
            raise ValueError(
                f"span_pool_factor {factor} must divide the occupancy grid "
                f"resolution {self.grid.resolution}"
            )
        rs = self.grid.resolution // factor
        # Conservativeness precondition: probe spacing <= half the
        # SHORTEST supercell side, over the worst-case bbox-diagonal ray
        # (spacing <= diag/n).  The dilation argument (docstring) needs
        # the probe within a quarter of the shortest side of a chord
        # point along EVERY axis; deriving from the max side — the
        # natural cubic shortcut — would quietly break conservation on
        # anisotropic (e.g. LLFF-style) bboxes (formula shared via
        # :func:`min_span_candidates`).
        span = np.asarray(self.bbox_max, np.float64) - np.asarray(
            self.bbox_min, np.float64
        )
        needed = min_span_candidates(
            self.grid.resolution, factor, self.bbox_min, self.bbox_max
        )
        if self.span_candidates < needed:
            # An undersized probe count would silently skip thin occupied
            # supercells and render those rays as background — a silent
            # cap, which this renderer forbids.  The grid resolution comes
            # from the checkpoint, so tell the user both levers.
            raise ValueError(
                f"occ_span_candidates={self.span_candidates} is too few "
                f"probes for a {rs}^3 supergrid (occupancy grid "
                f"{self.grid.resolution}, span_pool_factor {factor}, "
                f"bbox span {tuple(span.tolist())}): "
                f"need >= {needed} to guarantee no occupied supercell is "
                f"skipped. Raise --occ_span_candidates or raise "
                f"--occ_span_pool_factor."
            )
        n_coarse = self.span_candidates
        sup = (tables or {}).get("span_sup")
        if sup is None:
            densities = jax.lax.stop_gradient(grid_state.densities)
            sup = superpool_densities(densities, self.grid.resolution, factor)
            sup = dilate_supercells(sup, rs)  # grazing-ray conservativeness

        # Midpoint samples of n_coarse equal bins (deterministic; the
        # conservative pad below covers corner-grazed supercells).
        i = (jnp.arange(n_coarse, dtype=jnp.float32) + 0.5) / n_coarse
        ts = t_min[:, None] + (t_max - t_min)[:, None] * i[None, :]  # [N, Cc]
        pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]

        # The supergrid is indexed by THE flat-index convention
        # (OccupancyGrid.cell_indices) at the pooled resolution — one
        # definition, so the probe can never desynchronize from
        # superpool_densities' layout.
        import dataclasses

        supergrid = dataclasses.replace(self.grid, resolution=rs)
        from .acceleration import BLOCK_DIMS

        block_ok = all(rs % d == 0 for d in BLOCK_DIMS)
        if self.span_block_gather > 0 and block_ok:
            # Packed block-word probing (span_block_gather field
            # docstring): a mismatched probe counts occupied, which only
            # WIDENS the span — phase 2 re-tests every candidate at full
            # resolution, so no geometry can be lost.  Warmup mirrors
            # occupied_from_densities.
            table = (tables or {}).get("span_block")
            if table is None:
                from .acceleration import pack_block_table

                table = pack_block_table(sup, rs, self.grid.threshold)
            widx, bitidx = supergrid.block_indices(pts)
            bit, _, matched = _bracketed_block_words(
                widx, bitidx, table, self.span_block_gather
            )
            occ = jnp.where(matched, bit, True)
            occ = occ | (grid_state.step < self.grid.warmup_updates)
        else:
            idx = supergrid.cell_indices(pts)
            occ = self.grid.occupied_from_densities(
                grid_state, sup[idx]
            )  # [N, Cc]

        hit = jnp.any(occ, axis=1)
        first = jnp.argmax(occ, axis=1)  # first occupied bin
        last = n_coarse - 1 - jnp.argmax(occ[:, ::-1], axis=1)
        w = (t_max - t_min) / n_coarse
        # One bin width of pad is exactly sufficient after dilation: the
        # first detected probe sits <= 3w/2 past any chord's entry, so its
        # bin START is <= entry + w (symmetric at the far end) — see the
        # docstring's argument.  Per-ray (w varies with the bbox range).
        pad = w
        t_lo = t_min + first.astype(jnp.float32) * w - pad
        t_hi = t_min + (last.astype(jnp.float32) + 1.0) * w + pad
        t_lo = jnp.maximum(t_lo, t_min)
        t_hi = jnp.minimum(t_hi, t_max)
        t_lo = jnp.where(hit, t_lo, t_min)
        t_hi = jnp.where(hit, t_hi, t_max)
        return t_lo, t_hi, hit

    def mean_sample_demand(
        self,
        key: jax.Array,
        rays: Array,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        tables: Optional[Dict[str, Array]] = None,
    ) -> Array:
        """Mean per-ray survivor count a pooled pass would see.

        Exactly :meth:`render_rays_pooled`'s candidate selection (shared
        code path) without touching the field model — used to size the
        ``"auto"`` pool budgets from a real batch.
        """
        _, occ, _, _ = self._select_candidates(
            key, rays, grid_state, transmittance_eps, tables=tables
        )
        c = jnp.sum(occ.astype(jnp.float32), axis=1)
        return jnp.mean(jnp.minimum(c, float(self.samples)))

    def render_rays_pooled(
        self,
        key: jax.Array,
        rays: Array,
        params: Any,
        background: Array,
        grid_state: OccupancyGridState,
        budget: int,
        transmittance_eps: float = 0.0,
        tables: Optional[Dict[str, Array]] = None,
    ) -> Dict[str, Array]:
        """Inference fast path: pooled compaction + approximate early
        ray termination.

        :func:`render_rays` evaluates a fixed ``[N, K]`` block, so rays
        with few occupied candidates still pay K model evaluations
        (padding slots do real hash gathers).  At inference the model
        cost is the whole frame time, so this path instead:

        1. prunes candidates whose *approximate* transmittance — an
           exclusive scan of the occupancy grid's own EMA densities,
           already gathered for the occupancy test — falls below
           ``transmittance_eps`` (early ray termination at zero model
           cost; set 0 to disable),
        2. caps survivors per ray at K (identical selection to
           :func:`render_rays`), then compacts the whole batch's
           survivors into one ``[budget]`` pool (cumsum slot assignment
           + scatter) so the field model runs on the tile's *actual*
           survivor count, not the ``N * K`` worst case.  Size the
           budget from measured average occupancy; on overflow the
           trailing rays of the tile lose their samples (slots assign
           ray-major) — the interleaved frame tiling spreads those
           across the image,
        3. composites exactly per ray with segmented scans
           (``segment_sum`` over the ray-major pool).

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param budget: static total pooled samples for the whole batch.
        :param transmittance_eps: default 0.0 = early ray termination OFF
            (lossless).  Pass ~1e-2 for the measured inference fast path
            (render CLIs plumb ``--occ_t_eps``); training should keep 0
            while the grid is young (docs/DESIGN.md section 3).
        :return: dict with ``outputs [N,3]``, ``alphas [N,1]``,
                 ``coords [N,3]``, ``aux`` (scalar aux-loss means), plus
                 the no-silent-caps counters ``selected`` (total surviving
                 samples the selection produced) and ``dropped`` (samples
                 that did not fit the pool — trailing rays' samples, 0
                 whenever ``budget >= selected``).
        """
        origins, dirs = rays[:, 0], rays[:, 1]
        n = origins.shape[0]
        cand_ts, occ, dt, mask = self._select_candidates(
            key, rays, grid_state, transmittance_eps, tables=tables
        )

        # Per-ray cap first (same strided-K semantics as render_rays),
        # bounding any one ray's pool appetite at K; if the pool still
        # overflows, the trailing rays of the tile drop (ray-major slots).
        sel_ts, sel_mask, delta_scale = compact_occupied_strided(
            cand_ts, occ, self.samples
        )

        # Global slot assignment: ray-major order keeps each ray's samples
        # contiguous and t-sorted inside the pool.
        flat_occ = sel_mask.reshape(-1)  # [N*K]
        slots = jnp.cumsum(flat_occ) - 1
        slots = jnp.where(flat_occ, slots, budget).astype(jnp.int32)

        def pool(values, fill):
            init = jnp.full((budget,) + values.shape[1:], fill, values.dtype)
            return init.at[slots].set(values, mode="drop")

        flat_ts = sel_ts.reshape(-1)
        flat_ray = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[:, None], sel_mask.shape
        ).reshape(-1)
        pool_t = pool(flat_ts, 0.0)
        # Invalid (never-written) slots form the pool's tail; give them
        # segment id n so segment ids stay sorted.
        pool_ray = pool(flat_ray, n)
        pool_valid = pool(jnp.ones_like(flat_occ), False)

        safe_ray = jnp.minimum(pool_ray, n - 1)
        origins_p = origins[safe_ray]
        dirs_p = dirs[safe_ray]
        points = origins_p + dirs_p * pool_t[:, None]
        density, rgbs, aux = self.model.apply(dict(params=params), points, dirs_p)
        dt_scaled = dt * delta_scale  # [N, 1]
        sig_dt = density[..., 0] * pool_valid * dt_scaled[safe_ray, 0]

        # Segmented exclusive scan via an id-reset associative operator.
        # (A global cumsum minus each ray's base is cheaper but subtracts
        # two numbers of tile-total optical-depth magnitude in f32 — the
        # within-ray exponent then carries ~total*1e-7 absolute error,
        # 0.5%+ transmittance noise for trailing rays of big pools.  The
        # reset scan keeps every partial sum at within-ray magnitude.
        # The operator is associative because pool_ray is sorted: slots
        # are assigned ray-major, so segments are contiguous.)
        def _seg_add(a, b):
            a_sum, a_id = a
            b_sum, b_id = b
            return jnp.where(a_id == b_id, a_sum + b_sum, b_sum), b_id

        acc_incl, _ = jax.lax.associative_scan(_seg_add, (sig_dt, pool_ray))
        acc_excl = acc_incl - sig_dt
        ray_total = jax.ops.segment_sum(
            sig_dt, pool_ray, num_segments=n + 1, indices_are_sorted=True
        )[:n]
        survive = jnp.exp(-acc_excl)
        weights = survive * (1.0 - jnp.exp(-sig_dt)) * pool_valid  # [budget]

        def ray_sum(values):
            return jax.ops.segment_sum(
                weights[:, None] * values,
                pool_ray,
                num_segments=n + 1,
                indices_are_sorted=True,
            )[:n]

        bg_weight = jnp.exp(-ray_total)[:, None]
        outputs = ray_sum(rgbs) + bg_weight * background[None, :]
        outputs = jnp.where(mask[:, None], outputs, background[None, :])
        alphas = jnp.where(mask[:, None], 1.0 - bg_weight, 0.0)
        coords = jnp.where(mask[:, None], ray_sum(points), 0.0)
        # Aux-loss means, same semantics as ops.volume.average_aux: per-ray
        # weighted sum, masked rays contribute 0, mean over rays.
        aux_means = {
            k: jnp.mean(jnp.where(mask, ray_sum(v[:, None])[:, 0], 0.0))
            for k, v in aux.items()
        }
        selected = jnp.sum(flat_occ.astype(jnp.int32))
        dropped = jnp.maximum(selected - budget, 0)
        return dict(
            outputs=outputs,
            alphas=alphas,
            coords=coords,
            aux=aux_means,
            selected=selected,
            dropped=dropped,
        )


def make_demand_fn(renderer: OccupancyRenderer, transmittance_eps: float = 0.0):
    """Jitted mean-per-ray-demand function, reusable across frames.

    Build this ONCE per session and pass it to :func:`resolve_auto_budget`
    for every view — rebuilding it per view would retrace the jit.
    """
    eps = transmittance_eps
    return jax.jit(
        lambda k, r, gs: renderer.mean_sample_demand(
            k, r, gs, transmittance_eps=eps
        )
    )


def resolve_auto_budget(
    renderer: OccupancyRenderer,
    grid_state: OccupancyGridState,
    rays: Array,
    transmittance_eps: float = 0.0,
    sample_rays: int = 8192,
    demand_fn=None,
    quiet: bool = False,
) -> int:
    """Per-ray pool budget from measured demand, for the render CLIs.

    Lossless sizing: mean measured demand * 1.3 margin, bucket-quantized
    (``acceleration.quantize_budget``), capped at K.  Demand is measured
    on an evenly strided subset of the frame's rays — the same global mix
    the interleaved tiles see — so the one-shot pass allocates
    ``O(sample_rays * C)`` instead of the whole frame's ``O(M * C)``.
    Callers rendering multiple views should re-resolve per view (the pass
    avoids the field model entirely, so it is nearly free with a cached
    ``demand_fn``) — a later camera pose can demand more than the first.
    """
    from .acceleration import auto_budget_from_demand

    # Ceil-stride: floor division would make the subset a raster-order
    # PREFIX of the frame (top rows only) whenever m is not an exact
    # multiple — geometry concentrated in the bottom rows would then be
    # invisible to the demand measurement and undersize the budget.
    stride = max(1, -(-rays.shape[0] // sample_rays))
    subset = rays[::stride][:sample_rays]
    if demand_fn is None:
        demand_fn = make_demand_fn(renderer, transmittance_eps)
    demand = float(demand_fn(jax.random.PRNGKey(0), subset, grid_state))
    budget = auto_budget_from_demand(demand, renderer.samples)
    if not quiet:
        print(
            f"auto render budget: {budget} samples/ray "
            f"(measured demand {demand:.1f})"
        )
    return budget


class OccupancyFrameSession:
    """Jitted frame rendering + the pool-budget policy, shared by the
    render-family CLIs (``render_nerf``, ``render_new_dataset``,
    ``eval_psnr`` and the orbit/interactive tools via ``RenderSession``).

    Budget policy (no silent caps):

    * ``budget_cfg="auto"``: demand is re-measured for EVERY frame (the
      pass reads only the occupancy grid, no field model — nearly free
      with the cached jitted demand fn), so a camera pose with higher
      per-ray demand than the first frame cannot silently overflow.  If a
      frame still drops samples (demand is a mean; margin can lose), the
      budget escalates to the next bucket and the frame re-renders until
      drop-free or at the per-ray cap K.
    * numeric ``budget_cfg``: the user asked for that exact budget
      (e.g. a timed run); drops are *reported* with the measured rate,
      never silently ignored, but the budget is respected.
    * ``budget_cfg=None``: fixed-K path, no pooling.

    One jitted frame program is cached per distinct budget; escalation
    cost is bounded by the bucket count.
    """

    def __init__(
        self,
        renderer: OccupancyRenderer,
        params: Any,
        background: Array,
        grid_state: OccupancyGridState,
        budget_cfg,
        tile_size: int,
        transmittance_eps: float = 0.0,
        include_depth_outputs: bool = False,
        mesh=None,
    ):
        self.renderer = renderer
        # Device-commit ONCE (replicated over the mesh when sharding).
        # These are passed to the jitted frame as ARGUMENTS, never closed
        # over: a closure capture lowers them as jaxpr constants, and a
        # baked field's grid (gigabytes at 384^3 x pack 4) then ships with
        # the program to the compiler as "captured constants" (regression
        # gate in tests/test_constants.py).
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            _put = lambda t: jax.device_put(t, NamedSharding(mesh, P()))
        else:
            _put = jax.device_put
        self._params = _put(params)
        self._background = _put(background)
        self._grid_state = _put(grid_state)
        self.budget_cfg = budget_cfg
        self._tile_size = tile_size
        self._eps = transmittance_eps
        self._depth = include_depth_outputs
        self._mesh = mesh
        self._frame_cache: Dict[Any, Any] = {}
        # Highest budget an overflow escalation ever reached: a floor for
        # later frames' auto resolution, so one underestimate does not
        # re-pay the drop -> escalate -> re-render cycle on every frame
        # of a multi-view run (eval_psnr, orbits).
        self._escalated_floor = 0
        self._announced_budget = None
        self._demand_fn = (
            make_demand_fn(renderer, transmittance_eps)
            if budget_cfg == "auto"
            else None
        )

    def _make_frame(self, budget):
        # params/background/grid_state are jit ARGUMENTS (see __init__):
        # the lowered program must stay constant-free regardless of how
        # large the field (e.g. a baked grid) is.
        def frame(key, rays, params, background, grid_state):
            return render_frame_occupancy(
                self.renderer,
                key,
                rays,
                params,
                background,
                grid_state,
                tile_size=min(self._tile_size, rays.shape[0]),
                budget_per_ray=budget,
                transmittance_eps=self._eps,
                include_depth_outputs=self._depth,
                mesh=self._mesh,
            )

        jitted = jax.jit(frame)

        def call(key, rays):
            return jitted(
                key, rays, self._params, self._background, self._grid_state
            )

        # Exposed so the captured-constants regression gate
        # (tests/test_constants.py) can .trace() the actual lowered
        # program and assert it is constant-free.
        call.jitted = jitted
        return call

    def render(self, key: jax.Array, rays: Array) -> Dict[str, Array]:
        """Render one frame's rays; returns the full output dict."""
        budget = self.budget_cfg
        if budget == "auto":
            budget = resolve_auto_budget(
                self.renderer,
                self._grid_state,
                rays,
                transmittance_eps=self._eps,
                demand_fn=self._demand_fn,
                quiet=True,
            )
            budget = max(budget, self._escalated_floor)
            if budget != self._announced_budget:
                # Announce on CHANGE only: a 200-view orbit would
                # otherwise print one identical line per frame and drown
                # the log lines that matter (escalations, drop warnings).
                print(f"auto render budget: {budget} samples/ray", flush=True)
                self._announced_budget = budget
        while True:
            if budget not in self._frame_cache:
                self._frame_cache[budget] = self._make_frame(budget)
            out = self._frame_cache[budget](key, rays)
            if budget is None:
                return out
            dropped = int(out["dropped"])
            if dropped == 0:
                return out
            selected = int(out["selected"])
            rate = dropped / max(selected, 1)
            if self.budget_cfg == "auto" and budget < self.renderer.samples:
                from .acceleration import next_budget_bucket

                new = next_budget_bucket(budget, self.renderer.samples)
                print(
                    f"pool overflow: dropped {dropped}/{selected} samples "
                    f"({rate:.2%}); escalating budget {budget} -> {new}"
                )
                budget = new
                self._escalated_floor = max(self._escalated_floor, new)
                continue
            print(
                f"WARNING: pool budget {budget} dropped {dropped}/{selected} "
                f"samples ({rate:.2%}) — trailing interleaved rays lost "
                "samples; raise --occ_budget_per_ray or pass 'auto'"
            )
            return out


def render_frame_occupancy(
    renderer: OccupancyRenderer,
    key: jax.Array,
    rays: Array,
    params: Any,
    background: Array,
    grid_state: OccupancyGridState,
    tile_size: int = 8192,
    budget_per_ray: Optional[float] = None,
    transmittance_eps: float = 0.0,
    include_depth_outputs: bool = False,
    mesh=None,
) -> Dict[str, Array]:
    """Render a whole frame through the occupancy fast path.

    One device program: rays are padded to tiles and scanned with
    ``lax.map``.  With ``budget_per_ray`` set, each tile uses
    :meth:`OccupancyRenderer.render_rays_pooled` with a pool of
    ``tile_size * budget_per_ray`` samples; otherwise the fixed-K
    :meth:`OccupancyRenderer.render_rays`.  With ``mesh``, tiles shard
    over the ``data`` axis via ``shard_map`` (replicated params, no
    collectives in the hot path).

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param transmittance_eps: 0.0 (default) disables early ray
        termination — lossless; the measured fast path passes ~1e-2
        (the render CLIs' ``--occ_t_eps``).
    :return: dict with ``outputs [M,3]`` (+ ``alphas``/``coords``); the
        pooled path also returns scalar ``selected``/``dropped`` sample
        counters summed over tiles (no silent caps: a nonzero ``dropped``
        means the budget was undersized for this frame).
    """
    from .render import pad_rays_to_tiles

    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(
        rays, tile_size, mesh, renderer.bbox_max
    )
    pooled = budget_per_ray is not None
    if pooled:
        # Interleave rays across tiles (tile g takes rays g, g+G, g+2G, ...)
        # so each tile sees the frame's global mix of empty and dense rays:
        # per-tile sample demand concentrates at the frame mean and a
        # budget of mean + margin drops (almost) nothing.  Raster-order
        # tiles are spatially coherent and can demand 2-3x the mean.
        rays_t = rays_p.reshape(tile_size, num_tiles, 2, 3).transpose(1, 0, 2, 3)
    else:
        rays_t = rays_p.reshape(num_tiles, tile_size, 2, 3)
    keys = jax.random.split(key, num_tiles)

    def tile_fn(params, background, grid_state, tables, args):
        k, r = args
        if budget_per_ray is not None:
            out = renderer.render_rays_pooled(
                k,
                r,
                params,
                background,
                grid_state,
                budget=int(tile_size * budget_per_ray),
                transmittance_eps=transmittance_eps,
                tables=tables,
            )
        else:
            out, _ = renderer.render_rays(
                k, r, params, background, grid_state,
                transmittance_eps=transmittance_eps, tables=tables,
            )
        res = dict(outputs=out["outputs"])
        if budget_per_ray is not None:
            res.update(selected=out["selected"], dropped=out["dropped"])
        if include_depth_outputs:
            res.update(alphas=out["alphas"], coords=out["coords"])
        return res

    def scan_tiles(keys, rays_t, params, background, grid_state):
        # Frame-invariant selection tables built ONCE, outside the tile
        # scan (inside shard_map they are replicated per-shard work).
        tables = renderer.selection_tables(grid_state)
        return jax.lax.map(
            lambda args: tile_fn(params, background, grid_state, tables, args),
            (keys, rays_t),
        )

    if mesh is None:
        tiled = scan_tiles(keys, rays_t, params, background, grid_state)
    else:
        from jax.sharding import PartitionSpec as P

        from .parallel.mesh import DATA_AXIS

        fn = jax.shard_map(
            scan_tiles,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(), P(), P()),
            out_specs=P(DATA_AXIS),
        )
        tiled = fn(keys, rays_t, params, background, grid_state)

    def deinterleave(v):
        if pooled:  # undo the tile interleave: [G, S, ...] -> raster order
            v = v.transpose(1, 0, *range(2, v.ndim))
        return v.reshape((rays_p.shape[0],) + v.shape[2:])[:m]

    out = {}
    for k, v in tiled.items():
        if k in ("selected", "dropped"):  # per-tile scalars -> frame total
            out[k] = jnp.sum(v)
        else:
            out[k] = deinterleave(v)
    return out
