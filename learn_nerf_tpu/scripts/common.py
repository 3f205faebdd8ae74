"""Shared CLI helpers: model factory and flag groups.

Flag and hyperparameter parity with the reference
(``learn_nerf/scripts/train_nerf.py:136-170``): ``--instant_ngp`` /
``--ref_nerf`` select the model family; the NGP hierarchy uses a 6-level
coarse / 16-level fine hash grid with ``table_size=2^18`` and grid sizes
``2^(4 + i//2)``, and Adam ``eps=1e-15, b2=0.99``; Ref-NeRF uses
``sh_degree=4``.
"""

import argparse
from functools import partial
from typing import Any, Dict, Tuple

from ..data.dataset import ModelMetadata
from ..models import (
    FieldModel,
    InstantNGPModel,
    InstantNGPRefNeRFModel,
    NeRFModel,
    RefNeRFModel,
)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--instant_ngp", action="store_true")
    parser.add_argument("--ref_nerf", action="store_true")
    parser.add_argument(
        "--bf16",
        action="store_true",
        help="run the model MLPs in bfloat16 (params stay f32)",
    )


def add_occupancy_args(parser: argparse.ArgumentParser) -> None:
    """Flags for the occupancy-grid fast path (no reference counterpart —
    the reference always dense-samples)."""
    parser.add_argument(
        "--occupancy",
        action="store_true",
        help="use occupancy-grid accelerated sampling (single field model)",
    )
    parser.add_argument(
        "--occ_candidates",
        type=int,
        default=192,
        help="cheap candidate samples per ray before occupancy culling",
    )
    parser.add_argument(
        "--occ_samples",
        type=int,
        default=32,
        help="field-model samples per ray after culling",
    )
    parser.add_argument(
        "--occ_grid",
        type=int,
        default=128,
        help="occupancy grid resolution per axis",
    )
    parser.add_argument(
        "--occ_threshold",
        type=float,
        default=0.01,
        help="density above which a grid cell counts as occupied",
    )
    parser.add_argument(
        "--occ_budget_per_ray",
        type=lambda v: v if v == "auto" else float(v),
        default=None,
        help="inference only: pool all surviving samples of a render tile "
        "into one buffer of tile_size * this many slots (average-case "
        "model cost instead of the per-ray worst case); 'auto' sizes it "
        "losslessly from the first frame's measured demand",
    )
    parser.add_argument(
        "--occ_train_budget",
        type=lambda v: v if v == "auto" else float(v),
        default=None,
        help="training: after --occ_train_budget_start steps, pool each "
        "batch's surviving samples into batch * this many slots (the field "
        "model runs on actual survivor counts, not N*K padding); 'auto' "
        "sizes the pool from the grid's occupancy at switchover",
    )
    parser.add_argument(
        "--occ_train_budget_start",
        type=int,
        default=512,
        help="step at which pooled training kicks in (the grid must have "
        "started culling or the pool would overflow)",
    )
    parser.add_argument(
        "--occ_train_t_eps",
        type=float,
        default=0.0,
        help="pooled training only: prune candidates whose grid-estimated "
        "transmittance falls below this before pooling. MEASURED HARMFUL "
        "while the grid is still training (fog feedback: the EMA "
        "overestimates young-model fog, pruning robs the surface behind "
        "it of gradient — loss diverged 10x on the compound scene); keep "
        "0 unless resuming with a converged grid",
    )
    parser.add_argument(
        "--occ_refresh_samples",
        type=int,
        default=1,
        help="jittered model samples per refreshed grid cell (max taken). "
        "1 matches Instant NGP; raise to 4 for long runs where the "
        "density shell gets thinner than a cell — a single sample then "
        "misses it, the cell culls, and the loss excursions (measured "
        "5e-5 -> 5e-3 late in a 1600-step cosine run). Refresh is off "
        "the hot path, so the cost is amortized",
    )
    parser.add_argument(
        "--occ_freeze_grid_after",
        type=int,
        default=None,
        help="stop grid refreshes after this step (grid frozen for the "
        "rest of the run). Measured: late in long cosine runs the grid's "
        "decay-culling keeps shifting sample placement under the "
        "CONVERGED model — the loss excursions 5e-5 -> 5e-3 with the "
        "params provably frozen (lr~0). The grid converges by ~2x the "
        "warmup window; freezing it there (e.g. 512) removes the "
        "grid-driven tail instability",
    )
    parser.add_argument(
        "--occ_warmup",
        type=int,
        default=16,
        help="grid updates during which every cell tests occupied and "
        "decay is suppressed (x update interval 16 = 256 unbiased steps; "
        "guards young models from culling unlearned surfaces)",
    )
    parser.add_argument(
        "--occ_t_eps",
        type=float,
        default=0.0,
        help="inference only: drop samples once the occupancy grid's "
        "approximate transmittance falls below this (early ray "
        "termination; applies to both the pooled and fixed-K frame "
        "paths — pooling turns the dropped samples into actual compute "
        "savings, fixed-K into looser sample spacing)",
    )
    parser.add_argument(
        "--occ_span_candidates",
        type=int,
        default=0,
        help="inference only (pooled path): two-phase selection — test "
        "this many coarse midpoints against a conservative max-pooled "
        "supergrid to bound the occupied span, then place all "
        "--occ_candidates inside it (fewer grid gathers per ray at finer "
        "effective resolution; 64 is a good value for a 128 grid)",
    )
    parser.add_argument(
        "--occ_span_pool_factor",
        type=int,
        default=8,
        help="supergrid pooling factor for --occ_span_candidates (must "
        "divide the occupancy grid resolution; raising it coarsens the "
        "span probe so fewer span candidates are needed: required "
        "candidates = 2*sqrt(3)*grid/factor)",
    )
    parser.add_argument(
        "--occ_block_gather",
        type=int,
        default=0,
        help="inference only: gather ONE packed row (a 4x4x2 block's 32 "
        "occupancy bits + its max density) per this-many candidates and "
        "answer each candidate from the bracketing probes' words — "
        "gathers are count-bound, so stride k cuts selection gathers "
        "~k-fold; block-mismatch candidates conservatively count "
        "occupied (geometry is never dropped).  1 = bit-identical to "
        "per-cell gathers when the transmittance prune is off (with "
        "--occ_t_eps > 0 the prune sees the block-max density, so it "
        "can cut later candidates earlier); 2-4 trades a small "
        "occupied-overcount for speed (0 = off).  LIVE-path lever only: "
        "with --baked the packed grid already removed the gather "
        "bottleneck and block words measured SLOWER on-chip "
        "(docs/DESIGN.md section 3, 2026-08-19)",
    )
    parser.add_argument(
        "--occ_span_block_gather",
        type=int,
        default=0,
        help="inference only: the same packed block-word trick for the "
        "phase-1 span probes (requires --occ_span_candidates > 0 and a "
        "supergrid divisible by 4x4x2); a mismatched probe counts "
        "occupied, which only widens the span — phase 2 re-tests every "
        "candidate at full resolution, so geometry is never dropped "
        "(0 = off, 1 = bit-identical to per-cell span probes)",
    )


def create_model(
    args: argparse.Namespace, metadata: ModelMetadata
) -> Tuple[FieldModel, FieldModel, Dict[str, Any]]:
    """Build the (coarse, fine) pair plus extra TrainLoop kwargs."""
    dtype_kwargs = (
        dict(compute_dtype="bfloat16") if getattr(args, "bf16", False) else dict()
    )
    if args.instant_ngp:
        if args.ref_nerf:
            # Ref-NeRF's analytic normals need f32 gradients; no bf16 mode.
            model_cls = partial(InstantNGPRefNeRFModel, sh_degree=4)
        else:
            model_cls = partial(InstantNGPModel, **dtype_kwargs)
        bbox_kwargs = dict(
            bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max)
        )
        coarse = model_cls(
            table_sizes=[2**18] * 6,
            grid_sizes=[2 ** (4 + i // 2) for i in range(6)],
            **bbox_kwargs,
        )
        fine = model_cls(
            table_sizes=[2**18] * 16,
            grid_sizes=[2 ** (4 + i // 2) for i in range(16)],
            **bbox_kwargs,
        )
        train_kwargs = dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
    else:
        if args.ref_nerf:
            model_cls = partial(RefNeRFModel, sh_degree=4)
        else:
            model_cls = partial(NeRFModel, **dtype_kwargs)
        coarse = model_cls()
        fine = model_cls()
        train_kwargs = dict()
    return coarse, fine, train_kwargs


def add_baked_args(parser: argparse.ArgumentParser) -> None:
    """Inference-only flags for the baked NGP representation
    (``learn_nerf_tpu.baked``; render-family CLIs only)."""
    parser.add_argument(
        "--baked",
        type=int,
        default=None,
        metavar="RESOLUTION",
        help="bake the trained Instant-NGP spatial field onto a dense "
        "RESOLUTION^3 grid at startup and render from it (one 8-corner "
        "gather per sample instead of the full hash stack; requires "
        "--instant_ngp --occupancy; 384 with --baked_pack 4 is the "
        "recommended full-quality config)",
    )
    parser.add_argument(
        "--baked_dtype",
        type=str,
        default="bfloat16",
        choices=("bfloat16", "float32"),
        help="baked grid storage dtype (bfloat16 halves memory)",
    )
    parser.add_argument(
        "--baked_cache",
        action="store_true",
        help="cache the baked grid to <model_path>.baked<R>.<dtype>.npz "
        "and reuse it while it is newer than the checkpoint (skips the "
        "bake sweep on later sessions)",
    )
    parser.add_argument(
        "--baked_pack",
        type=int,
        default=1,
        choices=(1, 2, 4, 8),
        help="corners stored per baked-grid row: PACKx the grid memory "
        "for 8/PACK gathers per sample, identical output",
    )


def apply_baking(args, fine, params):
    """Swap (fine model, field params) for their baked equivalents when
    ``--baked`` is set.  Returns ``(model, field_params)`` either way."""
    if not getattr(args, "baked", None):
        return fine, params["fine"]
    if not getattr(args, "occupancy", False):
        raise SystemExit("--baked requires --occupancy")
    import os

    import jax.numpy as jnp

    from ..baked import bake_instant_ngp

    pack = getattr(args, "baked_pack", 1)
    cache_path = None
    if getattr(args, "baked_cache", False):
        import hashlib

        pack_tag = f".p{pack}" if pack != 1 else ""
        # The bbox is part of the cache identity: the grid's values are
        # sampled on THIS bbox's world lattice — the same checkpoint
        # rendered with a different metadata.json must re-bake, not
        # silently attribute every value to the wrong position.
        bbox_tag = hashlib.md5(
            repr((tuple(fine.bbox_min), tuple(fine.bbox_max))).encode()
        ).hexdigest()[:8]
        # ".seg128" versions the on-disk layout (segmented 128-lane
        # physical rows): an old-layout cache has
        # valid row indices for the new addressing and would misread
        # SILENTLY.
        cache_path = (
            f"{args.model_path}.baked{args.baked}.{args.baked_dtype}"
            f"{pack_tag}.{bbox_tag}.seg128.npz"
        )
        ckpt_mtime = os.path.getmtime(args.model_path)
        if (
            os.path.exists(cache_path)
            and os.path.getmtime(cache_path) >= ckpt_mtime
        ):
            import numpy as np

            from ..baked import BakedInstantNGP

            data = np.load(cache_path)
            raw = data["grid"]
            if args.baked_dtype == "bfloat16":
                # Stored as raw uint16 bits (np.savez has no bfloat16);
                # reinterpret, don't convert.
                import ml_dtypes

                raw = raw.view(ml_dtypes.bfloat16)
            baked_params = {"grid": jnp.asarray(raw)}
            i = 0
            while f"Dense_{i}_kernel" in data:
                baked_params[f"Dense_{i}"] = dict(
                    kernel=jnp.asarray(data[f"Dense_{i}_kernel"]),
                    bias=jnp.asarray(data[f"Dense_{i}_bias"]),
                )
                i += 1
            baked = BakedInstantNGP(
                resolution=args.baked,
                bbox_min=tuple(fine.bbox_min),
                bbox_max=tuple(fine.bbox_max),
                d_freqs=fine.d_freqs,
                hidden_dim=fine.hidden_dim,
                density_dim=fine.density_dim,
                color_layers=fine.color_layers,
                pack=pack,
                compute_dtype=fine.compute_dtype,
            )
            print(f"loaded baked grid cache: {cache_path}", flush=True)
            return baked, baked_params

    baked, baked_params = bake_instant_ngp(
        fine,
        params["fine"],
        args.baked,
        dtype=jnp.dtype(args.baked_dtype),
        pack=pack,
    )
    if cache_path is not None:
        import jax
        import numpy as np

        host = jax.device_get(baked_params)
        arrays = {"grid": np.asarray(host["grid"]).view(np.uint16)
                  if host["grid"].dtype == jnp.bfloat16
                  else np.asarray(host["grid"])}
        # np.savez has no bfloat16: store the raw bits; the loader casts
        # back through the view.
        i = 0
        while f"Dense_{i}" in host:
            arrays[f"Dense_{i}_kernel"] = np.asarray(host[f"Dense_{i}"]["kernel"])
            arrays[f"Dense_{i}_bias"] = np.asarray(host[f"Dense_{i}"]["bias"])
            i += 1
        # Atomic write (tmp + rename): a kill mid-write of this multi-GB
        # file would leave a truncated cache whose mtime still passes the
        # freshness check, crashing every later --baked_cache run.
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, cache_path)
        print(f"wrote baked grid cache: {cache_path}", flush=True)
    return baked, baked_params


def build_occupancy_renderer(args, metadata: ModelMetadata, fine, params):
    """Occupancy renderer + grid state from CLI args and a checkpoint.

    Shared by every render-family CLI so the grid resolution fallback
    (checkpointed ``occupancy_resolution`` wins over ``--occ_grid``) and
    the past-warmup state marking stay in one place.
    """
    from ..acceleration import OccupancyGrid
    from ..occ_render import OccupancyRenderer

    bbox = dict(
        bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max)
    )
    grid = OccupancyGrid(
        resolution=int(params.get("occupancy_resolution", args.occ_grid)),
        threshold=getattr(args, "occ_threshold", 0.01),
        **bbox,
    )
    grid_state = grid.state_from_checkpoint(params)
    renderer = OccupancyRenderer(
        model=fine,
        grid=grid,
        candidates=args.occ_candidates,
        samples=args.occ_samples,
        span_candidates=getattr(args, "occ_span_candidates", 0),
        span_pool_factor=getattr(args, "occ_span_pool_factor", 8),
        block_gather_stride=getattr(args, "occ_block_gather", 0),
        span_block_gather=getattr(args, "occ_span_block_gather", 0),
        **bbox,
    )
    return renderer, grid_state


def seeded_key(seed):
    import random

    import jax

    return jax.random.PRNGKey(seed if seed is not None else random.randint(0, 2**32 - 1))


def to_u8_image(colors, height: int, width: int):
    """[-1, 1] model colors -> HxWx3 uint8, clipped.

    The single definition of the render CLIs' encode step: without the
    clip, colors the model drives slightly out of range wrap around in
    the uint8 cast (-1.01 -> 254) as bright speckles.
    """
    import numpy as np

    arr = np.asarray(colors).reshape(height, width, 3)
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
