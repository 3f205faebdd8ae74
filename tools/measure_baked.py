"""Measure the baked NGP frame renderer vs the live hash stack, on one GPU.

Target: an 800x800 full-quality NGP frame on ONE card, baked PSNR within
0.1 dB of the unbaked render.  Renders the same view with the same PRNG
key through the live pooled path and through ``--baked`` at one or more
resolutions, timing steady-state frames (each timed window ends in
``jax.block_until_ready``) and reporting PSNR of baked vs live (same key
-> identical candidate jitter, so the PSNR isolates bake interpolation
error).  The first lines name the device and the card's power limit;
without a GPU the tool exits non-zero.

Usage:
  python tools/measure_baked.py CKPT METADATA VIEW [--size 800]
      [--resolutions 384,512] [--budget 10] [--eps 1e-2] [--reps 3]
      [--dtype bfloat16]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def psnr_float(a, b):
    """PSNR in dB over FLOAT [-1, 1] frames (peak-to-peak 2).

    Deliberately not u8-quantized: independent +-0.5 LSB rounding in two
    u8 images floors the measurable PSNR near ~56 dB, which would let
    rounding (not bake error) decide rankings between near-lossless
    configurations.  The baked verdict targets 0.1 dB resolution.
    """
    import numpy as np

    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(2.0**2 / mse)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ckpt")
    p.add_argument("metadata_json")
    p.add_argument("view_json")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--resolutions", type=str, default="384,512")
    p.add_argument("--budget", type=float, default=10.0)
    p.add_argument("--candidates", type=int, default=192)
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--eps", type=float, default=1e-2)
    p.add_argument("--tile", type=int, default=8192)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument(
        "--span_candidates", type=int, default=0,
        help="two-phase selection coarse tests per ray (0 = single-phase)",
    )
    p.add_argument(
        "--pack", type=int, default=1, choices=(1, 2, 4, 8),
        help="corners per baked row (PACKx memory, 8/PACK gathers/sample)",
    )
    p.add_argument(
        "--block_gather", type=int, default=0,
        help="packed block-word occupancy gathers at this candidate "
        "stride (0 = per-cell gathers; see --occ_block_gather)",
    )
    p.add_argument(
        "--span_block_gather", type=int, default=0,
        help="block-word span probes at this stride (see "
        "--occ_span_block_gather; requires --span_candidates > 0)",
    )
    return p.parse_args(argv)


def measure(args):
    """Render live and baked frames and print one report line each."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from learn_nerf_tpu.baked import bake_instant_ngp
    from learn_nerf_tpu.checkpoint import load_params_pickle
    from learn_nerf_tpu.data.camera import CameraView
    from learn_nerf_tpu.data.dataset import ModelMetadata
    from learn_nerf_tpu.occ_render import OccupancyFrameSession, OccupancyRenderer
    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.scripts.common import create_model

    metadata = ModelMetadata.from_json(args.metadata_json)
    params = load_params_pickle(args.ckpt)
    bbox = dict(
        bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max)
    )
    # The production model factory (scripts.common) owns the NGP config —
    # duplicating table/grid sizes here would silently drift from what the
    # checkpoint was trained with.
    _, model, _ = create_model(
        argparse.Namespace(instant_ngp=True, ref_nerf=False, bf16=False),
        metadata,
    )
    grid = OccupancyGrid(
        resolution=int(params.get("occupancy_resolution", 128)), **bbox
    )
    if args.span_candidates > 0:
        # Anisotropic scene bboxes need more probes than the cubic
        # ceil(2*sqrt(3)*rs) rule of thumb; raising the count is
        # conservative (never lossy), so a measurement run auto-sizes
        # LOUDLY instead of dying on the renderer's validation — chip
        # recovery windows are too precious to burn on a flag value
        # tuned against a different bbox.
        from learn_nerf_tpu.occ_render import min_span_candidates

        needed = min_span_candidates(  # 8 = renderer_for's default factor
            grid.resolution, 8, metadata.bbox_min, metadata.bbox_max
        )
        if args.span_candidates < needed:
            print(
                f"span_candidates raised {args.span_candidates} -> {needed} "
                f"(conservativeness bound for this scene's bbox)",
                flush=True,
            )
            args.span_candidates = needed
    grid_state = grid.state_from_checkpoint(params)
    background = jnp.asarray(params["background"], dtype=jnp.float32)
    view = CameraView.from_json(args.view_json)
    rays = view.bare_rays(args.size, args.size)
    key = jax.random.PRNGKey(0)

    def renderer_for(field_model):
        return OccupancyRenderer(
            model=field_model, grid=grid,
            candidates=args.candidates, samples=args.samples,
            span_candidates=args.span_candidates,
            block_gather_stride=args.block_gather,
            span_block_gather=args.span_block_gather, **bbox,
        )

    def timed_frames(tag, field_model, field_params):
        session = OccupancyFrameSession(
            renderer_for(field_model), field_params, background, grid_state,
            budget_cfg=args.budget, tile_size=args.tile,
            transmittance_eps=args.eps,
        )
        out = session.render(key, rays)  # compile + warmup
        img = np.asarray(out["outputs"])
        dropped, selected = int(out["dropped"]), int(out["selected"])
        t0 = time.time()
        for _ in range(args.reps):
            out = session.render(key, rays)
        jax.block_until_ready(out)
        per_frame = (time.time() - t0) / args.reps
        print(
            f"{tag}: {per_frame:.3f} s/frame "
            f"({args.size * args.size / per_frame:,.0f} rays/s), "
            f"dropped {dropped}/{selected}",
            flush=True,
        )
        return img, per_frame

    live_img, live_t = timed_frames("live", model, params["fine"])

    for r in [int(x) for x in args.resolutions.split(",") if x]:
        baked, baked_params = bake_instant_ngp(
            model, params["fine"], r, dtype=jnp.dtype(args.dtype),
            pack=args.pack,
        )
        tag = f"baked_{r}" + (f"_p{args.pack}" if args.pack != 1 else "")
        img, t = timed_frames(tag, baked, baked_params)
        print(
            f"{tag}: PSNR vs live {psnr_float(img, live_img):.2f} dB, "
            f"speedup {live_t / t:.2f}x",
            flush=True,
        )
        del baked_params


def main(argv=None):
    from learn_nerf_tpu.utils.device import (
        device_summary,
        gpu_name_and_power_limit,
        require_gpu,
        use_compile_cache,
    )

    args = parse_args(argv)
    use_compile_cache()
    require_gpu()
    print(f"device: {device_summary()}", flush=True)
    print(f"gpu: {gpu_name_and_power_limit()}", flush=True)
    measure(args)


if __name__ == "__main__":
    main()
