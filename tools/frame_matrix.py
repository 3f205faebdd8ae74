"""Frame-time matrix over the inference lever stack, one config per row,
on one GPU.

The optimization program stacks independent levers on the north-star
800x800 flagship frame (baking, tensor packing, block-word candidate
gathers, block-word span probes, candidate count).  This tool times each
named config on the SAME scene-free synthetic workload as ``bench.py``'s
``frame_800_baked`` submetric (random-init NGP, 128^3 surface-like shell
grid ~ a compound scene's survivor demand — see
``bench.shell_grid_state``) and prints a table plus one JSON line naming
the device and the card's power limit.  Without a GPU it exits non-zero:
CPU frame times say nothing about the card's lever ordering.

Workload being replaced: the reference's chunked host-loop frame render
(``learn_nerf/scripts/render_nerf.py:85-97``).

Usage:
    python tools/frame_matrix.py --size 800 --reps 3
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> overrides on BASE (bake=0 means live hash-grid field).
CONFIGS = {
    "live_span": dict(bake=0),
    "baked384_p1": dict(pack=1),
    "baked384_p4": dict(),
    "baked384_p4_bg4": dict(block_gather=4),
    "baked384_p4_bg4_sb4": dict(block_gather=4, span_block_gather=4),
    "baked384_p4_bg4_sb4_c64": dict(
        block_gather=4, span_block_gather=4, candidates=64
    ),
    "baked256_p8_bg4_sb4": dict(
        bake=256, pack=8, block_gather=4, span_block_gather=4
    ),
}

BASE = dict(
    bake=384, pack=4, candidates=96, samples=32, span_candidates=64,
    block_gather=0, span_block_gather=0,
)


_BAKE_CACHE = {}


def build_session(cfg, size, tile, budget, eps):
    # The workload itself is bench.frame_session — ONE definition shared
    # with the frame_800_baked submetric, so the decomposition rows here
    # measure exactly the program the headline bench times.
    from bench import frame_session

    return frame_session(
        bake_resolution=cfg["bake"], pack=cfg["pack"],
        candidates=cfg["candidates"], samples=cfg["samples"],
        span_candidates=cfg["span_candidates"],
        block_gather_stride=cfg["block_gather"],
        span_block_gather=cfg["span_block_gather"],
        tile=tile, budget=budget, eps=eps, bake_cache=_BAKE_CACHE,
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tile", type=int, default=8192)
    p.add_argument(
        "--budget", default="auto",
        help="'auto' (demand-measured, drop-free — the bench.py frame "
        "config) or a number (fixed; drops are reported, not silent)",
    )
    p.add_argument("--eps", type=float, default=1e-2)
    p.add_argument(
        "--configs", default=",".join(CONFIGS),
        help="comma-separated subset of: " + ", ".join(CONFIGS),
    )
    p.add_argument(
        "--bake_override", type=int, default=0,
        help="replace every config's bake resolution (0 = keep); the "
        "gather-count structure per frame is unchanged (bake resolution "
        "affects bake time and memory, not the per-frame gather counts)",
    )
    args = p.parse_args()
    if args.budget != "auto":
        args.budget = float(args.budget)

    import jax

    from bench import frame_view
    from learn_nerf_tpu.utils.device import (
        device_summary,
        gpu_name_and_power_limit,
        require_gpu,
        use_compile_cache,
    )

    use_compile_cache()
    require_gpu()
    device, gpu = device_summary(), gpu_name_and_power_limit()
    rays = frame_view().bare_rays(args.size, args.size)
    key = jax.random.PRNGKey(1)

    rows, base_secs = {}, None
    for name in args.configs.split(","):
        cfg = dict(BASE, **CONFIGS[name])
        if args.bake_override and cfg["bake"]:
            cfg["bake"] = args.bake_override
        session = build_session(cfg, args.size, args.tile, args.budget, args.eps)
        jax.block_until_ready(session.render(key, rays))  # compile + warmup
        t0 = time.time()
        for _ in range(args.reps):
            out = session.render(key, rays)
        jax.block_until_ready(out)
        secs = (time.time() - t0) / args.reps
        if base_secs is None:
            base_secs = secs
        rows[name] = dict(
            seconds_per_frame=round(secs, 4),
            rays_per_sec=round(args.size * args.size / secs, 1),
            speedup_vs_first=round(base_secs / secs, 3),
        )
        print(
            f"{name:28s} {secs:8.3f} s/frame   "
            f"{rows[name]['rays_per_sec']:>10.0f} rays/s   "
            f"{rows[name]['speedup_vs_first']:6.2f}x",
            flush=True,
        )

    print(json.dumps(dict(
        tool="frame_matrix", device=device, gpu=gpu, size=args.size,
        reps=args.reps, budget=args.budget, eps=args.eps,
        bake_override=args.bake_override, rows=rows,
    )))


if __name__ == "__main__":
    main()
