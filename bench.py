"""Headline benchmark + roofline report, on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.  The
headline metric is training throughput (rays/sec) of the flagship
Instant-NGP model with occupancy-grid accelerated sampling.  The same
line carries a ``submetrics`` object with the two parity workloads
(identical sample counts to the reference) and each config's roofline
numbers (achieved TFLOP/s, MFU, device-memory GB/s, and which resource
binds) against the peaks of the card's ``device_kind``
(:data:`learn_nerf_tpu.utils.flops.PEAKS`).  ``device`` names the
platform, ``device_kind`` and device count, and ``gpu`` the card's name
and power limit as ``nvidia-smi`` reports them.  Without a GPU the bench
exits non-zero: it has no CPU fallback.

Workload: batch 4096 rays/step (reference default,
``learn_nerf/scripts/train_nerf.py:24``).  The reference densely
evaluates its coarse(64) + fine(192-sample) hierarchy; the occupancy
config culls 192 candidates to 32 field samples per ray (matched
quality; tests/test_occupancy.py).  Timing includes the amortized
occupancy-grid updates (every 16 steps); every timed window ends in
``jax.block_until_ready``.

BENCH_MODE: "all" (default) | "occupancy" | "pooled" | "parity" |
"vanilla" | "frame".  The ``instant_ngp_pooled`` submetric measures the
shipped flagship config (``--occ_train_budget auto``) at a synthetic
converged grid with ~10 survivors per ray; ``frame_800_baked`` times the
north-star 800x800 inference frame (baked 384^3 + span selection +
pooled tiles) on a surface-like shell grid (the fog grid is right for
training's spanless sampling, wrong under span tightening — see
:func:`shell_grid_state`).
"""

import json
import os
import time

import numpy as np

BATCH = 4096


def make_batch(rng):
    origins = rng.randn(BATCH, 3).astype(np.float32)
    dirs = rng.randn(BATCH, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(BATCH, 3).astype(np.float32) * 2 - 1
    return np.stack([origins, dirs, colors], axis=1)


def ngp_model(levels):
    from learn_nerf_tpu.models import InstantNGPModel

    return InstantNGPModel(
        table_sizes=[2**18] * levels,
        grid_sizes=[2 ** (4 + i // 2) for i in range(levels)],
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
    )


def run_steps(loop, batch, steps, warmup):
    """Steady-state rays/sec of the production hot loop (step_auto)."""
    import jax

    # Batch sharded onto the mesh once (the train CLI double-buffers
    # transfers, so steady state never waits on input), per-step keys
    # derived inside the jitted step.
    base_key = jax.random.PRNGKey(1)
    batch = loop.shard_batch(batch)
    values = None
    for _ in range(warmup):
        values = loop.step_auto(base_key, batch)
    jax.block_until_ready((values, loop.state))

    t0 = time.time()
    for _ in range(steps):
        values = loop.step_auto(base_key, batch)
    jax.block_until_ready((values, loop.state))
    elapsed = time.time() - t0
    return BATCH * steps / elapsed, elapsed / steps


def step_roofline(loop, batch, step_seconds, device_kind, precision="tf32",
                  extra_args=()):
    """Roofline numbers for the loop's jitted hot step against the peaks
    of ``device_kind``: XLA's cost analysis, or the analytic matmul count
    when that reports no FLOPs."""
    import jax

    from learn_nerf_tpu.utils.flops import lowered_cost, roofline, traced_flops

    batch = loop.shard_batch(batch)
    key = jax.random.PRNGKey(1)
    lowered = loop._auto_step_fn.lower(loop.state, key, batch, *extra_args)
    cost = lowered_cost(lowered)
    if cost is None:
        cost = traced_flops(
            loop._auto_step_fn, loop.state, key, batch, *extra_args
        )
    return roofline(cost, step_seconds, device_kind, precision)


def _device_kind():
    import jax

    return jax.devices()[0].device_kind


def bench_occupancy():
    import jax

    from learn_nerf_tpu.train import OccupancyTrainLoop

    loop = OccupancyTrainLoop(
        ngp_model(16),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-4,
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
        candidates=192,
        samples=32,
        grid_resolution=128,
        update_interval=16,
        adam_eps=1e-15,
        adam_b2=0.99,
    )
    batch = make_batch(np.random.RandomState(0))
    # 32 steps include two grid updates -> amortized update cost measured.
    rays, secs = run_steps(loop, batch, steps=32, warmup=4)
    return dict(
        rays_per_sec=round(rays, 1),
        **step_roofline(loop, batch, secs, _device_kind(),
                        extra_args=(loop.grid_state,)),
    )


def freeze_pooled_grid(loop):
    """Freeze a synthetic grid for the pooled bench (shared with its
    test): the step-0 refresh would max-in the UNTRAINED model's
    exp(~0)~1.0 densities, roughly doubling the occupancy (and the auto
    budget) out from under the documented "demand ~10/ray" workload.
    _host_step=1 skips the step-0 cadence hit; the huge interval blocks
    all later refreshes; pooling stays active (pool_start_step=0 < 1).
    """
    loop.update_interval = 10**9
    loop._host_step = max(loop._host_step, 1)


def bench_pooled():
    """The shipped flagship config (--occ_train_budget auto): once the
    grid culls, each step pools the batch's actual survivors so the field
    model runs on ~demand samples instead of K per-ray padding.

    A real run reaches this state after the grid converges (demand of
    roughly 9 survivors/ray on a compound scene); here a synthetic grid
    with 5% occupied cells reproduces that demand (192 candidates x 5% ~
    9.6 survivors/ray) so the bench measures the same steady-state device
    program without minutes of scene training.
    """
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.train import OccupancyTrainLoop

    loop = OccupancyTrainLoop(
        ngp_model(16),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-4,
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
        candidates=192,
        samples=32,
        grid_resolution=128,
        update_interval=16,
        adam_eps=1e-15,
        adam_b2=0.99,
        pool_budget_per_ray="auto",
        pool_start_step=0,
    )
    # Converged-grid stand-in: 5% of cells occupied, warmup complete.
    rng = np.random.RandomState(3)
    occupied = (rng.rand(128**3) < 0.05).astype(np.float32)
    loop.grid_state = loop.grid_state.replace(
        densities=jnp.asarray(occupied),
        step=jnp.asarray(loop.grid.warmup_updates, jnp.int32),
    )
    freeze_pooled_grid(loop)
    batch = make_batch(np.random.RandomState(0))
    rays, secs = run_steps(loop, batch, steps=32, warmup=4)
    return dict(
        rays_per_sec=round(rays, 1),
        pool_budget=loop._auto_per_ray,
        **step_roofline(loop, batch, secs, _device_kind(),
                        extra_args=(loop.grid_state,)),
    )


def bench_parity():
    import jax

    from learn_nerf_tpu.train import TrainLoop

    loop = TrainLoop(
        ngp_model(6),
        ngp_model(16),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-4,
        coarse_ts=64,
        fine_ts=128,
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
        adam_eps=1e-15,
        adam_b2=0.99,
    )
    batch = make_batch(np.random.RandomState(0))
    rays, secs = run_steps(loop, batch, steps=10, warmup=3)
    return dict(
        rays_per_sec=round(rays, 1),
        **step_roofline(loop, batch, secs, _device_kind()),
    )


def bench_vanilla(compute_dtype="float32"):
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    loop = TrainLoop(
        NeRFModel(compute_dtype=compute_dtype),
        NeRFModel(compute_dtype=compute_dtype),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-4,
        coarse_ts=64,
        fine_ts=128,
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
    )
    batch = make_batch(np.random.RandomState(0))
    rays, secs = run_steps(loop, batch, steps=12, warmup=3)
    return dict(
        rays_per_sec=round(rays, 1),
        **step_roofline(
            loop, batch, secs, _device_kind(),
            "bf16" if compute_dtype == "bfloat16" else "tf32",
        ),
    )


def shell_grid_state(grid, radius=0.5, thickness_cells=1.5):
    """A surface-like synthetic occupancy grid: a thin spherical shell.

    A uniformly random 5%-occupied grid is FOG, not a scene — under
    two-phase span selection the tightened span concentrates candidates
    inside the fog, so survivor demand measured ~30/ray (66% drops at
    budget 10 on the CPU backend), triple the compound scene's ~5-10.
    A converged grid on a real scene is a compact SURFACE: rays cross
    it a couple of times with a handful of occupied cells per crossing.
    The shell reproduces that (demand ~5-10/ray with span tightening),
    so frame numbers from the scene-free bench transfer to the trained
    flagship (tools/measure_baked.py is the trained-checkpoint ground
    truth).  Symmetric in xyz, so the flat-index convention is moot.
    """
    import jax.numpy as jnp

    res = grid.resolution
    centers = ((np.arange(res) + 0.5) / res) * 2.0 - 1.0
    x, y, z = np.meshgrid(centers, centers, centers, indexing="ij")
    rad = np.sqrt(x * x + y * y + z * z)
    cell = 2.0 / res
    shell = (np.abs(rad - radius) < thickness_cells * cell)
    return grid.init().replace(
        densities=jnp.asarray(shell.reshape(-1).astype(np.float32)),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )


def frame_view():
    """The canonical flagship-frame camera (shared with frame_matrix)."""
    from learn_nerf_tpu.data.camera import CameraView

    return CameraView(
        camera_direction=(0.0, 0.0, 1.0), camera_origin=(0.0, 0.0, -3.0),
        x_axis=(1.0, 0.0, 0.0), y_axis=(0.0, 1.0, 0.0),
        x_fov=0.69, y_fov=0.69,
    )


def frame_session(bake_resolution, pack, candidates, samples,
                  span_candidates, block_gather_stride, span_block_gather,
                  tile, budget, eps, grid_resolution=128, bake_cache=None):
    """Build the flagship inference frame workload (scene-free).

    SINGLE definition of the random-init NGP model + shell grid + bake +
    renderer + frame session, shared by :func:`bench_frame` (the driver's
    ``frame_800_baked`` submetric) and ``tools/frame_matrix.py`` (the
    per-lever decomposition rows) so the two can never drift apart.
    ``bake_resolution=0`` keeps the live hash-grid field (no bake);
    ``bake_cache`` (a dict) reuses bakes across sessions keyed by
    (resolution, pack) — the 384^3 bake costs minutes on slow backends.
    """
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.baked import bake_instant_ngp
    from learn_nerf_tpu.occ_render import (
        OccupancyFrameSession,
        OccupancyRenderer,
    )

    bbox = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
    model = ngp_model(16)
    pts = jnp.zeros((8, 3))
    params = model.init(jax.random.PRNGKey(0), pts, pts)["params"]

    grid = OccupancyGrid(resolution=grid_resolution, **bbox)
    grid_state = shell_grid_state(grid)

    field, field_params = model, params
    if bake_resolution:
        key = (bake_resolution, pack)
        if bake_cache is None or key not in bake_cache:
            baked = bake_instant_ngp(
                model, params, bake_resolution, dtype=jnp.bfloat16,
                pack=pack, verbose=False,
            )
            if bake_cache is not None:
                bake_cache[key] = baked
        else:
            baked = bake_cache[key]
        field, field_params = baked
    renderer = OccupancyRenderer(
        model=field, grid=grid, candidates=candidates, samples=samples,
        span_candidates=span_candidates,
        block_gather_stride=block_gather_stride,
        span_block_gather=span_block_gather, **bbox,
    )
    return OccupancyFrameSession(
        renderer, field_params, jnp.zeros(3), grid_state,
        budget_cfg=budget, tile_size=tile, transmittance_eps=eps,
    )


def bench_frame(size=800, reps=3, bake_resolution=384, pack=4,
                grid_resolution=128, candidates=96, samples=32,
                span_candidates=64, block_gather_stride=0,
                span_block_gather=0, tile=8192):
    """North-star inference workload: one 800x800 flagship NGP frame on
    ONE card — baked spatial field (384^3 bf16, pack 4), two-phase span
    selection, pooled tiles, early termination.  Block-word gathers are
    off by default.  Scene-free: random-init NGP params and a synthetic
    surface-like grid (:func:`shell_grid_state`) reproduce a compound
    scene's ~5-10/ray survivor demand — frame time depends on shapes,
    occupancy, and gather counts, not on trained weight values, so this
    measures the same device program the trained flagship runs
    (tools/measure_baked.py measures the trained-checkpoint version).
    The pool budget is ``auto`` (demand-measured, escalate-on-drop), so
    the reported time is a DROP-FREE frame, not a silently lossy one.
    """
    import jax

    session = frame_session(
        bake_resolution=bake_resolution, pack=pack, candidates=candidates,
        samples=samples, span_candidates=span_candidates,
        block_gather_stride=block_gather_stride,
        span_block_gather=span_block_gather, tile=tile, budget="auto",
        eps=1e-2, grid_resolution=grid_resolution,
    )
    rays = frame_view().bare_rays(size, size)
    key = jax.random.PRNGKey(1)
    jax.block_until_ready(session.render(key, rays))  # compile + warmup
    t0 = time.time()
    for _ in range(reps):
        out = session.render(key, rays)
    jax.block_until_ready(out)
    per_frame = (time.time() - t0) / reps
    rays_per_sec = size * size / per_frame
    return dict(
        seconds_per_frame=round(per_frame, 3),
        rays_per_sec=round(rays_per_sec, 1),
        config=f"{size}x{size}, baked {bake_resolution}^3 bf16 "
        f"pack{pack}, span {span_candidates} (block-word "
        f"{span_block_gather}), block-gather {block_gather_stride}, "
        f"pooled auto (drop-free), eps 1e-2, shell grid",
    )


def main():
    # Comma-separated set, e.g. BENCH_MODE="occupancy,pooled,parity,vanilla"
    # (lets a caller bound each piece's time separately).
    # The headline JSON is re-emitted after every completed submetric, so
    # even under "all" a late hang only loses the not-yet-run pieces.
    modes = set(os.environ.get("BENCH_MODE", "all").split(","))
    valid = ("all", "occupancy", "pooled", "parity", "vanilla", "frame")
    if not modes <= set(valid):
        # Fail fast (before touching the device): an unknown mode would
        # otherwise fall through every branch and die on a bare KeyError
        # with no JSON line for the harness to parse.
        raise SystemExit(f"BENCH_MODE={sorted(modes)!r} not all in {valid}")

    def want(m):
        return "all" in modes or m in modes

    from learn_nerf_tpu.utils.device import (
        device_summary,
        gpu_name_and_power_limit,
        require_gpu,
        use_compile_cache,
    )

    use_compile_cache()
    require_gpu()
    device = device_summary()
    gpu = gpu_name_and_power_limit()

    # Incremental emission: the headline JSON line is (re)printed after
    # EVERY completed submetric, so a later hang/kill degrades to missing
    # submetrics instead of destroying already-computed numbers — the
    # reader parses the LAST complete JSON line.
    sub = {}
    benches = []
    if want("occupancy"):
        benches.append(("instant_ngp_occupancy", bench_occupancy))
    if want("pooled"):
        benches.append(("instant_ngp_pooled", bench_pooled))
    if want("parity"):
        benches.append(("instant_ngp_parity", bench_parity))
    if want("vanilla"):
        benches.append(("vanilla_parity", bench_vanilla))
        # The bf16-activation variant, with its roofline against the
        # bf16 matmul peak.
        benches.append(
            ("vanilla_parity_bf16", lambda: bench_vanilla("bfloat16"))
        )
    if want("frame"):
        # North-star inference frame (800x800, baked+span+block-gather);
        # last, under its own watchdog: if it hangs, the already-emitted
        # train headline survives and the bench exits 0.
        frame_timeout = float(os.environ.get("BENCH_FRAME_TIMEOUT", 1500))
        benches.append(
            ("frame_800_baked",
             lambda: _run_bounded(bench_frame, frame_timeout))
        )

    for name, fn in benches:
        try:
            sub[name] = fn()
        except Exception as e:  # noqa: BLE001 — keep earlier submetrics
            sub[name] = dict(error=f"{type(e).__name__}: {e}")
        _emit(sub, device, gpu)


def _run_bounded(fn, timeout_s):
    """Run fn() in a worker thread with a hard timeout.

    On timeout the worker is abandoned (daemon thread; the process exits
    soon after) and an error dict is returned, so a hang in a single
    risky submetric cannot take down the whole bench."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn()
        except Exception as e:  # noqa: BLE001
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return dict(
            error=f"timed out after {timeout_s:.0f}s (worker abandoned)"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def _emit(sub, device, gpu):
    """Print the headline JSON for everything measured so far."""
    def ok(name):
        return name in sub and "error" not in sub[name]

    headlines = (
        ("instant_ngp_occupancy", "train_rays_per_sec_instant_ngp",
         "rays/sec/chip (batch 4096, occupancy-culled 192->32 samples)"),
        ("instant_ngp_pooled", "train_rays_per_sec_instant_ngp_pooled",
         "rays/sec/chip (batch 4096, pooled survivors, demand ~10/ray)"),
        ("instant_ngp_parity", "train_rays_per_sec_instant_ngp_parity",
         "rays/sec/chip (batch 4096, dense 64c+192f samples)"),
        ("vanilla_parity", "train_rays_per_sec_vanilla_parity",
         "rays/sec/chip (batch 4096, dense 64c+192f samples)"),
        ("frame_800_baked", "frame_rays_per_sec_800px_baked",
         "rays/sec (800x800 frame, baked NGP field, one chip)"),
    )
    line = dict(
        # Nothing usable yet (first submetric errored): still a
        # well-formed line, value 0.
        metric="train_rays_per_sec_instant_ngp", value=0, unit="rays/sec/chip",
    )
    for name, metric, unit in headlines:
        if ok(name):
            line = dict(metric=metric, value=sub[name]["rays_per_sec"], unit=unit)
            break
    print(json.dumps(dict(line, device=device, gpu=gpu, submetrics=sub)), flush=True)


if __name__ == "__main__":
    main()
