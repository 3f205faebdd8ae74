"""Train a NeRF model on a scene.

CLI parity with the reference (``learn_nerf/scripts/train_nerf.py:21-55``):
same flags, defaults, auto-resume from ``--save_path``, optional per-step
test losses, and the ``step i: k=v ...`` stdout format.  Additions: a
``--mesh_devices`` override, ``--full_state_path`` for resumable optimizer
state, ``--profile_dir`` for jax.profiler traces, ``--steps`` to bound the
run, and a rays/sec counter in the log line.
"""

import argparse
import os

from ..data.dataset import load_dataset
from ..train import OccupancyTrainLoop, TrainLoop
from ..utils.logging import MetricLogger
from .common import add_model_args, add_occupancy_args, create_model, seeded_key
from ..utils.device import use_compile_cache


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument(
        "--lr_schedule",
        choices=("constant", "cosine"),
        default="constant",
        help="constant (reference behavior) or cosine decay from --lr to "
        "--lr * --lr_final_frac over --steps.  Constant-lr Adam keeps "
        "oscillating near convergence (measured: ~10x loss excursions, "
        "+-4 dB PSNR at an arbitrary stop step on the 600-step verify "
        "scene); cosine decay pins the endpoint quality",
    )
    parser.add_argument(
        "--lr_final_frac",
        type=float,
        default=0.1,
        help="cosine schedule floor as a fraction of --lr",
    )
    parser.add_argument(
        "--ema",
        type=float,
        default=None,
        help="Polyak-average the weights with this decay (e.g. 0.99) and "
        "checkpoint/render the average — Instant NGP's eval-weight EMA. "
        "Rides over constant-lr Adam's near-convergence oscillation, so "
        "the saved quality stops depending on the stop step",
    )
    parser.add_argument("--batch_size", type=int, default=4096, help="rays per batch")
    parser.add_argument(
        "--test_batch_size", type=int, default=None, help="rays per test batch"
    )
    parser.add_argument(
        "--coarse_samples", type=int, default=64, help="samples per coarse ray"
    )
    parser.add_argument(
        "--fine_samples",
        type=int,
        default=128,
        help="samples per fine ray (not including coarse samples)",
    )
    parser.add_argument(
        "--density_penalty",
        type=float,
        default=None,
        help="penalty coefficient for density at random points",
    )
    parser.add_argument(
        "--density_penalty_batch_size",
        type=int,
        default=128,
        help="batch size for computing density penalty",
    )
    parser.add_argument("--save_interval", type=int, default=1000)
    parser.add_argument("--save_path", type=str, default="nerf.pkl")
    parser.add_argument(
        "--full_state_path",
        type=str,
        default=None,
        help="also checkpoint the full train state (optimizer + step)",
    )
    parser.add_argument("--one_view", action="store_true")
    parser.add_argument("--test_data_dir", type=str, default=None)
    parser.add_argument(
        "--steps", type=int, default=None, help="stop after this many steps"
    )
    parser.add_argument(
        "--profile_dir", type=str, default=None, help="capture a profiler trace here"
    )
    parser.add_argument(
        "--steps_per_dispatch",
        type=int,
        default=1,
        help="run this many training steps (occupancy: plus their "
        "grid-refresh cadence) per device dispatch via lax.scan — "
        "amortizes per-dispatch host cost; identical numerics to "
        "per-step dispatch (incompatible with --test_data_dir)",
    )
    # Multi-host data parallelism (jax.distributed; each process loads its
    # own view subset — see data.shuffle and parallel.mesh).
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    add_model_args(parser)
    add_occupancy_args(parser)
    parser.add_argument("data_dir", type=str)
    return parser


def main(argv=None):
    use_compile_cache()
    args = build_parser().parse_args(argv)
    if args.steps_per_dispatch > 1 and args.test_data_dir is not None:
        # Validate pure flag combinations BEFORE datasets/model/checkpoint
        # load (minutes of IO on real scenes).
        raise SystemExit(
            "--steps_per_dispatch > 1 is incompatible with --test_data_dir "
            "(the per-step test-loss path keeps per-step dispatch)"
        )
    if args.test_batch_size is None:
        args.test_batch_size = args.batch_size

    from ..parallel.mesh import init_distributed

    init_distributed(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax

    print("loading dataset...")
    data = load_dataset(args.data_dir)
    if args.one_view:
        data.views = data.views[:1]

    test_data = None
    if args.test_data_dir is not None:
        print("loading test dataset...")
        test_data = load_dataset(args.test_data_dir)
        if args.one_view:
            test_data.views = test_data.views[:1]

    key = seeded_key(args.seed)
    init_key, key = jax.random.split(key)

    print("creating model and train loop...")
    if args.lr_schedule == "cosine":
        if args.steps is None:
            raise SystemExit("--lr_schedule cosine needs --steps (the decay span)")
        import optax

        # optax.adam takes a schedule in place of a float; the optimizer
        # step count drives it, so a full-state resume continues the decay
        # natively (no offset).  A params-PICKLE auto-resume starts a
        # fresh optimizer (count 0) — without an offset the schedule would
        # restart at the peak lr on near-converged params, the exact
        # excursion this flag exists to prevent — so peek the pickle's
        # step counter and shift.  BOTH resume paths cap args.steps.
        resume_step = 0
        will_full_resume = args.full_state_path and os.path.exists(
            args.full_state_path
        )
        if will_full_resume:
            from ..checkpoint import peek_train_state_step

            resume_step = peek_train_state_step(args.full_state_path)
        elif os.path.exists(args.save_path):
            import pickle

            with open(args.save_path, "rb") as f:
                payload = pickle.load(f)
            resume_step = int(
                payload.get(
                    "occupancy_host_step", payload.get("train_host_step", 0)
                )
            )
        base_schedule = optax.cosine_decay_schedule(
            init_value=args.lr,
            decay_steps=args.steps,
            alpha=args.lr_final_frac,
        )
        if resume_step:
            # --steps is the TOTAL decay span: a resumed run trains only
            # the remaining steps, so equal-step comparisons hold across
            # crash/resume — without the cap a
            # rerun would overshoot the budget and train the overflow at
            # the lr floor.
            remaining = max(args.steps - resume_step, 0)
            print(
                f"cosine schedule resumes at step {resume_step}; "
                f"{remaining} of {args.steps} total steps remain"
            )
            if remaining == 0:
                print("nothing to do: the checkpoint already covers --steps")
                return
            args.steps = remaining
            # The restored optimizer count already sits at resume_step on
            # a full-state resume — offsetting there would double-count.
            lr = (
                base_schedule
                if will_full_resume
                else lambda count: base_schedule(count + resume_step)
            )
        else:
            lr = base_schedule
    else:
        lr = args.lr
        # Deliberate default: constant lr is reference parity, but its endpoint is stop-step
        # dependent (several dB measured) — point long runs at the recipe.
        if args.steps is not None and args.steps >= 1000:
            print(
                "note: constant lr leaves end-of-run PSNR stop-step "
                "dependent; for a pinned endpoint use --lr_schedule cosine "
                "(+ --occ_freeze_grid_after, --ema; see README "
                "'Endpoint-quality recipe')"
            )
    coarse, fine, train_kwargs = create_model(args, data.metadata)
    if args.occupancy:
        loop = OccupancyTrainLoop(
            fine,
            init_rng=init_key,
            lr=lr,
            bbox_min=data.metadata.bbox_min,
            bbox_max=data.metadata.bbox_max,
            candidates=args.occ_candidates,
            samples=args.occ_samples,
            grid_resolution=args.occ_grid,
            grid_threshold=args.occ_threshold,
            density_penalty=args.density_penalty,
            density_penalty_batch_size=args.density_penalty_batch_size,
            pool_budget_per_ray=args.occ_train_budget,
            pool_start_step=args.occ_train_budget_start,
            pool_t_eps=args.occ_train_t_eps,
            grid_warmup_updates=args.occ_warmup,
            grid_refresh_samples=args.occ_refresh_samples,
            grid_freeze_after=args.occ_freeze_grid_after,
            ema_decay=args.ema,
            **train_kwargs,
        )
    else:
        loop = TrainLoop(
            coarse,
            fine,
            init_rng=init_key,
            lr=lr,
            coarse_ts=args.coarse_samples,
            fine_ts=args.fine_samples,
            bbox_min=data.metadata.bbox_min,
            bbox_max=data.metadata.bbox_max,
            density_penalty=args.density_penalty,
            density_penalty_batch_size=args.density_penalty_batch_size,
            ema_decay=args.ema,
            **train_kwargs,
        )
    if (
        args.full_state_path
        and os.path.exists(args.full_state_path)
        and hasattr(loop, "load_full")
    ):
        print(f"loading full train state: {args.full_state_path}")
        loop.load_full(args.full_state_path)
    elif os.path.exists(args.save_path):
        print(f"loading from checkpoint: {args.save_path}")
        loop.load(args.save_path)

    print("training...")
    seed_base = int(jax.random.randint(key, (), 0, 2**31 - 1))
    data_seed, test_seed = seed_base, seed_base + 1
    shuffle_dir = os.path.join(args.data_dir, "shuffled")
    test_iterator = None
    if test_data is not None:
        test_iterator = test_data.iterate_batches(
            os.path.join(args.test_data_dir, "shuffled"),
            test_seed,
            args.test_batch_size,
        )

    k = args.steps_per_dispatch
    if k > 1 and args.test_data_dir is not None:
        raise SystemExit(
            "--steps_per_dispatch > 1 is incompatible with --test_data_dir "
            "(the per-step test-loss path keeps per-step dispatch)"
        )
    logger = MetricLogger(rays_per_step=args.batch_size * k)
    profile_ctx = None
    if args.profile_dir:
        from ..utils.profiling import profile_trace

        profile_ctx = profile_trace(args.profile_dir)
        profile_ctx.__enter__()

    # Hot loop: batches double-buffer onto the device while the previous
    # step computes, and per-step PRNG keys derive inside the jitted step
    # (loop.step_auto) — the host issues one dispatch per step.  The
    # per-step test-loss path keeps the explicit host key chain.
    from ..data.prefetch import prefetch_to_device

    use_auto = test_iterator is None
    base_key, key = jax.random.split(key)
    if k > 1:
        import itertools

        import numpy as np

        def chunked(it):
            while True:
                stack = list(itertools.islice(it, k))
                if len(stack) < k:
                    return
                yield np.stack(stack)

        macro_batches = prefetch_to_device(
            chunked(data.iterate_batches(shuffle_dir, data_seed, args.batch_size)),
            loop.shard_batches,
        )
        try:
            for i, macro in enumerate(macro_batches):
                if args.steps is not None:
                    remaining = args.steps - i * k
                    if remaining <= 0:
                        break
                    if remaining < k:
                        # Final partial dispatch: scan exactly the steps
                        # asked for (equal-step comparisons depend on it).
                        # Costs one extra compile for the remainder shape.
                        macro = macro[:remaining]
                losses = loop.step_auto_many(base_key, macro)
                step = i * k + int(macro.shape[0]) - 1
                logger.log_step(step, losses)
                if step and (step + 1) % args.save_interval < k:
                    loop.save(args.save_path)
                    if args.full_state_path and hasattr(loop, "save_full"):
                        loop.save_full(args.full_state_path)
                if args.steps is not None and step + 1 >= args.steps:
                    break
        finally:
            logger.flush()
            if profile_ctx is not None:
                profile_ctx.__exit__(None, None, None)
        loop.save(args.save_path)
        if args.full_state_path and hasattr(loop, "save_full"):
            loop.save_full(args.full_state_path)
        return
    batches = prefetch_to_device(
        data.iterate_batches(shuffle_dir, data_seed, args.batch_size),
        loop.shard_batch,
    )
    try:
        for i, batch in enumerate(batches):
            if use_auto:
                losses = loop.step_auto(base_key, batch)
            else:
                step_key, test_key, key = jax.random.split(key, 3)
                losses = loop.step(step_key, batch)
                test_batch = next(test_iterator)
                test_losses = loop.eval_losses(test_key, test_batch)
                losses = dict(losses, **{f"test_{k}": v for k, v in test_losses.items()})
            logger.log_step(i, losses)
            if i and i % args.save_interval == 0:
                loop.save(args.save_path)
                if args.full_state_path and hasattr(loop, "save_full"):
                    loop.save_full(args.full_state_path)
            if args.steps is not None and i + 1 >= args.steps:
                break
    finally:
        logger.flush()
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)

    loop.save(args.save_path)
    if args.full_state_path and hasattr(loop, "save_full"):
        loop.save_full(args.full_state_path)


if __name__ == "__main__":
    main()
