"""K-fold cross-validation to flag views with bad camera poses.

Parity with ``learn_nerf/scripts/cv_nerf.py``: per fold, train on the
remaining views for ``--train_iters`` steps, then report each held-out
view's mean fine loss (high loss suggests a wrong pose).
"""

import argparse
import tempfile
from typing import Iterator, List, Set

import numpy as np

from ..data.dataset import NeRFDataset, load_dataset
from ..train import TrainLoop
from .common import add_model_args, create_model, seeded_key
from ..utils.device import use_compile_cache


def chunk_indices(num_chunks: int, indices: List[int]) -> Iterator[Set[int]]:
    chunk_size = len(indices) // num_chunks
    extra = len(indices) % num_chunks
    offset = 0
    for i in range(num_chunks):
        size = chunk_size + 1 if i < extra else chunk_size
        if not size:
            return
        yield set(indices[offset : offset + size])
        offset += size
    assert offset == len(indices)


def validation_losses(key, loop: TrainLoop, data: NeRFDataset, batch_size: int):
    import jax

    for view in data.views:
        rays = view.rays()
        total_loss = 0.0
        for i in range(0, rays.shape[0], batch_size):
            key, sk = jax.random.split(key)
            sub = rays[i : i + batch_size]
            losses = loop.eval_losses(sk, sub)
            total_loss += float(losses["fine"]) * len(sub)
        yield total_loss / rays.shape[0]


def main(argv=None):
    use_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--folds", type=int, default=10)
    parser.add_argument("--coarse_samples", type=int, default=64)
    parser.add_argument("--fine_samples", type=int, default=128)
    parser.add_argument("--train_iters", type=int, default=1500)
    add_model_args(parser)
    parser.add_argument("data_dir", type=str)
    args = parser.parse_args(argv)

    import jax

    print("loading dataset...")
    data = load_dataset(args.data_dir)

    global_key = seeded_key(args.seed)
    init_key, shuffle_key, global_key = jax.random.split(global_key, num=3)
    shuffle_indices = np.asarray(
        jax.random.permutation(shuffle_key, np.arange(len(data.views)))
    ).tolist()

    for fold, valid_indices in enumerate(chunk_indices(args.folds, shuffle_indices)):
        print(f"performing cross validation for fold {fold}...")
        train_data = NeRFDataset(
            metadata=data.metadata,
            views=[v for i, v in enumerate(data.views) if i not in valid_indices],
        )
        valid_data = NeRFDataset(
            metadata=data.metadata,
            views=[v for i, v in enumerate(data.views) if i in valid_indices],
        )
        coarse, fine, train_kwargs = create_model(args, data.metadata)
        loop = TrainLoop(
            coarse,
            fine,
            init_rng=init_key,
            lr=args.lr,
            coarse_ts=args.coarse_samples,
            fine_ts=args.fine_samples,
            bbox_min=data.metadata.bbox_min,
            bbox_max=data.metadata.bbox_max,
            **train_kwargs,
        )
        key = global_key
        with tempfile.TemporaryDirectory() as tmp_dir:
            data_key, base_key, key = jax.random.split(key, 3)
            batch_iter = train_data.iterate_batches(
                tmp_dir, int(jax.random.randint(data_key, (), 0, 2**31 - 1)),
                args.batch_size,
            )
            from ..data.prefetch import prefetch_to_device
            from ..utils.progress import progress

            # Hot loop like train_nerf: in-jit per-step keys + double-
            # buffered uploads (one host dispatch per step).
            batches = prefetch_to_device(batch_iter, loop.shard_batch)
            for step, batch in enumerate(
                progress(batches, desc=f"fold {fold}", total=args.train_iters)
            ):
                if step >= args.train_iters:
                    break
                loop.step_auto(base_key, batch)
        for view, loss in zip(
            valid_data.views,
            validation_losses(key, loop, valid_data, args.batch_size),
        ):
            name = getattr(view, "image_path", repr(view))
            print(loss, name)


if __name__ == "__main__":
    main()
