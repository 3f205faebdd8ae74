"""Validate that a dataset's bbox covers the scene content.

Parity with ``learn_nerf/scripts/check_bbox.py``: reports (min, max, mean)
color of pixels whose rays *miss* the bbox — if those aren't all background,
the bbox is too small.
"""

import argparse

import numpy as np

from ..data.dataset import load_dataset
from ..ops.geometry import ray_bbox_range
from ..utils.device import use_compile_cache


def main(argv=None):
    use_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dataset = load_dataset(args.data_dir)
    bbox_min = jnp.asarray(dataset.metadata.bbox_min, dtype=jnp.float32)
    bbox_max = jnp.asarray(dataset.metadata.bbox_max, dtype=jnp.float32)

    mask_fn = jax.jit(
        lambda rays: ray_bbox_range(rays[:, 0], rays[:, 1], bbox_min, bbox_max)[2]
    )

    from ..utils.progress import progress

    min_color = None
    max_color = None
    color_sum = np.zeros(3)
    total = 0
    for view in progress(dataset.views, desc="views"):
        colored = view.rays()
        miss = ~np.asarray(mask_fn(jnp.asarray(colored[:, :2])))
        colors = colored[miss, 2]
        if colors.shape[0] == 0:
            continue
        local_min = colors.min(axis=0)
        local_max = colors.max(axis=0)
        min_color = local_min if min_color is None else np.minimum(min_color, local_min)
        max_color = local_max if max_color is None else np.maximum(max_color, local_max)
        color_sum += colors.sum(axis=0)
        total += colors.shape[0]

    if total == 0:
        print("no rays missed the bounding box")
        return
    print("min color", min_color.tolist())
    print("max color", max_color.tolist())
    print("mean color", (color_sum / total).tolist())


if __name__ == "__main__":
    main()
