"""Distill a trained NeRF into a new RGBD dataset from random orbit views.

Parity with ``learn_nerf/scripts/render_new_dataset.py``: N random unit
view directions at ``distance * |bbox|`` from the center, 60-degree FOV;
writes ``{i:05}.json`` / ``.png`` / ``_depth.png`` plus a copied
``metadata.json``.  Depth is ``clip(<coords - origin, z> / alpha, 0,
max_depth) / max_depth`` where ``alpha > 0.9``, else max (``:104-121``),
encoded as 16-bit PNG.  Consumed by the ``point_cloud`` tool.
"""

import argparse
import math
import os
import shutil

import numpy as np

from ..checkpoint import load_params_pickle
from ..data.camera import CameraView
from ..data.dataset import ModelMetadata
from ..render import Renderer, render_frame
from .common import (
    add_baked_args,
    add_model_args,
    add_occupancy_args,
    apply_baking,
    create_model,
    seeded_key,
)
from ..utils.device import use_compile_cache


def main(argv=None):
    use_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1024, help="rays per tile")
    parser.add_argument("--coarse_samples", type=int, default=64)
    parser.add_argument("--fine_samples", type=int, default=128)
    parser.add_argument("--num_images", type=int, default=100)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--distance", type=float, default=1.0)
    parser.add_argument("--max_depth", type=float, default=10.0)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    add_occupancy_args(parser)
    add_baked_args(parser)
    parser.add_argument("metadata_json", type=str)
    parser.add_argument("output_dir", type=str)
    args = parser.parse_args(argv)

    if os.path.exists(args.output_dir):
        raise FileExistsError(f"output directory exists: {args.output_dir}")

    import jax
    import jax.numpy as jnp
    from PIL import Image

    metadata = ModelMetadata.from_json(args.metadata_json)
    print("loading model...")
    coarse, fine, _ = create_model(args, metadata)
    params = load_params_pickle(args.model_path)

    background = jnp.asarray(params["background"], dtype=jnp.float32)
    bbox = dict(
        bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max)
    )
    # Multi-chip by default (see scripts/render_nerf.py).
    from ..parallel.mesh import DATA_AXIS, default_mesh

    mesh = default_mesh()
    mesh = mesh if mesh.shape[DATA_AXIS] > 1 else None
    if args.occupancy:
        from ..occ_render import OccupancyFrameSession
        from .common import build_occupancy_renderer

        field_model, field_params = apply_baking(args, fine, params)
        occ_renderer, grid_state = build_occupancy_renderer(
            args, metadata, field_model, params
        )
        render = OccupancyFrameSession(
            occ_renderer,
            field_params,
            background,
            grid_state,
            budget_cfg=getattr(args, "occ_budget_per_ray", None),
            tile_size=args.batch_size,
            transmittance_eps=getattr(args, "occ_t_eps", 0.0),
            include_depth_outputs=True,
            mesh=mesh,
        ).render
    else:
        renderer = Renderer(
            coarse=coarse,
            fine=fine,
            coarse_ts=args.coarse_samples,
            fine_ts=args.fine_samples,
            **bbox,
        )
        # Params/background as jit ARGUMENTS (device-put once, replicated
        # over the mesh if any): closure-captured params would lower as
        # program constants (tests/test_constants.py).
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            _put = lambda t: jax.device_put(t, NamedSharding(mesh, P()))
        else:
            _put = jax.device_put
        coarse_p, fine_p, bg = _put(
            (params["coarse"], params["fine"], background)
        )
        render_jit = jax.jit(
            lambda key, rays, cp, fp, bg: render_frame(
                renderer,
                key,
                rays,
                cp,
                fp,
                bg,
                tile_size=args.batch_size,
                include_depth_outputs=True,
                mesh=mesh,
            )
        )
        render = lambda key, rays: render_jit(key, rays, coarse_p, fine_p, bg)

    key = seeded_key(args.seed)
    os.makedirs(args.output_dir)
    shutil.copy(args.metadata_json, os.path.join(args.output_dir, "metadata.json"))

    bbox_min = np.asarray(metadata.bbox_min)
    bbox_max = np.asarray(metadata.bbox_max)
    scale = float(np.linalg.norm(bbox_min - bbox_max))
    center = (bbox_min + bbox_max) / 2

    from ..utils.progress import progress

    # Poses from the CLI seed: --seed N must reproduce the same distilled
    # dataset (the JAX render keys alone are not enough).  Without --seed,
    # fresh random poses per run, like the reference.
    pose_rng = np.random.RandomState(args.seed)
    for frame in progress(range(args.num_images), desc="frames"):
        z = pose_rng.normal(size=(3,))
        z /= np.linalg.norm(z)
        x = np.array([z[1], -z[0], 0.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        view = CameraView(
            camera_direction=tuple(z.tolist()),
            camera_origin=tuple((-z * scale * args.distance + center).tolist()),
            x_axis=tuple(x.tolist()),
            y_axis=tuple(y.tolist()),
            x_fov=60.0 * math.pi / 180,
            y_fov=60.0 * math.pi / 180,
        )
        with open(os.path.join(args.output_dir, f"{frame:05}.json"), "w") as f:
            f.write(view.to_json())

        rays = view.bare_rays(args.size, args.size)
        key, this_key = jax.random.split(key)
        results = {k: np.asarray(v) for k, v in render(this_key, rays).items()}

        z_dir = np.asarray(view.camera_direction, np.float32)
        origin = np.asarray(view.camera_origin, np.float32)
        raw_depth = ((results["coords"] - origin) @ z_dir)[:, None] / (
            results["alphas"] + 1e-8
        )
        depth = (
            np.clip(
                np.where(results["alphas"] > 0.9, raw_depth, args.max_depth),
                0.0,
                args.max_depth,
            )
            / args.max_depth
        )

        from .common import to_u8_image

        image = to_u8_image(results["outputs"], args.size, args.size)
        Image.fromarray(image).save(os.path.join(args.output_dir, f"{frame:05}.png"))
        depth_image = (depth.reshape(args.size, args.size) * 0xFFFF).astype(np.uint16)
        Image.fromarray(depth_image).save(
            os.path.join(args.output_dir, f"{frame:05}_depth.png")
        )


if __name__ == "__main__":
    main()
