"""Render one or more views with a trained NeRF model.

CLI parity with the reference (``learn_nerf/scripts/render_nerf.py``):
positional ``metadata_json view_json... output_png``, same flags, frames
concatenated horizontally, u8 encoding ``(x + 1) * 127.5``.

The whole frame renders as ONE device program (rays tiled and
scanned inside a single jit, ``render.render_frame``) instead of the
reference's chunked host loop with a device sync and ``jnp.concatenate``
per chunk (``scripts/render_nerf.py:88-92``).
"""

import argparse

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
    build_occupancy_renderer,
    create_model,
    seeded_key,
)
from ..utils.device import use_compile_cache


def base_argparser() -> argparse.ArgumentParser:
    """Render flags shared by all render-family CLIs (no positionals)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--batch_size", type=int, default=1024, help="rays per render tile"
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
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    add_occupancy_args(parser)
    add_baked_args(parser)
    return parser


def argparser() -> argparse.ArgumentParser:
    parser = base_argparser()
    parser.add_argument("metadata_json", type=str)
    return parser


class RenderSession:
    """A loaded model + jitted whole-frame render function."""

    def __init__(self, args: argparse.Namespace):
        import jax
        import jax.numpy as jnp

        print("loading metadata...")
        self.metadata = ModelMetadata.from_json(args.metadata_json)

        print("loading model...")
        coarse, fine, _ = create_model(args, self.metadata)
        params = load_params_pickle(args.model_path)
        self.params = params

        self.background = jnp.asarray(params["background"], dtype=jnp.float32)
        self.key = seeded_key(args.seed)
        self.args = args
        self.images = []

        # Multi-chip by default: frame tiles shard over the data axis when
        # more than one device is visible (replicated params, no
        # collectives in the hot path); single-chip stays a plain lax.map.
        from ..parallel.mesh import DATA_AXIS, default_mesh

        mesh = default_mesh()
        self._mesh = mesh if mesh.shape[DATA_AXIS] > 1 else None

        if getattr(args, "occupancy", False):
            from ..occ_render import OccupancyFrameSession

            field_model, field_params = apply_baking(args, fine, params)
            self.renderer, grid_state = build_occupancy_renderer(
                args, self.metadata, field_model, params
            )
            self._frames = OccupancyFrameSession(
                self.renderer,
                field_params,
                self.background,
                grid_state,
                budget_cfg=getattr(args, "occ_budget_per_ray", None),
                tile_size=args.batch_size,
                transmittance_eps=getattr(args, "occ_t_eps", 0.0),
                mesh=self._mesh,  # tiles shard over the data axis
            )
            self._render = lambda key, rays: self._frames.render(key, rays)[
                "outputs"
            ]
        else:
            self.renderer = Renderer(
                coarse=coarse,
                fine=fine,
                bbox_min=tuple(self.metadata.bbox_min),
                bbox_max=tuple(self.metadata.bbox_max),
                coarse_ts=args.coarse_samples,
                fine_ts=args.fine_samples,
            )
            # Params/background as jit ARGUMENTS, device-put once — a
            # closure capture would lower them as program constants and
            # ship them to the (remote) compiler per trace
            # (tests/test_constants.py).
            if self._mesh is not None:
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P

                _put = lambda t: jax.device_put(
                    t, NamedSharding(self._mesh, P())
                )
            else:
                _put = jax.device_put
            coarse_p, fine_p, bg = _put(
                (params["coarse"], params["fine"], self.background)
            )
            if self._mesh is not None:
                from ..render import render_frame_sharded

                render_jit = jax.jit(
                    lambda key, rays, cp, fp, bg: render_frame_sharded(
                        self.renderer,
                        key,
                        rays,
                        cp,
                        fp,
                        bg,
                        mesh=self._mesh,
                        tile_size=args.batch_size,
                    ),
                )
            else:
                render_jit = jax.jit(
                    lambda key, rays, cp, fp, bg: render_frame(
                        self.renderer,
                        key,
                        rays,
                        cp,
                        fp,
                        bg,
                        tile_size=args.batch_size,
                    )["outputs"],
                )
            # Exposed for the captured-constants gate
            # (tests/test_constants.py).
            self._render_jit = render_jit
            self._render_args = (coarse_p, fine_p, bg)
            self._render = lambda key, rays: render_jit(
                key, rays, coarse_p, fine_p, bg
            )

    def render_view(self, view: CameraView, width=None, height=None) -> np.ndarray:
        """Render one view, optionally at an explicit resolution.

        The jitted frame function caches one executable per distinct ray
        count, so repeated resolutions compile once.
        """
        import jax

        width = width if width is not None else self.args.width
        height = height if height is not None else self.args.height
        rays = view.bare_rays(width, height)
        self.key, this_key = jax.random.split(self.key)
        from .common import to_u8_image

        image = to_u8_image(self._render(this_key, rays), height, width)
        self.images.append(image)
        return image

    def save(self, output_path: str) -> None:
        from PIL import Image

        Image.fromarray(np.concatenate(self.images, axis=1)).save(output_path)


def main(argv=None):
    use_compile_cache()
    parser = argparser()
    parser.add_argument("view_json", type=str, nargs="+")
    parser.add_argument("output_png", type=str)
    args = parser.parse_args(argv)

    from ..utils.progress import progress

    session = RenderSession(args)
    for view_json in progress(args.view_json, desc="views"):
        session.render_view(CameraView.from_json(view_json))
    session.save(args.output_png)


if __name__ == "__main__":
    main()
