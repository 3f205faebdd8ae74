"""Extract a mesh from a trained NeRF via iso-surface extraction.

CLI parity with the reference (``learn_nerf/scripts/marching_cubes.py``):
occupancy ``1 - exp(-density)`` evaluated on a bbox grid from the *fine*
model, surfaced at ``--threshold``, x/z flipped, rescaled/centered, written
as OBJ — or STL, which the reference advertises but whose writer is dead
code (``marching_cubes.py:79``, ``:111``); here it works.

The grid sweep is one jitted ``lax.map`` over row-tiles instead
of a host loop over batches (``marching_cubes.py:56-62``).
"""

import argparse

import numpy as np

from ..checkpoint import load_params_pickle
from ..data.dataset import ModelMetadata
from ..mesh import marching_tetrahedra, write_obj, write_stl
from .common import add_model_args, create_model
from ..utils.device import use_compile_cache


def grid_coordinates(bbox_min, bbox_max, grid_size: int) -> np.ndarray:
    """``[G, G, G, 3]`` lattice spanning the bbox (reference ``:86-95``)."""
    axes = [
        np.linspace(lo, hi, num=grid_size, dtype=np.float32)
        for lo, hi in zip(bbox_min, bbox_max)
    ]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def main(argv=None):
    use_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch_size", type=int, default=8192, help="points per tile")
    parser.add_argument(
        "--resolution", type=int, default=32, help="steps along each direction"
    )
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    parser.add_argument("metadata_json", type=str)
    parser.add_argument("output_obj", type=str)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    print("loading metadata...")
    metadata = ModelMetadata.from_json(args.metadata_json)

    print("loading model...")
    _, fine, _ = create_model(args, metadata)
    params = load_params_pickle(args.model_path)["fine"]

    coords = grid_coordinates(
        metadata.bbox_min, metadata.bbox_max, args.resolution
    ).reshape(-1, 3)
    n = coords.shape[0]
    tile = min(args.batch_size, n)

    # Multi-chip by default: point tiles shard over the data axis.
    from ..parallel.mesh import DATA_AXIS, default_mesh

    mesh = default_mesh()
    n_dev = mesh.shape[DATA_AXIS]
    num_tiles = -(-n // (n_dev * tile)) * n_dev
    coords_p = np.pad(coords, ((0, num_tiles * tile - n), (0, 0)))

    # Params as a jit ARGUMENT (closure capture would lower the field's
    # tables as program constants; tests/test_constants.py).
    def scan_tiles(params, tiles):
        def one(pts):
            density, _, _ = fine.apply(
                dict(params=params), pts, jnp.zeros_like(pts)
            )
            return 1.0 - jnp.exp(-density[..., 0])

        return jax.lax.map(one, tiles)

    if n_dev > 1:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        occupancy = jax.jit(
            jax.shard_map(
                scan_tiles, mesh=mesh, in_specs=(P(), P(DATA_AXIS)),
                out_specs=P(DATA_AXIS),
            )
        )
        params_d = jax.device_put(params, NamedSharding(mesh, P()))
    else:
        occupancy = jax.jit(scan_tiles)
        params_d = jax.device_put(params)

    print("computing densities...")
    occ = np.asarray(
        occupancy(params_d, coords_p.reshape(num_tiles, tile, 3))
    ).reshape(-1)[:n]
    volume = occ.reshape([args.resolution] * 3)
    volume = np.pad(volume, 1, mode="constant", constant_values=0)

    print("extracting mesh...")
    verts, faces = marching_tetrahedra(volume, args.threshold)
    if len(verts) == 0:
        raise SystemExit("no surface found at this threshold")

    # Match the reference's output frame: flip x/z, rescale to world units,
    # center (reference :71-77).  The axis swap is a REFLECTION, so the
    # face winding must reverse with it or every cross-product normal
    # (marching_tetrahedra's outward-orientation contract, and write_stl's
    # computed normals) points inward.
    verts = np.stack([verts[..., 2], verts[..., 1], verts[..., 0]], axis=-1)
    faces = faces[:, ::-1]
    size = np.asarray(metadata.bbox_max) - np.asarray(metadata.bbox_min)
    verts *= size / args.resolution
    verts -= (verts.max(axis=0) + verts.min(axis=0)) / 2

    if args.output_obj.endswith(".stl"):
        write_stl(args.output_obj, verts, faces)
    else:
        write_obj(args.output_obj, verts, faces)
    print(f"wrote {len(verts)} vertices / {len(faces)} faces to {args.output_obj}")


if __name__ == "__main__":
    main()
