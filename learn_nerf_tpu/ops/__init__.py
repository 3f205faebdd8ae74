"""Numeric primitives for volumetric rendering.

Everything in this package is shaped ``[N, ...]`` over a ray batch and is
safe to trace under ``jax.jit`` / ``shard_map`` with the batch axis sharded
over a device mesh.  No data-dependent Python control flow, no per-ray
``vmap``: each op is written directly in batched form so XLA can tile and
fuse it.
"""

from .geometry import ray_bbox_range
from .sampling import stratified_ts, inverse_cdf_ts, merge_sorted
from .volume import (
    bin_deltas,
    termination_weights,
    composite,
    composite_alpha,
    average_aux,
)
from .encoding import sinusoidal_features
from .sh import spherical_harmonics, integrated_dir_enc

__all__ = [
    "ray_bbox_range",
    "stratified_ts",
    "inverse_cdf_ts",
    "merge_sorted",
    "bin_deltas",
    "termination_weights",
    "composite",
    "composite_alpha",
    "average_aux",
    "sinusoidal_features",
    "spherical_harmonics",
    "integrated_dir_enc",
]
