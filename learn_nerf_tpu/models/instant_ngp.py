"""Instant NGP models (Mueller et al., arXiv:2201.05989).

Parity with the reference (``learn_nerf/instant_ngp.py``): multiresolution
hash-grid encoding feeding small 64-wide MLPs, ``exp`` density head, tanh
color in ``[-1, 1]``; the Ref-NeRF hybrid forces the C1 ``smooth`` encoding
so analytic normals exist (``instant_ngp.py:57-89``).

The encoding math lives in :mod:`learn_nerf_tpu.ops.hashgrid`; this module
only owns the table parameters (one ``table_i`` param per level, initialized
uniform +-1e-4 like ``instant_ngp.py:178-204``).
"""

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .. import nn
from ..ops.encoding import sinusoidal_features
from ..ops.hashgrid import dense_level_rows, hash_grid_encode
from .base import FieldModel, FieldOutput
from .ref_nerf import RefNeRFBase

Array = jnp.ndarray


class HashGridEncoding(nn.Module):
    """Owns the per-level feature tables and applies the fused encoding."""

    table_sizes: Sequence[int]
    grid_sizes: Sequence[int]
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    feature_dim: int = 2
    smooth: bool = False

    @nn.compact
    def __call__(self, x: Array) -> Array:
        if len(self.table_sizes) != len(self.grid_sizes):
            # zip() below would silently truncate to the shorter list —
            # a model quietly training with fewer levels than configured.
            raise ValueError(
                f"table_sizes ({len(self.table_sizes)}) and grid_sizes "
                f"({len(self.grid_sizes)}) must list the same number of "
                f"levels"
            )
        tables = [
            self.param(
                f"table_{i}",
                lambda key, rows=dense_level_rows(g, t): 1e-4
                * (jax.random.uniform(key, (rows, self.feature_dim)) * 2.0 - 1.0),
            )
            for i, (g, t) in enumerate(zip(self.grid_sizes, self.table_sizes))
        ]
        return hash_grid_encode(
            tables,
            x,
            self.grid_sizes,
            self.table_sizes,
            jnp.asarray(self.bbox_min, dtype=jnp.float32),
            jnp.asarray(self.bbox_max, dtype=jnp.float32),
            smooth=self.smooth,
        )


class InstantNGPModel(FieldModel):
    table_sizes: Sequence[int]
    grid_sizes: Sequence[int]
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    table_feature_dim: int = 2
    table_smooth: bool = False
    d_freqs: int = 4
    hidden_dim: int = 64
    density_dim: int = 16
    density_layers: int = 1
    color_layers: int = 2
    # "bfloat16" runs the small MLPs in bf16; the hash encoding
    # interpolation stays f32 (cheap, and the table grads need f32 scatter).
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(
        self, x: Array, d: Array, spatial_only: bool = False
    ) -> "FieldOutput | Array":
        # spatial_only=True returns the bare [.., density_dim] feature
        # vector (the baked sweep's input), NOT a FieldOutput tuple.
        dtype = jnp.dtype(self.compute_dtype)
        out = HashGridEncoding(
            table_sizes=self.table_sizes,
            grid_sizes=self.grid_sizes,
            bbox_min=self.bbox_min,
            bbox_max=self.bbox_max,
            feature_dim=self.table_feature_dim,
            smooth=self.table_smooth,
        )(x).astype(dtype)
        for _ in range(self.density_layers):
            out = nn.relu(nn.Dense(self.hidden_dim, dtype=dtype)(out))
        out = nn.Dense(self.density_dim, dtype=dtype)(out)
        if spatial_only:
            # The full spatial field in one vector: density = exp(out[0]),
            # the color head reads the rest.  This is what `baked` sweeps
            # onto a dense grid (module creation order up to here matches
            # the full path, so param names are unchanged).
            return out
        # exp in f32: bf16 exp saturates quickly and densities are unbounded.
        density = jnp.exp(out[..., 0:1].astype(jnp.float32))
        d_emb = sinusoidal_features(d, self.d_freqs).astype(dtype)
        out = jnp.concatenate([d_emb, out], axis=-1)
        for _ in range(self.color_layers):
            out = nn.relu(nn.Dense(self.hidden_dim, dtype=dtype)(out))
        color = nn.tanh(nn.Dense(3, dtype=dtype)(out).astype(jnp.float32))
        return density, color, {}


class InstantNGPRefNeRFModel(RefNeRFBase):
    """Hash-grid trunk under the Ref-NeRF head; smooth mode is forced so the
    density gradient is continuous (``instant_ngp.py:73-84``)."""

    table_sizes: Sequence[int]
    grid_sizes: Sequence[int]
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    table_feature_dim: int = 2
    d_freqs: int = 4
    hidden_dim: int = 64
    density_dim: int = 16
    density_layers: int = 1
    color_layers: int = 2

    def spatial_block(self, x: Array) -> Array:
        x = HashGridEncoding(
            table_sizes=self.table_sizes,
            grid_sizes=self.grid_sizes,
            bbox_min=self.bbox_min,
            bbox_max=self.bbox_max,
            feature_dim=self.table_feature_dim,
            smooth=True,
        )(x)
        for _ in range(self.density_layers):
            x = nn.relu(nn.Dense(self.hidden_dim)(x))
        return nn.Dense(self.density_dim)(x)

    def directional_block(self, x: Array) -> Array:
        for _ in range(self.color_layers):
            x = nn.relu(nn.Dense(self.hidden_dim)(x))
        return nn.Dense(3)(x)
