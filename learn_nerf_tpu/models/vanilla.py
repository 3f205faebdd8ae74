"""Vanilla NeRF MLP (Mildenhall et al. 2020).

Architecture parity with the reference (``learn_nerf/model.py:30-62``):
5 input layers, skip-concat of the positional embedding, 4 mid layers (ReLU
between but not after), softplus density head, and a 128-wide color branch
conditioned on the direction embedding with tanh output in ``[-1, 1]``.

The 256-wide Dense layers are the matmul workload; batches arrive as
``[N, T, F]`` and stay that shape end to end.
"""

import jax.numpy as jnp

from .. import nn
from ..ops.encoding import sinusoidal_features
from .base import FieldModel, FieldOutput

Array = jnp.ndarray


class NeRFModel(FieldModel):
    input_layers: int = 5
    mid_layers: int = 4
    hidden_dim: int = 256
    color_layer_dim: int = 128
    x_freqs: int = 10
    d_freqs: int = 4
    # "bfloat16" runs the Dense stack in bf16 (params stay f32).
    # The sinusoidal encoding always computes in f32 — bf16's 8-bit mantissa
    # cannot represent high-frequency phase (arguments up to 2^9 * x).
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(self, x: Array, d: Array) -> FieldOutput:
        dtype = jnp.dtype(self.compute_dtype)
        x_emb = sinusoidal_features(x, self.x_freqs).astype(dtype)
        d_emb = sinusoidal_features(d, self.d_freqs).astype(dtype)

        z = x_emb
        for _ in range(self.input_layers):
            z = nn.relu(nn.Dense(self.hidden_dim, dtype=dtype)(z))
        z = jnp.concatenate([z, x_emb], axis=-1)
        for i in range(self.mid_layers):
            if i > 0:
                z = nn.relu(z)
            z = nn.Dense(self.hidden_dim, dtype=dtype)(z)
        density = nn.softplus(nn.Dense(1, dtype=dtype)(z).astype(jnp.float32))
        z = jnp.concatenate([z, d_emb], axis=-1)
        z = nn.relu(nn.Dense(self.color_layer_dim, dtype=dtype)(z))
        rgb = nn.tanh(nn.Dense(3, dtype=dtype)(z).astype(jnp.float32))
        return density, rgb, {}
