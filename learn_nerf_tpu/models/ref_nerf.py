"""Ref-NeRF (Verbin et al., arXiv:2112.03907).

Behaviour parity with the reference (``learn_nerf/ref_nerf.py:19-118``):

* the spatial block's output channels split into
  ``density(1) | diffuse(3) | spectral(1) | roughness(1) | normal(3) |
  bottleneck`` (``ref_nerf.py:45-47``),
* the analytic normal is the normalized negative density gradient.  The
  reference calls ``jax.grad`` of a scalarized spatial pass
  (``ref_nerf.py:38-43``), re-running the forward; here a single ``jax.vjp``
  shares the forward activations with the primal outputs — one spatial-MLP
  evaluation plus one transposed pass instead of two forwards + one
  transpose,
* view directions reflect about the predicted normal and feed the
  integrated directional encoding (``ref_nerf.py:58-63``),
* the final color is gamma-compressed (linear -> sRGB) and mapped to
  ``[-1, 1]`` (``ref_nerf.py:67-71``),
* aux losses: ``normal_mse`` (predicted vs analytic normal) and
  ``neg_normal`` (normals facing away from the camera), ``ref_nerf.py:72-75``.
"""

import math

import jax
import jax.numpy as jnp

from .. import nn
from ..ops.encoding import sinusoidal_features
from ..ops.sh import integrated_dir_enc
from .base import FieldModel, FieldOutput

Array = jnp.ndarray

# Channels consumed by the physical heads; the rest is bottleneck.
REF_NERF_OUT_DIM = 9


def safe_normalize(v: Array, eps: float = 1e-10) -> Array:
    """Normalize without NaN at the origin (reference ``ref_nerf.py:314-317``)."""
    return v * jax.lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True) + eps)


def leaky_clip(x: Array) -> Array:
    """Clip to [0, 1] but keep identity gradients (``ref_nerf.py:320-326``)."""
    return x + jax.lax.stop_gradient(jnp.clip(x, 0.0, 1.0) - x)


def linear_to_srgb(colors: Array) -> Array:
    """Gamma compression, NaN-safe at 0 (``ref_nerf.py:110-118``)."""
    safe = jnp.maximum(1e-5, colors)
    return jnp.where(
        colors <= 0.0031308, 12.92 * colors, 1.055 * safe ** (1.0 / 2.4) - 0.055
    )


class RefNeRFBase(FieldModel):
    """Shared Ref-NeRF head over pluggable spatial/directional blocks."""

    sh_degree: int

    def spatial_block(self, x: Array) -> Array:
        raise NotImplementedError

    def directional_block(self, x: Array) -> Array:
        raise NotImplementedError

    @nn.compact
    def __call__(self, x: Array, d: Array) -> FieldOutput:
        # One forward through the spatial block, reused for both the primal
        # outputs and the density-gradient normal via the VJP transpose.
        spatial_out, vjp_fn = jax.vjp(self.spatial_block, x)
        cotangent = jnp.zeros_like(spatial_out).at[..., 0].set(-1.0)
        (real_normal,) = vjp_fn(cotangent)
        real_normal = safe_normalize(real_normal)

        if spatial_out.shape[-1] < REF_NERF_OUT_DIM:
            raise ValueError(
                f"Ref-NeRF spatial block must emit >= {REF_NERF_OUT_DIM} "
                f"channels (density, diffuse, spectral, roughness, normal); "
                f"got {spatial_out.shape[-1]} — raise the trunk's output dim"
            )
        density = jnp.exp(spatial_out[..., 0:1])
        # Initialize diffuse near 0.25 so the initial summed color is ~0.5.
        diffuse = nn.sigmoid(spatial_out[..., 1:4] - math.log(3))
        spectral = nn.sigmoid(spatial_out[..., 4:5])
        roughness = nn.softplus(spatial_out[..., 5:6])
        normal = safe_normalize(spatial_out[..., 6:9])

        reflection = d - 2.0 * normal * jnp.sum(d * normal, axis=-1, keepdims=True)
        reflection_enc = integrated_dir_enc(self.sh_degree, reflection, roughness)
        normal_dot = jnp.sum(-d * normal, axis=-1, keepdims=True)
        dir_input = jnp.concatenate([spatial_out, reflection_enc, normal_dot], axis=-1)
        spectral_color = nn.sigmoid(self.directional_block(dir_input))

        full_color = (
            linear_to_srgb(leaky_clip(spectral_color * spectral + diffuse)) * 2.0 - 1.0
        )
        aux = dict(
            normal_mse=jnp.sum((normal - real_normal) ** 2, axis=-1),
            neg_normal=jnp.maximum(0.0, jnp.sum(normal * d, axis=-1)) ** 2,
        )
        return density, full_color, aux


class RefNeRFModel(RefNeRFBase):
    """Ref-NeRF on the original NeRF MLP trunk (``ref_nerf.py:80-107``)."""

    input_layers: int = 5
    mid_layers: int = 4
    hidden_dim: int = 256
    color_layer_dim: int = 128
    x_freqs: int = 10
    d_freqs: int = 4

    def spatial_block(self, x: Array) -> Array:
        x_emb = sinusoidal_features(x, self.x_freqs)
        z = x_emb
        for _ in range(self.input_layers):
            z = nn.relu(nn.Dense(self.hidden_dim)(z))
        z = jnp.concatenate([z, x_emb], axis=-1)
        for i in range(self.mid_layers):
            if i > 0:
                z = nn.relu(z)
            z = nn.Dense(self.hidden_dim)(z)
        return z

    def directional_block(self, x: Array) -> Array:
        z = nn.relu(nn.Dense(self.color_layer_dim)(x))
        return nn.Dense(3)(z)
