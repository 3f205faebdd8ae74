"""Model base class."""

from typing import Dict, Tuple

import jax.numpy as jnp

from .. import nn

Array = jnp.ndarray
FieldOutput = Tuple[Array, Array, Dict[str, Array]]


class FieldModel(nn.Module):
    """Base class for neural field models.

    Subclasses implement ``__call__(x, d) -> (density, rgb, aux)`` over
    arbitrary leading batch dims (contract described in
    :mod:`learn_nerf_tpu.models`).
    """

    def __call__(self, x: Array, d: Array) -> FieldOutput:
        raise NotImplementedError
