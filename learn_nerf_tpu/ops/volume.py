"""Volumetric compositing over the per-ray sample axis.

Contract parity with the reference ``RaySamples`` math
(``learn_nerf/render.py:259-290``):

* bins are delimited by midpoints between consecutive ts, closed by
  ``t_min``/``t_max``,
* termination weights are ``P(survive to bin) * P(terminate in bin)`` with a
  final always-terminate background column, so ``weights`` has shape
  ``[N, T+1]`` and rows sum to 1,
* compositing blends per-sample colors plus the background against the
  weights; rays that miss the bbox (``mask=False``) return the background.

The sample axis T stays small (<=256) and on-chip; scaling is done by
sharding N.  ``cumsum`` over T is a cheap scan.
"""

from typing import Dict, Tuple

import jax.numpy as jnp

Array = jnp.ndarray


def bin_deltas(ts: Array, t_min: Array, t_max: Array) -> Tuple[Array, Array, Array]:
    """Midpoint bin boundaries for samples ``ts``.

    Matches reference ``render.py:259-268``.

    :param ts: ``[N, T]`` sorted sample positions.
    :param t_min: ``[N]`` range starts.
    :param t_max: ``[N]`` range ends.
    :return: ``(starts [N,T], ends [N,T], deltas [N,T])``.
    """
    mid = (ts[:, 1:] + ts[:, :-1]) * 0.5
    starts = jnp.concatenate([t_min[:, None], mid], axis=1)
    ends = jnp.concatenate([mid, t_max[:, None]], axis=1)
    return starts, ends, ends - starts


def termination_weights(densities: Array, deltas: Array) -> Array:
    """Per-bin termination probabilities with a trailing background column.

    Matches reference ``render.py:270-287``: ``w[:, t<T] = exp(-cum_prev) *
    (1 - exp(-density*dt))`` and ``w[:, T] = exp(-cum_total)``.

    :param densities: ``[N, T]`` non-negative densities.
    :param deltas: ``[N, T]`` bin widths.
    :return: ``[N, T+1]`` weights summing to 1 along axis 1.
    """
    density_dt = densities * deltas
    acc = jnp.cumsum(density_dt, axis=1)
    acc_prev = jnp.concatenate([jnp.zeros_like(acc[:, :1]), acc], axis=1)
    survive = jnp.exp(-acc_prev)  # [N, T+1]
    terminate = jnp.concatenate(
        [1.0 - jnp.exp(-density_dt), jnp.ones_like(acc[:, :1])], axis=1
    )
    return survive * terminate


def composite(
    weights: Array,
    values: Array,
    background: Array,
    mask: Array,
) -> Array:
    """Blend per-sample values and the background with termination weights.

    Matches reference ``render.py:155-176`` without materializing the
    ``[N, T+1, 3]`` concatenation: the background contribution is added as a
    rank-1 outer product.

    :param weights: ``[N, T+1]`` termination weights.
    :param values: ``[N, T, C]`` per-sample values (e.g. RGB or coords).
    :param background: ``[C]`` background value.
    :param mask: ``[N]`` bool; masked-out rays return the background.
    :return: ``[N, C]`` composited values.
    """
    fg = jnp.einsum("nt,ntc->nc", weights[:, :-1], values)
    out = fg + weights[:, -1:] * background[None, :]
    return jnp.where(mask[:, None], out, background[None, :])


def composite_alpha(weights: Array, mask: Array) -> Array:
    """Hit probability per ray: 1 minus the background weight.

    Matches reference ``render.py:178-190``.

    :param weights: ``[N, T+1]`` termination weights.
    :param mask: ``[N]`` bool.
    :return: ``[N, 1]`` alphas (0 for masked rays).
    """
    return jnp.where(mask[:, None], 1.0 - weights[:, -1:], 0.0)


def average_aux(
    weights: Array,
    aux: Dict[str, Array],
    mask: Array,
) -> Dict[str, Array]:
    """Density-weighted scalar mean of per-sample auxiliary losses.

    Semantics follow reference ``render.py:192-209``: each loss is summed
    over the sample axis against the (non-background) termination weights,
    zeroed for masked rays, then averaged.

    Note: the reference's ``jnp.where(mask[:, None], sums, 0.0)`` broadcasts
    ``[N, 1]`` against ``[N]`` into an ``[N, N]`` intermediate before the
    mean, which both wastes O(N^2) memory and skews the estimate when any
    ray is masked (it scales the *unmasked* mean by the masked fraction
    instead of dropping masked rays).  This implementation computes the
    intended masked mean directly; the two agree exactly whenever all rays
    hit the bbox.

    :param weights: ``[N, T+1]`` termination weights.
    :param aux: dict of ``[N, T]`` per-sample losses.
    :param mask: ``[N]`` bool.
    :return: dict of scalar means.
    """
    w = weights[:, :-1]
    return {
        k: jnp.mean(jnp.where(mask, jnp.sum(v * w, axis=-1), 0.0))
        for k, v in aux.items()
    }
