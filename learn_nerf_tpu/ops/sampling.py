"""Sampling along rays: stratified bins and inverse-CDF importance sampling.

Contract parity with the reference hierarchy
(``learn_nerf/render.py:121-143`` stratified; ``render.py:211-257`` fine):

* stratified: ``count`` equal bins in ``[t_min, t_max]``, one uniform sample
  per bin.
* fine: piecewise-linear inverse CDF built from coarse termination weights
  (with a floor ``eps``), evaluated at stratified points in ``[0, 1]``,
  optionally merged with the coarse ts into a single sorted array.

Differences from the reference:

* everything is batched ``[N, T]`` — the reference's per-ray
  ``jax.vmap(jnp.interp)`` (``render.py:251``) becomes one batched
  searchsorted + gather + lerp,
* the merge of coarse and fine ts is ``jnp.sort`` over the concatenation,
  same as the reference (``render.py:253-255``): the "smarter"
  rank-scatter merge (two searchsorteds + one scatter) was built and
  measured slower (premise not yet measured on the H100; see
  :func:`merge_sorted` and docs/DESIGN.md section 3).
"""

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def stratified_ts(
    key: jax.Array,
    t_min: Array,
    t_max: Array,
    count: int,
) -> Array:
    """Stratified samples: one uniform draw per equal bin.

    :param key: PRNG key.
    :param t_min: ``[N]`` lower bounds.
    :param t_max: ``[N]`` upper bounds.
    :param count: samples per ray.
    :return: ``[N, count]`` sorted sample positions.
    """
    bin_size = ((t_max - t_min) / count)[:, None]  # [N, 1]
    offsets = jnp.arange(count, dtype=jnp.float32)[None, :]  # [1, T]
    u = jax.random.uniform(key, (t_min.shape[0], count))
    return t_min[:, None] + (offsets + u) * bin_size


def batched_interp(x: Array, xp: Array, fp: Array) -> Array:
    """Rowwise linear interpolation: ``out[n, i] = interp(x[n, i], xp[n], fp[n])``.

    ``xp`` must be non-decreasing along its last axis.  Matches
    ``jnp.interp``'s clamp-to-endpoint behaviour outside the range.

    :param x: ``[N, M]`` query points.
    :param xp: ``[N, K]`` sorted knot positions.
    :param fp: ``[N, K]`` knot values.
    :return: ``[N, M]`` interpolated values.
    """
    k = xp.shape[-1]
    # Index of the right knot for each query, in [1, K-1].
    idx = jax.vmap(lambda xq, xk: jnp.searchsorted(xk, xq, side="right"))(x, xp)
    idx = jnp.clip(idx, 1, k - 1)
    x0 = jnp.take_along_axis(xp, idx - 1, axis=-1)
    x1 = jnp.take_along_axis(xp, idx, axis=-1)
    f0 = jnp.take_along_axis(fp, idx - 1, axis=-1)
    f1 = jnp.take_along_axis(fp, idx, axis=-1)
    denom = x1 - x0
    t = jnp.where(denom > 0, (x - x0) / jnp.where(denom == 0, 1.0, denom), 0.0)
    out = f0 + t * (f1 - f0)
    # Clamp outside the knot range like jnp.interp.
    out = jnp.where(x < xp[:, :1], fp[:, :1], out)
    out = jnp.where(x > xp[:, -1:], fp[:, -1:], out)
    return out


def inverse_cdf_ts(
    key: jax.Array,
    weights: Array,
    t_min: Array,
    bin_ends: Array,
    count: int,
    eps: float = 1e-8,
) -> Array:
    """Importance-sample ``count`` new ts per ray from termination weights.

    Builds the same piecewise-linear inverse CDF as the reference
    (``render.py:232-251``): knots at ``x = normalized cumsum of (w + eps)``
    prefixed with 0, ``y = [t_min, bin_ends]``.

    :param key: PRNG key.
    :param weights: ``[N, T]`` per-bin termination weights (background
                    column already stripped).
    :param t_min: ``[N]`` ray range starts.
    :param bin_ends: ``[N, T]`` per-bin end positions (midpoint boundaries).
    :param count: number of new samples per ray.
    :return: ``[N, count]`` sorted sampled positions.
    """
    w = weights + eps
    cdf = jnp.cumsum(w, axis=1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[:, :1]), cdf], axis=1)
    cdf = cdf / cdf[:, -1:]
    knots_y = jnp.concatenate([t_min[:, None], bin_ends], axis=1)

    zeros = jnp.zeros_like(t_min)
    u = stratified_ts(key, zeros, jnp.ones_like(t_min), count)
    return batched_interp(u, cdf, knots_y)


def merge_sorted(a: Array, b: Array) -> Array:
    """Merge two rowwise-sorted arrays into one sorted array.

    Implemented as ``jnp.sort(concat)``, which measured faster end-to-end
    than a rank-scatter merge (two batched searchsorteds + one scatter)
    on the vanilla train step (premise not yet measured on the H100).
    Matches reference ``render.py:253-255`` numerically.

    :param a: ``[N, Ta]`` sorted along axis 1.
    :param b: ``[N, Tb]`` sorted along axis 1.
    :return: ``[N, Ta + Tb]`` sorted merge.
    """
    return jnp.sort(jnp.concatenate([a, b], axis=1), axis=1)
