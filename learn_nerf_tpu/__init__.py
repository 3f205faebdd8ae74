"""learn_nerf_tpu: a NeRF training and rendering framework in JAX.

A from-scratch re-design of the capabilities of unixpickle/learn-nerf for
accelerators driven by XLA (its target is NVIDIA GPUs):

* all hot-path math is batched ``[N, T]`` JAX traced once under ``jax.jit``
  (the reference orchestrates per-ray ``vmap`` + reshape-to-flat pipelines),
* ray batches shard over a ``jax.sharding.Mesh`` ``data`` axis; gradients are
  combined by XLA collectives inserted by GSPMD,
* the hot paths are plain ``jnp``/``lax`` compiled by XLA, with no
  hand-written kernel (docs/DESIGN.md §3),
* checkpointing keeps the reference's pickle contract
  (``{"coarse", "fine", "background"}``, reference ``train.py:62-76``) while
  adding full train-state checkpoints.

Public surface parity map (reference -> here):

* ``learn_nerf.model``        -> :mod:`learn_nerf_tpu.models`
* ``learn_nerf.render``       -> :mod:`learn_nerf_tpu.render`
* ``learn_nerf.train``        -> :mod:`learn_nerf_tpu.train`
* ``learn_nerf.dataset``      -> :mod:`learn_nerf_tpu.data`
* ``learn_nerf.scripts.*``    -> :mod:`learn_nerf_tpu.scripts`
* ``simple_dataset`` (Go)     -> ``tools/simple_dataset`` (C++)
* ``point_cloud`` (Go)        -> ``tools/point_cloud`` (C++)
* ``convert_dataset/*``       -> :mod:`learn_nerf_tpu.convert`
"""

__version__ = "0.1.0"
