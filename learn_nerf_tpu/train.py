"""Training: loss, mesh-aware jitted step, and a stateful loop wrapper.

Loss contract parity with the reference ``TrainLoop.losses``
(``learn_nerf/train.py:114-165``): ``MSE(coarse) + MSE(fine) + sum of
weighted aux losses`` with default weights ``normal_mse=3e-4,
neg_normal=0.1`` (``train.py:187-191``), plus an optional mean-density
penalty at uniform random bbox points (``train.py:153-184``).  Optimizer is
Adam with the reference defaults (``train.py:30-32``); the logged dict
carries per-term losses plus ``grad_norm`` / ``param_norm``
(``train.py:92-104``).

The step is one jitted program whose ray batch is sharded over the mesh
``data`` axis; params are replicated and GSPMD inserts the gradient
all-reduce.  The state is donated so Adam updates happen in place in
device memory.
"""

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

from .acceleration import OccupancyGrid
from .models.base import FieldModel
from .occ_render import OccupancyRenderer
from .parallel.mesh import default_mesh, replicated_sharding
from .render import Renderer

Array = jnp.ndarray


def default_loss_weights() -> Dict[str, float]:
    return dict(normal_mse=3e-4, neg_normal=0.1)


def tree_norm(tree: Any) -> Array:
    return jnp.sqrt(
        sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(tree))
    )


def average_density(
    key: jax.Array,
    model: FieldModel,
    params: Any,
    bbox_min: Array,
    bbox_max: Array,
    batch_size: int,
) -> Array:
    """Mean model density at uniform random points in the bbox.

    Parity with reference ``train.py:167-184`` including its reuse of one
    key for both the coordinate and direction draws.
    """
    coords = (
        jax.random.uniform(key, shape=(batch_size, 3)) * (bbox_max - bbox_min)
        + bbox_min
    )
    dirs = jax.random.normal(key, shape=(batch_size, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    densities, _, _ = model.apply(dict(params=params), coords, dirs)
    return jnp.mean(densities)


def compute_losses(
    renderer: Renderer,
    params: Dict[str, Any],
    key: jax.Array,
    batch: Array,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
) -> Tuple[Array, Dict[str, Array]]:
    """Total training loss and a logging dict for one ray batch.

    :param batch: ``[N, 3, 3]`` rows of (origin, direction, target color).
    """
    key, density_key = jax.random.split(key)
    out = renderer.render_rays(
        key,
        batch[:, :2],
        coarse_params=params["coarse"],
        fine_params=params["fine"],
        background=params["background"],
    )
    targets = batch[:, 2]
    coarse_loss = jnp.mean((out["coarse"]["outputs"] - targets) ** 2)
    fine_loss = jnp.mean((out["fine"]["outputs"] - targets) ** 2)

    loss_dict = dict(coarse=coarse_loss, fine=fine_loss)
    total = coarse_loss + fine_loss
    for prefix in ("coarse", "fine"):
        for name, value in out[f"{prefix}_aux"].items():
            loss_dict[f"{prefix}_{name}"] = value
            total = total + loss_weights[name] * value

    if density_penalty is not None:
        bbox_min = jnp.asarray(renderer.bbox_min, dtype=jnp.float32)
        bbox_max = jnp.asarray(renderer.bbox_max, dtype=jnp.float32)
        for prefix, model in (("fine", renderer.fine), ("coarse", renderer.coarse)):
            penalty = average_density(
                density_key,
                model,
                params[prefix],
                bbox_min,
                bbox_max,
                density_penalty_batch_size,
            )
            loss_dict[f"{prefix}_density"] = penalty
            total = total + density_penalty * penalty

    return total, loss_dict


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "opt_state", "ema_params"],
    meta_fields=["tx"],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Params, optimizer state and step counter, plus Polyak-averaged eval
    params.

    ``ema_params`` is ``None`` when EMA is disabled (the default) — the
    field then adds nothing to the checkpoint or the compiled step.  When
    enabled (``ema_decay`` on the loops / ``--ema`` on the train CLI) the
    step updates ``ema <- decay * ema + (1 - decay) * params`` in-jit and
    checkpoints/rendering read the averaged weights.  Constant-lr Adam
    oscillates near convergence (~10x loss excursions, docs/DESIGN.md
    section 3); the average rides over the oscillation, so the endpoint
    stops depending on the stop-step phase.  Instant NGP trains with the
    same trick (EMA of weights for eval).
    """

    step: Any
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation
    ema_params: Any = None

    replace = dataclasses.replace

    @classmethod
    def create(cls, params: Any, tx: optax.GradientTransformation, ema_params: Any = None):
        return cls(
            step=0, params=params, opt_state=tx.init(params), tx=tx,
            ema_params=ema_params,
        )

    def apply_gradients(self, grads: Any) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
        )


def _ema_seed(params: Any) -> Any:
    """Independent copy of ``params`` to seed the average.

    The step donates the whole state; an EMA tree that ALIASES the param
    buffers would hand the same buffer to XLA twice (donation error).
    """
    return jax.tree_util.tree_map(jnp.copy, params)


def _ema_step(state: TrainState, decay: float) -> TrainState:
    """One in-jit EMA update after ``apply_gradients``."""
    return state.replace(
        ema_params=jax.tree_util.tree_map(
            lambda e, p: e * decay + p * (1.0 - decay),
            state.ema_params,
            state.params,
        )
    )


def _grad_step(loss_fn, state, ema_decay, **loss_kwargs):
    """THE gradient step shared by every loop/body: grad with aux, norm
    metrics, Adam update, optional EMA.  One definition, so a change
    (grad clipping, a new logged norm) cannot drift between the
    hierarchy, occupancy-dense, and occupancy-pooled bodies."""
    grads, values = jax.grad(
        lambda p: loss_fn(p, **loss_kwargs), has_aux=True
    )(state.params)
    values = dict(
        values, grad_norm=tree_norm(grads), param_norm=tree_norm(state.params)
    )
    state = state.apply_gradients(grads=grads)
    if ema_decay is not None:
        state = _ema_step(state, ema_decay)
    return state, values


class TrainLoop:
    """Stateful training loop over a coarse/fine hierarchy.

    Compared to the reference ``TrainLoop`` (``train.py:17-112``): the scene
    bbox is bound at construction (it is part of the renderer), the step is
    donated + mesh-sharded, and the full optimizer state/step counter can be
    checkpointed (the reference saves params only, losing Adam moments on
    resume — SURVEY.md section 5).
    """

    def __init__(
        self,
        coarse: FieldModel,
        fine: FieldModel,
        init_rng: jax.Array,
        lr: "float | optax.Schedule",
        coarse_ts: int,
        fine_ts: int,
        bbox_min,
        bbox_max,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-7,
        loss_weights: Optional[Dict[str, float]] = None,
        density_penalty: Optional[float] = None,
        density_penalty_batch_size: int = 128,
        ema_decay: Optional[float] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.renderer = Renderer(
            coarse=coarse,
            fine=fine,
            bbox_min=tuple(np.asarray(bbox_min, dtype=np.float32).tolist()),
            bbox_max=tuple(np.asarray(bbox_max, dtype=np.float32).tolist()),
            coarse_ts=coarse_ts,
            fine_ts=fine_ts,
        )
        self.loss_weights = (
            loss_weights if loss_weights is not None else default_loss_weights()
        )
        self.density_penalty = density_penalty
        self.density_penalty_batch_size = density_penalty_batch_size
        self.mesh = mesh if mesh is not None else default_mesh()

        self.ema_decay = ema_decay
        coarse_rng, fine_rng = jax.random.split(init_rng)
        example = jnp.zeros((1, 3))
        coarse_vars = coarse.init(dict(params=coarse_rng), example, example)
        fine_vars = fine.init(dict(params=fine_rng), example, example)
        params = dict(
            coarse=coarse_vars["params"],
            fine=fine_vars["params"],
            background=jnp.array([-1.0, -1.0, -1.0]),
        )
        state = TrainState.create(
            params=params,
            tx=optax.adam(lr, b1=adam_b1, b2=adam_b2, eps=adam_eps),
            ema_params=_ema_seed(params) if ema_decay is not None else None,
        )
        # Replicate once; GSPMD propagates shardings from the operands.
        self.state = jax.device_put(state, replicated_sharding(self.mesh))
        self._step_fn = self._build_step()

    def _build_step(self):
        loss_fn = partial(
            compute_losses,
            self.renderer,
            loss_weights=self.loss_weights,
            density_penalty=self.density_penalty,
            density_penalty_batch_size=self.density_penalty_batch_size,
        )

        def step_body(state, key, batch):
            return _grad_step(loss_fn, state, self.ema_decay, key=key, batch=batch)

        @partial(jax.jit, donate_argnums=0)
        def step(state, key, batch):
            return step_body(state, key, batch)

        @partial(jax.jit, donate_argnums=0)
        def step_auto(state, base_key, batch):
            # Per-step key derived ON DEVICE from the optimizer step counter:
            # the host never dispatches jax.random.split per step (each tiny
            # dispatch costs a host round trip).
            return step_body(state, jax.random.fold_in(base_key, state.step), batch)

        self._auto_step_fn = step_auto

        @partial(jax.jit, donate_argnums=0)
        def step_auto_scan(state, base_key, batches):
            # K steps as ONE device program (same rationale as
            # OccupancyTrainLoop.step_auto_many: fewer dispatches).  Keys
            # fold state.step
            # exactly like step_auto, so K scanned steps are bit-identical
            # to K step_auto calls.
            def body(state, batch):
                key = jax.random.fold_in(base_key, state.step)
                return step_body(state, key, batch)

            state, values = jax.lax.scan(body, state, batches)
            # Last step's metrics, sliced in-jit (stacked [k] metrics
            # would cost one tiny device fetch per metric on the host).
            return state, jax.tree_util.tree_map(lambda v: v[-1], values)

        self._scan_step_fn = step_auto_scan
        return step

    def shard_batch(self, batch) -> jax.Array:
        """Place a host batch onto the mesh, sharded over rays.

        Single-process: a plain ``device_put``.  Multi-process: the batch is
        this host's local slice; every host contributes its rows via
        ``make_array_from_process_local_data`` (no host sees the global
        batch).  Already-assembled ``jax.Array``s pass through.
        """
        if isinstance(batch, jax.Array):
            return batch
        from .parallel.mesh import global_batch_from_local

        return global_batch_from_local(self.mesh, np.asarray(batch))

    def step(self, key: jax.Array, batch: Array) -> Dict[str, Array]:
        """One in-place training step; returns the (lazy) logging dict."""
        self.state, values = self._step_fn(self.state, key, self.shard_batch(batch))
        return values

    def step_auto(self, base_key: jax.Array, batch: Array) -> Dict[str, Array]:
        """Hot-loop step: the per-step key is ``fold_in(base_key, step)``
        computed inside the jitted program, so the host issues exactly one
        dispatch per step.  Pass the SAME ``base_key`` every call; the key
        sequence continues correctly across a full-state resume because it
        is a pure function of the checkpointed step counter."""
        self.state, values = self._auto_step_fn(
            self.state, base_key, self.shard_batch(batch)
        )
        return values

    def shard_batches(self, batches) -> jax.Array:
        """Place a ``[k, N, 3, 3]`` multi-step batch onto the mesh (rays
        sharded over axis 1, scan axis replicated)."""
        if isinstance(batches, jax.Array):
            return batches
        from .parallel.mesh import macro_batch_sharding

        sharding = macro_batch_sharding(self.mesh)
        local = np.asarray(batches)
        if jax.process_count() == 1:
            return jax.device_put(local, sharding)
        return jax.make_array_from_process_local_data(sharding, local)

    def step_auto_many(self, base_key: jax.Array, batches) -> Dict[str, Array]:
        """K hot-loop steps in ONE device dispatch (``lax.scan`` in-jit);
        bit-identical to K :meth:`step_auto` calls.  Returns the LAST
        step's logging dict.

        :param batches: ``[k, N, 3, 3]`` stacked ray batches.
        """
        self.state, values = self._scan_step_fn(
            self.state, base_key, self.shard_batches(batches)
        )
        return values

    def eval_losses(self, key: jax.Array, batch: Array) -> Dict[str, Array]:
        """Loss dict without a gradient step (test-set monitoring).

        Evaluates :attr:`eval_params` — with EMA on, the test curve must
        track the weights actually checkpointed/rendered, not the raw
        params' near-convergence oscillation."""
        if not hasattr(self, "_eval_fn"):
            loss_fn = partial(
                compute_losses,
                self.renderer,
                loss_weights=self.loss_weights,
                density_penalty=self.density_penalty,
                density_penalty_batch_size=self.density_penalty_batch_size,
            )
            self._eval_fn = jax.jit(
                lambda params, key, batch: loss_fn(params, key=key, batch=batch)[1]
            )
        return self._eval_fn(self.eval_params, key, self.shard_batch(batch))

    # -- checkpointing ----------------------------------------------------

    @property
    def eval_params(self):
        """Params rendering/checkpoints should use: the Polyak average
        when ``ema_decay`` is set, the raw train params otherwise.

        Keys on BOTH the loop config and the state: a state restored from
        an EMA checkpoint into an EMA-off loop must not serve the stale
        (never-again-updated) average (checkpoint migration also drops
        it, ``checkpoint._reconcile_ema``)."""
        if self.ema_decay is not None and self.state.ema_params is not None:
            return self.state.ema_params
        return self.state.params

    def save(self, path: str) -> None:
        """Write the reference-compatible params pickle (atomic).

        Saves :attr:`eval_params` (the EMA weights when enabled).  Adds
        ``train_host_step`` next to the reference's
        ``coarse/fine/background`` keys (render CLIs index by name, so
        the extra key is inert to them) so a pickle resume continues the
        ``step_auto`` PRNG stream instead of replaying keys from 0 —
        same design as :meth:`OccupancyTrainLoop.save`.
        """
        from .checkpoint import save_params_pickle

        payload = dict(
            self.eval_params, train_host_step=np.int64(int(self.state.step))
        )
        save_params_pickle(path, payload)

    def load(self, path: str) -> None:
        """Load params from a reference-compatible pickle."""
        from .checkpoint import load_params_pickle

        payload = load_params_pickle(path)
        params = dict(
            coarse=payload["coarse"],
            fine=payload["fine"],
            background=payload["background"],
        )
        state = self.state.replace(
            params=params,
            # A params pickle has one tree: seed the average from it.
            ema_params=_ema_seed(params)
            if self.state.ema_params is not None
            else None,
        )
        if "train_host_step" in payload:
            # step_auto derives per-step keys as fold_in(base, state.step);
            # restarting at 0 would replay the original run's key sequence
            # against already-trained params.  Reference pickles lack the
            # key (their resume has the same flaw) — nothing to restore.
            state = state.replace(
                step=jnp.asarray(int(payload["train_host_step"]))
            )
        self.state = jax.device_put(state, replicated_sharding(self.mesh))

    def save_full(self, path: str) -> None:
        from .checkpoint import save_train_state

        save_train_state(path, self.state)

    def load_full(self, path: str) -> None:
        from .checkpoint import load_train_state

        state = load_train_state(path, self.state)
        self.state = jax.device_put(state, replicated_sharding(self.mesh))


def _single_model_loss_tail(
    renderer: OccupancyRenderer,
    params: Dict[str, Any],
    density_key: jax.Array,
    outputs: Array,
    aux: Dict[str, Array],
    targets: Array,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float],
    density_penalty_batch_size: int,
) -> Tuple[Array, Dict[str, Array]]:
    """Shared loss assembly for the single-field occupancy paths.

    ONE definition of MSE + weighted aux + optional density penalty (the
    ``fine``-prefixed log contract), used by both
    :func:`compute_losses_occupancy` and
    :func:`compute_losses_occupancy_pooled` so the loss contract cannot
    drift between the dense and pooled training paths.
    """
    fine_loss = jnp.mean((outputs - targets) ** 2)
    loss_dict = dict(fine=fine_loss)
    total = fine_loss
    for name, value in aux.items():
        loss_dict[f"fine_{name}"] = value
        total = total + loss_weights[name] * value
    if density_penalty is not None:
        penalty = average_density(
            density_key,
            renderer.model,
            params["fine"],
            jnp.asarray(renderer.bbox_min, dtype=jnp.float32),
            jnp.asarray(renderer.bbox_max, dtype=jnp.float32),
            density_penalty_batch_size,
        )
        loss_dict["fine_density"] = penalty
        total = total + density_penalty * penalty
    return total, loss_dict


def compute_losses_occupancy(
    renderer: OccupancyRenderer,
    params: Dict[str, Any],
    key: jax.Array,
    batch: Array,
    grid_state,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
) -> Tuple[Array, Dict[str, Array]]:
    """Loss for the occupancy-accelerated single-model path.

    Mirrors :func:`compute_losses` with one field model: the log dict uses
    the ``fine`` prefix so monitoring/plot tooling keeps working, and the
    optional density penalty (reference ``train.py:153-163``) applies to
    the single model.
    """
    key, density_key = jax.random.split(key)
    out, aux = renderer.render_rays(
        key, batch[:, :2], params["fine"], params["background"], grid_state
    )
    return _single_model_loss_tail(
        renderer, params, density_key, out["outputs"], aux, batch[:, 2],
        loss_weights, density_penalty, density_penalty_batch_size,
    )


def compute_losses_occupancy_pooled(
    renderer: OccupancyRenderer,
    params: Dict[str, Any],
    key: jax.Array,
    batch: Array,
    grid_state,
    loss_weights: Dict[str, float],
    budget: int,
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
    transmittance_eps: float = 0.0,
) -> Tuple[Array, Dict[str, Array]]:
    """Pooled-compaction variant of :func:`compute_losses_occupancy`.

    The field model runs on the batch's actual survivor count (one
    ``[budget]`` pool) instead of ``[N, K]``; training batches are random
    rays, so per-batch demand concentrates at the scene mean and a budget
    of mean + margin drops nothing.  Same loss contract.
    ``transmittance_eps`` > 0 additionally prunes candidates the grid's
    own EMA densities mark as occluded before they reach the pool —
    their compositing weights (and gradients) are ~0 anyway, and on
    scenes whose grid stays fat it is what lets a small budget suffice.
    """
    key, density_key = jax.random.split(key)
    out = renderer.render_rays_pooled(
        key, batch[:, :2], params["fine"], params["background"], grid_state,
        budget=budget, transmittance_eps=transmittance_eps,
    )
    total, loss_dict = _single_model_loss_tail(
        renderer, params, density_key, out["outputs"], out["aux"],
        batch[:, 2], loss_weights, density_penalty,
        density_penalty_batch_size,
    )
    # No-silent-caps during TRAINING too: an undersized pool drops the
    # trailing rays' samples (gradient starvation on those rays), which
    # was previously invisible — the counter now rides the step metrics
    # (``fine_pool_dropped=0`` in healthy runs; the auto budget
    # re-measures demand periodically but can lag a grid refresh).
    loss_dict["fine_pool_dropped"] = out["dropped"]
    return total, loss_dict


class OccupancyTrainLoop:
    """Training loop for the occupancy-grid fast path (single field model).

    The occupancy grid state is carried alongside the optimizer state and
    refreshed every ``update_interval`` steps with a partial EMA update
    (``acceleration.OccupancyGrid.update``); the grid is saved into the
    checkpoint so rendering can reuse it.

    With ``pool_budget_per_ray`` set, after ``pool_start_step`` steps the
    step switches to the pooled-compaction loss (one second compile): by
    then the grid has begun culling, a batch's total survivor count sits
    near ``N * scene_mean``, and the field model stops paying for ``[N, K]``
    padding.  Before that point (grid fully occupied) pooling would
    overflow any useful budget, so the dense step runs first.

    ``pool_budget_per_ray="auto"`` sizes the pool from measured demand —
    no per-scene tuning: every 256 steps one host fetch measures the mean
    per-ray survivor count of a real batch (the exact selection the
    pooled pass applies, including the ``pool_t_eps`` transmittance
    prune) and maps ``demand * 1.3`` up to a quantized bucket, so the
    budget tracks the grid's cull-in (and any demand RISE after a grid
    refresh marks new geometry) with at most one recompile per crossed
    bucket.  ``pool_t_eps`` also prunes
    grid-estimated-occluded candidates first, but is MEASURED HARMFUL
    while the grid is still training (the EMA overestimates young-model
    fog; pruning behind it starves the true surface of gradient — loss
    diverged 10x on the compound scene, docs/DESIGN.md section 3), so it
    defaults off.  On pool overflow the trailing rays of the batch lose
    their samples (slots assign ray-major); random batches spread that
    loss over different rays every step, which measured harmless at
    budget 12 vs demand ~32 on a compound scene.
    """

    def __init__(
        self,
        model: FieldModel,
        init_rng: jax.Array,
        lr: "float | optax.Schedule",
        bbox_min,
        bbox_max,
        candidates: int = 192,
        samples: int = 32,
        grid_resolution: int = 128,
        grid_threshold: float = 0.01,
        update_interval: int = 16,
        update_cells: int = 2**17,
        grid_refresh_samples: int = 1,
        grid_freeze_after: Optional[int] = None,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-7,
        loss_weights: Optional[Dict[str, float]] = None,
        density_penalty: Optional[float] = None,
        density_penalty_batch_size: int = 128,
        pool_budget_per_ray: Optional[float] = None,
        pool_start_step: int = 512,
        pool_t_eps: float = 0.0,
        grid_warmup_updates: int = 16,
        ema_decay: Optional[float] = None,
        mesh: Optional[Mesh] = None,
    ):
        bbox_min_t = tuple(np.asarray(bbox_min, dtype=np.float32).tolist())
        bbox_max_t = tuple(np.asarray(bbox_max, dtype=np.float32).tolist())
        self.grid = OccupancyGrid(
            bbox_min=bbox_min_t,
            bbox_max=bbox_max_t,
            resolution=grid_resolution,
            threshold=grid_threshold,
            warmup_updates=grid_warmup_updates,
        )
        self.renderer = OccupancyRenderer(
            model=model,
            grid=self.grid,
            bbox_min=bbox_min_t,
            bbox_max=bbox_max_t,
            candidates=candidates,
            samples=samples,
        )
        self.model = model
        self.loss_weights = (
            loss_weights if loss_weights is not None else default_loss_weights()
        )
        self.update_interval = update_interval
        self.update_cells = update_cells
        self.grid_refresh_samples = grid_refresh_samples
        self.grid_freeze_after = grid_freeze_after
        self.mesh = mesh if mesh is not None else default_mesh()

        self.ema_decay = ema_decay
        example = jnp.zeros((1, 3))
        variables = model.init(dict(params=init_rng), example, example)
        params = dict(
            fine=variables["params"],
            background=jnp.array([-1.0, -1.0, -1.0]),
        )
        state = TrainState.create(
            params=params,
            tx=optax.adam(lr, b1=adam_b1, b2=adam_b2, eps=adam_eps),
            ema_params=_ema_seed(params) if ema_decay is not None else None,
        )
        self.state = jax.device_put(state, replicated_sharding(self.mesh))
        self.grid_state = jax.device_put(
            self.grid.init(), replicated_sharding(self.mesh)
        )
        self._host_step = 0
        # "auto" pool-budget state (see _resolve_pool_budget); reset on
        # construction so a resumed loop re-measures the loaded grid.
        self._auto_per_ray = None
        self._auto_resolved_at = 0

        loss_fn = partial(
            compute_losses_occupancy,
            self.renderer,
            loss_weights=self.loss_weights,
            density_penalty=density_penalty,
            density_penalty_batch_size=density_penalty_batch_size,
        )
        self._loss_fn = loss_fn

        def step_body(state, key, batch, grid_state):
            return _grad_step(
                loss_fn, state, self.ema_decay,
                key=key, batch=batch, grid_state=grid_state,
            )

        @partial(jax.jit, donate_argnums=0)
        def step(state, key, batch, grid_state):
            return step_body(state, key, batch, grid_state)

        @partial(jax.jit, donate_argnums=0)
        def step_auto(state, base_key, batch, grid_state):
            # In-jit per-step key (see TrainLoop.step_auto): tag 0 = train.
            key = jax.random.fold_in(jax.random.fold_in(base_key, 0), state.step)
            return step_body(state, key, batch, grid_state)

        self._step_fn = step
        self._auto_step_fn = step_auto

        self.pool_budget_per_ray = pool_budget_per_ray
        self.pool_start_step = pool_start_step
        self.pool_t_eps = pool_t_eps

        def pooled_body(state, key, batch, grid_state, budget):
            pooled_loss = partial(
                compute_losses_occupancy_pooled,
                self.renderer,
                loss_weights=self.loss_weights,
                budget=budget,
                density_penalty=density_penalty,
                density_penalty_batch_size=density_penalty_batch_size,
                transmittance_eps=pool_t_eps,
            )
            return _grad_step(
                pooled_loss, state, self.ema_decay,
                key=key, batch=batch, grid_state=grid_state,
            )

        @partial(jax.jit, donate_argnums=0, static_argnums=4)
        def step_pooled(state, key, batch, grid_state, budget):
            return pooled_body(state, key, batch, grid_state, budget)

        @partial(jax.jit, donate_argnums=0, static_argnums=4)
        def step_pooled_auto(state, base_key, batch, grid_state, budget):
            key = jax.random.fold_in(jax.random.fold_in(base_key, 0), state.step)
            return pooled_body(state, key, batch, grid_state, budget)

        self._pooled_step_fn = step_pooled
        self._auto_pooled_step_fn = step_pooled_auto

        @partial(jax.jit, donate_argnums=(0, 1), static_argnums=(2,))
        def step_auto_scan(state, grid_state, budget, base_key, batches):
            # K training steps + their grid-refresh cadence as ONE device
            # program (lax.scan), amortizing per-dispatch host cost over K
            # steps (whether that pays on the H100 is not yet measured,
            # ROADMAP D5).  Key derivation and refresh cadence are
            # identical to the per-step path (keys fold state.step under
            # tag 0, refresh keys fold it under tag 1; refresh fires
            # BEFORE the step whenever state.step % update_interval == 0),
            # so K scanned steps produce bit-identical state to K
            # step_auto calls whenever the loop's host counter equals the
            # optimizer step (fresh runs and full-state resumes; tested).
            def body(carry, batch):
                state, grid_state = carry

                def refresh(gs):
                    key = jax.random.fold_in(
                        jax.random.fold_in(base_key, 1), state.step
                    )
                    return self.grid.update(
                        gs,
                        self.model,
                        state.params["fine"],
                        key,
                        num_cells=self.update_cells,
                        num_samples=self.grid_refresh_samples,
                    )

                do_refresh = state.step % self.update_interval == 0
                if self.grid_freeze_after is not None:
                    # Same freeze rule as _dispatch_step, evaluated on the
                    # in-scan step counter (static bound -> no recompile).
                    do_refresh = do_refresh & (
                        state.step < self.grid_freeze_after
                    )
                grid_state = jax.lax.cond(
                    do_refresh,
                    refresh,
                    lambda gs: gs,
                    grid_state,
                )
                key = jax.random.fold_in(
                    jax.random.fold_in(base_key, 0), state.step
                )
                if budget is None:
                    state, values = step_body(state, key, batch, grid_state)
                else:
                    state, values = pooled_body(
                        state, key, batch, grid_state, budget
                    )
                return (state, grid_state), values

            (state, grid_state), values = jax.lax.scan(
                body, (state, grid_state), batches
            )
            # Last step's metrics only, sliced IN-JIT: returning stacked
            # [k] metrics would cost one tiny slice dispatch per metric on
            # the host side — per-dispatch cost is the whole point here.
            return state, grid_state, jax.tree_util.tree_map(
                lambda v: v[-1], values
            )

        self._scan_step_fn = step_auto_scan

        @partial(jax.jit, donate_argnums=0, static_argnums=3)
        def update_grid(grid_state, params, key, num_cells):
            return self.grid.update(
                grid_state, self.model, params["fine"], key,
                num_cells=num_cells, num_samples=self.grid_refresh_samples,
            )

        self._update_grid_fn = update_grid

        @partial(jax.jit, donate_argnums=0, static_argnums=4)
        def update_grid_auto(grid_state, params, base_key, step, num_cells):
            # tag 1 = grid refresh (disjoint from the train-step stream).
            key = jax.random.fold_in(jax.random.fold_in(base_key, 1), step)
            return self.grid.update(
                grid_state, self.model, params["fine"], key,
                num_cells=num_cells, num_samples=self.grid_refresh_samples,
            )

        self._update_grid_auto_fn = update_grid_auto

    shard_batch = TrainLoop.shard_batch

    _AUTO_REBUDGET_INTERVAL = 256  # host steps between demand re-measures

    def _resolve_pool_budget(self, batch) -> float:
        """Per-ray pool budget.  ``"auto"`` measures the actual mean
        survivor demand of a real (sharded) ray batch — the exact
        candidate selection the pooled pass applies, including the
        ``pool_t_eps`` transmittance prune — every
        ``_AUTO_REBUDGET_INTERVAL`` steps (one host fetch each) and maps
        ``demand * 1.3`` up to the next bucket.  The budget tracks demand
        in BOTH directions: culling usually shrinks it, but a grid
        refresh that marks newly-learned geometry occupied can genuinely
        raise demand mid-training, and holding the old (smaller) budget
        would silently drop trailing rays' samples every step until the
        run ends.  Recompiles stay bounded by the bucket count; every
        bucket change is logged with the measured demand."""
        if self.pool_budget_per_ray != "auto":
            return self.pool_budget_per_ray
        if (
            self._auto_per_ray is None
            or self._host_step - self._auto_resolved_at
            >= self._AUTO_REBUDGET_INTERVAL
        ):
            if not hasattr(self, "_demand_fn"):
                from .occ_render import make_demand_fn

                self._demand_fn = make_demand_fn(
                    self.renderer, transmittance_eps=self.pool_t_eps
                )
            demand = float(
                self._demand_fn(
                    jax.random.fold_in(jax.random.PRNGKey(17), self._host_step),
                    batch[:, :2],
                    self.grid_state,
                )
            )
            from .acceleration import auto_budget_from_demand

            bucket = auto_budget_from_demand(demand, self.renderer.samples)
            if bucket != self._auto_per_ray:
                print(
                    f"auto pool budget: {bucket} samples/ray at step "
                    f"{self._host_step} (measured demand {demand:.1f}, "
                    f"was {self._auto_per_ray})",
                    flush=True,
                )
                self._auto_per_ray = bucket
            self._auto_resolved_at = self._host_step
        return self._auto_per_ray

    def _dispatch_step(self, batch, refresh_grid, dense, pooled):
        """Shared per-step driver for :meth:`step` / :meth:`step_auto`:
        grid-refresh cadence on the host-side counter (reading
        ``self.state.step`` would force a device->host sync every step),
        then the pooled-compaction switchover.  The pool budget derives
        from the *assembled global* batch, so multi-host runs pool the
        same total the single-host config implies."""
        if self._host_step % self.update_interval == 0 and (
            self.grid_freeze_after is None
            or self._host_step < self.grid_freeze_after
        ):
            self.grid_state = refresh_grid()
        self._host_step += 1
        batch = self.shard_batch(batch)
        if (
            self.pool_budget_per_ray is not None
            and self._host_step > self.pool_start_step
        ):
            budget = int(batch.shape[0] * self._resolve_pool_budget(batch))
            self.state, values = pooled(batch, budget)
        else:
            self.state, values = dense(batch)
        return values

    def step(self, key: jax.Array, batch: Array) -> Dict[str, Array]:
        step_key, grid_key = jax.random.split(key)
        return self._dispatch_step(
            batch,
            refresh_grid=lambda: self._update_grid_fn(
                self.grid_state, self.state.params, grid_key, self.update_cells
            ),
            dense=lambda b: self._step_fn(
                self.state, step_key, b, self.grid_state
            ),
            pooled=lambda b, budget: self._pooled_step_fn(
                self.state, step_key, b, self.grid_state, budget
            ),
        )

    def step_auto(self, base_key: jax.Array, batch: Array) -> Dict[str, Array]:
        """Hot-loop step with in-jit PRNG derivation (see
        :meth:`TrainLoop.step_auto`): pass the SAME ``base_key`` every call.
        Train keys fold the device step counter under tag 0; grid-refresh
        keys fold the host step counter under tag 1, so the two streams
        never collide.  Resume-consistent: both counters are checkpointed
        by :meth:`save_full`."""
        return self._dispatch_step(
            batch,
            refresh_grid=lambda: self._update_grid_auto_fn(
                self.grid_state,
                self.state.params,
                base_key,
                self._host_step,
                self.update_cells,
            ),
            dense=lambda b: self._auto_step_fn(
                self.state, base_key, b, self.grid_state
            ),
            pooled=lambda b, budget: self._auto_pooled_step_fn(
                self.state, base_key, b, self.grid_state, budget
            ),
        )

    shard_batches = TrainLoop.shard_batches

    def step_auto_many(self, base_key: jax.Array, batches) -> Dict[str, Array]:
        """K hot-loop steps (plus their grid-refresh cadence) in ONE
        device dispatch — ``lax.scan`` inside the jit.  Semantically
        identical to K :meth:`step_auto` calls when the loop's host
        counter equals the optimizer step (fresh runs / full-state
        resumes; the pickle-resume path syncs the counter too).  A macro
        that straddles ``pool_start_step`` is split at the boundary into
        a dense dispatch and a pooled one — one extra dispatch (and
        compile shape), exact per-step switchover semantics even when
        ``pool_start_step`` is not macro-aligned.  The
        auto budget holds for the whole macro step (the budget re-measure
        cadence rounds up to macro boundaries).  Returns the LAST step's
        logging dict.

        :param batches: ``[k, N, 3, 3]`` stacked ray batches.
        """
        batches = self.shard_batches(batches)
        k = batches.shape[0]
        if (
            self.pool_budget_per_ray is not None
            and self._host_step < self.pool_start_step < self._host_step + k
        ):
            split = self.pool_start_step - self._host_step
            self._step_auto_many_sharded(base_key, batches[:split])
            return self._step_auto_many_sharded(base_key, batches[split:])
        return self._step_auto_many_sharded(base_key, batches)

    def _step_auto_many_sharded(
        self, base_key: jax.Array, batches: Array
    ) -> Dict[str, Array]:
        if (
            self.pool_budget_per_ray is not None
            and self._host_step >= self.pool_start_step
        ):
            budget = int(batches.shape[1] * self._resolve_pool_budget(batches[0]))
        else:
            budget = None
        self.state, self.grid_state, values = self._scan_step_fn(
            self.state, self.grid_state, budget, base_key, batches
        )
        self._host_step += int(batches.shape[0])
        return values

    def eval_losses(self, key: jax.Array, batch: Array) -> Dict[str, Array]:
        if not hasattr(self, "_eval_fn"):
            loss_fn = self._loss_fn
            self._eval_fn = jax.jit(
                lambda params, key, batch, gs: loss_fn(
                    params, key=key, batch=batch, grid_state=gs
                )[1]
            )
        return self._eval_fn(
            self.eval_params, key, self.shard_batch(batch), self.grid_state
        )

    eval_params = TrainLoop.eval_params

    def save(self, path: str) -> None:
        """Checkpoint: params (the EMA average when enabled) plus the
        occupancy grid densities and the loop's step counter (so a pickle
        resume keeps its cadence — pooled switchover, grid-refresh phase —
        instead of re-waiting ``pool_start_step`` dense steps)."""
        from .checkpoint import save_params_pickle

        payload = dict(
            self.eval_params,
            occupancy_densities=self.grid_state.densities,
            occupancy_resolution=np.int32(self.grid.resolution),
            occupancy_host_step=np.int64(self._host_step),
        )
        save_params_pickle(path, payload)

    def load(self, path: str) -> None:
        from .checkpoint import load_params_pickle

        payload = load_params_pickle(path)
        params = dict(fine=payload["fine"], background=payload["background"])
        state = self.state.replace(
            params=params,
            # A params pickle has one tree: seed the average from it.
            ema_params=_ema_seed(params)
            if self.state.ema_params is not None
            else None,
        )
        if "occupancy_host_step" in payload:
            # Sync the optimizer step counter too: step_auto keys and the
            # scanned path's in-jit refresh cadence both fold state.step,
            # so a params-pickle resume must not restart that stream at 0
            # (it would replay early PRNG keys and desync the scan path's
            # cadence from the host counter's).  Adam moments are fresh
            # here regardless — only the full-state checkpoint keeps them.
            state = state.replace(
                step=jnp.asarray(int(payload["occupancy_host_step"]))
            )
        self.state = jax.device_put(state, replicated_sharding(self.mesh))
        if "occupancy_densities" in payload:
            # state_from_checkpoint marks the trained grid past warmup —
            # a step-0 state would re-enter the all-occupied window and
            # disable culling for 256 steps after every pickle resume.
            self.grid_state = jax.device_put(
                self.grid.state_from_checkpoint(payload),
                replicated_sharding(self.mesh),
            )
        if "occupancy_host_step" in payload:
            # Restore loop cadence: a post-switchover run resumes pooled
            # stepping immediately (the optimizer step itself is only in
            # the full-state checkpoint; the reference loses even params'
            # Adam moments here).
            self._host_step = int(payload["occupancy_host_step"])

    def save_full(self, path: str) -> None:
        """Full train state (params + Adam moments + step) AND grid state,
        so resume loses nothing (unlike the reference's params-only pickle,
        SURVEY.md section 5)."""
        from .checkpoint import save_train_state

        save_train_state(path, (self.state, self.grid_state))

    def load_full(self, path: str) -> None:
        from .checkpoint import load_train_state

        state, grid_state = load_train_state(path, (self.state, self.grid_state))
        self.state = jax.device_put(state, replicated_sharding(self.mesh))
        self.grid_state = jax.device_put(
            grid_state, replicated_sharding(self.mesh)
        )
        self._host_step = int(self.state.step)
