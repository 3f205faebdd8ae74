"""Training-step and mesh-sharding tests on a virtual 8-device CPU mesh."""

import numpy as np
import pytest


def make_batch(n, seed=0):
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3).astype(np.float32) * 2
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(n, 3).astype(np.float32) * 2 - 1
    return np.stack([origins, dirs, colors], axis=1)


def test_mesh_has_8_devices():
    import jax

    assert len(jax.devices()) == 8


def test_train_step_sharded_runs_and_learns():
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.parallel.mesh import default_mesh
    from learn_nerf_tpu.train import TrainLoop

    mesh = default_mesh()
    assert mesh.devices.shape == (8, 1)
    model = NeRFModel(hidden_dim=32, color_layer_dim=16, input_layers=2, mid_layers=2)
    loop = TrainLoop(
        model,
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=1e-2,
        coarse_ts=8,
        fine_ts=8,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        mesh=mesh,
    )
    batch = make_batch(128)
    key = jax.random.PRNGKey(1)
    first = None
    for i in range(10):
        key, sk = jax.random.split(key)
        vals = loop.step(sk, batch)
        if first is None:
            first = float(vals["fine"])
    last = float(vals["fine"])
    assert np.isfinite(last)
    assert last < first  # loss decreases on a fixed batch
    assert int(loop.state.step) == 10


def test_sharded_matches_single_device():
    """The data-sharded step must be numerically equal to a 1-device step."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.parallel.mesh import default_mesh
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)

    def run(mesh):
        loop = TrainLoop(
            model,
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            coarse_ts=4,
            fine_ts=4,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            mesh=mesh,
        )
        key = jax.random.PRNGKey(5)
        batch = make_batch(64)
        for i in range(3):
            key, sk = jax.random.split(key)
            vals = loop.step(sk, batch)
        return {k: float(v) for k, v in vals.items()}

    full = run(default_mesh())
    single = run(default_mesh(jax.devices()[:1]))
    for k in full:
        np.testing.assert_allclose(full[k], single[k], rtol=1e-4, atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)

    def new_loop():
        return TrainLoop(
            model,
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            coarse_ts=4,
            fine_ts=4,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
        )

    loop = new_loop()
    loop.step(jax.random.PRNGKey(1), make_batch(32))
    pkl = str(tmp_path / "nerf.pkl")
    full = str(tmp_path / "state.npz")
    loop.save(pkl)
    loop.save_full(full)

    # Pickle contract: the reference's {"coarse", "fine", "background"}
    # keys plus our step counter (render CLIs index by name, so the extra
    # key is inert to them).
    import pickle

    with open(pkl, "rb") as f:
        params = pickle.load(f)
    assert set(params) == {"coarse", "fine", "background", "train_host_step"}
    assert params["background"].shape == (3,)

    other = new_loop()
    other.load(pkl)
    a = jax.tree_util.tree_leaves(loop.state.params)
    b = jax.tree_util.tree_leaves(other.state.params)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))
    # Pickle resume continues the step_auto PRNG stream instead of
    # replaying keys from step 0.
    assert int(other.state.step) == 1
    assert set(other.state.params) == {"coarse", "fine", "background"}

    # A reference-style pickle (no step key) still loads, step untouched.
    with open(pkl, "wb") as f:
        pickle.dump(
            {k: params[k] for k in ("coarse", "fine", "background")}, f
        )
    ref_loaded = new_loop()
    ref_loaded.load(pkl)
    assert int(ref_loaded.state.step) == 0

    # Full restore keeps the optimizer step counter.
    third = new_loop()
    third.load_full(full)
    assert int(third.state.step) == 1


def test_render_frame_tiled_equals_direct():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.render import Renderer, render_frame

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    renderer = Renderer(
        coarse=model,
        fine=model,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        coarse_ts=4,
        fine_ts=4,
    )
    rays = make_batch(100)[:, :2]
    bg = jnp.zeros(3)
    out = render_frame(
        renderer, jax.random.PRNGKey(3), jnp.asarray(rays), params, params, bg,
        tile_size=32, include_depth_outputs=True,
    )
    assert out["outputs"].shape == (100, 3)
    assert out["alphas"].shape == (100, 1)
    assert out["coords"].shape == (100, 3)
    assert np.all(np.isfinite(np.asarray(out["outputs"])))


def test_orbax_checkpoint_roundtrip(tmp_path):
    import jax

    from learn_nerf_tpu.checkpoint_orbax import load_orbax, save_orbax
    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)

    def new_loop():
        return TrainLoop(
            model, model, init_rng=jax.random.PRNGKey(0), lr=1e-2,
            coarse_ts=4, fine_ts=4, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        )

    loop = new_loop()
    loop.step(jax.random.PRNGKey(1), make_batch(32))
    path = str(tmp_path / "orbax_ckpt")
    save_orbax(path, loop.state.params)

    other = new_loop()
    restored = load_orbax(path, other.state.params)
    a = jax.tree_util.tree_leaves(loop.state.params)
    b = jax.tree_util.tree_leaves(restored)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def test_occupancy_density_penalty_logged():
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    loop = OccupancyTrainLoop(
        model, init_rng=jax.random.PRNGKey(0), lr=1e-3,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=4, grid_resolution=8,
        density_penalty=0.1, density_penalty_batch_size=32,
    )
    vals = loop.step(jax.random.PRNGKey(1), make_batch(32))
    assert "fine_density" in vals
    assert np.isfinite(float(vals["fine_density"]))


def test_refnerf_train_step_and_aux_losses():
    import jax

    from learn_nerf_tpu.models import RefNeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = RefNeRFModel(
        sh_degree=2, hidden_dim=32, color_layer_dim=16, input_layers=1, mid_layers=1
    )
    loop = TrainLoop(
        model, model, init_rng=jax.random.PRNGKey(0), lr=1e-3,
        coarse_ts=4, fine_ts=4, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
    )
    vals = loop.step(jax.random.PRNGKey(1), make_batch(32))
    for key in ("coarse_normal_mse", "fine_normal_mse", "coarse_neg_normal",
                "fine_neg_normal"):
        assert key in vals and np.isfinite(float(vals[key]))


def test_create_model_wiring():
    import argparse

    from learn_nerf_tpu.data.dataset import ModelMetadata
    from learn_nerf_tpu.models import (
        InstantNGPModel,
        InstantNGPRefNeRFModel,
        NeRFModel,
        RefNeRFModel,
    )
    from learn_nerf_tpu.scripts.common import create_model

    meta = ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1))

    def args(**kw):
        ns = argparse.Namespace(instant_ngp=False, ref_nerf=False, bf16=False)
        ns.__dict__.update(kw)
        return ns

    assert isinstance(create_model(args(), meta)[0], NeRFModel)
    assert isinstance(create_model(args(ref_nerf=True), meta)[0], RefNeRFModel)
    coarse, fine, kwargs = create_model(args(instant_ngp=True), meta)
    assert isinstance(coarse, InstantNGPModel)
    assert len(coarse.table_sizes) == 6 and len(fine.table_sizes) == 16
    assert kwargs == dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
    hybrid = create_model(args(instant_ngp=True, ref_nerf=True), meta)[0]
    assert isinstance(hybrid, InstantNGPRefNeRFModel)
    assert hybrid.sh_degree == 4
    bf = create_model(args(bf16=True), meta)[0]
    assert bf.compute_dtype == "bfloat16"


def test_render_frame_sharded_matches_single_device():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.parallel.mesh import default_mesh
    from learn_nerf_tpu.render import Renderer, render_frame, render_frame_sharded

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    renderer = Renderer(
        coarse=model, fine=model, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        coarse_ts=4, fine_ts=4,
    )
    rays = jnp.asarray(make_batch(200)[:, :2])
    bg = jnp.zeros(3)
    mesh = default_mesh()

    sharded = render_frame_sharded(
        renderer, jax.random.PRNGKey(3), rays, params, params, bg, mesh,
        tile_size=16,
    )
    assert sharded.shape == (200, 3)
    assert np.all(np.isfinite(np.asarray(sharded)))

    # Per-ray results must match the per-tile semantics of the unsharded
    # path when the tiling (and so the RNG key per tile) lines up.
    single = render_frame(
        renderer, jax.random.PRNGKey(3), rays, params, params, bg, tile_size=16
    )["outputs"]
    # Same tile decomposition and same per-tile keys => identical output.
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), rtol=1e-4, atol=1e-5
    )


def test_lr_schedule_drives_optimizer():
    """Both loops accept an optax schedule in place of a float lr (the
    --lr_schedule cosine CLI path).  The schedule is indexed by the
    optimizer step count, so a decay to 0 after one step must freeze the
    params exactly — pinning that the schedule, not a snapshotted float,
    drives each update."""
    import jax
    import optax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=2, mid_layers=1)
    # Step 0 at lr 1e-2; every later step at exactly 0.
    schedule = optax.join_schedules(
        [optax.constant_schedule(1e-2), optax.constant_schedule(0.0)],
        boundaries=[1],
    )
    loop = TrainLoop(
        model,
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=schedule,
        coarse_ts=4,
        fine_ts=4,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
    )
    batch = make_batch(64)
    key = jax.random.PRNGKey(1)
    def snapshot():
        # The step donates the state, so copy off-device before stepping.
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(loop.state.params)]

    p0 = snapshot()
    loop.step(jax.random.fold_in(key, 0), batch)
    p1 = snapshot()
    # First step moved the params...
    assert any(not np.allclose(a, b) for a, b in zip(p0, p1))
    loop.step(jax.random.fold_in(key, 1), batch)
    p2 = snapshot()
    # ...the zero-lr step moved nothing.
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)


def test_ema_eval_params_recurrence_and_checkpoint(tmp_path):
    """--ema semantics: the step maintains ema <- d*ema + (1-d)*params
    in-jit (pinned against a manual recurrence), eval_params/save expose
    the average, and the full-state checkpoint round-trips it."""
    import pickle

    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=2, mid_layers=1)

    def new_loop(ema):
        return TrainLoop(
            model,
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            coarse_ts=4,
            fine_ts=4,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            ema_decay=ema,
        )

    loop = new_loop(0.5)
    batch = make_batch(64)
    key = jax.random.PRNGKey(1)

    def leaves(tree):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    manual = leaves(loop.state.params)  # ema seeds from init params
    for i in range(3):
        loop.step(jax.random.fold_in(key, i), batch)
        params = leaves(loop.state.params)
        manual = [0.5 * e + 0.5 * p for e, p in zip(manual, params)]
    for e, a in zip(manual, leaves(loop.eval_params)):
        np.testing.assert_allclose(e, a, rtol=1e-6, atol=1e-7)
    # The average lags the raw params (they differ after a moving step).
    assert any(
        not np.allclose(a, b)
        for a, b in zip(leaves(loop.state.params), leaves(loop.eval_params))
    )

    # save() writes the average; a fresh EMA loop resumes from it.
    pkl = str(tmp_path / "ema.pkl")
    loop.save(pkl)
    with open(pkl, "rb") as f:
        payload = pickle.load(f)
    np.testing.assert_allclose(
        np.asarray(payload["background"]),
        np.asarray(jax.tree_util.tree_leaves(loop.eval_params)[0]),
    )
    resumed = new_loop(0.5)
    resumed.load(pkl)
    assert resumed.state.ema_params is not None

    # Full-state checkpoint round-trips the subclassed field.
    full = str(tmp_path / "ema.npz")
    loop.save_full(full)
    other = new_loop(0.5)
    other.load_full(full)
    for a, b in zip(leaves(loop.eval_params), leaves(other.eval_params)):
        np.testing.assert_array_equal(a, b)

    # Disabled (default): no EMA tree, eval_params is the raw params.
    off = new_loop(None)
    assert off.state.ema_params is None
    assert off.eval_params is off.state.params


def test_full_state_ema_field_migration(tmp_path):
    """Full-state checkpoints survive the ema_params field in BOTH
    directions: blobs saved without an average load into current templates (with or
    without --ema: the average seeds from the checkpointed params), and
    EMA checkpoints resumed into an EMA-off loop DROP the stale average
    (eval must follow the raw params again)."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)

    def mk(ema):
        return TrainLoop(
            model, model, init_rng=jax.random.PRNGKey(0), lr=1e-2,
            coarse_ts=4, fine_ts=4, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
            ema_decay=ema,
        )

    batch = make_batch(32)
    src = mk(None)
    src.step(jax.random.PRNGKey(1), batch)

    # A blob without an average: an EMA-off state saves no ema leaves.
    old_path = str(tmp_path / "old.npz")
    src.save_full(old_path)

    plain = mk(None)
    plain.load_full(old_path)
    assert plain.state.ema_params is None
    plain.step(jax.random.PRNGKey(2), batch)

    seeded = mk(0.5)
    seeded.load_full(old_path)
    for p, e in zip(
        jax.tree_util.tree_leaves(seeded.state.params),
        jax.tree_util.tree_leaves(seeded.state.ema_params),
    ):
        np.testing.assert_allclose(np.asarray(p), np.asarray(e))
    seeded.step(jax.random.PRNGKey(2), batch)

    # An EMA checkpoint resumed without --ema: the average is dropped and
    # eval_params tracks the live params, not a frozen tree.
    on = mk(0.5)
    on.step(jax.random.PRNGKey(1), batch)
    on_path = str(tmp_path / "on.npz")
    on.save_full(on_path)
    off = mk(None)
    off.load_full(on_path)
    assert off.state.ema_params is None
    off.step(jax.random.PRNGKey(2), batch)
    assert off.eval_params is off.state.params


def test_hierarchy_step_auto_many_matches_per_step():
    """K scanned steps in one dispatch (TrainLoop.step_auto_many) produce
    the same params and metrics as K step_auto dispatches — the vanilla
    (non-occupancy) counterpart of the occupancy scan test, so
    --steps_per_dispatch is dispatch amortization only, never a numerics
    change."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)

    def make_loop():
        return TrainLoop(
            model,
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            coarse_ts=4,
            fine_ts=4,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            ema_decay=0.9,  # the EMA tree must thread through the scan too
        )

    steps = 6
    batches = np.stack([make_batch(32, seed=s) for s in range(steps)])
    base_key = jax.random.PRNGKey(5)

    a = make_loop()
    last = None
    for s in range(steps):
        last = a.step_auto(base_key, batches[s])

    b = make_loop()
    vals = None
    for chunk in (batches[:3], batches[3:]):
        vals = b.step_auto_many(base_key, chunk)

    assert int(a.state.step) == int(b.state.step) == steps
    for tree_a, tree_b in (
        (a.state.params, b.state.params),
        (a.state.ema_params, b.state.ema_params),
    ):
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-7
            ),
            jax.device_get(tree_a),
            jax.device_get(tree_b),
        )
    for k in last:
        np.testing.assert_allclose(
            float(last[k]), float(vals[k]), rtol=1e-5, atol=1e-7
        )
