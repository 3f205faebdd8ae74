"""Occupancy-grid fast path tests: compaction, grid updates, renderer,
training loop, and end-to-end learning via the CLI flags."""

import os

import numpy as np
import pytest


def test_grid_update_marks_dense_cells():
    from learn_nerf_tpu import nn
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid

    class Blob(nn.Module):
        """Density 5 inside a sphere of radius 0.25 at origin, else 0."""

        @nn.compact
        def __call__(self, x, d):
            r = jnp.linalg.norm(x, axis=-1, keepdims=True)
            density = jnp.where(r < 0.25, 5.0, 0.0)
            return density, jnp.zeros_like(x), {}

    model = Blob()
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    ).get("params", {})

    # warmup_updates=0: this test is about the cull dynamics themselves;
    # warmup semantics get their own test below.
    grid = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=16, decay=0.3,
        warmup_updates=0,
    )
    state = grid.init()
    key = jax.random.PRNGKey(1)
    for _ in range(12):  # full updates: all cells re-evaluated each time
        key, sk = jax.random.split(key)
        state = grid.update(state, model, params, sk)

    # Center cell occupied, corner cell not.
    center = jnp.asarray([[0.0, 0.0, 0.0]])
    corner = jnp.asarray([[0.9, 0.9, 0.9]])
    assert bool(grid.occupied(state, center)[0])
    assert not bool(grid.occupied(state, corner)[0])

    # Partial updates also converge: the decay must outlive the expected
    # refresh interval (1024/4096 cells per update -> ~4 updates between
    # refreshes; decay 0.8 keeps a dense cell alive ~21 updates).
    grid2 = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=16, decay=0.8,
        warmup_updates=0,
    )
    state2 = grid2.init()
    for _ in range(40):
        key, sk = jax.random.split(key)
        state2 = grid2.update(state2, model, params, sk, num_cells=1024)
    assert bool(grid2.occupied(state2, center)[0])
    assert not bool(grid2.occupied(state2, corner)[0])


def test_grid_warmup_all_occupied_and_no_decay():
    """During the first ``warmup_updates`` grid updates everything tests
    occupied and decay is suppressed, so a young model cannot cull true
    surfaces it has not learned yet; after warmup, empty cells cull on the
    usual ~log(threshold/init)/log(decay) schedule."""
    from learn_nerf_tpu import nn
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid

    class Empty(nn.Module):
        @nn.compact
        def __call__(self, x, d):
            return jnp.zeros(x.shape[:-1] + (1,)), jnp.zeros_like(x), {}

    model = Empty()
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    ).get("params", {})

    grid = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8, decay=0.5,
        warmup_updates=4,
    )
    state = grid.init()
    pt = jnp.asarray([[0.1, 0.2, 0.3]])
    key = jax.random.PRNGKey(1)
    for i in range(4):
        # In warmup: occupied regardless of density, and no decay erosion.
        assert bool(grid.occupied(state, pt)[0]), f"update {i}"
        key, sk = jax.random.split(key)
        state = grid.update(state, model, params, sk)
        np.testing.assert_allclose(
            np.asarray(state.densities), 2.0 * grid.threshold
        )
    # Post-warmup: an all-empty model culls quickly (decay 0.5: one update
    # takes 2x threshold below threshold).
    assert bool(grid.occupied(state, pt)[0])  # still at init level
    key, sk = jax.random.split(key)
    state = grid.update(state, model, params, sk)
    assert not bool(grid.occupied(state, pt)[0])


def test_occupancy_renderer_finite_and_masked():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    renderer = OccupancyRenderer(
        model=model,
        grid=grid,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=32,
        samples=8,
    )
    rng = np.random.RandomState(0)
    origins = rng.randn(64, 3).astype(np.float32) * 3
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = jnp.asarray(np.stack([origins, dirs], axis=1))

    out, aux = renderer.render_rays(
        jax.random.PRNGKey(1), rays, params, jnp.asarray([0.5, 0.5, 0.5]),
        grid.init(),
    )
    assert out["outputs"].shape == (64, 3)
    assert np.all(np.isfinite(np.asarray(out["outputs"])))
    # Rays that miss the bbox return the background exactly.
    from learn_nerf_tpu.ops.geometry import ray_bbox_range

    _, _, mask = ray_bbox_range(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.full(3, -1.0), jnp.ones(3)
    )
    missed = ~np.asarray(mask)
    if missed.any():
        np.testing.assert_allclose(
            np.asarray(out["outputs"])[missed], 0.5, atol=1e-6
        )

    # With an empty grid (all cells dead, past warmup), everything
    # composites to bg.
    dead = grid.init().replace(
        densities=jnp.zeros_like(grid.init().densities),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )
    out2, _ = renderer.render_rays(
        jax.random.PRNGKey(1), rays, params, jnp.asarray([0.5, 0.5, 0.5]), dead
    )
    np.testing.assert_allclose(np.asarray(out2["outputs"]), 0.5, atol=1e-5)


def test_occupancy_train_loop_learns(tmp_path):
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    model = NeRFModel(hidden_dim=32, color_layer_dim=16, input_layers=2, mid_layers=2)
    loop = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=1e-2,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=32,
        samples=8,
        grid_resolution=16,
        update_interval=4,
        update_cells=512,
    )
    rng = np.random.RandomState(0)
    origins = rng.randn(128, 3).astype(np.float32) * 2
    dirs = rng.randn(128, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(128, 3).astype(np.float32) * 2 - 1
    batch = np.stack([origins, dirs, colors], axis=1)

    key = jax.random.PRNGKey(1)
    first = None
    for _ in range(8):
        key, sk = jax.random.split(key)
        vals = loop.step(sk, batch)
        if first is None:
            first = float(vals["fine"])
    assert float(vals["fine"]) < first
    assert int(loop.grid_state.step) >= 2  # grid updates actually ran

    # Checkpoint roundtrip incl. grid densities.
    path = str(tmp_path / "occ.pkl")
    loop.save(path)
    import pickle

    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert {"fine", "background", "occupancy_densities"} <= set(payload)

    loop2 = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(42),
        lr=1e-2,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=32,
        samples=8,
        grid_resolution=16,
    )
    loop2.load(path)
    np.testing.assert_allclose(
        np.asarray(loop2.grid_state.densities),
        np.asarray(loop.grid_state.densities),
    )


def test_occupancy_cli_end_to_end(tmp_path):
    from learn_nerf_tpu.scripts import render_nerf, train_nerf

    from .synthetic_scene import write_dataset

    scene = write_dataset(str(tmp_path / "scene"), num_views=6, resolution=16)
    save_path = str(tmp_path / "occ.pkl")
    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--batch_size", "256",
            "--steps", "6",
            "--occupancy",
            "--occ_candidates", "32",
            "--occ_samples", "8",
            "--occ_grid", "16",
            "--save_path", save_path,
            scene,
        ]
    )
    out_png = str(tmp_path / "out.png")
    render_nerf.main(
        [
            "--seed", "0",
            "--batch_size", "128",
            "--occupancy",
            "--occ_candidates", "32",
            "--occ_samples", "8",
            "--width", "16",
            "--height", "16",
            "--model_path", save_path,
            scene + "/metadata.json",
            scene + "/0000.json",
            out_png,
        ]
    )
    from PIL import Image

    img = np.asarray(Image.open(out_png))
    assert img.shape == (16, 16, 3)

    # The auto pooled budget resolves from measured demand and renders a
    # frame that matches the fixed-K path closely (lossless sizing).
    auto_png = str(tmp_path / "out_auto.png")
    render_nerf.main(
        [
            "--seed", "0",
            "--batch_size", "128",
            "--occupancy",
            "--occ_candidates", "32",
            "--occ_samples", "8",
            "--occ_budget_per_ray", "auto",
            "--width", "16",
            "--height", "16",
            "--model_path", save_path,
            scene + "/metadata.json",
            scene + "/0000.json",
            auto_png,
        ]
    )
    # The pooled tiling draws different per-tile stratification keys, so
    # pixels differ by sampling jitter only — close on average.
    auto_img = np.asarray(Image.open(auto_png)).astype(np.int32)
    assert auto_img.shape == (16, 16, 3)
    assert np.abs(auto_img - img.astype(np.int32)).mean() <= 3.0


def test_render_new_dataset_occupancy(tmp_path):
    from learn_nerf_tpu.scripts import render_new_dataset, train_nerf

    from .synthetic_scene import write_dataset

    scene = write_dataset(str(tmp_path / "scene"), num_views=4, resolution=12)
    save_path = str(tmp_path / "occ.pkl")
    train_nerf.main(
        [
            "--seed", "0", "--batch_size", "128", "--steps", "3",
            "--occupancy", "--occ_candidates", "16", "--occ_samples", "4",
            "--occ_grid", "8", "--save_path", save_path, scene,
        ]
    )
    out_dir = str(tmp_path / "distilled")
    render_new_dataset.main(
        [
            "--seed", "0", "--num_images", "2", "--size", "8",
            "--batch_size", "64", "--occupancy", "--occ_candidates", "16",
            "--occ_samples", "4", "--model_path", save_path,
            os.path.join(scene, "metadata.json"), out_dir,
        ]
    )
    names = sorted(os.listdir(out_dir))
    assert names == [
        "00000.json", "00000.png", "00000_depth.png",
        "00001.json", "00001.png", "00001_depth.png", "metadata.json",
    ]


def _small_model_and_params(seed=0):
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    params = model.init(
        dict(params=jax.random.PRNGKey(seed)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    return model, params


def _random_rays(n, seed=0, spread=3.0):
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3).astype(np.float32) * spread
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.stack([origins, dirs], axis=1)


def test_pooled_render_matches_fixed_k():
    """With ample budget, no termination eps, and K = C (per-ray cap never
    binds), the pooled path must reproduce render_rays exactly."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    # Random sparse occupancy so compaction is non-trivial.
    rng = np.random.RandomState(3)
    densities = jnp.asarray(
        (rng.rand(8**3) < 0.4).astype(np.float32)
    )  # 1.0 > threshold in ~40% of cells
    grid_state = grid.init().replace(
        densities=densities,
        step=jnp.asarray(grid.warmup_updates, jnp.int32),  # past warmup
    )

    c = 24
    renderer = OccupancyRenderer(
        model=model,
        grid=grid,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=c,
        samples=c,  # K = C
    )
    rays = jnp.asarray(_random_rays(48, seed=5))
    background = jnp.asarray([0.3, -0.2, 0.8])
    key = jax.random.PRNGKey(7)

    ref_out, _ = renderer.render_rays(key, rays, params, background, grid_state)
    pooled = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=48 * c, transmittance_eps=0.0,
    )
    np.testing.assert_allclose(
        np.asarray(pooled["outputs"]), np.asarray(ref_out["outputs"]),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(pooled["alphas"]), np.asarray(ref_out["alphas"]),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(pooled["coords"]), np.asarray(ref_out["coords"]),
        rtol=1e-4, atol=1e-5,
    )


def test_pooled_render_early_termination_and_budget():
    """Early termination barely changes an opaque scene; a tight budget
    degrades gracefully (finite outputs, misses still equal background)."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params(seed=2)
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()  # fully occupied

    renderer = OccupancyRenderer(
        model=model,
        grid=grid,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=32,
        samples=32,
    )
    rays = jnp.asarray(_random_rays(32, seed=11))
    background = jnp.asarray([0.5, 0.5, 0.5])
    key = jax.random.PRNGKey(3)

    full = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=32 * 32, transmittance_eps=0.0,
    )
    pruned = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=32 * 32, transmittance_eps=1e-4,
    )
    # init grid densities are 1.0 -> sigma*dt small; eps=1e-4 prunes almost
    # nothing here, so results stay close.
    np.testing.assert_allclose(
        np.asarray(pruned["outputs"]), np.asarray(full["outputs"]), atol=1e-3
    )

    tight = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=64, transmittance_eps=0.0,
    )
    assert np.all(np.isfinite(np.asarray(tight["outputs"])))

    from learn_nerf_tpu.ops.geometry import ray_bbox_range

    _, _, mask = ray_bbox_range(
        rays[:, 0], rays[:, 1], jnp.full(3, -1.0), jnp.ones(3)
    )
    missed = ~np.asarray(mask)
    if missed.any():
        np.testing.assert_allclose(
            np.asarray(full["outputs"])[missed], 0.5, atol=1e-6
        )


def test_render_frame_occupancy_pooled_and_sharded():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer, render_frame_occupancy
    from learn_nerf_tpu.parallel.mesh import default_mesh

    model, params = _small_model_and_params(seed=4)
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()
    renderer = OccupancyRenderer(
        model=model,
        grid=grid,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=16,
        samples=8,
    )
    rays = jnp.asarray(_random_rays(100, seed=13))  # not a tile multiple
    background = jnp.asarray([0.0, 0.0, 0.0])
    key = jax.random.PRNGKey(5)

    out = render_frame_occupancy(
        renderer, key, rays, params, background, grid_state,
        tile_size=32, budget_per_ray=8.0, include_depth_outputs=True,
    )
    assert out["outputs"].shape == (100, 3)
    assert out["alphas"].shape == (100, 1)
    assert out["coords"].shape == (100, 3)
    assert np.all(np.isfinite(np.asarray(out["outputs"])))

    mesh = default_mesh()
    sharded = render_frame_occupancy(
        renderer, key, rays, params, background, grid_state,
        tile_size=16, budget_per_ray=8.0, mesh=mesh,
    )
    assert sharded["outputs"].shape == (100, 3)
    assert np.all(np.isfinite(np.asarray(sharded["outputs"])))


def test_compact_occupied_strided_matches_numpy():
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import compact_occupied_strided

    rng = np.random.RandomState(1)
    n, c, k = 17, 40, 8
    ts = np.sort(rng.rand(n, c).astype(np.float32), axis=1)
    occ = rng.rand(n, c) < 0.35
    occ[0] = False        # empty ray
    occ[1] = True         # fully occupied ray (c >> k)
    occ[2, :5] = True     # exactly under k
    occ[2, 5:] = False

    sel_ts, sel_mask, scale = map(
        np.asarray,
        compact_occupied_strided(jnp.asarray(ts), jnp.asarray(occ), k),
    )
    for i in range(n):
        occupied_ts = ts[i, occ[i]]
        cnt = len(occupied_ts)
        np.testing.assert_allclose(scale[i, 0], max(cnt / k, 1.0), rtol=1e-6)
        if cnt <= k:
            # first-K semantics: all occupied candidates kept, in order
            np.testing.assert_allclose(sel_ts[i][sel_mask[i]], occupied_ts)
            assert sel_mask[i].sum() == cnt
        else:
            # strided: k samples at ranks floor(j*cnt/k), covering the span
            ranks = (np.arange(k) * cnt) // k
            np.testing.assert_allclose(sel_ts[i][sel_mask[i]], occupied_ts[ranks])
            assert sel_mask[i].all()
            # coverage: last kept sample is in the final stride of the span
            assert sel_ts[i][-1] >= occupied_ts[-(cnt // k + 1)]


def test_pooled_training_step_switch():
    """The loop switches to the pooled step after pool_start_step and keeps
    learning; the pooled loss matches the dense loss on identical state."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    model = NeRFModel(hidden_dim=32, color_layer_dim=16, input_layers=2, mid_layers=2)
    loop = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=1e-2,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=32,
        samples=8,
        grid_resolution=16,
        update_interval=4,
        update_cells=512,
        pool_budget_per_ray=8.0,  # = K, ample: no drops vs dense
        pool_start_step=3,
    )
    rng = np.random.RandomState(0)
    origins = rng.randn(128, 3).astype(np.float32) * 2
    dirs = rng.randn(128, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(128, 3).astype(np.float32) * 2 - 1
    batch = np.stack([origins, dirs, colors], axis=1)

    key = jax.random.PRNGKey(1)
    losses = []
    for i in range(8):
        key, sk = jax.random.split(key)
        vals = loop.step(sk, batch)
        losses.append(float(vals["fine"]))
        if i >= 3:  # pooled steps surface the no-silent-caps counter
            assert int(vals["fine_pool_dropped"]) == 0  # ample budget
        else:
            assert "fine_pool_dropped" not in vals
    assert loop._host_step == 8
    # still learning after the switch (loss finite and decreased overall)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_refnerf_occupancy_training_with_pool():
    """Ref-NeRF under the occupancy loop: aux losses flow through both the
    dense and pooled steps and stay finite."""
    import jax

    from learn_nerf_tpu.models import RefNeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    model = RefNeRFModel(
        sh_degree=2, input_layers=1, mid_layers=1, hidden_dim=16, color_layer_dim=8
    )
    loop = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=1e-3,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=16,
        samples=4,
        grid_resolution=8,
        update_interval=8,
        update_cells=128,
        pool_budget_per_ray=4.0,
        pool_start_step=1,
    )
    rng = np.random.RandomState(2)
    origins = rng.randn(32, 3).astype(np.float32) * 2
    dirs = rng.randn(32, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.rand(32, 3).astype(np.float32) * 2 - 1
    batch = np.stack([origins, dirs, colors], axis=1)

    key = jax.random.PRNGKey(3)
    for _ in range(3):  # step 1 dense, steps 2-3 pooled
        key, sk = jax.random.split(key)
        vals = loop.step(sk, batch)
    assert "fine_normal_mse" in vals and "fine_neg_normal" in vals
    for v in vals.values():
        assert np.isfinite(float(v))


def test_occupancy_full_state_resume(tmp_path):
    """save_full/load_full restores optimizer moments, step counter, and
    the grid state bit-for-bit; resumed steps match an uninterrupted run."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    def make_loop():
        return OccupancyTrainLoop(
            NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            candidates=16,
            samples=4,
            grid_resolution=8,
            update_interval=4,
            update_cells=64,
        )

    rng = np.random.RandomState(0)
    batch = np.stack(
        [
            rng.randn(64, 3).astype(np.float32) * 2,
            rng.randn(64, 3).astype(np.float32),
            rng.rand(64, 3).astype(np.float32) * 2 - 1,
        ],
        axis=1,
    )
    batch[:, 1] /= np.linalg.norm(batch[:, 1], axis=-1, keepdims=True)

    keys = [jax.random.PRNGKey(i) for i in range(6)]
    a = make_loop()
    for k in keys[:3]:
        a.step(k, batch)
    path = str(tmp_path / "full.npz")
    a.save_full(path)
    for k in keys[3:]:
        ref_vals = a.step(k, batch)

    b = make_loop()
    b.load_full(path)
    assert b._host_step == 3
    for k in keys[3:]:
        got_vals = b.step(k, batch)
    for key_ in ref_vals:
        np.testing.assert_allclose(
            float(got_vals[key_]), float(ref_vals[key_]), rtol=1e-5
        )


def test_occupancy_step_auto_resume_and_determinism(tmp_path):
    """step_auto derives per-step keys in-program from the checkpointed
    counters: two loops fed the same base key and batches match exactly,
    and a full-state resume continues the identical key sequence."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    def make_loop():
        return OccupancyTrainLoop(
            NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
            init_rng=jax.random.PRNGKey(0),
            lr=1e-2,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            candidates=16,
            samples=4,
            grid_resolution=8,
            update_interval=2,
            update_cells=64,
        )

    rng = np.random.RandomState(3)
    batches = []
    for _ in range(4):
        b = np.stack(
            [
                rng.randn(64, 3).astype(np.float32) * 2,
                rng.randn(64, 3).astype(np.float32),
                rng.rand(64, 3).astype(np.float32) * 2 - 1,
            ],
            axis=1,
        )
        b[:, 1] /= np.linalg.norm(b[:, 1], axis=-1, keepdims=True)
        batches.append(b)

    base = jax.random.PRNGKey(42)

    a = make_loop()
    for b in batches:
        a_vals = a.step_auto(base, b)
    assert int(a.state.step) == 4
    for v in a_vals.values():
        assert np.isfinite(float(v))

    # Interrupted twin: 2 steps, full-state checkpoint, resume, 2 more.
    c = make_loop()
    for b in batches[:2]:
        c.step_auto(base, b)
    path = str(tmp_path / "full.npz")
    c.save_full(path)
    d = make_loop()
    d.load_full(path)
    assert d._host_step == 2
    for b in batches[2:]:
        d_vals = d.step_auto(base, b)
    for key_ in a_vals:
        np.testing.assert_allclose(
            float(d_vals[key_]), float(a_vals[key_]), rtol=1e-6
        )
    for pa, pd in zip(
        jax.tree_util.tree_leaves(a.state.params),
        jax.tree_util.tree_leaves(d.state.params),
    ):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pd))


def test_occupancy_step_auto_pooled_switch():
    """step_auto honors the pooled-compaction switchover like step."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    loop = OccupancyTrainLoop(
        NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-2,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=16,
        samples=4,
        grid_resolution=8,
        update_interval=2,
        update_cells=64,
        pool_budget_per_ray=4.0,
        pool_start_step=1,
    )
    rng = np.random.RandomState(5)
    batch = np.stack(
        [
            rng.randn(32, 3).astype(np.float32) * 2,
            rng.randn(32, 3).astype(np.float32),
            rng.rand(32, 3).astype(np.float32) * 2 - 1,
        ],
        axis=1,
    )
    batch[:, 1] /= np.linalg.norm(batch[:, 1], axis=-1, keepdims=True)
    base = jax.random.PRNGKey(9)
    vals = {}
    for _ in range(2):  # step 1 dense, step 2 pooled
        vals = loop.step_auto(base, batch)
    for v in vals.values():
        assert np.isfinite(float(v))


def test_pooled_training_auto_budget():
    """pool_budget_per_ray="auto" resolves once at switchover from the
    grid's occupied fraction: min(frac * C, K) * 1.3, floor 1.0."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    loop = OccupancyTrainLoop(
        NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-2,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=16,
        samples=4,
        grid_resolution=8,
        update_interval=4,
        update_cells=64,
        pool_budget_per_ray="auto",
        pool_start_step=1,
    )
    # Force a 25%-occupied, past-warmup grid so the switchover measures it.
    n_cells = 8**3
    densities = jnp.zeros(n_cells).at[: n_cells // 4].set(1.0)
    loop.grid_state = loop.grid_state.replace(
        densities=densities,
        step=jnp.asarray(loop.grid.warmup_updates, jnp.int32),
    )
    # Advance the host counter so no grid refresh overwrites the forced
    # pattern before the switchover measures it (refreshes run when
    # host_step % update_interval == 0).
    loop._host_step = 1

    rng = np.random.RandomState(7)
    batch = np.stack(
        [
            rng.randn(32, 3).astype(np.float32) * 2,
            rng.randn(32, 3).astype(np.float32),
            rng.rand(32, 3).astype(np.float32) * 2 - 1,
        ],
        axis=1,
    )
    batch[:, 1] /= np.linalg.norm(batch[:, 1], axis=-1, keepdims=True)
    base = jax.random.PRNGKey(1)

    assert loop.pool_budget_per_ray == "auto"
    vals = loop.step_auto(base, batch)  # host_step -> 2 > start: pooled
    # The budget resolves from the batch's measured survivor demand,
    # bucketed, capped at K=4; the config value stays symbolic.
    assert loop.pool_budget_per_ray == "auto"
    assert loop._auto_per_ray in (1, 2, 3, 4)

    # The demand estimator matches the pooled pass's selection: with the
    # whole grid dead (past warmup), demand is zero.
    import jax.numpy as jnp2

    dead = loop.grid_state.replace(
        densities=jnp.zeros_like(loop.grid_state.densities)
    )
    demand = float(
        loop.renderer.mean_sample_demand(
            jax.random.PRNGKey(0), jnp.asarray(batch[:, :2]), dead
        )
    )
    assert demand == 0.0
    # A transmittance prune can only reduce demand.
    full = loop.grid_state.replace(
        densities=jnp.ones_like(loop.grid_state.densities) * 100.0
    )
    d_none = float(
        loop.renderer.mean_sample_demand(
            jax.random.PRNGKey(0), jnp.asarray(batch[:, :2]), full
        )
    )
    d_eps = float(
        loop.renderer.mean_sample_demand(
            jax.random.PRNGKey(0), jnp.asarray(batch[:, :2]), full,
            transmittance_eps=1e-2,
        )
    )
    assert d_eps <= d_none
    for v in vals.values():
        assert np.isfinite(float(v))


def test_budget_buckets_cap_and_escalation():
    """quantize_budget treats the cap as the final bucket (no silent
    sub-demand sizing above the largest tabulated bucket), and
    next_budget_bucket steps upward for overflow escalation."""
    from learn_nerf_tpu.acceleration import next_budget_bucket, quantize_budget

    assert quantize_budget(5.2, 32) == 6
    assert quantize_budget(64.0, 64) == 64
    # Demand above the largest tabulated bucket: the ladder extends
    # geometrically (96, 128, 192, 256, ...) so sizing never drops below
    # demand while the cap allows it, yet distinct
    # compiled budgets stay bounded even for large caps.
    assert quantize_budget(70.0, 128) == 96
    assert quantize_budget(100.0, 256) == 128
    assert quantize_budget(130.0, 256) == 192
    assert quantize_budget(200.0, 256) == 256
    assert quantize_budget(70.0, 64) == 64
    assert next_budget_bucket(8, 32) == 12
    assert next_budget_bucket(32, 32) == 32
    assert next_budget_bucket(64, 128) == 96
    assert next_budget_bucket(96, 256) == 128
    assert next_budget_bucket(128, 256) == 192


def test_pooled_drop_counters():
    """render_rays_pooled reports selected/dropped; an ample budget drops
    zero, an undersized one drops exactly selected - budget."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()  # warmup: everything occupied
    renderer = OccupancyRenderer(
        model=model, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=16,
    )
    rays = jnp.asarray(_random_rays(24, seed=1))
    background = jnp.asarray([0.0, 0.0, 0.0])
    key = jax.random.PRNGKey(0)

    ample = renderer.render_rays_pooled(
        key, rays, params, background, grid_state, budget=24 * 16
    )
    sel = int(ample["selected"])
    assert sel > 0
    assert int(ample["dropped"]) == 0

    tight_budget = max(sel // 3, 1)
    tight = renderer.render_rays_pooled(
        key, rays, params, background, grid_state, budget=tight_budget
    )
    assert int(tight["selected"]) == sel
    assert int(tight["dropped"]) == sel - tight_budget


def test_frame_session_reports_and_escalates(capsys):
    """OccupancyFrameSession: a numeric undersized budget reports the drop
    rate; auto mode re-measures per view and renders drop-free."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyFrameSession, OccupancyRenderer

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()
    renderer = OccupancyRenderer(
        model=model, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=16,
    )
    background = jnp.asarray([0.0, 0.0, 0.0])
    # Aim every ray at the scene so selection demand is real (~16/ray on
    # the fully-occupied warmup grid).
    origins = _random_rays(64, seed=2)[:, 0]
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    rays = jnp.asarray(np.stack([origins, dirs], axis=1))

    # Budget 1/ray must drop and warn.
    manual = OccupancyFrameSession(
        renderer, params, background, grid_state,
        budget_cfg=1.0, tile_size=32,
    )
    out = manual.render(jax.random.PRNGKey(0), rays)
    assert int(out["dropped"]) > 0
    captured = capsys.readouterr().out
    assert "WARNING" in captured and "dropped" in captured

    # Auto mode sizes from measured demand and must drop nothing.
    auto = OccupancyFrameSession(
        renderer, params, background, grid_state,
        budget_cfg="auto", tile_size=32,
    )
    out = auto.render(jax.random.PRNGKey(0), rays)
    assert int(out["dropped"]) == 0
    assert "auto render budget" in capsys.readouterr().out


def test_pickle_resume_keeps_loop_cadence(tmp_path):
    """A params-pickle resume restores the host step counter, so a
    post-switchover run resumes pooled stepping immediately instead of
    re-waiting pool_start_step dense steps."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.train import OccupancyTrainLoop

    def make_loop():
        model, _ = _small_model_and_params()
        return OccupancyTrainLoop(
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-3,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            candidates=16,
            samples=8,
            grid_resolution=8,
            update_interval=4,
            pool_budget_per_ray=4.0,
            pool_start_step=3,
            grid_warmup_updates=1,
        )

    batch = np.concatenate(
        [_random_rays(16, seed=0), np.zeros((16, 1, 3), np.float32)], axis=1
    )
    a = make_loop()
    base_key = jax.random.PRNGKey(5)
    for _ in range(5):  # past pool_start_step: pooled stepping active
        a.step_auto(base_key, batch)
    assert a._host_step == 5
    path = str(tmp_path / "ckpt.pkl")
    a.save(path)

    b = make_loop()
    b.load(path)
    assert b._host_step == 5
    # The optimizer step counter syncs too: step_auto keys and the
    # scanned path's in-jit cadence fold state.step, so both must resume
    # from the checkpointed count, not replay the stream from 0.
    assert int(b.state.step) == 5
    # The very next step must dispatch the POOLED path: stub the dense fn
    # so any fallback to it fails loudly.
    def boom(*args, **kwargs):
        raise AssertionError("dense step used after pooled switchover")

    b._auto_step_fn = boom
    b.step_auto(base_key, batch)
    assert b._host_step == 6


def test_step_auto_many_matches_per_step():
    """K scanned steps in one dispatch (step_auto_many) produce the same
    params, grid state, and metrics as K step_auto dispatches — including
    the in-scan grid-refresh cadence and the pooled switchover."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.train import OccupancyTrainLoop

    def make_loop():
        model, _ = _small_model_and_params()
        return OccupancyTrainLoop(
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-3,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            candidates=16,
            samples=8,
            grid_resolution=8,
            update_interval=4,
            update_cells=64,
            pool_budget_per_ray=4.0,
            pool_start_step=4,
            grid_warmup_updates=1,
        )

    rng = np.random.RandomState(0)
    steps = 8
    batches = np.stack(
        [
            np.concatenate(
                [_random_rays(16, seed=s), rng.rand(16, 1, 3).astype(np.float32)],
                axis=1,
            )
            for s in range(steps)
        ]
    )
    base_key = jax.random.PRNGKey(5)

    a = make_loop()
    last = None
    for s in range(steps):
        last = a.step_auto(base_key, batches[s])

    b = make_loop()
    # Two macro dispatches of 4: dense (steps 0-3), pooled (steps 4-7).
    vals = None
    for chunk in (batches[:4], batches[4:]):
        vals = b.step_auto_many(base_key, chunk)

    # MISALIGNED macros: pool_start_step=4 inside a [3, 5] chunking — the
    # straddling macro must split at the boundary so the pooled
    # switchover happens at exactly step 4, not the next macro boundary.
    c = make_loop()
    vals_c = None
    for chunk in (batches[:3], batches[3:]):
        vals_c = c.step_auto_many(base_key, chunk)

    for other, other_vals in ((b, vals), (c, vals_c)):
        assert a._host_step == other._host_step == steps
        assert int(a.state.step) == int(other.state.step) == steps
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-7
            ),
            jax.device_get(a.state.params),
            jax.device_get(other.state.params),
        )
        np.testing.assert_allclose(
            np.asarray(a.grid_state.densities),
            np.asarray(other.grid_state.densities),
            rtol=1e-6,
        )
        assert int(a.grid_state.step) == int(other.grid_state.step)
        for name in last:
            np.testing.assert_allclose(
                float(last[name]), float(other_vals[name]), rtol=1e-5,
                err_msg=name,
            )


def test_frame_session_auto_escalates_on_underestimate(monkeypatch, capsys):
    """If the measured-demand sizing still overflows (demand is a mean),
    auto mode escalates the bucket and re-renders until drop-free."""
    import jax
    import jax.numpy as jnp

    import learn_nerf_tpu.occ_render as occ_render
    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyFrameSession, OccupancyRenderer

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()
    renderer = OccupancyRenderer(
        model=model, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=16,
    )
    origins = _random_rays(48, seed=3)[:, 0]
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    rays = jnp.asarray(np.stack([origins, dirs], axis=1))

    # Force a pathological first estimate (1 slot/ray on a ~16/ray scene).
    monkeypatch.setattr(
        occ_render, "resolve_auto_budget", lambda *a, **k: 1
    )
    session = OccupancyFrameSession(
        renderer, params, jnp.zeros(3), grid_state,
        budget_cfg="auto", tile_size=24,
    )
    out = session.render(jax.random.PRNGKey(0), rays)
    assert int(out["dropped"]) == 0
    printed = capsys.readouterr().out
    assert "escalating budget" in printed

    # The escalated budget persists as a floor: the next frame starts at
    # it instead of re-paying the drop -> escalate -> re-render cycle
    # (the patched estimator still says 1).
    out2 = session.render(jax.random.PRNGKey(1), rays)
    assert int(out2["dropped"]) == 0
    assert "escalating budget" not in capsys.readouterr().out


def test_superpool_densities_conservative():
    from learn_nerf_tpu.acceleration import superpool_densities

    rng = np.random.RandomState(0)
    r, f = 16, 4
    d = rng.rand(r**3).astype(np.float32)
    sup = np.asarray(superpool_densities(d, r, f))
    rs = r // f
    cube = d.reshape(r, r, r)  # [z, y, x]
    for zs in range(rs):
        for ys in range(rs):
            for xs in range(rs):
                block = cube[
                    zs * f : (zs + 1) * f,
                    ys * f : (ys + 1) * f,
                    xs * f : (xs + 1) * f,
                ]
                assert sup[xs + rs * (ys + rs * zs)] == block.max()


def test_two_phase_span_selection_matches_single_phase():
    """Two-phase selection on a slab scene: the span tightens to the slab
    (plus the conservative pad), no occupied candidate cells are lost,
    and the pooled render matches single-phase closely."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    r = 32
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    # Occupied only in a z-slab around z in [-0.25, 0].
    cube = np.zeros((r, r, r), np.float32)  # [z, y, x]
    z0, z1 = int(r * 0.375), int(r * 0.5)
    cube[z0:z1] = 1.0
    grid_state = grid.init().replace(
        densities=jnp.asarray(cube.reshape(-1)),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    def renderer(span):
        return OccupancyRenderer(
            model=model, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
            candidates=64, samples=24,
            span_candidates=span, span_pool_factor=8,
        )

    # Rays along +z from below: occupied span is [z0..z1] only.
    n = 32
    rng = np.random.RandomState(1)
    xy = rng.rand(n, 2).astype(np.float32) * 1.6 - 0.8
    origins = np.concatenate([xy, np.full((n, 1), -3.0, np.float32)], axis=1)
    dirs = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    rays = jnp.asarray(np.stack([origins, dirs], axis=1))
    key = jax.random.PRNGKey(0)

    two = renderer(64)
    t_lo, t_hi, hit = two._occupied_span(
        rays[:, 0], rays[:, 1], jnp.full((n,), 2.0), jnp.full((n,), 4.0),
        grid_state,
    )
    assert bool(jnp.all(hit))
    # Slab z in [-0.25, 0] -> t in [2.75, 3.0]; pad = sqrt(3)*2/4 ~ 0.87.
    np.testing.assert_array_less(np.asarray(t_lo), 2.76)
    np.testing.assert_array_less(2.75 - 0.9, np.asarray(t_lo))
    np.testing.assert_array_less(np.asarray(t_hi), 3.0 + 0.9)
    np.testing.assert_array_less(2.99, np.asarray(t_hi))

    # Demand parity: the two-phase path must see at least the single-phase
    # survivor count (finer resolution inside the span finds >= cells).
    single = renderer(0)
    d1 = float(single.mean_sample_demand(key, rays, grid_state))
    d2 = float(two.mean_sample_demand(key, rays, grid_state))
    assert d2 >= d1 - 0.5

    background = jnp.asarray([0.2, 0.2, 0.2])
    out1 = single.render_rays_pooled(
        key, rays, params, background, grid_state, budget=n * 24
    )
    out2 = two.render_rays_pooled(
        key, rays, params, background, grid_state, budget=n * 24
    )
    # Different candidate placement -> not bit-equal; the composited
    # slab color must agree closely on this smooth model (the tolerance
    # absorbs stratified-placement noise from the span width, which the
    # dilation/pad scheme legitimately changes).
    np.testing.assert_allclose(
        np.asarray(out2["outputs"]), np.asarray(out1["outputs"]), atol=0.05
    )

    # A ray that misses the slab entirely (enters above it) composites to
    # background with hit=False.
    miss_origin = np.asarray([[0.0, 3.0, 0.5]], np.float32)
    miss_dir = np.asarray([[0.0, -1.0, 0.0]], np.float32)
    miss_rays = jnp.asarray(np.stack([miss_origin, miss_dir], axis=1))
    out_miss = two.render_rays_pooled(
        key, miss_rays, params, background, grid_state, budget=24
    )
    np.testing.assert_allclose(
        np.asarray(out_miss["outputs"])[0], 0.2, atol=1e-5
    )


def test_two_phase_span_finds_single_cell():
    """Conservation stress: a SINGLE occupied cell anywhere in the grid
    must survive two-phase selection (the supergrid max-pool cannot hide
    it and the padded span cannot clip it)."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    r = 32
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    renderer = OccupancyRenderer(
        model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=96, samples=16, span_candidates=64, span_pool_factor=8,
    )
    rng = np.random.RandomState(4)
    key = jax.random.PRNGKey(0)
    for trial in range(6):
        cell = rng.randint(0, r, size=3)  # (x, y, z)
        densities = np.zeros(r**3, np.float32)
        densities[cell[0] + r * (cell[1] + r * cell[2])] = 1.0
        gs = grid.init().replace(
            densities=jnp.asarray(densities),
            step=jnp.asarray(grid.warmup_updates, jnp.int32),
        )
        center = (cell + 0.5) / r * 2.0 - 1.0  # world-space cell center
        # A ray aimed straight at the cell center from a random direction.
        d = rng.randn(3).astype(np.float32)
        d /= np.linalg.norm(d)
        origin = center - d * 3.0
        rays = jnp.asarray(
            np.stack([origin, d], axis=0)[None].astype(np.float32)
        )
        _, occ, _, mask = renderer._select_candidates(key, rays, gs)
        assert bool(mask[0]), f"trial {trial}: ray missed bbox"
        assert int(occ.sum()) >= 1, (
            f"trial {trial}: occupied cell {cell} lost by two-phase selection"
        )


def test_two_phase_span_covers_corner_grazing_chord():
    """Conservation stress for GRAZING rays: a ray that clips only the
    corner of an occupied supercell — chord much shorter than the probe
    spacing, every probe midpoint landing in *empty* neighbors — must
    still get a span covering the chord.  This is exactly the case the
    supergrid max-dilation exists for; without it the probes straddle the
    chord and the ray renders as background."""
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    r, factor = 64, 8
    rs = r // factor
    s = 2.0 / rs  # supercell side, bbox [-1, 1]^3
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    renderer = OccupancyRenderer(
        model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=96, samples=16, span_candidates=32, span_pool_factor=factor,
    )
    delta = 0.01  # chord length delta*sqrt(2) ~ 0.014 << probe spacing
    for sc in [(4, 4, 3), (5, 2, 6), (2, 6, 1)]:
        # Occupy every fine cell of supercell sc (x, y, z indices).
        densities = np.zeros((r, r, r), np.float32)  # [z, y, x]
        densities[
            sc[2] * factor:(sc[2] + 1) * factor,
            sc[1] * factor:(sc[1] + 1) * factor,
            sc[0] * factor:(sc[0] + 1) * factor,
        ] = 1.0
        gs = grid.init().replace(
            densities=jnp.asarray(densities.reshape(-1)),
            step=jnp.asarray(grid.warmup_updates, jnp.int32),
        )
        # Ray direction (1,-1,0)/sqrt(2) clipping the (max-x, max-y)
        # corner of the supercell: on the line x+y = const the chord
        # inside the cell is the tiny corner triangle of size delta.
        xmax = -1.0 + (sc[0] + 1) * s
        ymax = -1.0 + (sc[1] + 1) * s
        zmid = -1.0 + (sc[2] + 0.5) * s
        mid = np.asarray([xmax - delta / 2, ymax - delta / 2, zmid], np.float32)
        d = np.asarray([1.0, -1.0, 0.0], np.float32) / np.sqrt(2.0)
        origin = mid - 2.5 * d
        half_chord = delta * np.sqrt(2.0) / 2.0
        t_in, t_out = 2.5 - half_chord, 2.5 + half_chord

        from learn_nerf_tpu.ops.geometry import ray_bbox_range

        t_min, t_max, inb = ray_bbox_range(
            jnp.asarray(origin)[None], jnp.asarray(d)[None],
            jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]),
            renderer.min_t_range,
        )
        assert bool(inb[0])
        t_lo, t_hi, hit = renderer._occupied_span(
            jnp.asarray(origin)[None], jnp.asarray(d)[None], t_min, t_max, gs
        )
        assert bool(hit[0]), f"supercell {sc}: grazing chord not detected"
        assert float(t_lo[0]) <= t_in, (sc, float(t_lo[0]), t_in)
        assert float(t_hi[0]) >= t_out, (sc, float(t_hi[0]), t_out)


def test_block_word_occupancy_matches_cell_path():
    """Packed block-word selection (--occ_block_gather): stride 1 is
    bit-identical to the per-cell gather path (every candidate is its own
    probe, so the word's bit IS the cell's occupancy); stride 4 is a
    conservative superset (block-mismatch candidates count occupied) with
    a small fallback rate; warmup keeps everything occupied."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    r = 32
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    rng = np.random.RandomState(7)
    densities = (rng.rand(r**3) < 0.08).astype(np.float32)  # sparse blobs
    gs = grid.init().replace(
        densities=jnp.asarray(densities),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    def renderer(stride):
        return OccupancyRenderer(
            model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
            candidates=96, samples=16, block_gather_stride=stride,
        )

    # Aim every ray INTO the bbox from z=-3 so most cross occupied cells.
    rays = _rays_into_bbox(64)
    key = jax.random.PRNGKey(0)

    base = renderer(0)
    _, occ0, _, mask0 = base._select_candidates(key, rays, gs)
    one = renderer(1)
    _, occ1, _, mask1 = one._select_candidates(key, rays, gs)
    np.testing.assert_array_equal(np.asarray(occ0), np.asarray(occ1))
    np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask1))

    four = renderer(4)
    _, occ4, _, _ = four._select_candidates(key, rays, gs)
    o0, o4 = np.asarray(occ0), np.asarray(occ4)
    assert not np.any(o0 & ~o4), "block-word path dropped occupied candidates"
    extra = (o4 & ~o0).mean()
    assert extra < 0.05, f"conservative fallback rate too high: {extra:.3f}"

    # The transmittance prune composes: still never drops what the
    # unpruned cell path keeps pruned at the same eps... the prune sees
    # block-max densities (>= per-cell), so compare against eps=0 base.
    _, occ4e, _, _ = four._select_candidates(
        key, rays, gs, transmittance_eps=1e-6
    )
    assert not np.any(np.asarray(occ4e) & ~o4)

    # Warmup: everything occupied regardless of the words.
    gs_warm = grid.init()
    _, occw, _, maskw = four._select_candidates(key, rays, gs_warm)
    assert bool(jnp.all(occw[maskw]))

    # Non-divisible resolution is a loud error, not silent corruption.
    import pytest

    grid_bad = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=10
    )
    bad = OccupancyRenderer(
        model=None, grid=grid_bad, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=8, block_gather_stride=2,
    )
    with pytest.raises(ValueError, match="not divisible"):
        bad._select_candidates(key, rays, grid_bad.init())


def test_block_word_render_bit_identical_at_stride_one():
    """End-to-end: render_rays with block_gather_stride=1 (eps 0) must be
    BIT-identical to the per-cell path — same occ -> same strided
    compaction -> same model points -> same image."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    r = 32
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    rng = np.random.RandomState(11)
    densities = (rng.rand(r**3) < 0.1).astype(np.float32) * 2.0
    gs = grid.init().replace(
        densities=jnp.asarray(densities),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    def render(stride):
        rend = OccupancyRenderer(
            model=model, grid=grid, bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1), candidates=64, samples=16,
            block_gather_stride=stride,
        )
        out, _ = rend.render_rays(
            jax.random.PRNGKey(4), _rays_into_bbox(48),
            params, jnp.asarray([0.1, 0.2, 0.3]), gs,
        )
        return np.asarray(out["outputs"])

    np.testing.assert_array_equal(render(1), render(0))

    # stride 4 differs only through the rare conservative extras (an
    # extra "occupied" candidate changes that ray's strided compaction
    # and delta_scale): a few rays shift visibly on this random-param
    # model, the rest are identical.
    # (This incoherent random-blob grid is the worst case for block
    # bracketing — real trained grids are spatially coherent; the
    # fidelity/speed tradeoff per stride is measured on-chip.)
    r4, r0 = render(4), render(0)
    diff = np.abs(r4 - r0).max(axis=-1)
    assert (diff > 0.01).mean() < 0.25, (diff > 0.01).mean()
    assert diff.max() < 0.2, diff.max()


def _rays_into_bbox(n, seed=3):
    import jax.numpy as jnp

    dirs = np.asarray(_random_rays(n, seed=seed)[:, 1])
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (n, 1))
    return jnp.asarray(np.stack([origins, dirs.astype(np.float32)], axis=1))


def test_span_block_gather_identical_at_stride_one_and_widens_after():
    """Block-word span probes (--occ_span_block_gather): stride 1 must be
    bit-identical to the per-cell span; stride 4 may only WIDEN spans
    (t_lo' <= t_lo, t_hi' >= t_hi, hit' a superset) — a narrowed span
    would silently exclude geometry from phase 2."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    r, factor = 64, 8  # supergrid rs=8, divisible by the 4x4x2 blocks
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    rng = np.random.RandomState(17)
    densities = (rng.rand(r**3) < 0.02).astype(np.float32)
    gs = grid.init().replace(
        densities=jnp.asarray(densities),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    def spans(stride):
        rend = OccupancyRenderer(
            model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
            candidates=96, samples=16, span_candidates=32,
            span_pool_factor=factor, span_block_gather=stride,
        )
        rays = _rays_into_bbox(96, seed=5)
        origins, dirs = rays[:, 0], rays[:, 1]
        from learn_nerf_tpu.ops.geometry import ray_bbox_range

        t_min, t_max, _ = ray_bbox_range(
            origins, dirs, jnp.asarray([-1.0, -1.0, -1.0]),
            jnp.asarray([1.0, 1.0, 1.0]),
        )
        lo, hi, hit = rend._occupied_span(origins, dirs, t_min, t_max, gs)
        return np.asarray(lo), np.asarray(hi), np.asarray(hit)

    lo0, hi0, hit0 = spans(0)
    lo1, hi1, hit1 = spans(1)
    np.testing.assert_array_equal(lo0, lo1)
    np.testing.assert_array_equal(hi0, hi1)
    np.testing.assert_array_equal(hit0, hit1)

    lo4, hi4, hit4 = spans(4)
    assert not np.any(hit0 & ~hit4), "block-word span dropped a hit ray"
    both = hit0 & hit4
    assert np.all(lo4[both] <= lo0[both] + 1e-6)
    assert np.all(hi4[both] >= hi0[both] - 1e-6)

    # Warmup: the span degenerates to the full range either way.
    gs_warm = grid.init()
    rendw = OccupancyRenderer(
        model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=96, samples=16, span_candidates=32,
        span_pool_factor=factor, span_block_gather=4,
    )
    rays = _rays_into_bbox(8, seed=5)
    from learn_nerf_tpu.ops.geometry import ray_bbox_range
    import jax.numpy as jnp2

    t_min, t_max, _ = ray_bbox_range(
        rays[:, 0], rays[:, 1], jnp2.asarray([-1.0, -1.0, -1.0]),
        jnp2.asarray([1.0, 1.0, 1.0]),
    )
    lo, hi, hit = rendw._occupied_span(rays[:, 0], rays[:, 1], t_min, t_max, gs_warm)
    assert bool(jnp2.all(hit))
    np.testing.assert_allclose(np.asarray(lo), np.asarray(t_min), atol=1e-6)
    np.testing.assert_allclose(np.asarray(hi), np.asarray(t_max), atol=1e-6)

    # A supergrid too small to tile into 4x4x2 blocks falls back to the
    # per-cell span path (exact — the lever is moot at that size): the
    # result must be bit-identical to span_block_gather=0.
    grid_small = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=16
    )  # rs = 16/8 = 2: not divisible by (4, 4, 2)
    dens_small = (np.random.RandomState(3).rand(16**3) < 0.05).astype(np.float32)
    gs_small = grid_small.init().replace(
        densities=jnp2.asarray(dens_small),
        step=jnp2.asarray(grid_small.warmup_updates, jnp.int32),
    )
    raysb = _rays_into_bbox(32, seed=5)
    t_minb, t_maxb, _ = ray_bbox_range(
        raysb[:, 0], raysb[:, 1], jnp2.asarray([-1.0, -1.0, -1.0]),
        jnp2.asarray([1.0, 1.0, 1.0]),
    )

    def small_spans(stride):
        rend = OccupancyRenderer(
            model=None, grid=grid_small, bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1), candidates=32, samples=8, span_candidates=16,
            span_pool_factor=8, span_block_gather=stride,
        )
        lo, hi, hit = rend._occupied_span(
            raysb[:, 0], raysb[:, 1], t_minb, t_maxb, gs_small
        )
        return np.asarray(lo), np.asarray(hi), np.asarray(hit)

    for a, b in zip(small_spans(0), small_spans(2)):
        np.testing.assert_array_equal(a, b)


def test_span_block_gather_render_bit_identical_at_stride_one():
    """End-to-end render with span_block_gather=1 == per-cell span path."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    r = 64
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    rng = np.random.RandomState(23)
    densities = (rng.rand(r**3) < 0.05).astype(np.float32) * 2.0
    gs = grid.init().replace(
        densities=jnp.asarray(densities),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    def render(stride):
        rend = OccupancyRenderer(
            model=model, grid=grid, bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1), candidates=64, samples=16,
            span_candidates=32, span_pool_factor=8,
            span_block_gather=stride,
        )
        out, _ = rend.render_rays(
            jax.random.PRNGKey(4), _rays_into_bbox(32),
            params, jnp.asarray([0.1, 0.2, 0.3]), gs,
        )
        return np.asarray(out["outputs"])

    np.testing.assert_array_equal(render(1), render(0))


def test_two_phase_span_anisotropic_bbox():
    """On a non-cubic bbox the probe-count precondition must scale with
    the SHORTEST supercell side (deriving it from the max side quietly
    breaks conservation on LLFF-style flat boxes), and corner-grazing
    conservation must still hold."""
    import jax.numpy as jnp
    import pytest

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer
    from learn_nerf_tpu.ops.geometry import ray_bbox_range

    r, factor = 64, 8
    rs = r // factor
    bmin, bmax = (-1.0, -1.0, -0.25), (1.0, 1.0, 0.25)
    grid = OccupancyGrid(bbox_min=bmin, bbox_max=bmax, resolution=r)

    def renderer(span):
        return OccupancyRenderer(
            model=None, grid=grid, bbox_min=bmin, bbox_max=bmax,
            candidates=96, samples=16, span_candidates=span,
            span_pool_factor=factor,
        )

    # The cubic-formula count (2*sqrt(3)*rs ~ 28) is NOT enough here:
    # diag/min_span = 2.87/0.5 -> need >= 92 probes.
    too_few = renderer(32)
    with pytest.raises(ValueError, match="occ_span_candidates"):
        too_few._occupied_span(
            jnp.zeros((1, 3)), jnp.asarray([[1.0, 0.0, 0.0]]),
            jnp.zeros(1), jnp.ones(1),
            grid.init(),
        )

    rend = renderer(96)
    sx, sy = 2.0 / rs, 2.0 / rs
    delta = 0.01
    densities = np.zeros((r, r, r), np.float32)  # [z, y, x]
    sc = (4, 4, 3)
    densities[
        sc[2] * factor:(sc[2] + 1) * factor,
        sc[1] * factor:(sc[1] + 1) * factor,
        sc[0] * factor:(sc[0] + 1) * factor,
    ] = 1.0
    gs = grid.init().replace(
        densities=jnp.asarray(densities.reshape(-1)),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )
    xmax = -1.0 + (sc[0] + 1) * sx
    ymax = -1.0 + (sc[1] + 1) * sy
    zmid = -0.25 + (sc[2] + 0.5) * (0.5 / rs)
    mid = np.asarray([xmax - delta / 2, ymax - delta / 2, zmid], np.float32)
    d = np.asarray([1.0, -1.0, 0.0], np.float32) / np.sqrt(2.0)
    origin = mid - 1.5 * d
    half_chord = delta * np.sqrt(2.0) / 2.0
    t_in, t_out = 1.5 - half_chord, 1.5 + half_chord

    t_min, t_max, inb = ray_bbox_range(
        jnp.asarray(origin)[None], jnp.asarray(d)[None],
        jnp.asarray(bmin), jnp.asarray(bmax), rend.min_t_range,
    )
    assert bool(inb[0])
    t_lo, t_hi, hit = rend._occupied_span(
        jnp.asarray(origin)[None], jnp.asarray(d)[None], t_min, t_max, gs
    )
    assert bool(hit[0])
    assert float(t_lo[0]) <= t_in
    assert float(t_hi[0]) >= t_out


def test_two_phase_span_rejects_undersized_probe_count():
    """Too few span probes for the supergrid resolution would silently
    skip thin occupied supercells (rays render as background) — the
    renderer refuses instead, naming both levers."""
    import jax
    import jax.numpy as jnp
    import pytest

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    r = 256  # supergrid 32^3 at factor 8 -> needs >= 111 probes
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=r)
    renderer = OccupancyRenderer(
        model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=96, samples=16, span_candidates=64, span_pool_factor=8,
    )
    gs = grid.init().replace(step=jnp.asarray(grid.warmup_updates, jnp.int32))
    rays = jnp.asarray(
        np.stack(
            [np.asarray([0.0, 0.0, -3.0]), np.asarray([0.0, 0.0, 1.0])], axis=0
        )[None].astype(np.float32)
    )
    with pytest.raises(ValueError, match="occ_span_candidates"):
        renderer._select_candidates(jax.random.PRNGKey(0), rays, gs)
    # The same config with a sufficient probe count works.
    ok = OccupancyRenderer(
        model=None, grid=grid, bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=96, samples=16, span_candidates=112, span_pool_factor=8,
    )
    ok._select_candidates(jax.random.PRNGKey(0), rays, gs)


def test_cli_steps_per_dispatch(tmp_path):
    """train_nerf --steps_per_dispatch drives the scanned macro-step path
    end to end: trains, logs strided steps, writes a working checkpoint,
    and a --baked render of it produces a frame."""
    from learn_nerf_tpu.scripts import render_nerf, train_nerf

    from .synthetic_scene import write_dataset

    scene = write_dataset(str(tmp_path / "scene"), num_views=6, resolution=16)
    save_path = str(tmp_path / "occ_scan.pkl")
    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--batch_size", "256",
            # Deliberately NOT a multiple of steps_per_dispatch: the final
            # partial dispatch must scan exactly the remaining 2 steps
            # (equal-step baseline comparisons depend on it).
            "--steps", "10",
            "--steps_per_dispatch", "4",
            "--instant_ngp",
            "--occupancy",
            "--occ_candidates", "32",
            "--occ_samples", "8",
            "--occ_grid", "16",
            "--save_path", save_path,
            scene,
        ]
    )
    import pickle

    with open(save_path, "rb") as f:
        ckpt = pickle.load(f)
    assert int(ckpt["occupancy_host_step"]) == 10

    out_png = str(tmp_path / "out.png")
    render_nerf.main(
        [
            "--seed", "0",
            "--batch_size", "128",
            "--instant_ngp",
            "--occupancy",
            "--occ_candidates", "32",
            "--occ_samples", "8",
            "--occ_grid", "16",
            "--occ_budget_per_ray", "auto",
            "--baked", "33",
            "--width", "16",
            "--height", "16",
            "--model_path", save_path,
            scene + "/metadata.json",
            scene + "/0000.json",
            out_png,
        ]
    )
    from PIL import Image

    assert np.asarray(Image.open(out_png)).shape == (16, 16, 3)


def test_grid_resolution_mismatch_rejected():
    """Resuming a checkpointed grid into a differently-sized OccupancyGrid
    must raise: indexing a 16^3 density vector with 8-stride cell_indices
    silently corrupts culling."""
    from learn_nerf_tpu.acceleration import OccupancyGrid

    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    payload = dict(
        occupancy_densities=np.zeros(16**3, np.float32),
        occupancy_resolution=np.int32(16),
    )
    with pytest.raises(ValueError, match="--occ_grid 16"):
        grid.state_from_checkpoint(payload)
    # Matching resolution loads fine; a missing resolution key falls back
    # to the density vector's own length (checked below: a legacy
    # mismatch still raises).
    ok = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=16)
    state = ok.state_from_checkpoint(payload)
    assert state.densities.shape == (16**3,)
    legacy = dict(occupancy_densities=np.zeros(8**3, np.float32))
    assert grid.state_from_checkpoint(legacy).densities.shape == (8**3,)
    # A legacy checkpoint WITHOUT the resolution key still cannot slip a
    # mismatched grid through: the density vector's length is checked.
    legacy_mismatch = dict(occupancy_densities=np.zeros(16**3, np.float32))
    with pytest.raises(ValueError, match="--occ_grid 16"):
        grid.state_from_checkpoint(legacy_mismatch)
    # And a corrupt (non-cube) vector is rejected outright.
    with pytest.raises(ValueError, match="corrupt"):
        grid.state_from_checkpoint(
            dict(occupancy_densities=np.zeros(100, np.float32))
        )


def test_pooled_transmittance_precision_at_scale():
    """Compositing precision must not degrade with pool size: the pooled
    path's per-ray transmittance comes from a segment-reset scan, not a
    difference of tile-global cumsums (whose f32 error grows linearly with
    the pool's total optical depth — ~3e-4 for trailing rays at this size,
    which this tolerance would catch)."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init().replace(
        densities=jnp.ones(8**3, jnp.float32),  # everything occupied
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )

    c = 16
    renderer = OccupancyRenderer(
        model=model,
        grid=grid,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=c,
        samples=c,
    )
    n = 2048
    rays = jnp.asarray(_random_rays(n, seed=11))
    background = jnp.asarray([0.3, -0.2, 0.8])
    key = jax.random.PRNGKey(13)

    ref_out, _ = renderer.render_rays(key, rays, params, background, grid_state)
    pooled = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=n * c, transmittance_eps=0.0,
    )
    np.testing.assert_allclose(
        np.asarray(pooled["outputs"]), np.asarray(ref_out["outputs"]),
        rtol=0, atol=2e-6,
    )


def test_fixed_k_frame_honors_transmittance_eps():
    """The fixed-K (non-pooled) frame path must forward transmittance_eps
    to render_rays — an --occ_t_eps render without a pool budget was
    silently ignoring early termination (review round 3)."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer, render_frame_occupancy

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    # A grid dense enough that an aggressive eps prunes behind the front:
    # every cell 'occupied' at density 5 -> approx transmittance collapses
    # within a few candidates.
    grid_state = grid.init().replace(
        densities=jnp.full((8**3,), 5.0, jnp.float32),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )
    renderer = OccupancyRenderer(
        model=model, grid=grid,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=32, samples=8,
    )
    rays = jnp.asarray(_random_rays(64, seed=3))
    bg = jnp.zeros(3)
    key = jax.random.PRNGKey(0)

    plain = render_frame_occupancy(
        renderer, key, rays, params, bg, grid_state,
        tile_size=32, include_depth_outputs=True,
    )
    pruned = render_frame_occupancy(
        renderer, key, rays, params, bg, grid_state,
        tile_size=32, transmittance_eps=0.5, include_depth_outputs=True,
    )
    # Same key + same candidates: outputs must DIFFER once the aggressive
    # eps prunes trailing candidates (before the fix the kwarg was dropped
    # and the two frames were identical).
    assert not np.allclose(
        np.asarray(plain["outputs"]), np.asarray(pruned["outputs"])
    )
    # And the eps frame parallels the per-ray call with the same eps.
    direct, _ = renderer.render_rays(
        jax.random.fold_in(key, 0), rays[:32], params, bg, grid_state,
        transmittance_eps=0.5,
    )
    np.testing.assert_allclose(
        np.asarray(pruned["outputs"][:32]), np.asarray(direct["outputs"]),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pooled_equals_dense_fuzz(seed):
    """Pooled compaction == fixed-K rendering at ample budget across
    randomized configs (grid size, candidates, samples, occupancy
    fraction, ray count): the invariant behind lossless auto-budget
    sizing must not depend on one hand-picked shape."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.occ_render import OccupancyRenderer

    rng = np.random.RandomState(100 + seed)
    res = int(rng.choice([4, 8, 16]))
    c = int(rng.choice([8, 16, 24]))
    k = int(rng.choice([4, 8, c]))
    k = min(k, c)
    n = int(rng.choice([33, 64, 127]))  # odd sizes included
    frac = float(rng.choice([0.05, 0.3, 0.9]))

    model, params = _small_model_and_params()
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=res)
    grid_state = grid.init().replace(
        densities=jnp.asarray((rng.rand(res**3) < frac).astype(np.float32)),
        step=jnp.asarray(grid.warmup_updates, jnp.int32),
    )
    renderer = OccupancyRenderer(
        model=model, grid=grid,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=c, samples=k,
    )
    rays = jnp.asarray(_random_rays(n, seed=seed))
    background = jnp.asarray([0.1, -0.4, 0.7])
    key = jax.random.PRNGKey(seed)

    dense, _ = renderer.render_rays(key, rays, params, background, grid_state)
    pooled = renderer.render_rays_pooled(
        key, rays, params, background, grid_state,
        budget=n * k, transmittance_eps=0.0,
    )
    assert int(pooled["dropped"]) == 0  # budget n*k can never overflow
    np.testing.assert_allclose(
        np.asarray(pooled["outputs"]), np.asarray(dense["outputs"]),
        rtol=0, atol=5e-6,
    )


def test_grid_refresh_multi_sample():
    """--occ_refresh_samples: S jittered points per refreshed cell (max).
    S=1 must reproduce the original key stream bit-for-bit; S=8 must
    detect a thin density shell inside a cell far more reliably than a
    single sample (the measured late-training failure mode: a sharpened
    shell thinner than the cell gets missed, the cell culls, and the
    loss excursions)."""
    from learn_nerf_tpu import nn
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid

    class ThinShell(nn.Module):
        """Density 50 only within |x| < 0.02 (a thin wall through x=0)."""

        @nn.compact
        def __call__(self, x, d):
            density = jnp.where(jnp.abs(x[..., :1]) < 0.02, 50.0, 0.0)
            return density, jnp.zeros_like(x), {}

    model = ThinShell()
    params = model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    ).get("params", {})
    grid = OccupancyGrid(
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=4,
        warmup_updates=0,
    )
    # Cells straddling x=0 contain the wall in a ~4% slice of their width.
    # Zeroed densities: the init floor (2x threshold) would otherwise keep
    # every cell occupied regardless of what the refresh detects.
    state0 = grid.init().replace(
        densities=jnp.zeros_like(grid.init().densities),
        step=jnp.asarray(1, jnp.int32),
    )

    # Bit-identity: num_samples=1 == the original single-sample update.
    a = grid.update(state0, model, params, jax.random.PRNGKey(3))
    b = grid.update(state0, model, params, jax.random.PRNGKey(3), num_samples=1)
    np.testing.assert_array_equal(np.asarray(a.densities), np.asarray(b.densities))

    # Detection statistics over 20 keys: count refreshes that mark the
    # wall cell at (cell x=1, y=0, z=0 -> world x in [-0.5, 0]) occupied.
    idx = 1 + 4 * (0 + 4 * 0)
    def detections(num_samples):
        hits = 0
        for k in range(20):
            st = grid.update(
                state0, model, params, jax.random.PRNGKey(100 + k),
                num_samples=num_samples,
            )
            hits += int(np.asarray(st.densities)[idx] > grid.threshold)
        return hits

    d1, d8 = detections(1), detections(8)
    # p(single sample hits a 4%-wide slab) ~ 0.04; with 8 samples ~ 0.28.
    assert d8 > d1, (d1, d8)
    assert d8 >= 3, (d1, d8)


def test_grid_freeze_after():
    """--occ_freeze_grid_after: refreshes stop at the freeze step on both
    the per-step and the scanned dispatch paths (same rule), so the grid
    stays bit-frozen for the rest of the run."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.train import OccupancyTrainLoop

    def make_loop():
        model, _ = _small_model_and_params()
        return OccupancyTrainLoop(
            model,
            init_rng=jax.random.PRNGKey(0),
            lr=1e-3,
            bbox_min=(-1, -1, -1),
            bbox_max=(1, 1, 1),
            candidates=16,
            samples=8,
            grid_resolution=8,
            update_interval=2,
            grid_warmup_updates=1,
            grid_freeze_after=4,
        )

    rng = np.random.RandomState(0)
    batches = np.stack(
        [
            np.concatenate(
                [_random_rays(16, seed=s), rng.rand(16, 1, 3).astype(np.float32)],
                axis=1,
            )
            for s in range(8)
        ]
    )
    key = jax.random.PRNGKey(5)

    a = make_loop()
    dens = []
    for s in range(8):
        a.step_auto(key, batches[s])
        dens.append(np.asarray(a.grid_state.densities))
    # Refreshes fire at steps 0 and 2 (interval 2, freeze at 4): the grid
    # changes across them, then stays bit-frozen from step 4 on.
    assert not np.array_equal(dens[1], dens[3])  # refresh at step 2 landed
    for s in range(4, 8):
        np.testing.assert_array_equal(dens[s], dens[3])

    # Scanned dispatch applies the same rule: 8 steps in two macro
    # dispatches end with the identical frozen grid.
    b = make_loop()
    for chunk in (batches[:4], batches[4:]):
        b.step_auto_many(key, chunk)
    np.testing.assert_array_equal(
        np.asarray(b.grid_state.densities), dens[-1]
    )
