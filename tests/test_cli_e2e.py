"""End-to-end CLI test: synthetic scene -> train -> render -> checkpoint."""

import os

import numpy as np
import pytest

from .synthetic_scene import write_dataset


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=6, resolution=16)


def test_train_then_render(tiny_dataset, tmp_path):
    from learn_nerf_tpu.scripts import render_nerf, train_nerf

    save_path = str(tmp_path / "nerf.pkl")
    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--batch_size", "256",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--steps", "8",
            "--save_path", save_path,
            tiny_dataset,
        ]
    )
    assert os.path.exists(save_path)

    out_png = str(tmp_path / "out.png")
    render_nerf.main(
        [
            "--seed", "0",
            "--batch_size", "128",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--width", "16",
            "--height", "16",
            "--model_path", save_path,
            os.path.join(tiny_dataset, "metadata.json"),
            os.path.join(tiny_dataset, "0000.json"),
            os.path.join(tiny_dataset, "0001.json"),
            out_png,
        ]
    )
    from PIL import Image

    img = np.asarray(Image.open(out_png))
    assert img.shape == (16, 32, 3)  # two views side by side

    # Auto-resume path: train a few more steps from the checkpoint.
    train_nerf.main(
        [
            "--seed", "1",
            "--batch_size", "256",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--steps", "2",
            "--save_path", save_path,
            tiny_dataset,
        ]
    )


def test_eval_psnr_cli(tiny_dataset, tmp_path, capsys):
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.scripts import eval_psnr
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel()
    loop = TrainLoop(
        model, model, init_rng=jax.random.PRNGKey(0), lr=1e-3,
        coarse_ts=4, fine_ts=4, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3,
    )
    pkl = str(tmp_path / "nerf.pkl")
    loop.save(pkl)

    eval_psnr.main(
        [
            "--seed", "0",
            "--batch_size", "64",
            "--coarse_samples", "4",
            "--fine_samples", "4",
            "--max_views", "2",
            "--model_path", pkl,
            tiny_dataset,
        ]
    )
    out = capsys.readouterr().out
    assert "view 0: psnr=" in out
    assert "mean_psnr=" in out
    assert "mean_ssim=" in out  # 16x16 views >= the 11x11 SSIM window


def test_spin_and_pan_orbits(tiny_dataset, tmp_path):
    """Spin (yaw in place) and pan (orbit the center) render the expected
    reels; the orbit geometry matches the reference contract."""
    import jax

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.scripts import render_nerf_pan, render_nerf_spin
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel()  # RenderSession rebuilds the default architecture
    loop = TrainLoop(
        model, model, init_rng=jax.random.PRNGKey(0), lr=1e-3,
        coarse_ts=4, fine_ts=4, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3,
    )
    pkl = str(tmp_path / "nerf.pkl")
    loop.save(pkl)

    common = [
        "--seed", "0", "--batch_size", "64",
        "--coarse_samples", "4", "--fine_samples", "4",
        "--width", "8", "--height", "8",
        "--model_path", pkl, "--frames", "3",
    ]
    spin_png = str(tmp_path / "spin.png")
    render_nerf_spin.main(
        common + [os.path.join(tiny_dataset, "metadata.json"),
                  os.path.join(tiny_dataset, "0000.json"), spin_png]
    )
    pan_png = str(tmp_path / "pan.png")
    render_nerf_pan.main(
        common + [os.path.join(tiny_dataset, "metadata.json"), pan_png]
    )
    from PIL import Image

    assert np.asarray(Image.open(spin_png)).shape == (8, 24, 3)
    assert np.asarray(Image.open(pan_png)).shape == (8, 24, 3)


def test_cv_nerf_cli(tiny_dataset, capsys):
    """K-fold pose validation trains per fold (hot-loop path) and prints a
    loss line per held-out view."""
    from learn_nerf_tpu.scripts import cv_nerf

    cv_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--batch_size", "128",
            "--folds", "2",
            "--coarse_samples", "4",
            "--fine_samples", "4",
            "--train_iters", "3",
            tiny_dataset,
        ]
    )
    out = capsys.readouterr().out
    # 6 views over 2 folds -> one "loss path" line per view.
    loss_lines = [
        ln for ln in out.splitlines() if ln.rstrip().endswith(".png")
    ]
    assert len(loss_lines) == 6
    for ln in loss_lines:
        assert np.isfinite(float(ln.split()[0]))


def test_marching_cubes_cli(tmp_path):
    """The mesh-extraction CLI sweeps densities (sharded over the test
    mesh's 8 devices), extracts a surface, and writes OBJ and STL."""
    import jax
    import json

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.scripts import marching_cubes
    from learn_nerf_tpu.train import TrainLoop

    model = NeRFModel()
    loop = TrainLoop(
        model, model, init_rng=jax.random.PRNGKey(0), lr=1e-3,
        coarse_ts=4, fine_ts=4, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3,
    )
    pkl = str(tmp_path / "nerf.pkl")
    loop.save(pkl)
    meta = str(tmp_path / "metadata.json")
    with open(meta, "w") as f:
        json.dump({"min": [-0.7] * 3, "max": [0.7] * 3}, f)

    # An untrained softplus MLP has near-uniform low density; threshold
    # low enough that a surface exists somewhere in the grid.
    obj = str(tmp_path / "mesh.obj")
    marching_cubes.main(
        ["--resolution", "12", "--batch_size", "64", "--threshold", "0.01",
         "--model_path", pkl, meta, obj]
    )
    text = open(obj).read()
    assert text.count("\nf ") > 0 and text.startswith("v ")

    stl = str(tmp_path / "mesh.stl")
    marching_cubes.main(
        ["--resolution", "12", "--batch_size", "64", "--threshold", "0.01",
         "--model_path", pkl, meta, stl]
    )
    import struct

    with open(stl, "rb") as f:
        f.seek(80)
        (n_tris,) = struct.unpack("<I", f.read(4))
    assert n_tris > 0


def test_orbit_geometry_contracts():
    """spin_views yaws in place; orbit_views circles the bbox center at
    distance * |diag| looking inward with orthonormal frames."""
    from learn_nerf_tpu.data.camera import CameraView
    from learn_nerf_tpu.scripts.render_nerf_pan import orbit_views
    from learn_nerf_tpu.scripts.render_nerf_spin import spin_views

    start = CameraView(
        camera_direction=(0.0, 0.0, 1.0),
        camera_origin=(1.0, 2.0, -3.0),
        x_axis=(1.0, 0.0, 0.0),
        y_axis=(0.0, 1.0, 0.0),
        x_fov=1.0,
        y_fov=1.0,
    )
    views = list(spin_views(start, 4))
    assert len(views) == 4
    # quarter turn: x -> z, z -> -x; origin fixed
    np.testing.assert_allclose(views[1].x_axis, (0.0, 0.0, 1.0), atol=1e-12)
    np.testing.assert_allclose(views[1].camera_direction, (-1.0, 0.0, 0.0), atol=1e-12)
    for v in views:
        assert v.camera_origin == start.camera_origin

    bbox_min, bbox_max = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)
    radius = 2.0 * np.linalg.norm(np.asarray(bbox_max) - np.asarray(bbox_min))
    for v in orbit_views(6, bbox_min, bbox_max, distance=2.0):
        o = np.asarray(v.camera_origin)
        d = np.asarray(v.camera_direction)
        x = np.asarray(v.x_axis)
        y = np.asarray(v.y_axis)
        np.testing.assert_allclose(np.linalg.norm(o), radius, rtol=1e-6)
        # looking at the center
        np.testing.assert_allclose(o + radius * d, 0.0, atol=1e-6)
        # orthonormal frame
        for a, b in ((x, y), (x, d), (y, d)):
            assert abs(np.dot(a, b)) < 1e-9


def test_plot_log_cli(tmp_path):
    """plot_log parses `step k=v` lines and saves a figure headlessly."""
    pytest.importorskip("matplotlib")
    from learn_nerf_tpu.scripts import plot_log

    log = tmp_path / "train.log"
    log.write_text(
        "\n".join(
            f"step {i}: coarse={1.0/(i+1):.4f} fine={0.5/(i+1):.4f}"
            for i in range(20)
        )
    )
    out = str(tmp_path / "plot.png")
    plot_log.main(["--field", "fine", "--smoothing", "2", "--output", out, str(log)])
    assert os.path.getsize(out) > 0


def test_train_lr_schedule_and_ema_flags(tiny_dataset, tmp_path):
    """--lr_schedule cosine + --ema 0.99 train end-to-end through the CLI
    and produce a checkpoint the render CLI consumes unchanged (EMA saves
    the averaged weights under the standard keys)."""
    import pickle

    from learn_nerf_tpu.scripts import render_nerf, train_nerf

    save_path = str(tmp_path / "nerf_sched.pkl")
    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--lr_schedule", "cosine",
            "--ema", "0.99",
            "--occupancy",
            "--occ_candidates", "16",
            "--occ_samples", "8",
            "--occ_grid", "8",
            "--occ_refresh_samples", "2",
            "--occ_freeze_grid_after", "4",
            "--batch_size", "256",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--steps", "6",
            "--save_path", save_path,
            tiny_dataset,
        ]
    )
    with open(save_path, "rb") as f:
        payload = pickle.load(f)
    # Occupancy checkpoints carry a single field model + grid state.
    assert {"fine", "background", "occupancy_densities"} <= set(payload)

    out_png = str(tmp_path / "sched.png")
    render_nerf.main(
        [
            "--seed", "0",
            "--batch_size", "128",
            "--occupancy",
            "--occ_candidates", "16",
            "--occ_samples", "8",
            "--occ_grid", "8",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--width", "16",
            "--height", "16",
            "--model_path", save_path,
            os.path.join(tiny_dataset, "metadata.json"),
            os.path.join(tiny_dataset, "0000.json"),
            out_png,
        ]
    )
    from PIL import Image

    assert np.asarray(Image.open(out_png)).shape == (16, 16, 3)

    # cosine without --steps is a usage error, not a silent constant.
    with pytest.raises(SystemExit):
        train_nerf.main(
            [
                "--lr_schedule", "cosine",
                "--batch_size", "64",
                "--save_path", str(tmp_path / "x.pkl"),
                tiny_dataset,
            ]
        )


def test_cosine_pickle_resume_continues_schedule(tiny_dataset, tmp_path, capsys):
    """A params-pickle auto-resume must NOT restart the cosine schedule
    at the peak lr: the CLI peeks the pickle's step counter and offsets
    the schedule (a fresh optimizer's count starts at 0)."""
    from learn_nerf_tpu.scripts import train_nerf

    import pickle

    save_path = str(tmp_path / "resume.pkl")

    def args(steps):
        return [
            "--seed", "0",
            "--lr", "1e-3",
            "--lr_schedule", "cosine",
            "--batch_size", "256",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--steps", str(steps),
            "--save_path", save_path,
            tiny_dataset,
        ]

    train_nerf.main(args(8))
    capsys.readouterr()
    # --steps is the TOTAL decay span: resuming an 8-step checkpoint with
    # --steps 12 trains exactly 4 more steps at the continued lr.
    train_nerf.main(args(12))
    out = capsys.readouterr().out
    assert "cosine schedule resumes at step 8; 4 of 12 total steps" in out
    with open(save_path, "rb") as f:
        assert int(pickle.load(f)["train_host_step"]) == 12
    # Same command again: the budget is already covered -> clean no-op.
    train_nerf.main(args(12))
    out = capsys.readouterr().out
    assert "nothing to do" in out


@pytest.mark.parametrize("occupancy", [False, True])
def test_cosine_full_state_resume_caps_steps(
    tiny_dataset, tmp_path, capsys, occupancy
):
    """--steps is the TOTAL decay span on the FULL-STATE resume path too:
    resuming an 8-step full-state checkpoint with --steps 12 trains 4
    more steps.  No schedule offset here: the
    restored optimizer count drives the schedule natively.  Covers both
    full-state layouts (plain TrainState; occupancy (state, grid) tuple)
    through checkpoint.peek_train_state_step."""
    import pickle

    from learn_nerf_tpu.scripts import train_nerf

    save_path = str(tmp_path / "resume.pkl")
    full_path = str(tmp_path / "resume.state")
    extra = (
        ["--occupancy", "--occ_candidates", "16", "--occ_samples", "8",
         "--occ_grid", "16"]
        if occupancy
        else ["--coarse_samples", "8", "--fine_samples", "8"]
    )

    def args(steps):
        return [
            "--seed", "0",
            "--lr", "1e-3",
            "--lr_schedule", "cosine",
            "--batch_size", "256",
            "--steps", str(steps),
            "--save_path", save_path,
            "--full_state_path", full_path,
            *extra,
            tiny_dataset,
        ]

    train_nerf.main(args(8))
    from learn_nerf_tpu.checkpoint import peek_train_state_step

    assert peek_train_state_step(full_path) == 8
    capsys.readouterr()
    train_nerf.main(args(12))
    out = capsys.readouterr().out
    assert "cosine schedule resumes at step 8; 4 of 12 total steps" in out
    assert peek_train_state_step(full_path) == 12
    with open(save_path, "rb") as f:
        key = "occupancy_host_step" if occupancy else "train_host_step"
        assert int(pickle.load(f)[key]) == 12
    # Same command again: budget covered -> clean no-op.
    train_nerf.main(args(12))
    assert "nothing to do" in capsys.readouterr().out


def test_steps_per_dispatch_hierarchy(tiny_dataset, tmp_path):
    """--steps_per_dispatch works for the dense hierarchy too (it was
    occupancy-only at first); a partial final macro still stops at
    --steps exactly."""
    import pickle

    from learn_nerf_tpu.scripts import train_nerf

    save_path = str(tmp_path / "scan.pkl")
    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-3",
            "--batch_size", "256",
            "--coarse_samples", "8",
            "--fine_samples", "8",
            "--steps", "5",
            "--steps_per_dispatch", "3",
            "--save_path", save_path,
            tiny_dataset,
        ]
    )
    with open(save_path, "rb") as f:
        payload = pickle.load(f)
    assert int(payload["train_host_step"]) == 5
