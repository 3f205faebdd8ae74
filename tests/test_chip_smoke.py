"""chip_smoke.py's phases at tiny sizes on the CPU, plus its gate, its
last line and its helpers.  The script itself measures the card only:
``main`` refuses the CPU."""

import json
import os

import numpy as np
import pytest

import chip_smoke as cs

TINY = cs.Sizes(
    views=6, resolution=16, train_steps=60, batch=64, candidates=16,
    samples=8, dense_steps=2, coarse_samples=4, fine_samples=4, frame=16,
    tile=64, bake=24, bake_pack=4, serve_sizes=(16, 8, 16),
    cross_batch_per_device=16, cross_frame=16, cross_tile=16,
)


def small_ngp():
    # The flagship structure at 2 levels of 2^10 rows: the phases take the
    # model as an argument so the CPU rehearsal compiles quickly.
    return cs.ngp_model(levels=2, table_size=2**10)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Scene + the train phase (flagship occupancy config, then the dense
    NGP hierarchy and vanilla NeRF), shared by the later phases."""
    work = str(tmp_path_factory.mktemp("smoke"))
    data_dir = cs.make_scene(os.path.join(work, "scene"), 0, TINY)
    ckpt = cs.train_phase(data_dir, work, 0, TINY)
    return work, data_dir, ckpt


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_cpu(argv, capsys):
    """No phase runs on the CPU: the gate exits before the first one."""
    with pytest.raises(SystemExit, match="no GPU found"):
        cs.main(argv)
    out = capsys.readouterr().out
    assert '"ok"' not in out and "== phase" not in out


@pytest.mark.parametrize("count", [1, 4])
def test_ok_line_is_exact(count):
    device = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=count,
                  extra="ignored")
    line = cs.ok_line(device)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )
    assert json.loads(line)["device"]["count"] == count


@pytest.mark.parametrize("argv,phases", [
    ([], ["environment", "dataset", "train", "render", "serve",
          "correctness", "memory"]),
    (["--chips", "4"], ["environment", "cross_device"]),
])
def test_chips_option_selects_phases(argv, phases):
    args = cs.parse_args(argv)
    assert cs.phases_for(args.chips) == phases


def test_chips_option_rejects_other_counts():
    with pytest.raises(SystemExit):
        cs.parse_args(["--chips", "2"])


@pytest.mark.parametrize("got,ok", [
    ([1.0, 2.0 + 1.9e-4], True),     # inside atol + rtol * |want|
    ([1.0, 2.0 + 2.2e-4], False),    # just outside
    ([1.0, np.nan], False),          # non-finite never passes
])
def test_assert_close_tolerance(got, ok):
    want = [1.0, 2.0]
    if ok:
        assert cs.assert_close("x", got, want, rtol=1e-4, atol=0.0) <= 1.0
    else:
        with pytest.raises(AssertionError):
            cs.assert_close("x", got, want, rtol=1e-4, atol=0.0)
    # Ungated comparisons report instead of raising (finite inputs).
    if np.all(np.isfinite(got)):
        cs.assert_close("x", got, want, rtol=1e-4, atol=0.0, gate=False)


def test_environment_line_names_everything():
    gpus = "NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 400.00 W"
    line = cs.environment_line("/cache", gpus)
    assert "\n" not in line
    for part in ("device_kind=", "count=", "NVIDIA H100 80GB HBM3, 400.00 W;",
                 "jax=", "jaxlib=", "flax=", "PIL=", "XLA_FLAGS=",
                 "compile_cache='/cache'"):
        assert part in line


def test_train_log_gate():
    log = "loading...\nstep 0: fine=0.4 grad_norm=1.0\nstep 1: fine=0.1 grad_norm=0.5\n"
    records = cs.parse_train_log(log)
    assert [r["fine"] for r in records] == [0.4, 0.1]
    cs.check_train_log(records, max_ratio=0.5)
    with pytest.raises(AssertionError, match="above"):
        cs.check_train_log(records, max_ratio=0.2)
    with pytest.raises(AssertionError, match="non-finite"):
        cs.check_train_log(cs.parse_train_log("step 0: fine=nan\n"), None)


def test_train_phase_tiny(trained):
    work, _, ckpt = trained
    for name in ("flagship.pkl", "ngp_dense.pkl", "vanilla.pkl"):
        assert os.path.exists(os.path.join(work, name))
    assert ckpt == os.path.join(work, "flagship.pkl")


def test_render_phase_tiny(trained):
    work, data_dir, ckpt = trained
    # 60 tiny steps cannot reach the card run's 20 dB; the structure
    # (live + baked PNGs, shapes, PSNR gates) is what is rehearsed here.
    cs.render_phase(ckpt, data_dir, work, 0, TINY, min_psnr_truth=8.0,
                    min_psnr_baked=20.0)
    assert os.path.exists(os.path.join(work, "baked.png"))


def test_serve_phase_tiny(trained, capsys):
    _, data_dir, ckpt = trained
    cs.serve_phase(ckpt, data_dir, 0, TINY)
    out = capsys.readouterr().out
    assert out.count("HTTP 200") == 3


def test_golden_phase_on_cpu():
    import jax

    with jax.default_matmul_precision("highest"):
        cs.golden_phase(jax.devices("cpu")[0], gate=True)


@pytest.mark.gpu
def test_golden_phase_on_gpu(gpu_devices):
    """On the card: the golden fixtures at the parity tests' tolerances
    under ``highest`` precision."""
    import jax

    with jax.default_matmul_precision("highest"):
        cs.golden_phase(gpu_devices[0], gate=True)


def test_step_vs_reference_device(trained):
    import jax

    _, data_dir, _ = trained
    cpu = jax.devices("cpu")
    with jax.default_matmul_precision("highest"):
        loop, batch = cs.step_vs_cpu(cpu[1], cpu[0], data_dir, 0, TINY,
                                     gate=True, model=small_ngp())
    assert loop.mesh.devices.flat[0] == cpu[1]
    assert batch.shape == (TINY.batch, 3, 3)


def test_cross_device_phase_on_4_virtual_devices(capsys):
    import jax

    cs.cross_device_phase(jax.devices("cpu")[:4], 0, TINY, model=small_ngp())
    out = capsys.readouterr().out
    assert "dp4_vs_1.loss" in out and "frame_sharded4_vs_1" in out
