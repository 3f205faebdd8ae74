"""bench.py helpers: roofline accounting against XLA cost analysis."""

import numpy as np
import pytest

H100 = "NVIDIA H100 80GB HBM3"


def test_step_roofline_reports_cost():
    """step_roofline extracts FLOPs/bytes from the compiled hot step and
    reports roofline numbers against a peak-table entry (the CPU backend's
    cost analysis stands in for the card's; only the arithmetic is
    checked here)."""
    import jax

    import bench
    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    loop = TrainLoop(
        NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
        NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-3,
        coarse_ts=4,
        fine_ts=4,
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
    )
    rng = np.random.RandomState(0)
    batch = np.stack(
        [
            rng.randn(32, 3).astype(np.float32),
            rng.randn(32, 3).astype(np.float32),
            rng.rand(32, 3).astype(np.float32),
        ],
        axis=1,
    )
    out = bench.step_roofline(loop, batch, step_seconds=0.01, device_kind=H100)
    assert out["tflops"] >= 0
    assert 0 <= out["mfu"] <= 1
    assert out["bound"] in ("compute", "memory")


def test_roofline_math():
    from learn_nerf_tpu.utils.flops import roofline

    # A tenth of the H100's TF32 peak, a twentieth of its bandwidth.
    out = roofline(dict(flops=4.95e12, bytes=1.675e10), 0.1, H100, "tf32")
    assert out["tflops"] == 49.5
    assert out["mfu"] == 0.1
    assert out["gbps"] == 167.5
    assert out["bw_util"] == 0.05
    assert out["bound"] == "compute"
    assert roofline(None, 0.1, H100) == {}
    out2 = roofline(dict(flops=1.0, bytes=3.35e12), 1.0, H100)
    assert out2["bound"] == "memory"
    # The bf16 peak is the divisor when the matmuls run in bf16.
    out3 = roofline(dict(flops=9.89e12, bytes=1.0), 0.1, H100, "bf16")
    assert out3["mfu"] == 0.1


@pytest.mark.parametrize("precision,peak", [
    ("bf16", 989e12), ("tf32", 495e12), ("fp32", 67e12),
])
def test_peak_table_h100_entry(precision, peak):
    """The H100 SXM entry carries the data sheet's dense rates."""
    from learn_nerf_tpu.utils.flops import device_peaks

    peaks = device_peaks(H100)
    assert peaks[precision] == peak
    assert peaks["bytes_per_sec"] == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_device_raises(kind):
    """A device missing from the table is an error, never a default —
    also when roofline() is asked with no cost at all."""
    from learn_nerf_tpu.utils.flops import device_peaks, roofline

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        roofline(None, 0.1, kind)


def test_bench_frame_smoke():
    """bench_frame (the north-star 800x800 inference submetric) composes
    bake + span selection + block-word gathers + pooled tiles into one
    timed frame; pinned here at a tiny CPU config so the driver-run bench
    cannot be the first place the composition executes."""
    import bench

    out = bench.bench_frame(
        size=16, reps=1, bake_resolution=24, pack=2, grid_resolution=16,
        candidates=16, samples=8, span_candidates=8, block_gather_stride=2,
        tile=64,
    )
    assert out["seconds_per_frame"] > 0
    assert out["rays_per_sec"] > 0
    assert "baked 24^3" in out["config"]


def test_pooled_bench_grid_freeze_invariant():
    """bench_pooled freezes its synthetic grid (update_interval past the
    run, _host_step=1): the loop-level invariant is that no refresh fires,
    so the hand-planted densities survive every step — otherwise the
    bench's documented '~10/ray demand' workload silently doubles."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import OccupancyTrainLoop

    model = NeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    loop = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(0),
        lr=1e-3,
        bbox_min=(-1, -1, -1),
        bbox_max=(1, 1, 1),
        candidates=16,
        samples=4,
        grid_resolution=8,
        update_interval=16,
        pool_budget_per_ray="auto",
        pool_start_step=0,
    )
    rng = np.random.RandomState(3)
    planted = (rng.rand(8**3) < 0.05).astype(np.float32)
    loop.grid_state = loop.grid_state.replace(
        densities=jnp.asarray(planted),
        step=jnp.asarray(loop.grid.warmup_updates, jnp.int32),
    )
    import bench

    bench.freeze_pooled_grid(loop)  # the exact mechanism bench_pooled uses

    batch = np.stack(
        [rng.randn(32, 3), rng.randn(32, 3), rng.rand(32, 3) * 2 - 1], axis=1
    ).astype(np.float32)
    batch[:, 1] /= np.linalg.norm(batch[:, 1], axis=-1, keepdims=True)
    for _ in range(20):
        loop.step_auto(jax.random.PRNGKey(7), batch)
    np.testing.assert_array_equal(np.asarray(loop.grid_state.densities), planted)


def test_run_bounded_timeout_and_success():
    """_run_bounded: a hang degrades to an error dict (the round-4 frame
    bench destroyed four computed submetrics by hanging the whole
    process); a fast fn passes through; an exception re-raises."""
    import time

    import pytest

    import bench

    assert bench._run_bounded(lambda: 42, 5.0) == 42
    out = bench._run_bounded(lambda: time.sleep(30), 0.2)
    assert "error" in out and "timed out" in out["error"]

    def boom():
        raise ValueError("nope")

    with pytest.raises(ValueError):
        bench._run_bounded(boom, 5.0)


def test_emit_incremental_and_error_tolerant(capsys):
    """_emit prints a parseable headline after every submetric, skips
    errored submetrics in the priority chain, emits a well-formed zero
    line when nothing usable exists yet, and names the device on every
    line."""
    import json

    import bench

    device = dict(platform="gpu", kind=H100, count=1)
    gpu = "NVIDIA H100 80GB HBM3, 700.00 W"

    def last_line():
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    # Nothing usable: still a parseable line (value 0).
    bench._emit({"instant_ngp_occupancy": {"error": "x"}}, device, gpu)
    line = last_line()
    assert line["value"] == 0 and "submetrics" in line
    assert line["device"] == device and line["gpu"] == gpu

    # Occupancy lands: it is the headline.
    sub = {"instant_ngp_occupancy": dict(rays_per_sec=17000.0)}
    bench._emit(sub, device, gpu)
    line = last_line()
    assert line["metric"] == "train_rays_per_sec_instant_ngp"
    assert line["value"] == 17000.0
    assert "vs_baseline" not in line

    # A later errored frame bench must not dethrone the good headline.
    sub["frame_800_baked"] = dict(error="timed out after 1500s")
    bench._emit(sub, device, gpu)
    line = last_line()
    assert line["metric"] == "train_rays_per_sec_instant_ngp"
    assert line["submetrics"]["frame_800_baked"]["error"]

    # Frame-only success path.
    bench._emit({"frame_800_baked": dict(rays_per_sec=500000.0)}, device, gpu)
    line = last_line()
    # The frame-only headline carries the rays/s VALUE, so the metric
    # name/unit must say rays/s.
    assert line["metric"] == "frame_rays_per_sec_800px_baked"
    assert "rays/sec" in line["unit"]


def test_bench_main_refuses_cpu(monkeypatch):
    """The bench has no CPU fallback: without a GPU main() exits before
    measuring anything."""
    import bench

    monkeypatch.setenv("BENCH_MODE", "occupancy")
    with pytest.raises(SystemExit, match="no GPU found"):
        bench.main()


def test_jaxpr_matmul_flops_exact():
    """The analytic fallback counts 2*M*N*K per dot_general exactly —
    value step, grad step (3 matmuls per layer), and scan bodies
    multiplied by trip count."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.utils.flops import jaxpr_matmul_flops

    B, K, N = 32, 16, 8
    x = jnp.ones((B, K))
    w = jnp.ones((K, N))

    fwd = jax.make_jaxpr(lambda x, w: x @ w)(x, w)
    assert jaxpr_matmul_flops(fwd) == 2.0 * B * K * N

    # grad wrt w: forward (2BKN) + dx = g @ w.T (2BKN) + dw = x.T @ g
    # (2BKN) when grad wrt both args.
    g = jax.make_jaxpr(
        jax.grad(lambda x, w: (x @ w).sum(), argnums=(0, 1))
    )(x, w)
    assert jaxpr_matmul_flops(g) == 3 * 2.0 * B * K * N

    # scan multiplies the body by its length.
    L = 7

    def scanned(x, w):
        def body(c, _):
            return c @ w, ()

        out, _ = jax.lax.scan(body, x, None, length=L)
        return out

    s = jax.make_jaxpr(scanned)(x, jnp.ones((K, K)))
    assert jaxpr_matmul_flops(s) == L * 2.0 * B * K * K


def test_traced_flops_matches_xla_for_mlp():
    """On the CPU backend (cost analysis available) the analytic matmul
    count must agree with XLA's dot flops: analytic <= XLA total, and
    the MLP is matmul-dominated so not by much."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.utils.flops import lowered_cost, traced_flops

    def mlp(x, w1, w2):
        h = jnp.maximum(x @ w1, 0.0)
        return (h @ w2).sum()

    args = (jnp.ones((64, 32)), jnp.ones((32, 32)), jnp.ones((32, 4)))
    step = jax.jit(jax.grad(mlp, argnums=(1, 2)))
    analytic = traced_flops(step, *args)
    assert analytic is not None and analytic["bytes"] is None
    xla = lowered_cost(step.lower(*args))
    if xla is not None:  # cost analysis present on this backend
        # XLA's count is post-optimization (it may simplify a small dot
        # away); the pre-optimization analytic count can sit a hair
        # above it, never far below.
        assert analytic["flops"] <= xla["flops"] * 1.05
        assert analytic["flops"] >= 0.5 * xla["flops"]


def test_roofline_flops_only_cost():
    """A byte-less (analytic) cost yields the matmul-side roofline keys
    and no bandwidth claims."""
    from learn_nerf_tpu.utils.flops import roofline

    out = roofline(dict(flops=4.95e12, bytes=None, source="jaxpr-matmul"),
                   0.1, H100)
    assert out["tflops"] == 49.5
    assert out["mfu"] == 0.1
    assert out["flops_source"] == "jaxpr-matmul"
    assert "bound" not in out and "gbps" not in out
