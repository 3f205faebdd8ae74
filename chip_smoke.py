"""Smoke run of the main path on one GPU: train, render and serve through
the normal entry points at the reference widths, then check the results
against the plain reference on the card.

Everything runs in ONE process (a second JAX process on the same card
fails for want of memory): the train and render CLIs are called through
their ``main(argv)``, the render service runs in a thread and is driven
over HTTP with ``urllib``.  Phases, in order:

0. device gate and environment line (no GPU -> exit non-zero);
1. a PNG+JSON cube scene from ``--seed`` (24 views, 400x400);
2. 640 steps of the flagship Instant-NGP occupancy config (16 levels x
   2^18 rows x 2 features, hidden 64, batch 4096, 192 candidates -> 32
   samples, pooled after step 512), then 8 steps each of the dense NGP
   hierarchy and of vanilla NeRF at its default widths;
3. one 800x800 frame rendered live and one baked (384^3, pack 4);
4. three ``POST /render`` requests of two sizes;
5. the golden fixtures and one full-width train step compared with the
   plain reference: GPU vs the CPU backend of the same process, under
   ``highest`` matmul precision (gated) and at XLA's default precision
   (printed only);
6. the train step's compiled memory analysis and the peak device memory.

A failing phase raises: the script then exits non-zero without the last
line.  The last line is one JSON object naming the device.

``--chips 4`` runs only the cross-device path (data-parallel train step
and sharded occupancy frame on 4 cards) and its comparison with 1 card.

Usage:
    python chip_smoke.py [--seed 0] [--chips 1|4] [--workdir DIR]
"""

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

#: Live inference config of the render CLI (README quick start).
LIVE_RENDER_FLAGS = [
    "--instant_ngp", "--occupancy",
    "--occ_budget_per_ray", "auto", "--occ_t_eps", "1e-2",
]
#: Learning rate of the smoke's training runs (the verify recipe's).
LR = 2e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size the phases use; :data:`FULL` is the card's run."""

    views: int = 24
    resolution: int = 400
    train_steps: int = 640
    batch: int = 4096
    candidates: int = 192
    samples: int = 32
    dense_steps: int = 8
    coarse_samples: int = 64
    fine_samples: int = 128
    frame: int = 800
    tile: int = 8192
    bake: int = 384
    bake_pack: int = 4
    serve_sizes: Sequence[int] = (800, 400, 800)
    # Cross-device phase: global batch = per_device * devices; the frame's
    # ray count is a multiple of devices * tile, so 1 and N devices split
    # it into the same tiles (and the same per-tile keys).
    cross_batch_per_device: int = 4096
    cross_frame: int = 800
    cross_tile: int = 6400


FULL = Sizes()


def ok_line(device: Dict) -> str:
    """The run's last line: ``{"ok": true, "device": {...}}``."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": device["count"],
            },
        }
    )


def phases_for(chips: int) -> List[str]:
    """Names of the phases a run with ``--chips`` executes, in order."""
    if chips == 4:
        return ["environment", "cross_device"]
    return [
        "environment", "dataset", "train", "render", "serve",
        "correctness", "memory",
    ]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: ok, {time.time() - t0:.1f} s wall", flush=True)


def assert_close(name, got, want, rtol, atol, gate=True) -> float:
    """Print ``name``'s max-abs difference and the worst ratio of the
    error to its allowance ``atol + rtol * |want|``; raise when
    ``gate`` and any element exceeds its allowance.  Returns the ratio."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - want)
    ratio = float(np.max(err / (atol + rtol * np.abs(want)))) if err.size else 0.0
    max_abs = float(np.max(err)) if err.size else 0.0
    verdict = "ok" if ratio <= 1.0 else ("FAIL" if gate else "over")
    print(
        f"  {name}: max_abs={max_abs:.3e} worst/allowed={ratio:.3f} "
        f"(rtol={rtol:g}, atol={atol:g}) {verdict}",
        flush=True,
    )
    if gate and ratio > 1.0:
        raise AssertionError(f"{name}: worst error {ratio:.3f}x its allowance")
    return ratio


# ---------------------------------------------------------------- phase 0


def environment_line(cache_dir: str, gpus: str) -> str:
    """Phase 0's line: devices, ``gpus`` (``nvidia-smi``'s name and power
    limit per card), versions, ``XLA_FLAGS`` and the compile cache."""
    import jax
    import jaxlib

    def version(mod):
        try:
            return __import__(mod).__version__
        except ImportError:
            return "absent"

    devices = jax.devices()
    return (
        f"device_kind={devices[0].device_kind!r} count={len(devices)} "
        f"nvidia-smi: {'; '.join(gpus.splitlines())} | "
        f"jax={jax.__version__} jaxlib={jaxlib.__version__} "
        f"flax={version('flax')} PIL={version('PIL')} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache_dir!r}"
    )


# ---------------------------------------------------------------- phase 1


def make_scene(data_dir: str, seed: int, sizes: Sizes) -> str:
    sys.path.insert(0, REPO)
    from tests.synthetic_scene import write_dataset

    write_dataset(data_dir, num_views=sizes.views,
                  resolution=sizes.resolution, seed=seed)
    return data_dir


# ---------------------------------------------------------------- phase 2


def parse_train_log(text: str) -> List[Dict[str, float]]:
    """The ``step i: k=v ...`` lines of a train log as dicts."""
    records = []
    for m in re.finditer(r"^step (\d+): (.*)$", text, re.M):
        rec = {"step": float(m.group(1))}
        for kv in m.group(2).split():
            k, v = kv.split("=", 1)
            rec[k] = float(v)
        records.append(rec)
    return records


def check_train_log(records, max_ratio: Optional[float]) -> None:
    """Every logged value finite; with ``max_ratio``, the last ``fine``
    loss at most that fraction of the first."""
    if not records:
        raise AssertionError("the train CLI logged no steps")
    for rec in records:
        bad = [k for k, v in rec.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} at step {rec['step']:.0f}")
    first, last = records[0]["fine"], records[-1]["fine"]
    print(f"  fine loss {first:.5g} (step 0) -> {last:.5g} "
          f"(step {records[-1]['step']:.0f})", flush=True)
    if max_ratio is not None and not last <= max_ratio * first:
        raise AssertionError(
            f"final fine loss {last:.5g} is above {max_ratio} x the first "
            f"({first:.5g})"
        )


def run_train(data_dir, save_path, seed, steps, batch, flags,
              max_ratio=None) -> List[Dict[str, float]]:
    """``train_nerf.main`` in-process; its log is parsed and gated."""
    from learn_nerf_tpu.scripts import train_nerf

    argv = [
        "--seed", str(seed), "--lr", str(LR), "--batch_size", str(batch),
        "--steps", str(steps), "--save_interval", str(10**9),
        "--save_path", save_path, *flags, data_dir,
    ]
    print(f"  train_nerf {' '.join(argv)}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_nerf.main(argv)
    records = parse_train_log(buf.getvalue())
    for rec in records[:: max(1, len(records) // 8)] + records[-1:]:
        print(f"  step {rec['step']:.0f}: fine={rec['fine']:.5g} "
              f"rays_per_sec={rec.get('rays_per_sec', float('nan')):.5g}",
              flush=True)
    check_train_log(records, max_ratio)
    return records


def train_phase(data_dir, workdir, seed, sizes: Sizes) -> str:
    """The flagship config (scripts/common.py: 16-level NGP with 2^18-row
    tables; bench.py's headline cell), gated on a halved loss; then the
    dense NGP hierarchy and vanilla NeRF, gated on finite losses."""
    ckpt = os.path.join(workdir, "flagship.pkl")
    flagship = [
        "--instant_ngp", "--occupancy",
        "--occ_candidates", str(sizes.candidates),
        "--occ_samples", str(sizes.samples), "--occ_train_budget", "auto",
    ]
    run_train(data_dir, ckpt, seed, sizes.train_steps, sizes.batch, flagship,
              max_ratio=0.5)
    hierarchy = ["--coarse_samples", str(sizes.coarse_samples),
                 "--fine_samples", str(sizes.fine_samples)]
    run_train(data_dir, os.path.join(workdir, "ngp_dense.pkl"), seed,
              sizes.dense_steps, sizes.batch, ["--instant_ngp", *hierarchy])
    run_train(data_dir, os.path.join(workdir, "vanilla.pkl"), seed,
              sizes.dense_steps, sizes.batch, hierarchy)
    return ckpt


# ---------------------------------------------------------------- phase 3


def psnr_u8(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def ground_truth(view_json: str, size: int) -> np.ndarray:
    sys.path.insert(0, REPO)
    from learn_nerf_tpu.data.camera import CameraView
    from tests.synthetic_scene import cube_color

    rays = CameraView.from_json(view_json).bare_rays(size, size)
    return cube_color(rays[:, 0], rays[:, 1]).reshape(size, size, 3)


def read_png(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.shape != (size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{path}: {img.shape} {img.dtype}, want ({size}, {size}, 3) uint8")
    return img


def run_render(ckpt, data_dir, out_png, seed, size, tile, flags) -> np.ndarray:
    from learn_nerf_tpu.scripts import render_nerf

    argv = [
        "--seed", str(seed), "--model_path", ckpt,
        "--width", str(size), "--height", str(size),
        "--batch_size", str(tile), *flags,
        os.path.join(data_dir, "metadata.json"),
        os.path.join(data_dir, "0000.json"), out_png,
    ]
    print(f"  render_nerf {' '.join(argv)}", flush=True)
    t0 = time.time()
    render_nerf.main(argv)
    print(f"  render_nerf: {time.time() - t0:.1f} s including compile", flush=True)
    return read_png(out_png, size)


#: A trained cube renders far above this; a broken path (NaN colors turn
#: into black, garbage or background) falls below it.
MIN_PSNR_VS_TRUTH = 20.0
#: Baking interpolates the trained field on a dense lattice; the baked
#: frame stays within this of the live one or the bake is wrong.
MIN_PSNR_BAKED_VS_LIVE = 30.0


def render_phase(ckpt, data_dir, workdir, seed, sizes: Sizes,
                 min_psnr_truth=MIN_PSNR_VS_TRUTH,
                 min_psnr_baked=MIN_PSNR_BAKED_VS_LIVE) -> None:
    truth = ground_truth(os.path.join(data_dir, "0000.json"), sizes.frame)
    live = run_render(ckpt, data_dir, os.path.join(workdir, "live.png"),
                      seed, sizes.frame, sizes.tile, LIVE_RENDER_FLAGS)
    baked = run_render(
        ckpt, data_dir, os.path.join(workdir, "baked.png"), seed,
        sizes.frame, sizes.tile,
        [*LIVE_RENDER_FLAGS, "--baked", str(sizes.bake),
         "--baked_pack", str(sizes.bake_pack)],
    )
    live_db, baked_db = psnr_u8(live, truth), psnr_u8(baked, live)
    print(f"  PSNR live vs ground truth: {live_db:.2f} dB; "
          f"baked vs live: {baked_db:.2f} dB", flush=True)
    if live_db < min_psnr_truth:
        raise AssertionError(f"live render {live_db:.2f} dB < {min_psnr_truth}")
    if baked_db < min_psnr_baked:
        raise AssertionError(
            f"baked render {baked_db:.2f} dB < {min_psnr_baked} vs live")


# ---------------------------------------------------------------- phase 4


def serve_phase(ckpt, data_dir, seed, sizes: Sizes) -> None:
    """Start ``serve_nerf.make_server`` on a free port in a thread and
    POST one request per entry of ``sizes.serve_sizes``."""
    from PIL import Image

    from learn_nerf_tpu.scripts import serve_nerf

    args = serve_nerf.argparser().parse_args([
        "--seed", str(seed), "--model_path", ckpt, "--port", "0",
        "--batch_size", str(sizes.tile), *LIVE_RENDER_FLAGS,
        os.path.join(data_dir, "metadata.json"),
    ])
    server = serve_nerf.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        with open(os.path.join(data_dir, "0001.json")) as f:
            view = json.load(f)
        for size in sizes.serve_sizes:
            body = json.dumps(dict(view, width=size, height=size)).encode()
            req = urllib.request.Request(
                f"http://{host}:{port}/render", data=body, method="POST")
            t0 = time.time()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, png = resp.status, resp.read()
            img = np.asarray(Image.open(io.BytesIO(png)))
            print(f"  POST /render {size}x{size}: HTTP {status}, "
                  f"{img.shape} in {time.time() - t0:.2f} s", flush=True)
            if status != 200 or img.shape != (size, size, 3):
                raise AssertionError(f"bad response for {size}x{size}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


# ---------------------------------------------------------------- phase 5


def _golden(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def golden_phase(device, gate: bool) -> None:
    """The golden fixtures on ``device`` at the tolerances of
    ``tests/test_parity.py`` (the current matmul precision applies).

    The tolerances are the CPU parity tests', unchanged: float32 fields
    in another summation order stay within them under ``highest``.  At
    XLA's default precision a float32 matmul may run as TF32 (about three
    decimal digits), which these tolerances are not meant to admit."""
    import pickle

    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.checkpoint import load_params_pickle
    from learn_nerf_tpu.models import (
        InstantNGPModel,
        InstantNGPRefNeRFModel,
        NeRFModel,
        RefNeRFModel,
    )
    from learn_nerf_tpu.render import Renderer

    def put(x):
        return jax.device_put(x, device)

    def field(tag, model):
        g = _golden(f"{tag}_reference_outputs")
        params = put(load_params_pickle(
            os.path.join(GOLDEN, f"{tag}_reference_checkpoint.pkl"))["fine"])
        density, rgb, aux = jax.jit(model.apply)(
            dict(params=params), put(g["x"]), put(g["d"]))
        assert_close(f"{tag}.density", density, g["density"], 1e-5, 1e-6, gate)
        assert_close(f"{tag}.rgb", rgb, g["rgb"], 1e-5, 1e-6, gate)
        for k in ("normal_mse", "neg_normal"):
            if k in g:
                assert_close(f"{tag}.{k}", aux[k], g[k], 1e-4, 1e-5, gate)

    def bbox(tag):
        g = _golden(f"{tag}_reference_outputs")
        return dict(bbox_min=tuple(g["bbox_min"].tolist()),
                    bbox_max=tuple(g["bbox_max"].tolist()))

    field("ngp", InstantNGPModel(
        table_sizes=[2**12] * 3, grid_sizes=[4, 8, 64], **bbox("ngp")))
    field("refnerf", RefNeRFModel(
        sh_degree=4, input_layers=2, mid_layers=2, hidden_dim=32,
        color_layer_dim=16))
    field("ngp_refnerf", InstantNGPRefNeRFModel(
        sh_degree=4, table_sizes=[2**10] * 3, grid_sizes=[4, 8, 32],
        hidden_dim=32, **bbox("ngp_refnerf")))

    g = _golden("renderer_e2e")
    with open(os.path.join(GOLDEN, "vanilla_params.pkl"), "rb") as f:
        params = put(pickle.load(f))
    renderer = Renderer(
        coarse=NeRFModel(hidden_dim=32, color_layer_dim=16),
        fine=NeRFModel(hidden_dim=48, color_layer_dim=16),
        bbox_min=tuple(g["bbox_min"].tolist()),
        bbox_max=tuple(g["bbox_max"].tolist()),
        coarse_ts=8, fine_ts=12,
    )
    out = jax.jit(renderer.render_rays)(
        put(jax.random.PRNGKey(21)), put(jnp.asarray(g["rays"])),
        params["coarse"], params["fine"], put(jnp.asarray(g["background"])))
    for level, key, want, rtol, atol in (
        ("coarse", "outputs", "coarse_outputs", 1e-4, 1e-5),
        ("coarse", "densities", "coarse_densities", 1e-4, 1e-5),
        ("fine", "densities", "fine_densities", 1e-3, 1e-4),
        ("fine", "outputs", "fine_outputs", 1e-4, 1e-5),
        ("fine", "alphas", "fine_alphas", 1e-4, 1e-5),
        ("fine", "coords", "fine_coords", 1e-4, 1e-4),
    ):
        assert_close(f"renderer_e2e.{level}.{key}", out[level][key], g[want],
                     rtol, atol, gate)


def ngp_model(levels=16, table_size=2**18, bbox=(-0.7, 0.7)):
    """The flagship field at the reference widths (scripts/common.py)."""
    from learn_nerf_tpu.models import InstantNGPModel

    return InstantNGPModel(
        table_sizes=[table_size] * levels,
        grid_sizes=[2 ** (4 + i // 2) for i in range(levels)],
        bbox_min=(bbox[0],) * 3, bbox_max=(bbox[1],) * 3,
    )


def scene_batch(data_dir, n, seed) -> np.ndarray:
    """``n`` random training rays of the scene, as the loader packs them."""
    from learn_nerf_tpu.data.dataset import load_dataset

    views = load_dataset(data_dir).views
    rays = np.concatenate([v.rays() for v in views[:4]])
    idx = np.random.RandomState(seed).choice(len(rays), n, replace=False)
    return rays[idx]


def occupancy_loop(model, devices, seed, candidates, samples, grid):
    import jax

    from learn_nerf_tpu.parallel.mesh import default_mesh
    from learn_nerf_tpu.train import OccupancyTrainLoop

    return OccupancyTrainLoop(
        model, init_rng=jax.random.PRNGKey(seed), lr=LR,
        bbox_min=model.bbox_min, bbox_max=model.bbox_max,
        candidates=candidates, samples=samples, grid_resolution=grid,
        adam_eps=1e-15, adam_b2=0.99, mesh=default_mesh(devices),
    )


def compare_steps(tag, ref_loop, loop, batch, seed, gate: bool) -> None:
    """Copy ``ref_loop``'s state into ``loop``, run one step on each with
    the same batch and key, and compare the logged values and the
    updated parameters.

    Tolerances: the loss and norms are sums over ~10^5 samples taken in
    another order on each side (the table gradient is a scatter-add,
    atomics on a GPU): rtol 1e-4 on the loss, 1e-3 on the norms.  Adam's
    first step moves every parameter with a nonzero gradient by exactly
    ``lr * sign(g)`` (eps 1e-15), so an update can only differ where the
    two sides' gradient has opposite signs, i.e. is summation noise
    around zero: the max-abs difference is at most ``2 * lr``, and at
    most 1% of the parameters may differ by more than ``lr / 2``.
    """
    import jax

    from learn_nerf_tpu.parallel.mesh import replicated_sharding

    # Through fresh host copies: a device_put onto a device the source
    # already lives on may alias its buffers, and each step donates them.
    def copy(tree):
        host = jax.tree_util.tree_map(np.array, jax.device_get(tree))
        return jax.device_put(host, replicated_sharding(loop.mesh))

    loop.state = copy(ref_loop.state)
    loop.grid_state = copy(ref_loop.grid_state)
    key = jax.random.PRNGKey(seed + 1)
    ref_vals = jax.device_get(ref_loop.step(key, batch))
    vals = jax.device_get(loop.step(key, batch))
    assert_close(f"{tag}.loss", vals["fine"], ref_vals["fine"], 1e-4, 0.0, gate)
    for k in ("grad_norm", "param_norm"):
        assert_close(f"{tag}.{k}", vals[k], ref_vals[k], 1e-3, 0.0, gate)
    after_ref = jax.device_get(ref_loop.state.params)
    after = jax.device_get(loop.state.params)
    leaves = jax.tree_util.tree_leaves_with_path
    worst_abs, flipped, total = 0.0, 0, 0
    for (path, a), (_, b) in zip(leaves(after), leaves(after_ref)):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        if "table_" in jax.tree_util.keystr(path):
            worst_abs = max(worst_abs, float(d.max()))
        flipped += int(np.sum(d > LR / 2))
        total += d.size
    frac = flipped / total
    print(f"  {tag}.tables: max_abs={worst_abs:.3e} (bound {2 * LR:g}); "
          f"params whose update differs: {flipped}/{total} = {frac:.2e} "
          f"(bound 1e-2)", flush=True)
    if gate and (worst_abs > 2 * LR * (1 + 1e-3) or frac > 1e-2):
        raise AssertionError(f"{tag}: updated parameters disagree")


def step_vs_cpu(device, cpu, data_dir, seed, sizes: Sizes, gate: bool,
                model=None):
    """One full-width occupancy train step on ``device`` vs the same step
    on ``cpu``.  Returns the device loop (for the memory phase)."""
    model = model if model is not None else ngp_model()
    ref = occupancy_loop(model, [cpu], seed, sizes.candidates, sizes.samples, 128)
    loop = occupancy_loop(model, [device], seed, sizes.candidates, sizes.samples, 128)
    batch = scene_batch(data_dir, sizes.batch, seed)
    compare_steps("step_vs_cpu", ref, loop, batch, seed, gate)
    return loop, batch


def correctness_phase(data_dir, seed, sizes: Sizes, device, cpu, model=None):
    import jax

    results = {}
    for precision, gate in (("highest", True), ("default", False)):
        print(f"  -- matmul precision {precision} ({'gated' if gate else 'printed only'})",
              flush=True)
        ctx = (jax.default_matmul_precision("highest") if precision == "highest"
               else contextlib.nullcontext())
        with ctx:
            golden_phase(device, gate)
            results[precision] = step_vs_cpu(
                device, cpu, data_dir, seed, sizes, gate, model)
    return results["highest"]


# ---------------------------------------------------------------- phase 6


def memory_phase(loop, batch) -> None:
    import jax

    key = jax.random.PRNGKey(0)
    lowered = loop._auto_step_fn.lower(
        loop.state, key, loop.shard_batch(batch), loop.grid_state)
    print(f"  train step memory_analysis: {lowered.compile().memory_analysis()}",
          flush=True)
    stats = loop.mesh.devices.flat[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}",
          flush=True)


# ------------------------------------------------------- cross-device path


def cross_device_phase(devices, seed, sizes: Sizes, model=None) -> None:
    """Data-parallel train step and sharded occupancy frame on all
    ``devices`` vs the same work on the first one, under ``highest``."""
    import functools

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from bench import shell_grid_state
    from learn_nerf_tpu.occ_render import render_frame_occupancy
    from learn_nerf_tpu.parallel.mesh import default_mesh
    from tests.synthetic_scene import orbit_views

    n = len(devices)
    model = model if model is not None else ngp_model()
    with jax.default_matmul_precision("highest"):
        one = occupancy_loop(model, devices[:1], seed, sizes.candidates,
                             sizes.samples, 128)
        many = occupancy_loop(model, devices, seed, sizes.candidates,
                              sizes.samples, 128)
        rng = np.random.RandomState(seed)
        m = sizes.cross_batch_per_device * n
        origins = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
        dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
        colors = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        batch = np.stack([origins, dirs, colors], axis=1)
        print(f"  train step: global batch {m} on {n} devices vs 1", flush=True)
        compare_steps(f"dp{n}_vs_1", one, many, batch, seed, gate=True)

        size = sizes.cross_frame
        if (size * size) % (n * sizes.cross_tile):
            raise ValueError("cross_frame^2 must be a multiple of devices * cross_tile")
        rays = jnp.asarray(orbit_views(1)[0].bare_rays(size, size))
        grid_state = shell_grid_state(one.grid)
        params = jax.device_get(one.state.params)
        outs = []
        for mesh in (None, default_mesh(devices)):
            frame = jax.jit(functools.partial(
                render_frame_occupancy, one.renderer,
                tile_size=sizes.cross_tile, mesh=mesh))
            with jax.default_device(devices[0]):
                t0 = time.time()
                out = frame(jax.random.PRNGKey(seed), rays, params["fine"],
                            jnp.zeros(3), grid_state)["outputs"]
                out = np.asarray(jax.block_until_ready(out))
            print(f"  frame {size}x{size} on {1 if mesh is None else n} "
                  f"device(s): {time.time() - t0:.2f} s including compile",
                  flush=True)
            outs.append(out)
        # The same per-tile program, compiled alone vs inside shard_map,
        # may fuse and order its sums differently; colors are O(1).
        assert_close(f"frame_sharded{n}_vs_1", outs[1], outs[0], 0.0, 1e-4)


# ------------------------------------------------------------------- main


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: only the cross-device path and its 1-card comparison")
    p.add_argument("--workdir", default=None,
                   help="scene and checkpoints (default: a temporary directory)")
    return p.parse_args(argv)


def run(args, sizes: Sizes, devices, cpu) -> None:
    """Every phase of ``phases_for(args.chips)`` after the gate."""
    with contextlib.ExitStack() as stack:
        workdir = args.workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_"))
        names = phases_for(args.chips)
        if "cross_device" in names:
            with phase("cross_device"):
                cross_device_phase(devices[: args.chips], args.seed, sizes)
            return
        data_dir = os.path.join(workdir, "scene")
        with phase("dataset"):
            make_scene(data_dir, args.seed, sizes)
        with phase("train"):
            ckpt = train_phase(data_dir, workdir, args.seed, sizes)
        with phase("render"):
            render_phase(ckpt, data_dir, workdir, args.seed, sizes)
        with phase("serve"):
            serve_phase(ckpt, data_dir, args.seed, sizes)
        with phase("correctness"):
            loop, batch = correctness_phase(
                data_dir, args.seed, sizes, devices[0], cpu)
        with phase("memory"):
            memory_phase(loop, batch)


def main(argv=None) -> None:
    args = parse_args(argv)
    from learn_nerf_tpu.utils.device import (
        device_summary,
        gpu_name_and_power_limit,
        require_gpu,
        use_compile_cache,
    )

    cache_dir = use_compile_cache()
    cache_state = ("warm" if os.path.isdir(cache_dir) and os.listdir(cache_dir)
                   else "cold")
    import jax

    devices = require_gpu()
    if len(devices) < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} GPUs, "
                         f"found {len(devices)}")
    with phase("environment"):
        line = environment_line(cache_dir, gpu_name_and_power_limit())
        print(f"  {line} cache_at_start={cache_state}", flush=True)
    run(args, FULL, devices, jax.devices("cpu")[0])
    print(ok_line(device_summary()), flush=True)


if __name__ == "__main__":
    main()
