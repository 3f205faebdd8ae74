"""Smoke test for tools/measure_baked.py — the baked-vs-live measurement
tool for the flagship frame.  Its measurement path is pinned here on a
tiny CPU config: train a minimal NGP-occupancy checkpoint, then measure
one baked resolution against the live path and parse the report lines.
The tool's own ``main`` measures the card only and refuses the CPU.
"""

import importlib.util
import os
import re

import pytest

from .synthetic_scene import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "measure_baked", os.path.join(REPO, "tools", "measure_baked.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_measure_baked_main_refuses_cpu():
    """No CPU fallback: without a GPU the tool exits before measuring."""
    with pytest.raises(SystemExit, match="no GPU found"):
        _tool().main(["ckpt.pkl", "metadata.json", "view.json"])


def test_measure_baked_cli(tmp_path, capsys):
    scene = str(tmp_path / "scene")
    write_dataset(scene, num_views=4, resolution=16)
    ckpt = str(tmp_path / "ngp.pkl")

    from learn_nerf_tpu.scripts import train_nerf

    train_nerf.main(
        [
            "--seed", "0",
            "--lr", "1e-2",
            "--batch_size", "64",
            "--instant_ngp",
            "--occupancy",
            "--occ_candidates", "16",
            "--occ_samples", "8",
            "--occ_grid", "16",
            "--steps", "2",
            "--save_path", ckpt,
            scene,
        ]
    )

    # The tool's measurement path, through its own argument parser.
    tool = _tool()
    tool.measure(tool.parse_args(
        [
            ckpt,
            os.path.join(scene, "metadata.json"),
            os.path.join(scene, "0000.json"),
            "--size", "16", "--resolutions", "24", "--budget", "8",
            "--candidates", "16", "--samples", "8", "--reps", "1",
            "--pack", "2", "--block_gather", "2",
            # Span flags cover the two round-4 failure modes the plain
            # smoke missed: an undersized probe count for THIS scene's
            # bbox (must auto-raise loudly, not die — the r4 queue items
            # hit exactly that on the compound scene's anisotropic bbox)
            # and a sub-4x4x2 supergrid (16/8 = 2^3) under
            # span_block_gather (must fall back to per-cell probing).
            "--span_candidates", "4", "--span_block_gather", "2",
        ]
    ))
    stdout = capsys.readouterr().out
    assert re.search(r"^span_candidates raised 4 -> \d+", stdout, re.M), stdout
    assert re.search(r"^live: [\d.]+ s/frame", stdout, re.M), stdout
    m = re.search(
        r"^baked_24_p2: PSNR vs live ([\d.]+|inf) dB, speedup", stdout, re.M
    )
    assert m, stdout
    # Float-space PSNR: a near-lossless tiny bake must resolve ABOVE the
    # ~56 dB floor u8 quantization would impose — a threshold below that
    # floor could not catch a regression to u8-space PSNR.
    psnr = float(m.group(1))
    assert psnr > 60.0, stdout
