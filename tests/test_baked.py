"""Baked inference representation tests (learn_nerf_tpu.baked).

The bake sweeps the trained NGP spatial stack onto a dense lattice; at
lattice vertices trilinear interpolation is exact, so the baked field
must reproduce the live model there up to storage-dtype rounding — that
equality also pins the color-head param mapping.  Off-lattice fidelity
is resolution-dependent and is validated end-to-end on the card
(chip_smoke.py's baked-vs-live frame); here we assert it is close for a
smooth field.
"""

import numpy as np
import pytest


def _tiny_ngp(seed=0, density_dim=4, hidden=8):
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import InstantNGPModel

    model = InstantNGPModel(
        table_sizes=[256] * 4,
        grid_sizes=[4, 4, 8, 8],
        bbox_min=(-1.0, -1.0, -1.0),
        bbox_max=(1.0, 1.0, 1.0),
        hidden_dim=hidden,
        density_dim=density_dim,
    )
    params = model.init(
        dict(params=jax.random.PRNGKey(seed)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    return model, params


def _random_dirs(n, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_bake_exact_at_lattice_vertices():
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import bake_instant_ngp

    model, params = _tiny_ngp()
    r = 9
    baked, baked_params = bake_instant_ngp(
        model, params, r, dtype=jnp.float32, verbose=False
    )
    # Tile-aligned physical storage: 128-lane rows, S = 128 // width
    # logical rows per physical row, tail zero-padded (see
    # BakedInstantNGP's layout note).
    from learn_nerf_tpu.baked import physical_rows_per_row

    s = physical_rows_per_row(4)
    assert baked_params["grid"].shape == (-(-(r**3) // s), s * 4)

    # All lattice vertices, random view directions.
    ax = np.linspace(-1.0, 1.0, r).astype(np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    dirs = _random_dirs(pts.shape[0], seed=3)

    ref_density, ref_color, _ = model.apply(
        dict(params=params), jnp.asarray(pts), jnp.asarray(dirs)
    )
    baked_density, baked_color, _ = baked.apply(
        dict(params=baked_params), jnp.asarray(pts), jnp.asarray(dirs)
    )
    np.testing.assert_allclose(
        np.asarray(baked_density), np.asarray(ref_density), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(baked_color), np.asarray(ref_color), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("pack", [2, 4, 8])
def test_packed_grid_bitwise_identical(pack):
    """Corner packing trades memory for gather count only: every packed
    variant must produce BIT-identical outputs to pack=1 (same corner
    order, same interpolation arithmetic) at pack-x the grid rows' width."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import bake_instant_ngp

    model, params = _tiny_ngp()
    r = 9
    base, base_params = bake_instant_ngp(
        model, params, r, dtype=jnp.float32, verbose=False
    )
    packed, packed_params = bake_instant_ngp(
        model, params, r, dtype=jnp.float32, pack=pack, verbose=False
    )
    from learn_nerf_tpu.baked import physical_rows_per_row

    # Segmented format: S from density_dim alone; each of the pack
    # corner-shift segments is its own tile-aligned lane block.
    s = physical_rows_per_row(4)
    assert packed_params["grid"].shape == (-(-(r**3) // s), pack * s * 4)

    rng = np.random.RandomState(7)
    pts = (rng.rand(257, 3).astype(np.float32) * 2.0 - 1.0) * 0.999
    dirs = _random_dirs(pts.shape[0], seed=11)
    d0, c0, _ = base.apply(
        dict(params=base_params), jnp.asarray(pts), jnp.asarray(dirs)
    )
    d1, c1, _ = packed.apply(
        dict(params=packed_params), jnp.asarray(pts), jnp.asarray(dirs)
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))


def test_bake_close_off_lattice_and_bf16():
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import bake_instant_ngp

    model, params = _tiny_ngp(seed=1)
    rng = np.random.RandomState(0)
    pts = (rng.rand(512, 3).astype(np.float32) * 2 - 1) * 0.95
    dirs = _random_dirs(512, seed=1)
    ref_density, ref_color, _ = model.apply(
        dict(params=params), jnp.asarray(pts), jnp.asarray(dirs)
    )

    # Fine lattice: the random-init field is smooth (finest hash level 8),
    # so a 65^3 bake interpolates it closely everywhere.
    baked, bp = bake_instant_ngp(model, params, 65, dtype=jnp.float32, verbose=False)
    d65, c65, _ = baked.apply(dict(params=bp), jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(
        np.asarray(d65), np.asarray(ref_density), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(c65), np.asarray(ref_color), rtol=0.0, atol=5e-3
    )

    # bf16 storage: same field at ~3 significant digits.
    baked16, bp16 = bake_instant_ngp(model, params, 65, verbose=False)
    assert bp16["grid"].dtype == jnp.bfloat16
    d16, c16, _ = baked16.apply(dict(params=bp16), jnp.asarray(pts), jnp.asarray(dirs))
    assert np.all(np.isfinite(np.asarray(d16)))
    np.testing.assert_allclose(np.asarray(d16), np.asarray(d65), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(np.asarray(c16), np.asarray(c65), atol=3e-2)


def test_bake_rejects_non_ngp():
    import jax

    from learn_nerf_tpu.baked import bake_instant_ngp
    from learn_nerf_tpu.models import NeRFModel

    model = NeRFModel(hidden_dim=8, color_layer_dim=8, input_layers=1, mid_layers=1)
    with pytest.raises(ValueError):
        bake_instant_ngp(model, {}, 9)


def test_baked_field_through_pooled_frame():
    """The baked model drops into the occupancy frame renderer unchanged
    and reproduces the live model's frame within interpolation error."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.baked import bake_instant_ngp
    from learn_nerf_tpu.occ_render import OccupancyRenderer, render_frame_occupancy

    model, params = _tiny_ngp(seed=2)
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    grid_state = grid.init()
    background = jnp.asarray([0.1, 0.2, -0.3])

    rng = np.random.RandomState(7)
    origins = rng.randn(96, 3).astype(np.float32) * 3
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    rays = jnp.asarray(np.stack([origins, dirs], axis=1))
    key = jax.random.PRNGKey(0)

    def frame(field_model, field_params):
        renderer = OccupancyRenderer(
            model=field_model, grid=grid,
            bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
            candidates=32, samples=16,
        )
        return render_frame_occupancy(
            renderer, key, rays, field_params, background, grid_state,
            tile_size=32, budget_per_ray=16.0,
        )

    live = frame(model, params)
    baked, bp = bake_instant_ngp(model, params, 65, dtype=jnp.float32, verbose=False)
    b = frame(baked, bp)
    assert int(b["dropped"]) == 0
    np.testing.assert_allclose(
        np.asarray(b["outputs"]), np.asarray(live["outputs"]), atol=5e-3
    )

    # Packed variant through the same frame path: bit-identical to the
    # unpacked baked frame (same interpolation, fewer gathers).
    packed, pp = bake_instant_ngp(
        model, params, 65, dtype=jnp.float32, pack=8, verbose=False
    )
    p = frame(packed, pp)
    np.testing.assert_array_equal(
        np.asarray(p["outputs"]), np.asarray(b["outputs"])
    )


def test_render_cli_baked(tmp_path):
    """render_nerf --baked end to end: bake at startup, render a frame."""
    import pickle

    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.scripts import render_nerf

    path = tmp_path / "m.pkl"

    import json

    meta = tmp_path / "metadata.json"
    json.dump(dict(min=[-1.0] * 3, max=[1.0] * 3), open(meta, "w"))
    view = tmp_path / "view.json"
    json.dump(
        dict(
            origin=[0.0, 0.0, 3.0],
            x=[1.0, 0.0, 0.0],
            y=[0.0, 1.0, 0.0],
            z=[0.0, 0.0, -1.0],
            x_fov=0.8,
            y_fov=0.8,
        ),
        open(view, "w"),
    )
    out = tmp_path / "out.png"
    argv = [
        "--seed", "0", "--batch_size", "64", "--width", "16", "--height", "16",
        "--model_path", str(path), "--occupancy",
        "--occ_candidates", "32", "--occ_samples", "16", "--occ_grid", "8",
        "--occ_budget_per_ray", "auto",
        "--baked", "17", "--baked_dtype", "float32", "--baked_pack", "2",
    ]

    # The CLI builds the model from its own factory, so the checkpoint
    # must match create_model's NGP architecture.
    from argparse import Namespace

    from learn_nerf_tpu.data.dataset import ModelMetadata
    from learn_nerf_tpu.scripts.common import create_model

    args = Namespace(instant_ngp=True, ref_nerf=False, bf16=False)
    metadata = ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1))
    coarse_m, fine_m, _ = create_model(args, metadata)
    fine_params = fine_m.init(
        dict(params=jax.random.PRNGKey(0)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    coarse_params = coarse_m.init(
        dict(params=jax.random.PRNGKey(1)), jnp.zeros((1, 3)), jnp.zeros((1, 3))
    )["params"]
    ckpt = dict(
        coarse=coarse_params,
        fine=fine_params,
        background=np.zeros(3, np.float32),
        occupancy_densities=np.full(8**3, 1.0, np.float32),
        occupancy_resolution=np.int32(8),
    )
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)

    render_nerf.main(
        argv + ["--instant_ngp", str(meta), str(view), str(out)]
    )
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 3)


def test_baked_cache_roundtrip(tmp_path, capsys):
    """--baked_cache writes an npz next to the checkpoint and a second
    session reloads it bit-for-bit (incl. the bf16 raw-bits round trip)."""
    import pickle
    from argparse import Namespace

    import jax
    import jax.numpy as jnp
    import numpy as np

    from learn_nerf_tpu.scripts.common import apply_baking

    model, params = _tiny_ngp(seed=5)
    ckpt_path = tmp_path / "m.pkl"
    with open(ckpt_path, "wb") as f:
        pickle.dump(dict(fine=jax.device_get(params)), f)

    args = Namespace(
        baked=9, baked_dtype="bfloat16", baked_cache=True,
        occupancy=True, model_path=str(ckpt_path),
    )
    baked1, p1 = apply_baking(args, model, dict(fine=params))
    assert "wrote baked grid cache" in capsys.readouterr().out

    baked2, p2 = apply_baking(args, model, dict(fine=params))
    assert "loaded baked grid cache" in capsys.readouterr().out
    assert p2["grid"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(p1["grid"]).view(np.uint16),
        np.asarray(p2["grid"]).view(np.uint16),
    )
    pts = jnp.asarray(np.random.RandomState(0).rand(64, 3).astype(np.float32))
    dirs = jnp.asarray(_random_dirs(64, seed=2))
    d1, c1, _ = baked1.apply(dict(params=p1), pts, dirs)
    d2, c2, _ = baked2.apply(dict(params=p2), pts, dirs)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_physical_layout_roundtrip():
    """to_physical packs S consecutive logical rows per 128-lane physical
    row, zero-padding the tail: flattening back must recover the logical
    table exactly, and non-dividing widths must fall back to identity."""
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import physical_rows_per_row, to_physical

    rng = np.random.RandomState(3)
    for rows, w in [(729, 4), (729, 16), (64, 32), (100, 64), (7, 128)]:
        g = jnp.asarray(rng.randn(rows, w).astype(np.float32))
        s = physical_rows_per_row(w)
        phys = to_physical(g, w)
        assert phys.shape == (-(-rows // s), s * w)
        assert phys.shape[1] == 128 or s == 1
        back = np.asarray(phys).reshape(-1, w)[:rows]
        np.testing.assert_array_equal(back, np.asarray(g))

    # width 24 does not divide 128: layout falls back to one logical row
    # per physical row (no padding, no repack).
    assert physical_rows_per_row(24) == 1
    g = jnp.asarray(rng.randn(11, 24).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(to_physical(g, 24)), np.asarray(g))


def test_bake_in_sweep_physical_path():
    """At production density_dim (16) and even resolutions the sweep
    emits tile-aligned physical rows directly (S | r^2); the result must
    match the live model at lattice vertices exactly, same as the
    fallback path."""
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import (
        bake_instant_ngp,
        _make_sweep,
        physical_rows_per_row,
    )

    model, params = _tiny_ngp(density_dim=16)
    r = 8
    _, physical = _make_sweep(model, r, jnp.float32)
    assert physical  # S=8 divides r^2=64
    baked, bp = bake_instant_ngp(model, params, r, dtype=jnp.float32, verbose=False)
    s = physical_rows_per_row(16)
    assert bp["grid"].shape == (r**3 // s, 128)

    ax = np.linspace(-1.0, 1.0, r).astype(np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    dirs = _random_dirs(pts.shape[0], seed=5)
    ref_d, ref_c, _ = model.apply(
        dict(params=params), jnp.asarray(pts), jnp.asarray(dirs)
    )
    d, c, _ = baked.apply(dict(params=bp), jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(c), np.asarray(ref_c), rtol=1e-4, atol=1e-5)

    # Packed bakes from the physical sweep use the aligned segment-shift
    # builder (_segments_from_physical): still bit-identical to pack 1.
    # pack 8 covers the x-shift's lane-carry path; r == S makes each
    # x-line a single physical row (the carry's clamp-only edge), so
    # also exercise a larger r where the carry crosses physical rows.
    rng = np.random.RandomState(13)
    for rr in (r, 16):
        # OFF-lattice points: every trilinear corner (hence every packed
        # segment) carries nonzero weight, unlike lattice vertices.
        ptsr = (rng.rand(311, 3).astype(np.float32) * 2.0 - 1.0) * 0.999
        dirsr = _random_dirs(ptsr.shape[0], seed=6)
        b1, p1 = bake_instant_ngp(
            model, params, rr, dtype=jnp.float32, verbose=False
        )
        d1, c1, _ = b1.apply(
            dict(params=p1), jnp.asarray(ptsr), jnp.asarray(dirsr)
        )
        for pk in (2, 4, 8):
            bp_, pp_ = bake_instant_ngp(
                model, params, rr, dtype=jnp.float32, pack=pk, verbose=False
            )
            dk, ck, _ = bp_.apply(
                dict(params=pp_), jnp.asarray(ptsr), jnp.asarray(dirsr)
            )
            np.testing.assert_array_equal(np.asarray(d1), np.asarray(dk))
            np.testing.assert_array_equal(np.asarray(c1), np.asarray(ck))
