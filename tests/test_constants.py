"""Captured-constants regression gate.

A jitted entry point that CLOSES OVER its params lowers them as jaxpr
constants; the compiled program then ships those bytes to the compiler.
A baked field's grid (gigabytes at 384^3 x pack 4) captured that way
once made compilation hang past every timeout, and a small CPU run
never shows it because small constants are nearly free.

These tests .trace() the ACTUAL jitted programs used by the CLIs and
assert the lowered jaxpr is (almost) constant-free, with a field large
enough (a baked 65^3 grid, ~4 MB f32) that a closure-capture regression
trips the 1 MB budget immediately.
"""

import numpy as np

CONST_BUDGET_BYTES = 1 << 20  # 1 MB: config scalars ok, field tables not


def _consts_bytes(closed_jaxpr):
    """Total bytes of array constants captured by a (closed) jaxpr,
    including constants hoisted into nested pjit/closed-call sub-jaxprs."""
    import jax
    import jax.extend

    seen = 0
    stack = [closed_jaxpr]
    visited = set()
    while stack:
        cj = stack.pop()
        if id(cj) in visited:
            continue
        visited.add(id(cj))
        for c in getattr(cj, "consts", ()):  # ClosedJaxpr
            seen += getattr(c, "nbytes", 0)
        jaxpr = getattr(cj, "jaxpr", cj)
        for eqn in jaxpr.eqns:
            for v in eqn.params.values():
                if isinstance(v, jax.extend.core.ClosedJaxpr):
                    stack.append(v)
                elif isinstance(v, jax.extend.core.Jaxpr):
                    stack.append(v)
    return seen


def _baked_session(budget):
    import jax.numpy as jnp

    from learn_nerf_tpu.acceleration import OccupancyGrid
    from learn_nerf_tpu.baked import bake_instant_ngp
    from learn_nerf_tpu.occ_render import (
        OccupancyFrameSession,
        OccupancyRenderer,
    )
    from tests.test_baked import _tiny_ngp

    model, params = _tiny_ngp(seed=0)
    baked, baked_params = bake_instant_ngp(
        model, params, 65, dtype=jnp.float32, verbose=False
    )
    assert baked_params["grid"].nbytes > 2 * CONST_BUDGET_BYTES, (
        "test field too small to catch a capture regression"
    )
    grid = OccupancyGrid(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1), resolution=8)
    renderer = OccupancyRenderer(
        model=baked, grid=grid,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=32, samples=16,
    )
    return OccupancyFrameSession(
        renderer, baked_params, jnp.zeros(3), grid.init(),
        budget_cfg=budget, tile_size=32,
    )


def _frame_consts(session, budget):
    import jax

    call = session._make_frame(budget)
    rays = jax.numpy.zeros((96, 2, 3))
    traced = call.jitted.trace(
        jax.random.PRNGKey(0), rays,
        session._params, session._background, session._grid_state,
    )
    return _consts_bytes(traced.jaxpr)


def test_frame_session_pooled_constant_free():
    session = _baked_session(16.0)
    assert _frame_consts(session, 16.0) < CONST_BUDGET_BYTES


def test_frame_session_fixed_k_constant_free():
    session = _baked_session(None)
    assert _frame_consts(session, None) < CONST_BUDGET_BYTES


def test_render_session_dense_constant_free():
    """The non-occupancy RenderSession frame program (render_nerf CLI)
    must take coarse/fine params + background as arguments, not consts."""
    import jax

    from learn_nerf_tpu.scripts.render_nerf import RenderSession

    session = _dense_render_session()
    rays = jax.numpy.zeros((64, 2, 3))
    traced = session._render_jit.trace(
        jax.random.PRNGKey(0), rays, *session._render_args
    )
    assert _consts_bytes(traced.jaxpr) < CONST_BUDGET_BYTES


def test_demand_fn_constant_free():
    """make_demand_fn (auto pool sizing) over a BAKED renderer: the grid
    state is an argument; the baked field must not leak in as a const."""
    import jax

    from learn_nerf_tpu.occ_render import make_demand_fn

    session = _baked_session(None)
    fn = make_demand_fn(session.renderer)
    rays = jax.numpy.zeros((96, 2, 3))
    traced = fn.trace(jax.random.PRNGKey(0), rays, session._grid_state)
    assert _consts_bytes(traced.jaxpr) < CONST_BUDGET_BYTES


def test_bake_sweep_constant_free():
    """The bake sweep takes the trained params as an argument."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.baked import _make_sweep
    from tests.test_baked import _tiny_ngp

    model, params = _tiny_ngp(seed=0, hidden=64)
    total = sum(x.nbytes for x in jax.tree_util.tree_leaves(params))
    # Tiny table sizes keep params small; pad the check by asserting the
    # traced consts stay far below even this param tree's size.
    sweep, _ = _make_sweep(model, 33, jnp.float32)
    traced = sweep.trace(params)
    assert _consts_bytes(traced.jaxpr) < min(CONST_BUDGET_BYTES, total)


def test_train_step_auto_constant_free():
    """TrainLoop's hot-loop programs (step_auto + the K-step scan) take
    the full train state as donated ARGUMENTS; an ~8 MB vanilla param
    tree closed over instead would trip this immediately."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.train import TrainLoop

    loop = TrainLoop(
        NeRFModel(), NeRFModel(),
        init_rng=jax.random.PRNGKey(0), lr=1e-3,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        coarse_ts=4, fine_ts=4,
    )
    total = sum(
        x.nbytes for x in jax.tree_util.tree_leaves(loop.state.params)
    )
    assert total > 2 * CONST_BUDGET_BYTES
    batch = jnp.zeros((32, 3, 3))
    key = jax.random.PRNGKey(0)
    for fn, args in (
        (loop._auto_step_fn, (loop.state, key, batch)),
        (loop._scan_step_fn, (loop.state, key, batch[None])),
    ):
        traced = fn.trace(*args)
        assert _consts_bytes(traced.jaxpr) < CONST_BUDGET_BYTES


def test_occ_scan_step_constant_free():
    """OccupancyTrainLoop's K-step scan (the dispatch-amortized hot
    path): state, grid state, and batches are all arguments."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.train import OccupancyTrainLoop
    from tests.test_baked import _tiny_ngp

    model, _ = _tiny_ngp(seed=0, hidden=64)
    loop = OccupancyTrainLoop(
        model,
        init_rng=jax.random.PRNGKey(0), lr=1e-3,
        bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1),
        candidates=16, samples=4, grid_resolution=8, update_interval=4,
    )
    batches = jnp.zeros((2, 32, 3, 3))
    key = jax.random.PRNGKey(0)
    for budget in (None, 4):
        traced = loop._scan_step_fn.trace(
            loop.state, loop.grid_state, budget, key, batches
        )
        assert _consts_bytes(traced.jaxpr) < CONST_BUDGET_BYTES


def _dense_render_session():
    """A RenderSession over a vanilla model big enough (~8 MB params)
    that a closure-capture regression trips the budget."""
    import pickle
    from argparse import Namespace

    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.data.dataset import ModelMetadata
    from learn_nerf_tpu.scripts.common import create_model
    from learn_nerf_tpu.scripts.render_nerf import RenderSession

    import json
    import tempfile

    tmp = tempfile.mkdtemp()
    meta = f"{tmp}/metadata.json"
    json.dump(dict(min=[-1.0] * 3, max=[1.0] * 3), open(meta, "w"))
    args = Namespace(instant_ngp=False, ref_nerf=False, bf16=False)
    metadata = ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1))
    coarse_m, fine_m, _ = create_model(args, metadata)
    z = jnp.zeros((1, 3))
    ckpt = dict(
        coarse=coarse_m.init(dict(params=jax.random.PRNGKey(0)), z, z)["params"],
        fine=fine_m.init(dict(params=jax.random.PRNGKey(1)), z, z)["params"],
        background=np.zeros(3, np.float32),
    )
    total = sum(
        x.nbytes for x in jax.tree_util.tree_leaves((ckpt["coarse"], ckpt["fine"]))
    )
    assert total > 2 * CONST_BUDGET_BYTES
    path = f"{tmp}/m.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.device_get(ckpt), f)
    cli = Namespace(
        seed=0, batch_size=64, width=8, height=8,
        coarse_samples=8, fine_samples=8, model_path=path,
        metadata_json=meta, instant_ngp=False, ref_nerf=False, bf16=False,
        occupancy=False,
    )
    return RenderSession(cli)
