"""The in-repo module system (learn_nerf_tpu.nn): parameter-tree names,
binding rules, dtypes, hashing and thread safety."""

import os
import threading

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _bbox(tag):
    g = np.load(os.path.join(GOLDEN, f"{tag}_reference_outputs.npz"))
    return dict(bbox_min=tuple(g["bbox_min"].tolist()),
                bbox_max=tuple(g["bbox_max"].tolist()))


def _golden_model(tag):
    from learn_nerf_tpu.models import (
        InstantNGPModel,
        InstantNGPRefNeRFModel,
        RefNeRFModel,
    )

    if tag == "ngp":
        return InstantNGPModel(table_sizes=[2**12] * 3, grid_sizes=[4, 8, 64],
                               **_bbox(tag))
    if tag == "refnerf":
        return RefNeRFModel(sh_degree=4, input_layers=2, mid_layers=2,
                            hidden_dim=32, color_layer_dim=16)
    return InstantNGPRefNeRFModel(sh_degree=4, table_sizes=[2**10] * 3,
                                  grid_sizes=[4, 8, 32], hidden_dim=32,
                                  **_bbox(tag))


def _layout(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("tag", ["ngp", "refnerf", "ngp_refnerf"])
def test_init_layout_matches_reference_checkpoint(tag):
    """init() names and shapes every parameter exactly as the saved
    checkpoints do (Dense_i/kernel|bias, HashGridEncoding_0/table_i)."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.checkpoint import load_params_pickle

    model = _golden_model(tag)
    x = jnp.zeros((2, 3))
    # Shapes only: eval_shape traces init without computing anything.
    params = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, x))["params"]
    saved = load_params_pickle(
        os.path.join(GOLDEN, f"{tag}_reference_checkpoint.pkl"))["fine"]
    assert _layout(params) == _layout(saved)


def test_apply_with_missing_parameter_raises():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel

    model = NeRFModel(hidden_dim=8, color_layer_dim=8, input_layers=1,
                      mid_layers=1)
    x = jnp.zeros((2, 3))
    params = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, x))["params"]
    del params["Dense_1"]
    with pytest.raises(KeyError, match="Dense_1/kernel"):
        jax.eval_shape(lambda p: model.apply({"params": p}, x, x), params)


def test_unbound_module_call_raises():
    import jax.numpy as jnp

    from learn_nerf_tpu import nn

    with pytest.raises(RuntimeError, match="not bound"):
        nn.Dense(3)(jnp.zeros((1, 2)))


def test_dense_compute_dtype_and_param_dtype():
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu import nn

    layer = nn.Dense(4, dtype=jnp.bfloat16)
    x = jnp.ones((3, 5))
    params = layer.init(jax.random.PRNGKey(1), x)["params"]
    assert params["kernel"].dtype == jnp.float32
    assert params["kernel"].shape == (5, 4) and params["bias"].shape == (4,)
    y = layer.apply({"params": params}, x)
    assert y.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(y, np.float32),
        np.asarray(x @ params["kernel"] + params["bias"]), rtol=2e-2)


def test_modules_hash_by_configuration():
    from learn_nerf_tpu.models import NeRFModel

    a, b = NeRFModel(hidden_dim=8), NeRFModel(hidden_dim=8)
    assert a == b and hash(a) == hash(b)
    assert a != NeRFModel(hidden_dim=16)


def test_threads_trace_independently():
    """Binding state is per thread: concurrent init() calls build the same
    tree as a lone one."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.models import NeRFModel

    model = NeRFModel(hidden_dim=8, color_layer_dim=8, input_layers=2,
                      mid_layers=2)
    x = jnp.zeros((2, 3))

    def layout():
        return _layout(jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0), x, x))["params"])

    want = layout()
    got, errors = [], []

    def work():
        try:
            for _ in range(5):
                got.append(layout())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(got) == 20
    assert all(g == want for g in got)


def test_load_train_state_rejects_shape_mismatch(tmp_path):
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.checkpoint import load_train_state, save_train_state

    path = str(tmp_path / "state.npz")
    save_train_state(path, {"w": jnp.zeros((2, 3)), "step": jnp.asarray(4)})
    restored = load_train_state(path, {"w": jnp.ones((2, 3)), "step": jnp.asarray(0)})
    assert int(restored["step"]) == 4
    with pytest.raises(ValueError, match="shape"):
        load_train_state(path, {"w": jnp.ones((3, 3)), "step": jnp.asarray(0)})
    with pytest.raises(KeyError, match="no leaf"):
        load_train_state(path, {"v": jnp.ones((2, 3)), "step": jnp.asarray(0)})
