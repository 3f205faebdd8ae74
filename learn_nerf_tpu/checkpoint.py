"""Checkpointing.

Two formats:

* the reference's pickle contract — a dict ``{"coarse": params, "fine":
  params, "background": [3]}`` written atomically via tmp+rename
  (``learn_nerf/train.py:62-76``), consumed by every render/mesh CLI,
* a full train-state checkpoint (params + Adam moments + step counter) as
  an ``.npz`` of the flattened state, keyed by each leaf's pytree path,
  fixing the reference's lossy resume (params-only, SURVEY.md section 5).
"""

import io
import os
import pickle
from typing import Any

import jax
import numpy as np


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        # fsync BEFORE the rename: with delayed allocation a crash can
        # persist the rename but not the data blocks, replacing the only
        # good checkpoint with a truncated file.
        os.fsync(f.fileno())
    os.rename(tmp, path)
    # fsync the DIRECTORY too: the rename is a directory-entry update, so
    # a power loss after this function returns could otherwise roll the
    # path back to the previous checkpoint — and a resume would silently
    # replay steps the caller believed were persisted.
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def save_params_pickle(path: str, params: Any) -> None:
    """Save ``{"coarse", "fine", "background"}`` params as a pickle."""
    host_params = jax.device_get(params)
    _atomic_write(path, pickle.dumps(host_params))


def import_reference_params(params: Any) -> Any:
    """Convert a param tree saved by the *reference* implementation.

    Vanilla NeRF and Ref-NeRF trees transfer unchanged (both codebases
    create the Dense layers in the same order, so param names match — the
    golden renderer-parity test proves byte compatibility).  Instant-NGP
    trees need renaming: the reference nests per-level tables as
    ``MultiresHashTableEncoding_i/HashTableEncoding_j/table``
    (``learn_nerf/instant_ngp.py:92-208``) where this framework owns them
    as ``HashGridEncoding_i/table_j``.
    """

    def fix_model(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for key, value in tree.items():
            if key.startswith("MultiresHashTableEncoding_"):
                idx = key.rsplit("_", 1)[1]
                tables = {
                    f"table_{k.rsplit('_', 1)[1]}": v["table"]
                    for k, v in value.items()
                }
                out[f"HashGridEncoding_{idx}"] = tables
            else:
                out[key] = fix_model(value)
        return out

    return fix_model(params)


def _is_reference_tree(params: Any) -> bool:
    def has_marker(tree):
        if not isinstance(tree, dict):
            return False
        return any(
            k.startswith("MultiresHashTableEncoding_") or has_marker(v)
            for k, v in tree.items()
        )

    return has_marker(params)


def load_params_pickle(path: str) -> Any:
    """Load a params pickle; reference-format NGP trees convert on the fly."""
    with open(path, "rb") as f:
        params = pickle.load(f)
    if _is_reference_tree(params):
        params = import_reference_params(params)
    return params


def save_train_state(path: str, state: Any) -> None:
    """Full train state (params + optimizer + step), atomic ``.npz``."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    buf = io.BytesIO()
    np.savez(buf, **{jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    _atomic_write(path, buf.getvalue())


def peek_train_state_step(path: str) -> int:
    """Optimizer step counter from a full-state checkpoint, WITHOUT a
    template (no loop construction needed — the cosine-schedule CLI uses
    this before it knows the remaining step budget).

    Handles both on-disk layouts: ``TrainLoop.save_full`` saves the
    TrainState alone (key ``.step``); the occupancy loop saves a
    ``(state, grid_state)`` tuple (key ``[0].step``) — the grid state has
    its own ``step``, so the tuple case must read element 0.
    """
    with np.load(path) as f:
        key = ".step" if ".step" in f.files else "[0].step"
        return int(f[key])


def load_train_state(path: str, template: Any) -> Any:
    """Restore a full train state into the structure of ``template``.

    Tolerant of the ``ema_params`` field: a checkpoint saved without an
    average loads into an EMA template with the average seeded from the
    checkpointed params (copies, not aliases: the jitted step donates the
    whole state, and aliased leaves would hand XLA the same buffer twice),
    and a checkpoint's average is dropped when the template has none
    (resumed without ``--ema``: the stale average must not leak into eval
    — see ``TrainLoop.eval_params``).
    """
    with np.load(path) as f:
        raw = {k: f[k] for k in f.files}
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for p, leaf in flat:
        key = jax.tree_util.keystr(p)
        if key not in raw and ".ema_params" in key:
            key = key.replace(".ema_params", ".params", 1)
        if key not in raw:
            raise KeyError(f"{path}: checkpoint has no leaf {key}")
        value = raw[key]
        if value.shape != np.shape(leaf):
            raise ValueError(
                f"{path}: leaf {key} has shape {value.shape}, the template "
                f"expects {np.shape(leaf)}"
            )
        leaves.append(np.array(value))
    return jax.tree_util.tree_unflatten(treedef, leaves)
