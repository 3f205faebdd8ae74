"""A minimal module system for the field models.

The models are written in the ``compact`` style: a module's ``__call__``
creates its submodules inline (``Dense(64)(x)``) and its own parameters with
``self.param(name, init_fn)``.  This module supplies just that, with the
parameter-tree layout every checkpoint in the wild uses:

* a submodule is named ``<ClassName>_<i>``, counting per class name in
  creation order within its parent (``Dense_0``, ``Dense_1``,
  ``HashGridEncoding_0``),
* ``Dense`` owns ``kernel`` ``[in, out]`` (LeCun-normal init) and ``bias``
  ``[out]`` (zeros),
* ``init`` returns ``{"params": tree}`` and ``apply({"params": tree}, ...)``
  runs the model on that tree.

Modules are frozen dataclasses, so they hash and compare by
configuration and can be closed over by jitted functions.  Binding state
lives in a per-thread stack, so several threads can trace models at once.
"""

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
softplus = jax.nn.softplus
tanh = jnp.tanh

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "scopes", None)
    if stack is None:
        stack = _local.scopes = []
    return stack


class _Scope:
    """Parameters of one module instance during ``init`` or ``apply``."""

    def __init__(self, params: dict, rng: Optional[jax.Array], path: tuple):
        self.params = params
        self.rng = rng  # None when applying: parameters must already exist
        self.path = path
        self.counters: dict = {}
        self.owner = None

    def child(self, name: str) -> "_Scope":
        if self.rng is not None:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        return _Scope(sub, self.rng, self.path + (name,))

    def param(self, name: str, init_fn: Callable, *args) -> Any:
        if name in self.params:
            return self.params[name]
        if self.rng is None:
            raise KeyError(
                f"parameter {'/'.join(self.path + (name,))} is missing from "
                f"the params tree"
            )
        path = "/".join(self.path + (name,))
        key = jax.random.fold_in(self.rng, zlib.crc32(path.encode()) & 0x7FFFFFFF)
        value = init_fn(key, *args)
        self.params[name] = value
        return value


class Module:
    """Base class: subclasses declare their configuration as annotated
    fields and become frozen dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)

    def __post_init__(self):
        # A module created while another runs is that module's child and
        # takes the next free name for its class; a module created outside
        # any run is a root, bound by init()/apply().
        stack = _stack()
        parent, name = None, None
        if stack:
            parent = stack[-1]
            prefix = type(self).__name__
            index = parent.counters.get(prefix, 0)
            parent.counters[prefix] = index + 1
            name = f"{prefix}_{index}"
        object.__setattr__(self, "_parent", parent)
        object.__setattr__(self, "_name", name)

    def _scope(self) -> _Scope:
        stack = _stack()
        if stack and stack[-1].owner is self:
            return stack[-1]
        raise RuntimeError(
            f"{type(self).__name__}.param() called outside its own "
            f"compact method"
        )

    def param(self, name: str, init_fn: Callable, *args) -> Any:
        return self._scope().param(name, init_fn, *args)

    def _run(self, rng, params, args, kwargs):
        root = _Scope(params, rng, ())
        root.owner = self
        stack = _stack()
        stack.append(root)
        try:
            return type(self).__call__(self, *args, **kwargs)
        finally:
            stack.pop()

    def init(self, rngs, *args, **kwargs) -> dict:
        """Create parameters; ``rngs`` is a key or ``{"params": key}``."""
        rng = rngs["params"] if isinstance(rngs, dict) else rngs
        params: dict = {}
        self._run(rng, params, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, **kwargs):
        """Run the module on ``variables["params"]``."""
        return self._run(None, variables.get("params", {}), args, kwargs)


def compact(fn: Callable) -> Callable:
    """Run ``fn`` in the module's own scope, so submodules it creates and
    parameters it declares are named under this module."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        stack = _stack()
        if stack and stack[-1].owner is self:
            # A root module inside init()/apply(): its scope is pushed.
            return fn(self, *args, **kwargs)
        if self._parent is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                f"init() or apply()"
            )
        scope = self._parent.child(self._name)
        scope.owner = self
        stack.append(scope)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


_lecun_normal = jax.nn.initializers.lecun_normal()


class Dense(Module):
    """``y = x @ kernel + bias``; ``dtype`` sets the compute dtype (the
    parameters stay float32)."""

    features: int
    dtype: Any = None

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param(
            "kernel", _lecun_normal, (x.shape[-1], self.features), jnp.float32
        )
        bias = self.param(
            "bias", jax.nn.initializers.zeros, (self.features,), jnp.float32
        )
        dtype = self.dtype if self.dtype is not None else jnp.result_type(
            x, kernel, bias
        )
        x, kernel, bias = (jnp.asarray(a, dtype) for a in (x, kernel, bias))
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y + bias
