"""Small helpers for defining JAX pytree dataclasses.

The reference solver (altro-cpp) carries its state in mutable C++ objects
(`ilqr/ilqr.hpp:788-812`, `common/solver_stats.hpp:44`).  This design
instead threads explicit, immutable pytree state through pure functions so the
whole solve can live inside one jitted program and be vmapped over problem
batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import jax

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> Any:
    """A dataclass field treated as pytree metadata (static under jit)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: freeze a dataclass and register it as a JAX pytree.

    Fields declared with :func:`static_field` become aux data (hashable,
    trigger retrace on change); everything else is a traced leaf.
    Instances get a ``replace(**updates)`` method.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def replace(self: _T, **updates: Any) -> _T:
        return dataclasses.replace(self, **updates)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def with_matmul_precision(precision: str):
    """Decorator: trace the wrapped function under
    `jax.default_matmul_precision(precision)`.

    XLA may run f32 matmuls at reduced precision (TF32 on the H100);
    solver math needs full f32 products and accumulation (see
    `SolverOptions.matmul_precision`).
    """

    def deco(fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any):
            with jax.default_matmul_precision(precision):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def tree_select(pred: Any, on_true: _T, on_false: _T) -> _T:
    """Elementwise `jnp.where(pred, a, b)` over matching pytrees."""
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), on_true, on_false
    )
