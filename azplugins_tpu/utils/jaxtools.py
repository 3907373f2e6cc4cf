"""Small JAX utilities shared across the framework.

Design notes: every piece of simulation state is an immutable
pytree dataclass so the whole timestep can be traced once by ``jax.jit``
and live entirely in device memory. (Replaces the reference's mutable C++
``ParticleData``/``GPUArray`` store, /root/reference: hoomd substrate used at
src/TwoStepLangevinFlow.h:113-126.)
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax
import jax.numpy as jnp

T = TypeVar("T")

__all__ = ["pytree_dataclass", "field", "static_field", "asarray_f", "asarray_i"]

_STATIC_MARK = "__az_static__"


def field(**kwargs):
    """A regular (traced, array-valued) dataclass field."""
    return dataclasses.field(**kwargs)


def static_field(**kwargs):
    """A static (hashable, non-traced) dataclass field."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata[_STATIC_MARK] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[T]) -> type[T]:
    """Decorator: frozen dataclass registered as a JAX pytree.

    Fields declared with :func:`static_field` become aux (hashable) data;
    everything else is a traced child. Instances get a ``replace`` method.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get(_STATIC_MARK, False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)

    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls


def asarray_f(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype=dtype)


def asarray_i(x, dtype=jnp.int32):
    return jnp.asarray(x, dtype=dtype)
