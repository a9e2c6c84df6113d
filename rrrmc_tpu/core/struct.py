"""Pytree dataclass helpers.

Every model and sampler-state object in rrrmc_tpu is an immutable frozen
dataclass registered as a JAX pytree: array fields are traced leaves, fields
marked `static()` are hashable compile-time metadata (sizes, layouts, scales).
This is the functional replacement for the reference's mutable Julia structs
with type-level parameters (e.g. /root/reference/src/graphs/RE.jl:28 bakes
M, gamma, beta into the type; here they are static dataclass fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax


def static(default: Any = dataclasses.MISSING, **kw):
    """Declare a dataclass field as static (compile-time) pytree metadata."""
    if default is not dataclasses.MISSING:
        kw.setdefault("default", default)
    return dataclasses.field(metadata={"static": True}, **kw)


def pytree(cls):
    """Class decorator: frozen dataclass registered as a JAX pytree node."""
    cls = dataclasses.dataclass(frozen=True, repr=False)(cls)
    fields = dataclasses.fields(cls)
    data_fields = [f.name for f in fields if not f.metadata.get("static")]
    meta_fields = [f.name for f in fields if f.metadata.get("static")]
    cls = jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def _repr(self):
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                parts.append(f"{f.name}=<{v.dtype}{list(v.shape)}>")
            else:
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    cls.__repr__ = _repr

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    cls.replace = replace
    return cls
