"""SoA container code generator.

The reference generates its C++ SphereSOA container — one aligned buffer split
into per-property columns — from a property list, via a template generator
(reference: soa_generator/soa_generator.py:11-260, configured per step by
src/*/soa_generator_config.py). The generated container is the backbone of its
AoS→SoA optimization steps.

This is the JAX counterpart: from a column spec it emits a Python module
containing
  * a frozen dataclass registered as a JAX pytree — columns are device arrays,
    so the container flows through jit/vmap/grad/shard_map as data,
  * a host-side mutable Builder with the reference container's add/reserve/
    remove/copy surface (soa_sphere.h:22-63), finalized by padding the column
    length to a lane multiple (the analog of the reference's 32-byte column
    alignment + SIMD_WIDTH placeholder padding, soa_sphere.cpp:47-52 and
    rayweek1.cpp:575-576).

Run the spec module (e.g. tools/soa_spheres_spec.py) to regenerate; generated
files are checked in so the package has no build step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    dtype: str = "float32"        # jnp dtype name
    default: float = 0.0          # value used for placeholder padding rows


@dataclasses.dataclass(frozen=True)
class SoaSpec:
    class_name: str               # e.g. "SphereSOA"
    columns: List[Column]
    # Pad row count up to a multiple of this (keeps column shapes in a few buckets).
    pad_multiple: int = 128
    # Column whose padding default marks a row as placeholder.
    mask_col: Optional[str] = None
    doc: str = ""


_HEADER = '''"""{class_name}: generated SoA container. DO NOT EDIT BY HAND.

Generated by tools/soa_codegen.py from {spec_module}.
{doc}
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

'''

_CLASS_TMPL = '''
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class {class_name}:
    """Structure-of-arrays container; every column is a length-N device array.

    Rows whose `{mask_col}` equals its placeholder default ({mask_default!r})
    are padding ("placeholder spheres" in the reference, rayweek1.cpp:575-576)
    and must be masked out by consumers.
    """

{fields}

    @property
    def count(self) -> int:
        """Padded row count (a static Python int under jit)."""
        return self.{first_col}.shape[0]

    def astype(self, dtype) -> "{class_name}":
        """Cast all float columns to `dtype` (int columns untouched)."""
        kw = {{}}
{astype_body}
        return dataclasses.replace(self, **kw)


class {class_name}Builder:
    """Host-side mutable builder mirroring the reference container's mutation
    surface (add/reserve/remove/copy, soa_sphere.h:22-63). `finalize()` pads
    to a multiple of {pad_multiple} rows and returns the frozen pytree."""

    __slots__ = ({slot_names},)

    def __init__(self):
{init_body}

    def reserve(self, n: int) -> None:
        """No-op capacity hint (reference grows 1+2*cap, soa_sphere.cpp:90;
        Python lists manage capacity themselves)."""

    @property
    def count(self) -> int:
        return len(self.{first_col})

    def add(self, {add_params}) -> int:
        """Append one row; returns its index."""
{add_body}
        return len(self.{first_col}) - 1

    def remove(self, index: int) -> None:
        """Remove row by swapping in the last row (reference semantics,
        soa_sphere.cpp:108-121)."""
        last = len(self.{first_col}) - 1
{remove_body}

    def copy_from(self, other: "{class_name}Builder") -> None:
{copy_body}

    def finalize(self, pad_multiple: int = {pad_multiple}) -> {class_name}:
        n = len(self.{first_col})
        padded = n if n % pad_multiple == 0 else (n // pad_multiple + 1) * pad_multiple
        pad = padded - n
        return {class_name}(
{finalize_body}
        )
'''


def generate(spec: SoaSpec, spec_module: str) -> str:
    cols = spec.columns
    first = cols[0].name
    mask = next((c for c in cols if c.name == spec.mask_col), cols[0])
    fields = "\n".join(f"    {c.name}: jax.Array" for c in cols)
    astype_body = "\n".join(
        f'        kw["{c.name}"] = self.{c.name}.astype(dtype)'
        for c in cols if c.dtype.startswith("float")
    ) or "        pass"
    slot_names = ", ".join(f'"{c.name}"' for c in cols)
    init_body = "\n".join(f"        self.{c.name} = []" for c in cols)
    add_params = ", ".join(f"{c.name}: float" for c in cols)
    add_body = "\n".join(f"        self.{c.name}.append({c.name})" for c in cols)
    remove_body = "\n".join(
        f"        self.{c.name}[index] = self.{c.name}[last]; self.{c.name}.pop()"
        for c in cols
    )
    copy_body = "\n".join(f"        self.{c.name} = list(other.{c.name})" for c in cols)
    finalize_body = "\n".join(
        f"            {c.name}=jnp.asarray(np.asarray(self.{c.name} + [{c.default!r}] * pad, "
        f"dtype=np.{c.dtype})),"
        for c in cols
    )
    header = _HEADER.format(class_name=spec.class_name, spec_module=spec_module,
                            doc=spec.doc)
    body = _CLASS_TMPL.format(
        class_name=spec.class_name,
        fields=fields,
        astype_body=astype_body,
        slot_names=slot_names,
        init_body=init_body,
        add_params=add_params,
        add_body=add_body,
        remove_body=remove_body,
        copy_body=copy_body,
        finalize_body=finalize_body,
        first_col=first,
        mask_col=mask.name,
        mask_default=mask.default,
        pad_multiple=spec.pad_multiple,
    )
    return header + body


def write(spec: SoaSpec, spec_module: str, path: str) -> None:
    src = generate(spec, spec_module)
    with open(path, "w") as f:
        f.write(src)
    print(f"wrote {path} ({len(src.splitlines())} lines)")
