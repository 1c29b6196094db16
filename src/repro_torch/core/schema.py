# Copy of src/repro/core/schema.py, kept numpy-only; change both copies together.
"""Arrow-like schema model.

A :class:`Schema` is an ordered list of :class:`Field`\\ s. Types cover the
fixed-width numerics plus variable-length ``utf8``/``binary`` (which carry an
int32 offsets buffer, exactly like Arrow's layout). This is the metadata that
rides the *control plane* in Thallus — it is tiny and is shipped via RPC,
never via the bulk data path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

# Fixed-width value types -> numpy dtype.
_FIXED: dict[str, np.dtype] = {
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "uint8": np.dtype(np.uint8),
    "uint16": np.dtype(np.uint16),
    "uint32": np.dtype(np.uint32),
    "uint64": np.dtype(np.uint64),
    "float16": np.dtype(np.float16),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "bool": np.dtype(np.bool_),
}
_VARLEN = ("utf8", "binary")


def is_varlen(type_name: str) -> bool:
    return type_name in _VARLEN


def numpy_dtype(type_name: str) -> np.dtype:
    """numpy dtype of the *values* buffer for a type."""
    if type_name in _FIXED:
        return _FIXED[type_name]
    if type_name in _VARLEN:
        return np.dtype(np.uint8)  # raw bytes
    raise ValueError(f"unknown type: {type_name!r}")


def valid_types() -> tuple[str, ...]:
    return tuple(_FIXED) + _VARLEN


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: str
    nullable: bool = True

    def __post_init__(self) -> None:
        if self.type not in _FIXED and self.type not in _VARLEN:
            raise ValueError(f"unknown field type: {self.type!r}")

    @property
    def varlen(self) -> bool:
        return is_varlen(self.type)

    @property
    def value_dtype(self) -> np.dtype:
        return numpy_dtype(self.type)

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.type, "nullable": self.nullable}

    @staticmethod
    def from_dict(d: dict) -> "Field":
        return Field(d["name"], d["type"], d.get("nullable", True))


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __post_init__(self) -> None:
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names: {names}")

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self.fields)

    def __getitem__(self, key: int | str) -> Field:
        if isinstance(key, int):
            return self.fields[key]
        for f in self.fields:
            if f.name == key:
                return f
        raise KeyError(key)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple(self[n] for n in names))

    def to_dict(self) -> dict:
        return {"fields": [f.to_dict() for f in self.fields]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema(tuple(Field.from_dict(f) for f in d["fields"]))


def schema(*pairs: tuple[str, str]) -> Schema:
    """Convenience: ``schema(("a","int64"), ("b","utf8"))``."""
    return Schema(tuple(Field(n, t) for n, t in pairs))
