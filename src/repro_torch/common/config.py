"""Config base: frozen dataclasses with dict round-trip (twin of
``repro/common/config.py``; the port keeps its own copy so it never imports
the JAX package)."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar

T = TypeVar("T", bound="ConfigBase")


@dataclasses.dataclass(frozen=True)
class ConfigBase:
    """Frozen dataclass with dict/json round-trip and `replace`."""

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, ConfigBase):
                return v.to_dict()
            if isinstance(v, tuple):
                return [conv(x) for x in v]
            return v

        return {f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls: Type[T], d: dict) -> T:
        """Unknown keys are skipped; nested sub-config dicts are rebuilt."""
        kwargs = {}
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ft = hints.get(f.name)
            if isinstance(ft, type) and issubclass(ft, ConfigBase) and isinstance(v, dict):
                v = ft.from_dict(v)
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)
