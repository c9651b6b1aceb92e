"""Dotted-path config overrides.

``apply_overrides(cfg, ["model.num_layers=2", "precision.policy=fp32"])``
returns a new config with those fields replaced, each value coerced to
the field's annotated type (``none`` / ``null`` for an Optional field).
Unknown paths and values that do not parse raise.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Union


def _coerce(raw: str, typ: Any) -> Any:
    if typing.get_origin(typ) is Union:  # Optional[X]: "none" / "null"
        if raw.lower() in ("none", "null"):
            return None
        (inner,) = [a for a in typing.get_args(typ) if a is not type(None)]
        return _coerce(raw, inner)
    if typ is bool:
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse {raw!r} as bool")
    if typ in (int, float, str):
        return typ(raw)
    raise TypeError(f"unsupported config field type {typ} for value {raw!r}")


def _set_path(cfg: Any, parts: list[str], raw: str) -> Any:
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(
            f"cannot descend into non-dataclass {type(cfg)} at {parts}"
        )
    head, rest = parts[0], parts[1:]
    names = [f.name for f in dataclasses.fields(cfg)]
    if head not in names:
        raise KeyError(
            f"{type(cfg).__name__} has no field {head!r} (fields: {names})"
        )
    if rest:
        child = _set_path(getattr(cfg, head), rest, raw)
        return dataclasses.replace(cfg, **{head: child})
    typ = typing.get_type_hints(type(cfg))[head]
    return dataclasses.replace(cfg, **{head: _coerce(raw, typ)})


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``"a.b.c=value"`` overrides, returning a new config."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(
                f"override {ov!r} must look like path.to.field=value"
            )
        path, raw = ov.split("=", 1)
        cfg = _set_path(
            cfg, path.strip().lstrip("-").split("."), raw.strip()
        )
    return cfg
