"""Hierarchical configuration: dataclass configs ↔ YAML/JSON files.

The reference has only per-CLI argparse with hardcoded paths (SURVEY.md §5
"no hierarchical config"). Here every stage's config is a (frozen)
dataclass; this module loads/saves them from YAML or JSON with nested
dataclass support, so pipelines are reproducible from one file:

    cfg = load_config("experiment.yaml", PipelineConfig)
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, get_args, get_origin


def _coerce(value: Any, typ: Any) -> Any:
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    origin = get_origin(typ)
    if origin is tuple and isinstance(value, (list, tuple)):
        args = get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(value)
    if origin in (list,) and isinstance(value, tuple):
        return list(value)
    return value


def from_dict(cls, data: dict):
    """Build a (possibly nested) dataclass from a plain dict."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field '{key}'")
        kwargs[key] = _coerce(value, _resolve_type(cls, fields[key]))
    return cls(**kwargs)


def _resolve_type(cls, field):
    # dataclass field types may be strings under `from __future__ annotations`
    t = field.type
    if isinstance(t, str):
        import typing

        hints = typing.get_type_hints(cls)
        t = hints.get(field.name, Any)
    return t


def to_dict(cfg) -> dict:
    """Dataclass → JSON-serializable dict (tuples become lists)."""

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return {
                f.name: conv(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            }
        if isinstance(obj, (list, tuple)):
            return [conv(v) for v in obj]
        return obj

    return conv(cfg)


def load_config(path: str | Path, cls):
    path = Path(path)
    with open(path) as f:
        if path.suffix in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(f)
        else:
            data = json.load(f)
    return from_dict(cls, data or {})


def save_config(path: str | Path, cfg) -> Path:
    path = Path(path)
    data = to_dict(cfg)
    with open(path, "w") as f:
        if path.suffix in (".yaml", ".yml"):
            import yaml

            yaml.safe_dump(data, f)
        else:
            json.dump(data, f, indent=2)
    return path
