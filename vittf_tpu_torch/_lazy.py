"""Lazy re-exports for the package's ``__init__`` files.

``vittf_tpu``'s ``__init__`` files import their public names eagerly. The
port's resolve the same names on first access (PEP 562), so that importing
a subpackage imports none of its siblings: no import cycle between them, and
nothing heavier than the module a caller asked for.
"""
from __future__ import annotations

import importlib


def lazy_exports(package: str, modules: dict[str, tuple[str, ...]]):
    """``(__getattr__, __all__)`` for ``package``, where ``modules`` maps a
    module path relative to ``package`` to the names it exports."""
    where = {name: mod for mod, names in modules.items() for name in names}

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{where[name]}"), name)

    return __getattr__, sorted(where)
