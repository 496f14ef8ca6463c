"""Lazy package exports: the subpackages re-export the reference's public
names without importing their modules up front (the modules import across
subpackages, so eager re-exports would form import cycles)."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict[str, str]):
    """``(__getattr__, __dir__)`` for ``package``: each name of ``exports``
    (name -> submodule of ``package``, or a module's full dotted path where
    the name lives in another package) is imported from that module on first
    access."""

    def __getattr__(name: str):
        sub = exports.get(name)
        if sub is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = sub if "." in sub else f"{package}.{sub}"
        return getattr(importlib.import_module(module), name)

    def __dir__():
        return sorted(exports)

    return __getattr__, __dir__
