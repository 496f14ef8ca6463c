"""Lazy package exports: the subpackages re-export the reference's public
names without importing their modules up front (the modules import across
subpackages, so eager re-exports would form import cycles)."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict[str, str]):
    """``(__getattr__, __dir__)`` for ``package``: each name of ``exports``
    (name -> submodule) is imported from its submodule on first access."""

    def __getattr__(name: str):
        sub = exports.get(name)
        if sub is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{sub}"), name)

    def __dir__():
        return sorted(exports)

    return __getattr__, __dir__
