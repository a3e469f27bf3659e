"""Name -> class registries with a ``_name`` discriminator.

The port's copy of ``one_peace_tpu/core/registry.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``).

Mirrors the capability of fairseq's ``registry.setup_registry``
(ref: fairseq/fairseq/registry.py:14-62) without the metaprogramming:
a registry is a dict plus a decorator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Type


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Type], Type]:
        def deco(cls: Type) -> Type:
            if name in self._entries:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._entries[name] = cls
            cls.registry_name = name
            return cls

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)


TASKS = Registry("task")
MODELS = Registry("model")
CRITERIONS = Registry("criterion")
OPTIMIZERS = Registry("optimizer")
LR_SCHEDULERS = Registry("lr_scheduler")


def load_user_module(path: str) -> None:
    """Import a user plugin directory/file so its @register decorators run
    (the ``--user-dir`` mechanism, ref one_peace/user_module/__init__.py +
    fairseq's import_user_module)."""
    import importlib.util
    import os
    import sys

    path = os.path.abspath(path)
    if os.path.isdir(path):
        init = os.path.join(path, "__init__.py")
        name = os.path.basename(path)
        spec = importlib.util.spec_from_file_location(name, init)
    else:
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load user module from {path!r}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
