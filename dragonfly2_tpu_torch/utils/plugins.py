"""Plugin loader for evaluator / searcher / source overrides.

Port of dragonfly2_tpu/utils/plugins.py, whole: one plugin file serves both packages.

Capability parity with internal/dfplugin/dfplugin.go:43-81, which
plugin.Open()s `d7y-<type>-plugin-<name>.so` from the plugin dir and pulls
a `DragonflyPluginInit` symbol. Python equivalent: import
`df_<type>_plugin_<name>.py` from the plugin dir (or any importable module
path) and call its `dragonfly_plugin_init(options) -> object`. Same
attribute contract, no .so machinery.
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import sys
from typing import Any

PLUGIN_INIT = "dragonfly_plugin_init"

# Mirrors dfplugin's PluginType enum (resource/scheduler/manager).
PLUGIN_TYPES = ("evaluator", "searcher", "source", "resource")


def plugin_module_name(plugin_type: str, name: str) -> str:
    if plugin_type not in PLUGIN_TYPES:
        raise ValueError(f"unknown plugin type {plugin_type!r}")
    return f"df_{plugin_type}_plugin_{name}"


def load(plugin_dir: str | pathlib.Path, plugin_type: str, name: str, options: dict | None = None) -> Any:
    """Load a plugin from `<plugin_dir>/df_<type>_plugin_<name>.py`, falling
    back to an installed module of the same name."""
    module_name = plugin_module_name(plugin_type, name)
    path = pathlib.Path(plugin_dir) / f"{module_name}.py"
    if path.exists():
        spec = importlib.util.spec_from_file_location(module_name, path)
        assert spec is not None and spec.loader is not None
        module = importlib.util.module_from_spec(spec)
        # Registered before exec so plugin-defined classes are picklable /
        # re-importable (importlib contract).
        sys.modules[module_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            sys.modules.pop(module_name, None)
            raise
    else:
        try:
            module = importlib.import_module(module_name)
        except ModuleNotFoundError:
            raise FileNotFoundError(
                f"plugin {module_name} not found in {plugin_dir} or on sys.path"
            ) from None
    init = getattr(module, PLUGIN_INIT, None)
    if init is None:
        raise AttributeError(f"plugin {module_name} lacks {PLUGIN_INIT}()")
    return init(options or {})
