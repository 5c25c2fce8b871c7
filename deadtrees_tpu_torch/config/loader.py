"""Hydra-style config composition (defaults tree + CLI overrides).

Counterpart of ``deadtrees_tpu.config.loader`` (a copy: that module holds
no JAX). It reads the repo's ``configs/`` tree as data over PyYAML, with
the subset of Hydra's composition semantics the reference uses:

- a root config with a ``defaults`` list of ``{group: option}`` entries
  (plus ``_self_`` ordering and ``null`` options);
- group configs land under ``cfg[group]`` unless they start with the
  ``# @package _global_`` pragma, in which case they merge at the root
  (the datamodule configs patch ``model.network.classes`` this way);
- CLI overrides: ``group=option`` re-selects a group,
  ``a.b.c=value`` sets a leaf (YAML-parsed), ``+a.b=value`` adds one;
- ``${env:VAR}`` and ``${env:VAR,default}`` interpolation for dataset paths.

Deep-merge rule: later sources win per key (OmegaConf.merge). Nothing is
instantiated from a ``_target_`` key: it stays a string in the dict.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import yaml

_GLOBAL_PRAGMA = re.compile(r"^\s*#\s*@package\s+_global_\s*$", re.MULTILINE)
_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


class ConfigError(ValueError):
    pass


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _interp_env(value: Any) -> Any:
    if isinstance(value, str):
        def sub(m):
            var, default = m.group(1), m.group(2)
            v = os.environ.get(var)
            if v is None or v == "":
                if default is not None:
                    return default
                raise ConfigError(f"Env variable '{var}' not set or empty")
            return v

        return _ENV_RE.sub(sub, value)
    if isinstance(value, dict):
        return {k: _interp_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_interp_env(v) for v in value]
    return value


def _load_yaml(path: Path) -> tuple[Dict, bool]:
    text = path.read_text()
    is_global = bool(_GLOBAL_PRAGMA.search(text))
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"Top level of {path} must be a mapping")
    return data, is_global


def _load_group_file(
    config_dir: Path, group: str, option: str
) -> tuple[Dict, bool, List[tuple[str, str]]]:
    """Load a group config, resolving its own ``defaults``:

    - a plain string entry (``- default``) inherits another option of the
      SAME group (trainer/debug.yaml inherits trainer/default.yaml);
    - ``- override /other_group: option`` re-selects another group (the
      reference's mode/debug.yaml swaps in trainer/debug); returned as
      cross-group directives for the composer to apply.
    """
    path = config_dir / group / f"{option}.yaml"
    data, is_global = _load_yaml(path)
    own_defaults: List = data.pop("defaults", [])
    cross: List[tuple[str, str]] = []
    base: Dict = {}
    base_is_global = is_global
    for entry in own_defaults:
        if isinstance(entry, str) and entry != "_self_":
            name = entry[:-5] if entry.endswith(".yaml") else entry
            b, bg, bc = _load_group_file(config_dir, group, name)
            base = _deep_merge(base, b)
            base_is_global = base_is_global or bg
            cross.extend(bc)
        elif isinstance(entry, dict):
            (k, v), = entry.items()
            k = str(k)
            if k.startswith("override /"):
                cross.append((k[len("override /"):], str(v).removesuffix(".yaml")))
            elif k.startswith("override "):
                continue  # logging-style overrides — no-op
    return _deep_merge(base, data), base_is_global, cross


def _set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def compose(
    config_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Compose the config tree: root defaults → group files → CLI overrides."""
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    root_path = config_dir / f"{config_name}.yaml"
    root, _ = _load_yaml(root_path)
    defaults: List = root.pop("defaults", [])

    # split overrides into group re-selections and value sets
    group_over: Dict[str, Optional[str]] = {}
    value_over: List[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"Override '{ov}' must be key=value")
        key, raw = ov.split("=", 1)
        add = key.startswith("+")
        key = key.lstrip("+")
        value = yaml.safe_load(raw)
        if (
            not add
            and "." not in key
            and isinstance(value, (str, type(None)))
            and (config_dir / key).is_dir()
        ):
            group_over[key] = value
        else:
            value_over.append((key, value))

    cfg: Dict[str, Any] = {}
    self_merged = False
    seen_groups = set()
    for entry in defaults:
        if entry == "_self_":
            cfg = _deep_merge(cfg, root)
            self_merged = True
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"Bad defaults entry: {entry!r}")
        (group, option), = entry.items()
        group = str(group)
        if group.startswith("override "):
            continue  # hydra-internal (logging) overrides — no-op here
        optional = False
        if group.startswith("optional "):
            optional = True
            group = group.split(" ", 1)[1]
        seen_groups.add(group)
        option = group_over.get(group, option)
        if option is None:
            continue
        path = config_dir / group / f"{option}.yaml"
        if not path.exists():
            if optional:
                continue
            raise ConfigError(f"Missing config file: {path}")
        data, is_global, cross = _load_group_file(config_dir, group, str(option))
        if is_global:
            cfg = _deep_merge(cfg, data)
        else:
            cfg = _deep_merge(cfg, {group: data})
        # cross-group "override /X: opt" directives, unless the CLI already
        # re-selected that group (CLI wins)
        for xgroup, xopt in cross:
            if xgroup in group_over:
                continue
            xdata, xglobal, _ = _load_group_file(config_dir, xgroup, xopt)
            cfg = _deep_merge(cfg, xdata if xglobal else {xgroup: xdata})

    if not self_merged:
        cfg = _deep_merge(cfg, root)

    # group overrides naming groups absent from defaults
    for group, option in group_over.items():
        if group in seen_groups or option is None:
            continue
        path = config_dir / group / f"{option}.yaml"
        if not path.exists():
            raise ConfigError(f"Missing config file: {path}")
        data, is_global = _load_yaml(path)
        cfg = _deep_merge(cfg, data if is_global else {group: data})

    for key, value in value_over:
        _set_dotted(cfg, key, value)

    return _interp_env(cfg)


def to_yaml(cfg: Dict[str, Any]) -> str:
    return yaml.safe_dump(cfg, sort_keys=False, default_flow_style=False)


def print_config(cfg: Dict[str, Any], save_path: Optional[Path] = None) -> None:
    """Pretty tree print (reference utils/utils.py:77-116 rich tree)."""
    try:
        from rich.syntax import Syntax
        from rich.tree import Tree
        import rich

        tree = Tree("CONFIG")
        for k, v in cfg.items():
            branch = tree.add(k)
            branch.add(
                Syntax(
                    yaml.safe_dump(v) if isinstance(v, dict) else str(v),
                    "yaml",
                )
            )
        rich.print(tree)
    except ImportError:
        print(to_yaml(cfg))
    if save_path is not None:
        Path(save_path).write_text(to_yaml(cfg))
