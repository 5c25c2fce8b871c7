"""Environment handling (a copy of ``deadtrees_tpu.utils.env``).

``get_env`` raises on unset/empty variables; ``load_envs`` reads a ``.env``
file (python-dotenv isn't a dependency — the KEY=VALUE subset it actually
uses is parsed directly).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union


def get_env(env_name: str) -> str:
    env_value = os.environ.get(env_name)
    if not env_value:
        raise KeyError(f"{env_name} not defined and no default value is present!")
    return env_value


def load_envs(env_file: Optional[Union[str, Path]] = None) -> None:
    env_file = Path(env_file) if env_file else Path(".env")
    if not env_file.exists():
        return
    for line in env_file.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        os.environ.setdefault(key, value)
