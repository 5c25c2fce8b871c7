"""The port stands alone: it imports neither JAX nor the JAX package.

``deadtrees_tpu_torch`` shares its name's prefix with ``deadtrees_tpu``,
so every check below tells the two apart by the dotted name.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "deadtrees_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "chex", "orbax", "deadtrees_tpu"}


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


def _port_modules():
    names = []
    for path in PACKAGE.rglob("*.py"):
        parts = path.relative_to(REPO).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def test_forbidden_names_are_told_apart():
    assert _is_forbidden("deadtrees_tpu.ops.fused_mbconv")
    assert _is_forbidden("deadtrees_tpu")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("deadtrees_tpu_torch.ops.fused_mbconv")
    assert not _is_forbidden("jaxtyping")


def test_importing_every_module_loads_no_jax():
    modules = _port_modules()
    assert "deadtrees_tpu_torch.ops.fused_mbconv" in modules
    assert "deadtrees_tpu_torch.serve.server" in modules
    for name in ("core.compile_opts", "infer.blocks", "infer.geotiff", "infer.tiler",
                 "infer.sliding", "infer.export", "models.onnx_io", "models.segformer",
                 "infer.engine", "infer.scene", "geo", "geo.mosaic", "geo.retile",
                 "config", "config.loader", "utils.env", "utils.logging", "visualization",
                 "visualization.helper", "train.entry", "__main__", "parallel",
                 "parallel.mesh", "geo.raster", "geo.shapefile", "serve.ui"):
        assert f"deadtrees_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from deadtrees_tpu_torch.ops import _build\n"
        "from deadtrees_tpu_torch.data import native\n"
        "print(json.dumps({'modules': sorted(sys.modules), 'built': sorted(_build._libs),\n"
        "                  'native': native._lib is not None}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = report["modules"]
    assert set(modules) <= set(loaded)
    assert [m for m in loaded if _is_forbidden(m)] == []
    assert "triton" not in loaded
    assert report["built"] == []  # no kernel is built at import time
    assert not report["native"]  # nor the native shard reader


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py")) + ["chip_smoke.py"]
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "tools").glob("*.py")),
)
def test_no_source_imports_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _is_forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            args = [a.value for a in node.args if isinstance(a, ast.Constant)]
            found += [a for a in args if isinstance(a, str) and _is_forbidden(a)]
    assert found == [], f"{path} imports {found}"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """With no CUDA device, and alone in a directory, the script exits
    non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
            timeout=300,
        )
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout
