"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the port. Top-level names are compared whole:
the port's name begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench.harness.env import FORBIDDEN
from port_bench.tests.conftest import REPO


def _modules(prefix):
    base = REPO / "port_bench"
    out = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts or rel.name == "__init__":
            continue
        name = ".".join(rel.parts)
        if name.startswith(prefix):
            out.append(name)
    return out


def _loaded(modules, also=""):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n{also}"
            "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_it_drives_load_no_jax():
    modules = _modules("port_bench")
    assert "port_bench.kinds.train" in modules and "port_bench.control" in modules
    # what a run's set-up imports of the port, beside every harness module
    also = ("import deadtrees_tpu_torch.train.trainer, deadtrees_tpu_torch.infer.sliding\n"
            "import deadtrees_tpu_torch.config\n"
            "from port_bench.harness import spec\n"
            "for m in spec.benchmark()['per_layer'] + spec.benchmark()['end_to_end']:\n"
            "    spec.reader(m['name'])\n")
    loaded = _loaded(modules, also)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "deadtrees_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(_modules("port_bench.reference"))
    assert "deadtrees_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
