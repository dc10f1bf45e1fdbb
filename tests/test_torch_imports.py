"""Import hygiene of the port: ``accelerate_tpu_torch`` and ``chip_smoke.py``
load neither ``jax`` nor anything of ``accelerate_tpu``, nor the
``safetensors`` package (the GPU machine has none; the port reads and
writes the format itself), at run time or in their source."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "accelerate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "accelerate_tpu", "safetensors")


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    script = (
        "import importlib, json, sys\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.level == 0 and node.module and _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
