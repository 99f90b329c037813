"""The port stands alone: no module under src/repro_torch/ and not
chip_smoke.py imports JAX or anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*.py")
                    if "_build" not in p.parts) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_importing_the_port_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               for p in PORT_FILES if p.name != "chip_smoke.py"]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
