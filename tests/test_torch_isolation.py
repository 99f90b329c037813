"""The port stands alone: no module under src/repro_torch/, and neither
chip_smoke.py nor kernel_ab.py, imports JAX or anything of the JAX package
``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*.py")
                    if "_build" not in p.parts) + [ROOT / "chip_smoke.py",
                                                   ROOT / "kernel_ab.py"]
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
               for p in PORT_FILES if p.is_relative_to(ROOT / "src")]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)


def test_every_port_module_is_checked():
    """The rule covers every module of the port, the MoE and Mamba modules,
    the configs of the MoE, hymba, xLSTM and Whisper families, the sharded
    cache, its mesh and the elastic plans, and the training path (step,
    launcher, optimizer, trainer, checkpoints, synthetic data) among them."""
    checked = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES
               if p.is_relative_to(ROOT / "src" / "repro_torch")}
    assert {"models/moe.py", "models/ssm.py", "models/transformer.py",
            "configs/olmoe_1b_7b.py", "configs/phi3_5_moe_42b_a6_6b.py",
            "configs/hymba_1_5b.py", "configs/xlstm_1_3b.py",
            "configs/whisper_medium.py", "serving/engine.py", "core/sharded.py",
            "launch/mesh.py", "launch/elastic.py", "launch/steps.py", "launch/train.py",
            "train/optimizer.py", "train/trainer.py", "train/checkpoint.py",
            "data/synthetic.py"} <= checked
