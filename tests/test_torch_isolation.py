"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the ranks' side of the sharded tests
(``tests/_torch_world.py``) imports JAX or the JAX package, and
``chip_smoke.py`` refuses to run where there is no card or no port
beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_world.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    out = _run(["-c", "import sys, repro_torch, repro_torch.kernels, "
                "repro_torch.convert, repro_torch.models, "
                "repro_torch.configs, repro_torch.train, "
                "repro_torch.obs, repro_torch.tune, repro_torch.serve, "
                "repro_torch.streaming, repro_torch.checkpoint, "
                "repro_torch.runtime, repro_torch.optim, "
                "repro_torch.core.distributed; "
                "assert 'jax' not in sys.modules, 'jax imported'; "
                "assert not any(m == 'repro' or m.startswith('repro.') "
                "for m in sys.modules), 'repro imported'; print('ok')"],
               ROOT, {"PYTHONPATH": str(ROOT / "src"),
                      "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card_or_port(tmp_path):
    # no card (the CPU here, or a hidden one): non-zero, no result line
    out = _run([str(ROOT / "chip_smoke.py")], ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory: non-zero, no result line
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
