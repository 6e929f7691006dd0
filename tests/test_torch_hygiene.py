"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
needs no reader the serving machine lacks, runs on the card unless told
otherwise, and keeps its build output out of git."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ebfi_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ebfi_tpu", "h5py", "yaml", "cv2"}


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = set(imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ebfi_tpu', 'h5py', 'yaml', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import ebfi_tpu_torch, ebfi_tpu_torch.models, ebfi_tpu_torch.infer\n"
        "import ebfi_tpu_torch.ops.cuda, chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ebfi_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_engine_needs_a_card_unless_told_cpu(monkeypatch):
    from ebfi_tpu_torch.infer import InferenceEngine
    from ebfi_tpu_torch.models import EVFIAutoEx

    model = EVFIAutoEx(8, 8, 8, 2, step=1, channels=(4, 4, 4, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    assert InferenceEngine(model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, where):
    """With no card visible, from the repo or from a directory holding only
    the script, chip_smoke exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_gitignore_lists_the_build_directory():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "ebfi_tpu_torch/_build/" in lines
    from ebfi_tpu_torch.ops.cuda import build

    assert build.BUILD_DIR == PORT / "_build"
