"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
needs no reader the serving machine lacks, runs on the card unless told
otherwise, and keeps its build output out of git."""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ebfi_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ebfi_tpu", "h5py", "yaml", "cv2",
             "matplotlib"}


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
        "for m in ('jax', 'jaxlib', 'flax', 'ebfi_tpu', 'h5py', 'yaml', 'cv2', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import ebfi_tpu_torch, ebfi_tpu_torch.models, ebfi_tpu_torch.infer\n"
        "import ebfi_tpu_torch.ops.cuda, chip_smoke\n"
        "import ebfi_tpu_torch.data, ebfi_tpu_torch.data.clip_dataset\n"
        "import ebfi_tpu_torch.data.dataloader, ebfi_tpu_torch.data.synth\n"
        "import ebfi_tpu_torch.infer.cli\n"
        "import ebfi_tpu_torch.utils.vis, ebfi_tpu_torch.utils.logger\n"
        "import ebfi_tpu_torch.utils.metrics, ebfi_tpu_torch.utils.checkpoint\n"
        "import ebfi_tpu_torch.utils.yaml_lite, ebfi_tpu_torch.losses\n"
        "import ebfi_tpu_torch.train, ebfi_tpu_torch.train.cli, ebfi_tpu_torch.train.trainer\n"
        "import ebfi_tpu_torch.train.checkpoint, ebfi_tpu_torch.train.exposure_trainer\n"
        "import ebfi_tpu_torch.parallel, ebfi_tpu_torch.parallel.dist\n"
        "import ebfi_tpu_torch.parallel.spatial\n"
        "import ebfi_tpu_torch.losses.lpips, ebfi_tpu_torch.train.__main__\n"
        "import ebfi_tpu_torch.models.superslomo, ebfi_tpu_torch.models.library\n"
        "import ebfi_tpu_torch.ops.dcn_v2, ebfi_tpu_torch.ops.dcn_modules\n"
        "import ebfi_tpu_torch.data.generate, ebfi_tpu_torch.data.packager\n"
        "import ebfi_tpu_torch.tools.export, ebfi_tpu_torch.utils.flow_vis\n"
        "import ebfi_tpu_torch.utils.profiling, ebfi_tpu_torch.data.legacy_util\n"
        "import ebfi_tpu_torch.data.datalist, ebfi_tpu_torch.data.resize\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ebfi_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def _code_strings(path: Path):
    """String constants of a source other than docstrings: the paths and
    names the code can use."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings:
            yield node.value


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    """No port module names a file or directory of the JAX package: no
    string in its code has ``ebfi_tpu`` as a path component, so nothing is
    read from there.  Docstrings and ``file.py:line`` citations (the
    ``replaces`` field of chip_smoke's kernel line) name the counterparts
    and are let through."""
    bad = [v for v in _code_strings(path)
           if (v == "ebfi_tpu" or re.search(r"(^|[/\\])ebfi_tpu([/\\]|$)", v))
           and not re.search(r"\.py:\d+", v)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_engine_needs_a_card_unless_told_cpu(monkeypatch):
    from ebfi_tpu_torch.infer import InferenceEngine
    from ebfi_tpu_torch.models import EVFIAutoEx

    model = EVFIAutoEx(8, 8, 8, 2, step=1, channels=(4, 4, 4, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    assert InferenceEngine(model, device="cpu").device.type == "cpu"


def test_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """The CLI serves on the card by default; with no card it raises rather
    than run on the CPU."""
    from ebfi_tpu_torch.infer.cli import main
    from ebfi_tpu_torch.models import EVFIAutoEx
    from ebfi_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = {"name": "EVFIAutoEx", "args": {"FrameBasech": 8, "EventBasech": 8, "InterCH": 8,
                                          "TB": 2, "step": 1, "channels": [4, 4, 4, 4]}}
    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, EVFIAutoEx(8, 8, 8, 2, step=1, channels=(4, 4, 4, 4)), {"model": cfg})
    datalist = tmp_path / "list.txt"
    datalist.write_text("")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_path", ckpt, "--data_list", str(datalist),
            "--output_path", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    main(argv + ["--device", "cpu"])  # an empty datalist: only the result files
    assert sorted(os.listdir(tmp_path / "out")) == ["inference_all.yml", "inference_all_step.yml"]


def test_train_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """Training runs on the card by default; with no card it raises rather
    than train on the CPU."""
    from ebfi_tpu_torch.train.cli import main
    from ebfi_tpu_torch.utils.logger import dump_yaml
    from ebfi_tpu_torch.utils.yaml_lite import load_file

    cfg = load_file(str(ROOT / "configs" / "train_evfi.yml"))
    cfg["trainer"]["output_path"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yml"
    path.write_text(dump_yaml(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-c", str(path), "-id", "x"])
    with pytest.raises(FileNotFoundError):  # past the device check: the datalist is a placeholder
        main(["-c", str(path), "-id", "x", "--device", "cpu"])


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
