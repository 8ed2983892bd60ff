"""The port stands alone: no JAX, no kvq_tpu, no heavy host readers at import,
no kernel build at import, and entry points that need CUDA unless told to
run on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kvq_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kvq_tpu"}
NOT_AT_MODULE_LEVEL = {"yaml", "cv2", "pandas", "openpyxl", "msgpack"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(top-level package, imported when the module is?) for each import."""
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], not in_function)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], not in_function))
            visit(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        assert name not in FORBIDDEN, f"{path}: imports {name}"
        if name in NOT_AT_MODULE_LEVEL:
            assert not top, f"{path}: imports {name} at module level"


@pytest.mark.parametrize("path", sorted((PORT / "ops").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernels_import_nothing_of_the_model_layer(path):
    """``ops/`` lies below ``nn/``: no kernel module imports the models."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom):
            names = ["." * node.level + (node.module or "")]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            assert not name.startswith(("..nn", "kvq_tpu_torch.nn")), (
                f"{path}: imports {name}")


def test_importing_every_module_builds_nothing():
    """Import every module with the compiler and the library loader
    disabled: any build or load at import would raise."""
    mods = sorted(  # packages too: runtime/ is its __init__.py
        ".".join((p.parent if p.name == "__init__.py" else p.with_suffix(""))
                 .relative_to(ROOT).parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import subprocess, ctypes, sys\n"
        "import numpy, scipy.stats, torch  # their own native loads\n"
        "def boom(*a, **k): raise AssertionError('build at import')\n"
        "subprocess.Popen = boom\nctypes.CDLL = boom\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | NOT_AT_MODULE_LEVEL)!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from kvq_tpu_torch.core.device import resolve_device
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.evaluator import Evaluator

    from test_torch_modules import tiny_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    ev = Evaluator(tiny_config(), device="cpu")
    assert next(ev.model.parameters()).device.type == "cpu"


def test_cli_test_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    """``cli.test.main`` without ``--device cpu`` raises where there is no
    CUDA, before it reads a video or builds a model."""
    from kvq_tpu_torch.cli import test as cli_test
    from kvq_tpu_torch.cli import train as cli_train

    from test_torch_modules import tiny_config

    cfg = tmp_path / "cfg.yml"
    cfg.write_text("name: tiny\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(cli_test, "build_loaders",
                        lambda c: built.append(c) or (None, None))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_test.main(["-o", str(cfg), "-out", str(tmp_path / "o.txt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_test.run(tiny_config(), str(tmp_path / "o.txt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.run(tiny_config(), str(tmp_path / "work"))
    assert not built and not (tmp_path / "o.txt").exists()
    with pytest.raises(ValueError, match="data.val"):  # cpu goes on
        cli_test.run(dict(tiny_config(), data={}), str(tmp_path / "o.txt"),
                     device="cpu")
    assert len(built) == 1


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card, and alone in a directory, the script exits non-zero
    and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
