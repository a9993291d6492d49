"""The port stands alone: nothing under ``src/repro_torch`` or in
``chip_smoke.py`` imports JAX or the JAX package, the port imports with JAX
made unimportable, its entry points refuse to run without CUDA unless asked
for the CPU, and ``chip_smoke.py`` fails without a card or without the
repository around it."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    and ``import repro`` fail."""
    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in {k.split('.')[0] for k, v in "
            "sys.modules.items() if v is not None}\n"
            "print('ok', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_without_cuda(monkeypatch):
    """``device`` defaults to CUDA: without it the engine, the model init and
    the serving, training and colocation drivers raise instead of running
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import colocate, serve, train
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi4-mini-3.8b-smoke")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm(cfg, 0, torch.float32)
    params = init_lm(cfg, 0, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, batch_slots=2, max_len=32, params=params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--batch", "2", "--seq", "16"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        colocate.main(["--requests", "1"])
    eng = ServeEngine(cfg, batch_slots=2, max_len=32, params=params,
                      device="cpu")
    assert eng.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No result line and a non-zero exit: once here, where CUDA is absent
    (or made so), and once from a directory holding only the script."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [REPO]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs.append(alone)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0, (cwd, out.stdout, out.stderr)
        assert '"ok"' not in out.stdout, out.stdout
