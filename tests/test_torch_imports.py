"""Import hygiene of the port: it imports neither JAX nor the JAX package,
and its entry points never run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    fails."""
    code = (
        "import sys, importlib, pathlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"root = pathlib.Path({str(PORT)!r})\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    rel = p.relative_to(root.parent).with_suffix('')\n"
        "    parts = [x for x in rel.parts if x != '__init__']\n"
        "    importlib.import_module('.'.join(parts))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.partition import partition
    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import grid2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = grid2d(6, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FPPSession(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FPPSession(g, device="cuda")
    bg, _ = partition(g, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FPPEngine(bg)
    assert FPPSession(g, device="cpu").device == torch.device("cpu")


def test_lm_entry_points_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.factory import build_model
    from repro_torch.serve import ContinuousBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("starcoder2-7b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(device="cuda")
    params = model.init(device="cpu")
    assert params["embed"]["embedding"].device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(model, params, batch_size=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "starcoder2-7b", "--requests", "1"])
    b = ContinuousBatcher(model, params, batch_size=2, max_len=16,
                          device="cpu")
    assert b.state.kv.k.device == torch.device("cpu")
