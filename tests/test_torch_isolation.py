"""proton_tpu_torch stands alone: it imports neither JAX nor proton_tpu,
and its entry points run on CUDA or raise, never falling back to the CPU
unasked."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import proton_tpu_torch
from proton_tpu_torch.cut import fictdom_structured as fs

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "proton_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        proton_tpu_torch.__path__, "proton_tpu_torch."))


def test_every_module_imports_without_jax():
    """A fresh interpreter that cannot import jax or proton_tpu imports
    every module of the package."""
    mods = _modules()
    assert "proton_tpu_torch.methods.fused_assembly" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['proton_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    """No `import jax...` or `import proton_tpu...` in the package or in
    chip_smoke.py."""
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "proton_tpu"), (path, name)


def test_solve_without_device_raises_without_cuda(monkeypatch):
    """No device given and no CUDA: the entry point raises, on its
    default path (lean + multigrid) and on every other."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.solve_fictdom_structured(8, 1)
    for kw in (dict(precond="mg"), dict(precond="mg", fitted="full"),
               dict(precond="block_jacobi", fitted="full")):
        with pytest.raises(RuntimeError, match="CUDA"):
            fs.solve_fictdom_structured(8, 1, **kw)
