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
    for name in ("methods.fused_assembly", "methods.hho", "methods.poisson",
                 "methods.condensation", "methods.obstacle", "io.vtk",
                 "utils.checkpoint", "apps.polymesh", "cut.fictdom",
                 "cut.interface_problem", "cut.agglomerate",
                 "io.debug_plots", "utils.debug", "apps.cuthho_square",
                 "methods.structured", "cut.batched",
                 "apps.fictdom_family", "parallel.sharding",
                 "parallel.halo", "bench"):
        assert "proton_tpu_torch." + name in mods
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


def test_uncut_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device given and no CUDA: the mesh generator and loader, the
    obstacle solve and every app's main (without --device) raise."""
    from proton_tpu_torch.apps import convergence_test, obstacle, \
        polymesh, stabilization_test
    from proton_tpu_torch.core.mesh import load_poly_mesh, make_quad_mesh
    from proton_tpu_torch.methods.obstacle import run_obstacle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    missing = str(tmp_path / "no_mesh.txt")
    for call in (lambda: make_quad_mesh(Nx=4, Ny=4),
                 lambda: load_poly_mesh(missing),
                 lambda: run_obstacle(4, 0),
                 lambda: convergence_test.main(["--deg-max", "0", "--min-N",
                                                "2", "--steps", "1",
                                                "--no-files"]),
                 lambda: stabilization_test.main([]),
                 lambda: obstacle.main(["-N", "4"]),
                 lambda: polymesh.main([missing])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cut_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device given and no CUDA: the generic fictdom and interface
    solves and the cuthho_square app (without --device) raise."""
    from proton_tpu_torch.apps import cuthho_square
    from proton_tpu_torch.cut.fictdom import run_fictdom
    from proton_tpu_torch.cut.interface_problem import run_interface

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for call in (lambda: run_fictdom(4, 1),
                 lambda: run_interface(4, 1),
                 lambda: cuthho_square.main(["-f", "-i", "-N", "4", "-M",
                                             "4", "-d"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert list(tmp_path.iterdir()) == []


def test_galerkin_and_parallel_entry_points_raise_without_cuda(monkeypatch):
    """No device given and no CUDA: the Galerkin solve and the process
    group of proton_tpu_torch.parallel raise (the parallel package picks
    NCCL for CUDA, gloo only when the CPU is asked for)."""
    from proton_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: fs.solve_fictdom_structured(8, 1, mg_galerkin=True,
                                                     mg_gamma=2),
                 lambda: sharding.make_device_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
