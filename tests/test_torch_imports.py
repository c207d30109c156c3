"""The port imports torch and numpy, never jax: the GPU host has no jax.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "deltapq_tpu_torch"


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'deltapq_tpu' not in sys.modules\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_jax_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import deltapq_tpu\b|"
                     r"from deltapq_tpu\b)", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for p in files:
        assert not pat.search(p.read_text()), p


@pytest.mark.parametrize("module", [
    "deltapq_tpu_torch.ops.topk", "deltapq_tpu_torch.ops.decoded",
    "deltapq_tpu_torch.ops.adc_kernels", "deltapq_tpu_torch.eval",
    "deltapq_tpu_torch.eval.metrics", "deltapq_tpu_torch.eval.groundtruth",
    "deltapq_tpu_torch.bench_engines", "deltapq_tpu_torch.bench_gist"])
def test_module_alone_imports_without_jax(module):
    """Each module of the plain-scan family on its own, in a fresh
    interpreter: it is there, and brings in neither jax nor the JAX
    package."""
    path = ROOT.joinpath(*module.split("."))
    assert path.with_suffix(".py").exists() or (path / "__init__.py").exists()
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert 'deltapq_tpu' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
