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
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "multicard_check.py"]
    for p in files:
        assert not pat.search(p.read_text()), p


@pytest.mark.parametrize("module", [
    "deltapq_tpu_torch.ops.topk", "deltapq_tpu_torch.ops.decoded",
    "deltapq_tpu_torch.ops.adc_kernels", "deltapq_tpu_torch.eval",
    "deltapq_tpu_torch.eval.metrics", "deltapq_tpu_torch.eval.groundtruth",
    "deltapq_tpu_torch.bench_engines", "deltapq_tpu_torch.bench_gist",
    "deltapq_tpu_torch.cli", "deltapq_tpu_torch.config",
    "deltapq_tpu_torch.io", "deltapq_tpu_torch.io.vecs",
    "deltapq_tpu_torch.io.codes", "deltapq_tpu_torch.io.codewords",
    "deltapq_tpu_torch.io.groundtruth", "deltapq_tpu_torch.io.artifacts",
    "deltapq_tpu_torch.profiling", "deltapq_tpu_torch.ops.delta",
    "deltapq_tpu_torch.parallel", "deltapq_tpu_torch.parallel.runtime",
    "deltapq_tpu_torch.parallel.mesh", "deltapq_tpu_torch.parallel.sharded",
    "deltapq_tpu_torch.parallel.fused_sharded",
    "deltapq_tpu_torch.parallel.pipeline",
    "deltapq_tpu_torch.parallel.sharded_tree",
    "deltapq_tpu_torch.parallel.dryrun",
    "multicard_check", "deltapq_tpu_torch.serving",
    "deltapq_tpu_torch.tree.with_id", "deltapq_tpu_torch.tree.traverse",
    "deltapq_tpu_torch.tree.serialize", "deltapq_tpu_torch.tree.build",
    "deltapq_tpu_torch.tree", "deltapq_tpu_torch.tree.exact_mst",
    "deltapq_tpu_torch.tree.reroot", "deltapq_tpu_torch.native",
    "deltapq_tpu_torch.native.api", "deltapq_tpu_torch.native.build",
    "deltapq_tpu_torch.legacy", "deltapq_tpu_torch.legacy.prefix_tree",
    "deltapq_tpu_torch.entry", "deltapq_tpu_torch.tree.build_device"])
def test_module_alone_imports_without_jax(module):
    """Each module of the plain-scan family and of the CLI's layer on its
    own, in a fresh interpreter: it is there, and brings in neither jax
    nor the JAX package."""
    path = ROOT.joinpath(*module.split("."))
    assert path.with_suffix(".py").exists() or (path / "__init__.py").exists()
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert 'deltapq_tpu' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cli_module_runs_without_jax():
    """``python -m deltapq_tpu_torch.cli --help`` in a fresh interpreter:
    the console script's module answers without importing jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['deltapq-tpu-torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('deltapq_tpu_torch.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'deltapq_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "-engine" in out.stdout and "fused_dedup" in out.stdout
    out = subprocess.run([sys.executable, "-m", "deltapq_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "-dataset" in out.stdout, out.stderr
