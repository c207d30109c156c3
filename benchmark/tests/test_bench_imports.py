"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level names compared
whole)."""

import ast
import subprocess
import sys

import pytest

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "deltapq_tpu"}


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(run.HERE.parent)!r}); "
            f"{imports}; print(' '.join(sorted({{m.split('.')[0] "
            f"for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    top = _loaded_after(
        "import benchmark.run, benchmark.control, benchmark.sweep, "
        "benchmark.generators.closed_batch, "
        "benchmark.generators.open_poisson, "
        "deltapq_tpu_torch.index, deltapq_tpu_torch.serving; "
        "from benchmark.run import reader; "
        "[reader(n) for n in ('scan_roofline', 'served_p95_ms', "
        "'device_idle_share.serve')]")
    assert "deltapq_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after("import benchmark.reference, benchmark.check")
    assert not top & (FORBIDDEN | {"deltapq_tpu_torch"})


@pytest.mark.parametrize("path", sorted(run.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(run.HERE)))
def test_no_source_imports_jax(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if path.name in ("reference.py", "check.py", "data.py", "roofline.py"):
        assert "deltapq_tpu_torch" not in names


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", "sift1m.batch", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
