"""Coverage guard: every top-level function and class of the JAX
package, and every method of its classes, has a counterpart of the same
name in the port (``fused_pallas`` -> ``fused_kernels``, ``adc_pallas``
-> ``adc_kernels``), apart from the allow-list below.  The JAX sources
are read with ``ast``; nothing of the JAX package is imported.  Methods
are checked with ``hasattr`` on the port's class, so an inherited method
(the fused engines' ``query``, ``calibrate``, ``warmup`` from
``_FusedEngine``) counts."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "deltapq_tpu"
RENAMED = {"fused_pallas": "fused_kernels", "adc_pallas": "adc_kernels"}

#: names with no counterpart, by port module
ALLOWED = {
    "deltapq_tpu_torch.ops.fused_kernels": {
        # Pallas kernel bodies: each became a CUDA kernel in csrc/
        "_decoded_mins_kernel", "_codes_mins_kernel", "_delta_mins_kernel",
        "_stream_mins_kernel", "_stream_mins_pipelined_kernel",
        "_rerank_kernel",
        # their in-kernel helpers (subtile minima, masking, the shared
        # scan tail, the stream decode, prefix shifts, digit norms, the
        # upper-triangular prefix matrix) and the pallas_call wrapper
        # with its group split
        "_subtile_mins", "_mask_invalid", "_scan_tail", "_stream_decode",
        "_shift_right", "_norm_digits", "_upper_tri_i8", "_mins_call",
        "_groups_of",
        # TPU knobs: interpret mode, environment switches of the Pallas
        # kernels, the one-hot compare type and the two-group int16 form
        "_interpret", "_no_ut", "_stage_iso", "_no_dig", "_oh_cmp_dtype",
        "_int16_g2", "quantize_blockdiag_int16_g2",
        "int16_digits_to_values",
    },
    "deltapq_tpu_torch.ops.adc_kernels": {
        # Pallas kernel bodies (CUDA in csrc/adc_topk.cu, adc_dists.cu)
        "_adc_dists_kernel", "_adc_topk_kernel", "_adc_topk_packed_kernel",
        "_adc_topk_tiledict_kernel",
        # their one-hot table accumulation
        "_accumulate_onehot",
    },
}


def _jax_modules():
    for p in sorted(JAX_PKG.rglob("*.py")):
        parts = [RENAMED.get(x, x)
                 for x in p.relative_to(JAX_PKG).with_suffix("").parts]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield p, ".".join(["deltapq_tpu_torch"] + parts)


MODULES = list(_jax_modules())


@pytest.mark.parametrize("path,port", MODULES,
                         ids=[m for _, m in MODULES])
def test_every_name_has_a_counterpart(path, port):
    mod = importlib.import_module(port)
    allowed = ALLOWED.get(port, set())
    missing = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        if node.name in allowed:
            continue
        if not hasattr(mod, node.name):
            missing.append(node.name)
        elif isinstance(node, ast.ClassDef):
            cls = getattr(mod, node.name)
            missing += [f"{node.name}.{f.name}" for f in node.body
                        if isinstance(f, ast.FunctionDef)
                        and not hasattr(cls, f.name)]
    assert not missing, f"{port}: no counterpart for {missing}"


def test_allow_list_names_exist_in_jax():
    """Every allowed name is still in the JAX package (a stale entry
    would hide nothing, but says something false)."""
    names = {}
    for path, port in MODULES:
        names.setdefault(port, set()).update(
            n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    for port, allowed in ALLOWED.items():
        assert allowed <= names[port], allowed - names[port]
