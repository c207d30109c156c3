"""Shared helpers of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests``).  Sizes here are tiny: the
cells' real sizes run only on the card."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: every cell at a size the CPU holds in a second or two
TINY = {"sift1m": dict(n_base=4096, n_learn=2048, n_queries=300, D=32,
                       M=8, K=16, kmeans_iters=5),
        "gist1m": dict(n_base=3000, n_learn=2000, n_queries=100, D=64,
                       M=16, K=16, kmeans_iters=5)}


#: the served cell, which BENCHMARK.json does not hold yet, with the
#: metrics it would report
SERVE = dict(entry={"name": "sift1m.serve", "config": "sift1m",
                    "traffic": "serve_poisson", "chips": 1},
             end_to_end=[{"name": "served_p95_ms", "unit": "ms"},
                         {"name": "setup_s", "unit": "s"}],
             per_layer=[{"name": "rows_per_dispatch", "unit": "rows"},
                        {"name": "device_idle_share.serve", "unit": "%"}])


def spec_of(cell: str) -> dict:
    """The cell's spec: from BENCHMARK.json, or ``SERVE``'s."""
    from benchmark.run import cell_spec, load_spec

    if cell == SERVE["entry"]["name"]:
        return cell_spec(**SERVE)
    return load_spec(cell)


def tiny_spec(cell: str, engine: str = "auto") -> dict:
    """The cell's spec with its configuration cut to ``TINY`` and its
    traffic scaled to match."""
    spec = copy.deepcopy(spec_of(cell))
    spec["config"].update(TINY[spec["config"]["name"]], engine=engine)
    tr = spec["traffic"]
    if tr["kind"] == "closed_batch":
        tr["batch"] = min(tr["batch"], 64)
    else:
        tr.update(rate_qps=2000, wave_rows=256)
    return spec


@pytest.fixture
def tiny():
    return tiny_spec


@pytest.fixture(name="spec_of")
def spec_of_fixture():
    return spec_of
