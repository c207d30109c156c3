"""``correct`` separates: sound runs pass, the control and broken timed
paths fail.

The control (the reference one step below the stated precision, put in
the program's place) must come out not correct on every seed.  A whole
run, the look for a card skipped, must come out not correct when its
timed path is broken underneath: an answer altered where the engine
produces it (a wrong id, or a distance off by the rounding of a lower
precision), or the server's fan-out handing a request another query's
answer.  Tiny sizes on the CPU; ``test_control_on_the_card`` holds the
control at a larger size on the card.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark import check, control, run
from benchmark.generators import open_poisson

CELLS = ["sift1m.batch", "gist1m.batch", "sift1m.ood", "sift1m.serve"]
BATCH_CELLS = ["sift1m.batch", "gist1m.batch", "sift1m.ood"]
SEED = 2 ** 31 + 5


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, SEED])
def test_control_fails_every_limit_set(tiny, cell, seed):
    spec = tiny(cell)
    nums = control.control_numbers(spec, seed, "cpu")
    assert not check.verdict(nums, spec["cell"]["limits"]), nums


@pytest.mark.cuda
def test_control_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = tiny("sift1m.batch")
    spec["config"].update(n_base=131072, n_learn=20000, D=128, K=256)
    for seed in (1, 2, 3):
        nums = control.control_numbers(spec, seed, torch.device("cuda", 0))
        assert not check.verdict(nums, spec["cell"]["limits"]), nums


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    out = run.run_cell(cell, 3, 0.5, False, "cpu",
                       tiny(cell, "fused_compressed"))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _wrong_id(d, rows):
    rows = rows.clone()
    rows[0, 0] = (rows[0, 0] + 1) % 1000
    return d, rows


def _rounded_dist(d, rows):
    d = d.clone()
    d[0, 0] = d[0, 0] * (1 + 2 ** -9)
    return d, rows


@pytest.mark.parametrize("fault", [_wrong_id, _rounded_dist])
@pytest.mark.parametrize("cell", BATCH_CELLS + ["sift1m.serve"])
def test_answer_altered_where_produced(tiny, monkeypatch, cell, fault):
    from deltapq_tpu_torch.ops import fused

    select = fused._FusedEngine.select

    def broken(self, *a, **kw):
        return fault(*select(self, *a, **kw))

    monkeypatch.setattr(fused._FusedEngine, "select", broken)
    out = run.run_cell(cell, 4, 0.5, False, "cpu",
                       tiny(cell, "fused_compressed"))
    assert not out["correct"], out["checks"]


def test_fan_out_hands_a_request_another_answer(tiny, monkeypatch):
    query = open_poisson._Shim.query

    def shifted(self, queries, top_k):
        d, ids = query(self, queries, top_k)
        return np.roll(d, 1, axis=0), np.roll(ids, 1, axis=0)

    monkeypatch.setattr(open_poisson._Shim, "query", shifted)
    out = run.run_cell("sift1m.serve", 6, 0.5, False, "cpu",
                       tiny("sift1m.serve", "fused_compressed"))
    assert not out["correct"], out["checks"]


def test_answers_that_never_come_fail_and_the_run_still_ends(tiny,
                                                             monkeypatch):
    import time

    query = open_poisson._Shim.query

    def stalled(self, queries, top_k):
        time.sleep(0.3)
        return query(self, queries, top_k)

    monkeypatch.setattr(open_poisson, "run", functools.partial(
        open_poisson.run, drain_s=0.5))
    monkeypatch.setattr(open_poisson._Shim, "query", stalled)
    t = time.perf_counter()
    out = run.run_cell("sift1m.serve", 7, 0.5, False, "cpu",
                       tiny("sift1m.serve", "fused_compressed"))
    assert out["failed"] > 0 and not out["correct"]
    assert time.perf_counter() - t < 60
