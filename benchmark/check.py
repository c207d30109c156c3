"""What decides ``correct``: a search's answers against the reference.

For each checked query the reference gives the float64 exact top-k
distances ``ref`` (ascending) and ``dists_of`` the float64 distance of
every id the search returned.  With ``scale`` the reference's k-th
distance of the query (the size of the answer):

- ``dist_gap``: max |returned distance - ref[j]| / scale over ranks j:
  the distances the search reports are the exact ones, rank by rank;
- ``id_gap``: max |true distance of the returned id - ref[j]| / scale:
  the ids are the exact answer (ties may come in any order);
- ``bad_ids``: ids that are missing (-1), out of range, or repeated in
  one answer.

A cell's file gives a limit for each; ``correct`` holds where every
number is at or below its limit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import reference

NUMBERS = ("dist_gap", "id_gap", "bad_ids")


def compare(codewords, codes, queries, d_got, i_got, k: int, device
            ) -> Dict[str, float]:
    """The compared numbers for answers (d_got, i_got) [Q, k] to
    ``queries`` [Q, D]."""
    d_got = np.asarray(d_got, np.float64)
    i_got = np.asarray(i_got, np.int64)
    if d_got.shape != (len(queries), k) or i_got.shape != d_got.shape:
        raise ValueError(f"answers of shape {d_got.shape} / {i_got.shape} "
                         f"for {len(queries)} queries at k={k}")
    d_ref, _ = reference.exact_topk(codewords, codes, queries, k, device)
    d_true = reference.dists_of(codewords, codes, queries, i_got, device)
    n = len(codes)
    srt = np.sort(i_got, axis=1)
    repeated = np.zeros_like(i_got, bool)
    repeated[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    invalid = (i_got < 0) | (i_got >= n)
    scale = np.maximum(d_ref[:, -1:], np.finfo(np.float32).tiny)
    dist_gap = np.abs(d_got - d_ref) / scale
    id_gap = np.where(invalid, 0.0, np.abs(d_true - d_ref) / scale)
    return {"dist_gap": float(np.nan_to_num(dist_gap, nan=np.inf).max()),
            "id_gap": float(np.nan_to_num(id_gap, nan=np.inf).max()),
            "bad_ids": float(invalid.sum() + repeated.sum())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[n] <= limits[n] for n in NUMBERS)
