"""Staged-artifact caching.

A NumPy copy of ``deltapq_tpu/io/artifacts.py``.

The reference caches every expensive pipeline stage to a file keyed by its
config (codewords ``main.cpp:273``, codes ``pq_tree.cpp:1011``, edges
``deltapq_create_approx_tree.h:1215-1242``, QNodes ``:1357-1367``,
compressed codes ``:1749-1753``) and checks ``exists_test3`` before
recomputing.  We keep the same staged model: each stage is a pure
function dataset -> arrays, cached as ``.npz`` keyed by a config hash,
in addition to the reference-format binary artifacts (io.codes etc.)
used for cross-checking.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict

import numpy as np


def config_key(**kwargs) -> str:
    """Stable short hash of a config dict."""
    blob = json.dumps(kwargs, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


class ArtifactCache:
    """npz-file cache rooted at a dataset directory."""

    def __init__(self, root: str, enabled: bool = True):
        self.root = root
        self.enabled = enabled
        if enabled:
            os.makedirs(root, exist_ok=True)

    def path(self, stage: str, key: str) -> str:
        return os.path.join(self.root, f"{stage}_{key}.npz")

    def get_or_compute(self, stage: str, key: str,
                       fn: Callable[[], Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
        p = self.path(stage, key)
        if self.enabled and os.path.exists(p):
            with np.load(p, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        out = fn()
        if self.enabled:
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **out)
            os.replace(tmp, p)
        return out
