"""The benchmark of ``deltapq_tpu_torch``: exact top-k search through
``DeltaPQIndex.search`` on one card, in batches and served.

One command runs one cell once (see ``run.py``)::

    python3 -m benchmark.run --workload sift1m.batch --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (its ``kind`` names a module of ``generators/``),
``workloads/<cell>.json`` and ``metrics/<metric>.py``.  The inputs
(vectors, codebook, codes, queries) are made here from the seed; the
program receives only those.  ``reference.py`` is the plain exact top-k
that decides ``correct``; it imports nothing of the program.
"""
