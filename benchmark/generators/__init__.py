"""Traffic generators, one module per ``kind`` a traffic file names.

Each module defines ``warmup(session)``, run in set-up over every shape
its traffic uses, and ``run(session)``, the measured window.  ``session``
is ``run.Session``: the search entry, the queries, the traffic's
parameters, the window's length, the tracer and the sample of answers
kept for the check.
"""
