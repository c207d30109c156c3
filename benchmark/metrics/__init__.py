"""One reader a metric: ``metrics/<name>.py`` defines ``read(run)``,
which takes the finished ``run.Session`` and returns the metric's value,
or None where the run holds nothing to read (the harness then leaves the
metric out of the result line)."""
