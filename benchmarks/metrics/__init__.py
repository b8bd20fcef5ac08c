"""Metric readers, one file a metric, named as in ``BENCHMARK.json``.
Each defines ``UNIT`` and ``read(reading)``, which returns the number or
None when the run holds nothing to read (the metric is then left out)."""
