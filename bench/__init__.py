"""The port's benchmark: one cell of `BENCHMARK.json` run once by `bench/run.py`.

Everything that belongs to one configuration, query, traffic mix or
per-layer metric is a file of its own, found by its name:

  configs/<config>.json    tables, row counts, column recipes, the query
  queries/<query>.py       the logical plan and its plain reference
  traffic/<traffic>.json   the loop that offers the queries
  metrics/<metric>.py      a reader of one per-layer metric

The rest is the yardstick: the data generator (`datagen`), the loop
(`loop`), the answer check (`check`), the byte formulas (`roofline`), the
profiler reduction (`devtrace`) and the per-node spans (`spans`).
"""
