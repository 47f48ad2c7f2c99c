"""The port's benchmark: one cell a run (`bench/run.py`), driven by
`BENCHMARK.json` and the configuration, traffic, generator and metric
files it names."""
