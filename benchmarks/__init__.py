"""The benchmark of eventad_tpu_torch on one H100: ``python -m benchmarks.run`` (``BENCHMARK.json``)."""
