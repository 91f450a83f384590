"""The benchmark of the PyTorch port (``BENCHMARK.json``)."""
