"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
general harness, and the configurations, traffic mixes, per-layer metrics
and plain references it finds by name.  See README.md."""
