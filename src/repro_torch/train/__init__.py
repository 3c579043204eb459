"""LM training on the port: data, optimizer, train steps, checkpoints and
the compressed all-reduce (port of ``repro.train``)."""
