"""The LM model zoo (port of ``repro.models``): layers, Mamba-2, MoE,
blocks and the causal / encoder-decoder LMs."""
