"""Sharding rules: parameter, batch, cache and optimizer-state layouts on a
``torch.distributed`` device mesh (port of ``repro.sharding``)."""
