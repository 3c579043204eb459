"""Launchers: the production mesh and the LM training driver (port of
``repro.launch``)."""
