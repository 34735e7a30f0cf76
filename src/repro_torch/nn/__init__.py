"""Layers and initialisers of the port (``repro.nn`` counterparts)."""
