"""Decoder models of the port (``repro.models`` counterparts)."""
