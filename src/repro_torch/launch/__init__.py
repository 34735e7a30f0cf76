"""Entry points of the port's LM stack (``repro.launch`` counterparts)."""
