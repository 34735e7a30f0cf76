"""Training substrate of the port (``repro.train`` counterparts): the
optimizers."""
