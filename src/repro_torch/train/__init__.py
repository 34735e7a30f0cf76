"""Training substrate of the port (``repro.train`` counterparts): the
optimizers, checkpoints and the LM trainer."""
