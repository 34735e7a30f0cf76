"""Edge client and micro-batching policy server of the port
(``repro.serving.server`` / ``client`` counterparts)."""
