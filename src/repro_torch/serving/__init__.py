"""Edge client, decision loop, shaped link and micro-batching policy
server of the port (``repro.serving`` counterparts)."""
