"""Networks of the port (``repro.rl`` counterparts); training comes later."""
