"""Spec, plan, backends, wire and split of the port (``repro.core``
counterparts).  Import from the submodules."""
