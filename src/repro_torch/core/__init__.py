"""Spec, plan, backends, wire, split and the decision-latency model of the
port (``repro.core`` counterparts).  Import from the submodules; the
latency model's names are also exported here, as the reference exports
them."""
from repro_torch.core.latency import (LinkModel, PodSplitConfig, SplitConfig,
                                      break_even_bandwidth,
                                      decision_latency_server_only,
                                      decision_latency_split,
                                      paper_pi_zero_config,
                                      pod_break_even_bandwidth)

__all__ = ["LinkModel", "PodSplitConfig", "SplitConfig",
           "break_even_bandwidth", "decision_latency_server_only",
           "decision_latency_split", "paper_pi_zero_config",
           "pod_break_even_bandwidth"]
