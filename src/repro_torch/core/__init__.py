"""Core of the port (``repro.core`` counterparts): MiniConv specs, the
PassPlan IR, the backend registry, the autotuner, the split model, the
wire codecs and the decision-latency model.

Exports the reference's ``repro.core`` names, with two deliberate
divergences: the VMEM model's ``DEFAULT_VMEM_LIMIT`` has no counterpart
(the port plans tiles against shared memory, ``passplan.SMEM_LIMIT``), and
``vmem_feasible`` is ``tuning.launch_feasible``.  The latency model's
pod-scale names (``PodSplitConfig``, ``pod_break_even_bandwidth``) are
exported too.
"""
from repro_torch.core.backends import (ExecutionBackend, backend_names,
                                       get_backend, register_backend)
from repro_torch.core.latency import (LinkModel, PodSplitConfig, SplitConfig,
                                      break_even_bandwidth,
                                      decision_latency_server_only,
                                      decision_latency_split,
                                      paper_pi_zero_config,
                                      pod_break_even_bandwidth)
from repro_torch.core.miniconv import (PI_ZERO_BUDGET, LayerSpec,
                                       MiniConvSpec, ShaderBudget,
                                       miniconv_apply, miniconv_feature_shape,
                                       miniconv_init, standard_spec)
from repro_torch.core.passplan import (HeadPlan, LayerPlan, PassPlan,
                                       ShaderPass, build_pass_plan,
                                       count_passes, out_spatial_chain)
from repro_torch.core.split import (SplitModel, make_miniconv_split,
                                    make_split_policy, straight_through)
from repro_torch.core.tuning import (Candidate, TunedPlan, default_candidates,
                                     estimated_cost_s, prune_candidates,
                                     suggest_tuning, tune)
from repro_torch.core.wire import (CODECS, WireCodec, feature_bytes,
                                   frame_bytes_rgba, get_codec, roundtrip)

__all__ = [
    "ExecutionBackend", "backend_names", "get_backend", "register_backend",
    "LinkModel", "SplitConfig", "break_even_bandwidth",
    "decision_latency_server_only", "decision_latency_split",
    "paper_pi_zero_config", "PodSplitConfig", "pod_break_even_bandwidth",
    "MiniConvSpec", "LayerSpec", "ShaderBudget", "PI_ZERO_BUDGET",
    "miniconv_apply", "miniconv_feature_shape", "miniconv_init",
    "standard_spec", "HeadPlan", "LayerPlan", "PassPlan", "ShaderPass",
    "build_pass_plan", "count_passes", "out_spatial_chain", "SplitModel",
    "make_miniconv_split", "make_split_policy", "straight_through",
    "Candidate", "TunedPlan", "default_candidates", "estimated_cost_s",
    "prune_candidates", "suggest_tuning", "tune", "CODECS", "WireCodec",
    "feature_bytes", "frame_bytes_rgba", "get_codec", "roundtrip",
]
