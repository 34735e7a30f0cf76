"""The port's package exports against the reference's: ``repro_torch.core``
exports every name of ``repro.core`` but the VMEM model's two, whose
counterparts differ on purpose (``DEFAULT_VMEM_LIMIT`` has none: tiles
are planned against shared memory; ``vmem_feasible`` is
``core.tuning.launch_feasible``); ``repro_torch.kernels.ops`` exports the
reference's kernel wrappers."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

import repro.core as j_core
import repro.kernels.ops as j_ops
from repro.core.miniconv import standard_spec as j_standard_spec

import repro_torch.core as t_core
import repro_torch.kernels.ops as t_ops

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

DIVERGENCES = {"DEFAULT_VMEM_LIMIT"}
PORT_ONLY = {"PodSplitConfig", "pod_break_even_bandwidth"}


def test_core_exports_the_references_names():
    assert set(t_core.__all__) - PORT_ONLY == set(j_core.__all__) - \
        DIVERGENCES
    assert len(t_core.__all__) == len(set(t_core.__all__))
    for name in t_core.__all__:
        assert getattr(t_core, name) is not None
    assert not hasattr(t_core, "DEFAULT_VMEM_LIMIT")


def test_kernel_ops_export_the_references_wrappers():
    assert sorted(t_ops.__all__) == sorted(j_ops.__all__)
    for name in t_ops.__all__:
        assert callable(getattr(t_ops, name))


@pytest.mark.parametrize("c_in,k,h,w", [(12, 4, 84, 84), (4, 4, 400, 400),
                                        (9, 16, 85, 83)])
def test_miniconv_feature_shape(c_in, k, h, w):
    from repro.core import miniconv_feature_shape as j_shape
    got = t_core.miniconv_feature_shape(t_core.standard_spec(c_in=c_in, k=k),
                                        h, w)
    assert tuple(got) == tuple(j_shape(j_standard_spec(c_in=c_in, k=k), h,
                                       w))


def test_make_miniconv_split_shim():
    spec = t_core.standard_spec(c_in=12, k=4)

    def server(params, feats):
        return feats.sum()

    split = t_core.make_miniconv_split(spec, server, h=84, device="cpu")
    assert isinstance(split, t_core.SplitModel)
    assert split.server_apply is server
    assert split.wire_bytes() == 492
    params = t_core.miniconv_init(torch.Generator().manual_seed(0), spec,
                                  device="cpu")
    obs = torch.rand((1, 84, 84, 12), generator=torch.Generator()
                     .manual_seed(1))
    with torch.no_grad():
        full = t_core.miniconv_apply(params, spec, obs)
    assert tuple(full.shape[1:]) == tuple(
        t_core.miniconv_feature_shape(spec, 84, 84))
    assert np.isfinite(full.numpy()).all()
