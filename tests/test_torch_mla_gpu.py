"""K5's route for values narrower than the queries and keys, and the MLA
path through it, on the card (the GPU tier: these tests skip without a
Hopper card and nvcc).

K5 is held to its plain version (``kernels.ref.attention_ref`` in float32
on the same bf16 inputs) at 1e-2, the tolerance of every bf16 K5 case in
``test_torch_kernels_gpu.py``: K5 rounds P to bf16 before P.V and its
output once to bf16, 2^-8 of a value each."""
import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda_kernels_supported  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models.transformer import DecoderModel  # noqa: E402
from repro_torch.nn.module import tree_map  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not cuda_kernels_supported():
        pytest.skip("needs a Hopper (sm_90) card and nvcc: the port's CUDA "
                    "kernels build and run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    f = fmod.flash_attention
    return (f.launches, f.tc_launches, f.dv_launches, f.copies)


# (B, H, H_kv, S, D, D_v, causal, window): MLA's widths with two and one
# consumer warpgroups and a ragged S, grouped KV heads, a window, every
# padded pair (192/128, 192/64, 128/64, 128 with a 96-wide value) and
# widths below their padding
CASES = [(2, 16, 16, 1100, 192, 128, True, None),
         (2, 4, 4, 300, 192, 128, True, None),
         (1, 4, 2, 129, 192, 128, True, None),
         (1, 4, 4, 200, 192, 64, True, 50),
         (1, 4, 1, 257, 128, 64, True, None),
         (1, 4, 4, 300, 128, 96, False, None),
         (1, 4, 4, 100, 184, 120, True, None)]


@pytest.mark.parametrize("B,H,H_kv,S,D,Dv,causal,window", CASES)
def test_narrow_value_route_matches_plain(cuda, B, H, H_kv, S, D, Dv,
                                          causal, window):
    """Values read in place as the strided second half of a (B, S, H_kv,
    2 D_v) tensor, as ``nn.mla`` reads ``kv_b_proj``'s output: no copy,
    the tensor-core route, the output (B, S, H, D_v) storage, bit for bit
    between runs."""
    g = torch.Generator().manual_seed(S + D + Dv)
    q = torch.randn((B, S, H, D), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((B, S, H_kv, D), generator=g).to(cuda, torch.bfloat16)
    kv = torch.randn((B, S, H_kv, 2 * Dv), generator=g).to(cuda,
                                                           torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, kv[..., Dv:]))
    before = _counts()

    def run():
        return fmod.flash_attention(qt, kt, vt, causal=causal,
                                    sliding_window=window, block_q=S,
                                    block_k=S)
    got = run()
    rep = H // H_kv
    want = attention_ref(qt.float(), kt.float().repeat_interleave(rep, 1),
                         vt.float().repeat_interleave(rep, 1),
                         causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                         before[3])
    assert got.shape == (B, H, S, Dv) and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    assert torch.equal(got, run())


def test_narrow_values_refused_off_the_tensor_cores(cuda):
    q = torch.zeros((1, 2, 64, 192), device=cuda)
    v = torch.zeros((1, 2, 64, 128), device=cuda)
    with pytest.raises(ValueError, match="tensor-core route"):
        fmod.flash_attention(q, q, v)
    wide = torch.zeros((1, 2, 64, 200), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core route"):
        fmod.flash_attention(wide, wide, v.bfloat16())


def test_reduced_moonlight_on_card_matches_cpu_and_launches_k5(cuda):
    """The reduced Moonlight in bf16 (MLA at 32 + 16 query and key dims
    and 16-wide values: K5's narrow-value route in every layer) on the
    card against the same model's plain versions on the CPU, and one K5
    launch a layer, each with narrow values, none copied."""
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b").reduced(),
                              dtype="bfloat16")
    model = DecoderModel(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(3), device="cpu")
    for leaf in (p_cpu["scan"]["b0_mla"]["moe"],):
        leaf["e_score_correction_bias"].normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(4))
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    tok = torch.randint(0, cfg.vocab, (2, 200),
                        generator=torch.Generator().manual_seed(5))
    before = _counts()
    with torch.inference_mode():
        got, _ = model.forward(p_gpu, tok.to(cuda))
        torch.cuda.synchronize()
        after = _counts()
        want, _ = model.forward(p_cpu, tok)
    n = cfg.n_layers
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2], after[3] - before[3]) == (n, n, n, 0)
    # bf16 on both sides: the card's kernels and the CPU's plain versions
    # round in other places; a routing flip moves one token's logits, so
    # the bulk is held at 5e-2 of the largest logit
    gap = (got.float().cpu() - want.float()).abs()
    assert torch.quantile(gap.flatten()[::7], 0.99) <= \
        5e-2 * want.float().abs().max()
