"""The dropless MoE path on the card: ``torch._grouped_mm`` over the
experts' runs against a plain loop over the experts, at Moonlight's
published widths in bf16.

Marked ``gpu``: without a CUDA device every test skips.  Run on a machine
with a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_dropless_gpu.py
"""

import pytest
import torch

from repro_torch.configs import moonlight_16b_a3b
from repro_torch.models import moe

pytestmark = pytest.mark.gpu

T = 4096                 # a wave of 64 rows of 64 positions


@pytest.fixture
def layer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = moonlight_16b_a3b.full_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p = moe.init_moe(cfg.moe, cfg.d_model, torch.bfloat16, device="cuda",
                     generator=gen)
    p["score_bias"].normal_(generator=gen).mul_(0.05)
    x = torch.randn((T, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    real = torch.rand(T, generator=gen, device="cuda") < 0.7
    return cfg.moe, p, x, real


def test_grouped_products_equal_a_loop_over_the_experts(layer):
    """The same routing; each real token's routed rows through its
    experts one expert at a time, summed in f32 in choice order, and the
    shared experts: equal within bf16 rounding of the products (the
    grouped kernel and a per-expert product may sum in another order).
    Pads get the shared experts alone, bit for bit."""
    cfg, p, x, real = layer
    got = moe.moe_ffn_dropless(p, x, cfg, real).y
    _s, gates, ids = moe._router(p, x, cfg)
    out = torch.zeros((T, cfg.top_k, x.shape[1]), device="cuda")
    for e in range(cfg.n_experts):
        tok, slot = ((ids == e) & real[:, None]).nonzero(as_tuple=True)
        if tok.numel():
            out[tok, slot] = moe._swiglu(x[tok], p["wi"][e],
                                         p["wo"][e]).float()
    routed = torch.zeros((T, x.shape[1]), device="cuda")
    for kk in range(cfg.top_k):
        routed = routed + out[:, kk] * gates[:, kk, None]
    shared = moe._swiglu(x, p["shared_wi"], p["shared_wo"])
    want = routed.to(torch.bfloat16) + shared
    err = (got.float() - want.float()).pow(2).mean().sqrt()
    assert err <= 2e-3 * want.float().pow(2).mean().sqrt()
    assert torch.equal(got[~real], shared[~real])


def test_two_calls_agree_bit_for_bit(layer):
    cfg, p, x, real = layer
    a = moe.moe_ffn_dropless(p, x, cfg, real).y
    b = moe.moe_ffn_dropless(p, x, cfg, real).y
    assert torch.equal(a, b)
