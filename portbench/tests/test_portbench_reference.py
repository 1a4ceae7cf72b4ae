"""The plain reference against the port's plain path at tiny sizes, in
float32: logits of a prefill chunk and of decode steps through the paged
cache, on bf16 and on int8 weights (the port's own quantization against
the reference's, worked out again from the same draws)."""
from __future__ import annotations

import pytest
import torch

from portbench import system
from portbench.reference.model import Reference
from portbench.reference.quant import dequantized
from portbench.tests.conftest import tiny_config


def port_fp32(cfg, seed, weights):
    from repro_torch.models.params import map_tree
    from repro_torch.quant.quantize import QuantizedLinear
    pcfg, params = system.port_params(cfg, seed, torch.device("cpu"), weights)
    params = map_tree(lambda t: t if isinstance(t, QuantizedLinear) else t.float(), params,
                      is_leaf=lambda x: isinstance(x, QuantizedLinear))
    return pcfg, params


@pytest.mark.parametrize("name,weights", [("mixtral-8x7b-int8", "int8"),
                                          ("mixtral-8x7b-int8", "bf16"),
                                          ("deepseek-moe-16b-bf16", "bf16")])
def test_reference_matches_the_port_in_float32(name, weights):
    from repro_torch.models import LM, RunCtx
    cfg = tiny_config(name, weights)
    # the port renormalizes every router's top-k weights; deepseek's are
    # compared here with the reference's renormalization on, for the rest of
    # the model (the dense first layer, the shared experts)
    cfg["norm_topk_prob"] = True
    rule = cfg["serving"].get("quant_rule") or {"min_elems": 16384}
    pcfg, params = port_fp32(cfg, 21, weights)
    model = LM(pcfg)
    S, extra = 40, 3
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(1, cfg["vocab_size"], (1, S + extra), generator=g)
    cache = model.init_cache(1, 64, torch.float32, kind="paged", page_size=16, num_pages=8,
                             device="cpu")
    pt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    one = torch.ones(1, dtype=torch.long)
    got = []
    lg, _ = model.decode_chunk(params, toks[:, :S], cache, 0 * one, S * one, 0 * one,
                               torch.tensor([True]), RunCtx(), pt, all_logits=True)
    got.append(lg[0])
    for j in range(extra):          # decode steps through the pool
        lg, _ = model.decode_chunk(params, toks[:, S + j:S + j + 1], cache, (S + j) * one, one,
                                   0 * one, torch.tensor([False]), RunCtx(), pt)
        got.append(lg)
    got = torch.cat(got).float()
    ref = Reference(cfg, 21, "cpu", [weights], rule).logits([toks[0]], [list(range(S + extra))])
    ref = ref[weights][0]
    assert (got - ref).abs().max().item() < 1e-4 * max(1.0, ref.abs().max().item())


def test_int4_and_int8_follow_the_rule():
    w = torch.randn(32, 64).to(torch.bfloat16)
    rule = {"min_elems": 1024}
    for prec, qmax in (("int8", 127), ("int4", 7)):
        d = dequantized(w, prec, rule, 1)
        s = w.float().abs().amax(-1, keepdim=True) / qmax
        q = d / s
        assert torch.allclose(q, q.round(), atol=1e-4) and q.abs().max() <= qmax + 1e-4
    assert torch.equal(dequantized(w, "int8", {"min_elems": 10**6}, 1), w.float())
    assert torch.equal(dequantized(w[0], "int8", rule, 0), w[0].float())   # 1-D, alone
