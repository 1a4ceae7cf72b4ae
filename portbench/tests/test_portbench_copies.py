"""The benchmark's frozen copies equal their sources on today's tree: the
traffic generator (``repro_torch.data.workload``), the H100 peaks
(``chip_smoke.py``, ``repro_torch.launch.roofline``), the per-kernel
operation and byte counts (``chip_smoke.py``), and the model's parameter
and matmul counts (``repro_torch.models.params``, and the port's plain path
under ``FlopCounterMode``)."""
from __future__ import annotations

import inspect
import json

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import roofline, traffic
from portbench.tests.conftest import PB, tiny_config
from portbench.weights import Shapes
from repro_torch.data import workload as src_workload

SPECS = [dict(n_requests=64, vocab=32000),
         dict(n_requests=40, vocab=102400, prompt_median=1024, prompt_sigma=0.6,
              max_prompt=8192, min_prompt=256, max_new_tokens=64),
         dict(n_requests=50, vocab=1000, scale=0.25, shared_prefix_len=16, n_shared_prefixes=3),
         dict(n_requests=50, vocab=1000, extractive_frac=0.3, boilerplate_frac=0.3),
         dict(n_requests=30, vocab=500, arrival_rate=4.0, burst_mult=3.0)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 17])
@pytest.mark.parametrize("kw", SPECS, ids=range(len(SPECS)))
def test_workload_copy_equals_source(kw, seed):
    mine = traffic.WorkloadSpec(seed=seed, **kw)
    theirs = src_workload.WorkloadSpec(seed=seed, **kw)
    p1, o1 = traffic.sample_workload(mine)
    p2, o2 = src_workload.sample_workload(theirs)
    assert o1 == o2
    assert len(p1) == len(p2) and all(np.array_equal(a, b) for a, b in zip(p1, p2))
    assert traffic.sample_arrivals(mine) == src_workload.sample_arrivals(theirs)


def test_stream_gives_every_seed_the_same_sizes():
    mix = json.load(open(PB / "traffic" / "chat64.json"))
    mix = dict(mix, blocks=3)
    a = traffic.build_stream(mix, 32000, 1)
    b = traffic.build_stream(mix, 32000, 2**31 + 5)
    B = mix["block"]
    for k in range(3):
        sa = sorted((len(r.prompt), r.max_new_tokens) for r in a[k * B:(k + 1) * B])
        sb = sorted((len(r.prompt), r.max_new_tokens) for r in b[k * B:(k + 1) * B])
        assert sa == sb
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    again = traffic.build_stream(mix, 32000, 1)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, again))


def test_peaks_equal_sources():
    from repro_torch.launch.roofline import H100_SXM
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S == H100_SXM["hbm_bw"]
    assert roofline.PEAK_FLOPS["bfloat16"] == chip_smoke.PEAK_FLOPS[torch.bfloat16] \
        == H100_SXM["peak_flops_bf16"]
    assert roofline.PEAK_FLOPS["float32"] == chip_smoke.PEAK_FLOPS[torch.float32] \
        == H100_SXM["peak_flops_fp32"]


@pytest.mark.parametrize("M,K,N,G", [(128, 4096, 4096, 32), (384, 4096, 1024, 8),
                                     (1, 14336, 4096, 1), (2000, 4096, 32000, 1)])
def test_w8a16_count_equals_source(M, K, N, G):
    b, f = roofline.w8a16_cost(M, K, N, G)
    want = chip_smoke.w8a16_bound(M, K, N, G, torch.bfloat16)
    assert roofline.bound_s(b, f)[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert roofline.bound_s(b, f)[1] == want[1]


def test_gmm_count_equals_source_text():
    """``chip_smoke.run_gmm_case`` computes its bound inline: the copy's
    arithmetic is its two lines, term for term."""
    src = inspect.getsource(chip_smoke.run_gmm_case)
    assert "wbytes = active * K * (N + 4) if int8 else active * K * N * es" in src
    assert "nbytes = (M * K + M * N) * es + wbytes + gs.numel() * gs.element_size()" in src
    assert "bound_ms(nbytes, 2.0 * M * K * N, dtype)" in src
    for int8 in (False, True):
        M, K, N, E, a = 768, 4096, 14336, 8, 7
        es = 2
        wbytes = a * K * (N + 4) if int8 else a * K * N * es
        nbytes = (M * K + M * N) * es + wbytes + E * 8
        assert roofline.gmm_cost(M, K, N, E, a, int8) == (nbytes, 2.0 * M * K * N)


@pytest.mark.parametrize("case", range(4))
def test_attention_count_equals_source(case):
    g = torch.Generator().manual_seed(case)
    B, C, H, Hkv, D, ps = [(4, 1, 32, 8, 128, 16), (3, 128, 32, 8, 128, 16),
                           (2, 512, 16, 16, 128, 16), (5, 1, 16, 16, 128, 16)][case]
    starts = torch.randint(0, 900, (B,), generator=g)
    nvalid = torch.randint(0, C + 1, (B,), generator=g)
    lengths = starts + nvalid
    qpos = starts[:, None] + torch.arange(C)[None]
    q = torch.zeros(B, C, H, D, dtype=torch.bfloat16)
    kp = torch.zeros(64, ps, Hkv, D, dtype=torch.bfloat16)
    want = chip_smoke.attention_bound(q, kp, lengths, qpos, torch.bfloat16)
    b, f = roofline.attention_cost(q.shape, ps, Hkv, 2, lengths, qpos)
    got = roofline.bound_s(float(b), float(f))
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12) and got[1] == want[1]


@pytest.mark.parametrize("name", ["mixtral-8x7b-int8", "deepseek-moe-16b-bf16"])
def test_parameter_count_equals_port(name):
    from portbench.system import port_config
    from repro_torch.models.params import count_params_analytic
    cfg = json.load(open(PB / "configs" / f"{name}.json"))
    assert Shapes.of(cfg).param_count() == count_params_analytic(port_config(cfg))


@pytest.mark.parametrize("name", ["mixtral-8x7b-int8", "deepseek-moe-16b-bf16"])
def test_model_count_equals_flop_counter(name, monkeypatch):
    """The model call's matmul operations, attention's aside, equal
    ``FlopCounterMode`` over the port's plain ``decode_chunk`` with
    attention stubbed out (the plain attention scores masked keys too);
    attention's own term is chunked attention's count of visible pairs."""
    from torch.utils.flop_counter import FlopCounterMode
    from portbench import system
    from repro_torch.models import LM, RunCtx
    from repro_torch.models import attention as attn_mod
    cfg = tiny_config(name, "bf16")
    s = Shapes.of(cfg)
    pcfg, params = system.port_params(cfg, 3, torch.device("cpu"), "bf16")
    params = {k: v for k, v in params.items()}
    model = LM(pcfg)
    B, C = 3, 8
    cache = model.init_cache(B, 64, torch.bfloat16, kind="paged", page_size=16, num_pages=16,
                             device="cpu")
    starts, nvalid = torch.tensor([0, 5, 0]), torch.tensor([8, 3, 0])
    monkeypatch.setattr(attn_mod, "chunked_prefill_attention",
                        lambda q, *a, **k: torch.zeros_like(q))
    pt = torch.arange(1, 13, dtype=torch.int32).view(3, 4)
    with FlopCounterMode(display=False) as fc:
        model.decode_chunk(params, torch.ones(B, C, dtype=torch.long), cache, starts, nvalid,
                           torch.arange(B), torch.zeros(B, dtype=torch.bool), RunCtx(), pt)
    counted = fc.get_total_flops()
    _, flops = roofline.model_call_cost(s, starts.tolist(), nvalid.tolist())
    pairs = sum(n * a + n * (n + 1) // 2 for a, n in zip(starts.tolist(), nvalid.tolist()) if n)
    attention = s.layers * 4.0 * s.heads * s.head_dim * pairs
    # the port computes every row of the fixed call shape: idle rows and
    # padding positions too, and the head on every row
    T_all = B * C
    T_live = int(nvalid.sum())
    per_token = (flops - attention - 2.0 * s.d * s.vocab * 2) / T_live
    assert counted == pytest.approx(per_token * T_all + 2.0 * s.d * s.vocab * B, rel=1e-9)
