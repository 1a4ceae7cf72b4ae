"""The examples' torch twins (``examples/*_torch.py``) run end to end on the
CPU at their tiny configs, each under a time limit: quickstart's greedy
tokens equal a direct ``InferenceEngine.generate`` on the same weights;
the serving driver and the dynamic load balancer finish every request,
and the ``dynamic`` policy sends the concurrency-2 sweep to the high-TP
class (paper §6)."""
import importlib
from pathlib import Path

import pytest

from test_torch_dryrun import _deadline

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LIMIT_S = 120.0


@pytest.fixture
def examples(monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLES))
    return lambda name: importlib.import_module(name)


def test_quickstart_streams_equal_the_engine_s(examples, capsys):
    from repro_torch.core import EngineConfig, InferenceEngine
    from repro_torch.models import build_model
    qs = examples("quickstart_torch")
    with _deadline(LIMIT_S):
        reqs = qs.main(["--device", "cpu", "--arch", "mixtral-8x7b", "--max-new", "6"])
    assert "generated 18 tokens" in capsys.readouterr().out
    model = build_model(qs.tiny_config("mixtral-8x7b"))
    engine = InferenceEngine(model, model.init_params(0, device="cpu"), EngineConfig(
        max_slots=2, page_size=8, num_pages=128, max_seq=128, greedy=True, device="cpu"))
    direct = qs.make_requests(model.cfg, 6)
    engine.generate(direct)
    assert [r.generated for r in reqs] == [r.generated for r in direct]
    assert all(len(r.generated) == 6 for r in reqs)


def test_serve_endpoint_finishes_every_request(examples):
    se = examples("serve_endpoint_torch")
    with _deadline(LIMIT_S):
        out = se.main(["--device", "cpu", "--requests", "6", "--concurrency", "3",
                       "--max-new", "3"])
    assert sorted(out) == ["baseline", "scale"]
    for name, (summary, reqs) in out.items():
        assert len(reqs) == 6 and all(r.n_generated == 3 for r in reqs), name
        assert summary.throughput_tok_s > 0


def test_dynamic_policy_sends_low_concurrency_to_high_tp(examples):
    dl = examples("dynamic_load_balancing_torch")
    with _deadline(LIMIT_S):
        out = dl.main(["--device", "cpu", "--concurrency", "2", "16", "--max-new", "2"])
    for (c, policy), (summary, classes, reqs) in out.items():
        assert len(reqs) == 2 * c and all(r.n_generated == 2 for r in reqs), (c, policy)
        assert sum(classes.values()) == 2 * c
    assert set(out[(2, "dynamic")][1]) == {"high_tp"}
