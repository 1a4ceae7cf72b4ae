"""The port's dry-run (``launch.dryrun``) on ``meta`` tensors: rank 0's
walk of every config at ``decode_32k`` on the single-pod mesh, each under a
time limit of its own, each ending with finite roofline terms and a
dominant one (the prefill, train and int8 walks and the CLI are in
``test_torch_roofline_report.py``); the placed mesh (``Mesh.at``) and the
collective recorder; and the ops' routes by device (``kernels.route``)."""
import contextlib
import math
import signal
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ALL_ARCHS
from repro_torch.distributed import collectives
from repro_torch.kernels.route import plain
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh

WALK_LIMIT_S = 60.0


@contextlib.contextmanager
def _deadline(seconds):
    def on_alarm(signum, frame):
        raise TimeoutError(f"the walk took more than {seconds} s")
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _check(res):
    assert res["compiled_ok"] and "skipped" not in res
    assert res["mesh"] == [16, 16] and res["cost"]["n_probes"] == 1
    r = res["roofline"]
    terms = (r["compute_s"], r["memory_s"], r["collective_s"], r["memory_floor_s"])
    assert all(math.isfinite(t) and t >= 0 for t in terms)
    assert r["dominant"] in ("compute", "memory", "collective") and r["compute_s"] > 0
    assert r["memory_floor_s"] <= r["memory_s"]        # the floor reads each byte once
    sizes, mem = res["sizes"], res["memory"]
    assert 0 < sizes["params_local_bytes"] <= mem["argument_bytes"]
    assert mem["temp_bytes"] > 0 and res["collectives"]["count"] > 0
    assert res["collectives"]["total"] == sum(
        res["collectives"][k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                                        "all-to-all", "collective-permute"))
    assert 0 < res["useful_ratio"] < math.inf and 0 < res["roofline_fraction"] <= 1.0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_walks_decode_32k(arch):
    with _deadline(WALK_LIMIT_S):
        res = dryrun.run_cell(arch, "decode_32k", multi_pod=False)
    _check(res)
    assert "cache_local_bytes" in res["sizes"]


def test_a_placed_mesh_stands_in_only_inside_the_recorder():
    mesh = make_production_mesh().at(37)
    assert not mesh.bound and mesh.coords == {"data": 2, "model": 5}
    assert mesh.index("model") == 5 and mesh.axis_ranks("model")[:2] == (32, 33)
    with pytest.raises(RuntimeError, match="not bound"):
        mesh.group("model")
    x = torch.arange(32.).reshape(2, 16)
    for fn in (lambda: collectives.psum(x, mesh, "model"),
               lambda: collectives.all_gather(x, mesh, "model", dim=1),
               lambda: collectives.reduce_scatter(x, mesh, "model", dim=1),
               lambda: collectives.all_to_all(x, mesh, "data")):
        with pytest.raises(RuntimeError, match="record_collectives"):
            fn()
    with collectives.record_collectives() as log:
        s = collectives.psum(x, mesh, "model")
        g = collectives.all_gather(x, mesh, "model", dim=1)
        r = collectives.reduce_scatter(x, mesh, "model", dim=1)
        a = collectives.all_to_all(x, mesh, "data")
        m = collectives.pmax(x, mesh, ("data", "model"))
        collectives.psum(x, Mesh((1, 4), ("data", "model")).at(1), "data")   # a size-1 axis
    assert torch.equal(s, x) and torch.equal(a, x) and torch.equal(m, x)
    assert torch.equal(g, torch.cat([x] * 16, dim=1))
    assert torch.equal(r, x[:, 5:6])                    # the rank's chunk (model index 5)
    assert log == [("all-reduce", 128, "model"), ("all-gather", 16 * 128, "model"),
                   ("reduce-scatter", 8, "model"), ("all-to-all", 128, "data"),
                   ("all-reduce", 128, "data"), ("all-reduce", 128, "model")]


def test_the_routes_by_device():
    assert plain(torch.empty(1), "op") and plain(torch.empty(1, device="meta"), "op")
    with pytest.raises(RuntimeError, match="no version for xpu"):
        plain(SimpleNamespace(device=torch.device("xpu")), "op")


def test_meta_tensors_take_the_plain_versions():
    """Each op on ``meta`` tensors returns a meta result of its shape (the
    plain version ran; a kernel launch would need a card)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm.ops import GroupedRows
    from repro_torch.kernels.paged_attention import chunked_prefill_attention, paged_attention
    from repro_torch.kernels.quant_matmul import w8a16_matmul
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked
    from repro_torch.quant.quantize import QuantizedLinear
    m = dict(device="meta")
    q = torch.empty(2, 8, 4, 16, **m)
    assert flash_attention(q, q, q).shape == q.shape
    pool = torch.empty(5, 4, 4, 16, **m)
    pt, ln = torch.empty(2, 2, dtype=torch.int32, **m), torch.empty(2, dtype=torch.int32, **m)
    assert paged_attention(q[:, 0], pool, pool, pt, ln).shape == (2, 4, 16)
    qp = torch.empty(2, 8, dtype=torch.int32, **m)
    assert chunked_prefill_attention(q, pool, pool, pt, ln, qp).shape == q.shape
    x = torch.empty(6, 16, **m)
    assert w8a16_matmul(x, torch.empty(16, 8, dtype=torch.int8, **m),
                        torch.empty(8, **m)).shape == (6, 8)
    w = QuantizedLinear(torch.empty(3, 16, 8, dtype=torch.int8, **m), torch.empty(3, 16, 1, **m))
    rows = GroupedRows(torch.empty(3, dtype=torch.int64, **m), x, sizes=[2, 2, 2])
    assert rows.unpack(rows.matmul(rows.pack(x), w)).shape == (6, 8)
    y, final = ssd_chunked(torch.empty(1, 8, 2, 4, **m), torch.empty(1, 8, 2, **m),
                           torch.empty(2, **m), torch.empty(1, 8, 1, 3, **m),
                           torch.empty(1, 8, 1, 3, **m), chunk=4)
    assert y.shape == (1, 8, 2, 4) and final.shape == (1, 2, 4, 3) and y.is_meta
