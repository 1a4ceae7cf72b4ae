"""The port's launch tools against the JAX package's: ``model_flops`` for
every config and shape, ``local_bytes`` on the reference test's tree and on
an int8 tree, the rank's ``params_local_bytes`` of the dry-run's cell for
every config on the (16, 16) and (2, 16, 16) meshes under the serve rules
(float and int8) and the train rules, against the reference's
``local_bytes`` of its abstract (and ``_quantize_abstract``'d) tree; the
report's tables on the same cells; the roofline terms with the H100's
figures; ``collective_bytes`` on a recorder's log. And the dry-run's meta
walks of mixtral-8x7b and qwen2.5-3b at ``prefill_32k`` and ``train_4k``
under the sequence-parallel rule (mixtral's MoE on ep), of mixtral's int8
decode cell, and the CLI's JSON read by the report (the decode walks of
every config are in ``test_torch_dryrun.py``)."""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsharding
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.models import build_model as jax_build_model
from repro.models.params import param_specs as jax_param_specs
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import tree_leaves
from repro_torch.quant.quantize import QuantizedLinear
from test_torch_dryrun import WALK_LIMIT_S, _check, _deadline


class FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((4, 2))


class FakeNamed:
    """Shape-only stand-in for ``NamedSharding``."""
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _quantize_abstract():
    """The reference dry-run's ``_quantize_abstract``, its source compiled
    alone: importing ``repro.launch.dryrun`` sets XLA_FLAGS to 512 devices
    for the whole process."""
    path = Path(jsharding.__file__).parents[1] / "launch" / "dryrun.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "_quantize_abstract")
    ns = {"jax": jax}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["_quantize_abstract"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_equal_the_reference_s(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == jroofline.model_flops(jcfg, shape), name


def test_local_bytes_equal_the_reference_s():
    """The reference test's tree and specs, and an int8 leaf (q int8 by
    the float spec, its scale by that spec with the last entry None)."""
    import torch
    tree = {"w": torch.empty((8, 16), dtype=torch.float32, device="meta")}
    jtree = {"w": jax.ShapeDtypeStruct((8, 16), np.dtype("float32"))}
    for ours, ref in ((P(None, None), JP(None, None)), (P(None, "model"), JP(None, "model")),
                      (P("data", "model"), JP("data", "model")), (P(("data", "model"), None),
                                                                  JP(("data", "model"), None))):
        assert roofline.local_bytes(tree, {"w": ours}, FakeMesh()) == jroofline.local_bytes(
            jtree, {"w": ref}, FakeMesh())
    q = {"w": QuantizedLinear(torch.empty((8, 16), dtype=torch.int8, device="meta"),
                              torch.empty((8, 1), dtype=torch.float32, device="meta"))}
    assert roofline.local_bytes(q, {"w": P("data", "model")}, FakeMesh()) == (
        8 * 16 // 8 + 8 // 4 * 4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_local_bytes_equal_the_reference_s(arch, monkeypatch):
    """The dry-run's ``sizes.params_local_bytes`` of rank 0's cell (the
    tree of its meta shards' global shapes over their specs) against the
    reference's ``local_bytes(abstract_params(cfg, dtype), specs)``: serve
    rules on bf16 and on the int8 tree (``_quantize_abstract``), train
    rules on float32, MoE on tp, on both production meshes."""
    monkeypatch.setattr(jax.sharding, "NamedSharding", FakeNamed)
    quantize_abstract = _quantize_abstract()
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmodel = jax_build_model(jcfg)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for shape_name, quant in (("decode_32k", "none"), ("decode_32k", "int8"),
                                  ("train_4k", "none")):
            shape = SHAPES[shape_name]
            mode = "train" if shape.kind == "train" else "serve"
            jspecs = jsharding.param_partition_specs(
                jax_param_specs(jcfg), mesh, jsharding.make_rules(mode, moe="tp",
                                                                   multi_pod=multi_pod))
            abstract = jmodel.abstract_params(jnp.float32 if mode == "train" else jnp.bfloat16)
            if quant == "int8":
                p_sh = jax.tree.map(lambda sp: FakeNamed(mesh, sp), jspecs,
                                    is_leaf=lambda x: isinstance(x, JP))
                abstract, jspecs = quantize_abstract(abstract, p_sh)
            want = jroofline.local_bytes(abstract, jspecs, mesh)
            cell = build_cell(cfg, shape, mesh, moe_mode="tp", quant=quant, device="meta")
            assert cell.sizes["params_local_bytes"] == want, (multi_pod, shape_name, quant)
            # and the rank's meta shards hold exactly those bytes
            held = sum(t.numel() * t.element_size() for t in tree_leaves(cell.args[0]))
            assert held == want


def _cells():
    """Dry-run JSONs as both packages write them: a cost cell (tp and ep),
    a skipped one, a compile-only multi-pod one, an int8, a seq_shard and a
    hillclimb (xent_chunk) variant, whose tables must leave them out."""
    def cell(arch, shape, **kw):
        d = {"arch": arch, "shape": shape, "multi_pod": False, "mode": "decode", "moe": None,
             "seq_shard": False, "quant": "none", "exp4": None, "xent_chunk": 0,
             "microbatches": 1, "mesh": [16, 16], "lower_s": 1.25, "compile_s": 0.0,
             "sizes": {"params_local_bytes": 6343630848, "cache_local_bytes": 2149580800},
             "memory": {"argument_bytes": 8493211712, "output_bytes": 8192000,
                        "temp_bytes": 8704516},
             "compiled_ok": True,
             "collectives": {"all-gather": 65536, "all-reduce": 4194304, "reduce-scatter": 0,
                             "all-to-all": 0, "collective-permute": 0, "count": 291,
                             "total": 4259840},
             "cost": {"flops": 5.9e10, "bytes_accessed": 1.43e10, "n_probes": 1},
             "roofline": {"compute_s": 5.98e-05, "memory_s": 0.00427, "collective_s": 1.5e-4,
                          "dominant": "memory", "memory_floor_s": 0.00253},
             "model_flops_global": 3.3e12, "model_flops_per_dev": 1.29e10,
             "useful_ratio": 0.218, "roofline_fraction": 0.00304}
        d.update(kw)
        return d
    no_cost = {k: None for k in ("cost", "roofline")}
    out = [cell("mixtral-8x7b", "decode_32k", moe="tp"),
           cell("mixtral-8x7b", "decode_32k", moe="ep", lower_s=2.5),
           cell("qwen2.5-3b", "train_4k", mode="train", memory={
               "argument_bytes": 190000000, "output_bytes": 64, "temp_bytes": 1.8e11}),
           {"arch": "qwen2.5-3b", "shape": "long_500k", "multi_pod": False, "mode": "decode",
            "moe": None, "seq_shard": False, "quant": "none", "exp4": None, "xent_chunk": 0,
            "microbatches": 1, "skipped": "pure full-attention arch: 524k context not "
                                          "deployable (skip per DESIGN.md)"},
           cell("gemma2-27b", "prefill_32k", multi_pod=True, mesh=[2, 16, 16]),
           cell("mixtral-8x7b", "decode_32k", moe="tp", quant="int8"),
           cell("qwen2.5-3b", "prefill_32k", seq_shard=True),
           cell("yi-6b", "train_4k", xent_chunk=512)]
    for k in no_cost:                                  # the multi-pod cell: no cost probes
        out[4].pop(k)
    out[4]["collectives"] = {}
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("kind", ["roofline-tp", "roofline-ep", "dryrun"])
def test_report_tables_equal_the_reference_s(kind):
    cells = _cells()
    if kind == "dryrun":
        got, want = report.dryrun_table(cells), jreport.dryrun_table(cells)
    else:
        moe = kind.split("-")[1]
        got = report.roofline_table(cells, moe=moe)
        want = jreport.roofline_table(cells, moe=moe)
    assert got == want and got.count("\n") >= 3


def test_load_cells_reads_the_directory(tmp_path):
    for i, d in enumerate(_cells()[:3]):
        (tmp_path / f"c{i}.json").write_text(json.dumps(d))
    got, want = report.load_cells(str(tmp_path)), jreport.load_cells(str(tmp_path))
    assert got == want and [d["_file"] for d in got] == ["c0.json", "c1.json", "c2.json"]


def test_roofline_terms_on_the_h100_figures():
    """The reference test's cases with the H100's peaks: 1 s compute, 1 s
    memory, 0.5 s collective; then a collective-bound case."""
    hw = roofline.H100_SXM
    assert hw["name"] == "NVIDIA H100 SXM (data sheet, 700 W)"
    t = roofline.roofline(989e12, 3.35e12, 225e9)
    assert abs(t.compute_s - 1.0) < 1e-9 and abs(t.memory_s - 1.0) < 1e-9
    assert abs(t.collective_s - 0.5) < 1e-9
    assert t.as_dict()["dominant"] in ("compute", "memory")
    t2 = roofline.roofline(1e12, 1e9, 100e9)
    assert t2.dominant == "collective" and t2.bound_s == t2.collective_s


def test_collective_bytes_sums_the_log_as_the_hlo_parser_does():
    log = [("all-gather", 16 * 512 * 2048 * 2, "model"), ("all-reduce", 1024 * 688 * 4, "model"),
           ("all-to-all", 16 * 8 * 6144 * 2, "data"), ("reduce-scatter", 64 * 4, "model"),
           ("all-reduce", 8, "data")]
    out = roofline.collective_bytes(log)
    assert set(out) == set(jroofline.parse_collective_bytes(""))
    assert out["all-gather"] == 16 * 512 * 2048 * 2
    assert out["all-reduce"] == 1024 * 688 * 4 + 8
    assert out["reduce-scatter"] == 256 and out["collective-permute"] == 0
    assert out["count"] == 5 and out["total"] == sum(n for _, n, _ in log)


def test_no_tpu_figure_in_the_port_s_launch_tools():
    src = Path(roofline.__file__).parent
    for name in ("roofline.py", "dryrun.py", "report.py"):
        text = (src / name).read_text()
        assert "V5E" not in text and "197e12" not in text and "819e9" not in text, name


@pytest.mark.parametrize("arch,shape,moe", [
    ("mixtral-8x7b", "prefill_32k", "ep"), ("qwen2.5-3b", "prefill_32k", "tp"),
    ("mixtral-8x7b", "train_4k", "ep"), ("qwen2.5-3b", "train_4k", "tp")])
def test_prefill_and_train_walk_under_the_sequence_parallel_rule(arch, shape, moe):
    with _deadline(WALK_LIMIT_S):
        res = dryrun.run_cell(arch, shape, multi_pod=False, moe_mode=moe, seq_shard=True)
    _check(res)
    assert res["collectives"]["reduce-scatter"] > 0 and res["seq_shard"]
    # mixtral's 8 experts do not split over 16 data ranks: ep runs the TP
    # body, no all-to-all (the reference's ``moe_sublayer`` rule)
    assert res["collectives"]["all-to-all"] == 0
    if shape == "train_4k":               # the moments and the step ride along
        assert res["memory"]["argument_bytes"] > 3 * res["sizes"]["params_local_bytes"]


def test_the_int8_decode_cell_walks_the_int8_tree():
    with _deadline(WALK_LIMIT_S):
        f = dryrun.run_cell("mixtral-8x7b", "decode_32k", multi_pod=False, skip_cost=True)
        q = dryrun.run_cell("mixtral-8x7b", "decode_32k", multi_pod=False, quant="int8")
    _check(q)
    assert "cost" not in f and f["compiled_ok"]
    ratio = q["sizes"]["params_local_bytes"] / f["sizes"]["params_local_bytes"]
    assert 0.5 < ratio < 0.55                           # int8 values plus fp32 row scales


def test_the_cli_writes_the_reference_s_tag_and_the_report_reads_it(tmp_path, capsys):
    with _deadline(WALK_LIMIT_S):
        assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out",
                            str(tmp_path)]) == 0
        assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--out",
                            str(tmp_path), "--seq-shard"]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["mamba2-1.3b__long_500k__single__tp.json",
                     "qwen2.5-3b__long_500k__single__tp__seqshard.json"]
    cells = report.load_cells(str(tmp_path))
    table = report.roofline_table(cells)
    assert "| mamba2-1.3b | long_500k | **" in table     # the seq_shard cell is left out
    assert "qwen2.5-3b" not in table
    assert "SKIP" in report.dryrun_table([dict(c, seq_shard=False) for c in cells])
