"""The port's logical-axis sharding rules against the reference's: each
test of tests/test_sharding.py (divisibility fallback, axis-reuse exclusion,
priority, multi-pod batch, the hypothesis property) on the port, and the
port's ``param_partition_specs`` / ``cache_partition_specs`` equal to the
reference's entry for entry for all 11 configs on the production, multi-pod
and factored Exp4 meshes, under serve and train rules with the MoE on ep
and on tp; then the port's meshes, the rank's shard of a tree, ``constrain``
and the per-rank init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsharding
from repro.models import build_model as jax_build_model
from repro.models.params import param_specs as jax_param_specs
from repro_torch.configs import ALL_ARCHS as ARCHS, get_config, tiny_config
from repro_torch.distributed.sharding import (P, PartitionSpec, cache_partition_specs, constrain,
                                              local_shape, make_rules, param_partition_specs,
                                              partition_spec, shard, shard_tree, use_sharding)
from repro_torch.launch.mesh import Mesh, make_dev_mesh, make_moe_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.params import init_params, map_tree, param_specs


class FakeMesh:
    """Shape-only stand-in (no devices needed for spec computation)."""
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


M16 = FakeMesh({"data": 16, "model": 16})
RULES = make_rules("serve", moe="ep")


# ------------------------------------------------ tests/test_sharding.py's
def test_divisible_heads_shard():
    spec = partition_spec((4096, 32, 128), ("embed", "heads", "head_dim"), M16, RULES)
    assert spec == P(None, "model", None)


def test_indivisible_kv_heads_fall_back_to_seq():
    spec = partition_spec((36, 128, 32768, 2, 128),
                          ("layers", "batch", "kv_seq", "kv_heads", None), M16, RULES)
    assert spec == P(None, "data", "model", None, None)


def test_priority_kv_heads_beats_kv_seq():
    spec = partition_spec((46, 128, 32768, 16, 128),
                          ("layers", "batch", "kv_seq", "kv_heads", None), M16, RULES)
    assert spec == P(None, "data", None, "model", None)


def test_axis_never_reused():
    spec = partition_spec((16, 2048, 11008), ("experts", "embed", "mlp"), M16,
                          make_rules("serve", moe="ep"))
    used = [a for a in spec if a is not None]
    assert len(set(used)) == len(used)


def test_multi_pod_batch_uses_both_axes():
    mesh3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = partition_spec((256, 4096), ("batch", "seq"), mesh3,
                          make_rules("train", multi_pod=True))
    assert spec[0] == ("pod", "data")


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 512), st.integers(1, 64), st.integers(1, 64))
def test_spec_always_divides(dim0, dim1, dim2):
    spec = partition_spec((dim0, dim1, dim2), ("batch", "heads", "mlp"), M16, RULES)
    sizes = {"data": 16, "model": 16}
    for d, entry in zip((dim0, dim1, dim2), spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert d % int(np.prod([sizes[a] for a in axes])) == 0


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 512), st.integers(1, 64), st.integers(1, 4096))
def test_spec_equals_reference_property(dim0, dim1, dim2):
    """Any shape, the cache's logical axes on the Exp4 mesh: the same spec
    as the reference's."""
    mesh = FakeMesh({"data": 4, "expert": 2, "tensor": 4})
    logical = ("batch", "kv_heads", "kv_seq")
    for mode in ("serve", "train"):
        kw = dict(tensor_axis="tensor", expert_axis="expert")
        ours = partition_spec((dim0, dim1, dim2), logical, mesh, make_rules(mode, **kw))
        ref = jsharding.partition_spec((dim0, dim1, dim2), logical, mesh,
                                       jsharding.make_rules(mode, **kw))
        assert tuple(ours) == tuple(ref)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_param_specs_build_for_archs(arch):
    tree = param_partition_specs(param_specs(get_config(arch)), M16, RULES)
    leaves = []
    map_tree(leaves.append, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert leaves and all(isinstance(s, PartitionSpec) for s in leaves)


# ---------------------------------------------------- specs equal, 11 configs
MESHES = {
    "16x16": ({"data": 16, "model": 16}, {}),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, {"multi_pod": True}),
    "64x2x2": ({"data": 64, "expert": 2, "tensor": 2},
               {"tensor_axis": "tensor", "expert_axis": "expert"}),
    "32x4x2": ({"data": 32, "expert": 4, "tensor": 2},
               {"tensor_axis": "tensor", "expert_axis": "expert"}),
}
RULE_KINDS = [(mode, moe) for mode in ("serve", "train") for moe in ("ep", "tp")]


def _spec_leaves(tree, spec_type):
    out = []
    if spec_type is PartitionSpec:
        map_tree(out.append, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    else:
        out = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, spec_type))
    return [tuple(s) for s in out]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_reference(arch, mesh_name):
    sizes, kw = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    cfg = get_config(arch)
    jmodel, model = jax_build_model(jax_get_config(arch)), build_model(cfg)
    mem = cfg.encoder.cross_attn_memory if cfg.encoder is not None else 0
    jcaches = {kind: jax.eval_shape(lambda kind=kind: jmodel.init_cache(
        128, 4096, jnp.bfloat16, kind=kind, page_size=16, num_pages=1024, memory_len=mem))
        for kind in ("dense", "paged")}
    caches = {kind: model.init_cache(128, 4096, torch.bfloat16, kind=kind, page_size=16,
                                     num_pages=1024, memory_len=mem, device="meta")
              for kind in ("dense", "paged")}
    jspec_type = jax.sharding.PartitionSpec
    for mode, moe in RULE_KINDS:
        rules, jrules = make_rules(mode, moe, **kw), jsharding.make_rules(mode, moe, **kw)
        ours = _spec_leaves(param_partition_specs(param_specs(cfg), mesh, rules), PartitionSpec)
        ref = _spec_leaves(jsharding.param_partition_specs(jax_param_specs(jax_get_config(arch)),
                                                           mesh, jrules), jspec_type)
        assert len(ours) == len(ref) > 0 and ours == ref, (mode, moe)
        for kind in ("dense", "paged"):
            ours = _spec_leaves(cache_partition_specs(caches[kind], mesh, rules), PartitionSpec)
            ref = _spec_leaves(jsharding.cache_partition_specs(jcaches[kind], mesh, jrules),
                               jspec_type)
            assert len(ours) == len(ref) > 0 and ours == ref, (mode, moe, kind)


# ------------------------------------------------------------ meshes, shards
def test_meshes_mirror_the_reference():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert dict(make_production_mesh(multi_pod=True).shape) == {"pod": 2, "data": 16,
                                                                 "model": 16}
    m = make_moe_mesh(4, 2, chips=8)
    assert m.axis_names == ("data", "expert", "tensor") and m.devices.shape == (1, 4, 2)
    assert make_dev_mesh(2, 1).size == 2
    with pytest.raises(ValueError):
        make_moe_mesh(3, 2, chips=8)
    assert not m.bound
    with pytest.raises(RuntimeError, match="not bound"):
        m.group("tensor")


def _bound(shape, names, rank):
    """A mesh with ``rank``'s coordinates set, as ``bind`` would set them
    (no process group needed to slice)."""
    m = Mesh(shape, names)
    m.rank = rank
    m.coords = dict(zip(names, (int(i) for i in np.unravel_index(rank, shape))))
    return m


def test_axis_ranks_walk_one_axis_through_the_rank():
    m = _bound((2, 2, 2), ("data", "expert", "tensor"), 5)     # coords (1, 0, 1)
    assert m.coords == {"data": 1, "expert": 0, "tensor": 1}
    assert m.axis_ranks("data") == (1, 5) and m.axis_ranks("expert") == (5, 7)
    assert m.axis_ranks("tensor") == (4, 5)
    assert m.index(("data", "tensor")) == 3 and m.count(("expert", "tensor")) == 4


@pytest.mark.parametrize("rank", range(8))
def test_shards_tile_the_tensor(rank):
    """Every rank's shard of a tensor split on two axes (one a pair) sits
    where the spec's row-major order puts it, numpy and torch alike, and
    ``local_shape`` is its shape."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    x = np.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = P(("pod", "data"), None, "model")
    m = _bound(shape, names, rank)
    part = shard(x, spec, m)
    i = m.coords["pod"] * 2 + m.coords["data"]
    np.testing.assert_array_equal(part, x[2 * i:2 * i + 2, :, 2 * m.coords["model"]:][:, :, :2])
    assert part.shape == local_shape(x.shape, spec, m)
    t = shard(torch.from_numpy(x), spec, m)
    assert torch.equal(t, torch.from_numpy(part)) and t.is_contiguous()


def test_constrain_checks_the_local_shard():
    m = _bound((1, 2, 2), ("data", "expert", "tensor"), 3)
    rules = make_rules("serve", tensor_axis="tensor", expert_axis="expert")
    x = torch.zeros(2, 5, 2, 16)
    assert constrain(x, ("batch", None, "heads", None), (2, 5, 4, 16)) is x     # no rules: as is
    with use_sharding(m, rules):
        assert constrain(x, ("batch", None, "heads", None), (2, 5, 4, 16)) is x
        with pytest.raises(ValueError, match="not the shard"):
            constrain(x, ("batch", None, "heads", None), (2, 5, 8, 16))


@pytest.mark.parametrize("moe", ["ep", "tp"])
def test_rank_init_is_the_slice_of_the_whole(moe):
    """``init_params`` for one rank equals that rank's slice of the whole
    seeded init, leaf for leaf, and ``shard_tree`` of the whole gives it."""
    cfg = tiny_config("deepseek-moe-16b")
    rules = make_rules("serve", moe, tensor_axis="tensor", expert_axis="expert")
    whole = init_params(cfg, 3, device="cpu")
    for rank in range(4):
        m = _bound((1, 2, 2), ("data", "expert", "tensor"), rank)
        specs = param_partition_specs(param_specs(cfg), m, rules)
        mine = init_params(cfg, 3, device="cpu", mesh=m, rules=rules)
        sliced = shard_tree(whole, specs, m)
        a, b = [], []
        map_tree(a.append, mine)
        map_tree(b.append, sliced)
        assert len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
    assert mine["groups"][1]["layers"][0]["moe"]["wg"].shape == (
        (2, 2, 64, 32) if moe == "ep" else (2, 4, 64, 32))


@pytest.mark.parametrize("module", ["repro_torch.distributed.collectives",
                                    "repro_torch.distributed.sharding",
                                    "repro_torch.distributed.ranks", "repro_torch.launch.mesh"])
def test_distribution_modules_import_first(module):
    """Each distribution module imports in a fresh interpreter before the
    models do (the models import them: no import cycle)."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", f"import {module}; import repro_torch.models"],
                         capture_output=True, text=True, env={"PYTHONPATH": str(src), "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stderr
