"""Distributed serving on gloo CPU ranks against the JAX package.

The port's side runs on four spawned ranks (``distributed.ranks``,
``tests/torch_dist_worker.py``); the reference's in one child process whose
environment alone sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/torch_dist_reference.py``); both from the same numpy inputs, at
once. Held:

- the MoE layer: ``tp_shardmap`` on meshes (data, expert, tensor) = (1, 1,
  2), (1, 1, 4) and (2, 1, 2) (the batch split), ``ep_shardmap`` on (1, 2,
  1), (1, 2, 2) and (1, 4, 1), with ``quant="a2a_int8"`` too, tiny mixtral
  and tiny deepseek-moe (shared experts), capacity factors 1.25 and 0.5
  (where ep_shardmap's drops part it from "capacity"), against the
  reference's strategy on a mesh of the same shape within 1e-5, aux equal;
- the whole slice: tiny mixtral, gemma2 (window, softcaps, tied head),
  qwen2.5 (QKV bias) and dbrx at (1, 2, 2) with ep_shardmap and (2, 1, 2)
  with tp_shardmap, capacity factor E / K: ``prefill``, ``decode_step``
  over the dense ring (split on the expert axis at (1, 2, 2)) and over the
  paged pool, ``decode_chunk`` (a ragged pack, then a verify sweep with
  ``all_logits``) against the JAX package's unsharded calls on the same
  parameters within LOGIT_ATOL, greedy tokens equal;
- the same paths where the tensor axis outgrows the kv heads (the
  reference's kv_seq layout: tiny qwen2.5 and mixtral, 2 kv heads, at (1, 1,
  4) with tp_shardmap: the ring split on the sequence over tensor, the pool
  whole), and with mamba layers (tiny mamba2 at (1, 1, 2), (1, 1, 4) and (2,
  1, 2); tiny jamba at (1, 2, 2) with ep_shardmap and at (1, 1, 4) with
  tp_shardmap, where kv_seq, mamba and the MoE meet);
- the enc-dec and VLM families: tiny seamless at (2, 1, 2) (the encoder,
  the cross cache's rows split on data) and at (1, 1, 4) (kv_seq: every
  rank projects both kv heads of the encoder, the cross attention and the
  decoder), tiny phi-3-vision at (1, 1, 2), through the same paths with 12
  frames a row (the batch's, the pack's) or the patch prefix;
- what raises under a mesh: int8 trees, the int8 all-to-all under grad.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))          # the spawned ranks import torch_dist_worker by name

import torch_dist_worker  # noqa: E402
from repro_torch.distributed.ranks import spawn_ranks  # noqa: E402
from repro_torch.distributed.sharding import make_rules, use_sharding  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import RunCtx, build_model  # noqa: E402
from repro_torch.models.moe import moe_sublayer  # noqa: E402

LOGIT_ATOL = 2e-3                      # as tests/test_chunked_prefill.py
MOE_TOL = 1e-5                         # tests/test_moe.py:37
MOE_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
MOE_CASES = [(arch, "tp_shardmap", shape, cf, "none")
             for arch in MOE_ARCHS for shape in ((1, 1, 2), (1, 1, 4), (2, 1, 2))
             for cf in (1.25, 0.5)]
MOE_CASES += [(arch, "ep_shardmap", shape, cf, quant)
              for arch in MOE_ARCHS for shape in ((1, 2, 1), (1, 2, 2), (1, 4, 1))
              for cf in (1.25, 0.5) for quant in ("none", "a2a_int8")]
MODEL_CASES = [(arch, shape, strategy)
               for arch in ("mixtral-8x7b", "gemma2-27b", "qwen2.5-3b", "dbrx-132b")
               for shape, strategy in (((1, 2, 2), "ep_shardmap"), ((2, 1, 2), "tp_shardmap"))]
MODEL_CASES += [("qwen2.5-3b", (1, 1, 4), "tp_shardmap"),        # kv_seq: kv 2 at tensor 4
                ("mixtral-8x7b", (1, 1, 4), "tp_shardmap"),
                ("mamba2-1.3b", (1, 1, 2), "tp_shardmap"),
                ("mamba2-1.3b", (1, 1, 4), "tp_shardmap"),
                ("mamba2-1.3b", (2, 1, 2), "tp_shardmap"),
                ("jamba-v0.1-52b", (1, 2, 2), "ep_shardmap"),
                ("jamba-v0.1-52b", (1, 1, 4), "tp_shardmap"),    # kv_seq, mamba and the MoE
                ("seamless-m4t-large-v2", (2, 1, 2), "tp_shardmap"),   # encoder, cross cache
                ("seamless-m4t-large-v2", (1, 1, 4), "tp_shardmap"),   # ... under kv_seq
                ("phi-3-vision-4.2b", (1, 1, 2), "tp_shardmap")]       # the patch prefix
MODEL_ARCHS = tuple(sorted({c[0] for c in MODEL_CASES}))
PATHS = ("prefill", "ring0", "ring1", "pack", "paged0", "paged1", "verify")


def _io():
    """The model paths' inputs: 2 prompts of 20 tokens (gemma2's window of
    16 bites), 2 decode steps on each cache, a ragged pack of 20 / 13
    tokens, a verify sweep of 3 / 2; and each arch's extras: (12 frames a
    row for an enc-dec config, the patches for a VLM, as the batch's
    ``frames`` / ``patches`` and the pack's; the cross memory's length;
    the patch offset the decode steps' positions count), the pages 40
    positions a row (the VLM's 8 patches ahead of the verify sweep's 25)."""
    r = np.random.default_rng(11)
    B, S, ps, maxp = 2, 20, 4, 10
    tok = lambda *shape: r.integers(1, 256, shape).astype(np.int32)  # noqa: E731
    pt = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp)
    nv = np.asarray([20, 13], np.int32)
    extras, rx = {}, np.random.default_rng(12)
    for arch in MODEL_ARCHS:
        cfg, ext = jax_tiny_config(arch), {}
        if cfg.encoder is not None:
            ext["frames"] = rx.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
        if cfg.vision is not None:
            ext["patches"] = rx.standard_normal(
                (B, cfg.vision.n_patches, cfg.vision.d_patch)).astype(np.float32)
        extras[arch] = (ext, 12 if cfg.encoder is not None else 0,
                        cfg.vision.n_patches if cfg.vision is not None else 0)
    return {
        "prompt": tok(B, S), "max_seq": 32, "ps": ps, "num_pages": 1 + B * maxp,
        "extras": extras,
        "ring_steps": [(tok(B, 1), np.full(B, S + i, np.int32)) for i in range(2)],
        "pack": (tok(B, S), np.zeros(B, np.int32), nv, pt),
        "paged_steps": [(tok(B, 1), nv + i) for i in range(2)],
        "verify": (tok(B, 3), nv + 2, np.asarray([3, 2], np.int32)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = {a: to_np(jax_build_model(jax_tiny_config(a)).init_params(jax.random.PRNGKey(0)))
              for a in sorted(set(MODEL_ARCHS) | set(MOE_ARCHS))}
    moe_params = {}
    for a in MOE_ARCHS:
        lay = next(lay for g in params[a]["groups"] for lay in g["layers"] if "moe" in lay)
        moe_params[a] = jax.tree.map(lambda x: x[0], lay["moe"])
    h = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(np.float32)
    inputs = d / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"moe_cases": MOE_CASES, "model_cases": MODEL_CASES, "params": params,
                     "moe_params": moe_params, "moe_h": h, "io": _io()}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"), env.get("PYTHONPATH", "")])
    child = subprocess.Popen([sys.executable, str(HERE / "torch_dist_reference.py"), str(inputs),
                              str(d / "ref.pkl")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn_ranks(torch_dist_worker.run_all, 4, (str(inputs),), store_dir=d / "ranks",
                           timeout_s=240)
        log, _ = child.communicate(timeout=240)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, port


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_shardmap_matches_reference_mesh(runs, case):
    """Each rank holds what the reference's device at its mesh position
    holds: the rows of each data shard as that shard's device at the rank's
    (expert, tensor) coordinates computed them, and the aux. The reference
    runs shard_map with ``check_rep=False``, so an output its specs call
    replicated need not be one value: the aux is pmean'd over ep and tp
    only (each data shard's own), and where ``ep_shardmap`` drops (capacity
    factor 0.5) the ranks along the expert axis, which hold the same
    tokens, send the same rows twice and drop different copies (0.5 max
    abs apart in the outputs)."""
    ref, port = runs
    y_dev, aux_dev = ref["moe"][case]
    shape = case[2]
    positions = np.arange(int(np.prod(shape))).reshape(shape)
    for rank in range(positions.size):
        y, aux, drops = port[rank]["moe"][case]
        _, e, t = np.unravel_index(rank, shape)
        rows = y.shape[0] // shape[0]                  # the batch splits on data (B = 2)
        for d in range(shape[0]):
            np.testing.assert_allclose(y[d * rows:(d + 1) * rows], y_dev[positions[d, e, t]],
                                       atol=MOE_TOL, rtol=0)
        assert aux == pytest.approx(aux_dev[rank], rel=1e-6, abs=1e-7)
        if case[1] == "ep_shardmap" and case[3] == 0.5:
            assert drops > 0               # 64 assignments, 32 dispatch slots
        if case[1] == "ep_shardmap" and case[3] == 0.5:
            assert drops > 0               # 64 assignments, 32 dispatch slots


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_sharded_paths_match_unsharded_jax(runs, case):
    ref, port = runs
    want = ref["model"][case[0]]
    valid = np.arange(3)[None, :] < np.asarray([3, 2])[:, None]
    for rank in range(int(np.prod(case[1]))):     # the ranks the case's mesh binds
        got = port[rank]["model"][case]
        for path in PATHS:
            a, b = got[path], want[path]
            if path == "verify":
                a, b = a[valid], b[valid]
            assert a.shape == b.shape and np.isfinite(a).all(), path
            err = np.abs(a - b).max()
            assert err < LOGIT_ATOL, (path, rank, err)
            np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1), err_msg=path)


@pytest.mark.parametrize("case", [c for c in MODEL_CASES if c[1][0] > 1 and c[0] in (
    "mamba2-1.3b", "seamless-m4t-large-v2")], ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_a_pack_row_outside_its_rank_s_slot_block_is_refused(runs, case):
    """Under a batch split the SSM states and the cross cache hold the
    slots of each rank's batch block: a pack whose rows name each other's
    slots raises on every rank, naming the block."""
    _, port = runs
    for rank in range(int(np.prod(case[1]))):
        assert "its block of the" in port[rank]["model"][case]["refused"], rank


def test_every_moe_case_ran_on_its_ranks(runs):
    _, port = runs
    for case in MOE_CASES:
        n = int(np.prod(case[2]))
        assert all((case in port[r]["moe"]) == (r < n) for r in range(4)), case


# ------------------------------------------------------------------ raises
def _moe_layer(arch="mixtral-8x7b"):
    model = build_model(torch_dist_worker.config(arch))
    p = model.init_params(0, device="cpu")["groups"][0]["layers"][0]["moe"]
    return model.cfg, {k: v[0] for k, v in p.items()}


@pytest.mark.parametrize("strategy", ["dropless", "capacity"])
def test_local_strategies_raise_under_a_mesh(strategy):
    cfg, p = _moe_layer()
    ctx = RunCtx(moe_strategy=strategy, mesh=Mesh((1, 2, 2), torch_dist_worker.AXES),
                 ep_axis="expert", tp_axis="tensor")
    with pytest.raises(ValueError, match="tp_shardmap or ep_shardmap"):
        moe_sublayer(p, torch.zeros(2, 3, cfg.d_model), cfg, ctx)


def test_shardmap_strategies_without_a_mesh_run_capacity():
    cfg, p = _moe_layer()
    h = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, cfg.d_model))
                         .astype(np.float32))
    y0, a0 = moe_sublayer(p, h, cfg, RunCtx(moe_strategy="capacity"))
    for strategy in ("tp_shardmap", "ep_shardmap"):
        y, a = moe_sublayer(p, h, cfg, RunCtx(moe_strategy=strategy))
        assert torch.equal(y, y0) and float(a) == float(a0)


def test_int8_trees_and_training_raise_under_a_mesh():
    """What still raises: int8 trees under a mesh; the int8 all-to-all
    under grad (its rounding has no useful gradient)."""
    from repro_torch.quant.quantize import quantize_leaf
    cfg = torch_dist_worker.config("mixtral-8x7b")
    model = build_model(cfg)
    mesh = Mesh((1, 1, 1), torch_dist_worker.AXES)
    ctx = RunCtx(mesh=mesh, moe_strategy="ep_shardmap", tp_axis="tensor", ep_axis="expert")
    q = model.init_params(0, device="cpu")
    q["embed"]["w"] = quantize_leaf(q["embed"]["w"])
    with use_sharding(mesh, make_rules("serve", tensor_axis="tensor", expert_axis="expert")):
        with pytest.raises(NotImplementedError, match="int8"):
            model.prefill(q, {"tokens": torch.zeros(2, 4, dtype=torch.int64)}, None, ctx)
    cfg, p = _moe_layer()
    h = torch.zeros(2, 3, cfg.d_model, requires_grad=True)
    with pytest.raises(NotImplementedError, match="a2a_int8.*no useful gradient"):
        moe_sublayer(p, h, cfg, RunCtx(moe_strategy="ep_shardmap", mesh=mesh, quant="a2a_int8",
                                       ep_axis="expert", tp_axis="tensor"))


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "seamless-m4t-large-v2", "phi-3-vision-4.2b"])
def test_an_int8_tree_is_what_still_raises_under_a_mesh(arch, mode):
    """Every family serves and trains under a mesh on float trees; an int8
    tree there (the reference shards one only in its dry-run) is the
    ROADMAP's next item, which the message names."""
    from repro_torch.quant.quantize import quantize_leaf
    model = build_model(torch_dist_worker.config(arch))
    mesh = Mesh((1, 1, 1), torch_dist_worker.AXES)
    ctx = RunCtx(mode="train", mesh=mesh, tp_axis="tensor", ep_axis="expert")
    q = model.init_params(0, device="cpu")
    q["embed"]["w"] = quantize_leaf(q["embed"]["w"])
    batch = {"tokens": torch.zeros(2, 4, dtype=torch.int64),
             "labels": torch.zeros(2, 4, dtype=torch.int64)}
    with use_sharding(mesh, make_rules(mode, tensor_axis="tensor", expert_axis="expert")):
        with pytest.raises(NotImplementedError, match=r"int8.*ROADMAP Queue 1 item 3 \(c\)"):
            if mode == "serve":
                model.prefill(q, batch, None, ctx)
            else:
                model.loss(q, batch, ctx)
