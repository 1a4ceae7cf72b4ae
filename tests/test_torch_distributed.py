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
- int8 trees (every leaf of two dims or more quantized, ``_QUANT_MIN_SIZE``
  set to 1 on both packages, so norms, routers, convs and SSM scalars are
  int8 too), sharded by the reference dry-run's rule: tiny mixtral at (1,
  2, 2) ep_shardmap and (2, 1, 2) tp_shardmap (the rank's int8 experts in
  the grouped matmul), qwen2.5 at (1, 1, 4) (kv_seq: whole int8 ``wk`` /
  ``wv``), mamba2 at (1, 1, 2) and seamless at (2, 1, 2), through the same
  paths against the JAX package's unsharded calls on
  ``dequantize_tree(quantize_params_int8(params), float32)``;
- the sequence-parallel rule (``make_rules(seq_shard=True)``): tiny qwen2.5
  and mixtral at (2, 1, 2), qwen2.5 at (1, 1, 4) (kv_seq), mamba2 and
  phi-3-vision (the patch prefix joined before the split) at (1, 1, 2),
  seamless at (2, 1, 2) (the encoder's frames too), through the same paths
  against the same unsharded calls, the prefill and the pack reduce-scattering
  (the one-token steps and the 3-token verify sweep at tensor 2 stay whole);
- what raises under a mesh: an int8 tree's loss, the int8 all-to-all under
  grad; an int8 tree on the (1, 1, 1) mesh serves as it does unsharded;
- the dry-run's walk is the ranks' program: rank 0's real step of the
  dry-run's cell (tiny mixtral at (1, 2, 2) with ``tp_shardmap``, a
  ``decode_step`` over the dense cache and a sequence-parallel prefill)
  under ``record_collectives`` gives the log and the FLOPs of the walk of
  the same rank on ``meta`` (``launch.dryrun``); a bound mesh's collective
  still runs under the recorder.
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
INT8_CASES = [("mixtral-8x7b", (1, 2, 2), "ep_shardmap", "int8"),
              ("mixtral-8x7b", (2, 1, 2), "tp_shardmap", "int8"),
              ("qwen2.5-3b", (1, 1, 4), "tp_shardmap", "int8"),       # kv_seq
              ("mamba2-1.3b", (1, 1, 2), "tp_shardmap", "int8"),
              ("seamless-m4t-large-v2", (2, 1, 2), "tp_shardmap", "int8")]
INT8_ARCHS = tuple(sorted({c[0] for c in INT8_CASES}))
INT8_MIN_SIZE = 1                      # every leaf of two dims or more
SEQ_CASES = [("qwen2.5-3b", (2, 1, 2), "tp_shardmap", "seq"),
             ("mixtral-8x7b", (2, 1, 2), "tp_shardmap", "seq"),
             ("qwen2.5-3b", (1, 1, 4), "tp_shardmap", "seq"),        # kv_seq and seq meet
             ("mamba2-1.3b", (1, 1, 2), "tp_shardmap", "seq"),
             ("phi-3-vision-4.2b", (1, 1, 2), "tp_shardmap", "seq"),
             ("seamless-m4t-large-v2", (2, 1, 2), "tp_shardmap", "seq")]
PATHS = ("prefill", "ring0", "ring1", "pack", "paged0", "paged1", "verify")
WALK_MESH = (1, 2, 2)
WALK_CASES = {"decode": ("mixtral-8x7b", (32, 4, "decode"), "tp", False),
              "prefill_seq": ("mixtral-8x7b", (16, 2, "prefill"), "tp", True)}


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


def _int8_trees(params):
    """Per int8 arch: the port's int8 tree (numpy ``QuantizedLinear``
    leaves, what the ranks shard) and the JAX package's dequantized one
    (``dequantize_tree(quantize_params_int8(p), float32)``, what the
    reference runs), both at ``INT8_MIN_SIZE``."""
    import jax.numpy as jnp
    from repro.quant import quantize as jax_quant
    from repro_torch.models.params import map_tree, params_from_numpy
    from repro_torch.quant import quantize as quant
    port, ref = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_quant, "_QUANT_MIN_SIZE", INT8_MIN_SIZE)
        mp.setattr(quant, "_QUANT_MIN_SIZE", INT8_MIN_SIZE)
        for a in INT8_ARCHS:
            tq = quant.quantize_params_int8(params_from_numpy(params[a], device="cpu"))
            port[a] = map_tree(lambda t: t.numpy(), tq)
            jq = jax_quant.quantize_params_int8(jax.tree.map(jnp.asarray, params[a]))
            ref[a] = jax.tree.map(np.asarray, jax_quant.dequantize_tree(jq, jnp.float32))
    return port, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = {a: to_np(jax_build_model(jax_tiny_config(a)).init_params(jax.random.PRNGKey(0)))
              for a in sorted(set(MODEL_ARCHS) | set(MOE_ARCHS))}
    int8_params, int8_ref_params = _int8_trees(params)
    moe_params = {}
    for a in MOE_ARCHS:
        lay = next(lay for g in params[a]["groups"] for lay in g["layers"] if "moe" in lay)
        moe_params[a] = jax.tree.map(lambda x: x[0], lay["moe"])
    h = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(np.float32)
    inputs = d / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"moe_cases": MOE_CASES, "model_cases": MODEL_CASES + INT8_CASES + SEQ_CASES,
                     "params": params, "int8_params": int8_params,
                     "int8_ref_params": int8_ref_params, "moe_params": moe_params, "moe_h": h,
                     "io": _io(), "walk_mesh": WALK_MESH, "walk_cases": WALK_CASES}, f)
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


def _case_id(c):
    return "-".join([c[0], str(c[1]), c[2], *c[3:]])


@pytest.mark.parametrize("case", MODEL_CASES + INT8_CASES + SEQ_CASES, ids=_case_id)
def test_sharded_paths_match_unsharded_jax(runs, case):
    """Every path of each rank against the JAX package's unsharded calls:
    on the same parameters (a "seq" case too: ``with_sharding_constraint``
    changes nothing the reference computes, and there the sublayers'
    partials are reduce-scattered, nowhere else), or for an "int8" case on
    ``dequantize_tree(quantize_params_int8(params), float32)``."""
    ref, port = runs
    want = ref["int8" if case[3:] == ("int8",) else "model"][case[0]]
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
        assert (got["scattered"] > 0) == (case[3:] == ("seq",)), (rank, got["scattered"])


@pytest.mark.parametrize("case", INT8_CASES, ids=_case_id)
def test_an_int8_tree_round_trips_through_shard_and_gather(runs, case):
    """``gather_tree`` of the rank's ``shard_tree`` of the int8 tree (its
    q and scale by their own specs) is the whole tree, bit for bit and
    int8 still, on every rank."""
    _, port = runs
    assert all(port[rank]["model"][case]["round_trip"] for rank in range(int(np.prod(case[1]))))


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


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_the_meta_walk_is_the_ranks_program(runs, name):
    """The dry-run's walk of rank 0 on ``meta`` (a placed mesh, every
    collective standing in) records the collectives (kind, result bytes,
    axis, in order) and counts the FLOPs of rank 0's real step on the gloo
    ranks."""
    from repro_torch.configs import tiny_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_cell, walk
    _, port = runs
    arch, (S, B, kind), moe, seq = WALK_CASES[name]
    cell = build_cell(tiny_config(arch), ShapeConfig(name, S, B, kind),
                      Mesh(WALK_MESH, torch_dist_worker.AXES), moe_mode=moe, seq_shard=seq,
                      device="meta", rank=0)
    w = walk(cell)
    got = port[0]["walk"][name]
    assert w.log and w.log == got["log"]
    assert {k for k, _, _ in w.log} >= ({"all-reduce", "all-gather", "reduce-scatter"} if seq
                                        else {"all-reduce", "all-gather"})
    assert w.flops > 0 and w.flops == got["flops"]
    assert w.out[0].device.type == "meta"                 # (logits, cache)


def test_a_bound_mesh_communicates_under_the_recorder(runs):
    """On the spawned ranks a psum over the tensor axis under
    ``record_collectives`` sums the values (rank + 1) of the two ranks of
    the rank's tensor line, and is logged."""
    _, port = runs
    for rank in range(4):
        total, log = port[rank]["walk"]["psum"]
        line = 2 * (rank // 2)                     # (data, expert, tensor) = (0, rank // 2, rank % 2)
        assert total == [float(line + 1 + line + 2)] * 2
        assert log == [("all-reduce", 8, "tensor")]


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


INT8_TRAIN_REFUSAL = r"int8 weight trees serve under a mesh but do not train there"


def test_int8_trees_and_training_raise_under_a_mesh():
    """An int8 tree serves on the (1, 1, 1) mesh (ep_shardmap: its int8
    experts in the grouped matmul) as it does unsharded (dropless over the
    same int8 experts); its loss under a mesh raises; so does the int8
    all-to-all under grad (its rounding has no useful gradient)."""
    from repro_torch.quant.quantize import quantize_params_int8
    cfg = torch_dist_worker.config("mixtral-8x7b")
    model = build_model(cfg)
    mesh = Mesh((1, 1, 1), torch_dist_worker.AXES)
    ctx = RunCtx(mesh=mesh, moe_strategy="ep_shardmap", tp_axis="tensor", ep_axis="expert")
    q = quantize_params_int8(model.init_params(0, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (2, 6)))
    want, _ = model.prefill(q, {"tokens": tokens}, None, RunCtx(moe_strategy="dropless"))
    with use_sharding(mesh, make_rules("serve", tensor_axis="tensor", expert_axis="expert")):
        got, _ = model.prefill(q, {"tokens": tokens}, None, ctx)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with use_sharding(mesh, make_rules("train", tensor_axis="tensor", expert_axis="expert")):
        with pytest.raises(NotImplementedError, match=INT8_TRAIN_REFUSAL):
            model.loss(q, {"tokens": tokens, "labels": tokens}, ctx)
    cfg, p = _moe_layer()
    h = torch.zeros(2, 3, cfg.d_model, requires_grad=True)
    with pytest.raises(NotImplementedError, match="a2a_int8.*no useful gradient"):
        moe_sublayer(p, h, cfg, RunCtx(moe_strategy="ep_shardmap", mesh=mesh, quant="a2a_int8",
                                       ep_axis="expert", tp_axis="tensor"))


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "seamless-m4t-large-v2", "phi-3-vision-4.2b"])
def test_an_int8_tree_is_what_still_raises_under_a_mesh(arch, mode):
    """An int8 tree (embedding quantized, the rest by the reference's
    threshold) serves under a mesh: its (1, 1, 1) ``forward`` equals the
    unsharded one; its loss there raises, saying why (the reference shards
    an int8 tree for its decode cells only, and the int8 kernels have no
    backward)."""
    from repro_torch.quant.quantize import quantize_leaf, quantize_params_int8
    model = build_model(torch_dist_worker.config(arch))
    cfg = model.cfg
    mesh = Mesh((1, 1, 1), torch_dist_worker.AXES)
    ctx = RunCtx(mode="train", mesh=mesh, tp_axis="tensor", ep_axis="expert")
    q = model.init_params(0, device="cpu")
    q["embed"]["w"] = quantize_leaf(q["embed"]["w"])
    q = quantize_params_int8(q)
    r = np.random.default_rng(3)
    tokens = torch.from_numpy(r.integers(1, 256, (2, 4)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(r.standard_normal((2, 6, cfg.d_model))
                                           .astype(np.float32))
    if cfg.vision is not None:
        batch["patches"] = torch.from_numpy(r.standard_normal(
            (2, cfg.vision.n_patches, cfg.vision.d_patch)).astype(np.float32))
    with use_sharding(mesh, make_rules(mode, tensor_axis="tensor", expert_axis="expert")):
        if mode == "serve":
            got, _ = model.forward(q, batch, ctx)
        else:
            with pytest.raises(NotImplementedError, match=INT8_TRAIN_REFUSAL):
                model.loss(q, batch, ctx)
    if mode == "serve":
        want, _ = model.forward(q, batch, RunCtx(mode="train"))
        assert torch.equal(got, want)
