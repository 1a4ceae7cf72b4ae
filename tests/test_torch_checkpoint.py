"""The port's checkpointing, optimizer, gradient compression, data pipeline
and trainer on the CPU, mirroring tests/test_checkpoint_train.py:
bit-exact round trips (bf16 and NamedTuple state included), atomic
publish, garbage collection, the async writer's snapshot against a train
step that updates in place, crash / restart equal to the uninterrupted run,
AdamW against numpy, the grad clip, the cosine schedule, the int8
compression with error feedback and the data's determinism. Torch and numpy
only; the comparisons with the JAX package are in test_torch_train_step.py."""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs import tiny_config
from repro_torch.data.pipeline import DataConfig, data_iterator, synthesize_batch
from repro_torch.distributed.collectives import (compress_grads_with_feedback, compress_int8,
                                                 decompress_grads, decompress_int8,
                                                 zeros_error_like)
from repro_torch.models import build_model
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.quant import QuantizedLinear
from repro_torch.training import adamw_init, adamw_update, cosine_schedule
from repro_torch.training.train_step import TrainConfig
from repro_torch.training.trainer import CrashForTest, TrainerConfig, train


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    r = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones((2,), dtype=torch.int32),
                  {"c": torch.tensor(2.5), "d": torch.randn((5, 3), generator=r).bfloat16()}],
            "q": QuantizedLinear(q=torch.tensor([[1, -2]], dtype=torch.int8),
                                 scale=torch.tensor([[0.5]])),
            "state": (adamw_init({"w": torch.randn((4,), generator=r)}), None)}


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_checkpoint_roundtrip_exact(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    _assert_same(out, tree)
    assert isinstance(out["q"], QuantizedLinear) and out["state"][1] is None


def test_checkpoint_keys_and_formats(tmp_path):
    """The reference's leaf keys (dict keys, list / tuple indices, ".field"
    of a NamedTuple), bf16 stored as its bit pattern; every shard is an
    npz that np.load reads; a Fortran-ordered numpy leaf restores as a
    contiguous tensor of the same values."""
    import json
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree, shard_size=3)
    path = tmp_path / "step_00000001"
    manifest = json.loads((path / "manifest.json").read_text())
    keys = [e["key"] for e in manifest["leaves"]]
    assert keys == ["a", "b/0", "b/1/c", "b/1/d", "q/.q", "q/.scale", "state/0/.step",
                    "state/0/.m/w", "state/0/.v/w"]
    d = next(e for e in manifest["leaves"] if e["key"] == "b/1/d")
    assert d["dtype"] == "bfloat16" and len({e["shard"] for e in manifest["leaves"]}) == 3
    for e in manifest["leaves"]:
        with np.load(path / f"shard_{e['shard']:05d}.npz") as z:
            assert list(z[e["npz_key"]].shape) == e["shape"]
    arrays = {"x": np.arange(6, dtype=np.float32).reshape(2, 3).T, "y": np.asarray(3, np.int64)}
    save_checkpoint(str(tmp_path / "np"), 1, arrays)
    got, _ = restore_checkpoint(str(tmp_path / "np"), arrays)
    for k, v in arrays.items():
        assert got[k].is_contiguous() and np.array_equal(got[k].numpy(), v)


def test_checkpoint_atomicity_no_partial(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    # a stale tmp dir from a crashed writer must not be visible
    os.makedirs(tmp_path / "step_00000002.tmp.999")
    # nor a step directory whose manifest was never written
    os.makedirs(tmp_path / "step_00000003")
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="checkpoint"):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(5)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"y": torch.zeros(4)})


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    assert sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)) == [2, 3]
    out, _ = restore_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 3.0))


def test_async_snapshot_precedes_in_place_updates(tmp_path, monkeypatch):
    """The train step updates its tensors in place: ``save`` must copy them
    before it returns, so an update made while the writer runs is not in
    the checkpoint."""
    gate = threading.Event()
    write = ckpt_mod.save_checkpoint

    def slow_save(*args, **kw):
        gate.wait(10)
        return write(*args, **kw)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow_save)
    w = torch.ones(6).bfloat16()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": w})
    w.add_(1.0)                      # the next step, while the writer waits
    gate.set()
    ck.wait()
    out, _ = restore_checkpoint(str(tmp_path), {"w": w})
    assert torch.equal(out["w"], torch.ones(6).bfloat16())


def test_async_writer_errors_reach_the_caller(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", broken)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                        # reported once


def _tiny_train(steps, ckpt_dir=None, crash_at=None, name="qwen2.5-3b", **tkw):
    cfg = tiny_config(name)
    model = build_model(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, batch=2, seq_len=16)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=30, **tkw)
    rcfg = TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5, crash_at=crash_at)
    return train(model, dcfg, tcfg, rcfg, seed=0, device="cpu")


def test_crash_restart_matches_uninterrupted(tmp_path):
    """A crash at step 7 and a restart from the step-5 checkpoint give the
    uninterrupted run's losses and parameters, bit for bit on the CPU."""
    with pytest.raises(CrashForTest) as crash:
        _tiny_train(10, str(tmp_path), crash_at=7)
    assert len(crash.value.losses) == len(crash.value.step_seconds) == 7
    assert latest_step(str(tmp_path)) == 5
    resumed = _tiny_train(10, str(tmp_path))
    assert resumed["start"] == 5 and len(resumed["losses"]) == 5
    assert latest_step(str(tmp_path)) == 10
    ref = _tiny_train(10)
    assert resumed["losses"] == ref["losses"][5:]
    assert ref["losses"][-1] < ref["losses"][0]
    _assert_same(resumed["params"], ref["params"])
    _assert_same(resumed["state"], ref["state"])
    assert len(ref["step_seconds"]) == 10 and set(ref["metrics"][0]) == {"loss", "xent", "aux",
                                                                          "lr"}


def test_trainer_moe_capacity_and_remat_off():
    """The trainer's default ctx takes the capacity strategy and the
    config's remat; a MoE model trains through it."""
    out = _tiny_train(3, name="mixtral-8x7b", remat=False)
    assert all(np.isfinite(out["losses"])) and out["metrics"][0]["aux"] > 0


def test_adamw_matches_numpy_reference():
    r = np.random.default_rng(0)
    p = {"w": torch.from_numpy(r.standard_normal((4, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(r.standard_normal((4, 3)).astype(np.float32))}
    p0 = p["w"].clone()
    new_p, state = adamw_update(g, adamw_init(p), p, lr=0.1, b1=0.9, b2=0.95, eps=1e-8,
                                weight_decay=0.0, grad_clip=1e9)
    gn = g["w"].numpy()
    m, v = 0.1 * gn, 0.05 * gn ** 2
    expect = p0.numpy() - 0.1 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, atol=1e-5)
    assert int(state.step) == 1 and new_p["w"] is p["w"]      # in place
    np.testing.assert_allclose(state.m["w"].numpy(), m, rtol=1e-6)


def test_adamw_bf16_leaf_updates_in_fp32():
    """A bf16 leaf's update is computed in fp32 from fp32 moments and cast
    back once (torch.optim.AdamW would round in bf16)."""
    p = {"w": torch.full((3,), 1.0).bfloat16()}
    g = {"w": torch.tensor([1e-3, -2e-3, 0.0])}
    _, state = adamw_update(g, adamw_init(p), p, lr=0.25, weight_decay=0.1, grad_clip=1e9)
    assert state.m["w"].dtype == torch.float32 and p["w"].dtype == torch.bfloat16
    expect = (1.0 - 0.25 * (np.sign([1e-3, -2e-3, 0.0]) + 0.1)).astype(np.float32)
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  torch.from_numpy(expect).bfloat16().float().numpy())


def test_grad_clip_scales_update():
    g = {"w": torch.tensor([3.0, 4.0])}        # norm 5
    p1, p2 = {"w": torch.zeros(2)}, {"w": torch.zeros(2)}
    adamw_update(g, adamw_init(p1), p1, lr=1.0, weight_decay=0.0, grad_clip=1.0)
    adamw_update({"w": g["w"] / 5.0}, adamw_init(p2), p2, lr=1.0, weight_decay=0.0,
                 grad_clip=1e9)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), atol=1e-5)


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, peak_lr=1.0, warmup=10, total=100)) == 0.0
    assert abs(float(cosine_schedule(10, peak_lr=1.0, warmup=10, total=100)) - 1.0) < 1e-6
    end = float(cosine_schedule(torch.tensor(100), peak_lr=1.0, warmup=10, total=100, floor=0.1))
    assert abs(end - 0.1) < 1e-6
    mid = [float(cosine_schedule(s, peak_lr=1.0, warmup=10, total=100)) for s in range(10, 101)]
    assert all(a >= b for a, b in zip(mid, mid[1:]))


def test_compression_with_error_feedback():
    """int8 with one absmax scale a leaf; the residual carries the rounding
    error, so g + old error == dequantized + new error."""
    r = np.random.default_rng(3)
    grads = {"a": torch.from_numpy(r.standard_normal((5, 7)).astype(np.float32)),
             "b": [torch.from_numpy(r.standard_normal(9).astype(np.float32)).bfloat16()]}
    err = zeros_error_like(grads)
    err["a"] += 0.01
    q, scale = compress_int8(grads["a"] + err["a"])
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    qtree, new_err = compress_grads_with_feedback(grads, err)
    deq = decompress_grads(qtree)
    for g, e0, d, e1 in zip(tree_leaves(grads), tree_leaves(err), tree_leaves(deq),
                            tree_leaves(new_err)):
        assert d.dtype == torch.float32 and e1.dtype == torch.float32
        np.testing.assert_allclose((g.float() + e0).numpy(), (d + e1).numpy(), atol=1e-6)
        assert float(e1.abs().max()) <= float(d.abs().max()) / 127 * 0.5 + 1e-6
    np.testing.assert_allclose(decompress_int8(q, scale).numpy(), deq["a"].numpy())


def test_data_pipeline_deterministic():
    dcfg = DataConfig(vocab=128, batch=2, seq_len=16, seed=3)
    a, b, c = synthesize_batch(dcfg, 5), synthesize_batch(dcfg, 5), synthesize_batch(dcfg, 6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (2, 16) and a["labels"].shape == (2, 16)
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    it = data_iterator(dcfg, start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], a["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], c["tokens"])


def test_map_tree_namedtuple_and_none():
    tree = (adamw_init({"w": torch.zeros(2)}), None, [torch.ones(1)])
    doubled = map_tree(lambda t: t * 2, tree)
    assert type(doubled[0]).__name__ == "AdamWState" and doubled[1] is None
    assert len(tree_leaves(tree)) == 4
