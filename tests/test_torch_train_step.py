"""The port's training step and checkpoints against the JAX package's: three
``step_fn`` steps from the same tiny fp32 parameters match the JAX
package's jitted step (the losses and the parameters after each step,
within 1e-5): plain on qwen2.5-3b and on mixtral-8x7b (the capacity MoE),
and with 2 microbatches, int8 gradient compression and the chunked
cross-entropy each; a parameter checkpoint written by the JAX
package's ``save_checkpoint`` (bf16 leaves too) restores in the port to the
same loss; and the training launcher's CLI."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synthesize_batch as jax_synthesize_batch
from repro.training.train_step import TrainConfig as JaxTrainConfig
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.data.pipeline import DataConfig, synthesize_batch
from repro_torch.models import RunCtx
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.training.train_step import TrainConfig, make_train_step
from test_torch_train_loss import one_thread, pair, train_batch  # noqa: F401

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"plain": ("qwen2.5-3b", {}),
            "moe": ("mixtral-8x7b", {}),
            "microbatches": ("qwen2.5-3b", dict(microbatches=2)),
            "grad_compression": ("qwen2.5-3b", dict(grad_compression=True)),
            "xent_chunk": ("qwen2.5-3b", dict(xent_chunk=7))}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_matches_jax(variant):
    """The lr peaks at 1e-4: AdamW's first step divides each gradient by its
    own magnitude (plus eps = 1e-8), so a gradient element near eps turns
    an fp32 rounding difference between the two packages' sums into a
    parameter difference of up to ~lr (1.8e-5 at lr 1e-3 on one element of
    qwen's tiny wq, 1.8e-6 at 1e-4)."""
    arch, kw = VARIANTS[variant]
    jm, jp, model, params = pair(arch)
    common = dict(peak_lr=1e-4, warmup=2, total_steps=30, **kw)
    jinit, jstep = jax_make_train_step(jm, JaxTrainConfig(**common))
    jstep = jax.jit(jstep)
    init_fn, step_fn = make_train_step(model, TrainConfig(**common))
    jstate, state = jinit(jp), init_fn(params)
    dcfg = DataConfig(vocab=model.cfg.vocab, batch=2, seq_len=16)
    assert dcfg == DataConfig(**vars(JaxDataConfig(vocab=model.cfg.vocab, batch=2, seq_len=16)))
    for step in range(3):
        data = synthesize_batch(dcfg, step)
        np.testing.assert_array_equal(data["tokens"], jax_synthesize_batch(dcfg, step)["tokens"])
        jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in data.items()})
        params, state, met = step_fn(params, state, {k: torch.from_numpy(v)
                                                     for k, v in data.items()})
        for k in ("loss", "xent", "aux", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=TOL, rtol=TOL)
        for a, b in zip(tree_leaves(params), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    assert int(state[0].step) == int(jstate[0].step) == 3
    if kw.get("grad_compression"):
        for a, b in zip(tree_leaves(state[1]), jax.tree.leaves(jstate[1])):
            assert a.dtype == torch.float32 and a.shape == b.shape


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A parameter tree the JAX package saved (fp32, and its bf16 cast)
    restores into the port's tree, leaf for leaf and bit for bit, to the
    JAX package's loss."""
    jm, jp, model, like = pair("mixtral-8x7b")
    b = train_batch(model.cfg)
    jax_save_checkpoint(str(tmp_path / "f32"), 3, jp)
    jax_save_checkpoint(str(tmp_path / "bf16"), 4, jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                                                jp))
    restored, step = restore_checkpoint(str(tmp_path / "f32"), like)
    assert step == 3
    for a, w in zip(tree_leaves(restored), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    ctx = RunCtx(mode="train", moe_strategy="capacity")
    loss, _ = model.loss(restored, {k: torch.from_numpy(v) for k, v in b.items()}, ctx)
    from repro.models import RunCtx as JaxRunCtx
    jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in b.items()},
                    JaxRunCtx(mode="train", attn_backend="xla", moe_strategy="capacity"))
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL, rtol=TOL)
    restored, _ = restore_checkpoint(str(tmp_path / "bf16"), map_tree(lambda t: t.bfloat16(),
                                                                       like))
    for a, w in zip(tree_leaves(restored), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16
        want = np.asarray(w.astype(jnp.bfloat16)).view(np.uint16)
        np.testing.assert_array_equal(a.view(torch.int16).numpy().view(np.uint16), want)


def test_train_cli(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains a tiny
    config, checkpoints, resumes and prints the reference launcher's JSON."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
           "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["arch"] == "qwen2.5-3b" and res["resumed_from"] == 0 and res["steps"] == 3
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])
    again = subprocess.run(cmd[:6] + ["5"] + cmd[7:], cwd=ROOT, capture_output=True, text=True,
                           env=env, timeout=240)
    assert again.returncode == 0, again.stderr
    assert json.loads(again.stdout)["resumed_from"] == 3
