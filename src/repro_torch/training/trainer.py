"""Training loop with checkpoint / restart (the reference's
``repro.training.trainer``).

- resumes from the latest checkpoint (parameters, optimizer state and the
  data position: batches are deterministic per step, so a restart replays
  the stream from where the checkpoint left it);
- checkpoints asynchronously, off the step loop;
- an optional simulated crash step for the restart test.

Under a mesh (``ctx.mesh``, inside ``use_sharding(mesh, make_rules("train",
...))``) each rank draws its shards of the parameters (``init_params(mesh=,
rules=)``), holds its shards of AdamW's moments and of the error feedback,
and feeds each step the global batch (the loss takes its rows). A
checkpoint holds the global tree, as the reference's global arrays do: every
rank gathers it, the mesh's first rank writes it, and a restore reads it
whole and keeps the rank's shards, so a mesh checkpoint restores unsharded
or on any mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.data.pipeline import DataConfig, synthesize_batch
from repro_torch.distributed.collectives import psum
from repro_torch.distributed.sharding import PartitionSpec, active, gather_tree, shard_tree
from repro_torch.models.common import RunCtx, resolve_device
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainConfig, make_train_step, mesh_specs


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    crash_at: Optional[int] = None    # simulate a node failure (tests)


class CrashForTest(Exception):
    """The simulated failure; carries the crashed run's ``losses`` and
    ``step_seconds`` up to it."""


class _MeshCheckpointer:
    """``AsyncCheckpointer`` of the global tree under a mesh: ``save``
    gathers it on every rank (a collective), the mesh's first rank writes
    it; ``wait`` waits for the write, then for every rank, so none reads the
    directory before the write is published."""

    def __init__(self, directory: str, mesh, specs, device):
        self.mesh, self.specs, self.device = mesh, specs, device
        self.inner = AsyncCheckpointer(directory) if mesh.rank == 0 else None

    def save(self, step: int, tree) -> None:
        with torch.no_grad():
            whole = gather_tree(tree, self.specs, self.mesh)
        if self.inner is not None:
            self.inner.save(step, whole)

    def wait(self) -> None:
        if self.inner is not None:
            self.inner.wait()
        psum(torch.zeros(1, device=self.device), self.mesh, self.mesh.axis_names)


def _global_like(tree, specs, mesh):
    """Meta tensors of the global shapes of the shards in ``tree``."""
    spec_list = []
    map_tree(spec_list.append, specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    it = iter(spec_list)

    def leaf(t):
        spec = next(it)
        shape = [n * (mesh.count(spec[i]) if i < len(spec) else 1) for i, n in enumerate(t.shape)]
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return map_tree(leaf, tree)


def train(model, dcfg: DataConfig, tcfg: TrainConfig, rcfg: TrainerConfig, params=None,
          ctx: Optional[RunCtx] = None, seed: int = 0,
          device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Train ``model`` for ``rcfg.steps`` steps from ``params`` (default:
    ``model.init_params(seed)`` in fp32 on ``device``; cuda unless the
    caller asks for another). Returns {"params", "state", "losses" (one
    float a step taken in this call), "metrics" (each step's metrics as
    floats), "step_seconds" (each step's wall time, from its batch to its
    loss on the host), "start" (the step it resumed at)}. Under a mesh (the
    module's note) ``params`` defaults to the rank's shards of that init,
    and the returned trees are the rank's shards."""
    init_fn, step_fn = make_train_step(model, tcfg, ctx)
    mesh, specs = mesh_specs(model, ctx) if ctx is not None else (None, None)
    if params is None:
        params = model.init_params(seed, device=resolve_device(device), mesh=mesh,
                                   rules=active()[1] if mesh is not None else None)
    dev = tree_leaves(params)[0].device
    state = init_fn(params)
    state_specs = None
    if mesh is not None:       # the moments and the error feedback lie as the parameters
        state_specs = (specs, (AdamWState(step=PartitionSpec(), m=specs, v=specs),
                               specs if state[1] is not None else None))
    start = 0
    if rcfg.ckpt_dir and latest_step(rcfg.ckpt_dir) is not None:
        like = (params, state) if mesh is None else _global_like((params, state), state_specs,
                                                                 mesh)
        restored, start = restore_checkpoint(rcfg.ckpt_dir, like)
        if mesh is not None:
            restored = shard_tree(restored, state_specs, mesh)
        # into the live tensors, leaf by leaf: no second copy on the device
        with torch.no_grad():
            for dst, src in zip(tree_leaves((params, state)), tree_leaves(restored)):
                if dst.dtype != src.dtype:
                    raise ValueError(f"checkpoint dtype {src.dtype}, model {dst.dtype}")
                dst.copy_(src)
        del restored

    ckpt = None
    if rcfg.ckpt_dir:
        ckpt = (AsyncCheckpointer(rcfg.ckpt_dir) if mesh is None
                else _MeshCheckpointer(rcfg.ckpt_dir, mesh, state_specs, dev))
    losses: List[float] = []
    history: List[Dict[str, float]] = []
    step_seconds: List[float] = []
    saved = None
    for step in range(start, rcfg.steps):
        if rcfg.crash_at is not None and step == rcfg.crash_at:
            if ckpt:
                ckpt.wait()
            crash = CrashForTest(f"simulated failure at step {step}")
            crash.losses, crash.step_seconds = losses, step_seconds
            raise crash
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthesize_batch(dcfg, step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step's device work
        step_seconds.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in metrics.items()})
        if ckpt and (step + 1) % rcfg.ckpt_every == 0:
            ckpt.save(step + 1, (params, state))
            saved = step + 1
    if ckpt:
        if saved != rcfg.steps:       # the final state, unless the loop just saved it
            ckpt.save(rcfg.steps, (params, state))
        ckpt.wait()
    return {"params": params, "state": state, "losses": losses, "metrics": history,
            "step_seconds": step_seconds, "start": start}
