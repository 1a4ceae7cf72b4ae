"""Training loop with checkpoint / restart (the reference's
``repro.training.trainer``).

- resumes from the latest checkpoint (parameters, optimizer state and the
  data position: batches are deterministic per step, so a restart replays
  the stream from where the checkpoint left it);
- checkpoints asynchronously, off the step loop;
- an optional simulated crash step for the restart test.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.data.pipeline import DataConfig, synthesize_batch
from repro_torch.models.common import RunCtx, resolve_device
from repro_torch.models.params import tree_leaves
from repro_torch.training.train_step import TrainConfig, make_train_step


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


def train(model, dcfg: DataConfig, tcfg: TrainConfig, rcfg: TrainerConfig, params=None,
          ctx: Optional[RunCtx] = None, seed: int = 0,
          device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Train ``model`` for ``rcfg.steps`` steps from ``params`` (default:
    ``model.init_params(seed)`` in fp32 on ``device``; cuda unless the
    caller asks for another). Returns {"params", "state", "losses" (one
    float a step taken in this call), "metrics" (each step's metrics as
    floats), "step_seconds" (each step's wall time, from its batch to its
    loss on the host), "start" (the step it resumed at)}."""
    init_fn, step_fn = make_train_step(model, tcfg, ctx)
    if params is None:
        params = model.init_params(seed, device=resolve_device(device))
    dev = tree_leaves(params)[0].device
    state = init_fn(params)
    start = 0
    if rcfg.ckpt_dir and latest_step(rcfg.ckpt_dir) is not None:
        restored, start = restore_checkpoint(rcfg.ckpt_dir, (params, state))
        # into the live tensors, leaf by leaf: no second copy on the device
        with torch.no_grad():
            for dst, src in zip(tree_leaves((params, state)), tree_leaves(restored)):
                if dst.dtype != src.dtype:
                    raise ValueError(f"checkpoint dtype {src.dtype}, model {dst.dtype}")
                dst.copy_(src)
        del restored

    ckpt = AsyncCheckpointer(rcfg.ckpt_dir) if rcfg.ckpt_dir else None
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
