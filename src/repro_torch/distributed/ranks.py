"""Start ranks as processes and join them with a deadline.

``spawn_ranks(fn, world, args, store_dir=..., timeout_s=...)`` starts
``world`` processes with the ``spawn`` start method (CUDA cannot be
forked). Each joins the default process group through a ``FileStore``
under ``store_dir`` (no TCP port to collide with another run's), with a
timeout, and one CPU thread; then calls ``fn(rank, world, *args)`` and
saves what it returns under ``store_dir``. The parent polls: a rank that
fails or outlives the deadline gets every rank killed and raises here, so
a stuck collective costs the deadline and no more.
"""
from __future__ import annotations

import datetime
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch


def init_rank(rank: int, world: int, store_path: str, backend: str = "gloo",
              timeout_s: float = 60.0) -> None:
    """Join the default process group as ``rank`` of ``world``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def _entry(fn, rank, world, args, store_dir, backend):
    import torch.distributed as dist
    out = Path(store_dir) / f"rank{rank}.pt"
    try:
        init_rank(rank, world, str(Path(store_dir) / "store"), backend)
        result = fn(rank, world, *args)
        torch.save({"ok": True, "result": result}, out)
        dist.destroy_process_group()
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, store_dir,
                backend: str = "gloo", timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    each rank's result, in rank order. ``fn`` must be importable by its
    module's name (a module-level function). Raises if a rank fails or the
    ranks are not done within ``timeout_s``; no rank outlives the call."""
    import multiprocessing as mp
    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    for f in store_dir.glob("rank*.pt"):
        f.unlink()
    if (store_dir / "store").exists():
        (store_dir / "store").unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tuple(args), str(store_dir), backend),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks not done within {timeout_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    results, errors = [], []
    for r, p in enumerate(procs):
        f = store_dir / f"rank{r}.pt"
        saved = torch.load(f, weights_only=False) if f.exists() else None
        if saved is None or not saved["ok"] or p.exitcode != 0:
            errors.append(f"rank {r} (exit {p.exitcode}): "
                          + (saved["error"] if saved and not saved["ok"] else "no result"))
        else:
            results.append(saved["result"])
    if failed or errors:
        raise RuntimeError(f"spawned ranks failed: {failed or ''}\n" + "\n".join(errors))
    return results

