"""Training launcher on a reduced (tiny) config, the reference's
``repro.launch.train`` with a ``--device`` flag:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2.5-3b \\
      --steps 100 --ckpt-dir /tmp/ckpt

Without ``--device`` it trains on the card and raises without one. Prints the
reference's summary JSON.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import tiny_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.training.train_step import TrainConfig
from repro_torch.training.trainer import TrainerConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = tiny_config(args.arch)
    model = build_model(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    tcfg = TrainConfig(peak_lr=args.lr, warmup=10, total_steps=args.steps,
                       grad_compression=args.grad_compression)
    out = train(model, dcfg, tcfg,
                TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every),
                device=resolve_device(args.device))
    print(json.dumps({
        "arch": args.arch, "resumed_from": out["start"],
        "first_loss": out["losses"][0] if out["losses"] else None,
        "last_loss": out["losses"][-1] if out["losses"] else None,
        "steps": args.steps,
    }, indent=1))


if __name__ == "__main__":
    main()
