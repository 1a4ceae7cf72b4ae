#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns: for each tree, the
chosen phases of that tree's own ``chip_smoke.py``:

- 2: the phase-2 shapes of chunked attention, flash attention, paged
  decode, the grouped matmul (gmm), w8a16, the SSD scan and the flash
  backward;
- bwd: the phase-2 shapes of the flash backward alone;
- ssd: the phase-2 shapes of the SSD scan alone, and of its backward where
  the tree has one;
- 4: mixtral at 8 layers, bf16, the serving run;
- 6: full-depth mamba2, bf16: the serving run, then the generation API;
- 7: the full 32-layer mixtral on int8 weights: the serving run, then the
  generation API;
- 12: phase 12's uninterrupted qwen2.5-3b training run at full width and
  depth (bf16; STEPS steps, phase 12's 8 by default), with no checkpoint:
  the card's machine ends a call after 45 GiB of disk writes, and a
  checkpoint is 34 GB;
- 12d: phase 12 (d)'s uninterrupted mamba2-1.3b training run at full width
  and depth (bf16, phase 12's 8 steps, no checkpoint): its step ms, tokens/s
  and peak GB beside the SSD kernels' launches by path.

    python3 chip_ab.py TREE TAG [OUT_DIR] [PHASES] [STEPS]   # one tree, one process;
                                                             # PHASES e.g. ssd,12d
                                                             # (default 2,4,6,7)

Run it in turns (parent, change, change, parent) on one machine: host
dispatch moves the serving numbers far more between machines than on
one. Each run writes OUT_DIR/ab_TAG.json (OUT_DIR defaults to the current
directory) and prints one ``AB-RESULT`` line.
"""
import gc
import json
import sys
from pathlib import Path


def main() -> int:
    root, tag = Path(sys.argv[1]).resolve(), sys.argv[2]
    out_dir = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(".")
    phases = sys.argv[4].split(",") if len(sys.argv) > 4 else ["2", "4", "6", "7"]
    steps = int(sys.argv[5]) if len(sys.argv) > 5 else None
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs        # the tree's own: it puts the tree's src/ first
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("AB", tag, root, cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    torch.cuda._sleep(1000)        # load the lazily loaded modules before any timing
    flush.zero_()
    torch.cuda.synchronize()
    cs.cuda_ms(flush.zero_, flush=flush)
    res = []
    if "2" in phases:
        for run in (cs.run_attention, cs.run_flash, cs.run_paged_decode, cs.run_gmm,
                    cs.run_w8a16, cs.run_ssd):
            run(dev, flush, res)
    if "2" in phases or "bwd" in phases:
        cs.run_flash_bwd(dev, flush, res)
    if "ssd" in phases:
        cs.run_ssd(dev, flush, res)
    if ("2" in phases or "ssd" in phases) and hasattr(cs, "run_ssd_bwd"):
        cs.run_ssd_bwd(dev, flush, res)
    del flush
    kernels = ("chunked_prefill_attention", "flash_attention", "paged_attention", "moe_gmm",
               "w8a16_matmul", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd")
    out = dict(tag=tag, **{k: [dict(case=r["case"], dtype=r["dtype"], ms=r["ms"])
                               for r in res if r["kernel"] == k] for k in kernels})
    summary = {}
    if "4" in phases:
        model, params, _ = cs.build_mixtral(dev, cs.SERVE_LAYERS, int8=False)
        serve, *_ = cs.run_serving(dev, False, model, params)
        out["phase4"] = serve
        summary.update(p4_tok_s=serve["tok_s"], p4_decode_ms=serve["decode_step_ms_mean"],
                       p4_prefill_ms=serve["prefill_step_ms_mean"])
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if "6" in phases:
        serve6, gen6 = cs.run_mamba(dev, False)
        out["phase6"], out["phase6_gen"] = serve6, gen6
        summary.update(p6_tok_s=serve6["tok_s"], p6_decode_ms=serve6["decode_step_ms_mean"],
                       p6_prefill_ms=serve6["prefill_step_ms_mean"],
                       p6_gen_prefill_ms=gen6["prefill_ms"],
                       p6_gen_decode_ms=gen6["decode_step_ms_mean"])
        gc.collect()
        torch.cuda.empty_cache()
    if "7" in phases:
        model, params, _ = cs.build_mixtral(dev, 32, int8=True)
        serve7, _, streams, eng_logits = cs.run_serving(dev, False, model, params, int8=True)
        gen7, _ = cs.run_generation(dev, model, params, streams, profile=False,
                                    eng_logits=eng_logits)
        out["phase7"] = serve7
        out["phase7_gen"] = {k: v for k, v in gen7.items() if k != "divergence"}
        summary.update(p7_tok_s=serve7["tok_s"], p7_decode_ms=serve7["decode_step_ms_mean"],
                       p7_prefill_ms=serve7["prefill_step_ms_mean"],
                       p7_gen_decode_ms=gen7["decode_step_ms_mean"],
                       p7_gen_tok_s=gen7["decode_tok_s"])
    if "12" in phases:
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models import build_model
        from repro_torch.training.trainer import TrainerConfig, train
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(cs.TRAIN_ARCH)
        model = build_model(cfg)
        params = model.init_params(0, device=dev, dtype=torch.bfloat16)
        cs.zero_launches()
        run = train(model, DataConfig(vocab=cfg.vocab, batch=cs.TRAIN_BATCH,
                                      seq_len=cs.TRAIN_SEQ),
                    cs.train_config(), TrainerConfig(steps=steps or cs.TRAIN_STEPS),
                    params=params)
        launches, paths = cs.read_launches()
        later = run["step_seconds"][1:]          # the first step builds and warms up
        step_ms, mean_ms = 1e3 * float(np.median(later)), 1e3 * float(np.mean(later))
        out["phase12"] = dict(config=cfg.name, losses=run["losses"],
                              step_seconds=run["step_seconds"], step_ms_median=step_ms,
                              step_ms_mean=mean_ms, launches=launches, launches_by_path=paths)
        summary.update(p12_step_ms=step_ms, p12_step_ms_mean=mean_ms,
                       p12_last_loss=run["losses"][-1], p12_bwd_paths=paths["flash_attention_bwd"])
        del model, params, run
        gc.collect()
        torch.cuda.empty_cache()
    if "12d" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        res12d, _, paths = cs.run_mamba_training(dev)
        out["phase12d"] = res12d
        summary.update(p12d_step_ms=res12d["step_ms_median"], p12d_tok_s=res12d["tokens_per_s"],
                       p12d_peak_gb=res12d["peak_gb"], p12d_last_loss=res12d["losses"][-1],
                       p12d_bwd_paths=paths["ssd_scan_bwd"])
        gc.collect()
        torch.cuda.empty_cache()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"ab_{tag}.json").write_text(json.dumps(out, indent=1, default=str))
    print("AB-RESULT", tag, json.dumps(dict(
        **summary, **{k: {f"{r['case']} {r['dtype']}": round(r["ms"], 5) for r in out[k]}
                      for k in kernels})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
