#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns: for each tree,
the phase-2 shapes of chunked attention, flash attention, paged decode,
the grouped matmul (gmm), w8a16 and the SSD scan, then the chosen phases
of that tree's own ``chip_smoke.py``: 4 (mixtral at 8 layers, bf16, the
serving run), 6 (full-depth mamba2, bf16: the serving run, then the
generation API) and 7 (the full 32-layer mixtral on int8 weights: the
serving run, then the generation API).

    python3 chip_ab.py TREE TAG [OUT_DIR] [PHASES]   # one tree, one process;
                                                     # PHASES e.g. 4,7 (default 4,6,7)

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
    phases = sys.argv[4].split(",") if len(sys.argv) > 4 else ["4", "6", "7"]
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
    cs.run_attention(dev, flush, res)
    cs.run_flash(dev, flush, res)
    cs.run_paged_decode(dev, flush, res)
    cs.run_gmm(dev, flush, res)
    cs.run_w8a16(dev, flush, res)
    cs.run_ssd(dev, flush, res)
    del flush
    kernels = ("chunked_prefill_attention", "flash_attention", "paged_attention", "moe_gmm",
               "w8a16_matmul", "ssd_scan")
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
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"ab_{tag}.json").write_text(json.dumps(out, indent=1, default=str))
    print("AB-RESULT", tag, json.dumps(dict(
        **summary, **{k: {f"{r['case']} {r['dtype']}": round(r["ms"], 5) for r in out[k]}
                      for k in kernels})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
