#!/usr/bin/env python3
"""Time the attention kernels' design choices on one card.

Chunked attention's plan constants, the measurements behind
``SPLIT_MAX_ROWS`` and ``SPLIT_BLOCKS_PER_SM`` in
``src/repro_torch/kernels/paged_attention/kernel.py``: at Mixtral's width
(32 query heads over 8 KV heads of 128, pages of 16, 4 rows, bf16) over a
pool row of 512 positions, each chunk width C = 1, 2, 4, 5 and 8 (C * G = 4
to 32 folded rows) is timed on the split path and on the tensor-core path;
over 512 and 4096 positions the decode sweep is timed at 2, 4, 8 and 16
split blocks a SM.

Flash attention's tensor-core path, the measurements behind the choices in
``csrc/attention_mma.cuh`` and ``csrc/flash_attention.cu``: copies of those
sources, each with one choice undone (``expf`` for ``ex2``, ``tanhf`` for
the softcap's ``ex2`` and reciprocal, blocks in grid order instead of last
rows first, P as its hi part alone) or one stage removed (the Q K^T or P V
products, as a probe of what bounds the kernel), are built with nvcc under
``build/flash_variants/`` and timed beside the unchanged source at phase
2's two bf16 prefill shapes, each with its max |out - plain|.

Each time is ``chip_smoke.cuda_ms`` of the launch alone (cold L2, host
dispatch queued out of the events).

    python3 chip_tune.py            # on the card, from the repository root
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

# (file, text of the source, its replacement) for each flash variant
_PV = '''        if (j == 0) {
          mma_bf16_zero(d0, pl[j], b0);
          mma_bf16_zero(d1, pl[j], b1);
        } else {
          mma_bf16(d0, pl[j], b0);
          mma_bf16(d1, pl[j], b1);
        }
        mma_bf16(d0, ph[j], b0);
        mma_bf16(d1, ph[j], b1);'''
_NO_QK = ("attention_mma.cuh", "    float s[8][4];\n#pragma unroll\n    for (int kk = 0; kk < kKSteps; ++kk)",
          "    float s[8][4];\n    for (int nt = 0; nt < 8; ++nt)\n"
          "      for (int v = 0; v < 4; ++v) s[nt][v] = 0.f;\n    for (int kk = 0; kk < 0; ++kk)")
_NO_PV = ("attention_mma.cuh", "    for (int dp = 0; dp < D / 16; ++dp) {",
          "    for (int dp = 0; dp < 0; ++dp) {")
FLASH_VARIANTS = {
    "base": [],
    "expf": [("attention_mma.cuh", "alpha[hh] = ex2(m_r[hh] - m_new);",
              "alpha[hh] = expf((m_r[hh] - m_new) * 0.6931471805599453f);"),
             ("attention_mma.cuh", "s[nt][v] = ex2(s[nt][v] - m_r[v >> 1]);",
              "s[nt][v] = expf((s[nt][v] - m_r[v >> 1]) * 0.6931471805599453f);")],
    "tanhf": [("attention_mma.cuh",
               "return cap - __fdividef(2.f * cap, ex2(x * two_log2e_over_cap) + 1.f);",
               "return cap * tanhf(x / cap);")],
    "grid_order": [("flash_attention.cu",
                    "const int rb = gridDim.x - 1 - lin / heads;\n"
                    "  const int h = lin % heads % gridDim.y, b = lin % heads / gridDim.y;",
                    "const int rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;")],
    "p_hi_only": [("attention_mma.cuh", _PV, _PV.replace("pl[j]", "ph[j]").rsplit("\n", 2)[0])],
    "no_qk": [_NO_QK],
    "no_pv": [_NO_PV],
    "no_qk_pv": [_NO_QK, _NO_PV],
}


def build_flash_variants() -> dict:
    """Each variant's launch function, built from a patched copy of the
    sources (one nvcc per variant, all at once)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import bind
    out = build.BUILD_DIR.parent / "flash_variants"
    procs = {}
    for name, edits in FLASH_VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in [*build.CSRC.glob("*.cuh"), build.CSRC / "flash_attention.cu"]:
            shutil.copy(src, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            assert text.count(old) == 1, f"variant {name}: its text is not in {fname} once"
            (d / fname).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"variant {name} failed to build:\n{log}"
        fns[name] = bind(ctypes.CDLL(str(out / name / "lib.so")))
    return fns


def tune_flash(dev, flush) -> None:
    from repro_torch.kernels.flash_attention import mha_reference
    fns = build_flash_variants()
    for shape, Hkv, window, softcap in (("prefill", 8, 0, 0.0), ("window", 16, 128, 50.0)):
        g = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn((4, 297, 32, 128), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((4, 297, Hkv, 128), generator=g, device=dev).bfloat16()
                for _ in range(2))
        plain = mha_reference(q, k, v, causal=True, window=window, softcap=softcap,
                              scale=128 ** -0.5)
        out = torch.empty_like(q)
        for rnd in range(2):
            for name, fn in fns.items():
                def call():
                    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 297,
                             297, 32, Hkv, 128, 128 ** -0.5, softcap, 1, window, 0, 1,
                             torch.cuda.current_stream(dev).cuda_stream)
                    assert err == 0, f"variant {name}: launch failed (code {err})"
                call()
                torch.cuda.synchronize()
                err = float((out.float() - plain.float()).abs().max())
                ms = cs.cuda_ms(call, flush=flush)
                print(f"TUNE flash {shape} round {rnd} {name}: {ms:.5f} ms "
                      f"max_abs_err {err:.3g}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.kernels.paged_attention import kernel as pk
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    cs.cuda_ms(flush.zero_, flush=flush)
    defaults = pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM

    def time_case(name, C, maxp, num_pages, rows_and_blocks):
        *t, kw = cs.attention_case(dev, B=4, C=C, H=32, Hkv=8, D=128, ps=16, maxp=maxp,
                                   num_pages=num_pages, starts=[s - C for s in (132, 220, 300, 167)]
                                   if maxp == 32 else [4000, 4095, 3900, 4050],
                                   nvalid=[C] * 4, dtype=torch.bfloat16, seed=1)
        q, kp, vp, pt, lengths, qpos = t
        starts = qpos[:, 0].contiguous()
        for max_rows, blocks in rows_and_blocks:
            pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM = max_rows, blocks
            plan = pk.plan_for(q, kp, pt)
            ms = cs.cuda_ms(lambda: chunked_prefill_cuda(q, kp, vp, pt, lengths, starts, **kw),
                            flush=flush)
            print(f"TUNE {name} C={C} rows={4 * C} {plan.path} splits={plan.splits} "
                  f"blocks_per_sm={blocks}: {ms:.5f} ms", flush=True)
        pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM = defaults

    # the split threshold: each width on the split path, then on the tensor cores
    for C in (1, 2, 4, 5, 8):
        time_case("width", C, 32, 256, [(defaults[0], defaults[1]), (0, defaults[1])])
    # the split count: 512 and 4096 positions a row
    for maxp, num_pages in ((32, 256), (256, 1040)):
        time_case(f"positions={maxp * 16}", 1, maxp, num_pages,
                  [(defaults[0], b) for b in (2, 4, 8, 16)])
    tune_flash(dev, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
