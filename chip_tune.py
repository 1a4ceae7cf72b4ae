#!/usr/bin/env python3
"""Time the attention and SSD kernels' design choices on one card.

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
``build/flash_attention_variants/`` and timed beside the unchanged source at phase
2's two bf16 prefill shapes, each with its max |out - plain|.

The SSD scan's tensor-core path, the measurements behind ``_plan``'s
column width and the choices in ``csrc/ssd_scan.cu``: at phase 2's four
bf16 shapes (mamba2's pack, 297- and 4096-token prefills, jamba's pack),
the unchanged source at pb = 16, 32 and 64, then, at the planned pb,
copies of it with one choice undone each (M as its hi part alone, ``expf``
for ``ex2``, the next tile's copies issued after the tile instead of under
its second half) or one stage removed (C S, the scores, M x, the state
update, the B / C copies, the y stores, all four products: probes of what
bounds the kernel), built under
``build/ssd_scan_variants/``, each with its max |y - plain| and |state -
plain|; a copy that stamps ``clock64()`` at each phase of one block gives
the cycles a tile takes by phase at the 4096-token prefill; and the planned
kernel over one mamba2 row of 64 to 4096 tokens gives the cost of a tile.

Each time is ``chip_smoke.cuda_ms`` of the launch alone (cold L2, host
dispatch queued out of the events).

    python3 chip_tune.py [chunked] [flash] [ssd]   # on the card, from the repository root;
                                                   # no argument: all three
"""
import ctypes
import re
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


# (file, text of the source, its replacement) for each SSD variant
_LOAD_MID = "      stage();\n      load(t + 1);\n"
_LOOP_END = ("  }\n\n#pragma unroll\n  for (int u = 0; u < TM; ++u)\n#pragma unroll\n"
             "    for (int v = 0; v < TN; ++v)\n#pragma unroll\n      for (int e = 0; e < 4; ++e) {\n"
             "        const int n = (wm * TM + u) * 16 + gr + 8 * (e >> 1);\n"
             "        const int p = p0 + (wn * TN + v) * 8 + 2 * gc + (e & 1);\n"
             "        if (n < N && p < P) final_state")
SSD_VARIANTS = {
    "base": [],
    "m_hi_only": [("ssd_scan.cu", "        mma_bf16(yd[2 * dp], ml, b0);\n"
                   "        mma_bf16(yd[2 * dp + 1], ml, b1);\n", "")],
    "expf": [("ssd_scan.cu", '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
              "  y = expf(x * 0.6931471805599453f);")],
    "late_load": [("ssd_scan.cu", _LOAD_MID, "      stage();\n"),
                  ("ssd_scan.cu", _LOOP_END,
                   "    if (t + 1 < tiles) load(t + 1);\n" + _LOOP_END)],
    # probes of what bounds the kernel: one stage removed (outputs wrong)
    "no_c_s": [("ssd_scan.cu", "      for (int dp = 0; dp < NT / 2; ++dp) {\n        const int off",
                "      for (int dp = 0; dp < 0; ++dp) {\n        const int off")],
    "no_scores": [("ssd_scan.cu", "      for (int np = 0; np < 4; ++np) {\n        if (np > warp) "
                   "continue;\n        unsigned r[4];",
                   "      for (int np = 0; np < 0; ++np) {\n        if (np > warp) "
                   "continue;\n        unsigned r[4];")],
    "no_m_x": [("ssd_scan.cu", "      for (int dp = 0; dp < NT / 2; ++dp) {\n        unsigned r[4];",
                "      for (int dp = 0; dp < 0; ++dp) {\n        unsigned r[4];")],
    "no_state": [("ssd_scan.cu", "      for (int u = 0; u < TM; ++u) {\n        const int mt",
                  "      for (int u = 0; u < 0; ++u) {\n        const int mt")],
    "no_bc_loads": [("ssd_scan.cu", "for (int i = tid; i < kT * 2 * NK; i += kMmaThreads) {",
                     "for (int i = tid; i < 0; i += kMmaThreads) {")],
    "no_y_store": [("ssd_scan.cu", "      if (t0 + i >= L) continue;",
                    "      if (t0 + i >= 0) continue;")],
}
SSD_VARIANTS["no_products"] = [e for v in ("no_c_s", "no_scores", "no_m_x", "no_state")
                               for e in SSD_VARIANTS[v]]
# clock64() stamps of block (0, 0), lane 0 of each warp, at the phase
# boundaries of its first 64 tiles, read back by ssd_timeline()
_STAMP = ("    if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 && t < 64) "
          "g_clk[warp][t][{}] = clock64();\n")
_ANCHORS = [  # (text, stamp after it (True) or before it (False))
    ("    // tile t and the staged state visible to every thread\n    __syncthreads();\n", True),
    ("      total = ex2(last);\n      __syncwarp();\n    }\n", True),
    ("    // (2) S <- 2^cum_last S", False),
    ("    // (3) scores C B^T", False),
    ("    // B, C and the staged state are read", False),
    ("    // (4) M_ij = scores 2^(cum_i - cum_j) dt_j", False),
    ("    // (5) y_diag = M x", False),
    (_LOOP_END, False),
]
TIMELINE_PHASES = ("wait+barrier", "scan", "C S", "state", "scores", "barrier+stage+load", "M",
                   "M x + y")
SSD_VARIANTS["timeline"] = [
    ("ssd_scan.cu", "// grid (H * ceil(P / PB), B): block x",
     "__device__ unsigned long long g_clk[4][64][8];\n\n// grid (H * ceil(P / PB), B): block x"),
    ("ssd_scan.cu", 'extern "C" void ssd_scan_constants(int* c) {',
     'extern "C" int ssd_timeline(unsigned long long* out) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));\n}\n\n"
     'extern "C" void ssd_scan_constants(int* c) {')] + [
    ("ssd_scan.cu", text, text + _STAMP.format(k) if after else _STAMP.format(k) + text)
    for k, (text, after) in enumerate(_ANCHORS)]


def build_variants(source: str, variants: dict, bind, sizes_of=("",)) -> dict:
    """Each variant's launch function, built from a patched copy of the
    sources under build/<source>_variants/ (one nvcc per variant, all at
    once); prints the SASS size of its kernels whose names hold one of
    ``sizes_of``."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / f"{source}_variants"
    procs = {}
    for name, edits in variants.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in [*build.CSRC.glob("*.cuh"), build.CSRC / f"{source}.cu"]:
            shutil.copy(src, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            assert text.count(old) == 1, f"variant {name}: its text is not in {fname} once"
            (d / fname).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"variant {name} failed to build:\n{log}"
        fns[name] = bind(ctypes.CDLL(str(out / name / "lib.so")))
        regs = ptxas_usage(log)
        print(f"TUNE {source} variant {name}: " + "; ".join(
            f"{k} {v} SASS instructions, {regs.get(k, '?')}"
            for k, v in sass_sizes(out / name / "lib.so").items() if any(t in k for t in sizes_of)),
            flush=True)
    return fns


def ptxas_usage(log: str) -> dict:
    """Each kernel's registers and spill stores from nvcc's -Xptxas=-v log."""
    usage, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)(I.*?E)E", ln)
        if m:
            name = m.group(1) + m.group(2)
        elif name and "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif name and "Used" in ln and "registers" in ln:
            usage[name] = f"{ln.split('Used')[1].split(',')[0].strip()}, {spill}"
            name = None
    return usage


def sass_sizes(lib) -> dict:
    """Instructions of each kernel in a library (cuobjdump -sass), by the
    kernel's name with its template arguments."""
    from repro_torch.kernels import build
    text = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    sizes, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : .*?([a-z_]+_kernel)(I.*?E)E", ln)
        if m:
            name = m.group(1) + m.group(2)
            sizes[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            sizes[name] += 1
    return sizes


def build_flash_variants() -> dict:
    from repro_torch.kernels.flash_attention.kernel import bind
    return build_variants("flash_attention", FLASH_VARIANTS, bind)


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


def tune_ssd(dev, flush) -> None:
    from repro_torch.kernels.ssd_scan import ssd_reference
    from repro_torch.kernels.ssd_scan.kernel import PATHS, bind, plan_for
    fns = build_variants("ssd_scan", SSD_VARIANTS, bind,
                         sizes_of=("mma_kernelILi64ELi8E", "mma_kernelILi32ELi8E",
                                   "mma_kernelILi64ELi1E"))
    for name, sh in (
            ("mamba2 pack", dict(B=2, L=128, H=64, P=64, N=128, G=1, init=True,
                                 nvalid=[128, 100])),
            ("mamba2 prefill", dict(B=1, L=297, H=64, P=64, N=128, G=1)),
            ("mamba2 prefill 4096", dict(B=1, L=4096, H=64, P=64, N=128, G=1)),
            ("jamba pack", dict(B=2, L=128, H=128, P=64, N=16, G=1, init=True,
                                nvalid=[128, 100]))):
        x, dt, A, Bm, Cm, s0 = cs.ssd_case(dev, dtype=torch.bfloat16, seed=3, **sh)
        B, L, H, P = x.shape
        G, N = Bm.shape[2:]
        plan = plan_for(x, Bm)
        y_ref, s_ref = ssd_reference(x, dt, A, Bm.expand(-1, -1, H, -1),
                                     Cm.expand(-1, -1, H, -1), 256, init_state=s0)
        y = torch.empty((B, L, H, P), dtype=torch.float32, device=dev)
        fin = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
        runs = [("base", pb) for pb in (16, 32, 64)] + [(v, plan.pb) for v in SSD_VARIANTS
                                                        if v != "base"]
        for rnd in range(1 if L > 1000 else 2):
            for variant, pb in runs:
                def call():
                    err = fns[variant](
                        PATHS.index("mma"), pb, plan.nk, x.data_ptr(), dt.data_ptr(),
                        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        None if s0 is None else s0.data_ptr(), y.data_ptr(), fin.data_ptr(),
                        B, L, H, P, N, G, *x.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2],
                        1, torch.cuda.current_stream(dev).cuda_stream)
                    assert err == 0, f"variant {variant} pb {pb}: launch failed (code {err})"
                call()
                torch.cuda.synchronize()
                err_y, err_s = cs.max_err(y, y_ref), cs.max_err(fin, s_ref)
                ms = cs.cuda_ms(call, flush=flush)
                print(f"TUNE ssd {name} round {rnd} {variant} pb={pb} (plan pb={plan.pb}): "
                      f"{ms:.5f} ms max_abs_err y {err_y:.3g} state {err_s:.3g}", flush=True)
    # one block's phases at the 4096-token prefill (block (0, 0), 64 tiles)
    from repro_torch.kernels import build
    x, dt, A, Bm, Cm, _ = cs.ssd_case(dev, B=1, L=4096, H=64, P=64, N=128, G=1,
                                      dtype=torch.bfloat16, seed=3)
    y = torch.empty((1, 4096, 64, 64), dtype=torch.float32, device=dev)
    fin = torch.empty((1, 64, 64, 128), dtype=torch.float32, device=dev)
    plan = plan_for(x, Bm)
    for variant in [v for v in SSD_VARIANTS if v.startswith("timeline")]:
        lib = ctypes.CDLL(str(build.BUILD_DIR.parent / "ssd_scan_variants" / variant / "lib.so"))
        for _ in range(3):
            fns[variant](PATHS.index("mma"), plan.pb, plan.nk, x.data_ptr(), dt.data_ptr(),
                         A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), None, y.data_ptr(),
                         fin.data_ptr(), 1, 4096, 64, 64, 128, 1, *x.stride()[:2],
                         *Bm.stride()[:2], *Cm.stride()[:2], 1,
                         torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * (4 * 64 * 8))()
        assert lib.ssd_timeline(clk) == 0
        stamps = torch.tensor(list(clk), dtype=torch.float64).reshape(4, 64, 8)
        phase = torch.empty(4, 63, 8, dtype=torch.float64)     # tiles 1-63, each phase's cycles
        phase[:, :, 0] = stamps[:, 1:, 0] - stamps[:, :-1, 7]   # from the tile before's end
        phase[:, :, 1:] = stamps[:, 1:, 1:] - stamps[:, 1:, :-1]
        for w in range(4):
            print(f"TUNE ssd {variant} 4096 warp {w}: cycles a tile by phase (mean of tiles "
                  "1-63): " + ", ".join(f"{n} {v:.0f}" for n, v in zip(
                      TIMELINE_PHASES, phase[w].mean(0).tolist()))
                  + f"; whole tile {float((stamps[w, 63, 7] - stamps[w, 0, 7]) / 63):.0f}",
                  flush=True)

    # the cost of a tile: one mamba2 row (256 blocks at pb 16) over 1 to 64 tiles
    fn = fns["base"]
    for L in (64, 128, 256, 512, 1024, 2048, 4096):
        x, dt, A, Bm, Cm, _ = cs.ssd_case(dev, B=1, L=L, H=64, P=64, N=128, G=1,
                                          dtype=torch.bfloat16, seed=3)
        y = torch.empty((1, L, 64, 64), dtype=torch.float32, device=dev)
        fin = torch.empty((1, 64, 64, 128), dtype=torch.float32, device=dev)
        plan = plan_for(x, Bm)
        ms = cs.cuda_ms(lambda: fn(
            PATHS.index("mma"), plan.pb, plan.nk, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), None, y.data_ptr(), fin.data_ptr(), 1, L, 64, 64, 128,
            1, *x.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2], 1,
            torch.cuda.current_stream(dev).cuda_stream), flush=flush)
        print(f"TUNE ssd tiles L={L} ({-(-L // 64)} tiles) pb={plan.pb}: {ms:.5f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.kernels.paged_attention import kernel as pk
    parts = sys.argv[1:] or ["chunked", "flash", "ssd"]
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    cs.cuda_ms(flush.zero_, flush=flush)
    if "ssd" in parts:
        tune_ssd(dev, flush)
    if "flash" in parts:
        tune_flash(dev, flush)
    if "chunked" not in parts:
        return 0
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
