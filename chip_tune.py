#!/usr/bin/env python3
"""Time the attention and SSD kernels' design choices on one card.

Chunked attention's plan constants, the measurements behind
``SPLIT_MAX_ROWS`` and ``SPLIT_BLOCKS_PER_SM`` in
``src/repro_torch/kernels/paged_attention/kernel.py``: at Mixtral's width
(32 query heads over 8 KV heads of 128, pages of 16, 4 rows, bf16) over a
pool row of 512 positions, each chunk width C = 1, 2, 4, 5 and 8 (C * G = 4
to 32 folded rows) is timed on the split path and on the tensor-core path;
over 512 and 4096 positions the decode sweep is timed at 2, 4, 8 and 16
split blocks a SM; and the speculative verify sweeps at the ladder's
widths C = 2, 3 and 5 (8 / 12 / 20 folded rows), at phase 9's 1, 8 and 32
slots (``chip_smoke.spec_attention_shapes``) and at 64 slots over phase 8's
1024-page pool, are timed on both paths, each beside its bound and SDPA's
time on the same inputs.

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

The flash backward's tensor-core path, the measurement behind
``BWD_MIN_BLOCKS_PER_SM`` in ``src/repro_torch/kernels/flash_attention/
kernel.py`` and the choices in ``csrc/flash_attention_bwd.cu``: at phase
2's four bf16 training shapes (``chip_smoke.FLASH_BWD_FULL``), the whole
backward and its dK / dV part alone (the delta, dK / dV and reduce
kernels) at 0.5, 1, 2 and 4 dK / dV blocks a SM (the GQA subsets each
gives), in turns; then copies of the source with one choice undone (P and
dS as their hi parts alone; the dQ blocks in grid order instead of last
rows first), built under ``build/flash_attention_bwd_variants/``, each
with its max |grad - plain| relative to the plain version's max |grad|.

Each time is ``chip_smoke.cuda_ms`` of the launch alone (cold L2, host
dispatch queued out of the events).

The SSD backward's tensor-core path, the measurements behind ``bwd_plan``'s
heads a block and the choices in ``csrc/ssd_scan_bwd.cu``: at phase 2's two
bf16 training shapes, hb = 1, 2 and 4 (those whose block fits), a copy with
every lo part zeroed (the hi parts alone) and probes without the S or dy
loads, each with its errors relative to the plain version's max |grad|, and
copies that stamp ``clock64()`` at each phase of one block for its cycles a
tile by phase.

    python3 chip_tune.py [chunked] [flash] [ssd] [bwd] [ssdbwd]   # on the card, from the
                                                                  # repository root; no
                                                                  # argument: all five
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
    "expf": [("gemm_common.cuh", '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
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


# the SSD backward's variants (csrc/ssd_scan_bwd.cu): every lo part zeroed
# (the hi parts alone: the same instructions, so its time is the base's; its
# error is what the lo parts buy), probes, and copies that stamp clock64() at
# each phase of block (0, 0), lane 0 of each warp, over its tiles
_BWD_ANCHORS = [  # (text, stamp after it (True) or before it (False))
    ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n    __syncthreads();\n', True),
    ("    // M2 summed over the block's heads in head order", False),
    ("    // ---- (2) warp (w, k), rows j of tile w", False),
    ("    // ---- (3) warp (w, c < CHUNKS)", False),
    ("    __syncthreads();   // every reader of the staged S is done\n", True),
    ("    // ---- (4) warp (w, k): U = B dS'^T", False),
    ("    // ---- (5) warp (w, c < CHUNKS), rows j", False),
    ("    // ---- (6) warp (w, k): dS' <- 2^cum_Q dS'", False),
    ("    __syncthreads();   // the per-token partials are written\n", False),
    ("  }\n\n  if (d_init != nullptr)", False),
]
BWD_TIMELINE_PHASES = ("load+scan", "(1) C B^T, D", "M2 head sum", "(2) G^T dy",
                       "(3) dC + <dS', S>", "stage dS'", "(4) dx", "(5) dB", "(6) dS'",
                       "da")
_BWD_STAMP = ("    if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 && t < 8) "
              "g_clk[warp][t][{}] = clock64();\n")
# probes of what the tile's staging costs: one load removed (outputs wrong)
_BWD_PROBES = {
    "no_s_load": [("ssd_scan_bwd.cu", "        if (p < P && n < N) v = *reinterpret_cast"
                   "<const float4*>(st + (hh * P + p) * N + n);\n", "")],
    "no_dy_load": [("ssd_scan_bwd.cu", "        if (t0 + r < L && c < P) v = *reinterpret_cast"
                    "<const float4*>(dyt + (r * H + hh) * P + c);\n", "")],
}
_BWD_TIMELINE = [
    ("ssd_scan_bwd.cu", "// grid (H / HB, B): block x takes heads",
     "__device__ unsigned long long g_clk[16][8][10];\n\n"
     "// grid (H / HB, B): block x takes heads"),
    ("ssd_scan_bwd.cu", 'extern "C" void ssd_scan_bwd_constants(int* c) {',
     'extern "C" int ssd_bwd_timeline(unsigned long long* out) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));\n}\n\n"
     'extern "C" void ssd_scan_bwd_constants(int* c) {')] + [
    ("ssd_scan_bwd.cu", text, text + _BWD_STAMP.format(k) if after
     else _BWD_STAMP.format(k) + text) for k, (text, after) in enumerate(_BWD_ANCHORS)]
SSDBWD_VARIANTS = {
    "base": [],
    "hi_only": [("gemm_common.cuh", "  lo = *reinterpret_cast<const unsigned*>(&l);",
                 "  lo = 0u;")],
    **_BWD_PROBES,
    "timeline": _BWD_TIMELINE,
    **{f"timeline_{k}": _BWD_TIMELINE + v for k, v in _BWD_PROBES.items()},
}


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


# (file, text of the source, its replacement) for each backward variant
_BWD_LO = """      if (j == 0) {
        mma_bf16_zero(d0, xl[j], b0);
        mma_bf16_zero(d1, xl[j], b1);
      } else {
        mma_bf16(d0, xl[j], b0);
        mma_bf16(d1, xl[j], b1);
      }
      mma_bf16(d0, xh[j], b0);
      mma_bf16(d1, xh[j], b1);"""
BWD_VARIANTS = {
    "as_is": [],
    "hi_only": [("flash_attention_bwd.cu", _BWD_LO, """      if (j == 0) {
        mma_bf16_zero(d0, xh[j], b0);
        mma_bf16_zero(d1, xh[j], b1);
      } else {
        mma_bf16(d0, xh[j], b0);
        mma_bf16(d1, xh[j], b1);
      }""")],
    "dq_grid_order": [("flash_attention_bwd.cu",
                       "const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaTile",
                       "const int q0 = blockIdx.z * kMmaTile")],
}


def tune_bwd(dev, flush) -> None:
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda, mha_reference_bwd)
    from repro_torch.kernels.flash_attention import kernel as fk
    cases = []
    for name, B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff in cs.FLASH_BWD_FULL:
        g = torch.Generator(device=dev).manual_seed(Sq + Skv + D)
        q, do = (torch.randn((B, Sq, H, D), generator=g, device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device=dev).bfloat16()
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff, scale=D ** -0.5)
        out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        plain = mha_reference_bwd(q, k, v, out, do, lse, **kw)
        cases.append((name, (q, k, v, out, do, lse), kw, plain))
        flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)     # builds and loads the library
    torch.cuda.synchronize()
    default = fk.BWD_MIN_BLOCKS_PER_SM
    for per_sm in (2, 1, 4, 0.5, 2, 1, 4, 0.5):
        fk.BWD_MIN_BLOCKS_PER_SM = per_sm
        for name, t, kw, _ in cases:
            B, Sq, H, D = t[0].shape
            plan = fk.bwd_plan(B, Sq, t[1].shape[1], H, t[1].shape[2], D, torch.bfloat16,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
            ms = cs.cuda_ms(lambda: flash_attention_bwd_cuda(*t, **kw), flush=flush)
            dkv = cs.cuda_ms(lambda: flash_attention_bwd_cuda(*t, need_dq=False, **kw),
                             flush=flush)
            print(f"TUNE bwd {name} blocks_per_sm={per_sm} splits={plan['splits']} dkdv grid "
                  f"{plan['grids']['dkdv']}: {ms:.5f} ms (dK / dV part {dkv:.5f})", flush=True)
    fk.BWD_MIN_BLOCKS_PER_SM = default
    fns = build_variants("flash_attention_bwd", BWD_VARIANTS, fk.bind_bwd, ("mma",))
    for rnd in range(2):
        for name, t, kw, plain in cases:
            q, k, v, out, do, lse = t
            B, Sq, H, D = q.shape
            Skv, Hkv = k.shape[1], k.shape[2]
            plan = fk.bwd_plan(B, Sq, Skv, H, Hkv, D, torch.bfloat16,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
            grads = [torch.empty_like(x) for x in (q, k, v)]
            delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
            ws = torch.empty((2, plan["splits"], B, Skv, Hkv, D), dtype=torch.float32,
                             device=dev)
            for vname, fn in fns.items():
                def call():
                    err = fn(1, *(x.data_ptr() for x in (q, k, v, out, do, lse, delta, ws)),
                             *(x.data_ptr() for x in grads), B, Sq, Skv, H, Hkv, D,
                             plan["splits"], kw["scale"], kw["softcap"], int(kw["causal"]),
                             kw["window"], kw["q_offset"], 1,
                             torch.cuda.current_stream(dev).cuda_stream)
                    assert err == 0, f"variant {vname}: launch failed (code {err})"
                call()
                torch.cuda.synchronize()
                errs = [cs.max_err(a, b) / float(b.float().abs().max())
                        for a, b in zip(grads, plain)]
                ms = cs.cuda_ms(call, flush=flush)
                print(f"TUNE bwd {name} round {rnd} {vname}: {ms:.5f} ms rel errs dq "
                      f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}", flush=True)


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
                        None, B, L, H, P, N, G, *x.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2],
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
                         fin.data_ptr(), None, 1, 4096, 64, 64, 128, 1, *x.stride()[:2],
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
            Bm.data_ptr(), Cm.data_ptr(), None, y.data_ptr(), fin.data_ptr(), None, 1, L, 64, 64,
            128, 1, *x.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2], 1,
            torch.cuda.current_stream(dev).cuda_stream), flush=flush)
        print(f"TUNE ssd tiles L={L} ({-(-L // 64)} tiles) pb={plan.pb}: {ms:.5f} ms", flush=True)


def tune_ssdbwd(dev, flush) -> None:
    """The SSD backward's mma path at phase 2's two bf16 training shapes
    (chip_smoke.SSD_BWD_FULL): hb 1 / 2 / 4 heads a block (those whose
    block fits the card), then the variants at the planned hb, each with
    its errors relative to the plain version's max |grad| (dx in bf16, the
    others fp32), in two rounds; then one block's cycles a tile by phase."""
    from repro_torch.kernels.ssd_scan import ssd_reference_bwd, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan import kernel as sk
    fns = build_variants("ssd_scan_bwd", SSDBWD_VARIANTS, sk.bind_bwd, sizes_of=("mma",))
    names = ("dx", "ddt", "dA", "dB", "dC")
    cases = {}
    for name, B, L, H, P, N, G, *_ in cs.SSD_BWD_FULL:
        x, dt, A, Bm, Cm, _ = cs.ssd_case(dev, B=B, L=L, H=H, P=P, N=N, G=G,
                                          dtype=torch.bfloat16, init=False, nvalid=None,
                                          seed=L + P)
        g = torch.Generator(device=dev).manual_seed(L + N)
        dy = torch.randn((B, L, H, P), generator=g, device=dev)
        _, _, st = ssd_scan_cuda(x, dt, A, Bm, Cm, states=True)
        plain = ssd_reference_bwd(x, dt, A, Bm, Cm, None, st, dy, None)[:5]
        cases[name] = (x, dt, A, Bm, Cm, st, dy, plain)

    def launch(fn, case, hb, nk):
        x, dt, A, Bm, Cm, st, dy, _ = case
        B, L, H, P = x.shape
        G, N = Bm.shape[2:]
        f32 = dict(dtype=torch.float32, device=dev)
        part = (H // G // hb, B, L, G, N)
        outs = (torch.empty_like(x), torch.empty((B, L, H), **f32), torch.empty((B, H), **f32),
                torch.empty(part, **f32), torch.empty(part, **f32))

        def call():
            err = fn(1, hb, nk, *(t.data_ptr() for t in (x, dt, A, Bm, Cm, st, dy)), None,
                     *(t.data_ptr() for t in outs), None, B, L, H, P, N, G, *x.stride()[:2],
                     *Bm.stride()[:2], *Cm.stride()[:2], 1,
                     torch.cuda.current_stream(dev).cuda_stream)
            assert err == 0, f"hb {hb}: launch failed (code {err})"

        def grads():
            dB, dC, dA = sk.bwd_sums(dict(path="mma"), outs[3], outs[4], outs[2], torch.float32)
            return outs[0], outs[1], dA, dB, dC
        return call, grads

    for rnd in range(2):
        for name, case in cases.items():
            x, Bm, plain = case[0], case[3], case[7]
            plan = sk.bwd_plan_for(x, Bm)
            nk, H = plan["nk"], x.shape[2]
            runs = [("base", hb) for hb in (1, 2, 4)] + [
                (v, plan["hb"]) for v in SSDBWD_VARIANTS
                if v != "base" and not v.startswith("timeline")]
            for variant, hb in runs:
                if nk not in sk.MMA_BWD_STEPS[hb] or (H // Bm.shape[2]) % hb:
                    print(f"TUNE ssdbwd {name} round {rnd} {variant} hb={hb}: not built (its "
                          f"block needs {sk.bwd_mma_smem_bytes(hb, nk)} B of shared memory, "
                          f"the card {sk.SMEM_LIMIT})", flush=True)
                    continue
                call, grads = launch(fns[variant], case, hb, nk)
                call()
                torch.cuda.synchronize()
                errs = " ".join(f"{k} {cs.max_err(a, b) / float(b.abs().max()):.3g}"
                                for k, a, b in zip(names, grads(), plain))
                ms = cs.cuda_ms(call, flush=flush)
                print(f"TUNE ssdbwd {name} round {rnd} {variant} hb={hb} (plan hb={plan['hb']}) "
                      f"grid ({H // hb}, {x.shape[0]}): {ms:.5f} ms rel errs {errs}", flush=True)
    # one block's phases (block (0, 0), its 8 tiles) at each training shape,
    # as built and with each probe
    from repro_torch.kernels import build
    for variant in [v for v in SSDBWD_VARIANTS if v.startswith("timeline")]:
        lib = ctypes.CDLL(str(build.BUILD_DIR.parent / "ssd_scan_bwd_variants" / variant
                              / "lib.so"))
        for name, case in cases.items():
            plan = sk.bwd_plan_for(case[0], case[3])
            call, _ = launch(fns[variant], case, plan["hb"], plan["nk"])
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            clk = (ctypes.c_ulonglong * (16 * 8 * 10))()
            assert lib.ssd_bwd_timeline(clk) == 0
            stamps = torch.tensor(list(clk), dtype=torch.float64).reshape(16, 8, 10)
            nph = len(BWD_TIMELINE_PHASES)
            for wp in range(4 * plan["hb"]):
                s_ = stamps[wp]                       # tiles walk 7 .. 0
                phase = torch.empty(7, nph, dtype=torch.float64)
                phase[:, 0] = s_[:7, 0] - s_[1:, nph - 1]   # from the tile after's end
                phase[:, 1:] = s_[:7, 1:] - s_[:7, :-1]
                print(f"TUNE ssdbwd {variant} {name} hb={plan['hb']} warp {wp}: cycles a tile "
                      "by phase (mean of tiles 0-6): " + ", ".join(
                          f"{n} {v:.0f}" for n, v in zip(BWD_TIMELINE_PHASES,
                                                         phase.mean(0).tolist()))
                      + f"; whole walk {float(s_[0, nph - 1] - s_[7, 0]):.0f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda, chunked_prefill_reference
    from repro_torch.kernels.paged_attention import kernel as pk
    parts = sys.argv[1:] or ["chunked", "flash", "ssd", "bwd", "ssdbwd"]
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    cs.cuda_ms(flush.zero_, flush=flush)
    if "bwd" in parts:
        tune_bwd(dev, flush)
    if "ssd" in parts:
        tune_ssd(dev, flush)
    if "ssdbwd" in parts:
        tune_ssdbwd(dev, flush)
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

    # the split threshold: each width on the split path (the kernel takes up
    # to SPLIT_ROWS), then on the tensor cores
    for C in (1, 2, 4, 5, 8):
        time_case("width", C, 32, 256, [(pk.SPLIT_ROWS, defaults[1]), (0, defaults[1])])
    # the verify sweeps' widths on both paths, in turns split, mma, mma,
    # split: at phase 9's slots, then at the stack's 64 rows (each row
    # ending where its decode sweep's row ends)
    shapes = {n: sh for n, sh in cs.spec_attention_shapes().items()
              if sh["C"] in cs.VERIFY_WIDTHS}
    dec = cs.stack_attention_shapes()[f"stack decode B={cs.STACK_LAYOUTS[0][1]}"]
    for C in cs.VERIFY_WIDTHS:
        shapes[f"stack B={dec['B']} C={C}"] = dict(
            dec, C=C, starts=[s + 1 - C for s in dec["starts"]], nvalid=[C] * dec["B"])
    for name, sh in shapes.items():
        C = sh["C"]
        *t, kw = cs.attention_case(dev, H=32, Hkv=8, D=128, ps=16, dtype=torch.bfloat16,
                                   seed=1, **sh)
        q, kp, vp, pt, lengths, qpos = t
        starts = qpos[:, 0].contiguous()
        plain = chunked_prefill_reference(*t, **kw)
        times, errs = {"split": [], "mma": []}, {}
        for max_rows in (pk.SPLIT_ROWS, 0, 0, pk.SPLIT_ROWS):
            pk.SPLIT_MAX_ROWS = max_rows
            path = pk.plan_for(q, kp, pt).path
            errs[path] = cs.max_err(chunked_prefill_cuda(q, kp, vp, pt, lengths, starts, **kw),
                                    plain)
            times[path].append(cs.cuda_ms(
                lambda: chunked_prefill_cuda(q, kp, vp, pt, lengths, starts, **kw), flush=flush))
        pk.SPLIT_MAX_ROWS = defaults[0]
        bms, by = cs.attention_bound(q, kp, lengths, qpos, torch.bfloat16)
        sdpa = cs.cuda_ms(cs.sdpa_call(*t, kw["scale"]), flush=flush)
        print(f"TUNE verify {name} rows={C * 4}: split {times['split']} mma {times['mma']} ms "
              f"(in turns split, mma, mma, split); max |out - plain| {errs}; bound {bms:.6f} "
              f"ms ({by}); sdpa {sdpa:.5f} ms; planned {pk.plan_for(q, kp, pt).path}",
              flush=True)
        del q, kp, vp, pt, lengths, qpos, t, plain
        torch.cuda.empty_cache()
    # the split count: 512 and 4096 positions a row
    for maxp, num_pages in ((32, 256), (256, 1040)):
        time_case(f"positions={maxp * 16}", 1, maxp, num_pages,
                  [(defaults[0], b) for b in (2, 4, 8, 16)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
