// Grouped expert matmul (dropless MoE) on Hopper (sm_90a):
// out[m] = x[m] @ w[expert(m)] over rows sorted by expert, each expert's
// rows padded to whole kBlockM-row tiles (the layout of
// src/repro_torch/kernels/moe_gmm/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py, gmm_pallas
// (body _gmm_kernel). Same function; the per-tile expert map picks the
// weight matrix, and fp32 accumulation gives an output in x's dtype.
// Weights are fp32, bf16 or int8; int8 experts come with the int8 tree's
// scale per (expert, input row), w_scale (E, K), which multiplies each
// weight as the ws tile is staged (the w8a16 form of
// src/repro_torch/csrc/quant_matmul.cu, for the expert stack).
//
// What bounds it on the card: bytes at decode, operations at prefill. A
// decode sweep has a few rows per expert, so each expert's (K, N) weights
// are streamed once for a handful of rows (far below the flop/byte ridge);
// a prefill pack has tens to hundreds of rows per expert and becomes
// compute bound on these CUDA-core FMAs.
//
// Design:
//  - the TPU kernel holds all of K in VMEM; at Mixtral's down projection
//    K = 14336, a 16-row bf16 strip alone exceeds a block's 227 KB of shared
//    memory. So a block loops over K in kBlockK-deep tiles of x and w staged
//    in shared memory (fp32), with a 4x4 fp32 accumulator per thread in
//    registers (kBlockM x kBlockN = 64 x 64 outputs per block).
//  - grid = (N tiles, M tiles); each block reads its own tile_expert and
//    tile_rows entries. The static worst-case layout Mp = M + E*kBlockM
//    leaves up to E tiles of pure padding: their blocks exit before
//    touching the weights, so no padding tile streams an expert.
//  - inside a real tile, rows past tile_rows are neither loaded nor written,
//    and warps whose rows are all padding skip the FMAs (decode tiles hold
//    one or two real rows of 64).
//  - the ragged N and K edges are masked in the loads and the store.
//  - CUDA-core FMAs; mma.sync / wgmma with TMA staging is later work.

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ w_scale, const int* __restrict__ tile_expert,
               const int* __restrict__ tile_rows, TX* __restrict__ out, int K, int N) {
  const int tile = blockIdx.y;
  const int rows = tile_rows[tile];
  if (rows <= 0) return;  // padding tile
  const int e = tile_expert[tile];
  const int n0 = blockIdx.x * kBlockN;

  __shared__ float xs[kBlockM][kBlockK + 1];
  __shared__ __align__(16) float ws[kBlockK][kBlockN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const TX* xt = x + static_cast<size_t>(tile) * kBlockM * K;
  const TW* we = w + static_cast<size_t>(e) * K * N;
  const bool active = ty * 4 < rows;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBlockK) {
    for (int i = tid; i < kBlockM * kBlockK; i += kThreads) {
      const int r = i / kBlockK, kk = i % kBlockK;
      xs[r][kk] = (r < rows && k0 + kk < K) ? to_f32(xt[static_cast<size_t>(r) * K + k0 + kk])
                                            : 0.f;
    }
    for (int i = tid; i < kBlockK * kBlockN; i += kThreads) {
      const int kk = i / kBlockN, nn = i % kBlockN;
      float v = (k0 + kk < K && n0 + nn < N)
                    ? to_f32(we[static_cast<size_t>(k0 + kk) * N + n0 + nn])
                    : 0.f;
      if constexpr (std::is_same_v<TW, int8_t>) {
        if (k0 + kk < K) v *= w_scale[static_cast<size_t>(e) * K + k0 + kk];
      }
      ws[kk][nn] = v;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
        const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    TX* orow = out + (static_cast<size_t>(tile) * kBlockM + r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) orow[n] = from_f32<TX>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int gmm_block_m() { return kBlockM; }

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// dtype. Layouts: x (n_tiles * kBlockM, K); w (E, K, N) fp32, bf16 or int8
// (w_dtype kInt8, then w_scale (E, K) fp32; null otherwise); tile_expert,
// tile_rows (n_tiles,) int32; out (n_tiles * kBlockM, N), written only at
// each tile's first tile_rows rows; all contiguous.
extern "C" int gmm_launch(const void* x, const void* w, const void* w_scale,
                          const void* tile_expert, const void* tile_rows, void* out,
                          int n_tiles, int K, int N, int x_dtype, int w_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(x_dtype, [&](auto tx) {
    using TX = std::remove_pointer_t<decltype(tx)>;
    auto launch = [&](auto tw) {
      using TW = std::remove_pointer_t<decltype(tw)>;
      const dim3 grid((N + kBlockN - 1) / kBlockN, n_tiles);
      gmm_kernel<TX, TW><<<grid, kThreads, 0, s>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<const float*>(w_scale), static_cast<const int*>(tile_expert),
          static_cast<const int*>(tile_rows), static_cast<TX*>(out), K, N);
      return static_cast<int>(cudaGetLastError());
    };
    if (w_dtype == kInt8) return launch(static_cast<int8_t*>(nullptr));
    return dispatch_dtype(w_dtype, launch);
  });
}
