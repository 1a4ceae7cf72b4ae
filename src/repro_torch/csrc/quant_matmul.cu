// Weight-only int8 matmul (w8a16) on Hopper (sm_90a):
//   out[m, n] = (sum_k x[m, k] * q[k, n] * row_scale[k, n / (N / G)]) * col_scale[n]
// with x (M, K) fp32 or bf16, q (K, N) int8 read through its two strides,
// fp32 accumulation and the output in x's dtype. Either scale may be absent.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py,
// w8a16_matmul_pallas (body _w8a16_kernel): int8 weight tiles dequantized
// in registers, an fp32 accumulator over K, the per-output-channel scale
// (col_scale) applied once after the K loop. The row scale is the layout
// the model's int8 tree has (quantize_params_int8 reduces over a leaf's
// last axis): one scale per input row (G = 1) for a (K, N) projection, one
// per (input row, head) (G = H heads of N / G columns) for wq / wk / wv
// flattened to (d, H * hd). It multiplies each weight as the tile is
// staged. The head over a tied int8 embedding reads embed.q transposed
// (strides (1, d)) with a col_scale, which is the TPU kernel's own form.
//
// What bounds it on the card: bytes at decode (a few rows: the int8
// weights stream once, half of bf16's bytes), operations at prefill
// (hundreds of rows; these are CUDA-core fp32 FMAs, far from the tensor
// cores' rate).
//
// Design (the simple kernel; mma.sync / wgmma with TMA staging is later
// work):
//  - grid = (N tiles, M tiles) of kBlockM x kBlockN = 64 x 64 outputs, a
//    4 x 4 fp32 accumulator per thread; the block loops over K in
//    kBlockK-deep tiles of x and of the dequantized weights staged in
//    shared memory as fp32.
//  - a weight with unit stride along K (the transposed embedding) is
//    staged walking K fastest, so neighbouring threads still read
//    neighbouring bytes; the padded ws rows keep the transposed stores to
//    4-way bank conflicts.
//  - rows past M are neither loaded nor written, and warps whose rows are
//    all past M skip the FMAs (a decode call has 4 rows of 64); the ragged
//    N and K edges are masked in the loads and the store.

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename TX>
__global__ void __launch_bounds__(kThreads)
    w8a16_kernel(const TX* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                 long long q_sk, long long q_sn, const float* __restrict__ row_scale,
                 int groups, const float* __restrict__ col_scale, TX* __restrict__ out, int M,
                 int K, int N) {
  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * kBlockN;
  const int rows = min(kBlockM, M - m0);
  const int group = N / groups;  // output columns that share one row-scale column
  const bool k_major = q_sk == 1 && q_sn != 1;

  __shared__ float xs[kBlockM][kBlockK + 1];
  __shared__ __align__(16) float ws[kBlockK][kBlockN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const bool active = ty * 4 < rows;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBlockK) {
    for (int i = tid; i < kBlockM * kBlockK; i += kThreads) {
      const int r = i / kBlockK, kk = i % kBlockK;
      xs[r][kk] = (r < rows && k0 + kk < K)
                      ? to_f32(x[static_cast<long long>(m0 + r) * ldx + k0 + kk])
                      : 0.f;
    }
    for (int i = tid; i < kBlockK * kBlockN; i += kThreads) {
      const int kk = k_major ? i % kBlockK : i / kBlockN;
      const int nn = k_major ? i / kBlockK : i % kBlockN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N) {
        v = to_f32(q[k * q_sk + n * q_sn]);
        if (row_scale != nullptr) v *= row_scale[static_cast<long long>(k) * groups + n / group];
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
    TX* orow = out + static_cast<long long>(m0 + r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) orow[n] = from_f32<TX>(col_scale != nullptr ? acc[i][j] * col_scale[n]
                                                             : acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int w8a16_block_m() { return kBlockM; }

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// dtype. Layouts: x (M, K) with row stride ldx and unit column stride; q
// (K, N) int8 at strides (q_sk, q_sn); row_scale (K, groups) fp32
// contiguous or null, groups dividing N; col_scale (N,) fp32 or null; out
// (M, N) contiguous in x's dtype.
extern "C" int w8a16_launch(const void* x, long long ldx, const void* q, long long q_sk,
                            long long q_sn, const void* row_scale, int groups,
                            const void* col_scale, void* out, int M, int K, int N,
                            int x_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(x_dtype, [&](auto tx) {
    using TX = std::remove_pointer_t<decltype(tx)>;
    const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
    w8a16_kernel<TX><<<grid, kThreads, 0, s>>>(
        static_cast<const TX*>(x), ldx, static_cast<const int8_t*>(q), q_sk, q_sn,
        static_cast<const float*>(row_scale), groups, static_cast<const float*>(col_scale),
        static_cast<TX*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  });
}
