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
// flattened to (d, H * hd). The head over a tied int8 embedding reads
// embed.q transposed (strides (1, d)) with a col_scale, which is the TPU
// kernel's own form.
//
// Three kernels; the wrapper (kernels/quant_matmul/kernel.py, _plan) picks
// one by the call's shape and passes its grid:
//
//  - stream (M <= 16, decode; fp32 or bf16 x). Bound by bytes: the int8
//    weights must stream once at HBM rate, and output tiles alone would
//    give 64 blocks (16 for wk / wv) on 132 SMs, each walking all of K in
//    series. So K is split across blocks (grid.y) so that the grid has
//    at least 2 blocks a SM (one wave of the 4 a SM holds where the split
//    ranges stay >= 64 rows), and the block's slice of x (<= 4 rows a
//    block, grid.z) is staged once in shared memory as fp32, so the loop
//    over K has no barrier.
//      n-major weights (unit stride along N: the projections and an
//      lm_head): 128-thread blocks; a thread owns 16 consecutive columns,
//      neighbouring threads neighbouring columns, 8 threads along K. Each
//      thread streams its K rows through its own ring of 8 shared-memory
//      slots with 16-byte cp.async copies (and its row scales with 4-byte
//      ones): 7 rows in flight, no registers held for them and no barrier,
//      since a thread reads back only what it copied. int8 -> fp32 by a
//      byte permute into a float's mantissa (full-rate integer and FP32
//      pipes, not the quarter-rate conversion unit). The row scale
//      multiplies x once per (k, thread) when the thread's 16 columns
//      share one group, else each weight. The 8 K lanes of a block meet
//      through warp shuffles and a shared-memory sum at the end.
//      k-major weights (unit stride along K: the transposed tied
//      embedding): a warp owns 4 columns, each lane reads 16 bytes along K
//      per column, a warp shuffle sums the lanes.
//    With more than one split, the partial sums go to an fp32 workspace
//    (splits, M, N) allocated by the wrapper, and a second kernel adds them
//    in a fixed order (8 lanes a column over the splits, then the lanes in
//    turn), applies col_scale and casts: no atomics, so a call gives the
//    same bits every time. It is launched as a programmatic dependent
//    (griddepcontrol), so its launch overlaps the streaming grid's tail.
//    Unaligned or ragged operands (a stride, a pointer or N not a multiple
//    of 16 bytes) take a scalar load path inside the same kernels. The
//    split ranges, the cp.async copies, the byte permute, the split reduce
//    and the mma.sync helpers live in gemm_common.cuh, shared with the
//    grouped expert matmul (moe_gmm.cu).
//  - mma (M > 16 with bf16 x, prefill). Bound by operations, so the work
//    goes to the tensor cores: 128 x 64 output tiles (a weight tile is
//    dequantized once for 128 rows), 8 warps of 32 x 32, mma.sync.m16n8k16
//    bf16 -> fp32 over K steps of 64. A 3-stage cp.async ring (16 bytes a
//    thread) brings the bf16 x tile and the int8 weight tile. Each step
//    dequantizes the int8 tile into shared memory as bf16 [k][n] (the
//    k-major layout is transposed by the store), and ldmatrix.trans gives
//    the .col B fragment. The loop is software-pipelined with one barrier
//    a step: step t's products interleave with the dequant of step t + 1
//    into the other of two buffers, and the thread's row scale is loaded
//    two steps ahead (a global load in the step that uses it stalls every
//    step).
//    Precision: the row scale varies along K, so it cannot move after the
//    sum, and q * row_scale rounded once to bf16 is off by up to 2^-9 of
//    each weight; on sums of a few hundred terms whose output lands near 0
//    that breaks the bf16 tolerance (errors of 0.06 and 0.11 against 5e-2
//    in the card tests). So a
//    scaled weight w goes in as two bf16 parts, hi = w truncated to bf16
//    and lo = w - hi truncated (byte permutes, no conversion instruction;
//    hi + lo is within 2^-14 of w), and each step runs the products of
//    both; an unscaled q is exact in bf16 and runs hi alone.
//    K is split (as above, workspace and reduce) only when the output
//    tiles leave SMs idle. col_scale in the epilogue; ragged M, N and K
//    are zero-filled by the copies. wgmma and TMA are later work: they
//    need the B tile in bf16 in a swizzled layout, which an int8 source
//    does not give for free.
//  - tiled (M > 16 with fp32 x): 64 x 64 output tiles of CUDA-core fp32
//    FMAs over 32-deep K tiles of x and of the dequantized weights staged
//    in shared memory, so an fp32 call stays IEEE fp32 throughout.

#include "gemm_common.cuh"

namespace {

// ---------------------------------------------------------------- tiled
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

// ---------------------------------------------------------------- stream
constexpr int kStreamThreads = 128;                            // n-major block
constexpr int kStreamCols = 16;                                // columns a thread owns
constexpr int kStreamTX = 16;                                  // threads along N
constexpr int kStreamTY = kStreamThreads / kStreamTX;          // threads along K
constexpr int kStreamBlockN = kStreamTX * kStreamCols;         // 256 columns a block
constexpr int kStreamStages = 8;   // a thread's ring of K rows in shared memory (7 in flight)
constexpr int kKMajorThreads = 256;                            // k-major block
constexpr int kKMajorCols = 4;                                 // columns a warp (k-major)
constexpr int kKMajorBlockN = kKMajorThreads / 32 * kKMajorCols;  // 32 columns a block

// The final value of one output: with one split straight into out (col
// scale applied, cast), else the partial sum into the split's workspace row.
template <typename TX>
__device__ __forceinline__ void store_partial(float s, float* ws, TX* out,
                                              const float* col_scale, int split, int M, int N,
                                              int m, int n) {
  if (ws != nullptr)
    ws[(static_cast<long long>(split) * M + m) * N + n] = s;
  else
    out[static_cast<long long>(m) * N + n] =
        from_f32<TX>(col_scale != nullptr ? s * col_scale[n] : s);
}

// n-major weights: grid (ceil(N / 256), splits, ceil(M / RM)), 4 blocks a SM.
template <typename TX, int RM>
__global__ void __launch_bounds__(kStreamThreads, 4)
    w8a16_stream_n_kernel(const TX* __restrict__ x, long long ldx,
                          const int8_t* __restrict__ q, long long q_sk, long long q_sn,
                          const float* __restrict__ row_scale, int groups,
                          const float* __restrict__ col_scale, float* __restrict__ ws,
                          TX* __restrict__ out, int M, int K, int N, int splits) {
  __shared__ __align__(16) float xs[kXsFloats];                       // [k][RM]
  __shared__ __align__(16) float red[kStreamThreads / 32][kStreamBlockN];
  const int tid = threadIdx.x, tx = tid % kStreamTX, ty = tid / kStreamTX;
  const int m0 = blockIdx.z * RM, rows = min(RM, M - m0);
  int kb, ke;
  split_range(K, splits, blockIdx.y, kb, ke);
  const int klen = ke - kb;
  const int nb = blockIdx.x * kStreamBlockN, n0 = nb + tx * kStreamCols;
  const int group = N / groups;
  const bool live = n0 < N;
  const bool vec = q_sn == 1 && q_sk % 16 == 0 && N % 16 == 0 && aligned16(q);
  // n0 .. n0 + 15 share one row-scale group: one scale a (k, thread), loaded
  // beside the weights
  const bool one_scale = row_scale != nullptr && group % kStreamCols == 0;
  const float* rs_col = one_scale ? row_scale + n0 / group : nullptr;

  float acc[RM][kStreamCols];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < kStreamCols; ++j) acc[r][j] = 0.f;

  // one K row: x (times the row's scale when the 16 columns share a group)
  // times the 16 dequantized weights
  auto fma_row = [&](int k, float s, float (&f)[kStreamCols]) {
    float xv[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) xv[r] = xs[(k - kb) * RM + r] * s;
    if (row_scale != nullptr && !one_scale) {
      const float* rs = row_scale + static_cast<long long>(k) * groups;
#pragma unroll
      for (int j = 0; j < kStreamCols; ++j) f[j] *= n0 + j < N ? rs[(n0 + j) / group] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < kStreamCols; ++j) acc[r][j] = fmaf(xv[r], f[j], acc[r][j]);
  };
  // a thread's K rows kb + ty + i * 8 stream through its own ring slots by
  // cp.async (one commit group a row, empty past its last), so no barrier
  // guards them: the thread reads back only what it copied, and 7 rows (and
  // their row scales) are in flight while one is summed
  __shared__ __align__(16) int4 wring[kStreamStages][kStreamThreads];
  __shared__ float sring[kStreamStages][kStreamThreads];
  const int nrows = klen > ty ? (klen - ty + kStreamTY - 1) / kStreamTY : 0;
  auto copy_row = [&](int i) {
    if (i < nrows) {
      const int k = kb + ty + i * kStreamTY;
      cp_async16(&wring[i % kStreamStages][tid], q + k * q_sk + n0, 16);
      if (one_scale)
        cp_async4(&sring[i % kStreamStages][tid], rs_col + static_cast<long long>(k) * groups);
    }
    cp_async_commit();
  };

  const bool ring = vec && live;
  if (ring) {
#pragma unroll
    for (int i = 0; i < kStreamStages - 1; ++i) copy_row(i);   // in flight while x is staged
  }
  for (int i = tid; i < RM * klen; i += kStreamThreads) {
    const int r = i / klen, kk = i % klen;
    xs[kk * RM + r] =
        r < rows ? to_f32(x[static_cast<long long>(m0 + r) * ldx + kb + kk]) : 0.f;
  }
  __syncthreads();

  if (ring) {
    for (int i = 0; i < nrows; ++i) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStreamStages - 2));
      const int4 v = wring[i % kStreamStages][tid];
      const float sc = one_scale ? sring[i % kStreamStages][tid] : 1.f;
      copy_row(i + kStreamStages - 1);   // into slot (i - 1) % 8, read back a row ago
      float f[kStreamCols];
      dequant16(v, f);
      fma_row(kb + ty + i * kStreamTY, sc, f);
    }
  } else if (live) {
    for (int k = kb + ty; k < ke; k += kStreamTY) {
      float f[kStreamCols];
#pragma unroll
      for (int j = 0; j < kStreamCols; ++j)
        f[j] = n0 + j < N ? to_f32(q[k * q_sk + (n0 + j) * q_sn]) : 0.f;
      fma_row(k, one_scale ? rs_col[static_cast<long long>(k) * groups] : 1.f, f);
    }
  }
  // the split reduce may launch now (programmatic dependent launch): its
  // blocks wait for this grid's writes before they read the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // sum the block's 8 K lanes: the two of a warp by shuffle, then the 4
  // warps through shared memory, one output row at a time
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < kStreamCols; ++j)
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < kStreamCols; j += 4)
        *reinterpret_cast<float4*>(&red[warp][lane * kStreamCols + j]) =
            make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
    }
    __syncthreads();
    for (int c = tid; c < kStreamBlockN; c += kStreamThreads) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kStreamThreads / 32; ++v) s += red[v][c];
      if (nb + c < N) store_partial(s, ws, out, col_scale, blockIdx.y, M, N, m0 + r, nb + c);
    }
    __syncthreads();
  }
}

// k-major weights: grid (ceil(N / 32), splits, ceil(M / RM)).
template <typename TX, int RM>
__global__ void __launch_bounds__(kKMajorThreads)
    w8a16_stream_k_kernel(const TX* __restrict__ x, long long ldx,
                          const int8_t* __restrict__ q, long long q_sk, long long q_sn,
                          const float* __restrict__ row_scale, int groups,
                          const float* __restrict__ col_scale, float* __restrict__ ws,
                          TX* __restrict__ out, int M, int K, int N, int splits) {
  __shared__ __align__(16) float xs[kXsFloats];                       // [RM][ld]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.z * RM, rows = min(RM, M - m0);
  int kb, ke;
  split_range(K, splits, blockIdx.y, kb, ke);
  const int klen = ke - kb, ld = (klen + 15) / 16 * 16;
  const int nbase = blockIdx.x * kKMajorBlockN + warp * kKMajorCols;
  const int group = N / groups;
  const bool vec = q_sk == 1 && q_sn % 16 == 0 && K % 16 == 0 && aligned16(q);

  for (int i = tid; i < RM * klen; i += kKMajorThreads) {
    const int r = i / klen, kk = i % klen;
    xs[r * ld + kk] = r < rows ? to_f32(x[static_cast<long long>(m0 + r) * ldx + kb + kk]) : 0.f;
  }
  __syncthreads();

  float acc[kKMajorCols][RM];
#pragma unroll
  for (int c = 0; c < kKMajorCols; ++c)
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[c][r] = 0.f;

  if (vec) {
    for (int k = kb + lane * 16; k < ke; k += 32 * 16) {
      float f[kKMajorCols][16];
#pragma unroll
      for (int c = 0; c < kKMajorCols; ++c) {
        const int n = nbase + c;
        if (n < N) {
          dequant16(__ldg(reinterpret_cast<const int4*>(q + n * q_sn + k)), f[c]);
          if (row_scale != nullptr) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              f[c][j] *= row_scale[static_cast<long long>(k + j) * groups + n / group];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) f[c][j] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float* xr = xs + r * ld + (k - kb);
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + j);
#pragma unroll
          for (int c = 0; c < kKMajorCols; ++c) {
            acc[c][r] = fmaf(xv.x, f[c][j], acc[c][r]);
            acc[c][r] = fmaf(xv.y, f[c][j + 1], acc[c][r]);
            acc[c][r] = fmaf(xv.z, f[c][j + 2], acc[c][r]);
            acc[c][r] = fmaf(xv.w, f[c][j + 3], acc[c][r]);
          }
        }
      }
    }
  } else {
    for (int k = kb + lane; k < ke; k += 32) {
#pragma unroll
      for (int c = 0; c < kKMajorCols; ++c) {
        const int n = nbase + c;
        float b = 0.f;
        if (n < N) {
          b = to_f32(q[k * q_sk + n * q_sn]);
          if (row_scale != nullptr) b *= row_scale[static_cast<long long>(k) * groups + n / group];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) acc[c][r] = fmaf(xs[r * ld + k - kb], b, acc[c][r]);
      }
    }
  }

  // butterfly over the 32 lanes: a fixed order, every lane ends with the sum
#pragma unroll
  for (int c = 0; c < kKMajorCols; ++c)
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int o = 16; o > 0; o /= 2) acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kKMajorCols; ++c)
#pragma unroll
      for (int r = 0; r < RM; ++r)
        if (r < rows && nbase + c < N)
          store_partial(acc[c][r], ws, out, col_scale, blockIdx.y, M, N, m0 + r, nbase + c);
  }
}

// ---------------------------------------------------------------- mma
constexpr int kTcM = 128;
constexpr int kTcN = 64;
constexpr int kTcK = 64;
constexpr int kTcThreads = 256;     // 8 warps, 4 (M) x 2 (N), 32 x 32 outputs each
constexpr int kTcPad = 8;           // bf16 padding per row: ldmatrix rows on distinct banks
constexpr int kTcWRow = kTcK + 16;  // int8 tile row stride (bytes): 16-byte aligned
constexpr int kTcStages = 3;        // cp.async ring: 2 stages in flight while one is used
using TcXTile = __nv_bfloat16[kTcM][kTcK + kTcPad];   // x tile [m][k]
using TcBTile = __nv_bfloat16[kTcK][kTcN + kTcPad];   // dequantized weight tile [k][n]
constexpr int kTcWTile = kTcN * kTcWRow;              // int8 tile: [k][n] or [n][k]
constexpr int kTcSmem = kTcStages * (static_cast<int>(sizeof(TcXTile)) + kTcWTile) +
                        4 * static_cast<int>(sizeof(TcBTile));   // 2 buffers x (hi, lo)

// grid (ceil(N / 64), ceil(M / 128), splits), bf16 x and out; with splits
// > 1, block z sums its split's rows of K into ws (fp32, no col scale).
__global__ void __launch_bounds__(kTcThreads, 2)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const int8_t* __restrict__ q, long long q_sk, long long q_sn,
                     const float* __restrict__ row_scale, int groups,
                     const float* __restrict__ col_scale, float* __restrict__ ws,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N, int splits) {
  if (splits > 1) {  // this block's rows of K, as a matrix of their own
    int kb, ke;
    split_range(K, splits, blockIdx.z, kb, ke);
    x += kb;
    q += kb * q_sk;
    if (row_scale != nullptr) row_scale += static_cast<long long>(kb) * groups;
    K = ke - kb;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  auto* as = reinterpret_cast<TcXTile*>(smem);                                  // [stage]
  int8_t* wq = reinterpret_cast<int8_t*>(smem + kTcStages * sizeof(TcXTile));   // [stage]
  auto* bs = reinterpret_cast<TcBTile*>(smem + kTcStages * (sizeof(TcXTile) + kTcWTile));
  // bs[2 * d]: hi, bs[2 * d + 1]: lo of dequant buffer d (step t uses d = t % 2)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kTcM, n0 = blockIdx.x * kTcN;
  const bool k_major = q_sk == 1 && q_sn != 1;
  const bool x_vec = ldx % 8 == 0 && aligned16(x);
  const bool w_vec = aligned16(q) && (k_major ? q_sn % 16 == 0 : q_sn == 1 && q_sk % 16 == 0);
  const int group = N / groups;
  const int steps = (K + kTcK - 1) / kTcK;
  const bool split = row_scale != nullptr;  // else the weights are exact in bf16: hi alone

  // stage t's x tile (128 x 64 bf16: 4 chunks of 8 a thread) and int8 tile
  // (64 rows of 64 bytes: 1 chunk of 16 a thread) into buffer buf
  // a thread's copies: x chunks (rows tid / 8 + 32 u, 8 columns at
  // xc) and one 16-byte int8 chunk (tile row wr, bytes wc .. wc + 15)
  const int xc = tid % 8 * 8, wr = tid / 4, wc = tid % 4 * 16;
  const __nv_bfloat16* xrow[kTcM / 32];
#pragma unroll
  for (int u = 0; u < kTcM / 32; ++u) {
    const int m = m0 + tid / 8 + 32 * u;
    xrow[u] = m < M ? x + m * ldx + xc : nullptr;
  }
  // n-major: tile row = k, bytes along n; k-major: tile row = n, bytes along k
  const int wcol = k_major ? n0 + wr : n0 + wc;
  const int8_t* wsrc = wcol < N ? q + (k_major ? wcol * q_sn + wc : wr * q_sk + wcol) : nullptr;
  const int wvalid_n = k_major ? 16 : max(0, min(16, N - wcol));

  // stage t's x tile (128 x 64 bf16) and int8 tile (64 x 64) into buffer buf
  auto load_stage = [&](int t, int buf) {
    const int k0 = t * kTcK;
#pragma unroll
    for (int u = 0; u < kTcM / 32; ++u) {
      __nv_bfloat16* dst = &as[buf][tid / 8 + 32 * u][xc];
      const int valid = xrow[u] != nullptr && k0 + xc < K ? min(8, K - k0 - xc) : 0;
      if (x_vec) {
        cp_async16(dst, valid ? xrow[u] + k0 : x, valid * 2);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = j < valid ? xrow[u][k0 + j] : __float2bfloat16(0.f);
      }
    }
    int8_t* dst = wq + buf * kTcWTile + wr * kTcWRow + wc;
    const int valid = wsrc == nullptr ? 0
                      : k_major       ? max(0, min(16, K - k0 - wc))
                      : k0 + wr < K   ? wvalid_n
                                      : 0;
    // the chunk's first byte: k-major steps along k (unit stride), n-major
    // down the rows
    const int8_t* src = valid ? wsrc + (k_major ? k0 : k0 * q_sk) : q;
    if (w_vec) {
      cp_async16(dst, src, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = j >= valid ? int8_t(0) : src[j * (k_major ? q_sk : q_sn)];
    }
  };

  // n-major weights whose 16 columns a thread takes share a group: the
  // thread's one row scale of step t, loaded a step ahead
  const bool one_scale = split && !k_major && group % 16 == 0 && wsrc != nullptr;
  const float* rs_col = one_scale ? row_scale + wcol / group : nullptr;
  auto stage_scale = [&](int t) {
    const int k = t * kTcK + wr;
    return one_scale && k < K ? rs_col[static_cast<long long>(k) * groups] : 0.f;
  };

  // stage t's int8 tile -> bs[2 d] = bf16(q * row_scale) (hi) and, with a
  // row scale, bs[2 d + 1] = what hi rounded off (lo); a thread takes 16 bytes
  auto dequant_stage = [&](int t, int buf, float s, int d) {
    const int k0 = t * kTcK;
    const int r = tid / 4, c = tid % 4 * 16;
    float f[16];
    dequant16(*reinterpret_cast<const int4*>(wq + buf * kTcWTile + r * kTcWRow + c), f);
    if (!k_major) {
      // row k = k0 + r, columns n0 + c .. + 15: stored along bs's rows
      const int k = k0 + r, n = n0 + c;
      if (split) {
        const float* rs = row_scale + static_cast<long long>(k) * groups;
        if (one_scale) {
#pragma unroll
          for (int j = 0; j < 16; ++j) f[j] *= s;
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) f[j] *= k < K && n + j < N ? rs[(n + j) / group] : 0.f;
        }
      }
      unsigned hi[8], lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) split_pair(f[2 * j], f[2 * j + 1], hi[j], lo[j]);
      *reinterpret_cast<uint4*>(&bs[2 * d][r][c]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(&bs[2 * d][r][c + 8]) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      if (split) {
        *reinterpret_cast<uint4*>(&bs[2 * d + 1][r][c]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(&bs[2 * d + 1][r][c + 8]) =
            make_uint4(lo[4], lo[5], lo[6], lo[7]);
      }
    } else {
      // column n = n0 + r, rows k0 + c .. + 15: stored down bs's column
      const int n = n0 + r;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + c + j;
        if (split)
          f[j] *= k < K && n < N ? row_scale[static_cast<long long>(k) * groups + n / group]
                                 : 0.f;
        const float h = bf16_trunc(f[j]);
        bs[2 * d][c + j][r] = __float2bfloat16(h);   // exact: h has 8 significant bits
        if (split) bs[2 * d + 1][c + j][r] = __float2bfloat16(bf16_trunc(f[j] - h));
      }
    }
  };

  const int wm = warp / 2 * 32, wn = warp % 2 * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group a stage, empty past the last, so that "all but the
  // newest kTcStages - 2 groups complete" always means "stage t landed"
#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < steps) load_stage(t, t);
    cp_async_commit();
  }
  // software pipeline, one barrier a step: step t's products (bs[t % 2])
  // and the dequant of stage t + 1 (into bs[(t + 1) % 2]) interleave
  float s_next = stage_scale(0);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 2));   // stage 0 landed
  __syncthreads();
  dequant_stage(0, 0, s_next, 0);
  if (steps > 1) s_next = stage_scale(1);
  for (int t = 0; t < steps; ++t) {
    const int buf = t % kTcStages, d = t % 2;
    const float s_cur = s_next;   // stage t + 1's
    if (t + 2 < steps) s_next = stage_scale(t + 2);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 3));   // stage t + 1 landed
    // bs[d] is complete, stage t + 1 has landed for every thread, and every
    // warp is done with step t - 1: its x buffer (which stage t + 3 now
    // takes) and bs[d ^ 1]
    __syncthreads();
    if (t + kTcStages - 1 < steps) load_stage(t + kTcStages - 1, (t + kTcStages - 1) % kTcStages);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &as[buf][wm + mi * 16 + lane % 16][kk + lane / 16 * 8]);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        if (part == 1 && !split) break;
        // B fragments of two n8 tiles from bs [k][n], transposed by ldmatrix:
        // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), rows addressed by lanes
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4_trans(
              r, &bs[2 * d + part][kk + lane / 8 % 2 * 8 + lane % 8][wn + nj * 16 + lane / 16 * 8]);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
    if (t + 1 < steps) dequant_stage(t + 1, (t + 1) % kTcStages, s_cur, d ^ 1);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::);   // the split reduce, if any

  // accumulator fragment: rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + lane / 4 + h * 8;
        const int n = n0 + wn + ni * 8 + lane % 4 * 2;
        if (m >= M || n >= N) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (ws != nullptr) {
          float* p = ws + (static_cast<long long>(blockIdx.z) * M + m) * N + n;
          p[0] = v0;
          if (n + 1 < N) p[1] = v1;
          continue;
        }
        __nv_bfloat16* o = out + static_cast<long long>(m) * N + n;
        if (col_scale != nullptr) {
          v0 *= col_scale[n];
          if (n + 1 < N) v1 *= col_scale[n + 1];
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (n + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
}

enum Path : int { kTiled = 0, kStreamN = 1, kStreamK = 2, kMma = 3 };

template <typename TX, int RM>
int launch_stream(int path, dim3 grid, int splits, const TX* x, long long ldx, const int8_t* q,
                  long long q_sk, long long q_sn, const float* row_scale, int groups,
                  const float* col_scale, float* ws, TX* out, int M, int K, int N,
                  cudaStream_t s) {
  if (!split_fits(K, splits, RM)) return -1;   // the split's slice of x must fit the staging buffer
  float* part = splits > 1 ? ws : nullptr;
  if (path == kStreamN)
    w8a16_stream_n_kernel<TX, RM><<<grid, kStreamThreads, 0, s>>>(
        x, ldx, q, q_sk, q_sn, row_scale, groups, col_scale, part, out, M, K, N, splits);
  else
    w8a16_stream_k_kernel<TX, RM><<<grid, kKMajorThreads, 0, s>>>(
        x, ldx, q, q_sk, q_sn, row_scale, groups, col_scale, part, out, M, K, N, splits);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 || splits <= 1
             ? err
             : launch_split_reduce<TX>(ws, splits, col_scale, out, M, N, nullptr, 0, 0, s);
}

}  // namespace

// The tile and staging constants the wrapper's plan mirrors, in this order:
// stream block columns (n-major, k-major), staged x floats, split unit rows,
// the mma and tiled kernels' output tile (rows, columns).
extern "C" void w8a16_constants(int* c) {
  c[0] = kStreamBlockN;
  c[1] = kKMajorBlockN;
  c[2] = kXsFloats;
  c[3] = kSplitRows;
  c[4] = kTcM;
  c[5] = kTcN;
  c[6] = kBlockM;
  c[7] = kBlockN;
}

// Returns the CUDA error of the launch (0 on success), -1 for a path, row
// count or dtype the kernels do not take. path: 0 tiled, 1 stream n-major,
// 2 stream k-major, 3 mma (bf16 only); grid (gx, gy, gz) and rows (the
// stream kernels' rows a block: 1, 2 or 4) and splits come from the
// wrapper's plan. Layouts: x (M, K) with row stride ldx and unit column
// stride; q (K, N) int8 at strides (q_sk, q_sn); row_scale (K, groups) fp32
// contiguous or null, groups dividing N; col_scale (N,) fp32 or null; ws
// (splits, M, N) fp32 when splits > 1; out (M, N) contiguous in x's dtype.
extern "C" int w8a16_launch(int path, int rows, int gx, int gy, int gz, int splits,
                            const void* x, long long ldx, const void* q, long long q_sk,
                            long long q_sn, const void* row_scale, int groups,
                            const void* col_scale, void* ws, void* out, int M, int K, int N,
                            int x_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* cs = static_cast<const float*>(col_scale);
  auto* wsf = static_cast<float*>(ws);
  return dispatch_dtype(x_dtype, [&](auto tx) -> int {
    using TX = std::remove_pointer_t<decltype(tx)>;
    const auto* xt = static_cast<const TX*>(x);
    auto* ot = static_cast<TX*>(out);
    switch (path) {
      case kTiled:
        w8a16_kernel<TX><<<grid, kThreads, 0, s>>>(xt, ldx, q8, q_sk, q_sn, rs, groups, cs, ot,
                                                    M, K, N);
        return static_cast<int>(cudaGetLastError());
      case kStreamN:
      case kStreamK:
        switch (rows) {
          case 1: return launch_stream<TX, 1>(path, grid, splits, xt, ldx, q8, q_sk, q_sn, rs,
                                              groups, cs, wsf, ot, M, K, N, s);
          case 2: return launch_stream<TX, 2>(path, grid, splits, xt, ldx, q8, q_sk, q_sn, rs,
                                              groups, cs, wsf, ot, M, K, N, s);
          case 4: return launch_stream<TX, 4>(path, grid, splits, xt, ldx, q8, q_sk, q_sn, rs,
                                              groups, cs, wsf, ot, M, K, N, s);
          default: return -1;
        }
      case kMma:
        if constexpr (std::is_same_v<TX, __nv_bfloat16>) {
          static const cudaError_t attr = cudaFuncSetAttribute(
              w8a16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
          if (attr != cudaSuccess) return static_cast<int>(attr);
          w8a16_mma_kernel<<<grid, kTcThreads, kTcSmem, s>>>(
              xt, ldx, q8, q_sk, q_sn, rs, groups, cs, splits > 1 ? wsf : nullptr, ot, M, K, N,
              splits);
          const int err = static_cast<int>(cudaGetLastError());
          return err != 0 || splits <= 1
                     ? err
                     : launch_split_reduce<TX>(wsf, splits, cs, ot, M, N, nullptr, 0, 0, s);
        } else {
          return -1;
        }
      default: return -1;
    }
  });
}
