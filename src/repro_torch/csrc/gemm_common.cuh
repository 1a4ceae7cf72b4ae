// Device code shared by the tensor-core sources: the two matmuls'
// (quant_matmul.cu, w8a16; moe_gmm.cu, the grouped expert matmul) streaming split
// ranges, 16-byte cp.async copies into a thread's own shared-memory ring,
// the int8 byte permute, the fixed-order split reduce, and the tensor-core
// kernels' ldmatrix / mma.sync helpers, ex2 and the bf16 hi + lo splits.
#pragma once

#include "common.cuh"

namespace {

constexpr int kXsFloats = 4096;   // streaming: staged x, rows x split length <= 16 KB of fp32
constexpr int kSplitRows = 16;    // split ranges start at multiples of 16 rows of K
constexpr int kReduceCols = 32;   // split reduce: 32 columns x 8 lanes over the splits
constexpr int kReduceLanes = 8;

// Rows [kb, ke) of K for one split: the splits cut ceil(K / 16) units of 16
// rows as evenly as integers allow (kernels/quant_matmul/kernel.py's
// split_ranges mirrors it).
__device__ __forceinline__ void split_range(int K, int splits, int split, int& kb, int& ke) {
  const long long units = (K + kSplitRows - 1) / kSplitRows;
  kb = static_cast<int>(min(static_cast<long long>(K), split * units / splits * kSplitRows));
  ke = static_cast<int>(min(static_cast<long long>(K), (split + 1) * units / splits * kSplitRows));
}

// The longest split's slice of ``rows`` rows of x fits the staging buffer.
inline bool split_fits(int K, int splits, int rows) {
  const long long units = (K + kSplitRows - 1) / kSplitRows;
  return splits >= 1 && rows * ((units + splits - 1) / splits) * kSplitRows <= kXsFloats;
}

// 16 int8 values -> fp32, exactly: each byte, its sign bit flipped (b + 128
// in 0..255), goes into the low mantissa byte of 2^23, and 2^23 + 128 comes
// off again.
__device__ __forceinline__ void dequant16(const int4 v, float (&f)[16]) {
  const unsigned w[4] = {static_cast<unsigned>(v.x) ^ 0x80808080u,
                         static_cast<unsigned>(v.y) ^ 0x80808080u,
                         static_cast<unsigned>(v.z) ^ 0x80808080u,
                         static_cast<unsigned>(v.w) ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440 | b)) - 8388736.f;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past ``valid`` (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// out rows = the sum over splits of ws[s, row, n] (times col_scale[n]), in
// a fixed order: lane j of a column sums splits j, j + 8, ... in turn, then
// the 8 lane sums are added in lane order, so a call gives the same bits
// every time. ws is (splits, rows_total, N) fp32, out (rows_total, N).
// grid (ceil(N / 32), blocks): without tile_rows, block y sums row y; with
// it, block y sums the first tile_rows[y] rows of row tile y (block_m rows
// a tile), so the padding rows of the grouped layout are never read.
template <typename TX>
__global__ void __launch_bounds__(kReduceCols * kReduceLanes)
    split_reduce_kernel(const float* __restrict__ ws, int splits,
                        const float* __restrict__ col_scale, TX* __restrict__ out,
                        int rows_total, int N, const int* __restrict__ tile_rows, int block_m) {
  __shared__ float red[kReduceLanes][kReduceCols];
  const int c = threadIdx.x % kReduceCols, j = threadIdx.x / kReduceCols;
  const int n = blockIdx.x * kReduceCols + c;
  int row0 = blockIdx.y, nrows = 1;
  if (tile_rows != nullptr) {
    row0 = blockIdx.y * block_m;
    nrows = tile_rows[blockIdx.y];
  }
  // launched as a programmatic dependent of the kernel before it: wait for
  // that grid to finish and its workspace writes to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int r = 0; r < nrows; ++r) {
    const long long m = row0 + r;
    float s = 0.f;
    if (n < N)
      for (int sp = j; sp < splits; sp += kReduceLanes)
        s += ws[(static_cast<long long>(sp) * rows_total + m) * N + n];
    red[j][c] = s;
    __syncthreads();
    if (j == 0 && n < N) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < kReduceLanes; ++i) t += red[i][c];
      out[m * N + n] = from_f32<TX>(col_scale != nullptr ? t * col_scale[n] : t);
    }
    if (r + 1 < nrows) __syncthreads();   // red is rewritten for the next row
  }
}

// The split reduce, launched as a programmatic dependent of the kernel
// before it on the stream (it starts while that grid drains, hiding its
// launch latency, and waits for that grid's writes before reading ws).
template <typename TX>
int launch_split_reduce(const float* ws, int splits, const float* col_scale, TX* out,
                        int rows_total, int N, const int* tile_rows, int n_tiles, int block_m,
                        cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kReduceCols - 1) / kReduceCols,
                     tile_rows != nullptr ? n_tiles : rows_total);
  cfg.blockDim = dim3(kReduceCols * kReduceLanes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, split_reduce_kernel<TX>, ws, splits,
                                             col_scale, out, rows_total, N, tile_rows,
                                             block_m));
}

// ---------------------------------------------------------------- mma.sync
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (mma.sync.m16n8k16 bf16 -> fp32 from a zero accumulator)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit (ex2.approx: 2 ulp; +0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// w0, w1 -> the bf16 pair hi rounded to nearest (w0 in the low half) and
// the pair of the remainders w - hi rounded the same way: hi + lo is within
// 2^-17 of w (the SSD kernels' hi + lo parts)
__device__ __forceinline__ void split_rn(float w0, float w1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  const unsigned hu = *reinterpret_cast<const unsigned*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(w0 - __uint_as_float(hu << 16),
                                                 w1 - __uint_as_float(hu & 0xFFFF0000u));
  hi = hu;
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// the two bf16 halves of a register as floats
__device__ __forceinline__ float lo_f32(unsigned r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_f32(unsigned r) { return __uint_as_float(r & 0xFFFF0000u); }

// Every row start of a (B, L, ...) bf16 operand with row strides sb / st is
// 16 bytes aligned (cp.async's 16-byte copies).
inline bool aligned_rows(const void* p, long long sb, long long st, int B, int L) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (B == 1 || sb % 8 == 0) &&
         (L <= 1 || st % 8 == 0);
}

// w -> hi = w truncated to bf16 (its upper 16 bits) and lo = w - hi truncated
// the same way: hi + lo is within 2^-14 of w, and the split is byte
// permutes and a subtraction, no conversion instruction
__device__ __forceinline__ float bf16_trunc(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xFFFF0000u);
}
// w0, w1 -> the bf16 pairs (hi, lo) of both, w0 in the low halves
__device__ __forceinline__ void split_pair(float w0, float w1, unsigned& hi, unsigned& lo) {
  hi = __byte_perm(__float_as_uint(w0), __float_as_uint(w1), 0x7632);
  lo = __byte_perm(__float_as_uint(w0 - bf16_trunc(w0)), __float_as_uint(w1 - bf16_trunc(w1)),
                   0x7632);
}

}  // namespace
