// Grouped expert matmul (dropless MoE) on Hopper (sm_90a):
// out[m] = x[m] @ w[expert(m)] over rows sorted by expert, each expert's
// rows padded to whole row tiles (the layout of
// src/repro_torch/kernels/moe_gmm/ops.py, its row tile from the plan).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py, gmm_pallas
// (body _gmm_kernel). Same function; the per-tile expert map picks the
// weight matrix, and fp32 accumulation gives an output in x's dtype.
// Weights are fp32, bf16 or int8; int8 experts come with the int8 tree's
// scale per (expert, input row), w_scale (E, K).
//
// Three kernels; the wrapper (kernels/moe_gmm/kernel.py, _plan) picks one
// from what the host knows (total rows M, K, N, E and the dtypes) and
// passes its grid. The rows per expert live on the device: every block
// reads its own tile_expert / tile_rows entry, and a block whose tile holds
// no row (the layout's worst case leaves up to E such tiles) exits before
// it touches the weights.
//
//  - stream (M <= 16 rows in all, decode; any x and weight dtype). Bound
//    by bytes: each active expert's (K, N) weights must stream once at HBM
//    rate for a few rows. Rows are laid out in 16-row tiles (M <= 16 puts
//    at most 16 rows on an expert). grid (column blocks x row groups, K
//    splits, row tiles): a block takes 256 columns, one group of RM <= 4
//    of its tile's rows (groups of one column block are neighbouring
//    blocks, so a second group reads the weights from L2) and one split
//    of K. The split count gives the likely-active tiles, min(M, E), >= 2
//    blocks a SM. Load path of the w8a16 streaming kernel
//    (quant_matmul.cu): 128 threads, a thread owns 16 consecutive columns,
//    8 threads along K; each streams its K rows through its own ring of
//    shared-memory slots with 16-byte cp.async copies (an int8 row's
//    scale beside it with a 4-byte one), so the K loop has no barrier;
//    int8 -> fp32 by byte permute, bf16 -> fp32 by a shift; the group's
//    real rows of x staged once as fp32, times the row scale once per
//    (k, thread). Rows past the tile's count are neither loaded nor
//    summed. With more than one split the partial sums go to an fp32
//    workspace (splits, Mp, N), and the shared split reduce adds them in a
//    fixed order over each tile's real rows (a programmatic dependent
//    launch; no atomics, so a call gives the same bits every time).
//  - mma (M > 16 with bf16 x, bf16 or int8 weights: prefill). A pack of
//    256 tokens top-2 puts ~64 rows on an expert, under the flop/byte
//    ridge, so the aim is to read each weight tile once per expert and
//    keep the tensor cores fed: 64 x 128 output tiles (64 rows: one tile
//    usually holds all of an expert's rows), 8 warps of 32 x 32,
//    mma.sync.m16n8k16 bf16 -> fp32 over K steps of 64, a cp.async ring
//    (4 stages; int8 2), ldmatrix.trans B fragments from the [k][n]
//    weight tile; 16-row halves of a warp's rows past the tile's count
//    skip the products. The tensor cores truncate as they accumulate, so
//    each step's products are summed from zero and added to the
//    accumulator in fp32 (one chain over all of K drifted a bf16 step from
//    the fp32 plain version). bf16 weights go to the tensor cores straight
//    from the ring. int8 weights: the scale varies along K, so it cannot
//    move after the sum, and q * scale rounded once to bf16 is off by up
//    to 2^-9 of each weight. Two bf16 parts (w8a16's hi + lo, within
//    2^-16) still put outputs of size ~10 (K = 40, unit weights) one bf16
//    step (0.0625) from the fp32 plain version, past the 5e-2 edge-case
//    tolerance. So the scale goes onto x (the same products, q exact in
//    bf16): a pre-pass writes x s in fp32 as three bf16 parts, hi + mid +
//    lo (truncations: their sum is x s as fp32 holds it), once a call;
//    each step converts the int8 tile to bf16 and runs the products of all
//    three parts, smallest first. K is split (workspace and reduce as
//    above) only where the likely tiles leave the last wave mostly empty.
//  - tiled (M > 16 otherwise: fp32 x): 64 x 64 output tiles of CUDA-core
//    fp32 FMAs over 32-deep K tiles staged in shared memory (int8 weights
//    times their scale as they are staged), so an fp32 call stays IEEE
//    fp32 throughout.
// Ragged K and N (N not a multiple of 16, K not of 8) and unaligned
// operands take scalar load paths inside the same kernels.

#include "gemm_common.cuh"

namespace {

// ---------------------------------------------------------------- tiled
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

// ---------------------------------------------------------------- stream
constexpr int kStreamBlockM = 16;                         // rows a tile (layout)
constexpr int kStreamThreads = 128;
constexpr int kStreamCols = 16;                           // columns a thread owns
constexpr int kStreamTX = 16;                             // threads along N
constexpr int kStreamTY = kStreamThreads / kStreamTX;     // threads along K
constexpr int kStreamBlockN = kStreamTX * kStreamCols;    // 256 columns a block

// a thread's ring of K rows: 8 int8 rows of 16 bytes, 6 bf16 rows of 32, 3
// fp32 rows of 64 (16-24 KB a block)
template <typename TW>
__host__ __device__ constexpr int stream_stages() {
  return sizeof(TW) == 1 ? 8 : sizeof(TW) == 2 ? 6 : 3;
}

// one ring row (16 weights, sizeof(TW) 16-byte chunks) -> 16 fp32 values
__device__ __forceinline__ void row_to_f32(const int4* v, const int8_t*, float (&f)[16]) {
  dequant16(v[0], f);
}
__device__ __forceinline__ void row_to_f32(const int4* v, const __nv_bfloat16*,
                                           float (&f)[16]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const unsigned w[4] = {static_cast<unsigned>(v[c].x), static_cast<unsigned>(v[c].y),
                           static_cast<unsigned>(v[c].z), static_cast<unsigned>(v[c].w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[8 * c + 2 * i] = __uint_as_float(w[i] << 16);
      f[8 * c + 2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}
__device__ __forceinline__ void row_to_f32(const int4* v, const float*, float (&f)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[4 * c] = __int_as_float(v[c].x);
    f[4 * c + 1] = __int_as_float(v[c].y);
    f[4 * c + 2] = __int_as_float(v[c].z);
    f[4 * c + 3] = __int_as_float(v[c].w);
  }
}

// grid (ceil(N / 256) * groups, splits, n_tiles), 4 blocks a SM. Block x
// = column block * groups + row group; the group takes rows [g RM, g RM +
// RM) of its tile. ws (splits, n_tiles * 16, N) with splits > 1, else null.
template <typename TX, typename TW, int RM>
__global__ void __launch_bounds__(kStreamThreads, 4)
    gmm_stream_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const float* __restrict__ w_scale, const int* __restrict__ tile_expert,
                      const int* __restrict__ tile_rows, float* __restrict__ ws,
                      TX* __restrict__ out, int K, int N, int groups, int splits,
                      int rows_total) {
  constexpr bool kInt8W = std::is_same_v<TW, int8_t>;
  constexpr int kStages = stream_stages<TW>();
  constexpr int kChunks = sizeof(TW);                    // 16-byte chunks a ring row
  const int tile = blockIdx.z, g = blockIdx.x % groups;
  const int r0 = g * RM;
  const int trows = tile_rows[tile];
  if (r0 >= trows) return;   // a padding tile, or a group past the tile's rows
  const int rows = min(RM, trows - r0);
  const int e = tile_expert[tile];
  const long long m0 = static_cast<long long>(tile) * kStreamBlockM + r0;
  int kb, ke;
  split_range(K, splits, blockIdx.y, kb, ke);
  const int klen = ke - kb;
  const int tid = threadIdx.x, tx = tid % kStreamTX, ty = tid / kStreamTX;
  const int nb = blockIdx.x / groups * kStreamBlockN, n0 = nb + tx * kStreamCols;
  const bool live = n0 < N;
  const TW* we = w + static_cast<long long>(e) * K * N;
  const float* se = kInt8W ? w_scale + static_cast<long long>(e) * K : nullptr;
  const bool vec = N % 16 == 0 && aligned16(w);

  // staged x [k][RM]; after the K loop the block's K-lane sums reuse it
  __shared__ __align__(16) float xs[kXsFloats];
  static_assert(kXsFloats >= kStreamThreads / 32 * kStreamBlockN, "red fits in xs");
  __shared__ __align__(16) int4 wring[kStages][kStreamThreads][kChunks];
  __shared__ float sring[kInt8W ? kStages : 1][kStreamThreads];

  float acc[RM][kStreamCols];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < kStreamCols; ++j) acc[r][j] = 0.f;

  // one K row: x times the row's scale, times the 16 weights, for the
  // group's real rows only
  auto fma_row = [&](int k, float s, const float (&f)[kStreamCols]) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < rows) {
        const float xv = xs[(k - kb) * RM + r] * s;
#pragma unroll
        for (int j = 0; j < kStreamCols; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);
      }
    }
  };
  // a thread's K rows kb + ty + i * 8 stream through its own ring slots
  // (one commit group a row, empty past its last): it reads back only what
  // it copied, so no barrier guards them
  const int nrows = klen > ty ? (klen - ty + kStreamTY - 1) / kStreamTY : 0;
  auto copy_row = [&](int i) {
    if (i < nrows) {
      const int k = kb + ty + i * kStreamTY;
      const TW* src = we + static_cast<long long>(k) * N + n0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        cp_async16(&wring[i % kStages][tid][c], src + c * (16 / sizeof(TW)), 16);
      if constexpr (kInt8W) cp_async4(&sring[i % kStages][tid], se + k);
    }
    cp_async_commit();
  };

  const bool ring = vec && live;
  if (ring) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) copy_row(i);   // in flight while x is staged
  }
  for (int i = tid; i < RM * klen; i += kStreamThreads) {
    const int r = i / klen, kk = i % klen;
    xs[kk * RM + r] = r < rows ? to_f32(x[(m0 + r) * K + kb + kk]) : 0.f;
  }
  __syncthreads();

  if (ring) {
    for (int i = 0; i < nrows; ++i) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      int4 v[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) v[c] = wring[i % kStages][tid][c];
      float sc = 1.f;
      if constexpr (kInt8W) sc = sring[i % kStages][tid];
      copy_row(i + kStages - 1);   // into slot (i - 1) % stages, read back a row ago
      float f[kStreamCols];
      row_to_f32(v, static_cast<const TW*>(nullptr), f);
      fma_row(kb + ty + i * kStreamTY, sc, f);
    }
  } else if (live) {
    for (int k = kb + ty; k < ke; k += kStreamTY) {
      float f[kStreamCols];
#pragma unroll
      for (int j = 0; j < kStreamCols; ++j)
        f[j] = n0 + j < N ? to_f32(we[static_cast<long long>(k) * N + n0 + j]) : 0.f;
      fma_row(k, kInt8W ? se[k] : 1.f, f);
    }
  }
  // the split reduce may launch now (programmatic dependent launch): its
  // blocks wait for this grid's writes before they read the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // sum the block's 8 K lanes: the two of a warp by shuffle, then the 4
  // warps through shared memory, one output row at a time
  auto red = reinterpret_cast<float (*)[kStreamBlockN]>(xs);
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();   // every thread is done with xs
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
      const int n = nb + c;
      if (n < N) {
        if (ws != nullptr)
          ws[(static_cast<long long>(blockIdx.y) * rows_total + m0 + r) * N + n] = s;
        else
          out[(m0 + r) * N + n] = from_f32<TX>(s);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- mma
constexpr int kTcM = 64;             // rows a tile (layout)
constexpr int kTcN = 128;
constexpr int kTcK = 64;
constexpr int kTcThreads = 256;      // 8 warps, 2 (M) x 4 (N), 32 x 32 outputs each
constexpr int kTcPad = 8;            // bf16 padding per row: ldmatrix rows on distinct banks
constexpr int kTcQRow = kTcN + 16;   // int8 tile row stride (bytes): 16-byte aligned
using TcXTile = __nv_bfloat16[kTcM][kTcK + kTcPad];   // x tile [m][k]
using TcBTile = __nv_bfloat16[kTcK][kTcN + kTcPad];   // bf16 weight tile [k][n]
constexpr int kTcQTile = kTcK * kTcQRow;              // int8 weight tile [k][n]

// x tiles a stage: bf16 weights take x, int8 weights the three bf16 parts
// of x s (gmm_scale_x_kernel)
template <typename TW>
__host__ __device__ constexpr int mma_parts() {
  return std::is_same_v<TW, int8_t> ? 3 : 1;
}

// the cp.async ring's stages: bf16 4 (3 in flight while one is used); int8
// 2, so that two blocks a SM still fit (its steps are long: the int8 tile's
// conversion and three times the products)
template <typename TW>
__host__ __device__ constexpr int mma_stages() {
  return std::is_same_v<TW, int8_t> ? 2 : 4;
}

template <typename TW>
constexpr int mma_smem() {
  constexpr int kTcStages = mma_stages<TW>();
  return std::is_same_v<TW, int8_t>
             // ring: three x s tiles and the int8 tile; then the int8 tile in bf16
             ? kTcStages * (3 * static_cast<int>(sizeof(TcXTile)) + kTcQTile) +
                   static_cast<int>(sizeof(TcBTile))
             : kTcStages * static_cast<int>(sizeof(TcXTile) + sizeof(TcBTile));
}

// int8 experts: the scale varies along K, so it goes onto x's columns. x s
// of each tile's real rows, in fp32, as three bf16 parts (hi, mid, lo:
// truncations whose sum is x s exactly as fp32 holds it), xs3 (3,
// rows_total, K), once a call rather than once for each of the tensor-core
// kernel's column blocks. grid (ceil(K / 256), n_tiles), 256 threads.
__global__ void __launch_bounds__(256)
    gmm_scale_x_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w_scale,
                       const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
                       __nv_bfloat16* __restrict__ xs3, int K, int rows_total) {
  const int tile = blockIdx.y, rows = tile_rows[tile];
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (rows <= 0 || k >= K) return;
  const float s = w_scale[static_cast<long long>(tile_expert[tile]) * K + k];
  const long long part = static_cast<long long>(rows_total) * K;
  for (int r = 0; r < rows; ++r) {
    const long long i = (static_cast<long long>(tile) * kTcM + r) * K + k;
    const float v = __bfloat162float(x[i]) * s;
    const float hi = bf16_trunc(v), mid = bf16_trunc(v - hi);
    xs3[i] = __float2bfloat16(hi);                        // exact: 8 significant bits
    xs3[part + i] = __float2bfloat16(mid);
    xs3[2 * part + i] = __float2bfloat16(v - hi - mid);   // the last 8 bits, exact
  }
}

// grid (ceil(N / 128), n_tiles, splits); bf16 out, bf16 or int8 weights;
// x is bf16 x (n_tiles * 64, K) for bf16 weights, xs3 for int8 ones. With
// splits > 1, block z sums its split's rows of K into ws (splits, n_tiles *
// 64, N).
template <typename TW>
__global__ void __launch_bounds__(kTcThreads, 2)
    gmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const TW* __restrict__ w,
                   const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
                   float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int K, int N,
                   int splits, int rows_total) {
  constexpr bool kInt8W = std::is_same_v<TW, int8_t>;
  constexpr int kTcStages = mma_stages<TW>();
  constexpr int kParts = mma_parts<TW>();
  const int tile = blockIdx.y;
  const int rows = tile_rows[tile];
  if (rows <= 0) return;   // padding tile
  const int e = tile_expert[tile];
  const int ldx = K;
  const long long part = static_cast<long long>(rows_total) * ldx;   // xs3's part stride
  const TW* we = w + static_cast<long long>(e) * K * N;
  const __nv_bfloat16* xt = x + static_cast<long long>(tile) * kTcM * ldx;
  if (splits > 1) {   // this block's rows of K, as a matrix of their own
    int kb, ke;
    split_range(K, splits, blockIdx.z, kb, ke);
    xt += kb;
    we += static_cast<long long>(kb) * N;
    K = ke - kb;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  auto* as = reinterpret_cast<TcXTile*>(smem);                   // [stage * kParts + part]
  unsigned char* wsm = smem + kTcStages * kParts * sizeof(TcXTile);
  auto* bt = reinterpret_cast<TcBTile*>(wsm);                    // bf16 weights: [stage]
  int8_t* qt = reinterpret_cast<int8_t*>(wsm);                   // int8 weights: [stage]
  auto* bq = reinterpret_cast<TcBTile*>(wsm + kTcStages * kTcQTile);   // the int8 tile in bf16

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kTcN;
  const bool x_vec = ldx % 8 == 0 && aligned16(x);
  const bool w_vec = N % (16 / sizeof(TW)) == 0 && aligned16(w);
  const int steps = (K + kTcK - 1) / kTcK;

  // stage t into ring buffer buf: the x tiles (64 x 64 bf16: 2 chunks of 8
  // a thread each) and the weight tile (64 x 128: bf16 4 chunks of 8, int8
  // 2 chunks of 16 a thread), zero-filled past the tile's rows and past K
  // and N
  auto load_stage = [&](int t, int buf) {
    const int k0 = t * kTcK;
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = tid / 8 + 32 * u, c = tid % 8 * 8;
        __nv_bfloat16* dst = &as[buf * kParts + p][r][c];
        const int valid = r < rows && k0 + c < K ? min(8, K - k0 - c) : 0;
        const __nv_bfloat16* src = xt + p * part + static_cast<long long>(r) * ldx + k0 + c;
        if (x_vec) {
          cp_async16(dst, valid ? src : x, valid * 2);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j] = j < valid ? src[j] : __float2bfloat16(0.f);
        }
      }
    constexpr int kPer = 16 / sizeof(TW);                  // weights a chunk
    constexpr int kChunksRow = kTcN / kPer;                // chunks a tile row
    constexpr int kChunks = kTcK * kChunksRow / kTcThreads;   // chunks a thread
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = tid + u * kTcThreads;
      const int r = i / kChunksRow, c = i % kChunksRow * kPer;
      const int k = k0 + r, n = n0 + c;
      const int valid = k < K && n < N ? min(kPer, N - n) : 0;
      const TW* src = we + static_cast<long long>(k) * N + n;
      TW* dst = kInt8W ? reinterpret_cast<TW*>(qt + buf * kTcQTile + r * kTcQRow + c)
                       : reinterpret_cast<TW*>(&bt[buf][r][c]);
      if (w_vec) {
        cp_async16(dst, valid ? static_cast<const void*>(src) : static_cast<const void*>(w),
                   valid * static_cast<int>(sizeof(TW)));
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) dst[j] = j < valid ? src[j] : TW{};
      }
    }
  };

  // int8: stage buf's int8 tile -> bq in bf16, exact (a thread takes 2
  // chunks of 16 bytes)
  auto dequant_stage = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kTcThreads;
      const int r = i / (kTcN / 16), c = i % (kTcN / 16) * 16;
      float f[16];
      dequant16(*reinterpret_cast<const int4*>(qt + buf * kTcQTile + r * kTcQRow + c), f);
      unsigned h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)   // |q| <= 128: 8 significant bits, exact in bf16
        h[j] = __byte_perm(__float_as_uint(f[2 * j]), __float_as_uint(f[2 * j + 1]), 0x7632);
      *reinterpret_cast<uint4*>(&bq[0][r][c]) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(&bq[0][r][c + 8]) = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

  const int wm = warp / 4 * 32, wn = warp % 4 * 32;
  const bool busy = wm < rows;   // else the warp's 32 rows are all padding
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // one commit group a stage, empty past the last, so that "all but the
  // newest kTcStages - 2 groups complete" always means "stage t landed"
#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < steps) load_stage(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    const int buf = t % kTcStages;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 2));   // stage t landed
    // every thread's copies of stage t have landed, and every warp is done
    // with step t - 1: its ring buffer (which stage t + stages - 1 now
    // takes) and bq
    __syncthreads();
    if (t + kTcStages - 1 < steps) load_stage(t + kTcStages - 1, (t + kTcStages - 1) % kTcStages);
    cp_async_commit();
    if constexpr (kInt8W) {
      dequant_stage(buf);
      __syncthreads();
    }
    if (busy) {
      // this step's products start from 0 and are added to acc in fp32
      // (round to nearest): the tensor cores truncate as they add, so one
      // chain of K / 16 mma.sync into acc drifts (a bf16 step at |o| in
      // [4, 8) at K = 4096 against the fp32 plain version); int8 parts
      // smallest first
      float d[2][4][4];
#pragma unroll
      for (int kk = 0; kk < kTcK; kk += 16) {
        // B fragments of two n8 tiles from [k][n], transposed by ldmatrix:
        // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), rows addressed by lanes
        const TcBTile& bs = kInt8W ? bq[0] : bt[buf];
        unsigned b[4][2];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4_trans(r, &bs[kk + lane / 8 % 2 * 8 + lane % 8][wn + nj * 16 + lane / 16 * 8]);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int pi = 0; pi < (kInt8W ? 3 : 1); ++pi) {
          const TcXTile& xa = as[buf * kParts + (kInt8W ? 2 - pi : 0)];
          // 16-row halves past the tile's rows are skipped
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (wm + mi * 16 >= rows) continue;
            unsigned a[4];
            ldmatrix_x4(a, &xa[wm + mi * 16 + lane % 16][kk + lane / 16 * 8]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              if (kk == 0 && pi == 0)
                mma_bf16_zero(d[mi][ni], a, b[ni]);
              else
                mma_bf16(d[mi][ni], a, b[ni]);
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (wm + mi * 16 < rows)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[mi][ni][v] += d[mi][ni][v];
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::);   // the split reduce, if any
  if (!busy) return;

  // accumulator fragment: rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + lane / 4 + h * 8;
        const int n = n0 + wn + ni * 8 + lane % 4 * 2;
        if (r >= rows || n >= N) continue;
        const long long m = static_cast<long long>(tile) * kTcM + r;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (ws != nullptr) {
          float* p = ws + (static_cast<long long>(blockIdx.z) * rows_total + m) * N + n;
          p[0] = v0;
          if (n + 1 < N) p[1] = v1;
          continue;
        }
        __nv_bfloat16* o = out + m * N + n;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (n + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
}

enum Path : int { kTiled = 0, kStream = 1, kMma = 2 };

template <typename TX, typename TW, int RM>
int launch_stream(dim3 grid, int groups, int splits, const TX* x, const TW* w,
                  const float* w_scale, const int* tile_expert, const int* tile_rows, float* ws,
                  TX* out, int n_tiles, int K, int N, cudaStream_t s) {
  if (!split_fits(K, splits, RM)) return -1;   // the split's slice of x must fit the staging buffer
  const int rows_total = n_tiles * kStreamBlockM;
  gmm_stream_kernel<TX, TW, RM><<<grid, kStreamThreads, 0, s>>>(
      x, w, w_scale, tile_expert, tile_rows, splits > 1 ? ws : nullptr, out, K, N, groups,
      splits, rows_total);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 || splits <= 1
             ? err
             : launch_split_reduce<TX>(ws, splits, nullptr, out, rows_total, N, tile_rows,
                                       n_tiles, kStreamBlockM, s);
}

template <typename TW>
int launch_mma(dim3 grid, int splits, const __nv_bfloat16* x, const TW* w, const float* w_scale,
               const int* tile_expert, const int* tile_rows, float* ws, __nv_bfloat16* xs3,
               __nv_bfloat16* out, int n_tiles, int K, int N, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_mma_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem<TW>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows_total = n_tiles * kTcM;
  if constexpr (std::is_same_v<TW, int8_t>) {
    if (xs3 == nullptr) return -1;
    gmm_scale_x_kernel<<<dim3((K + 255) / 256, n_tiles), 256, 0, s>>>(
        x, w_scale, tile_expert, tile_rows, xs3, K, rows_total);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    x = xs3;
  }
  gmm_mma_kernel<TW><<<grid, kTcThreads, mma_smem<TW>(), s>>>(
      x, w, tile_expert, tile_rows, splits > 1 ? ws : nullptr, out, K, N, splits, rows_total);
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 || splits <= 1
             ? err
             : launch_split_reduce<__nv_bfloat16>(ws, splits, nullptr, out, rows_total, N,
                                                  tile_rows, n_tiles, kTcM, s);
}

}  // namespace

// The constants the wrapper's plan mirrors, in this order: the stream
// path's row tile, block columns, staged x floats and split unit rows; the
// mma and tiled kernels' output tiles (rows, columns).
extern "C" void gmm_constants(int* c) {
  c[0] = kStreamBlockM;
  c[1] = kStreamBlockN;
  c[2] = kXsFloats;
  c[3] = kSplitRows;
  c[4] = kTcM;
  c[5] = kTcN;
  c[6] = kBlockM;
  c[7] = kBlockN;
}

// Returns the CUDA error of the launch (0 on success), -1 for a path, row
// group, split count or dtype the kernels do not take. path: 0 tiled, 1
// stream, 2 mma (bf16 x, bf16 or int8 weights); grid (gx, gy, gz), rows
// (the stream kernel's rows a group: 1, 2 or 4), groups (its row groups a
// tile) and splits come from the wrapper's plan. Layouts: x (n_tiles *
// block_m, K), block_m the path's row tile (stream 16, else 64); w (E, K,
// N) fp32, bf16 or int8 (w_dtype kInt8, then w_scale (E, K) fp32; null
// otherwise); tile_expert, tile_rows (n_tiles,) int32; ws (splits, n_tiles
// * block_m, N) fp32 when splits > 1; xs3 (3, n_tiles * 64, K) bf16 on the
// mma path with int8 weights, null otherwise; out (n_tiles * block_m, N),
// written only at each tile's first tile_rows rows; all contiguous.
extern "C" int gmm_launch(int path, int rows, int groups, int gx, int gy, int gz, int splits,
                          const void* x, const void* w, const void* w_scale,
                          const void* tile_expert, const void* tile_rows, void* ws, void* xs3,
                          void* out, int n_tiles, int K, int N, int x_dtype, int w_dtype,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz);
  const auto* te = static_cast<const int*>(tile_expert);
  const auto* tr = static_cast<const int*>(tile_rows);
  const auto* sc = static_cast<const float*>(w_scale);
  auto* wsf = static_cast<float*>(ws);
  return dispatch_dtype(x_dtype, [&](auto tx) -> int {
    using TX = std::remove_pointer_t<decltype(tx)>;
    const auto* xt = static_cast<const TX*>(x);
    auto* ot = static_cast<TX*>(out);
    auto launch = [&](auto tw) -> int {
      using TW = std::remove_pointer_t<decltype(tw)>;
      const auto* wt = static_cast<const TW*>(w);
      switch (path) {
        case kTiled:
          gmm_kernel<TX, TW><<<grid, kThreads, 0, s>>>(xt, wt, sc, te, tr, ot, K, N);
          return static_cast<int>(cudaGetLastError());
        case kStream:
          switch (rows) {
            case 1: return launch_stream<TX, TW, 1>(grid, groups, splits, xt, wt, sc, te, tr,
                                                    wsf, ot, n_tiles, K, N, s);
            case 2: return launch_stream<TX, TW, 2>(grid, groups, splits, xt, wt, sc, te, tr,
                                                    wsf, ot, n_tiles, K, N, s);
            case 4: return launch_stream<TX, TW, 4>(grid, groups, splits, xt, wt, sc, te, tr,
                                                    wsf, ot, n_tiles, K, N, s);
            default: return -1;
          }
        case kMma:
          if constexpr (std::is_same_v<TX, __nv_bfloat16> &&
                        (std::is_same_v<TW, __nv_bfloat16> || std::is_same_v<TW, int8_t>))
            return launch_mma<TW>(grid, splits, xt, wt, sc, te, tr, wsf,
                                  static_cast<__nv_bfloat16*>(xs3), ot, n_tiles, K, N, s);
          else
            return -1;
        default: return -1;
      }
    };
    if (w_dtype == kInt8) return launch(static_cast<int8_t*>(nullptr));
    return dispatch_dtype(w_dtype, launch);
  });
}
