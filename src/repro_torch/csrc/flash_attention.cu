// Flash attention on Hopper (sm_90a): blocked online-softmax attention of a
// whole sequence, causal or bidirectional, with sliding window, softcap and
// a query offset. Serves LM.forward and LM.prefill (train / prefill modes).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_bhsd (body _flash_kernel). Same function: query row i sits
// at absolute position i + q_offset and attends to key j < Skv with, when
// causal, j <= i + q_offset and, with a window, j > i + q_offset - window;
// scores are scaled, optionally softcapped, and reduced with an fp32 online
// softmax; a row with no visible key gives zeros. GQA by index: query head
// h reads kv head h / (H / Hkv), so grouped K/V is never materialised.
// Head dims 16, 64, 96 and 128. On request (training: the backward in
// flash_attention_bwd.cu reads it) both kernels also write each row's
// logsumexp of its scaled, softcapped scores, lse (B, H, Sq) fp32, natural
// log, -inf for a row with no visible key. Besides causal self attention it serves
// seamless-m4t's encoder (bidirectional, Sq = Skv) and cross attention
// (not causal, Sq != Skv: a chunk or one token against the memory).
//
// What bounds it on the card: at the prefill shapes of the serving path
// (a few hundred tokens, D = 128) the operations (4*D per visible
// (query, key) pair) and the bytes (q, k, v, o once) give bounds of the same
// order, a few microseconds each. The host-side plan
// (kernels/flash_attention/kernel.py's _plan) picks one of two kernels:
//
//  - mma (bf16 q, k and v): FA2 on mma.sync.m16n8k16, attention_mma.cuh's
//    body, shared with chunked_prefill.cu. The GQA group is folded into the
//    row axis (r = s * G + g), so a block of 64 folded rows of one KV head
//    stages each K/V tile once for all G query heads (the TPU grid reads it
//    G times, once per query head); grid (ceil(Sq * G / 64), Hkv, B). A
//    block walks only the 64-key tiles its rows can see, through a cp.async
//    double buffer, masks each element in registers, and keeps the softmax
//    state and P V in registers; P enters the tensor cores as hi + lo bf16
//    parts, each tile's P V summed from zero and added in fp32. Ragged Sq,
//    Skv and Sq * G edges are masked or zero-filled in the kernel, never
//    padded.
//  - tiled (fp32: it stays IEEE fp32 on the CUDA cores), the port's first
//    kernel, kept as it was; grid (tiles of kBQ query rows, query head,
//    batch row). The TPU grid carries m / l / acc across its innermost kv
//    axis in VMEM scratch; here a block walks its kv tiles in a loop with
//    that state in registers, visiting only the tiles its rows can see (up
//    to its last row's position when causal, from its first row's window
//    start), and masks every element as kernel.py:76-81 does. Thread
//    (rg, cg) of 16 x 8 owns 4 query rows: a 4 x 4 block of the tile's
//    scores and a 4 x D/8 block of the output; row max and sum reduce over
//    the 8 threads of a row group with warp shuffles. q and k sit transposed
//    in shared memory as fp32, the probabilities go through shared memory
//    (over k's buffer) for the P V product; 68 KB at D = 128.

#include "attention_mma.cuh"   // the mma body (cp_async16, mma.sync helpers)

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                           // query rows per block
constexpr int kBK = 32;                           // keys per kv tile
constexpr int kColGroups = 8;                     // threads sharing a row group
constexpr int kRowsPer = kBQ / (kThreads / kColGroups);  // 4 rows per thread
constexpr int kKeysPer = kBK / kColGroups;               // 4 keys per thread
constexpr int kQStride = kBQ + 4;                 // float4-aligned padded rows
constexpr int kKStride = kBK + 4;
static_assert(kRowsPer == 4 && kKeysPer == 4, "the float4 tiling assumes 4 x 4");

template <int D>
struct Smem {
  float q[D][kQStride];  // q^T of the block's rows
  union {
    float k[D][kKStride];    // k^T of the tile, then
    float p[kBK][kQStride];  // the tile's probabilities^T
  } kp;
  float v[kBK][D];
};

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv, float scale,
    float softcap, int causal, int window, int q_offset) {
  constexpr int kVec = (D / kColGroups) >= 4 ? 4 : D / kColGroups;  // 4 from D = 32, D=16: 2
  constexpr int kChunks = D / (kColGroups * kVec);                  // D / 32, D=16: 1
  static_assert(D % (kColGroups * kVec) == 0, "head_dim must split over the row group");
  extern __shared__ float4 smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, Sq - q0);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sm.q[d][r] = r < nq ? to_f32(q[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * D + d])
                        : 0.f;
  }

  // the kv tiles this block's rows can see
  const int pos_lo = q0 + q_offset, pos_hi = q0 + nq - 1 + q_offset;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, pos_hi < 0 ? 0 : pos_hi / kBK + 1);
  const int kt_begin = window > 0 ? max(0, pos_lo - window + 1) / kBK : 0;

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kChunks][kVec];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + k0 + j) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      sm.kp.k[d][j] = kx;
      sm.v[j][d] = vx;
    }
    __syncthreads();

    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
      lds<4>(&sm.q[d][rg * kRowsPer], qa);
      lds<4>(&sm.kp.k[d][cg * kKeysPer], ka);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with k: p may take its buffer

#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qpos = q0 + rg * kRowsPer + i + q_offset;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int kpos = k0 + cg * kKeysPer + j;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < kColGroups; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const float pr = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = 1; o < kColGroups; o <<= 1) sum += __shfl_xor_sync(~0u, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeysPer; ++j)
      *reinterpret_cast<float4*>(&sm.kp.p[cg * kKeysPer + j][rg * kRowsPer]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4];
      lds<4>(&sm.kp.p[j][rg * kRowsPer], pa);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float va[kVec];
        lds<kVec>(&sm.v[j][(c * kColGroups + cg) * kVec], va);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[i][c][e] = fmaf(pa[i], va[e], acc[i][c][e]);
      }
    }
    __syncthreads();  // before the next tile overwrites k, p and v
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = rg * kRowsPer + i;
    if (r >= nq) continue;
    if (lse != nullptr && cg == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + q0 + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    T* o = out + ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        o[(c * kColGroups + cg) * kVec + e] = from_f32<T>(l[i] > 0.f ? acc[i][c][e] / l[i] : 0.f);
  }
}

template <typename T, int D>
int launch_tiled(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int Sq, int Skv, int H, int Hkv, float scale, float softcap, int causal,
                 int window, int q_offset, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<D>));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, H, Hkv, scale, softcap, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// grid (ceil(Sq * G / 64), Hkv, B); bf16 q, k, v and out. The body is
// attention_mma.cuh's, with key pos's K/V row at (b, pos, h) of k / v.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int H, int Hkv, float scale, float softcap, int window, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blocks start in the order of their linear index: the row block is the
  // slowest axis of that order, last rows first, so the blocks that walk the
  // most key tiles (causal: the last rows) start first and the light ones
  // fill the tail
  const unsigned lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const unsigned heads = gridDim.y * gridDim.z;
  const int rb = gridDim.x - 1 - lin / heads;
  const int h = lin % heads % gridDim.y, b = lin % heads / gridDim.y;
  const size_t row0 = static_cast<size_t>(b) * Skv;
  auto kv_row = [&](int pos) { return ((row0 + pos) * Hkv + h) * D; };
  mma_attention_block<D, kCausal>(q, k, v, out, lse, b, h, rb * kMmaRows, Sq, H, H / Hkv,
                                  q_offset, Skv, scale, softcap, window, kv_row, smem);
}

template <int D, bool kCausal>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Skv, int H, int Hkv, float scale, float softcap, int window, int q_offset,
               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<D, kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long rows = static_cast<long long>(Sq) * (H / Hkv);
  const dim3 grid(static_cast<unsigned>((rows + kMmaRows - 1) / kMmaRows), Hkv, B);
  flash_mma_kernel<D, kCausal><<<grid, kMmaThreads, mma_smem<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H,
      Hkv, scale, softcap, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

enum Path : int { kTiled = 0, kMma = 1 };

template <typename T, int D>
int launch_path(int path, const void* q, const void* k, const void* v, void* out, float* lse,
                int B, int Sq, int Skv, int H, int Hkv, float scale, float softcap, int causal,
                int window, int q_offset, cudaStream_t s) {
  switch (path) {
    case kTiled:
      return launch_tiled<T, D>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale, softcap, causal,
                                window, q_offset, s);
    case kMma:
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        return causal ? launch_mma<D, true>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                            softcap, window, q_offset, s)
                      : launch_mma<D, false>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                             softcap, window, q_offset, s);
      }
      return -1;
    default:
      return -1;
  }
}

}  // namespace

// The constants the wrapper's plan mirrors, in this order: the tiled
// kernel's query rows a block, the mma kernel's folded rows and key tile.
extern "C" void flash_attention_constants(int* c) {
  c[0] = kBQ;
  c[1] = kMmaRows;
  c[2] = kMmaKeys;
}

// Returns the CUDA error of the launch (0 on success), -1 for a path, dtype
// or head dim the kernels do not take. path: 0 tiled, 1 mma (bf16 only).
// Layouts: q / out (B, Sq, H, D); k / v (B, Skv, Hkv, D); all contiguous,
// one dtype, 16-byte aligned on the mma path. lse (B, H, Sq) fp32, or null
// to write none.
extern "C" int flash_attention_launch(int path, const void* q, const void* k, const void* v,
                                      void* out, float* lse, int B, int Sq, int Skv, int H,
                                      int Hkv, int D,
                                      float scale, float softcap, int causal, int window,
                                      int q_offset, int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    switch (D) {
      case 16: return launch_path<T, 16>(path, q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                         softcap, causal, window, q_offset, s);
      case 64: return launch_path<T, 64>(path, q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                         softcap, causal, window, q_offset, s);
      case 96: return launch_path<T, 96>(path, q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                         softcap, causal, window, q_offset, s);
      case 128: return launch_path<T, 128>(path, q, k, v, out, lse, B, Sq, Skv, H, Hkv, scale,
                                           softcap, causal, window, q_offset, s);
      default: return -1;
    }
  });
}
