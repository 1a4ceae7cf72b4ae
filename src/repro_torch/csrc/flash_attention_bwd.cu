// Flash attention backward on Hopper (sm_90a): the gradients dQ, dK and dV
// of flash_attention.cu's forward, for the training path (LM.loss under
// autograd). Same function as the forward: query row i sits at position
// i + q_offset and sees key j < Skv with, when causal, j <= i + q_offset and,
// with a window, j > i + q_offset - window; scores are scaled, optionally
// softcapped; GQA by index (query head h reads kv head h / G).
//
// Differentiates the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_bhsd, which has no backward of its own: the reference
// trains through XLA and computes this gradient by autodiff of mha_chunked
// (src/repro/kernels/flash_attention/ops.py), whose scores, P and P V are
// fp32 from bf16 inputs. The formulas are FA2's, from the forward's output O
// and row logsumexp lse (B, H, Sq) of the post-softcap scaled scores:
//   P = exp(S - lse)            (0 where masked, and on a row with no visible
//                                key: lse = -inf, forward output 0)
//   dV = P^T dO;  dP = dO V^T;  Delta = rowsum(dO o O)
//   dS = P o (dP - Delta), times 1 - tanh^2(s / cap) under a softcap
//   dQ = dS K * scale;  dK = dS^T Q * scale
//
// What bounds it on the card: 2.5x the forward's 4*D operations per visible
// (query head, key) pair, against q, k, v, o, dO and lse read once and dq,
// dk, dv written once; at the training shapes (512 tokens, D = 128) the
// bytes and the operations at the bf16 tensor-core rate give bounds of the
// same order, ~0.01-0.03 ms. The host-side plan (kernels/flash_attention/
// kernel.py's bwd_plan) picks one of two paths; both launch, in order on one
// stream, a delta kernel (Delta per (b, h, row), one warp a row, fp32), a
// dK / dV kernel and a dQ kernel, and neither uses atomics: every sum runs in
// a fixed order, so a repeat gives the same bits.
//
//  - mma (bf16): FA2's arrangement on mma.sync.m16n8k16 with fp32
//    accumulators, tiles bf16 in shared memory, 4 warps of 16 rows.
//    dK / dV: a block takes 64 keys of one kv head (16 a warp) and a subset
//    of `splits` of its GQA group, and walks for each of its query heads the
//    64-row query tiles that see its keys (Q, dO, lse and Delta through a
//    cp.async double buffer). It computes S^T = K Q^T and dP^T = V dO^T with
//    the keys as the M side, so P^T and dS^T come out as accumulator
//    fragments in the layout of the A operand of dV += P^T dO and
//    dK += dS^T Q: no shared-memory round trip. dQ: a block takes 64 query
//    rows of one query head and walks the 64-key tiles they see (K and V
//    double buffered), S = Q K^T and dP = dO V^T with the rows as the M
//    side, then dQ += dS K. P and dS enter the tensor cores as truncated
//    hi + lo bf16 parts (two products, within 2^-14 of the fp32 value, as the
//    forward's P V: attention_mma.cuh), and each tile's products are summed
//    from zero before they are added to the fp32 accumulator (mma.sync
//    truncates as it adds). S and dP need no split: their inputs are bf16.
//    Probabilities are ex2 of log2-unit scores against lse * log2(e).
//    So 10 tensor-core products per visible pair (6 in dK / dV, 4 in dQ),
//    where FA2 does 5. The grid: dK / dV has ceil(Skv / 64) x Hkv x B blocks
//    before the split, 64 at qwen2.5-3b's training shape (2 kv heads, 4 x
//    512 tokens) against 132 SMs; the plan splits each GQA group into the
//    fewest subsets that give 2 blocks a SM (8 at that shape: 512 blocks),
//    each subset writes fp32 partial dK / dV (a (2, splits, B, Skv, Hkv, D)
//    workspace) and a reduce kernel sums them in subset order. With causal
//    masks the first key tiles and the last query tiles walk the most
//    tiles, so the grids put the tile index on z and dispatch those first.
//  - tiled (fp32: IEEE fp32 on the CUDA cores, as the repo's precision rule
//    asks), the first design: dkdv has one block per
//    (32-key tile, kv head, batch row), walks the G query heads of its group
//    and, for each, the 64-row query tiles that can see its keys, keeping dK
//    and dV in registers (the group's sum stays in the block); dq has one
//    block per (64-row query tile, query head, batch row). Both recompute S
//    and dP from tiles staged in shared memory as fp32, with fp32 FMAs and
//    accumulators. A thread of the 16 x 16 grid of a block owns 4 x 2
//    scores (rows t + 16 u, keys t' + 16 a: neighbouring threads on
//    neighbouring padded rows, so the float4 loads of a quarter warp hit
//    distinct banks) and 2 rows x D/16 columns of each accumulator.

#include "attention_mma.cuh"   // ex2, soft_cap, mma_key_tiles, cp.async and mma.sync helpers

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;               // the block's threads form a 16 x 16 grid
constexpr int kBQ = 64;                  // query rows a tile
constexpr int kBK = 32;                  // keys a tile
constexpr int kQPer = kBQ / kLanes;      // 4 query rows a thread
constexpr int kKPer = kBK / kLanes;      // 2 keys a thread
constexpr int kPStride = kBK + 2;        // padded row of the P / dS tiles (float2 aligned)

// a thread's columns of a D-wide accumulator row: (c * 16 + t) * vec + e
template <int D>
struct Cols {
  static constexpr int per = D / kLanes;                       // 1, 4, 6, 8
  static constexpr int vec = per % 4 == 0 ? 4 : (per % 2 == 0 ? 2 : 1);
  static constexpr int chunks = per / vec;
  static constexpr int stride = D + 4;                         // padded smem row, floats
  static_assert(D % kLanes == 0 && D % 4 == 0, "head_dim");
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

// rows [r0, r0 + rows) of a (B, S, heads, D) tensor's head `head` into a
// padded fp32 tile of R rows, zero past S
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int b, int r0, int S,
                                      int heads, int head) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * Cols<D>::stride + d] =
        r0 + r < S ? to_f32(src[((static_cast<size_t>(b) * S + r0 + r) * heads + head) * D + d])
                   : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// P and dS of one score: s the raw Q.K dot, dp the dO.V dot
__device__ __forceinline__ void grad_score(float s, float dp, float lse, float delta, float scale,
                                           float softcap, bool ok, float& p, float& ds) {
  float x = s * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  p = ok && lse != -INFINITY ? expf(x - lse) : 0.f;
  ds = p * (dp - delta) * dcap;
}

// 1. Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(const T* __restrict__ out,
                                                         const T* __restrict__ dout,
                                                         float* __restrict__ delta, int Sq,
                                                         int H, long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(~0u, s, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(Sq) * H);
    const int i = static_cast<int>(row / H % Sq), h = static_cast<int>(row % H);
    delta[(b * H + h) * Sq + i] = s;
  }
}

template <int D>
struct DkdvSmem {
  float k[kBK][Cols<D>::stride];
  float v[kBK][Cols<D>::stride];
  float q[kBQ][Cols<D>::stride];
  float g[kBQ][Cols<D>::stride];       // dO
  float p[kBQ][kPStride];
  float ds[kBQ][kPStride];
  float lse[kBQ];
  float delta[kBQ];
};

// 2. dK and dV of keys [k0, k0 + 32) of kv head hk, batch row b
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int Hkv, float scale,
    float softcap, int causal, int window, int q_offset) {
  using C = Cols<D>;
  extern __shared__ float4 smem_raw[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, hi = tid / kLanes, lo = tid % kLanes;
  const int b = blockIdx.z, hk = blockIdx.y, G = H / Hkv;
  const int k0 = blockIdx.x * kBK, k_last = min(k0 + kBK, Skv) - 1;

  stage<T, D, kBK>(&sm.k[0][0], k, b, k0, Skv, Hkv, hk);
  stage<T, D, kBK>(&sm.v[0][0], v, b, k0, Skv, Hkv, hk);

  // the query rows that see some key of the tile
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - q_offset) : Sq - 1;
  const int qt_lo = i_lo / kBQ, qt_hi = i_hi >= i_lo ? i_hi / kBQ : qt_lo - 1;

  float acc_k[2][C::chunks][C::vec], acc_v[2][C::chunks][C::vec];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < C::chunks; ++c)
#pragma unroll
      for (int e = 0; e < C::vec; ++e) acc_k[a][c][e] = acc_v[a][c][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ, nq = min(kBQ, Sq - q0);
      __syncthreads();   // the previous tile's readers are done
      stage<T, D, kBQ>(&sm.q[0][0], q, b, q0, Sq, H, h);
      stage<T, D, kBQ>(&sm.g[0][0], dout, b, q0, Sq, H, h);
      if (tid < kBQ) {
        sm.lse[tid] = tid < nq ? lse_h[q0 + tid] : -INFINITY;
        sm.delta[tid] = tid < nq ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T of keys hi + 16 a against rows lo + 16 u
      float s[kKPer][kQPer], dp[kKPer][kQPer];
#pragma unroll
      for (int a = 0; a < kKPer; ++a)
#pragma unroll
        for (int u = 0; u < kQPer; ++u) s[a][u] = dp[a][u] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float kr[kKPer][4], vr[kKPer][4], qr[kQPer][4], gr[kQPer][4];
#pragma unroll
        for (int a = 0; a < kKPer; ++a) {
          lds<4>(&sm.k[hi + kLanes * a][d], kr[a]);
          lds<4>(&sm.v[hi + kLanes * a][d], vr[a]);
        }
#pragma unroll
        for (int u = 0; u < kQPer; ++u) {
          lds<4>(&sm.q[lo + kLanes * u][d], qr[u]);
          lds<4>(&sm.g[lo + kLanes * u][d], gr[u]);
        }
#pragma unroll
        for (int a = 0; a < kKPer; ++a)
#pragma unroll
          for (int u = 0; u < kQPer; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[a][u] = fmaf(kr[a][e], qr[u][e], s[a][u]);
              dp[a][u] = fmaf(vr[a][e], gr[u][e], dp[a][u]);
            }
      }
#pragma unroll
      for (int a = 0; a < kKPer; ++a)
#pragma unroll
        for (int u = 0; u < kQPer; ++u) {
          const int r = lo + kLanes * u, j = hi + kLanes * a;
          const int kpos = k0 + j, qpos = q0 + r + q_offset;
          const bool ok = r < nq && kpos < Skv && visible(qpos, kpos, causal, window);
          float p, ds;
          grad_score(s[a][u], dp[a][u], sm.lse[r], sm.delta[r], scale, softcap, ok, p, ds);
          sm.p[r][j] = p;
          sm.ds[r][j] = ds;
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's rows: keys 2 hi, 2 hi + 1
      for (int r = 0; r < nq; ++r) {
        float pr[2], dr[2];
        lds<2>(&sm.p[r][2 * hi], pr);
        lds<2>(&sm.ds[r][2 * hi], dr);
#pragma unroll
        for (int c = 0; c < C::chunks; ++c) {
          float gv[C::vec], qv[C::vec];
          lds<C::vec>(&sm.g[r][(c * kLanes + lo) * C::vec], gv);
          lds<C::vec>(&sm.q[r][(c * kLanes + lo) * C::vec], qv);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int e = 0; e < C::vec; ++e) {
              acc_v[a][c][e] = fmaf(pr[a], gv[e], acc_v[a][c][e]);
              acc_k[a][c][e] = fmaf(dr[a], qv[e], acc_k[a][c][e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int pos = k0 + 2 * hi + a;
    if (pos >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + pos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < C::chunks; ++c)
#pragma unroll
      for (int e = 0; e < C::vec; ++e) {
        const int d = (c * kLanes + lo) * C::vec + e;
        dk[off + d] = from_f32<T>(acc_k[a][c][e] * scale);
        dv[off + d] = from_f32<T>(acc_v[a][c][e]);
      }
  }
}

template <int D>
struct DqSmem {
  float q[kBQ][Cols<D>::stride];
  float g[kBQ][Cols<D>::stride];       // dO
  float k[kBK][Cols<D>::stride];
  float v[kBK][Cols<D>::stride];
  float ds[kBQ][kPStride];
};

// 3. dQ of query rows [q0, q0 + 64) of query head h, batch row b
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, int H, int Hkv, float scale, float softcap, int causal,
    int window, int q_offset) {
  using C = Cols<D>;
  extern __shared__ float4 smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, hi = tid / kLanes, lo = tid % kLanes;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ, nq = min(kBQ, Sq - q0);

  stage<T, D, kBQ>(&sm.q[0][0], q, b, q0, Sq, H, h);
  stage<T, D, kBQ>(&sm.g[0][0], dout, b, q0, Sq, H, h);
  // this thread's rows hi + 16 u: their lse and Delta in registers
  float lse_r[kQPer], delta_r[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int r = hi + kLanes * u;
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq + q0 + r;
    lse_r[u] = r < nq ? lse[row] : -INFINITY;
    delta_r[u] = r < nq ? delta[row] : 0.f;
  }

  // the key tiles the rows can see (the forward's walk)
  const int pos_lo = q0 + q_offset, pos_hi = q0 + nq - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, max(pos_hi + 1, 0)) : Skv;
  const int kv_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int kt_lo = kv_lo / kBK, kt_end = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : kt_lo;

  float acc[kQPer][C::chunks][C::vec];
#pragma unroll
  for (int u = 0; u < kQPer; ++u)
#pragma unroll
    for (int c = 0; c < C::chunks; ++c)
#pragma unroll
      for (int e = 0; e < C::vec; ++e) acc[u][c][e] = 0.f;

  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done (and q / dO staged)
    stage<T, D, kBK>(&sm.k[0][0], k, b, k0, Skv, Hkv, hk);
    stage<T, D, kBK>(&sm.v[0][0], v, b, k0, Skv, Hkv, hk);
    __syncthreads();

    // S and dP of rows hi + 16 u against keys lo + 16 a
    float s[kQPer][kKPer], dp[kQPer][kKPer];
#pragma unroll
    for (int u = 0; u < kQPer; ++u)
#pragma unroll
      for (int a = 0; a < kKPer; ++a) s[u][a] = dp[u][a] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kr[kKPer][4], vr[kKPer][4], qr[kQPer][4], gr[kQPer][4];
#pragma unroll
      for (int a = 0; a < kKPer; ++a) {
        lds<4>(&sm.k[lo + kLanes * a][d], kr[a]);
        lds<4>(&sm.v[lo + kLanes * a][d], vr[a]);
      }
#pragma unroll
      for (int u = 0; u < kQPer; ++u) {
        lds<4>(&sm.q[hi + kLanes * u][d], qr[u]);
        lds<4>(&sm.g[hi + kLanes * u][d], gr[u]);
      }
#pragma unroll
      for (int u = 0; u < kQPer; ++u)
#pragma unroll
        for (int a = 0; a < kKPer; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u][a] = fmaf(qr[u][e], kr[a][e], s[u][a]);
            dp[u][a] = fmaf(gr[u][e], vr[a][e], dp[u][a]);
          }
    }
#pragma unroll
    for (int u = 0; u < kQPer; ++u)
#pragma unroll
      for (int a = 0; a < kKPer; ++a) {
        const int r = hi + kLanes * u, j = lo + kLanes * a;
        const int kpos = k0 + j, qpos = q0 + r + q_offset;
        const bool ok = r < nq && kpos < Skv && visible(qpos, kpos, causal, window);
        float p, ds;
        grad_score(s[u][a], dp[u][a], lse_r[u], delta_r[u], scale, softcap, ok, p, ds);
        sm.ds[r][j] = ds;
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
    const int nk = min(kBK, Skv - k0);
    for (int j = 0; j < nk; ++j) {
      float dsr[kQPer];
#pragma unroll
      for (int u = 0; u < kQPer; ++u) dsr[u] = sm.ds[hi + kLanes * u][j];
#pragma unroll
      for (int c = 0; c < C::chunks; ++c) {
        float kv[C::vec];
        lds<C::vec>(&sm.k[j][(c * kLanes + lo) * C::vec], kv);
#pragma unroll
        for (int u = 0; u < kQPer; ++u)
#pragma unroll
          for (int e = 0; e < C::vec; ++e) acc[u][c][e] = fmaf(dsr[u], kv[e], acc[u][c][e]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int r = hi + kLanes * u;
    if (r >= nq) continue;
    T* o = dq + ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C::chunks; ++c)
#pragma unroll
      for (int e = 0; e < C::vec; ++e)
        o[(c * kLanes + lo) * C::vec + e] = from_f32<T>(acc[u][c][e] * scale);
  }
}

// ------------------------------------------------------------------ mma path
constexpr int kMmaTile = 64;   // keys a dK / dV block, query rows a dQ block, and the tiles each walks
static_assert(kMmaTile == kMmaKeys, "the dQ kernel walks mma_key_tiles' tiles");

using bf16 = __nv_bfloat16;

template <int D>
__host__ __device__ constexpr int dkdv_mma_smem() {   // K, V; 2 x (Q, dO); 2 x (lse, Delta)
  return 6 * kMmaTile * (D + kMmaPad) * 2 + 4 * kMmaTile * 4;
}

template <int D>
__host__ __device__ constexpr int dq_mma_smem() {     // Q, dO; 2 x (K, V)
  return 6 * kMmaTile * (D + kMmaPad) * 2;
}

// rows [r0, r0 + 64) of head `head` of a (B, S, heads, D) bf16 tensor into a
// padded tile, zero-filled from row S on
template <int D>
__device__ __forceinline__ void stage_mma(bf16* dst, const bf16* __restrict__ src, int b, int r0,
                                          int S, int heads, int head) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int u = 0; u < kMmaTile * kChunks / kMmaThreads; ++u) {
    const int i = threadIdx.x + u * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * (D + kMmaPad) + c,
               ok ? src + ((static_cast<size_t>(b) * S + r0 + r) * heads + head) * D + c : src,
               ok ? 16 : 0);
  }
}

// The 64-row query tiles [qt_lo, qt_lo + n) whose rows see some key of
// [k0, k_last] (kernel.py's bwd_query_tiles mirrors it)
__device__ __forceinline__ void bwd_query_tiles(int k0, int k_last, int Sq, int causal,
                                                int window, int q_offset, int& qt_lo, int& n) {
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - q_offset) : Sq - 1;
  qt_lo = i_lo / kMmaTile;
  n = i_hi >= i_lo ? i_hi / kMmaTile - qt_lo + 1 : 0;
}

// acc = A B^T over the head dim, from zero: A the warp's 16 rows of a staged
// tile (a: its first row), B the 64 rows of staged tile b; 16 x 64 fp32 in
// 8 n8 fragments
template <int D>
__device__ __forceinline__ void mma_rows_x64(float (&acc)[8][4], const bf16* a, const bf16* b,
                                             int lane) {
  constexpr int kRow = D + kMmaPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned fa[4];
    ldmatrix_x4(fa, a + (lane % 16) * kRow + kk * 16 + lane / 16 * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // B fragments of two n8 tiles from b [row][d]: matrices (rows 0-7 |
      // 8-15) x (d 0-7 | 8-15) of the k16 step
      unsigned r[4];
      ldmatrix_x4(r, b + (np * 16 + lane / 16 * 8 + lane % 8) * kRow + kk * 16 + lane / 8 % 2 * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      if (kk == 0) {
        mma_bf16_zero(acc[2 * np], fa, b0);
        mma_bf16_zero(acc[2 * np + 1], fa, b1);
      } else {
        mma_bf16(acc[2 * np], fa, b0);
        mma_bf16(acc[2 * np + 1], fa, b1);
      }
    }
  }
}

// acc += X Y: X the warp's 16 x 64 fp32 fragments (8 n8 tiles), as hi + lo
// bf16 A operands of 4 k16 steps (the fragments of n8 tiles 2j and 2j + 1
// are exactly A's registers), Y the 64 x D staged tile y read transposed by
// ldmatrix; the tile's product summed from zero (lo parts first), then
// added in fp32
template <int D>
__device__ __forceinline__ void mma_acc_x64(float (&acc)[D / 8][4], const float (&x)[8][4],
                                            const bf16* y, int lane) {
  constexpr int kRow = D + kMmaPad;
  unsigned xh[4][4], xl[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_pair(x[2 * j][0], x[2 * j][1], xh[j][0], xl[j][0]);
    split_pair(x[2 * j][2], x[2 * j][3], xh[j][1], xl[j][1]);
    split_pair(x[2 * j + 1][0], x[2 * j + 1][1], xh[j][2], xl[j][2]);
    split_pair(x[2 * j + 1][2], x[2 * j + 1][3], xh[j][3], xl[j][3]);
  }
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    float d0[4], d1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // B fragments of two n8 tiles from y [row][d], transposed: matrices
      // (rows 0-7 | 8-15) x (d 0-7 | 8-15)
      unsigned r[4];
      ldmatrix_x4_trans(r, y + (j * 16 + lane / 8 % 2 * 8 + lane % 8) * kRow + dp * 16 +
                               lane / 16 * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      if (j == 0) {
        mma_bf16_zero(d0, xl[j], b0);
        mma_bf16_zero(d1, xl[j], b1);
      } else {
        mma_bf16(d0, xl[j], b0);
        mma_bf16(d1, xl[j], b1);
      }
      mma_bf16(d0, xh[j], b0);
      mma_bf16(d1, xh[j], b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dp][e] += d0[e];
      acc[2 * dp + 1][e] += d1[e];
    }
  }
}

// P and dS of one score, in place: s the raw Q.K dot becomes P, dp the dO.V
// dot becomes dS; lse2 the row's logsumexp in log2 units (+inf: the row sees
// no key), ok the mask
__device__ __forceinline__ void grad_score_mma(float& s, float& dp, float lse2, float delta,
                                               bool ok, float scale_log2, float scale,
                                               float softcap, float cap_in) {
  float x2 = s * scale_log2, dcap = 1.f;
  if (softcap > 0.f) {
    const float c = soft_cap(s * scale, softcap, cap_in);   // softcap tanh(s scale / softcap)
    const float t = __fdividef(c, softcap);
    dcap = 1.f - t * t;
    x2 = c * kLog2e;
  }
  const float p = ok ? ex2(x2 - lse2) : 0.f;
  dp = ok ? p * (dp - delta) * dcap : 0.f;
  s = p;
}

// 2. (mma) dK and dV of keys [k0, k0 + 64) of kv head hk, batch row b, from
// query heads [h0, h0 + G / splits) of its group; to dk / dv (splits 1) or to
// this subset's fp32 partials in ws (2, splits, B, Skv, Hkv, D)
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ ws, int splits, int B,
    int Sq, int Skv, int H, int Hkv, float scale, float softcap, int causal, int window,
    int q_offset) {
  constexpr int kRow = D + kMmaPad, kTile = kMmaTile * kRow, kNT = D / 8;
  extern __shared__ float4 smem_raw[];
  auto* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;                                      // [2][64 rows][kRow]
  bf16* gs = qs + 2 * kTile;                                  // dO, the same
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kTile);    // [2][64]
  float* del_s = lse_s + 2 * kMmaTile;                        // [2][64]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv, Gs = G / splits;
  const int hk = blockIdx.x / splits, split = blockIdx.x % splits, b = blockIdx.y;
  const int k0 = blockIdx.z * kMmaTile, k_last = min(k0 + kMmaTile, Skv) - 1;
  int qt_lo, nqt;
  bwd_query_tiles(k0, k_last, Sq, causal, window, q_offset, qt_lo, nqt);
  const int steps = Gs * nqt, h0 = hk * G + split * Gs;

  // step i: query head h0 + i / nqt, query tile qt_lo + i % nqt, into buffer buf
  auto load_step = [&](int i, int buf) {
    const int h = h0 + i / nqt, q0 = (qt_lo + i % nqt) * kMmaTile;
    stage_mma<D>(qs + buf * kTile, q, b, q0, Sq, H, h);
    stage_mma<D>(gs + buf * kTile, dout, b, q0, Sq, H, h);
    const int r = tid % kMmaTile;                             // threads 0-63 lse, 64-127 Delta
    float* dst = (tid < kMmaTile ? lse_s : del_s) + buf * kMmaTile + r;
    if (q0 + r < Sq)
      cp_async4(dst, (tid < kMmaTile ? lse : delta) + (static_cast<size_t>(b) * H + h) * Sq + q0 + r);
    else
      *dst = tid < kMmaTile ? -INFINITY : 0.f;
  };
  if (steps > 0) {
    stage_mma<D>(ks, k, b, k0, Skv, Hkv, hk);
    stage_mma<D>(vs, v, b, k0, Skv, Hkv, hk);
    load_step(0, 0);
  }
  cp_async_commit();

  float acc_k[kNT][4], acc_v[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e, cap_in = softcap > 0.f ? 2.f * kLog2e / softcap : 0.f;
  const int kpos = k0 + warp * 16 + lane / 4;   // the thread's keys: kpos, kpos + 8
  const bf16* kw = ks + warp * 16 * kRow;
  const bf16* vw = vs + warp * 16 * kRow;

  for (int i = 0; i < steps; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // step i visible to every thread, every warp done with step i - 1,
    // whose buffer the next load takes
    __syncthreads();
    if (i + 1 < steps) load_step(i + 1, (i + 1) & 1);
    cp_async_commit();
    const int buf = i & 1, q0 = (qt_lo + i % nqt) * kMmaTile;
    const bf16* qt = qs + buf * kTile;
    const bf16* gt = gs + buf * kTile;
    const float* ls = lse_s + buf * kMmaTile;
    const float* dl = del_s + buf * kMmaTile;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 rows
    float s[8][4], dp[8][4];
    mma_rows_x64<D>(s, kw, qt, lane);
    mma_rows_x64<D>(dp, vw, gt, lane);
    // P^T and dS^T in place. Fragment (nt, e): key kpos + 8 (e / 2), row
    // 8 nt + 2 (lane % 4) + e % 2
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = nt * 8 + 2 * (lane % 4);
      const float2 l = *reinterpret_cast<const float2*>(ls + row);
      const float2 d = *reinterpret_cast<const float2*>(dl + row);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kpos + 8 * (e >> 1), qpos = q0 + row + (e & 1) + q_offset;
        const float lr = e & 1 ? l.y : l.x;
        const bool ok = key < Skv && lr != -INFINITY && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
        grad_score_mma(s[nt][e], dp[nt][e], lr * kLog2e, e & 1 ? d.y : d.x, ok, scale_log2,
                       scale, softcap, cap_in);
      }
    }
    mma_acc_x64<D>(acc_v, s, gt, lane);    // dV += P^T dO
    mma_acc_x64<D>(acc_k, dp, qt, lane);   // dK += dS^T Q
  }

  const size_t n = static_cast<size_t>(B) * Skv * Hkv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = kpos + 8 * hh;
    if (pos >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + pos) * Hkv + hk) * D + 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float k0v = acc_k[nt][2 * hh], k1v = acc_k[nt][2 * hh + 1];
      const float v0v = acc_v[nt][2 * hh], v1v = acc_v[nt][2 * hh + 1];
      if (splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + nt * 8) =
            __floats2bfloat162_rn(k0v * scale, k1v * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + nt * 8) = __floats2bfloat162_rn(v0v, v1v);
      } else {
        *reinterpret_cast<float2*>(ws + split * n + off + nt * 8) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(ws + (splits + split) * n + off + nt * 8) =
            make_float2(v0v, v1v);
      }
    }
  }
}

// (mma, splits > 1) dk = scale * the sum of the subsets' partial dK, dv = the
// sum of their partial dV, each in subset order; 4 elements a thread
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads) dkdv_reduce_kernel(
    const float* __restrict__ ws, int splits, long long n, float scale, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  const long long i = (static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const long long e = is_v ? i - n : i;
  const float* src = ws + (is_v ? splits * n : 0) + e;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 t = *reinterpret_cast<const float4*>(src + s * n);
    a.x += t.x;
    a.y += t.y;
    a.z += t.z;
    a.w += t.w;
  }
  const float f = is_v ? 1.f : scale;
  auto* dst = reinterpret_cast<__nv_bfloat162*>((is_v ? dv : dk) + e);
  dst[0] = __floats2bfloat162_rn(a.x * f, a.y * f);
  dst[1] = __floats2bfloat162_rn(a.z * f, a.w * f);
}

// 3. (mma) dQ of query rows [q0, q0 + 64) of query head h, batch row b; grid
// z counts the query tiles from the last, which walk the most key tiles
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv, float scale, float softcap,
    int causal, int window, int q_offset) {
  constexpr int kRow = D + kMmaPad, kTile = kMmaTile * kRow, kNT = D / 8;
  extern __shared__ float4 smem_raw[];
  auto* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kTile;                 // dO
  bf16* ks = gs + kTile;                 // [2][64 keys][kRow]
  bf16* vs = ks + 2 * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaTile, nq = min(kMmaTile, Sq - q0);
  int kv_lo, kv_hi, t0, tiles;
  mma_key_tiles(q0 + q_offset, q0 + nq - 1 + q_offset, Skv, causal, window, kv_lo, kv_hi, t0,
                tiles);
  if (tiles > 0) {
    stage_mma<D>(qs, q, b, q0, Sq, H, h);
    stage_mma<D>(gs, dout, b, q0, Sq, H, h);
    stage_mma<D>(ks, k, b, t0 * kMmaTile, Skv, Hkv, hk);
    stage_mma<D>(vs, v, b, t0 * kMmaTile, Skv, Hkv, hk);
  }
  cp_async_commit();

  // the thread's rows wrow and wrow + 8 (accumulator fragment rows lane / 4
  // and lane / 4 + 8 of its warp's 16): lse in log2 units, +inf for a row
  // past Sq or with no visible key
  const int wrow = warp * 16 + lane / 4;
  float lse2[2], del[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + wrow + 8 * hh;
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq + r;
    const float l = r < Sq ? lse[row] : -INFINITY;
    lse2[hh] = l == -INFINITY ? INFINITY : l * kLog2e;
    del[hh] = r < Sq ? delta[row] : 0.f;
  }
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e, cap_in = softcap > 0.f ? 2.f * kLog2e / softcap : 0.f;
  const bf16* qw = qs + warp * 16 * kRow;
  const bf16* gw = gs + warp * 16 * kRow;

  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t (and q, dO) visible to every thread, every warp done with tile
    // t - 1, whose buffer the next load takes
    __syncthreads();
    if (t + 1 < tiles) {
      const int nb = (t + 1) & 1;
      stage_mma<D>(ks + nb * kTile, k, b, (t0 + t + 1) * kMmaTile, Skv, Hkv, hk);
      stage_mma<D>(vs + nb * kTile, v, b, (t0 + t + 1) * kMmaTile, Skv, Hkv, hk);
    }
    cp_async_commit();
    const bf16* kt = ks + (t & 1) * kTile;
    const bf16* vt = vs + (t & 1) * kTile;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
    mma_rows_x64<D>(s, qw, kt, lane);
    mma_rows_x64<D>(dp, gw, vt, lane);
    // dS in place of dP. Fragment (nt, e): row wrow + 8 (e / 2), key
    // 8 nt + 2 (lane % 4) + e % 2 of the tile
    const int kbase = (t0 + t) * kMmaTile + 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nt * 8 + (e & 1), hh = e >> 1;
        const int qpos = q0 + wrow + 8 * hh + q_offset;
        const bool ok = key < Skv && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
        grad_score_mma(s[nt][e], dp[nt][e], lse2[hh], del[hh], ok, scale_log2, scale, softcap,
                       cap_in);
      }
    mma_acc_x64<D>(acc, dp, kt, lane);     // dQ += dS K
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + wrow + 8 * hh;
    if (r >= Sq) continue;
    bf16* dst = dq + ((static_cast<size_t>(b) * Sq + r) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * hh] * scale, acc[nt][2 * hh + 1] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B, int Sq, int H,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  delta_kernel<T, D><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(out),
                                                      static_cast<const T*>(dout), delta, Sq, H,
                                                      rows);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_tiled(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                 int Skv, int H, int Hkv, float scale, float softcap, int causal, int window,
                 int q_offset, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  cudaError_t err = launch_delta<T, D>(out, dout, delta, B, Sq, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk != nullptr) {
    constexpr int bytes = static_cast<int>(sizeof(DkdvSmem<D>));
    static const cudaError_t attr = allow_smem(dkdv_kernel<T, D>, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((Skv + kBK - 1) / kBK, Hkv, B);
    dkdv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, Hkv,
        scale, softcap, causal, window, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    constexpr int bytes = static_cast<int>(sizeof(DqSmem<D>));
    static const cudaError_t attr = allow_smem(dq_kernel<T, D>, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(qt, kt, vt, gt, lse, delta,
                                                      static_cast<T*>(dq), Sq, Skv, H, Hkv,
                                                      scale, softcap, causal, window, q_offset);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, float* ws, void* dq, void* dk, void* dv, int B,
               int Sq, int Skv, int H, int Hkv, int splits, float scale, float softcap,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  cudaError_t err = launch_delta<bf16, D>(out, dout, delta, B, Sq, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk != nullptr) {
    constexpr int bytes = dkdv_mma_smem<D>();
    static const cudaError_t attr = allow_smem(dkdv_mma_kernel<D>, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(Hkv * splits, B, (Skv + kMmaTile - 1) / kMmaTile);
    dkdv_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, splits, B,
        Sq, Skv, H, Hkv, scale, softcap, causal, window, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits > 1) {
      const long long n = static_cast<long long>(B) * Skv * Hkv * D;
      const unsigned blocks =
          static_cast<unsigned>((2 * n / 4 + kReduceThreads - 1) / kReduceThreads);
      dkdv_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
          ws, splits, n, scale, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (dq != nullptr) {
    constexpr int bytes = dq_mma_smem<D>();
    static const cudaError_t attr = allow_smem(dq_mma_kernel<D>, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(H, B, (Sq + kMmaTile - 1) / kMmaTile);
    dq_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), Sq, Skv, H, Hkv, scale, softcap,
        causal, window, q_offset);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// The constants the wrapper mirrors, in this order: the tiled path's query
// rows a tile and keys a tile, the mma path's tile (keys a dK / dV block,
// rows a dQ block).
extern "C" void flash_attention_bwd_constants(int* c) {
  c[0] = kBQ;
  c[1] = kBK;
  c[2] = kMmaTile;
}

// Returns the CUDA error of the launches (0 on success), -1 for a path,
// dtype, head dim or split the kernels do not take. path 0 = tiled (fp32),
// 1 = mma (bf16). Layouts: q / out / dout / dq (B, Sq, H, D); k / v / dk / dv
// (B, Skv, Hkv, D), all contiguous, one dtype; lse and the workspace delta
// (B, H, Sq) fp32; ws (mma with splits > 1 and dk: the partials, (2, splits,
// B, Skv, Hkv, D) fp32). splits divides H / Hkv (1 on the tiled path). dq
// null skips the dq kernel; dk (and dv with it) null skips the dK / dV
// kernels.
extern "C" int flash_attention_bwd_launch(int path, const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const float* lse,
                                          float* delta, float* ws, void* dq, void* dk, void* dv,
                                          int B, int Sq, int Skv, int H, int Hkv, int D,
                                          int splits, float scale, float softcap, int causal,
                                          int window, int q_offset, int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || splits < 1 || (H / Hkv) % splits != 0) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != kBFloat16 || (splits > 1 && dk != nullptr && ws == nullptr)) return -1;
    switch (D) {
      case 16: return launch_mma<16>(q, k, v, out, dout, lse, delta, ws, dq, dk, dv, B, Sq, Skv,
                                     H, Hkv, splits, scale, softcap, causal, window, q_offset, s);
      case 64: return launch_mma<64>(q, k, v, out, dout, lse, delta, ws, dq, dk, dv, B, Sq, Skv,
                                     H, Hkv, splits, scale, softcap, causal, window, q_offset, s);
      case 96: return launch_mma<96>(q, k, v, out, dout, lse, delta, ws, dq, dk, dv, B, Sq, Skv,
                                     H, Hkv, splits, scale, softcap, causal, window, q_offset, s);
      case 128: return launch_mma<128>(q, k, v, out, dout, lse, delta, ws, dq, dk, dv, B, Sq,
                                       Skv, H, Hkv, splits, scale, softcap, causal, window,
                                       q_offset, s);
      default: return -1;
    }
  }
  if (path != 0 || splits != 1 || dtype != kFloat32) return -1;
  switch (D) {
    case 16: return launch_tiled<float, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                                            H, Hkv, scale, softcap, causal, window, q_offset, s);
    case 64: return launch_tiled<float, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                                            H, Hkv, scale, softcap, causal, window, q_offset, s);
    case 96: return launch_tiled<float, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                                            H, Hkv, scale, softcap, causal, window, q_offset, s);
    case 128: return launch_tiled<float, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq,
                                              Skv, H, Hkv, scale, softcap, causal, window,
                                              q_offset, s);
    default: return -1;
  }
}
