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
// (src/repro/kernels/flash_attention/ops.py). The formulas are FA2's, from
// the forward's output O and row logsumexp lse (B, H, Sq) of the post-softcap
// scaled scores:
//   P = exp(S - lse)            (0 where masked, and on a row with no visible
//                                key: lse = -inf, forward output 0)
//   dV = P^T dO;  dP = dO V^T;  Delta = rowsum(dO o O)
//   dS = P o (dP - Delta), times 1 - tanh^2(s / cap) under a softcap
//   dQ = dS K * scale;  dK = dS^T Q * scale
//
// Three kernels, launched in order on one stream:
//   1. delta: Delta per (b, h, row), one warp a row, fp32.
//   2. dkdv: one block per (32-key tile, kv head, batch row). It walks the G
//      query heads of its GQA group and, for each, the 64-row query tiles
//      that can see its keys (the inverse of the forward's key_tiles), and
//      keeps dK and dV in registers: the group's sum stays inside the block,
//      so there are no atomics and a repeat gives the same bits.
//   3. dq: one block per (64-row query tile, query head, batch row), walking
//      the key tiles its rows can see, dQ in registers.
// Both recompute S and dP from tiles staged in shared memory as fp32 (inputs
// fp32 or bf16), with IEEE fp32 FMAs on the CUDA cores and fp32 accumulators;
// outputs in the inputs' dtype. A thread of the 16 x 16 grid of a block owns
// 4 x 2 scores (rows t + 16 u, keys t' + 16 a: neighbouring threads on
// neighbouring padded rows, so the float4 loads of a quarter warp hit
// distinct banks) and 2 rows x D/16 columns of each accumulator.
//
// What bounds it on the card: 2.5x the forward's 4*D operations per visible
// (query head, key) pair, against q, k, v, o, dO and lse read once and dq,
// dk, dv written once: at the training shapes (512 tokens, D = 128) the
// operations, ~0.01 ms at the bf16 tensor-core rate. This first design runs
// on the CUDA cores and reads its operands from shared memory for every FMA
// pair, so it stays far from that bound; mma.sync / wgmma tiles for bf16 and
// dQ folded into the dK / dV pass are later work.

#include "common.cuh"

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int H, int Hkv, float scale, float softcap, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  delta_kernel<T, D><<<delta_blocks, kThreads, 0, stream>>>(static_cast<const T*>(out), gt,
                                                           delta, Sq, H, rows);
  cudaError_t err = cudaGetLastError();
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

}  // namespace

// The constants the wrapper mirrors, in this order: query rows a tile, keys
// a tile.
extern "C" void flash_attention_bwd_constants(int* c) {
  c[0] = kBQ;
  c[1] = kBK;
}

// Returns the CUDA error of the launches (0 on success), -1 for a dtype or
// head dim the kernels do not take. Layouts: q / out / dout / dq (B, Sq, H,
// D); k / v / dk / dv (B, Skv, Hkv, D), all contiguous, one dtype; lse and
// the workspace delta (B, H, Sq) fp32. dq null skips the dq kernel; dk (and
// dv with it) null skips the dkdv kernel.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int Hkv, int D, float scale,
                                          float softcap, int causal, int window, int q_offset,
                                          int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    switch (D) {
      case 16: return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                    Hkv, scale, softcap, causal, window, q_offset, s);
      case 64: return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                    Hkv, scale, softcap, causal, window, q_offset, s);
      case 96: return launch<T, 96>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                    Hkv, scale, softcap, causal, window, q_offset, s);
      case 128: return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                      Hkv, scale, softcap, causal, window, q_offset, s);
      default: return -1;
    }
  });
}
