// Paged decode attention on Hopper (sm_90a): one new query token per
// sequence against its KV in the paged pool. Serves LM.decode_step over a
// paged cache.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py,
// paged_attention_pallas (body _paged_kernel). Same function: row b attends
// to its pool entries at positions pos < lengths[b] and, with a window,
// pos > lengths[b] - 1 - window; scores are scaled, optionally softcapped,
// and reduced with an fp32 softmax; length 0 gives zeros.
//
// What bounds it on the card: bytes. Each (row, kv head) reads its visible
// K/V once and does 4*D flops per (query head, key) pair, with G = H / Hkv
// query heads per key: ~2G flop per byte, far below the H100's ~295
// flop/byte ridge. At the serving path's sizes (4 rows, a few hundred keys)
// that bound is about a microsecond, so launch latency and the length of
// each block's serial walk decide the time.
//
// Design (split-KV, "flash-decoding"):
//  - the TPU grid (B, Hkv, pages) walks one row's pages in order with the
//    softmax state in VMEM. A grid of B * Hkv blocks would leave most of the
//    132 SMs idle (32 blocks at the serving shape), so the page walk is split:
//    pass 1, grid (splits, Hkv, B), gives each block kKeys consecutive key
//    positions of one (row, kv head) and the G query heads of that kv head.
//    It reads its own length and page ids, exits at once when its keys are
//    all invisible (past the length, or before the window: the test of
//    kernel.py:62-66), stages K (transposed) and V in shared memory as fp32,
//    and writes its partial max, sum and P V (fp32) to a scratch buffer.
//  - pass 2, grid (Hkv, B), rescales the live splits of each row by their
//    maxima and divides by the total sum; a row with no visible key gives
//    zeros. Both passes go on the caller's stream in one launch call.
//  - key positions map to (page, slot) one by one, so any page size works.
//  - fp32 or bf16 query and pool (they may differ), fp32 math, out in q's
//    type. CUDA-core FMAs; cp.async / TMA staging is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 32;  // key positions per split: one per lane of a warp
constexpr int kMaxG = 8;   // query heads per kv head

// Visible key positions [lo, hi) of a row: below its length and the pool
// row's capacity, and inside the window that ends at length - 1.
__device__ __forceinline__ void key_range(int length, int cap, int window, int* lo, int* hi) {
  *hi = max(min(length, cap), 0);
  *lo = window > 0 ? max(length - window, 0) : 0;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int Hkv, int ps,
    int maxp, int nsplit, float scale, float softcap, int window) {
  static_assert(kKeys == 32, "the softmax gives one key to each lane");
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[D][kKeys + 1];  // k^T, padded against bank conflicts
  __shared__ float vs[kKeys][D];
  __shared__ float ss[kMaxG][kKeys];  // scores, then probabilities
  __shared__ size_t rowoff[kKeys];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  int lo, hi;
  key_range(lengths[b], maxp * ps, window, &lo, &hi);
  const int k0 = split * kKeys;
  if (hi <= lo || k0 >= hi || k0 + kKeys <= lo) return;  // nothing visible here
  const int j_lo = max(lo - k0, 0), j_hi = min(hi - k0, kKeys);

  const int tid = threadIdx.x;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_f32(q[(static_cast<size_t>(b) * H + hk * G + g) * D + d]);
  }
  if (tid < kKeys) {
    size_t off = 0;
    if (tid >= j_lo && tid < j_hi) {
      const int pos = k0 + tid;
      const size_t page = static_cast<size_t>(page_table[static_cast<size_t>(b) * maxp + pos / ps]);
      off = ((page * ps + pos % ps) * Hkv + hk) * D;
    }
    rowoff[tid] = off;
  }
  __syncthreads();
  for (int i = tid; i < kKeys * D; i += kThreads) {
    const int j = i / D, d = i % D;
    float kx = 0.f, vx = 0.f;
    if (j >= j_lo && j < j_hi) {
      kx = to_f32(kp[rowoff[j] + d]);
      vx = to_f32(vp[rowoff[j] + d]);
    }
    ks[d][j] = kx;
    vs[j][d] = vx;
  }
  __syncthreads();

  for (int i = tid; i < G * kKeys; i += kThreads) {
    const int g = i / kKeys, j = i % kKeys;
    float s = -INFINITY;
    if (j >= j_lo && j < j_hi) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) dot[u] = fmaf(qs[g][d + u], ks[d + u][j], dot[u]);
      s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    }
    ss[g][j] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const size_t part = (static_cast<size_t>(b) * Hkv + hk) * nsplit + split;
  for (int g = warp; g < G; g += kThreads / 32) {
    const float s = ss[g][lane];
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    const float p = s == -INFINITY ? 0.f : expf(s - m);  // m is finite: a key is visible
    float l = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(~0u, l, o);
    ss[g][lane] = p;
    if (lane == 0) {
      part_ml[(part * G + g) * 2] = m;
      part_ml[(part * G + g) * 2 + 1] = l;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < kKeys; ++j) a = fmaf(ss[g][j], vs[j][d], a);
    part_acc[(part * G + g) * D + d] = a;
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, TQ* __restrict__ out, int H, int Hkv, int D, int ps,
    int maxp, int nsplit, int window) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  int lo, hi;
  key_range(lengths[b], maxp * ps, window, &lo, &hi);
  // the splits pass 1 wrote for this row
  const int s_lo = lo / kKeys, s_hi = hi > lo ? (hi + kKeys - 1) / kKeys : s_lo;
  const size_t base = (static_cast<size_t>(b) * Hkv + hk) * nsplit;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int s = s_lo; s < s_hi; ++s) M = fmaxf(M, part_ml[((base + s) * G + g) * 2]);
    float L = 0.f, a = 0.f;
    for (int s = s_lo; s < s_hi; ++s) {
      const size_t r = (base + s) * G + g;
      const float w = expf(part_ml[r * 2] - M);
      L = fmaf(part_ml[r * 2 + 1], w, L);
      a = fmaf(part_acc[r * D + d], w, a);
    }
    out[(static_cast<size_t>(b) * H + hk * G + g) * D + d] = from_f32<TQ>(L > 0.f ? a / L : 0.f);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* page_table,
           const void* lengths, void* out, float* part_acc, float* part_ml, int B, int H,
           int Hkv, int ps, int maxp, int nsplit, float scale, float softcap, int window,
           cudaStream_t stream) {
  paged_split_kernel<TQ, TKV, D><<<dim3(nsplit, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths), part_acc, part_ml,
      H, Hkv, ps, maxp, nsplit, scale, softcap, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine_kernel<TQ><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(lengths), static_cast<TQ*>(out), H, Hkv, D, ps,
      maxp, nsplit, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of key splits pass 1 uses for a page table of maxp pages of ps.
extern "C" int paged_attention_splits(int ps, int maxp) { return (maxp * ps + kKeys - 1) / kKeys; }

// Returns the CUDA error of the launches (0 on success), -1 for an
// unsupported dtype, head dim or group size. Layouts: q / out (B, H, D);
// k / v pools (P, ps, Hkv, D); page_table (B, maxp) int32; lengths (B,)
// int32; part_acc (B, Hkv, nsplit, G, D) and part_ml (B, Hkv, nsplit, G, 2)
// fp32 scratch; all contiguous.
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* lengths, void* out,
                                      void* part_acc, void* part_ml, int B, int H, int Hkv,
                                      int D, int ps, int maxp, float scale, float softcap,
                                      int window, int q_dtype, int kv_dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const int nsplit = paged_attention_splits(ps, maxp);
  auto* acc = static_cast<float*>(part_acc);
  auto* ml = static_cast<float*>(part_ml);
  return dispatch_dtype(q_dtype, [&](auto tq) {
    using TQ = std::remove_pointer_t<decltype(tq)>;
    return dispatch_dtype(kv_dtype, [&](auto tkv) {
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      switch (D) {
        case 16: return launch<TQ, TKV, 16>(q, kp, vp, page_table, lengths, out, acc, ml, B, H,
                                            Hkv, ps, maxp, nsplit, scale, softcap, window, s);
        case 128: return launch<TQ, TKV, 128>(q, kp, vp, page_table, lengths, out, acc, ml, B,
                                              H, Hkv, ps, maxp, nsplit, scale, softcap, window,
                                              s);
        default: return -1;
      }
    });
  });
}
