// Chunked paged attention on Hopper (sm_90a): causal GQA attention of a
// chunk of C query tokens per batch row over the paged KV pool. Serves the
// engine's prefill pack (C = chunk) and its decode sweep (C = 1).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py,
// chunked_prefill_pallas (body _chunked_prefill_kernel). Same function:
// query token c of row b sits at position starts[b] + c and attends to the
// pool's entries kv_pos < lengths[b], kv_pos <= q_pos, and, with a window,
// kv_pos > q_pos - window; scores are scaled, optionally softcapped, and
// reduced with an fp32 online softmax; a row with no visible key (lengths
// 0: idle decode slots, padding rows of the prefill pack) gives zeros.
//
// What bounds it on the card: bytes. Each block reads its KV pages once and
// does 4*D flops per (query row, key) pair, far below the H100's ~295
// flop/byte ridge at the engine's chunk sizes; decode (C = 1, G = 4 rows
// per KV head) is pure page streaming.
//
// Design:
//  - grid = (tiles of kRows folded query rows, KV head, batch row); the
//    fold r = c*G + g (the TPU kernel's (chunk, G) row axis) lets one
//    staged KV page serve every query head of its GQA group and every
//    token of the chunk. The public layout stays (B, C, H, D).
//  - the TPU grid walks pages in order with state in VMEM scratch; here a
//    block walks its pages in a loop instead, keeping the running max and
//    sum per row in shared memory and the output accumulator in registers
//    (each thread owns one head-dim column of kRows / (128 / D) rows).
//  - a block reads its own starts / lengths / page ids, visits only pages
//    below ceil(length / ps), stops at the last page its tile's queries can
//    see causally, and skips pages wholly outside the window (the test of
//    kernel.py:188-190, taken at the tile's first query position).
//  - KV is staged kKeys keys at a time in shared memory as fp32 (rows
//    padded by one word against bank conflicts), so any page size works.
//  - CUDA-core fp32 FMAs. Tensor cores (mma.sync / wgmma) and TMA staging
//    are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;   // folded query rows per block
constexpr int kKeys = 16;   // keys staged in shared memory per step
constexpr float kNegBig = -1.0e30f;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    const int* __restrict__ starts, TQ* __restrict__ out, int C, int H, int Hkv, int ps,
    int maxp, float scale, float softcap, int window) {
  static_assert(kThreads % D == 0, "head_dim must divide the block size");
  constexpr int kGroups = kThreads / D;       // row groups in the PV product
  constexpr int kPerThread = kRows / kGroups;  // accumulator rows per thread
  static_assert(kRows % kGroups == 0, "row tile must split over row groups");

  __shared__ float qs[kRows][D + 1];
  __shared__ float ks[kKeys][D + 1];
  __shared__ float vs[kKeys][D];
  __shared__ float ps_[kRows][kKeys + 1];  // scores, then probabilities
  __shared__ float m_s[kRows], l_s[kRows], a_s[kRows];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int G = H / Hkv;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, C * G - r0);
  const int length = lengths[b];
  const int start = starts[b];

  for (int i = tid; i < nr * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int r = r0 + row, c = r / G, g = r % G;
    qs[row][d] = to_f32(q[((static_cast<size_t>(b) * C + c) * H + h * G + g) * D + d]);
  }
  for (int row = tid; row < kRows; row += kThreads) {
    m_s[row] = kNegBig;
    l_s[row] = 0.f;
  }
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  const int q_lo = start + r0 / G;             // this tile's first and last
  const int q_hi = start + (r0 + nr - 1) / G;  // query positions
  const int p_end = min(min((length + ps - 1) / ps, maxp), q_hi / ps + 1);
  __syncthreads();

  for (int p = 0; p < p_end; ++p) {
    const int base = p * ps;
    if (window > 0 && !(base + ps - 1 > q_lo - window)) continue;
    const size_t page = static_cast<size_t>(page_table[static_cast<size_t>(b) * maxp + p]);
    for (int j0 = 0; j0 < ps; j0 += kKeys) {
      const int nk = min(kKeys, ps - j0);
      for (int i = tid; i < nk * D; i += kThreads) {
        const int j = i / D, d = i % D;
        const size_t off = ((page * ps + j0 + j) * Hkv + h) * D + d;
        ks[j][d] = to_f32(kp[off]);
        vs[j][d] = to_f32(vp[off]);
      }
      __syncthreads();

      // masked scores; -inf marks a masked (row, key) pair
      for (int i = tid; i < nr * kKeys; i += kThreads) {
        const int row = i / kKeys, j = i % kKeys;
        float s = -INFINITY;
        if (j < nk) {
          const int kv_pos = base + j0 + j;
          const int q_pos = start + (r0 + row) / G;
          const bool ok = kv_pos < length && kv_pos <= q_pos &&
                          (window <= 0 || kv_pos > q_pos - window);
          if (ok) {
            float dot = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], ks[j][d], dot);
            s = dot * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          }
        }
        ps_[row][j] = s;
      }
      __syncthreads();

      // online softmax update, one thread per query row
      for (int row = tid; row < nr; row += kThreads) {
        const float m_prev = m_s[row];
        float m_new = m_prev;
        for (int j = 0; j < nk; ++j) {
          const float s = ps_[row][j];
          if (s != -INFINITY) m_new = fmaxf(m_new, s);
        }
        float sum = 0.f;
        for (int j = 0; j < nk; ++j) {
          const float s = ps_[row][j];
          const float pr = (s != -INFINITY) ? expf(s - m_new) : 0.f;
          ps_[row][j] = pr;
          sum += pr;
        }
        const float alpha = expf(m_prev - m_new);
        a_s[row] = alpha;
        l_s[row] = alpha * l_s[row] + sum;
        m_s[row] = m_new;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int row = rgroup + i * kGroups;
        if (row < nr) {
          float o = acc[i] * a_s[row];
          for (int j = 0; j < nk; ++j) o = fmaf(ps_[row][j], vs[j][dcol], o);
          acc[i] = o;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int row = rgroup + i * kGroups;
    if (row < nr) {
      const float l = l_s[row];
      const int r = r0 + row, c = r / G, g = r % G;
      out[((static_cast<size_t>(b) * C + c) * H + h * G + g) * D + dcol] =
          from_f32<TQ>(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* page_table,
           const void* lengths, const void* starts, void* out, int B, int C, int H, int Hkv,
           int ps, int maxp, float scale, float softcap, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid((C * G + kRows - 1) / kRows, Hkv, B);
  chunked_prefill_kernel<TQ, TKV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<TQ*>(out), C, H, Hkv, ps, maxp, scale,
      softcap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// dtype or head dim. Layouts: q/out (B, C, H, D); k/v pools (P, ps, Hkv, D);
// page_table (B, maxp) int32; lengths, starts (B,) int32; all contiguous.
extern "C" int chunked_prefill_launch(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* lengths,
                                      const void* starts, void* out, int B, int C, int H,
                                      int Hkv, int D, int ps, int maxp, float scale,
                                      float softcap, int window, int q_dtype, int kv_dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(q_dtype, [&](auto tq) {
    using TQ = std::remove_pointer_t<decltype(tq)>;
    return dispatch_dtype(kv_dtype, [&](auto tkv) {
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      switch (D) {
        case 16: return launch<TQ, TKV, 16>(q, kp, vp, page_table, lengths, starts, out, B, C,
                                            H, Hkv, ps, maxp, scale, softcap, window, s);
        case 128: return launch<TQ, TKV, 128>(q, kp, vp, page_table, lengths, starts, out, B,
                                              C, H, Hkv, ps, maxp, scale, softcap, window, s);
        default: return -1;
      }
    });
  });
}
