// Chunked paged attention on Hopper (sm_90a): causal GQA attention of a
// chunk of C query tokens per batch row over the paged KV pool. Serves the
// engine's prefill pack (C = chunk) and its decode sweep (C = 1), and, through
// its split path in decode mode, LM.decode_step over a paged cache
// (paged_attention_cuda: one token a row at position lengths[b] - 1).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py,
// chunked_prefill_pallas (body _chunked_prefill_kernel). Same function:
// query token c of row b sits at position starts[b] + c and attends to the
// pool's entries kv_pos < lengths[b], kv_pos <= q_pos, and, with a window,
// kv_pos > q_pos - window; scores are scaled, optionally softcapped, and
// reduced with an fp32 online softmax; a row with no visible key (lengths
// 0: idle decode slots, padding rows of the prefill pack) gives zeros.
// In decode mode it also replaces paged_attention_pallas (same file, body
// _paged_kernel): row b's one query at q_pos = lengths[b] - 1 sees kv_pos <
// lengths[b] and, with a window, kv_pos > lengths[b] - 1 - window, which is
// the chunked function at C = 1.
//
// The fold r = c * G + g (the TPU kernel's (chunk, G) row axis) lets one
// staged KV tile serve every query head of its GQA group and every token of
// the chunk; the public layout stays (B, C, H, D). A block reads its own
// starts / lengths / page ids; key positions map to (page, slot) one by
// one, so any page size works.
//
// What bounds it on the card: bytes at decode (C * G folded rows a KV head
// read every visible key once: 2 * C * G flop a byte, far below the H100's
// ~295 flop/byte ridge), launch latency at the serving path's sizes (its
// byte bound is about a microsecond). The TPU grid (B, Hkv, pages) walks a
// row's pages in order; here the host-side plan (kernels/paged_attention/
// kernel.py's _plan) picks one of three kernels:
//
//  - split (C * G <= kSplitMaxRows = 32 folded rows: the decode sweep,
//    verify chunks; any dtype), flash-decoding. A grid of B * Hkv blocks
//    would leave most of the 132 SMs idle (32 at the decode sweep), so the
//    pool row's key positions are cut into `splits` ranges of whole
//    kSplitKeys tiles: grid (splits, Hkv, B). A block exits at once when
//    its range holds no key the chunk can see (past min(length, start + C),
//    or wholly before its first query's window); otherwise it streams its
//    tiles through a two-stage cp.async ring, scores all folded rows of its
//    KV head against them in fp32 (a warp a row, a lane a key), and writes
//    the rows' partial max, sum and P V (fp32). A second kernel, launched as
//    a programmatic dependent, merges each row's live splits in a fixed
//    order, one output value a thread, so repeats are bit-equal.
//  - mma (bf16 q and pool above that: prefill packs), FA2 on
//    mma.sync.m16n8k16 (attention_mma.cuh, shared with flash_attention.cu).
//    A block takes 64 folded rows of one KV head, walks 64-key tiles from
//    its first query's window to its last query's position through a
//    cp.async double buffer, and keeps the softmax and P V in registers; P
//    enters the tensor cores as hi + lo bf16 parts.
//  - tiled (fp32 or mixed dtypes above that; an fp32 case stays IEEE fp32
//    on the CUDA cores): the port's first kernel, kept as it was. A block
//    takes kRows folded rows and walks its row's pages in a loop, staging
//    kKeys keys at a time as fp32 in shared memory.

#include "attention_mma.cuh"   // the mma body; cp_async16 (gemm_common.cuh)

namespace {

// ------------------------------------------------------------------ tiled
constexpr int kThreads = 128;
constexpr int kRows = 32;   // folded query rows per block
constexpr int kKeys = 16;   // keys staged in shared memory per step

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

// ------------------------------------------------------------------ split
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 32;      // keys a staged tile: one a lane in the softmax
constexpr int kSplitMaxRows = 32;   // folded query rows a split block takes at most

// Key positions [lo, hi) that some query of a row's chunk can see: below its
// length, its last query's position + 1 and the pool row's capacity, and
// with a window inside its first query's window.
__device__ __forceinline__ void chunk_keys(int length, int start, int C, int cap, int window,
                                           int& lo, int& hi) {
  hi = max(min(min(length, start + C), cap), 0);
  lo = window > 0 ? max(start - window + 1, 0) : 0;
}

// Row b's first query position: starts[b], or with no starts (decode mode,
// paged_attention_cuda's one new token a row) lengths[b] - 1, so that a
// row of length 0 sits at -1 and sees nothing.
__device__ __forceinline__ int row_start(const int* starts, const int* lengths, int b) {
  return starts != nullptr ? starts[b] : lengths[b] - 1;
}

// Tiles of kSplitKeys in a pool row of cap positions (at least one).
__host__ __device__ __forceinline__ long long split_units(int cap) {
  return cap > kSplitKeys ? (cap + kSplitKeys - 1) / kSplitKeys : 1;
}

// Key positions [k0, k1) of split s: the split_units(cap) whole tiles cut
// as evenly as integers allow (kernels/paged_attention/kernel.py's
// split_ranges mirrors it; splits <= units, so none is empty).
__device__ __forceinline__ void split_keys(int cap, int splits, int s, int& k0, int& k1) {
  const long long units = split_units(cap);
  k0 = static_cast<int>(min(static_cast<long long>(cap), s * units / splits * kSplitKeys));
  k1 = static_cast<int>(min(static_cast<long long>(cap), (s + 1) * units / splits * kSplitKeys));
}

// The splits [s_lo, s_hi) whose ranges meet [lo, hi) (none where lo >= hi):
// split s meets it iff its last tile floor((s + 1) U / S) - 1 reaches tile
// floor(lo / kSplitKeys) and its first tile floor(s U / S) lies before
// tile ceil(hi / kSplitKeys), both monotone in s (kernel.py's live_splits
// mirrors it)
__device__ __forceinline__ void live_splits(int lo, int hi, int cap, int splits, int& s_lo,
                                            int& s_hi) {
  if (lo >= hi) {
    s_lo = s_hi = 0;
    return;
  }
  const long long units = split_units(cap);
  s_lo = static_cast<int>(((lo / kSplitKeys + 1) * static_cast<long long>(splits) + units - 1) /
                          units) - 1;
  s_hi = static_cast<int>(((hi + kSplitKeys - 1) / kSplitKeys * static_cast<long long>(splits) +
                           units - 1) / units);
}

// 8 consecutive staged elements -> fp32 (16-byte aligned)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
}

// Shared memory of the split kernel: a ring of 2 stages of K and V tiles
// (rows padded by 16 bytes: 16-byte lane loads on distinct banks), then q
// (fp32), the probabilities and the rows' rescale factors.
template <typename TKV, int D>
struct SplitSmem {
  static constexpr int kRow = D + 16 / static_cast<int>(sizeof(TKV));   // elements a key row
  static constexpr int kTile = kSplitKeys * kRow;                        // elements a K / V tile
  static constexpr int kQRow = D + 4;                                    // floats a query row
  static constexpr int kRing = 4 * kTile * static_cast<int>(sizeof(TKV));
  __host__ __device__ static constexpr int bytes(int R) {
    return kRing + R * (kQRow + kSplitKeys + 1) * 4;
  }
};

// grid (splits, Hkv, B); MR >= C * G rows. part_acc (B, Hkv, splits, C*G,
// D) and part_ml (..., 2) fp32; a block that exits early writes nothing.
template <typename TQ, typename TKV, int D, int MR>
__global__ void __launch_bounds__(kSplitThreads) chunked_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    const int* __restrict__ starts, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int C, int H, int Hkv, int ps, int maxp, int splits, float scale, float softcap,
    int window) {
  using S = SplitSmem<TKV, D>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(TKV));            // elements a 16-byte chunk
  constexpr int kChunksRow = D / kPer;                                // chunks a key row
  constexpr int kRowsWarp = (MR + kSplitWarps - 1) / kSplitWarps;     // score rows a warp
  constexpr int kGroups = kSplitThreads / D;                          // P V row groups
  constexpr int kRowsPV = (MR + kGroups - 1) / kGroups;               // P V rows a thread
  static_assert(kSplitThreads % D == 0 && D % 8 == 0, "head_dim must divide the block");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, R = C * G, cap = maxp * ps;
  const int start = row_start(starts, lengths, b);
  int lo, hi, s_lo, s_hi;
  chunk_keys(lengths[b], start, C, cap, window, lo, hi);
  live_splits(lo, hi, cap, splits, s_lo, s_hi);
  if (split < s_lo || split >= s_hi) return;   // nothing here is visible
  int k0, k1;
  split_keys(cap, splits, split, k0, k1);
  const int kb = max(k0, lo / kSplitKeys * kSplitKeys), ke = min(k1, hi);
  const int tiles = (ke - kb + kSplitKeys - 1) / kSplitKeys;

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);                        // [stage][K | V][key][kRow]
  float* qs = reinterpret_cast<float*>(smem + S::kRing);           // [row][kQRow]
  float* pr = qs + R * S::kQRow;                                   // [row][key]
  float* alpha_s = pr + R * kSplitKeys;                            // [row]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t prow = static_cast<size_t>(b) * maxp;

  // stage tile t (keys kb + kSplitKeys t ...) in ring stage buf, one 16-byte
  // copy a chunk, zero-filled outside [lo, ke): no row holds garbage
  auto load_tile = [&](int t, int buf) {
    TKV* ks = ring + buf * 2 * S::kTile;
    TKV* vs = ks + S::kTile;
    const int base = kb + t * kSplitKeys;
    for (int i = tid; i < kSplitKeys * kChunksRow; i += kSplitThreads) {
      const int j = i / kChunksRow, c = i % kChunksRow * kPer;
      const int pos = base + j;
      const bool ok = pos >= lo && pos < ke;
      size_t off = 0;
      if (ok) {
        const size_t page = static_cast<size_t>(page_table[prow + pos / ps]);
        off = ((page * ps + pos % ps) * Hkv + h) * D + c;
      }
      cp_async16(ks + j * S::kRow + c, kp + off, ok ? 16 : 0);
      cp_async16(vs + j * S::kRow + c, vp + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  load_tile(0, 0);
  for (int i = tid; i < R * D; i += kSplitThreads) {
    const int r = i / D, d = i % D;
    qs[r * S::kQRow + d] =
        to_f32(q[((static_cast<size_t>(b) * C + r / G) * H + h * G + r % G) * D + d]);
  }
  // softmax state of the warp's rows warp + 4 i (every lane holds it)
  float m_run[kRowsWarp], l_run[kRowsWarp];
#pragma unroll
  for (int i = 0; i < kRowsWarp; ++i) {
    m_run[i] = kNegBig;
    l_run[i] = 0.f;
  }
  // P V: the thread's column dcol of rows rgroup + kGroups i
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kRowsPV];
#pragma unroll
  for (int i = 0; i < kRowsPV; ++i) acc[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t (and q) visible to every thread, and every thread done with
    // tile t - 1, whose stage the next load takes
    __syncthreads();
    if (t + 1 < tiles) load_tile(t + 1, (t + 1) & 1);
    const TKV* ks = ring + (t & 1) * 2 * S::kTile;
    const TKV* vs = ks + S::kTile;
    const int pos = kb + t * kSplitKeys + lane;

    float s[kRowsWarp];
#pragma unroll
    for (int i = 0; i < kRowsWarp; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 8) {
      float kf[8];
      load8(ks + lane * S::kRow + d, kf);
#pragma unroll
      for (int i = 0; i < kRowsWarp; ++i) {
        const int r = warp + i * kSplitWarps;
        if (r < R) {
          const float4 a = *reinterpret_cast<const float4*>(qs + r * S::kQRow + d);
          const float4 c = *reinterpret_cast<const float4*>(qs + r * S::kQRow + d + 4);
          float x = s[i];
          x = fmaf(a.x, kf[0], x);
          x = fmaf(a.y, kf[1], x);
          x = fmaf(a.z, kf[2], x);
          x = fmaf(a.w, kf[3], x);
          x = fmaf(c.x, kf[4], x);
          x = fmaf(c.y, kf[5], x);
          x = fmaf(c.z, kf[6], x);
          s[i] = fmaf(c.w, kf[7], x);
        }
      }
    }
    // masked scores and the online softmax, a warp a row, a lane a key
#pragma unroll
    for (int i = 0; i < kRowsWarp; ++i) {
      const int r = warp + i * kSplitWarps;
      if (r >= R) break;
      const int q_pos = start + r / G;
      const bool ok = pos >= lo && pos < ke && pos <= q_pos &&
                      (window <= 0 || pos > q_pos - window);
      float x = -INFINITY;
      if (ok) {
        x = s[i] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      }
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float p = ok ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = fmaf(alpha, l_run[i], sum);
      m_run[i] = m_new;
      pr[r * kSplitKeys + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPV; ++i) {
      const int r = rgroup + i * kGroups;
      if (r < R) acc[i] *= alpha_s[r];
    }
#pragma unroll 2
    for (int j = 0; j < kSplitKeys; j += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = to_f32(vs[(j + u) * S::kRow + dcol]);
#pragma unroll
      for (int i = 0; i < kRowsPV; ++i) {
        const int r = rgroup + i * kGroups;
        if (r < R) {
          const float4 p = *reinterpret_cast<const float4*>(pr + r * kSplitKeys + j);
          float a = fmaf(p.x, v[0], acc[i]);
          a = fmaf(p.y, v[1], a);
          a = fmaf(p.z, v[2], a);
          acc[i] = fmaf(p.w, v[3], a);
        }
      }
    }
  }
  // the merge may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  const size_t part = (static_cast<size_t>(b) * Hkv + h) * splits + split;
#pragma unroll
  for (int i = 0; i < kRowsPV; ++i) {
    const int r = rgroup + i * kGroups;
    if (r < R) part_acc[(part * R + r) * D + dcol] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsWarp; ++i) {
      const int r = warp + i * kSplitWarps;
      if (r < R) {
        part_ml[(part * R + r) * 2] = m_run[i];
        part_ml[(part * R + r) * 2 + 1] = l_run[i];
      }
    }
  }
}

// grid (ceil(C * G * D / kSplitThreads), Hkv, B): one output value a
// thread (folded row i / D, column i % D) from its row's live splits: each
// split's P V rescaled to their common max and summed in split order, so a
// call gives the same bits every time; a row with no visible key (every
// sum 0) gives 0. A programmatic dependent of the split kernel.
template <typename TQ>
__global__ void __launch_bounds__(kSplitThreads) chunked_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, const int* __restrict__ starts, TQ* __restrict__ out,
    int C, int H, int Hkv, int D, int ps, int maxp, int splits, int window) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, R = C * G;
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;
  int lo, hi, s_lo, s_hi;
  chunk_keys(lengths[b], row_start(starts, lengths, b), C, maxp * ps, window, lo, hi);
  live_splits(lo, hi, maxp * ps, splits, s_lo, s_hi);
  // wait for the split kernel to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (i >= R * D) return;
  const int r = i / D, d = i % D;
  // split s of this row: (max, sum) at ml[2 s R], P V at acc[s R D]
  const size_t row = ((static_cast<size_t>(b) * Hkv + h) * splits + s_lo) * R + r;
  const float* ml = part_ml + row * 2;
  const float* acc = part_acc + row * D + d;
  float M = -INFINITY;
  for (int s = 0; s < s_hi - s_lo; ++s) M = fmaxf(M, ml[2 * s * R]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < s_hi - s_lo; ++s) {
    const float w = expf(ml[2 * s * R] - M);
    L = fmaf(ml[2 * s * R + 1], w, L);
    a = fmaf(acc[static_cast<size_t>(s) * R * D], w, a);
  }
  out[((static_cast<size_t>(b) * C + r / G) * H + h * G + r % G) * D + d] =
      from_f32<TQ>(L > 0.f ? a / L : 0.f);
}

template <typename TQ, typename TKV, int D, int MR>
int launch_split(const TQ* q, const TKV* kp, const TKV* vp, const int* page_table,
                 const int* lengths, const int* starts, TQ* out, float* part_acc, float* part_ml,
                 int B, int C, int H, int Hkv, int ps, int maxp, int splits, float scale,
                 float softcap, int window, cudaStream_t s) {
  using S = SplitSmem<TKV, D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(chunked_split_kernel<TQ, TKV, D, MR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes(MR));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int R = C * (H / Hkv);
  chunked_split_kernel<TQ, TKV, D, MR><<<dim3(splits, Hkv, B), kSplitThreads, S::bytes(R), s>>>(
      q, kp, vp, page_table, lengths, starts, part_acc, part_ml, C, H, Hkv, ps, maxp, splits,
      scale, softcap, window);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // the merge, as a programmatic dependent: it starts while the split
  // kernel drains, hiding its launch latency
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R * D + kSplitThreads - 1) / kSplitThreads, Hkv, B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr_pdl[1];
  attr_pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr_pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr_pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, chunked_merge_kernel<TQ>,
                                             static_cast<const float*>(part_acc),
                                             static_cast<const float*>(part_ml), lengths, starts,
                                             out, C, H, Hkv, D, ps, maxp, splits, window));
}

// ------------------------------------------------------------------ mma
// grid (ceil(C * G / 64), Hkv, B); bf16 q, pool and out. The body is
// attention_mma.cuh's, with a key's K/V row found through the page table.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2) chunked_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    __nv_bfloat16* __restrict__ out, int C, int H, int Hkv, int ps, int maxp, float scale,
    float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int* pages = page_table + static_cast<size_t>(b) * maxp;
  auto kv_row = [&](int pos) {
    return ((static_cast<size_t>(pages[pos / ps]) * ps + pos % ps) * Hkv + h) * D;
  };
  mma_attention_block<D, true>(q, kp, vp, out, b, h, blockIdx.x * kMmaRows, C, H, H / Hkv,
                               starts[b], min(lengths[b], maxp * ps), scale, softcap, window,
                               kv_row, smem);
}

template <int D>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
               const int* page_table, const int* lengths, const int* starts,
               __nv_bfloat16* out, int B, int C, int H, int Hkv, int ps, int maxp, float scale,
               float softcap, int window, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunked_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int R = C * (H / Hkv);
  chunked_mma_kernel<D><<<dim3((R + kMmaRows - 1) / kMmaRows, Hkv, B), kMmaThreads,
                          mma_smem<D>(), s>>>(q, kp, vp, page_table, lengths, starts, out, C, H,
                                              Hkv, ps, maxp, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

enum Path : int { kTiled = 0, kSplit = 1, kMma = 2 };

template <typename TQ, typename TKV, int D>
int launch_path(int path, int splits, const void* q, const void* kp, const void* vp,
                const void* page_table, const void* lengths, const void* starts, void* out,
                void* part_acc, void* part_ml, int B, int C, int H, int Hkv, int ps, int maxp,
                float scale, float softcap, int window, cudaStream_t s) {
  const auto* qt = static_cast<const TQ*>(q);
  const auto* kt = static_cast<const TKV*>(kp);
  const auto* vt = static_cast<const TKV*>(vp);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* ln = static_cast<const int*>(lengths);
  const auto* st = static_cast<const int*>(starts);
  auto* ot = static_cast<TQ*>(out);
  const int R = C * (H / Hkv);
  switch (path) {
    case kTiled:
      return launch<TQ, TKV, D>(q, kp, vp, page_table, lengths, starts, out, B, C, H, Hkv, ps,
                                maxp, scale, softcap, window, s);
    case kSplit: {
      if (splits < 1 || splits > split_units(maxp * ps) || part_acc == nullptr ||
          part_ml == nullptr)
        return -1;
      auto* acc = static_cast<float*>(part_acc);
      auto* ml = static_cast<float*>(part_ml);
      if (R <= 4)
        return launch_split<TQ, TKV, D, 4>(qt, kt, vt, pt, ln, st, ot, acc, ml, B, C, H, Hkv,
                                           ps, maxp, splits, scale, softcap, window, s);
      if (R <= 16)   // row classes: predicated-off rows still cost issue slots
        return launch_split<TQ, TKV, D, 16>(qt, kt, vt, pt, ln, st, ot, acc, ml, B, C, H, Hkv,
                                            ps, maxp, splits, scale, softcap, window, s);
      if (R <= kSplitMaxRows)
        return launch_split<TQ, TKV, D, kSplitMaxRows>(qt, kt, vt, pt, ln, st, ot, acc, ml, B,
                                                       C, H, Hkv, ps, maxp, splits, scale,
                                                       softcap, window, s);
      return -1;
    }
    case kMma:
      if constexpr (std::is_same_v<TQ, __nv_bfloat16> && std::is_same_v<TKV, __nv_bfloat16>)
        return launch_mma<D>(qt, kt, vt, pt, ln, st, ot, B, C, H, Hkv, ps, maxp, scale, softcap,
                             window, s);
      return -1;
    default:
      return -1;
  }
}

}  // namespace

// The constants the wrapper's plan mirrors, in this order: the split
// kernel's key tile and most folded rows, the mma kernel's folded rows and
// key tile, the tiled kernel's folded rows.
extern "C" void chunked_prefill_constants(int* c) {
  c[0] = kSplitKeys;
  c[1] = kSplitMaxRows;
  c[2] = kMmaRows;
  c[3] = kMmaKeys;
  c[4] = kRows;
}

// Returns the CUDA error of the launches (0 on success), -1 for a path,
// dtype, head dim or split count the kernels do not take. path: 0 tiled, 1
// split (its merge follows on the stream), 2 mma (bf16 only). Layouts: q /
// out (B, C, H, D); k / v pools (P, ps, Hkv, D); page_table (B, maxp)
// int32; lengths, starts (B,) int32 (split: starts may be null, the decode
// mode of row_start); split: part_acc (B, Hkv, splits, C*H/Hkv, D) and
// part_ml (B, Hkv, splits, C*H/Hkv, 2) fp32 scratch, null otherwise; all
// contiguous, q and the pools 16-byte aligned on the split and mma paths.
extern "C" int chunked_prefill_launch(int path, int splits, const void* q, const void* kp,
                                      const void* vp, const void* page_table,
                                      const void* lengths, const void* starts, void* out,
                                      void* part_acc, void* part_ml, int B, int C, int H,
                                      int Hkv, int D, int ps, int maxp, float scale,
                                      float softcap, int window, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (starts == nullptr && path != kSplit)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(q_dtype, [&](auto tq) {
    using TQ = std::remove_pointer_t<decltype(tq)>;
    return dispatch_dtype(kv_dtype, [&](auto tkv) {
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      switch (D) {
        case 16:
          return launch_path<TQ, TKV, 16>(path, splits, q, kp, vp, page_table, lengths, starts,
                                          out, part_acc, part_ml, B, C, H, Hkv, ps, maxp, scale,
                                          softcap, window, s);
        case 128:
          return launch_path<TQ, TKV, 128>(path, splits, q, kp, vp, page_table, lengths, starts,
                                           out, part_acc, part_ml, B, C, H, Hkv, ps, maxp, scale,
                                           softcap, window, s);
        default: return -1;
      }
    });
  });
}
