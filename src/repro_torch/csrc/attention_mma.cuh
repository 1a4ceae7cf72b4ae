// The tensor-core attention body shared by chunked paged attention
// (chunked_prefill.cu, its mma path) and flash attention
// (flash_attention.cu, its mma path): FA2 on mma.sync.m16n8k16 for bf16
// queries, keys and values, fp32 softmax and accumulation, bf16 out.
//
// A block takes 64 folded query rows r = s * G + g (token s, query head g of
// KV head h's group of G), so one staged K/V tile serves every query head of
// its KV head; 16 rows a warp, the Q fragment in registers. It walks the
// 64-key tiles that its rows can see (mma_key_tiles) through a cp.async
// double buffer, zero-filling keys outside them (0 x NaN would poison P V),
// computes S = Q K^T from a zero accumulator, applies scale, softcap and the
// mask in registers, runs the online softmax with quad shuffles, and adds
// each tile's P V, summed from zero, to the fp32 accumulator after the
// rescale. Scores are kept in log2 units, so each probability is one
// ex2.approx (expf's range reduction took ~18% of the kernel's time at the
// prefill shapes). P enters the tensor cores as truncated hi + lo bf16
// parts (two products, within 2^-14 of P): P rounded once to bf16 is off by
// up to 2^-9 of itself, as much as a bf16 step of an output near 2-4, so
// outputs would land a step from the fp32 plain version's. mma.sync
// truncates as it adds, so one chain over the whole walk would drift: hence
// the per-tile sums.
//
// The callers differ only in where a key's K/V row lies (a slot of a page
// of the pool, or a dense (b, pos, h) row: the kv_row functor), where the
// keys end (a row's length, or Skv), and whether the mask is causal.
#pragma once

#include "gemm_common.cuh"   // cp_async16, ldmatrix_x4[_trans], mma_bf16[_zero], split_pair

namespace {

constexpr float kNegBig = -1.0e30f;
constexpr int kMmaThreads = 128;   // 4 warps, 16 folded rows each
constexpr int kMmaRows = 64;       // folded query rows a block
constexpr int kMmaKeys = 64;       // keys a staged tile
constexpr int kMmaPad = 8;         // bf16 padding a staged row: ldmatrix rows on distinct banks

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit (ex2.approx: 2 ulp; +0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cap * tanh(x / cap) = cap - 2 cap / (e^(2x / cap) + 1): one ex2 and one
// reciprocal (tanhf's ~20 instructions a score set the softcap case's
// time); within ~1e-6 cap of it, -cap and cap at the ends
__device__ __forceinline__ float soft_cap(float x, float cap, float two_log2e_over_cap) {
  return cap - __fdividef(2.f * cap, ex2(x * two_log2e_over_cap) + 1.f);
}

// the q tile, then 2 stages of K and V tiles, bf16
template <int D>
__host__ __device__ constexpr int mma_smem() {
  return (kMmaRows + 4 * kMmaKeys) * (D + kMmaPad) * 2;
}

// The keys [kv_lo, kv_hi) of [0, kv_end) that some query at positions q_lo
// .. q_hi can see (up to the last one's position when causal, from the first
// one's window on), and the kMmaKeys tiles [t0, t0 + tiles) that hold them
// (the flash wrapper's key_tiles mirrors it).
__device__ __forceinline__ void mma_key_tiles(int q_lo, int q_hi, int kv_end, bool causal,
                                              int window, int& kv_lo, int& kv_hi, int& t0,
                                              int& tiles) {
  kv_hi = max(causal ? min(kv_end, q_hi + 1) : kv_end, 0);
  kv_lo = window > 0 ? max(q_lo - window + 1, 0) : 0;
  t0 = kv_lo / kMmaKeys;
  tiles = kv_hi > kv_lo ? (kv_hi + kMmaKeys - 1) / kMmaKeys - t0 : 0;
}

// One block's 64 folded rows r0 .. of KV head h in batch row b. q and out
// are (B, C, H, D) with H = Hkv * G; query token c sits at position pos0 + c;
// keys [0, kv_end) exist, key pos's K and V rows start at element
// kv_row(pos) of kp and vp. smem holds mma_smem<D>() bytes.
template <int D, bool kCausal, typename KvRow>
__device__ __forceinline__ void mma_attention_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, __nv_bfloat16* __restrict__ out, int b, int h,
    int r0, int C, int H, int G, int pos0, int kv_end, float scale, float softcap, int window,
    KvRow kv_row, unsigned char* smem) {
  constexpr int kRow = D + kMmaPad;       // elements a staged row
  constexpr int kChunks = D / 8;          // 16-byte chunks a row
  constexpr int kKSteps = D / 16;         // k16 steps of Q K^T
  constexpr int kNT = D / 8;              // n8 tiles of the output
  static_assert(D % 16 == 0 && kMmaRows * kChunks % kMmaThreads == 0, "head_dim");
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [row][kRow]
  __nv_bfloat16* ks = qs + kMmaRows * kRow;            // [stage][key][kRow]
  __nv_bfloat16* vs = ks + 2 * kMmaKeys * kRow;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = C * G;
  const int q_lo = pos0 + r0 / G, q_hi = pos0 + (min(r0 + kMmaRows, R) - 1) / G;
  int kv_lo, kv_hi, t0, tiles;
  mma_key_tiles(q_lo, q_hi, kv_end, kCausal, window, kv_lo, kv_hi, t0, tiles);
  // scores in log2 units, so that each probability is one ex2
  const float scale_log2 = scale * kLog2e, cap_in = softcap > 0.f ? 2.f * kLog2e / softcap : 0.f;
  auto score = [&](float x) {
    return softcap > 0.f ? soft_cap(x * scale, softcap, cap_in) * kLog2e : x * scale_log2;
  };

  // stage key tile t0 + t in buffer buf, zero-filled outside [kv_lo, kv_hi)
  auto load_kv = [&](int t, int buf) {
    const int base = (t0 + t) * kMmaKeys;
#pragma unroll
    for (int u = 0; u < kMmaKeys * kChunks / kMmaThreads; ++u) {
      const int i = tid + u * kMmaThreads;
      const int j = i / kChunks, c = i % kChunks * 8;
      const int pos = base + j;
      const bool ok = pos >= kv_lo && pos < kv_hi;
      const size_t off = ok ? kv_row(pos) + c : 0;
      cp_async16(ks + (buf * kMmaKeys + j) * kRow + c, kp + off, ok ? 16 : 0);
      cp_async16(vs + (buf * kMmaKeys + j) * kRow + c, vp + off, ok ? 16 : 0);
    }
  };

  if (tiles > 0) {
#pragma unroll
    for (int u = 0; u < kMmaRows * kChunks / kMmaThreads; ++u) {
      const int i = tid + u * kMmaThreads;
      const int row = i / kChunks, c = i % kChunks * 8;
      const int r = r0 + row;
      const bool ok = r < R;
      const __nv_bfloat16* src =
          ok ? q + ((static_cast<size_t>(b) * C + r / G) * H + h * G + r % G) * D + c : q;
      cp_async16(qs + row * kRow + c, src, ok ? 16 : 0);
    }
    load_kv(0, 0);
  }
  cp_async_commit();

  // the thread's rows of the tile: wrow and wrow + 8 (accumulator fragment
  // rows lane / 4 and lane / 4 + 8 of its warp's 16)
  const int wrow = warp * 16 + lane / 4;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = pos0 + (r0 + wrow + 8 * hh) / G;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[n][v] = 0.f;
  float m_r[2] = {kNegBig, kNegBig}, l_r[2] = {0.f, 0.f};   // l: this thread's columns
  unsigned qa[kKSteps][4];

  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t (and q) visible to every thread, and every warp done with
    // tile t - 1, whose buffer the next load takes
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + lane % 16) * kRow + kk * 16 + lane / 16 * 8);
    }
    if (t + 1 < tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (t & 1) * kMmaKeys * kRow;
    const __nv_bfloat16* vt = vs + (t & 1) * kMmaKeys * kRow;

    // S = Q K^T: 16 rows x 64 keys a warp, from a zero accumulator. B
    // fragments of two n8 tiles from K [key][d]: matrices (keys 0-7 | 8-15)
    // x (d 0-7 | 8-15) of the k16 step, rows addressed by lanes
    float s[8][4];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, kt + (np * 16 + lane / 16 * 8 + lane % 8) * kRow + kk * 16 +
                           lane / 8 % 2 * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        if (kk == 0) {
          mma_bf16_zero(s[2 * np], qa[kk], b0);
          mma_bf16_zero(s[2 * np + 1], qa[kk], b1);
        } else {
          mma_bf16(s[2 * np], qa[kk], b0);
          mma_bf16(s[2 * np + 1], qa[kk], b1);
        }
      }

    // scale, softcap and mask in registers; -inf marks a masked pair.
    // Fragment (n8 tile nt, v): row wrow + 8 (v / 2), key 8 nt + 2 (lane % 4) + v % 2
    const int kbase = (t0 + t) * kMmaKeys + 2 * (lane % 4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pos = kbase + nt * 8 + (v & 1), hh = v >> 1;
        const bool ok = pos < kv_hi && (!kCausal || pos <= qpos[hh]) &&
                        (window <= 0 || pos > qpos[hh] - window);
        s[nt][v] = ok ? score(s[nt][v]) : -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[nt][v]);
      }
    // online softmax (log2 units): a row's 64 scores lie on the 4 lanes of
    // a quad; a masked score gives ex2(-inf) = 0
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 2));
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      alpha[hh] = ex2(m_r[hh] - m_new);
      m_r[hh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        s[nt][v] = ex2(s[nt][v] - m_r[v >> 1]);
        rs[v >> 1] += s[nt][v];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = fmaf(alpha[hh], l_r[hh], rs[hh]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P as the A operand of 4 k16 steps (keys 16 j ..), hi + lo bf16 parts:
    // the S fragments of n8 tiles 2j and 2j + 1 are exactly A's registers
    unsigned ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_pair(s[2 * j][0], s[2 * j][1], ph[j][0], pl[j][0]);
      split_pair(s[2 * j][2], s[2 * j][3], ph[j][1], pl[j][1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], ph[j][2], pl[j][2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], ph[j][3], pl[j][3]);
    }
    // P V, 16 columns of d at a time, summed from zero over the tile (lo
    // parts first) and added to o in fp32
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      float d0[4], d1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B fragments of two n8 tiles from V [key][d], transposed by
        // ldmatrix: matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15)
        unsigned r[4];
        ldmatrix_x4_trans(r, vt + (j * 16 + lane / 8 % 2 * 8 + lane % 8) * kRow + dp * 16 +
                                 lane / 16 * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        if (j == 0) {
          mma_bf16_zero(d0, pl[j], b0);
          mma_bf16_zero(d1, pl[j], b1);
        } else {
          mma_bf16(d0, pl[j], b0);
          mma_bf16(d1, pl[j], b1);
        }
        mma_bf16(d0, ph[j], b0);
        mma_bf16(d1, ph[j], b1);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        o[2 * dp][v] += d0[v];
        o[2 * dp + 1][v] += d1[v];
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float L = l_r[hh];
    L += __shfl_xor_sync(~0u, L, 1);
    L += __shfl_xor_sync(~0u, L, 2);
    const int r = r0 + wrow + 8 * hh;
    if (r >= R) continue;
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * C + r / G) * H + h * G + r % G) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float v0 = L > 0.f ? o[n][2 * hh] / L : 0.f;
      const float v1 = L > 0.f ? o[n][2 * hh + 1] / L : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace
