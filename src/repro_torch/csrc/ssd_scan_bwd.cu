// Mamba2 SSD chunk scan backward on Hopper (sm_90a): the gradients of
// ssd_scan.cu's (y, final state) with respect to x, dt, A, B, C and the
// initial state, for the training path (LM.loss under autograd through
// kernels/ssd_scan/ops.py's SSDScan).
//
// Differentiates the TPU kernel src/repro/kernels/ssd_scan/kernel.py,
// ssd_scan_pallas, which has no backward of its own: the reference trains
// through the plain-jnp ssd_chunked (src/repro/models/mamba.py) and takes
// this gradient by XLA autodiff. The formulas (kernels/ssd_scan/ref.py's
// ssd_reference_bwd computes the same ones in plain PyTorch), per 64-token
// tile of one (row, head), with a_i the inclusive cumulative sum of dt A in
// the tile, L_ij = e^{a_i - a_j} for j <= i (else 0), S the state entering
// the tile, dS' the gradient flowing into its exit state, D_ij = dy_i . x_j:
//   dx_j  = dt_j sum_{i>=j} (C_i.B_j) L_ij dy_i + dt_j e^{a_Q-a_j} dS' B_j
//   dC_i  = sum_{j<=i} L_ij dt_j D_ij B_j + e^{a_i} S^T dy_i
//   dB_j  = dt_j sum_{i>=j} L_ij D_ij C_i + dt_j e^{a_Q-a_j} dS'^T x_j
//   da_i  = sum_j R_ij - sum_k R_ki + e^{a_i} dy_i.(S C_i) - s_i, where
//           R_ij = (C_i.B_j) L_ij dt_j D_ij, s_j = dt_j e^{a_Q-a_j} x_j^T dS' B_j,
//           and da_Q (the tile's last) also gains sum_j s_j + e^{a_Q} <dS', S>
//   ddt_j = sum_{i>=j} (C_i.B_j) L_ij D_ij + e^{a_Q-a_j} x_j^T dS' B_j
//           + A sum_{i>=j} da_i;     dA += sum_j dt_j sum_{i>=j} da_i
//   dS' of the tile before = e^{a_Q} dS' + sum_i e^{a_i} dy_i (x) C_i,
// and after the first tile dS' is d(init_state). Every exponent is <= 0.
// The entry states S come from the forward, which writes them when the op
// needs a gradient (65 MB a layer at mamba2's training shape).
//
// What bounds it on the card: at mamba2's training shape (4 x 512 tokens,
// 64 heads, P 64, N 128, bf16) the bytes (the tiles' entry states, dy, x and
// dx: 0.041 ms at 3.35 TB/s) and the ~13 GFLOP of products (~27 GFLOP of
// tensor-core work with the hi + lo parts below, ~0.03 ms at the bf16 peak)
// are close; what sets its time (~0.26 ms, the mma path) is latency: each
// block walks its 8 tiles in order, and a tile's phases depend on each
// other.
//
// kernels/ssd_scan/kernel.py's bwd_plan picks one of two kernels:
//
//  - mma (bf16 x, B and C): mma.sync.m16n8k16 tiles, fp32 accumulation. A
//    block takes hb = 1, 2 or 4 heads of one group (4 warps a head: 8 warps
//    a SM at mamba2's hb 2, 16 at jamba's hb 4, one block a SM), grid (H /
//    hb, B); the plan takes the widest hb whose grid still puts a block on
//    3/4 of the SMs and whose block fits (hb 4 at N 128 would need 320 KB).
//    The heads share the tile's B and C and, where a head's warps need it,
//    C B^T. Every fp32 operand of a product enters as hi + lo bf16 parts,
//    each rounded to nearest (dy, the entry state S, dS', G, the head sum
//    of M2, 2^cum dy), x, B and C as they are: an fp32 x bf16 product is two
//    MMAs (lo then hi), an fp32 x fp32 one three (lo hi, hi lo, hi hi), each
//    summed from zero over the tile and added in fp32 (mma.sync truncates as
//    it accumulates); the hi parts alone miss the 1e-4 gate by ~30x
//    (tests/test_torch_ssd_bwd_plan.py's emulation). Per tile, last to first:
//      stage B, C and x (cp.async), dy and S as hi + lo parts, dt and its
//        scan in log2 units;
//      (1) warp (w, k), head k, rows i of 16-row tile w against keys j <= i
//          (key tiles above the diagonal skipped): C B^T, D = dy x^T, then
//          G = C B^T o L, M2 = L dt_j D, the row sums of R = G dt_j D and
//          the column partials of G o D; M2 summed over the block's heads
//          in head order (named barriers of row tile w) and staged as hi +
//          lo parts;
//      (2) warp (w, k), rows j against queries i >= j: G^T = (B C^T) o L^T
//          in registers, then G^T dy (three products), its A fragments made
//          from the accumulator fragments;
//      (3) warp (w, c), rows i, chunk c of N: dC = M2sum B + sum over heads
//          of 2^cum V, V = dy S: the head sum of dB and dC becomes part of
//          each product's reduction, so the partials are (H / G / hb, B, L,
//          G, N) (half the bytes of per-head partials at mamba2), summed
//          over the group's blocks by gemm_common.cuh's split reduce,
//          launched as a programmatic dependent; the partials C . V and
//          <dS', S>;
//      then dS' (P x N fp32, in accumulator registers of the head's 4 warps
//      across tiles, 64 a thread at N 128) is staged over S as hi + lo;
//      (4) warp (w, k): U = B dS'^T, dx = dt (2^(cum_Q - cum) U + G^T dy);
//      (5) warp (w, c): dB = M2sum^T C + sum over heads of dt 2^(cum_Q -
//          cum) (x dS');
//      (6) warp (w, k): dS' <- 2^cum_Q dS' + (2^cum dy)^T C;
//      then da, its suffix sums, ddt and dA, warp (0, k) for head k.
//    dS' of a tile waits for the tile after it, so the walk is serial. No
//    atomics: every cross-thread sum has a fixed order, repeats are
//    bit-equal. -Xptxas -v: at P 64 / N 128 (hb 2, nk 8) 255 registers,
//    20 bytes of spill stores, 202304 bytes of shared memory, 8 warps a SM;
//    at P 64 / N 16 (hb 4, nk 1) 128 registers (the cap at 512 threads),
//    344 bytes of spill stores, 192640 bytes, 16 warps a SM. What holds it
//    (chip_tune.py ssdbwd at mamba2's shape): one block takes ~50k cycles
//    a tile; staging the tile is its longest phase, then dC (with V = dy
//    S), dB, C B^T and D, G^T dy; the kernel runs 14% faster without the
//    S loads and 7% without dy's (probes, outputs wrong). A row start of
//    x, B or C that is not 16 bytes aligned (P or N not a multiple of 8,
//    or an odd stride) is staged with 2-byte loads.
//  - tiled (fp32: it stays IEEE fp32 on the CUDA cores), the backward's
//    first kernel, as it was: one block of 256 threads a (row, head),
//    walking its tiles last to first with dS' (P x N, fp32) in shared
//    memory. A tile's x, dy, B, C (transposed, and dy also by rows) and
//    its three 64 x 64 matrices (C.B^T L, and L dt D in both orientations)
//    sit in shared memory, at most 221 KB (P 64, N 128): one block a SM. Each product gives a thread
//    a 4 x 4 or 4 x 8 tile of its output, one operand read as float4 along
//    the threads, the other as a broadcast. Sums across threads go through
//    per-row partials in shared memory added in a fixed order, and shuffles
//    in a fixed pattern. dB and dC come out per head as fp32 partials (B,
//    L, H, N).
//
// Both read B and C per group (head h reads group h / (H / G)) with the
// forward's row strides; the wrapper sums the dB / dC partials over each
// group's blocks in head order and dA (per row and head) over rows. Tokens
// past L load as zeros with dt = 0 and get no gradient written.

#include "gemm_common.cuh"   // cp_async16, ldmatrix_x4[_trans], mma_bf16, ex2, split_rn

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // tokens per tile, as the forward's
constexpr int kTP = kT + 4;  // row of the transposed and 64 x 64 tiles (16-byte aligned)
constexpr int kR = 16;       // rows of threads (tid / 16): the partials summed in order
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

struct Dims {
  int L, H, P, N, G, PP, NP, NS;  // P, N rounded up to 4 and 8; NS = NP + 4, dS''s row
  long long sxb, sxt, sbb, sbt, scb, sct;
};

// xT [PP][kTP], dyT [PP][kTP], dyr [kT][PP], bT [NP][kTP], cT [NP][kTP],
// dsp [PP][NS], gm / m2 / m2t [kT][kTP], three [kR][kT] partials, then
// cum, ecum, w, dts, rowr, colgd, xu, yoff [kT] and 16 scalars
__host__ __device__ inline int smem_floats(int PP, int NP) {
  return 2 * PP * kTP + kT * PP + 2 * NP * kTP + PP * (NP + 4) + 3 * kT * kTP + 3 * kR * kT +
         8 * kT + 16;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the sum over the 16 lanes of a half-warp (lanes tid / 16 equal), in a
// fixed pattern
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states,
    const float* __restrict__ dy, const float* __restrict__ d_final, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dA_part, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ d_init, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int PP = d.PP, NP = d.NP, NS = d.NS;
  float* xT = smem;
  float* dyT = xT + PP * kTP;
  float* dyr = dyT + PP * kTP;
  float* bT = dyr + kT * PP;
  float* cT = bT + NP * kTP;
  float* dsp = cT + NP * kTP;
  float* gm = dsp + PP * NS;     // gm[i][j] = (C_i.B_j) L_ij
  float* m2 = gm + kT * kTP;     // m2[i][j] = L_ij dt_j D_ij
  float* m2t = m2 + kT * kTP;    // m2t[j][i] = m2[i][j]
  float* red0 = m2t + kT * kTP;  // [kR][kT] partials: column sums of G o D
  float* red1 = red0 + kR * kT;  //   x_j . dS' B_j
  float* red2 = red1 + kR * kT;  //   C_i . S^T dy_i
  float* cum = red2 + kR * kT;
  float* ecum = cum + kT;
  float* w = ecum + kT;
  float* dts = w + kT;
  float* rowr = dts + kT;        // sum_j R_ij
  float* colgd = rowr + kT;      // sum_i G_ij D_ij
  float* xu = colgd + kT;        // x_j . dS' B_j
  float* yoff = xu + kT;         // e^{a_i} C_i . S^T dy_i
  float* scal = yoff + kT;       // [0] e^{a_Q}, [8..15] per-warp sums of <dS', S>

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = d.H, P = d.P, N = d.N, L = d.L;
  const int g = h / (H / d.G);
  const float a = A[h];
  const T* xrow = x + b * d.sxb + static_cast<long long>(h) * P;
  const T* brow = Bm + b * d.sbb + static_cast<long long>(g) * N;
  const T* crow = Cm + b * d.scb + static_cast<long long>(g) * N;
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N;
  const int tiles = (L + kT - 1) / kT;
  const int r = tid / 16, c = tid % 16, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < PP * NS; i += kThreads) {
    const int p = i / NS, n = i % NS;
    dsp[i] = (d_final != nullptr && p < P && n < N) ? d_final[st_off + p * N + n] : 0.f;
  }
  float dA_acc = 0.f;  // thread 0's sum over the tiles, last tile first

  for (int t = tiles - 1; t >= 0; --t) {
    const int t0 = t * kT, nt = min(kT, L - t0);
    const float* S = states + ((static_cast<size_t>(b) * tiles + t) * H + h) * P * N;
    __syncthreads();  // the previous tile's readers are done, dS' is updated
    for (int i = tid; i < kT * PP; i += kThreads) {
      const int j = i / PP, p = i % PP;
      const bool live = j < nt && p < P;
      const float xv = live ? to_f32(xrow[(t0 + j) * d.sxt + p]) : 0.f;
      const float dv = live ? dy[((static_cast<size_t>(b) * L + t0 + j) * H + h) * P + p] : 0.f;
      xT[p * kTP + j] = xv;
      dyT[p * kTP + j] = dv;
      dyr[j * PP + p] = dv;
    }
    for (int i = tid; i < kT * NP; i += kThreads) {
      const int j = i / NP, n = i % NP;
      const bool live = j < nt && n < N;
      bT[n * kTP + j] = live ? to_f32(brow[(t0 + j) * d.sbt + n]) : 0.f;
      cT[n * kTP + j] = live ? to_f32(crow[(t0 + j) * d.sct + n]) : 0.f;
    }
    if (tid < kT) dts[tid] = tid < nt ? dt[(static_cast<size_t>(b) * L + t0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive scan of dt*A: two tokens a lane, then across lanes
      const float a0 = dts[2 * tid] * a;
      const float a1 = a0 + dts[2 * tid + 1] * a;
      float s = a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(~0u, s, o);
        if (tid >= o) s += v;
      }
      float excl = __shfl_up_sync(~0u, s, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = excl + a1, last = __shfl_sync(~0u, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      w[2 * tid] = expf(last - c0);
      w[2 * tid + 1] = expf(last - c1);
      if (tid == 0) scal[0] = expf(last);
    }
    __syncthreads();

    // (A) rows i = 4r.., columns j = 4c..: C.B^T and D = dy x^T, then
    // G = C.B^T L, M2 = L dt_j D and the row and column sums of G o D
    {
      float cb[4][4] = {}, dd[4][4] = {};
      if (c <= r) {  // blocks above the diagonal are zero
        for (int n = 0; n < NP; ++n) {
          const float4 c4 = ld4(cT + n * kTP + 4 * r), b4 = ld4(bT + n * kTP + 4 * c);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) cb[u][v] = fmaf(cv[u], bv[v], cb[u][v]);
        }
        for (int p = 0; p < PP; ++p) {
          const float4 y4 = ld4(dyT + p * kTP + 4 * r), x4 = ld4(xT + p * kTP + 4 * c);
          const float yv[4] = {y4.x, y4.y, y4.z, y4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) dd[u][v] = fmaf(yv[u], xv[v], dd[u][v]);
        }
      }
      float colp[4] = {};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * r + u;
        float gv[4], mv[4], rowp = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = 4 * c + v;
          const float lm = j <= i ? expf(cum[i] - cum[j]) : 0.f;
          gv[v] = cb[u][v] * lm;
          mv[v] = lm * dts[j] * dd[u][v];
          const float gd = gv[v] * dd[u][v];
          rowp = fmaf(gd, dts[j], rowp);
          colp[v] += gd;
          m2t[j * kTP + i] = mv[v];
        }
        *reinterpret_cast<float4*>(gm + i * kTP + 4 * c) = make_float4(gv[0], gv[1], gv[2], gv[3]);
        *reinterpret_cast<float4*>(m2 + i * kTP + 4 * c) = make_float4(mv[0], mv[1], mv[2], mv[3]);
        rowp = half_warp_sum(rowp);
        if (c == 0) rowr[i] = rowp;
      }
      *reinterpret_cast<float4*>(red0 + r * kT + 4 * c) =
          make_float4(colp[0], colp[1], colp[2], colp[3]);
    }
    __syncthreads();

    // (B) dx for columns p = 4r.., tokens j = 4c..: sum_{i>=j} G_ij dy_i[p]
    // and U_j[p] = (dS' B_j)[p]; the partial x_j . U_j over the 4 columns
    if (4 * r < PP) {
      float acc[4][4] = {}, us[4][4] = {};
      for (int i = 4 * c; i < kT; i += 4) {
        float4 yv[4], gv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = ld4(dyT + (4 * r + u) * kTP + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) gv[k] = ld4(gm + (i + k) * kTP + 4 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float yk[4] = {yv[u].x, yv[u].y, yv[u].z, yv[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[u][0] = fmaf(yk[k], gv[k].x, acc[u][0]);
            acc[u][1] = fmaf(yk[k], gv[k].y, acc[u][1]);
            acc[u][2] = fmaf(yk[k], gv[k].z, acc[u][2]);
            acc[u][3] = fmaf(yk[k], gv[k].w, acc[u][3]);
          }
        }
      }
      for (int n = 0; n < NP; n += 4) {
        float4 sv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = ld4(dsp + (4 * r + u) * NS + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = ld4(bT + (n + k) * kTP + 4 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float sk[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            us[u][0] = fmaf(sk[k], bv[k].x, us[u][0]);
            us[u][1] = fmaf(sk[k], bv[k].y, us[u][1]);
            us[u][2] = fmaf(sk[k], bv[k].z, us[u][2]);
            us[u][3] = fmaf(sk[k], bv[k].w, us[u][3]);
          }
        }
      }
      float xup[4] = {};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = 4 * c + v;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = 4 * r + u;
          xup[v] = fmaf(xT[p * kTP + j], us[u][v], xup[v]);
          if (dx != nullptr && j < nt && p < P)
            dx[((static_cast<size_t>(b) * L + t0 + j) * H + h) * P + p] =
                from_f32<T>(dts[j] * fmaf(w[j], us[u][v], acc[u][v]));
        }
      }
      *reinterpret_cast<float4*>(red1 + r * kT + 4 * c) =
          make_float4(xup[0], xup[1], xup[2], xup[3]);
    }

    // (C) dC for tokens i = 4c.., state columns n = 8r..: sum_{j<=i} M2_ij B_j
    // and V_i = S^T dy_i (S from the forward's buffer); the partial C_i . V_i
    if (8 * r < NP) {
      float acc[4][8] = {}, vs[4][8] = {};
      for (int j = 0; j < 4 * c + 4; j += 4) {
        float4 mv[4], bv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k] = ld4(m2t + (j + k) * kTP + 4 * c);
#pragma unroll
        for (int u = 0; u < 8; ++u) bv[u] = ld4(bT + (8 * r + u) * kTP + j);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float bk[4] = {bv[u].x, bv[u].y, bv[u].z, bv[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[0][u] = fmaf(mv[k].x, bk[k], acc[0][u]);
            acc[1][u] = fmaf(mv[k].y, bk[k], acc[1][u]);
            acc[2][u] = fmaf(mv[k].z, bk[k], acc[2][u]);
            acc[3][u] = fmaf(mv[k].w, bk[k], acc[3][u]);
          }
        }
      }
      for (int p = 0; p < P; ++p) {
        const float4 y4 = ld4(dyT + p * kTP + 4 * c);
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int n = 8 * r + u;
          const float sv = n < N ? __ldg(S + p * N + n) : 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) vs[v][u] = fmaf(yv[v], sv, vs[v][u]);
        }
      }
      float cvp[4] = {};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * c + v;
        const float e = ecum[i];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int n = 8 * r + u;
          cvp[v] = fmaf(cT[n * kTP + i], vs[v][u], cvp[v]);
          if (dC_part != nullptr && i < nt && n < N)
            dC_part[((static_cast<size_t>(b) * L + t0 + i) * H + h) * N + n] =
                fmaf(e, vs[v][u], acc[v][u]);
        }
      }
      *reinterpret_cast<float4*>(red2 + r * kT + 4 * c) =
          make_float4(cvp[0], cvp[1], cvp[2], cvp[3]);
    }

    // (D) dB for tokens j = 4c.., state columns n = 8r..: sum_{i>=j} M2_ij C_i
    // and dt_j e^{a_Q-a_j} dS'^T x_j
    if (8 * r < NP && dB_part != nullptr) {
      float acc[4][8] = {}, ws[4][8] = {};
      for (int i = 4 * c; i < kT; i += 4) {
        float4 mv[4], cv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k] = ld4(m2 + (i + k) * kTP + 4 * c);
#pragma unroll
        for (int u = 0; u < 8; ++u) cv[u] = ld4(cT + (8 * r + u) * kTP + i);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float ck[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[0][u] = fmaf(mv[k].x, ck[k], acc[0][u]);
            acc[1][u] = fmaf(mv[k].y, ck[k], acc[1][u]);
            acc[2][u] = fmaf(mv[k].z, ck[k], acc[2][u]);
            acc[3][u] = fmaf(mv[k].w, ck[k], acc[3][u]);
          }
        }
      }
      for (int p = 0; p < PP; ++p) {
        const float4 x4 = ld4(xT + p * kTP + 4 * c);
        const float4 s0 = ld4(dsp + p * NS + 8 * r), s1 = ld4(dsp + p * NS + 8 * r + 4);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 8; ++u) ws[v][u] = fmaf(xv[v], sv[u], ws[v][u]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = 4 * c + v;
        if (j >= nt) continue;
        const float f = dts[j] * w[j];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int n = 8 * r + u;
          if (n < N)
            dB_part[((static_cast<size_t>(b) * L + t0 + j) * H + h) * N + n] =
                fmaf(f, ws[v][u], acc[v][u]);
        }
      }
    }
    __syncthreads();  // the partials are written; every reader of dS' is done

    if (tid < kT) {  // the partials summed over the rows of threads, in order
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < kR; ++k) s0 += red0[k * kT + tid];
      for (int k = 0; k < (PP + 3) / 4; ++k) s1 += red1[k * kT + tid];
      for (int k = 0; k < NP / 8; ++k) s2 += red2[k * kT + tid];
      colgd[tid] = s0;
      xu[tid] = s1;
      yoff[tid] = ecum[tid] * s2;
    }

    // (E) <dS', S>, then dS' <- e^{a_Q} dS' + sum_i e^{a_i} dy_i (x) C_i for
    // columns p = 4c.., state columns n = 8r.. (each thread its own entries)
    {
      float dot = 0.f;
      if (4 * c < PP && 8 * r < NP) {
        float acc[4][8] = {};
        for (int i = 0; i < kT; i += 4) {
          float4 yv[4], cv[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            yv[k] = ld4(dyr + (i + k) * PP + 4 * c);
            const float e = ecum[i + k];
            yv[k].x *= e;
            yv[k].y *= e;
            yv[k].z *= e;
            yv[k].w *= e;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) cv[u] = ld4(cT + (8 * r + u) * kTP + i);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float ck[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[0][u] = fmaf(yv[k].x, ck[k], acc[0][u]);
              acc[1][u] = fmaf(yv[k].y, ck[k], acc[1][u]);
              acc[2][u] = fmaf(yv[k].z, ck[k], acc[2][u]);
              acc[3][u] = fmaf(yv[k].w, ck[k], acc[3][u]);
            }
          }
        }
        const float tot = scal[0];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = 4 * c + v;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int n = 8 * r + u;
            float* e = dsp + p * NS + n;
            if (p < P && n < N) dot = fmaf(*e, __ldg(S + p * N + n), dot);
            *e = fmaf(tot, *e, acc[v][u]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(~0u, dot, o);
      if (lane == 0) scal[8 + warp] = dot;
    }
    __syncthreads();

    // da, its suffix sums, ddt and the tile's share of dA (warp 0, two
    // tokens a lane)
    if (tid < 32) {
      float sj[2], dv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * tid + k;
        sj[k] = dts[i] * w[i] * xu[i];
        dv[k] = rowr[i] - dts[i] * colgd[i] + yoff[i] - sj[k];
      }
      float ssum = sj[0] + sj[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ssum += __shfl_xor_sync(~0u, ssum, o);
      if (tid == 31) {
        float dot = 0.f;
        for (int k = 0; k < kThreads / 32; ++k) dot += scal[8 + k];
        dv[1] += ssum + scal[0] * dot;
      }
      // suffix sums: lane l holds da of tokens 2l, 2l + 1; sum over lanes >= l
      const float pair = dv[0] + dv[1];
      float s = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(~0u, s, o);
        if (tid + o < 32) s += v;
      }
      const float suf[2] = {s, s - dv[0]};   // sum_{i>=2l}, sum_{i>=2l+1}
      float dap = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = 2 * tid + k;
        dap = fmaf(dts[j], suf[k], dap);
        if (ddt != nullptr && j < nt)
          ddt[(static_cast<size_t>(b) * L + t0 + j) * H + h] =
              colgd[j] + w[j] * xu[j] + a * suf[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(~0u, dap, o);
      if (tid == 0) dA_acc += dap;
    }
  }
  __syncthreads();
  if (d_init != nullptr)
    for (int i = tid; i < P * N; i += kThreads) d_init[st_off + i] = dsp[(i / N) * NS + i % N];
  if (tid == 0 && dA_part != nullptr) dA_part[static_cast<size_t>(b) * H + h] = dA_acc;
}

// ---------------------------------------------------------------- mma path
constexpr int kXR = kT + 8;   // bf16 row of staged x, dy and M2: ldmatrix rows on distinct banks

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float2 bf2_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The shape of a block of HB heads over N padded to 16 NK: 4 warps a head,
// the n-split phases' chunks of N, and the shared memory (byte offsets).
template <int HB, int NK>
struct BwdShape {
  static constexpr int kThreads = 128 * HB;
  static constexpr int NR = 16 * NK + 8;           // bf16 row of staged B, C and dS'
  static constexpr int CHUNKS = HB < NK ? HB : NK;  // warps (w, c < CHUNKS) split N's 2 NK n8 tiles
  static constexpr int CW = 2 * NK / CHUNKS;        // n8 tiles a chunk (even)
  // B and C [64][NR]; per head x, dy's hi and lo parts [64][kXR] and the
  // state's (then dS''s) hi and lo parts [64 p][NR]; the head sum of M2
  // [i][j] as hi and lo [64][kXR] and, with HB > 1, in fp32 [64][68]; then
  // per head the vectors dt, cum (log2 units), 2^cum, 2^(cum_Q - cum),
  // dt 2^(cum_Q - cum), sum_j R_ij, x . U, the G o D column partials [4
  // row tiles], the C . V partials [CHUNKS <= HB], and 8 scalars (2^cum_Q,
  // the 4 warps' <dS', S>)
  static constexpr int kB = 0;
  static constexpr int kC = kB + kT * NR * 2;
  static constexpr int kX = kC + kT * NR * 2;
  static constexpr int kDyh = kX + HB * kT * kXR * 2;
  static constexpr int kDyl = kDyh + HB * kT * kXR * 2;
  static constexpr int kSh = kDyl + HB * kT * kXR * 2;
  static constexpr int kSl = kSh + HB * kMaxP * NR * 2;
  static constexpr int kMh = kSl + HB * kMaxP * NR * 2;
  static constexpr int kMl = kMh + kT * kXR * 2;
  static constexpr int kMf = kMl + kT * kXR * 2;
  static constexpr int kVec = kMf + (HB > 1 ? kT * (kT + 4) * 4 : 0);
  static constexpr int kBytes = kVec + 4 * (kT * HB * (11 + HB) + 8 * HB);
};

// grid (H / HB, B): block x takes heads HB x .. HB x + HB - 1, all of group
// HB x / (H / G). vec: x, B and C rows 16 bytes aligned with P and N
// multiples of 8 (cp.async), else 2-byte loads.
template <int HB, int NK>
__global__ void __launch_bounds__(128 * HB, 1) ssd_bwd_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ states, const float* __restrict__ dy,
    const float* __restrict__ d_final, __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ dA_part, float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ d_init, Dims d, int vec) {
  using S = BwdShape<HB, NK>;
  constexpr int kThr = S::kThreads, NR = S::NR, CW = S::CW, NT = 2 * NK;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  auto* bs = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kB);
  auto* cs = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kC);
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kX);
  auto* dyh = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kDyh);
  auto* dyl = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kDyl);
  auto* sdh = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kSh);
  auto* sdl = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kSl);
  auto* m2h = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kMh);
  auto* m2l = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kMl);
  auto* m2f = reinterpret_cast<float*>(smem_mma + S::kMf);
  float* dts = reinterpret_cast<float*>(smem_mma + S::kVec);   // [HB][64] each
  float* cum = dts + HB * kT;
  float* ecum = cum + HB * kT;
  float* wt = ecum + HB * kT;
  float* dtw = wt + HB * kT;
  float* rowr = dtw + HB * kT;
  float* xu = rowr + HB * kT;
  float* colp = xu + HB * kT;        // [4][HB][64]
  float* cvp = colp + 4 * HB * kT;   // [CHUNKS][HB][64]
  float* tot = cvp + HB * HB * kT;   // [HB]
  float* dotp = tot + HB;            // [HB][4]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gc = lane % 4;   // an accumulator fragment's row and column pair
  const int w = warp % 4, k = warp / 4;     // row tile w; head slot (or chunk) k
  const int H = d.H, P = d.P, N = d.N, L = d.L;
  const int h0 = blockIdx.x * HB, b = blockIdx.y, hk = h0 + k;
  const int g = h0 / (H / d.G);
  const int tiles = (L + kT - 1) / kT;
  const int i0 = 16 * w + gr;               // the thread's rows of a 16-row tile: i0, i0 + 8
  const __nv_bfloat16* xrow = x + b * d.sxb + static_cast<long long>(h0) * P;
  const __nv_bfloat16* brow = Bm + b * d.sbb + static_cast<long long>(g) * N;
  const __nv_bfloat16* crow = Cm + b * d.scb + static_cast<long long>(g) * N;
  // this block's slot of the dB / dC partials (gs, B, L, G, N): gs = H / G / HB
  // blocks a group, summed by the reduce kernel after this one
  const size_t prow = static_cast<size_t>(blockIdx.x % (H / d.G / HB)) * gridDim.y + b;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  __nv_bfloat16* xk = xs + k * kT * kXR;          // this warp's head: x, dy, S / dS'
  __nv_bfloat16* dyhk = dyh + k * kT * kXR;
  __nv_bfloat16* dylk = dyl + k * kT * kXR;
  __nv_bfloat16* sdhk = sdh + k * kMaxP * NR;
  __nv_bfloat16* sdlk = sdl + k * kMaxP * NR;

  // dS' of head k, p-tile w: dsa[nt][e] = dS'[16 w + gr + 8 (e / 2)][8 nt + 2 gc + e % 2]
  float dsa[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = i0 + 8 * (e >> 1), n = 8 * nt + 2 * gc + (e & 1);
      dsa[nt][e] = d_final != nullptr && p < P && n < N
                       ? d_final[((static_cast<size_t>(b) * H + hk) * P + p) * N + n] : 0.f;
    }
  float dA_acc = 0.f;   // lane 0 of warp (0, k): head k's sum over the tiles

  for (int t = tiles - 1; t >= 0; --t) {
    const int t0 = t * kT;
    __syncthreads();   // the previous tile's readers are done
    // ---- stage tile t: B, C and x by cp.async (zeros past L, P and N), dy
    // and the entry state S as hi + lo parts, dt and its scan
    if (vec) {
      for (int i = tid; i < kT * 2 * NK; i += kThr) {
        const int r = i / (2 * NK), c = i % (2 * NK) * 8;
        const bool ok = t0 + r < L && c < N;
        cp_async16(bs + r * NR + c, ok ? brow + (t0 + r) * d.sbt + c : brow, ok ? 16 : 0);
        cp_async16(cs + r * NR + c, ok ? crow + (t0 + r) * d.sct + c : crow, ok ? 16 : 0);
      }
      for (int i = tid; i < kT * HB * 8; i += kThr) {
        const int r = i / (HB * 8), hh = i % (HB * 8) / 8, c = i % 8 * 8;
        const bool ok = t0 + r < L && c < P;
        cp_async16(xs + (hh * kT + r) * kXR + c, ok ? xrow + (t0 + r) * d.sxt + hh * P + c : xrow,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kT * 16 * NK; i += kThr) {
        const int r = i / (16 * NK), c = i % (16 * NK);
        const bool ok = t0 + r < L && c < N;
        bs[r * NR + c] = ok ? brow[(t0 + r) * d.sbt + c] : zero;
        cs[r * NR + c] = ok ? crow[(t0 + r) * d.sct + c] : zero;
      }
      for (int i = tid; i < kT * HB * kMaxP; i += kThr) {
        const int r = i / (HB * kMaxP), hh = i % (HB * kMaxP) / kMaxP, c = i % kMaxP;
        xs[(hh * kT + r) * kXR + c] =
            t0 + r < L && c < P ? xrow[(t0 + r) * d.sxt + hh * P + c] : zero;
      }
    }
    cp_async_commit();
    const float* dyt = dy + (static_cast<size_t>(b) * L + t0) * H * P + static_cast<size_t>(h0) * P;
    if (P % 4 == 0) {
      for (int i = tid; i < kT * HB * 16; i += kThr) {
        const int r = i / (HB * 16), hh = i % (HB * 16) / 16, c = i % 16 * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + r < L && c < P) v = *reinterpret_cast<const float4*>(dyt + (r * H + hh) * P + c);
        uint2 hi, lo;
        split_rn(v.x, v.y, hi.x, lo.x);
        split_rn(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(dyh + (hh * kT + r) * kXR + c) = hi;
        *reinterpret_cast<uint2*>(dyl + (hh * kT + r) * kXR + c) = lo;
      }
    } else {
      for (int i = tid; i < kT * HB * 32; i += kThr) {
        const int r = i / (HB * 32), hh = i % (HB * 32) / 32, c = i % 32 * 2;
        const bool live = t0 + r < L;
        const float* src = dyt + (r * H + hh) * P + c;
        unsigned hi, lo;
        split_rn(live && c < P ? src[0] : 0.f, live && c + 1 < P ? src[1] : 0.f, hi, lo);
        *reinterpret_cast<unsigned*>(dyh + (hh * kT + r) * kXR + c) = hi;
        *reinterpret_cast<unsigned*>(dyl + (hh * kT + r) * kXR + c) = lo;
      }
    }
    const float* st = states + ((static_cast<size_t>(b) * tiles + t) * H + h0) * P * N;
    if (N % 4 == 0) {
      for (int i = tid; i < HB * kMaxP * 4 * NK; i += kThr) {
        const int hh = i / (kMaxP * 4 * NK), p = i % (kMaxP * 4 * NK) / (4 * NK),
                  n = i % (4 * NK) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < P && n < N) v = *reinterpret_cast<const float4*>(st + (hh * P + p) * N + n);
        uint2 hi, lo;
        split_rn(v.x, v.y, hi.x, lo.x);
        split_rn(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(sdh + (hh * kMaxP + p) * NR + n) = hi;
        *reinterpret_cast<uint2*>(sdl + (hh * kMaxP + p) * NR + n) = lo;
      }
    } else {
      for (int i = tid; i < HB * kMaxP * 8 * NK; i += kThr) {
        const int hh = i / (kMaxP * 8 * NK), p = i % (kMaxP * 8 * NK) / (8 * NK),
                  n = i % (8 * NK) * 2;
        const float* src = st + (hh * P + p) * N + n;
        unsigned hi, lo;
        split_rn(p < P && n < N ? src[0] : 0.f, p < P && n + 1 < N ? src[1] : 0.f, hi, lo);
        *reinterpret_cast<unsigned*>(sdh + (hh * kMaxP + p) * NR + n) = hi;
        *reinterpret_cast<unsigned*>(sdl + (hh * kMaxP + p) * NR + n) = lo;
      }
    }
    if (w == 0) {   // warp (0, k): head k's dt and the inclusive scan of dt A in log2 units
      const int j = 2 * lane;
      const float* dtr = dt + (static_cast<size_t>(b) * L + t0 + j) * H + hk;
      const float d0 = t0 + j < L ? dtr[0] : 0.f, d1 = t0 + j + 1 < L ? dtr[H] : 0.f;
      const float a2 = A[hk] * kLog2e;
      const float a0 = d0 * a2, a1 = a0 + d1 * a2;
      float sc = a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(~0u, sc, o);
        if (lane >= o) sc += v;
      }
      float excl = __shfl_up_sync(~0u, sc, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = excl + a1, last = __shfl_sync(~0u, c1, 31);
      const float w0 = ex2(last - c0), w1 = ex2(last - c1);
      float* base = dts + k * kT + j;
      *reinterpret_cast<float2*>(base) = make_float2(d0, d1);
      *reinterpret_cast<float2*>(base + HB * kT) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(base + 2 * HB * kT) = make_float2(ex2(c0), ex2(c1));
      *reinterpret_cast<float2*>(base + 3 * HB * kT) = make_float2(w0, w1);
      *reinterpret_cast<float2*>(base + 4 * HB * kT) = make_float2(d0 * w0, d1 * w1);
      if (lane == 0) tot[k] = ex2(last);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const float* cumk = cum + k * kT;
    const float* dtk = dts + k * kT;
    // ---- (1) warp (w, k), rows i of tile w against keys j <= i: C B^T (one
    // product: bf16 x bf16) and D = dy x^T (dy as lo + hi parts), then
    // L_ij = 2^(cum_i - cum_j), G = C B^T L, M2 = L dt_j D, R = G dt_j D;
    // the row sums of R, the column partials of G o D
    float m2[8][4];
    {
      float sc[8][4] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, cs + (16 * w + lane % 16) * NR + 16 * kk + lane / 16 * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np > w) continue;
          unsigned r[4];
          ldmatrix_x4(r, bs + (16 * np + lane / 16 * 8 + lane % 8) * NR + 16 * kk +
                             lane / 8 % 2 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(sc[2 * np], a, b0);
          mma_bf16(sc[2 * np + 1], a, b1);
        }
      }
#pragma unroll
      for (int kp = 0; kp < kMaxP / 16; ++kp) {
        unsigned al[4], ah[4];
        ldmatrix_x4(al, dylk + (16 * w + lane % 16) * kXR + 16 * kp + lane / 16 * 8);
        ldmatrix_x4(ah, dyhk + (16 * w + lane % 16) * kXR + 16 * kp + lane / 16 * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np > w) continue;
          unsigned r[4];
          ldmatrix_x4(r, xk + (16 * np + lane / 16 * 8 + lane % 8) * kXR + 16 * kp +
                             lane / 8 % 2 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(m2[2 * np], al, b0);
          mma_bf16(m2[2 * np + 1], al, b1);
          mma_bf16(m2[2 * np], ah, b0);
          mma_bf16(m2[2 * np + 1], ah, b1);
        }
      }
      const float ci[2] = {cumk[i0], cumk[i0 + 8]};
      float rowp[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float cq[2] = {0.f, 0.f};
        if (nt / 2 <= w) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * nt + 2 * gc + (e & 1), i = i0 + 8 * (e >> 1);
            if (j <= i) {
              const float lm = ex2(ci[e >> 1] - cumk[j]), gv = sc[nt][e] * lm, dj = dtk[j];
              const float dv = m2[nt][e];
              m2[nt][e] = lm * dj * dv;
              rowp[e >> 1] += gv * dj * dv;
              cq[e & 1] += gv * dv;
            } else {
              m2[nt][e] = 0.f;
            }
          }
        }
        // column partials over the tile's 16 rows (lanes of one gc), in a fixed pattern
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cq[0] += __shfl_xor_sync(~0u, cq[0], o);
          cq[1] += __shfl_xor_sync(~0u, cq[1], o);
        }
        if (gr == 0)
          *reinterpret_cast<float2*>(colp + (w * HB + k) * kT + 8 * nt + 2 * gc) =
              make_float2(cq[0], cq[1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = rowp[hh];
        v += __shfl_xor_sync(~0u, v, 1);
        v += __shfl_xor_sync(~0u, v, 2);
        if (gc == 0) rowr[k * kT + i0 + 8 * hh] = v;
      }
    }
    // M2 summed over the block's heads in head order (warps (w, 0), (w, 1),
    // ... of row tile w in turn, through m2f), then staged as hi + lo parts
#pragma unroll
    for (int step = 0; step < HB; ++step) {
      if (step > 0) bar_sync(1 + w, 32 * HB);
      if (k != step) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt / 2 > w) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (i0 + 8 * hh) * (kT + 4) + 8 * nt + 2 * gc;
          if (step > 0) {
            const float2 s2 = *reinterpret_cast<const float2*>(m2f + off);
            m2[nt][2 * hh] += s2.x;
            m2[nt][2 * hh + 1] += s2.y;
          }
          if (step < HB - 1) {
            *reinterpret_cast<float2*>(m2f + off) = make_float2(m2[nt][2 * hh], m2[nt][2 * hh + 1]);
          } else {
            unsigned hi, lo;
            split_rn(m2[nt][2 * hh], m2[nt][2 * hh + 1], hi, lo);
            const int o2 = (i0 + 8 * hh) * kXR + 8 * nt + 2 * gc;
            *reinterpret_cast<unsigned*>(m2h + o2) = hi;
            *reinterpret_cast<unsigned*>(m2l + o2) = lo;
          }
        }
      }
    }
    bar_sync(1 + w, 32 * HB);   // row tile w's M2 sum is staged

    // ---- (2) warp (w, k), rows j of tile w against queries i >= j: G^T =
    // (B C^T) o L^T, then G^T dy (hi + lo x hi + lo: three products), held
    // until dS' is staged
    float gdy[8][4] = {};
    {
      float sc[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, bs + (16 * w + lane % 16) * NR + 16 * kk + lane / 16 * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < w) continue;
          unsigned r[4];
          ldmatrix_x4(r, cs + (16 * np + lane / 16 * 8 + lane % 8) * NR + 16 * kk +
                             lane / 8 % 2 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(sc[2 * np], a, b0);
          mma_bf16(sc[2 * np + 1], a, b1);
        }
      }
      const float cj[2] = {cumk[i0], cumk[i0 + 8]};
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        if (ki < w) continue;
        unsigned gh[4], gl[4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = 16 * ki + 8 * q + 2 * gc + u, j = i0 + 8 * hh;
              v[u] = i >= j ? sc[2 * ki + q][2 * hh + u] * ex2(cumk[i] - cj[hh]) : 0.f;
            }
            split_rn(v[0], v[1], gh[2 * q + hh], gl[2 * q + hh]);
          }
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          unsigned rh[4], rl[4];
          ldmatrix_x4_trans(rh, dyhk + (16 * ki + lane % 16) * kXR + 16 * dp + lane / 16 * 8);
          ldmatrix_x4_trans(rl, dylk + (16 * ki + lane % 16) * kXR + 16 * dp + lane / 16 * 8);
          const unsigned h0b[2] = {rh[0], rh[1]}, h1b[2] = {rh[2], rh[3]};
          const unsigned l0b[2] = {rl[0], rl[1]}, l1b[2] = {rl[2], rl[3]};
          mma_bf16(gdy[2 * dp], gl, h0b);
          mma_bf16(gdy[2 * dp + 1], gl, h1b);
          mma_bf16(gdy[2 * dp], gh, l0b);
          mma_bf16(gdy[2 * dp + 1], gh, l1b);
          mma_bf16(gdy[2 * dp], gh, h0b);
          mma_bf16(gdy[2 * dp + 1], gh, h1b);
        }
      }
    }

    // ---- (3) warp (w, c < CHUNKS), rows i of tile w, chunk c of N: dC =
    // M2sum B (lo + hi) + sum over heads of 2^cum_i V, V = dy S (three
    // products a head); the partials C_i . V_i
    if (k < S::CHUNKS) {
      float cvq[HB][2] = {};
#pragma unroll
      for (int q = 0; q < CW / 2; ++q) {
        const int n0 = 8 * CW * k + 16 * q;
        float dc[2][4] = {};
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          if (kj > w) continue;
          unsigned al[4], ah[4], r[4];
          ldmatrix_x4(al, m2l + (16 * w + lane % 16) * kXR + 16 * kj + lane / 16 * 8);
          ldmatrix_x4(ah, m2h + (16 * w + lane % 16) * kXR + 16 * kj + lane / 16 * 8);
          ldmatrix_x4_trans(r, bs + (16 * kj + lane % 16) * NR + n0 + lane / 16 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(dc[0], al, b0);
          mma_bf16(dc[1], al, b1);
          mma_bf16(dc[0], ah, b0);
          mma_bf16(dc[1], ah, b1);
        }
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          float vv[2][4] = {};
#pragma unroll
          for (int kp = 0; kp < kMaxP / 16; ++kp) {
            unsigned al[4], ah[4], rh[4], rl[4];
            ldmatrix_x4(al, dyl + (hh * kT + 16 * w + lane % 16) * kXR + 16 * kp + lane / 16 * 8);
            ldmatrix_x4(ah, dyh + (hh * kT + 16 * w + lane % 16) * kXR + 16 * kp + lane / 16 * 8);
            const int so = (hh * kMaxP + 16 * kp + lane % 16) * NR + n0 + lane / 16 * 8;
            ldmatrix_x4_trans(rh, sdh + so);
            ldmatrix_x4_trans(rl, sdl + so);
            const unsigned h0b[2] = {rh[0], rh[1]}, h1b[2] = {rh[2], rh[3]};
            const unsigned l0b[2] = {rl[0], rl[1]}, l1b[2] = {rl[2], rl[3]};
            mma_bf16(vv[0], al, h0b);
            mma_bf16(vv[1], al, h1b);
            mma_bf16(vv[0], ah, l0b);
            mma_bf16(vv[1], ah, l1b);
            mma_bf16(vv[0], ah, h0b);
            mma_bf16(vv[1], ah, h1b);
          }
          const float e2[2] = {ecum[hh * kT + i0], ecum[hh * kT + i0 + 8]};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + 8 * (e >> 1), n = n0 + 8 * u + 2 * gc + (e & 1);
              dc[u][e] = fmaf(e2[e >> 1], vv[u][e], dc[u][e]);
              cvq[hh][e >> 1] = fmaf(__bfloat162float(cs[i * NR + n]), vv[u][e], cvq[hh][e >> 1]);
            }
        }
        if (dC_part != nullptr)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = i0 + 8 * hh;
            if (t0 + i >= L) continue;
            float* o = dC_part + ((prow * L + t0 + i) * d.G + g) * N;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int n = n0 + 8 * u + 2 * gc;
              if (n < N) o[n] = dc[u][2 * hh];
              if (n + 1 < N) o[n + 1] = dc[u][2 * hh + 1];
            }
          }
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = cvq[hh][r];
          v += __shfl_xor_sync(~0u, v, 1);
          v += __shfl_xor_sync(~0u, v, 2);
          if (gc == 0) cvp[(k * HB + hh) * kT + i0 + 8 * r] = v;
        }
    }
    // <dS', S> over the warp's entries of head k (S from its staged parts)
    {
      float dot = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (i0 + 8 * hh) * NR + 8 * nt + 2 * gc;
          const unsigned sh2 = *reinterpret_cast<const unsigned*>(sdhk + off);
          const unsigned sl2 = *reinterpret_cast<const unsigned*>(sdlk + off);
          dot = fmaf(dsa[nt][2 * hh], lo_f32(sh2) + lo_f32(sl2), dot);
          dot = fmaf(dsa[nt][2 * hh + 1], hi_f32(sh2) + hi_f32(sl2), dot);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(~0u, dot, o);
      if (lane == 0) dotp[k * 4 + w] = dot;
    }
    __syncthreads();   // every reader of the staged S is done

    // ---- dS' of head k staged over S as hi + lo parts [p][n]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned hi, lo;
        split_rn(dsa[nt][2 * hh], dsa[nt][2 * hh + 1], hi, lo);
        const int off = (i0 + 8 * hh) * NR + 8 * nt + 2 * gc;
        *reinterpret_cast<unsigned*>(sdhk + off) = hi;
        *reinterpret_cast<unsigned*>(sdlk + off) = lo;
      }
    __syncthreads();

    // ---- (4) warp (w, k): U = B dS'^T (B exact, dS' lo + hi) for rows j of
    // tile w; dx_j = dt_j (2^(cum_Q - cum_j) U_j + (G^T dy)_j); x_j . U_j
    {
      float u[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, bs + (16 * w + lane % 16) * NR + 16 * kk + lane / 16 * 8);
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          unsigned rl[4], rh[4];
          const int off = (16 * dp + lane / 16 * 8 + lane % 8) * NR + 16 * kk + lane / 8 % 2 * 8;
          ldmatrix_x4(rl, sdlk + off);
          ldmatrix_x4(rh, sdhk + off);
          const unsigned l0b[2] = {rl[0], rl[1]}, l1b[2] = {rl[2], rl[3]};
          const unsigned h0b[2] = {rh[0], rh[1]}, h1b[2] = {rh[2], rh[3]};
          mma_bf16(u[2 * dp], a, l0b);
          mma_bf16(u[2 * dp + 1], a, l1b);
          mma_bf16(u[2 * dp], a, h0b);
          mma_bf16(u[2 * dp + 1], a, h1b);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = i0 + 8 * hh;
        const float dj = dtk[j], wj = wt[k * kT + j];
        float xq = 0.f;
        __nv_bfloat16* o = dx == nullptr || t0 + j >= L
                               ? nullptr
                               : dx + ((static_cast<size_t>(b) * L + t0 + j) * H + hk) * P;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = 8 * nt + 2 * gc;
          const float2 xv = bf2_f32(xk + j * kXR + p);
          const float u0 = u[nt][2 * hh], u1 = u[nt][2 * hh + 1];
          xq = fmaf(xv.x, u0, xq);
          xq = fmaf(xv.y, u1, xq);
          const float v0 = dj * fmaf(wj, u0, gdy[nt][2 * hh]);
          const float v1 = dj * fmaf(wj, u1, gdy[nt][2 * hh + 1]);
          if (o == nullptr || p >= P) continue;
          if ((P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + p) = __floats2bfloat162_rn(v0, v1);
          } else {
            o[p] = __float2bfloat16(v0);
            if (p + 1 < P) o[p + 1] = __float2bfloat16(v1);
          }
        }
        xq += __shfl_xor_sync(~0u, xq, 1);
        xq += __shfl_xor_sync(~0u, xq, 2);
        if (gc == 0) xu[k * kT + j] = xq;
      }
    }

    // ---- (5) warp (w, c < CHUNKS), rows j of tile w, chunk c of N: dB =
    // M2sum^T C (lo + hi) + sum over heads of dt_j 2^(cum_Q - cum_j) W_j,
    // W = x dS' (x exact, dS' lo + hi)
    if (k < S::CHUNKS) {
#pragma unroll
      for (int q = 0; q < CW / 2; ++q) {
        const int n0 = 8 * CW * k + 16 * q;
        float db[2][4] = {};
#pragma unroll
        for (int ki = 0; ki < 4; ++ki) {
          if (ki < w) continue;
          unsigned al[4], ah[4], r[4];
          const int off = (16 * ki + lane / 16 * 8 + lane % 8) * kXR + 16 * w + lane / 8 % 2 * 8;
          ldmatrix_x4_trans(al, m2l + off);
          ldmatrix_x4_trans(ah, m2h + off);
          ldmatrix_x4_trans(r, cs + (16 * ki + lane % 16) * NR + n0 + lane / 16 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(db[0], al, b0);
          mma_bf16(db[1], al, b1);
          mma_bf16(db[0], ah, b0);
          mma_bf16(db[1], ah, b1);
        }
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          float ww[2][4] = {};
#pragma unroll
          for (int kp = 0; kp < kMaxP / 16; ++kp) {
            unsigned a[4], rh[4], rl[4];
            ldmatrix_x4(a, xs + (hh * kT + 16 * w + lane % 16) * kXR + 16 * kp + lane / 16 * 8);
            const int so = (hh * kMaxP + 16 * kp + lane % 16) * NR + n0 + lane / 16 * 8;
            ldmatrix_x4_trans(rl, sdl + so);
            ldmatrix_x4_trans(rh, sdh + so);
            const unsigned l0b[2] = {rl[0], rl[1]}, l1b[2] = {rl[2], rl[3]};
            const unsigned h0b[2] = {rh[0], rh[1]}, h1b[2] = {rh[2], rh[3]};
            mma_bf16(ww[0], a, l0b);
            mma_bf16(ww[1], a, l1b);
            mma_bf16(ww[0], a, h0b);
            mma_bf16(ww[1], a, h1b);
          }
          const float f[2] = {dtw[hh * kT + i0], dtw[hh * kT + i0 + 8]};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) db[u][e] = fmaf(f[e >> 1], ww[u][e], db[u][e]);
        }
        if (dB_part != nullptr)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = i0 + 8 * hh;
            if (t0 + j >= L) continue;
            float* o = dB_part + ((prow * L + t0 + j) * d.G + g) * N;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int n = n0 + 8 * u + 2 * gc;
              if (n < N) o[n] = db[u][2 * hh];
              if (n + 1 < N) o[n + 1] = db[u][2 * hh + 1];
            }
          }
      }
    }

    // ---- (6) warp (w, k): dS' <- 2^cum_Q dS' + (2^cum_i dy_i)^T C for its
    // p-tile w; 2^cum_i dy_i from dy's staged parts, rounded to hi + lo again
    {
      unsigned eh[4][4], el[4][4];
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        unsigned rh[4], rl[4];
        const int off = (16 * ki + lane / 16 * 8 + lane % 8) * kXR + 16 * w + lane / 8 % 2 * 8;
        ldmatrix_x4_trans(rh, dyhk + off);
        ldmatrix_x4_trans(rl, dylk + off);
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // register r: tokens 16 ki + 2 gc + 8 (r / 2), + 1
          const float2 e2 = *reinterpret_cast<const float2*>(ecum + k * kT + 16 * ki + 2 * gc +
                                                            8 * (r >> 1));
          split_rn((lo_f32(rh[r]) + lo_f32(rl[r])) * e2.x, (hi_f32(rh[r]) + hi_f32(rl[r])) * e2.y,
                   eh[ki][r], el[ki][r]);
        }
      }
      const float tk = tot[k];
#pragma unroll
      for (int q = 0; q < NK; ++q) {
        float nw[2][4] = {};
#pragma unroll
        for (int ki = 0; ki < 4; ++ki) {
          unsigned r[4];
          ldmatrix_x4_trans(r, cs + (16 * ki + lane % 16) * NR + 16 * q + lane / 16 * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(nw[0], el[ki], b0);
          mma_bf16(nw[1], el[ki], b1);
          mma_bf16(nw[0], eh[ki], b0);
          mma_bf16(nw[1], eh[ki], b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dsa[2 * q][e] = fmaf(tk, dsa[2 * q][e], nw[0][e]);
          dsa[2 * q + 1][e] = fmaf(tk, dsa[2 * q + 1][e], nw[1][e]);
        }
      }
    }
    __syncthreads();   // the per-token partials are written

    // ---- da, its suffix sums, ddt and the tile's share of dA: warp (0, k)
    // for head k, two tokens a lane (the tiled kernel's formulas)
    if (w == 0) {
      float sj[2], dv[2], cg[2], xv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        float c = 0.f, v = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) c += colp[(r * HB + k) * kT + i];
#pragma unroll
        for (int r = 0; r < S::CHUNKS; ++r) v += cvp[(r * HB + k) * kT + i];
        const float di = dtk[i], wi = wt[k * kT + i];
        cg[u] = c;
        xv[u] = xu[k * kT + i];
        sj[u] = di * wi * xv[u];
        dv[u] = rowr[k * kT + i] - di * c + ecum[k * kT + i] * v - sj[u];
      }
      float ssum = sj[0] + sj[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ssum += __shfl_xor_sync(~0u, ssum, o);
      if (lane == 31) {
        const float dot = dotp[k * 4] + dotp[k * 4 + 1] + dotp[k * 4 + 2] + dotp[k * 4 + 3];
        dv[1] += ssum + tot[k] * dot;
      }
      float sc = dv[0] + dv[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(~0u, sc, o);
        if (lane + o < 32) sc += v;
      }
      const float suf[2] = {sc, sc - dv[0]};
      const float ak = A[hk];
      float dap = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * lane + u;
        dap = fmaf(dtk[j], suf[u], dap);
        if (ddt != nullptr && t0 + j < L)
          ddt[(static_cast<size_t>(b) * L + t0 + j) * H + hk] =
              cg[u] + wt[k * kT + j] * xv[u] + ak * suf[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(~0u, dap, o);
      if (lane == 0) dA_acc += dap;
    }
  }

  if (d_init != nullptr)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = i0 + 8 * (e >> 1), n = 8 * nt + 2 * gc + (e & 1);
        if (p < P && n < N)
          d_init[((static_cast<size_t>(b) * H + hk) * P + p) * N + n] = dsa[nt][e];
      }
  if (w == 0 && lane == 0 && dA_part != nullptr) dA_part[static_cast<size_t>(b) * H + hk] = dA_acc;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* states;
  const float* dy;
  const float* d_final;
  void* dx;
  float* ddt;
  float* dA_part;
  float* dB_part;
  float* dC_part;
  float* d_init;
};

template <typename T>
int launch(const Args& a, int B, const Dims& d, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kMaxP, kMaxN) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bytes = smem_floats(d.PP, d.NP) * static_cast<int>(sizeof(float));
  ssd_bwd_kernel<T><<<dim3(d.H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(a.x), a.dt, a.A, static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), a.states, a.dy, a.d_final, static_cast<T*>(a.dx), a.ddt,
      a.dA_part, a.dB_part, a.dC_part, a.d_init, d);
  return static_cast<int>(cudaGetLastError());
}

template <int HB, int NK>
int launch_mma(const Args& a, int B, const Dims& d, int vec, cudaStream_t stream) {
  constexpr int bytes = BwdShape<HB, NK>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_mma_kernel<HB, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_bwd_mma_kernel<HB, NK><<<dim3(d.H / HB, B), 128 * HB, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.dt, a.A, static_cast<const __nv_bfloat16*>(a.Bm),
      static_cast<const __nv_bfloat16*>(a.Cm), a.states, a.dy, a.d_final,
      static_cast<__nv_bfloat16*>(a.dx), a.ddt, a.dA_part, a.dB_part, a.dC_part, a.d_init, d, vec);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn with integral constants HB and NK for the built pairs (hb 1 and 2
// at nk 1, 2, 4, 8; hb 4 at nk 1, 2: the others' blocks exceed the card's
// shared memory); -1 for any other.
template <typename Fn>
int dispatch_mma(int hb, int nk, Fn&& fn) {
  using std::integral_constant;
  switch (hb * 16 + nk) {
    case 17: return fn(integral_constant<int, 1>{}, integral_constant<int, 1>{});
    case 18: return fn(integral_constant<int, 1>{}, integral_constant<int, 2>{});
    case 20: return fn(integral_constant<int, 1>{}, integral_constant<int, 4>{});
    case 24: return fn(integral_constant<int, 1>{}, integral_constant<int, 8>{});
    case 33: return fn(integral_constant<int, 2>{}, integral_constant<int, 1>{});
    case 34: return fn(integral_constant<int, 2>{}, integral_constant<int, 2>{});
    case 36: return fn(integral_constant<int, 2>{}, integral_constant<int, 4>{});
    case 40: return fn(integral_constant<int, 2>{}, integral_constant<int, 8>{});
    case 65: return fn(integral_constant<int, 4>{}, integral_constant<int, 1>{});
    case 66: return fn(integral_constant<int, 4>{}, integral_constant<int, 2>{});
    default: return -1;
  }
}

// out (rows, N) = the sum over the gs slots of part (gs, rows, N), in a fixed
// order (gemm_common.cuh's split reduce), launched as a programmatic
// dependent of the kernel before it; at most 65535 rows a launch.
template <typename T>
int launch_group_sum(const float* part, int gs, T* out, long long rows, int N, cudaStream_t s) {
  for (long long r0 = 0; r0 < rows; r0 += 65535) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + kReduceCols - 1) / kReduceCols,
                       static_cast<unsigned>(rows - r0 < 65535 ? rows - r0 : 65535));
    cfg.blockDim = dim3(kReduceCols * kReduceLanes);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, split_reduce_kernel<T>, part + r0 * N, gs,
                                             static_cast<const float*>(nullptr), out + r0 * N,
                                             static_cast<int>(rows), N,
                                             static_cast<const int*>(nullptr), 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

enum Path : int { kTiled = 0, kMma = 1 };

}  // namespace

// The constants the wrapper mirrors, in this order: tokens a tile, the
// largest P and N, threads a tiled block, and the shared memory of a tiled
// block at the largest P and N (bytes).
extern "C" void ssd_scan_bwd_constants(int* c) {
  c[0] = kT;
  c[1] = kMaxP;
  c[2] = kMaxN;
  c[3] = kThreads;
  c[4] = smem_floats(kMaxP, kMaxN) * static_cast<int>(sizeof(float));
}

// The shared memory of an mma block of hb heads over N padded to 16 nk
// (bytes), -1 for a pair that is not built.
extern "C" int ssd_scan_bwd_mma_smem(int hb, int nk) {
  return dispatch_mma(hb, nk, [](auto hbc, auto nkc) {
    return BwdShape<decltype(hbc)::value, decltype(nkc)::value>::kBytes;
  });
}

// dB or dC of the mma path: out (B, L, G, N) of dtype = the sum over the gs
// blocks of each group of part (gs, B, L, G, N) fp32, rows = B L G; 0 on
// success, else the CUDA error, -1 for an unsupported dtype.
extern "C" int ssd_scan_bwd_group_sum(const float* part, int gs, void* out, long long rows,
                                      int N, int dtype, void* stream) {
  return dispatch_dtype(dtype, [&](auto* tp) {
    return launch_group_sum(part, gs, static_cast<decltype(tp)>(out), rows, N,
                            static_cast<cudaStream_t>(stream));
  });
}

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// path, dtype or shape. path 0 tiled (grid (H, B), one block a (row, head),
// fp32 or bf16), 1 mma (bf16; grid (H / hb, B), hb heads of one group a
// block, N padded to 16 nk). Layouts: x (B, L, H, P) with row strides sxb /
// sxt, B and C (B, L, G, N) with sbb / sbt and scb / sct (the last two dims
// of each contiguous), all of dtype; dt (B, L, H), A (H,), states (B,
// ceil(L / 64), H, P, N), dy (B, L, H, P) and d_final (B, H, P, N, or null:
// zeros) fp32 contiguous. Outputs, each null to skip it: dx (B, L, H, P) of
// dtype; ddt (B, L, H), dA_part (B, H), dB_part and dC_part (tiled: (B, L,
// H, N) per head; mma: (gs, B, L, G, N), each block's sum over its heads in
// its slot of the group's gs = H / G / hb) and d_init (B, H, P, N), fp32,
// contiguous.
extern "C" int ssd_scan_bwd_launch(int path, int hb, int nk, const void* x, const float* dt,
                                   const float* A, const void* Bm, const void* Cm,
                                   const float* states, const float* dy, const float* d_final,
                                   void* dx, float* ddt, float* dA_part, float* dB_part,
                                   float* dC_part, float* d_init, int B, int L, int H, int P,
                                   int N, int G, long long sxb, long long sxt, long long sbb,
                                   long long sbt, long long scb, long long sct, int dtype,
                                   void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G != 0 || B < 1 || L < 0)
    return -1;
  const int NP = (N + 7) / 8 * 8;
  const Dims d{L, H, P, N, G, (P + 3) / 4 * 4, NP, NP + 4, sxb, sxt, sbb, sbt, scb, sct};
  const Args a{x, dt, A, Bm, Cm, states, dy, d_final, dx, ddt, dA_part, dB_part, dC_part,
               d_init};
  auto s = static_cast<cudaStream_t>(stream);
  if (path == kTiled)
    return dispatch_dtype(dtype, [&](auto* tp) {
      return launch<std::remove_pointer_t<decltype(tp)>>(a, B, d, s);
    });
  if (path != kMma || dtype != kBFloat16 || hb < 1 || (H / G) % hb != 0 || 16 * nk < N) return -1;
  const int vec = P % 8 == 0 && N % 8 == 0 && aligned_rows(x, sxb, sxt, B, L) &&
                  aligned_rows(Bm, sbb, sbt, B, L) && aligned_rows(Cm, scb, sct, B, L);
  return dispatch_mma(hb, nk, [&](auto hbc, auto nkc) {
    return launch_mma<decltype(hbc)::value, decltype(nkc)::value>(a, B, d, vec, s);
  });
}
