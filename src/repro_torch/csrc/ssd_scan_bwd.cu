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
// What bounds it on the card: operations. Per tile and (row, head) it does
// about 7 products of 64 x 64 x N or 64 x P x N and 2 of 64 x 64 x P, ~4.2 M
// FMAs at mamba2's widths (P 64, N 128) against ~100 KB read, ~80 flops a
// byte; at the fp32 CUDA-core rate (no tensor cores here) the bound is the
// operations.
//
// The design, the first that is right (making it fast is later work): one
// block of 256 threads a (row, head), walking its tiles last to first with
// dS' (P x N, fp32) in shared memory, the only carried quantity. All math is
// IEEE fp32 on the CUDA cores, from fp32 or bf16 x / B / C. A tile's x, dy,
// B, C (transposed, and dy also by rows) and its three 64 x 64 matrices
// (C.B^T L, and L dt D in both orientations) sit in shared memory, at most
// 221 KB (P 64, N 128): one block a SM. Each product gives a thread a 4 x 4
// or 4 x 8 tile of its output, one operand read as float4 along the
// threads, the other as a broadcast. Sums across threads (column sums, dot
// products) go through per-row partials in shared memory added in a fixed
// order, and shuffles in a fixed pattern: no atomics, so a repeat gives the
// same bits. B and C are read per group (head h reads group h / (H / G)),
// with the forward's row strides; dB and dC come out per head as fp32
// partials (B, L, H, N), which the wrapper sums over each group's heads in
// head order, and dA per (row, head), which it sums over rows. Tokens past L
// load as zeros with dt = 0 and get no gradient written.

#include "common.cuh"

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

}  // namespace

// The constants the wrapper mirrors, in this order: tokens a tile, the
// largest P and N, threads a block, and the shared memory of a block at the
// largest P and N (bytes).
extern "C" void ssd_scan_bwd_constants(int* c) {
  c[0] = kT;
  c[1] = kMaxP;
  c[2] = kMaxN;
  c[3] = kThreads;
  c[4] = smem_floats(kMaxP, kMaxN) * static_cast<int>(sizeof(float));
}

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// dtype or shape. Grid (H, B), one block a (row, head). Layouts: x (B, L, H,
// P) with row strides sxb / sxt, B and C (B, L, G, N) with sbb / sbt and
// scb / sct (the last two dims of each contiguous), all of dtype; dt (B, L,
// H), A (H,), states (B, ceil(L / 64), H, P, N), dy (B, L, H, P) and d_final
// (B, H, P, N, or null: zeros) fp32 contiguous. Outputs, each null to skip
// it: dx (B, L, H, P) of dtype; ddt (B, L, H), dA_part (B, H), dB_part and
// dC_part (B, L, H, N) (per head, not yet summed over a group) and d_init
// (B, H, P, N), fp32, contiguous.
extern "C" int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A,
                                   const void* Bm, const void* Cm, const float* states,
                                   const float* dy, const float* d_final, void* dx, float* ddt,
                                   float* dA_part, float* dB_part, float* dC_part, float* d_init,
                                   int B, int L, int H, int P, int N, int G, long long sxb,
                                   long long sxt, long long sbb, long long sbt, long long scb,
                                   long long sct, int dtype, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G != 0 || B < 1 || L < 0)
    return -1;
  const int NP = (N + 7) / 8 * 8;
  const Dims d{L, H, P, N, G, (P + 3) / 4 * 4, NP, NP + 4, sxb, sxt, sbb, sbt, scb, sct};
  const Args a{x, dt, A, Bm, Cm, states, dy, d_final, dx, ddt, dA_part, dB_part, dC_part,
               d_init};
  return dispatch_dtype(dtype, [&](auto* tp) {
    return launch<std::remove_pointer_t<decltype(tp)>>(a, B, d, static_cast<cudaStream_t>(stream));
  });
}
