// Mamba2 SSD chunk scan on Hopper (sm_90a): the selective state-space scan
// of every multi-token SSM call (LM.forward, LM.prefill and the serving
// engine's prefill chunks), with a carried initial state and the final
// state written out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py,
// ssd_scan_pallas (body _ssd_kernel). Same function: for each (row, head),
// with cum the inclusive cumulative sum of dt*A inside a block of tokens,
//   y_i = sum_{j<=i} (C_i.B_j) e^{cum_i-cum_j} dt_j x_j + e^{cum_i} C_i.S
//   S  <- e^{cum_last} S + sum_j e^{cum_last-cum_j} dt_j B_j (x) x_j
// in fp32 from fp32 or bf16 inputs. Beyond the TPU kernel it starts from an
// optional init_state (B,H,P,N) instead of zeros and writes the final state
// (B,H,P,N); with no init_state it is ssd_scan_pallas.
//
// What bounds it on the card: bytes at the serving shapes. A (row, head)
// reads its L x P inputs once and writes L x P outputs in fp32, plus the
// P x N state in and out; with 64-token blocks it does about
// 2*64*(N+P)/2 + 4*N*P flops per token and head, so at mamba2's widths
// (P 64, N 128, 2 bytes in and 4 out per element) about 120 flops per byte,
// under the H100's bf16 ridge of ~295. Short calls are set by launch
// latency and the serial walk over tiles.
//
// Design:
//  - the TPU grid (B*H, chunks) carries the state in VMEM along its
//    sequential chunk axis. Here one block per (row, head) walks the whole
//    sequence in order with the N x P state in shared memory (32 KB at
//    mamba2 width), so the state never leaves the chip between blocks.
//  - a block walks the sequence in tiles of kT = 64 tokens whatever the
//    model's chunk length: the SSD output does not depend on the chunk
//    length, only its rounding does (the reference's
//    test_chunk_size_invariance), and a 256-token chunk's C.B^T alone would
//    be 256 KB in fp32. Per tile: x (64 x P), B^T and C^T (N x 64, padded
//    rows for 16-byte reads), dt and the cumulative sum (one warp scans
//    it), then (1) the masked 64 x 64 score tile M_ij = (C_i.B_j)
//    e^{cum_i-cum_j} dt_j for j <= i, 4 x 4 entries a thread, the decay
//    taken only on and below the diagonal, where its exponent is <= 0
//    (above it the exponent is positive and could reach inf); (2) y = M x +
//    e^{cum} C.S, 4 rows x 4 columns a thread, the j loop cut at the
//    thread's last row; (3) S <- e^{cum_last} S + (w B)^T x with w_j =
//    e^{cum_last-cum_j} dt_j, 8 x 4 state entries a thread. About 137 KB of
//    shared memory at mamba2 width: one block per SM.
//  - B and C are read per group: head h reads group h / (H / G), so the
//    reference's repeat over heads is never materialised.
//  - tokens past L (the ragged tail) are loaded as zeros with dt = 0, which
//    leaves the state untouched, as padded tokens do in the reference.
//  - x, B and C are read with row strides (batch, token) so the model's
//    slices of its conv output need no copy; the last two dims of each are
//    contiguous. P <= 64 and N <= 128 are runtime values (padded to 4 and 8
//    in shared memory, the padding zero). CUDA-core fp32 FMAs; tensor-core
//    tiles are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // tokens per tile
constexpr int kTP = kT + 4;  // row of the transposed tiles (16-byte aligned, fewer conflicts)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

struct Dims {
  int L, H, P, N, G, PP, NP;  // PP / NP: P and N rounded up to 4 and 8
  long long sxb, sxt, sbb, sbt, scb, sct;
};

__host__ __device__ inline int smem_floats(int PP, int NP) {
  // xs[kT][PP], ct[NP][kTP], bt[NP][kTP], ss[NP][PP], mt[kT][kTP] (M^T),
  // cum[kT], ecum[kT], w[kT], dts[kT], then the tile's total decay
  return kT * PP + 2 * NP * kTP + NP * PP + kT * kTP + 4 * kT + 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ init_state,
    float* __restrict__ y, float* __restrict__ final_state, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int PP = d.PP, NP = d.NP;
  float* xs = smem;                    // [kT][PP]
  float* ct = xs + kT * PP;            // [NP][kTP]
  float* bt = ct + NP * kTP;           // [NP][kTP]
  float* ss = bt + NP * kTP;           // [NP][PP], the state S[n][p]
  float* mt = ss + NP * PP;            // [kT][kTP], mt[j][i] = M_ij
  float* cum = mt + kT * kTP;
  float* ecum = cum + kT;
  float* w = ecum + kT;
  float* dts = w + kT;
  float* total = dts + kT;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = d.H, P = d.P, N = d.N, L = d.L;
  const int g = h / (H / d.G);
  const float a = A[h];
  const T* xrow = x + b * d.sxb + static_cast<long long>(h) * P;
  const T* brow = Bm + b * d.sbb + static_cast<long long>(g) * N;
  const T* crow = Cm + b * d.scb + static_cast<long long>(g) * N;
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N;

  for (int i = tid; i < NP * PP; i += kThreads) {
    const int n = i / PP, p = i % PP;
    ss[i] = (init_state != nullptr && n < N && p < P) ? init_state[st_off + p * N + n] : 0.f;
  }

  // thread tiles: 4 x 4 of the score tile and of y, 8 x 4 of the state
  const int tr = tid / 16, tc = tid % 16;
  for (int t0 = 0; t0 < L; t0 += kT) {
    const int nt = min(kT, L - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kT * PP; i += kThreads) {
      const int r = i / PP, p = i % PP;
      xs[i] = (r < nt && p < P) ? to_f32(xrow[(t0 + r) * d.sxt + p]) : 0.f;
    }
    for (int i = tid; i < kT * NP; i += kThreads) {
      const int r = i / NP, n = i % NP;
      const bool live = r < nt && n < N;
      bt[n * kTP + r] = live ? to_f32(brow[(t0 + r) * d.sbt + n]) : 0.f;
      ct[n * kTP + r] = live ? to_f32(crow[(t0 + r) * d.sct + n]) : 0.f;
    }
    if (tid < kT)
      dts[tid] = tid < nt ? dt[(static_cast<size_t>(b) * L + t0 + tid) * H + h] : 0.f;
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
      float excl = __shfl_up_sync(~0u, s, 1);  // the sum of the lanes before
      if (tid == 0) excl = 0.f;
      cum[2 * tid] = excl + a0;
      cum[2 * tid + 1] = excl + a1;
    }
    __syncthreads();
    if (tid < kT) {
      const float last = cum[kT - 1];
      ecum[tid] = expf(cum[tid]);
      w[tid] = expf(last - cum[tid]) * dts[tid];
      if (tid == 0) total[0] = expf(last);
    }

    // (1) the score tile, rows 4tr.., columns 4tc..; blocks above the
    // diagonal are never read
    if (tc <= tr) {
      float acc[4][4] = {};
      for (int n = 0; n < NP; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(ct + n * kTP + 4 * tr);
        const float4 b4 = *reinterpret_cast<const float4*>(bt + n * kTP + 4 * tc);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = 4 * tc + v;
        float m[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * tr + u;
          m[u] = j <= i ? acc[u][v] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
        *reinterpret_cast<float4*>(mt + j * kTP + 4 * tr) = make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // (2) y for rows 4tr.., columns 4tc..
    if (4 * tc < PP) {
      float acc[4][4] = {}, off[4][4] = {};
      const int jmax = 4 * tr + 3;
      for (int j = 0; j <= jmax; ++j) {
        const float4 m4 = *reinterpret_cast<const float4*>(mt + j * kTP + 4 * tr);
        const float4 x4 = *reinterpret_cast<const float4*>(xs + j * PP + 4 * tc);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(mv[u], xv[v], acc[u][v]);
      }
      for (int n = 0; n < NP; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(ct + n * kTP + 4 * tr);
        const float4 s4 = *reinterpret_cast<const float4*>(ss + n * PP + 4 * tc);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) off[u][v] = fmaf(cv[u], sv[v], off[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * tr + u;
        if (i >= nt) continue;
        float* yo = y + ((static_cast<size_t>(b) * L + t0 + i) * H + h) * P;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = 4 * tc + v;
          if (p < P) yo[p] = fmaf(ecum[i], off[u][v], acc[u][v]);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // (3) the state, rows 8tr.., columns 4tc..
    if (8 * tr < NP && 4 * tc < PP) {
      float acc[8][4];
      const float tot = total[0];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 s4 = *reinterpret_cast<const float4*>(ss + (8 * tr + u) * PP + 4 * tc);
        acc[u][0] = s4.x * tot;
        acc[u][1] = s4.y * tot;
        acc[u][2] = s4.z * tot;
        acc[u][3] = s4.w * tot;
      }
      for (int j = 0; j < nt; ++j) {
        const float wj = w[j];
        const float4 x4 = *reinterpret_cast<const float4*>(xs + j * PP + 4 * tc);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float bw = bt[(8 * tr + u) * kTP + j] * wj;
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(bw, xv[v], acc[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        *reinterpret_cast<float4*>(ss + (8 * tr + u) * PP + 4 * tc) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    final_state[st_off + i] = ss[n * PP + p];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init_state, float* y, float* final_state, int B, const Dims& d,
           cudaStream_t stream) {
  const int bytes = smem_floats(d.PP, d.NP) * static_cast<int>(sizeof(float));
  static bool configured = false;  // the attribute is set once per instantiation, to the most
  if (!configured) {               // any supported shape needs
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(kMaxP, kMaxN) * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(d.H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, y, final_state, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// dtype or shape. Layouts: x (B, L, H, P) with row strides sxb / sxt; B and C
// (B, L, G, N) with row strides sbb / sbt and scb / sct (the last two dims
// of each contiguous); dt (B, L, H) fp32 contiguous; A (H,) fp32;
// init_state (B, H, P, N) fp32 or null (zeros); y (B, L, H, P) fp32 and
// final_state (B, H, P, N) fp32, contiguous.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, const float* init_state, float* y,
                               float* final_state, int B, int L, int H, int P, int N, int G,
                               long long sxb, long long sxt, long long sbb, long long sbt,
                               long long scb, long long sct, int dtype, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G != 0 || B < 1 || L < 0)
    return -1;
  const Dims d{L, H, P, N, G, (P + 3) / 4 * 4, (N + 7) / 8 * 8, sxb, sxt, sbb, sbt, scb, sct};
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    return launch<T>(x, dt, A, Bm, Cm, init_state, y, final_state, B, d, s);
  });
}
