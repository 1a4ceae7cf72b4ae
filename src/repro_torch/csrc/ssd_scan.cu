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
// (B,H,P,N); with no init_state it is ssd_scan_pallas. When the op needs a
// gradient (kernels/ssd_scan/ops.py's SSDScan) it also writes the state
// entering each 64-token tile, (B, ceil(L/64), H, P, N) fp32, which the
// backward (csrc/ssd_scan_bwd.cu) reads: a template flag of both kernels,
// so serving's instantiations, which write none, compile as before (a
// run-time branch cost the mma kernel's registers 13-25% at mamba2's
// prefills).
//
// What bounds it on the card: bytes at the serving shapes. A (row, head)
// reads its L x P inputs once and writes L x P outputs in fp32, plus the
// P x N state in and out; with 64-token blocks it does about
// 2*64*(N+P)/2 + 4*N*P flops per token and head, so at mamba2's widths
// (P 64, N 128, 2 bytes in and 4 out per element) about 120 flops per byte,
// under the H100's bf16 ridge of ~295. Short calls are set by launch
// latency, the number of blocks in flight and the serial walk over tiles.
//
// Both kernels walk the sequence in tiles of kT = 64 tokens whatever the
// model's chunk length: the SSD output does not depend on the chunk length,
// only its rounding does (the reference's test_chunk_size_invariance), and
// a 256-token chunk's C.B^T alone would be 256 KB in fp32. The TPU grid
// (B*H, chunks) carries the state in VMEM along its sequential chunk axis;
// here a block walks its tiles in order with the state on chip. B and C are
// read per group (head h reads group h / (H / G)), so the reference's repeat
// over heads is never materialised; tokens past L are loaded as zeros with
// dt = 0, which leaves the state untouched, as padded tokens do in the
// reference; x, B and C are read with row strides (batch, token) so the
// model's slices of its conv output need no copy (the last two dims of each
// contiguous). The host-side plan (kernels/ssd_scan/kernel.py's _plan)
// picks one of two kernels:
//
//  - mma (bf16 x, B and C): mma.sync.m16n8k16 tiles, fp32 accumulation.
//    Column p of y and of the state depends only on x[:, p] and S[:, p], so
//    a block takes pb = 16, 32 or 64 columns of P of one (row, head), grid
//    (H * ceil(P / pb), B) (a block a (row, head), as the tiled kernel
//    takes, leaves half the card idle at a one-row prefill). Each block
//    stages its tile's whole B and C and recomputes C.B^T, the price of
//    the split (no workspace, no second launch), so the plan takes the
//    widest pb whose grid still puts a block on 3/4 of the SMs
//    (chip_tune.py: the B / C copies, which every block repeats, cost more
//    than the extra blocks gain). 4 warps, 16 token rows each. Per
//    tile: each warp scans dt*A in log2 units (2^x is one ex2.approx), then
//      (1) y_off = C S_prev, S_prev staged in shared memory as hi + lo bf16;
//      (2) S <- 2^cum_last S + B^T (w x), w_j = 2^(cum_last - cum_j) dt_j,
//          w x as hi + lo parts; S (N x pb) stays in fp32 accumulator
//          registers across tiles, spread over the 4 warps;
//      (3) scores C B^T of the warp's rows against the keys up to its
//          diagonal (key tiles above it are skipped);
//      then, while the next tile's B and C (one buffer) and x and dt (two
//      buffers) load by cp.async, zero-filled past L and past P / N:
//      (4) M_ij = scores 2^(cum_i - cum_j) dt_j for j <= i in registers,
//          the decay taken only there (its exponent <= 0);
//      (5) y = M x + 2^cum_i y_off, M entering as hi + lo bf16 parts made
//          from the score fragments, y written in fp32.
//    Each product is summed from zero over the tile (lo parts first) and
//    added in fp32 (mma.sync truncates as it accumulates). The hi + lo
//    parts are each rounded to nearest: hi + lo is within 2^-17 of the
//    fp32 value, so the scan keeps fp32-like rounding (y and the state
//    within 1e-4 of the fp32 plain version; M as its hi part alone misses
//    that). A block holds at most 90.5 KB of
//    shared memory (pb 64, N 128) and 2 blocks share a SM at every shape
//    (__launch_bounds__ (128, 2): up to 255 registers, 80 bytes of spills
//    at pb 64 and N 128, none elsewhere). No
//    atomics: repeats are bit-equal. A row start that is not 16 bytes
//    aligned (P or N not a multiple of 8, or an odd stride) is staged with
//    2-byte loads instead of cp.async. What bounds it (chip_tune.py's
//    timeline of one block): the serial walk, ~6900 cycles a tile at a
//    4096-token prefill, of which the B / C copies (issued by every block
//    of every head) and the barrier before them take ~1/4, the scores 1/5.
//  - tiled (fp32: it stays IEEE fp32 on the CUDA cores), the port's first
//    kernel, kept as it was: one block of 256 threads per (row, head), the
//    N x P state in shared memory (32 KB at mamba2 width), per tile the
//    masked 64 x 64 score tile (4 x 4 entries a thread), y = M x + e^{cum}
//    C.S (4 rows x 4 columns a thread, the j loop cut at the thread's last
//    row) and the state update (8 x 4 entries a thread). About 137 KB of
//    shared memory at mamba2 width: one block per SM.

#include "gemm_common.cuh"   // cp_async16 / cp_async4, ldmatrix_x4[_trans], mma_bf16,
                              // ex2, split_rn, aligned_rows

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

template <typename T, bool STATES>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ init_state,
    float* __restrict__ y, float* __restrict__ final_state, float* __restrict__ states, Dims d) {
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
    if constexpr (STATES) {  // the state entering this tile
      const size_t tile = static_cast<size_t>(b) * ((L + kT - 1) / kT) + t0 / kT;
      float* so = states + (tile * H + h) * P * N;
      for (int i = tid; i < P * N; i += kThreads) so[i] = ss[(i % N) * PP + i / N];
    }
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
int launch_tiled(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init_state, float* y, float* final_state, float* states, int B,
           const Dims& d, cudaStream_t stream) {
  const int bytes = smem_floats(d.PP, d.NP) * static_cast<int>(sizeof(float));
  static bool configured = false;  // the attribute is set once per instantiation, to the most
  if (!configured) {               // any supported shape needs
    for (auto kernel : {ssd_scan_kernel<T, false>, ssd_scan_kernel<T, true>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_floats(kMaxP, kMaxN) * static_cast<int>(sizeof(float)));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured = true;
  }
  const dim3 grid(d.H, B);
  const auto kernel = states != nullptr ? ssd_scan_kernel<T, true> : ssd_scan_kernel<T, false>;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, y, final_state, states, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- mma path
constexpr int kMmaThreads = 128;   // 4 warps, 16 token rows of a tile each
constexpr int kPad = 8;            // bf16 padding of a staged row: ldmatrix rows on distinct banks
constexpr int kMaxNk = kMaxN / 16;
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The shape of a block of pb = PB columns over N padded to 16 NK: its
// fragments, the state's split over the 4 warps and the shared memory (at
// most 90.5 KB, at pb 64 and N 128: 2 blocks a SM at every shape).
template <int PB, int NK>
struct MmaShape {
  static constexpr int NT = PB / 8;               // n8 tiles of the block's columns
  static constexpr int XR = PB + kPad;            // bf16 elements a staged x / state row
  static constexpr int NR = NK * 16 + kPad;       // a staged B / C row
  static constexpr int WN = NT < 4 ? NT : 4;      // warps across the state's n8 tiles
  static constexpr int WM = 4 / WN;               // and across its m16 tiles
  static constexpr int TN = NT / WN;              // n8 tiles of the state a warp holds
  static constexpr int TM = (NK + WM - 1) / WM;   // m16 tiles (the last warps' may run past NK)
  // byte offsets: x [2][kT][XR] (two buffers), B and C [kT][NR], the
  // staged state's hi and lo parts [16 NK][XR], dt [2][kT] fp32, then each
  // warp's cum and w [4][2][kT] fp32
  static constexpr int kX = 0;
  static constexpr int kB = kX + 2 * kT * XR * 2;
  static constexpr int kC = kB + kT * NR * 2;
  static constexpr int kSh = kC + kT * NR * 2;
  static constexpr int kSl = kSh + 16 * NK * XR * 2;
  static constexpr int kDt = kSl + 16 * NK * XR * 2;
  static constexpr int kW = kDt + 2 * kT * 4;
  static constexpr int kBytes = kW + 4 * 2 * kT * 4;
};

// grid (H * ceil(P / PB), B): block x = head * ceil(P / PB) + column block.
// vec: every row start of x, B and C is 16 bytes aligned, P and N multiples
// of 8 (cp.async); else 2-byte loads. STATES: write the tiles' entry states.
template <int PB, int NK, bool STATES>
__global__ void __launch_bounds__(kMmaThreads, 2) ssd_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ init_state, float* __restrict__ y, float* __restrict__ final_state,
    float* __restrict__ states, Dims d, int vec) {
  using S = MmaShape<PB, NK>;
  constexpr int NT = S::NT, XR = S::XR, NR = S::NR, TN = S::TN, TM = S::TM;
  constexpr bool kAllMt = S::TM * S::WM == NK;   // every warp's m16 tiles lie below NK
  extern __shared__ __align__(16) unsigned char smem_mma[];
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kX);
  auto* bt = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kB);
  auto* ct = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kC);
  auto* sh = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kSh);
  auto* sl = reinterpret_cast<__nv_bfloat16*>(smem_mma + S::kSl);
  auto* dts = reinterpret_cast<float*>(smem_mma + S::kDt);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gc = lane % 4;   // an accumulator fragment's row and column pair
  const int H = d.H, P = d.P, N = d.N, L = d.L;
  const int npb = (P + PB - 1) / PB;
  const int h = blockIdx.x / npb, p0 = blockIdx.x % npb * PB, b = blockIdx.y;
  const int g = h / (H / d.G);
  const int xcols = min(PB, P - p0);   // the block's live columns
  const float a2 = A[h] * kLog2e;      // dt * A in log2 units
  // this warp's copies of cum and w_j = 2^(cum_last - cum_j) dt_j
  float* cum = reinterpret_cast<float*>(smem_mma + S::kW) + warp * 2 * kT;
  float* w = cum + kT;
  const __nv_bfloat16* xrow = x + b * d.sxb + static_cast<long long>(h) * P + p0;
  const __nv_bfloat16* brow = Bm + b * d.sbb + static_cast<long long>(g) * N;
  const __nv_bfloat16* crow = Cm + b * d.scb + static_cast<long long>(g) * N;
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N;
  const int tiles = (L + kT - 1) / kT;
  // the warp's share of the state: m16 tiles wm * TM + u, n8 tiles wn * TN + v
  const int wm = warp / S::WN, wn = warp % S::WN;

  // Stage tile t: B and C, x and dt in buffer t & 1; zeros past L (dt = 0
  // there) and past P / N
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  auto load = [&](int t) {
    const int t0 = t * kT;
    __nv_bfloat16* xd = xs + (t & 1) * kT * XR;
    if (vec) {
      for (int i = tid; i < kT * NT; i += kMmaThreads) {
        const int r = i / NT, c = i % NT * 8;
        const bool ok = t0 + r < L && c < xcols;
        cp_async16(xd + r * XR + c, ok ? xrow + (t0 + r) * d.sxt + c : xrow, ok ? 16 : 0);
      }
      for (int i = tid; i < kT * 2 * NK; i += kMmaThreads) {
        const int r = i / (2 * NK), c = i % (2 * NK) * 8;
        const bool ok = t0 + r < L && c < N;
        cp_async16(bt + r * NR + c, ok ? brow + (t0 + r) * d.sbt + c : brow, ok ? 16 : 0);
        cp_async16(ct + r * NR + c, ok ? crow + (t0 + r) * d.sct + c : crow, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kT * PB; i += kMmaThreads) {
        const int r = i / PB, c = i % PB;
        xd[r * XR + c] = t0 + r < L && c < xcols ? xrow[(t0 + r) * d.sxt + c] : zero;
      }
      for (int i = tid; i < kT * 16 * NK; i += kMmaThreads) {
        const int r = i / (16 * NK), c = i % (16 * NK);
        const bool ok = t0 + r < L && c < N;
        bt[r * NR + c] = ok ? brow[(t0 + r) * d.sbt + c] : zero;
        ct[r * NR + c] = ok ? crow[(t0 + r) * d.sct + c] : zero;
      }
    }
    float* dd = dts + (t & 1) * kT;
    if (tid < kT) {
      if (t0 + tid < L)
        cp_async4(dd + tid, dt + (static_cast<size_t>(b) * L + t0 + tid) * H + h);
      else
        dd[tid] = 0.f;
    }
    cp_async_commit();
  };

  // the state S[n][p], fp32, from init_state (or zeros); zero past N and P
  float sacc[TM][TN][4];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (wm * TM + u) * 16 + gr + 8 * (e >> 1);
        const int p = p0 + (wn * TN + v) * 8 + 2 * gc + (e & 1);
        sacc[u][v][e] = init_state != nullptr && n < N && p < P
                            ? init_state[st_off + static_cast<size_t>(p) * N + n] : 0.f;
      }
  // the state as hi + lo bf16 parts in shared memory, [n][p], for C S
  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int mt = wm * TM + u;
      if (!kAllMt && mt >= NK) continue;
#pragma unroll
      for (int v = 0; v < TN; ++v)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (mt * 16 + gr + 8 * hh) * XR + (wn * TN + v) * 8 + 2 * gc;
          unsigned hi, lo;
          split_rn(sacc[u][v][2 * hh], sacc[u][v][2 * hh + 1], hi, lo);
          *reinterpret_cast<unsigned*>(sh + off) = hi;
          *reinterpret_cast<unsigned*>(sl + off) = lo;
        }
    }
  };

  if (tiles > 0) load(0);
  stage();
  const int i0 = warp * 16 + gr;   // the thread's rows of a tile: i0 and i0 + 8
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * kT;
    if constexpr (STATES) {  // the state entering this tile, from the registers
      float* so = states + ((static_cast<size_t>(b) * tiles + t) * H + h) * P * N;
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = (wm * TM + u) * 16 + gr + 8 * (e >> 1);
            const int p = p0 + (wn * TN + v) * 8 + 2 * gc + (e & 1);
            if (n < N && p < P) so[static_cast<size_t>(p) * N + n] = sacc[u][v][e];
          }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t and the staged state visible to every thread
    __syncthreads();
    const __nv_bfloat16* xt = xs + (t & 1) * kT * XR;
    const float* dtt = dts + (t & 1) * kT;

    // inclusive scan of dt A over the tile in log2 units, two tokens a
    // lane, each warp its own copy
    float total;
    {
      const float2 d2 = *reinterpret_cast<const float2*>(dtt + 2 * lane);
      const float a0 = d2.x * a2, a1 = a0 + d2.y * a2;
      float s = a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(~0u, s, o);
        if (lane >= o) s += v;
      }
      float excl = __shfl_up_sync(~0u, s, 1);   // the sum of the lanes before
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = excl + a1;
      const float last = __shfl_sync(~0u, c1, 31);
      *reinterpret_cast<float2*>(cum + 2 * lane) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(w + 2 * lane) =
          make_float2(ex2(last - c0) * d2.x, ex2(last - c1) * d2.y);
      total = ex2(last);
      __syncwarp();
    }

    // (1) y_off = C S_prev from zero: C of the warp's 16 rows as A
    // fragments, S_prev's lo and hi parts as B fragments of two n8 tiles
    // from [n][p], transposed by ldmatrix
    float yo[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned ca[4];
      ldmatrix_x4(ca, ct + (warp * 16 + lane % 16) * NR + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        const int off = (kk * 16 + lane % 16) * XR + dp * 16 + lane / 16 * 8;
        unsigned rl[4], rh[4];
        ldmatrix_x4_trans(rl, sl + off);
        ldmatrix_x4_trans(rh, sh + off);
        const unsigned l0[2] = {rl[0], rl[1]}, l1[2] = {rl[2], rl[3]};
        const unsigned h0[2] = {rh[0], rh[1]}, h1[2] = {rh[2], rh[3]};
        mma_bf16(yo[2 * dp], ca, l0);
        mma_bf16(yo[2 * dp + 1], ca, l1);
        mma_bf16(yo[2 * dp], ca, h0);
        mma_bf16(yo[2 * dp + 1], ca, h1);
      }
    }

    // (2) S <- 2^cum_last S + B^T (w x) in registers (C S above read the
    // staged copy). The B operand, w_j x_j of the warp's n8 tiles in hi +
    // lo parts, for the 4 k16 steps over the tile's tokens (fragment:
    // tokens 2 gc, 2 gc + 1 and + 8, column gr)
    {
      unsigned xh[4][TN][2], xl[4][TN][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = kk * 16 + 2 * gc;
        const float2 w01 = *reinterpret_cast<const float2*>(w + j);
        const float2 w89 = *reinterpret_cast<const float2*>(w + j + 8);
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          unsigned r[2];
          ldmatrix_x2_trans(r, xt + (kk * 16 + lane % 16) * XR + (wn * TN + v) * 8);
          split_rn(lo_f32(r[0]) * w01.x, hi_f32(r[0]) * w01.y, xh[kk][v][0], xl[kk][v][0]);
          split_rn(lo_f32(r[1]) * w89.x, hi_f32(r[1]) * w89.y, xh[kk][v][1], xl[kk][v][1]);
        }
      }
      // A = B^T from B [token][n], transposed by ldmatrix: matrices (n 0-7 |
      // 8-15) x (tokens 0-7 | 8-15); the tile's product summed from zero
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int mt = wm * TM + u;
        if (!kAllMt && mt >= NK) continue;
        float sd[TN][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned a[4];
          ldmatrix_x4_trans(a, bt + (kk * 16 + lane / 16 * 8 + lane % 8) * NR + mt * 16 +
                                   lane / 8 % 2 * 8);
#pragma unroll
          for (int v = 0; v < TN; ++v) {
            mma_bf16(sd[v], a, xl[kk][v]);
            mma_bf16(sd[v], a, xh[kk][v]);
          }
        }
#pragma unroll
        for (int v = 0; v < TN; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[u][v][e] = fmaf(total, sacc[u][v][e], sd[v][e]);
      }
    }

    // (3) scores C B^T of the warp's rows against keys 0 .. 16 warp + 15
    // (key tiles above the diagonal are skipped). B fragments of two n8
    // tiles from B [key][n]: matrices (keys 0-7 | 8-15) x (n 0-7 | 8-15)
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned ca[4];
      ldmatrix_x4(ca, ct + (warp * 16 + lane % 16) * NR + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) continue;
        unsigned r[4];
        ldmatrix_x4(r, bt + (np * 16 + lane / 16 * 8 + lane % 8) * NR + kk * 16 +
                           lane / 8 % 2 * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[2 * np], ca, b0);
        mma_bf16(s[2 * np + 1], ca, b1);
      }
    }

    // B, C and the staged state are read: stage the new state and start
    // the next tile's copies, which run under the rest of this tile
    if (t + 1 < tiles) {
      __syncthreads();
      stage();
      load(t + 1);
    }

    // (4) M_ij = scores 2^(cum_i - cum_j) dt_j for j <= i, else 0: the
    // decay is taken only there, where its exponent is <= 0. Fragment (n8
    // tile nt, e): row i0 + 8 (e / 2), key 8 nt + 2 gc + e % 2
    const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt / 2 > warp) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * gc + (e & 1), i = i0 + 8 * (e >> 1);
        s[nt][e] = j <= i ? s[nt][e] * ex2(ci[e >> 1] - cum[j]) * dtt[j] : 0.f;
      }
    }

    // (5) y_diag = M x from zero over key tiles 0 .. warp, M as the A
    // operand in hi + lo parts (the fragments of n8 tiles 2 j and 2 j + 1
    // are exactly A's registers), x as B fragments from [key][p]
    float yd[NT][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > warp) continue;
      unsigned mh[4], ml[4];
      split_rn(s[2 * j][0], s[2 * j][1], mh[0], ml[0]);
      split_rn(s[2 * j][2], s[2 * j][3], mh[1], ml[1]);
      split_rn(s[2 * j + 1][0], s[2 * j + 1][1], mh[2], ml[2]);
      split_rn(s[2 * j + 1][2], s[2 * j + 1][3], mh[3], ml[3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        unsigned r[4];
        ldmatrix_x4_trans(r, xt + (j * 16 + lane % 16) * XR + dp * 16 + lane / 16 * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(yd[2 * dp], ml, b0);
        mma_bf16(yd[2 * dp + 1], ml, b1);
        mma_bf16(yd[2 * dp], mh, b0);
        mma_bf16(yd[2 * dp + 1], mh, b1);
      }
    }
    // y = y_diag + 2^cum_i y_off, fp32, rows below L and columns below P
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + 8 * hh;
      if (t0 + i >= L) continue;
      const float e = ex2(ci[hh]);
      float* yr = y + ((static_cast<size_t>(b) * L + t0 + i) * H + h) * P + p0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int p = nt * 8 + 2 * gc;
        if (p >= xcols) continue;
        const float v0 = fmaf(e, yo[nt][2 * hh], yd[nt][2 * hh]);
        const float v1 = fmaf(e, yo[nt][2 * hh + 1], yd[nt][2 * hh + 1]);
        if ((P & 1) == 0) {
          *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
        } else {
          yr[p] = v0;
          if (p + 1 < xcols) yr[p + 1] = v1;
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (wm * TM + u) * 16 + gr + 8 * (e >> 1);
        const int p = p0 + (wn * TN + v) * 8 + 2 * gc + (e & 1);
        if (n < N && p < P) final_state[st_off + static_cast<size_t>(p) * N + n] = sacc[u][v][e];
      }
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init_state;
  float* y;
  float* final_state;
  float* states;
};

template <int PB, int NK, bool STATES>
int launch_mma(const Args& a, int B, const Dims& d, int vec, cudaStream_t stream) {
  constexpr int bytes = MmaShape<PB, NK>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_mma_kernel<PB, NK, STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(d.H * ((d.P + PB - 1) / PB), B);
  ssd_mma_kernel<PB, NK, STATES><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.dt, a.A, static_cast<const __nv_bfloat16*>(a.Bm),
      static_cast<const __nv_bfloat16*>(a.Cm), a.init_state, a.y, a.final_state, a.states, d,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn with integral constants PB and NK for a runtime pb (16, 32, 64)
// and nk (1, 2, 4, 8); -1 for any other.
template <typename Fn>
int dispatch_shape(int pb, int nk, Fn&& fn) {
  auto with_nk = [&](auto pbc) {
    switch (nk) {
      case 1: return fn(pbc, std::integral_constant<int, 1>{});
      case 2: return fn(pbc, std::integral_constant<int, 2>{});
      case 4: return fn(pbc, std::integral_constant<int, 4>{});
      case 8: return fn(pbc, std::integral_constant<int, 8>{});
      default: return -1;
    }
  };
  switch (pb) {
    case 16: return with_nk(std::integral_constant<int, 16>{});
    case 32: return with_nk(std::integral_constant<int, 32>{});
    case 64: return with_nk(std::integral_constant<int, 64>{});
    default: return -1;
  }
}

enum Path : int { kTiled = 0, kMma = 1 };

}  // namespace

// The constants the wrapper mirrors, in this order: tokens a tile, the
// largest P and N.
extern "C" void ssd_scan_constants(int* c) {
  c[0] = kT;
  c[1] = kMaxP;
  c[2] = kMaxN;
}

// Returns the CUDA error of the launch (0 on success), -1 for an unsupported
// path, dtype or shape. path: 0 tiled (fp32), 1 mma (bf16, pb columns of P
// a block, N padded to 16 nk). Layouts: x (B, L, H, P) with row
// strides sxb / sxt; B and C (B, L, G, N) with row strides sbb / sbt and
// scb / sct (the last two dims of each contiguous); dt (B, L, H) fp32
// contiguous; A (H,) fp32; init_state (B, H, P, N) fp32 or null (zeros); y
// (B, L, H, P) fp32 and final_state (B, H, P, N) fp32, contiguous; states
// (B, ceil(L / 64), H, P, N) fp32 contiguous, the state entering each tile,
// or null (not written).
extern "C" int ssd_scan_launch(int path, int pb, int nk, const void* x, const float* dt,
                               const float* A, const void* Bm, const void* Cm,
                               const float* init_state, float* y, float* final_state,
                               float* states, int B,
                               int L, int H, int P, int N, int G, long long sxb, long long sxt,
                               long long sbb, long long sbt, long long scb, long long sct,
                               int dtype, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || G < 1 || H % G != 0 || B < 1 || L < 0)
    return -1;
  const Dims d{L, H, P, N, G, (P + 3) / 4 * 4, (N + 7) / 8 * 8, sxb, sxt, sbb, sbt, scb, sct};
  auto s = static_cast<cudaStream_t>(stream);
  if (path == kTiled && dtype == kFloat32)
    return launch_tiled<float>(x, dt, A, Bm, Cm, init_state, y, final_state, states, B, d, s);
  if (path != kMma || dtype != kBFloat16 || 16 * nk < N || nk > kMaxNk) return -1;
  const int vec = P % 8 == 0 && N % 8 == 0 && aligned_rows(x, sxb, sxt, B, L) &&
                  aligned_rows(Bm, sbb, sbt, B, L) && aligned_rows(Cm, scb, sct, B, L);
  const Args a{x, dt, A, Bm, Cm, init_state, y, final_state, states};
  return dispatch_shape(pb, nk, [&](auto pbc, auto nkc) {
    constexpr int PB = decltype(pbc)::value, NK = decltype(nkc)::value;
    return states != nullptr ? launch_mma<PB, NK, true>(a, B, d, vec, s)
                             : launch_mma<PB, NK, false>(a, B, d, vec, s);
  });
}
