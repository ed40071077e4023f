// Blocked causal flash attention with per-query stats, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_prefill.py:
// flash_prefill (_kernel, _kernel_stats with return_stats=True).
//
// What it computes: q [S, Hq, D] against k, v [S, H, D] (f32), GQA mapping
// q head h to kv head h / (Hq / H), a causal mask, an optional sliding
// window, and an optional key count n_valid (keys at index >= n_valid are
// masked: this is kernels/ref.flash_prefill_stats_ref with
// kv_valid = arange(S) < n_valid, which the serving engine's g-sized
// prefill chunks need).  It writes out [S, Hq, D] and the flash stats
// m, l [S, Hq] for the merge with the paged-pool partition.
//
// What bounds it at the engine's shapes (S 128 for a big chunk, S 16 with
// n_valid <= 16 for a g-chunk; Hq 32, H 8, D 128): neither bytes (~1 MB)
// nor operations (~0.13 GFLOP, 0.002 ms at 67 TFLOP/s) but latency: the
// launch, the loads of the last query tile's 128 keys and its serial
// softmax.  The first design (one block per q head and 32-query tile,
// every K/V tile loaded once per q head, dot products over shared memory
// on CUDA cores, four barriers per key tile, the accumulator
// round-tripping through shared memory) took 0.125 ms at S 128, 6.6x SDPA.
//
// Design: a row is one (query, q head) pair; the GQ q heads of a kv head
// are contiguous in q, so one block of 16 rows (4 queries x 4 heads at
// r1-llama-8b, no padding to a query tile: at S 16 a kv head's 64 rows fill
// 4 blocks exactly) holds every q head of its queries and loads each key
// once for all of them.  The block's 8 warps split the keys, 8 each per
// 64-key tile, so the causal diagonal's longest rows are spread over the
// SM's four schedulers; each warp keeps its scores, probabilities,
// running (m, l) and output accumulator in registers (mma fragments, row
// max and sum reduced over the 4 lanes of a row by shuffles), and the
// warps' partials are merged once at the end through shared memory, as
// the reference merges two partitions.  Both products run on the tensor
// cores in f64 (f64_mma.cuh: exact products, 53-bit sums).  q and the
// tile's keys arrive by cp.async (zero-filled past S), only up to the
// block's causal, n_valid and window range; warps whose 8 keys fall
// outside it skip the tile.  Blocks run longest rows first; registers are
// capped for two blocks per SM.  The dynamic shared memory attribute is
// set once per instantiation.
//
// Head_dim 256 (paligemma-3b): the output accumulator of 16 rows x D
// columns (o[D / 8][4] a thread) would take 128 registers at D 256 on top
// of the D 128 instance's 128, so a block owns DV = 128 of the output's
// columns: the grid gains a third axis of D / DV column slices, each block
// computes the scores over all D (the product Q.K^T is repeated once per
// slice) and loads and accumulates only its slice of V.  Its shared memory
// holds q and K at D and V at DV (117 KB: one block per SM).  The blocks
// of a row write equal m and l; the first slice stores them.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase on an H100): D 256: 229
// registers (one block per SM, no cap below 255), no spills; D 128: 128
// registers, 20 bytes of spill stores and loads; D 64: 128 registers,
// 8 / 4 bytes; D 32: 96, D 16: 72 registers, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "f64_mma.cuh"

#define NEG_INF (-1e30f)
#define WARPS 8
#define THREADS (WARPS * 32)
#define ROWS 16                 // (query, q head) rows per block
#define KPW 8                   // keys per warp and tile
#define BK (WARPS * KPW)        // keys per tile: warp w takes [8w, 8w + 8)

template <int D>
struct Layout {
  static constexpr int DV = out_cols(D);
  static constexpr int LD = D + 4;          // row stride (floats): no bank
  static constexpr int LDV = DV + 4;        // conflicts on fragment loads
  static constexpr int Q = ROWS * LD;
  static constexpr int KV = BK * LD + BK * LDV;   // a tile's k, then v
  static constexpr int MLD = DV + 8;        // row stride of the merge
  static constexpr int PART = ROWS * MLD + 2 * ROWS;   // one warp's o, m, l
  static constexpr int KVM = KV > WARPS * PART ? KV : WARPS * PART;
  static constexpr int BYTES = (Q + KVM) * 4;   // q, then k, v or the merge
};

template <int D>
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ mo, float* __restrict__ lo, int S,
                     int Hq, int H, int causal, int window, int n_valid,
                     float scale) {
  using LY = Layout<D>;
  constexpr int LD = LY::LD, LDV = LY::LDV, DV = LY::DV, NT = DV / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + LY::Q;
  float* vs = ks + BK * LD;

  const int GQ = Hq / H;
  const int hk = blockIdx.x;
  const int col0 = blockIdx.z * DV;          // this block's output columns
  // the longest rows (last queries: most keys under causality) first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int nrows = S * GQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvalid = min(S, n_valid);

  // keys [lo, hi) a row attends; a row past S attends none
  auto key_hi = [&](int r) {
    if (r >= nrows) return 0;
    return causal ? min(kvalid, r / GQ + 1) : kvalid;
  };
  auto key_lo = [&](int r) {
    return window > 0 ? r / GQ - window + 1 : 0;
  };
  const int b_hi = key_hi(min(row0 + ROWS, nrows) - 1);
  const int b_lo = key_lo(row0);
  const int t_lo = max(0, b_lo) / KPW * KPW;
  const int ntiles = b_hi > t_lo ? (b_hi - t_lo + BK - 1) / BK : 0;

  // the rows of tile it the block attends (whole 8-key warp spans; zero
  // past S), by cp.async
  auto load_tile = [&](int it) {
    const int k0 = t_lo + it * BK;
    const int rows = min(BK, (b_hi - k0 + KPW - 1) / KPW * KPW);
    constexpr int CPR = D / 4, CPV = DV / 4;   // 16-byte chunks per row
    for (int c = tid; c < rows * CPR; c += THREADS) {   // k: all of D
      const int j = c / CPR, d = (c % CPR) * 4;
      const bool in = k0 + j < S;
      cp_async16(ks + j * LD + d,
                 k + ((size_t)(in ? k0 + j : 0) * H + hk) * D + d, in);
    }
    for (int c = tid; c < rows * CPV; c += THREADS) {   // v: this block's
      const int j = c / CPV, d = (c % CPV) * 4;         // columns
      const bool in = k0 + j < S;
      cp_async16(vs + j * LDV + d,
                 v + ((size_t)(in ? k0 + j : 0) * H + hk) * D + col0 + d,
                 in);
    }
    cp_async_commit();
  };
  // the block's q rows (zero past S) arrive with the first tile
  if (ntiles > 0) {
    for (int c = tid; c < ROWS * (D / 4); c += THREADS) {
      const int i = c / (D / 4), d = (c % (D / 4)) * 4;
      const int r = min(row0 + i, nrows - 1);
      cp_async16(qs + i * LD + d,
                 q + ((size_t)(r / GQ) * Hq + hk * GQ + r % GQ) * D + d,
                 row0 + i < nrows);
    }
    load_tile(0);
  }

  // this lane's rows a = g and b = g + 8 of the block
  const int ra = row0 + g, rb = ra + 8;
  const int hi_a = key_hi(ra), hi_b = key_hi(rb);
  const int lo_a = key_lo(ra), lo_b = key_lo(rb);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it > 0) {
      __syncthreads();                        // the last tile is consumed
      load_tile(it);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int kw = t_lo + it * BK + KPW * warp;   // this warp's 8 keys
    if (kw < b_hi && kw + KPW > b_lo) {
      const float* kb = ks + (KPW * warp + g) * LD + t;
      const float* vb = vs + (KPW * warp + 2 * t) * LDV + g;
      // scores in f64 (exact products, 53-bit sums)
      double sd[4] = {0.0, 0.0, 0.0, 0.0};
      const float* qa = qs + g * LD + t;
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        double a[8], b[4];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = qa[(e % 2) * 8 * LD + k0 + 4 * (e / 2)];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = kb[k0 + 4 * j];
        mma_f64(sd, a, b);
      }
      // mask, scale, online softmax over the rows a and b
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + 2 * t + (e & 1);
        const bool ok = e < 2 ? key >= lo_a && key < hi_a
                              : key >= lo_b && key < hi_b;
        s[e] = ok ? (float)sd[e] * scale : NEG_INF;
      }
      float mx_a = fmaxf(m_a, fmaxf(s[0], s[1]));
      float mx_b = fmaxf(m_b, fmaxf(s[2], s[3]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float c_a = expf(m_a - mx_a), c_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mx = e < 2 ? mx_a : mx_b;
        s[e] = s[e] > 0.5f * NEG_INF ? expf(s[e] - mx) : 0.f;
      }
      l_a = l_a * c_a + s[0] + s[1];
      l_b = l_b * c_b + s[2] + s[3];
      // o += P V in f64, the warp's 8 keys as one k step in the order
      // (0, 2, 4, 6, 1, 3, 5, 7)
      const double pa[4] = {s[0], s[2], s[1], s[3]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const double b[2] = {vb[n * 8], vb[n * 8 + LDV]};
        double od[4] = {0.0, 0.0, 0.0, 0.0};
        mma_f64_k8(od, pa, b);
        o[n][0] = o[n][0] * c_a + (float)od[0];
        o[n][1] = o[n][1] * c_a + (float)od[1];
        o[n][2] = o[n][2] * c_b + (float)od[2];
        o[n][3] = o[n][3] * c_b + (float)od[3];
      }
    }
  }

  // merge the warps' partials (o, m, l) of the 16 rows through shared
  // memory (the k/v tile, free after the barrier), as the reference merges
  // two partitions
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  __syncthreads();
  constexpr int MLD = LY::MLD;
  float* part = ks + warp * LY::PART;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(part + g * MLD + n * 8 + 2 * t) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * MLD + n * 8 + 2 * t) =
        make_float2(o[n][2], o[n][3]);
  }
  if (t == 0) {
    part[ROWS * MLD + g] = m_a;
    part[ROWS * MLD + g + 8] = m_b;
    part[ROWS * MLD + ROWS + g] = l_a;
    part[ROWS * MLD + ROWS + g + 8] = l_b;
  }
  __syncthreads();
  constexpr int TPR = THREADS / ROWS;          // threads per row
  constexpr int CPT = DV / TPR;                // columns per thread
  const int row = tid / TPR, c0 = tid % TPR;   // columns c0 + TPR i
  const int r = row0 + row;
  if (r >= nrows) return;
  const float* stats = ks + ROWS * MLD;
  float M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, stats[w * LY::PART + row]);
  float wt[WARPS], L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = expf(stats[w * LY::PART + row] - M);
    L += wt[w] * stats[w * LY::PART + ROWS + row];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const size_t orow = (size_t)(r / GQ) * Hq + hk * GQ + r % GQ;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      acc = fmaf(wt[w], ks[w * LY::PART + row * MLD + c0 + TPR * c], acc);
    out[orow * D + col0 + c0 + TPR * c] = acc * inv;
  }
  if (tid % TPR == 0 && blockIdx.z == 0) {
    mo[orow] = M;
    lo[orow] = L;
  }
}

template <int D>
static int launch(const float* q, const float* k, const float* v, float* out,
                  float* mo, float* lo, int S, int Hq, int H, int causal,
                  int window, int n_valid, float scale, cudaStream_t stream) {
  static int granted = 0;
  cudaError_t err =
      allow_smem(flash_prefill_kernel<D>, Layout<D>::BYTES, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (S * (Hq / H) + ROWS - 1) / ROWS, D / out_cols(D));
  flash_prefill_kernel<D><<<grid, THREADS, Layout<D>::BYTES, stream>>>(
      q, k, v, out, mo, lo, S, Hq, H, causal, window, n_valid, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_prefill_stats(const void* q, const void* k,
                                   const void* v, void* out, void* mo,
                                   void* lo, int S, int Hq, int H, int D,
                                   int causal, int window, int n_valid,
                                   float scale, void* stream) {
  if (S <= 0) return 0;
  auto f = [&](auto fn) {
    return fn((const float*)q, (const float*)k, (const float*)v, (float*)out,
              (float*)mo, (float*)lo, S, Hq, H, causal, window, n_valid,
              scale, (cudaStream_t)stream);
  };
  switch (D) {
    case 16: return f(launch<16>);
    case 32: return f(launch<32>);
    case 64: return f(launch<64>);
    case 128: return f(launch<128>);
    case 256: return f(launch<256>);
    default: return (int)cudaErrorInvalidValue;
  }
}
