// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/mamba_scan.py: mamba_scan
// (_kernel).  For every batch row and channel d, from h_0 = 0:
//
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n]
//
// x, dt, y [Bsz, S, di]; b, c [Bsz, S, N]; a [di, N]; f32 throughout.  This
// is kernels/ref.mamba_scan_ref (expf, not __expf).
//
// On the TPU the state h [d_blk, N] sits in VMEM scratch and carries across
// the sequential s-chunk grid axis.  Thread blocks on Hopper run in no
// order, so the time loop runs inside the block and h never leaves
// registers.
//
// Bound on this card: the larger of the bytes (x, dt and y: 12 B per (t, d),
// plus B and C rows and A, each read or written once) over 3.35 TB/s, and
// the S * di * N exponentials on the special-function units (16 per SM per
// clock).  At falcon-mamba-7b's prefill shape (Bsz 4, S 1024, di 8192,
// N 16) both are near 0.13 ms.  The first design ran one thread per
// (batch row, channel) holding all 16 state lanes: 32,768 threads, about
// two warps per scheduler, too few to hide the latency of a step's 16
// exponentials, its B/C loads and its serial 16-term sum for y; it took
// 0.93 ms on an H100 (7.3x the bound).  This design:
//   * splits a channel's N <= 16 state lanes over LANES = 2 neighbouring
//     threads (8 lanes each, with their A and h in registers): 65,536
//     threads, one wave of blocks of 32 channels; y_t is each thread's
//     8-term partial sum plus its neighbour's (one shuffle).  Four or
//     eight threads per channel were tried and were slower: each step's
//     shuffles and loads are paid per thread;
//   * stages, per block, CHUNK = 16 time steps of x and dt (32 channels
//     each) and of the B and C rows by cp.async (16-byte copies where di
//     and N are multiples of 4, else 4-byte ones; zero past S, di and N)
//     into a ring of three stages, two chunks ahead, with one barrier per
//     chunk; a thread makes the same copies every chunk, at offsets that
//     are computed, not looped over;
//   * gathers each chunk's y in shared memory and writes it a chunk later
//     as whole 128-byte rows of 32 channels.
// One launch per call, for every batch row.  What holds it above its bound
// is instruction issue: expf is a sequence of FMA-pipe instructions around
// its one special-function op.  Its times on an H100 are in PERF.md.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase on an H100): 62
// registers, no spills, 22,528 bytes of shared memory (16-byte path); the
// 4-byte path for ragged di or N: 64 registers and 32 bytes of spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "f64_mma.cuh"

#define MAXN 16
#define LANES 2                 // threads per channel
#define NPL (MAXN / LANES)      // state lanes per thread
#define CH 32                   // channels per block
#define THREADS (CH * LANES)
#define CHUNK 16                // time steps per stage
#define STAGES 3

struct __align__(16) Stage {
  float x[CHUNK][CH], dt[CHUNK][CH], b[CHUNK][MAXN], c[CHUNK][MAXN];
};

// VEC: di and N multiples of 4 and every array 16-byte aligned, so that
// rows are staged and y is written 16 bytes at a time
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ a, float* __restrict__ y, int S,
                  int di, int N) {
  __shared__ Stage sg[STAGES];
  __shared__ __align__(16) float ys[2][CHUNK][CH];
  const int tid = threadIdx.x, ch = tid / LANES, q = tid % LANES;
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const size_t row = (size_t)blockIdx.y * S;
  x += row * di;
  dt += row * di;
  y += row * di;
  b += row * N;
  c += row * N;

  float an[NPL], h[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    an[k] = (d < di && n < N) ? a[(size_t)d * N + n] : 0.f;
    h[k] = 0.f;
  }

  // chunk k's x, dt, B and C rows into stage k % STAGES (zero past S, di
  // and N): each thread copies fixed places of a stage (W floats each),
  // so its offsets are computed once and advance by a chunk's rows
  constexpr int W = VEC ? 4 : 1;               // floats per copy
  constexpr int NX = CHUNK * CH / W, NB = CHUNK * MAXN / W;
  constexpr int MX = (NX + THREADS - 1) / THREADS;
  constexpr int MB = (2 * NB + THREADS - 1) / THREADS;
  const int nch = (S + CHUNK - 1) / CHUNK;
  auto copy = [&](float* dst, const float* src, bool ok) {
    if constexpr (VEC) cp_async16(dst, ok ? src : x, ok);
    else cp_async4(dst, ok ? src : x, ok);
  };
  auto load = [&](int k) {
    if (k < nch) {
      Stage& s = sg[k % STAGES];
      const int t0 = k * CHUNK;
#pragma unroll
      for (int m = 0; m < MX; ++m) {
        const int e = tid + m * THREADS;
        if (NX % THREADS && e >= NX) break;
        const int i = e / (CH / W), cc = e % (CH / W) * W;
        const bool ok = t0 + i < S && d0 + cc < di;
        const size_t off = (size_t)(t0 + i) * di + d0 + cc;
        copy(&s.x[i][cc], x + off, ok);
        copy(&s.dt[i][cc], dt + off, ok);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int e = tid + m * THREADS;        // B's copies, then C's
        if ((2 * NB) % THREADS && e >= 2 * NB) break;
        const bool isc = e >= NB;
        const int ee = isc ? e - NB : e;
        const int i = ee / (MAXN / W), n = ee % (MAXN / W) * W;
        const bool ok = t0 + i < S && n < N;
        copy(isc ? &s.c[i][n] : &s.b[i][n],
             (isc ? c : b) + (size_t)(t0 + i) * N + n, ok);
      }
    }
    cp_async_commit();
  };
  // chunk k's y, gathered in ys[k % 2], as rows of the block's channels
  auto store_y = [&](int k) {
#pragma unroll
    for (int m = 0; m < MX; ++m) {
      const int e = tid + m * THREADS;
      if (NX % THREADS && e >= NX) break;
      const int i = e / (CH / W), cc = e % (CH / W) * W, t = k * CHUNK + i;
      if (t >= S || d0 + cc >= di) continue;
      float* dst = y + (size_t)t * di + d0 + cc;
      if constexpr (VEC)
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(&ys[k & 1][i][cc]);
      else
        *dst = ys[k & 1][i][cc];
    }
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) load(k);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait<STAGES - 2>();    // chunk k is here
    __syncthreads();                // chunk k - 1 done by every thread
    load(k + STAGES - 1);           // into chunk k - 1's stage
    if (k > 0) store_y(k - 1);
    const Stage& s = sg[k % STAGES];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const float dti = s.dt[i][ch], dx = dti * s.x[i][ch];
      float acc = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < NPL; ++k2) {
        h[k2] = expf(dti * an[k2]) * h[k2] + dx * s.b[i][q * NPL + k2];
        acc += h[k2] * s.c[i][q * NPL + k2];
      }
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0) ys[k & 1][i][ch] = acc;
    }
  }
  __syncthreads();
  if (nch > 0) store_y(nch - 1);
}

extern "C" int mamba_scan(const void* x, const void* dt, const void* b,
                          const void* c, const void* a, void* y, int batch,
                          int S, int di, int N, void* stream) {
  if (batch == 0 || S == 0 || di == 0) return 0;
  if (N < 1 || N > MAXN || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((di + CH - 1) / CH, batch);
  const bool vec = di % 4 == 0 && N % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)dt | (uintptr_t)b |
                     (uintptr_t)c | (uintptr_t)y) & 15) == 0;
  auto f = vec ? mamba_scan_kernel<true> : mamba_scan_kernel<false>;
  f<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)b, (const float*)c,
      (const float*)a, (float*)y, S, di, N);
  return (int)cudaGetLastError();
}
