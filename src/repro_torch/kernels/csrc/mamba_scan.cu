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
// registers: one thread per (batch row, channel) holds h[0..N) and A[d, :],
// and parallelism comes from (batch, channel) alone.
//
// Bound on this card: the larger of the bytes (x, dt and y: 12 B per (t, d),
// plus B and C rows and A, each read or written once) over 3.35 TB/s, and
// the S * di * N exponentials on the special-function units (16 per SM per
// clock).  At falcon-mamba-7b's prefill shape (Bsz 4, S 1024, di 8192,
// N 16) both are near 0.13 ms.  Design against the serial t loop's latency:
// the only loop-carried chain is one FMA per state lane (the 16 exponentials
// of a step do not depend on h), so a thread has 16 independent chains; the
// x/dt values of the next CHUNK time steps are loaded into registers while
// the current chunk computes, and the B/C rows of the next chunk, which all
// channels of the block read, are staged into the other half of a
// double-buffered shared-memory tile (one barrier per chunk).  y_t is stored
// per step, coalesced across the block's channels.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define MAXN 16
#define CHUNK 16
#define STAGE (CHUNK * MAXN / THREADS)   // B (and C) values a thread stages

__device__ __forceinline__ void load_xdt(const float* __restrict__ x,
                                         const float* __restrict__ dt,
                                         int t0, int S, int di, int d,
                                         bool live, float (&xs)[CHUNK],
                                         float (&ds)[CHUNK]) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const bool ok = live && t0 + i < S;
    xs[i] = ok ? x[(size_t)(t0 + i) * di + d] : 0.f;
    ds[i] = ok ? dt[(size_t)(t0 + i) * di + d] : 0.f;
  }
}

__device__ __forceinline__ void load_bc(const float* __restrict__ b,
                                        const float* __restrict__ c, int t0,
                                        int S, int N, float (&bn)[STAGE],
                                        float (&cn)[STAGE]) {
#pragma unroll
  for (int j = 0; j < STAGE; ++j) {
    const int i = threadIdx.x + j * THREADS, t = t0 + i / MAXN, n = i % MAXN;
    const bool ok = t < S && n < N;
    bn[j] = ok ? b[(size_t)t * N + n] : 0.f;
    cn[j] = ok ? c[(size_t)t * N + n] : 0.f;
  }
}

__device__ __forceinline__ void store_bc(float (*sb)[MAXN], float (*sc)[MAXN],
                                         const float (&bn)[STAGE],
                                         const float (&cn)[STAGE]) {
#pragma unroll
  for (int j = 0; j < STAGE; ++j) {
    const int i = threadIdx.x + j * THREADS;
    sb[i / MAXN][i % MAXN] = bn[j];
    sc[i / MAXN][i % MAXN] = cn[j];
  }
}

__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ a, float* __restrict__ y, int S,
                  int di, int N) {
  __shared__ float sb[2][CHUNK][MAXN];
  __shared__ float sc[2][CHUNK][MAXN];
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  const size_t row = (size_t)blockIdx.y * S;
  x += row * di;
  dt += row * di;
  y += row * di;
  b += row * N;
  c += row * N;

  float an[MAXN], h[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    an[n] = (live && n < N) ? a[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }

  float xr[CHUNK], dr[CHUNK], bn[STAGE], cn[STAGE];
  load_xdt(x, dt, 0, S, di, d, live, xr, dr);
  load_bc(b, c, 0, S, N, bn, cn);
  store_bc(sb[0], sc[0], bn, cn);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += CHUNK, buf ^= 1) {
    float xn[CHUNK], dn[CHUNK];
    const bool more = t0 + CHUNK < S;
    if (more) {                    // loads start now, used one chunk later
      load_xdt(x, dt, t0 + CHUNK, S, di, d, live, xn, dn);
      load_bc(b, c, t0 + CHUNK, S, N, bn, cn);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const float dti = dr[i], dx = dti * xr[i];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          h[n] = expf(dti * an[n]) * h[n] + dx * sb[buf][i][n];
          acc += h[n] * sc[buf][i][n];
        }
      }
      if (live && t0 + i < S) y[(size_t)(t0 + i) * di + d] = acc;
    }
    if (more) {
      store_bc(sb[buf ^ 1], sc[buf ^ 1], bn, cn);
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        xr[i] = xn[i];
        dr[i] = dn[i];
      }
    }
    __syncthreads();
  }
}

extern "C" int mamba_scan(const void* x, const void* dt, const void* b,
                          const void* c, const void* a, void* y, int batch,
                          int S, int di, int N, void* stream) {
  if (batch == 0 || S == 0 || di == 0) return 0;
  if (N < 1 || N > MAXN || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((di + THREADS - 1) / THREADS, batch);
  mamba_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)b, (const float*)c,
      (const float*)a, (float*)y, S, di, N);
  return (int)cudaGetLastError();
}
