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
// Bound on this card: bytes at the engine's shapes (S <= 128: q, k, v and
// out are a few MB, the flops a few hundred MFLOP).  Design: one thread
// block per (q head, tile of BQ queries) loops over key tiles up to the
// diagonal (the TPU's sequential kv grid axis); the q tile, the current
// k/v tile, the score tile and (m, l, acc) stay in shared memory, so each
// k/v row is read once per query tile and only the output and stats are
// written back.  CUDA-core fp32 math; no tensor cores or TMA yet.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define THREADS 128
#define BQ 32
#define BK 32

__host__ __device__ inline size_t fp_smem_words(int D) {
  return (size_t)BQ * D * 2 + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * BK + 3 * BQ;
}

__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ mo, float* __restrict__ lo, int S,
                     int Hq, int H, int D, int causal, int window,
                     int n_valid, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + BQ * D;
  float* ks = acc + BQ * D;
  float* vs = ks + BK * (D + 1);
  float* sc = vs + BK * D;
  float* m = sc + BQ * BK;
  float* l = m + BQ;
  float* corr = l + BQ;
  const int tid = threadIdx.x;
  const int hq = blockIdx.x;
  const int hk = hq / (Hq / H);
  const int q0 = blockIdx.y * BQ;

  for (int e = tid; e < BQ * D; e += blockDim.x) {
    int i = e / D, d = e % D;
    qs[e] = q0 + i < S ? q[((size_t)(q0 + i) * Hq + hq) * D + d] : 0.f;
    acc[e] = 0.f;
  }
  for (int i = tid; i < BQ; i += blockDim.x) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  __syncthreads();

  int kend = min(S, n_valid);
  if (causal) kend = min(kend, q0 + BQ);
  int kstart = 0;
  if (window > 0) kstart = max(0, q0 - window + 1) / BK * BK;
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    for (int e = tid; e < BK * D; e += blockDim.x) {
      int j = e / D, d = e % D;
      bool in = k0 + j < S;
      size_t idx = ((size_t)(k0 + j) * H + hk) * D + d;
      ks[j * (D + 1) + d] = in ? k[idx] : 0.f;
      vs[j * D + d] = in ? v[idx] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      int i = e / BK, j = e % BK;
      int qi = q0 + i, kj = k0 + j;
      bool ok = qi < S && kj < S && kj < n_valid && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
      float s = NEG_INF;
      if (ok) {
        const float* qr = qs + i * D;
        const float* kr = ks + j * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();
    for (int i = tid; i < BQ; i += blockDim.x) {
      float mp = m[i], mx = mp;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, sc[i * BK + j]);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        float s = sc[i * BK + j];
        float p = s > 0.5f * NEG_INF ? expf(s - mx) : 0.f;
        sc[i * BK + j] = p;
        sum += p;
      }
      float c = expf(mp - mx);
      l[i] = l[i] * c + sum;
      corr[i] = c;
      m[i] = mx;
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += blockDim.x) {
      int i = e / D, d = e % D;
      float a = acc[e] * corr[i];
      for (int j = 0; j < BK; ++j) a += sc[i * BK + j] * vs[j * D + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * D; e += blockDim.x) {
    int i = e / D, d = e % D;
    if (q0 + i < S)
      out[((size_t)(q0 + i) * Hq + hq) * D + d] = acc[e] / fmaxf(l[i], 1e-30f);
  }
  for (int i = tid; i < BQ; i += blockDim.x) {
    if (q0 + i < S) {
      mo[(size_t)(q0 + i) * Hq + hq] = m[i];
      lo[(size_t)(q0 + i) * Hq + hq] = l[i];
    }
  }
}

extern "C" int flash_prefill_stats(const void* q, const void* k,
                                   const void* v, void* out, void* mo,
                                   void* lo, int S, int Hq, int H, int D,
                                   int causal, int window, int n_valid,
                                   float scale, void* stream) {
  size_t smem = fp_smem_words(D) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (S + BQ - 1) / BQ);
  flash_prefill_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)mo, (float*)lo, S, Hq, H, D, causal, window, n_valid, scale);
  return (int)cudaGetLastError();
}
