// CT paged attention over the shared quantized KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/ct_paged_attention.py:
//   * ct_paged_attention_fused   (_fused_kernel, _decode_codes): a whole
//     decode tick's attention, every layer and request slot, in one launch;
//   * ct_paged_attention_batched (_kernel): the same pool walk for one layer,
//     returning flash stats (out, m, l) for the chunked-prefill merge.
//
// What it computes (same as the TPU kernel): for each (layer, slot, kv head)
// walk the NB logical blocks of the slot's block table (raw -1 entries
// clamped to physical block 0 and masked by the slot state), dequantize each
// [BS, D] tile of uint8 codes (per-slot bits: 2 ternary, 4 nvfp4, else int8)
// times its E4M3-valued bf16 scale per `group` lanes, mask every slot whose
// state is not VALID, and run an online softmax over the query rows.  The
// fused variant then attends the fp TBQ buffer (pos < buf_len[r]) as one last
// tile and writes the merged, normalised output.
//
// Bound on this card: bytes for decode (GQ = 4: ~4 flops per code byte, far
// below the fp32 ridge); a big prefill chunk folds 512 query rows into GQ and
// is then bound by fp32 operations.  Design: the TPU's sequential block grid
// axis becomes a loop inside one thread block per (layer, slot, kv head,
// tile of query rows).  Each pool block is read once per thread block with
// 4-byte loads along D, dequantized once into shared memory and reused by
// every query row of the tile.  A query row belongs to TPR consecutive
// threads that each hold D / TPR of its dimensions (query, running max, sum
// and output accumulator all in registers); a score is a partial dot
// product reduced by warp shuffles, so no score tile round-trips through
// shared memory and only the final output (and stats) reach device memory.
// Decode takes a warp per query row (TPR 32, 4 rows per block); prefill
// tiles take 8 threads per row (16 rows per block), which keeps 64 or more
// blocks in flight at GQ 512.  No tensor cores, TMA or pipelining yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define THREADS 128

// nvfp4 magnitudes of index 0..7 (sign is bit 3): e2m1 values
__constant__ float kFp4[8] = {0.f, 0.5f, 1.f, 1.5f, 2.f, 3.f, 4.f, 6.f};

__device__ __forceinline__ float decode_code(uint32_t c, int bits) {
  if (bits == 2) {
    uint32_t c2 = c & 3u;
    return c2 == 3u ? -1.f : (c2 == 1u ? 1.f : 0.f);
  }
  if (bits == 4) {
    float mag = kFp4[c & 7u];
    return (c & 8u) ? -mag : mag;
  }
  return (float)(int8_t)(uint8_t)c;
}

// Decode one [T, D] pool block of K and V into shared memory (row stride D).
// Threads cover 4 consecutive lanes each; D % 4 == 0 and group % 4 == 0.
__device__ __forceinline__ void load_pool_tile(
    float* ks, float* vs, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const __nv_bfloat16* __restrict__ ksc,
    const __nv_bfloat16* __restrict__ vsc, const int* bits, size_t row0,
    int H, int h, int D, int group, int T) {
  const int SG = D / group;
  const int words = T * D / 4;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int j = (w * 4) / D, d = (w * 4) % D;
    const size_t row = (row0 + j) * H + h;
    const uint32_t kw = *reinterpret_cast<const uint32_t*>(kc + row * D + d);
    const uint32_t vw = *reinterpret_cast<const uint32_t*>(vc + row * D + d);
    const float ksv = __bfloat162float(ksc[row * SG + d / group]);
    const float vsv = __bfloat162float(vsc[row * SG + d / group]);
    const int b = bits[j];
    float4 kd, vd;
    kd.x = decode_code(kw, b) * ksv;
    kd.y = decode_code(kw >> 8, b) * ksv;
    kd.z = decode_code(kw >> 16, b) * ksv;
    kd.w = decode_code(kw >> 24, b) * ksv;
    vd.x = decode_code(vw, b) * vsv;
    vd.y = decode_code(vw >> 8, b) * vsv;
    vd.z = decode_code(vw >> 16, b) * vsv;
    vd.w = decode_code(vw >> 24, b) * vsv;
    *reinterpret_cast<float4*>(ks + j * D + d) = kd;
    *reinterpret_cast<float4*>(vs + j * D + d) = vd;
  }
}

// Partial dot product of this thread's DPT lanes of q with one key row.
template <int DPT>
__device__ __forceinline__ float partial_dot(const float (&q)[DPT],
                                             const float* kr) {
  float part = 0.f;
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPT; i += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + i);
      part = fmaf(q[i], k4.x, part);
      part = fmaf(q[i + 1], k4.y, part);
      part = fmaf(q[i + 2], k4.z, part);
      part = fmaf(q[i + 3], k4.w, part);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) part = fmaf(q[i], kr[i], part);
  }
  return part;
}

// Online-softmax update of one query row's (m, l, acc) with the T keys of
// the tile in shared memory, KB keys at a time (one rescale per KB keys;
// the KB shuffle reductions are independent, so they overlap).  The TPR
// threads of the row (consecutive lanes of one warp) each hold DPT of its
// D dimensions.  Masked keys score NEG_INF and weigh 0, as in the
// reference.
template <int TPR, int DPT>
__device__ __forceinline__ void attend_tile(
    const float* ks, const float* vs, const int* valid, int T, int D, int d0,
    const float (&q)[DPT], float& m, float& l, float (&acc)[DPT],
    float scale) {
  constexpr int KB = 4;
  for (int j0 = 0; j0 < T; j0 += KB) {
    float s[KB];
    bool ok[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      ok[k] = j0 + k < T && valid[j0 + k];
      s[k] = ok[k] ? partial_dot<DPT>(q, ks + (j0 + k) * D + d0) : 0.f;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    }
    float mn = m;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      s[k] = ok[k] ? s[k] * scale : NEG_INF;
      mn = fmaxf(mn, s[k]);
    }
    const float corr = expf(m - mn);
    float p[KB], psum = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      p[k] = ok[k] ? expf(s[k] - mn) : 0.f;
      psum += p[k];
    }
    l = l * corr + psum;
    m = mn;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (!ok[k]) continue;                  // uniform across the block
      const float* vr = vs + (j0 + k) * D + d0;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p[k], vr[i], acc[i]);
    }
  }
}

// FUSED: one block per (l, r, h, query tile), L layers, buffer tile last.
// !FUSED: one block per (r, h, query tile) of one layer, stats out.
template <bool FUSED, int TPR, int DPT>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const float* __restrict__ qh,
                  const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
                  const __nv_bfloat16* __restrict__ ksc,
                  const __nv_bfloat16* __restrict__ vsc,
                  const uint8_t* __restrict__ state,
                  const uint8_t* __restrict__ sbits,
                  const int32_t* __restrict__ table,
                  const __nv_bfloat16* __restrict__ bk,
                  const __nv_bfloat16* __restrict__ bv,
                  const int32_t* __restrict__ blen,
                  float* __restrict__ out, float* __restrict__ mo,
                  float* __restrict__ lo,
                  int L, int R, int H, int GQ, int D, int NP, int BS, int NB,
                  int G, int group, float scale) {
  constexpr int RB = THREADS / TPR;          // query rows per block
  extern __shared__ float smem[];
  const int T = BS > G ? BS : G;
  float* ks = smem;
  float* vs = ks + T * D;
  int* valid = reinterpret_cast<int*>(vs + T * D);
  int* bits = valid + T;

  const int ntiles = (GQ + RB - 1) / RB;
  int bid = blockIdx.x;
  const int tile = bid % ntiles; bid /= ntiles;
  const int h = bid % H; bid /= H;
  const int r = bid % R;
  const int l = FUSED ? bid / R : 0;
  const int tid = threadIdx.x;
  const int row = tile * RB + tid / TPR;
  const bool live = row < GQ;
  const int d0 = (tid % TPR) * DPT;
  const size_t lr = FUSED ? (size_t)l * R + r : (size_t)r;   // (layer, slot)

  float q[DPT], acc[DPT];
  const float* qr = qh + ((lr * H + h) * GQ + (live ? row : 0)) * D + d0;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = live ? qr[i] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, lsum = 0.f;

  const size_t meta = lr * NB * BS;
  for (int b = 0; b < NB; ++b) {
    int phys = FUSED ? table[((size_t)r * L + l) * NB + b]
                     : table[(size_t)r * NB + b];
    phys = phys < 0 ? 0 : (phys >= NP ? NP - 1 : phys);
    for (int j = tid; j < BS; j += blockDim.x) {
      valid[j] = state[meta + (size_t)b * BS + j] == 1;
      bits[j] = sbits[meta + (size_t)b * BS + j];
    }
    __syncthreads();
    load_pool_tile(ks, vs, kc, vc, ksc, vsc, bits,
                   ((size_t)l * NP + phys) * BS, H, h, D, group, BS);
    __syncthreads();
    attend_tile<TPR, DPT>(ks, vs, valid, BS, D, d0, q, m, lsum, acc, scale);
    __syncthreads();
  }

  if (FUSED) {
    // the fp TBQ buffer: G rows, valid below buf_len[r]
    const int n = blen[r];
    for (int j = tid; j < G; j += blockDim.x) valid[j] = j < n;
    const size_t brow0 = lr * G;
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      const size_t bi = ((brow0 + j) * H + h) * D + d;
      ks[j * D + d] = __bfloat162float(bk[bi]);
      vs[j * D + d] = __bfloat162float(bv[bi]);
    }
    __syncthreads();
    attend_tile<TPR, DPT>(ks, vs, valid, G, D, d0, q, m, lsum, acc, scale);
  }

  if (live) {
    const size_t orow = (lr * H + h) * GQ + row;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[orow * D + d0 + i] = acc[i] * inv;
    if (!FUSED && d0 == 0) {
      mo[orow] = m;
      lo[orow] = lsum;
    }
  }
}

typedef void (*KernelFn)(const float*, const uint8_t*, const uint8_t*,
                         const __nv_bfloat16*, const __nv_bfloat16*,
                         const uint8_t*, const uint8_t*, const int32_t*,
                         const __nv_bfloat16*, const __nv_bfloat16*,
                         const int32_t*, float*, float*, float*, int, int,
                         int, int, int, int, int, int, int, int, float);

// The instantiation for D lanes split over TPR threads (D / TPR in
// {1, 2, 4} for a warp per row, {4, 8, 16} for 8 threads per row).
template <bool FUSED>
static KernelFn pick(int tpr, int D) {
  if (tpr == 32) {
    if (D == 32) return paged_attn_kernel<FUSED, 32, 1>;
    if (D == 64) return paged_attn_kernel<FUSED, 32, 2>;
    if (D == 128) return paged_attn_kernel<FUSED, 32, 4>;
  } else {
    if (D == 32) return paged_attn_kernel<FUSED, 8, 4>;
    if (D == 64) return paged_attn_kernel<FUSED, 8, 8>;
    if (D == 128) return paged_attn_kernel<FUSED, 8, 16>;
  }
  return nullptr;
}

// A warp per query row while a tile of 4 rows covers GQ; else 8 threads
// per row, 16 rows per block.
static int rows_per_thread_group(int GQ) { return GQ <= THREADS / 32 ? 32 : 8; }

template <bool FUSED>
static int launch(int blocks_per_tile_axis, cudaStream_t stream,
                  const float* qh, const uint8_t* kc, const uint8_t* vc,
                  const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                  const uint8_t* st, const uint8_t* bits, const int32_t* table,
                  const __nv_bfloat16* bk, const __nv_bfloat16* bv,
                  const int32_t* blen, float* out, float* mo, float* lo,
                  int L, int R, int H, int GQ, int D, int NP, int BS, int NB,
                  int G, int group, float scale) {
  if (D % 4 || group % 4 || D % group) return (int)cudaErrorInvalidValue;
  const int tpr = rows_per_thread_group(GQ);
  KernelFn fn = pick<FUSED>(tpr, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int rb = THREADS / tpr;
  const int ntiles = (GQ + rb - 1) / rb;
  const int T = BS > G ? BS : G;
  const size_t smem = (size_t)T * D * 2 * sizeof(float) + 2 * T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks_per_tile_axis * ntiles, THREADS, smem, stream>>>(
      qh, kc, vc, ks, vs, st, bits, table, bk, bv, blen, out, mo, lo, L, R, H,
      GQ, D, NP, BS, NB, G, group, scale);
  return (int)cudaGetLastError();
}

extern "C" int ct_paged_attention_fused(
    const void* qh, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* state, const void* bits, const void* table,
    const void* bk, const void* bv, const void* blen, void* out, int L, int R,
    int H, int GQ, int D, int NP, int BS, int NB, int G, int group,
    float scale, void* stream) {
  return launch<true>(L * R * H, (cudaStream_t)stream, (const float*)qh,
                      (const uint8_t*)kc, (const uint8_t*)vc,
                      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
                      (const uint8_t*)state, (const uint8_t*)bits,
                      (const int32_t*)table, (const __nv_bfloat16*)bk,
                      (const __nv_bfloat16*)bv, (const int32_t*)blen,
                      (float*)out, nullptr, nullptr, L, R, H, GQ, D, NP, BS,
                      NB, G, group, scale);
}

extern "C" int ct_paged_attention_batched(
    const void* qh, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* state, const void* bits, const void* table,
    void* out, void* mo, void* lo, int R, int H, int GQ, int D, int NP, int BS,
    int NB, int group, float scale, void* stream) {
  return launch<false>(R * H, (cudaStream_t)stream, (const float*)qh,
                       (const uint8_t*)kc, (const uint8_t*)vc,
                       (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
                       (const uint8_t*)state, (const uint8_t*)bits,
                       (const int32_t*)table, nullptr, nullptr, nullptr,
                       (float*)out, (float*)mo, (float*)lo, 1, R, H, GQ, D,
                       NP, BS, NB, 0, group, scale);
}
