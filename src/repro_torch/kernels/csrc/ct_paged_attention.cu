// CT paged attention over the shared quantized KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/ct_paged_attention.py:
//   * ct_paged_attention_fused   (_fused_kernel, _decode_codes): K1, a whole
//     decode tick's attention, every layer and request slot, in one launch;
//   * ct_paged_attention_batched (_kernel): K2, the same pool walk for one
//     layer, returning flash stats (out, m, l) for the chunked-prefill merge
//     and for the single-request wrapper ct_paged_attention.
//
// What both compute (same as the TPU kernel): for each (layer, slot, kv
// head) walk the NB logical blocks of the slot's block table (raw -1
// entries clamped to physical block 0 and masked by the slot state),
// dequantize each [BS, D] tile of uint8 codes (per-slot bits: 2 ternary,
// 4 nvfp4, else int8) times its E4M3-valued bf16 scale per `group` lanes,
// mask every slot whose state is not VALID, and run an online softmax over
// the query rows.  K1 then attends the fp TBQ buffer (pos < buf_len[r]) as
// one last tile and writes the merged, normalised output.
//
// K1 (fused_attn_kernel, unchanged since its second design): bound by bytes
// (GQ = 4: ~4 flops per code byte, far below the fp32 ridge).  The TPU's
// sequential block grid axis is a loop inside one thread block per (layer,
// slot, kv head, tile of query rows); each pool block is read once per
// thread block with 4-byte loads along D, dequantized once into shared
// memory and reused by every query row of the tile.  A query row belongs
// to a warp (TPR = 32 threads, each holding D / 32 of its dimensions, with
// query, running max, sum and accumulator in registers); a score is a
// partial dot product reduced by warp shuffles.
//
// K2 (paged_split_kernel + merge_splits_kernel): a big prefill chunk folds
// 512 query rows into GQ (a g-chunk 64, the wrapper 4), so K2 is bound by
// operations at GQ 512 and 64 (0.046 ms at 67 TFLOP/s for the full pool at
// GQ 512) and by latency at GQ 4.  Its first design (K1's walk with 16
// rows per block) walked every table entry (masked and unmapped ones
// included), decoded each pool block once per 16 rows (32x at GQ 512), ran
// three barriers per pool block with no prefetch and did its products on
// fp32 CUDA cores: 1.33 ms at GQ 512.  This design:
//   * walks only live blocks: a block first copies the slot's table row
//     (clamped as the reference clamps), state and bits to shared memory
//     and compacts the logical blocks that hold a VALID slot (ballot +
//     popc); a block with none is never read (its keys weigh 0 in the
//     reference; a -1 entry holds FREE slots by contract);
//   * decodes each live block once per 64 query rows (4 warps x 16 rows)
//     into shared memory, and runs Q.K^T and P.V on the tensor cores in f64
//     (f64_mma.cuh: exact products and 53-bit sums, so the flash stats l of
//     2048 keys keep the 1e-4 bar); scores, probabilities, (m, l) and the
//     accumulator stay in registers;
//   * splits the walk (split-KV): block s of NS takes the s-th share of the
//     live list and writes a partial (out, m, l); merge_splits_kernel merges
//     the NS partials with the reference's flash merge (a fully masked row
//     stays m = -1e30, l = 0, out = 0).  NS is chosen by the wrapper
//     (ops.kv_splits) so that about two blocks run per SM at any GQ;
//   * prefetches: the next live block's codes and scales arrive by
//     cp.async while the current one is decoded and attended, with one
//     barrier per pool block (raw codes and decoded tiles double-buffered).
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase on an H100):
// paged_split_kernel D 128 / 64 / 32: 186 / 141 / 95 registers;
// merge_splits_kernel: 32 registers; no spills.  K1 (fused_attn_kernel)
// 32-56 registers, 12 bytes of spill stores for TPR 8, D 64.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "f64_mma.cuh"

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


// K1: one block per (l, r, h, query tile), L layers, buffer tile last.
template <int TPR, int DPT>
__global__ void __launch_bounds__(THREADS)
fused_attn_kernel(const float* __restrict__ qh,
                  const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
                  const __nv_bfloat16* __restrict__ ksc,
                  const __nv_bfloat16* __restrict__ vsc,
                  const uint8_t* __restrict__ state,
                  const uint8_t* __restrict__ sbits,
                  const int32_t* __restrict__ table,
                  const __nv_bfloat16* __restrict__ bk,
                  const __nv_bfloat16* __restrict__ bv,
                  const int32_t* __restrict__ blen,
                  float* __restrict__ out,
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
  const int l = bid / R;
  const int tid = threadIdx.x;
  const int row = tile * RB + tid / TPR;
  const bool live = row < GQ;
  const int d0 = (tid % TPR) * DPT;
  const size_t lr = (size_t)l * R + r;       // (layer, slot)

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
    int phys = table[((size_t)r * L + l) * NB + b];
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

  if (live) {
    const size_t orow = (lr * H + h) * GQ + row;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[orow * D + d0 + i] = acc[i] * inv;
  }
}

typedef void (*FusedFn)(const float*, const uint8_t*, const uint8_t*,
                        const __nv_bfloat16*, const __nv_bfloat16*,
                        const uint8_t*, const uint8_t*, const int32_t*,
                        const __nv_bfloat16*, const __nv_bfloat16*,
                        const int32_t*, float*, int, int, int, int, int, int,
                        int, int, int, int, float);

// The instantiation for D lanes split over TPR threads (D / TPR in
// {1, 2, 4} for a warp per row, {4, 8, 16} for 8 threads per row).
static FusedFn pick_fused(int tpr, int D) {
  if (tpr == 32) {
    if (D == 32) return fused_attn_kernel<32, 1>;
    if (D == 64) return fused_attn_kernel<32, 2>;
    if (D == 128) return fused_attn_kernel<32, 4>;
  } else {
    if (D == 32) return fused_attn_kernel<8, 4>;
    if (D == 64) return fused_attn_kernel<8, 8>;
    if (D == 128) return fused_attn_kernel<8, 16>;
  }
  return nullptr;
}

extern "C" int ct_paged_attention_fused(
    const void* qh, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* state, const void* bits, const void* table,
    const void* bk, const void* bv, const void* blen, void* out, int L, int R,
    int H, int GQ, int D, int NP, int BS, int NB, int G, int group,
    float scale, void* stream) {
  if (D % 4 || group % 4 || D % group) return (int)cudaErrorInvalidValue;
  // a warp per query row while a tile of 4 rows covers GQ; else 8 threads
  // per row, 16 rows per block
  const int tpr = GQ <= THREADS / 32 ? 32 : 8;
  FusedFn fn = pick_fused(tpr, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int ntiles = (GQ + THREADS / tpr - 1) / (THREADS / tpr);
  const int T = BS > G ? BS : G;
  const size_t smem = (size_t)T * D * 2 * sizeof(float) + 2 * T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<L * R * H * ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)qh, (const uint8_t*)kc, (const uint8_t*)vc,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
      (const uint8_t*)state, (const uint8_t*)bits, (const int32_t*)table,
      (const __nv_bfloat16*)bk, (const __nv_bfloat16*)bv,
      (const int32_t*)blen, (float*)out, L, R, H, GQ, D, NP, BS, NB, G, group,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: split-KV walk of the live pool blocks on the tensor cores
// ---------------------------------------------------------------------------

#define K2_THREADS 128
#define K2_ROWS 64              // query rows per block: 4 warps x 16
#define MAX_KT 4                // BS <= 32: at most 4 eight-key sub-tiles

// shared memory of one K2 block, in bytes from the start, for D, BS, NB
// decode_code with the nvfp4 magnitudes packed in a register (twice each
// e2m1 value, a nibble per index) instead of a constant-memory table,
// whose lanes' differing indices would serialise
__device__ __forceinline__ float decode_reg(uint32_t c, int bits) {
  if (bits == 2) {
    const uint32_t c2 = c & 3u;
    return c2 == 3u ? -1.f : (c2 == 1u ? 1.f : 0.f);
  }
  if (bits == 4) {
    const float mag = 0.5f * (float)((0xC8643210u >> ((c & 7u) * 4)) & 15u);
    return (c & 8u) ? -mag : mag;
  }
  return (float)(int8_t)(uint8_t)c;
}

struct K2Layout {
  int deq, raw, raw_stage, state, bits, list, phys, count, bytes;
  __host__ __device__ K2Layout(int D, int BS, int NB, int SG) {
    const int LD = D + 4;
    deq = K2_ROWS * LD * 4;                    // q rows [64][LD] f32 first
    raw = deq + 2 * 2 * BS * LD * 4;           // decoded k, v: 2 stages
    raw_stage = 2 * BS * D + 2 * BS * SG * 2;  // k, v codes; k, v scales
    state = raw + 2 * raw_stage;
    bits = state + NB * BS;
    list = (bits + NB * BS + 15) / 16 * 16;
    phys = list + NB * 4;
    count = phys + NB * 4;
    bytes = count + 16;
  }
};

template <int D>
__global__ void __launch_bounds__(K2_THREADS)
paged_split_kernel(const float* __restrict__ qh,
                   const uint8_t* __restrict__ kc,
                   const uint8_t* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ ksc,
                   const __nv_bfloat16* __restrict__ vsc,
                   const uint8_t* __restrict__ state,
                   const uint8_t* __restrict__ sbits,
                   const int32_t* __restrict__ table,
                   float* __restrict__ out, float* __restrict__ mo,
                   float* __restrict__ lo, float* __restrict__ part,
                   float* __restrict__ pml, int R, int H, int GQ, int NP,
                   int BS, int NB, int group, int NS, float scale) {
  constexpr int LD = D + 4, NT = D / 8;
  const int SG = D / group, KT = BS / 8;
  const K2Layout ly(D, BS, NB, SG);
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(sm);
  float* deq = reinterpret_cast<float*>(sm + ly.deq);
  uint8_t* raw = sm + ly.raw;
  uint8_t* st = sm + ly.state;
  uint8_t* bt = sm + ly.bits;
  int* list = reinterpret_cast<int*>(sm + ly.list);
  int* phys = reinterpret_cast<int*>(sm + ly.phys);
  int* count = reinterpret_cast<int*>(sm + ly.count);

  const int split = blockIdx.x % NS, tile = blockIdx.x / NS;
  const int h = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t rh = (size_t)r * H + h;

  // 1. this tile's query rows (zero past GQ), in flight while the
  //    metadata is read
  for (int c = tid; c < K2_ROWS * (D / 4); c += K2_THREADS) {
    const int i = c / (D / 4), d = (c % (D / 4)) * 4;
    const int row = tile * K2_ROWS + i;
    cp_async16(qs + i * LD + d,
               qh + (rh * GQ + (row < GQ ? row : 0)) * D + d, row < GQ);
  }
  cp_async_commit();

  // 2. the slot's table row (clamped as the reference clamps), state and
  //    bits, and its live logical blocks: those that hold a VALID slot, in
  //    table order
  for (int b = tid; b < NB; b += K2_THREADS) {
    const int p = table[(size_t)r * NB + b];
    phys[b] = p < 0 ? 0 : (p >= NP ? NP - 1 : p);
  }
  const int nmeta = NB * BS;
  const uint8_t* sg = state + (size_t)r * nmeta;
  const uint8_t* bg = sbits + (size_t)r * nmeta;
  if ((((uintptr_t)sg | (uintptr_t)bg) & 3) == 0) {
    for (int w = tid; w < nmeta / 4; w += K2_THREADS) {
      reinterpret_cast<uint32_t*>(st)[w] =
          reinterpret_cast<const uint32_t*>(sg)[w];
      reinterpret_cast<uint32_t*>(bt)[w] =
          reinterpret_cast<const uint32_t*>(bg)[w];
    }
  } else {
    for (int e = tid; e < nmeta; e += K2_THREADS) {
      st[e] = sg[e];
      bt[e] = bg[e];
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int b0 = 0; b0 < NB; b0 += 32) {
      const int b = b0 + lane;
      bool any = false;
      if (b < NB) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(st + b * BS);
        for (int j = 0; j < BS / 4; ++j) {      // a byte equal to 1
          const uint32_t x = w[j] ^ 0x01010101u;
          any |= ((x - 0x01010101u) & ~x & 0x80808080u) != 0;
        }
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, any);
      if (any) list[n + __popc(mask & ((1u << lane) - 1u))] = b;
      n += __popc(mask);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  const int n_live = *count;
  const int first = (int)((long long)split * n_live / NS);
  const int n_mine = (int)((long long)(split + 1) * n_live / NS) - first;

  // 3. the pipeline: raw codes and scales of live block i arrive by
  //    cp.async into raw stage i % 2; they are decoded into deq stage
  //    i % 2 one step before block i is attended
  auto load_raw = [&](int i) {
    if (i < n_mine) {
      const size_t row0 = (size_t)phys[list[first + i]] * BS;
      uint8_t* rs = raw + (i & 1) * ly.raw_stage;
      constexpr int CPR = D / 16;               // 16-byte chunks per row
      for (int c = tid; c < 2 * BS * CPR; c += K2_THREADS) {
        const int plane = c / (BS * CPR), cc = c % (BS * CPR);
        const int j = cc / CPR, d = (cc % CPR) * 16;
        cp_async16(rs + plane * BS * D + j * D + d,
                   (plane ? vc : kc) + ((row0 + j) * H + h) * D + d);
      }
      const int spr = SG / 2;                   // 4-byte chunks per row
      uint8_t* rsc = rs + 2 * BS * D;
      for (int c = tid; c < 2 * BS * spr; c += K2_THREADS) {
        const int plane = c / (BS * spr), cc = c % (BS * spr);
        const int j = cc / spr, w = cc % spr;
        cp_async4(rsc + (plane * BS + j) * SG * 2 + 4 * w,
                  (plane ? vsc : ksc) + ((row0 + j) * H + h) * SG + 2 * w);
      }
    }
    cp_async_commit();
  };
  auto decode = [&](int i) {
    if (i >= n_mine) return;
    const uint8_t* bits = bt + list[first + i] * BS;
    const uint8_t* rs = raw + (i & 1) * ly.raw_stage;
    const __nv_bfloat16* rsc =
        reinterpret_cast<const __nv_bfloat16*>(rs + 2 * BS * D);
    float* kd = deq + (i & 1) * 2 * BS * LD;
    const int words = BS * D / 4;
    for (int w = tid; w < 2 * words; w += K2_THREADS) {
      const int plane = w >= words, ww = w - plane * words;
      const int j = ww / (D / 4), d = (ww % (D / 4)) * 4;
      const uint32_t cw = reinterpret_cast<const uint32_t*>(rs)[w];
      const float sc = __bfloat162float(rsc[(plane * BS + j) * SG + d / 16]);
      const int b = bits[j];
      *reinterpret_cast<float4*>(kd + (plane * BS + j) * LD + d) =
          make_float4(decode_reg(cw, b) * sc, decode_reg(cw >> 8, b) * sc,
                      decode_reg(cw >> 16, b) * sc,
                      decode_reg(cw >> 24, b) * sc);
    }
  };

  const int wrow = tile * K2_ROWS + warp * 16;   // the warp's first row
  const bool w_live = wrow < GQ;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  load_raw(0);
  load_raw(1);
  cp_async_wait<1>();               // q and block 0 are here
  __syncthreads();
  decode(0);
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<0>();             // block i + 1 is here
    __syncthreads();                // block i decoded; stage (i+1)%2 free
    load_raw(i + 2);
    decode(i + 1);
    if (!w_live) continue;
    const float* kd = deq + (i & 1) * 2 * BS * LD;
    const float* vd = kd + BS * LD;
    const uint8_t* sv = st + list[first + i] * BS;

    // scores in f64 (exact products, 53-bit sums), in the C places of the
    // m16n8 fragment that P.V takes below: rows a = g, b = g + 8, keys 2t
    // and 2t + 1 of each 8-key sub-tile
    double sd[MAX_KT][4];
#pragma unroll
    for (int n = 0; n < MAX_KT; ++n) sd[n][0] = sd[n][1] = sd[n][2] = sd[n][3] = 0.0;
    const float* qa = qs + (warp * 16 + g) * LD + t;
    const float* kb = kd + g * LD + t;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
      double a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = qa[(e % 2) * 8 * LD + k0 + 4 * (e / 2)];
#pragma unroll
      for (int n = 0; n < MAX_KT; ++n) {
        if (n >= KT) continue;
        double b4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b4[j] = kb[n * 8 * LD + k0 + 4 * j];
        mma_f64(sd[n], a, b4);
      }
    }
    float s[MAX_KT][4];
#pragma unroll
    for (int n = 0; n < MAX_KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = (float)sd[n][e];
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < MAX_KT; ++n) {
      if (n >= KT) continue;
      const bool ok0 = sv[n * 8 + 2 * t] == 1, ok1 = sv[n * 8 + 2 * t + 1] == 1;
      s[n][0] = ok0 ? s[n][0] * scale : NEG_INF;
      s[n][1] = ok1 ? s[n][1] * scale : NEG_INF;
      s[n][2] = ok0 ? s[n][2] * scale : NEG_INF;
      s[n][3] = ok1 ? s[n][3] * scale : NEG_INF;
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float c_a = expf(m_a - mx_a), c_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < MAX_KT; ++n) {
      if (n >= KT) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mx = e < 2 ? mx_a : mx_b;
        s[n][e] = s[n][e] > 0.5f * NEG_INF ? expf(s[n][e] - mx) : 0.f;
      }
      ps_a += s[n][0] + s[n][1];
      ps_b += s[n][2] + s[n][3];
    }
    l_a = l_a * c_a + ps_a;
    l_b = l_b * c_b + ps_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= c_a;
      o[n][1] *= c_a;
      o[n][2] *= c_b;
      o[n][3] *= c_b;
    }
    // o += P V in f64, two 8-key sub-tiles as one k step of 16 in the
    // order (0, 2, 4, 6, 1, 3, 5, 7, 8, 10, ...): a sub-tile past BS is zero
#pragma unroll
    for (int n = 0; n < MAX_KT; n += 2) {
      if (n >= KT) continue;
      const bool two = n + 1 < KT;
      const double a[8] = {s[n][0], s[n][2], s[n][1], s[n][3],
                           two ? s[n + 1][0] : 0.f, two ? s[n + 1][2] : 0.f,
                           two ? s[n + 1][1] : 0.f, two ? s[n + 1][3] : 0.f};
      const float* vb = vd + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        const double b4[4] = {vb[dn * 8], vb[dn * 8 + LD],
                              two ? vb[dn * 8 + 8 * LD] : 0.f,
                              two ? vb[dn * 8 + 9 * LD] : 0.f};
        double od[4] = {0.0, 0.0, 0.0, 0.0};
        mma_f64(od, a, b4);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] += (float)od[e];
      }
    }
  }

  // 4. the final result (one split) or this split's partial
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wrow + g + 8 * half;
    if (row >= GQ) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    const size_t ridx = rh * GQ + row;
    const size_t idx = NS == 1 ? ridx : (size_t)split * R * H * GQ + ridx;
    const float inv = NS == 1 ? 1.f / fmaxf(l, 1e-30f) : 1.f;
    float* dst = (NS == 1 ? out : part) + idx * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    if (t == 0) {
      if (NS == 1) {
        mo[idx] = m;
        lo[idx] = l;
      } else {
        pml[2 * idx] = m;
        pml[2 * idx + 1] = l;
      }
    }
  }
}

// The flash merge of NS partials (unnormalised out, m, l) of each row, a
// warp per row: out = sum_s e^(m_s - M) out_s / max(L, 1e-30) with
// M = max_s m_s and L = sum_s e^(m_s - M) l_s.  Rows no split saw keep
// M = -1e30, L = 0, out = 0.
template <int D>
__global__ void __launch_bounds__(128)
merge_splits_kernel(const float* __restrict__ part,
                    const float* __restrict__ pml, float* __restrict__ out,
                    float* __restrict__ mo, float* __restrict__ lo, int rows,
                    int NS) {
  constexpr int PER = D / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  // lane s holds split s's stats (NS <= 32)
  const bool has = lane < NS;
  const size_t own = (size_t)lane * rows + row;
  const float ms = has ? pml[2 * own] : NEG_INF;
  const float ls = has ? pml[2 * own + 1] : 0.f;
  float M = ms;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float w = has ? expf(ms - M) : 0.f;
  float L = w * ls;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < NS; ++s) {
    const float ws = __shfl_sync(0xffffffffu, w, s);
    const float* src = part + ((size_t)s * rows + row) * D + lane * PER;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] = fmaf(ws, src[e], acc[e]);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int e = 0; e < PER; ++e) out[(size_t)row * D + lane * PER + e] = acc[e] * inv;
  if (lane == 0) {
    mo[row] = M;
    lo[row] = L;
  }
}

template <int D>
static int launch_batched(const float* qh, const uint8_t* kc,
                          const uint8_t* vc, const __nv_bfloat16* ks,
                          const __nv_bfloat16* vs, const uint8_t* st,
                          const uint8_t* bits, const int32_t* table,
                          float* out, float* mo, float* lo, float* part,
                          float* pml, int R, int H, int GQ, int NP, int BS,
                          int NB, int group, int NS, float scale,
                          cudaStream_t stream) {
  static int granted = 0;
  const K2Layout ly(D, BS, NB, D / group);
  cudaError_t err = allow_smem(paged_split_kernel<D>, ly.bytes, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(NS * ((GQ + K2_ROWS - 1) / K2_ROWS), H, R);
  paged_split_kernel<D><<<grid, K2_THREADS, ly.bytes, stream>>>(
      qh, kc, vc, ks, vs, st, bits, table, out, mo, lo, part, pml, R, H, GQ,
      NP, BS, NB, group, NS, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return (int)err;
  const int rows = R * H * GQ;
  merge_splits_kernel<D><<<(rows + 3) / 4, 128, 0, stream>>>(
      part, pml, out, mo, lo, rows, NS);
  return (int)cudaGetLastError();
}

// K2.  part [NS, R, H, GQ, D] and pml [NS, R, H, GQ, 2] f32 are scratch
// for the NS split partials (unused when NS == 1).
extern "C" int ct_paged_attention_batched(
    const void* qh, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* state, const void* bits, const void* table,
    void* out, void* mo, void* lo, void* part, void* pml, int R, int H,
    int GQ, int D, int NP, int BS, int NB, int group, int NS, float scale,
    void* stream) {
  if (group != 16 || BS % 8 || BS > 8 * MAX_KT || NS < 1 || NS > 32)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || H == 0 || GQ == 0) return 0;
  auto f = [&](auto fn) {
    return fn((const float*)qh, (const uint8_t*)kc, (const uint8_t*)vc,
              (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
              (const uint8_t*)state, (const uint8_t*)bits,
              (const int32_t*)table, (float*)out, (float*)mo, (float*)lo,
              (float*)part, (float*)pml, R, H, GQ, NP, BS, NB, group, NS,
              scale, (cudaStream_t)stream);
  };
  switch (D) {
    case 32: return f(launch_batched<32>);
    case 64: return f(launch_batched<64>);
    case 128: return f(launch_batched<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}
