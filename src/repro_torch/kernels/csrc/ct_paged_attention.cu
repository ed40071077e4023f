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
// K1 (fused_attn_kernel) is bound by bytes: at GQ 4 it does ~4 fp32 FMAs
// per code byte, far below the fp32 ridge, so its bound is the live pool
// blocks read once.  Its first design (one block per (layer, slot, kv
// head), a warp per query row) took 1.28 ms against a 0.12 ms bound on an
// H100: it walked all NB table entries (unmapped ones decoded and then
// masked), with three barriers and no prefetch per entry (each pool
// block's load latency exposed), decoded nvfp4 through a constant-memory
// table whose lanes' indices serialise, and reduced every score over 32
// lanes with a 5-stage shuffle.  This design, still one block of 4 warps
// per (layer, slot, kv head, tile of up to 8 query rows):
//   * walks only live blocks: the block copies the slot's table row
//     (clamped as the reference clamps), state and bits to shared memory
//     and compacts the logical blocks that hold a VALID slot (ballot +
//     popc), as K2 does; the fp TBQ buffer is one more item at the end;
//   * deals the items to the warps (warp w takes items w, w + 4, ...) for
//     all query rows of the tile; each warp runs its own pipeline with no
//     block barrier: the next item's raw codes and scales arrive by
//     cp.async in a two-stage ring while the current one is decoded and
//     attended (__syncwarp only), and the four warps' (m, l, acc) are
//     merged once through shared memory at the end;
//   * a key row is covered by LG = 16 lanes of DPT = D / 16 dimensions
//     (two keys side by side per warp at D 128); each lane holds its
//     dimensions of every query row (q and acc in registers) and decodes
//     its code bytes without a branch: codes become value + 128 in a byte
//     by prmt lookups (tables chosen by selects from the key's bits),
//     placed under the exponent of 2^23 and subtracted out (prmt + fadd
//     per value, no conversion unit); the per-16-lane scale (and nvfp4's
//     1/2) multiplies the partial dot product, not each code;
//   * a tile of 32 / RB keys gives each lane RB x KS = 16 partial scores,
//     summed over its 16 lanes by a transposing butterfly without selects
//     (15 shuffles; the lane takes its keys and rows in an order permuted
//     by its lane index, so every step keeps the same half), each lane
//     ending with one (row, key) score; the softmax runs one score per
//     lane and its probabilities reach the P.V loop through a per-warp
//     shared-memory row; the accumulator is rescaled only when a row's
//     maximum moved;
//   * products stay on the fp32 CUDA cores (exact enough for the 1e-4 bar
//     at GQ <= 8; bytes, not products, bound the kernel).
// Its times on an H100 are in PERF.md.  What holds it above its
// bound is instruction issue in the decode and the FMAs; more warps per
// SM, a third ring stage, eight warps per block and two score folds per
// tile were tried and were no faster.
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
// Head_dim 16 (the trace config's; both kernels): a pool row has one bf16
// scale, and cp.async copies no fewer than 4 bytes, so the aligned 4-byte
// word holding it is staged (it lies inside the 4-byte aligned plane) and
// the element's parity picks its half; K1 tiles at most 4 query rows (its
// key row is 4 lanes wide); merge_splits_kernel takes half a warp per row.
//
// Head_dim 256 (paligemma-3b; both kernels): K1 covers a key row with one
// warp (DPT = 8 dimensions a lane, LG = 32, one key per warp and step,
// the lane shape of D 128 with a warp in place of half a warp), so q and
// the accumulator stay 2 x RB x 8 floats a lane; its ring of two 9 KB
// stages per warp and 256 registers a thread allow two blocks per SM.
// K2 would need o[32][4] a thread for D 256, so a block owns DV = 128 of
// the output's columns: the grid's first axis gains D / DV column slices,
// each block computes the scores over all D (q, K and V decoded at D into
// shared memory, ~152 KB: one block per SM) and accumulates its slice of
// P.V; the slices of a row write equal m and l, the first stores them.
// merge_splits_kernel needs no change (8 values a lane).
//
// Head_dim 112 (zamba2-7b's shared attention; K1 only, K2 and K3 have no
// instance): 112 = 7 x 16 breaks three of the shapes above.  A key row
// takes a warp as at D 256, but at DPT 4 only LA = 28 lanes hold
// dimensions (K1Shape): lanes 28-31 hold zero q, read lane 27's bytes (so
// every value they decode is finite and their partial scores are 0) and
// write no output; the fold stays 32 lanes wide.  A code row is 7 chunks
// of 16 bytes, so 4 rows a pass and lanes 28-31 copy none.  A (row, head)
// has 7 bf16 scales, 14 bytes, starting 2-byte aligned at every other
// (row, head): the 4 aligned words that cover them are staged (16 bytes a
// row; the last word stays inside the plane, whose rows come in blocks of
// a multiple of 4) and the element's parity offsets the index, as D 16
// does with its one word.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase on an H100):
// paged_split_kernel D 256 / 128 / 64 / 32 / 16: 184 / 186 / 141 / 95 / 80
// registers; merge_splits_kernel: 32 registers at every D; no spills.
// fused_attn_kernel at D 256 (capped at 255 registers for 2 blocks per
// SM) RB 8 / 4 / 2 / 1: 240 / 167 / 179 / 255 registers, no spills;
// fused_attn_kernel (capped at 170 registers for 3 blocks per SM) D 128 at
// RB 4 (the serve tick): 151 registers, no spills; D 128 at RB 8: 168
// registers and 124-136 bytes of spill stores; D 112 RB 8 / 4 / 2 / 1:
// 167 / 168 / 141 / 168 registers, no spills; D 64 and 32: 96-159
// registers, D 16: 88-102, no spills.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "f64_mma.cuh"

#define NEG_INF (-1e30f)

// decode one code with the nvfp4 magnitudes packed in a register (twice
// each e2m1 value, a nibble per index) instead of a constant-memory table,
// whose lanes' differing indices would serialise (K2's decode)
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

// ---------------------------------------------------------------------------
// K1: a whole decode tick; warps split the live blocks of a (layer, slot,
// kv head) walk
// ---------------------------------------------------------------------------

#define K1_WARPS 4
#define K1_THREADS (K1_WARPS * 32)
#define K1_STAGES 2             // ring of raw pool blocks per warp
#define K1_PB 40                // floats per warp: p [32], corrections [<= 8]

// How a warp covers a key row of D dimensions: DPT dimensions per lane on
// LA lanes, LG lanes per key (the fold's width, a power of two), KG keys
// side by side.  At D 16 a key row is LG = 4 lanes of one code word each
// (launch_fused_rows keeps RB <= LG there).  At D 112 (7 x 16) a key row
// takes a warp as at D 256: LA = 28 lanes of 4 dimensions, and lanes 28-31
// hold zero q, read lane 27's bytes (in bounds, finite) and write no output.
template <int D>
struct K1Shape {
  static constexpr int DPT = D >= 128 ? 8 : 4;
  static constexpr int LA = D / DPT;
  static constexpr int LG = (LA & (LA - 1)) == 0 ? LA : 32;
  static constexpr int KG = 32 / LG;
  static_assert(LA <= LG && D % DPT == 0, "K1: no lane shape for this D");
};

// PTX prmt in its default mode (a selector nibble with bit 3 set copies the
// sign of the selected byte into all 8 bits)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The codes of one row, four per word (one per byte), as integers in f32:
// ternary -1/0/1, nvfp4 twice its e2m1 value (the caller halves the scale),
// else int8.  Each becomes a byte holding value + 128 (lookups by prmt: an
// index of 2 or 3 bits per byte, packed into a selector), is placed under
// the exponent of 2^23 and subtracted out.  No branch: the tables are
// chosen by selects (once per row), so lanes that decode rows of other
// bits do not diverge and the caller's loop over keys stays straight-line.
template <int NW>
__device__ __forceinline__ void decode_row(const uint32_t (&w)[NW], int bits,
                                           float (&v)[4 * NW]) {
  const bool fp4 = bits == 4, lut = bits == 2 || fp4;
  const uint32_t mask = fp4 ? 0x07070707u : 0x03030303u;
  // indices 0..7: 128 + 2|e2m1| and 128 - 2|e2m1| (nvfp4, sign bit 3), or
  // 128 + (0, 1, 0, -1) (ternary, no sign bit)
  const uint32_t pos = fp4 ? 0x83828180u : 0x7F808180u;
  const uint32_t neg = fp4 ? 0x7D7E7F80u : 0x7F808180u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t t = w[k] & mask;
    const uint32_t sel = prmt(t | (t >> 4), 0u, 0x0020u);
    const uint32_t p = prmt(pos, 0x8C888684u, sel);
    const uint32_t n = prmt(neg, 0x74787A7Cu, sel);
    const uint32_t sgn = prmt(w[k] << 4, 0u, 0xBA98u);
    const uint32_t b = lut ? (p & ~sgn) | (n & sgn) : w[k] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[4 * k + i] =
          __uint_as_float(prmt(b, 0x4B000000u, 0x7540u + i)) - 8388736.f;
  }
}

// this lane's DPT code bytes of one row, as DPT / 4 words
template <int DPT>
__device__ __forceinline__ void load_codes(const uint8_t* p,
                                           uint32_t (&w)[DPT / 4]) {
  if constexpr (DPT == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// this lane's DPT bf16 values of one buffer row, as f32
template <int DPT>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&v)[DPT]) {
  uint32_t u[DPT / 2];
  if constexpr (DPT == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    u[0] = x.x; u[1] = x.y; u[2] = x.z; u[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    u[0] = x.x; u[1] = x.y;
  }
#pragma unroll
  for (int k = 0; k < DPT / 2; ++k) {
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xFFFF0000u);
  }
}

// A transposing butterfly over groups of 2 HALF lanes, with no select:
// position p of lane l holds the partial of index p ^ l, so every step
// keeps positions [0, HALF) and adds the partner's [HALF, 2 HALF), which
// are the partner's own kept indices.  From HALF = n / 2 down to 1, lane l
// of the group ends with the group's sum of index l in v[0] (n - 1
// shuffles for n sums).
template <int HALF, int N>
__device__ __forceinline__ void fold(float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < HALF; ++k)
    v[k] += __shfl_xor_sync(0xffffffffu, v[k + HALF], HALF);
  if constexpr (HALF > 1) fold<HALF / 2>(v);
}

// RB floats of a warp's probability rows (16-byte aligned)
template <int RB>
__device__ __forceinline__ void load_row(const float* p, float (&x)[RB]) {
  if constexpr (RB % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RB; r += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + r);
      x[r] = f.x;
      x[r + 1] = f.y;
      x[r + 2] = f.z;
      x[r + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) x[r] = p[r];
  }
}

// One warp's online softmax over nkeys keys, KT = 32 / RB at a time: KG
// keys side by side, each over LG lanes, for KS = LG / RB steps.  kf(j,
// cv) fills this lane's DPT values of key j (the unscaled codes) and
// returns the factor that scales them into the score's units; vf(j, cv)
// does the same for the value row; ok(j) says whether key j is attended.
// Keys a tile holds past nkeys read key nkeys - 1 and are masked; a masked
// key's row is decoded all the same (its score is dropped, its value's
// factor zeroed), so a tile is one straight-line block.
//
// Scores: at step s a lane of group g takes key (s ^ l % KS) KG + g and
// the query rows r ^ l / KS (qp holds them so permuted), so that its LG
// partials sit where fold() wants them; lane l of group g ends with the
// score of row l / KS and key (l % KS) KG + g, and keeps that row's (m, l)
// over its keys.  pb holds a tile's probabilities [KT][RB] and the rows'
// corrections [RB].  acc holds the group's share of the output (keys of
// the group), summed over the groups by the caller.
template <int D, int RB, class KF, class VF, class OK>
__device__ __forceinline__ void attend_keys(
    int nkeys, KF kf, VF vf, OK ok, const float (&qp)[RB][K1Shape<D>::DPT],
    float (&acc)[RB][K1Shape<D>::DPT], float& m_own, float& l_own,
    float* pb, int lane) {
  using SH = K1Shape<D>;
  constexpr int DPT = SH::DPT, LG = SH::LG, KG = SH::KG;
  constexpr int KT = 32 / RB, KS = LG / RB;
  const int g = lane / LG, l = lane % LG;
  const int rr = l / KS, jl = (l % KS) * KG + g;
  for (int j0 = 0; j0 < nkeys; j0 += KT) {
    float part[LG];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      float cv[DPT];
      const int j = j0 + (s ^ (l % KS)) * KG + g;
      const float f = kf(min(j, nkeys - 1), cv);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) sc = fmaf(qp[r][i], cv[i], sc);
        part[r * KS + s] = sc * f;
      }
    }
    fold<LG / 2>(part);                         // row rr, key j0 + jl
    const bool valid = j0 + jl < nkeys && ok(j0 + jl);
    const float sv = valid ? part[0] : NEG_INF;
    float mx = sv;
#pragma unroll
    for (int o = 1; o < KS; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
    for (int o = LG; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m_own, mx);
    const float corr = expf(m_own - mn);
    const float p = valid ? expf(sv - mn) : 0.f;
    l_own = l_own * corr + p;
    m_own = mn;
    pb[jl * RB + rr] = p;
    if (lane % KS == 0 && lane < LG) pb[32 + rr] = corr;
    __syncwarp();
    if (__any_sync(0xffffffffu, corr != 1.f)) {   // some row's max moved
      float cr[RB];
      load_row<RB>(pb + 32, cr);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] *= cr[r];
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int jj = s * KG + g, j = j0 + jj;
      float cv[DPT], pr[RB];
      const float f = vf(min(j, nkeys - 1), cv);
      const float fu = j < nkeys && ok(j) ? f : 0.f;
      load_row<RB>(pb + jj * RB, pr);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pv = pr[r] * fu;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] = fmaf(pv, cv[i], acc[r][i]);
      }
    }
    __syncwarp();                     // pb is rewritten by the next tile
  }
}

// bytes a pool row's scales take in shared memory: SG bf16, or at an odd
// SG (D 16: 1, D 112: 7) the aligned 4-byte words that cover the row's 2 SG
// bytes, since cp.async copies no fewer than 4 aligned bytes and a row's
// scales start 2-byte aligned at every other (row, head) (scale_half
// gives the offset, in bf16, of the first within the first word)
__host__ __device__ constexpr int scale_row_bytes(int SG) {
  return SG % 2 ? 2 * SG + 2 : 2 * SG;
}

// the half of its aligned word that the bf16 at element e of a 4-byte
// aligned scale plane sits in
__device__ __forceinline__ int scale_half(size_t e) { return (int)(e & 1); }

// the aligned 4-byte word holding a bf16 of a 4-byte aligned plane: it
// lies inside the plane, whose size in bytes is a multiple of 4
__device__ __forceinline__ const void* scale_word(const __nv_bfloat16* p) {
  return reinterpret_cast<const void*>((uintptr_t)p & ~(uintptr_t)3);
}

// shared memory of one K1 block, in bytes from the start
struct K1Layout {
  int stage, pbuf, state, bits, list, phys, count, bytes;
  __host__ __device__ K1Layout(int D, int BS, int NB, int SG, int RB) {
    stage = (2 * BS * D + 2 * BS * scale_row_bytes(SG) + 15) / 16 * 16;
    const int walk = K1_WARPS * K1_STAGES * stage;
    const int merge = K1_WARPS * (RB * D + 2 * RB) * 4;     // acc, m, l
    pbuf = ((walk > merge ? walk : merge) + 15) / 16 * 16;  // ring | merge
    state = pbuf + K1_WARPS * K1_PB * 4;
    bits = state + NB * BS;
    list = (bits + NB * BS + 15) / 16 * 16;
    phys = list + NB * 4;
    count = phys + NB * 4;
    bytes = count + 16;
  }
};

// K1: one block per (l, r, h, tile of RB query rows); the scale group is 16
// lanes and BS a multiple of 4.  Three blocks per SM up to D 128; two at
// D 256, whose shared memory (~77 KB) holds no third
template <int D, int RB>
__global__ void __launch_bounds__(K1_THREADS, D > 128 ? 2 : 3)
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
                  int L, int R, int H, int GQ, int NP, int BS, int NB, int G,
                  float scale) {
  using SH = K1Shape<D>;
  constexpr int DPT = SH::DPT, LG = SH::LG, KG = SH::KG, KS = LG / RB;
  constexpr int SG = D / 16;
  const K1Layout ly(D, BS, NB, SG, RB);
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* st = sm + ly.state;
  uint8_t* bt = sm + ly.bits;
  int* list = reinterpret_cast<int*>(sm + ly.list);
  int* phys = reinterpret_cast<int*>(sm + ly.phys);
  int* count = reinterpret_cast<int*>(sm + ly.count);

  const int ntiles = (GQ + RB - 1) / RB;
  int bid = blockIdx.x;
  const int tile = bid % ntiles; bid /= ntiles;
  const int h = bid % H; bid /= H;
  const int r = bid % R;
  const int l = bid / R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane % LG;                  // this lane's place in its key
  const int lgc = min(lg, SH::LA - 1);       // the dimensions it reads
  const size_t lr = (size_t)l * R + r;       // (layer, slot)
  const int row0 = tile * RB;

  // 1. the slot's table row for this layer (clamped as the reference
  //    clamps), state and bits, and its live logical blocks in table order
  for (int b = tid; b < NB; b += K1_THREADS) {
    const int p = table[((size_t)r * L + l) * NB + b];
    phys[b] = p < 0 ? 0 : (p >= NP ? NP - 1 : p);
  }
  const int nmeta = NB * BS;
  const uint8_t* sg = state + lr * nmeta;
  const uint8_t* bg = sbits + lr * nmeta;
  if ((((uintptr_t)sg | (uintptr_t)bg) & 3) == 0) {
    for (int w = tid; w < nmeta / 4; w += K1_THREADS) {
      reinterpret_cast<uint32_t*>(st)[w] =
          reinterpret_cast<const uint32_t*>(sg)[w];
      reinterpret_cast<uint32_t*>(bt)[w] =
          reinterpret_cast<const uint32_t*>(bg)[w];
    }
  } else {
    for (int e = tid; e < nmeta; e += K1_THREADS) {
      st[e] = sg[e];
      bt[e] = bg[e];
    }
  }
  // this lane's dimensions of the tile's query rows (zero past GQ), rows
  // permuted as attend_keys takes them
  float qp[RB][DPT], acc[RB][DPT];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    const int row = row0 + (rr ^ (lg / KS));
    const bool in = row < GQ && lg < SH::LA;
    const float* qr = qh + ((lr * H + h) * GQ + (in ? row : 0)) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qp[rr][i] = in ? qr[lg * DPT + i] : 0.f;
      acc[rr][i] = 0.f;
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

  // 2. the warp's items: live blocks w, w + K1_WARPS, ... then the buffer
  //    (item n_live); a pool block's raw codes and scales arrive by
  //    cp.async into stage k % K1_STAGES of the warp's ring, K1_STAGES - 1
  //    items ahead
  uint8_t* ring = sm + warp * K1_STAGES * ly.stage;
  float* pb = reinterpret_cast<float*>(sm + ly.pbuf) + warp * K1_PB;
  // a stage holds 2 BS rows of codes (K rows, then V rows) and then 2 BS
  // rows of scales; a lane copies one 16-byte chunk of every RPP-th code
  // row (at D 112, 7 chunks a row: lanes 28-31 copy none) and one 4-byte
  // word of every SRP-th scale row (at an odd SG, the aligned words that
  // cover the row's scales)
  constexpr int CPR = D / 16, RPP = 32 / CPR;   // chunks per code row
  constexpr int SRB = scale_row_bytes(SG);
  constexpr int SPR = SRB / 4, SRP = 32 / SPR;  // 4-byte words per scale row
  const size_t HD = (size_t)H * D, HS = (size_t)H * SG;
  auto load = [&](int k) {
    const int i = warp + k * K1_WARPS;
    if (i < n_live) {
      const size_t rw0 = ((size_t)l * NP + phys[list[i]]) * BS;
      uint8_t* rs = ring + (k % K1_STAGES) * ly.stage;
      const int dc = (lane % CPR) * 16;
      const uint8_t* gk = kc + rw0 * HD + (size_t)h * D + dc;
      const uint8_t* gv = vc + rw0 * HD + (size_t)h * D + dc;
      for (int row = lane < RPP * CPR ? lane / CPR : 2 * BS; row < 2 * BS;
           row += RPP) {
        const bool v = row >= BS;
        cp_async16(rs + row * D + dc,
                   (v ? gv : gk) + (size_t)(v ? row - BS : row) * HD);
      }
      const int sw = (lane % SPR) * 4;          // this lane's word, in bytes
      const __nv_bfloat16* sk = ksc + rw0 * HS + (size_t)h * SG;
      const __nv_bfloat16* sv_ = vsc + rw0 * HS + (size_t)h * SG;
      uint8_t* rsc = rs + 2 * BS * D + sw;
      for (int row = lane / SPR; row < 2 * BS; row += SRP) {
        const bool v = row >= BS;
        const __nv_bfloat16* src =
            (v ? sv_ : sk) + (size_t)(v ? row - BS : row) * HS;
        cp_async4(rsc + row * SRB,
                  reinterpret_cast<const uint8_t*>(
                      SG % 2 ? scale_word(src) : src) + sw);
      }
    }
    cp_async_commit();
  };

  float m_own = NEG_INF, l_own = 0.f;
  const int mine = n_live + 1 > warp
                       ? (n_live + 1 - warp + K1_WARPS - 1) / K1_WARPS : 0;
  const int grp = lgc * DPT / 16;               // this lane's scale group
#pragma unroll
  for (int k = 0; k < K1_STAGES - 1; ++k) load(k);
  for (int k = 0; k < mine; ++k) {
    load(k + K1_STAGES - 1);
    cp_async_wait<K1_STAGES - 1>();             // item k is here
    __syncwarp();
    const int i = warp + k * K1_WARPS;
    if (i < n_live) {
      const int b = list[i];
      const uint8_t* sv = st + b * BS;
      const uint8_t* bb = bt + b * BS;
      const uint8_t* rs = ring + (k % K1_STAGES) * ly.stage;
      const __nv_bfloat16* rsc =
          reinterpret_cast<const __nv_bfloat16*>(rs + 2 * BS * D);
      // element of key 0's scale in either plane (same index in both)
      const size_t e0 = ((size_t)l * NP + phys[b]) * BS * HS + (size_t)h * SG;
      auto code_row = [&](int plane, int j, float (&cv)[DPT]) {
        const int bits = bb[j];
        uint32_t w[DPT / 4];
        load_codes<DPT>(rs + (plane * BS + j) * D + lgc * DPT, w);
        decode_row<DPT / 4>(w, bits, cv);
        const int si =
            SG % 2 ? scale_half(e0 + (size_t)j * HS) + grp : grp;
        const float sc =
            __bfloat162float(rsc[(plane * BS + j) * (SRB / 2) + si]);
        return bits == 4 ? 0.5f * sc : sc;
      };
      attend_keys<D, RB>(
          BS, [&](int j, float (&cv)[DPT]) { return code_row(0, j, cv) * scale; },
          [&](int j, float (&cv)[DPT]) { return code_row(1, j, cv); },
          [&](int j) { return sv[j] == 1; }, qp, acc, m_own, l_own, pb, lane);
    } else {
      // the fp TBQ buffer: G rows, valid below buf_len[r]
      const int n = min(blen[r], G);
      const size_t brow = lr * G;
      auto row = [&](const __nv_bfloat16* p, int j, float (&cv)[DPT]) {
        load_bf16<DPT>(p + ((brow + j) * H + h) * D + lgc * DPT, cv);
      };
      attend_keys<D, RB>(
          n, [&](int j, float (&cv)[DPT]) { row(bk, j, cv); return scale; },
          [&](int j, float (&cv)[DPT]) { row(bv, j, cv); return 1.f; },
          [](int) { return true; }, qp, acc, m_own, l_own, pb, lane);
    }
    __syncwarp();                               // stage k % K1_STAGES is free
  }

  // 3. this warp's (m, l, acc): l and acc summed over the lanes and groups
  //    that share a row; then the warps' merged through shared memory (the
  //    ring, once every warp's walk is done), as the reference merges two
  //    partitions
#pragma unroll
  for (int o = 1; o < KS; o <<= 1)
    l_own += __shfl_xor_sync(0xffffffffu, l_own, o);
#pragma unroll
  for (int o = LG; o < 32; o <<= 1) {
    l_own += __shfl_xor_sync(0xffffffffu, l_own, o);
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[rr][i] += __shfl_xor_sync(0xffffffffu, acc[rr][i], o);
  }
  cp_async_wait<0>();
  __syncthreads();
  constexpr int PART = RB * D + 2 * RB;
  float* mg = reinterpret_cast<float*>(sm);
  if (lane < LG) {
    if (lane < SH::LA) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          mg[warp * PART + rr * D + lane * DPT + i] = acc[rr][i];
    }
    if (lane % KS == 0) {
      mg[warp * PART + RB * D + lane / KS] = m_own;
      mg[warp * PART + RB * D + RB + lane / KS] = l_own;
    }
  }
  __syncthreads();
  for (int e = tid; e < RB * D; e += K1_THREADS) {
    const int rr = e / D, d = e % D;
    if (row0 + rr >= GQ) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) M = fmaxf(M, mg[w * PART + RB * D + rr]);
    float Ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) {
      const float wt = expf(mg[w * PART + RB * D + rr] - M);
      Ls += wt * mg[w * PART + RB * D + RB + rr];
      o = fmaf(wt, mg[w * PART + e], o);
    }
    out[((lr * H + h) * GQ + row0 + rr) * D + d] = o / fmaxf(Ls, 1e-30f);
  }
}

template <int D, int RB>
static int launch_fused(const float* qh, const uint8_t* kc, const uint8_t* vc,
                        const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                        const uint8_t* st, const uint8_t* bits,
                        const int32_t* table, const __nv_bfloat16* bk,
                        const __nv_bfloat16* bv, const int32_t* blen,
                        float* out, int L, int R, int H, int GQ, int NP,
                        int BS, int NB, int G, float scale,
                        cudaStream_t stream) {
  static int granted = 0;
  const K1Layout ly(D, BS, NB, D / 16, RB);
  cudaError_t err = allow_smem(fused_attn_kernel<D, RB>, ly.bytes, granted);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (GQ + RB - 1) / RB;
  fused_attn_kernel<D, RB><<<L * R * H * ntiles, K1_THREADS, ly.bytes,
                             stream>>>(qh, kc, vc, ks, vs, st, bits, table,
                                       bk, bv, blen, out, L, R, H, GQ, NP,
                                       BS, NB, G, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_fused_rows(int GQ, const float* qh, const uint8_t* kc,
                             const uint8_t* vc, const __nv_bfloat16* ks,
                             const __nv_bfloat16* vs, const uint8_t* st,
                             const uint8_t* bits, const int32_t* table,
                             const __nv_bfloat16* bk, const __nv_bfloat16* bv,
                             const int32_t* blen, float* out, int L, int R,
                             int H, int NP, int BS, int NB, int G,
                             float scale, cudaStream_t stream) {
  // query rows per block: GQ rounded up to a power of two, at most 8, and
  // at most LG: attend_keys gives each lane KS = LG / RB key steps a tile,
  // so at D 16 (4 lanes per key) a tile takes 4 rows and GQ > 4 is tiled
  // over more blocks (each decodes its pool blocks again: cheap at D 16,
  // and no lane is left without a whole score to fold)
  auto f = [&](auto fn) {
    return fn(qh, kc, vc, ks, vs, st, bits, table, bk, bv, blen, out, L, R,
              H, GQ, NP, BS, NB, G, scale, stream);
  };
  if (GQ <= 1) return f(launch_fused<D, 1>);
  if (GQ <= 2) return f(launch_fused<D, 2>);
  if constexpr (K1Shape<D>::LG < 8) {
    return f(launch_fused<D, 4>);
  } else {
    if (GQ <= 4) return f(launch_fused<D, 4>);
    return f(launch_fused<D, 8>);
  }
}

extern "C" int ct_paged_attention_fused(
    const void* qh, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* state, const void* bits, const void* table,
    const void* bk, const void* bv, const void* blen, void* out, int L, int R,
    int H, int GQ, int D, int NP, int BS, int NB, int G, int group,
    float scale, void* stream) {
  if (group != 16 || BS % 4 || BS <= 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || R == 0 || H == 0 || GQ == 0) return 0;
  auto f = [&](auto fn) {
    return fn(GQ, (const float*)qh, (const uint8_t*)kc, (const uint8_t*)vc,
              (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
              (const uint8_t*)state, (const uint8_t*)bits,
              (const int32_t*)table, (const __nv_bfloat16*)bk,
              (const __nv_bfloat16*)bv, (const int32_t*)blen, (float*)out, L,
              R, H, NP, BS, NB, G, scale, (cudaStream_t)stream);
  };
  switch (D) {
    case 16: return f(launch_fused_rows<16>);
    case 32: return f(launch_fused_rows<32>);
    case 64: return f(launch_fused_rows<64>);
    case 112: return f(launch_fused_rows<112>);
    case 128: return f(launch_fused_rows<128>);
    case 256: return f(launch_fused_rows<256>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K2: split-KV walk of the live pool blocks on the tensor cores
// ---------------------------------------------------------------------------

#define K2_THREADS 128
#define K2_ROWS 64              // query rows per block: 4 warps x 16
#define MAX_KT 4                // BS <= 32: at most 4 eight-key sub-tiles

// shared memory of one K2 block, in bytes from the start, for D, BS, NB
struct K2Layout {
  int deq, raw, raw_stage, state, bits, list, phys, count, bytes;
  __host__ __device__ K2Layout(int D, int BS, int NB, int SG) {
    const int LD = D + 4;
    deq = K2_ROWS * LD * 4;                    // q rows [64][LD] f32 first
    raw = deq + 2 * 2 * BS * LD * 4;           // decoded k, v: 2 stages
    raw_stage = 2 * BS * D + 2 * BS * scale_row_bytes(SG);  // codes; scales
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
                   int BS, int NB, int NS, float scale) {
  constexpr int LD = D + 4, DV = out_cols(D), NC = D / DV, NT = DV / 8;
  constexpr int SG = D / 16, SRB = scale_row_bytes(SG);   // a scale per 16
  const int KT = BS / 8;
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

  const int col = blockIdx.x % NC, split = blockIdx.x / NC % NS;
  const int tile = blockIdx.x / NC / NS;
  const int col0 = col * DV;                 // this block's output columns
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
      constexpr int spr = SRB / 4;              // 4-byte chunks per row
      uint8_t* rsc = rs + 2 * BS * D;
      for (int c = tid; c < 2 * BS * spr; c += K2_THREADS) {
        const int plane = c / (BS * spr), cc = c % (BS * spr);
        const int j = cc / spr, w = cc % spr;
        const __nv_bfloat16* src =
            (plane ? vsc : ksc) + ((row0 + j) * H + h) * SG + 2 * w;
        cp_async4(rsc + (plane * BS + j) * SRB + 4 * w,
                  SG == 1 ? scale_word(src) : src);
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
    const size_t row0 = (size_t)phys[list[first + i]] * BS;
    float* kd = deq + (i & 1) * 2 * BS * LD;
    const int words = BS * D / 4;
    for (int w = tid; w < 2 * words; w += K2_THREADS) {
      const int plane = w >= words, ww = w - plane * words;
      const int j = ww / (D / 4), d = (ww % (D / 4)) * 4;
      const uint32_t cw = reinterpret_cast<const uint32_t*>(rs)[w];
      const int si = SG == 1 ? scale_half((row0 + j) * H + h) : d / 16;
      const float sc = __bfloat162float(rsc[(plane * BS + j) * (SRB / 2) + si]);
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
      const float* vb = vd + (n * 8 + 2 * t) * LD + col0 + g;
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
    float* dst = (NS == 1 ? out : part) + idx * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    if (t == 0 && col == 0) {
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

// The flash merge of NS partials (unnormalised out, m, l) of each row, RL =
// min(D, 32) lanes per row (a warp, or at D 16 half a warp: two rows per
// warp), PER = D / RL values a lane: out = sum_s e^(m_s - M) out_s /
// max(L, 1e-30) with M = max_s m_s and L = sum_s e^(m_s - M) l_s.  Rows no
// split saw keep M = -1e30, L = 0, out = 0.
template <int D>
__global__ void __launch_bounds__(128)
merge_splits_kernel(const float* __restrict__ part,
                    const float* __restrict__ pml, float* __restrict__ out,
                    float* __restrict__ mo, float* __restrict__ lo, int rows,
                    int NS) {
  constexpr int RL = D < 32 ? D : 32, PER = D / RL;
  constexpr int SPL = 32 / RL;                  // splits a lane holds
  static_assert(SPL <= 2, "merge_splits_kernel takes D >= 16");
  const int row_raw = (blockIdx.x * blockDim.x + threadIdx.x) / RL;
  const int lane = threadIdx.x % RL;
  // a row past the end computes row 0 with its half warp and writes nothing
  // (the shuffles below take the whole warp)
  const bool live = row_raw < rows;
  const int row = live ? row_raw : 0;
  // lane i of the row holds the stats of splits i and i + RL (NS <= 32)
  float ms[SPL], ls[SPL], M = NEG_INF;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int s = lane + k * RL;
    const size_t own = (size_t)s * rows + row;
    ms[k] = s < NS ? pml[2 * own] : NEG_INF;
    ls[k] = s < NS ? pml[2 * own + 1] : 0.f;
    M = fmaxf(M, ms[k]);
  }
#pragma unroll
  for (int off = RL / 2; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float w[SPL], L = 0.f;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    w[k] = lane + k * RL < NS ? expf(ms[k] - M) : 0.f;
    L += w[k] * ls[k];
  }
#pragma unroll
  for (int off = RL / 2; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < NS; ++s) {
    const float ws = __shfl_sync(0xffffffffu, s < RL ? w[0] : w[SPL - 1],
                                 s % RL, RL);
    const float* src = part + ((size_t)s * rows + row) * D + lane * PER;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] = fmaf(ws, src[e], acc[e]);
  }
  if (!live) return;
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
                          int NB, int NS, float scale, cudaStream_t stream) {
  static int granted = 0;
  const K2Layout ly(D, BS, NB, D / 16);
  cudaError_t err = allow_smem(paged_split_kernel<D>, ly.bytes, granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / out_cols(D) * NS * ((GQ + K2_ROWS - 1) / K2_ROWS), H, R);
  paged_split_kernel<D><<<grid, K2_THREADS, ly.bytes, stream>>>(
      qh, kc, vc, ks, vs, st, bits, table, out, mo, lo, part, pml, R, H, GQ,
      NP, BS, NB, NS, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return (int)err;
  const int rows = R * H * GQ, lanes = D < 32 ? D : 32;
  merge_splits_kernel<D><<<(rows * lanes + 127) / 128, 128, 0, stream>>>(
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
              (float*)part, (float*)pml, R, H, GQ, NP, BS, NB, NS,
              scale, (cudaStream_t)stream);
  };
  switch (D) {
    case 16: return f(launch_batched<16>);
    case 32: return f(launch_batched<32>);
    case 64: return f(launch_batched<64>);
    case 128: return f(launch_batched<128>);
    case 256: return f(launch_batched<256>);
    default: return (int)cudaErrorInvalidValue;
  }
}
