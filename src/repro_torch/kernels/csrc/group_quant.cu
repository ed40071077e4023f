// TBQ group quantization for the CT cache commit, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/group_quant.py: group_quant
// (_kernel, _e4m3_next_up).  Bit-exact to core/quantization.quantize_group:
// per 16 lanes of a row take amax, divide by qmax (1 / 6 / 127 for 2 / 4 / 8
// bits), round to E4M3 (round to nearest even, saturating at 448), step one
// E4M3 value up when s * qmax < amax, floor the scale at 2^-16, then encode
// uint8 codes (nvfp4 thresholds, ternary {0, 1, 3} or int8 two's
// complement) of x / s; the scale is stored as bf16 (E4M3 values are exact
// in bf16).
//
// Two entries run one kernel body, templated on the input type:
//   * group_quant: the TPU kernel's interface, f32 [N, D] at a bit width
//     the host gives;
//   * group_quant_commit: one CT cache commit in ONE launch, K and V (bf16
//     [L, G, H, D] each, blockIdx.y the plane) at the thought's width, read
//     on the device from the int32 that policy.psi_bits returns.  It is
//     resolved as the reference's selection chain resolves it
//     (core/ct_cache.py::_quantize_group_by_thought: the first precision
//     level, replaced by the level equal to the bits): the bits if they
//     are one of the levels (a bit mask), else the first level.  So the
//     commit is bit-identical to quantizing at every level and selecting,
//     for any precision tuple, with no host read and no f32 copy of the
//     buffers (widening bf16 to f32 is exact).
//
// Bound on this card: bytes (2 or 4 B read, 1.125 B written per element, a
// few operations each).  The first design took one thread per group with
// 16 scalar loads 64 bytes apart across neighbouring threads and 16
// single-byte stores, and a commit took 4 launches of it (2 levels x K, V)
// after 2 casts, then 4 selects.  This design takes two neighbouring
// threads per (plane, 16-lane group), 8 lanes each; the amax (one shuffle
// between the two), the scale and the codes stay in registers:
//   * a thread's 8 lanes arrive in 16-byte loads (one for bf16, two for
//     f32), neighbouring threads on neighbouring addresses;
//   * its 8 codes leave in one 8-byte store, so a warp's stores coalesce,
//     and the first thread of a pair writes the group's scale;
//   * the width is uniform over the grid, so its branch does not diverge.
// A thread per group (two 16-byte loads, one 16-byte store) left half as
// many loads in flight and 16 serial divisions per thread: at a commit's
// shape it took ~1.4x the time of this design on an H100 (PERF.md);
// four threads per group were no faster than two.
// The E4M3 rounding is the hardware conversion (cvt.rn.satfinite.e4m3),
// which makes the scales bit-exact without a software rounding routine;
// x / s stays an IEEE division (the build has no --use_fast_math).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#define SCALE_EPS (1.0f / 65536.0f)
#define GROUP 16
#define LANES 8                 // a thread's lanes: two threads per group
#define THREADS 256

__device__ __forceinline__ float e4m3_bits_to_float(unsigned b) {
  int e = (b >> 3) & 0xF, m = b & 7;
  float v = e == 0 ? ldexpf((float)m, -9) : ldexpf(1.f + (float)m * 0.125f, e - 7);
  return (b & 0x80) ? -v : v;
}

__device__ __forceinline__ unsigned e4m3_bits(float x) {
  return (unsigned)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float group_scale(float amax, float qmax) {
  float raw = fmaxf(amax, SCALE_EPS) / qmax;
  float s = e4m3_bits_to_float(e4m3_bits(fminf(fmaxf(raw, -448.f), 448.f)));
  if (s * qmax < amax)
    s = s >= 448.f ? 448.f : e4m3_bits_to_float((e4m3_bits(s) + 1) & 0xFF);
  return fmaxf(s, SCALE_EPS);
}

// a thread's 8 values, by 16-byte loads
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[LANES]) {
#pragma unroll
  for (int k = 0; k < LANES / 4; ++k) {
    const float4 f = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}

__device__ __forceinline__ void load_lanes(const __nv_bfloat16* p,
                                           float (&v)[LANES]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {               // bf16 -> f32 is exact
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <int BITS>
__device__ __forceinline__ unsigned encode(float y) {
  if constexpr (BITS == 4) {
    const float mag = fabsf(y);
    unsigned c = (unsigned)(mag >= 0.25f) + (mag >= 0.75f) + (mag >= 1.25f) +
                 (mag >= 1.75f) + (mag >= 2.5f) + (mag >= 3.5f) + (mag >= 5.0f);
    return c | ((y < 0.f ? 1u : 0u) << 3);
  } else if constexpr (BITS == 2) {
    const float r = fminf(fmaxf(rintf(y), -1.f), 1.f);
    return r < 0.f ? 3u : (unsigned)r;
  } else {
    const float r = fminf(fmaxf(rintf(y), -128.f), 127.f);
    return (unsigned)((int)r & 0xFF);
  }
}

// the 8 codes of x / s packed four to a word, in lane order
template <int BITS>
__device__ __forceinline__ uint2 encode_lanes(const float (&v)[LANES],
                                              float s) {
  uint32_t w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    w[k] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[k] |= encode<BITS>(v[4 * k + i] / s) << (8 * i);
  }
  return make_uint2(w[0], w[1]);
}

// Plane blockIdx.y of (x0 | x1) -> (codes0 | codes1, scales0 | scales1), two
// threads per 16-lane group.  The width is `bits`, or, when bits_dev is
// given, *bits_dev if bit *bits_dev of level_mask is set, else `bits`.
// That fallback mirrors the reference's selection chain (a width that is
// no level takes the first level); the shipped policies only return
// levels, so no commit of theirs reaches it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
group_quant_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                   uint8_t* __restrict__ codes0, uint8_t* __restrict__ codes1,
                   __nv_bfloat16* __restrict__ scales0,
                   __nv_bfloat16* __restrict__ scales1, int n_groups,
                   const int32_t* __restrict__ bits_dev, int bits,
                   int level_mask) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  // a pair past the last group reads group 0 and stores nothing (the
  // shuffle takes the whole warp)
  const bool live = t / 2 < n_groups;
  const size_t e0 = (size_t)(live ? t / 2 : 0) * GROUP + (t % 2) * LANES;
  const bool second = blockIdx.y != 0;
  int b = bits;
  if (bits_dev != nullptr) {
    const int w = *bits_dev;
    if (w >= 0 && w < 32 && ((level_mask >> w) & 1)) b = w;
  }
  float v[LANES];
  load_lanes((second ? x1 : x0) + e0, v);
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < LANES; ++k) amax = fmaxf(amax, fabsf(v[k]));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  if (!live) return;
  const float s = group_scale(amax, b == 2 ? 1.f : (b == 4 ? 6.f : 127.f));
  const uint2 c = b == 4 ? encode_lanes<4>(v, s)
                         : (b == 2 ? encode_lanes<2>(v, s) : encode_lanes<8>(v, s));
  *reinterpret_cast<uint2*>((second ? codes1 : codes0) + e0) = c;
  if (t % 2 == 0) (second ? scales1 : scales0)[t / 2] = __float2bfloat16_rn(s);
}

template <typename T>
static int launch(const T* x0, const T* x1, uint8_t* c0, uint8_t* c1,
                  __nv_bfloat16* s0, __nv_bfloat16* s1, int n_groups,
                  int planes, const int32_t* bits_dev, int bits,
                  int level_mask, cudaStream_t stream) {
  if (n_groups == 0) return 0;
  if (n_groups > (1 << 30)) return (int)cudaErrorInvalidValue;  // 2 n in int
  const dim3 grid((2 * n_groups + THREADS - 1) / THREADS, planes);
  group_quant_kernel<T><<<grid, THREADS, 0, stream>>>(
      x0, x1, c0, c1, s0, s1, n_groups, bits_dev, bits, level_mask);
  return (int)cudaGetLastError();
}

static bool is_width(int b) { return b == 2 || b == 4 || b == 8; }

// x [n, d] f32 -> codes [n, d] uint8, scales [n, d / 16] bf16 at `bits`
extern "C" int group_quant(const void* x, void* codes, void* scales, int n,
                           int d, int group, int bits, void* stream) {
  if (group != GROUP || d % GROUP || !is_width(bits))
    return (int)cudaErrorInvalidValue;
  return launch((const float*)x, (const float*)x, (uint8_t*)codes,
                (uint8_t*)codes, (__nv_bfloat16*)scales,
                (__nv_bfloat16*)scales, n * (d / GROUP), 1, nullptr, bits, 0,
                (cudaStream_t)stream);
}

// One commit: k, v bf16 (n_groups groups of 16 each) -> their codes and
// scales, at the width that *bits (int32, on the device) resolves to
// against the levels in level_mask (bit b set for level b), the first
// level `first` when it names none of them.
extern "C" int group_quant_commit(const void* k, const void* v, void* kc,
                                  void* vc, void* ks, void* vs,
                                  const void* bits, int n_groups, int first,
                                  int level_mask, void* stream) {
  if (!is_width(first) || !((level_mask >> first) & 1) ||
      (level_mask & ~0x114))
    return (int)cudaErrorInvalidValue;
  return launch((const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                (uint8_t*)kc, (uint8_t*)vc, (__nv_bfloat16*)ks,
                (__nv_bfloat16*)vs, n_groups, 2, (const int32_t*)bits, first,
                level_mask, (cudaStream_t)stream);
}
