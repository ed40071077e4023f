// TBQ group quantization for the CT cache commit, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/group_quant.py: group_quant
// (_kernel, _e4m3_next_up).  Bit-exact to core/quantization.quantize_group:
// per `group` lanes of a row take amax, divide by qmax (1 / 6 / 127 for
// 2 / 4 / 8 bits), round to E4M3 (round to nearest even, saturating at 448),
// step one E4M3 value up when s * qmax < amax, floor the scale at 2^-16,
// then encode uint8 codes (nvfp4 thresholds, ternary {0, 1, 3} or int8
// two's complement) of x / s; the scale is stored as bf16 (E4M3 values are
// exact in bf16).
//
// Bound on this card: bytes (4 B read, 1.125 B written per element, a few
// flops each).  Design: one thread per (row, group); the amax, scale and
// codes of a group never leave registers, and consecutive threads cover
// consecutive groups of a row so reads and writes stay coalesced.  The E4M3
// rounding is the hardware conversion (cvt.rn.satfinite.e4m3), which is what
// makes the scales bit-exact without a software rounding routine.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#define SCALE_EPS (1.0f / 65536.0f)

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

__global__ void group_quant_kernel(const float* __restrict__ x,
                                   uint8_t* __restrict__ codes,
                                   __nv_bfloat16* __restrict__ scales,
                                   long long n_groups, int group, int bits) {
  long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= n_groups) return;
  const float* xg = x + gi * group;
  float amax = 0.f;
  for (int k = 0; k < group; ++k) amax = fmaxf(amax, fabsf(xg[k]));
  const float qmax = bits == 2 ? 1.f : (bits == 4 ? 6.f : 127.f);
  const float s = group_scale(amax, qmax);
  uint8_t* cg = codes + gi * group;
  for (int k = 0; k < group; ++k) {
    float y = xg[k] / s;
    unsigned c;
    if (bits == 4) {
      float mag = fabsf(y);
      c = (unsigned)(mag >= 0.25f) + (mag >= 0.75f) + (mag >= 1.25f) +
          (mag >= 1.75f) + (mag >= 2.5f) + (mag >= 3.5f) + (mag >= 5.0f);
      c |= (y < 0.f ? 1u : 0u) << 3;
    } else if (bits == 2) {
      float r = fminf(fmaxf(rintf(y), -1.f), 1.f);
      c = r < 0.f ? 3u : (unsigned)r;
    } else {
      float r = fminf(fmaxf(rintf(y), -128.f), 127.f);
      c = (unsigned)((int)r & 0xFF);
    }
    cg[k] = (uint8_t)c;
  }
  scales[gi] = __float2bfloat16_rn(s);
}

extern "C" int group_quant(const void* x, void* codes, void* scales, int n,
                           int d, int group, int bits, void* stream) {
  long long n_groups = (long long)n * (d / group);
  if (n_groups == 0) return 0;
  int threads = 128;
  long long blocks = (n_groups + threads - 1) / threads;
  group_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)codes, (__nv_bfloat16*)scales, n_groups,
      group, bits);
  return (int)cudaGetLastError();
}
