// f64 tensor-core products and cp.async copies, sm_90a: the products for
// K2 (ct_paged_attention.cu) and K3 (flash_prefill.cu), the copies for
// them, K1 and K5 (mamba_scan.cu); and the output columns a K2 or K3 block
// owns (out_cols).
//
// Why f64: the kernels are held to 1e-4 against their f32 plain versions
// on out and on the flash stats (m, l).  One TF32 product (10 mantissa
// bits) misses that on scores of magnitude ~10.  3xTF32 (hi/lo splits)
// reached it at K3's shapes, but K2's l over 2048 keys (l ~ 50) stayed
// 1.1-1.7e-4 from the plain version however the products were rounded:
// the f32 plain version's own rounding is that large there.  On f64
// tensor cores f32 operands multiply exactly and sums keep 53 bits, so the
// kernels' scores carry no error of their own; and at these shapes the
// m16n8k16 f64 product also ran faster on an H100 than 3xTF32 m16n8k8.
//
// Fragments, with g = lane / 4 and t = lane % 4 (rows of A and C, columns
// of B and C; k the summed index):
//   m16n8k16: a [8] A (g + 8 (i % 2), k = t + 4 (i / 2)), b [4] B (k = t +
//             4 j, n = g)
//   m16n8k8:  a [4] and b [2] the same rule
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A score tile C feeds the next product P.V as its A operand without a
// shuffle when the 8 keys of each sub-tile are summed in the order
// (0, 2, 4, 6, 1, 3, 5, 7): a = (c0, c2, c1, c3), and V's B fragment
// reads keys 2t and 2t + 1 (see the P.V loops).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// The output columns a K2 or K3 block owns: all of D up to 128, else 128
// (a thread's f32 accumulator of P.V, o[out_cols / 8][4], stays within
// the register budget; ops.OUT_COLS on the host side).
__host__ __device__ constexpr int out_cols(int D) { return D > 128 ? 128 : D; }

// d += a b, one m16n8k16 f64 product on the tensor cores (sm_90)
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// d += a b, one m16n8k8 f64 product (sm_90)
__device__ __forceinline__ void mma_f64_k8(double (&d)[4],
                                           const double (&a)[4],
                                           const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full = true) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full = true) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// the largest dynamic shared memory a kernel was given so far: the
// attribute is set once per kernel and size, not on every launch, with the
// SM's whole carveout given to shared memory so that two blocks of up to
// ~110 KB share an SM
template <typename Fn>
static cudaError_t allow_smem(Fn fn, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) granted = bytes;
  return err;
}
