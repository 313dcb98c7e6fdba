// Two probes of mma.sync.m16n8k8 with .tf32 operands (sm_90a), built and
// run by tools/swa_probe.py (plain C interface, ctypes):
// * tf32_probe_mma: how the tensor cores read an f32 bit pattern given as
//   a .tf32 operand.  One warp computes D = A . B (A 16x8, B 8x8,
//   row-major f32 arrays) with the raw bits in the fragments, no cvt.  With
//   one operand set to 1.0 (exact in tf32) D shows what the other was read
//   as: truncated to 10 mantissa bits, rounded, or used in full.
// * tf32_probe_rate: the rate at which the card runs such products with
//   nothing else to do: each warp issues `iters` rounds of 8 independent
//   m16n8k8 products (8 accumulators, operands in registers), so the time
//   of a launch over every SM gives mma.sync's TF32 ceiling, the limit of
//   a kernel built on it (swa_tf32.cu).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tf32_mma(const float* a, const float* b, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a0 = __float_as_uint(a[g * 8 + t]);
  const uint32_t a1 = __float_as_uint(a[(g + 8) * 8 + t]);
  const uint32_t a2 = __float_as_uint(a[g * 8 + t + 4]);
  const uint32_t a3 = __float_as_uint(a[(g + 8) * 8 + t + 4]);
  const uint32_t b0 = __float_as_uint(b[t * 8 + g]);
  const uint32_t b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = c0;
  d[g * 8 + 2 * t + 1] = c1;
  d[(g + 8) * 8 + 2 * t] = c2;
  d[(g + 8) * 8 + 2 * t + 1] = c3;
}

__global__ void tf32_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  float c[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) sum += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// blocks x threads, each warp 8 * iters products of 16 x 8 x 8
extern "C" int tf32_probe_rate(void* out, int blocks, int threads, int iters, void* stream) {
  tf32_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" int tf32_probe_mma(const void* a, const void* b, void* d, void* stream) {
  tf32_mma<<<1, 32, 0, (cudaStream_t)stream>>>(static_cast<const float*>(a),
                                                 static_cast<const float*>(b),
                                                 static_cast<float*>(d));
  return (int)cudaGetLastError();
}
