// Microbenchmarks of the Hopper resources that bound K1 (csrc/knn2.cu),
// run by `python3 chip_smoke.py --microbench`:
//  * FFMA issue rate: independent chains, and an 8x8 outer product from
//    registers (the tile kernel's inner loop without its loads);
//  * SM cycles per warp-wide float4 shared load, by address pattern;
//  * SM cycles per 2048-float chunk copied global -> shared with cp.async,
//    4-byte copies (the transposing pattern of knn2.cu) against 16-byte.
// Each entry point launches one kernel on the default stream and returns
// cudaGetLastError(); the caller times it with CUDA events.

#include <cuda_runtime.h>

namespace {

__global__ void ffma_chains(float* out, int iters, float y, float z) {
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], y, z);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  if (s == 1.2345f) out[0] = s;
}

__global__ void ffma_outer8x8(float* out, int iters, const float* in) {
  float a[8], b[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = in[(threadIdx.x + i) & 255];
    b[i] = in[(threadIdx.x * 3 + i) & 255];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = -a[i];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  if (s == 1.2345f) out[0] = s;
}

// MODE 0: 32 distinct float4 per warp; 1: 8 distinct, the same 8 in every
// quarter-warp (knn2's train reads); 2: one address per quarter-warp
// (broadcast within 8 lanes); 3: one address per half-warp (knn2's query
// reads); 4: one address for the warp.
template <int MODE>
__global__ void lds128(int* out, int iters) {
  __shared__ int4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) buf[i] = make_int4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = MODE == 0 ? lane : MODE == 1 ? (lane & 7) : MODE == 2 ? (lane >> 3)
                : MODE == 3 ? (lane >> 4) : 0;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int base = (it & 31) * 32;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int4 v = buf[(base + u * 32 + idx) & 2047];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x12345678) out[0] = acc;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src));
}

// One 16 x 128 chunk of a (128, 128) row-major block per iteration: as
// 4-byte copies transposed into [k][row] (knn2.cu's pattern), or as 16-byte
// copies kept [row][k]; at most two chunks in flight.
template <int WIDE>
__global__ void copy_chunks(const float* g, float* out, int iters) {
  __shared__ __align__(16) float buf[16 * 132 * 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* block = g + (blockIdx.x % 64) * 128 * 128;
  for (int it = 0; it < iters; ++it) {
    const float* src = block + ((it * 16) & 127);
    if (!WIDE) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cp4(buf + (8 * h + (lane >> 2)) * 132 + warp * 4 + (lane & 3) + 32 * m,
              src + (size_t)(warp * 4 + (lane & 3) + 32 * m) * 128 + 8 * h + (lane >> 2));
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = (threadIdx.x >> 2) + 64 * u;
        const int k = (threadIdx.x & 3) * 4;
        cp16(buf + row * 20 + k, src + (size_t)row * 128 + k);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (buf[threadIdx.x] == 1.2345f) out[0] = 1.f;
}

}  // namespace

extern "C" {

// 256 threads a block; `iters` rounds of 128 (chains) or 256 (outer) FMAs.
int mb_ffma(int outer, int blocks, int iters, float* out, const float* in) {
  if (outer) ffma_outer8x8<<<blocks, 256>>>(out, iters, in);
  else ffma_chains<<<blocks, 256>>>(out, iters, 0.999f, 0.001f);
  return (int)cudaGetLastError();
}

// 512 threads a block; `iters` rounds of 8 loads.
int mb_lds128(int mode, int blocks, int iters, int* out) {
  switch (mode) {
    case 0: lds128<0><<<blocks, 512>>>(out, iters); break;
    case 1: lds128<1><<<blocks, 512>>>(out, iters); break;
    case 2: lds128<2><<<blocks, 512>>>(out, iters); break;
    case 3: lds128<3><<<blocks, 512>>>(out, iters); break;
    default: lds128<4><<<blocks, 512>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}

// 256 threads a block; `g` holds 64 blocks of 128 x 128 floats.
int mb_copy(int wide, int blocks, int iters, const float* g, float* out) {
  if (wide) copy_chunks<1><<<blocks, 256>>>(g, out, iters);
  else copy_chunks<0><<<blocks, 256>>>(g, out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
