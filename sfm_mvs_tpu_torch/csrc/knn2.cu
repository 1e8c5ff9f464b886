// Fused brute-force 2-NN descriptor matching for Hopper (sm_90a).
//
// Replaces the TPU kernel sfm_mvs_tpu/ops/matching_pallas.py:_knn2_kernel.
// For every query row q it returns the smallest squared L2 distance d1 to
// a train row, that row's index j1 (lowest column on ties) and the
// second-smallest distance d2, with
//
//     d = max((|q|^2 + |t|^2) - 2 q.t, 0),   d = 3e38 for invalid columns,
//
// rounded in exactly that order (the plain version in ops/matching.py uses
// the same expression). The (N0, N1) distance matrix never reaches memory.
//
// What bounds it: at the main-path shape (4096 x 4096 x 128) the cross
// term is 2.1 G fused multiply-adds (4.3 GFLOP) over 4 MiB of input, so it
// is bound by FP32 FMA throughput on the CUDA cores, not by memory; the
// plain version instead writes and re-reads a 64 MiB distance matrix.
// Tensor cores are not used: TF32 would change the distances and with them
// the ratio test's decisions.
//
// Design (simple and correct first):
//  * knn2_tile_kernel: one block per (64-query tile, train split). The
//    query tile sits in shared memory for the whole block; a loop inside the
//    block walks the split's 64-column train tiles in ascending order
//    (this loop replaces the TPU's sequential grid axis and its VMEM carry,
//    which cannot carry across GPU blocks). Each of the 256 threads owns a
//    4x4 register tile of cross terms and keeps a running (best, second,
//    arg) for its 4 query rows. The 16 threads sharing a row merge their
//    partials with warp shuffles; ties keep the lowest column.
//  * knn2_merge_kernel: folds the per-split partials of each row in split
//    order. Splitting the train axis gives the 4096-row problem enough
//    blocks to fill all SMs.
// Ragged edges: query rows past N0 are zero-filled and never stored, train
// columns past N1 are zero-filled and never folded.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BT = 64;       // train columns per tile
constexpr int BK = 16;       // depth of one staged train chunk
constexpr int MAXD = 128;    // largest descriptor width held in shared memory
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr float BIG = 3.0e38f;
constexpr int IMAX = 0x7fffffff;

struct Top2 {
  float b1, b2;
  int j;
};

// Merge two partial (best, second, arg) summaries of disjoint column sets.
// The best is the lexicographic minimum of (value, column); the second is
// the smaller of the winner's second and the loser's best.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_wins = (a.b1 < b.b1) || (a.b1 == b.b1 && a.j < b.j);
  Top2 r;
  if (a_wins) {
    r.b1 = a.b1; r.j = a.j; r.b2 = fminf(a.b2, b.b1);
  } else {
    r.b1 = b.b1; r.j = b.j; r.b2 = fminf(b.b2, a.b1);
  }
  return r;
}

__global__ void __launch_bounds__(THREADS)
knn2_tile_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
                 const float* __restrict__ t, const float* __restrict__ tsq,
                 const uint8_t* __restrict__ tvalid, int n0, int n1, int d,
                 int tiles_per_split, float* __restrict__ part_b1,
                 float* __restrict__ part_b2, int* __restrict__ part_j) {
  __shared__ float qs[MAXD][BQ];  // query tile, transposed: qs[k][row]
  __shared__ float ts[BK][BT];    // one depth chunk of a train tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int row0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;

  // Stage the query tile once (float4 loads; d % 16 == 0 is checked by the
  // caller). Rows past n0 are zero.
  for (int e = tid; e < BQ * (d / 4); e += THREADS) {
    const int r = e % BQ;  // neighbouring threads store to neighbouring banks
    const int k4 = (e / BQ) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n0) {
      v = *reinterpret_cast<const float4*>(q + (size_t)(row0 + r) * d + k4);
    }
    qs[k4 + 0][r] = v.x;
    qs[k4 + 1][r] = v.y;
    qs[k4 + 2][r] = v.z;
    qs[k4 + 3][r] = v.w;
  }

  float my_qsq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    my_qsq[i] = r < n0 ? qsq[r] : 0.f;
  }

  Top2 best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i].b1 = CUDART_INF_F;
    best[i].b2 = CUDART_INF_F;
    best[i].j = IMAX;
  }

  const int n_tiles = (n1 + BT - 1) / BT;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int col0 = tile * BT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();  // previous chunk fully consumed (and qs staged)
      {
        // 64 columns x 16 depth = 256 float4 loads, one per thread.
        const int c = tid / 4;
        const int kk = (tid % 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col0 + c < n1) {
          v = *reinterpret_cast<const float4*>(t + (size_t)(col0 + c) * d + k0 + kk);
        }
        ts[kk + 0][c] = v.x;
        ts[kk + 1][c] = v.y;
        ts[kk + 2][c] = v.z;
        ts[kk + 3][c] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[k0 + kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ts[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // Distance epilogue and streaming top-2 fold. A thread visits its
    // columns in ascending order, so strict '<' keeps the lowest column on
    // ties and an equal value becomes the second best.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n1) continue;
      const float tq = tsq[col];
      const bool ok = tvalid[col] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Explicit round-to-nearest intrinsics: no FMA contraction, so the
        // value rounds as max((qsq + tsq) - 2 * cross, 0) does.
        float v = __fsub_rn(__fadd_rn(my_qsq[i], tq), __fmul_rn(2.0f, acc[i][j]));
        v = fmaxf(v, 0.f);
        v = ok ? v : BIG;
        if (v < best[i].b1) {
          best[i].b2 = best[i].b1;
          best[i].b1 = v;
          best[i].j = col;
        } else {
          best[i].b2 = fminf(best[i].b2, v);
        }
      }
    }
  }

  // The 16 threads of a row group are 16 consecutive lanes of one warp.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Top2 m = best[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      Top2 o;
      o.b1 = __shfl_xor_sync(0xffffffffu, m.b1, off, 16);
      o.b2 = __shfl_xor_sync(0xffffffffu, m.b2, off, 16);
      o.j = __shfl_xor_sync(0xffffffffu, m.j, off, 16);
      m = merge(m, o);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < n0) {
      const size_t o = (size_t)r * n_splits + split;
      part_b1[o] = m.b1;
      part_b2[o] = m.b2;
      part_j[o] = m.j;
    }
  }
}

__global__ void knn2_merge_kernel(const float* __restrict__ part_b1,
                                  const float* __restrict__ part_b2,
                                  const int* __restrict__ part_j, int n0,
                                  int n_splits, float* __restrict__ d1,
                                  int* __restrict__ j1, float* __restrict__ d2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n0) return;
  Top2 m;
  m.b1 = CUDART_INF_F;
  m.b2 = CUDART_INF_F;
  m.j = IMAX;
  for (int s = 0; s < n_splits; ++s) {
    const size_t o = (size_t)r * n_splits + s;
    Top2 p;
    p.b1 = part_b1[o];
    p.b2 = part_b2[o];
    p.j = part_j[o];
    m = merge(m, p);
  }
  // With a single train column there is no second candidate: the plain
  // version reports 3e38 there, as it does for a masked column.
  d1[r] = fminf(m.b1, BIG);
  d2[r] = fminf(m.b2, BIG);
  j1[r] = m.j;
}

}  // namespace

extern "C" {

// Tile sizes and the widest descriptor the kernel holds (the caller picks
// the train split and sizes its scratch from these).
int knn2_tile_rows() { return BQ; }
int knn2_tile_cols() { return BT; }
int knn2_max_dim() { return MAXD; }

// Launches both kernels on `stream`. part_* hold n0 * n_splits entries.
// Returns cudaGetLastError() after the launches (0 on success).
int knn2_launch(const float* q, const float* qsq, const float* t,
                const float* tsq, const uint8_t* tvalid, int n0, int n1,
                int d, int n_splits, float* part_b1, float* part_b2,
                int* part_j, float* d1, int* j1, float* d2, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_tiles = (n1 + BT - 1) / BT;
  const int tiles_per_split = (n_tiles + n_splits - 1) / n_splits;
  dim3 grid((n0 + BQ - 1) / BQ, n_splits);
  knn2_tile_kernel<<<grid, THREADS, 0, s>>>(q, qsq, t, tsq, tvalid, n0, n1, d,
                                            tiles_per_split, part_b1, part_b2,
                                            part_j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn2_merge_kernel<<<(n0 + 127) / 128, 128, 0, s>>>(part_b1, part_b2, part_j,
                                                     n0, n_splits, d1, j1, d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
