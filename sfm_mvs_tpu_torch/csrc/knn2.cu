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
// the same expression), and, when asked, the Lowe ratio test on them. The
// (N0, N1) distance matrix never reaches memory.
//
// What bounds it: at the main-path shape (4096 x 4096 x 128) the cross
// term is 2.1 G fused multiply-adds (4.3 GFLOP) over 4 MiB of input. At
// the H100's 67 TFLOP/s of FP32 on the CUDA cores that is 64.1 us, against
// 1.3 us to read the input at 3.35 TB/s: K1 is bound by FP32 FMA issue.
// Tensor cores are not used: they have no FP32 mode, and TF32 would change
// the distances and with them the ratio test's decisions.
//
// Arithmetic (kept bitwise from the first version of this kernel): each
// cross term is one FMA chain over k = 0..D-1, ascending, from 0; the
// epilogue is __fsub_rn(__fadd_rn(qsq, tsq), __fmul_rn(2, acc)), fmaxf with
// 0, then the column mask; the norms come from the wrapper. The top-2 fold
// and merges order candidates by (value, column), which gives the same
// (d1, j1, d2) in any fold order, so the tiling below changes no output bit.
//
// What held the first design (64x64 block tiles, 4x4 per thread, one block
// per (64-row tile, train split)) back, and what this one does:
//  1. Shared-memory bandwidth: 8 scalar shared loads per 16 FMAs. Now each
//     thread owns an 8x8 register tile (64 accumulators) of a 128x128 block
//     tile and reads its 8 query and 8 train values per k as four float4
//     loads. On this card a warp's float4 shared load costs 4 SM cycles
//     (2 when each half-warp reads one address; `chip_smoke.py
//     --microbench`), so a half-warp shares its rows: per k a warp's 64
//     FMAs (16 SM cycles of FMA issue) need 12 shared cycles, where 16 FMAs
//     (4 cycles) needed 8 before.
//  2. Single-buffered staging with two barriers per 16-deep chunk: train
//     chunks (16 k x 128 columns) now stream through a two-slot ring with
//     cp.async, one barrier per chunk, so the next chunk's copies are in
//     flight while the current chunk's FMAs run. The operands are stored
//     k-major (transposed), which the float4 reads need; cp.async's 4-byte
//     form places one value per lane and so transposes, which TMA (a tile
//     copied as it is) cannot. The 4-byte copies cost about twice the
//     shared-pipe cycles of 16-byte ones; with the loads above, the shared
//     pipe stays this design's tightest resource (a [col][k] layout fed by
//     16-byte copies needs 32 more registers for float4 reads along k and
//     ran slower). Rows are padded to 132 floats: the copies
//     (4 columns x 8 k per warp instruction) and the reads are then free of
//     bank conflicts, and every read address is an immediate. The 128-row
//     query tile is copied the same way during the first tile and stays
//     resident (66 KiB); with the ring and the running top-2 a block holds
//     106.5 KiB of dynamic shared memory, two blocks an SM.
//  3. Grid tail: 320 blocks of 64 rows over 132 SMs left ~19% idle at the
//     end. The train axis is now split by a planner in the wrapper
//     (ops/matching_cuda.py:plan_splits) that picks the split count with
//     the fewest tile-steps per SM: at 4096 x 4096, 32 row tiles x 8
//     splits = 256 blocks of 4 tiles each, one wave on 132 SMs x 2.
//  4. Small device ops around the kernels: the merge kernel now also does
//     the ratio test and the query mask and writes idx0, so the wrapper
//     launches the two norm reductions and these two kernels, nothing else.
// Besides, the per-tile epilogue is branch-free and the chunk loop keeps
// counters instead of dividing by the runtime chunk count.
//
// Ragged edges: query rows past N0 and train columns past N1 are copied as
// zeros (cp.async's zero-fill), never stored and never folded.
//
// Batches: one launch matches B pairs of the same shape (the JAX package
// vmaps its kernel over pairs). Pair b is blockIdx.z of the tile kernel and
// blockIdx.y of the merge kernel; every array is B consecutive per-pair
// blocks, and each kernel first moves its pointers to pair b's block. A
// pair's blocks then compute exactly what a launch of that pair alone does,
// so each pair's outputs equal its single launch's bit for bit (the split
// count, which plan_splits now picks for B x row tiles, changes no bit).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;         // query rows per thread
constexpr int TN = 8;         // train columns per thread
constexpr int THREADS = 256;  // 8 warps of 2 row groups x 16 column groups
constexpr int BQ = 16 * TM;   // query rows per block
constexpr int BT = 128;       // train columns per tile
constexpr int BK = 16;        // depth of one staged chunk
constexpr int MAXD = 128;     // largest descriptor width held in shared memory
constexpr int LDQ = BQ + 4;   // padded row lengths of the shared operands
constexpr int LDT = BT + 4;
constexpr int STAGES = 2;     // train chunks in flight
constexpr int SMEM_BYTES = (MAXD * LDQ + STAGES * BK * LDT + 3 * TM * THREADS) * 4;
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

// 4-byte asynchronous copy global -> shared; copies a zero when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies one BK-deep chunk of ROWS rows of a row-major (n, d) matrix into
// shared memory as [k][row] (row length LD). Thread (warp, lane) copies
// rows warp*4 + (lane & 3) + 32 m at depths (lane >> 2) + 8 h: one warp
// instruction covers 4 rows x 8 depths, 32 distinct banks since
// LD = 4 (mod 32). `dst` and `src` are the thread's first element;
// `rows_left` counts the rows of the matrix from the thread's first row on;
// rows past the end copy zeros and read nothing (their address is `base`).
template <int ROWS, int LD>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, const float* base,
                                           size_t row_step, int rows_left) {
#pragma unroll
  for (int m = 0; m < ROWS / 32; ++m) {
    const bool ok = 32 * m < rows_left;
#pragma unroll
    for (int h = 0; h < BK / 8; ++h) {
      cp_async4(dst + h * 8 * LD + 32 * m, ok ? src + m * row_step + h * 8 : base, ok);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
knn2_tile_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
                 const float* __restrict__ t, const float* __restrict__ tsq,
                 const uint8_t* __restrict__ tvalid, int n0, int n1, int d,
                 int tiles_per_split, float* __restrict__ part_b1,
                 float* __restrict__ part_b2, int* __restrict__ part_j) {
  {  // pair blockIdx.z's blocks
    const size_t b = blockIdx.z;
    q += b * n0 * d;
    qsq += b * n0;
    t += b * n1 * d;
    tsq += b * n1;
    tvalid += b * n1;
    const size_t po = b * n0 * gridDim.y;
    part_b1 += po;
    part_b2 += po;
    part_j += po;
  }
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // query tile, [k][row]
  float* ring = qs + MAXD * LDQ;                // STAGES train chunks, [k][col]
  float* st_b1 = ring + STAGES * BK * LDT;      // running top-2 per (row, thread)
  float* st_b2 = st_b1 + TM * THREADS;
  int* st_j = reinterpret_cast<int*>(st_b2 + TM * THREADS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A half-warp shares its rows (their shared loads are broadcasts, half
  // the cost of distinct ones) and spreads over 16 column groups.
  const int rg = warp * 2 + (lane >> 4);  // rows 64 m + 4 rg + e (m < 2, e < 4)
  const int cg = lane & 15;               // columns 64 m + 4 cg + e (m < 2, e < 4)
  const int row0 = blockIdx.x * BQ;
  const int split = blockIdx.y;

  const int n_tiles = (n1 + BT - 1) / BT;
  const int tile_lo = split * tiles_per_split;
  const int n_tiles_here = max(0, min(n_tiles, tile_lo + tiles_per_split) - tile_lo);
  const int kchunks = d / BK;
  const int n_chunks = n_tiles_here * kchunks;

  // Copy pointers of this thread (see copy_chunk); they advance by BK per
  // chunk and, for the train matrix, by BT rows per tile.
  const int first = warp * 4 + (lane & 3);
  const int kq = lane >> 2;
  const size_t row_step = (size_t)32 * d;
  float* q_dst = qs + kq * LDQ + first;
  const float* q_src = q + (size_t)(row0 + first) * d + kq;
  const float* t_src = t + (size_t)(tile_lo * BT + first) * d + kq;
  int t_left = n1 - tile_lo * BT - first;
  int s_kc = 0, s_slot = 0;  // depth chunk and ring slot of the next copy

  // Copy group c holds train chunk c and, during the first tile, the query
  // tile's chunk at the same depth.
  auto stage = [&](int c) {
    copy_chunk<BT, LDT>(ring + s_slot * BK * LDT + kq * LDT + first, t_src, t, row_step,
                        t_left);
    if (c < kchunks) {
      copy_chunk<BQ, LDQ>(q_dst, q_src, q, row_step, n0 - row0 - first);
      q_dst += BK * LDQ;
      q_src += BK;
    }
    t_src += BK;
    s_slot = s_slot + 1 == STAGES ? 0 : s_slot + 1;
    if (++s_kc == kchunks) {  // next tile
      s_kc = 0;
      t_src += (size_t)BT * d - d;
      t_left -= BT;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) stage(s);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    st_b1[i * THREADS + tid] = CUDART_INF_F;
    st_b2[i * THREADS + tid] = CUDART_INF_F;
    st_j[i * THREADS + tid] = IMAX;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int kc = 0, slot = 0, col0 = tile_lo * BT;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c landed
    __syncthreads();              // everyone's; and chunk c-1's buffer is free
    if (c + STAGES - 1 < n_chunks) stage(c + STAGES - 1);
    cp_async_commit();

    const float* qk = qs + kc * BK * LDQ + rg * 4;
    const float* tk = ring + slot * BK * LDT + cg * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM / 4; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(qk + kk * LDQ + m * 64);
        a[4 * m] = v.x; a[4 * m + 1] = v.y; a[4 * m + 2] = v.z; a[4 * m + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < TN / 4; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(tk + kk * LDT + m * 64);
        b[4 * m] = v.x; b[4 * m + 1] = v.y; b[4 * m + 2] = v.z; b[4 * m + 3] = v.w;
      }
      // Column pairs, rows walked forward then back: each train value and
      // each query value feeds consecutive FMAs (the operand reuse cache);
      // on the H100 this ran faster than plain row-major order.
#pragma unroll
      for (int j = 0; j < TN; j += 2)
#pragma unroll
        for (int ii = 0; ii < TM; ++ii) {
          const int i = (j / 2) % 2 ? TM - 1 - ii : ii;
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          acc[i][j + 1] = fmaf(a[i], b[j + 1], acc[i][j + 1]);
        }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;

    if (++kc == kchunks) {
      // Distance epilogue and top-2 fold of one finished tile, branch-free.
      // Columns past n1 become +inf (never best, never second), masked ones
      // 3e38. The fold b1' = min(b1, v), b2' = min(b2, max(v, b1)), j' = v <
      // b1 ? col : j equals the streaming compare (ascending columns, strict
      // '<': the lowest column wins a tie, an equal value becomes second).
      kc = 0;
      float tq[TN], fill[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + (j / 4) * 64 + cg * 4 + j % 4;
        const bool in = col < n1;
        tq[j] = in ? tsq[col] : 0.f;
        fill[j] = !in ? CUDART_INF_F : (tvalid[col] != 0 ? 0.f : BIG);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + (i / 4) * 64 + rg * 4 + i % 4;
        const float qq = r < n0 ? qsq[r] : 0.f;
        float b1 = st_b1[i * THREADS + tid];
        float b2 = st_b2[i * THREADS + tid];
        int jb = st_j[i * THREADS + tid];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          // Explicit round-to-nearest intrinsics: no FMA contraction, so
          // the value rounds as max((qsq + tsq) - 2 * cross, 0) does.
          float v = __fsub_rn(__fadd_rn(qq, tq[j]), __fmul_rn(2.0f, acc[i][j]));
          v = fmaxf(v, 0.f);
          v = fill[j] == 0.f ? v : fill[j];
          jb = v < b1 ? col0 + (j / 4) * 64 + cg * 4 + j % 4 : jb;
          b2 = fminf(b2, fmaxf(v, b1));
          b1 = fminf(b1, v);
          acc[i][j] = 0.f;
        }
        st_b1[i * THREADS + tid] = b1;
        st_b2[i * THREADS + tid] = b2;
        st_j[i * THREADS + tid] = jb;
      }
      col0 += BT;
    }
  }

  // A row's 16 column threads are one half-warp: shuffles merge them.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    Top2 m = {st_b1[i * THREADS + tid], st_b2[i * THREADS + tid], st_j[i * THREADS + tid]};
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      Top2 o;
      o.b1 = __shfl_xor_sync(0xffffffffu, m.b1, off, 16);
      o.b2 = __shfl_xor_sync(0xffffffffu, m.b2, off, 16);
      o.j = __shfl_xor_sync(0xffffffffu, m.j, off, 16);
      m = merge(m, o);
    }
    const int r = row0 + (i / 4) * 64 + rg * 4 + i % 4;
    if (cg == 0 && r < n0) {
      const size_t o = (size_t)r * gridDim.y + split;
      part_b1[o] = m.b1;
      part_b2[o] = m.b2;
      part_j[o] = m.j;
    }
  }
}

// Folds the per-split partials of each row, then (when valid0 is given)
// the ratio test as the plain version rounds it: d1 < float32(ratio^2) * d2
// with one float32 product, and d1 < 3e38.
__global__ void knn2_merge_kernel(const float* __restrict__ part_b1,
                                  const float* __restrict__ part_b2,
                                  const int* __restrict__ part_j, int n0, int n_splits,
                                  float* __restrict__ d1, int* __restrict__ j1,
                                  float* __restrict__ d2,
                                  const uint8_t* __restrict__ valid0, float r2,
                                  int* __restrict__ idx0, uint8_t* __restrict__ ok) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n0) return;
  // Pair blockIdx.y's blocks.
  const size_t b = blockIdx.y;
  part_b1 += b * n0 * n_splits;
  part_b2 += b * n0 * n_splits;
  part_j += b * n0 * n_splits;
  d1 += b * n0;
  j1 += b * n0;
  d2 += b * n0;
  if (valid0 != nullptr) {
    valid0 += b * n0;
    idx0 += b * n0;
    ok += b * n0;
  }
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
  const float b1 = fminf(m.b1, BIG);
  const float b2 = fminf(m.b2, BIG);
  d1[r] = b1;
  d2[r] = b2;
  j1[r] = m.j;
  if (valid0 != nullptr) {
    ok[r] = (valid0[r] != 0) && (b1 < __fmul_rn(r2, b2)) && (b1 < BIG);
    idx0[r] = r;
  }
}

// Launches both kernels for `batch` pairs on stream `s` of the current
// device `device`.
cudaError_t launch(const float* q, const float* qsq, const float* t, const float* tsq,
                   const uint8_t* tvalid, int batch, int n0, int n1, int d, int n_splits,
                   int tiles_per_split, float* part, float* d1, int* j1, float* d2,
                   const uint8_t* valid0, float r2, int* idx0, uint8_t* ok, int device,
                   cudaStream_t s) {
  // Above 48 KB a launch is refused unless the kernel was granted more.
  static bool granted[64] = {};
  cudaError_t err = cudaSuccess;
  if (device >= 64 || !granted[device]) {
    err = cudaFuncSetAttribute(knn2_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(knn2_tile_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < 64) granted[device] = true;
  }
  const size_t np = (size_t)batch * n0 * n_splits;
  float* part_b1 = part;
  float* part_b2 = part + np;
  int* part_j = reinterpret_cast<int*>(part + 2 * np);
  dim3 grid((n0 + BQ - 1) / BQ, n_splits, batch);
  knn2_tile_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(q, qsq, t, tsq, tvalid, n0, n1, d,
                                                     tiles_per_split, part_b1, part_b2,
                                                     part_j);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn2_merge_kernel<<<dim3((n0 + 127) / 128, batch), 128, 0, s>>>(
      part_b1, part_b2, part_j, n0, n_splits, d1, j1, d2, valid0, r2, idx0, ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes and the widest descriptor the kernel holds (the wrapper plans
// the train split and sizes its scratch from these).
int knn2_tile_rows() { return BQ; }
int knn2_tile_cols() { return BT; }
int knn2_max_dim() { return MAXD; }

// Launches both kernels on `stream` for `batch` pairs of (n0, d) queries and
// (n1, d) train rows; each array holds the pairs' blocks one after another.
// `part` holds 3 * batch * n0 * n_splits words (best, second, column per
// row and split). valid0, idx0 and ok may be null (no ratio test). Returns
// the first CUDA error of the launches, else 0.
int knn2_launch(const float* q, const float* qsq, const float* t, const float* tsq,
                const uint8_t* tvalid, int batch, int n0, int n1, int d, int n_splits,
                int tiles_per_split, float* part, float* d1, int* j1, float* d2,
                const uint8_t* valid0, float r2, int* idx0, uint8_t* ok, int device,
                void* stream) {
  // The tensors' device becomes the current one for the launches.
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch(q, qsq, t, tsq, tvalid, batch, n0, n1, d, n_splits, tiles_per_split, part, d1,
               j1, d2, valid0, r2, idx0, ok, device, reinterpret_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
