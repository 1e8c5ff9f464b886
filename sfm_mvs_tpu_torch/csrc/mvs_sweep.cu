// MVS pass 1 for Hopper (sm_90a): one launch of the plane sweep per pyramid
// level, and one launch of the zero-mean filter per level.
//
// Replaces no TPU kernel. The JAX package leaves the sweep to XLA
// (sfm_mvs_tpu/models/mvs.py:_sweep_select maps over the hypotheses with
// jax.lax.map, and XLA fuses each hypothesis's warp, taps and box filters).
// The port's plain version (sfm_mvs_tpu_torch/models/mvs.py:
// _sweep_select_plain) runs each hypothesis as a chain of ~250 small ATen
// ops, two thirds of them the box filter's block cumsums, so a chunk of 4
// references (76 hypotheses over three levels) took ~19,000 launches, and
// the layer was bound by the host's launch rate, not by the device.
//
// What bounds this kernel: the neighbour samples. A fountain-sized chunk
// (4 references, 4 neighbours; 384x256 x 64 nearest hypotheses, 768x512 x 7
// and 1536x1024 x 5 bilinear ones) needs 270 M samples and 780 M taps (one
// a sample at the coarsest level, four elsewhere), ~1 G with the tiles'
// halos: four-byte loads that hit L1 or L2 (a reference's 4 neighbour
// images, 25 MB at the finest level, stay in the 50 MB L2), ~50 FP32
// operations a sample (the warp, two IEEE divisions, the taps), and 5x5
// window sums. At one load a lane a cycle the taps alone take ~0.09 ms on
// 132 SMs; the kernel takes ~3 ms, and more occupancy (64 registers, with
// spills) bought 10% at the finer levels, so latency (dependent loads and
// divisions, three barriers a hypothesis) is the likelier limit, not yet
// measured. The cost volume never
// reaches memory: each block owns a 32 x 32 output tile of one reference
// and loops over every hypothesis of the level, keeping the selection in
// registers.
//
// Per hypothesis, a block
//  1. computes num (the neighbour-summed weighted absolute difference) and
//     den (the neighbours that see the point) on its tile and a halo of
//     `radius`. A halo position outside the image takes the clamped edge
//     pixel's values: the replicate padding of the plain box filter. The
//     warped point is R_rel ray + t_rel iv, from the pixel's ray (in shared
//     memory, undistorted once per block when `dist` is given);
//  2. box-filters num and den in shared memory as direct (2r+1)-tap window
//     sums, rows then columns, each divided by 2r+1 (the plain version's
//     form, but with direct sums in place of differences of float32
//     prefix sums over whole rows: closer to exact, and the only intended
//     difference from the plain arithmetic);
//  3. forms the cost and folds it into each output pixel's selection: the
//     best uniform hypothesis (first on ties) with its neighbours' costs for
//     the parabolic shift, the running sum for the mean over the uniform
//     ones (compensated, Kahan's: a discrete tap that float32 and float64
//     round to different pixels moves one of the D costs, and a plain
//     float32 running sum of 64 costs added its own error on top), and the
//     best over all hypotheses with its unfiltered den.
//
// Arithmetic: float32 throughout, built with -fmad=false so that every
// product and sum rounds where the plain expression rounds; fmaf stands
// where the plain code uses addcmul (one rounding), rintf for torch.round's
// half-to-even. Comparisons take the plain code's float32 constants.
//
// The zero-mean kernel computes x - box_filter(x, radius) on the same tiles
// for the references and their neighbours of one level in one launch
// (blockIdx.z runs over the references, then the neighbour images).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;       // output tile side
constexpr int THREADS = 256;   // 8 warps; thread t owns column t % 32
constexpr int ROWS = TILE * TILE / THREADS;  // output rows a thread owns: t / 32 + 8 j

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Rows then columns of the (2r+1)-tap box filter of the T x T tile `x`
// (T = TILE + 2r, row-major) at output (oy, ox) of the tile, from the row
// pass `h` (T rows x TILE). Each pass divides its window sum by 2r+1.
__device__ __forceinline__ void row_pass(const float* x, float* h, int T, int radius) {
  const float k = (float)(2 * radius + 1);
  for (int i = threadIdx.x; i < T * TILE; i += THREADS) {
    const float* s = x + (i / TILE) * T + (i % TILE);
    float acc = s[0];
    for (int j = 1; j <= 2 * radius; ++j) acc = acc + s[j];
    h[i] = acc / k;
  }
}

__device__ __forceinline__ float col_sum(const float* h, int oy, int ox, int radius) {
  const float k = (float)(2 * radius + 1);
  const float* s = h + oy * TILE + ox;
  float acc = s[0];
  for (int j = 1; j <= 2 * radius; ++j) acc = acc + s[j * TILE];
  return acc / k;
}

// One block: a TILE x TILE output tile (blockIdx.x, blockIdx.y) of reference
// blockIdx.z, over all D + E hypotheses of the level.
__global__ void __launch_bounds__(THREADS, 3)
sweep_kernel(const float* __restrict__ ref, const float* __restrict__ nbrs,
             const float* __restrict__ K, const float* __restrict__ R_rel,
             const float* __restrict__ t_rel, const float* __restrict__ center,
             const float* __restrict__ offsets, const float* __restrict__ extra,
             const float* __restrict__ dist, int M, int H, int W, int D, int E, int radius,
             int nearest, float* __restrict__ invd_out, float* __restrict__ best_out,
             float* __restrict__ mean_out, float* __restrict__ den_out) {
  extern __shared__ float smem[];
  const int T = TILE + 2 * radius;
  const int TT = T * T;
  float* s_rx = smem;             // the halo tile's rays (x, y; z = 1)
  float* s_ry = s_rx + TT;
  float* s_ref = s_ry + TT;       // zero-mean reference
  float* s_ctr = s_ref + TT;      // center of the uniform hypotheses
  float* s_num = s_ctr + TT;      // this hypothesis's num, den
  float* s_den = s_num + TT;
  float* s_hnum = s_den + TT;     // row pass, T x TILE
  float* s_hden = s_hnum + T * TILE;
  float* s_rt = s_hden + T * TILE;  // M x (R row-major, t)
  float* s_off = s_rt + 12 * M;     // D offsets

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const size_t HW = (size_t)H * W;
  ref += b * HW;
  center += b * HW;
  nbrs += (size_t)b * M * HW;
  R_rel += (size_t)b * M * 9;
  t_rel += (size_t)b * M * 3;
  offsets += (size_t)b * D;
  if (extra != nullptr) extra += (size_t)b * E * HW;

  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  // _inv_K's closed form, then pix @ inv(K).T for pix = (x, y, 1).
  const float ifx = 1.0f / fx, ify = 1.0f / fy;
  const float ncx = -(cx * ifx), ncy = -(cy * ify);
  const float k1 = dist != nullptr ? dist[0] : 0.0f;
  const float k2 = dist != nullptr ? dist[1] : 0.0f;

  for (int i = threadIdx.x; i < 12 * M; i += THREADS) {
    const int m = i / 12, j = i % 12;
    s_rt[i] = j < 9 ? R_rel[m * 9 + j] : t_rel[m * 3 + j - 9];
  }
  for (int i = threadIdx.x; i < D; i += THREADS) s_off[i] = offsets[i];
  for (int i = threadIdx.x; i < TT; i += THREADS) {
    const int gx = clampi(x0 + i % T - radius, 0, W - 1);
    const int gy = clampi(y0 + i / T - radius, 0, H - 1);
    float rx = (float)gx * ifx + ncx;
    float ry = (float)gy * ify + ncy;
    if (dist != nullptr) {  // projection.undistort_normalized: 5 fixed-point steps
      const float xd = rx, yd = ry;
      for (int it = 0; it < 5; ++it) {
        const float r2 = rx * rx + ry * ry;
        float f = 1.0f + k1 * r2 + k2 * r2 * r2;
        f = fabsf(f) < 1e-12f ? 1e-12f : f;
        rx = xd / f;
        ry = yd / f;
      }
    }
    s_rx[i] = rx;
    s_ry[i] = ry;
    s_ref[i] = ref[gy * W + gx];
    s_ctr[i] = center[gy * W + gx];
  }
  __syncthreads();

  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const float xmax = (float)(W - 1.001), ymax = (float)(H - 1.001);
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  // Per owned pixel: the best uniform cost, its index and its neighbours'
  // costs, the previous uniform cost, the uniform sum and its
  // compensation; the best overall cost, its index and its unfiltered den.
  float bc[ROWS], c0[ROWS], c2[ROWS], prev[ROWS], sum[ROWS], comp[ROWS], ac[ROWS], aden[ROWS];
  int bu[ROWS], ai[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    bc[j] = c0[j] = c2[j] = prev[j] = sum[j] = comp[j] = ac[j] = aden[j] = 0.0f;
    bu[j] = ai[j] = 0;
  }

  for (int h = 0; h < D + E; ++h) {
    for (int i = threadIdx.x; i < TT; i += THREADS) {
      const int gx = clampi(x0 + i % T - radius, 0, W - 1);
      const int gy = clampi(y0 + i / T - radius, 0, H - 1);
      const float iv = h < D ? s_ctr[i] + s_off[h] : extra[(h - D) * HW + gy * W + gx];
      const float rx = s_rx[i], ry = s_ry[i], rv = s_ref[i];
      float num = 0.0f, den = 0.0f;
      for (int m = 0; m < M; ++m) {
        const float* q = s_rt + 12 * m;
        // R_rel ray as the plain code's matrix product accumulates it.
        const float a0 = fmaf(q[1], ry, q[0] * rx) + q[2];
        const float a1 = fmaf(q[4], ry, q[3] * rx) + q[5];
        const float a2 = fmaf(q[7], ry, q[6] * rx) + q[8];
        const float qx = fmaf(q[9], iv, a0);
        const float qy = fmaf(q[10], iv, a1);
        const float z = a2 + q[11] * iv;
        const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
        float xn = qx / zs, yn = qy / zs;
        if (dist != nullptr) {  // projection.distort_normalized
          const float r2 = xn * xn + yn * yn;
          const float f = 1.0f + k1 * r2 + k2 * r2 * r2;
          xn = xn * f;
          yn = yn * f;
        }
        const float u = fmaf(xn, fx, cx), v = fmaf(yn, fy, cy);
        const bool inside = u >= 0.0f && u <= wm1 && v >= 0.0f && v <= hm1;
        const float* img = nbrs + m * HW;
        float val;
        if (nearest) {
          const int ix = (int)fminf(fmaxf(rintf(u), 0.0f), wm1);
          const int iy = (int)fminf(fmaxf(rintf(v), 0.0f), hm1);
          val = __ldg(img + iy * W + ix);
        } else {
          const float xc = fminf(fmaxf(u, 0.0f), xmax);
          const float yc = fminf(fmaxf(v, 0.0f), ymax);
          const float xf = floorf(xc), yf = floorf(yc);
          const float ax = xc - xf, ay = yc - yf;
          const float* p = img + (int)yf * W + (int)xf;
          val = __ldg(p) * (1.0f - ay) * (1.0f - ax) + __ldg(p + 1) * (1.0f - ay) * ax
              + __ldg(p + W) * ay * (1.0f - ax) + __ldg(p + W + 1) * ay * ax;
        }
        const float w = (inside && z > 1e-6f) ? 1.0f : 0.0f;
        num = num + fabsf(val - rv) * w;
        den = den + w;
      }
      s_num[i] = num;
      s_den[i] = den;
    }
    __syncthreads();
    row_pass(s_num, s_hnum, T, radius);
    row_pass(s_den, s_hden, T, radius);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int oy = ty + j * (THREADS / TILE);
      const float nf = col_sum(s_hnum, oy, tx, radius);
      const float df = col_sum(s_hden, oy, tx, radius);
      const float c = df > 1e-6f ? nf / fmaxf(df, 1e-6f) : 1.0f;
      if (h < D) {
        if (h == 0 || c < bc[j]) {
          bc[j] = c;
          bu[j] = h;
          c0[j] = h > 0 ? prev[j] : c;
          c2[j] = c;
        } else if (h == bu[j] + 1) {
          c2[j] = c;
        }
        prev[j] = c;
        const float y = c - comp[j];  // Kahan: -fmad=false keeps each rounding
        const float t = sum[j] + y;
        comp[j] = (t - sum[j]) - y;
        sum[j] = t;
      }
      if (h == 0 || c < ac[j]) {
        ac[j] = c;
        ai[j] = h;
        aden[j] = s_den[(oy + radius) * T + tx + radius];
      }
    }
    __syncthreads();  // s_num, s_den and the row pass are rewritten next
  }

  const float step = D > 1 ? s_off[1] - s_off[0] : 0.0f;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int oy = ty + j * (THREADS / TILE);
    const int gx = x0 + tx, gy = y0 + oy;
    if (gx >= W || gy >= H) continue;
    const size_t p = (size_t)gy * W + gx;
    const float denom = c0[j] - 2.0f * bc[j] + c2[j];
    float shift = fabsf(denom) < 1e-9f ? 0.0f : 0.5f * (c0[j] - c2[j]) / denom;
    shift = fminf(fmaxf(shift, -1.0f), 1.0f);
    const float invd_u = s_ctr[(oy + radius) * T + tx + radius] + s_off[bu[j]] + shift * step;
    invd_out[b * HW + p] = ai[j] < D ? invd_u : extra[(ai[j] - D) * HW + p];
    best_out[b * HW + p] = ac[j];
    mean_out[b * HW + p] = sum[j] / (float)D;
    den_out[b * HW + p] = aden[j];
  }
}

// x - box_filter(x, radius) with replicate edges, for image blockIdx.z: the
// first n_ref images are `refs`, the rest `nbrs`.
__global__ void __launch_bounds__(THREADS)
zero_mean_kernel(const float* __restrict__ refs, const float* __restrict__ nbrs,
                 float* __restrict__ refs_out, float* __restrict__ nbrs_out, int n_ref, int H,
                 int W, int radius) {
  extern __shared__ float smem[];
  const int T = TILE + 2 * radius;
  float* s_x = smem;
  float* s_h = s_x + T * T;
  const size_t HW = (size_t)H * W;
  const int z = blockIdx.z;
  const float* src = z < n_ref ? refs + z * HW : nbrs + (z - n_ref) * HW;
  float* dst = z < n_ref ? refs_out + z * HW : nbrs_out + (z - n_ref) * HW;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  for (int i = threadIdx.x; i < T * T; i += THREADS) {
    const int gx = clampi(x0 + i % T - radius, 0, W - 1);
    const int gy = clampi(y0 + i / T - radius, 0, H - 1);
    s_x[i] = src[gy * W + gx];
  }
  __syncthreads();
  row_pass(s_x, s_h, T, radius);
  __syncthreads();
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int oy = ty + j * (THREADS / TILE);
    const int gx = x0 + tx, gy = y0 + oy;
    if (gx < W && gy < H)
      dst[(size_t)gy * W + gx] = s_x[(oy + radius) * T + tx + radius] - col_sum(s_h, oy, tx, radius);
  }
}

// Grants `kernel` `bytes` of dynamic shared memory where that passes the
// 48 KB a launch gets without asking.
cudaError_t grant(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Runs `launch` with `device` current, then restores the previous device.
template <class F>
int on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

// The output tile side and the threads of a block (the wrapper plans grids
// and shared memory from these).
int mvs_tile() { return TILE; }
int mvs_threads() { return THREADS; }

// One launch of the sweep over the D + E hypotheses of a level for
// `batch` references, on `stream` of `device`, with grid (gx, gy, batch) and
// `smem` bytes of dynamic shared memory. extra (batch, E, H, W) and dist (2)
// may be null. Returns the launch's CUDA error, else 0.
int mvs_sweep_launch(const float* ref, const float* nbrs, const float* K, const float* R_rel,
                     const float* t_rel, const float* center, const float* offsets,
                     const float* extra, const float* dist, int batch, int M, int H, int W,
                     int D, int E, int radius, int nearest, int gx, int gy, int smem,
                     float* invd, float* best, float* mean, float* den, int device,
                     void* stream) {
  return on_device(device, [&]() {
    cudaError_t err = grant((const void*)sweep_kernel, smem);
    if (err != cudaSuccess) return err;
    sweep_kernel<<<dim3(gx, gy, batch), THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        ref, nbrs, K, R_rel, t_rel, center, offsets, extra, dist, M, H, W, D, E, radius, nearest,
        invd, best, mean, den);
    return cudaGetLastError();
  });
}

// One launch of the zero-mean filter over n_ref reference images and n_nbr
// neighbour images of one (H, W), grid (gx, gy, n_ref + n_nbr).
int mvs_zero_mean_launch(const float* refs, const float* nbrs, float* refs_out, float* nbrs_out,
                         int n_ref, int n_nbr, int H, int W, int radius, int gx, int gy, int smem,
                         int device, void* stream) {
  return on_device(device, [&]() {
    cudaError_t err = grant((const void*)zero_mean_kernel, smem);
    if (err != cudaSuccess) return err;
    zero_mean_kernel<<<dim3(gx, gy, n_ref + n_nbr), THREADS, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(refs, nbrs, refs_out, nbrs_out,
                                                                  n_ref, H, W, radius);
    return cudaGetLastError();
  });
}

}  // extern "C"
