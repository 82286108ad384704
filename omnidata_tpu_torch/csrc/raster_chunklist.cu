// Chunk-list raster kernel for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   omnidata_tpu/mesh/pallas_raster.py:raster_tiles_pallas_chunklist
// (body _chunklist_tile_kernel, helpers _mt_precompute, _mt_packed_block,
// _mt_sweep_carry, _chunk_selector). It computes what that kernel computes,
// not how: no scalar prefetch, no 16-bit id pairs, no one-hot matmul.
//
// What bounds it: FP32 ALU work on (pixel x admitted face) pairs. Each pair
// costs about 35 arithmetic and compare operations (three 3-term dot
// products, the sign fold, four edge tests, a division on hits, the key
// min), against 4 bytes of ray direction per pixel and 36 bytes of geometry
// per face. Design answer: each CTA stages the per-face Moller-Trumbore
// invariants of a chunk once, computed cooperatively into shared memory,
// and every thread then reuses them for its pixels from registers; ray
// directions and the running winners live in registers for the whole sweep.
//
// Launch: one CTA per (view, tile) row; each thread owns PPT pixels
// (p = threadIdx.x + k * blockDim.x). The CTA decodes its own chunk list:
// counts >= 0 exact list, -1 scan all chunks, <= -2 block mode (8-chunk
// blocks, the last id clamped to the final chunk).
//
// Ties keep the TPU semantics: within a chunk the minimum of the full key
// (t bits & ~0x1FFF) | lane, across chunks replacement only on strict
// improvement of the masked key. The winner is kept as a face index and its
// COLS pack columns are copied at the end (zeros when nothing hit).
//
// Exactness: built with -fmad=false and IEEE division, and evaluated in the
// operation order of the plain PyTorch version
// (omnidata_tpu_torch/mesh/raster_kernels.py), so both agree bit for bit.
// Float constants are formed in double and rounded once to float32, as the
// JAX package forms them.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxChunk = 128;
constexpr int kMaxThreads = 256;
constexpr int kTieMask = ~((1 << 13) - 1);
constexpr int kLaneMask = (1 << 13) - 1;

constexpr float kBig = (float)1e30;
constexpr float kEps = (float)1e-7;
constexpr float kEps2 = (float)(1e-7 * 1e-7);
constexpr float kNegEdge = (float)(-1e-5);
constexpr float kOneEdge = (float)(1.0 + 1e-5);

__device__ __forceinline__ int big_packed() {
  return __float_as_int(kBig) & kTieMask;
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
raster_chunklist_kernel(const int* __restrict__ ids,
                        const int* __restrict__ counts,
                        const float* __restrict__ origins,
                        const float* __restrict__ pack,
                        const float* __restrict__ dxs,
                        const float* __restrict__ dys,
                        const float* __restrict__ dzs,
                        int* __restrict__ packed_out,
                        float* __restrict__ acc_out,
                        int P, int cols, int Fp, int chunk, int ccap,
                        int tiles_per_view, int n_chunks) {
  // per-face invariants of the chunk being swept:
  // n.xyz, q.xyz, r.xyz, e2.q
  __shared__ float s_pre[10][kMaxChunk];

  const int row = blockIdx.x;
  const int count = counts[row];
  const bool full = count == -1;
  const bool block_mode = count < -1;
  const int trip = full ? n_chunks : (block_mode ? (-count - 2) * 8 : count);
  const int view = row / tiles_per_view;
  const float ox = origins[view * 3 + 0];
  const float oy = origins[view * 3 + 1];
  const float oz = origins[view * 3 + 2];
  const int* row_ids = ids + (size_t)row * ccap;
  const size_t pix0 = (size_t)row * P;

  float dx[PPT], dy[PPT], dz[PPT];
  int best[PPT], win[PPT], cbest[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t p = pix0 + threadIdx.x + k * blockDim.x;
    dx[k] = dxs[p];
    dy[k] = dys[p];
    dz[k] = dzs[p];
    best[k] = big_packed();
    win[k] = -1;
  }

  for (int i = 0; i < trip; ++i) {
    int ci;
    if (full) {
      ci = i;
    } else {
      const int j = min(block_mode ? i / 8 : i, ccap - 1);
      const int listed = row_ids[j];
      ci = block_mode ? listed * 8 + i % 8 : listed;
    }
    ci = min(ci, n_chunks - 1);

    __syncthreads();  // the previous chunk's invariants are no longer read
    for (int l = threadIdx.x; l < chunk; l += blockDim.x) {
      const int f = ci * chunk + l;
      const float v0x = pack[0 * (size_t)Fp + f];
      const float v0y = pack[1 * (size_t)Fp + f];
      const float v0z = pack[2 * (size_t)Fp + f];
      const float e1x = pack[3 * (size_t)Fp + f];
      const float e1y = pack[4 * (size_t)Fp + f];
      const float e1z = pack[5 * (size_t)Fp + f];
      const float e2x = pack[6 * (size_t)Fp + f];
      const float e2y = pack[7 * (size_t)Fp + f];
      const float e2z = pack[8 * (size_t)Fp + f];
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      s_pre[0][l] = e1y * e2z - e1z * e2y;
      s_pre[1][l] = e1z * e2x - e1x * e2z;
      s_pre[2][l] = e1x * e2y - e1y * e2x;
      s_pre[3][l] = qx;
      s_pre[4][l] = qy;
      s_pre[5][l] = qz;
      s_pre[6][l] = e2y * tvz - e2z * tvy;
      s_pre[7][l] = e2z * tvx - e2x * tvz;
      s_pre[8][l] = e2x * tvy - e2y * tvx;
      s_pre[9][l] = e2x * qx + e2y * qy + e2z * qz;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < PPT; ++k) cbest[k] = INT_MAX;
    for (int l = 0; l < chunk; ++l) {
      const float nx = s_pre[0][l], ny = s_pre[1][l], nz = s_pre[2][l];
      const float qx = s_pre[3][l], qy = s_pre[4][l], qz = s_pre[5][l];
      const float rx = s_pre[6][l], ry = s_pre[7][l], rz = s_pre[8][l];
      const float e2q = s_pre[9][l];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float det = -(dx[k] * nx + dy[k] * ny + dz[k] * nz);
        const float udet = dx[k] * rx + dy[k] * ry + dz[k] * rz;
        const float vdet = dx[k] * qx + dy[k] * qy + dz[k] * qz;
        const float adet = fabsf(det);
        const bool pos = det >= 0.0f;
        const float us = pos ? udet : -udet;
        const float vs = pos ? vdet : -vdet;
        const float ts = pos ? e2q : -e2q;
        const bool hit = (adet >= kEps) && (us >= kNegEdge * adet) &&
                         (vs >= kNegEdge * adet) &&
                         (us + vs <= kOneEdge * adet) && (ts > kEps * adet);
        const float t = hit ? ts / fmaxf(adet, kEps2) : kBig;
        const int key = (__float_as_int(t) & kTieMask) | l;
        cbest[k] = min(cbest[k], key);
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if ((cbest[k] & kTieMask) < (best[k] & kTieMask)) {
        best[k] = cbest[k];
        win[k] = ci * chunk + (cbest[k] & kLaneMask);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    packed_out[pix0 + p] = best[k];
    float* acc = acc_out + (size_t)row * cols * P + p;
    for (int c = 0; c < cols; ++c) {
      acc[(size_t)c * P] = win[k] >= 0 ? pack[(size_t)c * Fp + win[k]] : 0.0f;
    }
  }
}

template <int PPT>
void launch(dim3 grid, int threads, cudaStream_t stream, const int* ids,
            const int* counts, const float* origins, const float* pack,
            const float* dx, const float* dy, const float* dz, int* packed,
            float* acc, int P, int cols, int Fp, int chunk, int ccap,
            int tiles_per_view, int n_chunks) {
  raster_chunklist_kernel<PPT><<<grid, threads, 0, stream>>>(
      ids, counts, origins, pack, dx, dy, dz, packed, acc, P, cols, Fp, chunk,
      ccap, tiles_per_view, n_chunks);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rows = K*T tiles; P pixels per tile; pack is (cols, Fp) row-major.
extern "C" int raster_chunklist_launch(
    const int* ids, const int* counts, const float* origins,
    const float* pack, const float* dx, const float* dy, const float* dz,
    int* packed, float* acc, int rows, int P, int cols, int Fp, int chunk,
    int ccap, int tiles_per_view, int n_chunks, void* stream) {
  if (rows <= 0 || P <= 0 || chunk < 1 || chunk > kMaxChunk || ccap < 1 ||
      n_chunks < 1 || cols < 10) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = P < kMaxThreads ? P : kMaxThreads;
  if (P % threads != 0) return (int)cudaErrorInvalidValue;
  const int ppt = P / threads;
  const dim3 grid(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 1:
      launch<1>(grid, threads, s, ids, counts, origins, pack, dx, dy, dz,
                packed, acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                n_chunks);
      break;
    case 2:
      launch<2>(grid, threads, s, ids, counts, origins, pack, dx, dy, dz,
                packed, acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                n_chunks);
      break;
    case 4:
      launch<4>(grid, threads, s, ids, counts, origins, pack, dx, dy, dz,
                packed, acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                n_chunks);
      break;
    case 8:
      launch<8>(grid, threads, s, ids, counts, origins, pack, dx, dy, dz,
                packed, acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                n_chunks);
      break;
    case 16:
      launch<16>(grid, threads, s, ids, counts, origins, pack, dx, dy, dz,
                 packed, acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                 n_chunks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
