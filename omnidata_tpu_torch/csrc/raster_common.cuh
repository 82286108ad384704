// Pieces shared by the Hopper raster kernels (raster_chunklist.cu,
// raster_compact.cu): the TPU's key and tie constants, the decode of one
// row's chunk list, the two pack layouts, the per-face Moller-Trumbore
// invariants, the per-chunk key sweep and the winner write.
//
// Every kernel that includes this file evaluates the operations of the
// plain PyTorch versions (omnidata_tpu_torch/mesh/raster_kernels.py) in the
// same order and is built with -fmad=false, IEEE division and no FTZ, so
// kernel and plain version agree bit for bit. Float constants are formed in
// double and rounded once to float32, as the JAX package forms them.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace raster {

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

// One row's chunk list. counts >= 0: that many listed chunk ids; -1: every
// chunk in order; <= -2: block mode, -count-2 listed 8-chunk block ids, each
// expanded to its 8 chunks. An id past the last chunk (the tail of the last
// block) is clamped to it.
struct Schedule {
  const int* ids;
  int ccap, n_chunks, trip;
  bool full, block;

  __device__ Schedule(const int* row_ids, int count, int ccap_, int n_chunks_)
      : ids(row_ids), ccap(ccap_), n_chunks(n_chunks_), full(count == -1),
        block(count < -1) {
    trip = full ? n_chunks : (block ? (-count - 2) * 8 : count);
  }
  // the chunk id at list position i before the clamp
  __device__ int raw(int i) const {
    if (full) return i;
    const int j = min(block ? i / 8 : i, ccap - 1);
    const int listed = ids[j];
    return block ? listed * 8 + i % 8 : listed;
  }
  __device__ int chunk_of(int i) const { return min(raw(i), n_chunks - 1); }
};

// The scene pack [v0|e1|e2|face_id|attr corners] as (cols, Fp), row-major.
struct RowMajor {
  const float* p;
  int Fp;
  __device__ const float* ptr(int c, int f) const {
    return p + (size_t)c * Fp + f;
  }
};

// The same pack chunk-major, (Fp / chunk, cols, chunk): one contiguous
// cols x chunk block per chunk.
struct ChunkMajor {
  const float* p;
  int cols, chunk;
  __device__ const float* ptr(int c, int f) const {
    const int ch = f / chunk;
    return p + ((size_t)ch * cols + c) * chunk + (f - ch * chunk);
  }
};

// Writes lane l's 10 invariants n = e1 x e2, q = tvec x e1, r = e2 x tvec
// and e2.q, with tvec = origin - v0, into s_pre[0..9][l].
__device__ __forceinline__ void mt_invariants(
    float (*s_pre)[kMaxChunk], int l, float v0x, float v0y, float v0z,
    float e1x, float e1y, float e1z, float e2x, float e2y, float e2z,
    float ox, float oy, float oz) {
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

// cbest[k] = the minimum over lanes l < n of the packed key
// (t bits & kTieMask) | l of this thread's pixel k; misses carry t = kBig.
template <int PPT>
__device__ __forceinline__ void sweep_chunk(const float (*s_pre)[kMaxChunk],
                                            int n, const float (&dx)[PPT],
                                            const float (&dy)[PPT],
                                            const float (&dz)[PPT],
                                            int (&cbest)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) cbest[k] = INT_MAX;
  for (int l = 0; l < n; ++l) {
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
}

// Across chunks the winner moves only on strict improvement of the masked
// key; face_of(lane) gives the face id of a lane of the chunk just swept.
template <int PPT, class FaceOf>
__device__ __forceinline__ void fold_chunk(const int (&cbest)[PPT],
                                           int (&best)[PPT], int (&win)[PPT],
                                           FaceOf face_of) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if ((cbest[k] & kTieMask) < (best[k] & kTieMask)) {
      best[k] = cbest[k];
      win[k] = face_of(cbest[k] & kLaneMask);
    }
  }
}

// Pixel p = threadIdx.x + k * blockDim.x of the row starting at pix0.
template <int PPT>
__device__ __forceinline__ void load_rays(const float* dxs, const float* dys,
                                          const float* dzs, size_t pix0,
                                          float (&dx)[PPT], float (&dy)[PPT],
                                          float (&dz)[PPT], int (&best)[PPT],
                                          int (&win)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t p = pix0 + threadIdx.x + k * blockDim.x;
    dx[k] = dxs[p];
    dy[k] = dys[p];
    dz[k] = dzs[p];
    best[k] = big_packed();
    win[k] = -1;
  }
}

// packed = the best key; acc = the winner's cols pack columns, zeros on a
// miss.
template <int PPT, class Pack>
__device__ __forceinline__ void write_winners(const Pack& pack,
                                              const int (&best)[PPT],
                                              const int (&win)[PPT], int row,
                                              int P, int cols,
                                              int* packed_out,
                                              float* acc_out) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    packed_out[(size_t)row * P + p] = best[k];
    float* acc = acc_out + (size_t)row * cols * P + p;
    for (int c = 0; c < cols; ++c) {
      acc[(size_t)c * P] = win[k] >= 0 ? *pack.ptr(c, win[k]) : 0.0f;
    }
  }
}

}  // namespace raster
