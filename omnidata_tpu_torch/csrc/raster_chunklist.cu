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
// (p = threadIdx.x + k * blockDim.x). The CTA decodes its own chunk list
// (raster::Schedule: exact list, all chunks, or block mode).
//
// Ties keep the TPU semantics: within a chunk the minimum of the full key
// (t bits & ~0x1FFF) | lane, across chunks replacement only on strict
// improvement of the masked key. The winner is kept as a face index and its
// COLS pack columns are copied at the end (zeros when nothing hit).
//
// Exactness: see raster_common.cuh.

#include "raster_common.cuh"

namespace {

using namespace raster;

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

  const RowMajor geo{pack, Fp};
  const int row = blockIdx.x;
  const Schedule sched(ids + (size_t)row * ccap, counts[row], ccap, n_chunks);
  const int view = row / tiles_per_view;
  const float ox = origins[view * 3 + 0];
  const float oy = origins[view * 3 + 1];
  const float oz = origins[view * 3 + 2];

  float dx[PPT], dy[PPT], dz[PPT];
  int best[PPT], win[PPT], cbest[PPT];
  load_rays<PPT>(dxs, dys, dzs, (size_t)row * P, dx, dy, dz, best, win);

  for (int i = 0; i < sched.trip; ++i) {
    const int ci = sched.chunk_of(i);
    __syncthreads();  // the previous chunk's invariants are no longer read
    for (int l = threadIdx.x; l < chunk; l += blockDim.x) {
      const int f = ci * chunk + l;
      mt_invariants(s_pre, l, *geo.ptr(0, f), *geo.ptr(1, f), *geo.ptr(2, f),
                    *geo.ptr(3, f), *geo.ptr(4, f), *geo.ptr(5, f),
                    *geo.ptr(6, f), *geo.ptr(7, f), *geo.ptr(8, f), ox, oy,
                    oz);
    }
    __syncthreads();
    sweep_chunk<PPT>(s_pre, chunk, dx, dy, dz, cbest);
    fold_chunk<PPT>(cbest, best, win,
                    [&](int lane) { return ci * chunk + lane; });
  }
  write_winners<PPT>(geo, best, win, row, P, cols, packed_out, acc_out);
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
