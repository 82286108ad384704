// Chunk-list raster kernel for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   omnidata_tpu/mesh/pallas_raster.py:raster_tiles_pallas_chunklist
// (body _chunklist_tile_kernel, helpers _mt_precompute, _mt_packed_block,
// _mt_sweep_carry, _chunk_selector). It computes what that kernel computes,
// not how: no scalar prefetch, no 16-bit id pairs, no one-hot matmul.
//
// What bounds it: FP32 ALU work on (pixel x admitted face) pairs, about 20
// multiplies and adds a pair (three 3-term dot products, the edge scales)
// plus compares and the key min, against 4 bytes of ray direction per pixel
// and 36 bytes of geometry per face; and, on this card, the imbalance of
// the rows: a row that scans all chunks (count -1) or lists hundreds is
// 10-100x the median row. Design answer: each CTA stages the
// per-face Moller-Trumbore invariants of a chunk once, computed
// cooperatively into shared memory, and every thread then reuses them for
// its pixels from registers; ray directions and the running winners live in
// registers for the whole item. Rows are cut into work items of at most
// `seg` list positions (raster_common.cuh), which persistent CTAs take
// longest first, so a long row is swept by many SMs at once and merged
// exactly; no SM sweeps a whole tail row.
//
// Launch: the entry point enqueues the item list's build (one CTA) and the
// merge words' fill, then the sweep: one CTA per resident slot of the
// card, no host sync in between; each thread owns PPT
// pixels (p = threadIdx.x + k * blockDim.x). A CTA decodes its item's row
// list (raster::Schedule: listed chunks at the row's offset, or all chunks)
// and sweeps positions [seg * item, seg * (item + 1)) of it.
//
// Ties keep the TPU semantics: within a chunk the minimum of the full key
// (t bits & ~0x1FFF) | lane, across chunks replacement only on strict
// improvement of the masked key, across a row's items the same rule in
// segment order (the merge in raster_common.cuh). The winner is kept as a
// face index and its COLS pack columns are copied at the end (zeros when
// nothing hit).
//
// Exactness: see raster_common.cuh.

#include "raster_common.cuh"

namespace {

using namespace raster;

struct Args {
  const int* ids;      // every row's list, flat
  const int* offsets;  // (rows,): where each row's list starts in ids
  const int* counts;
  const float* origins;
  const float* pack;
  const float* dx;
  const float* dy;
  const float* dz;
  int* packed;
  float* acc;
  int P, cols, Fp, chunk, tiles_per_view, n_chunks, seg;
};

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
raster_chunklist_kernel(const Args a, const ItemList items) {
  // per-face invariants of the chunk being swept:
  // n.xyz, q.xyz, r.xyz, e2.q
  __shared__ float s_pre[10][kMaxChunk];
  __shared__ int s_item[4];

  const RowMajor geo{a.pack, a.Fp};
  const int chunk = a.chunk;
  Item it;
  bool first = true;
  while (next_item(items, s_item, it, first)) {
    const int row = it.row;
    const Schedule sched(a.ids, a.offsets, row, a.counts[row], a.n_chunks);
    const int view = row / a.tiles_per_view;
    const float ox = a.origins[view * 3 + 0];
    const float oy = a.origins[view * 3 + 1];
    const float oz = a.origins[view * 3 + 2];

    float dx[PPT], dy[PPT], dz[PPT];
    int best[PPT], win[PPT], cbest[PPT];
    load_rays<PPT>(a.dx, a.dy, a.dz, (size_t)row * a.P, dx, dy, dz, best,
                   win);

    const int i_end = min(sched.trip, (it.seg + 1) * a.seg);
    for (int i = it.seg * a.seg; i < i_end; ++i) {
      const int ci = sched.chunk_of(i);
      __syncthreads();  // the previous chunk's invariants are no longer read
      for (int l = threadIdx.x; l < chunk; l += blockDim.x) {
        const int f = ci * chunk + l;
        mt_invariants(s_pre, l, *geo.ptr(0, f), *geo.ptr(1, f),
                      *geo.ptr(2, f), *geo.ptr(3, f), *geo.ptr(4, f),
                      *geo.ptr(5, f), *geo.ptr(6, f), *geo.ptr(7, f),
                      *geo.ptr(8, f), ox, oy, oz);
      }
      __syncthreads();
      sweep_chunk<PPT>(s_pre, chunk, dx, dy, dz, cbest);
      fold_chunk<PPT>(cbest, best, win,
                      [&](int lane) { return ci * chunk + lane; });
    }
    finish_item<PPT>(items, it, geo, best, win, a.P, a.cols, a.packed, a.acc,
                     s_item + 3);
  }
}

template <int PPT>
int launch(const Args& a, const ItemList& items, int threads,
           cudaStream_t stream) {
  auto kernel = raster_chunklist_kernel<PPT>;
  int grid = 0;
  const int err = persistent_grid(kernel, threads, 0, &grid);
  if (err != 0) return err;
  kernel<<<grid, threads, 0, stream>>>(a, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Builds the item list (schedule_kernel, segments of `seg` list positions)
// and sweeps it, all on `stream`; returns a CUDA error code (0 on
// success). rows = K*T tiles; P pixels per tile; row r's list is
// ids[offsets[r] ...], counts[r] long (raster_common.cuh); pack is (cols, Fp)
// row-major. The caller allocates the item list (order, ends, n_items,
// done: rows each; next: 1) and the merge words (rows, P); the launch
// fills them.
extern "C" int raster_chunklist_launch(
    const int* ids, const int* offsets, const int* counts,
    const float* origins, const float* pack, const float* dx, const float* dy,
    const float* dz, int* order, int* ends, int* n_items, int* done,
    int* next, unsigned long long* merge, int* packed, float* acc, int rows,
    int P, int cols, int Fp, int chunk, int tiles_per_view, int n_chunks,
    int seg, void* stream) {
  if (rows <= 0 || P <= 0 || chunk < 1 || chunk > kMaxChunk ||
      n_chunks < 1 || cols < 10 || !segments_fit(n_chunks, seg)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = P < kMaxThreads ? P : kMaxThreads;
  if (P % threads != 0 || !ppt_instantiated(P / threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{ids, offsets, counts, origins, pack, dx, dy, dz, packed, acc,
               P, cols, Fp, chunk, tiles_per_view, n_chunks, seg};
  const ItemList items{order, ends, rows, next, done, merge};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScheduleArgs sa{counts, nullptr, rows, n_chunks, seg, chunk, 0,
                        order, ends, n_items, done, next, nullptr};
  const int err = build_items(sa, merge, P, s);
  if (err != 0) return err;
  switch (P / threads) {
    case 1: return launch<1>(a, items, threads, s);
    case 2: return launch<2>(a, items, threads, s);
    case 4: return launch<4>(a, items, threads, s);
    case 8: return launch<8>(a, items, threads, s);
    case 16: return launch<16>(a, items, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
