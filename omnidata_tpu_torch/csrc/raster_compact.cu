// Compacting and streamed raster kernels for Hopper (sm_90a).
//
// Replaces two TPU Pallas kernels of omnidata_tpu/mesh/pallas_raster.py:
//   B raster_tiles_pallas_compact (body _compact_tile_kernel, helpers
//     _stage_window, _band_mask_and_flags): the scene pack (cols, Fp)
//     row-major, stage cap 512;
//   C raster_tiles_pallas_streamed (bodies _streamed_tile_kernel and
//     _streamed_compact_tile_kernel): the pack chunk-major
//     (Fp / chunk, cols, chunk); with bbox words the compacting body (stage
//     cap 8192), without them the plain body, which is kernel A's function.
// B and C are one kernel on one schedule: the same count pass and the same
// sweep kernel, templated on the pack layout (RowMajor for B, ChunkMajor
// for C); only their entry points differ. They compute what the TPU
// kernels compute, not how: no one-hot or triangular matmuls, no staging
// of whole pack columns.
//
// Compacting, per (view, tile) row:
//   pass 1 walks the row's list in (position, lane) order, blockDim.x faces
//     per round, and tests each face's u8-packed bbox word (x in tiles, y in
//     8-row bands) against the tile. A warp ballot and __popc give each
//     surviving face its slot; the face ids go to shared memory (4 bytes a
//     face: 2 KB at B's cap of 512, 32 KB at C's 8192). The count includes
//     faces past the cap.
//   pass 2 sweeps ceil(staged / chunk) dense chunks of staged faces (lane =
//     slot % chunk), or, when more than stage_cap faces were staged, the raw
//     list, which gives kernel A's result for the row.
// Plain body (C without bbox words): the raw list.
//
// What bounds it: FP32 ALU work on (pixel x swept face) pairs, as in kernel
// A (raster_chunklist.cu); compaction cuts the pairs to the faces whose
// bboxes overlap the tile. Geometry reaches the sweep through a
// double-buffered shared-memory copy: while a chunk is swept, the 9
// geometry rows of the next one (a raw chunk or a dense chunk's gathered
// faces) are copied in with 4-byte cp.async, Hopper's counterpart of the TPU
// kernel's double-buffered DMA. The chunk's invariants are then computed
// once per CTA and every thread reuses them for its pixels.
//
// On this card both kernels are also bound by the imbalance of their rows:
// a row that scans a whole scene's chunks, or stages more than the cap and
// falls back to its raw list, is 10-100x the median row, and with one CTA
// per row a few SMs ran for milliseconds after the rest had drained. So
// they work in items (raster_common.cuh), each item list built on the
// device by one CTA inside the entry point:
//   - the count pass (raster_count_launch) splits pass 1 into items of
//     `seg` list positions over every row and records each segment's
//     staged count and each row's total, so every row is known to be dense
//     or past the cap before the sweep starts;
//   - the sweep (raster_compact_launch for B, raster_streamed_launch for C)
//     takes, longest first, one item per dense row (pass 1 again in the
//     CTA, skipping segments that stage nothing, then the dense sweep) and
//     one item per `seg` positions of every other row's raw list, merged
//     exactly across the row's items.
//
// Ties and exactness as in kernel A: see raster_common.cuh. The winner is
// kept as a face index and its pack columns copied at the end; `packed`'s
// low 13 bits hold the lane, which on the dense path is the dense lane.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const int* ids;      // every row's list, flat
  const int* offsets;  // (rows,): where each row's list starts in ids
  const int* counts;
  const float* origins;
  const int* bbox;  // (K, Fp) u8-packed bbox words, or null: plain body
  const float* dx;
  const float* dy;
  const float* dz;
  int* packed;
  float* acc;
  int P, cols, Fp, chunk, tiles_per_view, n_chunks, tile, n1d, stage_cap;
};

// The split: segments of seg list positions; per row the staged
// count (rows) and per (row, segment) the segment's staged count
// (rows, max_seg), written by the count pass, read by the sweep.
struct Split {
  int seg, max_seg;
  int* staged;
  int* seg_counts;
};

// One sweep unit: n faces; a raw chunk's faces are base + lane, a dense
// chunk's are idx[lane] (staged face ids in shared memory).
struct Unit {
  int n;
  int base;
  const int* idx;
  __device__ int face(int l) const { return idx ? idx[l] : base + l; }
};

typedef float GeoBuf[9][kMaxChunk];

struct Shared {
  GeoBuf geo[2];
  float pre[10][kMaxChunk];
  int wcount[2][kMaxWarps];
  int item[4];
};

// Starts the copy of the unit's 9 geometry rows into buf: one commit group
// per thread.
template <class Pack>
__device__ __forceinline__ void issue_geometry(GeoBuf& buf, const Pack& pack,
                                               const Unit& u) {
  for (int e = threadIdx.x; e < 9 * u.n; e += blockDim.x) {
    const int c = e / u.n;
    const int l = e - c * u.n;
    cp_async4(&buf[c][l], pack.ptr(c, u.face(l)));
  }
  cp_async_commit();
}

// Pass 1 over list elements [e_begin, e_end) (element e = position
// e / chunk, lane e % chunk): the faces whose bbox word overlaps tile
// (tx, ty) go to s_stage from slot `base` on, in (position, lane) order,
// as long as slots stay below stage_cap. Returns base plus their count,
// faces past stage_cap included.
__device__ int stage_range(const Schedule& sched, const int* bbox_view,
                           int chunk, int tx, int ty, int tile, int stage_cap,
                           int e_begin, int e_end, int base, int* s_stage,
                           int (*s_wcount)[kMaxWarps]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int y_lo = (ty * tile) / 8;
  const int y_hi = (ty * tile + tile - 1) / 8;
  int parity = 0;
  for (int e0 = e_begin; e0 < e_end; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    bool m = false;
    int f = 0;
    if (e < e_end) {
      const int i = e / chunk;
      f = sched.chunk_of(i) * chunk + (e - i * chunk);
      const int w = bbox_view[f];
      const int lo_tx = w & 0xFF, hi_tx = (w >> 8) & 0xFF;
      const int lo_by = (w >> 16) & 0xFF, hi_by = (w >> 24) & 0xFF;
      m = lo_tx <= tx && tx <= hi_tx && lo_by <= y_hi && hi_by >= y_lo;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_wcount[parity][warp] = __popc(bal);
    __syncthreads();
    int off = 0, sum = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = s_wcount[parity][w];
      off += w < warp ? c : 0;
      sum += c;
    }
    if (m) {
      const int slot = base + off + __popc(bal & ((1u << lane) - 1u));
      if (slot < stage_cap) s_stage[slot] = f;
    }
    base += sum;
    parity ^= 1;  // the next round writes the other counts buffer
  }
  __syncthreads();
  return base;
}

// Pass 2: the double-buffered sweep of n_units units (unit_of(u) -> Unit),
// folded into best/win. Buffer (u+1)&1 was last read while computing unit
// u-1's invariants, before the barrier that follows them.
template <int PPT, class Pack, class UnitOf>
__device__ __forceinline__ void sweep_units(Shared& sh, const Pack& pack,
                                            int n_units, UnitOf unit_of,
                                            float ox, float oy, float oz,
                                            const float (&dx)[PPT],
                                            const float (&dy)[PPT],
                                            const float (&dz)[PPT],
                                            int (&best)[PPT],
                                            int (&win)[PPT]) {
  int cbest[PPT];
  Unit cur = n_units > 0 ? unit_of(0) : Unit{0, 0, nullptr};
  if (n_units > 0) issue_geometry(sh.geo[0], pack, cur);
  for (int u = 0; u < n_units; ++u) {
    Unit next = cur;
    if (u + 1 < n_units) {
      next = unit_of(u + 1);
      issue_geometry(sh.geo[(u + 1) & 1], pack, next);
      cp_async_wait<1>();  // unit u's copy has landed; u+1's may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies are visible; pre is free
    const GeoBuf& g = sh.geo[u & 1];
    for (int l = threadIdx.x; l < cur.n; l += blockDim.x) {
      mt_invariants(sh.pre, l, g[0][l], g[1][l], g[2][l], g[3][l], g[4][l],
                    g[5][l], g[6][l], g[7][l], g[8][l], ox, oy, oz);
    }
    __syncthreads();
    sweep_chunk<PPT>(sh.pre, cur.n, dx, dy, dz, cbest);
    fold_chunk<PPT>(cbest, best, win, [&](int lane) { return cur.face(lane); });
    cur = next;
  }
}

// A row's tile, ray origin and rays.
template <int PPT>
struct RowSetup {
  Schedule sched;
  int view, tx, ty;
  float ox, oy, oz;
  float dx[PPT], dy[PPT], dz[PPT];
  int best[PPT], win[PPT];

  __device__ RowSetup(const Args& a, int row)
      : sched(a.ids, a.offsets, row, a.counts[row], a.n_chunks) {
    view = row / a.tiles_per_view;
    const int tiv = row - view * a.tiles_per_view;
    tx = tiv % a.n1d;
    ty = tiv / a.n1d;
    ox = a.origins[view * 3 + 0];
    oy = a.origins[view * 3 + 1];
    oz = a.origins[view * 3 + 2];
    load_rays<PPT>(a.dx, a.dy, a.dz, (size_t)row * a.P, dx, dy, dz, best,
                   win);
  }
};

// The count pass of kernels B and C (it reads no pack): per item (row,
// segment), the segment's staged count into seg_counts and the row's total
// into staged (zero before).
__global__ void __launch_bounds__(kMaxThreads)
raster_count_kernel(const Args a, const Split sp, const ItemList items) {
  __shared__ int s_wcount[2][kMaxWarps];
  __shared__ int s_item[4];
  Item it;
  bool first = true;
  while (next_item(items, s_item, it, first)) {
    const int row = it.row;
    const Schedule sched(a.ids, a.offsets, row, a.counts[row], a.n_chunks);
    const int view = row / a.tiles_per_view;
    const int tiv = row - view * a.tiles_per_view;
    const int i0 = it.seg * sp.seg;
    const int i1 = min(sched.trip, i0 + sp.seg);
    const int n = stage_range(sched, a.bbox + (size_t)view * a.Fp, a.chunk,
                              tiv % a.n1d, tiv / a.n1d, a.tile, 0,
                              i0 * a.chunk, i1 * a.chunk, 0, nullptr,
                              s_wcount);
    if (threadIdx.x == 0) {
      sp.seg_counts[(size_t)row * sp.max_seg + it.seg] = n;
      if (n) atomicAdd(sp.staged + row, n);
    }
  }
}

// The sweep of kernels B (Pack = RowMajor) and C (ChunkMajor): per item, a
// dense row (compacting, staged <= stage_cap: pass 1 over the segments
// that stage anything, then the dense sweep) or segment it.seg of a row's
// raw list.
template <int PPT, class Pack>
__global__ void __launch_bounds__(kMaxThreads)
raster_sweep_kernel(const Args a, const Pack pack, const Split sp,
                    const ItemList items) {
  extern __shared__ int s_stage[];  // stage_cap staged face ids
  __shared__ Shared sh;

  const int chunk = a.chunk;
  Item it;
  bool first = true;
  while (next_item(items, sh.item, it, first)) {
    RowSetup<PPT> r(a, it.row);
    const bool dense = a.bbox != nullptr && sp.staged[it.row] <= a.stage_cap;
    int n_units, staged = 0, i0 = 0;
    if (dense) {
      const int* sc = sp.seg_counts + (size_t)it.row * sp.max_seg;
      const int n_segs = ceil_div(r.sched.trip, sp.seg);
      for (int s = 0; s < n_segs; ++s) {
        if (sc[s] == 0) continue;
        staged = stage_range(
            r.sched, a.bbox + (size_t)r.view * a.Fp, chunk, r.tx, r.ty,
            a.tile, a.stage_cap, s * sp.seg * chunk,
            min(r.sched.trip, (s + 1) * sp.seg) * chunk, staged, s_stage,
            sh.wcount);
      }
      n_units = (staged + chunk - 1) / chunk;
    } else {
      i0 = it.seg * sp.seg;
      n_units = min(r.sched.trip, i0 + sp.seg) - i0;
    }
    sweep_units<PPT>(sh, pack, n_units, [&](int u) -> Unit {
      if (dense) return Unit{min(chunk, staged - u * chunk), 0, s_stage + u * chunk};
      return Unit{chunk, r.sched.chunk_of(i0 + u) * chunk, nullptr};
    }, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.best, r.win);
    finish_item<PPT>(items, it, pack, r.best, r.win, a.P, a.cols, a.packed,
                     a.acc, sh.item + 3);
  }
}

// Refuses what no body takes; threads per CTA on success, else 0.
int check_args(const Args& a, int rows) {
  if (rows <= 0 || a.P <= 0 || a.chunk < 1 || a.chunk > kMaxChunk ||
      a.n_chunks < 1 || a.cols < 10 || a.stage_cap < 1 ||
      a.tile * a.tile != a.P || a.n1d * a.n1d != a.tiles_per_view ||
      a.n1d > 256) {
    return 0;
  }
  const int threads = a.P < kMaxThreads ? a.P : kMaxThreads;
  // whole warps: pass 1 ballots with every lane
  if (a.P % threads != 0 || threads % 32 != 0 ||
      !ppt_instantiated(a.P / threads)) {
    return 0;
  }
  return threads;
}

template <class Kernel>
int allow_shared(Kernel kernel, size_t dyn) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper reports it, no later launch
    return (int)err;
  }
  return 0;
}

template <int PPT, class Pack>
int launch_sweep(const Args& a, const Pack& pack, const Split& sp,
                 const ItemList& items, int threads, cudaStream_t stream) {
  auto kernel = raster_sweep_kernel<PPT, Pack>;
  const size_t dyn = a.bbox ? (size_t)a.stage_cap * sizeof(int) : 0;
  int err = allow_shared(kernel, dyn);
  int grid = 0;
  if (err == 0) err = persistent_grid(kernel, threads, dyn, &grid);
  if (err != 0) return err;
  kernel<<<grid, threads, dyn, stream>>>(a, pack, sp, items);
  return (int)cudaGetLastError();
}

// The entry points' sweep: builds the item list (schedule_kernel with, when
// compacting, the count pass's staged counts) and fills the merge words,
// then sweeps on `pack`, all on `stream`.
template <class Pack>
int sweep(const Args& a, const Pack& pack, int rows, int seg, int* order,
          int* ends, int* n_items, int* done, int* next,
          unsigned long long* merge, int* staged, int* seg_counts,
          void* stream) {
  const int threads = check_args(a, rows);
  if (threads == 0 || !segments_fit(a.n_chunks, seg) ||
      (a.bbox != nullptr) != (staged != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Split sp{seg, max_segments(a.n_chunks, seg), staged, seg_counts};
  const ItemList items{order, ends, rows, next, done, merge};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScheduleArgs sa{a.counts, staged, rows, a.n_chunks, seg, a.chunk,
                        a.stage_cap, order, ends, n_items, done, next,
                        nullptr};
  const int err = build_items(sa, merge, a.P, s);
  if (err != 0) return err;
  switch (a.P / threads) {
    case 1: return launch_sweep<1>(a, pack, sp, items, threads, s);
    case 2: return launch_sweep<2>(a, pack, sp, items, threads, s);
    case 4: return launch_sweep<4>(a, pack, sp, items, threads, s);
    case 8: return launch_sweep<8>(a, pack, sp, items, threads, s);
    case 16: return launch_sweep<16>(a, pack, sp, items, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const int* ids, const int* offsets, const int* counts,
               const float* origins, const int* bbox, const float* dx,
               const float* dy, const float* dz, int* packed, float* acc,
               int P, int cols, int Fp, int chunk, int tiles_per_view,
               int n_chunks, int tile, int n1d, int stage_cap) {
  return Args{ids,  offsets, counts, origins, bbox, dx,    dy,
              dz,   packed,  acc,    P,       cols, Fp,    chunk,
              tiles_per_view, n_chunks, tile, n1d, stage_cap};
}

}  // namespace

// The count pass of kernels B and C (compacting only): builds the item
// list of `seg` list positions over every row (schedule_kernel without
// staged counts; order, ends, n_items: rows each; next: 1), clears staged
// (rows) and counts into it each row's staged faces, writing seg_counts
// (rows, max_segments) where a segment exists; all on `stream`. Other
// arguments as raster_compact_launch.
extern "C" int raster_count_launch(
    const int* ids, const int* offsets, const int* counts, const int* bbox,
    int* order, int* ends, int* n_items, int* next, int* staged,
    int* seg_counts, int rows, int P, int Fp, int chunk, int tiles_per_view,
    int n_chunks, int tile, int n1d, int seg, void* stream) {
  const Args a = make_args(ids, offsets, counts, nullptr, bbox, nullptr,
                           nullptr, nullptr, nullptr, nullptr, P, 10, Fp,
                           chunk, tiles_per_view, n_chunks, tile, n1d, 1);
  const int threads = check_args(a, rows);
  if (bbox == nullptr || threads == 0 || !segments_fit(n_chunks, seg)) {
    return (int)cudaErrorInvalidValue;
  }
  const Split sp{seg, max_segments(n_chunks, seg), staged, seg_counts};
  const ItemList items{order, ends, rows, next, nullptr, nullptr};
  int grid = 0;
  int err = persistent_grid(raster_count_kernel, threads, 0, &grid);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScheduleArgs sa{counts, nullptr, rows, n_chunks, seg, chunk, 0,
                        order, ends, n_items, nullptr, next, staged};
  err = build_items(sa, nullptr, P, s);
  if (err != 0) return err;
  raster_count_kernel<<<grid, threads, 0, s>>>(a, sp, items);
  return (int)cudaGetLastError();
}

// Kernel B's sweep. Launches on `stream` and returns a CUDA error code (0
// on success). rows = K*T tiles of P = tile^2 pixels, T = n1d^2 tiles a
// view; row r's list is ids[offsets[r] ...], counts[r] long
// (raster_common.cuh); pack is (cols, Fp) row-major; bbox is (K, Fp),
// required, and
// staged and seg_counts come from the count pass. The caller allocates the
// item list (order, ends, n_items, done: rows each; next: 1) and the merge
// words (rows, P).
extern "C" int raster_compact_launch(
    const int* ids, const int* offsets, const int* counts,
    const float* origins, const float* pack, const int* bbox, const float* dx,
    const float* dy, const float* dz, int* order, int* ends, int* n_items,
    int* done, int* next, unsigned long long* merge, int* staged,
    int* seg_counts, int* packed, float* acc, int rows, int P, int cols,
    int Fp, int chunk, int tiles_per_view, int n_chunks, int tile, int n1d,
    int stage_cap, int seg, void* stream) {
  if (bbox == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = make_args(ids, offsets, counts, origins, bbox, dx, dy, dz,
                           packed, acc, P, cols, Fp, chunk, tiles_per_view,
                           n_chunks, tile, n1d, stage_cap);
  return sweep(a, RowMajor{pack, Fp}, rows, seg, order, ends, n_items, done,
               next, merge, staged, seg_counts, stream);
}

// Kernel C's sweep. As kernel B's, but pack is chunk-major
// (Fp / chunk, cols, chunk) and bbox may be null (the plain body, with
// staged and seg_counts null).
extern "C" int raster_streamed_launch(
    const int* ids, const int* offsets, const int* counts,
    const float* origins, const float* pack, const int* bbox, const float* dx,
    const float* dy, const float* dz, int* order, int* ends, int* n_items,
    int* done, int* next, unsigned long long* merge, int* staged,
    int* seg_counts, int* packed, float* acc, int rows, int P, int cols,
    int Fp, int chunk, int tiles_per_view, int n_chunks, int tile, int n1d,
    int stage_cap, int seg, void* stream) {
  const Args a = make_args(ids, offsets, counts, origins, bbox, dx, dy, dz,
                           packed, acc, P, cols, Fp, chunk, tiles_per_view,
                           n_chunks, tile, n1d, stage_cap);
  return sweep(a, ChunkMajor{pack, cols, chunk}, rows, seg, order, ends,
               n_items, done, next, merge, staged, seg_counts, stream);
}
