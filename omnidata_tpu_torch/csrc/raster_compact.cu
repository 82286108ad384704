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
// One kernel template serves both, on the pack layout; each has its own
// entry point. It computes what the TPU kernels compute, not how: no
// one-hot or triangular matmuls, no staging of whole pack columns.
//
// Compacting body, per (view, tile) row (one CTA):
//   pass 1 walks the row's list in (position, lane) order, blockDim.x faces
//     per round, skips the clamped duplicates at the tail of a block-mode
//     list, and tests each face's u8-packed bbox word (x in tiles, y in
//     8-row bands) against the tile. A warp ballot and __popc give each
//     surviving face its slot; the face ids go to shared memory (4 bytes a
//     face: 32 KB at cap 8192). The count includes faces past the cap.
//   pass 2 sweeps ceil(staged / chunk) dense chunks of staged faces (lane =
//     slot % chunk), or, when more than stage_cap faces were staged, the raw
//     list, which gives kernel A's result for the row.
// Plain body: the raw list.
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
  const int* ids;
  const int* counts;
  const float* origins;
  const int* bbox;  // (K, Fp) u8-packed bbox words, or null: plain body
  const float* dx;
  const float* dy;
  const float* dz;
  int* packed;
  float* acc;
  int P, cols, Fp, chunk, ccap, tiles_per_view, n_chunks, tile, n1d,
      stage_cap;
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

// Pass 1: the faces of the listed chunks whose bbox word overlaps tile
// (tx, ty) go to s_stage in (position, lane) order, fresh positions only.
// Returns their count, faces past stage_cap included.
__device__ int stage_faces(const Schedule& sched, const int* bbox_view,
                           int chunk, int tx, int ty, int tile, int stage_cap,
                           int* s_stage, int (*s_wcount)[kMaxWarps]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int y_lo = (ty * tile) / 8;
  const int y_hi = (ty * tile + tile - 1) / 8;
  const int total = sched.trip * chunk;
  int base = 0;
  int parity = 0;
  for (int e0 = 0; e0 < total; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    bool m = false;
    int f = 0;
    if (e < total) {
      const int i = e / chunk;
      const int raw = sched.raw(i);
      if (raw < sched.n_chunks) {  // not a clamped tail duplicate
        f = raw * chunk + (e - i * chunk);
        const int w = bbox_view[f];
        const int lo_tx = w & 0xFF, hi_tx = (w >> 8) & 0xFF;
        const int lo_by = (w >> 16) & 0xFF, hi_by = (w >> 24) & 0xFF;
        m = lo_tx <= tx && tx <= hi_tx && lo_by <= y_hi && hi_by >= y_lo;
      }
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

template <int PPT, class Pack>
__global__ void __launch_bounds__(kMaxThreads)
raster_staged_kernel(const Args a, const Pack pack) {
  extern __shared__ int s_stage[];  // stage_cap staged face ids
  __shared__ float s_geo[2][9][kMaxChunk];
  __shared__ float s_pre[10][kMaxChunk];
  __shared__ int s_wcount[2][kMaxWarps];

  const int row = blockIdx.x;
  const Schedule sched(a.ids + (size_t)row * a.ccap, a.counts[row], a.ccap,
                       a.n_chunks);
  const int view = row / a.tiles_per_view;
  const int tiv = row - view * a.tiles_per_view;
  const float ox = a.origins[view * 3 + 0];
  const float oy = a.origins[view * 3 + 1];
  const float oz = a.origins[view * 3 + 2];

  float dx[PPT], dy[PPT], dz[PPT];
  int best[PPT], win[PPT], cbest[PPT];
  load_rays<PPT>(a.dx, a.dy, a.dz, (size_t)row * a.P, dx, dy, dz, best, win);

  const int chunk = a.chunk;
  int n_units = sched.trip;
  bool dense = false;
  int staged = 0;
  if (a.bbox != nullptr) {
    staged = stage_faces(sched, a.bbox + (size_t)view * a.Fp, chunk,
                         tiv % a.n1d, tiv / a.n1d, a.tile, a.stage_cap,
                         s_stage, s_wcount);
    dense = staged <= a.stage_cap;  // else: the raw list, kernel A's result
    if (dense) n_units = (staged + chunk - 1) / chunk;
  }
  auto unit_of = [&](int u) -> Unit {
    if (dense) return Unit{min(chunk, staged - u * chunk), 0, s_stage + u * chunk};
    return Unit{chunk, sched.chunk_of(u) * chunk, nullptr};
  };

  // pass 2: double-buffered sweep. Buffer (u+1)&1 was last read while
  // computing unit u-1's invariants, before the barrier that follows them.
  Unit cur = n_units > 0 ? unit_of(0) : Unit{0, 0, nullptr};
  if (n_units > 0) issue_geometry(s_geo[0], pack, cur);
  for (int u = 0; u < n_units; ++u) {
    Unit next = cur;
    if (u + 1 < n_units) {
      next = unit_of(u + 1);
      issue_geometry(s_geo[(u + 1) & 1], pack, next);
      cp_async_wait<1>();  // unit u's copy has landed; u+1's may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies are visible; s_pre is free
    const GeoBuf& g = s_geo[u & 1];
    for (int l = threadIdx.x; l < cur.n; l += blockDim.x) {
      mt_invariants(s_pre, l, g[0][l], g[1][l], g[2][l], g[3][l], g[4][l],
                    g[5][l], g[6][l], g[7][l], g[8][l], ox, oy, oz);
    }
    __syncthreads();
    sweep_chunk<PPT>(s_pre, cur.n, dx, dy, dz, cbest);
    fold_chunk<PPT>(cbest, best, win, [&](int lane) { return cur.face(lane); });
    cur = next;
  }
  write_winners<PPT>(pack, best, win, row, a.P, a.cols, a.packed, a.acc);
}

template <int PPT, class Pack>
int launch_ppt(const Args& a, const Pack& pack, int rows, int threads,
               size_t dyn, cudaStream_t stream) {
  auto kernel = raster_staged_kernel<PPT, Pack>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper reports it, no later launch
    return (int)err;
  }
  kernel<<<rows, threads, dyn, stream>>>(a, pack);
  return (int)cudaGetLastError();
}

template <class Pack>
int launch(const Args& a, const Pack& pack, int rows, void* stream) {
  if (rows <= 0 || a.P <= 0 || a.chunk < 1 || a.chunk > kMaxChunk ||
      a.ccap < 1 || a.n_chunks < 1 || a.cols < 10 || a.stage_cap < 1 ||
      a.tile * a.tile != a.P || a.n1d * a.n1d != a.tiles_per_view ||
      a.n1d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = a.P < kMaxThreads ? a.P : kMaxThreads;
  // whole warps: pass 1 ballots with every lane
  if (a.P % threads != 0 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t dyn = a.bbox ? (size_t)a.stage_cap * sizeof(int) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.P / threads) {
    case 1: return launch_ppt<1>(a, pack, rows, threads, dyn, s);
    case 2: return launch_ppt<2>(a, pack, rows, threads, dyn, s);
    case 4: return launch_ppt<4>(a, pack, rows, threads, dyn, s);
    case 8: return launch_ppt<8>(a, pack, rows, threads, dyn, s);
    case 16: return launch_ppt<16>(a, pack, rows, threads, dyn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const int* ids, const int* counts, const float* origins,
               const int* bbox, const float* dx, const float* dy,
               const float* dz, int* packed, float* acc, int P, int cols,
               int Fp, int chunk, int ccap, int tiles_per_view, int n_chunks,
               int tile, int n1d, int stage_cap) {
  return Args{ids,  counts, origins, bbox, dx,   dy,    dz,
              packed, acc,  P,       cols, Fp,   chunk, ccap,
              tiles_per_view, n_chunks, tile, n1d, stage_cap};
}

}  // namespace

// Kernel B. Launches on `stream` and returns a CUDA error code (0 on
// success). rows = K*T tiles of P = tile^2 pixels, T = n1d^2 tiles a view;
// pack is (cols, Fp) row-major; bbox is (K, Fp), required.
extern "C" int raster_compact_launch(
    const int* ids, const int* counts, const float* origins,
    const float* pack, const int* bbox, const float* dx, const float* dy,
    const float* dz, int* packed, float* acc, int rows, int P, int cols,
    int Fp, int chunk, int ccap, int tiles_per_view, int n_chunks, int tile,
    int n1d, int stage_cap, void* stream) {
  if (bbox == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = make_args(ids, counts, origins, bbox, dx, dy, dz, packed,
                           acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                           n_chunks, tile, n1d, stage_cap);
  return launch(a, RowMajor{pack, Fp}, rows, stream);
}

// Kernel C. As kernel B, but pack is chunk-major (Fp / chunk, cols, chunk)
// and bbox may be null (the plain body).
extern "C" int raster_streamed_launch(
    const int* ids, const int* counts, const float* origins,
    const float* pack, const int* bbox, const float* dx, const float* dy,
    const float* dz, int* packed, float* acc, int rows, int P, int cols,
    int Fp, int chunk, int ccap, int tiles_per_view, int n_chunks, int tile,
    int n1d, int stage_cap, void* stream) {
  const Args a = make_args(ids, counts, origins, bbox, dx, dy, dz, packed,
                           acc, P, cols, Fp, chunk, ccap, tiles_per_view,
                           n_chunks, tile, n1d, stage_cap);
  return launch(a, ChunkMajor{pack, cols, chunk}, rows, stream);
}
