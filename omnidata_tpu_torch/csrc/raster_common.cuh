// Pieces shared by the Hopper raster kernels (raster_chunklist.cu,
// raster_compact.cu): the TPU's key and tie constants, the decode of one
// row's chunk list, the two pack layouts, the per-face Moller-Trumbore
// invariants, the per-chunk key sweep, the winner write, and the work items
// of kernels A, B and C with their exact merge.
//
// Every kernel that includes this file evaluates the operations of the
// plain PyTorch versions (omnidata_tpu_torch/mesh/raster_kernels.py) in the
// same order and is built with -fmad=false, IEEE division and no FTZ, so
// kernel and plain version agree bit for bit. Float constants are formed in
// double and rounded once to float32, as the JAX package forms them.
//
// Lists (Schedule below): the card's exact form only, every row's list at
// its offset into one flat id buffer.
//
// Work items (kernels A, B and C). A row's raw-list sweep is cut into
// segments of at most `seg` consecutive list positions; each segment is one
// item.
// Persistent CTAs (as many as fit on the card at once) take item blockIdx.x
// first, then pull items from an atomic counter, in the order of an item
// list that one CTA builds on the
// device in the same entry point (schedule_kernel, whose plain version is
// raster_kernels.split_schedule): rows in a stable sort by the bucket of
// their largest item's cost, largest first, their items contiguous; it
// also clears the launch's counters, so the wrapper only allocates. A row
// of one item writes its
// winners directly. A row of several items merges them exactly: per pixel,
// the sequential sweep returns the leftmost minimum over (masked key, list
// position, lane), and the leftmost minimum is associative, so each item
// sweeps its segment from scratch and posts (masked key | segment,
// lane << 24 | face) with a 64-bit atomicMin; the masked key's 13 zero low
// bits carry the segment index, so equal masked keys resolve to the earlier
// segment, exactly as fold_chunk's strict improvement does. Segments without
// a hit post nothing, as a chunk without a hit never replaces the winner.
// The last item of the row to finish (a per-row counter after
// __threadfence) decodes the minimum and writes packed and acc.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace raster {

constexpr int kMaxChunk = 128;
constexpr int kMaxThreads = 256;
constexpr int kTieMask = ~((1 << 13) - 1);
constexpr int kLaneMask = (1 << 13) - 1;
constexpr int kMaxSegments = 1 << 13;  // a segment index fits the tie bits
constexpr unsigned long long kNoHit = ~0ull;

constexpr float kBig = (float)1e30;
constexpr float kEps = (float)1e-7;
constexpr float kEps2 = (float)(1e-7 * 1e-7);
constexpr float kNegEdge = (float)(-1e-5);
constexpr float kOneEdge = (float)(1.0 + 1e-5);

__device__ __forceinline__ int big_packed() {
  return __float_as_int(kBig) & kTieMask;
}

// One row's chunk list, in the exact form admission writes on a card
// (raster_admission.cu): counts[row] >= 0 ascending chunk ids at
// ids[offsets[row] ...], every chunk that holds a face whose bbox overlaps
// the tile, uncapped (CSR: a flat list plus row offsets); or count -1, a
// row past the buffer, which scans every chunk in order. The JAX package's
// capped form (block mode, at most ccap ids a row) reaches no kernel. A
// list has at most n_chunks positions.
__host__ __device__ __forceinline__ int list_trip(int count, int n_chunks) {
  return count == -1 ? n_chunks : count;
}

// ceil(a / b) for a >= 0, b >= 1, without the overflow of a + b - 1
__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return a / b + (a % b != 0);
}

// Row `row`'s list, decoded; callers ask only positions i < trip.
struct Schedule {
  const int* ids;
  int trip;
  bool full;

  __device__ Schedule(const int* all_ids, const int* offsets, int row,
                      int count, int n_chunks)
      : ids(count == -1 ? all_ids : all_ids + offsets[row]),
        trip(list_trip(count, n_chunks)), full(count == -1) {}
  // the chunk id at list position i
  __device__ int chunk_of(int i) const { return full ? i : ids[i]; }
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

// The item list of one launch (schedule_kernel): order[pos] is a row, ends
// the inclusive prefix sum of the rows' item counts in that order, so item
// j belongs to the first pos with ends[pos] > j. next counts the items
// handed out; done[row] the row's finished items; merge is (rows, P), all
// ones in the rows of several items before the sweep (merge_init_kernel).
struct ItemList {
  const int* order;
  const int* ends;
  int rows;
  int* next;
  int* done;
  unsigned long long* merge;
};

struct Item {
  int row, seg, n_segs;
};

// Thread 0 takes the next item and the CTA learns it through s_item[3];
// false once every item is taken. A CTA's first item is item blockIdx.x:
// the first wave of CTAs lands one to an SM in block order, so the longest
// items, which lead the list, start on SMs of their own (taken from the
// counter in arrival order, several long items could share one SM while
// others idle, which shows when the items are few); later items come from
// the atomic counter. The barrier in front keeps s_item and the
// previous item's shared memory from being overwritten while read.
__device__ __forceinline__ bool next_item(const ItemList& L, int* s_item,
                                          Item& it, bool& first) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int j = first ? (int)blockIdx.x
                        : (int)gridDim.x + atomicAdd(L.next, 1);
    if (j >= L.ends[L.rows - 1]) {
      s_item[0] = -1;
    } else {
      int lo = 0, hi = L.rows - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (L.ends[mid] > j) hi = mid; else lo = mid + 1;
      }
      const int start = lo ? L.ends[lo - 1] : 0;
      s_item[0] = L.order[lo];
      s_item[1] = j - start;
      s_item[2] = L.ends[lo] - start;
    }
  }
  __syncthreads();
  first = false;
  it = Item{s_item[0], s_item[1], s_item[2]};
  return it.row >= 0;
}

// Writes an item's winners: directly for a row of one item; else posts
// them to the row's merge words, and the row's last item to finish decodes
// the merged minimum and writes it. `lane` of a winner is its lane in the
// swept chunk (face - chunk base on the raw list, which split items sweep).
template <int PPT, class Pack>
__device__ __forceinline__ void finish_item(const ItemList& L, const Item& it,
                                            const Pack& pack, int (&best)[PPT],
                                            int (&win)[PPT], int P, int cols,
                                            int* packed_out, float* acc_out,
                                            int* s_flag) {
  if (it.n_segs == 1) {
    write_winners<PPT>(pack, best, win, it.row, P, cols, packed_out, acc_out);
    return;
  }
  unsigned long long* m = L.merge + (size_t)it.row * P;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int masked = best[k] & kTieMask;
    if (masked < big_packed()) {
      const unsigned hi = (unsigned)(masked | it.seg);
      const unsigned lo = ((unsigned)(best[k] & kLaneMask) << 24) |
                          (unsigned)win[k];
      atomicMin(m + threadIdx.x + k * blockDim.x,
                ((unsigned long long)hi << 32) | lo);
    }
  }
  __threadfence();  // the posts are visible before the row's count moves
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_flag = atomicAdd(L.done + it.row, 1) == it.n_segs - 1;
  }
  __syncthreads();
  if (!*s_flag) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const unsigned long long v = __ldcg(m + threadIdx.x + k * blockDim.x);
    if (v == kNoHit) {
      best[k] = big_packed();
      win[k] = -1;
    } else {
      const unsigned lo = (unsigned)v;
      best[k] = ((int)(v >> 32) & kTieMask) | (int)(lo >> 24);
      win[k] = (int)(lo & 0xFFFFFFu);
    }
  }
  write_winners<PPT>(pack, best, win, it.row, P, cols, packed_out, acc_out);
}

// The inputs and outputs of schedule_kernel. staged null: every row is cut
// into segments of its raw list; else a row staging at most stage_cap faces
// is one dense item. done and clear_staged may be null.
struct ScheduleArgs {
  const int* counts;
  const int* staged;
  int rows, n_chunks, seg, chunk, stage_cap;
  int* order;
  int* ends;
  int* n_items;
  int* done;          // zeroed
  int* next;          // zeroed
  int* clear_staged;  // zeroed (the count pass's output)
};

constexpr int kScheduleThreads = 1024;
constexpr int kBuckets = 128;

// Monotone in cost, 4 buckets per power of two: the sort key of a row.
__device__ __forceinline__ int cost_bucket(int cost) {
  if (cost < 4) return cost;
  const int e = 31 - __clz(cost);
  return 4 * e + (cost >> (e - 2)) - 8;
}

// A row's item count and the pixel-face pairs per pixel of its largest
// item: min(trip, seg) raw chunks, or a dense row's staged faces.
__device__ __forceinline__ int row_items(const ScheduleArgs& s, int r,
                                         int* cost) {
  const int trip = list_trip(s.counts[r], s.n_chunks);
  if (s.staged != nullptr && s.staged[r] <= s.stage_cap) {
    *cost = s.staged[r];
    return 1;
  }
  *cost = min(trip, s.seg) * s.chunk;
  return max(1, ceil_div(trip, s.seg));
}

// One CTA of kScheduleThreads: n_items per row; order, a stable sort of the
// rows by descending cost_bucket (a counting sort: per tile of rows, each
// warp ranks its lanes of one bucket with __match_any_sync); ends, the
// inclusive prefix sum of n_items in that order.
__global__ void __launch_bounds__(kScheduleThreads)
schedule_kernel(const ScheduleArgs s) {
  constexpr int kWarps = kScheduleThreads / 32;
  __shared__ int s_base[kBuckets];
  __shared__ int s_wcount[kWarps][kBuckets];
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kBuckets) s_base[tid] = 0;
  if (tid == 0) {
    *s.next = 0;
    s_carry = 0;
  }
  __syncthreads();
  for (int r = tid; r < s.rows; r += kScheduleThreads) {
    int cost;
    s.n_items[r] = row_items(s, r, &cost);
    if (s.done != nullptr) s.done[r] = 0;
    if (s.clear_staged != nullptr) s.clear_staged[r] = 0;
    atomicAdd(&s_base[cost_bucket(cost)], 1);
  }
  __syncthreads();
  if (tid == 0) {  // each bucket's first position, the largest bucket first
    int sum = 0;
    for (int b = kBuckets - 1; b >= 0; --b) {
      const int c = s_base[b];
      s_base[b] = sum;
      sum += c;
    }
  }
  for (int r0 = 0; r0 < s.rows; r0 += kScheduleThreads) {
    const int r = r0 + tid;
    int b = kBuckets;  // no row
    if (r < s.rows) {
      int cost;
      row_items(s, r, &cost);
      b = cost_bucket(cost);
    }
    for (int i = tid; i < kWarps * kBuckets; i += kScheduleThreads) {
      s_wcount[i / kBuckets][i % kBuckets] = 0;
    }
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (b < kBuckets && rank == 0) s_wcount[warp][b] = __popc(peers);
    __syncthreads();
    if (b < kBuckets) {
      int pos = s_base[b] + rank;
      for (int w = 0; w < warp; ++w) pos += s_wcount[w][b];
      s.order[pos] = r;
    }
    __syncthreads();
    if (tid < kBuckets) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_wcount[w][tid];
      s_base[tid] += sum;
    }
    __syncthreads();
  }
  for (int p0 = 0; p0 < s.rows; p0 += kScheduleThreads) {
    const int p = p0 + tid;
    int v = p < s.rows ? s.n_items[s.order[p]] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += x;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int t = s_warp[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += x;
      }
      s_warp[lane] = t;
    }
    __syncthreads();
    const int incl = s_carry + (warp ? s_warp[warp - 1] : 0) + v;
    if (p < s.rows) s.ends[p] = incl;
    __syncthreads();
    if (tid == kScheduleThreads - 1) s_carry = incl;
    __syncthreads();
  }
}

// All ones in the merge words of every row of several items.
__global__ void merge_init_kernel(const int* n_items,
                                  unsigned long long* merge, int P) {
  if (n_items[blockIdx.x] < 2) return;
  unsigned long long* m = merge + (size_t)blockIdx.x * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) m[p] = kNoHit;
}

// Enqueues schedule_kernel and, when merge is given, merge_init_kernel;
// returns a CUDA error code.
inline int build_items(const ScheduleArgs& s, unsigned long long* merge,
                       int P, cudaStream_t stream) {
  schedule_kernel<<<1, kScheduleThreads, 0, stream>>>(s);
  if (merge != nullptr) {
    merge_init_kernel<<<s.rows, 256, 0, stream>>>(s.n_items, merge, P);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs of `kernel` on the whole card: the persistent grid.
template <class Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t dyn,
                           int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dyn);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper reports it
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  return 0;
}

// The longest list a row can hold (every chunk) in segments of seg
// positions.
inline int max_segments(int n_chunks, int seg) {
  return ceil_div(n_chunks, seg);
}

// Pixels per thread that the entry points instantiate (checked before the
// item list is built).
inline bool ppt_instantiated(int ppt) {
  return ppt == 1 || ppt == 2 || ppt == 4 || ppt == 8 || ppt == 16;
}

// The entry points' check on the split: segment indices fit the tie bits.
inline bool segments_fit(int n_chunks, int seg) {
  return seg >= 1 && max_segments(n_chunks, seg) <= kMaxSegments;
}

}  // namespace raster
