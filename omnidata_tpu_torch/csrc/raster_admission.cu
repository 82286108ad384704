// Chunk admission for Hopper (sm_90a): per (view, tile) row, the ascending
// list of 128-face Morton chunks holding a face whose conservative screen
// bbox overlaps the tile, and per (view, face) the bbox word of the
// compacting kernels.
//
// Replaces no Pallas kernel: the JAX package admits with XLA ops
// (omnidata_tpu/mesh/raster.py: face_screen_bboxes, the separable overlap
// einsum and admission_lists inside render_views_fused), which XLA fuses
// on a TPU. The port's plain version of the same function
// (omnidata_tpu_torch/mesh/raster.py: admission_exact_reference, i.e.
// padded_bboxes, tile_overlap, exact_lists, bbox_words) runs about a
// hundred unfused PyTorch ops whose (K, Fp)-sized float intermediates reach
// device memory.
//
// What bounds it: per (view, face) about 250 FP32 operations (the camera
// transform of three corners, up to six projections with their IEEE
// divisions, the near-plane crossings, the tile rectangle), against 36
// bytes of corners a face and 4 bytes of bbox word a (view, face) written;
// the bit matrix (K*T rows of ceil(NC / 32) words) and the lists are small.
// At K = 32 views, 1,423,616 faces and 256 tiles a view that is ~0.17 ms of
// operations at 67 TFLOP/s and ~0.08 ms of bytes at 3.35 TB/s. Design
// answer: no (K, Fp)-sized float leaves the SM.
//
// admission_overlap_kernel: a CTA owns one word column of the bit matrix
// (chunks 32w .. 32w + 31) for a group of views (and, where a view has more
// tiles than shared memory holds, a range of tile rows). A group holds up
// to 32 views; on a scene of few word columns it holds fewer, so that the
// grid still fills the card (a 40k-face scene has 10 columns). Each thread reads
// a face's three corners once and, for every view of the group, computes
// the face's bbox in registers, writes its bbox word, and ORs its chunk's
// bit into a shared word for each tile its bbox overlaps. The shared words,
// one per (view, tile), are the column; the CTA writes them once at the end.
//
// The lists (three small kernels after the overlap kernel, no host sync):
// every row's exact list, each chunk whose bits are set for the row, in
// ascending order and uncapped, in one flat int32 buffer at the row's
// offset (a CSR layout: flat lists plus row offsets; raster_common.cuh's
// Schedule reads it). This is the port's form; the JAX package's capped
// lists (at most ccap ids a row, else block mode or a scan of every chunk)
// serve the TPU's static shapes only.
//   admission_rows_kernel, one warp a row: the row's count, the popcount
//     of its words;
//   admission_scan_kernel, one CTA: offsets, exclusive prefix sums of the
//     counts, first over the rows of at most `slots` chunks, then over the
//     longer rows after them. The buffer holds rows * slots (the caller's
//     choice: raster.list_slots), so the short rows always fit: only a
//     longer row whose list would end past it gets count -1, scan every
//     chunk (winner-exact), as does every later longer row; offsets[rows]
//     is where the listed slots end;
//   admission_lists_kernel, one warp a row: the row's set chunks at their
//     ranks (prefix sums of the words' popcounts across the warp) from its
//     offset; the grid zeroes the slots past the last list.
// Plain version: raster.admission_rows_reference (exact_lists on the bits).
//
// Exactness: the bbox evaluates face_screen_bboxes' float operations in
// their order (sums left to right, torch.minimum/maximum's NaN
// propagation, clamp before the division), and the file is built with
// -fmad=false, IEEE division and no FTZ, so the bbox words, lists and
// counts equal the plain version's bit for bit. bbox_words divides by a
// Python number, which PyTorch's CUDA division computes as a product with
// the number's float reciprocal; the kernel does the same (for the
// power-of-two tiles the raster kernels take, that is the quotient).
// Float constants are formed in double and rounded once to float32, as
// PyTorch rounds Python numbers.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxViews = 32;      // views an overlap CTA keeps in shared memory
constexpr int kTileWords = 11264;  // (view, tile) words of an overlap CTA: 44 KB
constexpr int kMinCtas = 264;      // overlap CTAs wanted: two per SM of an H100
constexpr unsigned kFull = 0xffffffffu;

constexpr float kNear = (float)1e-4;
constexpr float kBigF = (float)1e9;

// torch.minimum / torch.maximum: NaN when either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

struct View {
  float rt[12];  // extrinsic [R|t], row-major 3x4
  float km[9];   // intrinsic K, row-major 3x3
};

// one row of _affine3: (m0 x + m1 y) + m2 z
__device__ __forceinline__ float dot3(const float* m, float x, float y,
                                      float z) {
  return m[0] * x + m[1] * y + m[2] * z;
}

// face_screen_bboxes' to_uv: K p, then u, v over clamp(w, min=near)
__device__ __forceinline__ void to_uv(const float* km, float x, float y,
                                      float z, float& u, float& v) {
  const float uw = dot3(km, x, y, z);
  const float vw = dot3(km + 3, x, y, z);
  const float w = dot3(km + 6, x, y, z);
  const float zz = w < kNear ? kNear : w;  // NaN stays NaN
  u = uw / zz;
  v = vw / zz;
}

struct Box {
  float lox, loy, hix, hiy;
  bool live;
};

// face_screen_bboxes for one face and one view: the bbox over the in-front
// corners and the edge/near-plane crossings; dead faces (not real, wholly
// behind the near plane or off screen) get lo = +BIG, hi = -BIG.
__device__ __forceinline__ Box face_box(const View& c, const float (&p)[9],
                                        bool real, float res) {
  float cx[3], cy[3], cz[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cx[i] = dot3(c.rt, p[3 * i], p[3 * i + 1], p[3 * i + 2]) + c.rt[3];
    cy[i] = dot3(c.rt + 4, p[3 * i], p[3 * i + 1], p[3 * i + 2]) + c.rt[7];
    cz[i] = dot3(c.rt + 8, p[3 * i], p[3 * i + 1], p[3 * i + 2]) + c.rt[11];
  }
  Box b{kBigF, kBigF, -kBigF, -kBigF, false};
  bool any_front = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const bool front = cz[i] > kNear;
    any_front |= front;
    float u, v;
    if (front) {
      to_uv(c.km, cx[i], cy[i], cz[i], u, v);
      b.lox = nan_min(b.lox, u);
      b.loy = nan_min(b.loy, v);
      b.hix = nan_max(b.hix, u);
      b.hiy = nan_max(b.hiy, v);
    }
    if (front != (cz[j] > kNear)) {
      const float za = cz[i], zb = cz[j];
      const float tcl = (kNear - za) / (zb == za ? 1.0f : zb - za);
      const float px = cx[i] + tcl * (cx[j] - cx[i]);
      const float py = cy[i] + tcl * (cy[j] - cy[i]);
      to_uv(c.km, px, py, kNear, u, v);
      b.lox = nan_min(b.lox, u);
      b.loy = nan_min(b.loy, v);
      b.hix = nan_max(b.hix, u);
      b.hiy = nan_max(b.hiy, v);
    }
  }
  b.live = real && any_front && b.hix >= 0.0f && b.lox <= res &&
           b.hiy >= 0.0f && b.loy <= res;
  if (!b.live) {
    b.lox = b.loy = kBigF;
    b.hix = b.hiy = -kBigF;
  }
  return b;
}

// bbox_words' q: clamp(floor(x), 0, 255) as an integer
__device__ __forceinline__ unsigned quantize(float x) {
  const float f = floorf(x);
  return (unsigned)(f < 0.0f ? 0.0f : (f > 255.0f ? 255.0f : f));
}

__device__ __forceinline__ int bbox_word(const Box& b, float inv_tile) {
  const float inv_band = 1.0f / 8.0f;
  return (int)(quantize((b.lox - 1.0f) * inv_tile) |
               (quantize((b.hix + 1.0f) * inv_tile) << 8) |
               (quantize((b.loy - 1.0f) * inv_band) << 16) |
               (quantize((b.hiy + 1.0f) * inv_band) << 24));
}

// tile_overlap's test: tile t overlaps [lo, hi] when hi >= t * tile and
// lo <= t * tile + tile. first_tile: the least t in [0, n) with the second
// (n if none); last_tile: the greatest with the first (-1 if none). The
// estimate from the quotient is corrected by the exact comparisons.
__device__ __forceinline__ int first_tile(float lo, int tile, int n) {
  const float g = floorf(lo / (float)tile);
  int t = g <= 1.0f ? 0 : (g >= (float)n ? n : (int)g - 1);
  while (t > 0 && lo <= (float)(t * tile)) --t;
  while (t < n && !(lo <= (float)((t + 1) * tile))) ++t;
  return t;
}

__device__ __forceinline__ int last_tile(float hi, int tile, int n) {
  const float g = floorf(hi / (float)tile);
  int t = g < 0.0f ? -1 : (g >= (float)(n - 1) ? n - 1 : (int)g);
  while (t >= 0 && !(hi >= (float)(t * tile))) --t;
  while (t + 1 < n && hi >= (float)((t + 1) * tile)) ++t;
  return t;
}

struct OverlapArgs {
  const float* vertices;  // (V, 3)
  const int* faces;       // (F, 3)
  const float* rt;        // (K, 3, 4)
  const float* km;        // (K, 3, 3)
  int* words;             // (K, Fp) or null
  unsigned* bits;         // (K * T, nw)
  int num_faces, K, res, tile, n1d, chunk, n_chunks, nw;
  int views_per_cta, rows_per_range, n_ranges;
};

__global__ void __launch_bounds__(kThreads)
admission_overlap_kernel(const OverlapArgs a) {
  __shared__ View s_view[kMaxViews];
  __shared__ unsigned s_bits[kTileWords];

  const int w = blockIdx.x;
  const int range = blockIdx.y % a.n_ranges;
  const int k0 = (blockIdx.y / a.n_ranges) * a.views_per_cta;
  const int nv = min(a.views_per_cta, a.K - k0);
  const int ty0 = range * a.rows_per_range;
  const int ty1 = min(a.n1d, ty0 + a.rows_per_range);
  const int tr = (ty1 - ty0) * a.n1d;  // tiles of the range, per view
  const int T = a.n1d * a.n1d;

  for (int i = threadIdx.x; i < nv * 21; i += blockDim.x) {
    const int v = i / 21, e = i % 21;
    if (e < 12) {
      s_view[v].rt[e] = a.rt[(size_t)(k0 + v) * 12 + e];
    } else {
      s_view[v].km[e - 12] = a.km[(size_t)(k0 + v) * 9 + e - 12];
    }
  }
  for (int i = threadIdx.x; i < nv * tr; i += blockDim.x) s_bits[i] = 0u;
  __syncthreads();

  const int Fp = a.n_chunks * a.chunk;
  const int f0 = w * 32 * a.chunk;
  const int f1 = min(f0 + 32 * a.chunk, Fp);
  const float res = (float)a.res;
  const float inv_tile = 1.0f / (float)a.tile;
  const bool words = a.words != nullptr && range == 0;
  for (int f = f0 + threadIdx.x; f < f1; f += blockDim.x) {
    const bool real = f < a.num_faces;
    float p[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int vi = real ? a.faces[(size_t)f * 3 + c] : 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        p[3 * c + d] = real ? a.vertices[(size_t)vi * 3 + d] : 0.0f;
      }
    }
    const unsigned bit = 1u << (f / a.chunk - 32 * w);
    for (int v = 0; v < nv; ++v) {
      const Box b = face_box(s_view[v], p, real, res);
      if (words) a.words[(size_t)(k0 + v) * Fp + f] = bbox_word(b, inv_tile);
      if (!b.live) continue;
      const int x0 = first_tile(b.lox, a.tile, a.n1d);
      const int x1 = last_tile(b.hix, a.tile, a.n1d);
      const int y0 = max(first_tile(b.loy, a.tile, a.n1d), ty0);
      const int y1 = min(last_tile(b.hiy, a.tile, a.n1d), ty1 - 1);
      for (int ty = y0; ty <= y1; ++ty) {
        unsigned* row_bits = s_bits + v * tr + (ty - ty0) * a.n1d;
        for (int tx = x0; tx <= x1; ++tx) atomicOr(row_bits + tx, bit);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nv * tr; i += blockDim.x) {
    const int v = i / tr, t = ty0 * a.n1d + i % tr;
    a.bits[((size_t)(k0 + v) * T + t) * a.nw + w] = s_bits[i];
  }
}

struct RowsArgs {
  const unsigned* bits;  // (rows, nw)
  int* ids;              // (capacity,): the lists, flat
  int* counts;           // (rows,)
  int* offsets;          // (rows + 1,)
  int rows, nw, slots, capacity;  // capacity = rows * slots
};

// counts[row] = the set chunks of the row
__global__ void __launch_bounds__(kThreads)
admission_rows_kernel(const RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp
  const unsigned* bits = a.bits + (size_t)row * a.nw;
  int n_set = 0;
  for (int w = lane; w < a.nw; w += 32) n_set += __popc(bits[w]);
  n_set = __reduce_add_sync(kFull, n_set);
  if (lane == 0) a.counts[row] = n_set;
}

constexpr int kScanThreads = 1024;

// One CTA, two passes over the rows in order. Pass 0 places the rows of at
// most `slots` chunks from slot 0; their lists always fit, since they sum
// to at most capacity. Pass 1 places the longer rows from where those end;
// a longer row whose list would end past capacity gets count -1, scan every
// chunk, and so does every later longer row, as the ends only grow. Such a
// row's offset is its start clamped to capacity; offsets[rows] = the end
// of the listed slots. Sums in 64 bits, so no count overflows them.
__global__ void __launch_bounds__(kScanThreads)
admission_scan_kernel(const RowsArgs a) {
  __shared__ long long s_warp[kScanThreads / 32];
  __shared__ long long s_carry;
  __shared__ int s_used;  // the first refused offset, else capacity
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_carry = 0;
    s_used = a.capacity;
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    for (int r0 = 0; r0 < a.rows; r0 += kScanThreads) {
      const int r = r0 + tid;
      const int count = r < a.rows ? a.counts[r] : 0;
      const bool mine = r < a.rows && (count > a.slots) == (pass == 1);
      const long long n = mine ? count : 0;
      long long v = n;  // inclusive prefix sum over the warp, then over warps
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long x = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += x;
      }
      if (lane == 31) s_warp[warp] = v;
      __syncthreads();
      if (warp == 0) {
        long long t = s_warp[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long x = __shfl_up_sync(kFull, t, d);
          if (lane >= d) t += x;
        }
        s_warp[lane] = t;
      }
      __syncthreads();
      const long long end = s_carry + (warp ? s_warp[warp - 1] : 0) + v;
      if (mine) {
        const long long off = end - n;
        a.offsets[r] = (int)(off < a.capacity ? off : a.capacity);
        if (end > a.capacity) {
          a.counts[r] = -1;
          atomicMin(&s_used, (int)(off < a.capacity ? off : a.capacity));
        }
      }
      __syncthreads();
      if (tid == kScanThreads - 1) s_carry = end;
      __syncthreads();
    }
  }
  if (tid == 0) a.offsets[a.rows] = (int)(s_carry < s_used ? s_carry : s_used);
}

// The rows' set chunks, ascending, at ids[offsets[row] ...]; zeros in the
// slots from offsets[rows] to capacity.
__global__ void __launch_bounds__(kThreads)
admission_lists_kernel(const RowsArgs a) {
  const int used = a.offsets[a.rows];
  for (int j = used + blockIdx.x * blockDim.x + threadIdx.x; j < a.capacity;
       j += gridDim.x * blockDim.x) {
    a.ids[j] = 0;
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= a.rows) return;  // the whole warp
  const int count = a.counts[row];
  if (count <= 0) return;  // nothing listed, or every chunk
  const unsigned* bits = a.bits + (size_t)row * a.nw;
  int* ids = a.ids + a.offsets[row];
  for (int w0 = 0, base = 0; base < count && w0 < a.nw; w0 += 32) {  // uniform
    const int w = w0 + lane;
    const unsigned x = w < a.nw ? bits[w] : 0u;
    const int nc = __popc(x);
    int sc = nc;  // inclusive prefix sum over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, sc, d);
      if (lane >= d) sc += u;
    }
    int r = base + sc - nc;
    for (unsigned m = x; m != 0u; m &= m - 1u) ids[r++] = w * 32 + __ffs(m) - 1;
    base += __shfl_sync(kFull, sc, 31);
  }
}

}  // namespace

// Admission of K views: the overlap kernel fills the bit matrix bits
// (K * T, ceil(n_chunks / 32)) and, when words is not null, the bbox words
// (K, n_chunks * chunk); the rows, scan and lists kernels turn the bits into
// every row's exact list: ids (K * T * slots,), counts (K * T,) and offsets
// (K * T + 1,), the last the end of the listed slots. faces (F, 3) index
// vertices (V, 3); faces at or past num_faces, and the padding up to
// n_chunks * chunk, are dead. rt (K, 3, 4) and km (K, 3, 3) are the views'
// extrinsic and intrinsic matrices. All on `stream`; returns a CUDA error
// code (0 on success).
extern "C" int admission_launch(const float* vertices, const int* faces,
                                const float* rt, const float* km, int* words,
                                unsigned* bits, int* ids, int* counts,
                                int* offsets, int num_faces, int F, int K,
                                int res, int tile, int chunk, int n_chunks,
                                int slots, void* stream) {
  if (K < 1 || tile < 1 || res < tile || res % tile != 0 || chunk < 1 ||
      n_chunks < 1 || (long long)n_chunks * chunk > INT_MAX ||
      F > n_chunks * chunk || F <= (n_chunks - 1) * chunk || num_faces < 0 ||
      num_faces > F || slots < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n1d = res / tile;
  if (n1d > kTileWords || (long long)n1d * n1d * K > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int T = n1d * n1d;
  const int nw = n_chunks / 32 + (n_chunks % 32 != 0);
  int views_per_cta = 1, rows_per_range = n1d;
  if (T <= kTileWords) {
    // fewer views a CTA where the word columns alone leave SMs idle
    const int groups = kMinCtas / nw + (kMinCtas % nw != 0);
    views_per_cta = min(min(K, kMaxViews), kTileWords / T);
    views_per_cta = min(views_per_cta, K / groups + (K % groups != 0));
  } else {
    rows_per_range = kTileWords / n1d;
  }
  const int n_ranges = n1d / rows_per_range + (n1d % rows_per_range != 0);
  const int n_groups = K / views_per_cta + (K % views_per_cta != 0);
  const int rows = K * T;
  // the offsets index the ids buffer with an int
  if ((long long)n_groups * n_ranges > 65535 ||
      (long long)rows * slots > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OverlapArgs oa{vertices, faces, rt, km, words, bits, num_faces, K,
                       res, tile, n1d, chunk, n_chunks, nw, views_per_cta,
                       rows_per_range, n_ranges};
  admission_overlap_kernel<<<dim3(nw, n_groups * n_ranges), kThreads, 0, s>>>(
      oa);
  const RowsArgs ra{bits, ids, counts, offsets, rows, nw, slots, rows * slots};
  constexpr int rows_per_cta = kThreads / 32;
  const int row_ctas = rows / rows_per_cta + (rows % rows_per_cta != 0);
  admission_rows_kernel<<<row_ctas, kThreads, 0, s>>>(ra);
  admission_scan_kernel<<<1, kScanThreads, 0, s>>>(ra);
  admission_lists_kernel<<<row_ctas, kThreads, 0, s>>>(ra);
  return (int)cudaGetLastError();
}
