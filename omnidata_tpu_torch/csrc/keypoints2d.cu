// SURF determinant-of-Hessian interest image for Hopper (sm_90a): from the
// float32 integral image of N grey images, every scale's box-filter Hessian
// determinant and the running maximum over the scales, in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves its _blob_doh
// (omnidata_tpu/cues/keypoints2d.py) to XLA, which fuses it on a TPU. It
// was added because the port's plain version of the same function
// (omnidata_tpu_torch/cues/keypoints2d.py: keypoints2d_reference: a padded
// copy of the integral image, then four shifted slices a box and one
// full-batch PyTorch op for every sum, difference, product and maximum,
// ~420 kernels a call) took 27% of a batch of the benchmark's
// xl.annotate10 cell: ~15 ms at 32 x 512^2.
//
// What bounds it: the function's floor is its arithmetic, ~42 float
// operations a pixel and scale, 3.5e9 at 32 x 512^2 and 10 scales, ~0.105 ms
// at the card's unfused FP32 rate (~33 TFLOP/s, the FMA rate halved, since
// nothing here fuses); the 33.5 MB read and 33.5 MB written in device memory
// take ~0.02 ms. This design's own floor lies above that: each pixel reads 4
// corners of 8 boxes at each scale out of shared memory, 320 reads of 4 B,
// 2.7e9 reads, 10.7 GB, ~0.32 ms at the SMs' ~33 TB/s (128 B a clock an SM).
// Neighbouring pixels share corners, so a design that kept them in
// registers would read less.
//
// Design: a CTA owns one 64 x 64 output tile of one image. It stages the
// integral image's tile with a halo of 45 pixels on every side (154^2
// floats, 94.9 KB, two CTAs an SM), which is the reach of the largest
// default scale (sigma 30: size 90, s2 44, s3 30), so every corner that the
// default scales read comes out of shared memory: a warp reads 32
// neighbouring columns of one row, one wavefront. The halo multiplies the
// tile's device-memory reads by ~5.8, 0.2 GB through L2, well under the
// shared-memory traffic. The zero-before / edge-after padding of the plain
// version is applied while staging, by index, so no padded copy exists.
// Each thread owns 16 pixels (one column, every fourth row); eight at a
// time walk every scale with their running maxima in registers (all 16 at
// once spill past the 128 registers that two CTAs an SM leave a thread),
// and it writes only the response. One launch takes up to 16 scales. A
// scale whose reach passes the halo (a larger max_sigma than the default)
// reads its corners from device memory through the read-only cache, with
// the same padding rule; the plain version's pad of 128 bounds every reach,
// and the wrapper raises beyond it.
//
// Exactness: each step rounds in float32 in the plain version's order (a
// box is ((a - b) - c) + d; dxy = (-(((bl + tr) - tl) - br)) * w;
// dxx = (-(mid - 3 * side)) * w and dyy likewise; r = dxx * dyy -
// 0.81 * (dxy * dxy), the Python scalars rounded to float32 as PyTorch
// rounds them; the maximum propagates NaN as torch.maximum does), and the
// file is built with -fmad=false, so the response equals the plain version
// on the card bit for bit for the same integral image.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstring>

namespace {

constexpr int kTile = 64;                       // output tile side
constexpr int kHalo = 45;                       // staged reach on each side
constexpr int kPitch = kTile + 2 * kHalo;       // staged row, in floats
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTile;      // rows between a thread's pixels
constexpr int kPixels = kTile / kRowStep;       // pixels a thread
constexpr int kGroup = 8;                       // pixels walking the scales together
constexpr int kScales = 16;                     // most scales a launch
constexpr size_t kShared = sizeof(float) * kPitch * kPitch;

struct Scale {
  int size, s2, s3, h3;  // int(3 sigma), (size - 1) // 2, size // 3, s3 // 2
  int staged;            // every corner within the staged halo
  float w;               // float32(1 / size^2)
};

struct Params {
  const float* ii;  // (N, H, W) integral images
  float* out;       // (N, H, W) responses
  int H, W, tiles_x, tiles, n_scales;
  Scale sc[kScales];
};

// torch.maximum on CUDA: a NaN on either side (the first's first), else ::max
__device__ __forceinline__ float torch_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// img[p + r0 : p + r0 + rl, q + c0 : q + c0 + cl] summed from four corners
template <class At>
__device__ __forceinline__ float box(const At& at, int r0, int c0, int rl,
                                     int cl) {
  const int r1 = r0 - 1, c1 = c0 - 1, r2 = r0 + rl - 1, c2 = c0 + cl - 1;
  return ((at(r2, c2) - at(r1, c2)) - at(r2, c1)) + at(r1, c1);
}

// keypoints2d_reference's hessian_det_appx at one pixel
template <class At>
__device__ __forceinline__ float hessian_det(const At& at, const Scale& s) {
  const int s2 = s.s2, s3 = s.s3, h3 = s.h3, size = s.size;
  const float three = static_cast<float>(3.0);
  const float k081 = static_cast<float>(0.81);
  const float tl = box(at, -s3, -s3, s3, s3);
  const float br = box(at, 1, 1, s3, s3);
  const float bl = box(at, 1, -s3, s3, s3);
  const float tr = box(at, -s3, 1, s3, s3);
  const float dxy = (-(((bl + tr) - tl) - br)) * s.w;
  float mid = box(at, -s3 + 1, -s2, 2 * s3 - 1, size);
  float side = box(at, -s3 + 1, -h3, 2 * s3 - 1, s3);
  const float dxx = (-(mid - three * side)) * s.w;
  mid = box(at, -s2, -s3 + 1, size, 2 * s3 - 1);
  side = box(at, -h3, -s3 + 1, s3, 2 * s3 - 1);
  const float dyy = (-(mid - three * side)) * s.w;
  return dxx * dyy - k081 * (dxy * dxy);
}

__global__ void __launch_bounds__(kThreads, 2)
    keypoints2d_kernel(const __grid_constant__ Params p) {
  extern __shared__ float staged[];
  const int n = blockIdx.x / p.tiles;
  const int t = blockIdx.x - n * p.tiles;
  const int y0 = t / p.tiles_x * kTile, x0 = t % p.tiles_x * kTile;
  const int H = p.H, W = p.W;
  const size_t plane = (size_t)H * W;
  const float* img = p.ii + n * plane;
  float* out = p.out + n * plane;

  // the tile and its halo: 0 before the image, the edge's value after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < kPitch; rr += kThreads / 32) {
    const int r = y0 - kHalo + rr;
    const float* row = img + (size_t)min(max(r, 0), H - 1) * W;
    for (int cc = lane; cc < kPitch; cc += 32) {
      const int c = x0 - kHalo + cc;
      staged[rr * kPitch + cc] =
          (r < 0 || c < 0) ? 0.0f : __ldg(row + min(c, W - 1));
    }
  }
  __syncthreads();

  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int q = x0 + lx;
  const float* s0 = staged + (ly + kHalo) * kPitch + lx + kHalo;
  // kGroup pixels at a time walk every scale: their maxima stay in registers
  for (int g = 0; g < kPixels; g += kGroup) {
    float resp[kGroup];
    for (int k = 0; k < p.n_scales; ++k) {
      const Scale sc = p.sc[k];
      const bool first = k == 0;
      if (sc.staged) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float* s = s0 + (g + j) * kRowStep * kPitch;
          const float r = hessian_det(
              [s](int dr, int dc) { return s[dr * kPitch + dc]; }, sc);
          resp[j] = first ? r : torch_maximum(resp[j], r);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int py = y0 + ly + (g + j) * kRowStep;
          const float r = hessian_det(
              [=](int dr, int dc) {
                const int rr = py + dr, cc = q + dc;
                return (rr < 0 || cc < 0)
                           ? 0.0f
                           : __ldg(img + (size_t)min(rr, H - 1) * W +
                                   min(cc, W - 1));
              },
              sc);
          resp[j] = first ? r : torch_maximum(resp[j], r);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int py = y0 + ly + (g + j) * kRowStep;
      if (py < H && q < W) out[(size_t)py * W + q] = resp[j];
    }
  }
}

}  // namespace

// ii, out: (N, H, W) float32, contiguous, on the current device. scales:
// host int32 rows of (size, s2, s3, s3 // 2, reach, float32 bits of
// 1 / size^2), one a sigma in order; reach is the largest |offset| of any
// corner; at most kScales (the wrapper refuses more). Launches one kernel.
// Returns cudaGetLastError().
extern "C" int keypoints2d_launch(const float* ii, float* out,
                                  const int* scales, int N, int H, int W,
                                  int n_scales, void* stream) {
  if (N < 1 || H < 1 || W < 1 || n_scales < 1 || n_scales > kScales) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_x = W / kTile + (W % kTile != 0);
  const int tiles_y = H / kTile + (H % kTile != 0);
  if ((long long)tiles_x * tiles_y * N > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      keypoints2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kShared);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper reports it
    return (int)err;
  }
  Params p{};
  p.ii = ii;
  p.out = out;
  p.H = H;
  p.W = W;
  p.tiles_x = tiles_x;
  p.tiles = tiles_x * tiles_y;
  p.n_scales = n_scales;
  for (int k = 0; k < n_scales; ++k) {
    const int* row = scales + 6 * k;
    float w;
    memcpy(&w, row + 5, sizeof w);
    p.sc[k] = Scale{row[0], row[1], row[2], row[3], row[4] <= kHalo, w};
  }
  keypoints2d_kernel<<<p.tiles * N, kThreads, kShared,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
