// NARF interest image for 3D keypoints (keypoints3d) — multi-scale.
//
// Native C++ counterpart of the reference's PCL-based NARF binary
// (omnidata_annotator/scripts/narf_interest_image.cpp + pcl_narf.{h,hpp},
// itself a fork of PCL's NarfKeypoint). This is a fresh implementation of
// the published operator (Steder, Rusu, Konolige, Burgard: "Point Feature
// Extraction on 3D Range Scans Taking into Account Object Boundaries",
// ICRA 2011) written against the algorithm, not a copy of PCL code.
//
// Pipeline (matching pcl_narf.hpp:205-470 behavior):
//   1. planar range image from metric depth; unseen pixels -> far range
//      (setUnseenToMaxRange semantics)
//   2. recursive scale space: half-resolution range images (min-range 2x2
//      pooling) until the angular resolution reaches ~2 deg/px
//      (calculateScaleSpace, pcl_narf.hpp:104-126)
//   3. per scale, a border extractor (PCL RangeImageBorderExtractor
//      algorithm): local-surface normals by PCA, 4-direction border
//      probability from range discontinuities vs the local point spacing,
//      obstacle/shadow border classification, surface-change score =
//      sqrt(lambda_max) of the neighborhood normal covariance (principal
//      direction = its eigenvector; borders score 1.0 with the border
//      direction), 3x3 blur
//   4. per scale, the NARF interest value: region growing over the metric
//      support radius, positive/negative scores with the optimal-distance
//      profile (nkdGetScores), 18-bin angle histogram of surface-change
//      directions in the viewer frame, pairwise angle-diversity product
//      (calculateCompleteInterestImage)
//   5. close points take their interest from the next-coarser scale via
//      bilinear interpolation (start_usage_ranges = support /
//      tan(optimal_patch_size * angular_resolution))
//
// Parameters fixed to the reference defaults (pcl_narf.h:76-83):
//   optimal_distance_to_high_surface_change = 0.25
//   min_surface_change_score = 0.2, optimal_range_image_patch_size = 10
//   minimum_border_probability = 0.8 (PCL border extractor default)
//
// Build:  g++ -O3 -shared -fPIC -o libnarf.so narf.cpp
// ABI  :  narf_interest_image(depth, H, W, fx, fy, cx, cy,
//                             support_size, max_range, out)
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <array>
#include <vector>

namespace {

constexpr float kFar = 1e30f;  // "unseen -> max range" sentinel
constexpr float kMinSurfaceChange = 0.2f;
constexpr float kOptimalDistance = 0.25f;
constexpr float kMinBorderProb = 0.8f;
constexpr int kOptimalPatchSize = 10;
constexpr int kAngleBins = 18;
constexpr int kBorderLookPx = 3;   // PCL pixel_radius_borders
constexpr int kSurfaceRadiusPx = 2;  // PCL pixel_radius_plane_extraction etc.

// Tunables exposed for calibration against the published interest images
// (narf_set_params); defaults are the PCL-faithful values.
struct Tunables {
  // calibrated against the published hm3d interest images (corr 0.62-0.68
  // per view with the reference's own sensitivity/FOV configuration)
  float jump_factor = 4.0f;    // spacing-estimate jump exclusion (x range*ar)
  float spacing_factor = 1.5f; // max_neighbor_distance = factor * spacing
  int max_levels = 99;         // pyramid depth cap (1 = single scale)
  int blur = 1;                // 3x3 surface-change blur on/off
  float min_change = kMinSurfaceChange;
};
Tunables g_tun;

struct Vec3 {
  float x = 0.f, y = 0.f, z = 0.f;
};
inline Vec3 operator-(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator+(const Vec3& a, const Vec3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator*(float s, const Vec3& a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(const Vec3& a) { return std::sqrt(dot(a, a)); }
inline Vec3 normalize(const Vec3& a) {
  float n = norm(a);
  if (n < 1e-12f) return {0.f, 0.f, 0.f};
  return {a.x / n, a.y / n, a.z / n};
}

// Largest-eigenvalue eigenpair of a symmetric 3x3 (power iteration with
// deterministic multi-seed start; plenty for blurred covariance inputs).
inline void eig3_max(const float C[6], float& lambda, Vec3& vec) {
  // C = [xx, xy, xz, yy, yz, zz]
  auto mul = [&](const Vec3& v) -> Vec3 {
    return {C[0] * v.x + C[1] * v.y + C[2] * v.z,
            C[1] * v.x + C[3] * v.y + C[4] * v.z,
            C[2] * v.x + C[4] * v.y + C[5] * v.z};
  };
  Vec3 best{1.f, 0.f, 0.f};
  float best_l = -1.f;
  const Vec3 seeds[3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  for (const Vec3& s : seeds) {
    Vec3 v = s;
    for (int it = 0; it < 24; ++it) {
      Vec3 w = mul(v);
      float n = norm(w);
      if (n < 1e-20f) break;
      v = {w.x / n, w.y / n, w.z / n};
    }
    float l = dot(v, mul(v));
    if (l > best_l) {
      best_l = l;
      best = v;
    }
  }
  lambda = std::max(0.f, best_l);
  vec = best;
}

// Smallest-eigenvalue eigenvector (surface normal from position covariance):
// deflate by shifting: B = tr(C)*I - C has the same eigenvectors with
// reversed order, so the largest of B is the smallest of C.
inline Vec3 eig3_min_vec(const float C[6]) {
  float tr = C[0] + C[3] + C[5];
  float B[6] = {tr - C[0], -C[1], -C[2], tr - C[3], -C[4], tr - C[5]};
  float l;
  Vec3 v;
  eig3_max(B, l, v);
  return v;
}

struct RangeLevel {
  int W = 0, H = 0;
  float fx = 1.f, fy = 1.f, cx = 0.f, cy = 0.f;
  float ar = 0.f;  // angular resolution (rad / pixel)
  std::vector<float> range;      // |point|; kFar for unseen
  std::vector<Vec3> pts;
  std::vector<unsigned char> valid;
  // border extractor products
  std::vector<unsigned char> shadow;    // shadow-border (skip everywhere)
  std::vector<unsigned char> obstacle;  // obstacle border
  std::vector<float> change;            // surface change score [0,1]
  std::vector<Vec3> change_dir;         // surface change direction
  std::vector<float> spacing2;          // max_neighbor_distance_squared

  int at(int y, int x) const { return y * W + x; }
  bool in(int y, int x) const { return y >= 0 && y < H && x >= 0 && x < W; }
};

void build_level0(const float* depth, int H, int W, float fx, float fy,
                  float cx, float cy, float max_range, RangeLevel& L) {
  L.W = W;
  L.H = H;
  L.fx = fx;
  L.fy = fy;
  L.cx = cx;
  L.cy = cy;
  L.ar = std::atan(1.0f / fx);
  L.range.assign(W * H, kFar);
  L.pts.assign(W * H, Vec3{});
  L.valid.assign(W * H, 0);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      float d = depth[i];
      if (d > 1e-6f && d < max_range) {
        float px = (static_cast<float>(x) - cx) / fx * d;
        float py = (static_cast<float>(y) - cy) / fy * d;
        L.pts[i] = {px, py, d};
        L.range[i] = std::sqrt(px * px + py * py + d * d);
        L.valid[i] = 1;
      }
    }
  }
}

// PCL RangeImage::getHalfImage: each target pixel takes the CLOSEST (min
// range) of its 2x2 source block; all-far blocks stay far.
void build_half(const RangeLevel& src, RangeLevel& dst) {
  dst.W = src.W / 2;
  dst.H = src.H / 2;
  dst.fx = src.fx * 0.5f;
  dst.fy = src.fy * 0.5f;
  dst.cx = src.cx * 0.5f;
  dst.cy = src.cy * 0.5f;
  dst.ar = src.ar * 2.0f;
  int N = dst.W * dst.H;
  dst.range.assign(N, kFar);
  dst.pts.assign(N, Vec3{});
  dst.valid.assign(N, 0);
  for (int y = 0; y < dst.H; ++y) {
    for (int x = 0; x < dst.W; ++x) {
      int best = -1;
      float best_r = kFar;
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          int sy = 2 * y + dy, sx = 2 * x + dx;
          if (sy >= src.H || sx >= src.W) continue;
          int si = src.at(sy, sx);
          if (src.valid[si] && src.range[si] < best_r) {
            best_r = src.range[si];
            best = si;
          }
        }
      }
      int di = dst.at(y, x);
      if (best >= 0) {
        dst.range[di] = src.range[best];
        dst.pts[di] = src.pts[best];
        dst.valid[di] = 1;
      }
    }
  }
}

// Average of up to `radius` consecutive valid points along (dx,dy) starting
// one step away (PCL get1dPointAverage). Returns false if none valid; far
// pixels report far=true.
bool point_average_1d(const RangeLevel& L, int x, int y, int dx, int dy,
                      int radius, Vec3& avg, bool& far) {
  far = false;
  int n = 0;
  Vec3 acc{};
  for (int i = 1; i <= radius; ++i) {
    int xn = x + i * dx, yn = y + i * dy;
    if (!L.in(yn, xn)) break;
    int j = L.at(yn, xn);
    if (!L.valid[j]) {
      if (L.range[j] >= kFar * 0.5f) far = true;  // unseen -> far background
      break;
    }
    acc = acc + L.pts[j];
    ++n;
  }
  if (n == 0) return false;
  avg = (1.0f / static_cast<float>(n)) * acc;
  return true;
}

// The border extractor: normals, border probabilities, obstacle/shadow
// classification, surface change scores/directions, 3x3 blur.
void extract_borders(RangeLevel& L) {
  const int W = L.W, H = L.H, N = W * H;
  std::vector<Vec3> normal(N, Vec3{});
  std::vector<unsigned char> has_normal(N, 0);
  L.spacing2.assign(N, 0.f);
  L.shadow.assign(N, 0);
  L.obstacle.assign(N, 0);
  L.change.assign(N, 0.f);
  L.change_dir.assign(N, Vec3{});

  // --- local surface: typical spacing + PCA normal over non-jump nbrs ---
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = L.at(y, x);
      if (!L.valid[i]) continue;
      const Vec3 p = L.pts[i];
      // typical point spacing: average 3D distance to valid direct nbrs;
      // fallback to the projected pixel footprint range*ar
      float acc = 0.f;
      int cnt = 0;
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (!dx && !dy) continue;
          if (!L.in(y + dy, x + dx)) continue;
          int j = L.at(y + dy, x + dx);
          if (!L.valid[j]) continue;
          float d = norm(L.pts[j] - p);
          if (d < g_tun.jump_factor * L.range[i] * L.ar) {  // ignore jumps
            acc += d;
            ++cnt;
          }
        }
      }
      float spacing = cnt ? acc / static_cast<float>(cnt) : L.range[i] * L.ar;
      float max_nb = g_tun.spacing_factor * std::max(spacing, L.range[i] * L.ar);
      L.spacing2[i] = max_nb * max_nb;

      // PCA over neighbors within the surface radius, excluding jumps
      float mean[3] = {0, 0, 0};
      float cov[6] = {0, 0, 0, 0, 0, 0};
      int n = 0;
      for (int dy = -kSurfaceRadiusPx; dy <= kSurfaceRadiusPx; ++dy) {
        for (int dx = -kSurfaceRadiusPx; dx <= kSurfaceRadiusPx; ++dx) {
          if (!L.in(y + dy, x + dx)) continue;
          int j = L.at(y + dy, x + dx);
          if (!L.valid[j]) continue;
          Vec3 q = L.pts[j] - p;
          if (dot(q, q) > 4.0f * L.spacing2[i]) continue;  // jump
          mean[0] += q.x;
          mean[1] += q.y;
          mean[2] += q.z;
          cov[0] += q.x * q.x;
          cov[1] += q.x * q.y;
          cov[2] += q.x * q.z;
          cov[3] += q.y * q.y;
          cov[4] += q.y * q.z;
          cov[5] += q.z * q.z;
          ++n;
        }
      }
      if (n >= 3) {
        float inv = 1.0f / static_cast<float>(n);
        for (int k = 0; k < 3; ++k) mean[k] *= inv;
        float C[6] = {cov[0] * inv - mean[0] * mean[0],
                      cov[1] * inv - mean[0] * mean[1],
                      cov[2] * inv - mean[0] * mean[2],
                      cov[3] * inv - mean[1] * mean[1],
                      cov[4] * inv - mean[1] * mean[2],
                      cov[5] * inv - mean[2] * mean[2]};
        Vec3 nrm = eig3_min_vec(C);
        if (dot(nrm, p) > 0) nrm = -1.0f * nrm;  // orient toward sensor
        normal[i] = nrm;
        has_normal[i] = 1;
      }
    }
  }

  // --- 4-direction border probability + obstacle/shadow classification ---
  const int DX[4] = {-1, 1, 0, 0};
  const int DY[4] = {0, 0, -1, 1};
  std::vector<float> bscore(4 * N, 0.f);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = L.at(y, x);
      if (!L.valid[i]) continue;
      const Vec3 p = L.pts[i];
      for (int d = 0; d < 4; ++d) {
        Vec3 nb;
        bool far = false;
        if (!point_average_1d(L, x, y, DX[d], DY[d], kBorderLookPx, nb, far)) {
          bscore[d * N + i] = far ? 1.0f : 0.0f;  // disappearing background
          continue;
        }
        Vec3 q = nb - p;
        float d2 = dot(q, q);
        if (d2 <= L.spacing2[i]) continue;
        float s = 1.0f - std::sqrt(L.spacing2[i] / d2);
        if (norm(nb) < L.range[i]) s = -s;  // neighbor closer: not our border
        bscore[d * N + i] = s;
      }
    }
  }
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = L.at(y, x);
      if (!L.valid[i]) continue;
      for (int d = 0; d < 4; ++d) {
        float s = bscore[d * N + i];
        if (s < kMinBorderProb) continue;
        // local maximum along the direction (checkPotentialBorder)
        bool is_max = true;
        for (int k = 1; k <= 2 && is_max; ++k) {
          int xn = x + k * DX[d], yn = y + k * DY[d];
          if (!L.in(yn, xn)) break;
          if (bscore[d * N + L.at(yn, xn)] > s) is_max = false;
        }
        if (!is_max) continue;
        L.obstacle[i] = 1;
        // the background side of the jump becomes a shadow border
        int xs = x + DX[d], ys = y + DY[d];
        if (L.in(ys, xs)) {
          int j = L.at(ys, xs);
          if (L.valid[j] && L.range[j] > L.range[i]) L.shadow[j] = 1;
        }
      }
    }
  }

  // --- surface change scores + directions ---
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = L.at(y, x);
      if (!L.valid[i] || L.shadow[i]) continue;
      if (L.obstacle[i]) {
        // borders are maximal changes; direction = across the border,
        // PROJECTED onto the local surface tangent plane — the raw
        // foreground->background vector is dominated by the along-ray depth
        // jump, which would make the direction angle noise (PCL projects
        // border directions into the surface plane for the same reason)
        Vec3 acc{};
        for (int d = 0; d < 4; ++d) {
          float s = bscore[d * N + i];
          if (s < kMinBorderProb) continue;
          Vec3 nb;
          bool far = false;
          if (point_average_1d(L, x, y, DX[d], DY[d], kBorderLookPx, nb, far))
            acc = acc + s * normalize(nb - L.pts[i]);
          else if (far)  // borders against unseen: use the view ray
            acc = acc + s * normalize(L.pts[i]);
        }
        if (has_normal[i]) {
          const Vec3& nrm = normal[i];
          acc = acc - dot(acc, nrm) * nrm;
        }
        L.change[i] = 1.0f;
        L.change_dir[i] = normalize(acc);
        continue;
      }
      // normal-covariance PCA (calculateMainPrincipalCurvature). Neighbors
      // are gathered along 8 beams that STOP at shadow borders — without
      // this, pixels next to an edge mix normals from both sides of the
      // depth jump and the whole support-radius band lights up (PCL's
      // beams_valid logic).
      float mean[3] = {0, 0, 0};
      float cov[6] = {0, 0, 0, 0, 0, 0};
      int n = 0;
      for (int by = -1; by <= 1; ++by) {
        for (int bx = -1; bx <= 1; ++bx) {
          if (!bx && !by) continue;
          for (int step = 1; step <= kSurfaceRadiusPx; ++step) {
            int xn = x + step * bx, yn = y + step * by;
            if (!L.in(yn, xn)) break;
            int j = L.at(yn, xn);
            if (L.shadow[j]) break;  // beam blocked at the border
            if (!L.valid[j] || !has_normal[j]) continue;
            const Vec3& v = normal[j];
            mean[0] += v.x;
            mean[1] += v.y;
            mean[2] += v.z;
            cov[0] += v.x * v.x;
            cov[1] += v.x * v.y;
            cov[2] += v.x * v.z;
            cov[3] += v.y * v.y;
            cov[4] += v.y * v.z;
            cov[5] += v.z * v.z;
            ++n;
          }
        }
      }
      if (n < 3) continue;
      float inv = 1.0f / static_cast<float>(n);
      for (int k = 0; k < 3; ++k) mean[k] *= inv;
      float C[6] = {cov[0] * inv - mean[0] * mean[0],
                    cov[1] * inv - mean[0] * mean[1],
                    cov[2] * inv - mean[0] * mean[2],
                    cov[3] * inv - mean[1] * mean[1],
                    cov[4] * inv - mean[1] * mean[2],
                    cov[5] * inv - mean[2] * mean[2]};
      float lambda;
      Vec3 dir;
      eig3_max(C, lambda, dir);
      L.change[i] = std::min(1.0f, std::sqrt(lambda));
      L.change_dir[i] = dir;
    }
  }

  // --- 3x3 blur of scores + wider direction smoothing ---
  // (blurSurfaceChanges). Directions smooth over a radius-2 window,
  // score-weighted and sign-aligned (directions are mod-180): along a
  // straight edge the border and crease directions must collapse into ONE
  // histogram bin or quantization jitter fakes corner diversity.
  if (!g_tun.blur) return;
  std::vector<float> bs(N, 0.f);
  std::vector<Vec3> bd(N, Vec3{});
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = L.at(y, x);
      if (!L.valid[i] || L.shadow[i]) continue;
      float acc = 0.f;
      int cnt = 0;
      const Vec3 ref = L.change_dir[i];
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (!L.in(y + dy, x + dx)) continue;
          int j = L.at(y + dy, x + dx);
          if (!L.valid[j] || L.shadow[j]) continue;
          acc += L.change[j];
          ++cnt;
        }
      }
      bs[i] = cnt ? acc / static_cast<float>(cnt) : 0.f;
      Vec3 dacc{};
      for (int dy = -2; dy <= 2; ++dy) {
        for (int dx = -2; dx <= 2; ++dx) {
          if (!L.in(y + dy, x + dx)) continue;
          int j = L.at(y + dy, x + dx);
          if (!L.valid[j] || L.shadow[j]) continue;
          Vec3 v = L.change_dir[j];
          if (dot(v, ref) < 0) v = -1.0f * v;
          dacc = dacc + L.change[j] * v;
        }
      }
      bd[i] = normalize(dacc);
    }
  }
  L.change.swap(bs);
  L.change_dir.swap(bd);
}

// Viewer coordinate frame at a point (nkdGetDirectionAngle): z along the
// view ray, y aligned with the sensor's "down". Hoisted out of the
// per-region-pixel scoring loop — the frame depends only on the SEED.
inline void viewer_frame(const Vec3& point, Vec3& ex, Vec3& ey) {
  Vec3 ez = normalize(point);
  ex = cross(Vec3{0.f, -1.f, 0.f}, ez);
  float n = norm(ex);
  if (n < 1e-6f) ex = Vec3{1.f, 0.f, 0.f};
  else ex = (1.0f / n) * ex;
  ey = cross(ez, ex);
}

inline float direction_angle_in(const Vec3& ex, const Vec3& ey,
                                const Vec3& dir) {
  float rx = dot(ex, dir), ry = dot(ey, dir);
  float len = std::sqrt(rx * rx + ry * ry);
  if (len < 1e-12f) return 0.f;
  rx /= len;
  // 0.5 * normAngle(2 * acos(rx)) folds the direction to a line in
  // [-pi/2, pi/2]
  float a = 2.0f * std::acos(std::max(-1.f, std::min(1.f, rx)));
  while (a > static_cast<float>(M_PI)) a -= 2.0f * static_cast<float>(M_PI);
  while (a < -static_cast<float>(M_PI)) a += 2.0f * static_cast<float>(M_PI);
  return 0.5f * a;
}

inline float direction_angle(const Vec3& point, const Vec3& dir) {
  Vec3 ex, ey;
  viewer_frame(point, ex, ey);
  return direction_angle_in(ex, ey, dir);
}

// The per-scale interest image (calculateCompleteInterestImage inner loop).
void interest_level(const RangeLevel& L, float support_size,
                    const RangeLevel* coarser, const float* coarser_interest,
                    float start_usage_range, float* interest) {
  const int W = L.W, H = L.H, N = W * H;
  const float radius = 0.5f * support_size;
  const float radius2 = radius * radius;
  std::vector<unsigned char> touched(N, 0);
  std::vector<int> visited;
  visited.reserve(4096);
  std::vector<std::array<int, 3>> spans;  // candidate (x0, x1, y) ranges
  spans.reserve(512);
  float hist[kAngleBins];

  // Integral image of (change >= min_change): a seed whose whole reachable
  // support window contains no qualifying pixel scores an EMPTY histogram
  // -> interest = neg * sqrt(0) = 0, so its region growing can be skipped
  // outright. The window bound: scored pixels satisfy |p_j - p_i| <=
  // radius, i.e. angular separation <= asin(radius / range_i); in pixels
  // that is <= (radius / (range_i - radius)) / ar at the image center and
  // up to sec^2(corner) more off-axis — doubled again for margin (a
  // too-large window only costs a wasted BFS, never a wrong skip).
  std::vector<int> integ((H + 1) * (W + 1), 0);
  for (int y = 0; y < H; ++y) {
    int rowsum = 0;
    for (int x = 0; x < W; ++x) {
      rowsum += (L.change[y * W + x] >= g_tun.min_change);
      integ[(y + 1) * (W + 1) + x + 1] = integ[y * (W + 1) + x + 1] + rowsum;
    }
  }
  auto window_has_change = [&](int y, int x, int r) {
    int y0 = std::max(0, y - r), x0 = std::max(0, x - r);
    int y1 = std::min(H - 1, y + r), x1 = std::min(W - 1, x + r);
    return (integ[(y1 + 1) * (W + 1) + x1 + 1] - integ[y0 * (W + 1) + x1 + 1]
            - integ[(y1 + 1) * (W + 1) + x0] + integ[y0 * (W + 1) + x0]) > 0;
  };
  const float half_w = 0.5f * static_cast<float>(W);
  const float half_h = 0.5f * static_cast<float>(H);
  const float sec2_corner =
      1.0f + (half_w * half_w + half_h * half_h) * L.ar * L.ar;
  long n_bilinear = 0, n_skip = 0, n_bfs = 0, bfs_px = 0;  // NARF_PROFILE

  for (int i = 0; i < N; ++i) {
    interest[i] = 0.f;
    if (!L.valid[i] || L.shadow[i]) continue;
    int y = i / W, x = i - y * W;

    if (coarser && L.range[i] < start_usage_range) {
      // close point: bilinear from the half-resolution interest image
      float fx2 = 0.5f * static_cast<float>(x);
      float fy2 = 0.5f * static_cast<float>(y);
      int x0 = std::min(static_cast<int>(fx2), coarser->W - 1);
      int y0 = std::min(static_cast<int>(fy2), coarser->H - 1);
      int x1 = std::min(x0 + 1, coarser->W - 1);
      int y1 = std::min(y0 + 1, coarser->H - 1);
      float tx = fx2 - static_cast<float>(x0);
      float ty = fy2 - static_cast<float>(y0);
      float v00 = coarser_interest[y0 * coarser->W + x0];
      float v01 = coarser_interest[y0 * coarser->W + x1];
      float v10 = coarser_interest[y1 * coarser->W + x0];
      float v11 = coarser_interest[y1 * coarser->W + x1];
      interest[i] = (1 - ty) * ((1 - tx) * v00 + tx * v01) +
                    ty * ((1 - tx) * v10 + tx * v11);
      ++n_bilinear;
      continue;
    }

    // provably-empty-histogram skip (see integral image above)
    float denom = std::max(L.range[i] - radius, 1e-3f);
    int px_r = static_cast<int>(std::ceil(
                   2.0f * (radius / denom) / L.ar * sec2_corner)) + 3;
    if (!window_has_change(y, x, px_r)) { ++n_skip; continue; }
    ++n_bfs;

    const Vec3 p = L.pts[i];
    Vec3 fex, fey;
    viewer_frame(p, fex, fey);
    std::fill(hist, hist + kAngleBins, 0.f);
    float negative_score = 1.0f;

    // Span-based flood fill of the SAME region the old per-pixel BFS grew:
    // the 8-connected component (through valid, non-shadow pixels) of
    //   P(j) = px_dist(i,j) <= 2  OR  |pts[j] - pts[i]|^2 <= radius^2
    // containing the seed. Scores fold only through max (histogram) and
    // min (negative_score), so traversal order is irrelevant — results are
    // bit-identical to the BFS — while spans pay ONE predicate eval + one
    // touched byte per region pixel instead of 9 neighbor probes
    // (~2x measured on the L0/L1 hot levels).
    auto inreg = [&](int yy, int xx) -> bool {
      int j = yy * W + xx;
      if (!L.valid[j] || L.shadow[j]) return false;
      if (std::max(std::abs(xx - x), std::abs(yy - y)) <= 2) return true;
      Vec3 q = L.pts[j] - p;
      return dot(q, q) <= radius2;
    };
    auto score = [&](int yy, int xx) {
      int j = yy * W + xx;
      float s = L.change[j];
      if (s < g_tun.min_change) return;
      float px_dist = static_cast<float>(
          std::max(std::abs(xx - x), std::abs(yy - y)));
      Vec3 q = L.pts[j] - p;
      float dist_factor = std::sqrt(dot(q, q)) / radius;
      // nkdGetScores
      float neg = 1.0f - 0.5f * s * std::max(1.0f - dist_factor / kOptimalDistance, 0.0f);
      neg = neg * neg;
      float pos = (px_dist < 2.0f) ? s : s * (1.0f - dist_factor);
      float angle = direction_angle_in(fex, fey, L.change_dir[j]);
      int cell = std::min(
          kAngleBins - 1,
          static_cast<int>(std::floor((angle + 0.5f * static_cast<float>(M_PI)) /
                                      static_cast<float>(M_PI) * kAngleBins)));
      cell = std::max(0, cell);
      hist[cell] = std::max(hist[cell], pos);
      negative_score = std::min(negative_score, neg);
    };
    auto fill_run = [&](int yy, int xx) {
      // expand the maximal untouched in-region run through (yy, xx); mark,
      // score, and enqueue the 1-px-widened ranges of both adjacent rows
      int lx = xx, rx = xx;
      int row = yy * W;
      while (lx > 0 && !touched[row + lx - 1] && inreg(yy, lx - 1)) --lx;
      while (rx < W - 1 && !touched[row + rx + 1] && inreg(yy, rx + 1)) ++rx;
      for (int x4 = lx; x4 <= rx; ++x4) {
        touched[row + x4] = 1;
        visited.push_back(row + x4);
        score(yy, x4);
      }
      if (yy > 0) spans.push_back({lx - 1, rx + 1, yy - 1});
      if (yy < H - 1) spans.push_back({lx - 1, rx + 1, yy + 1});
      return rx;
    };
    visited.clear();
    spans.clear();
    fill_run(y, x);  // seed run (P(seed) always holds: px_dist = 0)
    while (!spans.empty()) {
      auto [a, b, yy] = spans.back();
      spans.pop_back();
      int xb = std::min(W - 1, b);
      for (int xx = std::max(0, a); xx <= xb; ++xx) {
        if (!touched[yy * W + xx] && inreg(yy, xx)) xx = fill_run(yy, xx);
      }
    }
    bfs_px += static_cast<long>(visited.size());
    for (int j : visited) touched[j] = 0;

    float angle_change = 0.f;
    for (int c1 = 0; c1 < kAngleBins - 1; ++c1) {
      if (hist[c1] == 0.f) continue;
      for (int c2 = c1 + 1; c2 < kAngleBins; ++c2) {
        if (hist[c2] == 0.f) continue;
        float nd = 2.0f * static_cast<float>(c2 - c1) / static_cast<float>(kAngleBins);
        nd = nd <= 1.0f ? nd : 2.0f - nd;
        angle_change = std::max(angle_change, hist[c1] * hist[c2] * nd);
      }
    }
    interest[i] = negative_score * std::sqrt(angle_change);
  }
  if (std::getenv("NARF_PROFILE")) {
    std::fprintf(stderr,
                 "[narf]   level %dx%d: bilinear %ld skip %ld bfs %ld "
                 "(avg frontier %.1f)\n",
                 W, H, n_bilinear, n_skip, n_bfs,
                 n_bfs ? static_cast<double>(bfs_px) / n_bfs : 0.0);
  }
}

// Stages 4+5 (start_usage ranges, per-scale interest, coarse-to-fine
// combination, clip) given fully-populated levels.
void run_interest(std::vector<RangeLevel>& levels, float support_size,
                  float* out, bool prof = false) {
  auto tick = std::chrono::steady_clock::now();
  int S = static_cast<int>(levels.size());
  std::vector<float> start_usage(S, 0.0f);
  for (int s = S - 2; s >= 0; --s) {
    start_usage[s] = support_size /
        std::tan(static_cast<float>(kOptimalPatchSize) * levels[s + 1].ar);
  }
  std::vector<std::vector<float>> interest(S);
  for (int s = S - 1; s >= 0; --s) {
    interest[s].resize(levels[s].W * levels[s].H);
    const RangeLevel* coarser = (s + 1 < S) ? &levels[s + 1] : nullptr;
    const float* ci = (s + 1 < S) ? interest[s + 1].data() : nullptr;
    interest_level(levels[s], support_size, coarser, ci, start_usage[s],
                   interest[s].data());
    if (prof) {
      auto now = std::chrono::steady_clock::now();
      std::fprintf(stderr, "[narf] interest L%d      %.1f ms\n", s,
                   std::chrono::duration<double, std::milli>(now - tick)
                       .count());
      tick = now;
    }
  }
  int N = levels[0].W * levels[0].H;
  for (int i = 0; i < N; ++i)
    out[i] = std::max(0.0f, std::min(1.0f, interest[0][i]));
}

void build_pyramid(const float* depth, int H, int W, float fx, float fy,
                   float cx, float cy, float max_range,
                   std::vector<RangeLevel>& levels) {
  levels.resize(1);
  build_level0(depth, H, W, fx, fy, cx, cy, max_range, levels[0]);
  const float deg2 = 2.0f * static_cast<float>(M_PI) / 180.0f;
  while (0.5f * levels.back().ar < deg2 && levels.back().W >= 16 &&
         levels.back().H >= 16 &&
         static_cast<int>(levels.size()) < g_tun.max_levels) {
    levels.emplace_back();
    build_half(levels[levels.size() - 2], levels.back());
  }
}

}  // namespace

extern "C" {

// depth: H*W metric depths (<=0 or >=max_range treated as unseen).
// out:   H*W interest values in [0, 1].
void narf_interest_image(const float* depth, int H, int W, float fx, float fy,
                         float cx, float cy, float support_size,
                         float max_range, float* out) {
  // NARF_PROFILE=1: per-stage wall times on stderr (perf work only)
  const bool prof = std::getenv("NARF_PROFILE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[narf] %-16s %.1f ms\n", name,
                 std::chrono::duration<double, std::milli>(now - tick).count());
    tick = now;
  };
  // 1+2. range image pyramid
  std::vector<RangeLevel> levels;
  build_pyramid(depth, H, W, fx, fy, cx, cy, max_range, levels);
  lap("pyramid");

  // 3. border extraction per scale
  for (RangeLevel& L : levels) extract_borders(L);
  lap("borders");

  // 4+5. interest images, coarse to fine
  run_interest(levels, support_size, out, prof);
}

// Split-pipeline entry: border maps (change score / change direction /
// shadow flags) computed OFF-host — on the TPU by cues/narf_device.py, the
// convolution-shaped 74% of the operator — with only the data-dependent
// region-growing interest stage (stages 4+5) left here. Maps arrive
// transfer-quantized (u16 score, i8 direction, u8 shadow), concatenated
// level-major in this file's own pyramid order.
//
// Returns 0 on success, or the expected level count when n_levels does not
// match this pyramid's depth (caller should fall back to the full path).
int narf_interest_image_from_maps(
    const float* depth, int H, int W, float fx, float fy, float cx, float cy,
    float support_size, float max_range, int n_levels,
    const unsigned short* change_q, const signed char* cdir_q,
    const unsigned char* shadow_q, float* out) {
  std::vector<RangeLevel> levels;
  build_pyramid(depth, H, W, fx, fy, cx, cy, max_range, levels);
  if (static_cast<int>(levels.size()) != n_levels)
    return static_cast<int>(levels.size());
  size_t off = 0;
  for (RangeLevel& L : levels) {
    const size_t N = static_cast<size_t>(L.W) * L.H;
    L.change.resize(N);
    L.change_dir.resize(N);
    L.shadow.resize(N);
    for (size_t i = 0; i < N; ++i) {
      L.change[i] = change_q[off + i] * (1.0f / 65535.0f);
      L.change_dir[i] = {cdir_q[3 * (off + i)] * (1.0f / 127.0f),
                         cdir_q[3 * (off + i) + 1] * (1.0f / 127.0f),
                         cdir_q[3 * (off + i) + 2] * (1.0f / 127.0f)};
      L.shadow[i] = shadow_q[off + i];
    }
    off += N;
  }
  run_interest(levels, support_size, out,
               std::getenv("NARF_PROFILE") != nullptr);
  return 0;
}

// Calibration knobs (see Tunables); pass a negative value to keep a field.
void narf_set_params(float jump_factor, float spacing_factor, int max_levels,
                     int blur, float min_change) {
  if (jump_factor > 0) g_tun.jump_factor = jump_factor;
  if (spacing_factor > 0) g_tun.spacing_factor = spacing_factor;
  if (max_levels > 0) g_tun.max_levels = max_levels;
  if (blur >= 0) g_tun.blur = blur;
  if (min_change > 0) g_tun.min_change = min_change;
}

// Debug introspection: intermediate maps of a chosen pyramid level, resized
// nearest to the full resolution. which: 0=change score, 1=obstacle,
// 2=shadow, 3=raw per-level interest (no coarse interpolation),
// 4=direction angle (viewer frame, [-pi/2,pi/2]; -2 where undefined).
void narf_debug_map(const float* depth, int H, int W, float fx, float fy,
                    float cx, float cy, float support_size, float max_range,
                    int level, int which, float* out) {
  std::vector<RangeLevel> levels(1);
  build_level0(depth, H, W, fx, fy, cx, cy, max_range, levels[0]);
  const float deg2 = 2.0f * static_cast<float>(M_PI) / 180.0f;
  // honor the same pyramid-depth cap as narf_interest_image, so debug maps
  // describe the production scale space after narf_set_params
  while (0.5f * levels.back().ar < deg2 && levels.back().W >= 16 &&
         levels.back().H >= 16 &&
         static_cast<int>(levels.size()) < g_tun.max_levels) {
    levels.emplace_back();
    build_half(levels[levels.size() - 2], levels.back());
  }
  level = std::min(level, static_cast<int>(levels.size()) - 1);
  for (int s = 0; s <= level; ++s) extract_borders(levels[s]);
  RangeLevel& L = levels[level];
  std::vector<float> tmp(L.W * L.H, 0.f);
  if (which == 3) {
    interest_level(L, support_size, nullptr, nullptr, 0.f, tmp.data());
  } else {
    for (int i = 0; i < L.W * L.H; ++i) {
      if (which == 0) tmp[i] = L.change[i];
      else if (which == 1) tmp[i] = L.obstacle[i];
      else if (which == 2) tmp[i] = L.shadow[i];
      else if (which == 4) {
        tmp[i] = (L.change[i] > 0.f && L.valid[i])
                     ? direction_angle(L.pts[i], L.change_dir[i]) : -2.0f;
      }
    }
  }
  int scale = 1 << level;
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      int ys = std::min(y / scale, L.H - 1), xs = std::min(x / scale, L.W - 1);
      out[y * W + x] = tmp[ys * L.W + xs];
    }
}

}  // extern "C"
