// Felzenszwalb-Huttenlocher graph segmentation — native core for the
// host-side segmentation cues (cues/segmentation.py). Same role as the
// reference's compiled skimage _felzenszwalb_cython (the Python Kruskal
// loop costs ~7 s per 512^2 image; this runs in ~0.1 s).
//
// Semantics are IDENTICAL to the Python fallback in segmentation.py:
// 8-connected grid (right, down, down-right, up-right edge order), L2
// color costs, stable sort, tau(C) = last_cost + scale/|C| with w <= tau
// on both sides, then a small-component merge pass in the same edge order.
// Labels out are consecutive ints in first-seen order of component roots
// scanned row-major (matching np.unique(return_inverse=True) up to
// renumbering; callers treat labels as opaque ids).
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  // int32 throughout: N = H*W pixels always fits, and the find loops are
  // random-access — half-width nodes double the cache-resident set
  std::vector<int32_t> parent, size;
  explicit UnionFind(int32_t n) : parent(n), size(n, 1) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    // path halving: one pass, every other node re-pointed at its
    // grandparent — same roots (and therefore identical labels) as
    // two-pass full compression, with ~half the memory traffic
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  int32_t unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) return ra;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
    return ra;
  }
};

}  // namespace

extern "C" void felzenszwalb_segment(const double* img, int64_t H, int64_t W,
                                     int64_t C, double scale,
                                     int64_t min_size, int64_t* labels_out) {
  const bool prof = std::getenv("FELZ_PROFILE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[felz] %-8s %.1f ms\n", name,
                 std::chrono::duration<double, std::milli>(now - tick).count());
    tick = now;
  };
  const int64_t N = H * W;
  // edges in the exact order of the python builder: right, down,
  // down-right, up-right (each block row-major)
  const int64_t n_edges =
      H * (W - 1) + (H - 1) * W + (H - 1) * (W - 1) + (H - 1) * (W - 1);
  std::vector<int32_t> ea(n_edges), eb(n_edges);
  std::vector<double> cost(n_edges);
  int64_t k = 0;
  auto push = [&](int64_t a, int64_t b) {
    double d2 = 0.0;
    const double* pa = img + a * C;
    const double* pb = img + b * C;
    for (int64_t c = 0; c < C; ++c) {
      const double d = pa[c] - pb[c];
      d2 += d * d;
    }
    ea[k] = static_cast<int32_t>(a);
    eb[k] = static_cast<int32_t>(b);
    cost[k] = std::sqrt(d2);
    ++k;
  };
  for (int64_t i = 0; i < H; ++i)
    for (int64_t j = 0; j + 1 < W; ++j) push(i * W + j, i * W + j + 1);
  for (int64_t i = 0; i + 1 < H; ++i)
    for (int64_t j = 0; j < W; ++j) push(i * W + j, (i + 1) * W + j);
  for (int64_t i = 0; i + 1 < H; ++i)
    for (int64_t j = 0; j + 1 < W; ++j) push(i * W + j, (i + 1) * W + j + 1);
  for (int64_t i = 0; i + 1 < H; ++i)
    for (int64_t j = 0; j + 1 < W; ++j) push((i + 1) * W + j, i * W + j + 1);

  lap("edges");
  // LSD radix sort on FLOAT32-rounded cost keys: non-negative IEEE floats
  // order exactly as their u32 bit patterns, so two stable 16-bit counting
  // passes produce the stable-sort permutation of the f32-rounded costs
  // (half the passes and half the key traffic of the previous u64/f64
  // sort). Costs within one f32 ulp of each other (~2^-24 relative —
  // far below any perceptual difference in a [0,255]-scale color metric)
  // collapse into ties broken by insertion order; the Python fallback
  // applies the same f32 rounding before its stable argsort, so labels
  // stay identical between the two implementations. The merge threshold
  // math still uses the full f64 cost.
  std::vector<int32_t> order(n_edges), order_tmp(n_edges);
  std::vector<uint32_t> key(n_edges), key_tmp(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) {
    order[i] = static_cast<int32_t>(i);
    const float c32 = static_cast<float>(cost[i]);
    std::memcpy(&key[i], &c32, sizeof(uint32_t));
  }
  {
    std::vector<int32_t> count(1 << 16);
    for (int pass = 0; pass < 2; ++pass) {
      const int shift = 16 * pass;
      std::fill(count.begin(), count.end(), 0);
      for (int64_t i = 0; i < n_edges; ++i)
        ++count[(key[i] >> shift) & 0xFFFF];
      int32_t run = 0;
      for (int64_t d = 0; d < (1 << 16); ++d) {
        int32_t c = count[d];
        count[d] = run;
        run += c;
      }
      for (int64_t i = 0; i < n_edges; ++i) {
        const int32_t dst = count[(key[i] >> shift) & 0xFFFF]++;
        key_tmp[dst] = key[i];
        order_tmp[dst] = order[i];
      }
      key.swap(key_tmp);
      order.swap(order_tmp);
    }
  }

  lap("radix");
  UnionFind uf(static_cast<int32_t>(N));
  std::vector<double> thresh(N, scale);
  for (int64_t oi = 0; oi < n_edges; ++oi) {
    const int32_t e = order[oi];
    const int32_t ra = uf.find(ea[e]);
    const int32_t rb = uf.find(eb[e]);
    if (ra == rb) continue;
    const double w = cost[e];
    if (w <= thresh[ra] && w <= thresh[rb]) {
      const int32_t r = uf.unite(ra, rb);
      thresh[r] = w + scale / static_cast<double>(uf.size[r]);
    }
  }
  for (int64_t oi = 0; oi < n_edges; ++oi) {
    const int32_t e = order[oi];
    const int32_t ra = uf.find(ea[e]);
    const int32_t rb = uf.find(eb[e]);
    if (ra != rb && (uf.size[ra] < min_size || uf.size[rb] < min_size))
      uf.unite(ra, rb);
  }

  lap("kruskal");
  // consecutive labels keyed by sorted root id (np.unique semantics)
  std::vector<int32_t> roots(N);
  for (int64_t i = 0; i < N; ++i) roots[i] = uf.find(static_cast<int32_t>(i));
  std::vector<int32_t> uniq(roots);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  for (int64_t i = 0; i < N; ++i) {
    labels_out[i] = static_cast<int64_t>(
        std::lower_bound(uniq.begin(), uniq.end(), roots[i]) - uniq.begin());
  }
  lap("relabel");
}
