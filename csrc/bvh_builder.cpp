// Native SAH BVH builder.
//
// The framework's equivalent of the reference's host-side recursive
// CPU builder (main.cu:17-233): longest-axis, 12-bucket binned SAH with cost
// 1 + (SA_L*n_L + SA_R*n_R)/SA_parent, median fallback, mean-centroid backup
// split, force-leaf fallback. Exposed via a C ABI for ctypes; the Python
// numpy implementation in scene/bvh.py is the oracle this is tested against.
//
// Built with csrc/bvh8_collapse.cpp into one library by scene/native.py.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float comp(const V3& v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }
inline float surface_area(const V3& mn, const V3& mx) {
  float dx = std::max(mx.x - mn.x, 0.0f);
  float dy = std::max(mx.y - mn.y, 0.0f);
  float dz = std::max(mx.z - mn.z, 0.0f);
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  const V3* centroids;
  const V3* amins;
  const V3* amaxs;
  int max_leaf;
  int max_nodes;

  int32_t* left;
  int32_t* right;
  int32_t* axis_out;
  int32_t* leaf;    // [M,2] (first,count)
  float* bounds;    // [M,6]
  int32_t* perm;

  int num_nodes = 0;
  bool overflow = false;
  std::vector<int32_t> scratch;

  int new_node() {
    if (num_nodes >= max_nodes) {
      overflow = true;
      return max_nodes - 1;
    }
    int ni = num_nodes++;
    left[ni] = right[ni] = -1;
    axis_out[ni] = -1;
    leaf[2 * ni] = leaf[2 * ni + 1] = 0;
    return ni;
  }

  // 12-bucket binned SAH over node bounds; returns split position, or the
  // median fallback when no bucket split is valid (main.cu:64-131).
  double sah_split(int start, int end, int axis, const V3& min_b, const V3& max_b) {
    constexpr int NB = 12;
    float extent = comp(max_b, axis) - comp(min_b, axis);
    if (extent <= 0.0f) extent = 1e-30f;

    int counts[NB] = {0};
    V3 bmn[NB], bmx[NB];
    for (int i = 0; i < NB; i++) {
      bmn[i] = {FLT_MAX, FLT_MAX, FLT_MAX};
      bmx[i] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    }
    for (int i = start; i < end; i++) {
      int idx = perm[i];
      int b = (int)(NB * (comp(centroids[idx], axis) - comp(min_b, axis)) / extent);
      b = std::min(std::max(b, 0), NB - 1);
      counts[b]++;
      bmn[b] = vmin(bmn[b], amins[idx]);
      bmx[b] = vmax(bmx[b], amaxs[idx]);
    }

    float sa_parent = std::max(surface_area(min_b, max_b), 1e-30f);
    float best_cost = FLT_MAX;
    int best_split = -1;
    for (int i = 1; i < NB; i++) {
      V3 lmn = bmn[0], lmx = bmx[0];
      int nl = counts[0];
      for (int j = 1; j < i; j++) {
        lmn = vmin(lmn, bmn[j]);
        lmx = vmax(lmx, bmx[j]);
        nl += counts[j];
      }
      V3 rmn = bmn[i], rmx = bmx[i];
      int nr = counts[i];
      for (int j = i + 1; j < NB; j++) {
        rmn = vmin(rmn, bmn[j]);
        rmx = vmax(rmx, bmx[j]);
        nr += counts[j];
      }
      if (nl == 0 || nr == 0) continue;
      float cost = 1.0f + (nl * surface_area(lmn, lmx) + nr * surface_area(rmn, rmx)) / sa_parent;
      if (cost < best_cost) {
        best_cost = cost;
        best_split = i;
      }
    }

    if (best_split == -1) {
      // median fallback via nth_element on a stable-ordered copy
      int count = end - start;
      scratch.assign(perm + start, perm + end);
      int mid = count / 2;
      std::nth_element(scratch.begin(), scratch.begin() + mid, scratch.end(),
                       [&](int a, int b) {
                         float ca = comp(centroids[a], axis), cb = comp(centroids[b], axis);
                         if (ca != cb) return ca < cb;
                         return a < b;  // deterministic tie-break
                       });
      return comp(centroids[scratch[mid]], axis);
    }
    return comp(min_b, axis) + (double)extent * ((double)best_split / NB);
  }

  int count_left(int start, int end, int axis, double split) {
    int n = 0;
    for (int i = start; i < end; i++)
      if (comp(centroids[perm[i]], axis) < split) n++;
    return n;
  }

  // stable partition keeping relative order on both sides (matches the
  // Python builder; the reference's swap partition mangles order, which only
  // permutes leaf-internal triangle order — traversal results are identical)
  int partition_stable(int start, int end, int axis, double split) {
    scratch.clear();
    int mid = start;
    for (int i = start; i < end; i++) {
      int idx = perm[i];
      if (comp(centroids[idx], axis) < split)
        perm[mid++] = idx;
      else
        scratch.push_back(idx);
    }
    std::memcpy(perm + mid, scratch.data(), scratch.size() * sizeof(int32_t));
    return mid;
  }

  int build(int start, int end) {
    int ni = new_node();
    if (overflow) return ni;

    V3 min_b = amins[perm[start]], max_b = amaxs[perm[start]];
    for (int i = start; i < end; i++) {
      min_b = vmin(min_b, amins[perm[i]]);
      max_b = vmax(max_b, amaxs[perm[i]]);
    }
    bounds[6 * ni + 0] = min_b.x;
    bounds[6 * ni + 1] = min_b.y;
    bounds[6 * ni + 2] = min_b.z;
    bounds[6 * ni + 3] = max_b.x;
    bounds[6 * ni + 4] = max_b.y;
    bounds[6 * ni + 5] = max_b.z;

    int count = end - start;
    if (count <= max_leaf) {
      leaf[2 * ni] = start;
      leaf[2 * ni + 1] = count;
      return ni;
    }

    float dx = max_b.x - min_b.x, dy = max_b.y - min_b.y, dz = max_b.z - min_b.z;
    int axis = 0;
    if (dy > dx && dy > dz) axis = 1;
    else if (dz > dx && dz > dy) axis = 2;

    double split = sah_split(start, end, axis, min_b, max_b);
    int nl = count_left(start, end, axis, split);
    bool hard_split = false;
    if (!(nl > 0 && nl < count - 1)) {
      // mean-centroid backup (main.cu:196-206)
      double sum = 0.0;
      for (int i = start; i < end; i++) sum += comp(centroids[perm[i]], axis);
      split = sum / count;
      nl = count_left(start, end, axis, split);
      if (!(nl > 0 && nl < count - 1)) {
        // hard index split instead of the reference's oversized force-leaf
        // (leaves must fit the fixed-width packed node rows)
        hard_split = true;
      }
    }

    int mid = hard_split ? (start + count / 2)
                         : partition_stable(start, end, axis, split);
    axis_out[ni] = axis;
    int l = build(start, mid);
    int r = build(mid, end);
    left[ni] = l;
    right[ni] = r;
    return ni;
  }
};

}  // namespace

extern "C" {

// Returns node count, or -1 on overflow (max_nodes too small).
// All output arrays are caller-allocated with capacity max_nodes
// (2*n is always sufficient). perm must be pre-filled 0..n-1 or anything;
// it is (re)initialized here.
int tpt_build_bvh(const float* centroids, const float* amins, const float* amaxs,
                  int n, int max_leaf, int max_nodes,
                  int32_t* out_left, int32_t* out_right, int32_t* out_axis,
                  int32_t* out_leaf, float* out_bounds, int32_t* out_perm) {
  if (n <= 0 || max_leaf < 1) return -1;
  std::iota(out_perm, out_perm + n, 0);
  Builder b;
  b.centroids = reinterpret_cast<const V3*>(centroids);
  b.amins = reinterpret_cast<const V3*>(amins);
  b.amaxs = reinterpret_cast<const V3*>(amaxs);
  b.max_leaf = max_leaf;
  b.max_nodes = max_nodes;
  b.left = out_left;
  b.right = out_right;
  b.axis_out = out_axis;
  b.leaf = out_leaf;
  b.bounds = out_bounds;
  b.perm = out_perm;
  b.build(0, n);
  if (b.overflow) return -1;
  return b.num_nodes;
}

}  // extern "C"
