// Mesh intersection kernels for NVIDIA Hopper (sm_90a): K1 closest hit,
// K2 any-hit occlusion, K3 fused closest hit + shadow, K4 crossing census,
// K5 instanced closest hit, K6 instanced occlusion, and the elementwise
// cross-check backend K7a (closest hit) and K7b (occlusion); and, with no
// TPU counterpart, the object rows' sum (the shading glue's backward), the
// analytic prims' sweep (closest hit or shadow flag over the prims) and a
// bounce node's shading (its hits' frame, Phong and children's rays).
//
// Replaces (rtc_tpu/ops/pallas/mesh_intersect.py):
//   K1 _kernel_mxu / _kernel_mxu_body, with_n, with_sn, with_t0 and
//      with_uv modes                              (mesh_closest_hit_mxu)
//   K2 _anyhit_kernel_mxu                         (mesh_any_hit_mxu)
//   K3 _kernel_mxu_cs, flat and with_sn modes     (mesh_closest_shadow_mxu)
//   K4 _crossing_kernel_mxu + _mt_cluster_mxu_signed
//                                                 (mesh_crossing_count_mxu)
//   K5 _kernel_mxu_tlas + _inst_ray_features + _slab_full_t, with_n and
//      with_sn modes                              (mesh_closest_hit_tlas_mxu)
//   K6 _anyhit_kernel_tlas                        (mesh_any_hit_tlas_mxu)
//   K7a _kernel                                   (mesh_closest_hit_pallas)
//   K7b _anyhit_kernel                            (mesh_any_hit_pallas)
//
// What the TPU kernels compute is kept; their TPU layout is not. There is
// no Plücker matmul (that factoring exists to feed the MXU; K5/K6 map the
// ray itself into instance space instead of its Plücker features), no
// lane-major transposes, no per-tile union gate or selection sort, no
// seeded t_best, no two-probe loop and no VMEM superblocks inside a
// kernel. Each thread owns one ray (K7 also shares a block's rays across
// its warps, below). rtc_tpu's superblock streaming of
// oversized tables is kept as plain PyTorch around K1/K2/K4
// (ops/kernels/mesh_intersect.py), which K1's t0 mode serves.
//
// What bounds these kernels on an H100: divergent per-ray traversal, not
// bytes. A mesh's triangle tables (T x 9 floats, ~221 KB for the cow), its
// normals (T x 3 flat, T x 9 smooth) and container slots (T ints) sit in
// the 50 MB L2 and mostly in L1; a ray does a few thousand FP32 operations
// per cluster it visits and reads the same rows as its neighbours. The
// design answers that with ordering, not staging: rays come in 16x16 screen
// blocks, so a warp's 32 rays usually visit the same clusters in the same
// order and read the same triangle rows (one broadcast load per warp).
// Staging the occlusion walk's box tables in shared memory was measured
// no faster (PERF.md); TMA and wgmma are left for later work. K7, which
// tests every row of each cluster it enters, stages those rows in shared
// memory instead, one copy a block (the tile walk, below).
//
// Rounding. The file is compiled with -fmad=false, and every formula
// below keeps the association order of the plain PyTorch versions
// (rtc_tpu_torch/ops/intersect.py, ops/kernels/mesh_intersect.py). So each
// pair test, the smooth blend, and K3's in-register shadow ray round
// exactly as the plain versions' separate elementwise operations do, and
// K3's phase 1 is the same __device__ code as K1: fused and split give
// bit-identical t, idx and n.
//
// Any C, T, container count K and instance count I: no array is sized by
// the scene. K5/K6 read one copy of each unique mesh (the cow: 6,144 rows,
// ~300 KB with its normals), so ninety instances cost the caches no more
// than one.
//
// K1 and K5 (and K3's phase 1, which is K1) visit boxes in exact
// front-to-back (entry, id) order with an ordered early exit. What bounds
// them is the box tests of that order, beside the pair tests: finding the
// next box by a scan of every box of the range costs a visit O(C) box
// tests (C clusters, or K5's I instance boxes), so a ray that visits v
// boxes tests (v + 1) C, which on a table of thousands of clusters dwarfs
// its pair tests; and a warp waits for its lane with the most visits. The
// ordered walk (below) keeps a sorted list of the L nearest unvisited
// boxes a scan found, so a visit pops a key and the ray scans once per L
// visits, (floor(v / L) + 1) C box tests, in the same order and with the
// same cull: the outputs stay bit for bit those of a scan per visit. What
// is left is the first scan of each range, C box tests a ray however few
// boxes it enters, and the pair tests. The list costs 2 L registers a
// lane (K5 keeps two lists: instances, and the clusters of the current
// instance).
//
// Occlusion (K2, K3's phase 3, K6) needs no order: it returns the OR of
// pair tests. Those walk tables of their own (scene/compile.py
// OcclusionTables): groups of 8 boxes above the clusters (and the
// instances), and below each cluster sub-boxes of 8 rows over a copy of
// its rows in a finer k-d order, packed as 16-byte float4s, every box
// widened once at compile time (see "the occlusion walk" below). The
// census (K4) needs no order either: it sums crossings, and walks the same
// tables with a signed box test. K7a and K7b walk the world table in table
// order, a block of rays at a time (the tile walk).

#include <algorithm>

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;  // "no hit" (rtc_tpu_torch/utils/constants.py)
constexpr float kFar = 1e12f;  // parked origin of dead lanes (integrator.py)
// Threads a block of the per-ray kernels (K1-K6; K7 has kTileK7). A build
// may set it (-DRTC_THREADS=64): tools/kernel_sweep.py sweeps it, as
// kernel_sweep.py swept the TPU kernels' ray tile.
#ifndef RTC_THREADS
#define RTC_THREADS 128
#endif
constexpr int kThreads = RTC_THREADS;

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;  // slab reciprocals
};

// Near-zero direction components use +-BIG, not +-inf, so that
// (lo - o) * inv never forms 0 * inf = NaN (mesh_intersect.py:324-326).
__device__ __forceinline__ float slab_inv(float a) {
  if (fabsf(a) < 1e-30f) return a >= 0.f ? kBig : -kBig;
  return 1.0f / a;
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = slab_inv(dx); r.iy = slab_inv(dy); r.iz = slab_inv(dz);
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  return make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                  d[3 * i], d[3 * i + 1], d[3 * i + 2]);
}

__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& tmin,
                                          float& tmax) {
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
}

// Cluster c's box widened by a few ulps of its largest coordinate, so that
// rounding in the f32 box or in the slab arithmetic never cuts off a hit on
// its faces: w = [lx ly lz hx hy hz]; false (w unset) for an empty padding
// box (lo = 1 > hi = -1, compile.py).
__device__ __forceinline__ bool widened_box(const float* __restrict__ aabb, int c,
                                            float* w) {
  const float* b = aabb + 6 * c;
  const float lx = __ldg(b), ly = __ldg(b + 1), lz = __ldg(b + 2);
  const float hx = __ldg(b + 3), hy = __ldg(b + 4), hz = __ldg(b + 5);
  if (lx > hx || ly > hy || lz > hz) return false;
  const float scale = fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(hx)),
                                  fmaxf(fabsf(ly), fabsf(hy))),
                            fmaxf(fabsf(lz), fabsf(hz)));
  const float pad = 4e-6f * scale;
  w[0] = lx - pad; w[1] = ly - pad; w[2] = lz - pad;
  w[3] = hx + pad; w[4] = hy + pad; w[5] = hz + pad;
  return true;
}

// The ray's signed slab interval [tmin, tmax] through a widened box w.
__device__ __forceinline__ void widened_slab(const Ray& r, const float* w, float& tmin,
                                             float& tmax) {
  tmin = -kBig;
  tmax = kBig;
  slab_axis(w[0], w[3], r.ox, r.ix, tmin, tmax);
  slab_axis(w[1], w[4], r.oy, r.iy, tmin, tmax);
  slab_axis(w[2], w[5], r.oz, r.iz, tmin, tmax);
}

// The ray's signed slab interval [tmin, tmax] through cluster c's widened
// box; false for an empty box.
__device__ __forceinline__ bool cluster_slab(const Ray& r,
                                             const float* __restrict__ aabb,
                                             int c, float& tmin,
                                             float& tmax) {
  float w[6];
  if (!widened_box(aabb, c, w)) return false;
  widened_slab(r, w, tmin, tmax);
  return true;
}

// Conservative entry t (>= 0) of the ray into cluster c's box, or kBig
// when the ray misses the box, the box lies behind the ray, or the box is
// empty. A parked lane (origin 1e12, direction +0.577) has every box
// behind it.
__device__ __forceinline__ float cluster_entry(const Ray& r,
                                               const float* __restrict__ aabb,
                                               int c) {
  float tmin, tmax;
  if (!cluster_slab(r, aabb, c, tmin, tmax)) return kBig;
  if (!(tmax >= tmin && tmax >= 0.f)) return kBig;
  return fmaxf(tmin, 0.f);
}

// The rows a pair test reads: the (T, 3) tables of the world and the
// TLAS (SplitRows), the occlusion walk's copy, packed as three float4 a
// row (PackedRows), or one cluster of the world table staged in shared
// memory by K7's tile walk (SharedRows). All hand over the same f32 values.
struct SplitRows {
  const float *p1_, *e1_, *e2_;
  __device__ __forceinline__ float4 row(const float* x, int j) const {
    return make_float4(__ldg(x + 3 * j), __ldg(x + 3 * j + 1), __ldg(x + 3 * j + 2), 0.f);
  }
  __device__ __forceinline__ float4 e1(int j) const { return row(e1_, j); }
  __device__ __forceinline__ float4 e2(int j) const { return row(e2_, j); }
  __device__ __forceinline__ float4 p1(int j) const { return row(p1_, j); }
};

struct PackedRows {  // (T, 3) float4: p1, e1, e2, each with w = 0
  const float4* __restrict__ rows;
  __device__ __forceinline__ float4 e1(int j) const { return __ldg(rows + 3 * j + 1); }
  __device__ __forceinline__ float4 e2(int j) const { return __ldg(rows + 3 * j + 2); }
  __device__ __forceinline__ float4 p1(int j) const { return __ldg(rows + 3 * j); }
};

struct SharedRows {  // a staged cluster: (leaf, 3) p1, then e1, then e2; j local
  const float* p1_;
  int n;  // 3 * leaf
  __device__ __forceinline__ float4 row(const float* x, int j) const {
    return make_float4(x[3 * j], x[3 * j + 1], x[3 * j + 2], 0.f);
  }
  __device__ __forceinline__ float4 e1(int j) const { return row(p1_ + n, j); }
  __device__ __forceinline__ float4 e2(int j) const { return row(p1_ + 2 * n, j); }
  __device__ __forceinline__ float4 p1(int j) const { return row(p1_, j); }
};

// The one pair test of every kernel: Möller-Trumbore
// (rtc_tpu/ops/intersect.py:207-227) for triangle row j, in full FP32 and
// in the order of rtc_tpu_torch/ops/intersect.py, the edges loaded first
// and p1 past the det guard. Returns the stage where the test stops: the
// det guard, u, v, or kCrosses when the ray crosses the triangle (any sign
// of t), with t set. Padding rows have zero edges, so det = 0 and the det
// guard rejects them.
enum PairStop { kStopDet, kStopU, kStopV, kCrosses };

template <class Rows>
__device__ __forceinline__ int pair_stage(const Ray& r, const Rows& rows, int j,
                                          float eps, float& t) {
  const float4 a = rows.e1(j), b = rows.e2(j);
  const float hx = r.dy * b.z - r.dz * b.y;
  const float hy = r.dz * b.x - r.dx * b.z;
  const float hz = r.dx * b.y - r.dy * b.x;
  const float det = a.x * hx + a.y * hy + a.z * hz;
  if (!(fabsf(det) >= eps)) return kStopDet;
  const float f = 1.0f / det;
  const float4 p = rows.p1(j);
  const float sx = r.ox - p.x;
  const float sy = r.oy - p.y;
  const float sz = r.oz - p.z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  if (!(u >= 0.f && u <= 1.f)) return kStopU;
  const float qx = sy * a.z - sz * a.y;
  const float qy = sz * a.x - sx * a.z;
  const float qz = sx * a.y - sy * a.x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  if (!(v >= 0.f && u + v <= 1.f)) return kStopV;
  t = f * (b.x * qx + b.y * qy + b.z * qz);
  return kCrosses;
}

// The pair test on the (T, 3) tables: true with t set when the ray
// crosses triangle row j.
__device__ __forceinline__ bool tri_hit(const Ray& r,
                                        const float* __restrict__ p1,
                                        const float* __restrict__ e1,
                                        const float* __restrict__ e2, int j,
                                        float eps, float& t) {
  return pair_stage(r, SplitRows{p1, e1, e2}, j, eps, t) == kCrosses;
}

// Barycentric (u, v) of the ray on triangle row j, with tri_hit's
// arithmetic. Recomputing them at the winner costs one pair test per ray
// and gives the bits the traversal saw, without carrying (u, v) through
// the loop.
__device__ __forceinline__ void tri_uv(const Ray& r,
                                       const float* __restrict__ p1,
                                       const float* __restrict__ e1,
                                       const float* __restrict__ e2, int j,
                                       float& u, float& v) {
  const float e1x = __ldg(e1 + 3 * j), e1y = __ldg(e1 + 3 * j + 1),
              e1z = __ldg(e1 + 3 * j + 2);
  const float e2x = __ldg(e2 + 3 * j), e2y = __ldg(e2 + 3 * j + 1),
              e2z = __ldg(e2 + 3 * j + 2);
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float f = 1.0f / (e1x * hx + e1y * hy + e1z * hz);
  const float sx = r.ox - __ldg(p1 + 3 * j);
  const float sy = r.oy - __ldg(p1 + 3 * j + 1);
  const float sz = r.oz - __ldg(p1 + 3 * j + 2);
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
}

// ---- the ordered walk: K1's clusters and K5's instances ----
//
// A lane's list holds up to L keys (entry, id), sorted, of the boxes that
// one scan of the range found entered before t_best and after the last
// visited key. The scan offers boxes in increasing id, so a key goes after
// every key of equal entry already listed: sorting by entry alone, stably,
// sorts by (entry, id). The list lives in registers, and L is fixed at
// compile time for each kernel. Both were chosen by measurement, in turns
// on an H100 (kernel_ab.py): a list in dynamic shared memory, laid out
// [slot][thread], was no faster than registers in any kernel and slower in
// most; K1 and K3 gain up to L = 16 (a ray of the one-mesh herd visits up
// to 24 clusters), while K5, which keeps two lists, loses more to their
// registers beyond L = 8 than shorter walks give back. To sweep L, edit
// these constants and compare the builds with kernel_ab.py.

constexpr int kListK1 = 16;  // K1, and K3's phase 1
constexpr int kListK5 = 8;   // each of K5's two lists
static_assert(kListK1 >= 1 && kListK5 >= 1, "a list holds at least one key");

// Every index is a constant once the loops unroll, so the arrays stay in
// registers. Free slots hold +inf, above any key (a key's entry is
// < t_best, so finite).
template <int L>
struct WalkList {
  float e[L];
  int c[L];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < L; ++j) { e[j] = INFINITY; c[j] = -1; }
  }
  __device__ __forceinline__ bool empty() const { return !(e[0] < INFINITY); }
  // insert behind every key of entry <= ke; the last key falls off when full
  __device__ __forceinline__ void offer(float ke, int kc) {
    if (!(ke < e[L - 1])) return;
    bool shift = false;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      shift = shift || ke < e[j];
      if (shift) {
        const float te = e[j];
        const int tc = c[j];
        e[j] = ke; c[j] = kc;
        ke = te; kc = tc;
      }
    }
  }
  __device__ __forceinline__ void pop(float& ke, int& kc) {
    ke = e[0];
    kc = c[0];
#pragma unroll
    for (int j = 0; j + 1 < L; ++j) { e[j] = e[j + 1]; c[j] = c[j + 1]; }
    e[L - 1] = INFINITY;
    c[L - 1] = -1;
  }
};

// Visits the boxes of [c0, c1) entered before t_best in increasing
// (entry, id) order, calling visit(id) for each; visit may lower t_best.
// One scan tests every box once and fills the list with the L least keys
// after the last visited one; the walk pops them in order, each
// re-checked against the current t_best, and the first key at or beyond
// t_best ends it. When the list runs dry, it scans again from the last
// visited key, but only if that scan found more keys than the list held.
//
// Why this visits exactly what a scan per visit would (the next box being
// the least key after the last among those entered before the CURRENT
// t_best): t_best only falls, so every key that scan could return was
// found by the scan that filled the list, and the list holds the least of
// those after the last visited key. The next popped key is therefore the
// least candidate left, unless it is entered at or beyond t_best, and then
// so is every later one. So t, idx and every payload are those of the
// per-visit scan bit for bit, at a cost of one scan per L visits.
template <int L, class Visit>
__device__ __forceinline__ void ordered_walk(const Ray& r,
                                             const float* __restrict__ aabb,
                                             int c0, int c1,
                                             const float& t_best,
                                             WalkList<L>& list, Visit visit) {
  float last_e = -1.f;
  int last_c = -1;
  for (;;) {
    list.clear();
    int found = 0;
    for (int c = c0; c < c1; ++c) {
      const float e = cluster_entry(r, aabb, c);
      if (!(e < t_best)) continue;
      if (e < last_e || (e == last_e && c <= last_c)) continue;
      ++found;
      list.offer(e, c);
    }
    while (!list.empty()) {
      float e;
      int c;
      list.pop(e, c);
      if (!(e < t_best)) return;
      visit(c);
      last_e = e;
      last_c = c;
    }
    if (found <= L) return;
  }
}

// K1 body over clusters [c0, c1): lowers t_best (and sets best to the
// triangle row) for the nearest triangle with t >= 0 below the t_best it
// was given. Clusters are visited in increasing (entry, cluster id) order,
// and the walk stops once no unvisited cluster starts before t_best (the
// ordered early exit of _kernel_mxu_body). K5 carries t_best from one
// instance into the next.
template <int L>
__device__ __forceinline__ void closest_in_clusters(
    const Ray& r, const float* __restrict__ p1, const float* __restrict__ e1,
    const float* __restrict__ e2, const float* __restrict__ aabb, int c0,
    int c1, int leaf, float eps, float& t_best, int& best,
    WalkList<L>& list) {
  ordered_walk<L>(r, aabb, c0, c1, t_best, list, [&](int c) {
    const int base = c * leaf;
    for (int j = base; j < base + leaf; ++j) {
      float t;
      if (tri_hit(r, p1, e1, e2, j, eps, t) && t >= 0.f && t < t_best) {
        t_best = t;
        best = j;
      }
    }
  });
}

// K1 body over the whole table: t_best = kBig and best = -1 on a miss.
__device__ __forceinline__ void closest_hit_dev(
    const Ray& r, const float* __restrict__ p1, const float* __restrict__ e1,
    const float* __restrict__ e2, const float* __restrict__ aabb, int C,
    int leaf, float eps, float& t_best, int& best) {
  t_best = kBig;
  best = -1;
  WalkList<kListK1> list;
  closest_in_clusters<kListK1>(r, p1, e1, e2, aabb, 0, C, leaf, eps, t_best,
                               best, list);
}

// ---- the counting build (-DRTC_COUNT) ----
//
// Built as a library of its own (kernel_ab.py counting_library), the
// walks tally, per ray, the box tests and boxes entered at each level and
// the pair tests by the stage where they stop, into the (R, kCounters)
// i32 buffer that rtc_set_count_buffer names (the occlusion walk of K2,
// K3's phase 3 and K6, K4's census walk, K7's tile walk, and K2's old
// table-order loop, which this build alone also exports). K7's tile walk
// also tallies its 32-row rounds and the lanes holding a row in them on
// the ray, and, on the first ray of each tile, the clusters the tile
// tested, those it tested a lane a ray, and the ray slots its warps ran
// for them (a warp a ray: kTileWarps a round of listed rays; a lane a ray:
// 32 for each warp holding an entered lane). In
// the production build the tallies are empty and nothing else differs.
enum Counter {
  kInstGroupTests, kInstTests, kGroupTests, kClusterTests, kSubTests,
  kInstEntered, kGroupsEntered, kClustersEntered, kSubsEntered,
  kPairDet, kPairU, kPairV, kPairT,
  kSuperTests, kSupersEntered, kRounds, kRoundLanes, kTileClusters, kTileSlots,
  kTileByLane, kCounters
};

#ifdef RTC_COUNT
__device__ int* g_count;
// adds n to counter k of ray i of the launch
__device__ __forceinline__ void tally_at(int i, int k, int n) {
  if (g_count) g_count[(size_t)i * kCounters + k] += n;
}
__device__ __forceinline__ void tally(int k) {
  tally_at(blockIdx.x * blockDim.x + threadIdx.x, k, 1);
}
#else
__device__ __forceinline__ void tally_at(int, int, int) {}
__device__ __forceinline__ void tally(int) {}
#endif

#ifdef RTC_COUNT
// The table-order loop over clusters [c0, c1), K2's before its walk: does any triangle lie at t in [0, max_t)? max_t <= 0 marks a dead
// lane, which never hits. Clusters in table order (k-d order, so still
// spatially coherent), skipping those the ray misses or enters at or
// beyond max_t; each entered cluster's leaf rows; the lane stops at its
// first occluder. Built only to be counted.
__device__ __forceinline__ bool any_hit_table_order(
    const Ray& r, float max_t, const float* __restrict__ p1,
    const float* __restrict__ e1, const float* __restrict__ e2,
    const float* __restrict__ aabb, int c0, int c1, int leaf, float eps) {
  if (!(max_t > 0.f)) return false;
  for (int c = c0; c < c1; ++c) {
    tally(kClusterTests);
    if (!(cluster_entry(r, aabb, c) < max_t)) continue;
    tally(kClustersEntered);
    for (int j = c * leaf; j < (c + 1) * leaf; ++j) {
      float t;
      const int stage = pair_stage(r, SplitRows{p1, e1, e2}, j, eps, t);
      tally(kPairDet + stage);
      if (stage == kCrosses && t >= 0.f && t < max_t) return true;
    }
  }
  return false;
}
#endif

// ---- the occlusion walk: K2, K3's phase 3 and K6 ----
//
// Occlusion returns the OR of pair tests over rows, and each pair test
// depends only on the ray and the row. So a cull that never drops a row
// which hits, any visiting order, and a permuted copy of the rows all
// leave every flag bit as the table-order loop gives it. The walk (the
// tables: scene/compile.py OcclusionTables) culls at three box levels
// before the rows: groups of 8 clusters, the clusters, and the sub-boxes
// of 8 rows inside each cluster (its rows copied in a k-d order, packed
// as three float4 a row). A box counts as entered when the ray enters it
// before max_t; the lane stops at its first occluder.
//
// What it saves over the table-order loop: a ray there tests every
// cluster box (48 on the cow) and all 128 rows of each cluster it enters.
// A shadow ray leaves the surface from inside its own cluster's box, so
// it enters that box and usually a neighbour's; the sub-boxes then keep
// only the rows near its line. Every box is widened once at compile time,
// in f32 with cluster_slab's operations (compile.py widen_boxes), so a
// test is the bare slab test; an empty box is stored as a point at 1e30
// that no ray enters before its max_t. Padding rows have zero edges and
// never hit, so a padding box needs no test of its own.
//
// Why the cull never drops a hit: a group box is the union of its
// children's unwidened boxes, widened afterwards, and f32 rounding is
// monotone, so its slab interval contains each child's (compile.py
// widen_boxes); a cluster box and a sub-box each contain their rows'
// vertices and are widened as cluster_slab widens (the test that a hit
// lies in an entered box at every level: tests/test_torch_occlusion_tables.py).

constexpr int kGroup = 8;  // children a group box covers, at every level

// The ray's signed slab interval [tmin, tmax] through box k of a widened
// table ([lx ly lz hx hy hz]): cluster_slab's, with the box's widening
// already done. The box tables are read through L1 (__ldg): a copy into
// shared memory at block start (cp.async, ~20 KB a block) was no faster on
// an H100 (PERF.md).
__device__ __forceinline__ void box_slab(const Ray& r, const float* __restrict__ box,
                                         int k, float& tmin, float& tmax) {
  const float2* b = reinterpret_cast<const float2*>(box) + 3 * k;
  const float2 a = __ldg(b), bb = __ldg(b + 1), c = __ldg(b + 2);  // lx ly | lz hx | hy hz
  tmin = -kBig;
  tmax = kBig;
  slab_axis(a.x, bb.y, r.ox, r.ix, tmin, tmax);
  slab_axis(a.y, c.x, r.oy, r.iy, tmin, tmax);
  slab_axis(bb.x, c.y, r.oz, r.iz, tmin, tmax);
}

// Does the ray enter box k at some t in [0, max_t)? cluster_entry(...) <
// max_t for a live lane (max_t > 0).
__device__ __forceinline__ bool enters(const Ray& r, const float* __restrict__ box,
                                       int k, float max_t) {
  float tmin, tmax;
  box_slab(r, box, k, tmin, tmax);
  return tmax >= tmin && tmax >= 0.f && tmin < max_t;
}

struct OccTables {
  PackedRows rows;
  const float* sub;   // (C * n_sub, 6) widened sub-boxes of sub_rows rows
  const float* clus;  // (C, 6) widened cluster boxes
  const float* grp;   // (ceil(C / 8), 6) widened group boxes
  int n_sub, sub_rows;
};

// Any row of clusters [c0, c1) at t in [0, max_t), max_t > 0: the groups
// that hold the range in order, the range's clusters of each entered group,
// the sub-boxes of each entered cluster, the rows of each entered sub-box.
// A range whose ends fall inside a group (a streamed superblock of 372
// clusters, 46.5 groups) is walked exactly: the group box holds every
// cluster of the group, and the clusters outside the range are skipped.
__device__ __forceinline__ bool occluded(const Ray& r, float max_t, const OccTables& tb,
                                         int c0, int c1, float eps) {
  for (int g = c0 / kGroup; g * kGroup < c1; ++g) {
    tally(kGroupTests);
    if (!enters(r, tb.grp, g, max_t)) continue;
    tally(kGroupsEntered);
    const int cb = min((g + 1) * kGroup, c1);
    for (int c = max(g * kGroup, c0); c < cb; ++c) {
      tally(kClusterTests);
      if (!enters(r, tb.clus, c, max_t)) continue;
      tally(kClustersEntered);
      for (int s = c * tb.n_sub; s < (c + 1) * tb.n_sub; ++s) {
        tally(kSubTests);
        if (!enters(r, tb.sub, s, max_t)) continue;
        tally(kSubsEntered);
        for (int j = s * tb.sub_rows; j < (s + 1) * tb.sub_rows; ++j) {
          float t;
          const int stage = pair_stage(r, tb.rows, j, eps, t);
          tally(kPairDet + stage);
          if (stage == kCrosses && t >= 0.f && t < max_t) return true;
        }
      }
    }
  }
  return false;
}

// The winner's payload, zeros on a miss. Flat (SN = false): its row of
// tri_n (T, 3). Smooth (SN = true): its corner normals (pay = tri_sn, a
// (T, 9) table [sn1 | sn2 | sn3]) blended by its (u, v) in rtc_tpu's order
// (mesh_intersect.py:538-545), unnormalized.
template <bool SN>
__device__ __forceinline__ void hit_payload(const Ray& r, int idx,
                                            const float* __restrict__ pay,
                                            const float* __restrict__ p1,
                                            const float* __restrict__ e1,
                                            const float* __restrict__ e2,
                                            float& nx, float& ny, float& nz) {
  nx = ny = nz = 0.f;
  if (idx < 0) return;
  if (!SN) {
    nx = __ldg(pay + 3 * idx);
    ny = __ldg(pay + 3 * idx + 1);
    nz = __ldg(pay + 3 * idx + 2);
    return;
  }
  float u, v;
  tri_uv(r, p1, e1, e2, idx, u, v);
  const float w0 = (1.0f - u) - v;
  const float* g = pay + 9 * idx;
  nx = (w0 * __ldg(g) + u * __ldg(g + 3)) + v * __ldg(g + 6);
  ny = (w0 * __ldg(g + 1) + u * __ldg(g + 4)) + v * __ldg(g + 7);
  nz = (w0 * __ldg(g + 2) + u * __ldg(g + 5)) + v * __ldg(g + 8);
}

__device__ __forceinline__ void write_hit(int i, float t, int idx, float nx,
                                          float ny, float nz, float* t_out,
                                          int* idx_out, float* n_out) {
  t_out[i] = t;
  idx_out[i] = idx;
  n_out[3 * i] = nx;
  n_out[3 * i + 1] = ny;
  n_out[3 * i + 2] = nz;
}

// K1, in one of three payload modes: kFlat writes the winner's tri_n row
// and kSn its corner blend (hit_payload, pay = tri_n or tri_sn); kUv writes
// the winner's raw (u, v) from tri_uv, zeros on a miss, in place of a
// normal (:546-549), and reads no payload. T0 is the carried-bound mode
// (:435-460): t_best starts at t0[i], a strict bound, so the walk never
// schedules a cluster entered at or beyond it and only hits strictly
// before it win (the cross-superblock carry of the streaming drivers,
// mesh_intersect.py:1479-1520); a lane whose bound is never beaten reports
// t = BIG and idx = -1 (:1761-1764). Without T0, t0 is never read and the
// code is the walk of closest_hit_dev, as K3's phase 1.
enum Payload { kFlat, kSn, kUv };

template <Payload P, bool T0>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t0, int R,
                   const float* __restrict__ p1, const float* __restrict__ e1,
                   const float* __restrict__ e2, const float* __restrict__ pay,
                   const float* __restrict__ aabb, int C, int leaf, float eps,
                   float* __restrict__ t_out, int* __restrict__ idx_out,
                   float* __restrict__ pay_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(o, d, i);
  float t;
  int idx;
  if constexpr (T0) {
    t = t0[i];
    idx = -1;
    WalkList<kListK1> list;
    closest_in_clusters<kListK1>(r, p1, e1, e2, aabb, 0, C, leaf, eps, t, idx,
                                 list);
    if (idx < 0) t = kBig;
  } else {
    closest_hit_dev(r, p1, e1, e2, aabb, C, leaf, eps, t, idx);
  }
  if constexpr (P == kUv) {
    float u = 0.f, v = 0.f;
    if (idx >= 0) tri_uv(r, p1, e1, e2, idx, u, v);
    t_out[i] = t;
    idx_out[i] = idx;
    pay_out[2 * i] = u;
    pay_out[2 * i + 1] = v;
  } else {
    float nx, ny, nz;
    hit_payload<P == kSn>(r, idx, pay, p1, e1, e2, nx, ny, nz);
    write_hit(i, t, idx, nx, ny, nz, t_out, idx_out, pay_out);
  }
}

// K2: the occlusion walk (occluded) over clusters [c0, c1) of the world
// table's occlusion tables: the whole table in one launch, or one streamed
// superblock (ops/kernels/mesh_intersect.py any_hit_blocked) of the same
// tables. max_t <= 0 (or NaN) is a dead lane, which loads no ray.
__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ max_t, int R, OccTables tb, int c0,
               int c1, float eps, uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float mt = max_t[i];
  hit_out[i] = mt > 0.f && occluded(load_ray(o, d, i), mt, tb, c0, c1, eps);
}

#ifdef RTC_COUNT
// The table-order loop as K2 ran it before the occlusion walk, built only
// to be counted (rtc_count_any_hit_table_order).
__global__ void __launch_bounds__(kThreads)
any_hit_table_order_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ max_t, int R,
                           const float* __restrict__ p1, const float* __restrict__ e1,
                           const float* __restrict__ e2, const float* __restrict__ aabb,
                           int C, int leaf, float eps, uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  hit_out[i] = any_hit_table_order(load_ray(o, d, i), max_t[i], p1, e1, e2, aabb, 0, C,
                                   leaf, eps);
}
#endif

// K3: phase 1 is K1; phase 2 derives the shadow ray in registers, formula
// for formula as _kernel_mxu_cs (mesh_intersect.py:767-818), which copies
// prepare_hit3's normal flip and over_point, color_at's facing test and
// is_shadowed's direction, distance and live rules; phase 3 is the
// occlusion walk on it (occluded), whose flags equal K2's. Smooth meshes
// normalize the blend before the flip (:782-786); n_out keeps the raw
// blend, as K1's.
template <bool SN>
__global__ void __launch_bounds__(kThreads)
closest_shadow_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      int R, const float* __restrict__ p1,
                      const float* __restrict__ e1,
                      const float* __restrict__ e2,
                      const float* __restrict__ pay,
                      const float* __restrict__ aabb, int C, int leaf,
                      float eps, const float* __restrict__ light, OccTables occ,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      float* __restrict__ n_out, uint8_t* __restrict__ sh_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(o, d, i);
  float t;
  int idx;
  closest_hit_dev(r, p1, e1, e2, aabb, C, leaf, eps, t, idx);
  float nx, ny, nz;
  hit_payload<SN>(r, idx, pay, p1, e1, e2, nx, ny, nz);
  write_hit(i, t, idx, nx, ny, nz, t_out, idx_out, n_out);

  // ---- phase 2: the shadow ray ----
  if (SN) {  // normalize3, in the plain version's rounding (no rsqrtf)
    const float nsq = nx * nx + ny * ny + nz * nz;
    const float ninv = nsq > 0.f ? 1.0f / sqrtf(nsq) : 0.f;
    nx = nx * ninv; ny = ny * ninv; nz = nz * ninv;
  }
  const bool hit_ok = idx >= 0;
  const float ts = hit_ok ? t : 1.0f;
  const float px = r.ox + r.dx * ts;
  const float py = r.oy + r.dy * ts;
  const float pz = r.oz + r.dz * ts;
  const bool inside = (nx * -r.dx + ny * -r.dy + nz * -r.dz) < 0.f;
  if (inside) { nx = -nx; ny = -ny; nz = -nz; }
  const float lx = __ldg(light), ly = __ldg(light + 1), lz = __ldg(light + 2);
  // facing test from the hit point (color_at)
  const float fx = lx - px, fy = ly - py, fz = lz - pz;
  const float fsq = fx * fx + fy * fy + fz * fz;
  const float finv = fsq > 0.f ? 1.0f / sqrtf(fsq) : 0.f;
  const bool facing = ((fx * finv) * nx + (fy * finv) * ny
                       + (fz * finv) * nz) >= 0.f;
  // over_point, parked far away for misses (color_at)
  const float ovx = hit_ok ? px + nx * eps : kFar;
  const float ovy = hit_ok ? py + ny * eps : kFar;
  const float ovz = hit_ok ? pz + nz * eps : kFar;
  // direction, distance and live bound (is_shadowed)
  const float vx = lx - ovx, vy = ly - ovy, vz = lz - ovz;
  const float dist = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-30f));
  const float max_t = (hit_ok && facing) ? dist : -1.f;
  const Ray s = make_ray(ovx, ovy, ovz, vx / dist, vy / dist, vz / dist);

  // ---- phase 3: occlusion ----
  sh_out[i] = max_t > 0.f && occluded(s, max_t, occ, 0, C, eps);
}

// K4: per ray and container slot k, the number of crossings of slot-k
// triangles at t < t_hit, NEGATIVE t included (the reference's containers
// walk runs over the whole intersection list, src/intersection.rs:29-62),
// and the latest such t. The hit triangle itself (hit_gid, a world table
// row) is excluded by id. t_hit <= -BIG marks a dead lane, which visits
// nothing. The lane accumulates straight into its own output rows, so K
// is not bounded by the kernel; a row whose slot lies at or past K counts
// nowhere, as in the plain version.
//
// The census walk: every crossing counts, so there is no early exit and
// no order, and the walk descends the occlusion tables over clusters
// [c0, c1) (the whole table, or one streamed superblock): the groups that
// hold a container row, their clusters that do, the sub-boxes of each
// entered cluster, and each entered sub-box's container rows. A box counts
// as entered when the ray's signed slab interval through it is not empty
// and starts before t_hit (behind the origin included): the test the
// table-order census made on cluster_slab's box, which the stored cluster
// box equals bit for bit. Counts are integer sums and the latest crossing
// an fmaxf, so any order and any cull that keeps every crossing row gives
// the same cnt and last bit for bit; a group box holds its clusters' and a
// sub-box holds its rows' vertices, each widened (compile.py widen_boxes).
//
// Padding. Without the tmax >= 0 condition an empty box (EMPTY_BOX, a
// point at 1e30) can be entered by a ray whose three slabs meet there at
// a t inside the slab's start interval [-kBig, kBig]: not by a unit
// direction (it meets the point at +-1.7e30), but by one of magnitude >= 1
// on every axis, such as -2 (at t = -5e29). No count changes: an empty
// cluster or group holds no container row and is skipped by its census
// flag before its box; an empty sub-box inside a real cluster holds only
// padding rows, whose slot is -1 (and whose zero edges never cross), and
// they are skipped before their pair test (tests/test_torch_census_walk.py).
struct CensusTables {
  const int* row_id;      // (T,) the table row of each packed row
  const int* row_cid;     // (T,) its container slot, -1: none
  const uint8_t* clus;    // (C,) the cluster holds a container row
  const uint8_t* grp;     // (ceil(C / 8),) a cluster of the group does
};

// The census's test of box k: a signed slab interval starting before limit.
__device__ __forceinline__ bool enters_signed(const Ray& r, const float* __restrict__ box,
                                              int k, float limit) {
  float tmin, tmax;
  box_slab(r, box, k, tmin, tmax);
  return tmax >= tmin && tmin < limit;
}

__global__ void __launch_bounds__(kThreads)
crossing_count_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ t_hit,
                      const int* __restrict__ hit_gid, int R, OccTables tb,
                      CensusTables cs, int c0, int c1, float eps, int K,
                      int* __restrict__ cnt_out, float* __restrict__ last_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  int* cnt = cnt_out + (size_t)i * K;
  float* last = last_out + (size_t)i * K;
  for (int k = 0; k < K; ++k) {
    cnt[k] = 0;
    last[k] = -kBig;
  }
  const float th = t_hit[i];
  if (!(th > -kBig)) return;
  const Ray r = load_ray(o, d, i);
  const int self = hit_gid[i];
  for (int g = c0 / kGroup; g * kGroup < c1; ++g) {
    if (!__ldg(cs.grp + g)) continue;
    tally(kGroupTests);
    if (!enters_signed(r, tb.grp, g, th)) continue;
    tally(kGroupsEntered);
    const int cb = min((g + 1) * kGroup, c1);
    for (int c = max(g * kGroup, c0); c < cb; ++c) {
      if (!__ldg(cs.clus + c)) continue;
      tally(kClusterTests);
      if (!enters_signed(r, tb.clus, c, th)) continue;
      tally(kClustersEntered);
      for (int s = c * tb.n_sub; s < (c + 1) * tb.n_sub; ++s) {
        tally(kSubTests);
        if (!enters_signed(r, tb.sub, s, th)) continue;
        tally(kSubsEntered);
        for (int j = s * tb.sub_rows; j < (s + 1) * tb.sub_rows; ++j) {
          const int k = __ldg(cs.row_cid + j);
          if (k < 0 || k >= K || __ldg(cs.row_id + j) == self) continue;
          float t;
          const int stage = pair_stage(r, tb.rows, j, eps, t);
          tally(kPairDet + stage);
          if (stage == kCrosses && t < th) {
            cnt[k] += 1;
            last[k] = fmaxf(last[k], t);
          }
        }
      }
    }
  }
}

// ---- instanced (TLAS) tables: K5 and K6 ----
//
// The unique meshes sit once, in object space: M meshes of cm clusters of
// leaf rows each (p1/e1/e2 and the payload (M*cm*leaf, 3|9), caabb
// (M*cm, 6)). Instance k maps a world ray into its mesh's object space by
// inst_ab[k] = [A row-major | b]: o' = A o + b, d' = A d. d' is not
// renormalized, so a hit at parameter t in object space lies at the same
// world t, and one carried t_best serves every instance. inst_aabb[k] is
// the instance's world box; padding instances carry the identity, mesh 0
// and an EMPTY box, which alone keeps them out. Nothing is sized by I, M
// or cm, and an instance whose mesh index lies outside [0, M) is skipped.

// The ray in instance space, summed left to right in one fixed order:
// o'_k = ((A_k0 ox + A_k1 oy) + A_k2 oz) + b_k, d'_k = (A_k0 dx + A_k1 dy)
// + A_k2 dz, as the plain versions' elementwise operations round. Its slab
// reciprocals come from make_ray (+-BIG for near-zero components: a 0.5
// scale gives |d'| = 2, and an axis-aligned d' keeps exact zeros).
__device__ __forceinline__ Ray instance_ray(const Ray& r,
                                            const float* __restrict__ ab) {
  float o2[3], d2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a0 = __ldg(ab + 3 * k), a1 = __ldg(ab + 3 * k + 1),
                a2 = __ldg(ab + 3 * k + 2);
    o2[k] = ((a0 * r.ox + a1 * r.oy) + a2 * r.oz) + __ldg(ab + 9 + k);
    d2[k] = (a0 * r.dx + a1 * r.dy) + a2 * r.dz;
  }
  return make_ray(o2[0], o2[1], o2[2], d2[0], d2[1], d2[2]);
}

// An object-space normal pushed to world space by the inverse-transpose
// in row-vector form, n_w[a] = (n0 A[0][a] + n1 A[1][a]) + n2 A[2][a]
// (rtc_tpu mesh_intersect.py:1094-1096), unnormalized.
__device__ __forceinline__ void normal_to_world(const float* __restrict__ ab,
                                                float& nx, float& ny,
                                                float& nz) {
  const float n0 = nx, n1 = ny, n2 = nz;
  nx = (n0 * __ldg(ab) + n1 * __ldg(ab + 3)) + n2 * __ldg(ab + 6);
  ny = (n0 * __ldg(ab + 1) + n1 * __ldg(ab + 4)) + n2 * __ldg(ab + 7);
  nz = (n0 * __ldg(ab + 2) + n1 * __ldg(ab + 5)) + n2 * __ldg(ab + 8);
}

// K5: instances in increasing (world-box entry, instance id) order, by the
// ordered walk over inst_aabb with a list of its own; the walk stops once
// no unvisited instance starts before t_best. Each visit runs K1's walk
// over the instance's mesh in its object space with t_best carried in (a
// second list, reused from instance to instance), so the winner is the
// strict-< minimum over every instance. Outputs:
// t (kBig on a miss), enc = instance * cm * leaf + mesh-local row (-1),
// obj = inst_obj of the winning instance (0), and the payload (0): flat,
// the winner's object face normal; with_sn, its corner normals blended by
// its (u, v) in the winning instance's object space; both pushed to world
// by normal_to_world. The winning instance's ray is rebuilt for the
// payload, bit for bit as during the walk. At 80 registers ptxas spills one
// value to local memory, best_inst (a load and at most a store per visited
// instance, and a load at the end); both lists stay in registers
// (local_memory.py prints each local access with its source line).
template <bool SN>
__global__ void __launch_bounds__(kThreads)
closest_hit_tlas_kernel(const float* __restrict__ o,
                        const float* __restrict__ d, int R,
                        const float* __restrict__ p1,
                        const float* __restrict__ e1,
                        const float* __restrict__ e2,
                        const float* __restrict__ pay,
                        const float* __restrict__ caabb, int M, int cm,
                        int leaf, const float* __restrict__ inst_ab,
                        const float* __restrict__ inst_aabb,
                        const int* __restrict__ inst_mesh,
                        const int* __restrict__ inst_obj, int I, float eps,
                        float* __restrict__ t_out, int* __restrict__ enc_out,
                        int* __restrict__ obj_out, float* __restrict__ n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(o, d, i);
  float t_best = kBig;
  int best = -1, best_inst = -1;
  WalkList<kListK5> instances, clusters;
  ordered_walk<kListK5>(r, inst_aabb, 0, I, t_best, instances, [&](int k) {
    const int mi = __ldg(inst_mesh + k);
    if (mi < 0 || mi >= M) return;
    const float t_before = t_best;
    closest_in_clusters<kListK5>(instance_ray(r, inst_ab + 12 * k), p1, e1,
                                 e2, caabb, mi * cm, (mi + 1) * cm, leaf, eps,
                                 t_best, best, clusters);
    if (t_best < t_before) best_inst = k;
  });
  int enc = -1, obj = 0;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  if (best >= 0) {
    const float* ab = inst_ab + 12 * best_inst;
    const int tm = cm * leaf;
    enc = best_inst * tm + (best - __ldg(inst_mesh + best_inst) * tm);
    obj = __ldg(inst_obj + best_inst);
    hit_payload<SN>(instance_ray(r, ab), best, pay, p1, e1, e2, nx, ny, nz);
    normal_to_world(ab, nx, ny, nz);
  }
  t_out[i] = t_best;
  enc_out[i] = enc;
  obj_out[i] = obj;
  n_out[3 * i] = nx;
  n_out[3 * i + 1] = ny;
  n_out[3 * i + 2] = nz;
}

// K6: the occlusion walk one level up. The instance slots (the real
// instances in a k-d order of their boxes' centres, inst_perm; -1 marks a
// padding slot) in groups of 8: each group box, then each slot box of an
// entered group, then for each entered instance the walk over its mesh's
// groups (occluded) on the instance-space ray, built once an instance.
// That ray is not renormalized, so max_t bounds object-space t too. The
// lane stops at its first occluder; max_t <= 0 is a dead lane.
__global__ void __launch_bounds__(kThreads)
any_hit_tlas_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ max_t, int R, OccTables mesh,
                    int M, int cm, const float* __restrict__ inst_ab,
                    const int* __restrict__ inst_mesh,
                    const int* __restrict__ inst_perm,
                    const float* __restrict__ inst_box,
                    const float* __restrict__ inst_grp, int I, float eps,
                    uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float mt = max_t[i];
  bool hit = false;
  if (mt > 0.f) {
    const Ray r = load_ray(o, d, i);
    for (int g = 0; g * kGroup < I && !hit; ++g) {
      tally(kInstGroupTests);
      if (!enters(r, inst_grp, g, mt)) continue;
      const int s1 = min((g + 1) * kGroup, I);
      for (int s = g * kGroup; s < s1 && !hit; ++s) {
        tally(kInstTests);
        if (!enters(r, inst_box, s, mt)) continue;
        const int k = __ldg(inst_perm + s);
        if (k < 0) continue;
        const int mi = __ldg(inst_mesh + k);
        if (mi < 0 || mi >= M) continue;
        tally(kInstEntered);
        hit = occluded(instance_ray(r, inst_ab + 12 * k), mt, mesh, mi * cm,
                       (mi + 1) * cm, eps);
      }
    }
  }
  hit_out[i] = hit;
}

// ---- the elementwise cross-check backend: K7a and K7b ----
//
// rtc_tpu's _kernel and _anyhit_kernel are its debug backend
// (mesh_impl="pallas"), an independently structured traversal kept to
// cross-check the production kernels: a static three-level walk in TABLE
// order, superclusters of kSuperWidth clusters (super_aabb, their union
// boxes), then clusters, then each cluster's leaf rows, through the same
// pair test as K1. It reads the world table it is given and none of the
// other kernels' structures: no ordered walk, no occlusion tables. Since
// the pair test is shared, K7a's t equals K1's bit for bit on every ray,
// whatever the order.
//
// The tile walk. The TPU kernels gate a whole tile of rays on
// jnp.any(overlap) and test an entered cluster as an (RT, L) batch, rays
// by rows. Here the tile is a block of kTileK7 rays, one a thread for the
// box tests, and:
// - the gate is a block-wide vote (__syncthreads_or) over each lane's own
//   cull, entry < its bound (K7a: t_best; K7b: max_t on a live lane not yet
//   found), for each super in table order, then for each cluster of an
//   entered super; the block skips what no lane enters, in uniform control
//   flow. Every lane tests every super box it reaches, so the block widens
//   the super boxes once, as cluster_slab widens them, into shared memory
//   (kSupChunk at a time), and a lane's super test is the bare slab test;
// - VMEM becomes shared memory: each cluster that passes the vote is
//   copied once a block (cp.async, three contiguous slices of leaf x 12 B)
//   into a ring of two buffers. While the block tests one cluster, the copy
//   of the next cluster in table order that passes the vote under the
//   bounds of that moment is in flight. Once the tested cluster's results
//   are back in shared memory (a barrier), the lanes vote on the next one
//   again with their new bounds, and drop it if no lane still enters it;
// - the (RT, L) batch becomes a warp a ray: the block lists the lanes whose
//   ray entered the cluster (a ballot per warp, prefix offsets), its warps
//   take the listed rays in turn, and lane l tests rows l, l + 32, ... of
//   the staged cluster (SharedRows). K7a reduces (t, row) over the warp
//   lexicographically, least t and then least row: the earliest row at the
//   least t, which the table order's strict-< sequence keeps; across
//   clusters t_best still improves only by a strict <. K7b stops a ray after
//   the first 32-row round that finds an occluder (__any_sync), and the
//   block leaves its walk once every lane is found or dead
//   (__syncthreads_and), the TPU's found == 0.
// A warp a ray costs a warp-wide reduction (K7a) and the list; one ray a
// lane costs the lanes of a warp that did not enter the cluster. So a
// cluster whose entered lanes fill their warps densely (kK7LaneMin a warp on
// average, as coherent primary rays do) goes a lane a ray over the same
// staged rows, each lane on its own ray, and the block decides this per
// cluster from its counts. Measured on an H100 (PERF.md): one
// mapping alone lost on cow's primary rays (a warp a ray) or on the
// 4,088-cluster herd table (a lane a ray, barriers idling the warps with
// no entered lane), and the mix beat both.
//
// Bits. A cull that never drops a row hitting before the running bound
// leaves K7a's (t, idx) at the earliest row of least t over the whole table
// (the plain sweep's), and K7b's flag at the OR of its pair tests, in any
// order of visits: the cluster boxes are widened as cluster_slab widens, and
// a super box holds its clusters'. The staged rows hand the pair test the
// same f32 values, and the staged super boxes are widened with the same
// operations, so every output equals the plain sweep's bit for bit.

constexpr int kSuperWidth = 8;    // mesh_intersect.py SUPER_WIDTH
constexpr int kTileK7 = 256;      // rays a block: a 16x16 screen block's worth
constexpr int kTileWarps = kTileK7 / 32;
constexpr int kMaxLeafK7 = 1024;  // rows a cluster, the most K7 stages
static_assert(kTileK7 % 32 == 0 && kTileK7 <= 1024, "a tile is whole warps");
constexpr int kNoRow = 0x7fffffff;
// A tested cluster goes a lane a ray when its entered lanes average at
// least kK7LaneMin in the warps holding any of them, else a warp a ray.
constexpr int kK7LaneMin = 28;
constexpr int kSupChunk = 512;  // widened super boxes a block stages at a time

// The dynamic shared memory of a K7 block: two staged clusters.
inline size_t elementwise_smem(int leaf) { return 2 * 9 * (size_t)leaf * sizeof(float); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cluster_entry on a box widened already (a block's staged supers); w[0] >
// w[3] marks an empty box.
__device__ __forceinline__ float widened_entry(const Ray& r, const float* w) {
  if (w[0] > w[3]) return kBig;
  float tmin, tmax;
  widened_slab(r, w, tmin, tmax);
  if (!(tmax >= tmin && tmax >= 0.f)) return kBig;
  return fmaxf(tmin, 0.f);
}

// Starts the copy of cluster c's rows into buf (SharedRows' layout) and
// commits it as one group of this thread's copies; every thread copies the
// same chunks each time. vec16: 16-byte copies (leaf % 4 == 0 and 16-byte
// aligned tables), else 4-byte ones.
__device__ __forceinline__ void stage_cluster(float* buf, const float* __restrict__ p1,
                                              const float* __restrict__ e1,
                                              const float* __restrict__ e2, int c,
                                              int leaf, bool vec16) {
  const int n = 3 * leaf;
  const size_t at = (size_t)c * n;
  const float* const src[3] = {p1 + at, e1 + at, e2 + at};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (vec16) {
      for (int k = 4 * threadIdx.x; k < n; k += 4 * kTileK7)
        cp_async16(buf + a * n + k, src[a] + k);
    } else {
      for (int k = threadIdx.x; k < n; k += kTileK7) cp_async4(buf + a * n + k, src[a] + k);
    }
  }
  cp_async_commit();
}

// The counting build's tallies of one 32-row round of ray i (stage < 0: the
// lane held no row): its pair tests by stage, the round, and its lanes with
// a row. Lane 0 adds them.
__device__ __forceinline__ void count_round(int i, int stage, int lane) {
#ifdef RTC_COUNT
  const unsigned held = __ballot_sync(0xffffffffu, stage >= 0);
  if (lane == 0) {
    tally_at(i, kRounds, 1);
    tally_at(i, kRoundLanes, __popc(held));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = __ballot_sync(0xffffffffu, stage == k);
    if (lane == 0) tally_at(i, kPairDet + k, __popc(b));
  }
#endif
}

// K7a (ANY = false): t (BIG on a miss) and idx (-1; the earliest row in
// table order at the least t). K7b (ANY = true): any triangle at t in [0,
// max_t)? max_t <= 0 (or NaN) is a dead lane, which loads no ray.
template <bool ANY>
__global__ void __launch_bounds__(kTileK7)
elementwise_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ max_t, int R,
                   const float* __restrict__ p1, const float* __restrict__ e1,
                   const float* __restrict__ e2, const float* __restrict__ aabb,
                   int C, const float* __restrict__ sup, int leaf, float eps,
                   int vec16, float* __restrict__ t_out, int* __restrict__ idx_out,
                   uint8_t* __restrict__ hit_out) {
  extern __shared__ float4 k7_rows[];       // the ring: 2 x 9 * leaf floats
  __shared__ float s_ray[6][kTileK7];       // each lane's o, d
  __shared__ float s_bound[kTileK7];        // each lane's bound (below)
  __shared__ int s_best[kTileK7];           // K7a: its best row; K7b: found
  __shared__ int s_list[kTileK7];           // the lanes that entered the cluster
  __shared__ int s_count[kTileWarps];       // the listed lanes of each warp
  __shared__ float s_sup[kSupChunk][6];     // a chunk of widened super boxes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kTileK7 + tid;
  // A lane culls every box it enters at or beyond its bound, and tests no
  // box once the bound is <= 0: K7a's t_best; K7b's max_t, or -1 on a dead
  // lane and once found; -1 on the padding lanes of a ragged last tile.
  float bound = -1.f;
  if (i < R) {
    if (ANY) {
      const float mt = max_t[i];
      bound = mt > 0.f ? mt : -1.f;
    } else {
      bound = kBig;
    }
  }
  const Ray r = bound > 0.f ? load_ray(o, d, i) : make_ray(0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  s_ray[0][tid] = r.ox; s_ray[1][tid] = r.oy; s_ray[2][tid] = r.oz;
  s_ray[3][tid] = r.dx; s_ray[4][tid] = r.dy; s_ray[5][tid] = r.dz;
  s_bound[tid] = bound;
  s_best[tid] = ANY ? 0 : -1;
  float* const ring = reinterpret_cast<float*>(k7_rows);
  const int span = 9 * leaf;

  // The scan: from cluster c on, in table order, the first cluster some
  // lane enters before its bound, or C. A vote for each super reached (the
  // lane's verdict on the current super, sup_in, is kept across calls, so
  // each super box is tested once) and one for each cluster of an entered
  // super. e: the lane's entry into the cluster found (kBig: none).
  int sup_s = -1, sup_chunk = -1;
  bool sup_in = false;
  const int S = (C + kSuperWidth - 1) / kSuperWidth;
  auto scan = [&](int c, float& e) -> int {
    for (; c < C; ++c) {
      const int s = c / kSuperWidth;
      if (s != sup_s) {
        sup_s = s;
        sup_in = false;
        if (s / kSupChunk != sup_chunk) {  // stage the next chunk of supers
          sup_chunk = s / kSupChunk;
          __syncthreads();  // no lane still reads the last chunk
          const int base = sup_chunk * kSupChunk;
          for (int k = tid; k < kSupChunk && base + k < S; k += kTileK7) {
            if (!widened_box(sup, base + k, s_sup[k])) {
              s_sup[k][0] = 1.f;
              s_sup[k][3] = -1.f;
            }
          }
          __syncthreads();
        }
        if (bound > 0.f) {
          tally(kSuperTests);
          sup_in = widened_entry(r, s_sup[s % kSupChunk]) < bound;
          if (sup_in) tally(kSupersEntered);
        }
        if (!__syncthreads_or(sup_in)) {
          c = (s + 1) * kSuperWidth - 1;
          continue;
        }
      }
      e = kBig;
      if (sup_in && bound > 0.f) {
        tally(kClusterTests);
        e = cluster_entry(r, aabb, c);
      }
      if (__syncthreads_or(e < bound)) return c;
    }
    return C;
  };

  int cur = C;
  float e_cur = kBig;
  if (!ANY || !__syncthreads_and(!(bound > 0.f))) cur = scan(0, e_cur);
  int b = 0;
  if (cur < C) stage_cluster(ring, p1, e1, e2, cur, leaf, vec16);
  while (cur < C) {
    // the vote again, on the bounds the last tested cluster left
    const bool mine = e_cur < bound;
    if (!__syncthreads_or(mine)) {  // no lane enters it now: drop its copy
      cp_async_wait<0>();
      cur = scan(cur + 1, e_cur);
      if (cur < C) stage_cluster(ring + b * span, p1, e1, e2, cur, leaf, vec16);
      continue;
    }
    if (mine) tally(kClustersEntered);
    float e_next = kBig;
    const int next = scan(cur + 1, e_next);
    if (next < C) {
      stage_cluster(ring + (b ^ 1) * span, p1, e1, e2, next, leaf, vec16);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();  // cur's rows and the counts are in
    const SharedRows rows{ring + b * span, 3 * leaf};
    int first = 0, n = 0, warps = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int k = s_count[w];
      first += w < warp ? k : 0;
      n += k;
      warps += k > 0;
    }
    const bool by_lane = n >= kK7LaneMin * warps;
    if (tid == 0) {
      tally(kTileClusters);
      if (by_lane) tally(kTileByLane);
      tally_at(i, kTileSlots, by_lane ? 32 * warps
                                      : kTileWarps * ((n + kTileWarps - 1) / kTileWarps));
    }
    if (by_lane) {
      if (mine) {
        float bt = bound;
        int bj = -1;
        for (int j = 0; j < leaf; ++j) {
          float t;
          const int stage = pair_stage(r, rows, j, eps, t);
          tally(kPairDet + stage);
          if (stage == kCrosses && t >= 0.f && t < bt) {
            bt = t;
            bj = j;
            if (ANY) break;
          }
        }
        if (bj >= 0) {
          s_bound[tid] = ANY ? -1.f : bt;
          s_best[tid] = ANY ? 1 : cur * leaf + bj;
        }
      }
    } else {
      if (mine) s_list[first + __popc(ballot & ((1u << lane) - 1u))] = tid;
      __syncthreads();  // the list is in
      for (int k = warp; k < n; k += kTileWarps) {
        const int q = s_list[k];
        const int iq = blockIdx.x * kTileK7 + q;
        Ray rq;  // the pair test reads o and d only
        rq.ox = s_ray[0][q]; rq.oy = s_ray[1][q]; rq.oz = s_ray[2][q];
        rq.dx = s_ray[3][q]; rq.dy = s_ray[4][q]; rq.dz = s_ray[5][q];
        rq.ix = rq.iy = rq.iz = 0.f;
        const float bq = s_bound[q];
        if (ANY) {
          bool hit = false;
          for (int j0 = 0; j0 < leaf && !hit; j0 += 32) {
            const int j = j0 + lane;
            int stage = -1;
            bool h = false;
            if (j < leaf) {
              float t;
              stage = pair_stage(rq, rows, j, eps, t);
              h = stage == kCrosses && t >= 0.f && t < bq;
            }
            count_round(iq, stage, lane);
            hit = __any_sync(0xffffffffu, h);
          }
          if (hit && lane == 0) {
            s_bound[q] = -1.f;
            s_best[q] = 1;
          }
        } else {
          float bt = bq;
          int bj = kNoRow;
  #pragma unroll 4
          for (int j0 = 0; j0 < leaf; j0 += 32) {
            const int j = j0 + lane;
            int stage = -1;
            if (j < leaf) {
              float t;
              stage = pair_stage(rq, rows, j, eps, t);
              if (stage == kCrosses && t >= 0.f && t < bt) {
                bt = t;
                bj = j;
              }
            }
            count_round(iq, stage, lane);
          }
          // The warp's least (t, row): t >= 0 and finite here, so its bits
          // with the sign cleared order as t does (and -0 ties with +0); the
          // least row among the lanes at that key; its t from the lane that
          // holds that row (row % 32), with its own sign.
          const unsigned key = bj == kNoRow ? 0xffffffffu : __float_as_uint(bt) & 0x7fffffffu;
          const unsigned least = __reduce_min_sync(0xffffffffu, key);
          if (least != 0xffffffffu) {
            const int row = (int)__reduce_min_sync(0xffffffffu,
                                                   key == least ? (unsigned)bj : 0xffffffffu);
            const float t = __shfl_sync(0xffffffffu, bt, row & 31);
            if (lane == 0) {
              s_bound[q] = t;
              s_best[q] = cur * leaf + row;
            }
          }
        }
      }
    }
    __syncthreads();  // every listed ray's result is in
    bound = s_bound[tid];
    if (ANY && __syncthreads_and(!(bound > 0.f))) break;  // all found or dead
    cur = next;
    e_cur = e_next;
    b ^= 1;
  }
  cp_async_wait<0>();
  if (i >= R) return;
  if (ANY) {
    hit_out[i] = s_best[tid] != 0;
  } else {
    t_out[i] = bound;
    idx_out[i] = s_best[tid];
  }
}

// The object rows' sum: the gradient of object_record's gather of its
// parameter fields (render/integrator.py ObjectRows), each (R, width)
// gradient summed by the rays' object ids into its (O, width) table. It
// replaces no TPU kernel: it replaces the index_add_ that index_select's
// backward is, which adds every ray's columns by atomics into O rows, so
// the rays of one object wait on each other at the same few addresses
// (glass_teapot.fit: 19.35 ms a step, PERF.md). The work is R (K + 1) reads
// and R K adds, far under a millisecond at the card's bytes per second;
// what bounded the atomics was their order, not the bytes.
//
// Design: no atomics, and a fixed order, so the sums are the same bits
// from run to run. Pass 1 cuts the rays into one contiguous chunk a block
// (kRowsBlocksPerSM blocks an SM). A warp takes 32 rays at a time: for
// each object id among its lanes (one in a coherent warp), the lanes of
// that id add their column into a butterfly sum across the warp, and one
// lane a column adds it into the warp's own accumulator in shared memory.
// The block sums its warps' accumulators in warp order into its partial,
// scratch the wrapper takes from the torch allocator (so a CUDA graph
// captures the launch). Pass 2 gives each (object, column) a warp, whose
// lanes sum the blocks' partials in a fixed stride and then across the
// warp, and writes the field's table. O == 1 reads no ids. The
// accumulators hold one tile of the O x K table: all of it where its
// kRowsWarps copies fit a block's shared memory (2 x 3 in the fit cells,
// 90 x 16 under DEFAULT_PARAMS), else a few columns, and a few rows past
// that; each tile is a pass 1 and a pass 2 over all the rays.
constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsBlocksPerSM = 8;  // 2,048 threads, the most an SM holds
constexpr int kMaxRowFields = 12;

struct RowFields {
  const float* g[kMaxRowFields];  // (R, width[k]) gradients
  float* out[kMaxRowFields];      // (O, width[k]) sums
  int width[kMaxRowFields];
  int n;                          // fields
};

struct RowTile {
  int o0, rows;  // objects [o0, o0 + rows)
  int c0, cols;  // columns [c0, c0 + cols) of the fields side by side
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;  // every lane holds the same bits (a + b == b + a)
}

__global__ void __launch_bounds__(kRowsThreads)
object_rows_partial_kernel(const int* __restrict__ ids, int R, RowFields f, RowTile t,
                           int chunk, float* __restrict__ partial) {
  extern __shared__ float rows_acc[];  // [kRowsWarps][t.rows][t.cols]
  const int OK = t.rows * t.cols;
  for (int e = threadIdx.x; e < kRowsWarps * OK; e += kRowsThreads) rows_acc[e] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* own = rows_acc + warp * OK;
  const int first = (int)blockIdx.x * chunk;
  const int end = min(R, first + chunk);
  for (int base = first + warp * 32; base < end; base += kRowsThreads) {
    const int r = base + lane;
    int id = -1;  // the ray's row in the tile, or -1
    if (r < end) {
      id = (ids == nullptr ? 0 : ids[r]) - t.o0;
      if (id >= t.rows) id = -1;
    }
    unsigned todo = __ballot_sync(0xffffffffu, id >= 0);
    while (todo) {
      const int o = __shfl_sync(0xffffffffu, id, __ffs(todo) - 1);
      const bool in = id == o;
      todo &= ~__ballot_sync(0xffffffffu, in);
      for (int k = 0, c = -t.c0; k < f.n && c < t.cols; ++k) {
        const float* g = f.g[k];
        const int w = f.width[k];
        for (int j = 0; j < w; ++j, ++c) {
          if (c < 0 || c >= t.cols) continue;
          const float s = warp_sum(in ? g[(size_t)r * w + j] : 0.f);
          if (lane == (c & 31)) own[o * t.cols + c] += s;
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < OK; e += kRowsThreads) {
    float s = rows_acc[e];
    for (int w = 1; w < kRowsWarps; ++w) s += rows_acc[w * OK + e];
    partial[(size_t)blockIdx.x * OK + e] = s;
  }
}

__global__ void __launch_bounds__(kRowsThreads)
object_rows_total_kernel(const float* __restrict__ partial, int blocks, RowFields f,
                         RowTile t) {
  const int OK = t.rows * t.cols;
  const int e = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (e >= OK) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += partial[(size_t)b * OK + e];
  s = warp_sum(s);
  if (lane == 0) {
    const int o = t.o0 + e / t.cols;
    int c = t.c0 + e % t.cols, k = 0;
    while (c >= f.width[k]) c -= f.width[k++];
    f.out[k][(size_t)o * f.width[k] + c] = s;
  }
}

// ---------------------------------------------------------------------------
// The analytic prims' sweep (no TPU counterpart: rtc_tpu sweeps its prims
// in XLA, integrator.py :64-105, as the plain version ops/intersect.py
// prims() does, every kind on every prim and ray, padded to 4 slots).
// render/integrator.py closest_hit and is_shadowed launch it where the plan
// says so, once a shading node each. One thread a ray. The block stages the
// prims' tables (inverse (N, 3, 4), kind, ymin, ymax, capped) in shared
// memory, kPrimTile prims at a time, and each ray loops over them in
// order: the ray into the prim's object space in affine3's order
// (((m0 x + m1 y) + m2 z) + m3), then only that prim's kind's slots (the
// branch is uniform: every thread of the block reads the same prim), with
// ops/intersect.py's formulas in their order, reduced in registers.
// ANY = false: the first least t over prims, then slots, of the valid
// slots with t >= 0 (BIG elsewhere, pad slots too), argmin's answer over
// the plain version's (R, 4N) row, so (BIG, 0) where none is. ANY: does a
// valid slot lie at 0 <= t < max_t (max_t -1 on a dead lane: never)?
// torch.minimum and torch.maximum keep a NaN; so do nan_min and nan_max.
// What bounds it: bytes, the rays read once (24 B a ray in float32, 4 more
// for max_t) and the results written once (8 B, or a 1-byte flag), against
// a few hundred operations a ray and prim; the plain version writes and
// reads some 20 kB a ray through ~340 launches at one prim.
constexpr int kPrimTile = 128;     // prims a block stages at a time
constexpr double kBigD = 1e30;     // BIG in the rays' type (constants.py)

__device__ __forceinline__ float abs_s(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_s(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_s(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_s(double x) { return sqrt(x); }
__device__ __forceinline__ float fmin_s(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_s(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fmax_s(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_s(double a, double b) { return fmax(a, b); }

template <typename S>
__device__ __forceinline__ S nan_min(S a, S b) {  // torch.minimum
  if (a != a) return a;
  if (b != b) return b;
  return fmin_s(a, b);
}

template <typename S>
__device__ __forceinline__ S nan_max(S a, S b) {  // torch.maximum
  if (a != a) return a;
  if (b != b) return b;
  return fmax_s(a, b);
}

template <typename S>
struct PrimRow {
  S m[12];  // world -> object, row-major (3, 4)
  S ymin, ymax;
  int kind;  // intersect.py SPHERE .. CONE
  bool capped;
};

template <typename S>
struct PrimSlots {
  S t[4];
  bool v[4];
};

// intersect._quadratic: both roots, valid iff disc >= 0
template <typename S>
__device__ __forceinline__ bool prim_quadratic(S a, S b, S c, S& t0, S& t1) {
  const S disc = b * b - S(4) * a * c;
  const S sq = disc > S(0) ? sqrt_s(disc) : S(0);
  const S denom = abs_s(a) > S(0) ? S(2) * a : S(1);
  t0 = (-b - sq) / denom;
  t1 = (-b + sq) / denom;
  return disc >= S(0);
}

// intersect._check_axis on the +-1 slab
template <typename S>
__device__ __forceinline__ void prim_axis(S o1, S d1, S eps, S& tmin, S& tmax) {
  const S num_lo = S(-1) - o1;
  const S num_hi = S(1) - o1;
  const bool parallel = abs_s(d1) < eps;
  const S ds = parallel ? S(1) : d1;
  const S ta = num_lo / ds;
  const S tb = num_hi / ds;
  const S big = static_cast<S>(kBigD);
  tmin = parallel ? (num_lo <= S(0) ? -big : big) : nan_min(ta, tb);
  tmax = parallel ? (num_hi >= S(0) ? big : -big) : nan_max(ta, tb);
}

// intersect._check_cap
template <typename S>
__device__ __forceinline__ bool prim_cap(const S* o, const S* d, S t) {
  const S x = o[0] + t * d[0];
  const S y = o[1] + t * d[1];
  const S z = o[2] + t * d[2];
  return x * x + z * z <= abs_s(y);
}

// intersect._caps into slots 2 and 3
template <typename S>
__device__ __forceinline__ void prim_caps(const PrimRow<S>& p, const S* o, const S* d,
                                          S eps, PrimSlots<S>& h) {
  const bool dy_ok = abs_s(d[1]) >= eps;
  const S dy = dy_ok ? d[1] : S(1);
  h.t[2] = (p.ymin - o[1]) / dy;
  h.t[3] = (p.ymax - o[1]) / dy;
  const bool on = p.capped && dy_ok;
  h.v[2] = on && prim_cap(o, d, h.t[2]);
  h.v[3] = on && prim_cap(o, d, h.t[3]);
}

// The slots of prim p's own kind for a ray o, d in its object space;
// the plain version's pads: t 0, invalid.
template <typename S>
__device__ __forceinline__ PrimSlots<S> prim_slots(const PrimRow<S>& p, const S* o,
                                                   const S* d, S eps) {
  PrimSlots<S> h;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    h.t[s] = S(0);
    h.v[s] = false;
  }
  switch (p.kind) {
    case 0: {  // sphere
      const S a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const S b = S(2) * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
      const S c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - S(1);
      h.v[0] = h.v[1] = prim_quadratic(a, b, c, h.t[0], h.t[1]);
      break;
    }
    case 1: {  // plane
      h.v[0] = abs_s(d[1]) >= eps;
      h.t[0] = -o[1] / (h.v[0] ? d[1] : S(1));
      break;
    }
    case 2: {  // cube
      S xl, xh, yl, yh, zl, zh;
      prim_axis(o[0], d[0], eps, xl, xh);
      prim_axis(o[1], d[1], eps, yl, yh);
      prim_axis(o[2], d[2], eps, zl, zh);
      h.t[0] = nan_max(nan_max(xl, yl), zl);
      h.t[1] = nan_min(nan_min(xh, yh), zh);
      h.v[0] = h.v[1] = h.t[1] >= h.t[0];
      break;
    }
    case 3: {  // cylinder
      const S a = d[0] * d[0] + d[2] * d[2];
      const bool wall = abs_s(a) >= eps;
      const S b = S(2) * (o[0] * d[0] + o[2] * d[2]);
      const S c = o[0] * o[0] + o[2] * o[2] - S(1);
      const bool ok = prim_quadratic(wall ? a : S(1), b, c, h.t[0], h.t[1]);
      const S y0 = o[1] + h.t[0] * d[1];
      const S y1 = o[1] + h.t[1] * d[1];
      h.v[0] = wall && ok && p.ymin < y0 && y0 < p.ymax;
      h.v[1] = wall && ok && p.ymin < y1 && y1 < p.ymax;
      prim_caps(p, o, d, eps, h);
      break;
    }
    case 4: {  // cone
      const S a = d[0] * d[0] - d[1] * d[1] + d[2] * d[2];
      const S b = S(2) * (o[0] * d[0] - o[1] * d[1] + o[2] * d[2]);
      const S c = o[0] * o[0] - o[1] * o[1] + o[2] * o[2];
      const bool a_zero = abs_s(a) < eps;
      const bool b_ok = abs_s(b) >= eps;
      const S t_lin = -c / (b_ok ? S(2) * b : S(1));
      S t0, t1;
      const bool ok = prim_quadratic(a_zero ? S(1) : a, b, c, t0, t1);
      const S t_sm = nan_min(t0, t1);
      const S t_lg = nan_max(t0, t1);
      const S y0 = o[1] + t_sm * d[1];
      const S y1 = o[1] + t_lg * d[1];
      h.t[0] = a_zero ? t_lin : t_sm;
      h.v[0] = a_zero ? b_ok : (ok && p.ymin < y0 && y0 < p.ymax);
      h.t[1] = t_lg;
      h.v[1] = !a_zero && ok && p.ymin < y1 && y1 < p.ymax;
      prim_caps(p, o, d, eps, h);
      break;
    }
    default:
      break;
  }
  return h;
}

template <typename S, bool ANY>
__global__ void __launch_bounds__(kThreads)
prim_sweep_kernel(const S* __restrict__ o, const S* __restrict__ d,
                  const S* __restrict__ max_dist, int R, const S* __restrict__ inv,
                  const int* __restrict__ kind, const S* __restrict__ params, int N,
                  S eps, S* __restrict__ t_out, int* __restrict__ prim_out,
                  uint8_t* __restrict__ hit_out) {
  __shared__ PrimRow<S> tile[kPrimTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < R;
  S wo[3] = {S(0), S(0), S(0)}, wd[3] = {S(0), S(0), S(0)};
  S lim = S(-1);
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wo[k] = o[3 * (size_t)i + k];
      wd[k] = d[3 * (size_t)i + k];
    }
    if (ANY) lim = max_dist[i];
  }
  const S big = static_cast<S>(kBigD);
  S best = S(INFINITY);  // argmin: the first element always replaces it
  int best_p = 0;
  bool hit = false;
  for (int base = 0; base < N; base += kPrimTile) {
    const int n = min(kPrimTile, N - base);
    __syncthreads();  // the previous tile is read
    for (int e = threadIdx.x; e < n; e += kThreads) {
      PrimRow<S>& p = tile[e];
      const size_t r = (size_t)(base + e);
#pragma unroll
      for (int k = 0; k < 12; ++k) p.m[k] = inv[12 * r + k];
      p.ymin = params[3 * r];
      p.ymax = params[3 * r + 1];
      p.capped = params[3 * r + 2] > S(0.5);
      p.kind = kind[r];
    }
    __syncthreads();
    if (!live || (ANY && hit)) continue;
    for (int j = 0; j < n; ++j) {
      const PrimRow<S>& p = tile[j];
      S lo[3], ld[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const S* m = p.m + 4 * k;
        lo[k] = m[0] * wo[0] + m[1] * wo[1] + m[2] * wo[2] + m[3];
        ld[k] = m[0] * wd[0] + m[1] * wd[1] + m[2] * wd[2];
      }
      const PrimSlots<S> h = prim_slots(p, lo, ld, eps);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (ANY) {
          hit = hit || (h.v[s] && h.t[s] >= S(0) && h.t[s] < lim);
        } else {
          const S tt = h.v[s] && h.t[s] >= S(0) ? h.t[s] : big;
          if (tt < best) {
            best = tt;
            best_p = base + j;
          }
        }
      }
      if (ANY && hit) break;
    }
  }
  if (!live) return;
  if (ANY) {
    hit_out[i] = hit;
  } else {
    t_out[i] = best;
    prim_out[i] = best_p;
  }
}

// ---------------------------------------------------------------------------
// A bounce node's shading (no TPU counterpart: rtc_tpu shades in XLA,
// integrator.py :1114-1262). render/integrator.py color_at launches it
// three times a node around the searches, where the plan says so and
// autograd has nothing to record; the plain versions are ops/shading.py's:
//   kShadeSurface  after the closest hit: the hit's frame and its shadow
//                  query, the over point toward the light, parked where the
//                  lane is dead (shading.surface)
//   kShadeNode     after the shadow flag and the census: the base colour,
//                  Phong, and the children's parked rays and blend weights,
//                  or a childless node's final colour (shading.node)
//   kShadeBlend    after the children: their colours blended onto the
//                  surface colour (shading.blend_colors)
// One thread a ray, every intermediate in registers. A ray evaluates only
// its hit prim's own kind of normal (ops/normals.py) and only its object's
// own pattern (ops/patterns.py), with the plain versions' formulas in their
// order, where the plain versions evaluate every kind and pattern on every
// ray and select by mask. With -fmad=false and PyTorch's own definitions
// (torch.remainder: fmod, then the divisor added where the signs differ;
// clamp_min and clamp_max keep a NaN; x ** y is pow, x ** 2 is x * x;
// 1 / sqrt), each output rounds as the plain version's. Each ray reads
// its own prim's and object's rows through the read-only cache (staging a
// scene's rows in shared memory measured no faster on the H100). What
// bounds it: bytes, each ray's inputs read and its
// outputs written once, against some hundred operations a ray; the plain
// versions make some 200 elementwise passes a node over (R,) tensors.
constexpr int kShadeThreads = 256;
enum ShadeStage { kShadeSurface = 0, kShadeNode = 1, kShadeBlend = 2 };
// ShadeNode's flags (mesh_intersect.py SHADE_FLAGS)
enum ShadeFlag { kBranchR = 1, kBranchT = 2, kBlendFlag = 4, kPattern = 8 };
// utils/constants.py FAR, PARK; ops/patterns.py PATTERN_EPS; materials.py NONE
constexpr double kFarD = 1e12, kParkD = 0.5773502692, kPatternEpsD = 1e-4;
constexpr int kPatNone = -1;

__device__ __forceinline__ float floor_s(float x) { return floorf(x); }
__device__ __forceinline__ double floor_s(double x) { return floor(x); }
__device__ __forceinline__ float fmod_s(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_s(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float pow_s(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_s(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float ldg_s(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg_s(const double* p) { return __ldg(p); }

template <typename S>
struct ShadePrim {
  S m[12];  // world -> object, row-major (3, 4)
  S mt[9];  // the inverse-transpose's linear part (3, 3)
  S ymin, ymax;
  int kind;  // intersect.py SPHERE .. CONE
};

template <typename S>
struct ShadeObject {
  S a[3], b[3];
  S m[12];  // pattern_inv @ object_inv, row-major (3, 4)
  S color[3];
  S ambient, diffuse, specular, shininess, reflective, transparency;
  int kind;  // materials.py NONE .. TEST
};

// The scene's rows (shading.Prims, shading.Objects) and light; N may be 0.
template <typename S>
struct ShadeTables {
  const S* inv;
  const S* invT;
  const int* kind;
  const S* params;
  int N;
  const int* pat_kind;
  const S* pat_a;
  const S* pat_b;
  const S* pat_inv;
  const S* color;
  const S* ambient;
  const S* diffuse;
  const S* specular;
  const S* shininess;
  const S* reflective;
  const S* transparency;
  int O;
  const S* light;      // (3,) position
  const S* intensity;  // (3,)
};

// A stage's per-ray inputs, (R, ...) each; null where the stage reads none
// (shadowed: lit; n1, n2: 1).
template <typename S>
struct ShadeRays {
  const S* o;
  const S* d;
  const S* t;
  const uint8_t* valid;
  const uint8_t* is_tri;
  const int* prim;
  const S* tri_n;
  const int* obj;
  const uint8_t* shadowed;
  const S* n1;
  const S* n2;
  const S* surface;  // kShadeBlend: the surface colour
  const S* refl;     // the children's colours
  const S* refr;
  const S* weights;  // (R, 4) reflective, transparency, 1 - tir, reflectance
};

// A stage's outputs. kShadeSurface: origin (R, 3), direction (R, 3),
// distance (R,). kShadeNode: colour (R, 3), reflection o and d, refraction
// o and d (R, 3) each, weights (R, 4). kShadeBlend: colour (R, 3).
template <typename S>
struct ShadeOut {
  S* out[6];
};

template <typename S>
__device__ __forceinline__ ShadePrim<S> load_shade_prim(const ShadeTables<S>& tb, int p) {
  ShadePrim<S> r;
  const size_t i = (size_t)p;
#pragma unroll
  for (int k = 0; k < 12; ++k) r.m[k] = ldg_s(tb.inv + 12 * i + k);
#pragma unroll
  for (int k = 0; k < 9; ++k) r.mt[k] = ldg_s(tb.invT + 9 * i + k);
  r.ymin = ldg_s(tb.params + 3 * i);
  r.ymax = ldg_s(tb.params + 3 * i + 1);
  r.kind = __ldg(tb.kind + i);
  return r;
}

template <typename S>
__device__ __forceinline__ ShadeObject<S> load_shade_object(const ShadeTables<S>& tb, int e) {
  ShadeObject<S> r;
  const size_t i = (size_t)e;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.a[k] = ldg_s(tb.pat_a + 3 * i + k);
    r.b[k] = ldg_s(tb.pat_b + 3 * i + k);
    r.color[k] = ldg_s(tb.color + 3 * i + k);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) r.m[k] = ldg_s(tb.pat_inv + 12 * i + k);
  r.ambient = ldg_s(tb.ambient + i);
  r.diffuse = ldg_s(tb.diffuse + i);
  r.specular = ldg_s(tb.specular + i);
  r.shininess = ldg_s(tb.shininess + i);
  r.reflective = ldg_s(tb.reflective + i);
  r.transparency = ldg_s(tb.transparency + i);
  r.kind = __ldg(tb.pat_kind + i);
  return r;
}

// vec.py normalize3: a zero (or NaN) square stays zero
template <typename S>
__device__ __forceinline__ void shade_normalize(S* v) {
  const S sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const S inv = sq > S(0) ? S(1) / sqrt_s(sq) : S(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = v[k] * inv;
}

// shading.hit_normal on a prim: its own kind's object-space normal
// (normals.py) at the affine3 of p, through the inverse-transpose,
// normalized. An unknown kind is the sphere's, as the plain select leaves it.
template <typename S>
__device__ __forceinline__ void prim_normal(const ShadePrim<S>& q, const S* p, S eps, S* n) {
  S l[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const S* m = q.m + 4 * k;
    l[k] = m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3];
  }
  S nl[3] = {l[0], l[1], l[2]};
  switch (q.kind) {
    case 1:  // plane
      nl[0] = S(0); nl[1] = S(1); nl[2] = S(0);
      break;
    case 2: {  // cube: the largest |component|, ties x, then y, then z
      const S ax = abs_s(l[0]), ay = abs_s(l[1]), az = abs_s(l[2]);
      const S maxc = nan_max(nan_max(ax, ay), az);
      const bool is_x = ax == maxc;
      const bool is_y = !is_x && ay == maxc;
      nl[0] = is_x ? l[0] : S(0);
      nl[1] = is_y ? l[1] : S(0);
      nl[2] = is_x || is_y ? S(0) : l[2];
      break;
    }
    case 3: {  // cylinder: the caps within unit radius and eps of their plane
      const S dist = l[0] * l[0] + l[2] * l[2];
      const bool top = dist < S(1) && l[1] >= q.ymax - eps;
      const bool bottom = dist < S(1) && l[1] <= q.ymin + eps;
      nl[0] = top || bottom ? S(0) : l[0];
      nl[1] = top ? S(1) : (bottom ? S(-1) : S(0));
      nl[2] = top || bottom ? S(0) : l[2];
      break;
    }
    case 4: {  // cone
      const S s = l[0] * l[0] + l[2] * l[2];
      const S y = s > S(0) ? sqrt_s(s) : S(0);
      nl[1] = l[1] > S(0) ? -y : y;
      break;
    }
    default:  // sphere
      break;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const S* m = q.mt + 3 * k;
    n[k] = m[0] * nl[0] + m[1] * nl[1] + m[2] * nl[2];
  }
  shade_normalize(n);
}

// shading.surface_frame: the hit point p, the unit normal n flipped toward
// the eye -d, and the ray's direction d.
template <typename S>
struct ShadeFrame {
  S p[3], n[3], d[3];
};

template <typename S>
__device__ __forceinline__ ShadeFrame<S> shade_frame(const ShadeRays<S>& in,
                                                     const ShadeTables<S>& tb, int i,
                                                     bool valid, S eps) {
  ShadeFrame<S> f;
  const S ts = valid ? in.t[i] : S(1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.d[k] = in.d[3 * (size_t)i + k];
    f.p[k] = in.o[3 * (size_t)i + k] + f.d[k] * ts;
  }
  if (tb.N > 0 && !in.is_tri[i]) {
    const int pid = in.prim[i];
    prim_normal(load_shade_prim(tb, pid), f.p, eps, f.n);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) f.n[k] = in.tri_n[3 * (size_t)i + k];
  }
  const bool inside = (f.n[0] * -f.d[0] + f.n[1] * -f.d[1] + f.n[2] * -f.d[2]) < S(0);
  if (inside) {
#pragma unroll
    for (int k = 0; k < 3; ++k) f.n[k] = -f.n[k];
  }
  return f;
}

// normalize3(light - p) . n, lighting3's light_dot_normal and color_at's
// facing test; lv gets the unit light vector
template <typename S>
__device__ __forceinline__ S light_dot_normal(const ShadeFrame<S>& f, const S* light, S* lv) {
#pragma unroll
  for (int k = 0; k < 3; ++k) lv[k] = ldg_s(light + k) - f.p[k];
  shade_normalize(lv);
  return lv[0] * f.n[0] + lv[1] * f.n[1] + lv[2] * f.n[2];
}

// patterns.py _parity_even: torch.remainder(v, 2) == 0
template <typename S>
__device__ __forceinline__ bool parity_even(S v) {
  S mod = fmod_s(v, S(2));
  if (mod != S(0) && mod < S(0)) mod += S(2);
  return mod == S(0);
}

// patterns.color_at for one object's own kind at pattern-space point q
template <typename S>
__device__ __forceinline__ void pattern_color(const ShadeObject<S>& ob, const S* q, S* c) {
  const S pe = static_cast<S>(kPatternEpsD);
  int pick = -1;  // 0: a, 1: b
  switch (ob.kind) {
    case 0:  // stripe
      pick = parity_even(floor_s(q[0] + pe)) ? 0 : 1;
      break;
    case 1: {  // gradient
      const S frac = q[0] - floor_s(q[0]);
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] = ob.a[k] + (ob.b[k] - ob.a[k]) * frac;
      return;
    }
    case 2:  // ring
      pick = parity_even(floor_s(sqrt_s(q[0] * q[0] + q[2] * q[2]) + pe)) ? 0 : 1;
      break;
    case 3:  // checkers
      pick = parity_even(floor_s(q[0] + pe) + floor_s(q[1] + pe) + floor_s(q[2] + pe)) ? 0
                                                                                      : 1;
      break;
    case 4:  // test: the point itself
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] = q[k];
      return;
    default:
      break;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = pick == 0 ? ob.a[k] : (pick == 1 ? ob.b[k] : S(0));
}

// shading.blend_colors on one ray: where(valid, surface + secondary, 0)
template <typename S>
__device__ __forceinline__ void blend_out(bool valid, const S* surf, const S* refl,
                                          const S* refr, S reflective, S transparency,
                                          S reflectance, bool blend, S* out) {
  const bool both = blend && reflective > S(0) && transparency > S(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const S sec = both ? refl[k] * reflectance + refr[k] * (S(1) - reflectance)
                       : refl[k] + refr[k];
    out[k] = valid ? surf[k] + sec : S(0);
  }
}

template <typename S>
__device__ __forceinline__ void store3(S* out, int i, const S* v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * (size_t)i + k] = v[k];
}

template <typename S, int STAGE>
__global__ void __launch_bounds__(kShadeThreads)
shade_kernel(ShadeRays<S> in, int R, ShadeTables<S> tb, int flags, S eps,
             ShadeOut<S> out) {
  const int i = blockIdx.x * kShadeThreads + threadIdx.x;
  if (i >= R) return;
  const bool valid = in.valid[i];
  const S far = static_cast<S>(kFarD);

  if (STAGE == kShadeBlend) {  // shading.blend_colors
    const S* w = in.weights + 4 * (size_t)i;
    S surf[3], refl[3] = {S(0), S(0), S(0)}, refr[3] = {S(0), S(0), S(0)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      surf[k] = in.surface[3 * (size_t)i + k];
      if (flags & kBranchR) refl[k] = in.refl[3 * (size_t)i + k] * w[0];
      if (flags & kBranchT) refr[k] = in.refr[3 * (size_t)i + k] * w[1] * w[2];
    }
    S c[3];
    blend_out(valid, surf, refl, refr, w[0], w[1], w[3], (flags & kBlendFlag) != 0, c);
    store3(out.out[0], i, c);
    return;
  }

  const ShadeFrame<S> f = shade_frame(in, tb, i, valid, eps);
  S lv[3];
  const S ldn = light_dot_normal(f, tb.light, lv);

  if (STAGE == kShadeSurface) {  // shading.surface
    S over[3], v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      over[k] = valid ? f.p[k] + f.n[k] * eps : far;
      v[k] = ldg_s(tb.light + k) - over[k];
    }
    const S dist = sqrt_s(nan_max(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], S(1e-30)));
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] / dist;
    store3(out.out[0], i, over);
    store3(out.out[1], i, v);
    out.out[2][i] = valid && ldn >= S(0) ? dist : S(-1);
    return;
  }

  // kShadeNode: shading.node
  const ShadeObject<S> ob = load_shade_object(tb, in.obj[i]);
  S base[3];
  if ((flags & kPattern) && ob.kind != kPatNone) {
    S q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const S* m = ob.m + 4 * k;
      q[k] = m[0] * f.p[0] + m[1] * f.p[1] + m[2] * f.p[2] + m[3];
    }
    pattern_color(ob, q, base);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) base[k] = ob.color[k];
  }

  // lighting.lighting3
  const bool lit = !(in.shadowed && in.shadowed[i]) && ldn >= S(0);
  const S dl = ob.diffuse * ldn;
  const S kl = S(2) * (-lv[0] * f.n[0] + -lv[1] * f.n[1] + -lv[2] * f.n[2]);
  S r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = -lv[k] - f.n[k] * kl;
  const S rde = r[0] * -f.d[0] + r[1] * -f.d[1] + r[2] * -f.d[2];
  const bool spec_on = lit && rde > S(0);
  const S factor = pow_s(spec_on ? nan_max(rde, S(1e-30)) : S(1), ob.shininess);
  const S sf = ob.specular * factor;
  S surf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const S li = ldg_s(tb.intensity + k);
    const S ef = base[k] * li;
    const S df = lit ? ef * dl : S(0);
    const S sp_ = spec_on ? li * sf : S(0);
    surf[k] = ef * ob.ambient + df + sp_;
  }

  const S n1 = in.n1 ? in.n1[i] : S(1);
  const S n2 = in.n2 ? in.n2[i] : S(1);
  const S cos_i = -f.d[0] * f.n[0] + -f.d[1] * f.n[1] + -f.d[2] * f.n[2];
  const S park = static_cast<S>(kParkD);
  if (flags & kBranchR) {  // the reflection, from the over point
    const bool live = valid && ob.reflective > S(0);
    const S k2 = S(2) * (f.d[0] * f.n[0] + f.d[1] * f.n[1] + f.d[2] * f.n[2]);
    S ro[3], rd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ro[k] = live ? f.p[k] + f.n[k] * eps : far;
      rd[k] = live ? f.d[k] - f.n[k] * k2 : park;
    }
    store3(out.out[1], i, ro);
    store3(out.out[2], i, rd);
  }
  S notir = S(1);
  if (flags & kBranchT) {  // Snell's refraction, from the under point
    const S n_ratio = n1 / n2;
    const S sin2_t = n_ratio * n_ratio * (S(1) - cos_i * cos_i);
    const bool tir = sin2_t > S(1);
    const S c = S(1) - nan_min(sin2_t, S(1));
    const S cos_t = c > S(0) ? sqrt_s(c) : S(0);
    const S a = n_ratio * cos_i - cos_t;
    const bool live = valid && ob.transparency > S(0) && !tir;
    S to[3], td[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      to[k] = live ? f.p[k] - f.n[k] * eps : far;
      td[k] = live ? f.n[k] * a - -f.d[k] * n_ratio : park;
    }
    store3(out.out[3], i, to);
    store3(out.out[4], i, td);
    notir = tir ? S(0) : S(1);
  }
  S reflectance = S(0);
  if (flags & kBlendFlag) {  // shading.schlick
    const S n = n1 / n2;
    const S sin2_t = n * n * (S(1) - cos_i * cos_i);
    const bool tir = n1 > n2 && sin2_t > S(1);
    const S c = S(1) - nan_min(sin2_t, S(1));
    const S cos_t = c > S(0) ? sqrt_s(c) : S(0);
    const S cos_used = n1 > n2 ? cos_t : cos_i;
    S r0 = (n1 - n2) / (n1 + n2);
    r0 = r0 * r0;
    reflectance = tir ? S(1) : r0 + (S(1) - r0) * pow_s(S(1) - cos_used, S(5));
  }
  if (!(flags & (kBranchR | kBranchT))) {  // no child: the final colour
    const S zero[3] = {S(0), S(0), S(0)};
    S c[3];
    blend_out(valid, surf, zero, zero, ob.reflective, ob.transparency, reflectance,
              (flags & kBlendFlag) != 0, c);
    store3(out.out[0], i, c);
    return;
  }
  store3(out.out[0], i, surf);
  S* w = out.out[5] + 4 * (size_t)i;
  w[0] = ob.reflective;
  w[1] = ob.transparency;
  w[2] = notir;
  w[3] = reflectance;
}

template <typename S, int STAGE>
int launch_shade(void* stream, int R, const void* const* in, const void* const* tabs,
                 int N, int O, int flags, double eps, void* const* outs) {
  auto s = [](const void* p) { return static_cast<const S*>(p); };
  auto b = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto n = [](const void* p) { return static_cast<const int*>(p); };
  const ShadeRays<S> rays{s(in[0]), s(in[1]), s(in[2]), b(in[3]), b(in[4]), n(in[5]),
                          s(in[6]), n(in[7]), b(in[8]), s(in[9]), s(in[10]), s(in[11]),
                          s(in[12]), s(in[13]), s(in[14])};
  const ShadeTables<S> tb{s(tabs[0]), s(tabs[1]), n(tabs[2]), s(tabs[3]), N,
                          n(tabs[4]), s(tabs[5]), s(tabs[6]), s(tabs[7]), s(tabs[8]),
                          s(tabs[9]), s(tabs[10]), s(tabs[11]), s(tabs[12]), s(tabs[13]),
                          s(tabs[14]), O, s(tabs[15]), s(tabs[16])};
  ShadeOut<S> out;
  for (int k = 0; k < 6; ++k) out.out[k] = static_cast<S*>(outs[k]);
  shade_kernel<S, STAGE><<<(unsigned)((R + kShadeThreads - 1) / kShadeThreads),
                           kShadeThreads, 0, (cudaStream_t)stream>>>(
      rays, R, tb, flags, static_cast<S>(eps), out);
  return (int)cudaGetLastError();
}

inline unsigned blocks_for(int R) { return (unsigned)((R + kThreads - 1) / kThreads); }

// K2, K3, K4 and K6 read the occlusion tables (scene/compile.py OcclusionTables):
// rows (T, 12) packed, sub (T / sub_rows, 6), clus (C, 6) and grp
// (ceil(C / 8), 6) widened boxes, n_sub sub-boxes a cluster.
OccTables occ_tables(const float* rows, const float* sub, const float* clus,
                     const float* grp, int leaf, int n_sub) {
  return OccTables{PackedRows{reinterpret_cast<const float4*>(rows)}, sub, clus, grp,
                   n_sub, leaf / n_sub};
}

template <bool SN>
int launch_closest_shadow(int device, void* stream, const float* o, const float* d,
                          int R, const float* p1, const float* e1, const float* e2,
                          const float* pay, const float* aabb, int C, int leaf,
                          float eps, const float* light, const float* rows,
                          const float* sub, const float* clus, const float* grp,
                          int n_sub, float* t_out, int* idx_out, float* n_out,
                          uint8_t* sh_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  closest_shadow_kernel<SN><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, R, p1, e1, e2, pay, aabb, C, leaf, eps, light,
      occ_tables(rows, sub, clus, grp, leaf, n_sub), t_out, idx_out, n_out, sh_out);
  return (int)cudaGetLastError();
}

// K7a (ANY = false) and K7b: blocks of kTileK7 rays with two staged
// clusters of dynamic shared memory. Refuses a leaf outside [1,
// kMaxLeafK7] on a table with clusters.
template <bool ANY>
int launch_elementwise(int device, void* stream, const float* o, const float* d,
                       const float* max_t, int R, const float* p1, const float* e1,
                       const float* e2, const float* aabb, int C, const float* sup,
                       int leaf, float eps, float* t_out, int* idx_out,
                       uint8_t* hit_out) {
  if (C > 0 && (leaf < 1 || leaf > kMaxLeafK7)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = elementwise_smem(leaf);
  if (smem > 16384) {  // past the 48 KB default with the ~22 KB static arrays
    err = cudaFuncSetAttribute(elementwise_kernel<ANY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec16 = leaf % 4 == 0 &&
      ((uintptr_t)p1 | (uintptr_t)e1 | (uintptr_t)e2) % 16 == 0;
  elementwise_kernel<ANY><<<(unsigned)((R + kTileK7 - 1) / kTileK7), kTileK7, smem,
                            (cudaStream_t)stream>>>(
      o, d, max_t, R, p1, e1, e2, aabb, C, sup, leaf, eps, vec16, t_out, idx_out, hit_out);
  return (int)cudaGetLastError();
}

template <typename S, bool ANY>
int launch_prim_sweep(void* stream, const void* o, const void* d, const void* max_dist,
                      int R, const void* inv, const int* kind, const void* params,
                      int N, double eps, void* t_out, int* prim_out, uint8_t* hit_out) {
  prim_sweep_kernel<S, ANY><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const S*>(o), static_cast<const S*>(d),
      static_cast<const S*>(max_dist), R, static_cast<const S*>(inv), kind,
      static_cast<const S*>(params), N, static_cast<S>(eps), static_cast<S*>(t_out),
      prim_out, hit_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 = launched).
// The *_sn variants take the (T, 9) corner-normal table in place of tri_n.
extern "C" {

int rtc_closest_hit(int device, void* stream, const float* o, const float* d,
                    int R, const float* p1, const float* e1, const float* e2,
                    const float* tri_n, const float* aabb, int C, int leaf,
                    float eps, float* t_out, int* idx_out, float* n_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  closest_hit_kernel<kFlat, false><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, nullptr, R, p1, e1, e2, tri_n, aabb, C, leaf, eps, t_out, idx_out,
      n_out);
  return (int)cudaGetLastError();
}

int rtc_closest_hit_sn(int device, void* stream, const float* o,
                       const float* d, int R, const float* p1,
                       const float* e1, const float* e2, const float* tri_sn,
                       const float* aabb, int C, int leaf, float eps,
                       float* t_out, int* idx_out, float* n_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  closest_hit_kernel<kSn, false><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, nullptr, R, p1, e1, e2, tri_sn, aabb, C, leaf, eps, t_out, idx_out,
      n_out);
  return (int)cudaGetLastError();
}

// K2 over clusters [c0, c1) of the occlusion tables.
int rtc_any_hit(int device, void* stream, const float* o, const float* d,
                const float* max_t, int R, const float* rows, const float* sub,
                const float* clus, const float* grp, int leaf, int n_sub, int c0,
                int c1, float eps, uint8_t* hit_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  any_hit_kernel<<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, max_t, R, occ_tables(rows, sub, clus, grp, leaf, n_sub), c0, c1, eps,
      hit_out);
  return (int)cudaGetLastError();
}

int rtc_closest_shadow(int device, void* stream, const float* o,
                       const float* d, int R, const float* p1,
                       const float* e1, const float* e2, const float* tri_n,
                       const float* aabb, int C, int leaf, float eps,
                       const float* light, const float* rows, const float* sub,
                       const float* clus, const float* grp, int n_sub,
                       float* t_out, int* idx_out, float* n_out, uint8_t* sh_out) {
  return launch_closest_shadow<false>(device, stream, o, d, R, p1, e1, e2, tri_n,
                                      aabb, C, leaf, eps, light, rows, sub, clus,
                                      grp, n_sub, t_out, idx_out, n_out, sh_out);
}

int rtc_closest_shadow_sn(int device, void* stream, const float* o,
                          const float* d, int R, const float* p1,
                          const float* e1, const float* e2,
                          const float* tri_sn, const float* aabb, int C,
                          int leaf, float eps, const float* light,
                          const float* rows, const float* sub, const float* clus,
                          const float* grp, int n_sub, float* t_out, int* idx_out,
                          float* n_out, uint8_t* sh_out) {
  return launch_closest_shadow<true>(device, stream, o, d, R, p1, e1, e2, tri_sn,
                                     aabb, C, leaf, eps, light, rows, sub, clus,
                                     grp, n_sub, t_out, idx_out, n_out, sh_out);
}

// K4 over clusters [c0, c1) of the occlusion tables and their census
// fields: row_id and row_cid (T,), the census flags of the clusters (C,)
// and of the groups (ceil(C / 8),).
int rtc_crossing_count(int device, void* stream, const float* o,
                       const float* d, const float* t_hit,
                       const int* hit_gid, int R, const float* rows,
                       const float* sub, const float* clus, const float* grp,
                       int leaf, int n_sub, const int* row_id, const int* row_cid,
                       const uint8_t* clus_census, const uint8_t* grp_census,
                       int c0, int c1, float eps, int K, int* cnt_out,
                       float* last_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  crossing_count_kernel<<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, t_hit, hit_gid, R, occ_tables(rows, sub, clus, grp, leaf, n_sub),
      CensusTables{row_id, row_cid, clus_census, grp_census}, c0, c1, eps, K,
      cnt_out, last_out);
  return (int)cudaGetLastError();
}

int rtc_closest_hit_tlas(int device, void* stream, const float* o,
                         const float* d, int R, const float* p1,
                         const float* e1, const float* e2, const float* tri_n,
                         const float* caabb, int M, int cm, int leaf,
                         const float* inst_ab, const float* inst_aabb,
                         const int* inst_mesh, const int* inst_obj, int I,
                         float eps, float* t_out, int* enc_out, int* obj_out,
                         float* n_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  closest_hit_tlas_kernel<false><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, R, p1, e1, e2, tri_n, caabb, M, cm, leaf, inst_ab, inst_aabb,
      inst_mesh, inst_obj, I, eps, t_out, enc_out, obj_out, n_out);
  return (int)cudaGetLastError();
}

int rtc_closest_hit_tlas_sn(int device, void* stream, const float* o,
                            const float* d, int R, const float* p1,
                            const float* e1, const float* e2,
                            const float* tri_sn, const float* caabb, int M,
                            int cm, int leaf, const float* inst_ab,
                            const float* inst_aabb, const int* inst_mesh,
                            const int* inst_obj, int I, float eps,
                            float* t_out, int* enc_out, int* obj_out,
                            float* n_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  closest_hit_tlas_kernel<true><<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, R, p1, e1, e2, tri_sn, caabb, M, cm, leaf, inst_ab, inst_aabb,
      inst_mesh, inst_obj, I, eps, t_out, enc_out, obj_out, n_out);
  return (int)cudaGetLastError();
}

// K6 on the unique meshes' occlusion tables (M meshes of cm clusters, cm
// a multiple of 8) and the instance slots: inst_perm (I,), inst_box (I, 6),
// inst_grp (I / 8, 6); inst_ab and inst_mesh by instance id.
int rtc_any_hit_tlas(int device, void* stream, const float* o, const float* d,
                     const float* max_t, int R, const float* rows,
                     const float* sub, const float* clus, const float* grp, int M,
                     int cm, int leaf, int n_sub, const float* inst_ab,
                     const int* inst_mesh, const int* inst_perm,
                     const float* inst_box, const float* inst_grp, int I,
                     float eps, uint8_t* hit_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  any_hit_tlas_kernel<<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, max_t, R, occ_tables(rows, sub, clus, grp, leaf, n_sub), M, cm, inst_ab,
      inst_mesh, inst_perm, inst_box, inst_grp, I, eps, hit_out);
  return (int)cudaGetLastError();
}

// K1's t0 and uv modes. t0 may be null: no carried bound. tri_n null: the
// (u, v) payload (pay_out (R, 2)); else the flat normal (pay_out (R, 3)).
int rtc_closest_hit_bounded(int device, void* stream, const float* o,
                            const float* d, const float* t0, int R,
                            const float* p1, const float* e1, const float* e2,
                            const float* tri_n, const float* aabb, int C,
                            int leaf, float eps, float* t_out, int* idx_out,
                            float* pay_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto kernel =
      tri_n == nullptr
          ? (t0 != nullptr ? closest_hit_kernel<kUv, true>
                           : closest_hit_kernel<kUv, false>)
          : (t0 != nullptr ? closest_hit_kernel<kFlat, true>
                           : closest_hit_kernel<kFlat, false>);
  kernel<<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, t0, R, p1, e1, e2, tri_n, aabb, C, leaf, eps, t_out, idx_out,
      pay_out);
  return (int)cudaGetLastError();
}

int rtc_closest_hit_elementwise(int device, void* stream, const float* o,
                                const float* d, int R, const float* p1,
                                const float* e1, const float* e2,
                                const float* aabb, int C, const float* sup,
                                int S, int leaf, float eps, float* t_out,
                                int* idx_out) {
  (void)S;  // the supers are C / kSuperWidth (the wrapper checks C == 8 S)
  return launch_elementwise<false>(device, stream, o, d, nullptr, R, p1, e1, e2, aabb,
                                   C, sup, leaf, eps, t_out, idx_out, nullptr);
}

int rtc_any_hit_elementwise(int device, void* stream, const float* o,
                            const float* d, const float* max_t, int R,
                            const float* p1, const float* e1, const float* e2,
                            const float* aabb, int C, const float* sup, int S,
                            int leaf, float eps, uint8_t* hit_out) {
  (void)S;
  return launch_elementwise<true>(device, stream, o, d, max_t, R, p1, e1, e2, aabb, C,
                                  sup, leaf, eps, nullptr, nullptr, hit_out);
}

// The ordered walk's list lengths: K1's (and K3's), and K5's.
int rtc_walk_list(int* k1_len, int* k5_len) {
  *k1_len = kListK1;
  *k5_len = kListK5;
  return 0;
}

// What a block of one walking kernel takes on the device it runs on, K7's
// at clusters of leaf rows: its registers a thread, local bytes a thread,
// shared bytes a block (static and dynamic), threads a block, and the
// blocks that fit on one SM. which: 0-4 K1 flat, with_sn, with_t0, with_uv,
// with_uv + t0; 5-6 K3 flat, with_sn; 7-8 K5 flat, with_sn; 9 K6; 10 K2;
// 11 K4; 12-13 K7a, K7b (the order of WALK_KERNELS in
// ops/kernels/mesh_intersect.py).
int rtc_walk_kernel_report(int which, int leaf, int* regs, int* local_bytes,
                           int* shared_bytes, int* block_threads, int* blocks_per_sm) {
  const void* const kernels[] = {
      (const void*)closest_hit_kernel<kFlat, false>,
      (const void*)closest_hit_kernel<kSn, false>,
      (const void*)closest_hit_kernel<kFlat, true>,
      (const void*)closest_hit_kernel<kUv, false>,
      (const void*)closest_hit_kernel<kUv, true>,
      (const void*)closest_shadow_kernel<false>,
      (const void*)closest_shadow_kernel<true>,
      (const void*)closest_hit_tlas_kernel<false>,
      (const void*)closest_hit_tlas_kernel<true>,
      (const void*)any_hit_tlas_kernel,
      (const void*)any_hit_kernel,
      (const void*)crossing_count_kernel,
      (const void*)elementwise_kernel<false>,
      (const void*)elementwise_kernel<true>};
  constexpr int kFirstK7 = 12;
  if (which < 0 || which >= (int)(sizeof(kernels) / sizeof(kernels[0])))
    return (int)cudaErrorInvalidValue;
  const bool k7 = which >= kFirstK7;
  if (k7 && (leaf < 1 || leaf > kMaxLeafK7)) return (int)cudaErrorInvalidValue;
  const size_t smem = k7 ? elementwise_smem(leaf) : 0;
  cudaError_t err;
  if (smem > 16384) {
    err = cudaFuncSetAttribute(kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)(attr.sharedSizeBytes + smem);
  *block_threads = k7 ? kTileK7 : kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernels[which], *block_threads, smem);
}

#ifdef RTC_COUNT
// The counting build's buffer: (R, kCounters) i32 for the next launches,
// or null (no tallies). Synchronous.
int rtc_set_count_buffer(int* buf) {
  return (int)cudaMemcpyToSymbol(g_count, &buf, sizeof(buf));
}

int rtc_counters() { return kCounters; }

// K2's old loop, kept to be counted against the walks that replaced it
// (kernel_ab.py --count): the table-order loop over a (C * leaf, 3) table
// and its (C, 6) cluster boxes.
int rtc_count_any_hit_table_order(int device, void* stream, const float* o,
                                  const float* d, const float* max_t, int R,
                                  const float* p1, const float* e1, const float* e2,
                                  const float* aabb, int C, int leaf, float eps,
                                  uint8_t* hit_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  any_hit_table_order_kernel<<<blocks_for(R), kThreads, 0, (cudaStream_t)stream>>>(
      o, d, max_t, R, p1, e1, e2, aabb, C, leaf, eps, hit_out);
  return (int)cudaGetLastError();
}
#endif

// pass 1's blocks for R rays, and its tile of the O x K table (rows x
// cols): as much of the table as kRowsWarps accumulators of it fit a
// block's opt-in shared memory on this device
static cudaError_t rows_plan(int device, int R, int O, int K, int* blocks, int* rows,
                             int* cols) {
  int sms = 0, smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int cap = smem / (int)(kRowsWarps * sizeof(float));  // entries a tile
  *cols = std::min(K, std::max(1, cap / O));
  *rows = std::min(O, cap / *cols);
  *blocks = std::min((R + kRowsThreads - 1) / kRowsThreads, kRowsBlocksPerSM * sms);
  return cudaSuccess;
}

// The floats of scratch rtc_object_rows_sum takes for R rays and an O x K
// table: pass 1's partials of one tile.
int rtc_object_rows_scratch(int device, int R, int O, int K, long long* floats) {
  if (O < 1 || R < 1 || K < 1) return (int)cudaErrorInvalidValue;
  int blocks, rows, cols;
  cudaError_t err = rows_plan(device, R, O, K, &blocks, &rows, &cols);
  if (err != cudaSuccess) return (int)err;
  *floats = (long long)blocks * rows * cols;
  return 0;
}

// The object rows' sum over n fields (grads[k] (R, widths[k]) into outs[k]
// (O, widths[k])) by ids (R,) in [0, O), null when O == 1, with scratch of
// rtc_object_rows_scratch's floats; ids outside [0, O) add nothing.
// Refuses n outside [1, kMaxRowFields] and scratch short of that.
int rtc_object_rows_sum(int device, void* stream, const int* ids, int R, int O,
                        const float* const* grads, float* const* outs,
                        const int* widths, int n, float* scratch, long long floats) {
  if (n < 1 || n > kMaxRowFields || O < 1 || R < 1) return (int)cudaErrorInvalidValue;
  RowFields f{};
  f.n = n;
  int K = 0;
  for (int k = 0; k < n; ++k) {
    if (widths[k] < 1) return (int)cudaErrorInvalidValue;
    f.g[k] = grads[k];
    f.out[k] = outs[k];
    f.width[k] = widths[k];
    K += widths[k];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int blocks, rows, cols;
  err = rows_plan(device, R, O, K, &blocks, &rows, &cols);
  if (err != cudaSuccess) return (int)err;
  if (floats < (long long)blocks * rows * cols) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRowsWarps * rows * cols * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(object_rows_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int chunk = (R + blocks - 1) / blocks;
  for (int o0 = 0; o0 < O; o0 += rows) {
    for (int c0 = 0; c0 < K; c0 += cols) {
      const RowTile t{o0, std::min(rows, O - o0), c0, std::min(cols, K - c0)};
      object_rows_partial_kernel<<<blocks, kRowsThreads,
                                   (size_t)kRowsWarps * t.rows * t.cols * sizeof(float),
                                   (cudaStream_t)stream>>>(ids, R, f, t, chunk, scratch);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      object_rows_total_kernel<<<(unsigned)((t.rows * t.cols + kRowsWarps - 1) / kRowsWarps),
                                 kRowsThreads, 0, (cudaStream_t)stream>>>(scratch, blocks,
                                                                          f, t);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// The analytic prims' sweep over N >= 1 prims (inv (N, 3, 4), kind (N,) int32,
// params (N, 3)) of R rays o, d (R, 3), all float64 where f64 is set, else
// float32. any = 0: t_out (R,) and prim_out (R,) int32, the closest hit;
// any = 1: hit_out (R,) bytes, a valid slot at 0 <= t < max_dist (R,).
int rtc_prim_sweep(int device, void* stream, int f64, int any, const void* o,
                   const void* d, const void* max_dist, int R, const void* inv,
                   const int* kind, const void* params, int N, double eps,
                   void* t_out, int* prim_out, uint8_t* hit_out) {
  if (R < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto launch = f64 ? (any ? launch_prim_sweep<double, true> : launch_prim_sweep<double, false>)
                    : (any ? launch_prim_sweep<float, true> : launch_prim_sweep<float, false>);
  return launch(stream, o, d, max_dist, R, inv, kind, params, N, eps, t_out, prim_out,
                hit_out);
}

// A bounce node's shading, stage 0 (surface), 1 (node) or 2 (blend), over
// R rays, all float64 where f64 is set, else float32: in, the stage's 15
// ShadeRays pointers in order (o, d, t, valid, is_tri, prim, tri_n, obj,
// shadowed, n1, n2, surface, refl, refr, weights; null where the stage
// reads none); tables, the 17 ShadeTables pointers (the N prims' inv,
// invT, kind, params; the O objects' pat_kind, pat_a, pat_b, pat_inv,
// color, ambient, diffuse, specular, shininess, reflective, transparency;
// the light's position and intensity); outs, the stage's ShadeOut
// pointers (6, null where unused); flags, ShadeFlag's bits.
int rtc_shade(int device, void* stream, int f64, int stage, int flags, int R,
              const void* const* in, const void* const* tables, int N, int O,
              double eps, void* const* outs) {
  if (R < 1 || N < 0 || O < 0 || stage < kShadeSurface || stage > kShadeBlend)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  using Launch = int (*)(void*, int, const void* const*, const void* const*, int, int, int,
                         double, void* const*);
  static const Launch launches[2][3] = {
      {launch_shade<float, kShadeSurface>, launch_shade<float, kShadeNode>,
       launch_shade<float, kShadeBlend>},
      {launch_shade<double, kShadeSurface>, launch_shade<double, kShadeNode>,
       launch_shade<double, kShadeBlend>}};
  return launches[f64 ? 1 : 0][stage](stream, R, in, tables, N, O, flags, eps, outs);
}

const char* rtc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
