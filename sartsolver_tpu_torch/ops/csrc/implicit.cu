// The matrix-free ray-voxel projector of the implicit operator
// (sartsolver_tpu_torch/operators/implicit.py), CUDA C++ for sm_90a.
//
// It replaces no Pallas kernel. The JAX package rebuilds H in plain XLA: a
// fori_loop over 1024-voxel panels, each a [P, panel] block of ray segment
// lengths from the slab method (sartsolver_tpu/operators/implicit.py:117-161,
// used at :164-227). Eager PyTorch fuses nothing (the plain version takes
// about 110 ms a projection at 8192 rays x 65,536 voxels on the card), so
// the plain version serves the CPU and this kernel the card.
//
// What bounds it. H is sparse: a ray crosses about as many cells as the
// grid is wide (2.8e-4 of the pairs are nonzero on 8192 rays x 65,536
// voxels, 7.1e-5 on 131,072 x 1,048,576), so the work the inputs need,
// (25 + 2B) fp32 operations a nonzero entry, and the bytes (the [P, 6] ray
// table and the operand read once, the result written once) both take
// microseconds. What the kernels spend is finding the cells: a walk whose
// steps depend on each other (forward) and the cull and the evaluation of
// every surviving ray for every cell of a brick (back); PERF.md §6 counts
// the pairs each evaluates. The design visits only the cells a ray can
// cross, never every ray-voxel pair:
//   forward  [B, V] -> [B, P], one launch: a group of GROUP threads owns a
//            ray (each with up to LANES batch rows in registers). It clips
//            the ray to the grid (ray_window; a dead row or a miss writes
//            0), then walks the x-slabs the clipped ray spans in ascending
//            order; in each slab the ray's t-interval gives the y rows it
//            can cross, in each row the interval narrowed again gives the z
//            cells. A ray that spans GROUP slabs or more is cut into GROUP
//            runs of consecutive slabs, one a thread; a shorter one is
//            walked by every thread of the group, which take its rows' z
//            cells in turn (eight times the threads of one a ray: 8192 rays
//            alone fill 64 blocks, and the walk is a chain of dependent
//            steps). Each thread adds its terms in voxel-id order (x
//            slowest, z fastest); the group adds its partial sums in thread
//            order.
//   back     [B, P] -> [B, V], two launches: ray_boxes_kernel gives every
//            ray the index box of the cells it can cross (the same ranges),
//            and their unions over CHUNK consecutive rays and over SUPER
//            chunks. back_kernel's block owns a brick of THREADS cells (a
//            compact box, pick_brick), culls the super boxes, then the chunk
//            boxes, then each ray of a surviving chunk with the exact slab
//            test against the brick widened by one cell, compacts the
//            survivors in ray order into shared memory (warp ballots and a
//            block prefix sum) and lets each thread evaluate its own cell
//            against them, in ray order.
// Ray stats and the ordered-subsets densities run through the same two
// entry points (all-ones and subset-indicator operands). Neither sum uses
// atomics: the port keeps chain = serial and scheduler = classic byte for
// byte, and two calls give the same bytes.
//
// The entries are the plain version's bit for bit: every entry evaluated
// goes through voxel_box and seg_length, whose corner and slab steps are
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn so that nvcc
// cannot contract them into FMAs (one ulp in a corner can move a
// face-riding ray's segment into the neighbouring voxel, the half-open
// [lo, hi) rule). The traversal only chooses which cells to evaluate, and
// it may choose more than the nonzero ones, never fewer:
// - every range is first estimated from the ray's position at the ends of
//   its t-interval (times the spacing's reciprocal) and widened by one cell
//   on each side;
// - then it is extended, one cell at a time, while the next cell out can
//   still hold a segment inside the interval (reach). That test is
//   monotone in the cell index, because the corners and slab distances are
//   computed with the rounded operations of seg_length, and rounding keeps
//   order; so the first cell that fails it bounds every cell beyond. A
//   range is therefore a superset of the nonzero cells at any coordinate
//   magnitude, not only where one ulp of a coordinate is below a cell.
// - the back's brick test uses the same slab distances of the brick's
//   extreme cells (widened by one cell): a ray that fails it has a zero
//   entry in every cell of the brick.
// operators/implicit.py:candidate_cells and tile_survivors repeat these
// steps operation for operation in plain torch (the tests' and
// chip_smoke.py's count of the pairs evaluated). The sums accumulate in the
// operand's type (fp32 or fp64) and may contract; they agree with the plain
// version's within the summation order.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 8;          // batch rows a thread carries in registers
constexpr int GROUP = 8;          // threads that share a ray (forward)
constexpr int RAY_TILE = 256;     // surviving rays staged at once (back)
constexpr int CHUNK = 32;         // rays under one index box
constexpr int SUPER = 32;         // chunks under one super box
constexpr int BOX_THREADS = CHUNK * SUPER;  // ray_boxes_kernel: a super box a block
constexpr float EPS = 1e-7f;  // |d| below it: the ray is parallel to the axis
constexpr float BIG = 1e30f;  // stands in for infinity in the slab algebra
constexpr unsigned FULL = 0xffffffffu;

struct Grid {
  long long n[3];  // cells along x, y, z (x slowest in a voxel id)
  float org[3];
  float sp[3];
  float isp[3];  // 1 / sp, for the range estimates only
};

// the cells a back block owns: e[a] cells along axis a, nb[a] bricks
struct Brick {
  int e[3];
  long long nb[3];
};

// one ray, prepared once: origin, direction, the reciprocal of the
// direction (1 on a parallel axis), bits 0-2 the parallel axes, bit 3 a
// live ray (|d|^2 > 0.5; zero-padded rows are dead)
struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  int flags;
};

struct Box {
  float lo[3];
  float hi[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ r) {
  Ray ray;
  int flags = 0;
  float d2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = r[3 + a];
    ray.o[a] = r[a];
    ray.d[a] = d;
    bool parallel = fabsf(d) < EPS;
    ray.inv[a] = __fdiv_rn(1.f, parallel ? 1.f : d);
    flags |= parallel ? (1 << a) : 0;
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  ray.flags = flags | (d2 > 0.5f ? 8 : 0);
  return ray;
}

// the low corner of cell i along axis a
__device__ __forceinline__ float cell_lo(const Grid& g, int a, int i) {
  return __fadd_rn(g.org[a], __fmul_rn(static_cast<float>(i), g.sp[a]));
}

__device__ __forceinline__ Box voxel_box(int ix, int iy, int iz, const Grid& g) {
  Box b;
  b.lo[0] = cell_lo(g, 0, ix);
  b.lo[1] = cell_lo(g, 1, iy);
  b.lo[2] = cell_lo(g, 2, iz);
#pragma unroll
  for (int a = 0; a < 3; ++a) b.hi[a] = __fadd_rn(b.lo[a], g.sp[a]);
  return b;
}

// the length of a live ray's segment inside the box: the slab method of the
// plain version (operators/implicit.py:panel_lengths), operation for
// operation
__device__ __forceinline__ float seg_length(const Ray& r, const float* lo,
                                            const float* hi) {
  float near = -BIG, far = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float n, f;
    if (r.flags & (1 << a)) {
      // half-open [lo, hi): a ray riding a shared face belongs to one cell
      bool between = (r.o[a] >= lo[a]) && (r.o[a] < hi[a]);
      n = between ? -BIG : BIG;
      f = between ? BIG : -BIG;
    } else {
      float t1 = __fmul_rn(__fsub_rn(lo[a], r.o[a]), r.inv[a]);
      float t2 = __fmul_rn(__fsub_rn(hi[a], r.o[a]), r.inv[a]);
      n = fminf(t1, t2);
      f = fmaxf(t1, t2);
    }
    near = a == 0 ? n : fmaxf(near, n);
    far = a == 0 ? f : fminf(far, f);
  }
  float tmin = fmaxf(near, 0.f);  // matter behind the origin never counts
  return fmaxf(__fsub_rn(far, tmin), 0.f);
}

// seg_length's entry and exit distances of a non-parallel axis for cell i
__device__ __forceinline__ void slab_t(const Ray& r, const Grid& g, int a, int i, float& t1,
                                       float& t2) {
  const float lo = cell_lo(g, a, i);
  const float hi = __fadd_rn(lo, g.sp[a]);
  t1 = __fmul_rn(__fsub_rn(lo, r.o[a]), r.inv[a]);
  t2 = __fmul_rn(__fsub_rn(hi, r.o[a]), r.inv[a]);
}

// the ray's t-window inside cells [c0[a], c1[a]] of every axis, in
// seg_length's arithmetic: the slab distances of the extreme cells (they
// are monotone in the cell index, so the extremes bound every cell
// between). False for a dead ray, or where no cell of the box can hold a
// segment at t >= 0.
__device__ __forceinline__ bool window(const Ray& r, const Grid& g, const int* c0,
                                       const int* c1, float& t0, float& t1) {
  t0 = 0.f;
  t1 = BIG;
  if (!(r.flags & 8)) return false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (r.flags & (1 << a)) {
      const float lo = cell_lo(g, a, c0[a]);
      const float hi = __fadd_rn(cell_lo(g, a, c1[a]), g.sp[a]);
      if (!(r.o[a] >= lo && r.o[a] < hi)) return false;
    } else {
      float a1, a2, b1, b2;
      slab_t(r, g, a, c0[a], a1, a2);
      slab_t(r, g, a, c1[a], b1, b2);
      t0 = fmaxf(t0, fminf(fminf(a1, a2), fminf(b1, b2)));
      t1 = fminf(t1, fmaxf(fmaxf(a1, a2), fmaxf(b1, b2)));
    }
  }
  return t0 < t1;
}

// the whole grid's window: the ray clipped to the grid, t >= 0
__device__ __forceinline__ bool ray_window(const Ray& r, const Grid& g, float& t0,
                                           float& t1) {
  const int c0[3] = {0, 0, 0};
  const int c1[3] = {static_cast<int>(g.n[0]) - 1, static_cast<int>(g.n[1]) - 1,
                     static_cast<int>(g.n[2]) - 1};
  if (g.n[0] < 1 || g.n[1] < 1 || g.n[2] < 1) {
    t0 = 0.f;
    t1 = 0.f;
    return false;
  }
  return window(r, g, c0, c1, t0, t1);
}

// whether cell i of axis a can still hold a segment inside (w0, w1) as
// seen from the side a range grows towards: below it (down) or above it.
// Each test is monotone in i (a suffix of the cells passes the downward
// one, a prefix the upward one), so the first cell that fails it bounds
// every cell beyond.
__device__ __forceinline__ bool reach(const Ray& r, const Grid& g, int a, int i, float w0,
                                      float w1, bool down) {
  const float lo = cell_lo(g, a, i);
  const float hi = __fadd_rn(lo, g.sp[a]);
  if (r.flags & (1 << a)) return down ? r.o[a] < hi : r.o[a] >= lo;
  const float t1 = __fmul_rn(__fsub_rn(lo, r.o[a]), r.inv[a]);
  const float t2 = __fmul_rn(__fsub_rn(hi, r.o[a]), r.inv[a]);
  // inv > 0: t1 <= t2, both rising with i; inv < 0: t2 <= t1, both falling
  const bool rising = r.inv[a] > 0.f;
  return down == rising ? fmaxf(t1, t2) > w0 : fminf(t1, t2) < w1;
}

// floor(e) + widen, clamped to the axis's cells [0, n - 1]
__device__ __forceinline__ int clamp_index(float e, int n, int widen) {
  const float c = fminf(fmaxf(e, -2.f), __fadd_rn(static_cast<float>(n), 1.f));
  const int i = static_cast<int>(floorf(c)) + widen;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// the cells [i0, i1] of axis a that can hold a segment of the ray inside
// its t-interval (w0, w1): estimated from the ray's coordinate at the
// interval's ends, widened by one cell, extended while reach holds
__device__ __forceinline__ void axis_range(const Ray& r, const Grid& g, int a, float w0,
                                           float w1, int& i0, int& i1) {
  const int n = static_cast<int>(g.n[a]);
  float e0, e1;
  if (r.flags & (1 << a)) {
    e0 = e1 = __fmul_rn(__fsub_rn(r.o[a], g.org[a]), g.isp[a]);
  } else {
    const float p0 = __fadd_rn(r.o[a], __fmul_rn(r.d[a], w0));
    const float p1 = __fadd_rn(r.o[a], __fmul_rn(r.d[a], w1));
    e0 = __fmul_rn(__fsub_rn(fminf(p0, p1), g.org[a]), g.isp[a]);
    e1 = __fmul_rn(__fsub_rn(fmaxf(p0, p1), g.org[a]), g.isp[a]);
  }
  i0 = clamp_index(e0, n, -1);
  i1 = clamp_index(e1, n, 1);
  while (i0 > 0 && reach(r, g, a, i0 - 1, w0, w1, true)) --i0;
  while (i1 < n - 1 && reach(r, g, a, i1 + 1, w0, w1, false)) ++i1;
}

// the narrowed window of cell i of axis a inside (w0, w1); false if empty
__device__ __forceinline__ bool narrow(const Ray& r, const Grid& g, int a, int i, float w0,
                                       float w1, float& u0, float& u1) {
  float n, f;
  if (r.flags & (1 << a)) {
    const float lo = cell_lo(g, a, i);
    const float hi = __fadd_rn(lo, g.sp[a]);
    const bool between = (r.o[a] >= lo) && (r.o[a] < hi);
    n = between ? -BIG : BIG;
    f = between ? BIG : -BIG;
  } else {
    float t1, t2;
    slab_t(r, g, a, i, t1, t2);
    n = fminf(t1, t2);
    f = fmaxf(t1, t2);
  }
  u0 = fmaxf(w0, n);
  u1 = fminf(w1, f);
  return u0 < u1;
}

// a group of GROUP threads shares a ray: a ray that spans at least GROUP
// x-slabs is cut into GROUP runs of consecutive slabs, one a thread; a
// shorter one is walked by every thread of the group, which take the z
// cells of each row in turn. Each thread adds its terms in voxel-id order;
// the group's partial sums are added in thread order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ rays, long long P, const T* __restrict__ f,
               int B, long long V, Grid g, T* __restrict__ out) {
  const long long p = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / GROUP;
  const int member = threadIdx.x % GROUP;
  const int b0 = blockIdx.y * LANES;
  const int nb = min(LANES, B - b0);
  T acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = T(0);
  Ray ray;
  float t0 = 0.f, t1 = 0.f;
  bool hit = false;
  if (p < P) {
    ray = load_ray(rays + p * 6);
    hit = ray_window(ray, g, t0, t1);
  }
  if (hit) {
    int x0, x1;
    axis_range(ray, g, 0, t0, t1, x0, x1);
    const int slabs = x1 - x0 + 1;
    const bool cut = slabs >= GROUP;
    const int xa = cut ? x0 + slabs * member / GROUP : x0;
    const int xb = cut ? x0 + slabs * (member + 1) / GROUP - 1 : x1;
    const int z_first = cut ? 0 : member, z_step = cut ? 1 : GROUP;
    for (int ix = xa; ix <= xb; ++ix) {
      float w0, w1;
      if (!narrow(ray, g, 0, ix, t0, t1, w0, w1)) continue;
      int y0, y1;
      axis_range(ray, g, 1, w0, w1, y0, y1);
      for (int iy = y0; iy <= y1; ++iy) {
        float u0, u1;
        if (!narrow(ray, g, 1, iy, w0, w1, u0, u1)) continue;
        int z0, z1;
        axis_range(ray, g, 2, u0, u1, z0, z1);
        const long long row = (ix * g.n[1] + iy) * g.n[2];
        for (int iz = z0 + z_first; iz <= z1; iz += z_step) {
          const Box b = voxel_box(ix, iy, iz, g);
          const float L = seg_length(ray, b.lo, b.hi);
          if (L != 0.f) {
            const T e = static_cast<T>(L);
            const T* fv = f + static_cast<long long>(b0) * V + row + iz;
#pragma unroll
            for (int l = 0; l < LANES; ++l)
              if (l < nb) acc[l] += e * fv[static_cast<long long>(l) * V];
          }
        }
      }
    }
  }
  // the group's sums, in thread order
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    T s = __shfl_sync(FULL, acc[l], 0, GROUP);
#pragma unroll
    for (int k = 1; k < GROUP; ++k) s += __shfl_sync(FULL, acc[l], k, GROUP);
    if (member == 0 && p < P && l < nb) out[static_cast<long long>(b0 + l) * P + p] = s;
  }
}

__device__ __forceinline__ void union_over_warp(int* b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int o = __shfl_xor_sync(FULL, b[k], off);
      b[k] = (k % 2 == 0) ? min(b[k], o) : max(b[k], o);
    }
  }
}

// per ray the index box [x0, x1, y0, y1, z0, z1] of the cells it can cross
// (the forward's ranges over the whole clipped ray; empty: x0 > x1), and
// the boxes' unions: chunk_box over CHUNK consecutive rays, super_box over
// SUPER consecutive chunks (one block)
__global__ void __launch_bounds__(BOX_THREADS)
ray_boxes_kernel(const float* __restrict__ rays, long long P, Grid g,
                 int* __restrict__ chunk_box, int* __restrict__ super_box) {
  __shared__ int s_box[SUPER][6];
  const long long p = static_cast<long long>(blockIdx.x) * BOX_THREADS + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int b[6] = {INT_MAX, -1, INT_MAX, -1, INT_MAX, -1};
  if (p < P) {
    const Ray r = load_ray(rays + p * 6);
    float t0, t1;
    if (ray_window(r, g, t0, t1)) {
#pragma unroll
      for (int a = 0; a < 3; ++a) axis_range(r, g, a, t0, t1, b[2 * a], b[2 * a + 1]);
    }
  }
  union_over_warp(b);
  const long long chunk = p / CHUNK;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[warp][k] = b[k];
    if (chunk * CHUNK < P) {
#pragma unroll
      for (int k = 0; k < 6; ++k) chunk_box[chunk * 6 + k] = b[k];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = s_box[lane][k];
    union_over_warp(b);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) super_box[static_cast<long long>(blockIdx.x) * 6 + k] = b[k];
    }
  }
}

__device__ __forceinline__ bool overlaps(const int* __restrict__ box, const int* c0,
                                         const int* c1) {
  return box[0] <= c1[0] && box[1] >= c0[0] && box[2] <= c1[1] && box[3] >= c0[1] &&
         box[4] <= c1[2] && box[5] >= c0[2];
}

// a deterministic block-wide exclusive prefix sum of one flag a thread:
// this thread's slot among the set flags, in thread order, and their count
__device__ __forceinline__ void block_scan(bool flag, int* s_count, int& slot, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned bits = __ballot_sync(FULL, flag);
  if (lane == 0) s_count[warp] = __popc(bits);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  slot = before + __popc(bits & ((1u << lane) - 1u));
  __syncthreads();  // s_count is free for the next scan
}

// every thread's own cell against the staged rays, in ray order
template <typename T>
__device__ __forceinline__ void evaluate_staged(int staged, bool mine, const Box& box,
                                                float (*s_o)[3], float (*s_inv)[3],
                                                const int* s_flags, T (*s_w)[RAY_TILE],
                                                int nb,
                                                T* acc) {
#ifndef SART_IMPLICIT_CULL_ONLY  // sweep_measure.py implicit_cull: the cull alone
  if (mine) {
    for (int j = 0; j < staged; ++j) {
      Ray r;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        r.o[a] = s_o[j][a];
        r.d[a] = 0.f;
        r.inv[a] = s_inv[j][a];
      }
      r.flags = s_flags[j];
      const float L = seg_length(r, box.lo, box.hi);
      if (L != 0.f) {
        const T e = static_cast<T>(L);
#pragma unroll
        for (int l = 0; l < LANES; ++l)
          if (l < nb) acc[l] += e * s_w[l][j];
      }
    }
  }
#endif
  __syncthreads();  // the staging buffer is free again
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
back_kernel(const float* __restrict__ rays, long long P, const int* __restrict__ chunk_box,
            const int* __restrict__ super_box, const T* __restrict__ w, int B, long long V,
            Grid g, Brick br, T* __restrict__ out) {
  __shared__ float s_o[RAY_TILE][3];
  __shared__ float s_inv[RAY_TILE][3];
  __shared__ int s_flags[RAY_TILE];
  __shared__ T s_w[LANES][RAY_TILE];
  __shared__ int s_pass[THREADS];
  __shared__ int s_count[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.y * LANES;
  const int nb = min(LANES, B - b0);
  const long long n_bricks = br.nb[0] * br.nb[1] * br.nb[2];
  const long long grid_voxels = g.n[0] * g.n[1] * g.n[2];
  if (static_cast<long long>(blockIdx.x) >= n_bricks) {
    // the padding columns [grid_voxels, V) project to zero
    const long long v = grid_voxels + (blockIdx.x - n_bricks) * THREADS + tid;
    if (v < V) {
      for (int l = 0; l < nb; ++l) out[static_cast<long long>(b0 + l) * V + v] = T(0);
    }
    return;
  }
  // the brick's first cell per axis (bricks in voxel-id order, z fastest)
  long long k = blockIdx.x;
  int corner[3];
  corner[2] = static_cast<int>(k % br.nb[2]) * br.e[2];
  k /= br.nb[2];
  corner[1] = static_cast<int>(k % br.nb[1]) * br.e[1];
  corner[0] = static_cast<int>(k / br.nb[1]) * br.e[0];
  const int ey = br.e[1], ez = br.e[2];
  const int cell[3] = {corner[0] + tid / (ey * ez), corner[1] + (tid / ez) % ey,
                       corner[2] + tid % ez};
  const bool mine = tid < br.e[0] * ey * ez && cell[0] < g.n[0] && cell[1] < g.n[1] &&
                    cell[2] < g.n[2];
  Box box;
  if (mine) box = voxel_box(cell[0], cell[1], cell[2], g);
  // the brick's cells inside the grid, widened by one cell
  int c0[3], c1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c0[a] = corner[a] > 0 ? corner[a] - 1 : 0;
    c1[a] = min(corner[a] + br.e[a], static_cast<int>(g.n[a]) - 1);
  }
  T acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = T(0);
  int staged = 0;
  const long long n_chunks = (P + CHUNK - 1) / CHUNK;
  const long long n_super = (n_chunks + SUPER - 1) / SUPER;
  for (long long s0 = 0; s0 < n_super; s0 += THREADS) {
    const long long s = s0 + tid;
    const bool pass = s < n_super && overlaps(super_box + s * 6, c0, c1);
    int slot, n_pass;
    block_scan(pass, s_count, slot, n_pass);
    if (pass) s_pass[slot] = static_cast<int>(s);
    __syncthreads();
    for (int q = 0; q < n_pass; ++q) {
      const long long sc = s_pass[q];
      const long long c = sc * SUPER + lane;
      unsigned mask =
          __ballot_sync(FULL, c < n_chunks && overlaps(chunk_box + c * 6, c0, c1));
      while (mask != 0u) {  // the same mask in every warp
        // this round: the next WARPS surviving chunks, one a warp, in order
        int pick = -1;
        for (int j = 0; j < WARPS && mask != 0u; ++j) {
          const int bit = __ffs(mask) - 1;
          mask &= mask - 1u;
          if (j == warp) pick = bit;
        }
        const long long p = pick < 0 ? P : (sc * SUPER + pick) * CHUNK + lane;
        Ray r;
        bool keep = false;
        if (p < P) {
          r = load_ray(rays + p * 6);
          float t0, t1;
          keep = window(r, g, c0, c1, t0, t1);
        }
        int at, n_keep;
        block_scan(keep, s_count, at, n_keep);
        if (staged + n_keep > RAY_TILE) {
          evaluate_staged<T>(staged, mine, box, s_o, s_inv, s_flags, s_w, nb, acc);
          staged = 0;
        }
        if (keep) {
          const int j = staged + at;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            s_o[j][a] = r.o[a];
            s_inv[j][a] = r.inv[a];
          }
          s_flags[j] = r.flags;
#pragma unroll
          for (int l = 0; l < LANES; ++l)
            s_w[l][j] = l < nb ? w[static_cast<long long>(b0 + l) * P + p] : T(0);
        }
        staged += n_keep;
      }
    }
    __syncthreads();  // s_pass is rewritten by the next step; staged rays visible
  }
  evaluate_staged<T>(staged, mine, box, s_o, s_inv, s_flags, s_w, nb, acc);
  if (mine) {
    const long long v = (cell[0] * g.n[1] + cell[1]) * g.n[2] + cell[2];
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (l < nb) out[static_cast<long long>(b0 + l) * V + v] = acc[l];
  }
}

long long chunks(long long n, long long chunk) { return (n + chunk - 1) / chunk; }

// the back's brick: THREADS cells (or the whole grid), grown by doubling the
// axis with the fewest cells that the grid still exceeds (ties: z, y, x)
Brick pick_brick(const Grid& g) {
  Brick br{{1, 1, 1}, {0, 0, 0}};
  while (br.e[0] * br.e[1] * br.e[2] < THREADS) {
    int best = -1;
    for (int a = 2; a >= 0; --a)
      if (br.e[a] < g.n[a] && (best < 0 || br.e[a] < br.e[best])) best = a;
    if (best < 0) break;
    br.e[best] *= 2;
  }
  for (int a = 0; a < 3; ++a) br.nb[a] = chunks(g.n[a], br.e[a]);
  return br;
}

long long back_blocks(const Grid& g, long long V) {
  const Brick br = pick_brick(g);
  return br.nb[0] * br.nb[1] * br.nb[2] + chunks(V - g.n[0] * g.n[1] * g.n[2], THREADS);
}

template <typename T>
int launch(int which, const float* rays, long long P, const T* x, int B, long long V,
           const Grid& g, int* scratch, T* out, cudaStream_t stream) {
  const unsigned lane_groups = static_cast<unsigned>((B + LANES - 1) / LANES);
  if (which == 0) {
    const dim3 grid(static_cast<unsigned>(chunks(P * GROUP, THREADS)), lane_groups);
    forward_kernel<T><<<grid, THREADS, 0, stream>>>(rays, P, x, B, V, g, out);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n_chunks = chunks(P, CHUNK);
  const long long n_super = chunks(n_chunks, SUPER);
  int* chunk_box = scratch;
  int* super_box = scratch + n_chunks * 6;
  ray_boxes_kernel<<<static_cast<unsigned>(n_super), BOX_THREADS, 0, stream>>>(
      rays, P, g, chunk_box, super_box);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(back_blocks(g, V)), lane_groups);
  back_kernel<T><<<grid, THREADS, 0, stream>>>(rays, P, chunk_box, super_box, x, B, V, g,
                                                pick_brick(g), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// elements (of the operand's dtype, 4 or 8 bytes) of the scratch one call
// needs: which 0 forward none, 1 back the ray boxes' ints (6 a chunk and 6
// a super box)
long long sart_implicit_scratch_elems(int which, long long P, long long V, int B) {
  (void)V;
  (void)B;
  if (which == 0) return 0;
  const long long n_chunks = chunks(P, CHUNK);
  return 6 * (n_chunks + chunks(n_chunks, SUPER));
}

// which 0: out [B, P] = x [B, V] projected forward; 1: out [B, V] = x
// [B, P] projected back. dtype 0 fp32, 1 fp64 (x and out). rays [P, 6]
// fp32, contiguous; the grid grid_voxels / (ny nz) x ny x nz cells of the
// first grid_voxels columns (the rest are padding and project to zero).
// part: the scratch of sart_implicit_scratch_elems. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for arguments out of
// range).
int sart_implicit_project(int which, int dtype, const float* rays, long long P,
                          const void* x, int B, long long V, long long ny, long long nz,
                          long long grid_voxels, float ox, float oy, float oz, float sx,
                          float sy, float sz, void* part, void* out, void* stream) {
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || P < 1 || V < 1 || B < 1 ||
      ny < 1 || nz < 1 || ny > INT_MAX || nz > INT_MAX || grid_voxels < 0 ||
      grid_voxels > V || grid_voxels % (ny * nz) != 0 || grid_voxels / (ny * nz) > INT_MAX ||
      chunks(P * GROUP, THREADS) > INT_MAX || chunks(P, BOX_THREADS) > INT_MAX ||
      (B + LANES - 1) / LANES > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{{grid_voxels / (ny * nz), ny, nz},
               {ox, oy, oz},
               {sx, sy, sz},
               {1.f / sx, 1.f / sy, 1.f / sz}};
  if (back_blocks(g, V) > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* scratch = static_cast<int*>(part);
  if (dtype == 0)
    return launch<float>(which, rays, P, static_cast<const float*>(x), B, V, g, scratch,
                         static_cast<float*>(out), s);
  return launch<double>(which, rays, P, static_cast<const double*>(x), B, V, g, scratch,
                        static_cast<double*>(out), s);
}

}  // extern "C"
