// The matrix-free ray-voxel projector of the implicit operator
// (sartsolver_tpu_torch/operators/implicit.py), CUDA C++ for sm_90a.
//
// It replaces no Pallas kernel. The JAX package rebuilds H in plain XLA: a
// fori_loop over 1024-voxel panels, each a [P, panel] block of ray segment
// lengths from the slab method (sartsolver_tpu/operators/implicit.py:117-161,
// used at :164-227), which XLA fuses into one elementwise chain per panel.
// Eager PyTorch fuses nothing: at P = 8192 rays and V = 65,536 voxels a
// panel makes about fifteen [8192, 1024, 3] fp32 temporaries, about 3 GB of
// device traffic a panel and 200 GB a projection (about 60 ms at 3.35
// TB/s). Computed in registers the same work is 5.4e8 ray-voxel pairs of
// about 40 fp32 instructions, under a millisecond at the card's instruction
// rate. So the plain version serves the CPU and this kernel the card.
//
// What bounds it: instructions, not bytes. Its inputs are the [P, 6] ray
// table and a [B, V] or [B, P] operand; every entry of H is recomputed. Its
// design against that bound: no panel in memory (each entry lives in
// registers for the instant it is used), each entry reused across up to
// LANES batch rows, the per-voxel box corners (forward) or the per-ray
// origin, reciprocal direction and flags (back) computed once per block
// tile in shared memory, zero entries skipped. A traversal that visits only
// the voxels a ray crosses (Siddon / DDA) is the faster design left for
// later.
//
// Two entry points, both deterministic (no atomics: the port keeps chain =
// serial and scheduler = classic byte for byte):
//   forward  [B, V] -> [B, P]: a block takes a tile of THREADS rays (one a
//            thread) and a chunk of FWD_CHUNK voxels; partial sums go to
//            [n_chunks, B, P], a second pass adds the chunks in order.
//   back     [B, P] -> [B, V]: a thread owns a voxel and walks the rays of
//            its chunk in order (BACK_CHUNK rays a chunk, staged RAY_TILE
//            at a time in shared memory); partials [n_chunks, B, V], added
//            in chunk order.
// Ray stats and the ordered-subsets densities run through the same two
// entry points (all-ones and subset-indicator operands).
//
// The entries are the plain version's bit for bit: the box corners
// origin + idx * spacing, the slab distances (lo - o) * inv and the
// reciprocal 1 / d are written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, so nvcc cannot contract them into FMAs (one ulp in a corner
// can move a face-riding ray's segment into the neighbouring voxel, the
// half-open [lo, hi) rule). The sums accumulate in the operand's type
// (fp32 or fp64) and may contract; they agree with the plain version's
// within the summation order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 8;          // batch rows a block carries in registers
constexpr int VOX_TILE = 256;     // voxel boxes staged at once (forward)
constexpr int RAY_TILE = 512;     // rays staged at once (back)
constexpr long long FWD_CHUNK = 2048;   // voxels a forward block covers
constexpr long long BACK_CHUNK = 2048;  // rays a back block covers
constexpr float EPS = 1e-7f;  // |d| below it: the ray is parallel to the axis
constexpr float BIG = 1e30f;  // stands in for infinity in the slab algebra

struct Grid {
  long long ny, nz, grid_voxels;
  float ox, oy, oz, sx, sy, sz;
};

// one ray, prepared once: origin, the reciprocal of its direction (1 on a
// parallel axis), bits 0-2 the parallel axes, bit 3 a live ray (|d|^2 > 0.5;
// zero-padded rows are dead)
struct Ray {
  float o[3];
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
    bool parallel = fabsf(d) < EPS;
    ray.inv[a] = __fdiv_rn(1.f, parallel ? 1.f : d);
    flags |= parallel ? (1 << a) : 0;
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  ray.flags = flags | (d2 > 0.5f ? 8 : 0);
  return ray;
}

__device__ __forceinline__ Box voxel_box(long long v, const Grid& g) {
  // flat voxel id -> (ix, iy, iz), x slowest, z fastest
  long long ix = v / (g.ny * g.nz);
  long long iy = (v / g.nz) % g.ny;
  long long iz = v % g.nz;
  Box b;
  b.lo[0] = __fadd_rn(g.ox, __fmul_rn(static_cast<float>(ix), g.sx));
  b.lo[1] = __fadd_rn(g.oy, __fmul_rn(static_cast<float>(iy), g.sy));
  b.lo[2] = __fadd_rn(g.oz, __fmul_rn(static_cast<float>(iz), g.sz));
  b.hi[0] = __fadd_rn(b.lo[0], g.sx);
  b.hi[1] = __fadd_rn(b.lo[1], g.sy);
  b.hi[2] = __fadd_rn(b.lo[2], g.sz);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ rays, long long P,
               const T* __restrict__ f, int B, long long V, Grid g,
               T* __restrict__ part) {
  __shared__ float s_lo[VOX_TILE][3];
  __shared__ float s_hi[VOX_TILE][3];
  __shared__ T s_f[LANES][VOX_TILE];
  const long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int b0 = blockIdx.z * LANES;
  const int nb = min(LANES, B - b0);
  const long long v0 = static_cast<long long>(blockIdx.y) * FWD_CHUNK;
  const long long v1 = min(v0 + FWD_CHUNK, V);
  const long long v_end = min(v1, g.grid_voxels);  // padding columns are zero
  Ray ray;
  ray.flags = 0;
  if (p < P) ray = load_ray(rays + p * 6);
  const bool live = (ray.flags & 8) != 0;
  T acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = T(0);
  for (long long t0 = v0; t0 < v_end; t0 += VOX_TILE) {
    const int n = static_cast<int>(min(static_cast<long long>(VOX_TILE), v_end - t0));
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      Box b = voxel_box(t0 + i, g);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s_lo[i][a] = b.lo[a];
        s_hi[i][a] = b.hi[a];
      }
    }
    for (int i = threadIdx.x; i < LANES * VOX_TILE; i += THREADS) {
      const int l = i / VOX_TILE, j = i % VOX_TILE;
      s_f[l][j] = (l < nb && j < n) ? f[static_cast<long long>(b0 + l) * V + t0 + j] : T(0);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float L = seg_length(ray, s_lo[j], s_hi[j]);
        if (L != 0.f) {
          const T e = static_cast<T>(L);
#pragma unroll
          for (int l = 0; l < LANES; ++l) acc[l] += e * s_f[l][j];
        }
      }
    }
  }
  if (p < P) {
    for (int l = 0; l < nb; ++l)
      part[(static_cast<long long>(blockIdx.y) * B + b0 + l) * P + p] = acc[l];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
back_kernel(const float* __restrict__ rays, long long P,
            const T* __restrict__ w, int B, long long V, Grid g,
            T* __restrict__ part) {
  __shared__ float s_o[RAY_TILE][3];
  __shared__ float s_inv[RAY_TILE][3];
  __shared__ int s_flags[RAY_TILE];
  __shared__ T s_w[LANES][RAY_TILE];
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int b0 = blockIdx.z * LANES;
  const int nb = min(LANES, B - b0);
  const long long p0 = static_cast<long long>(blockIdx.y) * BACK_CHUNK;
  const long long p1 = min(p0 + BACK_CHUNK, P);
  const bool in_grid = v < V && v < g.grid_voxels;
  Box box;
  if (in_grid) box = voxel_box(v, g);
  T acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = T(0);
  for (long long t0 = p0; t0 < p1; t0 += RAY_TILE) {
    const int n = static_cast<int>(min(static_cast<long long>(RAY_TILE), p1 - t0));
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      Ray r = load_ray(rays + (t0 + i) * 6);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s_o[i][a] = r.o[a];
        s_inv[i][a] = r.inv[a];
      }
      s_flags[i] = r.flags;
    }
    for (int i = threadIdx.x; i < LANES * RAY_TILE; i += THREADS) {
      const int l = i / RAY_TILE, j = i % RAY_TILE;
      s_w[l][j] = (l < nb && j < n) ? w[static_cast<long long>(b0 + l) * P + t0 + j] : T(0);
    }
    __syncthreads();
    if (in_grid) {
      for (int j = 0; j < n; ++j) {
        Ray r;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          r.o[a] = s_o[j][a];
          r.inv[a] = s_inv[j][a];
        }
        r.flags = s_flags[j];
        if (!(r.flags & 8)) continue;
        const float L = seg_length(r, box.lo, box.hi);
        if (L != 0.f) {
          const T e = static_cast<T>(L);
#pragma unroll
          for (int l = 0; l < LANES; ++l) acc[l] += e * s_w[l][j];
        }
      }
    }
  }
  if (v < V) {
    for (int l = 0; l < nb; ++l)
      part[(static_cast<long long>(blockIdx.y) * B + b0 + l) * V + v] = acc[l];
  }
}

// out[i] = sum over chunks c, in order, of part[c * n + i]
template <typename T>
__global__ void sum_chunks_kernel(const T* __restrict__ part, int n_chunks,
                                  long long n, T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = part[i];
  for (int c = 1; c < n_chunks; ++c) s += part[static_cast<long long>(c) * n + i];
  out[i] = s;
}

long long chunks(long long n, long long chunk) { return (n + chunk - 1) / chunk; }

template <typename T>
int launch(int which, const float* rays, long long P, const T* x, int B, long long V,
           const Grid& g, T* part, T* out, cudaStream_t stream) {
  const long long lane_groups = (B + LANES - 1) / LANES;
  long long n_chunks, n_out;
  dim3 grid;
  if (which == 0) {
    n_chunks = chunks(V, FWD_CHUNK);
    n_out = static_cast<long long>(B) * P;
    grid = dim3(static_cast<unsigned>(chunks(P, THREADS)),
                static_cast<unsigned>(n_chunks), static_cast<unsigned>(lane_groups));
    forward_kernel<T><<<grid, THREADS, 0, stream>>>(rays, P, x, B, V, g, part);
  } else {
    n_chunks = chunks(P, BACK_CHUNK);
    n_out = static_cast<long long>(B) * V;
    grid = dim3(static_cast<unsigned>(chunks(V, THREADS)),
                static_cast<unsigned>(n_chunks), static_cast<unsigned>(lane_groups));
    back_kernel<T><<<grid, THREADS, 0, stream>>>(rays, P, x, B, V, g, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_chunks_kernel<T><<<static_cast<unsigned>(chunks(n_out, 256)), 256, 0, stream>>>(
      part, static_cast<int>(n_chunks), n_out, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// elements of the partial-sum scratch one call needs: which 0 forward
// ([n_chunks, B, P]), 1 back ([n_chunks, B, V])
long long sart_implicit_scratch_elems(int which, long long P, long long V, int B) {
  if (which == 0) return chunks(V, FWD_CHUNK) * B * P;
  return chunks(P, BACK_CHUNK) * B * V;
}

// which 0: out [B, P] = x [B, V] projected forward; 1: out [B, V] = x
// [B, P] projected back. dtype 0 fp32, 1 fp64 (x, part and out). rays
// [P, 6] fp32, contiguous. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for arguments out of range).
int sart_implicit_project(int which, int dtype, const float* rays, long long P,
                          const void* x, int B, long long V, long long ny, long long nz,
                          long long grid_voxels, float ox, float oy, float oz, float sx,
                          float sy, float sz, void* part, void* out, void* stream) {
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || P < 1 || V < 1 || B < 1 ||
      ny < 1 || nz < 1 || grid_voxels < 0 || chunks(P, THREADS) > 2147483647LL ||
      chunks(V, THREADS) > 2147483647LL || chunks(V, FWD_CHUNK) > 65535 ||
      chunks(P, BACK_CHUNK) > 65535 || (B + LANES - 1) / LANES > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g{ny, nz, grid_voxels, ox, oy, oz, sx, sy, sz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(which, rays, P, static_cast<const float*>(x), B, V, g,
                         static_cast<float*>(part), static_cast<float*>(out), s);
  return launch<double>(which, rays, P, static_cast<const double*>(x), B, V, g,
                        static_cast<double*>(part), static_cast<double*>(out), s);
}

}  // extern "C"
