// Fused SART sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sartsolver_tpu/ops/fused_sweep.py:_sweep_kernel
// (called through fused_sweep, :829), all four of its variants. One call
// computes, for the dense ray-transfer matrix H [P, V] (row-major), pixel
// weights w [B, P] and the current solution f [B, V]:
//
//   bp     = w @ H                       [B, V]
//   f_new  = update(f, bp * s, aux...)    [B, V]   (elementwise, below)
//   fitted = (f_new * s) @ H^T           [B, P]
//
// H is stored as fp32 (B1, B2), bf16 (B3) or int8 codes (B4). Every element
// is converted exactly to fp32 as it is loaded, and all arithmetic is fp32.
// s is the int8 codes' per-voxel scale [V] (the TPU kernel's fwd_scale aux
// panel, :813): bp is summed in code space and rounded times s before the
// update, and the forward operand is f_new * s rounded (models/sart.py
// :1309-1311, :1322-1324). Other storage has no s: both products use f_new
// and bp as they are.
//
// update, mode 0 (linear, models/sart.py:_lin_update):
//   f_new = max(f + invd * bp - pen, 0)          aux = invd [, pen]
// update, mode 1 (logarithmic, models/sart.py:_log_update):
//   f_new = f * ((obs + eps) / (bp * vm + eps))^alpha * exp(-pen)
//                                                 aux = vm, obs [, pen]
// Each aux panel has 1 row (broadcast over the batch) or B rows.
//
// What bounds it: one read of H, P*V*sizeof(T) bytes. At P = 8192,
// V = 65536 that is 2.147 GB in fp32 (0.64 ms at the H100 SXM's 3.35 TB/s),
// 1.07 GB in bf16 and 0.54 GB in int8 (use the bandwidth of the card
// nvidia-smi names). The 4*B*P*V fp32 operations are far below the fp32
// rate at B = 1; at B = 32 they bound it (68.7 GFLOP, 1.03 ms at 67 TFLOP/s).
//
// The design: the TPU kernel keeps a [P, bs] column panel in VMEM and
// accumulates `fitted` across a sequential grid, so H is read once. Here the
// grid is parallel and a whole panel does not fit in shared memory, so this
// first design reads H twice, in two launches on the caller's stream:
//
//   bp_update_kernel: one block per panel of 32*VW voxels. Warp k of the 8
//     sums rows p = k, k+8, k+16, ... in ascending order (each lane holds VW
//     neighbouring columns, loaded as one vector when VW = 4: a float4, 8
//     bytes of bf16 or a char4 of codes); a fixed-order sum over the 8 warps
//     in shared memory finishes bp, and the block applies the update and
//     writes f_new.
//   forward_kernel: each warp owns R pixel rows; lanes stride over the voxel
//     axis in a fixed order, then a fixed butterfly of shuffles sums the
//     lanes. fitted is written once per row.
//
// No atomics: a given launch configuration gives byte-identical results run
// to run. Batches are processed NB rows at a time (grid.y); rows past B are
// clamped duplicates whose results are discarded, so each batch tile reads
// H again (B = 32 reads it 2 * 8 times). Ragged P and V are masked here;
// nothing is assumed about alignment beyond what the launcher checks.
// Reading H once (a P-split panel held across a thread-block cluster's
// distributed shared memory) and the tensor cores for large B are left for
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;           // warps per block, both kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;          // rows in flight per warp, bp kernel
constexpr int kRowsPerWarp = 2;     // pixel rows per warp, forward kernel

struct AuxPanels {
  const float* ptr[3];
  long long stride[3];  // 0 for a broadcast row, V for B rows
};

// bf16 storage is carried as its bit pattern: a bf16 value is the upper 16
// bits of the fp32 value it stands for, so the conversion is a shift and is
// exact (no rounding, infinities and NaNs kept).
typedef uint16_t bf16_bits;

__device__ __forceinline__ float bf16_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// VW neighbouring elements of storage type T, loaded as one vector when
// VW = 4 and converted exactly to fp32.
template <typename T, int VW> struct Vec;
template <> struct Vec<float, 1> {
  float x[1];
  __device__ __forceinline__ static Vec load(const float* p) {
    Vec v;
    v.x[0] = __ldg(p);
    return v;
  }
};
template <> struct Vec<float, 4> {
  float x[4];
  __device__ __forceinline__ static Vec load(const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    Vec v;
    v.x[0] = q.x; v.x[1] = q.y; v.x[2] = q.z; v.x[3] = q.w;
    return v;
  }
};
template <> struct Vec<bf16_bits, 1> {
  float x[1];
  __device__ __forceinline__ static Vec load(const bf16_bits* p) {
    Vec v;
    v.x[0] = bf16_to_float(__ldg(p));
    return v;
  }
};
template <> struct Vec<bf16_bits, 4> {
  float x[4];
  __device__ __forceinline__ static Vec load(const bf16_bits* p) {
    // four bf16 in one 8-byte load; the lower half of each word comes first
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    Vec v;
    v.x[0] = bf16_to_float(q.x & 0xffffu); v.x[1] = bf16_to_float(q.x >> 16);
    v.x[2] = bf16_to_float(q.y & 0xffffu); v.x[3] = bf16_to_float(q.y >> 16);
    return v;
  }
};
template <> struct Vec<int8_t, 1> {
  float x[1];
  __device__ __forceinline__ static Vec load(const int8_t* p) {
    Vec v;
    v.x[0] = (float)__ldg(reinterpret_cast<const signed char*>(p));
    return v;
  }
};
template <> struct Vec<int8_t, 4> {
  float x[4];
  __device__ __forceinline__ static Vec load(const int8_t* p) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(p));
    Vec v;
    v.x[0] = (float)q.x; v.x[1] = (float)q.y; v.x[2] = (float)q.z; v.x[3] = (float)q.w;
    return v;
  }
};

// The elementwise update, written with explicit roundings (no fused
// multiply-add) so it rounds like the plain PyTorch version.
__device__ __forceinline__ float update(int mode, int has_pen, float alpha,
                                        float eps, float f, float bp,
                                        const AuxPanels& aux, int b,
                                        long long v) {
  if (mode == 0) {
    const float invd = aux.ptr[0][b * aux.stride[0] + v];
    float upd = __fadd_rn(f, __fmul_rn(invd, bp));
    if (has_pen) upd = __fsub_rn(upd, aux.ptr[1][b * aux.stride[1] + v]);
    return upd < 0.0f ? 0.0f : upd;
  }
  const float vm = aux.ptr[0][b * aux.stride[0] + v];
  const float obs = aux.ptr[1][b * aux.stride[1] + v];
  const float fit = __fmul_rn(bp, vm);
  float ratio = __fdiv_rn(__fadd_rn(obs, eps), __fadd_rn(fit, eps));
  if (alpha != 1.0f) ratio = powf(ratio, alpha);
  float out = __fmul_rn(f, ratio);
  if (has_pen) out = __fmul_rn(out, expf(-aux.ptr[2][b * aux.stride[2] + v]));
  return out;
}

// kScaled (int8 codes): bp is in code space and is rounded times the voxel's
// scale before the update.
template <typename T, int NB, int VW>
__global__ void __launch_bounds__(kThreads)
bp_update_kernel(const T* __restrict__ H, const float* __restrict__ scale,
                 const float* __restrict__ w, const float* __restrict__ f,
                 AuxPanels aux, float* __restrict__ f_new, int P, int V, int B,
                 int mode, int has_pen, float alpha, float eps) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int kPanel = 32 * VW;
  __shared__ float part[kWarps][NB][kPanel];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long panel0 = (long long)blockIdx.x * kPanel;
  const long long v0 = panel0 + (long long)lane * VW;
  const int b0 = blockIdx.y * NB;

  const float* wrow[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    wrow[b] = w + (long long)min(b0 + b, B - 1) * P;

  float acc[NB][VW];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[b][k] = 0.0f;

  // VW = 4 is only launched when V % 4 == 0, so v0 < V covers the whole
  // vector; with VW = 1 it is the plain column mask.
  if (v0 < V) {
    const T* hcol = H + v0;
    int p = warp;
    for (; p + (kUnroll - 1) * kWarps < P; p += kUnroll * kWarps) {
      Vec<T, VW> h[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        h[u] = Vec<T, VW>::load(hcol + (long long)(p + u * kWarps) * V);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float wv = __ldg(wrow[b] + p + u * kWarps);
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[b][k] = fmaf(wv, h[u].x[k], acc[b][k]);
        }
      }
    }
    for (; p < P; p += kWarps) {
      const Vec<T, VW> h = Vec<T, VW>::load(hcol + (long long)p * V);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float wv = __ldg(wrow[b] + p);
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[b][k] = fmaf(wv, h.x[k], acc[b][k]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < VW; ++k) part[warp][b][lane * VW + k] = acc[b][k];
  __syncthreads();

  for (int idx = threadIdx.x; idx < NB * kPanel; idx += kThreads) {
    const int b = idx / kPanel;
    const int c = idx - b * kPanel;
    const long long v = panel0 + c;
    const int bb = b0 + b;
    if (v < V && bb < B) {
      float bp = part[0][b][c];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) bp += part[k][b][c];
      if (kScaled) bp = __fmul_rn(bp, scale[v]);
      const long long i = (long long)bb * V + v;
      f_new[i] = update(mode, has_pen, alpha, eps, f[i], bp, aux, bb, v);
    }
  }
}

// kScaled (int8 codes): the forward operand is f_new * scale, rounded.
template <typename T, int NB, int VW>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const T* __restrict__ H, const float* __restrict__ scale,
               const float* __restrict__ f_new, float* __restrict__ fitted,
               int P, int V, int B) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const int b0 = blockIdx.y * NB;

  const T* hrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    hrow[r] = H + (p0 + r < P ? p0 + r : (long long)P - 1) * V;
  const float* frow[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    frow[b] = f_new + (long long)min(b0 + b, B - 1) * V;

  float acc[kRowsPerWarp][NB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.0f;

  // the forward operand's vector at i: f_new, times the scale when kScaled
  auto operand = [&](int b, long long i) {
    Vec<float, VW> x = Vec<float, VW>::load(frow[b] + i * VW);
    if (kScaled) {
      const Vec<float, VW> s = Vec<float, VW>::load(scale + i * VW);
#pragma unroll
      for (int k = 0; k < VW; ++k) x.x[k] = __fmul_rn(x.x[k], s.x[k]);
    }
    return x;
  };

  const long long nvec = V / VW;
  long long i = lane;
  // two vectors per lane in flight per row, then the tail
  for (; i + 32 < nvec; i += 64) {
    Vec<T, VW> h0[kRowsPerWarp], h1[kRowsPerWarp];
    Vec<float, VW> x0[NB], x1[NB];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      h0[r] = Vec<T, VW>::load(hrow[r] + i * VW);
      h1[r] = Vec<T, VW>::load(hrow[r] + (i + 32) * VW);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      x0[b] = operand(b, i);
      x1[b] = operand(b, i + 32);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[r][b] = fmaf(x0[b].x[k], h0[r].x[k], acc[r][b]);
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[r][b] = fmaf(x1[b].x[k], h1[r].x[k], acc[r][b]);
      }
  }
  for (; i < nvec; i += 32) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const Vec<T, VW> h = Vec<T, VW>::load(hrow[r] + i * VW);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const Vec<float, VW> x = operand(b, i);
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[r][b] = fmaf(x.x[k], h.x[k], acc[r][b]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float s = acc[r][b];
      // a + b == b + a exactly, so every lane ends with the same sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[r][b] = s;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (p0 + r < P && b0 + b < B)
          fitted[(long long)(b0 + b) * P + p0 + r] = acc[r][b];
  }
}

struct Args {
  const float* scale;
  const float* w;
  const float* f;
  AuxPanels aux;
  float* f_new;
  float* fitted;
  int P, V, B, mode, has_pen;
  float alpha, eps;
  cudaStream_t stream;
};

template <typename T, int NB, int VW>
cudaError_t launch(const T* H, const Args& a) {
  const unsigned nbatch = (unsigned)((a.B + NB - 1) / NB);
  const dim3 grid_bp((unsigned)((a.V + 32 * VW - 1) / (32 * VW)), nbatch);
  bp_update_kernel<T, NB, VW><<<grid_bp, kThreads, 0, a.stream>>>(
      H, a.scale, a.w, a.f, a.aux, a.f_new, a.P, a.V, a.B, a.mode, a.has_pen,
      a.alpha, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * kRowsPerWarp;
  const dim3 grid_fwd((unsigned)((a.P + rows_per_block - 1) / rows_per_block), nbatch);
  forward_kernel<T, NB, VW><<<grid_fwd, kThreads, 0, a.stream>>>(
      H, a.scale, a.f_new, a.fitted, a.P, a.V, a.B);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t dispatch_nb(const T* H, const Args& a) {
  if (a.B == 1) return launch<T, 1, VW>(H, a);
  if (a.B == 2) return launch<T, 2, VW>(H, a);
  return launch<T, 4, VW>(H, a);
}

// The vector path needs whole vectors per row (V % 4 == 0) and H, f_new
// and the scale aligned for a 4-element load of their types.
template <typename T>
cudaError_t dispatch(const void* H, const Args& a) {
  const T* h = static_cast<const T*>(H);
  const bool vec4 = a.V % 4 == 0 && (uintptr_t)H % (4 * sizeof(T)) == 0 &&
                    (uintptr_t)a.f_new % 16 == 0 &&
                    (uintptr_t)a.scale % 16 == 0;
  return vec4 ? dispatch_nb<T, 4>(h, a) : dispatch_nb<T, 1>(h, a);
}

}  // namespace

// Returns a cudaError_t (0 on success). H is a device pointer to a
// contiguous [P, V] matrix of the storage type `storage` (0 fp32, 1 bf16,
// 2 int8 codes); scale is the codes' [V] fp32 scale, given for int8 and only
// for int8. Every other pointer is a device pointer to a contiguous fp32
// array; aux_rows[i] is 1 (broadcast) or B. The caller allocates f_new
// [B, V] and fitted [B, P].
extern "C" int sart_fused_sweep(const void* H, int storage, const float* scale,
                                const float* w, const float* f,
                                const float* aux0, const float* aux1,
                                const float* aux2, const long long* aux_rows,
                                int n_aux, float* f_new, float* fitted,
                                long long P, long long V, long long B,
                                int mode, float alpha, float eps,
                                void* stream) {
  if (P <= 0 || V <= 0 || B <= 0 || P > 0x7fffffffLL || V > 0x7fffffffLL ||
      B > 0x7fffffffLL || (B + 3) / 4 > 65535)
    return (int)cudaErrorInvalidValue;
  const int want = mode == 0 ? 1 : 2;  // aux panels without the penalty
  if ((mode != 0 && mode != 1) || (n_aux != want && n_aux != want + 1))
    return (int)cudaErrorInvalidValue;
  if (storage < 0 || storage > 2 || (storage == 2) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.scale = scale;
  a.w = w;
  a.f = f;
  const float* ptrs[3] = {aux0, aux1, aux2};
  for (int i = 0; i < 3; ++i) {
    a.aux.ptr[i] = ptrs[i];
    a.aux.stride[i] = (i < n_aux && aux_rows[i] != 1) ? V : 0;
  }
  a.f_new = f_new;
  a.fitted = fitted;
  a.P = (int)P;
  a.V = (int)V;
  a.B = (int)B;
  a.mode = mode;
  a.has_pen = n_aux == want + 1;
  a.alpha = alpha;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (storage == 0)
    err = dispatch<float>(H, a);
  else if (storage == 1)
    err = dispatch<bf16_bits>(H, a);
  else
    err = dispatch<int8_t>(H, a);
  return (int)err;
}
