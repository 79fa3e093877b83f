// Fused SART sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sartsolver_tpu/ops/fused_sweep.py:_sweep_kernel
// (called through fused_sweep, :829). One call computes, for the dense fp32
// ray-transfer matrix H [P, V] (row-major), pixel weights w [B, P] and the
// current solution f [B, V]:
//
//   bp     = w @ H                       [B, V]
//   f_new  = update(f, bp, aux...)        [B, V]   (elementwise, below)
//   fitted = f_new @ H^T                 [B, P]
//
// update, mode 0 (linear, models/sart.py:_lin_update):
//   f_new = max(f + invd * bp - pen, 0)          aux = invd [, pen]
// update, mode 1 (logarithmic, models/sart.py:_log_update):
//   f_new = f * ((obs + eps) / (bp * vm + eps))^alpha * exp(-pen)
//                                                 aux = vm, obs [, pen]
// Each aux panel has 1 row (broadcast over the batch) or B rows.
//
// What bounds it: one read of H, P*V*4 bytes. At P = 8192, V = 65536 that is
// 2.147 GB, 0.64 ms at the H100 SXM's 3.35 TB/s (use the bandwidth of the
// card nvidia-smi names). The FLOPs (4*B*P*V) are far below the fp32 rate.
//
// The design: the TPU kernel keeps a [P, bs] column panel in VMEM and
// accumulates `fitted` across a sequential grid, so H is read once. Here the
// grid is parallel and a whole panel does not fit in shared memory, so this
// first design reads H twice, in two launches on the caller's stream:
//
//   bp_update_kernel: one block per panel of 32*VW voxels. Warp k of the 8
//     sums rows p = k, k+8, k+16, ... in ascending order (each lane holds VW
//     neighbouring columns, loaded as one float4 when VW = 4, so a warp reads
//     512 contiguous bytes of a row); a fixed-order sum over the 8 warps in
//     shared memory finishes bp, and the block applies the update and writes
//     f_new.
//   forward_kernel: each warp owns R pixel rows; lanes stride over the voxel
//     axis in a fixed order, then a fixed butterfly of shuffles sums the
//     lanes. fitted is written once per row.
//
// No atomics: a given launch configuration gives byte-identical results run
// to run. Batches are processed NB rows at a time (grid.y); rows past B are
// clamped duplicates whose results are discarded. Ragged P and V are masked
// here; nothing is assumed about alignment beyond what the launcher checks.
// Reading H once (a P-split panel held across a thread-block cluster's
// distributed shared memory) is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps per block, both kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;          // rows in flight per warp, bp kernel
constexpr int kRowsPerWarp = 2;     // pixel rows per warp, forward kernel

struct AuxPanels {
  const float* ptr[3];
  long long stride[3];  // 0 for a broadcast row, V for B rows
};

template <int VW> struct Vec;
template <> struct Vec<1> {
  float x[1];
  __device__ __forceinline__ static Vec load(const float* p) {
    Vec v;
    v.x[0] = __ldg(p);
    return v;
  }
};
template <> struct Vec<4> {
  float x[4];
  __device__ __forceinline__ static Vec load(const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    Vec v;
    v.x[0] = q.x; v.x[1] = q.y; v.x[2] = q.z; v.x[3] = q.w;
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

template <int NB, int VW>
__global__ void __launch_bounds__(kThreads)
bp_update_kernel(const float* __restrict__ H, const float* __restrict__ w,
                 const float* __restrict__ f, AuxPanels aux,
                 float* __restrict__ f_new, int P, int V, int B, int mode,
                 int has_pen, float alpha, float eps) {
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
  // float4; with VW = 1 it is the plain column mask.
  if (v0 < V) {
    const float* hcol = H + v0;
    int p = warp;
    for (; p + (kUnroll - 1) * kWarps < P; p += kUnroll * kWarps) {
      Vec<VW> h[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        h[u] = Vec<VW>::load(hcol + (long long)(p + u * kWarps) * V);
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
      const Vec<VW> h = Vec<VW>::load(hcol + (long long)p * V);
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
      const long long i = (long long)bb * V + v;
      f_new[i] = update(mode, has_pen, alpha, eps, f[i], bp, aux, bb, v);
    }
  }
}

template <int NB, int VW>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ H, const float* __restrict__ f_new,
               float* __restrict__ fitted, int P, int V, int B) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const int b0 = blockIdx.y * NB;

  const float* hrow[kRowsPerWarp];
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

  const long long nvec = V / VW;
  long long i = lane;
  // two vectors per lane in flight per row, then the tail
  for (; i + 32 < nvec; i += 64) {
    Vec<VW> h0[kRowsPerWarp], h1[kRowsPerWarp], x0[NB], x1[NB];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      h0[r] = Vec<VW>::load(hrow[r] + i * VW);
      h1[r] = Vec<VW>::load(hrow[r] + (i + 32) * VW);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      x0[b] = Vec<VW>::load(frow[b] + i * VW);
      x1[b] = Vec<VW>::load(frow[b] + (i + 32) * VW);
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
      const Vec<VW> h = Vec<VW>::load(hrow[r] + i * VW);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const Vec<VW> x = Vec<VW>::load(frow[b] + i * VW);
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

template <int NB, int VW>
cudaError_t launch(const float* H, const float* w, const float* f,
                   const AuxPanels& aux, float* f_new, float* fitted, int P,
                   int V, int B, int mode, int has_pen, float alpha,
                   float eps, cudaStream_t stream) {
  const unsigned nbatch = (unsigned)((B + NB - 1) / NB);
  const dim3 grid_bp((unsigned)((V + 32 * VW - 1) / (32 * VW)), nbatch);
  bp_update_kernel<NB, VW><<<grid_bp, kThreads, 0, stream>>>(
      H, w, f, aux, f_new, P, V, B, mode, has_pen, alpha, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * kRowsPerWarp;
  const dim3 grid_fwd((unsigned)((P + rows_per_block - 1) / rows_per_block), nbatch);
  forward_kernel<NB, VW><<<grid_fwd, kThreads, 0, stream>>>(H, f_new, fitted, P, V, B);
  return cudaGetLastError();
}

template <int VW>
cudaError_t dispatch_nb(const float* H, const float* w, const float* f,
                        const AuxPanels& aux, float* f_new, float* fitted,
                        int P, int V, int B, int mode, int has_pen,
                        float alpha, float eps, cudaStream_t stream) {
  if (B == 1)
    return launch<1, VW>(H, w, f, aux, f_new, fitted, P, V, B, mode, has_pen, alpha, eps, stream);
  if (B == 2)
    return launch<2, VW>(H, w, f, aux, f_new, fitted, P, V, B, mode, has_pen, alpha, eps, stream);
  return launch<4, VW>(H, w, f, aux, f_new, fitted, P, V, B, mode, has_pen, alpha, eps, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). All pointers are device pointers to
// contiguous fp32 arrays; aux_rows[i] is 1 (broadcast) or B. The caller
// allocates f_new [B, V] and fitted [B, P].
extern "C" int sart_fused_sweep(const float* H, const float* w, const float* f,
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
  AuxPanels aux;
  const float* ptrs[3] = {aux0, aux1, aux2};
  for (int i = 0; i < 3; ++i) {
    aux.ptr[i] = ptrs[i];
    aux.stride[i] = (i < n_aux && aux_rows[i] != 1) ? V : 0;
  }
  const int has_pen = n_aux == want + 1;
  const bool vec4 = V % 4 == 0 && ((uintptr_t)H % 16 == 0) &&
                    ((uintptr_t)f_new % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec4 ? dispatch_nb<4>(H, w, f, aux, f_new, fitted, (int)P, (int)V, (int)B,
                            mode, has_pen, alpha, eps, s)
           : dispatch_nb<1>(H, w, f, aux, f_new, fitted, (int)P, (int)V, (int)B,
                            mode, has_pen, alpha, eps, s);
  return (int)err;
}
