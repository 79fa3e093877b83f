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
// is converted exactly to fp32 (or, on the tensor cores, to bf16, which is
// exact for codes), and the sums are fp32. s is the int8 codes' per-voxel
// scale [V] (the TPU kernel's fwd_scale aux panel, :813): bp is summed in
// code space and rounded times s before the update, and the forward operand
// is f_new * s rounded (models/sart.py :1309-1311, :1322-1324). Other storage
// has no s: both products use f_new and bp as they are.
//
// update, mode 0 (linear, models/sart.py:_lin_update):
//   f_new = max(f + invd * bp - pen, 0)          aux = invd [, pen]
// update, mode 1 (logarithmic, models/sart.py:_log_update):
//   f_new = f * ((obs + eps) / (bp * vm + eps))^alpha * exp(-pen)
//                                                 aux = vm, obs [, pen]
// Each aux panel has 1 row (broadcast over the batch) or B rows.
//
// Three plans, chosen by the caller (ops/fused_sweep.py:plan_sweep) and
// refused here, never replaced, when their preconditions fail:
//
// - two_read (every storage, any shape): two launches that each read H,
//   described below. What bounds the sweep is one read of H, P*V*sizeof(T)
//   bytes: at P = 8192, V = 65536, 2.147 GB in fp32 (0.64 ms at the H100
//   SXM's 3.35 TB/s), 1.07 GB in bf16, 0.54 GB in int8.
// - one_read (fp32, B <= 4, P <= 8192, V % 16 == 0): H read once, a 16-column
//   panel split along P over a thread-block cluster (namespace one_read);
//   plan_sweep takes it from P = 7168, where it was measured faster.
// - tensor_core (int8 codes, V % 16 == 0): the three contractions on the bf16
//   tensor cores with the fp32 vectors split exactly into three bf16 pieces
//   (namespace tc). At B = 32 the 4*B*P*V operations bound the sweep: three
//   bf16 products of 68.7 GFLOP at 989 TFLOP/s, 0.208 ms.
//
// two_read: the TPU kernel keeps a [P, bs] column panel in VMEM and
// accumulates `fitted` across a sequential grid, so H is read once. Here
// the grid is parallel and a whole panel does not fit in shared memory, so
// this plan reads H twice, in two launches on the caller's stream:
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
// Batches are processed NB rows at a time (grid.y); rows past B are clamped
// duplicates whose results are discarded, so each batch tile reads H again.
// Ragged P and V are masked.
//
// No plan uses atomics: a given plan and shape give byte-identical results
// run to run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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
// multiply-add) so it rounds like the plain PyTorch version. a0..a2 are the
// voxel's aux values: mode 0 invd [, pen]; mode 1 vm, obs [, pen].
__device__ __forceinline__ float update_vals(int mode, int has_pen, float alpha,
                                             float eps, float f, float bp,
                                             float a0, float a1, float a2) {
  if (mode == 0) {
    float upd = __fadd_rn(f, __fmul_rn(a0, bp));
    if (has_pen) upd = __fsub_rn(upd, a1);
    return upd < 0.0f ? 0.0f : upd;
  }
  const float fit = __fmul_rn(bp, a0);
  float ratio = __fdiv_rn(__fadd_rn(a1, eps), __fadd_rn(fit, eps));
  if (alpha != 1.0f) ratio = powf(ratio, alpha);
  float out = __fmul_rn(f, ratio);
  if (has_pen) out = __fmul_rn(out, expf(-a2));
  return out;
}

// The voxel's aux values at (b, v), loading only the panels the mode reads.
__device__ __forceinline__ void load_aux(const AuxPanels& aux, int mode, int has_pen,
                                         int b, long long v, float& a0, float& a1,
                                         float& a2) {
  a0 = aux.ptr[0][b * aux.stride[0] + v];
  a1 = (mode == 1 || has_pen) ? aux.ptr[1][b * aux.stride[1] + v] : 0.0f;
  a2 = (mode == 1 && has_pen) ? aux.ptr[2][b * aux.stride[2] + v] : 0.0f;
}

__device__ __forceinline__ float update(int mode, int has_pen, float alpha,
                                        float eps, float f, float bp,
                                        const AuxPanels& aux, int b,
                                        long long v) {
  float a0, a1, a2;
  load_aux(aux, mode, has_pen, b, v, a0, a1, a2);
  return update_vals(mode, has_pen, alpha, eps, f, bp, a0, a1, a2);
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

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
// (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Plan "tensor_core": int8 codes at large B on the bf16 tensor cores.
//
// Every fp32 operand x is split exactly into three bf16 pieces, x_hi =
// bf16(x), x_mid = bf16(x - x_hi), x_lo = bf16(x - x_hi - x_mid) (24
// significant bits in all, so hi + mid + lo == x for normal fp32 values).
// A code (|c| <= 127) is exact in bf16 and a bf16 x bf16 product is exact in
// fp32, so three mma.sync.m16n8k16 products with fp32 accumulation give an
// fp32 contraction. Batch rows are padded with zero rows to the MMA's M
// (16, or 32 per batch chunk), and their results are discarded.
//
// Four launches: the split of w ([3, Bpad, Ppad] bf16), the bp + update
// kernel (a block owns 128 voxel columns and all of P, so the update runs in
// its epilogue; it writes f_new and the split forward operand f_new * s,
// [3, Bpad, V] bf16), the forward kernel (a block owns 128 pixel rows and
// one of S fixed splits of V; it writes partials [S, Bpad, P]) and the sum
// of the partials in split order.
//
// Both product kernels stream 64-deep chunks of K through a kStages-deep
// cp.async ring in shared memory (the A pieces and the raw codes), so loads
// stay in flight while the tensor cores work; codes become bf16 in
// registers. The thread's four k-slots of an MMA step ({2t, 2t+1, 2t+8,
// 2t+9} of the m16n8k16 layout) stand for four consecutive k, so an A row
// gives them as one 8-byte load, the forward kernel's codes row as one
// 4-byte word, and the bp kernel's codes as one byte of each of four rows
// (the 4 bytes a thread reads per row are its columns of four n8 tiles).
// The products' order is fixed, so launches are byte-identical.
//
// Accumulation: the tensor cores' fp32 accumulation need not round to
// nearest along an MMA chain. So each 64-deep chunk of K (12 MMAs: 4 steps
// x 3 pieces) accumulates into a zeroed fragment that is then added, rounded
// to nearest, into an fp32 register accumulator. A measurement build may
// define SART_TC_NO_PROMOTE to let the chain run unpromoted instead
// (sweep_measure.py, which measures what the promotion buys).
// ---------------------------------------------------------------------------
namespace tc {

#ifdef SART_TC_NO_PROMOTE
constexpr bool kPromote = false;
#else
constexpr bool kPromote = true;
#endif

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;                 // K per iteration: 4 MMA steps
constexpr int kNT = 4;                     // n8 tiles per warp
constexpr int kBlockN = kWarps * kNT * 8;  // 128 columns (bp) or rows (forward)
constexpr int kTargetBlocks = 528;         // forward blocks to aim for (4 per SM)
constexpr int kStages = 4;                 // cp.async pipeline depth

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte i of w as a signed code, converted exactly to fp32
__device__ __forceinline__ float code(unsigned w, int i) {
  return (float)(int)(signed char)(w >> (8 * i));
}

// two fp32 values exact in bf16 -> one register, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void split3(float x, bf16_bits& hi, bf16_bits& mid,
                                       bf16_bits& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(m));
  hi = __bfloat16_as_ushort(h);
  mid = __bfloat16_as_ushort(m);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

// src [rows, cols] fp32 -> dst [3, rows_pad, cols_pad] bf16 pieces, zero
// outside src
__global__ void split_kernel(const float* __restrict__ src, int rows, int cols,
                             int rows_pad, int cols_pad,
                             bf16_bits* __restrict__ dst) {
  const long long n = (long long)rows_pad * cols_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / cols_pad);
    const int c = (int)(i - (long long)r * cols_pad);
    const float x = (r < rows && c < cols) ? src[(long long)r * cols + c] : 0.0f;
    split3(x, dst[i], dst[n + i], dst[2 * n + i]);
  }
}

// Shared memory of one pipeline stage: the A tile, 3 pieces x R rows x 64 k
// (bf16, 128 bytes a row, 16-byte chunks XOR-swizzled by row & 7), then
// 8 KB of codes (bp: 64 rows of P x 128 columns; forward: 128 rows of P x
// 64 columns).
template <int MT>
struct Stage {
  static constexpr int kRows = 16 * MT;
  static constexpr int kABytes = 3 * kRows * kChunk * 2;
  static constexpr int kBytes = kABytes + 8192;
};

template <int MT>
constexpr int smem_bytes() { return kStages * Stage<MT>::kBytes; }

// Copy the A tile of one K chunk: rows b0.. of each piece (stride ld
// elements, pieces `piece` apart), columns k0..k0+63 (zero past kend).
template <int MT>
__device__ __forceinline__ void load_a_tile(unsigned char* st, const bf16_bits* src,
                                            long long piece, long long ld, int b0,
                                            long long k0, long long kend) {
  constexpr int R = Stage<MT>::kRows;
  bf16_bits* a = reinterpret_cast<bf16_bits*>(st);
  for (int i = threadIdx.x; i < 3 * R * 8; i += kThreads) {
    const int q = i / (R * 8), rem = i - q * R * 8, row = rem >> 3, c = rem & 7;
    const long long k = k0 + c * 8;
    const bool ok = k < kend;
    cp_async16(a + (q * R + row) * kChunk + ((c ^ (row & 7)) << 3),
               src + q * piece + (long long)(b0 + row) * ld + (ok ? k : 0), ok);
  }
}

// The A fragment of m-tile m (rows m*16 + gid, + 8) at the step's k-slots
// (tile column 16 tid + 4 s .. + 3), from a swizzled A tile.
template <int MT>
__device__ __forceinline__ void lds_a(unsigned (&a)[4], const unsigned char* st, int q,
                                      int m, int gid, int tid, int s) {
  constexpr int R = Stage<MT>::kRows;
  const bf16_bits* t = reinterpret_cast<const bf16_bits*>(st) + q * R * kChunk;
  const int r0 = m * 16 + gid, r1 = r0 + 8, c = 2 * tid + (s >> 1), off = (s & 1) * 4;
  const uint2 x0 = *reinterpret_cast<const uint2*>(t + r0 * kChunk + ((c ^ (r0 & 7)) << 3) + off);
  const uint2 x1 = *reinterpret_cast<const uint2*>(t + r1 * kChunk + ((c ^ (r1 & 7)) << 3) + off);
  a[0] = x0.x; a[1] = x1.x; a[2] = x0.y; a[3] = x1.y;
}

// The three pieces' MMAs of one step on every tile, into part (kPromote) or
// straight into acc.
template <int MT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][kNT][4], float (&part)[MT][kNT][4],
                                         const unsigned char* st, const unsigned (&bf)[kNT][2],
                                         int gid, int tid, int s) {
#pragma unroll
  for (int q = 2; q >= 0; --q) {  // lo, mid, hi
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      unsigned a[4];
      lds_a<MT>(a, st, q, m, gid, tid, s);
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        mma_bf16(kPromote ? part[m][t] : acc[m][t], a, bf[t][0], bf[t][1]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&x)[MT][kNT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][t][e] = 0.0f;
}

template <int MT>
__device__ __forceinline__ void promote(float (&acc)[MT][kNT][4], const float (&part)[MT][kNT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = __fadd_rn(acc[m][t][e], part[m][t][e]);
}

// bp = w @ codes on the tensor cores, then the update; writes f_new [B, V]
// and the split forward operand xs [3, Bpad, V] (zero in padded rows). The
// block's codes tile is 64 rows x 128 columns a stage; the thread reads
// word (8 warp + gid) of rows 16 tid + 4 s + j, whose words are
// XOR-swizzled by 8 * (row / 16) so the four tids hit other banks.
template <int MT>
__global__ void __launch_bounds__(kThreads)
bp_update_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                 const bf16_bits* __restrict__ ws, const float* __restrict__ f,
                 AuxPanels aux, float* __restrict__ f_new, bf16_bits* __restrict__ xs,
                 int P, int Ppad, int V, int B, int Bpad, int mode, int has_pen,
                 float alpha, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int b0 = blockIdx.y * 16 * MT;
  const long long nb = (long long)blockIdx.x * kBlockN;  // the block's first column
  const long long n0 = nb + warp * kNT * 8;              // the warp's
  const long long piece = (long long)Bpad * Ppad;
  const int n_iter = Ppad / kChunk;

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * Stage<MT>::kBytes;
    const long long k0 = (long long)it * kChunk;
    load_a_tile<MT>(st, ws, piece, Ppad, b0, k0, Ppad);
    unsigned char* bt = st + Stage<MT>::kABytes;
    for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
      const int row = i >> 3, c = i & 7;
      const long long p = k0 + row, n = nb + c * 16;
      const bool ok = p < P && n < V;  // V % 16 == 0: a chunk is all in or out
      cp_async16(bt + row * 128 + ((c ^ (2 * ((row >> 4) & 3))) << 4),
                 codes + (ok ? p * V + n : 0), ok);
    }
  };

  float acc[MT][kNT][4], part[MT][kNT][4];
  zero<MT>(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_iter) load_stage(i);
    cp_async_commit();
  }
  const int word = (warp * 8 + gid) ^ (8 * tid);
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % kStages) * Stage<MT>::kBytes;
    const unsigned* bt = reinterpret_cast<const unsigned*>(st + Stage<MT>::kABytes);
    if (kPromote) zero<MT>(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) raw[j] = bt[(tid * 16 + 4 * s + j) * 32 + word];
      unsigned bf[kNT][2];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        bf[t][0] = pack_bf16(code(raw[0], t), code(raw[1], t));
        bf[t][1] = pack_bf16(code(raw[2], t), code(raw[3], t));
      }
      mma_step<MT>(acc, part, st, bf, gid, tid, s);
    }
    if (kPromote) promote<MT>(acc, part);
  }

  // C element e of tile t: row gid (+8 for e >= 2), MMA column 2 tid + (e & 1),
  // which is voxel n0 + 8 tid + 4 (e & 1) + t
  const long long vpiece = (long long)Bpad * V;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + m * 16 + gid + 8 * (e >> 1);
        const long long v = n0 + 8 * tid + 4 * (e & 1) + t;
        if (v >= V) continue;
        float x = 0.0f;
        if (b < B) {
          const long long i = (long long)b * V + v;
          const float s = scale[v];
          const float fn = update(mode, has_pen, alpha, eps, f[i],
                                  __fmul_rn(acc[m][t][e], s), aux, b, v);
          f_new[i] = fn;
          x = __fmul_rn(fn, s);
        }
        const long long o = (long long)b * V + v;
        split3(x, xs[o], xs[vpiece + o], xs[2 * vpiece + o]);
      }
}

// partial[split] = xs @ codes^T over the split's range of V. The block's
// codes tile is 128 rows of P x 64 columns a stage; the thread reads 16
// bytes (its k-slots of four steps) of rows 32 warp + 8 t + gid.
template <int MT>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const int8_t* __restrict__ codes, const bf16_bits* __restrict__ xs,
               float* __restrict__ partial, int P, int V, int Bpad, int ksplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * 16 * MT;
  const long long pb = (long long)blockIdx.x * kBlockN;  // the block's first row
  const long long p0 = pb + warp * kNT * 8;              // the warp's
  const long long kbeg = (long long)split * ksplit;
  const long long kend = min((long long)V, kbeg + ksplit);
  const long long piece = (long long)Bpad * V;
  const int n_iter = (int)((kend - kbeg + kChunk - 1) / kChunk);

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * Stage<MT>::kBytes;
    const long long k0 = kbeg + (long long)it * kChunk;
    load_a_tile<MT>(st, xs, piece, V, b0, k0, kend);
    unsigned char* bt = st + Stage<MT>::kABytes;
    for (int i = threadIdx.x; i < 128 * 4; i += kThreads) {
      const int row = i >> 2, c = i & 3;
      const long long p = pb + row, k = k0 + c * 16;
      const bool ok = p < P && k < kend;  // kend % 16 == 0
      cp_async16(bt + row * 64 + c * 16, codes + (ok ? p * V + k : 0), ok);
    }
  };

  float acc[MT][kNT][4], part[MT][kNT][4];
  zero<MT>(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_iter) load_stage(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % kStages) * Stage<MT>::kBytes;
    const unsigned char* bt = st + Stage<MT>::kABytes;
    uint4 raw[kNT];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      raw[t] = *reinterpret_cast<const uint4*>(bt + (warp * 32 + 8 * t + gid) * 64 + tid * 16);
    if (kPromote) zero<MT>(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned bf[kNT][2];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const unsigned w = s == 0 ? raw[t].x : s == 1 ? raw[t].y : s == 2 ? raw[t].z : raw[t].w;
        bf[t][0] = pack_bf16(code(w, 0), code(w, 1));
        bf[t][1] = pack_bf16(code(w, 2), code(w, 3));
      }
      mma_step<MT>(acc, part, st, bf, gid, tid, s);
    }
    if (kPromote) promote<MT>(acc, part);
  }

  // C element e of tile t: batch row gid (+8), pixel p0 + 8 t + 2 tid + (e & 1)
  float* out = partial + (long long)split * Bpad * P;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + m * 16 + gid + 8 * (e >> 1);
        const long long p = p0 + 8 * t + 2 * tid + (e & 1);
        if (p < P) out[(long long)b * P + p] = acc[m][t][e];
      }
}

}  // namespace tc

// fitted[b, p] = sum over n of partial[n, b, p], n in order; partial rows
// are `rows` apart (>= B)
__global__ void sum_partials_kernel(const float* __restrict__ partial, int n,
                                    int rows, int B, int P,
                                    float* __restrict__ fitted) {
  const long long total = (long long)B * P;
  const long long stride = (long long)rows * P;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = partial[i];
    for (int k = 1; k < n; ++k) s += partial[k * stride + i];
    fitted[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Plan "one_read": fp32 storage at small B, H read once.
//
// A thread-block cluster of kCluster CTAs splits P: CTA r holds rows
// [r R, (r + 1) R) (R = ceil(P / kCluster) <= kMaxRows) of a 16-column panel
// in shared memory, 64 bytes a row, brought by cp.async into a ring of
// kStages slabs, so the next panels load while this one is used.
//   bp: each CTA sums its rows' partial bp [B, 16] in a fixed order, writes
//     it to one of two slots, and arrives at the cluster barrier; after the
//     wait every CTA reads the kCluster partials through distributed shared
//     memory in rank order, so all hold the same bp and apply the same
//     update. Rank 0 writes f_new.
//   fitted: each CTA adds its rows' f_new . slab^T into registers
//     (kMaxRows / kThreads rows a thread).
// The clusters are persistent: cluster g walks panels g, g + G, ... and at
// the end writes its fitted [B, P] to partials [G, B, P]; a second launch sums
// them in cluster order. Per panel: one cluster barrier and three block
// barriers; the next two panels' slabs load across them. The slabs' 16-byte
// chunks are XOR-swizzled by row so that both passes read shared memory
// without bank conflicts.
//
// Measured on the H100 (PERF.md §6): this order beat three variants that
// cut barriers, kept fewer slabs in flight or ran 512 threads.
// ---------------------------------------------------------------------------
namespace one_read {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kPanel = 16;
constexpr int kMaxRows = 1024;
constexpr int kStages = 3;
constexpr int kMaxB = 4;
constexpr int kGroups = kThreads / kPanel;           // row groups of the bp pass
constexpr int kRowsPerThread = kMaxRows / kThreads;  // fitted pass
constexpr int kMaxClusters = 16;

struct Smem {
  float slab[kStages][kMaxRows * kPanel];
  float w[kMaxB][kMaxRows];
  float red[kGroups][kMaxB][kPanel];
  float part[2][kMaxB][kPanel];
  float fnew[kMaxB][kPanel];
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// float index of (row r, column c) in a swizzled slab
__device__ __forceinline__ int slab_at(int r, int c) {
  return r * kPanel + ((((c >> 2) ^ (r >> 1)) & 3) << 2) + (c & 3);
}

template <int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
sweep_kernel(const float* __restrict__ H, const float* __restrict__ w,
             const float* __restrict__ f, AuxPanels aux, float* __restrict__ f_new,
             float* __restrict__ partial, int P, int V, int rows, int mode,
             int has_pen, float alpha, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int G = gridDim.x / kCluster;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, P - row0));
  const int n_panels = V / kPanel;
  const int mine = cid < n_panels ? (n_panels - cid + G - 1) / G : 0;
  const int t = threadIdx.x;

  for (int i = t; i < NB * kMaxRows; i += kThreads) {
    const int b = i / kMaxRows, r = i - b * kMaxRows;
    sm.w[b][r] = r < nrows ? w[(long long)b * P + row0 + r] : 0.0f;
  }
  auto load_panel = [&](int k) {  // the k-th panel of this cluster
    const float* src = H + (long long)row0 * V + (long long)(cid + k * G) * kPanel;
    float* dst = sm.slab[k % kStages];
    for (int i = t; i < nrows * 4; i += kThreads) {
      const int r = i >> 2, q = i & 3;
      cp_async16(dst + slab_at(r, 4 * q), src + (long long)r * V + 4 * q, true);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < mine) load_panel(k);
    cp_async_commit();
  }

  float fit[kRowsPerThread][NB];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int b = 0; b < NB; ++b) fit[j][b] = 0.0f;

  const int c = t % kPanel, g = t / kPanel;  // bp pass
  const bool upd = t < NB * kPanel;          // update threads: (b, c) = (g, c)
  for (int i = 0; i < mine; ++i) {
    const long long v = (long long)(cid + i * G) * kPanel + c;
    float fu = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    if (upd) {  // in flight while the partial bp is summed
      fu = f[(long long)g * V + v];
      load_aux(aux, mode, has_pen, g, v, a0, a1, a2);
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const float* slab = sm.slab[i % kStages];

    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
    for (int r = g; r < nrows; r += kGroups) {
      const float h = slab[slab_at(r, c)];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = fmaf(sm.w[b][r], h, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) sm.red[g][b][c] = acc[b];
    __syncthreads();
    float* slot = &sm.part[i & 1][0][0];
    if (upd) {
      float s = sm.red[0][g][c];
#pragma unroll
      for (int k = 1; k < kGroups; ++k) s += sm.red[k][g][c];
      slot[g * kPanel + c] = s;
    }
    cluster_arrive();
    if (i + kStages - 1 < mine) load_panel(i + kStages - 1);
    cp_async_commit();
    cluster_wait();
    if (upd) {
      float bp = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        bp += cluster.map_shared_rank(slot, r)[g * kPanel + c];
      const float fn = update_vals(mode, has_pen, alpha, eps, fu, bp, a0, a1, a2);
      sm.fnew[g][c] = fn;
      if (rank == 0) f_new[(long long)g * V + v] = fn;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = t + j * kThreads;
      if (r < nrows) {
        float h[kPanel];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(slab + slab_at(r, 4 * q));
          h[4 * q] = x.x; h[4 * q + 1] = x.y; h[4 * q + 2] = x.z; h[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float s = fit[j][b];
#pragma unroll
          for (int k = 0; k < kPanel; ++k) s = fmaf(h[k], sm.fnew[b][k], s);
          fit[j][b] = s;
        }
      }
    }
    // no block barrier here: the slab is reloaded (after the next arrive) and
    // fnew rewritten (after the next cluster wait) only once every thread has
    // passed the next panel's two block barriers
  }
  cluster.sync();  // no CTA leaves while another reads its slots

  float* out = partial + (long long)cid * NB * P;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = t + j * kThreads;
    if (r < nrows)
#pragma unroll
      for (int b = 0; b < NB; ++b) out[(long long)b * P + row0 + r] = fit[j][b];
  }
}

}  // namespace one_read

// ---------------------------------------------------------------------------
// Launchers and the C interface.
// ---------------------------------------------------------------------------

enum Plan { kTwoRead = 0, kOneRead = 1, kTensorCore = 2 };

struct Args {
  const float* scale;
  const float* w;
  const float* f;
  AuxPanels aux;
  float* f_new;
  float* fitted;
  int P, V, B, mode, has_pen;
  float alpha, eps;
  unsigned char* scratch;
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

long long align256(long long n) { return (n + 255) / 256 * 256; }

// The tensor_core plan's geometry, from the shape alone, and its scratch:
// w's pieces [3, Bpad, Ppad] bf16, then xs [3, Bpad, V] bf16, then the
// partials [splits, Bpad, P] fp32, each 256-byte aligned.
struct TcShape {
  int MT, rows, Bpad, Ppad, ksplit, splits;
  long long ws_bytes, xs_bytes, partial_bytes;
};

TcShape tc_shape(long long P, long long V, long long B) {
  TcShape s;
  s.MT = B <= 16 ? 1 : 2;
  s.rows = 16 * s.MT;
  s.Bpad = (int)((B + s.rows - 1) / s.rows * s.rows);
  s.Ppad = (int)((P + tc::kChunk - 1) / tc::kChunk * tc::kChunk);
  const long long blocks = (P + tc::kBlockN - 1) / tc::kBlockN * (s.Bpad / s.rows);
  long long want = (tc::kTargetBlocks + blocks - 1) / blocks;
  const long long most = (V + 1023) / 1024;  // at least 1024 columns a split
  if (want > most) want = most;
  if (want < 1) want = 1;
  const long long per = (V + want - 1) / want;
  s.ksplit = (int)((per + tc::kChunk - 1) / tc::kChunk * tc::kChunk);
  s.splits = (int)((V + s.ksplit - 1) / s.ksplit);
  s.ws_bytes = align256(3LL * s.Bpad * s.Ppad * 2);
  s.xs_bytes = align256(3LL * s.Bpad * V * 2);
  s.partial_bytes = align256((long long)s.splits * s.Bpad * P * 4);
  return s;
}

long long scratch_bytes(int plan, long long P, long long V, long long B) {
  if (plan == kTwoRead) return 0;
  if (plan == kOneRead) return align256((long long)one_read::kMaxClusters * B * P * 4);
  if (plan == kTensorCore) {
    const TcShape s = tc_shape(P, V, B);
    return s.ws_bytes + s.xs_bytes + s.partial_bytes;
  }
  return -1;
}

template <int MT>
cudaError_t launch_tc(const int8_t* codes, const Args& a, const TcShape& s) {
  bf16_bits* ws = reinterpret_cast<bf16_bits*>(a.scratch);
  bf16_bits* xs = reinterpret_cast<bf16_bits*>(a.scratch + s.ws_bytes);
  float* partial = reinterpret_cast<float*>(a.scratch + s.ws_bytes + s.xs_bytes);
  constexpr int smem = tc::smem_bytes<MT>();
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(tc::bp_update_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(tc::forward_kernel<MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (attr != cudaSuccess) return attr;
  tc::split_kernel<<<264, 256, 0, a.stream>>>(a.w, a.B, a.P, s.Bpad, s.Ppad, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned nbatch = (unsigned)(s.Bpad / s.rows);
  const dim3 grid_bp((unsigned)((a.V + tc::kBlockN - 1) / tc::kBlockN), nbatch);
  tc::bp_update_kernel<MT><<<grid_bp, tc::kThreads, smem, a.stream>>>(
      codes, a.scale, ws, a.f, a.aux, a.f_new, xs, a.P, s.Ppad, a.V, a.B, s.Bpad,
      a.mode, a.has_pen, a.alpha, a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_fwd((unsigned)((a.P + tc::kBlockN - 1) / tc::kBlockN),
                      (unsigned)s.splits, nbatch);
  tc::forward_kernel<MT><<<grid_fwd, tc::kThreads, smem, a.stream>>>(
      codes, xs, partial, a.P, a.V, s.Bpad, s.ksplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(partial, s.splits, s.Bpad, a.B,
                                                 a.P, a.fitted);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const int8_t* codes, const Args& a) {
  const TcShape s = tc_shape(a.P, a.V, a.B);
  return s.MT == 1 ? launch_tc<1>(codes, a, s) : launch_tc<2>(codes, a, s);
}

// Clusters of the one_read kernel that the card holds at once (at most
// kMaxClusters), asked once per kernel instance; 0 on failure.
template <int NB>
int one_read_clusters() {
  static int clusters = -1;
  if (clusters >= 0) return clusters;
  const int smem = (int)sizeof(one_read::Smem);
  if (cudaFuncSetAttribute(one_read::sweep_kernel<NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(one_read::kCluster * one_read::kMaxClusters);
  config.blockDim = dim3(one_read::kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = one_read::kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, one_read::sweep_kernel<NB>, &config) != cudaSuccess)
    n = 0;
  clusters = n < one_read::kMaxClusters ? n : one_read::kMaxClusters;
  return clusters;
}

template <int NB>
cudaError_t launch_one_read(const float* H, const Args& a) {
  const int G = one_read_clusters<NB>();
  if (G <= 0) return cudaErrorInvalidConfiguration;
  float* partial = reinterpret_cast<float*>(a.scratch);
  const int rows = (a.P + one_read::kCluster - 1) / one_read::kCluster;
  one_read::sweep_kernel<NB><<<G * one_read::kCluster, one_read::kThreads,
                               sizeof(one_read::Smem), a.stream>>>(
      H, a.w, a.f, a.aux, a.f_new, partial, a.P, a.V, rows, a.mode, a.has_pen,
      a.alpha, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(partial, G, NB, a.B, a.P, a.fitted);
  return cudaGetLastError();
}

cudaError_t dispatch_one_read(const float* H, const Args& a) {
  switch (a.B) {
    case 1: return launch_one_read<1>(H, a);
    case 2: return launch_one_read<2>(H, a);
    case 3: return launch_one_read<3>(H, a);
    default: return launch_one_read<4>(H, a);
  }
}

// The plan's preconditions (the Python plan_sweep's, plus alignment).
bool plan_ok(int plan, int storage, long long P, long long V, long long B,
             const void* H) {
  const bool h16 = (uintptr_t)H % 16 == 0;
  switch (plan) {
    case kTwoRead: return (B + 3) / 4 <= 65535;
    case kOneRead:
      return storage == 0 && B <= one_read::kMaxB &&
             P <= (long long)one_read::kCluster * one_read::kMaxRows &&
             V % one_read::kPanel == 0 && h16;
    case kTensorCore:
      return storage == 2 && V % 16 == 0 && h16 && (B + 31) / 32 <= 65535;
    default: return false;
  }
}

}  // namespace

// Bytes of scratch the plan needs at this shape (0 for two_read); -1 for an
// unknown plan. The caller allocates it, 256-byte aligned.
extern "C" long long sart_fused_sweep_scratch_bytes(int plan, long long P,
                                                    long long V, long long B) {
  return scratch_bytes(plan, P, V, B);
}

// Clusters the one_read plan runs at batch size B (1..4) on the current
// card: persistent, at most 16, as many as the card holds at once; 0 where
// the card holds none.
extern "C" int sart_one_read_clusters(int B) {
  switch (B) {
    case 1: return one_read_clusters<1>();
    case 2: return one_read_clusters<2>();
    case 3: return one_read_clusters<3>();
    case 4: return one_read_clusters<4>();
    default: return 0;
  }
}

// Returns a cudaError_t (0 on success). H is a device pointer to a
// contiguous [P, V] matrix of the storage type `storage` (0 fp32, 1 bf16,
// 2 int8 codes); scale is the codes' [V] fp32 scale, given for int8 and only
// for int8. Every other pointer is a device pointer to a contiguous fp32
// array; aux_rows[i] is 1 (broadcast) or B. The caller allocates f_new
// [B, V], fitted [B, P] and `scratch_bytes` of scratch (see above). `plan`
// (0 two_read, 1 one_read, 2 tensor_core) is run as asked or refused with
// cudaErrorInvalidValue; no other plan is taken in its place.
extern "C" int sart_fused_sweep(const void* H, int storage, const float* scale,
                                const float* w, const float* f,
                                const float* aux0, const float* aux1,
                                const float* aux2, const long long* aux_rows,
                                int n_aux, float* f_new, float* fitted,
                                long long P, long long V, long long B,
                                int mode, float alpha, float eps, int plan,
                                void* scratch, long long scratch_size,
                                void* stream) {
  if (P <= 0 || V <= 0 || B <= 0 || P > 0x7fffffffLL || V > 0x7fffffffLL ||
      B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int want = mode == 0 ? 1 : 2;  // aux panels without the penalty
  if ((mode != 0 && mode != 1) || (n_aux != want && n_aux != want + 1))
    return (int)cudaErrorInvalidValue;
  if (storage < 0 || storage > 2 || (storage == 2) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!plan_ok(plan, storage, P, V, B, H))
    return (int)cudaErrorInvalidValue;
  const long long need = scratch_bytes(plan, P, V, B);
  if (scratch_size < need || (need > 0 && (uintptr_t)scratch % 256 != 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.scale = scale;
  a.w = w;
  a.f = f;
  const float* ptrs[3] = {aux0, aux1, aux2};
  for (int i = 0; i < 3; ++i) {
    a.aux.ptr[i] = i < n_aux ? ptrs[i] : nullptr;
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
  a.scratch = static_cast<unsigned char*>(scratch);
  a.stream = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(H);
  switch (plan) {
    case kOneRead: return (int)dispatch_one_read(static_cast<const float*>(H), a);
    case kTensorCore: return (int)dispatch_tc(codes, a);
    default: break;
  }
  cudaError_t err;
  if (storage == 0)
    err = dispatch<float>(H, a);
  else if (storage == 1)
    err = dispatch<bf16_bits>(H, a);
  else
    err = dispatch<int8_t>(H, a);
  return (int)err;
}
