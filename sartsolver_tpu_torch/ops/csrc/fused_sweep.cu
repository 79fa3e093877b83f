// Fused SART sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sartsolver_tpu/ops/fused_sweep.py:_sweep_kernel
// (called through fused_sweep, :829), all four of its variants and the
// scheduled log update (alpha_lane, below). One call
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
// The scheduled log update (relaxation_decay != 1, models/sart.py:1292-1307)
// takes its exponent per batch row: alpha_lane, 1 or B fp32 values, in place
// of the literal alpha. The TPU kernel reads it as a fourth aux panel [1|B, V]
// (a Pallas closure cannot capture a traced scalar); here it is one value
// per row, read once per row by each thread, so it adds no per-voxel
// traffic. With it the power is taken for every exponent, 1 included, as the
// scheduled closure takes it; without it (a null pointer) the literal path
// is unchanged.
//
// Three plans, chosen by the caller (ops/fused_sweep.py:plan_sweep) and
// refused here, never replaced, when their preconditions fail:
//
// - two_read (every storage, any shape): two passes over H, each reading it
//   once for up to 32 batch rows (namespace two_read). What bounds the sweep
//   is one read of H, P*V*sizeof(T) bytes: at P = 8192, V = 65536, 2.147 GB
//   in fp32 (0.64 ms at the H100 SXM's 3.35 TB/s), 1.07 GB in bf16, 0.54 GB
//   in int8; two reads take twice that.
// - one_read (B <= 8 for fp32, B <= 4 for bf16 and int8, P <= 8192, V a
//   multiple of the panel's 16 fp32, 32 bf16 or 64 int8 columns): H read
//   once, a panel 64 bytes wide split along P over a thread-block cluster
//   (namespace one_read); plan_sweep takes it from the P where it was
//   measured faster, per storage type.
// - tensor_core (bf16 or int8 codes, V % 16 == 0): the three contractions
//   on the bf16 tensor cores with the fp32 vectors split exactly into three
//   bf16 pieces (namespace tc). At B = 32 the 4*B*P*V operations bound the
//   sweep: three bf16 products of 68.7 GFLOP at 989 TFLOP/s, 0.208 ms.
//
// No plan uses atomics: a given plan and shape give byte-identical results
// run to run.
//
// A rank of a pixel-sharded grid runs the sweep split at the all-reduce of
// its partial bp (sart_sharded_bp, then the caller's reduction, then
// sart_sharded_finish): one kernel a call on the cluster route (namespace
// split) where its rule holds, else two_read's kernels (see "The
// pixel-sharded sweep" below), both in two_read's order of summation; it
// has no Pallas counterpart (the JAX package's panel scan,
// sartsolver_tpu/ops/fused_sweep.py:270, is plain XLA).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the driver's encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <cmath>
#include <type_traits>

namespace cg = cooperative_groups;

// SART_PART 0 (the default) builds the whole library in one unit. 1 to 6
// each build one share of its kernel instances, which ops/_build.py
// compiles at once and links into one library: two_read with the
// pixel-sharded sweep for fp32 (1, which also holds the C interface), bf16
// (2) and int8 (3), one_read (4), tensor_core (5) and the pixel-sharded
// sweep's cluster route (6). The C interface
// reaches the other parts' kernels through the sart_part_* entry points at
// the end of the file; every part compiles the same host code, so an Args
// means the same bytes in each.
// sart-build-parts: 6
#ifndef SART_PART
#define SART_PART 0
#endif
#define SART_HAS(k) (SART_PART == 0 || SART_PART == (k))

namespace {

struct AuxPanels {
  const float* ptr[3];
  long long stride[3];  // 0 for a broadcast row, V for B rows
  const float* alpha_lane;  // the scheduled log update's exponent per row, or null
  long long alpha_stride;   // 0 for one value, 1 for B
};

// Row b's exponent of the log update: alpha_lane[b] where the update is
// scheduled, else the literal alpha.
__device__ __forceinline__ float row_alpha(const AuxPanels& aux, float alpha, int b) {
  return aux.alpha_lane != nullptr ? __ldg(aux.alpha_lane + b * aux.alpha_stride) : alpha;
}

// bf16 storage is carried as its bit pattern: a bf16 value is the upper 16
// bits of the fp32 value it stands for, so the conversion is a shift and is
// exact (no rounding, infinities and NaNs kept).
typedef uint16_t bf16_bits;

// The elementwise update, written with explicit roundings (no fused
// multiply-add) so it rounds like the plain PyTorch version. a0..a2 are the
// voxel's aux values: mode 0 invd [, pen]; mode 1 vm, obs [, pen]. alpha is
// the row's exponent; `scheduled` takes the power whatever its value.
__device__ __forceinline__ float update_vals(int mode, int has_pen, float alpha,
                                             bool scheduled, float eps, float f,
                                             float bp, float a0, float a1, float a2) {
  if (mode == 0) {
    float upd = __fadd_rn(f, __fmul_rn(a0, bp));
    if (has_pen) upd = __fsub_rn(upd, a1);
    return upd < 0.0f ? 0.0f : upd;
  }
  const float fit = __fmul_rn(bp, a0);
  float ratio = __fdiv_rn(__fadd_rn(a1, eps), __fadd_rn(fit, eps));
  if (scheduled || alpha != 1.0f) ratio = powf(ratio, alpha);
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
  return update_vals(mode, has_pen, row_alpha(aux, alpha, b), aux.alpha_lane != nullptr,
                     eps, f, bp, a0, a1, a2);
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

// The columns of storage type T in the 32-bit word x, first column in the
// low bits, converted exactly to fp32 without the conversion unit: a bf16
// value is the upper half of its fp32 pattern; a code c + 128 in the low byte
// of 2^23's pattern is the float 2^23 + c + 128.
template <typename T>
__device__ __forceinline__ void unpack(unsigned x, float* out);
template <>
__device__ __forceinline__ void unpack<float>(unsigned x, float* out) {
  out[0] = __uint_as_float(x);
}
template <>
__device__ __forceinline__ void unpack<bf16_bits>(unsigned x, float* out) {
  out[0] = __uint_as_float(x << 16);
  out[1] = __uint_as_float(x & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack<int8_t>(unsigned x, float* out) {
  const unsigned biased = x ^ 0x80808080u;  // each byte c + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7650 + i)),
                       8388736.0f);  // 2^23 + 128
}

// ---------------------------------------------------------------------------
// Plan "tensor_core": bf16 storage or int8 codes at large B on the bf16
// tensor cores.
//
// Every fp32 operand x is split exactly into three bf16 pieces, x_hi =
// bf16(x), x_mid = bf16(x - x_hi), x_lo = bf16(x - x_hi - x_mid) (24
// significant bits in all, so hi + mid + lo == x for normal fp32 values).
// A code (|c| <= 127) is exact in bf16, a stored bf16 value is the MMA's B
// operand as it is, and a bf16 x bf16 product is exact in fp32, so three
// mma.sync.m16n8k16 products with fp32 accumulation give an fp32
// contraction. Batch rows are padded with zero rows to the MMA's M
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
// cp.async ring in shared memory (the A pieces and the raw tile of H), so
// loads stay in flight while the tensor cores work; codes become bf16 in
// registers, bf16 storage is only regrouped. The thread's four k-slots of an
// MMA step ({2t, 2t+1, 2t+8, 2t+9} of the m16n8k16 layout) stand for four
// consecutive k, so an A row gives them as one 8-byte load, the forward
// kernel's row of H as one 4-byte word of codes (8 bytes of bf16), and the
// bp kernel's H as one element of each of four rows (the 4 elements a
// thread reads per row are its columns of four n8 tiles: a word of codes,
// 8 bytes of bf16). The products' order is fixed, so launches are
// byte-identical.
//
// bf16 storage moves twice the bytes of codes and is read twice (the bp and
// the forward launch), 2 x 1.07 GB at 8192 x 65536, where one_read cannot
// run (B > 4) and two_read reads it once per batch tile of 8 in each launch.
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
// the tile of H, 8192 elements of its storage type (bp: 64 rows of P x 128
// columns; forward: 128 rows of P x 64 columns): 8 KB of codes, 16 KB of
// bf16.
template <typename T, int MT>
struct Stage {
  static constexpr int kRows = 16 * MT;
  static constexpr int kABytes = 3 * kRows * kChunk * 2;
  static constexpr int kBytes = kABytes + 8192 * (int)sizeof(T);
};

template <typename T, int MT>
constexpr int smem_bytes() { return kStages * Stage<T, MT>::kBytes; }

// Copy the A tile of one K chunk: rows b0.. of each piece (stride ld
// elements, pieces `piece` apart), columns k0..k0+63 (zero past kend).
template <int MT>
__device__ __forceinline__ void load_a_tile(unsigned char* st, const bf16_bits* src,
                                            long long piece, long long ld, int b0,
                                            long long k0, long long kend) {
  constexpr int R = 16 * MT;
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
  constexpr int R = 16 * MT;
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

// The four B-operand registers of an MMA step that a thread's four columns
// of H give (one per n8 tile t), from its rows k0 .. k0 + 3: raw holds the
// thread's word of each row, four codes, or for bf16 its 8 bytes as two
// words (lo: columns 0 and 1, hi: 2 and 3; the first column in the low half).
template <typename T>
__device__ __forceinline__ void bp_operand(unsigned (&bf)[kNT][2], const uint2 (&raw)[4]);
template <>
__device__ __forceinline__ void bp_operand<int8_t>(unsigned (&bf)[kNT][2], const uint2 (&raw)[4]) {
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    bf[t][0] = pack_bf16(code(raw[0].x, t), code(raw[1].x, t));
    bf[t][1] = pack_bf16(code(raw[2].x, t), code(raw[3].x, t));
  }
}
template <>
__device__ __forceinline__ void bp_operand<bf16_bits>(unsigned (&bf)[kNT][2],
                                                      const uint2 (&raw)[4]) {
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const unsigned sel = (t & 1) ? 0x7632 : 0x5410;  // the high or the low halves
    bf[t][0] = __byte_perm(t < 2 ? raw[0].x : raw[0].y, t < 2 ? raw[1].x : raw[1].y, sel);
    bf[t][1] = __byte_perm(t < 2 ? raw[2].x : raw[2].y, t < 2 ? raw[3].x : raw[3].y, sel);
  }
}

// bp = w @ H on the tensor cores, then the update; writes f_new [B, V] and
// the split forward operand xs [3, Bpad, V] (zero in padded rows). The
// block's tile of H is 64 rows x 128 columns a stage, its 16-byte chunks
// XOR-swizzled by (chunks a row / 4) * (row / 16) so the four tids hit other
// banks; the thread reads its columns n0 + 4 gid .. + 3 of rows
// 16 tid + 4 s + j. int8 codes: bp is summed in code space and rounded
// times the voxel's scale before the update; the forward operand is f_new
// times the scale, rounded.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
bp_update_kernel(const T* __restrict__ H, const float* __restrict__ scale,
                 const bf16_bits* __restrict__ ws, const float* __restrict__ f,
                 AuxPanels aux, float* __restrict__ f_new, bf16_bits* __restrict__ xs,
                 int P, int Ppad, int V, int B, int Bpad, int mode, int has_pen,
                 float alpha, float eps) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int kRowBytes = 128 * (int)sizeof(T);  // a row of the tile
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kPerChunk = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int b0 = blockIdx.y * 16 * MT;
  const long long nb = (long long)blockIdx.x * kBlockN;  // the block's first column
  const long long n0 = nb + warp * kNT * 8;              // the warp's
  const long long piece = (long long)Bpad * Ppad;
  const int n_iter = Ppad / kChunk;
  auto swizzle = [](int c, int row) { return c ^ ((kRowChunks / 4) * ((row >> 4) & 3)); };

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * Stage<T, MT>::kBytes;
    const long long k0 = (long long)it * kChunk;
    load_a_tile<MT>(st, ws, piece, Ppad, b0, k0, Ppad);
    unsigned char* bt = st + Stage<T, MT>::kABytes;
    for (int i = threadIdx.x; i < 64 * kRowChunks; i += kThreads) {
      const int row = i / kRowChunks, c = i % kRowChunks;
      const long long p = k0 + row, n = nb + c * kPerChunk;
      const bool ok = p < P && n < V;  // V % 16 == 0: a chunk is all in or out
      cp_async16(bt + row * kRowBytes + (swizzle(c, row) << 4), H + (ok ? p * V + n : 0), ok);
    }
  };

  float acc[MT][kNT][4], part[MT][kNT][4];
  zero<MT>(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_iter) load_stage(i);
    cp_async_commit();
  }
  // the thread's 4 columns: a word (codes) or two (bf16) of each row
  constexpr int kWordsOf4 = (int)sizeof(T);
  const int chunk = swizzle((kWordsOf4 * (8 * warp + gid)) / 4, 16 * tid);
  const int word = chunk * 4 + (kWordsOf4 * (8 * warp + gid)) % 4;
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % kStages) * Stage<T, MT>::kBytes;
    const unsigned* bt = reinterpret_cast<const unsigned*>(st + Stage<T, MT>::kABytes);
    if (kPromote) zero<MT>(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint2 raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned* row = bt + (tid * 16 + 4 * s + j) * (kRowBytes / 4) + word;
        if constexpr (kWordsOf4 == 2) {
          raw[j] = *reinterpret_cast<const uint2*>(row);
        } else {
          raw[j] = make_uint2(*row, 0u);
        }
      }
      unsigned bf[kNT][2];
      bp_operand<T>(bf, raw);
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
          const float s = kScaled ? scale[v] : 1.0f;
          const float bp = kScaled ? __fmul_rn(acc[m][t][e], s) : acc[m][t][e];
          const float fn = update(mode, has_pen, alpha, eps, f[i], bp, aux, b, v);
          f_new[i] = fn;
          x = kScaled ? __fmul_rn(fn, s) : fn;
        }
        const long long o = (long long)b * V + v;
        split3(x, xs[o], xs[vpiece + o], xs[2 * vpiece + o]);
      }
}

// partial[split] = xs @ H^T over the split's range of V. The block's tile
// of H is 128 rows of P x 64 columns a stage; the thread reads the 16
// elements k = 16 tid .. + 15 (its k-slots of four steps) of rows
// 32 warp + 8 t + gid: 16 bytes of codes, or 32 bytes of bf16 whose 16-byte
// chunks are XOR-swizzled by row & 7 (the tid's chunks then meet no other
// tid's bank).
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const T* __restrict__ H, const bf16_bits* __restrict__ xs,
               float* __restrict__ partial, int P, int V, int Bpad, int ksplit) {
  constexpr bool kCodes = std::is_same<T, int8_t>::value;
  constexpr int kRowBytes = 64 * (int)sizeof(T);
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kPerChunk = 16 / (int)sizeof(T);
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
  auto swizzle = [](int c, int row) { return kCodes ? c : c ^ (row & 7); };

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * Stage<T, MT>::kBytes;
    const long long k0 = kbeg + (long long)it * kChunk;
    load_a_tile<MT>(st, xs, piece, V, b0, k0, kend);
    unsigned char* bt = st + Stage<T, MT>::kABytes;
    for (int i = threadIdx.x; i < 128 * kRowChunks; i += kThreads) {
      const int row = i / kRowChunks, c = i % kRowChunks;
      const long long p = pb + row, k = k0 + c * kPerChunk;
      const bool ok = p < P && k < kend;  // kend % 16 == 0
      cp_async16(bt + row * kRowBytes + (swizzle(c, row) << 4), H + (ok ? p * V + k : 0), ok);
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
    const unsigned char* st = smem + (it % kStages) * Stage<T, MT>::kBytes;
    const unsigned char* bt = st + Stage<T, MT>::kABytes;
    // the thread's 16 elements of each of its rows, as 4 (codes) or 8 words
    unsigned raw[kNT][4 * sizeof(T)];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int row = warp * 32 + 8 * t + gid;
#pragma unroll
      for (int h = 0; h < (int)sizeof(T); ++h) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            bt + row * kRowBytes + (swizzle(tid * (int)sizeof(T) + h, row) << 4));
        raw[t][4 * h] = q.x; raw[t][4 * h + 1] = q.y;
        raw[t][4 * h + 2] = q.z; raw[t][4 * h + 3] = q.w;
      }
    }
    if (kPromote) zero<MT>(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned bf[kNT][2];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        if constexpr (kCodes) {
          const unsigned w = raw[t][s];
          bf[t][0] = pack_bf16(code(w, 0), code(w, 1));
          bf[t][1] = pack_bf16(code(w, 2), code(w, 3));
        } else {  // k0, k0 + 1 and k0 + 2, k0 + 3, the first in the low half
          bf[t][0] = raw[t][2 * s];
          bf[t][1] = raw[t][2 * s + 1];
        }
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
// Plan "two_read": every storage type and shape. It replaces the TPU
// kernel's one-read column panel where no one-read plan applies (P > 8192,
// fp32 past B = 8, V off the panels' multiples): two passes over H, each
// reading it once for up to kMaxMB batch rows (a larger B runs in batch
// tiles of 32, each a pass of its own). Five kernels a call, the same at
// every B:
//
//   transpose_w_kernel: w [B, P] -> wT [Pp, Ws], zero past B and P, so the
//     weights of one row of H for every batch row are contiguous.
//   bp_kernel: a block owns a tile of voxel columns (64 lanes of TN columns:
//     16 bytes of them a lane up to MB = 4, 1 KB of each row; 4 a lane from
//     MB = 8, 32 lanes at MB = 32) and one of S splits of P. A ring of
//     kStages cp.async stages brings 16 KB of H (Kt rows) and the rows'
//     weights [Kt, MB] into shared memory. Row group g of 4 sums the split's
//     rows g, g + 4, ... in ascending order, thread (g, batch group, lane c)
//     its TM batch rows at its TN columns, and the groups' sums meet as
//     (q0 + q1) + (q2 + q3). Every batch group reads the same tile, so H
//     leaves device memory once for all MB rows; a row of weights is one to
//     four 16-byte shared loads for TM x TN FMAs. Writes partials [S, B, V].
//   finish_kernel: bp = the S partials summed in split order (rounded times
//     the scale for codes), the update, f_new [B, V] and the forward operand
//     xs [Bpad, Vp] (f_new, times the scale for codes, rounded; zero in
//     padded rows and columns), computed once a call.
//   forward_kernel: a block owns 64 pixel rows and one of S2 splits of V.
//     Lane kl of 8 takes piece kl (16 bytes) of each 128-byte step of a row
//     and sums its pieces in ascending order; the 8 lanes of a row meet in a
//     fixed butterfly. The operand [MB, V] is read from shared memory, where
//     cp.async brings it a chunk at a time, double-buffered: it crosses L2
//     once per 64 rows. Up to MB = 8 a lane holds 2 rows with 4 steps of
//     them in flight in registers; from MB = 16 it holds 8 rows for half
//     the batch rows (its twin lane, the other half, loads the same pieces
//     in the same request), and H comes through a cp.async ring in shared
//     memory (FwdStaged), since the accumulators leave no registers for
//     loads in flight. Writes partials [S2, B, P].
//   sum_partials_kernel: fitted = the S2 partials summed in split order.
//
// S and S2 follow from (P, V) alone: each is picked so the blocks fill the
// 132 SMs evenly, and capped so that no accumulator sums more than 1024
// terms in a row (a long fp32 chain drifts from the exact sum as it grows).
// A thread sums its rows (bp) or pieces (forward) in ascending order
// whatever its batch rows, so every output's order of summation depends on
// P, V, the storage type and whether H's rows are 16-byte aligned, never on
// B or on the row's place in the batch: a row gives the same bytes in any
// batch and alone. H's rows off 16-byte alignment (V * sizeof(T) % 16 !=
// 0, or H itself) take forward_kernel and bp_kernel with element-wise loads
// of H (kVec = false).
//
// What bounds it: one read of H a pass (bytes) up to about B = 32 for fp32,
// whose 2 B FLOP per 4 bytes come near the card's 20 FLOP a byte there;
// fp32 stays on CUDA-core FMAs. Measured on the H100 (sweep kernels and
// shared-memory loads, PERF.md): a 16-byte shared load that 8 lanes of a
// quarter-warp read at 8 addresses takes 4 cycles a warp, at one address 2,
// which is what bounds the forward pass's operand reads per FMA
// (sweep_measure.py lds); H streams in 128-byte steps of a row (forward)
// and 1 KB rows (bp), runs long enough for full DRAM bursts.
// ---------------------------------------------------------------------------
namespace two_read {

constexpr int kMaxMB = 32;       // batch rows a pass
constexpr int kSMs = 132;        // the H100 SXM's; the splits aim to fill them evenly
// bp
constexpr int kCols = 256;       // voxel columns of a nominal block: the splits' unit
constexpr int kGroups = 4;       // row groups of a block: rows p0 + g, p0 + g + 4, ...
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kStageBytes = 16384;  // bytes of H a stage
constexpr int kMinSplitRows = 256;
constexpr int kMaxSplitRows = 4096;  // a row group sums at most 1024 rows in a row
// forward
constexpr int kRows = 64;        // pixel rows a block
constexpr int kSplitColsAlign = 1024;  // a split's columns, a multiple of every chunk
constexpr int kMinSplitCols = 1024;
constexpr int kMaxSplitCols = 8192;  // a lane sums at most 1024 columns in a row

// The bp kernel's shape for storage type T and MB batch rows a pass
template <typename T, int MB>
struct Bp {
  static constexpr int TM = MB < 16 ? MB : 16;  // batch rows a thread
  static constexpr int BG = MB / TM;            // groups of batch rows
  // columns a thread: 16 bytes of them up to MB = 4 (fewer instructions a
  // byte for bf16 and codes), else 4
  static constexpr int TN = MB <= 4 ? 16 / (int)sizeof(T) : 4;
  static constexpr int Lanes = MB < 32 ? 64 : 32;  // threads along the columns
  static constexpr int Cols = Lanes * TN;       // columns a block
  static constexpr int kThreads = kGroups * BG * Lanes;
  static constexpr int Kt = kStageBytes / (Cols * (int)sizeof(T));  // rows a stage
  static constexpr int WS = MB < 4 ? 4 : MB;    // floats of a row of weights
  static constexpr int kStage = kStageBytes + Kt * WS * 4;
  static constexpr int kSmem = kStages * kStage;
  static constexpr int kSlot = MB * Cols;       // floats of one row group's sums
  static_assert(BG * TM == MB && Kt % kGroups == 0, "two_read: bp shape");
  static_assert(2 * kSlot * 4 <= kSmem, "two_read: bp reduction slots");
};

// The forward kernel's shape for storage type T and MB batch rows a pass.
// Lane (kl, bh, rl) of a warp: kl = lane % 8 holds piece kl of each
// 128-byte step; from MB = 16 on the batch rows are split between bh = 0
// and 1, two lanes that load the same pieces of H in one request; rl picks
// its R rows rl, rl + RL, ... of the warp's RL R (RL = 4 / BH row lanes).
// Ahead steps of a row are in flight a lane; the operand comes in chunks of
// C columns (the warps meet once a chunk). None of it changes a sum's
// order: a row's pieces go to lanes kl by their place in the row alone.
template <typename T, int MB>
struct Fwd {
  static constexpr int BH = MB < 16 ? 1 : 2;  // batch halves
  static constexpr int MBL = MB / BH;          // batch rows a lane
  static constexpr int RL = 4 / BH;            // row lanes of a warp
  static constexpr int R = MB < 16 ? 2 : 8;    // rows a lane
  static constexpr int kWarps = kRows / (RL * R);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int Ahead = MB < 16 ? 4 : 1;
  static constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  static constexpr int kStep = 8 * E;            // columns of a 128-byte step
  static constexpr int C = MB <= 4 ? 1024 : Ahead * kStep > 256 ? Ahead * kStep : 256;
  static constexpr int kSmem = 2 * MB * C * 4;
  static_assert(C % (Ahead * kStep) == 0 && kSplitColsAlign % C == 0 &&
                    RL * R * kWarps == kRows && MBL * BH == MB,
                "two_read: forward shape");
};

// src [rows, cols] -> dst [cols_pad, ld] (dst[c][r] = src[r][c], zero past
// rows and cols); 32 x 32 tiles through shared memory, block (32, 8)
__global__ void transpose_w_kernel(const float* __restrict__ src, int rows, int cols,
                                   int cols_pad, int ld, float* __restrict__ dst) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int r = r0 + ty + j, c = c0 + tx;
    tile[ty + j][tx] = (r < rows && c < cols) ? src[(long long)r * cols + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int c = c0 + ty + j, r = r0 + tx;
    if (c < cols_pad && r < ld) dst[(long long)c * ld + r] = tile[tx][ty + j];
  }
}

// TN neighbouring columns of a tile row (4, 8 or 16 bytes), converted
// exactly to fp32
template <typename T, int TN>
__device__ __forceinline__ void load_cols(const T* p, float (&h)[TN]) {
  constexpr int kWords = TN * (int)sizeof(T) / 4;
  constexpr int W = 4 / (int)sizeof(T);  // columns a word
  unsigned x[kWords];
  if constexpr (kWords == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (kWords == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) unpack<T>(x[k], h + k * W);
}

// TM floats of a row of weights as one to four shared loads
template <int TM>
__device__ __forceinline__ void load_weights(const float* row, float (&wv)[TM]) {
  if constexpr (TM == 1) {
    wv[0] = row[0];
  } else if constexpr (TM == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    wv[0] = q.x;
    wv[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < TM / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(row)[k];
      wv[4 * k] = q.x; wv[4 * k + 1] = q.y; wv[4 * k + 2] = q.z; wv[4 * k + 3] = q.w;
    }
  }
}

// part[split, b, v] = sum of w[b, p] H[p, v] over the split's rows p0 ..
// p1 - 1: row group g sums rows p0 + g, p0 + g + 4, ... in ascending order,
// and the groups' sums meet as (q0 + q1) + (q2 + q3). Grid: (column blocks,
// S, batch tiles); thread t is column lane t % L of batch group (t / L) %
// BG in row group t / (L BG), L = Cols / TN.
template <typename T, int MB, bool kVec>
__global__ void __launch_bounds__(Bp<T, MB>::kThreads)
bp_kernel(const T* __restrict__ H, const float* __restrict__ wT, float* __restrict__ part,
          int P, int V, int B, int Ws, int rows_per_split) {
  using K = Bp<T, MB>;
  constexpr int TM = K::TM, TN = K::TN, Kt = K::Kt, WS = K::WS, NT = K::kThreads;
  constexpr int kC = K::Cols, kL = K::Lanes;
  constexpr int kPer = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  constexpr int kRowChunks = kC / kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int cl = t % kL, bg = (t / kL) % K::BG, g = t / (kL * K::BG);
  const long long nb = (long long)blockIdx.x * kC;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * MB;
  const int p0 = split * rows_per_split;
  const int p1 = min(P, p0 + rows_per_split);
  const int n_tiles = (p1 - p0 + Kt - 1) / Kt;

  auto load_stage = [&](int it) {
    unsigned char* st = smem + (it % kStages) * K::kStage;
    T* ht = reinterpret_cast<T*>(st);
    float* wt = reinterpret_cast<float*>(st + kStageBytes);
    const int r0 = p0 + it * Kt;
    if constexpr (kVec) {
      for (int i = t; i < Kt * kRowChunks; i += NT) {
        const int r = i / kRowChunks, c = i - r * kRowChunks;
        const long long n = nb + (long long)c * kPer;
        const bool ok = r0 + r < p1 && n < V;  // a chunk is all in or all out
        cp_async16(ht + r * kC + c * kPer, H + (ok ? (long long)(r0 + r) * V + n : 0), ok);
      }
    } else {
      for (int i = t; i < Kt * kC; i += NT) {
        const int r = i / kC, c = i - r * kC;
        const long long n = nb + c;
        ht[i] = (r0 + r < p1 && n < V) ? H[(long long)(r0 + r) * V + n] : T(0);
      }
    }
    for (int i = t; i < Kt * (WS / 4); i += NT) {
      const int r = i / (WS / 4), c = i - r * (WS / 4);
      const bool ok = r0 + r < p1;
      cp_async16(wt + r * WS + 4 * c, wT + (ok ? (long long)(r0 + r) * Ws + b0 + 4 * c : 0), ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int b = 0; b < TM; ++b)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[b][c] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the stage has landed; the one refilled below is read by no one
    if (it + kStages - 1 < n_tiles) load_stage(it + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % kStages) * K::kStage;
    const T* ht = reinterpret_cast<const T*>(st) + TN * cl;
    const float* wt = reinterpret_cast<const float*>(st + kStageBytes) + bg * TM;
    const int rows = min(Kt, p1 - p0 - it * Kt);
#pragma unroll 4
    for (int r = g; r < Kt; r += kGroups) {
      if (r < rows) {
        float h[TN], wv[TM];
        load_cols<T, TN>(ht + r * kC, h);
        load_weights<TM>(wt + r * WS, wv);
#pragma unroll
        for (int b = 0; b < TM; ++b)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[b][c] = fmaf(wv[b], h[c], acc[b][c]);
      }
    }
  }

  // (q0 + q1) + (q2 + q3) through the ring's memory: slot k holds one row
  // group's sums, [TM * TN][BG * L] (neighbouring threads, neighbouring words)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int li = t % (kL * K::BG);
  auto slot = [&](int k, int b, int c) -> float& {
    return red[k * K::kSlot + (b * TN + c) * (kL * K::BG) + li];
  };
  if (g & 1) {
#pragma unroll
    for (int b = 0; b < TM; ++b)
#pragma unroll
      for (int c = 0; c < TN; ++c) slot(g >> 1, b, c) = acc[b][c];
  }
  __syncthreads();
  if (!(g & 1)) {
#pragma unroll
    for (int b = 0; b < TM; ++b)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[b][c] += slot(g >> 1, b, c);
  }
  __syncthreads();
  if (g == 2) {
#pragma unroll
    for (int b = 0; b < TM; ++b)
#pragma unroll
      for (int c = 0; c < TN; ++c) slot(0, b, c) = acc[b][c];
  }
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int b = 0; b < TM; ++b) {
    const int bb = b0 + bg * TM + b;
    if (bb >= B) continue;
    float* out = part + ((long long)split * B + bb) * V;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const long long v = nb + TN * cl + c;
      if (v < V) out[v] = acc[b][c] + slot(0, b, c);
    }
  }
}

// bp from the S partials in split order, the update, f_new and the forward
// operand xs [Bpad, Vp] (zero past B and V).
template <typename T>
__global__ void finish_kernel(const float* __restrict__ part, int S,
                              const float* __restrict__ scale, const float* __restrict__ f,
                              AuxPanels aux, float* __restrict__ f_new, float* __restrict__ xs,
                              int B, int Bpad, int V, int Vp, int mode, int has_pen,
                              float alpha, float eps) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const long long total = (long long)Bpad * Vp;
  const long long plane = (long long)B * V;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / Vp);
    const int v = (int)(i - (long long)b * Vp);
    float x = 0.0f;
    if (b < B && v < V) {
      const long long o = (long long)b * V + v;
      float bp = part[o];
      for (int s = 1; s < S; ++s) bp += part[s * plane + o];
      const float sc = kScaled ? scale[v] : 1.0f;
      if (kScaled) bp = __fmul_rn(bp, sc);
      const float fn = update(mode, has_pen, alpha, eps, f[o], bp, aux, b, v);
      f_new[o] = fn;
      x = kScaled ? __fmul_rn(fn, sc) : fn;
    }
    xs[i] = x;
  }
}

__device__ __forceinline__ unsigned word_of(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Elements 4j .. 4j + 3 of a 16-byte piece of H as fp32
template <typename T, int j>
__device__ __forceinline__ void quad_of(const uint4& q, float (&h)[4]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __uint_as_float(word_of(q, e));
  } else if constexpr (sizeof(T) == 2) {
    unpack<T>(word_of(q, 2 * j), h);
    unpack<T>(word_of(q, 2 * j + 1), h + 2);
  } else {
    unpack<T>(word_of(q, j), h);
  }
}

// acc[i][b] += h[i][e] x[b][4j + e] for e < 4 (and 4j + e < lim): the
// operand's float4 j of the lane's piece, batch row b, at xp + b C + 32 j
template <int R, int MB, int C>
__device__ __forceinline__ void fma_quad(float (&acc)[R][MB], const float (&h)[R][4],
                                         const float* xp, int j, int lim) {
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    const float4 q = *reinterpret_cast<const float4*>(xp + b * C + 32 * j);
    const float x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * j + e < lim) acc[i][b] = fmaf(h[i][e], x[e], acc[i][b]);
  }
}

// A 16-byte piece of each of R rows (raw) against the operand, its J
// float4s in order
template <typename T, int R, int MB, int C, int J, int j>
__device__ __forceinline__ void fma_piece(float (&acc)[R][MB], const uint4 (&raw)[R],
                                          const float* xp) {
  if constexpr (j < J) {
    float h[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) quad_of<T, j>(raw[i], h[i]);
    fma_quad<R, MB, C>(acc, h, xp, j, 4 * J);
    fma_piece<T, R, MB, C, J, j + 1>(acc, raw, xp);
  }
}

// The forward pass from MB = 16 on, H's rows 16-byte aligned, stages H
// through shared memory by cp.async, a 128-byte step of the block's rows a
// stage beside the operand's step, kStages stages in flight: the
// accumulators of 8 rows x MB / 2 batch rows leave no registers for loads
// in flight. The same lanes and sums, so the same bytes.
template <typename T, int MB>
struct FwdStaged {
  using K = Fwd<T, MB>;
  static constexpr int kStages = 4;
  static constexpr int kHBytes = kRows * 128;                 // a step of every row
  static constexpr int kStage = kHBytes + MB * K::kStep * 4;  // and of every batch row's operand
  static constexpr int kSmem = kStages * kStage;
  static_assert(K::BH == 2 && K::Ahead == 1, "two_read: staged forward shape");
};

// The forward kernel's shared memory: the staged ring from MB = 16 on (H's
// rows 16-byte aligned), else the operand's double buffer
template <typename T, int MB, bool kVec>
constexpr int forward_smem() {
  if constexpr (kVec && MB >= 16) {
    return FwdStaged<T, MB>::kSmem;
  } else {
    return Fwd<T, MB>::kSmem;
  }
}

// part[split, b, p] = sum of xs[b, k] H[p, k] over the split's columns.
// Grid: (row blocks, S2, batch tiles). A lane sums its pieces of each of
// its rows in ascending order, for its batch rows; the 8 lanes of a row
// meet in a fixed butterfly. The operand's chunk is kept with the float4s
// of each step permuted so that the 8 lanes of a row read 8 neighbouring
// float4s in each shared load: float4 kl J + j of a step (lane kl's j-th)
// sits at j 8 + kl.
template <typename T, int MB, bool kVec>
__global__ void __launch_bounds__(Fwd<T, MB>::kThreads)
forward_kernel(const T* __restrict__ H, const float* __restrict__ xs, float* __restrict__ part,
               int P, int V, int Vp, int B, int cols_per_split) {
  using K = Fwd<T, MB>;
  constexpr int R = K::R, RL = K::RL, MBL = K::MBL, E = K::E, kStep = K::kStep, C = K::C;
  constexpr int A = K::Ahead, NT = K::kThreads;
  constexpr int J = E / 4;                // the piece's float4s of the operand
  constexpr int kSteps = C / kStep;       // steps a chunk
  constexpr int kQ = C / 4;               // float4s of a chunk row
  extern __shared__ __align__(16) unsigned char smem[];
  float* xsm = reinterpret_cast<float*>(smem);  // [2][MB][C]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kl = lane & 7;
  const int bh = K::BH == 1 ? 0 : (lane >> 3) & 1;
  const int rl = lane >> (K::BH == 1 ? 3 : 4);
  const long long prow0 = (long long)blockIdx.x * kRows + warp * RL * R + rl;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * MB;
  const long long k0 = (long long)split * cols_per_split;
  const long long k1 = min((long long)V, k0 + cols_per_split);
  const int n_chunks = (int)((k1 - k0 + C - 1) / C);
  // lane kl's piece of global step g starts at column k0 + g kStep + kl E
  auto piece_at = [&](int g) { return k0 + (long long)g * kStep + kl * E; };

  float acc[R][MBL];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int b = 0; b < MBL; ++b) acc[i][b] = 0.0f;

  if constexpr (kVec && MB >= 16) {
    using S = FwdStaged<T, MB>;
    constexpr int NS = S::kStages;
    const long long pb = (long long)blockIdx.x * kRows;
    const int row0 = (int)(prow0 - pb);  // the lane's first row in the block
    const int n_steps = (int)((k1 - k0 + kStep - 1) / kStep);
    auto load_stage = [&](int g) {
      unsigned char* st = smem + (g % NS) * S::kStage;
      float* xst = reinterpret_cast<float*>(st + S::kHBytes);
      const long long kg = k0 + (long long)g * kStep;
      for (int i = t; i < kRows * 8; i += NT) {
        const int r = i >> 3, c = i & 7;
        const long long p = pb + r, kc = kg + c * E;
        const bool ok = p < P && kc < k1;  // a piece is all in or all out
        cp_async16(st + r * 128 + c * 16, H + (ok ? p * V + kc : 0), ok);
      }
      for (int i = t; i < MB * 2 * E; i += NT) {  // kg + kStep <= Vp
        const int b = i / (2 * E), q = i - b * (2 * E);
        const int pos = (q % J) * 8 + q / J;
        cp_async16(xst + b * kStep + 4 * pos, xs + (long long)(b0 + b) * Vp + kg + 4 * q, true);
      }
    };
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n_steps) load_stage(i);
      cp_async_commit();
    }
    for (int g = 0; g < n_steps; ++g) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // the stage has landed; the one refilled below is read by no one
      if (g + NS - 1 < n_steps) load_stage(g + NS - 1);
      cp_async_commit();
      if (piece_at(g) < k1) {
        const unsigned char* st = smem + (g % NS) * S::kStage;
        uint4 raw[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          raw[i] = *reinterpret_cast<const uint4*>(st + (row0 + RL * i) * 128 + kl * 16);
        const float* xp =
            reinterpret_cast<const float*>(st + S::kHBytes) + bh * MBL * kStep + 4 * kl;
        fma_piece<T, R, MBL, kStep, J, 0>(acc, raw, xp);
      }
    }
  } else {
    const T* hrow[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long p = prow0 + RL * i;
      hrow[i] = H + (p < P ? p : (long long)P - 1) * V;
    }

    auto load_chunk = [&](int c) {
      float* dst = xsm + (c & 1) * MB * C;
      const long long kc = k0 + (long long)c * C;  // kc + C <= Vp
      for (int i = t; i < MB * kQ; i += NT) {
        const int b = i / kQ, q = i - b * kQ;
        const int s = q / (2 * E), qq = q - s * (2 * E);
        const int pos = s * (2 * E) + (qq % J) * 8 + qq / J;
        cp_async16(dst + b * C + 4 * pos, xs + (long long)(b0 + b) * Vp + kc + 4 * q, true);
      }
    };
    uint4 ring[A][R];
    auto fetch = [&](int g, uint4 (&raw)[R]) {
      const long long kc = piece_at(g);
      if (kVec && kc < k1) {  // V * sizeof(T) % 16 == 0: a piece is all in or all out
#pragma unroll
        for (int i = 0; i < R; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(hrow[i] + kc));
      }
    };
    if constexpr (kVec) {
#pragma unroll
      for (int a = 0; a < A; ++a) fetch(a, ring[a]);
    }
    load_chunk(0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(c + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // the lane's batch rows of the chunk
      const float* xc = xsm + (c & 1) * MB * C + bh * MBL * C;
      for (int s0 = 0; s0 < kSteps; s0 += A) {
#pragma unroll
        for (int a = 0; a < A; ++a) {  // ring slot a holds step s0 + a
          const int s = s0 + a;
          const int g = c * kSteps + s;
          const long long kc = piece_at(g);
          const float* xp = xc + 4 * (s * 2 * E + kl);
          if constexpr (kVec) {
            if (kc < k1) fma_piece<T, R, MBL, C, J, 0>(acc, ring[a], xp);
            fetch(g + A, ring[a]);
          } else if (kc < k1) {
            const int lim = (int)min((long long)E, k1 - kc);
#pragma unroll
            for (int j = 0; j < J; ++j) {
              float h[R][4];
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int el = 4 * j + e;
                  unsigned word = 0;
                  if (el < lim) {
                    if constexpr (sizeof(T) == 4) word = __float_as_uint(hrow[i][kc + el]);
                    else if constexpr (sizeof(T) == 2) word = hrow[i][kc + el];
                    else word = (unsigned char)hrow[i][kc + el];
                  }
                  float x[4];
                  unpack<T>(word, x);  // the element in the low bits
                  h[i][e] = x[0];
                }
              fma_quad<R, MBL, C>(acc, h, xp, j, lim);
            }
          }
        }
      }
      __syncthreads();  // the buffer is refilled two chunks on
    }
  }

  // the 8 lanes of a row: a fixed butterfly (a + b == b + a exactly, so
  // every lane ends with the same sum)
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int b = 0; b < MBL; ++b) {
      float v = acc[i][b];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      acc[i][b] = v;
    }
  if (kl == 0) {
    const int bl = b0 + bh * MBL;  // the lane's first batch row
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long p = prow0 + RL * i;
      if (p >= P) continue;
#pragma unroll
      for (int b = 0; b < MBL; ++b)
        if (bl + b < B) part[((long long)split * B + bl + b) * P + p] = acc[i][b];
    }
  }
}

}  // namespace two_read

// ---------------------------------------------------------------------------
// Plan "one_read": small B (fp32 up to 8, bf16 and int8 up to 4), H read
// once, every storage type.
//
// A thread-block cluster of kCluster CTAs splits P: CTA r holds rows
// [r R, (r + 1) R) (R = ceil(P / kCluster) <= kMaxRows) of a panel 64 bytes
// wide (16 fp32, 32 bf16 or 64 int8 columns) in shared memory, in a ring of
// slabs so the next panels load while this one is used. The last warp's
// lane 0 issues a slab as TMA boxes of kBoxRows rows that land on the
// slab's mbarrier, and every thread waits on that barrier. A slab holds
// 32-bit words whatever the storage: a word is one fp32 value, two bf16
// values or four codes, converted exactly to fp32 where they are used.
//   bp: thread (g, c) sums word c of rows g, g + groups, ... (one to four
//     columns) in a fixed order; with more than one column a word, the two
//     groups of a warp are added by a shuffle first; then the groups are
//     summed in order. Each update thread (one per batch row and column)
//     pushes the CTA's partial to the same slot of every CTA of the cluster
//     (st.async, counted on that CTA's mbarrier), waits until all kCluster
//     partials have landed in its own slots and sums them in rank order, so
//     every CTA holds the same bp and applies the same update. int8 codes:
//     bp is summed in code space and rounded times the voxel's scale before
//     the update, and the forward operand kept for the fitted pass is
//     f_new * scale, rounded. Rank 0 writes f_new.
//   fitted: each CTA adds its rows' operand . slab^T into registers
//     (kMaxRows / threads rows a thread), one 16-byte chunk of the panel at
//     a time for all its rows.
// The clusters are persistent: cluster g walks panels g, g + G, ... and at
// the end writes its fitted [B, P] to partials [G, B, P]; a second launch sums
// them in cluster order. Per panel: two block barriers, the slab's mbarrier
// and the partials' mbarrier (two slots, so a CTA may push the next panel's
// partial while another still reads this one's). The slabs' 16-byte chunks
// are XOR-swizzled by row (TMA's 64-byte swizzle) so that both passes read
// shared memory without bank conflicts. The weights are kept row-major,
// w[row][b] padded to 4 or 8 batch rows, so the bp pass reads one row's
// weights for all batch rows as one or two 16-byte loads (at NB = 8, 3
// shared-memory loads for 8 FMAs a row, not 9). With two slabs the next
// panel's copy is issued at the top of a panel, after a block barrier that
// follows the previous panel's fitted pass, so it overlaps this panel's
// bp pass too; with three it is issued after the bp pass.
//
// Measured on the H100 (PERF.md §6, phases from sweep_measure.py): a
// cluster barrier per panel cost 0.55-0.9 us in its arrive (the release
// waits for the thread's memory operations), and loading slabs with
// cp.async from every thread 0.35-0.63 us more to issue; the push exchange
// and TMA take both off the chain. bf16 and int8 run 512 threads where
// their shared memory fits (shorter compute passes), fp32 256 up to B = 4
// and 512 from B = 5; a ring of three slabs where it fits, else two (fp32
// from B = 5: 128 KB of slabs, 32 KB of weights). What bounds it is one read of H
// (bytes): at 8192 x 65536, B = 1 fp32 and bf16 stream H at 2.5-2.7 TB/s;
// int8 is held back first by its two compute passes (most of a panel).
//
// Each code is converted twice per panel (bp and fitted pass), 131k
// conversions a CTA per int8 panel; I2F issues 16 a clock per SM against
// 128 FMAs, so a code becomes fp32 through 2^23's bit pattern instead (one
// PRMT and one FADD, both exact).
// ---------------------------------------------------------------------------
namespace one_read {

constexpr int kCluster = 8;
constexpr int kRowBytes = 64;          // a panel's row segment
constexpr int kWords = kRowBytes / 4;  // 32-bit words a row
constexpr int kMaxRows = 1024;
constexpr int kMaxB = 8;               // fp32; bf16 and int8 take at most 4
constexpr int kMaxClusters = 16;
constexpr int kBoxRows = 256;          // rows of a TMA box (at most 256)
constexpr int kSmemLimit = 232448;     // shared memory a block may use (sm_90)

template <typename T, int NB, int Threads, int Stages>
struct SmemOf {
  static constexpr int kPerWord = 4 / (int)sizeof(T);  // columns a word
  static constexpr int kCols = kWords * kPerWord;      // columns a panel
  // groups whose partial bp meet in shared memory (a warp's two groups are
  // added by a shuffle first where a word holds more than one column)
  static constexpr int kRedGroups = Threads / kWords / (kPerWord > 1 ? 2 : 1);

  // a row's weights for every batch row as one or two 16-byte loads
  static constexpr int kWStride = NB <= 2 ? NB : (NB + 3) / 4 * 4;

  unsigned slab[Stages][kMaxRows * kWords];  // first: 1024-byte aligned
  float w[kMaxRows][kWStride];
  float red[kRedGroups][NB][kCols];
  float part[2][kCluster][NB][kCols];  // every rank's partial bp, two slots
  float fnew[NB][kCols];
  unsigned long long full[Stages];     // mbarriers: the slab has landed
  unsigned long long got[2];           // mbarriers: every rank's partial has
};

// The kernel's shape for a storage type and batch size: 512 threads for bf16
// and int8 where the shared memory fits, else 256; fp32 256 up to NB = 4
// and 512 from NB = 5 (measured on the H100, sweep_measure.py threads: 512
// took 6-16% less at B = 5 and 8, 4% more at B = 4; a measurement build
// sets SART_ONE_READ_FP32_WIDE_THREADS to 256 to compare); three slabs where
// they fit, else two.
#ifndef SART_ONE_READ_FP32_WIDE_THREADS
#define SART_ONE_READ_FP32_WIDE_THREADS 512
#endif
template <typename T, int NB>
struct Cfg {
  static constexpr int kThreads =
      sizeof(T) == 4 ? (NB > 4 ? SART_ONE_READ_FP32_WIDE_THREADS : 256)
      : sizeof(SmemOf<T, NB, 512, 3>) <= kSmemLimit ? 512 : 256;
  static constexpr int kStages = sizeof(SmemOf<T, NB, kThreads, 3>) <= kSmemLimit ? 3 : 2;
  using Smem = SmemOf<T, NB, kThreads, kStages>;
  static constexpr int kGroups = kThreads / kWords;           // bp row groups
  static constexpr int kRowsPerThread = kMaxRows / kThreads;  // fitted pass
  static_assert(sizeof(Smem) <= kSmemLimit, "one_read: shared memory");
};

// Row r's weights of the NB batch rows, from its kWStride floats
template <int NB, int S>
__device__ __forceinline__ void load_w(const float (&row)[S], float (&wv)[NB]) {
  if constexpr (S == 1) {
    wv[0] = row[0];
  } else if constexpr (S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    wv[0] = q.x;
    wv[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < S / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(row)[k];
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j < NB) wv[4 * k + j] = e[j];
    }
  }
}

// E floats to shared memory as one store
template <int E>
__device__ __forceinline__ void store(float* dst, const float (&x)[E]) {
  if constexpr (E == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *dst = x[0];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival that also expects `bytes` of asynchronous transfers
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the barrier's phase of this parity to complete. A wait past
// about ten seconds traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}
// A box of the tensor map at (column x, row y) into shared memory, counted
// on the barrier when it lands.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}
// v into the same shared-memory element of cluster rank `rank`, counted on
// that rank's copy of the barrier
__device__ __forceinline__ void push(float* elem, int rank, float v, unsigned long long* bar) {
  unsigned remote, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(elem)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   remote),
               "r"(__float_as_uint(v)), "r"(remote_bar)
               : "memory");
}

// A measurement build (sweep_measure.py phases, -DSART_ONE_READ_PHASES)
// has thread 0 of every CTA add up the clock cycles of each phase of the
// panel loop, and the loop's nanoseconds, into g_phases; the shipped build
// has none of it.
// wait, bp, push, issue, gather, update, fitted
constexpr int kPhases = 7;
#ifdef SART_ONE_READ_PHASES
__device__ unsigned long long g_phases[kMaxClusters * kCluster][kPhases + 2];
#endif

// word index of (row r, word c) in a slab: the 16-byte chunks of a row
// XOR-swizzled by row, the layout TMA's 64-byte swizzle writes
__device__ __forceinline__ int slab_at(int r, int c) {
  return r * kWords + ((((c >> 2) ^ (r >> 1)) & 3) << 2) + (c & 3);
}

template <typename T, int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(Cfg<T, NB>::kThreads, 1)
sweep_kernel(const __grid_constant__ CUtensorMap hmap, const float* __restrict__ scale,
             const float* __restrict__ w, const float* __restrict__ f, AuxPanels aux,
             float* __restrict__ f_new, float* __restrict__ partial, int P, int V,
             int rows, int mode, int has_pen, float alpha, float eps) {
  using K = Cfg<T, NB>;
  using Smem = typename K::Smem;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int E = Smem::kPerWord, C = Smem::kCols, S = K::kStages;
  constexpr int kThreads = K::kThreads, kGroups = K::kGroups;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int G = gridDim.x / kCluster;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, P - row0));
  const int n_panels = V / C;
  const int mine = cid < n_panels ? (n_panels - cid + G - 1) / G : 0;
  const int t = threadIdx.x;
  const bool issuer = t == kThreads - 32;  // off the update threads' warps

  for (int i = t; i < Smem::kWStride * kMaxRows; i += kThreads) {
    const int b = i / kMaxRows, r = i - b * kMaxRows;
    sm.w[r][b] = b < NB && r < nrows ? w[(long long)b * P + row0 + r] : 0.0f;
  }
  // a panel's rows of this CTA as whole TMA boxes (rows past P arrive as
  // zeros, rows past nrows are not read)
  const int boxes = (nrows + kBoxRows - 1) / kBoxRows;
  auto load_panel = [&](int k) {  // the k-th panel of this cluster
    unsigned long long* bar = &sm.full[k % S];
    mbar_expect(bar, (unsigned)(boxes * kBoxRows * kRowBytes));
    for (int b = 0; b < boxes; ++b)
      tma_load(&sm.slab[k % S][b * kBoxRows * kWords], &hmap, bar, (cid + k * G) * C,
               row0 + b * kBoxRows);
  };
  if (issuer) {
    for (int k = 0; k < S; ++k) mbar_init(&sm.full[k]);
    for (int k = 0; k < 2; ++k) mbar_init(&sm.got[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < S - 1 && k < mine; ++k) load_panel(k);
  }
  cluster.sync();  // every rank's barriers are set before any push

  float fit[K::kRowsPerThread][NB];
#pragma unroll
  for (int j = 0; j < K::kRowsPerThread; ++j)
#pragma unroll
    for (int b = 0; b < NB; ++b) fit[j][b] = 0.0f;

  const int c = t % kWords, g = t / kWords;  // bp pass: word c, row group g
  const int ub = t / C, uc = t % C;          // update: batch row, column
  const bool upd = t < NB * C;
  const bool scheduled = aux.alpha_lane != nullptr;
  const float a_row = upd ? row_alpha(aux, alpha, ub) : alpha;  // once per thread
  constexpr unsigned kPartBytes = kCluster * NB * C * sizeof(float);
#ifdef SART_ONE_READ_PHASES
  unsigned long long cycles[kPhases] = {}, ns0, ns1;
  long long tick = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  auto phase = [&](int k) {
    if (t == 0) {
      const long long now = clock64();
      cycles[k] += now - tick;
      tick = now;
    }
  };
#else
  auto phase = [](int) {};
#endif
  // two slabs: the next panel's copy is issued at the top of this one
  constexpr bool kIssueEarly = S == 2;
  for (int i = 0; i < mine; ++i) {
    if constexpr (kIssueEarly) {
      // every thread is past panel i - 1's fitted pass: its slab is free
      __syncthreads();
      if (issuer && i + 1 < mine) load_panel(i + 1);
    }
    const long long v = (long long)(cid + i * G) * C + uc;
    float fu = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, s = 1.0f;
    if (upd) {  // in flight while the partial bp is summed
      fu = f[(long long)ub * V + v];
      load_aux(aux, mode, has_pen, ub, v, a0, a1, a2);
      if (kScaled) s = scale[v];
    }
    // this panel's slot: its phase before (panel i - 2) completed before
    // this thread's wait on it, so the next phase's bytes may be posted
    if (t == 0) mbar_expect(&sm.got[i & 1], kPartBytes);
    mbar_wait(&sm.full[i % S], (i / S) & 1);
    phase(0);
    const unsigned* slab = sm.slab[i % S];

    float acc[NB][E];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[b][e] = 0.0f;
    for (int r = g; r < nrows; r += kGroups) {
      float h[E], wv[NB];
      unpack<T>(slab[slab_at(r, c)], h);
      load_w<NB>(sm.w[r], wv);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[b][e] = fmaf(wv[b], h[e], acc[b][e]);
    }
    if constexpr (E > 1) {
      // the warp's even group (lanes 0-15) plus its odd group (16-31)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[b][e] += __shfl_down_sync(0xffffffffu, acc[b][e], 16);
      if ((t & 16) == 0)
#pragma unroll
        for (int b = 0; b < NB; ++b) store<E>(&sm.red[g >> 1][b][c * E], acc[b]);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) sm.red[g][b][c] = acc[b][0];
    }
    __syncthreads();
    phase(1);
    if (upd) {
      float sum = sm.red[0][ub][uc];
#pragma unroll
      for (int k = 1; k < Smem::kRedGroups; ++k) sum += sm.red[k][ub][uc];
      // A rank pushes panel i + 2 into this slot only after it has every
      // rank's partial of panel i + 1, which each rank pushes after reading
      // panel i's.
#pragma unroll
      for (int r = 0; r < kCluster; ++r) push(&sm.part[i & 1][rank][ub][uc], r, sum, &sm.got[i & 1]);
    }
    phase(2);
    // three slabs: the slab of panel i - 1 is free, every thread has passed
    // the block barrier after this panel's bp pass
    if (!kIssueEarly && issuer && i + S - 1 < mine) load_panel(i + S - 1);
    phase(3);
    if (upd) mbar_wait(&sm.got[i & 1], (i >> 1) & 1);
    phase(4);
    if (upd) {
      float bp = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) bp += sm.part[i & 1][r][ub][uc];
      if (kScaled) bp = __fmul_rn(bp, s);
      const float fn = update_vals(mode, has_pen, a_row, scheduled, eps, fu, bp, a0, a1, a2);
      sm.fnew[ub][uc] = kScaled ? __fmul_rn(fn, s) : fn;
      if (rank == 0) f_new[(long long)ub * V + v] = fn;
    }
    __syncthreads();
    phase(5);
    // one 16-byte chunk (4 E columns) of every row of this thread at a time,
    // the columns of a row in order
    constexpr int kChunkCols = 4 * E;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float x[NB][kChunkCols];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int k = 0; k < kChunkCols; ++k) x[b][k] = sm.fnew[b][q * kChunkCols + k];
#pragma unroll
      for (int j = 0; j < K::kRowsPerThread; ++j) {
        const int r = t + j * kThreads;
        if (r < nrows) {
          const uint4 u = *reinterpret_cast<const uint4*>(slab + slab_at(r, 4 * q));
          float h[kChunkCols];
          unpack<T>(u.x, h);
          unpack<T>(u.y, h + E);
          unpack<T>(u.z, h + 2 * E);
          unpack<T>(u.w, h + 3 * E);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            float acc_f = fit[j][b];
#pragma unroll
            for (int k = 0; k < kChunkCols; ++k) acc_f = fmaf(h[k], x[b][k], acc_f);
            fit[j][b] = acc_f;
          }
        }
      }
    }
    phase(6);
    // no block barrier here: the slab is reloaded and fnew and red
    // rewritten only once every thread has passed a later block barrier
  }
#ifdef SART_ONE_READ_PHASES
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (t == 0) {
    unsigned long long total = 0;
    for (int k = 0; k < kPhases; ++k) {
      g_phases[blockIdx.x][k] = cycles[k];
      total += cycles[k];
    }
    g_phases[blockIdx.x][kPhases] = total;
    g_phases[blockIdx.x][kPhases + 1] = ns1 - ns0;
  }
#endif
  cluster.sync();  // no CTA leaves while a push to it may be in flight

  float* out = partial + (long long)cid * NB * P;
#pragma unroll
  for (int j = 0; j < K::kRowsPerThread; ++j) {
    const int r = t + j * kThreads;
    if (r < nrows)
#pragma unroll
      for (int b = 0; b < NB; ++b) out[(long long)b * P + row0 + r] = fit[j][b];
  }
}

}  // namespace one_read

// ---------------------------------------------------------------------------
// The pixel-sharded sweep's cluster route: sart_sharded_bp and
// sart_sharded_finish in one kernel a call each, for B <= 4 with H's rows
// 16-byte aligned where two_read's splits of P number at most 8
// (ops/fused_sweep.py:split_route; the other shapes take two_read's kernels,
// "The pixel-sharded sweep" below). No Pallas kernel is its counterpart:
// the JAX package's pixel-sharded sweep is plain XLA
// (sartsolver_tpu/ops/fused_sweep.py:270). Every sum is taken in two_read's
// order, so the route gives two_read's bytes:
//
//   bp_kernel: a CTA owns a strip of LANES 16-byte pieces of each row (64,
//     32 or 16 lanes: 256 columns of fp32 up to 1024 of int8) and one of
//     two_read's S splits of P. Row group g of 4 sums the split's rows g,
//     g + 4, ... in ascending order, as in two_read::bp_kernel, one lane a
//     16-byte piece; the groups meet as (q0 + q1) + (q2 + q3) in shared
//     memory. The S splits of a strip form one thread-block cluster and meet
//     in split order through distributed shared memory: each CTA sums a
//     share of the strip's columns from every CTA's shared memory and writes
//     bp; no partials leave the cluster. LANES is the largest that still
//     puts about two CTAs on every SM (fp32 64, bf16 32, int8 16 at V =
//     65536: 256 CTAs each), so every storage covers the SMs; a thread's
//     bytes of a row stay 16 whatever the storage (fewer bytes a row a
//     thread, or one row group a CTA, measured slower: PERF.md §6).
//   finish_kernel: a CTA owns a row block of 64 pixel rows of one of
//     two_read's S2 splits of V at a time; CL CTAs of neighbouring row blocks
//     and the same split form a cluster. Each CTA computes the update (bp
//     rounded times the scale for codes, f_new, the forward operand) for its
//     share of the split's columns once and stores the operand into the
//     shared memory of every CTA of the cluster, permuted as the forward
//     reads it; the split's first cluster writes f_new. The operand never
//     goes through device memory. The clusters are persistent (as many as
//     the card holds, divided among the splits), each walking its split's
//     row blocks, so the update runs once a cluster. The forward pass is
//     two_read::forward_kernel's: lane kl of 8 sums piece kl of each
//     128-byte step of a row in ascending order and the 8 lanes meet in the
//     same butterfly. The S2 splits of a row meet in split order through
//     partials [S2, B, P] in device memory, summed by whichever CTA of the
//     row block arrives last (a counter per row block, which that CTA
//     resets): a cluster cannot hold both a split's row blocks, which share
//     its operand, and a row block's S2 splits.
//
// Both stream H through a ring of shared-memory stages that a producer
// warp's lane 0 fills with one 2D TMA box a stage (cp.async.bulk.tensor, H seen as
// 32-bit words; rows past P and words past a row read as zeros), completing
// on the stage's mbarrier; the consumer warps hand a stage back on a second
// mbarrier. w is read in place (at most 4 loads a row, from L1). Row
// segments copied one cp.async.bulk each (512 bytes to 1 KB) held a CTA to
// half the rate a box reaches (PERF.md §6).
//
// What bounds them: one read of the rank's block (bytes): 4096 x 65536 fp32
// is 1.07 GB, 0.321 ms at the H100 SXM's 3.35 TB/s.
// ---------------------------------------------------------------------------
namespace split {

constexpr int kSMs = 132;
constexpr int kMaxB = 4;
constexpr int kMaxCluster = 8;
// bp
constexpr int kBpStageBytes = 16384;  // of H a stage
// stages of the ring: 96 KB where two CTAs share an SM, 192 KB where the
// grid puts one on each
#ifndef SART_SPLIT_BP_STAGES
#define SART_SPLIT_BP_STAGES 6
#endif
constexpr int kBpStagesShared = SART_SPLIT_BP_STAGES;
constexpr int kBpStagesAlone = 2 * SART_SPLIT_BP_STAGES < 13 ? 2 * SART_SPLIT_BP_STAGES : 13;
constexpr int kBpBarriers = 1024;  // the barriers' bytes before the ring
constexpr int kTargetCtas = 2 * kSMs * 9 / 10;  // about two CTAs on every SM
// finish
constexpr int kFwdRows = 64;          // a row block: 8 warps x 4 row lanes x 2 rows
constexpr int kFwdR = 2;              // rows a lane
constexpr int kFwdWarps = 8;
constexpr int kFwdConsumers = 32 * kFwdWarps;
constexpr int kFwdThreads = kFwdConsumers + 32;  // and the producer warp
#ifndef SART_SPLIT_FWD_STAGES
#define SART_SPLIT_FWD_STAGES 4
#endif
constexpr int kFwdStages = SART_SPLIT_FWD_STAGES;

using one_read::smem_addr;

__device__ __forceinline__ void mbar_init_n(unsigned long long* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// a barrier of the `n` consumer threads alone (the producer may have left)
template <int n>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(n) : "memory");
}

// Elements 4j .. 4j + 3 of a 16-byte piece of H as fp32 (two_read::quad_of
// with j a value: the loops that call it are unrolled)
template <typename T>
__device__ __forceinline__ void quad_at(const uint4& q, int j, float (&h)[4]) {
  if constexpr (sizeof(T) == 4) {
    h[0] = __uint_as_float(q.x);
    h[1] = __uint_as_float(q.y);
    h[2] = __uint_as_float(q.z);
    h[3] = __uint_as_float(q.w);
  } else if constexpr (sizeof(T) == 2) {
    unpack<T>(two_read::word_of(q, 2 * j), h);
    unpack<T>(two_read::word_of(q, 2 * j + 1), h + 2);
  } else {
    unpack<T>(two_read::word_of(q, j), h);
  }
}

// The bp kernel's shape for storage type T and LANES lanes a row group
template <typename T, int LANES>
struct BpShape {
  static constexpr int kConsumers = 4 * LANES;        // 4 row groups
  static constexpr int kThreads = kConsumers + 32;    // and the producer warp
  static constexpr int kWarps = kConsumers / 32;
  static constexpr int CPT = 16 / (int)sizeof(T);     // columns a lane
  static constexpr int Cols = LANES * CPT;            // columns a strip
  static constexpr int kStrip = LANES * 16;           // bytes of a row
  static constexpr int Kt = kBpStageBytes / kStrip;   // rows a stage (the box)
  static constexpr int KW = (Kt + 31) / 32;           // a lane's weights a stage
  static constexpr int smem(int stages) { return kBpBarriers + stages * kBpStageBytes; }
  static_assert(Kt % 4 == 0 && Kt <= 256 && kStrip / 4 <= 256, "split: bp shape");
  static_assert(2 * kBpStagesAlone * 8 <= kBpBarriers, "split: bp barriers");
};

// bp[b, v] = sum of w[b, p] H[p, v] in two_read's order. Grid: strips x S,
// one cluster of the S splits of a strip (cluster rank = split).
template <typename T, int MB, int LANES>
__global__ void __launch_bounds__(BpShape<T, LANES>::kThreads)
bp_kernel(const __grid_constant__ CUtensorMap hmap, const float* __restrict__ w,
          float* __restrict__ bp, int P, int V, int B, int rows_per_split, int stages) {
  using K = BpShape<T, LANES>;
  constexpr int Cols = K::Cols, CPT = K::CPT, Kt = K::Kt, KW = K::KW, kSlot = MB * Cols;
  extern __shared__ __align__(1024) unsigned char smem_base[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_base);
  unsigned long long* empty = full + stages;
  unsigned char* smem = smem_base + kBpBarriers;  // the ring
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int strip = blockIdx.x / S;
  const long long n0 = (long long)strip * Cols;
  const int p0 = s * rows_per_split, p1 = min(P, p0 + rows_per_split);
  const int n_it = (p1 - p0 + Kt - 1) / Kt;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init_n(&full[k], 1);
      mbar_init_n(&empty[k], K::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool consumer = t < K::kConsumers;
  const int lg = t / LANES, l = t % LANES;  // a consumer's row group and lane
  float acc[MB][CPT];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0.0f;

  if (!consumer) {  // the producer warp: its lane 0 issues a box a stage
    for (int it = 0; it < n_it; ++it) {
      const int k = it % stages;
      if (it >= stages) one_read::mbar_wait(&empty[k], ((it / stages) - 1) & 1);
      if (t == K::kConsumers) {
        one_read::mbar_expect(&full[k], (unsigned)kBpStageBytes);
        one_read::tma_load(smem + k * kBpStageBytes, &hmap, &full[k],
                           strip * (K::kStrip / 4), p0 + it * Kt);
      }
      __syncwarp();
    }
  } else {
    // a stage's weights, one coalesced load a warp ahead of the stage: lane
    // i holds row r0 + 32 m + i of each batch row in wn[m][b], which the
    // row's lanes take by a shuffle
    const int lane = t & 31;
    float wn[KW][MB];
    auto fetch_w = [&](int it) {
#pragma unroll
      for (int m = 0; m < KW; ++m) {
        const int i = 32 * m + lane, p = p0 + it * Kt + i;
#pragma unroll
        for (int b = 0; b < MB; ++b)
          wn[m][b] = (b < B && i < Kt && p < p1) ? __ldg(w + (long long)b * P + p) : 0.0f;
      }
    };
    fetch_w(0);
    for (int it = 0; it < n_it; ++it) {
      const int k = it % stages;
      float wc[KW][MB];
#pragma unroll
      for (int m = 0; m < KW; ++m)
#pragma unroll
        for (int b = 0; b < MB; ++b) wc[m][b] = wn[m][b];
      if (it + 1 < n_it) fetch_w(it + 1);
      one_read::mbar_wait(&full[k], (it / stages) & 1);
      const unsigned char* st = smem + k * kBpStageBytes + l * 16;
      const int r0 = p0 + it * Kt;
#pragma unroll
      for (int jj = 0; jj < Kt / 4; ++jj) {
        const int j = 4 * jj + lg;  // row group lg: the split's rows lg, lg + 4, ...
        float wv[MB];
#pragma unroll
        for (int b = 0; b < MB; ++b)  // j / 32 == jj / 8: lg < 4
          wv[b] = __shfl_sync(0xffffffffu, wc[jj / 8][b], j % 32);
        if (r0 + j < p1) {
          float hv[CPT];
          two_read::load_cols<T, CPT>(reinterpret_cast<const T*>(st + j * K::kStrip), hv);
#pragma unroll
          for (int b = 0; b < MB; ++b)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[b][c] = fmaf(wv[b], hv[c], acc[b][c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k]);
    }
  }
  __syncthreads();  // every stage has landed and been read: the ring is free

  // (q0 + q1) + (q2 + q3) in the ring's memory; slot 1 then holds the
  // split's sum, [MB][Cols], which the cluster reads
  float* red = reinterpret_cast<float*>(smem);
  auto at = [&](int k, int b, int c) -> float& {
    return red[k * kSlot + b * Cols + l * CPT + c];
  };
  if (consumer && (lg & 1))
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int c = 0; c < CPT; ++c) at(lg >> 1, b, c) = acc[b][c];
  __syncthreads();
  if (consumer && !(lg & 1))
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[b][c] += at(lg >> 1, b, c);
  __syncthreads();
  if (consumer && lg == 2)
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int c = 0; c < CPT; ++c) at(0, b, c) = acc[b][c];
  __syncthreads();
  if (consumer && lg == 0)
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int c = 0; c < CPT; ++c) at(1, b, c) = acc[b][c] + at(0, b, c);
  if (S > 1) cluster.sync();
  else __syncthreads();

  // CTA s writes bp for its share of the strip's columns, the splits
  // summed in split order
  float* mine = red + kSlot;
  const int per = (Cols + S - 1) / S;
  const int c0 = s * per, n = max(0, min(Cols, c0 + per) - c0);
  for (int e = t; e < MB * n; e += K::kThreads) {
    const int b = e / n, c = c0 + (e - b * n);
    if (b >= B || n0 + c >= V) continue;
    float* o = mine + b * Cols + c;
    float total = *cluster.map_shared_rank(o, 0);
    for (int sp = 1; sp < S; ++sp) total += *cluster.map_shared_rank(o, sp);
    bp[(long long)b * V + n0 + c] = total;
  }
  if (S > 1) cluster.sync();  // no CTA leaves while its slot may be read
}

// The finish kernel's shape for storage type T and MB batch rows
template <typename T, int MB>
struct FwdShape {
  static constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  static constexpr int J = E / 4;                // its float4s of the operand
  static constexpr int kStep = 8 * E;            // columns of a 128-byte step
  // bytes of a row a stage (the box's width, at most 256 words): 16 KB
  // stages, so the ring and a split's operand at B = 1 (96 KB) leave room
  // for two CTAs an SM
#ifdef SART_SPLIT_FWD_ROW_BYTES
  static constexpr int kRowBytes = SART_SPLIT_FWD_ROW_BYTES;
#else
  static constexpr int kRowBytes = 256;
#endif
  static constexpr int kSteps = kRowBytes / 128;
  static constexpr int kCols = kRowBytes / (int)sizeof(T);  // columns a stage
  static constexpr int kStage = kFwdRows * kRowBytes;
  static constexpr int kRing = kFwdStages * kStage;
  // the ring, the operand of a split of `cols` columns, the barriers
  static constexpr int smem(int cols) { return kRing + MB * cols * 4 + 2 * kFwdStages * 8; }
  static_assert(two_read::kSplitColsAlign % kCols == 0 && kRowBytes / 4 <= 256,
                "split: forward shape");
};

// f_new and fitted of the rank's rows from the reduced bp, in two_read's
// order. Grid: (clusters a split x CL, S2); cluster q of split y walks the
// split's groups of CL row blocks g = q, q + clusters, ...; its CTA cr takes
// row block g CL + cr of each.
template <typename T, int MB>
__global__ void __launch_bounds__(kFwdThreads, 1)
finish_kernel(const __grid_constant__ CUtensorMap hmap, const float* __restrict__ scale,
              const float* __restrict__ f, const float* __restrict__ bp, AuxPanels aux,
              float* __restrict__ f_new, float* __restrict__ fitted, float* __restrict__ part,
              unsigned* __restrict__ counters, int P, int V, int B, int cols_per_split,
              int S2, int mode, int has_pen, float alpha, float eps) {
  using K = FwdShape<T, MB>;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int E = K::E, J = K::J;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned last;
  float* xs = reinterpret_cast<float*>(smem + K::kRing);  // [MB][cols_per_split], permuted
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + K::kRing + MB * cols_per_split * 4);
  unsigned long long* empty = full + kFwdStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int cr = (int)cluster.block_rank();
  const int q = blockIdx.x / CL, nq = gridDim.x / CL;  // this cluster, the split's clusters
  const int split = blockIdx.y;
  const long long k0 = (long long)split * cols_per_split;
  const int ncols = (int)min((long long)cols_per_split, V - k0);
  const int row_blocks = (P + kFwdRows - 1) / kFwdRows;
  const int groups = (row_blocks + CL - 1) / CL;
  const int n_it = (ncols + K::kCols - 1) / K::kCols;  // stages a row block
  const int t = threadIdx.x;

  if (t == 0) {
    for (int k = 0; k < kFwdStages; ++k) {
      mbar_init_n(&full[k], 1);
      mbar_init_n(&empty[k], kFwdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // the barriers are set; every CTA of the cluster runs

  // the producer warp's boxes (its lane 0 issues them): for each of the
  // CTA's row blocks in turn, its stages; stage number gs counts across row
  // blocks (the ring's phase)
  const int word0 = (int)(k0 * (long long)sizeof(T) / 4);
  int next_g = q, next_it = 0, gs = 0;
  auto issue_next = [&]() -> bool {  // the next box, false when none is left
    while (next_g < groups && next_g * CL + cr >= row_blocks) next_g += nq;
    if (next_g >= groups) return false;
    const int k = gs % kFwdStages;
    if (gs >= kFwdStages) one_read::mbar_wait(&empty[k], ((gs / kFwdStages) - 1) & 1);
    if (t == kFwdConsumers) {
      one_read::mbar_expect(&full[k], (unsigned)K::kStage);
      one_read::tma_load(smem + k * K::kStage, &hmap, &full[k],
                         word0 + next_it * (K::kRowBytes / 4), (next_g * CL + cr) * kFwdRows);
    }
    __syncwarp();
    ++gs;
    if (++next_it == n_it) {
      next_it = 0;
      next_g += nq;
    }
    return true;
  };
  const bool producer = t >= kFwdConsumers;
  if (producer) {
    for (int i = 0; i < kFwdStages; ++i)
      if (!issue_next()) break;
  } else {
    // the update of this CTA's share of the split's columns, stored into the
    // operand of every CTA of the cluster: float4 j of lane kl's piece of
    // step g sits at g 2E + j 8 + kl (two_read::forward_kernel's order)
    const int per = (ncols + CL - 1) / CL;
    const int c0 = cr * per, n = max(0, min(ncols, c0 + per) - c0);
    const bool writer = q == 0;  // the split's first cluster writes f_new
    for (int e = t; e < MB * n; e += kFwdConsumers) {
      const int b = e / n, c = c0 + (e - b * n);
      const long long v = k0 + c;
      float x = 0.0f;
      if (b < B) {
        const long long o = (long long)b * V + v;
        const float sc = kScaled ? scale[v] : 1.0f;
        float g = bp[o];
        if (kScaled) g = __fmul_rn(g, sc);
        const float fn = update(mode, has_pen, alpha, eps, f[o], g, aux, b, v);
        if (writer) f_new[o] = fn;
        x = kScaled ? __fmul_rn(fn, sc) : fn;
      }
      const int qq = (c % K::kStep) / 4;
      float* dst = xs + b * cols_per_split +
                   4 * ((c / K::kStep) * 2 * E + (qq % J) * 8 + qq / J) + c % 4;
      for (int r = 0; r < CL; ++r) *cluster.map_shared_rank(dst, r) = x;
    }
  }
  cluster.sync();  // every CTA's operand is whole

  if (producer) {
    while (issue_next()) {
    }
    return;
  }
  const int lane = t & 31, kl = lane & 7;
  const int row0 = (t >> 5) * 4 + (lane >> 3);  // the lane's rows of a block: row0 + 32 i
  int cs = 0;                                   // the consumers' stage number
  for (int g = q; g < groups; g += nq) {
    const int rb = g * CL + cr;
    if (rb >= row_blocks) continue;
    const int pb = rb * kFwdRows;
    const int nrows = min(kFwdRows, P - pb);
    float acc[kFwdR][MB];
#pragma unroll
    for (int i = 0; i < kFwdR; ++i)
#pragma unroll
      for (int b = 0; b < MB; ++b) acc[i][b] = 0.0f;
    for (int it = 0; it < n_it; ++it, ++cs) {
      const int k = cs % kFwdStages;
      one_read::mbar_wait(&full[k], (cs / kFwdStages) & 1);
      const unsigned char* st = smem + k * K::kStage + kl * 16;
#pragma unroll
      for (int s = 0; s < K::kSteps; ++s) {
        const int gstep = it * K::kSteps + s;  // the step of the split
        if (gstep * K::kStep + kl * E < ncols) {
          uint4 raw[kFwdR];
#pragma unroll
          for (int i = 0; i < kFwdR; ++i)
            raw[i] = *reinterpret_cast<const uint4*>(st + (row0 + 32 * i) * K::kRowBytes + s * 128);
          const float* xp = xs + 4 * (gstep * 2 * E + kl);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float hq[kFwdR][4];
#pragma unroll
            for (int i = 0; i < kFwdR; ++i) quad_at<T>(raw[i], j, hq[i]);
#pragma unroll
            for (int b = 0; b < MB; ++b) {
              const float4 q4 =
                  *reinterpret_cast<const float4*>(xp + b * cols_per_split + 32 * j);
              const float x[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
              for (int i = 0; i < kFwdR; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][b] = fmaf(hq[i][e], x[e], acc[i][b]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k]);
    }

    // the 8 lanes of a row: two_read's butterfly
#pragma unroll
    for (int i = 0; i < kFwdR; ++i)
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        float v = acc[i][b];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        acc[i][b] = v;
      }
    float* out = S2 == 1 ? fitted : part + (long long)split * B * P;
    if (kl == 0) {
#pragma unroll
      for (int i = 0; i < kFwdR; ++i) {
        const int r = row0 + 32 * i;
        if (r >= nrows) continue;
#pragma unroll
        for (int b = 0; b < MB; ++b)
          if (b < B) out[(long long)b * P + pb + r] = acc[i][b];
      }
    }
    if (S2 == 1) continue;
    // the splits of a row in split order, by the block's last CTA to arrive
    __threadfence();
    consumer_sync<kFwdConsumers>();
    if (t == 0) last = atomicAdd(&counters[rb], 1u) == (unsigned)(S2 - 1);
    consumer_sync<kFwdConsumers>();
    if (last) {
      __threadfence();
      for (int e = t; e < B * nrows; e += kFwdConsumers) {
        const int b = e / nrows;
        const long long o = (long long)b * P + pb + (e - b * nrows);
        float sum = __ldcg(part + o);
        for (int k = 1; k < S2; ++k) sum += __ldcg(part + (long long)k * B * P + o);
        fitted[o] = sum;
      }
      if (t == 0) counters[rb] = 0;
    }
    consumer_sync<kFwdConsumers>();  // `last` is read before the next block sets it
  }
}

}  // namespace split

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

long long align256(long long n) { return (n + 255) / 256 * 256; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
long long round_up(long long a, long long b) { return ceil_div(a, b) * b; }

// The two_read plan's geometry and its scratch: wT [Pp, Ws], the bp
// partials [S, B, V], the forward operand xs [Bpad, Vp] and the forward
// partials [S2, B, P], fp32, each 256-byte aligned. The splits S (of P)
// and S2 (of V) follow from the shape alone, never from B.
struct TrShape {
  int MB, tiles, Bpad, Ws, Pp, Vp, S, rows_per_split, S2, cols_per_split;
  long long wt_bytes, bp_bytes, xs_bytes, fwd_bytes;
};

// The split count for `units` blocks a split, at most `most`: the smallest
// that fills the SMs at least 1.5 blocks deep with at most a tenth of them
// idle in the last round, else the one that idles the fewest.
long long pick_splits(long long units, long long most) {
  long long best = 1;
  double best_use = 0.0;
  for (long long s = 1; s <= most && s <= 64; ++s) {
    const double rounds = (double)(units * s) / two_read::kSMs;
    const double use = rounds / std::ceil(rounds);
    if (rounds >= 1.5 && use >= 0.9) return s;
    if (use > best_use) {
      best_use = use;
      best = s;
    }
  }
  return best;
}

TrShape tr_shape(long long P, long long V, long long B) {
  using namespace two_read;
  TrShape s;
  s.MB = B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : B <= 16 ? 16 : kMaxMB;
  s.tiles = (int)ceil_div(B, s.MB);
  s.Bpad = s.MB * s.tiles;
  s.Ws = s.Bpad < 4 ? 4 : s.Bpad;
  s.Pp = (int)round_up(P, 32);
  s.Vp = (int)round_up(V, kSplitColsAlign);
  long long want = std::max(pick_splits(ceil_div(V, kCols), ceil_div(P, kMinSplitRows)),
                            ceil_div(P, kMaxSplitRows));
  s.rows_per_split = (int)std::min(round_up(ceil_div(P, want), 64), P);
  s.S = (int)ceil_div(P, s.rows_per_split);
  want = std::max(pick_splits(ceil_div(P, kRows), ceil_div(V, kMinSplitCols)),
                  ceil_div(V, kMaxSplitCols));
  s.cols_per_split = (int)round_up(ceil_div(V, want), kSplitColsAlign);
  s.S2 = (int)ceil_div(V, s.cols_per_split);
  s.wt_bytes = align256((long long)s.Pp * s.Ws * 4);
  s.bp_bytes = align256((long long)s.S * B * V * 4);
  s.xs_bytes = align256((long long)s.Bpad * s.Vp * 4);
  s.fwd_bytes = align256((long long)s.S2 * B * P * 4);
  return s;
}

template <typename T, int MB, bool kVec>
cudaError_t launch_two_read(const T* H, const Args& a, const TrShape& s) {
  using namespace two_read;
  using K = Bp<T, MB>;
  constexpr int kFwdSmem = forward_smem<T, MB, kVec>();
  float* wT = reinterpret_cast<float*>(a.scratch);
  float* bp = reinterpret_cast<float*>(a.scratch + s.wt_bytes);
  float* xs = reinterpret_cast<float*>(a.scratch + s.wt_bytes + s.bp_bytes);
  float* fwd = reinterpret_cast<float*>(a.scratch + s.wt_bytes + s.bp_bytes + s.xs_bytes);
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(bp_kernel<T, MB, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(forward_kernel<T, MB, kVec>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid_t((unsigned)(s.Pp / 32), (unsigned)ceil_div(s.Ws, 32));
  transpose_w_kernel<<<grid_t, dim3(32, 8), 0, a.stream>>>(a.w, a.B, a.P, s.Pp, s.Ws, wT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_bp((unsigned)ceil_div(a.V, K::Cols), (unsigned)s.S, (unsigned)s.tiles);
  bp_kernel<T, MB, kVec><<<grid_bp, K::kThreads, K::kSmem, a.stream>>>(
      H, wT, bp, a.P, a.V, a.B, s.Ws, s.rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)s.Bpad * s.Vp;
  const unsigned grid_f = (unsigned)std::min(ceil_div(n, 256), 8LL * kSMs);
  finish_kernel<T><<<grid_f, 256, 0, a.stream>>>(bp, s.S, a.scale, a.f, a.aux, a.f_new,
                                                      xs, a.B, s.Bpad, a.V, s.Vp, a.mode,
                                                      a.has_pen, a.alpha, a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_fwd((unsigned)ceil_div(a.P, kRows), (unsigned)s.S2, (unsigned)s.tiles);
  forward_kernel<T, MB, kVec><<<grid_fwd, Fwd<T, MB>::kThreads, kFwdSmem, a.stream>>>(
      H, xs, fwd, a.P, a.V, s.Vp, a.B, s.cols_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(fwd, s.S2, a.B, a.B, a.P, a.fitted);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t dispatch_two_read_mb(const T* H, const Args& a, const TrShape& s) {
  switch (s.MB) {
    case 1: return launch_two_read<T, 1, kVec>(H, a, s);
    case 2: return launch_two_read<T, 2, kVec>(H, a, s);
    case 4: return launch_two_read<T, 4, kVec>(H, a, s);
    case 8: return launch_two_read<T, 8, kVec>(H, a, s);
    case 16: return launch_two_read<T, 16, kVec>(H, a, s);
    default: return launch_two_read<T, two_read::kMaxMB, kVec>(H, a, s);
  }
}

// The 16-byte loads of H need its rows 16-byte aligned; other shapes take
// element-wise loads of H through the same kernels.
template <typename T>
cudaError_t dispatch_two_read(const void* H, const Args& a) {
  const T* h = static_cast<const T*>(H);
  const TrShape s = tr_shape(a.P, a.V, a.B);
  const bool vec = (uintptr_t)H % 16 == 0 && ((long long)a.V * sizeof(T)) % 16 == 0;
  return vec ? dispatch_two_read_mb<T, true>(h, a, s) : dispatch_two_read_mb<T, false>(h, a, s);
}

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
  if (plan == kTwoRead) {
    const TrShape s = tr_shape(P, V, B);
    return s.wt_bytes + s.bp_bytes + s.xs_bytes + s.fwd_bytes;
  }
  if (plan == kOneRead) return align256((long long)one_read::kMaxClusters * B * P * 4);
  if (plan == kTensorCore) {
    const TcShape s = tc_shape(P, V, B);
    return s.ws_bytes + s.xs_bytes + s.partial_bytes;
  }
  return -1;
}

template <typename T, int MT>
cudaError_t launch_tc(const T* H, const Args& a, const TcShape& s) {
  bf16_bits* ws = reinterpret_cast<bf16_bits*>(a.scratch);
  bf16_bits* xs = reinterpret_cast<bf16_bits*>(a.scratch + s.ws_bytes);
  float* partial = reinterpret_cast<float*>(a.scratch + s.ws_bytes + s.xs_bytes);
  constexpr int smem = tc::smem_bytes<T, MT>();
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(tc::bp_update_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(tc::forward_kernel<T, MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (attr != cudaSuccess) return attr;
  tc::split_kernel<<<264, 256, 0, a.stream>>>(a.w, a.B, a.P, s.Bpad, s.Ppad, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned nbatch = (unsigned)(s.Bpad / s.rows);
  const dim3 grid_bp((unsigned)((a.V + tc::kBlockN - 1) / tc::kBlockN), nbatch);
  tc::bp_update_kernel<T, MT><<<grid_bp, tc::kThreads, smem, a.stream>>>(
      H, a.scale, ws, a.f, a.aux, a.f_new, xs, a.P, s.Ppad, a.V, a.B, s.Bpad,
      a.mode, a.has_pen, a.alpha, a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_fwd((unsigned)((a.P + tc::kBlockN - 1) / tc::kBlockN),
                      (unsigned)s.splits, nbatch);
  tc::forward_kernel<T, MT><<<grid_fwd, tc::kThreads, smem, a.stream>>>(
      H, xs, partial, a.P, a.V, s.Bpad, s.ksplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(partial, s.splits, s.Bpad, a.B,
                                                 a.P, a.fitted);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tc(const void* H, const Args& a) {
  const T* h = static_cast<const T*>(H);
  const TcShape s = tc_shape(a.P, a.V, a.B);
  return s.MT == 1 ? launch_tc<T, 1>(h, a, s) : launch_tc<T, 2>(h, a, s);
}

// Clusters of the one_read kernel that the card holds at once (at most
// kMaxClusters), asked once per kernel instance; 0 on failure.
template <typename T, int NB>
int one_read_clusters() {
  static int clusters = -1;
  if (clusters >= 0) return clusters;
  const int smem = (int)sizeof(typename one_read::Cfg<T, NB>::Smem);
  if (cudaFuncSetAttribute(one_read::sweep_kernel<T, NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(one_read::kCluster * one_read::kMaxClusters);
  config.blockDim = dim3(one_read::Cfg<T, NB>::kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = one_read::kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, one_read::sweep_kernel<T, NB>, &config) !=
      cudaSuccess)
    n = 0;
  clusters = n < one_read::kMaxClusters ? n : one_read::kMaxClusters;
  return clusters;
}

// The largest B of the one_read instances of a storage type (fp32 8, else 4)
template <typename T>
constexpr int one_read_max_b() { return sizeof(T) == 4 ? one_read::kMaxB : 4; }

template <typename T>
int one_read_clusters_at(long long B) {
  if constexpr (one_read_max_b<T>() == 8) {
    switch (B) {
      case 5: return one_read_clusters<T, 5>();
      case 6: return one_read_clusters<T, 6>();
      case 7: return one_read_clusters<T, 7>();
      case 8: return one_read_clusters<T, 8>();
      default: break;
    }
  }
  switch (B) {
    case 1: return one_read_clusters<T, 1>();
    case 2: return one_read_clusters<T, 2>();
    case 3: return one_read_clusters<T, 3>();
    case 4: return one_read_clusters<T, 4>();
    default: return 0;
  }
}

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against the driver library); null where the driver lacks it.
decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p)
               : nullptr;
  }();
  return fn;
}

// H [P, V] as TMA boxes of one_read's panel: the panel's 64-byte row
// segment by kBoxRows rows, swizzled 64 bytes as slab_at reads them, rows
// past P read as zeros. L2 lines are promoted to 128 bytes: the
// neighbouring cluster reads the other half of the line at about the same
// time.
template <typename T>
bool one_read_map(CUtensorMap* map, const T* H, long long P, long long V) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_UINT32
                                   : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)V * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(one_read::kRowBytes / sizeof(T)),
                             (cuuint32_t)one_read::kBoxRows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<T*>(H), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NB>
cudaError_t launch_one_read(const T* H, const Args& a) {
  const int G = one_read_clusters<T, NB>();
  if (G <= 0) return cudaErrorInvalidConfiguration;
  CUtensorMap map;
  if (!one_read_map(&map, H, a.P, a.V)) return cudaErrorNotSupported;
  float* partial = reinterpret_cast<float*>(a.scratch);
  const int rows = (a.P + one_read::kCluster - 1) / one_read::kCluster;
  using K = one_read::Cfg<T, NB>;
  one_read::sweep_kernel<T, NB><<<G * one_read::kCluster, K::kThreads,
                                  sizeof(typename K::Smem), a.stream>>>(
      map, a.scale, a.w, a.f, a.aux, a.f_new, partial, a.P, a.V, rows, a.mode,
      a.has_pen, a.alpha, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(partial, G, NB, a.B, a.P, a.fitted);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_one_read(const void* H, const Args& a) {
  const T* h = static_cast<const T*>(H);
  if constexpr (one_read_max_b<T>() == 8) {
    switch (a.B) {
      case 5: return launch_one_read<T, 5>(h, a);
      case 6: return launch_one_read<T, 6>(h, a);
      case 7: return launch_one_read<T, 7>(h, a);
      case 8: return launch_one_read<T, 8>(h, a);
      default: break;
    }
  }
  switch (a.B) {
    case 1: return launch_one_read<T, 1>(h, a);
    case 2: return launch_one_read<T, 2>(h, a);
    case 3: return launch_one_read<T, 3>(h, a);
    default: return launch_one_read<T, 4>(h, a);
  }
}

// Bytes of one element of the storage type (0 fp32, 1 bf16, 2 int8 codes).
int element_bytes(int storage) { return storage == 0 ? 4 : storage == 1 ? 2 : 1; }

// The plan's preconditions (the Python plan_sweep's, plus alignment).
bool plan_ok(int plan, int storage, long long P, long long V, long long B,
             const void* H) {
  const bool h16 = (uintptr_t)H % 16 == 0;
  switch (plan) {
    case kTwoRead: {  // grid.y: the splits; grid.z: the batch tiles
      const TrShape s = tr_shape(P, V, B);
      return s.S <= 65535 && s.S2 <= 65535 && s.tiles <= 65535;
    }
    case kOneRead:  // V in whole panels (16, 32 or 64 columns)
      return B <= (storage == 0 ? one_read_max_b<float>() : one_read_max_b<int8_t>()) &&
             P <= (long long)one_read::kCluster * one_read::kMaxRows &&
             V % (one_read::kRowBytes / element_bytes(storage)) == 0 && h16;
    case kTensorCore:
      return (storage == 1 || storage == 2) && V % 16 == 0 && h16 && (B + 31) / 32 <= 65535;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// The pixel-sharded sweep, split at the all-reduce. A rank of a grid whose
// pixel axis is sharded holds a block of H's rows: its back projection is a
// partial sum that every rank of its voxel column must add before the
// update, so the sweep runs as two calls with the caller's all-reduce of
// [B, V_local] between them. On the cluster route (namespace split) each
// call is one kernel; on two_read's route, the shapes the cluster route's
// rule leaves out (B > 4, rows off 16 bytes, more than 8 splits of P):
//
//   sharded bp: two_read's bp pass (transpose_w_kernel, bp_kernel) and the
//     sum of its S splits in split order (sum_partials_kernel): the rank's
//     partial bp [B, V], unscaled (int8: the codes' sums; the scale is
//     applied after the reduction, in the finish, as the JAX closure
//     rounds it).
//   sharded finish: finish_kernel over the reduced bp (one split: the
//     scale, the update, f_new and the forward operand), then two_read's
//     forward pass over the rank's own rows (forward_kernel,
//     sum_partials_kernel): fitted [B, P_local].
//
// The block is read twice an iteration, once a call. The JAX panel scan
// reads it once and all-reduces every voxel panel's bp inside the read
// (sartsolver_tpu/ops/fused_sweep.py:270); one reduction an iteration keeps
// the collective count at one here. The splits and so every sum's order
// follow from (P, V) alone, as in two_read.
// ---------------------------------------------------------------------------

template <typename T, int MB, bool kVec>
cudaError_t launch_sharded_bp(const T* H, const float* w, float* bp, int P, int V, int B,
                              const TrShape& s, unsigned char* scratch, cudaStream_t stream) {
  using namespace two_read;
  using K = Bp<T, MB>;
  float* wT = reinterpret_cast<float*>(scratch);
  float* part = reinterpret_cast<float*>(scratch + s.wt_bytes);
  static const cudaError_t attr = cudaFuncSetAttribute(
      bp_kernel<T, MB, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid_t((unsigned)(s.Pp / 32), (unsigned)ceil_div(s.Ws, 32));
  transpose_w_kernel<<<grid_t, dim3(32, 8), 0, stream>>>(w, B, P, s.Pp, s.Ws, wT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_bp((unsigned)ceil_div(V, K::Cols), (unsigned)s.S, (unsigned)s.tiles);
  bp_kernel<T, MB, kVec><<<grid_bp, K::kThreads, K::kSmem, stream>>>(
      H, wT, part, P, V, B, s.Ws, s.rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, stream>>>(part, s.S, B, B, V, bp);
  return cudaGetLastError();
}

template <typename T, int MB, bool kVec>
cudaError_t launch_sharded_finish(const T* H, const Args& a, const float* bp, const TrShape& s) {
  using namespace two_read;
  constexpr int kFwdSmem = forward_smem<T, MB, kVec>();
  float* xs = reinterpret_cast<float*>(a.scratch);
  float* fwd = reinterpret_cast<float*>(a.scratch + s.xs_bytes);
  static const cudaError_t attr = cudaFuncSetAttribute(
      forward_kernel<T, MB, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (attr != cudaSuccess) return attr;
  const long long n = (long long)s.Bpad * s.Vp;
  const unsigned grid_f = (unsigned)std::min(ceil_div(n, 256), 8LL * kSMs);
  finish_kernel<T><<<grid_f, 256, 0, a.stream>>>(bp, 1, a.scale, a.f, a.aux, a.f_new, xs,
                                                      a.B, s.Bpad, a.V, s.Vp, a.mode,
                                                      a.has_pen, a.alpha, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_fwd((unsigned)ceil_div(a.P, kRows), (unsigned)s.S2, (unsigned)s.tiles);
  forward_kernel<T, MB, kVec><<<grid_fwd, Fwd<T, MB>::kThreads, kFwdSmem, a.stream>>>(
      H, xs, fwd, a.P, a.V, s.Vp, a.B, s.cols_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<264, 256, 0, a.stream>>>(fwd, s.S2, a.B, a.B, a.P, a.fitted);
  return cudaGetLastError();
}

// `finish` false: the bp call (w, bp_out), true: the finish call (a, bp_in)
template <typename T, bool kVec>
cudaError_t dispatch_sharded_mb(const T* H, bool finish, const float* w, float* bp_out,
                                const float* bp_in, const Args& a, const TrShape& s) {
#define SART_SHARDED_CASE(MBV)                                                          \
  case MBV:                                                                            \
    return finish ? launch_sharded_finish<T, MBV, kVec>(H, a, bp_in, s)                \
                  : launch_sharded_bp<T, MBV, kVec>(H, w, bp_out, a.P, a.V, a.B, s,    \
                                                    a.scratch, a.stream);
  switch (s.MB) {
    SART_SHARDED_CASE(1)
    SART_SHARDED_CASE(2)
    SART_SHARDED_CASE(4)
    SART_SHARDED_CASE(8)
    SART_SHARDED_CASE(16)
    default:
      return finish ? launch_sharded_finish<T, two_read::kMaxMB, kVec>(H, a, bp_in, s)
                    : launch_sharded_bp<T, two_read::kMaxMB, kVec>(H, w, bp_out, a.P, a.V,
                                                                   a.B, s, a.scratch, a.stream);
  }
#undef SART_SHARDED_CASE
}

template <typename T>
cudaError_t dispatch_sharded(const void* H, bool finish, const float* w, float* bp_out,
                             const float* bp_in, const Args& a) {
  const T* h = static_cast<const T*>(H);
  const TrShape s = tr_shape(a.P, a.V, a.B);
  const bool vec = (uintptr_t)H % 16 == 0 && ((long long)a.V * sizeof(T)) % 16 == 0;
  return vec ? dispatch_sharded_mb<T, true>(h, finish, w, bp_out, bp_in, a, s)
             : dispatch_sharded_mb<T, false>(h, finish, w, bp_out, bp_in, a, s);
}

long long sharded_scratch_bytes(bool finish, long long P, long long V, long long B) {
  const TrShape s = tr_shape(P, V, B);
  return finish ? s.xs_bytes + s.fwd_bytes : s.wt_bytes + s.bp_bytes;
}

// The cluster route's preconditions, by (P, V, B, storage)
// (ops/fused_sweep.py:split_route holds the same rule): B <= 4, H's rows
// 16-byte aligned (the tensor maps' row stride), two_read's splits of P no
// more than a cluster holds.
bool split_ok(int storage, long long P, long long V, long long B) {
  return B >= 1 && B <= split::kMaxB && (V * element_bytes(storage)) % 16 == 0 &&
         tr_shape(P, V, B).S <= split::kMaxCluster;
}

// The cluster route's geometry: two_read's splits (tr_shape) laid over
// clusters. bp: S splits of P (the cluster), strips of `lanes` 16-byte
// pieces of a row (the largest of 64, 32, 16 that puts about two CTAs on
// every SM, or 16); finish: S2 splits of V, row blocks of 64 rows, and the
// forward's partials [S2, B, P] where S2 > 1 (the scratch).
struct SplitShape {
  int S, lanes, strips, rows_per_split;
  int S2, cols_per_split, row_blocks;
  long long part_bytes;
};

SplitShape split_shape(int storage, long long P, long long V, long long B) {
  const TrShape tr = tr_shape(P, V, B);
  const int elem = element_bytes(storage);
  SplitShape s;
  s.S = tr.S;
  s.rows_per_split = tr.rows_per_split;
  s.lanes = 64;
  while (s.lanes > 16 &&
         ceil_div(V, (long long)s.lanes * 16 / elem) * s.S < split::kTargetCtas)
    s.lanes /= 2;
#ifdef SART_SPLIT_BP_LANES
  s.lanes = SART_SPLIT_BP_LANES;
#endif
  s.strips = (int)ceil_div(V, (long long)s.lanes * 16 / elem);
  s.S2 = tr.S2;
  s.cols_per_split = tr.cols_per_split;
  s.row_blocks = (int)ceil_div(P, split::kFwdRows);
  s.part_bytes = s.S2 > 1 ? align256((long long)s.S2 * B * P * 4) : 0;
  return s;
}

// H [P, V] of `elem`-byte elements as a 2D tensor of 32-bit words, read in
// boxes of box_words x box_rows (rows past P and words past a row as zeros)
bool split_map(CUtensorMap* map, const void* H, long long P, long long V, int elem,
               int box_words, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)(V * elem / 4), (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)(V * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_words, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(H), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// split_map's map, kept for the last few (H, shape, box) a thread asked for:
// a rank's sweeps read one block call after call
bool split_map_cached(CUtensorMap* map, const void* H, long long P, long long V, int elem,
                      int box_words, int box_rows) {
  struct Entry {
    const void* H;
    long long P, V;
    int elem, box_words, box_rows;
    CUtensorMap map;
  };
  thread_local Entry cache[4] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.H == H && e.H != nullptr && e.P == P && e.V == V && e.elem == elem &&
        e.box_words == box_words && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  if (!split_map(map, H, P, V, elem, box_words, box_rows)) return false;
  cache[next] = Entry{H, P, V, elem, box_words, box_rows, *map};
  next = (next + 1) % 4;
  return true;
}

// A kernel of the cluster route on grid `grid` in clusters of `cluster`
// CTAs along x
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), dim3 grid, int threads, int cluster,
                             int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of `cluster` CTAs of a kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 on failure.
template <typename... KArgs>
int active_clusters(void (*kernel)(KArgs...), int threads, int cluster, int smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(cluster * 64));
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &config) == cudaSuccess ? n : 0;
}

// The finish kernel's clusters the card holds at once, for clusters of 1, 2
// and 4 CTAs (its shared memory at the widest split), asked once an instance
template <typename T, int MB>
const int* finish_clusters() {
  static const std::array<int, 3> n = [] {
    const int smem = split::FwdShape<T, MB>::smem(two_read::kMaxSplitCols);
    std::array<int, 3> out;
    for (int i = 0; i < 3; ++i)
      out[i] = active_clusters(split::finish_kernel<T, MB>, split::kFwdThreads, 1 << i, smem);
    return out;
  }();
  return n.data();
}

template <typename T, int MB, int LANES>
cudaError_t launch_split_bp(const T* H, const float* w, float* bp, const Args& a,
                            const SplitShape& s) {
  using K = split::BpShape<T, LANES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split::bp_kernel<T, MB, LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::smem(split::kBpStagesAlone));
  if (attr != cudaSuccess) return attr;
  CUtensorMap map;
  if (!split_map_cached(&map, H, a.P, a.V, (int)sizeof(T), K::kStrip / 4, K::Kt))
    return cudaErrorNotSupported;
  // a CTA on each SM at most: the deeper ring
  const int stages = s.strips * s.S <= split::kSMs ? split::kBpStagesAlone
                                                   : split::kBpStagesShared;
  return launch_clustered(split::bp_kernel<T, MB, LANES>, dim3((unsigned)(s.strips * s.S)),
                          K::kThreads, s.S, K::smem(stages), a.stream, map, w, bp, a.P, a.V,
                          a.B, s.rows_per_split, stages);
}

// The finish: clusters of CL CTAs, CL in 1, 2, 4 (at most the row blocks)
// the one that keeps the most CTAs on the card at once; each split gets an
// equal share of the clusters the card holds (at least one, at most its
// groups of CL row blocks).
template <typename T, int MB>
cudaError_t launch_split_finish(const T* H, const Args& a, const float* bp, unsigned* counters,
                                const SplitShape& s) {
  using K = split::FwdShape<T, MB>;
  const int* held = finish_clusters<T, MB>();
  int ci = 0;
  for (int i = 1; i < 3 && (1 << i) <= s.row_blocks; ++i)
    if (held[i] * (1 << i) >= held[ci] * (1 << ci)) ci = i;
  if (held[ci] <= 0) return cudaErrorInvalidConfiguration;
  const int CL = 1 << ci;
  const int groups = (int)ceil_div(s.row_blocks, CL);
  const int nq = std::max(1, std::min(held[ci] / s.S2, groups));
  CUtensorMap map;
  if (!split_map_cached(&map, H, a.P, a.V, (int)sizeof(T), K::kRowBytes / 4,
                        split::kFwdRows))
    return cudaErrorNotSupported;
  float* part = reinterpret_cast<float*>(a.scratch);
  return launch_clustered(split::finish_kernel<T, MB>, dim3((unsigned)(nq * CL), (unsigned)s.S2),
                          split::kFwdThreads, CL, K::smem(s.cols_per_split), a.stream, map,
                          a.scale, a.f, bp, a.aux, a.f_new, a.fitted, part, counters, a.P, a.V,
                          a.B, s.cols_per_split, s.S2, a.mode, a.has_pen, a.alpha, a.eps);
}

template <typename T, int MB>
cudaError_t dispatch_split_mb(const T* H, bool finish, const float* w, float* bp_out,
                              const float* bp_in, unsigned* counters, const Args& a,
                              const SplitShape& s) {
  if (finish) return launch_split_finish<T, MB>(H, a, bp_in, counters, s);
  switch (s.lanes) {
    case 64: return launch_split_bp<T, MB, 64>(H, w, bp_out, a, s);
    case 32: return launch_split_bp<T, MB, 32>(H, w, bp_out, a, s);
    default: return launch_split_bp<T, MB, 16>(H, w, bp_out, a, s);
  }
}

template <typename T>
cudaError_t dispatch_split(const void* H, bool finish, const float* w, float* bp_out,
                           const float* bp_in, unsigned* counters, const Args& a) {
  const T* h = static_cast<const T*>(H);
  const int storage = sizeof(T) == 4 ? 0 : sizeof(T) == 2 ? 1 : 2;
  const SplitShape s = split_shape(storage, a.P, a.V, a.B);
  switch (a.B) {
    case 1: return dispatch_split_mb<T, 1>(h, finish, w, bp_out, bp_in, counters, a, s);
    case 2: return dispatch_split_mb<T, 2>(h, finish, w, bp_out, bp_in, counters, a, s);
    default: return dispatch_split_mb<T, 4>(h, finish, w, bp_out, bp_in, counters, a, s);
  }
}

}  // namespace

// The parts' entry points (see SART_PART): a storage's two_read sweep and
// pixel-sharded sweep, one_read and tensor_core, each defined in the part
// that holds their kernels; `args` is the caller's Args.
extern "C" {
int sart_part_two_read_f32(const void* H, const void* args);
int sart_part_two_read_bf16(const void* H, const void* args);
int sart_part_two_read_i8(const void* H, const void* args);
int sart_part_sharded_f32(const void* H, int finish, const float* w, float* bp_out,
                          const float* bp_in, const void* args);
int sart_part_sharded_bf16(const void* H, int finish, const float* w, float* bp_out,
                           const float* bp_in, const void* args);
int sart_part_sharded_i8(const void* H, int finish, const float* w, float* bp_out,
                         const float* bp_in, const void* args);
int sart_part_one_read(int storage, const void* H, const void* args);
int sart_part_tc(int storage, const void* H, const void* args);
int sart_part_split(int storage, int finish, const void* H, const float* w, float* bp_out,
                    const float* bp_in, unsigned* counters, const void* args);
}

#define SART_TWO_READ_PART(T, NAME)                                                   \
  extern "C" int sart_part_two_read_##NAME(const void* H, const void* args) {        \
    return (int)dispatch_two_read<T>(H, *static_cast<const Args*>(args));            \
  }                                                                                   \
  extern "C" int sart_part_sharded_##NAME(const void* H, int finish, const float* w,  \
                                          float* bp_out, const float* bp_in,          \
                                          const void* args) {                         \
    return (int)dispatch_sharded<T>(H, finish != 0, w, bp_out, bp_in,                 \
                                    *static_cast<const Args*>(args));                 \
  }
#if SART_HAS(1)
SART_TWO_READ_PART(float, f32)
#endif
#if SART_HAS(2)
SART_TWO_READ_PART(bf16_bits, bf16)
#endif
#if SART_HAS(3)
SART_TWO_READ_PART(int8_t, i8)
#endif
#undef SART_TWO_READ_PART

#if SART_HAS(4)
extern "C" int sart_part_one_read(int storage, const void* H, const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (storage == 0) return (int)dispatch_one_read<float>(H, a);
  if (storage == 1) return (int)dispatch_one_read<bf16_bits>(H, a);
  return (int)dispatch_one_read<int8_t>(H, a);
}

// Clusters the one_read plan runs for the storage type (0 fp32, 1 bf16,
// 2 int8 codes) at batch size B (1..8 fp32, 1..4 else) on the current card: persistent, at
// most 16, as many as the card holds at once; 0 where the card holds none.
extern "C" int sart_one_read_clusters(int storage, int B) {
  switch (storage) {
    case 0: return one_read_clusters_at<float>(B);
    case 1: return one_read_clusters_at<bf16_bits>(B);
    case 2: return one_read_clusters_at<int8_t>(B);
    default: return 0;
  }
}

#ifdef SART_ONE_READ_PHASES
// The measurement build's phase counters of the last one_read launch: per
// CTA (at most kMaxClusters * kCluster), the cycles of each of the kPhases
// phases, their sum and the loop's nanoseconds; returns the values a CTA has.
extern "C" int sart_one_read_phases(unsigned long long* out) {
  if (cudaMemcpyFromSymbol(out, one_read::g_phases, sizeof(one_read::g_phases)) != cudaSuccess)
    return -1;
  return one_read::kPhases + 2;
}
#endif
#endif  // SART_HAS(4)

#if SART_HAS(5)
extern "C" int sart_part_tc(int storage, const void* H, const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (storage == 1) return (int)dispatch_tc<bf16_bits>(H, a);
  return (int)dispatch_tc<int8_t>(H, a);
}
#endif

#if SART_HAS(6)
extern "C" int sart_part_split(int storage, int finish, const void* H, const float* w,
                               float* bp_out, const float* bp_in, unsigned* counters,
                               const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (storage == 0)
    return (int)dispatch_split<float>(H, finish != 0, w, bp_out, bp_in, counters, a);
  if (storage == 1)
    return (int)dispatch_split<bf16_bits>(H, finish != 0, w, bp_out, bp_in, counters, a);
  return (int)dispatch_split<int8_t>(H, finish != 0, w, bp_out, bp_in, counters, a);
}
#endif

#if SART_HAS(1)
// Bytes of scratch the plan needs at this shape; -1 for an unknown plan. The caller allocates it, 256-byte aligned.
extern "C" long long sart_fused_sweep_scratch_bytes(int plan, long long P,
                                                    long long V, long long B) {
  return scratch_bytes(plan, P, V, B);
}

// Returns a cudaError_t (0 on success). H is a device pointer to a
// contiguous [P, V] matrix of the storage type `storage` (0 fp32, 1 bf16,
// 2 int8 codes); scale is the codes' [V] fp32 scale, given for int8 and only
// for int8. Every other pointer is a device pointer to a contiguous fp32
// array; aux_rows[i] is 1 (broadcast) or B. alpha_lane (mode 1 only; null
// for the literal alpha) holds alpha_rows = 1 or B exponents of the
// scheduled log update. The caller allocates f_new
// [B, V], fitted [B, P] and `scratch_bytes` of scratch (see above). `plan`
// (0 two_read, 1 one_read, 2 tensor_core) is run as asked or refused with
// cudaErrorInvalidValue; no other plan is taken in its place.
extern "C" int sart_fused_sweep(const void* H, int storage, const float* scale,
                                const float* w, const float* f,
                                const float* aux0, const float* aux1,
                                const float* aux2, const long long* aux_rows,
                                int n_aux, float* f_new, float* fitted,
                                long long P, long long V, long long B,
                                int mode, float alpha, float eps,
                                const float* alpha_lane, long long alpha_rows, int plan,
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
  if (alpha_lane != nullptr && (mode != 1 || (alpha_rows != 1 && alpha_rows != B)))
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
  a.aux.alpha_lane = alpha_lane;
  a.aux.alpha_stride = (alpha_lane != nullptr && alpha_rows != 1) ? 1 : 0;
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
  switch (plan) {
    case kOneRead: return sart_part_one_read(storage, H, &a);
    case kTensorCore: return sart_part_tc(storage, H, &a);
    default: break;
  }
  if (storage == 0) return sart_part_two_read_f32(H, &a);
  if (storage == 1) return sart_part_two_read_bf16(H, &a);
  return sart_part_two_read_i8(H, &a);
}

// The pixel-sharded sweep's routes: two_read's kernels (three a call) or
// the cluster route (one a call), chosen by the caller
// (ops/fused_sweep.py:split_route) and refused, never replaced, where its
// preconditions fail.
enum SplitRoute { kSplitTwoRead = 0, kSplitCluster = 1 };

// Bytes of scratch the pixel-sharded sweep's call needs (finish 0: the bp
// call, 1: the finish call) on the route at this shape; -1 for an unknown
// route.
extern "C" long long sart_sharded_scratch_bytes(int finish, int route, long long P,
                                                long long V, long long B) {
  if (route == kSplitTwoRead) return sharded_scratch_bytes(finish != 0, P, V, B);
  if (route != kSplitCluster) return -1;
  return finish ? split_shape(0, P, V, B).part_bytes : 0;
}

// 1 where the cluster route takes this shape and storage (H's alignment
// aside), else 0: the rule ops/fused_sweep.py:split_route states.
extern "C" int sart_split_route_ok(int storage, long long P, long long V, long long B) {
  return storage >= 0 && storage <= 2 && P > 0 && V > 0 && P <= 0x7fffffffLL &&
         V <= 0x7fffffffLL && split_ok(storage, P, V, B);
}

// The counters the cluster route's finish needs at P rows (one a row block
// of 64), zero before the first call; each call leaves them zero.
extern "C" long long sart_split_counters(long long P) {
  return ceil_div(P, split::kFwdRows);
}

// The pixel-sharded sweep's first call: bp [B, V] = w [B, P] @ H [P, V] of
// the rank's block, unscaled (int8: the codes' sums), summed in two_read's
// split order. Returns a cudaError_t (0 on success); pointers as for
// sart_fused_sweep.
extern "C" int sart_sharded_bp(const void* H, int storage, const float* w, float* bp,
                               long long P, long long V, long long B, int route, void* scratch,
                               long long scratch_size, void* stream) {
  if (P <= 0 || V <= 0 || B <= 0 || P > 0x7fffffffLL || V > 0x7fffffffLL ||
      B > 0x7fffffffLL || storage < 0 || storage > 2)
    return (int)cudaErrorInvalidValue;
  if (!plan_ok(kTwoRead, storage, P, V, B, H)) return (int)cudaErrorInvalidValue;
  if (route == kSplitCluster && !(split_ok(storage, P, V, B) && (uintptr_t)H % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const long long need = sart_sharded_scratch_bytes(0, route, P, V, B);
  if (need < 0 || scratch_size < need || (need > 0 && (uintptr_t)scratch % 256 != 0))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.P = (int)P;
  a.V = (int)V;
  a.B = (int)B;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.stream = static_cast<cudaStream_t>(stream);
  if (route == kSplitCluster) return sart_part_split(storage, 0, H, w, bp, nullptr, nullptr, &a);
  if (storage == 0) return sart_part_sharded_f32(H, 0, w, bp, nullptr, &a);
  if (storage == 1) return sart_part_sharded_bf16(H, 0, w, bp, nullptr, &a);
  return sart_part_sharded_i8(H, 0, w, bp, nullptr, &a);
}

// The pixel-sharded sweep's second call, after the caller's all-reduce of
// bp over the pixel axis: bp rounded times the scale (int8), the update
// (aux, mode, alpha, eps, alpha_lane as for sart_fused_sweep), f_new [B, V]
// and fitted [B, P] of the rank's own rows.
extern "C" int sart_sharded_finish(const void* H, int storage, const float* scale,
                                   const float* f, const float* bp, const float* aux0,
                                   const float* aux1, const float* aux2,
                                   const long long* aux_rows, int n_aux, float* f_new,
                                   float* fitted, long long P, long long V, long long B,
                                   int mode, float alpha, float eps,
                                   const float* alpha_lane, long long alpha_rows, int route,
                                   unsigned* counters, long long n_counters, void* scratch,
                                   long long scratch_size, void* stream) {
  if (P <= 0 || V <= 0 || B <= 0 || P > 0x7fffffffLL || V > 0x7fffffffLL ||
      B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int want = mode == 0 ? 1 : 2;
  if ((mode != 0 && mode != 1) || (n_aux != want && n_aux != want + 1))
    return (int)cudaErrorInvalidValue;
  if (storage < 0 || storage > 2 || (storage == 2) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (alpha_lane != nullptr && (mode != 1 || (alpha_rows != 1 && alpha_rows != B)))
    return (int)cudaErrorInvalidValue;
  if (!plan_ok(kTwoRead, storage, P, V, B, H)) return (int)cudaErrorInvalidValue;
  if (route == kSplitCluster &&
      !(split_ok(storage, P, V, B) && (uintptr_t)H % 16 == 0 &&
        (split_shape(storage, P, V, B).S2 == 1 ||
         (counters != nullptr && n_counters >= sart_split_counters(P)))))
    return (int)cudaErrorInvalidValue;
  const long long need = sart_sharded_scratch_bytes(1, route, P, V, B);
  if (need < 0 || scratch_size < need || (need > 0 && (uintptr_t)scratch % 256 != 0))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.scale = scale;
  a.f = f;
  const float* ptrs[3] = {aux0, aux1, aux2};
  for (int i = 0; i < 3; ++i) {
    a.aux.ptr[i] = i < n_aux ? ptrs[i] : nullptr;
    a.aux.stride[i] = (i < n_aux && aux_rows[i] != 1) ? V : 0;
  }
  a.aux.alpha_lane = alpha_lane;
  a.aux.alpha_stride = (alpha_lane != nullptr && alpha_rows != 1) ? 1 : 0;
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
  if (route == kSplitCluster)
    return sart_part_split(storage, 1, H, nullptr, nullptr, bp, counters, &a);
  if (storage == 0) return sart_part_sharded_f32(H, 1, nullptr, nullptr, bp, &a);
  if (storage == 1) return sart_part_sharded_bf16(H, 1, nullptr, nullptr, bp, &a);
  return sart_part_sharded_i8(H, 1, nullptr, nullptr, bp, &a);
}
#endif  // SART_HAS(1)
