// DANet dual-attention kernels for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ops/_build.py and ops/cuda_attention.py).
//
// Three TPU kernels of distributedpytorch_tpu/ops/pallas_attention.py are
// ported here.  Each keeps WHAT the TPU kernel computes, not its block
// schedule:
//
// * pam_forward   <- _flash_kernel (:50), launched by _flash_forward (:92).
// * cam_gram +
//   cam_softmax   <- _cam_energy_kernel (:167), launched by _cam_forward
//                    (:205).  Two launches together are the one TPU kernel
//                    (entry points dptpu_cam_gram, dptpu_cam_softmax).
// * cam_apply     <- _cam_apply_kernel (:195), launched by _cam_forward.
//
// Numerics shared by all of them: inputs are float32 or bfloat16, every
// sum is float32 (no fast-math exp), outputs take the TPU kernel's dtype.
// Every product runs on the tensor cores with mma.sync: float32 operands
// in 3xTF32, which keeps float32's accuracy (see the channel-branch note
// below), bfloat16 operands of the position kernel in one bf16 pass with
// float32 accumulation.  No kernel uses atomics: repeated launches on the
// same input give the same bits.
//
// What bounds them on an H100: at the serving shapes (N = 4096 tokens,
// Ck = 64, Cv = C = 512) all three do >= 1.3 GFLOP on <= 20 MB, so they are
// bound by operations, not by the 3.35 TB/s memory.  For float32 that
// means 67 TFLOP/s on the CUDA cores, or 495 / 3 = 165 TFLOP/s of float32
// work through 3xTF32 on the tensor cores; for bfloat16, 989 TFLOP/s.
// Each design note below says what its kernel does about it.
//
// Every entry point returns the launch's error code (0 = launched) and never
// synchronises; buffers are allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's key mask value

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as an astype
}

// ---------------------------------------------------------------------------
// Channel branch on the tensor cores, float32-exact (3xTF32).
//
// Both CAM products are matrix products with K >= 512, so they are bound by
// operations.  The CUDA cores cap float32 at 67 TFLOP/s; the tensor cores
// run TF32 (10-bit mantissa) at 495.  One TF32 pass would round X to 10 bits,
// and the unscaled Gram feeds `rowmax - E` into an exponential, so instead
// each float32 operand is split x = big + small (big = tf32(x) rounded to
// nearest, ties away; small = x - big, exact in float32, of which the tensor
// core reads the top 19 bits) and a·b is taken as
// small_a·big_b + big_a·small_b + big_a·big_b, the two small terms first,
// all with float32 accumulation: float32 accuracy at three TF32 products
// per product (165 TFLOP/s of float32 work).  A bfloat16 value is exact in
// TF32 (small = 0), so a bfloat16 Gram takes one pass and a bfloat16 apply
// two (x·small_attn, x·big_attn).
//
// The products are `mma.sync.m16n8k8.tf32` with fragments loaded by hand from
// shared memory.  That instruction reads any shared-memory layout, which
// the Gram needs: both of its operands are X read along N (MN-major), a
// layout `wgmma.tf32` cannot take from shared memory.  Tiles are staged by
// 16-byte `cp.async` into a ring of stages (one __syncthreads per stage, the
// next stages' copies in flight under the current stage's products).  A
// block has eight warps, two per scheduler; each warp owns a 64 x 32 output
// tile (4 x 4 accumulators of m16n8), so every loaded and split operand
// value feeds 4 products.  The split is done in registers right after the
// fragment loads, which are 8- or 16-byte vector loads laid out free of
// bank conflicts (each kernel's note says how).
//
// What bounds them now, measured on an H100: not the tensor cores.  With
// the products removed the kernels keep most of their time; the staging
// path (copies into shared memory, fragment loads, splits) is the limit,
// and it is what a later version moves to TMA and wgmma, which read the
// operands from shared memory without the registers.
// ---------------------------------------------------------------------------

// The big part of x: TF32 rounded to nearest with ties away from zero, the
// bits that cvt.rna.tf32.f32 gives for every finite input, in two integer
// operations (the cvt instruction runs at a fraction of the integer rate:
// with it, the kernels ran no faster with their tensor-core products
// removed).  The small part x - big is exact in float32 and goes to the
// tensor core as it is: an m16n8k8.tf32 operand is read from its top 19
// bits, so small is taken toward zero, within 2^-21 |x| (CUTLASS's 3xTF32
// does the same), at no instruction.  That also keeps NaN: for a NaN x the
// rounding may carry a NaN into a zero or mask it into an infinity, but
// x - big is a NaN whose top bits stay a NaN, so every product with it is
// NaN.  An infinite x gives a NaN small part (inf - inf), and an x within
// 2^-12 of the float32 limit a big part of inf and a small one of -inf, so
// such inputs come out as NaN, where a float32 product may give an
// infinity (or, for the map's x, a finite value).
__device__ __forceinline__ uint32_t tf32_big(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// big and small TF32 parts of v
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_big(v);
  small = __float_as_uint(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// True for float32 operands, which take the big/small split; bfloat16 ones
// are exact in TF32.
template <typename T>
constexpr bool kSplit = sizeof(T) == 4;

constexpr int kMi = 4;  // m16 tiles per warp (64 rows)
constexpr int kNi = 4;  // n8 tiles per warp (32 columns)

// acc += A·B for one 8-deep step of a warp's 64 x 32 tile, given the raw
// fragment values of m16n8k8.tf32 (g = lane / 4, t = lane % 4):
// a[mi] = A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4) of m16 tile mi and
// b[ni] = B(t, g), B(t+4, g) of n8 tile ni; acc[mi][ni] holds D(g, 2t),
// D(g, 2t+1), D(g+8, 2t), D(g+8, 2t+1).  Which rows, columns and depths of
// the block's tile those letters stand for is the caller's choice.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void warp_mma_k8(float (&acc)[kMi][kNi][4],
                                            const float (&a)[kMi][4],
                                            const float (&b)[kNi][2]) {
  uint32_t a_big[kMi][4], a_small[kMi][4], b_big[kNi][2], b_small[kNi][2];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kSplitA) {
        split_tf32(a[mi][e], a_big[mi][e], a_small[mi][e]);
      } else {
        a_big[mi][e] = __float_as_uint(a[mi][e]);
      }
    }
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (kSplitB) {
        split_tf32(b[ni][e], b_big[ni][e], b_small[ni][e]);
      } else {
        b_big[ni][e] = __float_as_uint(b[ni][e]);
      }
    }
  if constexpr (kSplitA) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) mma_tf32(acc[mi][ni], a_small[mi], b_big[ni]);
  }
  if constexpr (kSplitB) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) mma_tf32(acc[mi][ni], a_big[mi], b_small[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) mma_tf32(acc[mi][ni], a_big[mi], b_big[ni]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[kMi][kNi][4]) {
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Copies rows [r0, r0 + R) x columns [c0, c0 + W) of a row-major matrix with
// leading dimension ld into shared memory (row stride lds elements), 16-byte
// chunk q of row r at chunk swizzle(r, q), each thread taking every
// kThreads-th chunk; entries at rows >= r_end or
// columns >= c_end are zero.  `vec`: every row starts 16-byte aligned and
// c_end is a multiple of a chunk, so whole chunks go by cp.async
// (zero-filled past the edge); otherwise element by element through
// registers (an odd C, or a bfloat16 C of 100).
template <typename T, int R, int W, int kThreads, typename Swizzle>
__device__ __forceinline__ void load_tile(T* dst, int lds, Swizzle swizzle,
                                          const T* src, int ld, int r0,
                                          int r_end, int c0, int c_end,
                                          bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = R * (W / kVec);
  constexpr int kRowChunks = W / kVec;
  static_assert(W % kVec == 0, "tile rows must split into whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kChunks % kThreads != 0 && i >= kChunks) break;
    const int r = i / kRowChunks, q = i % kRowChunks;
    const int gr = r0 + r, gc = c0 + q * kVec;
    T* d = dst + r * lds + swizzle(r, q) * kVec;
    const T* s = src + static_cast<size_t>(gr) * ld + gc;
    if (vec) {
      const bool in = gr < r_end && gc < c_end;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = (gr < r_end && gc + e < c_end) ? s[e] : from_f32<T>(0.f);
    }
  }
}

// n consecutive values of a staged row as float (n * sizeof(T) = 8 or 16
// bytes, one vector load).
template <typename T, int n>
__device__ __forceinline__ void load_vec(float* v, const T* p) {
  if constexpr (sizeof(T) == 4 && n == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else if constexpr (sizeof(T) == 4 && n == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  } else {  // bfloat16: widen by a shift
    static_assert(sizeof(T) == 2 && (n == 8 || n == 4 || n == 2), "vector width");
    uint32_t w[n / 2];
    if constexpr (n == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (n == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int e = 0; e < n / 2; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// CAM energy, first launch: Gram partials E_s = X_sᵀX_s over slices of N.
//
// Replaces the accumulation half of _cam_energy_kernel, which kept the
// whole C x C sum (1 MiB at C = 512) in VMEM across a sequential sweep over
// N.  Here a block owns a 128 x 128 output tile and one slice of N.  E is
// symmetric, so only the tiles on and above the diagonal are computed (10
// of 16 at C = 512) and each is written twice, as itself and mirrored.
// The kernel is bound by each SM's rate of products, so what sets its time
// is the most tokens any SM works through; N is split to even that out
// (gram_splits in ops/cuda_attention.py: 13 slices at B = 1, 130 blocks;
// 3 at B = 8, 240 blocks, two to most SMs) and each slice writes its
// partial (B, S, C, C).  The softmax launch sums the partials in slice
// order, so the result is the same every run without atomics.  A
// thread-block cluster of the slices that summed them in distributed shared
// memory instead (no partials in device memory) was built and measured
// slower at B = 1 on an H100, likely because a cluster of 8 must sit in one
// GPC and its blocks were not spread one to an SM.  With one slice the
// partial is E itself.  Rows past N are zero-filled, which is what zero
// padding did on the TPU.
//
// Eight warps, 2 x 4 of 64 x 32; 16 tokens per stage, four stages.  Both
// operands are rows of X, [k][channel] in shared memory (MN-major).  A
// thread reads 8 consecutive channels (A) and 4 (B) of rows t and t + 4
// with 16-byte loads (8-byte for a bfloat16 B), so the tile's rows and
// columns are permuted: warp row 8g + 2mi + h is row g + 8h of m16 tile mi
// and warp column 4g + ni is column g of n8 tile ni; each thread ends up
// owning an 8 x 8 block of E.  The 16-byte chunks of each staged row are
// XOR-swizzled by the row index so that a quarter-warp's loads fall on 8
// distinct bank groups.
// ---------------------------------------------------------------------------

constexpr int kGramTile = 128;
constexpr int kGramDepth = 16;
constexpr int kGramStages = 4;
constexpr int kGramThreads = 256;
constexpr int kGramMaxSplits = 16;

// Chunk q of staged row k goes to q ^ swizzle(k).  A quarter-warp reads
// chunks {2g, 2g + 1} (float32 A), g (bfloat16 A, float32 B) or g / 2
// (bfloat16 B) of rows t = 0..3 for g in {2p, 2p + 1}.
template <typename T>
__device__ __forceinline__ int gram_swizzle_a(int k) {
  if constexpr (sizeof(T) == 4)
    return (k & 1) | ((k & 2) << 1);
  else
    return (k & 3) << 1;
}

__device__ __forceinline__ int gram_swizzle_b(int k) { return (k & 3) << 1; }

template <typename T>
constexpr size_t kGramSmemBytes = sizeof(T) * 2 * kGramStages * kGramDepth * kGramTile;

template <typename T>
__global__ void __launch_bounds__(kGramThreads)
cam_gram_kernel(const T* __restrict__ x, float* __restrict__ partial,
                int n_tok, int c, int splits, int chunk, int vec) {
  extern __shared__ float4 smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStage = kGramDepth * kGramTile;
  T* sa = reinterpret_cast<T*>(smem_raw);  // [stage][k][channel i0 + ...]
  T* sb = sa + kGramStages * kStage;       // [stage][k][channel j0 + ...]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // blockIdx.x enumerates the tiles on and above the diagonal, row by row
  int ti = 0, tj = blockIdx.x;
  for (int row_tiles = (c + kGramTile - 1) / kGramTile; tj >= row_tiles - ti;) tj -= row_tiles - ti++;
  tj += ti;
  const int i0 = ti * kGramTile, j0 = tj * kGramTile;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int n_begin = split * chunk;
  const int n_end = min(n_tok, n_begin + chunk);
  const int steps = n_end > n_begin ? (n_end - n_begin + kGramDepth - 1) / kGramDepth : 0;
  const T* xb = x + static_cast<size_t>(b) * n_tok * c;

  const auto swizzle_a = [](int r, int q) { return q ^ gram_swizzle_a<T>(r); };
  const auto swizzle_b = [](int r, int q) { return q ^ gram_swizzle_b(r); };
  auto load = [&](int stage, int step) {
    const int n0 = n_begin + step * kGramDepth;
    load_tile<T, kGramDepth, kGramTile, kGramThreads>(
        sa + stage * kStage, kGramTile, swizzle_a, xb, c, n0, n_end, i0, c, vec);
    load_tile<T, kGramDepth, kGramTile, kGramThreads>(
        sb + stage * kStage, kGramTile, swizzle_b, xb, c, n0, n_end, j0, c, vec);
  };

  float acc[kMi][kNi][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kGramStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  const int col_a = wm * 64 + 8 * g;  // this thread's 8 A channels
  const int col_b = wn * 32 + 4 * g;  // and 4 B channels
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kGramStages - 2>();
    __syncthreads();  // stage `step` landed; stage step-1 is free again
    const int next = step + kGramStages - 1;
    if (next < steps) load(next % kGramStages, next);
    cp_async_commit();
    const T* a_st = sa + (step % kGramStages) * kStage;
    const T* b_st = sb + (step % kGramStages) * kStage;
#pragma unroll
    for (int k8 = 0; k8 < kGramDepth; k8 += 8) {
      float va[2][8], vb[2][4];  // rows k8 + t and k8 + t + 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k8 + t + 4 * h;
        const T* ra = a_st + k * kGramTile;
        const T* rb = b_st + k * kGramTile;
        if constexpr (kVec == 4) {
          load_vec<T, 4>(va[h], ra + ((col_a / 4) ^ gram_swizzle_a<T>(k)) * 4);
          load_vec<T, 4>(va[h] + 4, ra + ((col_a / 4 + 1) ^ gram_swizzle_a<T>(k)) * 4);
        } else {
          load_vec<T, 8>(va[h], ra + ((col_a / 8) ^ gram_swizzle_a<T>(k)) * 8);
        }
        load_vec<T, 4>(vb[h], rb + ((col_b / kVec) ^ gram_swizzle_b(k)) * kVec + col_b % kVec);
      }
      float fa[kMi][4], fb[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        fa[mi][0] = va[0][2 * mi];
        fa[mi][1] = va[0][2 * mi + 1];
        fa[mi][2] = va[1][2 * mi];
        fa[mi][3] = va[1][2 * mi + 1];
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        fb[ni][0] = vb[0][ni];
        fb[ni][1] = vb[1][ni];
      }
      warp_mma_k8<kSplit<T>, kSplit<T>>(acc, fa, fb);
    }
  }
  cp_async_wait<0>();

  // This thread's rows 8g + 2mi + h and columns 8t + e of the warp tile,
  // e = 0..7: acc[mi][e % 4][2h + e / 4].  Written as 8-float runs: along
  // the row for E's tile, along the column for its mirror image below the
  // diagonal (the same sums, so E stays exactly symmetric).
  float* pb = partial + (static_cast<size_t>(b) * splits + split) * c * c;
  const bool vec_out = c % 4 == 0;
  auto store8 = [&](int row, int col, const float (&v)[8]) {
    if (row >= c) return;
    float* o = pb + static_cast<size_t>(row) * c + col;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (vec_out && col + 4 * q + 3 < c) {
        *reinterpret_cast<float4*>(o + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
        for (int e = 0; e < 4 && col + 4 * q + e < c; ++e) o[4 * q + e] = v[4 * q + e];
      }
    }
  };
  const int row0 = i0 + wm * 64 + 8 * g, col0 = j0 + wn * 32 + 8 * t;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = acc[mi][e % 4][2 * h + e / 4];
      store8(row0 + 2 * mi + h, col0, v);
    }
  if (ti != tj) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v[8];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[2 * mi + h] = acc[mi][e % 4][2 * h + e / 4];
      store8(col0 + e, row0, v);
    }
  }
}

// ---------------------------------------------------------------------------
// CAM energy, second launch: sum the partials, then the row softmax.
//
// The finalize half of _cam_energy_kernel: E = the S partials summed in
// slice order, E' = rowmax(E) - E (DANet attends to the LEAST similar
// channels), then a max-subtracted softmax with IEEE expf, all float32.
// Memory bound (S·C² floats read, C² written).  One block of two warps per
// row, each thread 4 columns at a time with all S partial loads of them in
// flight together; block reductions in a fixed order.  With one slice the partial
// may be the output itself: each row is read whole before it is written.
// ---------------------------------------------------------------------------

constexpr int kSoftmaxThreads = 64;

__device__ float block_reduce(float v, bool is_max, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch is free again, and row[] is written
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kSoftmaxThreads / 32; ++w)
    v = is_max ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

__global__ void __launch_bounds__(kSoftmaxThreads)
cam_softmax_kernel(const float* partial, float* attn, int c, int splits) {
  extern __shared__ float4 row_raw[];
  float* row = reinterpret_cast<float*>(row_raw);  // [c]
  __shared__ float scratch[kSoftmaxThreads / 32];
  const size_t cc = static_cast<size_t>(c) * c;
  const int b = blockIdx.x / c, i = blockIdx.x % c;
  const float* p = partial + static_cast<size_t>(b) * splits * cc + static_cast<size_t>(i) * c;

  float local = kNegInf;
  if (c % 4 == 0) {  // 16-byte loads
    for (int j = 4 * threadIdx.x; j < c; j += 4 * kSoftmaxThreads) {
      float4 part[kGramMaxSplits];
#pragma unroll
      for (int s = 0; s < kGramMaxSplits; ++s)
        if (s < splits) part[s] = *reinterpret_cast<const float4*>(p + s * cc + j);
      float4 e = part[0];
#pragma unroll
      for (int s = 1; s < kGramMaxSplits; ++s)
        if (s < splits) {
          e.x += part[s].x;
          e.y += part[s].y;
          e.z += part[s].z;
          e.w += part[s].w;
        }
      *reinterpret_cast<float4*>(row + j) = e;
      local = fmaxf(local, fmaxf(fmaxf(e.x, e.y), fmaxf(e.z, e.w)));
    }
  } else {
    for (int j = threadIdx.x; j < c; j += kSoftmaxThreads) {
      float e = p[j];
      for (int s = 1; s < splits; ++s) e += p[s * cc + j];
      row[j] = e;
      local = fmaxf(local, e);
    }
  }
  const float row_max = block_reduce(local, true, scratch);
  local = kNegInf;
  for (int j = threadIdx.x; j < c; j += kSoftmaxThreads) {
    row[j] = row_max - row[j];
    local = fmaxf(local, row[j]);
  }
  const float m = block_reduce(local, true, scratch);
  local = 0.f;
  for (int j = threadIdx.x; j < c; j += kSoftmaxThreads) {
    row[j] = expf(row[j] - m);
    local += row[j];
  }
  const float sum = block_reduce(local, false, scratch);
  float* o = attn + static_cast<size_t>(blockIdx.x) * c;
  for (int j = threadIdx.x; j < c; j += kSoftmaxThreads) o[j] = row[j] / sum;
}

// ---------------------------------------------------------------------------
// CAM apply: out[n][i] = sum_j float(X[n][j]) * attn[i][j], cast to X's type.
//
// Replaces _cam_apply_kernel, which kept the attention map resident in VMEM
// and streamed row blocks of X through the MXU.  Here it is a tiled
// (B·N x C)·(C x C)ᵀ product in which both operands are K-major: X rows are
// contiguous in j and so are attn rows.  A block owns 128 tokens x 128
// output channels (128 blocks at B = 1, N = 4096, C = 512), eight warps of
// 64 x 32, 16 channels j per stage, four stages.  Within each 8-deep step a
// thread takes depths 2t and 2t + 1 (one 8-byte load per row) for the
// fragment's t and t + 4, the same permutation for both operands; rows are
// padded to 24 words so that those loads are free of bank conflicts.  X is
// upcast to float32 as the TPU kernel does; a float32 X is split like the
// map, a bfloat16 X is exact.
// ---------------------------------------------------------------------------

constexpr int kApplyM = 128;
constexpr int kApplyN = 128;
constexpr int kApplyDepth = 16;
constexpr int kApplyStages = 4;
constexpr int kApplyThreads = 256;
constexpr int kApplyLdBytes = 96;  // a staged row's stride: 16 words + 8

template <typename T>
constexpr int kApplyLd = kApplyLdBytes / static_cast<int>(sizeof(T));

constexpr size_t kApplySmemBytes =
    static_cast<size_t>(kApplyStages) * (kApplyM + kApplyN) * kApplyLdBytes;

template <typename T>
__device__ __forceinline__ void store_pair(T* ob, int row, int col, int n_tok,
                                           int c, float v0, float v1) {
  if (row >= n_tok || col >= c) return;
  T* o = ob + static_cast<size_t>(row) * c + col;
  if (c % 2 == 0) {  // col is even, so the pair is aligned and in bounds
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = from_f32<T>(v0);
    if (col + 1 < c) o[1] = from_f32<T>(v1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
cam_apply_kernel(const float* __restrict__ attn, const T* __restrict__ x,
                 T* __restrict__ out, int n_tok, int c, int vec_x, int vec_a) {
  extern __shared__ float4 smem_raw[];
  constexpr int LDX = kApplyLd<T>, LDA = kApplyLd<float>;
  constexpr int kStageX = kApplyM * LDX, kStageA = kApplyN * LDA;
  T* sx = reinterpret_cast<T*>(smem_raw);                             // [stage][n][j]
  float* sm = reinterpret_cast<float*>(sx + kApplyStages * kStageX);  // [stage][i][j]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * kApplyM;  // output rows (tokens)
  const int i0 = blockIdx.y * kApplyN;  // output columns (channels)
  const size_t b = blockIdx.z;
  const T* xb = x + b * n_tok * c;
  const float* ab = attn + b * c * c;
  T* ob = out + b * n_tok * c;
  const int steps = (c + kApplyDepth - 1) / kApplyDepth;

  const auto plain = [](int, int q) { return q; };
  auto load = [&](int stage, int step) {
    const int k0 = step * kApplyDepth;
    load_tile<T, kApplyM, kApplyDepth, kApplyThreads>(
        sx + stage * kStageX, LDX, plain, xb, c, n0, n_tok, k0, c, vec_x);
    load_tile<float, kApplyN, kApplyDepth, kApplyThreads>(
        sm + stage * kStageA, LDA, plain, ab, c, i0, c, k0, c, vec_a);
  };

  float acc[kMi][kNi][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kApplyStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kApplyStages - 2>();
    __syncthreads();
    const int next = step + kApplyStages - 1;
    if (next < steps) load(next % kApplyStages, next);
    cp_async_commit();
    const T* xs = sx + (step % kApplyStages) * kStageX + (wm * 64 + g) * LDX + 2 * t;
    const float* ms = sm + (step % kApplyStages) * kStageA + (wn * 32 + g) * LDA + 2 * t;
#pragma unroll
    for (int k8 = 0; k8 < kApplyDepth; k8 += 8) {
      float fa[kMi][4], fb[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        float lo[2], hi[2];  // rows g and g + 8, depths 2t and 2t + 1
        load_vec<T, 2>(lo, xs + (mi * 16) * LDX + k8);
        load_vec<T, 2>(hi, xs + (mi * 16 + 8) * LDX + k8);
        fa[mi][0] = lo[0];
        fa[mi][1] = hi[0];
        fa[mi][2] = lo[1];
        fa[mi][3] = hi[1];
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) load_vec<float, 2>(fb[ni], ms + (ni * 8) * LDA + k8);
      warp_mma_k8<kSplit<T>, true>(acc, fa, fb);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      const int row = n0 + wm * 64 + mi * 16 + g;
      const int col = i0 + wn * 32 + ni * 8 + 2 * t;
      store_pair(ob, row, col, n_tok, c, acc[mi][ni][0], acc[mi][ni][1]);
      store_pair(ob, row + 8, col, n_tok, c, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---------------------------------------------------------------------------
// Position attention: out = softmax(Q Kᵀ [* scale]) V over all N keys, on the
// tensor cores.
//
// Replaces _flash_kernel.  On the TPU the key sweep was a sequential grid
// axis carrying (max, sum, acc) in VMEM from step to step; here one block
// owns 64 queries and a 256-wide slice of Cv and sweeps every key itself, 32
// keys a stage, so nothing carries between blocks and nothing is summed
// across them (no atomics: repeated launches give the same bits).
//
// What bounds it: operations.  At N = 4096, Ck = 64, Cv = 512 the two
// products are 19.3 GFLOP on 18 MB, 89% of it in P·V.  Both run as
// mma.sync: float32 inputs in 3xTF32 (the channel branch's split, below:
// small·big + big·small + big·big, small terms first, float32 accumulation,
// float32 accuracy, NaN kept), bfloat16 inputs as one
// m16n8k16.bf16 pass with float32 accumulation, exact for bfloat16 operands.
//
// Tiling.  Eight warps, 4 row groups of 16 queries x 2 groups of 128 value
// channels.  A warp's accumulator is 16 x 128 float32, 64 registers a
// thread, and the card fills: 128 blocks at B = 1 on 132 SMs, one a SM
// (184 KB of shared memory at Ck = 64), so no split of the key sweep is
// needed.
// The two warps of a row group need the same p.  For float32 they share
// the work: each scores 16 of a stage's 32 keys (3xTF32, its exps, its half
// of the row max and sum) and the pair trade their halves' max, sum and p
// through shared memory, with two 64-thread barriers per stage; both add
// the halves in key order, so they hold the same bits.  A row's scores are
// then computed twice, by the 2 blocks of its Cv = 512 (grid.y): +11%
// operations over the minimum at Ck = 64, Cv = 512 (the score product is
// 11% of it) and 2x the exponentials.  For bfloat16, whose products are
// cheap beside that exchange, each warp scores all 32 keys (the shared
// version ran slower on an H100): 4x the scores, +33% of its operations.
//
// Keeping P in registers.  The m16n8 score accumulator of 8 keys holds, in
// thread (g, t) = (lane / 4, lane % 4), the scores of rows g, g + 8 at keys
// 2t, 2t + 1.  For the float32 P·V (m16n8k8, whose A fragment wants depths
// t and t + 4), the depth order inside each 8-key step is permuted so that
// depth t is key 2t and depth t + 4 is key 2t + 1: the accumulator is the
// A fragment as it stands, and the thread reads V's rows 2t and 2t + 1; the
// partner's half arrives in the same layout, each lane reading the slots
// its twin lane wrote.  For bfloat16 (m16n8k16) two score accumulators
// side by side are the A fragment in natural order, rounded to bfloat16
// (p.astype(v.dtype), as on the TPU; the running sum takes the unrounded
// p).  Row max and row sum are quad shuffles over the 4 lanes that hold a
// row.
//
// Fragment loads, free of bank conflicts.  float32: a thread takes 4
// consecutive depths (two 8-deep steps) of a Q or K row in one 16-byte load,
// the same permutation for both operands; rows are padded to 4 mod 8
// chunks.  For V the warp's 128 channels are permuted in groups of 32 so
// that a thread loads 4 consecutive channels (one 16-byte load feeds 4 n8
// tiles); V rows are padded to 260 floats, so the rows 2t of a quarter-warp
// fall on distinct chunks; the output permutation puts 8 consecutive
// channels of a row in each thread, written as two 16-byte stores.
// bfloat16: 8-byte Q and K loads (rows padded to 4 mod 16 eight-byte
// pairs), V through ldmatrix.trans (rows padded to 528 bytes).
//
// Splitting once.  Q is the same for the whole sweep: it is staged once,
// split once into big and small planes in shared memory (bfloat16: loaded
// once into registers).  p is split once, in the registers that hold it.
// K and V are split in registers as their fragments are loaded, by every
// warp that reads them (a K row by the 4 warps that score its half, V by
// the 4 of its channel group), 3 integer/float operations per value beside
// the 1.5 tensor-core products each split value feeds.  Split planes of the
// staged K and V tiles would double their shared memory, double the
// fragment loads and add a barrier per stage; the channel kernels' version
// of them ran no faster on an H100.
//
// Staging.  K and V tiles go by 16-byte cp.async (zero-filled past N and
// Cv) into a ring of three stages (two at Ck = 128, where three do not
// fit), one __syncthreads per stage, the next stages in flight under the
// current one's products.  Rows that are not 16-byte aligned (C = 67, a
// bfloat16 C of 100) go element by element.  Q and K depths past Ck
// (padded to 16, 32, 64 or 128) are zero-filled.  Keys >= N score -1e30
// (after the scale), so they get zero weight, as on the TPU; queries >= N
// and channels >= Cv are computed on zeros and never written.
//
// What bounds it now, measured on an H100: the issue rate of mma.sync,
// about a quarter of the 3xTF32 bound at B = 1 and 8.  Of the variants
// tried in development, one TF32 pass in place of three (which fails the
// float32 bound) saved by far the most time, sharing the scores between
// the warp pair (kept) the next most; the K/V splits and the
// exponentials, which share the warps' issue slots, come after.  The way
// on is wgmma for P·V, the larger product: asynchronous, the only way to
// the full tensor-core rate, P from registers and V from shared memory,
// which for wgmma.tf32 means V staged transposed (K-major) and split once
// there.
// ---------------------------------------------------------------------------

constexpr int kPamBq = 64;       // queries per block
constexpr int kPamBk = 32;       // keys per stage
constexpr int kPamCv = 256;      // value channels per block
constexpr int kPamWarpCv = 128;  // value channels per warp
constexpr int kPamThreads = 256;
constexpr int kPamMaxCk = 128;   // Q/K depth, padded to 16, 32, 64 or 128
// floats a lane passes to its partner warp each stage: its half's row max
// (2), row sum (2) and p (8)
constexpr int kPamSlots = 12;

// float32: the two warps of a row group share each stage's scores, 16 keys
// each, and pass each other p through shared memory; bfloat16, whose
// products are cheap beside that exchange: each warp scores all 32 keys
template <typename T>
constexpr bool kPamShare = kSplit<T>;

// A ring of three stages, two at Ck = 128, where a third does not fit.
template <int kCk>
constexpr int kPamStages = kCk > 64 ? 2 : 3;

// Row stride (elements) of a staged Q or K tile of depth w: float32 rows
// of 4 mod 8 sixteen-byte chunks, bfloat16 rows of 4 mod 16 eight-byte pairs.
template <typename T, int w>
constexpr int kPamLd = sizeof(T) == 4 ? (w / 4 + (12 - w / 4 % 8) % 8) * 4
                                      : (w / 4 + (20 - w / 4 % 16) % 16) * 4;

template <typename T>
constexpr int kPamLdv = sizeof(T) == 4 ? kPamCv + 4 : kPamCv + 8;

template <typename T, int kCk>
constexpr size_t pam_smem_bytes() {
  return sizeof(float) * kPamThreads * (kPamShare<T> ? kPamSlots : 0) +
         sizeof(T) * ((kSplit<T> ? 2 : 1) * kPamBq * kPamLd<T, kCk> +
                      kPamStages<kCk> * kPamBk * (kPamLd<T, kCk> + kPamLdv<T>));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a·b in 3xTF32 from split parts, the two small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// barrier `id` over the 64 threads of two warps; orders their shared memory
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

template <typename T, int kCk>
__global__ void __launch_bounds__(kPamThreads, 1)
pam_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int n_tok,
                   int ck, int cv, float scale, int has_scale, int vec_qk,
                   int vec_v) {
  constexpr bool kF32 = kSplit<T>;
  constexpr bool kShare = kPamShare<T>;
  constexpr int kOwn = kShare ? 2 : 4;  // n8 score tiles a warp computes
  constexpr int kStages = kPamStages<kCk>;
  constexpr int LDQ = kPamLd<T, kCk>, LDV = kPamLdv<T>;
  constexpr int kStageK = kPamBk * LDQ, kStageV = kPamBk * LDV;
  constexpr int kTiles = kPamWarpCv / 8;  // n8 tiles of a warp's accumulator
  extern __shared__ float4 smem_raw[];
  float* xch = reinterpret_cast<float*>(smem_raw);  // [warp][slot][lane], shared
  // [query][depth]: Q, then its big part; float32: Q's small part
  T* qs = reinterpret_cast<T*>(xch + kPamThreads * (kShare ? kPamSlots : 0));
  T* qsmall = qs + kPamBq * LDQ;
  T* ks = qsmall + (kF32 ? kPamBq * LDQ : 0);  // [stage][key][depth]
  T* vs = ks + kStages * kStageK;              // [stage][key][channel]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp & 3) * 16;  // the warp's rows in the block
  const int half = warp >> 2;        // its channels and, shared, its keys
  const int col0 = half * kPamWarpCv;
  const int pair_barrier = 1 + (warp & 3);  // shared with the partner warp, warp ^ 4
  float* mine = xch + warp * kPamSlots * 32 + lane;
  const float* theirs = xch + (warp ^ 4) * kPamSlots * 32 + lane;
  const int q0 = blockIdx.x * kPamBq, c0 = blockIdx.y * kPamCv;
  const size_t b = blockIdx.z;
  const T* kb = k + b * n_tok * ck;
  const T* vb = v + b * n_tok * cv;
  T* ob = out + b * n_tok * cv;
  const int steps = (n_tok + kPamBk - 1) / kPamBk;

  const auto plain = [](int, int c) { return c; };
  auto load = [&](int stage, int step) {
    const int k0 = step * kPamBk;
    load_tile<T, kPamBk, kCk, kPamThreads>(ks + stage * kStageK, LDQ, plain, kb, ck,
                                           k0, n_tok, 0, ck, vec_qk);
    load_tile<T, kPamBk, kPamCv, kPamThreads>(vs + stage * kStageV, LDV, plain, vb,
                                              cv, k0, n_tok, c0, cv, vec_v);
  };
  load_tile<T, kPamBq, kCk, kPamThreads>(qs, LDQ, plain, q + b * n_tok * ck, ck, q0,
                                         n_tok, 0, ck, vec_qk);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();

  uint32_t qf[kF32 ? 1 : kCk / 16][4];  // bfloat16: Q's A fragments
  if constexpr (kF32) {
    for (int e = threadIdx.x; e < kPamBq * kCk; e += kPamThreads) {
      const int i = (e / kCk) * LDQ + e % kCk;
      uint32_t big, small;
      split_tf32(qs[i], big, small);
      qs[i] = __uint_as_float(big);
      qsmall[i] = __uint_as_float(small);
    }
  } else {
    // depths 4t..4t+3 of each 16 stand for the fragment's 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int kk = 0; kk < kCk / 16; ++kk) {
      const T* p = qs + (row0 + g) * LDQ + 16 * kk + 4 * t;
      const uint2 lo = *reinterpret_cast<const uint2*>(p);
      const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * LDQ);
      qf[kk][0] = lo.x, qf[kk][1] = hi.x, qf[kk][2] = lo.y, qf[kk][3] = hi.y;
    }
  }

  float acc[kTiles][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int ni = 0; ni < kTiles; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed (and Q's split); stage step-1 is free
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    const int kown = kShare ? 16 * half : 0;  // the first key this warp scores
    const T* kst = ks + (step % kStages) * kStageK + kown * LDQ;
    const T* vst = vs + (step % kStages) * kStageV;

    // scores of rows g, g + 8 at keys kown + 8ni + 2t + {0, 1}
    float s[kOwn][4];
#pragma unroll
    for (int ni = 0; ni < kOwn; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
    if constexpr (kF32) {
#pragma unroll
      for (int kc = 0; kc < kCk / 16; ++kc) {
        float qb[2][4], qsm[2][4], kr[kOwn][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (row0 + g + 8 * h) * LDQ + 16 * kc + 4 * t;
          load_vec<float, 4>(qb[h], qs + at);
          load_vec<float, 4>(qsm[h], qsmall + at);
        }
#pragma unroll
        for (int ni = 0; ni < kOwn; ++ni)
          load_vec<float, 4>(kr[ni], kst + (8 * ni + g) * LDQ + 16 * kc + 4 * t);
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // depths 4t + 2u, 4t + 2u + 1 are t, t + 4
          const uint32_t a_big[4] = {
              __float_as_uint(qb[0][2 * u]), __float_as_uint(qb[1][2 * u]),
              __float_as_uint(qb[0][2 * u + 1]), __float_as_uint(qb[1][2 * u + 1])};
          const uint32_t a_small[4] = {
              __float_as_uint(qsm[0][2 * u]), __float_as_uint(qsm[1][2 * u]),
              __float_as_uint(qsm[0][2 * u + 1]), __float_as_uint(qsm[1][2 * u + 1])};
#pragma unroll
          for (int ni = 0; ni < kOwn; ++ni) {
            uint32_t b_big[2], b_small[2];
            split_tf32(kr[ni][2 * u], b_big[0], b_small[0]);
            split_tf32(kr[ni][2 * u + 1], b_big[1], b_small[1]);
            mma_3xtf32(s[ni], a_big, a_small, b_big, b_small);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kCk / 16; ++kk)
#pragma unroll
        for (int ni = 0; ni < kOwn; ++ni) {
          const uint2 kr = *reinterpret_cast<const uint2*>(
              kst + (8 * ni + g) * LDQ + 16 * kk + 4 * t);
          const uint32_t bf[2] = {kr.x, kr.y};
          mma_bf16(s[ni], qf[kk], bf);
        }
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1); shared, the row
    // max and sum of the stage combine this warp's half with the partner's,
    // added in key order, so that both warps hold the same bits
    const int k0 = step * kPamBk + kown;
    const bool ragged = k0 + 8 * kOwn > n_tok;
    float mx[2] = {kNegInf, kNegInf}, m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < kOwn; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = has_scale ? s[ni][e] * scale : s[ni][e];
        if (ragged && k0 + 8 * ni + 2 * t + (e & 1) >= n_tok) val = kNegInf;
        s[ni][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if constexpr (kShare) mine[h * 32] = mx[h];
    }
    if constexpr (kShare) pair_sync(pair_barrier);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], kShare ? fmaxf(mx[h], theirs[h * 32]) : mx[h]);
      corr[h] = expf(m[h] - m_new[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int ni = 0; ni < kOwn; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = expf(s[ni][e] - m_new[e >> 1]);
        sum[e >> 1] += s[ni][e];
        if constexpr (kShare) mine[(4 + 4 * ni + e) * 32] = s[ni][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      if constexpr (kShare) mine[(2 + h) * 32] = sum[h];
    }
    // p of the stage's 32 keys (shared: tiles 0, 1 from the half-0 warp,
    // 2, 3 from the half-1 warp)
    float p[4][4];
    if constexpr (kShare) {
      pair_sync(pair_barrier);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = theirs[(4 + 4 * ni + e) * 32];
          p[ni][e] = half ? other : s[ni][e];
          p[2 + ni][e] = half ? s[ni][e] : other;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float other = theirs[(2 + h) * 32];
        sum[h] = half ? other + sum[h] : sum[h] + other;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = s[j % kOwn][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int ni = 0; ni < kTiles; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] *= corr[e >> 1];

    // acc += P·V over the stage's 32 keys
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // keys 8j + 2t (depth t), 8j + 2t + 1 (t + 4)
        uint32_t p_big[4], p_small[4];
        split_tf32(p[j][0], p_big[0], p_small[0]);
        split_tf32(p[j][2], p_big[1], p_small[1]);
        split_tf32(p[j][1], p_big[2], p_small[2]);
        split_tf32(p[j][3], p_big[3], p_small[3]);
        // n8 tile 4c + i, column g is channel 32c + 4g + i of the warp's 128
        const float* vr = vst + (8 * j + 2 * t) * LDV + col0 + 4 * g;
#pragma unroll
        for (int c = 0; c < kTiles / 4; ++c) {
          float v0[4], v1[4];
          load_vec<float, 4>(v0, vr + 32 * c);
          load_vec<float, 4>(v1, vr + LDV + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t b_big[2], b_small[2];
            split_tf32(v0[i], b_big[0], b_small[0]);
            split_tf32(v1[i], b_big[1], b_small[1]);
            mma_3xtf32(acc[4 * c + i], p_big, p_small, b_big, b_small);
          }
        }
      }
    } else {
      // ldmatrix.trans: lanes 8r..8r+7 address the rows of matrix r = (keys
      // +8 (r & 1), channels +8 (r >> 1))
      const T* vr = vst + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDV + col0 +
                    (lane >> 4) * 8;
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // keys 16u .. 16u + 15
        const uint32_t a[4] = {pack_bf16(p[2 * u][0], p[2 * u][1]),
                               pack_bf16(p[2 * u][2], p[2 * u][3]),
                               pack_bf16(p[2 * u + 1][0], p[2 * u + 1][1]),
                               pack_bf16(p[2 * u + 1][2], p[2 * u + 1][3])};
#pragma unroll
        for (int np = 0; np < kTiles / 2; ++np) {
          uint32_t d[4];
          ldmatrix_x4_trans(d, vr + 16 * u * LDV + 16 * np);
          const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
          mma_bf16(acc[2 * np], a, b0);
          mma_bf16(acc[2 * np + 1], a, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    if (row >= n_tok) continue;
    const float den = fmaxf(l[h], 1e-30f);
    if constexpr (kF32) {
      // this thread's channels 32c + 8t .. 32c + 8t + 7 of the warp's 128
#pragma unroll
      for (int c = 0; c < kTiles / 4; ++c) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i] = acc[4 * c + i][2 * h] / den;
          o[4 + i] = acc[4 * c + i][2 * h + 1] / den;
        }
        const int col = c0 + col0 + 32 * c + 8 * t;
        float* dst = ob + static_cast<size_t>(row) * cv + col;
        if (cv % 4 == 0 && col + 8 <= cv) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          for (int e = 0; e < 8 && col + e < cv; ++e) dst[e] = o[e];
        }
      }
    } else {
#pragma unroll
      for (int ni = 0; ni < kTiles; ++ni)
        store_pair(ob, row, c0 + col0 + 8 * ni + 2 * t, n_tok, cv,
                   acc[ni][2 * h] / den, acc[ni][2 * h + 1] / den);
    }
  }
}

template <typename T>
int launch_gram(const void* x, float* partial, int b, int n_tok, int c,
                int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kGramMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kGramSmemBytes<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      cam_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // tokens per slice, whole stages
  const int chunk = ((n_tok + splits - 1) / splits + kGramDepth - 1) / kGramDepth * kGramDepth;
  const int tiles = (c + kGramTile - 1) / kGramTile;
  const int vec = aligned16(x) && (c * sizeof(T)) % 16 == 0;
  cam_gram_kernel<T><<<dim3(tiles * (tiles + 1) / 2, 1, b * splits), kGramThreads, smem,
                        stream>>>(
      static_cast<const T*>(x), partial, n_tok, c, splits, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const float* attn, const void* x, void* out, int b, int n_tok,
                 int c, cudaStream_t stream) {
  const size_t smem = kApplySmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      cam_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tok + kApplyM - 1) / kApplyM, (c + kApplyN - 1) / kApplyN, b);
  const int vec_x = aligned16(x) && (c * sizeof(T)) % 16 == 0;
  const int vec_a = aligned16(attn) && c % 4 == 0;
  cam_apply_kernel<T><<<grid, kApplyThreads, smem, stream>>>(
      attn, static_cast<const T*>(x), static_cast<T*>(out), n_tok, c, vec_x,
      vec_a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCk>
int launch_pam_ck(const void* q, const void* k, const void* v, void* out, int b,
                  int n_tok, int ck, int cv, float scale, int has_scale,
                  cudaStream_t stream) {
  constexpr size_t smem = pam_smem_bytes<T, kCk>();
  const cudaError_t err = cudaFuncSetAttribute(
      pam_forward_kernel<T, kCk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tok + kPamBq - 1) / kPamBq, (cv + kPamCv - 1) / kPamCv, b);
  const int vec_qk = aligned16(q) && aligned16(k) && (ck * sizeof(T)) % 16 == 0;
  const int vec_v = aligned16(v) && (cv * sizeof(T)) % 16 == 0;
  pam_forward_kernel<T, kCk><<<grid, kPamThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_tok, ck, cv, scale,
      has_scale, vec_qk, vec_v);
  return static_cast<int>(cudaGetLastError());
}

// Q and K depth padded with zeros to the next of 16, 32, 64, 128
template <typename T>
int launch_pam(const void* q, const void* k, const void* v, void* out, int b,
               int n_tok, int ck, int cv, float scale, int has_scale,
               cudaStream_t stream) {
  if (ck < 1 || ck > kPamMaxCk) return static_cast<int>(cudaErrorInvalidValue);
  if (ck <= 16)
    return launch_pam_ck<T, 16>(q, k, v, out, b, n_tok, ck, cv, scale, has_scale, stream);
  if (ck <= 32)
    return launch_pam_ck<T, 32>(q, k, v, out, b, n_tok, ck, cv, scale, has_scale, stream);
  if (ck <= 64)
    return launch_pam_ck<T, 64>(q, k, v, out, b, n_tok, ck, cv, scale, has_scale, stream);
  return launch_pam_ck<T, 128>(q, k, v, out, b, n_tok, ck, cv, scale, has_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the element type of every non-float
// argument).  The map `attn` and the Gram partials are always float32.
extern "C" {

int dptpu_pam_forward(const void* q, const void* k, const void* v, void* out,
                      int b, int n_tok, int ck, int cv, float scale,
                      int has_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pam<float>(q, k, v, out, b, n_tok, ck, cv, scale, has_scale, s);
  return launch_pam<__nv_bfloat16>(q, k, v, out, b, n_tok, ck, cv, scale,
                                   has_scale, s);
}

int dptpu_cam_gram(const void* x, float* partial, int b, int n_tok, int c,
                   int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gram<float>(x, partial, b, n_tok, c, splits, s);
  return launch_gram<__nv_bfloat16>(x, partial, b, n_tok, c, splits, s);
}

int dptpu_cam_softmax(const float* partial, float* attn, int rows, int c,
                      int splits, void* stream) {
  if (splits < 1 || splits > kGramMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cam_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cam_softmax_kernel<<<rows, kSoftmaxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      partial, attn, c, splits);
  return static_cast<int>(cudaGetLastError());
}

int dptpu_cam_apply(const float* attn, const void* x, void* out, int b,
                    int n_tok, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<float>(attn, x, out, b, n_tok, c, s);
  return launch_apply<__nv_bfloat16>(attn, x, out, b, n_tok, c, s);
}

}  // extern "C"
