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
//                    (:205).  Two launches together are the one TPU kernel.
// * cam_apply     <- _cam_apply_kernel (:195), launched by _cam_forward.
//
// Numerics shared by all of them: inputs are float32 or bfloat16, every
// product and sum is taken in float32 on the CUDA cores with IEEE fma (no
// TF32, no fast-math exp), outputs take the TPU kernel's dtype.
//
// What bounds them on an H100: at the serving shapes (N = 4096 tokens,
// Ck = 64, Cv = C = 512) all three do >= 2 GFLOP on <= 20 MB, so they are
// bound by float32 operations (67 TFLOP/s), not by the 3.35 TB/s memory.
// A CUDA-core kernel then lives or dies by how many shared-memory loads it
// spends per fma; each design note below says what it does about that.
// None of them uses wgmma or TMA yet: those belong to the kernels' later,
// faster versions.
//
// Every entry point returns cudaGetLastError() (0 = launched) and never
// synchronises; buffers are allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's key mask value

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as an astype
}

// ---------------------------------------------------------------------------
// Position attention: out = softmax(Q Kᵀ [* scale]) V over all N keys.
//
// Replaces _flash_kernel.  On the TPU the key sweep was a sequential grid
// axis carrying (max, sum, acc) in VMEM from step to step; here one block
// owns 64 queries and a 256-wide slice of Cv and loops over every 64-key
// block itself, so nothing carries between blocks.
//
// Cv = 512 is the trap: a 64 x 512 float32 accumulator (128 KB) does not fit
// one block's registers.  The block's Cv slice is 256 wide (gridDim.y =
// Cv / 256), which keeps the accumulator at 64 registers a thread; the
// scores are recomputed once per slice, 11% more operations than the
// minimum at Ck = 64, Cv = 512.  Each thread owns a 4 x 4 tile of the
// scores and a 4 x 16 tile of the accumulator on the same 4 query rows, so
// the online-softmax rescale stays in registers and the row reductions are
// 16-lane shuffles.  The products read 8 floats per 16 fma (scores) and
// 20 per 64 fma (P·V) from shared memory.  Keys >= N score -1e30, so they
// get zero weight, as on the TPU.
// ---------------------------------------------------------------------------

constexpr int kPamBq = 64;        // queries per block
constexpr int kPamBk = 64;        // keys per step
constexpr int kPamCv = 256;       // value channels per block
constexpr int kPamLd = kPamBq + 4;  // padded row of the transposed tiles
constexpr int kPamThreads = 256;

size_t pam_smem_bytes(int ck) {
  return sizeof(float) *
         (static_cast<size_t>(2 * ck) * kPamLd + kPamBk * kPamLd + kPamBk * kPamCv);
}

template <typename T>
__global__ void __launch_bounds__(kPamThreads, 1)
pam_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int n_tok,
                   int ck, int cv, float scale, int has_scale) {
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [ck][kPamLd]  Qᵀ
  float* ks = qs + ck * kPamLd;                     // [ck][kPamLd]  Kᵀ
  float* ps = ks + ck * kPamLd;                     // [kPamBk][kPamLd] Pᵀ
  float* vs = ps + kPamBk * kPamLd;                 // [kPamBk][kPamCv]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns / value columns
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kPamBq;
  const int c0 = blockIdx.y * kPamCv;
  const size_t b = blockIdx.z;
  const T* qb = q + b * n_tok * ck;
  const T* kb = k + b * n_tok * ck;
  const T* vb = v + b * n_tok * cv;
  T* ob = out + b * n_tok * cv;

  for (int e = tid; e < kPamBq * ck; e += kPamThreads) {
    const int i = e / ck, c = e - i * ck;
    const int n = q0 + i;
    qs[c * kPamLd + i] = n < n_tok ? to_f32(qb[static_cast<size_t>(n) * ck + c]) : 0.f;
  }

  float m[4], l[4], acc[4][16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_tok; k0 += kPamBk) {
    __syncthreads();  // the previous step is done with ks, vs and ps
    for (int e = tid; e < kPamBk * ck; e += kPamThreads) {
      const int j = e / ck, c = e - j * ck;
      const int n = k0 + j;
      ks[c * kPamLd + j] = n < n_tok ? to_f32(kb[static_cast<size_t>(n) * ck + c]) : 0.f;
    }
    for (int e = tid; e < kPamBk * kPamCv; e += kPamThreads) {
      const int j = e / kPamCv, c = e - j * kPamCv;
      const int n = k0 + j, cc = c0 + c;
      vs[e] = (n < n_tok && cc < cv) ? to_f32(vb[static_cast<size_t>(n) * cv + cc]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int c = 0; c < ck; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[c * kPamLd + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&ks[c * kPamLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(av[r], bv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float val = has_scale ? s[r][j] * scale : s[r][j];
        if (k0 + tx * 4 + j >= n_tok) val = kNegInf;
        s[r][j] = val;
        row_max = fmaxf(row_max, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[r], row_max);
      const float corr = expf(m[r] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        row_sum += p;
        // The TPU kernel feeds p.astype(v.dtype) to the P·V product.
        ps[(tx * 4 + j) * kPamLd + ty * 4 + r] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[r] = l[r] * corr + row_sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kPamBk; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[j * kPamLd + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j * kPamCv + g * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][g * 4 + c] = fmaf(pv[r], vv[c], acc[r][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = q0 + ty * 4 + r;
    if (n >= n_tok) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + g * 64 + tx * 4 + c;
        if (col < cv)
          ob[static_cast<size_t>(n) * cv + col] = from_f32<T>(acc[r][g * 4 + c] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// Shared 128 x 128 float32 tile product for the channel branch.
//
// 256 threads, each owning an 8 x 8 accumulator tile (rows ty*4+{0..3} and
// 64+ty*4+{0..3}, columns likewise from tx), fed from 8-deep slices of the
// two operands in shared memory: 16 floats loaded per 64 fma.  The caller
// fills `as[kk][m]` (row operand) and `bs[kk][n]` (column operand).
// ---------------------------------------------------------------------------

constexpr int kTile = 128;
constexpr int kDepth = 8;
constexpr int kGemmThreads = 256;

__device__ __forceinline__ void tile_fma(float (*as)[kTile],
                                         float (*bs)[kTile],
                                         float acc[8][8], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

// ---------------------------------------------------------------------------
// CAM energy, first launch: partial Gram matrices XᵀX.
//
// Replaces the accumulation half of _cam_energy_kernel.  The TPU kept the
// whole C x C sum (1 MiB at C = 512) in VMEM across a sequential sweep over
// N; that is more than one SM's shared memory, so here each block owns one
// 128 x 128 output tile and one contiguous slice of N, and writes its
// partial sum to partial[b][split].  Splitting N puts >= 128 blocks on the
// card even at B = 1 (16 tiles x 8 splits), and summing the partials in a
// fixed order in the row pass keeps the result deterministic (no atomics).
// Rows past N are simply not read, which is what zero padding did.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
cam_gram_kernel(const T* __restrict__ x, float* __restrict__ partial,
                int n_tok, int c, int splits) {
  __shared__ __align__(16) float as[kDepth][kTile];
  __shared__ __align__(16) float bs[kDepth][kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * kTile;  // output columns
  const int i0 = blockIdx.y * kTile;  // output rows
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int chunk = (n_tok + splits - 1) / splits;
  const int n_begin = split * chunk;
  const int n_end = min(n_tok, n_begin + chunk);
  const T* xb = x + static_cast<size_t>(b) * n_tok * c;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int kk = tid >> 5;         // row of the slice this thread loads
  const int m = (tid & 31) * 4;    // first of its 4 columns
  for (int n0 = n_begin; n0 < n_end; n0 += kDepth) {
    const int n = n0 + kk;
    const T* row = xb + static_cast<size_t>(n) * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = i0 + m + e, cj = j0 + m + e;
      as[kk][m + e] = (n < n_end && ci < c) ? to_f32(row[ci]) : 0.f;
      bs[kk][m + e] = (n < n_end && cj < c) ? to_f32(row[cj]) : 0.f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }

  float* pb = partial + (static_cast<size_t>(b) * splits + split) * c * c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + tile_row(ty, i);
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + tile_row(tx, j);
      if (col < c) pb[static_cast<size_t>(row) * c + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// CAM energy, second launch: one block per row of the C x C map.
//
// The finalize half of _cam_energy_kernel: E = sum of the partials (fixed
// order), E' = rowmax(E) - E (DANet attends to the LEAST similar
// channels), then a max-subtracted softmax.  Memory bound and tiny
// (C² floats read splits times, written once).
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

__device__ float block_reduce(float v, bool is_max, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch is free again
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kRowThreads / 32; ++w)
    v = is_max ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

__global__ void __launch_bounds__(kRowThreads)
cam_softmax_kernel(const float* __restrict__ partial, float* __restrict__ attn,
                   int c, int splits) {
  extern __shared__ float row[];  // [c]
  __shared__ float scratch[kRowThreads / 32];
  const int i = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t cc = static_cast<size_t>(c) * c;

  float local = kNegInf;
  for (int j = threadIdx.x; j < c; j += kRowThreads) {
    const float* p = partial + b * splits * cc + static_cast<size_t>(i) * c + j;
    float e = 0.f;
    for (int s = 0; s < splits; ++s) e += p[s * cc];
    row[j] = e;
    local = fmaxf(local, e);
  }
  const float row_max = block_reduce(local, true, scratch);

  local = kNegInf;
  for (int j = threadIdx.x; j < c; j += kRowThreads) {
    const float e = row_max - row[j];
    row[j] = e;
    local = fmaxf(local, e);
  }
  const float m = block_reduce(local, true, scratch);

  local = 0.f;
  for (int j = threadIdx.x; j < c; j += kRowThreads) {
    const float p = expf(row[j] - m);
    row[j] = p;
    local += p;
  }
  const float sum = block_reduce(local, false, scratch);

  float* out = attn + b * cc + static_cast<size_t>(i) * c;
  for (int j = threadIdx.x; j < c; j += kRowThreads) out[j] = row[j] / sum;
}

// ---------------------------------------------------------------------------
// CAM apply: out[n][i] = sum_j float(X[n][j]) * attn[i][j], cast to X's type.
//
// Replaces _cam_apply_kernel, which kept the attention map resident in VMEM
// and streamed row blocks of X through the MXU.  Here it is a tiled
// (B·N x C)·(C x C)ᵀ product: each block owns 128 tokens x 128 output
// channels (128 blocks at B = 1, N = 4096, C = 512) and walks the shared
// dimension 8 deep, with X upcast to float32 as the TPU kernel does.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
cam_apply_kernel(const float* __restrict__ attn, const T* __restrict__ x,
                 T* __restrict__ out, int n_tok, int c) {
  __shared__ __align__(16) float as[kDepth][kTile];  // X slice, [j][n]
  __shared__ __align__(16) float bs[kDepth][kTile];  // attn slice, [j][i]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTile;  // output rows (tokens)
  const int i0 = blockIdx.y * kTile;  // output columns (channels)
  const size_t b = blockIdx.z;
  const T* xb = x + b * n_tok * c;
  const float* ab = attn + b * c * c;
  T* ob = out + b * n_tok * c;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int m = tid >> 1;          // tile row this thread loads
  const int kq = (tid & 1) * 4;    // first of its 4 shared-dim entries
  const int n = n0 + m, ir = i0 + m;
  for (int j0 = 0; j0 < c; j0 += kDepth) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + kq + e;
      as[kq + e][m] = (n < n_tok && j < c) ? to_f32(xb[static_cast<size_t>(n) * c + j]) : 0.f;
      bs[kq + e][m] = (ir < c && j < c) ? ab[static_cast<size_t>(ir) * c + j] : 0.f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + tile_row(ty, i);
    if (row >= n_tok) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = i0 + tile_row(tx, j);
      if (col < c) ob[static_cast<size_t>(row) * c + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_pam(const void* q, const void* k, const void* v, void* out, int b,
               int n_tok, int ck, int cv, float scale, int has_scale,
               cudaStream_t stream) {
  const size_t smem = pam_smem_bytes(ck);
  cudaError_t err = cudaFuncSetAttribute(
      pam_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tok + kPamBq - 1) / kPamBq, (cv + kPamCv - 1) / kPamCv, b);
  pam_forward_kernel<T><<<grid, kPamThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_tok, ck, cv, scale,
      has_scale);
  return static_cast<int>(cudaGetLastError());
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

int dptpu_cam_energy(const void* x, float* partial, float* attn, int b,
                     int n_tok, int c, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + kTile - 1) / kTile, (c + kTile - 1) / kTile, b * splits);
  if (dtype == 0)
    cam_gram_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const float*>(x), partial, n_tok, c, splits);
  else
    cam_gram_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, n_tok, c, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * static_cast<size_t>(c);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cam_softmax_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cam_softmax_kernel<<<dim3(c, b), kRowThreads, smem, s>>>(partial, attn, c,
                                                           splits);
  return static_cast<int>(cudaGetLastError());
}

int dptpu_cam_apply(const float* attn, const void* x, void* out, int b,
                    int n_tok, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tok + kTile - 1) / kTile, (c + kTile - 1) / kTile, b);
  if (dtype == 0)
    cam_apply_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        attn, static_cast<const float*>(x), static_cast<float*>(out), n_tok, c);
  else
    cam_apply_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        attn, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n_tok, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
