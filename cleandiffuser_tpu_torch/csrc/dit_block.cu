// Fused adaLN-Zero DiT block, forward, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cleandiffuser_tpu/ops/dit_block.py
// (`fused_dit_block`, body `_kernel`). Same math as `dit_block_reference`
// in cleandiffuser_tpu_torch/ops/dit_block.py:
//
//     h   = LN(x) * (1 + scale1) + shift1           LN: eps 1e-6, no affine
//     qkv = h @ wqkv + bqkv                         q scaled by hd^-0.5
//     x   = x + gate1 * (MHA(q, k, v) @ wo + bo)    softmax per trajectory
//     h2  = LN(x) * (1 + scale2) + shift2
//     out = x + gate2 * (gelu_tanh(h2 @ w1 + b1) @ w2 + b2)
//
// What bounds it on this card. One block is 12*D^2*H multiply-adds per
// trajectory on 12*D^2 weights (D=320: 4.9 MB in f32). The weights do not
// fit in one SM's 227 KB of shared memory but do fit in the 50 MB L2, so
// the kernel is bound by the f32 FMA rate and by L2 reads of the weights,
// not by device memory: every intermediate (LN output, qkv, scores, GELU
// activations) stays on chip, and device memory sees one read of x and mod
// and one write of out. Inside a plan, other work evicts the weights from
// L2 between launches; read cold, a line at a time, they cost a third more
// time (measured on an H100, PERF.md).
//
// Design. One thread block per trajectory (grid = B), so attention needs
// no cross-trajectory mask (the TPU kernel flattened several trajectories
// under a -1e30 block-diagonal mask). At entry the blocks together prefetch
// all the weights into L2; the products then read them from L2 through a
// ring of registers that keeps 3 steps of 4 weight rows in flight. The block keeps in dynamic shared memory:
//     sx   H x D        the residual stream x, updated in place
//     sh   H x D        LN/modulated h, then the attention output
//     sq   H x (3D+1)   qkv (odd row stride: conflict-free key reads),
//                       then one D-wide chunk of the MLP hidden layer
//     smod 6D           shift1 scale1 gate1 shift2 scale2 gate2
//     sp   (D/32) x H   one softmax row per warp
// (H=32, D=320: 213,888 bytes.) Matrix products are register-tiled FFMA
// with D threads: each owns 8 rows x 4 columns, so a product of width D or
// 3D takes exactly 1 or 3 passes over its columns. The MLP runs over 4
// chunks of D hidden units; each chunk's W2 product is added to x, scaled
// by gate2, in place. bf16, tensor cores (wgmma, or 3xTF32 for f32
// accuracy), TMA and filling more than B SMs are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// One thread per 4 columns of D in each of 4 row groups: blockDim = D, so a
// product with N = D (or 3D) covers its columns in exactly 1 (or 3) passes.
// 384 threads leave each the 168 registers the weight ring needs.
constexpr int kMaxThreads = 384;
// matrix-product thread tile: 8 rows x 4 columns
constexpr int kTM = 8;
constexpr int kTN = 4;
constexpr int kRowGroups = 4;
// weight rows in flight per thread: a ring of kStages groups of 4 rows
constexpr int kStages = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// out[r, :] = LN(x[r, :]) * (1 + scale) + shift, two-pass variance; one warp
// per row. x and out are shared, row stride D.
__device__ void layernorm_modulate(const float* x, float* out, const float* shift,
                                   const float* scale, int H, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < H; r += blockDim.x >> 5) {
    const float* xr = x + r * D;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + 1e-6f);
    float* orow = out + r * D;
    for (int c = lane; c < D; c += 32) orow[c] = (xr[c] - mu) * rstd * (1.0f + scale[c]) + shift[c];
  }
}

// For r < H, n < N: epi(r, n, sum_k A[r*K + k] * W[k*ldw + n]).
// A is shared (row stride K, K % (4 * kStages) == 0, 16-byte aligned); W is
// global, row-major with leading dimension ldw, 16-byte aligned rows,
// N % 4 == 0.
// The lanes of a warp share a row group (all of them when D/4 is a multiple
// of 32), so their A reads are broadcasts; their W reads are up to 512
// contiguous bytes of one row.
template <class Epi>
__device__ __forceinline__ void gemm_rows(const float* __restrict__ A,
                                          const float* __restrict__ W, int ldw,
                                          int H, int K, int N, Epi epi) {
  const int col_groups = blockDim.x / kRowGroups;
  const int tx = threadIdx.x % col_groups;
  const int ty = threadIdx.x / col_groups;
  for (int r0 = 0; r0 < H; r0 += kRowGroups * kTM) {
    const int rbase = r0 + ty * kTM;
    for (int n0 = 0; n0 < N; n0 += col_groups * kTN) {
      const int n = n0 + tx * kTN;
      if (n >= N) continue;
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
      const float* wn = W + n;
      const int steps = K / 4;
      // ring of kStages groups of 4 weight rows: the rows of step j+kStages-1
      // are requested before step j is computed
      float4 w[kStages][4];
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[s][kk] = __ldg(reinterpret_cast<const float4*>(wn + (size_t)(4 * s + kk) * ldw));
      for (int j0 = 0; j0 < steps; j0 += kStages) {
#pragma unroll
        for (int s = 0; s < kStages; ++s) {
          const int j = j0 + s;
          const int jl = min(j + kStages - 1, steps - 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            w[(s + kStages - 1) % kStages][kk] =
                __ldg(reinterpret_cast<const float4*>(wn + (size_t)(4 * jl + kk) * ldw));
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            // rows past H (H % 8 != 0) read row H-1 and are never stored
            const int r = min(rbase + i, H - 1);
            const float4 a = *reinterpret_cast<const float4*>(A + r * K + 4 * j);
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[i][0] = fmaf(av[kk], w[s][kk].x, acc[i][0]);
              acc[i][1] = fmaf(av[kk], w[s][kk].y, acc[i][1]);
              acc[i][2] = fmaf(av[kk], w[s][kk].z, acc[i][2]);
              acc[i][3] = fmaf(av[kk], w[s][kk].w, acc[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = rbase + i;
        if (r < H) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) epi(r, n + j, acc[i][j]);
        }
      }
    }
  }
}

// Ask for this thread block's 1/gridDim share of a weight matrix to be
// brought into L2. Together the blocks warm the whole matrix at kernel entry,
// so the products below read it from L2 and not, a line at a time, from
// device memory.
__device__ __forceinline__ void prefetch_l2_share(const float* p, size_t n) {
  const char* base = reinterpret_cast<const char*>(p);
  const size_t lines = (n * sizeof(float) + 127) / 128;
  for (size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x; l < lines;
       l += (size_t)gridDim.x * blockDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + l * 128));
}

size_t smem_floats(int H, int D) {
  return (size_t)2 * H * D + (size_t)H * (3 * D + 1) + (size_t)6 * D + (size_t)(D / 32) * H;
}

__global__ void __launch_bounds__(kMaxThreads)
dit_block_kernel(const float* __restrict__ x, const float* __restrict__ mod,
                 const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                 const float* __restrict__ wo, const float* __restrict__ bo,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ out, int H, int D, int n_heads, float q_scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = 3 * D + 1;
  float* sx = smem;
  float* sh = sx + H * D;
  float* sq = sh + H * D;
  float* smod = sq + H * ldq;
  float* sp = smod + 6 * D;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = D / n_heads;

  prefetch_l2_share(wqkv, (size_t)3 * D * D);
  prefetch_l2_share(wo, (size_t)D * D);
  prefetch_l2_share(w1, (size_t)4 * D * D);
  prefetch_l2_share(w2, (size_t)4 * D * D);

  const float4* xb = reinterpret_cast<const float4*>(x + (size_t)b * H * D);
  for (int i = threadIdx.x; i < H * D / 4; i += blockDim.x) reinterpret_cast<float4*>(sx)[i] = xb[i];
  for (int i = threadIdx.x; i < 6 * D; i += blockDim.x) smod[i] = mod[(size_t)b * 6 * D + i];
  __syncthreads();
  const float* shift1 = smod;
  const float* scale1 = smod + D;
  const float* gate1 = smod + 2 * D;
  const float* shift2 = smod + 3 * D;
  const float* scale2 = smod + 4 * D;
  const float* gate2 = smod + 5 * D;

  // ---- attention branch ----
  layernorm_modulate(sx, sh, shift1, scale1, H, D);
  __syncthreads();
  gemm_rows(sh, wqkv, 3 * D, H, D, 3 * D, [&](int r, int n, float acc) {
    const float v = acc + bqkv[n];
    sq[r * ldq + n] = n < D ? v * q_scale : v;
  });
  __syncthreads();

  // one warp per (head, query row): lanes own keys j for the scores, then
  // head dims d for P @ V; the output overwrites h (no longer needed)
  float* p = sp + warp * H;
  for (int task = warp; task < n_heads * H; task += blockDim.x >> 5) {
    const int h = task / H, i = task % H;
    const float* qi = sq + i * ldq + h * hd;
    const float* kh = sq + D + h * hd;
    const float* vh = sq + 2 * D + h * hd;
    float m = -INFINITY;
    for (int j = lane; j < H; j += 32) {
      const float* kj = kh + j * ldq;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(qi[d], kj[d], s);
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < H; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < H; j += 32) p[j] = p[j] / l;
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < H; ++j) o = fmaf(p[j], vh[j * ldq + d], o);
      sh[i * D + h * hd + d] = o;
    }
    __syncwarp();  // p is rewritten by this warp's next task
  }
  __syncthreads();

  gemm_rows(sh, wo, D, H, D, D, [&](int r, int n, float acc) {
    sx[r * D + n] += gate1[n] * (acc + bo[n]);
  });
  __syncthreads();

  // ---- mlp branch, over 4 chunks of D hidden units ----
  layernorm_modulate(sx, sh, shift2, scale2, H, D);
  __syncthreads();
  for (int c = 0; c < 4; ++c) {
    gemm_rows(sh, w1 + c * D, 4 * D, H, D, D, [&](int r, int n, float acc) {
      sq[r * D + n] = gelu_tanh(acc + b1[c * D + n]);
    });
    __syncthreads();
    gemm_rows(sq, w2 + (size_t)c * D * D, D, H, D, D, [&](int r, int n, float acc) {
      sx[r * D + n] += gate2[n] * (c == 0 ? acc + b2[n] : acc);
    });
    __syncthreads();
  }

  float4* ob = reinterpret_cast<float4*>(out + (size_t)b * H * D);
  for (int i = threadIdx.x; i < H * D / 4; i += blockDim.x) ob[i] = reinterpret_cast<const float4*>(sx)[i];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at horizon H and width D.
long long dit_block_smem_bytes(int H, int D) {
  return (long long)(smem_floats(H, D) * sizeof(float));
}

// Most dynamic shared memory a block may opt in to on `device`, or -1.
int device_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* dit_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: (B, H, D); mod: (B, 6D); weights (in, out) row-major; all f32,
// contiguous, 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int dit_block_forward_f32(const void* x, const void* mod, const void* wqkv, const void* bqkv,
                          const void* wo, const void* bo, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int B, int H, int D,
                          int n_heads, float q_scale, void* stream) {
  const size_t smem = smem_floats(H, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dit_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (D % 32 != 0 || D > kMaxThreads || D % (4 * kStages) != 0) return (int)cudaErrorInvalidValue;
  dit_block_kernel<<<B, D, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mod),
      static_cast<const float*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), H, D, n_heads, q_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
