// Fused FiLM Conv1d residual block, forward, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cleandiffuser_tpu/ops/film_resblock.py
// (`film_resblock`, body `_kernel`). Same math as `film_resblock_reference`
// in cleandiffuser_tpu_torch/ops/film_resblock.py, channels-last:
//
//     h   = mish(GN(conv1(x) + b1))          conv: K taps, SAME padding (K odd)
//     h   = h + emb  (film_scale: emb[:C] * h + emb[C:])
//     h   = mish(GN(conv2(h) + b2))
//     out = h + (x @ wskip + bskip, or x when there is no skip conv)
//
// GN: GroupNorm per sample over (H, C/G), two-pass statistics, then the
// per-channel affine; eps is an argument.
//
// What bounds it on this card. In the Janner U-Net a block is small per
// sample (H = 4..32 rows, C = 23..512 channels) and the batch is large
// (B = 3200 candidate trajectories): 2*K*H*Cin*Cout + 2*K*H*Cout^2
// multiply-adds per sample on up to 1.3 MB of weights per conv. The
// activations of one sample are a few KB, so every intermediate (conv
// outputs, GN statistics, the FiLM'd hidden layer) can stay in shared
// memory: device memory sees one read of x and emb and one write of out.
// What is left is the f32 FMA rate and the reads of the weights, which stay
// in L2 (50 MB) across the thread blocks; each block re-reads them, so a
// block takes several samples (S*H >= 16 rows) to use each weight it reads
// on more rows.
//
// Design. A thread block of 256 threads takes S consecutive samples. Shared
// memory holds
//     sx  S x (H + 2P) x ldx   x with P = K/2 zero rows of halo per sample
//     sh  S x (H + 2P) x ldh   conv1 output, normalised and FiLM'd in place;
//                              then conv2's output (interior rows)
//     st  S x G x 2            GroupNorm mean and 1/std
// (row strides rounded up to 4 floats and padded by 4, zero columns past C).
// The TPU kernel's membership-matrix matmuls for the GroupNorm statistics
// (a Mosaic workaround) become one warp per (sample, group) reduction.
// Each conv is an implicit GEMM over the K taps: thread t owns 4 adjacent
// output channels (float4 weight loads, coalesced across the warp) and TM
// rows (row group t / (Cout/4), rows rg + i*RG), reads the A rows from
// shared memory as float4 and accumulates with FFMA. Tensor cores
// (implicit GEMM on wgmma, or 3xTF32 for f32 accuracy) and TMA-staged
// weight tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTM = 8;
// shared memory a block should stay under, so that two fit on one SM
constexpr size_t kSmemBudget = 100 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mish(float v) {
  // softplus in its overflow-free form: max(v, 0) + log1p(exp(-|v|))
  const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

// Row stride, in floats, of a shared tile with C columns: a multiple of 4
// (float4 reads), plus 4 to spread the rows of a warp over the banks.
__host__ __device__ __forceinline__ int row_stride(int C) { return (C + 3) / 4 * 4 + 4; }

// acc[i][j] = sum_{k < taps} sum_{c < C} A[(arow[i] + k) * lda + c] * W[(k*C + c) * ldw + n + j]
// A is shared, 16-byte aligned rows, columns C..lda-1 zero; W is global,
// row-major with leading dimension ldw (a multiple of 4), n a multiple of 4.
template <int TM>
__device__ __forceinline__ void conv_gemm(const float* A, int lda, const int (&arow)[TM],
                                          const float* __restrict__ W, int ldw, int C, int taps,
                                          int n, float (&acc)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < taps; ++k) {
    const float* wk = W + (size_t)k * C * ldw + n;
    for (int c = 0; c < C; c += 4) {
      // rows c..c+3 of this tap's weights; past C (C % 4 != 0) they are
      // zero, as are A's columns there
      float4 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = c + q < C ? __ldg(reinterpret_cast<const float4*>(wk + (size_t)(c + q) * ldw))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (arow[i] + k) * lda + c);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(av[q], w[q].x, acc[i][0]);
          acc[i][1] = fmaf(av[q], w[q].y, acc[i][1]);
          acc[i][2] = fmaf(av[q], w[q].z, acc[i][2]);
          acc[i][3] = fmaf(av[q], w[q].w, acc[i][3]);
        }
      }
    }
  }
}

// GroupNorm statistics of the interior rows of sh, one warp per (sample,
// group): st[2 * (s*G + g)] = mean, st[2 * (s*G + g) + 1] = 1/sqrt(var + eps).
__device__ void group_stats(const float* sh, int ldh, int S, int H, int Hp, int P, int C, int G,
                            float eps, float* st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Cg = C / G, n = H * Cg;
  for (int task = warp; task < S * G; task += blockDim.x >> 5) {
    const int s = task / G, g = task % G;
    const float* base = sh + (s * Hp + P) * ldh + g * Cg;
    float sum = 0.0f;
    for (int e = lane; e < n; e += 32) sum += base[(e / Cg) * ldh + e % Cg];
    const float mean = warp_sum(sum) / n;
    float var = 0.0f;
    for (int e = lane; e < n; e += 32) {
      const float d = base[(e / Cg) * ldh + e % Cg] - mean;
      var = fmaf(d, d, var);
    }
    var = warp_sum(var) / n;
    if (lane == 0) {
      st[2 * task] = mean;
      st[2 * task + 1] = rsqrtf(var + eps);
    }
  }
}

size_t smem_floats(int S, int H, int Cin, int Cout, int K, int G) {
  const int Hp = H + 2 * (K / 2);
  return (size_t)S * Hp * (row_stride(Cin) + row_stride(Cout)) + (size_t)2 * S * G;
}

// Samples per thread block and rows per thread for a shape: aim at 4 rows
// per thread, halve S while shared memory is over budget. Returns false if
// even S = 1 needs more than kMaxTM rows per thread.
bool plan_tile(int B, int H, int Cin, int Cout, int K, int G, int* S_out, int* TM_out,
               size_t* smem_out) {
  const int RG = kThreads / (Cout / 4);
  int S = (4 * RG) / H;
  S = S < 1 ? 1 : (S > B ? B : S);
  while (S > 1 && smem_floats(S, H, Cin, Cout, K, G) * sizeof(float) > kSmemBudget) S /= 2;
  const int need = (S * H + RG - 1) / RG;
  int TM = 1;
  while (TM < need) TM *= 2;
  if (TM > kMaxTM) return false;
  *S_out = S;
  *TM_out = TM;
  *smem_out = smem_floats(S, H, Cin, Cout, K, G) * sizeof(float);
  return true;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
film_resblock_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ g1s, const float* __restrict__ g1b,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ g2s, const float* __restrict__ g2b,
                     const float* __restrict__ wskip, const float* __restrict__ bskip,
                     float* __restrict__ out, int B, int H, int Cin, int Cout, int K, int G,
                     int S, int film_scale, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int P = K / 2, Hp = H + 2 * P;
  const int ldx = row_stride(Cin), ldh = row_stride(Cout);
  float* sx = smem;
  float* sh = sx + S * Hp * ldx;
  float* st = sh + S * Hp * ldh;
  const int b0 = blockIdx.x * S;
  const int nS = min(S, B - b0);  // samples of this block that exist
  const int rows = S * H;
  const int Cg = Cout / G;

  // x into sx: zero halo rows, zero columns past Cin, zero missing samples
  for (int e = threadIdx.x; e < S * Hp * ldx; e += blockDim.x) {
    const int s = e / (Hp * ldx), rem = e % (Hp * ldx);
    const int h = rem / ldx - P, c = rem % ldx;
    sx[e] = (s < nS && h >= 0 && h < H && c < Cin)
                ? x[((size_t)(b0 + s) * H + h) * Cin + c] : 0.0f;
  }
  // conv2 reads sh's halo rows and padding columns: they must be zero
  for (int e = threadIdx.x; e < S * Hp * ldh; e += blockDim.x) sh[e] = 0.0f;
  __syncthreads();

  // thread -> 4 output channels n..n+3 and rows rg, rg + RG, ...
  const int CG = Cout / 4, RG = blockDim.x / CG;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const bool active = rg < RG;  // the last threads idle in the products when CG does not divide 256
  const int n = 4 * cg;
  int arow[TM];   // tile row of (sample, h) at tap 0, i.e. h - P in halo coordinates
  int sample[TM];
  bool live[TM];  // a row of this tile, of a sample that exists
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + i * RG;
    const int rr = r < rows ? r : 0;
    sample[i] = rr / H;
    arow[i] = sample[i] * Hp + rr % H;
    live[i] = active && r < rows && sample[i] < nS;
  }
  float acc[TM][4];

  // ---- conv1 -> sh (interior rows)
  if (active) {
    conv_gemm<TM>(sx, ldx, arow, w1, Cout, Cin, K, n, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (live[i])
#pragma unroll
        for (int j = 0; j < 4; ++j) sh[(arow[i] + P) * ldh + n + j] = acc[i][j] + b1[n + j];
  }
  __syncthreads();
  group_stats(sh, ldh, S, H, Hp, P, Cout, G, eps, st);
  __syncthreads();

  // ---- GN affine, mish, FiLM, in place
  for (int e = threadIdx.x; e < nS * H * Cout; e += blockDim.x) {
    const int r = e / Cout, c = e % Cout;
    const int s = r / H;
    float* p = sh + (s * Hp + P + r % H) * ldh + c;
    const float* stat = st + 2 * (s * G + c / Cg);
    const float v = mish((*p - stat[0]) * stat[1] * g1s[c] + g1b[c]);
    const float* e_row = emb + (size_t)(b0 + s) * (film_scale ? 2 * Cout : Cout);
    *p = film_scale ? fmaf(e_row[c], v, e_row[Cout + c]) : v + e_row[c];
  }
  __syncthreads();

  // ---- conv2: sums held in registers until every thread has read sh
  if (active) conv_gemm<TM>(sh, ldh, arow, w2, Cout, Cout, K, n, acc);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (live[i])
#pragma unroll
        for (int j = 0; j < 4; ++j) sh[(arow[i] + P) * ldh + n + j] = acc[i][j] + b2[n + j];
  }
  __syncthreads();
  group_stats(sh, ldh, S, H, Hp, P, Cout, G, eps, st);
  __syncthreads();

  // ---- out = mish(GN(h)) + skip, 4 channels per thread, one float4 store
  if (!active) return;
  if (wskip != nullptr) {
    int crow[TM];  // the centre tap's row: x itself
#pragma unroll
    for (int i = 0; i < TM; ++i) crow[i] = arow[i] + P;
    conv_gemm<TM>(sx, ldx, crow, wskip, Cout, Cin, 1, n, acc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!live[i]) continue;
    const int row = arow[i] + P;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n + j;
      const float* stat = st + 2 * (sample[i] * G + c / Cg);
      const float v = mish((sh[row * ldh + c] - stat[0]) * stat[1] * g2s[c] + g2b[c]);
      o[j] = v + (wskip != nullptr ? acc[i][j] + bskip[c] : sx[row * ldx + c]);
    }
    const int h = row - sample[i] * Hp - P;
    *reinterpret_cast<float4*>(out + ((size_t)(b0 + sample[i]) * H + h) * Cout + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

template <int TM>
cudaError_t launch(const float* x, const float* emb, const float* w1, const float* b1,
                   const float* g1s, const float* g1b, const float* w2, const float* b2,
                   const float* g2s, const float* g2b, const float* wskip, const float* bskip,
                   float* out, int B, int H, int Cin, int Cout, int K, int G, int S,
                   int film_scale, float eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(film_resblock_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + S - 1) / S;
  film_resblock_kernel<TM><<<grid, kThreads, smem, stream>>>(
      x, emb, w1, b1, g1s, g1b, w2, b2, g2s, g2b, wskip, bskip, out, B, H, Cin, Cout, K, G, S,
      film_scale, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for this shape, or -1 if the
// kernel does not take it (more than 8 rows per thread).
long long film_resblock_smem_bytes(int B, int H, int Cin, int Cout, int K, int G) {
  int S, TM;
  size_t smem;
  if (Cout % 4 != 0 || Cout / 4 > kThreads || !plan_tile(B, H, Cin, Cout, K, G, &S, &TM, &smem))
    return -1;
  return (long long)smem;
}

// Most dynamic shared memory a block may opt in to on `device`, or -1.
int film_resblock_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* film_resblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, H, Cin), emb (B, Cout) or (B, 2*Cout), w1 (K, Cin, Cout), w2 (K,
// Cout, Cout), wskip (Cin, Cout) or null (then Cin == Cout), vectors
// (Cout,), out (B, H, Cout); all f32, contiguous, 16-byte aligned. Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int film_resblock_forward_f32(const void* x, const void* emb, const void* w1, const void* b1,
                              const void* g1s, const void* g1b, const void* w2, const void* b2,
                              const void* g2s, const void* g2b, const void* wskip,
                              const void* bskip, void* out, int B, int H, int Cin, int Cout,
                              int K, int G, int film_scale, float eps, void* stream) {
  int S, TM;
  size_t smem;
  if (B <= 0 || H <= 0 || Cin <= 0 || K % 2 == 0 || G <= 0 || Cout % 4 != 0 || Cout % G != 0 ||
      Cout / 4 > kThreads || (wskip == nullptr && Cin != Cout) ||
      !plan_tile(B, H, Cin, Cout, K, G, &S, &TM, &smem))
    return (int)cudaErrorInvalidValue;
  const float* f[12] = {
      static_cast<const float*>(x),   static_cast<const float*>(emb),
      static_cast<const float*>(w1),  static_cast<const float*>(b1),
      static_cast<const float*>(g1s), static_cast<const float*>(g1b),
      static_cast<const float*>(w2),  static_cast<const float*>(b2),
      static_cast<const float*>(g2s), static_cast<const float*>(g2b),
      static_cast<const float*>(wskip), static_cast<const float*>(bskip)};
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FILM_LAUNCH(TM_)                                                                      \
  launch<TM_>(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11], o, B, \
              H, Cin, Cout, K, G, S, film_scale, eps, smem, st)
  switch (TM) {
    case 1: return (int)FILM_LAUNCH(1);
    case 2: return (int)FILM_LAUNCH(2);
    case 4: return (int)FILM_LAUNCH(4);
    default: return (int)FILM_LAUNCH(8);
  }
#undef FILM_LAUNCH
}

}  // extern "C"
