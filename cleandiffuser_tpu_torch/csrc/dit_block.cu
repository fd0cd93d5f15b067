// Fused adaLN-Zero DiT block, forward, float32, for NVIDIA Hopper (sm_90a):
// `dit_block_forward_f32`. The BF16 route is csrc/dit_block_bf16.cu.
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
// What bounds it on this card. One block is B*H*(24*D^2 + 4*H*D) flops on
// 12*D^2 weights (D = 320: 4.9 MB in f32) and 2*B*H*D + 6*B*D floats of
// activations: at the DD plan's (B, H, D) = (100, 32, 320) 8.0 GFLOP
// against 13.9 MB, so the bound is the operations, 98 % of them in the
// four weight products. Every intermediate (LN output, q, k, v, scores,
// GELU activations) stays in shared memory, so device memory sees one read
// of x and mod and one write of out; the weights are read from L2, warmed
// at entry by a prefetch from every block. The products do 3 TF32 MMAs per
// multiply-add, so the operations bound is 3x the flops at the TF32 peak of
// 495 TFLOP/s: 0.048 ms at (100, 32, 320). One thread block per 32 rows of
// a trajectory (~212 KB of shared memory at D = 320, one block per SM): at
// H = 32, B = 100 covers 100 of 132 SMs and B = 3200 runs ~25 waves.
// Measured on an H100 (700 W): 0.285 ms at B = 100 (28 TFLOP/s, 17 % of the
// bound), 7.14 ms at B = 3200 (36), 0.59 ms at (100, 64, 320). Neither the
// tensor pipe (~1/3 busy) nor instruction issue is full: what holds it is
// the chain of each k8 step (a warp loads 12 fragments, splits 14 operands
// at 3 dependent instructions each, issues 15 MMAs) between barriers every
// two steps; the fixed phases (LN, epilogues, attention) are 10 %. Removing
// two of every three MMAs (and the splits they need) saves 29 % of the
// time, yet folding the two correction MMAs into one BF16 MMA saves 2 % and
// 20 warps instead of 16 lose 6 %; the weight copies cost 9 %, the
// per-stage barrier 7 %, attention 1.4 %. Two blocks of 16 rows per
// trajectory, two per SM, are 27 % slower: twice the weight staging and
// the barriers per trajectory.
//
// Design.
// - Tensor cores in 3xTF32. All four weight products, and QK^T and PV of
//   attention, run on `mma.sync.m16n8k8` TF32 with f32 accumulators. Each
//   operand v is split in registers into hi (v rounded to TF32) and
//   lo = v - hi, and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi:
//   f32-class accuracy at three MMAs per product (one TF32 product misses
//   the 1e-4 block tolerance; tests/test_torch_dit_tf32.py). `mma.sync`
//   rather than `wgmma`: TF32 `wgmma` reads B K-major from shared memory,
//   while the weights arrive in the JAX layout (in, out), N-major, which
//   `mma.sync` reads as it is stored; `wgmma` takes 64 rows, two
//   trajectories, which would halve the blocks at B = 100; and 3xTF32 on
//   it would need the split halves of B staged in shared memory, which does
//   not fit beside the activations.
// - Weight tiles are staged in shared memory by cp.async, kCK = 16 input
//   rows x the product's columns per stage, double-buffered; each staged
//   weight feeds every row of the trajectory. Behind its last stage, a
//   product issues the next product's first stage, which lands during the
//   epilogue. The sums of each stage are added into f32 registers: the
//   tensor cores' own accumulation over K = 320 is 10x less accurate
//   (against float64 at the DD plan's shape: 3.3e-5 against 3.3e-6), for
//   ~4 % of the time. 16 warps: 2 along the block's 32 rows (one m16 tile
//   each), 8 along the columns (NT = ceil(D / 64) n8 tiles each).
// - Every product's output is D columns wide: q, k and v are three products
//   over wqkv's column blocks (k and v first, so that q can replace h in
//   place), Wo one, and the MLP runs over 4 chunks of D hidden units, whose
//   GELU'd activations are the A of that chunk's W2 product; each chunk's
//   W2 product is added to x, scaled by gate2, in place.
// - Attention: one warp per (head, 16 query rows). S = q k^T and O = P V on
//   the same 3xTF32 MMAs; the scores stay in registers, where the softmax
//   is exact f32 (max-subtracted expf); the accumulator fragment of S is
//   the A fragment of P V, so P never leaves the registers. O replaces q.
// - Bank conflicts: within each 8-wide k step, column 2q of the step goes
//   to the MMA's k index q and 2q + 1 to q + 4 (the same permutation for A
//   and B), so a thread's A pair is one 8-byte load. Activation rows are
//   strided by D + 8 floats (8 mod 32), v's and the weight tiles' by a
//   width + 4 (2 * stride = 8 mod 32): every fragment load is
//   conflict-free.
// - H <= 64: a trajectory of H > 32 rows runs on a cluster of
//   ceil(H / 32) thread blocks, each holding 32 of its rows (every phase
//   but attention is row by row). Attention reads the keys and values of
//   the other blocks through distributed shared memory, between two
//   cluster barriers. Rows past H are zeros in x, so they stay finite;
//   keys past H are masked. The split is by rows because a split by heads
//   or by columns leaves x and h whole in every block: at H = 64 those
//   alone take 164 KB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarpsN = 8;  // warps along the columns of a product
constexpr int kWarpsM = 2;  // warps along the rows of a block, one m16 tile each
constexpr int kRows = 16 * kWarpsM;  // rows of a trajectory per thread block
constexpr int kThreads = 32 * kWarpsN * kWarpsM;
constexpr int kMaxH = 64;
constexpr int kMaxCluster = kMaxH / kRows;  // thread blocks per trajectory
constexpr int kCK = 16;     // weight rows per stage; two stages in flight
constexpr int kMaxD = 320;  // D = 352 needs 242 KB of shared memory
constexpr int kMaxHd = 64;
constexpr int kMaxKeyTiles = kMaxH / 8;

struct Params {
  const float *x, *mod, *wqkv, *bqkv, *wo, *bo, *w1, *b1, *w2, *b2;
  float* out;
  int H, D, n_heads, hd;
  float q_scale;
  int C, lda, ldv, ldw;  // C: thread blocks (a cluster) per trajectory
};

struct Geometry {
  int NT, lda, ldv, ldw;
  size_t smem_floats;
};

// NT n8 tiles per warp (kWarpsN warps cover 8 * kWarpsN * NT >= D
// columns); row strides as in the source note.
Geometry geometry(int D) {
  Geometry g;
  g.NT = (D + 8 * kWarpsN - 1) / (8 * kWarpsN);
  g.lda = D + 8;
  g.ldv = D + 4;
  g.ldw = 8 * kWarpsN * g.NT + 4;
  g.smem_floats = (size_t)3 * kRows * g.lda + (size_t)kRows * g.ldv + (size_t)6 * D +
                  (size_t)2 * kCK * g.ldw;
  return g;
}

// ---------------------------------------------------------------------------
// device helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !full
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v ~= hi + lo. hi = v rounded to TF32, to nearest, ties away from zero (an
// integer add of half a TF32 ulp, then the low 13 bits cleared). lo = v - hi
// is exact in f32, at most 2^-11 |v|; the tensor core reads its TF32 part,
// a further error below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// A fragment of one m16 x k8 step from two float2s: rows g and g + 8, columns
// 2q and 2q + 1 of the step (k indices q and q + 4)
__device__ __forceinline__ void split_a(float2 u, float2 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(u.x, hi[0], lo[0]);
  split_tf32(v.x, hi[1], lo[1]);
  split_tf32(u.y, hi[2], lo[2]);
  split_tf32(v.y, hi[3], lo[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max / sum over the 4 lanes of a quad (the lanes that share an MMA row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// out[r, :] = LN(x[r, :]) * (1 + scale) + shift for r < rows, two-pass
// variance; one warp per row; x and out shared, row stride ld.
__device__ void layernorm_modulate(const float* x, float* out, int ld, const float* shift,
                                   const float* scale, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    const float* xr = x + r * ld;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + 1e-6f);
    float* orow = out + r * ld;
    for (int c = lane; c < D; c += 32) orow[c] = (xr[c] - mu) * rstd * (1.0f + scale[c]) + shift[c];
  }
}

// One k8 step of the warp's 16 x 8*NT tile in 3xTF32. A: the step's column
// 0 of the activations; aoff[0/1]: offset of rows g, g + 8 of the warp's
// m16 tile, plus 2q. W: row 2q of the step in the staged weight tile, at the
// warp's first column + g.
template <int NT>
__device__ __forceinline__ void mma_step(const float* A, const int (&aoff)[2], const float* W,
                                         int ldw, float (&acc)[NT][4]) {
  uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(W[j * 8], bhi[j][0], blo[j][0]);
    split_tf32(W[j * 8 + ldw], bhi[j][1], blo[j][1]);
  }
  uint32_t ahi[4], alo[4];
  split_a(*reinterpret_cast<const float2*>(A + aoff[0]),
          *reinterpret_cast<const float2*>(A + aoff[1]), ahi, alo);
  // the three products of one n8 tile are dependent; interleave the tiles
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, bhi[j][0], bhi[j][1]);
}

// Stage st of a product: weight rows [st * kCK, (st + 1) * kCK) of the
// ncols-wide column block at W (row stride ldg) into ring slot st % 2, by
// cp.async, columns past ncols (up to the tile's 8 * kWarpsN * NT) zero; one
// group.
template <int NT>
__device__ __forceinline__ void issue_stage(const float* __restrict__ W, int ldg, int ncols,
                                            int st, float* ring, int ldw) {
  constexpr int per_row = 2 * kWarpsN * NT;  // 16-byte pieces in a staged row
  float* slot = ring + (st & 1) * kCK * ldw;
  const float* src = W + (size_t)st * kCK * ldg;
  for (int e = threadIdx.x; e < kCK * per_row; e += kThreads) {
    const int r = e / per_row, c = 4 * (e - r * per_row);
    const bool full = c < ncols;
    cp_async16(slot + r * ldw + c, full ? src + (size_t)r * ldg + c : W, full);
  }
  cp_async_commit();
}

// acc = the warp's tile of A[:, :K] @ W[:K, block], the block being the
// ncols columns at W (row stride ldg). A is shared (row stride lda). Stage
// 0 of W must be in flight (issued by the caller, or by the gemm before);
// the weights then stream through a double-buffered ring, and behind its
// last stage the gemm issues stage 0 of the next product, Wn (if not null),
// so that it lands during this epilogue. K / kCK is even, so every product
// starts in slot 0. Ends with a block barrier: A is free when it returns.
template <int NT>
__device__ __forceinline__ void gemm(const float* A, int lda, int K, const float* __restrict__ W,
                                     int ldg, const float* Wn, int ldgn, int ncols, float* ring,
                                     int ldw, int row0, int ncol0, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.0f;
  const int aoff[2] = {(row0 + g) * lda + 2 * q, (row0 + 8 + g) * lda + 2 * q};

  const int nst = K / kCK;
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<0>();
    __syncthreads();  // stage st landed for every thread; stage st - 1's slot is free
    if (st + 1 < nst)
      issue_stage<NT>(W, ldg, ncols, st + 1, ring, ldw);
    else if (Wn != nullptr)
      issue_stage<NT>(Wn, ldgn, ncols, 0, ring, ldw);
    const float* As = A + st * kCK;
    const float* Ws = ring + (st & 1) * kCK * ldw + 2 * q * ldw + ncol0 + g;
    // the stage's sums, added into acc in f32 (source note)
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[j][v] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kCK / 8; ++ks)
      mma_step<NT>(As + 8 * ks, aoff, Ws + 8 * ks * ldw, ldw, part);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][v] += part[j][v];
  }
  __syncthreads();
}

// epi(r, n, v0, v1) for the accumulators of columns n, n + 1 < ncols of
// every row r of the warp's tile
template <int NT, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[NT][4], int row0, int ncol0,
                                         int ncols, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = ncol0 + 8 * j + 2 * q;
    if (n >= ncols) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) epi(row0 + 8 * hf + g, n, acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
}

// Multi-head attention of the block's kRows query rows. q (scaled) is in
// sa (row stride lda); the keys and values of the trajectory's rows
// [kRows * r, kRows * (r + 1)) are at sk[r] (row stride lda) and sv[r] (row
// stride ldv), in the shared memory of cluster block r. One warp per (head,
// m16 tile of query rows); the output of a (head, tile) replaces its q,
// which no other warp reads.
__device__ __forceinline__ void attention(const Params& p, float* sa,
                                          const float* const (&sk)[kMaxCluster],
                                          const float* const (&sv)[kMaxCluster]) {
  constexpr int mtiles = kRows / 16, ktiles_per_block = kRows / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int lda = p.lda, ldv = p.ldv, hd = p.hd;
  const int ktiles = p.C * ktiles_per_block, dtiles = hd / 8;
  for (int task = warp; task < p.n_heads * mtiles; task += kThreads / 32) {
    const int h = task / mtiles, mt = task - h * mtiles;
    float* q0 = sa + (mt * 16 + g) * lda + h * hd + 2 * q;  // row g; row g + 8 at + 8 * lda
    // key g of key tile j, for j unrolled: its block and row are constants
    auto key = [&](int j) {
      return sk[j / ktiles_per_block] + (8 * (j % ktiles_per_block) + g) * lda + h * hd + 2 * q;
    };

    float s[kMaxKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) s[j][v] = 0.0f;
    for (int ks = 0; ks < dtiles; ++ks) {
      uint32_t ahi[4], alo[4];
      split_a(*reinterpret_cast<const float2*>(q0 + 8 * ks),
              *reinterpret_cast<const float2*>(q0 + 8 * lda + 8 * ks), ahi, alo);
#pragma unroll
      for (int j = 0; j < kMaxKeyTiles; ++j) {
        if (j >= ktiles) break;
        const float2 kk = *reinterpret_cast<const float2*>(key(j) + 8 * ks);
        uint32_t bhi[2], blo[2];
        split_tf32(kk.x, bhi[0], blo[0]);
        split_tf32(kk.y, bhi[1], blo[1]);
        mma_3x(s[j], ahi, alo, bhi, blo);
      }
    }

    // softmax over keys < H of rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      if (j >= ktiles) break;
      const int key = 8 * j + 2 * q;
      if (key >= p.H) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= p.H) s[j][1] = s[j][3] = -INFINITY;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      if (j >= ktiles) break;
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // O = P V: S's accumulator fragment is P's A fragment (keys 2q, 2q + 1
    // of a key tile are its k indices q, q + 4)
    float o[kMaxHd / 8][4];
#pragma unroll
    for (int d = 0; d < kMaxHd / 8; ++d)
#pragma unroll
      for (int v = 0; v < 4; ++v) o[d][v] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      if (j >= ktiles) break;
      uint32_t ahi[4], alo[4];
      split_a(make_float2(s[j][0], s[j][1]), make_float2(s[j][2], s[j][3]), ahi, alo);
      // values of keys 2q, 2q + 1 of tile j, column g of the head
      const float* vh =
          sv[j / ktiles_per_block] + (8 * (j % ktiles_per_block) + 2 * q) * ldv + h * hd + g;
#pragma unroll
      for (int d = 0; d < kMaxHd / 8; ++d) {
        if (d >= dtiles) break;
        const float* vp = vh + 8 * d;
        uint32_t bhi[2], blo[2];
        split_tf32(vp[0], bhi[0], blo[0]);
        split_tf32(vp[ldv], bhi[1], blo[1]);
        mma_3x(o[d], ahi, alo, bhi, blo);
      }
    }
    __syncwarp();
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int d = 0; d < kMaxHd / 8; ++d) {
      if (d >= dtiles) break;
      *reinterpret_cast<float2*>(q0 + 8 * d) = make_float2(o[d][0] * inv0, o[d][1] * inv0);
      *reinterpret_cast<float2*>(q0 + 8 * lda + 8 * d) =
          make_float2(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

// Ask for this thread block's 1/gridDim share of a weight matrix to be
// brought into L2. Together the blocks warm the whole matrix at kernel entry,
// so the staging copies read it from L2 and not from device memory.
__device__ __forceinline__ void prefetch_l2_share(const float* p, size_t n) {
  const char* base = reinterpret_cast<const char*>(p);
  const size_t lines = (n * sizeof(float) + 127) / 128;
  for (size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x; l < lines;
       l += (size_t)gridDim.x * blockDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + l * 128));
}

template <int NT>
__global__ void __launch_bounds__(kThreads) dit_block_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int D = p.D, H = p.H, lda = p.lda, ldv = p.ldv;
  float* sx = smem;               // kRows x lda  the residual stream x, updated in place
  float* sa = sx + kRows * lda;   // kRows x lda  h, then q, then the attention output, then h2
  float* sk = sa + kRows * lda;   // kRows x lda  k, then an MLP chunk's GELU'd hidden units
  float* sv = sk + kRows * lda;   // kRows x ldv  v
  float* smod = sv + kRows * ldv;  // 6D         shift1 scale1 gate1 shift2 scale2 gate2
  float* ring = smod + 6 * D;      // 2 x kCK x ldw  staged weight tiles
  // trajectory b, its rows [r0, r0 + rows)
  const int b = blockIdx.x / p.C, r0 = (int)cluster.block_rank() * kRows;
  const int rows = min(kRows, H - r0);
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp / kWarpsN) * 16, ncol0 = (warp % kWarpsN) * 8 * NT;

  prefetch_l2_share(p.wqkv, (size_t)3 * D * D);
  prefetch_l2_share(p.wo, (size_t)D * D);
  prefetch_l2_share(p.w1, (size_t)4 * D * D);
  prefetch_l2_share(p.w2, (size_t)4 * D * D);
  issue_stage<NT>(p.wqkv + D, 3 * D, D, 0, ring, p.ldw);  // the first product's first stage

  // x -> sx, rows past H zero; mod -> smod
  const int D4 = D / 4;
  const float4* xb = reinterpret_cast<const float4*>(p.x + ((size_t)b * H + r0) * D);
  for (int e = threadIdx.x; e < kRows * D4; e += kThreads) {
    const int r = e / D4, c = e - r * D4;
    *reinterpret_cast<float4*>(sx + r * lda + 4 * c) =
        r < rows ? xb[r * D4 + c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = threadIdx.x; i < 6 * D; i += kThreads) smod[i] = p.mod[(size_t)b * 6 * D + i];
  __syncthreads();
  const float* gate1 = smod + 2 * D;
  const float* gate2 = smod + 5 * D;

  float acc[NT][4];
  // A[:, :D] @ (a D-wide column block of W, row stride ldg), the
  // accumulators handed to epi(r, n, v0, v1); Wn is the next product's
  // block, whose first stage goes out behind this one's last. The epilogue
  // may overwrite A: gemm ends with a barrier.
  auto product = [&](const float* A, const float* W, int ldg, const float* Wn, int ldgn,
                     auto epi) {
    gemm<NT>(A, lda, D, W, ldg, Wn, ldgn, D, ring, p.ldw, wrow, ncol0, acc);
    epilogue<NT>(acc, wrow, ncol0, D, epi);
  };

  // ---- attention branch
  layernorm_modulate(sx, sa, lda, smod, smod + D, kRows, D);
  __syncthreads();
  // k and v, then q, which replaces h
  product(sa, p.wqkv + D, 3 * D, p.wqkv + 2 * D, 3 * D, [&](int r, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sk + r * lda + n) = make_float2(v0 + p.bqkv[D + n],
                                                               v1 + p.bqkv[D + n + 1]);
  });
  product(sa, p.wqkv + 2 * D, 3 * D, p.wqkv, 3 * D, [&](int r, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sv + r * ldv + n) = make_float2(v0 + p.bqkv[2 * D + n],
                                                               v1 + p.bqkv[2 * D + n + 1]);
  });
  product(sa, p.wqkv, 3 * D, p.wo, D, [&](int r, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sa + r * lda + n) =
        make_float2((v0 + p.bqkv[n]) * p.q_scale, (v1 + p.bqkv[n + 1]) * p.q_scale);
  });
  // every block of the cluster has its k and v; attention reads them all
  cluster.sync();
  const float* skr[kMaxCluster];
  const float* svr[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    skr[r] = r < p.C ? cluster.map_shared_rank(sk, r) : sk;
    svr[r] = r < p.C ? cluster.map_shared_rank(sv, r) : sv;
  }
  attention(p, sa, skr, svr);
  // no block reads this one's k and v any more: sk is free for the MLP
  cluster.sync();
  product(sa, p.wo, D, p.w1, 4 * D, [&](int r, int n, float v0, float v1) {
    float2* xr = reinterpret_cast<float2*>(sx + r * lda + n);
    const float2 x0 = *xr;
    *xr = make_float2(x0.x + gate1[n] * (v0 + p.bo[n]), x0.y + gate1[n + 1] * (v1 + p.bo[n + 1]));
  });
  __syncthreads();

  // ---- MLP branch, over 4 chunks of D hidden units
  layernorm_modulate(sx, sa, lda, smod + 3 * D, smod + 4 * D, kRows, D);
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    const float* b1 = p.b1 + c * D;
    const float* w2 = p.w2 + (size_t)c * D * D;
    product(sa, p.w1 + c * D, 4 * D, w2, D, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<float2*>(sk + r * lda + n) =
          make_float2(gelu_tanh(v0 + b1[n]), gelu_tanh(v1 + b1[n + 1]));
    });
    __syncthreads();
    const bool bias = c == 0;
    const float* w1_next = c < 3 ? p.w1 + (c + 1) * D : nullptr;
    product(sk, w2, D, w1_next, 4 * D, [&](int r, int n, float v0, float v1) {
      float2* xr = reinterpret_cast<float2*>(sx + r * lda + n);
      const float2 x0 = *xr;
      *xr = make_float2(x0.x + gate2[n] * (bias ? v0 + p.b2[n] : v0),
                        x0.y + gate2[n + 1] * (bias ? v1 + p.b2[n + 1] : v1));
    });
  }
  __syncthreads();

  float4* ob = reinterpret_cast<float4*>(p.out + ((size_t)b * H + r0) * D);
  for (int e = threadIdx.x; e < rows * D4; e += kThreads) {
    const int r = e / D4, c = e - r * D4;
    ob[e] = *reinterpret_cast<const float4*>(sx + r * lda + 4 * c);
  }
}

// B trajectories on B clusters of p.C thread blocks (a cluster of one when
// H <= kRows)
template <int NT>
cudaError_t launch(const Params& p, int B, const Geometry& geo, cudaStream_t stream) {
  auto kernel = dit_block_kernel<NT>;
  const size_t smem = geo.smem_floats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one thread block needs at width D (any H).
long long dit_block_smem_bytes(int D) {
  return (long long)(geometry(D).smem_floats * sizeof(float));
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
// contiguous, 16-byte aligned. H <= 64; D a multiple of 32, at most 320;
// head dim D / n_heads a multiple of 8, at most 64. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int dit_block_forward_f32(const void* x, const void* mod, const void* wqkv, const void* bqkv,
                          const void* wo, const void* bo, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int B, int H, int D,
                          int n_heads, float q_scale, void* stream) {
  if (B <= 0 || H <= 0 || H > kMaxH || D <= 0 || D % 32 != 0 || D > kMaxD ||
      n_heads <= 0 || D % n_heads != 0 || (D / n_heads) % 8 != 0 || D / n_heads > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(D);
  Params p;
  p.x = static_cast<const float*>(x);
  p.mod = static_cast<const float*>(mod);
  p.wqkv = static_cast<const float*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wo = static_cast<const float*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.H = H, p.D = D, p.n_heads = n_heads, p.hd = D / n_heads;
  p.q_scale = q_scale;
  p.C = (H + kRows - 1) / kRows;
  p.lda = geo.lda, p.ldv = geo.ldv, p.ldw = geo.ldw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (geo.NT) {
    case 1: return (int)launch<1>(p, B, geo, st);
    case 2: return (int)launch<2>(p, B, geo, st);
    case 3: return (int)launch<3>(p, B, geo, st);
    case 4: return (int)launch<4>(p, B, geo, st);
    case 5: return (int)launch<5>(p, B, geo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
