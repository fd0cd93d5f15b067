// Fused FiLM Conv1d residual block, forward, float32, for NVIDIA Hopper
// (sm_90a): `film_resblock_forward_f32`. The BF16 route is
// csrc/film_resblock_bf16.cu.
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
// (B = 3200 candidate trajectories): 2*K*H*(Cin + Cout)*Cout flops per
// sample against a few KB of activations, on up to 2.6 MB of weights. Every
// intermediate (conv outputs, GN statistics, the FiLM'd hidden layer) stays
// in shared memory, so device memory sees one read of x and emb and one
// write of out. What is left is the tensor-core work, three TF32 MMAs per
// f32 product (`mma.sync` TF32 peaks near 320 TFLOP/s on an H100 SXM, so
// 3xTF32 tops out near 107), the staging of weights into shared memory, and
// the GroupNorm / Mish / FiLM phases. Measured on the H100 the kernel
// reaches ~27 TFLOP/s at the large shapes: the MMA loop keeps the tensor
// pipe about a third busy (two to four warps per SM sub-partition, a block
// barrier per stage), issuing the copies costs about a fifth of the time
// though the L2 streams every block's weights in a tenth of it, and the
// elementwise phases take 0.04-0.07 ms per launch, half of it at the
// 32-channel shapes.
//
// Design.
// - Tensor cores in 3xTF32. Both convs and the skip are implicit GEMMs on
//   `mma.sync.m16n8k8` TF32 with f32 accumulators. Each operand v is split
//   in registers into hi (v rounded to TF32) and lo = v - hi, whose TF32
//   part the tensor core reads, and each product is a_lo*b_hi + a_hi*b_lo
//   + a_hi*b_hi: f32-class accuracy at three MMAs per product. `mma.sync`
//   rather than `wgmma`: a conv tap shifts A by one row, which the 8-row
//   core matrices of a `wgmma` shared-memory descriptor cannot express, so
//   A comes from registers, loaded per thread with its own row address; and
//   TF32 `wgmma` takes only K-major B, while the weights arrive in the JAX
//   layout (K, Cin, Cout), N-major, which `mma.sync` reads from shared
//   memory without a transpose.
// - A thread block owns BM output rows: S = BM / H whole samples (BM = 64;
//   32 when Cout > 256, so that the hidden tile fits) and every output
//   channel, so GroupNorm needs no second pass. Warp tile 16*MT x 8*NT, NW
//   warps of which WN along N: the instantiations below. Cout <= 128 runs two
//   8-warp blocks per SM; Cout = 256 one block of 16 warps. At H = 4 that is
//   200 blocks for B = 3200, 1.5 waves of 132 SMs; BM = 128 would leave 32
//   SMs idle, and BM = 32 (two blocks per SM) measured slower.
// - Weight tiles are staged in shared memory by cp.async in a ring of
//   kStages tiles of CK input channels x Cout (8-16 KB), issued
//   kStages - 1 stages ahead, behind each stage's MMAs. Each staged weight
//   feeds all BM rows of the block through the tensor cores. (Measured and
//   dropped: bulk copies, one per 128 B-1 KB weight row completing on an
//   mbarrier, were slower; so was one producer warp feeding the others
//   through mbarriers, as a single warp cannot issue the copies fast
//   enough.)
// - conv1 and the skip stream x in CK-channel chunks, with the weights of
//   all K taps of the chunk (the chunk is staged with the chunk's first
//   tap), so x never has to fit whole: at (H=4, Cin=512) it would take
//   200 KB. The skip conv re-streams x after conv2 (a 1x1 conv on the
//   centre rows), which costs no extra accumulators during conv1.
// - Halo rows are shared between neighbouring samples: the tile is
//   [P zeros][sample 0][P zeros][sample 1] ... [P zeros], P = K/2, so a
//   sample takes H + P rows and tap k of output row r reads tile row
//   r - P + k. Missing samples of a ragged last block are zero-filled and
//   never stored.
// - conv1's accumulators go to the hidden tile in shared memory; GroupNorm
//   statistics are one warp per (sample, group), two-pass; GN, Mish and
//   FiLM are applied in place, and that tile is conv2's A. conv2's
//   accumulators replace it once every warp has read it. No per-element
//   integer division in these phases, and Mish in closed form.
// - Bank conflicts: within each 8-channel MMA step, channel 2q of the step
//   goes to the MMA's column q and 2q + 1 to column q + 4 (the same
//   permutation for A and B), so a thread's A pair is one 8-byte load.
//   Tile rows are strided by an odd multiple of 8 floats, weight rows by
//   Cout + 4: every fragment load is conflict-free when H is a multiple
//   of 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;  // cp.async ring depth
constexpr int kMaxCout = 512;

struct Params {
  const float *x, *emb, *w1, *b1, *g1s, *g1b, *w2, *b2, *g2s, *g2b, *wskip, *bskip;
  float* out;
  int B, H, Cin, Cout, K, G, film_scale;
  float eps;
  int S, rows;  // samples per block, rows of the halo tile: S * (H + P) + P
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride of a shared tile with C columns: an odd multiple of 8 floats, so
// that 4 consecutive rows start on 4 different 8-bank groups.
__host__ __device__ constexpr int odd8_stride(int C) {
  return (round_up(C, 8) / 8) % 2 ? round_up(C, 8) : round_up(C, 8) + 8;
}

// The tile geometry of one instantiation: MT m16 tiles and NT n8 tiles per
// warp, NW warps of which WN along N.
template <int MT, int NT, int WN, int NW>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int BM = 16 * MT * (NW / WN);  // output rows of a block
  static constexpr int Cp = 8 * NT * WN;          // Cout padded to the warp grid
  // input channels per stage: weight tiles of 8-16 KB, so that every Cout but
  // 256 and 512 fits two blocks per SM (at most 113 KB of shared memory each;
  // at Cout = 128 and 64 that was 1.2-1.4x faster than 32-64 KB tiles)
  static constexpr int CK = Cp >= 512 ? 8 : Cp >= 128 ? 16 : Cp >= 64 ? 32 : 64;
  static constexpr int ldw = Cp + 4;             // weight tile rows: conflict-free b loads
  static constexpr int ldx = odd8_stride(CK);    // x chunk rows
  static constexpr int ldh = odd8_stride(Cp);    // hidden tile rows
  static size_t smem_bytes(int S, int rows, int G) {
    return sizeof(float) * ((size_t)rows * ldh + round_up(2 * S * G, 4) +
                            (size_t)kStages * CK * ldw + (size_t)kStages * rows * ldx);
  }
};

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// Warp tiling for a Cout, and the rows of a block: MT m16 tiles and NT n8
// tiles per warp, NW warps of which WN along N, BM = 16 * MT * (NW / WN)
// rows. Cout <= 128 fits two 8-warp blocks per SM; Cout = 256 fits one, and
// takes 16 warps so that the MMAs of more warps hide each other's latency.
void warp_tiling(int Cout, int* MT, int* NT, int* WN, int* NW, int* BM) {
  const int ntiles = Cout / 8;
  if (ntiles <= 8) {
    *MT = 1, *WN = 2, *NW = 8, *NT = pow2_ceil((ntiles + 1) / 2);
  } else if (ntiles <= 16) {
    *MT = 2, *WN = 4, *NW = 8, *NT = pow2_ceil((ntiles + 3) / 4);
  } else if (ntiles <= 32) {
    *MT = 2, *WN = 8, *NW = 16, *NT = pow2_ceil((ntiles + 7) / 8);
  } else {
    *MT = 2, *WN = 8, *NW = 8, *NT = 8;
  }
  *BM = 16 * *MT * (*NW / *WN);
}

struct Plan {
  int MT, NT, WN, NW, BM, S, rows;
  size_t smem;
};

// the instantiations: MT, NT, WN, NW
#define FILM_TILES(X) \
  X(1, 1, 2, 8) X(1, 2, 2, 8) X(1, 4, 2, 8) X(2, 4, 4, 8) X(2, 4, 8, 16) X(2, 8, 8, 8)
constexpr int tile_key(int MT, int NT, int WN, int NW) {
  return ((MT * 16 + NT) * 16 + WN) * 32 + NW;
}

template <int MT, int NT, int WN, int NW>
size_t smem_of(const Plan& pl, int G) {
  return Tile<MT, NT, WN, NW>::smem_bytes(pl.S, pl.rows, G);
}

bool make_plan(int B, int H, int Cin, int Cout, int K, int G, Plan* pl) {
  if (B <= 0 || H <= 0 || Cin <= 0 || K <= 0 || K % 2 == 0 || G <= 0 || Cout <= 0 ||
      Cout % 8 != 0 || Cout > kMaxCout || Cout % G != 0)
    return false;
  warp_tiling(Cout, &pl->MT, &pl->NT, &pl->WN, &pl->NW, &pl->BM);
  if (pl->BM % H != 0) return false;  // a block owns whole samples
  pl->S = pl->BM / H;
  pl->rows = pl->S * (H + K / 2) + K / 2;
  switch (tile_key(pl->MT, pl->NT, pl->WN, pl->NW)) {
#define FILM_SMEM(MT, NT, WN, NW) \
  case tile_key(MT, NT, WN, NW): pl->smem = smem_of<MT, NT, WN, NW>(*pl, G); return true;
    FILM_TILES(FILM_SMEM)
#undef FILM_SMEM
    default: return false;
  }
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v ~= hi + lo. hi = v rounded to TF32, to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives for finite v, which ptxas expands to 4 instructions
// on sm_90): an integer add of half a TF32 ulp, then the low 13 bits
// cleared. lo = v - hi is exact in f32, at most 2^-11 |v|; the tensor core
// reads its TF32 part (the low 13 bits are ignored), a further error below
// 2^-21 |v|. So hi*b_hi + hi*b_lo + lo*b_hi misses v*b by ~2^-21 relative.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mish(v) = v tanh(log(1 + e^v)) = v n / (n + 2) with n = e^v (e^v + 2); past
// v = 20, n / (n + 2) is 1 in f32
__device__ __forceinline__ float mish(float v) {
  const float e = __expf(fminf(v, 20.0f));
  const float n = e * (e + 2.0f);
  return v * __fdividef(n, n + 2.0f);
}

// One 8-channel step of the implicit GEMM in 3xTF32, all NT n-tiles (weight
// columns past Cout are zero in shared memory).
// A: this step's column 0 of the A tile, already shifted by the tap;
// aoff[i][0/1]: offset of the thread's rows g and g + 8 of m-tile i, plus 2q.
// W: row 2q of this step in the staged weight tile (row = input channel),
// at the warp's first column + g.
template <int MT, int NT, int LDW>
__device__ __forceinline__ void mma_step(const float* A, const int (&aoff)[MT][2], const float* W,
                                         float (&acc)[MT][NT][4]) {
  uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(W[j * 8], bhi[j][0], blo[j][0]);
    split_tf32(W[j * 8 + LDW], bhi[j][1], blo[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t ahi[4], alo[4];
    const float2 u = *reinterpret_cast<const float2*>(A + aoff[i][0]);  // row g: channels 2q, 2q+1
    const float2 v = *reinterpret_cast<const float2*>(A + aoff[i][1]);  // row g + 8
    split_tf32(u.x, ahi[0], alo[0]);
    split_tf32(v.x, ahi[1], alo[1]);
    split_tf32(u.y, ahi[2], alo[2]);
    split_tf32(v.y, ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi, bhi[j][0], bhi[j][1]);
  }
}

// Stage of a conv pass: input channels [c0, c0 + ncols) of tap t. Stages
// weights W[t, c0:c0+ncols, :Cout] into wslot (rows past C zero) and, when
// load_x, x[:, :, c0:c0+ncols] of the block's samples into xslot with the
// halo layout (gaps and missing samples zero), by cp.async.
template <int MT, int NT, int WN, int NW>
__device__ __forceinline__ void issue_stage(const Params& p, const float* __restrict__ W, int C,
                                            int t, int c0, int ncols, bool load_x, int b0,
                                            int nS, float* wslot, float* xslot) {
  using T = Tile<MT, NT, WN, NW>;
  // weights: a thread copies one 16-byte piece of every rstep-th row
  const int per_row = p.Cout / 4, rstep = T::kThreads / per_row;
  const int r0 = threadIdx.x / per_row, cc = 4 * (threadIdx.x - r0 * per_row);
  if (r0 < rstep) {
    for (int r = r0; r < ncols; r += rstep) {
      const int c = c0 + r;
      const bool full = c < C;
      const float* src = full ? W + ((size_t)t * C + c) * p.Cout + cc : W;
      cp_async16(wslot + r * T::ldw + cc, src, full);
    }
  }
  if (!load_x) return;
  const int P = p.K / 2, SP = p.H + P;
  const bool vec = p.Cin % 4 == 0;  // 16-byte copies need 16-byte aligned rows
  const int per_x = vec ? ncols / 4 : ncols;
  for (int e = threadIdx.x; e < p.rows * per_x; e += T::kThreads) {
    const int tr = e / per_x, xc = (vec ? 4 : 1) * (e - tr * per_x);
    const int tt = tr - P;
    const int s = tt / SP, h = tt - s * SP;
    const int c = c0 + xc;
    const bool full = tt >= 0 && h < p.H && s < nS && c < p.Cin;
    const float* src = full ? p.x + ((size_t)(b0 + s) * p.H + h) * p.Cin + c : p.x;
    if (vec)
      cp_async16(xslot + tr * T::ldx + xc, src, full);
    else
      cp_async4(xslot + tr * T::ldx + xc, src, full);
  }
}

// acc = sum over taps t < taps and channels c < C of
//   A[orow - shift + t, c] * W[t, c, n]
// for the thread's fragment rows orow and columns n. A is streamed from x in
// CK-channel chunks (kStream) or is the resident hidden tile hs. Ends with
// every copy landed and a block barrier, so the ring is free for the next
// pass.
template <int MT, int NT, int WN, int NW, bool kStream>
__device__ void conv_pass(const Params& p, const float* __restrict__ W, int C, int taps,
                          int shift, const float* hs, const int (&orow)[MT][2], int ncol0, int b0,
                          int nS, float* wring, float* xring, float (&acc)[MT][NT][4]) {
  using T = Tile<MT, NT, WN, NW>;
  constexpr int lda = kStream ? T::ldx : T::ldh;
  const int lane = threadIdx.x & 31, q = lane & 3, g = lane >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
  int aoff[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) aoff[i][hf] = (orow[i][hf] - shift) * lda + 2 * q;

  const int C8 = round_up(C, 8);
  const int nchunks = (C8 + T::CK - 1) / T::CK;
  const int nst = nchunks * taps;
  const int xslot_floats = p.rows * T::ldx;
  auto issue = [&](int st) {
    const int j = st / taps, t = st - j * taps, c0 = j * T::CK;
    issue_stage<MT, NT, WN, NW>(p, W, C, t, c0, min(T::CK, C8 - c0), kStream && t == 0, b0,
                                nS, wring + (st % kStages) * T::CK * T::ldw,
                                xring + (j % kStages) * xslot_floats);
  };
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for every thread; stage st - 1's slot is free,
                      // refilled with stage st + kStages - 1 below
    const int j = st / taps, t = st - j * taps, c0 = j * T::CK;
    const float* A =
        kStream ? xring + (j % kStages) * xslot_floats + t * lda : hs + c0 + t * lda;
    const float* Wt = wring + (st % kStages) * T::CK * T::ldw + 2 * q * T::ldw + ncol0 + g;
    if (C8 - c0 >= T::CK) {
#pragma unroll
      for (int ks = 0; ks < T::CK / 8; ++ks)
        mma_step<MT, NT, T::ldw>(A + 8 * ks, aoff, Wt + 8 * ks * T::ldw, acc);
    } else {  // the last, partial chunk
#pragma unroll 1
      for (int ks = 0; ks < (C8 - c0) / 8; ++ks)
        mma_step<MT, NT, T::ldw>(A + 8 * ks, aoff, Wt + 8 * ks * T::ldw, acc);
    }
    // the next copies go out behind this stage's MMAs, not all at once after
    // the barrier
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// GroupNorm statistics of the interior rows of hs, one warp per (sample,
// group): st[2 * (s*G + g)] = mean, st[2 * (s*G + g) + 1] = 1/sqrt(var + eps).
// Lane l reads elements l, l + 32, ... of the group's H x Cg block; their
// (row, column) advance by 32 = qs * Cg + rs without a division.
template <int LDH, int NW>
__device__ void group_stats(const Params& p, const float* hs, float* st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = p.K / 2, SP = p.H + P;
  const int Cg = p.Cout / p.G, n = p.H * Cg;
  const int qs = 32 / Cg, rs = 32 - qs * Cg, h0 = lane / Cg, c0 = lane - h0 * Cg;
  for (int task = warp; task < p.S * p.G; task += NW) {
    const int s = task / p.G, g = task - s * p.G;
    const float* base = hs + (P + s * SP) * LDH + g * Cg;
    float sum = 0.0f;
    for (int e = lane, h = h0, c = c0; e < n; e += 32) {
      sum += base[h * LDH + c];
      h += qs, c += rs;
      if (c >= Cg) c -= Cg, ++h;
    }
    const float mean = warp_sum(sum) / n;
    float var = 0.0f;
    for (int e = lane, h = h0, c = c0; e < n; e += 32) {
      const float d = base[h * LDH + c] - mean;
      var = fmaf(d, d, var);
      h += qs, c += rs;
      if (c >= Cg) c -= Cg, ++h;
    }
    var = warp_sum(var) / n;
    if (lane == 0) {
      st[2 * task] = mean;
      st[2 * task + 1] = rsqrtf(var + p.eps);
    }
  }
}

// Accumulators plus bias into the interior rows of hs (columns < Cout).
template <int MT, int NT, int LDH>
__device__ __forceinline__ void store_tile(const Params& p, float* hs, const int (&orow)[MT][2],
                                           int ncol0, const float* __restrict__ bias,
                                           const float (&acc)[MT][NT][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = ncol0 + j * 8 + 2 * q;
    if (n >= p.Cout) continue;
    const float bx = bias[n], by = bias[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(hs + orow[i][hf] * LDH + n) =
            make_float2(acc[i][j][2 * hf] + bx, acc[i][j][2 * hf + 1] + by);
  }
}

template <int MT, int NT, int WN, int NW>
__global__ void __launch_bounds__(32 * NW)
film_resblock_kernel(const Params p) {
  using T = Tile<MT, NT, WN, NW>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                    // rows x ldh hidden tile
  float* st = hs + p.rows * T::ldh;                    // S x G x 2 statistics
  float* wring = st + round_up(2 * p.S * p.G, 4);      // kStages x CK x ldw
  float* xring = wring + kStages * T::CK * T::ldw;     // kStages x rows x ldx
  const int P = p.K / 2, SP = p.H + P;
  const int b0 = blockIdx.x * p.S;
  const int nS = min(p.S, p.B - b0);  // samples of this block that exist

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int ncol0 = wn * NT * 8;  // the warp's first output channel
  int orow[MT][2], srow[MT][2];  // tile row and sample of each fragment row
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 16 * MT + i * 16 + hf * 8 + g;
      srow[i][hf] = r / p.H;
      orow[i][hf] = P + srow[i][hf] * SP + r - srow[i][hf] * p.H;  // P + s*SP + h
    }

  // The hidden tile's gap rows are conv2's zero padding; weight columns
  // past Cout are never written by the copies and must read as zero.
  for (int e = threadIdx.x; e < p.rows * T::ldh / 4; e += T::kThreads)
    reinterpret_cast<float4*>(hs)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (T::Cp > p.Cout) {
    const int pad = T::Cp - p.Cout;
    for (int e = threadIdx.x; e < kStages * T::CK * pad; e += T::kThreads) {
      const int r = e / pad;
      wring[r * T::ldw + p.Cout + (e - r * pad)] = 0.0f;
    }
  }

  float acc[MT][NT][4];
  // ---- conv1 -> hs
  conv_pass<MT, NT, WN, NW, true>(p, p.w1, p.Cin, p.K, P, nullptr, orow, ncol0, b0, nS, wring,
                                  xring, acc);
  store_tile<MT, NT, T::ldh>(p, hs, orow, ncol0, p.b1, acc);
  __syncthreads();
  group_stats<T::ldh, NW>(p, hs, st);
  __syncthreads();

  // ---- GN affine, mish, FiLM, in place: lanes over channels, warps over
  // rows (sample s, step h, advanced by NW = qh * H + rh without a division)
  const int Cg = p.Cout / p.G;
  const int ld_emb = p.film_scale ? 2 * p.Cout : p.Cout;
  const int qh = NW / p.H, rh = NW - qh * p.H, s0 = warp / p.H, h0 = warp - s0 * p.H;
  for (int c = lane; c < p.Cout; c += 32) {
    const float* stat = st + 2 * (c / Cg);
    const float gs = p.g1s[c], gb = p.g1b[c];
    for (int s = s0, h = h0; s < nS;) {
      float* v = hs + (P + s * SP + h) * T::ldh + c;
      const float* sg = stat + 2 * s * p.G;
      const float m = mish((*v - sg[0]) * sg[1] * gs + gb);
      const float* e_row = p.emb + (size_t)(b0 + s) * ld_emb + c;
      *v = p.film_scale ? fmaf(e_row[0], m, e_row[p.Cout]) : m + e_row[0];
      s += qh, h += rh;
      if (h >= p.H) h -= p.H, ++s;
    }
  }
  __syncthreads();

  // ---- conv2 from hs; its output replaces hs once every warp has read it
  conv_pass<MT, NT, WN, NW, false>(p, p.w2, p.Cout, p.K, P, hs, orow, ncol0, b0, nS, wring,
                                   xring, acc);
  store_tile<MT, NT, T::ldh>(p, hs, orow, ncol0, p.b2, acc);
  __syncthreads();
  group_stats<T::ldh, NW>(p, hs, st);
  __syncthreads();

  // ---- skip: a 1x1 conv over the centre rows, x streamed again
  if (p.wskip != nullptr)
    conv_pass<MT, NT, WN, NW, true>(p, p.wskip, p.Cin, 1, 0, nullptr, orow, ncol0, b0, nS,
                                    wring, xring, acc);

  // ---- out = mish(GN(h)) + skip
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = ncol0 + j * 8 + 2 * q;
    if (n >= p.Cout) continue;
    const int gi[2] = {n / Cg, (n + 1) / Cg};
    const float gs[2] = {p.g2s[n], p.g2s[n + 1]}, gb[2] = {p.g2b[n], p.g2b[n + 1]};
    const float bk[2] = {p.wskip ? p.bskip[n] : 0.0f, p.wskip ? p.bskip[n + 1] : 0.0f};
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = srow[i][hf];
        if (s >= nS) continue;
        const int row = orow[i][hf];
        const size_t o = ((size_t)b0 * p.H + row - P - s * P) * p.Cout + n;  // (b0+s, h, n)
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* stat = st + 2 * (s * p.G + gi[u]);
          v[u] = mish((hs[row * T::ldh + n + u] - stat[0]) * stat[1] * gs[u] + gb[u]);
        }
        if (p.wskip != nullptr) {
          v[0] += acc[i][j][2 * hf] + bk[0];
          v[1] += acc[i][j][2 * hf + 1] + bk[1];
        } else {
          const float2 xv = *reinterpret_cast<const float2*>(p.x + o);
          v[0] += xv.x;
          v[1] += xv.y;
        }
        *reinterpret_cast<float2*>(p.out + o) = make_float2(v[0], v[1]);
      }
  }
}

template <int MT, int NT, int WN, int NW>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
  auto kernel = film_resblock_kernel<MT, NT, WN, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + pl.S - 1) / pl.S;
  kernel<<<grid, 32 * NW, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output rows one thread block owns for this Cout (its samples are BM / H),
// or -1 if the kernel does not take the Cout.
int film_resblock_block_rows(int Cout) {
  if (Cout <= 0 || Cout % 8 != 0 || Cout > kMaxCout) return -1;
  int MT, NT, WN, NW, BM;
  warp_tiling(Cout, &MT, &NT, &WN, &NW, &BM);
  return BM;
}

// Dynamic shared memory one block needs for this shape, or -1 if the
// kernel does not take it.
long long film_resblock_smem_bytes(int B, int H, int Cin, int Cout, int K, int G) {
  Plan pl;
  if (!make_plan(B, H, Cin, Cout, K, G, &pl)) return -1;
  return (long long)pl.smem;
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
  Plan pl;
  if (!make_plan(B, H, Cin, Cout, K, G, &pl) || (wskip == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.emb = static_cast<const float*>(emb);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.g1s = static_cast<const float*>(g1s);
  p.g1b = static_cast<const float*>(g1b);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.g2s = static_cast<const float*>(g2s);
  p.g2b = static_cast<const float*>(g2b);
  p.wskip = static_cast<const float*>(wskip);
  p.bskip = static_cast<const float*>(bskip);
  p.out = static_cast<float*>(out);
  p.B = B, p.H = H, p.Cin = Cin, p.Cout = Cout, p.K = K, p.G = G, p.film_scale = film_scale;
  p.eps = eps;
  p.S = pl.S, p.rows = pl.rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_key(pl.MT, pl.NT, pl.WN, pl.NW)) {
#define FILM_LAUNCH(MT, NT, WN, NW) \
  case tile_key(MT, NT, WN, NW): return (int)launch<MT, NT, WN, NW>(p, pl, st);
    FILM_TILES(FILM_LAUNCH)
#undef FILM_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
