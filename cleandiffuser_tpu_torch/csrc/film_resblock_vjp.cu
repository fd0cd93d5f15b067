// The FiLM Conv1d residual block's vector-Jacobian product with respect to
// x, float32, for NVIDIA Hopper (sm_90a): a forward that keeps what the
// input gradient needs (`film_vjp_forward_f32`) and the input gradient
// (`film_vjp_input_grad_f32`). The math is `film_resblock_reference` in
// cleandiffuser_tpu_torch/ops/film_resblock.py (FiLM add), channels-last:
//
//     a1  = conv1(x) + b1,  n1 = (a1 - mean) * r1,  y1 = n1 * g1s + g1b
//     h   = mish(y1) + emb                             conv: K taps, SAME (K odd)
//     a2  = conv2(h) + b2,  n2 = (a2 - mean) * r2,  y2 = n2 * g2s + g2b
//     out = mish(y2) + (x @ wskip + bskip, or x when there is no skip conv)
//
// GroupNorm statistics per (sample, group) over (H, C/G), two-pass; r is
// 1 / sqrt(var + eps). Where x needs a gradient the forward also writes n1,
// n2 (B, H, Cout) and r1, r2 (B, G); under no_grad it writes only out.
// Given gout = d logp / d out, the input gradient is, with
// gn'(d, n, r) = r * (d - mean(d) - n * mean(d * n)) over each group:
//
//     da2 = gn'(gout * mish'(y2) * g2s, n2, r2)
//     dh  = conv2^T(da2)                    taps reversed, Cin and Cout swapped
//     da1 = gn'(dh * mish'(y1) * g1s, n1, r1)
//     dx  = conv1^T(da1) + (gout @ wskip^T, or gout)
//
// The FiLM add passes the gradient through unchanged; no gradient is formed
// for emb or for any weight (the classifier's own training keeps the plain
// block, ops/film_resblock_vjp.py).
//
// Why it exists. It replaces no TPU kernel: the JAX package differentiates
// the classifier through XLA. On the H100 the Diffuser plan's classifier
// guidance (its half U-Net's forward under grad and the input gradient at
// every sampler step) took 74 % of the device's time in a plan, on cuDNN's
// f32 dgrad and PyTorch's GroupNorm backward, at about 5 TFLOP/s, where K3
// (csrc/film_resblock.cu) runs the U-Net's blocks of the same widths at
// about 25.
//
// What bounds it on this card. The blocks are small per sample (H = 2..64
// rows, 23..512 channels) and the batch large (B = 3200 candidates):
// 2*K*H*(Cin + Cout)*Cout flops per sample each way against a few KB of
// activations. Both kernels keep every intermediate in shared memory, so
// device memory sees, forward, x, emb in and out, n1, n2, r1, r2 out and,
// backward, gout, n1, n2, r1, r2 in and dx out (n1 and n2 are read again
// from the L2 in the same thread block, a few hundred KB at a time). What
// is left is the tensor-core work, three TF32 MMAs per f32 product, the
// staging of weights and the GroupNorm / Mish phases, as in K3.
//
// Design.
// - The forward is K3's f32 design (see its note): a thread block owns the
//   output rows of whole samples (BM = 64; 32 when a width exceeds 256) and
//   every channel, both GroupNorms' statistics stay in shared memory, and
//   the residuals are written from the phases that already hold them.
// - The input gradient owns whole samples too, so both GroupNorm backward
//   reductions (two sums per (sample, group)) are one warp each, in shared
//   memory, with no second pass and no atomics; a fixed order everywhere, so
//   a plan repeats bit for bit. Its three GEMMs (conv2^T, conv1^T and the
//   skip^T) contract over Cout and share one warp tiling over
//   max(Cin, Cout) output channels; a warp whose channels all lie past a
//   pass's width skips its MMAs there, and columns past Cin are never
//   stored (the first block's gradient has 23 channels).
// - Every product is 3xTF32 on `mma.sync.m16n8k8` (split as K3 splits:
//   f32-class accuracy at three MMAs per product); the configuration is f32
//   with TF32 off, and one TF32 pass is a lower precision.
// - `mma.sync` rather than `wgmma`. The transposed weights are K-major
//   B, the layout TF32 `wgmma` wants, but A is the gradient tile shifted by
//   a tap per row, which a `wgmma` shared-memory descriptor cannot address,
//   so A would come from registers, and 3xTF32 would need the hi and lo
//   parts of every staged weight tile as two more tiles in shared memory.
//   K3's measurements on the same widths show the MMA loop keeps the tensor
//   pipe only about a third busy: the barriers per stage, the copies and
//   the elementwise phases bound these blocks, which `wgmma` does not
//   remove. So the backward takes K3's proven `mma.sync` loop.
// - Weights stream through a shared-memory ring of kStages tiles by
//   cp.async, as in K3. The input gradient stages w[tap, :, c0:c0+CK] for
//   the reversed tap: output channel rows, CK contraction columns, so a
//   thread's B pair for an MMA step is one 8-byte load; rows are strided by
//   an odd multiple of 8 floats, conflict-free.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;  // cp.async ring depth
constexpr int kMaxC = 512;

struct Params {
  const float *x, *emb, *w1, *b1, *g1s, *g1b, *w2, *b2, *g2s, *g2b, *wskip, *bskip;
  float* out;
  // the residuals: written by the forward (null: not kept), read by the
  // input gradient
  float *n1, *r1, *n2, *r2;
  const float* gout;  // d logp / d out (B, H, Cout), the input gradient's input
  float* dx;          // d logp / d x (B, H, Cin)
  int B, H, Cin, Cout, K, G;
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
// warp, NW warps of which WN along N. kT: the input gradient's layout (the
// weights staged transposed, output-channel rows of CK columns).
template <int MT, int NT, int WN, int NW, bool kT>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int BM = 16 * MT * (NW / WN);  // output rows of a block
  static constexpr int Cp = 8 * NT * WN;          // output channels padded to the warp grid
  // contraction channels per stage: weight tiles of 8-16 KB (K3's measure)
  static constexpr int CK = kT ? (Cp >= 256 ? 8 : Cp >= 128 ? 16 : Cp >= 64 ? 32 : 64)
                               : (Cp >= 512 ? 8 : Cp >= 128 ? 16 : Cp >= 64 ? 32 : 64);
  // weight tile rows: forward, CK rows of Cp + 4 (conflict-free b loads);
  // transposed, Cp rows of an odd multiple of 8 (conflict-free b pairs)
  static constexpr int ldw = kT ? odd8_stride(CK) : Cp + 4;
  static constexpr int wslot = kT ? Cp * ldw : CK * ldw;  // floats of a weight stage
  static constexpr int ldx = odd8_stride(CK);             // streamed chunk rows
  static size_t smem_bytes(int S, int rows, int G, int ldh) {
    // the input gradient keeps no statistics tile: its sums stay in registers
    return sizeof(float) * ((size_t)rows * ldh + (kT ? 0 : round_up(2 * S * G, 4)) +
                            (size_t)kStages * wslot + (size_t)kStages * rows * ldx);
  }
};

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// Warp tiling for N output channels (K3's): MT m16 tiles and NT n8 tiles per
// warp, NW warps of which WN along N, BM = 16 * MT * (NW / WN) rows. N <= 128
// fits two 8-warp blocks per SM; N = 256 one of 16 warps; N = 512 8 warps of
// 32 rows.
void warp_tiling(int N, int* MT, int* NT, int* WN, int* NW, int* BM) {
  const int ntiles = (N + 7) / 8;
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
#define VJP_TILES(X) \
  X(1, 1, 2, 8) X(1, 2, 2, 8) X(1, 4, 2, 8) X(2, 4, 4, 8) X(2, 4, 8, 16) X(2, 8, 8, 8)
constexpr int tile_key(int MT, int NT, int WN, int NW) {
  return ((MT * 16 + NT) * 16 + WN) * 32 + NW;
}

template <int MT, int NT, int WN, int NW, bool kT>
size_t smem_of(const Plan& pl, int G, int Cout) {
  using T = Tile<MT, NT, WN, NW, kT>;
  return T::smem_bytes(pl.S, pl.rows, G, odd8_stride(kT ? Cout : T::Cp));
}

// The forward tiles by Cout; the input gradient by its widest GEMM output,
// max(Cin, Cout).
bool make_plan(bool backward, int B, int H, int Cin, int Cout, int K, int G, Plan* pl) {
  if (B <= 0 || H <= 0 || Cin <= 0 || Cin > kMaxC || K <= 0 || K % 2 == 0 || G <= 0 ||
      Cout <= 0 || Cout % 8 != 0 || Cout > kMaxC || Cout % G != 0)
    return false;
  const int N = backward ? (Cin > Cout ? Cin : Cout) : Cout;
  warp_tiling(N, &pl->MT, &pl->NT, &pl->WN, &pl->NW, &pl->BM);
  if (pl->BM % H != 0) return false;  // a block owns whole samples
  pl->S = pl->BM / H;
  pl->rows = pl->S * (H + K / 2) + K / 2;
  switch (tile_key(pl->MT, pl->NT, pl->WN, pl->NW)) {
#define VJP_SMEM(MT, NT, WN, NW)                                                      \
  case tile_key(MT, NT, WN, NW):                                                      \
    pl->smem = backward ? smem_of<MT, NT, WN, NW, true>(*pl, G, Cout)                 \
                        : smem_of<MT, NT, WN, NW, false>(*pl, G, Cout);               \
    return true;
    VJP_TILES(VJP_SMEM)
#undef VJP_SMEM
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

// v ~= hi + lo, hi = v rounded to TF32 (nearest, ties away), lo = v - hi,
// exact in f32; hi*b_hi + hi*b_lo + lo*b_hi misses v*b by ~2^-21 relative
// (K3's split).
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

// mish'(v) = tanh(sp) + v sigmoid(v) (1 - tanh(sp)^2), sp = log(1 + e^v);
// with e = e^v, n = e (e + 2), w = 1 / (n + 2): tanh(sp) = n w and
// sigmoid(v) (1 - tanh(sp)^2) = 4 e (e + 1) w^2. Past v = 20 it is 1 in f32.
__device__ __forceinline__ float mish_grad(float v) {
  const float e = __expf(fminf(v, 20.0f));
  const float n = e * (e + 2.0f);
  const float w = 1.0f / (n + 2.0f);
  return fmaf(n, w, 4.0f * v * e * (e + 1.0f) * w * w);
}

// One 8-channel step of the implicit GEMM in 3xTF32, all NT n-tiles.
// A: this step's column 0 of the A tile, already shifted by the tap;
// aoff[i][0/1]: offset of the thread's rows g and g + 8 of m-tile i, plus 2q.
// Within a step, channel 2q is the MMA's k = q and 2q + 1 its k = q + 4, for
// A and B alike. W, forward: row 2q of this step in the staged tile (row =
// contraction channel) at the warp's first column + g, so b = W[8j],
// W[8j + LDW]; transposed (kT): the row of output channel (the warp's first
// + g) at this step's column 2q, so b is the pair at W + 8j * LDW.
template <int MT, int NT, int LDW, bool kT>
__device__ __forceinline__ void mma_step(const float* A, const int (&aoff)[MT][2], const float* W,
                                         float (&acc)[MT][NT][4]) {
  uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (kT) {
      const float2 b = *reinterpret_cast<const float2*>(W + j * 8 * LDW);
      split_tf32(b.x, bhi[j][0], blo[j][0]);
      split_tf32(b.y, bhi[j][1], blo[j][1]);
    } else {
      split_tf32(W[j * 8], bhi[j][0], blo[j][0]);
      split_tf32(W[j * 8 + LDW], bhi[j][1], blo[j][1]);
    }
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

// What one conv pass computes: out[r, n] (+)= sum over taps t and contraction
// channels c < C of A[r - shift + t, c] * w(t, c, n), n < N. Forward, W is
// (taps, C, N), N contiguous; transposed (kT), W is (taps, N, C), C
// contiguous, read at the reversed tap (taps - 1 - t): conv^T. A is streamed
// from `src` (Csrc channels, (B, H, Csrc)) in CK-channel chunks, or is the
// resident halo tile hs.
struct Pass {
  const float* W;
  int C, N, taps, shift;
  const float* src;
  int Csrc;
};

// Stage st of a pass: contraction channels [c0, c0 + ncols) of tap t into
// wslot (forward: rows past C zero) and, when load_x, those channels of the
// block's samples from src into xslot with the halo layout (gaps and missing
// samples zero), by cp.async.
template <int MT, int NT, int WN, int NW, bool kT>
__device__ __forceinline__ void issue_stage(const Params& p, const Pass& ps, int t, int c0,
                                            int ncols, bool load_x, int b0, int nS, float* wslot,
                                            float* xslot) {
  using T = Tile<MT, NT, WN, NW, kT>;
  if (kT) {
    // N rows of ncols (a multiple of 8: C = Cout) contiguous floats
    const float* Wt = ps.W + (size_t)(ps.taps - 1 - t) * ps.N * ps.C + c0;
    const int per_row = ncols / 4, rstep = T::kThreads / per_row;
    const int r0 = threadIdx.x / per_row, cc = 4 * (threadIdx.x - r0 * per_row);
    if (r0 < rstep)
      for (int n = r0; n < ps.N; n += rstep)
        cp_async16(wslot + n * T::ldw + cc, Wt + (size_t)n * ps.C + cc, true);
  } else {
    // ncols rows of N (= Cout) floats; a thread copies one 16-byte piece of
    // every rstep-th row
    const int per_row = ps.N / 4, rstep = T::kThreads / per_row;
    const int r0 = threadIdx.x / per_row, cc = 4 * (threadIdx.x - r0 * per_row);
    if (r0 < rstep) {
      for (int r = r0; r < ncols; r += rstep) {
        const int c = c0 + r;
        const bool full = c < ps.C;
        const float* src = full ? ps.W + ((size_t)t * ps.C + c) * ps.N + cc : ps.W;
        cp_async16(wslot + r * T::ldw + cc, src, full);
      }
    }
  }
  if (!load_x) return;
  const int P = p.K / 2, SP = p.H + P;
  const bool vec = ps.Csrc % 4 == 0;  // 16-byte copies need 16-byte aligned rows
  const int per_x = vec ? ncols / 4 : ncols;
  for (int e = threadIdx.x; e < p.rows * per_x; e += T::kThreads) {
    const int tr = e / per_x, xc = (vec ? 4 : 1) * (e - tr * per_x);
    const int tt = tr - P;
    const int s = tt / SP, h = tt - s * SP;
    const int c = c0 + xc;
    const bool full = tt >= 0 && h < p.H && s < nS && c < ps.Csrc;
    const float* src = full ? ps.src + ((size_t)(b0 + s) * p.H + h) * ps.Csrc + c : ps.src;
    if (vec)
      cp_async16(xslot + tr * T::ldx + xc, src, full);
    else
      cp_async4(xslot + tr * T::ldx + xc, src, full);
  }
}

// acc (+)= the pass (Pass) for the thread's fragment rows orow and columns
// ncol0 + 8j + (g or 2q); kStream: A streamed from ps.src, else the resident
// hs (row stride ldh). A warp whose first column is at or past N skips the
// MMAs (it still copies and meets every barrier). Ends with every copy
// landed and a block barrier, so the ring is free for the next pass.
template <int MT, int NT, int WN, int NW, bool kT, bool kStream>
__device__ void conv_pass(const Params& p, const Pass& ps, bool zero, const float* hs, int ldh,
                          const int (&orow)[MT][2], int ncol0, int b0, int nS, float* wring,
                          float* xring, float (&acc)[MT][NT][4]) {
  using T = Tile<MT, NT, WN, NW, kT>;
  const int lda = kStream ? T::ldx : ldh;
  const int lane = threadIdx.x & 31, q = lane & 3, g = lane >> 2;
  if (zero) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
  }
  int aoff[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) aoff[i][hf] = (orow[i][hf] - ps.shift) * lda + 2 * q;
  const bool live = ncol0 < ps.N;

  const int C8 = round_up(ps.C, 8);
  const int nchunks = (C8 + T::CK - 1) / T::CK;
  const int nst = nchunks * ps.taps;
  const int xslot_floats = p.rows * T::ldx;
  auto issue = [&](int st) {
    const int j = st / ps.taps, t = st - j * ps.taps, c0 = j * T::CK;
    issue_stage<MT, NT, WN, NW, kT>(p, ps, t, c0, min(T::CK, C8 - c0), kStream && t == 0, b0,
                                    nS, wring + (st % kStages) * T::wslot,
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
    const int j = st / ps.taps, t = st - j * ps.taps, c0 = j * T::CK;
    const float* A =
        kStream ? xring + (j % kStages) * xslot_floats + t * lda : hs + c0 + t * lda;
    const float* slot = wring + (st % kStages) * T::wslot;
    const float* Wt = kT ? slot + (ncol0 + g) * T::ldw + 2 * q : slot + 2 * q * T::ldw + ncol0 + g;
    // one 8-channel step advances the tile by 8 columns (kT) or 8 rows
    constexpr int kStep = kT ? 8 : 8 * T::ldw;
    if (live) {
      if (C8 - c0 >= T::CK) {
#pragma unroll
        for (int ks = 0; ks < T::CK / 8; ++ks)
          mma_step<MT, NT, T::ldw, kT>(A + 8 * ks, aoff, Wt + ks * kStep, acc);
      } else {  // the last, partial chunk
#pragma unroll 1
        for (int ks = 0; ks < (C8 - c0) / 8; ++ks)
          mma_step<MT, NT, T::ldw, kT>(A + 8 * ks, aoff, Wt + ks * kStep, acc);
      }
    }
    // the next copies go out behind this stage's MMAs
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// GroupNorm statistics of the interior rows of hs, one warp per (sample,
// group): st[2 * (s*G + g)] = mean, st[2 * (s*G + g) + 1] = 1/sqrt(var + eps);
// with r (a residual) also r[(b0 + s) * G + g] for the samples that exist.
// Lane l reads elements l, l + 32, ... of the group's H x Cg block; their
// (row, column) advance by 32 = qs * Cg + rs without a division.
template <int LDH, int NW>
__device__ void group_stats(const Params& p, const float* hs, float* st, float* r, int b0,
                            int nS) {
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
      const float rstd = rsqrtf(var + p.eps);
      st[2 * task] = mean;
      st[2 * task + 1] = rstd;
      if (r != nullptr && s < nS) r[(size_t)(b0 + s) * p.G + g] = rstd;
    }
  }
}

// Accumulators (plus bias, where given) into the interior rows of hs,
// columns < N.
template <int MT, int NT>
__device__ __forceinline__ void store_tile(float* hs, int ldh, int N, const int (&orow)[MT][2],
                                           int ncol0, const float* __restrict__ bias,
                                           const float (&acc)[MT][NT][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = ncol0 + j * 8 + 2 * q;
    if (n >= N) continue;
    const float bx = bias ? bias[n] : 0.0f, by = bias ? bias[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(hs + orow[i][hf] * ldh + n) =
            make_float2(acc[i][j][2 * hf] + bx, acc[i][j][2 * hf + 1] + by);
  }
}

// The GroupNorm and Mish part of the input gradient, in place in hs, one
// warp per (sample, group) of the samples that exist: d = (src, or hs where
// src is null) * mish'(n * gs + gb) * gs, then
// hs = r * (d - mean(d) - n * mean(d * n)). n is the residual (B, H, Cout),
// r (B, G). The lane that writes an element reads it back, so the two loops
// need no barrier between them.
template <int NW>
__device__ void gn_input_grad(const Params& p, float* hs, int ldh, const float* src,
                              const float* __restrict__ nres, const float* __restrict__ rres,
                              const float* __restrict__ gs, const float* __restrict__ gb, int b0,
                              int nS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = p.K / 2, SP = p.H + P;
  const int Cg = p.Cout / p.G, cnt = p.H * Cg;
  const int qs = 32 / Cg, rs = 32 - qs * Cg, h0 = lane / Cg, c0 = lane - h0 * Cg;
  for (int task = warp; task < nS * p.G; task += NW) {
    const int s = task / p.G, g = task - s * p.G;
    float* base = hs + (P + s * SP) * ldh + g * Cg;
    const size_t gbase = (size_t)(b0 + s) * p.H * p.Cout + g * Cg;
    const float* gsg = gs + g * Cg;
    const float* gbg = gb + g * Cg;
    float s1 = 0.0f, s2 = 0.0f;
    for (int e = lane, h = h0, c = c0; e < cnt; e += 32) {
      const size_t o = gbase + (size_t)h * p.Cout + c;
      const float nv = nres[o];
      const float v = src ? src[o] : base[h * ldh + c];
      const float d = v * mish_grad(fmaf(nv, gsg[c], gbg[c])) * gsg[c];
      base[h * ldh + c] = d;
      s1 += d;
      s2 = fmaf(d, nv, s2);
      h += qs, c += rs;
      if (c >= Cg) c -= Cg, ++h;
    }
    const float m1 = warp_sum(s1) / cnt, m2 = warp_sum(s2) / cnt;
    const float r = rres[(size_t)(b0 + s) * p.G + g];
    for (int e = lane, h = h0, c = c0; e < cnt; e += 32) {
      const float nv = nres[gbase + (size_t)h * p.Cout + c];
      float* v = base + h * ldh + c;
      *v = r * (*v - m1 - nv * m2);
      h += qs, c += rs;
      if (c >= Cg) c -= Cg, ++h;
    }
  }
}

// Tile row and sample of each of the thread's fragment rows.
template <int MT, int WN>
__device__ __forceinline__ void fragment_rows(const Params& p, int (&orow)[MT][2],
                                              int (&srow)[MT][2]) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int wm = warp / WN, P = p.K / 2, SP = p.H + P;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 16 * MT + i * 16 + hf * 8 + g;
      srow[i][hf] = r / p.H;
      orow[i][hf] = P + srow[i][hf] * SP + r - srow[i][hf] * p.H;  // P + s*SP + h
    }
}

// ---------------------------------------------------------------------------
// The forward, K3's f32 design; with p.n1 set it also writes n1, r1, n2, r2.
template <int MT, int NT, int WN, int NW>
__global__ void __launch_bounds__(32 * NW) film_vjp_forward(const Params p) {
  using T = Tile<MT, NT, WN, NW, false>;
  constexpr int ldh = odd8_stride(T::Cp);
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                    // rows x ldh hidden tile
  float* st = hs + p.rows * ldh;                       // S x G x 2 statistics
  float* wring = st + round_up(2 * p.S * p.G, 4);      // kStages weight stages
  float* xring = wring + kStages * T::wslot;           // kStages x rows x ldx
  const int P = p.K / 2, SP = p.H + P;
  const int b0 = blockIdx.x * p.S;
  const int nS = min(p.S, p.B - b0);  // samples of this block that exist

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int ncol0 = (warp % WN) * NT * 8;  // the warp's first output channel
  int orow[MT][2], srow[MT][2];
  fragment_rows<MT, WN>(p, orow, srow);

  // The hidden tile's gap rows are conv2's zero padding; weight columns
  // past Cout are never written by the copies and must read as zero.
  for (int e = threadIdx.x; e < p.rows * ldh / 4; e += T::kThreads)
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
  const Pass conv1{p.w1, p.Cin, p.Cout, p.K, P, p.x, p.Cin};
  conv_pass<MT, NT, WN, NW, false, true>(p, conv1, true, nullptr, ldh, orow, ncol0, b0, nS,
                                         wring, xring, acc);
  store_tile<MT, NT>(hs, ldh, p.Cout, orow, ncol0, p.b1, acc);
  __syncthreads();
  group_stats<ldh, NW>(p, hs, st, p.r1, b0, nS);
  __syncthreads();

  // ---- GN affine, mish, FiLM, in place: lanes over channels, warps over
  // rows (sample s, step h, advanced by NW = qh * H + rh without a division)
  const int Cg = p.Cout / p.G;
  const int qh = NW / p.H, rh = NW - qh * p.H, s0 = warp / p.H, h0 = warp - s0 * p.H;
  for (int c = lane; c < p.Cout; c += 32) {
    const float* stat = st + 2 * (c / Cg);
    const float gs = p.g1s[c], gb = p.g1b[c];
    for (int s = s0, h = h0; s < nS;) {
      float* v = hs + (P + s * SP + h) * ldh + c;
      const float* sg = stat + 2 * s * p.G;
      const float nv = (*v - sg[0]) * sg[1];
      if (p.n1 != nullptr) p.n1[((size_t)(b0 + s) * p.H + h) * p.Cout + c] = nv;
      *v = mish(fmaf(nv, gs, gb)) + p.emb[(size_t)(b0 + s) * p.Cout + c];
      s += qh, h += rh;
      if (h >= p.H) h -= p.H, ++s;
    }
  }
  __syncthreads();

  // ---- conv2 from hs; its output replaces hs once every warp has read it
  const Pass conv2{p.w2, p.Cout, p.Cout, p.K, P, nullptr, 0};
  conv_pass<MT, NT, WN, NW, false, false>(p, conv2, true, hs, ldh, orow, ncol0, b0, nS, wring,
                                          xring, acc);
  store_tile<MT, NT>(hs, ldh, p.Cout, orow, ncol0, p.b2, acc);
  __syncthreads();
  group_stats<ldh, NW>(p, hs, st, p.r2, b0, nS);
  __syncthreads();

  // ---- skip: a 1x1 conv over the centre rows, x streamed again
  if (p.wskip != nullptr) {
    const Pass skip{p.wskip, p.Cin, p.Cout, 1, 0, p.x, p.Cin};
    conv_pass<MT, NT, WN, NW, false, true>(p, skip, true, nullptr, ldh, orow, ncol0, b0, nS,
                                           wring, xring, acc);
  }

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
        float v[2], nv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* stat = st + 2 * (s * p.G + gi[u]);
          nv[u] = (hs[row * ldh + n + u] - stat[0]) * stat[1];
          v[u] = mish(fmaf(nv[u], gs[u], gb[u]));
        }
        if (p.n2 != nullptr) *reinterpret_cast<float2*>(p.n2 + o) = make_float2(nv[0], nv[1]);
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

// ---------------------------------------------------------------------------
// The input gradient: dx from gout and the residuals.
template <int MT, int NT, int WN, int NW>
__global__ void __launch_bounds__(32 * NW) film_vjp_input_grad(const Params p) {
  using T = Tile<MT, NT, WN, NW, true>;
  const int ldh = odd8_stride(p.Cout);
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                    // rows x ldh gradient tile
  float* wring = hs + p.rows * ldh;                    // kStages weight stages
  float* xring = wring + kStages * T::wslot;           // kStages x rows x ldx
  const int P = p.K / 2;
  const int b0 = blockIdx.x * p.S;
  const int nS = min(p.S, p.B - b0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int ncol0 = (warp % WN) * NT * 8;
  int orow[MT][2], srow[MT][2];
  fragment_rows<MT, WN>(p, orow, srow);

  // gap rows are the transposed convs' zero padding, and missing samples'
  // rows stay zero
  for (int e = threadIdx.x; e < p.rows * ldh / 4; e += T::kThreads)
    reinterpret_cast<float4*>(hs)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // ---- da2 = gn'(gout * mish'(y2) * g2s) into hs
  gn_input_grad<NW>(p, hs, ldh, p.gout, p.n2, p.r2, p.g2s, p.g2b, b0, nS);
  __syncthreads();

  // ---- dh = conv2^T(da2), then da1 = gn'(dh * mish'(y1) * g1s), in hs
  float acc[MT][NT][4];
  const Pass conv2t{p.w2, p.Cout, p.Cout, p.K, P, nullptr, 0};
  conv_pass<MT, NT, WN, NW, true, false>(p, conv2t, true, hs, ldh, orow, ncol0, b0, nS, wring,
                                         xring, acc);
  store_tile<MT, NT>(hs, ldh, p.Cout, orow, ncol0, nullptr, acc);
  __syncthreads();
  gn_input_grad<NW>(p, hs, ldh, nullptr, p.n1, p.r1, p.g1s, p.g1b, b0, nS);
  __syncthreads();

  // ---- dx = conv1^T(da1) + gout @ wskip^T (gout streamed) or + gout
  const Pass conv1t{p.w1, p.Cout, p.Cin, p.K, P, nullptr, 0};
  conv_pass<MT, NT, WN, NW, true, false>(p, conv1t, true, hs, ldh, orow, ncol0, b0, nS, wring,
                                         xring, acc);
  if (p.wskip != nullptr) {
    const Pass skipt{p.wskip, p.Cout, p.Cin, 1, 0, p.gout, p.Cout};
    conv_pass<MT, NT, WN, NW, true, true>(p, skipt, false, nullptr, ldh, orow, ncol0, b0, nS,
                                          wring, xring, acc);
  }
  if (ncol0 >= p.Cin) return;
  const bool pair = p.Cin % 2 == 0;  // dx rows 8-byte aligned
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = ncol0 + j * 8 + 2 * q;
    if (n >= p.Cin) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = srow[i][hf];
        if (s >= nS) continue;
        const size_t row = (size_t)b0 * p.H + orow[i][hf] - P - s * P;  // (b0+s, h)
        float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
        if (p.wskip == nullptr) {  // Cin == Cout
          const float2 gv = *reinterpret_cast<const float2*>(p.gout + row * p.Cout + n);
          v0 += gv.x;
          v1 += gv.y;
        }
        float* d = p.dx + row * p.Cin + n;
        if (pair) {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          d[0] = v0;
          if (n + 1 < p.Cin) d[1] = v1;
        }
      }
  }
}

template <int MT, int NT, int WN, int NW, bool backward>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
  auto kernel = backward ? film_vjp_input_grad<MT, NT, WN, NW> : film_vjp_forward<MT, NT, WN, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + pl.S - 1) / pl.S;
  kernel<<<grid, 32 * NW, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

int run(bool backward, Params& p, cudaStream_t stream) {
  Plan pl;
  if (!make_plan(backward, p.B, p.H, p.Cin, p.Cout, p.K, p.G, &pl) ||
      (p.wskip == nullptr && p.Cin != p.Cout))
    return (int)cudaErrorInvalidValue;
  p.S = pl.S, p.rows = pl.rows;
  switch (tile_key(pl.MT, pl.NT, pl.WN, pl.NW)) {
#define VJP_LAUNCH(MT, NT, WN, NW)                                               \
  case tile_key(MT, NT, WN, NW):                                                 \
    return backward ? (int)launch<MT, NT, WN, NW, true>(p, pl, stream)           \
                    : (int)launch<MT, NT, WN, NW, false>(p, pl, stream);
    VJP_TILES(VJP_LAUNCH)
#undef VJP_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Output rows one thread block owns (its samples are rows / H) for the
// forward (backward = 0) or the input gradient (1), or -1 if the kernel
// does not take the widths.
int film_vjp_block_rows(int backward, int Cin, int Cout) {
  if (Cin <= 0 || Cin > kMaxC || Cout <= 0 || Cout % 8 != 0 || Cout > kMaxC) return -1;
  int MT, NT, WN, NW, BM;
  warp_tiling(backward && Cin > Cout ? Cin : Cout, &MT, &NT, &WN, &NW, &BM);
  return BM;
}

// Dynamic shared memory one block of the forward (backward = 0) or the
// input gradient (1) needs for this shape, or -1 if the kernel does not
// take it.
long long film_vjp_smem_bytes(int backward, int B, int H, int Cin, int Cout, int K, int G) {
  Plan pl;
  if (!make_plan(backward != 0, B, H, Cin, Cout, K, G, &pl)) return -1;
  return (long long)pl.smem;
}

// Most dynamic shared memory a block may opt in to on `device`, or -1.
int film_vjp_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* film_vjp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward. x (B, H, Cin), emb (B, Cout), w1 (K, Cin, Cout), w2 (K, Cout,
// Cout), wskip (Cin, Cout) or null (then Cin == Cout), vectors (Cout,), out
// (B, H, Cout); n1 and n2 (B, H, Cout), r1 and r2 (B, G), all four null (no
// residuals) or none; all f32, contiguous, 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int film_vjp_forward_f32(const void* x, const void* emb, const void* w1, const void* b1,
                         const void* g1s, const void* g1b, const void* w2, const void* b2,
                         const void* g2s, const void* g2b, const void* wskip, const void* bskip,
                         void* out, void* n1, void* r1, void* n2, void* r2, int B, int H,
                         int Cin, int Cout, int K, int G, float eps, void* stream) {
  Params p = {};
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
  if ((n1 == nullptr) != (n2 == nullptr) || (n1 == nullptr) != (r1 == nullptr) ||
      (n1 == nullptr) != (r2 == nullptr))
    return (int)cudaErrorInvalidValue;
  p.n1 = static_cast<float*>(n1);
  p.r1 = static_cast<float*>(r1);
  p.n2 = static_cast<float*>(n2);
  p.r2 = static_cast<float*>(r2);
  p.B = B, p.H = H, p.Cin = Cin, p.Cout = Cout, p.K = K, p.G = G;
  p.eps = eps;
  return run(false, p, static_cast<cudaStream_t>(stream));
}

// The input gradient. gout (B, H, Cout); n1, n2 (B, H, Cout) and r1, r2 (B,
// G) from the forward on the same weights; w1 (K, Cin, Cout), w2 (K, Cout,
// Cout), wskip (Cin, Cout) or null (then Cin == Cout), g1s, g1b, g2s, g2b
// (Cout,); dx (B, H, Cin). All f32, contiguous, 16-byte aligned. Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int film_vjp_input_grad_f32(const void* gout, const void* n1, const void* r1, const void* n2,
                            const void* r2, const void* w1, const void* g1s, const void* g1b,
                            const void* w2, const void* g2s, const void* g2b, const void* wskip,
                            void* dx, int B, int H, int Cin, int Cout, int K, int G,
                            void* stream) {
  Params p = {};
  p.gout = static_cast<const float*>(gout);
  p.n1 = static_cast<float*>(const_cast<void*>(n1));
  p.r1 = static_cast<float*>(const_cast<void*>(r1));
  p.n2 = static_cast<float*>(const_cast<void*>(n2));
  p.r2 = static_cast<float*>(const_cast<void*>(r2));
  p.w1 = static_cast<const float*>(w1);
  p.g1s = static_cast<const float*>(g1s);
  p.g1b = static_cast<const float*>(g1b);
  p.w2 = static_cast<const float*>(w2);
  p.g2s = static_cast<const float*>(g2s);
  p.g2b = static_cast<const float*>(g2b);
  p.wskip = static_cast<const float*>(wskip);
  p.dx = static_cast<float*>(dx);
  p.B = B, p.H = H, p.Cin = Cin, p.Cout = Cout, p.K = K, p.G = G;
  return run(true, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
