// Fused adaLN-Zero DiT block, forward, BF16 weights, for NVIDIA Hopper
// (sm_90a): `dit_block_forward_bf16`. The float32 route is csrc/dit_block.cu.
//
// Replaces the Pallas TPU kernel cleandiffuser_tpu/ops/dit_block.py
// (`fused_dit_block`, body `_kernel`) with BF16 weights and biases (the
// DiT's copy cast by `bf16_sampling` / `bf16_training`); x and mod both f32
// (the bf16 sampler's call: the DiT keeps the residual stream f32) or both
// BF16 (the forward of a `bf16_training` step); the output in x's type. Same
// math as `dit_block_reference` in cleandiffuser_tpu_torch/ops/dit_block.py:
//
//     h   = LN(x) * (1 + scale1) + shift1           LN: eps 1e-6, no affine
//     qkv = h @ wqkv + bqkv                         q scaled by hd^-0.5
//     x   = x + gate1 * (MHA(q, k, v) @ wo + bo)    softmax per trajectory
//     h2  = LN(x) * (1 + scale2) + shift2
//     out = x + gate2 * (gelu_tanh(h2 @ w1 + b1) @ w2 + b2)
//
// What bounds it. A block is B*H*(24*D^2 + 4*H*D) flops on 12*D^2 BF16
// weights (2.46 MB at D = 320): at the bf16 DD plan's (B, H, D) = (100, 32,
// 320) 7.86 GFLOP of weight products at the 989 TFLOP/s BF16 peak and 0.13
// GFLOP of attention at the 495 TF32 peak, 0.0082 ms, against 11.4 MB of
// device memory, 0.0034 ms: the operations. But every 64-row tile streams
// all the weights from the L2 through its SM, and measured on the H100 (700
// W; edited copies of this source, parts removed) one SM takes them in at
// ~62 GB/s whatever the ring's depth (4 or 6 stages) or the TMA box's rows
// (64 or 128 bytes): the products of a tile take ~40 us with no MMA at
// all, ~50 us with them (tools/dit_block_variants.py --route bf16). At the plan's 50
// tiles (50 SMs) that stream and the tile's fixed chain (two LayerNorms, 12
// epilogues, attention, their barriers: ~40 us) make the ~0.09 ms of a
// launch; at B = 3200 (1,600 tiles, 3.9 GB of weight reads) the L2's total
// rate bounds the stream. Two blocks of a cluster splitting each tile's
// columns (each streaming half the weights) ran slower; what caps one SM's
// stream is open.
//
// Design.
// - Tensor cores: `wgmma.mma_async` m64nNk16 BF16 with f32 accumulators in
//   registers for the four weight products, two consumer warpgroups of N
//   output columns each (N = 160, an m64n160 accumulator of 80 registers a
//   thread, for D = 160-320; N = 64 for D <= 128). A and B both come from
//   shared memory by descriptor: A from a BF16 activation tile (K-major,
//   128-byte swizzle, written in that layout by the LayerNorms, attention
//   and the epilogues, each writer then fencing the async proxy); B from the
//   weight ring, MN-major, so the weights keep the JAX layout (in, out) with
//   no copy. (A from registers by ldmatrix gave wrong sums now and then: a
//   later ldmatrix rewrote the registers of a wgmma still in flight.) Every
//   product is D columns wide: q, k and v are three products over wqkv's
//   column blocks, Wo one, and the MLP runs over 4 chunks of D hidden units
//   (W1's chunk, GELU, then the chunk's W2 product added into the
//   residual). The sum runs over the whole K in the f32 accumulators; only
//   the wgmmas write them (a product's first wgmma has scale-d 0), so ptxas
//   keeps them in flight.
// - A tile is 64 rows, one wgmma M: S = floor(64 / H) whole trajectories
//   (two at H = 32, one at H = 33-64, with no cluster); rows past S * H and
//   trajectories past B (a ragged last tile) are zero and never stored; no
//   key past H is weighed. Persistent blocks, one to an SM, each walking
//   tiles b, b + gridDim.x, ...
// - Weights by TMA into a ring of NS >= 4 stages (6 at D = 320), one stage
//   being 16 weight rows (one k16 step) of the product's 2N columns: one
//   `cp.async.bulk.tensor` per stage, through a 3-d view of the weight
//   (32 columns, rows, 32-column blocks), so that the box lands as the
//   64-byte-swizzled MN-major atoms the descriptor reads; columns past the
//   weight are zero-filled by the map's bounds. The four maps are encoded
//   on the host per launch (`cuTensorMapEncodeTiled`, reached through
//   `cudaGetDriverEntryPoint`: no -lcuda) and passed as __grid_constant__
//   parameters, so a captured CUDA graph keeps them. Full and empty
//   mbarriers per stage; the producer warp's first thread issues every
//   stage ahead, across products and tiles. This replaces the mma.sync
//   route's cp.async ring issued by every thread with a block barrier per
//   stage.
// - BF16 activation tiles: h, the attention output, h2 (one tile A) and
//   q, then each MLP chunk's GELU'd hidden units (a second tile) are stored
//   once as BF16: the numbers the BF16 MMA reads anyway, in half the bytes.
//   k and v are stored as BF16 too. LN statistics, softmax, GELU (its tanh
//   on the SFU, below the BF16 rounding that follows), the residual and
//   every sum stay f32.
// - Shared memory (D = 320: ring 60 KB, A 40 KB, the q / hidden tile 40
//   KB, k and v 82 KB; 223 KB): the residual stream is not held while k and
//   v are. The tile's rows of x are staged there first (cp.async, one round
//   trip) for LN1; the Wo epilogue reads x again from the L2 and writes x +
//   gate1 * (o @ wo + bo) as f32 over k and v, which attention no longer
//   needs. The W2 epilogues add into it there; the last writes out. mod is
//   read where it is used, prefetched into the L1 per tile (the biases once
//   per block), so any number of trajectories per tile fits.
// - Attention (1.6 % of the flops at H = 32) on `mma.sync.m16n8k8` TF32:
//   q, k and v are BF16 values, which TF32 holds exactly, so one MMA per
//   product is exact in its products (P is rounded to TF32). One warp per
//   (trajectory, head, 16 query rows); the scores stay in registers, where
//   the softmax is f32 (max-subtracted) over keys < H; S's accumulator
//   fragment is P's A fragment. The output replaces h in A.
// - Warp roles: warps 0-7 are the two consumer warpgroups (products,
//   LayerNorms, attention, epilogues, named barrier 1 among them); warp 8
//   is the producer. ptxas gives the 288 threads 168 registers each (the
//   launch rounded to three warpgroups).
// - Loads that no branch separates: x and mod are templated on their type
//   (no per-element test), the LayerNorms and the epilogues read invalid
//   rows and columns from valid addresses and discard them, so the compiler
//   issues a row's loads together.

#include <math.h>

#include <type_traits>

#include "hopper_sm90.cuh"

namespace {

constexpr int kRows = 64;                 // rows of a tile: one wgmma M
constexpr int kCK = 16;                   // weight rows per stage: one k16 step
constexpr int kAtom = 32;                 // columns of a 64-byte swizzle atom
constexpr int kAtomBytes = kCK * 64;      // an atom's column block in a stage
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kProducts = 12;             // per tile: k, v, q, Wo, then W1 and W2 per MLP chunk
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr int kMaxH = 64, kMaxD = 320, kMaxHd = 64;
constexpr long long kSmemLimit = 232448;  // sm_90: most shared memory a block opts in to

// output columns of each consumer warpgroup at width D: two widths, so that
// the library builds four kernels (and x's two types), not ten; a width
// past D / 2 computes columns past D, which no epilogue stores
__host__ __device__ constexpr int wg_cols(int D) { return D <= 128 ? 64 : 160; }

// Byte offset of element (r, c) in an activation tile, the layout the A
// descriptor reads (K-major, 128-byte swizzle): blocks of 64 columns, each
// 64 rows of 128 bytes (8 KB), a row's 16-byte chunks XORed with r % 8.
__host__ __device__ constexpr uint32_t tile_off(int r, int c) {
  return (uint32_t)((c >> 6) * 8192 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// bytes of an activation tile of D columns
__host__ __device__ constexpr int tile_bytes(int D) { return (D + 63) / 64 * 8192; }

struct Params {
  const void *x, *mod;
  const bf16_t *bqkv, *bo, *b1, *b2;
  void* out;
  int B, H, D, n_heads, hd;
  int S, ld, NS, ntiles;  // the plan: trajectories per tile, row stride, stages, tiles
  uint32_t stage_bytes;
  float q_scale, inv_h;  // inv_h: 1 / H
};

struct Plan {
  int N, S, ld, NS, ntiles;
  long long smem;
};

// ring | A | q, then the hidden chunk | k, v, then the f32 residual | barriers
long long smem_bytes(int N, int D, int ld, int NS) {
  return 1024LL + (long long)NS * 64 * N + 2LL * tile_bytes(D) + 4LL * kRows * ld + 16LL * NS;
}

bool make_plan(int B, int H, int D, int n_heads, Plan* pl) {
  if (B <= 0 || H <= 0 || H > kMaxH || D <= 0 || D % 32 != 0 || D > kMaxD || n_heads <= 0 ||
      D % n_heads != 0 || (D / n_heads) % 8 != 0 || D / n_heads > kMaxHd)
    return false;
  pl->N = wg_cols(D);
  pl->S = kRows / H;
  pl->ld = D + 8;
  pl->ntiles = (B + pl->S - 1) / pl->S;
  if (smem_bytes(pl->N, D, pl->ld, kMinStages) > kSmemLimit) return false;
  pl->NS = kMinStages;
  while (pl->NS < kMaxStages && smem_bytes(pl->N, D, pl->ld, pl->NS + 1) <= kSmemLimit) ++pl->NS;
  pl->smem = smem_bytes(pl->N, D, pl->ld, pl->NS);
  return true;
}

// ---------------------------------------------------------------------------
// device helpers

// 16 bytes device -> shared memory, asynchronously (cp.async, L2 only).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Named barrier 1 over the two consumer warpgroups.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d (64 x N f32, the warpgroup's fragments) = a (64 x 16 BF16, shared
// memory, K-major by `desc_a`) * b (16 x N BF16, shared memory, MN-major by
// `desc_b`), + d unless scale_d is 0.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n160(float (&d)[80], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                      int scale_d) {
  if constexpr (N == 64) wgmma_m64n64(d, desc_a, desc_b, scale_d);
  else wgmma_m64n160(d, desc_a, desc_b, scale_d);
}

// Shared-memory descriptor of an A operand in the activation tile layout:
// 8-row groups SBO = 1024 B apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (the wgmmas' A operands).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a B operand stored MN-major, 64-byte
// swizzled: atoms of 8 rows (k) x 32 columns (64 B), the next 8 rows SBO =
// 512 B on, the next atom along N LBO = kAtomBytes on.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kAtomBytes >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (to nearest, ties away), as the bits the MMA reads
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t d;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(d) : "f"(v));
  return d;
}

// shared-memory loads by 32-bit address (volatile: never moved across the
// barriers around them)
__device__ __forceinline__ uint32_t lds_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_b16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// a BF16 pair (the first at the low half) as f32 bits: also exact TF32
__device__ __forceinline__ uint2 bf16x2_split(uint32_t u) { return make_uint2(u << 16, u & 0xffff0000u); }

// elements i, i + 1 (i even) of x or mod, stored f32 or (XB) BF16
template <bool XB>
__device__ __forceinline__ float2 ldg_act2(const void* p, size_t i) {
  if constexpr (XB) return load_bf16x2(static_cast<const bf16_t*>(p) + i);
  else return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p) + i));
}

// the same, not kept in the L1 (x, read once there, would evict mod and the
// biases)
template <bool XB>
__device__ __forceinline__ float2 ld_stream2(const void* p, size_t i) {
  if constexpr (XB) {
    uint32_t u;
    asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
                 : "=r"(u)
                 : "l"(static_cast<const bf16_t*>(p) + i));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  } else {
    float2 v;
    asm volatile("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y)
                 : "l"(static_cast<const float*>(p) + i));
    return v;
  }
}

// a and b summed over the warp, the two chains interleaved
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
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

// tanh on the SFU: relative error below 2^-10.98, under the BF16 rounding
// of the hidden units that follows
__device__ __forceinline__ float tanh_approx(float v) {
  float d;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(d) : "f"(v));
  return d;
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanh_approx(k * (v + 0.044715f * v * v * v)));
}

// ---------------------------------------------------------------------------
// producer warp

// Its producer, the producer warp's first thread: every weight stage in
// the consumers' order, per tile k, v, q (wqkv's column blocks), Wo, then per
// MLP chunk c its W1 columns and its W2 rows, running ahead into the next
// tile; each stage once the one NS before it in its slot is released.
__device__ void produce(const Params& p, const CUtensorMap* tqkv, const CUtensorMap* two,
                        const CUtensorMap* tw1, const CUtensorMap* tw2, uint32_t ring,
                        uint32_t full0, uint32_t empty0) {
  const int nst = p.D / kCK, da = p.D / kAtom;
  int slot = 0, round = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x)
    for (int product = 0; product < kProducts; ++product) {
      const CUtensorMap* tm = tqkv;
      int atom = 0, row0 = 0;
      if (product == 0) atom = da;           // k
      else if (product == 1) atom = 2 * da;  // v
      else if (product == 3) tm = two;       // (2: q)
      else if (product >= 4) {               // W1's chunk c, then W2's
        const int c = (product - 4) >> 1;
        if ((product & 1) == 0) tm = tw1, atom = c * da;
        else tm = tw2, row0 = c * p.D;
      }
      for (int step = 0; step < nst; ++step) {
        if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
        const uint32_t full = full0 + 8 * slot;
        mbar_arrive_tx(full, p.stage_bytes);
        tma_load_3d(ring + slot * p.stage_bytes, tm, full, 0, row0 + kCK * step, atom);
        if (++slot == p.NS) slot = 0, ++round;
      }
    }
}

// ---------------------------------------------------------------------------
// consumer warpgroups

// The consumer side of the weight ring, for one warpgroup's N columns.
template <int N>
struct Ring {
  const Params& p;
  uint32_t ring, bars, wg_off;  // bars: full[NS], then empty[NS]
  int slot = 0, phase = 0, prev = -1;

  // One k16 step: A from an activation tile at a_addr (the step's first
  // column), B from stage `slot`; the first of a product overwrites acc.
  // Releases the stage before it once its wgmma is done.
  __device__ __forceinline__ void stage(float (&acc)[N / 2], uint32_t a_addr, bool first) {
    mbar_wait(bars + 8 * slot, phase);
    fence_acc(acc);
    wgmma_fence();
    wgmma<N>(acc, a_desc(a_addr), b_desc(ring + slot * p.stage_bytes + wg_off), first ? 0 : 1);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      fence_acc(acc);
      if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (p.NS + prev));
    }
    prev = slot;
    if (++slot == p.NS) slot = 0, phase ^= 1;
  }

  // Every wgmma done (the accumulators may be read), the last stage released.
  __device__ __forceinline__ void drain(float (&acc)[N / 2]) {
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (p.NS + prev));
    prev = -1;
  }
};

// Four consecutive elements of x or mod (f32 or, XB, BF16) from device
// memory.
template <bool XB>
__device__ __forceinline__ float4 ldg_act4(const void* p, size_t i) {
  if constexpr (XB) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const bf16_t*>(p) + i));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
  }
}

// A[r, :D] = LN(row r) * (1 + scale) + shift, BF16 in the activation tile
// layout (tile_off), for the tile's 64 rows (rows past nrows zero). Each
// warp takes two rows at a time, r and r + 8; a lane holds 4 columns in
// each of up to kV blocks of 128. Every load of both rows is issued before
// the sums: the loads are unconditional (an invalid row or block reads row
// 0 or block 0, then counts as zero), so that no branch separates them. At
// X is the tile's x, staged as it is stored (compact rows of x's type), or
// with kResid the f32 residual (row stride ld); shift and scale are mod's
// columns at `off` and off + D of the row's trajectory, loaded with the
// output.
template <bool XB, bool kResid>
__device__ void layer_norm(const Params& p, const float* X, int b0, int nrows, int off,
                           uint8_t* A, int gw, int lane) {
  using TX = typename std::conditional<XB, bf16_t, float>::type;
  constexpr int kV = (kMaxD / 4 + 31) / 32, kWarps = kConsumers / 32;
  const int D = p.D, nf = D / 4;
  for (int r0 = gw; r0 < kRows; r0 += 2 * kWarps) {
    float4 v[2][kV];
    size_t m[2];  // mod's row of each row's trajectory, at `off`
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * kWarps, rr = r < nrows ? r : 0;
      m[u] = (size_t)(b0 + (int)((rr + 0.5f) * p.inv_h)) * 6 * D + off;
      const TX* xr = reinterpret_cast<const TX*>(X) + rr * D;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int f = lane + 32 * i, fi = f < nf ? f : 0;
        float4 x;
        if constexpr (kResid) {
          x = *reinterpret_cast<const float4*>(X + rr * p.ld + 4 * fi);
        } else if constexpr (XB) {
          const uint2 w = *reinterpret_cast<const uint2*>(xr + 4 * fi);
          x = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                          __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        } else {
          x = *reinterpret_cast<const float4*>(xr + 4 * fi);
        }
        const bool keep = f < nf && r < nrows;
        v[u][i] = keep ? x : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    float mu[2] = {0.0f, 0.0f}, var[2] = {0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < kV; ++i) mu[u] += (v[u][i].x + v[u][i].y) + (v[u][i].z + v[u][i].w);
    warp_sum2(mu[0], mu[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mu[u] /= D;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (lane + 32 * i < nf) {
          const float4 d = make_float4(v[u][i].x - mu[u], v[u][i].y - mu[u], v[u][i].z - mu[u],
                                       v[u][i].w - mu[u]);
          var[u] += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
        }
    }
    warp_sum2(var[0], var[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * kWarps;
      const float rstd = rsqrtf(var[u] / D + 1e-6f);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int f = lane + 32 * i, fi = f < nf ? f : 0;
        const float4 sh = ldg_act4<XB>(p.mod, m[u] + 4 * fi);
        const float4 sc = ldg_act4<XB>(p.mod, m[u] + D + 4 * fi);
        float4 y = make_float4((v[u][i].x - mu[u]) * rstd * (1.0f + sc.x) + sh.x,
                               (v[u][i].y - mu[u]) * rstd * (1.0f + sc.y) + sh.y,
                               (v[u][i].z - mu[u]) * rstd * (1.0f + sc.z) + sh.z,
                               (v[u][i].w - mu[u]) * rstd * (1.0f + sc.w) + sh.w);
        if (r >= nrows) y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (f < nf)
          *reinterpret_cast<uint2*>(A + tile_off(r, 4 * f)) =
              make_uint2(bf16x2(y.x, y.y), bf16x2(y.z, y.w));
      }
    }
  }
}

// Multi-head attention of the tile's nS trajectories: q (scaled) in Q (an
// activation tile), k in K and v in V (BF16, row stride ld), the output
// into the activation tile O. One consumer warp per
// (trajectory, head, m16 tile of query rows), over KT key tiles (H <= 8 KT)
// and up to DT n8 tiles of the head (hd <= 8 DT). Rows past the tile are
// read as row 63 (finite, masked or never stored).
template <int KT, int DT>
__device__ void attention(const Params& p, const uint8_t* Q, const bf16_t* K, const bf16_t* V,
                          uint8_t* O, int nS, int gw, int lane) {
  const int H = p.H, hd = p.hd, ld = p.ld, g = lane >> 2, q = lane & 3;
  const int mtiles = (H + 15) / 16, dtiles = hd / 8;
  const int per_traj = p.n_heads * mtiles;
  for (int task = gw; task < nS * per_traj; task += kConsumers / 32) {
    const int s = task / per_traj, rem = task - s * per_traj;
    const int head = rem / mtiles, mt = rem - head * mtiles;
    const int base = s * H, col = head * hd;
    const int qr = 16 * mt + g;  // query rows qr, qr + 8 of the trajectory
    const int qrow0 = min(base + qr, kRows - 1), qrow1 = min(base + qr + 8, kRows - 1);

    // S = q k^T: dims 2q, 2q + 1 of a k8 step are its k indices q, q + 4
    // (the same for A and B)
    // key g of key tile j (dims 2q on), keys 2q, 2q + 1 of it (dim g)
    uint32_t kp[KT], vp0[KT], vp1[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      kp[j] = smem_addr(K) + 2 * (min(base + 8 * j + g, kRows - 1) * ld + col + 2 * q);
      vp0[j] = smem_addr(V) + 2 * (min(base + 8 * j + 2 * q, kRows - 1) * ld + col + g);
      vp1[j] = smem_addr(V) + 2 * (min(base + 8 * j + 2 * q + 1, kRows - 1) * ld + col + g);
    }
    float sc[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sc[j][v] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DT; ++ks) {
      if (ks < dtiles) {
        const uint2 u0 = bf16x2_split(lds_b32(smem_addr(Q) + tile_off(qrow0, col + 8 * ks + 2 * q)));
        const uint2 u1 = bf16x2_split(lds_b32(smem_addr(Q) + tile_off(qrow1, col + 8 * ks + 2 * q)));
        const uint32_t a[4] = {u0.x, u1.x, u0.y, u1.y};
        uint2 kk[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) kk[j] = bf16x2_split(lds_b32(kp[j] + 16 * ks));
#pragma unroll
        for (int j = 0; j < KT; ++j) mma_tf32(sc[j], a, kk[j].x, kk[j].y);
      }
    }

    // softmax over keys < H of rows qr (sc[.][0..1]) and qr + 8 (sc[.][2..3])
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int key = 8 * j + 2 * q;
      if (key >= H) sc[j][0] = sc[j][2] = -INFINITY;
      if (key + 1 >= H) sc[j][1] = sc[j][3] = -INFINITY;
      m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
      m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      sc[j][0] = __expf(sc[j][0] - m0);
      sc[j][1] = __expf(sc[j][1] - m0);
      sc[j][2] = __expf(sc[j][2] - m1);
      sc[j][3] = __expf(sc[j][3] - m1);
      l0 += sc[j][0] + sc[j][1];
      l1 += sc[j][2] + sc[j][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // O = P V: S's accumulator fragment is P's A fragment (keys 2q, 2q + 1
    // of a key tile are its k indices q, q + 4)
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int v = 0; v < 4; ++v) o[d][v] = 0.0f;
    uint32_t pa[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      pa[j][0] = to_tf32(sc[j][0]);
      pa[j][1] = to_tf32(sc[j][2]);
      pa[j][2] = to_tf32(sc[j][1]);
      pa[j][3] = to_tf32(sc[j][3]);
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d < dtiles) {  // every load of the n8 tile before its MMAs
        uint32_t b0[KT], b1[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          b0[j] = lds_b16(vp0[j] + 16 * d) << 16;
          b1[j] = lds_b16(vp1[j] + 16 * d) << 16;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) mma_tf32(o[d], pa[j], b0[j], b1[j]);
      }
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d >= dtiles) break;
      if (qr < H)
        *reinterpret_cast<uint32_t*>(O + tile_off(base + qr, col + 8 * d + 2 * q)) =
            bf16x2(o[d][0] * inv0, o[d][1] * inv0);
      if (qr + 8 < H)
        *reinterpret_cast<uint32_t*>(O + tile_off(base + qr + 8, col + 8 * d + 2 * q)) =
            bf16x2(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

template <int N, bool XB>
__device__ void consume(const Params& p, uint32_t ring, uint32_t bars, uint8_t* A, uint8_t* Hb,
                        bf16_t* KV) {
  using TX = typename std::conditional<XB, bf16_t, float>::type;  // x, mod and out
  const int wg = threadIdx.x >> 7, gw = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = p.ld;
  bf16_t* K = KV;
  bf16_t* V = KV + kRows * ld;
  float* X = reinterpret_cast<float*>(KV);  // the residual, once k and v are spent
  Ring<N> rg{p, ring, bars, (uint32_t)(wg * (N / kAtom) * kAtomBytes)};

  // this thread's accumulators: rows r0 = 16 warp + g and r0 + 8, columns
  // col + 8 j and the next, for the n8 blocks j < jv inside D
  const int r0 = 16 * (gw & 3) + (lane >> 2), col = wg * N + 2 * (lane & 3);
  const int jv = (p.D - wg * N) / 8;
  const int t0 = r0 / p.H, t1 = (r0 + 8) / p.H;  // their trajectories in the tile
  const uint32_t a_tile = smem_addr(A), h_tile = smem_addr(Hb);

  // Only the wgmmas write the accumulators (each product's first one with
  // scale-d 0): another instruction defining them would make ptxas
  // serialize the wgmmas.
  float acc[N / 2];
  auto product = [&](uint32_t a) {  // k16 step s: 64-column block s / 4, 32 bytes a step in it
    for (int s = 0; s < p.D / kCK; ++s) rg.stage(acc, a + (s >> 2) * 8192 + (s & 3) * 32, s == 0);
    rg.drain(acc);
  };
  // f(j) for this thread's n8 blocks inside D; the epilogues address from
  // per-row base pointers, so that 8 j is an immediate offset
  auto each = [&](auto f) {
    if (jv >= N / 8) {  // no guard to keep one block's loads from the next's
#pragma unroll
      for (int j = 0; j < N / 8; ++j) f(j);
    } else {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        if (j < jv) f(j);
    }
  };
  // (acc + bias) * scale, or gelu(acc + bias), as BF16 into rows r0, r0 + 8
  // of k or v (row-major, row stride ld) or of an activation tile (T, in
  // the layout the A descriptor reads)
  auto to_kv = [&](bf16_t* T, const bf16_t* bias) {
    uint32_t* o0 = reinterpret_cast<uint32_t*>(T + r0 * ld + col);
    uint32_t* o1 = reinterpret_cast<uint32_t*>(T + (r0 + 8) * ld + col);
    const bf16_t* b = bias + col;
    each([&](int j) {
      const float2 bb = load_bf16x2(b + 8 * j);
      o0[4 * j] = bf16x2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      o1[4 * j] = bf16x2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    });
  };
  auto to_tile = [&](uint8_t* T, const bf16_t* bias, float scale, bool gelu) {
    const bf16_t* b = bias + col;
    each([&](int j) {
      const float2 bb = load_bf16x2(b + 8 * j);
      float v[4] = {acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y, acc[4 * j + 2] + bb.x,
                    acc[4 * j + 3] + bb.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = gelu ? gelu_tanh(v[i]) : v[i] * scale;
      *reinterpret_cast<uint32_t*>(T + tile_off(r0, col + 8 * j)) = bf16x2(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(T + tile_off(r0 + 8, col + 8 * j)) = bf16x2(v[2], v[3]);
    });
  };

  bool started = false;
  {  // the biases, into the L1 once
    const int lines = (9 * p.D * (int)sizeof(bf16_t) + 127) / 128;
    for (int i = threadIdx.x; i < lines; i += kConsumers) {
      const int e = 64 * i;  // BF16 elements of a 128-byte line
      prefetch_l1(e < 3 * p.D   ? p.bqkv + e
                  : e < 4 * p.D ? p.bo + (e - 3 * p.D)
                  : e < 8 * p.D ? p.b1 + (e - 4 * p.D)
                                : p.b2 + (e - 8 * p.D));
    }
  }
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int b0 = tile * p.S, nS = min(p.S, p.B - b0), nrows = nS * p.H;
    // this thread's rows of x and mod; a row past the tile's trajectories
    // reads row 0 (its residual is never stored)
    const bool ok0 = r0 < nrows, ok1 = r0 + 8 < nrows;
    const TX* xt = static_cast<const TX*>(p.x) + (size_t)b0 * p.H * p.D;
    const TX* m0 = static_cast<const TX*>(p.mod) + (size_t)(b0 + (ok0 ? t0 : 0)) * 6 * p.D + col;
    const TX* m1 = static_cast<const TX*>(p.mod) + (size_t)(b0 + (ok1 ? t1 : 0)) * 6 * p.D + col;
    float* X0 = X + r0 * ld + col;
    float* X1 = X + (r0 + 8) * ld + col;

    // ---- attention branch. The tile's rows of x into shared memory (over
    // k and v, not yet written) in one round trip; mod's rows of its
    // trajectories (and, once, the biases) into the L1 for the epilogues.
    if (started) consumer_sync();  // the last tile's residual is stored
    started = true;
    {
      const int bytes = nrows * p.D * (int)sizeof(TX);
      const char* src = reinterpret_cast<const char*>(xt);
      for (int i = 16 * threadIdx.x; i < bytes; i += 16 * kConsumers)
        cp_async16(smem_addr(X) + i, src + i);
      const char* mrows = reinterpret_cast<const char*>(static_cast<const TX*>(p.mod) +
                                                        (size_t)b0 * 6 * p.D);
      for (int i = 128 * threadIdx.x; i < nS * 6 * p.D * (int)sizeof(TX); i += 128 * kConsumers)
        prefetch_l1(mrows + i);
      cp_async_wait_all();
    }
    consumer_sync();
    layer_norm<XB, false>(p, X, b0, nrows, 0, A, gw, lane);
    fence_async_shared();
    consumer_sync();
    product(a_tile);  // k
    to_kv(K, p.bqkv + p.D);
    product(a_tile);  // v
    to_kv(V, p.bqkv + 2 * p.D);
    product(a_tile);  // q, scaled
    to_tile(Hb, p.bqkv, p.q_scale, false);
    consumer_sync();  // q, k, v whole; h spent
    if (p.H <= 32)
      p.hd <= 32 ? attention<4, 4>(p, Hb, K, V, A, nS, gw, lane)
                 : attention<4, 8>(p, Hb, K, V, A, nS, gw, lane);
    else
      p.hd <= 32 ? attention<8, 4>(p, Hb, K, V, A, nS, gw, lane)
                 : attention<8, 8>(p, Hb, K, V, A, nS, gw, lane);
    fence_async_shared();
    consumer_sync();  // the output whole; k and v spent
    product(a_tile);  // Wo: x + gate1 * (o @ wo + bo), f32, over k and v
    {
      const TX* x0p = xt + (ok0 ? r0 : 0) * p.D + col;
      const TX* x1p = xt + (ok1 ? r0 + 8 : 0) * p.D + col;
      const TX* g0 = m0 + 2 * p.D;  // gate1
      const TX* g1 = m1 + 2 * p.D;
      const bf16_t* b = p.bo + col;
      each([&](int j) {
        const float2 bb = load_bf16x2(b + 8 * j);
        const float2 xa = ld_stream2<XB>(x0p, 8 * j), ga = ldg_act2<XB>(g0, 8 * j);
        const float2 xb = ld_stream2<XB>(x1p, 8 * j), gb = ldg_act2<XB>(g1, 8 * j);
        *reinterpret_cast<float2*>(X0 + 8 * j) = make_float2(
            xa.x + ga.x * (acc[4 * j] + bb.x), xa.y + ga.y * (acc[4 * j + 1] + bb.y));
        *reinterpret_cast<float2*>(X1 + 8 * j) = make_float2(
            xb.x + gb.x * (acc[4 * j + 2] + bb.x), xb.y + gb.y * (acc[4 * j + 3] + bb.y));
      });
    }
    consumer_sync();  // the residual whole; o spent

    // ---- MLP branch, over 4 chunks of D hidden units
    layer_norm<XB, true>(p, X, b0, nrows, 3 * p.D, A, gw, lane);
    fence_async_shared();
    consumer_sync();
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      product(a_tile);  // W1's chunk c
      consumer_sync();  // both warpgroups' W2 of chunk c - 1 done
      to_tile(Hb, p.b1 + c * p.D, 1.0f, true);
      fence_async_shared();
      consumer_sync();  // the hidden chunk whole
      product(h_tile);  // W2's rows of chunk c, added into the residual (with b2 once)
      const float bias = c == 0 ? 1.0f : 0.0f;
      const bf16_t* b = p.b2 + col;
      const TX* g0 = m0 + 5 * p.D;  // gate2
      const TX* g1 = m1 + 5 * p.D;
      each([&](int j) {
        const float2 bb = load_bf16x2(b + 8 * j);
        const float2 ga = ldg_act2<XB>(g0, 8 * j), gb = ldg_act2<XB>(g1, 8 * j);
        float2* xa = reinterpret_cast<float2*>(X0 + 8 * j);
        float2* xb = reinterpret_cast<float2*>(X1 + 8 * j);
        const float2 ya = *xa, yb = *xb;
        *xa = make_float2(ya.x + ga.x * fmaf(bias, bb.x, acc[4 * j]),
                          ya.y + ga.y * fmaf(bias, bb.y, acc[4 * j + 1]));
        *xb = make_float2(yb.x + gb.x * fmaf(bias, bb.x, acc[4 * j + 2]),
                          yb.y + gb.y * fmaf(bias, bb.y, acc[4 * j + 3]));
      });
    }
    consumer_sync();  // the residual final

    // the residual -> out, in x's type (the tile's rows are contiguous there)
    const int D4 = p.D / 4;
    TX* out = static_cast<TX*>(p.out) + (size_t)b0 * p.H * p.D;
    for (int e = threadIdx.x; e < nrows * D4; e += kConsumers) {
      const int r = e / D4, c4 = 4 * (e - r * D4);
      const float4 v = *reinterpret_cast<const float4*>(X + r * ld + c4);
      if constexpr (XB)
        *reinterpret_cast<uint2*>(out + 4 * e) = make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
      else
        *reinterpret_cast<float4*>(out + 4 * e) = v;
    }
  }
}

template <int N, bool XB>
__global__ void __launch_bounds__(kThreads, 1)
dit_block_bf16_kernel(const __grid_constant__ CUtensorMap tqkv,
                      const __grid_constant__ CUtensorMap two,
                      const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the ring's swizzle atoms want 1024-byte alignment
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(base);
  uint8_t* A = base + p.NS * p.stage_bytes;  // activation tiles, tile_bytes(D) each
  uint8_t* Hb = A + tile_bytes(p.D);
  bf16_t* KV = reinterpret_cast<bf16_t*>(Hb + tile_bytes(p.D));  // 2 x 64 x ld
  const uint32_t bars = smem_addr(KV + 2 * kRows * p.ld);         // full[NS], empty[NS]
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.NS; ++i) {
      mbar_init(bars + 8 * i, 1);                          // the producer's arrive + the TMA bytes
      mbar_init(bars + 8 * (p.NS + i), kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce(p, &tqkv, &two, &tw1, &tw2, ring, bars, bars + 8 * p.NS);
    return;
  }
  consume<N, XB>(p, ring, bars, A, Hb, KV);
}

// ---------------------------------------------------------------------------
// host

// A (rows, cols) BF16 weight, row-major, as the 3-d map (32 columns, rows,
// cols / 32 column blocks): a box of (32, kCK, atoms) lands as `atoms`
// MN-major atom blocks of kCK rows, each 64-byte swizzled.
int encode(CUtensorMap* map, const void* w, int rows, int cols, int atoms) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)kAtom, (cuuint64_t)rows, (cuuint64_t)(cols / kAtom)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * kAtom};
  const cuuint32_t box[3] = {(cuuint32_t)kAtom, (cuuint32_t)kCK, (cuuint32_t)atoms};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// persistent blocks: as many as fit on the device at once (one to an SM:
// the registers allow no more), at most one per tile. The kernel's shared
// memory limit is raised to the most any plan takes, and the device's
// count of blocks found, once per kernel and device: the launch path stays
// short (a DD plan launches the route 40 times).
template <int N, bool XB>
int grid_size(const Plan& pl, int* grid) {
  static int cached_device = -1, resident = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device != cached_device) {
    auto kernel = dit_block_bf16_kernel<N, XB>;
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemLimit)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           kSmemLimit)) != cudaSuccess)
      return (int)e;
    resident = max(1, per_sm) * sms;
    cached_device = device;
  }
  *grid = min(pl.ntiles, resident);
  return 0;
}

int grid_for(const Plan& pl, int* grid) {
  return pl.N == 64 ? grid_size<64, false>(pl, grid) : grid_size<160, false>(pl, grid);
}

template <int N, bool XB>
int launch(const Params& p, const Plan& pl, const void* wqkv, const void* wo, const void* w1,
           const void* w2, cudaStream_t stream) {
  const int D = p.D, atoms = 2 * N / kAtom;
  CUtensorMap maps[4];
  int err = encode(&maps[0], wqkv, D, 3 * D, atoms);
  if (!err) err = encode(&maps[1], wo, D, D, atoms);
  if (!err) err = encode(&maps[2], w1, D, 4 * D, atoms);
  if (!err) err = encode(&maps[3], w2, 4 * D, D, atoms);
  if (err) return err;
  int grid = 0;
  if ((err = grid_size<N, XB>(pl, &grid)) != 0) return err;
  dit_block_bf16_kernel<N, XB><<<grid, kThreads, pl.smem, stream>>>(maps[0], maps[1], maps[2],
                                                                     maps[3], p);
  return (int)cudaGetLastError();
}

template <bool XB>
int launch_for(const Params& p, const Plan& pl, const void* wqkv, const void* wo, const void* w1,
               const void* w2, cudaStream_t stream) {
  return pl.N == 64 ? launch<64, XB>(p, pl, wqkv, wo, w1, w2, stream)
                    : launch<160, XB>(p, pl, wqkv, wo, w1, w2, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of the plan for a shape takes, or -1 if the
// route does not take the shape.
long long dit_block_bf16_smem_bytes(int B, int H, int D, int n_heads) {
  Plan pl;
  return make_plan(B, H, D, n_heads, &pl) ? pl.smem : -1;
}

// The plan for a shape, or -1 if the route does not take it: out[0..8] =
// rows of a tile, trajectories per tile, tiles, thread blocks (persistent,
// on this device), cluster size, ring stages, weight rows per stage, output
// columns per consumer warpgroup, shared memory bytes per block.
int dit_block_bf16_plan(int B, int H, int D, int n_heads, long long* out) {
  Plan pl;
  if (!make_plan(B, H, D, n_heads, &pl)) return -1;
  int grid = 0;
  const int err = grid_for(pl, &grid);
  if (err) return -1;
  const long long v[9] = {kRows, pl.S, pl.ntiles, grid, 1, pl.NS, kCK, pl.N, pl.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Most dynamic shared memory a block may opt in to on `device`, or -1.
int dit_block_bf16_max_smem_optin(int device) { return max_smem_optin(device); }

const char* dit_block_bf16_error_string(int err) { return launch_error_string(err); }

// x, out: (B, H, D); mod: (B, 6D); both f32 (x_bf16 0) or both BF16 (1).
// Weights (in, out) row-major and biases, BF16. All contiguous, 16-byte
// aligned. H <= 64; D a multiple of 32, at most 320; head dim D / n_heads a
// multiple of 8, at most 64. Launches on `stream` and returns 0 on success
// (else a cudaError_t, or a code that dit_block_bf16_error_string names);
// does not synchronise.
int dit_block_forward_bf16(const void* x, const void* mod, const void* wqkv, const void* bqkv,
                           const void* wo, const void* bo, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int B, int H, int D,
                           int n_heads, int x_bf16, float q_scale, void* stream) {
  Plan pl;
  if (!make_plan(B, H, D, n_heads, &pl)) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x, p.mod = mod, p.out = out;
  p.bqkv = static_cast<const bf16_t*>(bqkv), p.bo = static_cast<const bf16_t*>(bo);
  p.b1 = static_cast<const bf16_t*>(b1), p.b2 = static_cast<const bf16_t*>(b2);
  p.B = B, p.H = H, p.D = D, p.n_heads = n_heads, p.hd = D / n_heads;
  p.S = pl.S, p.ld = pl.ld, p.NS = pl.NS, p.ntiles = pl.ntiles;
  p.stage_bytes = (uint32_t)(64 * pl.N);
  p.q_scale = q_scale;
  p.inv_h = 1.0f / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_for<true>(p, pl, wqkv, wo, w1, w2, st)
                : launch_for<false>(p, pl, wqkv, wo, w1, w2, st);
}

}  // extern "C"
