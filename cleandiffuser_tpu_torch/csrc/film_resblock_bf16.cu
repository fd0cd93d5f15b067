// Fused FiLM Conv1d residual block, forward, BF16 weights, for NVIDIA Hopper
// (sm_90a): `film_resblock_forward_bf16`. The float32 route is
// csrc/film_resblock.cu.
//
// Replaces the Pallas TPU kernel cleandiffuser_tpu/ops/film_resblock.py
// (`film_resblock`, body `_kernel`) with BF16 weights, biases and GroupNorm
// affine (the U-Net's copy cast by `bf16_sampling` / `bf16_training`); x and
// emb each f32 or BF16; the output f32, or BF16 when x and emb both are (the
// promoted type of the operands, which flax's block returns). Same math as
// `film_resblock_reference` in cleandiffuser_tpu_torch/ops/film_resblock.py,
// channels-last:
//
//     h   = mish(GN(conv1(x) + b1))          conv: K taps, SAME padding (K odd)
//     h   = h + emb  (film_scale: emb[:C] * h + emb[C:])
//     h   = mish(GN(conv2(h) + b2))
//     out = h + (x @ wskip + bskip, or x when there is no skip conv)
//
// What bounds it. A block of the Janner U-Net is small per sample (H = 4..64
// rows, C = 23..1024 channels) and the batch is large (B = 3200 candidate
// trajectories): the products are 2*K*H*(Cin + Cout)*Cout flops per sample,
// on up to 2.6 MB of BF16 weights that every tile of 64 rows streams from
// the L2. At 64 rows a tile does 64 flops per weight byte, so at the wide
// blocks the L2's rate, not the tensor cores, bounds the convs; at the
// narrow ones (Cout = 32, 64) the chain of latencies a tile walks through
// (x staged, two GroupNorms with their shuffles and table round trips, the
// stores) does. Measured on the H100 (film_bf16_compare.py --variants, one
// MuJoCo U-Net call at B = 3200): without the wgmmas the call is ~11 %
// shorter, without the GroupNorm statistics ~35 %, without x's loads ~2 %.
//
// Design.
// - Tensor cores: `wgmma.mma_async` m64nNk16 BF16 with f32 accumulators in
//   registers, for conv1, conv2 and the 1x1 skip conv: an implicit GEMM per
//   conv, one k16 step per (tap, 16 input channels). A comes from registers,
//   loaded by `ldmatrix` from a BF16 tile in shared memory with one row
//   address per thread, so a tap's shift of A by one row is a shift of
//   those addresses. B comes from shared memory through a descriptor with B
//   transposed (MN-major): the weights keep the JAX layout (K, Cin, Cout),
//   N-major, with no transpose in device memory. N is Cout rounded up to 32,
//   64 or 128 with one consumer warpgroup; Cout up to 256 takes two, of
//   128 channels each, and Cout up to 512 two of 256, on the same rows (an
//   m64n256 wgmma needs 158 registers: more than two blocks of 256 threads
//   on an SM may have). Only the wgmmas write the accumulators (a pass's
//   first with scale-d 0, no zeroing; the epilogues read them, never write
//   them), so ptxas keeps one wgmma group in flight behind the next stage's
//   instead of serialising them.
// - A tile is 64 output rows, one wgmma M: S = 64 / H whole samples, every
//   output channel, so GroupNorm needs no other tile. Halo rows are shared
//   between neighbouring samples: the activation tile is [P zeros][sample 0]
//   [P zeros][sample 1] ... [P zeros], P = K/2, so tap k of output row r
//   reads tile row r - P + k. Samples past B (a ragged last tile) are zero
//   and never stored.
// - Persistent blocks: as many as fit on the device at once, each walking
//   tiles b, b + gridDim.x, ...; the weight ring and the x fills run on
//   from one tile into the next.
// - Weights by TMA into a ring of NS >= 4 stages, one stage being CK input
//   channels of one tap, all N columns: one `cp.async.bulk.tensor` per 64
//   (or 32) columns, 128 B (64 B) swizzled as the descriptor expects, rows
//   past C and columns past Cout zero-filled by the tensor map's bounds. The
//   tensor maps are encoded on the host per launch (`cuTensorMapEncodeTiled`,
//   reached through `cudaGetDriverEntryPoint`: no -lcuda) and passed as
//   __grid_constant__ parameters, so a captured CUDA graph keeps them. Full
//   and empty mbarriers per stage; one producer thread issues every stage
//   ahead, across passes and tiles, so the ring is full when a pass starts.
//   (The mma.sync route before this one measured a producer warp slower
//   than every thread issuing cp.async: that was one bulk copy per 128 B-1
//   KB weight row; a TMA tile is one instruction per 64 columns.)
// - Warp roles: warpgroup 0 is the producer (`setmaxnreg.dec`): its warp 0
//   issues the TMA, its warps 1-3 stage x. The consumer warpgroups
//   (`setmaxnreg.inc`) run the wgmmas and the epilogues. (ptxas compiles
//   every thread to the launch's register share, so the consumers gain no
//   registers in their code; the producer's region is compiled to its
//   lower count.)
// - BF16 activations in shared memory: x (rounded to BF16 as it is staged,
//   the rounding the MMA's input makes anyway) and the hidden tile between
//   conv1 and conv2 share one buffer. x wider than the buffer allows (Cin =
//   1024 at H = 4) is staged in fills of XC channels. The skip conv runs
//   right after conv1 on the same fills, into accumulators of its own,
//   where registers allow (N <= 64); wider blocks store mish(GN(h)), stage
//   x again after conv2 and add the skip to the stored h. Without a skip
//   conv the residual reads x in its own type from device memory.
// - GroupNorm from the accumulators, two-pass: per-column sums of acc +
//   bias over each sample's rows by shuffles into a table (a row per sample
//   or per warp's 16 rows), the (sample, group) sums from it, the mean
//   written back per column; then the centred sums of squares the same way
//   into a second table. Where a warp holds whole samples and groups (H <=
//   16), it finishes them alone with no barrier of the warpgroups. Affine,
//   Mish and FiLM in registers; conv1's epilogue writes the hidden tile
//   once, as BF16, for conv2; conv2's stores the output once.
// - Overlap of the epilogues with the MMAs: with one consumer warpgroup
//   (Cout <= 128) two blocks share an SM (three at Cout <= 32), so one
//   block's epilogue and x staging run against another's wgmmas; the
//   producer and the x stager run ahead into the next tile during a tile's
//   epilogues. Two consumer warpgroups on different row tiles of one block
//   would share the weight stages and so reach their epilogues together.
//   Wider blocks (two consumer warpgroups, 168 registers a thread) run one
//   to an SM; there each warpgroup's epilogue covers half the channels.

#include <type_traits>

#include "hopper_sm90.cuh"

namespace {

constexpr int kRows = 64;              // output rows of a tile: one wgmma M
constexpr int kLoaderThreads = 96;     // producer warps 1-3 stage x
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr long long kSmemLimit = 232448;  // sm_90: most shared memory a block opts in to

// shared memory each of `blocks` blocks may take on one SM (228 KB, 1 KB of
// it reserved per block)
constexpr long long block_smem_limit(int blocks) {
  return blocks == 1 ? kSmemLimit : (233472LL - 1024LL * blocks) / blocks;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride (BF16 elements) of a shared tile with C columns: 16 bytes times
// an odd number, so that the 8 rows of an ldmatrix hit 8 different 16-byte
// bank groups.
__host__ __device__ constexpr int odd8_stride(int C) {
  return (round_up(C, 8) / 8) % 2 ? round_up(C, 8) : round_up(C, 8) + 8;
}

// The instantiations: N output channels per consumer warpgroup, NWG of them.
template <int N, int NWG>
struct Cfg {
  static constexpr int kNtot = N * NWG;            // output channels of a tile (padded)
  static constexpr int kAtomN = N == 32 ? 32 : 64;  // columns of one swizzle atom (64 B / 128 B)
  static constexpr int kRowBytes = 2 * kAtomN;
  // input channels per stage: 8 KB stages (16 KB with two warpgroups), at
  // most 4 k16 steps
  static constexpr int kCK = (NWG == 2 ? 16384 : 8192) / (2 * kNtot) < 64
                                 ? (NWG == 2 ? 16384 : 8192) / (2 * kNtot)
                                 : 64;
  static constexpr int kBoxBytes = kCK * kRowBytes;  // one atom-wide column block of a stage
  static constexpr int kBoxes = kNtot / kAtomN;
  static constexpr int kStageBytes = kBoxes * kBoxBytes;
  static constexpr int kWgBytes = (N / kAtomN) * kBoxBytes;  // a warpgroup's columns in a stage
  static constexpr int kKStepBytes = 16 * kRowBytes;         // 16 input channels in a block
  static constexpr uint64_t kLayout = N == 32 ? 2 : 1;       // descriptor: 64 B / 128 B swizzle
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kMinBlocks = NWG == 2 ? 1 : N == 32 ? 3 : 2;
  // registers: ptxas compiles every thread to 65536 / (kThreads *
  // kMinBlocks) (128 / 168: an m64n256 wgmma needs 158, so N = 256 runs
  // only with two warpgroups); at run time the producer gives most of its
  // share to the consumers
  static constexpr int kRegs = (65536 / (kThreads * kMinBlocks) < 255
                                    ? 65536 / (kThreads * kMinBlocks)
                                    : 255) / 8 * 8;
  static constexpr int kProducerRegs = kRegs * 3 / 4 / 8 * 8;
  static constexpr int kConsumerRegs =
      (kRegs * kThreads - kProducerRegs * 128) / (128 * NWG) / 8 * 8 < 256
          ? (kRegs * kThreads - kProducerRegs * 128) / (128 * NWG) / 8 * 8
          : 256;
};

struct Params {
  const void *x, *emb;
  const bf16_t *b1, *g1s, *g1b, *b2, *g2s, *g2b, *bskip;
  void* out;
  int B, H, lgH, Cin, Cout, K, G, film_scale, x_bf16, emb_bf16, out_bf16, has_skip;
  int ntiles;  // tiles of 64 rows; block b takes tiles b, b + gridDim.x, ...
  // the skip conv runs right after conv1, on the same x fills, into
  // accumulators of its own (N <= 64); else after conv2, on x staged again
  int skip_early;
  float eps;
  // the plan: samples per tile, tile rows, row stride, x fill width and
  // count, ring stages, rows of each weight map's box (w1, w2, wskip) and
  // the bytes of its stage, stat table row stride
  int S, R, ld, XC, nfill, NS, ck[3], ldb;
  uint32_t tx[3];
};

struct Plan {
  int N, NWG, S, R, ld, XC, nfill, NS, CK, ldb, stat_floats, blocks;
  long long smem;
};

template <int N, int NWG>
long long smem_bytes(int NS, int R, int ld, int stat_floats) {
  return 1024LL + (long long)NS * Cfg<N, NWG>::kStageBytes + 2LL * R * ld + 4LL * stat_floats +
         8LL * (2 * NS + 2);
}

template <int N, int NWG>
bool plan_for(int H, int Cin, int Cout, int K, Plan* pl) {
  using C = Cfg<N, NWG>;
  const int P = K / 2, cin16 = round_up(Cin, 16);
  pl->N = N, pl->NWG = NWG, pl->CK = C::kCK;
  pl->S = kRows / H;
  pl->R = pl->S * (H + P) + P;
  // the mean and rstd tables: a row of Cout per slot (a sample, or a warp's
  // 16 rows)
  pl->ldb = Cout + 8;
  pl->stat_floats = 2 * (kRows / (H < 16 ? H : 16)) * pl->ldb;
  // x in as few fills as fit beside the ring at its least depth
  for (int nfill = 1; nfill <= cin16 / 16; ++nfill) {
    const int XC = round_up((cin16 + nfill - 1) / nfill, 16);
    const int ld = odd8_stride(XC > C::kNtot ? XC : C::kNtot);
    if (smem_bytes<N, NWG>(kMinStages, pl->R, ld, pl->stat_floats) > kSmemLimit) continue;
    pl->XC = XC, pl->nfill = (cin16 + XC - 1) / XC, pl->ld = ld;
    // then the deepest ring that keeps as many blocks on an SM as the
    // registers allow, or fewer
    pl->blocks = C::kMinBlocks;
    while (pl->blocks > 1 && smem_bytes<N, NWG>(kMinStages, pl->R, ld, pl->stat_floats) >
                                 block_smem_limit(pl->blocks))
      --pl->blocks;
    const long long limit = block_smem_limit(pl->blocks);
    pl->NS = kMinStages;
    while (pl->NS < kMaxStages &&
           smem_bytes<N, NWG>(pl->NS + 1, pl->R, ld, pl->stat_floats) <= limit)
      ++pl->NS;
    pl->smem = smem_bytes<N, NWG>(pl->NS, pl->R, ld, pl->stat_floats);
    return true;
  }
  return false;
}

bool make_plan(int B, int H, int Cin, int Cout, int K, int G, Plan* pl) {
  if (B <= 0 || H <= 0 || kRows % H != 0 || Cin <= 0 || K <= 0 || K % 2 == 0 || G <= 0 ||
      Cout <= 0 || Cout % 8 != 0 || Cout > 512 || Cout % G != 0)
    return false;
  if (Cout <= 32) return plan_for<32, 1>(H, Cin, Cout, K, pl);
  if (Cout <= 64) return plan_for<64, 1>(H, Cin, Cout, K, pl);
  if (Cout <= 128) return plan_for<128, 1>(H, Cin, Cout, K, pl);
  if (Cout <= 256) return plan_for<128, 2>(H, Cin, Cout, K, pl);
  return plan_for<256, 2>(H, Cin, Cout, K, pl);
}

// ---------------------------------------------------------------------------
// device helpers

// Named barrier 1 over the consumer warpgroups.
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (64 x N f32, the warpgroup's fragments) = a (64 x 16 BF16, registers:
// warp w rows 16w..16w+15 in mma.sync's A layout) * b (16 x N BF16, shared
// memory, MN-major by `desc`), + d unless scale_d is 0.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  if constexpr (N == 32) wgmma_m64n32(d, a, desc, scale_d);
  else if constexpr (N == 64) wgmma_m64n64(d, a, desc, scale_d);
  else if constexpr (N == 128) wgmma_m64n128(d, a, desc, scale_d);
  else wgmma_m64n256(d, a, desc, scale_d);
}

// Shared-memory descriptor of a B operand stored MN-major, swizzled: atoms
// of 8 rows (input channels) x kRowBytes, the next 8 rows SBO = 8 x
// kRowBytes on, the next atom along N LBO = kBoxBytes on.
template <int N, int NWG>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  using C = Cfg<N, NWG>;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(C::kBoxBytes >> 4) << 16) |
         ((uint64_t)((8 * C::kRowBytes) >> 4) << 32) | (C::kLayout << 62);
}

__device__ __forceinline__ bf16_t to_bf16(float v) {
  unsigned short d;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(d) : "f"(v));
  return d;
}

// elements i, i + 1 of an activation tensor stored in f32 or (bf16) in BF16
__device__ __forceinline__ float2 load_act2(const void* p, size_t i, int bf16) {
  if (bf16) return load_bf16x2(static_cast<const bf16_t*>(p) + i);
  return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p) + i));
}

// elements i, i + 1 of out, which this kernel writes (no read-only path)
__device__ __forceinline__ float2 load_out2(const Params& p, size_t i) {
  if (p.out_bf16) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(static_cast<const bf16_t*>(p.out) + i);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p.out) + i);
}

// mish(v) = v tanh(log(1 + e^v)) = v n / (n + 2) with n = e^v (e^v + 2); past
// v = 20, n / (n + 2) is 1 in f32
__device__ __forceinline__ float mish(float v) {
  const float e = __expf(fminf(v, 20.0f));
  const float n = e * (e + 2.0f);
  return v * __fdividef(n, n + 2.0f);
}

// ---------------------------------------------------------------------------
// producer warpgroup

// Warp 0, one thread: every weight stage in the consumers' order, per tile
// conv1 (per x fill, tap, CK channels; the skip's CK channels after each
// fill's taps when it runs early), conv2 (tap, CK channels), the skip (per
// x fill, CK channels) when it runs late; running ahead into the next tile.
template <int N, int NWG>
__device__ void produce(const Params& p, const CUtensorMap* tm1, const CUtensorMap* tm2,
                        const CUtensorMap* tms, uint32_t ring, uint32_t full0, uint32_t empty0) {
  using C = Cfg<N, NWG>;
  int slot = 0, round = 0;
  auto issue = [&](const CUtensorMap* tm, uint32_t tx, int c, int t) {
    if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
    const uint32_t full = full0 + 8 * slot, dst = ring + slot * C::kStageBytes;
    mbar_arrive_tx(full, tx);
#pragma unroll
    for (int nb = 0; nb < C::kBoxes; ++nb)
      tma_load_3d(dst + nb * C::kBoxBytes, tm, full, nb * C::kAtomN, c, t);
    if (++slot == p.NS) slot = 0, ++round;
  };
  const int cin16 = round_up(p.Cin, 16), cout16 = round_up(p.Cout, 16);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    for (int f = 0; f < p.nfill; ++f) {
      const int c0 = f * p.XC, w = min(p.XC, cin16 - c0);
      for (int t = 0; t < p.K; ++t)
        for (int c = 0; c < w; c += p.ck[0]) issue(tm1, p.tx[0], c0 + c, t);
      if (p.skip_early)
        for (int c = 0; c < w; c += p.ck[2]) issue(tms, p.tx[2], c0 + c, 0);
    }
    for (int t = 0; t < p.K; ++t)
      for (int c = 0; c < cout16; c += p.ck[1]) issue(tm2, p.tx[1], c, t);
    if (p.has_skip && !p.skip_early)
      for (int f = 0; f < p.nfill; ++f) {
        const int c0 = f * p.XC, w = min(p.XC, cin16 - c0);
        for (int c = 0; c < w; c += p.ck[2]) issue(tms, p.tx[2], c0 + c, 0);
      }
  }
}

// Warps 1-3: channels [c0, c0 + w) of x for the tile's samples into the
// activation tile's sample rows, rounded to BF16 (zero past Cin and for
// samples past B), in pieces of 8 (BF16 x, Cin % 8 == 0), 4 (f32 x,
// Cin % 4 == 0) or 1 channels; each thread loads kBatch pieces before it
// stores them, so that a fill takes few round trips to device memory.
template <typename T, int kPiece>
__device__ __forceinline__ void stage_x_pieces(const Params& p, bf16_t* A, int b0, int c0, int w,
                                               int lt) {
  constexpr int kBatch = kPiece == 1 ? 16 : 8;
  using Raw = typename std::conditional<kPiece == 8, uint4,
                                        typename std::conditional<kPiece == 4, float4, T>::type>::type;
  const int P = p.K >> 1, SP = p.H + P, nS = min(p.S, p.B - b0);
  const int cv = min(w, p.Cin - c0);  // channels of x in this fill
  const int per_row = w / kPiece, total = kRows * per_row;
  const T* x = static_cast<const T*>(p.x);
  for (int e0 = lt; e0 < total; e0 += kBatch * kLoaderThreads) {
    Raw v[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kLoaderThreads, r = e / per_row, k = kPiece * (e - r * per_row);
      const int s = r >> p.lgH, h = r & (p.H - 1);
      dst[u] = e < total ? (P + s * SP + h) * p.ld + k : -1;
      v[u] = Raw{};
      if (e < total && s < nS && k < cv)
        v[u] = *reinterpret_cast<const Raw*>(x + ((size_t)(b0 + s) * p.H + h) * p.Cin + c0 + k);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (dst[u] < 0) continue;
      if constexpr (kPiece == 8)  // BF16 already
        *reinterpret_cast<uint4*>(A + dst[u]) = v[u];
      else if constexpr (kPiece == 4)
        *reinterpret_cast<uint2*>(A + dst[u]) =
            make_uint2(bf16x2(v[u].x, v[u].y), bf16x2(v[u].z, v[u].w));
      else if constexpr (sizeof(T) == 2)
        A[dst[u]] = v[u];
      else
        A[dst[u]] = to_bf16(v[u]);
    }
  }
}

__device__ __forceinline__ void stage_x(const Params& p, bf16_t* A, int b0, int c0, int w,
                                        int lt) {
  if (p.x_bf16 && p.Cin % 8 == 0)
    stage_x_pieces<bf16_t, 8>(p, A, b0, c0, w, lt);
  else if (!p.x_bf16 && p.Cin % 4 == 0)
    stage_x_pieces<float, 4>(p, A, b0, c0, w, lt);
  else if (p.x_bf16)
    stage_x_pieces<bf16_t, 1>(p, A, b0, c0, w, lt);
  else
    stage_x_pieces<float, 1>(p, A, b0, c0, w, lt);
}

// Warps 1-3: zero the tile's gap rows (once), then every x fill of every
// tile: conv1's, then the skip's, each once the consumers have freed the
// activation tile.
__device__ void load_x(const Params& p, bf16_t* A, int lt, uint32_t xfull, uint32_t afree) {
  const int P = p.K >> 1, SP = p.H + P, per_row = p.ld / 8;
  for (int e = lt; e < (p.S + 1) * P * per_row; e += kLoaderThreads) {
    const int row = e / per_row, k = e - row * per_row;  // row-th gap row
    const int gi = row / P;
    reinterpret_cast<uint4*>(A + (size_t)(gi * SP + row - gi * P) * p.ld)[k] =
        make_uint4(0, 0, 0, 0);
  }
  const int cin16 = round_up(p.Cin, 16);
  int fill = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x)
    for (int pass = 0; pass < (p.has_skip && !p.skip_early ? 2 : 1); ++pass)
      for (int f = 0; f < p.nfill; ++f, ++fill) {
        if (fill > 0) mbar_wait(afree, (fill - 1) & 1);
        stage_x(p, A, tile * p.S, f * p.XC, min(p.XC, cin16 - f * p.XC), lt);
        mbar_arrive(xfull);
      }
}

// ---------------------------------------------------------------------------
// consumer warpgroups

// The consumer side of the weight ring.
template <int N, int NWG>
struct Ring {
  using C = Cfg<N, NWG>;
  uint32_t ring, full0, empty0, wg_off;
  int NS, slot = 0, round = 0, prev = -1;

  // NK k16 steps with A from the activation tile at a_addr (this lane's
  // ldmatrix row, tap and first channel applied), B from stage `slot`; the
  // first overwrites acc when `first`.
  template <int NK>
  __device__ __forceinline__ void mma(float (&acc)[N / 2], uint32_t a_addr, bool first) {
    uint32_t a[NK][4];
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) ldmatrix_x4(a[ks], a_addr + 32 * ks);
    const uint32_t b = ring + slot * C::kStageBytes + wg_off;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma<N>(acc, a[ks], b_desc<N, NWG>(b + ks * C::kKStepBytes), ks > 0 || !first);
    wgmma_commit();
  }

  // One stage of nk k16 steps (the pass's first when `first`); releases the
  // stage before it once its wgmmas are done.
  __device__ __forceinline__ void stage(float (&acc)[N / 2], uint32_t a_addr, int nk,
                                        bool first) {
    static_assert(C::kCK <= 64, "at most 4 k16 steps a stage");
    mbar_wait(full0 + 8 * slot, round & 1);
    switch (nk) {  // the wgmmas of one stage unconditional
      case 1: mma<1>(acc, a_addr, first); break;
      case 2: if constexpr (C::kCK >= 32) mma<2>(acc, a_addr, first); break;
      case 3: if constexpr (C::kCK >= 48) mma<3>(acc, a_addr, first); break;
      default: if constexpr (C::kCK >= 64) mma<4>(acc, a_addr, first); break;
    }
    if (prev >= 0) {
      wgmma_wait<1>();
      fence_acc(acc);
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * prev);
    }
    prev = slot;
    if (++slot == NS) slot = 0, ++round;
  }

  // Every wgmma done (the accumulators may be read), the last stage released.
  __device__ __forceinline__ void drain(float (&acc)[N / 2]) {
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * prev);
    prev = -1;
  }
};

// Where this thread's accumulators sit: rows 16 warp + g (+ 8), columns
// col + 8 j (+ 1) of the tile, and the rows of the stat table and the
// activation tile that go with them.
struct Frag {
  int col;        // first column: the warpgroup's + 2 q
  int warp, g;
  int s[2];       // sample of row hf in the tile
  int h[2];       // its step
  int tab[2];     // its sample's row of the stat table
  int trow[2];    // its row of the activation tile
};

// Per-column sums of val(j, hf) (float2: columns col + 8 j, col + 8 j + 1 of
// row hf) over each sample's rows into a stat table: one row per sample
// (H <= 16) or per warp's 16 rows (H >= 16); columns < Cout.
template <int N, typename Val>
__device__ __forceinline__ void col_sums(Val val, const Frag& fr, float* table, int ldb, int H,
                                         int lgH, int Cout) {
  const int col0 = fr.col - (fr.col & 7);  // the warpgroup's first column
  if (H >= 16) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (col0 + 8 * j >= Cout) break;
      const float2 a = val(j, 0), b = val(j, 1);
      float u0 = a.x + b.x, u1 = a.y + b.y;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u0 += __shfl_xor_sync(0xffffffffu, u0, o);
        u1 += __shfl_xor_sync(0xffffffffu, u1, o);
      }
      if (fr.g == 0)
        *reinterpret_cast<float2*>(table + fr.warp * ldb + fr.col + 8 * j) = make_float2(u0, u1);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (col0 + 8 * j >= Cout) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 a = val(j, hf);
      float u0 = a.x, u1 = a.y;
      for (int o = 4; o < 4 * H; o <<= 1) {  // the g-lanes of one sample
        u0 += __shfl_xor_sync(0xffffffffu, u0, o);
        u1 += __shfl_xor_sync(0xffffffffu, u1, o);
      }
      if ((fr.g & (H - 1)) == 0)
        *reinterpret_cast<float2*>(table + ((16 * fr.warp + fr.g + 8 * hf) >> lgH) * ldb +
                                   fr.col + 8 * j) = make_float2(u0, u1);
    }
  }
}

// (sample, group) sums of a stat table's column sums, for samples [s0, s0 +
// ns) and groups [g0, g0 + ng), a task a thread; each sample's first row
// gets, per column of the group, the mean (kMean) or 1 / sqrt(variance +
// eps) from the centred sums of squares.
template <bool kMean>
__device__ __forceinline__ void group_stats(const Params& p, float* table, int s0, int ns, int g0,
                                            int ng, int t, int nthreads) {
  const int Cg = p.Cout / p.G, span = p.H >= 16 ? p.H >> 4 : 1;
  const float inv_n = 1.0f / (float)(p.H * Cg);
  for (int task = t; task < ns * ng; task += nthreads) {
    const int i = task / ng, sm = s0 + i, gi = g0 + task - i * ng;
    float* row = table + sm * span * p.ldb + gi * Cg;
    // each task starts at another column (gi mod Cg): neighbouring tasks,
    // Cg floats apart, then fall on different banks
    const int c0 = gi % Cg;
    float sum = 0.0f;
    for (int k = 0; k < span; ++k)
      for (int c = 0, cc = c0; c < Cg; ++c, cc = cc + 1 == Cg ? 0 : cc + 1)
        sum += row[k * p.ldb + cc];
    const float v = kMean ? sum * inv_n : rsqrtf(sum * inv_n + p.eps);
    for (int c = 0, cc = c0; c < Cg; ++c, cc = cc + 1 == Cg ? 0 : cc + 1) row[cc] = v;
  }
}

// GroupNorm of acc + bias, from the accumulators (which it leaves as they
// are: only the wgmmas write them). Two passes: the mean table, then the
// centred sums of squares into the rstd table; each holds its value per
// (sample, column) at the sample's first row. Where each of a warp's
// samples and groups lies in that warp's rows and columns (H <= 16, the
// groups within a warpgroup's columns), the warp finishes them alone,
// with no barrier of the warpgroups.
struct Norm {
  const float *mean, *rstd;
  int ldb;
};

template <int N>
__device__ __forceinline__ Norm group_norm(const float (&acc)[N / 2], const bf16_t* bias,
                                           const Params& p, const Frag& fr, float* stat, int ctid,
                                           int nthreads) {
  float* mean = stat;
  float* rstd = stat + (kRows / (p.H < 16 ? p.H : 16)) * p.ldb;
  const int Cout = p.Cout;
  auto biased = [&](int j, int hf) {
    const float2 b = load_bf16x2(bias + fr.col + 8 * j);
    return make_float2(acc[4 * j + 2 * hf] + b.x, acc[4 * j + 2 * hf + 1] + b.y);
  };
  const int Cg = Cout / p.G;
  const bool local = p.H <= 16 && (nthreads == 128 || N % Cg == 0);
  const int s0 = local ? (16 * fr.warp) >> p.lgH : 0;
  const int ns = local ? (p.H < 16 ? 16 >> p.lgH : 1) : kRows >> p.lgH;
  const int g0 = local && nthreads > 128 ? (fr.col & ~7) / Cg : 0;
  const int ng = local && nthreads > 128 ? min(N / Cg, p.G - g0) : p.G;
  auto sync = [&] {
    if (local)
      __syncwarp();
    else
      consumer_sync(nthreads);
  };
  col_sums<N>(biased, fr, mean, p.ldb, p.H, p.lgH, Cout);
  sync();
  group_stats<true>(p, mean, s0, ns, g0, ng, local ? ctid & 31 : ctid, local ? 32 : nthreads);
  sync();
  auto squares = [&](int j, int hf) {
    const float2 v = biased(j, hf);
    const float2 m =
        *reinterpret_cast<const float2*>(mean + fr.tab[hf] * p.ldb + fr.col + 8 * j);
    return make_float2((v.x - m.x) * (v.x - m.x), (v.y - m.y) * (v.y - m.y));
  };
  col_sums<N>(squares, fr, rstd, p.ldb, p.H, p.lgH, Cout);
  sync();
  group_stats<false>(p, rstd, s0, ns, g0, ng, local ? ctid & 31 : ctid, local ? 32 : nthreads);
  sync();
  return {mean, rstd, p.ldb};
}

// mish(GN(acc + bias)) with the affine (gs, gb), for row hf of n8 block j
// (columns n, n + 1)
template <int N>
__device__ __forceinline__ float2 gn_mish(const float (&acc)[N / 2], const Norm& nm,
                                          const Frag& fr, int j, int hf, float2 b, float2 gs,
                                          float2 gb) {
  const int o = fr.tab[hf] * nm.ldb + fr.col + 8 * j;
  const float2 m = *reinterpret_cast<const float2*>(nm.mean + o);
  const float2 r = *reinterpret_cast<const float2*>(nm.rstd + o);
  return make_float2(mish((acc[4 * j + 2 * hf] + b.x - m.x) * r.x * gs.x + gb.x),
                     mish((acc[4 * j + 2 * hf + 1] + b.y - m.y) * r.y * gs.y + gb.y));
}

template <int N, int NWG>
__device__ void consume(const Params& p, uint32_t ring, uint32_t bars, bf16_t* A, float* stat,
                        int ctid) {
  using C = Cfg<N, NWG>;
  constexpr int kThreads = 128 * NWG;
  const int wg = ctid >> 7, warp = (ctid >> 5) & 3, lane = ctid & 31;
  const int H = p.H, lgH = p.lgH, P = p.K >> 1, SP = H + P, ld = p.ld;
  const uint32_t xfull = bars + 16 * p.NS, afree = xfull + 8;
  Ring<N, NWG> rg{ring, bars, bars + 8 * p.NS, (uint32_t)(wg * C::kWgBytes), p.NS};

  Frag fr;
  fr.col = wg * N + 2 * (lane & 3), fr.warp = warp, fr.g = lane >> 2;
  const int span = H >= 16 ? H >> 4 : 1;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + fr.g + 8 * hf;
    fr.s[hf] = r >> lgH, fr.h[hf] = r & (H - 1);
    fr.tab[hf] = fr.s[hf] * span;
    fr.trow[hf] = P + fr.s[hf] * SP + fr.h[hf];
  }
  // this lane's ldmatrix row: output row 16 warp + (lane & 15), at tap 0
  const int rl = 16 * warp + (lane & 15);
  const uint32_t a_lane =
      smem_addr(A) + 2 * (((rl >> lgH) * SP + (rl & (H - 1))) * ld + (lane >> 4) * 8);
  const int cin16 = round_up(p.Cin, 16), cout16 = round_up(p.Cout, 16);
  const int Cout = p.Cout;

  // Only the wgmmas write the accumulators (each pass's first one with
  // scale-d 0): another instruction defining them would make ptxas
  // serialize the wgmmas.
  float acc[N / 2];
  // N <= 64: the skip's own accumulators (skip_early); else h is stored and
  // read back around the skip
  constexpr bool kEarly = N <= 64;
  float acc_skip[kEarly ? N / 2 : 1];
  const int ld_emb = p.film_scale ? 2 * Cout : Cout;
  int fill = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int b0 = tile * p.S, nS = min(p.S, p.B - b0);
    auto out_at = [&](int hf, int n) {
      return ((size_t)(b0 + fr.s[hf]) * H + fr.h[hf]) * Cout + n;
    };
    auto store = [&](size_t o, float2 v) {
      if (p.out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<bf16_t*>(p.out) + o) = bf16x2(v.x, v.y);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = v;
    };

    // ---- conv1, over the x fills
    for (int f = 0; f < p.nfill; ++f, ++fill) {
      const int w = min(p.XC, cin16 - f * p.XC);
      mbar_wait(xfull, fill & 1);
      for (int t = 0; t < p.K; ++t)
        for (int c = 0; c < w; c += p.ck[0])
          rg.stage(acc, a_lane + 2 * (t * ld + c), min(p.ck[0], w - c) >> 4, f + t + c == 0);
      if constexpr (kEarly) {
        if (p.has_skip)
          for (int c = 0; c < w; c += p.ck[2])
            rg.stage(acc_skip, a_lane + 2 * (P * ld + c), min(p.ck[2], w - c) >> 4, f + c == 0);
      }
      if (f + 1 < p.nfill) mbar_arrive(afree);
    }
    rg.drain(acc);
    if constexpr (kEarly) fence_acc(acc_skip);

    // ---- GN, mish, FiLM; the hidden tile into the activation tile, BF16
    {
      const Norm nm = group_norm<N>(acc, p.b1, p, fr, stat, ctid, kThreads);
      // with two warpgroups, the other's conv1 may still read x where this
      // one writes
      if (NWG == 2) consumer_sync(kThreads);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = fr.col + 8 * j;
        if (n - (n & 7) < Cout) {
          const float2 b = load_bf16x2(p.b1 + n), gs = load_bf16x2(p.g1s + n),
                       gb = load_bf16x2(p.g1b + n);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2 y = gn_mish<N>(acc, nm, fr, j, hf, b, gs, gb);
            if (fr.s[hf] < nS) {
              const size_t ei = (size_t)(b0 + fr.s[hf]) * ld_emb + n;
              const float2 e0 = load_act2(p.emb, ei, p.emb_bf16);
              if (p.film_scale) {
                const float2 e1 = load_act2(p.emb, ei + Cout, p.emb_bf16);
                y = make_float2(fmaf(e0.x, y.x, e1.x), fmaf(e0.y, y.y, e1.y));
              } else {
                y = make_float2(y.x + e0.x, y.y + e0.y);
              }
            }
            *reinterpret_cast<uint32_t*>(A + fr.trow[hf] * ld + n) = bf16x2(y.x, y.y);
          }
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<uint32_t*>(A + fr.trow[hf] * ld + n) = 0u;
        }
      }
    }
    consumer_sync(kThreads);  // the hidden tile is whole

    // ---- conv2 from the hidden tile, which then takes x again (the skip's,
    // or the next tile's)
    for (int t = 0; t < p.K; ++t)
      for (int c = 0; c < cout16; c += p.ck[1])
        rg.stage(acc, a_lane + 2 * (t * ld + c), min(p.ck[1], cout16 - c) >> 4, t + c == 0);
    rg.drain(acc);
    mbar_arrive(afree);

    // ---- h = mish(GN(h)); out = h + x, or h + the skip conv on the centre
    // rows of x, which the wgmmas compute afresh
    const Norm nm = group_norm<N>(acc, p.b2, p, fr, stat, ctid, kThreads);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = fr.col + 8 * j;
      if (n - (n & 7) >= Cout) continue;
      const float2 b = load_bf16x2(p.b2 + n), gs = load_bf16x2(p.g2s + n),
                   gb = load_bf16x2(p.g2b + n);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (fr.s[hf] >= nS) continue;
        const float2 v = gn_mish<N>(acc, nm, fr, j, hf, b, gs, gb);
        float2 r;  // the residual
        if (!p.has_skip) {
          r = load_act2(p.x, out_at(hf, n), p.x_bf16);
        } else if constexpr (kEarly) {
          const float2 bk = load_bf16x2(p.bskip + n);
          r = make_float2(acc_skip[4 * j + 2 * hf] + bk.x, acc_skip[4 * j + 2 * hf + 1] + bk.y);
        } else {
          store(out_at(hf, n), v);
          continue;
        }
        store(out_at(hf, n), make_float2(v.x + r.x, v.y + r.y));
      }
    }
    if (!kEarly && p.has_skip) {
      for (int f = 0; f < p.nfill; ++f, ++fill) {
        const int w = min(p.XC, cin16 - f * p.XC);
        mbar_wait(xfull, fill & 1);
        for (int c = 0; c < w; c += p.ck[2])
          rg.stage(acc, a_lane + 2 * (P * ld + c), min(p.ck[2], w - c) >> 4, f + c == 0);
        mbar_arrive(afree);
      }
      rg.drain(acc);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = fr.col + 8 * j;
        if (n - (n & 7) >= Cout) continue;
        const float2 bk = load_bf16x2(p.bskip + n);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (fr.s[hf] >= nS) continue;
          const size_t o = out_at(hf, n);
          const float2 h = load_out2(p, o);  // this thread's own store
          store(o, make_float2(h.x + acc[4 * j + 2 * hf] + bk.x,
                               h.y + acc[4 * j + 2 * hf + 1] + bk.y));
        }
      }
    }
    consumer_sync(kThreads);  // the stat tables are free for the next tile
  }
}

template <int N, int NWG>
__global__ void __launch_bounds__(Cfg<N, NWG>::kThreads, Cfg<N, NWG>::kMinBlocks)
film_resblock_bf16_kernel(const __grid_constant__ CUtensorMap tm1,
                          const __grid_constant__ CUtensorMap tm2,
                          const __grid_constant__ CUtensorMap tms, const Params p) {
  using C = Cfg<N, NWG>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the ring's swizzle atoms want 1024-byte alignment
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(base);
  bf16_t* A = reinterpret_cast<bf16_t*>(base + p.NS * C::kStageBytes);  // R x ld activations
  float* stat = reinterpret_cast<float*>(A + p.R * p.ld);               // mean, rstd tables
  // full[NS], empty[NS], xfull, afree
  const uint32_t bars = smem_addr(stat + 2 * (kRows / (p.H < 16 ? p.H : 16)) * p.ldb);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.NS; ++i) {
      mbar_init(bars + 8 * i, 1);                     // the producer's arrive + the TMA bytes
      mbar_init(bars + 8 * (p.NS + i), 4 * NWG);      // one arrive per consumer warp
    }
    mbar_init(bars + 16 * p.NS, kLoaderThreads);      // x staged
    mbar_init(bars + 16 * p.NS + 8, 128 * NWG);       // the activation tile free for x
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0)
      produce<N, NWG>(p, &tm1, &tm2, &tms, ring, bars, bars + 8 * p.NS);
    else if (threadIdx.x >= 32)
      load_x(p, A, threadIdx.x - 32, bars + 16 * p.NS, bars + 16 * p.NS + 8);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  consume<N, NWG>(p, ring, bars, A, stat, threadIdx.x - 128);
}

// ---------------------------------------------------------------------------
// host

// w (K, C, Cout) BF16 as a 3-d map (Cout, C, K); a box of atom columns x
// `rows` channels x 1 tap
template <int N, int NWG>
int encode(CUtensorMap* map, const void* w, int C, int Cout, int K, int rows) {
  using Cf = Cfg<N, NWG>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, (cuuint64_t)K};
  const cuuint64_t strides[2] = {2ull * Cout, 2ull * C * Cout};
  const cuuint32_t box[3] = {(cuuint32_t)Cf::kAtomN, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        N == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int N, int NWG>
int launch(Params p, const Plan& pl, const void* w1, const void* w2, const void* wskip,
           cudaStream_t stream) {
  using C = Cfg<N, NWG>;
  const int cin16 = round_up(p.Cin, 16), cout16 = round_up(p.Cout, 16);
  p.ck[0] = p.ck[2] = min(C::kCK, min(pl.XC, cin16));
  p.ck[1] = min(C::kCK, cout16);
  for (int i = 0; i < 3; ++i) p.tx[i] = (uint32_t)(C::kBoxes * C::kRowBytes * p.ck[i]);
  CUtensorMap maps[3];
  int err = encode<N, NWG>(&maps[0], w1, p.Cin, p.Cout, p.K, p.ck[0]);
  if (!err) err = encode<N, NWG>(&maps[1], w2, p.Cout, p.Cout, p.K, p.ck[1]);
  if (!err)
    err = p.has_skip ? encode<N, NWG>(&maps[2], wskip, p.Cin, p.Cout, 1, p.ck[2])
                     : encode<N, NWG>(&maps[2], w2, p.Cout, p.Cout, p.K, p.ck[1]);
  if (err) return err;
  auto kernel = film_resblock_bf16_kernel<N, NWG>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  // persistent: as many blocks as fit on the device at once, each walking
  // its tiles
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads,
                                                         pl.smem)) != cudaSuccess)
    return (int)e;
  p.ntiles = (p.B + p.S - 1) / p.S;
  p.skip_early = p.has_skip && N <= 64;
  const int grid = min(p.ntiles, max(1, per_sm) * sms);
  kernel<<<grid, C::kThreads, pl.smem, stream>>>(maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output rows of a tile (its samples are 64 / H), or -1 if the route does
// not take the Cout.
int film_resblock_bf16_block_rows(int Cout) {
  return Cout > 0 && Cout % 8 == 0 && Cout <= 512 ? kRows : -1;
}

// The plan for a shape, or -1 if the route does not take it: out[0..10] =
// output channels of a tile (padded), consumer warpgroups, samples per
// tile, tile rows, row stride (BF16), x fill width and count, ring stages,
// input channels per stage, shared memory bytes, blocks per SM.
int film_resblock_bf16_plan(int B, int H, int Cin, int Cout, int K, int G, long long* out) {
  Plan pl;
  if (!make_plan(B, H, Cin, Cout, K, G, &pl)) return -1;
  const long long v[11] = {pl.N * pl.NWG, pl.NWG, pl.S, pl.R, pl.ld, pl.XC, pl.nfill, pl.NS,
                           pl.CK, pl.smem, pl.blocks};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// Most dynamic shared memory a block may opt in to on `device`, or -1.
int film_resblock_bf16_max_smem_optin(int device) { return max_smem_optin(device); }

const char* film_resblock_bf16_error_string(int err) { return launch_error_string(err); }

// x (B, H, Cin) f32 (x_bf16 0) or BF16 (1); emb (B, Cout) or (B, 2*Cout)
// with film_scale, f32 (emb_bf16 0) or BF16 (1); w1 (K, Cin, Cout), w2 (K,
// Cout, Cout), wskip (Cin, Cout) or null (then Cin == Cout), vectors (Cout,),
// all BF16; out (B, H, Cout), BF16 when x and emb both are, else f32; all
// contiguous, 16-byte aligned. Launches on `stream` and returns 0 on success
// (else a cudaError_t, or a code that film_resblock_bf16_error_string
// names); does not synchronise.
int film_resblock_forward_bf16(const void* x, const void* emb, const void* w1, const void* b1,
                               const void* g1s, const void* g1b, const void* w2, const void* b2,
                               const void* g2s, const void* g2b, const void* wskip,
                               const void* bskip, void* out, int B, int H, int Cin, int Cout,
                               int K, int G, int film_scale, int x_bf16, int emb_bf16, float eps,
                               void* stream) {
  Plan pl;
  if (!make_plan(B, H, Cin, Cout, K, G, &pl) || (wskip == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x, p.emb = emb, p.out = out;
  p.b1 = static_cast<const bf16_t*>(b1), p.g1s = static_cast<const bf16_t*>(g1s);
  p.g1b = static_cast<const bf16_t*>(g1b), p.b2 = static_cast<const bf16_t*>(b2);
  p.g2s = static_cast<const bf16_t*>(g2s), p.g2b = static_cast<const bf16_t*>(g2b);
  p.bskip = static_cast<const bf16_t*>(bskip);
  p.B = B, p.H = H, p.Cin = Cin, p.Cout = Cout, p.K = K, p.G = G, p.film_scale = film_scale;
  p.lgH = 0;
  while ((1 << p.lgH) < H) ++p.lgH;
  p.x_bf16 = x_bf16, p.emb_bf16 = emb_bf16, p.out_bf16 = x_bf16 && emb_bf16;
  p.has_skip = wskip != nullptr;
  p.eps = eps;
  p.S = pl.S, p.R = pl.R, p.ld = pl.ld, p.XC = pl.XC, p.nfill = pl.nfill, p.NS = pl.NS;
  p.ldb = pl.ldb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.NWG == 2)
    return pl.N == 128 ? launch<128, 2>(p, pl, w1, w2, wskip, st)
                       : launch<256, 2>(p, pl, w1, w2, wskip, st);
  switch (pl.N) {
    case 32: return launch<32, 1>(p, pl, w1, w2, wskip, st);
    case 64: return launch<64, 1>(p, pl, w1, w2, wskip, st);
    default: return launch<128, 1>(p, pl, w1, w2, wskip, st);
  }
}

}  // extern "C"
