// Flash attention prefill for Hopper (sm_90a): TMA, mbarriers and wgmma.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py for bf16 calls with more than 64
// query rows per KV head at head dims 64, 80, 96, 128, 192 and 256 (the
// serving path's prefill at 64 and 128, hubert-xlarge's encoder at 80,
// nemotron-4-340b and deepseek's MLA prefill at 192, gemma3-4b at 256).
// For every query row of every (batch, query head) it computes
//
//   o = softmax(q . k^T) . v      over the keys kpos < kv_len
//                                 (and kpos <= q_offset + qpos when causal,
//                                 and kpos > q_offset + qpos - window when
//                                 a sliding window is given)
//
// with q pre-scaled by d**-0.5 and rounded to bf16 as the TPU kernel does,
// logits, softmax and accumulation in fp32, p rounded to bf16 for the second
// product, and the output in bf16.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3): at the serving
// prefill (B 4, Hq 32, Hkv 8, S 1024, D 64, causal) the two products are
// 17.2 GFLOP, 17.4 us at the tensor-core rate, against 12.5 us for the
// 42 MB of Q/K/V/O: operations bound it, so the products must run on the
// tensor cores and the K/V stream must overlap them.  At hubert-xlarge's
// call (B 4, H 16, S 1024, D 80, not causal) the products are 21.5 GFLOP,
// 21.7 us, against 12.5 us for its 41.9 MB.  At gemma3-4b's prefill (B 4,
// Hq 8, Hkv 4, S 2048, D 256, causal, window 1024) the window leaves 1.57 M
// (query, key) pairs a head: 51.6 GFLOP, 52 us, against 30 us for 101 MB.
//
// Design (FlashAttention-3's shape).  A work item is a tile of 128 query
// rows of one (batch, KV head); its rows are (position, head) pairs of the KV
// head's query group, row = s * group + g, so the group shares every K/V
// tile and K/V are never repeated; a group that does not divide 128 (7 for
// qwen2-vl-7b) leaves the spare rows zero and unwritten.  The kernel is
// persistent: one block of 384 threads per SM walks the items longest first.
// Warpgroup 0 is the producer: one thread brings each item's Q by TMA into
// one of two buffers and streams its K and V tiles of 128 keys (64 at D 192
// and 256) into a ring of stages (three at D 64, two above), 128-byte
// swizzled, each buffer
// and stage guarded by a "full" and an "empty" mbarrier, running ahead into
// the next item while the consumers finish one; `setmaxnreg` gives its
// registers to the two consumer warpgroups, which own 64 query rows each.
// A consumer pre-scales and rounds its Q rows in place, then per KV tile:
// S = Q . K^T by wgmma (A and B from shared memory, K-major), the online
// softmax in fp32 registers (running max m, per-thread partial sums l),
// P converted to bf16 in registers, and O += P . V by wgmma (A = P from
// registers, B = the V tile, MN-major).  The softmax of tile t + 1 runs
// while the tensor cores do P_t . V_t.  KV tiles wholly above the diagonal
// are never loaded; the tile that crosses it, and the last one, are masked.
// With a sliding window the tiles wholly below every row's window are never
// loaded either (an item's first tile is the one holding the least key its
// first row sees), and the tiles that cross the window's edge are masked.
//
// Head dims 80 and 96 are not multiples of the 64-column swizzle atom: they
// run on a padded tile of two atoms, as D 128 does.  TMA reads the second
// atom past the tensor's D (each map's innermost dimension is the true D,
// never the row of all heads) and fills the missing columns with zeros, so
// Q, K and V tiles are zero beyond D.  S = Q . K^T runs at the true depth
// (D / 16 k-steps of 16 columns, 5 at D 80, 6 at D 96), O += P . V at width
// 128, and the store writes only the true D's columns; the softmax scale is
// the true D's (the wrapper passes it).  The padding costs P . V 128 / D of
// its products: (D + 128) / 2D of the needed work in all, 1.30x at D 80 and
// 1.17x at D 96.
//
// Head dims 192 and 256 are three and four whole atoms, unpadded.  At
// 128-key tiles they would not fit: D 256 needs 128 KB for two Q buffers
// and 64 KB a K/V stage, and its consumers' registers would hold 128 O
// accumulators and 64 scores a thread.  So, as FlashAttention-3 does for
// large head dims, their KV tiles are 64 keys (S = Q . K^T by m64n64k16,
// 32 scores a thread): D 192 keeps two Q buffers (96 KB) and two stages
// (96 KB), D 256 one Q buffer (64 KB) and two stages (128 KB), 192 KB
// each.  O += P . V runs as 128-column wgmmas over atom pairs (and one
// 64-column wgmma over D 192's third atom).  With one Q buffer the
// producer waits for the consumers to release Q before it loads the next
// item's; each consumer warpgroup releases it as soon as its last score
// product has read it, so that load overlaps the item's last P . V and
// its output store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Strides;
using flash::smem_u32;

constexpr int kConsumers = 2;
constexpr int kRows = 64 * kConsumers;         // query rows per work item
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kAtom = 64;                      // bf16 per 128-byte swizzled row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Keys per KV tile: 128, or 64 at D 192 / 256 (shared memory and registers).
__host__ __device__ constexpr int keys_for(int d) { return d >= 192 ? 64 : 128; }

// Shared memory: Q buffers (two where they fit: an item's Q arrives while
// the last item computes) and a ring of K/V stages, three at D 64 and two
// above (227 KB is the limit), all 1024-byte aligned for the 128-byte
// swizzle; then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kKeys = keys_for(D);
  static constexpr int kPad = D == 64 ? 64 : D <= 128 ? 128 : D;  // D in whole atoms
  static constexpr int kStages = kPad == 64 ? 3 : 2;
  static constexpr int kQBufs = kPad == 256 ? 1 : 2;
  static constexpr int kChunks = kPad / kAtom;             // 128-byte atoms per row
  static constexpr int kQRegion = kRows * 128;             // one atom column of Q
  static constexpr int kKVRegion = kKeys * 128;            // one atom column of K or V
  static constexpr int kQTile = kChunks * kQRegion;        // one Q buffer
  static constexpr int kTile = kChunks * kKVRegion;        // one K or V tile
  static constexpr int kQ = 0;                             // + buffer * kQTile
  static constexpr int kK = kQ + kQBufs * kQTile;          // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;
  // full[kStages], empty[kStages], qfull[kQBufs], qempty[kQBufs]
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (2 * kStages + 2 * kQBufs) * 8;
  static constexpr int kAlloc = kBytes + 1024;             // room to align to 1024 B
  static_assert(kAlloc <= 232448, "past the 227 KB of shared memory a block may have");
};

struct Params {
  __nv_bfloat16* o;
  Strides os;
  int batch, sq, hkv, group, npos, q_tiles, causal, q_offset, n_live;
  int window;           // sliding window (keys > qpos - window), 0 for none
  int q_bytes;          // bytes one Q buffer receives (group x npos rows,
                        // whole atoms: TMA counts the zero fill past D)
  float scale;
};

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A phase
// that never completes is a bug; trap after 2**26 polls (far longer than any
// tile takes) rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA tile of a 4-D tensor map into shared memory; completion is counted
// in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor for wgmma, 128-byte swizzle.  K-major
// tiles (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused.  MN-major tiles (V): SBO steps 8 keys (1024
// bytes), LBO steps from one 64-column atom to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The two consumer warpgroups take turns issuing their products
// (FlashAttention-3's ping-pong): a warpgroup waits for its turn on named
// barrier 3 + cw, issues, and hands the turn to the other, so one
// warpgroup's softmax runs while the other's products occupy the tensor
// cores.  Both count 256 threads: one warpgroup syncs, the other arrives.
__device__ __forceinline__ void wait_turn(int cw) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + cw) : "memory");
}
__device__ __forceinline__ void pass_turn(int cw) {
  asm volatile("bar.arrive %0, 256;" ::"r"(3 + (cw ^ 1)) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// -- wgmma products (fp32 accumulators, bf16 operands) ----------------------

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A from registers, B MN-major in shared
// memory.  D is accumulators OFF .. OFF + 31 of an N-float fragment (its
// columns 2 OFF .. 2 OFF + 63).
template <int N, int OFF>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[N], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  static_assert(OFF + 32 <= N, "the product's accumulators lie in d");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A from registers, B MN-major in
// shared memory; D is accumulators OFF .. OFF + 63 of an N-float fragment.
template <int N, int OFF>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[N], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  static_assert(OFF + 64 <= N, "the product's accumulators lie in d");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// -- the consumer's steps ----------------------------------------------------

// Online-softmax state of a thread's two rows: running maxima, partial sums
// (the quad adds them at the end), and the last tile's rescale factors.
struct Rows {
  float m0, m1, l0, l1, a0, a1;
};

// What masks a score: keys at or past n_live, when causal keys past the
// row's position, and keys at or below the row's position less the window
// (`win` is 2**30 without one).  first_qpos / last_qpos are the item's
// least and greatest row positions, qp0 / qp1 the thread's rows'.
struct Mask {
  int n_live, causal, first_qpos, last_qpos, win, qp0, qp1, col;
};

// S = Q . K^T of one KV tile into sc, issued and committed, not waited for;
// D / 16 k-steps, so a padded tile's zero columns are never multiplied.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[Layout<D>::kKeys / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
  using L = Layout<D>;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;                  // 16 columns = 32 bytes
    const uint64_t da = smem_desc(q_addr + (kk / 4) * L::kQRegion + off, 0);
    const uint64_t db = smem_desc(k_addr + (kk / 4) * L::kKVRegion + off, 0);
    if constexpr (L::kKeys == 128) {
      wgmma_m64n128k16_ss(sc, da, db, kk > 0);
    } else {
      wgmma_m64n64k16_ss(sc, da, db, kk > 0);
    }
  }
  wgmma_commit();
  fence_regs(sc);
}

// O += P . V of one KV tile (A = P from registers, B = V, MN-major) at the
// padded width, issued and committed, not waited for: one wgmma a k-step
// up to 128 columns, then one per further 128 (or, at D 192, 64) columns.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Layout<D>::kPad / 2],
                                         const uint32_t (&pa)[Layout<D>::kKeys / 16][4],
                                         uint32_t v_addr) {
  using L = Layout<D>;
  constexpr int N = L::kPad / 2;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk) {
    const uint32_t vk = v_addr + kk * 16 * 128;          // 16 keys = 16 rows of 128 bytes
    const uint64_t dv = smem_desc(vk, L::kKVRegion);
    if constexpr (L::kPad == 64) {
      wgmma_m64n64k16_rs<N, 0>(o, pa[kk], dv);
    } else {
      wgmma_m64n128k16_rs<N, 0>(o, pa[kk], dv);
      if constexpr (L::kChunks > 2) {                    // atoms 2 (and 3)
        const uint64_t dv2 = smem_desc(vk + 2 * L::kKVRegion, L::kKVRegion);
        if constexpr (L::kChunks == 4) {
          wgmma_m64n128k16_rs<N, 64>(o, pa[kk], dv2);
        } else {
          wgmma_m64n64k16_rs<N, 64>(o, pa[kk], dv2);
        }
      }
    }
  }
  wgmma_commit();
  fence_regs(o);
}

// Mask the tile of keys kv0 .. kv0 + KEYS - 1, update the rows' (m, l) and
// turn the scores into probabilities in place.  Without a window
// (kWindowed false) no test of it is compiled.
template <int KEYS, bool kWindowed>
__device__ __forceinline__ void softmax(float (&sc)[KEYS / 2], Rows& r, const Mask& mk,
                                        int kv0) {
  if (kv0 + KEYS > mk.n_live || (mk.causal && kv0 + KEYS - 1 > mk.first_qpos) ||
      (kWindowed && kv0 <= mk.last_qpos - mk.win)) {
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kv0 + 8 * j + mk.col + e;
        const bool out = kp >= mk.n_live;
        if (out || (mk.causal && kp > mk.qp0) || (kWindowed && kp <= mk.qp0 - mk.win)) {
          sc[4 * j + e] = -INFINITY;
        }
        if (out || (mk.causal && kp > mk.qp1) || (kWindowed && kp <= mk.qp1 - mk.win)) {
          sc[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  }
  // A row's KEYS scores lie in the 4 lanes of a quad.
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  // Scaled maxima; 0 while a row has seen no key, so nothing becomes NaN.
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * flash::kLog2e;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * flash::kLog2e;
  r.a0 = flash::ex2(r.m0 * flash::kLog2e - ms0);
  r.a1 = flash::ex2(r.m1 * flash::kLog2e - ms1);
  r.m0 = mn0;
  r.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    sc[4 * j] = flash::ex2(sc[4 * j] * flash::kLog2e - ms0);
    sc[4 * j + 1] = flash::ex2(sc[4 * j + 1] * flash::kLog2e - ms0);
    sc[4 * j + 2] = flash::ex2(sc[4 * j + 2] * flash::kLog2e - ms1);
    sc[4 * j + 3] = flash::ex2(sc[4 * j + 3] * flash::kLog2e - ms1);
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l0 = r.l0 * r.a0 + sum0;
  r.l1 = r.l1 * r.a1 + sum1;
}

// Rescale o's true columns by the last factors (a padded tile's others stay
// zero) and take the probabilities to bf16: the S fragment of keys 16 kk ..
// 16 kk + 15 is wgmma's A fragment for that k-step, so no data moves between
// threads.
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[Layout<D>::kPad / 2],
                                                 uint32_t (&pa)[Layout<D>::kKeys / 16][4],
                                                 const float (&sc)[Layout<D>::kKeys / 2],
                                                 const Rows& r) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= r.a0;
    o[4 * j + 1] *= r.a0;
    o[4 * j + 2] *= r.a1;
    o[4 * j + 3] *= r.a1;
  }
#pragma unroll
  for (int kk = 0; kk < Layout<D>::kKeys / 16; ++kk) {
    pa[kk][0] = flash::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = flash::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = flash::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = flash::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// -- the kernel --------------------------------------------------------------

// One work item: a tile of kRows query rows of one (batch, KV head), and
// the KV tiles [t0, t1) some row of it attends.  Items are numbered
// longest first (the highest query tile of every head, then the next), so
// a persistent block that takes items blockIdx.x, blockIdx.x + gridDim.x,
// ... meets the causal triangle's long items first.
struct Item {
  int b, hk, pos0, n_rows, t0, t1;
};

template <int KEYS, bool kWindowed>
__device__ __forceinline__ Item make_item(const Params& p, int idx) {
  const int bh_count = p.batch * p.hkv;
  const int qtile = p.q_tiles - 1 - idx / bh_count, bh = idx % bh_count;
  Item it;
  it.b = bh / p.hkv;
  it.hk = bh % p.hkv;
  it.pos0 = qtile * p.npos;
  it.n_rows = min(p.npos, p.sq - it.pos0) * p.group;
  it.t1 = (p.n_live + KEYS - 1) / KEYS;
  if (p.causal) {  // tiles wholly above the item's last query row are skipped
    const int last = p.q_offset + it.pos0 + it.n_rows / p.group - 1;
    it.t1 = min(it.t1, last < 0 ? 0 : last / KEYS + 1);
  }
  it.t0 = 0;
  if (kWindowed) {  // and tiles wholly below its first row's window
    const int lo = p.q_offset + it.pos0 - p.window + 1;
    if (lo > 0) it.t0 = min(lo / KEYS, it.t1);
  }
  return it;
}

template <int D, bool kWindowed>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  constexpr int kQBufs = L::kQBufs;
  constexpr int kKeys = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + kQBufs;
  const int tid = threadIdx.x;
  const int wg = tid / 128;                              // 0 producer, 1.. consumers
  const int n_items = p.q_tiles * p.batch * p.hkv;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int s = 0; s < kQBufs; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the Q buffers and the ring of K/V
    // stages full, running ahead into the block's next item while the
    // consumers finish one ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      int g = 0;                                         // ring position
      int n = 0;                                         // items so far
      for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++n) {
        const Item it = make_item<kKeys, kWindowed>(p, idx);
        const int qb = n % kQBufs;
        mbar_wait(&qempty[qb], ((n / kQBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[qb], p.q_bytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(smem + L::kQ + qb * L::kQTile + c * L::kQRegion, &qmap, &qfull[qb],
                      c * kAtom, it.hk * p.group, it.pos0, it.b);
        }
        for (int t = it.t0; t < it.t1; ++t, ++g) {
          const int s = g % kStages;
          mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load_4d(smem + L::kK + s * L::kTile + c * L::kKVRegion, &kmap, &full[s],
                        c * kAtom, t * kKeys, it.hk, it.b);
            tma_load_4d(smem + L::kV + s * L::kTile + c * L::kKVRegion, &vmap, &full[s],
                        c * kAtom, t * kKeys, it.hk, it.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int ctid = tid - 128 * wg;
  const int warp = ctid / 32, lane = ctid % 32;
  // This thread's two rows of the accumulators (wgmma's fragment layout).
  const int r0 = cw * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int col = 2 * (lane % 4);
  const int win = p.window > 0 ? p.window : (1 << 30);
  const uint32_t k_addr = smem_u32(smem + L::kK), v_addr = smem_u32(smem + L::kV);
  int g = 0;                                             // ring position
  int n = 0;                                             // items so far
  if (cw == 0) asm volatile("bar.arrive 3, 256;" ::: "memory");  // warpgroup 0 goes first

  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++n) {
    const Item it = make_item<kKeys, kWindowed>(p, idx);
    const int qb = n % kQBufs;
    uint8_t* qtile = smem + L::kQ + qb * L::kQTile;
    const uint32_t q_addr = smem_u32(qtile) + cw * 64 * 128;

    // Q rows [64 cw, 64 cw + 64) as TMA left them (positions past Sq and
    // columns past D are zero), pre-scaled and rounded in place; rows past
    // the item's are zeroed.  Elementwise over every 16-byte chunk of the
    // padded row, so the swizzle does not matter (a padded atom's true
    // columns sit in chunks that the swizzle moves with the row).
    mbar_wait(&qfull[qb], (n / kQBufs) & 1);
    for (int i = ctid; i < 64 * (L::kPad / 8); i += 128) {
      const int r = cw * 64 + i / (L::kPad / 8);
      const int c = i % (L::kPad / 8);
      uint4* chunk = reinterpret_cast<uint4*>(qtile + (c / 8) * L::kQRegion + r * 128 +
                                              (c % 8) * 16);
      *chunk = r < it.n_rows ? flash::scale_round8(*chunk, p.scale) : make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");

    const int first_qpos = p.q_offset + it.pos0;         // the item's least position
    const Mask mask = {p.n_live,
                       p.causal,
                       first_qpos,
                       first_qpos + it.n_rows / p.group - 1,
                       win,
                       first_qpos + r0 / p.group,
                       first_qpos + r1 / p.group,
                       col};
    float o[L::kPad / 2];
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) o[i] = 0.f;
    Rows rows = {-INFINITY, -INFINITY, 0.f, 0.f, 1.f, 1.f};
    float sc[kKeys / 2];         // scores, then probabilities, of one KV tile
    uint32_t pa[kKeys / 16][4];  // the last tile's probabilities in bf16 (wgmma A fragments)

    // Software pipeline (the last iteration peeled, so every group is
    // issued unconditionally): while the tensor cores run O += P_t . V_t,
    // the warpgroup's softmax of tile t + 1 waits only for S_{t+1}.  With
    // one Q buffer Q is released as soon as the last S product is done;
    // with two, after the item (a load never waits for it then).
    constexpr bool kEarly = kQBufs == 1;
    const int nt = it.t1 - it.t0;
    const int kv0 = it.t0 * kKeys;
    if (nt > 0) {
      mbar_wait(&full[g % kStages], (g / kStages) & 1);
      wait_turn(cw);
      issue_scores<D>(sc, q_addr, k_addr + (g % kStages) * L::kTile);
      pass_turn(cw);
      wgmma_wait<0>();
      fence_regs(sc);
      if (kEarly && nt == 1) mbar_arrive(&qempty[qb]);
      softmax<kKeys, kWindowed>(sc, rows, mask, kv0);
      rescale_and_pack<D>(o, pa, sc, rows);
      for (int t = 0; t < nt - 1; ++t) {
        const int s0 = (g + t) % kStages, s1 = (g + t + 1) % kStages;
        mbar_wait(&full[s1], ((g + t + 1) / kStages) & 1);
        wait_turn(cw);
        issue_scores<D>(sc, q_addr, k_addr + s1 * L::kTile);
        issue_pv<D>(o, pa, v_addr + s0 * L::kTile);
        pass_turn(cw);
        wgmma_wait<1>();   // S_{t+1} is done; P_t . V_t may still run
        fence_regs(sc);
        if (kEarly && t == nt - 2) mbar_arrive(&qempty[qb]);
        softmax<kKeys, kWindowed>(sc, rows, mask, kv0 + (t + 1) * kKeys);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[s0]);
        rescale_and_pack<D>(o, pa, sc, rows);
      }
      const int s_last = (g + nt - 1) % kStages;
      wait_turn(cw);
      issue_pv<D>(o, pa, v_addr + s_last * L::kTile);
      pass_turn(cw);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[s_last]);
      g += nt;
    }
    if (!kEarly || nt == 0) mbar_arrive(&qempty[qb]);

    float l0 = rows.l0, l1 = rows.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= it.n_rows) continue;
      const float inv = half ? inv1 : inv0;
      const int s = it.pos0 + r / p.group, h = it.hk * p.group + r % p.group;
      __nv_bfloat16* out = p.o + it.b * p.os.b + s * p.os.s + h * p.os.h + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {  // the true D's columns only
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            flash::pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, fetched once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-D bf16 tensor map of 64-column boxes, 128-byte swizzled; reads past
// the dims give zeros (at D 80 / 96 the second box's columns past D).  K
// and V: (D, S, H, B) in boxes of one KV tile's positions (keys_for(D)) of
// one head.  Q: (D, H, S, B) in boxes of `group` heads x `npos` positions,
// so a box's rows are the item's (position, head) rows in order.
int encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
               const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 2;
}

int encode_kv_map(CUtensorMap* map, const void* base, int d, int rows, int heads, int batch,
                  const Strides& st) {
  const cuuint32_t keys = static_cast<cuuint32_t>(keys_for(d));
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kAtom, keys, 1, 1};
  return encode_map(map, base, dims, strides, box);
}

int encode_q_map(CUtensorMap* map, const void* base, int d, int sq, int hq, int batch,
                 int group, int npos, const Strides& st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(hq),
                              static_cast<cuuint64_t>(sq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kAtom, static_cast<cuuint32_t>(group),
                             static_cast<cuuint32_t>(npos), 1};
  return encode_map(map, base, dims, strides, box);
}

template <int D, bool kWindowed>
cudaError_t launch_kernel(const CUtensorMap& qmap, const CUtensorMap& kmap,
                          const CUtensorMap& vmap, const Params& p, cudaStream_t stream) {
  static bool configured = false;  // checked and set once per kernel
  if (!configured) {
    // setmaxnreg moves registers between warpgroups of the block: the block
    // must start with enough for the consumers' 240, or their
    // setmaxnreg.inc would wait forever.
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_prefill_kernel<D, kWindowed>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * kThreads < 128 * kProducerRegs + 128 * kConsumers * kConsumerRegs) {
      return cudaErrorInvalidConfiguration;
    }
    err = cudaFuncSetAttribute(flash_prefill_kernel<D, kWindowed>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kAlloc);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  static int sms = 0;  // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
  }
  const int n_items = p.q_tiles * p.batch * p.hkv;
  if (n_items == 0) return cudaSuccess;
  const int grid = n_items < sms ? n_items : sms;
  Params pd = p;
  pd.q_bytes = Layout<D>::kChunks * p.q_bytes;
  flash_prefill_kernel<D, kWindowed>
      <<<grid, kThreads, Layout<D>::kAlloc, stream>>>(qmap, kmap, vmap, pd);
  return cudaGetLastError();
}

// A kernel without the window's tests serves the calls without a window, so
// they run the same code as before windows were taken.
template <int D>
cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                   const Params& p, cudaStream_t stream) {
  return p.window > 0 ? launch_kernel<D, true>(qmap, kmap, vmap, p, stream)
                      : launch_kernel<D, false>(qmap, kmap, vmap, p, stream);
}

}  // namespace

// Plain C entry, bound with ctypes.  Keys [0, n_live) are live; `window`
// > 0 also masks keys at or below each row's position less the window.
// Returns 0 when launched, a cudaError_t from the launch, or 1000 + 1
// (cuTensorMapEncodeTiled not found) / 1000 + 2 (a tensor map it refused);
// the wrapper raises on anything but 0.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* o, int batch,
                             int sq, int hq, int hkv, int d, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                             long long o_ss, long long o_sh, int causal, int q_offset,
                             int n_live, int window, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || window < 0 ||
      (d != 64 && d != 80 && d != 96 && d != 128 && d != 192 && d != 256)) {
    return cudaErrorInvalidValue;
  }
  const int group = hq / hkv, npos = kRows / group;
  CUtensorMap qmap, kmap, vmap;
  const int rows = n_live > 0 ? n_live : 1;
  int err = encode_q_map(&qmap, q, d, sq, hq, batch, group, npos, {q_sb, q_ss, q_sh});
  if (err == 0) err = encode_kv_map(&kmap, k, d, rows, hkv, batch, {k_sb, k_ss, k_sh});
  if (err == 0) err = encode_kv_map(&vmap, v, d, rows, hkv, batch, {v_sb, v_ss, v_sh});
  if (err != 0) return 1000 + err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.os = {o_sb, o_ss, o_sh};
  p.batch = batch;
  p.sq = sq;
  p.hkv = hkv;
  p.group = group;
  p.npos = npos;
  p.q_tiles = (sq + npos - 1) / npos;
  p.q_bytes = group * npos * 128;  // one atom column; launch<D> scales it
  p.causal = causal;
  p.q_offset = q_offset;
  p.n_live = n_live;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(qmap, kmap, vmap, p, s));
    case 80: return static_cast<int>(launch<80>(qmap, kmap, vmap, p, s));
    case 96: return static_cast<int>(launch<96>(qmap, kmap, vmap, p, s));
    case 128: return static_cast<int>(launch<128>(qmap, kmap, vmap, p, s));
    case 192: return static_cast<int>(launch<192>(qmap, kmap, vmap, p, s));
    default: return static_cast<int>(launch<256>(qmap, kmap, vmap, p, s));
  }
}
