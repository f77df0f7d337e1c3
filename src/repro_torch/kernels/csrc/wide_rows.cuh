// Wide row products on an H100: y = W x for a tall weight W [rows, M] (fp32
// or fp16) and an x [M, B] of more columns than the thin-row engine
// (thin_rows.cuh) takes well, reading W once for up to 256 columns of x.
// The engine of the wide-x entries of coded_matvec.cu (B1: repro/kernels/
// coded_matvec.py :: coded_matvec_pallas, def :47, pallas_call :65) and
// coded_decode.cu (B2: repro/kernels/coded_decode.py ::
// coded_matvec_decode_pallas, def :65, pallas_call :91); each source supplies
// a Task: which row of W each row of a tile is, and the epilogue.  The
// Pallas kernels read x [M, B] whole in one block at any B.  Below
// WIDE_MIN_B columns the thin-row engine (fp32 FMA, W read once) takes x:
// there it wins (chip_smoke.py --sweep-wide).
//
// What bounds it: at B up to about 100 on the served heads, reading W once
// (bytes(W) / 3.35 TB/s: 0.053 ms for a glm4-9b code block, 0.847 ms for its
// W_c); above that the operations.  fp32 FMA outside the tensor cores (67
// TFLOP/s) would bound a glm4-9b block at B = 128 to 0.169 ms, no better
// than cuBLAS's SGEMM, so the products run on the tensor cores with each
// fp32 operand split into three bf16 pieces, hi = bf16(v), mid = bf16(v -
// hi), lo = bf16(v - hi - mid) (their sum is v exactly), and six products
// taken: hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid; what is dropped
// (mid.lo, lo.mid, lo.lo) is below 2^-24 of |w||x|.  Each piece product is
// exact in the fp32 accumulator.  At 989 TFLOP/s that is 6x the work, 0.069
// ms at a glm4-9b block at B = 128.  This is neither TF32 nor a reduced
// precision mode.  fp16 inputs need no split: a product of two fp16 values
// is exact in fp32, so one fp16 product does it.  What the design does:
//  * A tile is 128 rows of W x up to 256 columns of x (a multiple of 32).
//    For the decode the 128 rows are bt = 128 / nb rows of each of the nb
//    code blocks, so a tile's decode needs nothing from another block.  x
//    wider than 256 columns runs in column tiles of equal width; W is read
//    once a column tile.  The K loop covers all of M in a tile.
//  * One launch, a persistent grid of one block an SM over the (row tile,
//    column tile) items, interleaved (block i takes items i, i + grid, ...),
//    so the SMs read one narrow window of W at a time.
//  * A block is a producer warpgroup (one warp of it loads; the group
//    hands its registers to the consumers by setmaxnreg) and two consumer
//    warpgroups (64 rows each).  The producer feeds a ring of shared-memory
//    stages: W's [128, 128 bytes] tile by TMA (a 2-D map; a 3-D map over
//    W_c as [nb, br, M] brings a decode tile in one copy), and x's pieces
//    by TMA, each stage completing its full mbarrier; the consumers free it
//    on its empty one.  W the TMA cannot take (a row pitch or base not
//    16-byte aligned: a code block view that starts mid-row, M % 4 != 0)
//    the producer warp loads itself into the same stages, in the same
//    layout.
//  * x is split once a call by a pre-pass (wide_split_x) into its pieces,
//    transposed to [piece][column][M] bf16 (fp16 for fp16 x), zero-padded,
//    so no block converts x again; wgmma reads them from shared memory
//    (64- or 128-byte swizzle, K-major).  W is loaded fp32, split in
//    registers and fed to wgmma's A operand from there (m64n32k16).
//  * Sums: a stage's products for 32 columns (a group: its k16 steps' six
//    products each) go into a fresh accumulator, which the CUDA cores then
//    add to the tile's fp32 sums, so the tensor cores' own accumulation
//    (which aligns and truncates) spans one stage, not the 6 x M / 16
//    products of a row.  A warpgroup waits for each group before it adds
//    it: ptxas serializes every wgmma of a kernel that reads an
//    accumulator while a later group may be in flight.  The K order is
//    fixed, there are no atomics, and a column's sums are taken by the same
//    instructions whatever else the call holds, so column j of a 64-wide
//    call is bit-equal to the same column in a 17-wide call.
//  * The decode's epilogue contracts a tile's [nb, bt, 32] coded sums with
//    R in shared memory, 32 columns at a time, and writes only [n_data, bt,
//    32]; R's zero columns keep an erased block's finite garbage out.
//  * A Task may declare kTransposedW: W is then the transpose of a
//    row-major source S [K, rows] (gaussian_encode.cu's dense encode, W =
//    A^T).  A stage's W tile arrives as four TMA boxes [32 K][32 rows] of S
//    (128-byte swizzle), the consumers read each fragment element by
//    element in that layout (no bank conflicts: Frags<float>::load), the producer's
//    own loads fill the same layout, and the items run column-tile-minor,
//    so the column tiles that share a W tile are in flight together and
//    the L2 serves all but the first of its reads.
// Offsets are 64-bit.  The launch geometry is computed by the wrapper
// (kernels/wide_rows.py::wide_plan); geometry() below computes it again and
// the C entries refuse a mismatch.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace wide_rows {

// ---- fixed geometry (mirrored in kernels/wide_rows.py)
constexpr int kTileRows = 128;       // rows of W a tile (two warpgroups of 64)
constexpr int kColQuantum = 32;      // columns of one wgmma (m64n32k16)
constexpr int kMaxTileCols = 256;    // columns of x a tile at most
constexpr int kMaxStages = 6;        // stages of the ring at most (12 measured no faster)
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // and the producer's warpgroup
constexpr int kProducerRegs = 56;    // registers a thread after setmaxnreg: producer
constexpr int kConsumerRegs = 224;   //   and consumers (128 x 56 + 256 x 224 <= 65536)
constexpr int kWRowBytes = 128;      // a W row's share of a stage (32 fp32, 64 fp16)
constexpr int kEpiPitch = kColQuantum + 1;  // floats a row of the decode's scratch
constexpr int kAlign = 1024;         // the ring's alignment (128-byte swizzle atoms)
constexpr int kBarrierBytes = 16 * kMaxStages;  // full[] and empty[] mbarriers
constexpr int kSmemLimit = 227 * 1024;          // dynamic shared memory a block may use
constexpr int kMaxBlocks = 32;       // code blocks of the decode at most
constexpr int kTBoxRows = 32;        // a transposed W tile: boxes of [32 K][32 rows] fp32
constexpr int kTBoxBytes = kTBoxRows * kWRowBytes;

// Whether a Task's W is the transpose of its row-major source (Task::kTransposedW)
template <class Task, class = void>
struct transposed_w : std::false_type {};
template <class Task>
struct transposed_w<Task, std::void_t<decltype(Task::kTransposedW)>>
    : std::integral_constant<bool, Task::kTransposedW> {};

// A launch's geometry; see geometry().
struct Geometry {
  int64_t m;          // columns of W, rows of x
  int64_t rows;       // rows of W (coded_matvec) or of a code block, br (decode)
  int n_row_tiles;    // row tiles
  int n_col_tiles;    // column tiles
  int items;          // n_row_tiles * n_col_tiles
  int bk;             // W elements of a row in a stage
  int k_tiles;        // stages of the K loop: ceil(m / bk)
  int m_pad;          // k_tiles * bk: x's pieces' row length
  int b;              // columns of x
  int cols;           // columns of a tile (a multiple of 32)
  int b_pad;          // n_col_tiles * cols: x's pieces' columns
  int pieces;         // x's pieces: 3 (fp32) or 1 (fp16)
  int x_row_bytes;    // bytes of a piece's column in a stage (bk * 2)
  int nb, n_data;     // decode: code blocks and decoded blocks (0 for coded_matvec)
  int bt;             // decode: rows of each block a tile (128 / nb); 0 for coded_matvec
  int tile_rows;      // rows a tile loads: 128, or nb * bt
  int w_bytes;        // a stage's W tile (128 rows of kWRowBytes)
  int stage_bytes;    // w_bytes + x's pieces
  int stages;         // the ring
  int bar_off;        // byte offsets from the aligned base: mbarriers,
  int epi_off;        //   the decode's scratch [128][kEpiPitch] fp32,
  int rec_off;        //   R transposed [nb][n_data rounded up to 8] fp32
  int smem_bytes;     // dynamic shared memory of the launch (alignment slack included)
  int tma_w;          // W by TMA (else the producer warp's loads)
};

__host__ __device__ constexpr int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The geometry of y = W x for x [m, b] of elt_bytes elements: coded_matvec
// over `rows` rows when nb == 0, else the decode over nb code blocks of
// `rows` rows each with n_data decoded blocks.  Mirrors
// kernels/wide_rows.py::wide_plan.
inline Geometry geometry(int64_t rows, int64_t m, int b, int elt_bytes, int nb, int n_data) {
  Geometry g{};
  g.m = m;
  g.rows = rows;
  g.b = b;
  g.nb = nb;
  g.n_data = n_data;
  g.bk = kWRowBytes / elt_bytes;
  g.pieces = elt_bytes == 4 ? 3 : 1;
  g.x_row_bytes = g.bk * 2;
  if (nb > 0) {
    g.bt = kTileRows / nb;
    g.tile_rows = nb * g.bt;
    g.n_row_tiles = static_cast<int>(cdiv(rows, g.bt));
  } else {
    g.bt = 0;
    g.tile_rows = kTileRows;
    g.n_row_tiles = static_cast<int>(cdiv(rows, kTileRows));
  }
  g.n_col_tiles = static_cast<int>(cdiv(b, kMaxTileCols));
  g.cols = static_cast<int>(cdiv(cdiv(b, g.n_col_tiles), kColQuantum) * kColQuantum);
  g.b_pad = g.n_col_tiles * g.cols;
  g.items = g.n_row_tiles * g.n_col_tiles;
  g.k_tiles = static_cast<int>(cdiv(m, g.bk));
  g.m_pad = g.k_tiles * g.bk;
  g.w_bytes = kTileRows * kWRowBytes;
  g.stage_bytes = g.w_bytes + g.pieces * g.cols * g.x_row_bytes;
  const int r_pitch = static_cast<int>(cdiv(n_data, 8)) * 8;
  const int epi = nb > 0 ? kTileRows * kEpiPitch * 4 + 4 * nb * r_pitch : 0;
  const int fixed = kAlign + kBarrierBytes + epi;
  g.stages = (kSmemLimit - fixed) / g.stage_bytes;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.bar_off = g.stages * g.stage_bytes;
  g.epi_off = g.bar_off + kBarrierBytes;
  g.rec_off = g.epi_off + kTileRows * kEpiPitch * 4;
  g.smem_bytes = fixed + g.stages * g.stage_bytes;
  return g;
}

// ---- Hopper primitives (inline PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// arrive once and expect `bytes` more from the TMA before the phase completes
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// spin until the phase of parity `parity` has completed; a wait of over ten
// seconds is a fault of the pipeline, so the kernel traps (the launch then
// fails with an error) instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 0xffffu) == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
// TMA: a box of `map` at the coordinates (innermost first) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep a register's value where it is until here: the tensor cores read A
// fragments and write accumulators asynchronously, behind the compiler's back
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// d (+)= A B over a 64 x 32 x 16 step: A from registers (the m16n8k16 A
// layout, a warp's 16 rows), B [32 columns][16 K] from shared memory
// through `desc`; scale_d = 0 starts d afresh
template <bool F16>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
}

// The shared-memory descriptor of a K-major B operand at `addr`: rows of
// `row_bytes` (64: 64-byte swizzle; 128: 128-byte swizzle), 8-row groups
// row_bytes * 8 apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// (a, b) = hi + mid + lo, each a bf16x2 register: hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid); both differences are exact in fp32
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// byte offset of element k (of `elt` bytes) in row r of a 128-byte-swizzled
// tile of 128-byte rows (the TMA's CU_TENSOR_MAP_SWIZZLE_128B)
__host__ __device__ __forceinline__ int swz128(int r, int k, int elt) {
  const int byte = k * elt;
  return r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// byte offset of W element (row, k) in a transposed stage: box row >> 5
// holds rows 32 (row >> 5) .. + 31, a 128-byte line of 32 of them for each
// k, swizzled as the TMA lays it
__host__ __device__ __forceinline__ int swz128_t(int row, int k) {
  return (row >> 5) * kTBoxBytes + swz128(k, row & 31, 4);
}

// ---- the consumers' products
//
// The A fragments of a stage for rows row0 and row0 + 8 (a warp's m16 slab
// of the warpgroup's 64 rows), each k16 step's; fp32 is split into (hi,
// mid, lo).
template <typename T>
struct Frags;
template <>
struct Frags<float> {
  static constexpr int kSteps = 2;   // k16 steps of a stage (32 fp32)
  uint32_t a[kSteps][3][4];          // [step][piece][register]
  // TW: the transposed layout (swz128_t), read a float at a time.  A warp's
  // lanes read rows row0 .. row0 + 7 (one 32-row box, 8 apart in lane / 4)
  // at k of one parity (4 values of k & 7 in lane % 4): the swizzled 16-byte
  // chunks (row & 31) / 4 ^ (k & 7) are 8 distinct ones, so the 32 loads
  // hit 32 distinct banks.
  template <bool TW = false>
  __device__ __forceinline__ void load(const unsigned char* w, int row0, int t) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = s * 16 + h * 8 + 2 * t;
        float2 va, vb;
        if constexpr (TW) {
          auto at = [&](int row, int kk) {
            return *reinterpret_cast<const float*>(w + swz128_t(row, kk));
          };
          va = make_float2(at(row0, k), at(row0, k + 1));
          vb = make_float2(at(row0 + 8, k), at(row0 + 8, k + 1));
        } else {
          va = *reinterpret_cast<const float2*>(w + swz128(row0, k, 4));
          vb = *reinterpret_cast<const float2*>(w + swz128(row0 + 8, k, 4));
        }
        split3(va.x, va.y, a[s][0][2 * h], a[s][1][2 * h], a[s][2][2 * h]);
        split3(vb.x, vb.y, a[s][0][2 * h + 1], a[s][1][2 * h + 1], a[s][2][2 * h + 1]);
      }
    }
  }
  // d (+)= product p of step s, p = 0..5 smallest first (W piece . x piece:
  // mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi; pieces 0 hi, 1 mid, 2 lo,
  // x's pieces piece_step apart); d starts afresh when `fresh`
  static constexpr int kProducts = 6;
  __device__ __forceinline__ void product(float (&d)[16], int s, int p, uint64_t desc,
                                          uint64_t piece_step, bool fresh) {
    constexpr int kW[6] = {1, 2, 0, 1, 0, 0};
    constexpr int kX[6] = {1, 0, 2, 0, 1, 0};
    wgmma_n32<false>(d, a[s][kW[p]], desc + kX[p] * piece_step, !fresh);
  }
  __device__ __forceinline__ void keep_all() {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) keep(a[s][p][i]);
  }
};
template <>
struct Frags<__half> {
  static constexpr int kSteps = 4;   // k16 steps of a stage (64 fp16)
  uint32_t a[kSteps][4];
  template <bool TW = false>
  __device__ __forceinline__ void load(const unsigned char* w, int row0, int t) {
    static_assert(!TW, "a transposed W is fp32 only");
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = s * 16 + h * 8 + 2 * t;
        a[s][2 * h] = *reinterpret_cast<const uint32_t*>(w + swz128(row0, k, 2));
        a[s][2 * h + 1] = *reinterpret_cast<const uint32_t*>(w + swz128(row0 + 8, k, 2));
      }
    }
  }
  static constexpr int kProducts = 1;
  __device__ __forceinline__ void product(float (&d)[16], int s, int, uint64_t desc, uint64_t,
                                          bool fresh) {
    wgmma_n32<true>(d, a[s], desc, !fresh);
  }
  __device__ __forceinline__ void keep_all() {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) keep(a[s][i]);
  }
};

// acc += d, once d's group has completed.  The fences on both sides keep
// the adds away from any wgmma's issue: ptxas serializes every wgmma of a
// kernel in which a non-wgmma instruction touches a wgmma's registers
// while it may be in flight.
__device__ __forceinline__ void promote(float (&acc)[16], float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) keep(d[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += d[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) keep(acc[i]);
}

// A consumer warpgroup's thread: warp w of warpgroup g holds rows 64g + 16w
// + (lane / 4) and that + 8 of the tile, columns 2 (lane % 4) (+1) of each
// 8.  A group is a stage's products for 32 columns (its k16 steps, six
// products each) into a fresh accumulator, which the warpgroup waits for
// and adds into the tile's sums; the other warpgroup's groups keep the
// tensor cores busy meanwhile.  Measured on an H100, neither independent
// accumulators a group (interleaved), nor two stages a group, nor the next
// stage split while a group runs, nor a deeper ring was faster.
template <typename T, int NT, bool TW>
struct Consumer {
  static constexpr int KS = Frags<T>::kSteps;
  static constexpr int KP = Frags<T>::kProducts;
  unsigned char* smem;
  const Geometry& geo;
  uint64_t* full;
  uint64_t* empty;
  int lane, row0, t;
  uint64_t piece_step, col_step;   // descriptor units
  int stage = 0;
  uint32_t phase = 0;
  float acc[NT][16];
  float tmp[16];

  __device__ __forceinline__ Consumer(unsigned char* smem_, const Geometry& g, uint64_t* full_,
                                      uint64_t* empty_, int warp, int lane_)
      : smem(smem_), geo(g), full(full_), empty(empty_), lane(lane_),
        row0((warp >> 2) * 64 + (warp & 3) * 16 + (lane_ >> 2)), t(lane_ & 3),
        piece_step((g.cols * g.x_row_bytes) >> 4), col_step((kColQuantum * g.x_row_bytes) >> 4) {}

  // a tile's K loop into acc
  __device__ __forceinline__ void tile() {
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
    for (int kt = 0; kt < geo.k_tiles; ++kt) {
      bar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * geo.stage_bytes;
      const uint64_t desc = b_desc(smem_u32(st + geo.w_bytes), geo.x_row_bytes);
      Frags<T> f;
      f.template load<TW>(st, row0, t);
      f.keep_all();  // the split is done before the first fence
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int p = 0; p < KP; ++p)
            f.product(tmp, s, p, desc + c * col_step + s * 2, piece_step, s == 0 && p == 0);
        wgmma_commit();
        wgmma_wait<0>();
        promote(acc[c], tmp);
      }
      f.keep_all();
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[stage]);
      if (++stage == geo.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

// ---- the engine
//
// Task (see coded_matvec.cu, coded_decode.cu, gaussian_encode.cu) provides:
//   using Elem;                                  float or __half (W's type)
//   void prologue(smem, geo, tid, n)             block set-up by the n consumer threads
//   void tma_w(dst, map, bar, rt, kt, geo, pol)  W's tile by TMA
//   const Elem* w_row(rr, rt, geo)               W's row that tile row rr of row
//                                                tile rt is, or nullptr (no row)
//   void epilogue(acc, smem, rt, ct, geo, row0, t, ctid)   the tile's sums
// or, with kTransposedW = true (fp32), in place of w_row: a, the source S
// [K, rows], and pitch, its row length in elements (load_w_t).

template <typename T>
__device__ __forceinline__ T zero_elem() {
  if constexpr (sizeof(T) == 4) return 0.f;
  else return __ushort_as_half(0);
}

// W's tile of stage kt into `st` by the producer warp, where the TMA cannot
// take W: [128 rows][bk] elements, laid out as the TMA lays them (128-byte
// swizzle), zero past W's edges and in the rows no W row fills.  Each lane
// a column (two for fp16), kInFlight rows at a time in flight; every store
// lands inside the stage's W tile.
template <class Task>
__device__ __forceinline__ void load_w(const Task& task, unsigned char* st, int rt, int kt,
                                       const Geometry& g, int lane) {
  using T = typename Task::Elem;
  constexpr int E = sizeof(T) == 4 ? 1 : 2;
  constexpr int kInFlight = 8 / E;  // rows a lane loads at once (the producer has 56 registers)
  static_assert(kTileRows % kInFlight == 0 && 32 * E * static_cast<int>(sizeof(T)) == kWRowBytes,
                "the stores fill the W tile's rows and no more");
  const int64_t k0 = static_cast<int64_t>(kt) * g.bk + lane;
  for (int r0 = 0; r0 < kTileRows; r0 += kInFlight) {
    T v[kInFlight][E];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const T* row = task.w_row(r0 + i, rt, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int64_t k = k0 + 32 * e;
        v[i][e] = row != nullptr && k < g.m ? row[k] : zero_elem<T>();
      }
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e)
        *reinterpret_cast<T*>(st + swz128(r0 + i, lane + 32 * e, sizeof(T))) = v[i][e];
  }
}
// The same for a transposed W (Task::kTransposedW): S [K, rows] row-major
// (task.a, row pitch task.pitch); stage kt is S's rows kt * bk .. + bk - 1
// over the tile's 128 columns, each lane a column of each 32-column box,
// kInFlight loads in flight, zero past S's edges.
template <class Task>
__device__ __forceinline__ void load_w_t(const Task& task, unsigned char* st, int rt, int kt,
                                         const Geometry& g, int lane) {
  constexpr int kInFlight = 8;
  constexpr int kLoads = kTBoxRows * (kTileRows / kTBoxRows);  // (k, box) pairs of a stage
  static_assert(kLoads % kInFlight == 0, "the loads fill the stage");
  const int64_t col0 = static_cast<int64_t>(rt) * kTileRows + lane;
  const int64_t k0 = static_cast<int64_t>(kt) * g.bk;
  for (int i0 = 0; i0 < kLoads; i0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int k = (i0 + i) >> 2, box = (i0 + i) & 3;
      const int64_t col = col0 + kTBoxRows * box;
      v[i] = k0 + k < g.m && col < g.rows ? task.a[(k0 + k) * task.pitch + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int k = (i0 + i) >> 2, box = (i0 + i) & 3;
      *reinterpret_cast<float*>(st + swz128_t(kTBoxRows * box + lane, k)) = v[i];
    }
  }
}

// The (row tile, column tile) of an item: row-tile-minor, or for a
// transposed W column-tile-minor (the column tiles of a W tile together)
template <class Task>
__device__ __forceinline__ void item_tiles(int item, const Geometry& g, int& rt, int& ct) {
  if constexpr (transposed_w<Task>::value) {
    rt = item / g.n_col_tiles;
    ct = item % g.n_col_tiles;
  } else {
    rt = item % g.n_row_tiles;
    ct = item / g.n_row_tiles;
  }
}

template <class Task, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    wide_rows_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap x_map, const Task task,
                     const Geometry geo) {
  using T = typename Task::Elem;
  extern __shared__ unsigned char wide_smem_raw[];
  const uint32_t raw = smem_u32(wide_smem_raw);
  unsigned char* smem = wide_smem_raw + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.bar_off);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    bar_fence_init();
  }
  if (warp < kConsumerWarps) {
    // a decode tile's rows past nb * bt are in no load: zero once
    if (geo.tma_w && geo.tile_rows < kTileRows) {
      const int n = (kTileRows - geo.tile_rows) * kWRowBytes / 16;
      for (int s = 0; s < geo.stages; ++s)
        for (int i = tid; i < n; i += 32 * kConsumerWarps)
          reinterpret_cast<uint4*>(smem + s * geo.stage_bytes + geo.tile_rows * kWRowBytes)[i] =
              make_uint4(0, 0, 0, 0);
    }
    task.prologue(smem, geo, tid, 32 * kConsumerWarps);
  }
  __syncthreads();

  const int x_tx = geo.pieces * geo.cols * geo.x_row_bytes;
  if (warp >= kConsumerWarps) {
    // ---- the producer: its warpgroup gives up registers, one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    const uint64_t policy = evict_first_policy();
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
      int rt, ct;
      item_tiles<Task>(item, geo, rt, ct);
      for (int kt = 0; kt < geo.k_tiles; ++kt) {
        bar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * geo.stage_bytes;
        if (!geo.tma_w) {
          if constexpr (transposed_w<Task>::value) load_w_t(task, st, rt, kt, geo, lane);
          else load_w(task, st, rt, kt, geo, lane);
          __syncwarp();
        }
        if (lane == 0) {
          bar_expect_tx(&full[stage], (geo.tma_w ? geo.tile_rows * kWRowBytes : 0) + x_tx);
          if (geo.tma_w) task.tma_w(smem_u32(st), &w_map, &full[stage], rt, kt, geo, policy);
          tma_3d(smem_u32(st + geo.w_bytes), &x_map, &full[stage], kt * geo.bk, ct * geo.cols,
                 0);
        }
        if (++stage == geo.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  Consumer<T, NT, transposed_w<Task>::value> con(smem, geo, full, empty, warp, lane);
  for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
    int rt, ct;
    item_tiles<Task>(item, geo, rt, ct);
    con.tile();
    task.epilogue(con.acc, smem, rt, ct, geo, con.row0, con.t, tid);
  }
}

// x [m, b] (row-major, T) -> xp [pieces][b_pad][m_pad]: transposed, zero-
// padded, and for fp32 split into (hi, mid, lo) bf16; fp16 is copied.  A
// 32 x 32 tile a block through shared memory, so both sides are coalesced.
template <typename T, typename P, int PIECES>
__global__ void __launch_bounds__(256) wide_split_x(const T* __restrict__ x, P* __restrict__ xp,
                                                    int m, int b, int m_pad, int b_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, q0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, q = q0 + tx;
    float v = 0.f;
    if (k < m && q < b) {
      if constexpr (sizeof(T) == 4) v = x[static_cast<int64_t>(k) * b + q];
      else v = __half2float(x[static_cast<int64_t>(k) * b + q]);
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(b_pad) * m_pad;
  for (int i = ty; i < 32; i += 8) {
    const int q = q0 + i, k = k0 + tx;
    const float v = tile[tx][i];
    const int64_t at = static_cast<int64_t>(q) * m_pad + k;
    if constexpr (PIECES == 3) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      const float r = v - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r);
      xp[at] = hi;
      xp[plane + at] = mid;
      xp[2 * plane + at] = __float2bfloat16_rn(r - __bfloat162float(mid));
    } else {
      xp[at] = __float2half_rn(v);
    }
  }
}

// ---- host side: tensor maps and the launch
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda); nullptr if the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A tiled map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..rank-1); false if the driver refuses it
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of x's pieces xp [pieces][b_pad][m_pad] (bf16, or fp16): a box is
// a stage's [pieces][cols][bk]
inline bool encode_x(CUtensorMap* map, const void* xp, const Geometry& g) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g.m_pad), static_cast<cuuint64_t>(g.b_pad),
                              static_cast<cuuint64_t>(g.pieces)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(g.m_pad) * 2,
                                 static_cast<cuuint64_t>(g.m_pad) * g.b_pad * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(g.bk), static_cast<cuuint32_t>(g.cols),
                             static_cast<cuuint32_t>(g.pieces)};
  const CUtensorMapDataType type =
      g.pieces == 3 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 3, xp, dims, strides, box,
                g.x_row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// Split x into xp on `stream`; cudaGetLastError() after the launch.
template <typename T>
int split_x(const T* x, void* xp, const Geometry& g, cudaStream_t stream) {
  const dim3 grid(g.m_pad / 32, g.b_pad / 32), block(32, 8);
  if constexpr (sizeof(T) == 4)
    wide_split_x<float, __nv_bfloat16, 3>
        <<<grid, block, 0, stream>>>(x, static_cast<__nv_bfloat16*>(xp), static_cast<int>(g.m),
                                     g.b, g.m_pad, g.b_pad);
  else
    wide_split_x<__half, __half, 1><<<grid, block, 0, stream>>>(
        x, static_cast<__half*>(xp), static_cast<int>(g.m), g.b, g.m_pad, g.b_pad);
  return static_cast<int>(cudaGetLastError());
}

template <class Task>
using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const Task, const Geometry);

template <class Task>
KernelFn<Task> pick(int cols) {
  switch (cols / kColQuantum) {
    case 1: return &wide_rows_kernel<Task, 1>;
    case 2: return &wide_rows_kernel<Task, 2>;
    case 3: return &wide_rows_kernel<Task, 3>;
    case 4: return &wide_rows_kernel<Task, 4>;
    case 5: return &wide_rows_kernel<Task, 5>;
    case 6: return &wide_rows_kernel<Task, 6>;
    case 7: return &wide_rows_kernel<Task, 7>;
    default: return &wide_rows_kernel<Task, 8>;
  }
}

// Launch the main kernel on `grid` blocks; cudaGetLastError() after it.
template <class Task>
int launch(int grid, cudaStream_t stream, const CUtensorMap& w_map, const CUtensorMap& x_map,
           const Task& task, const Geometry& geo) {
  const KernelFn<Task> kernel = pick<Task>(geo.cols);
  // raised once a kernel and device, to the most a block may have, never to
  // one launch's size (a later launch with more bytes would be refused)
  static std::atomic<uint64_t> raised[kMaxTileCols / kColQuantum + 1];  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<uint64_t>& bits = raised[geo.cols / kColQuantum];
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit == 0 || (bits.load() & bit) == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    bits.fetch_or(bit);
  }
  void* args[] = {const_cast<CUtensorMap*>(&w_map), const_cast<CUtensorMap*>(&x_map),
                  const_cast<Task*>(&task), const_cast<Geometry*>(&geo)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args,
                         static_cast<size_t>(geo.smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the geometry the wrapper sent is this one's
inline bool same_plan(const Geometry& g, int grid, int cols, int stages, int smem_bytes) {
  return grid >= 1 && grid <= g.items && cols == g.cols && stages == g.stages && stages >= 2 &&
         smem_bytes == g.smem_bytes;
}

}  // namespace wide_rows
