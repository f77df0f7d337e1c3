// Mamba-2 SSD intra-chunk kernels.
//
// Replaces the Pallas TPU kernels repro/kernels/ssd_scan.py ::
// ssd_chunk_pallas and ssd_combine_pallas.  A cell g is one (batch, head,
// chunk) slice of Q <= 256 positions; x [G, Q, P] (pre-multiplied by dt),
// da [G, Q] fp32, b and c [G, Q, N] (head-expanded); x, b and c are fp32 or
// bf16; every output is fp32 and every sum is taken in fp32.
//
//   ssd_chunk:   cum = cumsum(da); L_ls = exp(cum_l - cum_s) for l >= s, else 0
//                y_diag = (C Bᵀ ∘ L) X            [G, Q, P]
//                states = Xᵀ (exp(cum_Q - cum) ∘ B) [G, P, N]
//                decay  = exp(cum_Q) [G], cum [G, Q]
//   ssd_combine: y_off = exp(cum) ∘ (C S_inᵀ)     [G, Q, P], S_in [G, P, N] fp32
//
// Two routes, chosen by the dtype of x, b and c:
//
// * bf16 (the served path): tensor cores, mma.sync m16n8k16 with bf16
//   operands and fp32 accumulators, N <= 128.  In each product one operand
//   is a bf16 input (C·Bᵀ: both; (C·Bᵀ ∘ L)·X and Xᵀ·(decay ∘ B): X;
//   C·S_inᵀ: C) and the other is fp32.  The fp32 operand v is split into
//   three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
//   mid): their sum is v exactly for every normal v away from the underflow
//   edge, and a piece times a bf16 value is exact in fp32, so three MMA
//   passes into one fp32 accumulator give the fp32 product up to the order
//   of the sums.  With the passes counted a 4096-token prompt's cells need
//   14.0 GFLOP (mamba2-130m) and 23.7 GFLOP (zamba2-1.2b), 0.014 / 0.024 ms
//   at 989 TFLOP/s against 0.035 / 0.056 ms for their bytes at 3.35 TB/s:
//   the bound is bytes.  ssd_chunk runs at about 2.6x it (PERF.md): a
//   block's phases (staging, the y row groups, the state) follow each other
//   and two blocks an SM overlap them only in part.
//   ssd_chunk: one block a cell.  B and X are staged whole (Q x N and Q x
//   P bf16, rows padded by 16 bytes so ldmatrix is conflict-free) by 16-byte
//   cp.async copies in 64-row stages, each completing its own mbarrier; a
//   warp waits only for the stage it is about to read, so later stages load
//   while earlier ones multiply.  The cumsum is computed once, while the
//   copies fly.  A warp takes a pair of 16-row groups, r and R-1-r (the
//   causal rows balanced), then a 16 x (P or P/2) tile of statesᵀ.  For a
//   row group it keeps C's rows in registers as A fragments, walks the
//   16-row s-blocks up to its diagonal, forms C·Bᵀ in registers, selects
//   l >= s before the exp (above the diagonal the exp may overflow, and
//   inf·0 is NaN), scales by L, splits the result in three in registers
//   (the m16n8 accumulator layout is the m16k16 A layout) and runs three
//   passes against X (ldmatrix.trans).  statesᵀ = (decay ∘ B)ᵀ·X takes B
//   through ldmatrix.trans, scales and splits it in registers, three passes.
//   ssd_combine: one block a cell; all of C in flight at once by cp.async
//   (64-row stages, an mbarrier each) while S_in is staged once, already
//   split into three bf16 planes; a warp takes 16-row groups of l and runs
//   three passes over N, the exp(cum) row scale in the epilogue.
//   The launch geometry is tc_plan, mirrored by kernels/ssd_scan.py::ssd_plan;
//   the settings (warps, blocks an SM, the exp of L) were chosen by
//   `chip_smoke.py --sweep-ssd`.
// * fp32 (the CPU-shaped tests, the float32 prefill check): SIMT fp32, as
//   bf16 pieces cannot hold an fp32 x fp32 product in three passes.  Bound
//   by fp32 operations (67 TFLOP/s).  One grid row of blocks per cell:
//   64-row tiles of y_diag over the causal 64-wide s-tiles (C·Bᵀ over N in
//   stages of 32 through shared memory, the select and L, then the staged X
//   tile) and 64-column tiles of states over n; every block scans da of its
//   cell.  256 threads, each a 4 x 4 register tile of a 64 x 64 output.
//   Its bf16 instance is reached only from the ssd_*_simt entries, which
//   time it beside the tensor-core route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // output tile edge (rows l or p, columns p or n)
constexpr int kK = 32;           // reduction depth of one shared-memory stage
constexpr int kLd = kT + 4;      // padded stage row (keeps float4 alignment)
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kStage = kK * kLd;  // floats in one [kK][kLd] stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][tx*4 + j]
template <int DEPTH>
__device__ __forceinline__ void mma_stage(const float* __restrict__ a,
                                          const float* __restrict__ b, float acc[4][4],
                                          int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < DEPTH; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// stage[k][r] = src[(row0 + r) * ld + col0 + k] for r < 64, k < 32 — a
// transposing load, coalesced along the source row; zero outside
// rows < n_rows, cols < n_cols.
template <typename T>
__device__ __forceinline__ void stage_rows_t(float* __restrict__ stage,
                                             const T* __restrict__ src, int64_t ld,
                                             int row0, int n_rows, int col0, int n_cols) {
  for (int idx = threadIdx.x; idx < kT * kK; idx += kThreads) {
    const int r = idx / kK, k = idx % kK;
    const int row = row0 + r, col = col0 + k;
    stage[k * kLd + r] = (row < n_rows && col < n_cols) ? to_f(src[row * ld + col]) : 0.f;
  }
}

// cum_s[i] = da[0] + ... + da[i] for i < q (entries up to kMaxQ are filled).
// The first warp scans: each lane sums its 8 positions in order, every lane
// adds the 32 lane totals in lane order (the same adds in each lane), and
// lane k adds the sum of the totals before it.  So a lane's base is the
// previous lane's last value, bit for bit, and zeros at the end of a padded
// chunk leave cum unchanged: exp(cum_Q - cum_s) is exactly 1 at the last
// real position, as in a sequential scan.
__device__ __forceinline__ void cell_cumsum(float* __restrict__ cum_s,
                                            const float* __restrict__ da, int q) {
  for (int i = threadIdx.x; i < kMaxQ; i += blockDim.x) cum_s[i] = i < q ? da[i] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    constexpr int kPer = kMaxQ / 32;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      run += cum_s[lane * kPer + j];
      v[j] = run;
    }
    float base = 0.f, acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float t = __shfl_sync(0xffffffffu, run, k);
      if (lane == k) base = acc;
      acc += t;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) cum_s[lane * kPer + j] = base + v[j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ da,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ decay, float* __restrict__ cum_out,
                 int q, int p, int n) {
  __shared__ __align__(16) float cum_s[kMaxQ];
  __shared__ __align__(16) float dec_s[kMaxQ];
  __shared__ __align__(16) float buf[2 * kStage];  // two stages, or the X tile
  __shared__ __align__(16) float st[kT * kLd];     // masked C·Bᵀ ∘ L, transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t g = blockIdx.x;
  const T* xg = x + g * q * p;
  const T* bg = bm + g * q * n;
  const T* cg = cm + g * q * n;
  const int n_lt = (q + kT - 1) / kT;

  cell_cumsum(cum_s, da + g * q, q);
  float acc[4][4];
  zero(acc);

  if (static_cast<int>(blockIdx.y) < n_lt) {
    // ---- a 64-row tile of y_diag; heaviest (last) tiles first
    const int l0 = (n_lt - 1 - static_cast<int>(blockIdx.y)) * kT;
    for (int i = tid; i < kT && l0 + i < q; i += kThreads) cum_out[g * q + l0 + i] = cum_s[l0 + i];
    float* sa = buf;           // C stage [k][l]
    float* sb = buf + kStage;  // B stage [k][s]
    float* xs = buf;           // X tile [s][p] (after the C·Bᵀ stages)
    for (int s0 = 0; s0 <= l0; s0 += kT) {
      float cb[4][4];
      zero(cb);
      for (int n0 = 0; n0 < n; n0 += kK) {
        stage_rows_t(sa, cg, n, l0, q, n0, n);
        stage_rows_t(sb, bg, n, s0, q, n0, n);
        __syncthreads();
        mma_stage<kK>(sa, sb, cb, ty, tx);
        __syncthreads();
      }
      // select, then scale by L; store transposed: st[s][l]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty * 4 + i;
          v[i] = (l >= s && l < q) ? cb[i][j] * expf(cum_s[l] - cum_s[s]) : 0.f;
        }
        *reinterpret_cast<float4*>(st + (tx * 4 + j) * kLd + ty * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int r = idx / kT, col = idx % kT;
        const int s = s0 + r;
        xs[r * kLd + col] = (s < q && col < p) ? to_f(xg[s * p + col]) : 0.f;
      }
      __syncthreads();
      mma_stage<kT>(st, xs, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty * 4 + i;
      if (l >= q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        if (col < p) y[(g * q + l) * p + col] = acc[i][j];
      }
    }
  } else {
    // ---- a 64-column tile of the chunk state over n, reduced over all Q
    const int nt = static_cast<int>(blockIdx.y) - n_lt;
    const int n0 = nt * kT;
    const float last = cum_s[q - 1];
    for (int i = tid; i < q; i += kThreads) dec_s[i] = expf(last - cum_s[i]);
    if (nt == 0 && tid == 0) decay[g] = expf(last);
    __syncthreads();
    float* sa = buf;           // X stage [s][p]
    float* sb = buf + kStage;  // decayed B stage [s][n]
    for (int s0 = 0; s0 < q; s0 += kK) {
      for (int idx = tid; idx < kK * kT; idx += kThreads) {
        const int r = idx / kT, col = idx % kT;
        const int s = s0 + r;
        const bool in = s < q;
        sa[r * kLd + col] = (in && col < p) ? to_f(xg[s * p + col]) : 0.f;
        sb[r * kLd + col] = (in && n0 + col < n) ? dec_s[s] * to_f(bg[s * n + n0 + col]) : 0.f;
      }
      __syncthreads();
      mma_stage<kK>(sa, sb, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= p) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < n) states[(g * p + row) * n + col] = acc[i][j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_combine_kernel(const T* __restrict__ cm, const float* __restrict__ cum,
                   const float* __restrict__ s_in, float* __restrict__ y,
                   int q, int p, int n) {
  __shared__ __align__(16) float sa[kStage];  // C stage [k][l]
  __shared__ __align__(16) float sb[kStage];  // S_in stage [k][p]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t g = blockIdx.x;
  const int l0 = blockIdx.y * kT;
  const T* cg = cm + g * q * n;
  const float* sg = s_in + g * p * n;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < n; n0 += kK) {
    stage_rows_t(sa, cg, n, l0, q, n0, n);
    stage_rows_t(sb, sg, n, 0, p, n0, n);
    __syncthreads();
    mma_stage<kK>(sa, sb, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= q) continue;
    const float scale = expf(cum[g * q + l]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      if (col < p) y[(g * q + l) * p + col] = scale * acc[i][j];
    }
  }
}

// ====================== tensor-core route (bf16 x, B, C) ======================

constexpr int kChunkWarps = 8;       // ssd_chunk: warps a block; one block a cell
constexpr int kChunkMinBlocks = 2;   // blocks an SM its launch bounds ask for (caps registers)
constexpr int kCombineWarps = 8;     // ssd_combine: the same
constexpr int kCombineMinBlocks = 3;
constexpr int kFastExp = 0;          // L's exp by ex2.approx (__expf) instead of expf
constexpr int kChunkThreads = kChunkWarps * 32;
constexpr int kCombineThreads = kCombineWarps * 32;
constexpr int kRowGroup = 16;      // rows of an MMA row group (l), or of a k-step over s
constexpr int kSTile = 64;         // rows s of one staging stage (one mbarrier)
constexpr int kMaxStages = kMaxQ / kSTile;
constexpr int kMaxNTc = 128;       // widest state of this route (C's rows live in registers)
constexpr int kPieces = 3;         // bf16 pieces of an fp32 operand
constexpr int kHeadBytes = 2304;   // cum_s, dec_s and the stage mbarriers; B's tile starts here
constexpr int kCombineHeadBytes = 128;  // ssd_combine's stage mbarriers; C's tile starts here
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxDevices = 64;
static_assert(2 * kMaxQ * 4 + kMaxStages * 8 <= kHeadBytes, "cum_s, dec_s and the mbarriers");
static_assert(kMaxStages * 8 <= kCombineHeadBytes, "ssd_combine's mbarriers");

// Geometry of one cell on this route (kernels/ssd_scan.py::ssd_plan mirrors it).
struct TcPlan {
  int nk;            // k16 steps over N: N zero-padded to 16 nk (64 or 128)
  int pt;            // n8 tiles over P: P zero-padded to 8 pt (pt even)
  int rows;          // row groups R = ceil(q / 16)
  int y_units;       // ceil(R / 2) pairs (r, R-1-r); the middle group alone when R is odd
  int split;         // statesᵀ units a 16-row tile of n: 2 when nk = 4 and pt / 2 is even
  int state_units;   // nk * split, each 16 rows of n by 8 pt / split columns of p
  int stages;        // 64-row stages of B and X
  int ld_b, ld_x;    // staged row pitches in bf16: 16 nk + 8, 8 pt + 8
  int smem_chunk;    // ssd_chunk's dynamic shared bytes
  int smem_combine;  // ssd_combine's: C staged whole, then S_in in three bf16 planes
};

__host__ __device__ inline TcPlan tc_plan(int q, int p, int n) {
  TcPlan pl;
  pl.nk = n <= 64 ? 4 : 8;
  pl.pt = (p + 15) / 16 * 2;
  pl.rows = (q + kRowGroup - 1) / kRowGroup;
  pl.y_units = (pl.rows + 1) / 2;
  pl.split = (pl.nk == 4 && pl.pt / 2 % 2 == 0) ? 2 : 1;
  pl.state_units = pl.nk * pl.split;
  pl.stages = (pl.rows * kRowGroup + kSTile - 1) / kSTile;
  pl.ld_b = 16 * pl.nk + 8;
  pl.ld_x = 8 * pl.pt + 8;
  pl.smem_chunk = kHeadBytes + 2 * pl.rows * kRowGroup * (pl.ld_b + pl.ld_x);
  pl.smem_combine = kCombineHeadBytes + 2 * (pl.rows * kRowGroup + kPieces * 8 * pl.pt) * pl.ld_b;
  return pl;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b over one m16n8k16 tile: a row-major bf16 (4 registers), b
// column-major bf16 (2), d fp32 (4)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// arrive once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// this thread's share of a stage is issued: arrive once it has landed
// (cp.async copies), or now (plain stores, released by the arrive)
__device__ __forceinline__ void arrive_staged(uint32_t bar, bool by_cp_async) {
  if (by_cp_async)
    mbar_arrive_cp_async(bar);
  else
    mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// L's exp: accurate, or ex2.approx (kFastExp; ~2 ulp plus 1.2 ulp per unit of |x|)
__device__ __forceinline__ float l_exp(float v) { return kFastExp ? __expf(v) : expf(v); }

// (a, b) = hi + mid + lo, each a bf16x2 register: hi = bf16(v), mid = bf16(v
// - hi), lo = bf16(v - hi - mid); both differences are exact in fp32
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

// the bf16 pair (row l, columns k, k + 1) of a [q, n] cell as one register,
// zero outside it; vec: n even and the cell 4-byte aligned
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* __restrict__ cell, int l,
                                              int k, int q, int n, bool vec) {
  if (l >= q) return 0u;
  const unsigned short* row = reinterpret_cast<const unsigned short*>(cell) +
                              static_cast<int64_t>(l) * n;
  if (vec) return k < n ? __ldg(reinterpret_cast<const unsigned int*>(row + k)) : 0u;
  const uint32_t lo = k < n ? __ldg(row + k) : 0u;
  const uint32_t hi = k + 1 < n ? __ldg(row + k + 1) : 0u;
  return lo | (hi << 16);
}

// the A fragments of rows [l0, l0 + 16) of C over the padded N
template <int NK>
__device__ __forceinline__ void load_c_rows(uint32_t cf[NK][4],
                                            const __nv_bfloat16* __restrict__ cg, int l0, int q,
                                            int n, bool vec, int lane) {
  const int la = l0 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    cf[kk][0] = load_pair(cg, la, 16 * kk + col, q, n, vec);
    cf[kk][1] = load_pair(cg, la + 8, 16 * kk + col, q, n, vec);
    cf[kk][2] = load_pair(cg, la, 16 * kk + col + 8, q, n, vec);
    cf[kk][3] = load_pair(cg, la + 8, 16 * kk + col + 8, q, n, vec);
  }
}

// rows [s0, s1) of a [q, w] bf16 cell into a shared tile of pitch ld, zero
// past q rows and w columns up to wp; vec (w % 8 == 0, 16-byte aligned):
// 16-byte cp.async copies, zero-filled by the copy itself
__device__ __forceinline__ void stage_rows(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ src, int s0, int s1,
                                           int q, int w, int wp, int ld, bool vec) {
  if (vec) {
    const int chunks = wp / 8;
    for (int i = threadIdx.x; i < (s1 - s0) * chunks; i += blockDim.x) {
      const int s = s0 + i / chunks, k = i % chunks * 8;
      const bool in = s < q && k < w;
      cp_async16(smem_addr(dst + s * ld + k), in ? src + static_cast<int64_t>(s) * w + k : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (s1 - s0) * wp; i += blockDim.x) {
      const int s = s0 + i / wp, k = i % wp;
      dst[s * ld + k] = (s < q && k < w) ? src[static_cast<int64_t>(s) * w + k]
                                         : __ushort_as_bfloat16(0);
    }
  }
}

// y_diag rows [16 r, 16 r + 16) of a cell: C·Bᵀ per 16-row s-block up to the
// diagonal, selected, scaled by L and split in registers, three passes against X
template <int NK, int PT>
__device__ __forceinline__ void chunk_rows(int r, const TcPlan& pl,
                                           const __nv_bfloat16* __restrict__ cg,
                                           float* __restrict__ yg, const __nv_bfloat16* bs,
                                           const __nv_bfloat16* xs, const float* cum_s,
                                           const uint64_t* bars, int q, int p, int n,
                                           bool vec_c, bool vec_y, int lane) {
  const int tq = lane & 3;
  const int la = r * kRowGroup + (lane >> 2), lb = la + 8;
  uint32_t cf[NK][4];
  load_c_rows<NK>(cf, cg, r * kRowGroup, q, n, vec_c, lane);
  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float cum_a = cum_s[la], cum_b = cum_s[lb];
  // ldmatrix row addresses: B [s][n] as the col-major operand, X [s][p] transposed
  const uint32_t b_base =
      smem_addr(bs + ((lane & 7) + (lane >> 4) * 8) * pl.ld_b + ((lane >> 3) & 1) * 8);
  const uint32_t x_base =
      smem_addr(xs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pl.ld_x + (lane >> 4) * 8);
  for (int sb = 0; sb <= r; ++sb) {
    if ((sb & 3) == 0) mbar_wait(smem_addr(bars + (sb >> 2)), 0);
    const int s0 = sb * kRowGroup;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t bf[4];
      ldsm_x4(b_base + 2 * (s0 * pl.ld_b + 16 * kk), bf);
      mma_bf16(sc[0], cf[kk], bf[0], bf[1]);
      mma_bf16(sc[1], cf[kk], bf[2], bf[3]);
    }
    uint32_t pc[kPieces][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = s0 + 8 * j + 2 * tq;
      const float c0 = cum_s[s], c1 = cum_s[s + 1];
      const float v0 = la >= s ? sc[j][0] * l_exp(cum_a - c0) : 0.f;
      const float v1 = la >= s + 1 ? sc[j][1] * l_exp(cum_a - c1) : 0.f;
      const float v2 = lb >= s ? sc[j][2] * l_exp(cum_b - c0) : 0.f;
      const float v3 = lb >= s + 1 ? sc[j][3] * l_exp(cum_b - c1) : 0.f;
      split3(v0, v1, pc[0][2 * j], pc[1][2 * j], pc[2][2 * j]);
      split3(v2, v3, pc[0][2 * j + 1], pc[1][2 * j + 1], pc[2][2 * j + 1]);
    }
#pragma unroll
    for (int pp = 0; pp < PT / 2; ++pp) {
      uint32_t xf[4];
      ldsm_x4_t(x_base + 2 * (s0 * pl.ld_x + 16 * pp), xf);
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        mma_bf16(acc[2 * pp], pc[k], xf[0], xf[1]);
        mma_bf16(acc[2 * pp + 1], pc[k], xf[2], xf[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int col = 8 * j + 2 * tq;
    if (vec_y) {  // p even: (col, col + 1) both in or both out
      if (la < q && col < p)
        *reinterpret_cast<float2*>(yg + la * p + col) = make_float2(acc[j][0], acc[j][1]);
      if (lb < q && col < p)
        *reinterpret_cast<float2*>(yg + lb * p + col) = make_float2(acc[j][2], acc[j][3]);
    } else {
      if (la < q) {
        if (col < p) yg[la * p + col] = acc[j][0];
        if (col + 1 < p) yg[la * p + col + 1] = acc[j][1];
      }
      if (lb < q) {
        if (col < p) yg[lb * p + col] = acc[j][2];
        if (col + 1 < p) yg[lb * p + col + 1] = acc[j][3];
      }
    }
  }
}

// statesᵀ rows [16 mt, 16 mt + 16) (n) by columns [8 nt0, 8 nt0 + 8 SN) (p):
// (decay ∘ B)ᵀ through ldmatrix.trans, scaled and split in registers, three
// passes against X, over every s
template <int SN>
__device__ __forceinline__ void chunk_states(int mt, int nt0, const TcPlan& pl,
                                             float* __restrict__ sg, const __nv_bfloat16* bs,
                                             const __nv_bfloat16* xs, const float* dec_s,
                                             const uint64_t* bars, int p, int n, int lane) {
  const int tq = lane & 3;
  float acc[SN][4];
#pragma unroll
  for (int j = 0; j < SN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t a_base = smem_addr(bs + ((lane & 7) + (lane >> 4) * 8) * pl.ld_b + 16 * mt +
                                    ((lane >> 3) & 1) * 8);
  const uint32_t x_base = smem_addr(xs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pl.ld_x +
                                    8 * nt0 + (lane >> 4) * 8);
  for (int kb = 0; kb < pl.rows; ++kb) {
    if ((kb & 3) == 0) mbar_wait(smem_addr(bars + (kb >> 2)), 0);
    const int s0 = kb * kRowGroup;
    uint32_t af[4];
    ldsm_x4_t(a_base + 2 * s0 * pl.ld_b, af);
    // a0, a1 hold s = s0 + 2 tq (+1); a2, a3 hold s = s0 + 8 + 2 tq (+1)
    const float d0 = dec_s[s0 + 2 * tq], d1 = dec_s[s0 + 2 * tq + 1];
    const float d2 = dec_s[s0 + 8 + 2 * tq], d3 = dec_s[s0 + 9 + 2 * tq];
    uint32_t pc[kPieces][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&af[i]));
      split3(v.x * (i < 2 ? d0 : d2), v.y * (i < 2 ? d1 : d3), pc[0][i], pc[1][i], pc[2][i]);
    }
#pragma unroll
    for (int pp = 0; pp < SN / 2; ++pp) {
      uint32_t xf[4];
      ldsm_x4_t(x_base + 2 * (s0 * pl.ld_x + 16 * pp), xf);
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        mma_bf16(acc[2 * pp], pc[k], xf[0], xf[1]);
        mma_bf16(acc[2 * pp + 1], pc[k], xf[2], xf[3]);
      }
    }
  }
  const int na = 16 * mt + (lane >> 2), nb = na + 8;
#pragma unroll
  for (int j = 0; j < SN; ++j) {
    const int col = 8 * (nt0 + j) + 2 * tq;
    if (col < p) {
      if (na < n) sg[col * n + na] = acc[j][0];
      if (nb < n) sg[col * n + nb] = acc[j][2];
    }
    if (col + 1 < p) {
      if (na < n) sg[(col + 1) * n + na] = acc[j][1];
      if (nb < n) sg[(col + 1) * n + nb] = acc[j][3];
    }
  }
}

template <int NK, int PT>
__global__ void __launch_bounds__(kChunkThreads, kChunkMinBlocks)
ssd_chunk_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ da,
             const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
             float* __restrict__ y, float* __restrict__ states, float* __restrict__ decay,
             float* __restrict__ cum_out, int q, int p, int n, int vec_stage, int vec_c,
             int vec_y) {
  constexpr int kSplit = (NK == 4 && PT / 2 % 2 == 0) ? 2 : 1;
  constexpr int kSN = PT / kSplit;
  extern __shared__ __align__(128) unsigned char smem[];
  float* cum_s = reinterpret_cast<float*>(smem);
  float* dec_s = cum_s + kMaxQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dec_s + kMaxQ);
  const TcPlan pl = tc_plan(q, p, n);
  const int qp = pl.rows * kRowGroup;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + kHeadBytes);
  __nv_bfloat16* xs = bs + qp * pl.ld_b;
  const int64_t g = blockIdx.x;
  const __nv_bfloat16* xg = x + g * q * p;
  const __nv_bfloat16* bg = bm + g * q * n;
  const __nv_bfloat16* cg = cm + g * q * n;

  if (threadIdx.x == 0)
    for (int t = 0; t < pl.stages; ++t) mbar_init(smem_addr(bars + t), kChunkThreads);
  __syncthreads();
  // every stage of B and X in flight at once, each completing its own mbarrier
  for (int t = 0; t < pl.stages; ++t) {
    const int s0 = t * kSTile, s1 = min(s0 + kSTile, qp);
    stage_rows(bs, bg, s0, s1, q, n, 16 * NK, pl.ld_b, vec_stage);
    stage_rows(xs, xg, s0, s1, q, p, 8 * PT, pl.ld_x, vec_stage);
    arrive_staged(smem_addr(bars + t), vec_stage);
  }
  // the cumsum, once a cell, while the copies fly (the SIMT route's scan: the same bits)
  cell_cumsum(cum_s, da + g * q, q);
  const float last = cum_s[q - 1];
  for (int i = threadIdx.x; i < kMaxQ; i += kChunkThreads) {
    dec_s[i] = i < q ? expf(last - cum_s[i]) : 0.f;
    if (i < q) cum_out[g * q + i] = cum_s[i];
  }
  if (threadIdx.x == 0) decay[g] = expf(last);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = warp; it < pl.y_units + pl.state_units; it += kChunkWarps) {
    if (it < pl.y_units) {  // the short row group first: its stages land first
      chunk_rows<NK, PT>(it, pl, cg, y + g * q * p, bs, xs, cum_s, bars, q, p, n, vec_c, vec_y,
                         lane);
      if (pl.rows - 1 - it != it)
        chunk_rows<NK, PT>(pl.rows - 1 - it, pl, cg, y + g * q * p, bs, xs, cum_s, bars, q, p, n,
                           vec_c, vec_y, lane);
    } else {
      const int u = it - pl.y_units;
      chunk_states<kSN>(u / kSplit, u % kSplit * kSN, pl, states + g * p * n, bs, xs, dec_s,
                        bars, p, n, lane);
    }
  }
}

template <int NK, int PT>
__global__ void __launch_bounds__(kCombineThreads, kCombineMinBlocks)
ssd_combine_tc(const __nv_bfloat16* __restrict__ cm, const float* __restrict__ cum,
               const float* __restrict__ s_in, float* __restrict__ y, int q, int p, int n,
               int vec_c, int vec_s, int vec_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcPlan pl = tc_plan(q, p, n);
  const int qp = pl.rows * kRowGroup;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + kCombineHeadBytes);
  __nv_bfloat16* planes = cs + qp * pl.ld_b;
  const int plane = 8 * PT * pl.ld_b;  // bf16 a plane
  const int64_t g = blockIdx.x;
  const __nv_bfloat16* cg = cm + g * q * n;
  const float* sg = s_in + g * p * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;

  if (threadIdx.x == 0)
    for (int t = 0; t < pl.stages; ++t) mbar_init(smem_addr(bars + t), kCombineThreads);
  __syncthreads();
  // all of C in flight at once, a 64-row stage an mbarrier
  for (int t = 0; t < pl.stages; ++t) {
    stage_rows(cs, cg, t * kSTile, min(t * kSTile + kSTile, qp), q, n, 16 * NK, pl.ld_b, vec_c);
    arrive_staged(smem_addr(bars + t), vec_c);
  }
  // meanwhile S_in [p][n] fp32 -> hi, mid and lo bf16 planes [8 pt][16 nk], zero-padded
  constexpr int kQuads = 4 * NK;
  for (int i = threadIdx.x; i < 8 * PT * kQuads; i += kCombineThreads) {
    const int row = i / kQuads, k = i % kQuads * 4;
    float v[4];
    if (vec_s && row < p && k < n) {
      const float4 t = *reinterpret_cast<const float4*>(sg + row * n + k);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (row < p && k + e < n) ? sg[row * n + k + e] : 0.f;
    }
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v[0], v[1], h0, m0, l0);
    split3(v[2], v[3], h1, m1, l1);
    const int off = row * pl.ld_b + k;
    *reinterpret_cast<uint2*>(planes + off) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(planes + plane + off) = make_uint2(m0, m1);
    *reinterpret_cast<uint2*>(planes + 2 * plane + off) = make_uint2(l0, l1);
  }
  __syncthreads();

  // ldmatrix row addresses: C [l][n] as the row-major operand, the planes [p][n] col-major
  const uint32_t a_base =
      smem_addr(cs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pl.ld_b + (lane >> 4) * 8);
  const uint32_t b_base =
      smem_addr(planes + ((lane & 7) + (lane >> 4) * 8) * pl.ld_b + ((lane >> 3) & 1) * 8);
  float* yg = y + g * q * p;
  for (int r = warp; r < pl.rows; r += kCombineWarps) {
    mbar_wait(smem_addr(bars + r * kRowGroup / kSTile), 0);
    float acc[PT][4];
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1  // one k-step's fragments live at a time (registers for more blocks an SM)
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t af[4];
      ldsm_x4(a_base + 2 * (r * kRowGroup * pl.ld_b + 16 * kk), af);
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp)
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          uint32_t bf[4];
          ldsm_x4(b_base + 2 * (k * plane + 16 * pp * pl.ld_b + 16 * kk), bf);
          mma_bf16(acc[2 * pp], af, bf[0], bf[1]);
          mma_bf16(acc[2 * pp + 1], af, bf[2], bf[3]);
        }
    }
    const int la = r * kRowGroup + (lane >> 2), lb = la + 8;
    const float sa = la < q ? expf(cum[g * q + la]) : 0.f;
    const float sb = lb < q ? expf(cum[g * q + lb]) : 0.f;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int col = 8 * j + 2 * tq;
      if (vec_y) {  // p even: (col, col + 1) both in or both out
        if (la < q && col < p)
          *reinterpret_cast<float2*>(yg + la * p + col) = make_float2(sa * acc[j][0], sa * acc[j][1]);
        if (lb < q && col < p)
          *reinterpret_cast<float2*>(yg + lb * p + col) = make_float2(sb * acc[j][2], sb * acc[j][3]);
      } else {
        if (la < q) {
          if (col < p) yg[la * p + col] = sa * acc[j][0];
          if (col + 1 < p) yg[la * p + col + 1] = sa * acc[j][1];
        }
        if (lb < q) {
          if (col < p) yg[lb * p + col] = sb * acc[j][2];
          if (col + 1 < p) yg[lb * p + col + 1] = sb * acc[j][3];
        }
      }
    }
  }
}

// Raise the instantiation's dynamic shared-memory cap to kSmemMax, once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <int NK, int PT>
int launch_chunk_tc(const TcPlan& pl, const __nv_bfloat16* x, const float* da,
                    const __nv_bfloat16* b, const __nv_bfloat16* c, float* y, float* states,
                    float* decay, float* cum, long long g, int q, int p, int n, cudaStream_t s) {
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_smem(ssd_chunk_tc<NK, PT>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_stage = n % 8 == 0 && p % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_c = n % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0;
  const bool vec_y = p % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  ssd_chunk_tc<NK, PT><<<static_cast<unsigned>(g), kChunkThreads, pl.smem_chunk, s>>>(
      x, da, b, c, y, states, decay, cum, q, p, n, vec_stage, vec_c, vec_y);
  return static_cast<int>(cudaGetLastError());
}

template <int NK, int PT>
int launch_combine_tc(const TcPlan& pl, const __nv_bfloat16* c, const float* cum,
                      const float* s_in, float* y, long long g, int q, int p, int n,
                      cudaStream_t s) {
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_smem(ssd_combine_tc<NK, PT>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_c = n % 8 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const bool vec_s = n % 4 == 0 && reinterpret_cast<uintptr_t>(s_in) % 16 == 0;
  const bool vec_y = p % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  ssd_combine_tc<NK, PT><<<static_cast<unsigned>(g), kCombineThreads, pl.smem_combine, s>>>(
      c, cum, s_in, y, q, p, n, vec_c, vec_s, vec_y);
  return static_cast<int>(cudaGetLastError());
}

#define SSD_TC_CASES(LAUNCH, ...)                                                     \
  switch (pl.nk * 100 + pl.pt) {                                                      \
    case 402: return LAUNCH<4, 2>(pl, __VA_ARGS__);                                   \
    case 404: return LAUNCH<4, 4>(pl, __VA_ARGS__);                                   \
    case 406: return LAUNCH<4, 6>(pl, __VA_ARGS__);                                   \
    case 408: return LAUNCH<4, 8>(pl, __VA_ARGS__);                                   \
    case 802: return LAUNCH<8, 2>(pl, __VA_ARGS__);                                   \
    case 804: return LAUNCH<8, 4>(pl, __VA_ARGS__);                                   \
    case 806: return LAUNCH<8, 6>(pl, __VA_ARGS__);                                   \
    case 808: return LAUNCH<8, 8>(pl, __VA_ARGS__);                                   \
  }                                                                                   \
  return static_cast<int>(cudaErrorInvalidValue)

// ============================== both routes ==============================

bool bad_shape(long long g, int q, int p, int n) {
  return g < 1 || g > 0x7fffffffLL || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || n < 1;
}

template <typename T>
int launch_chunk_simt(const void* x, const float* da, const void* b, const void* c, float* y,
                      float* states, float* decay, float* cum, long long g, int q, int p, int n,
                      cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(g), (q + kT - 1) / kT + (n + kT - 1) / kT);
  ssd_chunk_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), da, static_cast<const T*>(b), static_cast<const T*>(c), y,
      states, decay, cum, q, p, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine_simt(const void* c, const float* cum, const float* states_in, float* y,
                        long long g, int q, int p, int n, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(g), (q + kT - 1) / kT);
  ssd_combine_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(c), cum, states_in, y,
                                                  q, p, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c [g, q, *] fp32 (bf16 = 0) or bf16 (bf16 = 1); da [g, q] fp32;
// outputs y [g, q, p], states [g, p, n], decay [g], cum [g, q] fp32; all
// contiguous on the current device.  bf16 runs on the tensor cores (n <=
// 128), fp32 on the SIMT kernel.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernels do not take).
extern "C" int ssd_chunk(const void* x, const float* da, const void* b, const void* c,
                         float* y, float* states, float* decay, float* cum,
                         long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n) || (bf16 && n > kMaxNTc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_chunk_simt<float>(x, da, b, c, y, states, decay, cum, g, q, p, n, s);
  const TcPlan pl = tc_plan(q, p, n);
  SSD_TC_CASES(launch_chunk_tc, static_cast<const __nv_bfloat16*>(x), da,
               static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c), y,
               states, decay, cum, g, q, p, n, s);
}

// c [g, q, n] fp32 or bf16; cum [g, q], states_in [g, p, n], y [g, q, p] fp32.
extern "C" int ssd_combine(const void* c, const float* cum, const float* states_in, float* y,
                           long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n) || (bf16 && n > kMaxNTc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_combine_simt<float>(c, cum, states_in, y, g, q, p, n, s);
  const TcPlan pl = tc_plan(q, p, n);
  SSD_TC_CASES(launch_combine_tc, static_cast<const __nv_bfloat16*>(c), cum, states_in, y, g, q,
               p, n, s);
}

// The SIMT kernels for either dtype, as ssd_chunk and ssd_combine launched
// them before the tensor-core route: `chip_smoke.py --sweep-ssd` times the
// bf16 instance beside the tensor cores.  Nothing in the package calls these.
extern "C" int ssd_chunk_simt(const void* x, const float* da, const void* b, const void* c,
                              float* y, float* states, float* decay, float* cum,
                              long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_chunk_simt<__nv_bfloat16>(x, da, b, c, y, states, decay, cum, g, q, p, n, s)
              : launch_chunk_simt<float>(x, da, b, c, y, states, decay, cum, g, q, p, n, s);
}

extern "C" int ssd_combine_simt(const void* c, const float* cum, const float* states_in, float* y,
                                long long g, int q, int p, int n, int bf16, void* stream) {
  if (bad_shape(g, q, p, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_combine_simt<__nv_bfloat16>(c, cum, states_in, y, g, q, p, n, s)
              : launch_combine_simt<float>(c, cum, states_in, y, g, q, p, n, s);
}
