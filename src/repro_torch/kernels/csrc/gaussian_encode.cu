// Dense encode out = G A (fp32) for coded parity and reserve rows.
//
// Replaces the Pallas TPU kernel repro/kernels/lt_encode.py ::
// gaussian_encode_pallas (def :107, pallas_call :125).  G [q, r] is a dense
// generator slice, A [r, M] the source; out [q, M].  On the serving path it
// re-encodes the coded LM head with one more parity block
// (encode_blocks_device): G = B [nb, n_data], A = the head's data blocks
// flattened to [n_data, br*in] (glm4-9b after a (13, 3) re-split: [16, 13] x
// [13, 47,751,168]).  On the task path it encodes all of a Gaussian plan's
// rows, static and reserve, in one launch (encode_rows: [564, 500] x
// [500, 500,000] in chip_smoke.py).  Two engines, one launch either way;
// the wrapper (kernels/lt_encode.py::gaussian_engine) takes the register
// engine up to GAUSSIAN_WIDE_MIN_Q rows of G and the tensor-core engine
// above (chip_smoke.py --sweep-gauss measured where each wins).
//
// The register engine, for small q (every parity raise: q = 16).
// What bounds it on an H100: memory.  Each element of A feeds q
// multiply-adds and each output element r of them, so the least time is
// (bytes(A) + bytes(out)) / 3.35 TB/s: at the glm4-9b raise 2.48 GB + 3.06
// GB, 1.65 ms.  At r = 500 the fp32 FMA rate (67 TFLOP/s) comes close,
// so FMAs spent on rows past q show.
//
// Design, for that bound (no TF32, no tensor cores: fp32 means fp32):
//  * A goes straight from device memory into registers, once.  Each thread
//    owns a column quad (float4 loads where M % 4 == 0 and the pointers are
//    16-byte aligned; otherwise 4 scalar columns 128 apart, still coalesced)
//    and every row of the block's q-tile: QT x 4 sums in registers.  No two
//    threads use the same element of A, so nothing of A is staged in shared
//    memory and no barrier separates loads from FMAs.
//  * G's q-tile is staged transposed ([k][QT]) in dynamic shared memory once
//    per block and read back as float4 broadcasts.  Where r x QT x 4 bytes
//    exceeds a 64 KB cap, r is walked in panels of G (restaged per column
//    span), so shared memory alone never keeps a third block off an SM.
//  * QT is a template parameter: q rounded up to a multiple of 4 (4 to 32),
//    so q = 16 (every parity raise) wastes no FMA and q = 26 two rows of 28.
//    Where q > 32 the rows are cut into ceil(q / 32) equal q-tiles and A is
//    read once per q-tile: this engine is for small q.
//  * The k loop loads U rows of A (16, or 8 at QT > 16) before the first
//    FMA that needs them: at r = 13 all 13 are in flight together.
//  * A persistent grid (a few blocks per SM, from the occupancy the wrapper
//    asks for) walks 512-column spans grid-stride, so G is staged once per
//    block and not once per span.
//  * out is stored with an evict-first hint (__stcs): nothing reads it again.
//  * Ragged shapes: rows past q, k past r (zero-padded to U in shared
//    memory and in registers), M % 4 != 0, M = 1, misaligned views (the
//    scalar variant) and 64-bit offsets (r x M past 2^31).
// The wrapper (kernels/lt_encode.py::gaussian_plan) computes the launch
// geometry; gaussian_encode() checks it and refuses what it does not take.
// On an H100 (700 W) the glm4-9b raise takes 1.955 ms (85 % of its bound;
// torch.matmul 3.178 ms) and a 26-row reserve slice at m = 200,000
// 0.194 ms (65 %; torch.matmul 0.247 ms), where the first port took 3.33
// and 0.331 ms (chip_smoke.py).  At the Gaussian task's whole plan (q =
// 564: 18 q-tiles, A read 18 times) it takes 9.98 ms against
// torch.matmul's 6.14.  ptxas reports up to 255 registers (the widest
// q-tiles) and no spills.
//
// The tensor-core engine, for q above GAUSSIAN_WIDE_MIN_Q (the Gaussian
// task's whole plan, G [564, 500] x A [500, 500,000]).
// What bounds it: operations.  2 q r M fp32 multiply-adds (0.282 TFLOP at
// the task) take 4.21 ms at the fp32 FMA rate, which no CUDA-core kernel
// beats by much (torch.matmul's SGEMM reaches 69 % of it); on the tensor
// cores, with each fp32 operand split into three bf16 pieces and six piece
// products taken (wide_rows.cuh: each product exact in the fp32
// accumulator, neither TF32 nor a reduced precision mode), 6 x 0.282 TFLOP
// at 989 TFLOP/s is 1.71 ms; the bytes (A read once a column tile of 256
// rows of G, out written once) 1.23 ms.  Design: wide_rows.cuh's engine
// with W = A^T and x = G^T, out^T [M, q] = A^T G^T.  Of the two layouts
// open, the transposed one reuses the engine whole (the ring, the TMA
// producer, the consumers' six products and the stage-by-stage fp32 sums,
// the persistent grid) and splits A in registers as the head kernels split
// their weight; the other (G as the register operand, A's fp32 tile split
// into bf16 pieces in shared memory for wgmma's B operand) needs a
// shared-memory split pass a stage and a second engine.  So:
//  * A row tile is 128 columns of A; a stage is A's [32 rows][128 columns]
//    tile, four TMA boxes [32][32] (128-byte swizzle) in A's own layout,
//    which the consumers read as the transpose (wide_rows.cuh's
//    kTransposedW, conflict-free) and split in registers into the A
//    fragments of m64n32k16.  Where A is misaligned or M % 4 != 0 the
//    producer warp loads it into the same layout.
//  * G's pieces are split once a call by gaussian_split_g into [3][b_pad]
//    [r_pad] bf16 (G's rows are G^T's columns, so no transpose), zero past q
//    and r, and reach the consumers by TMA as the B operand.
//  * q is cut into ceil(q / 256) column tiles of equal width (a multiple of
//    32: 3 x 192 at q = 564), and the items run column-tile-minor, so the
//    tiles that read one tile of A are in flight together and the L2
//    serves their second and third reads: A comes from device memory about
//    once.  K = r in a fixed order (32 rows a stage, one fresh accumulator
//    a stage, added on the CUDA cores), no atomics.
//  * The epilogue stores out [q, M] straight from the accumulators with an
//    evict-first hint: the lanes of a row hold 8 consecutive columns, whole
//    32-byte sectors.
//  * 64-bit offsets; M < 2^31 (TMA coordinates).
// On an H100 80GB HBM3 (700 W) the whole plan takes 2.86 ms, 60 % of its
// 1.71 ms bound, against torch.matmul's 6.24 and the register engine's
// 10.12, its error against float64 below fp32 torch.matmul's; at r = 500
// it is the faster engine from q = 16 up, at the parity raises (r = 13)
// the slower (3.74 ms against 1.95 at glm4-9b), so GAUSSIAN_WIDE_MIN_Q
// keeps q <= 32 on the register engine (chip_smoke.py --sweep-gauss).
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_rows.cuh"

namespace {

constexpr int kThreads = 128;            // one column quad each
constexpr int kSpan = 4 * kThreads;      // columns a block covers per work item
constexpr int kSmemCap = 64 * 1024;      // bytes of G a block stages at most

__host__ __device__ constexpr int unroll_for(int qt) { return qt > 16 ? 8 : 16; }

__device__ __forceinline__ void fma4(float (&c)[4], float g, const float4& x) {
  c[0] = fmaf(g, x.x, c[0]);
  c[1] = fmaf(g, x.y, c[1]);
  c[2] = fmaf(g, x.z, c[2]);
  c[3] = fmaf(g, x.w, c[3]);
}

template <int QT, bool VEC4>
__global__ void __launch_bounds__(kThreads)
gaussian_encode_kernel(const float* __restrict__ g, const float* __restrict__ a,
                       float* __restrict__ out, int q, int r, int64_t m, int panel,
                       int n_qtiles, int64_t n_spans) {
  constexpr int U = unroll_for(QT);
  extern __shared__ __align__(16) float gs[];  // [round_up(panel rows, U)][QT]
  const int n_panels = (r + panel - 1) / panel;
  const int64_t n_work = static_cast<int64_t>(n_qtiles) * n_spans;
  int staged = -1;  // the q-tile whose only panel gs holds

  for (int64_t w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int tile = static_cast<int>(w / n_spans);
    const int q0 = tile * QT;
    // VEC4: columns col .. col + 3; scalar: col + j * kThreads, j = 0..3
    const int64_t col = (w % n_spans) * kSpan + (VEC4 ? 4 * threadIdx.x : threadIdx.x);

    float acc[QT][4];
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int p = 0; p < n_panels; ++p) {
      const int k0 = p * panel;
      const int kp = min(panel, r - k0);
      if (n_panels > 1 || tile != staged) {
        const int kpad = (kp + U - 1) / U * U;
        __syncthreads();  // every thread is done with the previous panel
        for (int idx = threadIdx.x; idx < QT * kpad; idx += kThreads) {
          const int i = idx / kpad, k = idx % kpad;
          gs[k * QT + i] = (q0 + i < q && k < kp)
                               ? g[static_cast<int64_t>(q0 + i) * r + k0 + k] : 0.f;
        }
        __syncthreads();
        staged = tile;
      }
      const float* ap = a + static_cast<int64_t>(k0) * m + col;
      for (int kk = 0; kk < kp; kk += U) {
        float4 av[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          av[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kk + u < kp) {
            const float* src = ap + static_cast<int64_t>(kk + u) * m;
            if (VEC4) {
              if (col < m) av[u] = __ldg(reinterpret_cast<const float4*>(src));
            } else {
              if (col < m) av[u].x = __ldg(src);
              if (col + kThreads < m) av[u].y = __ldg(src + kThreads);
              if (col + 2 * kThreads < m) av[u].z = __ldg(src + 2 * kThreads);
              if (col + 3 * kThreads < m) av[u].w = __ldg(src + 3 * kThreads);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4* gk = reinterpret_cast<const float4*>(gs + (kk + u) * QT);
#pragma unroll
          for (int i4 = 0; i4 < QT / 4; ++i4) {
            const float4 gv = gk[i4];
            fma4(acc[4 * i4 + 0], gv.x, av[u]);
            fma4(acc[4 * i4 + 1], gv.y, av[u]);
            fma4(acc[4 * i4 + 2], gv.z, av[u]);
            fma4(acc[4 * i4 + 3], gv.w, av[u]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (q0 + i >= q) break;
      float* o = out + static_cast<int64_t>(q0 + i) * m + col;
      if (VEC4) {
        if (col < m)
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j * kThreads < m) __stcs(o + j * kThreads, acc[i][j]);
      }
    }
  }
}

template <int QT, bool VEC4>
void* kernel_ptr() {
  return reinterpret_cast<void*>(&gaussian_encode_kernel<QT, VEC4>);
}

// the instantiation for (qt, vec4), or nullptr for a qt the kernel does not take
void* select(int qt, bool vec4) {
#define GE_CASE(QT) \
  case QT: return vec4 ? kernel_ptr<QT, true>() : kernel_ptr<QT, false>();
  switch (qt) {
    GE_CASE(4) GE_CASE(8) GE_CASE(12) GE_CASE(16)
    GE_CASE(20) GE_CASE(24) GE_CASE(28) GE_CASE(32)
    default: return nullptr;
  }
#undef GE_CASE
}

int smem_for(int qt, int r, int panel) {
  const int u = unroll_for(qt);
  const int rows = panel < r ? panel : r;
  return (rows + u - 1) / u * u * qt * 4;
}

}  // namespace

namespace {

// ---- the tensor-core engine (wide_rows.cuh): q > GAUSSIAN_WIDE_MIN_Q
//
// out^T [m, q] = A^T G^T: W = A^T (128 columns of A a row tile, read from
// A in its own layout: wide_rows.cuh's transposed W), x = G^T, whose pieces
// are G's rows split (gaussian_split_g), q in column tiles of up to 256.
struct WideGaussianTask {
  using Elem = float;
  static constexpr bool kTransposedW = true;
  const float* a;   // A [r, m]: the source S of W = A^T
  int64_t pitch;    // A's row length, m
  float* out;       // [q, m]
  int q;

  __device__ void prologue(unsigned char*, const wide_rows::Geometry&, int, int) const {}
  // the tile's four [32 k][32 column] boxes of A; no cache hint: the tile's
  // other column tiles read it again from the L2
  __device__ void tma_w(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int rt, int kt,
                        const wide_rows::Geometry& g, uint64_t) const {
#pragma unroll
    for (int b = 0; b < wide_rows::kTileRows / wide_rows::kTBoxRows; ++b)
      wide_rows::tma_2d(dst + b * wide_rows::kTBoxBytes, map, bar,
                        rt * wide_rows::kTileRows + b * wide_rows::kTBoxRows, kt * g.bk);
  }
  // acc[c][4 j + 2 h + e] is A's column rt * 128 + row0 + 8 h and G's row
  // ct * cols + 32 c + 8 j + 2 t + e: lanes lane / 4 = 0..7 store 8
  // consecutive floats of a row of out, whole 32-byte sectors
  template <int NT>
  __device__ void epilogue(const float (&acc)[NT][16], unsigned char*, int rt, int ct,
                           const wide_rows::Geometry& g, int row0, int t, int) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t col = static_cast<int64_t>(rt) * wide_rows::kTileRows + row0 + 8 * h;
      if (col >= g.rows) continue;
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = ct * g.cols + c * wide_rows::kColQuantum + 8 * j + 2 * t + e;
            if (row < q) __stcs(out + static_cast<int64_t>(row) * g.rows + col,
                                acc[c][4 * j + 2 * h + e]);
          }
    }
  }
};

// G [q, r] -> gp [3][b_pad][m_pad] bf16: each element's pieces hi, mid, lo
// (as wide_rows::wide_split_x splits x), zero past q and r.  G^T's column
// j is G's row j, so no transpose.
__global__ void __launch_bounds__(256) gaussian_split_g(const float* __restrict__ g,
                                                        __nv_bfloat16* __restrict__ gp, int q,
                                                        int r, int m_pad, int b_pad) {
  const int64_t plane = static_cast<int64_t>(b_pad) * m_pad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < plane;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    const int j = static_cast<int>(i / m_pad), k = static_cast<int>(i % m_pad);
    const float v = j < q && k < r ? g[static_cast<int64_t>(j) * r + k] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float rest = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
    gp[i] = hi;
    gp[plane + i] = mid;
    gp[2 * plane + i] = __float2bfloat16_rn(rest - __bfloat162float(mid));
  }
}

}  // namespace

// The tensor-core engine: g [q, r], a [r, m], out [q, m] fp32, contiguous,
// on the current device; gp the scratch of G's pieces (2 * 3 * b_pad *
// m_pad bytes, 16-byte aligned).  The geometry comes from the wrapper
// (kernels/wide_rows.py::wide_plan(m, r, q)): the persistent grid, the
// tile's columns, the stages and smem_bytes, which must equal
// wide_rows::geometry's.  A goes by TMA where a is 16-byte aligned and m %
// 4 == 0, else by the producer warp's loads.  Launches the split of G, then
// the kernel.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or geometry the kernel does not take,
// cudaErrorNotSupported if the driver encodes no tensor map).
extern "C" int gaussian_encode_wide(const float* g, const float* a, void* gp, float* out,
                                    int q, int r, long long m, int grid, int cols, int stages,
                                    int smem_bytes, void* stream) {
  if (q < 1 || r < 1 || m < 1 || m >= (1LL << 31) ||
      wide_rows::cdiv(m, wide_rows::kTileRows) * wide_rows::cdiv(q, wide_rows::kMaxTileCols) >=
          (1LL << 31) ||
      reinterpret_cast<uintptr_t>(gp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wide_rows::Geometry geo = wide_rows::geometry(m, r, q, 4, 0, 0);
  if (!wide_rows::same_plan(geo, grid, cols, stages, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  geo.tma_w = reinterpret_cast<uintptr_t>(a) % 16 == 0 && m % 4 == 0;
  CUtensorMap w_map{}, x_map{};
  if (geo.tma_w) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(r)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * 4};
    const cuuint32_t box[2] = {wide_rows::kTBoxRows, static_cast<cuuint32_t>(geo.bk)};
    if (!wide_rows::encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorNotSupported);
  }
  if (!wide_rows::encode_x(&x_map, gp, geo)) return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(geo.b_pad) * geo.m_pad;
  const int split_blocks = static_cast<int>(plane / 256 + 1 < 1024 ? plane / 256 + 1 : 1024);
  gaussian_split_g<<<split_blocks, 256, 0, s>>>(g, static_cast<__nv_bfloat16*>(gp), q, r,
                                                geo.m_pad, geo.b_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const WideGaussianTask task{a, m, out, q};
  return wide_rows::launch(grid, s, w_map, x_map, task, geo);
}

// Blocks of the (qt, vec4) variant that fit on one SM with smem_bytes of
// dynamic shared memory, into *blocks.  Returns a cudaError_t.
extern "C" int gaussian_encode_occupancy(int qt, int vec4, int smem_bytes, int* blocks) {
  void* fn = select(qt, vec4 != 0);
  if (fn == nullptr || smem_bytes < 0 || smem_bytes > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem_bytes));
}

// g [q, r], a [r, m], out [q, m]; all fp32, contiguous, on the current
// device.  The geometry comes from the wrapper: the q-tile qt (a multiple
// of 4, at most 32) and n_qtiles = ceil(q / qt); G's panel (rows of r a
// block stages at once) and smem_bytes = round_up(min(panel, r), U) x qt x 4
// (at most 64 KB); the persistent grid; vec4 (m % 4 == 0, a and out 16-byte
// aligned).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or geometry the kernel does not take).
extern "C" int gaussian_encode(const float* g, const float* a, float* out, int q, int r,
                               long long m, int qt, int n_qtiles, int panel, int smem_bytes,
                               int grid, int vec4, void* stream) {
  void* fn = select(qt, vec4 != 0);
  if (fn == nullptr || q < 1 || r < 1 || m < 1 || panel < 1 || grid < 1 ||
      n_qtiles != (q + qt - 1) / qt || smem_bytes != smem_for(qt, r, panel) ||
      smem_bytes > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec4 && (m % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_spans = (m + kSpan - 1) / kSpan;
  void* args[] = {&g, &a, &out, &q, &r, &m, &panel, &n_qtiles,
                  const_cast<long long*>(&n_spans)};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args,
                         static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
