// Coded matvec / thin matmul y = A x: one worker's (or one code block's) product.
//
// Replaces the Pallas TPU kernel repro/kernels/coded_matvec.py ::
// coded_matvec_pallas (def :47, pallas_call :65): A [R, M] (fp32 or fp16),
// x [M, B] of the same type, y [R, B] fp32, summed in fp32.  On the serving
// path it is the local product of each code block of the mesh-sharded coded
// head (glm4-9b: [10826, 4096] fp32 a block, B = 1 at prefill and B =
// n_slots at decode).
//
// What bounds it on an H100: reading A once (a [10826, 4096] fp32 block:
// 177 MB, 0.053 ms at 3.35 TB/s).  The TPU kernel walks a sequential grid of
// column panels with the output block resident in VMEM; here the row
// products stream through thin_rows.cuh: a persistent grid whose blocks
// take equal, interleaved shares of the rows, x staged once a block, A read
// by a register stream (16 warps, 6 loads of each of 2 rows in flight a
// lane) and each row summed by one warp in a fixed order.  The epilogue
// writes each row's B sums, one store per output.  fp32 FMA throughout (no
// TF32); fp16 inputs are widened to fp32 before the FMA.  On an H100 80GB
// HBM3 at 700 W, through the wrapper as the path calls it, a glm4-9b
// block takes 0.0615 ms at B = 1 and 0.0656 at B = 4 (86 and 81 % of the
// bound; torch.matmul 0.0690 and 0.0980), and 0.0434 in fp16 at B = 4
// (torch.matmul 0.0478); launched through the bare C entry in turns with
// the wrapper, 0.0603, 0.0649 and 0.0429.  The wrapper's host time is
// 0.028-0.047 ms a call against the C entry's 0.007-0.013, under the
// kernel's, so the device does not wait on it (chip_smoke.py --sweep-head,
// kernel rows).  The first port took 0.0781, 0.0772 and 0.0479.
//
// x of WIDE_MIN_B (8) columns and more goes to the second entry,
// coded_matvec_wide, on the wide engine (wide_rows.cuh: 128-row tiles on
// the tensor cores, A read once a tile of up to 256 columns of x).  At the
// glm4-9b block it takes 0.0757, 0.1049, 0.1038 and 0.1576 ms at B = 17,
// 33, 64 and 128 (torch.matmul 0.0978 to 0.2354), 0.0403 in fp16 at 64
// (torch.matmul 0.0344) (chip_smoke.py kernel rows, H100 80GB HBM3, 700 W).
#include "thin_rows.cuh"
#include "wide_rows.cuh"

namespace {

using thin_rows::Group;

// The unit is a row; a group is kRowsPerWarp rows a warp.  The
// block's share fits an int (r < 2^31).
template <typename T>
struct MatvecTask {
  using Elem = T;
  const T* a;
  const T* x;
  float* out;
  int b;

  static constexpr bool kUnitIsGroup = false;
  __device__ const T* row(const Group& g, int i, int64_t m) const {
    return a + (g.first + i * g.stride) * m;
  }
  __device__ void prologue(float*, int, int) const {}
  __device__ void before_rows(int, float*) const {}
  __device__ void finish_row(const Group& g, int, int i, int q, float v, float*) const {
    out[(g.first + i * g.stride) * b + q] = v;
  }
  __device__ void after_rows(const Group&, int, float*, int, int) const {}
  __device__ void finish_block(const Group&, int, float*, int, int) const {}
};

constexpr int kGroupRows = thin_rows::kWarps * thin_rows::kRowsPerWarp;

bool vec_ok(const void* a, long long m, int half) {
  return m % (half ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

template <typename T>
thin_rows::KernelFn<MatvecTask<T>> pick(int b, bool vec) {
  return thin_rows::pick<MatvecTask<T>, thin_rows::kRowsPerWarp>(b, vec);
}

template <typename T>
int run(const void* a, const void* x, float* out, long long r, long long m, int b, int vec,
        int grid, int group_rows, int x_panel, int smem_bytes, void* stream) {
  if (grid < 1 || grid > r) return static_cast<int>(cudaErrorInvalidValue);
  const thin_rows::Geometry geo = thin_rows::geometry(m, r, grid, b, kGroupRows, 0);
  if (group_rows != geo.group_rows || x_panel != geo.x_panel || smem_bytes != geo.smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const MatvecTask<T> task{static_cast<const T*>(a), static_cast<const T*>(x), out, b};
  return thin_rows::launch(pick<T>(b, vec != 0), grid, stream, task, geo);
}

// ---- the wide engine (wide_rows.cuh): x of WIDE_MIN_B columns and more
//
// A row tile is 128 rows of A; its sums go straight from the registers to y.
template <typename T>
struct WideMatvecTask {
  using Elem = T;
  const T* a;
  float* out;
  int64_t r;
  int b;

  __device__ void prologue(unsigned char*, const wide_rows::Geometry&, int, int) const {}
  __device__ void tma_w(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int rt, int kt,
                        const wide_rows::Geometry& g, uint64_t policy) const {
    wide_rows::tma_2d(dst, map, bar, kt * g.bk, rt * wide_rows::kTileRows, policy);
  }
  // tile row rr is row rt * 128 + rr of A; none past A's edge
  __device__ const T* w_row(int rr, int rt, const wide_rows::Geometry& g) const {
    const int64_t row = static_cast<int64_t>(rt) * wide_rows::kTileRows + rr;
    return row < r ? a + row * g.m : nullptr;
  }
  // acc[c][4 j + 2 h + e] is row row0 + 8 h, column 32 c + 8 j + 2 t + e
  template <int NT>
  __device__ void epilogue(const float (&acc)[NT][16], unsigned char*, int rt, int ct,
                           const wide_rows::Geometry& g, int row0, int t, int) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = static_cast<int64_t>(rt) * wide_rows::kTileRows + row0 + 8 * h;
      if (row >= r) continue;
      float* y = out + row * b;
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = ct * g.cols + c * wide_rows::kColQuantum + 8 * j + 2 * t + e;
            if (col < b) y[col] = acc[c][4 * j + 2 * h + e];
          }
    }
  }
};

}  // namespace

// Blocks of the (b, half, vec) variant that fit on one SM with smem_bytes
// of dynamic shared memory, into *blocks.  Returns a cudaError_t.
extern "C" int coded_matvec_occupancy(int b, int half, int vec, int smem_bytes, int* blocks) {
  if (b < 1 || b > thin_rows::kMaxB || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (half) return thin_rows::occupancy(pick<__half>(b, vec != 0), smem_bytes, blocks);
  return thin_rows::occupancy(pick<float>(b, vec != 0), smem_bytes, blocks);
}

// a [r, m], x [m, b] (both fp32, or both fp16 when half != 0), out [r, b]
// fp32; all contiguous, on the current device.  The geometry comes from the
// wrapper (kernels/thin_rows.py::head_plan): vec (m a whole number of
// 16-byte words and a 16-byte aligned), the persistent grid (at most r
// blocks), group_rows, x_panel and smem_bytes, which must equal
// thin_rows::geometry's.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or geometry the kernel does not take).
extern "C" int coded_matvec(const void* a, const void* x, float* out, long long r, long long m,
                            int b, int half, int vec, int grid, int group_rows, int x_panel,
                            int smem_bytes, void* stream) {
  if (b < 1 || b > thin_rows::kMaxB || r < 1 || r >= (1LL << 31) || m < 1 ||
      (vec != 0) != vec_ok(a, m, half))
    return static_cast<int>(cudaErrorInvalidValue);
  if (half)
    return run<__half>(a, x, out, r, m, b, vec, grid, group_rows, x_panel, smem_bytes, stream);
  return run<float>(a, x, out, r, m, b, vec, grid, group_rows, x_panel, smem_bytes, stream);
}

// The wide engine: a [r, m], x [m, b] (both fp32, or both fp16 when half !=
// 0), out [r, b] fp32, xp the scratch of x's pieces (2 * pieces * b_pad *
// m_pad bytes, 16-byte aligned); all contiguous, on the current device.  The
// geometry comes from the wrapper (kernels/wide_rows.py::wide_plan): the
// persistent grid (at most the plan's items), the tile's columns, the
// stages and smem_bytes, which must equal wide_rows::geometry's.  Launches
// the split of x, then the kernel.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape or geometry the kernel does
// not take, cudaErrorNotSupported if the driver encodes no tensor map).
extern "C" int coded_matvec_wide(const void* a, const void* x, void* xp, float* out,
                                 long long r, long long m, int b, int half, int grid, int cols,
                                 int stages, int smem_bytes, void* stream) {
  if (b < 1 || r < 1 || r >= (1LL << 31) || m < 1 || m >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(xp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = half ? 2 : 4;
  wide_rows::Geometry g = wide_rows::geometry(r, m, b, elt, 0, 0);
  if (!wide_rows::same_plan(g, grid, cols, stages, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  g.tma_w = reinterpret_cast<uintptr_t>(a) % 16 == 0 && (m * elt) % 16 == 0;
  CUtensorMap w_map{}, x_map{};
  if (g.tma_w) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(r)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * elt};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(g.bk), wide_rows::kTileRows};
    const CUtensorMapDataType type =
        half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!wide_rows::encode(&w_map, type, 2, a, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorNotSupported);
  }
  if (!wide_rows::encode_x(&x_map, xp, g)) return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half) {
    const int err = wide_rows::split_x(static_cast<const __half*>(x), xp, g, s);
    if (err != 0) return err;
    const WideMatvecTask<__half> task{static_cast<const __half*>(a), out, r, b};
    return wide_rows::launch(grid, s, w_map, x_map, task, g);
  }
  const int err = wide_rows::split_x(static_cast<const float*>(x), xp, g, s);
  if (err != 0) return err;
  const WideMatvecTask<float> task{static_cast<const float*>(a), out, r, b};
  return wide_rows::launch(grid, s, w_map, x_map, task, g);
}
