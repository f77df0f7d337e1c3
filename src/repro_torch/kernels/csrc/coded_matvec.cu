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
#include "thin_rows.cuh"

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
