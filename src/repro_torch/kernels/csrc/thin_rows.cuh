// Thin row products on an H100: fp32 dot products of the rows of a tall
// weight W with a thin x [M, B] (B <= 7), reading W once.  The engine of
// coded_matvec.cu (y = A x) and coded_decode.cu (y = R . blocked(W_c x));
// each source supplies a Task: which rows a unit is, and what happens to
// their sums (the epilogue).
//
// What bounds both on this card: reading W once.  About 2B flops per weight
// element, far below the fp32 balance (~20 flop/byte), so the least time is
// bytes(W) / 3.35 TB/s.  What the engine does about it:
//  * A persistent grid (at most two blocks an SM, as the occupancy allows;
//    the shipped setting fits one), each block an equal share of the units
//    (rows, or row tiles of the decode) to within one unit: no wave tail.
//    The shares interleave (block b takes units b, b + grid, ...), so at
//    any time the SMs read one narrow window of W (of each code block),
//    which the DRAM serves about 2 % faster than 132 separate runs.
//  * x staged once a block in shared memory, converted to fp32 and
//    transposed to [B][M], with 16-byte loads, when B x M x 4 bytes fit
//    kXCapBytes; above that it is walked in panels, restaged per row group
//    (B 5-7 at M = 4096).
//  * Rows are streamed in groups of up to 32 (one group's sums live in the
//    registers of the warps, RPW rows a warp) by a register stream: 16
//    warps, each lane keeping 6 16-byte streaming loads (__ldcs, evict
//    first) of each of its 2 rows in flight before the first FMA that
//    needs them, the words raw until their FMAs.  Sixteen warps of at most
//    128 registers keep the memory busy while some of them add: a 3 KB row
//    (mamba2-130m's head) is one batch of loads.  No block-wide barrier in
//    the column loop.  A cp.async.bulk ring fed by a producer warp tied it
//    at a code block and lost at the decode and in fp16 (PERF.md §6).
//    Rows that are not 16-byte aligned (M not a multiple of the vector
//    width, or a view that starts mid-word) take scalar loads.
//  * A fixed sum order per output: lane l owns columns l*V + 32V*k (V
//    elements a 16-byte word, 1 for the scalar path), summed in k order,
//    then a butterfly shuffle.  Nothing depends on the grid or the panel
//    width, so two launches are bit-equal.  No float atomics, no split of M.
// Offsets are 64-bit.  The launch geometry is computed by the wrapper
// (kernels/thin_rows.py::head_plan); geometry() below computes it again and
// the C entries refuse a mismatch.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace thin_rows {

// ---- the shipped setting (chip_smoke.py --sweep-head builds copies with others)
constexpr int kWarps = 16;          // warps a block, each summing its rows
constexpr int kRowsPerWarp = 2;     // rows a warp streams at once (coded_matvec: its rows a group)
constexpr int kLoadsInFlight = 12;  // 16-byte loads a lane has in flight, all its rows

// ---- fixed geometry
constexpr int kMaxB = 7;  // x of WIDE_MIN_B = 8 columns and more takes the wide engine
constexpr int kMaxGroupRows = 32;          // rows whose sums a block holds at once
constexpr int kXCapBytes = 64 * 1024;      // x stays resident up to this many bytes
constexpr int kXPanelQuantum = 256;        // x panels are multiples of this many columns
constexpr int kSmemLimit = 227 * 1024;     // dynamic shared memory a block may use on sm_90
constexpr int kThreads = 32 * kWarps;

static_assert(kRowsPerWarp == 1 || kRowsPerWarp == 2 || kRowsPerWarp == 4, "1, 2 or 4 rows");
static_assert(kMaxGroupRows % kWarps == 0 &&
                  kWarps * kRowsPerWarp <= kMaxGroupRows,
              "a group (32 rows at most) is whole rows a warp");

// A launch's geometry; see geometry().
struct Geometry {
  int64_t m;        // columns of W, rows of x
  int64_t n_units;  // rows (coded_matvec) or row tiles (coded_matvec_decode)
  int64_t share;    // n_units / grid: a block's units, one more for the first `extra`
  int extra;        // n_units % grid
  int b;            // columns of x
  int group_rows;   // rows streamed together (<= 32)
  int x_panel;      // columns of x staged at once; >= m when x is resident
  int x_stride;     // floats between two columns of x in shared memory
  int epi_off;      // byte offset of the epilogue's scratch (x is at 0)
  int smem_bytes;   // dynamic shared memory of the launch
};

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The launch geometry for n_units units on `grid` blocks (1 <= grid <=
// n_units) over W's m columns, x [m, b], groups of group_rows rows and
// epi_bytes of epilogue scratch.  Mirrors kernels/thin_rows.py::head_plan.
inline Geometry geometry(int64_t m, int64_t n_units, int grid, int b, int group_rows,
                         int epi_bytes) {
  Geometry g{};
  g.m = m;
  g.n_units = n_units;
  g.share = n_units / grid;
  g.extra = static_cast<int>(n_units % grid);
  g.b = b;
  g.group_rows = group_rows;
  const int64_t m4 = (m + 3) / 4 * 4;
  if (static_cast<int64_t>(b) * m4 * 4 <= kXCapBytes) {
    g.x_panel = static_cast<int>(m);
    g.x_stride = static_cast<int>(m4);
  } else {
    g.x_panel = kXCapBytes / (4 * b) / kXPanelQuantum * kXPanelQuantum;
    g.x_stride = g.x_panel;
  }
  g.epi_off = b * g.x_stride * 4;
  g.smem_bytes = g.epi_off + epi_bytes;
  return g;
}

// A block's units: the j-th is block + j * grid, j < count; counts differ
// by at most one between blocks (no 64-bit division on the device).
struct Units {
  int64_t base, stride;
  int count;
};
__device__ __forceinline__ Units block_units(const Geometry& geo, int block, int grid) {
  return {block, grid, static_cast<int>(geo.share) + (block < geo.extra ? 1 : 0)};
}

// ---- Hopper primitives (inline PTX) and the launch
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// bytes (a multiple of 16, 16-byte aligned) from global memory into the L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}

template <class Task>
using KernelFn = void (*)(Task, Geometry);

// A kernel may take up to kSmemLimit bytes of dynamic shared memory.  The
// limit is only ever raised to that, never set to one launch's size: a later
// launch of the same kernel with more bytes (still under the 48 KB default)
// would be refused.
template <class Task>
cudaError_t allow_smem(KernelFn<Task> kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

// Blocks of `kernel` that fit on one SM, into *blocks; a cudaError_t.
template <class Task>
int occupancy(KernelFn<Task> kernel, int smem_bytes, int* blocks) {
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem_bytes));
}

// Launch on `stream`; cudaGetLastError() after the launch.
template <class Task>
int launch(KernelFn<Task> kernel, int grid, void* stream, const Task& task,
           const Geometry& geo) {
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<Task*>(&task), const_cast<Geometry*>(&geo)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args,
                         static_cast<size_t>(geo.smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- loads
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float half_lo(unsigned int u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu)));
}
__device__ __forceinline__ float half_hi(unsigned int u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

// one 16-byte word of the weight, which nothing reads again in the call:
// a streaming load (ld.global.cs, evict first)
__device__ __forceinline__ uint4 load_stream(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// V consecutive elements as fp32: a 16-byte word (VEC), kept raw until its
// FMAs, or one element
template <typename T, bool VEC>
struct Word;
template <>
struct Word<float, true> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& w, float (&f)[4]) {
    f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
  }
};
template <>
struct Word<__half, true> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4& w, float (&f)[8]) {
    f[0] = half_lo(w.x); f[1] = half_hi(w.x); f[2] = half_lo(w.y); f[3] = half_hi(w.y);
    f[4] = half_lo(w.z); f[5] = half_hi(w.z); f[6] = half_lo(w.w); f[7] = half_hi(w.w);
  }
};
template <>
struct Word<float, false> {
  static constexpr int V = 1;
  __device__ __forceinline__ static float load(const float* p) { return __ldcs(p); }
};
template <>
struct Word<__half, false> {
  static constexpr int V = 1;
  __device__ __forceinline__ static float load(const __half* p) {
    return __half2float(__ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
};

// V consecutive fp32 values of x from shared memory (16-byte aligned when V > 1)
template <int V>
__device__ __forceinline__ void x_words(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + e);
      f[e] = w.x; f[e + 1] = w.y; f[e + 2] = w.z; f[e + 3] = w.w;
    }
  }
}

// x's columns [c0, c0 + pm) into xs, transposed to [b][stride] fp32.  x [m,
// b] is read as a flat run of pm * b elements, kBatch 16-byte words a thread
// at a time where it is aligned, so a block stages 64 KB in a few round
// trips.
template <typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* x, int64_t c0, int pm, int b,
                                        int stride, int tid, int nthreads) {
  constexpr int kW = 16 / sizeof(T);  // elements a word
  constexpr int kBatch = 4;           // words a thread has in flight
  const T* src = x + c0 * b;
  const int n = pm * b;
  int done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int n_words = n / kW;
    const uint4* words = reinterpret_cast<const uint4*>(src);
    for (int w0 = 0; w0 < n_words; w0 += kBatch * nthreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int w = w0 + u * nthreads + tid;
        if (w < n_words) v[u] = __ldg(words + w);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int w = w0 + u * nthreads + tid;
        if (w < n_words) {
          float f[kW];
          Word<T, true>::unpack(v[u], f);
          int c = (w * kW) / b, q = w * kW - c * b;
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            xs[q * stride + c] = f[i];
            if (++q == b) {
              q = 0;
              ++c;
            }
          }
        }
      }
    }
    done = n_words * kW;
  }
  for (int idx = done + tid; idx < n; idx += nthreads) {
    const int c = idx / b, q = idx - c * b;
    xs[q * stride + c] = to_float(src[idx]);
  }
}

// acc[J0 + j][q] += sum_e w[j][e] * x_q[e] for the N rows from J0, in e order
template <int N, int J0, int RPW, int BMAX, int V>
__device__ __forceinline__ void fma_words(float (&acc)[RPW][BMAX], const float (&w)[N][V],
                                          const bool (&valid)[RPW], const float* xq, int stride,
                                          int b) {
#pragma unroll
  for (int q = 0; q < BMAX; ++q) {
    if (q < b) {
      float xv[V];
      x_words<V>(xq + q * stride, xv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (valid[J0 + j]) {
          float s = acc[J0 + j][q];
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(w[j][e], xv[e], s);
          acc[J0 + j][q] = s;
        }
      }
    }
  }
}

// ---- the engine
//
// Task (see coded_matvec.cu, coded_decode.cu) provides:
//   using Elem;                          float or __half
//   const Elem* x;                       [m, b]
//   bool kUnitIsGroup                    a unit is a group of G rows (a tile);
//                                        else a unit is a row, a group G units
//   const Elem* row(g, i, m)             row i of group g, or nullptr (no row)
//   void prologue(epi, tid, n)           block set-up by the n threads
//   void before_rows(k, epi)             a warp, before group k's sums
//   void finish_row(g, k, i, q, v, epi)  the sum v of row i, column q of x (lane q)
//   void after_rows(g, k, epi, warp, lane)   the warp's sums of group k are written
//   void finish_block(g, k, epi, warp, lane) after the block's last group k
struct Group {
  int64_t first;   // the group's first unit
  int64_t stride;  // between its units (and between the block's groups of one unit)
  int slots;       // rows in the group
};

template <class Task>
__device__ __forceinline__ int n_groups(const Units& u, int g) {
  return Task::kUnitIsGroup ? u.count : (u.count + g - 1) / g;
}
template <class Task>
__device__ __forceinline__ Group group(const Units& u, int k, int g) {
  if (Task::kUnitIsGroup) return {u.base + k * u.stride, u.stride, g};
  return {u.base + static_cast<int64_t>(k) * g * u.stride, u.stride,
          u.count - k * g < g ? u.count - k * g : g};
}

// The register stream's 16-byte words (or elements) of a row in flight:
// kLoadsInFlight across the RW rows, fewer as B grows (words x rows x B at
// most 64, so the raw words and the sums fit the registers), at least 2.
template <bool VEC, int RW, int BMAX>
__host__ __device__ constexpr int words_in_flight() {
  constexpr int kWant = kLoadsInFlight / RW, kFit = 64 / (RW * BMAX);
  constexpr int kWords = kWant < kFit ? kWant : kFit;
  return !VEC ? 8 : kWords > 2 ? kWords : 2;
}

// the register stream: rows J0 .. J0 + RW - 1 of the warp over x's staged
// columns [xp0, xp1), then the next RW rows
template <typename T, bool VEC, int RW, int J0, int RPW, int BMAX>
__device__ __forceinline__ void stream_rows(float (&acc)[RPW][BMAX], const T* (&rows)[RPW],
                                            const bool (&valid)[RPW], const float* xs,
                                            int64_t xp0, int64_t xp1, int stride, int b,
                                            int lane) {
  using W = Word<T, VEC>;
  constexpr int V = W::V;
  constexpr int U = words_in_flight<VEC, RW, BMAX>();
  if constexpr (VEC) {
    // the lane's words are lane + 32k; each row is walked by one pointer, so
    // a load's address is that pointer plus a constant
    const int n_words = static_cast<int>((xp1 - xp0) / V);
    const uint4* p[RW];  // (an absent row's pointer is never read)
#pragma unroll
    for (int j = 0; j < RW; ++j)
      p[j] = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(rows[J0 + j]) +
                                            xp0 * sizeof(T)) + lane;
    for (int w0 = lane; w0 < n_words; w0 += U * 32) {
      uint4 raw[U][RW];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          if (valid[J0 + j] && w0 + u * 32 < n_words) raw[u][j] = load_stream(p[j] + u * 32);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (w0 + u * 32 < n_words) {
          float w[RW][V];
#pragma unroll
          for (int j = 0; j < RW; ++j) {
            if (valid[J0 + j]) W::unpack(raw[u][j], w[j]);
          }
          fma_words<RW, J0, RPW, BMAX, V>(acc, w, valid, xs + (w0 + u * 32) * V, stride, b);
        }
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) p[j] += U * 32;
    }
  } else {
    for (int64_t c0 = xp0 + lane; c0 < xp1; c0 += U * 32) {
      float w[U][RW][1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t c = c0 + u * 32;
#pragma unroll
        for (int j = 0; j < RW; ++j)
          w[u][j][0] = valid[J0 + j] && c < xp1 ? W::load(rows[J0 + j] + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t c = c0 + u * 32;
        if (c < xp1) fma_words<RW, J0, RPW, BMAX, 1>(acc, w[u], valid, xs + (c - xp0), stride, b);
      }
    }
  }
  if constexpr (J0 + RW < RPW)
    stream_rows<T, VEC, RW, J0 + RW, RPW, BMAX>(acc, rows, valid, xs, xp0, xp1, stride, b, lane);
}

template <class Task, int BMAX, int RPW, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) thin_rows_kernel(const Task task, const Geometry geo) {
  using T = typename Task::Elem;
  constexpr int RW = kRowsPerWarp < RPW ? kRowsPerWarp : RPW;
  static_assert(RPW % RW == 0, "a warp's rows go RW at a time");

  extern __shared__ __align__(128) unsigned char thin_smem[];
  float* xs = reinterpret_cast<float*>(thin_smem);
  float* epi = reinterpret_cast<float*>(thin_smem + geo.epi_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Units units = block_units(geo, blockIdx.x, gridDim.x);
  const bool resident = geo.x_panel >= geo.m;
  const int groups = n_groups<Task>(units, geo.group_rows);
  if constexpr (VEC) {
    // the first group's first words start for the L2 while x is staged
    const Group g0 = group<Task>(units, 0, geo.group_rows);
    constexpr int64_t kBytes = 16 * 32 * words_in_flight<true, RW, BMAX>();
    const int i = warp * RPW + lane;
    const T* row = lane < RPW && i < g0.slots ? task.row(g0, i, geo.m) : nullptr;
    if (row != nullptr)
      prefetch_l2(row, static_cast<uint32_t>(min64(kBytes, min64(geo.m, geo.x_panel) * sizeof(T))));
  }
  task.prologue(epi, tid, kThreads);
  if (resident) stage_x(xs, task.x, 0, static_cast<int>(geo.m), geo.b, geo.x_stride, tid, kThreads);
  __syncthreads();

  float acc[RPW][BMAX];
  Group g{};
  for (int k = 0; k < groups; ++k) {
    g = group<Task>(units, k, geo.group_rows);
    const T* rows[RPW];
    bool valid[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int i = warp * RPW + j;
      rows[j] = i < g.slots ? task.row(g, i, geo.m) : nullptr;
      valid[j] = rows[j] != nullptr;
#pragma unroll
      for (int q = 0; q < BMAX; ++q) acc[j][q] = 0.f;
    }

    for (int64_t xp0 = 0; xp0 < geo.m; xp0 += geo.x_panel) {
      const int64_t xp1 = min64(geo.m, xp0 + geo.x_panel);
      if (!resident) {
        __syncthreads();  // the previous panel is consumed
        stage_x(xs, task.x, xp0, static_cast<int>(xp1 - xp0), geo.b, geo.x_stride, tid, kThreads);
        __syncthreads();
      }
      stream_rows<T, VEC, RW, 0, RPW, BMAX>(acc, rows, valid, xs, xp0, xp1, geo.x_stride, geo.b,
                                            lane);
    }

    task.before_rows(k, epi);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      if (valid[j]) {
#pragma unroll
        for (int q = 0; q < BMAX; ++q) {
          if (q < geo.b) {
            float v = acc[j][q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == q) task.finish_row(g, k, warp * RPW + j, q, v, epi);
          }
        }
      }
    }
    task.after_rows(g, k, epi, warp, lane);
  }
  task.finish_block(g, groups - 1, epi, warp, lane);
}

// The instantiation for (b, vec): BMAX is b rounded up to a power of two.
// BMAX 16 exists only in a copy built with a kMaxB above 8 (chip_smoke.py
// --sweep-wide times such a copy against the wide engine).
static_assert(kMaxB >= 1 && kMaxB <= 16, "1 to 16 columns");
template <class Task, int RPW, bool VEC>
KernelFn<Task> pick_b(int b) {
  if (b <= 1) return &thin_rows_kernel<Task, 1, RPW, VEC>;
  if (b <= 2) return &thin_rows_kernel<Task, 2, RPW, VEC>;
  if (b <= 4) return &thin_rows_kernel<Task, 4, RPW, VEC>;
  if constexpr (kMaxB > 8) {
    if (b > 8) return &thin_rows_kernel<Task, 16, RPW, VEC>;
  }
  return &thin_rows_kernel<Task, 8, RPW, VEC>;
}
template <class Task, int RPW>
KernelFn<Task> pick(int b, bool vec) {
  return vec ? pick_b<Task, RPW, true>(b) : pick_b<Task, RPW, false>(b);
}

}  // namespace thin_rows
