// Fused coded block matmul + erasure decode for the BPCC coded LM head.
//
// Replaces the Pallas TPU kernel repro/kernels/coded_decode.py ::
// coded_matvec_decode_pallas (def :65, pallas_call :91):  y = R .
// blocked(W_c x), where W_c [nb*br, M] holds nb coded row blocks of br rows
// each, x is [M, B] and R [n_data, nb] is the mask-keyed recovery matrix.
// Output [n_data*br, B].
//
// What bounds it on an H100: reading W_c once.  The head is a thin product
// (B = 1 at prefill, B = n_slots at decode), about 2B flops per 4-byte
// weight, so the least time is bytes(W_c) / 3.35 TB/s (glm4-9b: [173216,
// 4096] fp32, 2.84 GB, 0.848 ms).  Everything else (x, R, the decoded
// output) is noise.
//
// Design.  The TPU kernel walks a sequential grid of column panels with a
// VMEM-resident accumulator.  Here the unit of work is a row tile: BT = 32 /
// nb rows in EVERY one of the nb code blocks (nb*BT <= 32 coded rows), so
// the decode of those rows needs nothing from another block.  The coded
// rows stream through thin_rows.cuh: a persistent grid whose blocks take
// equal, interleaved shares of the tiles (glm4-9b: 5413 tiles on 132 SMs),
// x staged once a block (it used to be restaged by each of 5413 blocks),
// W_c read by a register stream, each coded row summed by one warp in a
// fixed order.  The epilogue puts a tile's [nb, BT, B] coded sums in shared
// memory and contracts them with R there, a tile late and behind mbarriers
// instead of a block barrier: only the decoded [n_data, BT, B] tile is
// written to device memory.  R's columns for erased blocks are exactly
// zero, so a straggler's block cannot leak.  fp32 FMA throughout (no
// TF32).  On an H100 80GB HBM3 at 700 W, through the wrapper as the path
// calls it, the glm4-9b head takes 0.926 ms at B = 1 and 0.938 at B = 4
// (91 and 90 % of the bound; torch.matmul(W_c, x) alone 0.933 and 2.187),
// the mamba2-130m head 0.0619 / 0.0733 and the zamba2-1.2b head 0.1031 at
// B = 1; through the bare C entry in turns with the wrapper, 0.922, 0.938,
// 0.0612, 0.0718 and 0.1013 (chip_smoke.py --sweep-head, kernel rows; on
// another card of the same kind the W_c read took 0.897 ms).  The first
// port took 0.978 ms at glm4-9b B = 4 and 0.0726 at mamba2 B = 4.
//
// x of WIDE_MIN_B (8) columns and more goes to the second entry,
// coded_matvec_decode_wide, on the wide engine (wide_rows.cuh): a tile is
// 128 / nb rows of each code block on the tensor cores, W_c read once a
// tile of up to 256 columns of x, the decode per tile in shared memory.
// It takes 1.1736 ms at the glm4-9b head at B = 64 and 0.1694 at the
// mamba2-130m head at 128 (torch.matmul(W_c, x) 2.3183 and 0.2839;
// chip_smoke.py kernel rows, H100 80GB HBM3, 700 W).
#include "thin_rows.cuh"
#include "wide_rows.cuh"

namespace {

using thin_rows::Group;

constexpr int kMaxBlocks = thin_rows::kMaxGroupRows;  // nb * BT <= 32
constexpr int kTileRowsPerWarp = thin_rows::kMaxGroupRows / thin_rows::kWarps;

// The unit is a row tile; a group is one tile: coded row i is row
// tile*bt + i % bt of block i / bt.  Epilogue scratch: the mbarriers
// done[2] and used[2], then ys [2][nb*bt][b] (two tiles' coded sums), then
// rs [n_data][nb] = R.
//
// No block-wide barrier between tiles: a warp writes its sums of tile k to
// ys[k % 2] and arrives on done[k % 2]; then it waits for done of tile k - 1
// (every warp's sums; a warp is rarely a tile behind) and writes its share
// of tile k - 1's decoded outputs, and arrives on used[(k - 1) % 2].  Before
// writing tile k's sums it waits for used of tile k - 2.
struct DecodeTask {
  using Elem = float;
  const float* w;
  const float* x;
  const float* rec;
  float* out;
  int64_t br;
  int b, nb, n_data, bt;

  static constexpr bool kUnitIsGroup = true;
  __device__ const float* row(const Group& g, int i, int64_t m) const {
    const int64_t r = g.first * bt + i % bt;
    return r < br ? w + (static_cast<int64_t>(i / bt) * br + r) * m : nullptr;
  }

  __device__ uint64_t* done(float* epi) const { return reinterpret_cast<uint64_t*>(epi); }
  __device__ uint64_t* used(float* epi) const { return done(epi) + 2; }
  __device__ float* ys(float* epi, int k) const { return epi + 8 + (k & 1) * nb * bt * b; }
  __device__ float* rs(float* epi) const { return epi + 8 + 2 * nb * bt * b; }

  __device__ void prologue(float* epi, int tid, int n) const {
    if (tid == 0) {
      for (int s = 0; s < 2; ++s) {
        thin_rows::mbar_init(&done(epi)[s], thin_rows::kWarps);
        thin_rows::mbar_init(&used(epi)[s], thin_rows::kWarps);
      }
      thin_rows::mbar_fence_init();
    }
    for (int i = tid; i < n_data * nb; i += n) rs(epi)[i] = rec[i];
  }
  __device__ void before_rows(int k, float* epi) const {
    if (k >= 2) thin_rows::mbar_wait(&used(epi)[k & 1], ((k - 2) >> 1) & 1);
  }
  __device__ void finish_row(const Group&, int k, int i, int q, float v, float* epi) const {
    ys(epi, k)[i * b + q] = v;
  }
  // y[d, tile*bt + t, q] = sum_j R[d, j] * ys[j*bt + t][q]: this warp's
  // share of tile k's outputs, once every warp's sums are in.  Eight lanes
  // share an output (lane p sums j = p, p + 8, ..., then a fixed butterfly),
  // so no warp holds up the next tile on a chain of nb FMAs.
  __device__ void decode(int64_t tile, int k, float* epi, int warp, int lane) const {
    constexpr int kParts = 8;
    constexpr int kSlots = thin_rows::kWarps * 32 / kParts;  // outputs a pass
    thin_rows::mbar_wait(&done(epi)[k & 1], (k >> 1) & 1);
    const float* y = ys(epi, k);
    const float* r = rs(epi);
    const int per_d = bt * b;
    const int n_out = n_data * per_d;
    const int part = lane % kParts;
    for (int base = 0; base < n_out; base += kSlots) {
      const int idx = base + (warp * 32 + lane) / kParts;
      const int d = idx / per_d;
      const int rem = idx - d * per_d;
      const int t = rem / b, q = rem - t * b;
      const int64_t row = tile * bt + t;
      const bool live = idx < n_out && row < br;
      float s = 0.f;
      if (live)
        for (int j = part; j < nb; j += kParts) s = fmaf(r[d * nb + j], y[(j * bt + t) * b + q], s);
#pragma unroll
      for (int off = kParts / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (live && part == 0) out[(static_cast<int64_t>(d) * br + row) * b + q] = s;
    }
  }
  __device__ void after_rows(const Group& g, int k, float* epi, int warp, int lane) const {
    __syncwarp();
    if (lane == 0) thin_rows::mbar_arrive(&done(epi)[k & 1]);
    if (k >= 1) {
      decode(g.first - g.stride, k - 1, epi, warp, lane);
      __syncwarp();
      if (lane == 0) thin_rows::mbar_arrive(&used(epi)[(k - 1) & 1]);
    }
  }
  __device__ void finish_block(const Group& g, int k, float* epi, int warp, int lane) const {
    decode(g.first, k, epi, warp, lane);
  }
};

bool vec_ok(const float* w, long long m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

int epi_bytes(int b, int nb, int n_data) {
  return 32 + 4 * (2 * nb * (kMaxBlocks / nb) * b + n_data * nb);
}

thin_rows::KernelFn<DecodeTask> pick(int b, bool vec) {
  return thin_rows::pick<DecodeTask, kTileRowsPerWarp>(b, vec);
}

// ---- the wide engine (wide_rows.cuh): x of WIDE_MIN_B columns and more
//
// A row tile is bt = 128 / nb rows of every code block: tile row j * bt + i
// is row rt * bt + i of block j.  Epilogue scratch: ys [128][kEpiPitch], a
// tile's coded sums for 32 columns at a time, and R transposed and padded.
struct WideDecodeTask {
  using Elem = float;
  const float* w;
  const float* rec;
  float* out;
  int64_t br;
  int b, nb, n_data;

  // R transposed, [nb][kDs * ceil(n_data / kDs)], zero-padded: a thread
  // reads kDs decoded rows' coefficients of a block in one float4 pair
  __device__ void prologue(unsigned char* smem, const wide_rows::Geometry& g, int tid,
                           int n) const {
    float* rt = reinterpret_cast<float*>(smem + g.rec_off);
    const int pitch = d_pitch();
    for (int i = tid; i < nb * pitch; i += n) {
      const int j = i / pitch, d = i - j * pitch;
      rt[i] = d < n_data ? rec[d * nb + j] : 0.f;
    }
  }
  static constexpr int kDs = 8;   // decoded rows a thread sums at once
  __device__ int d_pitch() const { return (n_data + kDs - 1) / kDs * kDs; }
  __device__ void tma_w(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int rt, int kt,
                        const wide_rows::Geometry& g, uint64_t policy) const {
    wide_rows::tma_3d(dst, map, bar, kt * g.bk, rt * g.bt, 0, policy);
  }
  // tile row rr = j * bt + i is row rt * bt + i of block j; none past nb * bt
  // or W_c's block edge
  __device__ const float* w_row(int rr, int rt, const wide_rows::Geometry& g) const {
    if (rr >= g.tile_rows) return nullptr;
    const int j = rr / g.bt, i = rr - j * g.bt;
    const int64_t row = static_cast<int64_t>(rt) * g.bt + i;
    return row < br ? w + (j * br + row) * g.m : nullptr;
  }
  // y[d, rt * bt + i, col] = sum_j R[d, j] * sums[j * bt + i][col], in j
  // order, 32 columns at a time through shared memory; acc[c][4 j + 2 h +
  // e] is tile row row0 + 8 h, column 32 c + 8 j + 2 t + e.  A thread
  // takes an (i, col) and kDs decoded rows at a time, each block's sum read
  // once for them.
  template <int NT>
  __device__ void epilogue(const float (&acc)[NT][16], unsigned char* smem, int rt, int ct,
                           const wide_rows::Geometry& g, int row0, int t, int ctid) const {
    constexpr int kConsumers = 32 * wide_rows::kConsumerWarps;
    constexpr int kQ = wide_rows::kColQuantum;
    float* ys = reinterpret_cast<float*>(smem + g.epi_off);
    const float* rtr = reinterpret_cast<const float*>(smem + g.rec_off);
    const int pitch = d_pitch();
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col0 = ct * g.cols + c * kQ;
      if (col0 >= b) continue;  // the same for every consumer thread
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ys[(row0 + 8 * h) * wide_rows::kEpiPitch + 8 * j + 2 * t + e] =
                acc[c][4 * j + 2 * h + e];
      wide_rows::named_sync(1, kConsumers);
      for (int p = ctid; p < g.bt * kQ; p += kConsumers) {
        const int i = p / kQ, col = p - i * kQ;
        const int64_t row = static_cast<int64_t>(rt) * g.bt + i;
        if (row >= br || col0 + col >= b) continue;
        for (int d0 = 0; d0 < n_data; d0 += kDs) {
          float s[kDs];
#pragma unroll
          for (int u = 0; u < kDs; ++u) s[u] = 0.f;
          for (int j = 0; j < nb; ++j) {
            const float y = ys[(j * g.bt + i) * wide_rows::kEpiPitch + col];
            const float4 r0 = *reinterpret_cast<const float4*>(rtr + j * pitch + d0);
            const float4 r1 = *reinterpret_cast<const float4*>(rtr + j * pitch + d0 + 4);
            s[0] = fmaf(r0.x, y, s[0]); s[1] = fmaf(r0.y, y, s[1]);
            s[2] = fmaf(r0.z, y, s[2]); s[3] = fmaf(r0.w, y, s[3]);
            s[4] = fmaf(r1.x, y, s[4]); s[5] = fmaf(r1.y, y, s[5]);
            s[6] = fmaf(r1.z, y, s[6]); s[7] = fmaf(r1.w, y, s[7]);
          }
#pragma unroll
          for (int u = 0; u < kDs; ++u)
            if (d0 + u < n_data)
              out[(static_cast<int64_t>(d0 + u) * br + row) * b + col0 + col] = s[u];
        }
      }
      wide_rows::named_sync(1, kConsumers);
    }
  }
};

}  // namespace

// Blocks of the (b, vec) variant that fit on one SM with smem_bytes of
// dynamic shared memory, into *blocks.  Returns a cudaError_t.
extern "C" int coded_matvec_decode_occupancy(int b, int vec, int smem_bytes, int* blocks) {
  if (b < 1 || b > thin_rows::kMaxB || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return thin_rows::occupancy(pick(b, vec != 0), smem_bytes, blocks);
}

// w [nb*br, m], x [m, b], rec [n_data, nb], out [n_data*br, b]; all fp32,
// contiguous, on the current device.  The geometry comes from the wrapper
// (kernels/thin_rows.py::head_plan): vec (m % 4 == 0, w 16-byte aligned),
// the persistent grid (at most ceil(br / bt) blocks, bt = 32 / nb),
// group_rows (nb * bt), x_panel and smem_bytes, which must equal
// thin_rows::geometry's.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or geometry the kernel does not take).
extern "C" int coded_matvec_decode(const float* w, const float* x, const float* rec, float* out,
                                   long long br, long long m, int b, int nb, int n_data, int vec,
                                   int grid, int group_rows, int x_panel, int smem_bytes,
                                   void* stream) {
  if (b < 1 || b > thin_rows::kMaxB || nb < 1 || nb > kMaxBlocks || n_data < 1 || n_data > nb ||
      br < 1 || m < 1 || (vec != 0) != vec_ok(w, m))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bt = kMaxBlocks / nb;
  const long long n_tiles = (br + bt - 1) / bt;
  if (grid < 1 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const thin_rows::Geometry geo =
      thin_rows::geometry(m, n_tiles, grid, b, nb * bt, epi_bytes(b, nb, n_data));
  if (group_rows != geo.group_rows || x_panel != geo.x_panel || smem_bytes != geo.smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeTask task{w, x, rec, out, br, b, nb, n_data, bt};
  return thin_rows::launch(pick(b, vec != 0), grid, stream, task, geo);
}

// The wide engine: w [nb*br, m], x [m, b], rec [n_data, nb], out
// [n_data*br, b]; all fp32, contiguous, on the current device; xp the
// scratch of x's pieces (6 * b_pad * m_pad bytes, 16-byte aligned).  The
// geometry comes from the wrapper (kernels/wide_rows.py::wide_plan): the
// persistent grid (at most the plan's items), the tile's columns, the
// stages and smem_bytes, which must equal wide_rows::geometry's.  Launches
// the split of x, then the kernel.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape or geometry the kernel does
// not take, cudaErrorNotSupported if the driver encodes no tensor map).
extern "C" int coded_matvec_decode_wide(const float* w, const float* x, void* xp,
                                        const float* rec, float* out, long long br, long long m,
                                        int b, int nb, int n_data, int grid, int cols, int stages,
                                        int smem_bytes, void* stream) {
  if (b < 1 || nb < 1 || nb > wide_rows::kMaxBlocks || n_data < 1 || n_data > nb || br < 1 ||
      br * nb >= (1LL << 31) || m < 1 || m >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(xp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wide_rows::Geometry g = wide_rows::geometry(br, m, b, 4, nb, n_data);
  if (!wide_rows::same_plan(g, grid, cols, stages, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  g.tma_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && m % 4 == 0;
  CUtensorMap w_map{}, x_map{};
  if (g.tma_w) {  // W_c as [nb, br, m]: a tile is the box [nb][bt][bk]
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(br),
                                static_cast<cuuint64_t>(nb)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(m) * 4,
                                   static_cast<cuuint64_t>(m) * br * 4};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(g.bk), static_cast<cuuint32_t>(g.bt),
                               static_cast<cuuint32_t>(nb)};
    if (!wide_rows::encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorNotSupported);
  }
  if (!wide_rows::encode_x(&x_map, xp, g)) return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = wide_rows::split_x(x, xp, g, s);
  if (err != 0) return err;
  const WideDecodeTask task{w, rec, out, br, b, nb, n_data};
  return wide_rows::launch(grid, s, w_map, x_map, task, g);
}
