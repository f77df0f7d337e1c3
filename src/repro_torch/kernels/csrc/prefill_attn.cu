// Serving prefill attention on an H100: the causal GQA self-attention of a
// prompt of S < 8192 tokens, which also writes the layer's KV cache, for a
// head dimension of 64 or 128 (repro_torch/models/attention.py ::
// attention_prefill; the plain version beside it, _attention_prefill_plain).
// It replaces no Pallas kernel: the reference's attention is plain jnp
// (repro/models/attention.py :: attention_full, _sdpa), which XLA fuses on a
// TPU; the port's eager version of it formed the [S, S] logits in bf16, cast
// them to fp32, masked, took the softmax and cast back, each step a fresh
// S^2-sized tensor, with Q, K and V projected and K roped twice.
//
// Two launches a layer, after the Q/K/V projections (torch GEMMs):
//  * prefill_rope_kernel (the prologue): K rotated in fp32 by the forward's
//    cos/sin table and rounded to bf16, exactly as layers.apply_rope_table
//    does (__fmul_rn / __fsub_rn / __fadd_rn, so nvcc cannot contract the
//    rotation into FMAs and the rows stay bit-identical to torch's), written
//    straight into the cache rows [:S]; V copied into the cache rows and,
//    transposed, into a scratch V^T [B, KVH, Hd, S rounded up to 64] (pad
//    columns zero), the K-major layout the PV product reads.
//  * prefill_attn_kernel: a flash attention over bf16 Q and the cache rows.
//    One block is one warpgroup (128 threads) on 64 query rows of one head;
//    Q is read once, rotated as K was, rounded to bf16 and laid out in
//    shared memory as a K tile.  For each 64-row KV tile up to the diagonal
//    (tiles wholly past it are skipped; the diagonal one is masked; rows of
//    the ragged last tile past S are zero-filled and masked): S = Q K^T by
//    wgmma (m64n64k16, both operands from shared memory), the logits,
//    running max and denominator in fp32 registers, P = exp2 of the scaled
//    logits rounded to bf16 (the reference rounds its probabilities to
//    v.dtype before PV) and P V by wgmma (m64nHdk16, P from registers, V^T
//    from shared memory) into a fresh accumulator that the CUDA cores add
//    to the rescaled O, so no wgmma accumulates onto registers the CUDA
//    cores rewrite.  K and V^T tiles arrive by cp.async into a ring of two
//    128-byte-swizzled stages.  Blocks are issued longest-first (the last
//    query tile, the most KV tiles, first) for balance.  No [S, S] tensor
//    exists: the logits never leave registers.  Q as register A fragments
//    (wgmma's RS form, reused across the KV loop) gave wrong logits on every
//    KV tile after the first at Hd 64 on an H100, right ones at Hd 128: Q
//    stays in shared memory.
//
// Rounding: the logits QK^T stay fp32 from the tensor cores' fp32 sums,
// where the plain version rounds them to bf16 first: more precise, not
// less.  P is rounded unnormalised and the sum of the fp32 p divides O at
// the end, where the plain version rounds the normalised probabilities.
//
// What bounds it: at glm4-9b's shapes (32 heads, 2 KV heads, Hd 128) the
// operations, 4 Hd H S(S+1)/2 (the causal QK^T and PV) at 989 TFLOP/s:
// 8.7 us at S = 1024 against 5.3 us for the bytes of Q, K, V and O once at
// 3.35 TB/s.  K and V of one KV head (0.5 MB at S = 1024) stay in the L2
// across the 16 heads that share them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace prefill {

constexpr int kRows = 64;        // query rows a block, KV rows a tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 2;       // the K / V^T ring
constexpr int kAlign = 1024;     // 128-byte swizzle atoms
constexpr int kRopeThreads = 256;

__host__ __device__ constexpr int smem_bytes(int hd) {
  // Q [64][hd], then the ring's stages of K [64][hd] and V^T [hd][64], bf16
  return kAlign + (1 + 2 * kStages) * kRows * hd * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the threads' own writes to shared memory (cp.async is the generic proxy)
// made visible to the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep a register's value where it is until here: the tensor cores read A
// fragments and write accumulators asynchronously, behind the compiler's back
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// The descriptor of a K-major operand at `addr`: rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c ^ r) & 7) << 4));
}

// d (+)= A B over a 64 x N x 16 step, bf16: A from registers (the m16n8k16
// A layout, a warp's 16 rows), B [N][16] K-major from shared memory through
// `desc`; scale_d = 0 starts d afresh
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// d (+)= A B over a 64 x 64 x 16 step, bf16, both from shared memory: A
// [64][16] and B [64][16] K-major through their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x1 cos - x2 sin and x2 cos + x1 sin, each product and sum rounded on its
// own as torch's eager ops round them
__device__ __forceinline__ float rot1(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}
__device__ __forceinline__ float rot2(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

struct Args {
  const __nv_bfloat16* q;      // [B, S, H, Hd] as projected
  const __nv_bfloat16* k;      // [B, S, KVH, Hd] as projected
  const __nv_bfloat16* v;      // [B, S, KVH, Hd]
  const float* cos;            // [B or 1, S, Hd / 2]
  const float* sin;
  int64_t rope_bstride;        // elements between batches of cos / sin (0: shared)
  __nv_bfloat16* cache_k;      // rows [:S] of the cache: [B, S, KVH, Hd], rows
  __nv_bfloat16* cache_v;      //   KVH * Hd apart, batches cache_bstride apart
  int64_t cache_bstride;
  __nv_bfloat16* vt;           // scratch [B, KVH, Hd, s_pad]
  __nv_bfloat16* out;          // [B, S, H, Hd]
  int b, s, h, kvh, s_pad, n_qt;
  float scale_log2;            // log2(e) / sqrt(Hd)
};

// The prologue: one block a (64-row tile, KV head, batch)
template <int HD>
__global__ void __launch_bounds__(kRopeThreads) prefill_rope_kernel(const Args a) {
  constexpr int kHalf = HD / 2;
  constexpr int kPitch = HD + 8;  // the V tile's row in shared memory, bf16
  __shared__ __align__(16) __nv_bfloat16 tile[kRows][kPitch];
  const int s0 = blockIdx.x * kRows, g = blockIdx.y, b = blockIdx.z;
  const int64_t row_elems = static_cast<int64_t>(a.kvh) * HD;
  const int64_t in0 = (static_cast<int64_t>(b) * a.s) * row_elems + g * HD;
  const int64_t cache0 = b * a.cache_bstride + g * HD;
  const float* cs = a.cos + b * a.rope_bstride;
  const float* sn = a.sin + b * a.rope_bstride;
  for (int i = threadIdx.x; i < kRows * kHalf / 2; i += kRopeThreads) {
    const int r = i / (kHalf / 2), kk = 2 * (i % (kHalf / 2)), pos = s0 + r;
    if (pos >= a.s) continue;
    const int64_t at = in0 + pos * row_elems + kk;
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.k + at));
    const float2 x2 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.k + at + kHalf));
    const float2 c = *reinterpret_cast<const float2*>(cs + static_cast<int64_t>(pos) * kHalf + kk);
    const float2 s = *reinterpret_cast<const float2*>(sn + static_cast<int64_t>(pos) * kHalf + kk);
    const int64_t to = cache0 + pos * row_elems + kk;
    *reinterpret_cast<uint32_t*>(a.cache_k + to) =
        pack_bf16(rot1(x1.x, x2.x, c.x, s.x), rot1(x1.y, x2.y, c.y, s.y));
    *reinterpret_cast<uint32_t*>(a.cache_k + to + kHalf) =
        pack_bf16(rot2(x1.x, x2.x, c.x, s.x), rot2(x1.y, x2.y, c.y, s.y));
  }
  for (int i = threadIdx.x; i < kRows * HD / 8; i += kRopeThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8), pos = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < a.s) {
      val = *reinterpret_cast<const uint4*>(a.v + in0 + pos * row_elems + 8 * c);
      *reinterpret_cast<uint4*>(a.cache_v + cache0 + pos * row_elems + 8 * c) = val;
    }
    *reinterpret_cast<uint4*>(&tile[r][8 * c]) = val;
  }
  __syncthreads();
  __nv_bfloat16* vt = a.vt + (static_cast<int64_t>(b) * a.kvh + g) * HD * a.s_pad + s0;
  for (int i = threadIdx.x; i < HD * kRows / 2; i += kRopeThreads) {
    const int d = i / (kRows / 2), r = 2 * (i % (kRows / 2));
    __nv_bfloat162 pair;
    pair.x = tile[r][d];
    pair.y = tile[r + 1][d];
    *reinterpret_cast<__nv_bfloat162*>(vt + static_cast<int64_t>(d) * a.s_pad + r) = pair;
  }
}

template <int HD>
struct Acc;
template <>
struct Acc<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_n64(d, a, desc, scale_d);
  }
};
template <>
struct Acc<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_n128(d, a, desc, scale_d);
  }
};

// K tile j (rows k0 .. k0 + 63) and V^T tile j into a stage: K as Hd / 64
// chunks [64 rows][128 bytes], V^T as [Hd rows][128 bytes], both swizzled
template <int HD>
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* st, int b, int g,
                                          int k0, int tid) {
  const uint32_t kbase = smem_u32(st), vbase = kbase + kRows * HD * 2;
  const int64_t row_elems = static_cast<int64_t>(a.kvh) * HD;
  const __nv_bfloat16* ck = a.cache_k + b * a.cache_bstride + g * HD;
#pragma unroll
  for (int i = 0; i < kRows * HD / 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / (HD / 8), c = idx % (HD / 8);
    const bool in = k0 + r < a.s;
    const __nv_bfloat16* src = ck + (in ? (k0 + r) * row_elems : 0) + 8 * c;
    cp_async16(kbase + (c >> 3) * (kRows * 128) + swz(r, c & 7), src, in ? 16 : 0);
  }
  const __nv_bfloat16* vt =
      a.vt + (static_cast<int64_t>(b) * a.kvh + g) * HD * a.s_pad + k0;
#pragma unroll
  for (int i = 0; i < HD * kRows / 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int d = idx >> 3, c = idx & 7;
    cp_async16(vbase + swz(d, c), vt + static_cast<int64_t>(d) * a.s_pad + 8 * c, 16);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 128 ? 2 : 3) prefill_attn_kernel(const Args a) {
  constexpr int kSteps = HD / 16;      // k16 steps of QK^T
  constexpr int kO = HD / 2;           // O accumulator registers a thread
  constexpr int kStage = 2 * kRows * HD * 2;
  extern __shared__ unsigned char prefill_smem_raw[];
  const uint32_t raw = smem_u32(prefill_smem_raw);
  unsigned char* smem = prefill_smem_raw + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));

  // longest first: the last query tile's blocks lead
  const int bh = blockIdx.x % (a.b * a.h);
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x / (a.b * a.h));
  const int b = bh / a.h, head = bh % a.h, g = head / (a.h / a.kvh);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);  // and row0 + 8

  const int n_kv = qt + 1;
  unsigned char* ring = smem + kRows * HD * 2;
  load_tile<HD>(a, ring, b, g, 0, tid);
  cp_async_commit();

  // Q rotated and rounded to bf16 into shared memory, laid out as a K tile
  // (the QK^T product's A operand)
  {
    const uint32_t qbase = smem_u32(smem);
    const int64_t q_row = static_cast<int64_t>(a.h) * HD;
    const float* cs = a.cos + b * a.rope_bstride;
    const float* sn = a.sin + b * a.rope_bstride;
    for (int i = tid; i < kRows * HD / 4; i += kThreads) {
      const int r = i / (HD / 4), k = 2 * (i % (HD / 4)), pos = q0 + r;
      float2 x1 = make_float2(0.f, 0.f), x2 = x1, c = x1, sv = x1;
      if (pos < a.s) {
        const __nv_bfloat16* qp = a.q + (static_cast<int64_t>(b) * a.s + pos) * q_row + head * HD;
        x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + k));
        x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + k + HD / 2));
        c = *reinterpret_cast<const float2*>(cs + static_cast<int64_t>(pos) * (HD / 2) + k);
        sv = *reinterpret_cast<const float2*>(sn + static_cast<int64_t>(pos) * (HD / 2) + k);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = k + half * (HD / 2);
        const uint32_t v = half == 0 ? pack_bf16(rot1(x1.x, x2.x, c.x, sv.x), rot1(x1.y, x2.y, c.y, sv.y))
                                     : pack_bf16(rot2(x1.x, x2.x, c.x, sv.x), rot2(x1.y, x2.y, c.y, sv.y));
        const uint32_t at = qbase + (kk >> 6) * (kRows * 128) + swz(r, (kk & 63) >> 3) + (kk & 7) * 2;
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v) : "memory");
      }
    }
  }
  const uint32_t qbase = smem_u32(smem);

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      load_tile<HD>(a, ring + ((j + 1) & 1) * kStage, b, g, (j + 1) * kRows, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    unsigned char* st = ring + (j & 1) * kStage;
    const uint32_t kbase = smem_u32(st), vbase = kbase + kRows * HD * 2;

    // S = Q K^T, fp32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t at = (s >> 2) * (kRows * 128);
      wgmma_ss_n64(sc, desc128(qbase + at) + 2 * (s & 3), desc128(kbase + at) + 2 * (s & 3), s > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(sc[i]);

    // sc[4 jj + 2 hh + e] is row row0 + 8 hh, column 8 jj + 2 t + e
    if (j == qt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
        if (col > row) sc[i] = -INFINITY;
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx * a.scale_log2);
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * jj + 2 * hh + e];
          x = exp2f(fmaf(x, a.scale_log2, -m_new));
          sum += x;
        }
      l[hh] = l[hh] * alpha[hh] + sum;
    }

    // P (bf16) as A fragments of the PV product's four k16 steps
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) keep(pa[ks][r]);
    // PV into a fresh accumulator, added to the rescaled O by the CUDA cores
    float pv[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) pv[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Acc<HD>::mma(pv, pa[ks], desc128(vbase) + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kO; ++i) keep(pv[i]);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
    __syncthreads();  // the stage is free for the load two tiles on
  }

  // o[4 jj + 2 hh + e] is row row0 + 8 hh, column 8 jj + 2 t + e
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / den;
    const int pos = q0 + row0 + 8 * hh;
    if (pos >= a.s) continue;
    __nv_bfloat16* op = a.out + ((static_cast<int64_t>(b) * a.s + pos) * a.h + head) * HD;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(op + 8 * jj + 2 * t) =
          pack_bf16(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 rope_grid(a.s_pad / kRows, a.kvh, a.b);
  prefill_rope_kernel<HD><<<rope_grid, kRopeThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = smem_bytes(HD);
  static bool smem_set = false;  // once a process (the attribute is the function's)
  if (!smem_set) {
    err = cudaFuncSetAttribute(prefill_attn_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const unsigned blocks = static_cast<unsigned>(a.n_qt) * a.b * a.h;
  prefill_attn_kernel<HD><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace prefill

extern "C" {

// The prologue, then the attention: two launches on `stream`.  Shapes as in
// prefill::Args; the wrapper (kernels/prefill_attn.py) checks them.
// Returns the first failing launch's cudaError_t, or 0.
int prefill_attn(const void* q, const void* k, const void* v, const float* cos, const float* sin,
                 long long rope_bstride, void* cache_k, void* cache_v, long long cache_bstride,
                 void* vt, void* out, int b, int s, int h, int kvh, int hd, cudaStream_t stream) {
  using prefill::Args;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.cos = cos;
  a.sin = sin;
  a.rope_bstride = rope_bstride;
  a.cache_k = static_cast<__nv_bfloat16*>(cache_k);
  a.cache_v = static_cast<__nv_bfloat16*>(cache_v);
  a.cache_bstride = cache_bstride;
  a.vt = static_cast<__nv_bfloat16*>(vt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.b = b;
  a.s = s;
  a.h = h;
  a.kvh = kvh;
  a.n_qt = (s + prefill::kRows - 1) / prefill::kRows;
  a.s_pad = a.n_qt * prefill::kRows;
  a.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  if (hd == 64) return prefill::launch<64>(a, stream);
  if (hd == 128) return prefill::launch<128>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
