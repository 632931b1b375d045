// Forward flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface, loaded with ctypes by repro_torch/kernels/flash_attention/ops.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (flash_attention_bhsd, body _flash_kernel): attention
// with an online softmax over KV tiles, causal or not, sliding window,
// q_offset, GQA by index h / (H / KV), scale hd**-0.5, NEG_INF = -2**30
// (finite), output divided by max(l, 1e-37) and stored in q's dtype.
//
// What bounds it on the H100: operations. At the serving shapes (B 4, S
// 1024, H 4, KV 1, hd 256, bf16) each visible (q, k) pair costs 4*hd flops
// against a few bytes of traffic, far above the card's ~295 flop/byte ridge,
// so the least time is the flops at the tensor cores' 989 TFLOP/s (bf16).
// Only wgmma reaches that rate, so the bf16 route is built around it.
//
// Two routes, chosen by the wrapper from (dtype, head_dim), never on failure:
//
// * wgmma (bf16, hd 64 / 128 / 224 / 256): fa_forward_wgmma.
//   - A CTA owns BQ = 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each (one wgmma M) and one producer warpgroup.
//     The grid is (B*H, q tiles) with the q tile index reversed, so the
//     heaviest causal tiles start first and the light ones fill in behind.
//   - The producer's one thread issues TMA loads: Q once, then K and V
//     tiles of BK = 64 keys into a ring of STAGES buffers (2 at hd 256, 4
//     below), each completed on a "full" mbarrier and handed back on an
//     "empty" one. setmaxnreg moves registers from the producer (24) to the
//     consumers (240): at hd 256 the O accumulator alone is 128 f32
//     registers a thread, the scores 32 more and P's fragments 16; ptxas
//     -v reports no spills.
//   - Tensor maps are 4-D (hd, heads, seq, batch) over the model layout
//     (B, S, H, hd) through its strides: no transpose in the wrapper. The
//     128-byte swizzle caps a box at 64 bf16 columns, so a row of hd values
//     is hd/64 slabs of (rows x 128 B); the wgmma descriptors walk across
//     them (K-major: +32 B a k16 step inside a slab, then the next slab;
//     MN-major V: the slab stride is the descriptor's leading byte offset).
//   - S = Q K^T is wgmma m64n64k16 with Q and K from shared memory, both
//     K-major as stored. O += P V is wgmma m64n{hd}k16 with P from
//     registers: the f32 score accumulator is rescaled, exponentiated and
//     packed to bf16 A fragments in place (its layout is the A layout), and
//     never touches shared memory; V (keys x hd, hd contiguous) is the
//     MN-major B operand through wgmma's transpose bit. f32 accumulation.
//   - Online softmax in the log2 domain (log2(e) folded into the scale):
//     running max and sum in f32 per row, the correction applied to the O
//     registers; the sum stays per thread until one quad reduction at the
//     end.
//   - Loop bounds come from the causal and window limits, so tiles outside
//     them are never loaded; each warpgroup skips the compute of tiles
//     outside its own rows' limits. Element masks run only on tiles that
//     cross the diagonal, the window edge or the ragged Sk tail. TMA fills
//     rows past Sk with zeros, and a zero score is not a masked one, so
//     k_pos < Sk is masked explicitly there.
//   - hd 224 (zamba2-7b's shared block) runs on the hd-256 instantiation.
//     Its tensor maps carry the tensor's real inner dimension, 224 (448-byte
//     rows), so the fourth slab's box (columns 192-255) is filled with
//     zeros past column 224 by TMA (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE). Q K^T
//     over 256 columns then equals Q K^T over 224, PV's columns past 224
//     are zero, and the epilogue stores only columns < hd. The scale is the
//     real hd's. A native HD = 224 would truncate SLABS = HD / 64 to 3 (32
//     columns dropped) and wgmma_pv has no n = 224 form: both would compile
//     to a kernel that is wrong without failing.
//
// * simt (float32 at any supported hd, bf16 at hd 16 / 32): fa_forward_simt,
//   the first, CUDA-core kernel. f32 stays off the tensor cores on purpose:
//   TF32 would not hold the 1e-4 the float32 path is held to.
//   - One block per (q tile of 32 rows, head, batch); Q, K and V tiles
//     converted to f32 in padded shared memory; 8 adjacent lanes own one
//     query row and reduce with shuffles; f32 FMAs on the CUDA cores.
//
// Status: see PERF.md for both routes' times on the H100 and the card they
// were measured on.

#include <cuda.h>          // CUtensorMap and the driver's enums; no -lcuda:
                           // the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2**30: finite on purpose

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

namespace simt {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // key rows per KV tile
constexpr int NT = 256;         // threads per block
constexpr int TPR = NT / BQ;    // threads per query row (8, adjacent lanes)
constexpr int CPT = BK / TPR;   // score columns per thread (4)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;                 // padded row, floats
  static constexpr int DPT = HD / TPR;              // output cols a thread
  static constexpr int VEC = (DPT % 4 == 0) ? 4 : 1;  // float4 P.V walks
  static constexpr int GROUPS = DPT / VEC;
  static constexpr size_t smem_floats =
      size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * (BK + 1);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
    int KV, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal, int window,
    int q_offset, float scale) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // BQ x LD
  float* sK = sQ + BQ * LD;      // BK x LD
  float* sV = sK + BK * LD;      // BK x LD
  float* sP = sV + BK * LD;      // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = tid / TPR;     // local query row owned by this thread
  const int sub = tid % TPR;     // its slot among the row's 8 lanes

  const int q0 = blockIdx.x * BQ;
  const int q_lo = q0 + q_offset;                     // absolute positions
  const int q_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int qpos = q_lo + row;

  const T* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sQ[r * LD + d] = qi < Sq ? to_f32(qb[int64_t(qi) * q_ss + d]) : 0.f;
  }

  // KV range any row of this tile can see; tiles outside are never loaded
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (window > 0) k_begin = max(0, q_lo - window + 1);

  float m = NEG_INF, l = 0.f;
  float acc[L::DPT];
#pragma unroll
  for (int j = 0; j < L::DPT; ++j) acc[j] = 0.f;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();  // previous tile consumed; Q stored on the first pass
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int kj = t0 + r;
      const bool ok = kj < Sk;
      sK[r * LD + d] = ok ? to_f32(kb[int64_t(kj) * k_ss + d]) : 0.f;
      sV[r * LD + d] = ok ? to_f32(vb[int64_t(kj) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores for columns c = sub + TPR * j of this thread's row
    float s[CPT];
    float tmax = NEG_INF;
    const float4* q4 = reinterpret_cast<const float4*>(sQ + row * LD);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + TPR * j;
      const float4* k4 = reinterpret_cast<const float4*>(sK + c * LD);
      float dot = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 a = q4[d4], kk = k4[d4];
        dot = fmaf(a.x, kk.x, dot);
        dot = fmaf(a.y, kk.y, dot);
        dot = fmaf(a.z, kk.z, dot);
        dot = fmaf(a.w, kk.w, dot);
      }
      dot *= scale;
      const int kpos = t0 + c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos < window);
      s[j] = ok ? dot : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    // the row's 8 lanes are adjacent: xor offsets < 8 stay inside the row
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      sP[row * (BK + 1) + sub + TPR * j] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's P is written by lanes of this warp only

#pragma unroll
    for (int j = 0; j < L::DPT; ++j) acc[j] *= corr;
    const float* pr = sP + row * (BK + 1);
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = sV + c * LD;
      if constexpr (L::VEC == 4) {
#pragma unroll
        for (int g = 0; g < L::GROUPS; ++g) {
          const float4 vv =
              reinterpret_cast<const float4*>(vr)[sub + TPR * g];
          acc[4 * g + 0] = fmaf(p, vv.x, acc[4 * g + 0]);
          acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < L::GROUPS; ++g)
          acc[g] = fmaf(p, vr[sub + TPR * g], acc[g]);
      }
    }
  }

  if (q0 + row < Sq) {
    const float denom = fmaxf(l, 1e-37f);
    T* ob = o + b * o_sb + int64_t(q0 + row) * o_ss + h * o_sh;
#pragma unroll
    for (int g = 0; g < L::GROUPS; ++g)
#pragma unroll
      for (int e = 0; e < L::VEC; ++e)
        ob[(sub + TPR * g) * L::VEC + e] =
            from_f32<T>(acc[g * L::VEC + e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, const int64_t* st,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<HD>::smem_floats * sizeof(float);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Sk, int H, int KV,
                        const int64_t* st, int causal, int window,
                        int q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, st, causal, window,
                           q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, st, causal, window,
                           q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, st, causal, window,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, st, causal,
                            window, q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, st, causal,
                            window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace simt


namespace wg {

constexpr int BM = 64;            // query rows per consumer warpgroup (wgmma M)
constexpr int NC = 2;             // consumer warpgroups
constexpr int BQ = BM * NC;       // query rows per CTA
constexpr int BK = 64;            // keys per KV tile (wgmma N of Q K^T)
constexpr int NT = 128 * (NC + 1);  // consumers first, then the producer
constexpr int SLAB_COLS = 64;     // bf16 columns in one 128-byte swizzle row
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128*24 + 256*240 <= 65,536

template <int HD>
struct Cfg {
  static constexpr int SLABS = HD / SLAB_COLS;
  static constexpr int Q_SLAB = BM * 128;          // bytes of one Q slab
  static constexpr int KV_SLAB = BK * 128;         // bytes of one K/V slab
  static constexpr int Q_BYTES = BM * HD * 2;      // one warpgroup's Q
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int STAGES = HD == 256 ? 2 : 4;  // 197,672 B at hd 256
  static constexpr int K_OFF = NC * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + barriers, + slack to align the base to 1024 B (the swizzle atom)
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. (No watchdog: a
// trap here becomes one block that ptxas shares between the producer and
// the consumers, and that alone held the consumers near 170 registers, so
// the hd-256 accumulators spilled and every wgmma was serialised.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 (SW128) at bit 62.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64x64, f32) += A(64x16) * B(16x64); A and B from shared memory,
// both K-major (tnspA = tnspB = 0).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                        uint64_t desc_a, uint64_t desc_b,
                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x64, f32) += A(64x16, bf16 registers) * B(16x64); B from shared
// memory, MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D(64x128, f32) += A(64x16, bf16 registers) * B(16x128); B from shared
// memory, MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D(64x256, f32) += A(64x16, bf16 registers) * B(16x256); B from shared
// memory, MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                        const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114,"
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      "%125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 64) wgmma_rs_m64n64k16(o, a, desc_b);
  if constexpr (HD == 128) wgmma_rs_m64n128k16(o, a, desc_b);
  if constexpr (HD == 256) wgmma_rs_m64n256k16(o, a, desc_b);
}

struct Shape {
  int Sq, Sk, H, KV, causal, window, q_offset;
  int hd;  // the tensors' head_dim: HD, or 224 on the HD = 256 tile
};

// One consumer warpgroup: 64 query rows, every KV tile of the CTA's range.
// Accumulator layout (wgmma m64nN, f32): thread `lane` of warp `w` holds
// rows r = 16w + lane/4 and r + 8; for each 8-column chunk i, d[4i + 0, 1]
// are (r, 8i + 2(lane%4) + {0, 1}) and d[4i + 2, 3] the same columns of r+8.
template <int HD>
__device__ __forceinline__ void consume(
    const Shape& sh, int wgi, int b, int h, int q0, int t_begin, int t_end,
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_q, uint32_t bar_full,
    uint32_t bar_empty, __nv_bfloat16* __restrict__ o, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, float scale_log2) {
  using C = Cfg<HD>;
  const int ctid = threadIdx.x - wgi * 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int row0 = q0 + wgi * BM;           // first query row of this group
  const int r_in = warp * 16 + lane / 4;    // this thread's rows: r_in, +8
  const int pos_lo = row0 + sh.q_offset;
  const int pos_hi = min(row0 + BM, sh.Sq) - 1 + sh.q_offset;
  const int qpos0 = pos_lo + r_in;
  const bool any_rows = row0 < sh.Sq;
  int k_begin = 0, k_end = sh.Sk;           // this group's visible keys
  if (sh.causal) k_end = min(k_end, pos_hi + 1);
  if (sh.window > 0) k_begin = max(0, pos_lo - sh.window + 1);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const uint32_t q_base = sQ + wgi * C::Q_BYTES;
  mbar_wait(bar_q, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t full = bar_full + 8 * stage;
    mbar_wait(full, phase);
    const int t0 = t * BK;
    if (any_rows && t0 < k_end && t0 + BK > k_begin) {
      const uint32_t k_tile = sK + stage * C::KV_BYTES;
      const uint32_t v_tile = sV + stage * C::KV_BYTES;

      // S = Q K^T over hd in k16 steps: 4 inside each 128-byte slab (+32 B
      // each), then the next slab. A step adds its byte offset / 16 to the
      // descriptor's start-address field.
      const uint64_t dq = sw128_desc(q_base, 16, 1024);
      const uint64_t dk = sw128_desc(k_tile, 16, 1024);
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss_m64n64k16(s, dq + (((kk / 4) * C::Q_SLAB + off) >> 4),
                           dk + (((kk / 4) * C::KV_SLAB + off) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks (only on tiles that cross a limit), scale, row max
      const bool edge = (t0 + BK > sh.Sk) ||
                        (sh.causal && t0 + BK - 1 > pos_lo) ||
                        (sh.window > 0 && pos_hi - t0 >= sh.window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e] * scale_log2;
          if (edge) {
            const int kpos = t0 + 8 * i + 2 * (lane % 4) + (e & 1);
            const int qpos = qpos0 + 8 * (e >> 1);
            bool ok = kpos < sh.Sk;
            if (sh.causal) ok = ok && qpos >= kpos;
            if (sh.window > 0) ok = ok && (qpos - kpos < sh.window);
            x = ok ? x : NEG_INF;
          }
          s[4 * i + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
      // a row's BK scores are spread over the 4 lanes of one quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i + 0] = exp2f(s[4 * i + 0] - n0);
        s[4 * i + 1] = exp2f(s[4 * i + 1] - n0);
        s[4 * i + 2] = exp2f(s[4 * i + 2] - n1);
        s[4 * i + 3] = exp2f(s[4 * i + 3] - n1);
        ps0 += s[4 * i + 0] + s[4 * i + 1];
        ps1 += s[4 * i + 2] + s[4 * i + 3];
      }
      l0 = l0 * c0 + ps0;                   // per-thread partial sums
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 0] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // P as bf16 A fragments: keys 16kk..16kk+15 are chunks 2kk, 2kk+1
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V is MN-major (hd contiguous); 16 keys = two 8-row groups
      // (stride 1024 B), hd crosses the slabs (stride KV_SLAB)
      const uint64_t dv = sw128_desc(v_tile, C::KV_SLAB, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(acc, pa[kk], dv + ((kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * stage);
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
  const int qr0 = row0 + r_in, qr1 = qr0 + 8;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const bool col = 8 * j < sh.hd;  // none past the real head_dim (hd 224)
    if (col && qr0 < sh.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + qr0 * o_ss + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
    if (col && qr1 < sh.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + qr1 * o_ss + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    Shape sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;
  const int kvh = h / (sh.H / sh.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first

  // the CTA's KV tiles: the union of its two groups' causal/window limits
  const int pos_lo = q0 + sh.q_offset;
  const int pos_hi = min(q0 + BQ, sh.Sq) - 1 + sh.q_offset;
  int k_begin = 0, k_end = sh.Sk;
  if (sh.causal) k_end = min(k_end, pos_hi + 1);
  if (sh.window > 0) k_begin = max(0, pos_lo - sh.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == NC) {
    // producer: one thread keeps the ring full; the rest of the group exits
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(bar_q, NC * C::Q_BYTES);
      for (int w = 0; w < NC; ++w)
        for (int j = 0; j < C::SLABS; ++j)
          tma_load_4d(sQ + w * C::Q_BYTES + j * C::Q_SLAB, &tm_q, bar_q,
                      j * SLAB_COLS, h, q0 + w * BM, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int j = 0; j < C::SLABS; ++j) {
          tma_load_4d(sK + stage * C::KV_BYTES + j * C::KV_SLAB, &tm_k, full,
                      j * SLAB_COLS, kvh, t * BK, b);
          tma_load_4d(sV + stage * C::KV_BYTES + j * C::KV_SLAB, &tm_v, full,
                      j * SLAB_COLS, kvh, t * BK, b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<HD>(sh, wgi, b, h, q0, t_begin, t_end, sQ, sK, sV, bar_q,
                bar_full, bar_empty, o, o_sb, o_ss, o_sh, scale_log2);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Errors of this route that are not a cudaError_t: 1000 + CUresult of the
// tensor-map encoder, or ERR_NO_ENCODER.
constexpr int ERR_TMAP = 1000;
constexpr int ERR_NO_ENCODER = 999;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (hd, heads, seq, batch) over a (B, S, heads, hd) bf16 tensor
// read through its strides (elements); box 64 columns x 1 head x 64 rows.
int make_map(CUtensorMap* m, const void* ptr, int hd, int heads, int seq,
             int batch, int64_t s_b, int64_t s_s, int64_t s_h) {
  static_assert(BK == BM, "one box shape serves Q, K and V");
  EncodeTiled enc = encoder();
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 2, cuuint64_t(s_s) * 2,
                                 cuuint64_t(s_b) * 2};
  const cuuint32_t box[4] = {SLAB_COLS, 1, BK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP + int(r);
}

// Q, K and V as strided tensors: base pointers and (batch, seq, head)
// strides in elements.
struct Operand {
  const void* ptr;
  int64_t sb, ss, sh;
};

// The maps take the tensors' real head_dim sh.hd (<= HD): TMA zero-fills
// the tile's columns past it.
template <int HD>
int launch(const Operand& q, const Operand& k, const Operand& v, void* o,
           int B, const Shape& sh, const int64_t* so, float scale,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q.ptr, sh.hd, sh.H, sh.Sq, B, q.sb, q.ss, q.sh);
  if (!e) e = make_map(&mk, k.ptr, sh.hd, sh.KV, sh.Sk, B, k.sb, k.ss, k.sh);
  if (!e) e = make_map(&mv, v.ptr, sh.hd, sh.KV, sh.Sk, B, v.sb, v.ss, v.sh);
  if (e) return e;
  auto kern = flash_wgmma_kernel<HD>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * sh.H, (sh.Sq + BQ - 1) / BQ);
  kern<<<grid, NT, Cfg<HD>::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sh, so[0], so[1], so[2],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. Strides (in
// elements) for q, k, v and o, each as (batch, seq, head); the head_dim
// stride must be 1. Returns the cudaError_t of the launch (0 = launched);
// nothing is synchronised.
int fa_forward_simt(int dtype, int hd, const void* q, const void* k,
                    const void* v, void* o, int B, int Sq, int Sk, int H,
                    int KV, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                    int64_t o_sh, int causal, int window, int q_offset,
                    float scale, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, st,
                                    causal, window, q_offset, scale, s);
  if (dtype == 1)
    return simt::dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV,
                                            st, causal, window, q_offset,
                                            scale, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route: bf16 only, hd 64, 128, 224 or 256 (224 on the
// 256 tile), Sq and Sk >= 1. The
// wrapper has checked what TMA needs: 16-byte aligned bases, strides in
// 16-byte multiples, head_dim contiguous. Same arguments as the simt route
// without the dtype; returns 0, a cudaError_t, or an ERR_* code above.
int fa_forward_wgmma(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int Sq, int Sk, int H, int KV,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     int causal, int window, int q_offset, float scale,
                     void* stream) {
  if (hd != 64 && hd != 128 && hd != 224 && hd != 256)
    return cudaErrorInvalidValue;
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const wg::Operand oq{q, q_sb, q_ss, q_sh}, ok{k, k_sb, k_ss, k_sh},
      ov{v, v_sb, v_ss, v_sh};
  const wg::Shape sh{Sq, Sk, H, KV, causal, window, q_offset, hd};
  const int64_t so[3] = {o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return wg::launch<64>(oq, ok, ov, o, B, sh, so, scale, s);
    case 128:
      return wg::launch<128>(oq, ok, ov, o, B, sh, so, scale, s);
    default:
      return wg::launch<256>(oq, ok, ov, o, B, sh, so, scale, s);
  }
}

const char* fa_error_string(int err) {
  static char buf[96];
  if (err == wg::ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= wg::ERR_TMAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - wg::ERR_TMAP);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
