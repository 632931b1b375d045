// Forward flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// interface, loaded with ctypes by repro_torch/kernels/flash_attention/ops.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (flash_attention_bhsd, body _flash_kernel): attention
// with an online softmax over KV tiles, causal or not, sliding window,
// q_offset, GQA by index h / (H / KV), scale hd**-0.5, NEG_INF = -2**30,
// output divided by max(l, 1e-37) and stored in the inputs' type.
//
// What bounds it on the H100. At the serving shapes (B 4, S 1024, H 4, KV 1,
// hd 256, bf16) attention is compute-heavy: each (q, k) pair costs 4*hd
// flops against a few bytes of traffic, far above the card's ~295 flop/byte
// ridge, so the bound is the tensor-core rate (989 TFLOP/s bf16). This first
// kernel does NOT use the tensor cores: it runs f32 FMAs on the CUDA cores
// out of shared memory, so it is bounded by shared-memory load bandwidth and
// the f32 FMA rate, and sits well below that bound. wgmma, TMA and warp
// specialisation are later work.
//
// Design.
// * One block per (q tile of BQ rows, head, batch). A loop inside the block
//   walks the KV tiles; it takes the place of the TPU's sequential kv grid
//   axis. Its bounds come from the causal and window limits of the tile's
//   rows, so tiles above the diagonal or left of the window are never
//   loaded (the TPU kernel skips their compute with pl.when).
// * Q, K and V tiles are converted to f32 once, into dynamic shared memory
//   (102,912 bytes at hd 256, hence cudaFuncSetAttribute). Rows are padded
//   by 4 floats: float4 walks along a row stay 16-byte aligned, and the 8
//   threads that read 8 different K rows hit 8 different bank groups.
// * 256 threads; each query row is owned by 8 adjacent lanes of one warp.
//   They split the tile's 32 key columns for Q.K^T and the hd output
//   columns for P.V, and combine row max and row sum with warp shuffles.
//   The f32 accumulator lives in registers (hd / 8 floats a thread), not in
//   shared memory.
// * Masks inside a tile: k_pos < Sk, causal q_pos >= k_pos, and window
//   q_pos - k_pos < window, exactly as the TPU kernel.
// * The model layout (B, S, H, hd) is read through strides: no transpose.
//
// Status: this source was compiled for sm_90a and held against the plain
// PyTorch version on an H100 by chip_smoke.py; see PERF.md for its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // key rows per KV tile
constexpr int NT = 256;         // threads per block
constexpr int TPR = NT / BQ;    // threads per query row (8, adjacent lanes)
constexpr int CPT = BK / TPR;   // score columns per thread (4)
constexpr float NEG_INF = -1073741824.0f;  // -2**30: finite on purpose

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements) for q, k, v and
// o, each as (batch, seq, head); the head_dim stride must be 1. Returns the
// cudaError_t of the launch (0 = launched); nothing is synchronised.
int fa_forward(int dtype, int hd, const void* q, const void* k,
               const void* v, void* o, int B, int Sq, int Sk, int H, int KV,
               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
               int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
               int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
               int causal, int window, int q_offset, float scale,
               void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, st, causal,
                              window, q_offset, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV, st,
                                      causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
