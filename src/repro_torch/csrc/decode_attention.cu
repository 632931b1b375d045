// Single-token decode attention against a KV cache for Hopper (sm_90a), CUDA
// C++ with a plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention/ops.py.
//
// Replaces no Pallas kernel: the reference's decode_attention
// (repro/models/common.py) is an XLA einsum over the bf16 cache with
// preferred_element_type=f32. The port's plain PyTorch version of it
// upcast the whole cache to float32 and reshaped it for a batched GEMV in
// every layer (about 7.4 GB moved a layer at olmoe-1b-7b's serving shape),
// so this kernel computes the same function from the cache in place.
//
// Function, per batch row b: len = min(pos_b + 1, S) (a position >= S - 1
// is the whole ring; a negative one attends to nothing and gives zeros).
// For each query head h of KV head h / g: s_j = (q_h . k_j) * hd**-0.5 in
// float32 over rows j < len, an online softmax in float32, P.V summed in
// float32, the output stored in q's dtype. Rows j >= len are never read.
//
// What bounds it on the H100: bytes. A row of K and of V is read once for
// all g query heads of its KV group (GQA against the unexpanded cache), and
// each byte feeds 2 * g flops (g <= 8 here), far below the ~295 flop/byte
// ridge. The least time is sum_b len_b * KV * hd * 2 * itemsize over
// 3.35 TB/s: 0.16 ms a layer for 64 slots of ~1,000 rows at olmoe-1b-7b's
// 16 KV heads of 128 in bf16.
//
// Design: split-KV (flash-decoding).
// * Grid (splits, KV heads x head groups, B). A CTA of 128 threads owns a
//   chunk of `chunk` cache rows of one (b, KV head) and G query heads of its
//   group (G = the largest of 8, 4, 2, 1 dividing g; g / G head groups).
//   The wrapper sizes the chunk from the shape alone (a few hundred rows
//   once the grid is full), so CTAs past their row's length exit at once
//   and ragged lengths balance across the card.
// * Lanes per row (lpr, a power of two up to 32) each hold NV 16-byte
//   vectors of a row, neighbouring lanes on neighbouring channels; the
//   CTA's 128 / lpr row groups walk the chunk U rows at a time, issuing all
//   2 * U * NV loads of K and V (__ldcs: read once, streamed) before using
//   any, so each CTA keeps U row groups of loads in flight and several CTAs
//   an SM cover the latency. Rows past len are not loaded: their score is
//   -inf and their V registers are zero.
// * q lives in registers in float32, pre-scaled by hd**-0.5 * log2(e); the
//   softmax runs in the log2 domain (exp2f). A row's dot product is reduced
//   over its lanes with shuffles; the running max, sum and accumulator are
//   per row group, merged once at the end through shared memory in a fixed
//   order (the result's bits depend on the shape alone).
// * A CTA whose chunk holds its row's whole length writes the normalised
//   output. Otherwise it writes (max, sum, unnormalised accumulator) in
//   float32 to scratch the wrapper allocates, and da_combine_kernel (one
//   CTA per (head, b), launched by the same call when there is more than
//   one split) merges the splits that hold rows, in order.
// * Strides: K and V are read through their (batch, row, head) strides, so
//   a per-layer view of the stacked cache needs no copy; the head dim must
//   be contiguous and the base and strides 16-byte multiples (the wrapper
//   checks). q is read element by element through its strides; the output
//   is contiguous (B, 1, H, hd).
//
// Status: see PERF.md for its time on the H100 beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads a CTA

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;   // elements a 16-byte vector
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ int row_length(const int64_t* pos_rows, int64_t pos_all,
                                          int b, int S) {
  const int64_t p = pos_rows ? pos_rows[b] : pos_all;
  return p < 0 ? 0 : (p >= S - 1 ? S : static_cast<int>(p) + 1);
}

// One CTA: rows [split * chunk, min(+chunk, len)) of (b, KV head) for G
// query heads. part: nullptr when the grid has one split.
template <typename T, int NV, int G, int U>
__global__ void __launch_bounds__(NT)
    da_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ part, const int64_t* __restrict__ pos_rows,
                    int64_t pos_all, int S, int H, int g, int hd, int lpr, int chunk,
                    int nsplit, int64_t q_b, int64_t q_h, int64_t k_b, int64_t k_s,
                    int64_t k_h, int64_t v_b, int64_t v_s, int64_t v_h, float qscale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int E = NV * VEC;   // elements of a row a lane holds
  extern __shared__ float smem[];

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = g / G;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * g + (blockIdx.y % groups) * G;   // first query head
  const int len = row_length(pos_rows, pos_all, b, S);
  const int start = split * chunk;
  const int tid = threadIdx.x;
  if (start >= len) {
    if (len == 0 && split == 0) {        // attends to nothing: zeros
      for (int o = tid; o < G * hd; o += NT)
        out[(static_cast<int64_t>(b) * H + h0 + o / hd) * hd + o % hd] = from_f32<T>(0.f);
    }
    return;
  }
  const int end = min(start + chunk, len);
  const int gi = tid / lpr, li = tid % lpr, ngr = NT / lpr;

  float qr[G][E];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const int e = (li + n * lpr) * VEC + t;
        qr[j][n * VEC + t] =
            e < hd ? to_f32(q[b * q_b + (h0 + j) * q_h + e]) * qscale : 0.f;
      }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  const T* kb = k + b * k_b + kvh * k_h;
  const T* vb = v + b * v_b + kvh * v_h;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int base = start; base < end; base += ngr * U) {   // CTA-uniform bounds
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * ngr + gi;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = (li + n * lpr) * VEC;
        const bool ld = row < end && col < hd;
        kr[u][n] = ld ? __ldcs(reinterpret_cast<const uint4*>(kb + row * k_s + col)) : zero;
        vr[u][n] = ld ? __ldcs(reinterpret_cast<const uint4*>(vb + row * v_s + col)) : zero;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float t[VEC];
        unpack(kr[u][n], t);
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[n * VEC + i] = t[i];
      }
      const bool valid = base + u * ngr + gi < end;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[j][e], kf[e], dot);
        for (int off = lpr / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][j] = valid ? dot : -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][j]);
      if (mx == -INFINITY) continue;                 // no row of this group yet
      const float corr = exp2f(m[j] - mx);           // 0 while m is -inf
      l[j] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= corr;
      m[j] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float t[VEC];
        unpack(vr[u][n], t);
#pragma unroll
        for (int i = 0; i < VEC; ++i) vf[n * VEC + i] = t[i];
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float p = s[u][j] == -INFINITY ? 0.f : exp2f(s[u][j] - m[j]);
        l[j] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
  }

  // merge the row groups: sm_m, sm_l [ngr][G], sm_a [ngr][G][hd]
  float* sm_m = smem;
  float* sm_l = sm_m + ngr * G;
  float* sm_a = sm_l + ngr * G;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (li == 0) {
      sm_m[gi * G + j] = m[j];
      sm_l[gi * G + j] = l[j];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const int e = (li + n * lpr) * VEC + t;
        if (e < hd) sm_a[(gi * G + j) * hd + e] = acc[j][n * VEC + t];
      }
  }
  __syncthreads();
  const bool whole = start == 0 && end == len;
  for (int o = tid; o < G * hd; o += NT) {
    const int j = o / hd, e = o % hd;
    float mx = -INFINITY;
    for (int r = 0; r < ngr; ++r) mx = fmaxf(mx, sm_m[r * G + j]);
    float sum = 0.f, a = 0.f;
    for (int r = 0; r < ngr; ++r) {
      const float mr = sm_m[r * G + j];
      const float w = mr == -INFINITY ? 0.f : exp2f(mr - mx);
      sum = fmaf(w, sm_l[r * G + j], sum);
      a = fmaf(w, sm_a[(r * G + j) * hd + e], a);
    }
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + j;
    if (whole) {
      out[bh * hd + e] = from_f32<T>(a / sum);
    } else {
      const int64_t at = bh * nsplit + split;
      part[at * hd + e] = a;
      if (e == 0) {
        float* ml = part + static_cast<int64_t>(gridDim.z) * H * nsplit * hd;
        ml[2 * at] = mx;
        ml[2 * at + 1] = sum;
      }
    }
  }
}

// One CTA per (head, b): merges the row's splits that hold rows, in order.
// A row whose length fits one chunk was written by its split kernel.
template <typename T>
__global__ void __launch_bounds__(NT)
    da_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      const int64_t* __restrict__ pos_rows, int64_t pos_all, int B, int S,
                      int H, int hd, int chunk, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = row_length(pos_rows, pos_all, b, S);
  const int used = (len + chunk - 1) / chunk;
  if (used <= 1) return;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* acc = part + bh * nsplit * hd;
  const float* ml = part + static_cast<int64_t>(B) * H * nsplit * hd + bh * nsplit * 2;
  float mx = -INFINITY;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int e = threadIdx.x; e < hd; e += NT) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < used; ++s) {
      const float w = exp2f(ml[2 * s] - mx);
      sum = fmaf(w, ml[2 * s + 1], sum);
      a = fmaf(w, acc[s * hd + e], a);
    }
    out[bh * hd + e] = from_f32<T>(a / sum);
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *part;
  const int64_t* pos_rows;
  int64_t pos_all;
  int B, S, KV, H, g, hd, lpr, chunk, nsplit;
  int64_t q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  float qscale;
  cudaStream_t stream;
};

template <typename T, int NV, int G>
int launch(const Args& a) {
  constexpr int U = (NV == 2 || G == 8) ? 2 : 4;   // rows a row group loads at once
  const int ngr = NT / a.lpr;
  const size_t smem = sizeof(float) * static_cast<size_t>(ngr) * G * (a.hd + 2);
  const dim3 grid(a.nsplit, a.KV * (a.g / G), a.B);
  da_split_kernel<T, NV, G, U><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.part), a.pos_rows, a.pos_all, a.S,
      a.H, a.g, a.hd, a.lpr, a.chunk, a.nsplit, a.q_b, a.q_h, a.k_b, a.k_s, a.k_h, a.v_b,
      a.v_s, a.v_h, a.qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  da_combine_kernel<T><<<dim3(a.H, a.B), NT, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<T*>(a.out), a.pos_rows, a.pos_all,
      a.B, a.S, a.H, a.hd, a.chunk, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int by_group(const Args& a, int G) {
  switch (G) {
    case 1: return launch<T, NV, 1>(a);
    case 2: return launch<T, NV, 2>(a);
    case 4: return launch<T, NV, 4>(a);
    case 8: return launch<T, NV, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, 1, H, hd) through strides (q_b, q_h) elements, unit stride on hd;
// k and v (B, S, KV, hd) through (k_b, k_s, k_h) and (v_b, v_s, v_h), unit
// stride on hd, 16-byte aligned base and strides; out: B * H * hd
// contiguous, q's dtype; part: B * H * nsplit * (hd + 2) floats when nsplit
// > 1 (else unused). pos_rows: B int64 positions on the device, or null to
// use pos_all for every row. dtype: 0 = float32, 1 = bfloat16. nv, group,
// lpr, chunk and nsplit are the wrapper's plan (ops.py::plan), checked here
// for what would make the launch unsound. Returns the cudaError_t of the
// launches (0 = launched); nothing is synchronised.
int da_forward(int dtype, int nv, int group, const void* q, const void* k, const void* v,
               void* out, void* part, const void* pos_rows, int64_t pos_all, int B, int S,
               int KV, int g, int hd, int lpr, int chunk, int nsplit, int64_t q_b,
               int64_t q_h, int64_t k_b, int64_t k_s, int64_t k_h, int64_t v_b,
               int64_t v_s, int64_t v_h, float qscale, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  const int vec = dtype == 0 ? 4 : 8;
  if (S <= 0 || g <= 0 || group <= 0 || g % group || lpr <= 0 || lpr > 32 ||
      (lpr & (lpr - 1)) || chunk <= 0 || nsplit <= 0 ||
      static_cast<int64_t>(nsplit) * chunk < S || hd <= 0 || hd % vec ||
      hd > vec * lpr * nv || (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, part, static_cast<const int64_t*>(pos_rows), pos_all, B, S, KV,
         KV * g, g, hd, lpr, chunk, nsplit, q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
         qscale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && nv == 1) return by_group<__nv_bfloat16, 1>(a, group);
  if (dtype == 0 && nv == 1) return by_group<float, 1>(a, group);
  if (dtype == 0 && nv == 2) return by_group<float, 2>(a, group);
  return cudaErrorInvalidValue;
}

const char* da_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
