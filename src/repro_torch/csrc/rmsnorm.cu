// RMSNorm for Hopper (sm_90a), CUDA C++ with a plain C interface, loaded
// with ctypes by repro_torch/kernels/rmsnorm/ops.py.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_2d, body _rmsnorm_kernel; wrapper ops.py::rmsnorm): per row,
// x * rsqrt(sum(x**2) / d + eps) * scale in float32, cast back to x's
// dtype; the sum is divided by the true d.
//
// What bounds it on the H100: bytes. It reads each element once and writes
// it once with a few flops per element, far below the card's ~295 flop/byte
// ridge, so the least time is 2 * N * d * itemsize bytes at 3.35 TB/s. At
// the decode shapes (4 x 1152, 16 x 256, 4 x 256) that is a few
// nanoseconds, so there the launch decides: the host path must be lean
// (one ctypes call, no Python launcher) and the kernel one short wave.
//
// Design.
// * A team of TEAM threads owns one row: one warp (TEAM 32, 4 rows a block
//   of 128) up to 64 vectors a row, the whole block (TEAM 128) above, with
//   the warps' partial sums combined in shared memory. Wide teams keep a
//   thread's loads few, so a short call is one memory round trip.
// * The row stays in registers (NV vectors of VEC values a thread) between
//   the sum of squares and the scale, so x crosses device memory once each
//   way. Up to NV = 4 the scale's values are loaded with x, before the
//   reduction, so their latency overlaps.
// * Vector path: 16-byte loads and stores (8 bf16 or 4 f32) when x's base
//   and row stride, the output and d allow them; otherwise the scalar path
//   (VEC 1), e.g. d = 7 or 300 in bf16.
// * Rows are read through their stride (the final norm's last-position
//   rows need no copy); the output is contiguous (rows of d).
// * scale may be f32 or bf16 whatever x is; it is read through the L1.
//
// Status: see PERF.md for its times on the H100 and the card they were
// measured on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block

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
  return __float2bfloat16(x);  // round to nearest even
}

// VEC consecutive values of T at p (16 bytes when VEC * sizeof(T) == 16,
// which the host guarantees is aligned) into f32
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(f[i]);
  }
}

template <typename T, typename W, int VEC, int TEAM, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int64_t n, int d, int64_t x_rs, float eps) {
  constexpr int ROWS = NT / TEAM;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int64_t row = int64_t(blockIdx.x) * ROWS + team;
  if (TEAM == 32 && row >= n) return;  // a whole warp; no block barrier below
  const int nvec = d / VEC;            // VEC divides d (VEC is 1 otherwise)
  const T* xr = x + row * x_rs;

  constexpr bool EARLY_W = NV <= 4;   // registers for the scale up front
  float v[NV][VEC], sv[EARLY_W ? NV : 1][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * TEAM;
    if (j < nvec) {
      load<T, VEC>(xr + j * VEC, v[i]);
      if constexpr (EARLY_W) load<W, VEC>(w + j * VEC, sv[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (t + i * TEAM < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (TEAM > 32) {
    __shared__ float part[NT / 32];
    if (t % 32 == 0) part[t / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < TEAM / 32; ++k) ss += part[k];
  }
  const float r = rsqrtf(ss / float(d) + eps);

  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * TEAM;
    if (j < nvec) {
      float s[VEC];
      if constexpr (EARLY_W) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] = sv[i][e];
      } else {
        load<W, VEC>(w + j * VEC, s);
      }
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = v[i][e] * r * s[e];
      store<T, VEC>(orow + j * VEC, y);
    }
  }
}

template <typename T, typename W, int VEC, int TEAM, int NV>
cudaError_t launch(const void* x, const void* w, void* out, int64_t n, int d,
                   int64_t x_rs, float eps, cudaStream_t stream) {
  constexpr int ROWS = NT / TEAM;
  const int64_t blocks = (n + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, W, VEC, TEAM, NV><<<unsigned(blocks), NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out),
      n, d, x_rs, eps);
  return cudaGetLastError();
}

// Pick the team and the registers a thread holds from the row's length.
template <typename T, typename W, int VEC>
cudaError_t by_width(const void* x, const void* w, void* out, int64_t n, int d,
                     int64_t x_rs, float eps, cudaStream_t s) {
  const int per = d / VEC;  // vectors (or values) a row
  if (per <= 32) return launch<T, W, VEC, 32, 1>(x, w, out, n, d, x_rs, eps, s);
  if (per <= 64) return launch<T, W, VEC, 32, 2>(x, w, out, n, d, x_rs, eps, s);
  if (per <= 256)
    return launch<T, W, VEC, 128, 2>(x, w, out, n, d, x_rs, eps, s);
  if (per <= 512)
    return launch<T, W, VEC, 128, 4>(x, w, out, n, d, x_rs, eps, s);
  if (per <= 1024)
    return launch<T, W, VEC, 128, 8>(x, w, out, n, d, x_rs, eps, s);
  if (per <= 2048)
    return launch<T, W, VEC, 128, 16>(x, w, out, n, d, x_rs, eps, s);
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t by_alignment(const void* x, const void* w, void* out, int64_t n,
                         int d, int64_t x_rs, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = uintptr_t(x) % 16 == 0 && uintptr_t(out) % 16 == 0 &&
                   d % VEC == 0 && x_rs % VEC == 0 &&
                   (sizeof(W) != sizeof(T) || uintptr_t(w) % 16 == 0);
  if (vec) return by_width<T, W, VEC>(x, w, out, n, d, x_rs, eps, s);
  return by_width<T, W, 1>(x, w, out, n, d, x_rs, eps, s);
}

}  // namespace

extern "C" {

// x: n rows of d values, row stride x_rs elements, unit column stride; w: d
// values; out: n * d contiguous. x_dtype / w_dtype: 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch (0 = launched); nothing is
// synchronised. Rows longer than the largest team holds (2048 vectors)
// return cudaErrorInvalidValue.
int rms_forward(int x_dtype, int w_dtype, const void* x, const void* w,
                void* out, int64_t n, int d, int64_t x_rs, float eps,
                void* stream) {
  if (n <= 0) return 0;
  if (d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (x_dtype * 2 + w_dtype) {
    case 0:
      return by_alignment<float, float>(x, w, out, n, d, x_rs, eps, s);
    case 1:
      return by_alignment<float, bf16>(x, w, out, n, d, x_rs, eps, s);
    case 2:
      return by_alignment<bf16, float>(x, w, out, n, d, x_rs, eps, s);
    case 3:
      return by_alignment<bf16, bf16>(x, w, out, n, d, x_rs, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* rms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
