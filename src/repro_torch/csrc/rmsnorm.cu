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
// The backward (rms_backward, below) is the gradient JAX takes of the
// reference's jnp rms_norm (repro/models/common.py:25); the reference has
// no Pallas backward, since its training path never calls the kernel.
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

// ---------------------------------------------------------------- backward
// Per row, with r = rsqrt(mean(x^2) + eps), xh = x * r and g = dy * scale,
// all in f32:
//   dx     = r * (g - xh * mean(g * xh))        cast to x's dtype
//   dscale = sum over rows of dy * xh           f32, cast to scale's dtype
//
// What bounds it: bytes, as the forward: x and dy read once, dx written
// once (plus the column partials below, a sixteenth of the rows), a few
// flops per element.
//
// Design.
// * The forward's row teams and 16-byte vectors. r is recomputed from x
//   with the forward's own summation order, so it is the forward's r bit
//   for bit, and the forward keeps its outputs as they are.
// * Up to NV = 4 a thread keeps its x and dy vectors in registers between
//   the row sums and dx; wider rows read them again (from L1/L2).
// * dscale is deterministic, with no atomics: a team walks the rows
//   blockIdx.x * ROWS + team, stepping by gridDim.x * ROWS, and sums dy * xh
//   for its columns in registers; each (block, team) writes its column
//   sums to its own row of a float32 partials buffer, and col_sum adds the
//   partial rows in a fixed order. The grid depends only on n and the
//   buffer's rows, so two calls on the same inputs give the same bits.
template <typename T, typename W, int VEC, int TEAM, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const W* __restrict__ w,
    T* __restrict__ dx, float* __restrict__ part, int64_t n, int d,
    int64_t x_rs, float eps) {
  constexpr int ROWS = NT / TEAM;
  constexpr bool KEEP = NV <= 4;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int nvec = d / VEC;
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  // TEAM > 32 means ROWS == 1: every thread of the block walks the same
  // rows, so the block barriers below are reached by all of them
  for (int64_t row = int64_t(blockIdx.x) * ROWS + team; row < n;
       row += int64_t(gridDim.x) * ROWS) {
    const T* xr = x + row * x_rs;
    const T* gr = dy + row * d;
    float xv[KEEP ? NV : 1][VEC], gv[KEEP ? NV : 1][VEC];
    float ss = 0.f, sg = 0.f;  // sum x^2 (the forward's order); sum g * x
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * TEAM;
      if (j < nvec) {
        float a[VEC], b[VEC], s[VEC];
        load<T, VEC>(xr + j * VEC, a);
        load<T, VEC>(gr + j * VEC, b);
        load<W, VEC>(w + j * VEC, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(a[e], a[e], ss);
          sg = fmaf(b[e] * s[e], a[e], sg);
          if constexpr (KEEP) {
            xv[i][e] = a[e];
            gv[i][e] = b[e];
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    if constexpr (TEAM > 32) {
      __shared__ float red[2][NT / 32];
      if (t % 32 == 0) {
        red[0][t / 32] = ss;
        red[1][t / 32] = sg;
      }
      __syncthreads();
      ss = 0.f;
      sg = 0.f;
#pragma unroll
      for (int k = 0; k < TEAM / 32; ++k) {
        ss += red[0][k];
        sg += red[1][k];
      }
      __syncthreads();  // red is written again for the next row
    }
    const float r = rsqrtf(ss / float(d) + eps);
    const float mg = r * sg / float(d);  // mean(g * xh)

    T* orow = dx + row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * TEAM;
      if (j < nvec) {
        float a[VEC], b[VEC], s[VEC], o[VEC];
        if constexpr (KEEP) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            a[e] = xv[i][e];
            b[e] = gv[i][e];
          }
        } else {
          load<T, VEC>(xr + j * VEC, a);
          load<T, VEC>(gr + j * VEC, b);
        }
        load<W, VEC>(w + j * VEC, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = a[e] * r;
          o[e] = r * (b[e] * s[e] - xh * mg);
          acc[i][e] = fmaf(b[e], xh, acc[i][e]);
        }
        store<T, VEC>(orow + j * VEC, o);
      }
    }
  }
  float* prow = part + (int64_t(blockIdx.x) * ROWS + team) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * TEAM;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) prow[j * VEC + e] = acc[i][e];
    }
  }
}

// dscale[c] = sum of part[p][c] over p < parts, in a fixed order: lane y of
// a (32 columns x 32 lanes) block adds rows y, y + 32, ...; lane 0 then adds
// the 32 lane sums in order.
template <typename W>
__global__ void __launch_bounds__(1024) col_sum_kernel(
    const float* __restrict__ part, W* __restrict__ out, int parts, int d) {
  __shared__ float lanes[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < d)
    for (int p = threadIdx.y; p < parts; p += 32) acc += part[int64_t(p) * d + c];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) sum += lanes[k][threadIdx.x];
    out[c] = from_f32<W>(sum);
  }
}

template <typename T, typename W, int VEC, int TEAM, int NV>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w, void* dx,
                       void* dw, float* part, int max_parts, int64_t n, int d,
                       int64_t x_rs, float eps, cudaStream_t stream) {
  constexpr int ROWS = NT / TEAM;
  const int64_t want = (n + ROWS - 1) / ROWS;
  const int64_t blocks = want < max_parts / ROWS ? want : max_parts / ROWS;
  if (blocks < 1) return cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<T, W, VEC, TEAM, NV><<<unsigned(blocks), NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const W*>(w), static_cast<T*>(dx), part, n, d, x_rs, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  col_sum_kernel<W><<<unsigned((d + 31) / 32), dim3(32, 32), 0, stream>>>(
      part, static_cast<W*>(dw), int(blocks * ROWS), d);
  return cudaGetLastError();
}

template <typename T, typename W, int VEC>
cudaError_t bwd_by_width(const void* x, const void* dy, const void* w, void* dx,
                         void* dw, float* part, int mp, int64_t n, int d,
                         int64_t x_rs, float eps, cudaStream_t s) {
  const int per = d / VEC;
  if (per <= 32)
    return launch_bwd<T, W, VEC, 32, 1>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  if (per <= 64)
    return launch_bwd<T, W, VEC, 32, 2>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  if (per <= 256)
    return launch_bwd<T, W, VEC, 128, 2>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  if (per <= 512)
    return launch_bwd<T, W, VEC, 128, 4>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  if (per <= 1024)
    return launch_bwd<T, W, VEC, 128, 8>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  if (per <= 2048)
    return launch_bwd<T, W, VEC, 128, 16>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t bwd_by_alignment(const void* x, const void* dy, const void* w,
                             void* dx, void* dw, float* part, int mp, int64_t n,
                             int d, int64_t x_rs, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = uintptr_t(x) % 16 == 0 && uintptr_t(dy) % 16 == 0 &&
                   uintptr_t(dx) % 16 == 0 && d % VEC == 0 && x_rs % VEC == 0 &&
                   (sizeof(W) != sizeof(T) || uintptr_t(w) % 16 == 0);
  if (vec)
    return bwd_by_width<T, W, VEC>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
  return bwd_by_width<T, W, 1>(x, dy, w, dx, dw, part, mp, n, d, x_rs, eps, s);
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

// The gradient of rms_forward. x: n rows of d values (row stride x_rs, as
// rms_forward); dy and dx: n * d contiguous, x's dtype; w and dw: d values,
// w_dtype; part: a float32 scratch of max_parts rows of d (max_parts a
// multiple of 4, at least 4), of which the launch uses at most max_parts
// rows. Two launches on `stream` (the rows, then the column sums); returns
// the first cudaError_t (0 = launched); nothing is synchronised.
int rms_backward(int x_dtype, int w_dtype, const void* x, const void* dy,
                 const void* w, void* dx, void* dw, float* part, int max_parts,
                 int64_t n, int d, int64_t x_rs, float eps, void* stream) {
  if (n <= 0 || d <= 0 || max_parts < 4 || max_parts % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (x_dtype * 2 + w_dtype) {
    case 0:
      return bwd_by_alignment<float, float>(x, dy, w, dx, dw, part, max_parts,
                                            n, d, x_rs, eps, s);
    case 1:
      return bwd_by_alignment<float, bf16>(x, dy, w, dx, dw, part, max_parts,
                                           n, d, x_rs, eps, s);
    case 2:
      return bwd_by_alignment<bf16, float>(x, dy, w, dx, dw, part, max_parts,
                                           n, d, x_rs, eps, s);
    case 3:
      return bwd_by_alignment<bf16, bf16>(x, dy, w, dx, dw, part, max_parts,
                                          n, d, x_rs, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* rms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
