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
// The backward (below: rms_backward_tma and rms_backward) is the gradient
// JAX takes of the reference's jnp rms_norm (repro/models/common.py:25);
// the reference has no Pallas backward, since its training path never
// calls the kernel.
//
// Status: see PERF.md for its times on the H100 and the card they were
// measured on.

#include <cooperative_groups.h>
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
// once, a dozen flops per element. At gemma3-1b's training shapes that is
// 3.8-17 us at 3.35 TB/s, so the kernel has to keep ~25 KB in flight on
// every SM (Little's law at ~1 us of latency) and must not pay a second
// launch or a serial column sum after the rows.
//
// Two routes, chosen by the wrapper (ops.py::bwd_route) from the dtype, d,
// the row stride and the addresses; each a launch of its own entry:
//
// "tma" (rms_backward_tma; rows TMA can copy: 16-byte aligned bases, row
// stride and row bytes, up to 160 16-byte vectors a row; every training
// shape of gemma3-1b). One launch.
// * A grid that depends only on (n, d, dtype) (ops.py::_bwd_plan): CTA i
//   owns the contiguous rows [i n / P, (i + 1) n / P); P is 264 (two CTAs
//   for each of the H100's 132 SMs) once n allows it.
// * A ring of `stages` tiles in shared memory, each `rows_per_stage` rows
//   of x and of dy, kept full by one producer thread with 1-D bulk copies
//   (cp.async.bulk, completed on a "full" mbarrier; x through its row
//   stride, one copy a row where the stride is not d). A consumer warp
//   copies its rows of a tile into registers and hands the tile back on
//   its "empty" mbarrier before the math, so the next copies do not wait
//   for it. Rows of 3 or more vectors a lane get 2 consumer warps a CTA,
//   narrower rows 4 (registers bound the warps an SM holds).
// * One warp a row: only shuffles, no block barrier. r is recomputed from
//   x in the forward's own summation order (a lane sums the vectors the
//   forward's threads lane, lane + 32, ... summed, each apart, and adds
//   them as the forward's block does), so it is the forward's r bit for
//   bit. dx is stored with 16-byte stores from registers.
// * scale is read once a CTA, into each lane's registers, as float.
// * dscale in a fixed order, no float atomics: each lane keeps its
//   columns' partial in registers across its warp's rows; the CTA adds its
//   warps' in warp order; a thread block cluster of 8 adds its CTAs' in
//   rank order through distributed shared memory, each CTA a slice of the
//   columns, into one float32 partial row a cluster; then a fence and an
//   atomicAdd ticket, and the cluster that draws last adds the partial
//   rows in row order 0..Q-1 (each of its CTAs a slice of the columns),
//   writes dscale and sets the ticket back to 0. Which cluster comes last
//   varies, the order of every sum does not: the same bits on every call.
// * What is left of the bound (PERF.md): the tail after the rows (three
//   cluster barriers, the ticket, the last cluster's pass over the partial
//   rows) costs several microseconds at every shape, and the rows
//   themselves run at about 70% of the card's memory rate.
//
// "two_pass" (rms_backward; every other row: unaligned bases, strides or
// d, e.g. d = 7 or 300 in bf16, and rows wider than 160 vectors). Two
// launches: the forward's row teams, then the column sums.
// * The forward's teams and vectors; up to NV = 4 a thread keeps its x and
//   dy in registers between the row sums and dx, wider rows read them again.
// * dscale without atomics: a team walks the rows blockIdx.x * ROWS + team,
//   stepping by gridDim.x * ROWS, and sums dy * xh for its columns in
//   registers; each (block, team) writes its column sums to its own row of
//   a float32 partials buffer, and col_sum adds the partial rows in a fixed
//   order. The grid depends only on n and the buffer's rows.
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

// ------------------------------------------------- backward, the tma route
constexpr int MAX_BT = 9 * 32;  // threads a CTA: up to 8 consumer warps + the producer

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// seconds means a copy that never lands (a byte count that does not match
// its copies): trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// `bytes` (a multiple of 16) from global `src` into shared `dst`, both
// 16-byte aligned, completed on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// VEC floats at p in shared memory (16-byte aligned), as float4s
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

// by value: the 16 bytes are one load into registers (a reference into
// shared memory would read each value with a load of its own)
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4 raw, float (&f)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
}

struct TmaArgs {
  const void* x;
  const void* dy;
  const void* w;
  void* dx;
  void* dw;
  float* part;      // one float32 row of d a cluster
  int* ticket;      // 0 between launches
  int64_t n, x_rs;  // rows; x's row stride in elements
  int d, rows_per_stage, stages;
  float eps;
};

// NVL: 16-byte vectors a lane holds (lane + 32 k, k < NVL). SUB: the
// forward's warps a row (TEAM / 32): a lane's vector k was summed by the
// forward's thread of warp k % SUB, the forward's order within a thread.
// RPW: rows a consumer warp takes from each tile (tma_rows_per_warp).
// blockDim.x / 32 - 1 consumer warps, then the producer warp.
template <typename T, typename W, int NVL, int SUB, int RPW>
__global__ void __launch_bounds__(MAX_BT) rmsnorm_bwd_tma_kernel(const TmaArgs a) {
  namespace cg = cooperative_groups;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d, S = a.stages;
  const int nvec = d / VEC, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32 - 1, nt = blockDim.x, R = nw * RPW;
  const size_t tile = size_t(R) * d;  // elements of x (or dy) a stage
  T* ring_x = reinterpret_cast<T*>(smem);
  T* ring_g = ring_x + S * tile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_g + S * tile);  // full, empty
  int* last = reinterpret_cast<int*>(bars + 2 * S);
  float* wpart = reinterpret_cast<float*>(smem);  // the ring, after the rows

  const int64_t r0 = int64_t(blockIdx.x) * a.n / gridDim.x;
  const int64_t r1 = int64_t(blockIdx.x + 1) * a.n / gridDim.x;
  const int tiles = int((r1 - r0 + R - 1) / R);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + S + s), nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NVL][VEC];  // this lane's columns of dscale, over the warp's rows
#pragma unroll
  for (int k = 0; k < NVL; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;

  if (warp == nw) {
    if (lane == 0) {  // the producer
      const T* x = static_cast<const T*>(a.x);
      const T* dy = static_cast<const T*>(a.dy);
      const uint32_t row_bytes = uint32_t(d) * sizeof(T);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(smem_u32(bars + S + s), ((it / S) - 1) & 1);
        const int64_t row = r0 + int64_t(it) * R;
        const int rows = int(r1 - row < R ? r1 - row : R);
        const uint32_t full = smem_u32(bars + s);
        mbar_expect_tx(full, 2u * rows * row_bytes);
        if (a.x_rs == d) {
          bulk_load(smem_u32(ring_x + s * tile), x + row * d, rows * row_bytes, full);
        } else {
          for (int i = 0; i < rows; ++i)
            bulk_load(smem_u32(ring_x + s * tile + size_t(i) * d),
                      x + (row + i) * a.x_rs, row_bytes, full);
        }
        bulk_load(smem_u32(ring_g + s * tile), dy + row * d, rows * row_bytes, full);
      }
    }
    __syncwarp();
  } else {  // a consumer warp: rows warp, warp + nw, ... of each tile
    float sc[NVL][VEC];  // scale, once: this lane's columns (the first tiles are in flight)
    const W* w = static_cast<const W*>(a.w);
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int j = lane + 32 * k;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sc[k][e] = j < nvec ? to_f32(w[j * VEC + e]) : 0.f;
    }
    T* dx = static_cast<T*>(a.dx);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % S;
      mbar_wait(smem_u32(bars + s), (it / S) & 1);
      const int64_t row0 = r0 + int64_t(it) * R;
      const int rows = int(r1 - row0 < R ? r1 - row0 : R);
      uint4 xv[RPW][NVL], gv[RPW][NVL];  // the warp's rows, out of the tile
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int i = warp + rr * nw;
        if (i < rows) {
          const uint4* xs = reinterpret_cast<const uint4*>(ring_x + s * tile + size_t(i) * d);
          const uint4* gs = reinterpret_cast<const uint4*>(ring_g + s * tile + size_t(i) * d);
#pragma unroll
          for (int k = 0; k < NVL; ++k) {
            const int j = lane + 32 * k;
            if (j < nvec) {
              xv[rr][k] = xs[j];
              gv[rr][k] = gs[j];
            }
          }
        }
      }
      __syncwarp();  // the tile goes back to the producer before the math
      if (lane == 0) mbar_arrive(smem_u32(bars + S + s));
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int i = warp + rr * nw;
        if (i >= rows) break;
        float part[SUB], sg = 0.f;
#pragma unroll
        for (int q = 0; q < SUB; ++q) part[q] = 0.f;
#pragma unroll
        for (int k = 0; k < NVL; ++k) {
          const int j = lane + 32 * k;
          if (j < nvec) {
            float xf[VEC], gf[VEC];
            unpack<T, VEC>(xv[rr][k], xf);
            unpack<T, VEC>(gv[rr][k], gf);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              part[k % SUB] = fmaf(xf[e], xf[e], part[k % SUB]);
              sg = fmaf(gf[e] * sc[k][e], xf[e], sg);
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < SUB; ++q)
            part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
          sg += __shfl_xor_sync(0xffffffffu, sg, off);
        }
        float ss = SUB > 1 ? 0.f : part[0];
        if constexpr (SUB > 1) {
#pragma unroll
          for (int q = 0; q < SUB; ++q) ss += part[q];
        }
        const float r = rsqrtf(ss / float(d) + a.eps);
        const float mg = r * sg / float(d);  // mean(g * xh)
        T* orow = dx + (row0 + i) * d;
#pragma unroll
        for (int k = 0; k < NVL; ++k) {
          const int j = lane + 32 * k;
          if (j < nvec) {
            float xf[VEC], gf[VEC], o[VEC];
            unpack<T, VEC>(xv[rr][k], xf);
            unpack<T, VEC>(gv[rr][k], gf);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float xh = xf[e] * r;
              o[e] = r * (gf[e] * sc[k][e] - xh * mg);
              acc[k][e] = fmaf(gf[e], xh, acc[k][e]);
            }
            store<T, VEC>(orow + j * VEC, o);
          }
        }
      }
    }
  }
  __syncthreads();  // every tile consumed: the ring becomes wpart

  if (warp < nw) {
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) store_f32<VEC>(wpart + warp * d + j * VEC, acc[k]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += nt) {  // the CTA's row, warps in order
    float sum = wpart[c];
    for (int q = 1; q < nw; ++q) sum += wpart[q * d + c];
    wpart[c] = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // the cluster's row: CTA `rank` adds the CTAs' rows in rank order over
  // its slice of the columns, and writes the slice to part
  const int csize = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int width = (d + csize - 1) / csize;
  const int lo = rank * width, hi = min(d, lo + width);
  const int64_t nq = gridDim.x / csize;
  for (int c = lo + threadIdx.x; c < hi; c += nt) {
    float v[8];  // every CTA's value first, so the remote reads overlap
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = q < csize ? cluster.map_shared_rank(wpart, q)[c] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < csize) sum += v[q];
    a.part[int64_t(blockIdx.x / csize) * d + c] = sum;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {  // one fence for the cluster's writes before it
    __threadfence();
    const int is_last = atomicAdd(a.ticket, 1) == int(nq) - 1;
    __threadfence();  // and for the reads of the partial rows after it
    if (is_last) atomicExch(a.ticket, 0);  // every cluster has drawn
    for (int q = 0; q < csize; ++q) *cluster.map_shared_rank(last, q) = is_last;
  }
  cluster.sync();
  if (*last) {  // the last cluster: the partial rows in row order
    W* dw = static_cast<W*>(a.dw);
    for (int c = lo + threadIdx.x; c < hi; c += nt) {
      const float* col = a.part + c;
      float sum = 0.f;
      for (int q0 = 0; q0 < int(nq); q0 += 16) {  // 16 loads in flight, then the adds
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          v[q] = q0 + q < int(nq) ? __ldcg(col + size_t(q0 + q) * d) : 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (q0 + q < int(nq)) sum += v[q];
      }
      dw[c] = from_f32<W>(sum);
    }
  }
}

// rows a consumer warp takes from each tile: as many as keep its registers
// near 40 vectors of x and dy
constexpr int tma_rows_per_warp(int nvl) { return nvl == 1 ? 4 : nvl == 2 ? 2 : 1; }

// shared bytes of the tma route's CTA: the ring, the barriers, the last
// cluster's flag (ops.py::_bwd_plan counts the same)
inline size_t tma_smem(int d, int itemsize, int rows_per_stage, int stages) {
  return size_t(stages) * 2 * rows_per_stage * d * itemsize + size_t(stages) * 16 + 16;
}

template <typename T, typename W, int NVL, int SUB>
cudaError_t launch_tma(const TmaArgs& a, int ctas, int cluster, int warps, size_t smem,
                       cudaStream_t stream) {
  constexpr int RPW = tma_rows_per_warp(NVL);
  if (a.rows_per_stage != warps * RPW) return cudaErrorInvalidValue;
  auto kernel = rmsnorm_bwd_tma_kernel<T, W, NVL, SUB, RPW>;
  if (smem > 48 * 1024) {  // the attribute is the current device's: set it every launch
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(ctas));
  cfg.blockDim = dim3(unsigned(warps + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t tma_by_width(const TmaArgs& a, int ctas, int cluster, int warps, size_t smem,
                         cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  switch ((a.d / VEC + 31) / 32) {  // the forward's team: 128 above 64 vectors
    case 1: return launch_tma<T, W, 1, 1>(a, ctas, cluster, warps, smem, s);
    case 2: return launch_tma<T, W, 2, 1>(a, ctas, cluster, warps, smem, s);
    case 3: return launch_tma<T, W, 3, 4>(a, ctas, cluster, warps, smem, s);
    case 4: return launch_tma<T, W, 4, 4>(a, ctas, cluster, warps, smem, s);
    case 5: return launch_tma<T, W, 5, 4>(a, ctas, cluster, warps, smem, s);
    default: return cudaErrorInvalidValue;
  }
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

// The gradient of rms_forward on the two_pass route. x: n rows of d values
// (row stride x_rs, as rms_forward); dy and dx: n * d contiguous, x's dtype; w and dw: d values,
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

// The gradient of rms_forward on the tma route (the header's note): one
// launch on `stream`. x: n rows of d values, row stride x_rs elements; dy
// and dx: n * d contiguous, x's dtype; w and dw: d values, w_dtype. part:
// float32 scratch of ctas / cluster rows of d; ticket: one int32, 0 before
// the launch and 0 again after it (keep one a stream). ctas (a multiple of
// cluster, 1..8), warps (consumer warps a CTA, 1..8), rows_per_stage and
// stages: ops.py::_bwd_plan. Bases of x, dy and dx, x_rs * itemsize and
// d * itemsize must be multiples of 16, d at most 160 16-byte vectors (5 a
// lane), and the CTA's shared memory at most 227 KB; otherwise
// cudaErrorInvalidValue and nothing is launched. Returns the cudaError_t of
// the launch (0 = launched); nothing is synchronised.
int rms_backward_tma(int x_dtype, int w_dtype, const void* x, const void* dy,
                     const void* w, void* dx, void* dw, float* part, int* ticket,
                     int64_t n, int d, int64_t x_rs, int ctas, int cluster, int warps,
                     int rows_per_stage, int stages, float eps, void* stream) {
  if (n <= 0 || d <= 0 || ctas <= 0 || cluster < 1 || cluster > 8 ||
      ctas % cluster || warps < 1 || warps > 8 || rows_per_stage < 1 || stages < 2)
    return cudaErrorInvalidValue;
  const int itemsize = x_dtype ? 2 : 4;
  const size_t smem = tma_smem(d, itemsize, rows_per_stage, stages);
  const bool aligned = uintptr_t(x) % 16 == 0 && uintptr_t(dy) % 16 == 0 &&
                       uintptr_t(dx) % 16 == 0 && (int64_t(d) * itemsize) % 16 == 0 &&
                       (x_rs * itemsize) % 16 == 0 && x_rs >= d;
  const size_t ring = size_t(stages) * 2 * rows_per_stage * d * itemsize;
  if (!aligned || d * itemsize > 160 * 16 || smem > 232448 ||
      ring < size_t(warps) * d * 4)  // the ring holds the warps' dscale rows after
    return cudaErrorInvalidValue;
  TmaArgs a{x, dy, w, dx, dw, part, ticket, n, x_rs, d, rows_per_stage, stages, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (x_dtype * 2 + w_dtype) {
    case 0: return tma_by_width<float, float>(a, ctas, cluster, warps, smem, s);
    case 1: return tma_by_width<float, bf16>(a, ctas, cluster, warps, smem, s);
    case 2: return tma_by_width<bf16, float>(a, ctas, cluster, warps, smem, s);
    case 3: return tma_by_width<bf16, bf16>(a, ctas, cluster, warps, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
