// Table-driven paged relocation copy for Hopper (sm_90a), CUDA C++ with a
// plain C interface, loaded with ctypes by
// repro_torch/kernels/paged_reloc_copy/ops.py.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_reloc_copy/
// paged_reloc_copy.py (paged_reloc_copy, body _copy_kernel; wrapper
// ops.py::apply_page_table): arena[dst[i]] = blob[src[i]] over 4096-byte
// pages, in place. Pages the table does not name keep their bytes; dst is
// unique (one write per arena page), so blocks never race.
//
// What bounds it on the H100: bytes. Each named page is read once from the
// blob and written once into the arena, with no arithmetic, so the least
// time is 2 * n * 4096 bytes at 3.35 TB/s: 1.19 ms for gemma3-1b's page
// table (n = 488,199 pages, 1,999,663,104 bytes each way).
//
// Design (simple first).
// * One block of 256 threads per table entry: each thread moves 16 bytes
//   (one uint4 load, one uint4 store), so a block moves exactly one page,
//   neighbouring threads on neighbouring addresses (fully coalesced 512-byte
//   warp transactions).
// * Each block reads its own src/dst index. The TPU kernel prefetched the
//   index arrays into SMEM before the grid; here every thread of the block
//   reads the same two ints, which the L1 broadcasts.
// * The blob is read once, so its loads bypass L1 allocation (__ldcs,
//   streaming); the stores are plain.
// * With up to 8 resident blocks an SM, 132 SMs keep ~4 MB of copies in
//   flight, above the ~2 MB that 3.35 TB/s times the memory latency needs.
// TMA bulk copies (cp.async.bulk) and several pages per block are later
// work, if this kernel reaches less than half its bound.
//
// Status: compiled for sm_90a and held against the plain PyTorch version on
// an H100 by chip_smoke.py (PERF.md has its times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAGE_BYTES = 4096;
constexpr int NT = PAGE_BYTES / 16;   // threads per block: one uint4 each

__global__ void __launch_bounds__(NT)
    page_copy_kernel(const uint4* __restrict__ blob, uint4* __restrict__ arena,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst) {
  const int64_t i = blockIdx.x;
  const int64_t s = src[i];
  const int64_t d = dst[i];
  const uint4 v = __ldcs(blob + s * NT + threadIdx.x);
  arena[d * NT + threadIdx.x] = v;
}

}  // namespace

extern "C" {

// blob and arena: int32 pages, 16-byte aligned; src and dst: n int32 page
// indices on the device, already checked by the caller (in range, dst
// unique). Returns the cudaError_t of the launch (0 = launched); nothing is
// synchronised. n == 0 launches nothing.
int prc_copy(const void* blob, void* arena, const void* src, const void* dst,
             int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  page_copy_kernel<<<static_cast<unsigned>(n), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blob), static_cast<uint4*>(arena),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}

const char* prc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
