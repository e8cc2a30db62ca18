// Segment sum on Hopper: out[g, j] = sum of cols[j, r] over the rows r with
// gid[r] == g, accumulated in float64.
//
// Replaces the TPU kernel `segsum_pallas` (dask_sql_tpu/ops/pallas_kernels.py,
// pl.pallas_call at line 138) and its production form `segsum_scan_blocked`.
// The TPU kernel builds a one-hot block in VMEM and feeds it to the matrix
// unit; nothing of that carries over.  Here the natural form is a histogram
// in shared memory:
//
//   pass 1  grid (row_blocks, column_chunks).  Each block owns at most
//           32,768 rows and keeps a [domain, kc] float64 partial in dynamic
//           shared memory.  Neighbouring threads read neighbouring rows of
//           the [k, n] column stack (coalesced), and add each row's values
//           into the partial with a shared atomicAdd(double).  Ids outside
//           [0, domain) add nothing, as a one-hot row of zeros would.  The
//           ragged last block is masked here; there are no padding copies.
//   pass 2  sums the [row_blocks, domain, k] scratch in fixed block order
//           into the [domain, k] float64 output.
//
// Contract (that of segsum_scan_blocked): float64 output, relative error at
// or under 5e-6 on float sums, counts (0/1 columns) exact.  Every addition is
// float64 here, so the error is far below that bound.
//
// Bound: the kernel must read n*(4 + 4k) bytes and write domain*k*8.  For
// TPC-H Q1 at SF1 (n = 6,000,000, domain = 12, k = 13) that is about 336 MB,
// about 100 us at the 3.35 TB/s of an H100 SXM: it is bound by bytes, not by
// its n*k float64 additions.  Contention of the shared atomics on few groups
// is what keeps this simple form from that bound; warp-private partials and
// cp.async/TMA loads are the next design.
//
// Built by dask_sql_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCombineThreads = 256;

__global__ void segsum_partials(const int32_t* __restrict__ gid,
                                const float* __restrict__ cols,  // [k, n]
                                int64_t n, int k, int domain,
                                int rows_per_block, int kc,
                                double* __restrict__ scratch) {  // [nb, domain, k]
  extern __shared__ double part[];  // [domain, kcb]
  const int c0 = blockIdx.y * kc;
  const int kcb = min(kc, k - c0);
  const int cells = domain * kcb;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) part[i] = 0.0;
  __syncthreads();

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const float* src = cols + (int64_t)c0 * n;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int g = gid[r];
    if (g < 0 || g >= domain) continue;
    double* row = part + g * kcb;
    for (int j = 0; j < kcb; ++j) {
      atomicAdd(row + j, (double)src[(int64_t)j * n + r]);
    }
  }
  __syncthreads();

  double* dst = scratch + (int64_t)blockIdx.x * domain * k + c0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int g = i / kcb;
    const int j = i - g * kcb;
    dst[(int64_t)g * k + j] = part[i];
  }
}

__global__ void segsum_combine(const double* __restrict__ scratch, int64_t nb,
                               int cells, double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  double acc = 0.0;
  for (int64_t b = 0; b < nb; ++b) acc += scratch[b * cells + i];
  out[i] = acc;
}

}  // namespace

// gid: [n] int32; cols: [k, n] float32, contiguous; scratch: [nb, domain, k]
// float64 with nb = ceil(n / rows_per_block); out: [domain, k] float64.
// kc columns per chunk must satisfy domain * kc * 8 <= the block's shared
// memory.  Launches on `stream`; returns a cudaError_t (0 = launched).
extern "C" int dsql_segsum_f32(const void* gid, const void* cols, int64_t n,
                               int k, int domain, int rows_per_block, int kc,
                               void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (n + rows_per_block - 1) / rows_per_block;
  if (nb > 0) {
    const int chunks = (k + kc - 1) / kc;
    const size_t smem = (size_t)domain * kc * sizeof(double);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          segsum_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)nb, (unsigned)chunks);
    segsum_partials<<<grid, kThreads, smem, s>>>(
        (const int32_t*)gid, (const float*)cols, n, k, domain, rows_per_block,
        kc, (double*)scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int cells = domain * k;
  segsum_combine<<<(cells + kCombineThreads - 1) / kCombineThreads,
                   kCombineThreads, 0, s>>>((const double*)scratch, nb, cells,
                                            (double*)out);
  return (int)cudaGetLastError();
}
