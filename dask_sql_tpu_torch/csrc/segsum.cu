// Segment sum on Hopper over typed columns read where they lie:
//
//   out[g, j] = sum of data_j[r] over the rows r with gid[r] == g and
//               mask_j[r] true, accumulated in float64.
//
// Replaces the TPU kernel `segsum_pallas` (dask_sql_tpu/ops/pallas_kernels.py,
// pl.pallas_call at line 138) and its production form `segsum_scan_blocked`.
// The TPU kernel multiplies a one-hot block by the contributions on the
// matrix unit.  Tensor cores do not serve this work on Hopper: a histogram
// does k additions per row whatever the domain, a one-hot product
// domain * k, and at Q1's domain of 12 the work is bound by the bytes read,
// not by operations; TF32 would also break the 5e-6 error bound.
//
// Each column is a descriptor: a data pointer (float32, float64 or bool),
// and an optional bool row mask.  A bool column adds 1 where it and its mask
// are true (a count); a float column adds its value where its mask is true.
// Rows under a false mask are skipped, not multiplied by 0, so they may hold
// NaN.  Ids outside [0, domain) add nothing, as a one-hot row of zeros.
//
//   pass 1  grid (blocks, column chunks), two blocks an SM where shared
//           memory allows.  A block is one producer warp and eight
//           consumer warps around a ring of two stages in shared memory.
//           A stage holds one tile of rows of every distinct buffer the
//           chunk reads (the ids, each column's data, each distinct mask),
//           filled by one cp.async.bulk a buffer that completes on the
//           stage's mbarrier; the producer refills a stage as soon as the
//           consumers release it, so loads stay in flight while the
//           consumers add.  A consumer thread takes 4 rows of a tile: the
//           ids as one int4, a float32 column as one float4, a float64
//           column as two double2, a bool column or mask as one 32-bit
//           word, all from shared memory.  Rows past the last full tile,
//           and every row of a call whose buffers are not 16-byte aligned
//           (a view can start anywhere), load one by one from global
//           memory here.
//           Every float64 partial cell has one owner, and that owner
//           adds in an order fixed by the call's shape, so the sums are
//           the same bits on every run (q15 compares two sums computed
//           apart).  Each consumer warp owns its own [domain, floats]
//           float64 partial.  For each of a thread's 4 rows the lanes that
//           hold the same id find each other (__match_any_sync) and merge
//           their values along the list of those lanes in lane order, by
//           pointer jumping (a fixed tree of shuffles); the first lane of
//           the list then adds the merged value into the warp's partial
//           with a plain load, add and store.  No float atomic is left.
//           Which rows a warp takes, which tiles a block takes and the grid
//           are fixed by the plan; rows that load from global memory (the
//           tail past the last full tile, or a call whose buffers are not
//           16-byte aligned) keep the same rows-to-thread map as staged
//           rows.  Counts add as 32-bit integers into one [domain, counts]
//           copy a block with shared atomics: integer adds are exact in
//           any order.  At the end each block sums its warps' partials in
//           warp order into the [blocks, domain, k] float64 scratch.  Eight
//           warp partials of one float column at domain 2048 take 128 KB,
//           so the plan takes as many columns a block as fit in shared
//           memory (one, at that domain), and the grid's column chunks
//           cover the rest.  Above 3516 groups (asked for only outside the
//           default policy) not even one column's eight partials fit: the
//           block then keeps one partial, every consumer warp reads every
//           row of the block's tiles, and warp w adds only the ids g with
//           g % 8 == w, so each cell still has one owner.
//   pass 2  one warp per output cell: lane l sums blocks l, l + 32, ... in
//           order, then a fixed shuffle tree; nothing nondeterministic of
//           its own.
//
// Contract (that of segsum_scan_blocked): float64 output, relative error at
// or under 5e-6 on float sums, counts exact.  Every float addition is
// float64 here, so the error is far below that bound.
//
// Bound: the kernel must read each distinct input buffer once: 4 bytes of
// id per row plus each column's data and each distinct mask.  For TPC-H Q1
// at SF1 (n = 6,000,000; 6 masks, 3 float32 and 2 float64 sums) that is
// 38 bytes a row, 228 MB, about 68 us at the 3.35 TB/s of an H100 SXM.
//
// The launch is planned here alone: dsql_segsum_plan picks the columns a
// block sums, the shared-memory layout and the grid for the
// shape of a call; the caller keeps that plan and hands it to every
// dsql_segsum_typed of the same shape.
//
// Built by dask_sql_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: each C entry point returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 256;             // 8 consumer warps
constexpr int kWarps = kConsumers / 32;     // float partials a block
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxCols = 32;                // descriptors a launch carries
constexpr int kMaxBufs = 1 + 2 * kMaxCols;  // ids, data and masks
constexpr int kStages = 2;
constexpr int kMaxTile = 4 * kConsumers;    // rows: one group a consumer
// tiles are multiples of this, so a tile's groups of 4 rows fill whole warps
constexpr int kTileStep = 128;
constexpr int kBatch = 4;  // columns whose loads a thread issues together
constexpr int kCombineThreads = 256;
// shared memory a block may take so that two stay resident on an SM
// (228 KB an SM, less 1 KB a block and the static arrays below)
constexpr int kPairBytes = 110 * 1024;
constexpr int kMaxBytes = 227 * 1024 - 4096;  // one block an SM
// the largest domain: one column's float partial (a single copy, the
// domain split among the warps) beside a ring of kTileStep rows of its
// widest row (id, float64 data, mask: 13 bytes)
constexpr int kMaxDomain = (kMaxBytes - 2 * kTileStep * 13) / 8;
constexpr int kPlanInts = 16;  // ints the caller keeps a Plan in

enum ColumnType : int { kFloat32 = 0, kFloat64 = 1, kBool = 2 };

// The descriptors, passed by value as a kernel parameter.
struct Columns {
  const void* data[kMaxCols];
  const uint8_t* mask[kMaxCols];  // nullptr: no mask
  int type[kMaxCols];
};

struct Desc {
  const void* data;
  const uint8_t* mask;
  int type;
  int slot;      // index among the chunk's float columns, or its counts
  int data_off;  // byte offsets of the column's data and mask in a stage
  int mask_off;  // -1: no mask
};

struct Buf {
  const char* ptr;
  int row_bytes;
  int off;
};

__host__ __device__ inline int row_bytes_of(int type) {
  return type == kFloat64 ? 8 : type == kFloat32 ? 4 : 1;
}

// Shared-memory layout of a launch, the same on the host and the device.
struct Layout {
  int row_bytes;       // most bytes a row of a chunk's distinct buffers
  int partial_bytes;   // most a chunk's partials take: the [domain,
                       // floats] float partial (kWarps copies unless the
                       // domain is split), then the counts
  int tile;            // rows a stage holds; 0: nothing staged
  int smem;            // dynamic shared memory a block
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// The layout of a call's k columns, chunked kc at a time.  data_buf[c]
// and mask_buf[c] name column c's buffers: one id for one buffer (the same
// memory read as the same type), a mask id below 0 for no mask.  The
// kernel finds the same distinct buffers by their pointers.
__host__ __device__ inline int float_bytes(int domain, int floats,
                                           bool split) {
  return align128(domain * floats * (split ? 1 : kWarps) * 8);
}

Layout layout_of(int domain, int k, const int64_t* data_buf,
                 const int64_t* mask_buf, const int* types, int kc,
                 bool split) {
  Layout l = {0, 0, 0, 0};
  for (int c0 = 0; c0 < k; c0 += kc) {
    const int c1 = c0 + kc < k ? c0 + kc : k;
    int floats = 0, counts = 0, bytes = 4;
    int64_t seen[2 * kMaxCols];
    int nseen = 0;
    for (int c = c0; c < c1; ++c) {
      (types[c] == kBool ? counts : floats) += 1;
      const int64_t ids[2] = {data_buf[c], mask_buf[c]};
      const int rbs[2] = {row_bytes_of(types[c]), 1};
      for (int w = 0; w < 2; ++w) {
        if (ids[w] < 0) continue;
        bool dup = false;
        for (int b = 0; b < nseen; ++b) dup = dup || seen[b] == ids[w];
        if (!dup) {
          seen[nseen++] = ids[w];
          bytes += rbs[w];
        }
      }
    }
    const int partial =
        float_bytes(domain, floats, split) + align128(domain * counts * 4);
    l.partial_bytes = partial > l.partial_bytes ? partial : l.partial_bytes;
    l.row_bytes = bytes > l.row_bytes ? bytes : l.row_bytes;
  }
  const int budgets[2] = {kPairBytes, kMaxBytes};
  for (int budget : budgets) {
    int tile = (budget - l.partial_bytes) / (kStages * l.row_bytes);
    tile = tile > kMaxTile ? kMaxTile : tile / kTileStep * kTileStep;
    if (tile > 0) {
      l.tile = tile;
      break;
    }
  }
  l.smem = l.partial_bytes + kStages * l.tile * l.row_bytes;
  return l;
}

// The plan of a call, made by dsql_segsum_plan and read by the kernel.
struct Plan {
  int kc;        // columns a chunk: blockIdx.y of a launch
  int warps;     // copies of the float partial a block: one a consumer
                 // warp, or 1 where the domain is split among the warps
  int blocks;    // blocks of pass 1: gridDim.x and the scratch's rows
  int group;     // columns a launch: a multiple of kc, at most kMaxCols
  Layout lay;
};
static_assert(sizeof(Plan) <= kPlanInts * sizeof(int), "Plan outgrew kPlanInts");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned on_bits(unsigned m) {
  unsigned on = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (((m >> (8 * t)) & 0xffu) != 0) on |= 1u << t;
  return on;
}

// Group q (rows 4q .. 4q + 3) of a staged tile: values into v, and into
// `on` bit t whether row t adds (its mask and, for bool, its value true).
__device__ __forceinline__ void load_staged(const Desc& d, const char* st,
                                            int q, double (&v)[4],
                                            unsigned& on) {
  unsigned m = 0x01010101u;
  if (d.mask_off >= 0) m = reinterpret_cast<const unsigned*>(st + d.mask_off)[q];
  if (d.type == kFloat32) {
    const float4 x = reinterpret_cast<const float4*>(st + d.data_off)[q];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if (d.type == kFloat64) {
    const double2* p = reinterpret_cast<const double2*>(st + d.data_off);
    const double2 a = p[2 * q], b = p[2 * q + 1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    m &= reinterpret_cast<const unsigned*>(st + d.data_off)[q];
  }
  on = on_bits(m);
}

// Rows r0 .. r0 + 3 (those below n) one by one from global memory.
__device__ __forceinline__ void load_rows(const Desc& d, int64_t r0, int64_t n,
                                          double (&v)[4], unsigned& on) {
  unsigned m = 0;
  const uint8_t* p8 = static_cast<const uint8_t*>(d.data);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (r0 + t >= n) continue;
    unsigned b = d.mask == nullptr ? 1u : __ldg(d.mask + r0 + t);
    if (d.type == kFloat32) {
      v[t] = __ldg(static_cast<const float*>(d.data) + r0 + t);
    } else if (d.type == kFloat64) {
      v[t] = __ldg(static_cast<const double*>(d.data) + r0 + t);
    } else {
      b &= __ldg(p8 + r0 + t);
    }
    m |= b << (8 * t);
  }
  on = on_bits(m);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSteps = 5;  // pointer-jumping steps over 32 lanes

// The merge of row slot t's lanes: src[s] is the lane whose running sum a
// lane adds at step s (-1: none), `steps` the warp's step count, `lead`
// whether this lane is the first of the lanes sharing its id.
struct Merge {
  int src[kMaxSteps];
  int steps;
  bool lead;
};

// The lanes holding the same key (ids in [0, domain); -1 for the others)
// form a list in lane order.  Pointer jumping over that list: at step s
// each lane adds the running sum of the lane 2^s places further down its
// list, so after ceil(log2(list length)) steps the list's first lane holds
// the list's sum, added in a tree fixed by which lanes hold which id.
__device__ __forceinline__ Merge merge_plan(int key, int lane) {
  Merge m;
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned above = peers & ~((2u << lane) - 1u);  // 2u << 31 is 0
  int nxt = above ? __ffs(above) - 1 : -1;
  // the longest list of lanes holding a live id sets the steps
  const int longest =
      (int)__reduce_max_sync(kFull, key >= 0 ? (unsigned)__popc(peers) : 0u);
  m.steps = longest > 1 ? 32 - __clz(longest - 1) : 0;
  m.lead = (peers & ((1u << lane) - 1u)) == 0;
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    m.src[s] = nxt;
    if (s < m.steps) {
      const int far = __shfl_sync(kFull, nxt, nxt >= 0 ? nxt : lane);
      nxt = nxt >= 0 ? far : -1;
    }
  }
  return m;
}

// The sum of x over this lane's list (its first lane gets the whole sum).
__device__ __forceinline__ double merged(double x, const Merge& m, int lane) {
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s >= m.steps) break;
    const double y = __shfl_sync(kFull, x, m.src[s] >= 0 ? m.src[s] : lane);
    if (m.src[s] >= 0) x += y;
  }
  return x;
}

// Adds the 4 rows of one group, ids g, into the warp's float partial
// `wpart` and the block's counts; `st` is the stage holding them, or null
// to load them from global memory.  Every lane of the warp calls it
// together (rows past the end carry id -1).  With `owner` >= 0 (a split
// domain) the warp adds only the ids g with g % kWarps == owner.
__device__ __forceinline__ void add_group(
    double* wpart, unsigned* cnt, const Desc* desc, int kcb, int floats,
    int counts, const int (&g)[4], int domain, const char* st, int q,
    int64_t r0, int64_t n, int lane, int owner) {
  unsigned live = 0;  // rows whose id lies in [0, domain), and is the warp's
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if ((unsigned)g[t] < (unsigned)domain &&
        (owner < 0 || g[t] % kWarps == owner))
      live |= 1u << t;
  Merge mp[4];
  if (floats > 0) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      mp[t] = merge_plan((live >> t) & 1u ? g[t] : -1, lane);
  }
  for (int j0 = 0; j0 < kcb; j0 += kBatch) {
    double v[kBatch][4];
    unsigned on[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      on[b] = 0;
      if (j0 + b < kcb) {
        if (st != nullptr)
          load_staged(desc[j0 + b], st, q, v[b], on[b]);
        else
          load_rows(desc[j0 + b], r0, n, v[b], on[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b >= kcb) continue;
      const unsigned add = on[b] & live;
      const Desc& d = desc[j0 + b];
      if (d.type == kBool) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (add & (1u << t)) atomicAdd(cnt + g[t] * counts + d.slot, 1u);
        continue;
      }
      if (!__any_sync(kFull, add != 0)) continue;  // warp-uniform
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const double x = merged((add >> t) & 1u ? v[b][t] : 0.0, mp[t], lane);
        if (mp[t].lead && ((live >> t) & 1u))
          wpart[g[t] * floats + d.slot] += x;
        __syncwarp();
      }
    }
  }
}

// Pass 1.  Chunk blockIdx.y holds columns c0 = blockIdx.y * kc ... of this
// launch's ng; scratch is [gridDim.x, domain, k] over all k columns of the
// call, of which this launch holds g0 ....
// two blocks an SM where shared memory allows: at most 113 registers
__global__ void __launch_bounds__(kThreads, 2)
segsum_partials(const int32_t* __restrict__ gid, int64_t n, int domain,
                const __grid_constant__ Columns cols, int ng, int g0, int k,
                const Plan plan, double* __restrict__ scratch) {
  const int kc = plan.kc;
  const Layout lay = plan.lay;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Desc desc[kMaxCols];
  __shared__ Buf bufs[kMaxBufs];
  __shared__ int nbuf, stage_bytes, staged, nfloats, ncounts;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int c0 = blockIdx.y * kc;
  const int kcb = min(kc, ng - c0);
  double* part = reinterpret_cast<double*>(smem);
  char* ring = reinterpret_cast<char*>(smem) + lay.partial_bytes;
  const int tile = lay.tile;

  if (threadIdx.x == 0) {
    // the chunk's distinct buffers and where each lies in a stage
    int nb = 0, off = 0, floats = 0, counts = 0;
    bool ok = aligned16(gid);
    bufs[nb++] = {reinterpret_cast<const char*>(gid), 4, 0};
    off += tile * 4;
    for (int j = 0; j < kcb; ++j) {
      const int c = c0 + j;
      Desc d;
      d.data = cols.data[c];
      d.mask = cols.mask[c];
      d.type = cols.type[c];
      d.slot = d.type == kBool ? counts++ : floats++;
      const char* ptrs[2] = {static_cast<const char*>(d.data),
                             reinterpret_cast<const char*>(d.mask)};
      const int rbs[2] = {row_bytes_of(d.type), 1};
      int offs[2] = {-1, -1};
      for (int w = 0; w < 2; ++w) {
        if (ptrs[w] == nullptr) continue;
        int found = -1;
        for (int b = 0; b < nb; ++b)
          if (bufs[b].ptr == ptrs[w] && bufs[b].row_bytes == rbs[w]) found = b;
        if (found < 0) {
          ok = ok && aligned16(ptrs[w]);
          bufs[nb] = {ptrs[w], rbs[w], off};
          off += tile * rbs[w];
          found = nb++;
        }
        offs[w] = bufs[found].off;
      }
      d.data_off = offs[0];
      d.mask_off = offs[1];
      desc[j] = d;
    }
    nbuf = nb;
    stage_bytes = off;
    staged = ok;
    nfloats = floats;
    ncounts = counts;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int words = lay.partial_bytes / 8;
  for (int i = threadIdx.x; i < words; i += kThreads) part[i] = 0.0;
  __syncthreads();
  // kWarps copies of the chunk's [domain, floats] float partial, one a
  // consumer warp (or one copy, whose ids the warps split), then its
  // [domain, counts] counts
  const int floats = nfloats, counts = ncounts;
  const bool split = plan.warps == 1;
  unsigned* cnt =
      reinterpret_cast<unsigned*>(smem + float_bytes(domain, floats, split));

  // full tiles go round the grid's blocks in a fixed order, staged or not,
  // so that a row meets the same thread whatever the buffers' alignment
  const int64_t tiles = n / tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps) {
    // producer: one lane keeps both stages in flight
    if (staged && lane == 0) {
      int it = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], (unsigned)stage_bytes);
        char* st = ring + (size_t)s * stage_bytes;
        for (int b = 0; b < nbuf; ++b) {
          const unsigned bytes = (unsigned)(tile * bufs[b].row_bytes);
          bulk_copy(st + bufs[b].off, bufs[b].ptr + t * (int64_t)bytes, bytes,
                    &full[s]);
        }
      }
    }
  } else {
    // a split domain: every warp reads every row of the block's tiles
    // and adds the ids it owns into the one partial
    double* wpart = split ? part : part + (size_t)warp * domain * floats;
    const int owner = split ? warp : -1;
    const int q0 = split ? lane : threadIdx.x;
    const int qstep = split ? 32 : kConsumers;
    int it = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int s = it % kStages;
      const char* st = nullptr;
      if (staged) {
        mbar_wait(&full[s], (it / kStages) & 1);
        st = ring + (size_t)s * stage_bytes;
      }
      // tile / 4 is a multiple of 32: a warp's lanes run this loop together
      for (int q = q0; q < tile / 4; q += qstep) {
        const int64_t r0 = t * tile + 4 * (int64_t)q;
        int g[4];
        if (st != nullptr) {
          const int4 x = reinterpret_cast<const int4*>(st)[q];
          g[0] = x.x; g[1] = x.y; g[2] = x.z; g[3] = x.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) g[u] = __ldg(gid + r0 + u);
        }
        add_group(wpart, cnt, desc, kcb, floats, counts, g, domain, st, q,
                  r0, n, lane, owner);
      }
      if (staged) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    // rows past the full tiles, one by one from global memory: a block
    // takes kConsumers groups of 4 at a time, 32 a warp (all of them each
    // warp where the domain is split); the loop runs warp by warp, lanes
    // past the end holding id -1
    const int64_t groups = (n + 3) >> 2;
    for (int64_t chunk = tiles * (tile / 4) + (int64_t)blockIdx.x * kConsumers;
         chunk < groups; chunk += (int64_t)gridDim.x * kConsumers) {
      for (int sub = split ? 0 : warp; sub < (split ? kWarps : warp + 1);
           ++sub) {
        const int64_t r0 = (chunk + sub * 32 + lane) * 4;
        int g[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          g[u] = r0 + u < n ? __ldg(gid + r0 + u) : -1;
        add_group(wpart, cnt, desc, kcb, floats, counts, g, domain, nullptr,
                  0, r0, n, lane, owner);
      }
    }
  }
  __syncthreads();

  // each cell sums the warps' partials in warp order
  const int cells = domain * kcb;
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
    const int grp = cell / kcb, j = cell - grp * kcb;
    const Desc& d = desc[j];
    double sum;
    if (d.type == kBool) {
      sum = (double)cnt[grp * counts + d.slot];
    } else {
      sum = part[grp * floats + d.slot];
      for (int w = 1; w < plan.warps; ++w)
        sum += part[((size_t)w * domain + grp) * floats + d.slot];
    }
    scratch[((int64_t)blockIdx.x * domain + grp) * k + g0 + c0 + j] = sum;
  }
}

// Pass 2: out[i] = sum over blocks b of scratch[b, i], one warp per cell.
__global__ void segsum_combine(const double* __restrict__ scratch, int nb,
                               int cells, double* __restrict__ out) {
  const int64_t warp =
      ((int64_t)blockIdx.x * kCombineThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= cells) return;
  double acc = 0.0;
  for (int b = lane; b < nb; b += 32) acc += scratch[(int64_t)b * cells + warp];
  acc = warp_sum(acc);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

// The plan of a call of k columns over n rows and `domain` groups, on the
// current device: columns a chunk, shared-memory layout and grid.
// data_buf and mask_buf name each column's buffers as layout_of says;
// types[c] as in dsql_segsum_typed.  Writes kPlanInts ints to `plan`, of
// which the first three are kc, warps and blocks.  Returns -1 for a shape
// the kernel does not take (k < 1, domain < 1, or one column's warp
// partials over the domain larger than shared memory), else a cudaError_t.
extern "C" int dsql_segsum_plan(int64_t n, int domain, int k,
                                const int64_t* data_buf,
                                const int64_t* mask_buf, const int* types,
                                int* plan) {
  if (k < 1 || domain < 1 || domain > kMaxDomain) return -1;
  Plan p = {};
  // as many columns a chunk as leave room for a ring of kTileStep rows,
  // with a partial a warp; where not even one column fits, one partial
  // whose ids the warps split
  for (int split = 0; split < 2; ++split) {
    p.warps = split ? 1 : kWarps;
    for (p.kc = k < kMaxCols ? k : kMaxCols; p.kc >= 1; --p.kc) {
      p.lay = layout_of(domain, k, data_buf, mask_buf, types, p.kc,
                        split != 0);
      if (p.lay.tile > 0) break;
    }
    if (p.kc >= 1) break;
  }
  if (p.kc < 1) return -1;
  p.group = kMaxCols / p.kc * p.kc;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // the most any plan asks, so that every kept plan launches
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(segsum_partials,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segsum_partials, kThreads, (size_t)p.lay.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every SM filled as far as shared memory and registers allow, and no
  // more blocks than the row groups of 4 need
  const int64_t want = ((n + 3) / 4 + kConsumers - 1) / kConsumers;
  const int64_t most = (int64_t)sms * per_sm;
  p.blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  memset(plan, 0, kPlanInts * sizeof(int));
  memcpy(plan, &p, sizeof p);
  return 0;
}

// gid: [n] int32.  Column c (of k) is data[c] (a [n] array of types[c]:
// 0 float32, 1 float64, 2 bool) under masks[c] (a [n] bool array, or
// null).  plan: from dsql_segsum_plan for this shape.  scratch:
// [blocks, domain, k] float64; out: [domain, k] float64.  The descriptor
// arrays are host memory, read before this returns.  Launches on `stream`;
// returns a cudaError_t (0 = launched).
extern "C" int dsql_segsum_typed(const void* gid, int64_t n, int domain,
                                 int k, const void* const* data,
                                 const void* const* masks, const int* types,
                                 const int* plan, void* scratch, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  memcpy(&p, plan, sizeof p);
  for (int g0 = 0; g0 < k; g0 += p.group) {
    const int ng = k - g0 < p.group ? k - g0 : p.group;
    Columns cols = {};
    for (int c = 0; c < ng; ++c) {
      cols.data[c] = data[g0 + c];
      cols.mask[c] = static_cast<const uint8_t*>(masks[g0 + c]);
      cols.type[c] = types[g0 + c];
    }
    dim3 grid((unsigned)p.blocks, (unsigned)((ng + p.kc - 1) / p.kc));
    segsum_partials<<<grid, kThreads, p.lay.smem, s>>>(
        (const int32_t*)gid, n, domain, cols, ng, g0, k, p, (double*)scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int cells = domain * k;
  const int64_t threads = (int64_t)cells * 32;
  segsum_combine<<<(unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
                   kCombineThreads, 0, s>>>((const double*)scratch, p.blocks,
                                            cells, (double*)out);
  return (int)cudaGetLastError();
}
