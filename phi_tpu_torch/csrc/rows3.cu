// rows3 sketch kernel for Hopper (sm_90a): canonical k-mer minimizers of
// 2-bit haplotype rows, with walk-position intervals and a per-block stable
// left-compaction of the emitted lanes.
//
// Replaces phi_tpu/sketch/kernels.py:_make_kernel_rows3 (the Pallas TPU
// kernel behind _pallas_sketch_rows3 / _pallas_join_rows3_ck).
//
// What bounds it. Per base it reads 2 bits of sequence (one byte after the
// unpack) and one byte of the node-start plane, and writes ~24 B per emitted
// minimizer (~2.36/(w+1) of the lanes), so it is far below the card's
// memory bandwidth; the work is integer ALU: building a 62-bit canonical key
// per lane (k steps) and the window-of-w minimum (w compares per lane).
//
// Design. One CUDA block per (row, 8192-lane block); blocks are independent,
// so nothing is carried between them the way the TPU grid carries its dedup
// and node-count state in SMEM:
//   * the previous window of lane 0 is recomputed from one base to the left
//     (the previous block's last lane, or the host-supplied base at
//     start-1 for a row that continues a walk; -1 when it does not);
//   * the node-count base of the block comes in as node_off[row, block]
//     (base_node + exclusive prefix of per-block node-start totals), and the
//     block scans its own node-start plane;
//   * the compaction is a block-wide exclusive scan of per-thread emit
//     counts (warp shuffles, then shared memory); each thread owns 32
//     consecutive lanes, so slot order is lane order (stable).
// Codes, the node prefix and the k-mer keys of the block plus its halo live
// in shared memory (~108 KB, two blocks per SM). The window minimum is the
// direct O(w) scan per lane, and emitted lanes recompute theirs when they
// write: simple and exact first, speed is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 8192;              // lanes per block (BLK in kernels.py)
constexpr int HALO = 128;              // halo lanes (HALO_PAD); k + w - 2 <= HALO
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LPT = BLK / THREADS;     // lanes per thread in the emit pass (32)
constexpr int NS = BLK + HALO;         // lanes of node prefix held per block
constexpr int NK = BLK + HALO + 2;     // k-mer keys held (lanes -1 .. BLK+w-2)
constexpr int NC = BLK + HALO + 1;     // codes held (lanes -1 .. BLK+HALO-1)
constexpr size_t SMEM_BYTES =
    sizeof(unsigned long long) * NK + sizeof(int) * NS + NC;

static_assert(LPT == 32, "one 32-bit emit mask per thread");

// Exclusive block-wide prefix sum of one int per thread; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < WARPS ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? warp_tot[wid - 1] : 0);
  *total = warp_tot[WARPS - 1];
  __syncthreads();
  return excl;
}

// Window of w k-mers starting at lane p (p >= -1): minimum key, ties to the
// rightmost lane. kmer[i] holds the k-mer at lane i - 1.
__device__ __forceinline__ void window_min(const unsigned long long* kmer,
                                           int p, int w,
                                           unsigned long long* key, int* q) {
  unsigned long long best = kmer[p + 1];
  int bq = p;
  for (int j = 1; j < w; ++j) {
    const unsigned long long v = kmer[p + 1 + j];
    if (v <= best) {
      best = v;
      bq = p + j;
    }
  }
  *key = best;
  *q = bq;
}

__global__ void __launch_bounds__(THREADS)
rows3_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ nd,
             const int32_t* __restrict__ nvalid,
             const int32_t* __restrict__ left,
             const int32_t* __restrict__ node_off, long long row_lanes,
             int SB, int k, int w, int C, long long* __restrict__ out_key,
             long long* __restrict__ out_se, int32_t* __restrict__ out_cnt) {
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const long long nv = nvalid[r];
  const long long base_lane = (long long)b * BLK;
  const long long out_off = ((long long)r * SB + b) * C;
  const long long dead_se = 0xFFFFFFFFll;

  if (base_lane >= nv) {  // block wholly past the row's windows
    for (int i = tid; i < C; i += THREADS) {
      out_key[out_off + i] = -1;
      out_se[out_off + i] = dead_se;
    }
    if (tid == 0) out_cnt[r * SB + b] = 0;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* kmer = reinterpret_cast<unsigned long long*>(smem);
  int* scan = reinterpret_cast<int*>(kmer + NK);
  uint8_t* code = reinterpret_cast<uint8_t*>(scan + NS);
  __shared__ int warp_tot[WARPS];

  const uint8_t* crow = codes + (long long)r * row_lanes + base_lane;
  const uint8_t* nrow = nd + (long long)r * row_lanes + base_lane;
  const int lb = left[r];

  // codes at lanes -1 .. BLK+HALO-1 (index = lane + 1) and the node plane
  for (int i = tid; i < NC; i += THREADS) {
    const int lane = i - 1;
    uint8_t c;
    if (lane >= 0) c = crow[lane];
    else if (b > 0) c = crow[-1];
    else c = lb >= 0 ? (uint8_t)lb : (uint8_t)0;
    code[i] = c;
  }
  for (int i = tid; i < NS; i += THREADS) scan[i] = nrow[i];
  __syncthreads();

  // inclusive node-start prefix over the block's lanes (and halo)
  {
    constexpr int SPT = (NS + THREADS - 1) / THREADS;
    const int lo = tid * SPT;
    const int hi = min(lo + SPT, NS);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += scan[i];
    int total;
    int run = block_exclusive_scan(sum, warp_tot, &total);
    for (int i = lo; i < hi; ++i) {
      run += scan[i];
      scan[i] = run;
    }
  }

  // canonical k-mer keys at lanes -1 .. BLK+w-2: min(forward, revcomp) as
  // one 2k-bit integer (same order as the reference's (hi, lo) pair)
  for (int i = tid; i < BLK + w; i += THREADS) {
    unsigned long long f = 0, rc = 0;
    for (int j = 0; j < k; ++j) {
      const unsigned long long c = code[i + j];
      f = (f << 2) | c;
      rc |= (3ull - c) << (2 * j);
    }
    kmer[i] = f < rc ? f : rc;
  }
  __syncthreads();

  // emit flags for this thread's 32 consecutive lanes
  const int p0 = tid * LPT;
  unsigned long long pkey;
  int pq;
  window_min(kmer, p0 - 1, w, &pkey, &pq);
  bool pvalid = (p0 > 0) ? (base_lane + p0 - 1 < nv) : (b > 0 || lb >= 0);
  unsigned mask = 0;
  for (int t = 0; t < LPT; ++t) {
    const int p = p0 + t;
    unsigned long long key;
    int q;
    window_min(kmer, p, w, &key, &q);
    const bool valid = base_lane + p < nv;
    if (valid && (key != pkey || !pvalid)) mask |= 1u << t;
    pkey = key;
    pvalid = valid;
  }

  int total;
  int slot = block_exclusive_scan(__popc(mask), warp_tot, &total);

  const long long nbase = node_off[r * SB + b];
  while (mask) {
    const int t = __ffs(mask) - 1;
    mask &= mask - 1;
    if (slot < C) {
      unsigned long long key;
      int q;
      window_min(kmer, p0 + t, w, &key, &q);
      const long long s = nbase + scan[q];
      const long long e = nbase + scan[q + k - 1];
      const unsigned span = (unsigned)min(e - s, 63ll);
      const unsigned packed = ((unsigned)s << 6) | span;
      out_key[out_off + slot] = (long long)key;
      out_se[out_off + slot] = (long long)packed;
    }
    ++slot;
  }
  // slots past the count (disjoint from the slots written above)
  for (int i = total + tid; i < C; i += THREADS) {
    out_key[out_off + i] = -1;
    out_se[out_off + i] = dead_se;
  }
  if (tid == 0) out_cnt[r * SB + b] = total;
}

}  // namespace

// C entry point (ctypes): launches on `stream` and returns cudaGetLastError().
extern "C" int phi_rows3_launch(const void* codes, const void* nd,
                                const void* nvalid, const void* left,
                                const void* node_off, long long row_lanes,
                                int R, int SB, int k, int w, int C,
                                void* out_key, void* out_se, void* out_cnt,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rows3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(SB, R);
  rows3_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(nd),
      static_cast<const int32_t*>(nvalid), static_cast<const int32_t*>(left),
      static_cast<const int32_t*>(node_off), row_lanes, SB, k, w, C,
      static_cast<long long*>(out_key), static_cast<long long*>(out_se),
      static_cast<int32_t*>(out_cnt));
  return (int)cudaGetLastError();
}
