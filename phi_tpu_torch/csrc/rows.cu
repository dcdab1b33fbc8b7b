// The rows sketch kernel family for Hopper (sm_90a): canonical k-mer
// minimizers of haplotype rows, in five compile-time variants of one
// kernel:
//
//   rows3   k <= 31, one uint64 key, walk-position interval passenger,
//           per-block stable left-compaction of the emitted lanes into C
//           slots plus an exact per-block count;
//   rows3w  31 < k <= 63, a 126-bit key held as two uint64 words compared
//           lexicographically, compacted like rows3;
//   rows2   k <= 31, full-lane output (key, interval, emit flag), no
//           compaction (the caller compacts with a cumsum and a scatter);
//   rows    k <= 31, full-lane output (key, row-local k-mer start, emit
//           flag): no node plane, no interval;
//   seq     rows on codes that may hold N (code >= 4): a k-mer holding one
//           is dead (never selected, so a window of dead k-mers is not
//           valid). The 2-bit rows never hold such a code, so this is a
//           compile-time flag and the other variants do not pay for it.
//
// Replaces, in phi_tpu/sketch/kernels.py, the Pallas TPU kernels
// _make_kernel_rows3 (behind _pallas_join_rows3_ck), _make_kernel_rows3w
// (behind _pallas_join_rows3w_ck), _make_kernel_rows2 (behind
// _pallas_join_rows2 and _pallas_join_rows2_ck), _make_kernel_rows (the v1
// kernel behind _pallas_join_rows and pallas_join_many) and _make_kernel
// (the single-sequence kernel behind pallas_sketch_sequence and
// pallas_join_sequence).
//
// What bounds it. Per base it reads 2 bits of sequence (one byte after the
// unpack) and, for the interval variants, one byte of the node-start plane;
// rows3/rows3w write ~24-40 B per emitted minimizer (~2.36/(w+1) of the
// lanes), rows2 17 B per lane and rows/seq 13 B per lane, all far below the
// card's memory bandwidth. The work is integer ALU: building a 2k-bit
// canonical key per lane (k steps) and the window-of-w minimum (w compares
// per lane, twice as many word compares for rows3w).
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
//     counts (warp shuffles, then shared memory); each thread owns LPT
//     consecutive lanes, so slot order is lane order (stable);
//   * the full-lane variants keep the per-thread emit masks in shared
//     memory and write their outputs in a second, coalesced pass.
// Codes, the node prefix and the k-mer keys of the block plus its halo live
// in shared memory: ~108 KB with 8-byte keys (two blocks of 256 threads per
// SM; ~75 KB for rows/seq, which hold no node prefix), ~175 KB with
// rows3w's 16-byte keys (one block per SM, so rows3w runs 512 threads a
// block). The window minimum is the direct O(w) scan per lane, and emitted
// lanes recompute theirs when they write: simple and exact first, speed is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int BLK = 8192;              // lanes per block (BLK in kernels.py)
constexpr int HALO = 128;              // halo lanes (HALO_PAD); k + w - 2 <= HALO
constexpr int NS = BLK + HALO;         // lanes of node prefix held per block
constexpr int NK = BLK + HALO + 2;     // k-mer keys held (lanes -1 .. BLK+w-2)
constexpr int NC = BLK + HALO + 1;     // codes held (lanes -1 .. BLK+HALO-1)
constexpr long long DEAD_SE = 0xFFFFFFFFll;
constexpr u64 DEAD_KEY = ~0ull;        // a dead k-mer (seq): never selected

// A 126-bit canonical key: the 2k-bit big-endian packing of the k-mer, hi
// holding bits 64..125 (the native __int128 layout of phi_native.cpp).
struct Key128 {
  u64 hi, lo;
};

__device__ __forceinline__ bool key_le(u64 a, u64 b) { return a <= b; }
__device__ __forceinline__ bool key_le(const Key128& a, const Key128& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo <= b.lo);
}
__device__ __forceinline__ bool key_ne(u64 a, u64 b) { return a != b; }
__device__ __forceinline__ bool key_ne(const Key128& a, const Key128& b) {
  return a.hi != b.hi || a.lo != b.lo;
}

// min(forward, reverse complement) of the k bases at code[0..k-1]; with
// NCODE, DEAD_KEY when one of them is N (code >= 4, masked to 2 bits before
// the complement so 3 - c cannot underflow)
template <bool NCODE>
__device__ __forceinline__ void canonical(const uint8_t* code, int k,
                                          u64* out) {
  u64 f = 0, rc = 0;
  bool dead = false;
  for (int j = 0; j < k; ++j) {
    u64 c = code[j];
    if constexpr (NCODE) {
      dead |= c > 3;
      c &= 3;
    }
    f = (f << 2) | c;
    rc |= (3ull - c) << (2 * j);
  }
  *out = (NCODE && dead) ? DEAD_KEY : (f < rc ? f : rc);
}
template <bool NCODE>
__device__ __forceinline__ void canonical(const uint8_t* code, int k,
                                          Key128* out) {
  static_assert(!NCODE, "the 126-bit key has no dead-k-mer variant");
  Key128 f{0, 0}, rc{0, 0};
  for (int j = 0; j < k; ++j) {
    const u64 c = code[j];
    f.hi = (f.hi << 2) | (f.lo >> 62);
    f.lo = (f.lo << 2) | c;
    const int sh = 2 * j;
    if (sh < 64) rc.lo |= (3ull - c) << sh;
    else rc.hi |= (3ull - c) << (sh - 64);
  }
  *out = key_le(f, rc) ? f : rc;
}

__device__ __forceinline__ void store_key(long long* hi, long long*, long long i,
                                          u64 key) {
  hi[i] = (long long)key;
}
__device__ __forceinline__ void store_key(long long* hi, long long* lo,
                                          long long i, const Key128& key) {
  hi[i] = (long long)key.hi;
  lo[i] = (long long)key.lo;
}
__device__ __forceinline__ void store_dead(long long* hi, long long* lo,
                                           long long i, bool wide) {
  hi[i] = -1;
  if (wide) lo[i] = -1;
}

// Exclusive block-wide prefix sum of one int per thread; *total gets the sum.
template <int THREADS>
__device__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  constexpr int WARPS = THREADS / 32;
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
template <typename K>
__device__ __forceinline__ void window_min(const K* kmer, int p, int w,
                                           K* key, int* q) {
  K best = kmer[p + 1];
  int bq = p;
  for (int j = 1; j < w; ++j) {
    const K v = kmer[p + 1 + j];
    if (key_le(v, best)) {
      best = v;
      bq = p + j;
    }
  }
  *key = best;
  *q = bq;
}

// Whether a selected key is a live k-mer: only NCODE keys can be dead (a
// live k <= 31 key is below 2^62, so it never equals DEAD_KEY).
template <bool NCODE, typename K>
__device__ __forceinline__ bool live(const K& key) {
  if constexpr (NCODE) return key != DEAD_KEY;
  else return true;
}

struct RowsIn {
  const uint8_t* codes;
  const uint8_t* nd;
  const int32_t* nvalid;
  const int32_t* left;      // null: no row continues a walk
  const int32_t* node_off;
  long long row_lanes;
  int SB, k, w, C;
};

// Compacted variants fill key_hi/key_lo/se [R, SB*C] and cnt [R, SB];
// the full-lane variants fill key_hi and se or pos [R, SB*BLK] and emit
// [R, SB*BLK].
struct RowsOut {
  long long* key_hi;
  long long* key_lo;  // rows3w only
  long long* se;      // interval variants
  int32_t* cnt;       // compacted only
  uint8_t* emit;      // full-lane only
  int32_t* pos;       // position variants (rows, seq)
};

// K: key type; COMPACT: C-slot output (else full lanes); POS: the selected
// k-mer's row-local start rides along (else its walk-position interval,
// from the node plane); NCODE: codes may hold N.
template <typename K, bool COMPACT, bool POS, bool NCODE, int THREADS>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const RowsIn in, const RowsOut out) {
  constexpr int LPT = BLK / THREADS;   // lanes per thread in the emit pass
  constexpr bool WIDE = sizeof(K) > sizeof(u64);
  static_assert(LPT <= 32, "one 32-bit emit mask per thread");
  static_assert(!(COMPACT && POS), "compaction carries the interval");
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int k = in.k, w = in.w, C = in.C, SB = in.SB;
  const long long nv = in.nvalid[r];
  const long long base_lane = (long long)b * BLK;
  const long long blk = (long long)r * SB + b;
  const long long out_off = blk * (COMPACT ? C : BLK);
  const int n_out = COMPACT ? C : BLK;

  if (base_lane >= nv) {  // block wholly past the row's windows
    for (int i = tid; i < n_out; i += THREADS) {
      store_dead(out.key_hi, out.key_lo, out_off + i, WIDE);
      if constexpr (POS) out.pos[out_off + i] = -1;
      else out.se[out_off + i] = DEAD_SE;
      if constexpr (!COMPACT) out.emit[out_off + i] = 0;
    }
    if constexpr (COMPACT) {
      if (tid == 0) out.cnt[blk] = 0;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  K* kmer = reinterpret_cast<K*>(smem);
  int* scan = reinterpret_cast<int*>(kmer + NK);      // node prefix (!POS)
  uint8_t* code = reinterpret_cast<uint8_t*>(scan + (POS ? 0 : NS));
  __shared__ int warp_tot[THREADS / 32];
  __shared__ unsigned masks[COMPACT ? 1 : THREADS];

  const uint8_t* crow = in.codes + (long long)r * in.row_lanes + base_lane;
  const int lb = in.left ? in.left[r] : -1;

  // codes at lanes -1 .. BLK+HALO-1 (index = lane + 1) and the node plane
  for (int i = tid; i < NC; i += THREADS) {
    const int lane = i - 1;
    uint8_t c;
    if (lane >= 0) c = crow[lane];
    else if (b > 0) c = crow[-1];
    else c = lb >= 0 ? (uint8_t)lb : (uint8_t)0;
    code[i] = c;
  }
  if constexpr (!POS) {
    const uint8_t* nrow = in.nd + (long long)r * in.row_lanes + base_lane;
    for (int i = tid; i < NS; i += THREADS) scan[i] = nrow[i];
  }
  __syncthreads();

  // inclusive node-start prefix over the block's lanes (and halo)
  if constexpr (!POS) {
    constexpr int SPT = (NS + THREADS - 1) / THREADS;
    const int lo = tid * SPT;
    const int hi = min(lo + SPT, NS);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += scan[i];
    int total;
    int run = block_exclusive_scan<THREADS>(sum, warp_tot, &total);
    for (int i = lo; i < hi; ++i) {
      run += scan[i];
      scan[i] = run;
    }
  }

  // canonical k-mer keys at lanes -1 .. BLK+w-2, in the reference's order
  for (int i = tid; i < BLK + w; i += THREADS)
    canonical<NCODE>(code + i, k, &kmer[i]);
  __syncthreads();

  // emit flags for this thread's LPT consecutive lanes
  const int p0 = tid * LPT;
  K pkey;
  int pq;
  window_min(kmer, p0 - 1, w, &pkey, &pq);
  bool pvalid = ((p0 > 0) ? (base_lane + p0 - 1 < nv) : (b > 0 || lb >= 0))
                && live<NCODE>(pkey);
  unsigned mask = 0;
  for (int t = 0; t < LPT; ++t) {
    const int p = p0 + t;
    K key;
    int q;
    window_min(kmer, p, w, &key, &q);
    const bool valid = base_lane + p < nv && live<NCODE>(key);
    if (valid && (key_ne(key, pkey) || !pvalid)) mask |= 1u << t;
    pkey = key;
    pvalid = valid;
  }

  const long long nbase = POS ? 0 : in.node_off[blk];
  auto packed_se = [&](int q) -> long long {
    const long long s = nbase + scan[q];
    const long long e = nbase + scan[q + k - 1];
    const unsigned span = (unsigned)min(e - s, 63ll);
    return (long long)(((unsigned)s << 6) | span);
  };

  if constexpr (!COMPACT) {
    // full lanes, coalesced: lane p's flag is bit p % LPT of masks[p / LPT]
    masks[tid] = mask;
    __syncthreads();
    for (int p = tid; p < BLK; p += THREADS) {
      const long long o = out_off + p;
      K key;
      int q = 0;
      bool ok = base_lane + p < nv;
      if (ok) {
        window_min(kmer, p, w, &key, &q);
        ok = live<NCODE>(key);
      }
      if (ok) {
        store_key(out.key_hi, out.key_lo, o, key);
        if constexpr (POS) out.pos[o] = (int32_t)(base_lane + q);
        else out.se[o] = packed_se(q);
      } else {
        store_dead(out.key_hi, out.key_lo, o, WIDE);
        if constexpr (POS) out.pos[o] = -1;
        else out.se[o] = DEAD_SE;
      }
      out.emit[o] = (uint8_t)((masks[p / LPT] >> (p % LPT)) & 1u);
    }
  } else {
    int total;
    int slot = block_exclusive_scan<THREADS>(__popc(mask), warp_tot, &total);
    while (mask) {
      const int t = __ffs(mask) - 1;
      mask &= mask - 1;
      if (slot < C) {
        K key;
        int q;
        window_min(kmer, p0 + t, w, &key, &q);
        store_key(out.key_hi, out.key_lo, out_off + slot, key);
        out.se[out_off + slot] = packed_se(q);
      }
      ++slot;
    }
    // slots past the count (disjoint from the slots written above)
    for (int i = total + tid; i < C; i += THREADS) {
      store_dead(out.key_hi, out.key_lo, out_off + i, WIDE);
      out.se[out_off + i] = DEAD_SE;
    }
    if (tid == 0) out.cnt[blk] = total;
  }
}

template <typename K, bool COMPACT, bool POS, bool NCODE, int THREADS>
int launch(const RowsIn& in, const RowsOut& out, int R, void* stream) {
  constexpr size_t smem = sizeof(K) * NK + (POS ? 0 : sizeof(int) * NS) + NC;
  auto* kern = rows_kernel<K, COMPACT, POS, NCODE, THREADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(in.SB, R);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(in, out);
  return (int)cudaGetLastError();
}

RowsIn rows_in(const void* codes, const void* nd, const void* nvalid,
               const void* left, const void* node_off, long long row_lanes,
               int SB, int k, int w, int C) {
  return RowsIn{static_cast<const uint8_t*>(codes),
                static_cast<const uint8_t*>(nd),
                static_cast<const int32_t*>(nvalid),
                static_cast<const int32_t*>(left),
                static_cast<const int32_t*>(node_off),
                row_lanes, SB, k, w, C};
}

}  // namespace

// C entry points (ctypes): each launches on `stream` and returns
// cudaGetLastError().
extern "C" int phi_rows3_launch(const void* codes, const void* nd,
                                const void* nvalid, const void* left,
                                const void* node_off, long long row_lanes,
                                int R, int SB, int k, int w, int C,
                                void* out_key, void* out_se, void* out_cnt,
                                void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr,
                    static_cast<long long*>(out_se),
                    static_cast<int32_t*>(out_cnt), nullptr, nullptr};
  return launch<u64, true, false, false, 256>(
      rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, C), out,
      R, stream);
}

extern "C" int phi_rows3w_launch(const void* codes, const void* nd,
                                 const void* nvalid, const void* left,
                                 const void* node_off, long long row_lanes,
                                 int R, int SB, int k, int w, int C,
                                 void* out_hi, void* out_lo, void* out_se,
                                 void* out_cnt, void* stream) {
  const RowsOut out{static_cast<long long*>(out_hi),
                    static_cast<long long*>(out_lo),
                    static_cast<long long*>(out_se),
                    static_cast<int32_t*>(out_cnt), nullptr, nullptr};
  return launch<Key128, true, false, false, 512>(
      rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, C), out,
      R, stream);
}

extern "C" int phi_rows2_launch(const void* codes, const void* nd,
                                const void* nvalid, const void* left,
                                const void* node_off, long long row_lanes,
                                int R, int SB, int k, int w, void* out_key,
                                void* out_se, void* out_emit, void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr,
                    static_cast<long long*>(out_se), nullptr,
                    static_cast<uint8_t*>(out_emit), nullptr};
  return launch<u64, false, false, false, 256>(
      rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, 0), out,
      R, stream);
}

// rows (2-bit codes) and seq (codes that may hold N): no node plane, the
// selected k-mer's row-local start rides along; left may be null for seq.
extern "C" int phi_rows_launch(const void* codes, const void* nvalid,
                               const void* left, long long row_lanes, int R,
                               int SB, int k, int w, void* out_key,
                               void* out_pos, void* out_emit, void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr, nullptr,
                    nullptr, static_cast<uint8_t*>(out_emit),
                    static_cast<int32_t*>(out_pos)};
  return launch<u64, false, true, false, 256>(
      rows_in(codes, nullptr, nvalid, left, nullptr, row_lanes, SB, k, w, 0),
      out, R, stream);
}

extern "C" int phi_seq_launch(const void* codes, const void* nvalid,
                              const void* left, long long row_lanes, int R,
                              int SB, int k, int w, void* out_key,
                              void* out_pos, void* out_emit, void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr, nullptr,
                    nullptr, static_cast<uint8_t*>(out_emit),
                    static_cast<int32_t*>(out_pos)};
  return launch<u64, false, true, true, 256>(
      rows_in(codes, nullptr, nvalid, left, nullptr, row_lanes, SB, k, w, 0),
      out, R, stream);
}
