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
// lanes), rows2 17 B per lane and rows/seq 13 B per lane. Against the
// card's 3.35 TB/s and its INT32 rate, the full-lane variants and rows3 are
// bound by those bytes and rows3w, whose 126-bit key doubles the key and
// compare work, by its operations: a rolling key (O(1) per lane) and
// log2(w) + 1 doubling steps of a tuple minimum.
//
// The kernel runs one CUDA block per (row, 8192-lane block); blocks are
// independent, so nothing is carried between them the way the TPU grid
// carries its dedup and node-count state in SMEM:
//   * the previous window of lane 0 is recomputed from one base to the left
//     (the previous block's last lane, or the host-supplied base at
//     start-1 for a row that continues a walk; -1 when it does not);
//   * the node-count base of the block comes in as node_off[row, block]
//     (base_node + exclusive prefix of per-block node-start totals), and the
//     block scans its own node-start plane.
//
// The tiled design (tiled_kernel, all five variants) takes the TPU
// kernel's algorithm and lays it out for warps. The block walks its 8192
// lanes in tiles of TILE = 1024 lanes, each with a right halo of k + w - 2
// lanes; consecutive lanes sit on consecutive threads at every stage, so
// no warp reads shared memory at a conflicting stride:
//   * the block's codes (lanes -1 .. 8383) are packed once, 2 bits a base,
//     into a big-endian stream and a little-endian stream of complemented
//     bases (4 KB; one thread per 32-base word, from two 16-byte loads, so
//     codes must be 16-byte aligned); a lane's forward and
//     reverse-complement keys are funnel shifts of two (k <= 31) or three
//     (k > 31) words of each, O(1) per lane;
//   * seq (NCODE) packs a third stream of one dead bit per base (1 KB),
//     laid out as the bases: a k-mer is dead when one of its k bits is
//     set, a funnel shift of two words and a mask, O(1) per lane, and a
//     dead k-mer's key is DEAD_KEY, above every live key;
//   * the window minimum is the tuple (key, lane) minimum with ties to the
//     rightmost lane, by log-doubling (floor(log2 w) steps, then one
//     combine of two overlapping windows); the order is total, so this
//     selects what a scan of each window would select, once per lane; a
//     window whose minimum is DEAD_KEY holds no live k-mer and is not
//     valid;
//   * the node prefix is a block-wide scan per tile, carried from tile to
//     tile as a running sum; rows and seq, whose passenger is the selected
//     k-mer's row-local start (POS), read no node plane and hold no
//     prefix;
//   * emit flags are computed in parallel, one lane per thread, from the
//     selections of lanes p and p - 1 (lane P0 - 1 of a tile is one more
//     window of the tile, so no selection is carried);
//   * rows2, rows and seq write full lanes, coalesced; rows3 and rows3w
//     compact in lane order, a __ballot_sync and __popc per warp and round,
//     one warp's scan of the tile's 32 warp counts, and a running block
//     offset.
// Shared memory is ~31 KB with 8-byte keys and the node prefix (rows3,
// rows2), ~27 KB without it (rows; ~28 KB for seq with its dead bits) and
// ~49 KB with 16-byte keys (rows3w): at 48 registers, four blocks of 256
// threads fit on an SM for rows3w and five for the others. rows3 is an
// instantiation of the design as rows3w and rows2 run it, with nothing
// tuned. rows and seq ask ptxas for five resident blocks (tiled_minb):
// left at four, ptxas spent more registers on rows and fit four, and it
// ran slower when the two builds were timed in turns.
// What keeps the design from its bound is the shared-memory traffic of the
// doubling passes (each key and entry read twice and written once per
// pass) and the block barrier that ends each pass, neither of which the
// bound counts. The kernel is its stages in a row (TiledBlock);
// the stage cuts that time them are separate kernels in rows_stages.cu,
// which the library the wrappers load does not hold. The tensor cores
// (wgmma) have no work here, since the kernel compares integers and
// multiplies no matrices; TMA or cp.async staging would hide the load of
// 2-3 bytes per lane, which the bound counts as a few percent of the bytes
// moved, so neither is used.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int BLK = 8192;              // lanes per block (BLK in kernels.py)
constexpr int HALO = 128;              // halo lanes (HALO_PAD); k + w - 2 <= HALO
constexpr long long DEAD_SE = 0xFFFFFFFFll;
// a dead k-mer (seq): above every live key (k <= 31: below 2^62), so a
// window selects it only when all its k-mers are dead
constexpr u64 DEAD_KEY = ~0ull;

__device__ __forceinline__ bool key_le(u64 a, u64 b) { return a <= b; }
__device__ __forceinline__ bool key_ne(u64 a, u64 b) { return a != b; }

__device__ __forceinline__ void store_key(long long* hi, long long*, long long i,
                                          u64 key) {
  hi[i] = (long long)key;
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

// A 126-bit key laid out for one 16-byte shared-memory access per lane.
struct __align__(16) Key128v {
  u64 hi, lo;
};
__device__ __forceinline__ bool key_le(const Key128v& a, const Key128v& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo <= b.lo);
}
__device__ __forceinline__ bool key_ne(const Key128v& a, const Key128v& b) {
  return a.hi != b.hi || a.lo != b.lo;
}
__device__ __forceinline__ void store_key(long long* hi, long long* lo,
                                          long long i, const Key128v& key) {
  hi[i] = (long long)key.hi;
  lo[i] = (long long)key.lo;
}

constexpr int TILE = 1024;              // lanes per tile
constexpr int TTHREADS = 256;           // threads of a tiled block
// Resident tiled blocks per SM asked of ptxas: four, and five for rows
// (POS), which would otherwise get more registers and fit only four.
constexpr int tiled_minb(bool pos) { return pos ? 5 : 4; }
constexpr int TK = TILE + HALO + 2;     // keys per tile: lanes P0-1 ..
                                        //   P0+TILE+w-2 of tile P0
constexpr int TS = TILE + HALO;         // node prefix per tile: lanes P0 ..
// packed 32-base words: a key reads words s/32 .. s/32 + 2 for s up to
// BLK + w - 2 + 32, w <= HALO + 1
constexpr int NW = (BLK + HALO + 31) / 32 + 3;

// The top 64 bits of the 128-bit a:b shifted left by sh (0 <= sh < 64),
// and the low 64 bits of b:a shifted right by sh.
__device__ __forceinline__ u64 shl_in(u64 a, u64 b, int sh) {
  return (a << sh) | ((b >> 1) >> (63 - sh));
}
__device__ __forceinline__ u64 shr_in(u64 a, u64 b, int sh) {
  return (a >> sh) | ((b << 1) << (63 - sh));
}

// Whether one of the k <= 31 bases from stream position s is N: dw holds the
// dead bit of base s at bit s % 32 of word s / 32.
__device__ __forceinline__ bool dead_kmer(const uint32_t* dw, int s, int k) {
  const int m = s >> 5;
  const u64 x = dw[m] | ((u64)dw[m + 1] << 32);
  return (x >> (s & 31)) & ((1ull << k) - 1);
}

// Canonical key of the k bases from stream position s: fw holds base s at
// bits 62 - 2(s % 32) of word s / 32, rv its complement at bits 2(s % 32).
__device__ __forceinline__ void packed_key(const u64* fw, const u64* rv,
                                           int s, int k, u64* out) {
  const int m = s >> 5, sh = 2 * (s & 31);
  const u64 f = shl_in(fw[m], fw[m + 1], sh) >> (64 - 2 * k);
  const u64 r = shr_in(rv[m], rv[m + 1], sh) & ((1ull << (2 * k)) - 1);
  *out = f < r ? f : r;
}
__device__ __forceinline__ void packed_key(const u64* fw, const u64* rv,
                                           int s, int k, Key128v* out) {
  const int m = s >> 5, sh = 2 * (s & 31);
  const u64 t_hi = shl_in(fw[m], fw[m + 1], sh);
  const u64 t_lo = shl_in(fw[m + 1], fw[m + 2], sh);
  const int r = 128 - 2 * k;  // 2 .. 64
  const Key128v f{(t_hi >> 1) >> (r - 1),
                  ((t_lo >> 1) >> (r - 1)) | (t_hi << (64 - r))};
  const Key128v rc{shr_in(rv[m + 1], rv[m + 2], sh) &
                       ((1ull << (2 * k - 64)) - 1),
                   shr_in(rv[m], rv[m + 1], sh)};
  *out = key_le(f, rc) ? f : rc;
}

// One block of the tiled design: its state, and its stages in the order
// tiled_kernel runs them (pack; for each tile keys_and_prefix, window_min,
// output, next_tile; finish). K: u64 (k <= 31) or Key128v (31 < k <= 63);
// COMPACT: C-slot output (else full lanes); POS: the selected k-mer's
// row-local start rides along (else its walk-position interval, from the
// node plane, which POS never reads); NCODE (seq): codes may hold N, packed
// as a third stream of one dead bit per base.
template <typename K, bool COMPACT, bool POS, bool NCODE>
struct TiledBlock {
  static constexpr int THREADS = TTHREADS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int RPT = TILE / THREADS;  // rounds of one lane per thread
  static constexpr bool WIDE = sizeof(K) > sizeof(u64);
  static_assert(RPT * WARPS <= 32, "one warp scans a tile's warp counts");
  static_assert(TILE % THREADS == 0 && BLK % TILE == 0, "whole tiles");
  static_assert(!(COMPACT && POS), "compaction carries the interval");
  static_assert(!NCODE || (POS && !WIDE), "N codes: seq only");

  // the kernel's __grid_constant__ parameter: its pointers are read from
  // the parameter bank where they are used (a copy here holds them in
  // registers, which cost rows2 three registers and a resident block)
  const RowsOut& out;
  const int tid, lane, wid, k, w, C, lb;
  const long long blk, out_off;
  const long long nvb;         // valid lanes of the block
  const int32_t* const node_off;
  const uint8_t* const crow;   // the block's codes and node plane (null
  const uint8_t* const nrow;   //   under POS)
  K* const ka;                 // shared memory: keys, two buffers
  K* const kb;
  int* const sc;               // the tile's node prefix (none under POS)
  u64* const fw;               // the block's packed codes, both streams
  u64* const rv;
  uint16_t* const pa;          // the keys' entries, two buffers
  uint16_t* const pb;
  uint32_t* const dw;          // NCODE: the dead bits, as fw lays out bases
  int* const warp_tot;
  int* const wofs;
  long long nbase = 0;         // node count before the block (pack)
  int carry = 0;               // node starts before the tile
  int slot0 = 0;               // emitted lanes before the tile
  const K* src = nullptr;      // after window_min: src[i], ps[i] are the
  const uint16_t* ps = nullptr;  // selection of the window at lane P0-1+i

  __device__ __forceinline__ TiledBlock(const RowsIn& in, const RowsOut& o,
                                        unsigned char* smem, int* wt,
                                        int* wo)
      : out(o), tid(threadIdx.x), lane(threadIdx.x & 31),
        wid(threadIdx.x >> 5), k(in.k), w(in.w), C(in.C),
        lb(in.left ? in.left[blockIdx.y] : -1),
        blk((long long)blockIdx.y * in.SB + blockIdx.x),
        out_off(blk * (COMPACT ? in.C : BLK)),
        nvb(in.nvalid[blockIdx.y] - (long long)blockIdx.x * BLK),
        node_off(in.node_off),
        crow(in.codes + (long long)blockIdx.y * in.row_lanes +
             (long long)blockIdx.x * BLK),
        nrow(POS ? nullptr
                 : in.nd + (long long)blockIdx.y * in.row_lanes +
                       (long long)blockIdx.x * BLK),
        ka(reinterpret_cast<K*>(smem)), kb(ka + TK),
        sc(reinterpret_cast<int*>(kb + TK)),
        fw(reinterpret_cast<u64*>(sc + (POS ? 0 : TS))), rv(fw + NW),
        pa(reinterpret_cast<uint16_t*>(rv + NW)), pb(pa + TK),
        dw(NCODE ? reinterpret_cast<uint32_t*>(pb + TK) : nullptr),
        warp_tot(wt), wofs(wo) {}

  __device__ __forceinline__ void dead_passenger(long long o) const {
    if constexpr (POS) out.pos[o] = -1;
    else out.se[o] = DEAD_SE;
  }

  __device__ __forceinline__ void dead(long long o) const {
    store_dead(out.key_hi, out.key_lo, o, WIDE);
    dead_passenger(o);
    if constexpr (!COMPACT) out.emit[o] = 0;
  }

  // A block wholly past the row's windows writes its dead outputs.
  __device__ __forceinline__ bool past_block() const {
    if (nvb > 0) return false;
    for (int i = tid; i < (COMPACT ? C : BLK); i += THREADS) dead(out_off + i);
    if constexpr (COMPACT) {
      if (tid == 0) out.cnt[blk] = 0;
    }
    return true;
  }

  // Pack the codes, one word per thread from two 16-byte loads: word m > 0
  // holds lanes 32(m-1) .. 32m-1 (lane L is stream position L + 32), word
  // 0 only lane -1; lanes past the halo feed bits that are shifted out.
  // Under NCODE a code >= 4 (N) packs as its low two bits, as the 2-bit
  // streams must, and sets its base's dead bit.
  // The block's node count is read after it, so that it takes no register
  // while the packing runs.
  __device__ __forceinline__ void pack() {
    for (int m = tid; m < NW; m += THREADS) {
      u64 f, rc;
      if (m > 0) {
        const uint4* s = reinterpret_cast<const uint4*>(crow + 32 * (m - 1));
        const uint4 v0 = s[0], v1 = s[1];
        const unsigned x[8] = {v0.x, v0.y, v0.z, v0.w,
                               v1.x, v1.y, v1.z, v1.w};
        f = rc = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const u64 c = (x[i >> 2] >> (8 * (i & 3))) & 3u;
          f |= c << (62 - 2 * i);
          rc |= (3u - c) << (2 * i);
        }
        if constexpr (NCODE) {
          unsigned d = 0;
#pragma unroll
          for (int i = 0; i < 32; ++i)
            d |= (unsigned)(((x[i >> 2] >> (8 * (i & 3))) & 0xFCu) != 0) << i;
          dw[m] = d;
        }
      } else {
        const u64 c0 =
            blockIdx.x > 0 ? crow[-1] : (lb >= 0 ? (unsigned)lb : 0u);
        if constexpr (NCODE) dw[0] = (unsigned)(c0 > 3) << 31;  // lane -1
        const u64 c = NCODE ? c0 & 3u : c0;
        f = c;
        rc = (3u - c) << 62;
      }
      fw[m] = f;
      rv[m] = rc;
    }
    __syncthreads();
    if constexpr (!POS) nbase = node_off[blk];
  }

  // Whether the block's windows end before tile P0; the full-lane variants
  // then write the rest of the block dead.
  __device__ __forceinline__ bool past_tile(int P0) const {
    if (P0 < nvb) return false;
    if constexpr (!COMPACT) {
      for (int p = P0 + tid; p < BLK; p += THREADS) dead(out_off + p);
    }
    return true;
  }

  // Entry i = lane - P0 + 1: the keys of lanes P0-1 .. P0+TILE+w-2 with
  // their entry (under NCODE, DEAD_KEY for a k-mer holding N, so it is
  // never selected), and (not under POS) the inclusive node-start prefix
  // of lanes P0 .. P0+TS-1 counted from lane 0 of the block.
  __device__ __forceinline__ void keys_and_prefix(int P0) const {
    for (int i = tid; i < TILE + w; i += THREADS) {
      if constexpr (NCODE) {
        const int s = P0 + i + 31;
        u64 key;
        packed_key(fw, rv, s, k, &key);
        ka[i] = dead_kmer(dw, s, k) ? DEAD_KEY : key;
      } else {
        packed_key(fw, rv, P0 + i + 31, k, &ka[i]);
      }
      pa[i] = (uint16_t)i;
    }
    if constexpr (POS) {
      __syncthreads();  // the keys, before the first doubling step
    } else {
      for (int i = tid; i < TS; i += THREADS) sc[i] = nrow[P0 + i];
      __syncthreads();
      constexpr int SPT = (TS + THREADS - 1) / THREADS;  // odd: no conflicts
      const int lo = tid * SPT;
      const int hi = min(lo + SPT, TS);
      int sum = 0;
      for (int i = lo; i < hi; ++i) sum += sc[i];
      int total;
      int run = carry + block_exclusive_scan<THREADS>(sum, warp_tot, &total);
      for (int i = lo; i < hi; ++i) {
        run += sc[i];
        sc[i] = run;
      }
    }
  }

  // The window minimum by log-doubling: after the steps, a buffer's entry i
  // is the (key, entry) minimum of entries i .. i+s-1, ties to the
  // rightmost; a last combine of two overlapping windows of s covers w.
  __device__ __forceinline__ void window_min() {
    K* s_k = ka;
    K* d_k = kb;
    uint16_t* s_p = pa;
    uint16_t* d_p = pb;
    int n = TILE + w, s = 1;
    for (; 2 * s <= w; s *= 2) {
      n -= s;
      for (int i = tid; i < n; i += THREADS) {
        const K x = s_k[i], y = s_k[i + s];
        const bool right = key_le(y, x);
        d_k[i] = right ? y : x;
        d_p[i] = right ? s_p[i + s] : s_p[i];
      }
      __syncthreads();
      K* t = s_k; s_k = d_k; d_k = t;
      uint16_t* u = s_p; s_p = d_p; d_p = u;
    }
    if (w > s) {
      const int d = w - s;
      for (int i = tid; i <= TILE; i += THREADS) {
        K x = s_k[i];
        uint16_t q = s_p[i];
        const K y = s_k[i + d];
        if (key_le(y, x)) {
          x = y;
          q = s_p[i + d];
        }
        d_k[i] = x;
        d_p[i] = q;
      }
      __syncthreads();
      s_k = d_k;
      s_p = d_p;
    }
    // w = 1 runs no step above to publish the node prefix
    if (!POS && w == 1) __syncthreads();
    src = s_k;
    ps = s_p;
  }

  __device__ __forceinline__ long long packed_se(int i) const {
    const int q = ps[i] - 1;  // the selected k-mer's lane - P0
    const long long s0 = nbase + sc[q];
    const long long e = nbase + sc[q + k - 1];
    const unsigned span = (unsigned)min(e - s0, 63ll);
    return (long long)(((unsigned)s0 << 6) | span);
  }

  // The passenger of the window at entry i of tile P0 into output o: the
  // packed interval, or under POS the selected k-mer's row-local start.
  __device__ __forceinline__ void passenger(long long o, int P0,
                                            int i) const {
    if constexpr (POS) {
      out.pos[o] = (int32_t)(blockIdx.x * BLK + P0 + ps[i] - 1);
    } else {
      out.se[o] = packed_se(i);
    }
  }

  // Lane p = P0 + j (window j + 1) emits when it is valid and its
  // selection differs from lane p - 1's or lane p - 1 is not valid. Under
  // NCODE a window whose k-mers all hold N (its minimum is DEAD_KEY) is not
  // valid; a live selection differs from a dead one, so lane p - 1's
  // liveness needs no test of its own.
  __device__ __forceinline__ bool emits(int P0, int p) const {
    const int j = p - P0;
    const bool pvalid = p > 0 ? p - 1 < nvb : (blockIdx.x > 0 || lb >= 0);
    if constexpr (NCODE) {
      return p < nvb && src[j + 1] != DEAD_KEY &&
             (src[j + 1] != src[j] || !pvalid);
    } else {
      return p < nvb && (key_ne(src[j + 1], src[j]) || !pvalid);
    }
  }

  // Full lanes (rows2, rows), coalesced; or (rows3, rows3w) the emitted
  // lanes compacted in lane order (rounds, then warps, then lanes) after
  // the slots of earlier tiles.
  __device__ __forceinline__ void output(int P0) {
    if constexpr (!COMPACT) {
      for (int j = tid; j < TILE; j += THREADS) {
        const int p = P0 + j;
        const long long o = out_off + p;
        bool ok = p < nvb;
        if constexpr (NCODE) ok = ok && src[j + 1] != DEAD_KEY;
        if (ok) {
          store_key(out.key_hi, out.key_lo, o, src[j + 1]);
          passenger(o, P0, j + 1);
        } else {
          store_dead(out.key_hi, out.key_lo, o, WIDE);
          dead_passenger(o);
        }
        out.emit[o] = (uint8_t)emits(P0, p);
      }
    } else {
      unsigned before[RPT];
      bool em[RPT];
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        em[t] = emits(P0, P0 + tid + t * THREADS);
        const unsigned ball = __ballot_sync(~0u, em[t]);
        before[t] = __popc(ball & ((1u << lane) - 1u));
        if (lane == 0) wofs[t * WARPS + wid] = __popc(ball);
      }
      __syncthreads();
      if (wid == 0) {
        const int v = lane < RPT * WARPS ? wofs[lane] : 0;
        int x = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(~0u, x, o);
          if (lane >= o) x += y;
        }
        if (lane < RPT * WARPS) wofs[lane] = x - v;
        if (lane == 31) warp_tot[0] = x;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        const int slot = slot0 + wofs[t * WARPS + wid] + (int)before[t];
        if (em[t] && slot < C) {
          const int i = tid + t * THREADS + 1;
          store_key(out.key_hi, out.key_lo, out_off + slot, src[i]);
          out.se[out_off + slot] = packed_se(i);
        }
      }
      slot0 += warp_tot[0];
    }
  }

  __device__ __forceinline__ void next_tile() {
    if constexpr (!POS) carry = sc[TILE - 1];
    __syncthreads();  // the next tile overwrites the shared arrays
  }

  // rows3, rows3w: the slots past the count (disjoint from the slots
  // written above), and the count.
  __device__ __forceinline__ void finish() const {
    if constexpr (COMPACT) {
      for (int i = slot0 + tid; i < C; i += THREADS) dead(out_off + i);
      if (tid == 0) out.cnt[blk] = slot0;
    }
  }
};

template <typename K, bool POS, bool NCODE>
constexpr size_t tiled_smem() {
  return 2 * sizeof(K) * TK + (POS ? 0 : sizeof(int) * TS) +
         2 * sizeof(u64) * NW + 2 * sizeof(uint16_t) * TK +
         (NCODE ? sizeof(uint32_t) * NW : 0);
}

template <typename K, bool COMPACT, bool POS, bool NCODE>
__global__ void __launch_bounds__(TTHREADS, tiled_minb(POS))
tiled_kernel(const __grid_constant__ RowsIn in,
             const __grid_constant__ RowsOut out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[TTHREADS / 32];
  __shared__ int wofs[COMPACT ? 32 : 1];
  TiledBlock<K, COMPACT, POS, NCODE> t(in, out, smem, warp_tot, wofs);
  if (t.past_block()) return;
  t.pack();
  for (int P0 = 0; P0 < BLK && !t.past_tile(P0); P0 += TILE) {
    t.keys_and_prefix(P0);
    t.window_min();
    t.output(P0);
    t.next_tile();
  }
  t.finish();
}

// A kernel instantiation with its dynamic shared memory (TTHREADS threads
// per block).
struct Variant {
  void (*kern)(RowsIn, RowsOut);
  size_t smem;
};

template <typename K, bool COMPACT, bool POS, bool NCODE = false>
Variant tiled() {
  return {tiled_kernel<K, COMPACT, POS, NCODE>, tiled_smem<K, POS, NCODE>()};
}

// The five kernels by their entry point's name.
Variant variant(const char* name) {
  static const struct {
    const char* name;
    Variant v;
  } table[] = {
      {"rows3", tiled<u64, true, false>()},
      {"rows3w", tiled<Key128v, true, false>()},
      {"rows2", tiled<u64, false, false>()},
      {"rows", tiled<u64, false, true>()},
      {"seq", tiled<u64, false, true, true>()},
  };
  for (const auto& e : table)
    if (!strcmp(name, e.name)) return e.v;
  return {nullptr, 0};
}

int set_smem(const Variant& v) {
  return (int)cudaFuncSetAttribute(
      v.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem);
}

int launch(const char* name, const RowsIn& in, const RowsOut& out, int R,
           void* stream) {
  const Variant v = variant(name);
  if (int err = set_smem(v)) return err;
  dim3 grid(in.SB, R);
  v.kern<<<grid, TTHREADS, v.smem, (cudaStream_t)stream>>>(in, out);
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

// C entry points (ctypes), phi_<name>_launch: each launches on `stream` and
// returns cudaGetLastError(). Compacted outputs are [R, SB*C] with cnt
// [R, SB]; full-lane outputs [R, SB*BLK].
#define PHI_ROWS3_ENTRY(N)                                                    \
  extern "C" int phi_##N##_launch(                                           \
      const void* codes, const void* nd, const void* nvalid,                 \
      const void* left, const void* node_off, long long row_lanes, int R,    \
      int SB, int k, int w, int C, void* out_key, void* out_se,              \
      void* out_cnt, void* stream) {                                         \
    const RowsOut out{static_cast<long long*>(out_key), nullptr,             \
                      static_cast<long long*>(out_se),                       \
                      static_cast<int32_t*>(out_cnt), nullptr, nullptr};     \
    return launch(#N, rows_in(codes, nd, nvalid, left, node_off, row_lanes,  \
                              SB, k, w, C),                                  \
                  out, R, stream);                                           \
  }
PHI_ROWS3_ENTRY(rows3)

#define PHI_ROWS3W_ENTRY(N)                                                   \
  extern "C" int phi_##N##_launch(                                           \
      const void* codes, const void* nd, const void* nvalid,                 \
      const void* left, const void* node_off, long long row_lanes, int R,    \
      int SB, int k, int w, int C, void* out_hi, void* out_lo,               \
      void* out_se, void* out_cnt, void* stream) {                           \
    const RowsOut out{static_cast<long long*>(out_hi),                       \
                      static_cast<long long*>(out_lo),                       \
                      static_cast<long long*>(out_se),                       \
                      static_cast<int32_t*>(out_cnt), nullptr, nullptr};     \
    return launch(#N, rows_in(codes, nd, nvalid, left, node_off, row_lanes,  \
                              SB, k, w, C),                                  \
                  out, R, stream);                                           \
  }
PHI_ROWS3W_ENTRY(rows3w)

#define PHI_ROWS2_ENTRY(N)                                                    \
  extern "C" int phi_##N##_launch(                                           \
      const void* codes, const void* nd, const void* nvalid,                 \
      const void* left, const void* node_off, long long row_lanes, int R,    \
      int SB, int k, int w, void* out_key, void* out_se, void* out_emit,     \
      void* stream) {                                                        \
    const RowsOut out{static_cast<long long*>(out_key), nullptr,             \
                      static_cast<long long*>(out_se), nullptr,              \
                      static_cast<uint8_t*>(out_emit), nullptr};             \
    return launch(#N, rows_in(codes, nd, nvalid, left, node_off, row_lanes,  \
                              SB, k, w, 0),                                  \
                  out, R, stream);                                           \
  }
PHI_ROWS2_ENTRY(rows2)

// rows (2-bit codes) and seq (codes that may hold N): no node plane, the
// selected k-mer's row-local start rides along; left may be null for seq.
#define PHI_POS_ENTRY(N)                                                      \
  extern "C" int phi_##N##_launch(                                           \
      const void* codes, const void* nvalid, const void* left,               \
      long long row_lanes, int R, int SB, int k, int w, void* out_key,       \
      void* out_pos, void* out_emit, void* stream) {                         \
    const RowsOut out{static_cast<long long*>(out_key), nullptr, nullptr,    \
                      nullptr, static_cast<uint8_t*>(out_emit),              \
                      static_cast<int32_t*>(out_pos)};                       \
    return launch(#N, rows_in(codes, nullptr, nvalid, left, nullptr,         \
                              row_lanes, SB, k, w, 0),                       \
                  out, R, stream);                                           \
  }
PHI_POS_ENTRY(rows)
PHI_POS_ENTRY(seq)

// Resident blocks per SM of the kernel behind phi_<name>_launch into
// *blocks; returns a cudaError, or -1 for an unknown name.
extern "C" int phi_rows_occupancy(const char* name, int* blocks) {
  const Variant v = variant(name);
  if (!v.kern) return -1;
  if (int err = set_smem(v)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, v.kern, TTHREADS, v.smem);
}
