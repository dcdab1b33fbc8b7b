// Stage cuts of the five kernels of rows.cu (rows3, rows3w, rows2, rows,
// seq), for timing where their time goes. chip_smoke.py builds this file
// into a library of its own and times each cut against the whole kernel;
// the library the wrappers in sketch/kernels.py load is built from rows.cu
// alone.
//
// A cut runs the stages of TiledBlock up to STOP: 1 the packing of the
// block's codes, 2 each tile's keys and node prefix (rows, seq: the keys
// alone), 3 its window minimum. A value its last stage computed is stored only
// under a condition that never holds, so the compiler keeps the work; the
// cut's outputs are not the kernel's.

#include "rows.cu"

namespace {

template <typename K, bool COMPACT, bool POS, bool NCODE, int STOP>
__global__ void __launch_bounds__(TTHREADS, tiled_minb(POS))
cut_kernel(const __grid_constant__ RowsIn in,
           const __grid_constant__ RowsOut out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[TTHREADS / 32];
  __shared__ int wofs[COMPACT ? 32 : 1];
  TiledBlock<K, COMPACT, POS, NCODE> t(in, out, smem, warp_tot, wofs);
  if (t.past_block()) return;
  t.pack();
  unsigned sink = (unsigned)t.fw[t.tid] ^ (unsigned)t.rv[t.tid];
  if constexpr (NCODE) sink ^= t.dw[t.tid];
  for (int P0 = 0; STOP > 1 && P0 < BLK && !t.past_tile(P0); P0 += TILE) {
    t.keys_and_prefix(P0);
    if constexpr (STOP == 2) {
      __syncthreads();
      sink ^= t.pa[t.tid];
      if constexpr (!POS) sink ^= (unsigned)t.sc[t.tid];
    } else {
      t.window_min();
      sink ^= t.ps[t.tid];
    }
    t.next_tile();
  }
  if (sink == 0x9e3779b9u && t.tid == 0) t.dead(t.out_off);
  t.finish();
}

template <typename K, bool COMPACT, bool POS, bool NCODE = false>
int launch_cut(int stop, const RowsIn& in, const RowsOut& out, int R,
               void* stream) {
  auto* kern = stop == 1   ? cut_kernel<K, COMPACT, POS, NCODE, 1>
               : stop == 2 ? cut_kernel<K, COMPACT, POS, NCODE, 2>
               : stop == 3 ? cut_kernel<K, COMPACT, POS, NCODE, 3>
                           : nullptr;
  if (!kern) return -1;
  const Variant v{kern, tiled_smem<K, POS, NCODE>()};
  if (int err = set_smem(v)) return err;
  dim3 grid(in.SB, R);
  kern<<<grid, TTHREADS, v.smem, (cudaStream_t)stream>>>(in, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of phi_<name>_launch with the cut (1-3) after the ints; -1
// for another cut.
extern "C" int phi_rows3_cut_launch(const void* codes, const void* nd,
                                    const void* nvalid, const void* left,
                                    const void* node_off, long long row_lanes,
                                    int R, int SB, int k, int w, int C,
                                    int stop, void* out_key, void* out_se,
                                    void* out_cnt, void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr,
                    static_cast<long long*>(out_se),
                    static_cast<int32_t*>(out_cnt), nullptr, nullptr};
  return launch_cut<u64, true, false>(
      stop, rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, C),
      out, R, stream);
}

extern "C" int phi_rows3w_cut_launch(const void* codes, const void* nd,
                                     const void* nvalid, const void* left,
                                     const void* node_off,
                                     long long row_lanes, int R, int SB,
                                     int k, int w, int C, int stop,
                                     void* out_hi, void* out_lo,
                                     void* out_se, void* out_cnt,
                                     void* stream) {
  const RowsOut out{static_cast<long long*>(out_hi),
                    static_cast<long long*>(out_lo),
                    static_cast<long long*>(out_se),
                    static_cast<int32_t*>(out_cnt), nullptr, nullptr};
  return launch_cut<Key128v, true, false>(
      stop, rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, C),
      out, R, stream);
}

extern "C" int phi_rows2_cut_launch(const void* codes, const void* nd,
                                    const void* nvalid, const void* left,
                                    const void* node_off, long long row_lanes,
                                    int R, int SB, int k, int w, int stop,
                                    void* out_key, void* out_se,
                                    void* out_emit, void* stream) {
  const RowsOut out{static_cast<long long*>(out_key), nullptr,
                    static_cast<long long*>(out_se), nullptr,
                    static_cast<uint8_t*>(out_emit), nullptr};
  return launch_cut<u64, false, false>(
      stop, rows_in(codes, nd, nvalid, left, node_off, row_lanes, SB, k, w, 0),
      out, R, stream);
}

// rows and seq (NCODE): the position variants.
#define PHI_POS_CUT_ENTRY(N, NCODE)                                           \
  extern "C" int phi_##N##_cut_launch(                                       \
      const void* codes, const void* nvalid, const void* left,               \
      long long row_lanes, int R, int SB, int k, int w, int stop,            \
      void* out_key, void* out_pos, void* out_emit, void* stream) {          \
    const RowsOut out{static_cast<long long*>(out_key), nullptr, nullptr,    \
                      nullptr, static_cast<uint8_t*>(out_emit),              \
                      static_cast<int32_t*>(out_pos)};                       \
    return launch_cut<u64, false, true, NCODE>(                              \
        stop, rows_in(codes, nullptr, nvalid, left, nullptr, row_lanes, SB,  \
                      k, w, 0),                                              \
        out, R, stream);                                                     \
  }
PHI_POS_CUT_ENTRY(rows, false)
PHI_POS_CUT_ENTRY(seq, true)
