// The code pairs of the weights-as-A GEMVs: K1's decode GEMV (w4a16.cuh)
// and K6's matmul phases (megakernel_batched.cu) put the codes of one
// column for channels (2tq, 2tq + 1) of a k16 step in one word of the A
// fragment of mma.sync m16n8k16. K4 and K5 decode their own way
// (mega_common.cuh).
#pragma once

#include <cstdint>

namespace pc {

// Bytes b of two words side by side: [x.b, x.b, y.b, y.b].
__device__ __forceinline__ uint32_t pair_bytes(uint32_t x, uint32_t y, int b) {
  return __byte_perm(x, y, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
}

// The pairs of k16 step j (0..3) of a 64-channel sub-step of one column,
// low (channels 16j + 2tq, + 1) and high (16j + 8 + 2tq, + 1), each code
// OR-ed into `base` (the tile type's 2^7 or 2^10 in both halves: that
// power plus the code, exactly). lo0/lo1 are the column's words of code
// rows 2tq and 2tq + 1; in W3 (pack_int3) they hold the two low bits of
// each code and hi0/hi1 the rows of the third bits, shifted into place
// for the sub-step by the caller.
template <bool W3>
__device__ __forceinline__ void code_pairs(uint32_t lo0, uint32_t lo1, uint32_t hi0, uint32_t hi1,
                                           int j, uint32_t base, uint32_t& pl, uint32_t& ph) {
  if constexpr (W3) {
    const uint32_t L3 = pair_bytes(lo0, lo1, j >> 1);
    const uint32_t H3 = pair_bytes(hi0, hi1, 0) << 2;
    const int f = 2 * (j & 1);
    pl = ((L3 >> (2 * f)) & 0x00030003u) | ((H3 >> (2 * j)) & 0x00040004u) | base;
    ph = ((L3 >> (2 * f + 2)) & 0x00030003u) | ((H3 >> (2 * j + 1)) & 0x00040004u) | base;
  } else {
    (void)hi0; (void)hi1;
    const uint32_t P = pair_bytes(lo0, lo1, j);
    pl = (P & 0x000F000Fu) | base;
    ph = ((P >> 4) & 0x000F000Fu) | base;
  }
}

}  // namespace pc
