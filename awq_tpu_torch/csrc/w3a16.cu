// K1's W3 mode over pack_int3 codes: the W3 entries of the body in
// w4a16.cuh, the counterpart of the Pallas kernels w3a16_matmul_stacked
// and w3a16_matmul_stacked_tiled_folded (awq_tpu/ops/w4a16.py).
#include "w4a16.cuh"

// Caller guarantees: as awq_w4a16_gemv, with qw int32 [IC*3/32, OC] in
// pack_int3's layout, IC % 256 == 0 and splits <= IC / 256.
extern "C" int awq_w3a16_gemv(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out, int M, int IC,
                              int OC, int G, int splits, int stages, int vec, int dtype,
                              void* stream) {
  return gemv_entry<true>(x, qw, scales, szeros, bias, out, M, IC, OC, G, splits, stages,
                          vec, dtype, stream);
}

// As awq_w4a16_gemm, with qw as for awq_w3a16_gemv (IC % 256 == 0,
// 1 <= splits <= IC / 256).
extern "C" int awq_w3a16_gemm(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out,
                              void* partial, int M, int IC, int OC, int G, int nt,
                              int splits, int dtype, void* stream) {
  return gemm_entry<true>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, nt,
                          splits, dtype, stream);
}
