// K1 over pack_int4 codes: the W4 entries of the body in w4a16.cuh.
#include "w4a16.cuh"

// The GEMV entry (M <= 8), one launch: `splits` and `stages` are the host
// plan's IC splits of a column tile (a cluster, at most 8) and ring slots
// (2..9; ops/w4a16.py::gemv_plan). Caller guarantees: x [M, IC] contiguous
// and 16-byte aligned, of dtype code `dtype` (0 f32, 1 bf16, 2 f16), qw
// int32 [IC/8, OC], scales/szeros f32 [IC/G, OC], bias [OC] of x's dtype or
// null, out [M, OC] of x's dtype; 1 <= M <= 8; G % 8 == 0, IC % G == 0,
// IC % 64 == 0; vec = 1 only where OC % 4 == 0 and qw, scales and szeros
// are 16-byte aligned.
extern "C" int awq_w4a16_gemv(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out, int M, int IC,
                              int OC, int G, int splits, int stages, int vec, int dtype,
                              void* stream) {
  return gemv_entry<false>(x, qw, scales, szeros, bias, out, M, IC, OC, G, splits, stages,
                           vec, dtype, stream);
}

// The GEMM entry (M > 8): `nt` and `splits` are the host plan's token
// tile (16, 32, 64 or 128) and split count (ops/w4a16.py::gemm_plan),
// partial f32 [splits, M, OC] when splits > 1 (else null). Caller
// guarantees: x [M, IC] contiguous and 16-byte aligned, bf16 for dtype 0
// (f32 output) and 1, f16 for 2; IC % 64 == 0, G % 8 == 0, IC % G == 0;
// 1 <= splits <= IC / 64; the other operands as for awq_w4a16_gemv.
extern "C" int awq_w4a16_gemm(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out,
                              void* partial, int M, int IC, int OC, int G, int nt,
                              int splits, int dtype, void* stream) {
  return gemm_entry<false>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, nt,
                           splits, dtype, stream);
}
