// Batched triangular matrix-matrix product  C[b] = tril(L[b]) @ X[b].
//
// Replaces the Pallas TPU kernel src/repro/kernels/trmm.py
// (trmm / _trmm_kernel): the It-Inv-TRSM solve step X_i = Dt_i @ B_i,
// with Dt_i the inverted lower-triangular diagonal block.
//
// What bounds it on the H100: bytes.  At the main path's shape
// (L 4096 x 4096, X 4096 x 16) it does 2 * n^2/2 * k = 2.7e8 flops on
// 16 MiB (bf16) of the triangle: 16 flops per byte, far below the
// card's ~20 (fp32 CUDA cores) to ~295 (bf16 tensor cores) flops per
// byte, so the least time is the triangle's read at 3.35 TB/s.
//
// What the design does about it: the grid is (column tiles, row tiles,
// batch) and the k-loop of a row tile stops at the diagonal, so tiles
// above it are never read and the triangle is read once when k fits
// one column tile (panel_k <= 16 takes 8 x 16 tiles 256 deep: one
// column tile and n/8 row tiles).  L and X tiles are staged through
// shared memory and accumulated in fp32 registers (double for fp64),
// stored in X's dtype; ragged k is masked.  Still far from the bound:
// the work of row tile i grows with i, and the last row tile's k-steps
// run one after another with no overlap of loads and math.  Not yet
// done: splitting the k-loop across blocks, cp.async/TMA pipelining,
// wgmma.
#include "tri_gemm.cuh"

namespace {

template <typename T>
int trmm(const void* L, long long l_sb, const void* X, long long x_sb,
         void* C, long long batch, int n, int k, void* stream) {
  repro::TriGemmArgs<T> p;
  p.a = static_cast<const T*>(L);
  p.lda = n; p.a_sb = l_sb; p.a_sq = 0;
  p.b = static_cast<const T*>(X);
  p.ldb = k; p.b_sb = x_sb; p.b_sq = 0;
  p.c = static_cast<T*>(C);
  p.ldc = k; p.c_sb = (int64_t)n * k; p.c_sq = 0;
  p.M = n; p.N = k; p.K = n;
  p.nq = 1;
  p.tri_a = 1; p.tri_b = 0; p.negate = 0;
  return (int)repro::launch_tri_gemm<T>(p, batch,
                                        static_cast<cudaStream_t>(stream));
}

}  // namespace

#define REPRO_TRMM(SUFFIX, T)                                              \
  extern "C" int repro_trmm_##SUFFIX(const void* L, long long l_sb,       \
                                     const void* X, long long x_sb,       \
                                     void* C, long long batch, int n,     \
                                     int k, void* stream) {               \
    return trmm<T>(L, l_sb, X, x_sb, C, batch, n, k, stream);             \
  }

REPRO_TRMM(f32, float)
REPRO_TRMM(bf16, __nv_bfloat16)
REPRO_TRMM(f64, double)
