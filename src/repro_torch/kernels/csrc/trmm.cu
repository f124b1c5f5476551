// Batched triangular matrix-matrix products on tri_gemm.cuh's tiles: the
// block-masked trmm (B4) and the ordered product.  The unmasked trmm
// (B2) has its own kernel in trmm_tri.cu.
//
// repro_trmm_masked_* replaces _trmm_masked_kernel of
// src/repro/kernels/trmm.py: C[b] = tril(L[b]) @ X[b] with an
// (n/bt, n/bt) int32 block mask shared by the batch, every block whose
// entry is 0 skipped and never read.  It forms the refinement residual
// tril(L_hi) @ X of a structured factor, with the structure's mask at
// bt = n0.  Bound by bytes like the unmasked product, but only the kept
// blocks are read: a row tile walks the runs of kept blocks of its block
// row (tri_gemm.cuh's MASK instantiation), so a banded factor's row tile
// visits only its band.
//
// What bounds it on the H100: bytes.  At the main path's shape
// (L 8192 x 8192 fp32, X 8192 x 16) it does 2 flops per element of the
// kept triangle on 4 bytes of it, far below the card's ~20 (fp32 CUDA
// cores) flops per byte, so the least time is the kept blocks' read at
// 3.35 TB/s.
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
// done: balancing the triangle and pipelining the loads, as trmm_tri.cu
// does for B2 (B4's own redesign is a later item of ROADMAP B).
//
// repro_gemm_* is the same tiles for a row-strided A, dense (tri_a = 0)
// or lower triangular (tri_a = 1): C[b] = op(A[b]) @ X[b], the trailing
// updates and the refinement residual of a narrow capacity bank.  It
// replaces no TPU kernel; it is there for its summation order.  Each
// output element sums its k-steps in one fixed order whatever M and K
// are, so the products of an order-d factor padded into an order-n
// bank give the unpadded products' bits (cuBLAS picks its kernel, and
// with it the order of the sums, by shape).
#include "tri_gemm.cuh"

namespace {

template <typename T>
repro::TriGemmArgs<T> trmm_args(const void* L, long long l_sb,
                                const void* X, long long x_sb, void* C,
                                int n, int k) {
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
  return p;
}

template <typename T>
int gemm(const void* A, long long a_sb, long long lda, const void* X,
         long long x_sb, void* C, long long batch, int M, int K, int N,
         int tri_a, void* stream) {
  repro::TriGemmArgs<T> p;
  p.a = static_cast<const T*>(A);
  p.lda = lda; p.a_sb = a_sb; p.a_sq = 0;
  p.b = static_cast<const T*>(X);
  p.ldb = N; p.b_sb = x_sb; p.b_sq = 0;
  p.c = static_cast<T*>(C);
  p.ldc = N; p.c_sb = (int64_t)M * N; p.c_sq = 0;
  p.M = M; p.N = N; p.K = K;
  p.nq = 1;
  p.tri_a = tri_a; p.tri_b = 0; p.negate = 0;
  return (int)repro::launch_tri_gemm<T>(p, batch,
                                        static_cast<cudaStream_t>(stream));
}

template <typename T>
int trmm_masked(const void* L, long long l_sb, const void* X,
                long long x_sb, void* C, long long batch, int n, int k,
                const void* mask, int bt, void* stream) {
  const repro::BlockMask bm{static_cast<const int*>(mask), bt,
                            bt > 0 ? n / bt : 0};
  return (int)repro::launch_tri_gemm<T, true>(
      trmm_args<T>(L, l_sb, X, x_sb, C, n, k), batch,
      static_cast<cudaStream_t>(stream), bm);
}

}  // namespace

#define REPRO_GEMM(SUFFIX, T)                                              \
  extern "C" int repro_gemm_##SUFFIX(const void* A, long long a_sb,       \
                                     long long lda, const void* X,        \
                                     long long x_sb, void* C,             \
                                     long long batch, int M, int K,       \
                                     int N, int tri_a, void* stream) {    \
    return gemm<T>(A, a_sb, lda, X, x_sb, C, batch, M, K, N, tri_a,       \
                   stream);                                                \
  }

REPRO_GEMM(f32, float)
REPRO_GEMM(bf16, __nv_bfloat16)
REPRO_GEMM(f64, double)

#define REPRO_TRMM_MASKED(SUFFIX, T)                                       \
  extern "C" int repro_trmm_masked_##SUFFIX(                               \
      const void* L, long long l_sb, const void* X, long long x_sb,       \
      void* C, long long batch, int n, int k, const void* mask, int bt,   \
      void* stream) {                                                      \
    return trmm_masked<T>(L, l_sb, X, x_sb, C, batch, n, k, mask, bt,     \
                          stream);                                         \
  }

REPRO_TRMM_MASKED(f32, float)
REPRO_TRMM_MASKED(bf16, __nv_bfloat16)
REPRO_TRMM_MASKED(f64, double)
