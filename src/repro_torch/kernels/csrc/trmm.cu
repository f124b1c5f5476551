// The ordered product on tri_gemm.cuh's tiles.  The triangular products
// have kernels of their own in trmm_tri.cu: the unmasked trmm (B2) and
// the block-masked trmm (B4).
//
// repro_gemm_* is the tiles for a row-strided A, dense (tri_a = 0) or
// lower triangular (tri_a = 1): C[b] = op(A[b]) @ X[b], the trailing
// updates and the refinement residual of a narrow capacity bank.  It
// replaces no TPU kernel; it is there for its summation order.  Each
// output element sums its k-steps in one fixed order whatever M and K
// are, so the products of an order-d factor padded into an order-n
// bank give the unpadded products' bits (cuBLAS picks its kernel, and
// with it the order of the sums, by shape).
#include "tri_gemm.cuh"

namespace {

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
