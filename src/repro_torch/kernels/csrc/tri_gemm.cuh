// Batched tile GEMM with optional lower-triangular operands, shared by
// trmm.cu and tri_inv_block.cu.
//
//   C[z] = sign * op_a(A[z]) @ op_b(B[z])      z = 0 .. batch-1
//
// op_a(A) = tril(A) when tri_a, else A; op_b likewise.  Operand z sits
// at ptr + (z / nq) * sb + (z % nq) * sq with row stride ld and unit
// column stride, so one launch can address the sub-blocks of a stack of
// matrices in place (the doubling levels of tri_inv_block.cu).
//
// The triangular structure bounds the k-loop: a lower-triangular A
// contributes nothing past column r0 + BM of a row tile, a
// lower-triangular B nothing above row c0 of a column tile, so those
// tiles are never loaded (the Pallas kernel's "skip tiles above the
// diagonal").  Inside the diagonal tiles the upper part is zeroed
// element by element on load, so the result is tril(A) @ B for any A.
//
// Operands are staged through shared memory as the accumulator type:
// float for float and bf16, double for double.  Products are IEEE
// fused multiply-adds on the CUDA cores (no TF32, no tensor cores); the
// result is rounded once to T.  Ragged edges (any M, N, K) are masked.
//
// The MASK instantiation (trmm.cu's block-masked product) also skips
// every block of A whose entry in an (M/bt, K/bt) block mask is 0: a
// row tile walks only the runs of consecutive block columns that one of
// its block rows keeps, each run in BK-deep k-steps that stop at the
// run's end, so a skipped block is never loaded.  When a row tile spans
// several block rows (bt < BM), each element is also gated by its own
// block's entry on load.  The unmasked instantiation is B1's and B2's
// kernel and must compile to the same code whatever the MASK path does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T>
__device__ __forceinline__ T from_acc(typename Acc<T>::type x);
template <>
__device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ double from_acc<double>(double x) { return x; }

// x rounded to T's precision, kept in the accumulator type
template <typename T>
__device__ __forceinline__ typename Acc<T>::type round_to(
    typename Acc<T>::type x) {
  return to_acc(from_acc<T>(x));
}

__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct TriGemmArgs {
  const T* a;
  int64_t lda, a_sb, a_sq;
  const T* b;
  int64_t ldb, b_sb, b_sq;
  T* c;
  int64_t ldc, c_sb, c_sq;
  int M, N, K;
  int nq;
  int tri_a, tri_b, negate;
};

// The MASK instantiation's block mask: A's element (r, c) is kept when
// mask[(r / bt) * nb + c / bt] != 0.  A parameter of its own: with these
// fields inside TriGemmArgs, nvcc reads the larger parameter through its
// address and the unmasked kernels compile to other code.
struct BlockMask {
  const int* mask;
  int bt, nb;
};

// One BK-deep k-step of the MASK instantiation at k0: the unmasked
// k-loop's step with the contraction index limited to k < k_end (the
// end of a run of kept blocks); with GATE, an element of A outside the
// block mask also reads as 0 and is never loaded.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool GATE>
__device__ __forceinline__ void k_step(
    const TriGemmArgs<T>& p, const BlockMask& bm, const T* A, const T* B,
    typename Acc<T>::type (&As)[BK][BM + 1],
    typename Acc<T>::type (&Bs)[BK][BN + 1],
    typename Acc<T>::type (&acc)[TM][TN], int r0, int c0, int k0,
    int k_end) {
  using A_t = typename Acc<T>::type;
  constexpr int NT = (BM / TM) * (BN / TN);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  for (int e = tid; e < BM * BK; e += NT) {
    const int r = e / BK, kk = e % BK;
    const int gr = r0 + r, gk = k0 + kk;
    A_t v = A_t(0);
    if (gr < p.M && gk < k_end && (!p.tri_a || gk <= gr) &&
        (!GATE || bm.mask[(gr / bm.bt) * bm.nb + gk / bm.bt]))
      v = to_acc(A[gr * p.lda + gk]);
    As[kk][r] = v;
  }
  for (int e = tid; e < BK * BN; e += NT) {
    const int kk = e / BN, c = e % BN;
    const int gk = k0 + kk, gc = c0 + c;
    A_t v = A_t(0);
    if (gk < k_end && gc < p.N && (!p.tri_b || gc <= gk))
      v = to_acc(B[gk * p.ldb + gc]);
    Bs[kk][c] = v;
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    A_t a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
  }
  __syncthreads();
}

// BM x BN output tile per block, BK-deep k-steps, TM x TN outputs per
// thread.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool MASK>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tri_gemm_kernel(const TriGemmArgs<T> p, const BlockMask bm) {
  using A_t = typename Acc<T>::type;
  __shared__ A_t As[BK][BM + 1];
  __shared__ A_t Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int64_t zb = blockIdx.z / p.nq, zq = blockIdx.z % p.nq;
  const T* A = p.a + zb * p.a_sb + zq * p.a_sq;
  const T* B = p.b + zb * p.b_sb + zq * p.b_sq;
  T* C = p.c + zb * p.c_sb + zq * p.c_sq;

  const int k_lo = p.tri_b ? (c0 / BK) * BK : 0;
  const int k_hi = p.tri_a ? min(p.K, r0 + BM) : p.K;

  A_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A_t(0);

  if constexpr (!MASK) {
    // not k_step: through it the 64 x 64 tiles of B1 and B2 compile to
    // another schedule
    constexpr int NT = (BM / TM) * (BN / TN);
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        const int gr = r0 + r, gk = k0 + kk;
        A_t v = A_t(0);
        if (gr < p.M && gk < p.K && (!p.tri_a || gk <= gr))
          v = to_acc(A[gr * p.lda + gk]);
        As[kk][r] = v;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = c0 + c;
        A_t v = A_t(0);
        if (gk < p.K && gc < p.N && (!p.tri_b || gc <= gk))
          v = to_acc(B[gk * p.ldb + gc]);
        Bs[kk][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        A_t a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = mad(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  } else {
    // block rows [i_lo, i_hi] of this row tile; block column j is live
    // when one of them keeps it
    const int bt = bm.bt;
    const int i_lo = r0 / bt, i_hi = (min(r0 + BM, p.M) - 1) / bt;
    const int j_end = (k_hi + bt - 1) / bt;
    const bool gate = i_lo != i_hi;
    auto live = [&](int j) {
      for (int i = i_lo; i <= i_hi; ++i)
        if (bm.mask[i * bm.nb + j]) return true;
      return false;
    };
    for (int j = k_lo / bt; j < j_end;) {
      if (!live(j)) {
        ++j;
        continue;
      }
      int j1 = j + 1;
      while (j1 < j_end && live(j1)) ++j1;
      const int ke = min(j1 * bt, k_hi);
      for (int k0 = max(j * bt, k_lo); k0 < ke; k0 += BK) {
        if (gate)
          k_step<T, BM, BN, BK, TM, TN, true>(p, bm, A, B, As, Bs, acc, r0,
                                              c0, k0, ke);
        else
          k_step<T, BM, BN, BK, TM, TN, false>(p, bm, A, B, As, Bs, acc,
                                               r0, c0, k0, ke);
      }
      j = j1;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty * TM + i;
    if (gr >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = c0 + tx * TN + j;
      if (gc < p.N)
        C[gr * p.ldc + gc] = from_acc<T>(p.negate ? -acc[i][j] : acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, bool MASK>
cudaError_t launch_tiles(const TriGemmArgs<T>& p, const BlockMask& bm,
                         int64_t batch, cudaStream_t stream) {
  const int64_t gx = (p.N + BN - 1) / BN, gy = (p.M + BM - 1) / BM;
  if (batch < 1 || batch > 65535 || gy > 65535 || gx > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)batch);
  tri_gemm_kernel<T, BM, BN, BK, TM, TN, MASK>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p, bm);
  return cudaGetLastError();
}

// Skinny right-hand sides (the solve step's panel_k <= 16 columns) take
// 8 x 16 tiles 256 deep (128 for double, to stay in 48 KB of static
// shared memory): an n = 4096 operand spreads over 512 blocks, and the
// longest row tile, which bounds the launch, walks 16 dependent k-steps
// instead of the 128 of 32 x 16 x 32 tiles (PERF.md has both times).
// Everything else takes 64 x 64 tiles.
template <typename T, bool MASK = false>
cudaError_t launch_tri_gemm(const TriGemmArgs<T>& p, int64_t batch,
                            cudaStream_t stream,
                            const BlockMask& bm = BlockMask{nullptr, 0, 0}) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || p.nq < 1) return cudaErrorInvalidValue;
  if (MASK && (bm.mask == nullptr || bm.bt < 1 || bm.nb < 1))
    return cudaErrorInvalidValue;
  constexpr int kSkinnyBK = sizeof(typename Acc<T>::type) == 8 ? 128 : 256;
  if (p.N <= 16)
    return launch_tiles<T, 8, 16, kSkinnyBK, 1, 1, MASK>(p, bm, batch,
                                                         stream);
  return launch_tiles<T, 64, 64, 16, 4, 4, MASK>(p, bm, batch, stream);
}

}  // namespace repro
