// Fused diagonal-GMM emission scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel rasr_tpu/ops/pallas/gmm_kernel.py::gmm_scores_pallas
// (its `_kernel` and the wrapper `mixture_scores_fused`).
//
// Computes, for frames x [N, D] and K densities per mixture,
//     d_k[n, m] = c_k[m] + sum_d x[n,d]^2 a_k[d,m] + x[n,d] b_k[d,m]
//     out[n, m] = min_k d_k[n,m]                          (max_approx)
//               = m* - log sum_k exp(-(d_k[n,m] - m*))    (m* = min_k d_k)
// with a/b k-major [K, D, M], c [K, M] (padding densities carry PAD_SCORE,
// so they never win the min and vanish from the sum). The [N, M*K]
// per-density tensor never reaches device memory: only [N, M] is written.
//
// What bounds it on the H100: fp32 issue. At the bench shape (N=63,872
// frames, D=45, M=2000, K=8) it is 2*2*N*D*M*K ~ 1.8e11 FLOP against
// N*M output floats, far above the fp32 ridge, while the unfused plain
// version writes and re-reads the N*M*K per-density floats (K=8 times
// the output).
//
// Design: one thread block per [TN=64 frame x TM=64 mixture] tile, 256
// threads, each owning a 4x4 register micro-tile. Per density k and per
// DC-wide slice of the feature dimension the block stages x, x^2 and the
// tile's a_k/b_k columns in shared memory, then accumulates with plain
// fp32 FMAs (no TF32, no tensor cores: the reference runs at
// Precision.HIGHEST). The combine over k runs in registers in the
// epilogue of each density: a running min, or an online log-sum-exp.
// Ragged frame/mixture edges are zero-filled on load and masked on store.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 64;
constexpr int TM = 64;
constexpr int DC = 16;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RN = TN / TY;
constexpr int RM = TM / TX;

template <bool MAX_APPROX>
__global__ void __launch_bounds__(THREADS)
gmm_scores_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  float* __restrict__ out, int N, int D, int M, int K) {
  // +1 pad: the transposing store below would otherwise hit one bank
  __shared__ float xs[DC][TN + 1];
  __shared__ float x2s[DC][TN + 1];
  __shared__ float a_s[DC][TM];
  __shared__ float b_s[DC][TM];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;

  float best[RN][RM];  // running min (or LSE max-shift m*)
  float ssum[RN][RM];  // LSE: sum exp(-(d_k - m*))
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      best[i][j] = 0.f;
      ssum[i][j] = 0.f;
    }

  for (int k = 0; k < K; ++k) {
    const float* ak = a + (size_t)k * D * M;
    const float* bk = b + (size_t)k * D * M;
    float acc[RN][RM];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();
      for (int e = threadIdx.x; e < TN * DC; e += THREADS) {
        const int r = e / DC, dd = e % DC;
        const int n = n0 + r, d = d0 + dd;
        const float v = (n < N && d < D) ? x[(size_t)n * D + d] : 0.f;
        xs[dd][r] = v;
        x2s[dd][r] = v * v;
      }
      for (int e = threadIdx.x; e < TM * DC; e += THREADS) {
        const int dd = e / TM, col = e % TM;
        const int m = m0 + col, d = d0 + dd;
        const bool ok = m < M && d < D;
        a_s[dd][col] = ok ? ak[(size_t)d * M + m] : 0.f;
        b_s[dd][col] = ok ? bk[(size_t)d * M + m] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        float xv[RN], x2v[RN], av[RM], bv[RM];
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          xv[i] = xs[dd][ty + TY * i];
          x2v[i] = x2s[dd][ty + TY * i];
        }
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          av[j] = a_s[dd][tx + TX * j];
          bv[j] = b_s[dd][tx + TX * j];
        }
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int j = 0; j < RM; ++j)
            acc[i][j] = fmaf(x2v[i], av[j], fmaf(xv[i], bv[j], acc[i][j]));
      }
    }

    // epilogue of density k: add c_k and combine into the running result
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int m = m0 + tx + TX * j;
      const float ck = (m < M) ? c[(size_t)k * M + m] : 0.f;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float dk = acc[i][j] + ck;
        if (k == 0) {
          best[i][j] = dk;
          ssum[i][j] = 1.f;
        } else if (MAX_APPROX) {
          best[i][j] = fminf(best[i][j], dk);
        } else {
          const float mn = fminf(best[i][j], dk);
          ssum[i][j] = ssum[i][j] * expf(mn - best[i][j]) + expf(mn - dk);
          best[i][j] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int n = n0 + ty + TY * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int m = m0 + tx + TX * j;
      if (m >= M) continue;
      out[(size_t)n * M + m] =
          MAX_APPROX ? best[i][j] : best[i][j] - logf(ssum[i][j]);
    }
  }
}

}  // namespace

extern "C" int gmm_scores_launch(const float* x, const float* a,
                                 const float* b, const float* c, float* out,
                                 int N, int D, int M, int K, int max_approx,
                                 void* stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_approx)
    gmm_scores_kernel<true><<<grid, THREADS, 0, s>>>(x, a, b, c, out, N, D, M, K);
  else
    gmm_scores_kernel<false><<<grid, THREADS, 0, s>>>(x, a, b, c, out, N, D, M, K);
  return static_cast<int>(cudaGetLastError());
}
