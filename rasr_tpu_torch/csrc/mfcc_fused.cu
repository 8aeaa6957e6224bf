// Fused MFCC for Hopper (sm_90a): windowed DFT -> power -> mel -> log -> DCT.
//
// Replaces the TPU kernel rasr_tpu/ops/pallas/frontend_kernel.py::
// mfcc_frames_fused (its `_kernel`).
//
// Computes, per frame x [L] (un-windowed, after pre-emphasis),
//     re = x . (diag(w) cos),  im = x . (diag(w) sin),  power = re^2 + im^2
//     ceps = log(max(power . mel, log_floor)) . dct
// with the window folded into the DFT bases on the host, as the TPU
// kernel does. Frames are read in place through (batch, frame) strides,
// so the framing view of the signal is never materialised; only the
// [N, C] cepstra are written.
//
// What bounds it on the H100: fp32 issue on the DFT, 4*L*bins ~ 4.1e5
// FLOP per frame at L=400 / 257 bins (2.6e10 FLOP for the bench's 63,872
// frames) against L floats read and C=16 written per frame; the cos/sin
// bases (2*L*bins floats) stay resident in L2 and are re-read per tile.
//
// Design: one thread block per tile of TF=32 frames, one thread per
// frequency bin (at most 288 threads, two blocks resident per SM; larger
// FFTs loop over bin groups; lanes past the last bin idle). The frame
// tile is staged in shared memory and broadcast to every bin thread as
// 4-sample vector loads (one shared-memory load per 8 FMAs); each thread
// keeps its bin's 32 re/im sums in registers and reads its basis column
// coalesced from L2. The power rows, the mel energies, their log and the
// DCT stay on chip. No padding to 128: the bin, mel and cepstrum edges are
// plain bounds.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TF = 32;
constexpr int MAX_THREADS = 288;  // 257 bins of a 512-point FFT, warp-rounded

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__global__ void __launch_bounds__(MAX_THREADS, 2) mfcc_frames_kernel(
    const float* __restrict__ frames, const float* __restrict__ cosw,
    const float* __restrict__ sinw, const float* __restrict__ mel,
    const float* __restrict__ dct, float* __restrict__ out, int B, int T,
    long long stride_b, long long stride_t, int L, int bins, int num_mel,
    int num_ceps, float log_floor) {
  extern __shared__ float4 smem4[];  // float4-typed: 16-byte aligned rows
  float* smem = reinterpret_cast<float*>(smem4);
  const int Lp = round4(L);
  const int Kp = round4(bins);
  float* xs = smem;                    // [TF][Lp] frames
  float* power = xs + TF * Lp;         // [TF][Kp]
  float* logmel = power + TF * Kp;     // [TF][num_mel]

  const long long N = (long long)B * T;
  const long long f0 = (long long)blockIdx.x * TF;
  const int tid = threadIdx.x;

  for (int e = tid; e < TF * Lp; e += blockDim.x) {
    const int f = e / Lp, l = e % Lp;
    const long long n = f0 + f;
    float v = 0.f;
    if (n < N && l < L) {
      const long long b = n / T, t = n % T;
      v = frames[b * stride_b + t * stride_t + l];
    }
    xs[f * Lp + l] = v;
  }
  __syncthreads();

  for (int b0 = 0; b0 < bins; b0 += blockDim.x) {
    const int bin = b0 + tid;
    if (bin >= bins) break;
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int l = 0; l < Lp; l += 4) {
      float cb[4], sb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = l + u < L;
        cb[u] = ok ? __ldg(cosw + (size_t)(l + u) * bins + bin) : 0.f;
        sb[u] = ok ? __ldg(sinw + (size_t)(l + u) * bins + bin) : 0.f;
      }
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(xs + f * Lp + l);
        re[f] = fmaf(v.w, cb[3], fmaf(v.z, cb[2], fmaf(v.y, cb[1], fmaf(v.x, cb[0], re[f]))));
        im[f] = fmaf(v.w, sb[3], fmaf(v.z, sb[2], fmaf(v.y, sb[1], fmaf(v.x, sb[0], im[f]))));
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) power[f * Kp + bin] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int e = tid; e < TF * num_mel; e += blockDim.x) {
    const int f = e / num_mel, m = e % num_mel;
    const float* pw = power + f * Kp;
    float acc = 0.f;
    for (int k = 0; k < bins; ++k) acc = fmaf(pw[k], __ldg(mel + (size_t)k * num_mel + m), acc);
    logmel[f * num_mel + m] = logf(fmaxf(acc, log_floor));
  }
  __syncthreads();

  for (int e = tid; e < TF * num_ceps; e += blockDim.x) {
    const int f = e / num_ceps, c = e % num_ceps;
    const long long n = f0 + f;
    if (n >= N) continue;
    const float* lm = logmel + f * num_mel;
    float acc = 0.f;
    for (int m = 0; m < num_mel; ++m) acc = fmaf(lm[m], __ldg(dct + (size_t)m * num_ceps + c), acc);
    out[n * num_ceps + c] = acc;
  }
}

}  // namespace

extern "C" int mfcc_frames_launch(const float* frames, const float* cosw,
                                  const float* sinw, const float* mel,
                                  const float* dct, float* out, int B, int T,
                                  long long stride_b, long long stride_t,
                                  int L, int bins, int num_mel, int num_ceps,
                                  float log_floor, void* stream) {
  const long long N = (long long)B * T;
  const int threads = bins < MAX_THREADS ? (bins + 31) / 32 * 32 : MAX_THREADS;
  const size_t smem =
      sizeof(float) * (size_t)TF * (round4(L) + round4(bins) + num_mel);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mfcc_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((N + TF - 1) / TF);
  mfcc_frames_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, cosw, sinw, mel, dct, out, B, T, stride_b, stride_t, L, bins,
      num_mel, num_ceps, log_floor);
  return static_cast<int>(cudaGetLastError());
}
