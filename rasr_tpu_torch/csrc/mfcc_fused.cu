// Fused MFCC for Hopper (sm_90a): windowed DFT -> power -> mel -> log -> DCT,
// the DFT on the tensor cores at fp32 accuracy (3xTF32).
//
// Replaces the TPU kernel rasr_tpu/ops/pallas/frontend_kernel.py::
// mfcc_frames_fused (its `_kernel`).
//
// Computes, per frame x [L] (un-windowed, after pre-emphasis),
//     re = x . (diag(w) cos),  im = x . (diag(w) sin),  power = re^2 + im^2
//     ceps = log(max(power . mel, log_floor)) . dct
// with the window folded into the DFT bases on the host, as the TPU
// kernel does. Frames are read through (batch, frame) strides, so the
// framing view of the signal is never materialised; only the [N, C]
// cepstra are written.
//
// What bounds it on the H100: operations. The DFT is 4*L*bins ~ 4.1e5
// FLOP per frame at L = 400 / 257 bins (2.6e10 for the main path's 63,872
// frames): 0.40 ms at the fp32 pipes' 67 TFLOP/s against 0.014 ms of
// memory traffic (the 41 MB signal read once, 4 MB of cepstra written).
// The design moves the DFT onto the tensor cores (tf32x3.cuh: three TF32
// mma.sync products per step, fp32 accuracy) and reads the bases from L2
// once per 128 frames instead of once per 32. Three TF32 products of
// 2.6e10 FLOP take at least 0.16 ms at 495 TFLOP/s: that is this kernel's
// bound.
//
// Design: a block owns TF = 128 consecutive frames. Frames of one
// utterance overlap (shift < L), so the block loads each utterance's
// contiguous span of samples once into shared memory, (TF-1)*shift + L
// samples (20,720 at 16 kHz), one span per utterance when the tile
// crosses an utterance boundary; frames that do not overlap are read
// from global memory as they are. The span is stored skewed (PAD floats
// after every `shift` samples) so that the 8 frames of an mma fragment,
// `shift` apart, fall in different banks: each lane loads its A fragment
// straight from the span and splits it into hi/lo in registers, with no
// staging pass. The product [128 x L] . [L x 2*bins] runs in passes of 96
// bins; per pass the packed bases (cos and sin columns of a bin side by
// side, split into hi/lo and laid out in fragment order on the host:
// ops/kernels/mfcc.py pack_basis) stream in depth chunks of 16 through a
// 3-stage cp.async ring. Eight warps each own 32 frames x 48 bins (re and
// im land in the same thread, and each A fragment feeds 12 column tiles),
// so the epilogue of a pass squares and adds in registers, writes the
// power rows to shared memory, 48 bins at a time, and adds their mel
// energies (from a shared-memory copy of the pass's mel rows) into
// per-frame sums; after the last pass the log and the DCT run on chip.
// Bins, depth and frames past their ends are zero.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int TF = 128;           // frames per block
constexpr int THREADS = 256;      // 8 warps: 4 along frames x 2 along bins
constexpr int GPW = 6;            // 8-bin groups per warp and pass
constexpr int GP = 2 * GPW;       // 8-bin groups per pass (96 bins)
constexpr int STAGES = 3;         // cp.async ring depth
constexpr int GROUP_F4 = 2 * 2 * 32;          // one group's depth-16 chunk: [ks][cos|sin][lane]
constexpr int STAGE_F4 = GP * GROUP_F4;       // 24 KB
constexpr int HALF = GPW * 8;                 // bins of one warp column: a power round
constexpr int PW_LD = HALF + 4;               // power row stride (16-byte rows, skewed banks)
constexpr int MAX_HALF_MEL = 16;              // mel bands per thread and band group
static_assert(2 * TF == THREADS, "the mel sums take two threads per frame");
static_assert(TF <= THREADS, "one thread per frame places the frames");
using tf32x3::SMEM_MAX;

size_t fixed_smem(int num_mel) {
  return sizeof(float4) * STAGES * STAGE_F4 + TF * (sizeof(long long) * 2 + sizeof(int) * 2) +
         sizeof(float) * ((size_t)TF * PW_LD + GP * 8 * num_mel + TF * num_mel);
}

// floats a skewed span of `frames` frames of one utterance takes
__host__ __device__ inline long long span_floats(long long frames, long long shift, int pad,
                                                int L) {
  return (frames - 1) * (shift + pad) + L + (long long)pad * ((L - 1) / shift);
}

// the skew for a frame shift: the row stride shift + pad is 4 banks
int skew_pad(long long shift) { return (int)((36 - shift % 32) % 32); }

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) mfcc_frames_kernel(
    const float* __restrict__ frames, const float4* __restrict__ basis,
    const float* __restrict__ mel, const float* __restrict__ dct, float* __restrict__ out,
    int B, int T, long long stride_b, long long stride_t, int L, int bins, int num_mel,
    int num_ceps, float log_floor, int pad) {
  extern __shared__ float4 smem[];
  float4* b_s = smem;                                   // [STAGES][STAGE_F4]
  long long* fbase = reinterpret_cast<long long*>(b_s + STAGES * STAGE_F4);  // [TF]
  long long* seg_g = fbase + TF;                        // span start in `frames`
  int* seg_s = reinterpret_cast<int*>(seg_g + TF);      // span start in `span`
  int* seg_n = seg_s + TF;                              // span length (samples)
  float* pw = reinterpret_cast<float*>(seg_n + TF);     // [TF][PW_LD] power of a round
  float* mel_s = pw + TF * PW_LD;                       // [num_mel][GP*8] mel rows of a pass
  float* lmel = mel_s + GP * 8 * num_mel;               // [TF][num_mel] mel energies
  float* span = lmel + TF * num_mel;                    // the frames' samples, skewed

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long N = (long long)B * T;
  const long long n0 = (long long)blockIdx.x * TF;
  const int NCH = (L + 15) / 16;
  const int passes = ((bins + 7) / 8 + GP - 1) / GP;
  const int Q = passes * NCH;

  auto issue = [&](int q) {
    if (q < Q) {
      const int p = q / NCH, c = q % NCH;
      float4* dst = b_s + (q % STAGES) * STAGE_F4;
      for (int i = tid; i < STAGE_F4; i += THREADS) {
        const int gi = p * GP + i / GROUP_F4;
        tf32x3::cp_async16(dst + i, basis + ((size_t)gi * NCH + c) * GROUP_F4 + i % GROUP_F4);
      }
    }
    tf32x3::cp_async_commit();
  };

  // Where each frame's samples start: in `span` (staged, skewed) or in
  // `frames`. The tile's valid frames fall into nseg utterances: a first
  // span of cnt0 frames, full utterances of T frames, and a last one.
  const int valid = (int)(N - n0 < TF ? N - n0 : TF);
  const int b0 = (int)(n0 / T), t0 = (int)(n0 % T);
  const int cnt0 = T - t0 < valid ? T - t0 : valid;
  const int nseg = STAGED ? (int)((n0 + valid - 1) / T) - b0 + 1 : 0;
  const int full = STAGED ? (int)span_floats(T, stride_t, pad, L) : 0;
  const int first = STAGED ? (int)span_floats(cnt0, stride_t, pad, L) : 0;
  if (tid < TF) {
    long long base = -1;
    if (tid < valid) {
      const long long n = n0 + tid;
      const int b = (int)(n / T), tt = (int)(n % T);
      if (STAGED) {
        const int j = b - b0;  // j > 0: a whole utterance from its frame 0
        base = (j == 0 ? 0 : first + (j - 1) * full) + (j == 0 ? tt - t0 : tt) * (stride_t + pad);
      } else {
        base = b * stride_b + tt * stride_t;
      }
    }
    fbase[tid] = base;
  }
  if (tid < nseg) {
    const int f = tid == 0 ? 0 : cnt0 + (tid - 1) * T;  // the span's first frame
    const int cnt = tid == 0 ? cnt0 : (valid - f < T ? valid - f : T);
    const long long n = n0 + f;
    seg_g[tid] = (n / T) * stride_b + (n % T) * stride_t;
    seg_s[tid] = tid == 0 ? 0 : first + (tid - 1) * full;
    seg_n[tid] = (cnt - 1) * (int)stride_t + L;
  }
  __syncthreads();
  // the spans, skewed, as asynchronous copies in the ring's first group
  const float inv_shift = 1.f / (float)stride_t;
  for (int j = 0; j < nseg; ++j) {
    const float* src = frames + seg_g[j];
    float* dst = span + seg_s[j];
    for (int i = tid; i < seg_n[j]; i += THREADS)
      tf32x3::cp_async4(dst + i + pad * __float2int_rz((i + 0.5f) * inv_shift), src + i);
  }
  for (int q = 0; q < STAGES - 1; ++q) issue(q);

  // The A fragment rows of this lane: frames g and g+8 of the warp's two
  // m16 tiles. Frames past N read a valid address and are zeroed.
  long long fb[2][2];
  bool ok[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long v = fbase[wm * 32 + i * 16 + h * 8 + g];
      ok[i][h] = v >= 0;
      fb[i][h] = v >= 0 ? v : 0;
    }

  float acc[2][2 * GPW][4];  // [m16 tile][bin group x (re|im)][fragment]
  for (int q = 0; q < Q; ++q) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(q + STAGES - 1);

    const int p = q / NCH, c = q % NCH;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int z = 0; z < 2 * GPW; ++z)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][z][r] = 0.f;
    }
    const float4* bs = b_s + (q % STAGES) * STAGE_F4;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // samples t and t+4 of this 8-deep step, at their skewed offsets
      int off[2];
      bool in[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int l = c * 16 + ks * 8 + t + 4 * u;
        in[u] = l < L;
        const int lc = in[u] ? l : L - 1;
        off[u] = STAGED ? lc + pad * __float2int_rz((lc + 0.5f) * inv_shift) : lc;
      }
      float v[2][4];  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long at = fb[i][r & 1] + off[r >> 1];
          v[i][r] = STAGED ? span[at] : __ldg(frames + at);
        }
      float4 a_hi[2], a_lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          tf32x3::split(ok[i][r & 1] && in[r >> 1] ? v[i][r] : 0.f, hi[r], lo[r]);
        a_hi[i] = make_float4(hi[0], hi[1], hi[2], hi[3]);
        a_lo[i] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
      float4 b[2 * GPW];  // per group: cos, sin
#pragma unroll
      for (int z = 0; z < 2 * GPW; ++z)
        b[z] = bs[(((wn * GPW + z / 2) * 2 + ks) * 2 + z % 2) * 32 + lane];
      tf32x3::mma3(acc, a_hi, a_lo, b);
    }
    if (c != NCH - 1) continue;

    // epilogue of pass p: its mel rows, then per warp column its power
    // rows and their mel energies
    for (int e = tid; e < GP * 8 * num_mel; e += THREADS) {  // mel_s[m][bl] = mel[bin][m]
      const int m = e / (GP * 8), bin = p * GP * 8 + e % (GP * 8);
      mel_s[e] = bin < bins ? mel[(size_t)bin * num_mel + m] : 0.f;
    }
    for (int round = 0; round < 2; ++round) {
      if (wn == round) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < GPW; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int f = wm * 32 + i * 16 + (r >> 1) * 8 + g;
              const float re = acc[i][2 * j][r], im = acc[i][2 * j + 1][r];
              pw[f * PW_LD + j * 8 + 2 * t + (r & 1)] = re * re + im * im;
            }
      }
      __syncthreads();
      // two threads per frame, each summing half of a group of at most
      // 2 * MAX_HALF_MEL bands, 4 bins per load
      const int f = tid >> 1;
      const float4* prow = reinterpret_cast<const float4*>(pw + f * PW_LD);
      for (int mg = 0; mg < num_mel; mg += 2 * MAX_HALF_MEL) {
        const int cnt = min(num_mel - mg, 2 * MAX_HALF_MEL);
        const int m0 = mg + (tid & 1) * ((cnt + 1) / 2);
        const int nm = min((cnt + 1) / 2, mg + cnt - m0);
        float sum[MAX_HALF_MEL];
#pragma unroll
        for (int u = 0; u < MAX_HALF_MEL; ++u) sum[u] = 0.f;
        for (int b4 = 0; b4 < HALF / 4; ++b4) {
          const float4 pv = prow[b4];
#pragma unroll
          for (int u = 0; u < MAX_HALF_MEL; ++u) {
            if (u >= nm) break;
            const float4 mv =
                reinterpret_cast<const float4*>(mel_s + (m0 + u) * GP * 8 + round * HALF)[b4];
            sum[u] =
                fmaf(pv.w, mv.w, fmaf(pv.z, mv.z, fmaf(pv.y, mv.y, fmaf(pv.x, mv.x, sum[u]))));
          }
        }
#pragma unroll
        for (int u = 0; u < MAX_HALF_MEL; ++u) {
          if (u >= nm) break;
          float* dst = lmel + f * num_mel + m0 + u;
          *dst = p == 0 && round == 0 ? sum[u] : *dst + sum[u];
        }
      }
      if (round == 0) __syncthreads();  // before the second round overwrites pw
    }
  }
  __syncthreads();
  for (int e = tid; e < TF * num_mel; e += THREADS) lmel[e] = logf(fmaxf(lmel[e], log_floor));
  __syncthreads();
  for (int e = tid; e < TF * num_ceps; e += THREADS) {
    const int f = e / num_ceps, cc = e % num_ceps;
    if (n0 + f >= N) continue;
    const float* lm = lmel + f * num_mel;
    float s = 0.f;
    for (int m = 0; m < num_mel; ++m) s = fmaf(lm[m], __ldg(dct + (size_t)m * num_ceps + cc), s);
    out[(n0 + f) * num_ceps + cc] = s;
  }
}

}  // namespace

extern "C" int mfcc_frames_launch(const float* frames, const float* basis, const float* mel,
                                  const float* dct, float* out, int B, int T,
                                  long long stride_b, long long stride_t, int L, int bins,
                                  int num_mel, int num_ceps, float log_floor, void* stream) {
  const long long N = (long long)B * T;
  size_t smem = fixed_smem(num_mel);
  // overlapping frames of one utterance: stage the spans if they fit
  bool staged = false;
  int pad = 0;
  if (T > 1 && stride_t > 0 && stride_t < L) {
    pad = skew_pad(stride_t);
    const long long nseg = (TF + T - 2) / T + 1 < TF ? (TF + T - 2) / T + 1 : TF;
    // TF frames in nseg spans: the most floats when every span but one has one frame
    const long long span = span_floats(TF - nseg + 1, stride_t, pad, L) +
                           (nseg - 1) * span_floats(1, stride_t, pad, L);
    if (smem + sizeof(float) * span <= (size_t)SMEM_MAX) {
      staged = true;
      smem += sizeof(float) * span;
    }
  }
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);  // > 144 bands
  const void* fn = staged ? (const void*)mfcc_frames_kernel<true>
                          : (const void*)mfcc_frames_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((N + TF - 1) / TF);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(basis);
  if (staged)
    mfcc_frames_kernel<true><<<grid, THREADS, smem, s>>>(
        frames, b4, mel, dct, out, B, T, stride_b, stride_t, L, bins, num_mel, num_ceps,
        log_floor, pad);
  else
    mfcc_frames_kernel<false><<<grid, THREADS, smem, s>>>(
        frames, b4, mel, dct, out, B, T, stride_b, stride_t, L, bins, num_mel, num_ceps,
        log_floor, pad);
  return static_cast<int>(cudaGetLastError());
}
