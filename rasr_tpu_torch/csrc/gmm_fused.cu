// Fused diagonal-GMM emission scoring for Hopper (sm_90a), on the tensor
// cores at fp32 accuracy (3xTF32).
//
// Replaces the TPU kernel rasr_tpu/ops/pallas/gmm_kernel.py::gmm_scores_pallas
// (its `_kernel` and the wrapper `mixture_scores_fused`).
//
// Computes, for frames x [N, D] and K densities per mixture,
//     d_k[n, m] = c_k[m] + sum_d x[n,d]^2 a_k[d,m] + x[n,d] b_k[d,m]
//     out[n, m] = min_k d_k[n,m]                          (max_approx)
//               = m* - log sum_k exp(-(d_k[n,m] - m*))    (m* = min_k d_k)
// Padding densities carry c = PAD_SCORE, so they never win the min and
// vanish from the sum. The [N, M*K] per-density tensor never reaches
// device memory: only [N, M] is written.
//
// What bounds it on the H100: operations. At the main path's shape
// (N = 63,872 frames, D = 45, M = 2000, K = 8) the two products are
// 2*2*N*D*M*K ~ 1.8e11 FLOP against a 511 MB output: 2.75 ms at the fp32
// pipes' 67 TFLOP/s, 0.16 ms of memory traffic. The design moves the
// products onto the tensor cores: one product of depth P = round_up(2D, 32)
// with A = [x^2 | x] and B = [a_k; b_k] per density, as three TF32
// mma.sync products (tf32x3.cuh), which hold the reference's
// Precision.HIGHEST accuracy; c is added exactly in the epilogue. Three
// TF32 products of 1.8e11 FLOP take at least 1.11 ms at 495 TFLOP/s: that
// is this kernel's bound.
//
// Design: a block owns TN = 128 frames and keeps their A operand (x^2 and
// x, split into hi/lo once, on load) resident in shared memory in fragment
// order (128 x P x 2 planes: 96 KB at D = 45). It walks over mixture tiles
// of 64; per tile and density the B operand, packed once on the host in
// fragment order (models/gmm.py: pack_operand), streams through a 3-stage
// cp.async ring in chunks of a density's whole depth (up to 96: one block
// barrier per density and tile; 32 for deeper models), so the next chunks'
// loads overlap this chunk's products; B stays fp32 on the way (the ring is fed
// from L2, and hi/lo planes would double its traffic) and is split into
// hi/lo in registers. Eight warps each own 32 frames x 32
// mixtures (2 x 4 m16n8 tiles); the K densities of one mixture land in the
// same thread's accumulators one after another, so the min / online
// log-sum-exp over k runs in registers with no shuffles. Ragged N, M and D
// are zero-filled (frames on load, mixtures and depth in the packed
// operand) and masked on store. A finished tile goes through shared memory
// so that each warp stores whole rows (float4 per thread), and c_k is
// fetched at a density's first chunk so its latency hides behind the
// products.
//
// Models deeper than D = 80 (a resident tile of more than 160 KB) take
// the streamed variant: each ring stage then also carries the chunk's
// frames, copied as raw x (128 x 32 floats, in fragment order) and
// squared and split in registers, so shared memory holds no resident tile
// and any D fits.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int TN = 128;          // frames per block
constexpr int TM = 64;           // mixtures per tile
constexpr int THREADS = 256;     // 8 warps: 4 along frames x 2 along mixtures
constexpr int MAX_CHUNK_STEPS = 12;  // a density's whole depth per chunk, up to 96
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int STEP_F4 = (TM / 8) * 32 / 2;  // float4 per 8-deep step of a tile (2 KB)
constexpr int OUT_LD = TM + 4;  // staged output row stride (16-byte rows, skewed banks)

// smem float4 of the resident frame tile, and of one ring stage
__host__ __device__ constexpr int resident_f4(int KS) { return (TN / 16) * KS * 2 * 32; }
__host__ __device__ constexpr int stage_f4(int CS, bool stream) {
  return CS * STEP_F4 + (stream ? (TN / 16) * CS * 32 : 0);
}

template <bool MAX_APPROX, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
gmm_scores_kernel(const float* __restrict__ x, const float4* __restrict__ operand,
                  const float* __restrict__ c, float* __restrict__ out, int N, int D,
                  int M, int K, int KS, int CS) {
  extern __shared__ float4 smem[];
  float4* a_s = smem;                                   // [TN/16][KS][2][32] (resident)
  float4* b_s = a_s + (STREAM ? 0 : resident_f4(KS));   // [STAGES][stage]: B, then raw A
  const int stage = stage_f4(CS, STREAM);
  float* o_s = reinterpret_cast<float*>(b_s + STAGES * stage);  // [TN][OUT_LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int P = KS * 8;
  const int NC = KS / CS;  // chunks per density
  const int chunk_f4 = CS * STEP_F4;
  const int T = (M + TM - 1) / TM;
  const int tiles = (T - 1 - (int)blockIdx.y) / (int)gridDim.y + 1;
  const int Q = tiles * K * NC;

  auto issue = [&](int q) {
    if (q < Q) {
      const int tile = blockIdx.y + (q / (K * NC)) * gridDim.y;
      const int kc = q % (K * NC);  // = k * NC + chunk
      const float4* src = operand + ((size_t)tile * K * NC + kc) * chunk_f4;
      float4* dst = b_s + (q % STAGES) * stage;
      for (int i = tid; i < chunk_f4; i += THREADS) tf32x3::cp_async16(dst + i, src + i);
      if (STREAM) {  // the chunk's raw [x | x | 0] columns, in fragment order
        float* a_dst = reinterpret_cast<float*>(dst + chunk_f4);
        const int w = CS * 8, d0 = (kc % NC) * w;
        for (int e = tid; e < TN * w; e += THREADS) {
          const int r = e / w, dl = e % w;
          const int n = n0 + r, d = d0 + dl;
          float* slot = a_dst + ((r >> 4) * CS + (dl >> 3)) * 128 + tf32x3::a_slot(r & 15, dl & 7);
          if (n < N && d < 2 * D)
            tf32x3::cp_async4(slot, x + (size_t)n * D + (d < D ? d : d - D));
          else
            *slot = 0.f;
        }
      }
    }
    tf32x3::cp_async_commit();
  };
  for (int q = 0; q < STAGES - 1; ++q) issue(q);

  // A = [x^2 | x | 0], split into hi/lo once, stored in fragment order
  float* a_f = reinterpret_cast<float*>(a_s);
  for (int e = tid; !STREAM && e < TN * P; e += THREADS) {
    const int r = e / P, d = e % P;
    const int n = n0 + r;
    float v = 0.f;
    if (n < N && d < 2 * D) {
      const float xv = x[(size_t)n * D + (d < D ? d : d - D)];
      v = d < D ? xv * xv : xv;
    }
    float hi, lo;
    tf32x3::split(v, hi, lo);
    float* tile = a_f + (((r >> 4) * KS + (d >> 3)) * 2) * 128;
    const int slot = tf32x3::a_slot(r & 15, d & 7);
    tile[slot] = hi;
    tile[128 + slot] = lo;
  }

  float acc[2][4][4], best[2][4][4], ssum[2][4][4], ck[4][2];
  for (int q = 0; q < Q; ++q) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(q + STAGES - 1);

    const int chunk = q % NC;
    const int k = (q / NC) % K;
    const int tile = blockIdx.y + (q / (K * NC)) * gridDim.y;
    const int mbase = tile * TM + wn * 32 + 2 * t;
    if (chunk == 0) {  // c_k of this density: its load overlaps the products
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int m = mbase + j * 8 + col;
          ck[j][col] = m < M ? c[(size_t)k * M + m] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
    const float2* bs = reinterpret_cast<const float2*>(b_s + (q % STAGES) * stage);
#pragma unroll 4
    for (int ss = 0; ss < CS; ++ss) {
      const int s = chunk * CS + ss;
      float4 a_hi[2], a_lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (STREAM) {  // a0, a1 in column t, a2, a3 in t + 4; squared where d < D
          float4 v = b_s[(q % STAGES) * stage + chunk_f4 + ((2 * wm + i) * CS + ss) * 32 + lane];
          const bool sq0 = s * 8 + t < D, sq1 = s * 8 + t + 4 < D;
          v = make_float4(sq0 ? v.x * v.x : v.x, sq0 ? v.y * v.y : v.y,
                          sq1 ? v.z * v.z : v.z, sq1 ? v.w * v.w : v.w);
          tf32x3::split(v.x, a_hi[i].x, a_lo[i].x);
          tf32x3::split(v.y, a_hi[i].y, a_lo[i].y);
          tf32x3::split(v.z, a_hi[i].z, a_lo[i].z);
          tf32x3::split(v.w, a_hi[i].w, a_lo[i].w);
        } else {
          const float4* at = a_s + (((2 * wm + i) * KS + s) * 2) * 32;
          a_hi[i] = at[lane];
          a_lo[i] = at[32 + lane];
        }
      }
      float4 b[4];  // (hi b0, hi b1, lo b0, lo b1), split on the way in
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = bs[(ss * (TM / 8) + wn * 4 + j) * 32 + lane];
        tf32x3::split(v.x, b[j].x, b[j].z);
        tf32x3::split(v.y, b[j].y, b[j].w);
      }
      tf32x3::mma3(acc, a_hi, a_lo, b);
    }
    if (chunk != NC - 1) continue;

    // epilogue of density k: add c_k and combine into the running result
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = half * 2 + col;
            const float dk = acc[i][j][r] + ck[j][col];
            if (k == 0) {
              best[i][j][r] = dk;
              ssum[i][j][r] = 1.f;
            } else if (MAX_APPROX) {
              best[i][j][r] = fminf(best[i][j][r], dk);
            } else {
              const float mn = fminf(best[i][j][r], dk);
              ssum[i][j][r] = ssum[i][j][r] * expf(mn - best[i][j][r]) + expf(mn - dk);
              best[i][j][r] = mn;
            }
          }
      }
    if (k != K - 1) continue;

    // the tile's scores: staged in shared memory, then whole rows of 64
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const int r = half * 2 + col;
            v[col] = MAX_APPROX ? best[i][j][r] : best[i][j][r] - logf(ssum[i][j][r]);
          }
          const int row = wm * 32 + i * 16 + half * 8 + g;
          *reinterpret_cast<float2*>(o_s + row * OUT_LD + wn * 32 + j * 8 + 2 * t) =
              make_float2(v[0], v[1]);
        }
    __syncthreads();
    for (int e = tid; e < TN * TM / 4; e += THREADS) {
      const int row = e / (TM / 4), m = tile * TM + (e % (TM / 4)) * 4;
      const int n = n0 + row;
      if (n >= N || m >= M) continue;
      const float4 v = *reinterpret_cast<const float4*>(o_s + row * OUT_LD + m - tile * TM);
      float* dst = out + (size_t)n * M + m;
      if ((M & 3) == 0) {
        __stcs(reinterpret_cast<float4*>(dst), v);  // streamed: keep L2 for the operand
      } else {
        dst[0] = v.x;
        if (m + 1 < M) dst[1] = v.y;
        if (m + 2 < M) dst[2] = v.z;
        if (m + 3 < M) dst[3] = v.w;
      }
    }
  }
}

}  // namespace

extern "C" int gmm_scores_launch(const float* x, const float* operand, const float* c,
                                 float* out, int N, int D, int M, int K, int max_approx,
                                 void* cuda_stream) {
  int KS = (2 * D + 31) / 32 * 4;  // 8-deep steps of the padded depth
  int CS = KS <= MAX_CHUNK_STEPS ? KS : 4;  // steps per chunk (KS is a multiple of 4)
  const size_t out_smem = sizeof(float) * TN * OUT_LD;
  size_t smem = sizeof(float4) * (resident_f4(KS) + STAGES * stage_f4(CS, false)) + out_smem;
  const bool stream = smem > (size_t)tf32x3::SMEM_MAX;
  if (stream) smem = sizeof(float4) * STAGES * stage_f4(CS, true) + out_smem;
  const void* fn = stream ? (max_approx ? (const void*)gmm_scores_kernel<true, true>
                                        : (const void*)gmm_scores_kernel<false, true>)
                          : (max_approx ? (const void*)gmm_scores_kernel<true, false>
                                        : (const void*)gmm_scores_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for two waves: more mixture-tile groups when N is small
  const int frame_blocks = (N + TN - 1) / TN;
  const int tiles = (M + TM - 1) / TM;
  int groups = (264 + frame_blocks - 1) / frame_blocks;
  groups = groups < 1 ? 1 : (groups > tiles ? tiles : groups);
  const dim3 grid(frame_blocks, groups);
  const float4* op = reinterpret_cast<const float4*>(operand);
  void* args[] = {&x, &op, &c, &out, &N, &D, &M, &K, &KS, &CS};
  return static_cast<int>(cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem,
                                           static_cast<cudaStream_t>(cuda_stream)));
}
