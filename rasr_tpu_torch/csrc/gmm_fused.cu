// Fused diagonal-GMM emission scoring for Hopper (sm_90a): wgmma on TF32
// operands fed by TMA, at fp32 accuracy (3xTF32).
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
// (N = 63,872 frames, D = 45, M = 2000, K = 8) the products are one product
// of depth P = round_up(2D, 32) per density, A = [x^2 | x | 0] (frames x
// depth) times B = [a_k; b_k] (depth x mixtures): 2*2D*N*M*K ~ 1.84e11 FLOP
// against a 511 MB output (0.16 ms of memory traffic). Each product runs
// as three TF32 products on the tensor cores (lo*hi + hi*lo + hi*hi of the
// operands split into TF32 hi and lo parts, tf32x3.cuh), which holds the
// reference's Precision.HIGHEST accuracy; three TF32 products of 1.84e11
// FLOP take at least 1.11 ms at 495 TFLOP/s: that is this kernel's bound.
// Only wgmma reaches that rate, so the design is Hopper's: operands in
// swizzled shared memory, a TMA ring fed by a producer warp, consumer
// warpgroups on wgmma. What holds it back next is L2: every unit reads
// its slice of the operand from L2, 6.1 GB per call at the main path's
// shape (499 frame blocks x 12.3 MB of hi and lo planes).
//
// Design: a persistent grid (one block per SM) walks work units of 128
// frames x 128 mixtures, frame block by frame block, each block a
// contiguous run of units, so one block reloads its frames only when its
// run crosses into the next frame block. A block has three warpgroups:
// - a producer warpgroup, of which one thread keeps the TMA ring (up to 4
//   stages) full. Registers move to the consumers with setmaxnreg (40
//   here, 232 there). Each ring stage is one TMA box of the packed operand
//   (models/gmm.py: pack_operand, [hi|lo][K][M][P] with the depth
//   contiguous, so B is K-major as TF32 wgmma requires): 32 deep x 128
//   mixtures x both planes (32 KB) of one density, completing on the
//   stage's `full` mbarrier; mixtures past M read as zero.
// - two consumer warpgroups, each owning 64 of the unit's frames. Each
//   writes its own A = [x^2 | x | 0] rows, split into hi and lo, into
//   shared memory in the 128-byte swizzle wgmma reads (x^2 is computed,
//   not copied, so no TMA brings A). Per density it runs one chain of
//   wgmma m64n128k8 over the depth (three per 8-deep step), keeping one
//   ring stage's products in flight while it releases the stage before
//   (one `empty` arrival per warp). Then it adds c_k (loaded while the
//   products run; the sums start at zero, as the reference's do) and folds
//   the density into the running min / log-sum-exp, one register per
//   output: the log-sum-exp folds pairwise, min - log(1 + exp(-|best -
//   d_k|)). The K densities of one mixture land in the same thread's
//   registers one after another, so the combine needs no shuffles. A
//   finished unit is stored from registers, two mixtures per store,
//   streamed past L2 so that the operand stays there.
//
// Models with P > 160 (D > 80), whose resident A tile (P KB per 128
// frames) would leave less than two ring stages, take the streamed
// variant: each warpgroup then rewrites a 32-deep A slab per ring stage
// into one of two slots, so any D fits.
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int TN = 128;           // frames per unit: two consumer warpgroups of 64
constexpr int TM = 128;           // mixtures per unit: the wgmma's n
constexpr int KC = 32;            // depth per ring stage: one 128-byte row of fp32
constexpr int CONSUMERS = 256;    // warpgroups 0 and 1
constexpr int THREADS = 384;      // and the producer warpgroup 2
constexpr int ACC = TM / 2;       // accumulator registers per consumer thread
constexpr int PLANE = TM * KC * 4;   // one plane of a ring stage (16 KB)
constexpr int STAGE = 2 * PLANE;     // hi and lo
constexpr int SLAB = 64 * KC * 4;    // one plane of a warpgroup's 32-deep A slab (8 KB)
constexpr int MAX_STAGES = 4;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// A = [x^2 | x | 0] of frames r0 .. r0+63, depth slabs [s0, s1), split
// into TF32 hi and lo and written as [slab][hi|lo][64 rows][128 bytes] at
// dst, 128-byte swizzled; frames past N and depth past 2D are zero
__device__ __forceinline__ void fill_a(uint8_t* dst, const float* __restrict__ x, int r0, int N,
                                       int D, int s0, int s1, int wt) {
  const int per_row = (s1 - s0) * (KC / 4);  // 16-byte chunks of a row
  for (int e = wt; e < 64 * per_row; e += 128) {
    const int r = e / per_row, j = e % per_row;
    const int n = r0 + r, d0 = s0 * KC + j * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + i;
      float xv = 0.f;
      if (n < N && d < 2 * D) {
        xv = x[(size_t)n * D + (d < D ? d : d - D)];
        if (d < D) xv *= xv;
      }
      v[i] = xv;
    }
    float4 hi, lo;
    tf32x3::split(v[0], hi.x, lo.x);
    tf32x3::split(v[1], hi.y, lo.y);
    tf32x3::split(v[2], hi.z, lo.z);
    tf32x3::split(v[3], hi.w, lo.w);
    uint8_t* row = dst + (j / 8) * 2 * SLAB + r * 128;
    const int at = ((j % 8) ^ (r & 7)) * 16;
    *reinterpret_cast<float4*>(row + at) = hi;
    *reinterpret_cast<float4*>(row + SLAB + at) = lo;
  }
}

template <bool MAX_APPROX, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
gmm_scores_kernel(const __grid_constant__ CUtensorMap bmap, const float* __restrict__ x,
                  const float* __restrict__ c, float* __restrict__ out, int N, int D, int M,
                  int K, int NC, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_tiles = ring + stages * STAGE;      // [warpgroup][slab or slot][hi|lo][64][32]
  const int a_wg = (STREAM ? 2 : NC) * 2 * SLAB;  // bytes per warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(a_tiles + 2 * a_wg);
  uint64_t* empty = full + MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], CONSUMERS / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // this block's contiguous run of units (frame block major)
  const int T = (M + TM - 1) / TM;
  const int units = ((N + TN - 1) / TN) * T;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);

  if (warp >= CONSUMERS / 32) {  // ------------------------------- producer
    sm90::regs_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      int q = 0;
      for (int u = u0; u < u1; ++u) {
        const int m0 = (u % T) * TM;
        for (int k = 0; k < K; ++k)
          for (int ch = 0; ch < NC; ++ch, ++q) {
            const int s = q % stages;
            if (q >= stages) sm90::bar_wait(&empty[s], (q / stages - 1) & 1);
            sm90::bar_expect(&full[s], STAGE);
            sm90::tma_load_4d(ring + s * STAGE, &bmap, &full[s], ch * KC, m0, k, 0);
          }
      }
    }
  } else {  // ------------------------------------------------------ consumers
    sm90::regs_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2, wt = tid & 127;
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    uint8_t* a_mine = a_tiles + wg * a_wg;
    const uint32_t a_addr = sm90::smem_addr(a_mine), ring_addr = sm90::smem_addr(ring);
    float acc[ACC], best[ACC];
    int q = 0, loaded = -1;
    for (int u = u0; u < u1; ++u) {
      const int fb = u / T, m0 = (u % T) * TM;
      const int r0 = fb * TN + 64 * wg;  // this warpgroup's first frame
      if (!STREAM && fb != loaded) {
        sm90::named_sync(1 + wg, 128);  // every warp's products on the old tile are done
        fill_a(a_mine, x, r0, N, D, 0, NC, wt);
        sm90::fence_async_smem();
        sm90::named_sync(1 + wg, 128);
        loaded = fb;
      }
#pragma unroll
      for (int i = 0; i < ACC; ++i) best[i] = INFINITY;
      for (int k = 0; k < K; ++k) {
        // c_k of this thread's mixtures, added after the products (its
        // loads run beside them)
        const float* ck = c + (size_t)k * M;
        float ckm[ACC / 2];
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int m = m0 + 8 * j + 2 * t + b;
            ckm[2 * j + b] = m < M ? __ldg(ck + m) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
        int prev = -1;
        for (int ch = 0; ch < NC; ++ch, ++q) {
          const int s = q % stages;
          int slab = ch;
          if (STREAM) {  // chunk q-2 (the same slot) is done in every warp
            slab = q & 1;
            sm90::named_sync(1 + wg, 128);
            fill_a(a_mine + slab * 2 * SLAB, x, r0, N, D, ch, ch + 1, wt);
            sm90::fence_async_smem();
            sm90::named_sync(1 + wg, 128);
          }
          sm90::bar_wait(&full[s], (q / stages) & 1);
          const uint64_t a_hi = sm90::desc_sw128(a_addr + slab * 2 * SLAB);
          const uint64_t a_lo = sm90::desc_add(a_hi, SLAB);
          const uint64_t b_hi = sm90::desc_sw128(ring_addr + s * STAGE);
          const uint64_t b_lo = sm90::desc_add(b_hi, PLANE);
          sm90::mma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 8; ++ks) {  // small terms first
            const uint32_t o = ks * 32;
            sm90::mma_ss_n128(acc, sm90::desc_add(a_lo, o), sm90::desc_add(b_hi, o));
            sm90::mma_ss_n128(acc, sm90::desc_add(a_hi, o), sm90::desc_add(b_lo, o));
            sm90::mma_ss_n128(acc, sm90::desc_add(a_hi, o), sm90::desc_add(b_hi, o));
          }
          sm90::mma_commit();
          if (prev >= 0) {  // the stage before is read: release it
            sm90::mma_wait<1>();
            if (lane == 0) sm90::bar_arrive(&empty[prev]);
          }
          prev = s;
        }
        sm90::mma_wait<0>();
        sm90::pin(acc);
        if (lane == 0) sm90::bar_arrive(&empty[prev]);

        // fold density k into the running result (+inf before the first):
        // min, or -log(exp(-best) + exp(-d_k)) = min - log(1 + exp(-|best - d_k|))
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const float dk = acc[i] + ckm[2 * (i / 4) + (i & 1)];
          const float mn = fminf(best[i], dk);
          best[i] = MAX_APPROX ? mn : mn - __logf(1.f + __expf(-fabsf(best[i] - dk)));
        }
      }

      // the unit's scores, two mixtures per store
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = r0 + 16 * w + g + 8 * h;
          const int m = m0 + 8 * j + 2 * t;
          if (n < N && m < M) {
            float* dst = out + (size_t)n * M + m;
            if ((M & 1) == 0) {
              __stcs(reinterpret_cast<float2*>(dst), make_float2(best[4 * j + 2 * h],
                                                                 best[4 * j + 2 * h + 1]));
            } else {
              dst[0] = best[4 * j + 2 * h];
              if (m + 1 < M) dst[1] = best[4 * j + 2 * h + 1];
            }
          }
        }
    }
  }
}

template <bool MAX_APPROX, bool STREAM>
int launch(const CUtensorMap& map, const float* x, const float* c, float* out, int N, int D,
           int M, int K, int NC, int stages, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gmm_scores_kernel<MAX_APPROX, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long units = (long long)((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  const int grid = (int)(units < sms ? units : sms);
  gmm_scores_kernel<MAX_APPROX, STREAM>
      <<<grid, THREADS, smem, stream>>>(map, x, c, out, N, D, M, K, NC, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gmm_scores_launch(const float* x, const float* operand, const float* c,
                                 float* out, int N, int D, int M, int K, int max_approx,
                                 void* cuda_stream) {
  const int NC = (2 * D + KC - 1) / KC;  // 32-deep chunks of the padded depth P
  const cuuint64_t P = (cuuint64_t)NC * KC;
  // the operand [hi|lo][K][M][P], cut in boxes of 32 deep x TM mixtures x 2 planes
  const cuuint64_t dims[4] = {P, (cuuint64_t)M, (cuuint64_t)K, 2};
  const cuuint64_t strides[3] = {P * 4, P * 4 * M, P * 4 * M * K};
  const cuuint32_t box[4] = {KC, TM, 1, 2};
  CUtensorMap map;
  int err = sm90::make_map(&map, operand, 4, dims, strides, box);
  if (err != 0) return err;
  const size_t fixed = 1024 + 2 * MAX_STAGES * sizeof(uint64_t);  // alignment, barriers
  size_t a_bytes = (size_t)2 * NC * 2 * SLAB;  // both warpgroups' resident A
  const bool stream = fixed + a_bytes + 2 * STAGE > (size_t)tf32x3::SMEM_MAX;
  if (stream) a_bytes = 2 * 2 * 2 * SLAB;  // two slots per warpgroup
  int stages = (int)((tf32x3::SMEM_MAX - fixed - a_bytes) / STAGE);
  stages = stages < MAX_STAGES ? stages : MAX_STAGES;
  const size_t smem = fixed + a_bytes + (size_t)stages * STAGE;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (stream)
    return max_approx ? launch<true, true>(map, x, c, out, N, D, M, K, NC, stages, smem, s)
                      : launch<false, true>(map, x, c, out, N, D, M, K, NC, stages, smem, s);
  return max_approx ? launch<true, false>(map, x, c, out, N, D, M, K, NC, stages, smem, s)
                    : launch<false, false>(map, x, c, out, N, D, M, K, NC, stages, smem, s);
}
