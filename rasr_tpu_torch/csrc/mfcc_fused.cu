// Fused MFCC for Hopper (sm_90a): windowed DFT -> power -> mel -> log -> DCT,
// the DFT as wgmma on TF32 operands fed by TMA, at fp32 accuracy (3xTF32).
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
// On the tensor cores as three TF32 products (tf32x3.cuh, fp32 accuracy)
// it takes at least 0.16 ms at 495 TFLOP/s: that is this kernel's bound,
// and only wgmma reaches that rate. What holds it back next is the work
// beside the products: each block's prologue (its sample spans, mel
// weights and band flags), the mel sums on the fp32 pipes between passes,
// and L2, from which every block reads the whole basis (1.7 MB of hi and
// lo planes at L = 400).
//
// Design: a block owns TF = 128 consecutive frames and has three
// warpgroups:
// - a producer warpgroup, of which one thread keeps a TMA ring of the DFT
//   basis full (registers move to the consumers with setmaxnreg). The
//   basis is packed once on the host (ops/kernels/mfcc.py: pack_basis) as
//   [hi|lo][bin, cos|sin][depth], the depth contiguous, so B is K-major as
//   TF32 wgmma requires; a ring stage is one box of 32 samples x 128
//   columns (64 bins) x both planes (32 KB). When 1-4 bins remain past
//   the last whole 64 (the Nyquist bin of a power-of-two FFT), the last
//   wide pass takes 136 columns (68 bins); other remainders take passes
//   of 16 columns (8 bins). Columns past the bins and depth past L read
//   as zero.
// - two consumer warpgroups, 64 frames each. A frame tile cannot come from
//   shared memory: its rows overlap, `shift` samples apart, and a wgmma
//   descriptor's rows sit a fixed 16 bytes apart. So A comes from
//   registers (wgmma's RS form): frames of one utterance overlap, so the
//   consumers load each utterance's contiguous span of samples once into
//   shared memory, (TF-1)*shift + L samples (20,720 at 16 kHz), one span per
//   utterance when the tile crosses an utterance boundary. The span is
//   stored skewed (PAD floats after every `shift` samples) so that the 8
//   frames of a fragment, `shift` apart, fall in different banks; each
//   thread loads its A fragment straight from the span and splits it into
//   hi and lo in registers. The product [128 x L] . [L x 2*bins] runs in
//   passes of 64 bins (wgmma m64n128k8, three per 8-deep step). The
//   products of a ring stage read their A fragments from registers while
//   they run, and the compiler may give those registers to the next
//   stage's fragments, so a warpgroup waits for its products before it
//   loads the next fragments; the other warpgroup's products keep the
//   tensor cores busy meanwhile. The cos and sin columns of a bin sit side
//   by side, so re and im land in the same thread: the epilogue of a pass
//   squares and adds in registers, sums the power into each mel band over
//   the thread's 16 bins and its quad's 4 threads (shuffles), and adds the
//   band to the frame's mel energy in shared memory. The mel weights are
//   staged there once per block, transposed to [band][bin], and a band
//   without weight in a pass's bins (a mel filter spans a few passes) is
//   skipped there. After the last pass the log and the DCT run on chip.
// The spans and the mel weights sit in shared memory where they fit beside
// a ring of at least two stages (the launcher picks both, the weights
// alone, the spans alone, or neither); what does not fit is read from
// global memory, frames that do not overlap always are.
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int TF = 128;            // frames per block: two consumer warpgroups of 64
constexpr int CONSUMERS = 256;     // warpgroups 0 and 1
constexpr int THREADS = 384;       // and the producer warpgroup 2
constexpr int KC = 32;             // depth per ring stage: one 128-byte row of fp32
constexpr int WIDE = 128;          // columns of a wide pass: 64 bins x (cos, sin)
constexpr int WIDE_PLUS = 136;     // the last wide pass when 1-4 bins remain: 68 bins
constexpr int NARROW = 16;         // columns of a narrow pass: 8 bins
constexpr int STAGE = 2 * WIDE_PLUS * KC * 4;  // 34 KB: both planes of the widest box
constexpr int MAX_STAGES = 4;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// The passes over the bins: whole passes of 64 bins (n128), the last of
// them widened to 68 (n136) when 1-4 bins remain (the Nyquist bin of a
// power-of-two FFT), else passes of 8 bins (n16) for what remains.
struct Passes {
  int wide, narrow;
  bool plus;  // the last wide pass takes 68 bins
  __host__ __device__ explicit Passes(int bins) {
    wide = bins / (WIDE / 2);
    const int rem = bins - wide * (WIDE / 2);
    plus = wide > 0 && rem > 0 && rem <= (WIDE_PLUS - WIDE) / 2;
    narrow = plus ? 0 : (rem + NARROW / 2 - 1) / (NARROW / 2);
  }
  __host__ __device__ int count() const { return wide + narrow; }
  __host__ __device__ int cols(int p) const {  // columns: 2 per bin
    return p < wide ? (plus && p == wide - 1 ? WIDE_PLUS : WIDE) : NARROW;
  }
  __host__ __device__ int col0(int p) const {
    return p < wide ? p * WIDE : wide * WIDE + (p - wide) * NARROW;
  }
};

// bytes of the per-pass band flags (whole 16 bytes, so the span after them
// stays aligned)
__host__ __device__ inline int live_bytes(int bins, int num_mel) {
  return (Passes(bins).count() * num_mel + 15) / 16 * 16;
}

// shared memory besides the span: alignment, ring, barriers, frame
// offsets and span segments, mel energies, the mel weights if staged, and
// the per-pass band flags
size_t fixed_smem(int num_mel, int bins, int stages, bool mel) {
  return 1024 + (size_t)stages * STAGE + 2 * MAX_STAGES * sizeof(uint64_t) +
         TF * (sizeof(long long) * 2 + sizeof(int) * 2) + sizeof(float) * TF * num_mel +
         (mel ? sizeof(float) * num_mel * bins : 0) + live_bytes(bins, num_mel);
}

// floats a skewed span of `frames` frames of one utterance takes
__host__ __device__ inline long long span_floats(long long frames, long long shift, int pad,
                                                int L) {
  return (frames - 1) * (shift + pad) + L + (long long)pad * ((L - 1) / shift);
}

// the skew for a frame shift: the row stride shift + pad is 4 banks
int skew_pad(long long shift) { return (int)((36 - shift % 32) % 32); }

struct Consumer {
  const float* src;       // the span (staged) or the frames
  float* lmel;            // [TF][num_mel] mel energies
  const uint8_t* live;    // [pass][num_mel]: the band has weight in the pass's bins
  const float* mel;
  uint64_t* full;
  uint64_t* empty;
  uint32_t ring;          // shared address of the ring
  long long fb[2];        // where this thread's two frames start in src
  bool ok[2];             // ... and whether they exist
  int f[2];               // their rows in the block
  int L, bins, num_mel, stages, pad, lane, t;
  float inv_shift;
};

// Per mel band the sum over this thread's J bins (bin0 + 4 j + t) and its
// quad (shuffles), added to the frame's mel energy. The weights come from
// shared memory as [band][bin] (MEL) or from the global [bin][band]; they
// never alias the energies, so the next bands' weights load while a band
// is summed. Bands with no weight in the pass's bins (`live` 0: a mel
// filter covers a few passes' bins) are skipped, the same for every thread.
template <int J, bool MEL>
__device__ __forceinline__ void mel_energies(const float* __restrict__ mel,
                                             float* __restrict__ lmel,
                                             const uint8_t* __restrict__ live,
                                             const float (&pw)[2][J], int bin0, int bins,
                                             int num_mel, int t, int f0, int f1) {
#pragma unroll 2
  for (int m = 0; m < num_mel; ++m) {
    if (!live[m]) continue;
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int b = bin0 + 4 * j + t;
      const float wv = b >= bins ? 0.f
                       : MEL ? mel[m * bins + b] : __ldg(mel + (size_t)b * num_mel + m);
      e0 = fmaf(pw[0][j], wv, e0);
      e1 = fmaf(pw[1][j], wv, e1);
    }
    e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
    e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
    if (t == 0) {
      lmel[f0 * num_mel + m] += e0;
      lmel[f1 * num_mel + m] += e1;
    }
  }
}

// One pass of NW columns (NW / 2 bins from bin0) over the whole depth,
// then its mel energies. q is the ring position.
template <int NW, bool STAGED, bool MEL>
__device__ __forceinline__ void dft_pass(Consumer& cs, int pass, int bin0, int& q) {
  constexpr int R = NW / 2;  // accumulator registers
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  const int NCH = (cs.L + KC - 1) / KC;
  for (int ch = 0; ch < NCH; ++ch, ++q) {
    // this thread's A fragments of the chunk's four 8-deep steps:
    // a0 (row g, sample t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    uint32_t a_hi[KC / 8][4], a_lo[KC / 8][4];
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      int off[2];
      bool in[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int l = ch * KC + ks * 8 + cs.t + 4 * u;
        in[u] = l < cs.L;
        const int lc = in[u] ? l : cs.L - 1;
        off[u] = STAGED ? lc + cs.pad * __float2int_rz((lc + 0.5f) * cs.inv_shift) : lc;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, u = r >> 1;
        const long long at = cs.fb[h] + off[u];
        const float v = STAGED ? cs.src[at] : __ldg(cs.src + at);
        float hi, lo;
        tf32x3::split(cs.ok[h] && in[u] ? v : 0.f, hi, lo);
        a_hi[ks][r] = __float_as_uint(hi);
        a_lo[ks][r] = __float_as_uint(lo);
      }
    }
    const int s = q % cs.stages;
    sm90::bar_wait(&cs.full[s], (q / cs.stages) & 1);
    const uint64_t b_hi = sm90::desc_sw128(cs.ring + s * STAGE);
    const uint64_t b_lo = sm90::desc_add(b_hi, NW * KC * 4);
    sm90::mma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {  // small terms first
      const uint32_t o = ks * 32;
      if constexpr (NW == WIDE) {
        sm90::mma_rs_n128(acc, a_lo[ks], sm90::desc_add(b_hi, o));
        sm90::mma_rs_n128(acc, a_hi[ks], sm90::desc_add(b_lo, o));
        sm90::mma_rs_n128(acc, a_hi[ks], sm90::desc_add(b_hi, o));
      } else if constexpr (NW == WIDE_PLUS) {
        sm90::mma_rs_n136(acc, a_lo[ks], sm90::desc_add(b_hi, o));
        sm90::mma_rs_n136(acc, a_hi[ks], sm90::desc_add(b_lo, o));
        sm90::mma_rs_n136(acc, a_hi[ks], sm90::desc_add(b_hi, o));
      } else {
        sm90::mma_rs_n16(acc, a_lo[ks], sm90::desc_add(b_hi, o));
        sm90::mma_rs_n16(acc, a_hi[ks], sm90::desc_add(b_lo, o));
        sm90::mma_rs_n16(acc, a_hi[ks], sm90::desc_add(b_hi, o));
      }
    }
    sm90::mma_commit();
    // the products read their A fragments from registers while they run:
    // they finish before the next chunk's fragments are loaded
    sm90::mma_wait<0>();
    sm90::pin(acc);
    if (cs.lane == 0) sm90::bar_arrive(&cs.empty[s]);
  }

  // power of bins bin0 + 4 j + t in rows g and g+8, then per mel band the
  // sum over the thread's bins and its quad
  constexpr int J = NW / 8;
  float pw[2][J];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
      pw[h][j] = re * re + im * im;
    }
  mel_energies<J, MEL>(cs.mel, cs.lmel, cs.live + pass * cs.num_mel, pw, bin0, cs.bins,
                       cs.num_mel, cs.t, cs.f[0], cs.f[1]);
}

template <bool STAGED, bool MEL>
__global__ void __launch_bounds__(THREADS, 1) mfcc_frames_kernel(
    const __grid_constant__ CUtensorMap wide_map, const __grid_constant__ CUtensorMap plus_map,
    const __grid_constant__ CUtensorMap narrow_map, const float* __restrict__ frames,
    const float* __restrict__ mel, const float* __restrict__ dct, float* __restrict__ out, int B,
    int T, long long stride_b,
    long long stride_t, int L, int bins, int num_mel, int num_ceps, float log_floor, int pad,
    int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + MAX_STAGES;
  long long* fbase = reinterpret_cast<long long*>(empty + MAX_STAGES);  // [TF]
  long long* seg_g = fbase + TF;                        // span start in `frames`
  int* seg_s = reinterpret_cast<int*>(seg_g + TF);      // span start in `span`
  int* seg_n = seg_s + TF;                              // span length (samples)
  float* lmel = reinterpret_cast<float*>(seg_n + TF);   // [TF][num_mel] mel energies
  float* mel_t = lmel + TF * num_mel;                   // [num_mel][bins] (MEL)
  uint8_t* live = reinterpret_cast<uint8_t*>(mel_t + (MEL ? num_mel * bins : 0));
  float* span = reinterpret_cast<float*>(live + live_bytes(bins, num_mel));  // skewed samples

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NCH = (L + KC - 1) / KC;
  const Passes ps(bins);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], CONSUMERS / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // ------------------------------- producer
    sm90::regs_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      int q = 0;
      for (int p = 0; p < ps.count(); ++p) {
        const int cols = ps.cols(p);
        const CUtensorMap* map =
            cols == WIDE ? &wide_map : cols == WIDE_PLUS ? &plus_map : &narrow_map;
        for (int ch = 0; ch < NCH; ++ch, ++q) {
          const int s = q % stages;
          if (q >= stages) sm90::bar_wait(&empty[s], (q / stages - 1) & 1);
          sm90::bar_expect(&full[s], 2 * cols * KC * 4);
          sm90::tma_load_3d(ring + s * STAGE, map, &full[s], ch * KC, ps.col0(p), 0);
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------------- consumers
  sm90::regs_alloc<CONSUMER_REGS>();
  const long long N = (long long)B * T;
  const long long n0 = (long long)blockIdx.x * TF;

  // Where each frame's samples start: in `span` (staged, skewed) or in
  // `frames`. The tile's valid frames fall into nseg utterances: a first
  // span of cnt0 frames, full utterances of T frames, and a last one.
  const int valid = (int)(N - n0 < TF ? N - n0 : TF);
  const int b0 = (int)(n0 / T), t0 = (int)(n0 % T);
  const int cnt0 = T - t0 < valid ? T - t0 : valid;
  const int nseg = STAGED ? (int)((n0 + valid - 1) / T) - b0 + 1 : 0;
  const int whole = STAGED ? (int)span_floats(T, stride_t, pad, L) : 0;
  const int first = STAGED ? (int)span_floats(cnt0, stride_t, pad, L) : 0;
  if (tid < TF) {
    long long base = -1;
    if (tid < valid) {
      const long long n = n0 + tid;
      const int b = (int)(n / T), tt = (int)(n % T);
      if (STAGED) {
        const int j = b - b0;  // j > 0: a whole utterance from its frame 0
        base = (j == 0 ? 0 : first + (j - 1) * whole) + (j == 0 ? tt - t0 : tt) * (stride_t + pad);
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
    seg_s[tid] = tid == 0 ? 0 : first + (tid - 1) * whole;
    seg_n[tid] = (cnt - 1) * (int)stride_t + L;
  }
  sm90::named_sync(1, CONSUMERS);
  const float inv_shift = 1.f / (float)stride_t;
  for (int j = 0; j < nseg; ++j) {  // the spans, skewed
    const float* src = frames + seg_g[j];
    float* dst = span + seg_s[j];
    for (int i = tid; i < seg_n[j]; i += CONSUMERS)
      tf32x3::cp_async4(dst + i + pad * __float2int_rz((i + 0.5f) * inv_shift), src + i);
  }
  tf32x3::cp_async_commit();
  for (int e = tid; MEL && e < num_mel * bins; e += CONSUMERS)  // the weights, transposed
    mel_t[(e % num_mel) * bins + e / num_mel] = mel[e];
  for (int e = tid; e < TF * num_mel; e += CONSUMERS) lmel[e] = 0.f;
  for (int e = tid; e < ps.count() * num_mel; e += CONSUMERS) {
    const int p = e / num_mel, m = e % num_mel;  // any weight of band m in pass p's bins?
    const int b0 = ps.col0(p) / 2, b1 = min(bins, b0 + ps.cols(p) / 2);
    bool any = false;  // (no early exit: the loads go out together)
#pragma unroll 8
    for (int b = b0; b < b1; ++b) any |= __ldg(mel + (size_t)b * num_mel + m) != 0.f;
    live[e] = any;
  }
  tf32x3::cp_async_wait<0>();
  sm90::named_sync(1, CONSUMERS);

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2;
  Consumer cs;
  cs.src = STAGED ? span : frames;
  cs.lmel = lmel;
  cs.live = live;
  cs.mel = MEL ? mel_t : mel;
  cs.full = full;
  cs.empty = empty;
  cs.ring = sm90::smem_addr(ring);
  cs.L = L;
  cs.bins = bins;
  cs.num_mel = num_mel;
  cs.stages = stages;
  cs.pad = pad;
  cs.lane = lane;
  cs.t = lane & 3;
  cs.inv_shift = inv_shift;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // frames past N read a valid address and are zeroed
    cs.f[h] = 64 * wg + 16 * w + g + 8 * h;
    const long long v = fbase[cs.f[h]];
    cs.ok[h] = v >= 0;
    cs.fb[h] = v >= 0 ? v : 0;
  }
  int q = 0;
  for (int p = 0; p < ps.count(); ++p) {
    const int cols = ps.cols(p), bin0 = ps.col0(p) / 2;
    if (cols == WIDE)
      dft_pass<WIDE, STAGED, MEL>(cs, p, bin0, q);
    else if (cols == WIDE_PLUS)
      dft_pass<WIDE_PLUS, STAGED, MEL>(cs, p, bin0, q);
    else
      dft_pass<NARROW, STAGED, MEL>(cs, p, bin0, q);
  }

  // log and DCT of this warpgroup's 64 frames
  const int wt = tid & 127;
  float* mine = lmel + 64 * wg * num_mel;
  sm90::named_sync(2 + wg, 128);
  for (int e = wt; e < 64 * num_mel; e += 128) mine[e] = logf(fmaxf(mine[e], log_floor));
  sm90::named_sync(2 + wg, 128);
  for (int e = wt; e < 64 * num_ceps; e += 128) {
    const int f = e / num_ceps, cc = e % num_ceps;
    const long long n = n0 + 64 * wg + f;
    if (n >= N) continue;
    const float* lm = mine + f * num_mel;
    float s = 0.f;
    for (int m = 0; m < num_mel; ++m) s = fmaf(lm[m], __ldg(dct + (size_t)m * num_ceps + cc), s);
    out[n * num_ceps + cc] = s;
  }
}

struct Launch {
  const CUtensorMap& wide_map;
  const CUtensorMap& plus_map;
  const CUtensorMap& narrow_map;
  const float *frames, *mel, *dct;
  float* out;
  int B, T;
  long long stride_b, stride_t;
  int L, bins, num_mel, num_ceps;
  float log_floor;
  int pad, stages;
  size_t smem;
  cudaStream_t stream;
};

template <bool STAGED, bool MEL>
int launch(const Launch& a) {
  cudaError_t e = cudaFuncSetAttribute(mfcc_frames_kernel<STAGED, MEL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(((long long)a.B * a.T + TF - 1) / TF);
  mfcc_frames_kernel<STAGED, MEL><<<grid, THREADS, a.smem, a.stream>>>(
      a.wide_map, a.plus_map, a.narrow_map, a.frames, a.mel, a.dct, a.out, a.B, a.T, a.stride_b,
      a.stride_t, a.L, a.bins, a.num_mel, a.num_ceps, a.log_floor, a.pad, a.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mfcc_frames_launch(const float* frames, const float* basis, const float* mel,
                                  const float* dct, float* out, int B, int T,
                                  long long stride_b, long long stride_t, int L, int bins,
                                  int num_mel, int num_ceps, float log_floor, void* stream) {
  const cuuint64_t Lp = (cuuint64_t)(L + KC - 1) / KC * KC;
  // the basis [hi|lo][2 bins][Lp], cut in boxes of 32 deep x 128, 136 or 16
  // columns x 2 planes
  const cuuint64_t dims[3] = {Lp, (cuuint64_t)2 * bins, 2};
  const cuuint64_t strides[2] = {Lp * 4, Lp * 4 * 2 * bins};
  const cuuint32_t wide_box[3] = {KC, WIDE, 2}, plus_box[3] = {KC, WIDE_PLUS, 2},
                   narrow_box[3] = {KC, NARROW, 2};
  CUtensorMap wide_map, plus_map, narrow_map;
  int err = sm90::make_map(&wide_map, basis, 3, dims, strides, wide_box);
  if (err == 0) err = sm90::make_map(&plus_map, basis, 3, dims, strides, plus_box);
  if (err == 0) err = sm90::make_map(&narrow_map, basis, 3, dims, strides, narrow_box);
  if (err != 0) return err;
  // shared memory beside a ring of 3 stages, or 2: the spans of the
  // utterances' overlapping frames and the mel weights, both where they
  // fit, else the weights alone, else the spans alone, else neither
  size_t span = 0;
  int pad = 0;
  if (T > 1 && stride_t > 0 && stride_t < L) {
    pad = skew_pad(stride_t);
    const long long nseg = (TF + T - 2) / T + 1 < TF ? (TF + T - 2) / T + 1 : TF;
    // TF frames in nseg spans: the most floats when every span but one has one frame
    span = sizeof(float) * (span_floats(TF - nseg + 1, stride_t, pad, L) +
                            (nseg - 1) * span_floats(1, stride_t, pad, L));
  }
  const bool choices[4][2] = {{true, true}, {false, true}, {true, false}, {false, false}};
  int stages = 0;
  bool staged = false, mel_staged = false;
  size_t smem = 0;
  for (int c = 0; c < 4 && stages == 0; ++c) {
    if (choices[c][0] && span == 0) continue;
    for (int st = 3; st >= 2 && stages == 0; --st) {
      const size_t need = fixed_smem(num_mel, bins, st, choices[c][1]) + (choices[c][0] ? span : 0);
      if (need <= (size_t)tf32x3::SMEM_MAX) {
        stages = st;
        staged = choices[c][0];
        mel_staged = choices[c][1];
        smem = need;
      }
    }
  }
  if (stages == 0) return static_cast<int>(cudaErrorInvalidValue);  // > 307 bands at 257 bins
  const Launch a{wide_map, plus_map, narrow_map, frames, mel, dct, out, B, T,
                 stride_b, stride_t, L, bins, num_mel, num_ceps, log_floor, pad, stages,
                 smem, static_cast<cudaStream_t>(stream)};
  if (staged) return mel_staged ? launch<true, true>(a) : launch<true, false>(a);
  return mel_staged ? launch<false, true>(a) : launch<false, false>(a);
}
