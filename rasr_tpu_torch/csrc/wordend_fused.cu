// Fused deferred-emission word-end block for Hopper (sm_90a).
//
// Replaces the TPU kernel examples/pallas_wordend_microbench.py::make_kernel,
// whose semantics are `xla_block` in the same file: the decoder's word-end
// stage under deferred emission (rasr_tpu/search/decoder.py, the combo row
// gather and the survivors' emission fetch before the word-end pre-score).
// For every word-end slot (b, k) of the K + R3 survivors:
//     row   = combo[w_state[b,k]]                      (one packed state row)
//     w2    = w_score < BIG/2 ? w_score + emis[b, row[4]] : BIG
//     pre   = row[0] != WORD_NONE ? w2 + bits_as_float(row[1]) : BIG
//     word, lemma, next = row[0], row[2], row[3];   spk = row[8 : 8 + C_sp]
//
// What bounds it on the H100: dependent random loads, not bytes. At the
// microbench shape (B=64, KW=1536, a 56,433 x 24 int32 combo table of
// 5.4 MB, 64 x 2000 f32 emissions of 0.5 MB, both L2-resident) it moves
// about 98k x (96 + 4 + 20 + 48) bytes = 16.5 MB, a few microseconds of
// HBM bandwidth; each slot's chain w_state -> combo row -> emission is
// three dependent loads, so latency and the launch itself set the time.
//
// Design: one thread per slot for the scalar outputs (index, the leading
// combo columns, the emission; five coalesced stores). The state-pack
// columns are then copied by the whole block, one thread per output int,
// so the [slots, C_sp] stores stay coalesced as well. The quarter-row
// emission select of the TPU kernel is a TPU layout and is not carried
// over: emis[b, cls] is read directly, so any B, KW and C are taken. Two
// fp32 adds and no multiply (`__fadd_rn` rules out contraction): the
// result is bit-identical to the plain version. Indices are assumed in
// range, as in the Pallas kernel.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e30f;
constexpr int WORD_NONE = -2147483647;  // -(2**31) + 1, the example's stand-in

__global__ void __launch_bounds__(THREADS)
wordend_kernel(const int* __restrict__ w_state, const float* __restrict__ w_score,
               const int* __restrict__ combo, const float* __restrict__ emis,
               float* __restrict__ pre, float* __restrict__ w2, int* __restrict__ word,
               int* __restrict__ lemma, int* __restrict__ nxt, int* __restrict__ spk,
               long long n, int KW, int Cc, int C, int C_sp) {
  __shared__ int rows[THREADS];
  const long long base = (long long)blockIdx.x * THREADS;
  const long long i = base + threadIdx.x;
  if (i < n) {
    const int s = w_state[i];
    rows[threadIdx.x] = s;
    const int* row = combo + (size_t)s * Cc;
    const int wd = row[0];
    const float e = emis[(size_t)(i / KW) * C + row[4]];
    const float ws = w_score[i];
    const float v = ws < 0.5f * BIG ? __fadd_rn(ws, e) : BIG;
    w2[i] = v;
    pre[i] = wd != WORD_NONE ? __fadd_rn(v, __int_as_float(row[1])) : BIG;
    word[i] = wd;
    lemma[i] = row[2];
    nxt[i] = row[3];
  }
  __syncthreads();
  const long long left = n - base;
  const int slots = left < THREADS ? (int)left : THREADS;
  int* out = spk + base * C_sp;
  for (int e = threadIdx.x; e < slots * C_sp; e += THREADS) {
    const int k = e / C_sp;
    out[e] = combo[(size_t)rows[k] * Cc + 8 + (e - k * C_sp)];
  }
}

}  // namespace

extern "C" int wordend_block_launch(const int* w_state, const float* w_score,
                                    const int* combo, const float* emis, float* pre,
                                    float* w2, int* word, int* lemma, int* nxt, int* spk,
                                    long long n, int KW, int Cc, int C, int C_sp,
                                    void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  wordend_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w_state, w_score, combo, emis, pre, w2, word, lemma, nxt, spk, n, KW, Cc, C, C_sp);
  return static_cast<int>(cudaGetLastError());
}
