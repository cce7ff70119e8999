// K9: the detection read-out's post-process, ops/nms.postprocess_cuda (the
// function of models/yolox_head.postprocess_plain: boxes, class max, score
// and class-offset NMS with a fixed output size).
//
// Replaces no TPU kernel: the JAX package's postprocess and nms_fixed
// (eventad_tpu/models/yolox_head.py) are jnp code that XLA lowers, the
// greedy pass a lax.fori_loop inside the program.  PyTorch runs the plain
// version eagerly: two stable sorts, the IoU matrix, the gathers, the box
// arithmetic and a Python loop of A greedy steps of three operations each,
// about 585 operations a read at 175 anchors, and on the H100 their host
// dispatch, not the card, is the cost.  One block does one image, all of it
// in shared memory:
//
//   1. per anchor: the xyxy box, the class max (the first index on ties, the
//      first NaN where there is one, as max(-1) on the card), the score
//      obj * conf, the thresholded score s (-inf below conf_threshold) and
//      the class-offset box with its area;
//   2. per anchor its stable descending rank by counting,
//      #{j: s_j > s_i} + #{j < i: s_j == s_i}, which is argsort(-s,
//      stable=True): no s is NaN, and a threshold above 0 leaves no signed
//      zero, which PyTorch's sorts order differently by length;
//   3. the suppression bitmask by rank: row r, bit j set where j > r and
//      IoU(r, j) > iou_threshold, one thread a 32-bit word, for the rows of
//      a finite s only (the greedy pass reads no other);
//   4. the greedy pass: one warp, each lane one word of the keep set (at
//      most 32 words, so at most kMaxAnchors anchors), which starts as the
//      finite s; at step r the lane that holds bit r broadcasts it, and
//      where it is set every lane clears row r's bits from its word;
//   5. compaction: with __popc prefix sums, slot k of the first
//      M = min(A, max_out) takes the k-th kept anchor in rank order, then
//      the others in rank order, as the plain version's second stable
//      argsort and its gathers do; the mask is the keep bit.
//
// Arithmetic: each product, sum, difference and quotient rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nothing contracted into an
// FMA), the halving as PyTorch divides by a scalar on the card (times the
// scalar's reciprocal, 0.5), minimum, maximum and the clamps propagating NaN
// as PyTorch's do, and the thresholds compared in f32 as written (>= for the
// score, > for the IoU): the outputs equal the plain version's on the card
// bit for bit.
//
// What bounds it on the H100: the launch.  An image's inputs (A x (5 + C)
// f32) and outputs are a few kB, and its work, some 30 000 comparisons and
// as many IoUs at A = 175, takes microseconds on one SM; B images run as B
// blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAnchors = 1024;   // keep equal to ops/nms.MAX_ANCHORS
constexpr int kMaxClasses = 32;     // keep equal to ops/nms.MAX_CLASSES

struct Params {
  const float* decoded;   // [B, A, D], D >= 5 + C
  int a, d, c, m;
  float conf_thr, iou_thr, offset_scale;
  float* boxes;           // [B, M, 4]
  float* scores;          // [B, M]
  long long* labels;      // [B, M]
  uint8_t* mask;          // [B, M]
};

// torch.minimum / torch.maximum: NaN where either is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
// clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// _iou_matrix's entry of two class-offset xyxy boxes and their areas
__device__ __forceinline__ float iou(const float4 p, const float4 q,
                                     float area_p, float area_q) {
  const float ow = clamp_lo(__fsub_rn(min_nan(p.z, q.z), max_nan(p.x, q.x)),
                            0.f);
  const float oh = clamp_lo(__fsub_rn(min_nan(p.w, q.w), max_nan(p.y, q.y)),
                            0.f);
  const float inter = __fmul_rn(ow, oh);
  // clamp(min=1e-9): the Python constant rounded to f32, as PyTorch
  // rounds a scalar for an f32 tensor
  const float den = clamp_lo(__fsub_rn(__fadd_rn(area_p, area_q), inter),
                             static_cast<float>(1e-9));
  return __fdiv_rn(inter, den);
}

// shared memory of an image of n anchors: the per-anchor records, the
// rank -> anchor map, the keep words with their prefix counts, and the
// bitmask, n rows of `words` 32-bit words
struct Smem {
  float4* sbox;     // [n] class-offset boxes
  float4* box;      // [n] boxes
  float* area;      // [n] of the class-offset boxes
  float* score;     // [n]
  float* s;         // [n] thresholded scores
  int* label;       // [n]
  int* order;       // [n] anchor of rank r
  uint32_t* keep;   // [32]
  uint32_t* excl;   // [33]: exclusive prefix counts, then the total
  uint32_t* sup;    // [n * words]
};

__host__ __device__ inline size_t smem_bytes(int n) {
  const int words = (n + 31) / 32;
  return static_cast<size_t>(n) * (2 * sizeof(float4) + 5 * sizeof(float)) +
         (32 + 33) * sizeof(uint32_t) +
         static_cast<size_t>(n) * words * sizeof(uint32_t);
}

__device__ inline Smem carve(unsigned char* base, int n) {
  Smem sm;
  sm.sbox = reinterpret_cast<float4*>(base);
  sm.box = sm.sbox + n;
  sm.area = reinterpret_cast<float*>(sm.box + n);
  sm.score = sm.area + n;
  sm.s = sm.score + n;
  sm.label = reinterpret_cast<int*>(sm.s + n);
  sm.order = sm.label + n;
  sm.keep = reinterpret_cast<uint32_t*>(sm.order + n);
  sm.excl = sm.keep + 32;
  sm.sup = sm.excl + 33;
  return sm;
}

__global__ void __launch_bounds__(kThreads) postprocess_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.a, words = (n + 31) / 32, tid = threadIdx.x;
  const Smem sm = carve(smem_raw, n);
  const long long img = blockIdx.x;

  // ---- 1. box, class max, score, class-offset box ----
  for (int i = tid; i < n; i += kThreads) {
    const float* row = p.decoded + (img * n + i) * p.d;
    const float x = row[0], y = row[1], w = row[2], h = row[3];
    const float x1 = __fsub_rn(x, __fmul_rn(w, 0.5f));
    const float y1 = __fsub_rn(y, __fmul_rn(h, 0.5f));
    const float x2 = __fadd_rn(x1, w), y2 = __fadd_rn(y1, h);
    float conf = row[5];
    int label = 0;
    for (int k = 1; k < p.c; ++k) {
      const float v = row[5 + k];
      if (!isnan(conf) && (isnan(v) || v > conf)) {
        conf = v;
        label = k;
      }
    }
    const float score = __fmul_rn(row[4], conf);
    const float off = __fmul_rn(static_cast<float>(label), p.offset_scale);
    const float4 sb = make_float4(__fadd_rn(x1, off), __fadd_rn(y1, off),
                                  __fadd_rn(x2, off), __fadd_rn(y2, off));
    sm.box[i] = make_float4(x1, y1, x2, y2);
    sm.sbox[i] = sb;
    sm.area[i] = __fmul_rn(clamp_lo(__fsub_rn(sb.z, sb.x), 0.f),
                           clamp_lo(__fsub_rn(sb.w, sb.y), 0.f));
    sm.score[i] = score;
    sm.s[i] = score >= p.conf_thr ? score : __int_as_float(0xff800000);
    sm.label[i] = label;
  }
  __syncthreads();

  // ---- 2. stable descending rank ----
  for (int i = tid; i < n; i += kThreads) {
    const float si = sm.s[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const float sj = sm.s[j];
      r += (sj > si) | ((j < i) & (sj == si));
    }
    sm.order[r] = i;
  }
  __syncthreads();

  // ---- 3. suppression bitmask, by rank ----
  for (int q = tid; q < n * words; q += kThreads) {
    const int r = q / words, w = q - r * words;
    const int ai = sm.order[r];
    if (!isfinite(sm.s[ai])) continue;
    const float4 bi = sm.sbox[ai];
    const float area_i = sm.area[ai];
    const int j0 = max(32 * w, r + 1), j1 = min(32 * w + 32, n);
    uint32_t bits = 0;
    for (int j = j0; j < j1; ++j) {
      const int aj = sm.order[j];
      if (iou(bi, sm.sbox[aj], area_i, sm.area[aj]) > p.iou_thr)
        bits |= 1u << (j - 32 * w);
    }
    sm.sup[q] = bits;
  }
  __syncthreads();

  // ---- 4. greedy pass, one warp; the keep words' prefix counts ----
  if (tid < 32) {
    const int lane = tid;
    uint32_t keep = 0;
    for (int k = 0; k < 32; ++k) {
      const int r = 32 * lane + k;
      if (r < n && isfinite(sm.s[sm.order[r]])) keep |= 1u << k;
    }
    for (int r = 0; r < n; ++r) {
      const uint32_t owner = __shfl_sync(0xffffffffu, keep, r >> 5);
      if (((owner >> (r & 31)) & 1u) && lane < words)
        keep &= ~sm.sup[r * words + lane];
    }
    const uint32_t cnt = __popc(keep);
    uint32_t incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    sm.keep[lane] = keep;
    sm.excl[lane] = incl - cnt;
    if (lane == 31) sm.excl[32] = incl;
  }
  __syncthreads();

  // ---- 5. compaction: the kept in rank order, then the others ----
  const uint32_t total = sm.excl[32];
  for (int r = tid; r < n; r += kThreads) {
    const uint32_t kw = sm.keep[r >> 5];
    const int bit = r & 31;
    const bool kept = (kw >> bit) & 1u;
    const uint32_t before = sm.excl[r >> 5] + __popc(kw & ((1u << bit) - 1u));
    const uint32_t pos = kept ? before : total + (r - before);
    if (pos >= static_cast<uint32_t>(p.m)) continue;
    const int ai = sm.order[r];
    const long long o = img * p.m + pos;
    reinterpret_cast<float4*>(p.boxes)[o] = sm.box[ai];
    p.scores[o] = sm.score[ai];
    p.labels[o] = sm.label[ai];
    p.mask[o] = kept;
  }
}

}  // namespace

// decoded [B, A, D] f32 contiguous; dims = (B, A, D, C, M), 1 <= A <=
// kMaxAnchors, 1 <= C <= kMaxClasses, D >= 5 + C, 1 <= M <= A; thr =
// (conf_threshold, iou_threshold, max(width, height) + 1) as f32 -> boxes
// [B, M, 4] f32, scores [B, M] f32, labels [B, M] int64, mask [B, M] bool.
// One launch of B blocks.
EVENTAD_API int eventad_postprocess(const void* decoded, const int* dims,
                                    const float* thr, void* boxes,
                                    void* scores, void* labels, void* mask,
                                    void* stream) {
  Params p;
  const int b = dims[0];
  p.a = dims[1];
  p.d = dims[2];
  p.c = dims[3];
  p.m = dims[4];
  if (b < 1 || p.a < 1 || p.a > kMaxAnchors || p.c < 1 ||
      p.c > kMaxClasses || p.d < 5 + p.c || p.m < 1 || p.m > p.a)
    return static_cast<int>(cudaErrorInvalidValue);
  p.decoded = static_cast<const float*>(decoded);
  p.conf_thr = thr[0];
  p.iou_thr = thr[1];
  p.offset_scale = thr[2];
  p.boxes = static_cast<float*>(boxes);
  p.scores = static_cast<float*>(scores);
  p.labels = static_cast<long long*>(labels);
  p.mask = static_cast<uint8_t*>(mask);
  const size_t bytes = smem_bytes(p.a);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        postprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  postprocess_kernel<<<static_cast<unsigned>(b), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
