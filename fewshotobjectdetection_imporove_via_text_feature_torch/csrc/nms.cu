// Exact greedy NMS over score-sorted boxes, batched over images, for Hopper.
//
// Replaces the JAX package's Pallas kernel `_nms_kernel`
// (fewshotobjectdetection_imporove_via_text_feature_tpu/ops/nms_pallas.py,
// launched from `nms_pallas_sorted`), and computes what its plain version
// `nms_sorted_plain` (ops/nms.py of this package) and the JAX `nms_fixed`
// compute: box k is kept iff it is valid and no kept box before it has
// IoU > thresh with it. With max_keep >= 0 the sweep stops before the first
// 128-box tile whose start finds at least max_keep boxes kept; later flags
// stay 0, exactly as the tiled versions stop.
//
// Bit-exactness: the IoU is written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn so that nvcc cannot contract it into FMAs, in the operation
// order of box_ops.pairwise_iou:
//   area = (x2 - x1) * (y2 - y1); iw = max(min(x2) - max(x1), 0);
//   inter = iw * ih; union = (a1 + a2) - inter; iou = union > 0 ? inter /
//   union : 0.  IoU is symmetric bit for bit (+, *, min, max commute).
//
// What bounds it on the card: neither bytes nor operations. The inputs are
// 17 bytes a box and the IoU tests the data needs are ~12 f32 operations
// each (microseconds at the card's rates). The greedy order is a serial
// chain, so the time is latency: of the chain through the boxes visited,
// of the launches that cut it into chunks, and of the IoU work of a chunk
// before its sweep may start.
//
// Design: the boxes go in chunks of 1024 (eight 128-box tiles), two
// launches a chunk, all on the caller's stream:
//   (a) fsod_nms_pairs_kernel, many 64-thread CTAs per image, grid-striding
//       over 64x64 blocks of work: the chunk's own upper-triangle IoU
//       bitmask (row box r, bit j: box j comes after r and IoU > thresh),
//       and the chunk's boxes against the compacted list of boxes kept in
//       earlier chunks, ORed into one "removed" bit per chunk box. So the
//       IoU work is the pairs the data needs, and none past the chunk in
//       which the sweep stops.
//   (b) fsod_nms_sweep_kernel, one CTA per image: stages the chunk's mask
//       rows and valid bits in shared memory with all loads in flight, then
//       one warp resolves the chunk 64 boxes (one word) at a time, with no
//       global-memory access in the chain. Lane v holds word v of the
//       removed bits; the candidates of word w are valid & ~removed, so
//       runs of removed boxes cost nothing. Within the word the greedy
//       result is the fixpoint of "kept = candidates minus what kept boxes
//       of the word suppress": lanes hold the own-word mask words of the 64
//       boxes in registers and one round ORs those of the kept ones across
//       the warp (__reduce_or_sync); suppression only points forward, so
//       the rounds settle after the longest suppression chain in the word,
//       a few rounds on real boxes, at most 65. The kept boxes' later words
//       are then ORed into the removed bits, all loads in flight. max_keep
//       is checked at every tile start. The CTA writes the keep flags,
//       appends the kept boxes to the list and, when the sweep stopped,
//       marks the image done: later launches for it return at once (the
//       sweep only zeroes its flags).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;                 // boxes per mask word
constexpr int kTile = 128;                // max_keep is checked here
constexpr int kChunk = 1024;              // boxes per launch pair
constexpr int kWords = kChunk / kWord;    // mask words per chunk row
constexpr int kPairThreads = 64;          // (a): one 64x64 block per CTA
constexpr int kSweepThreads = 512;        // (b)
constexpr int kPairCtas = 2048;           // (a)'s grid, over all images
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile % kWord == 0 && kChunk % kTile == 0, "tiling");
static_assert(kWords <= 32, "one removed word per lane");

typedef unsigned long long u64;

// Scratch of one call, carved from one buffer (fsod_nms_scratch_bytes).
struct Scratch {
  u64* mask;      // (B, kChunk, kWords) the chunk's upper-triangle bits
  float4* kept;   // (B, N) boxes kept so far, compacted
  u64* removed;   // (B, kWords) chunk boxes removed by earlier kept boxes
  int* count;     // (B,) boxes kept so far
  int* done;      // (B,) the sweep stopped
};

size_t align16(size_t x) { return (x + 15) / 16 * 16; }

size_t carve(void* base, int batch, int n, Scratch* s) {
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* q = p ? p + off : nullptr;
    off += align16(bytes);
    return q;
  };
  char* mask = take(sizeof(u64) * batch * kChunk * kWords);
  char* kept = take(sizeof(float4) * (size_t)batch * n);
  char* removed = take(sizeof(u64) * batch * kWords);
  char* count = take(sizeof(int) * batch);
  char* done = take(sizeof(int) * batch);
  if (s) {
    s->mask = reinterpret_cast<u64*>(mask);
    s->kept = reinterpret_cast<float4*>(kept);
    s->removed = reinterpret_cast<u64*>(removed);
    s->count = reinterpret_cast<int*>(count);
    s->done = reinterpret_cast<int*>(done);
  }
  return off;
}

__device__ __forceinline__ float area_rn(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__device__ __forceinline__ float iou_rn(float ax1, float ay1, float ax2,
                                        float ay2, float aarea, float bx1,
                                        float by1, float bx2, float by2,
                                        float barea) {
  float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(aarea, barea), inter);
  // inter == 0 gives 0 either way: most pairs skip the division
  return inter > 0.0f && uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// (a) IoU work of chunk `k`: grid (CTAs per image, B), kPairThreads each.
__global__ void __launch_bounds__(kPairThreads) fsod_nms_pairs_kernel(
    const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
    Scratch sc, int n, int k, float thresh) {
  const int img = blockIdx.y;
  const int t = threadIdx.x;
  const int c0 = k * kChunk;
  const int nb = min(kChunk, n - c0);
  const int nblk = (nb + kWord - 1) / kWord;
  int kept = 0;
  if (k == 0) {  // the first launch of the call sets up the image's state
    if (blockIdx.x == 0) {
      if (t < kWords) sc.removed[img * kWords + t] = 0ull;
      if (t == 0) {
        sc.count[img] = 0;
        sc.done[img] = 0;
      }
    }
  } else {
    if (sc.done[img]) return;
    kept = sc.count[img];
  }
  const float* b = boxes + ((size_t)img * n + c0) * 4;
  const uint8_t* v = valid + (size_t)img * n + c0;
  const float4* kl = sc.kept + (size_t)img * n;
  const int nself = nblk * (nblk + 1) / 2;
  const int ncross = nblk * ((kept + kWord - 1) / kWord);

  __shared__ float4 cbox[kWord];
  __shared__ float carea[kWord];
  for (int item = blockIdx.x; item < nself + ncross; item += gridDim.x) {
    __syncthreads();  // the previous item's columns are read
    int rb, col0, ncol;
    if (item < nself) {  // block (rb, cb), rb <= cb, of the own mask
      int rem = item;
      for (rb = 0; rem >= nblk - rb; ++rb) rem -= nblk - rb;
      col0 = (rb + rem) * kWord;
      ncol = min(kWord, nb - col0);
      if (t < ncol) {
        const float* q = b + (size_t)(col0 + t) * 4;
        cbox[t] = make_float4(q[0], q[1], q[2], q[3]);
      }
    } else {  // block (rb, ct) of the chunk against the kept list
      const int ci = item - nself;
      rb = ci % nblk;
      col0 = (ci / nblk) * kWord;
      ncol = min(kWord, kept - col0);
      if (t < ncol) cbox[t] = kl[col0 + t];
    }
    if (t < ncol)
      carea[t] = area_rn(cbox[t].x, cbox[t].y, cbox[t].z, cbox[t].w);
    __syncthreads();

    const int row = rb * kWord + t;
    const bool live = row < nb && v[row] != 0;
    float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;
    if (live) {
      const float* q = b + (size_t)row * 4;
      x1 = q[0]; y1 = q[1]; x2 = q[2]; y2 = q[3];
      area = area_rn(x1, y1, x2, y2);
    }
    if (item < nself) {
      if (row < nb) {
        u64 bits = 0ull;
        if (live) {
          const int start = col0 == rb * kWord ? t + 1 : 0;  // later boxes
          for (int j = start; j < ncol; ++j) {
            const float4 q = cbox[j];
            if (iou_rn(x1, y1, x2, y2, area, q.x, q.y, q.z, q.w, carea[j]) >
                thresh)
              bits |= 1ull << j;
          }
        }
        sc.mask[((size_t)img * kChunk + row) * kWords + col0 / kWord] = bits;
      }
    } else {
      bool hit = false;
      if (live)
        for (int j = 0; j < ncol && !hit; ++j) {
          const float4 q = cbox[j];
          hit = iou_rn(x1, y1, x2, y2, area, q.x, q.y, q.z, q.w, carea[j]) >
                thresh;
        }
      const unsigned bal = __ballot_sync(kFull, hit);
      if ((t & 31) == 0 && bal)  // little-endian halves of word rb
        atomicOr(reinterpret_cast<unsigned*>(sc.removed + img * kWords + rb) +
                     (t >> 5),
                 bal);
    }
  }
}

// (b) the greedy sweep of chunk `k`: one CTA per image.
__global__ void __launch_bounds__(kSweepThreads) fsod_nms_sweep_kernel(
    const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, Scratch sc, int n, int k, int max_keep) {
  // (kChunk, kWords) mask words, then the kChunk own-word (diagonal) words
  extern __shared__ ulonglong2 sraw[];
  u64* smask = reinterpret_cast<u64*>(sraw);
  u64* sdiag = smask + kChunk * kWords;
  __shared__ u64 s_valid[kWords], s_keep[kWords];
  __shared__ int s_count, s_done;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = k * kChunk;
  const int nb = min(kChunk, n - c0);
  const int nblk = (nb + kWord - 1) / kWord;
  uint8_t* kp = keep + (size_t)img * n + c0;
  if (sc.done[img]) {
    for (int i = tid; i < nb; i += blockDim.x) kp[i] = 0;
    return;
  }
  const int kept_before = sc.count[img];

  // stage the chunk's mask rows, 16 bytes a load, all loads in flight
  const u64* gm = sc.mask + (size_t)img * kChunk * kWords;
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(gm);
#pragma unroll
  for (int q = 0; q < kChunk * kWords / 2 / kSweepThreads; ++q) {
    const int e = q * kSweepThreads + tid;
    if (e < nb * kWords / 2) sraw[e] = __ldg(src + e);
  }
  for (int r = tid; r < nb; r += blockDim.x)
    sdiag[r] = __ldg(gm + r * kWords + r / kWord);
  const uint8_t* v = valid + (size_t)img * n + c0;
  for (int i = tid; i < kChunk; i += blockDim.x) {
    const unsigned bal = __ballot_sync(kFull, i < nb && v[i] != 0);
    if (lane == 0) reinterpret_cast<unsigned*>(s_valid)[i >> 5] = bal;
  }
  if (tid < kWords) s_keep[tid] = 0ull;
  __syncthreads();

  if (warp == 0) {
    // lane v < nblk holds the removed bits of word v
    u64 removed = lane < kWords ? sc.removed[img * kWords + lane] : 0ull;
    int count = kept_before;
    int stop = 0;
    for (int w = 0; w < nblk; ++w) {
      if (max_keep >= 0 && w % (kTile / kWord) == 0 && count >= max_keep) {
        stop = 1;
        break;
      }
      const int r0 = w * kWord;
      const u64 cand = s_valid[w] & ~__shfl_sync(kFull, removed, w);
      u64 kw = 0ull;
      if (cand) {
        // The word's greedy result is the fixpoint of "kept = cand minus
        // the boxes that kept boxes of the word suppress"; the suppression
        // only points forward, so iterating from kept = cand settles it
        // within (longest chain + 1) rounds. Lane l holds the own-word
        // mask words of boxes l and l + 32; a round ORs those of the kept
        // boxes across the warp.
        const u64 d_lo = sdiag[r0 + lane];
        const u64 d_hi = sdiag[r0 + 32 + lane];
        kw = cand;
        while (true) {
          const u64 x = (((kw >> lane) & 1ull) ? d_lo : 0ull) |
                        (((kw >> (lane + 32)) & 1ull) ? d_hi : 0ull);
          const u64 sup =
              ((u64)__reduce_or_sync(kFull, (unsigned)(x >> 32)) << 32) |
              __reduce_or_sync(kFull, (unsigned)x);
          const u64 next = cand & ~sup;
          if (next == kw) break;
          kw = next;
        }
      }
      count += __popcll(kw);
      if (lane == 0) s_keep[w] = kw;
      if (kw && w + 1 < nblk) {
        // later words: lane l ORs word w + 1 + (l & 15) of the kept boxes
        // among rows 32 * (l >> 4) .. + 31 of this word, all loads in flight
        const int tv = w + 1 + (lane & 15);
        const int half = lane >> 4;
        const unsigned kb = (unsigned)(kw >> (32 * half));
        u64 acc = 0ull;
        if (tv < nblk && kb) {
          const u64* col = smask + (r0 + 32 * half) * kWords + tv;
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if ((kb >> j) & 1u) acc |= col[j * kWords];
        }
        acc |= __shfl_xor_sync(kFull, acc, 16);
        const u64 add = __shfl_sync(kFull, acc, (lane - w - 1) & 31);
        if (lane > w && lane < nblk) removed |= add;
      }
    }
    if (lane == 0) {
      s_count = count;
      s_done = stop || (max_keep >= 0 && count >= max_keep);
    }
  }
  __syncthreads();

  // keep flags, and the kept boxes appended to the image's list
  float4* kl = sc.kept + (size_t)img * n + kept_before;
  const float* b = boxes + ((size_t)img * n + c0) * 4;
  for (int i = tid; i < nb; i += blockDim.x) {
    const int w = i / kWord;
    const u64 kw = s_keep[w];
    const u64 below = kw & ((1ull << (i % kWord)) - 1ull);
    const bool kept = (kw >> (i % kWord)) & 1ull;
    kp[i] = kept;
    if (kept) {
      int rank = __popcll(below);
      for (int x = 0; x < w; ++x) rank += __popcll(s_keep[x]);
      const float* q = b + (size_t)i * 4;
      kl[rank] = make_float4(q[0], q[1], q[2], q[3]);
    }
  }
  if (tid == 0) {
    sc.count[img] = s_count;
    sc.done[img] = s_done;
  }
  if (tid < kWords) sc.removed[img * kWords + tid] = 0ull;  // next chunk's
}

}  // namespace

// Bytes of scratch one call needs (the wrapper allocates them).
extern "C" long long fsod_nms_scratch_bytes(int batch, int n) {
  return static_cast<long long>(carve(nullptr, batch, n, nullptr));
}

// Kernel launches of one call: two per chunk of 1024 boxes.
extern "C" int fsod_nms_launches(int n) {
  return 2 * ((n + kChunk - 1) / kChunk);
}

extern "C" int fsod_nms_sorted(const float* boxes, const uint8_t* valid,
                               void* scratch, uint8_t* keep, int batch, int n,
                               float thresh, int max_keep, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch sc;
  carve(scratch, batch, n, &sc);
  const size_t smem = sizeof(u64) * kChunk * (kWords + 1);
  // once per device (so a call can also be captured into a CUDA graph)
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(fsod_nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 pair_grid(max(1, (kPairCtas + batch - 1) / batch), batch);
  for (int k = 0; k * kChunk < n; ++k) {
    fsod_nms_pairs_kernel<<<pair_grid, kPairThreads, 0, s>>>(
        boxes, valid, sc, n, k, thresh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fsod_nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(
        boxes, valid, keep, sc, n, k, max_keep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
