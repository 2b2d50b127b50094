// ROIAlignV2 (aligned=True), forward and backward, batched over images, for
// Hopper.
//
// Replaces the JAX package's `roi_align_mxu`
// (fewshotobjectdetection_imporove_via_text_feature_tpu/ops/roi_align_mxu.py),
// an XLA interpolation-matrix form with no Pallas kernel, its gradient (XLA's
// autodiff of that form), and their shared sample plan `roi_sample_geometry`
// (ops/roi_align.py). The plain versions are `roi_align_plain` in
// ops/roi_align.py of this package and its autograd.
// Features are NHWC (B, H, W, C) in f32 or bf16; boxes (B, S, 4) XYXY f32 in
// image coordinates; output (B, S, P', P', C) with P' = len(range(0, P,
// stride)), in the features' type, accumulated in f32.
//
// The sample plan is roi_sample_geometry's, written with round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs:
//   x = box * scale - 0.5; bin = max(x2 - x1, 1e-6) / P;
//   adaptive (sampling_ratio 0): g = clip(ceil((x2 - x1) / P), 0, cap) with
//   the static cap max(1, ceil(size / P)); g = 0 gives output 0;
//   static: g = sampling_ratio. Weight 1 / max(g, 1) per sample;
//   sample t = x1 + (bin_index + (j + 0.5) / max(g, 1)) * bin;
//   t outside [-1, size] adds nothing; else it is clamped to [0, size - 1]
//   and read through the bilinear tent max(0, 1 - |t - pos|).
//
// Forward. What bounds it on the card: in the ideal, bytes (each feature
// read once, each output written once: 0.04 ms for the main path's 8 x 256
// ROIs on 8x50x84x1024 bf16). A gather form is instead bound by the traffic
// of its taps through L2 and L1 and by their latency: every output reads 4
// feature vectors a sample (about 15 at the main path's ROIs), pixels that
// neighbouring samples share are read again, and working the sample plan
// out again for every channel costs more than the interpolation itself.
//
// Forward design: one CTA per ROI.
//   1. The CTA's threads compute the ROI's samples once per axis, with
//      roi_sample_geometry's roundings: for each (emitted bin, sample) its
//      two tap pixels and weights (already scaled by 1/g), or that it lies
//      outside the map (`axis_tap`). Then one thread per (axis, bin) merges
//      the bin's taps into distinct pixels with summed weights (`merge_bin`;
//      at most g + 1 when samples are at most a pixel apart, as adaptive
//      sampling places them). Both go to shared memory (`build_plan`). The
//      backward kernel plans with the same device functions.
//   2. Each thread owns 8 neighbouring channels of every bin: one 16-byte
//      load a tap in bf16 (two in f32), 8 f32 accumulators, one 16-byte
//      store a bin (two in f32). A bin reads each of its distinct pixels
//      once, row by row: (g_y + 1)(g_x + 1) loads where the plain gather
//      reads 4 g_y g_x, with two loads a row in flight. A channel loop
//      covers C > 8 * threads. Where C is not a multiple of 8 or a base is
//      not 16-byte aligned, the same loop reads channel by channel.
//   3. Pixel offsets within an image are 32-bit while the image has fewer
//      than 2^31 elements; a larger image takes the same kernel with 64-bit
//      offsets (at the main path's shape the 64-bit form is 1.5x slower).
//
// Backward: grad_features[pixel] = sum of w_y * w_x * grad_out[bin] over
// every (ROI, bin) whose merged plan gives the pixel the weights w_y, w_x:
// the exact adjoint of the forward (only the emitted bins send gradient;
// samples outside the map send none; clamped samples send theirs to the
// clamped pixels).
// What bounds it: bytes. grad_out is read once and the gradient of the map
// written once: at the training launch shape (bf16, 16 images x 256 ROIs,
// 4x4 bins, 16x50x84x1024) 134 + 138 MB, 0.0812 ms at 3.35 TB/s. The
// arithmetic (8 channels x one multiply-add a bin-pixel pair) is a few
// percent of that time at 67 TFLOP/s.
// This design's own bytes: a tile of pixels reads the grad_out slab of each
// bin whose taps meet it, so a bin whose taps straddle a tile edge is read
// once more for each further tile (about 1.3-1.6x grad_out on the training
// path's ROIs, counted by chip_smoke.py's design_bytes); the gradient is
// written once, in its own type, with no float32 copy of the map, no
// memset, no cast pass and no atomics.
// Backward design: a gather over output tiles, the transpose of the
// forward's plan worked out per tile of pixels.
//   1. Grid: one CTA per (image, tile of 16 rows x 8 columns, group of
//      128-channel slabs); 256 threads in 16 row groups of 16. A thread owns
//      one tile row, 8 channels (one 16-byte load of bf16, as the forward
//      reads) and 8 columns: 64 float32 accumulators in registers, each
//      pixel-channel owned by exactly one thread (<= 128 registers, two CTAs
//      an SM). The slabs are grouped so that there are about 16 CTAs an SM
//      to even out the tiles' uneven loads (`launch_bwd`: groups =
//      min(slabs, ceil(16 x SMs / tiles)), ceil(slabs / groups) slabs a CTA):
//      at the training shape 704 tiles (16 images x 4 x 11) and 8 slabs give
//      3 groups of 3, 3 and 2 slabs, 16 x 44 x 3 = 2112 CTAs.
//   2. Select: the CTA reads its image's boxes in passes of 256 through
//      shared memory and keeps, in ascending ROI order (a ballot and a
//      prefix sum), those whose tap footprint on each axis (`meets`, the
//      plan's roundings) meets the tile. Any number of ROIs an image.
//   3. Plan: for up to 32 kept ROIs at a time, one thread per (ROI, axis,
//      emitted bin) rebuilds the bin's merged taps with the forward's own
//      functions (`make_axis`, `axis_tap`, `merge_bin`) and keeps the
//      weights that fall on the tile's rows and columns. One warp lists the
//      slots, the (ROI, y bin, x bin) whose taps meet the tile, in order,
//      with a y entry per (ROI, y bin). Where one pass of boxes and one
//      batch of plans hold every kept ROI (the training path), the plans
//      and slots serve all the CTA's slabs.
//   4. Stage: the slots' grad_out slabs (8 channels a thread, 16-byte
//      cp.async) go to one of two shared-memory buffers of 32 KB; the next
//      round's, or the next slab's, copies are in flight while the current
//      round is summed.
//   5. Accumulate: each row group walks the y entries in order; for one
//      with a weight on its row it adds w_y * w_x * g, for each of the
//      entry's slots in order, into the columns that carry a weight
//      (columns in halves of 4, so a bin that meets one half costs half).
//   6. Write once: the slab of the tile, NHWC, in the gradient's type (bf16
//      rounded once from the float32 sum, as the plain version rounds);
//      pixels no ROI reaches are written 0 by the same kernel.
//   Every pixel sums its (ROI, bin) terms in one fixed order, so two
//   launches on the same inputs give bitwise-equal gradients. C not a
//   multiple of 8 or an unaligned base takes the channel-by-channel loads
//   and stores of the same kernel; offsets are 32-bit or 64-bit as in the
//   forward.
// What holds it above its bytes (measured on an H100 at 700 W with clock64
// per phase): each row group's walk is a chain of shared-memory reads and
// branches, and two CTAs of 256 threads an SM (registers) hide little of
// it; the accumulate phase is half a CTA's time, the plans, the selection
// and the first stage's wait most of the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // channels a thread owns
constexpr int kMaxThreads = 256;

struct Axis {
  float start;  // continuous ROI start in feature coordinates
  float bin;    // bin size
  int g;        // samples per bin
  float gs;     // max(g, 1): the sub-step divisor
  float inv;    // 1 / max(g, 1): the sample weight
};

__device__ __forceinline__ Axis make_axis(float b0, float b1, float scale,
                                          int pooled, int sampling, int cap) {
  Axis a;
  float s0 = __fsub_rn(__fmul_rn(b0, scale), 0.5f);
  float s1 = __fsub_rn(__fmul_rn(b1, scale), 0.5f);
  float raw = __fsub_rn(s1, s0);
  a.start = s0;
  a.bin = __fdiv_rn(fmaxf(raw, 1e-6f), (float)pooled);
  float gf;
  if (sampling > 0) {
    gf = (float)sampling;
  } else {
    gf = ceilf(__fdiv_rn(raw, (float)pooled));
    gf = fminf(fmaxf(gf, 0.0f), (float)cap);
  }
  a.g = (int)gf;
  a.gs = fmaxf(gf, 1.0f);
  a.inv = __fdiv_rn(1.0f, a.gs);
  return a;
}

// Position of sample j of bin `bin_index` along the axis.
__device__ __forceinline__ float sample_pos(const Axis& a, float bin_index,
                                            int j) {
  float grid =
      __fadd_rn(bin_index, __fdiv_rn(__fadd_rn((float)j, 0.5f), a.gs));
  return __fadd_rn(a.start, __fmul_rn(grid, a.bin));
}

// Sample j of bin `bin_index`: the two tent weights (already scaled by the
// sample weight) and their pixel indices; returns false when the sample is
// outside [-1, size] and adds nothing.
__device__ __forceinline__ bool sample(const Axis& a, float bin_index, int j,
                                       int size, int& i0, int& i1, float& w0,
                                       float& w1) {
  float t = sample_pos(a, bin_index, j);
  if (t < -1.0f || t > (float)size) return false;
  float tc = fminf(fmaxf(t, 0.0f), (float)(size - 1));
  float f0 = floorf(tc);
  i0 = (int)f0;
  i1 = min(i0 + 1, size - 1);
  w0 = __fmul_rn(a.inv, __fsub_rn(1.0f, __fsub_rn(tc, f0)));
  // the second tent is empty when i0 is the last pixel
  w1 = (i0 + 1 <= size - 1)
           ? __fmul_rn(a.inv,
                       fmaxf(__fsub_rn(1.0f, __fsub_rn(__fadd_rn(f0, 1.0f),
                                                       tc)),
                             0.0f))
           : 0.0f;
  return true;
}

// One sample along one axis: pixel indices of its two taps and their
// weights; i0 < 0 marks a sample outside the map.
struct Tap {
  int i0, i1;
  float w0, w1;
};

// Sample j of emitted bin `bin` (the axis' bin bin * bin_stride).
__device__ __forceinline__ Tap axis_tap(const Axis& a, int bin, int j,
                                        int bin_stride, int size) {
  Tap t{-1, 0, 0.0f, 0.0f};
  if (!sample(a, (float)(bin * bin_stride), j, size, t.i0, t.i1, t.w0, t.w1))
    t.i0 = -1;
  return t;
}

// A bin's g samples (`tap_at(j)`) merged into distinct pixels, weights
// summed in sample order, zero weights dropped, into `list` (its entries
// 0..n-1: `is(i, pixel)`, `add(i, weight)`, `push(pixel, weight)`). Sample
// positions only grow, so a tap's pixel is at least that of the entry two
// back: it merges into one of the last two entries or opens a new one.
template <typename TapAt, typename List>
__device__ __forceinline__ void merge_bin(int g, TapAt tap_at, List& list) {
  for (int j = 0; j < g; ++j) {
    const Tap t = tap_at(j);
    if (t.i0 < 0) continue;
    const int px[2] = {t.i0, t.i1};
    const float pw[2] = {t.w0, t.w1};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (pw[q] == 0.0f) continue;
      const int n = list.n;
      if (n > 0 && list.is(n - 1, px[q])) {
        list.add(n - 1, pw[q]);
      } else if (n > 1 && list.is(n - 2, px[q])) {
        list.add(n - 2, pw[q]);
      } else {
        list.push(px[q], pw[q]);
      }
    }
  }
}

// Whether the samples of emitted bins bin_lo..bin_hi along one axis can
// touch a pixel of [t0, t0 + tn): the pixels from the first sample's first
// tap to the last sample's second tap, as `sample` rounds and clamps them
// (positions only grow, so every sample lies between those two). False
// when the axis has no sample or all of them are outside the map.
__device__ __forceinline__ bool meets(const Axis& a, int bin_lo, int bin_hi,
                                      int bin_stride, int size, int t0,
                                      int tn) {
  if (a.g == 0) return false;
  const float first = sample_pos(a, (float)(bin_lo * bin_stride), 0);
  const float last = sample_pos(a, (float)(bin_hi * bin_stride), a.g - 1);
  if (last < -1.0f || first > (float)size) return false;
  const float top = (float)(size - 1);
  const int lo = (int)floorf(fminf(fmaxf(first, 0.0f), top));
  const int hi = min((int)floorf(fminf(fmaxf(last, 0.0f), top)) + 1, size - 1);
  return lo < t0 + tn && hi >= t0;
}

// One distinct pixel of a bin along one axis: its element offset in the
// image (a row offset on y, a column offset on x) and the summed weight of
// the bin's samples on it. Offsets are 32-bit where the image has fewer
// than 2^31 elements, 64-bit beyond.
template <typename Off>
struct Pix {
  Off off;
  float w;
};

// 8 channels as f32: one 16-byte load of bf16, two of f32, or (kVector
// false) `n` scalar loads with the rest 0.
template <bool kVector>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n,
                                      float (&v)[kVec]) {
  if (kVector) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(q[k] << 16);
      v[2 * k + 1] = __uint_as_float(q[k] & 0xffff0000u);
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = k < n ? __uint_as_float((uint32_t)__ldg(s + k) << 16) : 0.0f;
  }
}
template <bool kVector>
__device__ __forceinline__ void load8(const float* p, int n,
                                      float (&v)[kVec]) {
  if (kVector) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = k < n ? __ldg(p + k) : 0.0f;
  }
}

template <bool kVector>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int n,
                                       const float (&v)[kVec]) {
  if (kVector) {
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      q[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < n) p[k] = __float2bfloat16_rn(v[k]);
  }
}
template <bool kVector>
__device__ __forceinline__ void store8(float* p, int n,
                                       const float (&v)[kVec]) {
  if (kVector) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < n) p[k] = v[k];
  }
}

// `merge_bin`'s list for the forward: the bin's entries as element offsets
// (pixel * step) in shared memory.
template <typename Off>
struct PixList {
  Pix<Off>* e;
  Off step;
  int n;
  __device__ bool is(int i, int pix) const { return e[i].off == pix * step; }
  __device__ void add(int i, float w) { e[i].w = __fadd_rn(e[i].w, w); }
  __device__ void push(int pix, float w) { e[n++] = Pix<Off>{pix * step, w}; }
};

// The ROI's merged sample plan in shared memory: per emitted bin of each
// axis, its distinct pixels (element offsets in the image, a row offset on
// y, a column offset on x) with their summed weights, and how many.
template <typename Off>
struct Plan {
  const Pix<Off>* pix_y;  // bin by: pix_y[by * 2 * gmax_y + i], i < len_y[by]
  const Pix<Off>* pix_x;
  const int* len_y;
  const int* len_x;
};

template <typename Off>
size_t plan_smem_bytes(int p_out, int gmax_y, int gmax_x) {
  return sizeof(Tap) * (size_t)p_out * (gmax_y + gmax_x) +
         sizeof(Pix<Off>) * (size_t)p_out * 2 * (gmax_y + gmax_x) +
         sizeof(int) * 2 * (size_t)p_out;
}

// Built by all the CTA's threads; ends with __syncthreads().
template <typename Off>
__device__ Plan<Off> build_plan(int4* smem, const float* bx, int h, int w,
                                int c, int p, int p_out, int bin_stride,
                                float scale, int sampling, int gmax_y,
                                int gmax_x) {
  const Axis ay = make_axis(bx[1], bx[3], scale, p, sampling, gmax_y);
  const Axis ax = make_axis(bx[0], bx[2], scale, p, sampling, gmax_x);
  const int ny = p_out * ay.g;
  const int nx = p_out * ax.g;
  // shared memory: the samples of both axes, then each bin's pixel list
  // (at most 2g entries) and its length
  Tap* taps = reinterpret_cast<Tap*>(smem);
  using P = Pix<Off>;
  P* pix_y = reinterpret_cast<P*>(taps + p_out * (gmax_y + gmax_x));
  P* pix_x = pix_y + p_out * 2 * gmax_y;
  int* len_y = reinterpret_cast<int*>(pix_x + p_out * 2 * gmax_x);
  int* len_x = len_y + p_out;

  // 1a. every sample of the ROI, once: entry bin * g + j of each axis
  for (int e = threadIdx.x; e < ny + nx; e += blockDim.x) {
    const bool on_y = e < ny;
    const int k = on_y ? e : e - ny;
    const Axis a = on_y ? ay : ax;
    taps[e] = axis_tap(a, k / a.g, k % a.g, bin_stride, on_y ? h : w);
  }
  __syncthreads();
  // 1b. per (axis, bin): the bin's samples merged into distinct pixels
  for (int e = threadIdx.x; e < 2 * p_out; e += blockDim.x) {
    const bool on_y = e < p_out;
    const int bin = on_y ? e : e - p_out;
    const int g = on_y ? ay.g : ax.g;
    const Off step = on_y ? (Off)w * c : (Off)c;
    const Tap* tb = taps + (on_y ? 0 : ny) + bin * g;
    PixList<Off> list{on_y ? pix_y + bin * 2 * gmax_y
                           : pix_x + bin * 2 * gmax_x,
                      step, 0};
    merge_bin(g, [&](int j) { return tb[j]; }, list);
    (on_y ? len_y : len_x)[bin] = list.n;
  }
  __syncthreads();

  return Plan<Off>{pix_y, pix_x, len_y, len_x};
}

template <typename T, bool kVector, typename Off>
__global__ void __launch_bounds__(kMaxThreads) fsod_roi_align_fwd_kernel(
    const T* __restrict__ feat, const float* __restrict__ boxes,
    T* __restrict__ out, int s, int h, int w, int c, int p, int p_out,
    int bin_stride, float scale, int sampling, int gmax_y, int gmax_x) {
  extern __shared__ int4 smem[];
  const int roi = blockIdx.x;  // image * s + roi-in-image
  const int img = roi / s;
  const Plan<Off> plan =
      build_plan<Off>(smem, boxes + (size_t)roi * 4, h, w, c, p, p_out,
                      bin_stride, scale, sampling, gmax_y, gmax_x);
  using P = Pix<Off>;

  // 2. each thread: 8 channels of every bin, each distinct pixel read once
  // a bin (rows contracted along x first)
  const T* base = feat + (size_t)img * h * w * c;
  T* obase = out + (size_t)roi * p_out * p_out * c;
  const int groups = (c + kVec - 1) / kVec;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    const int c0 = grp * kVec;
    const int nc = min(kVec, c - c0);
    const T* f = base + c0;
    for (int by = 0; by < p_out; ++by) {
      const P* ly = plan.pix_y + by * 2 * gmax_y;
      const int ny_b = plan.len_y[by];
      for (int bxi = 0; bxi < p_out; ++bxi) {
        const P* lx = plan.pix_x + bxi * 2 * gmax_x;
        const int nx_b = plan.len_x[bxi];
        float acc[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
        for (int iy = 0; iy < ny_b; ++iy) {
          const P py = ly[iy];
          const T* row = f + py.off;
          float r[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) r[k] = 0.0f;
          int ix = 0;
          for (; ix + 1 < nx_b; ix += 2) {  // two taps in flight
            const P p0 = lx[ix], p1 = lx[ix + 1];
            float v0[kVec], v1[kVec];
            load8<kVector>(row + p0.off, nc, v0);
            load8<kVector>(row + p1.off, nc, v1);
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
              r[k] = __fmaf_rn(p0.w, v0[k], r[k]);
              r[k] = __fmaf_rn(p1.w, v1[k], r[k]);
            }
          }
          if (ix < nx_b) {
            const P p0 = lx[ix];
            float v0[kVec];
            load8<kVector>(row + p0.off, nc, v0);
#pragma unroll
            for (int k = 0; k < kVec; ++k) r[k] = __fmaf_rn(p0.w, v0[k], r[k]);
          }
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[k] = __fmaf_rn(py.w, r[k], acc[k]);
        }
        store8<kVector>(obase + (size_t)(by * p_out + bxi) * c + c0, nc,
                        acc);
      }
    }
  }
}

template <typename T, typename Off>
int launch(const void* feat, const float* boxes, void* out, int b, int h,
           int w, int c, int s, int p, int bin_stride, float scale,
           int sampling, cudaStream_t stream) {
  const int p_out = (p + bin_stride - 1) / bin_stride;
  if ((int64_t)b * s * p_out * p_out * c == 0) return 0;
  const int cap_y = max(1, (h + p - 1) / p);
  const int cap_x = max(1, (w + p - 1) / p);
  const int gy = sampling > 0 ? sampling : cap_y;  // most samples a bin
  const int gx = sampling > 0 ? sampling : cap_x;
  const size_t smem = plan_smem_bytes<Off>(p_out, gy, gx);
  const int groups = (c + kVec - 1) / kVec;
  const int threads = min(kMaxThreads, max(32, (groups + 31) / 32 * 32));
  // 8 channels of either type are 16 or 32 bytes: C % 8 keeps every pixel
  // and every bin of a 16-byte-aligned base aligned
  const bool vec = c % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? &fsod_roi_align_fwd_kernel<T, true, Off>
                    : &fsod_roi_align_fwd_kernel<T, false, Off>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(unsigned)(b * s), threads, smem, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), s, h, w, c,
      p, p_out, bin_stride, scale, sampling, gy, gx);
  return static_cast<int>(cudaGetLastError());
}

// Backward tiling (the reasons are in the note at the top).
constexpr int kTileH = 16;                   // rows of a tile
constexpr int kTileW = 8;                    // columns of a tile
constexpr int kHalfW = kTileW / 2;
constexpr int kSlab = 128;                   // channels of a slab
constexpr int kRowThreads = kSlab / kVec;    // threads of a row group: 16
constexpr int kBwdThreads = kTileH * kRowThreads;  // 256
constexpr int kBoxChunk = kBwdThreads;       // boxes selected per pass
constexpr int kMaxBatch = 32;                // kept ROIs planned at once
constexpr int kStageBytes = 32768;           // one of the two stage buffers

// grad_out slabs a stage buffer holds: 128 in bf16, 64 in f32
template <typename T>
__host__ __device__ constexpr int stage_slots() {
  return kStageBytes / (kSlab * (int)sizeof(T));
}

// `merge_bin`'s list for the backward: the last two entries in registers;
// an entry that can no longer merge is final and goes to the tile's weights
// `wt` (pixels t0 .. t0 + tn - 1; others fall outside the tile). `hits`
// collects 1 << (tile pixel / `per_bit`) of every pixel that lands.
struct TileList {
  float* wt;
  int t0, tn, per_bit;
  int n = 0;
  int hits = 0;
  int p0 = -1, p1 = -1;  // entries n - 2 and n - 1 (by parity: slot i & 1)
  float w0 = 0.0f, w1 = 0.0f;
  __device__ bool is(int i, int pix) const { return (i & 1 ? p1 : p0) == pix; }
  __device__ void add(int i, float w) {
    if (i & 1) w1 = __fadd_rn(w1, w);
    else w0 = __fadd_rn(w0, w);
  }
  __device__ void land(int pix, float w) {
    if (pix >= t0 && pix < t0 + tn) {
      wt[pix - t0] = w;
      hits |= 1 << ((pix - t0) / per_bit);
    }
  }
  __device__ void push(int pix, float w) {
    if (n & 1) {  // slot 1 takes entry n; entry n - 2 there is final
      if (n > 1) land(p1, w1);
      p1 = pix;
      w1 = w;
    } else {
      if (n > 1) land(p0, w0);
      p0 = pix;
      w0 = w;
    }
    ++n;
  }
  __device__ void finish() {  // the last two entries, in order
    if (n > 1) land(n & 1 ? p1 : p0, n & 1 ? w1 : w0);
    if (n > 0) land(n & 1 ? p0 : p1, n & 1 ? w0 : w1);
  }
};

// 8 channels from global to shared memory unchanged: 16 bytes (bf16) or 32
// (f32) as asynchronous copies (cp.async, in the caller's commit group),
// or `n` elements loaded and stored.
template <bool kVector, typename T>
__device__ __forceinline__ void copy8(const T* src, int n, T* dst) {
  if (kVector) {
#pragma unroll
    for (int k = 0; k < (int)(kVec * sizeof(T) / 16); ++k) {
      const unsigned to = static_cast<unsigned>(
          __cvta_generic_to_shared(reinterpret_cast<uint4*>(dst) + k));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(reinterpret_cast<const uint4*>(src) + k));
    }
  } else {
    for (int k = 0; k < n; ++k) dst[k] = src[k];
  }
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `kPending` commit groups are in flight
template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 8 channels from shared memory as f32 (`n` of them, the rest 0).
template <bool kVector>
__device__ __forceinline__ void read8(const __nv_bfloat16* p, int n,
                                      float (&v)[kVec]) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  if (kVector) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(q[k] << 16);
      v[2 * k + 1] = __uint_as_float(q[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = k < n ? __uint_as_float((uint32_t)s[k] << 16) : 0.0f;
  }
}
template <bool kVector>
__device__ __forceinline__ void read8(const float* p, int n,
                                      float (&v)[kVec]) {
  if (kVector) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = k < n ? p[k] : 0.0f;
  }
}

// The pixels of half `hf` of a thread's row of the tile: w_y * w_x * g for
// every column that the bin's merged plan gives a weight.
__device__ __forceinline__ void add_half(float (&acc)[kTileW][kVec],
                                         const float* wx, int hf, float wy,
                                         const float (&g)[kVec]) {
  const float4 x4 = reinterpret_cast<const float4*>(wx)[hf];
  const float x[kHalfW] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
  for (int i = 0; i < kHalfW; ++i) {
    if (x[i] != 0.0f) {
      const float wgt = __fmul_rn(wy, x[i]);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc[hf * kHalfW + i][k] = __fmaf_rn(wgt, g[k], acc[hf * kHalfW + i][k]);
    }
  }
}

// The launch's shape and sample plan, and the CTA's tile.
struct BwdShape {
  int s, h, w, p, p_out, bin_stride, sampling, cap_y, cap_x;
  float scale;
  int ty0, tx0;
};

// The backward kernel's shared memory.
template <typename T>
struct BwdSmem {
  float4* box;    // [kBoxChunk] the pass's boxes
  float* wy;      // [batch][p_out][kTileH] merged weight of each tile row
  float* wx;      // [batch][p_out][kTileW] ... of each tile column
  T* stage;       // [2][stage_slots][kSlab] grad_out slabs
  int4* yent;     // [batch * p_out] y entries {wy offset, first slot, count}
  int2* slot;     // [batch * p_out^2] {bin among the image's, x plan | halves}
  int* kept;      // [kBoxChunk] the kept ROIs' places in the pass
  int* warp_n;    // [kBwdThreads / 32] kept ROIs a warp
  int* counts;    // [3] y entries, slots, kept ROIs
  int* hit_y;     // [batch * p_out] whether the y bin has a tile row
  int* halves_x;  // [batch * p_out] the tile halves the x bin meets

  __device__ BwdSmem(int4* base, int batch, int p_out) {
    const int bins = batch * p_out;
    box = reinterpret_cast<float4*>(base);
    wy = reinterpret_cast<float*>(box + kBoxChunk);
    wx = wy + bins * kTileH;
    stage = reinterpret_cast<T*>(wx + bins * kTileW);
    yent = reinterpret_cast<int4*>(stage + 2 * stage_slots<T>() * kSlab);
    slot = reinterpret_cast<int2*>(yent + bins);
    kept = reinterpret_cast<int*>(slot + bins * p_out);
    warp_n = kept + kBoxChunk;
    counts = warp_n + kBwdThreads / 32;
    hit_y = counts + 3;
    halves_x = hit_y + bins;
  }
};

template <typename T>
size_t bwd_smem_bytes(int batch, int p_out) {
  const size_t bins = (size_t)batch * p_out;
  return sizeof(float4) * kBoxChunk + sizeof(float) * bins * (kTileH + kTileW) +
         sizeof(T) * 2 * stage_slots<T>() * kSlab + sizeof(int4) * bins +
         sizeof(int2) * bins * p_out +
         sizeof(int) * (kBoxChunk + kBwdThreads / 32 + 3 + 2 * bins);
}

// 2. The boxes r0 .. r0 + kBoxChunk - 1 of the image through shared memory;
// those whose taps can meet the tile kept in ascending order (a ballot, a
// prefix sum); their count to counts[2]. Ends with __syncthreads().
template <typename T>
__device__ void select_rois(const BwdSmem<T>& sm, const BwdShape& a,
                            const float* bimg, int r0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = r0 + threadIdx.x;
  bool keep = false;
  if (r < a.s) {
    const float* bx = bimg + (size_t)r * 4;
    const float4 box = make_float4(bx[0], bx[1], bx[2], bx[3]);
    sm.box[threadIdx.x] = box;
    keep = meets(make_axis(box.y, box.w, a.scale, a.p, a.sampling, a.cap_y),
                 0, a.p_out - 1, a.bin_stride, a.h, a.ty0, kTileH) &&
           meets(make_axis(box.x, box.z, a.scale, a.p, a.sampling, a.cap_x),
                 0, a.p_out - 1, a.bin_stride, a.w, a.tx0, kTileW);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) sm.warp_n[warp] = __popc(mask);
  __syncthreads();
  int before = 0, n_kept = 0;
#pragma unroll
  for (int i = 0; i < kBwdThreads / 32; ++i) {
    before += i < warp ? sm.warp_n[i] : 0;
    n_kept += sm.warp_n[i];
  }
  if (keep) sm.kept[before + __popc(mask & ((1u << lane) - 1u))] = threadIdx.x;
  if (threadIdx.x == 0) sm.counts[2] = n_kept;
  __syncthreads();
}

// 3. Kept ROIs k0 .. k0 + nk - 1: each one's plan per axis, cut to the
// tile, one thread per (ROI, axis, emitted bin) with the forward's own
// functions: the merged weight of each tile row (column) in each bin whose
// taps can meet the tile, and which rows (column halves) it reaches.
// Ends with __syncthreads().
template <typename T>
__device__ void plan_rois(const BwdSmem<T>& sm, const BwdShape& a, int k0,
                          int nk) {
  for (int e = threadIdx.x; e < nk * 2 * a.p_out; e += kBwdThreads) {
    const int k = e / (2 * a.p_out);
    const int q = e - k * 2 * a.p_out;
    const bool on_y = q < a.p_out;
    const int bin = on_y ? q : q - a.p_out;
    const float4 box = sm.box[sm.kept[k0 + k]];
    const Axis ax =
        on_y ? make_axis(box.y, box.w, a.scale, a.p, a.sampling, a.cap_y)
             : make_axis(box.x, box.z, a.scale, a.p, a.sampling, a.cap_x);
    const int size = on_y ? a.h : a.w;
    TileList list{on_y ? sm.wy + (k * a.p_out + bin) * kTileH
                       : sm.wx + (k * a.p_out + bin) * kTileW,
                  on_y ? a.ty0 : a.tx0, on_y ? kTileH : kTileW,
                  on_y ? kTileH : kHalfW};
    if (meets(ax, bin, bin, a.bin_stride, size, list.t0, list.tn)) {
      for (int i = 0; i < list.tn; ++i) list.wt[i] = 0.0f;
      merge_bin(
          ax.g, [&](int j) { return axis_tap(ax, bin, j, a.bin_stride, size); },
          list);
      list.finish();
    }
    (on_y ? sm.hit_y : sm.halves_x)[k * a.p_out + bin] = list.hits;
  }
  __syncthreads();
}

// 3. The slots: every (ROI, y bin, x bin) of the planned ROIs whose taps
// meet the tile, ROI by ROI, then y bin, then x bin. A slot holds its bin's
// place among the image's bins, and its x plan with the tile halves it
// meets in bits 28-29; a y entry per (ROI, y bin) holds its row weights'
// place and its run of slots. Counts to counts[0], counts[1]. One warp
// (nk <= 32); ends with __syncthreads().
template <typename T>
__device__ void list_slots(const BwdSmem<T>& sm, const BwdShape& a, int r0,
                           int k0, int nk) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const int q = lane * a.p_out;  // this ROI's first plan
    int ny = 0, nx = 0;
    for (int b = 0; lane < nk && b < a.p_out; ++b) {
      ny += sm.hit_y[q + b] != 0;
      nx += sm.halves_x[q + b] != 0;
    }
    if (nx == 0) ny = 0;
    int y_end = ny, s_end = ny * nx;  // inclusive prefixes over the ROIs
    for (int d = 1; d < 32; d <<= 1) {
      const int vy = __shfl_up_sync(0xffffffffu, y_end, d);
      const int vs = __shfl_up_sync(0xffffffffu, s_end, d);
      if (lane >= d) {
        y_end += vy;
        s_end += vs;
      }
    }
    int ye = y_end - ny, at = s_end - ny * nx;
    const int bins = (r0 + sm.kept[k0 + min(lane, nk - 1)]) * a.p_out * a.p_out;
    for (int by = 0; by < a.p_out && ye < y_end; ++by) {
      if (!sm.hit_y[q + by]) continue;
      sm.yent[ye++] = make_int4((q + by) * kTileH, at, nx, 0);
      for (int bx = 0; bx < a.p_out; ++bx)
        if (sm.halves_x[q + bx])
          sm.slot[at++] = make_int2(bins + by * a.p_out + bx,
                                    q + bx | sm.halves_x[q + bx] << 28);
    }
    if (lane == 31) {
      sm.counts[0] = y_end;
      sm.counts[1] = s_end;
    }
  }
  __syncthreads();
}

// 4. Slots s0 .. s1 - 1 of channel slab `slab` into stage buffer `buf`,
// every copy of the CTA in flight together, as one commit group.
template <typename T, bool kVector>
__device__ void stage_slots_of(const BwdSmem<T>& sm, const T* gimg, int c,
                               int slab, int s0, int s1, int buf) {
  T* stage = sm.stage + buf * stage_slots<T>() * kSlab;
  for (int e = threadIdx.x; e < (s1 - s0) * kRowThreads; e += kBwdThreads) {
    const int i = e / kRowThreads;
    const int ch = slab * kSlab + (e - i * kRowThreads) * kVec;
    if (ch < c)
      copy8<kVector>(gimg + (size_t)sm.slot[s0 + i].x * c + ch,
                     min(kVec, c - ch), stage + e * kVec);
  }
  copies_commit();
}

// 5. Each thread: its row of the tile, its 8 channels of the slab, from
// stage buffer `buf` holding slots s0 .. s1 - 1: the y entries in order
// from `e_lo`, and for one with a weight on the row its slots (x bins) in
// order (the next entry and its row weight read ahead). Returns the first
// entry not finished: one whose slots run past s1 goes on in the next round.
template <typename T, bool kVector>
__device__ int accumulate_round(const BwdSmem<T>& sm, int buf, int e_lo,
                                int n_yent, int s0, int s1, int row, int part,
                                int nc, bool owns,
                                float (&acc)[kTileW][kVec]) {
  const T* stage = sm.stage + buf * stage_slots<T>() * kSlab + part * kVec;
  int e = e_lo;
  int4 ye = sm.yent[min(e, n_yent - 1)];
  float wy = sm.wy[ye.x + row];
  for (; e < n_yent && ye.y < s1; ++e) {
    const int4 yn = sm.yent[min(e + 1, n_yent - 1)];
    const float wn = sm.wy[yn.x + row];
    if (owns && wy != 0.0f) {
      const int hi = min(ye.y + ye.z, s1);
      for (int j = max(ye.y, s0); j < hi; ++j) {
        const int xo = sm.slot[j].y;
        const float* wx = sm.wx + (xo & 0x0fffffff) * kTileW;
        float g[kVec];
        read8<kVector>(stage + (j - s0) * kSlab, nc, g);
        if (xo & 1 << 28) add_half(acc, wx, 0, wy, g);
        if (xo & 1 << 29) add_half(acc, wx, 1, wy, g);
      }
    }
    ye = yn;
    wy = wn;
  }
  const int4 last = sm.yent[max(e - 1, 0)];
  return e > e_lo && last.y + last.z > s1 ? e - 1 : e;
}

template <typename T, bool kVector, typename Off>
__global__ void __launch_bounds__(kBwdThreads, 2) fsod_roi_align_bwd_kernel(
    const T* __restrict__ grad_out, const float* __restrict__ boxes,
    T* __restrict__ grad, int s, int h, int w, int c, int p, int p_out,
    int bin_stride, float scale, int sampling, int cap_y, int cap_x,
    int tiles_x, int batch, int slabs_per_cta) {
  constexpr int kStage = stage_slots<T>();
  extern __shared__ int4 smem[];
  const BwdSmem<T> sm(smem, batch, p_out);
  const BwdShape a{s, h, w, p, p_out, bin_stride, sampling, cap_y, cap_x,
                   scale, (int)(blockIdx.x / tiles_x) * kTileH,
                   (int)(blockIdx.x % tiles_x) * kTileW};
  const int img = blockIdx.z;
  const int row = threadIdx.x / kRowThreads;  // this thread's tile row
  const int part = threadIdx.x % kRowThreads;
  const int y = a.ty0 + row;
  const float* bimg = boxes + (size_t)img * s * 4;
  const T* gimg = grad_out + (size_t)img * s * p_out * p_out * c;

  // The CTA's slabs one after another. `planned`: the plans and slots in
  // shared memory, made for an earlier slab, serve this one (one pass of
  // boxes and one batch of plans held every kept ROI). `staged`: this
  // round's copies are already in flight in buffer `buf`.
  const int slab_end =
      min((int)(blockIdx.y + 1) * slabs_per_cta, (c + kSlab - 1) / kSlab);
  bool planned = false, staged = false;
  int buf = 0;
  for (int slab = blockIdx.y * slabs_per_cta; slab < slab_end; ++slab) {
    const int c0 = slab * kSlab + part * kVec;
    const int nc = min(kVec, c - c0);  // this thread's channels; <= 0 past C
    const bool owns = y < h && nc > 0;
    float acc[kTileW][kVec];
#pragma unroll
    for (int i = 0; i < kTileW; ++i)
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[i][k] = 0.0f;

    for (int r0 = 0; r0 < s; r0 += kBoxChunk) {
      if (!planned) select_rois(sm, a, bimg, r0);
      const int n_kept = sm.counts[2];
      const bool reuse = s <= kBoxChunk && n_kept <= batch;
      for (int k0 = 0; k0 < n_kept; k0 += batch) {
        const int nk = min(batch, n_kept - k0);
        if (!planned) {
          plan_rois(sm, a, k0, nk);
          list_slots(sm, a, r0, k0, nk);
        }
        const int n_yent = sm.counts[0];
        const int n_slots = sm.counts[1];
        int e_lo = 0;
        for (int s0 = 0; s0 < n_slots; s0 += kStage) {
          const int s1 = min(s0 + kStage, n_slots);
          if (!staged)
            stage_slots_of<T, kVector>(sm, gimg, c, slab, s0, s1, buf);
          // the next round of this slab, or the next slab's first where it
          // reuses the plans, on its way while this one is summed
          const bool next_here = s1 < n_slots;
          staged = next_here || (reuse && slab + 1 < slab_end);
          if (staged) {
            stage_slots_of<T, kVector>(
                sm, gimg, c, next_here ? slab : slab + 1, next_here ? s1 : 0,
                next_here ? min(s1 + kStage, n_slots) : min(kStage, n_slots),
                buf ^ 1);
            copies_wait<1>();
          } else {
            copies_wait<0>();
          }
          __syncthreads();
          e_lo = accumulate_round<T, kVector>(sm, buf, e_lo, n_yent, s0, s1,
                                              row, part, nc, owns, acc);
          __syncthreads();
          buf ^= 1;
        }
      }
      planned = reuse;
    }

    // 6. the slab of the tile written once, in the gradient's type; pixels
    // that no ROI reaches are written as 0
    if (owns) {
      T* gp = grad + (size_t)img * h * w * c + c0;
#pragma unroll
      for (int col = 0; col < kTileW; ++col)
        if (a.tx0 + col < w)
          store8<kVector>(gp + ((Off)y * w + (a.tx0 + col)) * c, nc,
                          acc[col]);
    }
  }
}

template <typename T, typename Off>
int launch_bwd(const void* grad_out, const float* boxes, void* grad, int b,
               int h, int w, int c, int s, int p, int bin_stride, float scale,
               int sampling, cudaStream_t stream) {
  if ((int64_t)b * h * w * c == 0) return 0;
  const int p_out = (p + bin_stride - 1) / bin_stride;
  const int cap_y = max(1, (h + p - 1) / p);
  const int cap_x = max(1, (w + p - 1) / p);
  // kept ROIs planned at once: up to 32, fewer where their plans, y
  // entries and slots would pass 24 KB
  const int per_roi =
      4 * p_out * (kTileH + kTileW + 4 + 2) + 8 * p_out * p_out;
  const int batch = max(1, min(kMaxBatch, 24576 / per_roi));
  const size_t smem = bwd_smem_bytes<T>(batch, p_out);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int slabs = (c + kSlab - 1) / kSlab;
  const bool vec = c % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(grad_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  auto kernel = vec ? &fsod_roi_align_bwd_kernel<T, true, Off>
                    : &fsod_roi_align_bwd_kernel<T, false, Off>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // slabs a CTA: as many as keep 16 CTAs an SM (8 waves of 2) to spread
  // the tiles' uneven loads; each further slab reuses the CTA's plans
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = b * tiles_y * tiles_x;
  const int groups = max(1, min(slabs, (16 * sms + tiles - 1) / tiles));
  const int per_cta = (slabs + groups - 1) / groups;
  const dim3 grid((unsigned)(tiles_y * tiles_x),
                  (unsigned)((slabs + per_cta - 1) / per_cta), (unsigned)b);
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(grad_out), boxes, static_cast<T*>(grad), s, h, w,
      c, p, p_out, bin_stride, scale, sampling, cap_y, cap_x, tiles_x, batch,
      per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output).
extern "C" int fsod_roi_align_fwd(const void* feat, int dtype,
                                  const float* boxes, void* out, int b, int h,
                                  int w, int c, int s, int p, int bin_stride,
                                  float scale, int sampling, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // in-image offsets are below h * w * c: 32-bit unless that passes 2^31 - 1
  const bool wide = (int64_t)h * w * c > INT32_MAX;
  if (dtype == 0)
    return wide ? launch<float, long long>(feat, boxes, out, b, h, w, c, s, p,
                                           bin_stride, scale, sampling, st)
                : launch<float, int>(feat, boxes, out, b, h, w, c, s, p,
                                     bin_stride, scale, sampling, st);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, long long>(feat, boxes, out, b, h, w,
                                                   c, s, p, bin_stride, scale,
                                                   sampling, st)
                : launch<__nv_bfloat16, int>(feat, boxes, out, b, h, w, c, s,
                                             p, bin_stride, scale, sampling,
                                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of fsod_roi_align_fwd with respect to the features.
// grad_out (B, S, P', P', C) and grad (B, H, W, C), both in the features'
// type (dtype 0 = float32, 1 = bfloat16); every element of grad is written
// once, summed in float32 in a fixed order.
extern "C" int fsod_roi_align_bwd(const void* grad_out, int dtype,
                                  const float* boxes, void* grad, int b,
                                  int h, int w, int c, int s, int p,
                                  int bin_stride, float scale, int sampling,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = (int64_t)h * w * c > INT32_MAX;
  if (dtype == 0)
    return wide ? launch_bwd<float, long long>(grad_out, boxes, grad, b, h, w,
                                               c, s, p, bin_stride, scale,
                                               sampling, st)
                : launch_bwd<float, int>(grad_out, boxes, grad, b, h, w, c, s,
                                         p, bin_stride, scale, sampling, st);
  if (dtype == 1)
    return wide ? launch_bwd<__nv_bfloat16, long long>(
                      grad_out, boxes, grad, b, h, w, c, s, p, bin_stride,
                      scale, sampling, st)
                : launch_bwd<__nv_bfloat16, int>(grad_out, boxes, grad, b, h,
                                                 w, c, s, p, bin_stride, scale,
                                                 sampling, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
