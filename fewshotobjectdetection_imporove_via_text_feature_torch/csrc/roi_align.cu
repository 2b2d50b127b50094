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
//      outside the map. Then one thread per (axis, bin) merges the bin's
//      taps into distinct pixels with summed weights (at most g + 1 when
//      samples are at most a pixel apart, as adaptive sampling places
//      them). Both go to shared memory (`build_plan`, which the backward
//      kernel shares).
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
// Backward: grad_features[pixel] += w_y * w_x * grad_out[bin] over every
// (bin, pixel) pair of the forward's merged plan, the exact adjoint of the
// forward (only the emitted bins send gradient; samples outside the map
// send none; clamped samples send theirs to the clamped pixels).
// What bounds it: in the ideal, bytes (grad_out read once, the gradient of
// the map written once); this first design also zeroes, accumulates into
// and reads a float32 copy of the map, and its atomics are bound by L2's
// atomic units, which overlapping ROIs contend for.
// Backward design: one CTA per ROI builds the same plan in shared memory
// (`build_plan`). Each thread owns 8 channels, 32 apart, so that each
// atomic instruction of a warp covers 32 neighbouring floats (128 bytes):
// it reads the bin's 8 grad_out values once and adds weight x value into a
// zero-filled float32 NHWC buffer with atomicAdd for every pixel of the
// bin. The wrapper rounds that buffer once to bf16 for a bf16 gradient, as
// the plain version sums in f32 and rounds once. Lanes past C
// are masked, so any C and any base take the same path; offsets are 32-bit
// or 64-bit as in the forward.
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

// Sample j of bin `bin_index`: the two tent weights (already scaled by the
// sample weight) and their pixel indices; returns false when the sample is
// outside [-1, size] and adds nothing.
__device__ __forceinline__ bool sample(const Axis& a, float bin_index, int j,
                                       int size, int& i0, int& i1, float& w0,
                                       float& w1) {
  float grid =
      __fadd_rn(bin_index, __fdiv_rn(__fadd_rn((float)j, 0.5f), a.gs));
  float t = __fadd_rn(a.start, __fmul_rn(grid, a.bin));
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
    Tap t{-1, 0, 0.0f, 0.0f};
    if (!sample(a, (float)((k / a.g) * bin_stride), k % a.g, on_y ? h : w,
                t.i0, t.i1, t.w0, t.w1))
      t.i0 = -1;
    taps[e] = t;
  }
  __syncthreads();
  // 1b. per (axis, bin): the bin's samples merged into distinct pixels,
  // weights summed in sample order (zero weights dropped). Sample positions
  // only grow, so a tap's pixel is at least that of the entry two back: it
  // merges into one of the last two entries or opens a new one.
  for (int e = threadIdx.x; e < 2 * p_out; e += blockDim.x) {
    const bool on_y = e < p_out;
    const int bin = on_y ? e : e - p_out;
    const int g = on_y ? ay.g : ax.g;
    const Off step = on_y ? (Off)w * c : (Off)c;
    const Tap* tb = taps + (on_y ? 0 : ny) + bin * g;
    P* list = on_y ? pix_y + bin * 2 * gmax_y : pix_x + bin * 2 * gmax_x;
    int n = 0;
    for (int j = 0; j < g; ++j) {
      const Tap t = tb[j];
      if (t.i0 < 0) continue;
      const Off px[2] = {t.i0 * step, t.i1 * step};
      const float pw[2] = {t.w0, t.w1};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (pw[q] == 0.0f) continue;
        if (n > 0 && list[n - 1].off == px[q]) {
          list[n - 1].w = __fadd_rn(list[n - 1].w, pw[q]);
        } else if (n > 1 && list[n - 2].off == px[q]) {
          list[n - 2].w = __fadd_rn(list[n - 2].w, pw[q]);
        } else {
          list[n++] = P{px[q], pw[q]};
        }
      }
    }
    (on_y ? len_y : len_x)[bin] = n;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// channels of one warp in the backward: 32 lanes x kVec channels, 32 apart
constexpr int kWarpChannels = 32 * kVec;

template <typename T, typename Off>
__global__ void __launch_bounds__(kMaxThreads) fsod_roi_align_bwd_kernel(
    const T* __restrict__ grad_out, const float* __restrict__ boxes,
    float* __restrict__ grad, int s, int h, int w, int c, int p, int p_out,
    int bin_stride, float scale, int sampling, int gmax_y, int gmax_x) {
  extern __shared__ int4 smem[];
  const int roi = blockIdx.x;  // image * s + roi-in-image
  const int img = roi / s;
  const Plan<Off> plan =
      build_plan<Off>(smem, boxes + (size_t)roi * 4, h, w, c, p, p_out,
                      bin_stride, scale, sampling, gmax_y, gmax_x);
  using P = Pix<Off>;

  // each thread: channels c0 + lane + 32 k (k < 8) of every bin; every
  // (row, column) pixel pair of the bin gets weight_y * weight_x * grad
  float* base = grad + (size_t)img * h * w * c;
  const T* gbase = grad_out + (size_t)roi * p_out * p_out * c;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int c0 = (threadIdx.x >> 5) * kWarpChannels; c0 < c;
       c0 += warps * kWarpChannels) {
    const int ch = c0 + lane;
    for (int bin = 0; bin < p_out * p_out; ++bin) {
      const int by = bin / p_out;
      const int bxi = bin - by * p_out;
      const int ny_b = plan.len_y[by];
      const int nx_b = plan.len_x[bxi];
      if (ny_b == 0 || nx_b == 0) continue;
      const T* gp = gbase + (size_t)bin * c + ch;
      float g[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        g[k] = ch + 32 * k < c ? to_f32(gp[32 * k]) : 0.0f;
      const P* ly = plan.pix_y + by * 2 * gmax_y;
      const P* lx = plan.pix_x + bxi * 2 * gmax_x;
      for (int iy = 0; iy < ny_b; ++iy) {
        const P py = ly[iy];
        float* row = base + py.off + ch;
        for (int ix = 0; ix < nx_b; ++ix) {
          const P px = lx[ix];
          const float wgt = __fmul_rn(py.w, px.w);
          float* dst = row + px.off;
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            if (ch + 32 * k < c) atomicAdd(dst + 32 * k, __fmul_rn(wgt, g[k]));
        }
      }
    }
  }
}

template <typename T, typename Off>
int launch_bwd(const void* grad_out, const float* boxes, float* grad32,
               int b, int h, int w, int c, int s, int p, int bin_stride,
               float scale, int sampling, cudaStream_t stream) {
  const int64_t n = (int64_t)b * h * w * c;
  if (n == 0) return 0;
  cudaError_t err =
      cudaMemsetAsync(grad32, 0, (size_t)n * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int p_out = (p + bin_stride - 1) / bin_stride;
  if ((int64_t)s * p_out * p_out > 0) {
    const int cap_y = max(1, (h + p - 1) / p);
    const int cap_x = max(1, (w + p - 1) / p);
    const int gy = sampling > 0 ? sampling : cap_y;
    const int gx = sampling > 0 ? sampling : cap_x;
    const size_t smem = plan_smem_bytes<Off>(p_out, gy, gx);
    const int warps = (c + kWarpChannels - 1) / kWarpChannels;
    const int threads = min(kMaxThreads, 32 * warps);
    auto kernel = &fsod_roi_align_bwd_kernel<T, Off>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(unsigned)(b * s), threads, smem, stream>>>(
        static_cast<const T*>(grad_out), boxes, grad32, s, h, w, c, p, p_out,
        bin_stride, scale, sampling, gy, gx);
  }
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
// grad_out (B, S, P', P', C) in the features' type (dtype 0 = float32,
// 1 = bfloat16); grad32 the float32 (B, H, W, C) gradient, zeroed here and
// summed into with atomics (the caller rounds it once to bfloat16).
extern "C" int fsod_roi_align_bwd(const void* grad_out, int dtype,
                                  const float* boxes, float* grad32, int b,
                                  int h, int w, int c, int s, int p,
                                  int bin_stride, float scale, int sampling,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = (int64_t)h * w * c > INT32_MAX;
  if (dtype == 0)
    return wide ? launch_bwd<float, long long>(grad_out, boxes, grad32, b, h,
                                               w, c, s, p, bin_stride, scale,
                                               sampling, st)
                : launch_bwd<float, int>(grad_out, boxes, grad32, b, h, w, c,
                                         s, p, bin_stride, scale, sampling,
                                         st);
  if (dtype == 1)
    return wide ? launch_bwd<__nv_bfloat16, long long>(
                      grad_out, boxes, grad32, b, h, w, c, s, p, bin_stride,
                      scale, sampling, st)
                : launch_bwd<__nv_bfloat16, int>(grad_out, boxes, grad32, b,
                                                 h, w, c, s, p, bin_stride,
                                                 scale, sampling, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
