// ROIAlignV2 forward (aligned=True), batched over images, for Hopper.
//
// Replaces the JAX package's `roi_align_mxu`
// (fewshotobjectdetection_imporove_via_text_feature_tpu/ops/roi_align_mxu.py),
// an XLA interpolation-matrix form with no Pallas kernel, and its shared
// sample plan `roi_sample_geometry` (ops/roi_align.py). Its plain version is
// `roi_align_plain` in ops/roi_align.py of this package.
//
// Gather form: one thread per output element (image, roi, bin_y, bin_x,
// channel), channel fastest, so the 32 lanes of a warp read 32 neighbouring
// channels of one feature pixel. Each thread walks its g_y x g_x bilinear
// samples and accumulates in f32; the output is written in the feature type.
// Features are NHWC (B, H, W, C); boxes (B, S, 4) XYXY f32 in image
// coordinates; output (B, S, P', P', C) with P' = len(range(0, P, stride)).
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
// What bounds it on the card: bytes in the ideal (each feature read once,
// each output written once), but as written it is bound by the L1/L2
// traffic of its gathers: every output re-reads 4 feature values a sample,
// and neighbouring bins of one ROI read overlapping pixels again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
__global__ void fsod_roi_align_fwd_kernel(const T* __restrict__ feat,
                                          const float* __restrict__ boxes,
                                          T* __restrict__ out, int64_t total,
                                          int h, int w, int c, int s, int p,
                                          int p_out, int bin_stride,
                                          float scale, int sampling,
                                          int cap_y, int cap_x) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(idx % c);
    int64_t rest = idx / c;
    const int px = (int)(rest % p_out);
    rest /= p_out;
    const int py = (int)(rest % p_out);
    const int64_t roi = rest / p_out;  // image * s + roi-in-image
    const int64_t img = roi / s;

    const float* bx = boxes + roi * 4;
    const float bx1 = bx[0], by1 = bx[1], bx2 = bx[2], by2 = bx[3];
    const Axis ay = make_axis(by1, by2, scale, p, sampling, cap_y);
    const Axis ax = make_axis(bx1, bx2, scale, p, sampling, cap_x);
    const float biny = (float)(py * bin_stride);
    const float binx = (float)(px * bin_stride);
    const T* f = feat + img * (int64_t)h * w * c + ch;

    float acc = 0.0f;
    for (int jy = 0; jy < ay.g; ++jy) {
      int y0, y1;
      float wy0, wy1;
      if (!sample(ay, biny, jy, h, y0, y1, wy0, wy1)) continue;
      const T* r0 = f + (int64_t)y0 * w * c;
      const T* r1 = f + (int64_t)y1 * w * c;
      for (int jx = 0; jx < ax.g; ++jx) {
        int x0, x1;
        float wx0, wx1;
        if (!sample(ax, binx, jx, w, x0, x1, wx0, wx1)) continue;
        float top = __fadd_rn(__fmul_rn(wx0, load_f(r0 + (int64_t)x0 * c)),
                              __fmul_rn(wx1, load_f(r0 + (int64_t)x1 * c)));
        float bot = __fadd_rn(__fmul_rn(wx0, load_f(r1 + (int64_t)x0 * c)),
                              __fmul_rn(wx1, load_f(r1 + (int64_t)x1 * c)));
        acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(wy0, top),
                                       __fmul_rn(wy1, bot)));
      }
    }
    store_f(out + idx, acc);
  }
}

template <typename T>
int launch(const void* feat, const float* boxes, void* out, int b, int h,
           int w, int c, int s, int p, int bin_stride, float scale,
           int sampling, cudaStream_t stream) {
  const int p_out = (p + bin_stride - 1) / bin_stride;
  const int64_t total = (int64_t)b * s * p_out * p_out * c;
  if (total == 0) return 0;
  const int cap_y = max(1, (h + p - 1) / p);
  const int cap_x = max(1, (w + p - 1) / p);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  fsod_roi_align_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), total, h, w,
      c, s, p, p_out, bin_stride, scale, sampling, cap_y, cap_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output).
extern "C" int fsod_roi_align_fwd(const void* feat, int dtype,
                                  const float* boxes, void* out, int b, int h,
                                  int w, int c, int s, int p, int bin_stride,
                                  float scale, int sampling, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, boxes, out, b, h, w, c, s, p, bin_stride,
                         scale, sampling, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, boxes, out, b, h, w, c, s, p,
                                 bin_stride, scale, sampling, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
