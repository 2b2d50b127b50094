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
// Design (two launches, one call):
//   1. fsod_nms_mask_kernel: one 64-thread block per (row block, column
//      block, image) above the diagonal. Thread i compares box r = 64*rb + i
//      with the 64 boxes of column block cb (staged in shared memory) and
//      writes one u64 word: bit j set iff box 64*cb + j comes after r and
//      IoU(r, that box) > thresh. The mask is N x ceil(N/64) words per image.
//   2. fsod_nms_sweep_kernel: one warp per image walks the boxes in order,
//      keeps the suppressed-bits row in shared memory, and ORs in the mask
//      row of every kept box (lanes split the words).
//
// Bit-exactness: the IoU is written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn so that nvcc cannot contract it into FMAs, in the operation
// order of box_ops.pairwise_iou:
//   area = (x2 - x1) * (y2 - y1); iw = max(min(x2) - max(x1), 0);
//   inter = iw * ih; union = (a1 + a2) - inter; iou = union > 0 ? inter /
//   union : 0.  IoU is symmetric bit for bit (+, *, min, max commute).
//
// What bounds it on the card: neither bytes nor operations. The inputs are
// 17 bytes a box and the IoU work is ~12 f32 operations a pair (microseconds
// at the card's rates); the sweep is a serial chain of dependent
// shared-memory reads and, for each kept box, one global load of its mask
// row, so its time is latency times the number of boxes visited.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;   // boxes per mask word / per mask block
constexpr int kTile = 128;   // max_keep is checked at these boundaries

__device__ __forceinline__ float iou_rn(float ax1, float ay1, float ax2,
                                        float ay2, float aarea, float bx1,
                                        float by1, float bx2, float by2,
                                        float barea) {
  float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(aarea, barea), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void fsod_nms_mask_kernel(const float* __restrict__ boxes,
                                     unsigned long long* __restrict__ mask,
                                     int n, int col_blocks, float thresh) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int img = blockIdx.z;
  if (cb < rb) return;  // below the diagonal: never read by the sweep

  const float* b = boxes + (size_t)img * n * 4;
  __shared__ float cx1[kBlock], cy1[kBlock], cx2[kBlock], cy2[kBlock],
      carea[kBlock];
  const int t = threadIdx.x;
  const int col0 = cb * kBlock;
  const int ncol = min(kBlock, n - col0);
  if (t < ncol) {
    const float* q = b + (size_t)(col0 + t) * 4;
    cx1[t] = q[0];
    cy1[t] = q[1];
    cx2[t] = q[2];
    cy2[t] = q[3];
    carea[t] = __fmul_rn(__fsub_rn(q[2], q[0]), __fsub_rn(q[3], q[1]));
  }
  __syncthreads();

  const int row = rb * kBlock + t;
  if (row >= n) return;
  const float* p = b + (size_t)row * 4;
  const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
  const float area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  unsigned long long bits = 0ull;
  const int start = (cb == rb) ? t + 1 : 0;  // only later boxes
  for (int j = start; j < ncol; ++j) {
    float v = iou_rn(x1, y1, x2, y2, area, cx1[j], cy1[j], cx2[j], cy2[j],
                     carea[j]);
    if (v > thresh) bits |= 1ull << j;
  }
  mask[((size_t)img * n + row) * col_blocks + cb] = bits;
}

__global__ void fsod_nms_sweep_kernel(
    const unsigned long long* __restrict__ mask,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int n,
    int col_blocks, int max_keep) {
  extern __shared__ unsigned long long removed[];  // col_blocks words
  const int img = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)img * n * col_blocks;
  const uint8_t* v = valid + (size_t)img * n;
  uint8_t* k = keep + (size_t)img * n;

  for (int w = lane; w < col_blocks; w += 32) removed[w] = 0ull;
  for (int i = lane; i < n; i += 32) k[i] = 0;
  __syncwarp();

  int count = 0;  // identical in every lane
  for (int i = 0; i < n; ++i) {
    if (max_keep >= 0 && (i % kTile) == 0 && count >= max_keep) break;
    const int w0 = i / kBlock;
    const bool kept =
        v[i] != 0 && ((removed[w0] >> (i % kBlock)) & 1ull) == 0ull;
    if (kept) {
      ++count;
      const unsigned long long* row = m + (size_t)i * col_blocks;
      for (int w = w0 + lane; w < col_blocks; w += 32) removed[w] |= row[w];
      if (lane == 0) k[i] = 1;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int fsod_nms_sorted(const float* boxes, const uint8_t* valid,
                               unsigned long long* mask_scratch, uint8_t* keep,
                               int batch, int n, float thresh, int max_keep,
                               void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid(col_blocks, col_blocks, batch);
  fsod_nms_mask_kernel<<<grid, kBlock, 0, s>>>(boxes, mask_scratch, n,
                                               col_blocks, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(unsigned long long) * col_blocks;
  fsod_nms_sweep_kernel<<<batch, 32, smem, s>>>(mask_scratch, valid, keep, n,
                                                col_blocks, max_keep);
  return static_cast<int>(cudaGetLastError());
}
