// RGB -> CIELab (cvt / rgb2lab, clcode.cl:21-59 and :125-151) for Hopper
// (sm_90a): one thread a pixel.
//
// Replaces the JAX package's rgb_to_lab (cl_multiview_stereo_tpu/ops/
// color.py:46), an XLA function, not Pallas.  The port's plain form
// (ops/color.rgb_to_lab_reference) runs about 48 elementwise passes over
// the image, each reading and writing a float32 plane: at 9 x 1080 x 1920
// about 3.6 GB of traffic for a function that needs 3 bytes in and 12
// bytes out a pixel.
//
// lab_kernel: each thread reads its pixel's three channels (uint8, or
// float32 for callers that pass floats in [0, 255]) and writes L, a, b.
// It is held bitwise to the plain form run on the card, so it repeats the
// op sequence torch executes there, one rounding an op, in the plain
// form's order:
//   - every constant is a Python double rounded to float32, as torch
//     rounds a scalar operand (static_cast<float> of the double literal,
//     not the float literal, which could round the decimal differently);
//   - X = (r m00 + g m01) + b m02, each product rounded;
//   - a tensor divided by a Python scalar on the card is a product with
//     the scalar's reciprocal, taken in double and rounded to float32, so
//     X / 0.950456, Z / 1.088754 and / 116 are __fmul_rn by
//     static_cast<float>(1.0 / c) (and Y / 1.0 is Y).  The float
//     reciprocal of the float constant is one ulp off it for 1.088754,
//     and then 4,858,640 of the 2^24 uint8 triples' b differ; the IEEE
//     divide the CPU's plain form runs differs too;
//   - torch.pow(t, 1/3) on the card is powf(t, 0.33333334f), not cbrtf;
//   - the where() of f() takes one branch; the plain form computes both
//     and selects, with the same values.
// --fmad=false and the _rn intrinsics keep nvcc from contracting any of
// these into an FMA.
//
// Bound: the bytes (15 a pixel, 0.084 ms at 9 x 1080 x 1920 over 3.35
// TB/s); its 3 powf a pixel are the most arithmetic.  A warp's loads and
// stores cover contiguous 96- and 384-byte runs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the most pixels a launch takes: a thread's index plus the grid's stride
// stays inside an int
constexpr int kMaxPixels = 1 << 30;

// the plain form's constants, each a Python double rounded to float32
constexpr float kScale = static_cast<float>(0.0039216);
constexpr float kEpsilon = static_cast<float>(0.008856);
constexpr float kKappa = static_cast<float>(903.3);
// the white point's X and Z and the linear branch's 116, as the
// reciprocals the card multiplies by
constexpr float kInvWhiteX = static_cast<float>(1.0 / 0.950456);
constexpr float kInvWhiteZ = static_cast<float>(1.0 / 1.088754);
constexpr float kInv116 = static_cast<float>(1.0 / 116.0);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
// the RGB -> XYZ matrix, row by row
constexpr float kM00 = static_cast<float>(0.412453), kM01 = static_cast<float>(0.357580),
                kM02 = static_cast<float>(0.180423);
constexpr float kM10 = static_cast<float>(0.212671), kM11 = static_cast<float>(0.715160),
                kM12 = static_cast<float>(0.072169);
constexpr float kM20 = static_cast<float>(0.019334), kM21 = static_cast<float>(0.119193),
                kM22 = static_cast<float>(0.950227);

// CIE f(): cube root above epsilon, linear below (the plain form's _f_cbrt)
__device__ __forceinline__ float f_cbrt(float t) {
  if (t > kEpsilon) return powf(t, kThird);
  return __fmul_rn(__fadd_rn(__fmul_rn(t, kKappa), 16.0f), kInv116);
}

// one row of the RGB -> XYZ matrix: (r m0 + g m1) + b m2
__device__ __forceinline__ float row(float r, float g, float b, float m0, float m1, float m2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, m0), __fmul_rn(g, m1)), __fmul_rn(b, m2));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lab_kernel(const T* __restrict__ rgb, float* __restrict__ out, int n) {
  const int stride = gridDim.x * kThreads;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n; p += stride) {
    const long long q = 3LL * p;
    const float r = __fmul_rn(static_cast<float>(rgb[q]), kScale);
    const float g = __fmul_rn(static_cast<float>(rgb[q + 1]), kScale);
    const float b = __fmul_rn(static_cast<float>(rgb[q + 2]), kScale);
    const float fx = f_cbrt(__fmul_rn(row(r, g, b, kM00, kM01, kM02), kInvWhiteX));
    const float fy = f_cbrt(row(r, g, b, kM10, kM11, kM12));
    const float fz = f_cbrt(__fmul_rn(row(r, g, b, kM20, kM21, kM22), kInvWhiteZ));
    out[q] = __fsub_rn(__fmul_rn(fy, 116.0f), 16.0f);
    out[q + 1] = __fmul_rn(__fsub_rn(fx, fy), 500.0f);
    out[q + 2] = __fmul_rn(__fsub_rn(fy, fz), 200.0f);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; it does not synchronise.
//
// Lab of `n` pixels of 3 channels: `rgb` uint8 (is_float 0) or float32
// (is_float 1), `out` float32.
extern "C" int lab_convert_launch(const void* rgb, float* out, int n, int is_float, void* stream) {
  if (n < 0 || n > kMaxPixels || (is_float != 0 && is_float != 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    lab_kernel<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(rgb), out, n);
  else
    lab_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(rgb), out, n);
  return (int)cudaGetLastError();
}
