// Shared device helpers of the N:M kernels: element conversion, vector
// load types and the epilogue activations (the composition of
// kernels/epilogue.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nmk {

// dtype codes of the C interface (kernels/build.py passes them)
enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// int8 payload of the quantized kernels: exact in f32 (|q| <= 127)
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the unsigned type of one BYTES-wide load
template <int BYTES> struct Bytes;
template <> struct Bytes<1> { using type = uint8_t; };
template <> struct Bytes<2> { using type = uint16_t; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

// activation codes: kernels/epilogue.py ACTIVATION_CODES
enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kReluSq = 4 };

template <int ACT> __device__ __forceinline__ float activate(float v) {
  if (ACT == kRelu) return fmaxf(v, 0.f);
  if (ACT == kGelu) {  // tanh form, as jax.nn.gelu defaults to
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (ACT == kSilu) return v / (1.f + expf(-v));
  if (ACT == kReluSq) {
    const float r = fmaxf(v, 0.f);
    return r * r;
  }
  return v;
}

}  // namespace nmk
