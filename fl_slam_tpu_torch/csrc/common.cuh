// Shared helpers of the port's CUDA kernels (each .cu builds into its own
// shared library with a plain C interface, loaded by cuda_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Every library exports this so the Python side can name a failure.
#define FL_DEFINE_ERROR_STRING                                     \
  extern "C" const char* fl_error_string(int e) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }

template <typename T> __device__ __forceinline__ T fl_exp(T x);
template <> __device__ __forceinline__ float fl_exp(float x) { return expf(x); }
template <> __device__ __forceinline__ double fl_exp(double x) { return exp(x); }

template <typename T> __device__ __forceinline__ T fl_log(T x);
template <> __device__ __forceinline__ float fl_log(float x) { return logf(x); }
template <> __device__ __forceinline__ double fl_log(double x) { return log(x); }

template <typename T> __device__ __forceinline__ T fl_neg_inf();
template <> __device__ __forceinline__ float fl_neg_inf() { return -CUDART_INF_F; }
template <> __device__ __forceinline__ double fl_neg_inf() { return -CUDART_INF; }
