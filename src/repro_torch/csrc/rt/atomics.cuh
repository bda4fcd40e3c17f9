// The portable atomics of the device runtime: Listing 3 of the paper
// (`#pragma omp atomic [compare] capture seq_cst`) in libcu++'s
// cuda::atomic_ref, device scope, sequentially consistent.  Each returns
// the captured old value.  atomic_inc, the one atomic OpenMP 5.1 cannot
// express, is the target part's (targets/*.cuh).  Their sequential
// semantics are src/repro_torch/core/atomics.py.
#pragma once

#include <cuda/atomic>

namespace rt {

template <typename T>
using atomic_ref = cuda::atomic_ref<T, cuda::thread_scope_device>;

// { v = x; x += e; } return v;
template <typename T>
__device__ __forceinline__ T atomic_add(T* x, T e) {
  return atomic_ref<T>(*x).fetch_add(e, cuda::std::memory_order_seq_cst);
}

// { v = x; if (x < e) x = e; } return v;
template <typename T>
__device__ __forceinline__ T atomic_max(T* x, T e) {
  return atomic_ref<T>(*x).fetch_max(e, cuda::std::memory_order_seq_cst);
}

// { v = x; if (x > e) x = e; } return v;
template <typename T>
__device__ __forceinline__ T atomic_min(T* x, T e) {
  return atomic_ref<T>(*x).fetch_min(e, cuda::std::memory_order_seq_cst);
}

// { v = x; x = e; } return v;
template <typename T>
__device__ __forceinline__ T atomic_exchange(T* x, T e) {
  return atomic_ref<T>(*x).exchange(e, cuda::std::memory_order_seq_cst);
}

// { v = x; if (x == e) x = d; } return v;
template <typename T>
__device__ __forceinline__ T atomic_cas(T* x, T e, T d) {
  atomic_ref<T>(*x).compare_exchange_strong(e, d,
                                            cuda::std::memory_order_seq_cst);
  return e;  // on failure compare_exchange stores the value it found
}

}  // namespace rt
