// Team-shared memory: the allocate directive's omp_cgroup_mem_alloc
// (src/repro/core/memory.py alloc_shared) on the card.
//
// A kernel holds one Arena and carves its buffers out of the CTA's
// dynamic shared memory in declaration order; with sizes known at
// compile time every offset folds to a constant, so a carve-out costs
// what a hand-written `extern __shared__` pointer does, and lies where
// that pointer would (no padding beyond each type's alignment).  The
// launcher passes the bytes the carve-outs take as the launch's dynamic
// shared size.  Like the paper's loader_uninitialized globals, the
// buffers are uninitialized.
#pragma once

#include <stddef.h>

namespace rt {

class Arena {
 public:
  template <typename T>
  __device__ __forceinline__ T* alloc_shared(size_t n) {
    offset_ = (offset_ + alignof(T) - 1) / alignof(T) * alignof(T);
    T* p = reinterpret_cast<T*>(base() + offset_);
    offset_ += n * sizeof(T);
    return p;
  }

 private:
  __device__ __forceinline__ static unsigned char* base() {
    extern __shared__ __align__(16) unsigned char rt_shared_arena[];
    return rt_shared_arena;
  }

  size_t offset_ = 0;
};

}  // namespace rt
