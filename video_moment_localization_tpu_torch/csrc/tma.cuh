// The Tensor Memory Accelerator (TMA) and mbarrier operations the port's
// Hopper kernels share: the bf16 proposal backward's ring
// (proposal_rows.cu::proposal_bwd_bf16_kernel) and the bf16 GEMM's wgmma
// path (gemm.cuh::gemm_bf16_wg_kernel). Device side: the mbarrier
// operations in PTX, 2-D / 3-D tiled TMA loads completed on an mbarrier and
// 3-D tiled TMA stores in bulk groups.
// Host side: cuTensorMapEncodeTiled, found through the runtime's entry-point
// query so that no library links libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vml {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
// Waits until the phase of parity ``parity`` of the barrier has completed,
// spinning on test_wait (which never suspends the thread, so that the lanes
// of a producer warp whose slots are free go on issuing).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}
// The same wait on try_wait, which may suspend the thread until the phase
// completes: for whole warps that have nothing else to issue.
__device__ __forceinline__ void mbar_wait_sleep(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}
// One box of a 2-D tensor map, at column x and row y, into shared memory.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
}
// One box of a 3-D tensor map, at (x, y, z).
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
        : "memory");
}

// One box of a 3-D tensor map, at (x, y, z), from shared memory to global
// memory (elements past an extent are not written), in the thread's bulk
// group; commit, then wait until at most N groups are in flight (`read`: until
// their shared memory has been read, so that it may be written again).
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, const void* src, int x, int y,
                                           int z) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(x), "r"(y), "r"(z)
        : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait() {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query;
// null where it is missing. `static`: each library (each .cu) keeps its own
// cached pointer (a function-local static of an inline function would be one
// object across the libraries of a process).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// The tensor map of a bf16 (or `type`) array of up to three dimensions
// (dims[0] contiguous; strides in bytes of dims 1 and 2, multiples of 16),
// in boxes of `box` elements a dimension; elements past an extent read as 0
// and are not written.
static cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box,
                            CUtensorMapSwizzle swizzle,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    cuuint64_t d[3], s[2];
    cuuint32_t b[3], steps[3] = {1, 1, 1};
    for (int i = 0; i < rank; ++i) {
        d[i] = dims[i];
        b[i] = box[i];
        if (i > 0) s[i - 1] = strides[i - 1];
    }
    const CUresult r = encode(map, type, (cuuint32_t)rank,
                              const_cast<void*>(base), d, s, b, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vml
