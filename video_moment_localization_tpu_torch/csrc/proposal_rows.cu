// K1: packed proposal features of the training path, forward and backward.
//
// Replaces ops/proposal_pallas.py::proposal_features_rows of the JAX package
// (`_rows_kernel`) and its backward (`_rows_bwd` / `_rows_bwd_kernel`).
// Forward: f (B, T, D) -> fc (B, N, C, D) clip means masked by the pair
// validity, fm (B, N, D) their mean over C, fb (B, L, D) window means.
// Backward: the cotangents of the three -> df (B, T, D).
//
// The TPU kernel multiplies f by the dense averaging matrix Wc (N*C, T) on
// the MXU and emits c-major rows for its tiling. Every row of Wc is 1/len on
// one contiguous run of frames (ops/content_matrix.py), so here the forward
// is a segment mean (pool_kernel, shared with the serving stack) and fc is
// n-major, the layout of the SMI layer kernels. The TPU backward
// accumulates df[b] over row blocks in a sequential grid; here one block
// owns (b, t) and gathers every (pair, clip) whose segment covers frame t,
// found from the closed-form clip geometry: no atomics, deterministic.
//
// What bounds them on the H100: bytes. Forward reads 131 KB and writes
// 1.4 MB per element at the Charades shapes (T=64, L=16, C=4, D=512);
// backward reads the 1.4 MB and writes 131 KB. The backward re-reads a
// cotangent row once per frame of its clip (from L2 when it is hot).
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm.cuh"
#include "proposal.cuh"

namespace {

// grid B * T, one block per (element, frame).
//   df[t] = sum over (n, c) with t in clip (n, c) of
//             vmask[n] * (dfc[n, c] + dfm[n] / C) / clip_len(n)
//           + dfb[t / (T/L)] / (T/L)
// (fm is the mean over all C clips of the masked fc, so its cotangent
// spreads /C onto every existing clip.)
__global__ void proposal_rows_bwd_kernel(int T, int L, int C, int D,
                                         const float* __restrict__ vmask,
                                         const float* __restrict__ dfc,
                                         const float* __restrict__ dfm,
                                         const float* __restrict__ dfb,
                                         float* __restrict__ df) {
    const int N = L * (L + 1) / 2;
    const int b = blockIdx.x / T;
    const int t = blockIdx.x % T;
    const int tl = T / L;
    const int snippet = t / tl;
    const float inv_c = 1.f / (float)C;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float acc = dfb[((size_t)b * L + snippet) * D + d] / (float)tl;
        // Only pairs (i, j) with i <= snippet <= j can cover frame t.
        for (int i = 0; i <= snippet; ++i) {
            const int off = t - i * tl;
            for (int j = snippet; j < L; ++j) {
                const int frames = (j - i + 1) * tl;
                const int clip = max(1, frames / C);
                const int c = off / clip;
                if (c >= min(C, frames)) continue;   // past the pair's clips
                const size_t n = (size_t)b * N + vml::pair_index(i, j, L);
                const float vm = vmask[n];
                if (vm == 0.f) continue;
                acc += vm * (dfc[(n * C + c) * D + d] + dfm[n * D + d] * inv_c) / (float)clip;
            }
        }
        df[((size_t)b * T + t) * D + d] = acc;
    }
}

}  // namespace

extern "C" {

// f (B, T, D), vmask (B, N) -> fc (B, N, C, D), fm (B, N, D), fb (B, L, D).
// Returns the launch's CUDA error, 0 if none.
int vml_proposal_rows_fwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* f, const float* vmask, float* fc, float* fm,
                              float* fb) {
    const int N = L * (L + 1) / 2;
    vml::pool_kernel<<<B * (N + L), 128, 0, static_cast<cudaStream_t>(stream)>>>(
        T, L, C, D, f, vmask, fc, fm, fb);
    return (int)cudaGetLastError();
}

// vmask (B, N), dfc (B, N, C, D), dfm (B, N, D), dfb (B, L, D) -> df (B, T, D).
int vml_proposal_rows_bwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* vmask, const float* dfc, const float* dfm,
                              const float* dfb, float* df) {
    proposal_rows_bwd_kernel<<<B * T, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        T, L, C, D, vmask, dfc, dfm, dfb, df);
    return (int)cudaGetLastError();
}

}  // extern "C"
