// K1 and K8: proposal features of the training path, forward and backward,
// in the packed layout (K1, and K6 behind its own Python entry) and in the
// dense layout (K8).
//
// Replaces ops/proposal_pallas.py::proposal_features_rows of the JAX package
// (`_rows_kernel`) and its backward (`_rows_bwd` / `_rows_bwd_kernel`), and
// ::_fc_fm_pallas (`_row_kernel`, K8), whose backward is the XLA VJP of the
// prefix sums (ops/proposal.py::proposal_features).
// Forward: f (B, T, D) -> fc (B, P, C, D) clip means masked per moment, fm
// (B, P, D) their mean over C, fb (B, L, D) window means; P = N pairs masked
// by their validity (packed), or P = L * L cells masked by a given
// moment_mask (dense; zeros below the diagonal). Backward: the cotangents of
// the three -> df (B, T, D); none flows to the mask.
//
// The TPU kernels multiply f by the dense averaging matrix Wc on the MXU (K1
// emits c-major rows for its tiling; K8 one (L*C, T) @ (T, D) per map row).
// Every row of Wc is 1/len on one contiguous run of frames
// (ops/content_matrix.py), so here the forward is a segment mean
// (pool_kernel, shared with the serving stack) and fc is n-major, the layout
// of the SMI kernels. The TPU backward accumulates df[b] over row blocks in a
// sequential grid; here one block owns (b, t) and gathers every (moment,
// clip) whose segment covers frame t, found from the closed-form clip
// geometry: no atomics, deterministic. Both layouts are one copy of each
// kernel, templated on the layout.
//
// What bounds them on the H100: bytes. K1's forward reads 131 KB and writes
// 1.4 MB per element at the Charades shapes (T=64, L=16, C=4, D=512); K8
// writes 2.6 MB (the L * L cells); each backward reads the cotangents of the
// N = L(L+1)/2 cells i <= j (K8's never visits a cell below the diagonal)
// and writes 131 KB. The backward re-reads a cotangent row once per frame of
// its clip (from L2 when it is hot).
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm.cuh"
#include "proposal.cuh"

namespace {

// grid B * T, one block per (element, frame).
//   df[t] = sum over (n, c) with t in clip (n, c) of
//             mask[n] * (dfc[n, c] + dfm[n] / C) / clip_len(n)
//           + dfb[t / (T/L)] / (T/L)
// (fm is the mean over all C clips of the masked fc, so its cotangent
// spreads /C onto every existing clip; a dense cell below the diagonal has
// no clip and covers no frame.)
template <bool Dense>
__global__ void proposal_rows_bwd_kernel(int T, int L, int C, int D,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ dfc,
                                    const float* __restrict__ dfm,
                                    const float* __restrict__ dfb,
                                    float* __restrict__ df) {
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const int b = blockIdx.x / T;
    const int t = blockIdx.x % T;
    const int tl = T / L;
    const int snippet = t / tl;
    const float inv_c = 1.f / (float)C;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float acc = dfb[((size_t)b * L + snippet) * D + d] / (float)tl;
        // Only moments (i, j) with i <= snippet <= j can cover frame t.
        for (int i = 0; i <= snippet; ++i) {
            const int off = t - i * tl;
            for (int j = snippet; j < L; ++j) {
                const int frames = (j - i + 1) * tl;
                const int clip = max(1, frames / C);
                const int c = off / clip;
                if (c >= min(C, frames)) continue;   // past the moment's clips
                const size_t n = (size_t)b * P + vml::moment_index<Dense>(i, j, L);
                const float vm = mask[n];
                if (vm == 0.f) continue;
                acc += vm * (dfc[(n * C + c) * D + d] + dfm[n * D + d] * inv_c) / (float)clip;
            }
        }
        df[((size_t)b * T + t) * D + d] = acc;
    }
}

template <bool Dense>
int forward(void* stream, int B, int T, int L, int C, int D, const float* f, const float* mask,
            float* fc, float* fm, float* fb) {
    const int P = Dense ? L * L : L * (L + 1) / 2;
    vml::pool_kernel<Dense><<<B * (P + L), 128, 0, static_cast<cudaStream_t>(stream)>>>(
        T, L, C, D, f, mask, fc, fm, fb);
    return (int)cudaGetLastError();
}

template <bool Dense>
int backward(void* stream, int B, int T, int L, int C, int D, const float* mask,
             const float* dfc, const float* dfm, const float* dfb, float* df) {
    proposal_rows_bwd_kernel<Dense><<<B * T, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        T, L, C, D, mask, dfc, dfm, dfb, df);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. f (B, T, D), vmask (B, N) -> fc (B, N, C, D), fm (B, N, D), fb (B, L, D).
// Returns the launch's CUDA error, 0 if none.
int vml_proposal_rows_fwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* f, const float* vmask, float* fc, float* fm,
                              float* fb) {
    return forward<false>(stream, B, T, L, C, D, f, vmask, fc, fm, fb);
}

// vmask (B, N), dfc (B, N, C, D), dfm (B, N, D), dfb (B, L, D) -> df (B, T, D).
int vml_proposal_rows_bwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* vmask, const float* dfc, const float* dfm,
                              const float* dfb, float* df) {
    return backward<false>(stream, B, T, L, C, D, vmask, dfc, dfm, dfb, df);
}

// K8. f (B, T, D), moment_mask (B, L, L) -> fc (B, L, L, C, D),
// fm (B, L, L, D), fb (B, L, D).
int vml_proposal_dense_fwd_f32(void* stream, int B, int T, int L, int C, int D,
                               const float* f, const float* moment_mask, float* fc, float* fm,
                               float* fb) {
    return forward<true>(stream, B, T, L, C, D, f, moment_mask, fc, fm, fb);
}

// moment_mask (B, L, L), dfc (B, L, L, C, D), dfm (B, L, L, D), dfb (B, L, D)
// -> df (B, T, D).
int vml_proposal_dense_bwd_f32(void* stream, int B, int T, int L, int C, int D,
                               const float* moment_mask, const float* dfc, const float* dfm,
                               const float* dfb, float* df) {
    return backward<true>(stream, B, T, L, C, D, moment_mask, dfc, dfm, dfb, df);
}

}  // extern "C"
