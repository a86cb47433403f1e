// The backward of the ContentUnit on the device, shared by the SMI layer
// backward (smin_train.cu, K3) and the content-unit backward
// (content_train.cu, K7 and K10): the host functions that sequence the
// content-attention backward (content_attn.cuh) with the GEMMs of gemm.cuh,
// and the cotangent sum of K3 and K7. The derivation heads smin_train.cu
// ("ContentUnit"). Everything a kernel writes it owns: no atomics, so a run
// is deterministic.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "smin_units.cuh"

namespace vml {

// dcut[r, d] = dcu[r, d] + dx2[r / C, d] / C over the B * N * C clip rows;
// dcu may be null (zero).
static __global__ void dcu_total_kernel(size_t total, int C, int D, const float* __restrict__ dcu,
                                 const float* __restrict__ dx2, float* __restrict__ out) {
    const float inv_c = 1.f / (float)C;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t r = e / D;
        const int d = (int)(e % D);
        const float v = dx2[(r / C) * D + d] * inv_c;
        out[e] = dcu ? dcu[e] + v : v;
    }
}

// The content backward's buffers beyond the recomputed forward's own.
struct ContentBackwardScratch {
    float *dfcc, *dh, *dq, *part, *dfwh, *dkhat, *dfsh;
};
constexpr int kContentBackwardSlots = 7;

// Carves the slots of `w` out of `ws` from `off` on (ws null: only measure);
// returns the offset past them.
inline size_t carve_content_backward(float* ws, size_t off, int B, int N, int C, int Nq, int dl,
                                     ContentBackwardScratch* w) {
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t sizes[kContentBackwardSlots] = {
        rows * dl, rows * dl, rows * dl,                        // dfcc, dh, dq
        content_attn_partial_floats(B, N, C, Nq, dl),           // part
        BQ * dl, BQ * dl, (size_t)B * dl,                       // dfwh, dkhat, dfsh
    };
    float** slots[kContentBackwardSlots] = {&w->dfcc, &w->dh, &w->dq, &w->part, &w->dfwh,
                                            &w->dkhat, &w->dfsh};
    return carve_slots(ws, off, sizes, slots, kContentBackwardSlots);
}

// Floats of the partial-sum buffer that `content_backward`'s split
// reductions (gemm_tn with its column sums) need.
inline size_t content_partial_floats(int B, int N, int C, int Nq, int D, int dl) {
    const int NC = N * C;
    const int shapes[][3] = {{D, dl, B * NC}, {dl, dl, B * NC}, {dl, dl, B * Nq},
                             {dl, D, B * Nq}, {dl, D, B}, {dl, D, B * NC}};
    size_t most = 0;
    for (const auto& s : shapes) {
        const size_t f = gemm_tn_partial_floats(s[0], s[1], s[2]);
        if (f > most) most = f;
    }
    return most;
}

// Backward of cu = c_out(fcc) * vm + fc + fbar from dcut (B*N*C, D), the
// total cotangent of cu, through the unit recomputed into `s` by
// `content_forward`: fills w (dh, dfwh and dfsh are the cotangents of the
// three projections' outputs, which `content_input_grads` pushes to the
// inputs) and the 12 weight gradients dw[0..11] in `content_forward`'s
// order of p. Returns the first CUDA error of the launches.
inline cudaError_t content_backward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                    const float* fc, const float* fw, const float* fs,
                                    const float* qmask, const float* vmask,
                                    const float* const* p, const LayerScratch& s,
                                    const ContentBackwardScratch& w, float* partial,
                                    const float* dcut, float* const* dw) {
    const int NC = N * C;
    const Epilogue none{};
    Epilogue ep;
    gemm_nn(st, B * NC, dl, D, dcut, D, vmask, C, p[6], dl, w.dfcc, dl, none);
    VML_CHECK_LAUNCH();
    gemm_tn(st, D, dl, B * NC, dcut, D, vmask, C, s.fcc, dl, partial, dw[6], dw[7]);
    VML_CHECK_LAUNCH();
    cudaError_t err = content_attn_backward(st, B, N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh,
                                            qmask, vmask, w.dfcc, w.dh, w.dq, w.part, w.dfwh,
                                            w.dkhat, w.dfsh);
    if (err != cudaSuccess) return err;
    // attn_q: dh = (dq Wcq + dh) * vm, in place.
    ep.pre = w.dh;
    ep.ldpre = dl;
    ep.rmask = vmask;
    ep.mask_div = C;
    gemm_nn(st, B * NC, dl, dl, w.dq, dl, nullptr, 1, p[8], dl, w.dh, dl, ep);
    VML_CHECK_LAUNCH();
    gemm_tn(st, dl, dl, B * NC, w.dq, dl, nullptr, 1, s.h, dl, partial, dw[8], dw[9]);
    VML_CHECK_LAUNCH();
    // attn_k: dfwh = (dkhat Wck + dfwh) * qmask, in place.
    ep = Epilogue();
    ep.pre = w.dfwh;
    ep.ldpre = dl;
    ep.rmask = qmask;
    gemm_nn(st, B * Nq, dl, dl, w.dkhat, dl, nullptr, 1, p[10], dl, w.dfwh, dl, ep);
    VML_CHECK_LAUNCH();
    gemm_tn(st, dl, dl, B * Nq, w.dkhat, dl, nullptr, 1, s.fwh, dl, partial, dw[10], dw[11]);
    VML_CHECK_LAUNCH();
    // w_hat, s_hat, c_hat weights.
    gemm_tn(st, dl, D, B * Nq, w.dfwh, dl, nullptr, 1, fw, D, partial, dw[2], dw[3]);
    VML_CHECK_LAUNCH();
    gemm_tn(st, dl, D, B, w.dfsh, dl, nullptr, 1, fs, D, partial, dw[4], dw[5]);
    VML_CHECK_LAUNCH();
    gemm_tn(st, dl, D, B * NC, w.dh, dl, nullptr, 1, fc, D, partial, dw[0], dw[1]);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

// The unit's input gradients from what `content_backward` left in w:
//   dfw (+)= dfwh Wwh,  dfs (+)= dfsh Wsh,  dfc = dcut + dh Wch (in place:
// dfc holds dcut on entry). With `accumulate`, dfw and dfs already hold the
// other units' shares (K3); without, they are written (K7).
inline cudaError_t content_input_grads(cudaStream_t st, int B, int N, int C, int Nq, int D,
                                       int dl, const float* const* p,
                                       const ContentBackwardScratch& w, bool accumulate,
                                       float* dfc, float* dfw, float* dfs) {
    Epilogue ep;
    ep.ldpost = D;
    ep.post = accumulate ? dfw : nullptr;
    gemm_nn(st, B * Nq, D, dl, w.dfwh, dl, nullptr, 1, p[2], D, dfw, D, ep);
    VML_CHECK_LAUNCH();
    ep.post = accumulate ? dfs : nullptr;
    gemm_nn(st, B, D, dl, w.dfsh, dl, nullptr, 1, p[4], D, dfs, D, ep);
    VML_CHECK_LAUNCH();
    ep.post = dfc;
    gemm_nn(st, B * N * C, D, dl, w.dh, dl, nullptr, 1, p[0], D, dfc, D, ep);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

}  // namespace vml
