// The backward of the ContentUnit on the device, shared by the SMI layer
// backward (smin_train.cu, K3) and the content-unit backward
// (content_train.cu, K7 and K10): the host functions that sequence the
// content-attention backward (content_attn.cuh) with the GEMMs of gemm.cuh,
// and the cotangent sum of K3 and K7. The derivation heads smin_train.cu
// ("ContentUnit"). Everything a kernel writes it owns: no atomics, so a run
// is deterministic. One sequence serves both element types: at bf16 (K3-bf16)
// it runs on bf16 activations and gradients with gemm.cuh's bf16 products,
// and a gradient that two paths add to (dh, dfwh, dfw, dfs) stays fp32 until
// its last product's epilogue rounds it once.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "smin_units.cuh"

namespace vml {

// dcut[r, d] = dcu[r, d] + dx2[r / C, d] / C over the B * N * C clip rows;
// dcu may be null (zero). T: fp32, or bf16 (K3-bf16), where the share
// dx2 / C, the gradient of the clip mean's input, is rounded to bf16 before
// the outer cotangent is added and the sum is rounded again: cu is a stored
// bf16 value whose layer also reads it.
template <typename T = float>
static __global__ void dcu_total_kernel(size_t total, int C, int D, const T* __restrict__ dcu,
                                        const T* __restrict__ dx2, T* __restrict__ out) {
    const float inv_c = 1.f / (float)C;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t r = e / D;
        const int d = (int)(e % D);
        const float v = to_f(from_f<T>(to_f(dx2[(r / C) * D + d]) * inv_c));
        out[e] = from_f<T>(dcu ? to_f(dcu[e]) + v : v);
    }
}

// The content backward's buffers beyond the recomputed forward's own, in
// the unit's element type T where the next products read them (dfcc, dq,
// dkhat, dfsh) and fp32 where the pair leaves sums that the projections add
// to (dh, dfwh) and for the pair's partials. dh_t and dfwh_t are those two
// gradients' totals as the last products read them: at fp32 dh and dfwh
// themselves (summed in place), at bf16 their one rounding.
template <typename T>
struct ContentBackwardScratchT {
    T *dfcc, *dq, *dkhat, *dfsh, *dh_t, *dfwh_t;
    float *dh, *part, *dfwh;
};
using ContentBackwardScratch = ContentBackwardScratchT<float>;
constexpr int kContentBackwardSlots = 9;

// Carves the slots of `w` out of the byte workspace `ws` from byte `off` on
// (ws null: only measure); returns the offset past them.
template <typename T>
inline size_t carve_content_backward(unsigned char* ws, size_t off, int B, int N, int C, int Nq,
                                     int dl, ContentBackwardScratchT<T>* w) {
    constexpr bool f32 = std::is_same<T, float>::value;
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t t = sizeof(T), f = sizeof(float);
    const size_t sizes[kContentBackwardSlots] = {
        t * rows * dl, t * rows * dl, t * BQ * dl, t * B * dl,   // dfcc, dq, dkhat, dfsh
        f32 ? 0 : t * rows * dl, f32 ? 0 : t * BQ * dl,          // dh_t, dfwh_t
        f * rows * dl, f * content_attn_partial_floats(B, N, C, Nq, dl), f * BQ * dl,
    };
    void* slots[kContentBackwardSlots];
    off = carve_bytes(ws, off, sizes, slots, kContentBackwardSlots);
    T** typed[6] = {&w->dfcc, &w->dq, &w->dkhat, &w->dfsh, &w->dh_t, &w->dfwh_t};
    for (int k = 0; k < 6; ++k) *typed[k] = static_cast<T*>(slots[k]);
    w->dh = static_cast<float*>(slots[6]);
    w->part = static_cast<float*>(slots[7]);
    w->dfwh = static_cast<float*>(slots[8]);
    if (f32) {
        w->dh_t = reinterpret_cast<T*>(w->dh);
        w->dfwh_t = reinterpret_cast<T*>(w->dfwh);
    }
    return off;
}

// The fp32 slots in a float workspace, from float `off` on; returns the
// offset past them in floats.
inline size_t carve_content_backward(float* ws, size_t off, int B, int N, int C, int Nq, int dl,
                                     ContentBackwardScratch* w) {
    return carve_content_backward<float>(reinterpret_cast<unsigned char*>(ws),
                                         off * sizeof(float), B, N, C, Nq, dl, w) /
           sizeof(float);
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
// `content_forward`, in its element type T: fills w (dh_t, dfwh_t and dfsh
// are the cotangents of the three projections' outputs, which
// `content_input_grads` pushes to the inputs) and the 12 fp32 weight
// gradients dw[0..11] in `content_forward`'s order of p (matrices of type T,
// biases fp32). The products: dfcc = (dcut Wco) * vm; dh_t = (dq Wcq + dh) *
// vm and dfwh_t = (dkhat Wck + dfwh) * qmask; the weight gradients dY^T X
// with the bias gradients the column sums of dY. Returns the first CUDA
// error of the launches.
template <typename T, typename P>
inline cudaError_t content_backward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                    const T* fc, const T* fw, const T* fs, const float* qmask,
                                    const float* vmask, const P* const* p,
                                    const LayerScratchT<T>& s, const ContentBackwardScratchT<T>& w,
                                    float* partial, const T* dcut, float* const* dw) {
    const int NC = N * C;
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    EpilogueOf<T> ep;
    ep.rmask = vmask;
    ep.mask_div = C;
    product_nn(st, B * NC, dl, D, dcut, D, W(6), dl, w.dfcc, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, D, dl, B * NC, dcut, D, vmask, C, s.fcc, dl, partial, dw[6], dw[7]);
    VML_CHECK_LAUNCH();
    cudaError_t err = content_attn_backward(st, B, N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh,
                                            qmask, vmask, w.dfcc, w.dh, w.dq, w.part, w.dfwh,
                                            w.dkhat, w.dfsh);
    if (err != cudaSuccess) return err;
    // attn_q: dh_t = (dq Wcq + dh) * vm.
    ep = EpilogueOf<T>();
    ep.pre = w.dh;
    ep.ldpre = dl;
    ep.rmask = vmask;
    ep.mask_div = C;
    product_nn(st, B * NC, dl, dl, w.dq, dl, W(8), dl, w.dh_t, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, dl, B * NC, w.dq, dl, nullptr, 1, s.h, dl, partial, dw[8], dw[9]);
    VML_CHECK_LAUNCH();
    // attn_k: dfwh_t = (dkhat Wck + dfwh) * qmask.
    ep = EpilogueOf<T>();
    ep.pre = w.dfwh;
    ep.ldpre = dl;
    ep.rmask = qmask;
    product_nn(st, B * Nq, dl, dl, w.dkhat, dl, W(10), dl, w.dfwh_t, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, dl, B * Nq, w.dkhat, dl, nullptr, 1, s.fwh, dl, partial, dw[10], dw[11]);
    VML_CHECK_LAUNCH();
    // w_hat, s_hat, c_hat weights.
    product_tn(st, dl, D, B * Nq, w.dfwh_t, dl, nullptr, 1, fw, D, partial, dw[2], dw[3]);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, D, B, w.dfsh, dl, nullptr, 1, fs, D, partial, dw[4], dw[5]);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, D, B * NC, w.dh_t, dl, nullptr, 1, fc, D, partial, dw[0], dw[1]);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

// The unit's input gradients from what `content_backward` left in w, each
// rounded once to T: dfw = dfwh_t Wwh (+ dfw_acc), dfs = dfsh Wsh (+
// dfs_acc), dfc = dcut + dh_t Wch (in place: dfc holds dcut on entry).
// dfw_acc and dfs_acc (fp32, may be null) hold the other units' shares: K3
// passes them (at fp32 dfw and dfs themselves, summed in place), K7 none.
template <typename T, typename P>
inline cudaError_t content_input_grads(cudaStream_t st, int B, int N, int C, int Nq, int D,
                                       int dl, const P* const* p,
                                       const ContentBackwardScratchT<T>& w, const float* dfw_acc,
                                       const float* dfs_acc, T* dfc, T* dfw, T* dfs) {
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    EpilogueOf<T> ep;
    add_f32(ep, dfw_acc, D);
    product_nn(st, B * Nq, D, dl, w.dfwh_t, dl, W(2), D, dfw, D, ep);
    VML_CHECK_LAUNCH();
    add_f32(ep, dfs_acc, D);
    product_nn(st, B, D, dl, w.dfsh, dl, W(4), D, dfs, D, ep);
    VML_CHECK_LAUNCH();
    ep = EpilogueOf<T>();
    ep.post = dfc;
    ep.ldpost = D;
    product_nn(st, B * N * C, D, dl, w.dh_t, dl, W(0), D, dfc, D, ep);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

}  // namespace vml
