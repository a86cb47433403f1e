// The backward of the ContentUnit on the device, shared by the SMI layer
// backward (smin_train.cu, K3) and the content-unit backward
// (content_train.cu, K7): the kernels between the projections and the host
// functions that sequence them with the GEMMs of gemm.cuh. The derivation
// heads smin_train.cu ("ContentUnit"). Everything a kernel writes it owns:
// no atomics, so a run is deterministic.
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

inline size_t content_bwd_smem_bytes(int C, int Nq, int dl) {
    return sizeof(float) * ((size_t)2 * Nq * dl + (size_t)7 * C * dl + (size_t)2 * C * Nq +
                            (size_t)2 * C * C);
}

// One block per (element, pair): the content unit between its projections,
// recomputed and differentiated. Inputs as content_attn_kernel plus dfcc
// (B*N*C, dl). Writes dh (the paths through the clip attention and f_cq;
// the attn_q path is added by the caller's GEMM), dq, da (B*N*C, dl), the
// word attention p and its logit gradients ds (B*N*C, Nq), and dfsh_part
// (B*N, dl) = sum_c dg[c] * h[c].
static __global__ void content_attn_bwd_kernel(
    int N, int C, int Nq, int dl, const float* __restrict__ h, const float* __restrict__ q,
    const float* __restrict__ khat, const float* __restrict__ fwh,
    const float* __restrict__ fsh, const float* __restrict__ qmask,
    const float* __restrict__ vmask, const float* __restrict__ dfcc, float* __restrict__ dh,
    float* __restrict__ dq, float* __restrict__ da, float* __restrict__ pbuf,
    float* __restrict__ dsr, float* __restrict__ dfsh_part) {
    extern __shared__ float smem[];
    float* ks = smem;                 // (Nq, dl)
    float* vs = ks + Nq * dl;         // (Nq, dl)
    float* hs = vs + Nq * dl;         // (C, dl)
    float* qs = hs + C * dl;          // (C, dl)
    float* gs = qs + C * dl;          // (C, dl): f_cq
    float* us = gs + C * dl;          // (C, dl): a * vm + fsh
    float* os = us + C * dl;          // (C, dl): dfcc
    float* dgs = os + C * dl;         // (C, dl): d f_cq
    float* das = dgs + C * dl;        // (C, dl): d a
    float* ps = das + C * dl;         // (C, Nq): word attention
    float* dps = ps + C * Nq;         // (C, Nq): its gradient, then d logits
    float* Ps = dps + C * Nq;         // (C, C): clip attention (unmasked)
    float* dSs = Ps + C * C;          // (C, C): its gradient, then d logits

    const int pair = blockIdx.x;      // b * N + n
    const int b = pair / N;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sdl = 1.f / sqrtf((float)dl);
    const float vm = vmask[pair];
    const size_t row0 = (size_t)pair * C;

    for (int e = tid; e < Nq * dl; e += blockDim.x) {
        ks[e] = khat[(size_t)b * Nq * dl + e];
        vs[e] = fwh[(size_t)b * Nq * dl + e];
    }
    for (int e = tid; e < C * dl; e += blockDim.x) {
        hs[e] = h[row0 * dl + e];
        qs[e] = q[row0 * dl + e];
        os[e] = dfcc[row0 * dl + e];
    }
    __syncthreads();

    // Recompute: word attention p, f_cq, clip attention P.
    for (int idx = warp; idx < C * Nq; idx += nwarps) {
        const int c = idx / Nq;
        const int m = idx % Nq;
        float s = 0.f;
        for (int d = lane; d < dl; d += 32) s += qs[c * dl + d] * ks[m * dl + d];
        s = warp_sum(s);
        if (lane == 0) ps[idx] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sdl : kNegInf;
    }
    __syncthreads();
    if (tid < C) {
        float* p = ps + tid * Nq;
        float mx = p[0];
        for (int m = 1; m < Nq; ++m) mx = fmaxf(mx, p[m]);
        float sum = 0.f;
        for (int m = 0; m < Nq; ++m) {
            p[m] = expf(p[m] - mx);
            sum += p[m];
        }
        for (int m = 0; m < Nq; ++m) p[m] /= sum;
    }
    __syncthreads();
    for (int e = tid; e < C * dl; e += blockDim.x) {
        const int c = e / dl;
        const int d = e % dl;
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += ps[c * Nq + m] * vs[m * dl + d];
        us[e] = a * vm + fsh[(size_t)b * dl + d];
        gs[e] = hs[e] * us[e];
    }
    __syncthreads();
    for (int idx = warp; idx < C * C; idx += nwarps) {
        const int c = idx / C;
        const int e2 = idx % C;
        float s = 0.f, t = 0.f;
        for (int d = lane; d < dl; d += 32) {
            s += gs[c * dl + d] * gs[e2 * dl + d];
            t += os[c * dl + d] * hs[e2 * dl + d];   // dA[c, e2] = dfcc[c] . h[e2]
        }
        s = warp_sum(s);
        t = warp_sum(t);
        if (lane == 0) {
            Ps[idx] = s * inv_sdl;
            dSs[idx] = t;
        }
    }
    __syncthreads();
    if (tid < C) {
        float* P = Ps + tid * C;
        float* dS = dSs + tid * C;
        float mx = P[0];
        for (int e2 = 1; e2 < C; ++e2) mx = fmaxf(mx, P[e2]);
        float sum = 0.f;
        for (int e2 = 0; e2 < C; ++e2) {
            P[e2] = expf(P[e2] - mx);
            sum += P[e2];
        }
        float dot = 0.f;
        for (int e2 = 0; e2 < C; ++e2) {
            P[e2] /= sum;
            dS[e2] *= vm;                 // dP = dA * vm
            dot += P[e2] * dS[e2];
        }
        for (int e2 = 0; e2 < C; ++e2) dS[e2] = P[e2] * (dS[e2] - dot) * inv_sdl;
    }
    __syncthreads();

    for (int e = tid; e < C * dl; e += blockDim.x) {
        const int c = e / dl;
        const int d = e % dl;
        float dh_mix = 0.f, dg = 0.f;
        for (int c2 = 0; c2 < C; ++c2) {
            dh_mix += Ps[c2 * C + c] * os[c2 * dl + d];               // A[c2, c] dfcc[c2]
            dg += (dSs[c * C + c2] + dSs[c2 * C + c]) * gs[c2 * dl + d];
        }
        dgs[e] = dg;
        const float dav = dg * hs[e] * vm;
        das[e] = dav;
        dh[row0 * dl + e] = dh_mix * vm + dg * us[e];
        da[row0 * dl + e] = dav;
    }
    __syncthreads();
    for (int d = tid; d < dl; d += blockDim.x) {
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += dgs[c * dl + d] * hs[c * dl + d];
        dfsh_part[(size_t)pair * dl + d] = s;
    }
    for (int idx = warp; idx < C * Nq; idx += nwarps) {
        const int c = idx / Nq;
        const int m = idx % Nq;
        float s = 0.f;
        for (int d = lane; d < dl; d += 32) s += das[c * dl + d] * vs[m * dl + d];
        s = warp_sum(s);
        if (lane == 0) dps[idx] = s;
    }
    __syncthreads();
    if (tid < C) {
        const float* p = ps + tid * Nq;
        float* dp = dps + tid * Nq;
        float dot = 0.f;
        for (int m = 0; m < Nq; ++m) dot += p[m] * dp[m];
        for (int m = 0; m < Nq; ++m) {
            const float ds = qmask[(size_t)b * Nq + m] > 0.f ? p[m] * (dp[m] - dot) * inv_sdl
                                                            : 0.f;
            dp[m] = ds;
            pbuf[(row0 + tid) * Nq + m] = p[m];
            dsr[(row0 + tid) * Nq + m] = ds;
        }
    }
    __syncthreads();
    for (int e = tid; e < C * dl; e += blockDim.x) {
        const int c = e / dl;
        const int d = e % dl;
        float s = 0.f;
        for (int m = 0; m < Nq; ++m) s += dps[c * Nq + m] * ks[m * dl + d];
        dq[row0 * dl + e] = s;
    }
}

// grid B * (Nq + 1): block (b, m < Nq) reduces over the element's NC clip
// rows dfwh[b, m] = sum_r p[r, m] da[r] and dkhat[b, m] = sum_r ds[r, m]
// q[r]; block (b, Nq) reduces dfsh[b] = sum_n dfsh_part[b, n].
static __global__ void content_reduce_kernel(int N, int C, int Nq, int dl,
                                      const float* __restrict__ pbuf,
                                      const float* __restrict__ dsr,
                                      const float* __restrict__ da,
                                      const float* __restrict__ q,
                                      const float* __restrict__ dfsh_part,
                                      float* __restrict__ dfwh, float* __restrict__ dkhat,
                                      float* __restrict__ dfsh) {
    const int b = blockIdx.x / (Nq + 1);
    const int m = blockIdx.x % (Nq + 1);
    const int NC = N * C;
    for (int d = threadIdx.x; d < dl; d += blockDim.x) {
        if (m == Nq) {
            float s = 0.f;
            for (int n = 0; n < N; ++n) s += dfsh_part[((size_t)b * N + n) * dl + d];
            dfsh[(size_t)b * dl + d] = s;
            continue;
        }
        float s1 = 0.f, s2 = 0.f;
        for (int r = 0; r < NC; ++r) {
            const size_t row = (size_t)b * NC + r;
            s1 += pbuf[row * Nq + m] * da[row * dl + d];
            s2 += dsr[row * Nq + m] * q[row * dl + d];
        }
        dfwh[((size_t)b * Nq + m) * dl + d] = s1;
        dkhat[((size_t)b * Nq + m) * dl + d] = s2;
    }
}

// The content backward's buffers beyond the recomputed forward's own.
struct ContentBackwardScratch {
    float *dfcc, *dh, *dq, *da, *pbuf, *dsr, *dfsh_part, *dfwh, *dkhat, *dfsh;
};
constexpr int kContentBackwardSlots = 10;

// Carves the slots of `w` out of `ws` from `off` on (ws null: only measure);
// returns the offset past them.
inline size_t carve_content_backward(float* ws, size_t off, int B, int N, int C, int Nq, int dl,
                                     ContentBackwardScratch* w) {
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t sizes[kContentBackwardSlots] = {
        rows * dl, rows * dl, rows * dl, rows * dl,         // dfcc, dh, dq, da
        rows * Nq, rows * Nq, (size_t)B * N * dl,           // pbuf, dsr, dfsh_part
        BQ * dl, BQ * dl, (size_t)B * dl,                   // dfwh, dkhat, dfsh
    };
    float** slots[kContentBackwardSlots] = {&w->dfcc, &w->dh, &w->dq, &w->da, &w->pbuf,
                                            &w->dsr, &w->dfsh_part, &w->dfwh, &w->dkhat,
                                            &w->dfsh};
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
    const size_t csmem = content_bwd_smem_bytes(C, Nq, dl);
    cudaError_t err = cudaFuncSetAttribute(
        content_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
    if (err != cudaSuccess) return err;
    content_attn_bwd_kernel<<<B * N, 128, csmem, st>>>(
        N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh, qmask, vmask, w.dfcc, w.dh, w.dq, w.da,
        w.pbuf, w.dsr, w.dfsh_part);
    VML_CHECK_LAUNCH();
    content_reduce_kernel<<<B * (Nq + 1), 128, 0, st>>>(N, C, Nq, dl, w.pbuf, w.dsr, w.da, s.q,
                                                        w.dfsh_part, w.dfwh, w.dkhat, w.dfsh);
    VML_CHECK_LAUNCH();
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
