// One SMI layer on the device: the per-unit kernels and the host functions
// that sequence them, shared by the serving stack (smin_stack.cu, K4), the
// training layer kernels (smin_train.cu, K2 and the recompute of K3) and the
// content-unit training kernels (content_train.cu, K7, which runs
// `content_forward` alone).
//
// Because the ~1.1 MB of fp32 state per element does not fit a block's
// 227 KB of shared memory, a layer is a sequence of kernels on one stream
// with its intermediates in a device scratch:
//   gate_kernel            fbar = sigmoid(fm * fs) * fm
//   gemm_nt (gemm.cuh)     every projection, with bias / mask / residual
//                          epilogues
//   content_attn_forward   word attention of each clip row (-1e9 key mask),
//   (content_attn.cuh)     f_cq, the C x C clip attention (softmax unmasked,
//                          mask after), a block per tile of an element's
//                          pairs
//   boundary_query_kernel  word attention and f_bq of one snippet row
//   boundary_unit_kernel   A_b, f_bb and the moment message f_bm of one
//                          snippet row
//   moment_prologue_kernel outer[n] = bu[i_n] * bu[j_n] and mean_c(cu)
// Rows are n-major: row (b, n, c) of fc/cu is ((b * N) + n) * C + c, the
// layout of the plain version, models/smin.py::smi_block_packed.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "content_attn.cuh"
#include "gemm.cuh"
#include "proposal.cuh"

namespace vml {

constexpr int kWeightsPerLayer = 20;

// fbar = sigmoid(fm * fs) * fm over (B, N, D).
static __global__ void gate_kernel(size_t total, int ND, int D, const float* __restrict__ fm,
                            const float* __restrict__ fs, float* __restrict__ fbar) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const int b = (int)(e / ND);
        const int d = (int)(e % D);
        const float x = fm[e];
        fbar[e] = sigmoidf_(x * fs[(size_t)b * D + d]) * x;
    }
}

// The boundary unit between its projections, in two kernels of one block
// per (element, snippet row i). bq (B*L, D) = attn_q(fb), bk (B*Nq, D) =
// attn_k(fw); fw (B, Nq, D), fb (B, L, D), fs (B, D), fbar (B, N, D).
//
// boundary_query_kernel: word attention of row i (-1e9 key mask), then
// f_bq[i] = fb[i] * (f_baq[i] * lmask[i] + fs).
static __global__ void boundary_query_kernel(int L, int Nq, int D, const float* __restrict__ bq,
                                      const float* __restrict__ bk,
                                      const float* __restrict__ fw,
                                      const float* __restrict__ fb,
                                      const float* __restrict__ fs,
                                      const float* __restrict__ qmask,
                                      const float* __restrict__ lmask,
                                      float* __restrict__ fbq) {
    extern __shared__ float smem[];
    float* p = smem;                  // (Nq,): word attention of row i
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* x = bq + (size_t)row * D;

    for (int m = warp; m < Nq; m += nwarps) {
        const float* y = bk + ((size_t)b * Nq + m) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * y[d];
        s = warp_sum(s);
        if (lane == 0) p[m] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sd : kNegInf;
    }
    __syncthreads();
    if (tid == 0) {
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
    const float lm = lmask[row];
    const float* fwe = fw + (size_t)b * Nq * D;
    for (int d = tid; d < D; d += blockDim.x) {
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += p[m] * fwe[(size_t)m * D + d];
        fbq[(size_t)row * D + d] = fb[(size_t)row * D + d] * (a * lm + fs[(size_t)b * D + d]);
    }
}

// boundary_unit_kernel: A_b[i] = softmax_j(f_bq[i] . f_bq[j] / sqrt(D), -1e9
// on invalid j) * lmask[i], then bu[i] = f_bb[i] + fb[i] + f_bm[i] with
// f_bb[i] = (A_b[i] @ fb) * lmask[i] and f_bm[i] = sum over pairs n = (i, j)
// of A_b[i, j] * fbar[n].
static __global__ void boundary_unit_kernel(int L, int D, const float* __restrict__ fbq,
                                     const float* __restrict__ fb,
                                     const float* __restrict__ fbar,
                                     const float* __restrict__ lmask,
                                     float* __restrict__ bu) {
    extern __shared__ float smem[];
    float* a = smem;                  // (L,): A_b row i
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int N = L * (L + 1) / 2;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* lm = lmask + (size_t)b * L;
    const float* x = fbq + (size_t)row * D;

    for (int j = warp; j < L; j += nwarps) {
        const float* y = fbq + ((size_t)b * L + j) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * y[d];
        s = warp_sum(s);
        if (lane == 0) a[j] = lm[j] > 0.f ? s * inv_sd : kNegInf;
    }
    __syncthreads();
    if (tid == 0) {
        float mx = a[0];
        for (int j = 1; j < L; ++j) mx = fmaxf(mx, a[j]);
        float sum = 0.f;
        for (int j = 0; j < L; ++j) {
            a[j] = expf(a[j] - mx);
            sum += a[j];
        }
        for (int j = 0; j < L; ++j) a[j] = a[j] / sum * lm[i];
    }
    __syncthreads();
    const float* fbe = fb + (size_t)b * L * D;
    const float* fbar_i = fbar + ((size_t)b * N + pair_index(i, i, L)) * D;
    for (int d = tid; d < D; d += blockDim.x) {
        float bb = 0.f;
        for (int j = 0; j < L; ++j) bb += a[j] * fbe[(size_t)j * D + d];
        float bm = 0.f;
        for (int j = i; j < L; ++j) bm += a[j] * fbar_i[(size_t)(j - i) * D + d];
        bu[(size_t)row * D + d] = bb * lm[i] + fbe[(size_t)i * D + d] + bm;
    }
}

// One block per (element, pair): x1 = bu[i_n] * bu[j_n], x2 = mean_c(cu).
// bu and x1 may be null (L is then unused): only the clip mean is written.
static __global__ void moment_prologue_kernel(int L, int C, int D, const float* __restrict__ bu,
                                       const float* __restrict__ cu,
                                       float* __restrict__ x1, float* __restrict__ x2) {
    const int pair = blockIdx.x;
    const float* bi = nullptr;
    const float* bj = nullptr;
    if (bu) {
        const int N = L * (L + 1) / 2;
        const int b = pair / N;
        int i, j;
        pair_of(pair % N, L, i, j);
        bi = bu + ((size_t)b * L + i) * D;
        bj = bu + ((size_t)b * L + j) * D;
    }
    const float* cp = cu + (size_t)pair * C * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        if (bu) x1[(size_t)pair * D + d] = bi[d] * bj[d];
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += cp[(size_t)c * D + d];
        x2[(size_t)pair * D + d] = s / (float)C;
    }
}

// The intermediates of one layer. K4 and K2 only pass through them; the
// backward (K3) reads them after the recompute.
struct LayerScratch {
    float *fbar, *h, *q, *fcc, *fwh, *khat, *fsh, *bq, *bk, *fbq, *x1, *x2, *tmp;
};
constexpr int kLayerScratchSlots = 13;

// Sizes in floats of the LayerScratch slots, in declaration order.
inline void layer_scratch_sizes(int B, int L, int C, int Nq, int D, int dl, size_t* sizes) {
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t NC = N * C;
    const size_t v[kLayerScratchSlots] = {
        B * N * D,                              // fbar
        B * NC * dl, B * NC * dl, B * NC * dl,  // h, q, fcc
        (size_t)B * Nq * dl, (size_t)B * Nq * dl, (size_t)B * dl,  // fwh, khat, fsh
        (size_t)B * L * D, (size_t)B * Nq * D,  // bq, bk
        (size_t)B * L * D,                      // fbq
        B * N * D, B * N * D, B * N * D,        // x1, x2, tmp
    };
    for (int k = 0; k < kLayerScratchSlots; ++k) sizes[k] = v[k];
}

inline float** layer_scratch_slot(LayerScratch* s, int k) {
    float** slots[kLayerScratchSlots] = {&s->fbar, &s->h, &s->q, &s->fcc, &s->fwh,
                                         &s->khat, &s->fsh, &s->bq, &s->bk, &s->fbq,
                                         &s->x1, &s->x2, &s->tmp};
    return slots[k];
}

// Carves slots of the given sizes out of `ws` (null: only measure), each
// 16-byte aligned; returns the floats used from `off` on.
inline size_t carve_slots(float* ws, size_t off, const size_t* sizes, float*** slots, int n) {
    for (int k = 0; k < n; ++k) {
        *slots[k] = ws ? ws + off : nullptr;
        off += (sizes[k] + 3) / 4 * 4;
    }
    return off;
}

inline size_t carve_layer_scratch(float* ws, size_t off, int B, int L, int C, int Nq, int D,
                                  int dl, LayerScratch* s) {
    size_t sizes[kLayerScratchSlots];
    float** slots[kLayerScratchSlots];
    layer_scratch_sizes(B, L, C, Nq, D, dl, sizes);
    for (int k = 0; k < kLayerScratchSlots; ++k) slots[k] = layer_scratch_slot(s, k);
    return carve_slots(ws, off, sizes, slots, kLayerScratchSlots);
}

// Largest dynamic shared memory of the forward kernels of a layer.
inline size_t layer_forward_smem_bytes(int L, int C, int Nq, int dl) {
    const size_t a = content_attn_smem_bytes(L * (L + 1) / 2, C, Nq, dl, false);
    const size_t b = sizeof(float) * (size_t)(Nq > L ? Nq : L);   // boundary kernels
    return a > b ? a : b;
}

#define VML_CHECK_LAUNCH()                                                  \
    do {                                                                    \
        cudaError_t vml_err_ = cudaGetLastError();                          \
        if (vml_err_ != cudaSuccess) return vml_err_;                       \
    } while (0)

// The ContentUnit of a layer over N pairs: (fc, fbar) -> cu = c_out(f_cc_hat)
// * vmask + fc + fbar, with h, q, fwh, khat, fsh and fcc left in `s`. p: the
// unit's 12 device pointers, the first 12 of `layer_forward`'s order.
inline cudaError_t content_forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                   const float* fc, const float* fbar, const float* fw,
                                   const float* fs, const float* qmask, const float* vmask,
                                   const float* const* p, const LayerScratch& s, float* cu) {
    const int NC = N * C;
    Epilogue ep;
    ep.bias = p[1];
    ep.rmask = vmask;
    ep.mask_div = C;
    gemm_nt(st, B * NC, dl, D, fc, D, p[0], D, s.h, dl, ep);          // c_hat * vmask
    VML_CHECK_LAUNCH();
    linear(st, B * NC, dl, dl, s.h, p[8], p[9], s.q);                  // attn_q
    VML_CHECK_LAUNCH();
    ep = Epilogue();
    ep.bias = p[3];
    ep.rmask = qmask;
    gemm_nt(st, B * Nq, dl, D, fw, D, p[2], D, s.fwh, dl, ep);        // w_hat * qmask
    VML_CHECK_LAUNCH();
    linear(st, B * Nq, dl, dl, s.fwh, p[10], p[11], s.khat);           // attn_k
    VML_CHECK_LAUNCH();
    linear(st, B, dl, D, fs, p[4], p[5], s.fsh);                       // s_hat
    VML_CHECK_LAUNCH();
    cudaError_t err = content_attn_forward(st, B, N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh,
                                           qmask, vmask, s.fcc);
    if (err != cudaSuccess) return err;
    ep = Epilogue();     // cu = c_out(f_cc_hat) * vmask + fc + fbar
    ep.bias = p[7];
    ep.rmask = vmask;
    ep.mask_div = C;
    ep.post = fc;
    ep.ldpost = D;
    ep.post2 = fbar;
    ep.ldpost2 = D;
    ep.post2_div = C;
    gemm_nt(st, B * NC, D, dl, s.fcc, dl, p[6], dl, cu, D, ep);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

// One SMI layer: (fc, fm, fb) -> (cu, mu, bu), intermediates left in `s`.
// p: the layer's 20 device pointers in the order
//   c_hat.w, c_hat.b, w_hat.w, w_hat.b, s_hat.w, s_hat.b, c_out.w, c_out.b,
//   content attn W_q.w, .b, W_k.w, .b, boundary attn W_q.w, .b, W_k.w, .b,
//   conv_fb.w, .b, conv_fc.w, .b
// (torch layouts: Linear (out, in), 1x1 conv (out, in, 1, 1)).
// mu may be null: the two moment convolutions are then skipped (the
// backward's recompute needs only their inputs x1, x2).
// Returns the first CUDA error of the launches.
inline cudaError_t layer_forward(cudaStream_t st, int B, int L, int C, int Nq, int D, int dl,
                                 const float* fc, const float* fm, const float* fb,
                                 const float* fw, const float* fs, const float* qmask,
                                 const float* lmask, const float* vmask,
                                 const float* const* p, const LayerScratch& s, float* cu,
                                 float* mu, float* bu) {
    const int N = L * (L + 1) / 2;
    const size_t nd = (size_t)B * N * D;
    const int gate_blocks = (int)((nd + 255) / 256 < 4096 ? (nd + 255) / 256 : 4096);
    gate_kernel<<<gate_blocks, 256, 0, st>>>(nd, N * D, D, fm, fs, s.fbar);
    VML_CHECK_LAUNCH();

    cudaError_t err =
        content_forward(st, B, N, C, Nq, D, dl, fc, s.fbar, fw, fs, qmask, vmask, p, s, cu);
    if (err != cudaSuccess) return err;

    // BoundaryUnit
    linear(st, B * L, D, D, fb, p[12], p[13], s.bq);
    VML_CHECK_LAUNCH();
    linear(st, B * Nq, D, D, fw, p[14], p[15], s.bk);
    VML_CHECK_LAUNCH();
    boundary_query_kernel<<<B * L, 128, Nq * sizeof(float), st>>>(
        L, Nq, D, s.bq, s.bk, fw, fb, fs, qmask, lmask, s.fbq);
    VML_CHECK_LAUNCH();
    boundary_unit_kernel<<<B * L, 128, L * sizeof(float), st>>>(L, D, s.fbq, fb, s.fbar,
                                                                lmask, bu);
    VML_CHECK_LAUNCH();

    // MomentUnit: mu = (conv_fb(outer) + conv_fc(mean_c cu)) * vmask + fm
    moment_prologue_kernel<<<B * N, 128, 0, st>>>(L, C, D, bu, cu, s.x1, s.x2);
    VML_CHECK_LAUNCH();
    if (mu) {
        linear(st, B * N, D, D, s.x1, p[16], p[17], s.tmp);
        VML_CHECK_LAUNCH();
        Epilogue ep;
        ep.bias = p[19];
        ep.pre = s.tmp;
        ep.ldpre = D;
        ep.rmask = vmask;
        ep.post = fm;
        ep.ldpost = D;
        gemm_nt(st, B * N, D, D, s.x2, D, p[18], D, mu, D, ep);
        VML_CHECK_LAUNCH();
    }
    return cudaSuccess;
}

}  // namespace vml
