// K7: the ContentUnit of one SMI layer with the moment unit's conv_fc half
// folded in, forward and backward, for proposal maps whose whole layer the
// JAX package does not train in one kernel (ActivityNet: N * C = 8320 clip
// rows per element). K10: the ContentUnit alone with its moment gate, the
// fused unit of the packed unit loop (`fused_content`), forward and
// backward; its section is at the end of this file.
//
// Replaces ops/content_train_pallas.py::_fwd_call (`_fwd_kernel`) and
// ::_bwd_vjp (`_bwd_kernel`) of the JAX package, whose body is
// `_content_rows`. Forward: fc (B, N, C, D), fbar (B, N, D) = the moment gate
// computed by the caller, fw (B, Nq, D), fs (B, D), the query mask and the
// pair mask -> cu (B, N, C, D) and convfc (B, N, D) = conv_fc(mean_c cu) *
// vmask. Backward: recomputes the unit from the same inputs and maps (dcu or
// none, dconvfc) to dfc, dfbar, dfw, dfs and the fp32 gradients of the
// unit's 12 tensors and conv_fc's 2. Rows are n-major (see smin_units.cuh);
// the TPU kernel's c-major carry, pair-block grid and packed weight slab are
// its tiling and are not carried over.
//
// What bounds it on the H100: operations. The forward is 4.7 GFLOP per
// element at the ActivityNet shapes (N = 2080, C = 4, D = 512, dl = 128,
// Nq = 20), the backward twice that on top of the recompute, against 17 MB
// of fc read and 17 MB of cu written per element. The projections, most of
// the operations, run as 3xTF32 on the tensor cores (gemm.cuh, 165 TFLOP/s
// of fp32-accurate products); the content-attention pair is bound by its
// bytes.
//
// Design. The forward is `vml::content_forward`, the content section of the
// layer that K4 and K2 run, then the clip mean and one GEMM whose epilogue
// carries conv_fc's bias and the pair mask. The backward is the content
// section of K3 (`vml::content_backward`, content_bwd.cuh; the derivation
// heads smin_train.cu) with two differences in what flows in and out:
//   dcut[n, c] = dcu[n, c] + ((dconvfc * vm) Wfc)[n] / C
// and dfbar[n] = sum_c dcut[n, c] is returned to the caller instead of being
// pushed through the gate. As in the plain version the mask multiplies f_cc
// only, so at an invalid pair cu = fc + fbar and dfbar = sum_c dcu (the TPU
// kernel zeroes both there; nothing downstream reads an invalid pair
// unmasked). dfw / dfs reduce over the element's pairs and the weight
// gradients over all rows in kernels that own what they write: no atomics,
// a run is deterministic.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "content_bwd.cuh"
#include "smin_units.cuh"

namespace {

// dfbar[n, d] = sum_c dcut[n, c, d] over the B * N pairs.
__global__ void clip_sum_kernel(size_t total, int C, int D, const float* __restrict__ dcut,
                                float* __restrict__ dfbar) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t n = e / D;
        const int d = (int)(e % D);
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += dcut[(n * C + c) * D + d];
        dfbar[e] = s;
    }
}

// K10's gate: grid (B, ceil(D / blockDim)), one thread per (element, d)
// over the pairs, with dfbar[n] = sum_c dcu[n, c] (cu = ... + fbar[n] on
// every clip row):
//   dfm[n] = dfbar[n] * (s + z * s * (1 - s)),  z = fm[n] * fs, s = sigmoid(z)
//   dfs    = sum_n dfbar[n] * fm[n]^2 * s * (1 - s)
// (the s_hat path of dfs is added by `content_input_grads`).
__global__ void unit_gate_bwd_kernel(int N, int C, int D, const float* __restrict__ fm,
                                     const float* __restrict__ fs,
                                     const float* __restrict__ dcu, float* __restrict__ dfm,
                                     float* __restrict__ dfs) {
    const int b = blockIdx.x;
    const int d = blockIdx.y * blockDim.x + threadIdx.x;
    if (d >= D) return;
    const float fsv = fs[(size_t)b * D + d];
    float acc = 0.f;
    for (size_t n = (size_t)b * N; n < (size_t)(b + 1) * N; ++n) {
        float dfbar = 0.f;
        for (int c = 0; c < C; ++c) dfbar += dcu[(n * C + c) * D + d];
        const float x = fm[n * D + d];
        const float z = x * fsv;
        const float sg = vml::sigmoidf_(z);
        const float t = sg * (1.f - sg);
        dfm[n * D + d] = dfbar * (sg + z * t);
        acc += dfbar * x * x * t;
    }
    dfs[(size_t)b * D + d] = acc;
}

struct Workspace {
    vml::LayerScratch s;   // h, q, fcc, fwh, khat, fsh are used
    vml::ContentBackwardScratch w;
    float *x2, *dx2, *partial;   // x2: K7's clip mean, K10's fbar
};

size_t partial_floats(int B, int N, int C, int Nq, int D, int dl) {
    const size_t a = vml::content_partial_floats(B, N, C, Nq, D, dl);
    const size_t b = vml::gemm_tn_partial_floats(D, D, B * N);   // conv_fc's weight
    return a > b ? a : b;
}

// Carves the workspace; returns its size in floats (ws may be null).
size_t carve(float* ws, int B, int N, int C, int Nq, int D, int dl, bool backward,
             Workspace* k) {
    *k = Workspace{};
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t sizes[] = {rows * dl, rows * dl, rows * dl,          // h, q, fcc
                            BQ * dl, BQ * dl, (size_t)B * dl,         // fwh, khat, fsh
                            (size_t)B * N * D};                       // x2
    float** slots[] = {&k->s.h, &k->s.q, &k->s.fcc, &k->s.fwh, &k->s.khat, &k->s.fsh,
                       &k->x2};
    size_t off = vml::carve_slots(ws, 0, sizes, slots, 7);
    if (!backward) return off;
    off = vml::carve_content_backward(ws, off, B, N, C, Nq, dl, &k->w);
    const size_t more[] = {(size_t)B * N * D, partial_floats(B, N, C, Nq, D, dl)};
    float** more_slots[] = {&k->dx2, &k->partial};
    return vml::carve_slots(ws, off, more, more_slots, 2);
}

// cu and x2 = mean_c(cu) from the inputs; intermediates left in k.s.
cudaError_t forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                    const float* fc, const float* fbar, const float* fw, const float* fs,
                    const float* qmask, const float* vmask, const float* const* p,
                    const Workspace& k, float* cu) {
    cudaError_t err =
        vml::content_forward(st, B, N, C, Nq, D, dl, fc, fbar, fw, fs, qmask, vmask, p, k.s, cu);
    if (err != cudaSuccess) return err;
    vml::launch_moment_prologue<float>(st, B * N, 0, C, D, nullptr, cu, nullptr, k.x2, D);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t vml_content_rows_workspace_floats(int B, int N, int C, int Nq, int D, int dl,
                                         int backward) {
    Workspace k;
    return carve(nullptr, B, N, C, Nq, D, dl, backward != 0, &k);
}

// Largest dynamic shared memory of the forward and backward kernels, for the
// wrapper's admission check against the 227 KB a block may have.
size_t vml_content_rows_smem_bytes(int C, int Nq, int dl) {
    const size_t a = vml::content_attn_smem_bytes(1, C, Nq, dl, false);
    const size_t b = vml::content_attn_smem_bytes(1, C, Nq, dl, true);
    return a > b ? a : b;
}

// K7 forward. p: host array of 14 device pointers: the content unit's 12 in
// the order of vml::content_forward, then conv_fc's weight (D, D) and bias.
// Returns the first CUDA error of the launches, 0 if none.
int vml_content_rows_fwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fbar, const float* fw,
                             const float* fs, const float* qmask, const float* vmask,
                             const float* const* p, float* ws, float* cu, float* convfc) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Workspace k;
    carve(ws, B, N, C, Nq, D, dl, false, &k);
    cudaError_t err = forward(st, B, N, C, Nq, D, dl, fc, fbar, fw, fs, qmask, vmask, p, k, cu);
    if (err != cudaSuccess) return (int)err;
    vml::Epilogue ep;    // convfc = (conv_fc(x2) + b) * vmask
    ep.bias = p[13];
    ep.rmask = vmask;
    vml::gemm_nt(st, B * N, D, D, k.x2, D, p[12], D, convfc, D, ep);
    return (int)cudaGetLastError();
}

// K7 backward. dcu may be null (the zero cotangent of a top layer's cu). dw:
// host array of 14 device pointers to the weight-gradient outputs, in p's
// order. dfc doubles as the recompute's cu buffer before it is written.
int vml_content_rows_bwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fbar, const float* fw,
                             const float* fs, const float* qmask, const float* vmask,
                             const float* const* p, const float* dcu, const float* dconvfc,
                             float* ws, float* dfc, float* dfbar, float* dfw, float* dfs,
                             float* const* dw) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Workspace k;
    carve(ws, B, N, C, Nq, D, dl, true, &k);
    cudaError_t err;
#define VML_CHECK()                                                     \
    do {                                                                \
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
    } while (0)

    // Recompute the unit; cu goes to dfc (only x2 = mean_c cu is kept).
    err = forward(st, B, N, C, Nq, D, dl, fc, fbar, fw, fs, qmask, vmask, p, k, dfc);
    if (err != cudaSuccess) return (int)err;

    // conv_fc: with dz = dconvfc * vm, dx2 = dz Wfc, dWfc = dz^T x2, db = sum dz.
    vml::gemm_nn(st, B * N, D, D, dconvfc, D, vmask, 1, p[12], D, k.dx2, D, vml::Epilogue());
    VML_CHECK();
    vml::gemm_tn(st, D, D, B * N, dconvfc, D, vmask, 1, k.x2, D, k.partial, dw[12], dw[13]);
    VML_CHECK();

    // dcut = dcu + dx2 / C into dfc, and dfbar = sum_c dcut.
    const size_t ncd = (size_t)B * N * C * D;
    const int dcu_blocks = (int)((ncd + 255) / 256 < 8192 ? (ncd + 255) / 256 : 8192);
    vml::dcu_total_kernel<<<dcu_blocks, 256, 0, st>>>(ncd, C, D, dcu, k.dx2, dfc);
    VML_CHECK();
    const size_t nd = (size_t)B * N * D;
    const int sum_blocks = (int)((nd + 255) / 256 < 8192 ? (nd + 255) / 256 : 8192);
    clip_sum_kernel<<<sum_blocks, 256, 0, st>>>(nd, C, D, dfc, dfbar);
    VML_CHECK();

    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, k.s, k.w,
                                k.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;
    err = vml::content_input_grads(st, B, N, C, Nq, D, dl, p, k.w, nullptr, nullptr, dfc, dfw,
                                   dfs);
#undef VML_CHECK
    return (int)err;
}

}  // extern "C"

// ------------------------------------------------------------------------
// K10: the fused ContentUnit of the packed unit loop.
//
// Replaces ops/content_pallas.py::_content_unit_fused (`_kernel`) of the JAX
// package, whose backward is the VJP of the XLA unit
// (models/smin.py::content_unit_packed). Forward: fc (B, N, C, D), fm
// (B, N, D), fw, fs, the query mask and the pair mask -> cu = c_out(f_cc_hat)
// * vmask + fc + fbar, fbar = sigmoid(fm * fs) * fm computed here (the mask
// multiplies f_cc only: an invalid pair carries fc + fbar, as in the JAX
// kernel and the XLA unit). Backward: recomputes the unit and maps dcu to
// dfc, dfm, dfw, dfs and the fp32 gradients of the unit's 12 tensors.
//
// What bounds it on the H100: operations, as K7 without its conv_fc GEMM:
// 2 * N * C * (2 D dl + dl^2 + 2 Nq dl + 2 C dl + dl D) per element, 0.7
// GFLOP at the Charades shapes (N = 136), against 2.2 MB of fc, fm and cu
// per element. All but the 2 C dl term are the five projections forward
// (eleven backward), which run as 3xTF32 on the tensor cores (gemm.cuh, 165
// TFLOP/s of fp32-accurate products); the gate is a row walk bound by its
// bytes (smin_units.cuh).
//
// Design. The forward is the gate (`vml::gate_kernel`) and
// `vml::content_forward`, the content section of the layer that K4, K2 and
// K7 run. The backward is K7's with no conv_fc cotangent, so dcut = dcu;
// `unit_gate_bwd_kernel` then turns dfbar = sum_c dcu into dfm and the
// gate's share of dfs. The workspace is K7's, its clip-mean slot holding
// fbar instead. No atomics: a run is deterministic.

namespace {

// fbar in the x2 slot, then the unit; intermediates left in k.s.
cudaError_t unit_forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                         const float* fc, const float* fm, const float* fw, const float* fs,
                         const float* qmask, const float* vmask, const float* const* p,
                         const Workspace& k, float* cu) {
    vml::launch_gate(st, B, N, D, fm, fs, k.x2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return vml::content_forward(st, B, N, C, Nq, D, dl, fc, k.x2, fw, fs, qmask, vmask, p, k.s,
                                cu);
}

}  // namespace

extern "C" {

// K10 forward. p: host array of the unit's 12 device pointers in the order
// of vml::content_forward. ws: vml_content_rows_workspace_floats(..., 0)
// floats. Returns the first CUDA error of the launches, 0 if none.
int vml_content_unit_fwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fm, const float* fw, const float* fs,
                             const float* qmask, const float* vmask, const float* const* p,
                             float* ws, float* cu) {
    Workspace k;
    carve(ws, B, N, C, Nq, D, dl, false, &k);
    return (int)unit_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fm, fw,
                             fs, qmask, vmask, p, k, cu);
}

// K10 backward. dw: host array of 12 device pointers to the weight-gradient
// outputs, in p's order. ws: vml_content_rows_workspace_floats(..., 1)
// floats. dfc doubles as the recompute's cu buffer before it is written.
int vml_content_unit_bwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fm, const float* fw, const float* fs,
                             const float* qmask, const float* vmask, const float* const* p,
                             const float* dcu, float* ws, float* dfc, float* dfm, float* dfw,
                             float* dfs, float* const* dw) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Workspace k;
    carve(ws, B, N, C, Nq, D, dl, true, &k);
    cudaError_t err =
        unit_forward(st, B, N, C, Nq, D, dl, fc, fm, fw, fs, qmask, vmask, p, k, dfc);
    if (err != cudaSuccess) return (int)err;
    // dcut = dcu into dfc; the gate's gradients; then the unit's.
    err = cudaMemcpyAsync(dfc, dcu, sizeof(float) * B * N * C * D, cudaMemcpyDeviceToDevice,
                          st);
    if (err != cudaSuccess) return (int)err;
    unit_gate_bwd_kernel<<<dim3(B, (D + 127) / 128), 128, 0, st>>>(N, C, D, fm, fs, dcu, dfm,
                                                                    dfs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = cudaMemsetAsync(dfw, 0, sizeof(float) * B * Nq * D, st)) != cudaSuccess)
        return (int)err;
    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, k.s, k.w,
                                k.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;
    return (int)vml::content_input_grads(st, B, N, C, Nq, D, dl, p, k.w, dfw, dfs, dfc, dfw,
                                         dfs);
}

}  // extern "C"
