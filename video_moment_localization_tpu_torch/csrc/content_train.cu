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
//
// The bf16 variant (K7-bf16, the JAX kernel at bf16: ActivityNet's bf16
// training) runs the same sequences on bf16 activations and cotangents, as
// K2-bf16 and K3-bf16 run the layer: `content_forward<bf16>` (bf16 products
// with fp32 sums, fp32 arithmetic inside every other kernel, one rounding per
// stored value: h, q, fwh, khat, f_cc_hat, cu), the clip mean of the stored
// cu rounded once, conv_fc on gemm.cuh's bf16 path with its fp32 bias; the
// backward rounds each stored value's gradient once where the plain version
// (autograd through ops/content_train_cuda.py::content_rows_plain_bf16)
// rounds it: dx2, dcut, dfbar, then `content_backward<bf16>` /
// `content_input_grads<bf16>` as in K3-bf16. Weight matrices are bf16,
// biases and the 14 weight gradients fp32. The JAX kernel sums cu and
// takes the clip mean in fp32 and keeps h in fp32 through the clip
// attention; the port keeps the layer's (K2-bf16's) rounding, which differs
// from it by a bf16 rounding of those values.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "content_bwd.cuh"
#include "smin_units.cuh"

namespace {

using vml::bf16;

// The scratch of K7 and K10 in the element type T: the content section of
// the layer's (h, q, fcc, fwh, khat of T, fsh fp32), x2 (K7's clip mean,
// K10's fbar) and dx2 of T, the backward's content buffers, the split
// reductions' partials and, at bf16, K10's fp32 sum of dfs (at fp32 dfs
// sums in place: `vml::f32_sum`).
template <typename T>
struct Workspace {
    vml::LayerScratchT<T> s;   // h, q, fcc, fwh, khat, fsh are used
    vml::ContentBackwardScratchT<T> w;
    T *x2, *dx2;
    float *partial, *dfs32;
};

// The split reductions' partials, which K10's gate backward also uses
// before the unit's products do.
size_t partial_floats(int B, int N, int C, int Nq, int D, int dl) {
    const size_t sizes[3] = {vml::content_partial_floats(B, N, C, Nq, D, dl),
                             vml::gemm_tn_partial_floats(D, D, B * N),   // conv_fc's weight
                             vml::gate_part_floats(B, D)};
    size_t most = 0;
    for (size_t f : sizes) most = f > most ? f : most;
    return most;
}

// Carves the byte workspace `ws` (null: only measure); returns its size in
// bytes.
template <typename T>
size_t carve(unsigned char* ws, int B, int N, int C, int Nq, int D, int dl, bool backward,
             Workspace<T>* k) {
    *k = Workspace<T>{};
    constexpr bool f32 = std::is_same<T, float>::value;
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t t = sizeof(T), f = sizeof(float);
    const size_t sizes[7] = {t * rows * dl, t * rows * dl, t * rows * dl,   // h, q, fcc
                             t * BQ * dl, t * BQ * dl, f * B * dl,          // fwh, khat, fsh
                             t * B * N * D};                                // x2
    void* slots[7];
    size_t off = vml::carve_bytes(ws, 0, sizes, slots, 7);
    T** typed[6] = {&k->s.h, &k->s.q, &k->s.fcc, &k->s.fwh, &k->s.khat, &k->x2};
    const int at[6] = {0, 1, 2, 3, 4, 6};
    for (int i = 0; i < 6; ++i) *typed[i] = static_cast<T*>(slots[at[i]]);
    k->s.fsh = static_cast<float*>(slots[5]);
    if (!backward) return off;
    off = vml::carve_content_backward<T>(ws, off, B, N, C, Nq, dl, &k->w);
    const size_t more[3] = {t * B * N * D, f * partial_floats(B, N, C, Nq, D, dl),
                            f32 ? 0 : f * B * D};   // dx2, partial, dfs32
    void* more_slots[3];
    off = vml::carve_bytes(ws, off, more, more_slots, 3);
    k->dx2 = static_cast<T*>(more_slots[0]);
    k->partial = static_cast<float*>(more_slots[1]);
    k->dfs32 = static_cast<float*>(more_slots[2]);
    return off;
}

// cu and x2 = mean_c(cu) (of the stored cu, rounded once to T) from the
// inputs; intermediates left in k.s.
template <typename T, typename P>
cudaError_t forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl, const T* fc,
                    const T* fbar, const T* fw, const T* fs, const float* qmask,
                    const float* vmask, const P* const* p, const Workspace<T>& k, T* cu) {
    cudaError_t err =
        vml::content_forward(st, B, N, C, Nq, D, dl, fc, fbar, fw, fs, qmask, vmask, p, k.s, cu);
    if (err != cudaSuccess) return err;
    vml::launch_moment_prologue<T>(st, B * N, C, D, cu, k.x2, D);
    return cudaGetLastError();
}

// K7 forward at T: cu, then convfc = (conv_fc(x2) + b) * vmask.
template <typename T, typename P>
int rows_forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl, const T* fc,
                 const T* fbar, const T* fw, const T* fs, const float* qmask,
                 const float* vmask, const P* const* p, unsigned char* ws, T* cu, T* convfc) {
    Workspace<T> k;
    carve(ws, B, N, C, Nq, D, dl, false, &k);
    cudaError_t err = forward(st, B, N, C, Nq, D, dl, fc, fbar, fw, fs, qmask, vmask, p, k, cu);
    if (err != cudaSuccess) return (int)err;
    vml::EpilogueOf<T> ep;
    ep.bias = static_cast<const float*>(p[13]);
    ep.rmask = vmask;
    vml::product(st, B * N, D, D, k.x2, D, static_cast<const T*>(p[12]), D, convfc, D, ep);
    return (int)cudaGetLastError();
}

// K7 backward at T (see the file's head; dcu may be null).
template <typename T, typename P>
int rows_backward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl, const T* fc,
                  const T* fbar, const T* fw, const T* fs, const float* qmask,
                  const float* vmask, const P* const* p, const T* dcu, const T* dconvfc,
                  unsigned char* ws, T* dfc, T* dfbar, T* dfw, T* dfs, float* const* dw) {
    Workspace<T> k;
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
    vml::EpilogueOf<T> ep;
    ep.rmask = vmask;
    vml::product_nn(st, B * N, D, D, dconvfc, D, static_cast<const T*>(p[12]), D, k.dx2, D, ep);
    VML_CHECK();
    vml::product_tn(st, D, D, B * N, dconvfc, D, vmask, 1, k.x2, D, k.partial, dw[12], dw[13]);
    VML_CHECK();

    // dcut = dcu + dx2 / C into dfc, and dfbar = sum_c dcut.
    vml::launch_dcut<T>(st, B * N, C, D, dcu, k.dx2, dfc, dfbar);
    VML_CHECK();
#undef VML_CHECK

    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, k.s, k.w,
                                k.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;
    return (int)vml::content_input_grads(st, B, N, C, Nq, D, dl, p, k.w, nullptr, nullptr, dfc,
                                         dfc, dfw, dfs);
}

}  // namespace

extern "C" {

// Bytes of the workspace of K7's and K10's forward (backward 0) or backward
// (backward 1) entries, fp32 (bf16 0) or bf16 (bf16 1).
size_t vml_content_rows_workspace_bytes(int B, int N, int C, int Nq, int D, int dl,
                                        int backward, int bf16_) {
    if (bf16_) {
        Workspace<bf16> k;
        return carve<bf16>(nullptr, B, N, C, Nq, D, dl, backward != 0, &k);
    }
    Workspace<float> k;
    return carve<float>(nullptr, B, N, C, Nq, D, dl, backward != 0, &k);
}

// The splits of an element's N pairs in the moment gate's backward
// (vml::gate_bwd_splits; mirrored by ops/content_cuda.py::gate_bwd_splits).
int vml_gate_bwd_splits(int B, int N, int cols) { return vml::gate_bwd_splits(B, N, cols); }

// Largest dynamic shared memory of the forward and backward kernels, for the
// wrapper's admission check against the 227 KB a block may have (the fp32
// kernels': the bf16 forward stages fp32 rows, the bf16 backward bf16 rows
// in less).
size_t vml_content_rows_smem_bytes(int C, int Nq, int dl) {
    const size_t a = vml::content_attn_smem_bytes(1, C, Nq, dl, false);
    const size_t b = vml::content_attn_smem_bytes(1, C, Nq, dl, true);
    return a > b ? a : b;
}

// K7 forward. p: host array of 14 device pointers: the content unit's 12 in
// the order of vml::content_forward, then conv_fc's weight (D, D) and bias.
// ws: vml_content_rows_workspace_bytes(..., 0, 0) bytes. Returns the first
// CUDA error of the launches, 0 if none.
int vml_content_rows_fwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fbar, const float* fw,
                             const float* fs, const float* qmask, const float* vmask,
                             const float* const* p, void* ws, float* cu, float* convfc) {
    return rows_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fbar, fw, fs,
                        qmask, vmask, p, static_cast<unsigned char*>(ws), cu, convfc);
}

// K7 backward. dcu may be null (the zero cotangent of a top layer's cu). dw:
// host array of 14 device pointers to the weight-gradient outputs, in p's
// order. dfc doubles as the recompute's cu buffer before it is written.
int vml_content_rows_bwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fbar, const float* fw,
                             const float* fs, const float* qmask, const float* vmask,
                             const float* const* p, const float* dcu, const float* dconvfc,
                             void* ws, float* dfc, float* dfbar, float* dfw, float* dfs,
                             float* const* dw) {
    return rows_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fbar, fw, fs,
                         qmask, vmask, p, dcu, dconvfc, static_cast<unsigned char*>(ws), dfc,
                         dfbar, dfw, dfs, dw);
}

// K7-bf16 forward: K7 on bf16 activations (fc, fbar, fw, fs, cu, convfc),
// the matrices bf16 and the biases fp32 in p, the masks fp32. ws:
// vml_content_rows_workspace_bytes(..., 0, 1) bytes.
int vml_content_rows_fwd_bf16(void* stream, int B, int N, int C, int Nq, int D, int dl,
                              const bf16* fc, const bf16* fbar, const bf16* fw, const bf16* fs,
                              const float* qmask, const float* vmask, const void* const* p,
                              void* ws, bf16* cu, bf16* convfc) {
    return rows_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fbar, fw, fs,
                        qmask, vmask, p, static_cast<unsigned char*>(ws), cu, convfc);
}

// K7-bf16 backward: bf16 cotangents (dcu may be null) and input gradients,
// each rounded once; the 14 weight gradients fp32 (dw). ws:
// vml_content_rows_workspace_bytes(..., 1, 1) bytes.
int vml_content_rows_bwd_bf16(void* stream, int B, int N, int C, int Nq, int D, int dl,
                              const bf16* fc, const bf16* fbar, const bf16* fw, const bf16* fs,
                              const float* qmask, const float* vmask, const void* const* p,
                              const bf16* dcu, const bf16* dconvfc, void* ws, bf16* dfc,
                              bf16* dfbar, bf16* dfw, bf16* dfs, float* const* dw) {
    return rows_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fbar, fw, fs,
                         qmask, vmask, p, dcu, dconvfc, static_cast<unsigned char*>(ws), dfc,
                         dfbar, dfw, dfs, dw);
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
// K7 run. The backward recomputes the unit without the gate and the c_out
// product (fbar and cu have no reader there), then runs K7's with no
// conv_fc cotangent, reading dcut = dcu in place (no copy);
// `vml::gate_backward` (content_bwd.cuh, K3's gate without its boundary and
// moment terms, split along the pairs) turns dfbar = sum_c dcu into dfm and
// the gate's share of dfs. The workspace is K7's, its clip-mean slot holding
// fbar instead. No atomics: a run is deterministic.
//
// The bf16 variant (K10-bf16, the JAX kernel at bf16) runs it on bf16
// activations as K7-bf16 runs K7, with the JAX fused unit's residual: f_cc
// rounded to bf16, then + fc and + fbar (the gate computed in fp32 and
// stored in bf16) added in bf16, each sum rounded (`residual_in_t`, the
// GEMM epilogue's round_each). The backward is K7-bf16's content section
// with dcut = dcu, then the gate's, dfbar rounded to bf16 as fbar is
// stored; its plain version is autograd through ops/content_cuda.py::
// content_unit_plain_bf16, which rounds where the kernel rounds.

namespace {

// fbar in the x2 slot, then the unit with its residual added in T;
// intermediates left in k.s. cu null (the backward's recompute): neither
// the gate nor the c_out product, whose only reader is cu.
template <typename T, typename P>
cudaError_t unit_forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                         const T* fc, const T* fm, const T* fw, const T* fs, const float* qmask,
                         const float* vmask, const P* const* p, const Workspace<T>& k, T* cu) {
    if (cu) {
        vml::launch_gate(st, B, N, D, fm, fs, k.x2);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return vml::content_forward(st, B, N, C, Nq, D, dl, fc, k.x2, fw, fs, qmask, vmask, p, k.s,
                                cu, true);
}

template <typename T, typename P>
int unit_backward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl, const T* fc,
                  const T* fm, const T* fw, const T* fs, const float* qmask, const float* vmask,
                  const P* const* p, const T* dcu, unsigned char* ws, T* dfc, T* dfm, T* dfw,
                  T* dfs, float* const* dw) {
    Workspace<T> k;
    carve(ws, B, N, C, Nq, D, dl, true, &k);
    cudaError_t err = unit_forward(st, B, N, C, Nq, D, dl, fc, fm, fw, fs, qmask, vmask, p, k,
                                   static_cast<T*>(nullptr));
    if (err != cudaSuccess) return (int)err;
    // dcut = dcu: the gate's gradients (its share of dfs in fp32), then the
    // unit's, reading dcu where K3 and K7 read their dcut.
    float* dfs32 = vml::f32_sum(dfs, k.dfs32);
    err = vml::gate_backward<false>(st, B, N, 0, C, D, fm, fs, static_cast<const T*>(nullptr),
                                    dcu, nullptr, nullptr, nullptr, dfm, k.partial, dfs32);
    if (err != cudaSuccess) return (int)err;
    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, k.s, k.w,
                                k.partial, dcu, dw);
    if (err != cudaSuccess) return (int)err;
    return (int)vml::content_input_grads(st, B, N, C, Nq, D, dl, p, k.w, nullptr, dfs32, dcu,
                                         dfc, dfw, dfs);
}

}  // namespace

extern "C" {

// K10 forward. p: host array of the unit's 12 device pointers in the order
// of vml::content_forward. ws: vml_content_rows_workspace_bytes(..., 0, 0)
// bytes. Returns the first CUDA error of the launches, 0 if none.
int vml_content_unit_fwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fm, const float* fw, const float* fs,
                             const float* qmask, const float* vmask, const float* const* p,
                             void* ws, float* cu) {
    Workspace<float> k;
    carve(static_cast<unsigned char*>(ws), B, N, C, Nq, D, dl, false, &k);
    return (int)unit_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fm, fw,
                             fs, qmask, vmask, p, k, cu);
}

// K10 backward. dw: host array of 12 device pointers to the weight-gradient
// outputs, in p's order. ws: vml_content_rows_workspace_bytes(..., 1, 0)
// bytes.
int vml_content_unit_bwd_f32(void* stream, int B, int N, int C, int Nq, int D, int dl,
                             const float* fc, const float* fm, const float* fw, const float* fs,
                             const float* qmask, const float* vmask, const float* const* p,
                             const float* dcu, void* ws, float* dfc, float* dfm, float* dfw,
                             float* dfs, float* const* dw) {
    return unit_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fm, fw, fs,
                         qmask, vmask, p, dcu, static_cast<unsigned char*>(ws), dfc, dfm, dfw,
                         dfs, dw);
}

// K10-bf16 forward: K10 on bf16 activations, the matrices bf16 and the
// biases fp32 in p, the masks fp32. ws: vml_content_rows_workspace_bytes(...,
// 0, 1) bytes.
int vml_content_unit_fwd_bf16(void* stream, int B, int N, int C, int Nq, int D, int dl,
                              const bf16* fc, const bf16* fm, const bf16* fw, const bf16* fs,
                              const float* qmask, const float* vmask, const void* const* p,
                              void* ws, bf16* cu) {
    Workspace<bf16> k;
    carve(static_cast<unsigned char*>(ws), B, N, C, Nq, D, dl, false, &k);
    return (int)unit_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fm, fw,
                             fs, qmask, vmask, p, k, cu);
}

// K10-bf16 backward: bf16 dcu and input gradients, each rounded once; the 12
// weight gradients fp32 (dw). ws: vml_content_rows_workspace_bytes(..., 1, 1)
// bytes.
int vml_content_unit_bwd_bf16(void* stream, int B, int N, int C, int Nq, int D, int dl,
                              const bf16* fc, const bf16* fm, const bf16* fw, const bf16* fs,
                              const float* qmask, const float* vmask, const void* const* p,
                              const bf16* dcu, void* ws, bf16* dfc, bf16* dfm, bf16* dfw,
                              bf16* dfs, float* const* dw) {
    return unit_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, D, dl, fc, fm, fw, fs,
                         qmask, vmask, p, dcu, static_cast<unsigned char*>(ws), dfc, dfm, dfw,
                         dfs, dw);
}

}  // extern "C"
