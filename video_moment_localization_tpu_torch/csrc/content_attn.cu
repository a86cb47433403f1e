// The content-attention pair of content_attn.cuh on its own, for the card
// tests and the timing phase of chip_smoke.py (ops/content_attn_cuda.py):
// the forward and the backward (fp32 and bf16) between the content unit's
// projections, and
// the tile plan that the Python mirror in ops/content_attn_cuda.py is held
// against. K4, K2, K3, K7, K9 and K10 run the same device code inside their
// own entry points.
#include <cuda_runtime.h>

#include "content_attn.cuh"

extern "C" {

// fcc (B*N*C, dl) from h, q (B*N*C, dl), khat, fwh (B*Nq, dl), fsh (B, dl),
// qmask (B*Nq) and vmask (B*N). Returns the launch's CUDA error, 0 if none.
int vml_content_attn_fwd_f32(void* stream, int B, int N, int C, int Nq, int dl, const float* h,
                             const float* q, const float* khat, const float* fwh,
                             const float* fsh, const float* qmask, const float* vmask,
                             float* fcc) {
    return (int)vml::content_attn_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, dl, h,
                                          q, khat, fwh, fsh, qmask, vmask, fcc);
}

// The forward's bf16 variant: h, q, khat, fwh and fcc bf16; fsh and the
// masks fp32.
int vml_content_attn_fwd_bf16(void* stream, int B, int N, int C, int Nq, int dl,
                              const vml::bf16* h, const vml::bf16* q, const vml::bf16* khat,
                              const vml::bf16* fwh, const float* fsh, const float* qmask,
                              const float* vmask, vml::bf16* fcc) {
    return (int)vml::content_attn_forward(static_cast<cudaStream_t>(stream), B, N, C, Nq, dl, h,
                                          q, khat, fwh, fsh, qmask, vmask, fcc);
}

// The backward from dfcc: dh, dq (B*N*C, dl), dfwh, dkhat (B*Nq, dl) and
// dfsh (B, dl), through `part` (vml_content_attn_partial_floats floats).
int vml_content_attn_bwd_f32(void* stream, int B, int N, int C, int Nq, int dl, const float* h,
                             const float* q, const float* khat, const float* fwh,
                             const float* fsh, const float* qmask, const float* vmask,
                             const float* dfcc, float* part, float* dh, float* dq, float* dfwh,
                             float* dkhat, float* dfsh) {
    return (int)vml::content_attn_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, dl,
                                           h, q, khat, fwh, fsh, qmask, vmask, dfcc, dh, dq,
                                           part, dfwh, dkhat, dfsh);
}

// The backward's bf16 variant: h, q, khat, fwh, dfcc bf16, fsh and the
// masks fp32 in; dh and dfwh fp32, dq, dkhat and dfsh bf16 out, through
// `part` (vml_content_attn_partial_floats(..., 1) floats).
int vml_content_attn_bwd_bf16(void* stream, int B, int N, int C, int Nq, int dl,
                              const vml::bf16* h, const vml::bf16* q, const vml::bf16* khat,
                              const vml::bf16* fwh, const float* fsh, const float* qmask,
                              const float* vmask, const vml::bf16* dfcc, float* part, float* dh,
                              vml::bf16* dq, float* dfwh, vml::bf16* dkhat, vml::bf16* dfsh) {
    return (int)vml::content_attn_backward(static_cast<cudaStream_t>(stream), B, N, C, Nq, dl,
                                           h, q, khat, fwh, fsh, qmask, vmask, dfcc, dh, dq,
                                           part, dfwh, dkhat, dfsh);
}

// The tile plan (bf16 0: fp32 rows, and the bf16 forward, which stages
// fp32 rows; 1: the bf16 backward's layout): out = (pairs per pass, passes
// per block, blocks per element), *smem = a block's dynamic shared memory
// (0: shape not taken).
void vml_content_attn_plan(int B, int N, int C, int Nq, int dl, int backward, int bf16,
                           int* out, size_t* smem) {
    const vml::ContentAttnPlan p =
        vml::content_attn_plan(B, N, C, Nq, dl, backward != 0, bf16 != 0);
    out[0] = p.pp;
    out[1] = p.passes;
    out[2] = p.tiles;
    *smem = p.smem;
}

size_t vml_content_attn_partial_floats(int B, int N, int C, int Nq, int dl, int bf16) {
    return vml::content_attn_partial_floats(B, N, C, Nq, dl, bf16 != 0);
}

}  // extern "C"
