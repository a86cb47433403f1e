// K4: the fused SMI stack of the serving path (proposal pooling, the SMI
// layers and the four sigmoid heads).
//
// Replaces ops/smin_pallas.py::smin_stack_fused (the Pallas `_kernel`, whose
// layer body is `smi_layer_rows`) of the JAX package. Inputs are the
// backbone outputs f (B, T, D), fw (B, Nq, D), fs (B, D) and the masks;
// outputs pm (B, N) in np.triu_indices pair order and ps/pe/pa (B, L), fp32.
//
// What bounds it on the H100: about 1.01 GFLOP of fp32 work per element at
// the Charades shapes, most of it in the c_hat / c_out projections over the
// N*C = 544 clip rows and the moment convolutions (one product over [x1 |
// x2]) over the N = 136 pairs, which run as 3xTF32 on the tensor cores (165
// TFLOP/s of fp32-accurate products, gemm.cuh); the operations bound it, not
// the bytes (about 0.2 MB in and 0.6 KB out per element).
//
// Design: the TPU kernel keeps about 1.1 MB of fp32 state per element in
// VMEM; a block has 227 KB of shared memory, so the megakernel is split into
// a few kernels that this entry point sequences on one stream, with the
// intermediates in a device workspace that the wrapper allocates:
//   pool_kernel (proposal.cuh)     fc (B, N, C, D) clip means masked by
//                                  the pair validity of lmask (prefix-sum
//                                  differences of f's tile in shared
//                                  memory), fm = mean over C, fb = window
//                                  means
//   layer_forward (smin_units.cuh) one SMI layer, per layer
//   heads_kernel                   the four sigmoid heads, one warp per output
// Rows are n-major: row (b, n, c) of fc/cu is ((b * N) + n) * C + c, the
// layout of the plain version in ops/smin_cuda.py.
//
// The bf16 variant (`vml_smin_stack_bf16`; the JAX kernel at bf16, its
// production dtype): the same kernels at bf16 activations with fp32
// arithmetic inside and one rounding per stored value, products on
// gemm.cuh's bf16 path (bf16 operands, fp32 sums; 989 TFLOP/s of dense
// bf16 bound them), f_s_hat, the biases and the heads fp32, pm and pb fp32.
// Its weights come cast to bf16 once per model (models/smin.py
// `cast_weights`); its plain version is models/smin.py::smin_stack_bf16.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "smin_units.cuh"

namespace {

// One warp per output: pm (B*N) from fm, then ps, pe, pa (3, B*L) from fb.
// T: the element type of fm and fb; the heads' weights and sums are fp32.
template <typename T>
__global__ void heads_kernel(int BN, int BL, int D, const T* __restrict__ fm,
                             const T* __restrict__ fb,
                             const float* __restrict__ vmask,
                             const float* __restrict__ lmask,
                             const float* w_pm, const float* b_pm,
                             const float* w_ps, const float* b_ps,
                             const float* w_pe, const float* b_pe,
                             const float* w_pa, const float* b_pa,
                             float* __restrict__ pm, float* __restrict__ pb) {
    const int lane = threadIdx.x % 32;
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    if (r >= BN + 3 * BL) return;
    const T* x;
    const float* w;
    float bias, mask;
    float* dst;
    if (r < BN) {
        x = fm + (size_t)r * D;
        w = w_pm;
        bias = b_pm[0];
        mask = vmask[r];
        dst = pm + r;
    } else {
        const int head = (r - BN) / BL;
        const int q = (r - BN) % BL;
        x = fb + (size_t)q * D;
        w = head == 0 ? w_ps : (head == 1 ? w_pe : w_pa);
        bias = (head == 0 ? b_ps : (head == 1 ? b_pe : b_pa))[0];
        mask = lmask[q];
        dst = pb + (size_t)head * BL + q;
    }
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += vml::to_f(x[d]) * w[d];
    s = vml::warp_sum(s);
    if (lane == 0) *dst = vml::sigmoidf_(s + bias) * mask;
}

// The workspace: fc, cu, fm, mu, fb, bu and the layer's scratch, in the
// element type E (fp32, or bf16 for the bf16 variant).
template <typename E>
struct Workspace {
    E *fc, *cu, *fm, *mu, *fb, *bu;
    vml::LayerScratchT<E> s;
};

// Carves the workspace; returns its size in bytes (ws may be null).
template <typename E>
size_t carve(unsigned char* ws, int B, int L, int C, int Nq, int D, int dl, Workspace<E>* w) {
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t NC = N * C;
    const size_t e = sizeof(E);
    const size_t sizes[] = {
        e * B * NC * D, e * B * NC * D,         // fc, cu
        e * B * N * D, e * B * N * D,           // fm, mu
        e * B * L * D, e * B * L * D,           // fb, bu
    };
    void* slots[6];
    const size_t off = vml::carve_bytes(ws, 0, sizes, slots, 6);
    E** dst[6] = {&w->fc, &w->cu, &w->fm, &w->mu, &w->fb, &w->bu};
    for (int k = 0; k < 6; ++k) *dst[k] = static_cast<E*>(slots[k]);
    return vml::carve_layer_scratch(ws, off, B, L, C, Nq, D, dl, &w->s);
}

// The stack in the element type E of f, fw, fs and the layers' matrices
// (P: the pointer type of layer_w's entries); the masks, biases, heads and
// outputs fp32.
template <typename E, typename P>
int stack_forward(void* stream, int B, int T, int L, int C, int Nq, int D, int dl, int n_layers,
                  const E* f, const E* fw, const E* fs, const float* qmask, const float* lmask,
                  const float* vmask, const P* const* layer_w, const float* const* head_w,
                  unsigned char* ws, float* pm, float* pb) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int N = L * (L + 1) / 2;
    Workspace<E> w;
    carve(ws, B, L, C, Nq, D, dl, &w);
    cudaError_t err;

    err = vml::pool_forward<false, E>(st, B, T, L, C, D, f, lmask, w.fc, w.fm, w.fb);
    if (err != cudaSuccess) return (int)err;

    for (int layer = 0; layer < n_layers; ++layer) {
        err = vml::layer_forward(st, B, L, C, Nq, D, dl, w.fc, w.fm, w.fb, fw, fs, qmask, lmask,
                                 vmask, layer_w + (size_t)layer * vml::kWeightsPerLayer, w.s,
                                 w.cu, w.mu, w.bu, layer == n_layers - 1);
        if (err != cudaSuccess) return (int)err;
        E* t;
        t = w.fc; w.fc = w.cu; w.cu = t;
        t = w.fm; w.fm = w.mu; w.mu = t;
        t = w.fb; w.fb = w.bu; w.bu = t;
    }

    const int outputs = B * N + 3 * B * L;
    heads_kernel<E><<<(outputs * 32 + 255) / 256, 256, 0, st>>>(
        B * N, B * L, D, w.fm, w.fb, vmask, lmask, head_w[0], head_w[1], head_w[2],
        head_w[3], head_w[4], head_w[5], head_w[6], head_w[7], pm, pb);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace of vml_smin_stack_f32 (bf16 0) or
// vml_smin_stack_bf16 (bf16 1).
size_t vml_smin_workspace_bytes(int B, int L, int C, int Nq, int D, int dl, int bf16) {
    if (bf16) {
        Workspace<vml::bf16> w;
        return carve(nullptr, B, L, C, Nq, D, dl, &w);
    }
    Workspace<float> w;
    return carve(nullptr, B, L, C, Nq, D, dl, &w);
}

// Largest dynamic shared memory of the entry's kernels, for the wrapper's
// admission check against the 227 KB a block may have.
size_t vml_smin_smem_bytes(int L, int C, int Nq, int D, int dl) {
    (void)D;
    return vml::layer_forward_smem_bytes(L, C, Nq, dl);
}

// layer_w: host array of n_layers * 20 device pointers, per layer in the
// order of vml::layer_forward. head_w: host array of 8 device pointers:
// pm.w, pm.b, ps.w, ps.b, pe.w, pe.b, pa.w, pa.b. Outputs pm (B, N) and pb
// (3, B, L) = ps, pe, pa. ws: vml_smin_workspace_bytes(..., 0) bytes.
// Returns the first CUDA error of the launches, 0 if none.
int vml_smin_stack_f32(void* stream, int B, int T, int L, int C, int Nq, int D, int dl,
                       int n_layers, const float* f, const float* fw, const float* fs,
                       const float* qmask, const float* lmask, const float* vmask,
                       const float* const* layer_w, const float* const* head_w,
                       unsigned char* ws, float* pm, float* pb) {
    return stack_forward(stream, B, T, L, C, Nq, D, dl, n_layers, f, fw, fs, qmask, lmask, vmask,
                         layer_w, head_w, ws, pm, pb);
}

// K4's bf16 variant: f (B, T, D), fw (B, Nq, D), fs (B, D) bf16, the masks
// fp32; layer_w as the fp32 entry's, the weights bf16 and the biases fp32;
// head_w the 8 fp32 head pointers. Outputs pm (B, N) and pb (3, B, L) fp32,
// as the fp32 entry. ws: vml_smin_workspace_bytes(..., 1) bytes. Returns the
// first CUDA error of the launches, 0 if none.
int vml_smin_stack_bf16(void* stream, int B, int T, int L, int C, int Nq, int D, int dl,
                        int n_layers, const vml::bf16* f, const vml::bf16* fw,
                        const vml::bf16* fs, const float* qmask, const float* lmask,
                        const float* vmask, const void* const* layer_w,
                        const float* const* head_w, unsigned char* ws, float* pm, float* pb) {
    return stack_forward(stream, B, T, L, C, Nq, D, dl, n_layers, f, fw, fs, qmask, lmask, vmask,
                         layer_w, head_w, ws, pm, pb);
}

}  // extern "C"
