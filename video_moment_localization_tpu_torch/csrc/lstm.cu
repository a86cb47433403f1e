// K5: the fused 2-layer bidirectional masked LSTM of the serving path.
//
// Replaces ops/lstm_pallas.py::bilstm_fused (the Pallas `_kernel`) of the
// JAX package: the recurrence of both layers and both directions, and the
// layer-2 input projection that the TPU kernel computes in its body. The
// layer-1 input projection x @ W_ih^T + b_ih stays outside, as it does there
// (ops/lstm_cuda.py computes it).
//
// Semantics (models/lstm.py of either package): torch gate order i, f, g, o;
// a carry advances only where the step is valid and the output at a padded
// step is 0; the backward direction walks time S-1 .. 0, so its zero carry
// stays zero through the right padding.
//
// What bounds it on the H100: the recurrence is sequential in time, so each
// step is a small (rows x H) @ (H x 4H) product that must finish before the
// next one starts; at serving batch the steps' latency bounds it, not its
// 54.5 MFLOP per element. One direction's W_hh is (4H, H) = 1 MiB in fp32,
// over the 227 KB of shared memory of one block: a single block would have
// to stream it from L2 at every step.
//
// Design: a thread-block cluster of 8 CTAs runs one (batch block of kBB
// rows, direction). CTA r owns hidden units [r*H/8, (r+1)*H/8) and keeps
// their 4 gate rows of W_hh (128 KB at H=256) in its shared memory for the
// whole layer, k-major and padded against bank conflicts; W_hh is read from
// device memory once per launch. Each step a CTA computes its gate
// pre-activations from its local copy of h, updates c (registers) and h for
// its units, and stores the new h into every CTA's next-step buffer through
// distributed shared memory; one cluster barrier per step orders the double
// buffer. Gates are fp32. The layer-2 input projection is the hand-written
// GEMM of gemm.cuh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per (batch block, direction)
constexpr int kBB = 16;        // batch rows per cluster
constexpr int kThreads = 256;
constexpr int kRowsPerItem = 8;   // batch rows of one gate work item

// Shared memory of one CTA: ws (H, R + 1), hbuf (2, kBB, H), gates (R, kBB),
// with R = 4H / kCluster gate rows.
size_t layer_smem_bytes(int H) {
    const size_t R = 4 * (size_t)H / kCluster;
    return sizeof(float) * ((size_t)H * (R + 1) + 2 * (size_t)kBB * H + R * kBB);
}

// One layer: xp{f,b} (B, S, 4H) input projections (b_ih included), mask
// (B, S), w_hh{f,b} (4H, H), b_hh{f,b} (4H,) -> out (B, S, 2H), forward
// hidden states in [0, H) and backward ones in [H, 2H).
// grid (kCluster, ceil(B / kBB), 2 directions); H % 32 == 0, H <= 256.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lstm_layer_kernel(int B, int S, int H, const float* __restrict__ xpf,
                  const float* __restrict__ xpb, const float* __restrict__ mask,
                  const float* __restrict__ whhf, const float* __restrict__ whhb,
                  const float* __restrict__ bhhf, const float* __restrict__ bhhb,
                  float* __restrict__ out) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) float smem[];
    const int rank = (int)cluster.block_rank();
    const int U = H / kCluster;       // hidden units of this CTA
    const int R = 4 * U;              // local row g*U + u = W_hh row g*H + rank*U + u
    const int ldw = R + 1;
    float* ws = smem;                              // (H, R + 1)
    float* hbuf = ws + (size_t)H * ldw;            // (2, kBB, H)
    float* gates = hbuf + 2 * kBB * H;             // (R, kBB)
    const int dir = blockIdx.z;
    const int b0 = blockIdx.y * kBB;
    const float* xp = dir ? xpb : xpf;
    const float* whh = dir ? whhb : whhf;
    const float* bhh = dir ? bhhb : bhhf;
    const int tid = threadIdx.x;

    for (int e = tid; e < R * H; e += kThreads) {
        const int lr = e / H;
        const int k = e % H;
        ws[(size_t)k * ldw + lr] = whh[(size_t)((lr / U) * H + rank * U + lr % U) * H + k];
    }
    for (int e = tid; e < kBB * H; e += kThreads) hbuf[e] = 0.f;
    float c[2] = {0.f, 0.f};          // cells of this thread's (unit, row) pairs
    cluster.sync();                   // the cluster's CTAs have started and staged

    for (int t = 0; t < S; ++t) {
        const int tt = dir ? S - 1 - t : t;
        const float* hc = hbuf + (t & 1) * kBB * H;
        float* hn = hbuf + ((t + 1) & 1) * kBB * H;

        for (int item = tid; item < R * (kBB / kRowsPerItem); item += kThreads) {
            const int lr = item % R;
            const int rb = (item / R) * kRowsPerItem;
            const float* hrow = hc + rb * H;
            float acc[kRowsPerItem];
#pragma unroll
            for (int b = 0; b < kRowsPerItem; ++b) acc[b] = 0.f;
            for (int k = 0; k < H; k += 4) {
                const float w0 = ws[(size_t)(k + 0) * ldw + lr];
                const float w1 = ws[(size_t)(k + 1) * ldw + lr];
                const float w2 = ws[(size_t)(k + 2) * ldw + lr];
                const float w3 = ws[(size_t)(k + 3) * ldw + lr];
#pragma unroll
                for (int b = 0; b < kRowsPerItem; ++b) {
                    const float4 h4 = *reinterpret_cast<const float4*>(hrow + b * H + k);
                    float a = acc[b];
                    a = fmaf(h4.x, w0, a);
                    a = fmaf(h4.y, w1, a);
                    a = fmaf(h4.z, w2, a);
                    a = fmaf(h4.w, w3, a);
                    acc[b] = a;
                }
            }
#pragma unroll
            for (int b = 0; b < kRowsPerItem; ++b) gates[lr * kBB + rb + b] = acc[b];
        }
        __syncthreads();

#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = tid + q * kThreads;
            if (p >= U * kBB) break;
            const int u = p % U;
            const int b = p / U;
            const int j = rank * U + u;
            const int row = b0 + b;
            float h = 0.f;            // rows past B stay 0
            if (row < B) {
                const float m = mask[(size_t)row * S + tt];
                const float* x = xp + ((size_t)row * S + tt) * (4 * H);
                const float gi = vml::sigmoidf_(gates[(0 * U + u) * kBB + b] + x[j] + bhh[j]);
                const float gf = vml::sigmoidf_(gates[(1 * U + u) * kBB + b] + x[H + j] + bhh[H + j]);
                const float gg = tanhf(gates[(2 * U + u) * kBB + b] + x[2 * H + j] + bhh[2 * H + j]);
                const float go = vml::sigmoidf_(gates[(3 * U + u) * kBB + b] + x[3 * H + j] + bhh[3 * H + j]);
                const float c_new = gf * c[q] + gi * gg;
                const float h_new = go * tanhf(c_new);
                h = m * h_new + (1.f - m) * hc[b * H + j];
                c[q] = m * c_new + (1.f - m) * c[q];
                out[((size_t)row * S + tt) * (2 * H) + dir * H + j] = h * m;
            }
#pragma unroll
            for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(hn, r)[b * H + j] = h;
        }
        // Orders this step's h stores before the next step's reads, and the
        // next step's stores after every CTA's reads of this step's buffer.
        cluster.sync();
    }
}

}  // namespace

extern "C" {

// Shared memory of one recurrence CTA, for the wrapper's admission check.
size_t vml_lstm_layer_smem_bytes(int H) { return layer_smem_bytes(H); }

// Both layers: xp1{f,b} (B, S, 4H) layer-1 input projections with b_ih,
// mask (B, S) in {0, 1}, per-direction weights in torch's layout. Scratch
// h1 (B, S, 2H) and xp2{f,b} (B, S, 4H); result out (B, S, 2H). Returns the
// first CUDA error of the launches, 0 if none.
int vml_bilstm2_f32(void* stream, int B, int S, int H,
                    const float* xp1f, const float* xp1b, const float* mask,
                    const float* whh1f, const float* whh1b,
                    const float* bhh1f, const float* bhh1b,
                    const float* wih2f, const float* wih2b,
                    const float* bih2f, const float* bih2b,
                    const float* whh2f, const float* whh2b,
                    const float* bhh2f, const float* bhh2b,
                    float* h1, float* xp2f, float* xp2b, float* out) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = layer_smem_bytes(H);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(kCluster, (B + kBB - 1) / kBB, 2);

    lstm_layer_kernel<<<grid, kThreads, smem, st>>>(B, S, H, xp1f, xp1b, mask, whh1f,
                                                     whh1b, bhh1f, bhh1b, h1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    vml::linear(st, B * S, 4 * H, 2 * H, h1, wih2f, bih2f, xp2f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    vml::linear(st, B * S, 4 * H, 2 * H, h1, wih2b, bih2b, xp2b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    lstm_layer_kernel<<<grid, kThreads, smem, st>>>(B, S, H, xp2f, xp2b, mask, whh2f,
                                                     whh2b, bhh2f, bhh2b, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
