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
// Design: a thread-block cluster of 8 CTAs runs one (batch block of RB
// rows, direction). CTA r owns hidden units [r*H/8, (r+1)*H/8) and keeps
// their 4 gate rows of W_hh (129 KB at H=256) in its shared memory for the
// whole layer, k-major and padded against bank conflicts; W_hh is read from
// device memory once per launch. One CTA fits an SM, and a cluster needs 8
// SMs of one GPC, so the card holds about 15 clusters at once: RB is the
// smallest multiple of 16 rows whose clusters, two directions each, all fit
// at once (`cudaOccupancyMaxActiveClusters`), up to the 96 rows whose h fits
// beside W_hh, so B=16 and B=64 run 16 rows per cluster and B=512 runs 80
// rows in one wave instead of four. Each thread owns one unit and RB*U/256
// rows and computes all four gates of them in registers (no gate buffer),
// updates c and h (registers), and stores the new h into every CTA's copy
// of h through distributed shared memory. Where two copies of h fit (RB <=
// 48 at H=256) h is double-buffered and one cluster barrier per step orders
// it; else it is single-buffered and a second barrier separates the step's
// reads from its writes. Gates are fp32. The layer-2 input
// projections, forward and backward, are one launch of the hand-written GEMM
// of gemm.cuh (`gemm_nt2`, the two weights as two problems of one A).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per (batch block, direction)
constexpr int kThreads = 256;
constexpr int kRowStep = 16;       // batch rows per cluster: a multiple of this
constexpr int kMaxRows = 96;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

size_t wslice_bytes(int H) {        // ws (H, R + 1), R = 4H / kCluster gate rows
    return sizeof(float) * (size_t)H * (4 * (size_t)H / kCluster + 1);
}

// Whether two copies of h (RB, H) fit beside the W_hh slice.
bool double_buffered(int H, int RB) {
    return wslice_bytes(H) + 2 * sizeof(float) * (size_t)RB * H <= kMaxSmem;
}

// Bytes of one CTA's shared memory: ws, and hbuf (nbuf, RB, H).
size_t layer_smem_bytes(int H, int RB) {
    return wslice_bytes(H) + (double_buffered(H, RB) ? 2 : 1) * sizeof(float) * (size_t)RB * H;
}

// The most rows per cluster: one copy of h beside W_hh, at most kMaxRows.
int max_rows(int H) {
    int rb = kMaxRows;
    while (rb > kRowStep && layer_smem_bytes(H, rb) > kMaxSmem) rb -= kRowStep;
    return rb;
}

// Rows of one thread, rounded up to the kernel's template choices.
int rows_per_thread(int H, int RB) {
    const int U = H / kCluster;
    const int G = kThreads / U;                  // row groups
    const int r = (RB + G - 1) / G;
    return r <= 2 ? (r <= 1 ? 1 : 2) : r <= 4 ? 4 : r <= 6 ? 6 : r <= 8 ? 8 : r <= 10 ? 10 : 12;
}

// One layer: xp{f,b} (B, S, 4H) input projections (b_ih included), mask
// (B, S), w_hh{f,b} (4H, H), b_hh{f,b} (4H,) -> out (B, S, 2H), forward
// hidden states in [0, H) and backward ones in [H, 2H).
// grid (kCluster, ceil(B / RB), 2 directions); H % 32 == 0, H <= 256.
// Thread tid owns unit u = tid % U of this CTA and rows g + G * i (g = tid /
// U, G = 256 / U, i < RPT) of the batch block. nbuf: copies of h (1 or 2).
template <int RPT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_layer_kernel(int B, int S, int H, int RB, int nbuf, const float* __restrict__ xpf,
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
    const bool single = nbuf == 1;
    float* ws = smem;                              // (H, R + 1)
    float* hbuf = ws + (size_t)H * ldw;            // (nbuf, RB, H)
    const int dir = blockIdx.z;
    const int b0 = blockIdx.y * RB;
    const float* xp = dir ? xpb : xpf;
    const float* whh = dir ? whhb : whhf;
    const float* bhh = dir ? bhhb : bhhf;
    const int tid = threadIdx.x;
    const int G = kThreads / U;
    const int u = tid % U;
    const int grp = tid / U;
    const bool active = grp < G;
    const int j = rank * U + u;       // this thread's hidden unit

    for (int e = tid; e < R * H; e += kThreads) {
        const int lr = e / H;
        const int k = e % H;
        ws[(size_t)k * ldw + lr] = whh[(size_t)((lr / U) * H + rank * U + lr % U) * H + k];
    }
    for (int e = tid; e < nbuf * RB * H; e += kThreads) hbuf[e] = 0.f;
    float bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = bhh[g * H + j];
    int row[RPT];                     // batch row of each of this thread's rows, or -1
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = grp + G * i;
        row[i] = (active && r < RB && b0 + r < B) ? r : -1;
    }
    float c[RPT], hp[RPT];            // cell and hidden state of this thread's rows
#pragma unroll
    for (int i = 0; i < RPT; ++i) c[i] = hp[i] = 0.f;
    cluster.sync();                   // the cluster's CTAs have started and staged

    for (int t = 0; t < S; ++t) {
        const int tt = dir ? S - 1 - t : t;
        const float* hc = hbuf + (single ? 0 : (t & 1) * RB * H);
        float* hn = hbuf + (single ? 0 : ((t + 1) & 1) * RB * H);

        // This step's inputs, loaded while the gates are summed.
        float xg[4][RPT], m[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            m[i] = 0.f;
#pragma unroll
            for (int g = 0; g < 4; ++g) xg[g][i] = 0.f;
            if (row[i] < 0) continue;
            const size_t at = (size_t)(b0 + row[i]) * S + tt;
            m[i] = mask[at];
#pragma unroll
            for (int g = 0; g < 4; ++g) xg[g][i] = xp[at * (4 * H) + g * H + j];
        }

        float acc[4][RPT];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[g][i] = 0.f;
        if (active) {
            const float* hrow[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) hrow[i] = hc + min(grp + G * i, RB - 1) * H;
            for (int k = 0; k < H; k += 4) {
                float w[4][4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int g = 0; g < 4; ++g) w[g][q] = ws[(size_t)(k + q) * ldw + g * U + u];
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    const float4 h4 = *reinterpret_cast<const float4*>(hrow[i] + k);
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        float a = acc[g][i];
                        a = fmaf(h4.x, w[g][0], a);
                        a = fmaf(h4.y, w[g][1], a);
                        a = fmaf(h4.z, w[g][2], a);
                        a = fmaf(h4.w, w[g][3], a);
                        acc[g][i] = a;
                    }
                }
            }
        }
        // Single buffer: every CTA has read h before any CTA overwrites it.
        if (single) cluster.sync();

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            if (row[i] < 0) continue;     // rows past B keep h = 0
            const float gi = vml::sigmoidf_(acc[0][i] + xg[0][i] + bias[0]);
            const float gf = vml::sigmoidf_(acc[1][i] + xg[1][i] + bias[1]);
            const float gg = tanhf(acc[2][i] + xg[2][i] + bias[2]);
            const float go = vml::sigmoidf_(acc[3][i] + xg[3][i] + bias[3]);
            const float c_new = gf * c[i] + gi * gg;
            const float h_new = go * tanhf(c_new);
            const float h = m[i] * h_new + (1.f - m[i]) * hp[i];
            c[i] = m[i] * c_new + (1.f - m[i]) * c[i];
            hp[i] = h;
            out[((size_t)(b0 + row[i]) * S + tt) * (2 * H) + dir * H + j] = h * m[i];
#pragma unroll
            for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(hn, r)[row[i] * H + j] = h;
        }
        // Orders this step's h stores before the next step's reads (and, when
        // double-buffered, the next step's stores after this step's reads).
        cluster.sync();
    }
}

using LayerKernel = void (*)(int, int, int, int, int, const float*, const float*,
                             const float*, const float*, const float*, const float*,
                             const float*, float*);

LayerKernel layer_kernel(int H, int RB) {
    switch (rows_per_thread(H, RB)) {
        case 1: return lstm_layer_kernel<1>;
        case 2: return lstm_layer_kernel<2>;
        case 4: return lstm_layer_kernel<4>;
        case 6: return lstm_layer_kernel<6>;
        case 8: return lstm_layer_kernel<8>;
        case 10: return lstm_layer_kernel<10>;
        default: return lstm_layer_kernel<12>;
    }
}

// Clusters of the layer kernel at RB rows that the card holds at once.
// Answers are kept per (device, H / 32, RB / 16): a host-side query of this
// file's own kernels, so this library is the only one that reads them.
int g_active[16][9][kMaxRows / kRowStep + 1];

cudaError_t max_active_clusters(int H, int RB, int* n) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int* cached = dev < 16 ? &g_active[dev][H / 32][RB / kRowStep] : nullptr;
    if (cached && *cached > 0) {
        *n = *cached;
        return cudaSuccess;
    }
    const LayerKernel fn = layer_kernel(H, RB);
    const size_t smem = layer_smem_bytes(H, RB);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 2);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n, (const void*)fn, &cfg);
    if (err == cudaSuccess && cached) *cached = *n;
    return err;
}

struct Plan {
    int rows, clusters, max_active;
};

// The smallest RB (a multiple of kRowStep) whose 2 * ceil(B / RB) clusters
// the card holds at once; max_rows(H) when none does. The chosen RB's kernel
// has its shared-memory limit raised: max_active_clusters did so when it
// first asked about that RB in this process.
cudaError_t plan_for(int B, int H, Plan* plan) {
    for (int rb = kRowStep; rb <= max_rows(H); rb += kRowStep) {
        int n = 0;
        cudaError_t err = max_active_clusters(H, rb, &n);
        if (err != cudaSuccess) return err;
        *plan = {rb, 2 * ((B + rb - 1) / rb), n};
        if (plan->clusters <= n) break;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// The layer kernel's plan at batch B: rows per cluster, clusters (both
// directions), clusters the card holds at once at that size, and the shared
// memory of one CTA, for the wrapper's admission check and its Python mirror
// (ops/lstm_cuda.py::lstm_plan). Returns a CUDA error, 0 if none.
int vml_lstm_plan(int B, int H, int* rows, int* clusters, int* max_active, size_t* smem) {
    Plan plan{};
    cudaError_t err = plan_for(B, H, &plan);
    *rows = plan.rows;
    *clusters = plan.clusters;
    *max_active = plan.max_active;
    *smem = layer_smem_bytes(H, plan.rows);
    return (int)err;
}

// Clusters of the layer kernel at `rows` rows per cluster that the card
// holds at once (*n). Returns a CUDA error, 0 if none.
int vml_lstm_max_active_clusters(int H, int rows, int* n) {
    return (int)max_active_clusters(H, rows, n);
}

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
    Plan plan{};
    cudaError_t err = plan_for(B, H, &plan);
    if (err != cudaSuccess) return (int)err;
    const int RB = plan.rows;
    const LayerKernel fn = layer_kernel(H, RB);
    const size_t smem = layer_smem_bytes(H, RB);
    const dim3 grid(kCluster, (B + RB - 1) / RB, 2);

    const int nbuf = double_buffered(H, RB) ? 2 : 1;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp1f, xp1b, mask, whh1f, whh1b, bhh1f,
                                     bhh1b, h1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    vml::Epilogue epf, epb;
    epf.bias = bih2f;
    epb.bias = bih2b;
    vml::gemm_nt2(st, B * S, 4 * H, 2 * H, h1, 2 * H, wih2f, wih2b, 2 * H, xp2f, xp2b, 4 * H,
                  epf, epb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp2f, xp2b, mask, whh2f, whh2b, bhh2f,
                                     bhh2b, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
