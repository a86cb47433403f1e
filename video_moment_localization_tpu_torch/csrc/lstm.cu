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
//
// The bf16 variant (`vml_bilstm2_bf16`; the JAX kernel at bf16) has its own
// layer kernel, `lstm_layer_mma_kernel`: xp, W_hh, the copies of h in shared
// memory (the recurrent product's operand) and the outputs are bf16; each
// product of two bf16 values is exact in fp32 and the sums, gates, c and the
// carried h are fp32 (so are b_hh and the mask). Its recurrent product runs
// on the tensor cores: bf16 mma.sync m16n8k16 with fp32 accumulators, k in
// order 0 .. H-1 in steps of 16, so a launch is bit for bit repeatable. One
// direction's W_hh is 512 KiB, so a cluster of 4 CTAs holds it: CTA r keeps
// the 4 gate rows of units [r*H/4, (r+1)*H/4) (128 KiB at H=256) n-major
// with rows of H + 8 elements, which ldmatrix reads without bank conflicts,
// and so is h (RB, H + 8), double-buffered. 512 threads a CTA: a warp owns
// 8 units and m-tiles of 16 rows; the slice's rows are ordered gate by
// gate, so the n8
// tiles g = 0..3 of a warp's 8 units are the gates i, f, g, o and a lane's
// accumulators hold all four gates of two units in two rows: the gate math
// runs on the accumulators, with no gate buffer. A step then writes h (bf16)
// to its own copy, and copies its slice of columns to the cluster's three
// other CTAs in 16-byte stores through distributed shared memory; one
// cluster barrier a step (arrive.release, the next step's xp and mask loads
// and the output stores, wait.acquire) orders them. Fewer CTAs a cluster
// than fp32's 8 mean fewer remote stores and a cheaper barrier, and about
// twice the clusters fit the card at once: B=512 takes 32 rows a cluster in
// one wave. What bounds a step (a %globaltimer build, PERF.md §6): the gate
// math on the accumulators, then the product, then the barrier. The layer-2 projections take gemm.cuh's
// bf16 path (`gemm_nt2_bf16`, fp32 b_ih).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per (batch block, direction), fp32
constexpr int kClusterBf = 4;  // the same, bf16
constexpr int kThreads = 256;
constexpr int kThreadsBf = 512;   // the bf16 kernel's: 16 warps an SM
constexpr int kRowStep = 16;       // batch rows per cluster: a multiple of this
constexpr int kMaxRows = 96;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

// Shared-memory row stride of the fp32 W_hh slice: R = 4H / kCluster gate
// rows padded by one float.
__host__ __device__ inline size_t wslice_ld(int H) { return 4 * (size_t)H / kCluster + 1; }

size_t wslice_bytes(int H) { return sizeof(float) * H * wslice_ld(H); }   // ws (H, ld)

// Whether two copies of h (RB, H) fit beside the W_hh slice.
bool double_buffered(int H, int RB) {
    return wslice_bytes(H) + 2 * sizeof(float) * RB * H <= kMaxSmem;
}

// Bytes of one CTA's shared memory: ws, and hbuf (nbuf, RB, H).
size_t layer_smem_bytes(int H, int RB) {
    return wslice_bytes(H) + (double_buffered(H, RB) ? 2 : 1) * sizeof(float) * RB * H;
}

// The bf16 kernel's shared memory: the W_hh slice (4H / kClusterBf, H + 8)
// and h (2, RB, H + 8), bf16, rows of H + 8 elements.
size_t layer_smem_bytes_bf(int H, int RB) {
    return sizeof(vml::bf16) * (size_t)(H + 8) * (4 * H / kClusterBf + 2 * RB);
}

// The most rows per cluster (a multiple of kRowStep, at most kMaxRows) whose
// shared memory fits a block, at an element size (4 fp32, 2 bf16).
size_t smem_bytes(int H, int RB, int esize) {
    return esize == 2 ? layer_smem_bytes_bf(H, RB) : layer_smem_bytes(H, RB);
}
int max_rows(int H, int esize) {
    int rb = kMaxRows;
    while (rb > kRowStep && smem_bytes(H, rb, esize) > kMaxSmem) rb -= kRowStep;
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
// hidden states in [0, H) and backward ones in [H, 2H), all fp32.
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
    extern __shared__ __align__(16) unsigned char lstm_smem[];
    const int rank = (int)cluster.block_rank();
    const int U = H / kCluster;       // hidden units of this CTA
    const int R = 4 * U;              // local row g*U + u = W_hh row g*H + rank*U + u
    const int ldw = (int)wslice_ld(H);
    const bool single = nbuf == 1;
    float* ws = reinterpret_cast<float*>(lstm_smem);     // (H, ldw)
    float* hbuf = ws + (size_t)H * ldw;                   // (nbuf, RB, H)
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

using LayerKernel = void (*)(int, int, int, int, int, const float*, const float*, const float*,
                             const float*, const float*, const float*, const float*, float*);

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

// The bf16 layer (see the file's head): the same inputs and outputs as
// lstm_layer_kernel, xp, W_hh and out bf16. grid (kClusterBf, ceil(B / RB),
// 2 directions); H % 32 == 0, H <= 256; W_hh 16-byte aligned. U = H / 4
// units a CTA in NUG = U / 8 groups of 8; of its 16 warps, warp w < NUG *
// WPU (WPU = 16 / NUG warps a group) owns group w % NUG and the m-tiles w /
// NUG + WPU * i (i < MTW) of the RB / 16. Lane l holds rows l / 4 and l / 4 + 8 of each m-tile
// and units 2 (l % 4) and 2 (l % 4) + 1 of its group: accumulator
// acc[i][g][2 h + v] is gate g of row l / 4 + 8 h and unit 2 (l % 4) + v.
template <int MTW>
__global__ void __cluster_dims__(kClusterBf, 1, 1) __launch_bounds__(kThreadsBf, 1)
lstm_layer_mma_kernel(int B, int S, int H, int RB, const vml::bf16* __restrict__ xpf,
                      const vml::bf16* __restrict__ xpb, const float* __restrict__ mask,
                      const vml::bf16* __restrict__ whhf, const vml::bf16* __restrict__ whhb,
                      const float* __restrict__ bhhf, const float* __restrict__ bhhb,
                      vml::bf16* __restrict__ out) {
    using vml::bf16;
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char lstm_smem[];
    const int rank = (int)cluster.block_rank();
    const int U = H / kClusterBf;     // hidden units of this CTA
    const int ld = H + 8;             // row stride of ws and h, elements
    bf16* ws = reinterpret_cast<bf16*>(lstm_smem);   // (4U, ld): local row g*U + u
    bf16* hbuf = ws + (size_t)4 * U * ld;            // (2, RB, ld)
    const int dir = blockIdx.z;
    const int b0 = blockIdx.y * RB;
    const bf16* xp = dir ? xpb : xpf;
    const bf16* whh = dir ? whhb : whhf;
    const float* bhh = dir ? bhhb : bhhf;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int NUG = U / 8, WPU = kThreadsBf / 32 / NUG, MT = RB / 16;
    const bool mma_warp = warp < NUG * WPU;
    const int ug = warp % NUG, msub = warp / NUG;
    const int ul = ug * 8 + (lane % 4) * 2;   // this lane's first local unit
    const int j = rank * U + ul;              // its hidden unit (and j + 1)

    // W_hh's slice: local row g*U + u is row g*H + rank*U + u; 16-byte copies.
    const int kc = H / 8;
    for (int e = tid; e < 4 * U * kc; e += kThreadsBf) {
        const int lr = e / kc, k8 = e % kc;
        const size_t src = (size_t)((lr / U) * H + rank * U + lr % U) * H + 8 * k8;
        *reinterpret_cast<uint4*>(ws + (size_t)lr * ld + 8 * k8) =
            *reinterpret_cast<const uint4*>(whh + src);
    }
    for (int e = tid; e < 2 * RB * ld / 8; e += kThreadsBf)
        reinterpret_cast<uint4*>(hbuf)[e] = make_uint4(0u, 0u, 0u, 0u);
    float bias[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        bias[g][0] = bhh[g * H + j];
        bias[g][1] = bhh[g * H + j + 1];
    }
    // Local row of each of this lane's rows, and its batch row or -1.
    int lrow[MTW][2], brow[MTW][2];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int mt = msub + WPU * i;
            lrow[i][h] = mt * 16 + lane / 4 + 8 * h;
            brow[i][h] = (mma_warp && mt < MT && b0 + lrow[i][h] < B) ? b0 + lrow[i][h] : -1;
        }
    float c[MTW][2][2], hp[MTW][2][2];   // cell and carried h: [i][row h][unit v]
    unsigned xg[MTW][2][4];              // xp of [i][h][gate] for units j, j + 1
    float m[MTW][2];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            c[i][h][0] = c[i][h][1] = hp[i][h][0] = hp[i][h][1] = 0.f;
        }
    // The inputs of step t into xg and m (zero on rows past B).
    auto load_inputs = [&](int t) {
        const int tt = dir ? S - 1 - t : t;
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                m[i][h] = 0.f;
#pragma unroll
                for (int g = 0; g < 4; ++g) xg[i][h][g] = 0u;
                if (brow[i][h] < 0) continue;
                const size_t at = (size_t)brow[i][h] * S + tt;
                m[i][h] = mask[at];
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    xg[i][h][g] = *reinterpret_cast<const unsigned*>(xp + at * (4 * H) + g * H + j);
            }
    };
    load_inputs(0);
    // Distributed-shared-memory addresses of the other CTAs' h buffers.
    bf16* peer[kClusterBf - 1];
#pragma unroll
    for (int q = 0; q < kClusterBf - 1; ++q)
        peer[q] = cluster.map_shared_rank(hbuf, q < rank ? q : q + 1);
    cluster.sync();                   // the cluster's CTAs have started and staged

    for (int t = 0; t < S; ++t) {
        const int tt = dir ? S - 1 - t : t;
        const int cur = (t & 1) * RB * ld, nxt = ((t + 1) & 1) * RB * ld;
        const bf16* hc = hbuf + cur;
        bf16* hn = hbuf + nxt;

        float acc[MTW][4][4];
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
        if (mma_warp) {
            // ldmatrix row addresses: B's four 8 x 8 matrices are (gate 2p,
            // k0..7), (2p, k8..15), (2p + 1, k0..7), (2p + 1, k8..15); A's are
            // (rows 0..7, k0..7), (8..15, k0..7), (0..7, k8..15), (8..15, k8..15).
            const int mtx = lane / 8, r8 = lane % 8;
            const bf16* bp0 = ws + (size_t)((mtx / 2) * U + ug * 8 + r8) * ld + (mtx % 2) * 8;
            const bf16* bp1 = bp0 + (size_t)2 * U * ld;
            const bf16* ap = hc + (size_t)(msub * 16 + (mtx % 2) * 8 + r8) * ld + (mtx / 2) * 8;
#pragma unroll 2
            for (int k0 = 0; k0 < H; k0 += 16) {
                unsigned b01[4], b23[4];
                vml::ldmatrix_x4(b01, bp0 + k0);
                vml::ldmatrix_x4(b23, bp1 + k0);
#pragma unroll
                for (int i = 0; i < MTW; ++i) {
                    if (msub + WPU * i >= MT) continue;
                    unsigned a[4];
                    vml::ldmatrix_x4(a, ap + (size_t)WPU * i * 16 * ld + k0);
                    vml::mma_bf16(acc[i][0], a, b01[0], b01[1]);
                    vml::mma_bf16(acc[i][1], a, b01[2], b01[3]);
                    vml::mma_bf16(acc[i][2], a, b23[0], b23[1]);
                    vml::mma_bf16(acc[i][3], a, b23[2], b23[3]);
                }
            }
        }

        // The gates on the accumulators; h (bf16) into this CTA's copy.
        unsigned hout[MTW][2];
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                hout[i][h] = 0u;
                if (!mma_warp || msub + WPU * i >= MT) continue;
                float hv[2], ov[2];
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    float x[4];
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        const float2 f2 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&xg[i][h][g]));
                        x[g] = v ? f2.y : f2.x;
                    }
                    const float mk = m[i][h];
                    const float gi = vml::sigmoidf_(acc[i][0][2 * h + v] + x[0] + bias[0][v]);
                    const float gf = vml::sigmoidf_(acc[i][1][2 * h + v] + x[1] + bias[1][v]);
                    const float gg = tanhf(acc[i][2][2 * h + v] + x[2] + bias[2][v]);
                    const float go = vml::sigmoidf_(acc[i][3][2 * h + v] + x[3] + bias[3][v]);
                    const float c_new = gf * c[i][h][v] + gi * gg;
                    const float h_new = go * tanhf(c_new);
                    const float hh = mk * h_new + (1.f - mk) * hp[i][h][v];
                    c[i][h][v] = mk * c_new + (1.f - mk) * c[i][h][v];
                    hp[i][h][v] = hh;
                    hv[v] = hh;
                    ov[v] = hh * mk;
                }
                const __nv_bfloat162 hq = __floats2bfloat162_rn(hv[0], hv[1]);
                const __nv_bfloat162 oq = __floats2bfloat162_rn(ov[0], ov[1]);
                *reinterpret_cast<__nv_bfloat162*>(hn + (size_t)lrow[i][h] * ld + j) = hq;
                hout[i][h] = *reinterpret_cast<const unsigned*>(&oq);
            }
        __syncthreads();              // this CTA's columns of h are in its copy
        // ... and from there to the other CTAs' copies, 16 bytes a store.
        const int cpr = U / 8;        // 16-byte chunks of a row's columns
        for (int e = tid; e < RB * cpr; e += kThreadsBf) {
            const size_t off = (size_t)nxt + (size_t)(e / cpr) * ld + rank * U + 8 * (e % cpr);
            const uint4 v = *reinterpret_cast<const uint4*>(hbuf + off);
#pragma unroll
            for (int q = 0; q < kClusterBf - 1; ++q)
                *reinterpret_cast<uint4*>(peer[q] + off) = v;
        }
        // The barrier orders this step's h stores before the next step's
        // reads, and (two buffers) the next step's stores after this step's
        // reads. Between its arrive and its wait: the outputs, and the next
        // step's inputs.
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (brow[i][h] >= 0)
                    *reinterpret_cast<unsigned*>(out + ((size_t)brow[i][h] * S + tt) * (2 * H) +
                                                 dir * H + j) = hout[i][h];
        if (t + 1 < S) load_inputs(t + 1);
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
}

using MmaKernel = void (*)(int, int, int, int, const vml::bf16*, const vml::bf16*, const float*,
                           const vml::bf16*, const vml::bf16*, const float*, const float*,
                           vml::bf16*);

// M-tiles a warp walks at RB rows: ceil((RB / 16) / WPU).
int mma_tiles_per_warp(int H, int RB) {
    const int nug = H / kClusterBf / 8;
    const int wpu = kThreadsBf / 32 / nug;
    return (RB / kRowStep + wpu - 1) / wpu;
}

// At most 3 (RB = 96 at H <= 224, 80 at H = 256, two warps a unit group).
MmaKernel mma_kernel(int H, int RB) {
    switch (mma_tiles_per_warp(H, RB)) {
        case 1: return lstm_layer_mma_kernel<1>;
        case 2: return lstm_layer_mma_kernel<2>;
        default: return lstm_layer_mma_kernel<3>;
    }
}

// Clusters of the layer kernel at RB rows and element size esize that the
// card holds at once. Answers are kept per (device, element type, H / 32,
// RB / 16): a host-side query of this file's own kernels, so this library
// is the only one that reads them.
int g_active[16][2][9][kMaxRows / kRowStep + 1];

cudaError_t max_active_clusters(int H, int RB, int esize, int* n) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int* cached = dev < 16 ? &g_active[dev][esize == 2][H / 32][RB / kRowStep] : nullptr;
    if (cached && *cached > 0) {
        *n = *cached;
        return cudaSuccess;
    }
    const void* fn = esize == 2 ? (const void*)mma_kernel(H, RB) : (const void*)layer_kernel(H, RB);
    const int cluster = esize == 2 ? kClusterBf : kCluster;
    const size_t smem = smem_bytes(H, RB, esize);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 2);
    cfg.blockDim = dim3(esize == 2 ? kThreadsBf : kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
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
cudaError_t plan_for(int B, int H, int esize, Plan* plan) {
    for (int rb = kRowStep; rb <= max_rows(H, esize); rb += kRowStep) {
        int n = 0;
        cudaError_t err = max_active_clusters(H, rb, esize, &n);
        if (err != cudaSuccess) return err;
        *plan = {rb, 2 * ((B + rb - 1) / rb), n};
        if (plan->clusters <= n) break;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// The layer kernel's plan at batch B and element size esize (4 fp32, 2
// bf16): rows per cluster, clusters (both directions), clusters the card
// holds at once at that size, and the shared memory of one CTA, for the
// wrapper's admission check and its Python mirror (ops/lstm_cuda.py::
// lstm_plan). Returns a CUDA error, 0 if none.
int vml_lstm_plan(int B, int H, int esize, int* rows, int* clusters, int* max_active,
                  size_t* smem) {
    Plan plan{};
    cudaError_t err = plan_for(B, H, esize, &plan);
    *rows = plan.rows;
    *clusters = plan.clusters;
    *max_active = plan.max_active;
    *smem = smem_bytes(H, plan.rows, esize);
    return (int)err;
}

// Clusters of the layer kernel at `rows` rows per cluster and element size
// esize that the card holds at once (*n). Returns a CUDA error, 0 if none.
int vml_lstm_max_active_clusters(int H, int rows, int esize, int* n) {
    return (int)max_active_clusters(H, rows, esize, n);
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
    cudaError_t err = plan_for(B, H, 4, &plan);
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

// The bf16 variant: xp1{f,b} (B, S, 4H) bf16 layer-1 input projections with
// b_ih, mask (B, S) fp32, W_ih / W_hh bf16 (W_hh 16-byte aligned), b_ih /
// b_hh fp32; scratch h1 (B, S, 2H) and xp2{f,b} bf16; result out (B, S, 2H)
// bf16. rows: rows per cluster, a multiple of 16 up to max_rows (the card
// tests and chip_smoke.py hold every choice), or 0 for the plan's.
int vml_bilstm2_bf16(void* stream, int B, int S, int H, int rows,
                     const vml::bf16* xp1f, const vml::bf16* xp1b, const float* mask,
                     const vml::bf16* whh1f, const vml::bf16* whh1b,
                     const float* bhh1f, const float* bhh1b,
                     const vml::bf16* wih2f, const vml::bf16* wih2b,
                     const float* bih2f, const float* bih2b,
                     const vml::bf16* whh2f, const vml::bf16* whh2b,
                     const float* bhh2f, const float* bhh2b,
                     vml::bf16* h1, vml::bf16* xp2f, vml::bf16* xp2b, vml::bf16* out) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int RB = rows;
    if (RB == 0) {
        Plan plan{};
        cudaError_t err = plan_for(B, H, 2, &plan);
        if (err != cudaSuccess) return (int)err;
        RB = plan.rows;
    } else {
        if (RB % kRowStep || RB < kRowStep || RB > max_rows(H, 2))
            return (int)cudaErrorInvalidValue;
        int n = 0;   // raises the kernel's shared-memory limit
        cudaError_t err = max_active_clusters(H, RB, 2, &n);
        if (err != cudaSuccess) return (int)err;
    }
    const MmaKernel fn = mma_kernel(H, RB);
    const size_t smem = layer_smem_bytes_bf(H, RB);
    const dim3 grid(kClusterBf, (B + RB - 1) / RB, 2);

    fn<<<grid, kThreadsBf, smem, st>>>(B, S, H, RB, xp1f, xp1b, mask, whh1f, whh1b, bhh1f, bhh1b,
                                     h1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    vml::EpilogueBf16 epf, epb;
    epf.bias = bih2f;
    epb.bias = bih2b;
    vml::gemm_nt2_bf16(st, B * S, 4 * H, 2 * H, h1, 2 * H, wih2f, wih2b, 2 * H, xp2f, xp2b,
                       4 * H, epf, epb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fn<<<grid, kThreadsBf, smem, st>>>(B, S, H, RB, xp2f, xp2b, mask, whh2f, whh2b, bhh2f, bhh2b,
                                     out);
    return (int)cudaGetLastError();
}

}  // extern "C"
