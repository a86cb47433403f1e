#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--seed 0]

Phases (any failed check exits non-zero; no phase's failure is caught):

1. the card's name and power limit; build every kernel of the paths from
   ``video_moment_localization_tpu_torch/csrc`` with nvcc (one process per
   source, started together) and print the build time; hold the Python
   mirrors of the shared GEMM's plans (path, block tile, shared memory,
   split-K, partial-buffer floats) for every product of K2-K5, K7, K9 and
   K10 at the three shipped configs and B=1/16/64/512, of the
   content-attention pair's tile plan
   (pairs per pass, passes, blocks per element, shared memory, the
   backward's partial floats) at every query length of those configs and
   batches, and of K5's rows per cluster and shared memory, against their C
   counterparts on the card, each also at bf16 (the GEMM's bf16 plan, which
   kernel and its tiles, blocks and slices, on every product of K2-K5, K7,
   K9 and K10 at bf16 in its three layouts, with operands TMA can read and
   cannot; K5-bf16's rows per cluster; the pair's plans are those of fp32
   rows at either type), and the proposal kernels' launch plans at both
   types (``ops/proposal_cuda.py::plan`` against ``vml_proposal_plan``);
   print K5's clusters per wave at B=16/64/512 at both types;
2. serving kernel parity at the full Charades width
   (config/charadessta.yml), at B=512, B=64 and at the serving run's buckets
   B=16 and B=8: K5 (fused biLSTM) and K4 (fused SMI stack) against their plain
   PyTorch versions on the card, from seeded numpy inputs; each kernel
   launched twice must give the same bits, and whether its plain version
   ran twice gives the same bits is printed beside it (a kernel fault is
   told apart from cuBLAS and atomics in the plain version);
3. the serving path: random seeded weights written as a reference-format
   checkpoint, a synthetic GloVe table, ``MomentLocalizer.from_checkpoint``
   on the card serving 24 requests (a repeated video for the grouped path,
   an out-of-vocabulary word, videos shorter and longer than T); both launch
   counters must rise, and the top-k must equal that of the same localizer
   on the CPU;
4. serving times from CUDA events (median after warm-up) at B=16 and B=512
   for each kernel, its plain version, its bound and the one PyTorch call
   that computes the same function where there is one; end-to-end pairs/s;
5. training kernel parity at the full Charades width, B=64 and B=4, ragged
   masks: K1 (proposal rows) forward and backward (the backward also bit for
   bit against a second launch), K2 (SMI layer forward)
   and K3 (SMI layer backward: all five activation gradients and all 20
   weight and bias gradients, with and without a dcu cotangent; also bit for
   bit against a second launch) against their plain versions on the card;
6. the training path: ``make_train_step`` at B=64, full width and depth, on
   a seeded synthetic batch (targets from the ported label generators,
   ragged lengths, one padded sample), 3 Adam steps. Every loss is finite,
   every parameter's gradient of step 1 is finite and equals that of the
   plain versions, the launch counters of K1 / K2 / K3 rise by 3 + 3, 9 and
   9, and the 3 losses equal those of the same steps taken with the plain
   versions on the card from the same initial weights; then one
   ``make_eval_step`` (K5 and K4) on the batch, its scores and loss held to
   the plain versions';
7. training times at B=64: each new kernel, its plain version, its bound,
   the one PyTorch call for K1 (a matmul with the dense averaging matrix),
   and the whole train step in ms and samples/s;
8. kernel parity at the full ActivityNet-Captions width
   (config/activitynet.yml: T=128, L=64, C=4, D=512, dl=128, Nq=20), at the
   main path's B=64 (532,480 clip rows) and at B=8 and B=2, ragged masks with
   one video cut to L/2 and one query of one word: K6 (packed proposal)
   forward and backward (the backward also bit for bit against a second
   launch), K7 (content unit + folded conv_fc) forward (cu,
   convfc) and backward (dfc, dfbar, dfw, dfs and the 14 weight gradients,
   with and without a dcu cotangent; the backward also bit for bit against
   a second launch) against their plain versions; K5 and K4
   against theirs at that width at B=64 and B=8;
9. the ActivityNet training path: every parameter's gradient of one step at
   B=8 equal to that of the plain versions (the batch they can hold), then
   ``make_train_step`` at B=64, full width and depth, 3 Adam steps: every
   loss finite and falling, the launch counters of K6 / K7 rising by 3 + 3
   and 9 + 9 and those of K1 / K2 / K3 not at all, the peak device memory;
   then one ``make_eval_step`` (K5 at Nq=20, K4 at L=64) on that batch, its
   scores and loss held to the plain versions';
10. ActivityNet times at B=64: K6 and K7 forward and backward (per layer),
    their plain versions, bounds, for K6 the one matmul with the dense
    averaging matrix; K5 and K4 at that width with their plain versions,
    bounds and for K5 the cuDNN LSTM; the whole step in ms and samples/s,
    and its device busy share under ``torch.profiler``;
11. the reference-compat modes' kernels at the full Charades width, B=64
    and B=4, ragged masks: K8 (dense proposal) forward and backward (the
    backward also bit for bit against a second launch), K10
    (fused content unit) forward and backward (16 gradients) against their
    plain versions; K9 (all layers' forward) bit for bit against one K2
    launch per layer, carries included, and each layer within K2's
    tolerance of the plain layer on its input carry (`layer_err`: where the
    fp32 plain layer is itself outside that tolerance of its float64
    evaluation, at the top layer's moment unit, held to the float64
    evaluation no worse than the plain layer); K8 at the ActivityNet width
    at B=8;
12. the modes at B=64, 3 Adam steps each from the same weights, every loss
    and step-1 gradient held to the plain versions as in phase 6:
    ``packed: False`` (K8 3 + 3), ``compat_head`` + ``fused_content`` (K6
    3 + 3, K10 9 + 9), and the default route under
    VML_SMIN_TRAIN_FUSED_FWD=1 (K9 3, K2 0; its losses equal to the
    per-layer route's bit for bit), no other counter moving; the dense
    step-1 loss within 2e-5 of the packed route's; an eval step per mode
    whose loss and recall counts equal the CPU's; the compat localizer's
    top-k equal to the CPU's;
13. times at B=64: K8 forward and backward with the one matmul against the
    dense averaging matrix, K9 against one K2 per layer, K10 forward and
    backward, with plain versions and bounds; the dense and compat train
    steps in ms and samples/s;
14. the shared GEMM (``csrc/gemm.cuh``, through ``csrc/gemm.cu``) alone on
    the products of K7 (ActivityNet B=64: nt, nn and split-K tn), K2, K3 and
    K10 (Charades B=64), K4 (Charades B=16 and B=512) and K5 (B=16 and
    B=512, one of its two problems), and K7's c_hat rows at K=64..1024, on
    both paths: 3xTF32 on the tensor cores (ms, TFLOP/s of fp32 products,
    share of the 165 TFLOP/s that 495 TFLOP/s of TF32 gives) and fp32 on the
    CUDA cores (share of 67 TFLOP/s), with the path each product runs on,
    beside ``torch.matmul`` on the same operands with TF32 off; then every
    bf16 product of K7-bf16 (ActivityNet B=64) and K4-bf16 (Charades B=512
    and B=16) on its epilogue, on both bf16 kernels (wgmma and mma.sync,
    the first held to the second), beside bf16 ``torch.matmul``, against its
    bound (``utils/bench_gemm_bf16.py``);
15. the content-attention pair alone (``csrc/content_attn.cu``, the device
    code that K4, K2, K3, K7, K9 and K10 run between the content unit's
    projections) at Charades B=64 and B=512 and ActivityNet B=64, on the
    inputs a layer's content unit makes: forward and backward against the
    plain version, the backward bit for bit
    against a second launch, times (one call and back to back), the plain
    version's, the bound (its bytes) and the share of it; the same for the
    bf16 backward (bf16 rows, its plain version the fp32 VJP on the same
    values, by `K23_BF16_CARD`);
16. where the redesigned kernels had not been held: K4 at the ActivityNet
    width at B=512 (4,259,840 clip rows, past 65,535 GEMM row tiles along
    y) against K4 on slices of 8 of the same batch, and K2 / K3 at L=64 at
    B=2 and B=8 against their plain versions (K3 also bit for bit);
17. training from feature files through the port's CLI
    (``python -m video_moment_localization_tpu_torch.main``, in this process)
    at the full Charades width, B=64: a Charades-style directory written by
    ``data/synthetic.py`` (dv=1024, 128 train and 32 test videos of 2
    queries: 4 steps and one eval batch an epoch); the host path the labels
    and sampler take (native or NumPy); the loader alone in batches/s; 2
    epochs, whose kernel launches (K1 / K2 / K3 per train step, K5 / K4 per
    eval step, counted from 0 around the run) and stats are checked; a
    second directory trained 1 epoch and resumed to 2, whose stats must equal
    the uninterrupted run's bit for bit; ``--test`` and ``--test --nms``
    printing the 8 metrics; epoch 1 of the same Trainer on the CPU (the
    plain versions) from the same initial weights, its train and eval loss
    within 2e-4 of the card's; the device's busy share over a train epoch
    under ``torch.profiler``; the trainer's samples/s per epoch, beside the
    same steps on an epoch's batches loaded beforehand; the peak device
    memory;
18. asynchronous serving (``AsyncLocalizer``) from phase 3's checkpoint at
    the full Charades width, serve_batch 64, max_wait_ms 2, max_in_flight
    2: open-loop Poisson arrivals of 4,000 requests at 25 %, 50 % and 90 %
    of phase 4's with-host localize_batch throughput, drawn from 64 videos
    of 8-200 clips x 8 queries with ``video_key`` set (the grouped path),
    then 200 closed-loop single requests; p50 / p99 / mean / max latency,
    throughput, mean batch, queue depth and errors of each; every answer
    equal to localize_batch's on the same requests, no error but the one
    malformed request planted in the 50 % run (its own future only),
    close() with 300 requests queued resolving them all, and K4, K5 and
    the pair launched;
19. bf16 serving: K5-bf16 and K4-bf16 against their plain bf16 versions at
    B=16, 64 and 512 (each launched twice, bit for bit, as in phase 2),
    K5-bf16 also at B=8, 16, 64 and 512 at every rows-per-cluster choice of
    its plan (the last block ragged where B is no multiple of it; padded
    steps 0, twice bit for bit) and K4-bf16 at the ActivityNet width (L=64,
    B=64);
    ``MomentLocalizer`` at bf16 on phase 3's 24 requests (the bf16 launch
    counters from 0 around it), its top-5 scores held to the fp32
    localizer's by the JAX package's bf16 criterion; times (one call and
    back to back), plain times, bounds (bf16 products at 989 TFLOP/s, the
    rest at 67, bf16 elements at 2 bytes) and cuDNN's bf16 ``nn.LSTM`` as
    K5-bf16's library time; device pairs/s at B=16 and 512 at both types,
    and the serving forward's MFU (utils/flops.py): fp32 against 67 TFLOP/s
    with the share of 3xTF32's 165 beside it, bf16 against 989;
20. bf16 training on the whole-layer route: K1-bf16 (forward and backward),
    K2-bf16 and K3-bf16 against their plain bf16 versions on the bf16
    backbone's outputs at the full Charades width, B=64 and B=4, and the
    TACoS width, B=64 (K1-bf16 within one bf16 rounding of its plain
    version's fp32 value, K2-bf16 and K3-bf16 by `K23_BF16_CARD`, a K3-bf16
    gradient past its max held to float64 beside its plain version,
    `held_to_f64`; K1-bf16's backward and K3-bf16 twice bit for bit); 3 Adam steps of ``make_train_step`` at ``compute_dtype:
    bfloat16``, B=64, held to the same steps through the plain bf16 versions
    on the card (losses, step-1 gradients; the bf16 counters from 0 around
    the steps, no fp32 kernel launched); one TACoS step at bf16 (T=128,
    L=32, Nq=14, B=16) the same way; the bf16 eval step at B=64 against the
    plain bf16 versions; times of the new kernels (one call, back to back),
    their plain versions, bounds (bf16 contractions at 989 TFLOP/s, the rest
    at 67, bf16 elements at 2 bytes) and for K1 one bf16 ``torch.matmul``
    with Wc, and K3-bf16's device split under ``torch.profiler`` (its
    launches a call, their device time, the GEMM's share and the part of a
    call back to back that no kernel covers); the GEMM's bf16 nn and tn layouts on K3's largest products
    beside ``torch.matmul``; the bf16 and the fp32 train step in ms; bf16
    training from feature files: one epoch of the CLI at ``--compute_dtype
    bfloat16`` on the Charades config and ``--test`` at bf16, and one epoch
    of `Trainer.fit` at the TACoS model's widths (`bf16_files`);
21. bf16 on the content-unit route and the packed unit loop: K6-bf16
    (forward and backward, within one bf16 rounding of its plain version's
    fp32 value, the backward on top of K6's fp32 backward tolerance) and
    K7-bf16 at the full ActivityNet width, B=64, and K10-bf16 at the Charades
    width, B=64, against their plain bf16 versions on the bf16 backbone's
    outputs (`K23_BF16_CARD`; the backward twice bit for bit); 3 Adam steps
    of the ActivityNet bf16 step at B=64 and one ``compat_head`` +
    ``fused_content`` bf16 step at Charades B=64, each held to the same
    steps through the plain bf16 versions on the card (`train_bf16`: the
    same ``smin_forward`` with the kernels' entries swapped for their plain
    versions, `plain_bf16_kernels`; the bf16 counters from 0 around the
    steps: K6-bf16 1 + 1 per step, K7-bf16 or K10-bf16 3 + 3); the
    ActivityNet bf16 eval step; ``fused_smi: False`` serving at bf16 on both
    configs (K6-bf16 -> K7-bf16, K1-bf16 -> K2-bf16, without a graph); times
    of the new kernels (one call, back to back), their plain versions,
    bounds and for K6 one bf16 ``torch.matmul`` with Wc, and K10-bf16's
    device split as K3-bf16's in phase 20; the ActivityNet
    bf16 step in ms and under the profiler; the route fork: the three-layer
    stack of one ActivityNet B=64 step, forward and backward, through
    K1 -> K2 / K3 and through K6 -> K7, at fp32 and bf16 (`route_fork_ms`);
22. bf16 on the dense layout and under the all-layers train forward: K8 and
    K8-bf16 forward and backward at ActivityNet B=64 (a dense fc of 2^29
    elements, past 2^31 bytes at either type) and at Charades B=64 on the
    backbone's outputs, against their plain versions' fp32 values (K8 at
    K1_TOL and K8's backward tolerance, K8-bf16 within one bf16 rounding on
    top of them; forward and backward twice bit for bit); K9-bf16 bit for
    bit three K2-bf16 launches, carries included; 3 Adam steps of the dense
    step at bf16, Charades B=64, held to the same steps through the plain
    bf16 versions (`train_bf16`: K8-bf16 1 + 1 per step), its eval step, and
    ``MomentLocalizer`` with ``packed: False`` at bf16 (top-k and dense
    soft-NMS) against the fp32 localizer on the same weights; 3 bf16 steps
    under VML_SMIN_TRAIN_FUSED_FWD=1 (K9-bf16 1 per step, no K2-bf16) equal
    to the per-layer route's bit for bit; the dense ActivityNet step at B=64
    at fp32 and bf16 (ms, peak memory); times of K8 and K8-bf16 (and a
    ``torch.matmul`` with the dense Wc at their type) and K9-bf16 (beside
    three K2-bf16 launches), plain versions and bounds; the dense Charades
    step at both types in ms and under the profiler;
23. data parallelism on one card (`parallel/mesh.py`): (a) two ranks
    started by `mesh.spawn` with gloo, both on cuda:0 (NCCL puts no two
    ranks on one card), at the full Charades width, global B=64 (32 a
    rank): 3 Adam steps from the weights of one process's same steps on the
    card, the global losses (step 1 within 1e-5, all within
    TRAIN_LOSS_RTOL) and the reduced step-1 gradients (K3's tolerance)
    held to them, the parameters equal across the ranks bit for bit after
    every step, K1 / K2 / K3 launched 3 + 3, 9 and 9 times on each rank; a
    global batch of 40 valid samples (32 and 8 a rank) and one ActivityNet
    B=64 step (K6, K7) the same way; an eval step a rank (K5, K4) whose
    summed loss and counts equal one process's; (b) `Trainer.fit` at two
    gloo ranks, one epoch on phase 17's directory, its stats within 2e-4 of
    phase 17's epoch 1, the stats file and the checkpoint written once, by
    rank 0; (c) the CLI under ``--distributed`` as a one-process NCCL group
    (the launcher's variables set here, a free port), one epoch on the same
    directory, its stats equal to phase 17's epoch 1 bit for bit; (d)
    ``MomentLocalizer`` with two replicas named on cuda:0 on phase 3's 24
    requests, its top-5 equal to the single-device localizer's, and
    ``AsyncLocalizer`` over it on 500 requests equal to its
    ``localize_batch``; (e) the Charades step at world 1 without and with
    the gradient reduction (a one-process NCCL group) and the reduction
    alone, beside the two gloo ranks' step and all-reduce, labelled as
    one-card, host-staged figures;
24. sequence and 2-D parallelism on one card (`parallel.model_parallel`):
    gloo ranks started by `mesh.spawn`, all on cuda:0, their seq
    collectives staged through the host (the route printed); (a) the full
    Charades config (T=64, L=16, D=512, 3 layers), global B=64, on the
    (1 x 2) and (2 x 2) grids, packed and dense (``compat_head``): 3 Adam
    steps from the weights of one process's `make_train_step` on the card
    (the kernel routes), the global losses within TRAIN_LOSS_RTOL, the
    step-1 gradients summed over the world within GRAD_RTOL / GRAD_ATOL_REL
    of each module's largest magnitude, the counts equal each step (else
    the tied scores printed), the parameters
    after the last step within the JAX 2-D tests' tolerances (packed rtol
    3e-4 / atol 3e-5, dense 5e-4 / 5e-5), equal across the ranks bit for
    bit after every step, and no kernel of K1-K10 launched (the 2-D path is
    plain PyTorch, as the JAX one is XLA); (b) config/activitynet.yml
    (T=128, L=64, N=2080), packed, B=64, one step at seq 1 (this process),
    2 and 4: the peak device memory of each rank and the step's wall time;
    the packed pool's reduce-scatter and its backward all-gather alone on
    the Charades B=64 buffer, per spawn; (c) the long-video configuration of tests/test_seq_packed.py
    (T=512, L=32, D=512, dl=128), one (2 x 2) step: finite loss and
    parameters; (d) the CLI at ``--num_devices 2 --seq_devices 2 --device
    cuda:0`` (two gloo ranks on the card), one epoch on phase 17's directory, its epoch-1
    stats within DP_FIT_TOL of phase 17's, stdout, stats and checkpoint
    written once, by rank 0. Times and bytes are one-card, host-staged gloo
    figures, printed with the card's name and power limit.

Each phase prints its seconds.

The proposal kernels K1, K6 and K8 (``csrc/proposal.cuh``,
``csrc/proposal_rows.cu``) are one forward and one backward a type, templated
on the layout. The fp32 forward gives a block one element and 32 columns,
stages f's tile once as fp64 prefix sums in shared memory and writes every
clip mean as a difference of two of them; the bf16 forward gives a lane four
columns (256-byte warp stores) and keeps fp32 prefix sums; K4's pooling
phase is the same kernels. The backward scatters each clip's cotangent, read
once, into per-warp difference arrays in shared memory and scans them over
the frames in a fixed order; at bf16 a lane owns two columns (128-byte warp
loads) and a warp loads the rows of four moments at once. Their times keep
the bounds and library calls of earlier runs: the bytes of the inputs and
outputs, and one ``torch.matmul`` with the dense averaging matrix Wc or its
transpose. Phases 7, 10, 13 and 20-22 also time them and the matmul with
calls queued back to back (``device_ms``, ``library_device_ms``; phases 4
and 19 K5 and cuDNN's LSTM too): the device's time per call, without the
host time of a wrapper call that a single timed call includes while the
device waits.

The serving run and the train steps of phases 3, 6, 9 and 12 also count the
pair's launches by those entry points (the C counters of
``ops/content_attn_cuda.py::path_launches``) and check them.

Prints a ``{"kernels": [...]}`` line (K4 and K5 also at the ActivityNet
width, K8 at the ActivityNet batch; the pair's forward and backward with
their launches on the main path and their times alone; K5-bf16 and K4-bf16;
K1-bf16, K2-bf16 and K3-bf16; K6-bf16, K7-bf16 and K10-bf16; K8-bf16 and
K9-bf16), a ``{"gemm": [...]}`` line, the plans, a ``{"files_training":
{...}}`` line (phase 17), ``{"async_serving": {...}}`` (phase 18),
``{"bf16_serving": {...}}`` (phase 19), ``{"bf16_training": {...}}`` (phase
20), ``{"bf16_content": {...}}`` (phase 21), ``{"bf16_dense": {...}}``
(phase 22), ``{"data_parallel": {...}}`` (phase 23) and ``{"seq_parallel":
{...}}`` (phase 24), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM, TF32 on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3

LSTM_SRC = "video_moment_localization_tpu_torch/csrc/lstm.cu"
STACK_SRC = "video_moment_localization_tpu_torch/csrc/smin_stack.cu"
LSTM_REPLACES = "video_moment_localization_tpu/ops/lstm_pallas.py:159"
STACK_REPLACES = "video_moment_localization_tpu/ops/smin_pallas.py:682"
PROPOSAL_SRC = "video_moment_localization_tpu_torch/csrc/proposal_rows.cu"
TRAIN_SRC = "video_moment_localization_tpu_torch/csrc/smin_train.cu"
K1_FWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:342"
K1_BWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:398"
K2_REPLACES = "video_moment_localization_tpu/ops/smin_train_pallas.py:508"
K3_REPLACES = "video_moment_localization_tpu/ops/smin_train_pallas.py:637"
CONTENT_SRC = "video_moment_localization_tpu_torch/csrc/content_train.cu"
K6_FWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:173"
K6_BWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:488"
K7_FWD_REPLACES = "video_moment_localization_tpu/ops/content_train_pallas.py:361"
K7_BWD_REPLACES = "video_moment_localization_tpu/ops/content_train_pallas.py:402"
K8_FWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:63"
K8_BWD_REPLACES = "video_moment_localization_tpu/ops/proposal_pallas.py:121"
K9_REPLACES = "video_moment_localization_tpu/ops/smin_train_pallas.py:556"
K10_FWD_REPLACES = "video_moment_localization_tpu/ops/content_pallas.py:173"
K10_BWD_REPLACES = "video_moment_localization_tpu/ops/content_pallas.py:274"
PAIR_SRC = "video_moment_localization_tpu_torch/csrc/content_attn.cuh"
# The content attention inside the JAX layer body (smi_layer_rows, which K4's
# and K2's Pallas kernels run) and K3's VJP of that body.
PAIR_FWD_REPLACES = "video_moment_localization_tpu/ops/smin_pallas.py:352"
PAIR_BWD_REPLACES = K3_REPLACES
SOURCES = ("lstm", "smin_stack", "proposal_rows", "smin_train", "content_train", "gemm",
           "content_attn")
K5_TOL = dict(rtol=1e-4, atol=2e-5)
K4_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_TOL = 1e-4
# K1: a mean over at most T/L * L frames and its transpose; summation order.
K1_TOL = dict(rtol=1e-4, atol=1e-5)
# K3: the JAX train-kernel tests' gradient rtol; the absolute part is relative
# to a magnitude, because a weight gradient sums up to B*N*C = 34,816 rows in
# another order than the plain version: an activation gradient's own largest
# magnitude, and for the weights the largest over the layer's 20 (a
# key-projection bias has a structurally zero gradient: only noise is left).
GRAD_RTOL, GRAD_ATOL_REL = 5e-4, 5e-5
# Three Adam steps, kernels vs plain versions on the card: Adam's update is
# about lr * g / (|g| + 1e-8), so rounding noise in near-zero gradients moves
# those weights by up to 2 * lr between the two runs from step 2 on.
TRAIN_LOSS_RTOL = 2e-4
TRAIN_BATCH = 64
TRAIN_STEPS = 3
# ActivityNet: kernel parity at the main path's batch (a K7 weight gradient
# sums B*N*C = 532,480 rows there) and at two small ones, all held to the same
# form of tolerance as K3's; the whole step's gradients at the batch where the
# plain step's autograd graph over three layers fits beside the kernels' step.
ANET_PARITY_BATCHES = (TRAIN_BATCH, 8, 2)
ANET_STEP_PARITY_BATCH = 8
# An eval step's loss against the plain versions' on the same batch.
EVAL_LOSS_RTOL = 1e-4
# The dense layout's step-1 loss against the packed one's (JAX
# tests/test_packed.py: the same terms averaged over the same denominators).
DENSE_PACKED_RTOL = 2e-5
QUERIES = ["person opens the door", "a person sits on the couch",
           "someone takes a xylophone from the shelf", "the person closes a laptop",
           "person pours water into a cup", "a person laughs",
           "someone is eating a sandwich in the kitchen near the window", "person runs"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_pair_counts() -> None:
    from video_moment_localization_tpu_torch.ops import content_attn_cuda

    content_attn_cuda.reset_path_launches()


def pair_counts():
    """Launches of the content-attention pair's forward and backward by the
    C entry points of K4, K2, K3, K9, K7 and K10 since the last reset."""
    from video_moment_localization_tpu_torch.ops import content_attn_cuda

    fwd, bwd = content_attn_cuda.path_launches()
    return {"CAf": fwd, "CAb": bwd}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, launches: int = 20, reps: int = 5) -> float:
    """Median milliseconds per call of ``launches`` calls of fn() queued back
    to back between two CUDA events: the device's time per call, without the
    host time of a call that `cuda_ms` includes while the device waits."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(flops: float, nbytes: float, tensor_flops: float = 0.0):
    """The least time of the work: the larger of its operations' time and
    its bytes' time. ``tensor_flops`` of the ``flops`` are fp32-accurate
    products, priced as 3xTF32 on the tensor cores (three TF32 products
    each, at 495 TFLOP/s); the rest as fp32 on the CUDA cores (67
    TFLOP/s)."""
    t_ops = (3 * tensor_flops / PEAK_TF32_FLOPS + (flops - tensor_flops) / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gemm_flops(cfg, B, kernel, times=1):
    """Operations of ``kernel``'s products at batch B
    (ops/gemm_cuda.py::model_gemm_shapes), ``times`` over: K9's and K4's
    per layer."""
    from video_moment_localization_tpu_torch.ops import gemm_cuda

    return sum(times * 2.0 * M * N * K * groups
               for k, _, _, M, N, K, groups in gemm_cuda.model_gemm_shapes(cfg, B) if k == kernel)


def both_bounds(flops, nbytes, products, rest):
    """(bound_ms, bound_by, bound_fp32_ms). The first two count the port's
    own work: ``products`` (`gemm_flops`) priced as fp32-accurate products
    at the card's best rate for them, 3xTF32 on the tensor cores, whatever
    path the port runs them on, and ``rest``, the operations outside
    products, on the CUDA cores. bound_fp32_ms is the bound of earlier
    runs: the JAX package's operation count ``flops`` all at 67 TFLOP/s."""
    b_ms, b_by = bound(products + rest, nbytes, products)
    return b_ms, b_by, bound(flops, nbytes)[0]


def layer_rest(cfg, Nq):
    """`layer_flops` outside its products, per element: the word and clip
    attentions of the content unit, the boundary unit's attentions and its
    moment message (the bk projection it leaves out is a product)."""
    L, C, D, dl = cfg.L, cfg.C, cfg.D, cfg.dl
    N = L * (L + 1) // 2
    return 2 * (N * C * (2 * Nq * dl + 2 * C * dl) + L * (2 * Nq * D + 2 * L * D) + 3 * N * L * D)


def pool_rest(cfg):
    """K4's operations per element outside its layers: the port's proposal
    pooling (proposal.cuh::pool_kernel: the prefix sums over T, a difference
    and a scale per window mean, a difference, a scale and a mask per clip
    mean, the clip means' sum and scale into fm) and the four heads' dot
    products (smin_stack.cu::heads_kernel). The JAX package's count prices
    the pooling as dense products over T, which the prefix sums do not
    need."""
    L, C, D, T = cfg.L, cfg.C, cfg.D, cfg.T
    N = L * (L + 1) // 2
    return D * (T + 2 * L + 3 * N * C + N * (C + 1)) + 2 * D * (N + 3 * L)


def unit_rest(cfg, Nq):
    """`unit_flops` (and `content_flops`) outside their products, per
    element: the word and clip attentions of the content unit."""
    N = cfg.L * (cfg.L + 1) // 2
    return 2 * N * cfg.C * (2 * Nq * cfg.dl + 2 * cfg.C * cfg.dl)


# ------------------------------------------------------------------------- #
def lstm_inputs(cfg, B, rng, device):
    import torch

    x = torch.from_numpy(rng.standard_normal((B, cfg.max_query_length, cfg.word_dim))
                         .astype("float32")).to(device)
    lengths = rng.integers(1, cfg.max_query_length + 1, size=B)
    lengths[0] = 1
    lengths[-1] = cfg.max_query_length
    mask = (torch.arange(cfg.max_query_length)[None, :] < torch.from_numpy(lengths)[:, None])
    return x, mask.float().to(device), lengths


def stack_inputs(cfg, B, rng, device, pin=False):
    """(f, fw, fs, qmask, lmask, vmask) with random lengths; ``pin`` cuts the
    second video to L/2 snippets and the second query to one word."""
    import torch

    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

    def t(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    Nq = cfg.max_query_length
    f = t(rng.standard_normal((B, cfg.T, cfg.D)))
    fw = t(rng.standard_normal((B, Nq, cfg.D)))
    fs = t(rng.standard_normal((B, cfg.D)))
    qlen = rng.integers(1, Nq + 1, size=B)
    nlen = rng.integers(1, cfg.L + 1, size=B)
    nlen[0] = cfg.L
    if pin:
        qlen[1], nlen[1] = 1, cfg.L // 2
    qmask = (torch.arange(Nq)[None, :] < torch.from_numpy(qlen)[:, None]).float()[..., None]
    lmask = (torch.arange(cfg.L)[None, :] < torch.from_numpy(nlen)[:, None]).float()
    qmask, lmask = qmask.to(device), lmask.to(device)
    return f, fw, fs, qmask, lmask, packed_valid_mask(lmask).contiguous()


def max_err(got, want, tol, name):
    import torch

    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite output")
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: kernel disagrees with its plain version: max abs err {err:.3e} "
                 f"(tolerance {tol})")
    return err


def layer_err(got, weights, carry, shared, L, name):
    """One SMI layer's outputs ``got`` (the last len(got) of cu, mu, bu)
    against the plain layer on the same inputs at K2's tolerance. Where an
    output of the fp32 plain layer is itself outside that tolerance of the
    plain layer evaluated in float64 (the moment unit at the top of a
    stack: x1 = bu[i] bu[j] near 2,500, mu cancelling to near zero at some
    pairs), the kernel's is held to the float64 evaluation instead: outside
    the tolerance at no more elements than the fp32 plain layer's, and no
    farther from it on average. Returns the largest max abs error, each
    against the reference it was held to."""
    import torch

    from video_moment_localization_tpu_torch.ops import smin_train_cuda

    n = len(got)
    want = smin_train_cuda.smi_layer_plain(weights, *carry, *shared, L)[-n:]
    exact = smin_train_cuda.smi_layer_plain([w.double() for w in weights],
                                            *(t.double() for t in (*carry, *shared)), L)[-n:]
    err = 0.0
    for g, w, x, out in zip(got, want, exact, ("cu", "mu", "bu")[-n:]):
        if torch.isclose(w.double(), x, **K4_TOL).all():
            err = max(err, max_err([g], [w], K4_TOL, f"{name} {out}"))
            continue
        if not torch.isfinite(g).all():
            fail(f"{name} {out}: non-finite output")
        tol = K4_TOL["atol"] + K4_TOL["rtol"] * x.abs()
        dg, dw = (g.double() - x).abs(), (w.double() - x).abs()
        ng, nw = int((dg > tol).sum()), int((dw > tol).sum())
        report = (f"{name} {out} against the plain layer in float64: the fp32 plain layer "
                  f"outside {K4_TOL} at {nw} elements, max {float(dw.max()):.3e}, mean "
                  f"{float(dw.mean()):.3e}; the kernel at {ng}, max {float(dg.max()):.3e}, mean "
                  f"{float(dg.mean()):.3e}")
        if ng > nw or float(dg.mean()) > float(dw.mean()):
            fail(f"{report}: the kernel is farther from float64 than the plain layer")
        print(report)
        err = max(err, float(dg.max()))
    return err


def stack_flops(cfg, Nq):
    """ops/smin_pallas.py:720-724 of the JAX package, per element."""
    L, C, D, dl, T = cfg.L, cfg.C, cfg.D, cfg.dl, cfg.T
    N = L * (L + 1) // 2
    NC = N * C
    return cfg.num_smi_layers * 2 * (
        NC * (2 * D * dl + dl * dl + Nq * dl * 2 + 2 * C * dl)
        + N * (2 * D * D)
        + L * (D * D + Nq * D * 2 + L * D * 2) + N * L * D * 3
    ) + 2 * NC * T * D + 2 * L * T * D


def lstm_flops(cfg):
    """ops/lstm_pallas.py:196 of the JAX package, per element, plus the
    layer-1 input projection that the wrapper computes."""
    S, H, W = cfg.max_query_length, cfg.lstm_hidden_size, cfg.word_dim
    return S * 2 * 2 * (H * 4 * H) * 2 + S * 2 * (2 * H) * 4 * H * 2 + S * 2 * W * 4 * H * 2


def param_bytes(module):
    return sum(p.numel() * 4 for p in module.parameters())


# ------------------------------------------------------------------------- #
def check_twice(first, again, plain, plain_again, name):
    """A kernel's second launch on the same inputs must equal its first bit
    for bit (fixed-order sums, no atomics); the plain version's second run
    is reported beside it (cuBLAS may pick another reduction order), which
    tells a kernel fault apart from the plain version's. Returns whether the
    plain version repeated."""
    import torch

    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(first, again)):
        if not torch.equal(a, b):
            fail(f"{name}: output {k} of two launches on the same inputs differs by up to "
                 f"{float((a.float() - b.float()).abs().max()):.3e}")
    same = all(torch.equal(a, b) for a, b in zip(plain, plain_again))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(plain, plain_again))
    print(f"repeatable {name}: a second launch equal bit for bit; the plain version's second "
          f"run {'equal bit for bit' if same else f'differs by up to {diff:.3e}'}")
    return same


def phase_parity(cfg, model, rng, device):
    """K5 and K4 against their plain versions at the timed B=512 (K5's
    80-row clusters), at B=64 and at the serving run's buckets (16, and 8:
    below K5's 16-row cluster block); each kernel and each plain version run
    twice (`check_twice`). Returns the largest max abs error of each kernel
    over the sizes and whether each plain version repeated at every size."""
    import torch

    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    layers = lstm_layers(model.backbone.queryencoder.lstm)
    k5_err = k4_err = 0.0
    plain_repeats = {"K5": True, "K4": True}
    for B in (512, 64, 16, 8):
        x, mask, _ = lstm_inputs(cfg, B, rng, device)
        got = lstm_cuda.bilstm_fused(x, mask, layers)
        want = lstm_cuda.bilstm_plain(x, mask, layers)
        plain_repeats["K5"] &= check_twice(
            [got], [lstm_cuda.bilstm_fused(x, mask, layers)], [want],
            [lstm_cuda.bilstm_plain(x, mask, layers)], f"K5 bilstm_fused B={B}")
        if tuple(got.shape) != (B, cfg.max_query_length, cfg.D):
            fail(f"K5 output shape {tuple(got.shape)}")
        if bool((got[mask == 0] != 0).any()):
            fail("K5: output at a padded step is not 0")
        err = max_err([got], [want], K5_TOL, f"K5 bilstm_fused B={B}")
        print(f"parity K5 bilstm_fused B={B}: max abs err {err:.3e} (tolerance {K5_TOL})")
        k5_err = max(k5_err, err)

        ins = stack_inputs(cfg, B, rng, device)
        got = smin_cuda.smin_stack_fused(model, cfg, *ins)
        want = smin_cuda.smin_stack_plain(model, cfg, *ins)
        plain_repeats["K4"] &= check_twice(
            got, smin_cuda.smin_stack_fused(model, cfg, *ins), want,
            smin_cuda.smin_stack_plain(model, cfg, *ins), f"K4 smin_stack_fused B={B}")
        err = max_err(got, want, K4_TOL, f"K4 smin_stack_fused B={B}")
        print(f"parity K4 smin_stack_fused B={B}: max abs err {err:.3e} (tolerance {K4_TOL})")
        k4_err = max(k4_err, err)
    return k5_err, k4_err, plain_repeats


def write_glove(path, words, dim, seed):
    from video_moment_localization_tpu_torch.data.glove import WordEmbedding

    emb = WordEmbedding.synthetic(words, dim=dim, seed=seed)
    with open(path, "w") as fh:
        for w, i in emb.stoi.items():
            fh.write(w + " " + " ".join(repr(float(v)) for v in emb.vectors[i]) + "\n")


def requests(cfg, rng):
    """24 requests: 16 on 3 videos (grouped path), 8 on distinct videos."""
    def video(n):
        return rng.standard_normal((n, cfg.input_video_dim)).astype("float32")

    shared = [video(n) for n in (20, 64, 150)]   # shorter than, equal to, longer than T
    reqs = [(shared[k % 3], QUERIES[k % len(QUERIES)], 30.0 + k) for k in range(16)]
    reqs += [(video(int(n)), QUERIES[k % len(QUERIES)], float(n) / 2.0)
             for k, n in enumerate((9, 33, 47, 64, 80, 128, 200, 17))]
    return reqs


def phase_serving(cfg, seed, rng, tmp):
    import torch

    from video_moment_localization_tpu_torch.inference import MomentLocalizer
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    torch.manual_seed(seed)
    model = SMIN(cfg)
    ckpt_dir = os.path.join(tmp, "checkpoints")
    os.makedirs(ckpt_dir)
    torch.save({"epoch": 0, "model": model.state_dict(), "optimizer": {}},
               os.path.join(ckpt_dir, "charadessta_model.ckpt"))
    with open(os.path.join(REPO, "config", "charadessta.yml")) as fh:
        text = fh.read()
    cfg_path = os.path.join(tmp, "charadessta.yml")
    with open(cfg_path, "w") as fh:
        fh.write(text.replace('"checkpoints/"', json.dumps(ckpt_dir + "/")))
    words = sorted({w for q in QUERIES for w in q.split()} - {"xylophone"})
    glove = os.path.join(tmp, "glove.txt")
    write_glove(glove, words, cfg.word_dim, seed)

    gpu = MomentLocalizer.from_checkpoint(cfg_path, glove_path=glove, serve_batch=16)
    cpu = MomentLocalizer.from_checkpoint(cfg_path, glove_path=glove, serve_batch=16,
                                          device="cpu")
    reqs = requests(cfg, rng)
    lstm_cuda.bilstm_fused.launches = 0
    smin_cuda.smin_stack_fused.launches = 0
    reset_pair_counts()
    out = gpu.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    launches = {"K5": lstm_cuda.bilstm_fused.launches,
                "K4": smin_cuda.smin_stack_fused.launches,
                "CAf": pair_counts()["CAf"]}
    print(f"serving: {len(reqs)} requests, launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was not launched: {launches}")
    ref = cpu.localize_batch(reqs, top_k=5)
    worst = 0.0
    for k, (g, c) in enumerate(zip(out, ref)):
        if [(m.start, m.end) for m in g] != [(m.start, m.end) for m in c]:
            fail(f"request {k}: top-k {[(m.start, m.end) for m in g]} on the card, "
                 f"{[(m.start, m.end) for m in c]} on the CPU")
        for mg, mc in zip(g, c):
            if not (0.0 <= mg.score <= 1.0):
                fail(f"request {k}: score {mg.score} outside [0, 1]")
            worst = max(worst, abs(mg.score - mc.score))
    if worst > SCORE_TOL:
        fail(f"scores differ from the CPU's by {worst:.3e} > {SCORE_TOL}")
    print(f"serving: top-k equal to the CPU localizer's; max score diff {worst:.3e} "
          f"(tolerance {SCORE_TOL})")
    return gpu, launches, dict(cfg_path=cfg_path, glove=glove, requests=reqs, top5=out)


def cudnn_lstm(cfg, model, device):
    """(x, lengths) -> (B, Nq, D): torch.nn.LSTM with the model's weights on
    packed sequences, the one PyTorch call that computes K5's function."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    ref = torch.nn.LSTM(cfg.word_dim, cfg.lstm_hidden_size, num_layers=2, bidirectional=True,
                        batch_first=True)
    ref.load_state_dict(model.backbone.queryencoder.lstm.state_dict())
    ref = ref.to(device)

    def run(x, lengths):
        packed = pack_padded_sequence(x, torch.from_numpy(lengths), batch_first=True,
                                      enforce_sorted=False)
        return pad_packed_sequence(ref(packed)[0], batch_first=True,
                                   total_length=cfg.max_query_length)[0]

    return run


def serving_kernel_times(cfg, model, B, rng, device, library_lstm, iters=15):
    """K5 and K4 at batch B: kernel, plain version, bound and, for K5, the
    cuDNN LSTM. Returns ({"K5": ..., "K4": ...}, the query mask used)."""
    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    layers = lstm_layers(model.backbone.queryencoder.lstm)
    Nq = cfg.max_query_length
    N = cfg.L * (cfg.L + 1) // 2
    x, mask, lengths = lstm_inputs(cfg, B, rng, device)
    nbytes = (4 * (x.numel() + mask.numel() + B * Nq * cfg.D)
              + param_bytes(model.backbone.queryencoder.lstm))
    # Every operation is a product: the projections and the recurrence.
    b_ms, b_by, b32 = both_bounds(B * lstm_flops(cfg), nbytes, B * lstm_flops(cfg), 0.0)
    res = {"K5": dict(
        ms=cuda_ms(lambda: lstm_cuda.bilstm_fused(x, mask, layers), iters=iters),
        device_ms=cuda_ms_back_to_back(lambda: lstm_cuda.bilstm_fused(x, mask, layers)),
        plain_ms=cuda_ms(lambda: lstm_cuda.bilstm_plain(x, mask, layers), iters=iters),
        library_ms=cuda_ms(lambda: library_lstm(x, lengths), iters=iters),
        library_device_ms=cuda_ms_back_to_back(lambda: library_lstm(x, lengths)),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32)}
    ins = stack_inputs(cfg, B, rng, device)
    nbytes = (4 * sum(t.numel() for t in ins) + param_bytes(model.smis)
              + param_bytes(model.localization) + 4 * B * (N + 3 * cfg.L))
    # Outside the layers' products: their rest, and the pooling and heads.
    b_ms, b_by, b32 = both_bounds(
        B * stack_flops(cfg, Nq), nbytes, gemm_flops(cfg, B, "K4", cfg.num_smi_layers),
        B * (cfg.num_smi_layers * layer_rest(cfg, Nq) + pool_rest(cfg)))
    res["K4"] = dict(
        ms=cuda_ms(lambda: smin_cuda.smin_stack_fused(model, cfg, *ins), iters=iters),
        plain_ms=cuda_ms(lambda: smin_cuda.smin_stack_plain(model, cfg, *ins), iters=iters),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32)
    return res, mask


def phase_times(cfg, gpu, rng):
    import torch

    model = gpu.model
    device = gpu.device
    library_lstm = cudnn_lstm(cfg, model, device)
    Nq = cfg.max_query_length
    res = {}
    for B in (16, 512):
        at_b, mask = serving_kernel_times(cfg, model, B, rng, device, library_lstm)
        for k in ("K5", "K4"):
            r = res[(k, B)] = at_b[k]
            print(f"time {k} B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){b2b_note(r)}")

        # End to end on the device: the serving forward, scores and top-k.
        vf = torch.from_numpy(rng.standard_normal((B, cfg.T, cfg.input_video_dim))
                              .astype("float32")).to(device)
        vm = torch.ones((B, cfg.T, 1), device=device)
        qf = torch.from_numpy(rng.standard_normal((B, Nq, cfg.word_dim))
                              .astype("float32")).to(device)
        qm = mask[..., None].contiguous()
        lm = torch.ones((B, cfg.L), device=device)
        fwd_ms = cuda_ms(lambda: gpu._score(vf, vm, qf, qm, lm, None, 5))
        print(f"time serving forward + top-5 B={B}: {fwd_ms:.4f} ms, "
              f"{B / fwd_ms * 1e3:.1f} pairs/s on the device")
        res[("e2e", B)] = fwd_ms

    reqs = [(rng.standard_normal((int(n), cfg.input_video_dim)).astype("float32"),
             QUERIES[k % len(QUERIES)], 30.0) for k, n in
            enumerate(rng.integers(20, 200, size=512))]
    gpu.localize_batch(reqs[:32], top_k=5)
    t0 = time.perf_counter()
    gpu.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"time localize_batch 512 requests, serve_batch 16: {wall:.4f} s, "
          f"{len(reqs) / wall:.1f} pairs/s with host featurization")
    res["with_host_pairs_per_s"] = len(reqs) / wall
    return res


# ------------------------------------------------------------------------- #
# Training slice
# ------------------------------------------------------------------------- #
def print_back_to_back(res, keys, label):
    for k in keys:
        r = res[k]
        print(f"time {k} {label} back to back: kernel {r['device_ms']:.4f} ms, library "
              f"{r['library_device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def layer_flops(cfg, Nq):
    """ops/smin_train_pallas.py:489-493 of the JAX package, per element."""
    L, C, D, dl = cfg.L, cfg.C, cfg.D, cfg.dl
    N = L * (L + 1) // 2
    NC = N * C
    return 2 * (NC * (2 * D * dl + dl * dl + Nq * dl * 2 + 2 * C * dl)
                + N * (2 * D * D)
                + L * (D * D + Nq * D * 2 + L * D * 2) + N * L * D * 3)


def layer_inputs(cfg, B, rng, device, pin=False):
    """(fc, fm, fb, fw, fs, qmask, lmask, vmask) of one SMI layer."""
    from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

    f, fw, fs, qmask, lmask, vmask = stack_inputs(cfg, B, rng, device, pin)
    fc, fm, fb = proposal_features_packed(f, lmask, cfg.L, cfg.C)
    return [t.contiguous() for t in (fc, fm, fb, fw * qmask, fs, qmask, lmask, vmask)]


def randn_like(t, rng):
    import torch

    return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype("float32")).to(t.device)


def grad_err(got, want, scale, name):
    """Max abs error of a gradient held to GRAD_RTOL and GRAD_ATOL_REL * scale."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite gradient")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale):
        fail(f"{name}: kernel disagrees with its plain version: max abs err {err:.3e}, "
             f"magnitude {scale:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude)")
    return err


def check_repeatable(first, launch, name):
    """A second launch of a backward kernel on the same inputs must give
    the same bits (its sums are taken in one fixed order, without atomics)."""
    import torch

    again = launch()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"{name}: two launches differ by up to {float((first - again).abs().max()):.3e}")


def check_all_repeatable(first, again, name):
    """Every output of a backward (its activation gradients, then its list
    of weight gradients) equal bit for bit to a second launch's."""
    import torch

    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(list(first[:-1]) + list(first[-1]),
                                   list(again[:-1]) + list(again[-1]))):
        if not torch.equal(a, b):
            fail(f"{name}: output {k} differs between two launches by up to "
                 f"{float((a - b).abs().max()):.3e}")


def gradient_set_err(got, want, names, label):
    """Activation gradients held to their own magnitude, weight gradients to
    the largest of the set. Returns (max abs err, max err of its magnitude)."""
    worst = rel = 0.0
    for g, w, name in zip(got[:len(names)], want[:len(names)], names):
        scale = float(w.abs().max())
        e = grad_err(g, w, scale, f"{label} {name}")
        worst, rel = max(worst, e), max(rel, e / scale)
    scale = max(float(w.abs().max()) for w in want[-1])
    for k, (g, w) in enumerate(zip(got[-1], want[-1])):
        e = grad_err(g, w, scale, f"{label} weight gradient {k}")
        worst, rel = max(worst, e), max(rel, e / scale)
    return worst, rel


def phase_train_parity(cfg, model, rng, device):
    """K1 forward / backward, K2 and K3 against their plain versions at B=64
    and B=4. Returns the largest max abs error of each over the sizes (K3's
    also relative to the gradient magnitudes it was held to)."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda

    errs = {"K1f": 0.0, "K1b": 0.0, "K2": 0.0, "K3": 0.0, "K3_rel": 0.0}
    weights = [w.detach() for w in block_weights(model.smis[1])]
    for B in (TRAIN_BATCH, 4):
        f, _, _, _, lmask, _ = stack_inputs(cfg, B, rng, device)
        got = proposal_cuda.proposal_rows_forward(f, lmask, cfg.L, cfg.C)
        want = proposal_cuda.proposal_features_packed(f, lmask, cfg.L, cfg.C)
        torch.cuda.synchronize()
        e1 = max_err(got, want, K1_TOL, f"K1 proposal_rows_forward B={B}")
        cots = [randn_like(t, rng) for t in want]
        dgot = proposal_cuda.proposal_rows_backward(lmask, cfg.T, cfg.L, cfg.C, *cots)
        dwant = proposal_cuda.proposal_backward_plain(lmask, cfg.T, cfg.L, cfg.C, *cots)
        torch.cuda.synchronize()
        e2 = max_err([dgot], [dwant], K1_TOL, f"K1 proposal_rows_backward B={B}")
        check_repeatable(dgot, lambda: proposal_cuda.proposal_rows_backward(
            lmask, cfg.T, cfg.L, cfg.C, *cots), f"K1 proposal_rows_backward B={B}")
        print(f"parity K1 proposal rows B={B}: forward max abs err {e1:.3e}, backward "
              f"{e2:.3e} (tolerance {K1_TOL}), a second launch equal bit for bit")
        errs["K1f"], errs["K1b"] = max(errs["K1f"], e1), max(errs["K1b"], e2)

        ins = layer_inputs(cfg, B, rng, device)
        got = smin_train_cuda.smi_layer_forward(weights, *ins, cfg.L)
        want = smin_train_cuda.smi_layer_plain(weights, *ins, cfg.L)
        torch.cuda.synchronize()
        e = max_err(got, want, K4_TOL, f"K2 smi_layer_forward B={B}")
        print(f"parity K2 smi_layer_forward B={B}: max abs err {e:.3e} (tolerance {K4_TOL})")
        errs["K2"] = max(errs["K2"], e)

        dcu, dmu, dbu = [randn_like(t, rng) for t in want]
        for cot in (dcu, None):
            got = smin_train_cuda.smi_layer_backward(weights, *ins, cfg.L, cot, dmu, dbu)
            if cot is not None:
                check_all_repeatable(got, smin_train_cuda.smi_layer_backward(
                    weights, *ins, cfg.L, cot, dmu, dbu), f"K3 smi_layer_backward B={B}")
                print(f"repeatable K3 smi_layer_backward B={B}: 25 gradients of a second "
                      f"launch equal bit for bit")
            want = smin_train_cuda.smi_layer_backward_plain(weights, *ins, cfg.L, cot, dmu, dbu)
            torch.cuda.synchronize()
            worst, rel = gradient_set_err(got, want, ("dfc", "dfm", "dfb", "dfw", "dfs"),
                                          f"K3 B={B}")
            print(f"parity K3 smi_layer_backward B={B} dcu={'yes' if cot is not None else 'none'}: "
                  f"25 gradients, max abs err {worst:.3e}, {rel:.3e} of the magnitude "
                  f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude)")
            errs["K3"], errs["K3_rel"] = max(errs["K3"], worst), max(errs["K3_rel"], rel)
    return errs


def plain_forward(cfg, model, batch):
    """The forward of the config's mode with the plain version in place of
    every kernel: the pipeline of PyTorch ops under autograd (packed, or
    dense for ``packed: False``; pm densified under ``compat_head``)."""
    from video_moment_localization_tpu_torch.models import smin
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.ops.proposal import (
        proposal_features,
        proposal_features_packed,
    )

    f, fs, fw = smin.backbone(model.backbone, cfg, batch["video_features"], batch["video_mask"],
                              batch["query_features"], batch["query_mask"], fused_lstm=False)
    qmask, lmask = batch["query_mask"], batch["length_mask"]
    if not cfg.packed:
        mm = batch["moment_mask"]
        fc, fm, fb = proposal_features(f, mm, cfg.L, cfg.C)
        for block in model.smis:
            fc, fm, fb = smin.smi_block(block, fc, fm, fb, fw, fs, qmask, lmask, mm)
        return smin.localization(model.localization, fm, fb, lmask, mm)
    vmask = packed_valid_mask(lmask)
    fc, fm, fb = proposal_features_packed(f, lmask, cfg.L, cfg.C)
    for block in model.smis:
        fc, fm, fb = smin.smi_block_packed(block, fc, fm, fb, fw, fs, qmask, lmask, vmask, cfg.L)
    return smin.localization_packed(model.localization, fm, fb, lmask, vmask, cfg.L,
                                    dense_out=cfg.compat_head)


def plain_train_step(cfg, model, optimizer, batch):
    """One train step with the plain version in place of every kernel
    (`plain_forward`). Returns the loss tensor."""
    import torch

    from video_moment_localization_tpu_torch.train.loss import smin_loss

    model.train()
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, _ = smin_loss(plain_forward(cfg, model, batch), batch)
        loss.backward()
    optimizer.step()
    return loss.detach()


def check_eval_step(cfg, model, batch, device, label):
    """One eval step on the batch: K5 and K4 launch once each, the scores
    (pm, ps, pe, pa) of its forward equal those of the plain biLSTM and the
    plain SMI stack on the same batch, and so does its loss."""
    import torch

    from video_moment_localization_tpu_torch.models import smin
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.parallel.steps import make_eval_step
    from video_moment_localization_tpu_torch.train.loss import smin_loss

    k5, k4 = lstm_cuda.bilstm_fused.launches, smin_cuda.smin_stack_fused.launches
    ev = make_eval_step(cfg, model, device=device)(batch)
    torch.cuda.synchronize()
    if (lstm_cuda.bilstm_fused.launches, smin_cuda.smin_stack_fused.launches) != (k5 + 1, k4 + 1):
        fail(f"{label}: the eval step did not launch K5 and K4 once each")
    with torch.no_grad():
        args = [batch[k] for k in ("video_features", "video_mask", "query_features",
                                   "query_mask")]
        lmask = batch["length_mask"].float()
        got = smin.smin_forward_inference(model, cfg, *args, lmask)
        f, fs, fw = smin.backbone(model.backbone, cfg, *args, fused_lstm=False)
        want = smin_cuda.smin_stack_plain(model, cfg, f, fw, fs, batch["query_mask"], lmask,
                                          packed_valid_mask(lmask))
        plain_loss = float(smin_loss(want, batch)[0])
    torch.cuda.synchronize()
    B = lmask.shape[0]
    err = max_err(got, want, K4_TOL, f"{label}: eval forward (K5, K4) at B={B}")
    ev_loss = float(ev["loss"])
    if not abs(ev_loss - plain_loss) <= EVAL_LOSS_RTOL * abs(plain_loss):
        fail(f"{label}: eval loss {ev_loss} against the plain versions' {plain_loss} "
             f"(rtol {EVAL_LOSS_RTOL})")
    print(f"{label}: eval step at B={B}, scores equal to the plain versions' within {err:.3e} "
          f"(tolerance {K4_TOL}), loss {ev_loss:.6f} against {plain_loss:.6f} (rtol "
          f"{EVAL_LOSS_RTOL}), counts {ev['counts'].flatten().tolist()}")
    return err


def mode_counters():
    from video_moment_localization_tpu_torch.ops import (
        content_cuda,
        content_train_cuda,
        proposal_cuda,
        smin_train_cuda,
    )

    return {"K1f": proposal_cuda.proposal_rows_forward,
            "K1b": proposal_cuda.proposal_rows_backward,
            "K2": smin_train_cuda.smi_layer_forward, "K3": smin_train_cuda.smi_layer_backward,
            "K6f": proposal_cuda.proposal_packed_forward,
            "K6b": proposal_cuda.proposal_packed_backward,
            "K7f": content_train_cuda.content_rows_forward,
            "K7b": content_train_cuda.content_rows_backward,
            "K8f": proposal_cuda.proposal_dense_forward,
            "K8b": proposal_cuda.proposal_dense_backward,
            "K9": smin_train_cuda.smi_stack_forward,
            "K10f": content_cuda.content_unit_forward,
            "K10b": content_cuda.content_unit_backward}


def train_mode(config, cfg, label, initial, batch, per_step, device):
    """3 Adam steps of ``cfg``'s mode through the kernels from the weights
    ``initial``, held to the same steps through the plain versions (losses,
    and every gradient of step 1); each counter must rise by 3 x its
    ``per_step`` count and no other. Returns (step, model, losses,
    launches)."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step

    model = SMIN(cfg)
    model.load_state_dict(initial)
    step = make_train_step(cfg, model, build_optimizer(config, model), device=device)
    plain_model = SMIN(cfg).to(device)
    plain_model.load_state_dict(initial)
    plain_opt = build_optimizer(config, plain_model)
    counters = mode_counters()
    for fn in counters.values():
        fn.launches = 0
    reset_pair_counts()
    losses, plain_losses = [], []
    for k in range(TRAIN_STEPS):
        metrics = step(batch)
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        if not (losses[-1] == losses[-1] and abs(losses[-1]) < float("inf")):
            fail(f"{label} train step {k + 1}: loss {losses[-1]}")
        launches = dict({key: fn.launches for key, fn in counters.items()}, **pair_counts())
        plain_losses.append(float(plain_train_step(cfg, plain_model, plain_opt, batch)))
        if k == 0:
            if tuple(metrics["counts"].shape) != (2, 4) or metrics["counts"].device.type != "cuda":
                fail(f"{label} step 1: counts {tuple(metrics['counts'].shape)} on "
                     f"{metrics['counts'].device}")
            plain_grads = {n: p.grad for n, p in plain_model.named_parameters()}
            scale = max(float(g.abs().max()) for g in plain_grads.values())
            worst = 0.0
            for name, p in model.named_parameters():
                if p.grad is None:
                    fail(f"{label} step 1: parameter {name} has no gradient")
                worst = max(worst, grad_err(p.grad, plain_grads[name], scale,
                                            f"{label} step 1 gradient of {name}") / scale)
            print(f"{label}: step 1, {len(plain_grads)} parameter gradients finite and equal "
                  f"to the plain versions' within {worst:.3e} of the largest magnitude "
                  f"{scale:.3e}")
            del plain_grads
    want = {key: TRAIN_STEPS * per_step.get(key, 0) for key in launches}
    print(f"{label}: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, losses {losses}, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        fail(f"{label}: kernel launches of {TRAIN_STEPS} train steps: {launches}, expected {want}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"{label}: plain versions' losses {plain_losses}; max relative difference {worst:.3e} "
          f"(tolerance {TRAIN_LOSS_RTOL})")
    if worst > TRAIN_LOSS_RTOL:
        fail(f"{label}: losses differ from the plain versions' by {worst:.3e} > {TRAIN_LOSS_RTOL}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: 3 steps on one batch did not lower the loss: {losses}")
    del plain_model, plain_opt
    torch.cuda.empty_cache()
    return step, model, losses, launches


def phase_train(config, seed, rng, device):
    """3 Adam steps through the kernels at B=64, held to the same steps
    through the plain versions (`train_mode`); then one eval step. Returns
    the step function, the batch and the launch counts of the 3 steps."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    cfg = config.model
    n = cfg.num_smi_layers
    torch.manual_seed(seed + 1)
    initial = SMIN(cfg).state_dict()
    batch = {k: v.to(device) for k, v in synthetic_batch(cfg, TRAIN_BATCH, rng).items()}
    step, model, _, launches = train_mode(
        config, cfg, "training", initial, batch,
        {"K1f": 1, "K1b": 1, "K2": n, "K3": n, "CAf": 2 * n, "CAb": n}, device)
    check_eval_step(cfg, model, batch, device, "training")
    return step, batch, launches


def moment_cells(cfg, dense):
    """(i, j) of every moment: the packed pairs, or all L * L cells."""
    import numpy as np

    if dense:
        return np.repeat(np.arange(cfg.L), cfg.L), np.tile(np.arange(cfg.L), cfg.L)
    return np.triu_indices(cfg.L)


def proposal_bwd_work(cfg, mask, elem_bytes):
    """(additions, bytes) a proposal backward (K1, K6, K8 or their bf16
    variants) needs on these inputs: it reads the cotangent rows (C dfc and
    one dfm) of the unmasked moments only, the pairs i <= j whose mask is not
    0 (a (B, L) length mask's pair validity, or a (B, L, L) moment_mask on
    and above the diagonal), the pair masks and dfb, and writes df; it adds
    the frames of each of their clips and their clip means into fm, and the
    window means, twice (scatter and scan)."""
    import numpy as np

    from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

    B, L, C, D, T = mask.shape[0], cfg.L, cfg.C, cfg.D, cfg.T
    i, j = np.triu_indices(L)
    on = (packed_valid_mask(mask) if mask.dim() == 2 else mask[:, i, j]) != 0
    frames = content_segments(T, L, C).sizes[i, j].sum(axis=-1)
    per_moment = int((on.sum(dim=0).cpu().numpy() * (frames + C)).sum())
    moments = int(on.sum())
    adds = 2 * (per_moment + B * T) * D
    nbytes = elem_bytes * (B * T * D + moments * (C + 1) * D + B * L * D) + 4 * B * len(i)
    return adds, nbytes


def dense_content_matrix(cfg, device, dense=False):
    """Wc (P*C, T): the dense averaging matrix of the packed pairs (P = N),
    or of all L * L cells (``dense``; zero rows below the diagonal),
    n-major."""
    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.ops.content_matrix import content_segments

    seg = content_segments(cfg.T, cfg.L, cfg.C)
    cells = list(zip(*moment_cells(cfg, dense)))
    wc = np.zeros((len(cells), cfg.C, cfg.T), np.float32)
    for n, (i, j) in enumerate(cells):
        for c in range(cfg.C):
            s0, size = seg.starts[i, j, c], seg.sizes[i, j, c]
            wc[n, c, s0:s0 + size] = seg.weights[i, j, c]
    return torch.from_numpy(wc.reshape(len(cells) * cfg.C, cfg.T)).to(device)


def segment_adds(cfg, dense=False):
    """Additions per element and forward of the proposal pooling: the frames
    of every clip, the clip means into fm, the window means (for the packed
    pairs, or all L * L cells)."""
    from video_moment_localization_tpu_torch.ops.content_matrix import content_segments

    i, j = moment_cells(cfg, dense)
    sizes = content_segments(cfg.T, cfg.L, cfg.C).sizes[i, j]
    return int(sizes.sum()) * cfg.D + len(i) * cfg.C * cfg.D + cfg.T * cfg.D


def step_wall_ms(step, batch, iters=9):
    """Median wall ms of a train step that ends in a synchronize, after 2
    warm-ups."""
    import torch

    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[2:])


def phase_train_times(cfg, model, step, batch, rng, device):
    import torch

    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda

    B, L, C, D, T, Nq = TRAIN_BATCH, cfg.L, cfg.C, cfg.D, cfg.T, cfg.max_query_length
    N = L * (L + 1) // 2
    NC = N * C
    res = {}

    f, _, _, _, lmask, _ = stack_inputs(cfg, B, rng, device)
    out = proposal_cuda.proposal_features_packed(f, lmask, L, C)
    cots = [randn_like(t, rng) for t in out]
    wc = dense_content_matrix(cfg, device)
    carry_bytes = 4 * B * (NC + N + L) * D
    k1_bytes = 4 * (f.numel() + B * N) + carry_bytes
    seg_adds = segment_adds(cfg)
    b_ms, b_by = bound(B * seg_adds, k1_bytes)
    res["K1f"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_rows_forward(f, lmask, L, C)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_features_packed(f, lmask, L, C)),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f)), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(lambda: proposal_cuda.proposal_rows_forward(f, lmask, L, C)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f)))
    b_ms, b_by = bound(*proposal_bwd_work(cfg, lmask, 4))
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, NC, D)
    res["K1b"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_rows_backward(lmask, T, L, C, *cots)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_backward_plain(lmask, T, L, C,
                                                                            *cots)),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g)), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_rows_backward(lmask, T, L, C, *cots)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g)))

    weights = [w.detach() for w in block_weights(model.smis[1])]
    w_bytes = sum(w.numel() * 4 for w in weights)
    ins = layer_inputs(cfg, B, rng, device)
    shared_bytes = 4 * sum(t.numel() for t in ins[3:])
    flops = B * layer_flops(cfg, Nq)
    rest = B * layer_rest(cfg, Nq)
    b_ms, b_by, b32 = both_bounds(flops, 2 * carry_bytes + shared_bytes + w_bytes,
                                  gemm_flops(cfg, B, "K2"), rest)
    res["K2"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_layer_forward(weights, *ins, L)),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_layer_plain(weights, *ins, L)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_layer_forward(weights, *ins, L), launches=10, reps=3))
    dcu, dmu, dbu = [randn_like(t, rng) for t in ins[:3]]
    # In: the carry, its cotangents, the shared inputs, the weights; out: the
    # carry's, fw's and fs's gradients and the weight gradients. The layer's
    # output is recomputed, not moved.
    k3_bytes = 3 * carry_bytes + 2 * shared_bytes + 2 * w_bytes
    b_ms, b_by, b32 = both_bounds(3 * flops, k3_bytes, gemm_flops(cfg, B, "K3"), 3 * rest)
    res["K3"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu),
                   iters=9),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_layer_backward_plain(
            weights, *ins, L, dcu, dmu, dbu), iters=9),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu),
            launches=5, reps=3))
    res["K3_no_dcu_ms"] = cuda_ms(
        lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, None, dmu, dbu), iters=9)
    for k in ("K1f", "K1b", "K2", "K3"):
        r = res[k]
        print(f"time {k} B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", all-fp32 bound {r['bound_fp32_ms']:.4f} ms, back to back "
                 f"{r['device_ms']:.4f} ms" if "bound_fp32_ms" in r else ""))
    print_back_to_back(res, ("K1f", "K1b"), f"B={B}")
    print(f"time K3 B={B} without dcu (top layer): {res['K3_no_dcu_ms']:.4f} ms")

    res["step_ms"] = step_wall_ms(step, batch, iters=12)
    res["step_event_ms"] = cuda_ms(lambda: step(batch), warmup=0, iters=9)
    print(f"time train step B={B}: {res['step_ms']:.4f} ms wall, {res['step_event_ms']:.4f} ms "
          f"between CUDA events, {B / res['step_ms'] * 1e3:.1f} samples/s; launches per step: "
          f"K1 1 + 1, K2 {cfg.num_smi_layers}, K3 {cfg.num_smi_layers}")
    return res


# ------------------------------------------------------------------------- #
# ActivityNet slice: the content-unit train path (K6, K7)
# ------------------------------------------------------------------------- #
def content_flops(cfg, Nq):
    """ops/content_train_pallas.py:337-341 of the JAX package, per element:
    the content unit over N * C rows and the folded conv_fc."""
    L, C, D, dl = cfg.L, cfg.C, cfg.D, cfg.dl
    N = L * (L + 1) // 2
    return (2 * N * C * (2 * D * dl + dl * dl + 2 * Nq * dl + 2 * C * dl + dl * D)
            + 2 * N * D * D)


def content_inputs(cfg, B, rng, device, pin=False):
    """(fc, fbar, fw, fs, qmask, vmask) of K7 and the length mask."""
    from video_moment_localization_tpu_torch.models.smin import moment_gate

    fc, fm, _, fw, fs, qmask, lmask, vmask = layer_inputs(cfg, B, rng, device, pin)
    return [fc, moment_gate(fm, fs).contiguous(), fw, fs, qmask, vmask], lmask


def phase_anet_parity(cfg, model, rng, device):
    """K6 and K7 forward and backward against their plain versions at the
    ActivityNet width, at the main path's B=64 and at B=8 and B=2, with
    pinned ragged cases; K5 and K4 at that width at B=64 and B=8. Returns the
    largest max abs error of each over the sizes."""
    import torch

    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.ops import (
        content_train_cuda,
        lstm_cuda,
        proposal_cuda,
        smin_cuda,
    )

    errs = {"K6f": 0.0, "K6b": 0.0, "K7f": 0.0, "K7b": 0.0, "K7b_rel": 0.0}
    weights = [w.detach() for w in content_train_cuda.content_weights(model.smis[1])]
    for B in ANET_PARITY_BATCHES:
        f, _, _, _, lmask, _ = stack_inputs(cfg, B, rng, device, pin=True)
        got = proposal_cuda.proposal_packed_forward(f, lmask, cfg.L, cfg.C)
        want = proposal_cuda.proposal_features_packed(f, lmask, cfg.L, cfg.C)
        torch.cuda.synchronize()
        e1 = max_err(got, want, K1_TOL, f"K6 proposal_packed_forward B={B}")
        cots = [randn_like(t, rng) for t in want]
        dgot = proposal_cuda.proposal_packed_backward(lmask, cfg.T, cfg.L, cfg.C, *cots)
        dwant = proposal_cuda.proposal_backward_plain(lmask, cfg.T, cfg.L, cfg.C, *cots)
        torch.cuda.synchronize()
        # A frame gathers up to 1,024 pairs here: its sum is held like the
        # other gradients, relative to the gradient's magnitude.
        e2 = grad_err(dgot, dwant, float(dwant.abs().max()), f"K6 proposal_packed_backward B={B}")
        check_repeatable(dgot, lambda: proposal_cuda.proposal_packed_backward(
            lmask, cfg.T, cfg.L, cfg.C, *cots), f"K6 proposal_packed_backward B={B}")
        print(f"parity K6 packed proposal B={B}: forward max abs err {e1:.3e} (tolerance "
              f"{K1_TOL}), backward {e2:.3e} of magnitude {float(dwant.abs().max()):.3e} "
              f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude), a second launch "
              f"equal bit for bit")
        errs["K6f"], errs["K6b"] = max(errs["K6f"], e1), max(errs["K6b"], e2)
        del got, want, cots, dgot, dwant

        ins, _ = content_inputs(cfg, B, rng, device, pin=True)
        got = content_train_cuda.content_rows_forward(weights, *ins)
        want = content_train_cuda.content_rows_plain(weights, *ins)
        torch.cuda.synchronize()
        e = max_err(got, want, K4_TOL, f"K7 content_rows_forward B={B}")
        print(f"parity K7 content_rows_forward B={B}: cu and convfc, max abs err {e:.3e} "
              f"(tolerance {K4_TOL})")
        errs["K7f"] = max(errs["K7f"], e)
        dcu, dconv = [randn_like(t, rng) for t in want]
        del got, want
        for cot in (dcu, None):
            got = content_train_cuda.content_rows_backward(weights, *ins, cot, dconv)
            if cot is not None:
                check_all_repeatable(got, content_train_cuda.content_rows_backward(
                    weights, *ins, cot, dconv), f"K7 content_rows_backward B={B}")
                print(f"repeatable K7 content_rows_backward B={B}: 18 gradients of a second "
                      f"launch equal bit for bit")
            want = content_train_cuda.content_rows_backward_plain(weights, *ins, cot, dconv)
            torch.cuda.synchronize()
            worst, rel = gradient_set_err(got, want, ("dfc", "dfbar", "dfw", "dfs"),
                                          f"K7 B={B}")
            print(f"parity K7 content_rows_backward B={B} dcu={'yes' if cot is not None else 'none'}"
                  f": 18 gradients, max abs err {worst:.3e}, {rel:.3e} of the magnitude "
                  f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude)")
            errs["K7b"], errs["K7b_rel"] = max(errs["K7b"], worst), max(errs["K7b_rel"], rel)
            del got, want
        del ins, dcu, dconv
        torch.cuda.empty_cache()

    layers = lstm_layers(model.backbone.queryencoder.lstm)
    errs["K5"] = errs["K4"] = 0.0
    for B in ANET_PARITY_BATCHES[:2]:
        x, mask, _ = lstm_inputs(cfg, B, rng, device)
        e5 = max_err([lstm_cuda.bilstm_fused(x, mask, layers)],
                     [lstm_cuda.bilstm_plain(x, mask, layers)], K5_TOL, f"K5 at Nq=20 B={B}")
        ins = stack_inputs(cfg, B, rng, device, pin=True)
        e4 = max_err(smin_cuda.smin_stack_fused(model, cfg, *ins),
                     smin_cuda.smin_stack_plain(model, cfg, *ins), K4_TOL, f"K4 at L=64 B={B}")
        torch.cuda.synchronize()
        print(f"parity at the ActivityNet width B={B}: K5 (Nq=20) max abs err {e5:.3e} "
              f"(tolerance {K5_TOL}), K4 (L=64) {e4:.3e} (tolerance {K4_TOL})")
        errs["K5"], errs["K4"] = max(errs["K5"], e5), max(errs["K4"], e4)
        del x, mask, ins
        torch.cuda.empty_cache()
    return errs


def phase_anet_train(config, seed, rng, device):
    """Step-1 gradients at B=8 against the plain versions, then 3 Adam steps
    at B=64 through K6 and K7 and one eval step held to the plain versions.
    Returns the step function, the B=64 batch, the launch counts of the 3
    steps, the peak memory and the eval forward's max abs error."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    cfg = config.model
    torch.manual_seed(seed + 2)
    model = SMIN(cfg)
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    # One step at the batch the plain versions can hold: every gradient.
    B = ANET_STEP_PARITY_BATCH
    small = {k: v.to(device) for k, v in synthetic_batch(cfg, B, rng).items()}
    plain_model = SMIN(cfg).to(device)
    plain_model.load_state_dict(initial)
    loss = float(make_train_step(cfg, model, build_optimizer(config, model),
                                 device=device)(small)["loss"])
    plain_loss = float(plain_train_step(cfg, plain_model, build_optimizer(config, plain_model),
                                        small))
    torch.cuda.synchronize()
    plain_grads = {n: p.grad for n, p in plain_model.named_parameters()}
    scale = max(float(g.abs().max()) for g in plain_grads.values())
    worst = 0.0
    for name, p in model.named_parameters():
        if p.grad is None:
            fail(f"ActivityNet step at B={B}: parameter {name} has no gradient")
        worst = max(worst, grad_err(p.grad, plain_grads[name], scale,
                                    f"ActivityNet step at B={B}, gradient of {name}") / scale)
    if abs(loss - plain_loss) > 1e-5 * abs(plain_loss):
        fail(f"ActivityNet step at B={B}: loss {loss} against the plain versions' {plain_loss}")
    print(f"ActivityNet training: B={B} step, loss {loss:.6f} (plain versions {plain_loss:.6f}), "
          f"{len(plain_grads)} parameter gradients finite and equal to the plain versions' "
          f"within {worst:.3e} of the largest magnitude {scale:.3e}")
    del plain_model, plain_grads, small
    torch.cuda.empty_cache()

    # The main path: B=64 from the same initial weights, a fresh optimizer.
    model.load_state_dict(initial)
    model.zero_grad(set_to_none=True)
    step = make_train_step(cfg, model, build_optimizer(config, model), device=device)
    batch = {k: v.to(device) for k, v in synthetic_batch(cfg, TRAIN_BATCH, rng).items()}
    counters = mode_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    reset_pair_counts()
    losses = []
    for k in range(TRAIN_STEPS):
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        if not (losses[-1] == losses[-1] and abs(losses[-1]) < float("inf")):
            fail(f"ActivityNet train step {k + 1}: loss {losses[-1]}")
    launches = dict({k: fn.launches for k, fn in counters.items()}, **pair_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_layers = cfg.num_smi_layers
    want = dict({k: 0 for k in launches}, K6f=TRAIN_STEPS, K6b=TRAIN_STEPS,
                K7f=TRAIN_STEPS * n_layers, K7b=TRAIN_STEPS * n_layers,
                CAf=2 * TRAIN_STEPS * n_layers, CAb=TRAIN_STEPS * n_layers)
    print(f"ActivityNet training: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, losses {losses}, "
          f"launches { {k: v for k, v in launches.items() if v} }, peak device memory "
          f"{peak:.3f} GiB")
    if launches != want:
        fail(f"kernel launches of {TRAIN_STEPS} ActivityNet train steps: {launches}, "
             f"expected {want}")
    for name, p in model.named_parameters():
        if not torch.isfinite(p).all():
            fail(f"ActivityNet training: parameter {name} is not finite after the steps")
    if not losses[-1] < losses[0]:
        fail(f"3 ActivityNet steps on one batch did not lower the loss: {losses}")

    eval_err = check_eval_step(cfg, model, batch, device, "ActivityNet training")
    torch.cuda.empty_cache()
    return (step, batch, {k: launches[k] for k in ("K6f", "K6b", "K7f", "K7b", "CAf", "CAb")},
            peak, eval_err)


def phase_anet_times(cfg, model, step, batch, rng, device):
    import torch

    from video_moment_localization_tpu_torch.ops import content_train_cuda, proposal_cuda
    from video_moment_localization_tpu_torch.utils.profile_serving import profile_and_report

    B, L, C, D, T, Nq = TRAIN_BATCH, cfg.L, cfg.C, cfg.D, cfg.T, cfg.max_query_length
    N = L * (L + 1) // 2
    NC = N * C
    res = {}

    # The eval step's kernels at this width (L=64, Nq=20).
    serving, _ = serving_kernel_times(cfg, model, B, rng, device,
                                      cudnn_lstm(cfg, model, device), iters=5)
    for k in ("K5", "K4"):
        r = res[k] = serving[k]
        print(f"time {k} ActivityNet B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    torch.cuda.empty_cache()

    f, _, _, _, lmask, _ = stack_inputs(cfg, B, rng, device)
    cots = [randn_like(t, rng) for t in proposal_cuda.proposal_features_packed(f, lmask, L, C)]
    wc = dense_content_matrix(cfg, device)
    carry_bytes = 4 * B * (NC + N + L) * D
    k6_bytes = 4 * (f.numel() + B * N) + carry_bytes
    seg_adds = segment_adds(cfg)
    b_ms, b_by = bound(B * seg_adds, k6_bytes)
    res["K6f"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_packed_forward(f, lmask, L, C), iters=9),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_features_packed(f, lmask, L, C), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f), iters=9), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_packed_forward(f, lmask, L, C), launches=5),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f), launches=5))
    b_ms, b_by = bound(*proposal_bwd_work(cfg, lmask, 4))
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, NC, D)
    res["K6b"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_packed_backward(lmask, T, L, C, *cots), iters=9),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_backward_plain(lmask, T, L, C,
                                                                            *cots), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g), iters=9), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_packed_backward(lmask, T, L, C, *cots), launches=5),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g), launches=5))
    del f, cots, g, wc, wct

    weights = [w.detach() for w in content_train_cuda.content_weights(model.smis[1])]
    w_bytes = sum(w.numel() * 4 for w in weights)
    ins, _ = content_inputs(cfg, B, rng, device)
    rows_bytes = 4 * B * (NC + N) * D                  # fc and fbar, or cu and convfc
    shared_bytes = 4 * sum(t.numel() for t in ins[2:])
    flops = B * content_flops(cfg, Nq)
    rest = B * unit_rest(cfg, Nq)
    workspace = content_train_cuda.Workspace()
    b_ms, b_by, b32 = both_bounds(flops, 2 * rows_bytes + shared_bytes + w_bytes,
                                  gemm_flops(cfg, B, "K7f"), rest)
    res["K7f"] = dict(
        ms=cuda_ms(lambda: content_train_cuda.content_rows_forward(weights, *ins, workspace),
                   iters=9),
        plain_ms=cuda_ms(lambda: content_train_cuda.content_rows_plain(weights, *ins),
                         warmup=1, iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32)
    dcu, dconv = randn_like(ins[0], rng), randn_like(ins[1], rng)
    # In: fc and fbar, their cotangents dcu and dconvfc, the shared inputs,
    # the weights; out: the gradients of fc, fbar, fw, fs and of the
    # weights. Three carries of rows: the recomputed cu the port keeps in
    # dfc is its own, not the function's.
    b_ms, b_by, b32 = both_bounds(3 * flops, 3 * rows_bytes + 2 * shared_bytes + 2 * w_bytes,
                                  gemm_flops(cfg, B, "K7b"), 3 * rest)
    res["K7b"] = dict(
        ms=cuda_ms(lambda: content_train_cuda.content_rows_backward(weights, *ins, dcu, dconv,
                                                                    workspace), iters=7),
        plain_ms=cuda_ms(lambda: content_train_cuda.content_rows_backward_plain(
            weights, *ins, dcu, dconv), warmup=1, iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32)
    res["K7b_no_dcu_ms"] = cuda_ms(
        lambda: content_train_cuda.content_rows_backward(weights, *ins, None, dconv, workspace),
        iters=7)
    del ins, dcu, dconv, workspace
    torch.cuda.empty_cache()
    for k in ("K6f", "K6b", "K7f", "K7b"):
        r = res[k]
        print(f"time {k} ActivityNet B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    print(f"time K7b ActivityNet B={B} without dcu (top layer): {res['K7b_no_dcu_ms']:.4f} ms")
    print_back_to_back(res, ("K6f", "K6b"), f"ActivityNet B={B}")

    res["step_ms"] = step_wall_ms(step, batch)
    print(f"time ActivityNet train step B={B}: {res['step_ms']:.4f} ms wall, "
          f"{B / res['step_ms'] * 1e3:.1f} samples/s; launches per step: K6 1 + 1, "
          f"K7 {cfg.num_smi_layers} + {cfg.num_smi_layers}")
    profile_and_report(lambda: step(batch), f"ActivityNet B={B}", "train step", 3, top=14)
    return res


# ------------------------------------------------------------------------- #
# The reference-compat modes: K8 (dense proposal), K9 (all layers' forward in
# one launch), K10 (the fused content unit of the packed unit loop)
# ------------------------------------------------------------------------- #
def dense_moment_mask(lmask):
    """(B, L, L) moment_mask of a length mask: the valid pairs (i <= j), as
    data/labels.py::build_masks makes it."""
    import torch

    return torch.triu(lmask[:, :, None] * lmask[:, None, :]).contiguous()


def unit_flops(cfg, Nq):
    """ops/content_pallas.py:243-244 of the JAX package, per element: the
    content unit over N * C rows (K7's without the folded conv_fc). Per row:
    c_hat D*dl, W_q dl*dl, scores and values 2*Nq*dl, the clip attention
    2*C*dl, c_out dl*D."""
    L, C, D, dl = cfg.L, cfg.C, cfg.D, cfg.dl
    N = L * (L + 1) // 2
    return 2 * N * C * (2 * D * dl + dl * dl + 2 * Nq * dl + 2 * C * dl)


def phase_mode_parity(cfg, model, anet_cfg, rng, device):
    """K8 forward and backward, K9 and K10 forward and backward against their
    plain versions at the full Charades width, B=64 and B=4, ragged masks
    (one video cut to L/2, one query of one word); K9 also bit for bit
    against one K2 launch per layer; K8 at the ActivityNet width at B=8.
    Returns the largest max abs error of each over the sizes."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops import content_cuda, proposal_cuda, smin_train_cuda

    errs = {k: 0.0 for k in ("K8f", "K8b", "K8b_rel", "K9", "K10f", "K10b", "K10b_rel")}
    unit_w = [w.detach() for w in content_cuda.unit_weights(model.smis[1].content_unit)]
    stack_w = [w.detach() for b in model.smis for w in block_weights(b)]
    n_layers = cfg.num_smi_layers

    def k8(c, B, label):
        f, _, _, _, lmask, _ = stack_inputs(c, B, rng, device, pin=True)
        mm = dense_moment_mask(lmask)
        got = proposal_cuda.proposal_dense_forward(f, mm, c.L, c.C)
        want = proposal_cuda.proposal_features(f, mm, c.L, c.C)
        torch.cuda.synchronize()
        e1 = max_err(got, want, K1_TOL, f"K8 proposal_dense_forward {label} B={B}")
        below = torch.ones(c.L, c.L, device=device).tril(-1).bool()
        if bool((got[0][:, below] != 0).any()) or bool((got[1][:, below] != 0).any()):
            fail(f"K8 {label} B={B}: a cell below the diagonal is not 0")
        cots = [randn_like(t, rng) for t in want]
        del got, want
        dgot = proposal_cuda.proposal_dense_backward(mm, c.T, c.L, c.C, *cots)
        dwant = proposal_cuda.proposal_backward_plain(mm, c.T, c.L, c.C, *cots)
        torch.cuda.synchronize()
        scale = float(dwant.abs().max())
        e2 = grad_err(dgot, dwant, scale, f"K8 proposal_dense_backward {label} B={B}")
        check_repeatable(dgot, lambda: proposal_cuda.proposal_dense_backward(
            mm, c.T, c.L, c.C, *cots), f"K8 proposal_dense_backward {label} B={B}")
        print(f"parity K8 dense proposal {label} B={B}: forward max abs err {e1:.3e} (tolerance "
              f"{K1_TOL}), backward {e2:.3e} of magnitude {scale:.3e} (rtol {GRAD_RTOL}, atol "
              f"{GRAD_ATOL_REL} of the magnitude), a second launch equal bit for bit")
        errs["K8f"], errs["K8b"] = max(errs["K8f"], e1), max(errs["K8b"], e2)
        errs["K8b_rel"] = max(errs["K8b_rel"], e2 / scale)

    for B in (TRAIN_BATCH, 4):
        k8(cfg, B, "Charades")
        ins = layer_inputs(cfg, B, rng, device, pin=True)
        fm_o, fb_o, carries = smin_train_cuda.smi_stack_forward(stack_w, *ins, cfg.L)
        carry = tuple(ins[:3])
        for k in range(n_layers):
            if not all(torch.equal(a, b) for a, b in zip(carries[k], carry)):
                fail(f"K9 B={B}: layer {k}'s input carry differs from the K2 launches'")
            carry = smin_train_cuda.smi_layer_forward(stack_w[20 * k:20 * (k + 1)], *carry,
                                                      *ins[3:], cfg.L)
        if not (torch.equal(fm_o, carry[1]) and torch.equal(fb_o, carry[2])):
            fail(f"K9 B={B}: the outputs differ from {n_layers} K2 launches'")
        # Each layer against the plain layer on its input carry (the
        # rounding of three layers compounds past K2's tolerance).
        outs = list(carries[1:]) + [(fm_o, fb_o)]
        e = 0.0
        for k in range(n_layers):
            e = max(e, layer_err(outs[k], stack_w[20 * k:20 * (k + 1)], carries[k], ins[3:],
                                 cfg.L, f"K9 smi_stack_forward B={B} layer {k}"))
        torch.cuda.synchronize()
        print(f"parity K9 smi_stack_forward B={B}: equal bit for bit to {n_layers} K2 launches "
              f"(outputs and carries); each layer against the plain layer on its input carry, "
              f"max abs err {e:.3e} (tolerance {K4_TOL})")
        errs["K9"] = max(errs["K9"], e)
        del fm_o, fb_o, carries, carry, outs

        fc, fm, _, fw, fs, qmask, _, vmask = ins
        uins = (fc, fm, fw, fs, qmask, vmask)
        got = content_cuda.content_unit_forward(unit_w, *uins)
        want = content_cuda.content_unit_plain(unit_w, *uins)
        torch.cuda.synchronize()
        e = max_err([got], [want], K4_TOL, f"K10 content_unit_forward B={B}")
        dcu = randn_like(got, rng)
        del got, want
        got = content_cuda.content_unit_backward(unit_w, *uins, dcu)
        want = content_cuda.content_unit_backward_plain(unit_w, *uins, dcu)
        torch.cuda.synchronize()
        worst, rel = gradient_set_err(got, want, ("dfc", "dfm", "dfw", "dfs"), f"K10 B={B}")
        print(f"parity K10 content_unit B={B}: forward max abs err {e:.3e} (tolerance {K4_TOL}); "
              f"backward 16 gradients, max abs err {worst:.3e}, {rel:.3e} of the magnitude "
              f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude)")
        errs["K10f"] = max(errs["K10f"], e)
        errs["K10b"], errs["K10b_rel"] = max(errs["K10b"], worst), max(errs["K10b_rel"], rel)
        del got, want, ins, uins, dcu
        torch.cuda.empty_cache()
    k8(anet_cfg, 8, "ActivityNet")
    torch.cuda.empty_cache()
    return errs


def check_mode_eval(cfg, model, batch, label):
    """One eval step of the mode on the card, its loss and recall counts held
    to the same eval step on the CPU (the plain versions) on the same batch
    and weights."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel.steps import make_eval_step

    ev = make_eval_step(cfg, model, device=model.localization.conv_layer_pm.weight.device)(batch)
    torch.cuda.synchronize()
    cpu_model = SMIN(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref = make_eval_step(cfg, cpu_model, device="cpu")({k: v.cpu() for k, v in batch.items()})
    loss, ref_loss = float(ev["loss"]), float(ref["loss"])
    if abs(loss - ref_loss) > EVAL_LOSS_RTOL * abs(ref_loss):
        fail(f"{label}: eval loss {loss} on the card, {ref_loss} on the CPU")
    if not torch.equal(ev["counts"].cpu(), ref["counts"]):
        fail(f"{label}: eval recall counts {ev['counts'].tolist()} on the card, "
             f"{ref['counts'].tolist()} on the CPU")
    print(f"{label}: eval step at B={TRAIN_BATCH}, loss {loss:.6f} (CPU {ref_loss:.6f}, rtol "
          f"{EVAL_LOSS_RTOL}), recall counts equal to the CPU's: {ev['counts'].flatten().tolist()}")


def phase_modes(config, seed, rng, device):
    """The three modes at the full Charades width, B=64, 3 Adam steps each:
    ``packed: False`` (K8), ``compat_head`` + ``fused_content`` (K6, K10) and
    the default route under VML_SMIN_TRAIN_FUSED_FWD=1 (K1, K9, K3), each held
    to the plain versions; the dense step-1 loss against the packed route's,
    the K9 route's losses against the per-layer route's bit for bit; an eval
    step per mode against the CPU; the compat localizer against the CPU's.
    Returns {mode: (step, model, batch, launches)}."""
    import dataclasses

    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    cfg = config.model
    n = cfg.num_smi_layers
    dense_cfg = dataclasses.replace(cfg, packed=False)
    compat_cfg = dataclasses.replace(cfg, compat_head=True, fused_content=True)
    # One draw of the batch in both label layouts.
    draws = int(rng.integers(2**31))
    packed_batch, dense_batch = (
        {k: v.to(device) for k, v in synthetic_batch(c, TRAIN_BATCH,
                                                     np.random.default_rng(draws)).items()}
        for c in (cfg, dense_cfg))
    torch.manual_seed(seed + 3)
    initial = SMIN(cfg).state_dict()
    out = {}
    for mode, c, batch, per_step in (
            ("dense", dense_cfg, dense_batch, {"K8f": 1, "K8b": 1}),
            ("compat", compat_cfg, dense_batch,
             {"K6f": 1, "K6b": 1, "K10f": n, "K10b": n, "CAf": 2 * n, "CAb": n})):
        step, model, losses, launches = train_mode(config, c, mode, initial, batch, per_step,
                                                   device)
        check_mode_eval(c, model, batch, mode)
        out[mode] = (step, model, batch, launches, losses)

    previous = os.environ.get("VML_SMIN_TRAIN_FUSED_FWD")
    os.environ["VML_SMIN_TRAIN_FUSED_FWD"] = "1"
    try:
        step, model, losses, launches = train_mode(
            config, cfg, "fused_fwd", initial, packed_batch,
            {"K1f": 1, "K1b": 1, "K9": 1, "K3": n, "CAf": 2 * n, "CAb": n}, device)
        check_mode_eval(cfg, model, packed_batch, "fused_fwd")
    finally:
        if previous is None:
            del os.environ["VML_SMIN_TRAIN_FUSED_FWD"]
        else:
            os.environ["VML_SMIN_TRAIN_FUSED_FWD"] = previous
    out["fused_fwd"] = (step, model, packed_batch, launches, losses)
    # The same steps through one K2 per layer: the same bits.
    _, _, layer_losses, _ = train_mode(config, cfg, "per-layer", initial, packed_batch,
                                       {"K1f": 1, "K1b": 1, "K2": n, "K3": n, "CAf": 2 * n,
                                        "CAb": n}, device)
    if losses != layer_losses:
        fail(f"the K9 route's losses {losses} differ from the per-layer route's {layer_losses}")
    print(f"fused_fwd: losses equal bit for bit to the per-layer route's {layer_losses}")
    dense_first, packed_first = out["dense"][4][0], layer_losses[0]
    rel = abs(dense_first - packed_first) / abs(packed_first)
    print(f"dense: step-1 loss {dense_first} against the packed route's {packed_first}, relative "
          f"difference {rel:.3e} (tolerance {DENSE_PACKED_RTOL})")
    if rel > DENSE_PACKED_RTOL:
        fail(f"the dense step-1 loss differs from the packed one by {rel:.3e}")

    check_compat_localizer(compat_cfg, out["compat"][1], rng)
    return out


def check_compat_localizer(cfg, model, rng):
    """`MomentLocalizer` in the compat mode on the card serving 24 requests:
    K6 and K10 launch, and the top-k equals the CPU localizer's."""
    import torch

    from video_moment_localization_tpu_torch.data.glove import WordEmbedding
    from video_moment_localization_tpu_torch.inference import MomentLocalizer
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.ops import content_cuda, proposal_cuda

    words = sorted({w for q in QUERIES for w in q.split()} - {"xylophone"})
    emb = WordEmbedding.synthetic(words, dim=cfg.word_dim, seed=1)
    cpu_model = SMIN(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gpu = MomentLocalizer(cfg, model, emb, serve_batch=16)
    cpu = MomentLocalizer(cfg, cpu_model, emb, serve_batch=16, device="cpu")
    reqs = requests(cfg, rng)
    before = (proposal_cuda.proposal_packed_forward.launches,
              content_cuda.content_unit_forward.launches)
    out = gpu.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    launched = (proposal_cuda.proposal_packed_forward.launches - before[0],
                content_cuda.content_unit_forward.launches - before[1])
    if min(launched) < 1:
        fail(f"compat serving: K6 / K10 launched {launched} times")
    worst = 0.0
    for k, (g, c) in enumerate(zip(out, cpu.localize_batch(reqs, top_k=5))):
        if [(m.start, m.end) for m in g] != [(m.start, m.end) for m in c]:
            fail(f"compat request {k}: top-k {[(m.start, m.end) for m in g]} on the card, "
                 f"{[(m.start, m.end) for m in c]} on the CPU")
        worst = max([worst] + [abs(mg.score - mc.score) for mg, mc in zip(g, c)])
    if worst > SCORE_TOL:
        fail(f"compat serving: scores differ from the CPU's by {worst:.3e} > {SCORE_TOL}")
    print(f"compat serving: {len(reqs)} requests, K6 / K10 launches {launched}, top-k equal to "
          f"the CPU localizer's, max score diff {worst:.3e} (tolerance {SCORE_TOL})")


def phase_mode_times(cfg, model, modes, rng, device):
    """Times at B=64: K8 forward and backward with the one matmul against
    the dense Wc (L*L*C, T), K9 against one K2 per layer, K10 forward and
    backward, each with its plain version and bound; the dense and compat
    train steps."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops import content_cuda, proposal_cuda, smin_train_cuda

    B, L, C, D, T, Nq = TRAIN_BATCH, cfg.L, cfg.C, cfg.D, cfg.T, cfg.max_query_length
    N = L * (L + 1) // 2
    n_layers = cfg.num_smi_layers
    res = {}

    f, _, _, _, lmask, _ = stack_inputs(cfg, B, rng, device)
    mm = dense_moment_mask(lmask)
    out = proposal_cuda.proposal_features(f, mm, L, C)
    cots = [randn_like(t, rng) for t in out]
    wc = dense_content_matrix(cfg, device, dense=True)
    k8_bytes = 4 * (f.numel() + mm.numel() + sum(t.numel() for t in out))
    adds = segment_adds(cfg, dense=True)
    b_ms, b_by = bound(B * adds, k8_bytes)
    res["K8f"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_dense_forward(f, mm, L, C)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_features(f, mm, L, C)),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f)), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(lambda: proposal_cuda.proposal_dense_forward(f, mm, L, C)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f)))
    # The backward visits the i <= j cells only: it reads the mask of those,
    # dfc and dfm of the unmasked ones, with dfb, and writes df, as K1's does.
    b_ms, b_by = bound(*proposal_bwd_work(cfg, mm, 4))
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, L * L * C, D)
    res["K8b"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_backward_plain(mm, T, L, C, *cots)),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g)), bound_ms=b_ms, bound_by=b_by,
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g)))
    del f, out, cots, wc, wct, g

    stack_w = [w.detach() for b in model.smis for w in block_weights(b)]
    w_bytes = sum(w.numel() * 4 for w in stack_w)
    ins = layer_inputs(cfg, B, rng, device)
    carry_bytes = 4 * B * (N * C + N + L) * D
    shared_bytes = 4 * sum(t.numel() for t in ins[3:])
    # In: the carry, the shared inputs, every layer's weights; out: the inner
    # layers' carries and the top layer's (cu, mu, bu).
    b_ms, b_by, b32 = both_bounds(n_layers * B * layer_flops(cfg, Nq),
                                  (n_layers + 1) * carry_bytes + shared_bytes + w_bytes,
                                  gemm_flops(cfg, B, "K9", n_layers),
                                  n_layers * B * layer_rest(cfg, Nq))

    def per_layer():
        carry = tuple(ins[:3])
        for k in range(n_layers):
            carry = smin_train_cuda.smi_layer_forward(stack_w[20 * k:20 * (k + 1)], *carry,
                                                      *ins[3:], L)

    res["K9"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_stack_forward(stack_w, *ins, L)),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_stack_plain(stack_w, *ins, L)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_stack_forward(stack_w, *ins, L), launches=5, reps=3))
    res["K9_per_layer_ms"] = cuda_ms(per_layer)

    unit_w = [w.detach() for w in content_cuda.unit_weights(model.smis[1].content_unit)]
    uw_bytes = sum(w.numel() * 4 for w in unit_w)
    fc, fm, _, fw, fs, qmask, _, vmask = ins
    uins = (fc, fm, fw, fs, qmask, vmask)
    rows_bytes = 4 * B * N * C * D
    side_bytes = 4 * sum(t.numel() for t in (fm, fw, fs, qmask, vmask))
    flops = B * unit_flops(cfg, Nq)
    rest = B * unit_rest(cfg, Nq)
    workspace = content_cuda.Workspace()
    b_ms, b_by, b32 = both_bounds(flops, 2 * rows_bytes + side_bytes + uw_bytes,
                                  gemm_flops(cfg, B, "K10f"), rest)
    res["K10f"] = dict(
        ms=cuda_ms(lambda: content_cuda.content_unit_forward(unit_w, *uins, workspace)),
        plain_ms=cuda_ms(lambda: content_cuda.content_unit_plain(unit_w, *uins)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
        device_ms=cuda_ms_back_to_back(
            lambda: content_cuda.content_unit_forward(unit_w, *uins, workspace)))
    dcu = randn_like(fc, rng)
    # In: the inputs, dcu, the weights; out: dfc, dfm, dfw, dfs and the
    # weight gradients.
    b_ms, b_by, b32 = both_bounds(3 * flops, 3 * rows_bytes + 2 * side_bytes + 2 * uw_bytes,
                                  gemm_flops(cfg, B, "K10b"), 3 * rest)
    res["K10b"] = dict(
        ms=cuda_ms(lambda: content_cuda.content_unit_backward(unit_w, *uins, dcu, workspace),
                   iters=9),
        plain_ms=cuda_ms(lambda: content_cuda.content_unit_backward_plain(unit_w, *uins, dcu),
                         iters=9),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
        device_ms=cuda_ms_back_to_back(
            lambda: content_cuda.content_unit_backward(unit_w, *uins, dcu, workspace),
            launches=10, reps=3))
    del ins, uins, dcu, workspace
    torch.cuda.empty_cache()
    for k in ("K8f", "K8b", "K9", "K10f", "K10b"):
        r = res[k]
        print(f"time {k} B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"time K9 B={B}: {n_layers} K2 launches {res['K9_per_layer_ms']:.4f} ms")
    print_back_to_back(res, ("K8f", "K8b"), f"B={B}")

    for mode in ("dense", "compat"):
        step, _, batch, _, _ = modes[mode]
        res[f"{mode}_step_ms"] = step_wall_ms(step, batch)
        print(f"time {mode} train step B={B}: {res[f'{mode}_step_ms']:.4f} ms wall, "
              f"{B / res[f'{mode}_step_ms'] * 1e3:.1f} samples/s")
    return res


# ------------------------------------------------------------------------- #
# The shared GEMM and K5's plan
# ------------------------------------------------------------------------- #
PLAN_BATCHES = (1, 16, 64, 512)


def phase_plans(configs):
    """Holds the Python mirrors of the GEMM's, the content-attention pair's
    and K5's host-side plans against the C code on this card. Returns K5's
    plan at B=16/64/512."""
    import torch

    from video_moment_localization_tpu_torch.ops import content_attn_cuda, gemm_cuda, lstm_cuda

    held = pair_held = held_bf16 = 0
    for name, cfg in configs:
        N = cfg.L * (cfg.L + 1) // 2
        for B in PLAN_BATCHES:
            for Nq in range(1, cfg.max_query_length + 1):
                # fp32 (and the bf16 forward, which stages fp32 rows) and the
                # bf16 backward's own layout.
                for backward, bf16 in ((False, False), (True, False), (True, True)):
                    args = (B, N, cfg.C, Nq, cfg.dl, backward, bf16)
                    got = content_attn_cuda.card_plan(*args)
                    want = content_attn_cuda.plan(*args)
                    if got != want or not want["smem"]:
                        fail(f"pair plan {name} B={B} Nq={Nq} backward={backward} bf16={bf16}: "
                             f"C {got}, Python mirror {want}")
                    pair_held += 1
                for bf16 in (False, True):
                    got = content_attn_cuda.card_partial_floats(*args[:5], bf16)
                    if got != content_attn_cuda.partial_floats(*args[:5], bf16):
                        fail(f"pair partial floats {name} B={B} Nq={Nq} bf16={bf16}: C {got}, "
                             f"Python mirror {content_attn_cuda.partial_floats(*args[:5], bf16)}")
            for kernel, prod, layout, M, N, K, groups in gemm_cuda.model_gemm_shapes(cfg, B):
                got = gemm_cuda.card_plan(layout, M, N, K, groups, prod)
                want = gemm_cuda.plan(layout, M, N, K, groups, prod)
                if got != want:
                    fail(f"GEMM plan of {kernel} {prod} ({layout} {M}x{N}x{K}, {name} B={B}): "
                         f"C {got}, Python mirror {want}")
                held += 1
            # The bf16 variants of K2-K5, K7, K9 and K10: the GEMM's bf16
            # path, the wgmma kernel where TMA can read the operands (the
            # model's always can), the mma.sync kernel where it cannot (the
            # pair's plans are those of fp32 rows: it stages bf16 rows in
            # fp32).
            for kernel, prod, layout, M, N, K, groups in gemm_cuda.model_gemm_shapes_bf16(cfg, B):
                for tma_ok, path in ((True, gemm_cuda.BF16_WG), (False, gemm_cuda.BF16)):
                    got = gemm_cuda.card_plan(layout, M, N, K, groups, prod, torch.bfloat16,
                                              tma_ok)
                    want = gemm_cuda.plan(layout, M, N, K, groups, prod, torch.bfloat16, tma_ok)
                    if got != want or want["path"] != path:
                        fail(f"bf16 GEMM plan of {kernel} {prod} ({M}x{N}x{K}, {name} B={B}, "
                             f"TMA-readable {tma_ok}): C {got}, Python mirror {want}")
                    held_bf16 += 1
    active = {r: lstm_cuda.card_max_active_clusters(r) for r in lstm_cuda.row_choices(256)}
    plans = {}
    for B in PLAN_BATCHES + (17, 520):
        plan = lstm_cuda.card_plan(B)
        rows, clusters = lstm_cuda.lstm_plan(B, 256, active.get)
        smem = lstm_cuda.lstm_smem_bytes(256, rows)
        if (plan["rows"], plan["clusters"], plan["smem"]) != (rows, clusters, smem):
            fail(f"K5 plan at B={B}: C {plan}, Python mirror rows {rows}, clusters "
                 f"{clusters}, smem {smem}")
        plan["waves"] = -(-plan["clusters"] // plan["max_active_clusters"])
        plans[B] = plan
    active16 = {r: lstm_cuda.card_max_active_clusters(r, itemsize=2)
                for r in lstm_cuda.row_choices(256, itemsize=2)}
    plans16 = {}
    for B in PLAN_BATCHES + (17, 520):
        plan = lstm_cuda.card_plan(B, itemsize=2)
        rows, clusters = lstm_cuda.lstm_plan(B, 256, active16.get, itemsize=2)
        smem = lstm_cuda.lstm_smem_bytes(256, rows, itemsize=2)
        if (plan["rows"], plan["clusters"], plan["smem"]) != (rows, clusters, smem):
            fail(f"K5 bf16 plan at B={B}: C {plan}, Python mirror rows {rows}, clusters "
                 f"{clusters}, smem {smem}")
        plan["waves"] = -(-plan["clusters"] // plan["max_active_clusters"])
        plans16[B] = plan
    # The proposal kernels' plans (K1, K6, K8 and their bf16 variants) at
    # the configs' maps, the card tests' narrow ones and the admission edges.
    from video_moment_localization_tpu_torch.ops import proposal_cuda

    proposal_held = 0
    for T, L, C in sorted({(c.T, c.L, c.C) for _, c in configs}
                          | {(16, 8, 4), (10, 5, 3), (445, 5, 4), (837, 16, 4), (838, 16, 4),
                             (880, 4, 4)}):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                got = proposal_cuda.library_plan(T, L, C, backward, dtype)
                want = proposal_cuda.plan(T, L, C, backward, dtype)
                if got != want:
                    fail(f"proposal plan T={T} L={L} C={C} {dtype} backward={backward}: C "
                         f"{got}, Python mirror {want}")
                proposal_held += 1
    for _, c in configs:
        p = proposal_cuda.plan(c.T, c.L, c.C, True, torch.bfloat16)
        print(f"proposal bf16 backward plan T={c.T} L={c.L}: {p['warps']} warps (a producer), "
              f"{p['slots']} ring slots, {p['blocks_per_sm']} block(s) an SM, {p['smem']} B of "
              f"shared memory")
    print(f"plans: {proposal_held} proposal kernel plans (fp32 and bf16, forward and backward) "
          f"equal to their Python mirror")
    print(f"plans: {held} GEMM launches of K2-K5, K7, K9, K10 (3 configs, B={PLAN_BATCHES}), "
          f"{pair_held} content-attention pair plans (every Nq, forward and backward, with "
          f"the backward's partial floats) and K5 at B={sorted(plans)} equal to their Python "
          f"mirrors; K5 clusters of 8 CTAs the card holds at once by rows per cluster: "
          f"{active}")
    print(f"plans bf16: {held_bf16} GEMM launches of K2-K5, K7, K9, K10 at bf16 (layouts nt / "
          f"nn / tn, the wgmma kernel and, for operands TMA cannot read, the mma.sync one) and "
          f"K5-bf16 at B={sorted(plans16)} equal to their "
          f"Python mirrors; K5-bf16 clusters the card holds at once by rows per cluster: "
          f"{active16}")
    for name, cfg in configs:
        N = cfg.L * (cfg.L + 1) // 2
        for backward in (False, True):
            p = content_attn_cuda.plan(64, N, cfg.C, cfg.max_query_length, cfg.dl, backward)
            print(f"pair plan {name} B=64 {'backward' if backward else 'forward'}: {p['pp']} "
                  f"pairs per pass, {p['passes']} passes, {p['tiles']} blocks per element, "
                  f"{p['smem']} B of shared memory")
    for B in (16, 64, 512):
        for label, p in (("K5", plans[B]), ("K5-bf16", plans16[B])):
            print(f"{label} plan B={B}: {p['rows']} rows per cluster, {p['clusters']} clusters, "
                  f"{p['max_active_clusters']} at once, {p['waves']} wave(s), {p['smem']} B of "
                  f"shared memory per CTA")
    return ({str(B): plans[B] for B in (16, 64, 512)},
            {str(B): plans16[B] for B in (16, 64, 512)})


def phase_gemm(cfg, anet_cfg, device):
    """The shared GEMM alone on the products of K7 (ActivityNet B=64), K2,
    K3 and K10 (Charades B=64), K4 and K5 (Charades B=16 and B=512), on
    both paths (3xTF32 on the tensor cores, fp32 on the CUDA cores) and
    against torch.matmul with TF32 off, each back to back (the device's time
    per call). Returns the rows of the {"gemm": [...]} line."""
    import torch

    from video_moment_localization_tpu_torch.ops import gemm_cuda

    picks = [(anet_cfg, 64, ("K7f", "K7b"), "activitynet")]
    picks += [(cfg, 64, ("K2", "K3", "K10f", "K10b"), "charadessta")]
    picks += [(cfg, B, ("K4", "K5"), "charadessta") for B in (16, 512)]
    shapes = [(c, B, name) + s for c, B, kernels, name in picks
              for s in gemm_cuda.model_gemm_shapes(c, B) if s[0] in kernels]
    # K7's c_hat rows at other depths: what a block's fixed prologue and
    # epilogue cost as its K slices grow from 4 to 64.
    N7, D7 = 64 * anet_cfg.L * (anet_cfg.L + 1) // 2 * anet_cfg.C, anet_cfg.dl
    shapes += [(anet_cfg, 64, "activitynet", "K sweep", f"c_hat rows, K={K}", "nt", N7, D7, K, 1)
               for K in (64, 128, 256, 1024)]
    seen, rows = set(), []
    gen = torch.Generator(device=device).manual_seed(0)
    for _, B, name, kernel, prod, layout, M, N, K, groups in shapes:
        if (layout, M, N, K) in seen or M * N * K < 1e7:
            continue
        seen.add((layout, M, N, K))
        A = torch.randn((K, M) if layout == "tn" else (M, K), device=device, generator=gen)
        W = torch.randn((N, K) if layout == "nt" else (K, N), device=device, generator=gen)
        Wt = W.t() if layout == "nt" else W
        At = A.t() if layout == "tn" else A
        out = torch.empty((M, N), device=device)
        launches = 10 if M * N * K < 2e10 else 4
        ms = {path: cuda_ms_back_to_back(lambda: gemm_cuda.gemm(layout, A, W, out=out, path=path),
                                         launches=launches, reps=3)
              for path in (gemm_cuda.TENSOR, gemm_cuda.CUDA_CORE)}
        lib_ms = cuda_ms_back_to_back(lambda: torch.matmul(At, Wt, out=out),
                                      launches=launches, reps=3)
        flops = 2.0 * M * N * K
        path = gemm_cuda.site_path(prod, layout, M, N, K, groups)
        tc, cc = ms[gemm_cuda.TENSOR], ms[gemm_cuda.CUDA_CORE]
        row = dict(kernel=kernel if kernel == "K sweep" else kernel[:2], product=prod,
                   layout=layout, M=M, N=N, K=K, config=name, batch=B, groups=groups,
                   tile="x".join(map(str, gemm_cuda.TILES[gemm_cuda.launch_grid(
                       layout, M, N, K, groups)[0]])),
                   path="tensor" if path == gemm_cuda.TENSOR else "cuda_core",
                   ms=ms[path], tensor_ms=tc, tensor_tflops=flops / tc / 1e9,
                   tensor_peak_share=flops / tc / 1e9 / (PEAK_TF32_FLOPS / 3e12),
                   cuda_core_ms=cc, cuda_core_tflops=flops / cc / 1e9,
                   cuda_core_peak_share=flops / cc / 1e9 / (PEAK_FP32_FLOPS / 1e12),
                   matmul_ms=lib_ms, matmul_tflops=flops / lib_ms / 1e9)
        rows.append(row)
        print(f"gemm {row['kernel']} {prod} {layout} {M}x{N}x{K} ({name} B={B}, tile "
              f"{row['tile']}, runs on {row['path']}): tensor {tc:.4f} ms "
              f"{row['tensor_tflops']:.2f} TFLOP/s ({row['tensor_peak_share'] * 100:.1f} % of "
              f"165); CUDA cores {cc:.4f} ms {row['cuda_core_tflops']:.2f} TFLOP/s "
              f"({row['cuda_core_peak_share'] * 100:.1f} % of 67); torch.matmul {lib_ms:.4f} "
              f"ms, {row['matmul_tflops']:.2f} TFLOP/s")
        del A, W, out
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------------- #
# The content-attention pair alone, and the kernels that run it where they
# had not been held
# ------------------------------------------------------------------------- #
PAIR_CELLS = (("charadessta", 64), ("charadessta", 512), ("activitynet", 64))


def pair_inputs(cfg, unit, B, rng, device):
    """(h, q, khat, fwh, fsh, query_mask, vmask) of the pair as the content
    unit ``unit`` makes them from a layer's seeded inputs (`layer_inputs`,
    one video cut to L/2 snippets, one query of one word)."""
    from video_moment_localization_tpu_torch.ops.content_attn_cuda import unit_projections

    fc, _, _, fw, fs, qmask, _, vmask = layer_inputs(cfg, B, rng, device, pin=True)
    return [*unit_projections(unit, fc, fw, fs, qmask, vmask), qmask, vmask]


def pair_bound(cfg, B, backward):
    """The pair's least time: its bytes (rows of h, q in and fcc out; h, q,
    dfcc in and dh, dq out backward; the element's khat, fwh, fsh and masks;
    dfwh, dkhat, dfsh out) against its operations (per clip row: 4 Nq dl +
    4 C dl forward, 12 Nq dl + 8 C dl backward with the recompute)."""
    N, C, Nq, dl = cfg.L * (cfg.L + 1) // 2, cfg.C, cfg.max_query_length, cfg.dl
    rows = B * N * C
    shared = 4 * B * (2 * Nq * dl + dl + Nq + N)
    if backward:
        return bound(rows * (12 * Nq * dl + 8 * C * dl), 4 * 5 * rows * dl + 2 * shared)
    return bound(rows * (4 * Nq * dl + 4 * C * dl), 4 * 3 * rows * dl + shared)


def phase_pair(configs, rng, device):
    """The pair alone (csrc/content_attn.cu) at Charades B=64 and B=512 and
    ActivityNet B=64, on the inputs a layer's content unit gives it (the
    projections of a seeded model): forward and backward against the plain
    version, the
    backward bit for bit against a second launch, then times (one call, and
    back to back), the plain version's, and the bytes bound with its share.
    Returns {cell: {"f": ..., "b": ...}} and the largest errors."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.ops import content_attn_cuda as ca

    res, errs = {}, {"CAf": 0.0, "CAb": 0.0, "CAb_rel": 0.0}
    for name, B in PAIR_CELLS:
        cfg = configs[name]
        unit = SMIN(cfg).to(device).smis[1].content_unit
        ins = pair_inputs(cfg, unit, B, rng, device)
        got = ca.content_attn_forward(*ins)
        e = max_err([got], [ca.content_attn_plain(*ins)], K4_TOL, f"pair forward {name} B={B}")
        errs["CAf"] = max(errs["CAf"], e)
        dfcc = randn_like(got, rng)
        del got
        got = ca.content_attn_backward(*ins, dfcc)
        again = ca.content_attn_backward(*ins, dfcc)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, again)):
            if not torch.equal(a, b):
                fail(f"pair backward {name} B={B}: output {k} differs between two launches by "
                     f"up to {float((a - b).abs().max()):.3e}")
        del again
        want = ca.content_attn_backward_plain(*ins, dfcc)
        worst = rel = 0.0
        for g, w, out in zip(got, want, ("dh", "dq", "dfwh", "dkhat", "dfsh")):
            scale = float(w.abs().max())
            err = grad_err(g, w, scale, f"pair backward {name} B={B} {out}")
            worst, rel = max(worst, err), max(rel, err / scale)
        errs["CAb"], errs["CAb_rel"] = max(errs["CAb"], worst), max(errs["CAb_rel"], rel)
        print(f"parity pair {name} B={B}: forward max abs err {e:.3e} (tolerance {K4_TOL}); "
              f"backward 5 gradients max abs err {worst:.3e}, {rel:.3e} of the magnitude, a "
              f"second launch equal bit for bit")
        del got, want
        torch.cuda.empty_cache()
        cell = res[f"{name}_b{B}"] = {}
        for key, fn, plain, backward in (
                ("f", lambda: ca.content_attn_forward(*ins),
                 lambda: ca.content_attn_plain(*ins), False),
                ("b", lambda: ca.content_attn_backward(*ins, dfcc),
                 lambda: ca.content_attn_backward_plain(*ins, dfcc), True)):
            b_ms, b_by = pair_bound(cfg, B, backward)
            r = cell[key] = dict(
                ms=cuda_ms(fn, iters=9), plain_ms=cuda_ms(plain, warmup=1, iters=3),
                device_ms=cuda_ms_back_to_back(fn, launches=10, reps=3), library_ms=None,
                bound_ms=b_ms, bound_by=b_by)
            r["bound_share"] = b_ms / r["device_ms"]
            print(f"time pair {'backward' if backward else 'forward'} {name} B={B}: kernel "
                  f"{r['ms']:.4f} ms, back to back {r['device_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{r['bound_share'] * 100:.1f} % of the bound back to back")
        # The bf16 backward (K3-bf16's, K7-bf16's and K10-bf16's) on the same
        # values in bf16: its plain version by the bulk criterion, twice bit
        # for bit, its time beside its bytes bound at 2-byte rows.
        bf = torch.bfloat16
        ins16 = [t.to(bf) for t in ins[:4]] + list(ins[4:])
        dfcc16 = dfcc.to(bf)
        got = ca.content_attn_backward(*ins16, dfcc16)
        again = ca.content_attn_backward(*ins16, dfcc16)
        want = ca.content_attn_backward_plain(*ins16, dfcc16)
        torch.cuda.synchronize()
        for k, (g, a, w, out) in enumerate(zip(got, again, want,
                                               ("dh", "dq", "dfwh", "dkhat", "dfsh"))):
            if not torch.equal(g, a) or g.dtype != w.dtype:
                fail(f"pair bf16 backward {name} B={B}: {out} differs between two launches "
                     f"or is {g.dtype}")
            st = bulk_rel(g, w, K23_BF16_CARD, f"pair bf16 backward {name} B={B} {out}")
            errs["CAb16"] = max(errs.get("CAb16", 0.0), st["mean"])
        print(f"parity pair bf16 backward {name} B={B}: 5 gradients within {K23_BF16_CARD} of "
              f"the plain version (worst mean {errs['CAb16']:.2e} of the magnitude), a second "
              f"launch equal bit for bit")
        del got, again, want
        N, Nq, dl = cfg.L * (cfg.L + 1) // 2, cfg.max_query_length, cfg.dl
        rows = B * N * cfg.C
        b_ms, b_by = bound(rows * (12 * Nq * dl + 8 * cfg.C * dl),
                           (2 * 3 + 4 + 2) * rows * dl + 2 * 4 * B * (2 * Nq * dl + dl + Nq + N))
        fn = lambda: ca.content_attn_backward(*ins16, dfcc16)  # noqa: E731
        r = cell["b16"] = dict(
            ms=cuda_ms(fn, iters=9), device_ms=cuda_ms_back_to_back(fn, launches=10, reps=3),
            plain_ms=cuda_ms(lambda: ca.content_attn_backward_plain(*ins16, dfcc16), warmup=1,
                             iters=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        r["bound_share"] = b_ms / r["device_ms"]
        print(f"time pair bf16 backward {name} B={B}: kernel {r['ms']:.4f} ms, back to back "
              f"{r['device_ms']:.4f} ms (fp32 {cell['b']['device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{r['bound_share'] * 100:.1f} % of the bound back to back")
        del ins, dfcc, ins16, dfcc16
        torch.cuda.empty_cache()
    return res, errs


def phase_unheld(anet_cfg, rng, device):
    """K4 at the ActivityNet width at B=512 (4,259,840 clip rows, past the
    4,194,240 rows of 65,535 GEMM tiles along y), held to K4 on slices of 8
    of the same batch; K2 and K3 at L=64 at B=2 and B=8 against their plain
    versions, K3 also bit for bit against a second launch."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN, block_weights
    from video_moment_localization_tpu_torch.ops import smin_cuda, smin_train_cuda

    cfg = anet_cfg
    model = SMIN(cfg).to(device).eval()
    B = 512
    ins = stack_inputs(cfg, B, rng, device, pin=True)
    got = smin_cuda.smin_stack_fused(model, cfg, *ins)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    worst = 0.0
    for lo in range(0, B, 8):
        want = smin_cuda.smin_stack_fused(model, cfg, *[t[lo:lo + 8].contiguous() for t in ins])
        worst = max(worst, max_err([g[lo:lo + 8] for g in got], want, K4_TOL,
                                   f"K4 ActivityNet B={B} rows {lo}-{lo + 7}"))
    print(f"held K4 ActivityNet B={B} ({B * cfg.L * (cfg.L + 1) // 2 * cfg.C:,} clip rows): "
          f"equal to K4 on slices of 8 within {worst:.3e} (tolerance {K4_TOL})")
    del got, ins
    torch.cuda.empty_cache()

    weights = [w.detach() for w in block_weights(model.smis[1])]
    errs = {"K4_b512": worst, "K2": 0.0, "K3": 0.0, "K3_rel": 0.0}
    for B in (2, 8):
        ins = layer_inputs(cfg, B, rng, device, pin=True)
        got = smin_train_cuda.smi_layer_forward(weights, *ins, cfg.L)
        want = smin_train_cuda.smi_layer_plain(weights, *ins, cfg.L)
        e = max_err(got, want, K4_TOL, f"K2 at L=64 B={B}")
        dcu, dmu, dbu = [randn_like(t, rng) for t in want]
        got = smin_train_cuda.smi_layer_backward(weights, *ins, cfg.L, dcu, dmu, dbu)
        check_all_repeatable(got, smin_train_cuda.smi_layer_backward(
            weights, *ins, cfg.L, dcu, dmu, dbu), f"K3 at L=64 B={B}")
        want = smin_train_cuda.smi_layer_backward_plain(weights, *ins, cfg.L, dcu, dmu, dbu)
        w3, rel = gradient_set_err(got, want, ("dfc", "dfm", "dfb", "dfw", "dfs"),
                                   f"K3 at L=64 B={B}")
        print(f"held K2 / K3 at L=64 B={B}: K2 max abs err {e:.3e} (tolerance {K4_TOL}); K3 "
              f"25 gradients max abs err {w3:.3e}, {rel:.3e} of the magnitude (rtol "
              f"{GRAD_RTOL}, atol {GRAD_ATOL_REL} of the magnitude), a second launch equal bit "
              f"for bit")
        errs["K2"], errs["K3"] = max(errs["K2"], e), max(errs["K3"], w3)
        errs["K3_rel"] = max(errs["K3_rel"], rel)
        del ins, got, want
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return errs


# Phase 17: a Charades-style directory of feature files at the full width,
# 128 + 32 videos with 2 queries each: 256 train samples (4 steps at B=64)
# and 64 test samples (one eval batch).
FILES_VIDEOS = {"train": 128, "test": 32}
FILES_QUERIES = 2
FILES_EPOCHS = 2
FILES_LOADER_EPOCHS = 5
# The card's epoch-1 train loss (kernels) against the same Trainer on the CPU
# (plain versions) from the same initial weights: 4 Adam steps, as phase 6's
# three held to the plain versions.
FILES_CPU_LOSS_RTOL = TRAIN_LOSS_RTOL


def run_cli(args):
    """The port's CLI in this process; returns its stdout, which it also
    prints."""
    import contextlib
    import io

    from video_moment_localization_tpu_torch.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli([*args, "--device", "cuda"])
    print(buf.getvalue(), end="")
    return buf.getvalue()


def files_config(root, data, resume):
    """config/charadessta.yml with its data in ``data`` and its checkpoints in
    ``root``, written as ``root/charades_files.yml`` (the experiment name)."""
    import yaml

    with open(os.path.join(REPO, "config", "charadessta.yml")) as fh:
        raw = yaml.safe_load(fh)
    raw.update(data_dir=data, checkpoint_path=os.path.join(root, "ckpt"),
               resume_training=resume)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "charades_files.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(raw, fh)
    return path


def read_stats(cfg_path):
    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.utils.checkpoint import checkpoint_paths

    cfg = load_config(cfg_path)
    with open(checkpoint_paths(cfg.checkpoint_path, cfg.experiment)[1]) as fh:
        return json.load(fh)


def metric_lines(out, label):
    """The 8 metric lines of a --test run, each a share in [0, 1]."""
    names = [f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]
    got = dict(line.rsplit(" - ", 1) for line in out.splitlines()
               if line.split(" - ")[0] in names)
    if sorted(got) != sorted(names) or not all(0.0 <= float(v) <= 1.0 for v in got.values()):
        fail(f"{label}: metric lines {got}")
    return {k: float(v) for k, v in got.items()}


def phase_files(config, seed, device, tmp):
    """Training from feature files through the port's CLI at the full
    Charades width: the loader alone, 2 epochs, a resumed run equal to the
    uninterrupted one bit for bit, --test with and without --nms, the card's
    epoch-1 loss against the CPU's, and the device's busy share over an
    epoch. Returns its results and {data: the directory, stats: the 2-epoch
    run's stats} for phase 23."""
    import torch

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.data import native
    from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
    from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.train.trainer import Trainer, build_datasets
    from video_moment_localization_tpu_torch.utils.checkpoint import (
        checkpoint_paths,
        load_checkpoint,
    )
    from video_moment_localization_tpu_torch.utils.profile_serving import profile_and_report

    cfg = config.model
    n = cfg.num_smi_layers
    t0 = time.perf_counter()
    data = write_charades_style_dir(os.path.join(tmp, "charades"), queries_per_video=FILES_QUERIES,
                                    input_video_dim=cfg.input_video_dim, seed=seed,
                                    signal_strength=1.0, videos_per_split=FILES_VIDEOS)
    whole = files_config(os.path.join(tmp, "whole"), data, resume=False)
    fcfg = load_config(whole)
    B = fcfg.batch_size
    train_ds, eval_ds = build_datasets(fcfg)
    steps, evals = -(-len(train_ds) // B), -(-len(eval_ds) // B)
    print(f"files: {len(train_ds)} train and {len(eval_ds)} test samples written in "
          f"{time.perf_counter() - t0:.2f} s; host label and sampler path: {native.backend()}")

    def loaders(c, train, evald):
        return (BatchLoader(train, c.batch_size, shuffle=True, num_workers=c.num_workers,
                            seed=c.seed),
                BatchLoader(evald, c.batch_size, shuffle=False, num_workers=c.num_workers,
                            seed=c.seed))

    loader, _ = loaders(fcfg, train_ds, eval_ds)
    sum(1 for _ in loader.epoch(0))   # learns the feature width: the buffered path from here
    t0 = time.perf_counter()
    batches = sum(1 for e in range(1, FILES_LOADER_EPOCHS + 1) for _ in loader.epoch(e))
    loader_bps = batches / (time.perf_counter() - t0)
    print(f"files: loader alone, B={B}, {fcfg.num_workers} workers: {batches} batches, "
          f"{loader_bps:.2f} batches/s ({loader_bps * B:.1f} samples/s)")

    counters = dict(mode_counters(), K5=lstm_cuda.bilstm_fused, K4=smin_cuda.smin_stack_fused)
    for fn in counters.values():
        fn.launches = 0
    reset_pair_counts()
    torch.cuda.reset_peak_memory_stats()
    out = run_cli(["--config_path", whole, "--num_epochs", str(FILES_EPOCHS)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict({k: fn.launches for k, fn in counters.items()}, **pair_counts())
    train_steps, eval_steps = FILES_EPOCHS * steps, FILES_EPOCHS * evals
    want = {"K1f": train_steps, "K1b": train_steps, "K2": n * train_steps,
            "K3": n * train_steps, "CAb": n * train_steps, "K5": eval_steps, "K4": eval_steps}
    others = {k: v for k, v in launches.items() if k not in want and k != "CAf" and v}
    print(f"files: {FILES_EPOCHS} epochs through the CLI, launches "
          f"{ {k: v for k, v in launches.items() if v} }, peak device memory {peak:.3f} GiB")
    if (any(launches[k] != v for k, v in want.items()) or others
            or launches["CAf"] < 2 * n * train_steps):
        fail(f"files: kernel launches {launches}, expected {want} and CAf >= "
             f"{2 * n * train_steps}")
    stats = read_stats(whole)
    sps = [float(line.split(" - ")[1].split()[0]) for line in out.splitlines()
           if line.startswith("throughput - ")]
    if stats["epoch"] != [1, 2] or len(sps) != FILES_EPOCHS or not all(
            v == v and abs(v) < float("inf") for v in stats["train_loss"] + stats["eval_loss"]):
        fail(f"files: stats {stats}")

    # Resume: epoch 1 in a second directory, then a run that loads its
    # checkpoint and trains epoch 2.
    cut = files_config(os.path.join(tmp, "cut"), data, resume=True)
    run_cli(["--config_path", cut, "--num_epochs", "1"])
    cut_cfg = load_config(cut)
    card_epoch1 = load_checkpoint(checkpoint_paths(cut_cfg.checkpoint_path,
                                                   cut_cfg.experiment)[0])["model"]

    # Epoch 1 of the same Trainer on the CPU, from the same seeded initial
    # weights: its train and eval losses, and its weights after the epoch.
    cpu_path = files_config(os.path.join(tmp, "cpu"), data, resume=False)
    cpu_cfg = load_config(cpu_path, num_epochs_override=1)
    card = Trainer(fcfg, device=device)
    t0 = time.perf_counter()
    cpu = Trainer(cpu_cfg, device="cpu")
    card_init = card.model.state_dict()
    for name, p in cpu.model.state_dict().items():
        if not torch.equal(p, card_init[name].cpu()):
            fail(f"files: initial weight {name} differs between the card's and the CPU's Trainer")
    cpu.fit(*loaders(cpu_cfg, *build_datasets(cpu_cfg)))
    cpu_stats = read_stats(cpu_path)
    weight_diff = max(float((p - card_epoch1[name]).abs().max())
                      for name, p in cpu.model.state_dict().items())
    for key in ("train_loss", "eval_loss"):
        rel = abs(stats[key][0] - cpu_stats[key][0]) / abs(cpu_stats[key][0])
        print(f"files: epoch-1 {key} {stats[key][0]!r} on the card, {cpu_stats[key][0]!r} on the "
              f"CPU: relative difference {rel:.3e} (tolerance {FILES_CPU_LOSS_RTOL})")
        if rel > FILES_CPU_LOSS_RTOL:
            fail(f"files: epoch-1 {key} differs from the CPU's by {rel:.3e}")
    print(f"files: CPU epoch {time.perf_counter() - t0:.1f} s; weights after epoch 1 differ from "
          f"the card's by at most {weight_diff:.3e} (lr {fcfg.lr}, {steps} Adam steps)")
    del cpu

    out_resumed = run_cli(["--config_path", cut, "--num_epochs", str(FILES_EPOCHS)])
    if "Training Epoch - 2" not in out_resumed or "Training Epoch - 1" in out_resumed:
        fail("files: the resumed run did not start at epoch 2")
    resumed = read_stats(cut)
    if resumed != stats:
        diff = {k: (stats.get(k), resumed.get(k)) for k in set(stats) | set(resumed)
                if stats.get(k) != resumed.get(k)}
        fail(f"files: the resumed run's stats differ from the uninterrupted run's: {diff}")
    print(f"files: resumed at epoch 2, stats equal to the uninterrupted run's bit for bit "
          f"(train losses {stats['train_loss']}, eval losses {stats['eval_loss']})")
    metrics = {}
    for flags in ([], ["--nms"]):
        label = "files --test" + "".join(" " + f for f in flags)
        metrics[label] = metric_lines(run_cli(["--config_path", whole, "--test", *flags]), label)

    # The device's busy share over a train epoch from files (after a warm
    # one), then unprofiled epochs, then the same steps on an epoch's host
    # batches collected beforehand (no loader thread running beside them).
    train_loader, _ = loaders(fcfg, train_ds, eval_ds)
    card._run_epoch(train_loader, 1, True)
    busy = profile_and_report(lambda: card._run_epoch(train_loader, 2, True),
                              f"files: Charades train epoch from files, B={B}", "epoch", 1,
                              top=12)
    epoch_sps = []
    for epoch in range(3, 6):
        card.timer.reset()
        card._run_epoch(train_loader, epoch, True)
        epoch_sps.append(card.timer.throughput)
    host_sps = []
    for epoch in range(6, 8):
        host = list(train_loader.epoch(epoch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in host:
            card.train_step(card._to_device(b))
        torch.cuda.synchronize()
        host_sps.append(sum(float(b["sample_mask"].sum()) for b in host)
                        / (time.perf_counter() - t0))
    print(f"files: trainer epochs 3-5 unprofiled: {epoch_sps} samples/s; the same steps on an "
          f"epoch's batches loaded beforehand: {host_sps} samples/s")
    result = {"batch": B, "train_samples": len(train_ds), "test_samples": len(eval_ds),
              "native": native.backend(), "loader_batches_per_s": loader_bps,
              "cli_samples_per_s": sps, "trainer_samples_per_s": epoch_sps,
              "steps_on_loaded_batches_samples_per_s": host_sps,
              "device_busy_share": busy, "peak_memory_gib": peak,
              "train_loss": stats["train_loss"], "eval_loss": stats["eval_loss"],
              "cpu_epoch1": {k: cpu_stats[k][0] for k in ("train_loss", "eval_loss")},
              "cpu_weight_max_abs_diff": weight_diff, "launches": launches, "test": metrics}
    del card
    torch.cuda.empty_cache()
    return result, dict(data=data, stats=stats)


# ------------------------------------------------------------------------- #
# Asynchronous serving and bf16 serving
# ------------------------------------------------------------------------- #
ASYNC_REQUESTS = 4000
ASYNC_SHARES = (0.25, 0.5, 0.9)
ASYNC_SINGLES = 200
ASYNC_KEYS = ("p50_ms", "p99_ms", "mean_ms", "max_ms", "throughput_rps", "mean_batch",
              "max_queue_depth", "errors")
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 on the tensor cores
# bf16 kernels against their plain bf16 versions on the card, on the inputs
# the main path gives them (`backbone_inputs`). K4: the JAX package's bf16
# criterion (tests/test_smin_pallas.py::test_fused_stack_bf16_close) cut
# tenfold; phase 19 also prints how far each of the two lies from the fp32
# kernel. K5: tests/test_lstm_pallas.py's bf16 rtol = atol = 0.05 cut
# fivefold. The bf16 localizer's scores against the fp32 localizer's: the
# JAX criterion.
K4_BF16_CARD = dict(mean=1e-3, p98=5e-3, max=3e-2)
K4_BF16_JAX = dict(mean=1e-2, p98=5e-2, max=3e-1)
K5_BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def bf16_criterion(got, want, bounds, name):
    """Per output: mean, 98th percentile and max of |got - want| within
    ``bounds``. Returns the largest max abs error."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g.float()).all():
            fail(f"{name}: non-finite output")
        d = (g.float() - w.float()).abs().flatten()
        stats = dict(mean=float(d.mean()), max=float(d.max()),
                     p98=float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.98)))
        if any(stats[k] > bounds[k] for k in bounds):
            fail(f"{name}: kernel disagrees with its plain version: {stats} (bounds {bounds})")
        worst = max(worst, stats["max"])
    return worst


def async_run(loc, reqs, rate, rng, plant=None):
    """Open-loop Poisson arrivals of ``reqs`` at ``rate`` requests/s into a
    fresh AsyncLocalizer (serve_batch of ``loc``, max_wait_ms 2,
    max_in_flight 2); ``plant``: the index before which one malformed
    request is submitted. Returns (answers, the stats snapshot, the
    malformed request's future)."""
    import numpy as np

    from video_moment_localization_tpu_torch.inference import AsyncLocalizer

    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(reqs)))
    server = AsyncLocalizer(loc, top_k=5, max_wait_ms=2.0, max_in_flight=2)
    futures, bad = [], None
    t0 = time.perf_counter()
    for i, (req, at) in enumerate(zip(reqs, arrivals)):
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if i == plant:
            bad = server.submit(np.zeros((3,), np.float32), QUERIES[0], 1.0)
        futures.append(server.submit(req[0], req[1], req[2], video_key=req[3]))
    answers = [f.result(timeout=600) for f in futures]
    server.close()
    return answers, server.stats.snapshot(), bad


def check_answers(got, want, label):
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if [(m.start, m.end) for m in g] != [(m.start, m.end) for m in w]:
            fail(f"{label} request {k}: moments {[(m.start, m.end) for m in g]}, "
                 f"localize_batch {[(m.start, m.end) for m in w]}")
        worst = max([worst] + [abs(a.score - b.score) for a, b in zip(g, w)])
    if worst > SCORE_TOL:
        fail(f"{label}: scores differ from localize_batch's by {worst:.3e} > {SCORE_TOL}")
    return worst


def phase_async(cfg, serving, with_host_rps, rng):
    """Phase 18: `AsyncLocalizer` over phase 3's checkpoint at the full
    Charades width (serve_batch 64, max_wait_ms 2, max_in_flight 2): open-loop
    Poisson arrivals of 4,000 requests at 25 %, 50 % and 90 % of phase 4's
    with-host localize_batch throughput, drawn from 64 videos of 8-200 clips
    x 8 queries with video_key set; then 200 closed-loop single requests.
    Every answer must equal localize_batch's on the same requests, errors
    must be 0 (1 in the 50 % run, where one malformed request is planted
    and fails its own future only), close() with work queued must resolve
    it all, and K4, K5 and the pair must be launched."""
    import torch

    from video_moment_localization_tpu_torch.inference import AsyncLocalizer, MomentLocalizer
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    loc = MomentLocalizer.from_checkpoint(serving["cfg_path"], glove_path=serving["glove"],
                                          serve_batch=64)
    videos = [rng.standard_normal((int(n), cfg.input_video_dim)).astype("float32")
              for n in rng.integers(8, 201, size=64)]

    def draw(n):
        keys, qs = rng.integers(0, len(videos), size=n), rng.integers(0, len(QUERIES), size=n)
        return [(videos[k], QUERIES[q], videos[k].shape[0] / 2.0, int(k))
                for k, q in zip(keys, qs)]

    for b in loc.bucket_sizes:                 # every bucket once, before the clock
        loc.localize_batch(draw(b), top_k=5)
    torch.cuda.synchronize()
    lstm_cuda.bilstm_fused.launches = smin_cuda.smin_stack_fused.launches = 0
    reset_pair_counts()
    runs = {}
    for share in ASYNC_SHARES:
        reqs = draw(ASYNC_REQUESTS)
        plant = ASYNC_REQUESTS // 2 if share == 0.5 else None
        rate = share * with_host_rps
        answers, snap, bad = async_run(loc, reqs, rate, rng, plant)
        want_errors = 1 if plant is not None else 0
        if snap["errors"] != want_errors:
            fail(f"async {share:.0%}: {snap['errors']} errors, want {want_errors}")
        if bad is not None:
            if not isinstance(bad.exception(timeout=60), ValueError):
                fail(f"async {share:.0%}: the malformed request did not fail with ValueError")
        worst = check_answers(answers, loc.localize_batch(reqs, top_k=5), f"async {share:.0%}")
        runs[f"{int(share * 100)}%"] = dict({k: snap.get(k) for k in ASYNC_KEYS},
                                            offered_rps=rate, max_score_diff=worst)
        print(f"async {share:.0%} of {with_host_rps:.1f} requests/s ({rate:.1f}/s offered, "
              f"{ASYNC_REQUESTS} requests): " + ", ".join(
                  f"{k} {snap.get(k, float('nan')):.3f}" for k in ASYNC_KEYS)
              + f"; answers equal localize_batch's (max score diff {worst:.3e})")
    singles = draw(ASYNC_SINGLES)
    with AsyncLocalizer(loc, top_k=5, max_wait_ms=2.0, max_in_flight=2) as server:
        answers = [server.submit(r[0], r[1], r[2], video_key=r[3]).result(timeout=60)
                   for r in singles]
    snap = server.stats.snapshot()
    worst = check_answers(answers, loc.localize_batch(singles, top_k=5), "async singles")
    if snap["errors"] != 0:
        fail(f"async singles: {snap['errors']} errors")
    runs["closed_loop_single"] = dict({k: snap.get(k) for k in ASYNC_KEYS}, max_score_diff=worst)
    print(f"async closed-loop single requests ({ASYNC_SINGLES}): " + ", ".join(
        f"{k} {snap.get(k, float('nan')):.3f}" for k in ASYNC_KEYS))
    burst = draw(300)
    server = AsyncLocalizer(loc, top_k=5, max_wait_ms=2.0, max_in_flight=2)
    futures = [server.submit(r[0], r[1], r[2], video_key=r[3]) for r in burst]
    server.close()                             # straight away, with work queued
    if not all(f.done() and f.exception() is None for f in futures):
        fail("async close(): a queued request was not resolved")
    check_answers([f.result() for f in futures], loc.localize_batch(burst, top_k=5),
                  "async close")
    torch.cuda.synchronize()
    launches = {"K5": lstm_cuda.bilstm_fused.launches, "K4": smin_cuda.smin_stack_fused.launches,
                "CAf": pair_counts()["CAf"]}
    if min(launches.values()) < 1:
        fail(f"async: a kernel of the path was not launched: {launches}")
    print(f"async: close() with {len(burst)} requests queued resolved them all; launches "
          f"{launches}")
    runs["launches"] = launches
    runs["with_host_pairs_per_s"] = with_host_rps
    return runs


def cudnn_lstm_bf16(cfg, model, device):
    """K5-bf16's library call: torch.nn.LSTM in bf16 (cuDNN) with the
    model's weights on packed sequences."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    ref = torch.nn.LSTM(cfg.word_dim, cfg.lstm_hidden_size, num_layers=2, bidirectional=True,
                        batch_first=True)
    ref.load_state_dict(model.backbone.queryencoder.lstm.state_dict())
    ref = ref.to(device=device, dtype=torch.bfloat16)

    def run(x, lengths):
        packed = pack_padded_sequence(x, torch.from_numpy(lengths), batch_first=True,
                                      enforce_sorted=False)
        return pad_packed_sequence(ref(packed)[0], batch_first=True,
                                   total_length=cfg.max_query_length)[0]

    return run


def backbone_inputs(cfg16, model, B, rng, device):
    """(f, fw, fs, qmask, lmask, vmask) as the main path gives them to
    K4-bf16: the bf16 backbone (K5-bf16 in it) on unit-normal clip
    features and word vectors (the serving run's synthetic GloVe table is
    unit normal), ragged videos and queries. Unit-normal f, fw, fs drive
    the three layers' softmaxes far past anything the backbone makes, where
    bf16 and fp32 part by up to 0.36 in a score, the plain version and the
    kernel alike."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import backbone
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

    x, qmask, _ = lstm_inputs(cfg16, B, rng, device)
    vf = torch.from_numpy(rng.standard_normal((B, cfg16.T, cfg16.input_video_dim))
                          .astype("float32")).to(device)
    nlen = rng.integers(1, cfg16.L + 1, size=B)
    nlen[0] = cfg16.L
    lmask = (torch.arange(cfg16.L)[None, :] < torch.from_numpy(nlen)[:, None]).float().to(device)
    vmask = lmask.repeat_interleave(cfg16.T // cfg16.L, dim=1)[..., None].contiguous()
    qm = qmask[..., None].contiguous()
    f, fs, fw = backbone(model.backbone, cfg16, vf.bfloat16(), vmask, x.bfloat16(), qm)
    return (f.contiguous(), fw.contiguous(), fs.contiguous(), qm, lmask,
            packed_valid_mask(lmask).contiguous())


def bound_bf16(flops, nbytes, products):
    """The least time of bf16 work: ``products``, the operations of its
    contractions of bf16 operands, at 989 TFLOP/s of dense bf16, the rest of
    its ``flops`` at 67 TFLOP/s, against its bytes."""
    t_ops = (products / PEAK_BF16_FLOPS + (flops - products) / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_bf16(cfg, anet_cfg, serving, fp32_e2e, rng, device):
    """Phase 19: bf16 serving. K5-bf16 and K4-bf16 against their plain bf16
    versions at the Charades width (B=16, 64, 512) and K4-bf16 at the
    ActivityNet width (L=64, B=64); `MomentLocalizer` at bf16 on phase 3's
    24 requests (the launch counts), its scores held to the fp32
    localizer's; times (one call and back to back), bounds and cuDNN's bf16
    LSTM; device pairs/s at B=512 and the serving forward's MFU."""
    import dataclasses

    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.inference import MomentLocalizer
    from video_moment_localization_tpu_torch.models.lstm import bilstm_bf16, lstm_layers
    from video_moment_localization_tpu_torch.models.smin import SMIN, cast_weights, smin_stack_bf16
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.utils.flops import smin_forward_flops

    bf = torch.bfloat16
    loc32 = MomentLocalizer.from_checkpoint(serving["cfg_path"], glove_path=serving["glove"],
                                            serve_batch=16)
    cfg16 = dataclasses.replace(loc32.cfg, compute_dtype="bfloat16")
    loc16 = MomentLocalizer(cfg16, loc32.model, loc32.embedding, serve_batch=16)
    model = loc16.model
    lstm = model.backbone.queryencoder.lstm
    layers = lstm_layers(lstm, cast_weights(lstm, bf))
    reqs = serving["requests"]
    loc16.localize_batch(reqs[:2], top_k=5)            # the weights' cast, once
    lstm_cuda.bilstm_fused.launches_bf16 = smin_cuda.smin_stack_fused.launches_bf16 = 0
    reset_pair_counts()
    out16 = loc16.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    launches = {"K5": lstm_cuda.bilstm_fused.launches_bf16,
                "K4": smin_cuda.smin_stack_fused.launches_bf16, "CAf": pair_counts()["CAf"]}
    if min(launches.values()) < 1:
        fail(f"bf16 serving: a kernel of the path was not launched: {launches}")
    out32 = loc32.localize_batch(reqs, top_k=5)
    score_err = bf16_criterion([torch.tensor([[m.score for m in r] for r in out16])],
                               [torch.tensor([[m.score for m in r] for r in out32])],
                               K4_BF16_JAX, "bf16 localizer scores against fp32")
    same = sum([(m.start, m.end) for m in a] == [(m.start, m.end) for m in b]
               for a, b in zip(out16, out32))
    print(f"bf16 serving: {len(reqs)} requests, launches {launches}; top-5 scores within "
          f"{K4_BF16_JAX} of the fp32 localizer's (max {score_err:.3e}), the same moments for "
          f"{same} of {len(reqs)}")

    errs = {"K5": 0.0, "K4": 0.0}
    for B in (512, 64, 16):
        x, mask, _ = lstm_inputs(cfg, B, rng, device)
        got = lstm_cuda.bilstm_fused(x.to(bf), mask, layers)
        want = bilstm_bf16(x.to(bf), mask, layers)
        check_twice([got], [lstm_cuda.bilstm_fused(x.to(bf), mask, layers)], [want],
                    [bilstm_bf16(x.to(bf), mask, layers)], f"K5-bf16 B={B}")
        if bool((got[mask == 0] != 0).any()):
            fail("K5-bf16: output at a padded step is not 0")
        if not torch.allclose(got.float(), want.float(), **K5_BF16_TOL):
            fail(f"K5-bf16 B={B}: kernel disagrees with its plain version: max abs err "
                 f"{float((got.float() - want.float()).abs().max()):.3e} ({K5_BF16_TOL})")
        err = float((got.float() - want.float()).abs().max())
        errs["K5"] = max(errs["K5"], err)
        print(f"parity K5-bf16 B={B}: max abs err {err:.3e} (tolerance {K5_BF16_TOL})")
        ins = backbone_inputs(cfg16, model, B, rng, device)
        got = smin_cuda.smin_stack_fused(model, cfg16, *ins)
        want = smin_stack_bf16(model, cfg16, *ins)
        check_twice(got, smin_cuda.smin_stack_fused(model, cfg16, *ins), want,
                    smin_stack_bf16(model, cfg16, *ins), f"K4-bf16 B={B}")
        err = bf16_criterion(got, want, K4_BF16_CARD, f"K4-bf16 B={B}")
        errs["K4"] = max(errs["K4"], err)
        ref = smin_cuda.smin_stack_fused(model, cfg, *(t.float() for t in ins[:3]), *ins[3:])
        dist = [max(float((x - r).abs().max()) for x, r in zip(out, ref)) for out in (got, want)]
        print(f"parity K4-bf16 B={B}: max abs err {err:.3e} (bounds {K4_BF16_CARD}); from the "
              f"fp32 kernel on the same inputs: kernel {dist[0]:.3e}, plain {dist[1]:.3e}")
    # K5-bf16 at every rows-per-cluster choice of its plan, the last block
    # ragged where B is no multiple of it: the kernel against its plain
    # version, padded steps 0, two launches the same bits.
    held = 0
    for B in (8, 16, 64, 512):
        x, mask, _ = lstm_inputs(cfg, B, rng, device)
        x = x.to(bf)
        want = bilstm_bf16(x, mask, layers)
        for rows in lstm_cuda.row_choices(cfg.lstm_hidden_size, itemsize=2):
            got = lstm_cuda.bilstm_fused(x, mask, layers, rows=rows)
            again = lstm_cuda.bilstm_fused(x, mask, layers, rows=rows)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"K5-bf16 B={B} rows={rows}: two launches differ")
            if bool((got[mask == 0] != 0).any()):
                fail(f"K5-bf16 B={B} rows={rows}: output at a padded step is not 0")
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), **K5_BF16_TOL):
                fail(f"K5-bf16 B={B} rows={rows}: kernel disagrees with its plain version: max "
                     f"abs err {err:.3e} ({K5_BF16_TOL})")
            errs["K5"] = max(errs["K5"], err)
            held += 1
    print(f"parity K5-bf16 at every rows-per-cluster choice "
          f"{lstm_cuda.row_choices(cfg.lstm_hidden_size, itemsize=2)}, B=8, 16, 64, 512: {held} "
          f"plans held, max abs err {errs['K5']:.3e}, twice bit for bit, padded steps 0")
    anet16 = dataclasses.replace(anet_cfg, compute_dtype="bfloat16")
    torch.manual_seed(1)
    anet_model = SMIN(anet16).to(device).eval()
    ins = backbone_inputs(anet16, anet_model, 64, rng, device)
    errs["K4_activitynet_b64"] = bf16_criterion(
        smin_cuda.smin_stack_fused(anet_model, anet16, *ins),
        smin_stack_bf16(anet_model, anet16, *ins), K4_BF16_CARD, "K4-bf16 ActivityNet B=64")
    print(f"parity K4-bf16 ActivityNet B=64: max abs err {errs['K4_activitynet_b64']:.3e} "
          f"(bounds {K4_BF16_CARD})")

    library_lstm = cudnn_lstm_bf16(cfg, model, device)
    Nq, N = cfg.max_query_length, cfg.L * (cfg.L + 1) // 2
    times = {}
    for B in (16, 512):
        x, mask, lengths = lstm_inputs(cfg, B, rng, device)
        x = x.to(bf)
        w_bytes = sum(w.numel() * w.element_size() for d in layers for p in d.values()
                      for w in p.values())
        b_ms, b_by = bound_bf16(B * lstm_flops(cfg), bf16_bytes(x, mask) + 2 * B * Nq * cfg.D
                                + w_bytes, B * lstm_flops(cfg))
        times[("K5", B)] = dict(
            ms=cuda_ms(lambda: lstm_cuda.bilstm_fused(x, mask, layers)),
            device_ms=cuda_ms_back_to_back(lambda: lstm_cuda.bilstm_fused(x, mask, layers)),
            plain_ms=cuda_ms(lambda: bilstm_bf16(x, mask, layers)),
            library_ms=cuda_ms(lambda: library_lstm(x, lengths)),
            library_device_ms=cuda_ms_back_to_back(lambda: library_lstm(x, lengths)),
            bound_ms=b_ms, bound_by=b_by)
        ins = backbone_inputs(cfg16, model, B, rng, device)
        w_bytes = sum(2 * w.numel() if w.dim() > 1 else 4 * w.numel()
                      for w in model.smis.parameters()) + param_bytes(model.localization)
        # The port's own work: every contraction of the layers takes bf16
        # operands (the products and their rest); the pooling and heads fp32.
        products = (gemm_flops(cfg, B, "K4", cfg.num_smi_layers)
                    + B * cfg.num_smi_layers * layer_rest(cfg, Nq))
        b_ms, b_by = bound_bf16(products + B * pool_rest(cfg),
                                bf16_bytes(*ins) + w_bytes + 4 * B * (N + 3 * cfg.L), products)
        times[("K4", B)] = dict(
            ms=cuda_ms(lambda: smin_cuda.smin_stack_fused(model, cfg16, *ins)),
            device_ms=cuda_ms_back_to_back(
                lambda: smin_cuda.smin_stack_fused(model, cfg16, *ins), launches=10, reps=3),
            plain_ms=cuda_ms(lambda: smin_stack_bf16(model, cfg16, *ins), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        for k in ("K5", "K4"):
            r = times[(k, B)]
            print(f"time {k}-bf16 B={B}: kernel {r['ms']:.4f} ms (back to back "
                  f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  f"{b2b_note(r)}")

    e2e = {}
    for B in (16, 512):
        vf = torch.from_numpy(rng.standard_normal((B, cfg.T, cfg.input_video_dim))
                              .astype("float32")).to(device)
        vmask = torch.ones((B, cfg.T, 1), device=device)
        qf = torch.from_numpy(rng.standard_normal((B, Nq, cfg.word_dim))
                              .astype("float32")).to(device)
        _, mask, _ = lstm_inputs(cfg, B, rng, device)
        lmask = torch.ones((B, cfg.L), device=device)
        e2e[B] = cuda_ms(lambda: loc16._score(vf, vmask, qf, mask[..., None].contiguous(),
                                              lmask, None, 5))
    mfu = {}
    for B in (16, 512):
        flops = smin_forward_flops(cfg, B)
        t32, t16 = fp32_e2e[B] / 1e3, e2e[B] / 1e3
        mfu[str(B)] = dict(
            flops=flops, fp32_ms=fp32_e2e[B], bf16_ms=e2e[B],
            fp32_of_67=flops / t32 / PEAK_FP32_FLOPS,
            fp32_of_165=flops / t32 / (PEAK_TF32_FLOPS / 3),
            bf16_of_989=flops / t16 / PEAK_BF16_FLOPS)
        print(f"serving forward + top-5 B={B}: fp32 {fp32_e2e[B]:.4f} ms "
              f"({B / fp32_e2e[B] * 1e3:.1f} pairs/s), bf16 {e2e[B]:.4f} ms "
              f"({B / e2e[B] * 1e3:.1f} pairs/s) on the device; {flops / 1e9:.2f} GFLOP; MFU fp32 "
              f"{mfu[str(B)]['fp32_of_67']:.4f} of 67 TFLOP/s ({mfu[str(B)]['fp32_of_165']:.4f} of "
              f"165 TFLOP/s of 3xTF32), bf16 {mfu[str(B)]['bf16_of_989']:.4f} of 989 TFLOP/s")
    return dict(launches=launches, errs=errs, score_err=score_err, times=times,
                pairs_per_s={str(B): B / e2e[B] * 1e3 for B in e2e}, mfu=mfu)


# ------------------------------------------------------------------------- #
# bf16 training on the whole-layer route (K1-bf16, K2-bf16, K3-bf16)
# ------------------------------------------------------------------------- #
# K2-bf16 and K3-bf16 against their plain bf16 versions: the bulk criterion
# of tests/test_torch_bf16_train.py (mean |diff|, 98th percentile and max over
# the mean |reference|) cut tenfold for the mean and the 98th percentile and
# held at the criterion itself for the max: the kernel and its plain version
# round the same values at the same places, but their fp32 sums in another
# order move a rare bf16 rounding by one unit in the last place (a few
# thousand of 1.1 million elements of dfc), and one such flip at a value far
# above the mean exceeds the tenfold cut of the max: K2's cu up to 0.08 of
# its mean |value| at B=64, K3's dfw, whose padded words leave its mean
# small, up to 0.34 (PERF.md §6). Weight gradients against the layer's
# largest. K1-bf16 within one bf16
# rounding (2^-8 of the value) of its plain version's fp32 value, which the
# plain version rounds once, on top of the fp32 kernel's own tolerance
# against that value (K1_TOL: the two sum in other orders, so a value near a
# rounding boundary may round the other way). The step's loss: the CPU
# tests' rtol 2e-2 cut tenfold.
K23_BF16_CARD = dict(mean=2e-3, p98=1e-2, max=0.5)
BF16_LOSS_RTOL = 2e-3
K1_BF16_REL = 2.0 ** -8
BF16_TRAIN_CONFIGS = ("charadessta", "tacos")


def bulk_stats(got, want, name, scale=None):
    """mean, 98th percentile and max of |got - want| over ``scale`` (default
    the mean |want|); ``got`` must be finite."""
    import torch

    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    w = want.float()
    d = (got.float() - w).abs().flatten()
    scale = float(w.abs().mean()) if scale is None else scale
    return dict(mean=float(d.mean()) / scale, max=float(d.max()) / scale,
                p98=float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.98)) / scale)


def bulk_rel(got, want, bounds, name, scale=None):
    """`bulk_stats` of ``got`` against ``want`` within ``bounds``; returns
    the three."""
    scale = float(want.float().abs().mean()) if scale is None else scale
    stats = bulk_stats(got, want, name, scale)
    if any(stats[k] > bounds[k] for k in bounds):
        fail(f"{name}: kernel disagrees with its plain version: {stats} of the scale "
             f"{scale:.3e} (bounds {bounds})")
    return stats


# A K3-bf16 gradient within the bulk criterion's mean and 98th percentile
# against its plain version but past its max (on a TACoS draw, dfw's max
# reached 0.748 of its mean |value| against the criterion's 0.5: a bf16
# rounding flip of a value far above the mean, which dfw's padded words
# keep small) is held to the layer's gradient in float64 on the same bf16
# values (`layer_grads_f64`): its mean, 98th percentile and max distance
# from float64 no more than WITNESS_RATIO times the plain version's own, as
# the card tests hold K3-bf16 at L=64 and K7-bf16's dfs. A kernel that is
# wrong is farther from float64 than its plain version; one that only
# rounds once elsewhere is not.
WITNESS_RATIO = 1.5


def layer_grads_f64(smin_train_cuda, weights, ins, L, dcu, dmu, dbu):
    """The SMI layer's five input gradients in float64 on the same bf16
    values of the carry, the weights and the cotangents (the layer's
    function without rounding)."""
    import torch

    with torch.enable_grad():
        leaves = [t.detach().double().requires_grad_(True) for t in ins[:5]]
        cu, mu, bu = smin_train_cuda.smi_layer_plain([w.double() for w in weights], *leaves,
                                                     *(t.double() for t in ins[5:]), L)
        outs, cts = [mu, bu], [dmu.double(), dbu.double()]
        if dcu is not None:
            outs.append(cu)
            cts.append(dcu.double())
        return [g.detach() for g in torch.autograd.grad(outs, leaves, cts)]


def held_to_f64(got, want, exact, stats, name):
    """``got`` (the kernel's) and ``want`` (its plain version's) against
    ``exact`` (float64), over exact's mean |value|: fails unless each of the
    kernel's mean, p98 and max is within WITNESS_RATIO times the plain
    version's. Returns both."""
    import torch

    def rel(x):
        d = (x.double() - exact).abs().flatten()
        q = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.98))
        return dict(mean=float(d.mean()) / scale, p98=q / scale, max=float(d.max()) / scale)

    scale = float(exact.abs().mean())
    kern, plain = rel(got), rel(want)
    report = (f"{name}: {stats} of the mean |reference| (bounds {K23_BF16_CARD}); against "
              f"float64: kernel {kern}, plain version {plain}")
    if any(kern[k] > WITNESS_RATIO * plain[k] for k in kern):
        fail(f"{report}: the kernel is farther from float64 than {WITNESS_RATIO} times its "
             f"plain version")
    print(f"{report}: held to float64")
    return dict(kernel=kern, plain=plain)


def within_one_rounding(got, ref, name, tol=K1_TOL):
    """A bf16 output against its plain version's fp32 value: |diff| <=
    (2^-8 + tol's rtol) |ref| + tol's atol everywhere (``tol``: the fp32
    kernel's own tolerance against that value). Returns the max abs error."""
    import torch

    d = (got.float() - ref).abs()
    bound = (K1_BF16_REL + tol["rtol"]) * ref.abs() + tol["atol"]
    if not torch.isfinite(got.float()).all() or bool((d > bound).any()):
        k = int(torch.argmax(d - bound))
        fail(f"{name}: kernel farther than one bf16 rounding from its plain version "
             f"(max abs err {float(d.max()):.3e}; worst {float(got.flatten()[k])} against "
             f"{float(ref.flatten()[k])}, bound {float(bound.flatten()[k]):.3e})")
    return float(d.max())


def bf16_launches():
    """Every train kernel's launches since `reset_bf16_launches`: the bf16
    variants as "Kx-bf16", the fp32 kernels (which must stay 0 at bf16)
    under their own names, and the pair's."""
    out = {}
    for k, fn in mode_counters().items():
        out[k] = fn.launches
        if hasattr(fn, "launches_bf16"):
            out[f"{k}-bf16"] = fn.launches_bf16
    out.update(pair_counts())
    return out


def reset_bf16_launches():
    for fn in mode_counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
    reset_pair_counts()


def plain_stack_bf16(blocks, fc, fm, fb, fw, fs, qmask, lmask, vmask, L):
    """The whole-layer stack through the plain bf16 layer (K2-bf16's plain
    version, K3-bf16's under autograd)."""
    from video_moment_localization_tpu_torch.models import smin

    for block in blocks:
        fc, fm, fb = smin.smi_layer_bf16(dict(zip(smin.BLOCK_WEIGHT_NAMES,
                                                  smin.block_weights(block))),
                                         fc, fm, fb, fw, fs, qmask, lmask, vmask, L)
    return fm, fb


class plain_bf16_kernels:
    """Within it, the differentiable entries of K6-bf16, K7-bf16, K8-bf16,
    K10-bf16 and of K1-bf16 / K2-bf16 (or K9-bf16) / K3-bf16 are their plain
    bf16 versions under autograd, so the same forward and step run through
    the plain versions on the card."""

    def __enter__(self):
        from video_moment_localization_tpu_torch.ops import (
            content_cuda,
            content_train_cuda,
            proposal_cuda,
            smin_train_cuda,
        )

        self.saved = [(proposal_cuda, "proposal_features_packed_fused"),
                      (proposal_cuda, "proposal_features_rows"),
                      (proposal_cuda, "proposal_features_dense_fused"),
                      (smin_train_cuda, "smi_stack_layers"),
                      (content_train_cuda, "content_rows_train"),
                      (content_cuda, "content_unit_fused")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        proposal_cuda.proposal_features_packed_fused = (
            lambda f, lm, L, C: proposal_cuda.proposal_rows_forward_plain_bf16(f, lm, L, C))
        proposal_cuda.proposal_features_rows = proposal_cuda.proposal_features_packed_fused
        proposal_cuda.proposal_features_dense_fused = (
            lambda f, mm, L, C: proposal_cuda.proposal_rows_forward_plain_bf16(f, mm.float(), L, C))
        smin_train_cuda.smi_stack_layers = plain_stack_bf16
        content_train_cuda.content_rows_train = (
            lambda w, fc, fbar, fw, fs, qm, vm, ws=None:
            content_train_cuda.content_rows_plain_bf16(w, fc, fbar, fw, fs, qm, vm))
        content_cuda.content_unit_fused = (
            lambda unit, fc, fw, fs, fm, qm, vm: content_cuda.content_unit_plain_bf16(
                content_cuda.unit_weights(unit), fc, fm, fw, fs, qm, vm))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def grads_by_module(model):
    """Each parameter's gradient with the largest magnitude of its module (an
    SMI layer, an encoder, a head)."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    scales = {}
    for n, g in grads.items():
        key = ".".join(n.split(".")[:2])
        scales[key] = max(scales.get(key, 0.0), float(g.abs().max()))
    return grads, {n: scales[".".join(n.split(".")[:2])] for n in grads}


def train_bf16(config16, label, initial, batch, per_step, device, steps=TRAIN_STEPS):
    """``steps`` Adam steps of a bf16 train step through the kernels from
    ``initial``, held to the same steps through the plain bf16 versions on
    the card (`plain_bf16_kernels`): every loss (BF16_LOSS_RTOL), and the
    gradients of step 1 (K23_BF16_CARD against each module's largest); the
    counters (from 0 around the steps) rise by steps x ``per_step`` and no
    other moves. Returns (step, model, losses, launches, errors)."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN, smin_forward
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.train.loss import smin_loss

    cfg16 = config16.model
    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
            "moment_mask")
    model = SMIN(cfg16)
    model.load_state_dict(initial)
    step = make_train_step(cfg16, model, build_optimizer(config16, model), device=device)
    plain_model = SMIN(cfg16).to(device)
    plain_model.load_state_dict(initial)
    plain_opt = build_optimizer(config16, plain_model)
    reset_bf16_launches()
    losses, plain_losses, worst = [], [], 0.0
    for k in range(steps):
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        if not abs(losses[-1]) < float("inf"):
            fail(f"{label} step {k + 1}: loss {losses[-1]}")
        launches = bf16_launches()
        plain_model.train()
        plain_opt.zero_grad(set_to_none=True)
        with torch.enable_grad(), plain_bf16_kernels():
            loss, _ = smin_loss(smin_forward(plain_model, cfg16, *(batch.get(n) for n in keys)),
                                batch)
            loss.backward()
        if bf16_launches() != launches:
            fail(f"{label}: the plain versions' step launched a kernel")
        if k == 0:
            got, _ = grads_by_module(model)
            want, scales = grads_by_module(plain_model)
            for name, g in got.items():
                if g is None or g.dtype != torch.float32:
                    fail(f"{label} step 1: parameter {name} has no fp32 gradient")
                s = bulk_rel(g, want[name], K23_BF16_CARD, f"{label} step 1 gradient of {name}",
                             scale=scales[name])
                worst = max(worst, s["max"])
        plain_opt.step()
        plain_losses.append(float(loss.detach()))
    want = {k: steps * per_step.get(k, 0) for k in launches}
    print(f"{label}: {steps} steps at B={batch['length_mask'].shape[0]}, losses {losses}, "
          f"launches { {k: v for k, v in launches.items() if v} }; step-1 gradients within "
          f"{worst:.3e} (max) of each module's largest of the plain bf16 versions'")
    if launches != want:
        fail(f"{label}: kernel launches of {steps} train steps: {launches}, expected {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"{label}: plain bf16 versions' losses {plain_losses}; max relative difference "
          f"{rel:.3e} (tolerance {BF16_LOSS_RTOL})")
    if rel > BF16_LOSS_RTOL:
        fail(f"{label}: losses differ from the plain bf16 versions' by {rel:.3e}")
    if steps > 1 and not losses[-1] < losses[0]:
        fail(f"{label}: {steps} steps on one batch did not lower the loss: {losses}")
    del plain_model, plain_opt
    torch.cuda.empty_cache()
    return step, model, losses, launches, dict(loss_rel=rel, grad_max=worst)


def check_eval_step_bf16(cfg16, model, batch, device):
    """The bf16 eval step on the batch: K5-bf16 and K4-bf16 launch once
    each, its scores equal those of their plain bf16 versions on the same
    batch (phase 19's K4-bf16 bounds), its loss too (EVAL_LOSS_RTOL x 10)."""
    import torch

    from video_moment_localization_tpu_torch.models import smin
    from video_moment_localization_tpu_torch.models.lstm import bilstm_bf16, lstm_layers
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.parallel.steps import make_eval_step
    from video_moment_localization_tpu_torch.train.loss import smin_loss

    bf = torch.bfloat16
    k5, k4 = lstm_cuda.bilstm_fused.launches_bf16, smin_cuda.smin_stack_fused.launches_bf16
    ev = make_eval_step(cfg16, model, device=device)(batch)
    torch.cuda.synchronize()
    if (lstm_cuda.bilstm_fused.launches_bf16,
            smin_cuda.smin_stack_fused.launches_bf16) != (k5 + 1, k4 + 1):
        fail("bf16 eval step: K5-bf16 and K4-bf16 did not launch once each")
    with torch.no_grad():
        lmask = batch["length_mask"].float()
        vf, qf = batch["video_features"].to(bf), batch["query_features"].to(bf)
        fv = smin.video_encoder(model.backbone.videoencoder, vf, batch["video_mask"])
        # K5-bf16's plain version, gathered as query_encoder gathers fs.
        qmask, H = batch["query_mask"][..., 0], cfg16.lstm_hidden_size
        fw = bilstm_bf16(qf, qmask, lstm_layers(model.backbone.queryencoder.lstm,
                                                smin.module_weights(
                                                    model.backbone.queryencoder.lstm, bf)))
        last = qmask.sum(dim=1).long().clamp(min=1) - 1
        fs = torch.cat([fw[torch.arange(fw.shape[0], device=device), last, :H], fw[:, 0, H:]], -1)
        want = smin.smin_stack_bf16(model, cfg16, fv * fs[:, None], fw, fs, batch["query_mask"],
                                    lmask, packed_valid_mask(lmask))
        plain_loss = float(smin_loss(want, batch)[0])
        got = smin.smin_forward_inference(model, cfg16, batch["video_features"],
                                          batch["video_mask"], batch["query_features"],
                                          batch["query_mask"], lmask)
    err = bf16_criterion(got, want, K4_BF16_CARD, "bf16 eval forward (K5-bf16, K4-bf16)")
    ev_loss = float(ev["loss"])
    if not abs(ev_loss - plain_loss) <= 10 * EVAL_LOSS_RTOL * abs(plain_loss):
        fail(f"bf16 eval loss {ev_loss} against the plain versions' {plain_loss}")
    print(f"bf16 eval step at B={lmask.shape[0]}: scores within {err:.3e} of the plain bf16 "
          f"versions' (bounds {K4_BF16_CARD}), loss {ev_loss:.6f} against {plain_loss:.6f}")
    return err


def bf16_files(seed, tmp):
    """bf16 training from feature files on the card: the CLI at
    ``--compute_dtype bfloat16`` on the Charades config (64 train and 16 test
    videos of one query: one step and one eval batch an epoch), then
    ``--test`` at bf16; and `Trainer.fit` at the TACoS model's widths (T=128,
    L=32, Nq=14, dv=4096, B=64, one epoch) on a Charades-style directory of
    that width (the card machine has no h5py for the TACoS reader). The bf16
    counters (from 0 around each run) must show one K1-bf16 pair and 3
    K2-bf16 / K3-bf16 launches per step, K5-bf16 / K4-bf16 per eval batch,
    and no fp32 kernel; every loss finite."""
    import math

    import torch
    import yaml

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
    from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.train.trainer import Trainer, build_datasets

    def launches():
        out = bf16_launches()
        out.update({"K5-bf16": lstm_cuda.bilstm_fused.launches_bf16,
                    "K4-bf16": smin_cuda.smin_stack_fused.launches_bf16,
                    "K5": lstm_cuda.bilstm_fused.launches, "K4": smin_cuda.smin_stack_fused.launches})
        return {k: v for k, v in out.items() if v and not k.startswith("CA")}

    def reset():
        reset_bf16_launches()
        for fn in (lstm_cuda.bilstm_fused, smin_cuda.smin_stack_fused):
            fn.launches = fn.launches_bf16 = 0

    result = {}
    for name, dv, videos, widths in (
            ("charadessta", 1024, {"train": 64, "test": 16}, {}),
            ("tacos", 4096, {"train": 64, "test": 64},
             dict(T=128, L=32, max_query_length=14, input_video_dim=4096, batch_size=64))):
        data = write_charades_style_dir(os.path.join(tmp, f"{name}-data"), queries_per_video=1,
                                        input_video_dim=dv, seed=seed, signal_strength=1.0,
                                        videos_per_split=videos)
        path = files_config(os.path.join(tmp, f"{name}-bf16"), data, resume=False)
        with open(path) as fh:
            raw = yaml.safe_load(fh)
        raw.update(widths, compute_dtype="bfloat16", num_epochs=1)
        with open(path, "w") as fh:
            yaml.safe_dump(raw, fh)
        cfg = load_config(path)
        reset()
        if name == "charadessta":
            out = run_cli(["--config_path", path])
        else:
            trainer = Trainer(cfg, device="cuda")
            train, evald = build_datasets(cfg)
            trainer.fit(BatchLoader(train, cfg.batch_size, shuffle=True,
                                    num_workers=cfg.num_workers, seed=cfg.seed),
                        BatchLoader(evald, cfg.batch_size, shuffle=False,
                                    num_workers=cfg.num_workers, seed=cfg.seed))
            del trainer
        torch.cuda.synchronize()
        got = launches()
        n = cfg.model.num_smi_layers
        train_ds, eval_ds = build_datasets(cfg)
        steps = -(-len(train_ds) // cfg.batch_size)
        evals = -(-len(eval_ds) // cfg.batch_size)
        want = {"K1f-bf16": steps, "K1b-bf16": steps, "K2-bf16": n * steps, "K3-bf16": n * steps,
                "K5-bf16": evals, "K4-bf16": evals}
        stats = read_stats(path)
        losses = stats["train_loss"] + stats["eval_loss"]
        print(f"bf16 from files, {name} widths (T={cfg.model.T}, L={cfg.model.L}, "
              f"B={cfg.batch_size}): one epoch, launches {got}, train / eval loss {losses}")
        if got != want or not all(math.isfinite(x) for x in losses):
            fail(f"bf16 from files ({name}): launches {got}, expected {want}; losses {losses}")
        if name == "charadessta":
            metrics = metric_lines(run_cli(["--config_path", path, "--test"]), "bf16 --test")
            print(f"bf16 from files: --test at bf16 printed the 8 metrics {metrics}")
        result[name] = dict(launches=got, train_loss=stats["train_loss"],
                            eval_loss=stats["eval_loss"])
        torch.cuda.empty_cache()
    return result


def phase_bf16_train(config, seed, rng, device):
    """Phase 20: bf16 training on the whole-layer route. K1-bf16 (forward
    and backward), K2-bf16 and K3-bf16 against their plain bf16 versions on
    the backbone's outputs at the Charades width (B=64, 4) and the TACoS
    width (B=64), K1-bf16's backward and K3-bf16 twice bit for bit; 3 Adam
    steps at B=64 held to the same steps through the plain bf16 versions;
    one TACoS step at its batch of 64; the bf16
    eval step; times against the plain versions and bounds; the GEMM's bf16
    nn / tn layouts at K3's products; the bf16 and the fp32 step in ms."""
    import dataclasses

    import torch

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.models.smin import SMIN, backbone, block_weights
    from video_moment_localization_tpu_torch.ops import gemm_cuda, proposal_cuda, smin_train_cuda
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    bf = torch.bfloat16
    cfg16 = dataclasses.replace(config.model, compute_dtype="bfloat16")
    config16 = dataclasses.replace(config, model=cfg16)
    L, C, D, T, Nq = cfg16.L, cfg16.C, cfg16.D, cfg16.T, cfg16.max_query_length
    N = L * (L + 1) // 2
    torch.manual_seed(seed + 20)
    model = SMIN(cfg16).to(device).eval()
    cweights = smin_train_cuda.layer_weights_for(
        [w.detach() for w in block_weights(model.smis[1])], bf)
    errs = {"K1f": 0.0, "K1b": 0.0, "K2": 0.0, "K3": 0.0, "K3_rel": 0.0}
    stats = {}
    witnesses = {}
    cases = {}
    # The TACoS width (N*C = 2112, Nq = 14) takes this route at bf16 only.
    tacos = load_config(os.path.join(REPO, "config", "tacos.yml"))
    tacos16 = dataclasses.replace(tacos, model=dataclasses.replace(tacos.model,
                                                                   compute_dtype="bfloat16"))
    torch.manual_seed(seed + 23)
    tmodel = SMIN(tacos16.model).to(device).eval()
    tweights = smin_train_cuda.layer_weights_for(
        [w.detach() for w in block_weights(tmodel.smis[1])], bf)
    for name, mcfg, mdl, weights, B in (("Charades", cfg16, model, cweights, TRAIN_BATCH),
                                        ("Charades", cfg16, model, cweights, 4),
                                        ("TACoS", tacos16.model, tmodel, tweights, TRAIN_BATCH)):
        tag = f"{name} B={B}"
        L, C, T = mcfg.L, mcfg.C, mcfg.T
        # The generator's state before this case's draws, so that a case
        # can be drawn again alone (tests/test_torch_cuda.py holds one so).
        print(f"draw {tag}: generator state {json.dumps(rng.bit_generator.state)}")
        batch = {k: v.to(device) for k, v in synthetic_batch(mcfg, B, rng).items()}
        with torch.no_grad():
            f, fs, fw = backbone(mdl.backbone, mcfg, batch["video_features"].to(bf),
                                 batch["video_mask"], batch["query_features"].to(bf),
                                 batch["query_mask"], fused_lstm=False)
        lmask, qmask = batch["length_mask"].float(), batch["query_mask"]
        vmask = packed_valid_mask(lmask).contiguous()
        f = f.contiguous()
        got = proposal_cuda.proposal_rows_forward(f, lmask, L, C)
        ref = proposal_features_packed(f.float(), lmask, L, C)
        e1 = max(within_one_rounding(g, r, f"K1-bf16 forward {tag}") for g, r in zip(got, ref))
        cots = [randn_like(t, rng).to(bf) for t in ref]
        dgot = proposal_cuda.proposal_rows_backward(lmask, T, L, C, *cots)
        dref = proposal_cuda.proposal_backward_plain(lmask, T, L, C, *(c.float() for c in cots))
        e2 = within_one_rounding(dgot, dref, f"K1-bf16 backward {tag}")
        check_repeatable(dgot, lambda: proposal_cuda.proposal_rows_backward(
            lmask, T, L, C, *cots), f"K1-bf16 backward {tag}")
        print(f"parity K1-bf16 {tag}: forward max abs err {e1:.3e}, backward {e2:.3e} (within "
              f"one bf16 rounding of the plain version's fp32 value), a second backward equal "
              f"bit for bit")
        errs["K1f"], errs["K1b"] = max(errs["K1f"], e1), max(errs["K1b"], e2)

        ins = [t.contiguous() for t in (*got, fw, fs, qmask, lmask, vmask)]
        cu, mu, bu = smin_train_cuda.smi_layer_forward(weights, *ins, L)
        want = smin_train_cuda.smi_layer_plain(weights, *ins, L)
        for g, w, out in zip((cu, mu, bu), want, ("cu", "mu", "bu")):
            s = bulk_rel(g, w, K23_BF16_CARD, f"K2-bf16 {tag} {out}")
            stats[f"K2 {tag} {out}"] = s
            errs["K2"] = max(errs["K2"], float((g.float() - w.float()).abs().max()))
        print(f"parity K2-bf16 {tag}: "
              + ", ".join(f"{o} {stats[f'K2 {tag} {o}']}" for o in ("cu", "mu", "bu"))
              + f" of the mean |reference| (bounds {K23_BF16_CARD})")
        dcu, dmu, dbu = [randn_like(t, rng).to(bf) for t in want]
        for cot in (dcu, None):
            a = smin_train_cuda.smi_layer_backward(weights, *ins, L, cot, dmu, dbu)
            if cot is not None:
                check_all_repeatable(a, smin_train_cuda.smi_layer_backward(
                    weights, *ins, L, cot, dmu, dbu), f"K3-bf16 {tag}")
            b = smin_train_cuda.smi_layer_backward_plain(weights, *ins, L, cot, dmu, dbu)
            exact = []
            for k, (g, w, out) in enumerate(zip(a[:5], b[:5], ("dfc", "dfm", "dfb", "dfw", "dfs"))):
                key = f"K3 {tag} {out}{'' if cot is not None else ' top'}"
                s = bulk_stats(g, w, f"K3-bf16 {tag} {out}")
                if s["mean"] > K23_BF16_CARD["mean"] or s["p98"] > K23_BF16_CARD["p98"]:
                    fail(f"K3-bf16 {tag} {out}: kernel disagrees with its plain version: {s} "
                         f"of the mean |reference| (bounds {K23_BF16_CARD})")
                if s["max"] > K23_BF16_CARD["max"]:
                    if not exact:
                        exact.extend(layer_grads_f64(smin_train_cuda, weights, ins, L, cot, dmu, dbu))
                    witnesses[key] = held_to_f64(g, w, exact[k], s, f"K3-bf16 {tag} {out}")
                stats[key] = s
                errs["K3"] = max(errs["K3"], float((g.float() - w.float()).abs().max()))
            scale = max(float(w.abs().max()) for w in b[5])
            for k, (g, w) in enumerate(zip(a[5], b[5])):
                if g.dtype != torch.float32:
                    fail(f"K3-bf16: weight gradient {k} is {g.dtype}")
                s = bulk_rel(g, w, K23_BF16_CARD, f"K3-bf16 {tag} weight gradient {k}", scale)
                errs["K3_rel"] = max(errs["K3_rel"], s["max"])
            print(f"parity K3-bf16 {tag} dcu={'yes' if cot is not None else 'none'}: 5 "
                  f"activation gradients, worst max {max(v['max'] for k, v in stats.items() if k.startswith(f'K3 {tag}')):.3e} "
                  f"of the mean |reference|, 20 fp32 weight gradients within "
                  f"{errs['K3_rel']:.3e} of the largest"
                  + ("; a second launch equal bit for bit" if cot is not None else ""))
        cases[tag] = (f, lmask, cots, ins, (dcu, dmu, dbu))
        del batch

    # The main path: 3 Adam steps at B=64, then the eval step.
    torch.manual_seed(seed + 21)
    initial = SMIN(cfg16).state_dict()
    batch = {k: v.to(device) for k, v in synthetic_batch(cfg16, TRAIN_BATCH, rng).items()}
    n = cfg16.num_smi_layers
    per_step = {"K1f-bf16": 1, "K1b-bf16": 1, "K2-bf16": n, "K3-bf16": n, "CAf": 2 * n, "CAb": n}
    step16, model16, losses, launches, step_err = train_bf16(config16, "bf16 training", initial,
                                                            batch, per_step, device)
    eval_err = check_eval_step_bf16(cfg16, model16, batch, device)

    # One TACoS step (T=128, L=32, Nq=14) at its batch on the whole-layer route.
    del tmodel, tweights
    torch.manual_seed(seed + 22)
    tinitial = SMIN(tacos16.model).state_dict()
    tbatch = {k: v.to(device) for k, v in synthetic_batch(tacos16.model, tacos16.batch_size,
                                                           rng).items()}
    _, _, tlosses, tlaunches, tacos_err = train_bf16(tacos16, "bf16 training TACoS", tinitial,
                                                     tbatch, per_step, device, steps=1)
    del tbatch
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bf16-") as tmp:
        files = bf16_files(seed, tmp)

    # Times at B=64 on the first case's inputs.
    B, L, C, T, weights = TRAIN_BATCH, cfg16.L, cfg16.C, cfg16.T, cweights
    f, lmask, cots, ins, (dcu, dmu, dbu) = cases[f"Charades B={B}"]
    res = {}
    wc = dense_content_matrix(cfg16, device).to(bf)
    carry16 = 2 * B * (N * C + N + L) * D
    seg_adds = segment_adds(cfg16)
    k1_bytes = bf16_bytes(f) + 4 * B * L + carry16
    b_ms, b_by = bound_bf16(B * seg_adds, k1_bytes, 0)
    res["K1f"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_rows_forward(f, lmask, L, C)),
        device_ms=cuda_ms_back_to_back(lambda: proposal_cuda.proposal_rows_forward(f, lmask, L, C)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_rows_forward_plain_bf16(f, lmask, L, C)),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f)),
        bound_ms=b_ms, bound_by=b_by)
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, N * C, D)
    b_ms, b_by = bound_bf16(*proposal_bwd_work(cfg16, lmask, 2), 0)
    res["K1b"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_rows_backward(lmask, T, L, C, *cots)),
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_rows_backward(lmask, T, L, C, *cots)),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_rows_backward_plain_bf16(
            lmask, T, L, C, *cots)),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g)),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g)),
        bound_ms=b_ms, bound_by=b_by)
    w_bytes = bf16_bytes(*weights)
    shared16 = bf16_bytes(*ins[3:])
    contractions = gemm_flops(cfg16, B, "K2") + B * layer_rest(cfg16, Nq)
    b_ms, b_by = bound_bf16(contractions, 2 * carry16 + shared16 + w_bytes, contractions)
    res["K2"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_layer_forward(weights, *ins, L)),
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_layer_forward(weights, *ins, L), launches=10, reps=3),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_layer_plain(weights, *ins, L), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    # K3: the layer's recompute and its backward: the products of
    # model_gemm_shapes' K3 entries and three times the attentions' rest; in
    # the carry, its cotangents, the shared inputs and the weights, out the
    # carry's, fw's and fs's gradients and the fp32 weight gradients (the
    # layer's output is recomputed, not moved).
    contractions = gemm_flops(cfg16, B, "K3") + 3 * B * layer_rest(cfg16, Nq)
    k3_bytes = 3 * carry16 + 2 * shared16 + w_bytes + sum(4 * w.numel() for w in weights)
    b_ms, b_by = bound_bf16(contractions, k3_bytes, contractions)
    res["K3"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu),
                   iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu),
            launches=5, reps=3),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_layer_backward_plain(
            weights, *ins, L, dcu, dmu, dbu), warmup=1, iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        split=device_split(
            lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu)))
    for k in ("K1f", "K1b", "K2", "K3"):
        r = res[k]
        print(f"time {k}-bf16 B={B}: kernel {r['ms']:.4f} ms (back to back "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){b2b_note(r)}{split_note(r)}")

    # The GEMM's bf16 nn and tn layouts on K3's largest products.
    gemm_rows = []
    NC = N * C
    for prod, layout, M, Nn, K in (("dfcc", "nn", B * NC, cfg16.dl, D),
                                   ("dfc", "nn", B * NC, D, cfg16.dl),
                                   ("dx1 dx2 (one)", "nn", B * N, D, D),
                                   ("dW c_out", "tn", D, cfg16.dl, B * NC),
                                   ("dW c_hat", "tn", cfg16.dl, D, B * NC),
                                   ("dW conv_fb + conv_fc", "tn", D, 2 * D, B * N)):
        if layout == "nn":
            A = torch.randn(M, K, device=device).to(bf)
            W = torch.randn(K, Nn, device=device).to(bf)
        else:
            A = torch.randn(K, M, device=device).to(bf)
            W = torch.randn(K, Nn, device=device).to(bf)
        ms = cuda_ms(lambda: gemm_cuda.gemm_bf16_layout(layout, A, W))
        lib_ms = cuda_ms(lambda: torch.matmul(A.t() if layout == "tn" else A, W))
        tflops = 2.0 * M * Nn * K / ms / 1e9
        gemm_rows.append(dict(product=f"K3-bf16 {prod}", layout=layout, M=M, N=Nn, K=K, ms=ms,
                              tflops=tflops, share_of_989=tflops / 989.0,
                              library_ms=lib_ms))
        print(f"gemm bf16 {layout} K3 {prod} ({M}x{Nn}x{K}): {ms:.4f} ms, {tflops:.1f} TFLOP/s "
              f"({tflops / 989.0:.3f} of 989), torch.matmul {lib_ms:.4f} ms")

    # The bf16 step beside the fp32 step, from the same weights on one batch.
    res["step_ms"] = step_wall_ms(step16, batch, iters=9)
    res["step_event_ms"] = cuda_ms(lambda: step16(batch), warmup=0, iters=7)
    model32 = SMIN(config.model)
    model32.load_state_dict(initial)
    step32 = make_train_step(config.model, model32, build_optimizer(config, model32),
                             device=device)
    res["fp32_step_ms"] = step_wall_ms(step32, batch, iters=9)
    res["fp32_step_event_ms"] = cuda_ms(lambda: step32(batch), warmup=0, iters=7)
    print(f"time train step B={B}: bf16 {res['step_ms']:.4f} ms wall, {res['step_event_ms']:.4f} "
          f"ms between CUDA events; fp32 {res['fp32_step_ms']:.4f} ms wall, "
          f"{res['fp32_step_event_ms']:.4f} ms between CUDA events")
    del step32, model32, step16, model16
    torch.cuda.empty_cache()
    return dict(errs=errs, stats=stats, witnesses=witnesses, launches=launches, losses=losses,
                times=res, gemm=gemm_rows, eval_err=eval_err, step_err=step_err, tacos_losses=tlosses,
                tacos_launches=tlaunches, tacos_err=tacos_err, files=files)


# ------------------------------------------------------------------------- #
# bf16 on the content-unit route and in the packed unit loop (K6-bf16,
# K7-bf16, K10-bf16), and the route fork's timings
# ------------------------------------------------------------------------- #
# K6-bf16 is K1-bf16's device code: within one bf16 rounding of its plain
# version's fp32 value (`within_one_rounding`). K7-bf16 and K10-bf16 against
# their plain bf16 versions (which round where the kernels round) by phase
# 20's `K23_BF16_CARD`; the steps through `train_bf16`.
def serve_content16(cfg16, model, batch, per_call, label):
    """The grad-free forward of ``cfg16`` (``fused_smi: False``: the
    training route's forward kernels without a graph) on the batch: the
    counters rise by ``per_call`` and no other moves; the scores held to the
    same forward through the plain bf16 versions (phase 19's K4-bf16 bounds)."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import smin_forward_inference

    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")
    reset_bf16_launches()
    got = smin_forward_inference(model, cfg16, *(batch[k] for k in keys))
    torch.cuda.synchronize()
    counts = bf16_launches()
    launches = {k: v for k, v in counts.items() if v and not k.startswith("CA")}
    with plain_bf16_kernels():
        want = smin_forward_inference(model, cfg16, *(batch[k] for k in keys))
    torch.cuda.synchronize()
    if bf16_launches() != counts:
        fail(f"{label}: the plain versions' forward launched a kernel")
    if launches != per_call:
        fail(f"{label}: launches {launches}, expected {per_call}")
    err = bf16_criterion(got, want, K4_BF16_CARD, label)
    print(f"{label}: launches {launches}, scores within {err:.3e} of the plain bf16 versions' "
          f"(bounds {K4_BF16_CARD})")
    return err, launches


def route_fork_ms(cfg, model, f, fw, fs, qmask, lmask, dtype):
    """One ActivityNet step's three-layer stack, forward and backward (a
    masked readout of fm and fb), on the whole-layer route (K1 -> K2 / K3)
    and on the content-unit route (K6 -> K7) at ``dtype``, called directly:
    median CUDA-event ms of each."""
    import torch

    from video_moment_localization_tpu_torch.ops import content_train_cuda, proposal_cuda
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import smi_stack_layers

    L, C = cfg.L, cfg.C
    vmask = packed_valid_mask(lmask).contiguous()
    routes = {"whole_layer": (proposal_cuda.proposal_features_rows, smi_stack_layers),
              "content_unit": (proposal_cuda.proposal_features_packed_fused,
                               content_train_cuda.smi_stack_content_train)}
    ins = [t.to(dtype).detach() for t in (f, fw, fs)]
    wm = torch.randn(fs.shape[0], L * (L + 1) // 2, cfg.D, device=f.device)
    wb = torch.randn(fs.shape[0], L, cfg.D, device=f.device)
    out = {}
    for name, (proposal, stack) in routes.items():
        def run():
            with torch.enable_grad():
                f_, fw_, fs_ = (t.requires_grad_(True) for t in ins)
                fc, fm, fb = proposal(f_, lmask, L, C)
                fm, fb = stack(model.smis, fc, fm, fb, fw_, fs_, qmask, lmask, vmask, L)
                s = (fm.float() * wm).sum() + (fb.float() * wb).sum()
                torch.autograd.grad(s, [f_, fw_, fs_] + list(model.smis.parameters()))
        out[name] = cuda_ms(run, warmup=2, iters=5)
        torch.cuda.empty_cache()
    return out


def phase_bf16_content(anet, config, seed, rng, device):
    """Phase 21: bf16 on the content-unit route and in the packed unit loop.
    K6-bf16, K7-bf16 (ActivityNet, B=64) and K10-bf16 (Charades, B=64)
    against their plain bf16 versions on the bf16 backbone's outputs, twice
    bit for bit; 3 Adam steps of the ActivityNet bf16 step at B=64 held to
    the same steps through the plain bf16 versions, and its bf16 eval step;
    one compat_head + fused_content bf16 step at Charades B=64 the same way;
    ``fused_smi: False`` bf16 serving on both configs; times, plain times,
    library times and bounds of the new kernels; the bf16 and fp32 steps;
    the route fork: K1 -> K2 / K3 against K6 -> K7 at ActivityNet B=64, at
    fp32 and bf16."""
    import dataclasses

    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN, backbone
    from video_moment_localization_tpu_torch.ops import (
        content_cuda,
        content_train_cuda,
        proposal_cuda,
        smin_train_cuda,
    )
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed
    from video_moment_localization_tpu_torch.utils.profile_serving import profile_and_report
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    bf = torch.bfloat16
    B = TRAIN_BATCH
    a16 = dataclasses.replace(anet.model, compute_dtype="bfloat16")
    anet16 = dataclasses.replace(anet, model=a16)
    c16 = dataclasses.replace(config.model, compute_dtype="bfloat16", compat_head=True,
                              fused_content=True)
    compat16 = dataclasses.replace(config, model=c16)
    errs = {"K6f": 0.0, "K6b": 0.0, "K7f": 0.0, "K7b": 0.0, "K7_rel": 0.0, "K10f": 0.0,
            "K10b": 0.0, "K10_rel": 0.0}
    stats = {}

    def hold(tag, key, got, want, outs):
        for g, w, out in zip(got, want, outs):
            if g.dtype != bf:
                fail(f"{key}-bf16 {tag} {out}: {g.dtype}, not bf16")
            stats[f"{key} {tag} {out}"] = bulk_rel(g, w, K23_BF16_CARD, f"{key}-bf16 {tag} {out}")
            errs[key] = max(errs[key], float((g.float() - w.float()).abs().max()))

    def hold_weights(tag, key, got, want):
        scale = max(float(w.abs().max()) for w in want)
        for k, (g, w) in enumerate(zip(got, want)):
            if g.dtype != torch.float32:
                fail(f"{key}-bf16 {tag}: weight gradient {k} is {g.dtype}")
            s = bulk_rel(g, w, K23_BF16_CARD, f"{key}-bf16 {tag} weight gradient {k}", scale)
            errs[f"{key}_rel"] = max(errs[f"{key}_rel"], s["max"])

    # Parity on the bf16 backbone's outputs: ActivityNet B=64 (K6, K7) and
    # Charades B=64 (K10).
    torch.manual_seed(seed + 30)
    amodel = SMIN(a16).to(device).eval()
    abatch = {k: v.to(device) for k, v in synthetic_batch(a16, B, rng).items()}
    with torch.no_grad():
        f, fs, fw = backbone(amodel.backbone, a16, abatch["video_features"].to(bf),
                             abatch["video_mask"], abatch["query_features"].to(bf),
                             abatch["query_mask"], fused_lstm=False)
    f, fs, fw = f.contiguous(), fs.contiguous(), fw.contiguous()
    lmask, qmask = abatch["length_mask"].float(), abatch["query_mask"]
    vmask = packed_valid_mask(lmask).contiguous()
    L, C, T, D, Nq = a16.L, a16.C, a16.T, a16.D, a16.max_query_length
    N = L * (L + 1) // 2
    NC = N * C
    tag = f"ActivityNet B={B}"
    k6 = proposal_cuda.proposal_packed_forward(f, lmask, L, C)
    check_all_repeatable((*k6, []), (*proposal_cuda.proposal_packed_forward(f, lmask, L, C), []),
                         f"K6-bf16 forward {tag}")
    ref = proposal_features_packed(f.float(), lmask, L, C)
    errs["K6f"] = max(within_one_rounding(g, r, f"K6-bf16 forward {tag}")
                      for g, r in zip(k6, ref))
    k6_cots = [randn_like(t, rng).to(bf) for t in ref]
    dgot = proposal_cuda.proposal_packed_backward(lmask, T, L, C, *k6_cots)
    dref = proposal_cuda.proposal_backward_plain(lmask, T, L, C, *(c.float() for c in k6_cots))
    # On top of K6's fp32 backward tolerance (phase 8's `grad_err`): at this
    # width a frame's df sums thousands of clip cotangents, whose fp32 sums
    # in two orders part by more than K1_TOL's atol where they cancel.
    errs["K6b"] = within_one_rounding(
        dgot, dref, f"K6-bf16 backward {tag}",
        dict(rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(dref.abs().max())))
    check_repeatable(dgot, lambda: proposal_cuda.proposal_packed_backward(
        lmask, T, L, C, *k6_cots), f"K6-bf16 backward {tag}")
    print(f"parity K6-bf16 {tag}: forward max abs err {errs['K6f']:.3e}, backward "
          f"{errs['K6b']:.3e} (within one bf16 rounding of the plain version's fp32 value, "
          f"on top of K6's fp32 tolerance; df's largest magnitude "
          f"{float(dref.abs().max()):.3e}), a second forward and backward equal bit for bit")
    del ref, dref, dgot
    fc, fm, fb = k6
    fbar = (torch.sigmoid(fm * fs[:, None]) * fm).contiguous()      # the stack's bf16 gate
    k7_w = smin_train_cuda.layer_weights_for(
        [w.detach() for w in content_train_cuda.content_weights(amodel.smis[1])], bf)
    k7_ins = [fc, fbar, fw, fs, qmask, vmask]
    got = content_train_cuda.content_rows_forward(k7_w, *k7_ins)
    check_all_repeatable((*got, []), (*content_train_cuda.content_rows_forward(k7_w, *k7_ins), []),
                         f"K7-bf16 forward {tag}")
    hold(tag, "K7f", got, content_train_cuda.content_rows_plain(k7_w, *k7_ins), ("cu", "convfc"))
    dcu, dconv = randn_like(fc, rng).to(bf), randn_like(fbar, rng).to(bf)
    for cot in (dcu, None):
        a = content_train_cuda.content_rows_backward(k7_w, *k7_ins, cot, dconv)
        if cot is not None:
            check_all_repeatable(a, content_train_cuda.content_rows_backward(
                k7_w, *k7_ins, cot, dconv), f"K7-bf16 {tag}")
        p = content_train_cuda.content_rows_backward_plain(k7_w, *k7_ins, cot, dconv)
        hold(f"{tag}{'' if cot is not None else ' top'}", "K7b", a[:4], p[:4],
             ("dfc", "dfbar", "dfw", "dfs"))
        hold_weights(tag, "K7", a[4], p[4])
        del a, p
        torch.cuda.empty_cache()
    print(f"parity K7-bf16 {tag}: cu, convfc, dfc, dfbar, dfw, dfs (with and without dcu) "
          f"within {K23_BF16_CARD} of the mean |reference|, worst max "
          f"{max(v['max'] for k, v in stats.items() if k.startswith('K7')):.3e}; 14 fp32 weight "
          f"gradients within {errs['K7_rel']:.3e} of the largest; a second forward and "
          f"backward equal bit for bit")
    anet_parity_ins = (f, lmask, k6_cots, k7_w, k7_ins, dcu, dconv)

    torch.manual_seed(seed + 31)
    cmodel = SMIN(c16).to(device).eval()
    cbatch = {k: v.to(device) for k, v in synthetic_batch(c16, B, rng).items()}
    with torch.no_grad():
        cf, cfs, cfw = backbone(cmodel.backbone, c16, cbatch["video_features"].to(bf),
                                cbatch["video_mask"], cbatch["query_features"].to(bf),
                                cbatch["query_mask"], fused_lstm=False)
    clm, cqm = cbatch["length_mask"].float(), cbatch["query_mask"]
    cfc, cfm, _ = proposal_cuda.proposal_packed_forward(cf.contiguous(), clm, c16.L, c16.C)
    k10_w = smin_train_cuda.layer_weights_for(
        [w.detach() for w in content_cuda.unit_weights(cmodel.smis[1].content_unit)], bf)
    k10_ins = [cfc, cfm, cfw.contiguous(), cfs.contiguous(), cqm, packed_valid_mask(clm).contiguous()]
    ctag = f"Charades B={B}"
    got = content_cuda.content_unit_forward(k10_w, *k10_ins)
    check_repeatable(got, lambda: content_cuda.content_unit_forward(k10_w, *k10_ins),
                     f"K10-bf16 forward {ctag}")
    hold(ctag, "K10f", [got], [content_cuda.content_unit_plain(k10_w, *k10_ins)], ("cu",))
    k10_dcu = randn_like(cfc, rng).to(bf)
    a = content_cuda.content_unit_backward(k10_w, *k10_ins, k10_dcu)
    check_all_repeatable(a, content_cuda.content_unit_backward(k10_w, *k10_ins, k10_dcu),
                         f"K10-bf16 {ctag}")
    p = content_cuda.content_unit_backward_plain(k10_w, *k10_ins, k10_dcu)
    hold(ctag, "K10b", a[:4], p[:4], ("dfc", "dfm", "dfw", "dfs"))
    hold_weights(ctag, "K10", a[4], p[4])
    print(f"parity K10-bf16 {ctag}: cu, dfc, dfm, dfw, dfs within {K23_BF16_CARD} of the mean "
          f"|reference|, worst max {max(v['max'] for k, v in stats.items() if k.startswith('K10')):.3e}; "
          f"12 fp32 weight gradients within {errs['K10_rel']:.3e} of the largest; a second "
          f"forward and backward equal bit for bit")
    del a, p, amodel, cmodel
    torch.cuda.empty_cache()

    # The main path: 3 ActivityNet bf16 steps at B=64, its eval step; one
    # compat bf16 step at Charades B=64.
    n = a16.num_smi_layers
    torch.manual_seed(seed + 32)
    ainitial = SMIN(a16).state_dict()
    astep, amodel16, alosses, alaunches, aerr = train_bf16(
        anet16, "ActivityNet bf16 training", ainitial, abatch,
        {"K6f-bf16": 1, "K6b-bf16": 1, "K7f-bf16": n, "K7b-bf16": n, "CAf": 2 * n, "CAb": n},
        device)
    aeval_err = check_eval_step_bf16(a16, amodel16, abatch, device)
    torch.manual_seed(seed + 33)
    cinitial = SMIN(c16).state_dict()
    _, cmodel16, closses, claunches, cerr = train_bf16(
        compat16, "compat bf16 training", cinitial, cbatch,
        {"K6f-bf16": 1, "K6b-bf16": 1, "K10f-bf16": n, "K10b-bf16": n, "CAf": 2 * n,
         "CAb": n},
        device, steps=1)

    # fused_smi: False serving at bf16: ActivityNet through K6-bf16 -> K7-bf16,
    # Charades through K1-bf16 -> K2-bf16 (smin_forward without a graph).
    serve = {}
    amodel16.eval()
    serve["activitynet"] = serve_content16(
        dataclasses.replace(a16, fused_smi=False), amodel16, abatch,
        {"K6f-bf16": 1, "K7f-bf16": n}, f"fused_smi: False bf16 serving ActivityNet B={B}")
    torch.manual_seed(seed + 34)
    cs16 = dataclasses.replace(config.model, compute_dtype="bfloat16", fused_smi=False)
    smodel = SMIN(cs16).to(device).eval()
    sbatch = {k: v.to(device) for k, v in synthetic_batch(cs16, B, rng).items()}
    serve["charadessta"] = serve_content16(cs16, smodel, sbatch, {"K1f-bf16": 1, "K2-bf16": n},
                                           f"fused_smi: False bf16 serving Charades B={B}")
    del smodel, sbatch, cmodel16, cbatch
    torch.cuda.empty_cache()

    # Times at B=64: K6-bf16 and K7-bf16 at ActivityNet, K10-bf16 at Charades.
    f, lmask, k6_cots, k7_w, k7_ins, dcu, dconv = anet_parity_ins
    res = {}
    wc = dense_content_matrix(a16, device).to(bf)
    carry16 = 2 * B * (NC + N + L) * D
    seg_adds = segment_adds(a16)
    k6_bytes = bf16_bytes(f) + 4 * B * L + carry16
    b_ms, b_by = bound_bf16(B * seg_adds, k6_bytes, 0)
    res["K6f"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_packed_forward(f, lmask, L, C), iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_packed_forward(f, lmask, L, C), launches=5),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_rows_forward_plain_bf16(f, lmask, L, C),
                         iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f), iters=9),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f), launches=5),
        bound_ms=b_ms, bound_by=b_by)
    wct = wc.t().contiguous()
    g = k6_cots[0].reshape(B, NC, D)
    b_ms, b_by = bound_bf16(*proposal_bwd_work(a16, lmask, 2), 0)
    res["K6b"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_packed_backward(lmask, T, L, C, *k6_cots),
                   iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_packed_backward(lmask, T, L, C, *k6_cots), launches=5),
        plain_ms=cuda_ms(lambda: proposal_cuda.proposal_rows_backward_plain_bf16(
            lmask, T, L, C, *k6_cots), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g), iters=9),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g), launches=5),
        bound_ms=b_ms, bound_by=b_by)
    del wc, wct, g
    # K7-bf16: the content unit's contractions and the folded conv_fc, all
    # of bf16 operands; in fc and fbar (or cu and convfc out), the shared
    # inputs and the weights; the backward three times the operations (the
    # recompute), its cotangents in and the fp32 weight gradients out.
    w_bytes = bf16_bytes(*k7_w)
    rows_bytes = 2 * B * (NC + N) * D
    shared_bytes = bf16_bytes(*k7_ins[2:])
    contractions = gemm_flops(a16, B, "K7f") + B * unit_rest(a16, Nq)
    workspace = content_train_cuda.Workspace()
    b_ms, b_by = bound_bf16(contractions, 2 * rows_bytes + shared_bytes + w_bytes, contractions)
    res["K7f"] = dict(
        ms=cuda_ms(lambda: content_train_cuda.content_rows_forward(k7_w, *k7_ins, workspace),
                   iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: content_train_cuda.content_rows_forward(k7_w, *k7_ins, workspace),
            launches=5, reps=3),
        plain_ms=cuda_ms(lambda: content_train_cuda.content_rows_plain(k7_w, *k7_ins),
                         warmup=1, iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    contractions = gemm_flops(a16, B, "K7b") + 3 * B * unit_rest(a16, Nq)
    # Three carries of rows (fc and fbar, dcu and dconvfc in; dfc and dfbar
    # out), as K7b's fp32 bound counts them.
    b_ms, b_by = bound_bf16(contractions, 3 * rows_bytes + 2 * shared_bytes + w_bytes
                            + sum(4 * w.numel() for w in k7_w), contractions)
    res["K7b"] = dict(
        ms=cuda_ms(lambda: content_train_cuda.content_rows_backward(k7_w, *k7_ins, dcu, dconv,
                                                                    workspace), iters=7),
        device_ms=cuda_ms_back_to_back(
            lambda: content_train_cuda.content_rows_backward(k7_w, *k7_ins, dcu, dconv,
                                                             workspace), launches=3, reps=3),
        plain_ms=cuda_ms(lambda: content_train_cuda.content_rows_backward_plain(
            k7_w, *k7_ins, dcu, dconv), warmup=1, iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del workspace
    torch.cuda.empty_cache()
    uw_bytes = bf16_bytes(*k10_w)
    cN = c16.L * (c16.L + 1) // 2
    urows = 2 * B * cN * c16.C * c16.D
    side_bytes = bf16_bytes(*k10_ins[1:])
    contractions = gemm_flops(c16, B, "K10f") + B * unit_rest(c16, c16.max_query_length)
    workspace = content_cuda.Workspace()
    b_ms, b_by = bound_bf16(contractions, 2 * urows + side_bytes + uw_bytes, contractions)
    res["K10f"] = dict(
        ms=cuda_ms(lambda: content_cuda.content_unit_forward(k10_w, *k10_ins, workspace)),
        device_ms=cuda_ms_back_to_back(
            lambda: content_cuda.content_unit_forward(k10_w, *k10_ins, workspace)),
        plain_ms=cuda_ms(lambda: content_cuda.content_unit_plain(k10_w, *k10_ins)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        split=device_split(lambda: content_cuda.content_unit_forward(k10_w, *k10_ins,
                                                                     workspace)))
    contractions = gemm_flops(c16, B, "K10b") + 3 * B * unit_rest(c16, c16.max_query_length)
    b_ms, b_by = bound_bf16(contractions, 3 * urows + 2 * side_bytes + uw_bytes
                            + sum(4 * w.numel() for w in k10_w), contractions)
    res["K10b"] = dict(
        ms=cuda_ms(lambda: content_cuda.content_unit_backward(k10_w, *k10_ins, k10_dcu,
                                                              workspace), iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: content_cuda.content_unit_backward(k10_w, *k10_ins, k10_dcu, workspace),
            launches=10, reps=3),
        plain_ms=cuda_ms(lambda: content_cuda.content_unit_backward_plain(
            k10_w, *k10_ins, k10_dcu), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        split=device_split(lambda: content_cuda.content_unit_backward(k10_w, *k10_ins, k10_dcu,
                                                                      workspace)))
    del workspace, k10_ins, k10_dcu
    for k in ("K6f", "K6b", "K7f", "K7b", "K10f", "K10b"):
        r = res[k]
        print(f"time {k}-bf16 B={B}: kernel {r['ms']:.4f} ms (back to back "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){b2b_note(r)}{split_note(r)}")

    # The ActivityNet bf16 step: wall time, and its device time and busy
    # share under the profiler.
    res["step_ms"] = step_wall_ms(astep, abatch)
    print(f"time ActivityNet bf16 train step B={B}: {res['step_ms']:.4f} ms wall, "
          f"{B / res['step_ms'] * 1e3:.1f} samples/s")
    profile_and_report(lambda: astep(abatch), f"ActivityNet bf16 B={B}", "train step", 3, top=14)
    del astep, amodel16, abatch, k7_ins, dcu, dconv
    torch.cuda.empty_cache()

    # The route fork: the three-layer stack of one ActivityNet B=64 step,
    # forward and backward, on both training routes at both types.
    torch.manual_seed(seed + 35)
    fmodel = SMIN(anet.model).to(device)
    fork = {}
    for dtype in (torch.float32, bf):
        fork[str(dtype).split(".")[-1]] = route_fork_ms(anet.model, fmodel, f.float(),
                                                        fw.float(), fs.float(), qmask, lmask,
                                                        dtype)
    print(f"route fork, ActivityNet B={B}, three layers forward and backward (ms): {fork}")
    del fmodel, f
    torch.cuda.empty_cache()
    return dict(errs=errs, stats=stats, times=res, fork=fork, serve=serve,
                launches=alaunches, compat_launches=claunches, losses=alosses,
                compat_losses=closses, step_err=aerr, compat_err=cerr, eval_err=aeval_err)


# ------------------------------------------------------------------------- #
# bf16 on the dense layout and under the all-layers train forward (K8-bf16,
# K9-bf16), and K8 at the ActivityNet batch
# ------------------------------------------------------------------------- #
# K8-bf16 is K1-bf16's device code on the dense layout: within one bf16
# rounding of its plain version's fp32 value on top of K8's fp32 tolerance
# (forward K1_TOL, backward K8's fp32 backward tolerance, as K6-bf16's).
# K9-bf16 equals one K2-bf16 launch per layer bit for bit. The dense bf16
# localizer's top-5 scores against the fp32 localizer's: the JAX package's
# bf16 forward criterion, atol 2e-2 (tests/test_dtype_remat.py), for top-k;
# after soft-NMS, whose decays follow the moments picked (a near tie picked
# the other way moves the later scores), the JAX criterion of phase 19.
DENSE_SCORE_ATOL = 2e-2


def backbone_f(cfg, model, batch, dtype):
    """(f, fs, fw) of the training backbone (the plain biLSTM) at ``dtype``
    on a synthetic batch, grad-free, contiguous."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import backbone

    with torch.no_grad():
        out = backbone(model.backbone, cfg, batch["video_features"].to(dtype),
                       batch["video_mask"], batch["query_features"].to(dtype),
                       batch["query_mask"], fused_lstm=False)
    return tuple(t.contiguous() for t in out)


def check_k8(cfg, f, mm, seed, tag, errs):
    """K8 (fp32 f) or K8-bf16 (bf16 f), forward and backward, against the
    plain version's fp32 value on the same card: K8 at K1_TOL and
    `grad_err`, K8-bf16 within one bf16 rounding on top of them; zeros below
    the diagonal; forward and backward twice bit for bit. The cotangents
    are drawn on the card from ``seed`` (at the ActivityNet batch dfc holds
    2^29 elements). Returns them, for the times."""
    import torch

    from video_moment_localization_tpu_torch.ops import proposal_cuda

    bf = f.dtype == torch.bfloat16
    key = "K8-bf16" if bf else "K8"
    L, C, T = cfg.L, cfg.C, cfg.T
    got = proposal_cuda.proposal_dense_forward(f, mm, L, C)
    check_all_repeatable((*got, []), (*proposal_cuda.proposal_dense_forward(f, mm, L, C), []),
                         f"{key} forward {tag}")
    ref = proposal_cuda.proposal_features(f.float(), mm, L, C)
    below = torch.ones(L, L, device=f.device).tril(-1).bool()
    if bool((got[0][:, below] != 0).any()) or bool((got[1][:, below] != 0).any()):
        fail(f"{key} {tag}: a cell below the diagonal is not 0")
    if bf:
        e1 = max(within_one_rounding(g, r, f"{key} forward {tag}") for g, r in zip(got, ref))
    else:
        e1 = max_err(got, ref, K1_TOL, f"{key} forward {tag}")
    gen = torch.Generator(device=f.device).manual_seed(seed)
    cots = [torch.randn(r.shape, generator=gen, device=f.device).to(f.dtype) for r in ref]
    del got, ref
    torch.cuda.empty_cache()
    dgot = proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots)
    dref = proposal_cuda.proposal_backward_plain(mm, T, L, C, *(c.float() for c in cots))
    scale = float(dref.abs().max())
    if bf:
        e2 = within_one_rounding(dgot, dref, f"{key} backward {tag}",
                                 dict(rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale))
    else:
        e2 = grad_err(dgot, dref, scale, f"{key} backward {tag}")
    check_repeatable(dgot, lambda: proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots),
                     f"{key} backward {tag}")
    print(f"parity {key} {tag}: forward max abs err {e1:.3e}, backward {e2:.3e} of magnitude "
          f"{scale:.3e} ({'one bf16 rounding on top of ' if bf else ''}K8's fp32 tolerances), a "
          f"second forward and backward equal bit for bit")
    errs[f"{key} fwd {tag}"], errs[f"{key} bwd {tag}"] = e1, e2
    del dgot, dref
    torch.cuda.empty_cache()
    return cots


def k8_times(cfg, f, mm, cots, B, reps=5):
    """Times of K8 (or K8-bf16 on bf16 f) forward and backward at the
    inputs: one call and back to back, the plain version, the bytes bound
    (inputs read once, outputs written once, at the elements' width; the
    backward's `proposal_bwd_work`: the cotangents of the unmasked cells), and
    one ``torch.matmul`` with the dense Wc (or its transpose) at f's type."""
    import torch

    from video_moment_localization_tpu_torch.ops import proposal_cuda

    L, C, D, T = cfg.L, cfg.C, cfg.D, cfg.T
    e = f.element_size()
    bf = f.dtype == torch.bfloat16
    plain_fwd = (proposal_cuda.proposal_rows_forward_plain_bf16 if bf
                 else proposal_cuda.proposal_features)
    plain_bwd = (proposal_cuda.proposal_rows_backward_plain_bf16 if bf
                 else proposal_cuda.proposal_backward_plain)
    wc = dense_content_matrix(cfg, f.device, dense=True).to(f.dtype)
    fwd_bytes = e * (f.numel() + B * L * L * (C + 1) * D + B * L * D) + 4 * mm.numel()
    b_ms, b_by = (bound_bf16(B * segment_adds(cfg, dense=True), fwd_bytes, 0) if bf
                  else bound(B * segment_adds(cfg, dense=True), fwd_bytes))
    res = {"fwd": dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_dense_forward(f, mm, L, C), iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_dense_forward(f, mm, L, C), launches=reps),
        plain_ms=cuda_ms(lambda: plain_fwd(f, mm, L, C), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wc, f), iters=9),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wc, f), launches=reps),
        bound_ms=b_ms, bound_by=b_by)}
    torch.cuda.empty_cache()
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, L * L * C, D)
    work = proposal_bwd_work(cfg, mm, e)
    b_ms, b_by = bound_bf16(*work, 0) if bf else bound(*work)
    res["bwd"] = dict(
        ms=cuda_ms(lambda: proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots), iters=9),
        device_ms=cuda_ms_back_to_back(
            lambda: proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots), launches=reps),
        plain_ms=cuda_ms(lambda: plain_bwd(mm, T, L, C, *cots), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(wct, g), iters=9),
        library_device_ms=cuda_ms_back_to_back(lambda: torch.matmul(wct, g), launches=reps),
        bound_ms=b_ms, bound_by=b_by)
    del wc, wct, g
    torch.cuda.empty_cache()
    return res


def check_dense_eval16(cfg16, model, batch, per_call, label):
    """The dense bf16 eval step and grad-free forward on the batch: the
    counters rise by ``per_call`` for each and no other moves; the scores
    and the loss held to the same forward through the plain bf16 versions
    (phase 19's K4-bf16 bounds, EVAL_LOSS_RTOL x 10)."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import smin_forward_inference
    from video_moment_localization_tpu_torch.parallel.steps import make_eval_step
    from video_moment_localization_tpu_torch.train.loss import smin_loss

    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
            "moment_mask")
    reset_bf16_launches()
    ev = make_eval_step(cfg16, model, device=batch["length_mask"].device)(batch)
    got = smin_forward_inference(model, cfg16, *(batch[k] for k in keys))
    torch.cuda.synchronize()
    counts = bf16_launches()
    launches = {k: v for k, v in counts.items() if v}
    if launches != {k: 2 * v for k, v in per_call.items()}:
        fail(f"{label}: launches {launches}, expected twice {per_call}")
    with plain_bf16_kernels(), torch.no_grad():
        want = smin_forward_inference(model, cfg16, *(batch[k] for k in keys))
        plain_loss = float(smin_loss(want, batch)[0])
    torch.cuda.synchronize()
    if bf16_launches() != counts:
        fail(f"{label}: the plain versions' forward launched a kernel")
    err = bf16_criterion(got, want, K4_BF16_CARD, label)
    ev_loss = float(ev["loss"])
    if not abs(ev_loss - plain_loss) <= 10 * EVAL_LOSS_RTOL * abs(plain_loss):
        fail(f"{label}: eval loss {ev_loss} against the plain versions' {plain_loss}")
    print(f"{label}: launches {launches} (eval step and forward), scores within {err:.3e} of the "
          f"plain bf16 versions' (bounds {K4_BF16_CARD}), loss {ev_loss:.6f} against "
          f"{plain_loss:.6f}, counts {ev['counts'].flatten().tolist()}")
    return err


def check_dense_localizer16(cfg, model, rng):
    """`MomentLocalizer` with ``packed: False`` at bf16 on the card serving
    24 requests with top-k and with dense soft-NMS, beside the fp32
    localizer on the same weights: K8-bf16 launches, and the k-th of each
    request's top-5 scores within DENSE_SCORE_ATOL of the fp32 localizer's
    (top-k) or within the JAX bf16 criterion (soft-NMS). Returns the max abs
    score differences."""
    import dataclasses

    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.data.glove import WordEmbedding
    from video_moment_localization_tpu_torch.inference import MomentLocalizer
    from video_moment_localization_tpu_torch.ops import proposal_cuda

    cfg32 = dataclasses.replace(cfg, packed=False, compute_dtype="float32")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    words = sorted({w for q in QUERIES for w in q.split()} - {"xylophone"})
    emb = WordEmbedding.synthetic(words, dim=cfg.word_dim, seed=1)
    reqs = requests(cfg, rng)
    out = {}
    for nms in (False, True):
        scores = {}
        for name, c in (("fp32", cfg32), ("bf16", cfg16)):
            loc = MomentLocalizer(c, model, emb, serve_batch=16, use_nms=nms)
            before = (proposal_cuda.proposal_dense_forward.launches,
                      proposal_cuda.proposal_dense_forward.launches_bf16)
            answers = loc.localize_batch(reqs, top_k=5)
            torch.cuda.synchronize()
            moved = (proposal_cuda.proposal_dense_forward.launches - before[0],
                     proposal_cuda.proposal_dense_forward.launches_bf16 - before[1])
            if moved != ((2, 0) if name == "fp32" else (0, 2)):
                fail(f"dense {name} serving: K8 / K8-bf16 launched {moved} times, expected 2")
            scores[name] = np.array([[m.score for m in r] for r in answers], np.float32)
        d = np.abs(scores["bf16"] - scores["fp32"])
        label = f"dense bf16 serving ({'soft-NMS' if nms else 'top-k'})"
        if not np.isfinite(scores["bf16"]).all() or scores["bf16"].shape != (len(reqs), 5):
            fail(f"{label}: scores of shape {scores['bf16'].shape}, not all finite or not "
                 f"five a request")
        if nms:
            bf16_criterion([torch.from_numpy(scores["bf16"])], [torch.from_numpy(scores["fp32"])],
                           K4_BF16_JAX, label)
        elif float(d.max()) > DENSE_SCORE_ATOL:
            fail(f"{label}: top-5 scores differ from the fp32 localizer's by {float(d.max()):.3e}")
        print(f"{label}: {len(reqs)} requests, K8-bf16 2 launches; top-5 scores within "
              f"{float(d.max()):.3e} of the fp32 localizer's (max; mean {float(d.mean()):.3e}; "
              f"bound {K4_BF16_JAX if nms else DENSE_SCORE_ATOL})")
        out["nms" if nms else "topk"] = float(d.max())
    return out


def dense_anet_step(anet, dtype, seed, rng, device):
    """The dense ActivityNet train step (``packed: False``, B=64, full width
    and depth) at ``dtype``: 2 warm-up steps, then the median wall ms of 5,
    every loss finite, K8 (or K8-bf16) 1 + 1 launches a step and no other
    train kernel, and the peak device memory over the steps."""
    import dataclasses

    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    c = dataclasses.replace(anet.model, packed=False, compute_dtype=dtype)
    torch.manual_seed(seed + 40)
    model = SMIN(c)
    step = make_train_step(c, model, build_optimizer(dataclasses.replace(anet, model=c), model),
                           device=device)
    batch = {k: v.to(device) for k, v in synthetic_batch(c, TRAIN_BATCH, rng).items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_bf16_launches()
    losses = []
    for _ in range(2):
        losses.append(float(step(batch)["loss"]))
    launches = {k: v for k, v in bf16_launches().items() if v}
    suffix = "-bf16" if dtype == "bfloat16" else ""
    if launches != {f"K8f{suffix}": 2, f"K8b{suffix}": 2}:
        fail(f"dense ActivityNet {dtype}: launches of 2 steps {launches}")
    ms = step_wall_ms(step, batch, iters=7)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses.append(float(step(batch)["loss"]))
    if not all(abs(x) < float("inf") for x in losses):
        fail(f"dense ActivityNet {dtype}: losses {losses}")
    print(f"dense ActivityNet {dtype} train step B={TRAIN_BATCH} (remat_smi {c.remat_smi}): "
          f"{ms:.4f} ms wall, {TRAIN_BATCH / ms * 1e3:.1f} samples/s, peak {peak:.3f} GiB, "
          f"losses {losses}")
    del step, model, batch
    torch.cuda.empty_cache()
    return dict(ms=ms, samples_per_s=TRAIN_BATCH / ms * 1e3, peak_memory_gib=peak,
                remat_smi=c.remat_smi, losses=losses)


def phase_bf16_dense(anet, config, seed, rng, device):
    """Phase 22: bf16 on the dense layout and under the all-layers train
    forward. K8 and K8-bf16 against their plain versions on the backbone's
    outputs at ActivityNet B=64 and Charades B=64; K9-bf16 bit for bit three
    K2-bf16 launches; 3 dense bf16 Adam steps at Charades B=64 held to the
    same steps through the plain bf16 versions, the dense bf16 eval step and
    the dense bf16 localizer (top-k and soft-NMS) against the fp32 one; 3
    bf16 steps under VML_SMIN_TRAIN_FUSED_FWD=1 equal to the per-layer
    route's bit for bit; the dense ActivityNet step at fp32 and bf16; times
    of K8-bf16 and K9-bf16 (and K8 at ActivityNet B=64), their plain
    versions, bounds and library calls; the dense Charades step at both
    types."""
    import dataclasses

    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN, block_weights
    from video_moment_localization_tpu_torch.ops import smin_train_cuda
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.utils.profile_serving import profile_and_report
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    bf = torch.bfloat16
    B = TRAIN_BATCH
    cfg = config.model
    d16 = dataclasses.replace(cfg, packed=False, compute_dtype="bfloat16")
    dense16 = dataclasses.replace(config, model=d16)
    n = cfg.num_smi_layers
    errs, times = {}, {}

    # K8 and K8-bf16 on the backbone's outputs: ActivityNet B=64 (fc of 2^29
    # elements), then Charades B=64.
    for name, mcfg in (("ActivityNet", anet.model), ("Charades", cfg)):
        torch.manual_seed(seed + 41)
        mdl = SMIN(mcfg).to(device).eval()
        batch = {k: v.to(device) for k, v in synthetic_batch(
            dataclasses.replace(mcfg, packed=False), B, rng).items()}
        mm = batch["moment_mask"].float().contiguous()
        for dtype in (torch.float32, bf):
            f = backbone_f(mcfg, mdl, batch, dtype)[0]
            tag = f"{name} B={B}"
            cots = check_k8(mcfg, f, mm, seed + 45, tag, errs)
            times[("K8-bf16" if dtype == bf else "K8", name)] = k8_times(mcfg, f, mm, cots, B)
            del f, cots
            torch.cuda.empty_cache()
        del mdl, batch
    for (key, name), r in times.items():
        for way in ("fwd", "bwd"):
            t = r[way]
            print(f"time {key} {way} {name} B={B}: kernel {t['ms']:.4f} ms (back to back "
                  f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, matmul "
                  f"{t['library_ms']:.4f} ms (back to back {t['library_device_ms']:.4f}), bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    # K9-bf16 against three K2-bf16 launches at Charades B=64, and its times.
    torch.manual_seed(seed + 42)
    model = SMIN(cfg).to(device).eval()
    weights = smin_train_cuda.layer_weights_for(
        [w.detach() for b in model.smis for w in block_weights(b)], bf)
    ins = layer_inputs(cfg, B, rng, device, pin=True)
    ins[:5] = [t.to(bf).contiguous() for t in ins[:5]]
    fm_o, fb_o, carries = smin_train_cuda.smi_stack_forward(weights, *ins, cfg.L)
    carry = tuple(ins[:3])
    for k in range(n):
        if not all(torch.equal(a, b) for a, b in zip(carries[k], carry)):
            fail(f"K9-bf16 B={B}: layer {k}'s input carry differs from the K2-bf16 launches'")
        carry = smin_train_cuda.smi_layer_forward(weights[20 * k:20 * (k + 1)], *carry, *ins[3:],
                                                  cfg.L)
    if not (torch.equal(fm_o, carry[1]) and torch.equal(fb_o, carry[2])):
        fail(f"K9-bf16 B={B}: the outputs differ from {n} K2-bf16 launches'")
    plain = smin_train_cuda.smi_stack_plain(weights, *ins, cfg.L)
    k9_stats = {out: bulk_rel(g, w, K23_BF16_CARD, f"K9-bf16 B={B} {out}")
                for g, w, out in zip((fm_o, fb_o), plain[:2], ("mu", "bu"))}
    errs["K9-bf16"] = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip((fm_o, fb_o), plain[:2]))
    print(f"parity K9-bf16 B={B}: equal bit for bit to {n} K2-bf16 launches (outputs and "
          f"carries); the top layer against the plain bf16 stack {k9_stats} of the mean "
          f"|reference| (bounds {K23_BF16_CARD})")
    del fm_o, fb_o, carries, carry, plain
    N = cfg.L * (cfg.L + 1) // 2
    carry16 = 2 * B * (N * cfg.C + N + cfg.L) * cfg.D
    contractions = gemm_flops(cfg, B, "K2") + B * layer_rest(cfg, cfg.max_query_length)
    k2_ms, k2_by = bound_bf16(contractions, 2 * carry16 + bf16_bytes(*ins[3:])
                              + bf16_bytes(*weights[:20]), contractions)

    def per_layer():
        c = tuple(ins[:3])
        for k in range(n):
            c = smin_train_cuda.smi_layer_forward(weights[20 * k:20 * (k + 1)], *c, *ins[3:],
                                                  cfg.L)

    times["K9-bf16"] = dict(
        ms=cuda_ms(lambda: smin_train_cuda.smi_stack_forward(weights, *ins, cfg.L)),
        device_ms=cuda_ms_back_to_back(
            lambda: smin_train_cuda.smi_stack_forward(weights, *ins, cfg.L), launches=5, reps=3),
        plain_ms=cuda_ms(lambda: smin_train_cuda.smi_stack_plain(weights, *ins, cfg.L), iters=5),
        library_ms=None, bound_ms=n * k2_ms, bound_by=k2_by,
        per_layer_k2_ms=cuda_ms(per_layer),
        per_layer_k2_device_ms=cuda_ms_back_to_back(per_layer, launches=5, reps=3))
    r = times["K9-bf16"]
    print(f"time K9-bf16 B={B}: kernel {r['ms']:.4f} ms (back to back {r['device_ms']:.4f}), "
          f"{n} K2-bf16 launches {r['per_layer_k2_ms']:.4f} (back to back "
          f"{r['per_layer_k2_device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {n} x K2-bf16's)")
    del model, weights, ins
    torch.cuda.empty_cache()

    # The dense bf16 train step at Charades B=64 against the plain bf16
    # versions, its eval step, the dense bf16 localizer.
    torch.manual_seed(seed + 43)
    initial = SMIN(d16).state_dict()
    batch = {k: v.to(device) for k, v in synthetic_batch(d16, B, rng).items()}
    step16, model16, losses, launches, step_err = train_bf16(
        dense16, "dense bf16 training", initial, batch, {"K8f-bf16": 1, "K8b-bf16": 1}, device)
    model16.eval()
    eval_err = check_dense_eval16(d16, model16, batch, {"K8f-bf16": 1},
                                  f"dense bf16 eval step B={B}")
    serve_err = check_dense_localizer16(cfg, model16, rng)

    # The dense step at both types: wall ms and the bf16 step's device time
    # and busy share under the profiler.
    d32 = dataclasses.replace(d16, compute_dtype="float32")
    model32 = SMIN(d32)
    model32.load_state_dict(initial)
    step32 = make_train_step(d32, model32, build_optimizer(dataclasses.replace(config, model=d32),
                                                            model32), device=device)
    dense_ms = {"bf16": step_wall_ms(step16, batch), "fp32": step_wall_ms(step32, batch)}
    print(f"time dense train step B={B}: bf16 {dense_ms['bf16']:.4f} ms wall "
          f"({B / dense_ms['bf16'] * 1e3:.1f} samples/s), fp32 {dense_ms['fp32']:.4f} ms "
          f"({B / dense_ms['fp32'] * 1e3:.1f} samples/s)")
    busy = {"bf16": profile_and_report(lambda: step16(batch), f"dense bf16 B={B}", "train step",
                                       3, top=10),
            "fp32": profile_and_report(lambda: step32(batch), f"dense fp32 B={B}", "train step",
                                       3, top=10)}
    del step16, model16, step32, model32, batch
    torch.cuda.empty_cache()

    # VML_SMIN_TRAIN_FUSED_FWD=1 at bf16: 3 steps through K9-bf16, equal to
    # the per-layer route's bit for bit.
    c16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    packed16 = dataclasses.replace(config, model=c16)
    torch.manual_seed(seed + 44)
    initial = SMIN(c16).state_dict()
    batch = {k: v.to(device) for k, v in synthetic_batch(c16, B, rng).items()}
    previous = os.environ.get("VML_SMIN_TRAIN_FUSED_FWD")
    os.environ["VML_SMIN_TRAIN_FUSED_FWD"] = "1"
    try:
        _, _, fused_losses, fused_launches, fused_err = train_bf16(
            packed16, "fused_fwd bf16 training", initial, batch,
            {"K1f-bf16": 1, "K1b-bf16": 1, "K9-bf16": 1, "K3-bf16": n, "CAf": 2 * n, "CAb": n},
            device)
    finally:
        if previous is None:
            del os.environ["VML_SMIN_TRAIN_FUSED_FWD"]
        else:
            os.environ["VML_SMIN_TRAIN_FUSED_FWD"] = previous
    _, _, layer_losses, _, _ = train_bf16(
        packed16, "per-layer bf16 training", initial, batch,
        {"K1f-bf16": 1, "K1b-bf16": 1, "K2-bf16": n, "K3-bf16": n, "CAf": 2 * n, "CAb": n},
        device)
    if fused_losses != layer_losses:
        fail(f"the K9-bf16 route's losses {fused_losses} differ from the per-layer route's "
             f"{layer_losses}")
    print(f"fused_fwd bf16: losses equal bit for bit to the per-layer route's {layer_losses}")
    del batch
    torch.cuda.empty_cache()

    # The dense ActivityNet step at both types.
    anet_steps = {d: dense_anet_step(anet, d, seed, rng, device) for d in ("bfloat16", "float32")}
    return dict(errs=errs, times=times, k9_stats=k9_stats, losses=losses, launches=launches,
                step_err=step_err, eval_err=eval_err, serve_err=serve_err, dense_ms=dense_ms,
                busy=busy, fused_losses=fused_losses, fused_launches=fused_launches,
                fused_err=fused_err, anet_steps=anet_steps)


# ------------------------------------------------------------------------- #
# Phase 23: data parallelism on one card
# ------------------------------------------------------------------------- #
# Two ranks share the card through gloo, which reduces CUDA tensors through
# the host (NCCL puts no two ranks on one card); NCCL runs as a group of one.
# The ranks' steps are held to one process's steps on the card with phase
# 6's tolerances; a global batch of DP_TAIL_VALID valid samples leaves 32 on
# rank 0 and 8 on rank 1. The fit's stats are held to phase 17's epoch 1
# within DP_FIT_TOL of the value (at least of 1: the recalls are shares).
DP_RANKS = 2
DP_TAIL_VALID = 40
DP_FIT_TOL = 2e-4
DP_TIMED_STEPS = 10
DP_ASYNC_REQUESTS = 500
DP_TIMEOUT_S = 600


def dp_shard(batch, rank, world, device):
    """Rank ``rank``'s contiguous rows of a global host batch (NumPy) on the
    card, with the global batch's valid count (`parallel.steps`)."""
    import numpy as np

    from video_moment_localization_tpu_torch.parallel import mesh

    b = len(batch["sample_mask"]) // world
    out = {k: np.ascontiguousarray(v[rank * b: (rank + 1) * b]) for k, v in batch.items()}
    out["global_valid"] = np.asarray(batch["sample_mask"].sum(), np.float32)
    return mesh.put_batch(out, device)


def dp_counters():
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    return dict(mode_counters(), K5=lstm_cuda.bilstm_fused, K4=smin_cuda.smin_stack_fused)


def dp_counts(counters):
    return {k: fn.launches for k, fn in counters.items() if fn.launches}


def dp_wall_ms(fn, iters=DP_TIMED_STEPS):
    """Mean wall ms of fn() ending in a synchronize, after one warm-up (gloo
    blocks the host on its collectives: CUDA events would miss that)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def dp_rank(rank, job_path, out_pattern):
    """One rank of phase 23 (`parallel.mesh.spawn`: gloo, both ranks on
    cuda:0). Per case of the job: the replica from the case's weights
    (broadcast from rank 0), with "eval" the eval step on its shard of the
    first batch, summed over the ranks (K5, K4 counted), then one data-
    parallel train step a global batch: the global loss, the reduced
    gradients of step 1, whether the parameters equal rank 0's bit for bit
    after each step, the kernels' launches over the steps; with "time" the
    step's and the gradient all-reduce's wall ms. Then `Trainer.fit` for one
    epoch on phase 17's directory, counting the stats and checkpoint writes.
    Saves its results to ``out_pattern % rank``."""
    import torch
    import torch.distributed as dist

    import video_moment_localization_tpu_torch.train.trainer as trainer_mod
    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.parallel.steps import (
        build_optimizer,
        make_eval_step,
        make_train_step,
    )

    job = torch.load(job_path, weights_only=False)
    device = torch.device("cuda:0")
    group, world = mesh.default_group(), mesh.world_size()
    counters = dp_counters()
    out = {}
    for case in job["cases"]:
        config = case["config"]
        cfg = config.model
        model = SMIN(cfg)
        model.load_state_dict(case["state"])
        mesh.put_replicated(model.to(device), group)
        res = {"loss": [], "equal": []}
        for fn in counters.values():
            fn.launches = 0
        if case.get("eval"):
            ev = make_eval_step(cfg, model, device=device)(
                dp_shard(case["batches"][0], rank, world, device))
            sums = torch.cat([ev["loss_sum"].reshape(1), ev["num_valid"].reshape(1),
                              ev["counts"].reshape(-1)]).double()
            res["eval"] = mesh.all_reduce_sums(sums, group).cpu()
            res["eval_launches"] = dp_counts(counters)
            for fn in counters.values():
                fn.launches = 0
        step = make_train_step(cfg, model, build_optimizer(config, model), device, group=group)
        for k, batch in enumerate(case["batches"]):
            m = step(dp_shard(batch, rank, world, device))
            res["loss"].append(float(mesh.all_reduce_sums(m["loss"].clone(), group)))
            if k == 0:
                res["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            first = flat.clone()
            dist.broadcast(first, src=0)
            res["equal"].append(bool(torch.equal(flat, first)))
        torch.cuda.synchronize()
        res["launches"] = dp_counts(counters)
        if case.get("time"):
            shard = dp_shard(case["batches"][0], rank, world, device)
            res["step_ms"] = dp_wall_ms(lambda: step(shard))
            res["reduce_ms"] = dp_wall_ms(
                lambda: mesh.all_reduce_gradients(model.named_parameters(), group))
        out[case["name"]] = res
        del model, step
        torch.cuda.empty_cache()

    writes = {"stats": 0, "checkpoint": 0}

    def counted(fn, key):
        def wrapper(*args, **kw):
            writes[key] += 1
            return fn(*args, **kw)
        return wrapper

    trainer_mod.write_stats = counted(trainer_mod.write_stats, "stats")
    trainer_mod.save_checkpoint = counted(trainer_mod.save_checkpoint, "checkpoint")
    cfg = load_config(job["files_cfg"], num_epochs_override=1)
    trainer = trainer_mod.Trainer(cfg, device=device)
    train_ds, eval_ds = trainer_mod.build_datasets(cfg)
    shard = dict(shard_id=rank, num_shards=world, num_workers=cfg.num_workers, seed=cfg.seed)
    t0 = time.perf_counter()
    trainer.fit(BatchLoader(train_ds, cfg.batch_size, shuffle=True, **shard),
                BatchLoader(eval_ds, cfg.batch_size, shuffle=False, **shard))
    out["fit"] = dict(writes=writes, seconds=time.perf_counter() - t0)
    torch.save(out, out_pattern % rank)


def dp_reference(config, state, batches, device, evaluate=False):
    """The steps of a `dp_rank` case in this process without a group: the
    losses, step 1's gradients, and with ``evaluate`` the eval step on the
    first batch before them."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.parallel.steps import (
        build_optimizer,
        make_eval_step,
        make_train_step,
    )

    model = SMIN(config.model)
    model.load_state_dict(state)
    res = {"loss": []}
    if evaluate:
        ev = make_eval_step(config.model, model, device=device)(mesh.put_batch(batches[0], device))
        res["eval"] = (float(ev["loss"]), ev["counts"].cpu())
    step = make_train_step(config.model, model, build_optimizer(config, model), device)
    for k, batch in enumerate(batches):
        res["loss"].append(float(step(mesh.put_batch(batch, device))["loss"]))
        if k == 0:
            res["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return res


def dp_hold(label, got, want, launches):
    """A case of the ranks against one process: the global losses (step 1
    within 1e-5, all within TRAIN_LOSS_RTOL), the reduced step-1 gradients
    (GRAD_RTOL, GRAD_ATOL_REL of the largest), the parameters equal across
    the ranks after every step, and ``launches`` on each rank. Returns the
    largest gradient error relative to that magnitude."""
    for r, rank in enumerate(got):
        if rank["loss"] != got[0]["loss"]:
            fail(f"{label}: rank {r}'s losses {rank['loss']} differ from rank 0's")
        if not all(rank["equal"]):
            fail(f"{label}: rank {r}'s parameters differ from rank 0's after a step: "
                 f"{rank['equal']}")
        if rank["launches"] != launches:
            fail(f"{label}: rank {r} launched {rank['launches']}, expected {launches}")
    loss, ref = got[0]["loss"], want["loss"]
    first = abs(loss[0] - ref[0]) / abs(ref[0])
    worst = max(abs(a - b) / abs(b) for a, b in zip(loss, ref))
    if first > 1e-5 or worst > TRAIN_LOSS_RTOL:
        fail(f"{label}: global losses {loss}, one process's {ref} (step 1 rtol 1e-5, all "
             f"{TRAIN_LOSS_RTOL})")
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    err = max(grad_err(got[0]["grads"][n], g, scale, f"{label} step-1 gradient of {n}")
              for n, g in want["grads"].items()) / scale
    print(f"dp {label}: {DP_RANKS} gloo ranks on one card, losses {loss} against one process's "
          f"{ref} (step 1 {first:.3e}, worst {worst:.3e}); {len(want['grads'])} reduced "
          f"gradients within {err:.3e} of the largest magnitude {scale:.3e}; parameters equal "
          f"across the ranks after each step; launches a rank {launches}")
    return err


def phase_dp(config, anet, files, serving, seed, rng, device, tmp):
    """Phase 23: data parallelism on one card (a)-(e); see the module
    docstring."""
    import copy

    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.inference import AsyncLocalizer, MomentLocalizer
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    t_phase = time.perf_counter()
    cfg, n = config.model, config.model.num_smi_layers

    def host_batch(c):
        return {k: v.numpy() for k, v in synthetic_batch(c, TRAIN_BATCH, rng).items()}

    torch.manual_seed(seed + 23)
    initial = SMIN(cfg).state_dict()
    batches = [host_batch(cfg) for _ in range(TRAIN_STEPS)]
    tail = {k: v.copy() for k, v in batches[0].items()}
    for v in tail.values():    # the loader's zero padding past the valid rows
        v[DP_TAIL_VALID:] = 0
    torch.manual_seed(seed + 24)
    anet_initial = SMIN(anet.model).state_dict()
    anet_batch = host_batch(anet.model)

    # (a) one process on the card first, then the two ranks.
    want = {"charades": dp_reference(config, initial, batches, device, evaluate=True),
            "tail": dp_reference(config, initial, [tail], device),
            "activitynet": dp_reference(anet, anet_initial, [anet_batch], device)}
    fit_root = os.path.join(tmp, "dp_fit")
    job = dict(cases=[
        dict(name="charades", config=config, state=initial, batches=batches, eval=True,
             time=True),
        dict(name="tail", config=config, state=initial, batches=[tail]),
        dict(name="activitynet", config=anet, state=anet_initial, batches=[anet_batch])],
        files_cfg=files_config(fit_root, files["data"], resume=False))
    job_path = os.path.join(tmp, "dp_job.pt")
    torch.save(job, job_path)
    pattern = os.path.join(tmp, "dp_rank%d.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh.spawn(dp_rank, DP_RANKS, ["cuda:0"] * DP_RANKS, "gloo", args=(job_path, pattern),
               timeout_s=DP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(pattern % r, weights_only=False) for r in range(DP_RANKS)]
    errs = {
        "charades": dp_hold("Charades B=64", [r["charades"] for r in ranks], want["charades"],
                            {"K1f": TRAIN_STEPS, "K1b": TRAIN_STEPS, "K2": n * TRAIN_STEPS,
                             "K3": n * TRAIN_STEPS}),
        "tail": dp_hold(f"Charades, {DP_TAIL_VALID} valid of B=64 (32 and 8 a rank)",
                        [r["tail"] for r in ranks], want["tail"],
                        {"K1f": 1, "K1b": 1, "K2": n, "K3": n}),
        "activitynet": dp_hold("ActivityNet B=64", [r["activitynet"] for r in ranks],
                               want["activitynet"],
                               {"K6f": 1, "K6b": 1, "K7f": anet.model.num_smi_layers,
                                "K7b": anet.model.num_smi_layers})}
    ev_loss, ev_counts = want["charades"]["eval"]
    for r, rank in enumerate(ranks):
        sums = rank["charades"]["eval"]
        loss = float(sums[0] / sums[1])
        if rank["charades"]["eval_launches"] != {"K5": 1, "K4": 1}:
            fail(f"dp eval: rank {r} launched {rank['charades']['eval_launches']}")
        if (abs(loss - ev_loss) > EVAL_LOSS_RTOL * abs(ev_loss)
                or not torch.equal(sums[2:].float().reshape(ev_counts.shape), ev_counts)):
            fail(f"dp eval: rank {r}'s summed loss {loss} and counts {sums[2:].tolist()}, one "
                 f"process's {ev_loss} and {ev_counts.flatten().tolist()}")
    print(f"dp eval: the ranks' summed loss {loss} and counts equal one process's ({ev_loss}, "
          f"rtol {EVAL_LOSS_RTOL}); K5 and K4 once a rank")

    # (b) Trainer.fit at two gloo ranks against phase 17's epoch 1.
    writes = [r["fit"]["writes"] for r in ranks]
    if writes != [{"stats": 1, "checkpoint": 1}] + [{"stats": 0, "checkpoint": 0}] * (
            DP_RANKS - 1):
        fail(f"dp fit: writes per rank {writes}")
    if sorted(os.listdir(os.path.join(fit_root, "ckpt"))) != [
            "charades_files_model.ckpt", "charades_files_stats.json"]:
        fail(f"dp fit: checkpoint directory {os.listdir(os.path.join(fit_root, 'ckpt'))}")
    fit_stats = read_stats(job["files_cfg"])
    single = {k: v[0] for k, v in files["stats"].items()}
    fit_diff = {}
    for key, ref in single.items():
        fit_diff[key] = abs(fit_stats[key][0] - ref)
        if fit_diff[key] > DP_FIT_TOL * max(abs(ref), 1.0):
            fail(f"dp fit: epoch-1 {key} {fit_stats[key][0]!r} at {DP_RANKS} ranks, "
                 f"{ref!r} in phase 17 (tolerance {DP_FIT_TOL})")
    print(f"dp fit: one epoch at {DP_RANKS} gloo ranks in {ranks[0]['fit']['seconds']:.1f} s; "
          f"stats written once, by rank 0; epoch-1 stats within {max(fit_diff.values()):.3e} of "
          f"phase 17's (train loss {fit_stats['train_loss'][0]!r} against "
          f"{single['train_loss']!r})")

    # (c) the CLI under --distributed as a one-process NCCL group.
    cli_cfg = files_config(os.path.join(tmp, "dp_cli"), files["data"], resume=False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "video_moment_localization_tpu_torch.main", "--config_path",
         cli_cfg, "--num_epochs", "1", "--distributed"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dp --distributed: exit {proc.returncode}: {proc.stderr[-3000:]}")
    cli_stats = read_stats(cli_cfg)
    differ = {k: (cli_stats[k][0], v) for k, v in single.items() if cli_stats[k][0] != v}
    if differ:
        fail(f"dp --distributed: epoch-1 stats differ from phase 17's: {differ}")
    print(f"dp --distributed: one epoch as a one-process NCCL group in {cli_s:.1f} s (process "
          f"included); epoch-1 stats equal to phase 17's bit for bit")

    # (d) serving over two replicas named on cuda:0.
    one = MomentLocalizer.from_checkpoint(serving["cfg_path"], glove_path=serving["glove"],
                                          serve_batch=16)
    two = MomentLocalizer(one.cfg, copy.deepcopy(one.model), one.embedding, serve_batch=16,
                          devices=[device, device])
    lstm_cuda.bilstm_fused.launches = smin_cuda.smin_stack_fused.launches = 0
    worst = check_answers(two.localize_batch(serving["requests"], top_k=5), serving["top5"],
                          "dp serving")
    served = {"K5": lstm_cuda.bilstm_fused.launches, "K4": smin_cuda.smin_stack_fused.launches}
    if min(served.values()) < 1:
        fail(f"dp serving: launches {served}")
    videos = [rng.standard_normal((int(k), cfg.input_video_dim)).astype("float32")
              for k in rng.integers(8, 201, size=32)]
    reqs = [(videos[k], QUERIES[q], videos[k].shape[0] / 2.0) for k, q in zip(
        rng.integers(0, len(videos), size=DP_ASYNC_REQUESTS),
        rng.integers(0, len(QUERIES), size=DP_ASYNC_REQUESTS))]
    with AsyncLocalizer(two, top_k=5, max_wait_ms=2.0, max_in_flight=2) as server:
        futures = [server.submit(*r) for r in reqs]
        answers = [f.result(timeout=300) for f in futures]
    if server.stats.snapshot()["errors"]:
        fail("dp serving: AsyncLocalizer errors")
    async_worst = check_answers(answers, two.localize_batch(reqs, top_k=5), "dp async")
    print(f"dp serving: 2 replicas on {device}, buckets {two.bucket_sizes}: phase 3's 24 "
          f"requests' top-5 equal the single-device localizer's (scores within {worst:.3e}), "
          f"launches {served}; AsyncLocalizer over it on {DP_ASYNC_REQUESTS} requests equal to "
          f"localize_batch's (within {async_worst:.3e})")
    del one, two

    # (e) a step at world 1 without and with the gradient reduction (a
    # one-process NCCL group), beside the two ranks' step and all-reduce.
    mesh.initialize_distributed("nccl", 0, 1, "file://" + os.path.join(tmp, "dp_store"),
                                device=device)
    steps = {}
    for label, group in (("no_group", None), ("nccl_world1", mesh.default_group())):
        model = SMIN(cfg)
        model.load_state_dict(initial)
        steps[label] = make_train_step(cfg, model, build_optimizer(config, model), device,
                                       group=group)
    shard = dp_shard(batches[0], 0, 1, device)
    world1 = {label: step_wall_ms(step, shard) for label, step in steps.items()}
    model = SMIN(cfg).to(device)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    world1["nccl_reduce"] = dp_wall_ms(
        lambda: mesh.all_reduce_gradients(model.named_parameters(), mesh.default_group()))
    torch.distributed.destroy_process_group()
    del steps, model
    torch.cuda.empty_cache()
    two_rank = {k: statistics.mean(r["charades"][k] for r in ranks)
                for k in ("step_ms", "reduce_ms")}
    n_params = sum(p.numel() for p in SMIN(cfg).parameters())
    print(f"dp times ({card_line()}): Charades B=64 step at world 1 {world1['no_group']:.3f} ms "
          f"without a group, {world1['nccl_world1']:.3f} ms with the NCCL all-reduce of "
          f"{n_params} gradients ({world1['nccl_reduce']:.3f} ms alone); one-card, host-staged "
          f"figures that say nothing of NCCL across cards: {DP_RANKS} gloo ranks' step "
          f"(B=32 a rank) {two_rank['step_ms']:.3f} ms, its gradient all-reduce "
          f"{two_rank['reduce_ms']:.3f} ms ({two_rank['reduce_ms'] / two_rank['step_ms']:.1%} "
          f"of the step); spawn of the ranks {spawn_s:.1f} s")
    return dict(
        card=card_line(), losses={k: ranks[0][k]["loss"] for k in errs},
        one_process_losses={k: want[k]["loss"] for k in errs}, grad_err_of_magnitude=errs,
        fit_max_abs_diff=max(fit_diff.values()), fit_seconds=ranks[0]["fit"]["seconds"],
        cli_nccl_bit_equal=True, cli_seconds=cli_s, serving_max_score_diff=worst,
        async_max_score_diff=async_worst, world1_step_ms=world1["no_group"],
        world1_nccl_step_ms=world1["nccl_world1"], world1_nccl_reduce_ms=world1["nccl_reduce"],
        gloo_two_rank_step_ms=two_rank["step_ms"],
        gloo_two_rank_reduce_ms=two_rank["reduce_ms"], gradients=n_params,
        spawn_seconds=spawn_s, seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------------------------- #
# Phase 24: sequence and 2-D parallelism on one card
# ------------------------------------------------------------------------- #
# The ranks share the card through gloo, as in phase 23; the seq collectives
# stage through the host for a gloo group (`parallel.collectives.route`). The
# 2-D steps run the plain PyTorch units (the JAX sequence-parallel forward
# runs on XLA alone), so they launch none of K1-K10. They are held to one
# process's steps on the card, which run the kernel routes, with the JAX 2-D
# tests' tolerances for the parameters after 3 Adam steps (packed: rtol 3e-4
# / atol 3e-5, tests/test_seq_packed.py:97; dense: 5e-4 / 5e-5,
# tests/test_train_2d.py:63). The CLI's epoch is held to phase 17's epoch 1
# as phase 23 (b) holds its fit.
SEQ_GRIDS = ((1, 2), (2, 2))
SEQ_PARAM_TOL = {"packed": dict(rtol=3e-4, atol=3e-5), "dense": dict(rtol=5e-4, atol=5e-5)}
SEQ_MEMORY_WIDTHS = (1, 2, 4)
SEQ_COLLECTIVE_REPS = 3
# tests/test_seq_packed.py:100-124: the long-video configuration at its widths.
SEQ_LONG = dict(T=512, L=32, C=4, D=512, dl=128, num_smi_layers=1, input_video_dim=64,
                max_query_length=8, lstm_hidden_size=256)
SEQ_TIMEOUT_S = 600


def seq_data_shard(batch, grid):
    """Data index ``grid.data``'s rows of a global host batch (NumPy), with
    the global batch's valid count."""
    import numpy as np

    b = len(batch["sample_mask"]) // grid.nd
    out = {k: np.ascontiguousarray(v[grid.data * b:(grid.data + 1) * b]) for k, v in batch.items()}
    out["global_valid"] = np.asarray(batch["sample_mask"].sum(), np.float32)
    return out


def seq_steps(case, grid, device, counters):
    """A case's 2-D train steps on this rank: per step the global loss, the
    global counts, whether the parameters equal rank 0's bit for bit, the
    wall ms (ending in a synchronize; gloo blocks the host) and, with
    "outputs", this data shard's (pm, ps, pe) before the step from its seq
    rank 0; the peak device memory over the steps (and what was allocated
    before them), the kernels launched, and with "params" the parameters
    after the last step and, on rank 0, the step-1 gradients summed over
    the world (what the optimizer took)."""
    import torch
    import torch.distributed as dist

    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.parallel.model_parallel import (
        make_train_step_2d,
        put_batch_2d,
        seq_forward,
    )
    from video_moment_localization_tpu_torch.parallel.steps import build_optimizer

    config = case["config"]
    cfg = config.model
    torch.manual_seed(case["seed"])
    model = SMIN(cfg)
    if case.get("state") is not None:
        model.load_state_dict(case["state"])
    mesh.put_replicated(model.to(device), grid.world_group)
    step = make_train_step_2d(cfg, model, build_optimizer(config, model), grid, device)
    res = {"loss": [], "counts": [], "equal": [], "outputs": [], "step_ms": []}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    res["start_gib"] = torch.cuda.memory_allocated(device) / 2**30
    for batch in case["batches"]:
        b = put_batch_2d(seq_data_shard(batch, grid), grid, device)
        if case.get("outputs"):
            with torch.no_grad():
                outs = seq_forward(cfg, model, b, grid.seq_group)
            res["outputs"].append(tuple(o.cpu() for o in outs[:3]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(b)
        torch.cuda.synchronize()
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if case.get("params") and not res.get("grads") and grid.data == grid.seq_index == 0:
            res["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        res["loss"].append(float(mesh.all_reduce_sums(m["loss"].clone(), grid.data_group)))
        res["counts"].append(mesh.all_reduce_sums(m["counts"].double(), grid.data_group).cpu())
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        first = flat.clone()
        if grid.world_group is not None:
            dist.broadcast(first, src=0, group=grid.world_group)
        res["equal"].append(bool(torch.equal(flat, first)))
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["launches"] = dp_counts(counters)
    res["finite"] = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if case.get("params"):
        res["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return res


def seq_rank(rank, job_path, out_pattern):
    """One rank of phase 24 (`parallel.mesh.spawn`: gloo, every rank on
    cuda:0): each case of the job (`seq_steps`) on the (data x seq) grid of
    its "seq" over all the ranks. Saves the results and the collectives'
    route to ``out_pattern % rank``."""
    import torch

    from video_moment_localization_tpu_torch.parallel import collectives, mesh

    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["device"])
    counters = dp_counters()
    grids, out = {}, {}
    for case in job["cases"]:
        seq = case["seq"]
        if seq not in grids:
            grids[seq] = mesh.make_grid_2d(seq)
        grid = grids[seq]
        out["route"] = collectives.route(grid.seq_group)
        out[case["name"]] = dict(seq_steps(case, grid, device, counters),
                                 grid=(grid.nd, grid.seq), data=grid.data,
                                 seq_index=grid.seq_index)
    # The packed pool's collectives alone on the Charades step's buffer (its
    # forward reduce-scatter, its backward all-gather), over a seq group of 2.
    group = grids[2].seq_group
    part = torch.randn(job["pool_shape"], device=device)
    chunk = collectives.reduce_scatter(part, 1, group)
    out["pool_ms"] = {}
    for name, fn in (("reduce_scatter", lambda: collectives.reduce_scatter(part, 1, group)),
                     ("all_gather", lambda: collectives.all_gather(chunk, 1, group))):
        walls = []
        for _ in range(SEQ_COLLECTIVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["pool_ms"][name] = statistics.median(walls)
    torch.save(out, out_pattern % rank)


def seq_reference(config, state, batches, device):
    """One process's 3 steps on the card (the kernel routes): losses,
    counts, (pm, ps, pe) before each step, step-1 gradients, parameters
    after the last."""
    import torch

    from video_moment_localization_tpu_torch.models.smin import SMIN, smin_forward
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.parallel.steps import (
        _FORWARD_KEYS,
        build_optimizer,
        make_train_step,
    )

    model = SMIN(config.model)
    model.load_state_dict(state)
    step = make_train_step(config.model, model, build_optimizer(config, model), device)
    res = {"loss": [], "counts": [], "outputs": []}
    for batch in batches:
        b = mesh.put_batch(batch, device)
        with torch.no_grad():
            outs = smin_forward(model, config.model, *(b.get(k) for k in _FORWARD_KEYS))
        res["outputs"].append(tuple(o.cpu() for o in outs[:3]))
        m = step(b)
        if "grads" not in res:
            res["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        res["loss"].append(float(m["loss"]))
        res["counts"].append(m["counts"].double().cpu())
    res["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return res


def seq_tied_scores(cfg, got, want, batch, k=5):
    """Where the top-k of two runs' scores differ: the first sample whose
    top-k indices differ and the scores of both runs at those indices."""
    import torch

    from video_moment_localization_tpu_torch.train.metrics import (
        proposal_scores,
        proposal_scores_packed,
        topk_lowest_index_first,
    )

    def scores(outs):
        pm, ps, pe = outs
        lm = torch.from_numpy(batch["length_mask"])
        if pm.dim() == 2:
            return proposal_scores_packed(pm, ps, pe, lm, cfg.L)
        return proposal_scores(pm, ps, pe, torch.from_numpy(batch["moment_mask"])).reshape(
            pm.shape[0], -1)

    a, b = scores(got), scores(want)
    ia, ib = topk_lowest_index_first(a, k)[1], topk_lowest_index_first(b, k)[1]
    for s in range(a.shape[0]):
        if not torch.equal(ia[s], ib[s]):
            idx = sorted(set(ia[s].tolist()) ^ set(ib[s].tolist()))
            return (f"sample {s}: top-{k} {ia[s].tolist()} against {ib[s].tolist()}; scores at "
                    f"{idx}: 2-D {[float(a[s, i]) for i in idx]}, one process "
                    f"{[float(b[s, i]) for i in idx]}")
    return "the same top-k indices in every sample"


def seq_hold(label, cfg, layout, ranks, want, batches):
    """A (data x seq) case against one process's steps: the global losses
    within TRAIN_LOSS_RTOL, the step-1 gradients summed over the world
    against one process's (GRAD_RTOL, GRAD_ATOL_REL of each module's largest
    magnitude: a leaf's gradient off by a uniform factor, such as a missing
    1/seq on the replicated leaves, fails here, where Adam's update after 3
    steps would hide it), the counts equal (else the tied scores), the
    parameters after the last step at SEQ_PARAM_TOL[layout], every rank's
    parameters equal to rank 0's after every step, and no kernel launched.
    Returns the worst relative loss error, the worst gradient error against
    its module's magnitude and the worst parameter error against its
    tolerance's scale."""
    import torch

    got = ranks[0]
    for r, rank in enumerate(ranks):
        if rank["loss"] != got["loss"] or not all(rank["equal"]):
            fail(f"seq {label}: rank {r}'s losses {rank['loss']} / parameter equality "
                 f"{rank['equal']} against rank 0's {got['loss']}")
        if rank["launches"]:
            fail(f"seq {label}: rank {r} launched {rank['launches']}: the 2-D path runs no kernel")
    worst = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    if worst > TRAIN_LOSS_RTOL:
        fail(f"seq {label}: global losses {got['loss']}, one process's {want['loss']} "
             f"(rtol {TRAIN_LOSS_RTOL})")
    scales = {}
    for name, g in want["grads"].items():
        key = ".".join(name.split(".")[:2])
        scales[key] = max(scales.get(key, 0.0), float(g.abs().max()))
    grad_worst = 0.0
    for name, g in want["grads"].items():
        scale = scales[".".join(name.split(".")[:2])]
        err = grad_err(got["grads"][name], g, scale, f"seq {label} step-1 gradient of {name}")
        grad_worst = max(grad_worst, err / scale if scale else err)
    nd = got["grid"][0]
    leads = sorted((r for r in ranks if r["seq_index"] == 0), key=lambda r: r["data"])
    assert len(leads) == nd
    for i, (c, w) in enumerate(zip(got["counts"], want["counts"])):
        if not torch.equal(c, w):
            outs = tuple(torch.cat([r["outputs"][i][j] for r in leads]) for j in range(3))
            fail(f"seq {label}: step {i + 1} counts {c.flatten().tolist()}, one process's "
                 f"{w.flatten().tolist()}: {seq_tied_scores(cfg, outs, want['outputs'][i], batches[i])}")
    tol = SEQ_PARAM_TOL[layout]
    ratio, bad = 0.0, []
    for name, p in want["params"].items():
        q = ranks[0]["params"][name]
        excess = float(((q - p).abs() / (tol["atol"] + tol["rtol"] * p.abs())).max())
        ratio = max(ratio, excess)
        if excess > 1.0:
            bad.append(f"{name} (max abs diff {float((q - p).abs().max()):.3e})")
    if bad:
        fail(f"seq {label}: parameters after {len(batches)} steps outside rtol {tol['rtol']} / "
             f"atol {tol['atol']} of one process's: {bad}")
    print(f"seq {label}: grid {got['grid']}, losses {got['loss']} against one process's "
          f"{want['loss']} (worst {worst:.3e}); {len(want['grads'])} step-1 gradients summed "
          f"over the world within {grad_worst:.3e} of their module's largest magnitude; counts "
          f"equal each step; parameters within {ratio:.3f} of their tolerance; equal across the "
          f"ranks after each step; no kernel launched; step wall ms "
          f"{[round(t, 3) for t in got['step_ms']]}")
    return worst, grad_worst, ratio


def phase_seq(config, anet, files, seed, rng, device, tmp):
    """Phase 24: sequence and 2-D parallelism on one card (a)-(d); see the
    module docstring."""
    import dataclasses

    import numpy as np
    import torch

    from video_moment_localization_tpu_torch.config import ModelConfig
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.parallel import mesh
    from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

    t_phase = time.perf_counter()
    card = f"cuda:{torch.cuda.current_device()}" if device.type == "cuda" else str(device)

    def host_batch(c, B):
        return {k: v.numpy() for k, v in synthetic_batch(c, B, rng).items()}

    # (a) Charades at full width and depth, packed and dense (compat_head).
    layouts = {"packed": config, "dense": dataclasses.replace(
        config, model=dataclasses.replace(config.model, compat_head=True))}
    charades = {}
    for k, (layout, cfgx) in enumerate(layouts.items()):
        torch.manual_seed(seed + 240 + k)
        state = SMIN(cfgx.model).state_dict()
        batches = [host_batch(cfgx.model, TRAIN_BATCH) for _ in range(TRAIN_STEPS)]
        charades[layout] = (cfgx, state, batches, seq_reference(cfgx, state, batches, device))
    # (b) ActivityNet, packed: one process's peak memory and step time at seq 1.
    anet_batches = [host_batch(anet.model, TRAIN_BATCH)]
    grid1 = mesh.make_grid_2d(1)
    memory = {1: seq_steps(dict(config=anet, seed=seed + 250, batches=anet_batches), grid1,
                           device, dp_counters())}
    # (c) the long-video configuration.
    long_cfg = dataclasses.replace(config, model=ModelConfig(**SEQ_LONG), lr=1e-3)
    long_batch = host_batch(long_cfg.model, 2)

    runs, route, spawn_s, pool_ms = {}, None, {}, {}
    for world in (2, 4):
        cases = [dict(name=f"{layout}_{nd}x{sq}", seq=sq, config=c[0], state=c[1], batches=c[2],
                      outputs=True, params=True, seed=0)
                 for nd, sq in SEQ_GRIDS if nd * sq == world for layout, c in charades.items()]
        cases.append(dict(name=f"anet_seq{world}", seq=world, config=anet, seed=seed + 250,
                          batches=anet_batches))
        if world == 4:
            cases.append(dict(name="long_2x2", seq=2, config=long_cfg, seed=seed + 260,
                              batches=[long_batch]))
        job_path = os.path.join(tmp, f"seq_job{world}.pt")
        cfg_n = config.model.L * (config.model.L + 1) // 2
        torch.save(dict(cases=cases, device=card, pool_shape=(
            TRAIN_BATCH, cfg_n, config.model.C, config.model.D)), job_path)
        pattern = os.path.join(tmp, f"seq{world}_rank%d.pt")
        t0 = time.perf_counter()
        mesh.spawn(seq_rank, world, [card] * world, "gloo", args=(job_path, pattern),
                   timeout_s=SEQ_TIMEOUT_S)
        spawn_s[world] = time.perf_counter() - t0
        ranks = [torch.load(pattern % r, weights_only=False) for r in range(world)]
        route = ranks[0]["route"]
        pool_ms[world] = ranks[0]["pool_ms"]
        for case in cases:
            runs[case["name"]] = [r[case["name"]] for r in ranks]
    print(f"seq collectives on the gloo groups: {route}")

    parity = {}
    for nd, sq in SEQ_GRIDS:
        for layout, (cfgx, _, batches, want) in charades.items():
            name = f"{layout}_{nd}x{sq}"
            loss_err, grad_err_rel, param_ratio = seq_hold(
                f"Charades B={TRAIN_BATCH} {name}", cfgx.model, layout, runs[name], want, batches)
            parity[name] = dict(losses=runs[name][0]["loss"], one_process_losses=want["loss"],
                                worst_loss_rel=loss_err, grad_err_of_module_scale=grad_err_rel,
                                param_err_of_tolerance=param_ratio,
                                step_ms=runs[name][0]["step_ms"])
    for world in (2, 4):
        memory[world] = runs[f"anet_seq{world}"]
    mem = {}
    for sq, res in memory.items():
        ranks = res if isinstance(res, list) else [res]
        for r, rank in enumerate(ranks):
            if rank["launches"] or not rank["finite"]:
                fail(f"seq ActivityNet seq={sq}: rank {r} launched {rank['launches']}, finite "
                     f"parameters {rank['finite']}")
        mem[sq] = dict(peak_gib_per_rank=[rk["peak_gib"] for rk in ranks],
                       start_gib_per_rank=[rk["start_gib"] for rk in ranks],
                       step_ms=ranks[0]["step_ms"][-1], loss=ranks[0]["loss"])
        print(f"seq ActivityNet B={TRAIN_BATCH} packed, seq={sq} ({card_line()}; one-card, "
              f"host-staged gloo figures): peak device memory per rank "
              f"{[round(g, 3) for g in mem[sq]['peak_gib_per_rank']]} GiB (allocated before "
              f"the steps {[round(g, 3) for g in mem[sq]['start_gib_per_rank']]}), step "
              f"{mem[sq]['step_ms']:.1f} ms (one step), loss {mem[sq]['loss']}")
    pool_mb = TRAIN_BATCH * config.model.L * (config.model.L + 1) // 2 * config.model.C * \
        config.model.D * 4 / 1e6
    for world, ms in pool_ms.items():
        print(f"seq pool collectives alone ({card_line()}; one-card, host-staged gloo figures), "
              f"{world} ranks on the card, a seq group of 2: the reduce-scatter of the Charades "
              f"B={TRAIN_BATCH} partial sums ({pool_mb:.1f} MB) {ms['reduce_scatter']:.1f} ms, "
              f"its backward all-gather {ms['all_gather']:.1f} ms")
    losses = [m["loss"][0] for m in mem.values()]
    if max(losses) - min(losses) > TRAIN_LOSS_RTOL * abs(losses[0]):
        fail(f"seq ActivityNet: step-1 losses at seq 1/2/4 {losses} differ past "
             f"{TRAIN_LOSS_RTOL}")
    long = runs["long_2x2"]
    if not all(np.isfinite(r["loss"][0]) and r["finite"] for r in long):
        fail(f"seq long video: loss {long[0]['loss']}, finite parameters "
             f"{[r['finite'] for r in long]}")
    print(f"seq long video (T={SEQ_LONG['T']}, L={SEQ_LONG['L']}, D={SEQ_LONG['D']}, "
          f"dl={SEQ_LONG['dl']}) 2x2: loss {long[0]['loss'][0]!r} finite, "
          f"parameters finite; peak per rank {[round(r['peak_gib'], 3) for r in long]} GiB, step "
          f"{long[0]['step_ms'][0]:.1f} ms")

    # (d) the CLI on the 2-D grid: two gloo ranks on cuda:0.
    cli_cfg = files_config(os.path.join(tmp, "seq_cli"), files["data"], resume=False)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "video_moment_localization_tpu_torch.main", "--config_path",
         cli_cfg, "--num_epochs", "1", "--num_devices", "2", "--seq_devices", "2", "--device",
         card], cwd=REPO, capture_output=True, text=True,
        timeout=SEQ_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"seq CLI: exit {proc.returncode}: {proc.stderr[-3000:]}")
    if proc.stdout.count("Training Epoch - 1") != 1 or proc.stdout.count("throughput - ") != 1:
        fail(f"seq CLI: stdout not written once: {proc.stdout[-2000:]}")
    ckpt_dir = os.path.join(tmp, "seq_cli", "ckpt")
    if sorted(os.listdir(ckpt_dir)) != ["charades_files_model.ckpt", "charades_files_stats.json"]:
        fail(f"seq CLI: checkpoint directory {os.listdir(ckpt_dir)}")
    cli_stats = read_stats(cli_cfg)
    single = {k: v[0] for k, v in files["stats"].items()}
    cli_diff = {}
    for key, ref in single.items():
        cli_diff[key] = abs(cli_stats[key][0] - ref)
        if cli_diff[key] > DP_FIT_TOL * max(abs(ref), 1.0):
            fail(f"seq CLI: epoch-1 {key} {cli_stats[key][0]!r} on the 1x2 grid, {ref!r} in "
                 f"phase 17 (tolerance {DP_FIT_TOL})")
    print(f"seq CLI: --num_devices 2 --seq_devices 2 --device {card} (gloo), one epoch "
          f"in {cli_s:.1f} s (processes included); written once, by rank 0; epoch-1 stats "
          f"within {max(cli_diff.values()):.3e} of phase 17's (train loss "
          f"{cli_stats['train_loss'][0]!r} against {single['train_loss']!r})")
    return dict(
        card=card_line(), route=route, charades=parity, activitynet_memory=mem,
        long_video=dict(loss=long[0]["loss"][0], peak_gib_per_rank=[r["peak_gib"] for r in long],
                        step_ms=long[0]["step_ms"][0]),
        pool_collective_ms=pool_ms, pool_mb=pool_mb,
        cli_max_abs_diff=max(cli_diff.values()), cli_seconds=cli_s,
        spawn_seconds=spawn_s, seconds=time.perf_counter() - t_phase,
        note="one-card figures: every rank on cuda:0, gloo collectives staged through the host; "
             "they say nothing of NCCL over NVLink")


def device_split(fn, calls: int = 10) -> dict:
    """What one call of fn() runs on the card, from torch.profiler over
    ``calls`` calls (utils/profile_serving.py's report) after two calls
    traced and dropped (the tracer loses kernels of the first calls it
    sees): its kernel launches and their device time (summed, and the time
    some kernel runs: the union of their intervals, where kernels on two
    streams at once count once), and the shared GEMM's share of both (its
    products and split-K reductions)."""
    import torch

    from video_moment_localization_tpu_torch.utils.profile_serving import (
        covered_ms, device_intervals, device_rows, is_product)

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=2, active=calls, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2 + calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = device_rows(prof.key_averages())
    prods = [r for r in rows if is_product(r[0])]
    return dict(launches=sum(r[1] for r in rows) // calls,
                kernel_ms=sum(r[2] for r in rows) / calls,
                busy_ms=covered_ms(device_intervals(prof.events())) / calls,
                product_launches=sum(r[1] for r in prods) // calls,
                product_ms=sum(r[2] for r in prods) / calls)


def split_note(r):
    """A timed row's device split (`device_split`) for its line: launches,
    kernel time, the products' share and the part of a call back to back
    that no kernel covers."""
    sp = r.get("split")
    if not sp:
        return ""
    return (f"; a call {sp['launches']} launches, {sp['kernel_ms']:.4f} ms of kernels (products "
            f"{sp['product_ms']:.4f} ms in {sp['product_launches']}), busy {sp['busy_ms']:.4f} "
            f"ms, no kernel {r['device_ms'] - sp['busy_ms']:.4f} ms of the back-to-back time")


def back_to_back(r):
    """The back-to-back device times of a timed row, and its device split
    (`device_split`: launches per call and their device time), where it has
    them."""
    return {k: r[k] for k in ("device_ms", "library_device_ms", "split") if k in r}


def b2b_note(r):
    """The library call's back-to-back time of a timed row, for its line."""
    if r.get("library_device_ms") is None:
        return ""
    return f", library back to back {r['library_device_ms']:.4f} ms"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from video_moment_localization_tpu_torch.config import load_config
        from video_moment_localization_tpu_torch.models.smin import SMIN
        from video_moment_localization_tpu_torch.ops.cuda_build import BUILD_DIR, build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)   # serving: the plain versions time without autograd
    device = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, {len(SOURCES)} sources in "
          f"parallel)")
    for name in SOURCES:
        with open(os.path.join(BUILD_DIR, f"{name}.log")) as fh:
            for line in fh:
                if "Used" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    config = load_config(os.path.join(REPO, "config", "charadessta.yml"))
    cfg = config.model
    anet = load_config(os.path.join(REPO, "config", "activitynet.yml"))
    k5_plans, k5_plans16 = phase_plans(
        [(n, load_config(os.path.join(REPO, "config", f"{n}.yml")).model)
         for n in ("charadessta", "activitynet", "tacos")])
    lap(1)
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    model = SMIN(cfg).to(device).eval()
    k5_err, k4_err, plain_repeats = phase_parity(cfg, model, rng, device)
    lap(2)

    # Phase 3's checkpoint, GloVe file and requests serve phases 18 and 19 too.
    serve_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-")
    gpu, launches, serving = phase_serving(cfg, args.seed, rng, serve_tmp.name)
    lap(3)
    times = phase_times(cfg, gpu, rng)
    lap(4)

    train_errs = phase_train_parity(cfg, model, rng, device)
    lap(5)
    step, batch, train_launches = phase_train(config, args.seed, rng, device)
    lap(6)
    train_times = phase_train_times(cfg, model, step, batch, rng, device)
    lap(7)
    del step, batch, gpu, model
    torch.cuda.empty_cache()

    torch.manual_seed(args.seed)
    anet_model = SMIN(anet.model).to(device).eval()
    anet_errs = phase_anet_parity(anet.model, anet_model, rng, device)
    lap(8)
    anet_step, anet_batch, anet_launches, anet_peak, anet_eval_err = phase_anet_train(
        anet, args.seed, rng, device)
    lap(9)
    anet_times = phase_anet_times(anet.model, anet_model, anet_step, anet_batch, rng, device)
    lap(10)
    del anet_step, anet_batch, anet_model
    torch.cuda.empty_cache()

    torch.manual_seed(args.seed)
    model = SMIN(cfg).to(device).eval()
    mode_errs = phase_mode_parity(cfg, model, anet.model, rng, device)
    lap(11)
    modes = phase_modes(config, args.seed, rng, device)
    lap(12)
    mode_times = phase_mode_times(cfg, model, modes, rng, device)
    lap(13)
    del model
    torch.cuda.empty_cache()
    gemm_rows = phase_gemm(cfg, anet.model, device)
    # The bf16 products of K7-bf16 (ActivityNet B=64) and K4-bf16 (Charades
    # B=512 and B=16) on their epilogues, on both bf16 kernels, beside bf16
    # torch.matmul, each against its bound (utils/bench_gemm_bf16.py).
    from video_moment_localization_tpu_torch.utils import bench_gemm_bf16

    gemm_bf16_rows = bench_gemm_bf16.run(launches=10, seed=args.seed, quick=False,
                                         kernels=("K7f-bf16", "K7b-bf16", "K4-bf16"))
    lap(14)
    pair_times, pair_errs = phase_pair({"charadessta": cfg, "activitynet": anet.model}, rng,
                                       device)
    lap(15)
    unheld_errs = phase_unheld(anet.model, rng, device)
    lap(16)
    # Phase 17's directory and stats serve phase 23 too.
    files_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-files-")
    files, files_run = phase_files(config, args.seed, device, files_tmp.name)
    lap(17)
    torch.cuda.empty_cache()
    async_runs = phase_async(cfg, serving, times["with_host_pairs_per_s"], rng)
    lap(18)
    bf16 = phase_bf16(cfg, anet.model, serving, {B: times[("e2e", B)] for B in (16, 512)}, rng,
                      device)
    lap(19)
    bf16_train = phase_bf16_train(config, args.seed, rng, device)
    lap(20)
    bf16_content = phase_bf16_content(anet, config, args.seed, rng, device)
    lap(21)
    bf16_dense = phase_bf16_dense(anet, config, args.seed, rng, device)
    lap(22)
    torch.cuda.empty_cache()
    dp = phase_dp(config, anet, files_run, serving, args.seed, rng, device, files_tmp.name)
    lap(23)
    seq = phase_seq(config, anet, files_run, args.seed, rng, device, files_tmp.name)
    lap(24)
    serve_tmp.cleanup()
    files_tmp.cleanup()

    kernels = []
    for key, name, src, rep, err in (
            ("K5", "bilstm_fused", LSTM_SRC, LSTM_REPLACES, k5_err),
            ("K4", "smin_stack_fused", STACK_SRC, STACK_REPLACES, k4_err)):
        r16, r512 = times[(key, 16)], times[(key, 512)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], "max_abs_err": err,
            "ms": r16["ms"], "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
            "bound_by": r16["bound_by"], "library_ms": r16["library_ms"],
            "batch": 16,
            "ms_b512": r512["ms"], "plain_ms_b512": r512["plain_ms"],
            "bound_ms_b512": r512["bound_ms"], "bound_by_b512": r512["bound_by"],
            "library_ms_b512": r512["library_ms"],
            "bound_fp32_ms": r16["bound_fp32_ms"], "bound_fp32_ms_b512": r512["bound_fp32_ms"],
            **back_to_back(r16), **{f"{k}_b512": v for k, v in back_to_back(r512).items()},
        })
        ra = anet_times[key]
        kernels[-1].update({
            "ms_activitynet_b64": ra["ms"], "plain_ms_activitynet_b64": ra["plain_ms"],
            "bound_ms_activitynet_b64": ra["bound_ms"],
            "bound_fp32_ms_activitynet_b64": ra["bound_fp32_ms"],
            "library_ms_activitynet_b64": ra["library_ms"],
            "max_abs_err_activitynet": anet_errs[key]})
    kernels[0]["plan"] = k5_plans
    for key, name, src, rep, err in (
            ("K1f", "proposal_rows_forward", PROPOSAL_SRC, K1_FWD_REPLACES, train_errs["K1f"]),
            ("K1b", "proposal_rows_backward", PROPOSAL_SRC, K1_BWD_REPLACES, train_errs["K1b"]),
            ("K2", "smi_layer_forward", TRAIN_SRC, K2_REPLACES, train_errs["K2"]),
            ("K3", "smi_layer_backward", TRAIN_SRC, K3_REPLACES, train_errs["K3"])):
        r = train_times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": train_launches[key], "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
        })
        kernels[-1].update(back_to_back(r))
        if "bound_fp32_ms" in r:
            kernels[-1]["bound_fp32_ms"] = r["bound_fp32_ms"]
    kernels[-1]["max_err_of_magnitude"] = train_errs["K3_rel"]
    kernels[-1]["ms_without_dcu"] = train_times["K3_no_dcu_ms"]
    kernels[-1]["held_l64"] = {k: unheld_errs[k] for k in ("K2", "K3", "K3_rel")}
    kernels[1]["max_abs_err_activitynet_b512"] = unheld_errs["K4_b512"]
    # The content-attention pair, which K4, K2, K3, K7, K9 and K10 run inside
    # their entry points: launches by those entry points on the main path
    # (3 train steps; the serving run for the forward), times alone.
    for key, name, rep in (("CAf", "content_attn_forward", PAIR_FWD_REPLACES),
                           ("CAb", "content_attn_backward", PAIR_BWD_REPLACES)):
        cells = {c: r[key[-1]] for c, r in pair_times.items()}
        main_cell = cells["charadessta_b64"]
        kernels.append({
            "name": name, "route": "cuda", "source": PAIR_SRC, "replaces": rep,
            "launches": train_launches[key], "max_abs_err": pair_errs[key],
            "ms": main_cell["ms"], "plain_ms": main_cell["plain_ms"],
            "bound_ms": main_cell["bound_ms"], "bound_by": main_cell["bound_by"],
            "library_ms": None, "batch": TRAIN_BATCH, "device_ms": main_cell["device_ms"],
            "bound_share": main_cell["bound_share"],
            "cells": {c: r for c, r in cells.items() if c != "charadessta_b64"},
            "inside": ["K4", "K2", "K3", "K7", "K9", "K10"] if key == "CAf"
            else ["K3", "K7", "K10"],
        })
    kernels[-2]["launches_serving"] = launches["CAf"]
    kernels[-1]["max_err_of_magnitude"] = pair_errs["CAb_rel"]
    kernels[-1]["bf16"] = {c: r["b16"] for c, r in pair_times.items()}
    kernels[-1]["bf16_worst_mean_of_magnitude"] = pair_errs["CAb16"]
    for key, name, src, rep in (
            ("K6f", "proposal_packed_forward", PROPOSAL_SRC, K6_FWD_REPLACES),
            ("K6b", "proposal_packed_backward", PROPOSAL_SRC, K6_BWD_REPLACES),
            ("K7f", "content_rows_forward", CONTENT_SRC, K7_FWD_REPLACES),
            ("K7b", "content_rows_backward", CONTENT_SRC, K7_BWD_REPLACES)):
        r = anet_times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": anet_launches[key], "max_abs_err": anet_errs[key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
            "config": "activitynet",
        })
        kernels[-1].update(back_to_back(r))
        if "bound_fp32_ms" in r:
            kernels[-1]["bound_fp32_ms"] = r["bound_fp32_ms"]
    # K6 is its own Python entry and counters over K1's two C entry points.
    kernels[-4]["shares_c_entry_with"] = "proposal_rows_forward"
    kernels[-3]["shares_c_entry_with"] = "proposal_rows_backward"
    kernels[-1]["max_err_of_magnitude"] = anet_errs["K7b_rel"]
    kernels[-1]["ms_without_dcu"] = anet_times["K7b_no_dcu_ms"]
    for key, name, src, rep, mode in (
            ("K8f", "proposal_dense_forward", PROPOSAL_SRC, K8_FWD_REPLACES, "dense"),
            ("K8b", "proposal_dense_backward", PROPOSAL_SRC, K8_BWD_REPLACES, "dense"),
            ("K9", "smi_stack_forward", TRAIN_SRC, K9_REPLACES, "fused_fwd"),
            ("K10f", "content_unit_forward", CONTENT_SRC, K10_FWD_REPLACES, "compat"),
            ("K10b", "content_unit_backward", CONTENT_SRC, K10_BWD_REPLACES, "compat")):
        r = mode_times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": modes[mode][3][key], "max_abs_err": mode_errs[key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
            "mode": mode,
        })
        kernels[-1].update(back_to_back(r))
        if "bound_fp32_ms" in r:
            kernels[-1]["bound_fp32_ms"] = r["bound_fp32_ms"]
    kernels[-4]["max_err_of_magnitude"] = mode_errs["K8b_rel"]
    # K8 at the ActivityNet batch (phase 22, on the backbone's outputs).
    for row, way in ((kernels[-5], "fwd"), (kernels[-4], "bwd")):
        r = bf16_dense["times"][("K8", "ActivityNet")][way]
        row.update({f"{k}_activitynet_b64": r[k] for k in
                    ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                     "bound_by")})
        row["max_abs_err_activitynet_b64"] = bf16_dense["errs"][f"K8 {way} ActivityNet B=64"]
    kernels[-3]["per_layer_k2_ms"] = mode_times["K9_per_layer_ms"]
    kernels[-1]["max_err_of_magnitude"] = mode_errs["K10b_rel"]
    # The bf16 variants of K5 and K4 (phase 19): launches on the bf16
    # localizer's run, times at B=16 (and B=512) against their plain bf16
    # versions, bounds with bf16 products at 989 TFLOP/s.
    for key, name, src, rep in (("K5", "bilstm_fused_bf16", LSTM_SRC, LSTM_REPLACES),
                                ("K4", "smin_stack_fused_bf16", STACK_SRC, STACK_REPLACES)):
        r16, r512 = bf16["times"][(key, 16)], bf16["times"][(key, 512)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": bf16["launches"][key], "max_abs_err": bf16["errs"][key],
            "ms": r16["ms"], "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
            "bound_by": r16["bound_by"], "library_ms": r16["library_ms"], "batch": 16,
            "dtype": "bfloat16", **back_to_back(r16),
            "ms_b512": r512["ms"], **{f"{k}_b512": v for k, v in back_to_back(r512).items()},
            "plain_ms_b512": r512["plain_ms"], "bound_ms_b512": r512["bound_ms"],
            "bound_by_b512": r512["bound_by"], "library_ms_b512": r512["library_ms"],
        })
    kernels[-2]["plan"] = k5_plans16
    kernels[-1]["max_abs_err_activitynet_b64"] = bf16["errs"]["K4_activitynet_b64"]
    # The bf16 variants of K1, K2 and K3 (phase 20): launches on the 3 bf16
    # train steps, times at B=64 against their plain bf16 versions, bounds
    # with bf16 contractions at 989 TFLOP/s.
    for key, name, src, rep in (
            ("K1f", "proposal_rows_forward_bf16", PROPOSAL_SRC, K1_FWD_REPLACES),
            ("K1b", "proposal_rows_backward_bf16", PROPOSAL_SRC, K1_BWD_REPLACES),
            ("K2", "smi_layer_forward_bf16", TRAIN_SRC, K2_REPLACES),
            ("K3", "smi_layer_backward_bf16", TRAIN_SRC, K3_REPLACES)):
        r = bf16_train["times"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": bf16_train["launches"][f"{key}-bf16"],
            "max_abs_err": bf16_train["errs"][key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
            "dtype": "bfloat16", **back_to_back(r),
        })
    kernels[-1]["max_err_of_largest_weight_gradient"] = bf16_train["errs"]["K3_rel"]
    # The bf16 variants of K6, K7 (phase 21: launches on the 3 ActivityNet
    # bf16 steps, times at ActivityNet B=64) and K10 (launches on the compat
    # bf16 step, times at Charades B=64).
    bc = bf16_content
    for key, name, src, rep, launches, config_name in (
            ("K6f", "proposal_packed_forward_bf16", PROPOSAL_SRC, K6_FWD_REPLACES,
             bc["launches"]["K6f-bf16"], "activitynet"),
            ("K6b", "proposal_packed_backward_bf16", PROPOSAL_SRC, K6_BWD_REPLACES,
             bc["launches"]["K6b-bf16"], "activitynet"),
            ("K7f", "content_rows_forward_bf16", CONTENT_SRC, K7_FWD_REPLACES,
             bc["launches"]["K7f-bf16"], "activitynet"),
            ("K7b", "content_rows_backward_bf16", CONTENT_SRC, K7_BWD_REPLACES,
             bc["launches"]["K7b-bf16"], "activitynet"),
            ("K10f", "content_unit_forward_bf16", CONTENT_SRC, K10_FWD_REPLACES,
             bc["compat_launches"]["K10f-bf16"], "charadessta compat"),
            ("K10b", "content_unit_backward_bf16", CONTENT_SRC, K10_BWD_REPLACES,
             bc["compat_launches"]["K10b-bf16"], "charadessta compat")):
        r = bc["times"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": bc["errs"][key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
            "dtype": "bfloat16", **back_to_back(r), "config": config_name,
        })
    kernels[-3]["max_err_of_largest_weight_gradient"] = bc["errs"]["K7_rel"]
    kernels[-1]["max_err_of_largest_weight_gradient"] = bc["errs"]["K10_rel"]
    # The bf16 variants of K8 (phase 22: launches on the 3 dense bf16 steps,
    # times at Charades B=64 and ActivityNet B=64) and K9 (launches on the 3
    # bf16 steps under VML_SMIN_TRAIN_FUSED_FWD=1, times at Charades B=64).
    bd = bf16_dense
    for way, name, rep in (("fwd", "proposal_dense_forward_bf16", K8_FWD_REPLACES),
                           ("bwd", "proposal_dense_backward_bf16", K8_BWD_REPLACES)):
        r = bd["times"][("K8-bf16", "Charades")][way]
        ra = bd["times"][("K8-bf16", "ActivityNet")][way]
        kernels.append({
            "name": name, "route": "cuda", "source": PROPOSAL_SRC, "replaces": rep,
            "launches": bd["launches"][f"K8{way[0]}-bf16"],
            "max_abs_err": bd["errs"][f"K8-bf16 {way} Charades B=64"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "batch": TRAIN_BATCH,
            "dtype": "bfloat16", **back_to_back(r), "mode": "dense",
            **{f"{k}_activitynet_b64": ra[k] for k in
               ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                "bound_by")},
            "max_abs_err_activitynet_b64": bd["errs"][f"K8-bf16 {way} ActivityNet B=64"]})
    r = bd["times"]["K9-bf16"]
    kernels.append({
        "name": "smi_stack_forward_bf16", "route": "cuda", "source": TRAIN_SRC,
        "replaces": K9_REPLACES, "launches": bd["fused_launches"]["K9-bf16"],
        "max_abs_err": bd["errs"]["K9-bf16"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        "batch": TRAIN_BATCH, "dtype": "bfloat16", "device_ms": r["device_ms"],
        "mode": "fused_fwd", "per_layer_k2_ms": r["per_layer_k2_ms"],
        "per_layer_k2_device_ms": r["per_layer_k2_device_ms"]})
    kernels[1]["plain_repeatable"] = plain_repeats["K4"]
    kernels[0]["plain_repeatable"] = plain_repeats["K5"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"train_step": {
        "batch": TRAIN_BATCH, "ms": train_times["step_ms"],
        "samples_per_s": TRAIN_BATCH / train_times["step_ms"] * 1e3,
        "launches_per_step": {k: v // TRAIN_STEPS for k, v in train_launches.items() if v}}}))
    print(json.dumps({"activitynet_train_step": {
        "batch": TRAIN_BATCH, "ms": anet_times["step_ms"],
        "samples_per_s": TRAIN_BATCH / anet_times["step_ms"] * 1e3,
        "peak_memory_gib": anet_peak,
        "launches_per_step": {k: v // TRAIN_STEPS for k, v in anet_launches.items()},
        "eval_forward_max_abs_err": anet_eval_err,
        "k4_l64": dict(anet_times["K4"], max_abs_err=anet_errs["K4"]),
        "k5_nq20": dict(anet_times["K5"], max_abs_err=anet_errs["K5"])}}))
    print(json.dumps({"mode_train_steps": {
        mode: {"batch": TRAIN_BATCH, "ms": mode_times[f"{mode}_step_ms"],
               "samples_per_s": TRAIN_BATCH / mode_times[f"{mode}_step_ms"] * 1e3,
               "losses": modes[mode][4],
               "launches_per_step": {k: v // TRAIN_STEPS for k, v in modes[mode][3].items() if v}}
        for mode in ("dense", "compat")}}))
    print(json.dumps({"gemm": gemm_rows}))
    print(json.dumps({"gemm_bf16": gemm_bf16_rows}))
    print(json.dumps({"files_training": files}))
    print(json.dumps({"serving_pairs_per_s_device": {
        str(B): B / times[("e2e", B)] * 1e3 for B in (16, 512)}}))
    print(json.dumps({"async_serving": async_runs}))
    print(json.dumps({"bf16_serving": {
        "pairs_per_s_device": bf16["pairs_per_s"], "mfu": bf16["mfu"],
        "score_err_vs_fp32": bf16["score_err"], "launches": bf16["launches"]}}))
    t = bf16_train["times"]
    print(json.dumps({"bf16_training": {
        "batch": TRAIN_BATCH, "losses": bf16_train["losses"],
        "step_ms": t["step_ms"], "step_event_ms": t["step_event_ms"],
        "fp32_step_ms": t["fp32_step_ms"], "fp32_step_event_ms": t["fp32_step_event_ms"],
        "launches": {k: v for k, v in bf16_train["launches"].items() if v},
        "against_plain": bf16_train["step_err"], "eval_score_err": bf16_train["eval_err"],
        "tacos": {"losses": bf16_train["tacos_losses"],
                      "launches": {k: v for k, v in bf16_train["tacos_launches"].items() if v},
                      "against_plain": bf16_train["tacos_err"]},
        "files": bf16_train["files"],
        "parity": bf16_train["stats"], "gemm_bf16": bf16_train["gemm"]}}))
    t = bf16_content["times"]
    print(json.dumps({"bf16_content": {
        "batch": TRAIN_BATCH, "activitynet_losses": bf16_content["losses"],
        "activitynet_step_ms": t["step_ms"], "activitynet_fp32_step_ms": anet_times["step_ms"],
        "launches": {k: v for k, v in bf16_content["launches"].items() if v},
        "against_plain": bf16_content["step_err"], "eval_score_err": bf16_content["eval_err"],
        "compat": {"losses": bf16_content["compat_losses"],
                   "launches": {k: v for k, v in bf16_content["compat_launches"].items() if v},
                   "against_plain": bf16_content["compat_err"]},
        "fused_smi_false_serving": {k: {"score_err": e, "launches": n}
                                    for k, (e, n) in bf16_content["serve"].items()},
        "route_fork_ms": bf16_content["fork"], "parity": bf16_content["stats"]}}))
    print(json.dumps({"bf16_dense": {
        "batch": TRAIN_BATCH, "dense_losses": bd["losses"],
        "dense_launches": {k: v for k, v in bd["launches"].items() if v},
        "against_plain": bd["step_err"], "eval_score_err": bd["eval_err"],
        "serving_score_err_vs_fp32": bd["serve_err"],
        "dense_step_ms": bd["dense_ms"],
        "dense_samples_per_s": {k: TRAIN_BATCH / v * 1e3 for k, v in bd["dense_ms"].items()},
        "dense_busy_share": bd["busy"],
        "activitynet_dense_step": bd["anet_steps"],
        "fused_fwd": {"losses": bd["fused_losses"], "equal_to_per_layer": True,
                      "launches": {k: v for k, v in bd["fused_launches"].items() if v},
                      "against_plain": bd["fused_err"]},
        "k9_parity": bd["k9_stats"], "errs": bd["errs"]}}))
    print(json.dumps({"data_parallel": dp}))
    print(json.dumps({"seq_parallel": seq}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
