#!/usr/bin/env python3
"""
Drive the PyTorch port (packnet_sfm_tpu_torch) on one NVIDIA GPU and check
it, with nothing of JAX:

1. print the card (nvidia-smi name and power limit), the torch/CUDA
   versions, and build the CUDA kernels from the checkout's sources (one
   nvcc per source, all started together); fail unless the masked-conv
   library's SASS holds HMMA (tensor-core) instructions;
2. hold the masked-conv forward kernel against its plain PyTorch version at
   every shape the slice's 30 SAN convs take at 384x640 B1 (on the eval
   path's own LiDAR masks), at edge cases and at a 12x20 512 -> 1024 conv
   that splits K, in float32 (TF32 off, atol = rtol = 1e-4) and bfloat16
   (rtol 2e-2, atol 1e-2 x max|ref|: one bf16 rounding of the same fp32
   sum), and check that an empty mask gives exact zeros; then (a) the
   dgrad kernel against its plain version at every shape the training
   step's 27 dgrad launches take at B8 384x640 (on that batch's own LiDAR
   masks), at the edge cases and the split-K one, under the same rules,
   with exact zeros wherever no site within the halo is active and on an
   empty mask (each direction must have reached the tensor-core, split-K
   and CUDA-core paths), and (b) the whole autograd Function (forward
   kernel, dgrad kernel, dW/db) against plain autograd through the plain
   forward (F.conv2d's own backward), on dx, dW and db in float32 and in
   bfloat16;
   then the self-supervised slice's kernels (phase S below): the warp's
   out-only forward and its dgrid kernel at the slice's own grids, sources
   and cotangents (B8, grid 768x640, from real steps' depths and poses, bf16
   and float32 sources) and at edge cases (grids far outside the image,
   exact integer coordinates, the last row and column, 'border', Ho != H,
   odd W, one channel; g in the image dtype), the photometric forward and
   backward against their plain compositions (reflect pad, formula, reflect
   fold) at the step's own NHWC [8,192,640,3] inputs (row-slices of the
   warp's output, the strided cotangent, dy only where asked) and at edge
   cases (identical images, which must give exact zeros, constant images,
   strided row-slices with a stride-0 g, H = W = 2, widths 59 and 60 whose
   W-1 and W+1 a strip cut at multiples of 30 would separate, without dy),
   and both autograd Functions against plain autograd through the plain
   versions (dgrid; dx, dy through F.pad's gradient);
3. run the eval path: eval.main on configs/train_resnet_san_ncdb_640x384.yaml
   (ResNet18-SAN, FiLM at scale 0, bf16 convs) with flip-TTA, with the
   launch counts reset just before and read just after (30 forward
   launches per forward), the metrics finite, and the whole forward against
   the same forward through the plain version (float32 atol 1e-5, bfloat16
   atol 1e-2 on the sigmoid maps); then (c) the training path: train.main
   on the same YAML at its B8 384x640 bf16, the counts reset just before and
   read just after each run (30 forward and 27 dgrad launches per step), 4
   steps over two batches, then 10 steps on one batch with the last loss
   below the first, every loss finite and no step skipped by the guard; and
   one float32 step's loss and gradients through the kernels against the
   same step through the plain forward under plain autograd;
   then the self-supervised path (phase S): train.main on
   packnet_sfm_tpu_torch/configs/selfsup_kitti_192x640.yaml at B8 192x640,
   (i) as written (bf16 photometric maps; 10 steps on one batch, the last
   loss below the first) and (ii) with float32 maps through the fused
   kernels (3 steps), the counts reset just before and read just after
   each run: per step 2 warp forward and 2 dgrid launches (one each per
   context; no kernel writes the derivative maps A, B), under (ii) 10
   photometric forward (4 warped maps and the automask's map per context)
   and 8 backward launches (the automask maps need no gradient), and 30 /
   27 masked-conv launches; never an image cotangent through the warp; one
   (ii) step under torch.profiler runs no reflection_pad2d kernel;
   and one float32 step through every kernel against plain autograd
   through every plain version, with the reversed batch as the control;
   then the generic-camera path (phase G): the projection forward kernel
   against its plain version (rows, cols, m, s) and the backward kernels
   against the plain formula on the same residuals (twice: bit-equal), at
   the step's own planes (192x192 from configs/train_omnicam.yaml, 384x384
   from configs/train_omnicam_fullres.yaml), at two other windows (p = 7
   at 45x60, p = 23 at 50x53) and at edge shapes (41x41, 41x97, B2 45x60;
   rays near the pinhole template at the temperatures of progress 0 and
   1, and random rays at temperature 1), the Function
   against plain autograd; train.main on both YAMLs at B1 384x384 on one
   batch with something to learn (a smooth target, context frames that are
   the target shifted by 4 px; 10 steps of (i), the last loss below the
   first; 3 of (ii)), the counts reset just before and read just after
   each run: per step 2 projection forwards, 2 backward calls (one
   launch each, dray's and dd's tiles) and 2 warp forward and 2 dgrid
   launches, no masked-conv or
   photometric launch; and one float32 step of (i) at progress 0.5
   through every kernel against every plain version, held to the limits
   of the train step, with the plain
   step at a temperature moved by 3e-7 logged as the control (B1 has no
   reversed batch);
   then the lane-gather probes (phase Q): the probe's entry point
   (scripts/torch_bench_dynamic_gather.py `run`) with the counts reset
   just before and read just after (5 gather launches, the loop's 1 + 200
   launches a throughput shape, its semantics all right; its device times
   come from CUDA graphs of raw launches, which the counts do not see), and
   both kernels against their plain versions at its five semantic shapes,
   the two throughput shapes and the loop at S 8, 16, 32 and n 0, 1, 5, 16,
   512, bit-equal; beside their bounds, their practical floor: an empty
   kernel's time in a CUDA graph a launch, or the loop's dependent chain of
   n adds if longer;
   then the eval and inference CLIs (phase C): an NCDB-layout tree of 8
   frames at 384x640 written with the port's own writers (RGB, and 16-bit
   depth on LiDAR-like beam rows), the seeded bf16 model saved with
   save_checkpoint, eval.test on it with
   datasets.test.input_depth_type ['depth_original'] (B1, the counts reset
   just before and read just after: 30 masked-conv launches per frame,
   nothing else, 0 skipped batches), its metrics against `evaluate` on the
   same loader with the in-memory model (atol 1e-4), infer_and_save_depth
   on the frame folder (RGB only: no kernel launch) with each saved depth
   against the eval forward's on the same frame (rtol 1e-5), and the host
   decode time per frame, both CLIs' img/s and the device's busy share of
   the eval loop (its kernel time under torch.profiler over one more pass,
   against that pass's wall time);
   then training from disk (phase T): an NCDB-layout tree of 32 train and
   8 validation frames at 384x640 with a split JSON each, train.fit on the
   YAML at its B8 bf16 (2 epochs of 4 steps, a mid_epoch.ckpt every 2
   steps, one quick eval of the 8 validation frames an epoch, a logger),
   the counts reset just before and read just after each run: 30 forward
   and 27 dgrad masked-conv launches a train step, 30 forward launches a
   validation, quick-eval or logged-image frame (B1; the quick eval's
   RGB-only forward runs no masked conv), nothing else; every step
   applied (no loss skipped), the epoch losses finite, the top-k
   checkpoints and evaluation_results/epoch_{0,1}_results.json (6 x 7
   metrics) written, the stale mid_epoch.ckpt gone before the next epoch
   saves; the mid_epoch.ckpt of step 2 of epoch 1 resumed through
   train.fit: exactly 2 steps, its update (the parameters after them less
   the checkpoint's) against the uninterrupted run's per leaf at the
   train step's limits, and the same file without its Adam state resumed
   as the control, which must fail that check; then
   configs/overfit_synthetic.yaml through the same loop for 3 epochs
   (with its Synthetic frames' input depth and FiLM on, so that the SAN
   branch runs: 2 warp forward, 2 dgrid, 30 / 27 masked-conv launches a
   step), its loss falling, and one float32 step of that model on a
   batch of its loader (B2 64x96, the path's own shapes) through every
   kernel against every plain version, held to the train step's limits,
   with the reversed batch as the control; then the YAML's loader with
   the host jitter
   (3 epochs: epoch 1 timed, epoch 2 under torch.profiler for the
   device's busy share) and under tpu.device_augment (2 epochs), both
   without validation: img/s with data, data and step ms a step, the
   input-bound fraction; and the host's read-and-decode and train
   transform ms a sample on one thread, with and without the jitter;
   then the dual-head INT8 slice (phase D): an NCDB-layout tree of 16
   train and 4 validation frames at 384x640, train.fit on the dual-head
   YAML at its B8 bf16 under model.params.qat 'weights+outputs' (2 epochs
   of 2 steps, validated on the int8 weights, a checkpoint an epoch): 30
   forward masked-conv launches a step (the RGB+D pass, whose output no
   loss reads) and 0 dgrad, 30 a validation frame and 30 for the logged
   images' forward (a dual-head model logs none); its rate with data
   beside the same fit without QAT, the step alone under both on a batch
   held on the card, and the kernels the card runs a step under each
   (what QAT adds); one float32 step of that model under QAT on a batch of
   the loader through the kernels against the plain versions at the train
   step's limits (the reversed batch as the control), the SAN's
   MaskedBatchNorm statistics after it (where the kernel's output lands)
   and the loss heads' u8 codes (at most one step apart); the int8
   fake-quantized depth-net kernels on the card against the CPU's, bit
   for bit; eval.test --int8 --int8-weights on the fit's checkpoint over
   the validation frames with LiDAR (30 launches a frame) beside the
   float eval (the INT8 abs_rel cost), and in float32 through the kernels
   against the plain versions (atol 1e-4 over the metrics); infer.py on
   two frames, its depth (integer * max_depth + fractional) against the
   eval forward's; chiprun_out/chip_smoke_dual_head.json;
   then KITTI and the rest of the self-supervised family (phase K): a
   KITTI_raw drive of 36 frames at 375x1242 written with the port's
   write_kitti_tree (OXTS packets, groundtruth PNGs, velodyne .npz at ~5%
   fill below the horizon) and a seeded torchvision-layout resnet18 file
   in $PACKNET_WEIGHTS_DIR for the '18pt' encoders; K1,
   configs/train_kitti.yaml as written (DepthResNet + PoseResNet, B16
   192x640, bf16 convs and maps) through train.fit for 2 epochs of 2
   steps with validation: 2 warp forward and 2 dgrid launches a step, img/s
   with data, data and step ms, the step alone; 10 steps on one batch, the
   loss falling; the float32 maps through the fused kernels (2 steps: also
   10 photometric forward and 8 backward launches a step); one float32
   step through the warp and photometric kernels against every plain
   version at the train step's limits, and the kernels against their plain
   versions on that step's own inputs; K2,
   configs/train_resnet_san_kitti.yaml (B4 on the 352x1216 crop,
   sparse-silog, san_row_window -1 calibrated on the tree) with FiLM on
   (as written, use_film false builds no SAN branch: its LiDAR reaches no
   layer, in the JAX package too) through train.fit for one epoch of 2
   steps with its two validation datasets (with and without LiDAR): 30
   forward and 27 dgrad masked-conv launches a step, 30 a validation,
   quick-eval or logged-image frame with LiDAR; the masked-conv kernels
   against their plain versions at the step's own 30 shapes (the row
   window's masks; fp32 and bf16), each launch in a CUDA graph beside
   cuDNN's and its bound, by SAN level; the step alone; then
   configs/eval_resnet_san_kitti.yaml over K2's checkpoint (garg crop,
   scale_output top-center, the 352x1216 crop_eval_borders, the save
   pass: 30 launches a frame in each pass), and in float32 through the
   kernels against the plain versions (metrics within 1e-5); K3,
   train_kitti.yaml's SelfSupModel on seeded 384x640 batches carrying
   NCDB's A6 fisheye calibration (3 steps; at 384x640 every ray lands
   within a few pixels of the principal point, so the warp kernels are
   also held to their plain versions on the A6 grid of a 24x40 frame,
   all of whose points fall outside [-1, 1]) and
   VelSupModel on the Synthetic dataset's pose_context (1 step), each with
   2 warp forward and 2 dgrid launches a step and one float32 step through
   the kernels against the plain versions; chiprun_out/chip_smoke_kitti.json;
   then the Image and DGP datasets (phase I): a DGP tree written with the
   port's write_dgp_tree (2 scenes x 8 samples, camera_01 and camera_05 at
   DDAD's 1216x1936, 20,000 LiDAR points a sweep) and a seeded resnet18
   file for the '18pt' encoders; I1, configs/overfit_ddad.yaml as written
   but for the tree and repeat 1 (DepthResNet + PoseResNet, B4 384x640,
   float32 convs, bf16 maps, camera_01) through train.fit for 2 epochs of
   3 steps with validation on the LiDAR depth and a checkpoint: 2 warp
   forward and 2 dgrid launches a step, none in validation; eval.py
   --checkpoint on the test split (no launch); 10 steps on one batch, the
   loss falling; the float32 maps (2 steps: also 10 photometric forward and
   8 backward launches a step); one float32 step through the kernels
   against the plain versions at the train step's limits, the reversed
   batch as the control, and the kernels against their plain versions on
   that step's own inputs; I2, both cameras folded into B8 384x640 on the
   way to the card (every dgrid launch over 8 images; the launches a step
   stay 2 + 2, one a context over the whole batch), one epoch, the fp32
   step check at B8; the 'ram' sample cache under tpu.device_augment for 2
   epochs (the second replayed from memory) and RandAugment, random
   erasing and mixup for one, both without validation; I3, the omnicam
   YAMLs over 8 Image frames of 768x768 written with write_image_tree,
   one epoch each at B1 384x384: 2 projection forwards, 2 backward calls,
   2 warp forward and 2 dgrid launches a step, and the projection and
   warp kernels against their plain versions on a step of a batch from
   disk (192x192 and 384x384 planes); chiprun_out/chip_smoke_image_dgp.json;
   then the PackNet family (phase P): a KITTI_raw drive of 12 frames at
   375x1242 and DGP trees at DDAD's 1216x1936 written with the port's
   writers; P1, configs/train_packnet_san_kitti.yaml as written but for its
   data (PackNetSAN01 1A, B4 on the 352x1216 crop, bf16, velodyne in)
   through train.fit for 2 epochs of 2 steps with its two validation
   datasets: 30 forward and 27 dgrad masked-conv launches a step, 30 a
   validation, quick-eval or logged-image frame with LiDAR; the step alone
   on a batch the phase collates, its peak memory, img/s with data; the
   masked-conv kernels against their plain versions at the step's 30
   shapes (fp32 and bf16), each launch in a CUDA graph beside cuDNN's and
   its bound, by SAN level; configs/eval_packnet_san_kitti.yaml (dropout
   0.5, in eval) over the fit's checkpoint, its save pass included (30
   launches a LiDAR frame in each pass), and in float32 through the
   kernels against the plain versions (each metric within 1e-5 of max(1,
   its value)); one float32 step against the plain versions at the train
   step's limits; 10 steps on one batch, the loss falling; P1b,
   PackNetSlimSAN01 with FiLM on scales 0 and 1 and san_row_window 0.5 at
   B1: one float32 forward (12 launches, atol 1e-5) and step (12 forward
   and 9 dgrad) against the plain versions; P2, configs/train_ddad.yaml
   (PackNet01 1A + PoseNet, B2 384x640 bf16, camera_01, repeat 5 -> 1)
   through train.fit for 2 epochs of 2 steps: 2 warp forward and 2 dgrid
   launches a step, the step alone, peak memory, img/s with data; 2 steps
   under the float32 maps (also 10 photometric forward and 8 backward a
   step), one float32 step against the plain versions (PoseNet's conv1
   bias, zero analytically behind a one-channel-a-group GroupNorm, held
   apart as rounding), the kernels against theirs on its inputs, and 10
   steps on one batch, the loss falling; P3,
   configs/train_packnet_san_ddad.yaml (dropout 0.5) with validate_first
   over a four-camera tree: its 4 single-camera train entries and 8
   validation entries, finite losses, 30 launches a validation frame with
   LiDAR and none in training, the validation run twice bit for bit;
   chiprun_out/chip_smoke_packnet.json;
4. (d) time eval img/s at B1 and the train step and img/s at B8, the
   forward kernel at the eval shapes and both kernels at the train shapes
   beside their plain versions, the library yardstick (one cuDNN call the
   port never makes: F.conv2d, torch.nn.grad.conv2d_input) and the bound
   for the work the data needs, each kernel and library call both in a
   loop of calls (CUDA events, the host's issue included) and replayed in
   a CUDA graph (without it), one line per conv shape and per SAN level,
   and the dW time per step (san_conv.filter_grad); the
   self-supervised step's ms and img/s under (i) and (ii) and the peak
   device memory of one step of (i); the warp and photometric kernels
   over one step's launches, in a loop and in a CUDA graph, beside their
   plain versions, their bounds and PyTorch's call for the same function
   (F.grid_sample for the forward, aten.grid_sampler_2d_backward for
   dgrid); the warp's yardstick for the whole function, F.grid_sample with
   its grid gradient against the two kernels, both in a graph, beside the
   function's bound (image, grid and g read once, out and dgrid written
   once); the generic step's ms under (i) and
   (ii) and the projection kernels over one step's calls, in a loop and in
   a graph, the backward's dd and dray tiles apart in a graph, beside
   their plain versions and their bounds (bytes, fp32 operations or exps
   at the SFU rate, whichever is larger; no library call computes this
   function);
5. (e) print the kernels line with all ten kernels (the warp's forward
   and dgrid apart), then the card, then the device line last.

Run with no arguments: `python3 chip_smoke.py`. Exits nonzero without a
card. Extra output goes to chiprun_out/chip_smoke_convs.json,
chiprun_out/chip_smoke_selfsup.json, chiprun_out/chip_smoke_generic.json,
chiprun_out/chip_smoke_gather.json, chiprun_out/chip_smoke_cli.json,
chiprun_out/chip_smoke_train_disk.json,
chiprun_out/chip_smoke_dual_head.json, chiprun_out/chip_smoke_kitti.json
chiprun_out/chip_smoke_image_dgp.json and chiprun_out/chip_smoke_packnet.json.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
H100_FLOPS = {'float32': 67e12,       # CUDA cores, no tensor cores
              'bfloat16': 989e12}     # dense tensor cores
# exp2 (the core of expf) on the special-function units: 16 results per SM
# per clock at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), 132 SMs at the 1.98 GHz boost clock
H100_SFU_PER_S = 132 * 16 * 1.98e9
CONFIG = 'configs/train_resnet_san_ncdb_640x384.yaml'
N_EVAL_BATCHES = 3
CONVS_PER_FORWARD = 30
DGRADS_PER_STEP = 27                  # the 3 Cin=1 convs read the LiDAR
TRAIN_RUNS = ((4, 2), (10, 1))        # (steps, batches) of the two runs
# one float32 step through the kernels vs through the plain versions:
# loss rtol; per gradient leaf max|g - g_plain| / max|g_plain| and the same
# in the Frobenius norm (leaves whose plain gradient is below 1e-6 x the
# largest leaf's are zero analytically, the conv biases that feed a BN, and
# are held to that floor). Float32 sums in another order flip ReLU and
# max-pool decisions near ties, which moves single gradient entries.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-1
TRAIN_GRAD_NORM = 2e-2
# a gradient that is zero analytically (`gn_cancelled_biases`): float32
# rounding of a sum over the batch's pixels, within this share of the
# largest gradient in each run
CANCELLED_NOISE = 1e-5
SELFSUP_CONFIG = 'packnet_sfm_tpu_torch/configs/selfsup_kitti_192x640.yaml'
FP32_MAPS = ['tpu.photometric_dtype', 'float32', 'tpu.use_pallas', True]
WARPS_PER_STEP = 2                     # one per context frame
PHOTO_FWD_PER_STEP = 10                # (4 scales + automask) x 2 contexts
PHOTO_BWD_PER_STEP = 8                 # the automask maps need no gradient
SELFSUP_RUNS = (('i', None, 10), ('ii', FP32_MAPS, 3))
GENERIC_CONFIGS = {'i': 'configs/train_omnicam.yaml',
                   'ii': 'configs/train_omnicam_fullres.yaml'}
# RaySurfaceResNet '18pt' wants ImageNet weights, which the repository does
# not hold: the generic runs start from seeded random weights, and say so
RANDOM_INIT = ['model.depth_net.allow_random_init', True]
GENERIC_RUNS = (('i', 10), ('ii', 3))
PADDING_MODES = {'zeros': 0, 'border': 1}   # aten.grid_sampler_2d's codes
PROJ_PER_STEP = 2                      # one projection per context frame
GATHER_ITERS = 200                     # timed launches of each probe shape
CLI_FRAMES = 8                         # frames of the phase C tree
TRAIN_FRAMES, VAL_FRAMES = 32, 8       # frames of the phase T tree
DISK_EPOCHS = 2                        # epochs of the phase T run
OVERFIT_CONFIG = 'configs/overfit_synthetic.yaml'
OVERFIT_EPOCHS = 3
DUAL_CONFIG = 'configs/train_resnet_san_ncdb_dual_head_640x384.yaml'
DUAL_TRAIN_FRAMES, DUAL_VAL_FRAMES = 16, 4   # frames of the phase D tree
DUAL_EPOCHS = 2                        # epochs of the phase D runs
# the SAN's MaskedBatchNorm statistics after one float32 QAT step, kernels
# against plain versions: max|err| / max|value| per leaf. They are means
# and variances of the masked convs' outputs, which the kernels give
# within atol = rtol = 1e-4 of the plain version
DUAL_STATS_REL = 1e-3
KITTI_CONFIG = 'configs/train_kitti.yaml'
SAN_KITTI_CONFIG = 'configs/train_resnet_san_kitti.yaml'
SAN_KITTI_EVAL = 'configs/eval_resnet_san_kitti.yaml'
KITTI_RAW = (375, 1242)                # KITTI raw's image size
KITTI_FRAMES = 36                      # one drive of the phase K tree
KITTI_VAL = (1, 2, 3, 4)               # its validation and test frames
SAN_KITTI_TRAIN = range(10, 20)        # K2's frames, all with both contexts
K1_EPOCHS = 2                          # of 2 steps (34 samples, B16)
K3_SHAPE, K3_BATCH = (384, 640), 4     # the fisheye step: NCDB's A6 frames
DDAD_CONFIG = 'configs/overfit_ddad.yaml'
DDAD_NATIVE = (1216, 1936)             # DDAD's image size
DDAD_CAMERAS = ('camera_01', 'camera_05')
DDAD_SCENES, DDAD_SAMPLES = 2, 8       # the phase I tree
DDAD_POINTS = 20000                    # LiDAR points a sweep
DDAD_EPOCHS = 2                        # of 3 steps (12 samples, B4)
OMNICAM_NATIVE = (768, 768)            # the phase I Image folder's frames
OMNICAM_FRAMES = 8
PACKNET_SAN_KITTI = 'configs/train_packnet_san_kitti.yaml'
PACKNET_SAN_EVAL = 'configs/eval_packnet_san_kitti.yaml'
PACKNET_DDAD = 'configs/train_ddad.yaml'
PACKNET_SAN_DDAD = 'configs/train_packnet_san_ddad.yaml'
# the phase P KITTI drive's splits: train frames with both contexts (two
# steps of B4), validation frames
P1_TRAIN, P1_VAL = range(1, 9), (9, 10)
P_EPOCHS = 2                           # P1 and P2: 2 epochs of 2 steps
# the phase P DGP trees: P2's camera_01 over 2 scenes x 4 samples (2 with
# both contexts a scene: 2 steps of B2); P3's four cameras over 1 scene x 3
# samples (1 train sample a camera, 3 validation frames an entry)
P2_SCENES, P2_SAMPLES = 2, 4
P_CAMERAS = ('camera_01', 'camera_05', 'camera_06', 'camera_09')
P3_SCENES, P3_SAMPLES = 1, 3
# P1b: the FiLM fusion (2 sparse stages of 6 convs; the 3 of stage 0 that
# read the LiDAR take no input gradient) under the row-window crop
P1B = ['model.depth_net.name', 'PackNetSlimSAN01',
       'model.depth_net.use_film', True, 'model.depth_net.film_scales',
       [0, 1], 'model.depth_net.san_row_window', 0.5,
       'datasets.train.batch_size', 1]
P1B_FWD, P1B_DGRAD = 12, 9
# fp32 adds: one instruction a lane a clock, 128 lanes an SM, 132 SMs at
# 1.98 GHz (the 67 TFLOP/s peak counts an FMA as two)
H100_FP32_ADDS_PER_S = 132 * 128 * 1.98e9


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError('{}: {} of {} values differ, max |err| {:.3e}'
                             .format(name, int(bad.sum()), bad.numel(),
                                     float(err.max())))
    return float(err.max()) if err.numel() else 0.0


def check_kernel(name, got, want, dtype):
    """The comparison rule of both kernels: fp32 atol = rtol = 1e-4; bf16
    one rounding of the same fp32 sum (rtol 2e-2, atol 1e-2 x max|ref|)."""
    import torch
    if dtype == torch.float32:
        return check_close(name, got, want, 1e-4, 1e-4)
    return check_close(name, got, want,
                       1e-2 * float(want.float().abs().max()), 2e-2)


@contextlib.contextmanager
def plain_versions():
    """Run every kernel's op as its plain version under plain autograd: the
    masked conv as F.conv2d with its own backward, the warp as the gather
    version (dgrid by autograd through floor, the taps and the bilinear
    weights), the photometric map as the plain forward (its gradient by
    autograd through the box sums), the generic projection as the plain
    online softmax (its gradient by autograd through the recurrence). No
    kernel and no autograd Function, so
    every gradient comes from other code than the port's (the callers look
    the ops up at call time)."""
    from packnet_sfm_tpu_torch.ops.kernels import (
        generic_projection, photometric, san_conv, warp)
    swaps = ((san_conv, 'masked_conv2d_fn', san_conv.masked_conv2d_reference),
             (warp, 'grid_sample_fn', warp.grid_sample_reference),
             (photometric, 'photometric_map_fn',
              photometric.photometric_map_reference),
             (generic_projection, 'expected_patch_coords_fn',
              generic_projection.expected_patch_coords_reference))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def recording(module, name, store):
    """Append the arguments of every call of module.<name> (a kernel's
    launch function) to `store`, tensors detached."""
    saved = getattr(module, name)

    def wrapped(*args):
        store.append(tuple(a.detach() if hasattr(a, 'detach') else a
                           for a in args))
        return saved(*args)

    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, saved)


def path_convs(model, batch, train=False):
    """Each masked conv of one forward: (module, the mask it sees, whether
    its input needs a gradient), in the order the forward runs them,
    recorded by forward hooks."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[1],
                                            args[0].requires_grad)))
        for m in model.modules() if isinstance(m, _MaskedConv)]
    try:
        with torch.set_grad_enabled(train):
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return seen


def conv_inputs(mod, mask, dtype, gen):
    """x (unit normal at active sites), the module's kernel, a random bias."""
    import torch
    B, H, W, _ = mask.shape
    k, _, cin, cout = mod.kernel.shape
    x = torch.randn(B, H, W, cin, device=mask.device, generator=gen) * mask
    bias = torch.randn(cout, device=mask.device, generator=gen) * 0.1
    return (x.to(dtype).contiguous(), mask, mod.kernel.detach().to(dtype),
            bias.to(dtype))


def dgrad_inputs(mod, mask, dtype, gen):
    """gm = unit normal times the mask, the module's kernel."""
    import torch
    B, H, W, _ = mask.shape
    cout = mod.kernel.shape[3]
    gm = torch.randn(B, H, W, cout, device=mask.device, generator=gen) * mask
    return gm.to(dtype).contiguous(), mask, mod.kernel.detach().to(dtype)


def halo_empty(mask, k):
    """[B,H,W,1] True where no site within k//2 is active."""
    import torch.nn.functional as F
    near = F.max_pool2d(mask.permute(0, 3, 1, 2), k, 1, k // 2)
    return near.permute(0, 2, 3, 1) == 0


def edge_modules(dev, gen):
    """Edge cases: H, W not multiples of the 8x16 tile, B=2, Cin=1, narrow
    channels (16, 24), k=3/5; masks empty above a third of the height."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    cases = []
    for k, cin, cout, B, H, W in [(3, 16, 64, 2, 13, 21), (5, 1, 64, 1, 9, 20),
                                  (5, 24, 96, 2, 17, 33), (3, 1, 1, 1, 5, 3),
                                  (3, 24, 16, 2, 19, 35)]:
        mod = _MaskedConv(cin, cout, k).to(dev)
        with torch.no_grad():
            mod.kernel.normal_(0.0, 0.1, generator=gen)
        mask = (torch.rand(B, H, W, 1, device=dev, generator=gen) < 0.3).float()
        mask[:, :H // 3] = 0.0
        cases.append((mod, mask))
    return cases


def site_stats(mask, k):
    """Active sites, active-row count (rows a kernel must read), the share
    of 8x16 tiles with an active site, for the bound and the tables."""
    import torch.nn.functional as F
    B, H, W, _ = mask.shape
    m = mask[..., 0]
    active = int((m > 0).sum())
    tiles = (F.max_pool2d(F.pad(m[:, None], (0, -W % 16, 0, -H % 8)),
                          (8, 16), (8, 16)) > 0).float().mean()
    row_active = (m > 0).any(dim=2).float()[:, None]
    halo_rows = int((F.max_pool1d(row_active, k, 1, k // 2) > 0).sum())
    return active, int(row_active.sum()), halo_rows, float(tiles)


def compare_grads(got, want):
    """(max over leaves of max|err| / max|want|, the leaf where it is, max
    over leaves of |err| / |want| in the Frobenius norm, max|err| of the
    leaves that are zero analytically over the largest gradient). A leaf
    whose gradient is below 1e-6 x the largest leaf's counts as zero."""
    gmax = max(float(g.abs().max()) for g in want.values())
    rel, worst, norm, zero = 0.0, '', 0.0, 0.0
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((got[n] - w).abs().max())
        if scale > 1e-6 * gmax:
            norm = max(norm, float((got[n] - w).norm() / w.norm()))
            if err / scale > rel:
                rel, worst = err / scale, n
        else:
            zero = max(zero, err / gmax)
    return rel, worst, norm, zero


def step_gradients(model, runs):
    """(loss, gradients by leaf) of one step of `model` for each of `runs`
    ((plain, batch) each: through every plain version under plain autograd
    when plain, else through the kernels; a leaf the loss does not reach
    gets zeros)."""
    import torch
    res = []
    for plain, b in runs:
        model.zero_grad(set_to_none=True)
        with plain_versions() if plain else contextlib.nullcontext():
            out = model(b)
            out['loss'].backward()
        res.append((float(out['loss'].detach()),
                    {n: p.grad.detach().clone() if p.grad is not None
                     else torch.zeros_like(p)
                     for n, p in model.named_parameters()}))
        del out
    torch.cuda.synchronize()
    return res


def hmma_count(lib_path):
    """The HMMA (tensor-core) instructions in a built library's SASS, by
    the toolkit's cuobjdump; raises when there are none."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    n = sum(' HMMA' in line for line in sass.splitlines())
    if n == 0:
        raise AssertionError('{}: no HMMA instruction in its SASS'.format(
            lib_path))
    return n


def split_modules(dev, gen):
    """A 12x20 B1 conv of the last SAN level, 512 -> 1024 channels: its
    forward (K = 512) and its dgrad (K = 1024, N = 512) both split K."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    mod = _MaskedConv(512, 1024, 3).to(dev)
    with torch.no_grad():
        mod.kernel.normal_(0.0, 0.02, generator=gen)
    mask = (torch.rand(1, 12, 20, 1, device=dev, generator=gen) < 0.5).float()
    mask[:, :3] = 0.0
    return [(mod, mask)]


def launch_path(data, kernel, dgrad):
    """The wrapper's path for one launch: tensor-core, split-K or
    cuda-core."""
    from packnet_sfm_tpu_torch.ops.kernels import san_conv
    B, H, W, kc = data.shape
    nc = kernel.shape[2] if dgrad else kernel.shape[3]
    return san_conv.plan(B, H, W, kc, nc, kernel.shape[0], data.dtype,
                         san_conv._n_sm(data.device))[0]


# the timings each conv row sums: loop times by CUDA events (host issue
# included, as the path pays it), and times in a CUDA graph (without it)
TIME_KEYS = ('ms', 'graph_ms', 'plain_ms', 'library_ms',
             'library_graph_ms', 'bound_ms', 'bytes_ms', 'ops_ms')
LEVEL_KEYS = ('ms', 'graph_ms', 'library_ms', 'library_graph_ms',
              'bound_ms')


def graph_time_ms(fn, iters=10, reps=5):
    """The time of one call of fn with the host's issue taken out: `iters`
    calls captured in a CUDA graph, the graph replayed `reps` times between
    two CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def level_lines(rows, what):
    """One line per conv shape of each SAN level (H x W, k, Cin -> Cout,
    path; summed over the launches of that shape) and one per level."""
    levels = {}
    for r in rows:
        lvl = levels.setdefault((r['H'], r['W']), {})
        key = (r['k'], r['cin'], r['cout'], r['path'])
        agg = lvl.setdefault(key, dict.fromkeys(LEVEL_KEYS, 0.0))
        agg['n'] = agg.get('n', 0) + 1
        for f in LEVEL_KEYS:
            agg[f] += r[f]
    out = []
    for (h, w), lvl in levels.items():
        tot = {f: sum(a[f] for a in lvl.values()) for f in LEVEL_KEYS}
        for (k, cin, cout, path), a in lvl.items():
            log('  {} {}x{} k{} {:4d} -> {:4d} x{} {}: kernel {:.4f} ms '
                '(graph {:.4f}) cuDNN {:.4f} (graph {:.4f}) bound {:.4f}'
                .format(what, h, w, k, cin, cout, a['n'], path, a['ms'],
                        a['graph_ms'], a['library_ms'],
                        a['library_graph_ms'], a['bound_ms']))
        log('  {} level {}x{}: kernel {:.4f} ms (graph {:.4f}) cuDNN {:.4f} '
            '(graph {:.4f}) bound {:.4f}; in a graph {:.2f}x cuDNN'.format(
                what, h, w, tot['ms'], tot['graph_ms'], tot['library_ms'],
                tot['library_graph_ms'], tot['bound_ms'],
                tot['graph_ms'] / tot['library_graph_ms']))
        out.append({'level': '{}x{}'.format(h, w), **tot})
    return out


def bound(nbytes, flops, dname):
    b_ms = nbytes / H100_BYTES_PER_S * 1e3
    o_ms = flops / H100_FLOPS[dname] * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


def projection_bound(ray_p, p, planes, flops):
    """The generic projection's bound at ray_p [B,3,H,W] and window p:
    `planes` [B,H,W] fp32 planes moved once, `flops` fp32 operations a
    candidate (pixel, window position) at 67 TFLOP/s, one exp a candidate
    at the SFU rate; (bound ms, bytes ms, operations ms, what sets it)."""
    B, _, H, W = ray_p.shape
    n_cand = B * H * W * (2 * p + 1) ** 2
    b_all, b_ms, o_ms = bound(planes * B * H * W * 4, flops * n_cand,
                              'float32')
    e_ms = n_cand / H100_SFU_PER_S * 1e3
    parts = {'bytes': b_ms, 'fp32 operations': o_ms, 'exps': e_ms}
    return max(b_all, e_ms), b_ms, max(o_ms, e_ms), max(parts, key=parts.get)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.ops.kernels import (
        build, generic_projection, lane_gather, photometric, san_conv, warp)
    from packnet_sfm_tpu_torch.parallel.train_step import (
        make_eval_step, make_eval_metrics_step)

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log('card:', card)
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    t0 = time.time()
    built = build.build_all(['san_conv', 'warp', 'photometric',
                             'generic_projection', 'lane_gather'])
    log('kernel build (5 sources in parallel): {:.1f} s'.format(
        time.time() - t0))
    for name, (lib_path, ptxas) in built.items():
        log('  {} -> {}'.format(name, os.path.relpath(lib_path)))
        for line in ptxas.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log('  ptxas:', line.strip())
    log('san_conv SASS: {} HMMA instructions'.format(
        hmma_count(built['san_conv'][0])))
    # the comparisons below are against float32 math: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = {'fwd': 0, 'dgrad': 0}
    counters = {'san_fwd': san_conv.masked_conv2d,
                'san_dgrad': san_conv.masked_conv2d_dgrad,
                'warp_out': warp.warp_bilinear_out,
                'warp_dgrid': warp.warp_bilinear_dgrid,
                'photo_fwd': photometric.photometric_fwd,
                'photo_bwd': photometric.photometric_bwd,
                'proj_fwd': generic_projection.generic_projection_fwd,
                'proj_bwd': generic_projection.generic_projection_bwd,
                'gather': lane_gather.lane_gather,
                'gather_loop': lane_gather.lane_gather_loop}

    # the split-K reductions, counted apart from the conv launches and
    # summed over every path run
    reducers = {'san_fwd': san_conv.masked_conv2d,
                'san_dgrad': san_conv.masked_conv2d_dgrad}
    reduce_totals = dict.fromkeys(reducers, 0)

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in reducers.values():
            fn.reduce_launches = 0

    def read_counts():
        torch.cuda.synchronize()
        for k, fn in reducers.items():
            reduce_totals[k] += fn.reduce_launches
        return {k: fn.launches for k, fn in counters.items()}

    config, model = port_eval.build(CONFIG, 'cuda', seed=0)
    dtype = model.depth_net.encoder.Conv_0.dtype
    dname = str(dtype).replace('torch.', '')
    shape = port_eval.image_shape(config)
    batch = port_eval.make_batches(shape, 1, 1, seed=0, device='cuda')[0]
    convs = [(mod, mask) for mod, mask, _ in path_convs(model, batch)]
    if len(convs) != CONVS_PER_FORWARD:
        raise AssertionError('{} masked convs per forward, expected {}'
                             .format(len(convs), CONVS_PER_FORWARD))
    train_bs = int(config.datasets.train.batch_size)
    _, tmodel = port_train.build(CONFIG, 'cuda', seed=0)
    tbatch = port_eval.make_batches(shape, train_bs, 1, seed=0,
                                    device='cuda')[0]
    tconvs = path_convs(tmodel, tbatch, train=True)
    dconvs = [(mod, mask) for mod, mask, needs in tconvs if needs]
    del tmodel
    if len(tconvs) != CONVS_PER_FORWARD or len(dconvs) != DGRADS_PER_STEP:
        raise AssertionError('train forward: {} masked convs, {} with an '
                             'input gradient; expected {} and {}'.format(
                                 len(tconvs), len(dconvs), CONVS_PER_FORWARD,
                                 DGRADS_PER_STEP))

    # ---------------------------------------------------------------- 2
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    cases = convs + edge_modules(dev, gen) + split_modules(dev, gen)
    fwd_paths = {}
    for i, (mod, mask) in enumerate(cases):
        for dt in (torch.float32, torch.bfloat16):
            args = conv_inputs(mod, mask, dt, gen)
            path = launch_path(args[0], args[2], False)
            fwd_paths[path] = fwd_paths.get(path, 0) + 1
            got = san_conv.masked_conv2d(*args)
            torch.cuda.synchronize()
            want = san_conv.masked_conv2d_reference(*args)
            name = 'conv {} {} {}'.format(i, tuple(args[0].shape[1:]),
                                          tuple(args[2].shape))
            key = str(dt).replace('torch.', '')
            max_err[key] = max(max_err[key], check_kernel(name, got, want, dt))
            if bool((got[(mask[..., 0] == 0)] != 0).any()):
                raise AssertionError(name + ': nonzero output at an '
                                     'inactive site')
        empty = conv_inputs(mod, torch.zeros_like(mask), torch.float32, gen)
        out = san_conv.masked_conv2d(*empty)
        torch.cuda.synchronize()
        if bool((out != 0).any()):
            raise AssertionError('empty mask: nonzero output')
    log('forward kernel vs plain: {} cases x fp32/bf16 ok, max |err| fp32 '
        '{:.3e} bf16 {:.3e}; launches by path {}'.format(
            len(cases), max_err['float32'], max_err['bfloat16'], fwd_paths))

    # (a) the dgrad kernel at the train step's shapes and the edge cases
    dmax_err = {'float32': 0.0, 'bfloat16': 0.0}
    dcases = dconvs + edge_modules(dev, gen) + split_modules(dev, gen)
    dg_paths = {}
    for i, (mod, mask) in enumerate(dcases):
        k = mod.kernel.shape[0]
        far = halo_empty(mask, k)
        for dt in (torch.float32, torch.bfloat16):
            gm, mk, kern = dgrad_inputs(mod, mask, dt, gen)
            path = launch_path(gm, kern, True)
            dg_paths[path] = dg_paths.get(path, 0) + 1
            got = san_conv.masked_conv2d_dgrad(gm, mk, kern)
            torch.cuda.synchronize()
            want = san_conv.masked_conv2d_dgrad_reference(gm, mk, kern)
            name = 'dgrad {} {} {}'.format(i, tuple(gm.shape),
                                           tuple(kern.shape))
            key = str(dt).replace('torch.', '')
            dmax_err[key] = max(dmax_err[key],
                                check_kernel(name, got, want, dt))
            if bool((got[far.expand_as(got)] != 0).any()):
                raise AssertionError(name + ': nonzero dx where no site '
                                     'within the halo is active')
        gm, mk, kern = dgrad_inputs(mod, torch.zeros_like(mask),
                                    torch.float32, gen)
        out = san_conv.masked_conv2d_dgrad(gm, mk, kern)
        torch.cuda.synchronize()
        if bool((out != 0).any()):
            raise AssertionError('dgrad, empty mask: nonzero dx')
    log('dgrad kernel vs plain: {} cases x fp32/bf16 ok, max |err| fp32 '
        '{:.3e} bf16 {:.3e}; launches by path {}'.format(
            len(dcases), dmax_err['float32'], dmax_err['bfloat16'], dg_paths))
    for what, paths in (('forward', fwd_paths), ('dgrad', dg_paths)):
        if set(paths) != {'tensor-core', 'split-K', 'cuda-core'}:
            raise AssertionError('the {} checks reached the paths {}, not '
                                 'all three'.format(what, sorted(paths)))

    # (b) the autograd Function (forward kernel, dgrad kernel, dW / db)
    # against plain autograd through the plain forward (fp32 math, one cast
    # at the end): float32 atol 1e-4 x max|ref|, rtol 1e-4; bfloat16 the
    # kernels' rule (rtol 2e-2, atol 1e-2 x max|ref|)
    fn_err = {}                 # 'dtype grad' -> max |err| / max|ref|
    for mod, mask in [dconvs[3], dconvs[14], dconvs[-1]] + edge_modules(
            dev, gen)[:1]:
        for dt in (torch.float32, torch.bfloat16):
            x, mk, kern, bias = conv_inputs(mod, mask, dt, gen)
            g = torch.randn(mask.shape[:3] + (kern.shape[3],), device=dev,
                            generator=gen).to(dt)
            grads = []
            for fn in (san_conv.masked_conv2d_fn,
                       san_conv.masked_conv2d_reference):
                leaves = [t.clone().requires_grad_(True)
                          for t in (x, kern, bias)]
                fn(leaves[0], mk, leaves[1], leaves[2]).backward(g)
                grads.append([t.grad for t in leaves])
            for nm, a, b in zip(('dx', 'dW', 'db'), *grads):
                key = '{} {}'.format(str(dt).replace('torch.', ''), nm)
                name = 'Function {} {}'.format(key, tuple(kern.shape))
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError('{}: {} {} against {} {}'.format(
                        name, a.dtype, tuple(a.shape), b.dtype,
                        tuple(b.shape)))
                if dt == torch.float32:
                    err = check_close(name, a, b, 1e-4 * float(
                        b.abs().max()), 1e-4)
                else:
                    err = check_kernel(name, a, b, dt)
                fn_err[key] = max(fn_err.get(key, 0.0),
                                  err / max(float(b.abs().max()), 1e-30))
    torch.cuda.synchronize()
    log('autograd Function vs plain autograd, max |err| / max|ref|: ' +
        ', '.join('{} {:.3e}'.format(k, v) for k, v in fn_err.items()))

    # ---------------------------------------------------------------- 3
    reset_counts()
    flat = port_eval.main(CONFIG, device='cuda', batch_size=1,
                          n_batches=N_EVAL_BATCHES, seed=0,
                          overrides=['model.params.flip_tta', True])
    got = read_counts()
    eval_launches = got['san_fwd']
    want = dict.fromkeys(counters, 0)
    want['san_fwd'] = 2 * CONVS_PER_FORWARD * N_EVAL_BATCHES
    if got != want:
        raise AssertionError('eval path launched the kernels {} times, '
                             'expected {}'.format(got, want))
    if len(flat) != 6 * 7 + 1 or not all(np.isfinite(v)
                                         for v in flat.values()):
        raise AssertionError('metrics not finite: {}'.format(flat))
    log('eval.main: {} batches flip-TTA, {} kernel launches, depth-abs_rel '
        '{:.4f}'.format(N_EVAL_BATCHES, eval_launches, flat['depth-abs_rel']))

    fwd_err = {}
    for dt_name, overrides in (('float32', ['tpu.compute_dtype', 'float32']),
                               (dname, None)):
        _, m = port_eval.build(CONFIG, 'cuda', seed=0, overrides=overrides)
        with torch.no_grad():
            got = m(batch)['inv_depths'][0]
            with plain_versions():
                want = m(batch)['inv_depths'][0]
        torch.cuda.synchronize()
        atol = 1e-5 if dt_name == 'float32' else 1e-2
        fwd_err[dt_name] = check_close('forward ' + dt_name, got, want,
                                       atol, 0.0)
        if not bool(torch.isfinite(got).all()) or got.shape != (1,) + tuple(
                shape) + (1,):
            raise AssertionError('forward output {} not finite or of the '
                                 'wrong shape'.format(tuple(got.shape)))
        del m
    log('forward kernel vs plain: max |err| on sigmoids {}'.format(
        {k: float('{:.3e}'.format(v)) for k, v in fwd_err.items()}))

    # (c) the training path
    train_runs = []
    for n_steps, n_batches in TRAIN_RUNS:
        reset_counts()
        t0 = time.time()
        run = port_train.main(CONFIG, device='cuda', n_steps=n_steps,
                              n_batches=n_batches, seed=0)
        got = read_counts()
        wall = time.time() - t0
        losses = run['losses']
        want = dict.fromkeys(counters, 0)
        want.update(san_fwd=CONVS_PER_FORWARD * n_steps,
                    san_dgrad=DGRADS_PER_STEP * n_steps)
        if got != want:
            raise AssertionError('train path ({} steps) launched the kernels '
                                 '{} times, expected {}'.format(
                                     n_steps, got, want))
        launches = (got['san_fwd'], got['san_dgrad'])
        if not all(np.isfinite(losses)) or \
                run['trainer'].optimizer.count != n_steps:
            raise AssertionError('train path: non-finite loss or a step '
                                 'skipped: {}'.format(losses))
        if run['batches'][0]['rgb'].shape != (train_bs,) + tuple(shape) + (3,):
            raise AssertionError('train batch of the wrong shape')
        counts['fwd'] += launches[0]
        counts['dgrad'] += launches[1]
        train_runs.append({'steps': n_steps, 'batches': n_batches,
                           'losses': losses, 'wall_s': wall})
        log('train.main B{} {}x{} {}: {} steps over {} batch(es), launches '
            '{} forward / {} dgrad, losses {}'.format(
                train_bs, shape[0], shape[1], dname, n_steps, n_batches,
                launches[0], launches[1], ['{:.4f}'.format(v) for v in losses]))
    fixed = train_runs[-1]['losses']
    if not fixed[-1] < fixed[0]:
        raise AssertionError('loss did not fall over {} steps on one batch: '
                             '{}'.format(len(fixed), fixed))
    trainer, run_batch = run['trainer'], run['batches'][0]
    del run

    # one float32 step through the kernels, through the plain forward under
    # plain autograd, and (the control) plain again on the batch's images
    # in reverse order: the loss is the same function, only sums change order
    _, fmodel = port_train.build(CONFIG, 'cuda', seed=0,
                                 overrides=['tpu.compute_dtype', 'float32'])
    (loss_k, gk), (loss_p, gp), (_, gr) = step_gradients(
        fmodel, ((False, tbatch), (True, tbatch),
                 (True, {k: v.flip(0) for k, v in tbatch.items()})))
    del fmodel
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_check = compare_grads(gk, gp)
    order_check = compare_grads(gr, gp)
    log('train step fp32 B{}, kernels vs plain: loss {:.6f} vs {:.6f} (rel '
        '{:.2e}); per gradient leaf max|err|/max|g| {:.3e} (at {}), '
        '|err|/|g| {:.3e}; zero leaves {:.2e} of the largest gradient. '
        'Plain vs plain on the reversed batch: {:.3e} (at {}), {:.3e}, '
        '{:.2e}'.format(train_bs, loss_k, loss_p, loss_rel, *grad_check,
                        *order_check))
    rel, _, norm, zero_leaf = grad_check
    if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
            norm > TRAIN_GRAD_NORM or zero_leaf > 1e-6:
        raise AssertionError('train step through the kernels disagrees with '
                             'the plain versions')

    # ---------------------------------------------------------------- S
    selfsup_rows, selfsup_launches = selfsup_phase(card, dev, gen,
                                                   reset_counts, read_counts)
    train_fwd, train_dgrad = counts['fwd'], counts['dgrad']
    counts['fwd'] += selfsup_launches['san_fwd']
    counts['dgrad'] += selfsup_launches['san_dgrad']

    # ---------------------------------------------------------------- G
    generic_rows, generic_warps = generic_phase(card, dev, gen, reset_counts,
                                                read_counts)
    # the generic step's warps go through the same two kernels
    for row in selfsup_rows:
        key = {'warp_bilinear_out': 'warp_out',
               'warp_bilinear_dgrid': 'warp_dgrid'}.get(row['name'])
        if key:
            for path, got in generic_warps.items():
                row['launches'] += got[key]
                row['launches_by_path'][path] = got[key]

    # ---------------------------------------------------------------- Q
    gather_rows = gather_phase(card, dev, gen, reset_counts, read_counts)

    # ---------------------------------------------------------------- C
    cli_launches = cli_phase(card, dev, reset_counts, read_counts)
    counts['fwd'] += cli_launches

    # ---------------------------------------------------------------- T
    disk_launches = train_disk_phase(card, reset_counts, read_counts)
    for got in disk_launches.values():
        counts['fwd'] += got['san_fwd']
        counts['dgrad'] += got['san_dgrad']
    for row in selfsup_rows:
        key = {'warp_bilinear_out': 'warp_out',
               'warp_bilinear_dgrid': 'warp_dgrid'}.get(row['name'])
        if key:
            for path, got in disk_launches.items():
                if got[key]:
                    row['launches'] += got[key]
                    row['launches_by_path'][path] = got[key]

    # ---------------------------------------------------------------- D
    dual_launches = dual_head_phase(card, dev, reset_counts, read_counts)
    for got in dual_launches.values():
        counts['fwd'] += got['san_fwd']
        counts['dgrad'] += got['san_dgrad']

    # ---------------------------------------------------------------- K
    kitti_launches, kitti_convs = kitti_phase(card, dev, gen, reset_counts,
                                              read_counts)
    for got in kitti_launches.values():
        counts['fwd'] += got['san_fwd']
        counts['dgrad'] += got['san_dgrad']
    for row in selfsup_rows:
        key = {'warp_bilinear_out': 'warp_out',
               'warp_bilinear_dgrid': 'warp_dgrid',
               'photometric_fwd': 'photo_fwd',
               'photometric_bwd': 'photo_bwd'}.get(row['name'])
        if key:
            for path, got in kitti_launches.items():
                if got[key]:
                    row['launches'] += got[key]
                    row['launches_by_path'][path] = got[key]

    # ---------------------------------------------------------------- I
    image_dgp_launches = image_dgp_phase(card, dev, gen, reset_counts,
                                         read_counts)
    for row in selfsup_rows + generic_rows:
        key = {'warp_bilinear_out': 'warp_out',
               'warp_bilinear_dgrid': 'warp_dgrid',
               'photometric_fwd': 'photo_fwd',
               'photometric_bwd': 'photo_bwd',
               'generic_projection_fwd': 'proj_fwd',
               'generic_projection_bwd': 'proj_bwd'}.get(row['name'])
        if key:
            for path, got in image_dgp_launches.items():
                if got[key]:
                    row['launches'] += got[key]
                    row['launches_by_path'][path] = got[key]

    # ---------------------------------------------------------------- P
    packnet_launches, packnet_convs = packnet_phase(
        card, dev, gen, reset_counts, read_counts)
    for got in packnet_launches.values():
        counts['fwd'] += got['san_fwd']
        counts['dgrad'] += got['san_dgrad']
    for row in selfsup_rows:
        key = {'warp_bilinear_out': 'warp_out',
               'warp_bilinear_dgrid': 'warp_dgrid',
               'photometric_fwd': 'photo_fwd',
               'photometric_bwd': 'photo_bwd'}.get(row['name'])
        if key:
            for path, got in packnet_launches.items():
                if got[key]:
                    row['launches'] += got[key]
                    row['launches_by_path'][path] = got[key]

    # ---------------------------------------------------------------- 4
    step = make_eval_step(model)
    fwd_ms = cuda_time_ms(lambda: step(batch), iters=20)
    log('eval forward B1 {}x{} {}: {:.3f} ms, {:.2f} img/s'.format(
        shape[0], shape[1], dname, fwd_ms, 1e3 / fwd_ms))
    mstep = make_eval_metrics_step(model, config.model.params, flip_tta=True)
    tta_ms = cuda_time_ms(lambda: mstep(batch), iters=10)
    log('eval protocol step (flip-TTA + 6x7 metrics) B1: {:.3f} ms, {:.2f} '
        'img/s'.format(tta_ms, 1e3 / tta_ms))
    del model, mstep, step

    for _ in range(2):
        trainer.train_step(run_batch)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_step(run_batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    log('train step B{} {}x{} {}: {:.3f} ms, {:.2f} img/s'.format(
        train_bs, shape[0], shape[1], dname, step_ms,
        train_bs * 1e3 / step_ms))
    del trainer

    esize = torch.tensor([], dtype=dtype).element_size()
    fwd_rows = []
    fwd_tot = dict.fromkeys(TIME_KEYS, 0.0)
    for i, (mod, mask) in enumerate(convs):
        row = time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv)
        fwd_rows.append(row)
        for key in fwd_tot:
            fwd_tot[key] += row[key]
    log('30 forward convs, B1 eval: kernel {:.3f} ms ({:.3f} in a graph), '
        'plain {:.3f}, library {:.3f} ({:.3f}), bound {:.4f} ms'.format(
            fwd_tot['ms'], fwd_tot['graph_ms'], fwd_tot['plain_ms'],
            fwd_tot['library_ms'], fwd_tot['library_graph_ms'],
            fwd_tot['bound_ms']))
    levels = {'forward_b1': level_lines(fwd_rows, 'forward B1')}
    fwd8_rows = []
    fwd8 = dict.fromkeys(TIME_KEYS, 0.0)
    dw_ms = 0.0
    for i, (mod, mask, _) in enumerate(tconvs):
        row = time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv)
        x, mk, kern, _ = conv_inputs(mod, mask, dtype, gen)
        gm = dgrad_inputs(mod, mask, dtype, gen)[0]
        # dW as the Function computes it, TF32 allowed as outside this
        # script (exact here: bf16 values fit TF32's mantissa)
        torch.backends.cudnn.allow_tf32 = True
        row['dw_ms'] = cuda_time_ms(
            lambda: san_conv.filter_grad(x, gm, kern), iters=10)
        torch.backends.cudnn.allow_tf32 = False
        dw_ms += row['dw_ms']
        fwd8_rows.append(row)
        for key in fwd8:
            fwd8[key] += row[key]
    log('30 forward convs, B{} train: kernel {:.3f} ms ({:.3f} in a '
        'graph), plain {:.3f}, library {:.3f} ({:.3f}), bound {:.4f} ms; dW '
        '(filter_grad: cuDNN on float32 copies) {:.3f} ms per step'.format(
            train_bs, fwd8['ms'], fwd8['graph_ms'], fwd8['plain_ms'],
            fwd8['library_ms'], fwd8['library_graph_ms'], fwd8['bound_ms'],
            dw_ms))
    levels['forward_b{}'.format(train_bs)] = level_lines(
        fwd8_rows, 'forward B{}'.format(train_bs))

    dg_rows = []
    dg_tot = dict.fromkeys(TIME_KEYS, 0.0)
    for i, (mod, mask) in enumerate(dconvs):
        row = time_dgrad(i, mod, mask, dtype, dname, esize, gen, san_conv)
        dg_rows.append(row)
        for key in dg_tot:
            dg_tot[key] += row[key]
    log('27 dgrad launches of one B{} step: kernel {:.3f} ms ({:.3f} in a '
        'graph), plain {:.3f}, library {:.3f} ({:.3f}), bound {:.4f} ms'
        .format(train_bs, dg_tot['ms'], dg_tot['graph_ms'],
                dg_tot['plain_ms'], dg_tot['library_ms'],
                dg_tot['library_graph_ms'], dg_tot['bound_ms']))
    levels['dgrad_b{}'.format(train_bs)] = level_lines(
        dg_rows, 'dgrad B{}'.format(train_bs))
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_convs.json', 'w') as f:
        json.dump({'card': card, 'torch': torch.__version__,
                   'forward_ms': fwd_ms, 'flip_tta_step_ms': tta_ms,
                   'train_step_ms': step_ms, 'train_batch': train_bs,
                   'train_runs': train_runs, 'dw_ms': dw_ms,
                   'train_fp32_check': {
                       'loss_rel': loss_rel,
                       'kernels_vs_plain': grad_check,
                       'plain_reversed_batch_vs_plain': order_check},
                   'fwd_err': fwd_err, 'max_err': max_err,
                   'dgrad_max_err': dmax_err, 'function_rel_err': fn_err,
                   'convs': fwd_rows, 'train_convs': fwd8_rows,
                   'dgrads': dg_rows, 'levels': levels,
                   'reduce_launches': reduce_totals}, f, indent=1)

    # ---------------------------------------------------------------- 5
    def by(tot):
        return 'bytes' if tot['bytes_ms'] > tot['ops_ms'] else 'operations'

    log(json.dumps({'kernels': [{
        'name': 'san_masked_conv2d', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/san_conv.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/san_conv.py:53',
        'launches': eval_launches + counts['fwd'],
        'launches_by_path': {'eval': eval_launches, 'train': train_fwd,
                             'selfsup': selfsup_launches['san_fwd'],
                             'eval_cli': cli_launches,
                             **{k: v['san_fwd']
                                for k, v in disk_launches.items()},
                             **{k: v['san_fwd']
                                for k, v in dual_launches.items()},
                             **{k: v['san_fwd']
                                for k, v in kitti_launches.items()
                                if v['san_fwd']},
                             **{k: v['san_fwd']
                                for k, v in packnet_launches.items()
                                if v['san_fwd']}},
        'reduce_launches': reduce_totals['san_fwd'],
        'max_abs_err': max_err['float32'],
        'max_abs_err_bf16': max_err['bfloat16'],
        'timed_as': '30 launches of one B1 {}x{} eval forward, {}'.format(
            shape[0], shape[1], dname),
        'ms': fwd_tot['ms'], 'plain_ms': fwd_tot['plain_ms'],
        'bound_ms': fwd_tot['bound_ms'], 'bound_by': by(fwd_tot),
        'library_ms': fwd_tot['library_ms'],
        'graph_ms': fwd_tot['graph_ms'],
        'library_graph_ms': fwd_tot['library_graph_ms'],
        'train_step_ms': fwd8['ms'], 'train_step_plain_ms': fwd8['plain_ms'],
        'train_step_bound_ms': fwd8['bound_ms'],
        'train_step_library_ms': fwd8['library_ms'],
        'train_step_graph_ms': fwd8['graph_ms'],
        'train_step_library_graph_ms': fwd8['library_graph_ms'],
        'kitti_k2_step_graph_ms': kitti_convs['forward']['graph_ms'],
        'kitti_k2_step_library_graph_ms':
            kitti_convs['forward']['library_graph_ms'],
        'kitti_k2_step_bound_ms': kitti_convs['forward']['bound_ms'],
        'packnet_p1_step_graph_ms': packnet_convs['forward']['graph_ms'],
        'packnet_p1_step_library_graph_ms':
            packnet_convs['forward']['library_graph_ms'],
        'packnet_p1_step_bound_ms': packnet_convs['forward']['bound_ms']}, {
        'name': 'san_masked_conv2d_dgrad', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/san_conv.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/san_conv.py:184',
        'launches': counts['dgrad'],
        'launches_by_path': {'train': train_dgrad,
                             'selfsup': selfsup_launches['san_dgrad'],
                             **{k: v['san_dgrad']
                                for k, v in disk_launches.items()},
                             **{k: v['san_dgrad']
                                for k, v in dual_launches.items()},
                             **{k: v['san_dgrad']
                                for k, v in kitti_launches.items()
                                if v['san_dgrad']},
                             **{k: v['san_dgrad']
                                for k, v in packnet_launches.items()
                                if v['san_dgrad']}},
        'reduce_launches': reduce_totals['san_dgrad'],
        'max_abs_err': dmax_err['float32'],
        'max_abs_err_bf16': dmax_err['bfloat16'],
        'timed_as': '27 launches of one B{} {}x{} train step, {}'.format(
            train_bs, shape[0], shape[1], dname),
        'ms': dg_tot['ms'], 'plain_ms': dg_tot['plain_ms'],
        'bound_ms': dg_tot['bound_ms'], 'bound_by': by(dg_tot),
        'library_ms': dg_tot['library_ms'],
        'graph_ms': dg_tot['graph_ms'],
        'library_graph_ms': dg_tot['library_graph_ms'],
        'kitti_k2_step_graph_ms': kitti_convs['dgrad']['graph_ms'],
        'kitti_k2_step_library_graph_ms':
            kitti_convs['dgrad']['library_graph_ms'],
        'kitti_k2_step_bound_ms': kitti_convs['dgrad']['bound_ms'],
        'packnet_p1_step_graph_ms': packnet_convs['dgrad']['graph_ms'],
        'packnet_p1_step_library_graph_ms':
            packnet_convs['dgrad']['library_graph_ms'],
        'packnet_p1_step_bound_ms': packnet_convs['dgrad']['bound_ms']}] +
        selfsup_rows +
        generic_rows + gather_rows}))
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def profile_step_kernels(trainer, batch):
    """{kernel name: launches} of one train step under torch.profiler,
    after a step of warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, 'device_time_total', None)
        if total is None:
            total = getattr(evt, 'cuda_time_total', 0.0)
        if total:
            out[evt.key] = out.get(evt.key, 0) + evt.count
    return out


def reversed_batch(batch):
    """The batch's samples in reverse order (lists of frames and dicts of
    tensors too; other values as they are)."""
    def rev(v):
        if isinstance(v, list):
            return [rev(c) for c in v]
        if isinstance(v, dict):
            return {k: rev(c) for k, c in v.items()}
        return v.flip(0) if hasattr(v, 'flip') else v
    return {k: rev(v) for k, v in batch.items()}


def edge_grid(B, Ho, Wo, H, W, gen):
    """Normalised coordinates on the card: 70% in and around the image, 10%
    far outside (|x| up to 1e7, as a depth clipped at 1e-5 gives), 10% on
    exact integer pixels, 10% on the last row or column."""
    import torch
    dev = gen.device
    g = torch.rand(B, Ho, Wo, 2, device=dev, generator=gen) * 2.6 - 1.3
    flat = g.view(-1, 2)
    n = flat.shape[0]
    idx = torch.randperm(n, device=dev, generator=gen)
    far, ints, edge = idx[:n // 10], idx[n // 10:n // 5], idx[n // 5:n * 3 // 10]
    vals = torch.tensor([-1e7, -3e5, 2e6, 1e7], device=dev)
    flat[far] = vals[torch.randint(0, 4, (len(far), 2), device=dev,
                                   generator=gen)]
    px = torch.stack([torch.randint(-1, W + 1, (len(ints),), device=dev,
                                    generator=gen),
                      torch.randint(-1, H + 1, (len(ints),), device=dev,
                                    generator=gen)], 1).float()
    flat[ints] = 2.0 * px / torch.tensor([W - 1.0, H - 1.0], device=dev) - 1.0
    flat[edge[0::2], 0] = 1.0
    flat[edge[1::2], 1] = 1.0
    return g


def selfsup_phase(card, dev, gen, reset_counts, read_counts):
    """Phase S: the self-supervised slice's kernels, its path and its
    timings (see the module note). Returns the kernels-line rows of the
    warp and photometric kernels, the masked-conv launches of its runs and
    a summary for chiprun_out/chip_smoke_selfsup.json."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import parse_train_config
    from packnet_sfm_tpu_torch.ops.kernels import photometric, warp

    config = parse_train_config(SELFSUP_CONFIG)
    shape = port_eval.image_shape(config)
    bs = int(config.datasets.train.batch_size)
    batch = port_eval.make_batches(shape, bs, 1, seed=0, device='cuda',
                                   contexts=port_train.n_contexts(config))[0]

    # the step's own kernel inputs: one training step of (i) and of (ii)
    rec = {'warp_i': [], 'warp_ii': [], 'dgrid_i': [], 'dgrid_ii': [],
           'fwd': [], 'bwd': []}
    for name, over in (('i', None), ('ii', FP32_MAPS)):
        _, model = port_train.build(SELFSUP_CONFIG, 'cuda', seed=0,
                                    overrides=over)
        with contextlib.ExitStack() as stack:
            stack.enter_context(recording(warp, '_launch_out',
                                          rec['warp_' + name]))
            stack.enter_context(recording(warp, '_launch_dgrid',
                                          rec['dgrid_' + name]))
            if name == 'ii':
                stack.enter_context(recording(photometric, '_launch_fwd',
                                              rec['fwd']))
                stack.enter_context(recording(photometric, '_launch_bwd',
                                              rec['bwd']))
            model(batch)['loss'].backward()
        del model
    torch.cuda.synchronize()
    counted = tuple(len(rec[k]) for k in ('warp_i', 'dgrid_i', 'warp_ii',
                                          'dgrid_ii', 'fwd', 'bwd'))
    if counted != (WARPS_PER_STEP,) * 4 + (PHOTO_FWD_PER_STEP,
                                           PHOTO_BWD_PER_STEP):
        raise AssertionError('one selfsup step launched the warp forward and '
                             'dgrid kernels {} / {} (i), {} / {} (ii) times '
                             'and the photometric kernels {} / {}'.format(
                                 *counted))

    # the warp kernels against their plain versions: out of the forward
    # kernel against bilinear_warp_reference's (the same formulas in the
    # same order, no FMA contraction: expected bit for bit) and dgrid of the
    # dgrid kernel against warp_dgrid_reference (the same, up to the order
    # of the plain version's sum over the channels), on the step's own
    # launches with their recorded cotangents and on edge cases with a g in
    # the image dtype; held to atol = rtol = 1e-6 (x max|ref| for the atol)
    # so a library's rounding change in the plain side's elementwise ops
    # would not read as a fault
    warp_err = {'float32': 0.0, 'bfloat16': 0.0}
    exact = {'out': [0, 0], 'dgrid': [0, 0]}
    cases = [(img, grid, mode, g, 'step ' + tag)
             for tag in ('i', 'ii') for img, grid, g, mode in
             rec['dgrid_' + tag]]
    for B, H, W, C, Ho in ((2, 37, 53, 3, 111), (1, 8, 9, 1, 8)):
        grid = edge_grid(B, Ho, W, H, W, gen)
        for dt in (torch.float32, torch.bfloat16):
            img = torch.rand(B, H, W, C, device=dev, generator=gen).to(dt)
            g = torch.randn(B, Ho, W, C, device=dev, generator=gen).to(dt)
            for mode in ('zeros', 'border'):
                cases.append((img, grid, mode, g, 'edge {}x{}->{}'.format(
                    H, W, Ho)))
    for img, grid, mode, g, tag in cases:
        got = (warp.warp_bilinear_out(img, grid, mode),
               warp.warp_bilinear_dgrid(img, grid, g, mode))
        torch.cuda.synchronize()
        want = (warp.bilinear_warp_reference(img, grid, mode)[0],
                warp.warp_dgrid_reference(img, grid, g, mode))
        key = str(img.dtype).replace('torch.', '')
        for nm, a, b in zip(('out', 'dgrid'), got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError('warp {} {}: {} {} against {} {}'.format(
                    tag, nm, a.dtype, tuple(a.shape), b.dtype,
                    tuple(b.shape)))
            err = check_close('warp {} {} {} {}'.format(tag, key, mode, nm),
                              a, b, 1e-6 * max(float(b.float().abs().max()),
                                               1e-30), 1e-6)
            warp_err[key] = max(warp_err[key], err)
            exact[nm][0] += int((a == b).sum())
            exact[nm][1] += a.numel()
    bit_equal = {k: v[0] / v[1] for k, v in exact.items()}
    log('warp kernels vs plain: {} cases x (out, dgrid) ok, max |err| fp32 '
        '{:.3e} bf16 {:.3e}, bit-equal out {:.6f} dgrid {:.6f} of the '
        'values'.format(len(cases), warp_err['float32'],
                        warp_err['bfloat16'], bit_equal['out'],
                        bit_equal['dgrid']))

    # the photometric kernels against their plain compositions (the
    # reflect pad, the formulas, the reflect fold, the permutes; the same
    # formulas in the same order, but float32 sums of the plain side may
    # round differently): forward atol = rtol = 1e-6; backward atol 1e-6 x
    # max|ref|, rtol 1e-5. On the step's own NHWC inputs (row-slices of the
    # warp's output, the target image, the strided cotangent; dy as the
    # step asks for it) and on edge cases: random and constant images, x
    # and y strided row-slices of one tensor with a stride-0 g, H = W = 2,
    # and widths 59 and 60, where strips cut at multiples of 30 columns
    # would separate W-1 from W+1 (the kernel starts its strips elsewhere).
    # Identical images must give exact zeros both ways
    pcases = [(x, y, g, need_dy) for (x, y, g, need_dy, *_) in rec['bwd']]
    pcases += [(x, y, None, False) for (x, y, *_) in rec['fwd']]

    def rand_case(B, H, W, need_dy, make=torch.rand):
        x = make(B, H, W, 3, device=dev, generator=gen)
        y = make(B, H, W, 3, device=dev, generator=gen)
        return (x, y, torch.rand(B, H, W, device=dev, generator=gen),
                need_dy)

    def const(*shape, device, generator):
        return torch.full(shape, float(torch.rand(
            (), device=device, generator=generator)), device=device)

    big = torch.rand(2, 4 * 13, 47, 3, device=dev, generator=gen)
    pcases += [rand_case(2, 13, 45, True), rand_case(2, 13, 45, False),
               rand_case(2, 13, 45, True, const),
               (big[:, 13:26], big[:, 39:], torch.full(
                   (1, 1, 1), 0.3, device=dev).expand(2, 13, 47), True),
               rand_case(1, 2, 2, True), rand_case(3, 9, 59, True),
               rand_case(1, 7, 60, True)]
    photo_err = {'fwd': 0.0, 'bwd': 0.0}
    for x, y, g, need_dy in pcases:
        tag = '{} strides {}'.format(tuple(x.shape), x.stride())
        got = photometric.photometric_fwd(x, y)
        torch.cuda.synchronize()
        want = photometric.photometric_fwd_plain(x, y)
        photo_err['fwd'] = max(photo_err['fwd'], check_close(
            'photometric fwd ' + tag, got, want, 1e-6, 1e-6))
        if g is None:
            continue
        got = photometric.photometric_bwd(x, y, g, need_dy)
        torch.cuda.synchronize()
        want = photometric.photometric_bwd_plain(x, y, g, need_dy)
        if (got[1] is None) != (not need_dy):
            raise AssertionError('photometric bwd {}: dy {} with need_dy {}'
                                 .format(tag, got[1] is not None, need_dy))
        for nm, a, b in zip(('dx', 'dy'), got, want):
            if b is None:
                continue
            if a.shape != b.shape:
                raise AssertionError('photometric bwd {} {}: {} against {}'
                                     .format(tag, nm, tuple(a.shape),
                                             tuple(b.shape)))
            photo_err['bwd'] = max(photo_err['bwd'], check_close(
                'photometric bwd {} {}'.format(tag, nm), a, b,
                1e-6 * float(b.abs().max()), 1e-5))
    n_bwd = sum(c[2] is not None for c in pcases)
    x, _, g, _ = pcases[0]
    same = [photometric.photometric_fwd(x, x),
            *photometric.photometric_bwd(x, x, g, True)]
    torch.cuda.synchronize()
    if any(bool(v.any()) for v in same):
        raise AssertionError('photometric kernels: identical images must '
                             'give exact zeros')
    log('photometric kernels vs plain: {} forward and {} backward cases ok, '
        'max |err| fwd {:.3e} bwd {:.3e}; identical images give exact '
        'zeros'.format(len(pcases), n_bwd, photo_err['fwd'],
                       photo_err['bwd']))

    # the autograd Functions against plain autograd through the plain
    # versions: dgrid (the dgrid kernel against autograd through floor,
    # taps and weights) and dx, dy through the
    # reflect fold. Float32 in another order: atol 1e-5 x max|ref|, rtol
    # 1e-4. A bf16 source: the kernels' bf16 rule (rtol 2e-2, atol 1e-2 x
    # max|ref|), because the dgrid kernel's B rounds the tap differences
    # p10 - p00 and p11 - p01 to bf16, as the JAX `_gs_derivs` does, while
    # autograd through the out formula differentiates bot - top formed in
    # float32: dgrid's y half differs by one bf16 rounding of a difference
    fn_err = {}
    for img, grid, mode in rec['warp_i'][:1] + rec['warp_ii'][:1]:
        grads = []
        gout = torch.randn(img.shape[:1] + grid.shape[1:3] + img.shape[3:],
                           device=dev, generator=gen).to(img.dtype)
        for fn in (warp.grid_sample_fn, warp.grid_sample_reference):
            leaf = grid.clone().requires_grad_(True)
            fn(img, leaf, mode).backward(gout)
            grads.append(leaf.grad)
        key = 'dgrid ' + str(img.dtype).replace('torch.', '')
        if img.dtype == torch.float32:
            err = check_close(key, grads[0], grads[1], 1e-5 * float(
                grads[1].abs().max()), 1e-4)
        else:
            err = check_kernel(key, grads[0], grads[1], img.dtype)
        fn_err[key] = err / float(grads[1].abs().max())
    # the photometric map on the step's NHWC images, and on the same
    # images held as NCHW tensors seen through a permute (as a resize may
    # leave them), which photometric_map_fn copies to the kernels' layout
    x, y = rec['fwd'][0][:2]
    gout = torch.rand(x.shape[:3] + (1,), device=dev, generator=gen)
    for layout in ('NHWC', 'NCHW view'):
        grads = []
        for fn in (photometric.photometric_map_fn,
                   photometric.photometric_map_reference):
            if layout == 'NHWC':
                leaves = [v.clone().requires_grad_(True) for v in (x, y)]
                args = leaves
            else:
                leaves = [v.permute(0, 3, 1, 2).contiguous()
                          .requires_grad_(True) for v in (x, y)]
                args = [v.permute(0, 2, 3, 1) for v in leaves]
            fn(*args).backward(gout)
            grads.append([t.grad for t in leaves])
        for nm, a, b in zip(('dx', 'dy'), *grads):
            key = 'photometric {} {}'.format(layout, nm)
            fn_err[key] = check_close(key, a, b, 1e-5 * float(
                b.abs().max()), 1e-4) / float(b.abs().max())
    torch.cuda.synchronize()
    log('autograd Functions vs plain autograd, max |err| / max|ref|: ' +
        ', '.join('{} {:.3e}'.format(k, v) for k, v in fn_err.items()))

    # the path: train.main on the slice's YAML, (i) and (ii)
    warp.WarpFunction.image_grads = 0
    runs, trainers, launches_by_run = [], {}, {}
    for name, over, n_steps in SELFSUP_RUNS:
        reset_counts()
        t0 = time.time()
        run = port_train.main(SELFSUP_CONFIG, device='cuda', n_steps=n_steps,
                              n_batches=1, seed=0, overrides=over)
        got = read_counts()
        wall = time.time() - t0
        fp32 = over is not None
        want = dict.fromkeys(got, 0)
        want.update(san_fwd=CONVS_PER_FORWARD * n_steps,
                    san_dgrad=DGRADS_PER_STEP * n_steps,
                    warp_out=WARPS_PER_STEP * n_steps,
                    warp_dgrid=WARPS_PER_STEP * n_steps,
                    photo_fwd=PHOTO_FWD_PER_STEP * n_steps if fp32 else 0,
                    photo_bwd=PHOTO_BWD_PER_STEP * n_steps if fp32 else 0)
        if got != want:
            raise AssertionError('selfsup path ({}) launched {}, expected {}'
                                 .format(name, got, want))
        losses = run['losses']
        if not all(np.isfinite(losses)) or \
                run['trainer'].optimizer.count != n_steps:
            raise AssertionError('selfsup path ({}): non-finite loss or a '
                                 'step skipped: {}'.format(name, losses))
        if n_steps >= 10 and not losses[-1] < losses[0]:
            raise AssertionError('selfsup loss did not fall over {} steps on '
                                 'one batch: {}'.format(n_steps, losses))
        launches_by_run[name] = got
        trainers[name] = (run['trainer'], run['batches'][0])
        runs.append({'run': name, 'overrides': over, 'steps': n_steps,
                     'losses': losses, 'wall_s': wall, 'launches': got})
        log('train.main selfsup ({}) B{} {}x{}: {} steps, launches {}, '
            'losses {}'.format(name, bs, shape[0], shape[1], n_steps, got,
                               ['{:.4f}'.format(v) for v in losses]))
        del run
    if warp.WarpFunction.image_grads:
        raise AssertionError('the selfsup path computed an image cotangent '
                             'through the warp')

    # one (ii) step under torch.profiler: the reflect pad and its gradient
    # run inside the photometric kernels, so no reflection_pad2d kernel may
    # run (the profile must see the step's photometric launches)
    step_kernels = profile_step_kernels(*trainers['ii'])
    pads = {k: v for k, v in step_kernels.items() if 'reflection_pad' in k}
    seen = tuple(sum(v for k, v in step_kernels.items() if name in k)
                 for name in ('photometric_fwd_kernel',
                              'photometric_bwd_kernel'))
    if pads or seen != (PHOTO_FWD_PER_STEP, PHOTO_BWD_PER_STEP):
        raise AssertionError('profiled selfsup (ii) step: reflect-pad '
                             'kernels {}, photometric kernels {}'.format(
                                 pads, seen))
    ii_kernels = sum(step_kernels.values())
    log('selfsup (ii) step under torch.profiler: {} device launches, no '
        'reflection_pad2d kernel, photometric kernels {} / {}'.format(
            ii_kernels, *seen))

    # one float32 step through every kernel, through every plain version
    # under plain autograd, and (the control) plain on the reversed batch
    def fp32_steps(extra, runs):
        """(loss, gradients by leaf) of one float32 (ii) step a run of
        `runs` ((plain, batch) each), and the photometric kernels'
        launches over them."""
        _, fmodel = port_train.build(SELFSUP_CONFIG, 'cuda', seed=0,
                                     overrides=['tpu.compute_dtype',
                                                'float32'] + FP32_MAPS +
                                     extra)
        kernels = (photometric.photometric_fwd, photometric.photometric_bwd)
        before = [k.launches for k in kernels]
        res = step_gradients(fmodel, runs)
        return res, [k.launches - n for k, n in zip(kernels, before)]

    ((loss_k, gk), (loss_p, gp), (_, gr)), _ = fp32_steps(
        [], ((False, batch), (True, batch), (True, reversed_batch(batch))))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_check = compare_grads(gk, gp)
    order_check = compare_grads(gr, gp)
    log('selfsup step fp32 B{}, kernels vs plain: loss {:.6f} vs {:.6f} (rel '
        '{:.2e}); per gradient leaf max|err|/max|g| {:.3e} (at {}), '
        '|err|/|g| {:.3e}; zero leaves {:.2e} of the largest gradient. '
        'Plain vs plain on the reversed batch: {:.3e} (at {}), {:.3e}, '
        '{:.2e}'.format(bs, loss_k, loss_p, loss_rel, *grad_check,
                        *order_check))
    rel, _, norm, zero_leaf = grad_check
    if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
            norm > TRAIN_GRAD_NORM or zero_leaf > 1e-6:
        raise AssertionError('selfsup step through the kernels disagrees '
                             'with the plain versions')

    # the loss's per-scale path (upsample_depth_maps off) under (ii): a
    # warp a scale, and the lower scales' targets resized by ops/image.py
    # interpolate, which photometric_map_fn hands to the kernels in their
    # layout (a copy only where the resize left NCHW memory). One float32
    # step through the kernels against the plain versions, at the limits
    # above
    ((ps_k, ps_gk), (ps_p, ps_gp)), ps_launches = fp32_steps(
        ['model.loss.upsample_depth_maps', False],
        ((False, batch), (True, batch)))
    ps_rel = abs(ps_k - ps_p) / abs(ps_p)
    ps_check = compare_grads(ps_gk, ps_gp)
    log('selfsup step fp32 per scale, kernels vs plain: loss {:.6f} vs '
        '{:.6f} (rel {:.2e}); per gradient leaf max|err|/max|g| {:.3e} (at '
        '{}), |err|/|g| {:.3e}; zero leaves {:.2e}; photometric launches '
        '{} / {}'.format(ps_k, ps_p, ps_rel, *ps_check,
                         *ps_launches))
    if ps_rel > TRAIN_LOSS_RTOL or ps_check[0] > TRAIN_GRAD_REL or \
            ps_check[2] > TRAIN_GRAD_NORM or ps_check[3] > 1e-6 or \
            not all(ps_launches):
        raise AssertionError('selfsup per-scale step through the kernels '
                             'disagrees with the plain versions or skipped '
                             'the photometric kernels')

    # timings: the step under (i) and (ii); the device memory of one step
    # of (i): what was allocated before it, and its peak above that (the
    # saved activations, the warp's among them, and the gradients)
    step_ms, step_memory = {}, {}
    for name, (trainer, run_batch) in trainers.items():
        for _ in range(2):
            trainer.train_step(run_batch)
        torch.cuda.synchronize()
        if name == 'i':
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            trainer.train_step(run_batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            step_memory = {'held_before_mib': held / 2 ** 20,
                           'peak_mib': peak / 2 ** 20,
                           'step_peak_above_held_mib': (peak - held) / 2 ** 20}
            log('selfsup train step (i): max_memory_allocated {:.1f} MiB, '
                '{:.1f} MiB above the {:.1f} MiB held before the step'.format(
                    peak / 2 ** 20, (peak - held) / 2 ** 20, held / 2 ** 20))
        n_timed = 5
        t0 = time.perf_counter()
        for _ in range(n_timed):
            trainer.train_step(run_batch)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3 / n_timed
        log('selfsup train step ({}) B{} {}x{}: {:.3f} ms, {:.2f} img/s'
            .format(name, bs, shape[0], shape[1], step_ms[name],
                    bs * 1e3 / step_ms[name]))
    del trainers

    # the kernels over one step's launches (each launch on its own inputs,
    # so the 50 MB L2 holds at most the last of them), in a loop of calls
    # (the host's issue included) and replayed in a CUDA graph (without
    # it), the plain versions, the yardsticks and the bound from this run's
    # inputs
    def over_step(fn, items, iters=10):
        return cuda_time_ms(lambda: [fn(*a) for a in items], iters=iters)

    def over_step_graph(fn, items):
        return graph_time_ms(lambda: [fn(*a) for a in items])

    def warp_pair(img, grid, g, mode):
        """The two warp kernels of one context: out, then dgrid."""
        return (warp._launch_out(img, grid, mode),
                warp._launch_dgrid(img, grid, g, mode))

    def grid_sample_with_dgrid(im, grid, g, mode):
        """The same function by PyTorch: F.grid_sample's out and its grid
        gradient (aten.grid_sampler_2d_backward, output_mask (False,
        True))."""
        out = F.grid_sample(im, grid, mode='bilinear', padding_mode=mode,
                            align_corners=True)
        return out, grid_sampler_dgrid(im, grid, g, mode)

    def grid_sampler_dgrid(im, grid, g, mode):
        return torch.ops.aten.grid_sampler_2d_backward(
            g, im, grid, 0, PADDING_MODES[mode], True, [False, True])[1]

    def grid_sample_out(im, grid, g, mode):
        return F.grid_sample(im, grid, mode='bilinear', padding_mode=mode,
                             align_corners=True)

    with torch.no_grad():
        # the step's own launches: the forward's (image, grid, mode) and the
        # dgrid kernel's (image, grid, g, mode), g the step's cotangent of
        # out in the image dtype
        w_items, d_items = rec['warp_i'], rec['dgrid_i']
        w_ms = over_step(warp._launch_out, w_items)
        w_graph = over_step_graph(warp._launch_out, w_items)
        w_plain = over_step(warp.bilinear_warp_reference, w_items, 5)
        d_ms = over_step(warp._launch_dgrid, d_items)
        d_graph = over_step_graph(warp._launch_dgrid, d_items)
        d_plain = over_step(warp.warp_dgrid_reference, d_items, 5)
        pair_graph = over_step_graph(warp_pair, d_items)
        # PyTorch's calls take the source in NCHW and, for the grid, the
        # image's dtype: timed on float32 copies of each source and g
        lib_items = [(img.float().permute(0, 3, 1, 2).contiguous(), grid,
                      g.float().permute(0, 3, 1, 2).contiguous(), mode)
                     for img, grid, g, mode in d_items]
        w_lib_out = over_step(grid_sample_out, lib_items)
        w_lib_graph = over_step_graph(grid_sample_out, lib_items)
        d_lib_graph = over_step_graph(grid_sampler_dgrid, lib_items)
        pair_lib_graph = over_step_graph(grid_sample_with_dgrid, lib_items)
        # the step's own calls: (x, y, alpha, C1, C2) forward and (x, y,
        # g, need_dy, alpha, C1, C2) backward, NHWC as the loss holds them
        f_items, b_items = rec['fwd'], rec['bwd']
        f_ms = over_step(photometric._launch_fwd, f_items)
        f_graph = over_step_graph(photometric._launch_fwd, f_items)
        f_plain = over_step(photometric.photometric_fwd_plain,
                            [a[:2] for a in f_items], 5)
        b_ms = over_step(photometric._launch_bwd, b_items)
        b_graph = over_step_graph(photometric._launch_bwd, b_items)
        b_plain = over_step(photometric.photometric_bwd_plain,
                            [a[:4] for a in b_items], 5)

    def warp_bound(img, grid, with_out, with_dgrid):
        """The warp's least time at one launch: the image and the grid read
        once, out written once (with_out), g read and dgrid written once
        (with_dgrid); ~12 FLOPs a pixel for the coordinates, ~16 a channel
        for the taps and weights, ~24 a channel for A, B and the sums."""
        B, H, W, C = img.shape
        n_out = grid.numel() // 2
        esize = img.element_size()
        nbytes = img.numel() * esize + grid.numel() * 4
        flops = n_out * (12 + 16 * C)
        if with_out:
            nbytes += n_out * C * esize
        if with_dgrid:
            nbytes += n_out * C * esize + grid.numel() * 4
            flops += n_out * 24 * C
        return bound(nbytes, flops, 'float32')

    def photo_bound(x, n_images_moved, flops_per_px):
        """[B,H,W,3] images moved (read or written) once, unpadded, plus
        one [B,H,W] map (photo written or g read)."""
        B, H, W, _ = x.shape
        n = B * H * W
        return bound((n_images_moved * x.numel() + n) * 4, n * flops_per_px,
                     'float32')

    wb = [warp_bound(img, grid, True, False) for img, grid, _ in w_items]
    db = [warp_bound(img, grid, False, True) for img, grid, *_ in d_items]
    pb = [warp_bound(img, grid, True, True) for img, grid, *_ in d_items]
    # forward: x, y in, photo out; ~100 FLOPs a pixel and channel
    fb = [photo_bound(a[0], 2, 300) for a in f_items]
    # backward: x, y, g in, dx (and dy when asked) out; ~180 FLOPs a pixel
    # and channel
    bb = [photo_bound(a[0], 3 + int(a[3]), 540) for a in b_items]

    def total(bounds):
        b_all = sum(b[0] for b in bounds)
        by = 'bytes' if sum(b[1] for b in bounds) > sum(b[2] for b in bounds) \
            else 'operations'
        return b_all, by

    times = {'warp_out': (w_ms, w_graph, w_plain, w_lib_graph, *total(wb)),
             'warp_dgrid': (d_ms, d_graph, d_plain, d_lib_graph,
                            *total(db)),
             'photometric_fwd': (f_ms, f_graph, f_plain, None, *total(fb)),
             'photometric_bwd': (b_ms, b_graph, b_plain, None, *total(bb))}
    for k, (ms, graph, plain, lib, b_ms_, by) in times.items():
        log('{} over one step\'s launches: kernel {:.4f} ms (graph {:.4f}), '
            'plain {:.4f}, library {}, bound {:.4f} ms ({})'.format(
                k, ms, graph, plain, 'none' if lib is None else
                '{:.4f} (graph)'.format(lib), b_ms_, by))
    pair_bound = total(pb)[0]
    log('warp forward and dgrid kernels in a graph {:.4f} ms; F.grid_sample '
        'with its grid gradient {:.4f}; the function\'s bound {:.4f}; '
        'F.grid_sample out only, in a loop {:.4f}'.format(
            pair_graph, pair_lib_graph, pair_bound, w_lib_out))

    n_launch = {k: sum(r[k] for r in launches_by_run.values())
                for k in ('warp_out', 'warp_dgrid', 'photo_fwd', 'photo_bwd',
                          'san_fwd', 'san_dgrad')}
    timed_as = '{} launches of one B{} {}x{} selfsup step (i), bf16 source'
    rows = [{
        'name': 'warp_bilinear_out', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/warp.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/warp.py:92',
        'launches': n_launch['warp_out'],
        'launches_by_path': {'selfsup_i': launches_by_run['i']['warp_out'],
                             'selfsup_ii': launches_by_run['ii']['warp_out']},
        'max_abs_err': warp_err['float32'],
        'max_abs_err_bf16': warp_err['bfloat16'],
        'bit_equal_share': bit_equal['out'],
        'timed_as': timed_as.format(len(w_items), bs, *shape),
        'ms': w_ms, 'graph_ms': w_graph, 'plain_ms': w_plain,
        'bound_ms': times['warp_out'][4], 'bound_by': times['warp_out'][5],
        'library_ms': w_lib_graph,
        'library_call': 'F.grid_sample(bilinear, align_corners=True) on a '
                        'float32 NCHW copy, in a CUDA graph',
        'library_out_only_loop_ms': w_lib_out,
        # the function the port computes, out and dgrid: both kernels in a
        # graph, PyTorch's pair, and its bound (image, grid and g read
        # once, out and dgrid written once)
        'kernel_with_dgrid_graph_ms': pair_graph,
        'library_pair_graph_ms': pair_lib_graph,
        'library_pair_call': 'F.grid_sample and aten.grid_sampler_2d_backward'
                             '(output_mask=(False, True)) on float32 copies',
        'function_bound_ms': pair_bound}, {
        'name': 'warp_bilinear_dgrid', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/warp.cu',
        'replaces': 'packnet_sfm_tpu/ops/image.py:356 (the grid cotangent of '
                    'the custom VJP around packnet_sfm_tpu/ops/pallas/'
                    'warp.py:92)',
        'launches': n_launch['warp_dgrid'],
        'launches_by_path': {'selfsup_i': launches_by_run['i']['warp_dgrid'],
                             'selfsup_ii':
                                 launches_by_run['ii']['warp_dgrid']},
        'max_abs_err': warp_err['float32'],
        'max_abs_err_bf16': warp_err['bfloat16'],
        'bit_equal_share': bit_equal['dgrid'],
        'timed_as': timed_as.format(len(d_items), bs, *shape),
        'ms': d_ms, 'graph_ms': d_graph, 'plain_ms': d_plain,
        'bound_ms': times['warp_dgrid'][4],
        'bound_by': times['warp_dgrid'][5], 'library_ms': d_lib_graph,
        'library_call': 'aten.grid_sampler_2d_backward(output_mask=(False, '
                        'True)) on float32 copies, in a CUDA graph'}, {
        'name': 'photometric_fwd', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/photometric.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/photometric.py:94',
        'launches': n_launch['photo_fwd'],
        'launches_by_path': {'selfsup_ii': launches_by_run['ii']['photo_fwd']},
        'max_abs_err': photo_err['fwd'],
        'timed_as': '{} launches of one B{} {}x{} selfsup step (ii)'.format(
            len(f_items), bs, *shape),
        'ms': f_ms, 'graph_ms': f_graph, 'plain_ms': f_plain,
        'bound_ms': times['photometric_fwd'][4],
        'bound_by': times['photometric_fwd'][5], 'library_ms': None}, {
        'name': 'photometric_bwd', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/photometric.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/photometric.py:133',
        'launches': n_launch['photo_bwd'],
        'launches_by_path': {'selfsup_ii': launches_by_run['ii']['photo_bwd']},
        'max_abs_err': photo_err['bwd'],
        'timed_as': '{} launches of one B{} {}x{} selfsup step (ii)'.format(
            len(b_items), bs, *shape),
        'ms': b_ms, 'graph_ms': b_graph, 'plain_ms': b_plain,
        'bound_ms': times['photometric_bwd'][4],
        'bound_by': times['photometric_bwd'][5], 'library_ms': None}]
    summary = {'card': card, 'batch': bs, 'shape': list(shape),
               'step_ms': step_ms,
               'img_per_s': {k: bs * 1e3 / v for k, v in step_ms.items()},
               'runs': runs, 'warp_max_err': warp_err,
               'warp_bit_equal_share': bit_equal,
               'step_i_memory_mib': step_memory,
               'photometric_max_err': photo_err, 'function_rel_err': fn_err,
               'step_ii_kernel_launches': ii_kernels,
               'fp32_step_check': {'loss_rel': loss_rel,
                                   'kernels_vs_plain': grad_check,
                                   'plain_reversed_batch_vs_plain':
                                       order_check},
               'fp32_per_scale_step_check': {
                   'loss_rel': ps_rel, 'kernels_vs_plain': ps_check,
                   'photometric_launches': ps_launches},
               'kernels': rows}
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_selfsup.json', 'w') as f:
        json.dump(summary, f, indent=1)
    return rows, n_launch


def pinhole_planes(B, H, W, gen, noise):
    """Unit pinhole rays [B,3,H,W] (fx = W, centred) plus `noise` times a
    unit normal, renormalised: a ray plane near the template."""
    import torch
    dev = gen.device
    u = (torch.arange(W, device=dev, dtype=torch.float32) - (W - 1) / 2) / W
    v = (torch.arange(H, device=dev, dtype=torch.float32) - (H - 1) / 2) / W
    rays = torch.stack([u[None].expand(H, W), v[:, None].expand(H, W),
                        torch.ones(H, W, device=dev)])[None].repeat(B, 1, 1, 1)
    rays = rays + noise * torch.randn(B, 3, H, W, device=dev, generator=gen)
    return (rays / rays.norm(dim=1, keepdim=True)).contiguous()


def projection_cases(rec, gen):
    """(tag, ray_p, d_p, p) for the kernel checks: the step's own inputs,
    two other windows (p = 7 at 45x60, p = 23 at 50x53, progress 0), then
    edge shapes (41x41, 41x97, B2 45x60) with rays near the pinhole
    template and directions divided by the temperature of progress 0 and 1
    (a peaked softmax), and random unnormalised rays at temperature 1 (a
    flat one)."""
    import torch
    from packnet_sfm_tpu_torch.geometry.camera_generic import (
        softmax_temperature)
    cases = [('step ' + tag, a[0], a[1], a[2])
             for tag in ('i', 'ii') for a in rec['fwd_' + tag]]
    # windows other than the configs' p = 20, for the kernels' chunks whose
    # every slot is tested (k1 = 15 < 41) and for a second, partial chunk
    # a window row (k1 = 47 > 44)
    for B, H, W, p in ((1, 45, 60, 7), (1, 50, 53, 23)):
        ray = pinhole_planes(B, H, W, gen, 0.01)
        d = pinhole_planes(B, H, W, gen, 0.01) / softmax_temperature(0.0)
        cases.append(('{}x{}x{} p{}'.format(B, H, W, p), ray, d.contiguous(),
                      p))
    for B, H, W in ((1, 41, 41), (1, 41, 97), (2, 45, 60)):
        ray = pinhole_planes(B, H, W, gen, 0.01)
        for progress in (0.0, 1.0):
            d = pinhole_planes(B, H, W, gen, 0.01) / softmax_temperature(
                progress)
            cases.append(('{}x{}x{} progress {}'.format(B, H, W, progress),
                          ray, d.contiguous(), 20))
        flat = [torch.randn(B, 3, H, W, device=gen.device, generator=gen)
                for _ in range(2)]
        cases.append(('{}x{}x{} flat'.format(B, H, W), flat[0], flat[1], 20))
    return cases


def check_projection_fwd(tag, ray, d, p, err, m_equal):
    """The projection forward kernel against its plain version on one
    input. The logits are the same products summed in the same order, so
    m (their max) is expected bit for bit; s, rows and cols sum the same
    positive terms in another order: s rtol 1e-5, rows and cols atol 1e-5
    of the plane's extent (5e-6 on the normalised grid, 40x inside JAX's
    own cross-formulation limit of 2e-4). Raises past those; updates the
    max errors in `err` ('rows_cols_px', 'm_rel', 's_rel') and the count
    of bit-equal m values in `m_equal` [equal, all]."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels import generic_projection as gp
    got = gp.generic_projection_fwd(ray, d, p)
    torch.cuda.synchronize()
    want = gp.generic_projection_fwd_reference(ray, d, p)
    H, W = ray.shape[2], ray.shape[3]
    for nm, a, b, ext in (('rows', got[0], want[0], H - 1),
                          ('cols', got[1], want[1], W - 1)):
        err['rows_cols_px'] = max(err['rows_cols_px'], check_close(
            'projection fwd {} {}'.format(tag, nm), a, b, 1e-5 * ext, 0.0))
    err['m_rel'] = max(err['m_rel'], check_close(
        'projection fwd {} m'.format(tag), got[2], want[2], 0.0, 1e-6)
        / float(want[2].abs().max()))
    err['s_rel'] = max(err['s_rel'], check_close(
        'projection fwd {} s'.format(tag), got[3], want[3], 0.0, 1e-5)
        / float(want[3].abs().max()))
    m_equal[0] += int((got[2] == want[2]).sum())
    m_equal[1] += got[2].numel()


def check_projection_bwd(tag, args):
    """The projection backward kernels against their plain formula on one
    call's arguments: signed sums over up to (3p+1)^2 terms in another
    order, atol 2e-4 x max|ref| (10x inside JAX's 2e-3); run twice,
    bit-equal (no atomics). Returns the max |err| / max|ref|."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels import generic_projection as gp
    got = gp.generic_projection_bwd(*args)
    again = gp.generic_projection_bwd(*args)
    torch.cuda.synchronize()
    want = gp.generic_projection_bwd_reference(*args)
    err = 0.0
    for nm, a, b, c in zip(('dray', 'dd'), got, want, again):
        err = max(err, check_close(
            'projection bwd {} {}'.format(tag, nm), a, b,
            2e-4 * float(b.abs().max()), 0.0) / float(b.abs().max()))
        if not torch.equal(a, c):
            raise AssertionError('projection bwd {} {}: two calls differ'
                                 .format(tag, nm))
    return err


def generic_phase(card, dev, gen, reset_counts, read_counts):
    """Phase G: the generic-camera slice (configs/train_omnicam.yaml (i),
    configs/train_omnicam_fullres.yaml (ii)): its projection kernels
    against their plain versions, its path through train.main, one fp32
    step against the plain versions, and its timings. Returns the
    kernels-line rows of the two projection kernels."""
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import parse_train_config
    from packnet_sfm_tpu_torch.geometry import camera_generic
    from packnet_sfm_tpu_torch.ops.kernels import build
    from packnet_sfm_tpu_torch.ops.kernels import generic_projection as gp

    config = parse_train_config(GENERIC_CONFIGS['i'])
    shape = port_eval.image_shape(config)
    bs = int(config.datasets.train.batch_size)
    batch = port_eval.make_batches(shape, bs, 1, seed=0, device='cuda',
                                   contexts=port_train.n_contexts(config))[0]

    # the step's own kernel inputs: one training step of (i) and of (ii)
    rec = {k: [] for k in ('fwd_i', 'fwd_ii', 'bwd_i', 'bwd_ii')}
    for name, path in GENERIC_CONFIGS.items():
        _, model = port_train.build(path, 'cuda', seed=0,
                                    overrides=RANDOM_INIT)
        with recording(gp, '_launch_fwd', rec['fwd_' + name]), \
                recording(gp, '_launch_bwd', rec['bwd_' + name]):
            model(batch)['loss'].backward()
        del model
    torch.cuda.synchronize()
    got = [len(v) for v in rec.values()]
    if got != [PROJ_PER_STEP] * 4:
        raise AssertionError('one generic step called the projection '
                             'forward / backward {} times (i, ii)'.format(got))
    sizes = {k: tuple(rec['fwd_' + k][0][0].shape) for k in ('i', 'ii')}
    log('generic step projection planes: (i) {}, (ii) {}'.format(
        sizes['i'], sizes['ii']))

    # the forward against its plain version (check_projection_fwd's rule)
    fwd_err = {'rows_cols_px': 0.0, 'm_rel': 0.0, 's_rel': 0.0}
    m_equal = [0, 0]
    cases = projection_cases(rec, gen)
    for tag, ray, d, p in cases:
        check_projection_fwd(tag, ray, d, p, fwd_err, m_equal)
    log('projection forward kernel vs plain: {} cases ok; max |err| rows / '
        'cols {:.3e} px, m {:.3e} and s {:.3e} of max; m bit-equal {:.6f} '
        'of the values'.format(len(cases), fwd_err['rows_cols_px'],
                               fwd_err['m_rel'], fwd_err['s_rel'],
                               m_equal[0] / m_equal[1]))

    # the backward against its plain formula on the same residuals
    # (check_projection_bwd's rule)
    bwd_err = 0.0
    bcases = [('step ' + tag, a) for tag in ('i', 'ii')
              for a in rec['bwd_' + tag]]
    for tag, ray, d, p in cases[len(bcases):]:
        res = gp.generic_projection_fwd(ray, d, p)
        g2 = [torch.randn(res[0].shape, device=dev, generator=gen)
              for _ in range(2)]
        bcases.append((tag, (ray, d, *res, *g2, p)))
    for tag, args in bcases:
        bwd_err = max(bwd_err, check_projection_bwd(tag, args))
    log('projection backward kernels vs plain: {} cases ok, max |err| {:.3e} '
        'of max|ref|; two calls bit-equal'.format(len(bcases), bwd_err))

    # the Function against plain autograd through the plain forward. The
    # two round differently (the analytic adjoint against autodiff of the
    # online softmax), and at the step's temperature the logits are ~1e4,
    # whose float32 ulp is ~1e-3: each lands ~1e-4 of max from the exact
    # gradient, in places ~3x apart. So the Function is held to JAX's own
    # cross-formulation limits (rtol 5e-3, atol 2e-3 x max|ref|) against
    # the exact gradient, plain autograd through the plain forward in
    # float64, and float32 plain autograd's distance from it is logged
    fn_err = {}
    f64 = lambda r, dd, p: gp.generic_projection_fwd_reference(r, dd, p)[:2]
    for tag, ray, d, p in [cases[0], cases[-2], cases[-1]]:
        g2 = [torch.randn(ray.shape[:1] + ray.shape[2:], device=dev,
                          generator=gen) for _ in range(2)]
        grads = []
        for fn, dt in ((gp.expected_patch_coords_fn, torch.float32),
                       (gp.expected_patch_coords_reference, torch.float32),
                       (f64, torch.float64)):
            leaves = [ray.to(dt, copy=True).requires_grad_(True),
                      d.to(dt, copy=True).requires_grad_(True)]
            rows, cols = fn(*leaves, p)
            ((rows * g2[0].to(dt)).sum() + (cols * g2[1].to(dt)).sum()
             ).backward()
            grads.append([t.grad for t in leaves])
            del rows, cols, leaves
        for i, nm in enumerate(('dray', 'dd')):
            exact = grads[2][i]
            scale = float(exact.abs().max())
            key = '{} {}'.format(tag, nm)
            check_close('projection Function ' + key, grads[0][i].double(),
                        exact, 2e-3 * scale, 5e-3)
            fn_err[key] = {'function': float(
                (grads[0][i].double() - exact).abs().max()) / scale,
                'plain_fp32': float(
                (grads[1][i].double() - exact).abs().max()) / scale}
        del grads
    torch.cuda.synchronize()
    log('projection Function and plain float32 autograd against plain '
        'float64 autograd, max |err| / max|ref|: ' + ', '.join(
            '{} {:.3e} / {:.3e}'.format(k, v['function'], v['plain_fp32'])
            for k, v in fn_err.items()))

    # the path: train.main on (i) and (ii) on a batch with something to
    # learn, each run one epoch of that batch repeated, so that progress
    # stays below 0.02 as in the first steps of a real run (at one batch an
    # epoch it would reach 0.18 by step 10 and ramp the random ray residual
    # in at 0.47)
    learn = port_eval.shifted_context_batch(batch)
    runs, trainers, launches_by_run = [], {}, {}
    for name, n_steps in GENERIC_RUNS:
        reset_counts()
        t0 = time.time()
        run = port_train.main(GENERIC_CONFIGS[name], device='cuda',
                              n_steps=n_steps, seed=0,
                              batches=[learn] * n_steps,
                              overrides=RANDOM_INIT)
        got = read_counts()
        wall = time.time() - t0
        want = dict.fromkeys(got, 0)
        want.update(proj_fwd=PROJ_PER_STEP * n_steps,
                    proj_bwd=PROJ_PER_STEP * n_steps,
                    warp_out=WARPS_PER_STEP * n_steps,
                    warp_dgrid=WARPS_PER_STEP * n_steps)
        if got != want:
            raise AssertionError('generic path ({}) launched {}, expected {}'
                                 .format(name, got, want))
        losses = run['losses']
        if not all(np.isfinite(losses)) or \
                run['trainer'].optimizer.count != n_steps:
            raise AssertionError('generic path ({}): non-finite loss or a '
                                 'step skipped: {}'.format(name, losses))
        fell = bool(losses[-1] < losses[0])
        if n_steps >= 10 and not fell:
            raise AssertionError('generic loss ({}) did not fall over {} '
                                 'steps on one batch: {}'.format(
                                     name, n_steps, losses))
        launches_by_run[name] = got
        trainers[name] = (run['trainer'], run['batches'][0])
        runs.append({'run': name, 'config': GENERIC_CONFIGS[name],
                     'steps': n_steps, 'losses': losses, 'last_below_first':
                     fell, 'wall_s': wall, 'launches': got})
        log('train.main generic ({}) B{} {}x{}: {} steps, launches {}, '
            'losses {}, last below first: {}'.format(
                name, bs, shape[0], shape[1], n_steps, got,
                ['{:.4f}'.format(v) for v in losses], fell))
        del run

    # one float32 step of (i) at progress 0.5 (the ray head live) through
    # every kernel, through every plain version under plain autograd, and
    # (the control; B1 has no reversed batch) plain again with the softmax
    # temperature moved by 3e-7 relative, a few ulps
    _, fmodel = port_train.build(GENERIC_CONFIGS['i'], 'cuda', seed=0,
                                 overrides=['tpu.compute_dtype', 'float32']
                                 + RANDOM_INIT)
    temperature = camera_generic.softmax_temperature
    step_grads = []
    for plain, scale in ((False, 1.0), (True, 1.0), (True, 1.0 + 3e-7)):
        fmodel.zero_grad(set_to_none=True)
        camera_generic.softmax_temperature = (
            lambda progress, s=scale: temperature(progress) * s)
        try:
            with plain_versions() if plain else contextlib.nullcontext():
                out = fmodel(batch, progress=0.5)
                out['loss'].backward()
        finally:
            camera_generic.softmax_temperature = temperature
        step_grads.append((float(out['loss'].detach()),
                           {n: p.grad.detach().clone() if p.grad is not None
                            else torch.zeros_like(p)
                            for n, p in fmodel.named_parameters()}))
        del out
    del fmodel
    (loss_k, gk), (loss_p, gp_), (_, gt) = step_grads
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_check = compare_grads(gk, gp_)
    temp_check = compare_grads(gt, gp_)
    log('generic step (i) fp32 at progress 0.5, kernels vs plain: loss '
        '{:.6f} vs {:.6f} (rel {:.2e}); per gradient leaf max|err|/max|g| '
        '{:.3e} (at {}), |err|/|g| {:.3e}; zero leaves {:.2e} of the '
        'largest gradient. Plain vs plain at the temperature x (1 + 3e-7): '
        '{:.3e} (at {}), {:.3e}, {:.2e}'.format(
            loss_k, loss_p, loss_rel, *grad_check, *temp_check))
    # held to slice 2's fixed limits; the control is logged, not a limit:
    # a few-ulp change of every logit moves single leaves whose gradient
    # is a sum that cancels (a one-element bias) by up to their size
    rel, _, norm, zero_leaf = grad_check
    if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
            norm > TRAIN_GRAD_NORM or zero_leaf > 1e-6:
        raise AssertionError('generic step through the kernels disagrees '
                             'with the plain versions')

    # timings: the step under (i) and (ii)
    step_ms = {}
    for name, (trainer, run_batch) in trainers.items():
        for _ in range(2):
            trainer.train_step(run_batch)
        torch.cuda.synchronize()
        n_timed = 5
        t0 = time.perf_counter()
        for _ in range(n_timed):
            trainer.train_step(run_batch)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3 / n_timed
        log('generic train step ({}) B{} {}x{}: {:.3f} ms, {:.2f} img/s'
            .format(name, bs, shape[0], shape[1], step_ms[name],
                    bs * 1e3 / step_ms[name]))
    del trainers

    # the kernels over one step's launches, the plain versions, and the
    # bound from this run's inputs: bytes (each plane once), fp32
    # operations (~12 a candidate forward, ~24 backward) at 67 TFLOP/s, and
    # the exps (one a candidate) at the SFU rate
    def over_step(fn, items, iters=10):
        return cuda_time_ms(lambda: [fn(*a) for a in items], iters=iters)

    def bwd_launch(symbol):
        """One half of the backward call alone, dd's or dray's tiles (the C
        entry points generic_projection_bwd_dd and _dray), on preallocated
        outputs; for timing only, not counted."""
        fn = build.function('generic_projection', symbol, 10, 4)

        def run(ray, d, rows, cols, m, s, gy, gx, p, out):
            B, _, H, W = ray.shape
            rc = fn(*[t.data_ptr() for t in (ray, d, rows, cols, m, s, gy,
                                                gx, *out)], B, H, W, p,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError('{}: cudaError {}'.format(symbol, rc))
        return run

    def graph_parts(items):
        outs = [(torch.empty_like(a[0]), torch.empty_like(a[1]))
                for a in items]
        return {part: graph_time_ms(lambda fn=bwd_launch(
                    'generic_projection_bwd_' + part): [
                    fn(*a, out=o) for a, o in zip(items, outs)])
                for part in ('dd', 'dray')}

    # loop and graph times of the step's calls; the backward's dd and dray
    # tiles apart, each in a graph
    times = {}
    with torch.no_grad():
        for name in ('i', 'ii'):
            f_items, b_items = rec['fwd_' + name], rec['bwd_' + name]
            # forward: ray_p, d_p in (6 planes), rows, cols, m, s out (4);
            # backward: those 10 and gy, gx in, dray, dd out (18)
            fb = [projection_bound(a[0], a[2], 10, 12) for a in f_items]
            bb = [projection_bound(a[0], a[8], 18, 24) for a in b_items]
            times[name] = {
                'fwd': (over_step(gp._launch_fwd, f_items),
                        over_step(gp.generic_projection_fwd_reference,
                                  f_items, 3), fb,
                        graph_time_ms(lambda items=f_items: [
                            gp._launch_fwd(*a) for a in items]), {}),
                'bwd': (over_step(gp._launch_bwd, b_items),
                        over_step(gp.generic_projection_bwd_reference,
                                  b_items, 3), bb,
                        graph_time_ms(lambda items=b_items: [
                            gp._launch_bwd(*a) for a in items]),
                        graph_parts(b_items))}
    rows_out, summary_times = [], {}
    for kname, key, line, replaces in (
            ('generic_projection_fwd', 'fwd', ':81', 'forward'),
            ('generic_projection_bwd', 'bwd', ':199', 'backward')):
        t_i, t_ii = times['i'][key], times['ii'][key]
        b_i = sum(b[0] for b in t_i[2])
        b_ii = sum(b[0] for b in t_ii[2])
        by = 'bytes' if sum(b[1] for b in t_i[2]) > sum(
            b[2] for b in t_i[2]) else 'operations'
        summary_times[kname] = {
            tag: {'ms': t[0], 'graph_ms': t[3], 'plain_ms': t[1],
                  'bound_ms': bd, 'set_by': t[2][0][3],
                  **{part + '_graph_ms': v for part, v in t[4].items()}}
            for tag, t, bd in (('i', t_i, b_i), ('ii', t_ii, b_ii))}
        parts = lambda t: ''.join(', {} {:.4f}'.format(k, v)
                                  for k, v in t[4].items())
        log('projection {} over one step\'s {} calls: (i) kernel {:.4f} ms '
            '(graph {:.4f}{}), plain {:.4f}, bound {:.4f} ms (set by {}); '
            '(ii) kernel {:.4f} ms (graph {:.4f}{}), plain {:.4f}, bound '
            '{:.4f} ms; library none'.format(
                replaces, PROJ_PER_STEP, t_i[0], t_i[3], parts(t_i), t_i[1],
                b_i, t_i[2][0][3], t_ii[0], t_ii[3], parts(t_ii), t_ii[1],
                b_ii))
        rows_out.append({
            'name': kname, 'route': 'cuda',
            'source': 'packnet_sfm_tpu_torch/csrc/generic_projection.cu',
            'replaces': 'packnet_sfm_tpu/ops/pallas/generic_projection.py'
                        + line,
            'launches': sum(r['proj_' + key] for r in
                            launches_by_run.values()),
            'launches_by_path': {'generic_' + k: v['proj_' + key]
                                 for k, v in launches_by_run.items()},
            'max_abs_err': (fwd_err['rows_cols_px'] if key == 'fwd'
                            else bwd_err),
            'timed_as': '{} {} of one B{} {}x{} step (i), {}x{} planes'
                        .format(PROJ_PER_STEP, 'launches' if key == 'fwd'
                                else 'calls (1 launch each)', bs, *shape,
                                *sizes['i'][2:]),
            'ms': t_i[0], 'graph_ms': t_i[3], 'plain_ms': t_i[1],
            'bound_ms': b_i, 'bound_by': by, 'bound_set_by': t_i[2][0][3],
            'library_ms': None,
            **{part + '_graph_ms': v for part, v in t_i[4].items()},
            'ii_ms': t_ii[0], 'ii_graph_ms': t_ii[3],
            'ii_plain_ms': t_ii[1], 'ii_bound_ms': b_ii,
            **{'ii_' + part + '_graph_ms': v for part, v in t_ii[4].items()}})
    summary = {'card': card, 'batch': bs, 'shape': list(shape),
               'planes': {k: list(v) for k, v in sizes.items()},
               'step_ms': step_ms,
               'img_per_s': {k: bs * 1e3 / v for k, v in step_ms.items()},
               'runs': runs, 'fwd_err': fwd_err,
               'm_bit_equal_share': m_equal[0] / m_equal[1],
               'bwd_rel_err': bwd_err, 'function_rel_err': fn_err,
               'fp32_step_check': {'loss_rel': loss_rel,
                                   'kernels_vs_plain': grad_check,
                                   'plain_temperature_moved_vs_plain':
                                       temp_check},
               'kernel_times': summary_times, 'kernels': rows_out}
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_generic.json', 'w') as f:
        json.dump(summary, f, indent=1)
    return rows_out, {'generic_' + k: v for k, v in launches_by_run.items()}


def gather_phase(card, dev, gen, reset_counts, read_counts):
    """Phase Q: the lane-gather probes (see the module note). Returns the
    kernels-line rows of both kernels."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels import lane_gather as lg
    sys.path.insert(0, os.path.join(os.getcwd(), 'scripts'))
    import torch_bench_dynamic_gather as probe

    os.makedirs('chiprun_out', exist_ok=True)
    # the path: the probe's entry point, as a user runs it; it also times
    # each kernel at each of its shapes in a CUDA graph of raw launches,
    # which the counts do not see
    reset_counts()
    result = probe.run('cuda', GATHER_ITERS)
    got = read_counts()
    want = {k: 0 for k in got}
    want['gather'] = len(probe.SEMANTIC_SHAPES)
    want['gather_loop'] = len(probe.THROUGHPUT) * (1 + GATHER_ITERS)
    if got != want or not all(r['ok'] for r in result['semantics']):
        raise AssertionError('gather probe: launches {} (expected {}), '
                             'semantics {}'.format(got, want,
                                                   result['semantics']))
    launches = (got['gather'], got['gather_loop'])

    # both kernels against their plain versions, bit for bit: a gather
    # moves values, and the loop adds in the plain version's order
    cases = 0
    for S, L in probe.SEMANTIC_SHAPES + ((8, 512), (32, 512)):
        x = torch.randn(S, L, device=dev, generator=gen)
        idx = torch.randint(0, L, (S, L), device=dev, generator=gen,
                            dtype=torch.int32)
        out = lg.lane_gather(x, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, lg.lane_gather_reference(x, idx)):
            raise AssertionError('lane_gather [{},{}] differs from its plain '
                                 'version'.format(S, L))
        cases += 1
    for S in (8, 16, 32):
        for n in (0, 1, 5, 16, 512):
            x = torch.randn(S, 512, device=dev, generator=gen)
            idx = torch.randint(0, 128, (S, 512), device=dev, generator=gen,
                                dtype=torch.int32)
            out = lg.lane_gather_loop(x, idx, n)
            torch.cuda.synchronize()
            if not torch.equal(out, lg.lane_gather_loop_reference(x, idx, n)):
                raise AssertionError('lane_gather_loop S={} n={} differs '
                                     'from its plain version'.format(S, n))
            cases += 1
    log('lane-gather kernels vs plain: {} cases bit-equal; the probe path '
        'launched {} gathers and {} loops'.format(cases, *launches))

    # the kernels' device times are the probe's, from CUDA graphs (a
    # launch takes less time on the device than the wrapper takes to issue
    # it); the plain versions and torch.gather (the gather's yardstick) are
    # timed the same way on the probe's inputs
    rows = []
    for r in result['semantics']:
        S, L = r['S'], r['L']
        x, idx = probe.inputs(S, L, L, dev)
        idx64 = idx.long()
        bytes_ms = 12.0 * S * L / H100_BYTES_PER_S * 1e3
        rows.append({
            'kernel': 'gather', 'S': S, 'L': L, 'ms': r['graph_us'] * 1e-3,
            'plain_ms': probe.graph_time_ms(
                lambda: lg.lane_gather_reference(x, idx)),
            'library_ms': probe.graph_time_ms(
                lambda: torch.gather(x, 1, idx64)),
            'bytes_ms': bytes_ms, 'ops_ms': 0.0, 'bound_ms': bytes_ms})
    for r in result['throughput']:
        S, n = r['S'], r['n_gathers']
        x, idx = probe.inputs(S, 512, 128, dev)
        # bytes: x and idx once, out once; operations: the n S 128 fp32
        # adds of the sums (the four loads an output are in the bytes)
        bytes_ms = (8.0 * S * 512 + 4.0 * S * 128) / H100_BYTES_PER_S * 1e3
        ops_ms = n * S * 128 / H100_FP32_ADDS_PER_S * 1e3
        rows.append({
            'kernel': 'loop', 'S': S, 'n_gathers': n,
            'ms': r['graph_us'] * 1e-3,
            'plain_ms': probe.graph_time_ms(
                lambda: lg.lane_gather_loop_reference(x, idx, n), n=4),
            'bytes_ms': bytes_ms, 'ops_ms': ops_ms,
            'bound_ms': max(bytes_ms, ops_ms)})
    # the practical floor beside the bound: an empty kernel's device time
    # in a CUDA graph (torch.cuda._sleep(0), timed the same way) a launch,
    # and for the loop, if longer, the dependent chain of an output's n
    # adds: the loop kernel's graph time at n less its time at n = 0 on the
    # same inputs, both measured here in turns (n, 0, 0, n)
    empty_ms = probe.graph_time_ms(lambda: torch.cuda._sleep(0))
    for row in rows:
        row['floor_ms'] = empty_ms
        if row['kernel'] != 'loop':
            continue
        S, n = row['S'], row['n_gathers']
        x, idx = probe.inputs(S, 512, 128, dev)
        out = torch.empty(S, 128, device=dev)
        at = [probe.kernel_graph_us('lane_gather_loop', x, idx, out, k) * 1e-3
              for k in (n, 0, 0, n)]
        row['at_n_ms'], row['at_0_ms'] = (at[0] + at[3]) / 2, \
            (at[1] + at[2]) / 2
        row['chain_ms'] = row['at_n_ms'] - row['at_0_ms']
        row['floor_ms'] = max(empty_ms, row['chain_ms'])
    log('an empty kernel in a CUDA graph: {:.5f} ms a launch'.format(
        empty_ms))
    tot = {}
    for row in rows:
        t = tot.setdefault(row['kernel'], {})
        for k in ('ms', 'plain_ms', 'library_ms', 'bytes_ms', 'ops_ms',
                  'bound_ms', 'chain_ms', 'at_n_ms', 'at_0_ms', 'floor_ms'):
            if k in row:
                t[k] = t.get(k, 0.0) + row[k]
        log('{kernel} {shape}: in a CUDA graph kernel {ms:.5f} ms plain '
            '{plain_ms:.5f} library {lib}; bound {bound_ms:.3e} ms, floor '
            '{floor_ms:.5f}{chain}'.format(
                shape='[{},{}]'.format(row['S'], row.get('L', 512)) +
                (' n={}'.format(row['n_gathers']) if 'n_gathers' in row
                 else ''),
                lib='{:.5f}'.format(row['library_ms']) if 'library_ms' in row
                else 'none',
                chain=' (dependent chain {:.5f}: {:.5f} at n less {:.5f} at '
                '0)'.format(row['chain_ms'], row['at_n_ms'], row['at_0_ms'])
                if 'chain_ms' in row else '', **row))
    with open('chiprun_out/chip_smoke_gather.json', 'w') as f:
        json.dump({'card': card, 'probe': result, 'cases': cases,
                   'launches': launches, 'rows': rows, 'totals': tot,
                   'empty_kernel_graph_ms': empty_ms}, f, indent=1)
    g, lp = tot['gather'], tot['loop']
    return [{
        'name': 'lane_gather', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/lane_gather.cu',
        'replaces': 'scripts/bench_dynamic_gather.py:23',
        'launches': launches[0], 'max_abs_err': 0.0,
        'timed_as': 'one launch at each of [8,128], [8,256], [8,640], '
                    '[16,128], [32,128], device time in a CUDA graph',
        'ms': g['ms'], 'graph_ms': g['ms'], 'plain_ms': g['plain_ms'],
        'bound_ms': g['bound_ms'], 'bound_by': 'bytes',
        'floor_ms': g['floor_ms'], 'library_ms': g['library_ms']}, {
        'name': 'lane_gather_loop', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/lane_gather.cu',
        'replaces': 'scripts/bench_dynamic_gather.py:64',
        'launches': launches[1], 'max_abs_err': 0.0,
        'timed_as': 'one launch at each of S = 8 and S = 32, n = 512, '
                    'device time in a CUDA graph',
        'ms': lp['ms'], 'graph_ms': lp['ms'], 'plain_ms': lp['plain_ms'],
        'bound_ms': lp['bound_ms'],
        'bound_by': 'bytes' if lp['bytes_ms'] > lp['ops_ms']
        else 'operations', 'floor_ms': lp['floor_ms'],
        'chain_ms': lp['chain_ms'], 'library_ms': None}]


def cli_phase(card, dev, reset_counts, read_counts):
    """Phase C: the eval and inference CLIs from a checkpoint and a tree on
    disk (see the module note). Returns the eval CLI's masked-conv
    launches."""
    import tempfile
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import infer as port_infer
    from packnet_sfm_tpu_torch.config import parse_test_file
    from packnet_sfm_tpu_torch.datasets.io import load_image
    from packnet_sfm_tpu_torch.datasets.ncdb import write_ncdb_tree
    from torch.profiler import ProfilerActivity, profile
    from packnet_sfm_tpu_torch.datasets.transforms import resize_image
    from packnet_sfm_tpu_torch.ops.depth import (
        inv2depth, sigmoid_to_inv_depth)
    from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step
    from packnet_sfm_tpu_torch.trainers import trainer
    from packnet_sfm_tpu_torch.utils.checkpoint import save_checkpoint

    config, model = port_eval.build(CONFIG, 'cuda', seed=0)
    shape = port_eval.image_shape(config)
    summary = {'card': card, 'frames': CLI_FRAMES, 'shape': list(shape)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        frames = write_ncdb_tree(os.path.join(tmp, 'ncdb'), shape,
                                 CLI_FRAMES)
        summary['write_tree_s'] = time.perf_counter() - t0
        ckpt = save_checkpoint(os.path.join(tmp, 'model.ckpt'), config,
                               model)
        summary['checkpoint_mb'] = os.path.getsize(ckpt) / 2 ** 20
        overrides = ['datasets.test.path', [os.path.join(tmp, 'ncdb')],
                     'datasets.test.split', ['split.json'],
                     'datasets.test.input_depth_type', ['depth_original']]

        # the path: the eval CLI's entry point on the checkpoint
        reset_counts()
        t0 = time.perf_counter()
        metrics = port_eval.test(ckpt, overrides=overrides)
        torch.cuda.synchronize()
        summary['eval_cli_s'] = time.perf_counter() - t0
        got = read_counts()
        want = {k: 0 for k in got}
        want['san_fwd'] = CONVS_PER_FORWARD * CLI_FRAMES
        if got != want or metrics.skipped:
            raise AssertionError('eval CLI: launches {} (expected {}), {} '
                                 'batches skipped'.format(got, want,
                                                          metrics.skipped))
        if len(metrics) != 6 * 7 + 1 or not all(
                np.isfinite(v) for v in metrics.values()):
            raise AssertionError('eval CLI metrics: {}'.format(metrics))

        # the same loader through `evaluate` with the in-memory model
        tconfig, _ = parse_test_file(ckpt, overrides=overrides)
        t0 = time.perf_counter()
        direct = trainer.evaluate(tconfig, model,
                                  trainer.make_loader(tconfig, 'test'))
        torch.cuda.synchronize()
        summary['eval_loop_s'] = time.perf_counter() - t0
        err = max(abs(metrics[k] - direct[k]) for k in direct)
        if sorted(direct) != sorted(metrics) or err > 1e-4:
            raise AssertionError('eval CLI vs in-memory evaluate: max |err| '
                                 '{:.3e}'.format(err))
        summary['cli_vs_memory_max_err'] = err

        # where the loop's time goes: host decode per frame (read, decode,
        # test transforms) on one thread, and the device's kernel time
        # over one more pass of the same loop under torch.profiler, against
        # that pass's wall time (the device's busy share of the loop)
        ds = trainer.make_loader(tconfig, 'test').dataset
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        summary['decode_ms_per_frame'] = (time.perf_counter() - t0) * 1e3 / \
            len(ds)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.evaluate(tconfig, model,
                             trainer.make_loader(tconfig, 'test'))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(ev.device_time_total for ev in prof.events()
                        if ev.device_type == torch.autograd.DeviceType.CUDA
                        ) * 1e-3
        if device_ms <= 0:
            raise AssertionError('the profiler saw no device time in the '
                                 'eval loop')
        summary['profiled_loop_ms'] = wall_ms
        summary['device_ms_per_frame'] = device_ms / CLI_FRAMES
        summary['loop_device_busy_share'] = device_ms / wall_ms
        summary['eval_cli_img_s'] = CLI_FRAMES / summary['eval_cli_s']
        summary['eval_loop_img_s'] = CLI_FRAMES / summary['eval_loop_s']

        # the inference CLI on the frame folder: RGB only, no kernel launch
        out_dir = os.path.join(tmp, 'infer')
        reset_counts()
        t0 = time.perf_counter()
        port_infer.infer_and_save_depth(ckpt, frames, out_dir,
                                        image_shape=shape, save=('npz',))
        torch.cuda.synchronize()
        summary['infer_cli_s'] = time.perf_counter() - t0
        summary['infer_cli_img_s'] = CLI_FRAMES / summary['infer_cli_s']
        got = read_counts()
        if any(got.values()):
            raise AssertionError('infer CLI launched kernels: {}'.format(got))
        forward = make_eval_step(model)
        params = config.model.params
        derr = 0.0
        for name in sorted(os.listdir(frames)):
            rgb = resize_image(load_image(os.path.join(frames, name)), shape)
            sig = forward({'rgb': torch.from_numpy(rgb[None]).to(dev)})
            want = inv2depth(sigmoid_to_inv_depth(
                sig['inv_depths'][0][0].float(), params.min_depth,
                params.max_depth, params.use_log_space))[..., 0].cpu()
            saved = torch.from_numpy(np.load(os.path.join(
                out_dir, name[:-4] + '.npz'))['depth'])
            torch.testing.assert_close(saved, want, rtol=1e-5, atol=0)
            derr = max(derr, float((saved - want).abs().max()))
        summary['infer_vs_forward_max_err_m'] = derr
    log('eval CLI B1 {}x{} {} from a checkpoint on disk: {} frames in '
        '{:.3f} s = {:.2f} img/s (checkpoint load and model build '
        'included), the loop alone {:.2f} img/s; {} masked-conv launches, '
        '0 skipped; vs in-memory evaluate max |err| {:.2e}; depth-abs_rel '
        '{:.4f}'.format(shape[0], shape[1], config.tpu.compute_dtype,
                        CLI_FRAMES, summary['eval_cli_s'],
                        summary['eval_cli_img_s'], summary['eval_loop_img_s'],
                        CONVS_PER_FORWARD * CLI_FRAMES, err,
                        metrics['depth-abs_rel']))
    log('eval loop: host decode {:.2f} ms a frame on one thread; under the '
        'profiler device {:.3f} ms a frame over {:.3f} ms of loop, busy '
        'share {:.3f}; infer CLI {:.2f} img/s, its depth vs the eval forward '
        'max |err| {:.2e} m'.format(
            summary['decode_ms_per_frame'], summary['device_ms_per_frame'],
            summary['profiled_loop_ms'], summary['loop_device_busy_share'],
            summary['infer_cli_img_s'], derr))
    with open('chiprun_out/chip_smoke_cli.json', 'w') as f:
        json.dump(summary, f, indent=1)
    return CONVS_PER_FORWARD * CLI_FRAMES


class EpochRecorder:
    """A logger for Trainer.fit: every per-epoch metrics dict, and how many
    image sets it was handed."""

    def __init__(self):
        self.history = {}
        self.images = 0

    def log_metrics(self, metrics, step=None):
        self.history.setdefault(int(step), {}).update(metrics)

    def log_images(self, *args, **kwargs):
        self.images += 1


def overfit_step_check(overrides, batch):
    """One float32 step of configs/overfit_synthetic.yaml under `overrides`
    on `batch` (one batch of its train loader, on the card: the path's own
    shapes) through the kernels against every plain version
    (`kernel_step_check`), the photometric maps in float32 too (on the path
    they are bf16 plain code, no kernel). Returns the readings."""
    readings, _ = kernel_step_check(
        'overfit', OVERFIT_CONFIG, overrides + ['tpu.photometric_dtype',
                                                'float32'], batch,
        {'san_fwd': CONVS_PER_FORWARD, 'san_dgrad': DGRADS_PER_STEP,
         'warp_out': WARPS_PER_STEP, 'warp_dgrid': WARPS_PER_STEP})
    return readings


def train_disk_phase(card, reset_counts, read_counts):
    """Phase T: training from disk (see the module note). Returns
    {run: launch counts} of the runs through Trainer.fit."""
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import (
        parse_train_config, parse_train_file)
    from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
    from packnet_sfm_tpu_torch.datasets.ncdb import write_ncdb_tree
    from packnet_sfm_tpu_torch.datasets.transforms import TrainTransform
    from packnet_sfm_tpu_torch.trainers import trainer as trainer_mod
    from packnet_sfm_tpu_torch.trainers.trainer import (
        Trainer, make_loader, seeded_model)
    from packnet_sfm_tpu_torch.utils.checkpoint import load_weights

    summary = {'card': card, 'train_frames': TRAIN_FRAMES,
               'val_frames': VAL_FRAMES}
    launches = {}

    def expect(run, got, steps, val_forwards, warps=0):
        want = dict.fromkeys(got, 0)
        want.update(san_fwd=CONVS_PER_FORWARD * (steps + val_forwards),
                    san_dgrad=DGRADS_PER_STEP * steps,
                    warp_out=warps * steps, warp_dgrid=warps * steps)
        if got != want:
            raise AssertionError('{}: launches {}, expected {}'.format(
                run, got, want))
        launches[run] = got

    def check_steps(run, trainer, steps, updates=None):
        """`steps` steps run, and `updates` (by default `steps`) applied
        by the optimizer: no loss skipped."""
        updates = steps if updates is None else updates
        if trainer.step != steps or trainer.optimizer.count != updates:
            raise AssertionError('{}: {} steps, {} updates, expected {} and '
                                 '{} (a step skipped?)'.format(
                                     run, trainer.step,
                                     trainer.optimizer.count, steps, updates))

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'ncdb')
        t0 = time.perf_counter()
        write_ncdb_tree(root, (384, 640), TRAIN_FRAMES + VAL_FRAMES,
                        splits={'train.json': range(TRAIN_FRAMES),
                                'val.json': range(TRAIN_FRAMES,
                                                  TRAIN_FRAMES + VAL_FRAMES)})
        summary['write_tree_s'] = time.perf_counter() - t0
        data = ['datasets.train.path', [root],
                'datasets.train.split', ['train.json'],
                'datasets.train.input_depth_type', ['depth_original'],
                'datasets.validation.path', [root],
                'datasets.validation.split', ['val.json'],
                'datasets.validation.input_depth_type', ['depth_original']]
        ck = os.path.join(tmp, 'ckpts')
        main_run = data + [
            'arch.max_epochs', DISK_EPOCHS, 'arch.eval_during_training',
            True, 'arch.eval_progress_interval', 0.5,
            'arch.eval_subset_size', VAL_FRAMES, 'checkpoint.filepath', ck,
            'checkpoint.save_every_n_steps', 2]

        # the path: train.py's loader-driven entry on the YAML, a
        # mid_epoch.ckpt every 2 steps (the one at step 2 of epoch 1 kept
        # aside), a quick eval each epoch; the stale mid_epoch.ckpt must be
        # gone when the next epoch saves its first
        kept = {}
        real_save = trainer_mod.save_checkpoint

        def capture(path, *args, extra=None, **kwargs):
            consumed = extra['loader']['batches_consumed']
            if os.path.exists(path) != (consumed > 2):
                raise AssertionError('mid_epoch.ckpt at {} batches: stale '
                                     'file {}'.format(consumed,
                                                      os.path.exists(path)))
            out = real_save(path, *args, extra=extra, **kwargs)
            if extra['loader'] == {'epoch': 1, 'batches_consumed': 2}:
                kept['path'] = shutil.copy(path, os.path.join(
                    tmp, 'kept_mid_epoch.ckpt'))
            return out

        logger = EpochRecorder()
        trainer_mod.save_checkpoint = capture
        reset_counts()
        t0 = time.perf_counter()
        try:
            trainer = port_train.fit(CONFIG, 'cuda', main_run, logger=logger)
            torch.cuda.synchronize()
        finally:
            trainer_mod.save_checkpoint = real_save
        summary['fit_s'] = time.perf_counter() - t0
        got = read_counts()
        steps_per_epoch = TRAIN_FRAMES // int(
            trainer.config.datasets.train.batch_size)
        steps = DISK_EPOCHS * steps_per_epoch
        # per epoch: the validation, one quick eval of VAL_FRAMES (RGB +
        # LiDAR; the RGB-only forward runs no masked conv), one logged
        # image batch; B1
        expect('train_disk', got, steps, DISK_EPOCHS * (2 * VAL_FRAMES + 1))
        check_steps('train_disk', trainer, steps)
        losses = [logger.history[e]['train/loss'] for e in range(DISK_EPOCHS)]
        if not all(np.isfinite(losses)) or logger.images != 2 * DISK_EPOCHS:
            raise AssertionError('train from disk: losses {}, {} image '
                                 'sets'.format(losses, logger.images))
        run_dir = os.path.dirname(trainer.config.checkpoint.filepath)
        ckpts = sorted(f for f in os.listdir(run_dir) if f.endswith('.ckpt'))
        if [c[:3] for c in ckpts] != ['{:02d}_'.format(e)
                                      for e in range(DISK_EPOCHS)]:
            raise AssertionError('top-k checkpoints: {}'.format(ckpts))
        for e in range(DISK_EPOCHS):
            with open(os.path.join(run_dir, 'evaluation_results',
                                   'epoch_{}_results.json'.format(e))) as f:
                metrics = json.load(f)
            if len(metrics) != 6 * 7 + 1 or not all(
                    np.isfinite(v) for v in metrics.values()):
                raise AssertionError('epoch {} eval JSON: {}'.format(
                    e, metrics))
        summary['train_disk'] = {
            'losses': losses, 'checkpoints': ckpts,
            'val_abs_rel': [logger.history[e]['val/depth-abs_rel']
                            for e in range(DISK_EPOCHS)],
            'epochs': {e: {k: v for k, v in logger.history[e].items()
                           if k.startswith('train/')}
                       for e in range(DISK_EPOCHS)}}
        log('train.fit from disk B{} 384x640 bf16: {} epochs of {} steps '
            'in {:.1f} s, launches {} forward / {} dgrad, epoch losses {}, '
            'val abs_rel {}; checkpoints {}'.format(
                trainer.config.datasets.train.batch_size, DISK_EPOCHS,
                steps_per_epoch, summary['fit_s'], got['san_fwd'],
                got['san_dgrad'], ['{:.4f}'.format(v) for v in losses],
                ['{:.4f}'.format(v) for v in
                 summary['train_disk']['val_abs_rel']], ckpts))
        want_params = {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}
        del trainer

        # resume from the mid_epoch.ckpt of step 2 of epoch 1: exactly the
        # 2 remaining steps, the validation and one quick eval. Its update
        # (the parameters after the 2 steps less the checkpoint's) against
        # the uninterrupted run's, per leaf at the train step's limits; the
        # control resumes from the same file without its Adam state, which
        # must fail that check
        config, payload = parse_train_file(kept['path'])
        start = {n: p.detach().to(want_params[n].device) for n, p in
                 load_weights(seeded_model(config, 0),
                              payload).named_parameters()}
        want_update = {n: want_params[n] - start[n] for n in start}

        def resume(path, run, updates):
            reset_counts()
            resumed = port_train.fit(path, 'cuda', [
                'checkpoint.filepath', os.path.join(tmp, run, '{epoch}')])
            got = read_counts()
            expect(run, got, steps - payload['step'], 2 * VAL_FRAMES)
            check_steps(run, resumed, steps, updates)
            return compare_grads({n: p.detach() - start[n] for n, p in
                                  resumed.model.named_parameters()},
                                 want_update)

        rel, worst, norm, zero = resume(kept['path'], 'resume', steps)
        no_adam = os.path.join(tmp, 'kept_no_adam_state.ckpt')
        with open(no_adam, 'wb') as f:
            pickle.dump({k: v for k, v in payload.items()
                         if k != 'adam_state'}, f)
        # a fresh optimizer counts from 0
        c_rel, c_worst, c_norm, c_zero = resume(no_adam, 'resume_control',
                                                steps - payload['step'])
        del launches['resume_control']
        summary['resume'] = {
            'from_step': payload['step'], 'update_max_rel': rel, 'at': worst,
            'update_norm_rel': norm, 'zero_leaves': zero,
            'control_without_adam_state': {
                'update_max_rel': c_rel, 'at': c_worst,
                'update_norm_rel': c_norm, 'zero_leaves': c_zero}}
        log('resumed from mid_epoch.ckpt at step {} of {}: {} steps, its '
            'update vs the uninterrupted run\'s per leaf max|err|/max|u| '
            '{:.3e} (at {}), |err|/|u| {:.3e}, zero leaves {:.2e}; the '
            'control without Adam state: {:.3e} (at {}), {:.3e}, '
            '{:.2e}'.format(payload['step'], steps, steps - payload['step'],
                            rel, worst, norm, zero, c_rel, c_worst, c_norm,
                            c_zero))
        if rel > TRAIN_GRAD_REL or norm > TRAIN_GRAD_NORM or zero > 1e-6:
            raise AssertionError('the resumed run disagrees with the '
                                 'uninterrupted one')
        if c_rel <= TRAIN_GRAD_REL and c_norm <= TRAIN_GRAD_NORM:
            raise AssertionError('the resume check passes a resume that '
                                 'dropped the Adam state')
        del want_params, start, want_update

        # the overfit config through the same loop, PoseNet over 2 contexts;
        # as written it feeds no input depth and has no FiLM, so its depth
        # net runs no SAN branch: here the Synthetic frames carry their
        # sparse input depth and FiLM is on, which adds the masked convs
        logger = EpochRecorder()
        overfit = ['model.depth_net.use_film', True,
                   'datasets.train.input_depth_type', ['depth'],
                   'datasets.validation.input_depth_type', ['depth']]
        reset_counts()
        over = port_train.fit(OVERFIT_CONFIG, 'cuda', [
            'arch.max_epochs', OVERFIT_EPOCHS, 'checkpoint.filepath', ''] +
            overfit, logger=logger)
        got = read_counts()
        loader = make_loader(over.config, 'train')
        n_val = len(make_loader(over.config, 'validation'))
        o_steps = OVERFIT_EPOCHS * len(loader)
        expect('overfit', got, o_steps, OVERFIT_EPOCHS * (n_val + 1),
               warps=WARPS_PER_STEP)
        check_steps('overfit', over, o_steps)
        o_losses = [logger.history[e]['train/loss']
                    for e in range(OVERFIT_EPOCHS)]
        summary['overfit'] = {'losses': o_losses, 'val_abs_rel': [
            logger.history[e]['val/depth-abs_rel']
            for e in range(OVERFIT_EPOCHS)]}
        log('overfit_synthetic through Trainer.fit: {} epochs of {} steps, '
            'launches {}, epoch losses {}'.format(
                OVERFIT_EPOCHS, len(loader), {k: v for k, v in got.items()
                                              if v},
                ['{:.4f}'.format(v) for v in o_losses]))
        if not (all(np.isfinite(o_losses)) and o_losses[-1] < o_losses[0]):
            raise AssertionError('overfit loss did not fall: {}'.format(
                o_losses))
        summary['overfit']['fp32_step'] = overfit_step_check(
            overfit, to_device_batch(next(iter(loader)), over.device))
        del over

        # the rates: the YAML's loader (host jitter) and tpu.device_augment,
        # 3 and 2 epochs without validation or checkpoints; epoch 1 timed,
        # epoch 2 of the first under torch.profiler for the busy share
        class Profiled(Trainer):
            def train_epoch(self, loader, val_loader, epoch):
                if epoch != 2:
                    return super().train_epoch(loader, val_loader, epoch)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out = super().train_epoch(loader, val_loader, epoch)
                    torch.cuda.synchronize()
                    self.profiled_wall_ms = (time.perf_counter() - t0) * 1e3
                self.profiled_device_ms = sum(
                    ev.device_time_total for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                ) * 1e-3
                return out

        rates = {}
        for name, extra, epochs in (('host_jitter', [], 3),
                                    ('device_augment',
                                     ['tpu.device_augment', True], 2)):
            cfg = parse_train_config(CONFIG, data + extra + [
                'arch.max_epochs', epochs, 'arch.eval_during_training',
                False, 'checkpoint.filepath', ''])
            cfg.datasets.validation.dataset = []
            logger = EpochRecorder()
            reset_counts()
            run = Profiled(cfg, logger=logger, device='cuda').fit()
            got = read_counts()
            expect(name, got, epochs * steps_per_epoch, 0)
            check_steps(name, run, epochs * steps_per_epoch)
            rates[name] = {k[len('train/'):]: v
                           for k, v in logger.history[1].items()}
            if epochs == 3:
                if run.profiled_device_ms <= 0:
                    raise AssertionError('the profiler saw no device time '
                                         'in the epoch')
                rates[name]['profiled_epoch_wall_ms'] = run.profiled_wall_ms
                rates[name]['profiled_epoch_device_ms'] = \
                    run.profiled_device_ms
                rates[name]['device_busy_share'] = \
                    run.profiled_device_ms / run.profiled_wall_ms
            log('{} (epoch 1 of {}): {:.2f} img/s with data, data {:.1f} ms '
                '| step {:.1f} ms a step, input-bound {:.3f}{}; {}'.format(
                    name, epochs, rates[name]['img_per_s'],
                    rates[name]['data_ms_per_step'],
                    rates[name]['step_ms_per_step'],
                    rates[name]['data_fraction'],
                    '; epoch 2 under the profiler: device {:.1f} ms over '
                    '{:.1f} ms, busy share {:.3f}'.format(
                        run.profiled_device_ms, run.profiled_wall_ms,
                        rates[name]['device_busy_share'])
                    if epochs == 3 else '', card))
            del run
        summary['rates'] = rates

        # the host's work a sample on one thread: read and decode (no
        # transform), the train transform with and without the jitter
        ds = make_loader(parse_train_config(CONFIG, data), 'train').dataset
        keep = ds.transform
        ds.transform = None
        samples, t0 = [], time.perf_counter()
        for i in range(min(16, len(ds))):
            samples.append(ds[i])
        host = {'decode_ms': (time.perf_counter() - t0) * 1e3 / len(samples)}
        for name, t in (('transform_jitter_ms', keep),
                        ('transform_no_jitter_ms', TrainTransform(
                            keep.image_shape, (), keep.crop_train_borders))):
            t0 = time.perf_counter()
            for smp in samples:
                t({k: (dict(v) if isinstance(v, dict) else v.copy()
                       if isinstance(v, np.ndarray) else v)
                   for k, v in smp.items()})
            host[name] = (time.perf_counter() - t0) * 1e3 / len(samples)
        summary['host_ms_per_sample'] = host
        log('host, one thread, a 384x640 NCDB sample: read and decode '
            '{:.2f} ms, train transform with jitter {:.2f} ms, without '
            '{:.2f} ms; {}'.format(host['decode_ms'],
                                   host['transform_jitter_ms'],
                                   host['transform_no_jitter_ms'], card))
    summary['launches'] = launches
    with open('chiprun_out/chip_smoke_train_disk.json', 'w') as f:
        json.dump(summary, f, indent=1)
    return launches


def san_conv_counts():
    """The masked-conv kernels' launch counts, by the kernels line's keys."""
    from packnet_sfm_tpu_torch.ops.kernels import san_conv
    return {'san_fwd': san_conv.masked_conv2d.launches,
            'san_dgrad': san_conv.masked_conv2d_dgrad.launches}


def qat_step_readings(model, batch, plain):
    """One float32 step of a dual-head `model` under QAT on weights and
    outputs (the train step's forward: the model over its int8
    fake-quantized depth-net kernels, parallel/train_step.py) on `batch`,
    through the kernels or (plain) through every plain version under
    plain autograd, from the model's current statistics, which it puts
    back after: (loss, gradients by leaf, the SAN's MaskedBatchNorm
    statistics after the step, the loss heads' u8 codes)."""
    import torch
    from packnet_sfm_tpu_torch.ops.quantization import (
        fake_quant_u8, quantize_depth_net_params)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    model.zero_grad(set_to_none=True)
    with plain_versions() if plain else contextlib.nullcontext():
        out = torch.func.functional_call(
            model, quantize_depth_net_params(model), (batch,))
        out['loss'].backward()
    grads = {n: p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p) for n, p in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.named_buffers()
             if k.startswith('depth_net.mconvs.') and
             k.endswith(('.mean', '.var'))}
    codes = {k: torch.round(fake_quant_u8(out[(k, 0)].detach()) * 255.0)
             for k in ('integer', 'fractional')}
    loss = float(out['loss'].detach())
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(buffers[k])
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return loss, grads, stats, codes


def stats_rel(got, want):
    """max over leaves of max|got - want| / max|want|, and the leaf."""
    worst, at = 0.0, ''
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
        if err > worst:
            worst, at = err, k
    return worst, at


def dual_step_rate(qat, batch, n_timed=5):
    """(ms a step, kernels the card runs a step) of the dual-head YAML's
    train step (B8 384x640 bf16) on a batch held on the card, under
    model.params.qat `qat`: 4 steps of warm-up, `n_timed` timed, one
    more under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from packnet_sfm_tpu_torch import train as port_train
    run = port_train.main(DUAL_CONFIG, batch['rgb'].device, n_steps=2,
                          seed=0,
                          overrides=['model.params.qat', qat],
                          batches=[batch])
    step = run['trainer'].train_step
    ms = step_alone_ms(step, batch, n_timed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return ms, kernels


def dual_head_phase(card, dev, reset_counts, read_counts):
    """Phase D: the dual-head INT8 slice (see the module note). Returns
    {run: launch counts} of the runs through the entry points."""
    import copy
    import shutil
    import tempfile
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import infer as port_infer
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import (
        parse_test_file, parse_train_config)
    from packnet_sfm_tpu_torch.datasets.io import load_image
    from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
    from packnet_sfm_tpu_torch.datasets.ncdb import write_ncdb_tree
    from packnet_sfm_tpu_torch.datasets.transforms import resize_image
    from packnet_sfm_tpu_torch.models.factory import setup_model
    from packnet_sfm_tpu_torch.ops.depth import dual_head_to_depth
    from packnet_sfm_tpu_torch.ops.quantization import (
        quantize_depth_net_params)
    from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step
    from packnet_sfm_tpu_torch.trainers.trainer import Trainer, make_loader
    from packnet_sfm_tpu_torch.utils.checkpoint import load_weights

    yaml = parse_train_config(DUAL_CONFIG)
    shape = tuple(yaml.datasets.augmentation.image_shape)
    bs = int(yaml.datasets.train.batch_size)
    summary = {'card': card, 'train_frames': DUAL_TRAIN_FRAMES,
               'val_frames': DUAL_VAL_FRAMES, 'shape': list(shape),
               'batch': bs}
    launches = {}
    qat = ['model.params.qat', 'weights+outputs']

    def expect(run, got, steps, forwards):
        want = dict.fromkeys(got, 0)
        want['san_fwd'] = CONVS_PER_FORWARD * (steps + forwards)
        if got != want:
            raise AssertionError('{}: launches {}, expected {}'.format(
                run, got, want))
        launches[run] = got

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'ncdb')
        n = DUAL_TRAIN_FRAMES + DUAL_VAL_FRAMES
        frames = write_ncdb_tree(root, shape, n, splits={
            'train.json': range(DUAL_TRAIN_FRAMES),
            'val.json': range(DUAL_TRAIN_FRAMES, n)})
        data = ['datasets.train.path', [root],
                'datasets.train.split', ['train.json'],
                'datasets.validation.path', [root],
                'datasets.validation.split', ['val.json'],
                'datasets.validation.input_depth_type', ['depth_original'],
                'arch.eval_during_training', False]
        ck = os.path.join(tmp, 'ckpts')

        # the path: train.py's entry on the dual-head YAML under QAT on
        # weights and outputs, validated on the int8 weights each epoch;
        # a step runs the SAN once (the RGB+D pass) and no gradient
        # reaches it: no dgrad launch
        logger = EpochRecorder()
        reset_counts()
        t0 = time.perf_counter()
        trainer = port_train.fit(DUAL_CONFIG, dev, data + qat + [
            'arch.max_epochs', DUAL_EPOCHS, 'checkpoint.filepath', ck],
            logger=logger)
        torch.cuda.synchronize()
        summary['fit_s'] = time.perf_counter() - t0
        got = read_counts()
        steps_per_epoch = DUAL_TRAIN_FRAMES // bs
        steps = DUAL_EPOCHS * steps_per_epoch
        # a validation forward a frame (B1) and, each epoch, the logged
        # images' forward (a dual-head model then logs nothing)
        expect('dual_head_train', got, steps,
               DUAL_EPOCHS * (DUAL_VAL_FRAMES + 1))
        losses = [logger.history[e]['train/loss'] for e in range(DUAL_EPOCHS)]
        if trainer.step != steps or trainer.optimizer.count != steps or \
                not all(np.isfinite(losses)) or logger.images:
            raise AssertionError('dual-head fit: {} steps, {} updates, '
                                 'losses {}, {} image sets'.format(
                                     trainer.step, trainer.optimizer.count,
                                     losses, logger.images))
        run_dir = os.path.dirname(trainer.config.checkpoint.filepath)
        ckpts = sorted(f for f in os.listdir(run_dir) if f.endswith('.ckpt'))
        if len(ckpts) != DUAL_EPOCHS:
            raise AssertionError('dual-head checkpoints: {}'.format(ckpts))
        ckpt = os.path.join(run_dir, ckpts[-1])
        rates = {'weights+outputs': logger.history[DUAL_EPOCHS - 1]}
        summary['fit'] = {'losses': losses, 'checkpoints': ckpts,
                          'val_abs_rel': [logger.history[e]['val/abs_rel']
                                          for e in range(DUAL_EPOCHS)]}
        log('dual head, train.fit B{} {}x{} {} under QAT weights+outputs: '
            '{} epochs of {} steps in {:.1f} s, launches {} forward / {} '
            'dgrad (a step: {} forward, 0 dgrad), epoch losses {}, val '
            'abs_rel on the int8 weights {}'.format(
                bs, shape[0], shape[1], yaml.tpu.compute_dtype,
                DUAL_EPOCHS, steps_per_epoch, summary['fit_s'],
                got['san_fwd'], got['san_dgrad'], CONVS_PER_FORWARD,
                ['{:.4f}'.format(v) for v in losses],
                ['{:.4f}'.format(v) for v in summary['fit']['val_abs_rel']]))
        batch = to_device_batch(next(iter(make_loader(trainer.config,
                                                      'train'))), dev)
        del trainer

        # the rate with data without QAT (same loader, no validation)
        cfg = parse_train_config(DUAL_CONFIG, data + [
            'arch.max_epochs', DUAL_EPOCHS, 'checkpoint.filepath', ''])
        cfg.datasets.validation.dataset = []
        logger = EpochRecorder()
        Trainer(cfg, logger=logger, device=dev).fit()
        rates[''] = logger.history[DUAL_EPOCHS - 1]
        alone = {q: dual_step_rate(q, batch) for q in ('', 'weights+outputs')}
        summary['rates'] = {q: {
            'img_per_s_with_data': rates[q]['train/img_per_s'],
            'data_ms_per_step': rates[q]['train/data_ms_per_step'],
            'step_ms_per_step': rates[q]['train/step_ms_per_step'],
            'step_alone_ms': alone[q][0],
            'img_per_s_step_alone': bs * 1e3 / alone[q][0],
            'device_kernels_a_step': alone[q][1]} for q in alone}
        for q, r in summary['rates'].items():
            log('dual head B{} {}x{} {}, qat {!r}: {:.2f} img/s with data '
                '(epoch {}: data {:.1f} ms | step {:.1f} ms a step), the step '
                'alone {:.2f} ms = {:.2f} img/s, {} kernels on the card a '
                'step; {}'.format(bs, shape[0], shape[1],
                                  yaml.tpu.compute_dtype, q,
                                  r['img_per_s_with_data'],
                                  DUAL_EPOCHS - 1, r['data_ms_per_step'],
                                  r['step_ms_per_step'], r['step_alone_ms'],
                                  r['img_per_s_step_alone'],
                                  r['device_kernels_a_step'], card))
        added = summary['rates']['weights+outputs'][
            'device_kernels_a_step'] - summary['rates']['']['device_kernels_a_step']
        summary['qat_added_kernels_a_step'] = added
        log('QAT on weights and outputs adds {} kernels a step (the '
            'per-channel weight quantizer over the depth net\'s kernels and '
            'the u8 output quantizer, forward and backward)'.format(added))

        # one float32 step under QAT at B8 384x640 through the kernels
        # against the plain versions, with the reversed batch as control;
        # the kernel's output lands only in the SAN's MaskedBatchNorm
        # statistics (the RGB+D pass feeds no loss), compared too, and the
        # loss heads' u8 codes
        _, fmodel = port_train.build(DUAL_CONFIG, dev, seed=0, overrides=[
            'tpu.compute_dtype', 'float32'] + qat)
        before = san_conv_counts()
        k_loss, gk, sk, ck_codes = qat_step_readings(fmodel, batch, False)
        launched = {k: v - before[k] for k, v in san_conv_counts().items()}
        p_loss, gp, sp, cp_codes = qat_step_readings(fmodel, batch, True)
        _, gr, sr, _ = qat_step_readings(fmodel, reversed_batch(batch), True)
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        grad_check = compare_grads(gk, gp)
        order_check = compare_grads(gr, gp)
        stat_check = stats_rel(sk, sp)
        stat_order = stats_rel(sr, sp)
        flips = {k: int((ck_codes[k] != cp_codes[k]).sum())
                 for k in ck_codes}
        max_step = max(float((ck_codes[k] - cp_codes[k]).abs().max())
                       for k in ck_codes)
        summary['fp32_qat_step'] = {
            'loss_rel': loss_rel, 'grad': grad_check, 'launches': launched,
            'plain_reversed_batch_vs_plain': order_check,
            'san_stats_rel': stat_check, 'san_stats_reversed': stat_order,
            'u8_codes_differing': flips, 'u8_max_code_step': max_step}
        log('dual-head QAT step fp32 B{} {}x{}, kernels vs plain: loss '
            '{:.6f} vs {:.6f} (rel {:.2e}); per gradient leaf max|err|/max|g| '
            '{:.3e} (at {}), |err|/|g| {:.3e}, zero leaves {:.2e}; launches '
            '{}; SAN MaskedBatchNorm statistics max|err|/max {:.3e} (at {}); '
            'u8 codes differing {} (at most {} step). Plain vs plain on the '
            'reversed batch: {:.3e} (at {}), {:.3e}, {:.2e}; statistics '
            '{:.3e}'.format(bs, shape[0], shape[1], k_loss, p_loss, loss_rel,
                            *grad_check, launched,
                            *stat_check, flips, max_step, *order_check,
                            stat_order[0]))
        rel, _, norm, zero = grad_check
        if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
                norm > TRAIN_GRAD_NORM or zero > 1e-6 or \
                stat_check[0] > DUAL_STATS_REL or max_step > 1 or \
                launched != {'san_fwd': CONVS_PER_FORWARD, 'san_dgrad': 0}:
            raise AssertionError('the dual-head QAT step through the kernels '
                                 'disagrees with the plain versions')

        # the int8 weights on the card equal the CPU's bit for bit
        q_card = quantize_depth_net_params(fmodel)
        q_cpu = quantize_depth_net_params(copy.deepcopy(fmodel).cpu())
        differ = [k for k in q_card if not torch.equal(q_card[k].cpu(),
                                                       q_cpu[k])]
        summary['int8_weights_card_vs_cpu'] = {'kernels': len(q_card),
                                               'differing': differ}
        log('int8 fake-quantized depth-net kernels, card vs CPU: {} of {} '
            'differ'.format(len(differ), len(q_card)))
        if differ or not q_card:
            raise AssertionError('int8 weights differ on the card: {}'.format(
                differ))
        del fmodel, q_card, q_cpu

        # the eval CLI with --int8 --int8-weights on the fit's checkpoint,
        # on the validation frames with LiDAR; float32 through the kernels
        # and through the plain versions; the float eval beside it
        over = ['datasets.test.path', [root], 'datasets.test.split',
                ['val.json'], 'datasets.test.input_depth_type',
                ['depth_original']]
        reset_counts()
        int8 = port_eval.test(ckpt, int8=True, int8_weights=True,
                              device=dev, overrides=over)
        got = read_counts()
        expect('dual_head_eval', got, 0, DUAL_VAL_FRAMES)
        # the float eval: a QAT-on-weights model is otherwise validated on
        # its int8 weights
        fp = port_eval.test(ckpt, device=dev,
                            overrides=over + ['model.params.qat', ''])
        cost = int8['depth-abs_rel'] - fp['depth-abs_rel']
        f32 = over + ['tpu.compute_dtype', 'float32']
        k8 = port_eval.test(ckpt, int8=True, int8_weights=True, device=dev,
                            overrides=f32)
        with plain_versions():
            p8 = port_eval.test(ckpt, int8=True, int8_weights=True,
                                device=dev, overrides=f32)
        err = max(abs(k8[k] - p8[k]) for k in p8)
        summary['int8_eval'] = {'int8': dict(int8), 'float': dict(fp),
                                'int8_abs_rel_cost': cost,
                                'fp32_kernels_vs_plain_max_err': err}
        for name, m in (('int8', int8), ('float', fp), ('fp32 int8', k8)):
            if len(m) != 2 * 7 + 1 or m.skipped or not all(
                    np.isfinite(v) for v in m.values()):
                raise AssertionError('dual-head {} eval: {}'.format(name, m))
        log('dual-head eval CLI --int8 --int8-weights ({} frames with LiDAR, '
            '{}): abs_rel {:.4f}, float {:.4f}: the INT8 cost {:+.4f} '
            'abs_rel; {} masked-conv launches; fp32 through the kernels vs '
            'the plain versions max |err| {:.3e} over the metrics'.format(
                DUAL_VAL_FRAMES, yaml.tpu.compute_dtype,
                int8['depth-abs_rel'], fp['depth-abs_rel'],
                cost, got['san_fwd'], err))
        if sorted(k8) != sorted(p8) or err > 1e-4:
            raise AssertionError('int8 eval through the kernels disagrees '
                                 'with the plain versions')

        # the inference CLI on two frames with the dual-head checkpoint: RGB
        # only, no kernel launch; its depth against the eval forward's
        two = os.path.join(tmp, 'two')
        os.makedirs(two)
        names = sorted(os.listdir(frames))[:2]
        for name in names:
            shutil.copy(os.path.join(frames, name), two)
        out_dir = os.path.join(tmp, 'infer')
        reset_counts()
        port_infer.infer_and_save_depth(ckpt, two, out_dir, image_shape=shape,
                                        save=('npz',), device=dev)
        got = read_counts()
        if any(got.values()):
            raise AssertionError('infer CLI launched kernels: {}'.format(got))
        config, state = parse_test_file(ckpt)
        model = load_weights(setup_model(config), state).to(dev).eval()
        forward = make_eval_step(model)
        derr = 0.0
        for name in names:
            rgb = resize_image(load_image(os.path.join(two, name)), shape)
            out = forward({'rgb': torch.from_numpy(rgb[None]).to(dev)})
            want = dual_head_to_depth(out[('integer', 0)],
                                      out[('fractional', 0)],
                                      config.model.params.max_depth)[0, ..., 0]
            saved = torch.from_numpy(np.load(os.path.join(
                out_dir, name[:-4] + '.npz'))['depth'])
            torch.testing.assert_close(saved, want.float().cpu(), rtol=1e-5,
                                       atol=0)
            derr = max(derr, float((saved - want.float().cpu()).abs().max()))
        summary['infer_vs_forward_max_err_m'] = derr
        log('dual-head infer CLI on {} frames: depth = integer * {} + '
            'fractional, vs the eval forward max |err| {:.2e} m, 0 kernel '
            'launches'.format(len(names), config.model.params.max_depth, derr))
    summary['launches'] = launches
    with open('chiprun_out/chip_smoke_dual_head.json', 'w') as f:
        json.dump(summary, f, indent=1)
    return launches



def seeded_resnet18_state_dict(seed):
    """A torchvision-layout resnet18 state_dict (conv1, bn1, layer1-4 with
    their downsample branches, fc) of numpy-seeded values: kaiming-normal
    convs, BN scales and variances in [0.5, 1.5], small biases and means.
    It stands for the ImageNet file that 'pt' encoders load."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = torch.from_numpy((rng.randn(cout, cin, k, k) * np.sqrt(
            2.0 / (cout * k * k))).astype(np.float32))

    def bn(name, c):
        for leaf, v in (('weight', rng.uniform(0.5, 1.5, c)),
                        ('bias', rng.randn(c) * 0.1),
                        ('running_mean', rng.randn(c) * 0.1),
                        ('running_var', rng.uniform(0.5, 1.5, c))):
            sd['{}.{}'.format(name, leaf)] = torch.from_numpy(
                v.astype(np.float32))
        sd[name + '.num_batches_tracked'] = torch.tensor(0)

    conv('conv1.weight', 64, 3, 7)
    bn('bn1', 64)
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512)):
        for b in range(2):
            pre = 'layer{}.{}.'.format(stage + 1, b)
            conv(pre + 'conv1.weight', width, cin, 3)
            bn(pre + 'bn1', width)
            conv(pre + 'conv2.weight', width, width, 3)
            bn(pre + 'bn2', width)
            if cin != width:
                conv(pre + 'downsample.0.weight', width, cin, 1)
                bn(pre + 'downsample.1', width)
            cin = width
    sd['fc.weight'] = torch.from_numpy((rng.randn(1000, 512) * 0.01).astype(
        np.float32))
    sd['fc.bias'] = torch.zeros(1000)
    return sd


def step_alone_ms(step, batch, n_timed=5):
    """ms of one call of a Trainer's train step on a batch held on the
    card, after 2 calls of warm-up."""
    import torch
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_timed


def gn_cancelled_biases(model):
    """The conv biases that feed a GroupNorm of one channel a group
    directly (PoseNet's 16-channel conv1): the norm subtracts each
    channel's mean, so their gradient is zero analytically and what a step
    computes for them is float32 rounding."""
    import torch.nn as nn
    names = []
    for name, mod in model.named_modules():
        conv, norm = getattr(mod, 'Conv_0', None), getattr(
            mod, 'GroupNorm_0', None)
        if isinstance(conv, nn.Conv2d) and isinstance(norm, nn.GroupNorm) \
                and conv.bias is not None and \
                norm.num_groups == norm.num_channels == conv.out_channels \
                and not hasattr(mod, 'Conv2D_0'):
            names.append('{}.Conv_0.bias'.format(name))
    return names


def kernel_step_check(tag, config, overrides, batch, want_launches,
                      cancelled=False):
    """One float32 step of `config` under `overrides` on `batch` through
    the kernels, through every plain version under plain autograd, and
    (the control) plain on the batch's samples in reverse order: the loss
    is the same function, only sums change order. Held to the train
    step's limits; the step's launches must be `want_launches`. Returns
    the readings and the recorded launches of the warp and photometric
    kernels: ('warp', (img, grid, mode, g)) and ('photo', (x, y, g,
    need_dy)) for the backward, ('photo', (x, y, None, False)) for the
    forward. With `cancelled`, the leaves of `gn_cancelled_biases` are held
    apart: zero analytically, both runs' values must be float32 rounding,
    within CANCELLED_NOISE of the largest gradient (the 1e-6 magnitude rule
    of `compare_grads` can read such a leaf as nonzero and then compares
    rounding with rounding)."""
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.ops.kernels import photometric, san_conv, warp
    _, model = port_train.build(config, batch['rgb'].device, seed=0,
                                overrides=['tpu.compute_dtype', 'float32'] +
                                overrides)
    kernels = {'san_fwd': san_conv.masked_conv2d,
               'san_dgrad': san_conv.masked_conv2d_dgrad,
               'warp_out': warp.warp_bilinear_out,
               'warp_dgrid': warp.warp_bilinear_dgrid,
               'photo_fwd': photometric.photometric_fwd,
               'photo_bwd': photometric.photometric_bwd}
    before = {k: fn.launches for k, fn in kernels.items()}
    rec = {'dgrid': [], 'fwd': [], 'bwd': []}
    with recording(warp, '_launch_dgrid', rec['dgrid']), \
            recording(photometric, '_launch_fwd', rec['fwd']), \
            recording(photometric, '_launch_bwd', rec['bwd']):
        ((loss_k, gk),) = step_gradients(model, ((False, batch),))
    launched = {k: fn.launches - before[k] for k, fn in kernels.items()}
    (loss_p, gp), (_, gr) = step_gradients(
        model, ((True, batch), (True, reversed_batch(batch))))
    noise = None
    if cancelled:
        names = gn_cancelled_biases(model)
        gmax = max(float(g.abs().max()) for g in gp.values())
        noise = max([float(g[n].abs().max()) / gmax for g in (gk, gp, gr)
                     for n in names] or [0.0])
        for g in (gk, gp, gr):
            for n in names:
                del g[n]
        log('{}: {} conv biases into one-channel GroupNorm groups (zero '
            'analytically), their gradients at most {:.2e} of the largest'
            .format(tag, len(names), noise))
        if not names or noise > CANCELLED_NOISE:
            raise AssertionError('{}: cancelled biases {} at {:.2e} of the '
                                 'largest gradient'.format(tag, names,
                                                           noise))
    del model
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_check = compare_grads(gk, gp)
    order_check = compare_grads(gr, gp)
    log('{} fp32 step B{} {}x{}, kernels vs plain: loss {:.6f} vs {:.6f} '
        '(rel {:.2e}); per gradient leaf max|err|/max|g| {:.3e} (at {}), '
        '|err|/|g| {:.3e}; zero leaves {:.2e} of the largest gradient; '
        'launches {}. Plain vs plain on the reversed batch: {:.3e} (at {}), '
        '{:.3e}, {:.2e}'.format(tag, *batch['rgb'].shape[:3], loss_k,
                                loss_p, loss_rel, *grad_check,
                                {k: v for k, v in launched.items() if v},
                                *order_check))
    rel, _, norm, zero_leaf = grad_check
    if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
            norm > TRAIN_GRAD_NORM or zero_leaf > 1e-6:
        raise AssertionError('{} step through the kernels disagrees with '
                             'the plain versions'.format(tag))
    want = dict.fromkeys(launched, 0)
    want.update(want_launches)
    if launched != want:
        raise AssertionError('{} fp32 step: launches {}, expected {}'.format(
            tag, launched, want))
    cases = [('warp', (img, grid, mode, g)) for img, grid, g, mode in
             rec['dgrid']]
    cases += [('photo', (x, y, g, need_dy)) for x, y, g, need_dy, *_ in
              rec['bwd']]
    cases += [('photo', (x, y, None, False)) for x, y, *_ in rec['fwd']]
    return {'loss_rel': loss_rel, 'grad': grad_check, 'launches': launched,
            'plain_reversed_batch_vs_plain': order_check,
            'cancelled_bias_noise': noise}, cases


def check_recorded_kernels(tag, cases):
    """The warp and photometric kernels against their plain versions on a
    step's recorded inputs, under phase S's rules: the warp's out and dgrid
    atol = rtol = 1e-6 (x max|ref| for the atol), the photometric forward
    atol = rtol = 1e-6, its backward atol 1e-6 x max|ref|, rtol 1e-5.
    Returns the max |err| of each kernel."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels import photometric, warp
    err = {}

    def note(key, name, a, b, atol, rtol):
        err[key] = max(err.get(key, 0.0), check_close(
            '{} {}'.format(tag, name), a, b, atol, rtol))

    for kind, args in cases:
        if kind == 'warp':
            img, grid, mode, g = args
            got = (warp.warp_bilinear_out(img, grid, mode),
                   warp.warp_bilinear_dgrid(img, grid, g, mode))
            torch.cuda.synchronize()
            want = (warp.bilinear_warp_reference(img, grid, mode)[0],
                    warp.warp_dgrid_reference(img, grid, g, mode))
            for nm, a, b in zip(('warp_out', 'warp_dgrid'), got, want):
                note(nm, nm, a, b, 1e-6 * max(float(b.float().abs().max()),
                                              1e-30), 1e-6)
            continue
        x, y, g, need_dy = args
        got = photometric.photometric_fwd(x, y)
        torch.cuda.synchronize()
        note('photo_fwd', 'photometric fwd', got,
             photometric.photometric_fwd_plain(x, y), 1e-6, 1e-6)
        if g is None:
            continue
        got = photometric.photometric_bwd(x, y, g, need_dy)
        torch.cuda.synchronize()
        want = photometric.photometric_bwd_plain(x, y, g, need_dy)
        for a, b in zip(got, want):
            if b is not None:
                note('photo_bwd', 'photometric bwd', a, b,
                     1e-6 * float(b.abs().max()), 1e-5)
    return err


def kitti_conv_rows(convs, dtype, gen, tag='K2'):
    """The masked-conv kernels at K2's shapes: each forward conv (fp32 and
    bf16) and each dgrad (those whose input needs a gradient) against its
    plain version under section 2's rule, with exact zeros at inactive
    sites; then, in the path's dtype, each launch replayed in a CUDA graph
    beside cuDNN's call (F.conv2d times the mask; conv2d_input) and the
    bound. Returns (max errors, forward rows, dgrad rows, launch paths)."""
    import torch
    import torch.nn.functional as F
    from packnet_sfm_tpu_torch.ops.kernels import san_conv
    dname = str(dtype).replace('torch.', '')
    esize = torch.tensor([], dtype=dtype).element_size()
    max_err = {}
    paths = {}
    fwd_rows, dg_rows = [], []
    for i, (mod, mask, needs) in enumerate(convs):
        k = mod.kernel.shape[0]
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).replace('torch.', '')
            args = conv_inputs(mod, mask, dt, gen)
            got = san_conv.masked_conv2d(*args)
            torch.cuda.synchronize()
            name = '{} conv {} {} {}'.format(tag, i,
                                             tuple(args[0].shape[1:]), key)
            want = san_conv.masked_conv2d_reference(*args)
            max_err['fwd_' + key] = max(max_err.get('fwd_' + key, 0.0),
                                        check_kernel(name, got, want, dt))
            if bool((got[(mask[..., 0] == 0)] != 0).any()):
                raise AssertionError(name + ': nonzero output at an '
                                     'inactive site')
            if not needs:
                continue
            gargs = dgrad_inputs(mod, mask, dt, gen)
            got = san_conv.masked_conv2d_dgrad(*gargs)
            torch.cuda.synchronize()
            max_err['dgrad_' + key] = max(
                max_err.get('dgrad_' + key, 0.0), check_kernel(
                    '{} dgrad {} {}'.format(tag, i, key), got,
                    san_conv.masked_conv2d_dgrad_reference(*gargs), dt))
            if bool((got[halo_empty(mask, k)[..., 0]] != 0).any()):
                raise AssertionError('{} dgrad {}: nonzero input gradient '
                                     'with no active site in the halo'
                                     .format(tag, i))
        # timings in the path's dtype, in a CUDA graph
        x, mk, kern, bias = conv_inputs(mod, mask, dtype, gen)
        _, _, cin, cout = kern.shape
        B, H, W, _ = x.shape
        path = launch_path(x, kern, False)
        paths['fwd ' + path] = paths.get('fwd ' + path, 0) + 1
        w_oihw = kern.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x_cl, m_nchw = x.permute(0, 3, 1, 2), mk.permute(0, 3, 1, 2)
        with torch.no_grad():
            graph = graph_time_ms(lambda: san_conv._launch(x, mk, kern, bias))
            lib = graph_time_ms(lambda: F.conv2d(
                x_cl, w_oihw, bias, padding=k // 2) * m_nchw)
        active, act_rows, x_rows, _ = site_stats(mk, k)
        nbytes = (x_rows * W * cin + kern.numel() + bias.numel() +
                  B * H * W * cout) * esize + mk.numel() * 4
        b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                                  dname)
        row = {'H': H, 'W': W, 'k': int(k), 'cin': int(cin),
               'cout': int(cout), 'path': path, 'ms': graph,
               'graph_ms': graph, 'library_ms': lib,
               'library_graph_ms': lib, 'bound_ms': b_all,
               'bytes_ms': b_ms, 'ops_ms': o_ms}
        fwd_rows.append(row)
        if not needs:
            continue
        gm, mk, kern = dgrad_inputs(mod, mask, dtype, gen)
        path = launch_path(gm, kern, True)
        paths['dgrad ' + path] = paths.get('dgrad ' + path, 0) + 1
        g_cl = gm.permute(0, 3, 1, 2)
        with torch.no_grad():
            graph = graph_time_ms(lambda: san_conv._launch_dgrad(gm, mk,
                                                                 kern))
            lib = graph_time_ms(lambda: torch.nn.grad.conv2d_input(
                (B, cin, H, W), w_oihw, g_cl, padding=k // 2))
        nbytes = (act_rows * W * cout + kern.numel() + B * H * W * cin) * \
            esize + mk.numel() * 4
        b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                                  dname)
        dg_rows.append({**row, 'path': path, 'ms': graph, 'graph_ms': graph,
                        'library_ms': lib, 'library_graph_ms': lib,
                        'bound_ms': b_all, 'bytes_ms': b_ms,
                        'ops_ms': o_ms})
    return max_err, fwd_rows, dg_rows, paths


def kitti_phase(card, dev, gen, reset_counts, read_counts):
    """Phase K: KITTI and the rest of the self-supervised family (see the
    module note). Returns ({run: launch counts} of the path runs, the
    masked-conv timings at K2's levels)."""
    import tempfile
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import parse_test_file
    from packnet_sfm_tpu_torch.datasets.kitti import (
        KITTIDataset, write_kitti_tree)
    from packnet_sfm_tpu_torch.datasets.loader import (
        default_collate, to_device_batch)
    from packnet_sfm_tpu_torch.datasets.ncdb import DEFAULT_CALIB_A6
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticDataset
    from packnet_sfm_tpu_torch.datasets.transforms import parse_crop_borders
    from packnet_sfm_tpu_torch.geometry.camera import FisheyeCamera
    from packnet_sfm_tpu_torch.trainers.trainer import make_loader

    summary = {'card': card, 'raw_shape': list(KITTI_RAW),
               'frames': KITTI_FRAMES}
    launches = {}

    def expect(run, got, **want_counts):
        want = dict.fromkeys(got, 0)
        want.update(want_counts)
        if got != want:
            raise AssertionError('{}: launches {}, expected {}'.format(
                run, got, want))
        launches[run] = got

    env = {k: os.environ.get(k) for k in ('PACKNET_WEIGHTS_DIR',
                                          'KITTI_CACHE_DIR')}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.environ['PACKNET_WEIGHTS_DIR'] = os.path.join(tmp, 'weights')
            os.environ['KITTI_CACHE_DIR'] = os.path.join(tmp, 'kitti_cache')
            os.makedirs(os.environ['PACKNET_WEIGHTS_DIR'])
            torch.save(seeded_resnet18_state_dict(0), os.path.join(
                os.environ['PACKNET_WEIGHTS_DIR'], 'resnet18-seeded.pth'))
            root = os.path.join(tmp, 'kitti')
            t0 = time.perf_counter()
            write_kitti_tree(root, KITTI_RAW, KITTI_FRAMES, splits={
                'train.txt': range(KITTI_FRAMES),
                'san_train.txt': SAN_KITTI_TRAIN, 'val.txt': KITTI_VAL})
            summary['write_tree_s'] = time.perf_counter() - t0
            s = KITTIDataset(root, 'val.txt', depth_type='groundtruth',
                             input_depth_type='velodyne')[0]
            below = slice(int(KITTI_RAW[0] * 0.35) + 1, None)
            summary['fill_below_horizon'] = {
                'velodyne': float((s['input_depth'][below] > 0).mean()),
                'groundtruth': float((s['depth'][below] > 0).mean())}
            log('phase K tree: {} KITTI_raw frames at {}x{} with OXTS, '
                'groundtruth PNG and velodyne .npz ({:.3f} / {:.3f} fill '
                'below the horizon) in {:.1f} s; seeded resnet18 weights in '
                '$PACKNET_WEIGHTS_DIR'.format(
                    KITTI_FRAMES, *KITTI_RAW,
                    summary['fill_below_horizon']['groundtruth'],
                    summary['fill_below_horizon']['velodyne'],
                    summary['write_tree_s']))

            # K1: train_kitti.yaml as written (bf16 convs and maps, B16
            # 192x640, DepthResNet + PoseResNet '18pt' from the seeded
            # file) through train.fit: 2 warp forward and 2 dgrid launches
            # a step, none in validation
            k1_data = ['datasets.train.path', [root],
                       'datasets.train.split', ['train.txt'],
                       'datasets.validation.path', [root],
                       'datasets.validation.split', ['val.txt'],
                       'datasets.test.path', [root],
                       'datasets.test.split', ['val.txt'],
                       'checkpoint.filepath', '']
            logger = EpochRecorder()
            reset_counts()
            t0 = time.perf_counter()
            k1 = port_train.fit(KITTI_CONFIG, dev, k1_data + [
                'arch.max_epochs', K1_EPOCHS], logger=logger)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            got = read_counts()
            loader = make_loader(k1.config, 'train')
            steps = K1_EPOCHS * len(loader)
            expect('kitti_k1_fit', got, warp_out=WARPS_PER_STEP * steps,
                   warp_dgrid=WARPS_PER_STEP * steps)
            losses = [logger.history[e]['train/loss']
                      for e in range(K1_EPOCHS)]
            if k1.step != steps or k1.optimizer.count != steps or \
                    not all(np.isfinite(losses)):
                raise AssertionError('K1 fit: {} steps, {} updates, losses '
                                     '{}'.format(k1.step, k1.optimizer.count,
                                                 losses))
            batch = to_device_batch(next(iter(loader)), dev)
            bs, shape = batch['rgb'].shape[0], tuple(batch['rgb'].shape[1:3])
            if len(batch['rgb_context']) != 2 or (bs, shape) != (
                    int(k1.config.datasets.train.batch_size),
                    tuple(k1.config.datasets.augmentation.image_shape)):
                raise AssertionError('K1 batch: B{} {} with {} contexts'
                                     .format(bs, shape,
                                             len(batch['rgb_context'])))
            last = logger.history[K1_EPOCHS - 1]
            alone = step_alone_ms(k1.train_step, batch)
            summary['k1'] = {
                'fit_s': fit_s, 'steps': steps, 'losses': losses,
                'val_abs_rel': [logger.history[e]['val/depth-abs_rel']
                                for e in range(K1_EPOCHS)],
                'img_per_s_with_data': last['train/img_per_s'],
                'data_ms_per_step': last['train/data_ms_per_step'],
                'step_ms_per_step': last['train/step_ms_per_step'],
                'step_alone_ms': alone, 'img_per_s_step_alone':
                bs * 1e3 / alone}
            log('K1 train_kitti.yaml through train.fit, B{} {}x{} bf16: {} '
                'epochs of {} steps in {:.1f} s, launches {}, epoch losses '
                '{}; epoch {}: {:.2f} img/s with data, data {:.1f} ms | step '
                '{:.1f} ms a step; the step alone {:.2f} ms = {:.2f} img/s; '
                '{}'.format(bs, *shape, K1_EPOCHS, len(loader), fit_s,
                            {k: v for k, v in got.items() if v},
                            ['{:.4f}'.format(v) for v in losses],
                            K1_EPOCHS - 1, last['train/img_per_s'],
                            last['train/data_ms_per_step'],
                            last['train/step_ms_per_step'], alone,
                            bs * 1e3 / alone, card))
            del k1

            # the loss falls over 10 steps on one batch; then the float32
            # variant (tpu.photometric_dtype float32, tpu.use_pallas): 10
            # photometric forward and 8 backward launches a step too
            reset_counts()
            run = port_train.main(KITTI_CONFIG, dev, n_steps=10,
                                  batches=[batch], overrides=k1_data)
            got = read_counts()
            expect('kitti_k1_one_batch', got, warp_out=WARPS_PER_STEP * 10,
                   warp_dgrid=WARPS_PER_STEP * 10)
            if not (np.all(np.isfinite(run['losses'])) and
                    run['losses'][-1] < run['losses'][0]):
                raise AssertionError('K1 loss did not fall over 10 steps: '
                                     '{}'.format(run['losses']))
            summary['k1']['one_batch_losses'] = run['losses']
            reset_counts()
            run = port_train.main(KITTI_CONFIG, dev, n_steps=2,
                                  batches=[batch],
                                  overrides=k1_data + FP32_MAPS)
            got = read_counts()
            expect('kitti_k1_fp32_maps', got,
                   warp_out=WARPS_PER_STEP * 2, warp_dgrid=WARPS_PER_STEP * 2,
                   photo_fwd=PHOTO_FWD_PER_STEP * 2,
                   photo_bwd=PHOTO_BWD_PER_STEP * 2)
            log('K1 10 steps on one batch: loss {:.4f} -> {:.4f}; the float32 '
                'maps through the fused kernels, 2 steps: losses {}'.format(
                    summary['k1']['one_batch_losses'][0],
                    summary['k1']['one_batch_losses'][-1],
                    ['{:.4f}'.format(v) for v in run['losses']]))
            del run
            per_step = {'warp_out': WARPS_PER_STEP,
                        'warp_dgrid': WARPS_PER_STEP,
                        'photo_fwd': PHOTO_FWD_PER_STEP,
                        'photo_bwd': PHOTO_BWD_PER_STEP}
            summary['k1']['fp32_step'], cases = kernel_step_check(
                'K1 (float32 maps)', KITTI_CONFIG, k1_data + FP32_MAPS,
                batch, per_step)
            summary['k1']['kernels_vs_plain'] = check_recorded_kernels(
                'K1', cases)
            log('K1 kernels vs plain on the step\'s own inputs: {}'.format(
                {k: '{:.3e}'.format(v) for k, v in
                 summary['k1']['kernels_vs_plain'].items()}))
            del batch, cases

            # K2: train_resnet_san_kitti.yaml (B4 on the 352x1216 crop,
            # sparse-silog, san_row_window -1 calibrated on the tree) with
            # FiLM on: as written its use_film false builds no SAN branch
            # and reads no LiDAR (in the JAX package too)
            ck = os.path.join(tmp, 'k2')
            k2_data = ['datasets.train.path', [root],
                       'datasets.train.split', ['san_train.txt'],
                       'datasets.validation.path', [root, root],
                       'datasets.validation.split', ['val.txt', 'val.txt'],
                       'model.depth_net.use_film', True,
                       'arch.max_epochs', 1,
                       'arch.eval_subset_size', len(KITTI_VAL),
                       'checkpoint.filepath', ck]
            logger = EpochRecorder()
            reset_counts()
            t0 = time.perf_counter()
            k2 = port_train.fit(SAN_KITTI_CONFIG, dev, k2_data,
                                logger=logger)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            got = read_counts()
            loader = make_loader(k2.config, 'train')
            steps = len(loader)
            n_val = len(KITTI_VAL)
            # a step runs the SAN once (the RGB+D pass); with LiDAR: the
            # first validation dataset's frames, one quick eval of them and
            # the logged images' batch (B1); the second dataset has none
            expect('kitti_k2_fit', got,
                   san_fwd=CONVS_PER_FORWARD * (steps + 2 * n_val + 1),
                   san_dgrad=DGRADS_PER_STEP * steps)
            frac = float(k2.config.model.depth_net.san_row_window)
            batch = to_device_batch(next(iter(loader)), dev)
            k2_bs = int(k2.config.datasets.train.batch_size)
            left, top, right, bottom = parse_crop_borders(
                k2.config.datasets.augmentation.crop_train_borders, KITTI_RAW)
            H = batch['rgb'].shape[1]
            Hw = int(H * frac) // 32 * 32
            val = k2.last_val_metrics
            prefixes = sorted({k.split('/')[0] for k in val if '/' in k})
            if tuple(batch['rgb'].shape[:3]) != (k2_bs, bottom - top,
                                                 right - left) or \
                    not 0 < Hw < H or len(prefixes) != 2 or \
                    k2.step != steps or k2.optimizer.count != steps or \
                    not np.isfinite(logger.history[0]['train/loss']):
                raise AssertionError('K2 fit: batch {}, row window {} of {}, '
                                     'validations {}, {} steps, loss {}'
                                     .format(tuple(batch['rgb'].shape), Hw,
                                             H, prefixes, k2.step,
                                             logger.history[0]))
            alone = step_alone_ms(k2.train_step, batch)
            summary['k2'] = {
                'fit_s': fit_s, 'steps': steps, 'row_window': frac,
                'row_window_rows': Hw,
                'loss': logger.history[0]['train/loss'],
                'val_abs_rel': {p: val[p + '/depth-abs_rel']
                                for p in prefixes},
                'img_per_s_with_data': logger.history[0]['train/img_per_s'],
                'data_ms_per_step': logger.history[0][
                    'train/data_ms_per_step'],
                'step_ms_per_step': logger.history[0][
                    'train/step_ms_per_step'],
                'step_alone_ms': alone,
                'img_per_s_step_alone': k2_bs * 1e3 / alone}
            log('K2 train_resnet_san_kitti.yaml (FiLM on) through train.fit, '
                'B{} {}x{} bf16, row window {} of {} rows (calibrated '
                '{:.4f}): {} steps in {:.1f} s, launches {}; loss {:.4f}; '
                'val abs_rel {}; {:.2f} img/s with data, data {:.1f} ms | '
                'step {:.1f} ms a step; the step alone {:.2f} ms = {:.2f} '
                'img/s; {}'.format(
                    k2_bs, H, right - left, Hw, H, frac, steps, fit_s,
                    {k: v for k, v in got.items() if v},
                    summary['k2']['loss'],
                    {p: '{:.4f}'.format(v) for p, v in
                     summary['k2']['val_abs_rel'].items()},
                    summary['k2']['img_per_s_with_data'],
                    summary['k2']['data_ms_per_step'],
                    summary['k2']['step_ms_per_step'], alone,
                    k2_bs * 1e3 / alone, card))
            dtype = k2.model.depth_net.encoder.Conv_0.dtype
            convs = path_convs(k2.model, batch, train=True)
            run_dir = os.path.dirname(k2.config.checkpoint.filepath)
            ckpts = sorted(f for f in os.listdir(run_dir)
                           if f.endswith('.ckpt'))
            del k2
            if len(convs) != CONVS_PER_FORWARD or sum(
                    n for _, _, n in convs) != DGRADS_PER_STEP or \
                    len(ckpts) != 1:
                raise AssertionError('K2: {} masked convs, {} with a '
                                     'gradient, checkpoints {}'.format(
                                         len(convs),
                                         sum(n for _, _, n in convs), ckpts))
            errs, fwd_rows, dg_rows, paths = kitti_conv_rows(convs, dtype,
                                                             gen)
            del convs
            levels = {'forward': level_lines(fwd_rows, 'K2 forward'),
                      'dgrad': level_lines(dg_rows, 'K2 dgrad')}
            tot = {d: {k: sum(r[k] for r in rows) for k in
                       ('graph_ms', 'library_graph_ms', 'bound_ms',
                        'bytes_ms', 'ops_ms')}
                   for d, rows in (('forward', fwd_rows),
                                   ('dgrad', dg_rows))}
            summary['k2'].update(conv_max_err=errs, conv_paths=paths,
                                 levels=levels, conv_totals=tot)
            log('K2 masked convs at their own shapes (B{}, the row window), '
                'kernels vs plain max |err| {}; launch paths {}; a step in a '
                'CUDA graph: forward {:.4f} ms (cuDNN {:.4f}, bound {:.4f}), '
                'dgrad {:.4f} ms (cuDNN {:.4f}, bound {:.4f}); {}'.format(
                    k2_bs, {k: '{:.3e}'.format(v) for k, v in errs.items()},
                    paths,
                    tot['forward']['graph_ms'],
                    tot['forward']['library_graph_ms'],
                    tot['forward']['bound_ms'], tot['dgrad']['graph_ms'],
                    tot['dgrad']['library_graph_ms'],
                    tot['dgrad']['bound_ms'], card))

            # K2's eval: eval_resnet_san_kitti.yaml over the fit's
            # checkpoint on the tree (garg crop, top-center, the 352x1216
            # crop_eval_borders; B1 with LiDAR), its save pass included:
            # 30 launches a frame in each pass; in float32 through the
            # kernels against the plain versions
            ckpt = os.path.join(run_dir, ckpts[0])
            ev = ['datasets.test.path', [root], 'datasets.test.split',
                  ['val.txt'], 'save.folder', os.path.join(tmp, 'outputs')]
            # the checkpoint's test split, merged with the eval YAML's,
            # keeps the training YAML's two entries (the eval YAML's
            # dataset twice): B1 over all its frames, each pass
            n_test = len(make_loader(parse_test_file(
                ckpt, SAN_KITTI_EVAL, ev)[0], 'test'))
            reset_counts()
            m = port_eval.test(ckpt, SAN_KITTI_EVAL, device=dev,
                               overrides=ev)
            got = read_counts()
            expect('kitti_k2_eval', got,
                   san_fwd=CONVS_PER_FORWARD * 2 * n_test)
            f32 = ev[:4] + ['save.folder', '', 'tpu.compute_dtype',
                            'float32']
            mk = port_eval.test(ckpt, SAN_KITTI_EVAL, device=dev,
                                overrides=f32)
            with plain_versions():
                mp = port_eval.test(ckpt, SAN_KITTI_EVAL, device=dev,
                                    overrides=f32)
            err = max(0.0 if mk[k] == mp[k] else abs(mk[k] - mp[k])
                      for k in mp)
            saved = sum(len(f) for _, _, f in os.walk(os.path.join(
                tmp, 'outputs')))
            summary['k2']['eval'] = {'metrics': dict(m),
                                     'fp32_kernels_vs_plain_max_err': err}
            for name, r in (('bf16', m), ('fp32', mk)):
                if len(r) != 6 * 7 + 1 or r.skipped or any(
                        np.isnan(v) for v in r.values()):
                    raise AssertionError('K2 {} eval: {}'.format(name, r))
            log('K2 eval_resnet_san_kitti.yaml over the checkpoint, {} '
                'frames B1 at the 352x1216 crop: abs_rel {:.4f}, '
                'depth_gt-abs_rel {:.4f}; {} masked-conv launches with the '
                'save pass ({} files written); fp32 kernels vs plain max '
                '|err| {:.3e} over the metrics'.format(
                    n_test, m['depth-abs_rel'], m['depth_gt-abs_rel'],
                    got['san_fwd'], saved, err))
            if sorted(mk) != sorted(mp) or err > 1e-5:
                raise AssertionError('K2 eval through the kernels disagrees '
                                     'with the plain versions')
            del batch

            # K3: the fisheye camera, train_kitti.yaml's SelfSupModel on
            # seeded batches carrying NCDB's A6 calibration (384x640, 2
            # contexts): the loss takes the fisheye camera, whose grids
            # fall far outside [-1, 1]; then VelSupModel on the Synthetic
            # dataset's batch with its pose_context
            intr = DEFAULT_CALIB_A6['intrinsic']
            fb = port_eval.make_batches(K3_SHAPE, K3_BATCH, 1, seed=1,
                                        device=dev, contexts=2)[0]
            fb['distortion_coeffs'] = {
                'k': torch.tensor(intr[0:7], device=dev).repeat(K3_BATCH, 1),
                **{key: torch.full((K3_BATCH,), float(intr[i]), device=dev)
                   for i, key in ((7, 's'), (8, 'div'), (9, 'ux'),
                                  (10, 'uy'))}}
            k3 = ['datasets.augmentation.image_shape', K3_SHAPE,
                  'datasets.train.batch_size', K3_BATCH]
            reset_counts()
            run = port_train.main(KITTI_CONFIG, dev, n_steps=3,
                                  batches=[fb], overrides=k3)
            got = read_counts()
            expect('kitti_k3_fisheye', got, warp_out=WARPS_PER_STEP * 3,
                   warp_dgrid=WARPS_PER_STEP * 3)
            if not np.all(np.isfinite(run['losses'])):
                raise AssertionError('K3 fisheye losses: {}'.format(
                    run['losses']))
            fish = {'losses': run['losses']}
            del run
            fish['fp32_step'], cases = kernel_step_check(
                'K3 fisheye (float32 maps)', KITTI_CONFIG, k3 + FP32_MAPS,
                fb, per_step)
            grids = [c[1][1] for c in cases if c[0] == 'warp']
            # where the step's rays land, in pixels of the 384x640 frame
            px = [((gr + 1) * gr.new_tensor([K3_SHAPE[1] - 1,
                                             K3_SHAPE[0] - 1]) / 2)
                  for gr in grids]
            fish['grid_pixel_range'] = [
                [float(p[..., i].min()), float(p[..., i].max())]
                for p in px for i in (0, 1)]
            fish['kernels_vs_plain'] = check_recorded_kernels('K3', cases)
            # on a 24x40 frame the same calibration sends the rays
            # outside [-1, 1] (the zeros padding): the warp kernels against
            # their plain versions on such grids
            cam = FisheyeCamera.create(fb['distortion_coeffs'],
                                       image_size=(24, 40))
            depth = torch.rand(K3_BATCH, 24, 40, 1, device=dev,
                               generator=gen) * 20 + 1
            grid = cam.project(cam.reconstruct(depth, 'c'), 'c')
            small = [('warp', (torch.rand(K3_BATCH, 24, 40, 3, device=dev,
                                          generator=gen), grid, 'zeros',
                               torch.randn(K3_BATCH, 24, 40, 3, device=dev,
                                           generator=gen)))]
            fish['small_grid_outside_share'] = float(
                (grid.abs() > 1).any(-1).float().mean())
            fish['kernels_vs_plain_small_grid'] = check_recorded_kernels(
                'K3 24x40', small)
            summary['k3_fisheye'] = fish
            log('K3 fisheye SelfSupModel B{} {}x{} (A6 calibration): losses '
                '{}; the warp grids land on x, y pixels {} (near ux, uy); '
                'kernels vs plain on the step\'s own inputs {}; on a 24x40 '
                'frame {:.3f} of the A6 grid points fall outside [-1, 1], '
                'kernels vs plain there {}'.format(
                    K3_BATCH, *K3_SHAPE,
                    ['{:.4f}'.format(v) for v in fish['losses']],
                    ['{:.2f}-{:.2f}'.format(*r) for r in
                     fish['grid_pixel_range']],
                    {k: '{:.3e}'.format(v) for k, v in
                     fish['kernels_vs_plain'].items()},
                    fish['small_grid_outside_share'],
                    {k: '{:.3e}'.format(v) for k, v in
                     fish['kernels_vs_plain_small_grid'].items()}))
            if fish['small_grid_outside_share'] < 0.5:
                raise AssertionError('the 24x40 A6 grid: {:.3f} outside'
                                     .format(fish['small_grid_outside_share']))
            del fb, cases
            syn = SyntheticDataset(num_samples=K3_BATCH, height=shape[0],
                                   width=shape[1])
            vb = to_device_batch(default_collate(
                [syn[i] for i in range(K3_BATCH)]), dev)
            velsup = ['model.name', 'VelSupModel',
                      'datasets.train.batch_size', K3_BATCH]
            reset_counts()
            run = port_train.main(KITTI_CONFIG, dev, n_steps=1,
                                  batches=[vb], overrides=velsup)
            got = read_counts()
            expect('kitti_k3_velsup', got, warp_out=WARPS_PER_STEP,
                   warp_dgrid=WARPS_PER_STEP)
            vel = {'loss': run['losses'][0],
                   'metrics': sorted(run['model'](vb)['metrics'])}
            del run
            if not np.isfinite(vel['loss']) or \
                    'velocity_loss' not in vel['metrics']:
                raise AssertionError('K3 VelSupModel: {}'.format(vel))
            vel['fp32_step'], cases = kernel_step_check(
                'K3 VelSupModel (float32 maps)', KITTI_CONFIG,
                velsup + FP32_MAPS, vb, per_step)
            vel['kernels_vs_plain'] = check_recorded_kernels('K3 VelSup',
                                                             cases)
            summary['k3_velsup'] = vel
            log('K3 VelSupModel on the Synthetic pose_context, B{} {}x{}: '
                'loss {:.4f}, metrics {}'.format(K3_BATCH, *shape,
                                                 vel['loss'],
                                                 vel['metrics']))
            del vb, cases
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    summary['launches'] = launches
    with open('chiprun_out/chip_smoke_kitti.json', 'w') as f:
        json.dump(summary, f, indent=1, default=float)
    return launches, summary['k2']['conv_totals']


def image_dgp_phase(card, dev, gen, reset_counts, read_counts):
    """Phase I: the Image and DGP datasets, the multi-camera fold, the
    sample cache and the advanced augmentations (see the module note).
    Returns {run: launch counts} of the path runs."""
    import tempfile
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.datasets.cache import SampleCache
    from packnet_sfm_tpu_torch.datasets.dgp import write_dgp_tree
    from packnet_sfm_tpu_torch.datasets.image_dataset import write_image_tree
    from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
    from packnet_sfm_tpu_torch.ops.kernels import generic_projection as gp
    from packnet_sfm_tpu_torch.ops.kernels import warp
    from packnet_sfm_tpu_torch.trainers.trainer import make_loader

    summary = {'card': card, 'ddad_shape': list(DDAD_NATIVE),
               'ddad_cameras': list(DDAD_CAMERAS),
               'ddad_points': DDAD_POINTS,
               'omnicam_shape': list(OMNICAM_NATIVE)}
    launches = {}
    per_step = {'warp_out': WARPS_PER_STEP, 'warp_dgrid': WARPS_PER_STEP,
                'photo_fwd': PHOTO_FWD_PER_STEP,
                'photo_bwd': PHOTO_BWD_PER_STEP}

    def expect(run, got, **want_counts):
        want = dict.fromkeys(got, 0)
        want.update(want_counts)
        if got != want:
            raise AssertionError('{}: launches {}, expected {}'.format(
                run, got, want))
        launches[run] = got

    def fit(tag, config, overrides, **want_per_step):
        """train.fit under `overrides` with an EpochRecorder; its launches
        must be want_per_step x the steps, and no step skipped. Returns
        (trainer, its train loader, the recorder's history, seconds)."""
        logger = EpochRecorder()
        reset_counts()
        t0 = time.perf_counter()
        trainer = port_train.fit(config, dev, overrides, logger=logger)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        loader = make_loader(trainer.config, 'train')
        steps = trainer.max_epochs * len(loader)
        expect(tag, got, **{k: v * steps for k, v in want_per_step.items()})
        losses = [logger.history[e]['train/loss']
                  for e in range(trainer.max_epochs)]
        if trainer.step != steps or trainer.optimizer.count != steps or \
                not np.all(np.isfinite(losses)):
            raise AssertionError('{}: {} steps, {} updates, losses {}'.format(
                tag, trainer.step, trainer.optimizer.count, losses))
        return trainer, loader, logger.history, seconds

    def first_batch(loader):
        """The loader's first samples (unshuffled) collated and on the
        card, without starting the loader's threads, whose decoding would
        run on during the timings that follow."""
        return to_device_batch(loader.collate_fn([
            loader.dataset[i] for i in range(loader.batch_size)]), dev)

    def rates(history, epoch):
        h = history[epoch]
        return {'img_per_s_with_data': h['train/img_per_s'],
                'data_ms_per_step': h['train/data_ms_per_step'],
                'step_ms_per_step': h['train/step_ms_per_step']}

    env = os.environ.get('PACKNET_WEIGHTS_DIR')
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # the '18pt' encoders (DepthResNet, PoseResNet, RaySurfaceResNet)
            # load the seeded resnet18 file
            os.environ['PACKNET_WEIGHTS_DIR'] = os.path.join(tmp, 'weights')
            os.makedirs(os.environ['PACKNET_WEIGHTS_DIR'])
            torch.save(seeded_resnet18_state_dict(0), os.path.join(
                os.environ['PACKNET_WEIGHTS_DIR'], 'resnet18-seeded.pth'))
            root = os.path.join(tmp, 'ddad')
            t0 = time.perf_counter()
            write_dgp_tree(root, DDAD_SCENES, DDAD_SAMPLES, DDAD_CAMERAS,
                           *DDAD_NATIVE, DDAD_POINTS, seed=0)
            summary['write_ddad_s'] = time.perf_counter() - t0
            log('phase I DGP tree: {} scenes x {} samples, cameras {} at '
                '{}x{}, {} LiDAR points a sweep, in {:.1f} s'.format(
                    DDAD_SCENES, DDAD_SAMPLES, DDAD_CAMERAS, *DDAD_NATIVE,
                    DDAD_POINTS, summary['write_ddad_s']))
            data = ['datasets.train.repeat', [1],
                    'arch.eval_subset_size', 4]
            for split in ('train', 'validation', 'test'):
                data += ['datasets.{}.path'.format(split), [root],
                         'datasets.{}.split'.format(split), ['']]

            # I1: overfit_ddad.yaml as written (DepthResNet + PoseResNet
            # '18pt', B4 384x640, float32 convs and bf16 maps, camera_01)
            # through train.fit: 2 warp forward and 2 dgrid launches a
            # step, none in validation
            ck = os.path.join(tmp, 'i1')
            i1, loader, history, fit_s = fit(
                'ddad_i1_fit', DDAD_CONFIG, data + [
                    'arch.max_epochs', DDAD_EPOCHS, 'checkpoint.filepath',
                    ck], warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
            batch = first_batch(loader)
            bs = int(i1.config.datasets.train.batch_size)
            shape = tuple(i1.config.datasets.augmentation.image_shape)
            val = [history[e]['val/depth-abs_rel']
                   for e in range(DDAD_EPOCHS)]
            if tuple(batch['rgb'].shape[:3]) != (bs,) + shape or \
                    len(batch['rgb_context']) != 2 or \
                    not np.all(np.isfinite(val)):
                raise AssertionError('I1: batch {}, {} contexts, val '
                                     'abs_rel {}'.format(
                                         tuple(batch['rgb'].shape),
                                         len(batch['rgb_context']), val))
            alone = step_alone_ms(i1.train_step, batch)
            last = rates(history, DDAD_EPOCHS - 1)
            summary['i1'] = {
                'fit_s': fit_s, 'steps': i1.step, 'val_abs_rel': val,
                'losses': [history[e]['train/loss']
                           for e in range(DDAD_EPOCHS)],
                **last, 'first_epoch': rates(history, 0),
                'step_alone_ms': alone,
                'img_per_s_step_alone': bs * 1e3 / alone}
            log('I1 overfit_ddad.yaml through train.fit, B{} {}x{} (float32 '
                'convs, bf16 maps), camera_01 from {}x{}: {} epochs of {} '
                'steps in {:.1f} s, launches {}; val abs_rel on the LiDAR '
                '{}; epoch {}: {:.2f} img/s with data, data {:.1f} ms | '
                'step {:.1f} ms a step (epoch 0: {:.2f} img/s, data {:.1f} '
                'ms); the step alone {:.2f} ms = {:.2f} img/s; {}'.format(
                    bs, *shape, *DDAD_NATIVE, DDAD_EPOCHS, len(loader),
                    fit_s, {k: v for k, v in launches['ddad_i1_fit'].items()
                            if v}, ['{:.4f}'.format(v) for v in val],
                    DDAD_EPOCHS - 1, last['img_per_s_with_data'],
                    last['data_ms_per_step'], last['step_ms_per_step'],
                    summary['i1']['first_epoch']['img_per_s_with_data'],
                    summary['i1']['first_epoch']['data_ms_per_step'], alone,
                    bs * 1e3 / alone, card))
            run_dir = os.path.dirname(i1.config.checkpoint.filepath)
            ckpt = os.path.join(run_dir, sorted(
                f for f in os.listdir(run_dir) if f.endswith('.ckpt'))[-1])
            last_val = dict(i1.last_val_metrics)
            del i1

            # eval.py --checkpoint on the test split (the same 16 frames
            # with their LiDAR depth): no kernel launch
            reset_counts()
            t0 = time.perf_counter()
            m = port_eval.test(ckpt, device=dev, overrides=data[-4:])
            eval_s = time.perf_counter() - t0
            expect('ddad_i1_eval', read_counts())
            if len(m) != 6 * 7 + 1 or m.skipped or \
                    not np.isfinite(m['depth-abs_rel']):
                raise AssertionError('I1 eval: {}'.format(m))
            summary['i1']['eval'] = {
                'seconds': eval_s, 'abs_rel': m['depth-abs_rel'],
                'abs_rel_last_validation': last_val['depth-abs_rel']}
            log('I1 eval.py --checkpoint {} on the test split: abs_rel '
                '{:.4f} (the last validation {:.4f}), in {:.1f} s, no kernel '
                'launch'.format(os.path.basename(ckpt), m['depth-abs_rel'],
                                last_val['depth-abs_rel'], eval_s))

            # 10 steps on one batch, the loss falling; then the float32
            # maps through the fused kernels: 10 photometric forward and 8
            # backward launches a step too
            reset_counts()
            run = port_train.main(DDAD_CONFIG, dev, n_steps=10,
                                  batches=[batch], overrides=data)
            expect('ddad_i1_one_batch', read_counts(),
                   warp_out=WARPS_PER_STEP * 10,
                   warp_dgrid=WARPS_PER_STEP * 10)
            if not (np.all(np.isfinite(run['losses'])) and
                    run['losses'][-1] < run['losses'][0]):
                raise AssertionError('I1 loss did not fall over 10 steps: '
                                     '{}'.format(run['losses']))
            summary['i1']['one_batch_losses'] = run['losses']
            reset_counts()
            run = port_train.main(DDAD_CONFIG, dev, n_steps=2,
                                  batches=[batch],
                                  overrides=data + FP32_MAPS)
            expect('ddad_i1_fp32_maps', read_counts(),
                   **{k: v * 2 for k, v in per_step.items()})
            one = summary['i1']['one_batch_losses']
            log('I1 10 steps on one batch: loss {:.4f} -> {:.4f}; the '
                'float32 maps through the fused kernels, 2 steps: losses '
                '{}'.format(one[0], one[-1],
                            ['{:.4f}'.format(v) for v in run['losses']]))
            del run
            summary['i1']['fp32_step'], cases = kernel_step_check(
                'I1 (float32 maps)', DDAD_CONFIG, data + FP32_MAPS, batch,
                per_step)
            summary['i1']['kernels_vs_plain'] = check_recorded_kernels(
                'I1', cases)
            log('I1 kernels vs plain on the step\'s own inputs (B{} {}x{}): '
                '{}'.format(bs, *shape, {
                    k: '{:.3e}'.format(v) for k, v in
                    summary['i1']['kernels_vs_plain'].items()}))
            del batch, cases

            # I2: both cameras, folded into B8 on the way to the card; the
            # launches a step stay 2 + 2 (a launch covers the whole batch),
            # each over the 8 images
            cams = [list(DDAD_CAMERAS)]
            cams = ['datasets.train.cameras', cams,
                    'datasets.validation.cameras', cams]
            grids = []
            dgrid = warp._launch_dgrid
            warp._launch_dgrid = lambda img, *a: (
                grids.append(tuple(img.shape)), dgrid(img, *a))[1]
            try:
                i2, loader, history, fit_s = fit(
                    'ddad_i2_fit', DDAD_CONFIG, data + cams + [
                        'arch.max_epochs', 1, 'checkpoint.filepath', ''],
                    warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
            finally:
                warp._launch_dgrid = dgrid
            batch = first_batch(loader)
            folded = (bs * len(DDAD_CAMERAS),) + shape
            if tuple(batch['rgb'].shape[:3]) != folded or \
                    {g[:3] for g in grids} != {folded}:
                raise AssertionError('I2: batch {}, the dgrid launches saw '
                                     '{}'.format(tuple(batch['rgb'].shape),
                                                 sorted(set(grids))))
            alone = step_alone_ms(i2.train_step, batch)
            summary['i2'] = {
                'fit_s': fit_s, 'steps': i2.step,
                'launches_per_step': {k: v // i2.step for k, v in
                                      launches['ddad_i2_fit'].items() if v},
                'launch_batch': folded[0],
                'val_abs_rel': history[0]['val/depth-abs_rel'],
                **rates(history, 0), 'step_alone_ms': alone,
                'img_per_s_step_alone': folded[0] * 1e3 / alone}
            log('I2 both cameras: the folded batch B{} {}x{} reaches the '
                'step (every dgrid launch over {} images); {} steps in '
                '{:.1f} s, launches {} ({} a step, as I1\'s: one a context '
                'over the whole batch); {:.2f} img/s with data, data {:.1f} '
                'ms | step {:.1f} ms; the step alone {:.2f} ms = {:.2f} '
                'img/s; {}'.format(
                    *folded, folded[0], i2.step, fit_s,
                    {k: v for k, v in launches['ddad_i2_fit'].items() if v},
                    summary['i2']['launches_per_step'],
                    summary['i2']['img_per_s_with_data'],
                    summary['i2']['data_ms_per_step'],
                    summary['i2']['step_ms_per_step'], alone,
                    folded[0] * 1e3 / alone, card))
            del i2
            summary['i2']['fp32_step'], cases = kernel_step_check(
                'I2 folded (float32 maps)', DDAD_CONFIG,
                data + cams + FP32_MAPS, batch, per_step)
            summary['i2']['kernels_vs_plain'] = check_recorded_kernels(
                'I2', cases)
            log('I2 kernels vs plain on the folded step\'s own inputs: '
                '{}'.format({k: '{:.3e}'.format(v) for k, v in
                             summary['i2']['kernels_vs_plain'].items()}))
            del batch, cases

            # the sample cache in RAM under tpu.device_augment (2 epochs:
            # the second replays the first's samples), then RandAugment,
            # random erasing and mixup; no validation
            quiet = ['datasets.validation.dataset', [],
                     'datasets.validation.path', [],
                     'checkpoint.filepath', '']
            i2c, loader, history, fit_s = fit(
                'ddad_i2_cache', DDAD_CONFIG, data + cams + quiet + [
                    'arch.max_epochs', 2, 'datasets.train.cache', 'ram',
                    'tpu.device_augment', True],
                warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
            if not isinstance(loader.dataset, SampleCache):
                raise AssertionError('I2: the train split is not cached')
            summary['i2']['cache_ram_device_augment'] = {
                'fit_s': fit_s, 'epochs': [rates(history, e)
                                           for e in range(2)]}
            del i2c
            advanced = ['datasets.augmentation.randaugment.enabled', True,
                        'datasets.augmentation.random_erasing.enabled', True,
                        'datasets.augmentation.mixup.enabled', True]
            i2a, loader, history, fit_s = fit(
                'ddad_i2_advanced', DDAD_CONFIG,
                data + cams + quiet + advanced + ['arch.max_epochs', 1],
                warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
            if loader.batch_augment is None or len(
                    loader.dataset.transform.advanced) != 2:
                raise AssertionError('I2: the advanced augmentations are '
                                     'not on the train split')
            summary['i2']['advanced'] = {'fit_s': fit_s, **rates(history, 0),
                                         'loss': history[0]['train/loss']}
            del i2a
            c = summary['i2']['cache_ram_device_augment']['epochs']
            log('I2 cache \'ram\' under tpu.device_augment: epoch 0 {:.2f} '
                'img/s with data (data {:.1f} ms a step), epoch 1 from RAM '
                '{:.2f} (data {:.1f} ms); RandAugment + random erasing + '
                'mixup: {:.2f} img/s (data {:.1f} ms), loss {:.4f}; {}'.format(
                    c[0]['img_per_s_with_data'], c[0]['data_ms_per_step'],
                    c[1]['img_per_s_with_data'], c[1]['data_ms_per_step'],
                    summary['i2']['advanced']['img_per_s_with_data'],
                    summary['i2']['advanced']['data_ms_per_step'],
                    summary['i2']['advanced']['loss'], card))

            # I3: the omnicam YAMLs over an Image folder (768x768 frames,
            # B1 384x384): 2 projection forwards, 2 backward calls, 2 warp
            # forward and 2 dgrid launches a step, as in phase G
            frames = write_image_tree(os.path.join(tmp, 'omnicam'),
                                      OMNICAM_FRAMES, *OMNICAM_NATIVE,
                                      seed=0)
            summary['i3'] = {}
            for name, config in GENERIC_CONFIGS.items():
                g, loader, history, fit_s = fit(
                    'omnicam_{}_fit'.format(name), config, [
                        'datasets.train.path', [frames],
                        'arch.max_epochs', 1, 'checkpoint.filepath', ''],
                    proj_fwd=PROJ_PER_STEP, proj_bwd=PROJ_PER_STEP,
                    warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
                batch = first_batch(loader)
                alone = step_alone_ms(g.train_step, batch)
                model = g.model
                del g
                # the projection and warp kernels against their plain
                # versions on one step's own inputs from disk
                rec = {'fwd': [], 'bwd': [], 'dgrid': []}
                with recording(gp, '_launch_fwd', rec['fwd']), \
                        recording(gp, '_launch_bwd', rec['bwd']), \
                        recording(warp, '_launch_dgrid', rec['dgrid']):
                    model.train()
                    model(batch)['loss'].backward()
                del model
                fwd_err = {'rows_cols_px': 0.0, 'm_rel': 0.0, 's_rel': 0.0}
                m_equal = [0, 0]
                for ray, d, p in rec['fwd']:
                    check_projection_fwd('I3 ' + name, ray, d, p, fwd_err,
                                         m_equal)
                bwd_err = max(check_projection_bwd('I3 ' + name, args)
                              for args in rec['bwd'])
                warp_err = check_recorded_kernels('I3 ' + name, [
                    ('warp', (img, grid, mode, gg))
                    for img, grid, gg, mode in rec['dgrid']])
                plane = tuple(rec['fwd'][0][0].shape)
                summary['i3'][name] = {
                    'fit_s': fit_s, 'steps': len(loader),
                    'loss': history[0]['train/loss'], **rates(history, 0),
                    'step_alone_ms': alone, 'plane': list(plane),
                    'projection_fwd_err': fwd_err,
                    'projection_bwd_rel_err': bwd_err, 'warp_err': warp_err}
                log('I3 {} ({}) over {} frames of {}x{} on disk, B1 {}x{}: '
                    '{} steps in {:.1f} s, launches {}; {:.2f} img/s with '
                    'data (data {:.1f} ms | step {:.1f} ms); the step alone '
                    '{:.2f} ms; projection planes {}, kernels vs plain on a '
                    'disk step: fwd rows/cols {:.3e} px, m {:.3e}, s {:.3e}; '
                    'bwd {:.3e} of max; warp {}; {}'.format(
                        name, os.path.basename(config), OMNICAM_FRAMES,
                        *OMNICAM_NATIVE, *batch['rgb'].shape[1:3],
                        len(loader), fit_s,
                        {k: v for k, v in
                         launches['omnicam_{}_fit'.format(name)].items()
                         if v},
                        summary['i3'][name]['img_per_s_with_data'],
                        summary['i3'][name]['data_ms_per_step'],
                        summary['i3'][name]['step_ms_per_step'], alone,
                        plane, fwd_err['rows_cols_px'], fwd_err['m_rel'],
                        fwd_err['s_rel'], bwd_err,
                        {k: '{:.3e}'.format(v) for k, v in warp_err.items()},
                        card))
                del batch, rec
        finally:
            if env is None:
                os.environ.pop('PACKNET_WEIGHTS_DIR', None)
            else:
                os.environ['PACKNET_WEIGHTS_DIR'] = env
    summary['launches'] = launches
    with open('chiprun_out/chip_smoke_image_dgp.json', 'w') as f:
        json.dump(summary, f, indent=1, default=float)
    return launches


def packnet_phase(card, dev, gen, reset_counts, read_counts):
    """Phase P: the PackNet family (see the module note). Returns ({run:
    launch counts} of the path runs, P1's masked-conv totals a step in a
    CUDA graph)."""
    import tempfile
    import numpy as np
    import torch
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import parse_test_file
    from packnet_sfm_tpu_torch.datasets.dgp import write_dgp_tree
    from packnet_sfm_tpu_torch.datasets.kitti import write_kitti_tree
    from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
    from packnet_sfm_tpu_torch.datasets.transforms import parse_crop_borders
    from packnet_sfm_tpu_torch.trainers.trainer import (
        make_loader, make_val_loaders, validate_multi)

    summary = {'card': card, 'kitti_raw': list(KITTI_RAW),
               'ddad_shape': list(DDAD_NATIVE), 'ddad_cameras':
               list(P_CAMERAS), 'p2_tree': [P2_SCENES, P2_SAMPLES],
               'p3_tree': [P3_SCENES, P3_SAMPLES]}
    launches = {}
    per_step = {'warp_out': WARPS_PER_STEP, 'warp_dgrid': WARPS_PER_STEP,
                'photo_fwd': PHOTO_FWD_PER_STEP,
                'photo_bwd': PHOTO_BWD_PER_STEP}
    t_phase = time.perf_counter()

    def expect(run, got, **want_counts):
        want = dict.fromkeys(got, 0)
        want.update(want_counts)
        if got != want:
            raise AssertionError('{}: launches {}, expected {}'.format(
                run, got, want))
        launches[run] = got

    def fit(config, overrides):
        """train.fit under `overrides` with an EpochRecorder: (trainer, its
        train loader, the history, seconds, the launches)."""
        logger = EpochRecorder()
        reset_counts()
        t0 = time.perf_counter()
        trainer = port_train.fit(config, dev, overrides, logger=logger)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        loader = make_loader(trainer.config, 'train')
        losses = [logger.history[e]['train/loss']
                  for e in range(trainer.max_epochs)]
        steps = trainer.max_epochs * len(loader)
        if trainer.step != steps or trainer.optimizer.count != steps or \
                not np.all(np.isfinite(losses)):
            raise AssertionError('{}: {} steps, {} updates, losses {}'.format(
                config, trainer.step, trainer.optimizer.count, losses))
        return trainer, loader, logger.history, seconds, got

    def first_batch(loader):
        """The loader's first samples collated and on the card, without
        starting the loader's threads (PERF.md section 7)."""
        return to_device_batch(loader.collate_fn([
            loader.dataset[i] for i in range(loader.batch_size)]), dev)

    def rates(history, epoch):
        h = history[epoch]
        return {'img_per_s_with_data': h['train/img_per_s'],
                'data_ms_per_step': h['train/data_ms_per_step'],
                'step_ms_per_step': h['train/step_ms_per_step']}

    def alone_and_peak(step, batch):
        """(ms of the step alone, peak device memory of it in GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = step_alone_ms(step, batch)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    def one_batch_falls(tag, config, overrides, batch, **want_per_step):
        """10 steps on one batch: the launches and the loss falling."""
        reset_counts()
        run = port_train.main(config, dev, n_steps=10, batches=[batch],
                              overrides=overrides)
        expect(tag, read_counts(),
               **{k: v * 10 for k, v in want_per_step.items()})
        losses = run['losses']
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError('{}: the loss did not fall over 10 steps '
                                 'on one batch: {}'.format(tag, losses))
        return losses

    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------------------ P1
        root = os.path.join(tmp, 'kitti')
        t0 = time.perf_counter()
        n_frames = max(P1_VAL) + 2
        write_kitti_tree(root, KITTI_RAW, n_frames, splits={
            'train.txt': P1_TRAIN, 'val.txt': P1_VAL})
        summary['write_kitti_s'] = time.perf_counter() - t0
        ck = os.path.join(tmp, 'p1')
        n_val = len(P1_VAL)
        p1_data = ['datasets.train.path', [root],
                   'datasets.train.split', ['train.txt'],
                   'datasets.validation.path', [root, root],
                   'datasets.validation.split', ['val.txt', 'val.txt'],
                   'datasets.test.path', [root, root],
                   'datasets.test.split', ['val.txt', 'val.txt']]
        p1, loader, history, fit_s, got = fit(PACKNET_SAN_KITTI, p1_data + [
            'arch.max_epochs', P_EPOCHS, 'arch.eval_subset_size', n_val,
            'checkpoint.filepath', ck])
        steps = len(loader)
        every = max(1, int(steps * p1.config.arch.eval_progress_interval))
        quick = len([b for b in range(1, steps) if b % every == 0])
        # a step runs the SAN once (the RGB+D pass); an epoch validates
        # the first validation dataset's frames with LiDAR (the second
        # has none), quick-evaluates them `quick` times and logs one batch
        # (B1)
        expect('packnet_p1_fit', got,
               san_fwd=CONVS_PER_FORWARD * P_EPOCHS * (
                   steps + n_val * (1 + quick) + 1),
               san_dgrad=DGRADS_PER_STEP * P_EPOCHS * steps)
        batch = first_batch(loader)
        bs = int(p1.config.datasets.train.batch_size)
        shape = tuple(batch['rgb'].shape[1:3])
        left, top, right, bottom = parse_crop_borders(
            p1.config.datasets.augmentation.crop_train_borders, KITTI_RAW)
        net = p1.model.depth_net
        if type(net).__name__ != 'PackNetSAN01' or \
                batch['rgb'].shape[0] != bs or \
                shape != (bottom - top, right - left) or \
                net.core.pre_calc.Conv_0.dtype != torch.bfloat16:
            raise AssertionError('P1: {} B{} {} {}'.format(
                type(net).__name__, batch['rgb'].shape[0], shape,
                net.core.pre_calc.Conv_0.dtype))
        convs = path_convs(p1.model, batch, train=True)
        if len(convs) != CONVS_PER_FORWARD or \
                sum(n for _, _, n in convs) != DGRADS_PER_STEP:
            raise AssertionError('P1: {} masked convs a step, {} with an '
                                 'input gradient'.format(
                                     len(convs), sum(n for *_, n in convs)))
        alone, peak = alone_and_peak(p1.train_step, batch)
        last = rates(history, P_EPOCHS - 1)
        summary['p1'] = {
            'fit_s': fit_s, 'steps': p1.step, 'write_tree_s':
            summary['write_kitti_s'],
            'losses': [history[e]['train/loss'] for e in range(P_EPOCHS)],
            'val_abs_rel': {k: v for k, v in p1.last_val_metrics.items()
                            if k.endswith('/depth-abs_rel')},
            **last, 'first_epoch': rates(history, 0),
            'step_alone_ms': alone, 'img_per_s_step_alone': bs * 1e3 / alone,
            'peak_gib': peak,
            'launches_per_step': {'san_fwd': CONVS_PER_FORWARD,
                                  'san_dgrad': DGRADS_PER_STEP}}
        log('P1 train_packnet_san_kitti.yaml (PackNetSAN01 1A) through '
            'train.fit, B{} {}x{} bf16 over a KITTI_raw drive at {}x{}: {} '
            'epochs of {} steps in {:.1f} s, launches {} ({} forward and {} '
            'dgrad masked-conv launches a step); epoch {}: {:.2f} img/s with '
            'data, data {:.1f} ms | step {:.1f} ms a step; the step alone '
            '{:.2f} ms = {:.2f} img/s, peak {:.2f} GiB; {}'.format(
                bs, *shape, *KITTI_RAW, P_EPOCHS, steps, fit_s,
                {k: v for k, v in got.items() if v}, CONVS_PER_FORWARD,
                DGRADS_PER_STEP, P_EPOCHS - 1, last['img_per_s_with_data'],
                last['data_ms_per_step'], last['step_ms_per_step'], alone,
                bs * 1e3 / alone, peak, card))
        run_dir = os.path.dirname(p1.config.checkpoint.filepath)
        ckpts = sorted(f for f in os.listdir(run_dir) if f.endswith('.ckpt'))
        dtype = net.core.pre_calc.Conv_0.dtype
        del p1, net
        torch.cuda.empty_cache()
        errs, fwd_rows, dg_rows, paths = kitti_conv_rows(convs, dtype, gen,
                                                         'P1')
        del convs
        levels = {'forward': level_lines(fwd_rows, 'P1 forward'),
                  'dgrad': level_lines(dg_rows, 'P1 dgrad')}
        tot = {d: {k: sum(r[k] for r in rows) for k in
                   ('graph_ms', 'library_graph_ms', 'bound_ms', 'bytes_ms',
                    'ops_ms')}
               for d, rows in (('forward', fwd_rows), ('dgrad', dg_rows))}
        summary['p1'].update(conv_max_err=errs, conv_paths=paths,
                             levels=levels, conv_totals=tot)
        log('P1 masked convs at their own shapes (B{} {}x{}: stage 0 32 '
            'channels at half size .. stage 4 512 at 1/32), kernels vs '
            'plain max |err| {}; launch paths {}; a step in a CUDA graph: '
            'forward {:.4f} ms (cuDNN {:.4f}, bound {:.4f}), dgrad {:.4f} ms '
            '(cuDNN {:.4f}, bound {:.4f}); {}'.format(
                bs, *shape, {k: '{:.3e}'.format(v) for k, v in errs.items()},
                paths, tot['forward']['graph_ms'],
                tot['forward']['library_graph_ms'],
                tot['forward']['bound_ms'], tot['dgrad']['graph_ms'],
                tot['dgrad']['library_graph_ms'], tot['dgrad']['bound_ms'],
                card))

        # P1's eval: eval_packnet_san_kitti.yaml (dropout 0.5, in eval)
        # over the fit's checkpoint, its save pass included; the merged
        # test split keeps the velodyne entry (ROADMAP.md section 3)
        if len(ckpts) != P_EPOCHS:
            raise AssertionError('P1 checkpoints: {}'.format(ckpts))
        ckpt = os.path.join(run_dir, ckpts[-1])       # the last epoch's
        ev = ['datasets.test.path', [root], 'datasets.test.split',
              ['val.txt'], 'save.folder', os.path.join(tmp, 'outputs')]
        ev_cfg = parse_test_file(ckpt, PACKNET_SAN_EVAL, ev)[0]
        n_lidar = sum('input_depth' in b for b in make_loader(ev_cfg,
                                                                'test'))
        reset_counts()
        t0 = time.perf_counter()
        m = port_eval.test(ckpt, PACKNET_SAN_EVAL, device=dev, overrides=ev)
        eval_s = time.perf_counter() - t0
        expect('packnet_p1_eval', read_counts(),
               san_fwd=CONVS_PER_FORWARD * 2 * n_lidar)
        f32 = ev[:4] + ['save.folder', '', 'tpu.compute_dtype', 'float32']
        mk = port_eval.test(ckpt, PACKNET_SAN_EVAL, device=dev, overrides=f32)
        with plain_versions():
            mp = port_eval.test(ckpt, PACKNET_SAN_EVAL, device=dev,
                                overrides=f32)
        # the YAML's min_depth 0 bounds the inverse depth at 1e6, and the
        # log-space maps' median-scaled metrics reach 1e6 and more: each
        # metric within 1e-5 of max(1, its plain value)
        err = max(0.0 if mk[k] == mp[k] else
                  abs(mk[k] - mp[k]) / max(1.0, abs(mp[k])) for k in mp)
        for name, r in (('bf16', m), ('fp32', mk)):
            if len(r) != 6 * 7 + 1 or r.skipped or any(
                    np.isnan(v) for v in r.values()):
                raise AssertionError('P1 {} eval: {}'.format(name, r))
        if float(ev_cfg.model.depth_net.dropout) != 0.5 or n_lidar == 0:
            raise AssertionError('P1 eval: dropout {}, {} frames with LiDAR'
                                 .format(ev_cfg.model.depth_net.dropout,
                                         n_lidar))
        summary['p1']['eval'] = {'seconds': eval_s, 'metrics': dict(m),
                                 'lidar_frames': n_lidar,
                                 'fp32_kernels_vs_plain_max_err': err}
        log('P1 eval_packnet_san_kitti.yaml over the checkpoint (dropout '
            '0.5 in eval, B1 at the crop, {} frames with LiDAR): abs_rel '
            '{:.4f}, depth_gt-abs_rel {:.4f} in {:.1f} s with the save pass, '
            '{} masked-conv launches; fp32 kernels vs plain max |err| / '
            'max(1, |value|) {:.3e} over the metrics'.format(
                n_lidar, m['depth-abs_rel'], m['depth_gt-abs_rel'], eval_s,
                launches['packnet_p1_eval']['san_fwd'], err))
        if sorted(mk) != sorted(mp) or err > 1e-5:
            raise AssertionError('P1 eval through the kernels disagrees '
                                 'with the plain versions')

        # one float32 step through the kernels against the plain versions;
        # 10 steps on one batch, the loss falling
        summary['p1']['fp32_step'], _ = kernel_step_check(
            'P1', PACKNET_SAN_KITTI, p1_data, batch,
            {'san_fwd': CONVS_PER_FORWARD, 'san_dgrad': DGRADS_PER_STEP})
        summary['p1']['one_batch_losses'] = one_batch_falls(
            'packnet_p1_one_batch', PACKNET_SAN_KITTI, p1_data, batch,
            san_fwd=CONVS_PER_FORWARD, san_dgrad=DGRADS_PER_STEP)
        one = summary['p1']['one_batch_losses']
        log('P1 10 steps on one batch: loss {:.4f} -> {:.4f}'.format(
            one[0], one[-1]))

        # ----------------------------------------------------------- P1b
        # PackNetSlimSAN01 with FiLM on scales 0 and 1 and the row window
        # at 0.5, B1: the FiLM fusion, the crop and pool_denom
        b1 = {k: (v[:1] if torch.is_tensor(v) else v)
              for k, v in batch.items()}
        del batch
        _, slim = port_train.build(PACKNET_SAN_KITTI, dev, seed=0, overrides=[
            'tpu.compute_dtype', 'float32'] + p1_data + P1B)
        slim.eval()
        with torch.no_grad():
            reset_counts()
            got_fwd = slim(b1)['inv_depths'][0]
            fwd_launches = read_counts()
            with plain_versions():
                want_fwd = slim(b1)['inv_depths'][0]
        torch.cuda.synchronize()
        fwd_err = check_close('P1b forward', got_fwd, want_fwd, 1e-5, 0.0)
        expect('packnet_p1b_forward', fwd_launches, san_fwd=P1B_FWD)
        H = b1['rgb'].shape[1]
        Hw = int(H * 0.5) // 32 * 32
        if type(slim.depth_net).__name__ != 'PackNetSlimSAN01' or \
                not slim.depth_net.use_film or not 0 < Hw < H or \
                got_fwd.shape != (1, H, b1['rgb'].shape[2], 1) or \
                not bool(torch.isfinite(got_fwd).all()):
            raise AssertionError('P1b: {} FiLM {} window {} of {}, output '
                                 '{}'.format(type(slim.depth_net).__name__,
                                             slim.depth_net.use_film, Hw, H,
                                             tuple(got_fwd.shape)))
        del slim
        p1b, _ = kernel_step_check('P1b', PACKNET_SAN_KITTI, p1_data + P1B,
                                   b1, {'san_fwd': P1B_FWD,
                                        'san_dgrad': P1B_DGRAD})
        summary['p1b'] = {'forward_max_err': fwd_err, 'row_window': Hw,
                          'fp32_step': p1b}
        log('P1b PackNetSlimSAN01 (FiLM on scales 0, 1; row window {} of {} '
            'rows) B1 fp32: forward kernels vs plain max |err| {:.3e} ({} '
            'masked-conv launches)'.format(Hw, H, fwd_err, P1B_FWD))
        del b1

        # ------------------------------------------------------------ P2
        droot = os.path.join(tmp, 'ddad')
        t0 = time.perf_counter()
        write_dgp_tree(droot, P2_SCENES, P2_SAMPLES, P_CAMERAS[:1],
                       *DDAD_NATIVE, DDAD_POINTS, seed=0)
        summary['write_ddad_s'] = time.perf_counter() - t0
        log('phase P DGP tree: {} scenes x {} samples, {} at {}x{}, {} LiDAR '
            'points a sweep, in {:.1f} s'.format(
                P2_SCENES, P2_SAMPLES, P_CAMERAS[0], *DDAD_NATIVE,
                DDAD_POINTS, summary['write_ddad_s']))
        p2_data = ['datasets.train.repeat', [1], 'checkpoint.filepath', '',
                   'arch.eval_subset_size', 2]
        for split in ('train', 'validation', 'test'):
            p2_data += ['datasets.{}.path'.format(split), [droot],
                        'datasets.{}.split'.format(split), ['']]
        p2, loader, history, fit_s, got = fit(PACKNET_DDAD, p2_data + [
            'arch.max_epochs', P_EPOCHS])
        steps = P_EPOCHS * len(loader)
        expect('packnet_p2_fit', got, warp_out=WARPS_PER_STEP * steps,
               warp_dgrid=WARPS_PER_STEP * steps)
        batch = first_batch(loader)
        bs = int(p2.config.datasets.train.batch_size)
        shape = tuple(batch['rgb'].shape[1:3])
        if type(p2.model.depth_net).__name__ != 'PackNet01' or \
                batch['rgb'].shape[0] != bs or len(loader) != 2 or \
                shape != tuple(p2.config.datasets.augmentation.image_shape) \
                or len(batch['rgb_context']) != 2:
            raise AssertionError('P2: {} B{} {}, {} steps an epoch'.format(
                type(p2.model.depth_net).__name__, bs, shape, len(loader)))
        alone, peak = alone_and_peak(p2.train_step, batch)
        last = rates(history, P_EPOCHS - 1)
        summary['p2'] = {
            'fit_s': fit_s, 'steps': p2.step,
            'losses': [history[e]['train/loss'] for e in range(P_EPOCHS)],
            'val_abs_rel': [history[e]['val/depth-abs_rel']
                            for e in range(P_EPOCHS)],
            **last, 'first_epoch': rates(history, 0),
            'step_alone_ms': alone, 'img_per_s_step_alone': bs * 1e3 / alone,
            'peak_gib': peak, 'launches_per_step': {
                'warp_out': WARPS_PER_STEP, 'warp_dgrid': WARPS_PER_STEP}}
        log('P2 train_ddad.yaml (PackNet01 1A + PoseNet) through train.fit, '
            'B{} {}x{} bf16, camera_01 from {}x{} (repeat 5 -> 1): {} epochs '
            'of {} steps in {:.1f} s, launches {} ({} warp forward and {} '
            'dgrid a step); epoch {}: {:.2f} img/s with data, data {:.1f} ms '
            '| step {:.1f} ms a step; the step alone {:.2f} ms = {:.2f} '
            'img/s, peak {:.2f} GiB; {}'.format(
                bs, *shape, *DDAD_NATIVE, P_EPOCHS, len(loader), fit_s,
                {k: v for k, v in got.items() if v}, WARPS_PER_STEP,
                WARPS_PER_STEP, P_EPOCHS - 1, last['img_per_s_with_data'],
                last['data_ms_per_step'], last['step_ms_per_step'], alone,
                bs * 1e3 / alone, peak, card))
        del p2
        torch.cuda.empty_cache()

        # two steps under the float32 maps (the photometric kernels too),
        # one float32 step against the plain versions, the kernels against
        # theirs on that step's inputs; 10 steps on one batch
        reset_counts()
        run = port_train.main(PACKNET_DDAD, dev, n_steps=2, batches=[batch],
                              overrides=p2_data + FP32_MAPS)
        expect('packnet_p2_fp32_maps', read_counts(),
               **{k: v * 2 for k, v in per_step.items()})
        summary['p2']['fp32_maps_losses'] = run['losses']
        del run
        summary['p2']['fp32_step'], cases = kernel_step_check(
            'P2 (float32 maps)', PACKNET_DDAD, p2_data + FP32_MAPS, batch,
            per_step, cancelled=True)
        summary['p2']['kernels_vs_plain'] = check_recorded_kernels('P2',
                                                                   cases)
        del cases
        summary['p2']['one_batch_losses'] = one_batch_falls(
            'packnet_p2_one_batch', PACKNET_DDAD, p2_data, batch,
            warp_out=WARPS_PER_STEP, warp_dgrid=WARPS_PER_STEP)
        one = summary['p2']['one_batch_losses']
        log('P2 kernels vs plain on the fp32 step\'s own inputs {}; 10 steps '
            'on one batch: loss {:.4f} -> {:.4f}'.format(
                {k: '{:.3e}'.format(v) for k, v in
                 summary['p2']['kernels_vs_plain'].items()}, one[0], one[-1]))
        del batch

        # ------------------------------------------------------------ P3
        # train_packnet_san_ddad.yaml, validate_first, one epoch over a
        # four-camera tree: its four single-camera train entries (1 sample
        # a camera with both contexts: 4 steps at B1), its eight
        # validation entries (four with LiDAR; 3 frames each)
        qroot = os.path.join(tmp, 'ddad4')
        t0 = time.perf_counter()
        write_dgp_tree(qroot, P3_SCENES, P3_SAMPLES, P_CAMERAS,
                       *DDAD_NATIVE, DDAD_POINTS, seed=1)
        summary['write_ddad4_s'] = time.perf_counter() - t0
        log('phase P four-camera DGP tree: {} scene x {} samples, {} at '
            '{}x{}, in {:.1f} s'.format(P3_SCENES, P3_SAMPLES, P_CAMERAS,
                                         *DDAD_NATIVE,
                                         summary['write_ddad4_s']))
        p3_data = ['arch.max_epochs', 1, 'arch.eval_subset_size', 1,
                   'datasets.train.repeat', [1], 'checkpoint.filepath', '']
        for split in ('train', 'validation'):
            p3_data += ['datasets.{}.path'.format(split), [qroot],
                        'datasets.{}.split'.format(split), ['']]
        p3, loader, history, fit_s, got = fit(PACKNET_SAN_DDAD, p3_data)
        val_loaders = make_val_loaders(p3.config)
        n_lidar = sum('input_depth' in b for _, ld in val_loaders
                      for b in ld)
        net = p3.model.depth_net
        if type(net).__name__ != 'PackNetSAN01' or \
                float(net.core.dropout) != 0.5 or len(val_loaders) != 8 or \
                len(loader.dataset.datasets) != 4 or n_lidar == 0:
            raise AssertionError('P3: {} dropout {}, {} validation and {} '
                                 'train datasets, {} frames with LiDAR'
                                 .format(type(net).__name__,
                                         net.core.dropout, len(val_loaders),
                                         len(loader.dataset.datasets),
                                         n_lidar))
        # validate_first and the epoch's validation run the masked convs
        # on the LiDAR entries' frames; training reads no input depth
        expect('packnet_p3_fit', got, san_fwd=CONVS_PER_FORWARD * 2 * n_lidar)
        reset_counts()
        t0 = time.perf_counter()
        v1 = validate_multi(p3.config, p3.model, val_loaders)
        val_s = time.perf_counter() - t0
        v2 = validate_multi(p3.config, p3.model, val_loaders)
        expect('packnet_p3_validation_twice', read_counts(),
               san_fwd=CONVS_PER_FORWARD * 2 * n_lidar)
        if dict(v1) != dict(v2) or len(v1) < 8 * (6 * 7 + 1):
            raise AssertionError('P3 validation did not repeat bit for bit '
                                 '({} metrics)'.format(len(v1)))
        summary['p3'] = {
            'fit_s': fit_s, 'steps': p3.step, 'loss': history[0]['train/loss'],
            **rates(history, 0), 'validation_s': val_s,
            'lidar_frames': n_lidar,
            'val_abs_rel': {k: v for k, v in v1.items()
                            if k.endswith('/depth-abs_rel')}}
        log('P3 train_packnet_san_ddad.yaml (PackNetSAN01 dropout 0.5) '
            'through train.fit with validate_first, B1 {}x{} bf16: {} steps '
            'over 4 single-camera datasets in {:.1f} s, loss {:.4f} (finite), '
            '{:.2f} img/s with data; 8 validation datasets, {} frames with '
            'LiDAR: {} masked-conv launches in the fit (none in training), '
            'a validation {:.1f} s, repeated bit for bit; {}'.format(
                *p3.config.datasets.augmentation.image_shape, p3.step,
                fit_s, history[0]['train/loss'],
                history[0]['train/img_per_s'], n_lidar, got['san_fwd'],
                val_s, card))
        del p3, net, val_loaders
        torch.cuda.empty_cache()
    summary['phase_s'] = time.perf_counter() - t_phase
    summary['launches'] = launches
    log('phase P: {:.1f} s'.format(summary['phase_s']))
    with open('chiprun_out/chip_smoke_packnet.json', 'w') as f:
        json.dump(summary, f, indent=1, default=float)
    return launches, summary['p1']['conv_totals']


def time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv):
    """One forward conv's kernel, plain and library (dense bf16 F.conv2d +
    bias times the mask, channels-last) times and its bound; x is read only
    in the rows within k//2 of an active output row."""
    import torch
    import torch.nn.functional as F
    x, mk, kern, bias = conv_inputs(mod, mask, dtype, gen)
    k, _, cin, cout = kern.shape
    B, H, W, _ = x.shape
    x_cl = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    w_oihw = kern.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    m_nchw = mk.permute(0, 3, 1, 2)
    def kernel():
        return san_conv._launch(x, mk, kern, bias)

    def library():
        return F.conv2d(x_cl, w_oihw, bias, padding=k // 2) * m_nchw

    with torch.no_grad():
        ms, graph = cuda_time_ms(kernel), graph_time_ms(kernel)
        plain = cuda_time_ms(
            lambda: san_conv.masked_conv2d_reference(x, mk, kern, bias))
        lib, lib_graph = cuda_time_ms(library), graph_time_ms(library)
    active, _, x_rows, tiles = site_stats(mk, k)
    nbytes = (x_rows * W * cin + kern.numel() + bias.numel() +
              B * H * W * cout) * esize + mk.numel() * 4
    b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                              dname)
    row = {'conv': i, 'B': B, 'H': H, 'W': W, 'k': int(k), 'cin': int(cin),
           'cout': int(cout), 'dtype': dname, 'active_sites': active,
           'active_site_frac': active / (B * H * W),
           'active_tile_frac': tiles, 'ms': ms, 'graph_ms': graph,
           'plain_ms': plain, 'library_ms': lib,
           'library_graph_ms': lib_graph, 'bound_ms': b_all,
           'bytes_ms': b_ms, 'ops_ms': o_ms, 'bound_by': 'bytes'
           if b_ms > o_ms else 'operations',
           'path': launch_path(x, kern, False)}
    log('conv {:2d} B{} {}x{} k{} {:4d}->{:4d} sites {:.3f} tiles {:.3f} {}: '
        'kernel {:.4f} ms (graph {:.4f}) plain {:.4f} library {:.4f} '
        '(graph {:.4f}) bound {:.4f} ({})'.format(
            i, B, H, W, k, cin, cout, row['active_site_frac'], tiles,
            row['path'], ms, graph, plain, lib, lib_graph, b_all,
            row['bound_by']))
    return row


def time_dgrad(i, mod, mask, dtype, dname, esize, gen, san_conv):
    """One dgrad conv's kernel, plain and library (cuDNN conv2d_input,
    channels-last) times and its bound; gm is read only in its rows with
    an active site (zero elsewhere)."""
    import torch
    import torch.nn.functional as F
    gm, mk, kern = dgrad_inputs(mod, mask, dtype, gen)
    k, _, cin, cout = kern.shape
    B, H, W, _ = gm.shape
    w_oihw = kern.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    g_cl = gm.permute(0, 3, 1, 2)       # NCHW view, channels-last memory

    def kernel():
        return san_conv._launch_dgrad(gm, mk, kern)

    def library():
        return torch.nn.grad.conv2d_input((B, cin, H, W), w_oihw, g_cl,
                                          padding=k // 2)

    with torch.no_grad():
        ms, graph = cuda_time_ms(kernel, iters=10), graph_time_ms(kernel)
        plain = cuda_time_ms(
            lambda: san_conv.masked_conv2d_dgrad_reference(gm, mk, kern),
            iters=10)
        lib = cuda_time_ms(library, iters=10)
        lib_graph = graph_time_ms(library)
    active, act_rows, _, tiles = site_stats(mk, k)
    nbytes = (act_rows * W * cout + kern.numel() + B * H * W * cin) * \
        esize + mk.numel() * 4
    b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                              dname)
    halo_tiles = float((F.max_pool2d(F.pad(
        (~halo_empty(mk, k))[..., 0].float()[:, None],
        (0, -W % 16, 0, -H % 8)), (8, 16), (8, 16)) > 0).float().mean())
    row = {'conv': i, 'B': B, 'H': H, 'W': W, 'k': int(k),
           'cin': int(cin), 'cout': int(cout), 'dtype': dname,
           'active_sites': active, 'active_site_frac':
           active / (B * H * W), 'active_tile_frac': tiles,
           'halo_tile_frac': halo_tiles, 'ms': ms, 'graph_ms': graph,
           'plain_ms': plain, 'library_ms': lib,
           'library_graph_ms': lib_graph, 'bound_ms': b_all,
           'bytes_ms': b_ms, 'ops_ms': o_ms,
           'bound_by': 'bytes' if b_ms > o_ms else 'operations',
           'path': launch_path(gm, kern, True)}
    log('dgrad {:2d} {}x{} k{} {:4d}<-{:4d} sites {:.3f} halo tiles {:.3f} '
        '{}: kernel {:.4f} ms (graph {:.4f}) plain {:.4f} library {:.4f} '
        '(graph {:.4f}) bound {:.4f} ({})'.format(
            i, H, W, k, cin, cout, row['active_site_frac'], halo_tiles,
            row['path'], ms, graph, plain, lib, lib_graph, b_all,
            row['bound_by']))
    return row


if __name__ == '__main__':
    sys.exit(main())
