#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (wesep_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script exits 0 only when all
pass):

1. device: the card's name, power limit and the torch/CUDA versions;
2. build: every CUDA kernel of the serving and training paths, from csrc/
   with nvcc (one nvcc per source, started together), with the nvcc logs;
3. kernels: each kernel against its plain PyTorch version on the card, in
   f32 and bf16, with its time, its plain version's time, a library call's
   time for the same function (where one exists) and the card's bound for
   the work: the BiLSTM forward kernel at the serving shapes, the forward
   kernel with the cell-state output and the two backward kernels at the
   training shapes; then the fused TCN block, forward and backward, at
   SpEx+'s serving shape (2 rows) and training shape (16 rows) at
   dilations 1 and 128, each run twice bit for bit, with each launch's
   time (CUDA events between launches) and the time of the block's
   products alone in torch.matmul (`products_library_ms`, f32 with TF32
   off), and one speaker-fused block through its module;
   then the unfold-fused BiLSTM layer (forward, serial adjoint, weight
   gradients, with cuDNN's LSTM over the materialised frames as yardstick)
   at TF-GridNet's intra and inter RNN shapes for serving (2 rows x 3 s)
   and training (8 rows x 1 s), in f32 and bf16, and once at hs 2, with
   the weight gradients repeated bit for bit; and the plain layer's
   kernels at TF-GridNet's materialised shapes (D = H = 192); then the
   tensor-core bf16 backward of the LSTM layers (gate products, cluster
   chain, dx, dW) at every training shape of the four routes, each kernel
   against its plain version, the whole backward against the route's plain
   backward, run twice bit for bit, timed beside cuBLAS; the tensor-core
   bf16 forward of the LSTM layers (the projection in the chain's order,
   the cluster recurrence) at the same shapes, likewise, timed beside
   cuBLAS's projection and cuDNN's LSTM forward, with the clusters the card
   runs at once (bf16 LSTM forwards of phases 3-13 at shapes
   cuda_lstm_tc.forward_fits takes run these kernels); the f32 cluster
   forward of the LSTM layers (the FMA projection in the chain's order, the
   recurrence over clusters of H / 32 blocks with Wh in registers) at every
   f32 shape serving and the validation step run, each kernel against its
   plain version, the whole forward against the route's plain forward,
   twice bit for bit, timed beside cuBLAS's f32 projection, cuDNN's f32
   LSTM forward (TF32 off), the route's own FMA forward kernel and the
   bound, with the clusters the card runs at once (f32 LSTM forwards of
   phases 3-13 at shapes cuda_lstm_f32.f32_forward_fits takes run these
   kernels); the f32 backward of the LSTM layers (the FMA gates product in
   the chain's order, the adjoint chain over clusters of H / 32 blocks
   with Wh in registers, dx, dW) at every f32 training shape (K0 at the
   pBSRNN's band and comm and the v2 TF-GridNet's two shapes, K3 at the
   latter, K2 and K1 at the former), each kernel against its plain
   version, the whole backward against the route's plain backward, twice
   bit for bit, timed beside cuBLAS's f32 products, cuDNN's whole f32
   backward (TF32 off), the route's own FMA backward kernels and the
   bounds, with the clusters the card runs at once (f32 LSTM backwards of
   phases 3-14 at shapes cuda_lstm_f32.f32_backward_fits takes run these
   kernels); each route's own FMA forward, adjoint and weight-gradient
   kernels through the layers at a shape those gates refuse (H 96); and
   the TCN block
   and the Conv2dBlock past one grid dimension (B = 65537, and K4 at a T of
   more than 65535 element-wise chunks);
4. serve: the full-width v1 pBSRNN (feature_dim 128, 6 repeats, multiply
   fuse, 256-d embeddings; random weights from a seed) decodes a small
   shard through the port's bin/infer on the card; the launch counts must
   show 12 launches of the f32 cluster chain and 12 of the f32 projection
   per forward, none of the route's own FMA forward kernel, and the kernel
   forward must agree with the plain-LSTM forward of the same model;
5. train: the same model trains through the port's bin/train on the card,
   in bf16 at batch_size 8 (16 rows x 3 s per step), a few steps and one
   validation pass on synthetic shards; the launch counts must show, per
   bf16 train step, 12 launches of each of the two tensor-core forward
   kernels (projection, chain) and of each of the four tensor-core backward
   kernels (gates, chain, dx, dW), and 12 of the f32 cluster chain and
   projection per f32 validation step, none of them in the train steps;
   losses must be finite,
   the parameters
   must move, and the checkpoint must hold parameters, optimizer state and
   step and load as bin/infer loads it. Then the gradients of every
   parameter through the kernels against those through the plain LSTM
   (f32, 2 rows x 3 s, through the f32 cluster forward and the f32
   backward, 12 of each kernel counted; and bf16, through the tensor-core
   ones),
   and the time and peak
   memory of a train step;
6. serve SpEx+: the full-width ConvTasNet of
   examples/librimix/tse/v2/confs/spexplus.yaml (random weights from a
   seed) decodes a small shard with 6 s enrollment wavs through bin/infer:
   32 launches of the fused block per forward, kernel forward against the
   plain blocks' forward;
7. train SpEx+: the same model trains through bin/train with the recipe's
   loss table ([SISDR, CE] over the three scales and the speaker logits),
   bf16, batch_size 8 (16 rows x 3 s), a few steps and one validation
   step: 32 forward and 32 backward launches per train step, 32 forward
   per validation step; finite losses, parameters and BatchNorm statistics
   that moved, a checkpoint that bin/infer decodes from, whole-model
   gradients through the kernels against those through the plain blocks,
   and the time and peak memory of a train step;
8. serve TF-GridNet: the full-width model of
   examples/librimix/tse/v1/confs/tfgridnet.yaml (random weights from a
   seed) decodes a small shard through bin/infer twice, with
   WESEP_LSTM_UNFOLD=1 (the unfold-fused layer) and without it (the plain
   layer over materialised frames): each of its 12 f32 BiLSTM forwards one
   launch of the f32 cluster chain and of the f32 projection, none of
   either route's own FMA forward kernel; on each route the kernels'
   forward against the plain versions' forward, and the step time;
9. train TF-GridNet: the same model trains through bin/train with
   WESEP_LSTM_UNFOLD=1, bf16, batch_size 4 (8 rows x 1 s), a few steps
   and one validation step: 12 launches of each tensor-core forward and
   backward kernel per train step, 12 of the f32 cluster chain and
   projection per validation step (the f32 backward's kernels on the f32
   gradient check); finite losses,
   parameters that moved, a checkpoint that bin/infer decodes from,
   whole-model gradients through the kernels against those through the
   plain versions, and the time and peak memory of a train step on both
   routes;
10. serve DPCCN: the full-width model of
   examples/librimix/tse/v1/confs/dpccn.yaml (random weights from a seed)
   decodes a small shard through bin/infer on conv_impl "pallas" (exactly
   7 launches of the fused Conv2dBlock kernel per forward) and on the
   default "xla" route (none); the two routes' estimates against each
   other, the kernels' forward against the plain versions', the step time;
11. train DPCCN: the same model trains through bin/train on conv_impl
   "pallas", bf16, batch_size 4 (8 rows x 3 s), a few steps and one
   validation step: 7 forward and 7 backward launches per train step, 7
   forward per validation step; finite losses, parameters that moved, a
   checkpoint that bin/infer decodes from, whole-model gradients through
   the kernels against those through the plain versions, and the time and
   peak memory of a train step on both routes.

12. the pBSRNN on WESEP_LSTM_LAYER=0: phases 4 and 5 again with every
   BiLSTM on the two-kernel layer (the projection a cuBLAS product, the
   recurrence on the f32 cluster chain in f32, its adjoint and dWh K2b):
   12 launches of the f32 cluster chain per forward and none of the fused
   layer's kernels or K2, 12 of the gates, chain and dW kernels per
   bf16 train step (K2b's own kernels on the f32 gradient check); the
   forward and a train step also timed on the default route in the same
   process, in turns;
13. the unidirectional pBSRNN (`--set
   model_args.tse_model.use_bidirectional=false`): phases 4 and 5 again
   with 12 launches of the f32 cluster chain per forward (none of K1) and
   12 of the gates, chain and dW kernels per bf16 train step (K1b's own on
   the f32 gradient check).
14. the joint v2 recipes (examples/librimix/tse/v2/confs: ResNet34 on the
   enrollment's 80-bin fbank, whose f32 embedding promotes everything
   after the speaker fuse to f32 in a bf16 step, as in the JAX package):
   (a) the speaker branch's ops on the card against the same calls on the
   CPU (Kaldi fbank of 16 x 3 s, the consistent frontend of 2 x 6 s,
   ResNet34 on fbank [2, 598, 80] in eval mode and [16, 598, 80] in train
   mode with its statistics), with cuDNN's TF32 off and on, each timed;
   (b) the full-width v2 BSRNN decodes a shard with 6 s enrollment wavs
   through bin/infer (fbank on the host): 12 f32 cluster chains and 12 f32
   projections per forward, the forward's time and the speaker branch's
   share of it, kernels against the plain LSTM; (c) it trains through
   bin/train (bf16 compute dtype, 16 rows x 3 s, a few steps and one
   validation step): per train step 12 f32 forwards with cs and 12 of each
   f32 backward kernel (gates, adjoint chain, dx, dW), the encoder's
   statistics move, average_model
   -> bin/infer decodes, spk_model_freeze keeps the encoder bit for bit;
   the host data plane's rate; the whole joint model's f32 gradients
   (encoder included) against the plain LSTM's; a step's time, peak memory
   and its f32 LSTM wrappers' device time; (d) one step with
   SSA_enroll_prob 1, its BatchNorm buffers moved once; (e) the v2
   TF-GridNet (4 rows x 3 s) and DPCCN (12 rows x 3 s): a served forward
   and a train step each, with launch counts. Phase 3 also holds the f32
   K0 with cs, K0b and K3/K3b at the v2 TF-GridNet's training shapes.
15. MetricGAN on DPCCN (examples/librimix/tse/{v1,v2}/confs/
   dpcc_init_gan.yaml) and BSRNN_Multi (v2 bsrnn_multi_optim.yaml): (a)
   P.862 (ops/pesq.py) on the card against the same call on the CPU, 4
   rows x 3 s at 8 and 16 kHz, within 1e-4 MOS, a call timed; (b) the
   full-width CMGAN discriminator's forward and backward on the card
   against the CPU (f32, TF32 off; 1e-4 of the largest score, gradients
   rel. L2 1e-3), u moved by one power step per train-mode call and not in
   eval mode; (c) bin/train_gan on the v1 conf (full-width DPCCN, the
   default discriminator, 8 rows x 3 s, f32 as in the JAX package) on the
   recipe's "xla" route (no K5/K5b) and under conv_impl=pallas (7 f32 K5
   and 7 f32 K5b a GAN step, 7 K5 a validation step): finite g_loss,
   se_loss and d_loss, both models' parameters and D's u moved, a run
   resumed from --checkpoint that restores both models and both
   optimizers, average_model -> bin/infer; the generator's f32 gradients
   of the GAN loss through K5/K5b against the plain versions (rel. L2
   1e-3); the GAN step's time, peak memory and PESQ share on both routes;
   (d) one GAN step of the v2 conf (ResNet34 on 6 s enrollment fbank), its
   statistics moved once; (e) BSRNN_Multi through bin/train (full width,
   ResNet34 on the consistent frontend of 6 s enrollment wavs, bf16, 8
   rows x 3 s): per train step 24 f32 chains with cs, 24 projections and
   24 of each f32 backward kernel, per validation step and served forward
   12 chains and projections; average_model -> bin/infer; the whole
   model's f32 gradients (both passes, the encoder included) against the
   plain LSTM's (rel. L2 1e-3); a step's time and peak memory, TF32 off
   and on. Phase 3 also holds K5/K5b in f32 at the GAN step's rows (4 and
   8) at the six shapes.
16. BSRNN_Feats (examples/librimix/tse/v2/confs/bsrnn_feats.yaml: the
   tfmap_emb TF map and cross_multiply fusion over ECAPA-TDNN's frame
   features, spk_model_freeze), its encoders and data parallelism: (a)
   ECAPA_TDNN_GLOB_c512 in the tpu and wespeaker layouts and CAMPPlus
   (embed 192) on the card against the same module and weights on the
   CPU, on the fbank of 6 s enrollments, eval mode at 2 rows and train
   mode at 4, TF32 off (embeddings and frame features rel. L2 1e-4, the
   statistics after one train call 1e-5 of their largest), the forward at
   2 rows and forward + backward at 4 rows timed beside their bounds; (b)
   the conf through bin/infer, 10 requests of 2 rows x 3 s with 6 s
   enrollments, f32: 12 f32 cluster chains and projections a forward,
   finite outputs, the step's time, audio-s/s, RTF and the two encoder
   calls' share, kernels against the plain LSTM; (c) through bin/train
   (bf16 compute, 2 steps of 4 rows x 3 s and a validation step): per
   train step 12 f32 forwards with cs and 12 of each f32 backward kernel
   (the stream is f32 after the cross fuse), the frozen encoder bit for
   bit while its statistics move, the whole model's f32 gradients through
   the kernels against the plain LSTM's (rel. L2 1e-3), a step's time,
   peak memory, the encoder's and the cross-attention's device ms; (d)
   bin/train on phase 5's pBSRNN (2 steps of 16 rows x 3 s) under
   WESEP_DIST=1 with a one-process NCCL group: losses, parameters and
   buffers bit for bit those of the run without WESEP_DIST, both timed;
   (e) only where 2 or more cards are present (the run with no arguments
   needs one): make_train_step under DistributedDataParallel in an NCCL
   group of one process a card (up to 4), 2 rows each, against one process
   on all their rows (f32: loss, gradient, BatchNorm statistics and
   parameters at the CPU test's limits, the ranks bit for bit), and
   bin/train on bsrnn_feats.yaml under WESEP_DIST=1 across the cards (the
   ranks end bit for bit equal; only rank 0 writes).
   Phase 3 also holds K0's f32 forward (with cs) and backward at
   BSRNN_Feats' train shapes (band T 376 x B' 128, comm T 32 x B' 1504).
17. online mixing (examples/voxceleb1/v2/confs/bsrnn_online.yaml: the joint
   ResNet34 BSRNN at feature_dim 128, 6 repeats; reverb 0.5, noise 0.5,
   random SNRs): (a) the simulation of a batch of the conf (8 mixtures x 2
   x 3 s; data/augment.py: FRAM-RIR, cuFFT convolution, SNR mixing, noise)
   on the card against the same call on the CPU on the same draws (RIRs
   rel. L2 1e-4, the taps whose integer delay moved counted; mixture and
   targets 1e-4 of their largest), a repeat from the same generator state
   bit for bit, its time by CUDA events beside its bound; (b) the conf
   through bin/train on synthetic single-speaker shards of 8 speakers (4-6
   s utterances), a noise pack built by the port's tools/make_noise_db
   from synthetic noise_*, music_* and speech_* wavs and a premixed
   validation shard: 2 steps of 8 mixtures and a validation step with the
   simulation on the card, 12 f32 forwards with cs and 12 of each f32
   backward kernel a train step, 12 f32 forwards a validation step, finite
   losses, the epoch's audio-s/s; a step's time, peak memory and the
   simulation's share; (c) one step with device_augment false (the host
   simulates), and the host chain's audio-s/s in one thread on both paths.

Phase 3 also holds the fused Conv2dBlock (K5 forward, K5b backward) against
its plain versions at the six distinct shapes DPCCN gives it (T 376), at
serving (2 rows, f32) and training (8 rows, bf16) size, each pass twice
bit for bit, with each launch's time (CUDA events between launches), and
as notes DPCCN's "xla" Conv2dBlock at the same shape (`xla_route_ms`:
forward alone, forward + autograd backward; cuDNN with TF32 off) and
cuDNN's conv alone, forward and backward; and the two-kernel layers, both
directions (K2, K2b) and one (K1, K1b), at the pBSRNN's band and comm
shapes: the forward at the serving size in f32, the forward, serial
adjoint and weight gradients at the training size in bf16, with cuDNN's
LSTM and a cuBLAS product as yardsticks.

The last lines are the script's wall time, the card line of nvidia-smi,
one JSON object describing the kernels, and {"ok": true, "device":
{...}}.

    python3 chip_smoke.py --only-conv2d

runs phases 1 and 2 for the Conv2dBlock's two sources and phase 3's K5/K5b
cases only, one JSON line each, and prints no final line.

    python3 chip_smoke.py --only-phase15

runs phases 1 and 2, phase 3's f32 K5/K5b cases at the GAN step's rows and
phase 15, and prints no final line.

    python3 chip_smoke.py --only-phase16

runs phases 1 and 2, phase 3's f32 K0 / K0b cases at BSRNN_Feats' train
shapes and phase 16, and prints no final line.

    python3 chip_smoke.py --only-phase17

runs phases 1 and 2 and phase 17, and prints no final line.

    python3 chip_smoke.py --only-ddp

(2 or more cards) runs phases 1 and 2 and phase 16 (e) alone, and prints
no final line.
"""

import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

SEED = 0
D, H = 128, 256  # BSRNN feature_dim 128 -> BiLSTM input 128, hidden 256
MAIN_SHAPES = {"band": (376, 64), "comm": (32, 752)}  # (T, B') at 2 rows x 3 s
TRAIN_SHAPES = {"band": (376, 512), "comm": (32, 6016)}  # at 16 rows x 3 s
TRAIN_BATCH = 8     # mixtures per step; the collator makes 2 rows of each
TRAIN_STEPS = 4     # epoch_iter of the training run
CHUNK = 48000       # 3 s
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM
PEAK_BYTES = 3.35e12
V1_MODEL_ARGS = dict(sr=16000, win=512, stride=128, feature_dim=128,
                     num_repeat=6, spk_fuse_type="multiply",
                     use_spk_transform=False, multi_fuse=False,
                     joint_training=False, spk_emb_dim=256)
SHARD_SECONDS = (3.0, 3.0, 3.0, 3.0, 4.37)
# SpEx+ (examples/librimix/tse/v2/confs/spexplus.yaml) at full width
SPEX_MODEL_ARGS = dict(N=256, L=20, B=256, H=512, P=3, X=8, R=4,
                       spk_emb_dim=256, norm="gLN", causal=False,
                       skip_con=False, spk_fuse_type="concatConv",
                       multi_fuse=True, encoder_type="Multi",
                       decoder_type="Multi", joint_training=True,
                       multi_task=True, spks_in_train=251)
SPEX_BLOCKS = SPEX_MODEL_ARGS["R"] * SPEX_MODEL_ARGS["X"]  # fused blocks
SPEX_T = (CHUNK - 20) // 10 + 1  # 4799 encoder frames of a 3 s chunk
SPEX_TRAIN_STEPS = 3
ENROLL_SECONDS = 6.0
TCN_C, TCN_H, TCN_K = 256, 512, 3
BUCKET = 16000
ROWS_PER_STEP = 2

# TF-GridNet (examples/librimix/tse/v1/confs/tfgridnet.yaml) at full width
GRID_MODEL_ARGS = dict(n_srcs=1, sr=16000, n_fft=128, stride=64,
                       n_layers=6, lstm_hidden_units=192, attn_n_head=4,
                       attn_approx_qk_dim=512, emb_dim=48, emb_ks=4,
                       emb_hs=1, spk_emb_dim=256, spk_fuse_type="multiply",
                       joint_training=False)
GRID_C, GRID_H, GRID_KS = 48, 192, 4
GRID_RNNS = 2 * GRID_MODEL_ARGS["n_layers"]  # intra + inter per block
GRID_BATCH = 4         # the conf's batch_size: 8 rows of 1 s per step
GRID_CHUNK = 16000
GRID_TRAIN_STEPS = 4
# parameters whose true gradient is zero, so that two correct versions
# return rounding noise: the keys' norm bias adds one logit to every key of
# a query, which the softmax cancels; the real part of the deconv bias is a
# constant spectrum, an impulse at the first sample of each frame, where
# the periodic Hann window is 0
GRID_NOISE_ONLY = ("attn_norm_K_bias", "deconv.bias")

# DPCCN (examples/librimix/tse/v1/confs/dpccn.yaml) at full width
DPCCN_MODEL_ARGS = dict(win=512, stride=128, sr=16000, spk_emb_dim=256,
                        spk_fuse_type="multiply", tcn_dims=384,
                        tcn_blocks=10, tcn_layers=2, use_spk_transform=False,
                        joint_training=False)
DPCCN_FUSED = 7        # Conv2dBlocks per forward on conv_impl "pallas"
DPCCN_BATCH = 4        # the conf's batch_size: 8 rows of 3 s per step
DPCCN_TRAIN_STEPS = 4
DPCCN_CLIP = 3.0       # the conf's clip_grad
CONV_T = 376           # frames of a 3 s chunk
# the fused block's shapes on DPCCN's path, (module, F, Ci, Co); dec7.conv1
# has enc0.conv2's
CONV_SHAPES = [("enc0.conv1", 257, 16, 16), ("enc0.conv2", 257, 32, 16),
               ("enc1_dense.conv1", 129, 32, 32),
               ("enc2_dense.conv1", 65, 32, 32),
               ("enc3_dense.conv1", 33, 32, 32),
               ("enc4_dense.conv1", 17, 32, 32)]
# parameters with a rounding-noise gradient: a TCN block's depthwise bias
# feeds an instance norm directly; the real part of the output deconv's
# bias is a constant spectrum (Hann window 0 at a frame's first sample);
# and near-cancelling ones: every conv block's bias feeds ELU -> instance
# norm, where only the ELU's negative branch keeps its gradient
DPCCN_NOISE_ONLY = ("dconv1.bias", "deconv2d.bias")
DPCCN_NEAR_CANCELLING = ("conv.bias",)

# The joint v2 recipes (examples/librimix/tse/v2/confs/{bsrnn,tfgridnet,
# dpccn}.yaml): ResNet34 (m_channels 32) embeds the enrollment's 80-bin
# fbank (speaker_feat, 6 s: 598 frames), and its f32 embedding promotes the
# separator after the speaker fuse to f32 in a bf16 step
V2_SPK_ARGS = dict(feat_dim=80, embed_dim=256, pooling_func="TSTP",
                   two_emb_layer=False)
V2_JOINT = dict(joint_training=True, spk_model="ResNet34",
                spk_args=V2_SPK_ARGS, spk_feat=True, feat_type="consistent",
                multi_task=False, spksInTrain=251)
V2_BSRNN_ARGS = dict(V1_MODEL_ARGS, **V2_JOINT, spk_model_freeze=False,
                     remat=False)
V2_GRID_ARGS = dict(GRID_MODEL_ARGS, **V2_JOINT, remat=False)
V2_DPCCN_ARGS = dict(DPCCN_MODEL_ARGS, **V2_JOINT)
V2_FBANK = {"num_mel_bins": 80, "frame_shift": 10, "frame_length": 25,
            "dither": 1.0}
ENROLL_FRAMES = int(ENROLL_SECONDS * 1000 / V2_FBANK["frame_shift"]) - 2
V2_GRID_BATCH, V2_DPCCN_BATCH = 2, 6  # the confs' batch_size (rows 2x)
# the speaker ops on the card against the CPU: fbank relative to its
# largest value, ResNet34's embedding and statistics relative L2; with
# cuDNN's TF32 (10-bit significands in every product of 36 convolutions)
SPEAKER_OPS_LIMIT = 1e-4
SPEAKER_TF32_LIMIT = 5e-2


def resnet_flops(frames, feat=80, m=32, blocks=(3, 4, 6, 3), embed=256):
    """2 x the multiply-adds of a BasicBlock ResNet's convolutions and its
    embedding layer on one [frames, feat] fbank (TSTP: 2 F' C inputs)."""
    f, t, cin = feat, frames, m
    macs = f * t * m * 9
    for stage, (n, stride) in enumerate(zip(blocks, (1, 2, 2, 2))):
        planes = m * 2 ** stage
        for i in range(n):
            s = stride if i == 0 else 1
            f, t = -(-f // s), -(-t // s)
            macs += f * t * (cin + planes) * planes * 9
            if s != 1 or cin != planes:
                macs += f * t * cin * planes
            cin = planes
    return 2 * (macs + 2 * f * cin * embed)


RESNET34_FLOPS_PER_ROW = resnet_flops(ENROLL_FRAMES)


def grid_rnn_shapes(rows, samples):
    """(B', L) of the intra (frequency) and inter (time) RNNs of a
    TF-GridNet block for `rows` rows of `samples` samples: the frames and
    the 65 bins, each padded by 2 * (emb_ks - emb_hs) (hs 1)."""
    olp = GRID_KS - GRID_MODEL_ARGS["emb_hs"]
    t_pad = samples // GRID_MODEL_ARGS["stride"] + 1 + 2 * olp
    q_pad = GRID_MODEL_ARGS["n_fft"] // 2 + 1 + 2 * olp
    return {"intra": (rows * t_pad, q_pad), "inter": (rows * q_pad, t_pad)}


# the unfold-fused layer at TF-GridNet's shapes: serving 2 rows x 3 s and
# training 8 rows x 1 s
UNFOLD_SHAPES = {
    f"{path}_{rnn}": shape
    for path, rows, samples in (("serve", ROWS_PER_STEP, CHUNK),
                                ("train", 2 * GRID_BATCH, GRID_CHUNK))
    for rnn, shape in grid_rnn_shapes(rows, samples).items()}
# and the joint v2 TF-GridNet's training shapes: 4 rows x 3 s, in f32
V2_GRID_SHAPES = {f"v2_train_{rnn}": shape for rnn, shape in
                  grid_rnn_shapes(2 * V2_GRID_BATCH, CHUNK).items()}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, warmup=2, runs=10):
    """Median of `runs` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_wgrad_ms(a_mats, dg):
    """The cuBLAS yardsticks of a weight-gradient kernel, a_mats one [rows,
    K] per direction and dg [dirs, ..., 4H], each timed whole: (one batched
    product a^T @ dg over every direction's operands, the one PyTorch call
    for the function; one product per direction, back to back)."""
    a = torch.stack(a_mats)
    g = dg.reshape(a.shape[0], a.shape[1], -1)
    batched = time_ms(lambda: torch.bmm(a.transpose(1, 2), g), 1, 5)
    apart = time_ms(lambda: [torch.matmul(a_d.t(), g_d)
                             for a_d, g_d in zip(a, g)], 1, 5)
    return batched, apart


def host_ms(fn, runs=5):
    """Median host time to return from fn() on an idle card: the time to
    enqueue its work. Near the device time, the host paces the card."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def tolerance(ref):
    """Max abs error allowed against the plain version: 1e-4 in f32 (the
    sum order differs over T steps); in bf16, 4 units in the last place at
    the output's largest magnitude, since h is rounded to bf16 every step
    and a different f32 sum order may flip one rounding."""
    if ref.dtype == torch.float32:
        return 1e-4
    amax = max(ref.float().abs().max().item(), 2.0 ** -126)
    return 4 * 2.0 ** (math.floor(math.log2(amax)) - 7)  # 8-bit significand


def bilstm_bound(t_len, batch, dtype, d=D, h=H, x_elems=None):
    """Least time of one BiLSTM layer on the card: the larger of its
    operations over the peak rate of its type and its bytes (x, weights
    and biases read once, y written once) over the memory rate. d is the
    length of a step's input row, `x_elems` as in backward_bounds."""
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * 2 * t_len * batch * (d + h) * 4 * h
    x_elems = batch * t_len * d if x_elems is None else x_elems
    nbytes = (x_elems * size + 2 * (d + h) * 4 * h * size
              + 2 * 4 * h * 4 + batch * t_len * 2 * h * size)
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def check_kernel(name, t_len, batch, dtype, d=D, h=H):
    """Kernel vs plain version (and cuDNN) at one main-path shape."""
    from wesep_tpu_torch.ops.cuda_lstm import (
        bilstm_layer,
        bilstm_layer_reference,
    )

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda().to(dtype)

    def weights(sfx):
        p = {n: getattr(lstm, n + sfx).detach() for n in
             ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
        return (p["weight_ih_l0"].t().contiguous(),
                (p["bias_ih_l0"].float() + p["bias_hh_l0"].float()),
                p["weight_hh_l0"].t().contiguous())

    args = (x, *weights(""), *weights("_reverse"))
    y = bilstm_layer(*args)
    torch.cuda.synchronize()
    ref = bilstm_layer_reference(*args)
    with torch.inference_mode():
        lib = lstm(x)[0]
    err = (y.float() - ref.float()).abs().max().item()
    err_lib = (y.float() - lib.float()).abs().max().item()
    tol = tolerance(ref)
    ms = time_ms(lambda: bilstm_layer(*args))
    plain_ms = time_ms(lambda: bilstm_layer_reference(*args), 1, 5)
    with torch.inference_mode():
        library_ms = time_ms(lambda: lstm(x))
    bound_ms, bound_by = bilstm_bound(t_len, batch, dtype, d, h)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": d, "H": h,
        "max_abs_err": err, "tolerance": tol,
        "kernels": forward_kernels(dtype, d, h, batch * t_len),
        "max_abs_err_vs_cudnn": err_lib,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log("kernel bilstm_layer", json.dumps(case))
    if not (err <= tol and err_lib <= tol and torch.isfinite(y).all()):
        raise AssertionError(f"bilstm_layer disagrees at {case}")
    return case


def _bound(flops, nbytes, dtype):
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def backward_bounds(t_len, batch, dtype, d=D, h=H, x_elems=None):
    """Least times of the two backward kernels on the card, and of the
    forward kernel when it also writes the cell states. Operations per
    product 2 * T * B * K * 4H for each direction; bytes: every input read
    once, every output written once (the dg scratch is an output of the
    serial kernel and an input of the weight-gradient kernel). d is the
    length of a step's input row; `x_elems`, where given, the elements of
    the stream the rows are read from (the unfold-fused layer reads its
    frames from a raw stream of B * L * C elements)."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows, h4 = t_len * batch, 4 * h
    product = 2 * 2 * rows * (d + h) * h4  # both directions, one K = d + h
    weights = 2 * (d + h) * h4 * size + 2 * h4 * 4
    x_b = (rows * d if x_elems is None else x_elems) * size
    y_b, cs_b = rows * 2 * h * size, rows * 2 * h * 4
    dg_b = 2 * rows * h4 * size
    forward = _bound(product, x_b + weights + y_b + cs_b, dtype)
    # recompute of the gates, then dh and dx
    serial = _bound(2 * product, x_b + 2 * weights + y_b + cs_b + y_b
                    + 2 * rows * d * size + dg_b
                    + (batch + 7) // 8 * 2 * h4 * 4, dtype)
    splits = max(1, min(8, -(-rows // 4096)))
    wgrad = _bound(product, x_b + y_b + dg_b
                   + splits * 2 * (d + h) * h4 * 4, dtype)
    return forward, serial, wgrad


def forward_kernels(dtype, d, h, rows, c=None):
    """The kernels a layer forward at these shapes runs: the tensor-core
    projection (d > 0) and chain where cuda_lstm_tc.forward_fits takes the
    shapes (bf16), the f32 projection and cluster chain where
    cuda_lstm_f32.f32_forward_fits takes them (f32), the route's own FMA
    forward kernel otherwise."""
    from wesep_tpu_torch.ops.cuda_lstm_f32 import f32_forward_fits
    from wesep_tpu_torch.ops.cuda_lstm_tc import forward_fits

    if forward_fits(dtype, d, h, rows, c=c):
        return ["lstm_project", "lstm_forward_chain"] if d else \
            ["lstm_forward_chain"]
    if f32_forward_fits(dtype, d, h, rows, c=c):
        return list(F32_FORWARD_NAMES) if d else [F32_FORWARD_NAMES[1]]
    return ["own FMA kernel"]


def rel_err(got, ref):
    """Max abs error relative to the reference's largest magnitude."""
    scale = max(ref.float().abs().max().item(), 1e-12)
    return (got.float() - ref.float()).abs().max().item() / scale


def check_training_kernels(name, t_len, batch, dtype, d=D, h=H):
    """Forward with cell states and both backward kernels against their
    plain versions (and cuDNN's forward + backward) at one training shape.

    Limits, relative to the largest magnitude of the plain version's
    result: f32 1e-4 (dW sums 192,512 terms in another order; the order is
    fixed, so the result does not change from run to run); bf16 2e-2 for
    dx, dW and db (dgates and dh are rounded to bf16 at every step, and a
    sum that differs in its last bit flips such a rounding now and then),
    and the forward's rule (4 bf16 units in the last place) for ys."""
    from wesep_tpu_torch.ops import cuda_lstm as k

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda().to(dtype)
    dys = (torch.randn(batch, t_len, 2 * h, generator=gen) * 0.1).cuda() \
        .to(dtype)

    def weights(sfx):
        p = {n: getattr(lstm, n + sfx).detach().float() for n in
             ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}
        return (p["weight_ih_l0"].t().contiguous(),
                p["bias_ih_l0"] + p["bias_hh_l0"],
                p["weight_hh_l0"].t().contiguous())

    args = (x, *weights(""), *weights("_reverse"))  # f32 parameters
    limit = 1e-4 if dtype == torch.float32 else 2e-2

    # forward with the cell states
    ys, cs = k._forward_cuda(*args, with_cs=True)
    torch.cuda.synchronize()
    ref_ys, ref_cs = k.bilstm_layer_reference(*args, return_cs=True)
    err_y = (ys.float() - ref_ys.float()).abs().max().item()
    err_c = rel_err(cs, ref_cs)
    fwd_ms = time_ms(lambda: k._forward_cuda(*args, with_cs=True), 1, 5)
    fwd_plain_ms = time_ms(
        lambda: k.bilstm_layer_reference(*args, return_cs=True), 0, 2)

    # the backward kernels, from the plain forward's saved tensors so that
    # only the adjoint differs
    dx, db, dg = k.bilstm_layer_backward(*args, ref_ys, ref_cs, dys)
    dw = k.bilstm_layer_wgrad(x, ref_ys, dg)
    torch.cuda.synchronize()
    ref = k.bilstm_layer_backward_reference(*args, ref_ys, ref_cs, dys)
    ref_dw = torch.stack([torch.cat([ref[1], ref[3]]),
                          torch.cat([ref[4], ref[6]])])
    ref_db = torch.stack([ref[2], ref[5]])
    errs = {"dx": rel_err(dx, ref[0]), "db": rel_err(db, ref_db),
            "dwx": rel_err(dw[:, :d], ref_dw[:, :d]),
            "dwh": rel_err(dw[:, d:], ref_dw[:, d:])}
    wgrad_ref = k.bilstm_layer_wgrad_reference(x, ref_ys, dg)
    err_wgrad = rel_err(dw, wgrad_ref)
    bwd_ms = time_ms(
        lambda: k.bilstm_layer_backward(*args, ref_ys, ref_cs, dys), 1, 5)
    wgrad_ms = time_ms(lambda: k.bilstm_layer_wgrad(x, ref_ys, dg), 1, 5)
    bwd_plain_ms = time_ms(
        lambda: k.bilstm_layer_backward_reference(*args, ref_ys, ref_cs, dys),
        0, 2)
    wgrad_plain_ms = time_ms(
        lambda: k.bilstm_layer_wgrad_reference(x, ref_ys, dg), 1, 3)

    # library yardsticks, never called by the port: cuDNN's LSTM forward
    # and backward with the same weights, and one batched cuBLAS product
    # over both directions for dW
    xg = x.clone().requires_grad_()
    lib_y = lstm(xg)[0]
    lib_params = list(lstm.parameters())
    lib_grads = torch.autograd.grad(lib_y, [xg] + lib_params, dys,
                                    retain_graph=True)
    err_lib_dx = rel_err(lib_grads[0], ref[0])
    err_lib_dwx = rel_err(lib_grads[1].t(), ref[1])
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_y, [xg] + lib_params, dys, retain_graph=True), 1, 5)

    def lib_fwd_bwd():
        torch.autograd.grad(lstm(xg)[0], [xg] + lib_params, dys)

    lib_fwd_bwd_ms = time_ms(lib_fwd_bwd, 1, 5)
    with torch.inference_mode():
        lib_fwd_ms = time_ms(lambda: lstm(x), 1, 5)
    del lib_y, lib_grads
    lib_wgrad_ms, lib_apart_ms = library_wgrad_ms(
        [torch.cat([x, ref_ys[..., i * h:(i + 1) * h]], dim=-1)
         .reshape(-1, d + h) for i in (0, 1)], dg)

    (f_ms, f_by), (s_ms, s_by), (w_ms, w_by) = backward_bounds(
        t_len, batch, dtype, d, h)
    case = {
        "shape": "train_" + name, "dtype": str(dtype).replace("torch.", ""),
        "T": t_len, "B": batch, "D": d, "H": h, "rel_limit": limit,
        "forward": {"max_abs_err": err_y, "tolerance": tolerance(ref_ys),
                    "kernels": forward_kernels(dtype, d, h, batch * t_len),
                    "cs_rel_err": err_c, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "library_ms": lib_fwd_ms,
                    "bound_ms": f_ms, "bound_by": f_by},
        "backward": {"rel_err": {n: errs[n] for n in ("dx", "db")},
                     "max_abs_err": (dx.float() - ref[0].float()).abs()
                     .max().item(),
                     "rel_err_cudnn_vs_plain": {"dx": err_lib_dx,
                                                "dwx": err_lib_dwx},
                     "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                     "library_ms": lib_bwd_ms,
                     "library_fwd_bwd_ms": lib_fwd_bwd_ms,
                     "bound_ms": s_ms, "bound_by": s_by,
                     "dg_scratch_bytes": dg.numel() * dg.element_size()},
        "wgrad": {"rel_err": {"dwx": errs["dwx"], "dwh": errs["dwh"],
                              "vs_plain_product": err_wgrad},
                  "max_abs_err": (dw - wgrad_ref).abs().max().item(),
                  "ms": wgrad_ms, "plain_ms": wgrad_plain_ms,
                  "library_ms": lib_wgrad_ms,
                  "library_per_direction_ms": lib_apart_ms,
                  "bound_ms": w_ms, "bound_by": w_by},
    }
    log("kernels at training shape", json.dumps(case))
    cs_limit = limit if dtype == torch.float32 else 5e-2
    ok = (err_y <= tolerance(ref_ys) and err_c <= cs_limit
          and all(e <= limit for e in errs.values())
          and err_wgrad <= 1e-4
          and all(torch.isfinite(t).all() for t in (ys, cs, dx, db, dw)))
    if not ok:
        raise AssertionError(f"training-shape kernels disagree: {case}")
    if dtype == torch.float32 and not (err_lib_dx <= 1e-3
                                       and err_lib_dwx <= 1e-3):
        raise AssertionError(f"plain backward disagrees with cuDNN: {case}")
    return case


def fused_bounds(t_len, batch, dtype, dirs, h=H):
    """Least times of the two-kernel layer's kernels on the card: the
    forward without and with the cell states, the serial adjoint and the
    weight gradients. Operations: 2 * T * B * H * 4H per direction and
    product (the forward's h @ Wh; the adjoint's recompute of it and its
    dh); bytes: every input read once, every output written once, the
    4H-wide xw and dxw streams included (dxw is an output of the adjoint
    and an input of the weight gradients)."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows, h4 = t_len * batch, 4 * h
    product = 2 * dirs * rows * h * h4
    xw_b, wh_b = dirs * rows * h4 * size, dirs * h * h4 * size
    y_b, cs_b = rows * dirs * h * size, rows * dirs * h * 4
    serve = _bound(product, xw_b + wh_b + y_b, dtype)
    forward = _bound(product, xw_b + wh_b + y_b + cs_b, dtype)
    serial = _bound(2 * product, xw_b + 2 * wh_b + y_b + cs_b + y_b + xw_b
                    + (batch + 7) // 8 * dirs * h4 * 4, dtype)
    splits = max(1, min(8, -(-rows // 4096)))
    wgrad = _bound(product, y_b + xw_b + splits * dirs * h * h4 * 4, dtype)
    return serve, forward, serial, wgrad


def fused_names(dirs):
    return LSTM_ROUTES["two_kernel" if dirs == 2 else "unidirectional"]


def check_fused_kernels(name, t_len, batch, dtype, dirs, train):
    """The two-kernel layer's kernels against their plain versions at one
    pBSRNN shape: K2 (dirs 2, `bilstm_fused`) or K1 (dirs 1, `lstm_fused`,
    the forward walk of the unidirectional model). The forward at a serving
    shape; at a training shape the forward with the cell states, the serial
    adjoint (on the plain forward's saved tensors, so only the adjoint
    differs) and the weight gradients (on the adjoint's own dxw). xw is
    projected as the layer projects it, from torch LSTM weights. Yardsticks,
    never called by the port: cuDNN's LSTM (bidirectional or not) forward
    and backward, and one batched cuBLAS product h_prev^T @ dxw over every
    direction.

    Limits: the forward's rule for y (1e-4 in f32, 4 bf16 units in the last
    place at the largest |y| in bf16) and rel. L2 <= 1e-4 (f32) / 2e-2
    (bf16) for y and every gradient, with each gradient's max abs error
    within the same fraction of its largest magnitude."""
    from wesep_tpu_torch.ops import cuda_lstm_fused as k

    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=dirs == 2)
    lstm = lstm.cuda().to(dtype)
    lstm.flatten_parameters()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(batch, t_len, D, generator=gen) * 0.2).cuda().to(dtype)
    sfx = ("", "_reverse")[:dirs]
    p = {n + s: getattr(lstm, n + s).detach().float() for s in sfx
         for n in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                   "bias_hh_l0")}
    xw = torch.stack([k.project(x, p["weight_ih_l0" + s].t(),
                                p["bias_ih_l0" + s] + p["bias_hh_l0" + s])
                      for s in sfx])
    whs = [p["weight_hh_l0" + s].t().contiguous() for s in sfx]
    # the wrappers of both layers take (xw, *whs, ...)
    fwd, bwd, wgrad, ref_fwd, ref_bwd = (
        (k.bilstm_fused_forward, k.bilstm_fused_backward,
         k.bilstm_fused_wgrad, k.bilstm_fused_reference,
         k.bilstm_fused_backward_reference) if dirs == 2 else
        (k.lstm_fused_forward, k.lstm_fused_backward, k.lstm_fused_wgrad,
         k.lstm_fused_reference, k.lstm_fused_backward_reference))
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    serve_b, fwd_b, serial_b, wgrad_b = fused_bounds(t_len, batch, dtype,
                                                     dirs)
    names = fused_names(dirs)
    case = {"shape": ("train_" if train else "") + name,
            "dtype": str(dtype).replace("torch.", ""), "dirs": dirs,
            "T": t_len, "B": batch, "H": H, "rel_limit": limit}

    ys, cs = fwd(xw, *whs, with_cs=train)
    torch.cuda.synchronize()
    ref = ref_fwd(xw, *whs, return_cs=train)
    ref_ys, ref_cs = ref if train else (ref, None)
    err_y = (ys.float() - ref_ys.float()).abs().max().item()
    rel_y = rel_l2(ys, ref_ys)
    with torch.inference_mode():
        lib = lstm(x)[0]
    bound_ms, bound_by = fwd_b if train else serve_b
    case["forward"] = {
        "name": names[0], "kernels": forward_kernels(dtype, 0, H,
                                                     batch * t_len),
        "max_abs_err": err_y,
        "tolerance": tolerance(ref_ys), "rel_l2_err": rel_y,
        "max_abs_err_vs_cudnn": (ys.float() - lib.float()).abs().max()
        .item(),
        "ms": time_ms(lambda: fwd(xw, *whs, with_cs=train), 1, 5),
        "plain_ms": time_ms(lambda: ref_fwd(xw, *whs, return_cs=train), 0,
                            2),
        "bound_ms": bound_ms, "bound_by": bound_by}
    with torch.inference_mode():
        case["forward"]["library_ms"] = time_ms(lambda: lstm(x), 1, 5)
    del lib
    ok = (err_y <= tolerance(ref_ys) and rel_y <= limit
          and torch.isfinite(ys).all())
    if train:
        err_c = rel_err(cs, ref_cs)
        case["forward"]["cs_rel_err"] = err_c
        ok = ok and err_c <= (limit if dtype == torch.float32 else 5e-2)
        dys = (torch.randn(batch, t_len, dirs * H, generator=gen) * 0.1) \
            .cuda().to(dtype)
        dxw, db = bwd(xw, *whs, ref_ys, ref_cs, dys)
        dwh = wgrad(ref_ys, dxw)
        torch.cuda.synchronize()
        want_dxw, want_dwh, want_db = ref_bwd(xw, *whs, ref_ys, ref_cs, dys)
        got = {"dxw": dxw, "db": db, "dwh": dwh}
        want = {"dxw": want_dxw, "db": want_db, "dwh": want_dwh}
        rel = {n: rel_l2(got[n], want[n]) for n in got}
        peak = {n: rel_err(got[n], want[n]) for n in got}
        dwh_ref = k.lstm_fused_wgrad_reference(ref_ys, dxw)
        err_wgrad = rel_err(dwh, dwh_ref)
        ok = ok and all(v <= limit for v in list(rel.values())
                        + list(peak.values())) and err_wgrad <= 1e-4 \
            and all(torch.isfinite(t).all() for t in got.values())
        # yardsticks: cuDNN's backward on its own forward, and cuBLAS's
        # h_prev^T @ dxw over every direction in one batched product
        xg = x.clone().requires_grad_()
        lib_y = lstm(xg)[0]
        lib_params = list(lstm.parameters())
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_y, [xg] + lib_params, dys, retain_graph=True), 1, 5)
        del lib_y
        zero = ref_ys.new_zeros(batch, 1, H)
        h_prev = [torch.cat([zero, ref_ys[:, :-1, :H]], dim=1)]
        if dirs == 2:
            h_prev.append(torch.cat([ref_ys[:, 1:, H:], zero], dim=1))
        lib_wgrad_ms, lib_apart_ms = library_wgrad_ms(
            [h.reshape(-1, H) for h in h_prev], dxw)
        del h_prev
        case["backward"] = {
            "name": names[1], "rel_l2_err": {n: rel[n] for n in ("dxw",
                                                                 "db")},
            "max_abs_err": (dxw.float() - want_dxw.float()).abs().max()
            .item(),
            "rel_err": {n: peak[n] for n in ("dxw", "db")},
            "ms": time_ms(lambda: bwd(xw, *whs, ref_ys, ref_cs, dys), 1, 5),
            "plain_ms": time_ms(
                lambda: ref_bwd(xw, *whs, ref_ys, ref_cs, dys), 0, 2),
            "library_ms": lib_bwd_ms, "bound_ms": serial_b[0],
            "bound_by": serial_b[1],
            "dxw_bytes": dxw.numel() * dxw.element_size()}
        case["wgrad"] = {
            "name": names[2], "rel_l2_err": rel["dwh"],
            "rel_err": peak["dwh"], "vs_plain_product": err_wgrad,
            "max_abs_err": (dwh - want_dwh).abs().max().item(),
            "ms": time_ms(lambda: wgrad(ref_ys, dxw), 1, 5),
            "plain_ms": time_ms(
                lambda: k.lstm_fused_wgrad_reference(ref_ys, dxw), 1, 3),
            "library_ms": lib_wgrad_ms,
            "library_per_direction_ms": lib_apart_ms, "bound_ms": wgrad_b[0],
            "bound_by": wgrad_b[1]}
    log(f"kernels {names[0][:-len('_forward')]}", json.dumps(case))
    if not ok:
        raise AssertionError(f"{names[0]} kernels disagree: {case}")
    return case


def tc_bounds(rows, d, h, dirs):
    """Least times of the tensor-core backward's kernels on the card, bf16
    (989 TFLOP/s, 3.35 TB/s), each of its own inputs and outputs (so the
    split design's: G and dg count where they pass between kernels): every
    input read once, every output written once. The gate products A @ [Wx ; Wh] + (b or xw) (A = [x ; h_{t-1}],
    f32 out); the chain's dh products, reading G, cs, dy and Wh and writing
    dg and the tiles' db; dx = dg @ Wx^T; dW = A^T @ dg with its split
    partials."""
    h4, k = 4 * h, d + h
    a_b = rows * (d + dirs * h) * 2  # x once, y once
    g_b = dirs * rows * h4 * 4
    dg_b = dirs * rows * h4 * 2
    w_b = dirs * k * h4 * 2
    base_b = dirs * rows * h4 * 2 if d == 0 else dirs * h4 * 4
    gates = _bound(2 * dirs * rows * k * h4, a_b + w_b + base_b + g_b,
                   torch.bfloat16)
    chain = _bound(2 * dirs * rows * h * h4,
                   g_b + rows * dirs * h * (4 + 2) + dg_b
                   + dirs * h * h4 * 2, torch.bfloat16)
    dx = _bound(2 * dirs * rows * h4 * d,
                dg_b + dirs * d * h4 * 2 + dirs * rows * d * 2,
                torch.bfloat16)
    wgrad = _bound(2 * dirs * rows * k * h4, a_b + dg_b + dirs * k * h4 * 4,
                   torch.bfloat16)
    return {"lstm_gates": gates, "lstm_adjoint_chain": chain, "lstm_dx": dx,
            "lstm_wgrad": wgrad}


def tc_function_bounds(in_bytes, rows, d, h, dirs, dx_bytes):
    """Least times of the functions the Pallas kernels compute, bf16: the
    adjoint (gate recompute 2 T B (d + H) 4H, dh 2 T B H 4H and dx
    2 T B 4H d per direction), reading x or xw, y, cs, dy, the weights and
    b (`in_bytes`) and writing dg, dx (`dx_bytes`, 0 on the two-kernel
    routes) and db; and the whole backward, the adjoint and dW = A^T @ dg
    (2 T B (d + H) 4H more), writing dx (dxw, which is dg, on the
    two-kernel routes), dW f32 and db. No G and no dg pass between kernels
    here: those are the split design's own traffic (tc_bounds)."""
    h4 = 4 * h
    product = 2 * dirs * rows * (d + h) * h4
    ops = product + 2 * dirs * rows * h * h4 + 2 * dirs * rows * h4 * d
    dg_b, db_b = dirs * rows * h4 * 2, dirs * h4 * 4
    adjoint = _bound(ops, in_bytes + dg_b + dx_bytes + db_b, torch.bfloat16)
    whole = _bound(ops + product, in_bytes + (dx_bytes or dg_b)
                   + dirs * (d + h) * h4 * 4 + db_b, torch.bfloat16)
    return adjoint, whole


TC_NAMES = ("lstm_gates", "lstm_adjoint_chain", "lstm_dx", "lstm_wgrad")
TC_FORWARD_NAMES = ("lstm_project", "lstm_forward_chain")


def check_tc_backward(route, name, t_len, batch, d=D, h=H, length=None):
    """The tensor-core backward (gates, chain, dx, dW) of one LSTM route at
    one training shape, bf16, f32 parameters, on the plain forward's saved
    tensors: each kernel against its plain version on the kernels' own
    inputs (so that only the kernel differs), the whole backward against
    the route's step-by-step plain backward (the JAX package's rounding
    points), a second run bit for bit, each kernel's time beside its plain
    version's, its cuBLAS yardstick and its bound, and the adjoint and the
    whole backward, each timed as one call, beside their functions'
    bounds (tc_function_bounds).

    route: "layer" (x [B, T, d]), "unfold" (x [B, length, 48], ks d / 48,
    hs 1, T the frames), "two_kernel" or "unidirectional" (xw from x [B, T,
    d] as the layers project it). Limits: the f32 products (G, dW) within
    1e-4 of their plain products' largest magnitude; dg, db and dx within
    2e-2 (rel. L2 and max error over the largest magnitude: dgates and dh
    are rounded to bf16 every step and a sum that differs in its last bit
    flips such a rounding now and then); the whole backward against the
    route's plain backward within 2e-2, the existing kernels' limit."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc
    from wesep_tpu_torch.ops import cuda_lstm_unfold

    dtype = torch.bfloat16
    dirs = 1 if route == "unidirectional" else 2
    gen = torch.Generator().manual_seed(SEED + 20)
    scale = 1.0 / math.sqrt(h)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    flat = [w for _ in range(dirs) for w in (u(d, 4 * h), u(4 * h),
                                             u(h, 4 * h))]
    wx32, b32, wh32 = flat[0::3], flat[1::3], flat[2::3]
    whs = [w.to(dtype).contiguous() for w in wh32]
    biases, xw, wxs = [b.float().contiguous() for b in b32], None, None
    if route == "unfold":
        ks = d // GRID_C
        x = torch.randn(batch, length, GRID_C, generator=gen).cuda().to(dtype)
        ys, cs = cuda_lstm_unfold.bilstm_layer_unfold_reference(
            x, *flat, ks, 1, return_cs=True)
        spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, GRID_C, 1)
        wxs = [tc.to_k_major(w, GRID_C, ks).to(dtype).contiguous()
               for w in wx32]
    elif route == "layer":
        x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda() \
            .to(dtype)
        ys, cs = cuda_lstm.bilstm_layer_reference(x, *flat, return_cs=True)
        spec = tc.RowSpec(tc.ROW_X, d)
        wxs = [w.to(dtype).contiguous() for w in wx32]
    else:
        x_in = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda() \
            .to(dtype)
        xw = torch.stack([cuda_lstm_fused.project(x_in, wx, b)
                          for wx, b in zip(wx32, b32)])
        ys, cs = cuda_lstm_fused._recurrence_reference(xw, wh32, False, True)
        x, spec, biases = None, tc.RowSpec(tc.ROW_H, 0), None
        del x_in
    frames = ys.shape[1]
    rows = batch * frames
    dys = (torch.randn(batch, frames, dirs * h, generator=gen) * 0.1).cuda() \
        .to(dtype)
    k_in = spec.d

    def run():
        g = tc.lstm_gates(x, ys, wxs, whs, spec, biases, xw)
        dg, db = tc.lstm_adjoint_chain(g, whs, cs, dys)
        dx2 = tc.lstm_dx(dg, wxs) if wxs is not None else None
        dw = tc.lstm_wgrad(x, ys, dg, spec)
        return g, dg, db, dx2, dw

    g, dg, db, dx2, dw = run()
    torch.cuda.synchronize()
    g2, dg2, db2, dx22, dw2 = run()
    repeats = (torch.equal(g, g2) and torch.equal(dg, dg2)
               and torch.equal(db, db2) and torch.equal(dw, dw2)
               and (dx2 is None or torch.equal(dx2, dx22)))
    del g2, dg2, db2, dx22, dw2

    # each kernel against its plain version on the kernels' own inputs
    def compare(kname, got, want):
        errs[kname] = rel_err(got, want)
        max_abs[kname] = (got.float() - want.float()).abs().max().item()

    errs, max_abs = {}, {}
    compare("lstm_gates", g,
            tc.lstm_gates_reference(x, ys, wxs, whs, spec, biases, xw))
    dg_ref, db_ref = tc.lstm_adjoint_chain_reference(g, whs, cs, dys)
    compare("lstm_adjoint_chain", dg, dg_ref)
    errs["lstm_adjoint_chain"] = max(errs["lstm_adjoint_chain"],
                                     rel_l2(dg, dg_ref), rel_err(db, db_ref))
    del dg_ref
    if dx2 is not None:
        compare("lstm_dx", dx2, tc.lstm_dx_reference(dg, wxs))
    compare("lstm_wgrad", dw, tc.lstm_wgrad_reference(x, ys, dg, spec))

    # the whole backward against the route's step-by-step plain backward
    if route == "layer":
        want = cuda_lstm.bilstm_layer_backward_reference(x, *flat, ys, cs,
                                                         dys)
        got = tc.layer_backward(x, *flat, ys, cs, dys)
        names = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")
    elif route == "unfold":
        want = cuda_lstm_unfold.bilstm_layer_unfold_backward_reference(
            x, *flat, ys, cs, dys, ks, 1)
        got = tc.unfold_backward(x, *flat, ys, cs, dys, ks, 1)
        names = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")
    else:
        want = cuda_lstm_fused._adjoint_reference(xw, wh32, False, ys, cs,
                                                  dys)
        got = tc.fused_backward(xw, wh32, ys, cs, dys)
        names = ("dxw", "dwh", "db")
    whole = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    del got, want

    times = {"lstm_gates": time_ms(
        lambda: tc.lstm_gates(x, ys, wxs, whs, spec, biases, xw), 1, 5)}
    times["lstm_adjoint_chain"] = time_ms(
        lambda: tc.lstm_adjoint_chain(g, whs, cs, dys), 1, 5)
    if dx2 is not None:
        times["lstm_dx"] = time_ms(lambda: tc.lstm_dx(dg, wxs), 1, 5)
    times["lstm_wgrad"] = time_ms(lambda: tc.lstm_wgrad(x, ys, dg, spec), 1,
                                  5)
    plain = {"lstm_gates": time_ms(
        lambda: tc.lstm_gates_reference(x, ys, wxs, whs, spec, biases, xw),
        0, 1),
        "lstm_adjoint_chain": time_ms(
            lambda: tc.lstm_adjoint_chain_reference(g, whs, cs, dys), 0, 1),
        "lstm_wgrad": time_ms(
            lambda: tc.lstm_wgrad_reference(x, ys, dg, spec), 0, 1)}
    if dx2 is not None:
        plain["lstm_dx"] = time_ms(lambda: tc.lstm_dx_reference(dg, wxs), 0,
                                   1)
    # cuBLAS yardsticks, never called by the port: the same products per
    # direction, back to back (bf16 operands; f32 out for G and dW)
    a = tc.gate_rows(x, ys, spec, dirs).to(dtype)
    wcat = [w if wxs is None else torch.cat([wx, w])
            for wx, w in zip(wxs or [None] * dirs, whs)]
    library = {"lstm_gates": time_ms(lambda: [
        torch.mm(a[i].reshape(rows, -1), wcat[i], out_dtype=torch.float32)
        for i in range(dirs)], 1, 5)}
    dg2d = dg.reshape(dirs, rows, -1)
    # the adjoint (gates, chain, dx) and the whole backward, each timed as
    # one call, against the functions' own bounds
    def adjoint():
        dg_, _ = tc.lstm_adjoint_chain(
            tc.lstm_gates(x, ys, wxs, whs, spec, biases, xw), whs, cs, dys)
        return tc.lstm_dx(dg_, wxs) if wxs is not None else dg_

    whole_ms = {"adjoint": time_ms(adjoint, 1, 5),
                "backward": time_ms(run, 1, 5)}
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (x, xw, ys, cs, dys, *whs, *(wxs or []),
                             *(biases or [])) if t is not None)
    fn_bounds = tc_function_bounds(
        in_bytes, rows, k_in, h, dirs,
        x.numel() * x.element_size() if wxs is not None else 0)
    library["lstm_wgrad"] = time_ms(lambda: [
        torch.mm(a[i].reshape(rows, -1).t(), dg2d[i],
                 out_dtype=torch.float32) for i in range(dirs)], 1, 5)
    if dx2 is not None:
        library["lstm_dx"] = time_ms(lambda: [
            torch.matmul(dg2d[i], wxs[i].t()) for i in range(dirs)], 1, 5)
    del a, g
    bounds = tc_bounds(rows, k_in, h, dirs)
    kernels = {}
    for kname in TC_NAMES:
        if kname not in times:
            continue
        kernels[kname] = {
            "rel_err": errs[kname], "max_abs_err": max_abs.get(kname),
            "ms": times[kname], "plain_ms": plain[kname],
            "library_ms": library.get(kname),
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    case = {"route": route, "shape": name, "dtype": "bfloat16", "dirs": dirs,
            "T": frames, "B": batch, "D": k_in, "H": h, "rows": rows,
            "repeats_bit_for_bit": repeats, "whole_rel_err": whole,
            "kernels": kernels,
            "function": {
                part: {"ms": whole_ms[part], "bound_ms": b[0],
                       "bound_by": b[1]}
                for part, b in zip(("adjoint", "backward"), fn_bounds)},
            "dg_scratch_bytes": dg.numel() * dg.element_size(),
            "g_scratch_bytes": dirs * rows * 4 * h * 4}
    log("kernels tensor-core backward", json.dumps(case))
    limits = {"lstm_gates": 1e-4, "lstm_wgrad": 1e-4,
              "lstm_adjoint_chain": 2e-2, "lstm_dx": 2e-2}
    ok = (repeats and all(errs[n] <= limits[n] for n in errs)
          and all(v <= 2e-2 for v in whole.values())
          and all(torch.isfinite(t).all() for t in (dg, db, dw)))
    if not ok:
        raise AssertionError(f"tensor-core backward disagrees: {case}")
    return case


def tc_forward_bounds(rows, d, h, dirs, x_bytes, xw_size):
    """Least times of the tensor-core forward on the card, bf16 (989
    TFLOP/s, 3.35 TB/s): every input read once, every output written once.
    The projection A @ Wx + b (x, Wx and b in, xw f32 out; layers that
    project x); the chain h_{t-1} @ Wh and the cell update (xw, of
    `xw_size` bytes an element, and Wh in, y and cs out); and the forward's
    function as the Pallas kernel computes it, from x (or, on the two-kernel
    routes, xw) and the weights to y and cs, with no xw passing between two
    kernels."""
    h4 = 4 * h
    y_b, cs_b = rows * dirs * h * 2, rows * dirs * h * 4
    wx_b, wh_b = dirs * d * h4 * 2 + dirs * h4 * 4, dirs * h * h4 * 2
    xw_b = dirs * rows * h4 * xw_size
    project = _bound(2 * dirs * rows * d * h4, x_bytes + wx_b + xw_b,
                     torch.bfloat16)
    chain = _bound(2 * dirs * rows * h * h4, xw_b + wh_b + y_b + cs_b,
                   torch.bfloat16)
    function = _bound(2 * dirs * rows * (d + h) * h4,
                      (x_bytes + wx_b if d else xw_b) + wh_b + y_b + cs_b,
                      torch.bfloat16)
    return {"lstm_project": project, "lstm_forward_chain": chain,
            "function": function}


def check_tc_forward(route, name, t_len, batch, d=D, h=H, length=None):
    """The tensor-core forward (projection, cluster chain) of one LSTM route
    at one training shape, bf16, f32 parameters, cell states written as for
    training: each kernel against its plain version on the kernels' own
    inputs (the projection's chain order undone by from_chain_order; the
    chain on the projection's own xw), the whole forward against the
    route's step-by-step plain forward (the JAX package's rounding points),
    a second run bit for bit, each kernel's time beside its plain
    version's, its library yardstick (cuBLAS's product for the projection;
    none for the chain alone) and its bound, and the whole forward, timed
    as one call, beside cuDNN's LSTM forward over the same shape and the
    bound of the forward's function (tc_forward_bounds).

    route: as check_tc_backward. Limits: the projection within 1e-4 of its
    plain product's largest magnitude (f32 sums of exact products in
    another order); y, of the chain and of the whole forward, within 4 bf16
    units in the last place at its largest magnitude and cs within 5e-2 of
    its largest magnitude (the limits check_training_kernels holds the
    bf16 forward to: h is rounded to bf16 every step and a sum that differs
    in its last bit flips such a rounding now and then)."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc
    from wesep_tpu_torch.ops import cuda_lstm_unfold

    dtype = torch.bfloat16
    dirs = 1 if route == "unidirectional" else 2
    gen = torch.Generator().manual_seed(SEED + 30)
    scale = 1.0 / math.sqrt(h)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    flat = [w for _ in range(dirs) for w in (u(d, 4 * h), u(4 * h),
                                             u(h, 4 * h))]
    wx32, b32, wh32 = flat[0::3], flat[1::3], flat[2::3]
    whs = [w.to(dtype).contiguous() for w in wh32]
    biases = [b.float().contiguous() for b in b32]
    xw = wxs = spec = None
    if route == "unfold":
        ks = d // GRID_C
        x = torch.randn(batch, length, GRID_C, generator=gen).cuda().to(dtype)
        t_len = length - ks + 1
        spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, GRID_C, 1)
        wxs = [tc.to_k_major(w, GRID_C, ks).to(dtype).contiguous()
               for w in wx32]
        x_rows = cuda_lstm_unfold.unfold_frames(x, ks, 1)

        def whole():
            return tc.unfold_forward(x, *flat, ks, 1, with_cs=True)

        def plain_whole():
            return cuda_lstm_unfold.bilstm_layer_unfold_reference(
                x, *flat, ks, 1, return_cs=True)
    elif route == "layer":
        x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda() \
            .to(dtype)
        spec = tc.RowSpec(tc.ROW_X, d)
        wxs = [w.to(dtype).contiguous() for w in wx32]
        x_rows = x

        def whole():
            return tc.layer_forward(x, *flat, with_cs=True)

        def plain_whole():
            return cuda_lstm.bilstm_layer_reference(x, *flat, return_cs=True)
    else:
        x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda() \
            .to(dtype)
        xw = torch.stack([cuda_lstm_fused.project(x, wx, b)
                          for wx, b in zip(wx32, b32)])
        x_rows = x

        def whole():
            return tc.fused_forward(xw, wh32, with_cs=True)

        def plain_whole():
            return cuda_lstm_fused._recurrence_reference(xw, wh32, False,
                                                         True)
    rows = batch * t_len

    def run():
        xw_k = xw if xw is not None else tc.lstm_project(x, wxs, biases, spec,
                                                         t_len)
        y, cs = tc.lstm_forward_chain(xw_k, whs, False, True, batch=batch)
        return xw_k, y, cs

    xw_k, y, cs = run()
    torch.cuda.synchronize()
    again = run()
    repeats = all(torch.equal(a, b) for a, b in zip((xw_k, y, cs), again))
    del again

    # each kernel against its plain version on the kernels' own inputs
    errs, max_abs = {}, {}
    xw_nat = xw
    if xw is None:
        xw_nat = tc.from_chain_order(xw_k, batch)
        xw_ref = tc.lstm_project_reference(x, wxs, biases, spec, t_len)
        errs["lstm_project"] = rel_err(xw_nat, xw_ref)
        max_abs["lstm_project"] = (xw_nat - xw_ref).abs().max().item()
        del xw_ref
    y_ref, cs_ref = tc.lstm_forward_chain_reference(xw_nat, whs, False, True)
    chain_tol = tolerance(y_ref)
    max_abs["lstm_forward_chain"] = (y.float() - y_ref.float()).abs().max() \
        .item()
    errs["lstm_forward_chain"] = rel_err(cs, cs_ref)
    del y_ref, cs_ref
    # the whole forward against the route's step-by-step plain forward
    want_y, want_cs = plain_whole()
    whole_tol = tolerance(want_y)
    got_y, got_cs = whole()
    whole_err = {"y_max_abs": (got_y.float() - want_y.float()).abs().max()
                 .item(), "y_tolerance": whole_tol,
                 "cs_rel_err": rel_err(got_cs, want_cs)}
    del got_y, got_cs, want_y, want_cs

    times = {"lstm_forward_chain": time_ms(
        lambda: tc.lstm_forward_chain(xw_k, whs, False, True, batch=batch),
        1, 5)}
    plain = {"lstm_forward_chain": time_ms(
        lambda: tc.lstm_forward_chain_reference(xw_nat, whs, False, True),
        0, 1)}
    library = {"lstm_forward_chain": None}
    x_bytes = x.numel() * x.element_size()
    if xw is None:
        times["lstm_project"] = time_ms(
            lambda: tc.lstm_project(x, wxs, biases, spec, t_len), 1, 5)
        plain["lstm_project"] = time_ms(
            lambda: tc.lstm_project_reference(x, wxs, biases, spec, t_len),
            0, 1)
        # cuBLAS: one product of the (materialised) input rows with both
        # directions' Wx side by side, the bias added, f32 out
        a2d = x_rows.reshape(rows, -1)
        w_cat = torch.cat([w.to(dtype) for w in wx32], dim=1)
        b_cat = torch.cat(biases)
        library["lstm_project"] = time_ms(lambda: torch.addmm(
            b_cat, a2d, w_cat, out_dtype=torch.float32), 1, 5)
        del a2d, w_cat
    whole_ms = time_ms(whole, 1, 5)
    plain_ms = time_ms(plain_whole, 0, 1)
    # cuDNN's LSTM forward at the same shape (its input the materialised
    # frames on the unfold route)
    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(x_rows.shape[-1], h, batch_first=True,
                         bidirectional=dirs == 2).cuda().to(dtype)
    lstm.flatten_parameters()
    x_lib = x_rows.contiguous()
    with torch.inference_mode():
        cudnn_ms = time_ms(lambda: lstm(x_lib), 1, 5)
    del lstm, x_lib
    bounds = tc_forward_bounds(rows, spec.d if xw is None else 0, h, dirs,
                               x_bytes, 4 if xw is None else 2)
    kernels = {}
    for kname in TC_FORWARD_NAMES:
        if kname not in times:
            continue
        kernels[kname] = {
            "rel_err": errs[kname], "max_abs_err": max_abs[kname],
            "ms": times[kname], "plain_ms": plain[kname],
            "library_ms": library[kname],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    kernels["lstm_forward_chain"]["y_tolerance"] = chain_tol
    case = {"route": route, "shape": name, "dtype": "bfloat16", "dirs": dirs,
            "T": t_len, "B": batch, "D": spec.d if xw is None else 0, "H": h,
            "rows": rows, "repeats_bit_for_bit": repeats,
            "whole_err": whole_err, "kernels": kernels,
            "forward": {"ms": whole_ms, "plain_ms": plain_ms,
                        "library_ms": cudnn_ms,
                        "bound_ms": bounds["function"][0],
                        "bound_by": bounds["function"][1]},
            "xw_scratch_bytes": xw_k.numel() * xw_k.element_size()
            if xw is None else 0}
    log("kernels tensor-core forward", json.dumps(case))
    ok = (repeats and errs.get("lstm_project", 0.0) <= 1e-4
          and max_abs["lstm_forward_chain"] <= chain_tol
          and errs["lstm_forward_chain"] <= 5e-2
          and whole_err["y_max_abs"] <= whole_tol
          and whole_err["cs_rel_err"] <= 5e-2
          and torch.isfinite(y.float()).all() and torch.isfinite(cs).all())
    if not ok:
        raise AssertionError(f"tensor-core forward disagrees: {case}")
    return case


F32_FORWARD_NAMES = ("lstm_f32_project", "lstm_f32_forward_chain")
# the routes' own FMA forward kernels, which f32 runs only at shapes the
# f32 gate refuses since the f32 cluster forward took the others
OLD_F32_FORWARD = {"layer": "bilstm_layer", "unfold": "bilstm_layer_unfold",
                   "two_kernel": "bilstm_fused_forward",
                   "unidirectional": "lstm_fused_forward"}


def f32_forward_bounds(rows, d, h, dirs, x_bytes, with_cs):
    """Least times of the f32 forward on the card (67 TFLOP/s f32 outside
    the tensor cores, 3.35 TB/s): every input read once, every output
    written once. The projection A @ Wx + b (x, Wx and b in, xw f32 out;
    layers that project x); the chain h_{t-1} @ Wh and the cell update (xw
    and Wh in, y and, `with_cs`, cs out); and the forward's function as the
    Pallas kernel computes it, from x (or, on the two-kernel routes, xw)
    and the weights to y and cs, with no xw passing between two kernels."""
    h4, f32 = 4 * h, torch.float32
    out_b = rows * dirs * h * 4 * (2 if with_cs else 1)
    wx_b, wh_b = dirs * (d + 1) * h4 * 4, dirs * h * h4 * 4
    xw_b = dirs * rows * h4 * 4
    return {
        "lstm_f32_project": _bound(2 * dirs * rows * d * h4,
                                   x_bytes + wx_b + xw_b, f32),
        "lstm_f32_forward_chain": _bound(2 * dirs * rows * h * h4,
                                         xw_b + wh_b + out_b, f32),
        "function": _bound(2 * dirs * rows * (d + h) * h4,
                           (x_bytes + wx_b if d else xw_b) + wh_b + out_b,
                           f32)}


def old_f32_forward(route, x, flat, xw, ks, with_cs):
    """The route's own FMA forward kernel (`bilstm_fwd_kernel` of
    csrc/bilstm_common.cuh) on f32 operands, launched directly: the layers
    no longer reach it at shapes the f32 gate takes. -> (y, cs or None)."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_unfold
    from wesep_tpu_torch.ops.cuda_lstm import _entry, _launch

    if route in ("two_kernel", "unidirectional"):
        dirs, batch, t_len, h4 = xw.shape
        whs = flat[2::3]
        out = (batch, t_len, dirs * h4 // 4)
        counter = getattr(cuda_lstm_fused, OLD_F32_FORWARD[route])
        fn = _entry("lstm_fused", "lstm_fused_forward", 5, 6)
        tensors = (xw, whs[0], whs[1] if dirs == 2 else None)
        ints = (batch, t_len, h4 // 4, dirs, 0, 0)
    elif route == "layer":
        batch, t_len, d = x.shape
        tensors = cuda_lstm._kernel_args(x, *flat)
        h = flat[2].shape[0]
        out = (batch, t_len, 2 * h)
        counter = cuda_lstm.bilstm_layer
        fn = _entry("bilstm_layer", "bilstm_layer_forward", 9, 5)
        ints = (batch, t_len, d, h, 0)
    else:
        batch, length, c = x.shape
        tensors = cuda_lstm._kernel_args(x, *flat, d=ks * c)
        h = flat[2].shape[0]
        out = (batch, length - ks + 1, 2 * h)
        counter = cuda_lstm_unfold.bilstm_layer_unfold
        fn = _entry("bilstm_unfold", "bilstm_unfold_forward", 9, 7)
        ints = (batch, length, c, ks, 1, h, 0)
    y = torch.empty(*out, device=tensors[0].device)
    cs = torch.empty_like(y) if with_cs else None
    _launch(counter, fn, (*tensors, y, cs), ints, y.device)
    return y, cs


def check_f32_forward(route, name, t_len, batch, d=D, h=H, length=None,
                      with_cs=False, old=True):
    """The f32 cluster forward (the FMA projection, the cluster chain) of
    one LSTM route at one f32 shape that serving or the validation step
    runs, f32 parameters, cell states written where a backward follows
    (`with_cs`, the training shapes): each kernel against its plain version
    on the kernels' own inputs (the projection's chain order undone by
    from_f32_chain_order; the chain on the projection's own xw, with the
    rows a cluster the wrapper picks), the whole forward as the route runs
    it against the route's step-by-step plain forward, a second run bit for
    bit, each kernel's time beside its plain version's, its library
    yardstick (cuBLAS's f32 product for the projection; none for the chain
    alone) and its bound; the whole forward beside cuDNN's f32 LSTM forward
    (TF32 off) over the same shape, the route's own FMA forward kernel
    (launched directly; not with `old` false) and the bound of the
    forward's function.

    route: "layer" (K0), "unfold" (K3, x [B', L, C]), "two_kernel" (K2) or
    "unidirectional" (K1; both given xw from the layers' f32 projection).
    Limits: y and cs of the chain, of the whole forward and of the FMA
    kernel within 1e-4 abs of the plain versions (f32 sums in another
    order over T steps), the projection within 1e-4 of its plain product's
    largest magnitude."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_f32 as f
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc
    from wesep_tpu_torch.ops import cuda_lstm_unfold

    dirs = 1 if route == "unidirectional" else 2
    gen = torch.Generator().manual_seed(SEED + 40)
    scale = 1.0 / math.sqrt(h)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    flat = [w for _ in range(dirs) for w in (u(d, 4 * h), u(4 * h),
                                             u(h, 4 * h))]
    wx32, b32, whs = flat[0::3], flat[1::3], flat[2::3]
    xw = spec = wxs = None
    ks = d // GRID_C
    if route == "unfold":
        x = torch.randn(batch, length, GRID_C, generator=gen).cuda()
        t_len = length - ks + 1
        spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, GRID_C, 1)
        wxs = [tc.to_k_major(w, GRID_C, ks).contiguous() for w in wx32]
        x_rows = cuda_lstm_unfold.unfold_frames(x, ks, 1)

        def whole():
            return cuda_lstm_unfold._forward_cuda(x, *flat, ks, 1, with_cs)

        def plain_whole():
            return cuda_lstm_unfold.bilstm_layer_unfold_reference(
                x, *flat, ks, 1, return_cs=True)
    else:
        x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda()
        x_rows = x
        if route == "layer":
            spec = tc.RowSpec(tc.ROW_X, d)
            wxs = [w.contiguous() for w in wx32]

            def whole():
                return cuda_lstm._forward_cuda(x, *flat, with_cs=with_cs)

            def plain_whole():
                return cuda_lstm.bilstm_layer_reference(x, *flat,
                                                        return_cs=True)
        else:
            xw = torch.stack([cuda_lstm_fused.project(x, wx, b)
                              for wx, b in zip(wx32, b32)])
            counter = getattr(cuda_lstm_fused, OLD_F32_FORWARD[route])

            def whole():
                return cuda_lstm_fused._forward_cuda(counter, xw, whs, False,
                                                     with_cs)

            def plain_whole():
                return cuda_lstm_fused._recurrence_reference(xw, whs, False,
                                                             True)
    rows = batch * t_len
    per_cluster = f.rows_per_cluster(batch, dirs, h)

    def run():
        xw_k = xw if xw is not None else f.lstm_f32_project(
            x, wxs, b32, spec, t_len, per_cluster)
        y, cs = f.lstm_f32_forward_chain(
            xw_k, whs, False, with_cs, batch=None if xw is not None
            else batch)
        return xw_k, y, cs

    def natural(xw_k):
        # the projection writes no row of the last tile past B: compare
        # the rows it writes
        return xw_k if xw is not None else f.from_f32_chain_order(
            xw_k, batch, h)

    xw_k, y, cs = run()
    torch.cuda.synchronize()
    again = run()
    repeats = torch.equal(natural(xw_k), natural(again[0])) and all(
        a is None or torch.equal(a, b) for a, b in zip((y, cs), again[1:]))
    del again

    # each kernel against its plain version on the kernels' own inputs
    max_abs = {}
    xw_nat = xw
    if xw is None:
        xw_nat = natural(xw_k)
        xw_ref = f.lstm_f32_project_reference(x, wxs, b32, spec, t_len)
        max_abs["lstm_f32_project"] = (xw_nat - xw_ref).abs().max().item()
        proj_rel = rel_err(xw_nat, xw_ref)
        del xw_ref
    y_ref, cs_ref = f.lstm_f32_forward_chain_reference(xw_nat, whs, False,
                                                       True)
    max_abs["lstm_f32_forward_chain"] = (y - y_ref).abs().max().item()
    cs_err = (cs - cs_ref).abs().max().item() if with_cs else 0.0
    del y_ref
    # the whole forward as the route runs it, the route's own FMA kernel,
    # both against the route's step-by-step plain forward
    want_y, want_cs = plain_whole()
    got_y, got_cs = whole()
    whole_err = {"y_max_abs": (got_y - want_y).abs().max().item(),
                 "cs_max_abs": (got_cs - want_cs).abs().max().item()
                 if with_cs else 0.0}
    old_err = {}
    if old:
        old_y, old_cs = old_f32_forward(route, x, flat, xw, ks, with_cs)
        old_err = {"y_max_abs": (old_y - want_y).abs().max().item(),
                   "cs_max_abs": (old_cs - want_cs).abs().max().item()
                   if with_cs else 0.0}
        del old_y, old_cs
    del got_y, got_cs, want_y, want_cs, cs_ref

    times = {"lstm_f32_forward_chain": time_ms(
        lambda: f.lstm_f32_forward_chain(
            xw_k, whs, False, with_cs,
            batch=None if xw is not None else batch), 1, 5)}
    plain = {"lstm_f32_forward_chain": time_ms(
        lambda: f.lstm_f32_forward_chain_reference(xw_nat, whs, False,
                                                   with_cs), 0, 1)}
    library = {"lstm_f32_forward_chain": None}
    x_bytes = x.numel() * 4
    if xw is None:
        times["lstm_f32_project"] = time_ms(
            lambda: f.lstm_f32_project(x, wxs, b32, spec, t_len,
                                       per_cluster), 1, 5)
        plain["lstm_f32_project"] = time_ms(
            lambda: f.lstm_f32_project_reference(x, wxs, b32, spec, t_len),
            0, 1)
        # cuBLAS: one f32 product of the (materialised) input rows with
        # both directions' Wx side by side, the bias added
        a2d = x_rows.reshape(rows, -1)
        w_cat = torch.cat(wx32, dim=1)
        b_cat = torch.cat(b32)
        library["lstm_f32_project"] = time_ms(
            lambda: torch.addmm(b_cat, a2d, w_cat), 1, 5)
        del a2d, w_cat
    whole_ms = time_ms(whole, 1, 5)
    plain_ms = time_ms(plain_whole, 0, 1)
    old_ms = time_ms(lambda: old_f32_forward(route, x, flat, xw, ks,
                                             with_cs), 1, 5) if old else None
    # cuDNN's f32 LSTM forward at the same shape (TF32 off; its input the
    # materialised frames on the unfold route)
    torch.manual_seed(SEED)
    lstm = torch.nn.LSTM(x_rows.shape[-1], h, batch_first=True,
                         bidirectional=dirs == 2).cuda()
    lstm.flatten_parameters()
    x_lib = x_rows.contiguous()
    with torch.inference_mode():
        cudnn_ms = time_ms(lambda: lstm(x_lib), 1, 5)
    del lstm, x_lib
    bounds = f32_forward_bounds(rows, spec.d if xw is None else 0, h, dirs,
                                x_bytes, with_cs)
    kernels = {}
    for kname in F32_FORWARD_NAMES:
        if kname not in times:
            continue
        kernels[kname] = {
            "max_abs_err": max_abs[kname], "ms": times[kname],
            "plain_ms": plain[kname], "library_ms": library[kname],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    kernels["lstm_f32_forward_chain"]["cs_max_abs_err"] = cs_err
    if xw is None:
        kernels["lstm_f32_project"]["rel_err"] = proj_rel
    forward = {"ms": whole_ms, "plain_ms": plain_ms, "library_ms": cudnn_ms,
               "bound_ms": bounds["function"][0],
               "bound_by": bounds["function"][1]}
    case = {"route": route, "shape": name, "dtype": "float32", "dirs": dirs,
            "T": t_len, "B": batch, "D": spec.d if xw is None else 0, "H": h,
            "rows": rows, "with_cs": with_cs, "rows_per_cluster": per_cluster,
            "repeats_bit_for_bit": repeats, "whole_err": whole_err,
            "kernels": kernels, "forward": forward,
            "own_fma_kernel": {
                "name": OLD_F32_FORWARD[route], "ms": old_ms,
                "max_abs_err": old_err["y_max_abs"],
                "cs_max_abs_err": old_err["cs_max_abs"],
                "plain_ms": plain_ms, "library_ms": cudnn_ms,
                "bound_ms": bounds["function"][0],
                "bound_by": bounds["function"][1]} if old else None}
    log("kernels f32 cluster forward", json.dumps(case))
    limit = 1e-4
    ok = (repeats and (xw is not None or proj_rel <= 1e-4)
          and max_abs["lstm_f32_forward_chain"] <= limit
          and cs_err <= limit
          and all(v <= limit for v in whole_err.values())
          and all(v <= limit for v in old_err.values())
          and torch.isfinite(y).all()
          and (cs is None or torch.isfinite(cs).all()))
    if not ok:
        raise AssertionError(f"f32 cluster forward disagrees: {case}")
    return case


F32_BACKWARD_NAMES = ("lstm_f32_gates", "lstm_f32_adjoint_chain",
                      "lstm_f32_dx", "lstm_f32_wgrad")


def f32_backward_bounds(rows, d, h, dirs, in_bytes, x_bytes, dx_bytes):
    """Least times of the f32 backward on the card (67 TFLOP/s f32 outside
    the tensor cores, 3.35 TB/s): every input read once, every output
    written once. Each kernel of its own inputs and outputs (so the split
    design's G and dg count where they pass between kernels): the gates A
    @ [Wx ; Wh] + (b or xw), G out; the chain's dh products, reading G, cs,
    dy and Wh and writing dg and the tiles' db; dx = dg @ Wx^T; dW = A^T @
    dg with its split partials. And the functions the Pallas kernels
    compute, with no G or dg passing between kernels: the adjoint (gate
    recompute, dh and dx from x or xw, y, cs, dy and the weights
    (`in_bytes`), writing dg, dx (`dx_bytes`, 0 on the two-kernel routes)
    and db) and the whole backward (the adjoint and dW, writing dx or dxw,
    dW and db)."""
    h4, k, f32 = 4 * h, d + h, torch.float32
    a_b = x_bytes + rows * dirs * h * 4  # x once, y once
    g_b = dg_b = dirs * rows * h4 * 4
    w_b = dirs * k * h4 * 4
    base_b = dirs * rows * h4 * 4 if d == 0 else dirs * h4 * 4
    product = 2 * dirs * rows * k * h4
    ops = product + 2 * dirs * rows * h * h4 + 2 * dirs * rows * h4 * d
    db_b = dirs * h4 * 4
    return {
        "lstm_f32_gates": _bound(product, a_b + w_b + base_b + g_b, f32),
        "lstm_f32_adjoint_chain": _bound(
            2 * dirs * rows * h * h4,
            g_b + rows * dirs * h * 4 * 2 + dg_b + dirs * h * h4 * 4, f32),
        "lstm_f32_dx": _bound(2 * dirs * rows * h4 * d,
                              dg_b + dirs * d * h4 * 4 + dirs * rows * d * 4,
                              f32),
        "lstm_f32_wgrad": _bound(product, a_b + dg_b + dirs * k * h4 * 4, f32),
        "adjoint": _bound(ops, in_bytes + dg_b + dx_bytes + db_b, f32),
        "backward": _bound(ops + product, in_bytes + (dx_bytes or dg_b)
                           + dirs * k * h4 * 4 + db_b, f32)}


def old_f32_backward(route, x, flat, xw, ys, cs, dys, ks, wgrad=True,
                     hs=1):
    """The route's own FMA backward kernels (`bilstm_bwd_kernel` and, with
    `wgrad`, `bilstm_wgrad_kernel` of csrc/bilstm_backward.cuh), launched
    directly through their wrappers: the layers no longer reach them at
    shapes the f32 backward gate takes. -> (adjoint's outputs, dW or
    None)."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_unfold

    if route == "layer":
        out = cuda_lstm.bilstm_layer_backward(x, *flat, ys, cs, dys)
        return out, wgrad and cuda_lstm.bilstm_layer_wgrad(x, ys, out[2])
    if route == "unfold":
        out = cuda_lstm_unfold.bilstm_layer_unfold_backward(
            x, *flat, ys, cs, dys, ks, hs)
        return out, wgrad and cuda_lstm_unfold.bilstm_layer_unfold_wgrad(
            x, ys, out[2], ks, hs)
    whs = flat[2::3]
    if route == "two_kernel":
        out = cuda_lstm_fused.bilstm_fused_backward(xw, *whs, ys, cs, dys)
        return out, wgrad and cuda_lstm_fused.bilstm_fused_wgrad(ys, out[0])
    out = cuda_lstm_fused.lstm_fused_backward(xw, *whs, ys, cs, dys)
    return out, wgrad and cuda_lstm_fused.lstm_fused_wgrad(ys, out[0])


def check_f32_backward(route, name, t_len, batch, d=D, h=H, length=None,
                       hs=1, old=True):
    """The f32 backward (gates, adjoint chain, dx, dW) of one LSTM route at
    one f32 training shape (what the joint v2 recipes' steps and the f32
    gradient checks run), f32 parameters, on the plain forward's saved
    tensors: each kernel against its plain version on the kernels' own
    inputs (so that only the kernel differs; G's chain order undone by
    from_f32_chain_order), the whole backward as the route runs it against
    the route's step-by-step plain backward, a second run bit for bit, each
    kernel's time beside its plain version's, its cuBLAS yardstick and its
    bound; the adjoint (gates, chain, dx) and the whole backward, each
    timed as one call, beside their functions' bounds, cuDNN's whole f32
    backward (TF32 off) and the route's own FMA kernels (launched
    directly, the old path: its adjoint, its dW and the two; not with
    `old` false).

    route: "layer" (K0b), "unfold" (K3b, x [B', L, 48], hop `hs`, T the
    frames), "two_kernel" (K2b) or "unidirectional" (K1b; both xw from x
    [B, T, d] as the layers project it, cuDNN's yardstick over that x).
    Limits, the f32 ones of the FMA kernels: every result within 1e-4 of
    its plain version's largest magnitude (f32 sums in another order over
    T steps), dW also against the plain product on the kernels' own dg."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_f32 as f
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc
    from wesep_tpu_torch.ops import cuda_lstm_unfold

    dirs = 1 if route == "unidirectional" else 2
    gen = torch.Generator().manual_seed(SEED + 60)
    scale = 1.0 / math.sqrt(h)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    flat = [w for _ in range(dirs) for w in (u(d, 4 * h), u(4 * h),
                                             u(h, 4 * h))]
    wx32, b32, whs = flat[0::3], flat[1::3], flat[2::3]
    biases, xw, wxs, ks = b32, None, None, d // GRID_C
    if route == "unfold":
        x = torch.randn(batch, length, GRID_C, generator=gen).cuda()
        ys, cs = cuda_lstm_unfold.bilstm_layer_unfold_reference(
            x, *flat, ks, hs, return_cs=True)
        spec = tc.RowSpec(tc.ROW_UNFOLD, d, length, GRID_C, hs)
        wxs = [tc.to_k_major(w, GRID_C, ks).contiguous() for w in wx32]
        x_lib = cuda_lstm_unfold.unfold_frames(x, ks, hs)
    elif route == "layer":
        x = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda()
        ys, cs = cuda_lstm.bilstm_layer_reference(x, *flat, return_cs=True)
        spec, wxs, x_lib = tc.RowSpec(tc.ROW_X, d), wx32, x
    else:
        x_lib = (torch.randn(batch, t_len, d, generator=gen) * 0.2).cuda()
        xw = torch.stack([cuda_lstm_fused.project(x_lib, wx, b)
                          for wx, b in zip(wx32, b32)])
        ys, cs = cuda_lstm_fused._recurrence_reference(xw, whs, False, True)
        x, spec, biases = None, tc.RowSpec(tc.ROW_H, 0), None
    frames = ys.shape[1]
    rows = batch * frames
    dys = (torch.randn(batch, frames, dirs * h, generator=gen) * 0.1).cuda()
    per_cluster = f.adjoint_rows_per_cluster(batch, dirs, h)

    def gates():
        return f.lstm_f32_gates(x, ys, wxs, whs, spec, per_cluster, biases,
                                xw)

    def adjoint():
        dg_, db_ = f.lstm_f32_adjoint_chain(gates(), whs, cs, dys, batch)
        return (f.lstm_f32_dx(dg_, wxs) if wxs is not None else None), dg_, \
            db_

    def run():
        g_ = gates()
        dg_, db_ = f.lstm_f32_adjoint_chain(g_, whs, cs, dys, batch)
        dx2_ = f.lstm_f32_dx(dg_, wxs) if wxs is not None else None
        return g_, dg_, db_, dx2_, f.lstm_f32_wgrad(x, ys, dg_, spec)

    g, dg, db, dx2, dw = run()
    torch.cuda.synchronize()
    again = run()
    # G's rows of the last tile past B are never written: compare the rows
    # it writes
    repeats = torch.equal(f.from_f32_chain_order(g, batch, h),
                          f.from_f32_chain_order(again[0], batch, h)) and all(
        a is None and b is None or torch.equal(a, b)
        for a, b in zip((dg, db, dx2, dw), again[1:]))
    del again

    # each kernel against its plain version on the kernels' own inputs
    errs, max_abs = {}, {}

    def compare(kname, got, want):
        errs[kname] = max(errs.get(kname, 0.0), rel_err(got, want))
        max_abs[kname] = max(max_abs.get(kname, 0.0),
                             (got.float() - want.float()).abs().max().item())

    g_nat = f.from_f32_chain_order(g, batch, h)
    compare("lstm_f32_gates", g_nat, f.lstm_f32_gates_reference(
        x, ys, wxs, whs, spec, biases, xw))
    dg_ref, db_ref = f.lstm_f32_adjoint_chain_reference(
        g_nat, whs, cs, dys, False, per_cluster)
    compare("lstm_f32_adjoint_chain", dg, dg_ref)
    compare("lstm_f32_adjoint_chain", db, db_ref)
    del dg_ref, g_nat
    if dx2 is not None:
        compare("lstm_f32_dx", dx2, f.lstm_f32_dx_reference(dg, wxs))
    compare("lstm_f32_wgrad", dw, f.lstm_f32_wgrad_reference(x, ys, dg,
                                                             spec))

    # the whole backward, as the route runs it, against the route's
    # step-by-step plain backward
    if route == "layer":
        want = cuda_lstm.bilstm_layer_backward_reference(x, *flat, ys, cs,
                                                         dys)
        got = cuda_lstm._backward_cuda(x, *flat, ys, cs, dys)
        names = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")
    elif route == "unfold":
        want = cuda_lstm_unfold.bilstm_layer_unfold_backward_reference(
            x, *flat, ys, cs, dys, ks, hs)
        got = cuda_lstm_unfold._backward_cuda(x, *flat, ys, cs, dys, ks, hs)
        names = ("dx", "dwx_f", "db_f", "dwh_f", "dwx_b", "db_b", "dwh_b")
    else:
        want = cuda_lstm_fused._adjoint_reference(xw, whs, False, ys, cs,
                                                  dys)
        got = tc.fused_backward(xw, whs, ys, cs, dys)
        names = ("dxw", "dwh", "db")
    whole = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    del got, want

    times = {"lstm_f32_gates": time_ms(gates, 1, 5)}
    times["lstm_f32_adjoint_chain"] = time_ms(
        lambda: f.lstm_f32_adjoint_chain(g, whs, cs, dys, batch), 1, 5)
    if dx2 is not None:
        times["lstm_f32_dx"] = time_ms(lambda: f.lstm_f32_dx(dg, wxs), 1, 5)
    times["lstm_f32_wgrad"] = time_ms(
        lambda: f.lstm_f32_wgrad(x, ys, dg, spec), 1, 5)
    g_nat = f.from_f32_chain_order(g, batch, h)
    plain = {
        "lstm_f32_gates": time_ms(lambda: f.lstm_f32_gates_reference(
            x, ys, wxs, whs, spec, biases, xw), 0, 1),
        "lstm_f32_adjoint_chain": time_ms(
            lambda: f.lstm_f32_adjoint_chain_reference(
                g_nat, whs, cs, dys, False, per_cluster), 0, 1),
        "lstm_f32_wgrad": time_ms(
            lambda: f.lstm_f32_wgrad_reference(x, ys, dg, spec), 0, 1)}
    if dx2 is not None:
        plain["lstm_f32_dx"] = time_ms(
            lambda: f.lstm_f32_dx_reference(dg, wxs), 0, 1)
    del g_nat, g
    # cuBLAS yardsticks, never called by the port: the same f32 products
    # per direction (TF32 off)
    a = tc.gate_rows(x, ys, spec, dirs)
    wcat = [w if wxs is None else torch.cat([wx, w])
            for wx, w in zip(wxs or [None] * dirs, whs)]
    dg2d = dg.reshape(dirs, rows, -1)
    library = {"lstm_f32_gates": time_ms(lambda: [
        torch.mm(a[i].reshape(rows, -1), wcat[i]) for i in range(dirs)],
        1, 5)}
    if dx2 is not None:
        library["lstm_f32_dx"] = time_ms(lambda: [
            torch.mm(dg2d[i], wxs[i].t()) for i in range(dirs)], 1, 5)
    wgrad_lib_ms, wgrad_apart_ms = library_wgrad_ms(
        [a[i].reshape(rows, -1) for i in range(dirs)], dg)
    library["lstm_f32_wgrad"] = wgrad_lib_ms
    del a, dg2d
    whole_ms = {"adjoint": time_ms(adjoint, 1, 5),
                "backward": time_ms(run, 1, 5)}

    # the old path: the route's own FMA kernels, launched directly
    old_ms = dict.fromkeys(("adjoint", "backward", "wgrad"))
    if old:
        old_ms["adjoint"] = time_ms(lambda: old_f32_backward(
            route, x, flat, xw, ys, cs, dys, ks, wgrad=False, hs=hs), 1, 3)
        old_ms["backward"] = time_ms(lambda: old_f32_backward(
            route, x, flat, xw, ys, cs, dys, ks, hs=hs), 1, 3)
        old_ms["wgrad"] = old_ms["backward"] - old_ms["adjoint"]

    # cuDNN's whole f32 backward over the same rows (the frames for K3;
    # x for the two-kernel routes), never called by the port
    lstm = torch.nn.LSTM(x_lib.shape[-1], h, batch_first=True,
                         bidirectional=dirs == 2).cuda()
    lstm.flatten_parameters()
    xg = x_lib.detach().clone().requires_grad_()
    lib_y = lstm(xg)[0]
    lib_params = list(lstm.parameters())
    cudnn_ms = time_ms(lambda: torch.autograd.grad(
        lib_y, [xg] + lib_params, dys, retain_graph=True), 1, 5)
    del lib_y, lstm, xg

    in_bytes = sum(t.numel() * t.element_size()
                   for t in (x, xw, ys, cs, dys, *whs, *(wxs or []),
                             *(biases or [])) if t is not None)
    x_bytes = x.numel() * 4 if x is not None else 0
    bounds = f32_backward_bounds(rows, spec.d, h, dirs, in_bytes, x_bytes,
                                 x_bytes if wxs is not None else 0)
    kernels = {}
    for kname in F32_BACKWARD_NAMES:
        if kname not in times:
            continue
        kernels[kname] = {
            "rel_err": errs[kname], "max_abs_err": max_abs[kname],
            "ms": times[kname], "plain_ms": plain[kname],
            "library_ms": library.get(kname),
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    kernels["lstm_f32_wgrad"]["library_per_direction_ms"] = wgrad_apart_ms
    case = {"route": route, "shape": name, "dtype": "float32", "dirs": dirs,
            "hs": hs,
            "T": frames, "B": batch, "D": spec.d, "H": h, "rows": rows,
            "rows_per_cluster": per_cluster,
            "repeats_bit_for_bit": repeats, "whole_rel_err": whole,
            "kernels": kernels,
            "function": {
                part: {"ms": whole_ms[part], "bound_ms": bounds[part][0],
                       "bound_by": bounds[part][1],
                       "old_fma_ms": old_ms[part]}
                for part in ("adjoint", "backward")},
            "old_fma_wgrad_ms": old_ms["wgrad"],
            "cudnn_backward_ms": cudnn_ms,
            "g_scratch_bytes": dirs * rows * 4 * h * 4,
            "dg_scratch_bytes": dg.numel() * dg.element_size()}
    log("kernels f32 backward", json.dumps(case))
    ok = (repeats and all(e <= 1e-4 for e in errs.values())
          and all(v <= 1e-4 for v in whole.values())
          and all(torch.isfinite(t).all() for t in (dg, db, dw)))
    if not ok:
        raise AssertionError(f"f32 backward disagrees: {case}")
    return case


def f32_refused_path():
    """f32 layers at a shape the f32 gates refuse (H 96: not whole clusters
    of 32-unit blocks), through each route's layer function on the card,
    counts set to 0 just before and read just after: a served forward is
    one launch of the route's own FMA forward kernel and none of any other
    LSTM kernel; a forward with cs and its backward one launch each of the
    route's own FMA forward, serial adjoint and weight-gradient kernels and
    none of any other; each output against the route's plain version (y
    1e-4 abs, every gradient 1e-4 of its largest magnitude). -> {route:
    counts}."""
    from wesep_tpu_torch.ops import cuda_lstm, cuda_lstm_fused
    from wesep_tpu_torch.ops import cuda_lstm_unfold
    from wesep_tpu_torch.ops.cuda_lstm_f32 import (
        f32_backward_fits,
        f32_forward_fits,
    )

    batch, t_len, d, h, c, ks = 6, 40, 64, 96, 16, 4
    if f32_forward_fits(torch.float32, d, h, batch * t_len) or \
            f32_backward_fits(torch.float32, d, h, batch * t_len):
        raise AssertionError("the f32 gates take the refused shape")
    gen = torch.Generator().manual_seed(SEED + 50)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) / 10).cuda()

    x = torch.randn(batch, t_len, d, generator=gen).cuda() * 0.5
    xu = torch.randn(batch, t_len + ks - 1, c, generator=gen).cuda()
    bi = [u(d, 4 * h), u(4 * h), u(h, 4 * h)] * 2
    bi_u = [u(ks * c, 4 * h), u(4 * h), u(h, 4 * h)] * 2
    runs = {
        "layer": (x, bi, lambda p, a: cuda_lstm.bilstm_layer(*a, plain=p)),
        "unfold": (xu, bi_u, lambda p, a: cuda_lstm_unfold.bilstm_layer_unfold(
            *a, ks, 1, plain=p)),
        "two_kernel": (x, bi, lambda p, a: cuda_lstm_fused.bilstm_fused(
            *a, plain=p)),
        "unidirectional": (x, bi[:3], lambda p, a: cuda_lstm_fused.lstm_fused(
            *a, plain=p)),
    }
    out = {}
    for route, (xin, weights, fn) in runs.items():
        args = (xin, *weights)
        with torch.inference_mode():
            zero_counts()
            y = fn(False, args)
            torch.cuda.synchronize()
            counts = read_counts()
            want = fn(True, args)
        err = (y - want).abs().max().item()
        expect = dict.fromkeys(counts, 0)
        expect[OLD_F32_FORWARD[route]] = 1
        # and a forward with cs and its backward
        dy = torch.randn(*y.shape, generator=gen).cuda()
        grads = {}
        for plain in (False, True):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            zero_counts()
            fn(plain, leaves).backward(dy)
            torch.cuda.synchronize()
            if not plain:
                train_counts = read_counts()
            grads[plain] = [a.grad for a in leaves]
        grad_err = max(rel_err(g, p) for g, p in zip(grads[False],
                                                    grads[True]))
        _, adjoint, wgrad = LSTM_ROUTES[route]
        train_expect = dict.fromkeys(counts, 0)
        train_expect.update({OLD_F32_FORWARD[route]: 1, adjoint: 1,
                             wgrad: 1})
        log(f"f32 at a refused shape ({route} route, B' {batch}, H {h}): "
            f"forward launches {({n: v for n, v in counts.items() if v})}, "
            f"max abs error {err:.3e} against the plain version (limit "
            f"1e-4); forward and backward launches "
            f"{({n: v for n, v in train_counts.items() if v})}, gradients "
            f"{grad_err:.3e} of their largest magnitude (limit 1e-4)")
        if counts != expect or train_counts != train_expect \
                or not (err <= 1e-4 and grad_err <= 1e-4):
            raise AssertionError(f"refused f32 shape on the {route} route: "
                                 f"launches {counts}, {train_counts}, "
                                 f"errors {err}, {grad_err}")
        out[route] = {n: counts[n] + train_counts[n] for n in counts}
    return out


def write_shard(root, rng, name, seconds):
    """Premixed shard `name`.tar of len(seconds) two-speaker mixtures, with
    its list, 256-d embeddings (scp), utt2spk and enrollment lists, as the
    recipes lay them out; returns their paths and the lengths."""
    from wesep_tpu_torch.data.wav_io import wav_bytes
    from wesep_tpu_torch.utils.file_utils import write_vec_ark_scp

    emb_dim = V1_MODEL_ARGS["spk_emb_dim"]
    lengths = [int(round(s * 16000)) for s in seconds]
    keys = [f"{name}{i:02d}" for i in range(len(lengths))]
    embeds, utt2spk = {}, {}
    tar_path = os.path.join(root, f"{name}.tar")
    with tarfile.open(tar_path, "w") as tar:
        for key, n in zip(keys, lengths):
            srcs = []
            for spk in (1, 2):
                embeds[f"{key}_enr{spk}"] = rng.standard_normal(emb_dim)
                utt2spk[f"{key}_enr{spk}"] = f"{key}_s{spk}"
                # a few harmonic partials with noise, per speaker
                t = np.arange(n) / 16000.0
                f0 = rng.uniform(90, 250)
                s = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                        / k for k in range(1, 6))
                s = 0.1 * s + 0.02 * rng.standard_normal(n)
                srcs.append(s.astype(np.float32))
            members = [(f"{key}.spk1", f"{key}_s1".encode()),
                       (f"{key}.spk2", f"{key}_s2".encode()),
                       (f"{key}.wav", wav_bytes(srcs[0] + srcs[1], 16000)),
                       (f"{key}_spk1.wav", wav_bytes(srcs[0], 16000)),
                       (f"{key}_spk2.wav", wav_bytes(srcs[1], 16000))]
            for member, data in members:
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    _, scp = write_vec_ark_scp(os.path.join(root, f"{name}_embed"), embeds)
    paths = {"data": os.path.join(root, f"{name}.list"), "spk_embeds": scp,
             "utt2spk": os.path.join(root, f"{name}.utt2spk")}
    with open(paths["data"], "w") as f:
        f.write(tar_path + "\n")
    with open(paths["utt2spk"], "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in utt2spk.items())
    for spk in (1, 2):
        paths[f"spk{spk}_enroll"] = os.path.join(root, f"{name}_spk{spk}_enroll")
        with open(paths[f"spk{spk}_enroll"], "w") as f:
            f.writelines(f"{k} {k}_enr{spk}\n" for k in keys)
    return paths, lengths


def forward_steps(lengths):
    """Forward calls bin/infer makes: rows (2 per mixture) buffered per
    length bucket, ROWS_PER_STEP at a time."""
    rows = {}
    for n in lengths:
        pad = math.ceil(n / BUCKET) * BUCKET
        rows[pad] = rows.get(pad, 0) + 2
    return sum(math.ceil(r / ROWS_PER_STEP) for r in rows.values())


# The pBSRNN's LSTM routes: the environment and the overrides (as the
# entry points' `--set` takes them) that choose each; the wrappers each
# launches are LSTM_ROUTES[route]
BSRNN_ROUTES = {
    "layer": ({}, []),
    "two_kernel": ({"WESEP_LSTM_LAYER": "0"}, []),
    "unidirectional": ({}, ["model_args.tse_model.use_bidirectional=false"]),
}


def bsrnn_route(route):
    """(environment, overrides, model arguments) of a pBSRNN route."""
    from wesep_tpu_torch.utils.config import parse_override_args

    env, overrides = BSRNN_ROUTES[route]
    tse = parse_override_args(overrides).get("model_args", {}) \
        .get("tse_model", {})
    return env, overrides, dict(V1_MODEL_ARGS, **tse)


def set_env(env):
    """Set the variables of `env` (None removes one); return the old
    values, for set_env again."""
    old = {key: os.environ.get(key) for key in env}
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    return old


def serve(root, route="layer"):
    """Phase 4 (and 12, 13 on the other routes): the v1 pBSRNN through
    bin/infer on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    env, overrides, model_args = bsrnn_route(route)
    rng = np.random.default_rng(SEED)
    paths, lengths = write_shard(root, rng, "test", SHARD_SECONDS)
    data = {f"test_{k}": v for k, v in paths.items() if k != "utt2spk"}
    torch.manual_seed(SEED)
    model = BSRNN(**model_args)
    ckpt = os.path.join(root, "avg_model.pt")
    save_checkpoint(ckpt, [model.state_dict()])
    config = {
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V1_MODEL_ARGS)},
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000},
        "exp_dir": os.path.join(root, "exp"),
        "checkpoint": ckpt,
        "length_bucket": BUCKET,
        "infer_batch_size": ROWS_PER_STEP,
        "device": "cuda",
        **data,
    }
    tag = f"serve ({route} route)"
    old_env = set_env(env)
    try:
        steps = forward_steps(lengths)
        zero_counts()
        t0 = time.perf_counter()
        avg_sisnr, avg_sisnri = infer(config, overrides=overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches = counts["lstm_f32_forward_chain"]
        audio_s = 2 * sum(lengths) / 16000.0
        log(f"{tag}: {2 * len(lengths)} requests (mixture x target) in "
            f"{steps} forward steps, {wall:.3f} s wall, RTF "
            f"{wall / audio_s:.5f}, avg SI-SNR {avg_sisnr:.3f} dB, avg "
            f"SI-SNRi {avg_sisnri:.3f} dB (random weights: shows the chain "
            "ran, not quality)")
        per_forward = 2 * V1_MODEL_ARGS["num_repeat"]  # band + comm per BSNet
        log(f"{tag}: launches {({n: v for n, v in counts.items() if v})} "
            f"(expected {per_forward} x {steps} of the f32 cluster chain, "
            "as many of the f32 projection on the layers that project x, "
            "no other LSTM kernel)")
        expect_counts(counts, per_forward * steps, 0, route, tag, f32=True)
        if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
            raise AssertionError("non-finite SI-SNR from infer")
        audio = os.path.join(root, "exp", "audio")
        wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
        if len(wavs) != 2 * len(lengths):
            raise AssertionError(f"{len(wavs)} outputs for "
                                 f"{2 * len(lengths)} requests")
        for name, n in zip(wavs[::2], lengths):
            wav, _ = read_wav(os.path.join(audio, name))
            if wav.shape != (1, n) or not np.isfinite(wav).all():
                raise AssertionError(f"bad output {name}: {wav.shape}")

        # kernel forward vs plain-LSTM forward of the same model, f32
        model = model.cuda().eval()
        gen = torch.Generator().manual_seed(SEED + 1)
        mix = (torch.randn(ROWS_PER_STEP, 48000, generator=gen) * 0.1).cuda()
        emb = torch.randn(ROWS_PER_STEP, 256, generator=gen).cuda()
        lstms = [m for m in model.modules() if isinstance(m, LSTM)]
        with torch.inference_mode():
            zero_counts()
            est = model(mix, emb)[0]
            expect_counts(read_counts(), per_forward, 0, route,
                          f"one forward ({route} route)", f32=True)
            step_ms = time_ms(lambda: model(mix, emb), warmup=1, runs=5)
            for m in lstms:
                m.plain = True
            try:
                est_plain = model(mix, emb)[0]
                plain_step_ms = time_ms(lambda: model(mix, emb), 1, 3)
            finally:
                for m in lstms:
                    m.plain = False
            if route == "two_kernel":
                # the default route's kernels on the same model, in turns
                set_env({"WESEP_LSTM_LAYER": None})
                layer_step_ms = time_ms(lambda: model(mix, emb), 1, 5)
                set_env(env)
                again_ms = time_ms(lambda: model(mix, emb), 1, 5)
    finally:
        set_env(old_env)
    if not torch.isfinite(est).all() or est.shape != mix.shape:
        raise AssertionError("kernel forward is not finite / wrong shape")
    rel = ((est - est_plain).norm() / est_plain.norm()).item()
    log(f"{tag}: forward [2 x 3 s] {step_ms:.3f} ms/step with the kernel, "
        f"{plain_step_ms:.3f} ms/step with the plain LSTM; "
        f"{2 * 3.0 / (step_ms / 1e3):.1f} audio-s/s, RTF "
        f"{step_ms / 1e3 / 6.0:.5f}; kernel vs plain rel L2 {rel:.3e} "
        "(limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"kernel forward differs from plain: {rel}")
    summary = {
        "route": route, "requests": 2 * len(lengths), "steps": steps,
        "wall_s": wall, "rtf_wall": wall / audio_s, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms, "rel_l2_vs_plain": rel,
        "avg_sisnri": avg_sisnri,
    }
    if route == "two_kernel":
        summary.update(step_ms_again=again_ms,
                       layer_route_step_ms=layer_step_ms)
        log(f"{tag}: forward in turns, two-kernel route {step_ms:.3f} ms, "
            f"default (fused layer) route {layer_step_ms:.3f} ms, two-kernel "
            f"route {again_ms:.3f} ms")
    return counts, summary


def rows_loss(text):
    """The TRAIN rows' running mean losses from a train log."""
    return [float(v) for v in re.findall(
        r"\|\s+TRAIN\s+\|\s+1\s+\|\s+\d+\s+\|\s+(\S+)\s+\|", text)]


def param_grads(model, mix, emb, target, dtype=None):
    """Gradients of the SI-SDR loss w.r.t. every parameter, by name; with
    `dtype`, the mixture and the cue cast to it as make_train_step casts
    them, the estimate back to f32 for the loss."""
    from wesep_tpu_torch.train.losses import si_sdr_loss

    names, params = zip(*model.named_parameters())
    if dtype is not None:
        mix, emb = mix.to(dtype), emb.to(dtype)
    loss = si_sdr_loss(model(mix, emb)[0].float(), target).mean()
    return dict(zip(names, torch.autograd.grad(loss, params)))


# Whole-model gradients in bf16, kernels against plain versions. Both
# paths round h, the dgates and dx to bf16 at the same points, but their
# f32 sums differ in order (the kernels' tensor-core tiles and cluster
# partition, the plain versions' step-by-step products), so a rounding
# flips now and then and moves a value by one bf16 unit (2^-8 of it); the
# flips pass through 12 layers and the bf16 model around them, whose own
# roundings then differ too. So the bound is bf16's own error: with K, P
# the kernels' and the plain versions' bf16 gradients and F the plain
# versions' f32 one (all parameters' gradients together), a K no further
# from F than P is gives |K - P| <= |K - F| + |F - P| <= 2 |P - F|; and no
# parameter may differ by more than BF16_GRAD_WORST (relative L2; some
# parameters' gradients nearly cancel).
BF16_GRAD_WORST = 1e-1
# Controls of that bound: the kernels' path with a fault planted in the
# chain wrapper's inputs. "g_bf16" rounds the stored gates G to bf16 first,
# one rounding more than the design has (reported, not required either
# way); "dh_partial_dropped" zeroes the Wh columns that the last block of
# every cluster owns, so its partial dh never reaches the units' owners, as
# a reduce-scatter that lost one sender would: the bound must reject it.
BF16_GRAD_CONTROLS = ("g_bf16", "dh_partial_dropped")


def bf16_verdict(got, want, plain_f32):
    """bf16 gradients `got` against the plain versions' bf16 (`want`) and
    f32 (`plain_f32`) ones, by the bounds above."""
    rel = {n: rel_l2(got[n], want[n]) for n in want}
    worst = max(rel, key=rel.get)
    flat = [torch.cat([g.flatten() for g in d.values()])
            for d in (got, want, plain_f32)]
    out = {"whole": rel_l2(flat[0], flat[1]),
           "bf16_vs_f32": rel_l2(flat[1], flat[2]),
           "kernels_vs_f32": rel_l2(flat[0], flat[2]),
           "worst": rel[worst], "worst_at": worst}
    out["passes"] = (out["whole"] <= 2 * out["bf16_vs_f32"]
                     and out["worst"] <= BF16_GRAD_WORST)
    return out


def planted_chain(chain, fault):
    """`chain` (the chain wrapper) with one of BF16_GRAD_CONTROLS planted;
    its `.calls` counts its calls (and `.launches` the kernel's, as the
    wrapper counts them while it stands in the wrapper's place)."""
    from wesep_tpu_torch.ops.cuda_lstm_tc import CLUSTER

    def faulty(g, whs, cs, dys, reverse=False):
        faulty.calls += 1
        if fault == "g_bf16":
            g = g.to(torch.bfloat16).float()
        else:
            h = whs[0].shape[0]
            whs = [w.clone() for w in whs]
            for w in whs:
                w.view(h, 4, h)[:, :, h - h // CLUSTER:] = 0
        return chain(g, whs, cs, dys, reverse)

    faulty.calls = faulty.launches = 0
    return faulty


def bf16_grads(model, plain_modules, mix, emb, target, plain_f32):
    """bf16 whole-model gradients through the kernels against those
    through the plain versions (`plain_modules` switched by their `plain`
    flag), with `plain_f32` the plain versions' f32 gradients; raises past
    the bounds above, or if the bounds accept the dropped partial dh."""
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc

    got = param_grads(model, mix, emb, target, torch.bfloat16)
    for m in plain_modules:
        m.plain = True
    want = param_grads(model, mix, emb, target, torch.bfloat16)
    for m in plain_modules:
        m.plain = False
    out = bf16_verdict(got, want, plain_f32)
    if not out["passes"]:
        raise AssertionError(f"bf16 gradients differ: {out}")
    del got
    chain, out["controls"] = tc.lstm_adjoint_chain, {}
    for fault in BF16_GRAD_CONTROLS:
        tc.lstm_adjoint_chain = planted = planted_chain(chain, fault)
        try:
            bad = param_grads(model, mix, emb, target, torch.bfloat16)
        finally:
            tc.lstm_adjoint_chain = chain
        out["controls"][fault] = dict(bf16_verdict(bad, want, plain_f32),
                                      chain_calls=planted.calls)
        del bad
    dropped = out["controls"]["dh_partial_dropped"]
    if dropped["passes"] or not dropped["chain_calls"]:
        raise AssertionError(f"the bf16 bound accepts a dropped partial dh "
                             f"(or the chain never ran): {dropped}")
    return out


def train_phase(root, route="layer"):
    """Phase 5 (and 12, 13 on the other routes): the v1 pBSRNN through
    bin/train on the card."""
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    env, overrides, model_args = bsrnn_route(route)
    tag = f"train ({route} route)"
    rng = np.random.default_rng(SEED + 2)
    tr, _ = write_shard(root, rng, "train", [4.0] * (2 * TRAIN_BATCH))
    va, _ = write_shard(root, rng, "dev", [3.5] * TRAIN_BATCH)
    torch.manual_seed(SEED)
    init = BSRNN(**model_args)
    init_path = os.path.join(root, "init.ckpt")
    save_checkpoint(init_path, [init.state_dict()])
    # the values of examples/librimix/tse/v1/confs/bsrnn.yaml; one epoch of
    # TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                            "prefetch_factor": 6},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch": TRAIN_STEPS * TRAIN_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": CHUNK, "speaker_feat": False},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V1_MODEL_ARGS)},
        "model_init": {"tse_model": init_path},
        "num_avg": 2, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }
    old_env = set_env(env)
    try:
        return _train_route(route, tag, config, overrides, model_args, init,
                            env)
    finally:
        set_env(old_env)


def _train_route(route, tag, config, overrides, model_args, init, env):
    """train_phase with the route's environment set: bin/train, its
    checkpoint, whole-model gradients against the plain LSTM's, the time
    and peak memory of a train step."""
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.train.checkpoint import load_checkpoint
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    names = LSTM_ROUTES[route]
    zero_counts()
    t0 = time.perf_counter()
    state = train(config, overrides=overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = [counts[n] for n in names]
    per_pass = 2 * V1_MODEL_ARGS["num_repeat"]  # band + comm per BSNet
    val_steps = 1  # 16 validation enrollments / 2 / batch_size 8
    log(f"{tag}: {TRAIN_STEPS} steps + {val_steps} validation step through "
        f"bin/train in {wall:.3f} s wall; launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected "
        f"{per_pass * TRAIN_STEPS} of each tensor-core forward and backward "
        f"kernel (bf16 steps), {per_pass * val_steps} of the f32 cluster "
        f"chain (the f32 validation step, and of the f32 projection on the "
        f"layers that project x), no other LSTM kernel)")
    expect_counts(counts, per_pass * TRAIN_STEPS, per_pass * TRAIN_STEPS,
                  route, tag, f32_forward=per_pass * val_steps)
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    log(f"{tag}: running mean loss per step {losses}, epoch {epoch}")
    if len(losses) != TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates, expected {TRAIN_STEPS}")
    moved = {n: (p.detach().cpu() - init.state_dict()[n]).abs().max().item()
             for n, p in state.model.named_parameters()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError("parameters that did not change: "
                             f"{[n for n, v in moved.items() if v == 0]}")
    models = os.path.join(config["exp_dir"], "models")
    bundle = load_checkpoint(os.path.join(models, "checkpoint_1.ckpt"))
    if not (bundle["step"] == TRAIN_STEPS
            and bundle["opt_states"][0]["count"] == TRAIN_STEPS
            and set(bundle["opt_states"][0]["mu"]) == set(moved)
            and os.path.islink(os.path.join(models, "final_checkpoint.ckpt"))):
        raise AssertionError("checkpoint_1.ckpt lacks optimizer state or step")
    served = BSRNN(**model_args)  # as bin/infer loads it
    served.load_state_dict(bundle["models"][0])
    for n, p in served.named_parameters():
        if not torch.equal(p.detach(), state.model.state_dict()[n].cpu()):
            raise AssertionError(f"checkpoint differs from the model at {n}")
    del state

    # gradients through the kernels against gradients through the plain
    # LSTM: f32, 2 rows x 3 s, relative L2 per parameter (limit 1e-3: the
    # two paths differ only in the order of f32 sums)
    gen = torch.Generator().manual_seed(SEED + 3)
    model = BSRNN(**model_args)
    model.load_state_dict(init.state_dict())
    model = model.cuda().train()
    mix = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    target = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(2, 256, generator=gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    zero_counts()
    got = param_grads(model, mix, emb, target)
    f32_counts = read_counts()
    expect_counts(f32_counts, per_pass, per_pass, route,
                  f"{tag}: f32 gradients", f32=True)
    for m in lstms:
        m.plain = True
    want = param_grads(model, mix, emb, target)
    for m in lstms:
        m.plain = False
    rel = {n: ((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-20))
           .item() for n in want}
    worst = max(rel, key=rel.get)
    log(f"{tag}: gradients of {len(rel)} parameters, kernels vs plain LSTM "
        f"(f32): worst relative L2 {rel[worst]:.3e} at {worst} (limit 1e-3)")
    if not rel[worst] <= 1e-3:
        raise AssertionError(f"gradients differ: {worst} {rel[worst]}")

    # and in bf16, the dtype the recipe trains in, where the backward runs
    # the tensor-core kernels (bounds above bf16_grads)
    bf16 = bf16_grads(model, lstms, mix, emb, target, want)
    del got, want
    log(f"{tag}: gradients of {len(rel)} parameters, kernels vs plain LSTM "
        f"(bf16): whole gradient relative L2 {bf16['whole']:.3e} (limit "
        f"twice the plain LSTM's bf16 vs f32, {bf16['bf16_vs_f32']:.3e}; "
        f"kernels' bf16 vs plain f32 {bf16['kernels_vs_f32']:.3e}); worst "
        f"parameter {bf16['worst']:.3e} at {bf16['worst_at']} (limit "
        f"{BF16_GRAD_WORST})")
    for fault, c in bf16["controls"].items():
        log(f"{tag}: bf16 control {fault} ({c['chain_calls']} chain calls): "
            f"whole {c['whole']:.3e} against the limit "
            f"{2 * c['bf16_vs_f32']:.3e}, worst parameter {c['worst']:.3e} "
            f"at {c['worst_at']}: {'accepted' if c['passes'] else 'rejected'}")

    # time and peak memory of one train step at the recipe's size
    rows = 2 * TRAIN_BATCH
    batch = {
        "wav_mix": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "wav_targets": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "spk_embeds": torch.randn(rows, 256, generator=gen).cuda(),
    }
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"),
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(tstate, batch)
    per_step = read_counts()
    log(f"{tag}: launches of one train step "
        f"{ {n: v for n, v in per_step.items() if v} }")
    expect_counts(per_step, per_pass, per_pass, route,
                  f"one train step ({route} route)")
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    audio = rows * CHUNK / 16000.0
    summary = {
        "route": route, "steps": TRAIN_STEPS, "val_steps": val_steps,
        "wall_s": wall, "running_mean_loss": losses, "step_ms": step_ms,
        "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "grad_rel_l2_worst": rel[worst],
        "bf16_grad_rel_l2": bf16,
        "launches_per_step": {n: v for n, v in per_step.items() if v},
    }
    if route == "layer":
        for m in lstms:
            m.plain = True
        summary["plain_step_ms"] = time_ms(lambda: step(tstate, batch),
                                           warmup=0, runs=1)
        for m in lstms:
            m.plain = False
        other = ""
    elif route == "two_kernel":
        # the default route's kernels on the same model and batch, in turns:
        # two-kernel, fused layer, fused layer, two-kernel
        set_env({"WESEP_LSTM_LAYER": None})
        layer_ms = [time_ms(lambda: step(tstate, batch), 1, 5)
                    for _ in range(2)]
        set_env(env)
        summary["step_ms_again"] = time_ms(lambda: step(tstate, batch), 1, 5)
        summary["layer_route_step_ms"] = layer_ms
        other = (f"; default (fused layer) route {layer_ms[0]:.3f} / "
                 f"{layer_ms[1]:.3f} ms, this route again "
                 f"{summary['step_ms_again']:.3f} ms")
    else:
        other = ""
    if "plain_step_ms" in summary:
        other += f", {summary['plain_step_ms']:.3f} ms with the plain LSTM"
    log(f"{tag}: step [16 rows x 3 s, bf16] {step_ms:.3f} ms with the "
        f"kernels{other}; {audio / (step_ms / 1e3):.1f} audio-s/s; peak "
        f"memory {peak / 2 ** 30:.2f} GiB")
    return {"main": counts, "f32_grads": f32_counts}, summary


TCN_GRADS = ("dx", "db1_eff", "dw1", "dp0", "dkd", "dbd", "dg0w", "dg0b",
             "dp1", "dw2", "db2", "dg1w", "dg1b")


def tcn_args(batch, dtype, seed=SEED):
    """Seeded inputs of one fused block at SpEx+'s widths: the thirteen
    arguments (x in `dtype`, f32 parameters) and a cotangent dy."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    u = lambda n: torch.rand(n, generator=gen) + 0.5  # noqa: E731
    c, h, k = TCN_C, TCN_H, TCN_K
    args = [r(batch, SPEX_T, c) * 0.5, r(batch, h) * 0.1, r(c, h) * 0.06,
            torch.tensor([0.25]), r(k, h) * 0.3, r(h) * 0.1, u(h),
            r(h) * 0.2, torch.tensor([0.2]), r(h, c) * 0.04, r(c) * 0.1,
            u(h), r(h) * 0.2]
    args = [a.cuda() for a in args]
    args[0] = args[0].to(dtype)
    return args, (r(batch, SPEX_T, c) * 0.1).cuda().to(dtype)


def tcn_bounds(batch, dtype):
    """Least times of the fused block on the card, forward and backward:
    the operations the JAX package counts for it (forward 4 B T C H +
    2 B T H k; backward, the model's count, 8 B T C H + 4 B T H k) and the
    bytes of every input read once and every output written once (x, the
    parameters, y; x, dy, the parameters, dx and the f32 gradients)."""
    size = torch.tensor([], dtype=dtype).element_size()
    c, h, k = TCN_C, TCN_H, TCN_K
    rows = batch * SPEX_T
    stream = rows * c * size
    params = (2 * c * h + k * h) * size + (batch * h + 5 * h + c + 2) * 4
    forward = _bound(4 * rows * c * h + 2 * rows * h * k,
                     2 * stream + params + batch * 16, dtype)
    grads = (2 * c * h + k * h + batch * h + 5 * h + c + 2) * 4
    backward = _bound(8 * rows * c * h + 4 * rows * h * k,
                      3 * stream + params + batch * 16 + grads, dtype)
    return forward, backward


def rel_l2(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-20)).item()


def tcn_limits(dtype):
    """Limits of the fused block against its plain version.

    y: f32 1e-4 of the largest magnitude (the products and the gLN sums
    run in another order); bf16 4 units in the last place at the largest
    magnitude (q is rounded to bf16, and a sum that differs in its last
    bit flips such a rounding). Gradients: among tens of millions of PReLU
    inputs a few lie within an f32 rounding of zero, where kernel and
    plain version take different branches; one such flip moves one element
    of dv or ds by (1 - slope) of its size, which no sum order can avoid.
    So a gradient is held to a relative L2 error of 2e-3 (f32) or 2e-2
    (bf16: dv, ds and dn0 are rounded) and to a largest error of 5e-2 of
    its largest magnitude."""
    if dtype == torch.float32:
        return {"y": 1e-4, "grad_l2": 2e-3, "grad_max": 5e-2}
    return {"y": None, "grad_l2": 2e-2, "grad_max": 5e-2}


def tcn_products_library_ms(batch, dtype):
    """The fused block's products alone, as torch.matmul calls at its
    shapes and dtype (f32 with TF32 off): forward x @ W1 and (g1w w) @ W2;
    backward the five of its VJP, s = x @ W1 recomputed, dn1 = dy @ W2^T,
    dW2 = n1^T @ dy, dx = ds @ W1^T, dW1 = x^T @ ds. The least time a
    library takes for the products only, not for the block."""
    gen = torch.Generator().manual_seed(SEED + 40)
    rows = batch * SPEX_T
    r = lambda *shape: (torch.randn(*shape, generator=gen) * 0.1).cuda() \
        .to(dtype)  # noqa: E731
    x, dy = r(rows, TCN_C), r(rows, TCN_C)
    wide, ds = r(rows, TCN_H), r(rows, TCN_H)
    w1, w2 = r(TCN_C, TCN_H), r(TCN_H, TCN_C)
    fwd = time_ms(lambda: (torch.matmul(x, w1), torch.matmul(wide, w2)), 2,
                  10)
    bwd = time_ms(lambda: (torch.matmul(x, w1), torch.matmul(dy, w2.t()),
                           torch.matmul(wide.t(), dy),
                           torch.matmul(ds, w1.t()), torch.matmul(x.t(), ds)),
                  2, 10)
    return fwd, bwd


def check_tcn(name, batch, dtype, dilation):
    """K4 and K4b against their plain versions at one SpEx+ shape; their
    times, each launch's time (CUDA events between launches) and the time
    of their products alone in torch.matmul."""
    from wesep_tpu_torch.ops import cuda_tcn as k

    args, dy = tcn_args(batch, dtype)
    conf = (dilation, TCN_K, False, 1e-5)
    limits = tcn_limits(dtype)
    y, stats = k._forward_cuda(*args, *conf)
    torch.cuda.synchronize()
    ref_y, ref_stats = k.tcn_block_gln_reference(*args, *conf,
                                                 return_stats=True)
    err_y = (y.float() - ref_y.float()).abs().max().item()
    tol_y = tolerance(ref_y) if limits["y"] is None else \
        limits["y"] * ref_y.float().abs().max().item()
    err_stats = rel_err(stats, ref_stats)
    y_again, _ = k._forward_cuda(*args, *conf)
    torch.cuda.synchronize()
    fwd_same_bits = torch.equal(y, y_again)
    del y_again
    # the backward from the plain forward's statistics, so that only the
    # adjoint differs
    grads = k.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
    torch.cuda.synchronize()
    again = k.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = k.tcn_block_gln_backward_reference(*args, ref_stats, dy, *conf)
    l2 = {n: rel_l2(g, w) for n, g, w in zip(TCN_GRADS, grads, ref)}
    mx = {n: rel_err(g, w) for n, g, w in zip(TCN_GRADS, grads, ref)}
    err_dx = (grads[0].float() - ref[0].float()).abs().max().item()
    del again, ref

    fwd_ms = time_ms(lambda: k._forward_cuda(*args, *conf), 2, 10)
    bwd_ms = time_ms(
        lambda: k.tcn_block_gln_backward(*args, ref_stats, dy, *conf), 2, 10)
    fwd_launch_ms = k.launch_times(
        lambda ev: k._forward_cuda(*args, *conf, events=ev),
        k.FORWARD_LAUNCHES)
    bwd_launch_ms = k.launch_times(
        lambda ev: k.tcn_block_gln_backward(*args, ref_stats, dy, *conf,
                                            events=ev),
        k.BACKWARD_LAUNCHES)
    fwd_plain_ms = time_ms(
        lambda: k.tcn_block_gln_reference(*args, *conf), 1, 5)
    bwd_plain_ms = time_ms(lambda: k.tcn_block_gln_backward_reference(
        *args, ref_stats, dy, *conf), 1, 5)
    fwd_products_ms, bwd_products_ms = tcn_products_library_ms(batch, dtype)
    (f_ms, f_by), (b_ms, b_by) = tcn_bounds(batch, dtype)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "B": batch, "T": SPEX_T, "C": TCN_C, "H": TCN_H, "k": TCN_K,
        "dilation": dilation, "limits": limits,
        "forward": {"max_abs_err": err_y, "tolerance": tol_y,
                    "stats_rel_err": err_stats,
                    "same_bits_twice": fwd_same_bits, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "library_ms": None,
                    "products_library_ms": fwd_products_ms,
                    "bound_ms": f_ms, "bound_by": f_by,
                    "launches_ms": fwd_launch_ms},
        "backward": {"max_abs_err": err_dx, "rel_l2": l2, "rel_max": mx,
                     "same_bits_twice": same_bits, "ms": bwd_ms,
                     "plain_ms": bwd_plain_ms, "library_ms": None,
                     "products_library_ms": bwd_products_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches_ms": bwd_launch_ms},
    }
    log("kernel tcn_block_gln", json.dumps(case))
    ok = (err_y <= tol_y and err_stats <= 1e-4 and same_bits
          and fwd_same_bits
          and all(v <= limits["grad_l2"] for v in l2.values())
          and all(v <= limits["grad_max"] for v in mx.values())
          and all(torch.isfinite(t).all() for t in (y, *grads)))
    if not ok:
        raise AssertionError(f"tcn_block_gln disagrees at {case}")
    return case


def check_large_grids():
    """K4/K4b and K5/K5b past one grid dimension, f32, against their plain
    versions: K4 at B = 65537 (two slices of the batch) and at B = 1 with a
    T of more than 65535 element-wise chunks (the grid-stride loop), K5 at
    B = 65537; narrow widths (C = H = 8, Ci = Co = 8). Limits as
    tcn_limits and conv_limits give them for f32."""
    from wesep_tpu_torch.ops import cuda_conv2d, cuda_tcn

    gen = torch.Generator().manual_seed(SEED + 30)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    cases = []
    for name, batch, t_len in (("tcn_batch_65537", 65537, 16),
                               ("tcn_t_65536_chunks", 1, 65536 * 128 + 5)):
        c, h, k = 8, 8, 3
        args = [r(batch, t_len, c) * 0.5, r(batch, h) * 0.1, r(c, h) * 0.2,
                torch.tensor([0.25]), r(k, h) * 0.3, r(h) * 0.1,
                torch.rand(h, generator=gen) + 0.5, r(h) * 0.2,
                torch.tensor([0.2]), r(h, c) * 0.2, r(c) * 0.1,
                torch.rand(h, generator=gen) + 0.5, r(h) * 0.2]
        args = [a.cuda() for a in args]
        dy = (r(batch, t_len, c) * 0.1).cuda()
        conf = (2, k, False, 1e-5)
        y, stats = cuda_tcn._forward_cuda(*args, *conf)
        ref_y, ref_stats = cuda_tcn.tcn_block_gln_reference(
            *args, *conf, return_stats=True)
        grads = cuda_tcn.tcn_block_gln_backward(*args, ref_stats, dy, *conf)
        ref = cuda_tcn.tcn_block_gln_backward_reference(*args, ref_stats, dy,
                                                        *conf)
        cases.append({"shape": name, "B": batch, "T": t_len, "C": c, "H": h,
                      "y_rel_err": rel_err(y, ref_y),
                      "stats_rel_err": rel_err(stats, ref_stats),
                      "grad_rel_l2": {n: rel_l2(g, w) for n, g, w in
                                      zip(TCN_GRADS, grads, ref)},
                      "grad_rel_max": {n: rel_err(g, w) for n, g, w in
                                       zip(TCN_GRADS, grads, ref)},
                      "limits": tcn_limits(torch.float32)})
        del args, dy, y, ref_y, grads, ref
    x = (r(65537, 4, 4, 8) * 0.5).cuda()
    w = (r(3, 3, 8, 8) * 0.1).cuda()
    b = (r(8) * 0.1).cuda()
    dy = (r(65537, 4, 4, 8) * 0.1).cuda()
    y, stats = cuda_conv2d._forward_cuda(x, w, b, 1e-5)
    ref_y, ref_stats = cuda_conv2d.conv2d_block_in_reference(
        x, w, b, return_stats=True)
    grads = cuda_conv2d.conv2d_block_in_backward(x, w, b, ref_stats, dy)
    ref = cuda_conv2d.conv2d_block_in_backward_reference(x, w, b, ref_stats,
                                                         dy)
    cases.append({"shape": "conv2d_batch_65537", "B": 65537, "T": 4, "F": 4,
                  "Ci": 8, "Co": 8, "y_rel_err": rel_err(y, ref_y),
                  "stats_rel_err": rel_err(stats, ref_stats),
                  "grad_rel_l2": {n: rel_l2(g, w_) for n, g, w_ in
                                  zip(CONV_GRADS, grads, ref)},
                  "grad_rel_max": {n: rel_err(g, w_) for n, g, w_ in
                                   zip(CONV_GRADS, grads, ref)},
                  "limits": conv_limits(torch.float32)})
    log("kernels past one grid dimension", json.dumps(cases))
    for case in cases:
        lim = case["limits"]
        if not (case["y_rel_err"] <= lim["y"]
                and case["stats_rel_err"] <= 1e-4
                and all(v <= lim["grad_l2"]
                        for v in case["grad_rel_l2"].values())
                and all(v <= lim["grad_max"]
                        for v in case["grad_rel_max"].values())):
            raise AssertionError(f"past one grid dimension: {case}")
    return cases


def check_fused_tcn_block(dtype):
    """One speaker-fused block through its module (the embedding folded
    into the per-sample bias): y and the gradients of x, the embedding and
    every parameter, kernels against the plain version of the same
    module."""
    from wesep_tpu_torch.models.convtasnet import FuseTCNBlock

    torch.manual_seed(SEED)
    block = FuseTCNBlock(TCN_C, 256, TCN_H, TCN_K, dilation=1,
                         norm="gLN").cuda()
    gen = torch.Generator().manual_seed(SEED + 4)
    x = (torch.randn(2, SPEX_T, TCN_C, generator=gen) * 0.5).cuda() \
        .to(dtype).requires_grad_()
    emb = torch.randn(2, 256, generator=gen).cuda().to(dtype).requires_grad_()
    dy = (torch.randn(2, SPEX_T, TCN_C, generator=gen) * 0.1).cuda().to(dtype)
    names, params = zip(*block.named_parameters())

    def run():
        y = block(x, emb)
        return y, torch.autograd.grad(y, (x, emb) + params, dy)

    y, grads = run()
    block.plain = True
    try:
        ref_y, ref = run()
    finally:
        block.plain = False
    limits = tcn_limits(dtype)
    err_y = (y.float() - ref_y.float()).abs().max().item()
    tol_y = tolerance(ref_y) if limits["y"] is None else \
        limits["y"] * ref_y.float().abs().max().item()
    l2 = {n: rel_l2(g, w)
          for n, g, w in zip(("x", "embed") + names, grads, ref)}
    case = {"shape": "fused_block", "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err_y, "tolerance": tol_y, "grad_rel_l2": l2}
    log("kernel tcn_block_gln through FuseTCNBlock", json.dumps(case))
    if not (err_y <= tol_y
            and all(v <= limits["grad_l2"] for v in l2.values())):
        raise AssertionError(f"fused TCN block disagrees: {case}")
    return case


def write_enrollments(root, rng, name, paths, keys):
    """6 s enrollment wavs for the shard `name` (one per mixture and
    target), with the utt -> wav scp, spk2enroll.json and a single.utt2spk,
    as the v2 recipe lays them out."""
    from wesep_tpu_torch.data.wav_io import write_wav

    n = int(ENROLL_SECONDS * 16000)
    os.makedirs(os.path.join(root, f"{name}_enroll"), exist_ok=True)
    spk2enroll, utt2wav = {}, {}
    for key in keys:
        for spk in (1, 2):
            utt = f"{key}_enr{spk}"
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(90, 250)
            wav = 0.1 * sum(np.sin(2 * np.pi * f0 * h * t) / h
                            for h in range(1, 6))
            wav = wav + 0.02 * rng.standard_normal(n)
            path = os.path.join(root, f"{name}_enroll", utt + ".wav")
            write_wav(path, wav.astype(np.float32), 16000)
            utt2wav[utt] = path
            spk2enroll[f"{key}_s{spk}"] = [[utt, path]]
    paths["spk2utt"] = os.path.join(root, f"{name}_enroll_wav.scp")
    with open(paths["spk2utt"], "w") as f:
        f.writelines(f"{u} {p}\n" for u, p in utt2wav.items())
    paths["spk2enroll"] = os.path.join(root, f"{name}_spk2enroll.json")
    with open(paths["spk2enroll"], "w") as f:
        json.dump(spk2enroll, f)
    return paths


def enroll_shard(root, rng, name, seconds):
    """A shard with 6 s enrollment wavs, as the v2 recipes lay it out."""
    paths, lengths = write_shard(root, rng, name, seconds)
    keys = [f"{name}{i:02d}" for i in range(len(lengths))]
    return write_enrollments(root, rng, name, paths, keys), lengths


def tcn_blocks(model):
    from wesep_tpu_torch.models.convtasnet import FuseTCNBlock, TCNBlock

    return [m for m in model.modules()
            if isinstance(m, (TCNBlock, FuseTCNBlock))]


def set_plain(blocks, plain):
    for m in blocks:
        m.plain = plain


def serve_spex(root):
    """Phase 6: SpEx+ through bin/infer on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.convtasnet import ConvTasNet
    from wesep_tpu_torch.ops.cuda_tcn import tcn_block_gln
    from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

    rng = np.random.default_rng(SEED + 5)
    paths, lengths = enroll_shard(root, rng, "spextest", SHARD_SECONDS)
    torch.manual_seed(SEED)
    model = ConvTasNet(**SPEX_MODEL_ARGS)
    ckpt = os.path.join(root, "spex_avg_model.pt")
    params, buffers = split_state(model)
    save_checkpoint(ckpt, [params], batch_stats=[buffers])
    config = {
        "model": {"tse_model": "ConvTasNet"},
        "model_args": {"tse_model": dict(SPEX_MODEL_ARGS)},
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "exp_dir": os.path.join(root, "exp_spex"),
        "checkpoint": ckpt, "length_bucket": BUCKET,
        "infer_batch_size": ROWS_PER_STEP, "device": "cuda",
        "test_data": paths["data"], "test_spk2utt": paths["spk2utt"],
        "test_spk1_enroll": paths["spk1_enroll"],
        "test_spk2_enroll": paths["spk2_enroll"],
    }
    steps = forward_steps(lengths)
    tcn_block_gln.launches = 0
    t0 = time.perf_counter()
    avg_sisnr, avg_sisnri = infer(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tcn_block_gln.launches
    audio_s = 2 * sum(lengths) / 16000.0
    log(f"serve SpEx+: {2 * len(lengths)} requests in {steps} forward steps, "
        f"{wall:.3f} s wall, RTF {wall / audio_s:.5f}, avg SI-SNR "
        f"{avg_sisnr:.3f} dB, avg SI-SNRi {avg_sisnri:.3f} dB (random "
        "weights: shows the chain ran, not quality)")
    log(f"serve SpEx+: tcn_block_gln launches {launches} (expected "
        f"{SPEX_BLOCKS} x {steps})")
    if launches != SPEX_BLOCKS * steps:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{SPEX_BLOCKS * steps}")
    if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
        raise AssertionError("non-finite SI-SNR from infer")
    audio = os.path.join(root, "exp_spex", "audio")
    wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
    if len(wavs) != 2 * len(lengths):
        raise AssertionError(f"{len(wavs)} outputs for {2 * len(lengths)} "
                             "requests")
    for name, n in zip(wavs[::2], lengths):
        wav, _ = read_wav(os.path.join(audio, name))
        if wav.shape != (1, n) or not np.isfinite(wav).all():
            raise AssertionError(f"bad output {name}: {wav.shape}")

    # kernel forward against the plain blocks' forward of the same model
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(SEED + 6)
    mix = (torch.randn(ROWS_PER_STEP, CHUNK, generator=gen) * 0.1).cuda()
    enr = (torch.randn(ROWS_PER_STEP, int(ENROLL_SECONDS * 16000),
                       generator=gen) * 0.1).cuda()
    blocks = tcn_blocks(model)
    with torch.inference_mode():
        before = tcn_block_gln.launches
        ests = model(mix, enr)[0]
        per_forward = tcn_block_gln.launches - before
        step_ms = time_ms(lambda: model(mix, enr), warmup=1, runs=5)
        set_plain(blocks, True)
        try:
            ests_plain = model(mix, enr)[0]
            plain_step_ms = time_ms(lambda: model(mix, enr), 1, 3)
        finally:
            set_plain(blocks, False)
    if per_forward != SPEX_BLOCKS or len(blocks) != SPEX_BLOCKS:
        raise AssertionError(f"{per_forward} launches in one forward of "
                             f"{len(blocks)} blocks, expected {SPEX_BLOCKS}")
    if len(ests) != 3 or any(e.shape != mix.shape
                             or not torch.isfinite(e).all() for e in ests):
        raise AssertionError("kernel forward is not finite / wrong shape")
    rel = max(rel_l2(a, b) for a, b in zip(ests, ests_plain))
    log(f"serve SpEx+: forward [2 x 3 s] {step_ms:.3f} ms/step with the "
        f"kernel, {plain_step_ms:.3f} ms/step with the plain blocks; "
        f"{2 * 3.0 / (step_ms / 1e3):.1f} audio-s/s, RTF "
        f"{step_ms / 1e3 / 6.0:.5f}; kernel vs plain rel L2 {rel:.3e} "
        "(limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"kernel forward differs from plain: {rel}")
    return launches, {
        "requests": 2 * len(lengths), "steps": steps, "wall_s": wall,
        "rtf_wall": wall / audio_s, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms, "rel_l2_vs_plain": rel,
        "avg_sisnri": avg_sisnri,
    }


def spex_param_grads(model, batch, criterion, table):
    """Gradients of the recipe's loss w.r.t. every parameter, by name."""
    from wesep_tpu_torch.train.trainer import weighted_loss

    names, params = zip(*model.named_parameters())
    loss = weighted_loss(
        model(batch["wav_mix"], batch["spk_embeds"]), batch["wav_targets"],
        batch["spk_label"], criterion, table["loss_posi"],
        table["loss_weight"], multi_task=True)
    return dict(zip(names, torch.autograd.grad(loss, params)))


def train_spex(root):
    """Phase 7: SpEx+ through bin/train on the card."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.convtasnet import ConvTasNet
    from wesep_tpu_torch.ops import cuda_tcn as k
    from wesep_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
        split_state,
    )
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 7)
    tr, _ = enroll_shard(root, rng, "spextrain", [4.0] * (2 * TRAIN_BATCH))
    va, va_lengths = enroll_shard(root, rng, "spexdev", [3.5] * TRAIN_BATCH)
    torch.manual_seed(SEED)
    init = ConvTasNet(**SPEX_MODEL_ARGS)
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "spex_init.ckpt")
    params, buffers = split_state(init)
    save_checkpoint(init_path, [params], batch_stats=[buffers])
    table = {"loss_posi": [[0, 1, 2], [3]],
             "loss_weight": [[0.8, 0.1, 0.1], [0.5]]}
    # the values of examples/librimix/tse/v2/confs/spexplus.yaml; one epoch
    # of SPEX_TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_spex_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_utt2spk": tr["utt2spk"],
        "train_spk2utt": tr["spk2enroll"],
        "val_data": va["data"], "val_spk2utt": va["spk2utt"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                            "prefetch_factor": 6},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch":
                             SPEX_TRAIN_STEPS * TRAIN_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": CHUNK, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": ["SISDR", "CE"], "loss_args": table,
        "model": {"tse_model": "ConvTasNet"},
        "model_args": {"tse_model": dict(SPEX_MODEL_ARGS)},
        "model_init": {"tse_model": init_path},
        "num_avg": 2, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }
    counters = (k.tcn_block_gln, k.tcn_block_gln_backward)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    val_steps = 1  # 16 validation enrollments / 2 / batch_size 8
    expected = [SPEX_BLOCKS * (SPEX_TRAIN_STEPS + val_steps),
                SPEX_BLOCKS * SPEX_TRAIN_STEPS]
    log(f"train SpEx+: {SPEX_TRAIN_STEPS} steps + {val_steps} validation "
        f"step through bin/train in {wall:.3f} s wall; launches forward / "
        f"backward {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    log(f"train SpEx+: running mean loss per step {losses}, epoch {epoch}")
    if len(losses) != SPEX_TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    if state.step != SPEX_TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates, expected "
                             f"{SPEX_TRAIN_STEPS}")
    moved = {n: (v.detach().cpu().float() - init_state[n]).abs().max().item()
             for n, v in state.model.state_dict().items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(
            "parameters or BatchNorm statistics that did not change: "
            f"{[n for n, v in moved.items() if v == 0]}")
    n_stats = len(dict(state.model.named_buffers()))
    models = os.path.join(config["exp_dir"], "models")
    ckpt = os.path.join(models, "checkpoint_1.ckpt")
    bundle = load_checkpoint(ckpt)
    if not (bundle["step"] == SPEX_TRAIN_STEPS
            and bundle["opt_states"][0]["count"] == SPEX_TRAIN_STEPS
            and len(bundle["batch_stats"][0]) == n_stats == 12):
        raise AssertionError("checkpoint_1.ckpt lacks optimizer state, step "
                             "or BatchNorm statistics")
    del state
    # bin/infer decodes from the checkpoint bin/train wrote
    sisnr, _ = infer({
        "model": config["model"], "model_args": config["model_args"],
        "data_type": "shard", "dataset_args": config["dataset_args"],
        "exp_dir": os.path.join(root, "exp_spex_ckpt"), "checkpoint": ckpt,
        "save_wav": False, "device": "cuda", "length_bucket": BUCKET,
        "test_data": va["data"], "test_spk2utt": va["spk2utt"],
        "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    if not math.isfinite(sisnr):
        raise AssertionError("bin/infer from the trained checkpoint: "
                             "non-finite SI-SNR")
    log(f"train SpEx+: bin/infer decoded {2 * len(va_lengths)} requests from "
        f"checkpoint_1.ckpt, avg SI-SNR {sisnr:.3f} dB")

    # gradients through the kernels against gradients through the plain
    # blocks: f32, 2 rows x 3 s, relative L2 per parameter (limit 5e-3:
    # the sums run in another order, and a PReLU input within rounding of
    # zero may take the other branch, see tcn_limits; through 32 blocks
    # and over only 2 x 4799 rows one such flip weighs more in a depthwise
    # tap's gradient than in the single block's check). The three decoder
    # biases are left out: they shift an estimate by a constant, which the
    # zero-mean SI-SDR does not see, so their gradient is rounding noise.
    criterion = parse_loss(["SISDR", "CE"])
    gen = torch.Generator().manual_seed(SEED + 8)
    model = ConvTasNet(**SPEX_MODEL_ARGS)
    model.load_state_dict(init_state)
    model = model.cuda().train()
    blocks = tcn_blocks(model)

    def make_batch(rows):
        return {
            "wav_mix": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
            "wav_targets":
                (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
            "spk_embeds": (torch.randn(
                rows, int(ENROLL_SECONDS * 16000), generator=gen) * 0.1)
            .cuda(),
            "spk_label": torch.randint(0, 251, (rows,), generator=gen).cuda(),
        }

    small = make_batch(2)
    got = spex_param_grads(model, small, criterion, table)
    set_plain(blocks, True)
    want = spex_param_grads(model, small, criterion, table)
    set_plain(blocks, False)
    # A PReLU slope's gradient is one number, sum(dw * min(v, 0)) over
    # millions of terms that nearly cancel (the gLN adjoint makes dw
    # orthogonal to 1 and to the normalised w), 1e-5 of the whole
    # gradient's norm here: its own size is no scale for its error, so
    # the slopes are held to 1e-5 of the whole gradient's norm instead.
    skipped = re.compile(r"dec_\d\.ConvTranspose_0\.bias")
    total = torch.cat([g.flatten() for g in want.values()]).norm().item()
    rel = {n: rel_l2(got[n], want[n]) for n in want
           if not skipped.fullmatch(n) and not n.endswith(".alpha")}
    slopes = {n: (got[n] - want[n]).norm().item() / total for n in want
              if n.endswith(".alpha")}
    worst = max(rel, key=rel.get)
    worst_slope = max(slopes, key=slopes.get)
    log(f"train SpEx+: gradients of {len(rel)} parameters, kernels vs plain "
        f"blocks (f32): worst relative L2 {rel[worst]:.3e} at {worst} "
        f"(limit 5e-3); {len(slopes)} PReLU slopes: worst error "
        f"{slopes[worst_slope]:.3e} of the whole gradient's norm at "
        f"{worst_slope} (limit 1e-5)")
    if not (rel[worst] <= 5e-3 and slopes[worst_slope] <= 1e-5):
        raise AssertionError(
            f"gradients differ: {worst} {rel[worst]}, {worst_slope} "
            f"{slopes[worst_slope]}")
    del got, want

    # time and peak memory of one train step at the recipe's size
    rows = 2 * TRAIN_BATCH
    batch = make_batch(rows)
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(criterion, table["loss_posi"],
                           table["loss_weight"], multi_task=True,
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    set_plain(blocks, True)
    torch.cuda.reset_peak_memory_stats()
    plain_step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=2)
    plain_peak = torch.cuda.max_memory_allocated()
    set_plain(blocks, False)
    audio = rows * CHUNK / 16000.0
    log(f"train SpEx+: step [16 rows x 3 s, bf16] {step_ms:.3f} ms with the "
        f"kernels (peak memory {peak / 2 ** 30:.2f} GiB), "
        f"{plain_step_ms:.3f} ms with the plain blocks (peak "
        f"{plain_peak / 2 ** 30:.2f} GiB); "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s")
    return dict(zip(("tcn_block_gln", "tcn_block_gln_backward"), launches)), {
        "steps": SPEX_TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms,
        "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "plain_peak_memory_bytes": plain_peak,
        "grad_rel_l2_worst": rel[worst],
        "slope_grad_err_worst": slopes[worst_slope],
    }


def grid_weights(d, gen):
    """Seeded f32 weights of one TF-GridNet BiLSTM layer in the kernels'
    order (wx_f, b_f, wh_f, wx_b, b_b, wh_b), torch LSTM-scale."""
    h, scale = GRID_H, 1.0 / math.sqrt(GRID_H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    return (u(d, 4 * h), u(4 * h), u(h, 4 * h),
            u(d, 4 * h), u(4 * h), u(h, 4 * h))


def cudnn_lstm(weights, dtype):
    """cuDNN's bidirectional LSTM holding the kernels' weights (the time
    yardstick; the port never calls it)."""
    wx = weights[0]
    lstm = torch.nn.LSTM(wx.shape[0], GRID_H, batch_first=True,
                         bidirectional=True).cuda()
    with torch.no_grad():
        for sfx, (w_x, b, w_h) in (("", weights[:3]),
                                   ("_reverse", weights[3:])):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w_x.t())
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w_h.t())
            getattr(lstm, "bias_ih_l0" + sfx).copy_(b)
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def check_unfold_kernels(name, rows, length, dtype, ks=GRID_KS, hs=1):
    """The unfold-fused BiLSTM layer (K3 forward, K3b's two backward
    kernels) against its plain versions at one TF-GridNet shape: x [B', L,
    48], H 192, unfold(ks, hs), f32 parameters.

    Limits as for the plain layer: ys within 1e-4 (f32) or 4 bf16 units in
    the last place; dx, dW and db within 1e-4 (f32) or 2e-2 (bf16) of the
    plain version's largest magnitude (dgates and dh are rounded to bf16
    every step and each direction's frame cotangent before the two are
    added and folded, and a sum that differs in its last bit flips such a
    rounding now and then); the weight-gradient kernel within 1e-4 of the
    plain product on the same dgates. The weight and bias gradients must
    repeat bit for bit. The yardstick is cuDNN's LSTM with the same
    weights over the materialised frames (checked against the plain
    version in f32)."""
    from wesep_tpu_torch.ops import cuda_lstm_unfold as k

    h, d = GRID_H, ks * GRID_C
    frames = (length - ks) // hs + 1
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(rows, length, GRID_C, generator=gen).cuda().to(dtype)
    weights = grid_weights(d, gen)
    dys = (torch.randn(rows, frames, 2 * h, generator=gen) * 0.1).cuda() \
        .to(dtype)
    args = (x, *weights)
    limit = 1e-4 if dtype == torch.float32 else 2e-2

    # the serving forward (no cell states), then the training forward
    y = k.bilstm_layer_unfold(*args, ks, hs)
    ys, cs = k._forward_cuda(*args, ks, hs, with_cs=True)
    torch.cuda.synchronize()
    ref_ys, ref_cs = k.bilstm_layer_unfold_reference(*args, ks, hs,
                                                     return_cs=True)
    tol = tolerance(ref_ys)
    err_y = (y.float() - ref_ys.float()).abs().max().item()
    err_y_train = (ys.float() - ref_ys.float()).abs().max().item()
    err_c = rel_err(cs, ref_cs)
    lstm = cudnn_lstm(weights, dtype)
    u = k.unfold_frames(x, ks, hs).contiguous()
    with torch.inference_mode():
        err_lib = rel_err(lstm(u)[0], ref_ys)
    ms = time_ms(lambda: k.bilstm_layer_unfold(*args, ks, hs))
    fwd_cs_ms = time_ms(lambda: k._forward_cuda(*args, ks, hs, with_cs=True),
                        1, 5)
    plain_ms = time_ms(lambda: k.bilstm_layer_unfold_reference(*args, ks, hs),
                       1, 2)
    with torch.inference_mode():
        library_ms = time_ms(lambda: lstm(u), 1, 5)

    # the backward kernels, from the plain forward's saved tensors so that
    # only the adjoint differs
    du, db, dg = k.bilstm_layer_unfold_backward(*args, ref_ys, ref_cs, dys,
                                                ks, hs)
    dw = k.bilstm_layer_unfold_wgrad(x, ref_ys, dg, ks, hs)
    dx = k.fold_frames(du, ks, hs, length)
    torch.cuda.synchronize()
    ref = k.bilstm_layer_unfold_backward_reference(*args, ref_ys, ref_cs, dys,
                                                   ks, hs)
    ref_dw = torch.stack([torch.cat([ref[1], ref[3]]),
                          torch.cat([ref[4], ref[6]])])
    ref_db = torch.stack([ref[2], ref[5]])
    errs = {"dx": rel_err(dx, ref[0]), "db": rel_err(db, ref_db),
            "dwx": rel_err(dw[:, :d], ref_dw[:, :d]),
            "dwh": rel_err(dw[:, d:], ref_dw[:, d:])}
    err_wgrad = rel_err(dw, k.bilstm_layer_unfold_wgrad_reference(
        x, ref_ys, dg, ks, hs))
    du2, db2, dg2 = k.bilstm_layer_unfold_backward(*args, ref_ys, ref_cs,
                                                   dys, ks, hs)
    repeats = (torch.equal(du, du2) and torch.equal(db, db2)
               and torch.equal(dw, k.bilstm_layer_unfold_wgrad(
                   x, ref_ys, dg2, ks, hs)))
    del du2, db2, dg2
    bwd_ms = time_ms(lambda: k.bilstm_layer_unfold_backward(
        *args, ref_ys, ref_cs, dys, ks, hs), 1, 5)
    wgrad_ms = time_ms(lambda: k.bilstm_layer_unfold_wgrad(
        x, ref_ys, dg, ks, hs), 1, 5)
    bwd_plain_ms = time_ms(lambda: k.bilstm_layer_unfold_backward_reference(
        *args, ref_ys, ref_cs, dys, ks, hs), 0, 1)
    wgrad_plain_ms = time_ms(lambda: k.bilstm_layer_unfold_wgrad_reference(
        x, ref_ys, dg, ks, hs), 1, 3)
    # cuDNN's backward over the materialised frames: the backward call, and
    # forward + backward
    ug = u.clone().requires_grad_()
    lib_params = list(lstm.parameters())
    lib_y = lstm(ug)[0]
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_y, [ug] + lib_params, dys, retain_graph=True), 1, 5)
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lstm(ug)[0], [ug] + lib_params, dys), 1, 5)
    del lib_y
    # and one batched cuBLAS product over both directions for dW over the
    # materialised frames
    lib_wgrad_ms, lib_apart_ms = library_wgrad_ms(
        [torch.cat([u, ref_ys[..., i * h:(i + 1) * h]], dim=-1)
         .reshape(-1, d + h) for i in (0, 1)], dg)

    x_elems = rows * length * GRID_C
    bound = bilstm_bound(frames, rows, dtype, d, h, x_elems=x_elems)
    (f_ms, f_by), (s_ms, s_by), (w_ms, w_by) = backward_bounds(
        frames, rows, dtype, d, h, x_elems=x_elems)
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "B": rows, "L": length, "C": GRID_C, "ks": ks, "hs": hs,
        "T": frames, "H": h, "rel_limit": limit,
        "forward": {"max_abs_err": err_y, "tolerance": tol,
                    "kernels": forward_kernels(dtype, d, h, rows * frames,
                                               c=GRID_C),
                    "max_abs_err_with_cs": err_y_train, "cs_rel_err": err_c,
                    "rel_err_cudnn_vs_plain": err_lib, "ms": ms,
                    "with_cs_ms": fwd_cs_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "with_cs_bound_ms": f_ms},
        "backward": {"rel_err": {n: errs[n] for n in ("dx", "db")},
                     "max_abs_err": (dx.float() - ref[0].float()).abs()
                     .max().item(),
                     "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                     "library_ms": lib_bwd_ms,
                     "library_fwd_bwd_ms": lib_fwd_bwd_ms,
                     "bound_ms": s_ms, "bound_by": s_by,
                     "repeats_bit_for_bit": repeats},
        "wgrad": {"rel_err": {"dwx": errs["dwx"], "dwh": errs["dwh"],
                              "vs_plain_product": err_wgrad},
                  "max_abs_err": (dw - ref_dw).abs().max().item(),
                  "ms": wgrad_ms, "plain_ms": wgrad_plain_ms,
                  "library_ms": lib_wgrad_ms,
                  "library_per_direction_ms": lib_apart_ms, "bound_ms": w_ms,
                  "bound_by": w_by},
    }
    log("kernels unfold-fused", json.dumps(case))
    cs_limit = limit if dtype == torch.float32 else 5e-2
    ok = (err_y <= tol and err_y_train <= tol and err_c <= cs_limit
          and all(e <= limit for e in errs.values()) and err_wgrad <= 1e-4
          and repeats
          and all(torch.isfinite(t).all() for t in (y, ys, cs, dx, db, dw)))
    if dtype == torch.float32:
        ok = ok and err_lib <= 1e-4
    if not ok:
        raise AssertionError(f"unfold-fused kernels disagree: {case}")
    return case


def grid_lstms(model):
    from wesep_tpu_torch.models.common import LSTM

    return [m for m in model.modules() if isinstance(m, LSTM)]


def set_route(unfold):
    """The JAX package's switch: WESEP_LSTM_UNFOLD=1 takes the unfold-fused
    layer (K3/K3b), anything else unfold + the plain layer (K0/K0b)."""
    if unfold:
        os.environ["WESEP_LSTM_UNFOLD"] = "1"
    else:
        os.environ.pop("WESEP_LSTM_UNFOLD", None)


# every LSTM route's wrappers: forward, serial adjoint, weight gradients
LSTM_ROUTES = {
    "layer": ("bilstm_layer", "bilstm_layer_backward", "bilstm_layer_wgrad"),
    "unfold": ("bilstm_layer_unfold", "bilstm_layer_unfold_backward",
               "bilstm_layer_unfold_wgrad"),
    "two_kernel": ("bilstm_fused_forward", "bilstm_fused_backward",
                   "bilstm_fused_wgrad"),
    "unidirectional": ("lstm_fused_forward", "lstm_fused_backward",
                       "lstm_fused_wgrad"),
}


def lstm_counters():
    """Every LSTM wrapper's counter: K0, K0b x2, K3, K3b x2, K2, K2b x2,
    K1, K1b x2, the tensor-core forward's two kernels, the tensor-core
    backward's four, the f32 cluster forward's two and the f32 backward's
    four."""
    from wesep_tpu_torch.ops import cuda_lstm as k0
    from wesep_tpu_torch.ops import cuda_lstm_f32 as f32
    from wesep_tpu_torch.ops import cuda_lstm_fused as k12
    from wesep_tpu_torch.ops import cuda_lstm_tc as tc
    from wesep_tpu_torch.ops import cuda_lstm_unfold as k3

    counters = {name: getattr(module, name)
                for module, route in ((k0, "layer"), (k3, "unfold"),
                                      (k12, "two_kernel"),
                                      (k12, "unidirectional"))
                for name in LSTM_ROUTES[route]}
    counters.update({name: getattr(tc, name)
                     for name in TC_NAMES + TC_FORWARD_NAMES})
    counters.update({name: getattr(f32, name)
                     for name in F32_FORWARD_NAMES + F32_BACKWARD_NAMES})
    return counters


def zero_counts():
    for fn in lstm_counters().values():
        fn.launches = 0


def read_counts():
    return {n: fn.launches for n, fn in lstm_counters().items()}


def expect_counts(got, forward, backward, route, what, f32=False,
                  f32_forward=0):
    """Launch counts of a run: `forward` layer forwards and `backward`
    layer backwards on the LSTM route taken, none of any other LSTM
    wrapper. In bf16, at shapes the tensor-core route gates take (every
    bf16 run here), a forward is one launch of the forward chain, and of
    the projection on the layers that project x (K0, K3), and none of the
    route's own forward kernel; a backward one launch each of the gate
    product, the adjoint chain and the dW product, and of the dx product on
    K0 and K3. In f32 (`f32`: serving, the joint v2 recipes' train steps
    and the f32 gradient checks), at shapes cuda_lstm_f32.f32_forward_fits
    and f32_backward_fits take (every f32 run here), a forward is one
    launch of the f32 cluster chain, and of the f32 projection on K0 and
    K3, and none of the route's own forward kernel; a backward one launch
    each of the f32 gates, adjoint chain and dW, and of the f32 dx on K0
    and K3, and none of the route's own backward kernels; `f32_forward`
    counts the f32 forwards of a bf16 run (bin/train's validation
    step)."""
    want = dict.fromkeys(got, 0)
    projects = route in ("layer", "unfold")
    f32_forwards = forward if f32 else f32_forward
    want.update(lstm_f32_forward_chain=f32_forwards,
                lstm_f32_project=f32_forwards if projects else 0)
    if f32:
        want.update(lstm_f32_gates=backward, lstm_f32_adjoint_chain=backward,
                    lstm_f32_wgrad=backward,
                    lstm_f32_dx=backward if projects else 0)
    else:
        want.update(lstm_forward_chain=forward,
                    lstm_project=forward if projects else 0,
                    lstm_gates=backward, lstm_adjoint_chain=backward,
                    lstm_wgrad=backward,
                    lstm_dx=backward if projects else 0)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def serve_tfgridnet(root):
    """Phase 8: TF-GridNet through bin/infer on the card, on both routes."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.tfgridnet import TFGridNet
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + 9)
    paths, lengths = write_shard(root, rng, "gridtest", SHARD_SECONDS)
    data = {f"test_{k}": v for k, v in paths.items() if k != "utt2spk"}
    torch.manual_seed(SEED)
    model = TFGridNet(**GRID_MODEL_ARGS)
    ckpt = os.path.join(root, "grid_avg_model.pt")
    save_checkpoint(ckpt, [model.state_dict()])
    steps = forward_steps(lengths)
    audio_s = 2 * sum(lengths) / 16000.0
    gen = torch.Generator().manual_seed(SEED + 10)
    mix = (torch.randn(ROWS_PER_STEP, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(ROWS_PER_STEP, 256, generator=gen).cuda()
    cuda_model = TFGridNet(**GRID_MODEL_ARGS)
    cuda_model.load_state_dict(model.state_dict())
    cuda_model = cuda_model.cuda().eval()
    lstms = grid_lstms(cuda_model)
    routes = {}
    try:
        for unfold in (True, False):
            route = "unfold" if unfold else "default"
            set_route(unfold)
            exp_dir = os.path.join(root, f"exp_grid_{route}")
            config = {
                "model": {"tse_model": "TFGridNet"},
                "model_args": {"tse_model": dict(GRID_MODEL_ARGS)},
                "data_type": "shard",
                "dataset_args": {"resample_rate": 16000},
                "exp_dir": exp_dir, "checkpoint": ckpt,
                "length_bucket": BUCKET, "infer_batch_size": ROWS_PER_STEP,
                "device": "cuda", **data,
            }
            zero_counts()
            t0 = time.perf_counter()
            avg_sisnr, avg_sisnri = infer(config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            log(f"serve TF-GridNet ({route} route): {2 * len(lengths)} "
                f"requests in {steps} forward steps, {wall:.3f} s wall, RTF "
                f"{wall / audio_s:.5f}, avg SI-SNR {avg_sisnr:.3f} dB, avg "
                f"SI-SNRi {avg_sisnri:.3f} dB (random weights: shows the "
                f"chain ran, not quality); launches {launches}")
            expect_counts(launches, GRID_RNNS * steps, 0,
                          "unfold" if unfold else "layer",
                          f"serve TF-GridNet ({route})", f32=True)
            if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
                raise AssertionError("non-finite SI-SNR from infer")
            audio = os.path.join(exp_dir, "audio")
            wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
            if len(wavs) != 2 * len(lengths):
                raise AssertionError(f"{len(wavs)} outputs for "
                                     f"{2 * len(lengths)} requests")
            for name, n in zip(wavs[::2], lengths):
                wav, _ = read_wav(os.path.join(audio, name))
                if wav.shape != (1, n) or not np.isfinite(wav).all():
                    raise AssertionError(f"bad output {name}: {wav.shape}")

            # kernel forward against the plain versions' forward, f32
            with torch.inference_mode():
                zero_counts()
                est = cuda_model(mix, emb)[0]
                per_forward = read_counts()
                step_ms = time_ms(lambda: cuda_model(mix, emb), 1, 5)
                set_plain(lstms, True)
                try:
                    est_plain = cuda_model(mix, emb)[0]
                    plain_step_ms = time_ms(lambda: cuda_model(mix, emb), 0, 1)
                finally:
                    set_plain(lstms, False)
            expect_counts(per_forward, GRID_RNNS, 0,
                          "unfold" if unfold else "layer",
                          f"one TF-GridNet forward ({route})", f32=True)
            if not torch.isfinite(est).all() or est.shape != mix.shape:
                raise AssertionError("kernel forward is not finite / wrong "
                                     "shape")
            rel = rel_l2(est, est_plain)
            log(f"serve TF-GridNet ({route} route): forward [2 x 3 s] "
                f"{step_ms:.3f} ms/step with the kernels, "
                f"{plain_step_ms:.3f} ms/step with the plain versions; "
                f"{2 * 3.0 / (step_ms / 1e3):.1f} audio-s/s, RTF "
                f"{step_ms / 1e3 / 6.0:.5f}; kernels vs plain rel L2 "
                f"{rel:.3e} (limit 1e-3)")
            if not rel <= 1e-3:
                raise AssertionError(f"kernel forward differs from plain: "
                                     f"{rel}")
            routes[route] = {
                "launches": launches, "wall_s": wall,
                "rtf_wall": wall / audio_s, "step_ms": step_ms,
                "plain_step_ms": plain_step_ms,
                "audio_s_per_s": 2 * 3.0 / (step_ms / 1e3),
                "rtf": step_ms / 1e3 / 6.0, "rel_l2_vs_plain": rel,
                "avg_sisnri": avg_sisnri}
    finally:
        set_route(False)
    return {"requests": 2 * len(lengths), "steps": steps, **routes}


def train_tfgridnet(root):
    """Phase 9: TF-GridNet through bin/train on the card, unfold-fused
    route."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.tfgridnet import TFGridNet
    from wesep_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 11)
    tr, _ = write_shard(root, rng, "gridtrain", [2.0] * (2 * GRID_BATCH))
    va, va_lengths = write_shard(root, rng, "griddev", [1.5] * GRID_BATCH)
    torch.manual_seed(SEED)
    init = TFGridNet(**GRID_MODEL_ARGS)
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "grid_init.ckpt")
    save_checkpoint(init_path, [init.state_dict()])
    # the values of examples/librimix/tse/v1/confs/tfgridnet.yaml; one
    # epoch of GRID_TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_grid_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": GRID_BATCH, "drop_last": True,
                            "prefetch_factor": 4},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch":
                             GRID_TRAIN_STEPS * GRID_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": GRID_CHUNK, "speaker_feat": False},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "TFGridNet"},
        "model_args": {"tse_model": dict(GRID_MODEL_ARGS)},
        "model_init": {"tse_model": init_path},
        "num_avg": 2, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }
    val_steps = 1  # 8 validation enrollments / 2 / batch_size 4
    try:
        set_route(True)
        zero_counts()
        t0 = time.perf_counter()
        state = train(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        log(f"train TF-GridNet: {GRID_TRAIN_STEPS} steps + {val_steps} "
            f"validation step through bin/train in {wall:.3f} s wall; "
            f"launches {launches}")
        expect_counts(launches, GRID_RNNS * GRID_TRAIN_STEPS,
                      GRID_RNNS * GRID_TRAIN_STEPS, "unfold",
                      "train TF-GridNet", f32_forward=GRID_RNNS * val_steps)
        with open(os.path.join(config["exp_dir"], "train.log")) as f:
            text = f.read()
        losses = rows_loss(text)
        epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
        log(f"train TF-GridNet: running mean loss per step {losses}, epoch "
            f"{epoch}")
        if len(losses) != GRID_TRAIN_STEPS or len(epoch) != 1 or not all(
                math.isfinite(v)
                for v in losses + [float(e) for e in epoch[0]]):
            raise AssertionError("missing or non-finite training losses")
        if state.step != GRID_TRAIN_STEPS:
            raise AssertionError(f"{state.step} updates, expected "
                                 f"{GRID_TRAIN_STEPS}")
        moved = {n: (p.detach().cpu() - init_state[n]).abs().max().item()
                 for n, p in state.model.named_parameters()}
        still = [n for n, v in moved.items()
                 if v == 0 and not n.endswith(GRID_NOISE_ONLY)]
        if still:
            raise AssertionError(f"parameters that did not change: {still}")
        models = os.path.join(config["exp_dir"], "models")
        ckpt = os.path.join(models, "checkpoint_1.ckpt")
        bundle = load_checkpoint(ckpt)
        if not (bundle["step"] == GRID_TRAIN_STEPS
                and bundle["opt_states"][0]["count"] == GRID_TRAIN_STEPS
                and set(bundle["opt_states"][0]["mu"]) == set(moved)):
            raise AssertionError("checkpoint_1.ckpt lacks optimizer state or "
                                 "step")
        del state
        # bin/infer decodes from the checkpoint bin/train wrote
        sisnr, _ = infer({
            "model": config["model"], "model_args": config["model_args"],
            "data_type": "shard", "dataset_args": {"resample_rate": 16000},
            "exp_dir": os.path.join(root, "exp_grid_ckpt"),
            "checkpoint": ckpt, "save_wav": False, "device": "cuda",
            "length_bucket": BUCKET,
            "test_data": va["data"], "test_spk_embeds": va["spk_embeds"],
            "test_spk1_enroll": va["spk1_enroll"],
            "test_spk2_enroll": va["spk2_enroll"]})
        if not math.isfinite(sisnr):
            raise AssertionError("bin/infer from the trained checkpoint: "
                                 "non-finite SI-SNR")
        log(f"train TF-GridNet: bin/infer decoded {2 * len(va_lengths)} "
            f"requests from checkpoint_1.ckpt, avg SI-SNR {sisnr:.3f} dB")

        # gradients through the kernels against gradients through the
        # plain versions: f32, 2 rows x 1 s, relative L2 per parameter
        # (limit 5e-3, as for SpEx+: the sums run in another order, and an
        # attention PReLU input within rounding of zero may take the other
        # branch; the biases just before those PReLUs read 5e-4 to 1e-3
        # from one machine to another); the GRID_NOISE_ONLY leaves, whose
        # true gradient is zero, are held to 1e-5 of the whole gradient's
        # norm instead
        gen = torch.Generator().manual_seed(SEED + 12)
        model = TFGridNet(**GRID_MODEL_ARGS)
        model.load_state_dict(init_state)
        model = model.cuda().train()
        lstms = grid_lstms(model)
        mix = (torch.randn(2, GRID_CHUNK, generator=gen) * 0.1).cuda()
        target = (torch.randn(2, GRID_CHUNK, generator=gen) * 0.1).cuda()
        emb = torch.randn(2, 256, generator=gen).cuda()
        zero_counts()
        got = param_grads(model, mix, emb, target)
        f32_counts = read_counts()
        expect_counts(f32_counts, GRID_RNNS, GRID_RNNS, "unfold",
                      "TF-GridNet f32 gradients", f32=True)
        set_plain(lstms, True)
        want = param_grads(model, mix, emb, target)
        set_plain(lstms, False)
        total = torch.cat([g.flatten() for g in want.values()]).norm().item()
        rel = {n: rel_l2(got[n], want[n]) for n in want
               if not n.endswith(GRID_NOISE_ONLY)}
        noise = {n: (got[n] - want[n]).norm().item() / total for n in want
                 if n.endswith(GRID_NOISE_ONLY)}
        worst = max(rel, key=rel.get)
        worst_noise = max(noise, key=noise.get)
        log(f"train TF-GridNet: gradients of {len(rel)} parameters, kernels "
            f"vs plain (f32): worst relative L2 {rel[worst]:.3e} at {worst} "
            f"(limit 5e-3); {len(noise)} noise-only leaves: worst error "
            f"{noise[worst_noise]:.3e} of the whole gradient's norm at "
            f"{worst_noise} (limit 1e-5)")
        if not (rel[worst] <= 5e-3 and noise[worst_noise] <= 1e-5):
            raise AssertionError(f"gradients differ: {worst} {rel[worst]}, "
                                 f"{worst_noise} {noise[worst_noise]}")
        del got, want

        # time and peak memory of one train step at the recipe's size, on
        # each route, and with the plain versions
        rows = 2 * GRID_BATCH
        batch = {
            "wav_mix": (torch.randn(rows, GRID_CHUNK, generator=gen) * 0.1)
            .cuda(),
            "wav_targets": (torch.randn(rows, GRID_CHUNK, generator=gen)
                            * 0.1).cuda(),
            "spk_embeds": torch.randn(rows, 256, generator=gen).cuda(),
        }
        opt = make_optimizer(model, exponential_decrease(
            num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
            warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
        tstate = TrainState(model=model, optimizer=opt)
        step = make_train_step(parse_loss("SISDR"),
                               compute_dtype=torch.bfloat16)
        timed = {}
        for unfold in (True, False):
            route = "unfold" if unfold else "default"
            set_route(unfold)
            zero_counts()
            step(tstate, batch)
            torch.cuda.synchronize()
            per_step = read_counts()
            log(f"train TF-GridNet: launches of one train step ({route} "
                f"route) { {n: v for n, v in per_step.items() if v} }")
            expect_counts(per_step, GRID_RNNS, GRID_RNNS,
                          "unfold" if unfold else "layer",
                          f"one TF-GridNet train step ({route})")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step_ms = time_ms(lambda: step(tstate, batch), 1, 5)
            timed[route] = {"step_ms": step_ms,
                            "peak_memory_bytes":
                                torch.cuda.max_memory_allocated()}
        set_route(True)
        set_plain(lstms, True)
        plain_step_ms = time_ms(lambda: step(tstate, batch), 0, 1)
        set_plain(lstms, False)
    finally:
        set_route(False)
    audio = rows * GRID_CHUNK / 16000.0
    for route, t in timed.items():
        t["audio_s_per_s"] = audio / (t["step_ms"] / 1e3)
        log(f"train TF-GridNet ({route} route): step [8 rows x 1 s, bf16] "
            f"{t['step_ms']:.3f} ms, {t['audio_s_per_s']:.1f} audio-s/s, "
            f"peak memory {t['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"train TF-GridNet: step with the plain versions (unfold route) "
        f"{plain_step_ms:.3f} ms")
    return {"main": launches, "f32_grads": f32_counts}, {
        "steps": GRID_TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "plain_step_ms": plain_step_ms,
        "grad_rel_l2_worst": rel[worst],
        "noise_only_grad_err_worst": noise[worst_noise], **timed,
    }


CONV_GRADS = ("dx", "dK", "db")


def conv_bounds(batch, f, ci, co, dtype):
    """Least times of the fused Conv2dBlock on the card, forward and
    backward: the conv's 2 * 9 * Ci * Co operations per output (the
    backward's two products, dx and dK, twice that; the recompute of e is
    not needed work) and the bytes of every input read once and every
    output written once (x, K, the bias, y, the statistics; x, dy, K, the
    bias, the statistics, dx and the f32 dK and db)."""
    size = torch.tensor([], dtype=dtype).element_size()
    pos = batch * CONV_T * f
    ops = 2 * 9 * ci * co * pos
    small = 9 * ci * co * size + co * 4 + batch * 2 * co * 4
    forward = _bound(ops, pos * (ci + co) * size + small, dtype)
    backward = _bound(2 * ops, pos * (2 * ci + co) * size + small
                      + (9 * ci * co + co) * 4, dtype)
    return forward, backward


def conv_limits(dtype):
    """Limits of the fused block against its plain version. y: f32 1e-4 of
    the largest magnitude (the conv and the statistics sum in another
    order); bf16 4 units in the last place at the largest magnitude (y is
    rounded once from an f32 value that may differ in its last bits).
    Gradients, by relative L2: f32 1e-3; bf16 2e-2 (dout is rounded to
    bf16, and a sum that differs in its last bit flips such a rounding now
    and then); largest error 5e-2 of the largest magnitude."""
    if dtype == torch.float32:
        return {"y": 1e-4, "grad_l2": 1e-3, "grad_max": 5e-2}
    return {"y": None, "grad_l2": 2e-2, "grad_max": 5e-2}


def xla_route_ms(x, w, b, dy):
    """The yardstick of K5/K5b: DPCCN's "xla" Conv2dBlock (cuDNN's conv,
    ELU, instance_norm; TF32 off for f32) at the same shape, dtype and
    weights -> (forward alone, forward + autograd backward to x, K and the
    bias) ms."""
    from wesep_tpu_torch.models.dpccn import Conv2dBlock

    block = Conv2dBlock(x.shape[-1], w.shape[-1], conv_impl="xla").cuda()
    with torch.no_grad():
        block.conv.kernel.copy_(w)
        block.conv.bias.copy_(b)
    leaf = x.detach().clone().requires_grad_()
    params = (leaf, block.conv.kernel, block.conv.bias)
    with torch.no_grad():
        forward = time_ms(lambda: block(x), 2, 10)
    both = time_ms(lambda: torch.autograd.grad(block(leaf), params, dy), 2,
                   10)
    return forward, both


def cudnn_backward_ms(x, w, dy):
    """cuDNN's conv backward alone (dx and dK of the 3x3 conv,
    torch.nn.grad.conv2d_input + conv2d_weight), a note beside K5b: it
    leaves out the recompute of e, ELU, the norm's adjoint and db."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.to(x.dtype).permute(3, 2, 0, 1)
    dyn = dy.permute(0, 3, 1, 2)
    return time_ms(lambda: (
        torch.nn.grad.conv2d_input(xn.shape, wn, dyn, padding=1),
        torch.nn.grad.conv2d_weight(xn, wn.shape, dyn, padding=1)), 2, 10)


def check_conv2d(name, f, ci, co, batch, dtype):
    """K5 and K5b against their plain versions at one DPCCN shape; their
    times, each launch's time (CUDA events between launches), DPCCN's "xla"
    Conv2dBlock at the same shape (`xla_route_ms`) and cuDNN's conv alone,
    forward and backward, as notes."""
    from torch.nn import functional as F

    from wesep_tpu_torch.ops import cuda_conv2d as k
    from wesep_tpu_torch.ops.cuda_tcn import launch_times

    gen = torch.Generator().manual_seed(SEED)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    x = (r(batch, CONV_T, f, ci) * 0.5).cuda().to(dtype)
    w = (r(3, 3, ci, co) * 0.1).cuda()
    b = (r(co) * 0.1).cuda()
    dy = (r(batch, CONV_T, f, co) * 0.1).cuda().to(dtype)
    limits = conv_limits(dtype)
    y, stats = k._forward_cuda(x, w, b, 1e-5)
    torch.cuda.synchronize()
    ref_y, ref_stats = k.conv2d_block_in_reference(x, w, b,
                                                   return_stats=True)
    err_y = (y.float() - ref_y.float()).abs().max().item()
    tol_y = tolerance(ref_y) if limits["y"] is None else \
        limits["y"] * ref_y.float().abs().max().item()
    err_stats = rel_err(stats, ref_stats)
    y_again, stats_again = k._forward_cuda(x, w, b, 1e-5)
    torch.cuda.synchronize()
    fwd_same_bits = torch.equal(y, y_again) and torch.equal(stats,
                                                            stats_again)
    del y_again, stats_again
    # the backward from the plain forward's statistics, so that only the
    # adjoint differs
    grads = k.conv2d_block_in_backward(x, w, b, ref_stats, dy)
    torch.cuda.synchronize()
    again = k.conv2d_block_in_backward(x, w, b, ref_stats, dy)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, c) for a, c in zip(grads, again))
    ref = k.conv2d_block_in_backward_reference(x, w, b, ref_stats, dy)
    l2 = {n: rel_l2(g, want) for n, g, want in zip(CONV_GRADS, grads, ref)}
    mx = {n: rel_err(g, want) for n, g, want in zip(CONV_GRADS, grads, ref)}
    err_dx = (grads[0].float() - ref[0].float()).abs().max().item()
    del again, ref

    fwd_ms = time_ms(lambda: k._forward_cuda(x, w, b, 1e-5), 2, 10)
    bwd_ms = time_ms(
        lambda: k.conv2d_block_in_backward(x, w, b, ref_stats, dy), 2, 10)
    fwd_host_ms = host_ms(lambda: k._forward_cuda(x, w, b, 1e-5))
    bwd_host_ms = host_ms(
        lambda: k.conv2d_block_in_backward(x, w, b, ref_stats, dy))
    fwd_launch_ms = launch_times(
        lambda ev: k._forward_cuda(x, w, b, 1e-5, events=ev),
        k.FORWARD_LAUNCHES[dtype])
    bwd_launch_ms = launch_times(
        lambda ev: k.conv2d_block_in_backward(x, w, b, ref_stats, dy,
                                              events=ev),
        k.BACKWARD_LAUNCHES[dtype])
    fwd_plain_ms = time_ms(lambda: k.conv2d_block_in_reference(x, w, b), 1, 5)
    bwd_plain_ms = time_ms(lambda: k.conv2d_block_in_backward_reference(
        x, w, b, ref_stats, dy), 1, 5)
    # notes, not yardsticks: no single PyTorch call computes conv -> ELU
    # -> instance norm or its backward; these are cuDNN's conv alone on the
    # same input, forward and backward, and the "xla" route's whole block
    xn, wn = x.permute(0, 3, 1, 2), w.to(dtype).permute(3, 2, 0, 1)
    cudnn_conv_ms = time_ms(lambda: F.conv2d(xn, wn, b.to(dtype), padding=1))
    cudnn_bwd_ms = cudnn_backward_ms(x, w, dy)
    xla_fwd_ms, xla_both_ms = xla_route_ms(x, w, b, dy)
    (f_ms, f_by), (b_ms, b_by) = conv_bounds(batch, f, ci, co, dtype)
    dk_blocks = k.backward_plan(batch, CONV_T, f, ci, co, dtype,
                                k._slots(ci, co, dtype, x.device))[0]
    case = {
        "shape": name, "dtype": str(dtype).replace("torch.", ""),
        "B": batch, "T": CONV_T, "F": f, "Ci": ci, "Co": co,
        "limits": limits, "dk_blocks": dk_blocks,
        "xla_route_ms": {"forward": xla_fwd_ms,
                         "forward_backward": xla_both_ms},
        "forward": {"max_abs_err": err_y, "tolerance": tol_y,
                    "stats_rel_err": err_stats,
                    "same_bits_twice": fwd_same_bits, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "library_ms": None,
                    "cudnn_conv_only_ms": cudnn_conv_ms,
                    "host_ms": fwd_host_ms,
                    "bound_ms": f_ms, "bound_by": f_by,
                    "launches_ms": fwd_launch_ms},
        "backward": {"max_abs_err": err_dx, "rel_l2": l2, "rel_max": mx,
                     "same_bits_twice": same_bits, "ms": bwd_ms,
                     "host_ms": bwd_host_ms,
                     "plain_ms": bwd_plain_ms, "library_ms": None,
                     "cudnn_conv_backward_only_ms": cudnn_bwd_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches_ms": bwd_launch_ms},
    }
    log("kernel conv2d_block_in", json.dumps(case))
    ok = (err_y <= tol_y and err_stats <= 1e-4 and same_bits
          and fwd_same_bits
          and all(v <= limits["grad_l2"] for v in l2.values())
          and all(v <= limits["grad_max"] for v in mx.values())
          and all(torch.isfinite(t).all() for t in (y, *grads)))
    if not ok:
        raise AssertionError(f"conv2d_block_in disagrees at {case}")
    return case


def conv_counters():
    from wesep_tpu_torch.ops import cuda_conv2d as k

    return {"conv2d_block_in": k.conv2d_block_in,
            "conv2d_block_in_backward": k.conv2d_block_in_backward}


def zero_conv_counts():
    for fn in conv_counters().values():
        fn.launches = 0


def read_conv_counts():
    return {n: fn.launches for n, fn in conv_counters().items()}


def conv_blocks(model):
    from wesep_tpu_torch.models.dpccn import Conv2dBlock

    return [m for m in model.modules() if isinstance(m, Conv2dBlock)]


def dpccn_model(conv_impl, state):
    from wesep_tpu_torch.models.dpccn import DPCCN

    model = DPCCN(**DPCCN_MODEL_ARGS, conv_impl=conv_impl)
    model.load_state_dict(state)
    return model.cuda()


def serve_dpccn(root):
    """Phase 10: DPCCN through bin/infer on the card, on both routes."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.dpccn import DPCCN
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + 13)
    paths, lengths = write_shard(root, rng, "dpccntest", SHARD_SECONDS)
    data = {f"test_{k}": v for k, v in paths.items() if k != "utt2spk"}
    torch.manual_seed(SEED)
    state = DPCCN(**DPCCN_MODEL_ARGS).state_dict()
    ckpt = os.path.join(root, "dpccn_avg_model.pt")
    save_checkpoint(ckpt, [state])
    steps = forward_steps(lengths)
    audio_s = 2 * sum(lengths) / 16000.0
    gen = torch.Generator().manual_seed(SEED + 14)
    mix = (torch.randn(ROWS_PER_STEP, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(ROWS_PER_STEP, 256, generator=gen).cuda()
    routes, ests = {}, {}
    for route in ("pallas", "xla"):
        exp_dir = os.path.join(root, f"exp_dpccn_{route}")
        config = {
            "model": {"tse_model": "DPCCN"},
            "model_args": {"tse_model": dict(DPCCN_MODEL_ARGS,
                                             conv_impl=route)},
            "data_type": "shard",
            "dataset_args": {"resample_rate": 16000},
            "exp_dir": exp_dir, "checkpoint": ckpt,
            "length_bucket": BUCKET, "infer_batch_size": ROWS_PER_STEP,
            "device": "cuda", **data,
        }
        fused = DPCCN_FUSED if route == "pallas" else 0
        zero_conv_counts()
        t0 = time.perf_counter()
        avg_sisnr, avg_sisnri = infer(config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_conv_counts()
        log(f"serve DPCCN ({route} route): {2 * len(lengths)} requests in "
            f"{steps} forward steps, {wall:.3f} s wall, RTF "
            f"{wall / audio_s:.5f}, avg SI-SNR {avg_sisnr:.3f} dB, avg "
            f"SI-SNRi {avg_sisnri:.3f} dB (random weights: shows the chain "
            f"ran, not quality); launches {launches}")
        want = {"conv2d_block_in": fused * steps,
                "conv2d_block_in_backward": 0}
        if launches != want:
            raise AssertionError(f"serve DPCCN ({route}): launches "
                                 f"{launches}, expected {want}")
        if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
            raise AssertionError("non-finite SI-SNR from infer")
        audio = os.path.join(exp_dir, "audio")
        wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
        if len(wavs) != 2 * len(lengths):
            raise AssertionError(f"{len(wavs)} outputs for "
                                 f"{2 * len(lengths)} requests")
        for name, n in zip(wavs[::2], lengths):
            wav, _ = read_wav(os.path.join(audio, name))
            if wav.shape != (1, n) or not np.isfinite(wav).all():
                raise AssertionError(f"bad output {name}: {wav.shape}")

        # one forward of the model on this route, f32
        model = dpccn_model(route, state).eval()
        with torch.inference_mode():
            zero_conv_counts()
            est = model(mix, emb)[0]
            per_forward = read_conv_counts()["conv2d_block_in"]
            step_ms = time_ms(lambda: model(mix, emb), 1, 5)
            enqueue_ms = host_ms(lambda: model(mix, emb), 3)
        if per_forward != fused:
            raise AssertionError(f"{per_forward} launches in one DPCCN "
                                 f"forward ({route}), expected {fused}")
        if not torch.isfinite(est).all() or est.shape != mix.shape:
            raise AssertionError("DPCCN forward is not finite / wrong shape")
        ests[route] = est
        routes[route] = {
            "launches": launches, "wall_s": wall, "rtf_wall": wall / audio_s,
            "step_ms": step_ms, "enqueue_ms": enqueue_ms,
            "audio_s_per_s": 2 * 3.0 / (step_ms / 1e3),
            "rtf": step_ms / 1e3 / 6.0, "avg_sisnri": avg_sisnri}
        if route == "pallas":
            # the kernels against their plain versions in the same model
            set_plain(conv_blocks(model), True)
            with torch.inference_mode():
                est_plain = model(mix, emb)[0]
                plain_step_ms = time_ms(lambda: model(mix, emb), 0, 2)
            set_plain(conv_blocks(model), False)
            routes[route].update(plain_step_ms=plain_step_ms,
                                 rel_l2_vs_plain=rel_l2(est, est_plain))
        del model
    rel = rel_l2(ests["pallas"], ests["xla"])
    for route, t in routes.items():
        log(f"serve DPCCN ({route} route): forward [2 x 3 s] "
            f"{t['step_ms']:.3f} ms/step ({t['enqueue_ms']:.3f} ms to "
            f"enqueue on the host), {t['audio_s_per_s']:.1f} audio-s/s, RTF "
            f"{t['rtf']:.5f}")
    log(f"serve DPCCN: plain versions {routes['pallas']['plain_step_ms']:.3f} "
        f"ms/step; kernels vs plain rel L2 "
        f"{routes['pallas']['rel_l2_vs_plain']:.3e}, pallas vs xla route rel "
        f"L2 {rel:.3e} (limits 1e-3: the same f32 arithmetic in another "
        "order, ELU through exp - 1 against expm1)")
    if not (routes["pallas"]["rel_l2_vs_plain"] <= 1e-3 and rel <= 1e-3):
        raise AssertionError(f"DPCCN routes differ: {routes}, {rel}")
    return {"requests": 2 * len(lengths), "steps": steps,
            "rel_l2_pallas_vs_xla": rel, **routes}


def train_dpccn(root):
    """Phase 11: DPCCN through bin/train on the card, conv_impl "pallas"."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.dpccn import DPCCN
    from wesep_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(SEED + 15)
    tr, _ = write_shard(root, rng, "dpccntrain", [4.0] * (2 * DPCCN_BATCH))
    va, va_lengths = write_shard(root, rng, "dpccndev", [3.5] * DPCCN_BATCH)
    torch.manual_seed(SEED)
    init_state = {n: v.clone()
                  for n, v in DPCCN(**DPCCN_MODEL_ARGS).state_dict().items()}
    init_path = os.path.join(root, "dpccn_init.ckpt")
    save_checkpoint(init_path, [init_state])
    model_args = dict(DPCCN_MODEL_ARGS, conv_impl="pallas")
    # the values of examples/librimix/tse/v1/confs/dpccn.yaml; one epoch of
    # DPCCN_TRAIN_STEPS batches on the synthetic shards
    config = {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_dpccn_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
        "train_utt2spk": tr["utt2spk"],
        "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": DPCCN_BATCH, "drop_last": True,
                            "prefetch_factor": 4},
        "dataset_args": {"resample_rate": 16000,
                         "sample_num_per_epoch":
                             DPCCN_TRAIN_STEPS * DPCCN_BATCH,
                         "shuffle": True,
                         "shuffle_args": {"shuffle_size": 2500},
                         "chunk_len": CHUNK, "speaker_feat": False},
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "DPCCN"},
        "model_args": {"tse_model": model_args},
        "model_init": {"tse_model": init_path},
        "num_avg": 5, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": DPCCN_CLIP, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }
    val_steps = 1  # 8 validation enrollments / 2 / batch_size 4
    zero_conv_counts()
    t0 = time.perf_counter()
    state = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_conv_counts()
    want = {"conv2d_block_in": DPCCN_FUSED * (DPCCN_TRAIN_STEPS + val_steps),
            "conv2d_block_in_backward": DPCCN_FUSED * DPCCN_TRAIN_STEPS}
    log(f"train DPCCN: {DPCCN_TRAIN_STEPS} steps + {val_steps} validation "
        f"step through bin/train in {wall:.3f} s wall; launches {launches} "
        f"(expected {want})")
    if launches != want:
        raise AssertionError(f"train DPCCN: launches {launches}, expected "
                             f"{want}")
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    log(f"train DPCCN: running mean loss per step {losses}, epoch {epoch}")
    if len(losses) != DPCCN_TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    if state.step != DPCCN_TRAIN_STEPS:
        raise AssertionError(f"{state.step} updates, expected "
                             f"{DPCCN_TRAIN_STEPS}")
    moved = {n: (p.detach().cpu() - init_state[n]).abs().max().item()
             for n, p in state.model.named_parameters()}
    still = [n for n, v in moved.items()
             if v == 0 and not n.endswith(DPCCN_NOISE_ONLY)]
    if still:
        raise AssertionError(f"parameters that did not change: {still}")
    ckpt = os.path.join(config["exp_dir"], "models", "checkpoint_1.ckpt")
    bundle = load_checkpoint(ckpt)
    if not (bundle["step"] == DPCCN_TRAIN_STEPS
            and bundle["opt_states"][0]["count"] == DPCCN_TRAIN_STEPS
            and set(bundle["opt_states"][0]["mu"]) == set(moved)):
        raise AssertionError("checkpoint_1.ckpt lacks optimizer state or "
                             "step")
    del state
    # bin/infer decodes from the checkpoint bin/train wrote
    sisnr, _ = infer({
        "model": config["model"], "model_args": config["model_args"],
        "data_type": "shard", "dataset_args": {"resample_rate": 16000},
        "exp_dir": os.path.join(root, "exp_dpccn_ckpt"),
        "checkpoint": ckpt, "save_wav": False, "device": "cuda",
        "length_bucket": BUCKET,
        "test_data": va["data"], "test_spk_embeds": va["spk_embeds"],
        "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    if not math.isfinite(sisnr):
        raise AssertionError("bin/infer from the trained checkpoint: "
                             "non-finite SI-SNR")
    log(f"train DPCCN: bin/infer decoded {2 * len(va_lengths)} requests "
        f"from checkpoint_1.ckpt, avg SI-SNR {sisnr:.3f} dB")

    # gradients through the kernels against gradients through the plain
    # versions: f32, 2 rows x 3 s, relative L2 per parameter (limit 1e-3:
    # only the sum order differs, and ELU' is continuous at 0, so no branch
    # flip moves an element); the noise-only and near-cancelling leaves
    # (DPCCN_NOISE_ONLY, DPCCN_NEAR_CANCELLING) are held to 1e-5 of the
    # whole gradient's norm instead
    gen = torch.Generator().manual_seed(SEED + 16)
    model = dpccn_model("pallas", init_state).train()
    blocks = conv_blocks(model)
    mix = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    target = (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda()
    emb = torch.randn(2, 256, generator=gen).cuda()
    got = param_grads(model, mix, emb, target)
    set_plain(blocks, True)
    want = param_grads(model, mix, emb, target)
    set_plain(blocks, False)
    total = torch.cat([g.flatten() for g in want.values()]).norm().item()
    weak = DPCCN_NOISE_ONLY + DPCCN_NEAR_CANCELLING
    rel = {n: rel_l2(got[n], want[n]) for n in want if not n.endswith(weak)}
    noise = {n: (got[n] - want[n]).norm().item() / total for n in want
             if n.endswith(weak)}
    worst = max(rel, key=rel.get)
    worst_noise = max(noise, key=noise.get)
    log(f"train DPCCN: gradients of {len(rel)} parameters, kernels vs plain "
        f"(f32): worst relative L2 {rel[worst]:.3e} at {worst} (limit "
        f"1e-3); {len(noise)} noise-only and near-cancelling leaves: worst "
        f"error {noise[worst_noise]:.3e} of the whole gradient's norm at "
        f"{worst_noise} (limit 1e-5)")
    if not (rel[worst] <= 1e-3 and noise[worst_noise] <= 1e-5):
        raise AssertionError(f"gradients differ: {worst} {rel[worst]}, "
                             f"{worst_noise} {noise[worst_noise]}")
    del got, want

    # time and peak memory of one train step at the recipe's size, on each
    # route, and with the plain versions
    rows = 2 * DPCCN_BATCH
    batch = {
        "wav_mix": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "wav_targets": (torch.randn(rows, CHUNK, generator=gen) * 0.1).cuda(),
        "spk_embeds": torch.randn(rows, 256, generator=gen).cuda(),
    }
    step = make_train_step(parse_loss("SISDR"), compute_dtype=torch.bfloat16)
    timed = {}
    for route in ("pallas", "xla"):
        model = dpccn_model(route, init_state).train()
        opt = make_optimizer(model, exponential_decrease(
            num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
            warm_up_epoch=0), weight_decay=1e-4, clip_grad=DPCCN_CLIP)
        tstate = TrainState(model=model, optimizer=opt)
        zero_conv_counts()
        step(tstate, batch)
        torch.cuda.synchronize()
        fused = DPCCN_FUSED if route == "pallas" else 0
        if read_conv_counts() != {"conv2d_block_in": fused,
                                  "conv2d_block_in_backward": fused}:
            raise AssertionError(f"one DPCCN train step ({route}): "
                                 f"launches {read_conv_counts()}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(tstate, batch), 1, 5)
        timed[route] = {"step_ms": step_ms,
                        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if route == "pallas":
            set_plain(conv_blocks(model), True)
            plain_step_ms = time_ms(lambda: step(tstate, batch), 0, 2)
            set_plain(conv_blocks(model), False)
        del model, opt, tstate
    audio = rows * CHUNK / 16000.0
    for route, t in timed.items():
        t["audio_s_per_s"] = audio / (t["step_ms"] / 1e3)
        log(f"train DPCCN ({route} route): step [8 rows x 3 s, bf16] "
            f"{t['step_ms']:.3f} ms, {t['audio_s_per_s']:.1f} audio-s/s, "
            f"peak memory {t['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"train DPCCN: step with the plain versions (pallas route) "
        f"{plain_step_ms:.3f} ms")
    return launches, {
        "steps": DPCCN_TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "plain_step_ms": plain_step_ms,
        "grad_rel_l2_worst": rel[worst],
        "noise_only_grad_err_worst": noise[worst_noise], **timed,
    }


# --- the joint v2 models: examples/librimix/tse/v2/confs/{bsrnn,tfgridnet,
# dpccn}.yaml at full width, ResNet34 (m_channels 32) on 80-bin fbank ------


def resnet34():
    """The v2 confs' ResNet34, weights from SEED and its BatchNorm
    statistics seeded too (so that eval mode normalises)."""
    from wesep_tpu_torch.models.speaker import speaker_encoder

    torch.manual_seed(SEED)
    model = speaker_encoder("ResNet34", V2_SPK_ARGS)
    seed_statistics(model)
    return model


def seed_statistics(model, seed=SEED):
    """BatchNorm means ~ N(0, 0.1), variances ~ U(0.5, 1.5), from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(".mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith(".var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)


def voices(rows, samples, gen):
    """Harmonic voices with noise, [rows, samples] f32 on the host."""
    t = torch.arange(samples, dtype=torch.float64) / 16000.0
    f0 = 90 + 160 * torch.rand(rows, 1, generator=gen, dtype=torch.float64)
    s = sum(torch.sin(2 * math.pi * f0 * k * t) / k for k in range(1, 6))
    s = 0.1 * s + 0.02 * torch.randn(rows, samples, generator=gen,
                                     dtype=torch.float64)
    return s.float()


def enroll_fbank(rows, gen):
    """Enrollment cues as the v2 data chain gives them: the Kaldi fbank
    (int16 scale, dither 0) of 6 s wavs after CMVN, [rows, 598, 80]."""
    from wesep_tpu_torch.ops.fbank import apply_cmvn, kaldi_fbank

    wav = voices(rows, int(ENROLL_SECONDS * 16000), gen)
    return apply_cmvn(kaldi_fbank(wav, input_scale=32768.0))


def check_speaker_ops():
    """Phase 14 (a): the speaker branch's ops on the card against the same
    calls on the CPU: Kaldi fbank of 16 estimates of 3 s (the SSA route),
    the consistent frontend of two 6 s enrollments, and ResNet34 on fbank
    [2, 598, 80] in eval mode and [16, 598, 80] in train mode (the updated
    statistics too), with cuDNN's TF32 off (what this script compares in)
    and on (PyTorch's default, which bin/train and bin/infer keep); the
    times of the ops and of ResNet34's forward at 2 rows and forward +
    backward at 16 rows, each with TF32 off and on."""
    from wesep_tpu_torch.ops.fbank import kaldi_fbank, speaker_feat

    gen = torch.Generator().manual_seed(SEED + 20)
    out = {}
    est = voices(2 * TRAIN_BATCH, CHUNK, gen)
    cpu = kaldi_fbank(est, input_scale=32768.0)
    est_card = est.cuda()
    card = kaldi_fbank(est_card, input_scale=32768.0)
    out["kaldi_fbank"] = {
        "shape": list(est.shape), "rel_err": rel_err(card.cpu(), cpu),
        "limit": SPEAKER_OPS_LIMIT,
        "ms": time_ms(lambda: kaldi_fbank(est_card, input_scale=32768.0)),
        "frames": cpu.shape[1]}
    wav = voices(ROWS_PER_STEP, int(ENROLL_SECONDS * 16000), gen)
    cpu = speaker_feat(wav)
    wav_card = wav.cuda()
    err = (speaker_feat(wav_card).cpu() - cpu).abs()
    out["speaker_feat"] = {
        "shape": list(wav.shape), "max_abs_err": err.max().item(),
        "q999_abs_err": torch.quantile(err.flatten(), 0.999).item(),
        "limits": [1e-2, 2e-4],
        "ms": time_ms(lambda: speaker_feat(wav_card))}

    model = resnet34()
    feats = enroll_fbank(2 * TRAIN_BATCH, gen)
    small = feats[:ROWS_PER_STEP]
    with torch.no_grad():
        want = model.eval()(small)
        trained = resnet34().train()
        want_train = trained(feats)
    want_stats = dict(trained.named_buffers())
    model = model.cuda()
    small_card, feats_card = small.cuda(), feats.cuda()
    res = {"rows_eval": ROWS_PER_STEP, "rows_train": 2 * TRAIN_BATCH,
           "frames": ENROLL_FRAMES, "limit_tf32_off": SPEAKER_OPS_LIMIT,
           "limit_tf32_on": SPEAKER_TF32_LIMIT}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        tag = "tf32_on" if tf32 else "tf32_off"
        state = {n: v.clone() for n, v in model.state_dict().items()}
        with torch.no_grad():
            got = model.eval()(small_card)
            got_train = model.train()(feats_card)
        stats = dict(model.named_buffers())
        res[f"eval_rel_l2_{tag}"] = rel_l2(got.cpu(), want)
        res[f"train_rel_l2_{tag}"] = rel_l2(got_train.cpu(), want_train)
        res[f"stats_rel_err_{tag}"] = max(
            rel_err(stats[n].cpu(), w) for n, w in want_stats.items())
        model.load_state_dict(state)
        model.eval()
        with torch.inference_mode():
            res[f"forward_2_rows_ms_{tag}"] = time_ms(
                lambda: model(small_card), 2, 10)
        model.train()

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            model(feats_card).square().mean().backward()

        torch.cuda.reset_peak_memory_stats()
        res[f"fwd_bwd_16_rows_ms_{tag}"] = time_ms(fwd_bwd, 1, 5)
        res[f"fwd_bwd_peak_bytes_{tag}"] = torch.cuda.max_memory_allocated()
        model.load_state_dict(state)
    torch.backends.cudnn.allow_tf32 = False
    flops = RESNET34_FLOPS_PER_ROW
    res["flops_per_row"] = flops
    res["bound_ms_2_rows"] = ROWS_PER_STEP * flops / PEAK_FLOPS[
        torch.float32] * 1e3
    out["resnet34"] = res
    log("speaker ops", json.dumps(out))
    log(f"speaker ops: kaldi_fbank [16 x 3 s] card vs CPU "
        f"{out['kaldi_fbank']['rel_err']:.3e} of the largest (limit "
        f"{SPEAKER_OPS_LIMIT}), {out['kaldi_fbank']['ms']:.3f} ms; "
        f"speaker_feat [2 x 6 s] max {out['speaker_feat']['max_abs_err']:.3e}"
        f" / 99.9 % {out['speaker_feat']['q999_abs_err']:.3e} (limits 1e-2 /"
        f" 2e-4), {out['speaker_feat']['ms']:.3f} ms")
    for tag in ("tf32_off", "tf32_on"):
        log(f"speaker ops: ResNet34 ({tag}) embedding card vs CPU rel L2 "
            f"eval {res['eval_rel_l2_' + tag]:.3e}, train "
            f"{res['train_rel_l2_' + tag]:.3e}, statistics "
            f"{res['stats_rel_err_' + tag]:.3e} (limit "
            f"{res['limit_' + tag]}); forward [2 x 598] "
            f"{res['forward_2_rows_ms_' + tag]:.3f} ms, forward + backward "
            f"[16 x 598] {res['fwd_bwd_16_rows_ms_' + tag]:.3f} ms")
    bad = [k for k in ("eval_rel_l2", "train_rel_l2", "stats_rel_err")
           for tag in ("tf32_off", "tf32_on")
           if not res[f"{k}_{tag}"] <= res[f"limit_{tag}"]]
    sf = out["speaker_feat"]
    if bad or not (out["kaldi_fbank"]["rel_err"] <= SPEAKER_OPS_LIMIT
                   and sf["max_abs_err"] <= 1e-2
                   and sf["q999_abs_err"] <= 2e-4):
        raise AssertionError(f"speaker ops disagree: {bad} {out}")
    return out


def v2_dataset_args(steps):
    """dataset_args of the v2 confs; an epoch of `steps` batches."""
    return {"resample_rate": 16000, "sample_num_per_epoch":
            steps * TRAIN_BATCH, "shuffle": True,
            "shuffle_args": {"shuffle_size": 2500}, "chunk_len": CHUNK,
            "speaker_feat": True, "enroll_sec": ENROLL_SECONDS,
            "fbank_args": dict(V2_FBANK), "noise_prob": 0,
            "specaug_enroll_prob": 0, "reverb_enroll_prob": 0,
            "noise_enroll_prob": 0, "SSA_enroll_prob": 0}


def v2_infer_dataset_args():
    """dataset_args that bin/infer reads of the v2 confs (no shuffle)."""
    return {"resample_rate": 16000, "speaker_feat": True,
            "enroll_sec": ENROLL_SECONDS, "fbank_args": dict(V2_FBANK)}


def v2_bsrnn(seed=SEED):
    from wesep_tpu_torch.models.bsrnn import BSRNN

    torch.manual_seed(seed)
    model = BSRNN(**V2_BSRNN_ARGS)
    seed_statistics(model, seed)
    return model


def save_model(path, model):
    from wesep_tpu_torch.train.checkpoint import save_checkpoint, split_state

    params, buffers = split_state(model)
    save_checkpoint(path, [params], batch_stats=[buffers])


def serve_v2_bsrnn(root):
    """Phase 14 (b): the librimix v2 BSRNN (ResNet34 on fbank) through
    bin/infer on the card: launch counts, outputs, the forward's time, the
    speaker branch's share of it, the kernels against the plain LSTM."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.common import LSTM

    rng = np.random.default_rng(SEED + 21)
    paths, lengths = enroll_shard(root, rng, "v2test", SHARD_SECONDS)
    model = v2_bsrnn()
    ckpt = os.path.join(root, "v2_avg_model.pt")
    save_model(ckpt, model)
    config = {
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V2_BSRNN_ARGS)},
        "data_type": "shard", "dataset_args": v2_infer_dataset_args(),
        "exp_dir": os.path.join(root, "exp_v2"), "checkpoint": ckpt,
        "length_bucket": BUCKET, "infer_batch_size": ROWS_PER_STEP,
        "device": "cuda", "test_data": paths["data"],
        "test_spk2utt": paths["spk2utt"],
        "test_spk1_enroll": paths["spk1_enroll"],
        "test_spk2_enroll": paths["spk2_enroll"],
    }
    tag = "serve v2 BSRNN"
    steps = forward_steps(lengths)
    per_forward = 2 * V2_BSRNN_ARGS["num_repeat"]
    zero_counts()
    t0 = time.perf_counter()
    avg_sisnr, avg_sisnri = infer(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    audio_s = 2 * sum(lengths) / 16000.0
    log(f"{tag}: {2 * len(lengths)} requests in {steps} forward steps, "
        f"{wall:.3f} s wall (fbank on the host included), RTF "
        f"{wall / audio_s:.5f}, avg SI-SNR {avg_sisnr:.3f} dB, avg SI-SNRi "
        f"{avg_sisnri:.3f} dB (random weights); launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected "
        f"{per_forward} x {steps} of the f32 cluster chain and of the f32 "
        "projection)")
    expect_counts(counts, per_forward * steps, 0, "layer", tag, f32=True)
    if not (math.isfinite(avg_sisnr) and math.isfinite(avg_sisnri)):
        raise AssertionError("non-finite SI-SNR from infer")
    audio = os.path.join(root, "exp_v2", "audio")
    wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
    if len(wavs) != 2 * len(lengths):
        raise AssertionError(f"{len(wavs)} outputs for {2 * len(lengths)}")
    for name, n in zip(wavs[::2], lengths):
        wav, _ = read_wav(os.path.join(audio, name))
        if wav.shape != (1, n) or not np.isfinite(wav).all():
            raise AssertionError(f"bad output {name}: {wav.shape}")

    gen = torch.Generator().manual_seed(SEED + 22)
    model = model.cuda().eval()
    mix = voices(ROWS_PER_STEP, CHUNK, gen).cuda()
    enr = enroll_fbank(ROWS_PER_STEP, gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    with torch.inference_mode():
        zero_counts()
        est = model(mix, enr)[0]
        expect_counts(read_counts(), per_forward, 0, "layer",
                      f"{tag}: one forward", f32=True)
        step_ms = time_ms(lambda: model(mix, enr), 2, 10)
        branch_ms = time_ms(lambda: model.spk_model_net(enr), 2, 10)
        # PyTorch's default, which bin/infer keeps: cuDNN convs on TF32
        torch.backends.cudnn.allow_tf32 = True
        tf32_step_ms = time_ms(lambda: model(mix, enr), 2, 10)
        tf32_branch_ms = time_ms(lambda: model.spk_model_net(enr), 2, 10)
        torch.backends.cudnn.allow_tf32 = False
        for m in lstms:
            m.plain = True
        est_plain = model(mix, enr)[0]
        for m in lstms:
            m.plain = False
    rel = rel_l2(est, est_plain)
    if not (torch.isfinite(est).all() and est.dtype == torch.float32
            and rel <= 1e-3):
        raise AssertionError(f"{tag}: kernel forward vs plain {rel}")
    summary = {
        "requests": 2 * len(lengths), "steps": steps, "wall_s": wall,
        "rtf_wall": wall / audio_s, "step_ms": step_ms,
        "audio_s_per_s": 2 * 3.0 / (step_ms / 1e3),
        "rtf": step_ms / 1e3 / 6.0, "speaker_branch_ms": branch_ms,
        "speaker_branch_share": branch_ms / step_ms,
        "tf32_step_ms": tf32_step_ms, "tf32_speaker_branch_ms":
        tf32_branch_ms, "rel_l2_vs_plain": rel, "avg_sisnri": avg_sisnri,
        "launches_per_forward": per_forward,
    }
    log(f"{tag}: forward [2 x 3 s, fbank 2 x 598] {step_ms:.3f} ms/step, "
        f"{summary['audio_s_per_s']:.1f} audio-s/s, RTF "
        f"{summary['rtf']:.5f}; the speaker branch (ResNet34) "
        f"{branch_ms:.3f} ms, {100 * branch_ms / step_ms:.1f} % of it; "
        f"with cuDNN's TF32 (the default) {tf32_step_ms:.3f} ms, the branch "
        f"{tf32_branch_ms:.3f} ms; kernels vs plain LSTM rel L2 {rel:.3e} "
        "(limit 1e-3)")
    return counts, summary


# the f32 LSTM wrappers a joint v2 step runs (the promotion after the fuse)
V2_F32_WRAPPERS = tuple(("cuda_lstm_f32", name) for name in
                        F32_FORWARD_NAMES + F32_BACKWARD_NAMES)


def wrapper_times(fn, wrappers=V2_F32_WRAPPERS):
    """Device ms of each wrapper's calls (its kernels and the small copies
    around them) within one fn(), by CUDA events recorded around each
    call; and the ms of the whole fn()."""
    import importlib

    events = {name: [] for _, name in wrappers}
    saved = []
    for module_name, name in wrappers:
        module = importlib.import_module(f"wesep_tpu_torch.ops.{module_name}")
        real = getattr(module, name)

        def timed(*args, real=real, name=name, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out

        # the wrapper counts its launches on the name it is called by
        timed.launches, timed.__name__ = 0, name
        saved.append((module, name, real))
        setattr(module, name, timed)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    return ({name: sum(s.elapsed_time(e) for s, e in pairs)
             for name, pairs in events.items()}, start.elapsed_time(end))


def v2_batch(rows, gen):
    return {"wav_mix": voices(rows, CHUNK, gen).cuda(),
            "wav_targets": voices(rows, CHUNK, gen).cuda(),
            "spk_embeds": enroll_fbank(rows, gen).cuda()}


def v2_train_config(root, tr, va, init_path, steps):
    """The values of examples/librimix/tse/v2/confs/bsrnn.yaml; an epoch
    of `steps` batches on the synthetic shards."""
    return {
        "device": "cuda", "exp_dir": os.path.join(root, "exp_v2_train"),
        "data_type": "shard",
        "train_data": tr["data"], "train_utt2spk": tr["utt2spk"],
        "train_spk2utt": tr["spk2enroll"],
        "val_data": va["data"], "val_spk2utt": va["spk2utt"],
        "val_spk1_enroll": va["spk1_enroll"],
        "val_spk2_enroll": va["spk2_enroll"],
        "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                            "prefetch_factor": 6},
        "dataset_args": v2_dataset_args(steps),
        "compute_dtype": "bfloat16", "log_batch_interval": 1,
        "loss": "SISDR", "loss_args": {},
        "model": {"tse_model": "BSRNN"},
        "model_args": {"tse_model": dict(V2_BSRNN_ARGS)},
        "model_init": {"tse_model": init_path},
        "num_avg": 1, "num_epochs": 1,
        "optimizer": {"tse_model": "Adam"},
        "optimizer_args": {"tse_model": {"lr": 0.001, "weight_decay": 0.0001}},
        "clip_grad": 5.0, "save_epoch_interval": 1,
        "scheduler": {"tse_model": "ExponentialDecrease"},
        "scheduler_args": {"tse_model": {
            "final_lr": 2.5e-05, "initial_lr": 0.001,
            "warm_from_zero": False, "warm_up_epoch": 0}},
        "seed": 42,
    }


def train_v2_bsrnn(root):
    """Phase 14 (c) and (d): the librimix v2 BSRNN through bin/train on the
    card (bf16, the separator promoted to f32 after the fuse), then
    average_model and bin/infer; with spk_model_freeze; the host data
    plane; the whole joint model's f32 gradients through the kernels
    against the plain LSTM's; a step's time, peak memory and its f32 LSTM
    wrappers' device time; one step with SSA_enroll_prob 1."""
    from wesep_tpu_torch.bin import average_model
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import load_enroll_maps, train
    from wesep_tpu_torch.data import BatchLoader, Dataset, tse_collate_fn
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.train.checkpoint import load_checkpoint
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    tag = "train v2 BSRNN"
    rng = np.random.default_rng(SEED + 23)
    tr, _ = enroll_shard(root, rng, "v2train", [4.0] * (2 * TRAIN_BATCH))
    va, va_lengths = enroll_shard(root, rng, "v2dev", [3.5] * TRAIN_BATCH)
    init = v2_bsrnn()
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "v2_init.ckpt")
    save_model(init_path, init)
    config = v2_train_config(root, tr, va, init_path, TRAIN_STEPS)
    per_pass = 2 * V2_BSRNN_ARGS["num_repeat"]
    val_steps = 1
    zero_counts()
    t0 = time.perf_counter()
    state = train(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"{tag}: {TRAIN_STEPS} steps + {val_steps} validation step through "
        f"bin/train in {wall:.3f} s wall; launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected, the "
        f"separator in f32 after the fuse: {per_pass * (TRAIN_STEPS + 1)} "
        f"of the f32 cluster chain and projection (with cs in the train "
        f"steps), {per_pass * TRAIN_STEPS} of the f32 adjoint and weight-"
        "gradient kernels, no tensor-core LSTM kernel)")
    expect_counts(counts, per_pass * (TRAIN_STEPS + val_steps),
                  per_pass * TRAIN_STEPS, "layer", tag, f32=True)
    # the validation step's forward is one of the f32 forwards counted
    with open(os.path.join(config["exp_dir"], "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    meter = re.findall(r"-> (\S+) audio-s/s", text)
    if len(losses) != TRAIN_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError("missing or non-finite training losses")
    moved = {n: (v.detach().cpu().float() - init_state[n]).abs().max().item()
             for n, v in state.model.state_dict().items()}
    still = [n for n, v in moved.items() if v == 0]
    stats = [n for n, _ in state.model.named_buffers()
             if n.endswith((".mean", ".var"))]
    if still or not stats or state.step != TRAIN_STEPS:
        raise AssertionError(f"parameters or statistics that did not move: "
                             f"{still}")
    log(f"{tag}: running mean loss per step {losses}, epoch {epoch}; "
        f"{len(stats)} BatchNorm buffers of spk_model_net all moved; the "
        f"epoch's throughput {meter} audio-s/s")
    del state
    models = os.path.join(config["exp_dir"], "models")
    avg = os.path.join(root, "v2_avg.ckpt")
    average_model.main(["--dst_model", avg, "--src_path", models,
                        "--num", "1"])
    if set(load_checkpoint(avg)["batch_stats"][0]) != set(stats):
        raise AssertionError("average_model lost the BatchNorm statistics")
    sisnr, _ = infer({
        "model": config["model"], "model_args": config["model_args"],
        "data_type": "shard", "dataset_args": v2_infer_dataset_args(),
        "exp_dir": os.path.join(root, "exp_v2_avg"), "checkpoint": avg,
        "save_wav": False, "device": "cuda", "length_bucket": BUCKET,
        "test_data": va["data"], "test_spk2utt": va["spk2utt"],
        "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    if not math.isfinite(sisnr):
        raise AssertionError("bin/infer from the averaged model: non-finite")
    log(f"{tag}: average_model -> bin/infer decoded {2 * len(va_lengths)} "
        f"requests, avg SI-SNR {sisnr:.3f} dB")

    # spk_model_freeze: one step; the encoder's parameters keep their
    # values bit for bit, its statistics and the separator move
    frozen_cfg = v2_train_config(root, tr, va, init_path, 1)
    frozen_cfg["exp_dir"] = os.path.join(root, "exp_v2_freeze")
    state = train(frozen_cfg,
                  overrides=["model_args.tse_model.spk_model_freeze=true"])
    torch.cuda.synchronize()
    enc = {n: p.detach().cpu() for n, p in state.model.named_parameters()
           if n.startswith("spk_model_net.")}
    kept = all(torch.equal(p, init_state[n]) for n, p in enc.items())
    enc_stats_moved = all(
        not torch.equal(b.cpu(), init_state[n])
        for n, b in state.model.named_buffers()
        if n.endswith((".mean", ".var")))
    sep_moved = all(
        not torch.equal(p.detach().cpu(), init_state[n])
        for n, p in state.model.named_parameters()
        if not n.startswith("spk_model_net."))
    log(f"{tag}: spk_model_freeze: {len(enc)} encoder parameters unchanged "
        f"bit for bit {kept}; its statistics moved {enc_stats_moved}; every "
        f"separator parameter moved {sep_moved}")
    if not (kept and enc_stats_moved and sep_moved and enc):
        raise AssertionError("spk_model_freeze did not hold")
    del state

    # the host data plane alone, in one thread: the v2 train chain (shard
    # decode, chunks, enrollment wavs, fbank with dither, CMVN) and the
    # collator, after one batch of warm-up; without the shuffle buffer,
    # whose first fill (2500 samples) is a one-off
    maps = load_enroll_maps(config, True, False)
    chain = Dataset("shard", tr["data"],
                    dict(config["dataset_args"], shuffle=False), maps[0],
                    state="train", joint_training=True, repeat_dataset=True)
    loader = BatchLoader(chain, batch_size=TRAIN_BATCH, prefetch=0,
                         collate_fn=lambda b: tse_collate_fn(
                             b, fixed_enroll_len=ENROLL_FRAMES))
    loader.set_epoch(1)
    host_audio, host_batches = 0.0, 2 * TRAIN_STEPS
    for i, batch in enumerate(loader):
        if batch["spk_embeds"].shape != (2 * TRAIN_BATCH, ENROLL_FRAMES, 80):
            raise AssertionError(f"fbank batch {batch['spk_embeds'].shape}")
        if i == 0:
            t0 = time.perf_counter()
            continue
        host_audio += batch["wav_mix"].size / 16000.0
        if i == host_batches:
            break
    host_s = time.perf_counter() - t0
    log(f"{tag}: host data plane (one thread) {host_batches} batches of 16 "
        f"rows x 3 s with fbank cues in {host_s:.3f} s: "
        f"{host_audio / host_s:.1f} audio-s/s")

    # the whole joint model's f32 gradients, the encoder's leaves included,
    # through the kernels against the plain LSTM's (limit 1e-3)
    gen = torch.Generator().manual_seed(SEED + 24)
    model = v2_bsrnn()
    model.load_state_dict(init_state)
    model = model.cuda().train()
    small = v2_batch(ROWS_PER_STEP, gen)
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    zero_counts()
    got = param_grads(model, small["wav_mix"], small["spk_embeds"],
                      small["wav_targets"])
    f32_counts = read_counts()
    expect_counts(f32_counts, per_pass, per_pass, "layer",
                  f"{tag}: f32 gradients", f32=True)
    for m in lstms:
        m.plain = True
    want = param_grads(model, small["wav_mix"], small["spk_embeds"],
                       small["wav_targets"])
    for m in lstms:
        m.plain = False
    rel = {n: rel_l2(got[n], want[n]) for n in want}
    worst = max(rel, key=rel.get)
    enc_worst = max((n for n in rel if n.startswith("spk_model_net.")),
                    key=rel.get)
    log(f"{tag}: gradients of {len(rel)} parameters, kernels vs plain LSTM "
        f"(f32): worst relative L2 {rel[worst]:.3e} at {worst}, the encoder's "
        f"worst {rel[enc_worst]:.3e} at {enc_worst} (limit 1e-3)")
    if not rel[worst] <= 1e-3:
        raise AssertionError(f"gradients differ: {worst} {rel[worst]}")
    del got, want

    # a train step at the recipe's size: time, peak memory, launches and
    # the f32 LSTM wrappers' device time in it
    batch = v2_batch(2 * TRAIN_BATCH, gen)
    sched = exponential_decrease(num_epochs=1, epoch_iter=100,
                                 initial_lr=1e-3, final_lr=2.5e-5,
                                 warm_up_epoch=0)
    opt = make_optimizer(model, sched, weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"), compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(tstate, batch)
    per_step = read_counts()
    expect_counts(per_step, per_pass, per_pass, "layer",
                  f"{tag}: one train step", f32=True)
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    wrapper_ms, timed_step_ms = wrapper_times(lambda: step(tstate, batch))
    lstm_ms = sum(wrapper_ms.values())
    # PyTorch's default, which bin/train keeps: cuDNN convs on TF32
    torch.backends.cudnn.allow_tf32 = True
    tf32_step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=3)
    torch.backends.cudnn.allow_tf32 = False
    audio = 2 * TRAIN_BATCH * CHUNK / 16000.0
    log(f"{tag}: step [16 rows x 3 s, bf16 stream, f32 after the fuse] "
        f"{step_ms:.3f} ms ({tf32_step_ms:.3f} ms with cuDNN's TF32, the "
        f"default), {audio / (step_ms / 1e3):.1f} audio-s/s, peak "
        f"memory {peak / 2 ** 30:.2f} GiB; launches "
        f"{ {n: v for n, v in per_step.items() if v} }; in one step of "
        f"{timed_step_ms:.3f} ms the f32 LSTM wrappers take "
        f"{ {n: round(v, 3) for n, v in wrapper_ms.items()} } ms, "
        f"{lstm_ms:.3f} ms in all, {100 * lstm_ms / timed_step_ms:.1f} %")

    # (d) one step with SSA_enroll_prob 1: the no-grad pass's statistics
    # are thrown away, so each buffer moves once, by the loss forward's
    # batch statistics
    from wesep_tpu_torch.models.common import BatchNorm

    norms = {n: m for n, m in model.named_modules()
             if isinstance(m, BatchNorm)}
    seen = {n: [] for n in norms}

    def record(name):
        def hook(module, args):
            x = args[0].float()
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            seen[name].append((mean, ((x * x).mean(dim=axes) - mean * mean)
                               .clamp_min(0.0)))
        return hook

    ssa = make_train_step(parse_loss("SISDR"), compute_dtype=torch.bfloat16,
                          ssa_enroll_prob=1.0, ssa_speaker_feat=True,
                          fbank_args=dict(V2_FBANK), sample_rate=16000,
                          seed=42)
    before = {n: (m.mean.clone(), m.var.clone()) for n, m in norms.items()}
    hooks = [m.register_forward_pre_hook(record(n))
             for n, m in norms.items()]
    zero_counts()
    ssa(tstate, batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    ssa_counts = read_counts()
    once = max(
        max(rel_err(m.mean, 0.9 * before[n][0] + 0.1 * seen[n][-1][0]),
            rel_err(m.var, 0.9 * before[n][1] + 0.1 * seen[n][-1][1]))
        for n, m in norms.items())
    calls = {len(v) for v in seen.values()}
    expect_counts(ssa_counts, 2 * per_pass, per_pass, "layer",
                  f"{tag}: one SSA step", f32=True)
    ssa_ms = time_ms(lambda: ssa(tstate, batch), warmup=0, runs=3)
    log(f"{tag}: SSA step (prob 1) {ssa_ms:.3f} ms; each of {len(norms)} "
        f"BatchNorms ran {calls} times a step, its buffers moved once "
        f"(error against one momentum update by the loss forward's "
        f"statistics {once:.3e}, limit 1e-5); launches "
        f"{ {n: v for n, v in ssa_counts.items() if v} }")
    if not (calls == {2} and once <= 1e-5):
        raise AssertionError("the SSA pass's statistics were kept")
    summary = {
        "steps": TRAIN_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "epoch_audio_s_per_s": meter,
        "step_ms": step_ms, "tf32_step_ms": tf32_step_ms,
        "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak,
        "host_data_plane_audio_s_per_s": host_audio / host_s,
        "grad_rel_l2_worst": rel[worst],
        "encoder_grad_rel_l2_worst": rel[enc_worst],
        "f32_lstm_wrapper_ms": wrapper_ms, "timed_step_ms": timed_step_ms,
        "f32_lstm_share": lstm_ms / timed_step_ms,
        "launches_per_step": {n: v for n, v in per_step.items() if v},
        "ssa_step_ms": ssa_ms, "ssa_stats_err": once,
        "avg_model_sisnr": sisnr,
    }
    return {"main": counts, "f32_grads": f32_counts}, summary


def v2_other_model(name):
    """The v2 TF-GridNet or DPCCN at its conf's width, weights and
    statistics from SEED."""
    from wesep_tpu_torch.models import get_model

    torch.manual_seed(SEED)
    args = V2_GRID_ARGS if name == "TFGridNet" else V2_DPCCN_ARGS
    model = get_model(name)(**args)
    seed_statistics(model)
    return model.cuda()


def check_v2_others():
    """Phase 14 (e): the v2 TF-GridNet and DPCCN (ResNet34 on fbank, the
    default routes: TF-GridNet's BiLSTMs over unfolded frames through K0,
    DPCCN's conv_impl "xla"), one served forward of 2 rows x 3 s and one
    train step at the conf's batch (4 and 12 rows x 3 s, bf16 stream, f32
    after the fuse), with their launch counts, times and peak memory."""
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    set_route(False)  # the default route: unfold in torch ops, then K0
    out = {}
    for name, rows in (("TFGridNet", 2 * V2_GRID_BATCH),
                       ("DPCCN", 2 * V2_DPCCN_BATCH)):
        gen = torch.Generator().manual_seed(SEED + 25)
        model = v2_other_model(name).eval()
        serve_b = v2_batch(ROWS_PER_STEP, gen)
        with torch.inference_mode():
            zero_counts()
            zero_conv_counts()
            est = model(serve_b["wav_mix"], serve_b["spk_embeds"])[0]
            serve_counts = dict(read_counts(), **read_conv_counts())
            serve_ms = time_ms(lambda: model(serve_b["wav_mix"],
                                             serve_b["spk_embeds"]), 1, 5)
        if not (torch.isfinite(est).all() and est.shape == (2, CHUNK)):
            raise AssertionError(f"v2 {name}: bad served estimate")
        model.train()
        opt = make_optimizer(model, exponential_decrease(
            num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
            warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
        tstate = TrainState(model=model, optimizer=opt)
        step = make_train_step(parse_loss("SISDR"),
                               compute_dtype=torch.bfloat16)
        batch = v2_batch(rows, gen)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        zero_conv_counts()
        _, metrics = step(tstate, batch)
        train_counts = dict(read_counts(), **read_conv_counts())
        loss = float(metrics["loss"])
        step_ms = time_ms(lambda: step(tstate, batch), warmup=0, runs=3)
        peak = torch.cuda.max_memory_allocated()
        lstm = {n: train_counts[n] for n in read_counts()}
        if name == "TFGridNet":
            expect_counts({n: serve_counts[n] for n in read_counts()},
                          GRID_RNNS, 0, "layer", f"v2 {name} serving",
                          f32=True)
            expect_counts(lstm, GRID_RNNS, GRID_RNNS, "layer",
                          f"v2 {name} train step", f32=True)
        elif any(serve_counts.values()) or any(train_counts.values()):
            raise AssertionError(f"v2 DPCCN (xla route) launched kernels: "
                                 f"{serve_counts} {train_counts}")
        if not math.isfinite(loss):
            raise AssertionError(f"v2 {name}: non-finite loss")
        audio = rows * CHUNK / 16000.0
        out[name] = {
            "serve_ms": serve_ms, "serve_audio_s_per_s": 6.0 / (serve_ms
                                                                / 1e3),
            "serve_launches": {n: v for n, v in serve_counts.items() if v},
            "train_rows": rows, "step_ms": step_ms,
            "audio_s_per_s": audio / (step_ms / 1e3),
            "peak_memory_bytes": peak, "loss": loss,
            "train_launches": {n: v for n, v in train_counts.items() if v}}
        log(f"v2 {name}: served forward [2 x 3 s] {serve_ms:.3f} ms, launches "
            f"{out[name]['serve_launches']}; train step [{rows} rows x 3 s, "
            f"bf16 stream, f32 after the fuse] {step_ms:.3f} ms, "
            f"{out[name]['audio_s_per_s']:.1f} audio-s/s, peak "
            f"{peak / 2 ** 30:.2f} GiB, launches "
            f"{out[name]['train_launches']}")
        del model, opt, tstate, batch
        torch.cuda.empty_cache()
    return out


# --- phase 15: MetricGAN on DPCCN (examples/librimix/tse/{v1,v2}/confs/
# dpcc_init_gan.yaml) and BSRNN_Multi (v2 bsrnn_multi_optim.yaml) ----------

HERE = os.path.dirname(os.path.abspath(__file__))
GAN_CONF = {v: os.path.join(HERE, f"examples/librimix/tse/{v}/confs/"
                            "dpcc_init_gan.yaml") for v in ("v1", "v2")}
MULTI_CONF = os.path.join(HERE, "examples/librimix/tse/v2/confs/"
                          "bsrnn_multi_optim.yaml")
GAN_BATCH = 4       # the conf's batch_size: 8 rows of 3 s a GAN step
# in_bias_0's gradient, card vs CPU, rel. L2 of its own norm: 1.56e-3
# measured on an H100 80GB HBM3 at 700 W, where a planted fault reads 0.94
# (PERF.md, the discriminator's limits)
DISC_IN_BIAS0_LIMIT = 5e-3
GAN_STEPS = 2       # epoch_iter of each train_gan run
GAN_W = 0.05        # the confs' gan_loss_weight
PESQ_LIMIT = 1e-4   # MOS, the card against the CPU
MULTI_BATCH = 4     # 8 rows x 3 s a BSRNN_Multi step
MULTI_STEPS = 2
MULTI_TABLE = ([[0, 1]], [[0.4, 0.6]])  # the conf's loss table
MULTI_PASS = 2 * V1_MODEL_ARGS["num_repeat"]  # BiLSTMs a separation pass
MULTI_GRAD_SEEDS = 3
# The encoder's gradients over both passes, kernels vs plain LSTM: the
# second pass embeds the fbank of the first estimate, which magnifies the
# estimate's rounding. Set from readings on an H100 80GB HBM3 at 700 W:
# the sound runs' largest over MULTI_GRAD_SEEDS seeds 2.3e-2, a planted
# fault's smallest 6.4e-2 and median 0.10 (PERF.md, BSRNN_Multi's
# limits).
MULTI_ENCODER_LIMIT = 5e-2


def check_pesq():
    """Phase 15 (a): P.862 on the card against the same call on the CPU,
    4 rows x 3 s at 8 and 16 kHz (degraded at 40 ... 0 dB SNR), and the
    time of a call."""
    from wesep_tpu_torch.ops.pesq import pesq_batch, pesq_norm_batch

    out = {}
    for fs in (8000, 16000):
        gen = torch.Generator().manual_seed(SEED + 40)
        n = 3 * fs
        ref = voices(4, n, gen)
        noise = torch.randn(4, n, generator=gen)
        snr = torch.tensor([40.0, 20.0, 10.0, 0.0])[:, None]
        noise = noise * (ref.square().mean(-1, keepdim=True)
                         / noise.square().mean(-1, keepdim=True)).sqrt() \
            * 10 ** (-snr / 20)
        deg = ref + noise
        want, want_ok = pesq_norm_batch(deg, ref, fs)
        ref_c, deg_c = ref.cuda(), deg.cuda()
        got, ok = pesq_norm_batch(deg_c, ref_c, fs)
        err = ((got.cpu() - want) * 5).abs().max().item()  # in MOS
        card_ms = time_ms(lambda: pesq_batch(ref_c, deg_c, fs), 2, 10)
        t0 = time.perf_counter()
        pesq_batch(ref, deg, fs)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        out[fs] = {"mos": (want * 5 - 0.5).tolist(), "max_err_mos": err,
                   "valid_equal": torch.equal(ok.cpu(), want_ok),
                   "card_ms": card_ms, "cpu_ms": cpu_ms}
        log(f"P.862 at {fs} Hz, 4 x 3 s: MOS {out[fs]['mos']}, card vs CPU "
            f"max error {err:.3e} MOS (limit {PESQ_LIMIT}); a call "
            f"{card_ms:.3f} ms on the card, {cpu_ms:.1f} ms on the CPU")
        if not (err <= PESQ_LIMIT and out[fs]["valid_equal"]):
            raise AssertionError(f"P.862 on the card disagrees: {out[fs]}")
    return out


def check_discriminator():
    """Phase 15 (b): the full-width CMGAN discriminator (hid 16, 4 conv
    blocks) forward and backward on the card against the CPU (f32, TF32
    off), 8 rows x 3 s, one dropout mask; u moves by one power step per
    train-mode call and not in eval mode."""
    from wesep_tpu_torch.models.discriminator import (
        CMGANDiscriminator,
        SpectralNormed,
    )

    torch.manual_seed(SEED)
    cpu_d = CMGANDiscriminator()
    card_d = CMGANDiscriminator()
    init = {k: v.clone() for k, v in cpu_d.state_dict().items()}
    card_d.load_state_dict(init)
    card_d = card_d.cuda()
    gen = torch.Generator().manual_seed(SEED + 41)
    rows = 2 * GAN_BATCH
    ref = voices(rows, CHUNK, gen)
    est = ref + 0.05 * torch.randn(rows, CHUNK, generator=gen)
    mask = cpu_d.dropout_mask(rows, torch.Generator().manual_seed(3), "cpu")
    u0 = {n: m.u.clone() for n, m in cpu_d.named_modules()
          if isinstance(m, SpectralNormed)}
    res = []
    for model, dev in ((cpu_d, "cpu"), (card_d, "cuda")):
        model.train()
        out = model(ref.to(dev), est.to(dev), [m.to(dev) for m in mask])
        grads = torch.autograd.grad(out.sum(), list(model.parameters()))
        res.append((out.detach().cpu(), [g.cpu() for g in grads]))
    (want, want_g), (got, got_g) = res
    err = (got - want).abs().max().item() / want.abs().max().item()
    # every parameter by relative L2 1e-3 of its own gradient but in_bias_0,
    # held to DISC_IN_BIAS0_LIMIT: the next block's instance norm removes
    # its per-channel shift but for the PReLU's kink and the conv's zero
    # padding, so its gradient is a sum of ~2e5 terms a channel that cancels
    # to 0.6 % of the whole norm, which cuDNN and the CPU add in other
    # orders; a planted fault (PReLU 0's input gradient 1 on its negative
    # side, on the CPU) must read above that limit
    names = [n for n, _ in card_d.named_parameters()]
    rel = {n: rel_l2(g, w) for n, g, w in zip(names, got_g, want_g)}
    limit = {n: DISC_IN_BIAS0_LIMIT if n == "in_bias_0" else 1e-3
             for n in names}
    worst = max((n for n in names if n != "in_bias_0"), key=rel.get)
    fault_d = CMGANDiscriminator()
    fault_d.load_state_dict(init)
    prelu = fault_d.prelu_0
    prelu.forward = lambda x: torch.where(
        x >= 0, x, x + ((prelu.alpha - 1) * x).detach())
    fault_g, = torch.autograd.grad(
        fault_d.train()(ref, est, mask).sum(), fault_d.in_bias_0)
    fault_rel = rel_l2(fault_g, want_g[names.index("in_bias_0")])
    # one power step from the initial u, in flax's matrix layout
    step_err = 0.0
    for name, m in card_d.named_modules():
        if name not in u0:
            continue
        mat = m.flax_matrix().detach().cpu()
        v = u0[name] @ mat.t()
        v = v * torch.rsqrt(v.square().sum() + 1e-12)
        u = v @ mat
        u = u * torch.rsqrt(u.square().sum() + 1e-12)
        step_err = max(step_err, (m.u.cpu() - u).abs().max().item())
    after = {n: m.u.clone() for n, m in card_d.named_modules() if n in u0}
    with torch.no_grad():
        card_d.eval()(ref.cuda(), est.cuda())
    eval_kept = all(torch.equal(m.u, after[n])
                    for n, m in card_d.named_modules() if n in u0)
    card_d.train()
    r, e = ref.cuda(), est.cuda()
    cmask = [m.cuda() for m in mask]
    params = list(card_d.parameters())
    both_ms = time_ms(lambda: torch.autograd.grad(
        card_d(r, e, cmask).sum(), params), 2, 10)
    summary = {"rows": rows, "max_err_rel_largest": err,
               "grad_rel_l2": rel, "in_bias_0_fault_rel_l2": fault_rel,
               "u_one_step_err": step_err, "eval_keeps_u": eval_kept,
               "forward_backward_ms": both_ms}
    log(f"CMGAN discriminator [8 x 3 s] card vs CPU: score error "
        f"{err:.3e} of the largest (limit 1e-4), gradients worst rel L2 "
        f"{rel[worst]:.3e} at {worst} (limit 1e-3), in_bias_0 "
        f"{rel['in_bias_0']:.3e} (limit {DISC_IN_BIAS0_LIMIT:.0e}; the "
        f"planted fault {fault_rel:.3e}); u after one train call against "
        f"one power step {step_err:.3e}, eval keeps u {eval_kept}; forward + "
        f"backward {both_ms:.3f} ms; by parameter {json.dumps(rel)}")
    if not (err <= 1e-4 and all(rel[n] <= limit[n] for n in names)
            and fault_rel > DISC_IN_BIAS0_LIMIT and step_err <= 1e-5
            and eval_kept):
        raise AssertionError(f"discriminator on the card: {summary}")
    return summary


def gan_overrides(exp_dir, tr, va, steps, epochs=1):
    """`--set` overrides of dpcc_init_gan.yaml for the synthetic shards."""
    return [f"exp_dir={exp_dir}", "device=cuda",
            f"train_data={tr['data']}", f"train_utt2spk={tr['utt2spk']}",
            f"train_spk_embeds={tr['spk_embeds']}",
            f"val_data={va['data']}", f"val_spk_embeds={va['spk_embeds']}",
            f"val_spk1_enroll={va['spk1_enroll']}",
            f"val_spk2_enroll={va['spk2_enroll']}",
            f"num_epochs={epochs}", "log_batch_interval=1",
            f"dataset_args.sample_num_per_epoch={steps * GAN_BATCH}"]


class FirstStates:
    """Wraps trainer_gan.make_gan_train_step: keeps copies of both models'
    state and both optimizers' counts and moments as the first GAN step of
    a run finds them."""

    def __enter__(self):
        from wesep_tpu_torch.train import trainer_gan

        self.module, self.real = trainer_gan, trainer_gan.make_gan_train_step
        self.seen = {}
        seen = self.seen

        def wrapped(*args, **kw):
            step = self.real(*args, **kw)

            def first(states, batch):
                if not seen:
                    for tag, st in zip("gd", states):
                        seen[tag] = {n: v.detach().cpu().clone() for n, v
                                     in st.model.state_dict().items()}
                        seen[tag + "_opt"] = {
                            "count": st.optimizer.count,
                            "mu": {n: t.cpu().clone() for n, t in
                                   st.optimizer.mu.items()}}
                return step(states, batch)

            return first

        trainer_gan.make_gan_train_step = wrapped
        return seen

    def __exit__(self, *exc):
        self.module.make_gan_train_step = self.real


def gan_log_losses(exp_dir):
    with open(os.path.join(exp_dir, "train.log")) as f:
        text = f.read()
    return [tuple(float(v) for v in m) for m in re.findall(
        r"Epoch \d+ g_loss (\S+) se_loss (\S+) d_loss (\S+) val (\S+)",
        text)]


def gan_loss_grads(gen, disc, batch):
    """Gradients of the GAN step's generator loss (SE + GAN_W * (D(clean,
    est) - 1)^2 through D in eval mode) w.r.t. every generator parameter."""
    from wesep_tpu_torch.train.losses import si_sdr_loss

    names, params = zip(*gen.named_parameters())
    est = gen(batch["wav_mix"], batch["spk_embeds"])[0]
    score = disc.eval()(batch["wav_targets"], est).reshape(-1)
    loss = si_sdr_loss(est, batch["wav_targets"]).mean() \
        + GAN_W * (score - 1).square().mean()
    return dict(zip(names, torch.autograd.grad(loss, params)))


def gan_states(gen, disc):
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import TrainState, make_optimizer

    def state(model, lr):
        return TrainState(model, make_optimizer(model, exponential_decrease(
            num_epochs=50, epoch_iter=100, initial_lr=lr, final_lr=2.5e-5,
            warm_up_epoch=0), weight_decay=1e-4, clip_grad=DPCCN_CLIP))

    return state(gen, 1e-4), state(disc, 1e-3)


def train_gan_dpccn(root):
    """Phase 15 (c), (d): bin/train_gan on v1 dpcc_init_gan.yaml (DPCCN at
    full width, the default discriminator, 8 rows x 3 s, f32) on the
    recipe's "xla" route and under conv_impl=pallas (7 K5 and 7 K5b a GAN
    step, 7 K5 a validation step); a resumed run; average_model ->
    bin/infer; the generator's f32 gradients through K5/K5b against the
    plain versions; the GAN step's time, peak memory and PESQ share on
    both routes; then one GAN step of the v2 conf (ResNet34 on 6 s
    enrollment fbank)."""
    from functools import partial

    from wesep_tpu_torch.bin import average_model
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train_gan import train_gan
    from wesep_tpu_torch.models.discriminator import CMGANDiscriminator
    from wesep_tpu_torch.models.dpccn import DPCCN
    from wesep_tpu_torch.train.checkpoint import load_checkpoint
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.trainer_gan import (
        make_gan_train_step,
        metric_pesq,
    )

    tag = "train_gan DPCCN"
    rng = np.random.default_rng(SEED + 42)
    tr, _ = write_shard(root, rng, "gantrain", [4.0] * (2 * GAN_BATCH))
    va, va_lengths = write_shard(root, rng, "gandev", [3.5] * GAN_BATCH)
    val_steps = 1  # 8 validation enrollments / 2 / batch_size 4
    runs = {}
    for route in ("xla", "pallas"):
        exp = os.path.join(root, f"exp_gan_{route}")
        overrides = gan_overrides(exp, tr, va, GAN_STEPS)
        if route == "pallas":
            overrides.append("model_args.tse_model.conv_impl=pallas")
        zero_conv_counts()
        t0 = time.perf_counter()
        with FirstStates() as first:
            g_state, d_state = train_gan(GAN_CONF["v1"], overrides=overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_conv_counts()
        fused = DPCCN_FUSED if route == "pallas" else 0
        want = {"conv2d_block_in": fused * (GAN_STEPS + val_steps),
                "conv2d_block_in_backward": fused * GAN_STEPS}
        losses = gan_log_losses(exp)
        moved = {t: [n for n, v in m.state_dict().items()
                     if torch.equal(v.cpu(), first[t][n])
                     and not n.endswith(DPCCN_NOISE_ONLY)]
                 for t, m in (("g", g_state.model), ("d", d_state.model))}
        u_moved = all(not torch.equal(b.cpu(), first["d"][n])
                      for n, b in d_state.model.named_buffers()
                      if n.endswith(".u"))
        log(f"{tag} ({route} route): {GAN_STEPS} GAN steps + {val_steps} "
            f"validation step through bin/train_gan in {wall:.3f} s wall; "
            f"launches {launches} (expected {want}); epoch (g_loss, se_loss, "
            f"d_loss, val) {losses}; unchanged G / D entries {moved}, D's u "
            f"moved {u_moved}")
        if launches != want:
            raise AssertionError(f"{tag} ({route}): launches {launches}")
        if not (len(losses) == 1 and all(math.isfinite(v)
                                          for v in losses[0])):
            raise AssertionError(f"{tag} ({route}): losses {losses}")
        if moved["g"] or moved["d"] or not u_moved \
                or g_state.step != GAN_STEPS:
            raise AssertionError(f"{tag} ({route}): parameters that did not "
                                 f"move {moved}")
        runs[route] = {"wall_s": wall, "losses": losses[0],
                       "launches": launches}
        del g_state, d_state

    # a run resumed from the pallas run's checkpoint_1: both models and both
    # optimizers as the bundle holds them
    ckpt = os.path.join(root, "exp_gan_pallas", "models", "checkpoint_1.ckpt")
    exp = os.path.join(root, "exp_gan_resume")
    overrides = gan_overrides(exp, tr, va, GAN_STEPS, epochs=2) + [
        "model_args.tse_model.conv_impl=pallas"]
    with FirstStates() as first:
        g_state, d_state = train_gan(GAN_CONF["v1"], checkpoint=ckpt,
                                     overrides=overrides)
    bundle = load_checkpoint(ckpt)
    restored = all(
        torch.equal(first[t][n], v)
        for i, t in enumerate("gd")
        for part in (bundle["models"][i], bundle["batch_stats"][i])
        for n, v in part.items()) and all(
        first[t + "_opt"]["count"] == GAN_STEPS
        and all(torch.equal(first[t + "_opt"]["mu"][n], v)
                for n, v in bundle["opt_states"][i]["mu"].items())
        for i, t in enumerate("gd"))
    if not (restored and g_state.step == d_state.step == 2 * GAN_STEPS):
        raise AssertionError(f"{tag}: the resumed run did not restore both "
                             "models and optimizers")
    del g_state, d_state
    avg = os.path.join(root, "gan_avg.ckpt")
    average_model.main(["--dst_model", avg, "--src_path",
                        os.path.join(exp, "models"), "--num", "1"])
    sisnr, _ = infer({
        "model": {"tse_model": "DPCCN"},
        "model_args": {"tse_model": dict(DPCCN_MODEL_ARGS)},
        "data_type": "shard", "dataset_args": {"resample_rate": 16000},
        "exp_dir": os.path.join(root, "exp_gan_infer"), "checkpoint": avg,
        "save_wav": False, "device": "cuda", "length_bucket": BUCKET,
        "test_data": va["data"], "test_spk_embeds": va["spk_embeds"],
        "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    if not math.isfinite(sisnr):
        raise AssertionError(f"{tag}: bin/infer from the average: {sisnr}")
    log(f"{tag}: resumed from checkpoint_1 with both models and optimizers "
        f"restored; average_model -> bin/infer decoded "
        f"{2 * len(va_lengths)} requests, avg SI-SNR {sisnr:.3f} dB")

    # the generator's f32 gradients through K5/K5b against the plain
    # versions (the GAN step's generator loss through a fixed D, 2 rows)
    gen = torch.Generator().manual_seed(SEED + 43)
    torch.manual_seed(SEED)
    init_state = DPCCN(**DPCCN_MODEL_ARGS).state_dict()
    torch.manual_seed(SEED + 1)
    disc = CMGANDiscriminator().cuda()
    g = dpccn_model("pallas", init_state).train()
    small = {"wav_mix": (torch.randn(2, CHUNK, generator=gen) * 0.1).cuda(),
             "wav_targets": (torch.randn(2, CHUNK, generator=gen)
                             * 0.1).cuda(),
             "spk_embeds": torch.randn(2, 256, generator=gen).cuda()}
    zero_conv_counts()
    got = gan_loss_grads(g, disc, small)
    counts = read_conv_counts()
    set_plain(conv_blocks(g), True)
    want = gan_loss_grads(g, disc, small)
    set_plain(conv_blocks(g), False)
    total = torch.cat([w.flatten() for w in want.values()]).norm().item()
    weak = DPCCN_NOISE_ONLY + DPCCN_NEAR_CANCELLING
    rel = {n: rel_l2(got[n], want[n]) for n in want if not n.endswith(weak)}
    noise = {n: (got[n] - want[n]).norm().item() / total for n in want
             if n.endswith(weak)}
    worst, worst_noise = max(rel, key=rel.get), max(noise, key=noise.get)
    log(f"{tag}: generator f32 gradients of the GAN loss, K5/K5b ({counts}) "
        f"vs plain: worst rel L2 {rel[worst]:.3e} at {worst} (limit 1e-3); "
        f"noise-only and near-cancelling leaves {noise[worst_noise]:.3e} of "
        f"the norm at {worst_noise} (limit 1e-5)")
    if counts != {"conv2d_block_in": DPCCN_FUSED,
                  "conv2d_block_in_backward": DPCCN_FUSED} or not (
            rel[worst] <= 1e-3 and noise[worst_noise] <= 1e-5):
        raise AssertionError(f"{tag}: gradients {rel[worst]} "
                             f"{noise[worst_noise]} {counts}")
    del got, want, g

    # the GAN step at the recipe's size, each route: time, peak memory,
    # launches, and the PESQ targets' share
    rows = 2 * GAN_BATCH
    batch = {"wav_mix": voices(rows, CHUNK, gen).cuda(),
             "wav_targets": voices(rows, CHUNK, gen).cuda(),
             "spk_embeds": torch.randn(rows, 256, generator=gen).cuda()}
    metric = partial(metric_pesq, fs=16000)
    step = make_gan_train_step(parse_loss("SISDR"), gan_loss_weight=GAN_W,
                               metric_fn=metric, seed=42)
    timed = {}
    for route in ("xla", "pallas"):
        torch.manual_seed(SEED + 1)
        states = gan_states(dpccn_model(route, init_state),
                            CMGANDiscriminator().cuda())
        zero_conv_counts()
        _, m = step(states, batch)
        per_step = read_conv_counts()
        fused = DPCCN_FUSED if route == "pallas" else 0
        if per_step != {"conv2d_block_in": fused,
                        "conv2d_block_in_backward": fused} or not all(
                math.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"{tag}: one GAN step ({route}): "
                                 f"{per_step} {m}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(states, batch), 1, 5)
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            est = states[0].model(batch["wav_mix"], batch["spk_embeds"])[0]
        pesq_ms = time_ms(lambda: (metric(batch["wav_mix"],
                                          batch["wav_targets"]),
                                   metric(est, batch["wav_targets"])), 2, 10)
        timed[route] = {"step_ms": step_ms, "peak_memory_bytes": peak,
                        "pesq_ms": pesq_ms, "pesq_share": pesq_ms / step_ms,
                        "audio_s_per_s": rows * 3.0 / (step_ms / 1e3),
                        "launches_per_step": per_step}
        log(f"{tag} ({route} route): GAN step [8 rows x 3 s, f32] "
            f"{step_ms:.3f} ms, {timed[route]['audio_s_per_s']:.1f} "
            f"audio-s/s, peak memory {peak / 2 ** 30:.2f} GiB; its two PESQ "
            f"target calls {pesq_ms:.3f} ms ({100 * pesq_ms / step_ms:.1f} "
            f"%); launches {per_step}")
        del states, est

    # (d) one GAN step of the v2 conf: ResNet34 on 6 s enrollment fbank,
    # its statistics moved once (one generator forward a step)
    from wesep_tpu_torch.models.common import BatchNorm

    g = v2_other_model("DPCCN")
    torch.manual_seed(SEED + 1)
    states = gan_states(g, CMGANDiscriminator().cuda())
    norms = {n: mod for n, mod in g.named_modules()
             if isinstance(mod, BatchNorm)}
    seen = {n: [] for n in norms}

    def record(name):
        def hook(module, args):
            x = args[0].float()
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            seen[name].append((mean, ((x * x).mean(dim=axes) - mean * mean)
                               .clamp_min(0.0)))
        return hook

    before = {n: (mod.mean.clone(), mod.var.clone())
              for n, mod in norms.items()}
    hooks = [mod.register_forward_pre_hook(record(n))
             for n, mod in norms.items()]
    v2 = v2_batch(rows, gen)
    _, m = step(states, v2)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    once = max(
        max(rel_err(mod.mean, 0.9 * before[n][0] + 0.1 * seen[n][0][0]),
            rel_err(mod.var, 0.9 * before[n][1] + 0.1 * seen[n][0][1]))
        for n, mod in norms.items())
    calls = {len(v) for v in seen.values()}
    v2_losses = {k: float(v) for k, v in m.items()}
    v2_ms = time_ms(lambda: step(states, v2), 0, 3)
    log(f"{tag}: v2 GAN step [8 rows x 3 s, fbank 598 x 80] {v2_ms:.3f} "
        f"ms; losses {v2_losses}; each of {len(norms)} BatchNorms ran "
        f"{calls} times, its statistics moved once (error {once:.3e}, limit "
        "1e-5)")
    if not (calls == {1} and once <= 1e-5
            and all(math.isfinite(v) for v in v2_losses.values())):
        raise AssertionError(f"{tag}: v2 GAN step {v2_losses} {calls} {once}")
    return runs["pallas"]["launches"], {
        "runs": runs, "infer_sisnr": sisnr,
        "grad_rel_l2_worst": rel[worst],
        "noise_only_grad_err_worst": noise[worst_noise], "steps": timed,
        "v2_step_ms": v2_ms, "v2_losses": v2_losses, "v2_stats_err": once}


def multi_grads(model, mix, enroll, target, table=MULTI_TABLE):
    """Gradients of a loss table (the conf's: 0.4 SI-SDR of s + 0.6 of
    self_s) w.r.t. every parameter, by name."""
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.trainer import weighted_loss

    names, params = zip(*model.named_parameters())
    loss = weighted_loss(model(mix, enroll), target, None,
                         parse_loss("SISDR"), *table)
    return dict(zip(names, torch.autograd.grad(loss, params)))


def check_multi_grads(model_args, tag):
    """The whole BSRNN_Multi's f32 gradients through the kernels against
    the plain LSTM's, 2 rows x 3 s: (1) the first pass's loss alone, every
    parameter, the encoder's included, rel. L2 1e-3; (2) the conf's loss
    over both passes, for MULTI_GRAD_SEEDS seeds of weights and inputs:
    the separator's parameters rel. L2 1e-3, the encoder's
    MULTI_ENCODER_LIMIT; (3) a planted fault, the second pass's gradient
    into the encoder dropped, must read above that limit. Returns the first
    seed's model, its initial state, its input generator, the launches of
    one both-pass gradient, and the readings."""
    from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi
    from wesep_tpu_torch.models.common import LSTM

    lstms = []

    def grads(model, init_state, inputs, plain, table, drop_pass2=False):
        for m in lstms:
            m.plain = plain
        model.load_state_dict(init_state)  # the statistics move each pass
        if drop_pass2:
            embed = model._spk_embedding

            def dropped(cue, from_waveform=False):
                e, logits = embed(cue, from_waveform)
                return (e.detach() if from_waveform else e), logits
            model._spk_embedding = dropped
        try:
            return multi_grads(model, *inputs, table)
        finally:
            if drop_pass2:
                del model._spk_embedding
            for m in lstms:
                m.plain = False

    def enc(names):
        return [n for n in names if n.startswith("spk_model_net.")]

    readings = []
    for k in range(MULTI_GRAD_SEEDS):
        gen = torch.Generator().manual_seed(SEED + 45 + k)
        torch.manual_seed(SEED + k)
        model = BSRNN_Multi(**model_args)
        seed_statistics(model, SEED + k)
        init_state = {n: v.clone() for n, v in model.state_dict().items()}
        model = model.cuda().train()
        lstms[:] = [m for m in model.modules() if isinstance(m, LSTM)]
        inputs = (voices(2, CHUNK, gen).cuda(),
                  voices(2, int(ENROLL_SECONDS * 16000), gen).cuda(),
                  voices(2, CHUNK, gen).cuda())
        if k == 0:
            first_pass = ([[0]], [[MULTI_TABLE[1][0][0]]])
            rel1 = {n: rel_l2(g, w) for (n, g), w in zip(
                grads(model, init_state, inputs, False, first_pass).items(),
                grads(model, init_state, inputs, True, first_pass).values())}
            zero_counts()
        got = grads(model, init_state, inputs, False, MULTI_TABLE)
        if k == 0:
            grad_counts = read_counts()
            expect_counts(grad_counts, 2 * MULTI_PASS, 2 * MULTI_PASS,
                          "layer", f"{tag}: f32 gradients", f32=True)
        want = grads(model, init_state, inputs, True, MULTI_TABLE)
        readings.append({n: rel_l2(got[n], want[n]) for n in want})
        if k == 0:
            fault = grads(model, init_state, inputs, False, MULTI_TABLE,
                          drop_pass2=True)
            fault_rel = {n: rel_l2(fault[n], want[n]) for n in enc(want)}
            keep = (model, init_state, gen)
        del got, want
    model, init_state, gen = keep
    worst1 = max(rel1, key=rel1.get)
    sep = {n: max(r[n] for r in readings) for n in readings[0]
           if not n.startswith("spk_model_net.")}
    encr = {n: max(r[n] for r in readings) for n in enc(readings[0])}
    worst, enc_worst = max(sep, key=sep.get), max(encr, key=encr.get)
    enc_by_seed = [max(r[n] for n in encr) for r in readings]
    fault_worst = max(fault_rel, key=fault_rel.get)
    fault_caught = [n for n in fault_rel if fault_rel[n] > MULTI_ENCODER_LIMIT]
    log(f"{tag}: gradients of {len(sep) + len(encr)} parameters, kernels vs "
        f"plain LSTM (f32): the first pass's loss: worst rel L2 "
        f"{rel1[worst1]:.3e} at {worst1} (limit 1e-3); both passes, "
        f"{MULTI_GRAD_SEEDS} seeds: the separator's worst {sep[worst]:.3e} "
        f"at {worst} (limit 1e-3), the encoder's worst by seed "
        f"{[f'{v:.3e}' for v in enc_by_seed]}, over all {encr[enc_worst]:.3e}"
        f" at {enc_worst} (limit {MULTI_ENCODER_LIMIT:.0e}); planted fault "
        f"(the second pass's gradient into the encoder dropped): worst "
        f"{fault_rel[fault_worst]:.3e} at {fault_worst}, median "
        f"{sorted(fault_rel.values())[len(fault_rel) // 2]:.3e}, smallest "
        f"{min(fault_rel.values()):.3e}, "
        f"{len(fault_caught)} of {len(fault_rel)} encoder parameters above "
        f"the limit")
    if (rel1[worst1] > 1e-3 or sep[worst] > 1e-3
            or encr[enc_worst] > MULTI_ENCODER_LIMIT or not fault_caught):
        raise AssertionError(f"{tag}: gradients differ: {worst1} "
                             f"{rel1[worst1]}; {worst} {sep[worst]}; "
                             f"{enc_worst} {encr[enc_worst]}; the planted "
                             f"fault caught at {len(fault_caught)}")
    del fault
    return model, init_state, gen, grad_counts, {
        "first_pass_grad_rel_l2_worst": rel1[worst1],
        "separator_grad_rel_l2_worst": sep[worst],
        "encoder_grad_rel_l2_by_seed": enc_by_seed,
        "encoder_grad_limit": MULTI_ENCODER_LIMIT,
        "encoder_fault_rel_l2": fault_rel[fault_worst],
        "encoder_fault_caught": len(fault_caught)}


def train_bsrnn_multi(root):
    """Phase 15 (e): bin/train on v2 bsrnn_multi_optim.yaml (full width,
    ResNet34 on the consistent frontend of 6 s enrollment wavs, bf16, 8
    rows x 3 s): 24 f32 chains with cs, 24 projections and 24 of each f32
    backward kernel a train step, 12 chains and projections a validation
    step and a served forward; average_model -> bin/infer; the whole
    model's f32 gradients through the kernels against the plain LSTM's; a
    step's time and peak memory, TF32 off and on."""
    import yaml

    from wesep_tpu_torch.bin import average_model
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    tag = "train BSRNN_Multi"
    with open(MULTI_CONF) as f:
        conf = yaml.safe_load(f)
    rng = np.random.default_rng(SEED + 44)
    tr, _ = enroll_shard(root, rng, "multitrain", [4.0] * (2 * MULTI_BATCH))
    va, va_lengths = enroll_shard(root, rng, "multidev", [3.5] * MULTI_BATCH)
    exp = os.path.join(root, "exp_multi")
    overrides = [
        f"exp_dir={exp}", "device=cuda", f"train_data={tr['data']}",
        f"train_utt2spk={tr['utt2spk']}", f"train_spk2utt={tr['spk2enroll']}",
        f"val_data={va['data']}", f"val_spk2utt={va['spk2utt']}",
        f"val_spk1_enroll={va['spk1_enroll']}",
        f"val_spk2_enroll={va['spk2_enroll']}", "num_epochs=1",
        "log_batch_interval=1", f"dataloader_args.batch_size={MULTI_BATCH}",
        f"dataset_args.sample_num_per_epoch={MULTI_STEPS * MULTI_BATCH}"]
    val_steps = 1
    zero_counts()
    t0 = time.perf_counter()
    state = train(MULTI_CONF, overrides=overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"{tag}: {MULTI_STEPS} steps + {val_steps} validation step through "
        f"bin/train in {wall:.3f} s wall; launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected "
        f"{2 * MULTI_PASS} f32 forwards with cs and of each f32 backward "
        f"kernel a train step, {MULTI_PASS} f32 forwards a validation step)")
    expect_counts(counts, 2 * MULTI_PASS * MULTI_STEPS + MULTI_PASS *
                  val_steps, 2 * MULTI_PASS * MULTI_STEPS, "layer", tag,
                  f32=True)
    with open(os.path.join(exp, "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    if len(losses) != MULTI_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError(f"{tag}: losses {losses} {epoch}")
    if not isinstance(state.model, BSRNN_Multi) \
            or state.step != MULTI_STEPS:
        raise AssertionError(f"{tag}: {type(state.model)} {state.step}")
    del state
    avg = os.path.join(root, "multi_avg.ckpt")
    average_model.main(["--dst_model", avg, "--src_path",
                        os.path.join(exp, "models"), "--num", "1"])
    steps = forward_steps(va_lengths)
    zero_counts()
    sisnr, _ = infer({
        "model": conf["model"], "model_args": conf["model_args"],
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "exp_dir": os.path.join(root, "exp_multi_infer"), "checkpoint": avg,
        "save_wav": False, "device": "cuda", "length_bucket": BUCKET,
        "infer_batch_size": ROWS_PER_STEP, "test_data": va["data"],
        "test_spk2utt": va["spk2utt"], "test_spk1_enroll": va["spk1_enroll"],
        "test_spk2_enroll": va["spk2_enroll"]})
    expect_counts(read_counts(), MULTI_PASS * steps, 0, "layer",
                  f"{tag}: bin/infer", f32=True)
    if not math.isfinite(sisnr):
        raise AssertionError(f"{tag}: bin/infer from the average: {sisnr}")
    log(f"{tag}: running mean loss per step {losses}, epoch {epoch}; "
        f"average_model -> bin/infer decoded {2 * len(va_lengths)} requests "
        f"in {steps} forward steps ({MULTI_PASS} f32 chains and projections "
        f"each), avg SI-SNR {sisnr:.3f} dB")

    model, init_state, gen, grad_counts, grad_summary = check_multi_grads(
        conf["model_args"]["tse_model"], tag)

    # a train step at 8 rows x 3 s: time, peak memory, TF32 off and on
    model.load_state_dict(init_state)
    rows = 2 * MULTI_BATCH
    batch = {"wav_mix": voices(rows, CHUNK, gen).cuda(),
             "wav_targets": voices(rows, CHUNK, gen).cuda(),
             "spk_embeds": voices(rows, int(ENROLL_SECONDS * 16000),
                                  gen).cuda()}
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"), *MULTI_TABLE,
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(tstate, batch)
    per_step = read_counts()
    expect_counts(per_step, 2 * MULTI_PASS, 2 * MULTI_PASS, "layer",
                  f"{tag}: one train step", f32=True)
    step_ms = time_ms(lambda: step(tstate, batch), 1, 5)
    peak = torch.cuda.max_memory_allocated()
    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = time_ms(lambda: step(tstate, batch), 1, 3)
    torch.backends.cudnn.allow_tf32 = False
    audio = rows * CHUNK / 16000.0
    log(f"{tag}: step [8 rows x 3 s, bf16 stream, both passes f32 after the "
        f"fuse] {step_ms:.3f} ms ({tf32_ms:.3f} ms with cuDNN's TF32), "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches "
        f"{ {n: v for n, v in per_step.items() if v} }")
    return {"main": counts, "f32_grads": grad_counts}, {
        "steps": MULTI_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "avg_model_sisnr": sisnr,
        **grad_summary, "step_ms": step_ms,
        "tf32_step_ms": tf32_ms, "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak,
        "launches_per_step": {n: v for n, v in per_step.items() if v}}


def phase15():
    """Phase 15 whole: (a) P.862, (b) the discriminator, (c) and (d)
    train_gan on DPCCN, (e) BSRNN_Multi; -> (launches by path, summary)."""
    pesq = check_pesq()
    disc = check_discriminator()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        gan_launches, gan = train_gan_dpccn(root)
    log("train_gan DPCCN summary", json.dumps(gan))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        multi_launches, multi = train_bsrnn_multi(root)
    log("train BSRNN_Multi summary", json.dumps(multi))
    return {"gan_dpccn_train_pallas": gan_launches,
            "bsrnn_multi_train": multi_launches["main"],
            "bsrnn_multi_f32_grads": multi_launches["f32_grads"]}, {
        "pesq": {str(k): v for k, v in pesq.items()},
        "discriminator": disc, "gan": gan, "bsrnn_multi": multi}


# --- phase 16: BSRNN_Feats (examples/librimix/tse/v2/confs/bsrnn_feats.yaml:
# tfmap_emb + cross_multiply over ECAPA-TDNN frame features), the encoders
# ECAPA-TDNN (both layouts) and CAM++, and bin/train under WESEP_DIST ------

FEATS_CONF = os.path.join(HERE, "examples/librimix/tse/v2/confs/"
                          "bsrnn_feats.yaml")
FEATS_BATCH = 2     # the conf's batch_size 4 is 4 mixtures; 4 rows here
FEATS_STEPS = 2
FEATS_ROWS = 2 * FEATS_BATCH
ENROLL_SAMPLES = int(ENROLL_SECONDS * 16000)
# the K0 f32 shapes of its train step, 4 rows x 3 s: (T, B')
FEATS_SHAPES = {"feats_train_band": (376, 32 * FEATS_ROWS),
                "feats_train_comm": (32, 376 * FEATS_ROWS)}
# the encoders on the card against the CPU (TF32 off): embeddings and frame
# features relative L2, statistics relative to their largest
ENCODER_LIMIT, ENCODER_STATS_LIMIT = 1e-4, 1e-5
ENCODERS = (("ecapa_tpu", "ECAPA_TDNN_GLOB_c512", {}),
            ("ecapa_wespeaker", "ECAPA_TDNN_GLOB_c512",
             {"layout": "wespeaker"}),
            ("campplus", "CAMPPlus", {"pooling_func": "TSTP"}))
DDP_STEPS = 2       # phase 5's pBSRNN, 16 rows x 3 s a step
# the train-mode comparison's rows: the BatchNorm after the pooling
# normalises the embeddings over the batch's rows, and over few rows its
# single-pass variance cancels (4 rows read 7.9e-5 .. 9.3e-5 rel. L2 on an
# H100 80GB HBM3 at 700 W, against 1e-4)
ENCODER_TRAIN_ROWS = 8
# cross_att.k_proj.bias adds q . b_k to every key of a query, which the
# softmax cancels: its true gradient is zero and two correct versions give
# rounding noise, held to 1e-5 of the whole gradient's norm
FEATS_NOISE_ONLY = ("cross_att.k_proj.bias",)


def feats_conf():
    import yaml

    with open(FEATS_CONF) as f:
        return yaml.safe_load(f)


def flops_and_bytes(fn, params):
    """(operations, bytes) of fn(): the FLOPs PyTorch's counter gives for
    its products and convolutions, and the parameters read once."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops(), 4 * sum(p.numel() for p in params)


def encoder_bound_ms(flops, nbytes):
    return max(flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES) * 1e3


def check_feats_encoders():
    """Phase 16 (a): ECAPA_TDNN_GLOB_c512 (tpu and wespeaker layouts) and
    CAMPPlus at embed 192 on the card against the same module and weights on
    the CPU, on the fbank of 6 s enrollments: eval mode at 2 rows and train
    mode at ENCODER_TRAIN_ROWS (embeddings, ECAPA's frame features, the
    statistics after one train call), TF32 off; the forward ms at 2 rows and
    forward + backward ms at 4, each beside its bound."""
    from wesep_tpu_torch.models.speaker import speaker_encoder

    spk_args = feats_conf()["model_args"]["tse_model"]["spk_args"]
    gen = torch.Generator().manual_seed(SEED + 60)
    many = enroll_fbank(ENCODER_TRAIN_ROWS, gen)
    feats, small = many[:FEATS_ROWS], many[:ROWS_PER_STEP]
    many_card = many.cuda()
    feats_card, small_card = many_card[:FEATS_ROWS], many_card[:ROWS_PER_STEP]
    out = {}
    for tag, name, extra in ENCODERS:
        torch.manual_seed(SEED)
        cpu = speaker_encoder(name, dict(spk_args, **extra))
        seed_statistics(cpu)
        card = speaker_encoder(name, dict(spk_args, **extra))
        card.load_state_dict(cpu.state_dict())
        card = card.cuda()
        frames = hasattr(cpu, "frame_dim")
        res = {"name": name, **extra, "rows_eval": ROWS_PER_STEP,
               "rows_train": ENCODER_TRAIN_ROWS, "frames": ENROLL_FRAMES}
        with torch.no_grad():
            want = cpu.eval()(small)
            got = card.eval()(small_card)
            res["eval_rel_l2"] = rel_l2(got.cpu(), want)
            if frames:
                res["frame_rel_l2"] = rel_l2(
                    card(small_card, return_frame_feats=True).cpu(),
                    cpu(small, return_frame_feats=True))
            if frames:  # then both back to the seeded statistics
                state = {n: v.clone() for n, v in cpu.state_dict().items()}
                res["train_frame_rel_l2"] = rel_l2(
                    card.train()(many_card, return_frame_feats=True).cpu(),
                    cpu.train()(many, return_frame_feats=True))
                cpu.load_state_dict(state)
                card.load_state_dict(state)
            want = cpu.train()(many)
            got = card.train()(many_card)
        res["train_rel_l2"] = rel_l2(got.cpu(), want)
        stats = dict(card.named_buffers())
        res["stats_rel_err"] = max(rel_err(stats[n].cpu(), w)
                                   for n, w in cpu.named_buffers())
        params = list(card.parameters())
        card.eval()
        with torch.inference_mode():
            res["forward_ms"] = time_ms(lambda: card(small_card), 2, 10)
            flops, nbytes = flops_and_bytes(lambda: card(small_card), params)
        res["forward_bound_ms"] = encoder_bound_ms(
            flops, nbytes + 4 * (small.numel() + ROWS_PER_STEP * 192))
        card.train()

        def fwd_bwd():
            card.zero_grad(set_to_none=True)
            card(feats_card).square().mean().backward()

        torch.cuda.reset_peak_memory_stats()
        res["fwd_bwd_ms"] = time_ms(fwd_bwd, 1, 5)
        res["fwd_bwd_peak_bytes"] = torch.cuda.max_memory_allocated()
        flops, nbytes = flops_and_bytes(fwd_bwd, params)
        res["fwd_bwd_bound_ms"] = encoder_bound_ms(
            flops, 2 * nbytes + 4 * feats.numel())
        res["fwd_bwd_flops"] = flops
        out[tag] = res
        log(f"phase 16 encoder {tag} ({name}): card vs CPU rel L2 eval "
            f"{res['eval_rel_l2']:.3e}, train {res['train_rel_l2']:.3e}"
            + (f", frame features eval {res['frame_rel_l2']:.3e} train "
               f"{res['train_frame_rel_l2']:.3e}" if frames else "")
            + f" (limit {ENCODER_LIMIT}), statistics "
            f"{res['stats_rel_err']:.3e} (limit {ENCODER_STATS_LIMIT}); "
            f"forward [2 x 598] {res['forward_ms']:.3f} ms (bound "
            f"{res['forward_bound_ms']:.3f}), forward + backward [4 x 598] "
            f"{res['fwd_bwd_ms']:.3f} ms (bound {res['fwd_bwd_bound_ms']:.3f})")
        bad = [k for k in ("eval_rel_l2", "train_rel_l2", "frame_rel_l2",
                           "train_frame_rel_l2")
               if k in res and not res[k] <= ENCODER_LIMIT]
        if bad or not res["stats_rel_err"] <= ENCODER_STATS_LIMIT:
            raise AssertionError(f"encoder {tag} on the card disagrees with "
                                 f"the CPU: {bad} {res}")
        del card, cpu
    return out


def feats_model(conf, seed=SEED):
    """BSRNN_Feats at the conf's width, weights and statistics from
    `seed`."""
    from wesep_tpu_torch.models import get_model

    torch.manual_seed(seed)
    model = get_model("BSRNN_Feats")(**conf["model_args"]["tse_model"])
    seed_statistics(model, seed)
    return model


def encoder_share_ms(model, mix, enroll):
    """Device ms of the two encoder calls of a forward (the mixture's and
    the enrollment's fbank -> frame features)."""
    return time_ms(lambda: (model._frame_feats(mix),
                            model._frame_feats(enroll)), 2, 10)


def serve_bsrnn_feats(root):
    """Phase 16 (b): bsrnn_feats.yaml through bin/infer on the card, 10
    requests of 2 rows x 3 s with 6 s enrollments, f32: launch counts,
    outputs, the step's time, audio-s/s, RTF, the encoder's share; the
    kernels' forward against the plain LSTM's."""
    from wesep_tpu_torch.bin.infer import infer
    from wesep_tpu_torch.data.wav_io import read_wav
    from wesep_tpu_torch.models.common import LSTM

    tag = "serve BSRNN_Feats"
    conf = feats_conf()
    rng = np.random.default_rng(SEED + 61)
    paths, lengths = enroll_shard(root, rng, "featstest", [3.0] * 5)
    model = feats_model(conf)
    ckpt = os.path.join(root, "feats_model.ckpt")
    save_model(ckpt, model)
    exp = os.path.join(root, "exp_feats")
    per_forward = 2 * conf["model_args"]["tse_model"]["num_repeat"]
    steps = forward_steps(lengths)
    zero_counts()
    t0 = time.perf_counter()
    sisnr, sisnri = infer({
        "model": conf["model"], "model_args": conf["model_args"],
        "data_type": "shard",
        "dataset_args": {"resample_rate": 16000, "speaker_feat": False,
                         "enroll_sec": ENROLL_SECONDS},
        "exp_dir": exp, "checkpoint": ckpt, "device": "cuda",
        "length_bucket": BUCKET, "infer_batch_size": ROWS_PER_STEP,
        "test_data": paths["data"], "test_spk2utt": paths["spk2utt"],
        "test_spk1_enroll": paths["spk1_enroll"],
        "test_spk2_enroll": paths["spk2_enroll"]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"{tag}: {2 * len(lengths)} requests in {steps} forward steps, "
        f"{wall:.3f} s wall, avg SI-SNR {sisnr:.3f} dB, SI-SNRi "
        f"{sisnri:.3f} dB (random weights); launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected "
        f"{per_forward} x {steps} of the f32 chain and of the f32 "
        "projection)")
    expect_counts(counts, per_forward * steps, 0, "layer", tag, f32=True)
    audio = os.path.join(exp, "audio")
    wavs = sorted(n for n in os.listdir(audio) if n.endswith(".wav"))
    if len(wavs) != 2 * len(lengths) or not (
            math.isfinite(sisnr) and math.isfinite(sisnri)):
        raise AssertionError(f"{tag}: {len(wavs)} outputs, {sisnr}")
    for name in wavs:
        wav, _ = read_wav(os.path.join(audio, name))
        if wav.shape != (1, lengths[0]) or not np.isfinite(wav).all():
            raise AssertionError(f"{tag}: bad output {name}: {wav.shape}")

    gen = torch.Generator().manual_seed(SEED + 62)
    model = model.cuda().eval()
    mix = voices(ROWS_PER_STEP, CHUNK, gen).cuda()
    enr = voices(ROWS_PER_STEP, ENROLL_SAMPLES, gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    with torch.inference_mode():
        zero_counts()
        est = model(mix, enr)[0]
        expect_counts(read_counts(), per_forward, 0, "layer",
                      f"{tag}: one forward", f32=True)
        step_ms = time_ms(lambda: model(mix, enr), 2, 10)
        encoder_ms = encoder_share_ms(model, mix, enr)
        for m in lstms:
            m.plain = True
        est_plain = model(mix, enr)[0]
        for m in lstms:
            m.plain = False
    rel = rel_l2(est, est_plain)
    if not (torch.isfinite(est).all() and rel <= 1e-3):
        raise AssertionError(f"{tag}: kernel forward vs plain {rel}")
    summary = {"requests": 2 * len(lengths), "steps": steps, "wall_s": wall,
               "step_ms": step_ms, "audio_s_per_s": 2 * 3.0 / (step_ms / 1e3),
               "rtf": step_ms / 1e3 / 6.0, "encoder_ms": encoder_ms,
               "encoder_share": encoder_ms / step_ms,
               "rel_l2_vs_plain": rel, "launches_per_forward": per_forward}
    log(f"{tag}: forward [2 x 3 s, enrollments 2 x 6 s] {step_ms:.3f} ms/"
        f"step, {summary['audio_s_per_s']:.1f} audio-s/s, RTF "
        f"{summary['rtf']:.5f}; the encoder's two calls (ECAPA on the "
        f"mixture's and the enrollment's fbank) {encoder_ms:.3f} ms, "
        f"{100 * encoder_ms / step_ms:.1f} %; kernels vs plain LSTM rel L2 "
        f"{rel:.3e} (limit 1e-3)")
    return counts, summary


def module_event_ms(modules, fn):
    """Device ms of each named module's forward calls within one fn(), by
    CUDA events recorded by forward pre- and post-hooks."""
    events = {name: [] for name in modules}
    hooks = []
    for name, module in modules.items():
        def pre(mod, args, name=name):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events[name].append([start, None])

        def post(mod, args, out, name=name):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events[name][-1][1] = end

        hooks += [module.register_forward_pre_hook(pre),
                  module.register_forward_hook(post)]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {name: sum(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in events.items()}, {
                name: len(pairs) for name, pairs in events.items()}


def train_bsrnn_feats(root):
    """Phase 16 (c): bsrnn_feats.yaml through bin/train on the card (its
    bf16 compute and spk_model_freeze; 2 steps of 4 rows x 3 s and one
    validation step): exact f32 LSTM launches, the frozen encoder bit for
    bit while its statistics move; the whole model's f32 gradients through
    the kernels against the plain LSTM's; a step's time, peak memory and
    the encoder's and cross-attention's device ms."""
    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.common import LSTM
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    tag = "train BSRNN_Feats"
    conf = feats_conf()
    rng = np.random.default_rng(SEED + 63)
    tr, _ = enroll_shard(root, rng, "featstrain", [4.0] * FEATS_ROWS)
    va, _ = enroll_shard(root, rng, "featsdev", [3.5] * FEATS_BATCH)
    init = feats_model(conf)
    init_state = {n: v.clone() for n, v in init.state_dict().items()}
    init_path = os.path.join(root, "feats_init.ckpt")
    save_model(init_path, init)
    exp = os.path.join(root, "exp_feats_train")
    overrides = [
        f"exp_dir={exp}", "device=cuda", f"train_data={tr['data']}",
        f"train_utt2spk={tr['utt2spk']}", f"train_spk2utt={tr['spk2enroll']}",
        f"val_data={va['data']}", f"val_spk2utt={va['spk2utt']}",
        f"val_spk1_enroll={va['spk1_enroll']}",
        f"val_spk2_enroll={va['spk2_enroll']}", "num_epochs=1",
        "num_avg=1", "log_batch_interval=1",
        f"model_init.tse_model={init_path}",
        f"dataloader_args.batch_size={FEATS_BATCH}",
        f"dataset_args.sample_num_per_epoch={FEATS_STEPS * FEATS_BATCH}"]
    per_pass = 2 * conf["model_args"]["tse_model"]["num_repeat"]
    val_steps = 1
    zero_counts()
    t0 = time.perf_counter()
    state = train(FEATS_CONF, overrides=overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"{tag}: {FEATS_STEPS} steps + {val_steps} validation step through "
        f"bin/train in {wall:.3f} s wall; launches "
        f"{ {n: v for n, v in counts.items() if v} } (expected "
        f"{per_pass} f32 forwards with cs and of each f32 backward kernel a "
        f"train step, {per_pass} f32 forwards a validation step)")
    expect_counts(counts, per_pass * (FEATS_STEPS + val_steps),
                  per_pass * FEATS_STEPS, "layer", tag, f32=True)
    with open(os.path.join(exp, "train.log")) as f:
        text = f.read()
    losses = rows_loss(text)
    epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
    if len(losses) != FEATS_STEPS or len(epoch) != 1 or not all(
            math.isfinite(v) for v in losses + [float(e) for e in epoch[0]]):
        raise AssertionError(f"{tag}: losses {losses} {epoch}")
    enc = {n: p.detach().cpu() for n, p in state.model.named_parameters()
           if n.startswith("spk_model_net.")}
    kept = bool(enc) and all(torch.equal(p, init_state[n])
                             for n, p in enc.items())
    stats_moved = all(not torch.equal(b.cpu(), init_state[n])
                      for n, b in state.model.named_buffers()
                      if n.endswith((".mean", ".var")))
    rest_moved = all(not torch.equal(p.detach().cpu(), init_state[n])
                     for n, p in state.model.named_parameters()
                     if not n.startswith("spk_model_net."))
    log(f"{tag}: running mean loss per step {losses}, epoch {epoch}; "
        f"spk_model_freeze: {len(enc)} encoder parameters unchanged bit for "
        f"bit {kept}, its statistics moved {stats_moved}, every other "
        f"parameter moved {rest_moved}")
    if not (kept and stats_moved and rest_moved):
        raise AssertionError(f"{tag}: spk_model_freeze did not hold")
    del state

    # the whole model's f32 gradients through the kernels against the plain
    # LSTM's (2 rows x 3 s, 6 s enrollments)
    gen = torch.Generator().manual_seed(SEED + 64)
    model = feats_model(conf).cuda().train()
    mix = voices(ROWS_PER_STEP, CHUNK, gen).cuda()
    enr = voices(ROWS_PER_STEP, ENROLL_SAMPLES, gen).cuda()
    target = voices(ROWS_PER_STEP, CHUNK, gen).cuda()
    lstms = [m for m in model.modules() if isinstance(m, LSTM)]
    zero_counts()
    got = param_grads(model, mix, enr, target)
    grad_counts = read_counts()
    expect_counts(grad_counts, per_pass, per_pass, "layer",
                  f"{tag}: f32 gradients", f32=True)
    for m in lstms:
        m.plain = True
    want = param_grads(model, mix, enr, target)
    for m in lstms:
        m.plain = False
    total = torch.cat([g.flatten() for g in want.values()]).norm().item()
    rel = {n: rel_l2(got[n], want[n]) for n in want
           if n not in FEATS_NOISE_ONLY}
    noise = {n: (got[n] - want[n]).norm().item() / total
             for n in FEATS_NOISE_ONLY}
    worst = max(rel, key=rel.get)
    enc_worst = max((n for n in rel if n.startswith("spk_model_net.")),
                    key=rel.get)
    log(f"{tag}: gradients of {len(rel)} parameters, kernels vs plain LSTM "
        f"(f32): worst relative L2 {rel[worst]:.3e} at {worst}, the "
        f"encoder's worst {rel[enc_worst]:.3e} at {enc_worst} (limit 1e-3); "
        f"noise-only {noise} of the whole gradient's norm (limit 1e-5)")
    if not (rel[worst] <= 1e-3 and max(noise.values()) <= 1e-5):
        raise AssertionError(f"{tag}: gradients differ: {worst} {rel[worst]}"
                             f", {noise}")
    del got, want

    # a train step at the recipe's shape: 4 rows x 3 s, bf16, frozen encoder
    model = feats_model(conf).cuda()
    batch = {"wav_mix": voices(FEATS_ROWS, CHUNK, gen).cuda(),
             "wav_targets": voices(FEATS_ROWS, CHUNK, gen).cuda(),
             "spk_embeds": voices(FEATS_ROWS, ENROLL_SAMPLES, gen).cuda()}
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0,
        freeze_prefixes=("spk_model_net",))
    tstate = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"), compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(tstate, batch)
    per_step = read_counts()
    expect_counts(per_step, per_pass, per_pass, "layer",
                  f"{tag}: one train step", f32=True)
    step_ms = time_ms(lambda: step(tstate, batch), 1, 5)
    peak = torch.cuda.max_memory_allocated()
    part_ms, calls = module_event_ms(
        {"encoder": model.spk_model_net, "cross_att": model.cross_att},
        lambda: step(tstate, batch))
    wrapper_ms, timed_ms = wrapper_times(lambda: step(tstate, batch))
    lstm_ms = sum(wrapper_ms.values())
    audio = FEATS_ROWS * CHUNK / 16000.0
    log(f"{tag}: step [4 rows x 3 s, 6 s enrollments, bf16 stream, f32 "
        f"after the cross fuse] {step_ms:.3f} ms, "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; forward device ms by CUDA events: the "
        f"encoder {part_ms['encoder']:.3f} over {calls['encoder']} calls, "
        f"the cross-attention {part_ms['cross_att']:.3f} over "
        f"{calls['cross_att']}; the f32 LSTM wrappers "
        f"{ {n: round(v, 3) for n, v in wrapper_ms.items()} } ms, "
        f"{lstm_ms:.3f} in all, {100 * lstm_ms / timed_ms:.1f} % of a "
        f"{timed_ms:.3f} ms step")
    if calls["encoder"] != 2:
        raise AssertionError(f"{tag}: {calls['encoder']} encoder calls a "
                             "train step, expected 2")
    return {"main": counts, "f32_grads": grad_counts}, {
        "steps": FEATS_STEPS, "val_steps": val_steps, "wall_s": wall,
        "running_mean_loss": losses, "grad_rel_l2_worst": rel[worst],
        "encoder_grad_rel_l2_worst": rel[enc_worst],
        "noise_only_grad_err": noise,
        "step_ms": step_ms, "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "encoder_forward_ms": part_ms["encoder"],
        "cross_att_forward_ms": part_ms["cross_att"],
        "f32_lstm_wrapper_ms": wrapper_ms, "timed_step_ms": timed_ms,
        "f32_lstm_share": lstm_ms / timed_ms,
        "launches_per_step": {n: v for n, v in per_step.items() if v}}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_ddp_one_process(root):
    """Phase 16 (d): bin/train on phase 5's pBSRNN (16 rows x 3 s, bf16,
    DDP_STEPS steps and a validation step) under WESEP_DIST=1 with a
    one-process NCCL group, against the same run without WESEP_DIST: the
    losses and the final parameters and buffers equal bit for bit; the two
    runs' wall times and each step's ms (the first includes set-up)."""
    import torch.distributed as dist

    from wesep_tpu_torch.bin.train import train
    from wesep_tpu_torch.models.bsrnn import BSRNN
    from wesep_tpu_torch.train import trainer
    from wesep_tpu_torch.train.checkpoint import save_checkpoint

    tag = "bin/train under WESEP_DIST"
    make_step, steps_ms = trainer.make_train_step, []

    def timed_make_step(*args, **kw):
        """bin/train's step, each call timed by the host clock between two
        synchronisations (which change no number)."""
        step = make_step(*args, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    rng = np.random.default_rng(SEED + 65)
    tr, _ = write_shard(root, rng, "ddptrain", [4.0] * (2 * TRAIN_BATCH))
    va, _ = write_shard(root, rng, "ddpdev", [3.5] * TRAIN_BATCH)
    torch.manual_seed(SEED)
    init_path = os.path.join(root, "ddp_init.ckpt")
    save_checkpoint(init_path, [BSRNN(**V1_MODEL_ARGS).state_dict()])
    runs = {}
    for mode in ("plain", "dist"):
        config = {
            "device": "cuda", "exp_dir": os.path.join(root, f"exp_{mode}"),
            "data_type": "shard",
            "train_data": tr["data"], "train_spk_embeds": tr["spk_embeds"],
            "train_utt2spk": tr["utt2spk"],
            "val_data": va["data"], "val_spk_embeds": va["spk_embeds"],
            "val_spk1_enroll": va["spk1_enroll"],
            "val_spk2_enroll": va["spk2_enroll"],
            # no prefetch thread: the chain's draws from Python's global
            # random then come in one order in both runs
            "dataloader_args": {"batch_size": TRAIN_BATCH, "drop_last": True,
                                "prefetch_factor": 0},
            "dataset_args": {"resample_rate": 16000,
                             "sample_num_per_epoch": DDP_STEPS * TRAIN_BATCH,
                             "shuffle": True,
                             "shuffle_args": {"shuffle_size": 2500},
                             "chunk_len": CHUNK, "speaker_feat": False},
            "compute_dtype": "bfloat16", "log_batch_interval": 1,
            "loss": "SISDR", "loss_args": {},
            "model": {"tse_model": "BSRNN"},
            "model_args": {"tse_model": dict(V1_MODEL_ARGS)},
            "model_init": {"tse_model": init_path},
            "num_avg": 1, "num_epochs": 1,
            "optimizer": {"tse_model": "Adam"},
            "optimizer_args": {"tse_model": {"lr": 0.001,
                                             "weight_decay": 0.0001}},
            "clip_grad": 5.0, "save_epoch_interval": 1,
            "scheduler": {"tse_model": "ExponentialDecrease"},
            "scheduler_args": {"tse_model": {
                "final_lr": 2.5e-05, "initial_lr": 0.001,
                "warm_from_zero": False, "warm_up_epoch": 0}},
            "seed": 42,
        }
        env = {"WESEP_DIST": "1" if mode == "dist" else None,
               "WESEP_COORDINATOR": f"localhost:{free_port()}",
               "WESEP_NUM_PROCESSES": "1", "WESEP_PROCESS_ID": "0"}
        old = set_env(env)
        steps_ms.clear()
        trainer.make_train_step = timed_make_step
        try:
            t0 = time.perf_counter()
            state = train(config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            backend = dist.get_backend() if dist.is_initialized() else None
        finally:
            trainer.make_train_step = make_step
            if dist.is_initialized():
                dist.destroy_process_group()
            set_env(old)
        with open(os.path.join(config["exp_dir"], "train.log")) as f:
            text = f.read()
        meter = re.findall(r"-> (\S+) audio-s/s", text)
        runs[mode] = {"losses": rows_loss(text), "wall_s": wall,
                      "steps_ms": list(steps_ms), "backend": backend,
                      "epoch_audio_s_per_s": meter,
                      "state": {n: v.detach().cpu().clone() for n, v in
                                state.model.state_dict().items()}}
        del state
    plain, ddp = runs["plain"], runs["dist"]
    same_state = plain["state"].keys() == ddp["state"].keys() and all(
        torch.equal(v, ddp["state"][n]) for n, v in plain["state"].items())
    summary = {mode: {k: v for k, v in r.items() if k != "state"}
               for mode, r in runs.items()}
    summary["bit_for_bit"] = same_state and plain["losses"] == ddp["losses"]
    log(f"{tag}: {DDP_STEPS} steps + 1 validation step of the pBSRNN (16 "
        f"rows x 3 s, bf16) with WESEP_DIST=1 (backend {ddp['backend']}, one "
        f"process) in {ddp['wall_s']:.3f} s wall, steps "
        f"{[round(t, 3) for t in ddp['steps_ms']]} ms, losses "
        f"{ddp['losses']}; without WESEP_DIST {plain['wall_s']:.3f} s, steps "
        f"{[round(t, 3) for t in plain['steps_ms']]} ms, losses "
        f"{plain['losses']}; losses, parameters and buffers equal bit for "
        f"bit {summary['bit_for_bit']}")
    if not (summary["bit_for_bit"] and ddp["backend"] == "nccl"
            and len(ddp["losses"]) == DDP_STEPS):
        raise AssertionError(f"{tag}: the run differs from the plain run "
                             f"{summary}")
    return summary


# the data-parallel step across cards against one process on every card's
# rows (f32, TF32 off), with the limits of the CPU test
# (tests/test_torch_ddp.py). The first step starts from equal parameters:
# loss rtol 1e-6, gradient relative L2 1e-5, statistics 1e-6 of their
# largest. Its update is Adam's first, lr * g / (|g| + eps): it turns an
# element whose gradient is within rounding of zero into +-lr, so the
# parameters after it may differ by 2 lr on such elements; the elements
# that differ by more than 1e-6 must be under 1 %. Later steps start from
# those parameters: loss rtol 1e-4, gradient 2e-3, statistics 5e-4 (the CPU
# test's limits for the JAX step after such a first update); every
# parameter within 2 lr a step taken.
DDP_CARD_ROWS, DDP_CARD_STEPS = 2, 3
DDP_CARD_LIMITS = (
    {"loss_rtol": 1e-6, "grad_rel_l2": 1e-5, "stats": 1e-6,
     "params_off_share": 0.01},
    {"loss_rtol": 1e-4, "grad_rel_l2": 2e-3, "stats": 5e-4})
DDP_CARD_LR = 1e-3


def ddp_card_steps(world, rank=None):
    """DDP_CARD_STEPS f32 train steps (TF32 off) of bsrnn_feats.yaml's
    model with its spk_model_freeze, through make_train_step, on a seeded
    batch of world * DDP_CARD_ROWS rows (3 s mixtures of two sources, each
    source a row's target, 6 s enrollments), or on `rank`'s DDP_CARD_ROWS
    of them -> {"steps": for each step (loss,
    the gradient handed to the optimizer, parameters, statistics) on the
    CPU, "init": the parameters before, "last_step_ms": the last step's
    time by the host clock between synchronisations}."""
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(SEED + 66)
    rows = world * DDP_CARD_ROWS
    share = slice(None) if rank is None else slice(
        rank * DDP_CARD_ROWS, (rank + 1) * DDP_CARD_ROWS)
    # rows as the collator makes them, each mixture of two sources twice
    # with each source as the target: a target unrelated to its mixture
    # puts SI-SDR near -54 dB, where the loss magnifies the rounding of the
    # estimate's projection on the target some 500x (such rows read 5.3e-5
    # rel. L2 between the first steps' gradients on an H100)
    src = voices(rows, CHUNK, gen)
    batch = {"wav_mix": (src[0::2] + src[1::2]).repeat_interleave(2, 0),
             "wav_targets": src,
             "spk_embeds": voices(rows, ENROLL_SAMPLES, gen)}
    batch = {k: v[share].cuda() for k, v in batch.items()}
    model = feats_model(feats_conf()).cuda()
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=DDP_CARD_LR,
        final_lr=2.5e-5, warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0,
        freeze_prefixes=("spk_model_net",))
    grads, update = [], opt.update
    opt.update = lambda g: grads.append(
        {n: v.detach().cpu() for n, v in g.items()}) or update(g)
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(parse_loss("SISDR"))
    init = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    out = []
    for _ in range(DDP_CARD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        out.append((loss, grads[-1],
                    {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()},
                    {n: b.cpu().clone() for n, b in model.named_buffers()
                     if n.endswith((".mean", ".var"))}))
    return {"steps": out, "init": init, "last_step_ms": ms}


def ddp_card_rank(rank, world, port, out_dir, task, overrides=None):
    """One process of check_ddp_across_cards, on card `rank`: "steps"
    joins an NCCL group of `world` and runs ddp_card_steps; "bin_train"
    runs bin/train on bsrnn_feats.yaml under WESEP_DIST=1, which joins it
    itself. Writes its result to `out_dir`/{task}{rank}.pt."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    try:
        if task == "steps":
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{port}",
                world_size=world, rank=rank)
            result = ddp_card_steps(world, rank)
        else:
            from wesep_tpu_torch.bin.train import train

            set_env({"WESEP_DIST": "1",
                     "WESEP_COORDINATOR": f"localhost:{port}",
                     "WESEP_NUM_PROCESSES": str(world),
                     "WESEP_PROCESS_ID": str(rank)})
            state = train(FEATS_CONF, overrides=overrides)
            torch.cuda.synchronize()
            result = {"steps": state.step, "backend": dist.get_backend(),
                      "state": {n: v.detach().cpu() for n, v in
                                state.model.state_dict().items()}}
        torch.save(result, os.path.join(out_dir, f"{task}{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world, out_dir, task, overrides=None, limit=600):
    """ddp_card_rank in `world` spawned processes, one a card; every
    process is ended by `limit` s -> each rank's result."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=ddp_card_rank,
                         args=(rank, world, port, out_dir, task, overrides))
             for rank in range(world)]
    deadline = time.monotonic() + limit
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{task} across {world} cards: exit codes "
                             f"{codes}")
    return [torch.load(os.path.join(out_dir, f"{task}{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def ddp_step_errors(got, want, init):
    """One rank's steps against the one process's -> for each step its
    errors by the measures of DDP_CARD_LIMITS, each beside the parameter it
    is worst at, and every parameter's largest difference ("params_max",
    held to 2 lr a step taken)."""
    out = []
    for i, ((loss, grads, new, stats),
            (w_loss, w_grads, w_new, w_stats)) in enumerate(zip(got, want)):
        num = sum(float((grads[n] - g).square().sum())
                  for n, g in w_grads.items())
        den = sum(float(g.square().sum()) for g in w_grads.values())
        stat = {n: float((stats[n] - w).abs().max())
                / max(float(w.abs().max()), 1.0) for n, w in w_stats.items()}
        diff = {n: (new[n] - w).abs() for n, w in w_new.items()}
        worst_p = max(diff, key=lambda n: float(diff[n].max()))
        err = {"loss_rtol": abs(loss - w_loss) / abs(w_loss),
               "grad_rel_l2": (num / den) ** 0.5,
               "stats": max(stat.values()),
               "stats_worst_at": max(stat, key=stat.get),
               "params_max": float(diff[worst_p].max()),
               "params_max_at": worst_p,
               "params_max_limit": 2 * DDP_CARD_LR * (i + 1)}
        if i == 0:
            off = sum(int((d > 1e-6).sum()) for d in diff.values())
            err["params_off_share"] = off / sum(d.numel()
                                                for d in diff.values())
        out.append(err)
    return out


def ddp_errors_ok(errs):
    """Every step's errors within DDP_CARD_LIMITS (the first step's, then
    the later steps')."""
    return all(
        e[k] <= v for i, e in enumerate(errs)
        for k, v in DDP_CARD_LIMITS[min(i, 1)].items()) and all(
        e["params_max"] <= e["params_max_limit"] for e in errs)


def check_ddp_across_cards(world):
    """Phase 16 (e), with `world` >= 2 cards of one host: (i)
    make_train_step under DistributedDataParallel over an NCCL group of
    `world` processes, one a card, DDP_CARD_ROWS rows each, against one
    process on all their rows (ddp_card_steps, f32, TF32 off): every
    rank's loss, gradient, statistics and parameters at every step within
    DDP_CARD_LIMITS, the ranks' parameters and statistics bit for bit;
    (ii) bin/train on bsrnn_feats.yaml (bf16, FEATS_STEPS steps a rank)
    under WESEP_DIST=1 across the cards: the ranks end equal bit for bit,
    only rank 0 writes the log and checkpoints."""
    tag = f"DDP across {world} cards"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        ranks = run_ranks(world, root, "steps")
        ranks_wall = time.perf_counter() - t0
        one = ddp_card_steps(world)
        errs = [ddp_step_errors(r["steps"], one["steps"], one["init"])
                for r in ranks]
        last = ranks[0]["steps"][-1]
        equal = all(
            all(torch.equal(v, r["steps"][-1][part][n])
                for part in (2, 3) for n, v in last[part].items())
            for r in ranks[1:])
        losses = [round(s[0], 6) for s in one["steps"]]
        log(f"{tag}: {DDP_CARD_STEPS} f32 steps of BSRNN_Feats "
            f"({DDP_CARD_ROWS} rows x 3 s a card, NCCL, {ranks_wall:.1f} s "
            f"wall with spawn and set-up) against one process on "
            f"{world * DDP_CARD_ROWS} rows: losses {losses}; ranks bit for "
            f"bit {equal}; last step {ranks[0]['last_step_ms']:.3f} ms a "
            f"rank, {one['last_step_ms']:.3f} ms in one process")
        for rank, e in enumerate(errs):
            log(f"{tag}: rank {rank} against the one process, by step "
                f"{json.dumps(e)} (limits {DDP_CARD_LIMITS})")
        if not (equal and all(ddp_errors_ok(e) for e in errs)):
            raise AssertionError(f"{tag}: the DDP steps differ from the one "
                                 f"process: {errs}, ranks equal {equal}")

        rng = np.random.default_rng(SEED + 67)
        tr, _ = enroll_shard(root, rng, "ddptrain", [4.0] * FEATS_ROWS)
        va, _ = enroll_shard(root, rng, "ddpdev", [3.5] * FEATS_BATCH)
        exp = os.path.join(root, "exp_ddp_cards")
        overrides = [
            f"exp_dir={exp}", "device=cuda", f"train_data={tr['data']}",
            f"train_utt2spk={tr['utt2spk']}",
            f"train_spk2utt={tr['spk2enroll']}",
            f"val_data={va['data']}", f"val_spk2utt={va['spk2utt']}",
            f"val_spk1_enroll={va['spk1_enroll']}",
            f"val_spk2_enroll={va['spk2_enroll']}", "num_epochs=1",
            "num_avg=1", "log_batch_interval=1",
            f"dataloader_args.batch_size={FEATS_BATCH}",
            "dataset_args.sample_num_per_epoch="
            f"{FEATS_STEPS * FEATS_BATCH * world}"]
        t0 = time.perf_counter()
        runs = run_ranks(world, root, "bin_train", overrides)
        bin_wall = time.perf_counter() - t0
        state0 = runs[0]["state"]
        same = all(torch.equal(v, r["state"][n])
                   for r in runs[1:] for n, v in state0.items())
        logs = sorted(n for n in os.listdir(exp) if n.startswith("train.log"))
        models = sorted(os.listdir(os.path.join(exp, "models")))
        steps = [r["steps"] for r in runs]
        log(f"{tag}: bin/train on bsrnn_feats.yaml under WESEP_DIST=1 "
            f"(backend {runs[0]['backend']}): steps a rank {steps}, "
            f"{bin_wall:.1f} s wall with spawn and set-up; the ranks' "
            f"parameters and buffers equal bit for bit {same}; logs {logs}, "
            f"checkpoints {models}")
        if not (same and steps == [FEATS_STEPS] * world
                and runs[0]["backend"] == "nccl" and logs == ["train.log"]
                and "checkpoint_1.ckpt" in models):
            raise AssertionError(f"{tag}: bin/train under WESEP_DIST: steps "
                                 f"{steps}, equal {same}, {logs}, {models}")
    return {"world": world, "rows_a_card": DDP_CARD_ROWS,
            "steps": DDP_CARD_STEPS, "losses": losses, "errors": errs,
            "limits": DDP_CARD_LIMITS, "ranks_bit_for_bit": equal,
            "last_step_ms_rank": ranks[0]["last_step_ms"],
            "last_step_ms_one_process": one["last_step_ms"],
            "bin_train": {"steps": steps, "bit_for_bit": same,
                          "wall_s": bin_wall}}


def phase16():
    """Phase 16 whole: (a) the encoders, (b) BSRNN_Feats served, (c)
    trained, (d) bin/train under WESEP_DIST in one process, (e) with 2 or
    more cards, DDP across up to 4 of them; -> (launches by path,
    summary)."""
    t0 = time.perf_counter()
    encoders = check_feats_encoders()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_launches, served = serve_bsrnn_feats(root)
    log("serve BSRNN_Feats summary", json.dumps(served))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        train_launches, trained = train_bsrnn_feats(root)
    log("train BSRNN_Feats summary", json.dumps(trained))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        ddp = check_ddp_one_process(root)
    cards = torch.cuda.device_count()
    if cards >= 2:
        ddp_cards = check_ddp_across_cards(min(cards, 4))
    else:
        ddp_cards = None
        log("phase 16 (e), DDP across cards, needs 2 or more cards: "
            "python3 chip_smoke.py --only-ddp on a machine that has them")
    log(f"phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"bsrnn_feats_serve": serve_launches,
            "bsrnn_feats_train": train_launches["main"],
            "bsrnn_feats_f32_grads": train_launches["f32_grads"]}, {
        "encoders": encoders, "serve": served, "train": trained,
        "ddp": ddp, "ddp_cards": ddp_cards}


# Phase 17: online mixing and the simulation on the card
# (examples/voxceleb1/v2/confs/bsrnn_online.yaml: the joint ResNet34 BSRNN at
# feature_dim 128, 6 repeats; 8 mixtures x 2 speakers x 3 s a step)
ONLINE_CONF = os.path.join(HERE, "examples/voxceleb1/v2/confs/"
                                 "bsrnn_online.yaml")
ONLINE_STEPS = 2
ONLINE_SPEAKERS, ONLINE_UTTS = 8, 3   # utterances of 4-6 s per speaker
# the card against the CPU on the same draws: RIRs by relative L2, the
# mixtures and targets relative to their largest value (cuFFT against
# pocketfft, cuDNN's FIR against the CPU's)
AUG_LIMIT = 1e-4


def online_conf():
    import yaml

    with open(ONLINE_CONF) as f:
        return yaml.safe_load(f)


def augment_bound(batch, n_spk, samples, cfg, n_img):
    """(ms, "bytes" or "operations") of the least time the card could take
    for the simulation of a batch: the sources, noise and draws read once,
    the mixture and targets written once; the operations of its three FFTs
    a row (real, 2.5 n log2 n each, and the spectra's product) and its FIR
    (taps x outputs a row)."""
    rows = batch * n_spk
    rir_len = int(math.ceil(cfg.sr * cfg.rt60[1]))
    n = 2 ** int(math.ceil(math.log2(samples + rir_len - 1)))
    taps = 32 * cfg.oversample + 1
    flops = rows * (3 * 2.5 * n * math.log2(n) + 6 * (n // 2 + 1)
                    + 2 * taps * rir_len)
    nbytes = 4 * (2 * rows * samples + 2 * batch * samples
                  + 2 * rows * n_img)
    t_flops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return max(t_flops, t_bytes) * 1e3, (
        "operations" if t_flops >= t_bytes else "bytes")


def check_augment():
    """Phase 17 (a): the simulation of a batch of the conf (8 mixtures x 2
    sources x 3 s, reverb 0.5, random SNRs, noise 0.5) on the card against
    the same call on the CPU on the same draws, the taps whose integer
    delay moved between the two, a repeat with the same generator state bit
    for bit, and its time by CUDA events beside its bound."""
    from wesep_tpu_torch.bin.train import augment_config
    from wesep_tpu_torch.data import augment

    conf = online_conf()
    da = conf["dataset_args"]
    aug = augment_config(da)
    b, s, t = conf["dataloader_args"]["batch_size"], da["num_speakers"], \
        da["chunk_len"]
    cfg = augment.RirConfig(sr=aug["sample_rate"], num_src=s)
    gen = torch.Generator().manual_seed(SEED + 70)
    srcs = voices(b * s, t, gen).view(b, s, t)
    noise = 0.05 * torch.randn(b, t, generator=gen)

    def draws_on(device):
        return augment.draw_augment(
            augment.step_generator(42, 0, 0, device), b, s, cfg,
            aug["reverb_prob"], aug["use_random_snr"], aug["noise_prob"],
            tuple(aug["noise_snr"]))

    def run(draws, x, n):
        return augment.augment_batch(x, draws, n, cfg, aug["reverb_prob"],
                                     aug["noise_prob"])

    def to(draws, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in draws.items()}

    def leaves(draws):
        return [t for k in sorted(draws) for t in (
            leaves(draws[k]) if isinstance(draws[k], dict) else [draws[k]])]

    draws = draws_on("cuda")
    card = run(draws, srcs.cuda(), noise.cuda())
    torch.cuda.synchronize()
    host_draws = to(draws, "cpu")
    host = run(host_draws, srcs, noise)
    rir_card = augment.sample_rirs(draws["rir"], cfg)[0].cpu()
    rir_host = augment.sample_rirs(host_draws["rir"], cfg)[0]
    rir_err = rel_l2(rir_card, rir_host)
    delay_card = augment.image_taps(draws["rir"], cfg)[0].cpu()
    delay_host = augment.image_taps(host_draws["rir"], cfg)[0]
    moved = int((delay_card.floor() != delay_host.floor()).sum())
    mix_err = rel_err(card[0].cpu(), host[0])
    tgt_err = rel_err(card[1].cpu(), host[1])
    again_draws = draws_on("cuda")
    again = run(again_draws, srcs.cuda(), noise.cuda())
    repeats = all(torch.equal(x, y) for x, y in zip(card, again)) and all(
        torch.equal(x, y) for x, y in zip(leaves(draws), leaves(again_draws)))
    reverbed = int((draws["reverb_coin"] < aug["reverb_prob"]).sum())
    noised = int((draws["noise_coin"] < aug["noise_prob"]).sum())
    x, n = srcs.cuda(), noise.cuda()
    ms = time_ms(lambda: run(draws_on("cuda"), x, n), warmup=2, runs=10)
    parts = {
        "draws": time_ms(lambda: draws_on("cuda"), 2, 10),
        "sample_rirs": time_ms(
            lambda: augment.sample_rirs(draws["rir"], cfg), 2, 10),
        "reverberate": time_ms(lambda: augment.reverberate(
            x, rir_card.cuda(), draws["reverb_coin"], aug["reverb_prob"]),
            2, 10),
        "snr_mix": time_ms(lambda: augment.snr_mix(x, draws["snr"]), 2, 10),
        "add_noise": time_ms(lambda: augment.add_noise_snr(
            card[0], n, draws["noise_snr"], draws["noise_coin"],
            aug["noise_prob"]), 2, 10)}
    bound_ms, bound_by = augment_bound(b, s, t, cfg, cfg.n_image[1])
    log(f"augment [{b} x {s} x {t}, reverb {aug['reverb_prob']} "
        f"({reverbed} of {b * s} sources), noise {aug['noise_prob']} "
        f"({noised} of {b}), random SNR {aug['use_random_snr']}]: card vs "
        f"CPU on the same draws: RIR rel. L2 {rir_err:.3e} (limit "
        f"{AUG_LIMIT}), taps moved {moved} of {delay_card.numel()}, mixture "
        f"{mix_err:.3e}, targets {tgt_err:.3e} of the largest (limit "
        f"{AUG_LIMIT}); repeat bit for bit {repeats}; {ms:.3f} ms a batch "
        f"with its draws (parts {json.dumps({k: round(v, 3) for k, v in parts.items()})} "
        f"ms), bound {bound_ms:.4f} ms ({bound_by})")
    if not (rir_err <= AUG_LIMIT and mix_err <= AUG_LIMIT
            and tgt_err <= AUG_LIMIT and repeats):
        raise AssertionError("the simulation on the card is wrong")
    return {"rir_rel_l2": rir_err, "taps_moved": moved,
            "taps": delay_card.numel(), "mix_err": mix_err,
            "targets_err": tgt_err, "repeats_bit_for_bit": repeats,
            "reverberated": reverbed, "noised": noised, "ms": ms, "parts_ms": parts, "bound_ms": bound_ms,
            "bound_by": bound_by}


def write_single_speaker_shard(root, rng, name):
    """ONLINE_SPEAKERS x ONLINE_UTTS single-speaker utterances of 4-6 s as a
    shard (`name`.tar, {key}.wav + {key}.spk) with its list and utt2spk,
    and spk2enroll.json naming each speaker's own wavs as its
    enrollments."""
    from wesep_tpu_torch.data.wav_io import wav_bytes, write_wav

    tar_path = os.path.join(root, f"{name}.tar")
    os.makedirs(os.path.join(root, f"{name}_wav"), exist_ok=True)
    spk2enroll, utt2spk = {}, {}
    with tarfile.open(tar_path, "w") as tar:
        for u in range(ONLINE_UTTS):
            for k in range(ONLINE_SPEAKERS):
                spk, key = f"{name}_spk{k}", f"{name}_spk{k}_u{u}"
                n = int(rng.uniform(4.0, 6.0) * 16000)
                t = np.arange(n) / 16000.0
                f0 = 90 + 20 * k
                wav = 0.1 * sum(np.sin(2 * np.pi * f0 * h * t
                                       + rng.uniform(0, 6)) / h
                                for h in range(1, 6))
                wav = (wav + 0.02 * rng.standard_normal(n)).astype(np.float32)
                path = os.path.join(root, f"{name}_wav", key + ".wav")
                write_wav(path, wav, 16000)
                spk2enroll.setdefault(spk, []).append([key, path])
                utt2spk[key] = spk
                for member, data in ((f"{key}.spk", spk.encode()),
                                     (f"{key}.wav", wav_bytes(wav, 16000))):
                    info = tarfile.TarInfo(member)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    paths = {"data": os.path.join(root, f"{name}.list"),
             "utt2spk": os.path.join(root, f"{name}.utt2spk"),
             "spk2enroll": os.path.join(root, f"{name}_spk2enroll.json")}
    with open(paths["data"], "w") as f:
        f.write(tar_path + "\n")
    with open(paths["utt2spk"], "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in utt2spk.items())
    with open(paths["spk2enroll"], "w") as f:
        json.dump(spk2enroll, f)
    return paths


def write_noise_pack(root, rng):
    """A noise store of synthetic MUSAN-like wavs (noise_*, music_* at 22.05
    kHz, speech_* in two channels), built by the port's make_noise_db."""
    from wesep_tpu_torch.data.wav_io import write_wav
    from wesep_tpu_torch.tools import make_noise_db

    lines = []
    for i, (kind, sr, ch, seconds) in enumerate((
            ("noise", 16000, 1, 8.0), ("noise", 16000, 1, 1.5),
            ("music", 22050, 1, 10.0), ("speech", 16000, 2, 7.0))):
        n = int(sr * seconds)
        wav = rng.standard_normal((ch, n)) * 0.05
        if kind == "music":
            wav += 0.1 * np.sin(2 * np.pi * 440 * np.arange(n) / sr)
        path = os.path.join(root, f"{kind}_{i}.wav")
        write_wav(path, wav.astype(np.float32), sr)
        lines.append(f"{kind}_{i} {path}\n")
    scp = os.path.join(root, "noise.scp")
    with open(scp, "w") as f:
        f.writelines(lines)
    pack = os.path.join(root, "noise.pack")
    make_noise_db.main([scp, pack])
    return pack


def augment_times(fn):
    """Device ms of the simulation's calls (its draws and augment_batch)
    within one fn(), by CUDA events around each, and of the whole fn()."""
    from wesep_tpu_torch.data import augment

    spent, saved = [], {}
    for name in ("draw_augment", "augment_batch"):
        real = saved[name] = getattr(augment, name)

        def timed(*args, real=real, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kw)
            end.record()
            spent.append((start, end))
            return out

        setattr(augment, name, timed)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        for name, real in saved.items():
            setattr(augment, name, real)
    return sum(s.elapsed_time(e) for s, e in spent), start.elapsed_time(end)


def host_chain_rate(tr, conf, pack, device_augment, batches):
    """audio-s/s of target rows the train chain of the conf gives in one
    thread (decode, chunk, pairing, noise and, on the host path, reverb and
    mixing; the enrollments' fbank; the collate), over `batches` batches
    after one, with a buffer of two batches' utterances."""
    from wesep_tpu_torch.data import (
        BatchLoader,
        Dataset,
        tse_collate_fn,
        tse_collate_fn_device,
    )
    from wesep_tpu_torch.utils.file_utils import read_spk2enroll_json

    da = dict(conf["dataset_args"])
    b = conf["dataloader_args"]["batch_size"]
    da["online_buffer_size"] = 2 * b
    spk2enroll, _ = read_spk2enroll_json(tr["spk2enroll"])
    chain = Dataset("shard", tr["data"], da, spk2enroll, state="train",
                    joint_training=True, repeat_dataset=True,
                    noise_prob=da["noise_prob"], reverb_prob=da["reverb_prob"],
                    noise_lmdb_file=pack, online_mix=True,
                    device_augment=device_augment)
    collate = tse_collate_fn_device if device_augment else tse_collate_fn
    loader = BatchLoader(chain, batch_size=b, prefetch=0,
                         collate_fn=lambda x: collate(
                             x, fixed_enroll_len=ENROLL_FRAMES))
    loader.set_epoch(1)
    audio = 0.0
    for i, batch in enumerate(loader):
        if i == 0:
            t0 = time.perf_counter()
            continue
        audio += da["num_speakers"] * b * da["chunk_len"] / 16000.0
        if i == batches:
            break
    return audio / (time.perf_counter() - t0)


def train_online(root):
    """Phase 17 (b), (c): bsrnn_online.yaml through bin/train on the card
    (bf16 compute; the separator f32 after the fuse), data paths overridden
    to synthetic single-speaker shards, a noise pack and a premixed
    validation shard: 2 steps of 8 mixtures and a validation step with the
    simulation on the card, then one step with device_augment false (the
    host simulates); exact f32 LSTM launches, finite losses, the epoch's
    audio-s/s; a step's time, peak memory and the simulation's share; the
    host chain's audio-s/s on both paths."""
    from wesep_tpu_torch.bin.train import augment_config, train
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    tag = "train online BSRNN"
    conf = online_conf()
    b = conf["dataloader_args"]["batch_size"]
    n_spk, samples = conf["dataset_args"]["num_speakers"], \
        conf["dataset_args"]["chunk_len"]
    rng = np.random.default_rng(SEED + 71)
    tr = write_single_speaker_shard(root, rng, "onlinetrain")
    va, _ = enroll_shard(root, rng, "onlinedev", [3.5] * b)
    pack = write_noise_pack(root, rng)
    per_pass = 2 * conf["model_args"]["tse_model"]["num_repeat"]

    def run(name, steps, extra=()):
        exp = os.path.join(root, name)
        overrides = [
            f"exp_dir={exp}", "device=cuda", f"train_data={tr['data']}",
            f"train_utt2spk={tr['utt2spk']}",
            f"train_spk2utt={tr['spk2enroll']}", f"val_data={va['data']}",
            f"val_spk2utt={va['spk2utt']}",
            f"val_spk1_enroll={va['spk1_enroll']}",
            f"val_spk2_enroll={va['spk2_enroll']}", "num_epochs=1",
            "num_avg=1", "log_batch_interval=1",
            f"dataset_args.noise_lmdb_file={pack}",
            f"dataset_args.sample_num_per_epoch={steps * b}", *extra]
        zero_counts()
        t0 = time.perf_counter()
        state = train(ONLINE_CONF, overrides=overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(counts, per_pass * (steps + 1), per_pass * steps,
                      "layer", f"{tag} ({name})", f32=True)
        with open(os.path.join(exp, "train.log")) as f:
            text = f.read()
        losses = rows_loss(text)
        epoch = re.findall(r"Epoch 1 train_loss (\S+) val_loss (\S+)", text)
        meter = [float(v) for v in re.findall(r"-> (\S+) audio-s/s", text)]
        if len(losses) != steps or len(epoch) != 1 or not all(
                math.isfinite(v) for v in losses + [float(e)
                                                    for e in epoch[0]]) \
                or not meter or meter[0] <= 0:
            raise AssertionError(f"{tag} ({name}): losses {losses} {epoch}, "
                                 f"throughput {meter}")
        log(f"{tag} ({name}): {steps} steps + 1 validation step through "
            f"bin/train in {wall:.3f} s wall; launches "
            f"{ {n: v for n, v in counts.items() if v} } (expected "
            f"{per_pass} f32 forwards with cs and of each f32 backward "
            f"kernel a train step, {per_pass} f32 forwards a validation "
            f"step); running mean loss per step {losses}, epoch {epoch}, "
            f"the epoch's {meter[0]} audio-s/s")
        return state, counts, {"wall_s": wall, "running_mean_loss": losses,
                               "epoch": epoch, "epoch_audio_s_per_s": meter}

    state, counts, device_run = run("exp_online", ONLINE_STEPS)

    # a step at the recipe's size: 8 mixtures x 2 x 3 s, their noise chunks
    # and the 16 rows' fbank cues; its time, peak memory, launches and the
    # simulation's share
    gen = torch.Generator().manual_seed(SEED + 72)
    model = state.model
    del state
    batch = {"wav_srcs": voices(b * n_spk, samples, gen).view(
                 b, n_spk, samples).cuda(),
             "wav_noise": (0.05 * torch.randn(b, samples,
                                              generator=gen)).cuda(),
             "spk_embeds": enroll_fbank(b * n_spk, gen).cuda()}
    opt = make_optimizer(model, exponential_decrease(
        num_epochs=1, epoch_iter=100, initial_lr=1e-3, final_lr=2.5e-5,
        warm_up_epoch=0), weight_decay=1e-4, clip_grad=5.0)
    tstate = TrainState(model=model, optimizer=opt, step=ONLINE_STEPS)
    step = make_train_step(
        parse_loss("SISDR"), compute_dtype=torch.bfloat16, seed=42,
        device_augment=augment_config(conf["dataset_args"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(tstate, batch)
    per_step = read_counts()
    expect_counts(per_step, per_pass, per_pass, "layer",
                  f"{tag}: one train step", f32=True)
    step_ms = time_ms(lambda: step(tstate, batch), warmup=1, runs=5)
    peak = torch.cuda.max_memory_allocated()
    aug_ms, timed_ms = augment_times(lambda: step(tstate, batch))
    audio = b * n_spk * samples / 16000.0
    log(f"{tag}: step [{b} mixtures x {n_spk} x 3 s simulated on the card, "
        f"bf16 stream, f32 after the fuse] {step_ms:.3f} ms, "
        f"{audio / (step_ms / 1e3):.1f} audio-s/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; the simulation (draws + augment_batch) "
        f"{aug_ms:.3f} ms of a {timed_ms:.3f} ms step, "
        f"{100 * aug_ms / timed_ms:.2f} %")
    del model, tstate, opt, step, batch
    torch.cuda.empty_cache()

    # (c) one step with the host simulating (the reference's path)
    state, host_counts, host_run = run("exp_online_host", 1,
                                       ["dataset_args.device_augment=false"])
    del state
    torch.cuda.empty_cache()
    rates = {"device": host_chain_rate(tr, conf, pack, True, 4),
             "host": host_chain_rate(tr, conf, pack, False, 2)}
    log(f"{tag}: host chain (one thread, buffer of {2 * b} utterances) "
        f"audio-s/s of target rows: device path {rates['device']:.1f}, host "
        f"path (per-sample FRAM-RIR, scipy convolution) {rates['host']:.1f}; "
        f"the step consumes {audio / (step_ms / 1e3):.1f}")
    return {"online_train": counts, "online_host_train": host_counts}, {
        "device_run": device_run, "host_run": host_run,
        "step_ms": step_ms, "audio_s_per_s": audio / (step_ms / 1e3),
        "peak_memory_bytes": peak, "augment_ms_in_step": aug_ms,
        "timed_step_ms": timed_ms, "augment_share": aug_ms / timed_ms,
        "host_chain_audio_s_per_s": rates,
        "launches_per_step": {n: v for n, v in per_step.items() if v}}


def phase17():
    """Phase 17 whole: (a) the simulation on the card against the CPU, (b)
    bsrnn_online.yaml through bin/train with it, (c) with device_augment
    false, and the host chain on both paths; -> (launches by path,
    summary)."""
    t0 = time.perf_counter()
    augmented = check_augment()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches, trained = train_online(root)
    log("phase 17 summary", json.dumps({"augment": augmented,
                                        "train": trained}))
    log(f"phase 17 in {time.perf_counter() - t0:.1f} s")
    return launches, {"augment": augmented, "train": trained}


def phase17_only() -> int:
    """`--only-phase17`: phases 1 and 2 and phase 17; no final line."""
    from wesep_tpu_torch.ops import _build

    log(card_line())
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build in {time.perf_counter() - t0:.2f} s")
    launches, _ = phase17()
    log("phase 17 launches", json.dumps(launches))
    log(f"wall {time.perf_counter() - t0:.1f} s")
    log(card_line())
    return 0


def feats_kernel_cases():
    """Phase 3's f32 K0 cases at BSRNN_Feats' train shapes (4 rows x 3 s):
    the forward with cs, and the backward (the old FMA kernels, which no
    recipe runs at these shapes, neither held nor timed)."""
    forward = [check_f32_forward("layer", name, t_len, batch, with_cs=True,
                                 old=False)
               for name, (t_len, batch) in FEATS_SHAPES.items()]
    backward = [check_f32_backward("layer", name, t_len, batch, old=False)
                for name, (t_len, batch) in FEATS_SHAPES.items()]
    return forward, backward


def phase16_only() -> int:
    """`--only-phase16`: phases 1 and 2, phase 3's f32 K0 / K0b cases at
    BSRNN_Feats' train shapes, and phase 16; no final line."""
    from wesep_tpu_torch.ops import _build

    log(card_line())
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build in {time.perf_counter() - t0:.2f} s")
    feats_kernel_cases()
    launches, summary = phase16()
    log("phase 16 launches", json.dumps(launches))
    log(f"wall {time.perf_counter() - t0:.1f} s")
    log(card_line())
    return 0


def ddp_only() -> int:
    """`--only-ddp` (2 or more cards): phases 1 and 2 and phase 16 (e), DDP
    across up to 4 cards; no final line."""
    from wesep_tpu_torch.ops import _build

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_smoke --only-ddp: {cards} card, 2 or more needed",
              file=sys.stderr)
        return 1
    log(card_line())
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build in {time.perf_counter() - t0:.2f} s")
    log("phase 16 (e) summary", json.dumps(
        check_ddp_across_cards(min(cards, 4))))
    log(f"wall {time.perf_counter() - t0:.1f} s")
    log(card_line())
    return 0


# (rows, dtype) of phase 3's K5/K5b cases: DPCCN serving (f32), training
# (bf16), and the MetricGAN step (f32, which dpcc_init_gan.yaml runs)
CONV_CASES = ((ROWS_PER_STEP, torch.float32),
              (2 * DPCCN_BATCH, torch.bfloat16),
              (GAN_BATCH, torch.float32), (2 * GAN_BATCH, torch.float32))


def phase15_only() -> int:
    """`--only-phase15`: phases 1 and 2, phase 3's f32 K5/K5b cases at the
    MetricGAN step's rows, and phase 15; no final line."""
    from wesep_tpu_torch.ops import _build

    log(card_line())
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build in {time.perf_counter() - t0:.2f} s")
    for batch in (GAN_BATCH, 2 * GAN_BATCH):
        for name, f, ci, co in CONV_SHAPES:
            check_conv2d(name, f, ci, co, batch, torch.float32)
    launches, summary = phase15()
    log("phase 15 launches", json.dumps(launches))
    log(f"wall {time.perf_counter() - t0:.1f} s")
    log(card_line())
    return 0


def conv2d_only() -> int:
    """`--only-conv2d`: phases 1 and 2 for the Conv2dBlock's sources and
    phase 3's K5/K5b cases and batch-slice case, printed one JSON line each;
    no path is driven and no final line is printed."""
    from wesep_tpu_torch.ops import _build

    log(card_line())
    libs = _build.build_all(("conv2d_block", "conv2d_block_bwd"))
    for lib in libs.values():
        with open(lib + ".log") as f:
            log(f.read().strip())
    for batch, dtype in CONV_CASES:
        for name, f, ci, co in CONV_SHAPES:
            check_conv2d(name, f, ci, co, batch, dtype)
    log(card_line())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from wesep_tpu_torch.ops import _build

    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name):
        """The wall time since the previous lap, added under `name`."""
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - last[0]
        last[0] = now

    # numbers are compared in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--only-conv2d"]:
        return conv2d_only()
    if sys.argv[1:] == ["--only-phase15"]:
        return phase15_only()
    if sys.argv[1:] == ["--only-phase16"]:
        return phase16_only()
    if sys.argv[1:] == ["--only-ddp"]:
        return ddp_only()
    if sys.argv[1:] == ["--only-phase17"]:
        return phase17_only()

    # 1. device
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(card)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {', '.join(n + '.cu' for n in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        with open(lib + ".log") as f:
            log(f.read().strip())

    lap("1-2 device, build")
    # 3. kernels against their plain versions
    cases = [check_kernel(name, t_len, batch, dtype)
             for name, (t_len, batch) in MAIN_SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)]
    train_cases = [check_training_kernels(name, t_len, batch, dtype)
                   for name, (t_len, batch) in TRAIN_SHAPES.items()
                   for dtype in (torch.float32, torch.bfloat16)]
    tcn_cases = [check_tcn(name, batch, dtype, dilation)
                 for name, batch in (("spex_serve", ROWS_PER_STEP),
                                     ("spex_train", 2 * TRAIN_BATCH))
                 for dtype in (torch.float32, torch.bfloat16)
                 for dilation in (1, 128)]
    fused_cases = [check_fused_tcn_block(dtype)
                   for dtype in (torch.float32, torch.bfloat16)]
    # the unfold-fused layer at TF-GridNet's four shapes, and once at hs 2
    unfold_cases = [check_unfold_kernels(name, rows, length, dtype)
                    for name, (rows, length) in UNFOLD_SHAPES.items()
                    for dtype in (torch.float32, torch.bfloat16)]
    unfold_cases.append(check_unfold_kernels(
        "train_intra_hs2", *UNFOLD_SHAPES["train_intra"], torch.float32,
        hs=2))
    # the plain layer at TF-GridNet's materialised shapes (D = H = 192),
    # where the default route runs it: serving in f32, training in bf16
    grid_d = GRID_KS * GRID_C
    for name, (rows, length) in UNFOLD_SHAPES.items():
        frames = length - GRID_KS + 1
        if name.startswith("serve"):
            cases.append(check_kernel("grid_" + name, frames, rows,
                                      torch.float32, grid_d, GRID_H))
        else:
            train_cases.append(check_training_kernels(
                "grid_" + name[len("train_"):], frames, rows,
                torch.bfloat16, grid_d, GRID_H))
    # the joint v2 TF-GridNet trains its BiLSTMs in f32 (the promotion
    # after the fuse) at the conf's 4 rows x 3 s: K0 with cs and K0b over
    # the materialised frames (its default route), K3/K3b on
    # WESEP_LSTM_UNFOLD=1
    for name, (rows, length) in V2_GRID_SHAPES.items():
        train_cases.append(check_training_kernels(
            "grid_" + name, length - GRID_KS + 1, rows, torch.float32,
            grid_d, GRID_H))
        unfold_cases.append(check_unfold_kernels(name, rows, length,
                                                 torch.float32))

    # the two-kernel layers at the pBSRNN's shapes, both directions (K2)
    # and one (K1): the forward at the serving shapes in f32, the forward,
    # serial adjoint and weight gradients at the training shapes in bf16
    two_kernel_cases = [
        check_fused_kernels(name, t_len, batch, dtype, dirs, train)
        for shapes, dtype, train in ((MAIN_SHAPES, torch.float32, False),
                                     (TRAIN_SHAPES, torch.bfloat16, True))
        for name, (t_len, batch) in shapes.items() for dirs in (2, 1)]

    # the tensor-core backward of every LSTM route at its training shapes
    # (bf16): the pBSRNN's band and comm on K0, K2 and K1; TF-GridNet's
    # intra and inter on K3 and on K0 over the materialised frames
    tc_cases = [check_tc_backward(route, "train_" + name, t_len, batch)
                for route in ("layer", "two_kernel", "unidirectional")
                for name, (t_len, batch) in TRAIN_SHAPES.items()]
    for name, (rows, length) in UNFOLD_SHAPES.items():
        if name.startswith("train"):
            tc_cases.append(check_tc_backward(
                "unfold", name, None, rows, grid_d, GRID_H, length=length))
            tc_cases.append(check_tc_backward(
                "layer", "train_grid_" + name[len("train_"):],
                length - GRID_KS + 1, rows, grid_d, GRID_H))

    # the tensor-core forward of every LSTM route at the same shapes
    tc_fwd_cases = [check_tc_forward(route, "train_" + name, t_len, batch)
                    for route in ("layer", "two_kernel", "unidirectional")
                    for name, (t_len, batch) in TRAIN_SHAPES.items()]
    for name, (rows, length) in UNFOLD_SHAPES.items():
        if name.startswith("train"):
            tc_fwd_cases.append(check_tc_forward(
                "unfold", name, None, rows, grid_d, GRID_H, length=length))
            tc_fwd_cases.append(check_tc_forward(
                "layer", "train_grid_" + name[len("train_"):],
                length - GRID_KS + 1, rows, grid_d, GRID_H))
    from wesep_tpu_torch.ops.cuda_lstm_tc import forward_clusters

    clusters = {h: forward_clusters(h) for h in (64, 128, 192, 256)}
    log(f"forward chain: clusters of 4 blocks the card runs at once, by H: "
        f"{clusters}")

    # the f32 cluster forward of every LSTM route at every f32 shape that
    # serving and the validation step run: the pBSRNN's band and comm at
    # the serving and (with cs) the training sizes on K0, K2 and K1;
    # TF-GridNet's intra and inter on K3 and on K0 over the materialised
    # frames
    from wesep_tpu_torch.ops import cuda_lstm_f32

    f32_clusters = {
        h: {r: cuda_lstm_f32.f32_forward_clusters(h, r)
            for r in cuda_lstm_f32.F32_ROWS}
        for h in cuda_lstm_f32.F32_HIDDEN}
    log(f"f32 cluster forward: clusters of H / 32 blocks the card runs at "
        f"once, by H and rows a cluster: {f32_clusters}")
    f32_cases = [
        check_f32_forward(route, path + name, t_len, batch,
                          with_cs=path == "train_")
        for route in ("layer", "two_kernel", "unidirectional")
        for path, shapes in (("serve_", MAIN_SHAPES),
                             ("train_", TRAIN_SHAPES))
        for name, (t_len, batch) in shapes.items()]
    for name, (rows, length) in list(UNFOLD_SHAPES.items()) + list(
            V2_GRID_SHAPES.items()):
        train = not name.startswith("serve")
        f32_cases.append(check_f32_forward(
            "unfold", name, None, rows, grid_d, GRID_H, length=length,
            with_cs=train))
        f32_cases.append(check_f32_forward(
            "layer", "grid_" + name, length - GRID_KS + 1, rows, grid_d,
            GRID_H, with_cs=train))
    # the f32 backward (gates, adjoint chain, dx, dW) of every LSTM route at
    # the f32 training shapes: K0 at the pBSRNN's band and comm (the joint
    # v2 BSRNN's step) and at the v2 TF-GridNet's intra and inter over the
    # materialised frames (its default route), K3 at the v2 TF-GridNet's
    # shapes, K2 and K1 at the pBSRNN's band and comm
    f32_bwd_clusters = {
        h: {r: cuda_lstm_f32.f32_adjoint_clusters(h, r)
            for r in cuda_lstm_f32.F32_ROWS}
        for h in cuda_lstm_f32.F32_HIDDEN}
    log(f"f32 adjoint chain: clusters of H / 32 blocks the card runs at "
        f"once, by H and rows a cluster: {f32_bwd_clusters}")
    f32_bwd_cases = [check_f32_backward(route, "train_" + name, t_len, batch)
                     for route in ("layer", "two_kernel", "unidirectional")
                     for name, (t_len, batch) in TRAIN_SHAPES.items()]
    for name, (rows, length) in V2_GRID_SHAPES.items():
        f32_bwd_cases.append(check_f32_backward(
            "layer", "grid_" + name, length - GRID_KS + 1, rows, grid_d,
            GRID_H))
        f32_bwd_cases.append(check_f32_backward(
            "unfold", name, None, rows, grid_d, GRID_H, length=length))
    # and K3b at the v1 TF-GridNet's f32 training shapes (the f32 gradient
    # checks of the unfold-fused route), at hs 1 and once at hs 2
    for name, hs in (("train_intra", 1), ("train_inter", 1),
                     ("train_intra", 2)):
        rows, length = UNFOLD_SHAPES[name]
        f32_bwd_cases.append(check_f32_backward(
            "unfold", name + ("_hs2" if hs == 2 else ""), None, rows,
            grid_d, GRID_H, length=length, hs=hs))
    # and K0's f32 forward (with cs) and backward at BSRNN_Feats' train
    # shapes (4 rows x 3 s, phase 16)
    lap("3 kernels (but BSRNN_Feats' shapes)")
    feats_fwd, feats_bwd = feats_kernel_cases()
    lap("3 kernels at BSRNN_Feats' shapes")
    f32_cases += feats_fwd
    f32_bwd_cases += feats_bwd
    # and the routes' own FMA kernels, forward and backward, at a shape the
    # f32 gates refuse, through the layers' entry points
    refused_launches = f32_refused_path()

    # the fused Conv2dBlock at DPCCN's six shapes: serving in f32 (2 rows),
    # training in bf16 (8 rows), and the MetricGAN step's f32 (4 rows, and
    # the 8 rows its batch_size 4 gives)
    conv_cases = [check_conv2d(name, f, ci, co, batch, dtype)
                  for batch, dtype in CONV_CASES
                  for name, f, ci, co in CONV_SHAPES]
    # the TCN block and the Conv2dBlock past one grid dimension
    large_cases = check_large_grids()

    lap("3 kernels (but BSRNN_Feats' shapes)")
    # 4. serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_launches, served = serve(root)
    log("serve summary", json.dumps(served))

    lap("4 serve")
    # 5. train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        train_launches, trained = train_phase(root)
    log("train summary", json.dumps(trained))

    lap("5 train")
    # 6. serve SpEx+
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        spex_serve_launches, spex_served = serve_spex(root)
    log("serve SpEx+ summary", json.dumps(spex_served))

    lap("6 serve SpEx+")
    # 7. train SpEx+
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        spex_launches, spex_trained = train_spex(root)
    log("train SpEx+ summary", json.dumps(spex_trained))

    lap("7 train SpEx+")
    # 8. serve TF-GridNet, on both routes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        grid_served = serve_tfgridnet(root)
    log("serve TF-GridNet summary", json.dumps(grid_served))

    lap("8 serve TF-GridNet")
    # 9. train TF-GridNet, on the unfold-fused route
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        grid_launches, grid_trained = train_tfgridnet(root)
    log("train TF-GridNet summary", json.dumps(grid_trained))

    lap("9 train TF-GridNet")
    # 10. serve DPCCN, on both routes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        dpccn_served = serve_dpccn(root)
    log("serve DPCCN summary", json.dumps(dpccn_served))

    lap("10 serve DPCCN")
    # 11. train DPCCN, on the fused-block route
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        dpccn_launches, dpccn_trained = train_dpccn(root)
    log("train DPCCN summary", json.dumps(dpccn_trained))

    lap("11 train DPCCN")
    # 12, 13. the pBSRNN on its two other LSTM routes: serve and train
    # through the two-kernel bidirectional layer (WESEP_LSTM_LAYER=0), then
    # the unidirectional model (use_bidirectional: false)
    route_launches, route_summaries = {}, {}
    for route in ("two_kernel", "unidirectional"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            n_serve, served_route = serve(root, route)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            n_train, trained_route = train_phase(root, route)
        route_launches[route] = (n_serve, n_train)
        route_summaries[route] = {"serve": served_route,
                                  "train": trained_route}
        log(f"pBSRNN {route} route summary",
            json.dumps(route_summaries[route]))

    lap("12-13 pBSRNN routes")
    # 14. the joint v2 models: (a) the speaker branch's ops against the
    # CPU; (b) the v2 BSRNN served through bin/infer; (c) trained through
    # bin/train, then average_model and bin/infer, with (d) one SSA step;
    # (e) the v2 TF-GridNet and DPCCN
    speaker_ops = check_speaker_ops()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        v2_serve_launches, v2_served = serve_v2_bsrnn(root)
    log("serve v2 BSRNN summary", json.dumps(v2_served))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        v2_launches, v2_trained = train_v2_bsrnn(root)
    log("train v2 BSRNN summary", json.dumps(v2_trained))
    v2_others = check_v2_others()
    log("v2 TF-GridNet and DPCCN summary", json.dumps(v2_others))
    log("speaker ops summary", json.dumps(speaker_ops))

    lap("14 joint v2")
    # 15. MetricGAN on DPCCN: (a) P.862 and (b) the discriminator against
    # the CPU; (c) bin/train_gan on both conv_impl routes, resume,
    # average_model -> bin/infer; (d) a v2 GAN step; (e) BSRNN_Multi
    # through bin/train and bin/infer
    phase15_launches, phase15_summary = phase15()
    log("phase 15 summary", json.dumps({
        k: v for k, v in phase15_summary.items() if k in ("pesq",
                                                           "discriminator")}))

    lap("15 MetricGAN, BSRNN_Multi")
    # 16. BSRNN_Feats: (a) ECAPA-TDNN (both layouts) and CAM++ against the
    # CPU; (b) bsrnn_feats.yaml served through bin/infer; (c) trained
    # through bin/train; (d) bin/train under WESEP_DIST (one NCCL process)
    # against the plain run
    phase16_launches, phase16_summary = phase16()
    log("phase 16 summary", json.dumps({
        k: v for k, v in phase16_summary.items() if k in ("encoders",
                                                           "ddp")}))

    lap("16 BSRNN_Feats")
    # 17. online mixing: (a) the simulation on the card against the CPU;
    # (b) bsrnn_online.yaml through bin/train with it; (c) with the host
    # simulating, and the host chain's rate on both paths
    phase17_launches, _ = phase17()

    # the headline case of each kernel: the band RNN, the shape that takes
    # most of its path's time, in the dtype that path runs (serving f32,
    # training bf16); the routes' own FMA forward kernels, which f32 runs
    # only at shapes the f32 gate refuses, timed beside the f32 cluster
    # forward at the serving shapes where that forward takes longest
    def f32_case(route, shape):
        return next(c for c in f32_cases
                    if c["route"] == route and c["shape"] == shape)

    band = f32_case("layer", "serve_band")
    # the routes' own f32 FMA backward kernels' headline: the training band
    # in f32, launched directly (the layers take them only at shapes the
    # f32 backward gate refuses; bf16 steps take the tensor-core backward)
    train_band = train_cases[0]
    # and of the fused TCN block: SpEx+'s training shape (16 rows, bf16)
    # at dilation 1
    tcn_head = next(c for c in tcn_cases if c["shape"] == "spex_train"
                    and c["dtype"] == "bfloat16" and c["dilation"] == 1)
    # and of the unfold-fused layer: the TF-GridNet training shape (bf16)
    # whose kernels take longest; its own forward kernel, which bf16 no
    # longer runs there, at the f32 training shape that takes longest
    unfold_head = max(
        (c for c in unfold_cases
         if c["shape"].startswith("train") and c["dtype"] == "bfloat16"),
        key=lambda c: c["forward"]["ms"] + c["backward"]["ms"]
        + c["wgrad"]["ms"])
    unfold_fwd_head = f32_case("unfold", "serve_inter")
    # and of the fused Conv2dBlock: the DPCCN training shape (bf16) whose
    # kernels take longest
    conv_head = max((c for c in conv_cases if c["dtype"] == "bfloat16"),
                    key=lambda c: c["forward"]["ms"] + c["backward"]["ms"])
    sources = {"bilstm_layer": "wesep_tpu_torch/csrc/bilstm_layer.cu",
               "bilstm_layer_backward":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu",
               "bilstm_layer_wgrad":
                   "wesep_tpu_torch/csrc/bilstm_layer_bwd.cu",
               "bilstm_layer_unfold": "wesep_tpu_torch/csrc/bilstm_unfold.cu",
               "bilstm_layer_unfold_backward":
                   "wesep_tpu_torch/csrc/bilstm_unfold_bwd.cu",
               "bilstm_layer_unfold_wgrad":
                   "wesep_tpu_torch/csrc/bilstm_unfold_bwd.cu",
               "tcn_block_gln": "wesep_tpu_torch/csrc/tcn_block.cu",
               "tcn_block_gln_backward":
                   "wesep_tpu_torch/csrc/tcn_block_bwd.cu",
               "conv2d_block_in": "wesep_tpu_torch/csrc/conv2d_block.cu",
               "conv2d_block_in_backward":
                   "wesep_tpu_torch/csrc/conv2d_block_bwd.cu"}
    for route in ("two_kernel", "unidirectional"):
        fwd, adjoint, wgrad = LSTM_ROUTES[route]
        sources[fwd] = "wesep_tpu_torch/csrc/lstm_fused.cu"
        sources[adjoint] = sources[wgrad] = \
            "wesep_tpu_torch/csrc/lstm_fused_bwd.cu"
    replaces = {"bilstm_layer": "wesep_tpu/ops/pallas_lstm.py:834",
                "bilstm_layer_backward": "wesep_tpu/ops/pallas_lstm.py:932",
                "bilstm_layer_wgrad": "wesep_tpu/ops/pallas_lstm.py:932",
                "bilstm_layer_unfold": "wesep_tpu/ops/pallas_lstm.py:1236",
                "bilstm_layer_unfold_backward":
                    "wesep_tpu/ops/pallas_lstm.py:1353",
                "bilstm_layer_unfold_wgrad":
                    "wesep_tpu/ops/pallas_lstm.py:1353",
                "tcn_block_gln": "wesep_tpu/ops/pallas_tcn.py:230",
                "tcn_block_gln_backward": "wesep_tpu/ops/pallas_tcn.py:527",
                "conv2d_block_in": "wesep_tpu/ops/pallas_conv2d.py:201",
                "conv2d_block_in_backward":
                    "wesep_tpu/ops/pallas_conv2d.py:415",
                "bilstm_fused_forward": "wesep_tpu/ops/pallas_lstm.py:460",
                "bilstm_fused_backward": "wesep_tpu/ops/pallas_lstm.py:546",
                "bilstm_fused_wgrad": "wesep_tpu/ops/pallas_lstm.py:546",
                "lstm_fused_forward": "wesep_tpu/ops/pallas_lstm.py:157",
                "lstm_fused_backward": "wesep_tpu/ops/pallas_lstm.py:230",
                "lstm_fused_wgrad": "wesep_tpu/ops/pallas_lstm.py:230"}
    headline = {"bilstm_layer": band["own_fma_kernel"],
                "bilstm_layer_backward": train_band["backward"],
                "bilstm_layer_wgrad": train_band["wgrad"],
                "bilstm_layer_unfold": unfold_fwd_head["own_fma_kernel"],
                "bilstm_layer_unfold_backward": unfold_head["backward"],
                "bilstm_layer_unfold_wgrad": unfold_head["wgrad"],
                "tcn_block_gln": tcn_head["forward"],
                "tcn_block_gln_backward": tcn_head["backward"],
                "conv2d_block_in": conv_head["forward"],
                "conv2d_block_in_backward": conv_head["backward"]}
    # and of the two-kernel layers: as the plain layer's, the serving band
    # (f32) for the forward and the training band (bf16) for the backward
    for dirs in (2, 1):
        fwd, adjoint, wgrad = fused_names(dirs)
        train_band_case = next(c for c in two_kernel_cases
                               if c["dirs"] == dirs
                               and c["shape"] == "train_band")
        headline[fwd] = f32_case(
            "two_kernel" if dirs == 2 else "unidirectional",
            "serve_band")["own_fma_kernel"]
        headline[adjoint] = train_band_case["backward"]
        headline[wgrad] = train_band_case["wgrad"]
    # and of the tensor-core backward: the main path's training band (K0,
    # bf16); the chain has no library call of its own (cuDNN's backward
    # also forms the gates, dx and dW: it is held against the whole
    # backward, in the tensor-core cases' "function")
    tc_head = next(c for c in tc_cases
                   if c["route"] == "layer" and c["shape"] == "train_band")
    for name in TC_NAMES:
        sources[name] = "wesep_tpu_torch/csrc/lstm_backward_tc.cu"
        replaces[name] = "wesep_tpu/ops/pallas_lstm.py:932"
        headline[name] = dict(tc_head["kernels"][name])
    # and of the tensor-core forward: the main path's training band (K0,
    # bf16); the chain alone has no library call (cuDNN's forward also
    # projects x: it is held against the whole forward, the cases'
    # "forward")
    tc_fwd_head = next(c for c in tc_fwd_cases
                       if c["route"] == "layer" and c["shape"] == "train_band")
    for name in TC_FORWARD_NAMES:
        sources[name] = "wesep_tpu_torch/csrc/lstm_forward_tc.cu"
        replaces[name] = "wesep_tpu/ops/pallas_lstm.py:834"
        headline[name] = dict(tc_fwd_head["kernels"][name])
    # and of the f32 cluster forward: the main path's serving band (K0, f32,
    # what bin/infer runs); the chain alone has no library call (cuDNN's
    # forward also projects x: it is held against the whole forward, the
    # cases' "forward")
    for name in F32_FORWARD_NAMES:
        sources[name] = "wesep_tpu_torch/csrc/lstm_forward_f32.cu"
        replaces[name] = "wesep_tpu/ops/pallas_lstm.py:834"
        headline[name] = dict(band["kernels"][name])
    # and of the f32 backward: the joint v2 BSRNN's training band (K0, f32,
    # what its train step runs); the chain alone has no library call
    # (cuDNN's backward also forms the gates, dx and dW: it is held against
    # the whole backward, the cases' "function" and "cudnn_backward_ms")
    f32_bwd_head = next(c for c in f32_bwd_cases if c["route"] == "layer"
                        and c["shape"] == "train_band")
    for name in F32_BACKWARD_NAMES:
        sources[name] = "wesep_tpu_torch/csrc/lstm_backward_f32.cu"
        replaces[name] = "wesep_tpu/ops/pallas_lstm.py:932"
        headline[name] = dict(f32_bwd_head["kernels"][name])
    # launches of each wrapper on each path that ran it: the main-path
    # count of an entry is its training path's (the f32 gradient checks are
    # the paths of the LSTM routes' own backward kernels, which bf16
    # training no longer runs)
    by_path = {name: {} for name in headline}

    def add_path(path, counts):
        for name, n in counts.items():
            if n:
                by_path[name][path] = n

    add_path("serve", serve_launches)
    add_path("train", train_launches["main"])
    add_path("train_f32_grads", train_launches["f32_grads"])
    by_path["tcn_block_gln"].update(serve=spex_serve_launches)
    for name in ("tcn_block_gln", "tcn_block_gln_backward"):
        by_path[name]["train"] = spex_launches[name]
    for route in ("unfold", "default"):
        add_path(f"tfgridnet_serve_{route}", grid_served[route]["launches"])
    add_path("tfgridnet_train", grid_launches["main"])
    add_path("tfgridnet_f32_grads", grid_launches["f32_grads"])
    for route in ("pallas", "xla"):
        n = dpccn_served[route]["launches"]["conv2d_block_in"]
        by_path["conv2d_block_in"][f"dpccn_serve_{route}"] = n
    for name, n in dpccn_launches.items():
        by_path[name]["dpccn_train"] = n
    for route, (n_serve, n_train) in route_launches.items():
        add_path(f"serve_{route}", n_serve)
        add_path(f"train_{route}", n_train["main"])
        add_path(f"train_{route}_f32_grads", n_train["f32_grads"])
    for route, counts in refused_launches.items():
        add_path(f"f32_refused_shape_{route}", counts)
    add_path("v2_bsrnn_serve", v2_serve_launches)
    add_path("v2_bsrnn_train", v2_launches["main"])
    add_path("v2_bsrnn_f32_grads", v2_launches["f32_grads"])
    add_path("v2_tfgridnet_train_step", {
        n: v for n, v in v2_others["TFGridNet"]["train_launches"].items()
        if n in by_path})
    for path, counts in list(phase15_launches.items()) + list(
            phase16_launches.items()) + list(phase17_launches.items()):
        add_path(path, counts)
    # the main path of a kernel: its training path; for the f32 cluster
    # forward, serving (phase 4); for the routes' own FMA forward kernels,
    # which no recipe's shape reaches any more, the layers' forward at a
    # shape the f32 gate refuses
    main_paths = ("train", "v2_bsrnn_train", "tfgridnet_train",
                  "dpccn_train",
                  "train_two_kernel", "train_unidirectional",
                  "train_f32_grads", "tfgridnet_f32_grads",
                  "train_two_kernel_f32_grads",
                  "train_unidirectional_f32_grads") + tuple(
                      f"f32_refused_shape_{r}" for r in OLD_F32_FORWARD)
    kernels = []
    for name, head in headline.items():
        main_path = "serve" if name in F32_FORWARD_NAMES else next(
            p for p in main_paths if p in by_path[name])
        entry = {"name": name, "route": "cuda", "source": sources[name],
                 "replaces": replaces[name],
                 "launches": by_path[name][main_path],
                 "launches_by_path": by_path[name]}
        entry.update({key: head[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        if name in OLD_F32_FORWARD.values():
            entry["own_fma_cases"] = [
                dict(c["own_fma_kernel"], route=c["route"], shape=c["shape"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"])
                for c in f32_cases if c["own_fma_kernel"]
                and OLD_F32_FORWARD[c["route"]] == name]
        if name == "bilstm_layer":
            entry["cases"] = cases + [
                dict(c["forward"], shape=c["shape"], dtype=c["dtype"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"])
                for c in train_cases]
        elif name.startswith("bilstm_layer_unfold"):
            part = {"bilstm_layer_unfold": "forward",
                    "bilstm_layer_unfold_backward": "backward",
                    "bilstm_layer_unfold_wgrad": "wgrad"}[name]
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], B=c["B"],
                     L=c["L"], T=c["T"], ks=c["ks"], hs=c["hs"],
                     rel_limit=c["rel_limit"]) for c in unfold_cases]
        elif name.startswith("conv2d_block_in"):
            part = "backward" if name.endswith("backward") else "forward"
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], B=c["B"],
                     T=c["T"], F=c["F"], Ci=c["Ci"], Co=c["Co"])
                for c in conv_cases]
            entry["large_grid_cases"] = [c for c in large_cases
                                         if c["shape"].startswith("conv2d")]
            # bf16: the tensor-core passes; f32: the FMA kernels
            entry["also_sources"] = [
                "wesep_tpu_torch/csrc/conv2d_tc.cuh",
                "wesep_tpu_torch/csrc/conv2d_common.cuh",
                "wesep_tpu_torch/csrc/tc_common.cuh"]
        elif name in fused_names(2) + fused_names(1):
            part = ("forward", "backward", "wgrad")[
                fused_names(2 if name.startswith("bilstm") else 1)
                .index(name)]
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], H=c["H"], rel_limit=c["rel_limit"])
                for c in two_kernel_cases
                if part in c and c["dirs"] == (2 if name.startswith("bilstm")
                                               else 1)]
        elif name in F32_FORWARD_NAMES:
            entry["also_replaces"] = [
                "wesep_tpu/ops/pallas_lstm.py:1236",
                "wesep_tpu/ops/pallas_lstm.py:460",
                "wesep_tpu/ops/pallas_lstm.py:157"][
                    :3 if name == "lstm_f32_forward_chain" else 1]
            entry["clusters_at_once"] = f32_clusters
            entry["cases"] = [
                dict(c["kernels"][name], route=c["route"], shape=c["shape"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"],
                     with_cs=c["with_cs"],
                     rows_per_cluster=c["rows_per_cluster"],
                     repeats_bit_for_bit=c["repeats_bit_for_bit"],
                     whole_err=c["whole_err"], forward=c["forward"],
                     own_fma_ms=(c["own_fma_kernel"] or {}).get("ms"))
                for c in f32_cases if name in c["kernels"]]
        elif name in TC_FORWARD_NAMES:
            entry["also_replaces"] = [
                "wesep_tpu/ops/pallas_lstm.py:1236",
                "wesep_tpu/ops/pallas_lstm.py:460",
                "wesep_tpu/ops/pallas_lstm.py:157"][
                    :3 if name == "lstm_forward_chain" else 1]
            entry["clusters_at_once"] = clusters
            entry["cases"] = [
                dict(c["kernels"][name], route=c["route"], shape=c["shape"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"],
                     repeats_bit_for_bit=c["repeats_bit_for_bit"],
                     whole_err=c["whole_err"], forward=c["forward"])
                for c in tc_fwd_cases if name in c["kernels"]]
        elif name in F32_BACKWARD_NAMES:
            entry["also_replaces"] = [
                "wesep_tpu/ops/pallas_lstm.py:1353",
                "wesep_tpu/ops/pallas_lstm.py:546",
                "wesep_tpu/ops/pallas_lstm.py:230"]
            entry["clusters_at_once"] = f32_bwd_clusters
            entry["cases"] = [
                dict(c["kernels"][name], route=c["route"], shape=c["shape"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"],
                     rows_per_cluster=c["rows_per_cluster"],
                     repeats_bit_for_bit=c["repeats_bit_for_bit"],
                     whole_rel_err=c["whole_rel_err"],
                     function=c["function"],
                     old_fma_wgrad_ms=c["old_fma_wgrad_ms"],
                     cudnn_backward_ms=c["cudnn_backward_ms"])
                for c in f32_bwd_cases if name in c["kernels"]]
        elif name in TC_NAMES:
            entry["also_replaces"] = [
                "wesep_tpu/ops/pallas_lstm.py:1353",
                "wesep_tpu/ops/pallas_lstm.py:546",
                "wesep_tpu/ops/pallas_lstm.py:230"]
            entry["cases"] = [
                dict(c["kernels"][name], route=c["route"], shape=c["shape"],
                     T=c["T"], B=c["B"], D=c["D"], H=c["H"],
                     repeats_bit_for_bit=c["repeats_bit_for_bit"],
                     whole_rel_err=c["whole_rel_err"])
                for c in tc_cases if name in c["kernels"]]
        elif name.startswith("tcn_block_gln"):
            part = "backward" if name.endswith("backward") else "forward"
            # the products and the column walks both passes share
            entry["also_sources"] = ["wesep_tpu_torch/csrc/tcn_common.cuh",
                                     "wesep_tpu_torch/csrc/tc_common.cuh"]
            if part == "forward":
                entry["fused_block_cases"] = fused_cases
            entry["large_grid_cases"] = [c for c in large_cases
                                         if c["shape"].startswith("tcn")]
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], dilation=c["dilation"]) for c in tcn_cases]
        else:
            part = "backward" if name == "bilstm_layer_backward" else "wgrad"
            entry["cases"] = [
                dict(c[part], shape=c["shape"], dtype=c["dtype"], T=c["T"],
                     B=c["B"], D=c["D"], H=c["H"], rel_limit=c["rel_limit"])
                for c in train_cases]
        kernels.append(entry)
    lap("17 online mixing, the kernel line")
    log("chip_smoke: wall s by phase", json.dumps(laps))
    log(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
