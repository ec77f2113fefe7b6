#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (bonito_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. In order, it:

 1. prints the card's name, power limit and count;
 2. builds the port's kernels from ``bonito_tpu_torch/csrc`` with nvcc for
    sm_90a and prints each kernel's registers, shared memory, stack frame
    and spills (kernel O's stretch kernel and the ring kernels of B, C, M,
    Q, U, V, W and X and of GW's and JW's passes, GW's head product, F's
    mma kernel and Y and Z split over warps must have neither;
    G's and J's ring kernels none at H 32 and no more than J's 8 bytes at
    H 96);
 3. holds each kernel against its plain PyTorch version on the card: at
    hac widths (N=96, T=1666, C=H=1024, S=1024) A, B, C in bf16 (B and C
    on their ring, ``decode_plan`` gives a plan, and held against their
    earlier kernels bit for bit on all eight outputs) and the
    int8 LSTM kernels D (both outputs) and E, every one in both
    directions (D and E each one persistent launch, the plan
    ``persistent_plan`` gives, whose output equals its step kernel's bit
    for bit); the full-score decode M + Q (a stay plane that is not
    constant, bf16) at hac and at fast widths, on their ring
    (``decode_full_plan`` gives a plan) and held against their earlier
    kernels bit for bit on all eight outputs; at fast widths (N=1024,
    T=1200, C=H=96, S=64) the fused LSTM layer F (both directions, with and
    without a bias; on its mma kernel, ``fused_plan`` gives a plan, and held
    against its earlier kernel bit for bit) and the fused-head decode G + J
    (the fast head, and a small head with two upsample phases, tanh, a
    scale and a bias; G and J on their rings, ``fused_decode_plan`` gives
    both plans, each held against its earlier kernel bit for bit); at sup
    widths (N=128,
    T=1000 and 1024, 8 heads of 64, window (127, 128)) the fused rotary +
    banded attention K in bf16 (and once with a partial rotary_dim) on its
    stretch kernel (``window_plan`` gives a plan at each) and at T=1000 on
    its earlier kernel beside it (H's o there equal to its K's), the
    banded attention L in f32 and bf16 (its tensor-core instance) and, in
    bf16, on what the shallow
    transformer below hands it (N=32, 8 heads of 40, q and k out of
    apply_rotary), and the layout pin P on a transposed view and on a
    contiguous tensor; GW + JW, the fused-head decode at 1024 states (GW's
    head product once for the batch, both passes over its f32 moves on the
    ring), on random heads of hac's width (N=96, T=1666, H=1024, U=1,
    clamped to +-5) and sup's (N=128, 1000 encoder frames x 2 phases,
    H=512, tanh x 5 and a bias), the moves equal to ``head_moves_plain``'s
    and all eight outputs to the earlier GW + JW's bit for bit;
 4. writes full-width model directories with the port's own code (random
    weights from a seed, the CRF weight scaled up so that the output is no
    run of stays): hac and fast, each once with quantize=false in its
    config and once with the config's own default, quantize=true; the
    shipped sup (transformer) model, and a shallow transformer whose heads
    (8 of 40) the fused attention kernel's gate rejects;
 5. basecalls synthetic reads through ``load_model`` + ``basecall`` on
    the card and checks the output of each path. hac (batch 96, chunk
    9996): bf16 (quantize=false; kernels A, B, C; 48 reads), int8 fused
    (the default directory loaded with quantize=None; D, B, C; 144 reads)
    and int8 two-stage (the same with route="two_stage"; E, B, C; 20
    reads). fast (batch 1024, chunk 6000, overlap 500): the default
    directory loaded with quantize=None (dequantised weights through F,
    then G, J; 160 reads, over 4 full batches) and a short run of the
    quantize=false directory (40 reads). sup (batch 128, chunk 12000,
    overlap 600; bf16 as shipped): 42 reads over at least 3 full batches
    (P, 18 x K, then B, C), and a short run of the shallow directory
    (rotary + L in each layer). The full-score paths: the reverse strand
    (``reverse=True``: model(x), M + Q reading it in reverse-complement
    order in place) of hac as
    shipped (48 reads, at least 3 full batches), of fast (one full batch of
    1024) and of sup (one full batch of 128: T 2000 behind P and 18 x K),
    and the beam decode of hac (``decoder="beam"``, one full batch). The
    fused-head decode at 1024 states (``head_route="fused"``): hac as
    shipped (hac_fused: D x 5, GW, JW) and sup (sup_fused: P, 18 x K, GW,
    JW), at least 2 full batches each. Then it
    holds one batch on the int8 path, one on the hac bf16 path (five
    layers through A against A's plain version in its place, and both
    decodes), one on the hac and one on the fast reverse path (the in-place
    read through M + Q against their plain versions, their earlier kernels
    and M + Q on the reverse_complement copy, bit for bit but the plain
    versions' qstring; for hac it prints, and does not require, the share of
    rows whose reverse call is the shifted reverse complement of the forward
    call), one on the fast
    path, one on the sup path (in bf16 and on an f32 copy of the model; and
    its full scores through M + Q on the reverse strand, held as hac's) and
    one of the
    shallow transformer (likewise) against the same batch with the plain
    versions in the kernels' place; and one batch of each fused path: its
    head through GW + JW against their plain versions, and its decode
    against the same batch's on the TCN route (the count of frames that
    differ is printed, not required: f32 against bf16 move scores), and
    GW + JW against the earlier GW + JW bit for bit;
 6. checks from the launch counts, set to 0 before each path and read
    after it, that each path launched its own kernels (5 LSTM and 1 + 1
    decode launches per batch; sup: 1 pin, 18 attention and 1 + 1 decode
    launches; the beam: 5 LSTM launches and no decode kernel; hac_fused: 5
    LSTM launches, GW's head product and GW + JW; sup_fused: 1 pin, 18
    attention, the product, GW + JW) and no other kernel of the port, and
    prints the plans F, G, J, GW and JW ran on (the fast paths' must be the
    mma kernel's and the rings', the fused paths' the product's and
    rings');
 7. prints samples/s, the device step and peak memory of the hac bf16,
    int8, reverse and beam paths, the fast path, the sup path and the two
    fused paths (beside the TCN route's device step on the same batch, and
    in turns with the earlier GW + JW, with the peak memory of each turn)
    beside the card's name and power, the sup and sup_fused device steps
    with K on its earlier kernel, the hac int8 and sup device steps
    with B and C on theirs, the fast device step with F and J on theirs
    and, in turns with the rings, with G on its earlier kernel (the fast
    reverse step with F on its), and the hac, fast and sup reverse device
    steps
    beside the parent's route (the reverse_complement copy and M + Q's
    earlier kernels; hac also the copy and the ring);
 8. times each kernel, its plain version and a PyTorch library call where
    one computes the same function (and, for comparison, A's, D's and E's
    step kernels at hac widths beside their persistent kernels, K's earlier
    kernel beside its stretch kernel, L in bf16 at sup widths
    beside scaled_dot_product_attention, F, G and J beside their earlier
    kernels and the routes that F, G and J take the place of at fast
    widths, B and C (beside their
    earlier kernels) at hac and sup shapes and
    the parts of one sup layer; M and Q on the ring, on the reverse strand
    read in place and on the forward strand, beside their earlier kernels
    and the reverse_complement copy, at hac, fast and sup shapes; GW, JW and
    GW's head product alone at hac's and sup's shapes beside the earlier GW
    and JW, ``torch.matmul`` in f32 on the product's operands and the TCN
    route's head matmul + B + C there);
 9. runs the CRF training loss at hac training width: the hac bf16
    directory (quantize=false), a batch of 128 chunks of 6000 samples and
    targets of 250 to 500 bases from the seed, through ``forward_tcn``
    under no_grad, ``loss_tcn`` and its backward (kernels U, V, Y, Z), then
    ``model(x)``, ``loss`` and its backward (W, X), then ``loss_tcn`` under
    no_grad as validation does (U and Y without their stacks); each path
    with its launch counts, held against the same path on the plain
    versions, with its loss, time, train-loss samples/s and peak memory
    (``loss_tcn`` also with U and V, and with Y, on their earlier kernels;
    ``loss`` in turns with W and X, and with W alone, on their earlier
    kernels and on the ring); then U to Z alone against their plain
    versions at hac, fast and sup training shapes, with their times and
    bounds at each, U, V, W and X on their ring (``logz_plan`` gives a plan
    at each) and held against their earlier kernels bit for bit (stack,
    logZ, no-stack logZ, gradients; U's and W's times without the stack), Y
    and Z split over warps (``lattice_fwd_plan`` and ``lattice_plan`` give
    a plan at each) held against their earlier kernels bit for bit (Y's
    stack, logZ and no-stack logZ, Z's dmove), with those kernels' times;
10. runs the LSTM-CRF train step: R and S (the LSTM recurrence of a train
    step and its backward through time) against their plain versions at
    hac and fast training shapes (N 128; T 1000, H 1024 and T 1200, H 96),
    both directions, R's h against A's bit for bit, with the plans they
    ran, their times, bounds, their step kernels' times and a cuDNN LSTM
    layer's forward + backward beside them; the hac train step (lstm_crf_config()
    with f32 master weights, a bf16 forward, batch 128 x chunk 6000,
    targets of 250 to 500 bases, AdamW 2e-3, clip 2.0): a warm-up step and
    three timed ones with their launch counts (R 5, S 5, U, V, Y, Z 1 each
    per step, nothing else), finite losses and norms, every parameter
    moved, and one step's gradients through the kernels against the same
    through the plain versions; its time, train samples/s and peak memory,
    and the step with U and V on their earlier kernels and on the ring in
    turns, with Z, and with Y (the parent's route), on its earlier kernel
    and split over warps in turns; one fast train step (R and S at H 96);
    and ``python -m
    bonito_tpu_torch train`` (in this process) for one epoch of hac on a
    generated npy set (3 batches of 128 x 6000, one validation batch, which
    runs A, U, Y, B and C), checking its checkpoint and logs;
11. runs the sup train step: H and O (the training twin of K: its forward
    with each query's lse, and the flash-style backward to dqkv) against
    their plain versions at sup training widths (N 32, 8 heads of 64,
    window (127, 128); T 1024 and 1000, bf16 and f32, t_real < T, a partial
    rotary_dim), O in bf16 on its stretch kernel (``window_bwd_plan`` gives
    a plan at each) and against its earlier kernel, H's o against K's, and
    P's backward on a transposed cotangent; the full-width sup train step (the shipped sup model with f32
    master weights, a bf16 forward, batch 32 x chunk 12288, targets of 1024
    bases, AdamW 2e-3, clip 2.0: the JAX package's sup train bench): a
    warm-up step and three timed ones with their launch counts (P 2, H 18,
    O 18, U, V, Y, Z 1 each per step, nothing else), finite losses and
    norms, every parameter moved (the convolutions and each wqkv among
    them), and one step's gradients through the kernels against the same
    through the plain versions; its time, sup train samples/s and peak
    memory, and the same step's time with H, then O, on its earlier
    kernel, with U and V on theirs and on the ring in turns, and with Z,
    and with Y, on its earlier kernel and split over warps in turns; one
    epoch of ``python -m bonito_tpu_torch train --config
    dna_r10.4.1_e8.2_400bps_sup@v5.0`` on a generated npy set (2 batches of
    32 x 12288, one validation batch: P, 18 x K, U, Y, B, C); and H's and
    O's times, plain times and bounds beside rotary + scaled_dot_product_
    attention with the band as a mask, forward and backward (H's and O's
    earlier kernels beside them);
12. runs ``python -m bonito_tpu_torch basecaller`` (``cli.main``, in this
    process, fd 1 on the output file) on pod5 directories written here with
    the port's writer, two files each, VBZ (uncompressed where no libzstd
    is found, which it says): hac as shipped (the phase-4 directory with
    quantize=true) over 64 reads of 20k to 400k samples to BAM, with 4
    reader processes, launch counts set to 0 before and read after (5 D, 1
    B, 1 C per batch and nothing else), every record (sequence, qstring,
    mv) equal to ``basecall`` in this process on the Reads the port's
    reader yields, the RG, qs, ns, ts, ch and rn tags, one summary row a
    read; 16 of those reads to SAM, a FASTA of their calls with every
    other one reverse complemented, and the 16 again to SAM with
    ``--reference``: each on its own contig and strand with NM 0, each
    record the mapping ``Aligner`` gives its call here; fast as shipped
    over 256 reads to fastq (5 F, 1 G, 1 J per batch; the first file's
    reads equal to ``basecall``'s). It prints the CLI's own samples/s, the
    wall time, reads and samples, the stage waits of
    ``BONITO_TPU_PROFILE=1`` beside phase 7's device step, the reader
    processes' start-up time and whether libzstd was found.
13. runs the conv-CTC family (``dna_r9.4.1_e8_fast@v2`` as shipped, random
    weights of the seed with BatchNorm statistics of a random batch),
    which no hand kernel serves, every launch count 0 on each of its
    paths: the device step at 512 x 3999 as the basecaller loads the model
    (bf16, fuse_bn) in turns, with samples/s, peak memory, every module's
    tensors on cuda, and the time of each block, of the k 115, 123 and 67
    depthwise convs, a pointwise conv and a BatchNorm, swish and add pass,
    and the device time by kernel (torch.profiler); the host's greedy and
    beam decode of one batch on the decode threads; ``basecaller`` from
    64 pod5 reads at 4 kHz to fastq (greedy with qualities), BAM and SAM
    (the beam), every record the in-process ``basecall``'s, with the
    CLI's samples/s and stage waits; one train step at 64 x 3999 (bf16
    amp, AdamW, the clip) with train samples/s and peak memory; the
    loss's route (F.ctc_loss in f64) against the plain recursion in f64
    on one batch (F.ctc_loss in f32 and the recursion in f32 beside it);
    one ``train`` CLI epoch; ``evaluate`` on 64 chunks, its seqs.fasta
    ``decode_batch``'s in this process (the LSTM-CRF family's f32
    ``evaluate`` is phase 15's); one f32 batch on the card against the CPU
    with TF32 on and off; ``view``'s parameter count.
14. runs upstream bonito's model directories (a ``config.toml`` with
    ``bonito.*`` package names and ``weights_1.tar``): hac, sup and conv-CTC
    at full width with phase 4's and 13's weights, written by ``python -m
    bonito_tpu_torch export --format torch``, each LSTM given a nonzero
    ``bias_hh_l0`` and every key a ``module.`` prefix, beside a ``.npz``
    directory of the same weights; prints each ``.tar``'s import time on
    the host; one device-step batch of each form as the basecaller loads
    it (hac 96 x 9996 quantised: D, the int8 head, B, C; sup 128 x 12000:
    P, 18 x K, B, C; conv-CTC 512 x 3999) equal bit for bit, with their
    launch counts; ``basecaller`` on the hac ``.tar`` directory to BAM
    (phase 12's 64 pod5 reads) record for record as on the ``.npz``
    directory, with the CLI's samples/s; the old-style parametric
    ``[encoder]`` (``models.rnn_crf_config()``: 5 LSTM layers of 768, S
    1024, stride 5) as a ``.tar`` directory at 96 x 9996 with
    ``quantize`` false (A) and true (D): launch counts (5 + 1 + 1), the step
    in turns, samples/s, peak memory, device time by kernel, one batch
    through the kernels against their plain versions (HAC_* limits for A,
    the int8 path's for D), and A and D alone at H 768 against their plain
    versions (D's persistent launch its step kernel's bits) with their
    times and bounds; ``download --models --select`` from a ``file://``
    zip of the hac ``.tar`` directory (its ``.npz`` the import); ``export
    --format dorado`` of it, each ``.tensor`` read back with
    ``torch.jit.load`` equal to the BatchNorm-fused state;
15. runs f32 on the card: kernel A's f32 persistent kernel (csrc/
    lstm_f32.cu) at hac's basecall batch (N 96, T 1666, H 1024), at
    evaluate's (N 256, T 500) and the --no-amp validation's (N 16) and at
    the old-style model's evaluate batch (N 256, T 600, H 768), and kernel
    F's f32 kernel at fast's (N 1024, T 1200, C = H = 96) and at N 256 and
    16 (T 500): each against its plain version, against its earlier kernel
    (R's f32 step kernel; F's first f32 kernel), and the earlier kernel
    against the plain version, within LSTM_F32_ATOL (A both directions at
    hac, F three cases at fast); the new and earlier kernels timed in
    turns, the bounds (f32 FMA or bytes) and cuDNN's f32 LSTM with TF32 off
    (the yardstick) and on; B and C on their f32 ring at S 1024 (hac) and
    S 64 (fast) against their plain versions bit for bit on all eight
    outputs, with times and bounds; the other f32 instances ``evaluate``
    and ``train --no-amp`` launch (``f32_gaps``: M and Q on f32 full
    scores, R and S in f32, the launches of the sup model's forward and
    decode at evaluate's batch, K on the stretch kernel's f32 plan and P on
    the tiles, both required, timed in turns with their earlier kernels,
    K within ATTN_F32_TOL of its plain version and of the earlier kernel,
    P bit for bit and faster than ``Tensor.contiguous()``, P also at a bf16
    T 999), each against its plain version and timed beside its library
    call where one exists; one sup ``train --no-amp`` step
    (``sup_no_amp``: 32 x 12288 where it fits, else the largest of
    SUP_NO_AMP_N; its time, peak memory and launches, H on the stretch
    kernel's f32 plan and O on its earlier kernel, required; in turns with
    H on its earlier kernel) and, at its first layer's inputs, H in f32 in
    turns with its earlier kernel and O in f32, their plain versions,
    bounds and the library calls; R and
    S in f32 (``f32_train_kernels``, csrc/lstm_f32.cu) at the --no-amp
    batch (N 16: hac T 500, fast T 600 at H 96), the train CLI's default
    batch (N 64, T 500) and hac training's (N 128, T 1000) on their
    persistent kernels (R A's f32 kernel with its stores, its h A's bit for
    bit; S the layout turned around) against their plain versions and their
    step kernels, timed in turns with the step kernels, cuDNN's f32 LSTM
    forward + backward (TF32 off and on) and the port's whole layer on
    either, and one hac ``--no-amp`` train step at N 16 in turns on the
    new and the step kernels;
    ``evaluate`` (f32, as bonito_tpu
    loads it) of the hac, fast and an old-style directory on the card (A
    or F in f32, then M and Q; launch counts; at its defaults the new f32
    kernels' plans) and with ``--device cpu`` on the same
    chunks (at most F32_EVAL_MAX_DIFFER of them called otherwise; one
    batch's card scores decode alike on both), and on the card again at
    evaluate's defaults (512 chunks in two batches of 256) for its rate,
    and sup at evaluate's defaults on the card (P, 18 x K, M, Q a batch;
    K's f32 plan and P's tiles required) for its rate; one
    ``train --no-amp`` epoch of hac and of fast (R and S on their f32
    persistent kernels, which it requires, then the validation through A
    or F in f32, U, Y, and B and C on the f32 ring), with the validation's
    time; the basecaller from
    phase 12's hac reads to BAM and to CRAM, referenceless and with
    ``--reference`` (a FASTA of the calls), each CRAM's records the BAM's
    (the port's ``CramReader``), with the rates and sizes; ``duplex`` on
    that BAM and CRAM and on a BAM and CRAM of the calls with their
    complement strands, to fastq and SAM on spawned workers, each record
    ``call_basespace_duplex``'s in process, and no kernel launched.

Then it prints one ``kernels`` JSON line with all twenty-six kernels and
the f32 instances of A, F, B and C and of M, Q, R, S, K, P, H and O (K's,
P's and H's with their plans and their earlier kernels' times; R's and
S's with their plans, their step kernels' times and every RS32_SHAPES
shape's numbers) (phase 15's f32 paths, evaluate and
the ``--no-amp`` epochs, in their ``by_path``; every kernel's ``by_path``
gains all of phase 15's paths) (F's,
G's and J's with their plans, their earlier kernels' times and the fast
device steps on both; K's, H's and O's with their plans and their earlier
kernel's time; B's and C's with their plan, their earlier kernels' times
and difference, and the device steps on both; M's and Q's likewise, with
the reverse paths' device steps and the parent's; U's, V's, X's, Y's and
Z's with their plan, their earlier kernels' times at hac, fast and sup
training shapes, and the loss paths and train steps on both; every
kernel's ``by_path`` with phase 13's conv-CTC paths, all 0, and phase
14's paths; A's and D's ``h768`` with their times at H 768), after a line
with the whole script's time and each phase's.

The last line is {"ok": true, "device": {...}}. Any failed phase raises, so
the script exits non-zero and prints no result; it does the same when no
CUDA device is available, or when the bonito_tpu_torch package is absent.
It imports nothing of JAX or bonito_tpu.
"""

import contextlib
import gzip
import io
import json
import math
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np

H100_BF16_OPS = 989e12    # dense bf16 tensor-core FLOP/s (data sheet, SXM)
H100_INT8_OPS = 1979e12   # dense int8 tensor-core OP/s (data sheet, SXM)
H100_F32_OPS = 67e12      # f32 FLOP/s outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bytes/s
SEED = 1

# hac geometry (dna_r10.4.1_e8.2_400bps_hac@v4.3): batch 96, chunk 10000
# rounded to the stride 6 -> 9996 samples -> T = 1666 frames
N, T, H, STATE_LEN = 96, 1666, 1024, 5
S = 4 ** STATE_LEN
LSTM_ATOL, LSTM_MEAN_TOL = 1.6e-2, 1e-4  # see check_lstm
# One hac bf16 batch through 5 x A against the same batch with A's plain
# version in its place: each layer's h drifts from the plain version's by a
# flipped bf16 rounding here and there (check_lstm), and the head (clamped to
# +-5, where one bf16 step is 0.0313) carries that to the move scores: seen
# one step on the max and 0.0027 on the mean (an H100, random weights of
# seed 1); the limits are two steps and a quarter step. A random hac
# model's Viterbi path is a periodic cycle of moves with near-ties all along
# (CRF_SCALE), so a one-step change shifts stretches of it: seen 0.672 of the
# frames decoded alike; at least HAC_MIN_EQUAL must be.
HAC_MOVES_MAX, HAC_MOVES_MEAN, HAC_MIN_EQUAL = 0.0625, 0.0313 / 4, 0.5
INT8_MAX_STEPS, INT8_MEAN_STEPS = 1, 0.001  # see check_lstm_int8
# A random hac model's moves carry a large per-column offset, so over a
# 1666-frame chunk its Viterbi path settles either on staying or on one
# periodic cycle of moves. With the weights of seed 1 the CRF weight x 5
# (what tests/golden/hac_shipped_shape.json uses) gives almost only stays;
# x 8 gives a cycle through all four bases (seed 0 x 8 a homopolymer).
CRF_SCALE = 8.0

# fast geometry (dna_r10.4.1_e8.2_400bps_fast@v4.3): batch 1024, chunk 6000,
# stride 5 -> T = 1200 frames, 96 features, state_len 3 -> 64 states
FAST = "dna_r10.4.1_e8.2_400bps_fast@v4.3"
FN, FT, FH, FS = 1024, 1200, 96, 64
# A random fast model behaves like a random hac one: its output hardly
# depends on the signal. With the weights of seed 1 the CRF weight x 6 and
# below gives stays only, x 6.5 to 11 a cycle without T, x 16 and above a
# homopolymer or no stay at all; x 13 to 14 gives a cycle of ten bases
# through all four letters, with the stay at the head of a read. Found on
# the CPU with the plain versions, bf16, quantised and not.
FAST_CRF_SCALE = 13.5
# G + J against their plain versions: the head sums run in another order, so
# a near-tie (a winning margin under ~1e-4) may fall the other way and move a
# stretch of the traceback. Frames whose moves and sequence agree: at least
# DECODE_MIN_EQUAL of all; qstring within 1 on those. logZ is a running f32
# sum of T logs near 4000, where one f32 step is 2.4e-4.
DECODE_MIN_EQUAL = 0.999
LOGZ_ATOL, LOGZ_RTOL = 1e-3, 1e-5
# J's ring at H 96 (the fast head): 18 warps leave 96 registers a thread,
# and ptxas spills 8 bytes of a head warp's (PERF.md, kernel-table row 3);
# the stack frame and spills may not grow beyond that
J_SPILL_MAX = 8
# GW + JW, the fused-head decode above 256 states, on random heads of
# hac's width (N, Th, H, S, U, tanh, gain: no tanh, clamped to +-5) and
# sup's (1000 encoder frames x 2 phases of H 512, tanh x 5 and a bias),
# held to the tolerances of G + J
WIDE_HEADS = {"hac": (96, 1666, 1024, 1024, 1, False, 3.0),
              "sup": (128, 1000, 512, 1024, 2, True, 0.5)}


# sup geometry (dna_r10.4.1_e8.2_400bps_sup@v5.0): batch 128, chunk 12000,
# stride 12 into the transformer -> 1000 tokens of d 512 = 8 heads of 64,
# window (127, 128), x 2 upsample -> 2000 decode frames, S = 1024
SUP = "dna_r10.4.1_e8.2_400bps_sup@v5.0"
SN, ST, SH, SD, SWIN = 128, 1000, 8, 64, (127, 128)
# A random sup model needs no rescue: its tanh x 5 head already gives all
# four letters and no long homopolymer. With the weights of seed 1 the CRF
# weight as drawn emits on 97% of the frames and x 2 on every frame; x 0.5
# leaves 84% (16% stays). Found on the CPU with the plain versions, two
# chunks of 12000 samples, bf16 and f32 alike. The shallow model with heads
# of 40 behaves the same (84% at x 0.5).
SUP_CRF_SCALE = 0.5
# K and L against their plain versions: the same operands and rounding
# points, f32 sums in another order: one bf16 step of the largest output on
# the max in bf16 (a rounding of p or of the output can flip), ATTN_F32_TOL
# for K and L in f32 (bonito_tpu's tolerance for its kernel; K in f32 seen at
# 2.1e-06 at sup's width, NVIDIA H100 80GB HBM3, 700.00 W); ATTN_MEAN_TOL on
# the mean.
ATTN_F32_TOL, ATTN_MEAN_TOL = 2e-5, 1e-5
# One sup batch through 18 layers with K and P against 18 with their plain
# versions: each layer's attention is within a bf16 step of the other's, the
# layers in between (RMSNorm keeps |x| near 1) pass the difference on. In
# bf16 every layer rounds its output anew, so two runs that differ in one
# rounding drift apart by a fraction of a step everywhere, and a random
# model's paths tie often. Over random models of seeds 1 to 3
# (scripts/sup_drift.py) the move scores (tanh x 5, |m| <= 5, one bf16 step
# 0.0313 there) differ by 0.117 to 0.119 on the max and 0.0081 to 0.0084 on
# the mean, and the two decodes agree on 0.9562 to 0.9628 of the frames: the
# limits are eight steps, half a step and SUP_MIN_EQUAL. The same batch on an
# f32 copy of the model, where only K's own bf16 roundings can flip, holds
# the kernels' path tight: SUP_F32_MAX and SUP_F32_MEAN on the moves (seen:
# 9.2e-5 to 1.2e-4 and 5e-6). The decode kernels read bf16 moves, and that
# cast turns a difference of 1e-5 into a whole step on some entries, so a few
# frames of the f32 decodes may differ too (seen: 0, 0 and 23 of 256,000; 47
# of the shallow model's 64,000): at least SUP_F32_MIN_EQUAL agree.
SUP_MOVES_MAX, SUP_MOVES_MEAN, SUP_MIN_EQUAL = 0.25, 0.0313 / 2, 0.95
SUP_F32_MAX, SUP_F32_MEAN, SUP_F32_MIN_EQUAL = 1e-3, 5e-5, 0.998
# the shallow transformer whose heads (8 of 40; rotary_dim 40 is no multiple
# of 16) the fused kernel's gate rejects: every layer runs apply_rotary and
# then L, in bf16, on batches of 32 chunks of 1000 tokens
D40 = dict(d_model=320, nhead=8, depth=2, dim_feedforward=1280, batchsize=32)
D40_N, D40_H, D40_D = 32, 8, 40
# its batch through P + 2 x L against the plain versions, in bf16 (seen on
# an H100: 0.0469, 0.00084, 0.9947 of the frames); its f32 copy is held to
# SUP_F32_*
D40_MOVES_MAX, D40_MOVES_MEAN, D40_MIN_EQUAL = 0.125, 0.003, 0.98

# The CRF training loss (kernels U to Z) at hac training width, as the JAX
# package's train bench builds it: lstm_crf_config() in bf16 with
# quantize=false (the hac bf16 directory above), batch 128 x chunk 6000 ->
# T = 1000 frames, S = 1024; targets of 250 to 500 bases (1..4) from the
# seed, so up to P = 496 lattice positions. The kernels alone also run at
# fast's training shapes and sup's: (N, T, S, L) below.
TRAIN_N, TRAIN_CHUNK, TRAIN_L = 128, 6000, 500
LOSS_SHAPES = {"hac": (128, 1000, 1024, 500), "fast": (128, 1200, 64, 600),
               "sup": (32, 2048, 1024, 1024)}
# Tolerances of the loss kernels against their plain versions, which take
# the same f32 steps in the same order (equality is expected, not
# required). Forward values (alpha stacks, logZ, the loss) and Z's f32
# gradient: within F32_STEPS f32 steps of the output's largest magnitude
# (another sum order moves a value by a step or two). The gradients of V and
# X, rounded to bf16 as the TPU kernels round them: each entry within one
# bf16 step of its own magnitude (another f32 sum order can round to the
# neighbouring bf16 value), at least GRAD_MIN_EQUAL of the entries equal.
# A path's gradient adds the lattice branch's to logZ's, each a posterior
# (at most 1) times the row's cotangent g_row = 1 / (length x rows): each
# entry within one bf16 step of |g_row| plus one of its own value, at least
# GRAD_MIN_EQUAL equal (the gather's backward adds repeated columns with
# atomics, in no fixed order).
F32_STEPS, GRAD_MIN_EQUAL = 4, 0.99

# The LSTM-CRF train step (kernels R and S, with U to Z) at hac training
# width: lstm_crf_config() with f32 master weights and a bf16 forward, batch
# 128 x chunk 6000, AdamW 2e-3, clip 2.0; TRAIN_STEPS timed steps after a
# warm-up. R and S alone at hac and fast training shapes (N, T, H).
HAC = "dna_r10.4.1_e8.2_400bps_hac@v4.3"
TRAIN_SHAPES = {"hac": (128, 1000, 1024), "fast": (128, 1200, 96)}
TRAIN_STEPS, TRAIN_CLI_BATCHES = 3, 3
# R and S against their plain versions: h rounded to bf16 each step, f32
# sums in another order, so a flipped rounding moves a trajectory by a few
# bf16 steps (as kernel A's); each output's worst difference relative to its
# largest magnitude within LSTM_TRAIN_MAX, the mean within LSTM_TRAIN_MEAN
# (seen on the H100: at most 0.0061 and 1.3e-4, dW_hh's mean the largest).
LSTM_TRAIN_MAX, LSTM_TRAIN_MEAN = 2.0 ** -6, 1e-3
# One hac step's gradients through the kernels against the plain versions':
# each parameter's within TRAIN_GRAD_REL (relative L2; a convolution bias in
# front of BatchNorm, whose gradient is 0 in exact arithmetic, relative to
# its weight's), the losses within TRAIN_LOSS_TOL.
TRAIN_GRAD_REL, TRAIN_LOSS_TOL = 0.05, 1e-3

# The sup train step (kernels H and O, P twice, with U, V, Y, Z) as the JAX
# package's sup train bench builds it (bench.py:221-254): the shipped sup
# model with f32 master weights and a bf16 forward, batch 32 x chunk 12288 ->
# 1024 tokens, 2048 decode frames; targets of 1024 bases (1..4) from the
# seed; AdamW 2e-3, clip 2.0; TRAIN_STEPS timed steps after a warm-up. H and
# O alone at the step's shapes (T 1024) and at the shipped basecall chunk's
# (T 1000), in bf16 and f32, with t_real < T and a partial rotary_dim.
SUP_TRAIN_N, SUP_TRAIN_CHUNK, SUP_TRAIN_L = 32, 12288, 1024
SUP_TRAIN_T = SUP_TRAIN_CHUNK // 12  # tokens
SUP_TRAIN_CLI_BATCHES = 2
# the sup train --no-amp step (phase 15): the bench's batch if it fits in
# f32, else the largest of these
SUP_NO_AMP_N = (32, 16, 8)
# H and O against their plain versions on the same inputs (O's o and lse
# are H's): the same bf16 operands and rounding points, f32 sums in another
# order and exp's last bit, which can flip a bf16 rounding of p, ds or an
# output. o, dq, dk, dv: one bf16 step of the output's largest magnitude on
# the max, ROW13_MEAN of it on the mean; lse: ROW13_LSE_STEPS f32 steps of
# its largest magnitude. H's o equals K's bit for bit.
ROW13_MEAN, ROW13_LSE_STEPS = 2.0 ** -16, 16


PHASE_AT = {}  # "[n]" -> when its first line was logged (perf_counter)


def log(msg):
    m = re.match(r"\[(\d+)\]", msg)
    if m and m.group(1) not in PHASE_AT:
        PHASE_AT[m.group(1)] = time.perf_counter()
    print(msg, flush=True)


def phase_seconds(end):
    """Each phase's seconds, from its first line to the next phase's (the
    last one's to ``end``)."""
    marks = sorted(PHASE_AT.items(), key=lambda kv: kv[1])
    return {k: round((marks[i + 1][1] if i + 1 < len(marks) else end) - t, 1)
            for i, (k, t) in enumerate(marks)}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops, peak_ops, more_ops=0, more_peak=H100_F32_OPS):
    """The least time in ms for the bytes and for the operations (of up to
    two kinds, each at its own peak), and which of the two it is."""
    t_bytes = n_bytes / H100_BYTES * 1e3
    t_ops = (n_ops / peak_ops + more_ops / more_peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(report):
    """One line per kernel: demangled-enough name, registers, smem, spills."""
    rows, name, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            base = re.search(r"(lstm_step_bf16|lstm_persistent_bf16|"
                             r"lstm_bptt_persistent|"
                             r"lstm_int8_step|lstm_int8_persistent|"
                             r"lstm_train_(?:fwd|bwd)_step|"
                             r"lstm_fused_bf16_kernel|lstm_fused_mma_kernel|"
                             r"lstm_fused_f32_kernel|"
                             r"fused_rotary_window_attention_kernel|"
                             r"window_attention_kernel|"
                             r"window_attention_bwd_kernel|"
                             r"window_bwd_rows_kernel|"
                             r"local_attention_(?:tc|f32)_kernel|"
                             r"relayout_transpose_tiles|relayout_transpose|"
                             r"relayout_gather|"
                             r"(?:logz|lattice)_(?:full_)?(?:fwd|bwd)"
                             r"(?:_ring|_split)?_kernel|"
                             r"decode_(?:fwd|bwd)_ring_kernel|"
                             r"head_product_kernel|"
                             r"decode_fused_(?:fwd|bwd)_ring|"
                             r"decode_(?:fused_(?:wide_)?)?(?:fwd|bwd))", m.group(1))
            tmpl = "bf16" if "bfloat16" in m.group(1) else "f32"
            name = base.group(1) if base else m.group(1)
            resident = re.search(r"(?:fwd|bwd)ILb(\d)EE", m.group(1))
            padded = re.search(r"(?:tc_kernel|persistent_bf16)ILi(\d+)E"
                               r"(?:Lb(\d)E)?E", m.group(1))
            bptt = re.search(r"bptt_persistentILi(\d+)ELi(\d+)EE",
                             m.group(1))
            tiles = re.search(r"kernelILi(\d+)ELi(\d+)EE", m.group(1))
            window = re.search(r"window_attention_kernelI(13__nv_bfloat16|f)"
                               r"Li(\d+)ELb(\d)EE", m.group(1))
            window_bwd = re.search(r"window_attention_bwd_kernelILi(\d+)EE",
                                   m.group(1))
            f32f = re.search(r"lstm_fused_f32_kernelILi(\d+)EE",
                             m.group(1))
            mma = re.search(r"lstm_fused_mma_kernelILi(\d+)ELi(\d+)EE",
                            m.group(1))
            zsplit = re.search(r"lattice_bwd_split_kernelILi(\d+)ELi(\d+)EE",
                               m.group(1))
            ysplit = re.search(r"lattice_fwd_split_kernelILi(\d+)ELi(\d+)E"
                               r"Lb(\d)EE", m.group(1))
            jring = re.search(r"decode_fused_(?:fwd|bwd)_ringILi(\d+)ELi"
                              r"(\d+)EE", m.group(1))
            product = re.search(r"head_product_kernelILi(\d+)ELi(\d+)ELi"
                                r"(\d+)ELi(\d+)EE", m.group(1))
            if product:
                name = (f"{name}<{product.group(1)} x {product.group(2)}, k "
                        f"{product.group(3)} a step, ring of "
                        f"{product.group(4)}>")
            elif mma:
                name = (f"{name}<C={16 * int(mma.group(1))}, H="
                        f"{16 * int(mma.group(2))}, weights in registers>")
            elif f32f:
                kh = int(f32f.group(1))
                name = (f"{name}<W_hh's column in registers at H={16 * kh}>"
                        if kh else f"{name}<W_hh through L2>")
            elif jring:
                name = (f"{name}<H={16 * int(jring.group(1))}, "
                        f"{jring.group(2)} m-tiles a head warp>")
            elif zsplit:
                name = (f"{name}<{zsplit.group(1)} positions a thread, "
                        f"{zsplit.group(2)} frames ahead>")
            elif ysplit:
                name = (f"{name}<{ysplit.group(1)} positions a thread, "
                        f"{ysplit.group(2)} frames ahead, stack="
                        f"{ysplit.group(3)}>")
            elif window:
                name = (f"{name}<{'f32' if window.group(1) == 'f' else 'bf16'}"
                        f", head dim up to {window.group(2)}, "
                        f"lse={window.group(3)}>")
            elif window_bwd:
                name = f"{name}<bf16, head dim up to {window_bwd.group(1)}>"
            elif padded and name.startswith("lstm"):
                train = ", R's stores" if padded.group(2) == "1" else ""
                name = f"{name}<rows={16 * int(padded.group(1))}{train}>"
            elif bptt:
                name = (f"{name}<rows={16 * int(bptt.group(1))}, cluster="
                        f"{bptt.group(2)}>")
            elif padded:
                name = f"{name}<bf16, head dim padded to {padded.group(1)}>"
            elif resident:
                name = f"{name}<weights in shared memory={resident.group(1)}>"
            elif tiles:
                name = (f"{name}<weight k-tiles in registers="
                        f"{tiles.group(1)}+{tiles.group(2)}>")
            elif name.startswith("lstm_train"):
                name += (" <c, activations, gradient stored in bf16>"
                         if "stepI13__nv_bfloat16" in m.group(1)
                         else " <c, activations, gradient stored in f32>")
            elif name.startswith(("logz", "lattice")):
                # the template arguments as the mangled name gives them
                name += f" [{m.group(1).split('_kernel', 1)[1]}]"
            elif name.endswith("_ring_kernel"):
                full = re.search(r"FullRowsI(13__nv_bfloat16|f)Lb([01])E",
                                 m.group(1))
                tcn = ("<TcnRows, bf16: B, C>" if "TcnRowsI13" in m.group(1)
                       else "<TcnRows, f32: GW, JW>")
                name += (tcn if full is None else
                         f"<FullRows: M, Q, "
                         f"{'bf16' if full.group(1) != 'f' else 'f32'}, "
                         f"{'reverse' if full.group(2) == '1' else 'forward'}"
                         f" strand>")
            elif "decode" in name:
                frame = re.search(r"(Tcn|RevFull|Full)Frame", m.group(1))
                name = (f"{name}<{frame.group(1)} frame, {tmpl}>" if frame
                        else f"{name}<{tmpl}>")
            io = None if window else re.search(
                r"(?:attention_kernel|relayout_\w+?)I"
                r"(13__nv_bfloat16|5uint4|[fhtjm])(?:Li(\d+)E)?", m.group(1))
            if io:
                kinds = {"13__nv_bfloat16": "bf16", "f": "f32", "h": "1 byte",
                         "t": "2 bytes", "j": "4 bytes", "m": "8 bytes",
                         "5uint4": "16 bytes"}
                name = f"{name}<{kinds[io.group(1)]}" + (
                    f", head dim up to {io.group(2)}>" if io.group(2) else ">")
            flags = re.search(r"lstm_int8_(?:step|persistent)ILi(\d+)ELb(\d)"
                              r"ELb(\d)E", m.group(1))
            if flags:
                tile = int(flags.group(1)) * (16 if "persistent" in name
                                              else 1)
                name = (f"{name}<rows={tile}, fused="
                        f"{flags.group(2)}, out_int8={flags.group(3)}>")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = (f"stack {m.group(1)} B, spills {m.group(2)}/"
                      f"{m.group(3)} B")
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append(f"  {name}: {m.group(1)} registers, {m.group(2) or 0} "
                        f"B static smem, {spills}")
            name = None
    return rows


def check_lstm(torch, lstm_cuda, dev):
    """Kernel A against its plain version, both directions, bf16. Both
    round h to bf16 every step but sum the f32 products in another order,
    so a rounding can flip and the trajectories drift apart by a few bf16
    steps of |h| <= 1 (one bf16 step is 2**-8 on [0.5, 1)); the tolerance
    is four such steps on the max and LSTM_MEAN_TOL on the mean absolute
    difference."""
    g = torch.Generator().manual_seed(SEED)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)
    w_hh = (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).to(
        dev, torch.bfloat16)
    errs = []
    for reverse in (False, True):
        out = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
        torch.cuda.synchronize()
        ref = lstm_cuda.lstm_recurrence_plain(xw, w_hh, reverse=reverse)
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        log(f"  kernel A reverse={reverse}: max |h - plain| {err:.3g}, "
            f"mean {mean:.3g} (tolerance {LSTM_ATOL} / {LSTM_MEAN_TOL})")
        require(torch.isfinite(out.float()).all().item(), "kernel A: non-finite h")
        require(err <= LSTM_ATOL and mean <= LSTM_MEAN_TOL,
                f"kernel A disagrees with its plain version: max {err}, "
                f"mean {mean}")
        errs.append(err)
    return xw, w_hh, max(errs)


def check_lstm_int8(torch, int8, lstm_int8_cuda, dev):
    """Kernels D and E against their plain versions, both directions, D
    with int8 and with bf16 output. Kernel and plain version do the same
    exact integer sums and the same f32 operations in the same order;
    only expf/tanhf can differ in the last bit and move an h across a
    half step. Differences are counted in int8 steps of 1/127: at most
    INT8_MAX_STEPS, INT8_MEAN_STEPS on the mean (none was seen: every run
    so far gave equal outputs). Each runs as one persistent launch, the
    plan ``persistent_plan`` gives, and its output equals its step
    kernel's (torch.equal): the same int32 sums and f32 operations."""
    g = torch.Generator().manual_seed(SEED + 2)
    x_q = torch.randint(-127, 128, (T, N, H), generator=g,
                        dtype=torch.int8).to(dev)
    w_ih_q, ih_scales = int8.quantize_cols(
        (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).numpy())
    w_hh_q, scales = int8.quantize_whh(
        (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).numpy())
    w_ih_q, w_hh_q = (torch.from_numpy(w).to(dev) for w in (w_ih_q, w_hh_q))
    ih_scales = torch.from_numpy(ih_scales).to(dev) * int8.H_STEP
    scales = torch.from_numpy(scales).to(dev)
    b = (0.5 * torch.randn(4 * H, generator=g)).to(dev)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)
    d_args = (x_q, w_ih_q, w_hh_q, ih_scales, scales, b)
    e_args = (xw, w_hh_q, scales)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {"D": lstm_int8_cuda.persistent_plan(N, H, H, sms),
             "E": lstm_int8_cuda.persistent_plan(N, None, H, sms,
                                                 fused=False)}
    require(plans["D"] is not None and plans["E"] is not None,
            f"no persistent plan for D or E at hac: {plans}")
    cases = [("D", lstm_int8_cuda.lstm_int8_fused,
              lstm_int8_cuda.lstm_int8_fused_step_kernel,
              lstm_int8_cuda.lstm_int8_fused_plain, d_args,
              dict(reverse=r, out_int8=o))
             for r in (False, True) for o in (True, False)]
    cases += [("E", lstm_int8_cuda.lstm_int8_recurrence,
               lstm_int8_cuda.lstm_int8_recurrence_step_kernel,
               lstm_int8_cuda.lstm_int8_recurrence_plain, e_args,
               dict(reverse=r)) for r in (False, True)]
    errs = {"D": 0.0, "E": 0.0}
    for name, kernel, step_kernel, plain, args, kw in cases:
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        require(kernel.plan == plans[name],
                f"kernel {name} ran {kernel.plan}, not the plan "
                f"{plans[name]}")
        same = torch.equal(out, step_kernel(*args, **kw))
        log(f"  kernel {name} {kw}: one persistent launch ({plans[name]['ctas']}"
            f" CTAs in clusters of {plans[name]['cluster']}, "
            f"{plans[name]['rows']} rows each); equal to its step kernel: "
            f"{same}")
        require(same, f"kernel {name}'s persistent launch differs from its "
                f"step kernel ({kw})")
        ref = plain(*args, **kw)
        require(out.dtype == ref.dtype, f"kernel {name}: dtype {out.dtype}")
        unit = 1.0 if out.dtype == torch.int8 else 127.0
        steps = (out.float() - ref.float()).abs() * unit
        worst, mean = steps.max().item(), steps.mean().item()
        spread = out.float().std().item() / (127.0 / unit)
        log(f"  kernel {name} {kw}: max |h - plain| {worst:.3g} int8 steps, "
            f"mean {mean:.3g} (tolerance {INT8_MAX_STEPS} / "
            f"{INT8_MEAN_STEPS}); std of h {spread:.3f}")
        # bf16 output: a bf16 step of h is up to half an int8 step
        limit = INT8_MAX_STEPS + (0 if out.dtype == torch.int8 else 0.5)
        require(spread > 0.05, f"kernel {name}: h does not vary")
        require(worst <= limit and mean <= INT8_MEAN_STEPS,
                f"kernel {name} disagrees with its plain version: max "
                f"{worst}, mean {mean} int8 steps")
        errs[name] = max(errs[name], worst / 127.0)
    return d_args, e_args, errs, plans


DECODE_OUTPUTS = ("move_in", "choices", "c", "logZ", "end state",
                  "sequence", "qstring", "moves")


def outputs_differ(torch, fwd, out, fwd2, out2):
    """Two decodes' eight outputs (the forward pass's five, the backward
    pass's three): the names of those that differ in any bit and the
    largest difference."""
    torch.cuda.synchronize()
    pairs = list(zip(fwd, fwd2)) + [
        (out[k], out2[k]) for k in ("sequence", "qstring", "moves")]
    differ = [name for name, (a, b) in zip(DECODE_OUTPUTS, pairs)
              if not torch.equal(a.contiguous().view(torch.uint8),
                                 b.contiguous().view(torch.uint8))]
    worst = max((a.double() - b.double()).abs().max().item()
                for a, b in pairs)
    return differ, worst


def ring_vs_old_kernel(torch, decode_cuda, moves, blank, fwd, out, **q):
    """B's and C's outputs on the ring (``fwd``, ``out``: the wrappers'
    on ``decode_plan``'s plan) against the earlier kernels' on the same
    moves: the names of the outputs that differ in any bit (none where both
    take the same f32 steps) and the largest difference."""
    old_fwd = decode_cuda.tcn_forward_old_kernel(moves, blank)
    old = decode_cuda.tcn_backward_old_kernel(moves, *old_fwd, blank, **q)
    return outputs_differ(torch, fwd, out, old_fwd, old)


def check_decode(torch, decode_cuda, dev):
    """Kernels B and C against their plain versions on the same bf16
    moves: choices, end states, sequence and moves identical (the max
    semiring does the same f32 adds in both), qstring within one step; and
    on the ring (``decode_plan`` gives a plan at hac) against the earlier
    kernels, bit for bit on all eight outputs."""
    g = torch.Generator().manual_seed(SEED + 1)
    moves = (3 * torch.randn(N, T, 4 * S, generator=g)).clamp(-5, 5).to(
        dev, torch.bfloat16)
    blank = 2.0
    fwd = decode_cuda.tcn_forward(moves, blank)
    out = decode_cuda.tcn_backward(moves, *fwd, blank, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    ref_fwd = decode_cuda.tcn_forward_plain(moves, blank)
    ref = decode_cuda.tcn_backward_plain(moves, *ref_fwd, blank, qscale=1.05,
                                         qbias=0.2)
    require(torch.equal(fwd[1], ref_fwd[1]), "kernel B: choices differ")
    require(torch.equal(fwd[4], ref_fwd[4]), "kernel B: end states differ")
    err_b = (fwd[0] - ref_fwd[0]).abs().max().item()
    err_lz = (fwd[3] - ref_fwd[3]).abs().max().item()
    log(f"  kernel B: choices and end states identical; max |move_in - "
        f"plain| {err_b:.3g}, max |logZ - plain| {err_lz:.3g}")
    require(err_b <= 1e-4 and err_lz <= 1e-3 * T,
            f"kernel B disagrees with its plain version: {err_b}, {err_lz}")
    for k in ("sequence", "moves"):
        require(torch.equal(out[k], ref[k]), f"kernel C: {k} differs")
    dq = (out["qstring"].int() - ref["qstring"].int()).abs().max().item()
    frac = out["moves"].float().mean().item()
    log(f"  kernel C: sequence and moves identical; max |dq| {dq}; "
        f"{frac:.3f} of frames move")
    require(dq <= 1, f"kernel C: qstring off by {dq}")
    plans = (decode_cuda.tcn_forward.plan, decode_cuda.tcn_backward.plan)
    require(plans[0] is not None and plans[1] is not None,
            "kernels B and C did not run on the ring at hac")
    differ, vs_old = ring_vs_old_kernel(torch, decode_cuda, moves, blank,
                                        fwd, out, qscale=1.05, qbias=0.2)
    log(f"  B and C on the ring (plan {plans[0]}) vs the earlier kernels: "
        f"outputs that differ in any bit {differ}, max |diff| {vs_old:.3g}")
    require(not differ, f"kernels B and C on the ring differ from the "
            f"earlier kernels in {differ}")
    return moves, blank, fwd, err_b, float(dq), plans[0], vs_old


def hold_full(torch, decode_full_cuda, scores, reverse=False, **q):
    """Kernels M + Q on full scores (``reverse``: the reverse strand read
    from them in place) against their plain versions and against their
    earlier kernels on the same tensor. Returns M's outputs, Q's, and the
    comparison: choices and end states identical (as for B and C: the max
    semiring does the same f32 adds in both), max |move_in - plain|, logZ
    within LOGZ_*, sequence and moves identical, max |dq|; the plan they
    ran, the outputs that differ from the earlier kernels' in any bit and
    the largest difference; ``ok`` when all of them hold (qstring within
    one step, on the ring, bit for bit with the earlier kernels)."""
    fwd = decode_full_cuda.full_forward(scores, reverse=reverse)
    out = decode_full_cuda.full_backward(scores, *fwd, reverse=reverse, **q)
    plans = (decode_full_cuda.full_forward.plan,
             decode_full_cuda.full_backward.plan)
    torch.cuda.synchronize()
    ref_fwd = decode_full_cuda.full_forward_plain(scores, reverse=reverse)
    ref = decode_full_cuda.full_backward_plain(scores, *ref_fwd,
                                               reverse=reverse, **q)
    old_fwd = decode_full_cuda.full_forward_old_kernel(scores,
                                                       reverse=reverse)
    old = decode_full_cuda.full_backward_old_kernel(scores, *old_fwd,
                                                    reverse=reverse, **q)
    d_lz = (fwd[3] - ref_fwd[3]).abs()
    h = {"same": all(torch.equal(fwd[i], ref_fwd[i]) for i in (1, 4)),
         "err_in": (fwd[0] - ref_fwd[0]).abs().max().item(),
         "d_lz": d_lz.max().item(), "lz": ref_fwd[3].abs().mean().item(),
         "ok_lz": (d_lz <= LOGZ_ATOL + LOGZ_RTOL * ref_fwd[3].abs()).all()
         .item(),
         "exact": all(torch.equal(out[k], ref[k])
                      for k in ("sequence", "moves")),
         "dq": (out["qstring"].int() - ref["qstring"].int()).abs().max()
         .item(),
         "frac": out["moves"].float().mean().item(), "plan": plans[0]}
    h["differ_old"], h["vs_old"] = outputs_differ(torch, fwd, out, old_fwd,
                                                  old)
    h["ok"] = (h["same"] and h["err_in"] <= 1e-4 and h["ok_lz"] and h["exact"]
               and h["dq"] <= 1 and None not in plans
               and not h["differ_old"])
    h["text"] = (
        f"choices and end states identical {h['same']}; max |move_in - "
        f"plain| {h['err_in']:.3g}, max |logZ - plain| {h['d_lz']:.3g} at "
        f"|logZ| about {h['lz']:.4g} (tolerance {LOGZ_ATOL} + {LOGZ_RTOL} "
        f"|logZ|); sequence and moves identical {h['exact']}, max |dq| "
        f"{h['dq']}; {h['frac']:.3f} of frames move; on the ring (plan "
        f"{plans[0]}) vs the earlier kernels: outputs that differ in any bit "
        f"{h['differ_old']}, max |diff| {h['vs_old']:.3g}")
    return fwd, out, h


def reverse_vs_copy(torch, decode_full_cuda, seqdist, scores, fwd, out, **q):
    """The reverse strand read in place (``fwd``, ``out``: M's and Q's
    outputs with reverse=True) against M + Q on the copy
    ``seqdist.reverse_complement(scores)``: the names of the outputs that
    differ in any bit (move_in and choices taken in the forward strand's
    order of states, ``rc_states``) and the largest difference."""
    rc = seqdist.reverse_complement(scores)
    ref_fwd = decode_full_cuda.full_forward(rc)
    ref = decode_full_cuda.full_backward(rc, *ref_fwd, **q)
    cols = decode_full_cuda.rc_states(scores.shape[-1] // 5).to(scores.device)
    ref_fwd = (ref_fwd[0][..., cols], ref_fwd[1][..., cols], *ref_fwd[2:])
    return outputs_differ(torch, fwd, out, ref_fwd, ref)


def full_decode_bounds(scores):
    """The bounds of M and Q on full scores [N, T, 5S]: M reads the scores
    and writes move-in f32, choices, c, logZ and the end state; Q reads
    them, as C a quarter of move-in, one choice per frame (the
    traceback's), c, logZ and the end state, and writes three [N, T]
    planes; about 25 f32 operations per state and frame (one more exp than
    B and C, the stay plane's)."""
    N, T, S5 = scores.shape
    S = S5 // 5
    n_in = scores.numel() * scores.element_size()
    ops = 25 * N * T * S
    return (bound(n_in + N * T * S * 5 + N * T * 4 + N * 8, ops, H100_F32_OPS),
            bound(n_in + N * T * (S // 4) * 4 + N * T * 5 + N * 8 + 3 * N * T,
                  ops, H100_F32_OPS))


def time_full(torch, decode_full_cuda, seqdist, scores, plain=False):
    """M's and Q's times on full scores: on the ring reading the reverse
    strand in place (what the reverse paths run) and the forward strand;
    their earlier kernels on the forward strand (the parent's M and Q, the
    work they did on the reverse_complement copy); the copy itself; with
    ``plain`` the in-place read's plain versions; and the bounds."""
    f = decode_full_cuda
    t = {}
    for key, rev in (("rev", True), ("fwd", False)):
        fwd = f.full_forward(scores, reverse=rev)
        t["M_" + key] = cuda_ms(lambda: f.full_forward(scores, reverse=rev),
                                reps=3)
        t["Q_" + key] = cuda_ms(
            lambda: f.full_backward(scores, *fwd, reverse=rev), reps=3)
    t["plan"] = f.full_forward.plan
    require(t["plan"] is not None and f.full_backward.plan is not None,
            f"M and Q did not run on the ring at {tuple(scores.shape)}")
    fwd = f.full_forward_old_kernel(scores)
    t["M_old"] = cuda_ms(lambda: f.full_forward_old_kernel(scores), reps=3)
    t["Q_old"] = cuda_ms(lambda: f.full_backward_old_kernel(scores, *fwd),
                         reps=3)
    t["rc"] = cuda_ms(lambda: seqdist.reverse_complement(scores), reps=3)
    if plain:
        fwd = f.full_forward(scores, reverse=True)
        t["M_plain"] = cuda_ms(
            lambda: f.full_forward_plain(scores, reverse=True), reps=1,
            warmup=0)
        t["Q_plain"] = cuda_ms(
            lambda: f.full_backward_plain(scores, *fwd, reverse=True),
            reps=1, warmup=0)
    t["bounds"] = full_decode_bounds(scores)
    return t


def full_times_text(t):
    (bm, by), (bq, _) = t["bounds"]
    return (f"M {t['M_rev']:.4g} ms, Q {t['Q_rev']:.4g} ms on the ring "
            f"reading the reverse strand in place (forward strand "
            f"{t['M_fwd']:.4g}, {t['Q_fwd']:.4g}; plan {t['plan']}; bounds "
            f"{bm:.4g} and {bq:.4g} ms by {by}); their earlier kernels "
            f"{t['M_old']:.4g} and {t['Q_old']:.4g} ms; reverse_complement "
            f"of the scores {t['rc']:.4g} ms")


def full_more(tm, rev_steps, key, vs_old):
    """The kernels line's extra keys of M or Q (``key``): the plan, the
    times beside the earlier kernels' at each shape, the forward strand's,
    the copy's, and the reverse paths' device steps beside the parent's
    route."""
    i = 0 if key == "M" else 1
    more = {"plan": tm["hac"]["plan"],
            "old_kernel_ms": tm["hac"][key + "_old"],
            "forward_strand_ms": tm["hac"][key + "_fwd"],
            "max_abs_err_vs_old_kernel": vs_old,
            "reverse_complement_ms": tm["hac"]["rc"]}
    for shape in ("fast", "sup"):
        t = tm[shape]
        more.update({f"{shape}_shape_ms": t[key + "_rev"],
                     f"{shape}_shape_old_kernel_ms": t[key + "_old"],
                     f"{shape}_shape_forward_strand_ms": t[key + "_fwd"],
                     f"{shape}_shape_bound_ms": t["bounds"][i][0],
                     f"{shape}_shape_reverse_complement_ms": t["rc"]})
    for path, steps in rev_steps.items():
        more[f"{path}_device_step_ms"] = steps["step"]
        more[f"{path}_device_step_parent_route_ms"] = steps["copy_old"]
        if "copy" in steps:
            more[f"{path}_device_step_copy_and_ring_ms"] = steps["copy"]
    return more


def random_full_scores(torch, dev, n, t, s):
    """bf16 full scores [n, t, 5 s] drawn on the card from SEED + 9: a stay
    plane that is not constant. The same draw for the same shape, so phase 8
    times what phase 3 checked without holding it on the card through the
    paths of phase 5."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    return (3 * torch.randn(n, t, 5 * s, generator=g, device=dev)).clamp(
        -5, 5).to(torch.bfloat16)


def check_decode_full(torch, decode_full_cuda, dev):
    """Kernels M and Q on the ring against their plain versions and their
    earlier kernels (``hold_full``) on the same bf16 full scores with a
    stay plane that is not constant, at hac widths (N=96, T=1666, S=1024)
    and fast widths (N=1024, T=1200, S=64)."""
    err_m, err_q, vs_old = 0.0, 0.0, 0.0
    for name, n, t, s in (("hac", N, T, S), ("fast", FN, FT, FS)):
        scores = random_full_scores(torch, dev, n, t, s)
        _, _, h = hold_full(torch, decode_full_cuda, scores, qscale=1.05,
                            qbias=0.2)
        log(f"  kernels M + Q, {name} (N={n}, T={t}, S={s}): {h['text']}")
        require(h["ok"], f"kernels M + Q ({name}) disagree with their plain "
                f"versions or their earlier kernels, or ran off the ring")
        require(0.01 < h["frac"] < 1,
                f"kernels M + Q ({name}): degenerate decode")
        err_m, err_q = max(err_m, h["err_in"]), max(err_q, float(h["dq"]))
        vs_old = max(vs_old, h["vs_old"])
    return err_m, err_q, vs_old


def hold_reverse_batch(torch, decode_full_cuda, model, xc, name, **q):
    """One batch of a reverse path: the model's full scores of the wire
    batch ``xc``, the reverse strand read from them in place through M + Q
    on the ring, held against the plain versions and the earlier kernels
    (``hold_full``) and against M + Q on the copy
    ``seqdist.reverse_complement(scores)`` (``reverse_vs_copy``), all bit
    for bit but the plain versions' qstring. Returns the scores, Q's
    outputs and the comparison."""
    with torch.inference_mode():
        scores = model(xc[..., None])
        fwd, out, h = hold_full(torch, decode_full_cuda, scores, reverse=True,
                                **q)
        h["differ_copy"], h["vs_copy"] = reverse_vs_copy(
            torch, decode_full_cuda, model.seqdist, scores, fwd, out, **q)
    log(f"  {name} reverse path, one batch: scores {tuple(scores.shape)} "
        f"{str(scores.dtype)[6:]} read in reverse-complement order in place "
        f"through M + Q vs their plain versions: {h['text']}; vs M + Q on "
        f"the reverse_complement copy: outputs that differ in any bit "
        f"{h['differ_copy']}, max |diff| {h['vs_copy']:.3g}")
    require(h["ok"], f"{name} reverse path: M + Q disagree with their plain "
            f"versions or their earlier kernels, or ran off the ring")
    require(not h["differ_copy"], f"{name} reverse path: the in-place read "
            f"differs from the copy in {h['differ_copy']}")
    require(0.01 < h["frac"] < 1, f"{name} reverse path: degenerate decode")
    return scores, out, h


def check_lstm_fused(torch, lstm_fused_cuda, dev):
    """Kernel F against its plain version at fast widths, both directions,
    with and without a bias. As for kernel A: both round h to bf16 every
    step and sum in f32 in another order, so the tolerance is LSTM_ATOL
    (four bf16 steps) on the max and LSTM_MEAN_TOL on the mean. On its mma
    kernel (``fused_plan`` gives a plan at fast widths) h equals the
    earlier kernel's bit for bit. Returns the inputs, the worst difference
    to the plain version, the plan and the largest |h - the earlier
    kernel's h| of the four cases."""
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.tanh(torch.randn(FT, FN, FH, generator=g)).to(dev, torch.bfloat16)
    w_ih, w_hh = ((torch.randn(FH, 4 * FH, generator=g) / math.sqrt(FH)).to(
        dev, torch.bfloat16) for _ in range(2))
    b = (0.5 * torch.randn(4 * FH, generator=g)).to(dev)
    worst = vs_old = 0.0
    for reverse, bias in ((False, b), (True, b), (False, None), (True, None)):
        out = lstm_fused_cuda.lstm_fused(x, w_ih, w_hh, bias, reverse=reverse)
        torch.cuda.synchronize()
        ref = lstm_fused_cuda.lstm_fused_plain(x, w_ih, w_hh, bias,
                                               reverse=reverse)
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        spread = out.float().std().item()
        log(f"  kernel F reverse={reverse} bias={bias is not None}: max |h - "
            f"plain| {err:.3g}, mean {mean:.3g} (tolerance {LSTM_ATOL} / "
            f"{LSTM_MEAN_TOL}); std of h {spread:.3f}")
        require(torch.isfinite(out.float()).all().item() and spread > 0.05,
                "kernel F: h is not finite or does not vary")
        require(err <= LSTM_ATOL and mean <= LSTM_MEAN_TOL,
                f"kernel F disagrees with its plain version: max {err}, "
                f"mean {mean}")
        plan = lstm_fused_cuda.lstm_fused.plan
        old = lstm_fused_cuda.lstm_fused_old_kernel(x, w_ih, w_hh, bias,
                                                    reverse=reverse)
        differ = (out != old).sum().item()
        d_old = (out.float() - old.float()).abs().max().item()
        log(f"    on the mma kernel vs the earlier kernel: {differ} of "
            f"{out.numel()} values differ in any bit, max |diff| {d_old:.3g}")
        require(plan is not None and differ == 0,
                f"kernel F at fast widths: plan {plan}, {differ} values "
                f"differ from the earlier kernel")
        worst, vs_old = max(worst, err), max(vs_old, d_old)
    plan = lstm_fused_cuda.lstm_fused.plan
    log(f"  kernel F's plan: {plan}")
    return (x, w_ih, w_hh, b), worst, plan, vs_old


def fused_head(torch, HeadSplit, dev, N, Th, H, S, U, tanh, gain):
    """A random head split from the seed: tanh x 5 with a bias (sup's kind),
    or a linear head clamped to +-5 (hac's and fast's). The same draw for
    the same shape, so phase 8 times what phase 3 checked."""
    g = torch.Generator().manual_seed(SEED + 4 + U)
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(dev, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / math.sqrt(H)).to(
        dev, torch.bfloat16)
    bias = ((0.3 * torch.randn(U, 4 * S, generator=g)).to(dev) if tanh
            else None)
    return HeadSplit(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                     None if tanh else -5.0, None if tanh else 5.0, 2.0)


def hold_fused(torch, decode_fused_cuda, head, name, kernels, **q):
    """A head through the fused-head decode (G + J, or GW + JW above 256
    states) on the route ``viterbi_decode_head`` takes (GW's head product
    once, into ``move_buffer``'s tensor, which JW reads) and through their
    plain versions. Tolerances: DECODE_MIN_EQUAL and LOGZ_* above, move-in
    within 1e-4; GW's moves equal to ``head_moves_plain``'s bit for bit.
    Returns the kernels' forward outputs and decode, the worst move-in
    difference and |dq|."""
    moves = decode_fused_cuda.move_buffer(head)
    fwd = decode_fused_cuda.tcn_fused_forward(head, moves_out=moves)
    out = decode_fused_cuda.tcn_fused_backward(head, *fwd, **q, moves=moves)
    torch.cuda.synchronize()
    ref_mv = decode_fused_cuda.head_moves_plain(head)
    ref_fwd = decode_fused_cuda.tcn_forward_plain(ref_mv, head.blank)
    ref = decode_fused_cuda.tcn_backward_plain(ref_mv, *ref_fwd, head.blank,
                                               **q)
    same_mv = moves is None or torch.equal(moves.view(torch.int32),
                                           ref_mv.view(torch.int32))
    del ref_mv
    Th, N, H = head.h.shape
    U, S = head.wT.shape[0], head.wT.shape[1] // 4
    n_choice = (fwd[1] != ref_fwd[1]).sum().item()
    n_end = (fwd[4] != ref_fwd[4]).sum().item()
    err_in = (fwd[0] - ref_fwd[0]).abs().max().item()
    d_lz = (fwd[3] - ref_fwd[3]).abs()
    ok_lz = (d_lz <= LOGZ_ATOL + LOGZ_RTOL * ref_fwd[3].abs()).all().item()
    same = ((out["moves"] == ref["moves"])
            & (out["sequence"] == ref["sequence"]))
    n_diff = (~same).sum().item()
    n_rows = (~same).any(1).sum().item()
    dq = (out["qstring"].int() - ref["qstring"].int()).abs()[same]
    dq = dq.max().item() if dq.numel() else 0
    frac = out["moves"].float().mean().item()
    log(f"  kernels {kernels}, {name} (N={N}, T={Th * U}, H={H}, S={S}, "
        f"U={U}): {n_choice} of {fwd[1].numel()} choices and {n_end} end "
        f"states differ, max |move_in - plain| {err_in:.3g}, max |logZ - "
        f"plain| {d_lz.max().item():.3g} at |logZ| about "
        f"{ref_fwd[3].abs().mean().item():.4g} (tolerance {LOGZ_ATOL} + "
        f"{LOGZ_RTOL} |logZ|); {n_diff} of "
        f"{same.numel()} frames differ in {n_rows} of {N} rows (at most "
        f"{1 - DECODE_MIN_EQUAL:.1%} may), max |dq| {dq} on the others; "
        f"{frac:.3f} of frames move"
        + ("" if moves is None else
           f"; GW's moves equal head_moves_plain's bit for bit {same_mv}"))
    first = kernels.split(" + ")[0]
    require(err_in <= 1e-4 and ok_lz and same_mv,
            f"kernel {first} ({name}) disagrees with its plain version")
    require(n_diff <= (1 - DECODE_MIN_EQUAL) * same.numel() and dq <= 1,
            f"kernels {kernels} ({name}) disagree with their plain versions")
    require(0.01 < frac < 1, f"kernels {kernels} ({name}): degenerate decode")
    return fwd, out, err_in, float(dq)


def hold_wide_old(torch, decode_fused_cuda, head, fwd, out, name, **q):
    """GW + JW (the head product, the passes on the f32 ring) against the
    earlier GW + JW (``csrc/decode_tcn_fused_wide.cu``) on the same head:
    move-in, choices, c, logZ, end state, sequence, qstring and moves equal
    bit for bit -> the largest |difference| over them."""
    old_fwd = decode_fused_cuda.tcn_fused_forward_wide_old_kernel(head)
    old = decode_fused_cuda.tcn_fused_backward_wide_old_kernel(
        head, *old_fwd, **q)
    same_f, d_f = vs_old_kernel(torch, *zip(fwd, old_fwd))
    differ = [k for k in out if not torch.equal(out[k], old[k])]
    d_b = max((out[k].int() - old[k].int()).abs().max().item() for k in out)
    log(f"    GW + JW (plan {decode_fused_cuda.tcn_fused_forward_wide.plan}) "
        f"vs the earlier GW + JW, {name}: move-in, choices, c, logZ, end "
        f"state equal bit for bit {same_f}, outputs of JW that differ in any "
        f"bit {differ}, max |diff| {max(d_f, float(d_b))}")
    require(decode_fused_cuda.tcn_fused_forward_wide.plan is not None
            and same_f and not differ,
            f"GW + JW ({name}) differ from the earlier GW + JW")
    return max(d_f, float(d_b))


def check_decode_fused(torch, decode_fused_cuda, HeadSplit, dev):
    """Kernels G and J against their plain versions: the fast head (U = 1,
    no tanh, Clamp +-5) at fast widths, and a small head with two upsample
    phases, tanh, scale 5 and a bias; on both G and J on their rings
    (``fused_decode_plan`` gives both plans) against their earlier kernels,
    bit for bit on move-in, choices, c, logZ and the end state, and on
    sequence, qstring and moves. Returns the fast head, G's outputs on it,
    the worst move-in difference and |dq|, G's and J's plans and the
    largest |ring - earlier kernel| over each one's outputs on both heads."""
    q = dict(qscale=1.05, qbias=0.2)
    plans, vs_old = {}, {"G": 0.0, "J": 0.0}
    for what, shape in (("two phases, tanh * 5, bias",
                         (24, 50, 32, 64, 2, True, 0.5)),
                        ("fast head", (FN, FT, FH, FS, 1, False, 3.0))):
        head = fused_head(torch, HeadSplit, dev, *shape)
        fwd, out, err, dq = hold_fused(torch, decode_fused_cuda, head, what,
                                       "G + J", **q)
        plans = {"G": decode_fused_cuda.tcn_fused_forward.plan,
                 "J": decode_fused_cuda.tcn_fused_backward.plan}
        old_fwd = decode_fused_cuda.tcn_fused_forward_old_kernel(head)
        same_g, d_g = vs_old_kernel(torch, *zip(fwd, old_fwd))
        old = decode_fused_cuda.tcn_fused_backward_old_kernel(head, *fwd, **q)
        differ = [k for k in out if not torch.equal(out[k], old[k])]
        d_old = max((out[k].int() - old[k].int()).abs().max().item()
                    for k in out)
        log(f"    G on its ring (plan {plans['G']}) vs the earlier G: "
            f"move-in, choices, c, logZ, end state equal bit for bit "
            f"{same_g}, max |diff| {d_g}")
        log(f"    J on its ring (plan {plans['J']}) vs the earlier J: outputs "
            f"that differ in any bit {differ}, max |diff| {d_old}")
        require(plans["G"] is not None and same_g,
                f"kernel G ({what}): plan {plans['G']}, its outputs differ "
                f"from the earlier G's")
        require(plans["J"] is not None and not differ,
                f"kernel J ({what}): plan {plans['J']}, {differ} differ from "
                f"the earlier J")
        vs_old["G"] = max(vs_old["G"], d_g)
        vs_old["J"] = max(vs_old["J"], float(d_old))
        del old_fwd
    return head, fwd, err, dq, plans, vs_old


def check_decode_fused_wide(torch, decode_fused_cuda, HeadSplit, dev):
    """Kernels GW and JW against their plain versions and against the
    earlier GW and JW (bit for bit) at hac's and sup's widths (WIDE_HEADS)
    -> the worst move-in difference, |dq| and |new - earlier|."""
    err = dq = vs_old = 0.0
    q = dict(qscale=1.05, qbias=0.2)
    for name, shape in WIDE_HEADS.items():
        head = fused_head(torch, HeadSplit, dev, *shape)
        fwd, out, e, d = hold_fused(torch, decode_fused_cuda, head,
                                    f"{name} head", "GW + JW", **q)
        vs_old = max(vs_old, hold_wide_old(torch, decode_fused_cuda, head,
                                           fwd, out, f"{name} head", **q))
        err, dq = max(err, e), max(dq, d)
        del head, fwd, out
    return err, dq, vs_old


def a_step_kernel(torch, build, xw, w_hh):
    """A's step kernel (one launch per timestep: the branch of
    ops.lstm_cuda.lstm_recurrence for an H whose slice of W_hh does not fit
    in shared memory, and A's first design) at xw's shape, through its C
    entry: the persistent kernel's time stands beside it from the same run.
    No path runs it at hac widths, so it counts no launch."""
    T_, N_, G_ = xw.shape
    H_ = G_ // 4
    Np = -(-N_ // 32) * 32
    out = torch.empty(T_, N_, H_, dtype=xw.dtype, device=xw.device)
    hbuf = torch.zeros(2, Np, H_, dtype=xw.dtype, device=xw.device)
    cbuf = torch.zeros(N_, H_, dtype=torch.float32, device=xw.device)
    build.check(build.library().lstm_recurrence_bf16(
        xw.data_ptr(), w_hh.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
        cbuf.data_ptr(), T_, N_, Np, H_, 0, build.stream_of(xw)),
        "lstm_recurrence_bf16")
    return out


def bf16_step(x):
    """One bf16 step at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check_attention(torch, attention_cuda, transformer, dev):
    """Kernels K and L against their plain versions at sup widths: K in
    bf16 at T = 1000 (the shipped chunk) and 1024, full and partial
    rotary_dim, on its stretch kernel (a plan at each), and K's earlier
    kernel at the shipped chunk beside it (the same tolerance; H's o on it
    equal to its K's); L on the strided [N, H, T, D] views of a packed qkv in f32
    and bf16, and on what the shallow transformer's layers hand it (32 rows,
    8 heads of 40, bf16: q and k from apply_rotary, v a view of the packed
    qkv). Tolerances: ATTN_* above."""
    g = torch.Generator().manual_seed(SEED + 7)
    rotary_freqs = transformer.rotary_freqs
    errs = {"K": 0.0, "L": 0.0, "L sup f32": 0.0}
    kept = {}
    for T, r in ((ST, SD), (1024, SD), (ST, SD // 2)):
        qkv = torch.randn(SN, T, 3, SH, SD, generator=g).to(dev, torch.bfloat16)
        cos, sin = rotary_freqs(T, r, device=dev)
        out = attention_cuda.fused_rotary_window_attention(qkv, cos, sin, SWIN)
        plan = attention_cuda.fused_rotary_window_attention.plan
        torch.cuda.synchronize()
        ref = attention_cuda.fused_rotary_window_attention_plain(
            qkv, cos, sin, SWIN)
        top = ref.float().abs().max().item()
        routes = [("K", out)]
        if (T, r) == (ST, SD):
            kept["K"] = (qkv, cos, sin)
            old, lse_old = (attention_cuda.
                            fused_rotary_window_attention_old_kernel(
                                qkv, cos, sin, SWIN, with_lse=True))
            k_old = attention_cuda.fused_rotary_window_attention_old_kernel(
                qkv, cos, sin, SWIN)
            torch.cuda.synchronize()
            routes.append(("K's earlier kernel", k_old))
            require(torch.equal(old, k_old), "the earlier kernel: H's o is "
                                             "not K's")
            diff = (out.float() - k_old.float()).abs().max().item()
            log(f"  kernel K T={T}: the stretch kernel against the earlier "
                f"kernel: max |diff| {diff:.3g}; H's o on the earlier kernel "
                f"equals its K's")
            del old, lse_old, k_old
        for name, o in routes:
            diff = (o.float() - ref.float()).abs()
            err, mean = diff.max().item(), diff.mean().item()
            log(f"  {name} T={T} rotary_dim={r}: max |o - plain| {err:.3g}, "
                f"mean {mean:.3g} at max |o| {top:.3g} (tolerance "
                f"{bf16_step(top):.3g}, one bf16 step there / "
                f"{ATTN_MEAN_TOL}); std of o {o.float().std().item():.3f}"
                + (f"; plan {plan}" if name == "K" else ""))
            require(torch.isfinite(o.float()).all().item()
                    and o.float().std().item() > 0.01,
                    f"{name}: o is not finite or does not vary")
            require(err <= bf16_step(top) and mean <= ATTN_MEAN_TOL,
                    f"{name} disagrees with its plain version: max {err}, "
                    f"mean {mean}")
            if name == "K":
                errs["K"] = max(errs["K"], err)
        require(plan is not None, f"kernel K took its earlier kernel at T={T}")
    for T, dtype, own in ((ST, torch.float32, False),
                          (1024, torch.float32, False),
                          (ST, torch.bfloat16, False),
                          (1024, torch.bfloat16, False),
                          (ST, torch.bfloat16, True)):
        if own:  # the shallow transformer's own call
            qkv = torch.randn(D40_N, T, 3, D40_H, D40_D, generator=g).to(
                dev, dtype)
            cos, sin = rotary_freqs(T, D40_D, device=dev)
            q = transformer.apply_rotary(qkv[:, :, 0], cos, sin).transpose(1, 2)
            k = transformer.apply_rotary(qkv[:, :, 1], cos, sin).transpose(1, 2)
            v = qkv[:, :, 2].transpose(1, 2)
        else:
            qkv = torch.randn(SN, T, 3, SH, SD, generator=g).to(dev, dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = attention_cuda.local_attention(q, k, v, SWIN)
        torch.cuda.synchronize()
        ref = attention_cuda.local_attention_plain(q, k, v, SWIN)
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        tol = (ATTN_F32_TOL if dtype == torch.float32
               else bf16_step(ref.float().abs().max().item()))
        log(f"  kernel L {tuple(q.shape)} strides {q.stride()} / "
            f"{v.stride()} {str(dtype)[6:]}: max |o - plain| {err:.3g}, "
            f"mean {mean:.3g} (tolerance {tol:.3g} / {ATTN_MEAN_TOL}), "
            f"{(diff > 0).float().mean().item():.3g} of the outputs differ; "
            f"std of o {out.float().std().item():.3f}")
        require(torch.isfinite(out.float()).all().item()
                and out.float().std().item() > 0.01
                and err <= tol and mean <= ATTN_MEAN_TOL,
                f"kernel L disagrees with its plain version: max {err}, "
                f"mean {mean}")
        if own:
            errs["L"], kept["L"] = err, (q, k, v)
        else:
            key = "L sup f32" if dtype == torch.float32 else "L sup bf16"
            errs[key] = max(errs.get(key, 0.0), err)
            if T == ST:
                kept[key] = (q, k, v)
    return kept, errs


def check_pin(torch, relayout, dev):
    """Kernel P against its plain version: the [N, T, C] view of a
    [N, C, T] tensor at sup widths (what a convolution hands the stack),
    and a contiguous tensor. Identical in every bit, contiguous, a copy."""
    g = torch.Generator().manual_seed(SEED + 8)
    base = torch.randn(SN, 512, ST, generator=g).to(dev, torch.bfloat16)
    view = base.transpose(1, 2)
    worst = 0.0
    for name, x in (("transposed view", view),
                    ("contiguous", view.contiguous())):
        out = relayout.pin_layout(x)
        torch.cuda.synchronize()
        ref = relayout.pin_layout_plain(x)
        plan = relayout.relayout_plan(list(x.shape), list(x.stride()),
                                      x.element_size())
        same = torch.equal(out, ref)
        log(f"  kernel P, {name} {tuple(x.shape)} strides {x.stride()} "
            f"({plan[0]}, unit {plan[-1]}): identical {same}, contiguous "
            f"{out.is_contiguous()}")
        require(same and out.is_contiguous()
                and out.data_ptr() != x.data_ptr(),
                f"kernel P ({name}) is no identical contiguous copy")
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
    return view, worst


def pin_tiles(relayout, x):
    """Kernel P's tiles variant forced on a [B, R, C] view of [B, C, R]
    memory that the plan gives the 16-byte transpose (uncounted): what that
    plan is held against where both variants take the view."""
    from bonito_tpu_torch.ops import build
    plan = relayout.relayout_plan(list(x.shape), list(x.stride()),
                                  x.element_size(),
                                  aligned=x.data_ptr() % 16 == 0)
    require(plan[0] == "transpose", f"pin_tiles: the plan is {plan[0]}")
    _, B, R, C, sb, sc, unit = plan
    out = x.new_empty(x.shape)
    build.check(build.library().relayout_transpose_tiles_any(
        x.data_ptr(), out.data_ptr(), B, R, C, sb, sc, unit,
        build.stream_of(x)), "relayout_transpose_tiles_any")
    return out


class Read:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


def run_path(torch, name, model, reads, counters, basecall, chunk, geometry,
             **kw):
    """Basecall ``reads`` through ``basecall`` (with the options ``kw``)
    with every launch count set to 0 just before and read just after; check
    what came back. ``geometry`` is the (chunksize, overlap, batchsize) the
    model's config must name."""
    bc = model.config["basecaller"]
    chunksize, overlap, batchsize = bc["chunksize"], bc["overlap"], bc["batchsize"]
    require((chunksize, overlap, batchsize) == geometry, f"unexpected {bc}")
    n_chunks = sum(chunk(r.signal, chunksize, overlap).shape[0] for r in reads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = {r.read_id: res for r, res in basecall(
        model, iter(reads), chunksize=chunksize, overlap=overlap,
        batchsize=batchsize, **kw)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # the plans F, G, J, GW and JW ran on (their last call's), where the
    # path ran them
    plans = {k: counters[k].plan for k in ("F", "G", "J", "GW", "JW")
             if launches[k]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(results.keys() == {r.read_id for r in reads},
            f"{name}: not every read came back")
    total_bases = 0
    for read in reads:
        res = results[read.read_id]
        seq, qs, mv = res["sequence"], res["qstring"], res["moves"]
        require(len(seq) == int(mv.sum()) == len(qs),
                f"{name} {read.read_id}: sequence/moves/qstring lengths differ")
        require(len(mv) == len(read.signal) // model.stride
                or len(read.signal) >= chunksize,
                f"{name} {read.read_id}: short read frames")
        total_bases += len(seq)
    frac = total_bases / sum(len(r["moves"]) for r in results.values())
    letters = set("".join(r["sequence"] for r in results.values()))
    samples = int(sum(len(r.signal) for r in reads))
    log(f"  {name}: {len(reads)} reads, {n_chunks} chunks, {total_bases} "
        f"bases, {frac:.3f} of frames emit, letters {sorted(letters)}; "
        f"{samples / wall:.6g} samples/s over {wall:.3f} s, peak memory "
        f"{peak:.3f} GiB ({held:.3f} GiB of it held before the path: the "
        f"models and the checks' tensors); launches {launches}")
    require(0.01 < frac < 1 and letters == set("ACGT"),
            f"{name}: degenerate output")
    return {"launches": launches, "plans": plans,
            "batches": -(-n_chunks // batchsize),
            "full_batches": n_chunks // batchsize, "batchsize": batchsize,
            "chunksize": chunksize, "wall": wall, "samples": samples,
            "peak": peak, "held": held}


def first_reads(reads, chunk, geometry, n_chunks):
    """The shortest run of ``reads`` from the first that makes at least
    ``n_chunks`` chunks of ``geometry`` (chunksize, overlap, batchsize)."""
    total = 0
    for i, r in enumerate(reads):
        total += chunk(r.signal, geometry[0], geometry[1]).shape[0]
        if total >= n_chunks:
            return reads[:i + 1]
    raise RuntimeError(f"chip_smoke: too few reads for {n_chunks} chunks")


def device_step(np, model, reads, make_compute_fn, chunk, **kw):
    """One prepared full batch and the time of its device step (upload,
    forward, decode, fetch) with the options ``kw`` of make_compute_fn."""
    bc = model.config["basecaller"]
    compute = make_compute_fn(model, bc["batchsize"], bc["chunksize"], **kw)
    chunks, n = [], 0
    for r in reads[2:]:  # the first two reads are short ones
        if n >= bc["batchsize"]:
            break
        chunks.append(chunk(r.signal, bc["chunksize"], bc["overlap"]))
        n += chunks[-1].shape[0]
    require(n >= bc["batchsize"], "too few reads for one full batch")
    prepared = compute.prepare(np.concatenate(chunks)[:bc["batchsize"]])
    ms = cuda_ms(lambda: compute.fetch(compute.dispatch(prepared)), reps=3)
    return prepared, ms


def step_and_peak(torch, np, model, reads, make_compute_fn, chunk, **kw):
    """``device_step`` and the peak device memory of its run in GiB above
    what was held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    prepared, ms = device_step(np, model, reads, make_compute_fn, chunk, **kw)
    torch.cuda.synchronize()
    return prepared, ms, (torch.cuda.max_memory_allocated() - held) / 2 ** 30


class earlier_kernel:
    """K and H (``rule`` "window_plan") or O ("window_bwd_plan") of
    ``attention_cuda``, B and C ("decode_plan" of ``decode_cuda``), GW and
    JW ("wide_decode_plan" of ``decode_fused_cuda``), U, V, W and X
    ("logz_plan" of ``logz_cuda``: U and V on the TCN moves, W and X on the
    full scores of ``loss``; W alone with ``part`` "fwd" on ``loss``'s
    path), F ("fused_plan" of ``lstm_fused_cuda``), G
    and J ("fused_decode_plan" of ``decode_fused_cuda``; G or J alone with
    ``part`` "fwd" or "bwd"), Z ("lattice_plan" of ``lattice_cuda``) or Y
    alone ("lattice_fwd_plan" of ``lattice_cuda``) on their earlier kernels
    at every shape, for the comparisons of phases 7 and 9 to 11: the shape
    rule swapped for one that gives no plan (or none for ``part``). The
    launch counts count as on the redesigned kernels."""

    def __init__(self, attention_cuda, rule="window_plan", part=None):
        self.mod, self.name, self.part = attention_cuda, rule, part

    def __enter__(self):
        self.rule = rule = getattr(self.mod, self.name)
        part = self.part

        def without(*shape, **kw):
            plans = rule(*shape, **kw)
            return plans and {**plans, part: None}
        setattr(self.mod, self.name,
                (lambda *shape, **kw: None) if part is None else without)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.rule)


class parent_reverse:
    """The reverse strand as the parent tree decodes it, for the device
    steps of phase 7: model(x)'s scores copied through
    ``seqdist.reverse_complement``, then M + Q on the copy, on the ring or
    (``old``: ``decode_full_plan`` giving no plan) on the earlier kernels,
    the parent's M and Q. The launch counts count as on the in-place
    read."""

    def __init__(self, crf_basecall, decode_full_cuda, old):
        self.basecall, self.full, self.old = crf_basecall, decode_full_cuda, old

    def __enter__(self):
        self.decode, self.plan = (self.basecall.viterbi_decode,
                                  self.full.decode_full_plan)
        decode = self.decode

        def copy_decode(seqdist, scores, reverse=False, **q):
            if reverse:
                scores = seqdist.reverse_complement(scores)
            return decode(seqdist, scores, **q)
        self.basecall.viterbi_decode = copy_decode
        if self.old:
            self.full.decode_full_plan = lambda *shape: None

    def __exit__(self, *exc):
        self.basecall.viterbi_decode = self.decode
        self.full.decode_full_plan = self.plan


def moves_kernels_vs_plain(torch, model, x):
    """One batch's move scores through a transformer model twice: with its
    attention and pin kernels (K or L, and P), and with their plain versions
    in the kernels' place. Returns both, the max and mean absolute
    difference, and the kernels' launches in the first pass."""
    from bonito_tpu_torch import nn as port_nn
    from bonito_tpu_torch.ops import attention as ops_attention
    from bonito_tpu_torch.ops import attention_cuda, relayout
    from bonito_tpu_torch.transformer import model as transformer
    kernels = {"K": attention_cuda.fused_rotary_window_attention,
               "L": attention_cuda.local_attention, "P": relayout.pin_layout}
    before = {k: fn.launches for k, fn in kernels.items()}
    mv_kernel, blank = model.forward_tcn(x)
    launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
    transformer.fused_rotary_window_attention = (
        attention_cuda.fused_rotary_window_attention_plain)
    ops_attention.local_attention = attention_cuda.local_attention_plain
    port_nn.pin_layout = relayout.pin_layout_plain
    try:
        mv_plain, _ = model.forward_tcn(x)
    finally:
        transformer.fused_rotary_window_attention = kernels["K"]
        ops_attention.local_attention = kernels["L"]
        port_nn.pin_layout = kernels["P"]
    require({k: fn.launches - before[k] for k, fn in kernels.items()}
            == launches, "the plain pass launched a kernel")
    worst = total = 0.0
    for a in range(0, mv_kernel.shape[0], 250):  # slabs of frames
        diff = (mv_kernel[a:a + 250].float()
                - mv_plain[a:a + 250].float()).abs()
        worst = max(worst, diff.max().item())
        total += diff.sum().item()
    require(torch.isfinite(mv_kernel.float()).all().item(),
            "non-finite move scores")
    mean = total / mv_kernel.numel()
    return mv_kernel, mv_plain, blank, worst, mean, launches


def decodes_differ(torch, model, mv_a, mv_b, blank, ops_decode, **q):
    """Frames on which the TCN decodes (B + C) of two move tensors differ in
    moves or sequence, and all frames."""
    outs = [ops_decode.viterbi_decode_tcn(
        model.seqdist, mv.to(torch.bfloat16), blank, **q)
        for mv in (mv_a, mv_b)]
    same = ((outs[0]["moves"] == outs[1]["moves"])
            & (outs[0]["sequence"] == outs[1]["sequence"]))
    return (~same).sum().item(), same.numel(), outs[0]


def timed(torch, fn):
    """(fn(), its time in ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def f32_close(out, ref, steps=F32_STEPS):
    """(max |out - ref|, whether it is within ``steps`` f32 steps of the
    largest |ref|)."""
    if out.numel() == 0:
        return 0.0, True
    err = (out.float() - ref.float()).abs().max().item()
    return err, err <= steps * 2.0 ** -23 * ref.float().abs().max().item()


def grad_close(torch, out, ref, g_row=None, row_dim=0):
    """(max |out - ref|, whether each entry is within one bf16 step of its
    own magnitude (plus one of |g_row| for a path's gradient), the share of
    equal entries) and whether at least GRAD_MIN_EQUAL are equal."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    if g_row is not None:
        shape = [1] * out.dim()
        shape[row_dim] = -1
        tol = tol + 2.0 ** -7 * g_row.abs().reshape(shape)
    equal = (out == ref).float().mean().item()
    return (err.max().item(), bool((err <= tol).all())
            and equal >= GRAD_MIN_EQUAL, equal)


class plain_loss_kernels:
    """Within the block, the loss's kernel wrappers run their plain
    versions on the card (the launch counts do not move)."""

    def __init__(self, logz, logz_cuda, lattice, lattice_cuda):
        self.mods = (logz_cuda, lattice_cuda)
        self.swap = {
            (logz_cuda, "tcn_forward"): lambda m, b, round_bf16=True,
                with_stack=True: logz.forward_plain(m, float(b), round_bf16,
                                                    with_stack),
            (logz_cuda, "tcn_backward"): lambda m, st, lz, g, b,
                round_bf16=True, out_dtype=None: logz.backward_plain(
                    m, float(b), st, lz, g, round_bf16,
                    m.dtype if out_dtype is None else out_dtype)[0],
            (logz_cuda, "full_forward"): logz.full_forward_plain,
            (logz_cuda, "full_backward"): logz.full_backward_plain,
            (lattice_cuda, "lattice_forward"): lattice.forward_plain,
            (lattice_cuda, "lattice_backward"): lattice.backward_plain}

    def __enter__(self):
        self.saved = {k: getattr(*k) for k in self.swap}
        for (mod, name), fn in self.swap.items():
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def loss_path(torch, counters, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, the counts, peak memory above what was held, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    return out, launches, (torch.cuda.max_memory_allocated() - held) / 2 ** 30


def vs_old_kernel(torch, *pairs):
    """Whether each pair of tensors (a kernel's output, its earlier
    kernel's) is equal bit for bit, and the largest |difference| over all."""
    torch.cuda.synchronize()
    same = all(torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in pairs)
    diff = max(float(torch.where(a == b, 0.0, (a.float() - b.float()).abs())
                     .max()) for a, b in pairs)
    return same, diff


def hold_loss_kernels(torch, mods, moves, blank, scores, move, lengths, g,
                      g_lat, time_plain):
    """Each of U to Z on the given tensors against its plain version on the
    same inputs, and its time (the plain version's when ``time_plain``); U,
    V, W and X, on the ring where ``logz_plan`` gives a plan, and Y and Z,
    split over warps where ``lattice_fwd_plan`` and ``lattice_plan`` give
    one, also against their earlier kernels bit for bit, and those kernels'
    times. Returns {key: {"err", "ok", "ms", "plain_ms", "bytes", "ops"},
    with each one's "plan", "vs_old" (bit for bit), "diff_old" (max |diff|)
    and "old_kernel_ms", and W's times without its stack} and U's time
    without its stack."""
    logz, logz_cuda, lattice, lattice_cuda = mods
    N, T, Cm = moves.shape
    S = Cm // 4
    P = move.shape[2] + 1
    res = {}

    def plain_time(fn):
        return timed(torch, fn) if time_plain else (fn(), None)

    stack, lz = logz_cuda.tcn_forward(moves, blank)
    plan = logz_cuda.tcn_forward.plan
    (ref_stack, ref_lz), plain_ms = plain_time(
        lambda: logz.forward_plain(moves, blank))
    e1, ok1 = f32_close(stack, ref_stack)
    e2, ok2 = f32_close(lz, ref_lz)
    _, lz_only = logz_cuda.tcn_forward(moves, blank, with_stack=False)
    old_stack, old_lz = logz_cuda.tcn_forward_old_kernel(moves, blank)
    _, old_only = logz_cuda.tcn_forward_old_kernel(moves, blank,
                                                   with_stack=False)
    same_u, diff_u = vs_old_kernel(torch, (stack, old_stack), (lz, old_lz),
                                   (lz_only, old_only))
    res["U"] = dict(err=max(e1, e2), ok=ok1 and ok2 and torch.equal(
        lz, lz_only), plain_ms=plain_ms, ms=cuda_ms(
        lambda: logz_cuda.tcn_forward(moves, blank), reps=3),
        bytes=moves.numel() * moves.element_size() + stack.numel() * 4
        + N * 4, bytes_no_stack=moves.numel() * moves.element_size() + N * 4,
        ops=30 * N * T * S, plan=plan, vs_old=same_u, diff_old=diff_u,
        old_kernel_ms=cuda_ms(lambda: logz_cuda.tcn_forward_old_kernel(
            moves, blank), reps=3),
        no_stack_old_kernel_ms=cuda_ms(
            lambda: logz_cuda.tcn_forward_old_kernel(
                moves, blank, with_stack=False), reps=3))
    del old_stack
    ms_u_only = cuda_ms(lambda: logz_cuda.tcn_forward(
        moves, blank, with_stack=False), reps=3)
    grad = logz_cuda.tcn_backward(moves, stack, lz, g, blank)
    ref, plain_ms = plain_time(lambda: logz.backward_plain(
        moves, blank, ref_stack, ref_lz, g, out_dtype=moves.dtype)[0])
    err, ok, _ = grad_close(torch, grad, ref)
    old_grad = logz_cuda.tcn_backward_old_kernel(moves, stack, lz, g, blank)
    same_v, diff_v = vs_old_kernel(torch, (grad, old_grad))
    res["V"] = dict(err=err, ok=ok, plain_ms=plain_ms, ms=cuda_ms(
        lambda: logz_cuda.tcn_backward(moves, stack, lz, g, blank), reps=3),
        bytes=2 * moves.numel() * moves.element_size() + stack.numel() * 4
        + N * 8, ops=54 * N * T * S, plan=logz_cuda.tcn_backward.plan,
        vs_old=same_v, diff_old=diff_v,
        old_kernel_ms=cuda_ms(lambda: logz_cuda.tcn_backward_old_kernel(
            moves, stack, lz, g, blank), reps=3))
    del stack, ref_stack, grad, ref, old_grad

    stack, lz = logz_cuda.full_forward(scores)
    plan_w = logz_cuda.full_forward.plan
    (ref_stack, ref_lz), plain_ms = plain_time(
        lambda: logz.full_forward_plain(scores))
    e1, ok1 = f32_close(stack, ref_stack)
    e2, ok2 = f32_close(lz, ref_lz)
    _, lz_only = logz_cuda.full_forward(scores, with_stack=False)
    old_stack, old_lz = logz_cuda.full_forward_old_kernel(scores)
    _, old_only = logz_cuda.full_forward_old_kernel(scores, with_stack=False)
    same_w, diff_w = vs_old_kernel(torch, (stack, old_stack), (lz, old_lz),
                                   (lz_only, old_only))
    del old_stack
    res["W"] = dict(err=max(e1, e2), ok=ok1 and ok2 and torch.equal(
        lz, lz_only), plain_ms=plain_ms,
                    ms=cuda_ms(lambda: logz_cuda.full_forward(scores), reps=3),
                    bytes=scores.numel() * scores.element_size()
                    + stack.numel() * 4 + N * 4,
                    bytes_no_stack=scores.numel() * scores.element_size()
                    + N * 4, ops=32 * N * T * S,
                    plan=plan_w if plan_w and plan_w["fwd"] else None,
                    vs_old=same_w,
                    diff_old=diff_w,
                    old_kernel_ms=cuda_ms(
                        lambda: logz_cuda.full_forward_old_kernel(scores),
                        reps=3),
                    no_stack_ms=cuda_ms(lambda: logz_cuda.full_forward(
                        scores, with_stack=False), reps=3),
                    no_stack_old_kernel_ms=cuda_ms(
                        lambda: logz_cuda.full_forward_old_kernel(
                            scores, with_stack=False), reps=3))
    grad = logz_cuda.full_backward(scores, stack, lz, g)
    plan_x = logz_cuda.full_backward.plan
    ref, plain_ms = plain_time(lambda: logz.full_backward_plain(
        scores, ref_stack, ref_lz, g, out_dtype=scores.dtype))
    err, ok, _ = grad_close(torch, grad, ref)
    old_grad = logz_cuda.full_backward_old_kernel(scores, stack, lz, g)
    same_x, diff_x = vs_old_kernel(torch, (grad, old_grad))
    del old_grad
    res["X"] = dict(err=err, ok=ok, plain_ms=plain_ms, ms=cuda_ms(
        lambda: logz_cuda.full_backward(scores, stack, lz, g), reps=3),
        bytes=2 * scores.numel() * scores.element_size() + stack.numel() * 4
        + N * 8, ops=60 * N * T * S, plan=plan_x, vs_old=same_x,
        diff_old=diff_x, old_kernel_ms=cuda_ms(
            lambda: logz_cuda.full_backward_old_kernel(scores, stack, lz, g),
            reps=3))
    del stack, ref_stack, grad, ref

    stack, lz = lattice_cuda.lattice_forward(move, lengths, blank)
    plan_y = lattice_cuda.lattice_forward.plan
    (ref_stack, ref_lz), plain_ms = plain_time(
        lambda: lattice.forward_plain(move, lengths, blank))
    e1, ok1 = f32_close(stack, ref_stack)
    e2, ok2 = f32_close(lz, ref_lz)
    _, lz_only = lattice_cuda.lattice_forward(move, lengths, blank,
                                              with_stack=False)
    old_stack, old_lz = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, blank)
    _, old_only = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, blank, with_stack=False)
    same_y, diff_y = vs_old_kernel(torch, (stack, old_stack), (lz, old_lz),
                                   (lz_only, old_only))
    del old_stack
    res["Y"] = dict(err=max(e1, e2), ok=ok1 and ok2 and torch.equal(
        lz, lz_only), plain_ms=plain_ms,
                    ms=cuda_ms(lambda: lattice_cuda.lattice_forward(
                        move, lengths, blank), reps=3),
                    bytes=move.numel() * 4 + stack.numel() * 4 + N * 8,
                    ops=8 * N * T * P, plan=plan_y, vs_old=same_y,
                    diff_old=diff_y,
                    old_kernel_ms=cuda_ms(
                        lambda: lattice_cuda.lattice_forward_old_kernel(
                            move, lengths, blank), reps=3),
                    no_stack_ms=cuda_ms(lambda: lattice_cuda.lattice_forward(
                        move, lengths, blank, with_stack=False), reps=3),
                    no_stack_old_kernel_ms=cuda_ms(
                        lambda: lattice_cuda.lattice_forward_old_kernel(
                            move, lengths, blank, with_stack=False), reps=3))
    gz, sg = lattice.cotangent(g_lat, lz)
    dmove = lattice_cuda.lattice_backward(move, stack, lengths, gz, sg, blank)
    ref, plain_ms = plain_time(lambda: lattice.backward_plain(
        move, ref_stack, lengths, gz, sg, blank))
    err, ok = f32_close(dmove, ref)
    plan_z = lattice_cuda.lattice_backward.plan
    same_z, diff_z = vs_old_kernel(torch, (dmove, lattice_cuda.
                                           lattice_backward_old_kernel(
                                               move, stack, lengths, gz, sg,
                                               blank)))
    res["Z"] = dict(err=err, ok=ok and bool(torch.isfinite(dmove).all()),
                    plain_ms=plain_ms, ms=cuda_ms(
        lambda: lattice_cuda.lattice_backward(move, stack, lengths, gz, sg,
                                              blank), reps=3),
        bytes=2 * move.numel() * 4 + stack.numel() * 4 + N * 12,
        ops=14 * N * T * P, plan=plan_z, vs_old=same_z, diff_old=diff_z,
        old_kernel_ms=cuda_ms(lambda: lattice_cuda.lattice_backward_old_kernel(
            move, stack, lengths, gz, sg, blank), reps=3))
    return res, ms_u_only


def random_loss_inputs(torch, dev, N, T, S, L, seed):
    """Moves [N, T, 4S] bf16 (tanh x 5, as a head gives them), full scores
    [N, T, 5S] f32, lattice moves [N, T, P-1] f32 and lengths from P/2 to
    P, the cotangents of logZ and of the lattice."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = L + 1 - round(math.log(S, 4))  # L - (state_len - 1)
    moves = (5 * torch.tanh(torch.randn(N, T, 4 * S, device=dev,
                                        generator=g))).to(torch.bfloat16)
    scores = 2 * torch.randn(N, T, 5 * S, device=dev, generator=g)
    move = 2 * torch.randn(N, T, P - 1, device=dev, generator=g)
    lengths = torch.randint(P // 2, P + 1, (N,), device=dev, generator=g,
                            dtype=torch.int32)
    g_row = 1.0 / (lengths.float() * N)
    return moves, scores, move, lengths, g_row, -g_row


def train_loss_phase(torch, hac, counters, dev):
    """Phase 9: the training loss on the hac model ``hac`` (bf16,
    quantize=false) through ``loss_tcn`` and ``loss`` with their backward,
    and under no_grad, each path with the launch counts ``counters`` set to
    0 before it and read after it and held against the plain versions;
    then each of U to Z alone at hac, fast and sup training shapes."""
    from bonito_tpu_torch.ops import lattice as ops_lattice
    from bonito_tpu_torch.ops import lattice_cuda, logz_cuda
    from bonito_tpu_torch.ops import logz as ops_logz

    log(f"[9] the CRF training loss at hac training width (batch {TRAIN_N} "
        f"x chunk {TRAIN_CHUNK}, bf16, quantize=false; targets of "
        f"{TRAIN_L // 2} to {TRAIN_L} bases), kernels U to Z")
    loss_mods = (ops_logz, logz_cuda, ops_lattice, lattice_cuda)
    sd = hac.seqdist
    rng = np.random.default_rng(SEED)
    x_train = torch.from_numpy(rng.normal(size=(TRAIN_N, TRAIN_CHUNK, 1))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    t_lengths = rng.integers(TRAIN_L // 2, TRAIN_L + 1, TRAIN_N)
    targets = rng.integers(1, 5, (TRAIN_N, TRAIN_L))
    targets[np.arange(TRAIN_L)[None] >= t_lengths[:, None]] = 0
    targets = torch.from_numpy(targets).to(dev)
    t_lengths = torch.from_numpy(t_lengths).to(dev)
    # the cotangent of each row's logZ in the mean loss: 1 / (length x rows)
    g_row = 1.0 / (t_lengths.float() * TRAIN_N)

    def train_step():
        with torch.no_grad():
            moves, blank = hac.forward_tcn(x_train)
        mv = moves.detach().requires_grad_()
        loss = hac.loss_tcn(mv, blank, targets, t_lengths)
        loss.backward()
        return loss.detach(), mv, blank

    def loss_step():
        with torch.no_grad():
            scores = hac(x_train)
        sc = scores.detach().requires_grad_()
        loss = hac.loss(sc, targets, t_lengths)
        loss.backward()
        return loss.detach(), sc

    def valid_step():
        with torch.no_grad():
            moves, blank = hac.forward_tcn(x_train)
            return hac.loss_tcn(moves, blank, targets, t_lengths)

    loss_paths = {}
    (train_loss, mv, train_blank), n, mem = loss_path(torch, counters,
                                                      train_step)
    loss_paths["train_loss"] = (n, mem)
    log(f"  train_loss: Y ran on the plan "
        f"{lattice_cuda.lattice_forward.plan}, Z on "
        f"{lattice_cuda.lattice_backward.plan}")
    require(lattice_cuda.lattice_forward.plan is not None,
            "train_loss: Y ran on its earlier kernel")
    require(lattice_cuda.lattice_backward.plan is not None,
            "train_loss: Z ran on its earlier kernel")
    (full_loss, sc), n, mem = loss_path(torch, counters, loss_step)
    loss_paths["loss"] = (n, mem)
    log(f"  loss: W and X ran on the plan {logz_cuda.full_backward.plan}")
    require(logz_cuda.full_forward.plan is not None
            and logz_cuda.full_forward.plan["fwd"] is not None,
            "loss: W ran on its earlier kernel")
    require(logz_cuda.full_backward.plan is not None,
            "loss: X ran on its earlier kernel")
    valid_loss, n, mem = loss_path(torch, counters, valid_step)
    loss_paths["valid_loss"] = (n, mem)
    require(lattice_cuda.lattice_forward.plan is not None,
            "valid_loss: Y ran on its earlier kernel")
    own_loss = {"train_loss": {"A": 5, "U": 1, "V": 1, "Y": 1, "Z": 1},
                "loss": {"A": 5, "W": 1, "X": 1},
                "valid_loss": {"A": 5, "U": 1, "Y": 1}}
    for name, (n, _) in loss_paths.items():
        expect = {k: own_loss[name].get(k, 0) for k in counters}
        require(n == expect, f"{name}: launches {n}, expected {expect}")

    # each path's loss + backward alone (the encoder's forward outside the
    # time), and the same on the plain versions in the kernels' place
    moves_d = mv.detach()
    sc_d = sc.detach()

    def tcn_loss(m):
        m = m.detach().requires_grad_()
        hac.loss_tcn(m, train_blank, targets, t_lengths).backward()
        return m.grad

    def full_loss_grad(scores):
        scores = scores.detach().requires_grad_()
        hac.loss(scores, targets, t_lengths).backward()
        return scores.grad

    def plain_path(fn, arg):
        with plain_loss_kernels(*loss_mods):
            with torch.enable_grad():
                a = arg.detach().requires_grad_()
                loss = fn(a)
                loss.backward()
        return loss.detach(), a.grad

    def valid_ms():
        with torch.no_grad():
            return cuda_ms(lambda: hac.loss_tcn(moves_d, train_blank,
                                                targets, t_lengths), reps=3)
    ms_train = cuda_ms(lambda: tcn_loss(moves_d), reps=3)
    # loss + backward in turns: W and X on their earlier kernels, W alone
    # on its earlier kernel (X on the ring), both on the ring, then W alone
    # and both again on the earlier kernels
    ms_full_old, ms_full_w_old = [], []
    for turn in (ms_full_old, ms_full_w_old, None, ms_full_w_old,
                 ms_full_old):
        if turn is None:
            ms_full = cuda_ms(lambda: full_loss_grad(sc_d), reps=2)
            continue
        with earlier_kernel(logz_cuda, "logz_plan",
                            "fwd" if turn is ms_full_w_old else None):
            turn.append(cuda_ms(lambda: full_loss_grad(sc_d), reps=2))
    ms_valid = valid_ms()
    # the same with U and V on their earlier kernels, then on the ring again
    with earlier_kernel(logz_cuda, "logz_plan"):
        ms_train_old = cuda_ms(lambda: tcn_loss(moves_d), reps=3)
        ms_valid_old = valid_ms()
    ms_train_again = cuda_ms(lambda: tcn_loss(moves_d), reps=3)
    # and with Y on its earlier kernel (Z on its plan), then split again
    with earlier_kernel(lattice_cuda, "lattice_fwd_plan"):
        ms_train_y_old = cuda_ms(lambda: tcn_loss(moves_d), reps=3)
        ms_valid_y_old = valid_ms()
    ms_train_y_again = cuda_ms(lambda: tcn_loss(moves_d), reps=3)
    plain_train, plain_g = plain_path(
        lambda m: hac.loss_tcn(m, train_blank, targets, t_lengths), moves_d)
    plain_full, plain_gs = plain_path(
        lambda s_: hac.loss(s_, targets, t_lengths), sc_d)
    checks = {}
    for name, loss, grad, ploss, pgrad, row_dim in (
            ("train_loss", train_loss, mv.grad, plain_train, plain_g, 2),
            ("loss", full_loss, sc.grad, plain_full, plain_gs, 0)):
        err_l, ok_l = f32_close(loss, ploss)
        err_g, ok_g, equal = grad_close(torch, grad, pgrad, g_row, row_dim)
        finite = bool(torch.isfinite(grad.float()).all()) and bool(
            torch.isfinite(loss))
        checks[name] = ok_l and ok_g and finite
        log(f"  {name}: loss {loss.item():.7g} (plain versions "
            f"{ploss.item():.7g}, |diff| {err_l:.3g}); gradient "
            f"{tuple(grad.shape)} {str(grad.dtype)[6:]} vs the plain "
            f"versions' max |diff| {err_g:.3g}, {equal:.5f} equal; finite "
            f"{finite}")
    err_v, ok_v = f32_close(valid_loss, train_loss)
    checks["valid_loss"] = ok_v
    for name, value, ms, what in (
            ("train_loss", train_loss, ms_train, "forward + backward"),
            ("loss", full_loss, ms_full, "forward + backward"),
            ("valid_loss", valid_loss, ms_valid, "forward")):
        n, mem = loss_paths[name]
        log(f"  {name} path: loss {value.item():.7g}; the loss's {what} "
            f"{ms:.4g} ms = {TRAIN_N * TRAIN_CHUNK / ms * 1e3:.6g} "
            f"train-loss samples/s; peak memory {mem:.3f} GiB above what "
            f"was held; launches {({k: v for k, v in n.items() if v})}")
    log(f"  valid_loss (no_grad: U and Y without their stacks) vs "
        f"train_loss: |diff| {err_v:.3g}")
    log(f"  with U and V on their earlier kernels: "
        f"train_loss forward + backward {ms_train_old:.4g} ms (on the ring "
        f"{ms_train:.4g}, again {ms_train_again:.4g}), valid_loss "
        f"{ms_valid_old:.4g} ms (on the ring {ms_valid:.4g})")
    log(f"  with Y on its earlier kernel: train_loss forward + backward "
        f"{ms_train_y_old:.4g} ms (split over warps {ms_train:.4g}, again "
        f"{ms_train_y_again:.4g}), valid_loss {ms_valid_y_old:.4g} ms "
        f"(split {ms_valid:.4g})")
    log(f"  loss forward + backward in turns, W and X on their earlier "
        f"kernels / W on its earlier kernel / both on the ring / W on its "
        f"earlier kernel / both on their earlier kernels: "
        f"{ms_full_old[0]:.4g} / {ms_full_w_old[0]:.4g} / {ms_full:.4g} / "
        f"{ms_full_w_old[1]:.4g} / {ms_full_old[1]:.4g} ms")
    for name, ok in checks.items():
        require(ok, f"{name}: the kernels disagree with the plain versions")
    del plain_g, plain_gs

    # the kernels alone: at hac on the path's own tensors, at fast and sup
    # training shapes on random ones
    lat_lengths = (t_lengths + 1 - sd.state_len).int()
    held = hold_loss_kernels(
        torch, loss_mods, moves_d.permute(2, 0, 1).contiguous(), train_blank,
        sc_d.float(), sd.prepare_ctc_moves_tcn(moves_d, targets),
        lat_lengths, g_row, -g_row, time_plain=True)
    loss_k, ms_u_only = held
    del mv, sc, moves_d, sc_d
    loss_more = {}
    for shape in ("fast", "sup"):
        N_, T_, S_, L_ = LOSS_SHAPES[shape]
        inputs = random_loss_inputs(torch, dev, N_, T_, S_, L_, SEED)
        res, _ = hold_loss_kernels(torch, loss_mods, inputs[0], 2.0,
                                   *inputs[1:], time_plain=False)
        del inputs
        for key, r in res.items():
            loss_more.setdefault(key, {})[f"{shape}_shape_ms"] = r["ms"]
            loss_more[key][f"{shape}_shape_bound_ms"] = bound(
                r["bytes"], r["ops"], H100_F32_OPS)[0]
            loss_more[key][f"{shape}_shape_max_abs_err"] = r["err"]
            require(r["ok"], f"kernel {key} at {shape} training shapes "
                             f"disagrees with its plain version")
            if "vs_old" in r:
                loss_more[key][f"{shape}_shape_old_kernel_ms"] = (
                    r["old_kernel_ms"])
                loss_more[key][f"{shape}_shape_max_abs_err_vs_old_kernel"] = (
                    r["diff_old"])
                loss_more[key][f"{shape}_shape_plan"] = r["plan"]
                require(r["vs_old"] and r["plan"] is not None,
                        f"kernel {key} at {shape} training shapes: the plan "
                        f"{r['plan']} ran, or differs from the earlier "
                        f"kernel")
        log(f"  at {shape} training shapes (N {N_}, T {T_}, S {S_}, L "
            f"{L_}): " + ", ".join(
                f"{k} {r['ms']:.4g} ms (bound "
                f"{loss_more[k][shape + '_shape_bound_ms']:.4g}, max |diff| "
                f"{r['err']:.3g})" for k, r in res.items()))
        log(f"    U and V on the ring (plan {res['U']['plan']}), bit for "
            f"bit the earlier kernels' (stack, logZ, no-stack logZ; "
            f"gradient): {res['U']['vs_old']}, {res['V']['vs_old']}; the "
            f"earlier kernels U {res['U']['old_kernel_ms']:.4g} ms (no "
            f"stack {res['U']['no_stack_old_kernel_ms']:.4g}), V "
            f"{res['V']['old_kernel_ms']:.4g} ms")
        log(f"    Z split over warps (plan {res['Z']['plan']}), bit for bit "
            f"the earlier kernel's: {res['Z']['vs_old']}; the earlier Z "
            f"{res['Z']['old_kernel_ms']:.4g} ms")
        log(f"    Y split over warps (plan {res['Y']['plan']}), bit for bit "
            f"the earlier kernel's (stack, logZ, no-stack logZ): "
            f"{res['Y']['vs_old']}; the earlier Y "
            f"{res['Y']['old_kernel_ms']:.4g} ms (no stack "
            f"{res['Y']['no_stack_old_kernel_ms']:.4g}; split "
            f"{res['Y']['no_stack_ms']:.4g})")
        log(f"    X on the ring (plan {res['X']['plan']}), bit for bit the "
            f"earlier kernel's: {res['X']['vs_old']}; the earlier X "
            f"{res['X']['old_kernel_ms']:.4g} ms")
        w_only_bound = bound(res["W"]["bytes_no_stack"], res["W"]["ops"],
                             H100_F32_OPS)[0]
        log(f"    W on the ring (plan {res['W']['plan']}), bit for bit the "
            f"earlier kernel's (stack, logZ, no-stack logZ): "
            f"{res['W']['vs_old']}; the earlier W "
            f"{res['W']['old_kernel_ms']:.4g} ms (no stack "
            f"{res['W']['no_stack_old_kernel_ms']:.4g}; on the ring "
            f"{res['W']['no_stack_ms']:.4g}, bound {w_only_bound:.4g})")
        for key in "WY":
            loss_more[key][f"{shape}_shape_no_stack_ms"] = (
                res[key]["no_stack_ms"])
            loss_more[key][f"{shape}_shape_no_stack_old_kernel_ms"] = (
                res[key]["no_stack_old_kernel_ms"])
        loss_more["W"][f"{shape}_shape_no_stack_bound_ms"] = w_only_bound
    for key, r in loss_k.items():
        require(r["ok"], f"kernel {key} at hac training shapes disagrees "
                         f"with its plain version")
        r["bound"] = bound(r["bytes"], r["ops"], H100_F32_OPS)
    for key in "UVWXYZ":
        require(loss_k[key]["vs_old"] and loss_k[key]["plan"] is not None,
                f"kernel {key} at hac training shapes: the plan "
                f"{loss_k[key]['plan']} ran, or differs from the earlier "
                f"kernel")
    bound_u_only = bound(loss_k["U"]["bytes_no_stack"], loss_k["U"]["ops"],
                         H100_F32_OPS)
    loss_k["W"]["no_stack_bound_ms"] = bound(
        loss_k["W"]["bytes_no_stack"], loss_k["W"]["ops"], H100_F32_OPS)[0]
    log("  at hac training shapes: " + ", ".join(
        f"{k} {r['ms']:.4g} ms (plain {r['plain_ms']:.4g}, bound "
        f"{r['bound'][0]:.4g} by {r['bound'][1]}, max |diff| {r['err']:.3g})"
        for k, r in loss_k.items()) + f"; U without its stack "
        f"{ms_u_only:.4g} ms (bound {bound_u_only[0]:.4g})")
    log(f"    U and V on the ring (plan {loss_k['U']['plan']}), bit for bit "
        f"the earlier kernels'; the earlier kernels U "
        f"{loss_k['U']['old_kernel_ms']:.4g} ms (no stack "
        f"{loss_k['U']['no_stack_old_kernel_ms']:.4g}), V "
        f"{loss_k['V']['old_kernel_ms']:.4g} ms; Z split over warps (plan "
        f"{loss_k['Z']['plan']}), bit for bit the earlier Z's, which takes "
        f"{loss_k['Z']['old_kernel_ms']:.4g} ms")
    log(f"    Y split over warps (plan {loss_k['Y']['plan']}), bit for bit "
        f"the earlier Y's (stack, logZ, no-stack logZ), which takes "
        f"{loss_k['Y']['old_kernel_ms']:.4g} ms (no stack "
        f"{loss_k['Y']['no_stack_old_kernel_ms']:.4g}; split "
        f"{loss_k['Y']['no_stack_ms']:.4g}); X on the ring (plan "
        f"{loss_k['X']['plan']}), bit for bit the earlier X's, which takes "
        f"{loss_k['X']['old_kernel_ms']:.4g} ms")
    log(f"    W on the ring, bit for bit the earlier W's (stack, logZ, "
        f"no-stack logZ), which takes {loss_k['W']['old_kernel_ms']:.4g} ms "
        f"(no stack {loss_k['W']['no_stack_old_kernel_ms']:.4g}; on the ring "
        f"{loss_k['W']['no_stack_ms']:.4g}, bound "
        f"{loss_k['W']['no_stack_bound_ms']:.4g})")
    loss_k["U"]["train_loss_ms"] = loss_k["V"]["train_loss_ms"] = ms_train
    loss_k["U"]["train_loss_old_kernel_ms"] = ms_train_old
    loss_k["V"]["train_loss_old_kernel_ms"] = ms_train_old
    loss_k["Y"]["train_loss_ms"] = [ms_train, ms_train_y_again]
    loss_k["Y"]["train_loss_old_kernel_ms"] = ms_train_y_old
    loss_k["Y"]["valid_loss_ms"] = ms_valid
    loss_k["Y"]["valid_loss_old_kernel_ms"] = ms_valid_y_old
    loss_k["X"]["loss_ms"] = loss_k["W"]["loss_ms"] = ms_full
    loss_k["X"]["loss_old_kernel_ms"] = ms_full_old
    loss_k["W"]["loss_old_kernel_ms"] = ms_full_w_old
    return loss_paths, loss_k, loss_more, ms_u_only, bound_u_only


def kernel_counters():
    """Every kernel wrapper of the port by its letter; each carries the
    count of its launches."""
    from bonito_tpu_torch.ops import (attention_cuda, decode_cuda,
                                      decode_full_cuda, decode_fused_cuda,
                                      lattice_cuda, logz_cuda, lstm_cuda,
                                      lstm_fused_cuda, lstm_int8_cuda,
                                      lstm_train_cuda, relayout)
    return {"A": lstm_cuda.lstm_recurrence,
            "B": decode_cuda.tcn_forward, "C": decode_cuda.tcn_backward,
            "D": lstm_int8_cuda.lstm_int8_fused,
            "E": lstm_int8_cuda.lstm_int8_recurrence,
            "F": lstm_fused_cuda.lstm_fused,
            "G": decode_fused_cuda.tcn_fused_forward,
            "J": decode_fused_cuda.tcn_fused_backward,
            "GW": decode_fused_cuda.tcn_fused_forward_wide,
            "JW": decode_fused_cuda.tcn_fused_backward_wide,
            "HP": decode_fused_cuda.head_product,
            "K": attention_cuda.fused_rotary_window_attention,
            "L": attention_cuda.local_attention,
            "P": relayout.pin_layout,
            "M": decode_full_cuda.full_forward,
            "Q": decode_full_cuda.full_backward,
            "U": logz_cuda.tcn_forward, "V": logz_cuda.tcn_backward,
            "W": logz_cuda.full_forward, "X": logz_cuda.full_backward,
            "Y": lattice_cuda.lattice_forward,
            "Z": lattice_cuda.lattice_backward,
            "R": lstm_train_cuda.lstm_train_forward,
            "S": lstm_train_cuda.lstm_train_backward,
            "H": attention_cuda.fused_rotary_window_attention_train,
            "O": attention_cuda.fused_rotary_window_attention_bwd}


def loss_mods():
    """The loss's route and kernel modules, in ``plain_loss_kernels``'s
    order."""
    from bonito_tpu_torch.ops import lattice as ops_lattice
    from bonito_tpu_torch.ops import lattice_cuda, logz_cuda
    from bonito_tpu_torch.ops import logz as ops_logz
    return ops_logz, logz_cuda, ops_lattice, lattice_cuda


class plain_train_kernels(plain_loss_kernels):
    """Within the block every kernel of a train step runs its plain version
    on the card: R and S (named in ``ops.lstm``, where the autograd
    Function calls them) and the loss's U to Z."""

    def __init__(self, ops_lstm, lstm_train_cuda, *loss_mods):
        super().__init__(*loss_mods)
        self.swap[(ops_lstm, "lstm_train_forward")] = (
            lstm_train_cuda.lstm_train_forward_plain)
        self.swap[(ops_lstm, "lstm_train_backward")] = (
            lstm_train_cuda.lstm_train_backward_plain)


def r_step_kernel(torch, build, xw, w_hh, reverse=False):
    """R's step kernel (one launch per timestep: the branch of
    ops.lstm_train_cuda.lstm_train_forward for an f32 model, f32 storage or
    an H whose W_hh does not fit in shared memory, and R's first design) at
    xw's shape in bf16 with bf16 storage, through its C entry: checked
    against the plain version and timed beside the persistent kernel in
    the same run. No path runs it at these shapes, so it counts no
    launch."""
    T_, N_, G_ = xw.shape
    H_ = G_ // 4
    Np = -(-N_ // 32) * 32
    h = torch.empty(T_, N_, H_, dtype=xw.dtype, device=xw.device)
    c = torch.empty(T_, N_, H_, dtype=xw.dtype, device=xw.device)
    acts = torch.empty(T_, N_, G_, dtype=xw.dtype, device=xw.device)
    hbuf = torch.zeros(2, Np, H_, dtype=xw.dtype, device=xw.device)
    cbuf = torch.zeros(N_, H_, dtype=torch.float32, device=xw.device)
    build.check(build.library().lstm_train_fwd(
        xw.data_ptr(), w_hh.data_ptr(), h.data_ptr(), c.data_ptr(),
        acts.data_ptr(), hbuf.data_ptr(), cbuf.data_ptr(), 0, 1, T_, N_, Np,
        H_, int(reverse), build.stream_of(xw)), "lstm_train_fwd")
    return h, c, acts


def s_step_kernel(torch, build, w_hh, acts, c, g_h, reverse=False):
    """S's step kernel, as ``r_step_kernel`` R's."""
    T_, N_, G_ = acts.shape
    Np = -(-N_ // 32) * 32
    dgates = torch.empty_like(acts)
    dgbuf = torch.zeros(2, Np, G_, dtype=acts.dtype, device=acts.device)
    dcbuf = torch.zeros(N_, G_ // 4, dtype=torch.float32, device=acts.device)
    build.check(build.library().lstm_train_bwd(
        w_hh.data_ptr(), acts.data_ptr(), c.data_ptr(), g_h.data_ptr(),
        dgates.data_ptr(), dgbuf.data_ptr(), dcbuf.data_ptr(), 0, 1, T_, N_,
        Np, G_ // 4, int(reverse), build.stream_of(acts)), "lstm_train_bwd")
    return dgates


def check_lstm_train(torch, ops_lstm, lstm_train_cuda, lstm_cuda, build, dev,
                     n, t, h, time_it):
    """Kernels R and S against their plain versions on random bf16 inputs
    at (N, T, H) = (n, t, h), both directions, rounding as bonito_tpu's
    kernels do: R's h, c and activations; S's gate gradient on R's own
    output (the same inputs as its plain version); their step kernels
    (``r_step_kernel``, ``s_step_kernel``) on the same inputs; and the
    Function's dxw and dW_hh through the kernels against the same through
    the plain versions. R's h against kernel A's on the same xw and W_hh:
    at one plan, bit for bit. Returns the worst differences (max and mean
    relative to the largest magnitude of the reference, and the max
    absolute), the plans R and S ran and, with ``time_it``, the times of
    R, S, their step kernels, their plain versions and a cuDNN LSTM
    layer's forward + backward at the same shape."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    xw = torch.randn(t, n, 4 * h, device=dev, generator=g).to(torch.bfloat16)
    w_hh = (torch.randn(h, 4 * h, device=dev, generator=g) / math.sqrt(h)
            ).to(torch.bfloat16)
    g_h = torch.randn(t, n, h, device=dev, generator=g).to(torch.bfloat16)
    err = {}

    def diff(key, out, ref):
        d = (out.float() - ref.float()).abs()
        scale = max(ref.float().abs().max().item(), 1e-30)
        worst = d.max().item()
        old = err.get(key, (0.0, 0.0, 0.0))
        err[key] = (max(old[0], worst / scale),
                    max(old[1], d.mean().item() / scale), max(old[2], worst))

    def function(xw_, w_, reverse):
        xw_ = xw_.detach().requires_grad_()
        w_ = w_.detach().requires_grad_()
        out = ops_lstm.LSTMRecurrence.apply(xw_, w_, reverse, True)
        out.backward(g_h)
        return xw_.grad, w_.grad

    plans = {}
    for reverse in (False, True):
        hk, ck, ak = lstm_train_cuda.lstm_train_forward(xw, w_hh, reverse)
        plans["R"] = lstm_train_cuda.lstm_train_forward.plan
        ha = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
        require(lstm_cuda.lstm_recurrence.plan == plans["R"]
                and torch.equal(hk, ha),
                f"kernel R's h is not kernel A's at (N {n}, T {t}, H {h}), "
                f"reverse={reverse}: plans {plans['R']} and "
                f"{lstm_cuda.lstm_recurrence.plan}")
        del ha
        hp, cp, ap = lstm_train_cuda.lstm_train_forward_plain(xw, w_hh,
                                                              reverse)
        torch.cuda.synchronize()
        for key, out, ref in (("h", hk, hp), ("c", ck, cp), ("acts", ak, ap)):
            require(bool(torch.isfinite(out.float()).all()),
                    f"kernel R: non-finite {key}")
            diff(key, out, ref)
        for key, out, ref in zip(("step h", "step c", "step acts"),
                                 r_step_kernel(torch, build, xw, w_hh,
                                               reverse), (hp, cp, ap)):
            require(bool(torch.isfinite(out.float()).all()),
                    f"R's step kernel: non-finite {key}")
            diff(key, out, ref)
        del hp, cp, ap
        dk = lstm_train_cuda.lstm_train_backward(w_hh, ak, ck, g_h, reverse)
        plans["S"] = lstm_train_cuda.lstm_train_backward.plan
        dp = lstm_train_cuda.lstm_train_backward_plain(w_hh, ak, ck, g_h,
                                                       reverse)
        require(bool(torch.isfinite(dk.float()).all()),
                "kernel S: non-finite dgates")
        diff("dgates", dk, dp)
        ds = s_step_kernel(torch, build, w_hh, ak, ck, g_h, reverse)
        require(bool(torch.isfinite(ds.float()).all()),
                "S's step kernel: non-finite dgates")
        diff("step dgates", ds, dp)
        del dk, dp, ds, hk, ck, ak
        dxw, dw = function(xw, w_hh, reverse)
        with plain_train_kernels(ops_lstm, lstm_train_cuda, *loss_mods()):
            pdxw, pdw = function(xw, w_hh, reverse)
        diff("dxw", dxw, pdxw)
        diff("dW_hh", dw, pdw)
        del dxw, dw, pdxw, pdw
    times = {}
    if time_it:
        times["R"] = cuda_ms(lambda: lstm_train_cuda.lstm_train_forward(
            xw, w_hh), reps=3)
        _, ck, ak = lstm_train_cuda.lstm_train_forward(xw, w_hh)
        times["S"] = cuda_ms(lambda: lstm_train_cuda.lstm_train_backward(
            w_hh, ak, ck, g_h), reps=3)
        times["R_step"] = cuda_ms(
            lambda: r_step_kernel(torch, build, xw, w_hh), reps=2)
        times["S_step"] = cuda_ms(
            lambda: s_step_kernel(torch, build, w_hh, ak, ck, g_h), reps=2)
        times["R_plain"] = cuda_ms(
            lambda: lstm_train_cuda.lstm_train_forward_plain(xw, w_hh),
            reps=1, warmup=0)
        times["S_plain"] = cuda_ms(
            lambda: lstm_train_cuda.lstm_train_backward_plain(w_hh, ak, ck,
                                                              g_h),
            reps=1, warmup=0)
        del ck, ak
        # cuDNN: one layer's forward + backward, its input projection
        # included (x of width H), at the same shape
        cudnn = torch.nn.LSTM(h, h, device=dev, dtype=torch.bfloat16)
        cudnn.flatten_parameters()
        x = torch.randn(t, n, h, device=dev, generator=g).to(
            torch.bfloat16).requires_grad_()

        def cudnn_step():
            out, _ = cudnn(x)
            out.backward(g_h)
        times["cudnn"] = cuda_ms(cudnn_step, reps=3)
        del cudnn, x
    # bounds: R reads xw and W_hh and writes h, c and the activations; S
    # reads the activations, c (its previous step's too, the same tensor),
    # g_h and W_hh and writes the gates' gradient; each 2*N*H*4H*T
    # operations on the tensor cores, and about 20 f32 operations per hidden
    # unit and step outside them
    plane, gates = t * n * h * 2, t * n * 4 * h * 2
    bounds = {
        "R": bound(gates + h * 4 * h * 2 + 2 * plane + gates,
                   2 * n * h * 4 * h * t, H100_BF16_OPS, 20 * n * h * t),
        "S": bound(gates + 2 * plane + h * 4 * h * 2 + gates,
                   2 * n * h * 4 * h * (t - 1), H100_BF16_OPS,
                   20 * n * h * t)}
    return err, plans, times, bounds


def train_batch(torch, dev, n, chunk, length, seed):
    """A batch of ``n`` chunks of standard-normal signal and targets of
    length/2 to ``length`` bases (1..4), from ``seed``, on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, chunk, 1)).astype(np.float32))
    lengths = rng.integers(length // 2, length + 1, n)
    targets = rng.integers(1, 5, (n, length))
    targets[np.arange(length)[None] >= lengths[:, None]] = 0
    return (x.to(dev), torch.from_numpy(targets).to(dev),
            torch.from_numpy(lengths).to(dev))


def step_grads(torch, model, batch):
    """The loss and every parameter's gradient of one amp step, without
    the optimiser (the train step's forward and backward)."""
    x, targets, lengths = batch
    model.train()
    model.zero_grad(set_to_none=True)
    try:
        moves, blank = model.forward_tcn(x.to(torch.bfloat16))
        loss = model.loss_tcn(moves, blank, targets, lengths)
        loss.backward()
    finally:
        model.eval()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def steps_in_turns(torch, step, batch, mod, rule):
    """A train step's ms (a warm-up, then TRAIN_STEPS steps) with the
    kernels of ``rule`` (``earlier_kernel``'s: "logz_plan" for U and V,
    "lattice_plan" for Z, "lattice_fwd_plan" for Y) on their earlier
    kernels, on their plans, then on the earlier kernels again: {"old":
    [ms, ms], "ring": [ms]}."""
    def step_ms():
        step(batch, 1.0, 2.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step(batch, 1.0, 2.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    turns = {"old": [], "ring": []}
    for route in ("old", "ring", "old"):
        if route == "old":
            with earlier_kernel(mod, rule):
                turns[route].append(step_ms())
        else:
            turns[route].append(step_ms())
    return turns


def train_step_phase(torch, counters, dev):
    """Phase 10: the LSTM-CRF train step. (a) R and S against their plain
    versions at hac and fast training shapes; (b) the hac train step at
    batch 128 x 6000 (f32 master weights, bf16 forward, AdamW 2e-3, clip
    2.0): a warm-up step, then TRAIN_STEPS timed ones with their launch
    counts, and one step's gradients through the kernels against the same
    through the plain versions; (c) one fast train step; (d) the train CLI
    end to end on a generated npy set."""
    from bonito_tpu_torch.crf.model import Model
    from bonito_tpu_torch.models import MODELS, lstm_crf_config
    from bonito_tpu_torch.ops import build, lattice_cuda, logz_cuda, lstm_cuda
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.ops import lstm_train_cuda
    from bonito_tpu_torch.training import make_optimizer, make_train_step

    log(f"[10] the LSTM-CRF train step (kernels R, S with U, V, Y, Z)")
    res = {"kernels": {}}
    for shape, (n, t, h) in TRAIN_SHAPES.items():
        err, plans, times, bounds = check_lstm_train(
            torch, ops_lstm, lstm_train_cuda, lstm_cuda, build, dev, n, t, h,
            time_it=True)
        res["kernels"][shape] = (err, plans, times, bounds)
        bad = {k: v for k, v in err.items()
               if v[0] > LSTM_TRAIN_MAX or v[1] > LSTM_TRAIN_MEAN}
        log(f"  R, S vs plain at {shape} training shapes (N {n}, T {t}, H "
            f"{h}), both directions; worst |diff| / max |ref| (max, mean): "
            + ", ".join(f"{k} {m:.3g} / {a:.3g} (max abs {w:.3g})"
                        for k, (m, a, w) in err.items()))
        log(f"    R {times['R']:.4g} ms = {times['R'] / t * 1e3:.4g} us a "
            f"step (step kernel {times['R_step']:.4g}, plain "
            f"{times['R_plain']:.4g}, bound {bounds['R'][0]:.4g} by "
            f"{bounds['R'][1]}), S {times['S']:.4g} ms = "
            f"{times['S'] / t * 1e3:.4g} us a step (step kernel "
            f"{times['S_step']:.4g}, plain {times['S_plain']:.4g}, bound "
            f"{bounds['S'][0]:.4g} by {bounds['S'][1]}); R + S "
            f"{times['R'] + times['S']:.4g} ms vs cuDNN LSTM({h}, {h}) "
            f"forward + backward {times['cudnn']:.4g} ms; R's h is A's bit "
            f"for bit")
        log(f"    R's plan {plans['R']}; S's plan {plans['S']}")
        require(not bad, f"R, S at {shape} training shapes disagree with "
                         f"their plain versions: {bad}")

    log(f"  hac train step: batch {TRAIN_N} x chunk {TRAIN_CHUNK}, f32 "
        f"master weights, bf16 forward, AdamW 2e-3, clip 2.0")
    hac = Model(lstm_crf_config()).init(SEED).to(dev)
    step = make_train_step(hac, make_optimizer(hac, 2e-3))
    batch = train_batch(torch, dev, TRAIN_N, TRAIN_CHUNK, TRAIN_L, SEED)
    before = {k: p.detach().clone() for k, p in hac.named_parameters()}
    losses, norm = step(batch, 1.0, 2.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = [step(batch, 1.0, 2.0) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {k: c.launches for k, c in counters.items()}
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    own = {"R": 5, "S": 5, "U": 1, "V": 1, "Y": 1, "Z": 1}
    expect = {k: own.get(k, 0) * TRAIN_STEPS for k in counters}
    require(launches == expect, f"hac train step: launches {launches}, "
                                f"expected {expect}")
    values = [(float(l["loss"]), float(n_)) for l, n_ in [(losses, norm)]
              + out]
    require(all(math.isfinite(v) for pair in values for v in pair),
            f"hac train step: non-finite loss or grad norm {values}")
    moved = sum(not torch.equal(p.detach(), before[k])
                for k, p in hac.named_parameters())
    require(moved == len(before), f"hac train step: {len(before) - moved} "
                                  f"parameters did not move")
    del before
    res["hac"] = dict(ms=wall * 1e3, peak=peak, held=held / 2 ** 30,
                      launches=launches, values=values)
    log(f"  hac train step on {card_line()}: {wall * 1e3:.4g} ms per step "
        f"= {TRAIN_N * TRAIN_CHUNK / wall:.6g} train samples/s ("
        f"{TRAIN_STEPS} steps after a warm-up); peak memory {peak:.3f} GiB "
        f"above the {held / 2 ** 30:.3f} GiB held before the timed steps; "
        f"loss and grad norm per step {values}; launches per step "
        f"{({k: v // TRAIN_STEPS for k, v in launches.items() if v})}")

    loss_k, grads_k = step_grads(torch, hac, batch)
    with plain_train_kernels(ops_lstm, lstm_train_cuda, *loss_mods()):
        loss_p, grads_p = step_grads(torch, hac, batch)
    # a convolution's bias in front of a batch-statistics BatchNorm has a
    # gradient of 0 in exact arithmetic (the norm takes the batch mean out):
    # what both give there is rounding noise, held to the others' size
    rel = {}
    for k in grads_p:
        d = (grads_k[k].float() - grads_p[k].float()).norm().item()
        if k.endswith(".b") and k[:-1] + "norm.scale" in grads_p:
            ref = max(grads_p[k[:-1] + "w"].float().norm().item(), 1e-30)
        else:
            ref = max(grads_p[k].float().norm().item(), 1e-30)
        rel[k] = d / ref
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    worst = top[0][1]
    res["hac"]["grad_rel"] = worst
    res["hac"]["loss_diff"] = abs(loss_k.item() - loss_p.item())
    log(f"  one hac step through the kernels vs the plain versions: loss "
        f"{loss_k.item():.7g} vs {loss_p.item():.7g}; relative L2 "
        f"difference of the gradients, worst three: "
        + ", ".join(f"{k} {v:.3g}" for k, v in top)
        + f" (limit {TRAIN_GRAD_REL})")
    require(worst <= TRAIN_GRAD_REL and res["hac"]["loss_diff"]
            <= TRAIN_LOSS_TOL, "hac train step: the kernels' gradients "
                               "disagree with the plain versions'")
    res["hac"]["uv_plans"] = (logz_cuda.tcn_forward.plan,
                              logz_cuda.tcn_backward.plan)
    res["hac"]["z_plan"] = lattice_cuda.lattice_backward.plan
    res["hac"]["y_plan"] = lattice_cuda.lattice_forward.plan
    turns = steps_in_turns(torch, step, batch, logz_cuda, "logz_plan")
    res["hac"]["uv_turns"] = turns
    log(f"  the hac train step in turns, U and V on their earlier kernels "
        f"/ on the ring: {turns['old'][0]:.4g} / {turns['ring'][0]:.4g} / "
        f"{turns['old'][1]:.4g} ms (the timed steps above: "
        f"{res['hac']['ms']:.4g}); U's and V's plans "
        f"{res['hac']['uv_plans']}")
    turns = steps_in_turns(torch, step, batch, lattice_cuda, "lattice_plan")
    res["hac"]["z_turns"] = turns
    log(f"  the hac train step in turns, Z on its earlier kernel / split "
        f"over warps: {turns['old'][0]:.4g} / {turns['ring'][0]:.4g} / "
        f"{turns['old'][1]:.4g} ms; Z's plan {res['hac']['z_plan']}")
    turns = steps_in_turns(torch, step, batch, lattice_cuda,
                           "lattice_fwd_plan")
    res["hac"]["y_turns"] = turns
    log(f"  the hac train step in turns, Y on its earlier kernel (the "
        f"parent's route) / split over warps: {turns['old'][0]:.4g} / "
        f"{turns['ring'][0]:.4g} / {turns['old'][1]:.4g} ms; Y's plan "
        f"{res['hac']['y_plan']}")
    require(all(p is not None for p in res["hac"]["uv_plans"]),
            "hac train step: U and V did not run on the ring")
    require(res["hac"]["z_plan"] is not None,
            "hac train step: Z ran on its earlier kernel")
    require(res["hac"]["y_plan"] is not None,
            "hac train step: Y ran on its earlier kernel")
    del hac, step, grads_k, grads_p, batch
    torch.cuda.empty_cache()

    cfg = MODELS[FAST]()
    fast = Model(cfg).init(SEED).to(dev)
    step = make_train_step(fast, make_optimizer(fast, 2e-3))
    batch = train_batch(torch, dev, TRAIN_N, TRAIN_CHUNK, TRAIN_L, SEED)
    step(batch, 1.0, 2.0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    losses, norm = step(batch, 1.0, 2.0)
    torch.cuda.synchronize()
    fast_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    require(launches == {k: own.get(k, 0) for k in counters},
            f"fast train step: launches {launches}")
    require(math.isfinite(float(losses["loss"])) and math.isfinite(
        float(norm)), "fast train step: non-finite loss or grad norm")
    require(lattice_cuda.lattice_forward.plan is not None
            and lattice_cuda.lattice_backward.plan is not None,
            "fast train step: Y or Z ran on its earlier kernel")
    res["fast"] = dict(ms=fast_ms, launches=launches)
    log(f"  fast train step (batch {TRAIN_N} x {TRAIN_CHUNK}, H 96): "
        f"{fast_ms:.4g} ms = {TRAIN_N * TRAIN_CHUNK / fast_ms * 1e3:.6g} "
        f"train samples/s (one step after a warm-up); loss "
        f"{float(losses['loss']):.6g}")
    del fast, step, batch
    torch.cuda.empty_cache()
    res["cli"] = train_cli(
        torch, counters, HAC, TRAIN_N, TRAIN_CHUNK, TRAIN_L,
        TRAIN_CLI_BATCHES, own,
        # validation, in eval mode: the inference route (A x 5), the loss (U
        # and Y without their stacks), then the decode (B and C)
        {"A": 5, "U": 1, "Y": 1, "B": 1, "C": 1}, "hac")
    return res


def train_cli(torch, counters, config, n, chunk, length, batches, own,
              valid, name, extra=()):
    """``python -m bonito_tpu_torch train --config config`` in this process
    on a generated npy set under the build directory: ``batches`` training
    batches of ``n`` x ``chunk`` samples with targets of length/2 to
    ``length`` bases and one validation batch, one epoch (``extra``: more
    arguments, as ``--no-amp``). ``own``: each kernel's launches per
    training batch; ``valid``: the validation batch's."""
    from bonito_tpu_torch.cli import main as cli_main
    from bonito_tpu_torch.ops import build
    root = build.BUILD / f"chip_smoke_train_{name}"
    if root.exists():
        shutil.rmtree(root)
    rng = np.random.default_rng(SEED)
    for sub, rows in (("", batches * n), ("validation", n)):
        d = root / "data" / sub
        d.mkdir(parents=True)
        lengths = rng.integers(length // 2, length + 1, rows)
        refs = rng.integers(1, 5, (rows, length))
        refs[np.arange(length)[None] >= lengths[:, None]] = 0
        np.save(d / "chunks.npy", rng.normal(size=(rows, chunk))
                .astype(np.float16))
        np.save(d / "references.npy", refs.astype(np.uint8))
        np.save(d / "reference_lengths.npy", lengths.astype(np.uint16))
    work = root / "work"
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    cli_main(["train", str(work), "--config", config, "--directory",
              str(root / "data"), "--batch", str(n), "--epochs", "1",
              "--seed", str(SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect = {k: own.get(k, 0) * batches + valid.get(k, 0) for k in counters}
    require(launches == expect, f"train CLI ({name}): launches {launches}, "
                                f"expected {expect}")
    require((work / "weights_1.npz").exists(), "train CLI: no weights_1.npz")
    with open(work / "losses_1.csv") as f:
        rows = f.read().strip().splitlines()
    require(len(rows) == 1 + batches,
            f"train CLI: losses_1.csv has {len(rows) - 1} rows")
    with open(work / "training.csv") as f:
        header, row = f.read().strip().splitlines()
    fields = dict(zip(header.split(","), row.split(",")))
    acc = float(fields["validation_mean"])
    require(math.isfinite(acc) and math.isfinite(
        float(fields["validation_loss"])), f"train CLI: {fields}")
    log(f"  train CLI, one epoch of {name} ({batches} batches of {n} x "
        f"{chunk}, one validation batch): {wall:.1f} s in all (model init, "
        f"data, steps, checkpoint, validation); training.csv {fields}; "
        f"launches {({k: v for k, v in launches.items() if v})}")
    return dict(wall=wall, launches=launches, fields=fields)


class plain_sup_train_kernels(plain_loss_kernels):
    """Within the block every kernel of a sup train step runs its plain
    version on the card: H and O (named in ``ops.attention_cuda``, where
    the autograd Function calls them), P (``ops.relayout._pin``, forward
    and backward) and the loss's U to Z."""

    def __init__(self, attention_cuda, relayout, *loss_mods):
        super().__init__(*loss_mods)
        self.swap[(attention_cuda, "fused_rotary_window_attention_train")] = (
            attention_cuda.fused_rotary_window_attention_train_plain)
        self.swap[(attention_cuda, "fused_rotary_window_attention_bwd")] = (
            attention_cuda.fused_rotary_window_attention_bwd_plain)
        self.swap[(relayout, "_pin")] = relayout.pin_layout_plain


def band_pairs(T, window, t_real=None):
    """Visible (query, key) pairs of one head of one row."""
    i = np.arange(T)
    hi = np.minimum(np.minimum(T, t_real or T) - 1, i + window[1])
    return int(np.maximum(hi - np.maximum(0, i - window[0]) + 1, 0).sum())


def check_attention_train(torch, attention_cuda, relayout, dev):
    """Kernels H and O against their plain versions at sup training widths
    (N 32, 8 heads of 64, window (127, 128)): T 1024 and 1000 in bf16, T
    1024 with t_real 1000, f32, and a partial rotary_dim of 32; H's o
    against K's; O on its stretch kernel in bf16 (a plan at each), and
    there against its earlier kernel: each of dq, dk, dv within one bf16
    step of the earlier kernel's largest; P's backward on a transposed
    cotangent. Returns the first case's tensors (for the times) and the
    worst differences."""
    from bonito_tpu_torch.transformer.model import rotary_freqs
    g = torch.Generator().manual_seed(SEED + 11)
    fwd = attention_cuda.fused_rotary_window_attention_train
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    errs = {"o": 0.0, "lse": 0.0, "dqkv": 0.0, "dqkv_old": 0.0}
    kept = None
    for T, dtype, r, t_real in ((SUP_TRAIN_T, torch.bfloat16, SD, None),
                                (ST, torch.bfloat16, SD, None),
                                (SUP_TRAIN_T, torch.bfloat16, SD, ST),
                                (SUP_TRAIN_T, torch.float32, SD, None),
                                (ST, torch.bfloat16, SD // 2, None)):
        qkv = torch.randn(SUP_TRAIN_N, T, 3, SH, SD, generator=g).to(dev, dtype)
        do = torch.randn(SUP_TRAIN_N, T, SH, SD, generator=g).to(dev, dtype)
        cos, sin = rotary_freqs(T, r, device=dev)
        o, lse = fwd(qkv, cos, sin, SWIN, t_real)
        dqkv = bwd(qkv, cos, sin, lse, o, do, SWIN, t_real)
        plan = bwd.plan
        old = (attention_cuda.fused_rotary_window_attention_bwd_old_kernel(
            qkv, cos, sin, lse, o, do, SWIN, t_real) if plan is not None
            else None)
        torch.cuda.synchronize()
        same_k = torch.equal(o, attention_cuda.fused_rotary_window_attention(
            qkv, cos, sin, SWIN, t_real))
        ref_o, ref_lse = attention_cuda.fused_rotary_window_attention_train_plain(
            qkv, cos, sin, SWIN, t_real)
        ref = attention_cuda.fused_rotary_window_attention_bwd_plain(
            qkv, cos, sin, lse, o, do, SWIN, t_real)
        outs = [("o", o, ref_o)] + [(f"d{c}", dqkv[:, :, i], ref[:, :, i])
                                    for i, c in enumerate("qkv")]
        line, ok = [], same_k and bool(torch.isfinite(dqkv.float()).all())
        for name, out, want in outs:
            diff = (out.float() - want.float()).abs()
            top = want.float().abs().max().item()
            err, mean = diff.max().item(), diff.mean().item()
            ok &= err <= bf16_step(top) and mean <= ROW13_MEAN * top
            line.append(f"{name} {err:.3g} / {mean:.3g} at max {top:.3g}")
            key = "o" if name == "o" else "dqkv"
            errs[key] = max(errs[key], err)
        top = ref_lse.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = ROW13_LSE_STEPS * 2.0 ** (math.floor(math.log2(top)) - 23)
        ok &= lse_err <= lse_tol
        errs["lse"] = max(errs["lse"], lse_err)
        ok &= (plan is not None) == (dtype == torch.bfloat16)
        route = "O on its earlier kernel"
        if old is not None:
            worst = 0.0
            for i in range(3):
                want = old[:, :, i].float()
                d_old = (dqkv[:, :, i].float() - want).abs().max().item()
                ok &= d_old <= bf16_step(want.abs().max().item())
                worst = max(worst, d_old)
            errs["dqkv_old"] = max(errs["dqkv_old"], worst)
            route = (f"O on its stretch kernel (stretch {plan['stretch']}, "
                     f"{plan['ctas']} CTAs), max |diff| from its earlier "
                     f"kernel {worst:.3g}")
        log(f"  H, O vs plain, T={T} {str(dtype)[6:]} rotary_dim={r} "
            f"t_real={t_real}: max / mean |diff| " + ", ".join(line)
            + f"; lse {lse_err:.3g} (tolerance {lse_tol:.3g}); o equals K's "
            f"{same_k}; {route}")
        require(ok, f"H or O disagrees with its plain version at T={T}, "
                    f"{dtype}, rotary_dim {r}, t_real {t_real}")
        if kept is None:
            kept = (qkv, cos, sin, do, o, lse)
        del dqkv, ref, ref_o, ref_lse, old
    x = torch.randn(SUP_TRAIN_N, SH * SD, SUP_TRAIN_T, generator=g).to(
        dev, torch.bfloat16).transpose(1, 2).requires_grad_()
    cot = torch.randn(SUP_TRAIN_N, SH * SD, SUP_TRAIN_T, generator=g).to(
        dev, torch.bfloat16).transpose(1, 2)
    before = relayout.pin_layout.launches
    y = relayout.pin_layout(x)
    y.backward(cot)
    torch.cuda.synchronize()
    n_p = relayout.pin_layout.launches - before
    log(f"  P backward on a transposed cotangent {tuple(cot.shape)} strides "
        f"{cot.stride()}: x.grad identical {torch.equal(x.grad, cot)}, "
        f"{n_p} launches (forward and backward)")
    require(torch.equal(x.grad, cot) and torch.equal(y, x) and n_p == 2,
            "P's backward is not the identity through two launches")
    return kept, errs


def sup_train_batch(torch, dev, seed):
    """The sup bench's batch: SUP_TRAIN_N chunks of standard-normal signal,
    targets of SUP_TRAIN_L bases (1..4) from ``seed``, on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(SUP_TRAIN_N, SUP_TRAIN_CHUNK, 1)).astype(np.float32)
    targets = rng.integers(1, 5, (SUP_TRAIN_N, SUP_TRAIN_L))
    lengths = np.full(SUP_TRAIN_N, SUP_TRAIN_L)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, targets, lengths))


def sup_train_phase(torch, counters, dev):
    """Phase 11: the sup train step. (a) H and O against their plain
    versions, P's backward; (b) the full-width sup train step: a warm-up,
    TRAIN_STEPS timed steps with their launch counts, every parameter moved,
    one step's gradients through the kernels against the plain versions';
    (c) one epoch of the train CLI; (d) H's and O's times, bounds and the
    library yardstick."""
    import torch.nn.functional as F
    from bonito_tpu_torch.models import MODELS
    from bonito_tpu_torch.ops import (attention_cuda, lattice_cuda,
                                      logz_cuda, relayout)
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    from bonito_tpu_torch.transformer import model as transformer

    log(f"[11] the sup train step (kernels H, O, P with U, V, Y, Z): batch "
        f"{SUP_TRAIN_N} x chunk {SUP_TRAIN_CHUNK}, f32 master weights, bf16 "
        f"forward, AdamW 2e-3, clip 2.0")
    kept, errs = check_attention_train(torch, attention_cuda, relayout, dev)
    res = {"errs": errs}

    model = transformer.Model(MODELS[SUP]()).init(SEED).to(dev)
    step = make_train_step(model, make_optimizer(model, 2e-3))
    batch = sup_train_batch(torch, dev, SEED)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, norm = step(batch, 1.0, 2.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = [step(batch, 1.0, 2.0) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {k: c.launches for k, c in counters.items()}
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    own = {"P": 2, "H": 18, "O": 18, "U": 1, "V": 1, "Y": 1, "Z": 1}
    expect = {k: own.get(k, 0) * TRAIN_STEPS for k in counters}
    require(launches == expect, f"sup train step: launches {launches}, "
                                f"expected {expect}")
    values = [(float(l["loss"]), float(n_)) for l, n_ in [(losses, norm)]
              + out]
    require(all(math.isfinite(v) for pair in values for v in pair),
            f"sup train step: non-finite loss or grad norm {values}")
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), before[k])]
    convs = [k for k in before if k.startswith("encoder.conv.")
             and k.endswith(".w")]
    wqkv = [k for k in before if k.endswith("wqkv")]
    log(f"  every parameter moved: {not still} ({len(before)} parameters, "
        f"{len(convs)} convolution weights and {len(wqkv)} wqkv among them)")
    require(not still and len(convs) == 5 and len(wqkv) == 18,
            f"sup train step: {still} did not move")
    del before
    res["step"] = dict(ms=wall * 1e3, peak=peak, held=held / 2 ** 30,
                       launches=launches, values=values)
    log(f"  sup train step on {card_line()}: {wall * 1e3:.4g} ms per step "
        f"= {SUP_TRAIN_N * SUP_TRAIN_CHUNK / wall:.6g} sup train samples/s "
        f"({TRAIN_STEPS} steps after a warm-up); peak memory {peak:.3f} GiB "
        f"above the {held / 2 ** 30:.3f} GiB held before the timed steps; "
        f"loss and grad norm per step {values}; launches per step "
        f"{({k: v // TRAIN_STEPS for k, v in launches.items() if v})}")

    def grads_of_one_step():
        x, targets, lengths = batch
        model.train()
        model.zero_grad(set_to_none=True)
        try:
            moves, blank = model.forward_tcn(x.to(torch.bfloat16))
            loss = model.loss_tcn(moves, blank, targets, lengths)
            loss.backward()
        finally:
            model.eval()
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.detach(), grads
    loss_k, grads_k = grads_of_one_step()
    with plain_sup_train_kernels(attention_cuda, relayout, *loss_mods()):
        loss_p, grads_p = grads_of_one_step()
    # a convolution's bias in front of a batch-statistics BatchNorm: its
    # gradient is 0 in exact arithmetic, held to its weight's size (phase 10)
    rel = {}
    for k in grads_p:
        d = (grads_k[k].float() - grads_p[k].float()).norm().item()
        ref_k = (k[:-1] + "w" if k.endswith(".b")
                 and k[:-1] + "norm.scale" in grads_p else k)
        rel[k] = d / max(grads_p[ref_k].float().norm().item(), 1e-30)
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    res["step"]["grad_rel"] = top[0][1]
    res["step"]["loss_diff"] = abs(loss_k.item() - loss_p.item())
    log(f"  one sup step through the kernels vs the plain versions: loss "
        f"{loss_k.item():.7g} vs {loss_p.item():.7g}; relative L2 difference "
        f"of the gradients, worst three: "
        + ", ".join(f"{k} {v:.3g}" for k, v in top)
        + f"; conv weights up to {max(rel[k] for k in convs):.3g}, wqkv up "
        f"to {max(rel[k] for k in wqkv):.3g} (limit {TRAIN_GRAD_REL})")
    require(top[0][1] <= TRAIN_GRAD_REL
            and res["step"]["loss_diff"] <= TRAIN_LOSS_TOL,
            "sup train step: the kernels' gradients disagree with the plain "
            "versions'")

    def step_ms():
        step(batch, 1.0, 2.0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step(batch, 1.0, 2.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    # the same step with H on its earlier kernel (O on its own), then with O
    # on its earlier kernel (H on its own)
    with earlier_kernel(attention_cuda):
        res["step"]["old_kernel_ms"] = step_ms()
    with earlier_kernel(attention_cuda, "window_bwd_plan"):
        res["step"]["o_old_kernel_ms"] = step_ms()
    log(f"  the same step with H on its earlier kernel: "
        f"{res['step']['old_kernel_ms']:.4g} ms per step; with O on its "
        f"earlier kernel: {res['step']['o_old_kernel_ms']:.4g} ms (both on "
        f"their stretch kernels: {res['step']['ms']:.4g})")
    res["step"]["uv_plans"] = (logz_cuda.tcn_forward.plan,
                               logz_cuda.tcn_backward.plan)
    res["step"]["z_plan"] = lattice_cuda.lattice_backward.plan
    res["step"]["y_plan"] = lattice_cuda.lattice_forward.plan
    turns = steps_in_turns(torch, step, batch, logz_cuda, "logz_plan")
    res["step"]["uv_turns"] = turns
    log(f"  the sup train step in turns, U and V on their earlier kernels "
        f"/ on the ring: {turns['old'][0]:.4g} / {turns['ring'][0]:.4g} / "
        f"{turns['old'][1]:.4g} ms (the timed steps above: "
        f"{res['step']['ms']:.4g}); U's and V's plans "
        f"{res['step']['uv_plans']}")
    turns = steps_in_turns(torch, step, batch, lattice_cuda, "lattice_plan")
    res["step"]["z_turns"] = turns
    log(f"  the sup train step in turns, Z on its earlier kernel / split "
        f"over warps: {turns['old'][0]:.4g} / {turns['ring'][0]:.4g} / "
        f"{turns['old'][1]:.4g} ms; Z's plan {res['step']['z_plan']}")
    turns = steps_in_turns(torch, step, batch, lattice_cuda,
                           "lattice_fwd_plan")
    res["step"]["y_turns"] = turns
    log(f"  the sup train step in turns, Y on its earlier kernel (the "
        f"parent's route) / split over warps: {turns['old'][0]:.4g} / "
        f"{turns['ring'][0]:.4g} / {turns['old'][1]:.4g} ms; Y's plan "
        f"{res['step']['y_plan']}")
    require(all(p is not None for p in res["step"]["uv_plans"]),
            "sup train step: U and V did not run on the ring")
    require(res["step"]["z_plan"] is not None,
            "sup train step: Z ran on its earlier kernel")
    require(res["step"]["y_plan"] is not None,
            "sup train step: Y ran on its earlier kernel")
    del model, step, grads_k, grads_p, batch
    torch.cuda.empty_cache()
    res["cli"] = train_cli(
        torch, counters, SUP, SUP_TRAIN_N, SUP_TRAIN_CHUNK, SUP_TRAIN_L,
        SUP_TRAIN_CLI_BATCHES, own,
        # validation in eval mode: P, 18 x K, the loss (U and Y without
        # their stacks), then the decode (B and C)
        {"P": 1, "K": 18, "U": 1, "Y": 1, "B": 1, "C": 1}, "sup")

    # H's and O's times at the step's shapes, their plain versions', and the
    # library yardstick: rotary passes + scaled_dot_product_attention with
    # the band as a mask, forward (H's) and backward under autograd (O's)
    qkv, cos, sin, do, o, lse = kept
    N_, T_ = qkv.shape[:2]
    fwd = attention_cuda.fused_rotary_window_attention_train
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    ms = {"H": cuda_ms(lambda: fwd(qkv, cos, sin, SWIN), reps=10),
          "H_old": cuda_ms(lambda: attention_cuda.
                           fused_rotary_window_attention_old_kernel(
                               qkv, cos, sin, SWIN, with_lse=True), reps=10),
          "O": cuda_ms(lambda: bwd(qkv, cos, sin, lse, o, do, SWIN),
                       reps=10),
          "O_old": cuda_ms(lambda: attention_cuda.
                           fused_rotary_window_attention_bwd_old_kernel(
                               qkv, cos, sin, lse, o, do, SWIN), reps=10),
          "H_plain": cuda_ms(lambda: attention_cuda.
                             fused_rotary_window_attention_train_plain(
                                 qkv, cos, sin, SWIN), reps=1, warmup=0),
          "O_plain": cuda_ms(lambda: attention_cuda.
                             fused_rotary_window_attention_bwd_plain(
                                 qkv, cos, sin, lse, o, do, SWIN), reps=1,
                             warmup=0)}
    band = attention_cuda.band_mask(T_, SWIN, None, dev)
    x_l = qkv.detach().requires_grad_()

    def library_fwd():
        q = transformer.apply_rotary(x_l[:, :, 0], cos, sin)
        k = transformer.apply_rotary(x_l[:, :, 1], cos, sin)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            x_l[:, :, 2].transpose(1, 2), attn_mask=band).transpose(1, 2)
    ms["H_library"] = cuda_ms(lambda: library_fwd().detach(), reps=5)
    o_l = library_fwd()
    ms["O_library"] = cuda_ms(lambda: torch.autograd.grad(
        o_l, x_l, do, retain_graph=True), reps=5)
    lib_err = (o_l.detach().float() - o.float()).abs().max().item()
    g_l = torch.autograd.grad(o_l, x_l, do)[0]
    g_k = bwd(qkv, cos, sin, lse, o, do, SWIN)
    lib_gerr = (g_l.float() - g_k.float()).abs().max().item()
    require(lib_err <= 2e-2 and lib_gerr <= 0.1 * g_k.float().abs().max()
            .item(), f"the library yardstick for H and O computes another "
                     f"function: {lib_err}, {lib_gerr}")
    del o_l, x_l, g_l, g_k
    pairs = N_ * SH * band_pairs(T_, SWIN)
    isz = qkv.element_size()
    plane = N_ * T_ * SH * SD * isz
    trig = 2 * T_ * cos.shape[1] * 4
    # H: qkv in, o and lse out; two band products on the tensor cores and
    # about 10 f32 operations per pair for the softmax. O: qkv, o, do and
    # lse in, dqkv out; five band products (s, dp, dq, dk, dv) and about 10
    # f32 operations per pair
    bounds = {"H": bound(3 * plane + plane + N_ * SH * T_ * 4 + trig,
                         2 * 2 * pairs * SD, H100_BF16_OPS, 10 * pairs),
              "O": bound(3 * plane + 2 * plane + N_ * SH * T_ * 4 + trig
                         + 3 * plane, 5 * 2 * pairs * SD, H100_BF16_OPS,
                         10 * pairs)}
    res["ms"], res["bounds"], res["lib_err"] = ms, bounds, lib_err
    res["plan"], res["o_plan"] = fwd.plan, bwd.plan
    log(f"  at the step's shapes (N {N_}, T {T_}, bf16): H {ms['H']:.4g} ms "
        f"on the stretch kernel (plan {fwd.plan}; the earlier kernel "
        f"{ms['H_old']:.4g}; "
        f"plain {ms['H_plain']:.4g}, bound {bounds['H'][0]:.4g} by "
        f"{bounds['H'][1]}), O {ms['O']:.4g} ms on the stretch kernel (plan "
        f"{bwd.plan}; the earlier kernel {ms['O_old']:.4g}; plain "
        f"{ms['O_plain']:.4g}, bound {bounds['O'][0]:.4g} by "
        f"{bounds['O'][1]}); rotary + "
        f"scaled_dot_product_attention with the band as a mask: forward "
        f"{ms['H_library']:.4g} ms, backward {ms['O_library']:.4g} ms (max "
        f"|o - H| {lib_err:.3g}, |dqkv - O| {lib_gerr:.3g})")
    return res


# phase 12: the basecaller CLI on pod5 directories the port writes from the
# seed; reads of 20k to 400k samples as int16 with a calibration, pA =
# scale * (adc + offset) about the configs' pa standardisation (90, 23)
CLI_HAC_READS, CLI_FAST_READS, CLI_REF_READS = 64, 256, 16
CLI_LENGTHS = (20000, 400000)
CLI_SCALE, CLI_OFFSET = 0.2, -12.0
CLI_PROCS = 4
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_NT16 = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_B_TYPES = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2", "i": "<i4",
            "I": "<u4", "f": "<f4"}


def write_cli_reads(pod5, directory, n, seed, compress, sample_rate=5000):
    """``n`` reads from ``seed`` in two pod5 files of the port's writer, at
    ``sample_rate``; their samples."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*CLI_LENGTHS, n)
    records = []
    for i, length in enumerate(lengths):
        pa = 90 + 23 * rng.standard_normal(int(length), dtype=np.float32)
        records.append({
            "read_id": str(uuid.UUID(int=(seed << 32) + i)),
            "signal": np.rint(pa / CLI_SCALE - CLI_OFFSET).astype(np.int16),
            "calibration_scale": CLI_SCALE, "calibration_offset": CLI_OFFSET,
            "channel": 1 + i % 512, "well": 1 + i % 4, "read_number": i,
            "start": 4000 * i})
    if directory.exists():
        shutil.rmtree(directory)
    directory.mkdir(parents=True)
    run_info = {"sample_rate": sample_rate}
    pod5.write_pod5(directory / "a.pod5", records[:n // 2], compress=compress,
                    run_info=run_info)
    pod5.write_pod5(directory / "b.pod5", records[n // 2:], compress=compress,
                    run_info=run_info)
    return int(lengths.sum())


def run_cli(cli_main, argv, out):
    """``python -m bonito_tpu_torch`` (``cli_main(argv)``) in this process
    with fd 1 on ``out``, whose name gives the format, and its stderr
    captured (then echoed); its wall time and stderr. Nothing else may
    print while fd 1 is the file."""
    sys.stdout.flush()
    saved = os.dup(1)
    stdout, stderr = sys.stdout, sys.stderr
    handler = signal.getsignal(signal.SIGINT)  # the CLI installs its own
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with open(out, "wb") as f:
            os.dup2(f.fileno(), 1)
            sys.stdout = io.TextIOWrapper(io.BufferedWriter(
                io.FileIO(1, "w", closefd=False)))
            sys.stderr = err
            cli_main(argv)
            sys.stdout.flush()
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        sys.stdout, sys.stderr = stdout, stderr
        signal.signal(signal.SIGINT, handler)
        sys.stderr.write(err.getvalue())
    return time.perf_counter() - t0, err.getvalue()


def bam_records(data):
    """The records of a BAM file's bytes, parsed with gzip and struct:
    name, flag, sequence, qualities (phred+33) and tags."""
    require(data.endswith(BGZF_EOF), "the BAM does not end in BGZF's EOF")
    raw = gzip.decompress(data)
    require(raw[:4] == b"BAM\x01", "no BAM magic")
    (l_text,) = struct.unpack_from("<i", raw, 4)
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    for _ in range(n_ref):
        pos += 8 + struct.unpack_from("<i", raw, pos)[0]
    records = []
    while pos < len(raw):
        (size,) = struct.unpack_from("<i", raw, pos)
        rec = raw[pos + 4:pos + 4 + size]
        pos += 4 + size
        _, _, l_name, _, _, n_cigar, flag, l_seq = struct.unpack_from(
            "<iiBBHHHi", rec)
        o = 32
        name = rec[o:o + l_name - 1].decode()
        o += l_name + 4 * n_cigar
        packed = np.frombuffer(rec, np.uint8, (l_seq + 1) // 2, o)
        o += (l_seq + 1) // 2
        codes = np.stack([packed >> 4, packed & 15], 1).ravel()[:l_seq]
        qual = (np.frombuffer(rec, np.uint8, l_seq, o) + 33).tobytes()
        o += l_seq
        tags = {}
        while o < len(rec):
            tag, typ = rec[o:o + 2].decode(), chr(rec[o + 2])
            o += 3
            if typ == "Z":
                end = rec.index(b"\0", o)
                tags[tag] = rec[o:end].decode()
                o = end + 1
            elif typ == "A":
                tags[tag] = chr(rec[o])
                o += 1
            elif typ == "B":
                dt = np.dtype(_B_TYPES[chr(rec[o])])
                (n,) = struct.unpack_from("<i", rec, o + 1)
                tags[tag] = np.frombuffer(rec, dt, n, o + 5)
                o += 5 + n * dt.itemsize
            else:
                dt = np.dtype(_B_TYPES[typ])
                tags[tag] = np.frombuffer(rec, dt, 1, o)[0].item()
                o += dt.itemsize
        records.append({"name": name, "flag": flag,
                        "seq": _NT16[codes].tobytes().decode(),
                        "qual": qual.decode(), "tags": tags})
    return records


def fastq_records(text):
    """{read id: (sequence, qualities, tags)} of a fastq's text; the tags
    are the header's comment (RG, qs, ns, ts, ...)."""
    lines = text.splitlines()
    require(len(lines) % 4 == 0, "a fastq whose lines are no records")
    out = {}
    for i in range(0, len(lines), 4):
        rid, *tags = lines[i][1:].split()
        tags = {t[:2]: int(t[5:]) if t[3] == "i" else t[5:] for t in tags}
        out[rid] = (lines[i + 1], lines[i + 3], tags)
    return out


def cli_batches(chunk, tags, bc):
    """The batches the CLI ran: its reads' trimmed signal (the records' ns
    - ts) in chunks of the model's geometry, packed into batches."""
    n_chunks = sum(chunk(np.empty(t["ns"] - t["ts"], np.float32),
                         bc["chunksize"], bc["overlap"]).shape[0]
                   for t in tags)
    return -(-n_chunks // bc["batchsize"])


def reference_calls(torch, load_model, basecall, pod5, model_dir, reads_dir,
                    read_ids=None, **kw):
    """``basecall`` (with the options ``kw``) in this process on the model
    the CLI loads and on the Reads the port's pod5 reader yields (in this
    process), as the CLI reads them: {read_id: result}, and the model's
    geometry."""
    model = load_model(model_dir, half=True, fuse_bn=True, quantize=None,
                       device="cuda")
    model.requires_grad_(False)
    scaling = model.config.get("scaling")
    norm = (model.config.get("standardisation")
            if (scaling or {}).get("strategy") == "pa"
            else model.config.get("normalisation"))
    bc = model.config["basecaller"]
    reads = pod5.get_reads(reads_dir, read_ids=read_ids, n_proc=1,
                           scaling_strategy=scaling, norm_params=norm)
    out = {r.read_id: res for r, res in basecall(
        model, reads, chunksize=bc["chunksize"], overlap=bc["overlap"],
        batchsize=bc["batchsize"], **kw)}
    del model
    torch.cuda.empty_cache()
    return out, bc


def cli_phase(torch, counters, dirs, steps, card):
    """Phase 12: ``python -m bonito_tpu_torch basecaller`` on the card, hac
    as shipped to BAM (and with ``--reference`` to SAM) and fast as shipped
    to fastq, from pod5 directories written here; launch counts, records
    against in-process ``basecall`` on the same Reads, mappings, rates."""
    from bonito_tpu_torch import pipeline, pod5, profiling
    from bonito_tpu_torch.cli import main as cli_main
    from bonito_tpu_torch.crf.basecall import basecall
    from bonito_tpu_torch.util import chunk, load_model, revcomp

    log("[12] the basecaller CLI on the card, from pod5 files")
    try:
        pod5.libzstd()
        zstd = True
    except pod5.LibraryMissing:
        zstd = False
    log(f"  libzstd: {'found' if zstd else 'not found'} "
        f"(ctypes.util.find_library('zstd'))")
    if not zstd:
        log("  no libzstd: the pod5 files hold uncompressed signal (the "
            "layout of write_pod5(compress=False)); the CLI reads them as "
            "they are")
    root = Path(dirs["int8"]).parent / "chip_smoke_cli"
    t0 = time.perf_counter()
    samples = {"hac": write_cli_reads(pod5, root / "hac_reads",
                                      CLI_HAC_READS, SEED, zstd),
               "fast": write_cli_reads(pod5, root / "fast_reads",
                                       CLI_FAST_READS, SEED + 1, zstd)}
    log(f"  wrote {CLI_HAC_READS} hac reads ({samples['hac']} samples) and "
        f"{CLI_FAST_READS} fast reads ({samples['fast']} samples) in "
        f"{time.perf_counter() - t0:.1f} s, two files each, "
        f"{'VBZ' if zstd else 'uncompressed'}")
    t0 = time.perf_counter()
    list(pipeline.process_map(abs, ((i, -i) for i in range(CLI_PROCS)),
                              n_proc=CLI_PROCS))
    startup = time.perf_counter() - t0
    log(f"  {CLI_PROCS} reader processes (spawned) start and answer in "
        f"{startup:.2f} s")

    results = {}
    for name, model_dir, ext, n_reads in (
            ("hac", dirs["int8"], "bam", CLI_HAC_READS),
            ("fast", dirs["fast"], "fastq", CLI_FAST_READS)):
        reads_dir = root / f"{name}_reads"
        out = root / f"{name}_out" / f"out.{ext}"
        if out.parent.exists():
            shutil.rmtree(out.parent)
        out.parent.mkdir()
        ids = sorted(pod5.Pod5File(reads_dir / "a.pod5").read_ids()
                     + pod5.Pod5File(reads_dir / "b.pod5").read_ids())
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        profiling.report(reset=True)
        os.environ["BONITO_TPU_PROFILE"] = "1"
        try:
            wall, err = run_cli(cli_main, [
                "basecaller", str(model_dir), str(reads_dir), "--n-proc",
                str(CLI_PROCS), "--output-dir", str(out.parent)], out)
        finally:
            del os.environ["BONITO_TPU_PROFILE"]
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        stages = profiling.report(reset=True)
        rate = re.search(r"samples per second (\S+)", err)
        duration = re.search(r"duration: (\S+)", err)
        require(rate and "completed reads: %d" % n_reads in err,
                f"{name}: the CLI did not report {n_reads} completed reads")
        summary = (out.parent / "out_summary.tsv").read_text().splitlines()
        require(len(summary) == n_reads + 1,
                f"{name}: the summary has {len(summary) - 1} rows, not "
                f"{n_reads}")
        results[name] = {"out": out, "ids": ids, "wall": wall,
                         "rate": float(rate.group(1)),
                         "duration": duration.group(1),
                         "launches": launches, "stages": stages,
                         "reads_dir": reads_dir}

    # hac: one BAM record per read, its tags, the launches, the calls
    hac = results["hac"]
    records = bam_records(hac["out"].read_bytes())
    require(sorted(r["name"] for r in records) == hac["ids"],
            "hac: the BAM's records are not the pod5 files' reads")
    for r in records:
        missing = {"RG", "qs", "ns", "ts", "ch", "rn", "mv"} - r["tags"].keys()
        require(not missing, f"hac: {r['name']} lacks the tags {missing}")
    ref, hac["bc"] = reference_calls(torch, load_model, basecall, pod5,
                                     dirs["int8"], hac["reads_dir"])
    batches = cli_batches(chunk, [r["tags"] for r in records], hac["bc"])
    want = {k: 0 for k in counters}
    want.update({"D": 5 * batches, "B": batches, "C": batches})
    require(hac["launches"] == want,
            f"hac CLI: launches {hac['launches']}, expected {want}")
    for r in records:
        res = ref[r["name"]]
        mv = r["tags"]["mv"]
        require(r["seq"] == res["sequence"] and r["qual"] == res["qstring"]
                and mv[0] == res["stride"]
                and np.array_equal(mv[1:], res["moves"]),
                f"hac: {r['name']}'s record differs from basecall's call")
    hac["batches"] = batches
    log(f"  hac CLI: {len(records)} BAM records, each the in-process "
        f"basecall's call (sequence, qstring and mv), with RG, qs, ns, ts, "
        f"ch, rn; {batches} batches, launches {hac['launches']}")

    # --reference: 16 of the reads to SAM, a FASTA of their calls with
    # every other one reverse complemented, and the same 16 again with
    # --reference: each on its own contig and strand with NM 0, and each
    # record the mapping the port's Aligner gives its call here. (The 16
    # reads' calls are taken from a run of the 16 alone: the int8 chain
    # quantises layer 0 over the whole batch, so a read's call depends on
    # the other reads in its batches, and among the 64 it calls a little
    # otherwise.)
    from bonito_tpu_torch.aligner import Aligner
    from bonito_tpu_torch.io import sam_record
    chosen = sorted(r["name"] for r in records)[:CLI_REF_READS]
    (root / "ref_ids.txt").write_text("\n".join(chosen) + "\n")

    def sam_run(tag, *more):
        out = root / f"{tag}_out" / "out.sam"
        if out.parent.exists():
            shutil.rmtree(out.parent)
        out.parent.mkdir()
        wall, _ = run_cli(cli_main, [
            "basecaller", str(dirs["int8"]), str(hac["reads_dir"]),
            "--n-proc", str(CLI_PROCS), "--read-ids",
            str(root / "ref_ids.txt"), "--output-dir", str(out.parent),
            *more], out)
        text = out.read_text().splitlines()
        return wall, [line for line in text if line.startswith("@SQ")], [
            line.split("\t") for line in text if not line.startswith("@")]

    _, _, sam16 = sam_run("calls16")
    require(sorted(f[0] for f in sam16) == chosen,
            "--read-ids: the SAM's records are not the chosen reads")
    fasta = root / "calls.fasta"
    with open(fasta, "w") as f:
        for i, r in enumerate(sam16):
            f.write(f">ctg{i}\n{revcomp(r[9]) if i % 2 else r[9]}\n")
    contig = {r[0]: i for i, r in enumerate(sam16)}
    wall_ref, sq, sam = sam_run("ref", "--reference", str(fasta))
    require(len(sq) == len(sam16)
            and sorted(f[0] for f in sam) == chosen,
            "--reference: not one @SQ per contig or not the chosen reads")
    aligner = Aligner(str(fasta))
    for f in sam:
        i = contig[f[0]]
        tags = dict(t.split(":", 1) for t in f[11:])
        require(f[2] == f"ctg{i}" and int(f[1]) & 16 == (16 if i % 2 else 0)
                and tags.get("NM") == "i:0",
                f"--reference: {f[0]} mapped to {f[2]} (flag {f[1]}, NM "
                f"{tags.get('NM')}), not to ctg{i} on the "
                f"{'-' if i % 2 else '+'} strand with NM 0")
        reverse = int(f[1]) & 16
        seq = revcomp(f[9]) if reverse else f[9]
        qual = f[10][::-1] if reverse else f[10]
        want = sam_record(f[0], seq, qual,
                          mapping=aligner.map(seq)).split("\t")
        require(f[1:11] == want[1:11] and [t for t in f[11:] if t[:2] in (
            "NM", "MD")] == want[11:],
                f"--reference: {f[0]}'s record is not the Aligner's mapping "
                f"{want[1:6]}")
    log(f"  hac CLI --reference: {len(sam)} reads to SAM in {wall_ref:.1f} s "
        f"against {len(sq)} contigs of their calls (every other one reverse "
        f"complemented): each on its own contig and strand with NM 0, each "
        f"record the Aligner's mapping of its call")

    # fast: one fastq record per read, the launches, one file's calls
    fast = results["fast"]
    fq = fastq_records(fast["out"].read_text())
    require(sorted(fq) == fast["ids"],
            "fast: the fastq's records are not the pod5 files' reads")
    first = set(pod5.Pod5File(fast["reads_dir"] / "a.pod5").read_ids())
    ref, fast["bc"] = reference_calls(torch, load_model, basecall, pod5,
                                      dirs["fast"], fast["reads_dir"],
                                      read_ids=first)
    batches = cli_batches(chunk, [t for _, _, t in fq.values()], fast["bc"])
    want = {k: 0 for k in counters}
    want.update({"F": 5 * batches, "G": batches, "J": batches})
    require(fast["launches"] == want,
            f"fast CLI: launches {fast['launches']}, expected {want}")
    require(ref.keys() == first, "fast: basecall missed a read")
    for rid in first:
        require(fq[rid][:2] == (ref[rid]["sequence"], ref[rid]["qstring"]),
                f"fast: {rid}'s record differs from basecall's call")
    fast["batches"] = batches
    log(f"  fast CLI: {len(fq)} fastq records, the first file's "
        f"{len(first)} each the in-process basecall's call; {batches} "
        f"batches, launches {fast['launches']}")

    for name, step in (("hac", steps["hac"]), ("fast", steps["fast"])):
        r = results[name]
        step_rate = r["bc"]["batchsize"] * r["bc"]["chunksize"] / step * 1e3
        log(f"  {name} CLI on {card}: '> samples per second {r['rate']:.1E}' "
            f"(synthetic pod5 reads: {len(r['ids'])} reads, "
            f"{samples[name]} samples; the CLI's duration {r['duration']}), "
            f"{samples[name] / r['wall']:.6g} samples/s over the command's "
            f"{r['wall']:.2f} s wall (model load and reader start-up in it); "
            f"phase 7's device step {step:.4g} ms a batch = "
            f"{step_rate:.6g} samples/s; {r['batches']} batches")
        for line in r["stages"]:
            log(f"    {line}")
    return {name: {k: r[k] for k in ("wall", "rate", "launches", "batches",
                                     "reads_dir")}
            | {"samples": samples[name], "reads": len(r["ids"]),
               "stages": r["stages"]} for name, r in results.items()} | {
        "reader_startup_s": startup, "libzstd": zstd}



# phase 13: the conv-CTC family at full width, dna_r9.4.1_e8_fast@v2 as
# shipped (8 blocks of 344 to 48 filters, kernels 9 to 123, stride 3),
# random weights from the seed with BatchNorm statistics of a random batch
# of CTC_CALIBRATION chunks (with statistics of (0, 1) each block of a
# random model halves its activations and the calls hardly depend on the
# signal); batch 512 x 3999 (the config's 4000 at the stride)
CTC = "dna_r9.4.1_e8_fast@v2"
CTC_CALIBRATION = 16
CTC_TURNS, CTC_REPS = 3, 5
CTC_CLI_READS = 64
CTC_SAMPLE_RATE = 4000
# the train step at full width: the train CLI's default batch of 64
# chunks, targets of 300 to 400 bases; the card's loss route (F.ctc_loss,
# in f64) against the plain recursion run in f64 on one batch: the loss
# within CTC_LOSS_RTOL relative, the gradient to the log-probs within
# CTC_GRAD_RTOL relative L2 (F.ctc_loss in f32 and the plain recursion in
# f32 are printed beside it: F.ctc_loss's f32 gradient drifted 1.4e-3
# from the f64 recursion's over 1333 frames, the f32 recursion's 3.3e-5)
CTC_TRAIN_BATCH, CTC_TARGETS, CTC_TRAIN_STEPS = 64, (300, 400), 3
CTC_LOSS_RTOL, CTC_GRAD_RTOL = 1e-4, 1e-3
# one f32 batch (CTC_F32_ROWS chunks) on the card against the CPU: with
# TF32 off, cuDNN's and the CPU's f32 sums in other orders (max |d log-p|
# within CTC_F32_TOL); with TF32 on (torch's default for cuDNN) within
# CTC_TF32_TOL, a sanity bound: TF32 keeps 10 bits of each product's
# operands
CTC_F32_ROWS, CTC_F32_TOL, CTC_TF32_TOL = 4, 1e-3, 0.25
CTC_EVAL_CHUNKS, CTC_EVAL_BATCH = 64, 32


def ctc_flops_per_frame(model, TCSConv):
    """Multiply-adds x 2 of the conv-CTC model per output frame: a plain
    conv 2 I O K, a separable one 2 I K + 2 I O, the decoder 2 I O."""
    flops = 0
    for m in model.modules():
        if isinstance(m, TCSConv):
            flops += (2 * m.insize * m.winlen + 2 * m.insize * m.size
                      if m.separable else 2 * m.insize * m.size * m.winlen)
    dec = next(model.decoder.children())
    return flops + 2 * dec.insize * dec.size


def calibrate_ctc(torch, nn, model, x):
    """Every BatchNorm's statistics set to those of the batch ``x`` (one
    forward in train mode with the update's momentum 1)."""
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm)]
    for bn in norms:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for bn in norms:
        bn.apply_pending()
        bn.momentum = 0.1


def profile_step(torch, fn):
    """Device time by kernel of one call of ``fn`` under torch.profiler:
    [(name, ms, count)], the most first; [] where the profiler records no
    device time."""
    try:
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t:
                rows.append((e.key, t / 1e3, e.count))
        return sorted(rows, key=lambda r: -r[1])
    except Exception as e:  # noqa: BLE001 - reported, the phase goes on
        log(f"    torch.profiler gave no device times: {e!r}")
        return []


def zero_launches(counters, name, launches):
    require(not any(launches.values()),
            f"{name}: hand kernels launched on the conv-CTC path: "
            f"{({k: v for k, v in launches.items() if v})}")


def ctc_phase(torch, counters, dev, dirs, card):
    """Phase 13: the conv-CTC family at full width on the card: the device
    step and the host decode, the cuDNN pieces, the basecaller CLI from
    pod5 to fastq, BAM and SAM against in-process ``basecall``, a train
    step and F.ctc_loss against the plain loss, one train CLI epoch,
    ``evaluate``, f32 on the card against the CPU, ``view``. Every hand kernel's count is 0 on each path."""
    import contextlib
    from functools import partial

    import torch.nn.functional as F

    from bonito_tpu_torch import checkpoint, nn, pod5, profiling, training
    from bonito_tpu_torch.cli import main as cli_main
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.ctc import basecall as ctc_basecall
    from bonito_tpu_torch.ctc import model as ctc_model
    from bonito_tpu_torch.models import MODELS
    from bonito_tpu_torch.pipeline import thread_map
    from bonito_tpu_torch.util import chunk, load_model

    log(f"[13] the conv-CTC family ({CTC}) at full width on the card")
    root = Path(dirs["int8"]).parent / "chip_smoke_ctc"
    if root.exists():
        shutil.rmtree(root)
    model_dir = root / "model"
    model_dir.mkdir(parents=True)
    cfg = MODELS[CTC]()
    rng = np.random.default_rng(SEED)
    master = ctc_model.Model(cfg).init(SEED).to(dev)
    calibrate_ctc(torch, nn, master, torch.from_numpy(rng.normal(
        size=(CTC_CALIBRATION, 3999, 1)).astype(np.float32)).to(dev))
    save_config(cfg, model_dir / "config.toml")
    checkpoint.save_params(model_dir / "weights_1.npz", master)
    del master
    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {k: c.launches for k, c in counters.items()}
        zero_launches(counters, name, launches[name])
        return out

    # (a) the device step, as the basecaller loads the model
    model = load_model(model_dir, half=True, fuse_bn=True, quantize=None,
                       device="cuda")
    model.requires_grad_(False)
    bc = model.config["basecaller"]
    N, L = bc["batchsize"], bc["chunksize"]
    require((N, L, bc["overlap"], model.stride) == (512, 3999, 498, 3),
            f"unexpected geometry {bc}, stride {model.stride}")
    kinds = sorted({(b.conv0.winlen, b.conv0.separable, b.residual)
                    for b in model.encoder.children()})
    batch = rng.normal(size=(N, L)).astype(np.float32)
    compute = ctc_basecall.make_compute_fn(model, N)
    devices, hooks = set(), []

    def on_device(module, inputs, output):
        for t in (*inputs, output):
            if isinstance(t, torch.Tensor):
                devices.add(t.device.type)
    for m in model.modules():
        hooks.append(m.register_forward_hook(on_device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = counted("ctc_device_step",
                  lambda: compute.fetch(compute.dispatch(batch)))
    for h in hooks:
        h.remove()
    params = {t.device.type for t in (*model.parameters(), *model.buffers())}
    require(devices == params == {"cuda"},
            f"the device stage's tensors lie on {devices | params}")
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    T = out.shape[1]
    require(out.shape == (N, (L + 2) // 3, 5) and np.isfinite(out).all(),
            f"log-probs {out.shape}, finite {np.isfinite(out).all()}")
    turns = []
    for _ in range(CTC_TURNS):
        turns.append(cuda_ms(lambda: compute.fetch(compute.dispatch(batch)),
                             reps=CTC_REPS))
    step = min(turns)
    flops = ctc_flops_per_frame(model, ctc_model.TCSConv) * N * T
    t_ops, _ = bound(0, flops, H100_BF16_OPS)
    log(f"  device step ({N} x {L} -> {T} frames, bf16, BatchNorm kept "
        f"f32 statistics, log-probs in bf16 to the host) on {card}: "
        f"{', '.join(f'{t:.4g}' for t in turns)} ms in {CTC_TURNS} turns of "
        f"{CTC_REPS} (spread {max(turns) - min(turns):.3g} ms) = "
        f"{N * L / step * 1e3:.6g} samples/s at the best; peak memory "
        f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held; "
        f"{flops / 1e12:.4g} TFLOP a batch ({flops / N / T / 1e6:.4g} MFLOP "
        f"a frame): {t_ops:.4g} ms at the bf16 peak; block kinds (kernel, "
        f"separable, residual) {kinds}; every module's tensors on cuda")

    # (b) the host decode of one batch on the decode threads
    items = [(i, {"scores": out[i]}) for i in range(N)]
    fn = partial(ctc_model.decode_scores, alphabet=model.alphabet,
                 qscale=model.qscale, qbias=model.qbias)
    host = {}
    for name, kw in (("greedy", {"qscores": True}), ("beam", {})):
        decoder = partial(ctc_basecall.decode, decode_fn=fn, stride=3, **kw)
        t0 = time.perf_counter()
        calls = [r for _, r in thread_map(decoder, iter(items), n_thread=4)]
        host[name] = (time.perf_counter() - t0) * 1e3
        bases = sum(len(c["sequence"]) for c in calls)
        require(bases > 0.1 * N * T and set("".join(
            c["sequence"] for c in calls)) == set("ACGT"),
                f"{name} decode: {bases} bases in {N * T} frames")
        log(f"  host {name} decode of one batch on 4 threads: "
            f"{host[name]:.1f} ms ({bases} bases from {N * T} frames, "
            f"{N * L / host[name] * 1e3:.4g} samples/s)")

    # (c) where the device step's time goes: each block, the decoder, and
    # the cuDNN pieces (not TPU kernels; plain torch)
    x = torch.from_numpy(batch).to(dev, torch.bfloat16)[..., None]
    block_ms = []
    with torch.inference_mode():
        h = x
        for b in model.encoder.children():
            block_ms.append(cuda_ms(lambda b=b, h=h: b(h), reps=3))
            h = b(h)
        dec_ms = cuda_ms(lambda: F.log_softmax(model.decoder(h).float(), -1),
                         reps=3)
        pieces = {}
        for name, (c, k) in (("depthwise k115", (344, 115)),
                             ("depthwise k123", (464, 123)),
                             ("depthwise k67", (280, 67))):
            a = torch.randn(N, c, T, device=dev, dtype=torch.bfloat16)
            w = torch.randn(c, 1, k, device=dev, dtype=torch.bfloat16)
            pieces[name] = cuda_ms(
                lambda a=a, w=w, k=k, c=c: F.conv1d(a, w, padding=k // 2,
                                                     groups=c), reps=3)
        a = torch.randn(N, 464, T, device=dev, dtype=torch.bfloat16)
        w = torch.randn(456, 464, 1, device=dev, dtype=torch.bfloat16)
        pieces["pointwise 464->456"] = cuda_ms(lambda: F.conv1d(a, w), reps=3)
        bn = nn.BatchNorm(464, eps=1e-3).to(dev)
        v = a.transpose(1, 2)
        pieces["BatchNorm pass (464 ch)"] = cuda_ms(lambda: bn(v), reps=3)
        pieces["swish pass (464 ch)"] = cuda_ms(lambda: F.silu(v), reps=3)
        pieces["residual add (464 ch)"] = cuda_ms(lambda: v + v, reps=3)
        act_bytes = N * 464 * T * 2
    kernels_ms = profile_step(torch, lambda: compute.fetch(
        compute.dispatch(batch)))
    log(f"  blocks: {', '.join(f'{t:.4g}' for t in block_ms)} ms (sum "
        f"{sum(block_ms):.4g}); decoder + log-softmax {dec_ms:.4g} ms")
    for name, t in pieces.items():
        log(f"    {name} at [{N}, *, {T}] bf16: {t:.4g} ms")
    log(f"    one bf16 activation of 464 channels is {act_bytes / 1e9:.4g} "
        f"GB: a pass reading and writing it {2 * act_bytes / H100_BYTES * 1e3:.4g}"
        f" ms at {H100_BYTES / 1e12:.3g} TB/s")
    if kernels_ms:
        total = sum(t for _, t, _ in kernels_ms)
        log(f"    torch.profiler over one device step: {total:.4g} ms of "
            f"device time in {len(kernels_ms)} kinds of kernel; the most:")
        for name, t, n in kernels_ms[:12]:
            log(f"      {t:8.3f} ms {n:5d} x {name[:100]}")
    del x, h, a, w, v, bn
    torch.cuda.empty_cache()

    # (d) the basecaller CLI from pod5: fastq (greedy with qualities), BAM
    # and SAM (the beam: qstring '*', no moves)
    try:
        pod5.libzstd()
        zstd = True
    except pod5.LibraryMissing:
        zstd = False
    reads_dir = root / "reads"
    samples = write_cli_reads(pod5, reads_dir, CTC_CLI_READS, SEED + 2, zstd,
                              sample_rate=CTC_SAMPLE_RATE)
    ids = sorted(pod5.Pod5File(reads_dir / "a.pod5").read_ids()
                 + pod5.Pod5File(reads_dir / "b.pod5").read_ids())
    del model, compute
    torch.cuda.empty_cache()
    cli = {}
    for ext in ("fastq", "bam", "sam"):
        out_path = root / f"cli_{ext}" / f"out.{ext}"
        out_path.parent.mkdir()
        profiling.report(reset=True)
        os.environ["BONITO_TPU_PROFILE"] = "1"
        try:
            wall, err = counted(f"ctc_cli_{ext}", lambda: run_cli(
                cli_main, ["basecaller", str(model_dir), str(reads_dir),
                           "--n-proc", str(CLI_PROCS), "--output-dir",
                           str(out_path.parent)], out_path))
        finally:
            del os.environ["BONITO_TPU_PROFILE"]
        rate = re.search(r"samples per second (\S+)", err)
        require(rate and f"completed reads: {CTC_CLI_READS}" in err,
                f"conv-CTC CLI to {ext}: no rate or not {CTC_CLI_READS} "
                f"reads")
        cli[ext] = {"wall": wall, "rate": float(rate.group(1)),
                    "stages": profiling.report(reset=True), "out": out_path}
    for qscores in (True, False):
        ref, _ = reference_calls(torch, load_model, ctc_basecall.basecall,
                                 pod5, model_dir, reads_dir, qscores=qscores)
        require(sorted(ref) == ids, "basecall missed a read")
        if qscores:
            fq = fastq_records(cli["fastq"]["out"].read_text())
            require(sorted(fq) == ids, "fastq: not the pod5 files' reads")
            for rid, (seq, qual, _) in fq.items():
                require((seq, qual) == (ref[rid]["sequence"],
                                        ref[rid]["qstring"]),
                        f"fastq: {rid}'s record differs from basecall's")
            continue
        records = bam_records(cli["bam"]["out"].read_bytes())
        require(sorted(r["name"] for r in records) == ids,
                "BAM: not the pod5 files' reads")
        for r in records:
            require(r["seq"] == ref[r["name"]]["sequence"]
                    and "mv" not in r["tags"]
                    and ref[r["name"]]["qstring"] == "*",
                    f"BAM: {r['name']}'s record differs from basecall's")
        rows = [line.split("\t") for line in cli["sam"]["out"].read_text()
                .splitlines() if not line.startswith("@")]
        require(sorted(f[0] for f in rows) == ids,
                "SAM: not the pod5 files' reads")
        for f in rows:
            require(f[9] == ref[f[0]]["sequence"] and f[10] == "*",
                    f"SAM: {f[0]}'s record differs from basecall's")
    for ext, r in cli.items():
        log(f"  CLI to {ext} on {card}: '> samples per second "
            f"{r['rate']:.1E}' ({CTC_CLI_READS} synthetic pod5 reads at "
            f"{CTC_SAMPLE_RATE} Hz, {samples} samples), {samples / r['wall']:.6g}"
            f" samples/s over the command's {r['wall']:.2f} s wall; every "
            f"record the in-process basecall's; no hand kernel launched")
        for line in r["stages"]:
            log(f"    {line}")

    # (e) one train step at full width: bf16 amp on f32 master weights,
    # AdamW and the clip, as the trainer runs them
    model = ctc_model.Model(cfg).init(SEED).to(dev)
    opt = training.make_optimizer(model, 2e-3)
    step_fn = training.make_train_step(model, opt, use_amp=True)
    lengths = rng.integers(CTC_TARGETS[0], CTC_TARGETS[1] + 1,
                           CTC_TRAIN_BATCH)
    targets = rng.integers(1, 5, (CTC_TRAIN_BATCH, CTC_TARGETS[1]))
    targets[np.arange(CTC_TARGETS[1])[None] >= lengths[:, None]] = 0
    tb = (torch.from_numpy(rng.normal(size=(CTC_TRAIN_BATCH, L, 1)).astype(
        np.float32)).to(dev), torch.from_numpy(targets).to(dev),
          torch.from_numpy(lengths).to(dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_t = torch.cuda.memory_allocated()
    losses0, _ = step_fn(tb, 1.0, 2.0)

    def train_steps():
        t0 = time.perf_counter()
        for _ in range(CTC_TRAIN_STEPS):
            losses, norm = step_fn(tb, 1.0, 2.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / CTC_TRAIN_STEPS * 1e3, losses
    train_ms, losses = counted("ctc_train_step", train_steps)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(math.isfinite(float(v)) for v in losses.values()),
            f"train step losses {losses}")
    log(f"  train step ({CTC_TRAIN_BATCH} x {L}, targets of "
        f"{CTC_TARGETS[0]} to {CTC_TARGETS[1]} bases; bf16 amp, f32 master "
        f"weights, AdamW, clip 2) on {card}: {train_ms:.4g} ms (mean of "
        f"{CTC_TRAIN_STEPS} after a warm-up) = "
        f"{CTC_TRAIN_BATCH * L / train_ms * 1e3:.6g} train samples/s; peak "
        f"memory {train_peak:.3f} GiB ({(train_peak - held_t / 2 ** 30):.3f} "
        f"above the held); loss {float(losses0['loss']):.4g} -> "
        f"{float(losses['loss']):.4g}")
    # F.ctc_loss against the plain recursion on one batch's log-probs
    model.train()
    with torch.no_grad():
        lp = model(tb[0].to(torch.bfloat16))
    model.eval()
    require(bool(ctc_model.alignable(tb[1], tb[2], lp.shape[1]).all()),
            "the train batch has a row that cannot align")
    grads, vals, ms, rows = {}, {}, {}, {}
    nll = ctc_model.ctc_nll
    def ctc_loss_f32(log_probs, targets, lengths):
        return F.ctc_loss(log_probs.transpose(0, 1), targets, torch.full(
            (log_probs.shape[0],), log_probs.shape[1], device=dev), lengths,
            reduction="none")
    for route, dtype, fn in (
            ("ctc_loss", torch.float32, nll),
            ("ctc_loss_f32", torch.float32, ctc_loss_f32),
            ("plain", torch.float32, ctc_model.ctc_nll_plain),
            ("plain_f64", torch.float64, ctc_model.ctc_nll_plain)):
        leaf = lp.detach().to(dtype).clone().requires_grad_(True)
        ctc_model.ctc_nll = fn
        try:
            def fwd_bwd(leaf=leaf):
                out = model.loss(leaf, tb[1], tb[2])
                out["total_loss"].backward()
                return {k: float(v.detach()) for k, v in out.items()}
            vals[route], ms[route] = timed(torch, fwd_bwd)
            with torch.no_grad():
                rows[route] = ctc_model.ctc_nll(leaf.detach(), tb[1],
                                                tb[2]).double()
        finally:
            ctc_model.ctc_nll = nll
        grads[route] = leaf.grad.double()

    def against(a, b):
        return ({k: abs(vals[a][k] / vals[b][k] - 1)
                 for k in ("total_loss", "loss")},
                float(((rows[a] - rows[b]).abs() / rows[b].abs()).max()),
                float((grads[a] - grads[b]).norm() / grads[b].norm()))
    lib, lib_rows, g_lib = against("ctc_loss", "plain_f64")
    lib32, lib32_rows, g_lib32 = against("ctc_loss_f32", "plain_f64")
    f32, f32_rows, g_f32 = against("plain", "plain_f64")
    log(f"  loss through F.ctc_loss (in f64, the card's route) against the "
        f"plain recursion (optax's) in f64 on one batch (loss "
        f"{vals['plain_f64']['loss']:.8g}): relative differences {lib}, per "
        f"row at most {lib_rows:.3g}, the gradient to the log-probs "
        f"{g_lib:.3g} relative L2; F.ctc_loss in f32 (not the route): "
        f"{lib32}, per row {lib32_rows:.3g}, gradient {g_lib32:.3g}; the "
        f"plain recursion in f32: {f32}, per row {f32_rows:.3g}, gradient "
        f"{g_f32:.3g}; forward + backward: F.ctc_loss {ms['ctc_loss']:.4g} "
        f"ms (f32 {ms['ctc_loss_f32']:.4g}), plain f32 {ms['plain']:.4g} ms, "
        f"f64 {ms['plain_f64']:.4g} ms")
    require(max(lib.values()) <= CTC_LOSS_RTOL and g_lib <= CTC_GRAD_RTOL,
            f"F.ctc_loss against the plain loss in f64: {lib}, gradient "
            f"{g_lib}")
    del model, opt, step_fn, lp, grads, tb
    torch.cuda.empty_cache()
    epoch = train_cli(torch, counters, CTC, 16, L, CTC_TARGETS[1], 2, {}, {},
                      "ctc")
    launches["ctc_train_cli"] = epoch["launches"]
    zero_launches(counters, "ctc_train_cli", epoch["launches"])

    # (f) evaluate on the card, against decode_batch in this process
    data = root / "eval_data"
    rng_e = np.random.default_rng(SEED + 3)
    for sub in ("", "validation"):
        d = data / sub
        d.mkdir(parents=True, exist_ok=True)
        lens = rng_e.integers(150, 301, CTC_EVAL_CHUNKS)
        refs = rng_e.integers(1, 5, (CTC_EVAL_CHUNKS, 300))
        refs[np.arange(300)[None] >= lens[:, None]] = 0
        np.save(d / "chunks.npy", rng_e.normal(size=(CTC_EVAL_CHUNKS, L))
                .astype(np.float16))
        np.save(d / "references.npy", refs.astype(np.uint8))
        np.save(d / "reference_lengths.npy", lens.astype(np.uint16))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counted("ctc_evaluate", lambda: cli_main([
            "evaluate", str(model_dir), "--directory", str(data),
            "--chunks", str(CTC_EVAL_CHUNKS), "--batchsize",
            str(CTC_EVAL_BATCH), "--output-dir", str(root / "eval_out")]))
    report = buf.getvalue()
    model32 = load_model(model_dir, half=False, device="cuda")
    model32.requires_grad_(False)
    chunks = np.load(data / "validation" / "chunks.npy").astype(np.float32)
    want = []
    with torch.inference_mode():
        for i in range(0, CTC_EVAL_CHUNKS, CTC_EVAL_BATCH):
            xb = torch.from_numpy(chunks[i:i + CTC_EVAL_BATCH]).to(dev)
            want += model32.decode_batch(model32(xb[..., None]))
    seqs = (root / "eval_out" / "seqs.fasta").read_text().splitlines()[1::2]
    require(seqs == want, "evaluate's seqs.fasta is not decode_batch's")
    summary = [line for line in report.splitlines() if line.startswith("* ")]
    log(f"  evaluate on the card ({CTC_EVAL_CHUNKS} chunks of {L}, batch "
        f"{CTC_EVAL_BATCH}, f32): seqs.fasta equals decode_batch in this "
        f"process; cudnn.allow_tf32 {tf32[0]}, matmul.allow_tf32 {tf32[1]} "
        f"(the f32 convolutions run in TF32: {tf32[0]})")
    for line in summary:
        log(f"    {line}")

    # (g) f32 on the card against the CPU, with TF32 on and off
    x = np.random.default_rng(SEED + 4).normal(
        size=(CTC_F32_ROWS, L, 1)).astype(np.float32)
    cpu = load_model(model_dir, half=False, device="cpu")
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x)).numpy()
        diffs = {}
        for allow in (True, False):
            torch.backends.cudnn.allow_tf32 = allow
            try:
                got = model32(torch.from_numpy(x).to(dev)).cpu().numpy()
            finally:
                torch.backends.cudnn.allow_tf32 = tf32[0]
            diffs[allow] = (float(np.abs(got - ref).max()),
                            float((got.argmax(-1) == ref.argmax(-1)).mean()))
    log(f"  one f32 batch ({CTC_F32_ROWS} x {L}) on the card against the CPU:"
        f" TF32 on (torch's default) max |d log-p| {diffs[True][0]:.3g}, "
        f"argmax alike {diffs[True][1]:.4f}; TF32 off {diffs[False][0]:.3g}, "
        f"{diffs[False][1]:.4f}")
    require(diffs[False][0] <= CTC_F32_TOL and diffs[True][0] <= CTC_TF32_TOL,
            f"f32 card against CPU: {diffs}")
    del model32, cpu
    torch.cuda.empty_cache()

    # (h) view
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["view", CTC])
    count = int(buf.getvalue().splitlines()[-1].split(":")[1].replace(",", ""))
    want_count = sum(p.numel() for p in ctc_model.Model(cfg).parameters())
    require(count == want_count, f"view counts {count}, not {want_count}")
    log(f"  view {CTC}: total parameters {count:,} (BatchNorm statistics "
        f"not counted)")
    return {"launches": launches, "step_ms": turns, "samples_per_s":
            N * L / step * 1e3, "peak_gib": peak, "host_ms": host,
            "blocks_ms": block_ms, "pieces_ms": pieces,
            "profile": kernels_ms[:12],
            "cli": {k: {"rate": v["rate"], "wall": v["wall"]}
                    for k, v in cli.items()},
            "train_ms": train_ms, "train_peak_gib": train_peak,
            "loss_vs_f64": {"ctc_loss": (lib, g_lib),
                            "ctc_loss_f32": (lib32, g_lib32),
                            "plain_f32": (f32, g_f32)}, "loss_ms": ms,
            "tf32": tf32, "f32_vs_cpu": diffs, "view_count": count,
            "model_dir": model_dir}


# phase 14: upstream bonito's model directories, as it publishes them (a
# config.toml with bonito.* package names and weights_1.tar, a torch state
# dict under upstream's module names): hac, sup and conv-CTC at full width
# from phase 4's and 13's weights, written by `export --format torch`, each
# LSTM then given a nonzero bias_hh_l0 and every key a `module.` prefix, as
# upstream's trainer leaves them; beside each the same weights as a .npz
# directory (each LSTM's b the sum of its two biases). The old-style
# parametric [encoder] (upstream's r9.4.1 v3 schema) at rnn_encoder's
# defaults: 5 LSTM layers of 768, stride 5, S 1024; its chunk of 9996
# samples rounds to 9995 at the stride (1999 frames)
UPSTREAM_NAME = "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"  # a published name
# each family's device-step batch (batch x chunk) and its launches
UPSTREAM_STEPS = {"hac": ((96, 9996), {"D": 5, "B": 1, "C": 1}),
                  "sup": ((128, 12000), {"P": 1, "K": 18, "B": 1, "C": 1}),
                  "ctc": ((512, 3999), {})}
OLD_TURNS, OLD_REPS = 3, 3
OLD_N, OLD_CHUNK, OLD_H = 96, 9995, 768


def upstream_phase(torch, counters, dev, dirs, cli_reads, card):
    """Phase 14: upstream-form directories on the card: the .tar directory
    against the .npz directory of the same weights (one device-step batch of
    hac, sup and conv-CTC, bit for bit; the basecaller CLI on hac to BAM,
    record for record), the old-style model at full width at both quantize
    values (its step, A and D at H 768 against their plain versions),
    ``download`` from a ``file://`` zip and ``export --format dorado``."""
    import zipfile

    from bonito_tpu_torch import checkpoint, nn, profiling
    from bonito_tpu_torch.cli import download
    from bonito_tpu_torch.cli import main as cli_main
    from bonito_tpu_torch.cli.export import torch_state_dict
    from bonito_tpu_torch.config import load_config, save_config
    from bonito_tpu_torch.crf.basecall import make_compute_fn
    from bonito_tpu_torch.crf.model import Model
    from bonito_tpu_torch.ctc import basecall as ctc_basecall
    from bonito_tpu_torch.models import rnn_crf_config
    from bonito_tpu_torch.ops import decode as ops_decode
    from bonito_tpu_torch.ops import int8, lstm_cuda, lstm_int8_cuda
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.util import load_model, load_symbol

    log("[14] upstream bonito's model directories (config.toml with bonito.* "
        "packages, weights_1.tar) on the card")
    t_phase = time.perf_counter()
    root = Path(dirs["int8"]).parent / "chip_smoke_upstream"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 14)
    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        if name is not None:
            launches[name] = {k: c.launches for k, c in counters.items()}
        return out

    def require_launches(name, want):
        full = {k: 0 for k in counters} | want
        require(launches[name] == full,
                f"{name}: launches {launches[name]}, expected {full}")

    # (a) the directories, and each .tar's import on the host
    forms, import_s = {}, {}
    for name, src in (("hac", dirs["int8"]), ("sup", dirs["sup"]),
                      ("ctc", dirs["ctc"])):
        tar_dir, npz_dir = root / f"{name}_tar", root / f"{name}_npz"
        cli_main(["export", str(src), "--output", str(tar_dir), "--format",
                  "torch"])
        # upstream's published configs keep their [basecaller] section,
        # which export cleans away: the source's config (bonito.* package
        # names) goes in its place
        shutil.copy(Path(src) / "config.toml", tar_dir / "config.toml")
        cfg = load_config(tar_dir / "config.toml")
        require(cfg["model"]["package"].startswith("bonito."),
                f"{name}: package {cfg['model']['package']}")
        tar = tar_dir / "weights_1.tar"
        state = torch.load(tar, weights_only=True)
        model = load_model(src, half=False, device="cpu")
        n_hh = 0
        for k in state:
            if k.endswith("bias_hh_l0"):
                r = (0.1 * rng.standard_normal(state[k].shape)).astype(
                    np.float32)
                state[k] = torch.from_numpy(r)
                lstm = model.get_submodule(k.rsplit(".", 2)[0])
                with torch.no_grad():
                    lstm.b.copy_(torch.from_numpy(
                        state[k.replace("bias_hh", "bias_ih")].numpy() + r))
                n_hh += 1
        torch.save({f"module.{k}": v for k, v in state.items()}, tar)
        require(sorted(os.listdir(tar_dir)) == ["config.toml",
                                                "weights_1.tar"],
                f"{name}: the upstream directory holds "
                f"{sorted(os.listdir(tar_dir))}")
        npz_dir.mkdir()
        shutil.copy(tar_dir / "config.toml", npz_dir / "config.toml")
        checkpoint.save_params(npz_dir / "weights_1.npz", model)
        t0 = time.perf_counter()
        imported = checkpoint.import_torch_checkpoint(
            tar, load_symbol(cfg, "Model")(cfg))
        import_s[name] = time.perf_counter() - t0
        want = {k: v.numpy() for k, v in model.state_dict().items()}
        require(imported.keys() == want.keys() and all(
            np.array_equal(imported[k], want[k]) for k in want),
            f"{name}: the .tar's import differs from the model's weights")
        forms[name] = {"tar": tar_dir, "npz": npz_dir}
        log(f"  {name}: {tar_dir.name}/ (config.toml, weights_1.tar: "
            f"{len(state)} tensors, {tar.stat().st_size / 2 ** 20:.1f} MiB, "
            f"module. prefixes, {n_hh} nonzero bias_hh_l0) beside "
            f"{npz_dir.name}/; the import of the .tar on the host of "
            f"{card}: {import_s[name]:.3f} s (torch.load with weights_only, "
            f"key matching, layouts), equal to the weights")
        del model, state, imported

    # (b) the same weights, the same bits: one device-step batch each, as
    # the basecaller loads the model (bf16, fuse_bn, the config's quantize)
    for name, ((n, length), want) in UPSTREAM_STEPS.items():
        batch = rng.standard_normal((n, length), dtype=np.float32)
        outs = {}
        for form in ("tar", "npz"):
            model = load_model(forms[name][form], half=True, fuse_bn=True,
                               quantize=None, device=dev)
            model.requires_grad_(False)
            bc = model.config["basecaller"]
            require((bc["batchsize"], bc["chunksize"]) == (n, length),
                    f"{name} {form}: geometry {bc}")
            if name == "ctc":
                compute = ctc_basecall.make_compute_fn(model, n)
                outs[form] = counted(f"tar_{name}_step" if form == "tar"
                                     else None, lambda: compute(batch))
            else:
                compute = make_compute_fn(model, n, length)
                prepared = compute.prepare(batch)
                outs[form] = counted(
                    f"tar_{name}_step" if form == "tar" else None,
                    lambda: compute.fetch(compute.dispatch(prepared)))
            devices = {p.device.type for p in model.parameters()}
            require(devices == {dev.type},
                    f"{name} {form}: tensors on {devices}")
            del model, compute
            torch.cuda.empty_cache()
        require_launches(f"tar_{name}_step", want)
        a, b = outs["tar"], outs["npz"]
        same = (np.array_equal(a, b) if name == "ctc" else
                a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                             for k in a))
        require(same, f"{name}: the .tar directory's device step differs "
                f"from the .npz directory's")
        log(f"  {name}: one device-step batch ({n} x {length}) of the .tar "
            f"directory equals the .npz directory's bit for bit "
            f"({'log-probs' if name == 'ctc' else 'sequence, qstring, moves'}"
            f"); launches {({k: v for k, v in launches[f'tar_{name}_step'].items() if v}) or 'none'}")

    # (c) the basecaller CLI on the hac .tar directory and on the .npz one
    bams, cli = {}, {}
    for form in ("tar", "npz"):
        out = root / f"cli_{form}" / "out.bam"
        out.parent.mkdir()
        profiling.report(reset=True)
        os.environ["BONITO_TPU_PROFILE"] = "1"
        try:
            wall, err = counted(
                "tar_hac_cli" if form == "tar" else None,
                lambda: run_cli(cli_main, [
                    "basecaller", str(forms["hac"][form]), str(cli_reads),
                    "--n-proc", str(CLI_PROCS), "--output-dir",
                    str(out.parent)], out))
        finally:
            del os.environ["BONITO_TPU_PROFILE"]
        stages = profiling.report(reset=True)
        rate = re.search(r"samples per second (\S+)", err)
        require(rate and f"completed reads: {CLI_HAC_READS}" in err,
                f"CLI on the hac {form} directory: no {CLI_HAC_READS} "
                f"completed reads")
        bams[form] = sorted(bam_records(out.read_bytes()),
                            key=lambda r: r["name"])
        cli[form] = {"rate": float(rate.group(1)), "wall": wall,
                     "stages": stages}
    d, b = launches["tar_hac_cli"]["D"], launches["tar_hac_cli"]["B"]
    require_launches("tar_hac_cli", {"D": d, "B": b, "C": b})
    require(b > 0 and d == 5 * b, f"CLI: {d} launches of D for {b} batches")
    require(len(bams["tar"]) == len(bams["npz"]) == CLI_HAC_READS,
            "CLI: not one record a read")
    for x, y in zip(bams["tar"], bams["npz"]):
        tags_x = {k: v for k, v in x["tags"].items() if k != "RG"}
        tags_y = {k: v for k, v in y["tags"].items() if k != "RG"}
        require((x["name"], x["flag"], x["seq"], x["qual"])
                == (y["name"], y["flag"], y["seq"], y["qual"])
                and tags_x.keys() == tags_y.keys()
                and all(np.array_equal(tags_x[k], tags_y[k]) for k in tags_x),
                f"CLI: {x['name']}'s record differs between the .tar and "
                f".npz directories")
    log(f"  basecaller CLI on {card}, hac .tar directory, {CLI_HAC_READS} "
        f"pod5 reads to BAM: '> samples per second {cli['tar']['rate']:.1E}' "
        f"over {cli['tar']['wall']:.2f} s wall (the .npz directory: "
        f"{cli['npz']['rate']:.1E}, {cli['npz']['wall']:.2f} s); every record "
        f"(sequence, qstring, flag, every tag but RG, which names the "
        f"directory) equal; {b} batches, launches D {d}, B {b}, C {b}")
    for line in cli["tar"]["stages"]:
        log(f"    {line}")

    # (d) the old-style model at full width
    cfg = rnn_crf_config()
    require("type" not in cfg["encoder"], "not an old-style [encoder]")
    old_dir = root / "old_tar"
    old_dir.mkdir()
    master = Model(cfg).init(SEED)
    save_config(cfg, old_dir / "config.toml")
    torch.save(torch_state_dict(master), old_dir / "weights_1.tar")
    del master
    models = {q: load_model(old_dir, half=True, fuse_bn=True, quantize=q,
                            device=dev) for q in (False, True)}
    for q, m in models.items():
        m.requires_grad_(False)
        lstms = [x for x in m.encoder.modules() if isinstance(x, nn.LSTM)]
        bc = m.config["basecaller"]
        require(len(lstms) == 5 and all(x.size == OLD_H for x in lstms)
                and m.seqdist.n_states == S and m.stride == 5
                and all(x.quantized == q for x in lstms)
                and (bc["batchsize"], bc["chunksize"]) == (OLD_N, OLD_CHUNK),
                f"the old-style model (quantize={q}) did not load as 5 LSTM "
                f"layers of {OLD_H}, S {S}, stride 5, {OLD_N} x {OLD_CHUNK}")
    batch = rng.standard_normal((OLD_N, OLD_CHUNK), dtype=np.float32)
    computes = {q: make_compute_fn(m, OLD_N, OLD_CHUNK)
                for q, m in models.items()}
    prepared = {q: c.prepare(batch) for q, c in computes.items()}
    old = {}
    for q, key in ((False, "old_style_bf16_step"),
                   (True, "old_style_int8_step")):
        c, p = computes[q], prepared[q]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = counted(key, lambda: c.fetch(c.dispatch(p)))
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        require_launches(key, {"D" if q else "A": 5, "B": 1, "C": 1})
        plan = (lstm_int8_cuda.lstm_int8_fused if q
                else lstm_cuda.lstm_recurrence).plan
        require(plan is not None, f"{key}: the LSTM kernel took no "
                f"persistent plan at H {OLD_H}")
        mv = out["moves"]
        old[q] = {"peak": peak, "plan": plan, "ms": [],
                  "emit": float(mv.mean()),
                  "letters": sorted(set(np.unique(out["sequence"][mv > 0])
                                        .tolist()))}
    for t in range(OLD_TURNS):
        for q in ((False, True) if t % 2 == 0 else (True, False)):
            c, p = computes[q], prepared[q]
            old[q]["ms"].append(cuda_ms(lambda: c.fetch(c.dispatch(p)),
                                        reps=OLD_REPS))
    for q in (False, True):
        c, p = computes[q], prepared[q]
        old[q]["profile"] = profile_step(torch, lambda: c.fetch(c.dispatch(p)))
        best = min(old[q]["ms"])
        old[q]["samples_per_s"] = OLD_N * OLD_CHUNK / best * 1e3
        name = "int8 (quantize=true: D, the int8 head, B, C)" if q else \
            "bf16 (quantize=false: projection + A, B, C)"
        log(f"  old-style step {OLD_N} x {OLD_CHUNK} ({OLD_CHUNK // 5} "
            f"frames, H {OLD_H}, S {S}), {name} on {card}: "
            f"{', '.join(f'{ms:.4g}' for ms in old[q]['ms'])} ms in "
            f"{OLD_TURNS} turns of {OLD_REPS} (spread "
            f"{max(old[q]['ms']) - best:.3g} ms) = "
            f"{old[q]['samples_per_s']:.6g} samples/s at the best; peak "
            f"memory {old[q]['peak']:.3f} GiB above the held; launches a "
            f"batch {({k: v for k, v in launches['old_style_' + ('int8' if q else 'bf16') + '_step'].items() if v})}; "
            f"plan {old[q]['plan']}; {old[q]['emit']:.3f} of the frames emit, "
            f"letters {old[q]['letters']} (a random model's path)")
        for kname, ms, count in old[q]["profile"][:8]:
            log(f"    {ms:8.3f} ms  x{count:<5} {kname[:100]}")

    # the step's batch through the kernels against the same batch with
    # their plain versions in their place: A (bf16) with the hac bf16
    # limits, D (int8) with the hac int8 path's
    holds = {}
    for q, kernel_name, plain in (
            (False, "lstm_recurrence", lstm_cuda.lstm_recurrence_plain),
            (True, "lstm_int8_fused", lstm_int8_cuda.lstm_int8_fused_plain)):
        _, x_wire, sig_scale = prepared[q]
        m = models[q]
        kernel = getattr(ops_lstm, kernel_name)
        with torch.inference_mode():
            xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
                  * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
            mv_kernel, blank = m.forward_tcn(xc[..., None])
            setattr(ops_lstm, kernel_name, plain)
            try:
                mv_plain, _ = m.forward_tcn(xc[..., None])
            finally:
                setattr(ops_lstm, kernel_name, kernel)
            diff = (mv_kernel.float() - mv_plain.float()).abs()
            worst, mean = diff.max().item(), diff.mean().item()
            n_diff, n_all, _ = decodes_differ(torch, m, mv_kernel, mv_plain,
                                              blank, ops_decode)
        finite = torch.isfinite(mv_kernel.float()).all().item()
        limits = (0.5, 1e-3) if q else (HAC_MOVES_MAX, HAC_MOVES_MEAN)
        holds[q] = {"max": worst, "mean": mean, "frames_differ": n_diff,
                    "frames": n_all}
        log(f"  old-style {'int8' if q else 'bf16'} batch, moves "
            f"{tuple(mv_kernel.shape)} through 5 x {'D' if q else 'A'} at H "
            f"{OLD_H} vs its plain version: max |diff| {worst:.3g}, mean "
            f"{mean:.3g} (tolerance {limits[0]:.4g} / {limits[1]:.4g}); the "
            f"two decodes differ on {n_diff} of {n_all} frames (at most "
            f"{1 - HAC_MIN_EQUAL:.1%} may); finite {finite}")
        require(finite and worst <= limits[0] and mean <= limits[1]
                and n_diff <= (1 - HAC_MIN_EQUAL) * n_all,
                f"old-style {'int8' if q else 'bf16'} batch: the kernels' "
                f"moves disagree with the plain versions'")
        del mv_kernel, mv_plain, diff
    del models, computes
    torch.cuda.empty_cache()

    # A and D alone at H 768 on random inputs of the step's shape: A with
    # check_lstm's limits, D's persistent launch its step kernel's bits and
    # within check_lstm_int8's steps of the plain version; their times
    T7, H7 = OLD_CHUNK // 5, OLD_H
    g = torch.Generator().manual_seed(SEED + 768)
    xw = torch.randn(T7, OLD_N, 4 * H7, generator=g).to(dev, torch.bfloat16)
    w_hh = (torch.randn(H7, 4 * H7, generator=g) / math.sqrt(H7)).to(
        dev, torch.bfloat16)
    x_q = torch.randint(-127, 128, (T7, OLD_N, H7), generator=g,
                        dtype=torch.int8).to(dev)
    w_ih_q, ih_scales = int8.quantize_cols(
        (torch.randn(H7, 4 * H7, generator=g) / math.sqrt(H7)).numpy())
    w_hh_q, scales = int8.quantize_whh(
        (torch.randn(H7, 4 * H7, generator=g) / math.sqrt(H7)).numpy())
    d_args = (x_q, torch.from_numpy(w_ih_q).to(dev),
              torch.from_numpy(w_hh_q).to(dev),
              torch.from_numpy(ih_scales).to(dev) * int8.H_STEP,
              torch.from_numpy(scales).to(dev),
              (0.5 * torch.randn(4 * H7, generator=g)).to(dev))
    k768 = {}
    for reverse in (False, True):
        out = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
        ref = lstm_cuda.lstm_recurrence_plain(xw, w_hh, reverse=reverse)
        diff = (out.float() - ref.float()).abs()
        err_a, mean_a = diff.max().item(), diff.mean().item()
        require(err_a <= LSTM_ATOL and mean_a <= LSTM_MEAN_TOL,
                f"A at H {H7} (reverse={reverse}): max {err_a}, mean {mean_a}")
        d_out = lstm_int8_cuda.lstm_int8_fused(*d_args, reverse=reverse,
                                               out_int8=True)
        same = torch.equal(d_out, lstm_int8_cuda.lstm_int8_fused_step_kernel(
            *d_args, reverse=reverse, out_int8=True))
        steps_d = (d_out.float() - lstm_int8_cuda.lstm_int8_fused_plain(
            *d_args, reverse=reverse, out_int8=True).float()).abs()
        err_d, mean_d = steps_d.max().item(), steps_d.mean().item()
        require(same and err_d <= INT8_MAX_STEPS and mean_d <= INT8_MEAN_STEPS,
                f"D at H {H7} (reverse={reverse}): equal to its step kernel "
                f"{same}, max {err_d}, mean {mean_d} int8 steps")
        k768[reverse] = (err_a, mean_a, err_d, mean_d)
        log(f"  A at H {H7}, reverse={reverse}: max |h - plain| {err_a:.3g}, "
            f"mean {mean_a:.3g} (tolerance {LSTM_ATOL} / {LSTM_MEAN_TOL}); D: "
            f"equal to its step kernel, max {err_d:.3g} int8 steps, mean "
            f"{mean_d:.3g} (tolerance {INT8_MAX_STEPS} / {INT8_MEAN_STEPS})")
    ms_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence(xw, w_hh), reps=3)
    plan_a = lstm_cuda.lstm_recurrence.plan
    plain_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence_plain(xw, w_hh),
                      reps=1, warmup=0)
    ms_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused(
        *d_args, out_int8=True), reps=3)
    plan_d = lstm_int8_cuda.lstm_int8_fused.plan
    plain_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused_plain(
        *d_args, out_int8=True), reps=1, warmup=0)
    bound_a = bound(T7 * OLD_N * 4 * H7 * 2 + H7 * 4 * H7 * 2
                    + T7 * OLD_N * H7 * 2, 2 * OLD_N * H7 * 4 * H7 * T7,
                    H100_BF16_OPS)
    bound_d = bound(T7 * OLD_N * H7 + 2 * H7 * 4 * H7 + 3 * 4 * H7 * 4
                    + T7 * OLD_N * H7, 2 * OLD_N * T7 * (H7 + H7) * 4 * H7,
                    H100_INT8_OPS)
    h768 = {"A": {"ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a[0],
                  "bound_by": bound_a[1], "us_a_step": ms_a / T7 * 1e3,
                  "plan": plan_a,
                  "max_abs_err": max(v[0] for v in k768.values())},
            "D": {"ms": ms_d, "plain_ms": plain_d, "bound_ms": bound_d[0],
                  "bound_by": bound_d[1], "us_a_step": ms_d / T7 * 1e3,
                  "plan": plan_d,
                  "max_abs_err": max(v[2] for v in k768.values()) / 127.0}}
    for key, r in h768.items():
        log(f"  {key} at H {H7} ({OLD_N} x {T7} frames) on {card}: "
            f"{r['ms']:.4g} ms a layer ({r['us_a_step']:.4g} us a step), "
            f"plain {r['plain_ms']:.4g} ms, bound {r['bound_ms']:.4g} ms by "
            f"{r['bound_by']}; plan {r['plan']}")
    del xw, w_hh, d_args

    # (e) download from a file:// zip of the hac .tar directory
    site = root / "site"
    site.mkdir()
    with zipfile.ZipFile(site / f"{UPSTREAM_NAME}.zip", "w") as zf:
        for f in sorted(forms["hac"]["tar"].iterdir()):
            zf.write(f, f"{UPSTREAM_NAME}/{f.name}")
    saved = download.__url__
    download.__url__ = f"file://{site}/"
    t0 = time.perf_counter()
    try:
        cli_main(["download", "--models", "--select", UPSTREAM_NAME,
                  "--out_dir", str(root / "downloads")])
    finally:
        download.__url__ = saved
    download_s = time.perf_counter() - t0
    got = root / "downloads" / UPSTREAM_NAME
    require(sorted(os.listdir(got)) == ["config.toml", "weights_1.npz",
                                        "weights_1.tar"],
            f"download wrote {sorted(os.listdir(got))}")
    cfg = load_config(got / "config.toml")
    via_npz = checkpoint.params_from_jax(
        Model(cfg), checkpoint.load_params(got / "weights_1.npz"))
    imported = checkpoint.import_torch_checkpoint(got / "weights_1.tar",
                                                  Model(cfg))
    require(all(np.array_equal(v.numpy(), imported[k])
                for k, v in via_npz.state_dict().items())
            and imported.keys() == via_npz.state_dict().keys(),
            "download: the .npz it wrote differs from the .tar's import")
    log(f"  download --models --select {UPSTREAM_NAME} from a file:// zip of "
        f"the hac .tar directory: {download_s:.2f} s (unpack, import, "
        f"weights_1.npz); the .npz equals the import")

    # (f) export --format dorado of the hac .tar directory
    t0 = time.perf_counter()
    cli_main(["export", str(forms["hac"]["tar"]), "--output",
              str(root / "dorado"), "--format", "dorado"])
    export_s = time.perf_counter() - t0
    model = load_model(forms["hac"]["tar"], half=False, device="cpu")
    nn.fuse_bn(model.encoder)
    fused = checkpoint.export_state_dict(model.encoder)
    files = sorted(p.stem for p in (root / "dorado").glob("*.tensor"))
    require(files == sorted(fused), f"dorado export: {files} against "
            f"{sorted(fused)}")
    for k, v in fused.items():
        t = dict(torch.jit.load(str(root / "dorado" / f"{k}.tensor"))
                 .named_parameters())["0"]
        require(torch.equal(t.detach().cpu(), torch.from_numpy(v)),
                f"dorado export: {k}.tensor differs from the fused state")
    log(f"  export --format dorado of the hac .tar directory: {len(files)} "
        f".tensor files in {export_s:.2f} s, each read back with "
        f"torch.jit.load equal to the BatchNorm-fused state")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 14 took {phase_s:.1f} s")
    return {"launches": launches, "import_s": import_s,
            "cli": cli, "old": {("int8" if q else "bf16"): {
                k: v for k, v in r.items() if k != "profile"}
                for q, r in old.items()},
            "old_holds": holds, "h768": h768, "download_s": download_s,
            "export_s": export_s, "phase_s": phase_s}



# phase 15: f32 on the card. Kernels A and F in f32 at full width against
# their plain versions and their earlier kernels (f32_kernels), B and C on
# their f32 ring bit for bit; ``evaluate`` (half=False) of hac, fast and
# old-style
# directories on the card and with --device cpu; one ``train --no-amp``
# epoch with validation on hac and fast; the basecaller to CRAM with and
# without --reference; ``duplex`` on its BAM and CRAM.
F32_EVAL_CHUNKS, F32_EVAL_BATCH, F32_EVAL_LEN = 8, 8, 3000
# evaluate's own defaults (--chunks 512, --batchsize 256: two batches), the
# card only, for its rate
F32_RATE_CHUNKS, F32_RATE_BATCH = 512, 256
# evaluate on the card against --device cpu, f32 both: the card's kernels
# and cuDNN (TF32 convolutions, torch's default) sum in other orders, and
# where a random model's paths nearly tie the decode takes the other one;
# the share of chunks whose call may differ (seen: 0 of 8 for hac, fast and
# old-style, NVIDIA H100 80GB HBM3, torch 2.11.0+cu128)
F32_EVAL_MAX_DIFFER = 0.125
F32_TRAIN_N, F32_TRAIN_CHUNK, F32_TRAIN_L, F32_TRAIN_BATCHES = 16, 3000, 250, 2
# R and S in f32, (N, T, H): the --no-amp epochs' batch (F32_TRAIN_N
# chunks of 3000: hac T 500, fast T 600), the train CLI's default batch
# (64) and hac training's (128 x 6000: T 1000)
RS32_SHAPES = {"hac": (F32_TRAIN_N, 500, H), "fast": (F32_TRAIN_N, 600, FH),
               "cli": (64, 500, H), "hac_train": (128, 1000, H)}
F32_DUPLEX_THREADS = 2


# A's and F's f32 kernels (csrc/lstm_f32.cu) against their plain versions
# and their earlier kernels (R's f32 step kernel, csrc/lstm_fused.cu's f32
# kernel) within the LSTM recurrence's f32 limit (ROADMAP: f32 against f32,
# the same operations summed in another order; seen at most 1.07e-06 over
# 1666 hac steps on the earlier kernel, NVIDIA H100 80GB HBM3, 700.00 W)
LSTM_F32_ATOL = 1e-5
# (N, T, H): hac's basecall batch, evaluate's (256 chunks of 3000 samples:
# T 500 at hac's stride 6, 600 at the old-style model's stride 5) and the
# --no-amp validation's (16); F at fast's batch and at N 256 and 16
A32_SHAPES = {"hac": (N, T, H), "evaluate": (256, 500, H),
              "validation": (16, 500, H),
              "old_style_evaluate": (256, 600, 768)}
F32_SHAPES = {"fast": (FN, FT, FH), "evaluate": (256, 500, FH),
              "validation": (16, 500, FH)}
F32_TURNS = 2


def in_turns(torch, fns, reps):
    """Each of ``fns`` (name -> callable) after one warm-up call, timed
    F32_TURNS times in turns: name -> [ms, ...]."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(F32_TURNS):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, reps, warmup=0))
    return times


def cudnn_f32(torch, dev, t, n, h, reps):
    """cuDNN's f32 LSTM layer (``torch.nn.LSTM(h, h)``, its projection
    included) on x [t, n, h], forward: its time with TF32 off (the f32
    function: the yardstick) and on (torch's default for cuDNN: its
    products' operands rounded to 10 bits of mantissa), the setting
    restored after. (R's and S's forward + backward: f32_train_kernels.)"""
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.randn(t, n, h, device=dev, generator=g)
    lstm = torch.nn.LSTM(h, h, device=dev)
    lstm.flatten_parameters()

    def step():
        with torch.no_grad():
            return lstm(x)
    tf32 = torch.backends.cudnn.allow_tf32
    times = {}
    try:
        for on in (False, True):
            torch.backends.cudnn.allow_tf32 = on
            times[on] = cuda_ms(step, reps)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return times[False], times[True]


def f32_kernels(torch, dev, lstm_cuda, lstm_fused_cuda, decode_cuda):
    """A and F in f32 at A32_SHAPES and F32_SHAPES: each new kernel against
    its plain version, the earlier kernel against the plain version and
    the two against each other (all within LSTM_F32_ATOL; A both
    directions at hac, F three cases at fast), the launches and plan of
    each call; the two timed in turns; the bound; cuDNN's f32 LSTM with
    TF32 off and on. B and C on the f32 ring at S 1024 and 64 against
    their plain versions bit for bit. Times of the plain versions are of
    their one call here."""
    out = {"A": {}, "F": {}}
    g = torch.Generator().manual_seed(SEED + 15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for key, (n, t, h) in A32_SHAPES.items():
        xw = torch.randn(t, n, 4 * h, generator=g).to(dev)
        w_hh = (torch.randn(h, 4 * h, generator=g) / math.sqrt(h)).to(dev)
        err = {"new": 0.0, "old": 0.0, "vs_old": 0.0}
        for reverse in ((False, True) if key == "hac" else (False,)):
            before = lstm_cuda.lstm_recurrence.launches
            got = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
            torch.cuda.synchronize()
            plan = lstm_cuda.lstm_recurrence.plan
            require(got.dtype == torch.float32 and plan is not None
                    and plan == lstm_cuda.f32_plan(n, h, sms)
                    and lstm_cuda.lstm_recurrence.launches - before
                    == plan["launches"],
                    f"kernel A in f32 at {(n, t, h)}: {got.dtype}, plan "
                    f"{plan}, launches "
                    f"{lstm_cuda.lstm_recurrence.launches - before}")
            ref, plain = timed(torch, lambda: lstm_cuda.lstm_recurrence_plain(
                xw, w_hh, reverse=reverse))
            old = lstm_cuda.lstm_recurrence_old_kernel(xw, w_hh, reverse)
            for k, a, b in (("new", got, ref), ("old", old, ref),
                            ("vs_old", got, old)):
                require(torch.isfinite(a).all().item(),
                        f"kernel A in f32 at {(n, t, h)}: non-finite {k}")
                err[k] = max(err[k], (a - b).abs().max().item())
            del ref, old
        require(all(v <= LSTM_F32_ATOL for v in err.values()),
                f"kernel A in f32 at {(n, t, h)}: max |diff| {err} (new, "
                f"earlier kernel, new vs earlier) beyond {LSTM_F32_ATOL}")
        turns = in_turns(torch, {
            "new": lambda: lstm_cuda.lstm_recurrence(xw, w_hh),
            "old": lambda: lstm_cuda.lstm_recurrence_old_kernel(xw, w_hh)},
            reps=1)
        lib, lib_tf32 = cudnn_f32(torch, dev, t, n, h, reps=2)
        b = bound(t * n * 4 * h * 4 + h * 4 * h * 4 + t * n * h * 4,
                  2 * n * h * 4 * h * t, H100_F32_OPS)
        ms = sum(turns["new"]) / F32_TURNS
        out["A"][key] = dict(
            shape=[n, t, h], plan=plan, launches_per_call=plan["launches"],
            max_abs_err=err["new"], old_kernel_max_abs_err=err["old"],
            max_abs_err_vs_old_kernel=err["vs_old"], ms=ms,
            ms_turns=turns["new"], old_kernel_ms=sum(turns["old"]) / F32_TURNS,
            old_kernel_ms_turns=turns["old"], plain_ms=plain, bound_ms=b[0],
            bound_by=b[1], library_ms=lib, library_tf32_ms=lib_tf32,
            us_a_step=ms / t * 1e3)
        log(f"  A in f32, {key} (N {n}, T {t}, H {h}): {ms:.4g} ms a layer "
            f"({ms / t * 1e3:.4g} us a step; turns {turns['new']}), the "
            f"earlier kernel {turns['old']}; plain {plain:.4g} ms, bound "
            f"{b[0]:.4g} ms by {b[1]}, cuDNN torch.nn.LSTM f32 {lib:.4g} ms "
            f"with TF32 off ({lib_tf32:.4g} ms with TF32 on); max |h - plain| "
            f"{err['new']:.3g} (earlier kernel {err['old']:.3g}, the two "
            f"{err['vs_old']:.3g}); plan {plan}")
        del xw, w_hh, got
        torch.cuda.empty_cache()

    for key, (n, t, h) in F32_SHAPES.items():
        x = torch.tanh(torch.randn(t, n, h, generator=g)).to(dev)
        w_ih, w_hh = ((torch.randn(h, 4 * h, generator=g) / math.sqrt(h)).to(
            dev) for _ in range(2))
        bias = (0.5 * torch.randn(4 * h, generator=g)).to(dev)
        err = {"new": 0.0, "old": 0.0, "vs_old": 0.0}
        cases = (((True, bias), (False, None), (False, bias)) if key == "fast"
                 else ((False, bias),))
        for reverse, b in cases:
            before = lstm_fused_cuda.lstm_fused.launches
            got = lstm_fused_cuda.lstm_fused(x, w_ih, w_hh, b,
                                             reverse=reverse)
            torch.cuda.synchronize()
            plan = lstm_fused_cuda.lstm_fused.plan
            require(got.dtype == torch.float32 and plan is not None
                    and plan == lstm_fused_cuda.f32_plan(n, h, h, sms)
                    and lstm_fused_cuda.lstm_fused.launches - before == 1,
                    f"kernel F in f32 at {(n, t, h)}: {got.dtype}, plan "
                    f"{plan}")
            ref, plain = timed(torch, lambda: lstm_fused_cuda.lstm_fused_plain(
                x, w_ih, w_hh, b, reverse=reverse))
            old = lstm_fused_cuda.lstm_fused_old_kernel(x, w_ih, w_hh, b,
                                                        reverse=reverse)
            for k, a, r in (("new", got, ref), ("old", old, ref),
                            ("vs_old", got, old)):
                require(torch.isfinite(a).all().item(),
                        f"kernel F in f32 at {(n, t, h)}: non-finite {k}")
                err[k] = max(err[k], (a - r).abs().max().item())
            del ref, old
        require(all(v <= LSTM_F32_ATOL for v in err.values()),
                f"kernel F in f32 at {(n, t, h)}: max |diff| {err} (new, "
                f"earlier kernel, new vs earlier) beyond {LSTM_F32_ATOL}")
        turns = in_turns(torch, {
            "new": lambda: lstm_fused_cuda.lstm_fused(x, w_ih, w_hh, bias),
            "old": lambda: lstm_fused_cuda.lstm_fused_old_kernel(
                x, w_ih, w_hh, bias)}, reps=3)
        lib, lib_tf32 = cudnn_f32(torch, dev, t, n, h, reps=3)
        b = bound(2 * t * n * h * 4 + 2 * h * 4 * h * 4 + 4 * h * 4,
                  2 * n * t * (h + h) * 4 * h, H100_F32_OPS)
        ms = sum(turns["new"]) / F32_TURNS
        out["F"][key] = dict(
            shape=[n, t, h, h], plan=plan, max_abs_err=err["new"],
            old_kernel_max_abs_err=err["old"],
            max_abs_err_vs_old_kernel=err["vs_old"], ms=ms,
            ms_turns=turns["new"],
            old_kernel_ms=sum(turns["old"]) / F32_TURNS,
            old_kernel_ms_turns=turns["old"], plain_ms=plain, bound_ms=b[0],
            bound_by=b[1], library_ms=lib, library_tf32_ms=lib_tf32,
            us_a_step=ms / t * 1e3)
        log(f"  F in f32, {key} (N {n}, T {t}, C = H = {h}): {ms:.4g} ms a "
            f"layer ({ms / t * 1e3:.4g} us a step; turns {turns['new']}), "
            f"the earlier kernel {turns['old']}; plain {plain:.4g} ms, bound "
            f"{b[0]:.4g} ms by {b[1]}, cuDNN torch.nn.LSTM f32 {lib:.4g} ms "
            f"with TF32 off ({lib_tf32:.4g} ms with TF32 on); max |h - plain| "
            f"{err['new']:.3g} (earlier kernel {err['old']:.3g}, the two "
            f"{err['vs_old']:.3g}); plan {plan}")
        del x, w_ih, w_hh, got
    torch.cuda.empty_cache()

    names = DECODE_OUTPUTS
    for key, (n, t, s) in (("BC", (N, T, S)), ("BC64", (FN, FT, FS))):
        moves = (2.0 * torch.randn(n, t, 4 * s, generator=g)).to(dev)
        fwd = decode_cuda.tcn_forward(moves, 2.0)
        res = decode_cuda.tcn_backward(moves, *fwd, 2.0, qscale=1.05,
                                       qbias=0.2)
        torch.cuda.synchronize()
        plan = decode_cuda.tcn_forward.plan
        require(plan is not None and decode_cuda.tcn_backward.plan == plan,
                f"B and C on f32 moves at S {s} took the earlier kernels")
        ref_fwd, plain_b = timed(
            torch, lambda: decode_cuda.tcn_forward_plain(moves, 2.0))
        ref, plain_c = timed(torch, lambda: decode_cuda.tcn_backward_plain(
            moves, *ref_fwd, 2.0, qscale=1.05, qbias=0.2))
        got = list(fwd) + [res[k] for k in ("sequence", "qstring", "moves")]
        want = list(ref_fwd) + [ref[k] for k in ("sequence", "qstring",
                                                   "moves")]
        differ = [name for name, a, w in zip(names, got, want)
                  if not torch.equal(a, w)]
        require(not differ, f"B and C on the f32 ring at S {s} differ from "
                            f"their plain versions in {differ}")
        err_b = max((a.float() - w.float()).abs().max().item()
                    for a, w in zip(got[:5], want[:5]))
        err_c = max((a.float() - w.float()).abs().max().item()
                    for a, w in zip(got[5:], want[5:]))
        ms_b = cuda_ms(lambda: decode_cuda.tcn_forward(moves, 2.0), reps=3)
        ms_c = cuda_ms(lambda: decode_cuda.tcn_backward(moves, *fwd, 2.0),
                       reps=3)
        r = s // 4
        move_bytes = n * t * 4 * s * 4
        bb = bound(move_bytes + n * t * s * 5 + n * t * 4 + n * 8,
                   20 * n * t * s, H100_F32_OPS)
        bc = bound(move_bytes + n * t * r * 4 + n * t * 5 + n * 8 + 3 * n * t,
                   20 * n * t * s, H100_F32_OPS)
        out[key] = {"B": dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                              bound_ms=bb[0], bound_by=bb[1]),
                    "C": dict(max_abs_err=err_c, ms=ms_c, plain_ms=plain_c,
                              bound_ms=bc[0], bound_by=bc[1]),
                    "plan": plan, "shape": [n, t, s]}
        log(f"  B and C on the f32 ring, N {n}, T {t}, S {s}: B {ms_b:.4g} "
            f"ms (plain {plain_b:.4g}, bound {bb[0]:.4g} by {bb[1]}), C "
            f"{ms_c:.4g} ms (plain {plain_c:.4g}, bound {bc[0]:.4g} by "
            f"{bc[1]}); all eight outputs equal the plain versions' bit for "
            f"bit")
        del moves, fwd, res, ref_fwd, ref, got, want
    torch.cuda.empty_cache()
    return out


def f32_gaps(torch, dev, counters):
    """The other f32 instances that ``evaluate`` or ``train --no-amp``
    launch, at their shapes: M and Q on f32 full scores (evaluate's decode:
    256 chunks of 3000 samples, hac T 500 at S 1024, fast T 600 at S 64)
    against their plain versions and earlier kernels (``hold_full``); R and
    S in f32 (``f32_train_kernels``); K and P in the sup model's f32
    forward at evaluate's batch (``sup_f32_kernels``)."""
    from bonito_tpu_torch.crf import seqdist
    from bonito_tpu_torch.ops import decode_full_cuda
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    for key, (n, t, s) in (("MQ_hac", (256, 500, S)),
                           ("MQ_fast", (256, 600, FS))):
        crf = seqdist.CTC_CRF(round(math.log(s, 4)), list("NACGT"))
        scores = (3 * torch.randn(n, t, 5 * s, generator=g, device=dev)
                  ).clamp(-5, 5)
        _, _, h = hold_full(torch, decode_full_cuda, scores, qscale=1.05,
                            qbias=0.2)
        require(h["ok"], f"M + Q on f32 full scores at {(n, t, s)}: "
                         f"{h['text']}")
        tm = time_full(torch, decode_full_cuda, crf, scores, plain=True)
        out[key] = {k: dict(ms=tm[f"{k}_fwd"], old_kernel_ms=tm[f"{k}_old"],
                            plain_ms=tm[f"{k}_plain"], bound_ms=b[0],
                            bound_by=b[1], library_ms=None, max_abs_err=e)
                    for k, b, e in zip("MQ", tm["bounds"],
                                       (h["err_in"], float(h["dq"])))}
        out[key].update(shape=[n, t, s], plan=tm["plan"],
                        max_abs_err_move_in=h["err_in"], max_dq=h["dq"])
        log(f"  M + Q on f32 full scores, evaluate's decode (N {n}, T {t}, "
            f"S {s}): M {tm['M_fwd']:.4g} ms, Q {tm['Q_fwd']:.4g} ms (the "
            f"earlier kernels {tm['M_old']:.4g}, {tm['Q_old']:.4g}; plain "
            f"{tm['M_plain']:.4g}, {tm['Q_plain']:.4g}; bounds "
            f"{tm['bounds'][0][0]:.4g}, {tm['bounds'][1][0]:.4g} ms by "
            f"{tm['bounds'][0][1]}); {h['text']}")
        del scores
    out.update(f32_train_kernels(torch, dev, counters))
    out.update(sup_f32_kernels(torch, dev, counters))
    torch.cuda.empty_cache()
    return out


def sup_f32_kernels(torch, dev, counters):
    """The sup model's forward and ``decode_batch`` in f32 at evaluate's
    batch (the shipped sup model, 256 x 3000; called here, not through the
    evaluate CLI): its launches, K on the stretch kernel's f32 plan and P
    on the tiles (both required), and K's and P's times at that call's
    inputs in turns with their earlier kernels (K's one block a tile; P's
    gather), with their plain versions and the library calls (rotary
    passes + SDPA in f32 with the band as a mask, TF32 off;
    ``Tensor.contiguous()``). K is held to ATTN_F32_TOL of its plain
    version and of the earlier kernel, P bit for bit to both and faster
    than ``Tensor.contiguous()``; P also at the bf16 stack input of a T no
    multiple of 8 (T 999) against the earlier gather."""
    import torch.nn.functional as F
    from bonito_tpu_torch import nn
    from bonito_tpu_torch.models import MODELS
    from bonito_tpu_torch.ops import attention_cuda, relayout
    from bonito_tpu_torch.transformer import model as transformer
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    model = transformer.Model(MODELS[SUP]()).init(SEED).to(dev)
    model.requires_grad_(False)
    x = torch.randn(256, 3000, 1, generator=g, device=dev)
    k_args, p_args = [], []
    k_fn, p_fn = transformer.fused_rotary_window_attention, nn.pin_layout

    def k_spy(*a, **kw):
        if not k_args:
            k_args.append((a, kw))
        return k_fn(*a, **kw)

    def p_spy(*a, **kw):
        if not p_args:
            p_args.append((a, kw))
        return p_fn(*a, **kw)
    transformer.fused_rotary_window_attention = k_spy
    nn.pin_layout = p_spy
    try:
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        with torch.inference_mode():
            model.decode_batch(model(x))
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in counters.items() if c.launches}
    finally:
        transformer.fused_rotary_window_attention = k_fn
        nn.pin_layout = p_fn
    plans = {"K": attention_cuda.fused_rotary_window_attention.plan,
             "P": relayout.pin_layout.plan}
    out["sup_forward_decode_launches"] = launched
    out["sup_forward_plans"] = plans
    log(f"  the sup model's forward + decode_batch in f32 at evaluate's "
        f"batch (256 x 3000): launches {launched}; K's plan {plans['K']}, "
        f"P's {plans['P'][0]}")
    require(launched.get("K") == 18 and launched.get("P") == 1
            and plans["K"] is not None and plans["K"]["dtype"] == "f32"
            and plans["P"][0] == "tiles" and k_args and p_args,
            f"sup's f32 forward at evaluate's batch: launches {launched}, "
            f"K's plan {plans['K']}, P's {plans['P']}")
    del model
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (qkv, cos, sin, window, *rest), kw = k_args[0]
        t_real = (rest or [kw.get("t_real")])[0]
        n, t, _, hd, d = qkv.shape
        kernel = attention_cuda.fused_rotary_window_attention
        earlier = attention_cuda.fused_rotary_window_attention_old_kernel
        ref_k, plain_k = timed(torch, lambda: attention_cuda.
                               fused_rotary_window_attention_plain(
                                   qkv, cos, sin, window, t_real))
        got_k = kernel(qkv, cos, sin, window, t_real)
        old_k = earlier(qkv, cos, sin, window, t_real)
        torch.cuda.synchronize()
        err = {name: ((a - b).abs().max().item(), (a - b).abs().mean().item())
               for name, a, b in (("plain", got_k, ref_k),
                                  ("old", got_k, old_k),
                                  ("old_plain", old_k, ref_k))}
        # f32 against f32, the same operations summed in another order: L's
        # f32 limits (a K that rounded its output to bf16 would be about
        # 1e-3 off)
        require(torch.isfinite(got_k).all().item() and all(
            e <= ATTN_F32_TOL and m <= ATTN_MEAN_TOL
            for e, m in (err["plain"], err["old"])),
                f"K in f32 at sup's forward: max / mean |o - plain| "
                f"{err['plain']}, |o - earlier kernel| {err['old']} "
                f"(tolerance {ATTN_F32_TOL} / {ATTN_MEAN_TOL})")
        band = attention_cuda.band_mask(t, window, t_real, dev)

        def library_k():
            q = transformer.apply_rotary(qkv[:, :, 0], cos, sin)
            k = transformer.apply_rotary(qkv[:, :, 1], cos, sin)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                qkv[:, :, 2].transpose(1, 2), attn_mask=band).transpose(1, 2)
        err_lib = (library_k() - got_k).abs().max().item()
        del ref_k, got_k, old_k
        turns = in_turns(torch, {
            "K": lambda: kernel(qkv, cos, sin, window, t_real),
            "K_old": lambda: earlier(qkv, cos, sin, window, t_real),
            "library": library_k}, reps=5)
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        pairs = band_pairs(t, window, t_real)
        # f32 qkv in and f32 o out; the two band products on the tensor
        # cores (q, k, v and p rounded to bf16) and about 10 f32 operations
        # a pair for the softmax
        b_k = bound(n * t * 4 * hd * d * 4 + 2 * t * cos.shape[-1] * 4,
                    2 * 2 * n * hd * pairs * d, H100_BF16_OPS,
                    10 * n * hd * pairs)
        require(ms["K"] < ms["K_old"], f"K in f32 on the stretch kernel is "
                                       f"no faster than the earlier kernel: "
                                       f"{turns}")
        out["K"] = dict(ms=ms["K"], times=turns["K"],
                        old_kernel_ms=ms["K_old"],
                        old_kernel_times=turns["K_old"], plain_ms=plain_k,
                        bound_ms=b_k[0], bound_by=b_k[1],
                        library_ms=ms["library"],
                        library_times=turns["library"],
                        max_abs_err=err["plain"][0],
                        mean_abs_err=err["plain"][1],
                        max_abs_err_vs_old_kernel=err["old"][0],
                        old_kernel_max_abs_err=err["old_plain"][0],
                        max_abs_err_vs_library=err_lib,
                        shape=[n, t, hd, d], plan=plans["K"])
        log(f"  K in f32 at that call (N {n}, T {t}, {hd} heads of {d}), in "
            f"turns: {turns['K']} ms on the stretch kernel (plan "
            f"{plans['K']}), {turns['K_old']} ms on the earlier kernel; "
            f"max / mean |o - plain| {err['plain'][0]:.3g} / "
            f"{err['plain'][1]:.3g} (the earlier kernel's "
            f"{err['old_plain'][0]:.3g}; the two kernels "
            f"{err['old'][0]:.3g}); plain {plain_k:.4g} ms, bound "
            f"{b_k[0]:.4g} ms by {b_k[1]}, rotary passes + SDPA f32 with "
            f"the band {turns['library']} ms (max |diff| {err_lib:.3g})")
        del qkv, cos, sin, band
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (view, *_), _ = p_args[0]
    views = {"f32": view,
             "bf16_t999": torch.randn(128, 512, 999, generator=g, device=dev)
             .to(torch.bfloat16).transpose(1, 2)}
    for key, v in views.items():
        plan = relayout.relayout_plan(list(v.shape), list(v.stride()),
                                      v.element_size(),
                                      aligned=v.data_ptr() % 16 == 0)
        old_plan = relayout.relayout_plan(list(v.shape), list(v.stride()),
                                          v.element_size(),
                                          aligned=v.data_ptr() % 16 == 0,
                                          earlier=True)
        want = relayout.pin_layout_plain(v)
        require(plan[0] == "tiles"
                and torch.equal(relayout.pin_layout(v), want)
                and torch.equal(relayout.pin_layout_old_kernel(v), want),
                f"P ({key}, {tuple(v.shape)}): plan {plan[0]}, or it or its "
                f"earlier kernel differs from the plain version")
        _, plain_p = timed(torch, lambda: relayout.pin_layout_plain(v))
        turns = in_turns(torch, {
            "P": lambda: relayout.pin_layout(v),
            "P_old": lambda: relayout.pin_layout_old_kernel(v),
            "library": lambda: v.contiguous()}, reps=10)
        ms = {k: sum(t_) / len(t_) for k, t_ in turns.items()}
        b_p = bound(2 * v.numel() * v.element_size(), 0, H100_F32_OPS)
        require(ms["P"] < ms["library"] and ms["P"] < ms["P_old"],
                f"P ({key}) is no faster than Tensor.contiguous() and its "
                f"earlier kernel: {turns}")
        out["P" if key == "f32" else f"P_{key}"] = dict(
            ms=ms["P"], times=turns["P"], old_kernel_ms=ms["P_old"],
            old_kernel_times=turns["P_old"], old_kernel_plan=old_plan[0],
            plain_ms=plain_p, bound_ms=b_p[0], bound_by=b_p[1],
            library_ms=ms["library"], library_times=turns["library"],
            max_abs_err=0.0, shape=list(v.shape), plan=plan[0])
        log(f"  P on {key} {tuple(v.shape)} strides {v.stride()}, in turns: "
            f"{turns['P']} ms on the {plan[0]} (the earlier kernel's "
            f"{old_plan[0]}: {turns['P_old']} ms), Tensor.contiguous() "
            f"{turns['library']} ms; plain {plain_p:.4g} ms, bound "
            f"{b_p[0]:.4g} ms; bit-identical")
    del views, view
    return out


class step_kernels:
    """R and S on their step kernels at every shape (``forward_plan`` and
    ``backward_plan`` swapped for rules that give no plan), for the
    comparisons of phase 15; their launches count as on the persistent
    kernels'."""

    def __init__(self, lstm_train_cuda):
        self.ctx = (earlier_kernel(lstm_train_cuda, "forward_plan"),
                    earlier_kernel(lstm_train_cuda, "backward_plan"))

    def __enter__(self):
        for c in self.ctx:
            c.__enter__()

    def __exit__(self, *exc):
        for c in self.ctx:
            c.__exit__(*exc)


def f32_train_kernels(torch, dev, counters):
    """R and S in f32 (``train --no-amp``) at RS32_SHAPES, c and the
    activations stored as the path stores them (``train_supported``): the
    persistent kernels on their f32 plans (R A's ``f32_plan``, S
    ``f32_backward_plan``; launches and plans checked) against their plain
    versions and the earlier step kernels (``lstm_train_forward_step``,
    ``lstm_train_backward_step``): h within LSTM_F32_ATOL and equal to A's
    f32 kernel bit for bit, the gates' gradient within LSTM_TRAIN_MAX of
    the largest; timed in turns with the step kernels and cuDNN's f32 LSTM
    forward + backward (TF32 off: the f32 function, the yardstick; and on),
    and the port's whole layer (``ops.lstm.lstm_train`` forward + backward:
    the projection, R, S, dW_hh; what cuDNN's figure covers) on the new
    kernels and on the step kernels; and one hac ``--no-amp`` train step at
    F32_TRAIN_N x F32_TRAIN_CHUNK on the new kernels in turns with the step
    kernels."""
    from bonito_tpu_torch.crf.model import Model
    from bonito_tpu_torch.models import lstm_crf_config
    from bonito_tpu_torch.ops import lstm_cuda, lstm_train_cuda
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd, bwd = lstm_train_cuda.lstm_train_forward, \
        lstm_train_cuda.lstm_train_backward
    for key, (n, t, h) in RS32_SHAPES.items():
        xw = torch.randn(t, n, 4 * h, generator=g, device=dev)
        w = torch.randn(h, 4 * h, generator=g, device=dev) / math.sqrt(h)
        g_h = torch.randn(t, n, h, generator=g, device=dev)
        rb = ops_lstm.train_supported(torch.empty(n, t, h), w)
        before = (fwd.launches, bwd.launches)
        hk, ck, ak = fwd(xw, w, False, rb)
        dk = bwd(w, ak, ck, g_h, False, rb)
        torch.cuda.synchronize()
        plans = (fwd.plan, bwd.plan)
        require(plans[0] == lstm_cuda.f32_plan(n, h, sms)
                and plans[1] == lstm_train_cuda.f32_backward_plan(
                    n, h, sms, rb) and None not in plans
                and (fwd.launches - before[0], bwd.launches - before[1])
                == (plans[0]["launches"], plans[1]["launches"]),
                f"R and S in f32 at {(n, t, h)}: plans {plans}, launches "
                f"{fwd.launches - before[0]}, {bwd.launches - before[1]}")
        a = lstm_cuda.lstm_recurrence(xw, w)
        same_as_a = bool(torch.equal(hk, a))
        del a
        hs, _, _ = lstm_train_cuda.lstm_train_forward_step(xw, w, False, rb)
        ds = lstm_train_cuda.lstm_train_backward_step(w, ak, ck, g_h, False,
                                                      rb)
        (hp, _, _), plain_r = timed(torch, lambda: lstm_train_cuda.
                                    lstm_train_forward_plain(xw, w, False,
                                                             rb))
        dp, plain_s = timed(torch, lambda: lstm_train_cuda.
                            lstm_train_backward_plain(w, ak, ck, g_h, False,
                                                      rb))
        big = dp.float().abs().max().item()
        err = {"h": (hk - hp).abs().max().item(),
               "h_step": (hk - hs).abs().max().item(),
               "d": (dk.float() - dp.float()).abs().max().item(),
               "d_step": (dk.float() - ds.float()).abs().max().item()}
        require(same_as_a and torch.isfinite(dk.float()).all().item()
                and max(err["h"], err["h_step"]) <= LSTM_F32_ATOL
                and max(err["d"], err["d_step"]) <= LSTM_TRAIN_MAX * big,
                f"R and S in f32 at {(n, t, h)}: h equal to A's "
                f"{same_as_a}, max |diff| {err} (largest gradient {big})")
        del hs, ds, hp, dp
        # the whole layer, x [N, T, H] -> h, and its backward
        x = torch.randn(n, t, h, generator=g, device=dev)
        params = [(torch.randn(h, 4 * h, generator=g, device=dev)
                   / math.sqrt(h)).requires_grad_(),
                  w.clone().requires_grad_(),
                  torch.randn(4 * h, generator=g, device=dev
                              ).requires_grad_()]
        x.requires_grad_()
        g_layer = g_h.transpose(0, 1)

        def layer():
            ops_lstm.lstm_train(x, *params).backward(g_layer)

        def layer_step():
            with step_kernels(lstm_train_cuda):
                layer()
        lstm = torch.nn.LSTM(h, h, device=dev)
        lstm.flatten_parameters()
        xc = torch.randn(t, n, h, generator=g, device=dev,
                         requires_grad=True)

        def cudnn(on):
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = on
            try:
                y, _ = lstm(xc)
                y.backward(g_h)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
        turns = in_turns(torch, {
            "R": lambda: fwd(xw, w, False, rb),
            "R_step": lambda: lstm_train_cuda.lstm_train_forward_step(
                xw, w, False, rb),
            "S": lambda: bwd(w, ak, ck, g_h, False, rb),
            "S_step": lambda: lstm_train_cuda.lstm_train_backward_step(
                w, ak, ck, g_h, False, rb),
            "layer": layer, "layer_step": layer_step,
            "cudnn": lambda: cudnn(False), "cudnn_tf32": lambda: cudnn(True)},
            reps=1)
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        st = 2 if rb else 4  # c and the activations: bf16 or f32
        ops = 2 * n * h * 4 * h * t
        b_r = bound(t * n * 4 * h * 4 + h * 4 * h * 4 + t * n * h * 4
                    + t * n * 5 * h * st, ops, H100_F32_OPS)
        b_s = bound(t * n * 5 * h * st + t * n * h * 4 + h * 4 * h * 4
                    + t * n * 4 * h * st, ops, H100_F32_OPS)
        # the layer: the projection forward and its two gradients, R, S and
        # dW_hh, six products of 2 N T H 4H f32 operations
        b_layer = bound(0, 6 * ops, H100_F32_OPS)
        out[f"RS_{key}"] = {
            "R": dict(ms=ms["R"], times=turns["R"],
                      step_kernel_ms=ms["R_step"],
                      step_kernel_times=turns["R_step"], plain_ms=plain_r,
                      bound_ms=b_r[0], bound_by=b_r[1],
                      max_abs_err=err["h"],
                      max_abs_err_vs_step_kernel=err["h_step"],
                      h_equals_a=same_as_a, plan=plans[0]),
            "S": dict(ms=ms["S"], times=turns["S"],
                      step_kernel_ms=ms["S_step"],
                      step_kernel_times=turns["S_step"], plain_ms=plain_s,
                      bound_ms=b_s[0], bound_by=b_s[1],
                      max_abs_err=err["d"],
                      max_abs_err_vs_step_kernel=err["d_step"],
                      err_relative_to_max=err["d"] / big, plan=plans[1]),
            "layer_ms": ms["layer"], "layer_times": turns["layer"],
            "layer_step_kernels_ms": ms["layer_step"],
            "layer_bound_ms": b_layer[0],
            "library_ms": ms["cudnn"], "library_times": turns["cudnn"],
            "library_tf32_ms": ms["cudnn_tf32"],
            "shape": [n, t, h], "round_bf16": rb, "plans": list(plans)}
        log(f"  R and S in f32 at (N {n}, T {t}, H {h}; c and activations in "
            f"{'bf16' if rb else 'f32'}), in turns: R {turns['R']} ms "
            f"(step kernel {turns['R_step']}), S {turns['S']} ms (step "
            f"kernel {turns['S_step']}); R + S {ms['R'] + ms['S']:.4g} ms "
            f"against cuDNN's f32 forward + backward {turns['cudnn']} ms "
            f"with TF32 off ({turns['cudnn_tf32']} on); the port's whole "
            f"layer {turns['layer']} ms (on the step kernels "
            f"{turns['layer_step']}, bound {b_layer[0]:.4g} ms); plain "
            f"{plain_r:.4g}, {plain_s:.4g} ms; bounds {b_r[0]:.4g}, "
            f"{b_s[0]:.4g} ms by {b_r[1]}; max |h - plain| {err['h']:.3g} "
            f"(step kernel {err['h_step']:.3g}, A's h bit for bit "
            f"{same_as_a}), dgates {err['d'] / big:.3g} of the largest "
            f"(step kernel {err['d_step'] / big:.3g}); plans {plans}")
        del xw, w, g_h, hk, ck, ak, dk, x, params, lstm, xc
        torch.cuda.empty_cache()

    # one hac --no-amp train step at the epochs' batch, in turns with the
    # step kernels
    model = Model(lstm_crf_config()).init(SEED).to(dev)
    step = make_train_step(model, make_optimizer(model, 2e-3), use_amp=False)
    batch = train_batch(torch, dev, F32_TRAIN_N, F32_TRAIN_CHUNK, F32_TRAIN_L,
                        SEED)

    def step_ms():
        step(batch, 1.0, 2.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step(batch, 1.0, 2.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    turns = {"step_kernels": [], "new": []}
    for route in ("step_kernels", "new", "new", "step_kernels"):
        for c in counters.values():
            c.launches = 0
        if route == "new":
            turns[route].append(step_ms())
            launched = {k: c.launches for k, c in counters.items()
                        if c.launches}
            require(fwd.plan is not None and bwd.plan is not None
                    and fwd.plan["dtype"] == bwd.plan["dtype"] == "f32",
                    f"the hac --no-amp step: R's plan {fwd.plan}, S's "
                    f"{bwd.plan}")
        else:
            with step_kernels(lstm_train_cuda):
                turns[route].append(step_ms())
    require(launched.get("R") == launched.get("S")
            == 5 * (TRAIN_STEPS + 1),
            f"the hac --no-amp step: launches {launched}")
    out["no_amp_step"] = dict(
        ms=sum(turns["new"]) / 2, times=turns["new"],
        step_kernels_ms=sum(turns["step_kernels"]) / 2,
        step_kernels_times=turns["step_kernels"],
        batch=[F32_TRAIN_N, F32_TRAIN_CHUNK], launches_per_step={
            k: v // (TRAIN_STEPS + 1) for k, v in launched.items()})
    log(f"  one hac train --no-amp step ({F32_TRAIN_N} x {F32_TRAIN_CHUNK}, "
        f"f32 forward and master weights, AdamW), in turns: "
        f"{turns['new']} ms on R's and S's f32 persistent kernels, "
        f"{turns['step_kernels']} ms on their step kernels; launches per "
        f"step {out['no_amp_step']['launches_per_step']}")
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def sup_no_amp(torch, dev, counters):
    """One sup ``train --no-amp`` step (the shipped sup model in f32, AdamW
    2e-3, clip 2.0) at the sup train bench's batch, SUP_TRAIN_N x
    SUP_TRAIN_CHUNK, or the largest of SUP_NO_AMP_N that fits: its time
    (TRAIN_STEPS steps after a warm-up), peak memory and launches (P 2, H
    and O 18 each, U, V, Y, Z; H on the stretch kernel's f32 plan, O on its
    earlier kernel, both required), then in turns with H (and K) on their
    earlier kernel. At the first layer's inputs of that step, H in f32 in
    turns with its earlier kernel and O in f32 (earlier kernel), each with
    its plain version, its bound and the library call with TF32 off
    (rotary passes + SDPA f32 with the band as a mask, forward; its
    backward under autograd): kernel-table row 13's f32 cells. H's o is
    K's bit for bit and within one bf16 step of its largest magnitude (the
    card tests' limit for H) and ATTN_MEAN_TOL on the mean of the plain
    version and of the earlier kernel, its lse within ROW13_LSE_STEPS;
    O within one bf16 step of each output's largest magnitude."""
    import torch.nn.functional as F
    from bonito_tpu_torch.models import MODELS
    from bonito_tpu_torch.ops import attention as ops_attention
    from bonito_tpu_torch.ops import attention_cuda
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    from bonito_tpu_torch.transformer import model as transformer
    fwd = attention_cuda.fused_rotary_window_attention_train
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    model = transformer.Model(MODELS[SUP]()).init(SEED).to(dev)
    step = make_train_step(model, make_optimizer(model, 2e-3), use_amp=False)
    h_args, o_args = [], []

    def h_spy(*a, **kw):
        res = fwd(*a, **kw)
        if not h_args:
            h_args.append(a)
        return res

    def o_spy(*a, **kw):
        if not o_args:
            o_args.append(a)
        return bwd(*a, **kw)

    class Spies:
        """``attention_cuda`` as the autograd Function sees it, with H and
        O recording their first call's arguments (the wrappers, which
        count their launches, stay as they are)."""
        fused_rotary_window_attention_train = staticmethod(h_spy)
        fused_rotary_window_attention_bwd = staticmethod(o_spy)

        def __getattr__(self, name):
            return getattr(attention_cuda, name)
    batch = None
    for n in SUP_NO_AMP_N:
        rng = np.random.default_rng(SEED)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (
            rng.normal(size=(n, SUP_TRAIN_CHUNK, 1)).astype(np.float32),
            rng.integers(1, 5, (n, SUP_TRAIN_L)),
            np.full(n, SUP_TRAIN_L)))
        ops_attention.attention_cuda = Spies()
        try:
            losses, norm = step(batch, 1.0, 2.0)  # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            batch = None
            h_args.clear()
            o_args.clear()
            torch.cuda.empty_cache()
        finally:
            ops_attention.attention_cuda = attention_cuda
    require(batch is not None, f"the sup --no-amp step fits none of the "
                               f"batches {SUP_NO_AMP_N}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out_steps = [step(batch, 1.0, 2.0) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches = {k: c.launches for k, c in counters.items()}
    own = {"P": 2, "H": 18, "O": 18, "U": 1, "V": 1, "Y": 1, "Z": 1}
    expect = {k: own.get(k, 0) * TRAIN_STEPS for k in counters}
    values = [(float(l_["loss"]), float(n_)) for l_, n_ in [(losses, norm)]
              + out_steps]
    require(launches == expect and fwd.plan is not None
            and fwd.plan["dtype"] == "f32" and bwd.plan is None
            and all(math.isfinite(v) for pair in values for v in pair),
            f"the sup --no-amp step: launches {launches} (expected "
            f"{expect}), H's plan {fwd.plan}, O's {bwd.plan}, loss and "
            f"grad norm {values}")
    turns = steps_in_turns(torch, step, batch, attention_cuda, "window_plan")
    n = batch[0].shape[0]
    res = {"step": dict(
        ms=wall * 1e3, batch=[n, SUP_TRAIN_CHUNK], peak_gib=peak,
        held_gib=held / 2 ** 30, values=values, plan=fwd.plan,
        launches_per_step={k: v // TRAIN_STEPS for k, v in launches.items()
                           if v},
        turns_old_kernel=turns["old"], turns_stretch=turns["ring"])}
    log(f"  one sup train --no-amp step ({n} x {SUP_TRAIN_CHUNK}"
        f"{'' if n == SUP_TRAIN_N else ', the largest batch that fits'}, "
        f"f32 forward and master weights, AdamW): {wall * 1e3:.4g} ms = "
        f"{n * SUP_TRAIN_CHUNK / wall:.6g} train samples/s; peak memory "
        f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held; loss and "
        f"grad norm {values}; launches per step "
        f"{res['step']['launches_per_step']}; in turns, H and K on their "
        f"earlier kernel / on the stretch kernel / earlier: "
        f"{turns['old'][0]:.4g} / {turns['ring'][0]:.4g} / "
        f"{turns['old'][1]:.4g} ms")
    del model, step, batch, out_steps
    torch.cuda.empty_cache()

    # the step's own tensors, detached (the kernels refuse a graph)
    qkv, cos, sin, window, t_real = (tuple(h_args[0]) + (None,))[:5]
    qkv, cos, sin = (t_.detach() for t_ in (qkv, cos, sin))
    lse, o, do = (t_.detach() for t_ in o_args[0][3:6])
    N_, T_, _, hd, d = qkv.shape
    earlier = attention_cuda.fused_rotary_window_attention_old_kernel
    o_new, lse_new = fwd(qkv, cos, sin, window, t_real)
    o_old, lse_old = earlier(qkv, cos, sin, window, t_real, with_lse=True)
    k_new = attention_cuda.fused_rotary_window_attention(qkv, cos, sin,
                                                         window, t_real)
    (ref_o, ref_lse), plain_h = timed(torch, lambda: attention_cuda.
                                      fused_rotary_window_attention_train_plain(
                                          qkv, cos, sin, window, t_real))
    dqkv = bwd(qkv, cos, sin, lse, o, do, window, t_real)
    ref_d, plain_o = timed(torch, lambda: attention_cuda.
                           fused_rotary_window_attention_bwd_plain(
                               qkv, cos, sin, lse, o, do, window, t_real))
    torch.cuda.synchronize()
    err = {name: ((a - b).abs().max().item(), (a - b).abs().mean().item())
           for name, a, b in (("plain", o_new, ref_o), ("old", o_new, o_old),
                              ("old_plain", o_old, ref_o))}
    # H's limit of the card tests (test_fused_train_kernels_match_plain):
    # a flipped bf16 rounding of p shows in f32 o as about 2^-8 p |v|,
    # which at this step's activations passes ATTN_F32_TOL on either kernel
    o_tol = bf16_step(ref_o.abs().max().item())
    top = ref_lse.abs().max().item()
    lse_steps = max((lse_new - ref_lse).abs().max().item(),
                    (lse_new - lse_old).abs().max().item()) / 2.0 ** (
                        math.floor(math.log2(top)) - 23)
    d_err = [((dqkv[:, :, i] - ref_d[:, :, i]).abs().max().item(),
              bf16_step(ref_d[:, :, i].abs().max().item())) for i in range(3)]
    require(torch.equal(o_new, k_new) and all(
        e <= o_tol and m <= ATTN_MEAN_TOL
        for e, m in (err["plain"], err["old"]))
            and lse_steps <= ROW13_LSE_STEPS
            and all(e <= tol for e, tol in d_err),
            f"H or O in f32 at the sup --no-amp step's first layer: o equals "
            f"K's {torch.equal(o_new, k_new)}, max / mean |o - plain| "
            f"{err['plain']}, |o - earlier| {err['old']} (tolerance {o_tol} "
            f"/ {ATTN_MEAN_TOL}), lse {lse_steps} steps, dq, dk, dv (max, "
            f"tolerance) {d_err}")
    del o_new, lse_new, o_old, lse_old, k_new, ref_o, ref_lse, dqkv, ref_d
    band = attention_cuda.band_mask(T_, window, t_real, dev)
    x_l = qkv.detach().requires_grad_()

    def library_fwd():
        q = transformer.apply_rotary(x_l[:, :, 0], cos, sin)
        k = transformer.apply_rotary(x_l[:, :, 1], cos, sin)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            x_l[:, :, 2].transpose(1, 2), attn_mask=band).transpose(1, 2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o_l = library_fwd()
        turns = in_turns(torch, {
            "H": lambda: fwd(qkv, cos, sin, window, t_real),
            "H_old": lambda: earlier(qkv, cos, sin, window, t_real,
                                     with_lse=True),
            "O": lambda: bwd(qkv, cos, sin, lse, o, do, window, t_real),
            "H_library": lambda: library_fwd().detach(),
            "O_library": lambda: torch.autograd.grad(o_l, x_l, do,
                                                     retain_graph=True)},
            reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    del o_l, x_l
    pairs = N_ * hd * band_pairs(T_, window, t_real)
    plane = N_ * T_ * hd * d * 4
    trig = 2 * T_ * cos.shape[1] * 4
    lse_b = N_ * hd * T_ * 4
    # H: f32 qkv in, f32 o and lse out; O: qkv, o, do and lse in, dqkv out;
    # their products on the tensor cores (bf16 operands), about 10 f32
    # operations a pair
    bounds = {"H": bound(3 * plane + plane + lse_b + trig,
                         2 * 2 * pairs * d, H100_BF16_OPS, 10 * pairs),
              "O": bound(3 * plane + 2 * plane + lse_b + trig + 3 * plane,
                         5 * 2 * pairs * d, H100_BF16_OPS, 10 * pairs)}
    require(ms["H"] < ms["H_old"], f"H in f32 on the stretch kernel is no "
                                   f"faster than its earlier kernel: {turns}")
    res["H"] = dict(ms=ms["H"], times=turns["H"], old_kernel_ms=ms["H_old"],
                    old_kernel_times=turns["H_old"], plain_ms=plain_h,
                    bound_ms=bounds["H"][0], bound_by=bounds["H"][1],
                    library_ms=ms["H_library"],
                    library_times=turns["H_library"],
                    max_abs_err=err["plain"][0],
                    mean_abs_err=err["plain"][1],
                    max_abs_err_vs_old_kernel=err["old"][0],
                    old_kernel_max_abs_err=err["old_plain"][0],
                    tolerance=o_tol, lse_steps=lse_steps,
                    shape=[N_, T_, hd, d],
                    plan=attention_cuda.window_plan(
                        N_, T_, hd, d, window, qkv.dtype,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count))
    res["O"] = dict(ms=ms["O"], times=turns["O"], plain_ms=plain_o,
                    bound_ms=bounds["O"][0], bound_by=bounds["O"][1],
                    library_ms=ms["O_library"],
                    library_times=turns["O_library"],
                    max_abs_err=max(e for e, _ in d_err),
                    shape=[N_, T_, hd, d], plan=None)
    log(f"  at that step's first layer (N {N_}, T {T_}, {hd} heads of {d}, "
        f"f32), in turns: H {turns['H']} ms on the stretch kernel (the "
        f"earlier kernel {turns['H_old']}; plain {plain_h:.4g}, bound "
        f"{bounds['H'][0]:.4g} by {bounds['H'][1]}; max |o - plain| "
        f"{err['plain'][0]:.3g}, the earlier kernel's "
        f"{err['old_plain'][0]:.3g}, the two kernels {err['old'][0]:.3g}, "
        f"one bf16 step {o_tol:.3g}; lse {lse_steps:.3g} f32 steps), O "
        f"{turns['O']} ms on its earlier kernel (plain {plain_o:.4g}, bound "
        f"{bounds['O'][0]:.4g} by {bounds['O'][1]}; dq, dk, dv (max, one "
        f"bf16 step) {d_err}); rotary + SDPA f32 with the band, TF32 off: "
        f"forward {turns['H_library']} ms, backward {turns['O_library']} ms")
    del qkv, cos, sin, lse, o, do, band, h_args, o_args
    torch.cuda.empty_cache()
    return res


def rs32_extra(gaps, letter, src_train):
    """The kernels line's more keys of R or S in f32: its plan and its step
    kernel's time at the --no-amp batch, every RS32_SHAPES shape's numbers,
    the port's whole layer, one hac --no-amp train step."""
    main = gaps["RS_hac"]
    return {"plan": main[letter]["plan"],
            "step_kernel_ms": main[letter]["step_kernel_ms"],
            "earlier_kernel_source": src_train,
            "max_abs_err_vs_step_kernel":
                main[letter]["max_abs_err_vs_step_kernel"],
            "library_call": "torch.nn.LSTM f32 forward + backward, cuDNN, "
                            "TF32 off (library_tf32_ms: TF32 on)",
            "layer_ms": main["layer_ms"],
            "layer_step_kernels_ms": main["layer_step_kernels_ms"],
            "shapes": {key: {**gaps[f"RS_{key}"][letter],
                             "shape": gaps[f"RS_{key}"]["shape"],
                             "library_ms": gaps[f"RS_{key}"]["library_ms"],
                             "library_tf32_ms":
                                 gaps[f"RS_{key}"]["library_tf32_ms"],
                             "layer_ms": gaps[f"RS_{key}"]["layer_ms"],
                             "layer_step_kernels_ms":
                                 gaps[f"RS_{key}"]["layer_step_kernels_ms"]}
                       for key in RS32_SHAPES},
            "no_amp_step": gaps["no_amp_step"]}


def f32_eval_data(path, rows, chunk, seed):
    """An npy training set of ``rows`` chunks of ``chunk`` samples with
    references (as the train CLI reads it)."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    length = chunk // 40
    lengths = rng.integers(length // 2, length + 1, rows)
    refs = rng.integers(1, 5, (rows, length))
    refs[np.arange(length)[None] >= lengths[:, None]] = 0
    np.save(path / "chunks.npy", rng.normal(size=(rows, chunk)).astype(
        np.float16))
    np.save(path / "references.npy", refs.astype(np.uint8))
    np.save(path / "reference_lengths.npy", lengths.astype(np.uint16))
    return path


def f32_phase(torch, counters, dev, dirs, cli_reads, card):
    """Phase 15: f32 on the card (the kernels, ``evaluate`` and a
    ``--no-amp`` epoch), the basecaller to CRAM and ``duplex``."""
    from bonito_tpu_torch import cram, training
    from bonito_tpu_torch.bam import BAMWriter
    from bonito_tpu_torch.checkpoint import save_params
    from bonito_tpu_torch.cli import main as cli_main
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.crf.model import Model
    from bonito_tpu_torch.duplex import SeqRecord, call_basespace_duplex
    from bonito_tpu_torch.models import rnn_crf_config
    from bonito_tpu_torch.ops import (attention_cuda, decode_cuda, lstm_cuda,
                                      lstm_fused_cuda, lstm_train_cuda,
                                      relayout)
    from bonito_tpu_torch.util import load_model, revcomp

    log("[15] f32 on the card: A and F in f32, B and C on the f32 ring, K, "
        "H and P in f32, evaluate and train --no-amp; CRAM output and "
        "duplex")
    t_phase = time.perf_counter()
    root = Path(dirs["int8"]).parent / "chip_smoke_f32"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    launches = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        res = fn()
        torch.cuda.synchronize()
        launches[name] = {k: c.launches for k, c in counters.items()}
        return res

    def require_launches(name, want):
        full = {k: 0 for k in counters} | want
        require(launches[name] == full,
                f"{name}: launches {launches[name]}, expected {full}")

    kernels = f32_kernels(torch, dev, lstm_cuda, lstm_fused_cuda,
                          decode_cuda)
    gaps = f32_gaps(torch, dev, counters)
    sup_train = sup_no_amp(torch, dev, counters)
    launches["f32_train_sup_step"] = {
        k: sup_train["step"]["launches_per_step"].get(k, 0)
        for k in counters}
    t_kernels = time.perf_counter() - t_phase

    # (b) evaluate, f32 (half=False), on the card and with --device cpu
    old = root / "old_style"
    old.mkdir()
    cfg = rnn_crf_config()
    model = Model(cfg).init(SEED)
    _, (_, crf), _ = model.decode_head()
    with torch.no_grad():
        crf.w.mul_(CRF_SCALE)
    save_config(cfg, old / "config.toml")
    save_params(old / "weights_1.npz", model)
    del model
    data = f32_eval_data(root / "eval_data", F32_RATE_CHUNKS, F32_EVAL_LEN,
                         SEED + 15)
    evaluate, plans = {}, {}
    for name, model_dir, layer in (("hac", dirs["bf16"], "A"),
                                   ("fast", dirs["fast_bf16"], "F"),
                                   ("old_style", old, "A")):
        seqs, rates = {}, {}
        for where in ("card", "cpu"):
            buf = io.StringIO()
            argv = ["evaluate", str(model_dir), "--directory", str(data),
                    "--chunks", str(F32_EVAL_CHUNKS), "--batchsize",
                    str(F32_EVAL_BATCH), "--output-dir",
                    str(root / f"eval_{name}_{where}")]
            if where == "cpu":
                argv += ["--device", "cpu"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if where == "card":
                    counted(f"f32_evaluate_{name}", lambda: cli_main(argv))
                else:
                    cli_main(argv)
            wall = time.perf_counter() - t0
            report = buf.getvalue()
            rates[where] = (wall, next(line for line in report.splitlines()
                                       if line.startswith("* samples/s")))
            seqs[where] = (root / f"eval_{name}_{where}" / "seqs.fasta"
                           ).read_text().splitlines()[1::2]
        batches = F32_EVAL_CHUNKS // F32_EVAL_BATCH
        require_launches(f"f32_evaluate_{name}",
                         {layer: 5 * batches, "M": batches, "Q": batches})
        differ = sum(a != b for a, b in zip(seqs["card"], seqs["cpu"]))
        bases = sum(map(len, seqs["card"]))
        require(len(seqs["card"]) == len(seqs["cpu"]) == F32_EVAL_CHUNKS
                and differ <= F32_EVAL_MAX_DIFFER * F32_EVAL_CHUNKS,
                f"evaluate {name}: {differ} of {F32_EVAL_CHUNKS} chunks "
                f"called otherwise on the card than on the CPU")
        # one batch's scores from the card, decoded on the card (M, Q) and
        # on the CPU (the plain versions): the same calls
        m = load_model(model_dir, half=False, device=dev)
        x = torch.from_numpy(np.load(data / "chunks.npy")[:F32_EVAL_BATCH]
                             .astype(np.float32))[..., None].to(dev)
        with torch.inference_mode():
            scores = m(x)
            on_card = m.decode_batch(scores)
            on_cpu = m.decode_batch(scores.cpu())
        require(on_card == on_cpu, f"evaluate {name}: one batch's scores "
                                   f"decode otherwise on the card and CPU")
        del m, scores
        # the rate: evaluate's defaults (512 chunks, two batches of 256) on
        # the card
        buf = io.StringIO()
        path = f"f32_evaluate_{name}_b{F32_RATE_BATCH}"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted(path, lambda: cli_main([
                "evaluate", str(model_dir), "--directory", str(data),
                "--output-dir", str(root / f"eval_{name}_rate")]))
        wall = time.perf_counter() - t0
        batches = F32_RATE_CHUNKS // F32_RATE_BATCH
        require_launches(path, {layer: 5 * batches, "M": batches,
                                "Q": batches})
        # the layers ran the new f32 kernels: A's persistent kernel, one
        # launch a layer at N 256, or F's f32 kernel
        ran = (lstm_cuda.lstm_recurrence if layer == "A"
               else lstm_fused_cuda.lstm_fused).plan
        require(ran is not None and ran["dtype"] == "f32"
                and ran.get("launches", 1) == 1,
                f"evaluate {name} at its defaults: {layer}'s plan {ran}")
        plans[name] = ran
        rates["card_default"] = (wall, next(
            line for line in buf.getvalue().splitlines()
            if line.startswith("* samples/s")))
        evaluate[name] = dict(differ=differ, chunks=F32_EVAL_CHUNKS,
                              bases=bases, card=rates["card"],
                              cpu=rates["cpu"],
                              card_default=rates["card_default"],
                              plan=plans[name])
        log(f"  evaluate {name} (f32, {F32_EVAL_CHUNKS} chunks of "
            f"{F32_EVAL_LEN}, batch {F32_EVAL_BATCH}): card {rates['card'][1]}"
            f" ({rates['card'][0]:.1f} s with the load), cpu "
            f"{rates['cpu'][1]} ({rates['cpu'][0]:.1f} s); {differ} of "
            f"{F32_EVAL_CHUNKS} chunks called otherwise ({bases} bases on "
            f"the card); one batch's card scores decode alike on both; "
            f"launches {({k: v for k, v in launches['f32_evaluate_' + name].items() if v})}; "
            f"at evaluate's defaults ({F32_RATE_CHUNKS} chunks, batch "
            f"{F32_RATE_BATCH}) on the card {rates['card_default'][1]} "
            f"({rates['card_default'][0]:.1f} s with the load), {layer} on "
            f"the plan {plans[name]}")
    # sup (the transformer-CRF, P, 18 x K, M, Q a batch) through evaluate
    # at its defaults on the card: K on the stretch kernel's f32 plan, P on
    # the tiles (T 250)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        counted("f32_evaluate_sup_b256", lambda: cli_main([
            "evaluate", str(dirs["sup"]), "--directory", str(data),
            "--output-dir", str(root / "eval_sup_rate")]))
    wall = time.perf_counter() - t0
    batches = F32_RATE_CHUNKS // F32_RATE_BATCH
    require_launches("f32_evaluate_sup_b256", {
        "P": batches, "K": 18 * batches, "M": batches, "Q": batches})
    k_plan = attention_cuda.fused_rotary_window_attention.plan
    p_plan = relayout.pin_layout.plan
    require(k_plan is not None and k_plan["dtype"] == "f32"
            and p_plan[0] == "tiles",
            f"evaluate sup at its defaults: K's plan {k_plan}, P's {p_plan}")
    rate = next(line for line in buf.getvalue().splitlines()
                if line.startswith("* samples/s"))
    evaluate["sup"] = dict(card_default=(wall, rate), plan=k_plan,
                           p_plan=p_plan[0])
    log(f"  evaluate sup (f32) at evaluate's defaults ({F32_RATE_CHUNKS} "
        f"chunks of {F32_EVAL_LEN}, batch {F32_RATE_BATCH}) on the card: "
        f"{rate} ({wall:.1f} s with the load); launches "
        f"{({k: v for k, v in launches['f32_evaluate_sup_b256'].items() if v})}"
        f"; K on the plan {k_plan}, P on the {p_plan[0]}")
    torch.cuda.empty_cache()

    # (c) train --no-amp: one epoch with its validation, hac and fast
    valid_time = []
    validate = training.Trainer.validate_one_epoch

    def timed_validation(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = validate(self)
        torch.cuda.synchronize()
        valid_time.append(time.perf_counter() - t0)
        return res
    train = {}
    training.Trainer.validate_one_epoch = timed_validation
    try:
        for name, config, layer in (("hac", HAC, "A"), ("fast", FAST, "F")):
            own = {"R": 5, "S": 5, "U": 1, "V": 1, "Y": 1, "Z": 1}
            res = train_cli(
                torch, counters, config, F32_TRAIN_N, F32_TRAIN_CHUNK,
                F32_TRAIN_L, F32_TRAIN_BATCHES, own,
                {layer: 5, "U": 1, "Y": 1, "B": 1, "C": 1},
                f"f32_{name}", extra=["--no-amp"])
            require(decode_cuda.tcn_forward.plan is not None
                    and decode_cuda.tcn_backward.plan is not None,
                    f"--no-amp validation of {name}: B or C took an earlier "
                    f"kernel")
            # the epoch's steps ran R and S on their f32 persistent kernels
            rs = (lstm_train_cuda.lstm_train_forward.plan,
                  lstm_train_cuda.lstm_train_backward.plan)
            require(None not in rs and rs[0]["dtype"] == rs[1]["dtype"]
                    == "f32", f"train --no-amp {name}: R's and S's plans "
                              f"{rs}")
            res["plans"] = list(rs)
            res["validation_s"] = valid_time[-1]
            launches[f"f32_train_{name}"] = res["launches"]
            train[name] = res
            log(f"  train --no-amp {name}: validation {valid_time[-1]:.3f} s "
                f"(one batch of {F32_TRAIN_N} x {F32_TRAIN_CHUNK}: the f32 "
                f"forward through {layer}, loss_tcn, B and C on the f32 "
                f"ring)")
    finally:
        training.Trainer.validate_one_epoch = validate
    torch.cuda.empty_cache()

    # (d) the basecaller to CRAM from phase 12's hac reads, with and
    # without --reference, beside BAM
    outs, walls, rates = {}, {}, {}

    def basecall_to(tag, ext, *more):
        out = root / f"{tag}_out" / f"out.{ext}"
        out.parent.mkdir()
        walls[tag], err = counted(f"cram_cli_{tag}", lambda: run_cli(
            cli_main, ["basecaller", str(dirs["int8"]), str(cli_reads),
                       "--n-proc", str(CLI_PROCS), "--output-dir",
                       str(out.parent), *more], out))
        rates[tag] = next(line for line in err.splitlines()
                          if "samples per second" in line)
        outs[tag] = out
        return out
    basecall_to("bam", "bam")
    basecall_to("cram", "cram")
    records = list(cram.CramReader(outs["cram"].read_bytes()))
    bam_recs = bam_records(outs["bam"].read_bytes())
    require(len(records) == len(bam_recs) and all(
        (r.name, r.seq, r.qual) == (b["name"], b["seq"], b["qual"])
        for r, b in zip(records, bam_recs)),
            "the CRAM's records are not the BAM's")
    mv = sum(1 for r in records for t in r.tags if t.startswith("mv:"))
    require(mv == len(records), "a CRAM record without its mv tag")
    fasta = root / "calls.fasta"
    fasta.write_text("".join(f">ctg{i}\n{r.seq}\n"
                             for i, r in enumerate(records)))
    basecall_to("cram_ref", "cram", "--reference", str(fasta))
    aligned = list(cram.CramReader(outs["cram_ref"].read_bytes(),
                                   reference=str(fasta)))
    require(sorted((r.name, r.seq, r.qual) for r in aligned)
            == sorted((r.name, r.seq, r.qual) for r in records)
            and all(r.ref_id >= 0 for r in aligned),
            "the reference-based CRAM does not decode to the calls, each "
            "mapped")
    sizes = {k: v.stat().st_size for k, v in outs.items()}
    log(f"  basecaller to CRAM ({len(records)} hac reads, int8 as shipped): "
        f"referenceless {sizes['cram']} B, reference-based "
        f"{sizes['cram_ref']} B, BAM {sizes['bam']} B; every CRAM record "
        f"the BAM's; rates: BAM {rates['bam']} ({walls['bam']:.1f} s), "
        f"CRAM {rates['cram']} ({walls['cram']:.1f} s), CRAM --reference "
        f"{rates['cram_ref']} ({walls['cram_ref']:.1f} s)")

    # (e) duplex on that BAM and CRAM (pairs of the basecalled reads), and
    # on a BAM and CRAM of the calls with their complement strands (each
    # call's reverse complement, qualities reversed), fastq and SAM
    calls = [(r.name, r.seq, r.qual) for r in records]
    comp = {}
    for ext, writer in (("bam", BAMWriter), ("cram", cram.CramWriter)):
        comp[ext] = root / f"with_complements.{ext}"
        with open(comp[ext], "wb") as f:
            w = writer(f, "@HD\tVN:1.6\tSO:unknown\n", [])
            for name, seq, qual in calls:
                w.write(name, seq, qual)
                w.write(f"{name}_c", revcomp(seq), qual[::-1])
            w.close()
    ids = [name for name, _, _ in calls]
    # pairs of unrelated calls: the global alignment of two reads of tens
    # of kilobases is what a pair costs, so 4 of them
    cases = {"calls": (list(zip(ids[0:8:2], ids[1:8:2])),
                       {"bam": outs["bam"], "cram": outs["cram"]}),
             "complements": ([(i, f"{i}_c") for i in ids], comp)}
    by_name = {name: SeqRecord(name, seq, qual) for name, seq, qual in calls}
    duplex = {}
    for case, (pairs, inputs) in cases.items():
        want = {}
        for a, b in pairs:
            t = by_name[a]
            c = by_name.get(b) or SeqRecord(b, revcomp(t.sequence),
                                            t.qstring[::-1])
            res = call_basespace_duplex(t, c)
            if res["sequence"]:
                want[f"{a};{b}"] = (res["sequence"], res["qstring"])
        pairs_file = root / f"pairs_{case}.txt"
        pairs_file.write_text("template complement\n" + "".join(
            f"{a} {b}\n" for a, b in pairs))
        for src, path in inputs.items():
            for ext in ("fastq", "sam"):
                out = root / f"duplex_{case}_{src}" / f"out.{ext}"
                out.parent.mkdir(exist_ok=True)
                wall, err = counted(f"duplex_{case}_{src}_{ext}",
                                    lambda: run_cli(cli_main, [
                                        "duplex", str(path), str(pairs_file),
                                        "--threads",
                                        str(F32_DUPLEX_THREADS)], out))
                require(not any(launches[f"duplex_{case}_{src}_{ext}"]
                                .values()), "duplex launched a kernel")
                del launches[f"duplex_{case}_{src}_{ext}"]
                lines = out.read_text().splitlines()
                if ext == "fastq":
                    got = {lines[i][1:].split()[0]: (lines[i + 1],
                                                     lines[i + 3])
                           for i in range(0, len(lines), 4)}
                else:
                    got = {f[0]: (f[9], f[10]) for f in (
                        line.split("\t") for line in lines
                        if not line.startswith("@"))}
                require(got == want, f"duplex ({case}, {src} to {ext}): "
                                     f"{len(got)} records, not the "
                                     f"{len(want)} of call_basespace_duplex")
                duplex[f"{case}_{src}_{ext}"] = dict(
                    records=len(got), pairs=len(pairs), wall=wall,
                    bases=sum(len(s) for s, _ in got.values()))
        log(f"  duplex ({case}: {len(pairs)} pairs, BAM and CRAM in, fastq "
            f"and SAM out, {F32_DUPLEX_THREADS} spawned workers): "
            f"{len(want)} consensus records each, equal to "
            f"call_basespace_duplex in process ("
            f"{sum(len(s) for s, _ in want.values())} bases); walls "
            f"{', '.join(f'{k} {v["wall"]:.1f} s' for k, v in duplex.items() if k.startswith(case))}")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 15 took {phase_s:.1f} s (its kernels {t_kernels:.1f} s)")
    return {"launches": launches, "kernels": kernels, "gaps": gaps,
            "sup_train": sup_train, "evaluate": evaluate,
            "train": {k: {"validation_s": v["validation_s"],
                          "wall": v["wall"], "fields": v["fields"]}
                      for k, v in train.items()},
            "cram": {"sizes": sizes, "rates": rates, "walls": walls},
            "duplex": duplex, "phase_s": phase_s}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from bonito_tpu_torch import checkpoint
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.crf import basecall as crf_basecall
    from bonito_tpu_torch.crf.basecall import basecall, make_compute_fn
    from bonito_tpu_torch.crf.model import HeadSplit, Model
    from bonito_tpu_torch.models import (MODELS, lstm_crf_config,
                                         transformer_crf_config)
    from bonito_tpu_torch.ops import (attention_cuda, build, decode_cuda,
                                      decode_full_cuda, decode_fused_cuda,
                                      int8, lattice_cuda, logz_cuda,
                                      lstm_cuda, lstm_fused_cuda,
                                      lstm_int8_cuda, relayout)
    from bonito_tpu_torch.ops import decode as ops_decode
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.transformer import model as transformer
    from bonito_tpu_torch.util import chunk, load_model

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1] card: {card}; torch.cuda: {kind} x {count}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    require(count >= 1, "no CUDA device counted")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"[2] built {Path(lib_path).name} in {time.perf_counter() - t0:.1f} s")
    ptxas_rows = ptxas_summary(build.ptxas_report)
    for row in ptxas_rows:
        log(row)
    o_rows = [r for r in ptxas_rows if "window_attention_bwd_kernel" in r]
    require(len(o_rows) == 3 and all("stack 0 B, spills 0/0 B" in r
                                     for r in o_rows),
            f"kernel O's stretch kernel has a stack frame or spills: {o_rows}")
    # K's and H's stretch kernel, bf16 and f32 at three head dims; P's tiles
    k_rows = [r for r in ptxas_rows
              if r.lstrip().startswith("window_attention_kernel<")]
    p_rows = [r for r in ptxas_rows if "relayout_transpose_tiles" in r]
    require(len(k_rows) == 12 and len(p_rows) == 4
            and all("stack 0 B, spills 0/0 B" in r for r in k_rows + p_rows),
            f"K's and H's stretch kernel or P's tiles have a stack frame or "
            f"spills (or not 12 and 4 instances): {k_rows} {p_rows}")
    ring_rows = [r for r in ptxas_rows if "decode_" in r
                 and "_ring_kernel" in r]
    require(len(ring_rows) == 12 and all("stack 0 B, spills 0/0 B" in r
                                         for r in ring_rows),
            f"kernels B, C, M, Q and GW's and JW's passes on the ring have a "
            f"stack frame or spills (or not twelve instances): {ring_rows}")
    hp_rows = [r for r in ptxas_rows if "head_product_kernel" in r]
    require(len(hp_rows) == 1 and "stack 0 B, spills 0/0 B" in hp_rows[0],
            f"GW's head product has a stack frame or spills: {hp_rows}")
    # U: bf16 or f32 moves, rounded or not, with or without the stack, 1 or
    # 4 states a thread; V: the same with a bf16 or f32 gradient
    logz_rows = [r for r in ptxas_rows if "logz_" in r
                 and "_ring_kernel" in r and "logz_full" not in r]
    require(len(logz_rows) == 32 and all("stack 0 B, spills 0/0 B" in r
                                         for r in logz_rows),
            f"kernels U and V on the ring have a stack frame or spills (or "
            f"not 32 instances): {logz_rows}")

    # F's mma kernel at C = H from 16 to 96; J's ring at H 32 (U 1 and 2)
    # and 96 (U 1, the fast head, whose head warps spill J_SPILL_MAX bytes)
    f_rows = [r for r in ptxas_rows if "lstm_fused_mma_kernel" in r]
    require(len(f_rows) == 6 and all("stack 0 B, spills 0/0 B" in r
                                     for r in f_rows),
            f"kernel F's mma kernel has a stack frame or spills (or not six "
            f"instances): {f_rows}")
    j_rows = [r for r in ptxas_rows if "decode_fused_bwd_ring" in r]
    j_frames = [tuple(int(v) for v in re.search(
        r"stack (\d+) B, spills (\d+)/(\d+) B", r).groups()) for r in j_rows]
    require(len(j_rows) == 3 and all(
        max(f) <= (J_SPILL_MAX if "H=96" in r else 0)
        for r, f in zip(j_rows, j_frames)),
            f"kernel J's ring: a stack frame or spills above "
            f"{J_SPILL_MAX} B at H 96 or any at H 32 (or not three "
            f"instances): {j_rows}")
    # G's ring at J's instances, held to J's limit
    g_rows = [r for r in ptxas_rows if "decode_fused_fwd_ring" in r]
    g_frames = [tuple(int(v) for v in re.search(
        r"stack (\d+) B, spills (\d+)/(\d+) B", r).groups()) for r in g_rows]
    require(len(g_rows) == 3 and all(
        max(f) <= (J_SPILL_MAX if "H=96" in r else 0)
        for r, f in zip(g_rows, g_frames)),
            f"kernel G's ring: a stack frame or spills above "
            f"{J_SPILL_MAX} B at H 96 or any at H 32 (or not three "
            f"instances): {g_rows}")
    # Z split over warps: 1 or 2 positions a thread, two depths each
    z_rows = [r for r in ptxas_rows if "lattice_bwd_split_kernel" in r]
    require(len(z_rows) == 4 and all("stack 0 B, spills 0/0 B" in r
                                     for r in z_rows),
            f"kernel Z split over warps has a stack frame or spills (or not "
            f"four instances): {z_rows}")
    # Y split over warps: 1 or 2 positions a thread, with the stack and
    # without; X on the ring: bf16 or f32 in and out, rounded or not, 1 or 4
    # predecessors a thread; W on the ring: bf16 or f32 in, rounded or not,
    # with the stack or without, 1 or 4 states a thread
    y_rows = [r for r in ptxas_rows if "lattice_fwd_split_kernel" in r]
    x_rows = [r for r in ptxas_rows if "logz_full_bwd_ring_kernel" in r]
    w_rows = [r for r in ptxas_rows if "logz_full_fwd_ring_kernel" in r]
    require(len(y_rows) == 4 and len(x_rows) == 16 and len(w_rows) == 16
            and all("stack 0 B, spills 0/0 B" in r
                    for r in y_rows + x_rows + w_rows),
            f"kernel Y split over warps or W or X on the ring has a stack "
            f"frame or spills (or not 4, 16 and 16 instances): {y_rows} "
            f"{x_rows} {w_rows}")

    log(f"[3] kernels vs plain at hac widths (N={N}, T={T}, C=H={H}, S={S})")
    xw, w_hh, err_a = check_lstm(torch, lstm_cuda, dev)
    d_args, e_args, err_int8, int8_plans = check_lstm_int8(
        torch, int8, lstm_int8_cuda, dev)
    moves, blank, fwd, err_b, err_c, plan_bc, bc_vs_old = check_decode(
        torch, decode_cuda, dev)
    err_m, err_q, vs_old_mq = check_decode_full(torch, decode_full_cuda, dev)
    log(f"    and at fast widths (N={FN}, T={FT}, C=H={FH}, S={FS})")
    f_args, err_f, plan_f, f_vs_old = check_lstm_fused(torch, lstm_fused_cuda,
                                                       dev)
    f_head, f_fwd, err_g, err_j, plans_gj, gj_vs_old = check_decode_fused(
        torch, decode_fused_cuda, HeadSplit, dev)
    log(f"    and at sup widths (N={SN}, T={ST}, H={SH}, D={SD}, window "
        f"{SWIN})")
    attn_args, err_attn = check_attention(torch, attention_cuda, transformer,
                                          dev)
    pin_view, err_p = check_pin(torch, relayout, dev)
    log(f"    and the fused-head decode at {S} states (GW, JW) on random "
        f"heads of hac's and sup's widths")
    err_gw, err_jw, wide_vs_old = check_decode_fused_wide(
        torch, decode_fused_cuda, HeadSplit, dev)

    log("[4] hac, fast and sup model directories from the port's own code")
    dirs = {}
    for name, quantize, scale in (("bf16", False, CRF_SCALE),
                                  ("int8", True, CRF_SCALE),
                                  ("fast_bf16", False, FAST_CRF_SCALE),
                                  ("fast", True, FAST_CRF_SCALE),
                                  ("sup", None, SUP_CRF_SCALE),
                                  ("sup_d40", None, SUP_CRF_SCALE)):
        model_dir = build.BUILD / f"chip_smoke_{name}"
        if model_dir.exists():
            shutil.rmtree(model_dir)
        model_dir.mkdir(parents=True)
        if name.startswith("sup"):
            cfg = (MODELS[SUP]() if name == "sup"
                   else transformer_crf_config(**D40))
            require("quantize" not in cfg["basecaller"],
                    "the sup config names a quantize default")
            model = transformer.Model(cfg).init(SEED)
            with torch.no_grad():
                model.encoder.crf.w.mul_(scale)
            save_config(cfg, model_dir / "config.toml")
            checkpoint.save_params(model_dir / "weights_1.npz", model)
            dirs[name] = model_dir
            del model
            continue
        cfg = MODELS[FAST]() if name.startswith("fast") else lstm_crf_config()
        require(cfg["basecaller"]["quantize"] is True,
                "the config's default is no longer quantize=true")
        cfg["basecaller"]["quantize"] = quantize
        model = Model(cfg).init(SEED)
        _, (_, crf), _ = model.decode_head()
        with torch.no_grad():
            crf.w.mul_(scale)
        save_config(cfg, model_dir / "config.toml")
        checkpoint.save_params(model_dir / "weights_1.npz", model)
        dirs[name] = model_dir
        del model

    log("[5] load_model + basecall on the card, thirteen paths")
    rng = np.random.default_rng(SEED)
    lengths = np.concatenate([[3000, 9000], rng.integers(20000, 110000, 142)])
    reads = [Read(f"read{i}", rng.normal(size=int(n)).astype(np.float32))
             for i, n in enumerate(lengths)]
    # fast: chunks of 6000 at a step of 5500; 160 reads of 100k to 220k
    # samples make about 4600 chunks, over 4 full batches of 1024
    lengths = np.concatenate([[3000, 9000], rng.integers(100000, 220000, 158)])
    fast_reads = [Read(f"fast{i}", rng.normal(size=int(n)).astype(np.float32))
                  for i, n in enumerate(lengths)]
    counters = kernel_counters()
    models = {
        name: load_model(dirs[src], half=True, fuse_bn=True, quantize=None,
                         device="cuda", **kw)
        for name, src, kw in (("bf16", "bf16", {}), ("int8", "int8", {}),
                              ("two_stage", "int8", {"route": "two_stage"}),
                              ("fast", "fast", {}),
                              ("fast_bf16", "fast_bf16", {}),
                              ("sup", "sup", {}), ("sup_d40", "sup_d40", {}))}
    # inference only: these paths' kernels keep no autograd graph and refuse
    # an input that wants a gradient, so the weights want none
    for m in models.values():
        m.requires_grad_(False)
    lstms = [m for m in models["int8"].encoder.modules()
             if hasattr(m, "quantize_params")]
    require(len(lstms) == 5 and all(
        m.quantized and m.int8_out and m.w_hh_q.dtype == torch.int8
        for m in lstms), "the default directory did not load quantised")
    require(not any(m.quantized for m in models["bf16"].encoder.modules()
                    if hasattr(m, "quantize_params")),
            "quantize=false in the config was not honoured")
    fast_lstms = [m for m in models["fast"].encoder.modules()
                  if hasattr(m, "quantize_params")]
    require(len(fast_lstms) == 5 and all(
        m.quantized and ops_lstm.int8_route(
            torch.empty(1, 1, FH, dtype=torch.bfloat16), m.w_hh_q,
            m.w_ih_q) == "dequant" for m in fast_lstms),
        "the fast directory did not load quantised on the dequant route")
    sup_layers = [m for m in models["sup"].modules()
                  if isinstance(m, transformer.TransformerEncoderLayer)]
    require(len(sup_layers) == 18 and models["sup"].compute_dtype
            == torch.bfloat16 and models["sup"].seqdist.n_states == S
            and all(m.self_attn.route(torch.empty(1, 9, 3, SH, SD)) == "fused"
                    for m in sup_layers),
            "the sup directory did not load as 18 bf16 layers on the fused "
            "attention route")
    d40_layers = [m for m in models["sup_d40"].modules()
                  if isinstance(m, transformer.TransformerEncoderLayer)]
    require(len(d40_layers) == 2 and all(
        m.self_attn.route(torch.empty(1, 9, 3, 8, 40)) == "local"
        for m in d40_layers),
        "the shallow transformer's heads do not take the local route")
    hac_geometry, fast_geometry = (9996, 492, 96), (6000, 500, FN)
    # sup: chunks of 12000 at a step of 11400; 40 reads of 100k to 220k
    # samples make about 570 chunks, over 4 full batches of 128
    paths = {"bf16": (reads[:48], hac_geometry),
             "int8": (reads[:144], hac_geometry),
             "two_stage": (reads[:20], hac_geometry),
             "fast": (fast_reads, fast_geometry),
             "fast_bf16": (fast_reads[:40], fast_geometry),
             "sup": (fast_reads[:42], (12000, 600, SN)),
             "sup_d40": (fast_reads[:7], (12000, 600, 32))}
    runs = {name: run_path(torch, name, models[name], rds, counters, basecall,
                           chunk, geometry)
            for name, (rds, geometry) in paths.items()}
    # the full-score paths: the reverse strand (M, Q) of hac as shipped, of
    # fast (S 64) and of sup (T 2000 behind P and 18 x K), and the beam
    sup_geometry = (12000, 600, SN)
    full_paths = {
        "rev": ("int8", reads[:48], hac_geometry, dict(reverse=True)),
        "fast_rev": ("fast", first_reads(fast_reads, chunk, fast_geometry, FN),
                     fast_geometry, dict(reverse=True)),
        "sup_rev": ("sup", first_reads(fast_reads, chunk, sup_geometry, SN),
                    sup_geometry, dict(reverse=True)),
        "beam": ("int8", first_reads(reads[2:], chunk, hac_geometry, N),
                 hac_geometry, dict(decoder="beam"))}
    for name, (model, rds, geometry, kw) in full_paths.items():
        runs[name] = run_path(torch, name, models[model], rds, counters,
                              basecall, chunk, geometry, **kw)
    # the fused-head decode at 1024 states (GW, JW): hac as shipped and sup
    # with head_route="fused", over at least 2 full batches each
    fused_paths = {
        "hac_fused": ("int8", first_reads(reads, chunk, hac_geometry, 2 * N),
                      hac_geometry),
        "sup_fused": ("sup", first_reads(fast_reads, chunk, sup_geometry,
                                         2 * SN), sup_geometry)}
    for name, (model, rds, geometry) in fused_paths.items():
        runs[name] = run_path(torch, name, models[model], rds, counters,
                              basecall, chunk, geometry, head_route="fused")
    for name, n in (("fast", 4), ("sup", 3), ("rev", 3), ("fast_rev", 1),
                    ("sup_rev", 1), ("beam", 1), ("hac_fused", 2),
                    ("sup_fused", 2)):
        require(runs[name]["full_batches"] >= n,
                f"the {name} path ran fewer than {n} full batches")

    # one batch's move scores: kernel D's chain against its plain version's
    prepared, step_int8 = device_step(np, models["int8"], reads,
                                      make_compute_fn, chunk)
    with earlier_kernel(decode_cuda, "decode_plan"):
        _, step_int8_bc_old = device_step(np, models["int8"], reads,
                                          make_compute_fn, chunk)
    prepared_bf16, step_bf16 = device_step(np, models["bf16"], reads,
                                           make_compute_fn, chunk)
    _, x_wire, sig_scale = prepared
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        mv_kernel, _ = models["int8"].forward_tcn(xc[..., None])
        ops_lstm.lstm_int8_fused = lstm_int8_cuda.lstm_int8_fused_plain
        try:
            mv_plain, _ = models["int8"].forward_tcn(xc[..., None])
        finally:
            ops_lstm.lstm_int8_fused = lstm_int8_cuda.lstm_int8_fused
        diff = (mv_kernel.float() - mv_plain.float()).abs()
        worst, mean = diff.max().item(), diff.mean().item()
    log(f"  int8 path, one batch's moves {tuple(mv_kernel.shape)} through "
        f"kernel D vs its plain version: max |diff| {worst:.3g}, mean "
        f"{mean:.3g} (tolerance 0.5 / 1e-3); all finite: "
        f"{torch.isfinite(mv_kernel.float()).all().item()}")
    require(torch.isfinite(mv_kernel.float()).all().item(),
            "int8 path: non-finite move scores")
    require(worst <= 0.5 and mean <= 1e-3,
            "int8 path: the kernels' moves disagree with the plain versions'")
    del mv_kernel, mv_plain, diff

    # one hac bf16 batch: its five layers through kernel A against the same
    # batch with A's plain version in A's place, and both decodes (B + C)
    _, x_wire, sig_scale = prepared_bf16
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        before = lstm_cuda.lstm_recurrence.launches
        mv_kernel, hac_blank = models["bf16"].forward_tcn(xc[..., None])
        n_a = lstm_cuda.lstm_recurrence.launches - before
        ops_lstm.lstm_recurrence = lstm_cuda.lstm_recurrence_plain
        try:
            mv_plain, _ = models["bf16"].forward_tcn(xc[..., None])
        finally:
            ops_lstm.lstm_recurrence = lstm_cuda.lstm_recurrence
        diff = (mv_kernel.float() - mv_plain.float()).abs()
        worst, mean = diff.max().item(), diff.mean().item()
        n_diff, n_all, _ = decodes_differ(
            torch, models["bf16"], mv_kernel, mv_plain, hac_blank, ops_decode,
            qscale=1.05, qbias=0.2)
    log(f"  hac bf16 path, one batch's moves {tuple(mv_kernel.shape)} "
        f"through {n_a} launches of kernel A vs its plain version: max "
        f"|diff| {worst:.3g}, mean {mean:.3g} (tolerance {HAC_MOVES_MAX} / "
        f"{HAC_MOVES_MEAN}); the two decodes differ on {n_diff} of {n_all} "
        f"frames (at most {1 - HAC_MIN_EQUAL:.1%} may)")
    require(n_a == 5, f"hac bf16 path: {n_a} launches of A, expected 5")
    require(torch.isfinite(mv_kernel.float()).all().item(),
            "hac bf16 path: non-finite move scores")
    require(worst <= HAC_MOVES_MAX and mean <= HAC_MOVES_MEAN
            and n_diff <= (1 - HAC_MIN_EQUAL) * n_all,
            "hac bf16 path: kernel A's moves disagree with its plain "
            "version's")
    del mv_kernel, mv_plain, diff

    # one batch on each reverse path (hac, fast): its full scores read in
    # reverse-complement order in place through M + Q, held against their
    # plain versions, their earlier kernels and M + Q on the copy; and for
    # hac the share of rows whose reverse call is the forward call's reverse
    # complement shifted by state_len (tests/test_seqdist.py's property)
    prepared, step_rev = device_step(np, models["int8"], reads,
                                     make_compute_fn, chunk, reverse=True)
    rev_steps = {"rev": {"step": step_rev}}
    for name, route in (("copy", False), ("copy_old", True)):
        with parent_reverse(crf_basecall, decode_full_cuda, route):
            _, rev_steps["rev"][name] = device_step(
                np, models["int8"], reads, make_compute_fn, chunk,
                reverse=True)
    _, step_beam = device_step(np, models["int8"], reads, make_compute_fn,
                               chunk, decoder="beam")
    _, x_wire, sig_scale = prepared
    sd = models["int8"].seqdist
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
    scores, out_kernel, h = hold_reverse_batch(
        torch, decode_full_cuda, models["int8"], xc, "hac", qscale=1.05,
        qbias=0.2)
    with torch.inference_mode():
        out_fwd = ops_decode.viterbi_decode(sd, scores)
    comp = dict(zip("ACGT", "TGCA"))
    shifted = 0
    for a, b in zip(out_fwd["sequence"].cpu().numpy(),
                    out_kernel["sequence"].cpu().numpy()):
        f, r = sd.path_to_str(a), sd.path_to_str(b)
        expect = "".join(comp[c] for c in reversed(f))
        k = sd.state_len
        shifted += len(r) == len(f) and r[:len(r) - k] == expect[k:]
    log(f"    {shifted} of {N} rows call the shifted reverse complement of "
        f"the forward strand's call (not required: a random bf16 model's "
        f"paths tie)")
    err_m, err_q = max(err_m, h["err_in"]), max(err_q, float(h["dq"]))
    vs_old_mq = max(vs_old_mq, h["vs_old"])
    del scores, out_kernel, out_fwd
    prepared, step_fast_rev = device_step(np, models["fast"], fast_reads,
                                          make_compute_fn, chunk,
                                          reverse=True)
    rev_steps["fast_rev"] = {"step": step_fast_rev}
    with parent_reverse(crf_basecall, decode_full_cuda, True):
        _, rev_steps["fast_rev"]["copy_old"] = device_step(
            np, models["fast"], fast_reads, make_compute_fn, chunk,
            reverse=True)
    with earlier_kernel(lstm_fused_cuda, "fused_plan"):
        _, rev_steps["fast_rev"]["f_old"] = device_step(
            np, models["fast"], fast_reads, make_compute_fn, chunk,
            reverse=True)
    _, x_wire, sig_scale = prepared
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
    _, _, h = hold_reverse_batch(torch, decode_full_cuda, models["fast"], xc,
                                 "fast", qscale=1.05, qbias=0.2)
    err_m, err_q = max(err_m, h["err_in"]), max(err_q, float(h["dq"]))
    vs_old_mq = max(vs_old_mq, h["vs_old"])

    # one fast batch: the encoder through kernel F against F's plain version
    # in its place, then the kernels' head through G + J against their plain
    # versions. Five layers, each within LSTM_ATOL / LSTM_MEAN_TOL of its
    # plain version on the same input, compound: five times those.
    prepared, step_fast = device_step(np, models["fast"], fast_reads,
                                      make_compute_fn, chunk)
    # the same batch with F and J on their earlier kernels (the parent's)
    with earlier_kernel(lstm_fused_cuda, "fused_plan"), \
            earlier_kernel(decode_fused_cuda, "fused_decode_plan", "bwd"):
        _, step_fast_old = device_step(np, models["fast"], fast_reads,
                                       make_compute_fn, chunk)
    _, step_fast_tcn = device_step(np, models["fast"], fast_reads,
                                   make_compute_fn, chunk, head_route="tcn")
    # G on its earlier kernel (the parent's route) and on the ring, in turns
    g_turns = {"old": [], "ring": []}
    for route in ("old", "ring", "old", "ring"):
        if route == "old":
            with earlier_kernel(decode_fused_cuda, "fused_decode_plan",
                                "fwd"):
                g_turns[route].append(device_step(
                    np, models["fast"], fast_reads, make_compute_fn,
                    chunk)[1])
        else:
            g_turns[route].append(device_step(
                np, models["fast"], fast_reads, make_compute_fn, chunk)[1])
    _, x_wire, sig_scale = prepared
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        head_kernel = models["fast"].forward_tcn_head(xc[..., None])
        ops_lstm.lstm_fused = lstm_fused_cuda.lstm_fused_plain
        try:
            head_plain = models["fast"].forward_tcn_head(xc[..., None])
        finally:
            ops_lstm.lstm_fused = lstm_fused_cuda.lstm_fused
        diff = (head_kernel.h.float() - head_plain.h.float()).abs()
        worst, mean = diff.max().item(), diff.mean().item()
        out_kernel = ops_decode.viterbi_decode_head(
            models["fast"].seqdist, head_kernel, qscale=1.05, qbias=0.2)
        out_plain = decode_fused_cuda.tcn_fused_backward_plain(
            head_kernel, *decode_fused_cuda.tcn_fused_forward_plain(
                head_kernel), qscale=1.05, qbias=0.2)
        same = ((out_kernel["moves"] == out_plain["moves"])
                & (out_kernel["sequence"] == out_plain["sequence"]))
        n_diff = (~same).sum().item()
        dq = (out_kernel["qstring"].int()
              - out_plain["qstring"].int()).abs()[same].max().item()
    log(f"  fast path, one batch: encoder output {tuple(head_kernel.h.shape)} "
        f"through kernel F vs its plain version: max |diff| {worst:.3g}, "
        f"mean {mean:.3g} (tolerance {5 * LSTM_ATOL:.3g} / "
        f"{5 * LSTM_MEAN_TOL:.3g}); its decode through G + J vs their plain "
        f"versions: {n_diff} of {same.numel()} frames differ (at most "
        f"{1 - DECODE_MIN_EQUAL:.1%} may), max |dq| {dq} on the others")
    require(torch.isfinite(head_kernel.h.float()).all().item(),
            "fast path: non-finite encoder output")
    require(worst <= 5 * LSTM_ATOL and mean <= 5 * LSTM_MEAN_TOL,
            "fast path: kernel F's encoder output disagrees with the plain "
            "version's")
    require(n_diff <= (1 - DECODE_MIN_EQUAL) * same.numel() and dq <= 1,
            "fast path: G + J disagree with their plain versions")
    del head_kernel, head_plain, diff, out_kernel, out_plain, same

    # one sup batch: the conv stack's own output through P, the move scores
    # through P + 18 x K against the plain versions in their place, and the
    # decode of both through B + C (and B, C against their plain versions on
    # the kernels' moves: identical, as in phase 3)
    prepared, step_sup = device_step(np, models["sup"], fast_reads,
                                     make_compute_fn, chunk)
    with earlier_kernel(attention_cuda):
        _, step_sup_old = device_step(np, models["sup"], fast_reads,
                                      make_compute_fn, chunk)
    with earlier_kernel(decode_cuda, "decode_plan"):
        _, step_sup_bc_old = device_step(np, models["sup"], fast_reads,
                                         make_compute_fn, chunk)
    _, x_wire, sig_scale = prepared
    sup = models["sup"]
    q = dict(qscale=1.05, qbias=1.3)
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        conv_out = sup.encoder.conv(xc[..., None])
        pinned = relayout.pin_layout(conv_out)
        log(f"  sup path, one batch: the conv stack's output "
            f"{tuple(conv_out.shape)} {str(conv_out.dtype)[6:]} has strides "
            f"{conv_out.stride()}; kernel P's copy is identical: "
            f"{torch.equal(pinned, conv_out)}, contiguous: "
            f"{pinned.is_contiguous()}")
        require(tuple(conv_out.shape) == (SN, ST, 512)
                and torch.equal(pinned, conv_out) and pinned.is_contiguous(),
                "sup path: kernel P does not copy the conv stack's output")
        sup_view = conv_out
        del pinned
        mv_kernel, mv_plain, sup_blank, worst, mean, n_k = (
            moves_kernels_vs_plain(torch, sup, xc[..., None]))
        n_diff, n_all, out_kernel = decodes_differ(
            torch, sup, mv_kernel, mv_plain, sup_blank, ops_decode, **q)
        sup_moves = mv_kernel.permute(2, 0, 1).contiguous()
        sup_fwd = decode_cuda.tcn_forward(sup_moves, sup_blank)
        sup_out = decode_cuda.tcn_backward(sup_moves, *sup_fwd, sup_blank,
                                           **q)
        sup_plan = (decode_cuda.tcn_forward.plan,
                    decode_cuda.tcn_backward.plan)
        sup_differ, sup_vs_old = ring_vs_old_kernel(
            torch, decode_cuda, sup_moves, sup_blank, sup_fwd, sup_out, **q)
        ref_fwd = decode_cuda.tcn_forward_plain(sup_moves, sup_blank)
        out_plain = decode_cuda.tcn_backward_plain(sup_moves, *ref_fwd,
                                                   sup_blank, **q)
        exact = all(torch.equal(out_kernel[k], out_plain[k])
                    for k in ("sequence", "moves"))
        dq = (out_kernel["qstring"].int()
              - out_plain["qstring"].int()).abs().max().item()
    log(f"    its moves {tuple(mv_kernel.shape)} through P + 18 x K vs the "
        f"plain versions: max |diff| {worst:.3g}, mean {mean:.3g} (tolerance "
        f"{SUP_MOVES_MAX} / {SUP_MOVES_MEAN}); the two decodes agree on "
        f"{1 - n_diff / n_all:.5f} of {n_all} frames (at least "
        f"{SUP_MIN_EQUAL}); B + C vs their plain versions on the kernels' "
        f"moves: sequence and moves identical {exact}, choices identical "
        f"{torch.equal(sup_fwd[1], ref_fwd[1])}, max |dq| {dq}")
    require(n_k == {"K": 18, "L": 0, "P": 1}, f"sup path: launches {n_k}")
    require(worst <= SUP_MOVES_MAX and mean <= SUP_MOVES_MEAN,
            "sup path: the kernels' moves disagree with the plain versions'")
    require(n_diff <= (1 - SUP_MIN_EQUAL) * n_all,
            "sup path: the decode through the kernels disagrees with the "
            "decode through the plain versions")
    require(exact and torch.equal(sup_fwd[1], ref_fwd[1]) and dq <= 1,
            "sup path: B + C disagree with their plain versions")
    log(f"    B + C on the ring (plan {sup_plan[0]}) vs the earlier kernels "
        f"on the kernels' moves: outputs that differ in any bit "
        f"{sup_differ}, max |diff| {sup_vs_old:.3g}")
    require(sup_plan[0] is not None and sup_plan[1] is not None,
            "sup path: B and C did not run on the ring")
    require(not sup_differ, f"sup path: B + C on the ring differ from the "
            f"earlier kernels in {sup_differ}")
    bc_vs_old = max(bc_vs_old, sup_vs_old)
    del mv_kernel, mv_plain, out_kernel, out_plain, ref_fwd, conv_out, sup_out
    # the same batch on the reverse path: its full scores (T 2000) read in
    # reverse-complement order in place through M + Q, held as hac's; M and
    # Q are timed on these scores in phase 8
    sup_scores, _, h = hold_reverse_batch(torch, decode_full_cuda, sup, xc,
                                          "sup", **q)
    err_m, err_q = max(err_m, h["err_in"]), max(err_q, float(h["dq"]))
    vs_old_mq = max(vs_old_mq, h["vs_old"])
    rev_steps["sup_rev"] = {"step": device_step(
        np, sup, fast_reads, make_compute_fn, chunk, reverse=True)[1]}
    with parent_reverse(crf_basecall, decode_full_cuda, True):
        rev_steps["sup_rev"]["copy_old"] = device_step(
            np, sup, fast_reads, make_compute_fn, chunk, reverse=True)[1]

    # the same batch on an f32 copy of the model: K takes f32 in and out and
    # rounds to bf16 inside, nothing else rounds to bf16
    sup32 = load_model(dirs["sup"], half=False, fuse_bn=True, device="cuda")
    with torch.inference_mode():
        mv_kernel, mv_plain, _, worst, mean, n_k = moves_kernels_vs_plain(
            torch, sup32, xc[..., None].float())
        n_diff, n_all, _ = decodes_differ(
            torch, sup32, mv_kernel, mv_plain, sup_blank, ops_decode, **q)
    log(f"    an f32 copy of the model, the same {SN} chunks, launches {n_k} "
        f"in f32: moves {tuple(mv_kernel.shape)} {str(mv_kernel.dtype)[6:]} "
        f"vs the plain versions: max |diff| {worst:.3g}, mean {mean:.3g} "
        f"(tolerance {SUP_F32_MAX} / {SUP_F32_MEAN}); the two decodes differ "
        f"on {n_diff} of {n_all} frames (at most "
        f"{1 - SUP_F32_MIN_EQUAL:.1%} may)")
    require(n_k == {"K": 18, "L": 0, "P": 1}
            and mv_kernel.dtype == torch.float32,
            f"sup path, f32: launches {n_k} on {mv_kernel.dtype} moves")
    require(worst <= SUP_F32_MAX and mean <= SUP_F32_MEAN
            and n_diff <= (1 - SUP_F32_MIN_EQUAL) * n_all,
            "sup path, f32: the kernels' moves disagree with the plain "
            "versions'")
    del sup32, mv_kernel, mv_plain

    # one batch of the shallow transformer: P + 2 x (apply_rotary, L) against
    # the plain versions in their place, in bf16 as it runs and on an f32 copy
    prepared, _ = device_step(np, models["sup_d40"], fast_reads,
                              make_compute_fn, chunk)
    _, x_wire, sig_scale = prepared
    d40_32 = load_model(dirs["sup_d40"], half=False, fuse_bn=True,
                        device="cuda")
    with torch.inference_mode():
        xd = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        for name, model, x, tol_max, tol_mean, tol_frames in (
                ("bf16", models["sup_d40"], xd[..., None], D40_MOVES_MAX,
                 D40_MOVES_MEAN, 1 - D40_MIN_EQUAL),
                ("an f32 copy", d40_32, xd[..., None].float(), SUP_F32_MAX,
                 SUP_F32_MEAN, 1 - SUP_F32_MIN_EQUAL)):
            mv_kernel, mv_plain, d40_blank, worst, mean, n_l = (
                moves_kernels_vs_plain(torch, model, x))
            n_diff, n_all, _ = decodes_differ(
                torch, model, mv_kernel, mv_plain, d40_blank, ops_decode, **q)
            log(f"  shallow transformer, one batch, {name}: moves "
                f"{tuple(mv_kernel.shape)} {str(mv_kernel.dtype)[6:]} through "
                f"P + 2 x (apply_rotary, L), launches {n_l}, vs the plain "
                f"versions: max |diff| {worst:.3g}, mean {mean:.3g} "
                f"(tolerance {tol_max} / {tol_mean}); the two decodes differ "
                f"on {n_diff} of {n_all} frames (at most {tol_frames:.1%} "
                f"may)")
            require(n_l == {"K": 0, "L": 2, "P": 1},
                    f"shallow transformer, {name}: launches {n_l}")
            require(worst <= tol_max and mean <= tol_mean
                    and n_diff <= tol_frames * n_all,
                    f"shallow transformer, {name}: the kernels' moves "
                    f"disagree with the plain versions'")
    del d40_32, mv_kernel, mv_plain, xd

    # one batch of each fused path (the batch the TCN route's device step
    # above ran): its head through GW + JW against their plain versions, and
    # its decode against the same batch's on the TCN route (printed, not
    # required: f32 against bf16 move scores decode differently by design)
    fused_steps, wide_turns = {}, {}
    for name, src, rds in (("hac_fused", "int8", reads),
                           ("sup_fused", "sup", fast_reads)):
        model = models[src]
        # the device step with GW + JW and with the earlier pair in turns
        # (earlier, new, new, earlier), each with its peak memory above
        # what was held before it
        turns = {"old": [], "new": [], "old_peak": [], "new_peak": []}
        for pair in ("old", "new", "new", "old"):
            with (earlier_kernel(decode_fused_cuda, "wide_decode_plan")
                  if pair == "old" else contextlib.nullcontext()):
                prepared, ms, peak = step_and_peak(
                    torch, np, model, rds, make_compute_fn, chunk,
                    head_route="fused")
            turns[pair].append(ms)
            turns[pair + "_peak"].append(peak)
        wide_turns[name] = turns
        fused_steps[name] = turns["new"][0]
        if src == "sup":
            with earlier_kernel(attention_cuda):
                _, fused_steps[name + "_old"] = device_step(
                    np, model, rds, make_compute_fn, chunk,
                    head_route="fused")
        _, x_wire, sig_scale = prepared
        with torch.inference_mode():
            xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
                  * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
            head = model.forward_tcn_head(xc[..., None])
            fwd_kernel, out_kernel, e, d = hold_fused(
                torch, decode_fused_cuda, head, f"{name} path, one batch",
                "GW + JW", **q)
            wide_vs_old = max(wide_vs_old, hold_wide_old(
                torch, decode_fused_cuda, head, fwd_kernel, out_kernel,
                f"{name} path, one batch", **q))
            out_tcn = ops_decode.viterbi_decode_tcn(
                model.seqdist, *model.forward_tcn(xc[..., None]), **q)
            differ = ((out_tcn["moves"] != out_kernel["moves"])
                      | (out_tcn["sequence"] != out_kernel["sequence"]))
        log(f"    the same batch on the TCN route (head matmul, bf16 moves, "
            f"B + C): {differ.sum().item()} of {differ.numel()} frames "
            f"differ in moves or sequence, in {differ.any(1).sum().item()} "
            f"of {differ.shape[0]} rows (not required: f32 against bf16 "
            f"move scores)")
        err_gw, err_jw = max(err_gw, e), max(err_jw, d)
        del head, fwd_kernel, out_kernel, out_tcn, differ

    log("[6] launches on each path (counts set to 0 before it, read after)")
    own = {"bf16": {"A": 5, "B": 1, "C": 1}, "int8": {"D": 5, "B": 1, "C": 1},
           "two_stage": {"E": 5, "B": 1, "C": 1},
           "fast": {"F": 5, "G": 1, "J": 1},
           "fast_bf16": {"F": 5, "G": 1, "J": 1},
           "sup": {"P": 1, "K": 18, "B": 1, "C": 1},
           "sup_d40": {"P": 1, "L": 2, "B": 1, "C": 1},
           "rev": {"D": 5, "M": 1, "Q": 1},
           "fast_rev": {"F": 5, "M": 1, "Q": 1},
           "sup_rev": {"P": 1, "K": 18, "M": 1, "Q": 1},
           "beam": {"D": 5},
           "hac_fused": {"D": 5, "GW": 1, "JW": 1, "HP": 1},
           "sup_fused": {"P": 1, "K": 18, "GW": 1, "JW": 1, "HP": 1}}
    for name, run in runs.items():
        expect = {k: own[name].get(k, 0) * run["batches"] for k in counters}
        log(f"  {name}: {run['batches']} batches ({run['full_batches']} "
            f"full) of {run['batchsize']}; launches {run['launches']}")
        require(run["launches"] == expect,
                f"{name}: launches {run['launches']}, expected {expect}: "
                f"{own[name]} per batch, no other kernel")
        if run["plans"]:
            log(f"    the plans F, G, J, GW and JW ran on: {run['plans']}")
            require(all(v is not None for v in run["plans"].values()),
                    f"{name}: F, G, J, GW or JW ran on its earlier kernel: "
                    f"{run['plans']}")

    log(f"[7] on {card}:")
    for name, step in (("bf16", step_bf16), ("int8", step_int8),
                       ("fast", step_fast), ("sup", step_sup),
                       ("rev", step_rev), ("beam", step_beam)):
        run = runs[name]
        per_batch = run["batchsize"] * run["chunksize"]
        log(f"  {name}: {run['samples'] / run['wall']:.6g} samples/s over "
            f"{run['wall']:.3f} s ({run['samples']} samples, "
            f"{run['batches']} batches of {run['batchsize']}), peak memory "
            f"{run['peak']:.3f} GiB, {run['peak'] - run['held']:.3f} GiB "
            f"above what was held before the path; device step (upload, forward, decode, "
            f"fetch) {step:.4g} ms per batch = "
            f"{per_batch / step * 1e3:.6g} samples/s")
    log(f"  fast with head_route='tcn' (head matmul + B + C in place of G + "
        f"J): device step {step_fast_tcn:.4g} ms per batch")
    log(f"  fast in turns, G on its earlier kernel (the parent's route) / "
        f"on the ring: device step " + " / ".join(
            f"{g_turns[r][i]:.4g}" for i in range(2) for r in ("old", "ring"))
        + " ms per batch")
    log(f"  fast with F and J on their earlier kernels: device step "
        f"{step_fast_old:.4g} ms per batch ({step_fast:.4g} on the mma "
        f"kernel and the ring); fast reverse with F on its earlier kernel "
        f"{rev_steps['fast_rev']['f_old']:.4g} "
        f"({rev_steps['fast_rev']['step']:.4g})")
    rs = rev_steps
    log(f"  the reverse strand read in place (M + Q on the ring): device "
        f"step hac {rs['rev']['step']:.4g} ms per batch, fast "
        f"{rs['fast_rev']['step']:.4g}, sup {rs['sup_rev']['step']:.4g}; as "
        f"the parent decodes it (the reverse_complement copy, M + Q's "
        f"earlier kernels): hac {rs['rev']['copy_old']:.4g}, fast "
        f"{rs['fast_rev']['copy_old']:.4g}, sup "
        f"{rs['sup_rev']['copy_old']:.4g}; hac with the copy and the ring "
        f"{rs['rev']['copy']:.4g}")
    log(f"  B and C on their earlier kernels in place of the ring: hac int8 "
        f"device step {step_int8_bc_old:.4g} ms per batch (the ring's "
        f"{step_int8:.4g}), sup {step_sup_bc_old:.4g} ms ({step_sup:.4g})")
    log(f"  sup with K's earlier kernel in place of the stretch kernel: "
        f"device step {step_sup_old:.4g} ms per batch (the stretch kernel's "
        f"{step_sup:.4g}); sup_fused {fused_steps['sup_fused_old']:.4g} ms "
        f"({fused_steps['sup_fused']:.4g})")
    for name, tcn_name, tcn_step in (("hac_fused", "int8", step_int8),
                                     ("sup_fused", "sup", step_sup)):
        run, step = runs[name], fused_steps[name]
        per_batch = run["batchsize"] * run["chunksize"]
        log(f"  {name} (head_route='fused': GW + JW in place of the head "
            f"matmul + B + C): {run['samples'] / run['wall']:.6g} samples/s "
            f"over {run['wall']:.3f} s ({run['samples']} samples, "
            f"{run['batches']} batches of {run['batchsize']}), peak memory "
            f"{run['peak']:.3f} GiB, {run['peak'] - run['held']:.3f} GiB "
            f"above what was held before the path; device step {step:.4g} ms "
            f"per batch = {per_batch / step * 1e3:.6g} samples/s, beside the "
            f"TCN route's ({tcn_name}) {tcn_step:.4g} ms on the same batch")
        turns = wide_turns[name]
        log(f"    {name} in turns, the earlier GW + JW / GW + JW / GW + JW / "
            f"the earlier: device step {turns['old'][0]:.4g} / "
            f"{turns['new'][0]:.4g} / {turns['new'][1]:.4g} / "
            f"{turns['old'][1]:.4g} ms per batch, peak memory above what was "
            f"held {turns['old_peak'][0]:.3f} / {turns['new_peak'][0]:.3f} / "
            f"{turns['new_peak'][1]:.3f} / {turns['old_peak'][1]:.3f} GiB")

    log(f"[8] kernel times at hac shapes (N={N}, T={T}, C=H={H}, S={S}; "
        f"CUDA events)")
    x_lstm = torch.randn(T, N, H, device=dev, dtype=torch.bfloat16)
    w_ih = (torch.randn(H, 4 * H, device=dev) / math.sqrt(H)).to(torch.bfloat16)
    ms_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence(xw, w_hh), reps=3)
    a_plan = lstm_cuda.lstm_recurrence.plan  # what the timed launches ran
    require(a_plan is not None, "A took its step kernel at hac")
    ms_a_step = cuda_ms(lambda: a_step_kernel(torch, build, xw, w_hh), reps=2)
    plain_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence_plain(xw, w_hh),
                      reps=1, warmup=0)
    proj = cuda_ms(lambda: torch.matmul(x_lstm, w_ih), reps=5)
    cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    with torch.no_grad():
        lib_a = cuda_ms(lambda: cudnn(x_lstm), reps=5)
    log(f"  A: projection matmul {proj:.4g} ms + kernel {ms_a:.4g} ms "
        f"(persistent: {a_plan['launches']} launch of {a_plan['ctas']} CTAs "
        f"in clusters of {a_plan['cluster']}, {a_plan['rows']} rows and 16 "
        f"units each, {a_plan['smem']} B of shared memory; "
        f"{ms_a / T * 1e3:.4g} us a step) vs one cuDNN "
        f"torch.nn.LSTM layer {lib_a:.4g} ms; A's step kernel at this shape "
        f"{ms_a_step:.4g} ms ({ms_a_step / T * 1e3:.4g} us a step)")
    bytes_a = T * N * 4 * H * 2 + H * 4 * H * 2 + T * N * H * 2
    bound_a = bound(bytes_a, 2 * N * H * 4 * H * T, H100_BF16_OPS)

    ms_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused(
        *d_args, out_int8=True), reps=3)
    require(lstm_int8_cuda.lstm_int8_fused.plan == int8_plans["D"],
            "D took another plan than check_lstm_int8's")
    ms_d_step = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused_step_kernel(
        *d_args, out_int8=True), reps=2)
    plain_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused_plain(
        *d_args, out_int8=True), reps=1, warmup=0)
    ms_e = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_recurrence(*e_args),
                   reps=3)
    require(lstm_int8_cuda.lstm_int8_recurrence.plan == int8_plans["E"],
            "E took another plan than check_lstm_int8's")
    ms_e_step = cuda_ms(
        lambda: lstm_int8_cuda.lstm_int8_recurrence_step_kernel(*e_args),
        reps=2)
    plain_e = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_recurrence_plain(
        *e_args), reps=1, warmup=0)
    for key, ms, ms_step in (("D", ms_d, ms_d_step), ("E", ms_e, ms_e_step)):
        pl = int8_plans[key]
        log(f"  {key}: {ms:.4g} ms a layer ({ms / T * 1e3:.4g} us a step; "
            f"persistent: {pl['launches']} launch of {pl['ctas']} CTAs in "
            f"clusters of {pl['cluster']}, {pl['rows']} rows and 16 units "
            f"each, {pl['smem']} B of shared memory) beside its step kernel's "
            f"{ms_step:.4g} ms ({ms_step / T * 1e3:.4g} us a step)")
    # D: int8 x in, both int8 weights, three f32 rows, int8 h out
    bound_d = bound(T * N * H + 2 * H * 4 * H + 3 * 4 * H * 4 + T * N * H,
                    2 * N * T * (H + H) * 4 * H, H100_INT8_OPS)
    # E: bf16 xw in, int8 W_hh, one f32 row, bf16 h out
    bound_e = bound(T * N * 4 * H * 2 + H * 4 * H + 4 * H * 4 + T * N * H * 2,
                    2 * N * T * H * 4 * H, H100_INT8_OPS)
    lstm0 = lstms[0]
    project = cuda_ms(lambda: int8.project_int8(
        x_lstm, lstm0.w_ih_q, lstm0.ih_scales, lstm0.b, torch.bfloat16),
        reps=3)
    quantise = cuda_ms(lambda: int8.quantize_dynamic(x_lstm), reps=3)
    _, (_, crf), _ = models["int8"].decode_head()
    perm = models["int8"]._tcn_perm(dev)
    h_q = d_args[0].transpose(0, 1)
    head_int8 = cuda_ms(lambda: crf.project(h_q, perm, torch.bfloat16), reps=3)
    _, (_, crf_bf16), _ = models["bf16"].decode_head()
    head_bf16 = cuda_ms(lambda: crf_bf16.project(x_lstm.transpose(0, 1), perm),
                        reps=3)
    log(f"  int8 path outside the kernels: layer 0's dynamic quantise "
        f"{quantise:.4g} ms; int8 head in slabs of {crf.SLAB_ROWS} rows "
        f"(torch._int_mm + f32 rescale) {head_int8:.4g} ms vs the bf16 head "
        f"matmul {head_bf16:.4g} ms; two-stage project_int8 (quantise, "
        f"torch._int_mm, rescale) {project:.4g} ms per layer")

    ms_b = cuda_ms(lambda: decode_cuda.tcn_forward(moves, blank), reps=3)
    ms_b_old = cuda_ms(lambda: decode_cuda.tcn_forward_old_kernel(
        moves, blank), reps=3)
    plain_b = cuda_ms(lambda: decode_cuda.tcn_forward_plain(moves, blank),
                      reps=1, warmup=0)
    ms_c = cuda_ms(lambda: decode_cuda.tcn_backward(moves, *fwd, blank),
                   reps=3)
    ms_c_old = cuda_ms(lambda: decode_cuda.tcn_backward_old_kernel(
        moves, *fwd, blank), reps=3)
    plain_c = cuda_ms(lambda: decode_cuda.tcn_backward_plain(
        moves, *fwd, blank), reps=1, warmup=0)
    R = S // 4
    move_bytes = N * T * 4 * S * 2
    # B: moves in; move-in f32, choices, c, logZ and end state out
    bound_b = bound(move_bytes + N * T * S * 5 + N * T * 4 + N * 8,
                    20 * N * T * S, H100_F32_OPS)
    # C: moves in; the emitted base's quarter of move-in, one choice per
    # frame (the traceback's), c, logZ, end state; three [N, T] planes out
    bound_c = bound(move_bytes + N * T * R * 4 + N * T * 5 + N * 8 + 3 * N * T,
                    20 * N * T * S, H100_F32_OPS)

    sd = models["int8"].seqdist
    tm = {"hac": time_full(torch, decode_full_cuda, sd,
                           random_full_scores(torch, dev, N, T, S),
                           plain=True)}
    ms_m, ms_q = tm["hac"]["M_rev"], tm["hac"]["Q_rev"]
    plain_m, plain_q = tm["hac"]["M_plain"], tm["hac"]["Q_plain"]
    bound_m, bound_q = tm["hac"]["bounds"]
    log(f"  B {ms_b:.4g} ms, C {ms_c:.4g} ms on the ring (bounds "
        f"{bound_b[0]:.4g} and {bound_c[0]:.4g} ms by {bound_b[1]}); their "
        f"earlier kernels {ms_b_old:.4g} and {ms_c_old:.4g} ms on the same "
        f"[{N}, {T}, {4 * S}] moves")
    log(f"  on bf16 scores [{N}, {T}, {5 * S}] (B {ms_b:.4g}, C {ms_c:.4g} "
        f"on the [{N}, {T}, {4 * S}] moves): {full_times_text(tm['hac'])}")

    log(f"    and at fast shapes (N={FN}, T={FT}, C=H={FH}, S={FS})")
    fx, fw_ih, fw_hh, fb = f_args
    ms_f = cuda_ms(lambda: lstm_fused_cuda.lstm_fused(fx, fw_ih, fw_hh, fb),
                   reps=5)
    ms_f_old = cuda_ms(lambda: lstm_fused_cuda.lstm_fused_old_kernel(
        fx, fw_ih, fw_hh, fb), reps=5)
    plain_f = cuda_ms(lambda: lstm_fused_cuda.lstm_fused_plain(
        fx, fw_ih, fw_hh, fb), reps=1, warmup=0)
    cudnn_f = torch.nn.LSTM(FH, FH, device=dev, dtype=torch.bfloat16)
    cudnn_f.flatten_parameters()
    with torch.no_grad():
        lib_f = cuda_ms(lambda: cudnn_f(fx), reps=5)

    def projection_and_a():  # the route kernel F takes the place of
        xw_f = torch.matmul(fx, fw_ih)
        xw_f.add_(fb.to(torch.bfloat16))
        return lstm_cuda.lstm_recurrence(xw_f, fw_hh)
    ms_via_a = cuda_ms(projection_and_a, reps=2)
    log(f"  F: {ms_f:.4g} ms per layer on the mma kernel "
        f"({ms_f / FT * 1e3:.4g} us a step), its earlier kernel "
        f"{ms_f_old:.4g} ms, vs projection + kernel A {ms_via_a:.4g} ms vs "
        f"one cuDNN torch.nn.LSTM({FH}, {FH}) layer {lib_f:.4g} ms")
    # F: bf16 x in, both weights, the f32 bias, bf16 h out
    bound_f = bound(2 * FT * FN * FH * 2 + 2 * FH * 4 * FH * 2 + 4 * FH * 4,
                    2 * FN * FT * (FH + FH) * 4 * FH, H100_BF16_OPS)

    ms_g = cuda_ms(lambda: decode_fused_cuda.tcn_fused_forward(f_head), reps=5)
    ms_g_old = cuda_ms(lambda: decode_fused_cuda.tcn_fused_forward_old_kernel(
        f_head), reps=5)
    plain_g = cuda_ms(lambda: decode_fused_cuda.tcn_fused_forward_plain(
        f_head), reps=1, warmup=0)
    ms_j = cuda_ms(lambda: decode_fused_cuda.tcn_fused_backward(
        f_head, *f_fwd), reps=5)
    ms_j_old = cuda_ms(lambda: decode_fused_cuda.tcn_fused_backward_old_kernel(
        f_head, *f_fwd), reps=5)
    log(f"  G: {ms_g:.4g} ms on its ring, its earlier kernel {ms_g_old:.4g} "
        f"ms; J: {ms_j:.4g} ms on its ring, its earlier kernel "
        f"{ms_j_old:.4g} ms")
    plain_j = cuda_ms(lambda: decode_fused_cuda.tcn_fused_backward_plain(
        f_head, *f_fwd), reps=1, warmup=0)
    head_ops = 2 * FT * FN * FH * 4 * FS     # on the tensor cores
    head_in = FT * FN * FH * 2 + 4 * FS * FH * 2
    # G: h and the weights in; move-in f32, choices, c, logZ, end state out
    bound_g = bound(head_in + FN * FT * FS * 5 + FN * FT * 4 + FN * 8,
                    head_ops, H100_BF16_OPS, 20 * FN * FT * FS)
    # J: h and the weights in; as for C a quarter of move-in, one choice per
    # frame, c, logZ, end state; three [N, T] planes out
    bound_j = bound(head_in + FN * FT * (FS // 4) * 4 + FN * FT * 5 + FN * 8
                    + 3 * FN * FT, head_ops, H100_BF16_OPS, 20 * FN * FT * FS)
    # the TCN route's pieces at fast widths, which G + J take the place of
    _, (_, crf_fast), clamp_fast = models["fast_bf16"].decode_head()
    perm_fast = models["fast_bf16"]._tcn_perm(dev)
    h_nt = f_head.h.transpose(0, 1)
    head_tcn = lambda: clamp_fast[1](
        crf_fast.head(h_nt, perm_fast)).contiguous()
    ms_head_fast = cuda_ms(head_tcn, reps=5)
    mv_fast = head_tcn()
    ms_b_fast = cuda_ms(lambda: decode_cuda.tcn_forward(mv_fast, 2.0), reps=3)
    fwd_fast = decode_cuda.tcn_forward(mv_fast, 2.0)
    ms_c_fast = cuda_ms(lambda: decode_cuda.tcn_backward(
        mv_fast, *fwd_fast, 2.0), reps=3)
    # the same moves as full scores with the stays beside them
    full_fast = ops_decode.tcn_to_scores(models["fast"].seqdist,
                                         mv_fast.permute(1, 2, 0), 2.0)
    tm["fast"] = time_full(torch, decode_full_cuda, models["fast"].seqdist,
                           full_fast)
    log(f"  G {ms_g:.4g} ms + J {ms_j:.4g} ms vs the TCN route at these "
        f"widths: head matmul + clamp {ms_head_fast:.4g} ms + B "
        f"{ms_b_fast:.4g} ms + C {ms_c_fast:.4g} ms; on [{FN}, {FT}, "
        f"{5 * FS}] full scores: {full_times_text(tm['fast'])}")

    log(f"    and at sup shapes (N={SN}, T={ST}, H={SH}, D={SD}, window "
        f"{SWIN}; decode N={SN}, T={2 * ST}, S={S})")
    qkv_s, cos_s, sin_s = attn_args["K"]
    ms_k = cuda_ms(lambda: attention_cuda.fused_rotary_window_attention(
        qkv_s, cos_s, sin_s, SWIN), reps=10)
    plan_k = attention_cuda.fused_rotary_window_attention.plan
    ms_k_old = cuda_ms(
        lambda: attention_cuda.fused_rotary_window_attention_old_kernel(
            qkv_s, cos_s, sin_s, SWIN), reps=10)
    plain_k = cuda_ms(
        lambda: attention_cuda.fused_rotary_window_attention_plain(
            qkv_s, cos_s, sin_s, SWIN), reps=1, warmup=0)
    band = attention_cuda.band_mask(ST, SWIN, None, dev)

    def library_k():  # rotary passes + one fused-attention call with the band
        q = transformer.apply_rotary(qkv_s[:, :, 0], cos_s, sin_s)
        k = transformer.apply_rotary(qkv_s[:, :, 1], cos_s, sin_s)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            qkv_s[:, :, 2].transpose(1, 2), attn_mask=band).transpose(1, 2)
    lib_k = cuda_ms(library_k, reps=5)
    lib_k_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        qkv_s[:, :, 0].transpose(1, 2), qkv_s[:, :, 1].transpose(1, 2),
        qkv_s[:, :, 2].transpose(1, 2), attn_mask=band), reps=5)
    ref_k = attention_cuda.fused_rotary_window_attention(
        qkv_s, cos_s, sin_s, SWIN)
    lib_err = (library_k().float() - ref_k.float()).abs().max().item()
    require(lib_err <= 2e-2, f"the library yardstick for K computes another "
                             f"function: {lib_err}")
    del ref_k
    # L where the shallow transformer calls it (bf16, 32 rows, 8 heads of
    # 40), and at sup widths in f32
    def time_l(q_l, k_l, v_l):
        T_l = q_l.shape[2]
        mask = band if T_l == ST else attention_cuda.band_mask(
            T_l, SWIN, None, dev)
        return (cuda_ms(lambda: attention_cuda.local_attention(
                    q_l, k_l, v_l, SWIN), reps=5),
                cuda_ms(lambda: attention_cuda.local_attention_plain(
                    q_l, k_l, v_l, SWIN), reps=1, warmup=0),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    q_l, k_l, v_l, attn_mask=mask), reps=5))
    ms_l, plain_l, lib_l = time_l(*attn_args["L"])
    ms_l32, plain_l32, lib_l32 = time_l(*attn_args["L sup f32"])
    ms_l16, plain_l16, lib_l16 = time_l(*attn_args["L sup bf16"])
    ref_l = attention_cuda.local_attention(*attn_args["L"], SWIN)
    lib_err_l = (F.scaled_dot_product_attention(
        *attn_args["L"], attn_mask=band).float()
        - ref_l.float()).abs().max().item()
    require(lib_err_l <= 2e-2, f"the library yardstick for L computes another "
                               f"function: {lib_err_l}")
    del ref_l
    log(f"  K {ms_k:.4g} ms on the stretch kernel (plan {plan_k}), "
        f"{ms_k_old:.4g} ms on the earlier kernel, vs rotary passes + "
        f"scaled_dot_product_attention "
        f"with the band as a mask {lib_k:.4g} ms (the attention call alone "
        f"{lib_k_sdpa:.4g} ms; max |K - library| {lib_err:.3g}); L on the "
        f"shallow transformer's call (N={D40_N}, H={D40_H}, D={D40_D}, bf16) "
        f"{ms_l:.4g} ms vs scaled_dot_product_attention {lib_l:.4g} ms (max "
        f"|L - library| {lib_err_l:.3g}); L at sup widths in bf16 "
        f"{ms_l16:.4g} ms vs scaled_dot_product_attention {lib_l16:.4g} ms; "
        f"in f32 {ms_l32:.4g} ms vs scaled_dot_product_attention in f32 "
        f"{lib_l32:.4g} ms")
    pairs = band_pairs(ST, SWIN)
    attn_ops = 2 * 2 * SN * SH * pairs * SD  # both products
    # K: bf16 qkv in, the two f32 tables, bf16 o out; products on the tensor
    # cores, about 10 f32 operations per pair for the softmax
    bound_k = bound(SN * ST * 4 * SH * SD * 2 + 2 * ST * (SD // 2) * 4,
                    attn_ops, H100_BF16_OPS, 10 * SN * SH * pairs)
    # L: q, k, v in, o out, in their own type. bf16: as K, the products on
    # the tensor cores and about 10 f32 operations per pair for the softmax;
    # f32: everything on the f32 cores
    bound_l = bound(D40_N * ST * 4 * D40_H * D40_D * 2,
                    2 * 2 * D40_N * D40_H * pairs * D40_D, H100_BF16_OPS,
                    10 * D40_N * D40_H * pairs)
    bound_l16 = bound(SN * ST * 4 * SH * SD * 2, attn_ops, H100_BF16_OPS,
                      10 * SN * SH * pairs)
    bound_l32 = bound(SN * ST * 4 * SH * SD * 4,
                      attn_ops + 10 * SN * SH * pairs, H100_F32_OPS)
    ms_p = cuda_ms(lambda: relayout.pin_layout(sup_view), reps=10)
    plain_p = cuda_ms(lambda: relayout.pin_layout_plain(sup_view), reps=5)
    lib_p = cuda_ms(lambda: sup_view.contiguous(), reps=5)
    ms_p_t = cuda_ms(lambda: relayout.pin_layout(pin_view), reps=10)
    lib_p_t = cuda_ms(lambda: pin_view.contiguous(), reps=5)
    # the tiles on the same view, in turns with the 16-byte transpose the
    # plan gives it (the plan keeps such views on the faster) and with the
    # earlier kernel P, whose plan was the same
    require(torch.equal(pin_tiles(relayout, sup_view),
                        relayout.pin_layout_plain(sup_view)),
            "P's tiles at the sup stack's bf16 input differ from the plain "
            "version")
    p_turns = in_turns(torch, {
        "transpose": lambda: relayout.pin_layout(sup_view),
        "tiles": lambda: pin_tiles(relayout, sup_view),
        "earlier": lambda: relayout.pin_layout_old_kernel(sup_view)},
        reps=10)
    require(sum(p_turns["transpose"]) <= sum(p_turns["tiles"]),
            f"P at sup's bf16 input: the 16-byte transpose the plan takes is "
            f"slower than the tiles: {p_turns}")
    log(f"  P on the conv stack's output (strides {sup_view.stride()}) "
        f"{ms_p:.4g} ms vs Tensor.contiguous() {lib_p:.4g} ms; on a "
        f"transposed [N, C, T] view {ms_p_t:.4g} ms vs {lib_p_t:.4g} ms; in "
        f"turns, the 16-byte transpose {p_turns['transpose']} ms, the tiles "
        f"{p_turns['tiles']} ms, the earlier kernel P {p_turns['earlier']} "
        f"ms")
    bound_p = bound(2 * sup_view.numel() * sup_view.element_size(), 0,
                    H100_F32_OPS)
    ms_b_sup = cuda_ms(lambda: decode_cuda.tcn_forward(sup_moves, sup_blank),
                       reps=3)
    ms_c_sup = cuda_ms(lambda: decode_cuda.tcn_backward(
        sup_moves, *sup_fwd, sup_blank), reps=3)
    ms_b_sup_old = cuda_ms(lambda: decode_cuda.tcn_forward_old_kernel(
        sup_moves, sup_blank), reps=3)
    ms_c_sup_old = cuda_ms(lambda: decode_cuda.tcn_backward_old_kernel(
        sup_moves, *sup_fwd, sup_blank), reps=3)
    ST2 = 2 * ST  # decode frames
    sup_move_bytes = SN * ST2 * 4 * S * 2
    bound_b_sup = bound(sup_move_bytes + SN * ST2 * S * 5 + SN * ST2 * 4
                        + SN * 8, 20 * SN * ST2 * S, H100_F32_OPS)
    bound_c_sup = bound(sup_move_bytes + SN * ST2 * R * 4 + SN * ST2 * 5
                        + SN * 8 + 3 * SN * ST2, 20 * SN * ST2 * S,
                        H100_F32_OPS)
    # M and Q on the sup reverse batch's scores
    tm["sup"] = time_full(torch, decode_full_cuda, sup.seqdist, sup_scores)
    del sup_scores
    log(f"  B {ms_b_sup:.4g} ms, C {ms_c_sup:.4g} ms at sup shapes (bounds "
        f"{bound_b_sup[0]:.4g} and {bound_c_sup[0]:.4g} ms by bytes; their "
        f"earlier kernels {ms_b_sup_old:.4g} and {ms_c_sup_old:.4g} ms); on "
        f"the same batch's full scores: {full_times_text(tm['sup'])}")

    # the parts of one sup layer and of the step around the stack, each timed
    # alone on the tensors it sees in a batch
    layer = sup_layers[0]
    attn, ff = layer.self_attn, layer.ff
    with torch.inference_mode():
        x_s = relayout.pin_layout(sup_view)
        o_s = attention_cuda.fused_rotary_window_attention(
            qkv_s, cos_s, sin_s, SWIN).reshape(SN, ST, SH * SD)
        y_s = torch.matmul(x_s, ff.fc1)
        parts = {
            "wqkv matmul": lambda: torch.matmul(x_s, attn.wqkv),
            "out_w matmul + bias": lambda: torch.matmul(o_s, attn.out_w)
            + attn.out_b,
            "fc1 matmul": lambda: torch.matmul(x_s, ff.fc1),
            "SwiGLU": lambda: y_s.chunk(2, -1)[0] * F.silu(y_s.chunk(2, -1)[1]),
            "fc2 matmul": lambda: torch.matmul(y_s[..., :ff.hidden], ff.fc2),
            "residual + RMSNorm": lambda: layer.norm1(
                torch.add(o_s, x_s, alpha=layer.deepnorm_alpha)),
        }
        ms_parts = {k: cuda_ms(fn, reps=5) for k, fn in parts.items()}
        xc1 = xc[..., None]
        ms_conv = cuda_ms(lambda: sup.encoder.conv(xc1), reps=3)
        _, (_, crf_sup), _ = sup.decode_head()
        perm_sup = sup._tcn_perm(dev)
        ms_up = cuda_ms(lambda: sup.encoder.upsample(x_s), reps=3)
        up_s = sup.encoder.upsample(x_s)
        ms_head = cuda_ms(lambda: crf_sup.head(up_s, perm_sup,
                                               torch.bfloat16), reps=3)
        del up_s, y_s
    per_layer = (ms_k + sum(v for k, v in ms_parts.items()
                            if k != "residual + RMSNorm")
                 + 2 * ms_parts["residual + RMSNorm"])
    log("  one sup layer: K " + f"{ms_k:.4g} ms, " + ", ".join(
        f"{k} {v:.4g} ms" for k, v in ms_parts.items())
        + f" (x 2): {per_layer:.4g} ms per layer, {18 * per_layer:.4g} ms "
        f"for 18; around the stack: convs {ms_conv:.4g} ms, P {ms_p:.4g} ms, "
        f"upsample {ms_up:.4g} ms, head matmul + tanh + scale {ms_head:.4g} "
        f"ms, B {ms_b_sup:.4g} ms, C {ms_c_sup:.4g} ms")
    sup_sum = (18 * per_layer + ms_conv + ms_p + ms_up + ms_head + ms_b_sup
               + ms_c_sup)
    log(f"  sup path per batch: these parts sum to {sup_sum:.4g} ms of the "
        f"{step_sup:.4g} ms device step; the rest {step_sup - sup_sum:.4g} ms "
        f"(wire, pack, fetch)")

    # GW, JW and GW's head product alone at hac's and sup's shapes (the
    # random heads of phase 3), the earlier GW and JW beside them, and
    # torch.matmul in f32 on the product's operands as a yardstick (no path
    # runs it); then the TCN route's pieces they take the place of
    log(f"    and the fused-head decode at {S} states (GW, JW, GW's head "
        f"product)")
    wide = {}
    for name, shape in WIDE_HEADS.items():
        head = fused_head(torch, HeadSplit, dev, *shape)
        Nw, Thw, Hw, Sw, Uw = shape[:5]
        Tw = Thw * Uw
        f = decode_fused_cuda
        mv_w = f.move_buffer(head)
        fwd_w = f.tcn_fused_forward(head, moves_out=mv_w)
        old_w = f.tcn_fused_forward_wide_old_kernel(head)
        t = {"GW": cuda_ms(lambda: f.tcn_fused_forward(head, moves_out=mv_w),
                           reps=3),
             "HP": cuda_ms(lambda: f.head_product(head, mv_w), reps=3),
             "JW": cuda_ms(lambda: f.tcn_fused_backward(head, *fwd_w,
                                                        moves=mv_w), reps=3),
             "GW_old": cuda_ms(lambda: f.tcn_fused_forward_wide_old_kernel(
                 head), reps=2),
             "JW_old": cuda_ms(lambda: f.tcn_fused_backward_wide_old_kernel(
                 head, *old_w), reps=2),
             "GW_plain": cuda_ms(lambda: f.tcn_fused_forward_plain(head),
                                 reps=1, warmup=0),
             "HP_plain": cuda_ms(lambda: f.head_moves_plain(head), reps=1,
                                 warmup=0),
             "JW_plain": cuda_ms(lambda: f.tcn_backward_plain(
                 mv_w, *fwd_w, head.blank), reps=1, warmup=0)}
        hp_err = (f.head_product(head) - f.head_moves_plain(head)).abs()
        t["HP_err"] = hp_err.max().item()
        del hp_err, old_w
        a32 = head.h.float().transpose(0, 1).reshape(Nw * Thw, Hw)
        w32 = head.wT.float().reshape(Uw * 4 * Sw, Hw).t()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            t["HP_library"] = cuda_ms(lambda: torch.matmul(a32, w32), reps=3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del a32, w32
        # the head product: 2*N*T*H*4S operations, bf16 operands (the
        # tensor cores' rate bounds it; the f32 cores' printed beside),
        # h, the weights and bias in, the f32 moves out; about 20 f32
        # operations per state and frame for each pass, as for G and J
        head_ops = 2 * Nw * Tw * Hw * 4 * Sw
        head_in = (Thw * Nw * Hw * 2 + Uw * 4 * Sw * Hw * 2
                   + (Uw * 4 * Sw * 4 if head.bias is not None else 0))
        moves_bytes = Nw * Tw * 4 * Sw * 4
        t["HP_bound"] = bound(head_in + moves_bytes, head_ops, H100_BF16_OPS)
        t["HP_f32_bound"] = head_ops / H100_F32_OPS * 1e3
        # GW: the product, then the forward pass; its outputs are the moves
        # (for JW), move-in f32, choices, c, logZ, end state
        t["GW_bound"] = bound(head_in + moves_bytes + Nw * Tw * Sw * 5
                              + Nw * Tw * 4 + Nw * 8, head_ops, H100_BF16_OPS,
                              20 * Nw * Tw * Sw)
        # JW: the moves, a quarter of move-in, one choice per frame, c,
        # logZ, end state in; three [N, T] planes out
        t["JW_bound"] = bound(moves_bytes + Nw * Tw * (Sw // 4) * 4
                              + Nw * Tw * 5 + Nw * 8 + 3 * Nw * Tw, 0,
                              H100_F32_OPS, 20 * Nw * Tw * Sw)
        t["plan"] = f.tcn_fused_forward_wide.plan
        wide[name] = t
        del head, fwd_w, mv_w
        torch.cuda.empty_cache()
    # the TCN route's pieces at the same shapes: hac's bf16 head matmul (and
    # the int8 head of hac as shipped), B, C; sup's upsample, head matmul +
    # tanh + scale, B, C
    tcn_route = {"hac": head_bf16 + ms_b + ms_c,
                 "hac_int8_head": head_int8 + ms_b + ms_c,
                 "sup": ms_up + ms_head + ms_b_sup + ms_c_sup}
    for name, t in wide.items():
        log(f"  {name} shapes: GW {t['GW']:.4g} ms (of it the head product "
            f"{t['HP']:.4g}: plain {t['HP_plain']:.4g}, bound "
            f"{t['HP_bound'][0]:.4g} by {t['HP_bound'][1]} on the tensor "
            f"cores, {t['HP_f32_bound']:.4g} on the f32 cores, torch.matmul "
            f"f32 on its operands {t['HP_library']:.4g}, max |diff| "
            f"{t['HP_err']:.3g}; GW plain {t['GW_plain']:.4g}, bound "
            f"{t['GW_bound'][0]:.4g} by {t['GW_bound'][1]}) + JW "
            f"{t['JW']:.4g} ms (plain {t['JW_plain']:.4g}, bound "
            f"{t['JW_bound'][0]:.4g} by {t['JW_bound'][1]}) = "
            f"{t['GW'] + t['JW']:.4g} ms (bound "
            f"{t['GW_bound'][0] + t['JW_bound'][0]:.4g}: the product once) "
            f"against the earlier GW {t['GW_old']:.4g} + JW "
            f"{t['JW_old']:.4g} = {t['GW_old'] + t['JW_old']:.4g} ms; the "
            f"TCN route's pieces {tcn_route[name]:.4g} ms" + (
                f" (bf16 head {head_bf16:.4g} + B {ms_b:.4g} + C {ms_c:.4g};"
                f" with the int8 head of hac as shipped "
                f"{tcn_route['hac_int8_head']:.4g})" if name == "hac" else
                f" (upsample {ms_up:.4g} + head {ms_head:.4g} + B "
                f"{ms_b_sup:.4g} + C {ms_c_sup:.4g})"))
    for name, step, tcn_step in (("hac_fused", fused_steps["hac_fused"],
                                  step_int8),
                                 ("sup_fused", fused_steps["sup_fused"],
                                  step_sup)):
        t = wide[name.split("_")[0]]
        log(f"  {name} path per batch: GW + JW {t['GW'] + t['JW']:.4g} ms of "
            f"the {step:.4g} ms device step ({step - tcn_step:+.4g} ms against "
            f"the TCN route's step)")

    for name, key, ms_lstm, dec, step in (
            ("bf16", "A", ms_a, (("B", ms_b), ("C", ms_c)), step_bf16),
            ("int8", "D", ms_d, (("B", ms_b), ("C", ms_c)), step_int8),
            ("rev", "D", ms_d, (("M", ms_m), ("Q", ms_q)), step_rev),
            ("fast", "F", ms_f, (("G", ms_g), ("J", ms_j)), step_fast)):
        kernels_ms = 5 * ms_lstm + dec[0][1] + dec[1][1]
        log(f"  {name} path per batch: 5 x {key} {5 * ms_lstm:.4g} ms + "
            f"{dec[0][0]} {dec[0][1]:.4g} ms + {dec[1][0]} {dec[1][1]:.4g} ms "
            f"= {kernels_ms:.4g} ms of the {step:.4g} ms device step; the "
            f"rest {step - kernels_ms:.4g} ms")
    loss_paths, loss_k, loss_more, ms_u_only, bound_u_only = (
        train_loss_phase(torch, models["bf16"], counters, dev))
    del models
    torch.cuda.empty_cache()
    train = train_step_phase(torch, counters, dev)
    torch.cuda.empty_cache()
    sup_train = sup_train_phase(torch, counters, dev)
    torch.cuda.empty_cache()
    cli = cli_phase(torch, counters, dirs, {"hac": step_int8,
                                            "fast": step_fast}, card)
    runs["cli_hac"] = {"launches": cli["hac"]["launches"]}
    runs["cli_fast"] = {"launches": cli["fast"]["launches"]}
    torch.cuda.empty_cache()
    ctc = ctc_phase(torch, counters, dev, dirs, card)
    dirs["ctc"] = ctc["model_dir"]
    torch.cuda.empty_cache()
    upstream = upstream_phase(torch, counters, dev, dirs,
                              cli["hac"]["reads_dir"], card)
    torch.cuda.empty_cache()
    f32 = f32_phase(torch, counters, dev, dirs, cli["hac"]["reads_dir"],
                    card)

    src_attn = "bonito_tpu_torch/csrc/attention.cu"
    src_window = "bonito_tpu_torch/csrc/attention_window.cu"  # K's, H's
    src_window_bwd = "bonito_tpu_torch/csrc/attention_window_bwd.cu"  # O's
    src_int8 = "bonito_tpu_torch/csrc/lstm_int8.cu"
    src_fused = "bonito_tpu_torch/csrc/decode_tcn_fused.cu"
    src_full = "bonito_tpu_torch/csrc/decode_full.cu"
    src_ring = "bonito_tpu_torch/csrc/decode_tcn_ring.cu"
    src_product = "bonito_tpu_torch/csrc/head_product.cu"  # GW's product
    # launches: the count on the path that is the kernel's own (A: bf16,
    # D, B, C: int8 fused, E: int8 two-stage, F, G, J: fast, K, P: sup, L:
    # the shallow transformer, M, Q: hac's reverse strand, GW, JW and GW's
    # head product: hac_fused); by_path has every path's
    entries = [
        ("lstm_recurrence", "A", "bf16", "bonito_tpu_torch/csrc/lstm.cu",
         "bonito_tpu/ops/lstm_pallas.py:54", err_a, ms_a, plain_a, bound_a,
         lib_a),
        ("decode_tcn_fwd", "B", "int8", src_ring,
         "bonito_tpu/ops/decode_pallas.py:183", err_b, ms_b, plain_b, bound_b,
         None),
        ("decode_tcn_bwd", "C", "int8", src_ring,
         "bonito_tpu/ops/decode_pallas.py:246", err_c, ms_c, plain_c, bound_c,
         None),
        ("lstm_int8_fused", "D", "int8", src_int8,
         "bonito_tpu/ops/lstm_pallas.py:478", err_int8["D"], ms_d, plain_d,
         bound_d, None),
        ("lstm_int8_recurrence", "E", "two_stage", src_int8,
         "bonito_tpu/ops/lstm_pallas.py:355", err_int8["E"], ms_e, plain_e,
         bound_e, None),
        ("lstm_fused", "F", "fast", "bonito_tpu_torch/csrc/lstm_fused.cu",
         "bonito_tpu/ops/lstm_pallas.py:604", err_f, ms_f, plain_f, bound_f,
         lib_f),
        ("decode_fused_fwd", "G", "fast", src_fused,
         "bonito_tpu/ops/decode_pallas.py:348", err_g, ms_g, plain_g, bound_g,
         None),
        ("decode_fused_bwd", "J", "fast", src_fused,
         "bonito_tpu/ops/decode_pallas.py:413", err_j, ms_j, plain_j, bound_j,
         None),
        ("fused_rotary_window_attention", "K", "sup", src_window,
         "bonito_tpu/ops/attention_pallas.py:106", err_attn["K"], ms_k,
         plain_k, bound_k, lib_k),
        ("local_attention", "L", "sup_d40", src_attn,
         "bonito_tpu/ops/attention_pallas.py:26", err_attn["L"], ms_l,
         plain_l, bound_l, lib_l),
        ("pin_layout", "P", "sup", "bonito_tpu_torch/csrc/relayout.cu",
         "bonito_tpu/ops/relayout.py:25", err_p, ms_p, plain_p, bound_p,
         lib_p),
        ("decode_full_fwd", "M", "rev", src_full,
         "bonito_tpu/ops/decode_pallas.py:48", err_m, ms_m, plain_m, bound_m,
         None),
        ("decode_full_bwd", "Q", "rev", src_full,
         "bonito_tpu/ops/decode_pallas.py:109", err_q, ms_q, plain_q, bound_q,
         None),
        # GW: the head product, then the forward pass on B's ring in f32
        # (csrc/decode_tcn_ring.cu); JW: the backward pass on C's ring
        ("decode_fused_wide_fwd", "GW", "hac_fused", src_ring,
         "bonito_tpu/ops/decode_pallas.py:348", err_gw, wide["hac"]["GW"],
         wide["hac"]["GW_plain"], wide["hac"]["GW_bound"], None),
        ("decode_fused_wide_bwd", "JW", "hac_fused", src_ring,
         "bonito_tpu/ops/decode_pallas.py:413", err_jw, wide["hac"]["JW"],
         wide["hac"]["JW_plain"], wide["hac"]["JW_bound"], None),
        # GW's head product; library: torch.matmul in f32 (TF32 off) on its
        # operands, without the bias, tanh, scale and clamp
        ("head_product_wide", "HP", "hac_fused", src_product,
         "bonito_tpu/ops/decode_pallas.py:324", wide["hac"]["HP_err"],
         wide["hac"]["HP"], wide["hac"]["HP_plain"], wide["hac"]["HP_bound"],
         wide["hac"]["HP_library"]),
    ]
    # times at another path's shapes than the one the entry's numbers are of
    more = {"A": {"step_kernel_ms": ms_a_step, "plan": a_plan},
            "D": {"step_kernel_ms": ms_d_step, "plan": int8_plans["D"],
                  "us_a_step": ms_d / T * 1e3},
            "E": {"step_kernel_ms": ms_e_step, "plan": int8_plans["E"],
                  "us_a_step": ms_e / T * 1e3},
            **{k: {"plan": plan_bc, "old_kernel_ms": old,
                   "max_abs_err_vs_old_kernel": bc_vs_old,
                   "sup_shape_ms": sup, "sup_shape_old_kernel_ms": sup_old,
                   "sup_shape_bound_ms": sup_bound[0],
                   "hac_int8_device_step_ms": step_int8,
                   "hac_int8_device_step_old_kernel_ms": step_int8_bc_old,
                   "sup_device_step_ms": step_sup,
                   "sup_device_step_old_kernel_ms": step_sup_bc_old}
               for k, old, sup, sup_old, sup_bound in (
                   ("B", ms_b_old, ms_b_sup, ms_b_sup_old, bound_b_sup),
                   ("C", ms_c_old, ms_c_sup, ms_c_sup_old, bound_c_sup))},
            **{k: full_more(tm, rev_steps, k, vs_old_mq) for k in "MQ"},
            **{k: {"plan": wide["hac"]["plan"],
                   "sup_shape_ms": wide["sup"][k],
                   "sup_shape_plain_ms": wide["sup"][f"{k}_plain"],
                   "sup_shape_bound_ms": wide["sup"][f"{k}_bound"][0],
                   **({"old_kernel_ms": wide["hac"][f"{k}_old"],
                       "sup_shape_old_kernel_ms": wide["sup"][f"{k}_old"],
                       "max_abs_err_vs_old_kernel": wide_vs_old,
                       "tcn_route_ms": tcn_route,
                       "hac_fused_device_step_ms": wide_turns[
                           "hac_fused"]["new"],
                       "hac_fused_device_step_old_kernel_ms": wide_turns[
                           "hac_fused"]["old"],
                       "sup_fused_device_step_ms": wide_turns[
                           "sup_fused"]["new"],
                       "sup_fused_device_step_old_kernel_ms": wide_turns[
                           "sup_fused"]["old"],
                       "hac_fused_peak_gib": wide_turns["hac_fused"][
                           "new_peak"],
                       "hac_fused_peak_old_kernel_gib": wide_turns[
                           "hac_fused"]["old_peak"],
                       "sup_fused_peak_gib": wide_turns["sup_fused"][
                           "new_peak"],
                       "sup_fused_peak_old_kernel_gib": wide_turns[
                           "sup_fused"]["old_peak"]} if k != "HP" else
                      {"f32_cores_bound_ms": wide["hac"]["HP_f32_bound"],
                       "sup_shape_f32_cores_bound_ms":
                           wide["sup"]["HP_f32_bound"],
                       "sup_shape_max_abs_err": wide["sup"]["HP_err"],
                       "sup_shape_library_ms": wide["sup"]["HP_library"],
                       "library_call": "torch.matmul f32, TF32 off, no "
                                       "bias, tanh, scale or clamp"})}
               for k in ("GW", "JW", "HP")},
            "F": {"plan": plan_f, "old_kernel_ms": ms_f_old,
                  "max_abs_err_vs_old_kernel": f_vs_old,
                  "us_a_step": ms_f / FT * 1e3,
                  "fast_device_step_ms": step_fast,
                  "fast_device_step_old_kernel_ms": step_fast_old,
                  "fast_rev_device_step_ms": rev_steps["fast_rev"]["step"],
                  "fast_rev_device_step_old_kernel_ms":
                      rev_steps["fast_rev"]["f_old"]},
            "G": {"plan": plans_gj["G"], "old_kernel_ms": ms_g_old,
                  "max_abs_err_vs_old_kernel": gj_vs_old["G"],
                  "fast_device_step_ms": g_turns["ring"],
                  "fast_device_step_old_kernel_ms": g_turns["old"]},
            "J": {"plan": plans_gj["J"], "old_kernel_ms": ms_j_old,
                  "max_abs_err_vs_old_kernel": gj_vs_old["J"],
                  "fast_device_step_ms": step_fast,
                  "fast_device_step_old_kernel_ms": step_fast_old},
            "K": {"plan": plan_k, "old_kernel_ms": ms_k_old,
                  "sup_device_step_ms": step_sup,
                  "sup_device_step_old_kernel_ms": step_sup_old,
                  "sup_fused_device_step_ms": fused_steps["sup_fused"],
                  "sup_fused_device_step_old_kernel_ms":
                      fused_steps["sup_fused_old"]},
            # the variant P takes at the sup stack's bf16 input (a [N, T,
            # C] view of [N, C, T] memory)
            "P": {"plan": relayout.relayout_plan(
                [SN, ST, SH * SD], [SH * SD * ST, 1, ST], 2)[0],
                  "transpose_times": p_turns["transpose"],
                  "tiles_times": p_turns["tiles"],
                  "old_kernel_times": p_turns["earlier"]},
            "L": {"sup_f32": {
                "max_abs_err": err_attn["L sup f32"], "ms": ms_l32,
                "plain_ms": plain_l32, "bound_ms": bound_l32[0],
                "bound_by": bound_l32[1], "library_ms": lib_l32},
                  "sup_bf16": {
                "max_abs_err": err_attn["L sup bf16"], "ms": ms_l16,
                "plain_ms": plain_l16, "bound_ms": bound_l16[0],
                "bound_by": bound_l16[1], "library_ms": lib_l16}}}
    kernels = []
    for name, key, path, src, rep, err, ms, plain, (bms, by), lib in entries:
        n = runs[path]["launches"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "by_path": {p: r["launches"][key] for p, r in runs.items()},
            **more.get(key, {})})
        log(f"  {name}: {ms:.4g} ms (plain {plain:.4g} ms, bound {bms:.4g} ms "
            f"by {by}), {n} launches on the {path} path")
    # the loss kernels: launches on the path that is each one's own (U, V,
    # Y, Z: train_loss; W, X: loss); no library call computes a CRF
    # partition function or this lattice (torch.nn.functional.ctc_loss is
    # another function: interleaved blanks, a softmax per frame)
    src_logz_ring = "bonito_tpu_torch/csrc/logz_ring.cu"  # U, V, W, X
    src_lat = "bonito_tpu_torch/csrc/lattice.cu"
    # U, V, W and X on the ring, Y and Z split over warps: their plan,
    # their earlier kernels' times, the loss paths (U, V, Y: loss_tcn; W, X:
    # loss) and the train steps (U, V, Y, Z) with them on the earlier
    # kernels
    turn_of = {"U": "uv_turns", "V": "uv_turns", "Y": "y_turns",
               "Z": "z_turns"}
    for key in "UVWXYZ":
        r = loss_k[key]
        loss_more[key].update({
            "plan": r["plan"], "old_kernel_ms": r["old_kernel_ms"],
            "max_abs_err_vs_old_kernel": max(
                [r["diff_old"]] + [loss_more[key][f"{s}_shape_max_abs_err_"
                                                  f"vs_old_kernel"]
                                   for s in ("fast", "sup")]),
            **{k: r[k] for k in ("train_loss_ms", "train_loss_old_kernel_ms",
                                 "valid_loss_ms", "valid_loss_old_kernel_ms",
                                 "loss_ms", "loss_old_kernel_ms",
                                 "no_stack_ms", "no_stack_old_kernel_ms",
                                 "no_stack_bound_ms")
               if k in r}})
        if key in turn_of:
            hac_turns = train["hac"][turn_of[key]]
            sup_turns = sup_train["step"][turn_of[key]]
            loss_more[key].update({
                "hac_train_step_ms": [train["hac"]["ms"]]
                + hac_turns["ring"],
                "hac_train_step_old_kernel_ms": hac_turns["old"],
                "sup_train_step_ms": [sup_train["step"]["ms"]]
                + sup_turns["ring"],
                "sup_train_step_old_kernel_ms": sup_turns["old"]})
    for name, key, path, src, rep in (
            ("logz_tcn_fwd", "U", "train_loss", src_logz_ring,
             "bonito_tpu/ops/logz_pallas.py:246"),
            ("logz_tcn_bwd", "V", "train_loss", src_logz_ring,
             "bonito_tpu/ops/logz_pallas.py:293"),
            ("logz_full_fwd", "W", "loss", src_logz_ring,
             "bonito_tpu/ops/logz_pallas.py:28"),
            ("logz_full_bwd", "X", "loss", src_logz_ring,
             "bonito_tpu/ops/logz_pallas.py:82"),
            ("lattice_fwd", "Y", "train_loss", src_lat,
             "bonito_tpu/ops/lattice_pallas.py:54"),
            ("lattice_bwd", "Z", "train_loss", src_lat,
             "bonito_tpu/ops/lattice_pallas.py:78")):
        r = loss_k[key]
        n = loss_paths[path][0][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
            "by_path": {p: v[0][key] for p, v in loss_paths.items()},
            **loss_more[key],
            **({"no_stack_ms": ms_u_only, "no_stack_bound_ms":
                bound_u_only[0]} if key == "U" else {})})
        log(f"  {name}: {r['ms']:.4g} ms (plain {r['plain_ms']:.4g} ms, "
            f"bound {r['bound'][0]:.4g} ms by {r['bound'][1]}), {n} launches "
            f"on the {path} path")
    # R and S: launches on the hac train step (per step); times, bounds and
    # the library call (a cuDNN LSTM layer's forward + backward, its input
    # projection included) at hac training shapes, fast's beside them
    src_train = "bonito_tpu_torch/csrc/lstm_train.cu"
    err_hac, p_hac, t_hac, b_hac = train["kernels"]["hac"]
    err_fast, p_fast, t_fast, b_fast = train["kernels"]["fast"]
    for name, key, rep, outs in (
            ("lstm_train_fwd", "R", "bonito_tpu/ops/lstm_pallas.py:165",
             ("h", "c", "acts")),
            ("lstm_train_bwd", "S", "bonito_tpu/ops/lstm_pallas.py:192",
             ("dgates", "dxw", "dW_hh"))):
        n = train["hac"]["launches"][key] // TRAIN_STEPS
        kernels.append({
            "name": name, "route": "cuda", "source": src_train,
            "replaces": rep, "launches": n,
            "max_abs_err": max(err_hac[k][2] for k in outs),
            "ms": t_hac[key], "plain_ms": t_hac[f"{key}_plain"],
            "bound_ms": b_hac[key][0], "bound_by": b_hac[key][1],
            "library_ms": t_hac["cudnn"],
            "by_path": {"hac_train_step": n,
                        "fast_train_step": train["fast"]["launches"][key],
                        "train_cli": train["cli"]["launches"][key]},
            "err_relative_to_max": {k: err_hac[k] for k in outs},
            "plan": p_hac[key], "step_kernel_ms": t_hac[f"{key}_step"],
            "step_kernel_err_relative_to_max": {
                k: err_hac[f"step {k}"] for k in outs
                if f"step {k}" in err_hac},
            "fast_shape_plan": p_fast[key],
            "fast_shape_step_kernel_ms": t_fast[f"{key}_step"],
            "fast_shape_ms": t_fast[key],
            "fast_shape_plain_ms": t_fast[f"{key}_plain"],
            "fast_shape_bound_ms": b_fast[key][0],
            "fast_shape_library_ms": t_fast["cudnn"],
            "fast_shape_err_relative_to_max": {k: err_fast[k] for k in outs},
            "fast_shape_step_kernel_err_relative_to_max": {
                k: err_fast[f"step {k}"] for k in outs
                if f"step {k}" in err_fast}})
        log(f"  {name}: {t_hac[key]:.4g} ms (step kernel "
            f"{t_hac[key + '_step']:.4g} ms, plain "
            f"{t_hac[key + '_plain']:.4g} ms, bound {b_hac[key][0]:.4g} ms by "
            f"{b_hac[key][1]}), {n} launches per hac train step")
    # H and O: launches on the sup train step (per step); times, bounds and
    # the library yardstick at its shapes
    for name, key, src, rep, err in (
            ("fused_rotary_window_attention_train_fwd", "H", src_window,
             "bonito_tpu/ops/attention_pallas.py:264",
             max(sup_train["errs"]["o"], sup_train["errs"]["lse"])),
            ("fused_rotary_window_attention_train_bwd", "O", src_window_bwd,
             "bonito_tpu/ops/attention_pallas.py:298",
             sup_train["errs"]["dqkv"])):
        n = sup_train["step"]["launches"][key] // TRAIN_STEPS
        b = sup_train["bounds"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": rep, "launches": n, "max_abs_err": err,
            "ms": sup_train["ms"][key],
            "plain_ms": sup_train["ms"][f"{key}_plain"], "bound_ms": b[0],
            "bound_by": b[1], "library_ms": sup_train["ms"][f"{key}_library"],
            "by_path": {"sup_train_step": n,
                        "sup_train_cli": sup_train["cli"]["launches"][key]},
            **({"plan": sup_train["plan"],
                "old_kernel_ms": sup_train["ms"]["H_old"],
                "sup_train_step_ms": sup_train["step"]["ms"],
                "sup_train_step_old_kernel_ms":
                    sup_train["step"]["old_kernel_ms"]} if key == "H"
               else {"plan": sup_train["o_plan"],
                     "old_kernel_ms": sup_train["ms"]["O_old"],
                     "max_abs_err_vs_old_kernel":
                         sup_train["errs"]["dqkv_old"],
                     "sup_train_step_ms": sup_train["step"]["ms"],
                     "sup_train_step_old_kernel_ms":
                         sup_train["step"]["o_old_kernel_ms"]})})
        log(f"  {name}: {sup_train['ms'][key]:.4g} ms (plain "
            f"{sup_train['ms'][key + '_plain']:.4g} ms, bound {b[0]:.4g} ms by "
            f"{b[1]}), {n} launches per sup train step")
    for k in kernels:
        if k["name"] == "pin_layout":
            k["by_path"]["sup_train_step"] = (
                sup_train["step"]["launches"]["P"] // TRAIN_STEPS)
    # every kernel's count on phase 13's conv-CTC paths (all 0: the
    # family runs no hand kernel)
    letters = ([e[1] for e in entries] + list("UVWXYZ") + ["R", "S", "H",
                                                          "O"])
    require(len(letters) == len(kernels), "a kernel without its letter")
    for k, letter in zip(kernels, letters):
        k["by_path"].update({p: n[letter]
                             for p, n in ctc["launches"].items()})
        # phase 14's paths: the .tar directories' device steps and CLI run,
        # the old-style steps
        k["by_path"].update({p: n[letter]
                             for p, n in upstream["launches"].items()})
        if letter in ("A", "D"):
            k["h768"] = upstream["h768"][letter]
        # phase 15's paths: f32 evaluate, the --no-amp epochs, the CLI to
        # BAM and CRAM (duplex launches nothing: checked there)
        k["by_path"].update({p: n[letter]
                             for p, n in f32["launches"].items()})
    # the f32 instances of A, F, B and C (phase 15): launches on the path
    # that is each one's own (A: evaluate of hac, F: of fast, B and C: the
    # hac --no-amp validation), by_path over phase 15's f32 paths (evaluate
    # and train --no-amp: on the other paths the same counters count bf16)
    fk = f32["kernels"]
    f32_paths = {p: n for p, n in f32["launches"].items()
                 if p.startswith(("f32_evaluate_", "f32_train_"))}
    for name, letter, src, rep, m, path in (
            ("lstm_recurrence_f32", "A", "bonito_tpu_torch/csrc/lstm_f32.cu",
             "bonito_tpu/ops/lstm_pallas.py:54", fk["A"]["hac"],
             "f32_evaluate_hac"),
            ("lstm_fused_f32", "F", "bonito_tpu_torch/csrc/lstm_f32.cu",
             "bonito_tpu/ops/lstm_pallas.py:604", fk["F"]["fast"],
             "f32_evaluate_fast"),
            ("decode_tcn_fwd_ring_f32", "B", src_ring,
             "bonito_tpu/ops/decode_pallas.py:183", fk["BC"]["B"],
             "f32_train_hac"),
            ("decode_tcn_bwd_ring_f32", "C", src_ring,
             "bonito_tpu/ops/decode_pallas.py:246", fk["BC"]["C"],
             "f32_train_hac")):
        # A and F: the plan and the earlier kernel at the main shape, every
        # shape's numbers, the plan evaluate's layers ran
        more = ({k: m[k] for k in (
            "plan", "old_kernel_ms", "old_kernel_max_abs_err",
            "max_abs_err_vs_old_kernel", "library_tf32_ms", "us_a_step")}
            | {"earlier_kernel_source": (
                "bonito_tpu_torch/csrc/lstm_train.cu" if letter == "A"
                else "bonito_tpu_torch/csrc/lstm_fused.cu"),
               "library_call": "torch.nn.LSTM f32 forward, cuDNN, TF32 off "
                               "(library_tf32_ms: TF32 on)",
               "shapes": fk[letter],
               "evaluate_plan": f32["evaluate"]["hac" if letter == "A"
                                                else "fast"]["plan"]}
            if letter in "AF" else
            {"plan": fk["BC"]["plan"], "s64": fk["BC64"][letter],
             "s64_shape": fk["BC64"]["shape"]})
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": f32["launches"][path][letter],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
            "dtype": "f32",
            "by_path": {p: n[letter] for p, n in f32_paths.items()},
            **more})
        log(f"  {name}: {m['ms']:.4g} ms (plain {m['plain_ms']:.4g} ms, "
            f"bound {m['bound_ms']:.4g} ms by {m['bound_by']}), "
            f"{kernels[-1]['launches']} launches on the {path} path")
    # the other f32 instances evaluate and train --no-amp launch (phase
    # 15's f32_gaps): M and Q at evaluate's hac batch (launches: the hac
    # evaluate path), R and S at the --no-amp batch (the hac epoch's path;
    # library: cuDNN's f32 LSTM forward + backward with TF32 off, as the
    # bf16 entries'), K and P at the sup model's forward + decode_batch in
    # f32 at evaluate's batch (its launches; their plans and earlier
    # kernels' times), H and O at the sup --no-amp step (its launches a
    # step; H's plan and earlier kernel's time, O on its earlier kernel)
    gaps = f32["gaps"]
    sup_run = gaps["sup_forward_decode_launches"]
    st32 = f32["sup_train"]

    def earlier_more(m, **more):
        return {k: m[k] for k in ("plan", "old_kernel_ms", "times",
                                  "old_kernel_times", "library_times",
                                  "max_abs_err_vs_old_kernel",
                                  "old_kernel_plan") if k in m} | more
    for name, letter, src, rep, m, path, extra in (
            ("decode_full_fwd_f32", "M", src_full,
             "bonito_tpu/ops/decode_pallas.py:48", gaps["MQ_hac"]["M"],
             "f32_evaluate_hac", {"fast_shape": gaps["MQ_fast"]["M"]}),
            ("decode_full_bwd_f32", "Q", src_full,
             "bonito_tpu/ops/decode_pallas.py:109", gaps["MQ_hac"]["Q"],
             "f32_evaluate_hac", {"fast_shape": gaps["MQ_fast"]["Q"]}),
            ("lstm_train_fwd_f32", "R", "bonito_tpu_torch/csrc/lstm_f32.cu",
             "bonito_tpu/ops/lstm_pallas.py:165", gaps["RS_hac"]["R"],
             "f32_train_hac", rs32_extra(gaps, "R", src_train)),
            ("lstm_train_bwd_f32", "S", "bonito_tpu_torch/csrc/lstm_f32.cu",
             "bonito_tpu/ops/lstm_pallas.py:192", gaps["RS_hac"]["S"],
             "f32_train_hac", rs32_extra(gaps, "S", src_train)),
            ("fused_rotary_window_attention_f32", "K", src_window,
             "bonito_tpu/ops/attention_pallas.py:106", gaps["K"],
             "sup_forward_decode_f32", earlier_more(
                 gaps["K"], earlier_kernel_source=src_attn,
                 library_call="rotary passes + scaled_dot_product_attention"
                              " f32 with the band as a mask, TF32 off",
                 evaluate_sup_plan=f32["evaluate"]["sup"]["plan"])),
            ("pin_layout_f32", "P", "bonito_tpu_torch/csrc/relayout.cu",
             "bonito_tpu/ops/relayout.py:25", gaps["P"],
             "sup_forward_decode_f32", earlier_more(
                 gaps["P"], library_call="Tensor.contiguous()",
                 bf16_t999=gaps["P_bf16_t999"])),
            ("fused_rotary_window_attention_train_fwd_f32", "H", src_window,
             "bonito_tpu/ops/attention_pallas.py:264", st32["H"],
             "f32_train_sup_step", earlier_more(
                 st32["H"], earlier_kernel_source=src_attn,
                 lse_steps=st32["H"]["lse_steps"], no_amp_step=st32["step"],
                 library_call="rotary passes + scaled_dot_product_attention"
                              " f32 with the band as a mask, TF32 off")),
            ("fused_rotary_window_attention_train_bwd_f32", "O", src_attn,
             "bonito_tpu/ops/attention_pallas.py:298", st32["O"],
             "f32_train_sup_step", earlier_more(
                 st32["O"], plan=None, no_amp_step=st32["step"],
                 library_call="the backward of the H library call under "
                              "autograd, TF32 off"))):
        shapes = gaps["MQ_hac" if letter in "MQ" else "RS_hac"] \
            if letter in "MQRS" else m
        lib = (gaps["RS_hac"]["library_ms"] if letter in "RS"
               else m["library_ms"])
        launches = (sup_run.get(letter, 0)
                    if path == "sup_forward_decode_f32"
                    else f32["launches"][path][letter])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": lib, "dtype": "f32", "launches_path": path,
            "shape": shapes["shape"],
            **({"library_tf32_ms": gaps["RS_hac"]["library_tf32_ms"]}
               if letter in "RS" else {}),
            **({"old_kernel_ms": m["old_kernel_ms"]} if letter in "MQ"
               else {}), **extra})
        log(f"  {name}: {m['ms']:.4g} ms (plain {m['plain_ms']:.4g} ms, "
            f"bound {m['bound_ms']:.4g} ms by {m['bound_by']}, library "
            f"{lib}), {launches} launches on the {path} path")
    end = time.perf_counter()
    log(f"chip_smoke.py took {end - t_script:.1f} s (phase 14 "
        f"{upstream['phase_s']:.1f} s, phase 15 {f32['phase_s']:.1f} s); "
        f"seconds by phase, from its first line to the next's: "
        f"{phase_seconds(end)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
