"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``imagecompression_adversarial_tpu_torch`` only (no JAX):

1. requires CUDA and prints the card's name and power limit, and the
   libzstd that the orbax reader (phase 20) loads;
2. builds the GDN kernels (forward and backward, ``csrc/gdn.cu``) with
   nvcc (``kernels/_build.py``) and prints what ``ptxas -v`` reports of
   them: registers, shared memory, spills (any spill fails the phase);
   builds the host rANS coder and the host JPEG, PNG, WebP, TIFF, GIF and
   JPEG 2000 decoders with g++, and round-trips a few bytes through CPython's
   ``lzma``, which the TIFF reader inflates LZMA strips with;
3. holds the forward kernel against ``gdn_forward_reference`` and the
   backward kernel against ``gdn_backward_reference`` for GDN and IGDN at
   every (C, rows) of GDN_SHAPES (the hyper q=1 attack at 768x512, C=192,
   training, the ranks of phase 18, the megapixel calls): the forward; dx,
   and dnorm with it, with dgamma and dbeta through the same cuBLAS and
   torch calls (dx alone above DX_MAX_ROWS); it times each kernel, its
   plain version and the cuBLAS products (``torch.addmm`` and dnorm @
   gamma) beside the card's bound, and prints the launch each kernel picks
   (rows per tile, blocks an SM, grid; the backward's warps a group and a
   block, stages and lane tile too); the training path's largest call
   (131,072 rows) and the 6,144- and 24,576-row calls are also timed over
   500 launches and with L2 flushed before each launch (the forward);
4. runs the attack CLI's ``run`` path (hyper q=1, the committed demo
   weights, a 768x512 image made with numpy, 1001 steps,
   ``-two_phase select``) and counts both kernels' launches in it: the
   backward kernel's must equal the GDN backwards that reached its wrapper;
   prints the rate beside the previous backward kernel's (PREVIOUS_BWD, as
   phases 12a, 19a and 19g do);
5. runs a 20-step attack at 256x256 (hyper q=1, demo weights) with the
   kernel and with the plain version and compares the final noise and vi;
6. writes a 256x256 PNG with the port's writer into a temporary directory,
   runs the CLI on it (``-s``, 5 steps, ``--debug``, cwd there), reads its
   three debug PNGs back with the port's reader and removes the directory;
7. runs the CLI's ``run`` path on the paper's full model, cheng2020-gmm q=3
   (N=128, the committed demo weights), at 768x512 for 1001 steps with
   ``-two_phase select``, and counts both kernels' launches in it;
8. for factorized, context and debug at q=1 (seeded weights) and for
   cheng2020-attn and cheng2020 on the cheng2020-gmm demo's trained
   transforms, runs a 20-step attack at 256x256 as phase 5 does, at phase
   5's tolerances (cheng2020: ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL); prints
   the launch the kernel picks for context's widest call (C=192);
9. runs the real coder (``entropy/codec.py``): hyper q=1 and cheng2020-gmm
   q=3 on their demo weights at 768x512, factorized and context q=1
   (seeded) at 256x256.  Each decodes to the encoder's latent exactly and
   (but context, whose coder writes mean-shifted symbols) to the clipped
   ``dequantize`` forward's x_hat; the trained runs hold real_bpp to
   ideal_bpp, est_bpp and the JAX package's own numbers.  The hyper stream
   decodes again with the plain GDN.  ``cli.codec --encode`` and
   ``--decode`` in two more processes must write the PNG the in-process
   round trip writes, byte for byte, for hyper and cheng2020-gmm;
10. drives the attack and defense engines through their CLIs' ``run`` at
    full width (hyper q1, demo weights, a 768x512 numpy image): the
    adaptive attack through the 8-variant self-ensemble (``--adv
    -ensemble_impl scan``, 201 steps), the RD attack evaluated through the
    ensemble (1001 steps; its two batches of 4 make GDN calls of 393,216
    rows), MI-FGSM best of 2 PGD starts (101 steps each) and the RD attack
    best of 2 restarts (1001 steps each); each prints steps/s, vi, bpp_ori,
    bpp, GDN launches and peak memory, and fails on a non-finite value or
    no launch;
11. runs every engine of phase 10 and the rest of the slice at 256x256
    (hyper q1, demo weights, cuDNN deterministic) with the kernel and with
    the plain GDN at fixed bounds: noise (``im_``) 1e-4 and vi 1e-3 dB for
    the targeted ROI attack, the adaptive ensemble (scan and batch), the
    bitdepth, resize and clip attacks (clip on a profile the phase writes
    from the clean latent), a 2-image batch (also against two single
    runs) and batched against sequential restarts; the same outer rounds
    and bisection decisions and vi 1e-3 dB for CW (normal and fast); at
    most 0.5% of pixels more than 1e-6 apart and vi 1e-2 dB for I-FGSM,
    PGD and MI-FGSM; and the resize on the card against the CPU's at 1e-5;
12. trains hyper q1 from its demo weights on batches of 8 synthetic 256x256
    crops through ``cli.train``'s ``main``, in a temporary working
    directory: (a) 50 RD steps, printing the steady steps/s (the first
    step excluded), GDN launches a step, peak memory and the first and
    last loss, bpp, distortion and aux loss; (b) ``--adv -noise 0.0001
    -steps 101`` to step 12 (the eval and checkpoint at step 10, the final
    checkpoint at 12), printing training and inner-attack steps/s, the
    eval vi and the lr, and checking that the checkpoint restores the
    params and both optimizer states exactly; then a resume to step 14,
    which must print its resume line and go on from step 12; (c) 5 RD steps
    with the kernel and with the plain GDN from the same weights, batches
    and noise, cuDNN deterministic, at fixed bounds: each step's loss
    within TRAIN_LOSS_RTOL, step 1's dgamma/dbeta within TRAIN_GRAD_REL of
    each tensor's largest element, the parameters within Adam's own bound;
    (d) profiles one RD training step by kernel with ``torch.profiler``;
    (e) attacks the codec of 12b's step-12 checkpoint through
    ``cli.attack_rd -ckpt`` (its step directory), 20 steps at 256x256;
13. runs the RD attack through ``cli.attack_rd``'s ``run`` on the five
    adapter families at 768x512 with ``-two_phase select``: nlaic, tic and
    fic q3 on their demo weights, invcompress and hific on seeded weights,
    ADAPTER_STEPS steps (fic with ``-random 2``, so twice); each prints
    steps/s, vi, bpp_ori, bpp, peak memory and GDN launches, and fails on a
    non-finite value, or when nlaic or fic launch no GDN kernel;
14. runs a 20-step attack at 256x256 on nlaic and fic (demo weights) with
    the kernel and with the plain GDN at phase 8's bounds for cheng2020
    (ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL; fic from a random start), and the
    real coder on all five at 768x512: the decoded latent must equal the
    encoder's, and the trained three hold real_bpp to the ideal bits and,
    with the PSNR, to the JAX package's own numbers;
15. (a) trains the classifier through ``cli.classifier_train`` (synthetic
    stream, batch 8, CLS_TRAIN_STEPS steps); (b) runs ``attack_cv
    --cls_ckpt`` with it (hyper q1 demo weights, a 768x512 PNG,
    CLS_ATTACK_STEPS steps), printing steps/s, vi, bpp, both labels, GDN
    launches and peak memory, then the classifier-targeted attack (20
    steps) with the kernel and with the plain GDN at phase 11's bounds;
    (c) trains hific at full width through ``cli.train_hific`` (8 x
    256x256 synthetic crops, GAN_STEPS steps, each synced so that its time
    is read), checks finite losses, that every spectral-normed conv's ``u``
    and ``sigma`` moved, and that the msgpack written reads back equal to
    the trained generator and discriminator, then attacks the trained codec
    through ``attack_rd -m hific -ckpt <that file>`` (20 steps, 256x256);
16. runs the evaluation CLIs on two 768x512 PNGs (hyper q1 demo weights,
    cuDNN deterministic): ``test`` with and without ``--defend``,
    ``random_noise -noise 1e-3``, ``-degrade blurgen`` (to a BLUR_MSE
    budget) and ``-degrade deblur`` on its output, ``recompression -re
    50``; each prints its seconds, AVG line and GDN launches, and each that
    runs the codec runs again with the plain GDN, the two held at
    EVAL_BOUNDS;
17. runs the analysis CLIs on two 768x512 PNGs (hyper q1 demo weights,
    cuDNN deterministic): ``feature_range`` (its profile must load through
    ``load_range_profile(..., require=('dead', 'ranks_min'))``), then
    ``search``, which reads that profile, ``attack_linear`` and
    ``transfer_noise`` (ANALYSIS_STEPS), the cross-model ``transfer_noise
    -cross`` of hyper q1 and cheng2020-gmm q3 (demo weights; each lazy
    leg's peak memory is printed, and a freed leg may leave no more than
    LEG_HELD_MIB allocated), ``visual -degrade noise``,
    ``visual_distribution``, ``compare``, ``mmd --do-fid --do-mmd``
    (random features) and ``jpeg_baseline``; each prints its seconds, GDN
    launches, peak memory and numbers, fails on a non-finite value or on a
    codec run without a launch, and each that runs the codec runs again
    with the plain GDN, its forward-only values held at
    EVAL_BOUNDS["clean"]; then a 20-step cross-image transfer matrix at
    256x256 with the kernel and with the plain GDN, held at VI_ATOL;
18. drives the parallel layer (``parallel/``, ``train_step(..., mesh=)``)
    in spawned ranks, one process each over ``torch.distributed``
    (``parallel/launch.py::run_spmd``, a ``FileStore`` rendezvous), hyper
    q1 on its demo weights, cuDNN deterministic, the kernel on, each run
    held to its one-process counterpart: (b) one NCCL rank on an sp=1
    mesh, the row-sharded forward at 768x512 (GDN_ATOL + GDN_RTOL) and a
    PAR_SP_STEPS-step attack (NOISE_ATOL, VI_ATOL); (a) and (c) two
    ranks, gloo on one card (NCCL refuses two ranks a device) and NCCL
    where each rank has a card of its own: the collective probe (which
    collectives run on CUDA tensors), the dp=2
    corpus attack of PAR_CORPUS numpy-made 768x512 images
    (PAR_CORPUS_STEPS steps, ``select``; NOISE_ATOL, VI_ATOL an image), the
    sp=2 forward (PAR_XHAT_ATOL) and PAR_SP_STEPS-step attack (``select``,
    so that the codec runs on every step), and dp=2 RD
    and ``--adv`` training (TRAIN_KVP_STEPS steps on 8 256x256 crops, phase
    12c's TRAIN_* bounds, every rank holding the same parameters); (d)
    four ranks (gloo or NCCL, as in (c)), one dp x sp = 2 x 2 RD step at
    the same bounds, step 1's gradients in float64 (PAR_F64_GRAD_REL); also
    in (c), sp=2 runs of the large-image slice: the
    paper's model (cheng2020-gmm q3, demo weights) forward and a
    PAR_SP_STEPS-step `select` attack at 768x512 (ANCHOR_NOISE_ATOL,
    ANCHOR_VI_ATOL), the MS-SSIM attack (MSSSIM_FAR_SHARE, VI_ATOL) and a
    split attack at PAR_SPLIT_SIZE (NOISE_ATOL, VI_ATOL); (e) in the same
    two ranks, the five adapter families at q3 (phase 13's weights) on
    sp=2: the forward at 768x512 (PAR_XHAT_ATOL of its scale) and a
    PAR_ADAPTER_STEPS-step `select` attack (nlaic and fic at
    ANCHOR_NOISE_ATOL and ANCHOR_VI_ATOL, fic from a random start and also
    with the plain GDN; tic, hific and invcompress at ADAPTER_FAR_SHARE and
    ADAPTER_VI_ATOL), and for tic, invcompress and hific a
    PAR_ADAPTER_LARGE_STEPS-step attack at PAR_ADAPTER_LARGE_SIZE (cuDNN
    deterministic, then its default heuristics), each rank's peak beside
    one process's; (f) slice 12: in the two ranks of (c), PAR_DEFENSE_STEPS-step
    `select` attacks at 768x512 on sp=2 through the self-ensemble
    (``batch``), the bit-depth reduction and the resize and with ``-p
    64``, each held to one process (PAR_DEFENSE_FAR_SHARE, VI_ATOL;
    bpp_ori within PAR_BPP_RTOL), and the resize's again with the plain GDN, held to its
    kernel run; in the four ranks of (d), one dp x sp = 2 x 2 step with
    ``recompress`` on the ``--adv`` inner attack's example (PAR_ADV_STEPS
    steps), held to one process in float32 (phase 12c's bounds) and in
    float64 (PAR_F64_ATOL); (g) phase 21e's runs on uneven row blocks: in
    the two ranks of (c), ``-p PAR_UNEVEN_PAD``, and in the four ranks of
    (d), the self-ensemble on sp=4 at PAR_UNEVEN_SIZE (phase 21 holds
    them).  It prints each
    world's backend and each rank's card, rate, peak memory and GDN
    launches (added to the ``kernels`` line), and the sp=2 attacks' peaks
    beside the unsharded ones.  Each rank records
    the (C, rows) of its GDN calls; a pair that phase 3 has not held to the
    plain GDN (GDN_SHAPES) fails the phase.  Any rank's failure or a rank
    past PAR_TIMEOUT_S fails the phase.  On one card the ranks time-share
    it: no number there is multi-GPU scaling;
19. megapixel attacks on one card through the large-image path
    (``split_eval``), cuDNN deterministic, each run's peak memory
    (``torch.cuda.max_memory_allocated``), steps/s and GDN launches
    printed: (a) hyper q1 (demo weights) at 4096x3072 (12.6 MP), MP_STEPS
    `select` steps single-program, then split, held to each other at
    NOISE_ATOL and VI_ATOL; (b) the split attack again in the same process,
    with the memory held after both; (c) a split attack at 9344x7040 (65.8
    MP), or at the largest size below it that fits, beside the
    single-program peak scaled from (a); (d) cheng2020-gmm q3 at
    4096x3072, single-program, then split, held to each other at
    ANCHOR_NOISE_ATOL and ANCHOR_VI_ATOL; (e) ``cli.attack_rd --split_eval`` (`cond`, MP_CLI_STEPS
    steps) on a 4096x3072 PNG; (f) the 4096x3072 split attack with the
    kernel and with the plain GDN at NOISE_ATOL and VI_ATOL; (g) (a)'s two
    attacks again (MP_PLAIN_BWD_STEPS steps) with the forward kernel and the
    plain backward, whose peaks it prints beside (a)'s.  A (C, rows) of its
    runs that phase 3 did not hold is held here;
20. resumes the JAX trainer's committed orbax tree (slice 11): (a) reads
    its step 2000 with the port's reader (OCDBT, zarr v2, libzstd through
    ctypes), printing the seconds and bytes read, and holds every leaf's
    path, shape and dtype and the exact sums of params, mu, nu and count to
    the constants the CPU test pins to JAX's restore; (b) runs
    ``cli.train -m hyper -q 4 -metric mse --adv -steps 300`` (the flags
    that name the tree; synthetic batches of 8 256x256 crops) in a
    temporary directory
    holding a copy of that step alone, which must print its resume line,
    take the one step to the ``--adv`` hard stop, save step 2001 and leave
    2000, 2001 and ``best_loss``, step 2000's files unchanged; it prints the
    step's time, the inner attack's rate, GDN launches and peak memory;
    (c) takes one resumed ``train_step`` with the kernel and with the plain
    GDN, held at phase 12c's bounds with the restored lr;
21. JPEG and BMP inputs, uneven row shards and ``-precision bfloat16``
    (slice 15): (a) prints phase 2's build of the JPEG decoder, and decodes
    a textured JPEG_SIZE file coded at JPEG_QUALITY (the port's encoder
    writes Pillow's bytes) with the host C++ decoder and with its numpy
    plain version, which must agree bit for bit, each timed; (b) runs
    ``cli.attack_rd -s x.jpg`` (hyper q1 demo weights, JPEG_ATTACK_STEPS
    steps, cuDNN deterministic), printing its GDN launches, beside the same
    attack on a PNG of the decoded pixels: noise within NOISE_ATOL and vi
    within VI_ATOL; (c) ``cli.train -data`` on a folder of JPEG_TRAIN_FILES
    JPEGs of JPEG_TRAIN_SIZE for JPEG_TRAIN_STEPS steps beside the same
    pixels as PNGs, printing each run's steps/s and the host's decode time
    a batch of each folder, whose batches must be equal; (d)
    PRECISION_STEPS-step hyper attacks through the CLI with ``-precision
    bfloat16`` (TF32 on) and ``highest`` in turns (PRECISIONS), printing
    the rate and vi of each; (e) holds phase 18's uneven row-sharded runs to one process at
    18f's bounds: ``-p PAR_UNEVEN_PAD`` at 768x512 on sp=2 (576 padded rows:
    320 and 256) in 18c's two ranks, and the self-ensemble at
    PAR_UNEVEN_SIZE on sp=4 (the rotated variants' 576 rows: 192, 192, 192
    and 0) in 18d's four ranks;
22. progressive and CMYK JPEGs and every PNG kind (slice 16): (a) prints
    phase 2's build of the PNG decoder, decodes every file of INPUTS_DIR
    (``tests/data/inputs``: progressive 4:2:0 and 4:4:4, CMYK, and PNGs
    interlaced, palette, gray+alpha, 16-bit, 1-, 2- and 4-bit, written by
    its ``make_inputs.py``) with the host C++ decoders and their numpy plain
    versions, which must agree bit for bit and give the sha256 of Pillow's
    ``convert("RGB")`` pixels that ``inputs.json`` records, and times both
    on the 768x512 progressive file and on a 448x256 RGB PNG; (b) runs
    ``cli.attack_rd -s`` on that progressive file (hyper q1 demo weights,
    JPEG_ATTACK_STEPS steps, cuDNN deterministic), printing its GDN
    launches, beside the same attack on a PNG of its pixels: noise within
    NOISE_ATOL and vi within VI_ATOL; (c) ``cli.train -data`` on a folder
    of every file for KINDS_TRAIN_STEPS steps, printing its rate, an
    epoch's host decode time and its launches.  Phase 21c's PNG folder is
    read by the C++ PNG decoder since this slice, and the WebP files of
    INPUTS_DIR join 22c's folder since slice 17;
23. WebP inputs (slice 17): (a) prints phase 2's build of the WebP decoder
    (``csrc/webp.cc``), decodes every WebP of INPUTS_DIR (lossy, lossy
    with alpha, the simple loop filter, a filter sharpness, a bundled
    palette, noise, and WEBP_TEXTURED and WEBP_LOSSLESS, 768x512 q90 lossy
    and its lossless twin) with it, each of which must give the sha256 of
    Pillow's pixels and Pillow's mode that ``inputs.json`` records (the
    decoder has no numpy twin), and times the two 768x512 files (best of
    JPEG_DECODE_RUNS); (b) runs ``cli.attack_rd -s`` on WEBP_TEXTURED
    (hyper q1 demo weights, JPEG_ATTACK_STEPS steps, cuDNN deterministic),
    printing its GDN launches, beside the same attack on a PNG of its
    pixels: noise within NOISE_ATOL and vi within VI_ATOL. Phase 19's
    MP_STEPS went from 11 to 7 to make room for this phase, and to 4 (with
    MP_GMM_STEPS and MP_KVP_STEPS at 3, phase 18's PAR_SP_STEPS at 10 and
    PAR_CORPUS_STEPS at 51) for phase 24.
24. TIFF and GIF inputs and the rest of the BMP, WebP and JPEG kinds
    (slice 18): (a) prints phase 2's builds of the TIFF and GIF decoders
    (``csrc/tiff.cc``, ``csrc/gif.cc``), decodes every slice-18 file of
    INPUTS_DIR (``make_inputs.py``'s TAIL_FILES: TIFFs of every layout and
    coding, GIFs, animated WebPs, palette, RLE and bitfield BMPs,
    RGB-coded, YCCK and 4:4:0/4:1:1 JPEGs), each of which must give the
    sha256 of Pillow's pixels and Pillow's mode that ``inputs.json``
    records (the JPEGs also equal to the numpy decoder), and times
    TAIL_TEXTURED and an uncompressed 768x512 TIFF of ``textured_rgb``
    (seed 5) that a numpy writer here makes (best of JPEG_DECODE_RUNS);
    (b) runs ``cli.attack_rd -s`` on that TIFF (hyper q1 demo weights,
    JPEG_ATTACK_STEPS steps, cuDNN deterministic) beside the same attack
    on a PNG of its pixels: noise within NOISE_ATOL, vi within VI_ATOL,
    and TAIL_LAUNCHES GDN launches; (c) phase 22c's training folder holds
    the slice's BMPs, animated WebPs and JPEGs (the stream lists no TIFF or
    GIF).
25. The TIFF codecs, colour spaces and sample layouts past slice 18
    (slice 19): (a) decodes every committed file of
    ``make_inputs.py``'s CODEC_FILES (JPEG-compressed gray, RGB and YCbCr
    TIFFs in strips and tiles, Zstandard, LZMA, YCbCr under LZW,
    Zstandard and LZMA, CIELab, CCITT RLE, Group 3 2-D and Group 4, 32-bit
    signed, float, signed 16-bit, 12-bit and bit-reversed 16-bit gray),
    each of which must give the sha256 of Pillow's pixels and Pillow's
    mode that ``inputs.json`` records; every JPEG strip or tile must equal
    the numpy JPEG decoder's and every CCITT file the plain fax decoder's
    (``io/fax.py``); times CODEC_TEXTURED (768x512, YCbCr 2x2 JPEG in
    strips of 16 rows) and a 768x512 Zstandard TIFF of ``textured_rgb``
    (seed 5, horizontal differencing) that ``make_inputs.write_tiff``
    writes here, which must give the pixels written (best of
    JPEG_DECODE_RUNS); (b) runs ``cli.attack_rd -s`` on CODEC_TEXTURED
    (hyper q1 demo weights, JPEG_ATTACK_STEPS steps, cuDNN deterministic)
    beside the same attack on a PNG of its pixels: noise within
    NOISE_ATOL, vi within VI_ATOL, and CODEC_LAUNCHES GDN launches.
27. JPEG 2000 inputs and the training stream's decode window (slice 21):
    (a) prints phase 2's build of the JPEG 2000 decoder
    (``csrc/jpeg2000.cc``), decodes every committed ``.jp2``/``.j2k`` of
    INPUTS_DIR, each of which must give the sha256 of Pillow's pixels and
    Pillow's mode that ``inputs.json`` records, and times J2K_TEXTURED
    (9/7) and J2K_LOSSLESS (5/3) on the host; (b) runs ``cli.attack_rd
    -s`` on J2K_TEXTURED beside the same attack on a PNG of its pixels
    (J2K_LAUNCHES); (c) in a child process without CUDA, reads a folder of
    WINDOW_FILES Vimeo-sized PNGs through ``image_folder_batches`` with a
    slow consumer, then closes it: the child's memory growth and the
    close's seconds must stay under WINDOW_MAX_GIB and WINDOW_MAX_CLOSE_S;
    then runs ``cli.train -data`` on the folder in another child and
    prints its rate and wall time.

Phases 5, 8, 11, 12c, 14 and 19 set cuDNN deterministic, so that the kernel and plain
runs differ in the GDN alone, and phase 18 so that its two runs differ in
the sharding alone (18e repeats its 2048x1536 runs with cuDNN's default
heuristics, whose peaks it compares); the coder sets it itself.

Every phase prints one line with the elapsed seconds; any failure raises
and the script exits nonzero.  Phase 18's ranks are processes of their
own, which the phase waits for and stops.  It prints a ``{"coder":
[...]}`` line, a ``{"kernels": [...]}`` line (``gdn_fwd`` and ``gdn_bwd``)
and, last, ``{"ok": true,
"device": {...}}``.  It writes nothing but the builds
(``imagecompression_adversarial_tpu_torch/_build/``) and the temporary
directories of phases 6, 9, 11, 12, 15, 16, 17, 18 (the ranks'
rendezvous), 19, 20, 21, 22, 23, 24, 25, 26 and 27.  It reads five demo checkpoints: hyper q1,
cheng2020-gmm q3, and nlaic, tic and fic q3; step 2000 of the orbax tree
``ckpts/adv/hyper-0.013-mse-0.0001-300``; and the files of
``tests/data/inputs``.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import ctypes.util
import functools
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack")
CKPT_GMM = os.path.join(ROOT, "ckpts", "demo", "cheng2020-gmm-q3-mse-synthetic.msgpack")
# the adapter families of phases 13 and 14 at q3: the trained three on
# their demo trees, invcompress and hific (no demo tree) on seeded weights
ADAPTER_CKPTS = {f: os.path.join(ROOT, "ckpts", "demo", f"{f}-q3-mse-synthetic.msgpack")
                 for f in ("nlaic", "tic", "fic")}
ADAPTERS = ("nlaic", "tic", "fic", "invcompress", "hific")
ADAPTER_STEPS = 101

# H100 SXM peaks (NVIDIA data sheet): HBM rate, the fp32 rate outside the
# tensor cores (the kernel's product runs there) and, as a second column,
# the dense TF32 tensor-core rate (where v4's ran)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain version, elementwise |k - p| <= ATOL + RTOL * |p|.  The
# plain version is an fp32 product (TF32 off).  The kernel's is an fp32 FMA
# chain in the product's order (equal to cuBLAS's on an H100), and
# rsqrtf/sqrtf are within 2 ulp; v4's 3xTF32 (the previous version) kept norm within
# about 1e-6 relative, which these bounds were set for
GDN_RTOL, GDN_ATOL = 1e-5, 1e-6
# 20-step attack, kernel vs plain GDN: Adam divides each gradient by its
# running RMS plus 1e-8, so a pixel whose gradient is near 1e-8 moves by up
# to lr (1e-2) per step on an fp32 rounding difference; the noise elements
# stay within NOISE_ATOL and vi within VI_ATOL dB
NOISE_ATOL = 1e-4
VI_ATOL = 1e-3
# cheng2020 (the anchor) on the demo's trained transforms: its ~65 convs in
# sequence amplify rounding, so that the plain GDN summing in float64 lands
# 2.045e-3 (noise) and 2.65e-3 dB (vi) from the float32 plain GDN after 20
# steps, and no float32 GDN can meet the bounds above.  The kernel reads
# 2.045e-3 and 2.67e-3 dB from the float32 plain GDN (NVIDIA H100 80GB
# HBM3, 700 W; the gap is 2.0e-3 to 2.5e-3 at 5 to 15 steps too)
ANCHOR_NOISE_ATOL = 5e-3
ANCHOR_VI_ATOL = 5e-3

# phase 9, the real coder.  Decoded x_hat vs the clipped dequantize
# forward's (the bound of tests/test_rans.py:120-122 and
# tests/test_golden.py:76-78), and the hyper decode with the plain GDN vs
# the kernel's (float32 GDN sums in another order, through g_s)
CODER_XHAT_ATOL = 1e-5
CODER_PLAIN_XHAT_ATOL = 1e-4
# trained runs: real bits vs the ideal bits of the coded symbols (the coder's
# overhead) and vs the model's estimate (tests/test_golden.py:74)
REAL_VS_IDEAL_RTOL = 0.02
REAL_VS_EST_RTOL = 0.03
# the JAX package's RealCodec on the same image and weights, on a CPU at
# `highest` precision: `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_realcodec.py` on the tree of commit 9066502 with that
# script added (the JAX package is unchanged since a3f9fd3).  The port
# must land within REAL_VS_JAX_RTOL of its real_bpp and PSNR_VS_JAX_DB of its
# PSNR: the float32 transforms differ in the last bits, so a few symbols
# round the other way
JAX_REAL_CODEC = {
    "hyper q1": {"real_bpp": 0.2833251953125, "psnr": 24.397785186767578},
    "cheng2020-gmm q3": {"real_bpp": 0.6161092122395834, "psnr": 22.275646209716797},
    # phase 14, the same script on the tree of this slice (the JAX package
    # unchanged): `python tests/test_torch_realcodec.py nlaic tic fic`
    "nlaic q3": {"real_bpp": 0.4715576171875, "psnr": 26.390838623046875},
    "tic q3": {"real_bpp": 1.9007568359375, "psnr": 16.017681121826172},
    "fic q3": {"real_bpp": 0.09440104166666667, "psnr": 12.553168296813965},
}
REAL_VS_JAX_RTOL = 0.005
PSNR_VS_JAX_DB = 0.01
CODER_SUBPROCESS_TIMEOUT_S = 300

# phase 11: sign-gradient attacks step by alpha * sign(grad), so a gradient
# component within float noise of 0 may flip and move its pixel by 2 alpha;
# at most SIGN_FLIP_SHARE of the pixels may sit more than SIGN_FLIP_ATOL
# apart, and vi within SIGN_VI_ATOL dB
SIGN_FLIP_SHARE = 0.005
SIGN_FLIP_ATOL = 1e-6
SIGN_VI_ATOL = 1e-2
# the resize on the card vs on the CPU
RESIZE_ATOL = 1e-5

# (C, rows) of the GDN/IGDN calls of the hyper attack at 768x512 (q1-5,
# C=128; cheng2020* q1-3 makes the same calls), the widest call of q6-8
# (C=192), the first call of the self-ensemble's batch of 4 variants
# (4 x 98,304 rows), and the calls of a training step on 8 crops of 256x256
# (8 x 128 x 128 rows, then 32,768 and 8,192), and the calls of nlaic q3
# and fic at 768x512 (C=192: 98,304, 24,576 and 6,144 rows); then the
# calls of phase 18's ranks that no other phase makes: 2 images a rank
# (196,608, then 49,152 and 12,288), a half image's rows (49,152, 12,288,
# 3,072), 4 crops a rank (65,536, 16,384, 4,096) and 4 half crops (32,768,
# 8,192, 2,048); then the megapixel calls of phase 19 (and of phase 18's
# one-process 2048x1536 run): 4096x3072 (3,145,728, 786,432, 196,608
# rows), 8192x6144 (12,582,912, 3,145,728, 786,432) and 9344x7040
# (16,445,440, 4,111,360, 1,027,840); then phase 18e's nlaic and fic
# (C=192) on half a 768x512 image a rank: 49,152, 12,288 and 3,072 rows;
# then phase 18f's -p 64 clean forward, a rank's half of the 896x640
# padded image: 71,680, 17,920 and 4,480 rows (its ensemble's batches of 4
# variant blocks make 196,608, 49,152 and 12,288, held above); then phase
# 21e's uneven blocks: -p 32's clean forward on sp=2, 320 and 256 rows of
# the 832x576 padded image (66,560, 16,640, 4,160; 53,248, 13,312, 3,328),
# and the ensemble on sp=4 at 576x512, 128 rows a rank: the batch of 4
# flipped blocks (73,728, 18,432, 4,608) and the clean forward (18,432,
# 4,608, 1,152; the rotated blocks of 192 rows make 98,304, held above)
GDN_SHAPES = ((128, 98304), (128, 24576), (128, 6144), (192, 6144), (128, 393216),
              (128, 131072), (128, 32768), (128, 8192), (192, 98304), (192, 24576),
              (128, 196608), (128, 49152), (128, 12288), (128, 3072), (128, 65536),
              (128, 16384), (128, 4096), (128, 2048), (128, 786432), (128, 3145728),
              (128, 12582912), (128, 1027840), (128, 4111360), (128, 16445440),
              (192, 49152), (192, 12288), (192, 3072), (128, 71680), (128, 17920),
              (128, 4480), (128, 66560), (128, 16640), (128, 4160), (128, 53248),
              (128, 13312), (128, 3328), (128, 73728), (128, 18432), (128, 4608),
              (128, 1152))
# the backward is checked in both modes (dx; dx and dnorm, with dgamma and
# dbeta) up to this many rows; the larger calls (4,111,360 rows and up, 2.1
# GB a tensor and more) check dx alone: x, g, the kernel's dx and the plain
# backward's four temporaries and dx fit on the card at every row count of
# GDN_SHAPES (8.4 GB a tensor at 16,445,440 rows, 59 GB in all), the plain
# backward's dnorm and its dgamma's x^2 beside them not at the largest.  The
# calls above BWD_TIMED_MAX_ROWS take HUGE_LAUNCHES a backward timing, and
# above DX_MAX_ROWS a forward timing too (13 ms and more a launch)
DX_MAX_ROWS = 4_000_000
# the previous backward kernel's numbers (one 8-warp block an SM at C=192,
# tiles copied after the epilogue, gamma read by float2 column pairs in
# dnorm @ gamma), from this script on an NVIDIA H100 80GB HBM3 at 700 W;
# printed beside this run's
PREVIOUS_BWD = {"4 steps/s": 82.14, "12a steps/s": 20.33,
                "19a peak GiB": {"single": 13.243, "split": 9.411},
                "19g peak GiB": {"single": 15.821, "split": 13.348}}
BWD_TIMED_MAX_ROWS = 1_100_000
TIMED_LAUNCHES = 50
HUGE_LAUNCHES = 10
# kernel vs plain outputs are compared in blocks of this many rows, so that
# a megapixel call's comparison needs no tensor-sized temporaries
COMPARE_ROWS = 1 << 20
# also timed over 500 launches and with a 64 MB write before each launch,
# which evicts x and out from the 50 MB L2 as the path's other kernels do:
# the calls small enough to stay in L2 between back-to-back launches, and
# the training path's largest call
L2_FLUSHED_ROWS = (131072, 24576, 6144)
LONG_LAUNCHES = 500
FLUSH_BYTES = 64 << 20
# a device-side wait (~0.1 ms) queued before each flushed launch, so the
# host has enqueued the launch before the device reaches its start event
# and the interval holds the kernel alone, not the wrapper's host time
SLEEP_CYCLES = 200_000

# phase 12, training: hyper q1 from the demo weights, batches of 8 synthetic
# 256x256 crops (the trainer's own defaults), through cli.train's main
TRAIN_FLAGS = ("-m", "hyper", "-q", "1", "-metric", "mse", "-device", "cuda")
TRAIN_RD_STEPS = 50
TRAIN_ADV_ATTACK_STEPS = 101
TRAIN_ADV_FLAGS = ("--adv", "-noise", "0.0001", "-steps", str(TRAIN_ADV_ATTACK_STEPS))
TRAIN_ADV_STEPS, TRAIN_RESUME_STEPS = 12, 14
TRAIN_LR = 1e-4  # -lr_train's default
# 12c, 5 RD steps with the kernel and with the plain GDN, cuDNN
# deterministic, so that the two runs differ in the GDN forward alone.
# The kernel's output stays within ~1e-6 relative of the fp32 plain product
# (GDN_RTOL's reasoning); the loss is a mean and a sum over 524,288 pixels
# of such outputs, so each step's loss within TRAIN_LOSS_RTOL.  Step 1's
# dgamma and dbeta come from the same plain backward, fed activations and
# upstream gradients that differ by that much; their sums over 8,192 to
# 131,072 rows cancel, so each tensor is held to TRAIN_GRAD_REL of its
# largest element, not elementwise.  After the steps, Adam has moved each
# element by at most lr a step, and an element whose gradient sits within
# rounding of zero may take the other sign: every parameter within 2 x 5 x
# lr (the quantiles: the aux lr, 1e-3), and at most TRAIN_FAR_SHARE of the
# elements more than lr / 10 apart
TRAIN_KVP_STEPS = 5
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_FAR_SHARE = 1e-4
# 12d: warm-up steps before the one profiled training step, and the kernel
# categories of its device time, by kernel name (first match wins)
PROFILE_WARMUP = 3
KERNEL_CATEGORIES = (
    ("GDN forward (the kernel)", ("gdn_fwd_kernel",)),
    ("GDN backward (the kernel)", ("gdn_bwd_kernel",)),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn",
                              "fft")),
    ("SGEMM (cuBLAS: GDN dgamma, entropy model)", ("gemm", "gemv", "cublas")),
    ("elementwise, reductions, copies", ("elementwise", "reduce", "copy", "vectorized", "fill",
                                         "cat", "index", "scatter", "gather", "softplus", "erf",
                                         "multi_tensor", "foreach")),
)

# phase 15: the classifier (a), its attack (b) and HiFiC GAN training (c).
# 15b holds the classifier-targeted attack's kernel run (20 steps, 768x512)
# to a float64 run of the same attack (plain GDN; codec, classifier and image
# in float64): its noise no further from it than twice the float32 plain
# run's distance, or NOISE_ATOL if that is larger, and vi within VI_ATOL of
# the plain run.  Kernel against float32 plain (phase 11's check) is printed:
# the cross-entropy's gradient reaches each pixel through the 28x28 resize,
# small, and Adam amplifies its float32 rounding (3.1e-4 apart on the card
# while each run repeats itself bit for bit)
CLS_TRAIN_STEPS = 1001
CLS_ATTACK_STEPS = 201
CLS_LABEL = 3
GAN_STEPS = 30
# phase 16: the evaluation CLIs, each run with the kernel and again with the
# plain GDN (cuDNN deterministic), their AVG values held apart by at most
# these bounds: bpp relative, MS-SSIM absolute, the dB values (PSNR, dpsnr,
# vi_noise, msim_dB) absolute.  "clean" runs are single forwards: the GDN
# outputs differ by ~1e-6 relative, which flips a few latent roundings
# (each moving the PSNR by ~1e-5 dB at 768x512); "chain" is the
# recompression chain, which rounds its output to 8 bits each cycle and
# carries every flip into the next cycle: its bounds are ten times the
# largest gap, rounded up, between the port's float32 runs (oneDNN on and
# off) and its float64 run of the same 50-cycle chain on these two images
# on the CPU (`PYTHONPATH=.:tests python tests/test_torch_eval_clis.py`):
# bpp 1.3e-5 relative, MS-SSIM 8.0e-5, PSNR 9.2e-4 dB and msim_dB 1.2e-3 dB
EVAL_BOUNDS = {"clean": {"bpp": 1e-4, "msim": 1e-5, "dB": 1e-3},
               "chain": {"bpp": 2e-4, "msim": 1e-3, "dB": 2e-2}}
BLUR_MSE = 1e-4  # blurgen's budget: the synthetic image needs ~860 anneal steps
RECOMPRESS_CYCLES = 50
# phase 17: the analysis CLIs on two 768x512 PNGs (hyper q1 demo weights;
# the cross-model matrix adds cheng2020-gmm q3 on its demo weights), cuDNN
# deterministic.  Each run that uses the codec runs again with the plain
# GDN.  Its forward-only values are held at EVAL_BOUNDS["clean"]: the
# profile's arrays, the search scores and the channel rates within the
# "bpp" bound (1e-4) of each array's largest magnitude (float32 values
# computed through the GDN outputs, which differ by ~1e-6 relative), the
# PSNR within the "dB" bound.  The attacks' outcomes (ANALYSIS_STEPS) are
# printed beside their plain runs, not held: phase 5's bounds hold 20
# steps, so a 20-step cross-image matrix at 256x256 is held at VI_ATOL
# instead.  After each cross-model leg is freed, the memory still
# allocated may exceed what was allocated before the run by LEG_HELD_MIB.
ANALYSIS_STEPS = {"attack_linear": 101, "transfer_noise": 201, "cross": 101}
LEG_HELD_MIB = 16
# phase 18: the parallel layer, one process a rank over torch.distributed
# (parallel/launch.py::run_spmd): (b) one NCCL rank, (c) two ranks and (d)
# four, over gloo when they time-share one card and over NCCL when each has
# a card of its own (run_spmd's choice).  Every run is held to its
# single-process counterpart, cuDNN deterministic, the kernel on: the dp=2
# corpus attack (PAR_CORPUS 768x512 images, PAR_CORPUS_STEPS steps,
# `select`) at NOISE_ATOL and VI_ATOL an image; the row-sharded forward's
# x_hat at PAR_XHAT_ATOL (sp=1: at phase 3's GDN_ATOL + GDN_RTOL, since
# its only change is the deconvolutions' exact subpixel form); the
# row-sharded PAR_SP_STEPS-step attack (`select`, the codec on every step)
# at NOISE_ATOL and VI_ATOL; dp=2 RD
# and --adv training (TRAIN_KVP_STEPS steps on 8 x 256x256 crops, the
# --adv inner attack TRAIN_ADV_ATTACK_STEPS steps) and one dp x sp = 2 x 2
# step at phase 12c's TRAIN_* bounds, step 1's gradients of every main
# parameter held at TRAIN_GRAD_REL.  Under dp x sp, step 1's gradients are
# held in float64 (the plain GDN) at PAR_F64_GRAD_REL instead: at 256x256
# a rank holds two rows of z, and the float32 sharded run's scale
# pre-activations sit up to 1.4e-6 from one process's (other conv shapes,
# other sums), so a scale within that of its 0.11 bound is gated in one
# run and not in the other.  On an H100 80GB HBM3 at 700 W one such scale
# put h_s.4's gradient 5.1e-4 apart with the plain GDN (and with the
# kernel, which equals it); in float64 the pre-activations were equal and
# the gradients 8.1e-15 apart.  The bound: float64 rounding (2**-53) times
# the 524,288 terms of the largest sum, 5.8e-11, rounded up
PAR_F64_GRAD_REL = 1e-10
PAR_CORPUS = 4
# PAR_CORPUS_STEPS and PAR_SP_STEPS were 101 and 20 up to phase 24, cut then
# with MP_STEPS below after a whole run of 1007.7 s on a slow host
PAR_CORPUS_STEPS = 51
PAR_SP_STEPS = 10
PAR_XHAT_ATOL = 1e-5
PAR_TIMEOUT_S = 600
# the slice-9 sp=2 runs (phase 18c): cheng2020-gmm q3 at 768x512, its
# attack held at phase 8's ANCHOR_* bounds (its ~65 convs amplify the sums'
# order as they amplify the GDN's); the MS-SSIM attack (`cond`), where a
# few pixels have gradients near Adam's eps (1e-8) and move apart on any
# change in the sums' order (tests/test_torch_parallel.py on the CPU:
# 39-41 of 98,304 elements past 1e-5 at 256x128 after 5 steps): at most
# MSSSIM_FAR_SHARE of the pixels more than NOISE_ATOL apart, vi within
# VI_ATOL (1.61e-5 of the pixels past it on an H100 80GB HBM3 at 700 W,
# so the share leaves room of ~12x); its budget, PAR_MSSSIM_NOISE, lets the output phase (whose loss
# gathers the whole image) run on most steps (at 1e-4 it ran on 1 of 20:
# 24 GDN launches a rank); a split attack at PAR_SPLIT_SIZE (H, W)
MSSSIM_FAR_SHARE = 2e-4
PAR_MSSSIM_NOISE = 1e-3
PAR_SPLIT_SIZE = (1536, 2048)
# phase 18e, the adapter families on sp=2 (slice 10), each at q3 (phase
# 13's weights) and held to one process: the `dequantize` forward at
# 768x512 at PAR_XHAT_ATOL times the largest |x_hat| where that exceeds 1
# (18c's bound is for outputs in [0, 1]; seeded hific's reach 2.46, and its
# sp=2 forward sat 1.007e-5 from one process on an H100 80GB HBM3 at
# 700 W, 4.1e-6 of its scale); a PAR_ADAPTER_STEPS-step `select` attack
# at 768x512 (fic from a random start), nlaic and fic at phase 14's bounds
# (ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL), fic's also with the plain GDN at
# them; tic, hific and invcompress, whose float32 trajectories part on
# pixels whose gradient sits near Adam's eps (on the CPU at 128x128, 3
# steps: hific's sp=2 and one-process runs 9.7-12.9% of the pixels past
# 1e-4, tests/test_torch_parallel_adapters.py; on that card 12.35% at
# 768x512 and vi 2.6e-3 dB apart), at most ADAPTER_FAR_SHARE of the pixels
# more than NOISE_ATOL apart and vi within ADAPTER_VI_ATOL; and, for the
# three families with no split attack, a PAR_ADAPTER_LARGE_STEPS-step
# attack at PAR_ADAPTER_LARGE_SIZE (H, W), whose peak a rank is set beside
# one process's, once under cuDNN deterministic and once with its default
# heuristics (as the CLIs run; LARGE_RUNS): the peaks carry the workspace
# of the algorithm picked for each shape (hific's one-process 768x512
# attack peaked at 9.24 GiB under deterministic against phase 13's 2.29
# GiB at default flags), so the default runs record the allocator's
# history (HISTORY_ENTRIES events at most) and report the cuDNN
# workspace live at their peak
PAR_ADAPTER_STEPS = 10
ADAPTER_FAR_SHARE = 0.25
ADAPTER_VI_ATOL = 0.02
PAR_ADAPTER_LARGE = ("tic", "invcompress", "hific")
PAR_ADAPTER_LARGE_SIZE = (1536, 2048)
PAR_ADAPTER_LARGE_STEPS = 3
LARGE_RUNS = (("large", True), ("large_default", False))  # (record, cuDNN deterministic)
HISTORY_ENTRIES = 2_000_000
# phase 18f, slice 12 (hyper q1, demo weights, cuDNN deterministic): in the
# two ranks of 18c, PAR_DEFENSE_STEPS-step `select` attacks at 768x512 on
# sp=2 through each in-loop defense of PAR_DEFENSES and with -p PAR_PAD
# (its padded 640 rows divide by sp x 64), held to one process at the
# bounds of 18c's MS-SSIM attack: at most PAR_DEFENSE_FAR_SHARE of the
# pixels more than NOISE_ATOL apart (a pixel whose gradient sits near
# Adam's eps moves apart on any change in the sums' order: the first
# bitdepth run on an H100 80GB HBM3 at 700 W sat 1.260e-4 from one
# process, the ensemble's 1.192e-6, while float64 sharded and one-process
# ensemble runs were equal) and vi within VI_ATOL; bpp_ori within
# PAR_BPP_RTOL, the CPU tests' row-sharded bound; and the resize again
# with the plain GDN, held to its kernel run at the same bounds.  In the
# four ranks of 18d, one dp x sp = 2 x 2 step with `recompress` on the
# --adv inner attack's example (PAR_ADV_STEPS steps, -noise 0.0001) of
# 18d's batch, held to one process in float32 at phase 12c's bounds (the
# example at NOISE_ATOL) and, where float32 parts (18d), in float64 with
# the plain GDN at PAR_F64_ATOL (the example, the parameters) and
# PAR_F64_GRAD_REL (the losses)
PAR_DEFENSE_STEPS = 10
PAR_PAD = 64
PAR_DEFENSES = {"ensemble": dict(defend_in_loop="ensemble", ensemble_impl="batch"),
                "bitdepth": dict(defend_in_loop="bitdepth"),
                "resize": dict(defend_in_loop="resize"), "pad": dict(pad=PAR_PAD)}
PAR_BPP_RTOL = 1e-4
PAR_DEFENSE_FAR_SHARE = MSSSIM_FAR_SHARE
PAR_ADV_STEPS = 20
PAR_F64_ATOL = 1e-9
# phase 19: megapixel attacks on one card (hyper q1 and cheng2020-gmm q3 on
# their demo weights, seeded numpy images, cuDNN deterministic, `select`
# unless named): (a) MP_SIZE (H, W) single-program, then split, held to
# each other at phase 5's bounds; (b) the split attack again in the same
# process; (c) MP_LARGE split, or the largest size below it, each side
# MP_SHRINK of the last and a multiple of 64, that fits.  9344x7040 (65.8
# MP) is the largest 64-aligned 4:3 size whose widest activation (128
# channels at half resolution) stays under 2**31 elements: past that,
# cuDNN's 3x3 conv (128 channels, forward and input gradient) took 39 s
# against 1.4 s just under it on an H100 80GB HBM3 at 700 W.
# At 8192x6144 the single-program peak scaled from (a) is 63.3 GiB, which
# the card holds; at 9344x7040 it is 82.7 GiB; (d) cheng2020-gmm
# single-program, then split, at MP_SIZE, held to each other at phase 8's
# ANCHOR_* bounds; (e) cli.attack_rd --split_eval on an MP_SIZE PNG
# (`cond`); (f) the MP_SIZE split attack with the kernel and with the plain
# GDN at phase 5's bounds
MP_SIZE = (3072, 4096)
# MP_STEPS, MP_GMM_STEPS, MP_LARGE_STEPS and MP_KVP_STEPS were 21, 11, 3
# and 11 up to PR 20, and are 11, 6, 2 and 6 since phase 21 was added, to
# keep the run within its time (the split and single-program attacks were
# equal at 21 and 11 steps, and a peak is set in the first step); MP_STEPS
# is 7 since phase 23 was added, which takes back its ~15 s; MP_STEPS,
# MP_GMM_STEPS and MP_KVP_STEPS are 4, 3 and 3 since phase 24, whose first
# whole run on a slow host took 1007.7 s; MP_STEPS is 3 and MP_LARGE_STEPS
# 1 since phase 27 was added (~60 s; 19c's second step took ~11 s)
MP_STEPS = 3
MP_LARGE = (7040, 9344)
# the peak is set in the first step
MP_LARGE_STEPS = 1
MP_SHRINK = 0.9
MP_GMM_STEPS = 3
MP_CLI_STEPS = 101
MP_KVP_STEPS = 3
# (g) the single-program and split attacks again with the plain GDN
# backward, for their peaks beside (a)'s with the backward kernel (a peak
# is set within the first step)
MP_PLAIN_BWD_STEPS = 3
MP_FAR_SHARE = 1e-3
# phase 20: the resume of the JAX trainer's committed orbax tree (slice 11).
# (a) The port's reader on ORBAX_STEP: every leaf's path, shape and dtype
# (their sha256) and the exact float64 sums and sums of
# squares of the params and of both Adams' mu, nu and count
# (ORBAX_FINGERPRINT), the constants tests/test_torch_orbax.py pins to
# JAX's own restore of that step; (b) cli.train with ORBAX_FLAGS, the flags
# that name that tree (-metric mse included: both packages default to
# ms-ssim), in a temporary directory holding a copy of the step alone: it
# resumes at step ORBAX_STEP_NUMBER, takes the one step to the --adv hard
# stop, saves the next step and keeps the copy (-max_steps stops the run
# at that same step, and bounds it should the resume fail); (c) one
# train_step from the restored state with the kernel and with the plain
# GDN at phase 12c's bounds, lr the restored one (the step's loss, step
# 1's dgamma and dbeta within TRAIN_GRAD_REL, the params after the step)
ORBAX_STEP_NUMBER = 2000
ORBAX_STEP = os.path.join(ROOT, "ckpts", "adv", "hyper-0.013-mse-0.0001-300",
                          str(ORBAX_STEP_NUMBER))
ORBAX_FLAGS = ("-m", "hyper", "-q", "4", "-metric", "mse", "--adv", "-steps", "300",
               "-max_steps", str(ORBAX_STEP_NUMBER + 1))
ORBAX_FINGERPRINT = {
    "leaves": "65cfc983dca442e1adf6a6748bfae1b500e02bcfc8008ea187b6ca473fc917ab",
    "params": [283.78110468620116, 28868.738369090566],
    "mu": [-20.214313928732814, 1654.3832925467962],
    "nu": [24872.635254693283, 4409598.030982538],
    "count": [4000.0, 8000000.0],
}


# phase 21 (slice 15): (a) a textured JPEG_SIZE (H, W) image coded at
# JPEG_QUALITY, the C decoder timed best of JPEG_DECODE_RUNS; (b) the
# attack CLI on it (JPEG_ATTACK_STEPS steps); (c) training on JPEG_TRAIN_FILES
# JPEGs of JPEG_TRAIN_SIZE, Vimeo-90k's frame size (the reference trains on
# Vimeo-90k crops), JPEG_TRAIN_STEPS steps of cli.train's batches of 8
# 256x256 crops, and JPEG_DECODE_BATCHES batches timed on the host alone;
# (d) PRECISION_STEPS-step attacks at PRECISIONS, in turns; (e) phase 18's
# uneven runs: -p PAR_UNEVEN_PAD at 768x512 on sp=2 (PAR_DEFENSE_STEPS
# `select` steps) and the ensemble (`batch`) at PAR_UNEVEN_SIZE on sp=4
JPEG_SIZE = (512, 768)
JPEG_QUALITY = 90
JPEG_DECODE_RUNS = 5
JPEG_ATTACK_STEPS = 101
JPEG_TRAIN_SIZE = (256, 448)
JPEG_TRAIN_FILES = 16
JPEG_TRAIN_STEPS = 20
JPEG_DECODE_BATCHES = 2
PRECISION_STEPS = 101
PRECISIONS = ("highest", "bfloat16", "bfloat16", "highest")  # in turns
PAR_UNEVEN_PAD = 32
PAR_UNEVEN_SIZE = (512, 576)
# phase 22 (slice 16): the committed files of every kind in INPUTS_DIR
# (``make_inputs.py`` there wrote them; ``inputs.json`` holds the sha256 of
# Pillow 12.1.0's convert("RGB") pixels of each), (a) each decoded by the
# C++ and the numpy decoders, KINDS_TEXTURED (a 768x512 progressive q90
# JPEG of textured_rgb) and a JPEG_TRAIN_SIZE RGB PNG of Paeth-filtered
# rows timed (C best of JPEG_DECODE_RUNS); (b) the attack CLI on
# KINDS_TEXTURED (JPEG_ATTACK_STEPS steps); (c) KINDS_TRAIN_STEPS steps of
# cli.train -data on a folder of every file
INPUTS_DIR = os.path.join(ROOT, "tests", "data", "inputs")
KINDS_TEXTURED = "textured_progressive.jpg"
KINDS_TRAIN_STEPS = 5
# phase 23 (slice 17): the committed WebPs of INPUTS_DIR, each held to the
# sha256 and mode recorded for Pillow's decode, WEBP_TEXTURED and
# WEBP_LOSSLESS (768x512, make_inputs.py::webp_textured, q90 lossy and its
# lossless twin) timed; the attack CLI on WEBP_TEXTURED beside its PNG twin
WEBP_TEXTURED = "textured_lossy.webp"
WEBP_LOSSLESS = "textured_lossless.webp"
# phase 24 (slice 18): the slice's committed files of INPUTS_DIR (TIFF, GIF,
# animated WebP, palette, RLE and bitfield BMPs, RGB-coded, YCCK and
# 4:4:0/4:1:1 JPEGs), each held to the sha256 and mode recorded for
# Pillow's decode (the JPEGs to the numpy decoder too); TAIL_TEXTURED
# (768x512, LZW with horizontal differencing) and an uncompressed 768x512
# TIFF of textured_rgb(seed 5), written here, timed; the attack CLI on
# that TIFF beside its PNG twin, with TAIL_LAUNCHES (gdn_fwd, gdn_bwd)
TAIL_TEXTURED = "textured_lzw.tif"
TAIL_LAUNCHES = (627, 606)
# phase 25 (slice 19): the committed TIFFs of make_inputs.CODEC_FILES, each
# held to the sha256 and mode recorded for Pillow's decode (JPEG strips to
# the numpy decoder, CCITT files to the plain fax decoder); CODEC_TEXTURED
# (768x512 YCbCr 2x2 JPEG) and a 768x512 Zstandard TIFF written here timed;
# the attack CLI on CODEC_TEXTURED beside its PNG twin, with CODEC_LAUNCHES
# (gdn_fwd, gdn_bwd)
CODEC_TEXTURED = "textured_jpeg.tif"
CODEC_LAUNCHES = (627, 606)
# phase 26 (slice 20): (a) attacks/common.py::make_phase_fwd_scan, hyper q1
# demo weights on a seeded 768x512 image: FWD_SCAN_STEPS steps with the GDN
# kernel, GDN_PER_FWD_STEP launches a step (g_a's three GDNs, g_s_phase's
# three IGDNs), its rate beside phase 4's attack rate, which includes a
# backward and so stays below FWD_SCAN_MAX_RATIO of it; then
# FWD_SCAN_CHECK_STEPS steps with the kernel and with the plain GDN, cuDNN
# deterministic: the final noise, every element the sum of the steps' 1e-6
# x mean(g_s_phase(g_a(x + n))), within FWD_SCAN_RTOL of the plain run's
# (the kernel's outputs sit within ~1e-6 relative of the plain fp32
# product, GDN_RTOL's reasoning; a mean of 1,179,648 of them keeps that)
# plus FWD_SCAN_ATOL; (b) cli.export_ckpt on ORBAX_STEP, which must give
# EXPORT_SHA256 (the JAX script's file), and on an EXPORT_TRAIN_STEPS-step
# cli.train run's checkpoint.pt, read back through io/weights.py; (c) the
# committed files of make_inputs.SLICE20_FILES, each held to the sha256 and
# mode recorded for Pillow's decode, the JPEGs to the numpy decoder;
# SLICE20_TEXTURED (768x512, progressive arithmetic-coded q60, 62 kB: inside
# the one 65,536-byte block in which Pillow reads such a file) timed; (d)
# the attack CLI on SLICE20_TEXTURED beside its PNG twin, with
# SLICE20_LAUNCHES (gdn_fwd, gdn_bwd)
FWD_SCAN_STEPS = 1001
FWD_SCAN_CHECK_STEPS = 101
GDN_PER_FWD_STEP = 6
FWD_SCAN_MAX_RATIO = 1.1
FWD_SCAN_RTOL = 1e-5
FWD_SCAN_ATOL = 1e-12
EXPORT_SHA256 = "e0d8c2882b45af0132aa2fbe43b5399d13feac88bf273b9f454126d1600e77b3"
EXPORT_TRAIN_STEPS = 2
SLICE20_TEXTURED = "textured_arith.jpg"
SLICE20_LAUNCHES = (627, 606)
# phase 27 (slice 21): (a) the committed JPEG 2000 files of INPUTS_DIR
# (make_inputs.py::jpeg2000_files), each held to the sha256 and mode
# recorded for Pillow's decode; J2K_TEXTURED (768x512 9/7 at ratio 20 of
# textured_rgb) and J2K_LOSSLESS (a 768x512 lossless 5/3) timed on the host,
# best of JPEG_DECODE_RUNS; (b) the attack CLI on J2K_TEXTURED beside its PNG
# twin, with J2K_LAUNCHES (gdn_fwd, gdn_bwd); (c) the training stream's
# decode window on WINDOW_FILES PNGs of JPEG_TRAIN_SIZE (Vimeo-90k's frame;
# WINDOW_DISTINCT images, copied), in a child process without CUDA:
# WINDOW_BATCHES of cli.train's batches of 8 256x256 crops, the consumer
# sleeping WINDOW_SLEEP_S a batch (a trainer of ~17 steps/s), then closed;
# its growth (VmHWM less the VmRSS before the stream) must stay under
# WINDOW_MAX_GIB (the window holds 2 * 8 workers * 8 crops of 786,432 bytes,
# the folder 0.75 GiB of them) and the close under WINDOW_MAX_CLOSE_S; then
# cli.train -data on the folder, WINDOW_TRAIN_STEPS steps in a second child,
# its rate and its wall time
J2K_TEXTURED = "textured_j2k.jp2"
J2K_LOSSLESS = "textured_j2k53.jp2"
J2K_LAUNCHES = (627, 606)
WINDOW_FILES = 1024
WINDOW_DISTINCT = 16
WINDOW_BATCHES = 5
WINDOW_SLEEP_S = 0.06
WINDOW_MAX_GIB = 0.25
WINDOW_MAX_CLOSE_S = 1.0
WINDOW_TRAIN_STEPS = 5


def textured_rgb(h: int, w: int, seed: int):
    """(h, w, 3) uint8 pixels made with numpy from ``seed``: the synthetic
    image with fine stripes and noise, so that a JPEG of it carries the
    many AC coefficients of a photo's texture."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    rng = np.random.RandomState(seed)
    img = synthetic_image(h, w, seed=seed)[0] + 0.25 * (rng.rand(h, w, 3) - 0.5)
    img += 0.1 * np.sin(np.arange(w) / 1.7 + seed)[None, :, None]
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def orbax_fingerprint(tree) -> dict:
    """An orbax item's tree (nested dicts; None for its empty leaves) in
    brief: ``leaves``, the sha256 of each leaf's dotted path, shape and
    dtype, sorted, and for the params and both Adams' ``mu``, ``nu`` and
    ``count`` the float64 sum and sum of squares, each exact to the last
    bit (``math.fsum``; a float32's square is exact in float64), so that
    two machines agree to the bit."""
    import hashlib

    import numpy as np

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                yield from walk(child, path + (str(key),))
        elif node is not None:
            yield path, np.asarray(node)

    lines, groups = [], {"params": [], "mu": [], "nu": [], "count": []}
    for path, arr in walk(tree, ()):
        lines.append(f"{'.'.join(path)} {list(arr.shape)} {arr.dtype.str}")
        group = "params" if path[:2] == ("state", "params") else next(
            (g for g in ("mu", "nu", "count") if g in path), None)
        if group:
            groups[group].append(arr.astype(np.float64).ravel())
    out = {"leaves": hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()}
    for group, arrays in groups.items():
        flat = np.concatenate(arrays).tolist() if arrays else []
        out[group] = [math.fsum(flat), math.fsum(x * x for x in flat)]
    return out


def eval_bound(kind: str, field: str) -> float:
    group = "bpp" if field.startswith("bpp") else "msim" if field == "msim" else "dB"
    return EVAL_BOUNDS[kind][group]


def log(msg: str) -> None:
    print(f"[chip_smoke t={time.time() - T0:7.1f}s] {msg}", flush=True)


def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_ms_flushed(fn, flush, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of ``fn`` with ``flush`` run before each launch,
    outside the timed interval."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for start, end in events:
        torch.cuda._sleep(SLEEP_CYCLES)
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / n


def phase_kernel_vs_plain(gdn):
    """Phase 3: the forward and backward kernels against their plain
    versions on the same inputs, at every (C, rows) of GDN_SHAPES; timings.

    The forward kernel is held to ``gdn_forward_reference`` and the backward
    kernel to ``gdn_backward_reference`` (dx, and dnorm with it; dgamma and
    dbeta through the same cuBLAS and torch calls from each route's dnorm),
    each called directly, so that each check tests one kernel; the autograd
    wiring around them is phase 4's count and the card tests'.
    """
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    records = []
    for c, rows in GDN_SHAPES:
        records += gdn_shape_records(gdn, c, rows, gen, flush_buf)
    return records


def held(k, p, label: str) -> dict:
    """``k`` (kernel) against ``p`` (plain), in blocks of COMPARE_ROWS rows:
    raises where an element of ``k`` is not finite or is past GDN_ATOL +
    GDN_RTOL |p|; returns the largest |k - p|, the share of elements equal
    and the share more than 1e-6 apart."""
    import torch

    worst, equal, far = 0.0, 0, 0
    for a, b in zip(k.split(COMPARE_ROWS), p.split(COMPARE_ROWS)):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"{label}: not finite")
        d = (a - b).abs()
        bad = int((d > GDN_ATOL + GDN_RTOL * b.abs()).sum())
        if bad:
            raise RuntimeError(f"{label}: differs at {bad} elements, max |diff| "
                               f"{d.max().item():.3e}")
        worst = max(worst, d.max().item())
        equal += int((a == b).sum())
        far += int((d > 1e-6).sum())
    return {"max_abs": worst, "equal_share": equal / k.numel(), "past_1e-6_share": far / k.numel()}


def held_params(k, p, label: str) -> float:
    """dgamma or dbeta of the kernel's dnorm against the plain's: the
    largest |k - p| over the tensor's largest |p| (phase 20c's measure),
    held to GDN_ATOL + GDN_RTOL of it (sums over all rows, so held by the
    tensor's scale, not elementwise)."""
    scale = p.abs().max().item()
    worst = (k - p).abs().max().item()
    if worst > GDN_ATOL + GDN_RTOL * scale:
        raise RuntimeError(f"{label}: {worst:.3e} apart (scale {scale:.3e})")
    return worst / scale


def gdn_bwd_bound(rows: int, c: int, inverse: bool, dnorm: bool):
    """(bound ms, 'bytes' or 'operations') of the backward kernel: x and g
    read once, dx (and dnorm) written once, gamma and beta; both products
    (4C a row-channel) and the elementwise steps (x^2, + beta, the root,
    dnorm's 3 or 5, m x, x 2, g s, +)."""
    nbytes = 4 * ((4 if dnorm else 3) * rows * c + c * c + c)
    flops = rows * c * (4 * c + (10 if inverse else 12))
    byte_ms, op_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def gdn_shape_records(gdn, c: int, rows: int, gen, flush_buf, phase: str = "3"):
    """Phase 3's check and timings at one (C, rows), GDN and IGDN: the
    forward kernel and the backward kernel against their plain versions on
    the same inputs; the backward in both modes up to DX_MAX_ROWS rows, dx
    alone above."""
    import torch

    x = 2.0 * torch.randn(rows, c, device="cuda", generator=gen)
    gamma = 0.1 * torch.eye(c, device="cuda") + 0.01 * torch.rand(
        c, c, device="cuda", generator=gen
    )
    beta = 0.5 + torch.rand(c, device="cuda", generator=gen)
    g = torch.randn(rows, c, device="cuda", generator=gen)
    both_modes = rows <= DX_MAX_ROWS
    records = []
    for inverse in (False, True):
        torch.cuda.synchronize()
        label = f"gdn C={c} rows={rows} inverse={inverse}"
        layout = gdn.kernel_layout(rows, c, inverse)
        bwd_layout = gdn.kernel_layout(rows, c, inverse, backward=True)
        fwd = held(gdn.gdn_forward(x, gamma, beta, inverse),
                   gdn.gdn_forward_reference(x, gamma, beta, inverse), f"{label}: forward")
        bwd = {"mode": "dx, dnorm" if both_modes else "dx"}
        kdx, kdn = gdn.gdn_backward(x, gamma, beta, g, inverse, True, both_modes)
        pdx, pdn = gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, both_modes)
        bwd["dx"] = held(kdx, pdx, f"{label}: backward dx")
        del kdx, pdx
        if both_modes:
            bwd["dnorm"] = held(kdn, pdn, f"{label}: backward dnorm")
            for what, k, p in zip(("dgamma", "dbeta"), gdn.param_grads(x, kdn, True, True),
                                  gdn.param_grads(x, pdn, True, True)):
                bwd[f"{what}_rel"] = held_params(k, p, f"{label}: backward {what}")
        del kdn, pdn
        torch.cuda.synchronize()

        def kernel():
            gdn.gdn_forward(x, gamma, beta, inverse)

        n = TIMED_LAUNCHES if rows <= DX_MAX_ROWS else HUGE_LAUNCHES
        ms = time_ms(kernel, n)
        plain_ms = time_ms(lambda: gdn.gdn_forward_reference(x, gamma, beta, inverse), n)
        library_ms = time_ms(lambda: torch.addmm(beta, x * x, gamma.T), n)
        nbytes = 4 * (2 * rows * c + c * c + c)
        flops = rows * c * (2 * c + 4)
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * flops / FP32_FLOP_PER_S

        n = TIMED_LAUNCHES if rows <= BWD_TIMED_MAX_ROWS else HUGE_LAUNCHES
        bwd["ms"] = time_ms(lambda: gdn.gdn_backward(x, gamma, beta, g, inverse, True, False), n)
        bwd["plain_ms"] = time_ms(
            lambda: gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, False), n)
        if both_modes:
            bwd["dnorm_ms"] = time_ms(
                lambda: gdn.gdn_backward(x, gamma, beta, g, inverse, True, True), n)
            bwd["plain_dnorm_ms"] = time_ms(
                lambda: gdn.gdn_backward_reference(x, gamma, beta, g, inverse, True, True), n)
            bwd["dnorm_bound_ms"] = gdn_bwd_bound(rows, c, inverse, True)[0]
        bwd["addmm_ms"] = library_ms
        # g stands in for dnorm: the same shape and layout, the same product
        bwd["dnorm_gamma_ms"] = time_ms(lambda: g @ gamma, n)
        bwd["bound_ms"], bwd["bound_by"] = gdn_bwd_bound(rows, c, inverse, False)
        bwd["max_abs_err"] = max(bwd["dx"]["max_abs"], bwd.get("dnorm", {}).get("max_abs", 0.0))
        bwd["layout"] = bwd_layout
        rec = {
            "C": c, "rows": rows, "inverse": inverse, "max_abs_err": fwd["max_abs"],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "tf32_bound_ms": max(byte_ms, 1e3 * flops / TF32_FLOP_PER_S),
            "layout": layout, "backward": bwd,
        }
        more = ""
        if rows in L2_FLUSHED_ROWS:
            rec["ms_500"] = time_ms(kernel, LONG_LAUNCHES)
            rec["ms_l2_flushed"] = time_ms_flushed(kernel, flush_buf.zero_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LONG_LAUNCHES):
                kernel()
            rec["host_ms"] = 1e3 * (time.perf_counter() - t0) / LONG_LAUNCHES
            torch.cuda.synchronize()
            more = (f" (x{LONG_LAUNCHES} {rec['ms_500']:.4f}, L2 flushed "
                    f"{rec['ms_l2_flushed']:.4f}, host enqueue {rec['host_ms']:.4f})")
        records.append(rec)
        kind = "IGDN" if inverse else "GDN "
        log(
            f"phase {phase} {kind} C={c} rows={rows}: max_abs_err "
            f"{fwd['max_abs']:.3e}  kernel {ms:.4f} ms{more}  plain "
            f"{plain_ms:.4f} ms  addmm {library_ms:.4f} ms  bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}; TF32 tensor-core bound {rec['tf32_bound_ms']:.4f} ms)  "
            f"launch: {layout['tile']}-row tiles, {layout['blocks_per_sm']} blocks/SM, "
            f"grid {layout['grid']}, {layout['smem_bytes']} B shared"
        )
        dx = bwd["dx"]
        both = (f", dnorm {bwd['dnorm']['max_abs']:.3e} (equal {bwd['dnorm']['equal_share']:.6f}), "
                f"dgamma {bwd['dgamma_rel']:.3e} and dbeta {bwd['dbeta_rel']:.3e} of their "
                f"largest; kernel dx+dnorm {bwd['dnorm_ms']:.4f} ms, plain "
                f"{bwd['plain_dnorm_ms']:.4f} ms, bound {bwd['dnorm_bound_ms']:.4f} ms"
                if both_modes else " (dx alone at this size)")
        log(
            f"phase {phase} {kind} C={c} rows={rows} backward: dx max_abs_err "
            f"{dx['max_abs']:.3e} (equal {dx['equal_share']:.6f}, past 1e-6 "
            f"{dx['past_1e-6_share']:.2e}){both}; kernel dx {bwd['ms']:.4f} ms, plain "
            f"{bwd['plain_ms']:.4f} ms, cuBLAS addmm {library_ms:.4f} + dnorm@gamma "
            f"{bwd['dnorm_gamma_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}); "
            f"launch: {bwd_layout['tile']}-row tiles a group of {bwd_layout['group_warps']} warps, "
            f"{bwd_layout['stages']} stages, lane tile {bwd_layout['lane_rows']}x"
            f"{bwd_layout['lane_channels']}, {bwd_layout['warps']} warps a block, "
            f"{bwd_layout['blocks_per_sm']} blocks/SM, grid {bwd_layout['grid']}, "
            f"{bwd_layout['smem_bytes']} B shared"
        )
    return records


def phase_main_path(gdn):
    """Phase 4: the attack CLI's run path at full width and size."""
    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    steps = 1001
    cfg = parse_config([
        "-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT,
        "-steps", str(steps), "-two_phase", "select", "-device", "cuda",
    ])
    im = synthetic_image(512, 768, seed=0)
    backwards = collections.Counter()
    wrapper = gdn.gdn_backward

    def counted(*args):
        backwards["calls"] += 1
        return wrapper(*args)

    gdn.reset_launch_counts()
    gdn.gdn_backward = counted
    try:
        avg = run(cfg, images=[("synthetic-768x512", im, 512, 768)])
    finally:
        gdn.gdn_backward = wrapper
    launches, launches_bwd = gdn.launch_counts["gdn_fwd"], gdn.launch_counts["gdn_bwd"]
    for key in ("vi", "bpp_ori", "bpp"):
        if not math.isfinite(avg[key]):
            raise RuntimeError(f"main path: {key} is not finite ({avg[key]})")
    if launches == 0 or launches_bwd == 0:
        raise RuntimeError(f"main path launched gdn_fwd {launches} and gdn_bwd {launches_bwd} times")
    if launches_bwd != backwards["calls"]:
        raise RuntimeError(f"main path: {backwards['calls']} GDN backwards, gdn_bwd launched "
                           f"{launches_bwd} times")
    log(
        f"phase 4 main path: {steps / avg['t']:.2f} steps/s (incl. clean forward and eval), "
        f"vi {avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, "
        f"gdn_fwd launches {launches} ({launches / steps:.3f} per step), gdn_bwd launches "
        f"{launches_bwd} ({launches_bwd / steps:.3f} per step; {backwards['calls']} GDN backwards); "
        f"the previous backward kernel's rate {PREVIOUS_BWD['4 steps/s']:.2f} steps/s"
    )
    return launches, launches_bwd, steps / avg["t"]


def has_gdn(codec) -> bool:
    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    return any(isinstance(m, GDN) for m in codec.modules())


def use_gdn_kernel(codec, on: bool) -> None:
    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    for m in codec.modules():
        if isinstance(m, GDN):
            m.use_kernel = on


def load_codec(model: str, quality: int, checkpoint=None, demo_transforms: bool = False):
    """The codec on the card; ``demo_transforms`` fills every parameter that
    the cheng2020-gmm demo checkpoint shares with ``model`` from it (all of
    g_a and g_s for cheng2020 and cheng2020-attn) and keeps the seeded rest."""
    import torch

    from imagecompression_adversarial_tpu_torch.config import Config
    from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint
    from imagecompression_adversarial_tpu_torch.runtime import load_model

    codec = load_model(Config(device="cuda", model=model, quality=quality, checkpoint=checkpoint))
    if demo_transforms:
        own = codec.state_dict()
        demo = load_checkpoint(CKPT_GMM, "cheng2020-gmm")
        shared = {k: v for k, v in demo.items() if k in own and v.shape == own[k].shape}
        if not any(k.startswith("g_s.") for k in shared):
            raise RuntimeError(f"{model}: the demo checkpoint shares no synthesis with it")
        codec.load_state_dict({**own, **shared}, strict=True)
        codec = codec.to(memory_format=torch.channels_last)
    return codec


def attack_kernel_vs_plain(gdn, label: str, codec, debug_model: bool = False,
                           noise_atol: float = NOISE_ATOL, vi_atol: float = VI_ATOL,
                           random_start: bool = False) -> int:
    """20-step attack at 256x256 with the kernel and with the plain GDN,
    cuDNN set deterministic; every element of the final noise must agree
    within ``noise_atol`` and vi within ``vi_atol`` dB.  ``random_start``
    starts both runs from the same uniform(+-1e-2) noise (a restart's init,
    drawn from a generator seeded 0).  Returns the kernel run's launches."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    x = to_tensor(synthetic_image(256, 256, seed=1), "cuda")
    attack = make_attack_fn(codec, RDAttackConfig(steps=20, two_phase_impl="select",
                                                  debug_model=debug_model,
                                                  random_restarts=2 if random_start else 1))
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    results = []
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        for use_kernel in (True, False):
            use_gdn_kernel(codec, use_kernel)
            gdn.reset_launch_counts()
            res = attack(x, torch.Generator("cuda").manual_seed(0))
            torch.cuda.synchronize()
            results.append((res["im_"] - x, res["vi"].item(), gdn.launch_counts["gdn_fwd"]))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    (nk, vik, lk), (npl, vip, lp) = results
    diff = (nk - npl).abs().max().item()
    log(f"{label} attack 256x256 x20 steps: max |noise diff| {diff:.3e} (tol {noise_atol}), "
        f"vi kernel {vik:.6f} plain {vip:.6f} (tol {vi_atol}), gdn_fwd launches {lk} / {lp}")
    if (lk == 0) == has_gdn(codec) or lp != 0:
        raise RuntimeError(f"{label}: launch counts: kernel run {lk}, plain run {lp}")
    if not (math.isfinite(vik) and math.isfinite(vip)):
        raise RuntimeError(f"{label}: non-finite vi ({vik}, {vip})")
    if diff > noise_atol or abs(vik - vip) > vi_atol:
        raise RuntimeError(f"{label}: kernel vs plain attack differ beyond the tolerances")
    return lk


def phase_attack_kernel_vs_plain(gdn):
    """Phase 5: the hyper q1 attack (demo weights), kernel vs plain GDN."""
    attack_kernel_vs_plain(gdn, "phase 5 hyper q1", load_codec("hyper", 1, CKPT))


def phase_cli_png():
    """Phase 6: the CLI's file path, a PNG in through ``-s`` and the
    ``--debug`` PNGs out, with the port's own PNG codec."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import main as cli_main
    from imagecompression_adversarial_tpu_torch.io.image import (
        read_image, synthetic_image, write_image,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_png_")
    cwd = os.getcwd()
    try:
        src = os.path.join(tmp, "synthetic01.png")
        write_image(synthetic_image(256, 256, seed=2), src)
        os.chdir(tmp)
        cli_main(["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-s", src,
                  "-steps", "5", "--debug", "-device", "cuda"])
        for kind in ("advin", "advout", "noise"):
            im, h, w = read_image(os.path.join(tmp, "attack", "results",
                                               f"hyper_1_mse_synthetic01_{kind}.png"))
            if (h, w) != (256, 256) or im.shape != (1, 256, 256, 3) or not np.isfinite(im).all():
                raise RuntimeError(f"phase 6: {kind} PNG read back as {im.shape}, ({h}, {w})")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    log("phase 6 CLI on a PNG: -s in, 3 --debug PNGs out and read back at 256x256")


def phase_slice2_path(gdn):
    """Phase 7: the CLI's run path on cheng2020-gmm q3 at full width and
    size, the phase-space loss on (auto)."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    steps = 1001
    cfg = parse_config([
        "-m", "cheng2020-gmm", "-q", "3", "-metric", "mse", "-ckpt", CKPT_GMM,
        "-steps", str(steps), "-two_phase", "select", "-device", "cuda",
    ])
    im = synthetic_image(512, 768, seed=0)
    torch.cuda.reset_peak_memory_stats()
    gdn.reset_launch_counts()
    avg = run(cfg, images=[("synthetic-768x512", im, 512, 768)])
    launches, launches_bwd = gdn.launch_counts["gdn_fwd"], gdn.launch_counts["gdn_bwd"]
    for key in ("vi", "bpp_ori", "bpp"):
        if not math.isfinite(avg[key]):
            raise RuntimeError(f"phase 7: {key} is not finite ({avg[key]})")
    if launches == 0 or launches_bwd == 0:
        raise RuntimeError(f"phase 7 launched gdn_fwd {launches} and gdn_bwd {launches_bwd} times")
    log(
        f"phase 7 cheng2020-gmm q3 768x512: {steps / avg['t']:.2f} steps/s (incl. clean forward "
        f"and eval, {avg['t']:.2f} s), vi {avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, "
        f"bpp {avg['bpp']:.4f}, gdn_fwd launches {launches} ({launches / steps:.3f} per step), "
        f"gdn_bwd launches {launches_bwd}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    return launches, launches_bwd


def phase_families_kernel_vs_plain(gdn):
    """Phase 8: every other new family, kernel vs plain GDN.  factorized,
    context and debug run at q1 with seeded weights.  cheng2020-attn and
    cheng2020 run with the demo checkpoint's trained transforms (N=128, as
    at q1-3): with seeded transforms their attack is chaotic."""
    import torch

    torch.cuda.synchronize()
    layout = gdn.kernel_layout(128 * 128, 192, False)
    log(f"phase 8 context's widest GDN call (C=192, 16,384 rows): {layout['tile']}-row tiles, "
        f"{layout['blocks_per_sm']} blocks/SM, grid {layout['grid']}, "
        f"{layout['smem_bytes']} B shared")
    launches = {}
    for model in ("factorized", "context", "debug"):
        launches[f"{model} q1"] = attack_kernel_vs_plain(
            gdn, f"phase 8 {model} q1", load_codec(model, 1), debug_model=(model == "debug"))
    for model, noise_atol, vi_atol in (("cheng2020-attn", NOISE_ATOL, VI_ATOL),
                                       ("cheng2020", ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL)):
        launches[f"{model} q3 demo transforms"] = attack_kernel_vs_plain(
            gdn, f"phase 8 {model} q3 demo transforms",
            load_codec(model, 3, demo_transforms=True), noise_atol=noise_atol, vi_atol=vi_atol)
    return launches


@contextlib.contextmanager
def timed_split(model):
    """Wall seconds, each after a CUDA sync, spent in the codec's transforms
    (g_a, h_a, h_s, g_s), in the host's CDF rows and scale indexes, in the
    rANS calls and in the ideal-bits audit, while the block runs; the rest of
    a call is the context head on the device, its syncs and the copies."""
    import torch

    from imagecompression_adversarial_tpu_torch.entropy import autoregressive, codec, rans

    times = collections.defaultdict(float)
    starts = {}

    def wrap(bucket, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[bucket] += time.perf_counter() - t
            return out
        return timed

    patches = [(mod, name, bucket) for bucket, pairs in (
        ("cdf rows", ((autoregressive, "build_gmm_cdf_rows"), (autoregressive, "gc_build_indexes"),
                      (codec, "gc_build_indexes"))),
        ("rans", ((autoregressive, "encode_with_indexes"), (rans, "encode_with_indexes"),
                  (rans, "decode_with_indexes"), (rans.StreamingDecoder, "decode"))),
        ("ideal bits", ((autoregressive, "ideal_bits"), (codec, "ideal_bits"))),
    ) for mod, name in pairs]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, bucket in patches:
        setattr(mod, name, wrap(bucket, getattr(mod, name)))

    def pre(m, args):
        torch.cuda.synchronize()
        starts[m] = time.perf_counter()

    def post(m, args, out):
        torch.cuda.synchronize()
        times["transforms"] += time.perf_counter() - starts[m]

    # the transforms that are modules (tic, hific and invcompress make
    # g_a and g_s methods over their own submodules)
    subs = [getattr(model, n) for n in ("g_a", "h_a", "h_s", "g_s")
            if isinstance(getattr(model, n, None), torch.nn.Module)]
    hooks = [h for sub in subs
             for h in (sub.register_forward_pre_hook(pre), sub.register_forward_hook(post))]
    try:
        yield times
    finally:
        for h in hooks:
            h.remove()
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def coder_run(gdn, label: str, model, h: int, w: int, trained: bool, phase: str = "9",
              est_rtol=REAL_VS_EST_RTOL):
    """Phase 9 (and 14), one run: encode and decode synthetic_image(h, w,
    seed=0) on the card, check the round trip, and time encode and decode
    (then again, split by ``timed_split``, for the trained runs).
    ``est_rtol=None`` reports real_bpp against the model's estimate without
    holding it there."""
    import torch

    from imagecompression_adversarial_tpu_torch.entropy.codec import RealCodec, coder_settings
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods, psnr

    x = to_tensor(synthetic_image(h, w, seed=0), "cuda")
    codec = RealCodec(model)
    gdn.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = {}
    out = codec.compress(x, trace)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    y_hat = codec.decode_latent(out["strings"], out["shape"])
    x_hat = codec.synthesize(y_hat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = gdn.launch_counts["gdn_fwd"]

    if y_hat.shape != trace["y_hat"].shape or not torch.equal(y_hat, trace["y_hat"]):
        bad = int((y_hat != trace["y_hat"]).sum()) if y_hat.shape == trace["y_hat"].shape else -1
        raise RuntimeError(f"phase {phase} {label}: decoded latent differs from the encoder's at "
                           f"{bad} of {y_hat.numel()} elements")
    with coder_settings():
        ref = model(x, "dequantize")
        x_ref = torch.clamp(ref["x_hat"], 0.0, 1.0)
    num_pixels = h * w
    rec = {
        "run": label, "shape": [h, w], "stream_shape": list(out["shape"]),
        "real_bpp": codec.real_bpp(out, num_pixels),
        "ideal_bpp": out["ideal_bits"] / num_pixels,
        "est_bpp": float(bpp_from_likelihoods(ref["likelihoods"], num_pixels)),
        "psnr": float(psnr(x_hat, x)),
        "encode_s": t1 - t0, "decode_s": t2 - t1, "gdn_launches": launches,
        "xhat_vs_forward": (x_hat - x_ref).abs().max().item(),
    }
    if x_hat.shape != x.shape or not torch.isfinite(x_hat).all():
        raise RuntimeError(f"phase {phase} {label}: x_hat {tuple(x_hat.shape)} not finite or "
                           "misshapen")
    if not all(math.isfinite(rec[k]) for k in ("real_bpp", "ideal_bpp", "est_bpp", "psnr")):
        raise RuntimeError(f"phase {phase} {label}: non-finite result {rec}")
    if launches == 0 and has_gdn(model):
        raise RuntimeError(f"phase {phase} {label}: the coder ran without launching the GDN kernel")
    # context's coder writes mean-shifted symbols while its forward rounds
    # means-free; fic's forward decodes the un-quantized latent
    if model.entropy_structure not in ("context", "context4") and \
            rec["xhat_vs_forward"] > CODER_XHAT_ATOL:
        raise RuntimeError(f"phase {phase} {label}: x_hat {rec['xhat_vs_forward']:.3e} from the "
                           f"dequantize forward (tol {CODER_XHAT_ATOL})")
    gap_ideal = rec["real_bpp"] / rec["ideal_bpp"] - 1.0
    gap_est = rec["real_bpp"] / rec["est_bpp"] - 1.0
    more = ""
    if trained:
        if abs(gap_ideal) > REAL_VS_IDEAL_RTOL or (est_rtol is not None and abs(gap_est) > est_rtol):
            raise RuntimeError(f"phase {phase} {label}: real_bpp {rec['real_bpp']:.5f} vs ideal "
                               f"{gap_ideal:+.4f} (tol {REAL_VS_IDEAL_RTOL}), vs est "
                               f"{gap_est:+.4f} (tol {est_rtol})")
        jax_ref = JAX_REAL_CODEC[label]
        gap_jax = rec["real_bpp"] / jax_ref["real_bpp"] - 1.0
        dpsnr = rec["psnr"] - jax_ref["psnr"]
        rec.update(real_vs_jax=gap_jax, psnr_vs_jax=dpsnr)
        if abs(gap_jax) > REAL_VS_JAX_RTOL or abs(dpsnr) > PSNR_VS_JAX_DB:
            raise RuntimeError(f"phase {phase} {label}: real_bpp {gap_jax:+.5f} (tol {REAL_VS_JAX_RTOL}) "
                               f"and PSNR {dpsnr:+.4f} dB (tol {PSNR_VS_JAX_DB}) from JAX's")
        more = f", vs JAX real_bpp {gap_jax:+.5f} psnr {dpsnr:+.4f} dB"
        for what, fn in (("encode", lambda: codec.compress(x)),
                         ("decode", lambda: codec.decompress(out["strings"], out["shape"]))):
            with timed_split(model) as split:
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                total = time.perf_counter() - t
            parts = dict(split)
            parts["device head, syncs, copies"] = total - sum(split.values())
            rec[f"{what}_split_s"] = {"total": total, **parts}
            more += f"; {what} split (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec[f"{what}_split_s"].items())
    log(f"phase {phase} {label} {w}x{h}: real_bpp {rec['real_bpp']:.5f} est_bpp {rec['est_bpp']:.5f} "
        f"ideal_bpp {rec['ideal_bpp']:.5f} (real vs ideal {gap_ideal:+.4f}, vs est {gap_est:+.4f})"
        f", psnr {rec['psnr']:.4f} dB, encode {rec['encode_s']:.3f} s, decode "
        f"{rec['decode_s']:.3f} s, gdn_fwd launches {launches}, latent round trip exact, "
        f"x_hat vs forward {rec['xhat_vs_forward']:.3e}{more}")
    return codec, out, y_hat, x_hat, rec


def coder_kernel_vs_plain(gdn, codec, out, y_hat, x_hat) -> dict:
    """Phase 9: the hyper stream decoded again with the plain GDN."""
    import torch

    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    gdns = [m for m in codec.module.modules() if isinstance(m, GDN)]
    try:
        for m in gdns:
            m.use_kernel = False
        gdn.reset_launch_counts()
        y_plain = codec.decode_latent(out["strings"], out["shape"])
        x_plain = codec.synthesize(y_plain)
        torch.cuda.synchronize()
        launches = gdn.launch_counts["gdn_fwd"]
    finally:
        for m in gdns:
            m.use_kernel = True
    diff = (x_plain - x_hat).abs().max().item()
    log(f"phase 9 hyper q1 decode with the plain GDN: latent equal {torch.equal(y_plain, y_hat)}, "
        f"max |x_hat diff| {diff:.3e} (tol {CODER_PLAIN_XHAT_ATOL}), gdn_fwd launches {launches}")
    if not torch.equal(y_plain, y_hat) or diff > CODER_PLAIN_XHAT_ATOL or launches:
        raise RuntimeError("phase 9: the plain-GDN decode differs from the kernel's")
    return {"latent_equal": True, "xhat_max_abs_diff": diff}


def coder_cross_process(model: str, quality: int, ckpt: str, tmp: str) -> dict:
    """Phase 9: ``cli.codec`` round trip in this process, then ``--encode``
    and ``--decode`` in two more; the decoded PNGs must be equal byte for
    byte (and the streams too)."""
    from imagecompression_adversarial_tpu_torch.cli.codec import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import read_image, synthetic_image, write_image

    work = os.path.join(tmp, model)
    enc_dir, dec_dir = os.path.join(work, "enc"), os.path.join(work, "dec")
    os.makedirs(work)
    src = os.path.join(work, "synthetic.png")
    write_image(synthetic_image(256, 256, seed=0), src)
    flags = ["-m", model, "-q", str(quality), "-ckpt", ckpt, "-device", "cuda"]
    inproc = os.path.join(work, "inproc.png")
    run(parse_config(flags + ["-s", src, "-t", inproc]))
    seconds = {}
    for step, args in (("encode", ["--encode", "-s", src, "-t", enc_dir]),
                       ("decode", ["--decode", "-s", os.path.join(enc_dir, "*.bin"), "-t", dec_dir])):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "imagecompression_adversarial_tpu_torch.cli.codec", *flags, *args],
            cwd=ROOT, capture_output=True, text=True, timeout=CODER_SUBPROCESS_TIMEOUT_S,
        )
        seconds[step] = time.perf_counter() - t
        if proc.returncode != 0:
            raise RuntimeError(f"phase 9 {model} --{step} exited {proc.returncode}:\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    with open(inproc + ".bin", "rb") as f, open(os.path.join(enc_dir, "synthetic.bin"), "rb") as g:
        same_stream = f.read() == g.read()
    rec_path = os.path.join(dec_dir, "synthetic_rec.png")
    with open(inproc, "rb") as f, open(rec_path, "rb") as g:
        same_png = f.read() == g.read()
    a, b = read_image(inproc)[0], read_image(rec_path)[0]
    mismatched = int((a != b).any(axis=-1).sum())
    log(f"phase 9 cross-process {model} q{quality} 256x256: stream equal {same_stream}, "
        f"reconstruction PNG equal {same_png} ({mismatched} pixels differ), --encode "
        f"{seconds['encode']:.1f} s, --decode {seconds['decode']:.1f} s (each a new process)")
    if not same_png:
        raise RuntimeError(f"phase 9 {model}: the two-process decode differs from the in-process "
                           f"round trip at {mismatched} pixels")
    return {"model": model, "stream_equal": same_stream, "png_equal": same_png,
            "encode_process_s": seconds["encode"], "decode_process_s": seconds["decode"]}


def phase_coder(gdn):
    """Phase 9: the real coder on the card."""
    records, launches = [], {}
    for label, model, quality, ckpt, h, w in (
        ("hyper q1", "hyper", 1, CKPT, 512, 768),
        ("cheng2020-gmm q3", "cheng2020-gmm", 3, CKPT_GMM, 512, 768),
        ("factorized q1", "factorized", 1, None, 256, 256),
        ("context q1", "context", 1, None, 256, 256),
    ):
        codec, out, y_hat, x_hat, rec = coder_run(
            gdn, label, load_codec(model, quality, ckpt), h, w, trained=ckpt is not None)
        launches[f"9 coder {label} {w}x{h}"] = rec["gdn_launches"]
        if model == "hyper":
            rec["plain_gdn_decode"] = coder_kernel_vs_plain(gdn, codec, out, y_hat, x_hat)
        records.append(rec)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_codec_")
    try:
        cross = [coder_cross_process("hyper", 1, CKPT, tmp),
                 coder_cross_process("cheng2020-gmm", 3, CKPT_GMM, tmp)]
    finally:
        shutil.rmtree(tmp)
    print(json.dumps({"coder": records, "cross_process": cross}), flush=True)
    return launches


def phase_slice4_path(gdn):
    """Phase 10: the attack and defense engines through their CLIs' ``run``
    at full width and size (hyper q1, demo weights, 768x512)."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli import attack_ifgsm, attack_rd, self_ensemble
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    flags = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cuda"]
    runs = (
        # label, CLI, its flags, attack steps in all (restarts and starts included)
        ("adaptive ensemble scan", self_ensemble,
         ["--defend", "--defend_m", "ensemble", "--adv", "-ensemble_impl", "scan", "-steps", "201"],
         201),
        ("ensemble-defended RD", self_ensemble, ["--defend", "--defend_m", "ensemble",
                                                 "-steps", "1001"], 1001),
        ("MI-FGSM best of 2 PGD starts", attack_ifgsm, ["-steps", "101", "-random", "2"], 202),
        ("RD best of 2 restarts (host)", attack_rd, ["-steps", "1001", "-random", "2"], 2002),
    )
    im = synthetic_image(512, 768, seed=0)
    records, launches = [], {}
    for label, cli, args, steps in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gdn.reset_launch_counts()
        avg = cli.run(parse_config(flags + args), images=[("synthetic-768x512", im, 512, 768)])
        torch.cuda.synchronize()
        n = gdn.launch_counts["gdn_fwd"]
        rec = {"run": label, "args": args, "steps": steps, "t_s": avg["t"],
               "steps_per_s": steps / avg["t"], "vi": avg["vi"], "bpp_ori": avg["bpp_ori"],
               "bpp": avg["bpp"], "gdn_launches": n,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        for key in ("vi", "bpp_ori", "bpp"):
            if not math.isfinite(rec[key]):
                raise RuntimeError(f"phase 10 {label}: {key} is not finite ({rec[key]})")
        if n == 0:
            raise RuntimeError(f"phase 10 {label} ran without launching the GDN kernel")
        log(f"phase 10 {label} 768x512: {rec['steps_per_s']:.2f} steps/s ({steps} steps, "
            f"{avg['t']:.2f} s incl. clean forward and eval), vi {avg['vi']:.4f}, bpp_ori "
            f"{avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, gdn_fwd launches {n}, peak memory "
            f"{rec['peak_gib']:.2f} GiB")
        records.append(rec)
        launches[f"10 {label} 768x512"] = n
    split = adaptive_step_split(parse_config(flags), im)
    print(json.dumps({"phase10": records, "step_split_ms": split}), flush=True)
    return launches


def adaptive_step_split(cfg, im, reps: int = 5):
    """Device ms of one attack step's loss forward and backward at 768x512,
    by what the loss runs: the phase-space synthesis (phase 4's step), the
    full quantization-free forward, the 8-variant ensemble (scan and batch),
    and the scan's forward alone (no backward, no recompute)."""
    import torch

    from imagecompression_adversarial_tpu_torch.defenses import self_ensemble
    from imagecompression_adversarial_tpu_torch.io.image import to_tensor
    from imagecompression_adversarial_tpu_torch.runtime import load_model

    codec = load_model(cfg)
    x = to_tensor(im, "cuda")
    noise = torch.full_like(x, 1e-3)
    outputs = {
        "phase-space g_a + g_s_phase": lambda v: codec.g_s_phase(codec.g_a(v)),
        "full forward (quant 'none')": lambda v: codec(v, quant_mode="none")["x_hat"],
        "ensemble scan (8 variants)": lambda v: self_ensemble(codec, v, "none", "scan")["x_hat"],
        "ensemble batch (2 x 4)": lambda v: self_ensemble(codec, v, "none", "batch")["x_hat"],
    }

    def step(out_fn):
        n = noise.clone().requires_grad_(True)
        torch.autograd.grad(out_fn(x + n).square().mean(), n)

    split = {k: time_ms(lambda f=f: step(f), reps) for k, f in outputs.items()}
    with torch.no_grad():
        split["ensemble scan forward only"] = time_ms(
            lambda: outputs["ensemble scan (8 variants)"](x + noise), reps)
    log("phase 10 step split at 768x512 (device ms a loss forward + backward): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()))
    return split


@contextlib.contextmanager
def cudnn_deterministic(on: bool = True):
    """cuDNN deterministic, no benchmarking; with ``on`` False, its default
    heuristics (what the CLIs run), whose algorithms ask less workspace."""
    import torch

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = on, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags


def kernel_and_plain(gdn, codec, fn):
    """``fn()`` with the kernels, then with the plain GDN (forward and
    backward), cuDNN set deterministic: ``[(result, launches), (result,
    launches)]`` (the forward kernel's); the kernel run must launch the
    forward kernel and the plain run neither kernel."""
    import torch

    out = []
    with cudnn_deterministic():
        try:
            for use_kernel in (True, False):
                use_gdn_kernel(codec, use_kernel)
                gdn.reset_launch_counts()
                res = fn()
                torch.cuda.synchronize()
                out.append((res, gdn.launch_counts["gdn_fwd"]))
            plain_bwd = gdn.launch_counts["gdn_bwd"]
        finally:
            use_gdn_kernel(codec, True)
    if out[0][1] == 0 or out[1][1] != 0 or plain_bwd != 0:
        raise RuntimeError(f"launch counts: kernel run {out[0][1]}, plain run {out[1][1]} "
                           f"(gdn_bwd {plain_bwd})")
    return out


def hold(label, a, b, noise_atol=NOISE_ATOL, vi_atol=VI_ATOL, what="kernel vs plain",
         phase="11"):
    """``im_`` within ``noise_atol`` (the noise, since x is shared) and vi
    within ``vi_atol`` dB; returns the record."""
    diff = (a["im_"] - b["im_"]).abs().max().item()
    dvi = abs(a["vi"].item() - b["vi"].item())
    log(f"phase {phase} {label}, {what}: max |noise diff| {diff:.3e} (tol {noise_atol}), vi "
        f"{a['vi'].item():.6f} / {b['vi'].item():.6f} (tol {vi_atol})")
    if not (math.isfinite(a["vi"].item()) and math.isfinite(b["vi"].item())):
        raise RuntimeError(f"phase {phase} {label}: non-finite vi")
    if diff > noise_atol or dvi > vi_atol:
        raise RuntimeError(f"phase {phase} {label}: {what} differ beyond the tolerances")
    return {"engine": label, "compare": what, "noise_max_abs_diff": diff, "vi_abs_diff": dvi}


def phase_engines_kernel_vs_plain(gdn):
    """Phase 11: each engine of the slice with the kernel and with the plain
    GDN (hyper q1, demo weights, 256x256), at fixed bounds."""
    import functools

    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import (
        CWAttackConfig, IFGSMConfig, RDAttackConfig, TargetedAttackConfig, best_of_restarts,
        make_attack_fn, make_batch_attack_fn, make_cw_attack_fn, make_ifgsm_fn,
        make_targeted_attack_fn,
    )
    from imagecompression_adversarial_tpu_torch.defenses import (
        clip_dead_channel, draw_resize_scale, load_range_profile, make_defend_fn,
        make_latent_defend_fn, random_resize,
    )
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    codec = load_codec("hyper", 1, CKPT)
    x = to_tensor(synthetic_image(256, 256, seed=1), "cuda")
    x2 = to_tensor(synthetic_image(256, 256, seed=4), "cuda")
    records, launches = [], {}

    def run_pair(label, fn):
        (k, lk), (p, _) = kernel_and_plain(gdn, codec, fn)
        launches[f"11 {label} 256x256"] = lk
        return k, p

    # targeted ROI attack toward another image, 20 steps
    target = to_tensor(synthetic_image(256, 256, seed=3), "cuda")
    roi = make_targeted_attack_fn(codec, TargetedAttackConfig(steps=20, mask_loc=(64, 192, 32, 160),
                                                              lamb_bkg_out=0.5))
    records.append(hold("targeted ROI x20", *run_pair("targeted ROI", lambda: roi(x, target))))

    # the RD attack through each in-loop defense, evaluated through it
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        with torch.no_grad():
            absmax = codec.g_a(x).abs().amax(dim=(0, 2, 3)).cpu().numpy()
        ranks = np.empty(absmax.size, np.int64)
        ranks[np.argsort(-absmax, kind="stable")] = np.arange(absmax.size)
        prof_path = os.path.join(tmp, "hyper-mse-1_range.npz")
        np.savez(prof_path, channel_max=absmax, channel_min=-absmax, dead=absmax < 2.0,
                 ranks_min=ranks)
        prof = load_range_profile(prof_path, require=("dead", "ranks_min"))
    finally:
        shutil.rmtree(tmp)
    log(f"phase 11 clip profile written from the clean latent of the 256x256 image: "
        f"{int(prof['dead'].sum())} of {absmax.size} channels dead (|y| < 2), ranks by abs-max")
    transform = functools.partial(clip_dead_channel, dead=prof["dead"], ranks_min=prof["ranks_min"])
    for mode, impl, steps in (("ensemble", "scan", 5), ("ensemble", "batch", 5),
                              ("bitdepth", "scan", 20), ("resize", "scan", 20),
                              ("clip", "scan", 20)):
        if mode == "clip":
            builder, tf = (lambda m: make_latent_defend_fn(m, transform)), transform
        else:
            builder, tf = (lambda m, mode=mode: make_defend_fn(m, mode)), None
        attack = make_attack_fn(codec, RDAttackConfig(steps=steps, defend_in_loop=mode,
                                                      ensemble_impl=impl),
                                defend_fn_builder=builder, latent_transform=tf)
        label = f"adaptive {mode}" + (f" {impl}" if mode == "ensemble" else "") + f" x{steps}"
        records.append(hold(label, *run_pair(label, lambda: attack(x))))

    # a batch of two images: kernel vs plain, and against two single runs
    cfg = RDAttackConfig(steps=20, two_phase_impl="select")
    batched, single = make_batch_attack_fn(codec, cfg), make_attack_fn(codec, cfg)
    xs = torch.cat([x, x2])
    kb, pb = run_pair("attack_batch 2", lambda: batched(xs))
    for j in range(2):
        records.append(hold(f"attack_batch 2 image {j} x20", {k: v[j] for k, v in kb.items()},
                            {k: v[j] for k, v in pb.items()}))
    with cudnn_deterministic():
        for j, xj in enumerate((x, x2)):
            records.append(hold(f"attack_batch 2 image {j} x20", {k: v[j] for k, v in kb.items()},
                                single(xj), what="batch vs single"))

    # restarts: kernel vs plain of the batched ones, then batched vs sequential
    rcfg = RDAttackConfig(steps=20, random_restarts=2, two_phase_impl="select")
    restart = make_attack_fn(codec, rcfg)
    kv, pv = run_pair("restarts vmap", lambda: best_of_restarts(
        restart, x, torch.Generator("cuda").manual_seed(0), 2, impl="vmap"))
    records.append(hold("best_of_restarts vmap x20", kv, pv))
    with cudnn_deterministic():
        host = best_of_restarts(restart, x, torch.Generator("cuda").manual_seed(0), 2, impl="host")
    records.append(hold("best_of_restarts x20", kv, host, what="vmap vs host"))

    # CW: the same rounds and decisions, vi within VI_ATOL
    for fast in (False, True):
        cw = make_cw_attack_fn(codec, CWAttackConfig(steps=11, search_steps=2, fast=fast))
        label = "CW" + (" fast" if fast else "") + " ssteps 2 x11"
        k, p = run_pair(label, lambda: cw(x))
        dvi = abs(k["vi"].item() - p["vi"].item())
        log(f"phase 11 {label}: outer rounds {k['outer_rounds']} / {p['outer_rounds']}, "
            f"decisions {k['decisions']} / {p['decisions']}, vi {k['vi'].item():.6f} / "
            f"{p['vi'].item():.6f} (tol {VI_ATOL})")
        if k["decisions"] != p["decisions"] or dvi > VI_ATOL or not math.isfinite(k["vi"].item()):
            raise RuntimeError(f"phase 11 {label}: kernel vs plain differ")
        records.append({"engine": label, "compare": "kernel vs plain",
                        "outer_rounds": k["outer_rounds"], "decisions": k["decisions"],
                        "vi_abs_diff": dvi})

    # sign-gradient attacks: flips of near-zero gradient signs are allowed
    for label, kw in (("I-FGSM", {}), ("PGD", {"random_start": True}),
                      ("MI-FGSM", {"momentum": True})):
        attack = make_ifgsm_fn(codec, IFGSMConfig(steps=20, **kw))
        k, p = run_pair(label, lambda: attack(x, torch.Generator("cuda").manual_seed(0)))
        share = ((k["im_"] - p["im_"]).abs() > SIGN_FLIP_ATOL).float().mean().item()
        dvi = abs(k["vi"].item() - p["vi"].item())
        log(f"phase 11 {label} x20: share of pixels > {SIGN_FLIP_ATOL} apart {share:.5f} (tol "
            f"{SIGN_FLIP_SHARE}), vi {k['vi'].item():.6f} / {p['vi'].item():.6f} (tol "
            f"{SIGN_VI_ATOL})")
        if share > SIGN_FLIP_SHARE or dvi > SIGN_VI_ATOL or not math.isfinite(k["vi"].item()):
            raise RuntimeError(f"phase 11 {label}: kernel vs plain differ beyond the tolerances")
        records.append({"engine": f"{label} x20", "compare": "kernel vs plain",
                        "flip_share": share, "vi_abs_diff": dvi})

    # the resize on the card vs on the CPU
    for scale in (243.0 / 256.0, draw_resize_scale(0)):
        diff = (random_resize(x, scale)[0].cpu() - random_resize(x.cpu(), scale)[0]).abs().max().item()
        log(f"phase 11 random_resize scale {scale:.6f}: cuda vs cpu max |diff| {diff:.3e} "
            f"(tol {RESIZE_ATOL})")
        if diff > RESIZE_ATOL:
            raise RuntimeError("phase 11: random_resize on the card differs from the CPU's")
        records.append({"engine": f"random_resize {scale:.6f}", "compare": "cuda vs cpu",
                        "max_abs_diff": diff})
    print(json.dumps({"phase11": records}), flush=True)
    return launches


class _Tee(io.TextIOBase):
    """Writes to every stream it holds (the console and a capture)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def train_cli(gdn, args, base=None):
    """``cli.train``'s ``main`` on ``args`` in the current directory, after
    ``base`` (by default phase 12's flags and the hyper q1 demo weights):
    (summary, GDN launches, peak GiB, stdout)."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli import train as cli_train

    base = list(TRAIN_FLAGS) + ["-ckpt", CKPT] if base is None else list(base)
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gdn.reset_launch_counts()
    with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        summary = cli_train.main(base + list(args))
    torch.cuda.synchronize()
    launches = gdn.launch_counts["gdn_fwd"]
    for key in ("loss", "best_loss"):
        if not math.isfinite(summary[key]):
            raise RuntimeError(f"phase 12 {args}: {key} is not finite ({summary[key]})")
    for which in ("first", "last"):
        bad = {k: v for k, v in summary[which].items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"phase 12 {args}: non-finite {which} logs {bad}")
    if launches == 0:
        raise RuntimeError(f"phase 12 {args} ran without launching the GDN kernel")
    return summary, launches, torch.cuda.max_memory_allocated() / 2**30, out.getvalue()


def state_equal(a, b) -> bool:
    """Two ``TrainState.state_dict()``s hold equal tensors and values."""
    import torch

    if a.keys() != b.keys():
        return False
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            if not (isinstance(y, dict) and state_equal(x, y)):
                return False
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def attack_trained(gdn, step_dir: str, state):
    """Phase 12e: ``cli.attack_rd -ckpt <step dir>`` on the codec that
    phase 12b trained; the loaded parameters must be the trained ones."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image
    from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint

    loaded = load_checkpoint(step_dir, "hyper")
    trained = state.model.state_dict()
    if loaded.keys() != trained.keys() or not all(
            torch.equal(loaded[k].cuda(), v) for k, v in trained.items()):
        raise RuntimeError(f"phase 12e: {step_dir} does not hold the trained parameters")
    cfg = parse_config(["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", step_dir,
                        "-steps", "20", "-two_phase", "select", "-device", "cuda"])
    gdn.reset_launch_counts()
    avg = run(cfg, images=[("synthetic-256x256", synthetic_image(256, 256, seed=3), 256, 256)])
    launches = gdn.launch_counts["gdn_fwd"]
    if not all(math.isfinite(avg[k]) for k in ("vi", "bpp_ori", "bpp")) or launches == 0:
        raise RuntimeError(f"phase 12e: {avg}, gdn_fwd launches {launches}")
    log(f"phase 12e cli.attack_rd -ckpt {os.path.basename(os.path.dirname(step_dir))}/"
        f"{os.path.basename(step_dir)} (the trained codec, loaded exactly), 20 steps 256x256: "
        f"vi {avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, gdn_fwd "
        f"launches {launches}")
    return {k: avg[k] for k in ("vi", "bpp_ori", "bpp")}, launches


def phase_training(gdn):
    """Phase 12a and 12b: RD training and --adv finetuning through
    ``cli.train`` at full width, with a resume, in a temporary directory.
    Returns the records and the forward and backward kernels' launches."""
    from imagecompression_adversarial_tpu_torch.config import Config
    from imagecompression_adversarial_tpu_torch.runtime import load_model
    from imagecompression_adversarial_tpu_torch.train import CheckpointManager, create_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cwd = os.getcwd()
    launches, launches_bwd, records = {}, {}, {}
    try:
        os.chdir(tmp)
        s, n, peak, _ = train_cli(gdn, ["-max_steps", str(TRAIN_RD_STEPS)])
        nb = gdn.launch_counts["gdn_bwd"]
        if nb == 0:
            raise RuntimeError("phase 12a ran without launching the GDN backward kernel")
        t = s["timing"]
        rec = {"steps": s["steps"], "steps_per_s": t["steady_steps"] / t["steady_s"],
               "first_step_s": t["first_step_s"], "gdn_launches": n, "gdn_bwd_launches": nb,
               "launches_per_step": n / s["steps"], "peak_gib": peak,
               "first": s["first"], "last": s["last"], "eval_loss": s["best_loss"]}
        records["12a"] = rec
        launches[f"12a RD training x{TRAIN_RD_STEPS}"] = n
        launches_bwd[f"12a RD training x{TRAIN_RD_STEPS}"] = nb
        log(f"phase 12a RD training hyper q1, 8 x 256x256: {rec['steps_per_s']:.2f} steps/s "
            f"(steps 2-{s['steps']}; the first took {t['first_step_s']:.2f} s), gdn_fwd launches {n} "
            f"({rec['launches_per_step']:.2f} a step, the final eval's forward included), gdn_bwd "
            f"launches {nb} ({nb / s['steps']:.2f} a step), peak "
            f"memory {peak:.2f} GiB; loss {s['first']['loss']:.4f} -> {s['last']['loss']:.4f}, bpp "
            f"{s['first']['bpp_loss']:.4f} -> {s['last']['bpp_loss']:.4f}, distortion "
            f"{s['first']['distortion']:.6f} -> {s['last']['distortion']:.6f}, aux "
            f"{s['first']['aux_loss']:.2f} -> {s['last']['aux_loss']:.2f}; the previous backward "
            f"kernel's rate {PREVIOUS_BWD['12a steps/s']:.2f} steps/s")

        adv = list(TRAIN_ADV_FLAGS)
        s, n, peak, _ = train_cli(gdn, adv + ["-max_steps", str(TRAIN_ADV_STEPS)])
        t = s["timing"]
        with open(os.path.join("logs", "log.txt")) as f:
            curve = [json.loads(line) for line in f]
        if [c["step"] for c in curve] != [10]:
            raise RuntimeError(f"phase 12b: curve steps {[c['step'] for c in curve]}, not [10]")
        if sorted(os.listdir(s["ckpt_dir"])) != ["10", "12", "best_loss"]:
            raise RuntimeError(f"phase 12b: checkpoints {sorted(os.listdir(s['ckpt_dir']))}")
        rec = {"steps": s["steps"], "steps_per_s": t["steady_steps"] / t["steady_s"],
               "attack_steps_per_s": t["attack_steps"] / t["attack_s"],
               "attack_steps": t["attack_steps"], "eval_vi_step10": curve[0]["eval_loss"],
               "lr": curve[0]["lr"], "best_eval_vi": s["best_loss"], "eval_s": t["eval_s"],
               "gdn_launches": n, "gdn_bwd_launches": gdn.launch_counts["gdn_bwd"],
               "peak_gib": peak, "first": s["first"], "last": s["last"]}
        if not math.isfinite(rec["eval_vi_step10"]):
            raise RuntimeError(f"phase 12b: eval vi {rec['eval_vi_step10']}")

        cfg = Config(device="cuda", model="hyper", quality=1, checkpoint=CKPT)
        fresh = create_train_state(load_model(cfg).requires_grad_(True), TRAIN_LR)
        extra = CheckpointManager(s["ckpt_dir"], "hyper").restore(fresh)
        exact = state_equal(fresh.state_dict(), s["state"].state_dict())
        rec["restored_exactly"] = exact
        if not exact or fresh.step != TRAIN_ADV_STEPS:
            raise RuntimeError(f"phase 12b: step {fresh.step} restored, exactly: {exact}")
        records["12b"] = rec
        launches[f"12b --adv training x{TRAIN_ADV_STEPS}"] = n
        launches_bwd[f"12b --adv training x{TRAIN_ADV_STEPS}"] = rec["gdn_bwd_launches"]
        log(f"phase 12b --adv training, 8 x 256x256, -steps 101: {rec['steps_per_s']:.3f} train "
            f"steps/s (steps 2-{s['steps']}, evals excluded), inner attack "
            f"{rec['attack_steps_per_s']:.2f} steps/s ({t['attack_steps']} steps), eval vi at step "
            f"10 {rec['eval_vi_step10']:.4f} dB (lr {rec['lr']:g}), best {s['best_loss']:.4f}, "
            f"gdn_fwd launches {n}, gdn_bwd launches {rec['gdn_bwd_launches']}, peak memory "
            f"{peak:.2f} GiB; checkpoint of step 12 restores "
            f"params and both optimizer states exactly (extra {extra})")

        s, n, _, out = train_cli(gdn, adv + ["-max_steps", str(TRAIN_RESUME_STEPS)])
        line = f"resume training from epoch 0 (step {TRAIN_ADV_STEPS})"
        if line not in out or s["steps"] != TRAIN_RESUME_STEPS:
            raise RuntimeError(f"phase 12b resume: {s['steps']} steps, resume line printed: "
                               f"{line in out}")
        if s["timing"]["attack_steps"] != (TRAIN_RESUME_STEPS - TRAIN_ADV_STEPS) * TRAIN_ADV_ATTACK_STEPS:
            raise RuntimeError(f"phase 12b resume ran {s['timing']['attack_steps']} attack steps")
        records["12b resume"] = {"steps": s["steps"], "gdn_launches": n, "last": s["last"]}
        launches[f"12b resume to {TRAIN_RESUME_STEPS}"] = n
        log(f"phase 12b resume: '{line}', on to step {s['steps']}, loss {s['last']['loss']:.4f}, "
            f"gdn_fwd launches {n}")

        records["12e"], launches["12e attack of the step-12 checkpoint"] = attack_trained(
            gdn, os.path.join(s["ckpt_dir"], str(TRAIN_ADV_STEPS)), fresh)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def train_kernel_vs_plain(gdn):
    """Phase 12c: 5 RD training steps with the kernel and with the plain
    GDN from the same weights, batches and noise, at fixed bounds."""
    import torch

    from imagecompression_adversarial_tpu_torch.io.image import to_tensor
    from imagecompression_adversarial_tpu_torch.models.layers import GDN
    from imagecompression_adversarial_tpu_torch.train import (
        create_train_state, lambda_for, rate_distortion_loss, train_step,
    )
    from imagecompression_adversarial_tpu_torch.train.data import synthetic_batches
    from imagecompression_adversarial_tpu_torch.train.step import LR_AUX

    codec = load_codec("hyper", 1, CKPT).requires_grad_(True)
    initial = {k: v.clone() for k, v in codec.state_dict().items()}
    stream = synthetic_batches(8, 256, seed=0)
    batches = [to_tensor(next(stream), "cuda") for _ in range(TRAIN_KVP_STEPS)]
    lmbda = lambda_for("mse", 1)
    gdns = [(n, m) for n, m in codec.named_modules() if isinstance(m, GDN)]

    def run():
        codec.load_state_dict(initial)
        result = codec(batches[0], quant_mode="noise",
                       generator=torch.Generator(device="cuda").manual_seed(0))
        loss = rate_distortion_loss(result, batches[0], lmbda, "mse")["loss"]
        params = [p for _, m in gdns for p in (m.gamma, m.beta)]
        grads = [g.detach() for g in torch.autograd.grad(loss, params)]
        state = create_train_state(codec, TRAIN_LR)
        gen = torch.Generator(device="cuda").manual_seed(42)
        losses = [float(train_step(state, b, gen, TRAIN_LR, lmbda)["loss"]) for b in batches]
        return grads, losses, {k: v.detach().clone() for k, v in codec.state_dict().items()}

    (k, lk), (p, _) = kernel_and_plain(gdn, codec, run)
    rec = {"kernel_launches": lk}
    rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(k[1], p[1]))
    rec["grad_rel"] = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(k[0], p[0]))
    far = total = 0
    rec["param_max_abs"] = 0.0
    for name, a in k[2].items():
        lr = LR_AUX if name.endswith("quantiles") else TRAIN_LR
        diff = (a - p[2][name]).abs()
        worst = float(diff.max())
        rec["param_max_abs"] = max(rec["param_max_abs"], worst)
        if worst > 2 * TRAIN_KVP_STEPS * lr:
            raise RuntimeError(f"phase 12c: {name} {worst:.3e} apart after {TRAIN_KVP_STEPS} steps")
        far += int((diff > lr / 10).sum())
        total += diff.numel()
    rec["far_share"] = far / total
    log(f"phase 12c kernel vs plain GDN, {TRAIN_KVP_STEPS} RD steps 8 x 256x256: loss max rel "
        f"{rec['loss_rel']:.3e} (tol {TRAIN_LOSS_RTOL}), step-1 dgamma/dbeta max rel "
        f"{rec['grad_rel']:.3e} (tol {TRAIN_GRAD_REL}), params max |diff| "
        f"{rec['param_max_abs']:.3e} (tol 2 x {TRAIN_KVP_STEPS} x lr), share > lr/10 "
        f"{rec['far_share']:.2e} (tol {TRAIN_FAR_SHARE}), kernel launches {lk}")
    if rec["loss_rel"] > TRAIN_LOSS_RTOL or rec["grad_rel"] > TRAIN_GRAD_REL or \
            rec["far_share"] > TRAIN_FAR_SHARE:
        raise RuntimeError("phase 12c: kernel vs plain training differ beyond the tolerances")
    return rec, codec, initial, batches


def profile_train_step(codec, initial, batches):
    """Phase 12d: device time of one RD training step (after warm-up steps)
    by kernel, in the categories of KERNEL_CATEGORIES."""
    import torch

    from imagecompression_adversarial_tpu_torch.train import create_train_state, lambda_for, train_step

    codec.load_state_dict(initial)
    state = create_train_state(codec, TRAIN_LR)
    gen = torch.Generator(device="cuda").manual_seed(42)
    lmbda = lambda_for("mse", 1)
    for b in batches[:PROFILE_WARMUP]:
        train_step(state, b, gen, TRAIN_LR, lmbda)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(train_step(state, batches[PROFILE_WARMUP], gen, TRAIN_LR, lmbda)["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    # device-side ranges of annotations (the optimizer's "Optimizer.step#...")
    # span kernels counted on their own, so they are left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy = sum(device_us(e) for e in kernels)
    if busy == 0:
        raise RuntimeError("phase 12d: the profiler saw no device time")
    shares = collections.Counter()
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, keys in KERNEL_CATEGORIES if any(k in name for k in keys)), "other")
        shares[cat] += device_us(e)
    kernels.sort(key=device_us, reverse=True)
    top = [{"name": e.key[:100], "ms": device_us(e) / 1e3, "calls": e.count} for e in kernels[:12]]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / 1e3 / wall_ms,
           "shares": {c: v / busy for c, v in shares.most_common()}, "top": top}
    log(f"phase 12d one RD training step profiled: wall {wall_ms:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share of this window {rec['idle_share']:.3f}); " + ", ".join(f"{c} {v:.3f}" for c, v in rec["shares"].items()))
    for t in top:
        log(f"phase 12d   {t['ms']:8.3f} ms {t['calls']:5d}x  {t['name']}")
    return rec


def phase_train_kernel_vs_plain(gdn):
    """Phase 12c and 12d."""
    with cudnn_deterministic():
        rec, codec, initial, batches = train_kernel_vs_plain(gdn)
    rec["profile"] = profile_train_step(codec, initial, batches)
    return rec


def phase_adapters(gdn):
    """Phase 13: the RD attack on the five adapter families through the
    attack CLI's ``run`` at 768x512."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import run
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image

    im = synthetic_image(512, 768, seed=0)
    records, launches = {}, {}
    for model in ADAPTERS:
        flags = ["-m", model, "-q", "3", "-metric", "mse", "-steps", str(ADAPTER_STEPS),
                 "-two_phase", "select", "-device", "cuda"]
        if model in ADAPTER_CKPTS:
            flags += ["-ckpt", ADAPTER_CKPTS[model]]
        restarts = 2 if model == "fic" else 1  # fic's zero start is a critical point
        flags += ["-random", str(restarts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gdn.reset_launch_counts()
        avg = run(parse_config(flags), images=[("synthetic-768x512", im, 512, 768)])
        torch.cuda.synchronize()
        n = gdn.launch_counts["gdn_fwd"]
        steps = ADAPTER_STEPS * restarts
        rec = {"steps": steps, "steps_per_s": steps / avg["t"], "seconds": avg["t"],
               "vi": avg["vi"], "bpp_ori": avg["bpp_ori"], "bpp": avg["bpp"], "gdn_launches": n,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "weights": "demo" if model in ADAPTER_CKPTS else "seeded"}
        records[model] = rec
        launches[f"13 {model} q3 768x512"] = n
        log(f"phase 13 {model} q3 768x512 ({rec['weights']} weights, {steps} steps"
            f"{', best of 2 restarts' if restarts > 1 else ''}): {rec['steps_per_s']:.2f} steps/s "
            f"(incl. clean forward and eval, {avg['t']:.2f} s), vi {avg['vi']:.4f}, bpp_ori "
            f"{avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, gdn_fwd launches {n}, peak memory "
            f"{rec['peak_gib']:.2f} GiB")
        for key in ("vi", "bpp_ori", "bpp"):
            if not math.isfinite(avg[key]):
                raise RuntimeError(f"phase 13 {model}: {key} is not finite ({avg[key]})")
        if model in ("nlaic", "fic") and n == 0:
            raise RuntimeError(f"phase 13 {model} ran without launching the GDN kernel")
    return records, launches


def phase_adapters_check(gdn):
    """Phase 14: nlaic and fic with the kernel and with the plain GDN, and
    the real coder on the five adapter families at 768x512."""
    launches, records = {}, []
    for model in ("nlaic", "fic"):
        launches[f"14 {model} q3 256x256"] = attack_kernel_vs_plain(
            gdn, f"phase 14 {model} q3", load_codec(model, 3, ADAPTER_CKPTS[model]),
            noise_atol=ANCHOR_NOISE_ATOL, vi_atol=ANCHOR_VI_ATOL, random_start=model == "fic")
    for model in ADAPTERS:
        trained = model in ADAPTER_CKPTS
        label = f"{model} q3"
        rec = coder_run(gdn, label, load_codec(model, 3, ADAPTER_CKPTS.get(model)), 512, 768,
                        trained=trained, phase="14", est_rtol=None)[-1]
        launches[f"14 coder {label} 768x512"] = rec["gdn_launches"]
        records.append(rec)
    print(json.dumps({"coder_adapters": records}), flush=True)
    return launches

@contextlib.contextmanager
def in_temp_dir(prefix: str):
    """Run the body with a new temporary directory as the working
    directory; the directory is removed after it."""
    tmp = tempfile.mkdtemp(prefix=prefix)
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        yield tmp
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def run_captured(fn, *args):
    """``fn(*args)`` with its stdout shown and captured; the card synced and
    its peak memory reset before: (result, stdout, seconds, peak GiB)."""
    import torch

    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        res = fn(*args)
    torch.cuda.synchronize()
    return res, out.getvalue(), time.time() - t, torch.cuda.max_memory_allocated() / 2**30


def phase_classifier(gdn):
    """Phase 15a and 15b: ``cli.classifier_train`` on the synthetic stream
    and ``attack_cv --cls_ckpt`` on hyper q1 at 768x512, then the
    classifier-targeted attack with the kernel and with the plain GDN."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import (
        TargetedAttackConfig, make_targeted_attack_fn,
    )
    from imagecompression_adversarial_tpu_torch.cli import attack_cv, classifier_train
    from imagecompression_adversarial_tpu_torch.io.image import (
        read_image, synthetic_image, to_tensor, write_image,
    )
    from imagecompression_adversarial_tpu_torch.io.weights import classifier_from_jax, read_msgpack
    from imagecompression_adversarial_tpu_torch.models.classifier import (
        MLPClassifier, make_logits_fn,
    )
    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    records, launches = {}, {}
    with in_temp_dir("chip_smoke_cls_") as tmp:
        cls = os.path.join(tmp, "classifier.msgpack")
        loss, _, secs, peak = run_captured(classifier_train.main, [
            "-steps", str(CLS_TRAIN_STEPS), "-batch_size", "8", "-ckpt", cls, "-device", "cuda"])
        if not math.isfinite(loss) or not os.path.isfile(cls):
            raise RuntimeError(f"phase 15a: final loss {loss}, file written {os.path.isfile(cls)}")
        records["15a"] = {"steps": CLS_TRAIN_STEPS, "final_loss": loss, "seconds": secs,
                          "steps_per_s": CLS_TRAIN_STEPS / secs, "peak_gib": peak}
        log(f"phase 15a cli.classifier_train, synthetic stream, batch 8, {CLS_TRAIN_STEPS} steps: "
            f"final loss {loss:.4f}, {CLS_TRAIN_STEPS / secs:.1f} steps/s ({secs:.2f} s, the "
            f"file written included), peak memory {peak:.3f} GiB")

        src = os.path.join(tmp, "synthetic01.png")
        write_image(synthetic_image(512, 768, seed=5), src)
        gdn.reset_launch_counts()
        res, out, secs, peak = run_captured(attack_cv.main, [
            "-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-s", src,
            "--cls_ckpt", cls, "--cls_label", str(CLS_LABEL), "-steps", str(CLS_ATTACK_STEPS),
            "-device", "cuda"])
        n = gdn.launch_counts["gdn_fwd"]
        line = (f"classifier: clean-recon label {res['label_clean']} -> adv-recon label "
                f"{res['label_adv']} (target {CLS_LABEL})")
        if line not in out.splitlines() or n == 0 or not all(
                math.isfinite(res[k]) for k in ("vi", "bpp_ori", "bpp")):
            raise RuntimeError(f"phase 15b: {res}, label line printed {line in out}, launches {n}")
        records["15b"] = dict(res, steps=CLS_ATTACK_STEPS, seconds=secs, gdn_launches=n,
                              steps_per_s=CLS_ATTACK_STEPS / secs, peak_gib=peak)
        launches["15b attack_cv --cls_ckpt 768x512"] = n
        log(f"phase 15b attack_cv --cls_ckpt hyper q1 768x512, {CLS_ATTACK_STEPS} steps: "
            f"{CLS_ATTACK_STEPS / secs:.2f} steps/s (the whole CLI, {secs:.2f} s), vi "
            f"{res['vi']:.4f}, bpp_ori {res['bpp_ori']:.4f}, bpp {res['bpp']:.4f}, labels "
            f"{res['label_clean']} -> {res['label_adv']} (target {CLS_LABEL}), gdn_fwd launches "
            f"{n}, peak memory {peak:.2f} GiB")

        x = to_tensor(read_image(src)[0], "cuda")
        runs = {}
        for dtype in (torch.float32, torch.float64):
            codec = load_codec("hyper", 1, CKPT).to(dtype)
            classifier = MLPClassifier()
            classifier.load_state_dict(classifier_from_jax(read_msgpack(cls)), strict=True)
            attack = make_targeted_attack_fn(
                codec, TargetedAttackConfig(steps=20), target_label=CLS_LABEL,
                classifier_logits_fn=make_logits_fn(classifier.to("cuda", dtype).eval()))
            if dtype == torch.float32:
                (k, lk), (p, _) = kernel_and_plain(gdn, codec, lambda: attack(x))
                with cudnn_deterministic():
                    again = (attack(x)["im_"] - k["im_"]).abs().max().item()
            else:  # the witness: plain GDN, everything in float64
                for m in codec.modules():
                    if isinstance(m, GDN):
                        m.use_kernel = False
                with cudnn_deterministic():
                    w = attack(x.double())
        d_k, d_p, d_kp = ((a["im_"].double() - b["im_"].double()).abs().max().item()
                          for a, b in ((k, w), (p, w), (k, p)))
        bound = max(NOISE_ATOL, 2 * d_p)
        dvi = abs(k["vi"].item() - p["vi"].item())
        rec = {"noise_kernel_vs_f64": d_k, "noise_plain_vs_f64": d_p, "noise_kernel_vs_plain": d_kp,
               "vi_kernel_vs_plain": dvi, "repeat_noise_max_abs_diff": again,
               "vi": [k["vi"].item(), p["vi"].item(), w["vi"].item()]}
        log(f"phase 15b classifier-targeted x20 768x512: max |noise diff| kernel vs float64 plain "
            f"{d_k:.3e} (tol {bound:.3e}: the larger of {NOISE_ATOL} and twice the float32 plain "
            f"run's {d_p:.3e}), kernel vs float32 plain {d_kp:.3e}, the kernel run repeated "
            f"{again:.3e}; vi kernel {k['vi'].item():.6f}, plain {p['vi'].item():.6f} (tol "
            f"{VI_ATOL}), float64 {w['vi'].item():.6f}")
        if d_k > bound or dvi > VI_ATOL or not math.isfinite(k["vi"].item()):
            raise RuntimeError(f"phase 15b classifier-targeted: kernel vs plain beyond the bounds: {rec}")
        records["15b kernel vs plain"] = rec
        launches["15b classifier-targeted x20 768x512"] = lk
    return records, launches


def phase_gan(gdn):
    """Phase 15c: ``cli.train_hific`` at hific's full widths, its checkpoint
    read back, and 20 RD attack steps on the trained codec."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.cli import attack_rd, train_hific
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image
    from imagecompression_adversarial_tpu_torch.io.weights import (
        flax_params, load_checkpoint, read_msgpack,
    )

    made, step_s = {}, []
    init_model, init_disc, make_step = (train_hific.init_model, train_hific.init_discriminator,
                                        train_hific.make_gan_train_step)

    def timed_step(*args):  # each step synced, so its time is the device's too
        step = make_step(*args)

        def run(*a):
            t = time.time()
            logs = step(*a)
            torch.cuda.synchronize()
            step_s.append(time.time() - t)
            return logs

        return run

    train_hific.init_model = lambda *a, **k: made.setdefault("codec", init_model(*a, **k))
    train_hific.init_discriminator = lambda *a, **k: made.setdefault("disc", init_disc(*a, **k))
    train_hific.make_gan_train_step = timed_step
    try:
        with in_temp_dir("chip_smoke_gan_") as tmp:
            out_file = os.path.join(tmp, "hific.msgpack")
            logs, out, secs, peak = run_captured(train_hific.main, [
                "-max_steps", str(GAN_STEPS), "-ckpt", out_file, "-device", "cuda"])
            codec, disc = made["codec"], made["disc"]
            n_params = sum(p.numel() for p in codec.parameters())
            lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
            values = [float(v) for ln in lines for v in re.findall(r" (?:loss|d) (\S+)", ln)]
            if (len(step_s) != GAN_STEPS or len(lines) != -(-GAN_STEPS // 10)
                    or not all(math.isfinite(v) for v in values + list(logs.values()))):
                raise RuntimeError(f"phase 15c: {len(step_s)} steps, log lines {lines}, logs {logs}")
            fresh = init_disc(codec.M, seed=1)
            still = [f"{m}.{b}" for m in [f"conv_{i}" for i in range(4)] + ["logits"]
                     for b in ("u", "sigma")
                     if torch.equal(getattr(fresh, m).get_buffer(b),
                                    getattr(disc, m).get_buffer(b).cpu())]
            # a 1x1 logits conv has a one-element u that stays +-1 when it is 1
            still = [s for s in still if s != "logits.u" or abs(float(fresh.logits.u)) != 1.0]
            if still:
                raise RuntimeError(f"phase 15c: spectral-norm stats that did not move: {still}")
            t = time.time()
            tree = read_msgpack(out_file)
            trained = load_checkpoint(out_file, "hific")
            state = codec.state_dict()
            d_now = flax_params(disc)
            same = (trained.keys() == state.keys()
                    and all(torch.equal(trained[k], state[k].cpu()) for k in state)
                    and tree["discriminator"].keys() == d_now.keys()
                    and all(np.array_equal(tree["discriminator"][m][leaf], d_now[m][leaf])
                            for m in d_now for leaf in d_now[m]))
            read_s = time.time() - t
            if not same:
                raise RuntimeError("phase 15c: the msgpack does not hold the trained weights")
            steady = sum(step_s[1:]) / (GAN_STEPS - 1)
            rec = {"steps": GAN_STEPS, "params": n_params, "first_step_s": step_s[0],
                   "steady_steps_per_s": 1.0 / steady, "seconds": secs, "peak_gib": peak,
                   "file_mb": os.path.getsize(out_file) / 1e6, "read_back_s": read_s,
                   "last": logs, "first_line": lines[0]}
            log(f"phase 15c cli.train_hific hific full width ({n_params / 1e6:.1f}M generator "
                f"parameters), 8 x 256x256, {GAN_STEPS} steps: steady {1.0 / steady:.2f} steps/s "
                f"(steps 2-{GAN_STEPS}, each synced; the first took {step_s[0]:.2f} s), the whole "
                f"CLI {secs:.2f} s, peak memory {peak:.2f} GiB; {lines[0]}; last loss "
                f"{logs['loss']:.4f} bpp {logs['bpp']:.4f} mse {logs['mse']:.5f} perc "
                f"{logs['perceptual']:.4f} g_adv {logs['g_adv']:.4f} d {logs['d_loss']:.4f}; every "
                f"u and sigma moved; the {rec['file_mb']:.0f} MB msgpack reads back equal "
                f"({read_s:.2f} s)")

            cfg = parse_config(["-m", "hific", "-ckpt", out_file, "-steps", "20",
                                "-two_phase", "select", "-device", "cuda"])
            avg = attack_rd.run(cfg, images=[("synthetic-256x256", synthetic_image(256, 256, 3),
                                              256, 256)])
            if not all(math.isfinite(avg[k]) for k in ("vi", "bpp_ori", "bpp")):
                raise RuntimeError(f"phase 15c attack of the trained codec: {avg}")
            rec["attack"] = {k: avg[k] for k in ("vi", "bpp_ori", "bpp")}
            log(f"phase 15c attack_rd -m hific -ckpt <the GAN file>, 20 steps 256x256: vi "
                f"{avg['vi']:.4f}, bpp_ori {avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}")
    finally:
        train_hific.init_model, train_hific.init_discriminator = init_model, init_disc
        train_hific.make_gan_train_step = make_step
    return rec


@contextlib.contextmanager
def plain_gdn_in(cli_module):
    """The CLI module's ``load_model`` gives codecs with ``GDN.use_kernel``
    off for the body."""
    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    load = cli_module.load_model

    def plain(*args, **kwargs):
        model = load(*args, **kwargs)
        for m in model.modules():
            if isinstance(m, GDN):
                m.use_kernel = False
        return model

    cli_module.load_model = plain
    try:
        yield
    finally:
        cli_module.load_model = load


def phase_eval_clis(gdn):
    """Phase 16: the evaluation CLIs on two 768x512 PNGs (hyper q1 demo
    weights), each with the kernel and again with the plain GDN, cuDNN
    deterministic, held at EVAL_BOUNDS."""
    from imagecompression_adversarial_tpu_torch.cli import random_noise, recompression
    from imagecompression_adversarial_tpu_torch.cli import test as cli_test
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, write_image

    records, launches = {}, {}
    with in_temp_dir("chip_smoke_eval_") as tmp, cudnn_deterministic():
        for i in (1, 2):
            write_image(synthetic_image(512, 768, seed=10 + i), os.path.join(tmp, f"kodim0{i}.png"))
        src = os.path.join(tmp, "kodim*.png")
        hyper = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cuda"]
        runs = (
            ("test", cli_test, hyper + ["-s", src], "clean"),
            ("test --defend", cli_test, hyper + ["-s", src, "--defend"], "clean"),
            ("random_noise -noise 1e-3", random_noise, hyper + ["-s", src, "-noise", "1e-3"],
             "clean"),
            ("random_noise -degrade blurgen", random_noise,
             ["-s", src, "-noise", str(BLUR_MSE), "-degrade", "blurgen", "-device", "cuda"], None),
            ("random_noise -degrade deblur", random_noise,
             hyper + ["-s", os.path.join(tmp, "attack", "blur", "*.png"), "-t", src,
                      "-degrade", "deblur"], "clean"),
            (f"recompression -re {RECOMPRESS_CYCLES}", recompression,
             hyper + ["-s", src, "-re", str(RECOMPRESS_CYCLES)], "chain"),
        )
        for label, cli, argv, bounds in runs:
            gdn.reset_launch_counts()
            avg, out, secs, peak = run_captured(cli.run, parse_config(argv))
            n = gdn.launch_counts["gdn_fwd"]
            avg_line = ([ln for ln in out.splitlines() if ln.startswith("AVG:")] or [""])[-1]
            sigmas = re.findall(r"sigma (\S+)", out)
            rec = {"seconds": secs, "gdn_launches": n, "peak_gib": peak, "avg": avg,
                   "avg_line": avg_line}
            if bounds is None:  # blurgen runs no codec: it must write both PNGs, no launch
                blurred = sorted(os.listdir(os.path.join(tmp, "attack", "blur")))
                if blurred != ["kodim01.png", "kodim02.png"] or n != 0 or len(sigmas) != 2:
                    raise RuntimeError(f"phase 16 {label}: wrote {blurred}, launches {n}")
                rec["sigmas"] = [float(v) for v in sigmas]
                log(f"phase 16 {label} 2 x 768x512: {secs:.2f} s, sigmas {sigmas} (annealed "
                    f"from 5.0 by 0.005 to the {BLUR_MSE} MSE), gdn_fwd launches {n}")
                records[label] = rec
                continue
            if n == 0 or not avg or not all(math.isfinite(v) for v in avg.values()):
                raise RuntimeError(f"phase 16 {label}: {avg}, gdn_fwd launches {n}")
            with plain_gdn_in(cli):
                gdn.reset_launch_counts()
                plain, _, plain_secs, _ = run_captured(cli.run, parse_config(argv))
                if gdn.launch_counts["gdn_fwd"] != 0:
                    raise RuntimeError(f"phase 16 {label}: the plain run launched the kernel")
            gaps = {k: abs(avg[k] - plain[k]) for k in avg if k != "t"}
            bad = {k: g for k, g in gaps.items()
                   if g > eval_bound(bounds, k) * (abs(plain[k]) if k.startswith("bpp") else 1)}
            rec.update(plain_seconds=plain_secs, plain=plain, gaps=gaps)
            log(f"phase 16 {label} 2 x 768x512: {secs:.2f} s (plain GDN {plain_secs:.2f} s), "
                f"gdn_fwd launches {n}, peak {peak:.2f} GiB; {avg_line}; kernel vs plain gaps "
                + ", ".join(f"{k} {g:.3e}" for k, g in gaps.items()) + f" ({bounds} bounds)")
            if bad:
                raise RuntimeError(f"phase 16 {label}: kernel vs plain beyond the bounds: {bad}")
            records[label] = rec
            launches[f"16 {label} 2 x 768x512"] = n
    return records, launches


def phase_analysis_clis(gdn):
    """Phase 17: the analysis CLIs on two 768x512 PNGs, each run that uses
    the codec again with the plain GDN (cuDNN deterministic), and a 20-step
    cross-image transfer matrix at 256x256, kernel against plain."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.analysis import (
        cross_image_matrix, make_transfer_eval_fn,
    )
    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
    from imagecompression_adversarial_tpu_torch.cli import (
        attack_linear, compare, feature_range, jpeg_baseline, mmd, search, transfer_noise, visual,
        visual_distribution,
    )
    from imagecompression_adversarial_tpu_torch.config import parse_config
    from imagecompression_adversarial_tpu_torch.defenses import load_range_profile
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor, write_image

    records, launches = {}, {}
    with in_temp_dir("chip_smoke_analysis_") as tmp, cudnn_deterministic():
        rng = np.random.RandomState(17)
        for i in (1, 2):
            im = synthetic_image(512, 768, seed=20 + i)
            for sub, arr in (("data", im), ("noisy", np.clip(im + 0.02 * rng.randn(*im.shape), 0, 1))):
                os.makedirs(os.path.join(tmp, sub), exist_ok=True)
                write_image(arr, os.path.join(tmp, sub, f"kodim0{i}.png"))
        src, noisy = os.path.join(tmp, "data", "kodim*.png"), os.path.join(tmp, "noisy", "kodim*.png")
        first, second = src.replace("*", "01"), src.replace("*", "02")
        hyper = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cuda"]
        cross = f"hyper:1:{CKPT},cheng2020-gmm:3:{CKPT_GMM}"
        profile = os.path.join(tmp, "attack", "data", "hyper-mse-1_range.npz")

        def arrays(path, keys):
            data = np.load(path)
            return {k: (np.asarray(data[k], np.float64), "rel") for k in keys}

        def cfg(argv):
            return lambda: parse_config(argv)

        def cross_run(args):
            return transfer_noise.run(args, cross_model=True, cross_specs=cross)

        # (label, CLI module, fn, args thunk, values of (result, stdout), codec)
        runs = (
            ("feature_range", feature_range, feature_range.run, cfg(hyper + ["-s", src]),
             lambda r, o: arrays(profile, ("channel_max", "channel_min", "per_image_max",
                                           "per_image_min")), True),
            ("search", search, search.run,
             cfg(hyper + ["-s", os.path.join(tmp, "*", "kodim*.png")]),
             lambda r, o: {"scores": (np.array([v for _, v in sorted(r)]), "rel")}, True),
            (f"attack_linear -steps {ANALYSIS_STEPS['attack_linear']}", attack_linear,
             attack_linear.run,
             cfg(hyper + ["-s", src, "-steps", str(ANALYSIS_STEPS["attack_linear"])]),
             lambda r, o: {"vi": (np.array([v["vi"] for v in r.values()]), None),
                           "exceeded": (np.array([v["exceeded"] for v in r.values()]), None)},
             True),
            (f"transfer_noise -steps {ANALYSIS_STEPS['transfer_noise']}", transfer_noise,
             transfer_noise.run,
             cfg(hyper + ["-s", src, "-steps", str(ANALYSIS_STEPS["transfer_noise"])]),
             lambda r, o: {"vi matrix": (np.asarray(r, np.float64), None)}, True),
            (f"transfer_noise --cross-model -cross hyper:1,cheng2020-gmm:3 -steps "
             f"{ANALYSIS_STEPS['cross']}", transfer_noise, cross_run,
             cfg(["-s", src, "-steps", str(ANALYSIS_STEPS["cross"]), "-device", "cuda"]),
             lambda r, o: {"vi matrix": (np.asarray(r, np.float64), None)}, True),
            ("visual -degrade noise", visual, lambda a: visual.run(a, noised=True),
             cfg(hyper + ["-s", first, "-t", os.path.join(tmp, "rec.png"), "-degrade", "noise"]),
             lambda r, o: {"psnr": (np.array([r["psnr"]]), "dB")}, True),
            ("visual_distribution", visual_distribution, visual_distribution.run,
             cfg(hyper + ["-s", first, "-t", second]),
             lambda r, o: {**arrays("hyper_1_distribution.npz", ("rate_natural",
                                                                 "rate_adversarial")),
                           "top channels": (np.array(r["channels_by_rate"]), None)}, True),
            ("compare", compare, compare.main, lambda: [src, noisy, "-device", "cuda"],
             lambda r, o: {k: (np.array([v]), None) for k, v in r.items()}, False),
            ("mmd --do-fid --do-mmd", mmd, mmd.main,
             lambda: [src, noisy, "--do-fid", "--do-mmd", "--mmd-subsets", "10",
                      "--mmd-subset-size", "2", "--splits", "1", "-device", "cuda"],
             lambda r, o: {k: (np.array(r[k], np.float64).ravel(), None)
                           for k in ("fid", "kid", "is")}, False),
            ("jpeg_baseline -q 50", jpeg_baseline, jpeg_baseline.main,
             lambda: [src, "-q", "50", "-device", "cuda"],
             lambda r, o: {k: (np.array([v]), None) for k, v in r.items()}, False),
        )
        for label, cli, fn, args, values, codec in runs:
            base_gib = torch.cuda.memory_allocated() / 2**30
            gdn.reset_launch_counts()
            res, out, secs, peak = run_captured(fn, args())
            n = gdn.launch_counts["gdn_fwd"]
            vals = values(res, out)
            rec = {"seconds": secs, "gdn_launches": n, "peak_gib": peak,
                   "values": {k: v.ravel().tolist()[:8] for k, (v, _) in vals.items()}}
            bad = [k for k, (v, _) in vals.items()
                   if not np.all(np.isfinite(v.astype(np.float64)))]
            if bad or (n == 0) == codec:
                raise RuntimeError(f"phase 17 {label}: non-finite {bad}, gdn_fwd launches {n}")
            if label.startswith("feature_range"):
                load_range_profile(profile, require=("dead", "ranks_min"))
                shutil.copy(profile, profile + ".kernel")
            if "--cross-model" in label:
                legs = re.findall(r"\[(attack|eval) (\d)/2\] memory: peak (\S+) GiB, (\S+) GiB "
                                  r"allocated after it was freed", out)
                rec["legs"] = [{"leg": f"{k} {i}", "peak_gib": float(p), "held_gib": float(h)}
                               for k, i, p, h in legs]
                rec["allocated_before_gib"] = base_gib
                # each leg resets the peak statistic: the run's peak is its legs' largest
                rec["peak_gib"] = peak = max([float(p) for _, _, p, _ in legs] or [peak])
                held = [float(h) for *_, h in legs]
                if len(legs) != 4 or max(held) > base_gib + LEG_HELD_MIB / 1024:
                    raise RuntimeError(f"phase 17 {label}: a freed leg holds memory: {legs}, "
                                       f"{base_gib:.3f} GiB allocated before the run")
                log(f"phase 17 cross-model legs (peak GiB, GiB held after the leg was freed; "
                    f"{base_gib:.3f} GiB allocated before): "
                    + ", ".join(f"{k} {i} {float(p):.3f}/{float(h):.3f}" for k, i, p, h in legs))
            if codec:
                with plain_gdn_in(cli):
                    gdn.reset_launch_counts()
                    plain, plain_out, plain_secs, _ = run_captured(fn, args())
                    if gdn.launch_counts["gdn_fwd"] != 0:
                        raise RuntimeError(f"phase 17 {label}: the plain run launched the kernel")
                pvals = values(plain, plain_out)
                gaps, over = {}, {}
                for k, (v, kind) in vals.items():
                    gap = float(np.max(np.abs(v - pvals[k][0]))) if v.size else 0.0
                    gaps[k] = gap
                    if kind == "rel":
                        scale = float(np.max(np.abs(pvals[k][0]))) or 1.0
                        if gap > eval_bound("clean", "bpp") * scale:
                            over[k] = gap
                    elif kind == "dB" and gap > eval_bound("clean", "psnr"):
                        over[k] = gap
                rec.update(plain_seconds=plain_secs, gaps=gaps)
                if label.startswith("feature_range"):
                    shutil.copy(profile + ".kernel", profile)  # search reads the kernel's
                if over:
                    raise RuntimeError(f"phase 17 {label}: kernel vs plain beyond the bounds: {over}")
            shown = "; ".join(f"{k} {np.array2string(v.ravel()[:5], precision=4)}"
                              for k, (v, _) in vals.items())
            log(f"phase 17 {label} 768x512: {secs:.2f} s"
                + (f" (plain GDN {rec['plain_seconds']:.2f} s)" if codec else "")
                + f", gdn_fwd launches {n}, peak {peak:.2f} GiB; {shown}"
                + ("; kernel vs plain gaps " + ", ".join(f"{k} {g:.3e}" for k, g in
                                                         rec["gaps"].items()) if codec else ""))
            records[label] = rec
            if codec:
                launches[f"17 {label} 768x512"] = n

        codec = load_codec("hyper", 1, CKPT)
        images = [to_tensor(synthetic_image(256, 256, seed=30 + i), "cuda") for i in (1, 2)]
        attack = make_attack_fn(codec, RDAttackConfig(steps=20, two_phase_impl="select"))
        (mk, lk), (mp, _) = kernel_and_plain(
            gdn, codec, lambda: cross_image_matrix(attack, make_transfer_eval_fn(codec), images))
        gap = float(np.max(np.abs(mk - mp)))
        log(f"phase 17 cross-image matrix x20 256x256, kernel vs plain: max |vi diff| {gap:.3e} "
            f"(tol {VI_ATOL}), kernel {np.array2string(mk, precision=4)}, gdn_fwd launches {lk}")
        if gap > VI_ATOL or not np.all(np.isfinite(mk)):
            raise RuntimeError(f"phase 17 cross-image x20: kernel vs plain differ: {mk} / {mp}")
        records["cross-image x20 256x256"] = {"kernel": mk.tolist(), "plain": mp.tolist(),
                                              "max_abs_diff": gap}
        launches["17 cross-image x20 256x256"] = lk
    return records, launches


def par_rank_setup():
    """A phase-18 rank: TF32 off and cuDNN deterministic, as the phases that
    hold two runs to each other set them; the codec on the rank's card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    return load_codec("hyper", 1, CKPT)


def measured(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after, the peak memory reset before it, and its synced seconds:
    ``(result, {"s", "peak_gib", "launches", "bwd_launches",
    "gdn_shapes"})``, the last the (C, rows) of every GDN call with rows
    that reached the forward or the backward kernel's wrapper."""
    import torch

    from imagecompression_adversarial_tpu_torch.kernels import gdn

    shapes = set()
    forward, backward = gdn.gdn_forward, gdn.gdn_backward

    def recorded_forward(x, *args):
        if x.shape[0]:  # an empty row block (uneven shards) launches nothing
            shapes.add((int(x.shape[1]), int(x.shape[0])))
        return forward(x, *args)

    def recorded_backward(x, *args):
        if x.shape[0]:
            shapes.add((int(x.shape[1]), int(x.shape[0])))
        return backward(x, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gdn.reset_launch_counts()
    gdn.gdn_forward, gdn.gdn_backward = recorded_forward, recorded_backward
    try:
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.time() - t
    finally:
        gdn.gdn_forward, gdn.gdn_backward = forward, backward
    return res, {"s": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "launches": gdn.launch_counts["gdn_fwd"],
                 "bwd_launches": gdn.launch_counts["gdn_bwd"], "gdn_shapes": sorted(shapes)}


@contextlib.contextmanager
def plain_gdn_backward():
    """The GDN's forward kernel with the plain backward (``GDNFunction``'s
    backward calls ``gdn_backward_reference`` in place of the kernel)."""
    from imagecompression_adversarial_tpu_torch.kernels import gdn

    wrapper = gdn.gdn_backward
    gdn.gdn_backward = gdn.gdn_backward_reference
    try:
        yield
    finally:
        gdn.gdn_backward = wrapper


def par_batches(steps: int):
    from imagecompression_adversarial_tpu_torch.io.image import to_tensor
    from imagecompression_adversarial_tpu_torch.train.data import synthetic_batches

    stream = synthetic_batches(8, 256, seed=0)
    return [to_tensor(next(stream), "cuda") for _ in range(steps)]


def par_step1_grads(codec, batch, mesh=None):
    """Step 1's gradients of the main parameters for the noise-quantized RD
    loss of ``batch`` (this rank's block under ``mesh``), reduced over the
    mesh."""
    import torch

    from imagecompression_adversarial_tpu_torch.ops import shard
    from imagecompression_adversarial_tpu_torch.train import (
        lambda_for, parameter_groups, rate_distortion_loss,
    )
    from imagecompression_adversarial_tpu_torch.train.step import mesh_shard, reduce_gradients_

    codec.requires_grad_(True)
    main, _ = parameter_groups(codec)
    where = mesh_shard(mesh, batch) if mesh is not None else None
    with shard.within(where) if where else contextlib.nullcontext():
        result = codec(batch, quant_mode="noise",
                       generator=torch.Generator(device="cuda").manual_seed(0))
        loss = rate_distortion_loss(result, batch, lambda_for("mse", 1), "mse")["loss"]
    grads = [torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(main, torch.autograd.grad(loss, main, allow_unused=True))]
    if where is not None:
        reduce_gradients_(grads, where)
    return grads


def wide(codec):
    """``codec`` in float64 with the plain GDN (the kernel takes float32)."""
    codec = codec.double()
    use_gdn_kernel(codec, False)
    return codec


def par_train(codec, batches, mesh=None, adv: bool = False):
    """Step 1's gradients of the main parameters (reduced over the mesh),
    then one RD step a batch (with ``adv``, on its adversarial example, as
    ``cli.train --adv -noise 0.0001`` makes it), from the same weights and
    noise seeds as phase 12c; with a mesh, ``batches`` are this rank's
    blocks.  Returns the gradients, the losses, the parameters and the
    steps' synced seconds."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.attacks.rd import make_adv_example_fn
    from imagecompression_adversarial_tpu_torch.train import (
        create_train_state, lambda_for, train_step,
    )

    grads = par_step1_grads(codec, batches[0], mesh)
    lmbda = lambda_for("mse", 1)
    state = create_train_state(codec, TRAIN_LR)
    gen = torch.Generator(device="cuda").manual_seed(42)
    adv_fn = (make_adv_example_fn(codec, RDAttackConfig(steps=TRAIN_ADV_ATTACK_STEPS), mesh)
              if adv else None)
    torch.cuda.synchronize()
    t = time.time()
    losses = []
    for b in batches:
        x = adv_fn(b, 1e-4) if adv else b
        losses.append(float(train_step(state, x, gen, TRAIN_LR, lmbda, mesh=mesh)["loss"]))
    torch.cuda.synchronize()
    seconds = time.time() - t
    return ([g.cpu() for g in grads], losses,
            {k: v.detach().cpu() for k, v in codec.state_dict().items()}, seconds)


def par_fingerprint(params) -> list:
    return [float(v.double().sum()) for v in params.values()]


def par_train_record(codec, adv: bool, mesh, steps: int):
    """``par_train`` on this rank's blocks of ``steps`` batches (dim 0 over
    ``dp``, the rows over ``sp``), measured."""
    import torch
    import torch.distributed as dist

    from imagecompression_adversarial_tpu_torch.parallel import batch_row_sharding, local_part

    batches = [local_part(mesh, b, batch_row_sharding(mesh)).contiguous(
        memory_format=torch.channels_last) for b in par_batches(steps)]
    (grads, losses, params, seconds), m = measured(
        lambda: par_train(codec, batches, mesh, adv))
    rank0 = dist.get_rank() == 0
    return {"grads": grads if rank0 else None, "losses": losses,
            "params": params if rank0 else None, "fingerprint": par_fingerprint(params),
            "steps_per_s": steps / seconds, **m}


def par_check_shapes(runs) -> None:
    """Raise where a rank's GDN call had a (C, rows) that phase 3 did not
    hold to the plain GDN."""
    seen = {tuple(p) for m in runs for p in m["gdn_shapes"]}
    missing = sorted(seen - set(GDN_SHAPES))
    if missing:
        raise RuntimeError(f"phase 18: GDN calls at (C, rows) {missing}, which phase 3 "
                           "does not hold to the plain GDN; add them to GDN_SHAPES")


def par_world_nccl():
    """Phase 18b, in the one NCCL rank: the row-sharded forward and a
    PAR_SP_STEPS-step attack on an sp=1 mesh (every conv through the halo
    path, each deconvolution in its subpixel form) and their unsharded
    counterparts; each attack is timed on its second run, after cuDNN
    has met its shapes."""
    import torch
    import torch.distributed as dist

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import (
        make_mesh, make_spatial_attack_fn, make_spatial_forward, replicate,
    )

    codec = par_rank_setup()
    mesh = make_mesh(axis_names=("sp",))
    replicate(mesh, codec)
    x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
    cfg = RDAttackConfig(steps=PAR_SP_STEPS, two_phase_impl="select")
    fwd, m_fwd = measured(lambda: make_spatial_forward(codec, mesh)(x)["x_hat"])
    with torch.no_grad():
        ref = codec(x, quant_mode="dequantize")["x_hat"]
    sharded, unsharded = make_spatial_attack_fn(codec, cfg, mesh), make_attack_fn(codec, cfg)
    sharded(x)
    res, m_att = measured(lambda: sharded(x))
    unsharded(x)
    want, m_ref = measured(lambda: unsharded(x))
    tol = GDN_ATOL + GDN_RTOL * ref.abs()
    return {"backend": dist.get_backend(),
            "xhat_max_abs": float((fwd - ref).abs().max()),
            "xhat_within": bool(((fwd - ref).abs() <= tol).all()),
            "noise_max_abs": float((res["im_"] - want["im_"]).abs().max()),
            "vi": float(res["vi"]), "vi_ref": float(want["vi"]),
            "forward": m_fwd, "attack": m_att, "attack_ref": m_ref}


def par_world_two():
    """Phases 18a and 18c, in each of two ranks: the collective probe, the
    dp=2 corpus attack, the sp=2 forward and attack, dp=2 RD and --adv
    training; phase 21e's -p run on uneven row blocks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import (
        make_mesh, make_sharded_attack_fn, make_spatial_attack_fn, make_spatial_forward, replicate,
    )
    from imagecompression_adversarial_tpu_torch.parallel import collective_report

    out = {"probe": collective_report("cuda"), "backend": dist.get_backend(),
           "card": torch.cuda.current_device()}
    codec = par_rank_setup()
    dp = make_mesh(axis_names=("dp",))
    sp = make_mesh(axis_names=("sp",))
    replicate(dp, codec)
    initial = {k: v.clone() for k, v in codec.state_dict().items()}
    rank0 = dist.get_rank() == 0

    xs = np.concatenate([synthetic_image(512, 768, seed=30 + i) for i in range(PAR_CORPUS)])
    attack = make_sharded_attack_fn(
        codec, RDAttackConfig(steps=PAR_CORPUS_STEPS, two_phase_impl="select"), dp)
    res, m = measured(lambda: attack(xs.transpose(0, 3, 1, 2)))
    out["corpus"] = {"vi": res["vi"], "im_": res["im_"] if rank0 else None,
                     "images_per_s": PAR_CORPUS / dp.size() / m["s"], **m}

    x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
    fwd, m = measured(lambda: make_spatial_forward(codec, sp)(x)["x_hat"])
    out["sp_forward"] = {"x_hat": fwd.cpu().numpy(), **m}
    sp_attack = make_spatial_attack_fn(
        codec, RDAttackConfig(steps=PAR_SP_STEPS, two_phase_impl="select"), sp)
    sp_attack(x)  # timed on its second run, after cuDNN has met its shapes
    res, m = measured(lambda: sp_attack(x))
    out["sp_attack"] = {"im_": res["im_"].cpu().numpy(), "vi": float(res["vi"]),
                        "steps_per_s": PAR_SP_STEPS / m["s"], **m}
    out.update(par_sp_slice9(codec, sp, x))
    out.update(par_sp_defenses(codec, sp, x))
    out["sp_pad_uneven"] = par_sp_uneven(codec, sp, x, "pad")
    out.update(par_sp_adapters(sp, x))
    for label, adv in (("train_rd", False), ("train_adv", True)):
        codec.load_state_dict(initial)
        out[label] = par_train_record(codec, adv, dp, TRAIN_KVP_STEPS)
    return out


def par_sp_slice9(codec, sp, x):
    """Phase 18c's sp=2 runs of the large-image slice, in each rank: the
    paper's model (cheng2020-gmm q3, demo weights) forward and a
    PAR_SP_STEPS-step `select` attack at 768x512, the MS-SSIM attack
    (PAR_SP_STEPS steps, `cond`) and a split attack at PAR_SPLIT_SIZE
    (`select`), each timed on its first run."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import (
        make_spatial_attack_fn, make_spatial_forward, replicate,
    )

    def attack(model, image, **kw):
        fn = make_spatial_attack_fn(model, RDAttackConfig(steps=PAR_SP_STEPS, **kw), sp)
        res, m = measured(lambda: fn(image))
        return {"im_": res["im_"].cpu().numpy(), "vi": float(res["vi"]),
                "steps_per_s": PAR_SP_STEPS / m["s"], **m}

    out = {}
    gmm = replicate(sp, load_codec("cheng2020-gmm", 3, CKPT_GMM))
    fwd, m = measured(lambda: make_spatial_forward(gmm, sp)(x)["x_hat"])
    out["sp_gmm_forward"] = {"x_hat": fwd.cpu().numpy(), **m}
    out["sp_gmm_attack"] = attack(gmm, x, two_phase_impl="select")
    del gmm, fwd
    out["sp_msssim"] = attack(codec, x, att_metric="ms-ssim", noise_threshold=PAR_MSSSIM_NOISE)
    h, w = PAR_SPLIT_SIZE
    out["sp_split"] = attack(codec, to_tensor(synthetic_image(h, w, seed=44), "cuda"),
                             two_phase_impl="select", split_eval=True)
    torch.cuda.empty_cache()
    return out


def par_hold_slice9(codec, two, records, launches) -> None:
    """Phase 18c: the sp=2 runs of ``par_sp_slice9`` held to one process."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    def rows(key, field="im_"):
        return torch.from_numpy(np.concatenate([r[key][field] for r in two], axis=2)).cuda()

    def one_process(model, image, **kw):
        fn = make_attack_fn(model, RDAttackConfig(steps=PAR_SP_STEPS, **kw))
        return measured(lambda: fn(image))

    def held(label, key, ref, m_ref, noise_atol, vi_atol, far_share=0.0):
        a = [r[key] for r in two]
        diff = (rows(key) - ref["im_"]).abs()
        far = float((diff > noise_atol).float().mean())
        dvi = max(abs(r["vi"] - float(ref["vi"])) for r in a)
        bound = f"share > {noise_atol} {far:.2e} (tol {far_share})" if far_share else \
            f"(tol {noise_atol})"
        log(f"phase 18c sp=2 {label}: noise max |diff| {float(diff.max()):.3e} {bound}, vi "
            f"{a[0]['vi']:.6f} / {float(ref['vi']):.6f} (tol {vi_atol}); per rank steps/s "
            f"{[round(r['steps_per_s'], 2) for r in a]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in a]} against {m_ref['peak_gib']:.3f} in one "
            f"process, GDN launches {[r['launches'] for r in a]} against {m_ref['launches']}; one "
            f"process {PAR_SP_STEPS / m_ref['s']:.2f} steps/s")
        if far > far_share or dvi > vi_atol or (not far_share and float(diff.max()) > noise_atol):
            raise RuntimeError(f"phase 18c sp=2 {label}: differs from one process")
        records[f"18c sp {label}"] = {
            "noise_max_abs": float(diff.max()), "far_share": far, "vi_abs": dvi,
            "steps_per_s": [r["steps_per_s"] for r in a], "peak_gib": [r["peak_gib"] for r in a],
            "one_process_steps_per_s": PAR_SP_STEPS / m_ref["s"],
            "one_process_peak_gib": m_ref["peak_gib"]}
        for r, out in enumerate(a):
            launches[f"18c sp=2 {label} rank {r}"] = out["launches"]

    x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
    gmm = load_codec("cheng2020-gmm", 3, CKPT_GMM)
    with torch.no_grad():
        want = gmm(x, quant_mode="dequantize")["x_hat"]
    dx = float((rows("sp_gmm_forward", "x_hat") - want).abs().max())
    log(f"phase 18c sp=2 cheng2020-gmm q3 forward at 768x512: x_hat max |diff| {dx:.3e} (tol "
        f"{PAR_XHAT_ATOL}), GDN launches {[r['sp_gmm_forward']['launches'] for r in two]}")
    if dx > PAR_XHAT_ATOL:
        raise RuntimeError("phase 18c: the sp=2 cheng2020-gmm forward differs from one process")
    records["18c sp cheng2020-gmm forward"] = {"xhat_max_abs": dx}
    for r, out in enumerate(two):
        launches[f"18c sp=2 cheng2020-gmm forward rank {r}"] = out["sp_gmm_forward"]["launches"]
    held(f"cheng2020-gmm q3 {PAR_SP_STEPS}-step select attack 768x512", "sp_gmm_attack",
         *one_process(gmm, x, two_phase_impl="select"), ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL)
    del gmm
    held(f"MS-SSIM {PAR_SP_STEPS}-step cond attack 768x512", "sp_msssim",
         *one_process(codec, x, att_metric="ms-ssim", noise_threshold=PAR_MSSSIM_NOISE),
         NOISE_ATOL, VI_ATOL, MSSSIM_FAR_SHARE)
    h, w = PAR_SPLIT_SIZE
    xl = to_tensor(synthetic_image(h, w, seed=44), "cuda")
    held(f"split {PAR_SP_STEPS}-step select attack {w}x{h}", "sp_split",
         *one_process(codec, xl, two_phase_impl="select", split_eval=True), NOISE_ATOL, VI_ATOL)


def par_defense_cfg(name: str):
    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig

    return RDAttackConfig(steps=PAR_DEFENSE_STEPS, two_phase_impl="select", **PAR_DEFENSES[name])


def par_sp_defenses(codec, sp, x):
    """Phase 18f's sp=2 runs of slice 12, in each rank: the attack through
    each in-loop defense and with -p (PAR_DEFENSES), each timed on its
    first run, and the resize's again with the plain GDN."""
    from imagecompression_adversarial_tpu_torch.parallel import make_spatial_attack_fn

    def run(name):
        fn = make_spatial_attack_fn(codec, par_defense_cfg(name), sp)
        res, m = measured(lambda: fn(x))
        return {"im_": res["im_"].cpu().numpy(), "vi": float(res["vi"]),
                "bpp_ori": float(res["bpp_ori"]), "steps_per_s": PAR_DEFENSE_STEPS / m["s"], **m}

    out = {f"sp_{name}": run(name) for name in PAR_DEFENSES}
    use_gdn_kernel(codec, False)
    out["sp_resize_plain"] = run("resize")
    use_gdn_kernel(codec, True)
    return out


def par_uneven_cfg(kind: str):
    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig

    extra = dict(pad=PAR_UNEVEN_PAD) if kind == "pad" else PAR_DEFENSES["ensemble"]
    return RDAttackConfig(steps=PAR_DEFENSE_STEPS, two_phase_impl="select", **extra)


def par_sp_uneven(codec, sp, x, kind: str) -> dict:
    """Phase 21e's run in each rank of ``sp``: the attack of
    ``par_uneven_cfg(kind)`` on ``x``, whose padded image (``pad``) or
    rotated variants (``ensemble``) split into uneven row blocks, timed on
    its first run."""
    from imagecompression_adversarial_tpu_torch.parallel import make_spatial_attack_fn

    fn = make_spatial_attack_fn(codec, par_uneven_cfg(kind), sp)
    res, m = measured(lambda: fn(x))
    return {"im_": res["im_"].cpu().numpy(), "vi": float(res["vi"]),
            "bpp_ori": float(res["bpp_ori"]), "steps_per_s": PAR_DEFENSE_STEPS / m["s"], **m}


def par_hold_defenses(codec, two, records, launches) -> None:
    """Phase 18f: the sp=2 runs of ``par_sp_defenses`` held to one process
    (cuDNN deterministic, as the ranks run), and the resize's plain-GDN run
    to its kernel run."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    def rows(key):
        return torch.from_numpy(np.concatenate([r[key]["im_"] for r in two], axis=2)).cuda()

    x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
    failed = []
    for name in PAR_DEFENSES:
        ref, m_ref = measured(lambda: make_attack_fn(codec, par_defense_cfg(name))(x))
        a = [r[f"sp_{name}"] for r in two]
        diff = (rows(f"sp_{name}") - ref["im_"]).abs()
        far = float((diff > NOISE_ATOL).float().mean())
        dvi = max(abs(r["vi"] - float(ref["vi"])) for r in a)
        dbpp = max(abs(r["bpp_ori"] / float(ref["bpp_ori"]) - 1.0) for r in a)
        label = f"18f sp=2 {PAR_DEFENSE_STEPS}-step select attack 768x512, " + (
            f"-p {PAR_PAD}" if name == "pad" else f"defense {name}")
        log(f"phase {label}: noise max |diff| {float(diff.max()):.3e}, share > {NOISE_ATOL} "
            f"{far:.2e} (tol {PAR_DEFENSE_FAR_SHARE}), vi {a[0]['vi']:.6f} / "
            f"{float(ref['vi']):.6f} (tol {VI_ATOL}), bpp_ori rel {dbpp:.2e} (tol "
            f"{PAR_BPP_RTOL}); per rank steps/s "
            f"{[round(r['steps_per_s'], 3) for r in a]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in a]} against {m_ref['peak_gib']:.3f} in one "
            f"process, GDN launches {[r['launches'] for r in a]} against {m_ref['launches']}; one "
            f"process {PAR_DEFENSE_STEPS / m_ref['s']:.3f} steps/s")
        if far > PAR_DEFENSE_FAR_SHARE or dvi > VI_ATOL or dbpp > PAR_BPP_RTOL or \
                not math.isfinite(a[0]["vi"]):
            failed.append(label)
        records[f"18f sp {name}"] = {
            "noise_max_abs": float(diff.max()), "far_share": far, "vi_abs": dvi,
            "bpp_ori_rel": dbpp, "steps_per_s": [r["steps_per_s"] for r in a],
            "peak_gib": [r["peak_gib"] for r in a], "launches": [r["launches"] for r in a],
            "one_process_steps_per_s": PAR_DEFENSE_STEPS / m_ref["s"],
            "one_process_peak_gib": m_ref["peak_gib"], "one_process_launches": m_ref["launches"]}
        for r, out in enumerate(a):
            launches[f"18f sp=2 {name} rank {r}"] = out["launches"]
    k, p = [r["sp_resize"] for r in two], [r["sp_resize_plain"] for r in two]
    diff = (rows("sp_resize") - rows("sp_resize_plain")).abs()
    far = float((diff > NOISE_ATOL).float().mean())
    dvi = abs(k[0]["vi"] - p[0]["vi"])
    log(f"phase 18f sp=2 resize attack 768x512, kernel vs plain GDN: noise max |diff| "
        f"{float(diff.max()):.3e}, share > {NOISE_ATOL} {far:.2e} (tol {PAR_DEFENSE_FAR_SHARE}), "
        f"vi {k[0]['vi']:.6f} / {p[0]['vi']:.6f} (tol {VI_ATOL}), GDN launches "
        f"{[r['launches'] for r in p]} (plain)")
    if far > PAR_DEFENSE_FAR_SHARE or dvi > VI_ATOL or any(r["launches"] for r in p):
        failed.append("the resize's kernel and plain-GDN runs")
    records["18f sp resize kernel vs plain"] = {"noise_max_abs": float(diff.max()),
                                                "far_share": far, "vi_abs": dvi}
    if failed:
        raise RuntimeError(f"phase 18f: differs from its reference: {failed}")


def par_adv_recompress_step(codec, batch, mesh=None):
    """One RD step with ``recompress`` on the --adv inner attack's example
    of ``batch`` (PAR_ADV_STEPS steps at -noise 0.0001), from the codec's
    weights, the noise seeded as in phase 12c; with a mesh, ``batch`` is
    this rank's block.  Returns the example, the logs, the parameters and
    the synced seconds of the attack and the step."""
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.attacks.rd import make_adv_example_fn
    from imagecompression_adversarial_tpu_torch.train import (
        create_train_state, lambda_for, train_step,
    )

    codec.requires_grad_(True)
    adv_fn = make_adv_example_fn(codec, RDAttackConfig(steps=PAR_ADV_STEPS), mesh)
    state = create_train_state(codec, TRAIN_LR)
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    t = time.time()
    x_adv = adv_fn(batch, 1e-4)
    logs = train_step(state, x_adv, gen, TRAIN_LR, lambda_for("mse", 1), recompress=True, mesh=mesh)
    logs = {k: float(v) for k, v in logs.items()}
    torch.cuda.synchronize()
    return (x_adv.cpu(), logs, {k: v.detach().cpu() for k, v in codec.state_dict().items()},
            time.time() - t)


def adapter_attack_cfg(model: str, steps: int):
    """Phase 18e's `select` attack of ``model``; fic starts from a restart's
    random noise (its zero start is a critical point), drawn for the whole
    image from a generator seeded 0."""
    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig

    return RDAttackConfig(steps=steps, two_phase_impl="select",
                          random_restarts=2 if model == "fic" else 1)


def cudnn_workspace_at_peak(run):
    """``run()`` with the allocator's history recorded (C++ stacks):
    ``(result, GiB live at the history's peak, GiB of those that cuDNN's
    convolution plans asked as workspace)``, the latter the blocks
    allocated under ``run_conv_plan``."""
    import torch

    torch.cuda.memory._record_memory_history(max_entries=HISTORY_ENTRIES, stacks="all")
    try:
        res = run()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            ws = any("run_conv_plan" in f.get("name", "") for f in ev.get("frames", ()))
            live[ev["addr"]] = (ev["size"], ws)
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    workspace = sum(size for size, ws in at_peak.values() if ws)
    return res, peak / 2 ** 30, workspace / 2 ** 30


def adapter_run(fn, x, steps: int, host: bool = True, history: bool = False) -> dict:
    """``fn(x, generator)`` measured: its vi, ``im_`` (copied to the host
    with ``host``), rate, peak memory and GDN launches; with ``history``
    also the cuDNN workspace live at the peak (``cudnn_workspace_at_peak``;
    the recording slows the run)."""
    import torch

    def call():
        return fn(x, torch.Generator("cuda").manual_seed(0))

    workspace = None
    if history:
        (res, _, workspace), m = measured(lambda: cudnn_workspace_at_peak(call))
    else:
        res, m = measured(call)
    im = res["im_"]
    return {"vi": float(res["vi"]), "finite": bool(torch.isfinite(im).all()),
            "im_": im.cpu().numpy() if host else im, "steps_per_s": steps / m["s"],
            "workspace_gib": workspace, **m}


def par_sp_adapters(sp, x):
    """Phase 18e's sp=2 runs of slice 10, in each rank: each adapter family
    at q3 (phase 13's weights), the `dequantize` forward and a
    PAR_ADAPTER_STEPS-step attack at 768x512 (fic's with the kernel and
    with the plain GDN), and for the three families with no split attack a
    PAR_ADAPTER_LARGE_STEPS-step attack at PAR_ADAPTER_LARGE_SIZE (cuDNN
    deterministic, then its default heuristics); each timed on its first
    run."""
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import (
        make_spatial_attack_fn, make_spatial_forward, replicate,
    )

    out = {}
    h, w = PAR_ADAPTER_LARGE_SIZE
    for model in ADAPTERS:
        codec = replicate(sp, load_codec(model, 3, ADAPTER_CKPTS.get(model)))
        fwd, m = measured(lambda: make_spatial_forward(codec, sp)(x)["x_hat"])
        rec = {"forward": {"x_hat": fwd.cpu().numpy(), **m}}
        attack = make_spatial_attack_fn(codec, adapter_attack_cfg(model, PAR_ADAPTER_STEPS), sp)
        rec["attack"] = adapter_run(attack, x, PAR_ADAPTER_STEPS)
        if model == "fic":
            use_gdn_kernel(codec, False)
            rec["attack_plain"] = adapter_run(attack, x, PAR_ADAPTER_STEPS)
            use_gdn_kernel(codec, True)
        if model in PAR_ADAPTER_LARGE:
            xl = to_tensor(synthetic_image(h, w, seed=45), "cuda")
            for key, deterministic in LARGE_RUNS:
                with cudnn_deterministic(deterministic):
                    rec[key] = adapter_run(make_spatial_attack_fn(
                        codec, adapter_attack_cfg(model, PAR_ADAPTER_LARGE_STEPS), sp), xl,
                        PAR_ADAPTER_LARGE_STEPS, history=not deterministic)
            del xl
        out[f"sp_{model}"] = rec
        del codec, attack, fwd
        free_card()
    return out


def par_hold_adapters(two, records, launches) -> None:
    """Phase 18e: the sp=2 runs of ``par_sp_adapters`` held to one process
    (cuDNN deterministic, as the ranks run), and fic's plain-GDN run to its
    kernel run."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    def rows(recs, field="im_"):
        return torch.from_numpy(np.concatenate([r[field] for r in recs], axis=2)).cuda()

    def held(label, recs, ref, noise_atol, vi_atol, far_share, steps):
        diff = (rows(recs) - ref["im_"]).abs()
        far = float((diff > NOISE_ATOL).float().mean())
        dvi = max(abs(r["vi"] - ref["vi"]) for r in recs)
        peak = max(r["peak_gib"] for r in recs)
        workspace = "" if ref["workspace_gib"] is None else (
            f" (cuDNN workspace live at the peak {[round(r['workspace_gib'], 3) for r in recs]} "
            f"against {ref['workspace_gib']:.3f} GiB; the allocator's history on)")
        log(f"phase 18e sp=2 {label}: noise max |diff| {float(diff.max()):.3e} (tol "
            f"{noise_atol}), share > {NOISE_ATOL} {far:.3e} (tol {far_share}), vi "
            f"{recs[0]['vi']:.6f} / {ref['vi']:.6f} (tol {vi_atol}); per rank steps/s "
            f"{[round(r['steps_per_s'], 3) for r in recs]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in recs]} against {ref['peak_gib']:.3f} in one "
            f"process (ratio {peak / ref['peak_gib']:.3f}){workspace}, GDN launches "
            f"{[r['launches'] for r in recs]} against {ref['launches']}; one process "
            f"{ref['steps_per_s']:.3f} steps/s")
        if not (all(r["finite"] for r in recs) and math.isfinite(ref["vi"])) or \
                float(diff.max()) > noise_atol or far > far_share or dvi > vi_atol:
            raise RuntimeError(f"phase 18e sp=2 {label}: differs from one process")
        return {"noise_max_abs": float(diff.max()), "far_share": far, "vi_abs": dvi,
                "steps_per_s": [r["steps_per_s"] for r in recs],
                "peak_gib": [r["peak_gib"] for r in recs], "peak_ratio": peak / ref["peak_gib"],
                "workspace_gib": [r["workspace_gib"] for r in recs],
                "one_process_workspace_gib": ref["workspace_gib"],
                "launches": [r["launches"] for r in recs],
                "one_process_steps_per_s": ref["steps_per_s"],
                "one_process_peak_gib": ref["peak_gib"]}

    x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
    h, w = PAR_ADAPTER_LARGE_SIZE
    for model in ADAPTERS:
        a = [r[f"sp_{model}"] for r in two]
        trained = model in ("nlaic", "fic")  # the two with GDN and phase 14's bounds
        codec = load_codec(model, 3, ADAPTER_CKPTS.get(model))
        with torch.no_grad():
            want = codec(x, quant_mode="dequantize")["x_hat"]
        dx = float((rows([r["forward"] for r in a], "x_hat") - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        log(f"phase 18e sp=2 {model} q3 forward at 768x512: x_hat max |diff| {dx:.3e} (tol "
            f"{PAR_XHAT_ATOL} x {scale:.3f}, the largest |x_hat| or 1), GDN launches "
            f"{[r['forward']['launches'] for r in a]}, peak GiB "
            f"{[round(r['forward']['peak_gib'], 3) for r in a]}")
        if dx > PAR_XHAT_ATOL * scale:
            raise RuntimeError(f"phase 18e: the sp=2 {model} forward differs from one process")
        rec = {"xhat_max_abs": dx, "xhat_scale": scale}
        bounds = ((ANCHOR_NOISE_ATOL, ANCHOR_VI_ATOL, 1.0) if trained else
                  (float("inf"), ADAPTER_VI_ATOL, ADAPTER_FAR_SHARE))
        ref = adapter_run(make_attack_fn(codec, adapter_attack_cfg(model, PAR_ADAPTER_STEPS)), x,
                          PAR_ADAPTER_STEPS, host=False)
        rec["attack"] = held(f"{model} q3 {PAR_ADAPTER_STEPS}-step select attack 768x512",
                             [r["attack"] for r in a], ref, *bounds, PAR_ADAPTER_STEPS)
        if model == "fic":
            k, p = [r["attack"] for r in a], [r["attack_plain"] for r in a]
            noise = float((rows(k) - rows(p)).abs().max())
            dvi = abs(k[0]["vi"] - p[0]["vi"])
            log(f"phase 18e sp=2 fic q3 attack 768x512, kernel vs plain GDN: noise max |diff| "
                f"{noise:.3e} (tol {ANCHOR_NOISE_ATOL}), vi {k[0]['vi']:.6f} / {p[0]['vi']:.6f} "
                f"(tol {ANCHOR_VI_ATOL}), GDN launches {[r['launches'] for r in p]} (plain)")
            if noise > ANCHOR_NOISE_ATOL or dvi > ANCHOR_VI_ATOL or any(r["launches"] for r in p):
                raise RuntimeError("phase 18e: fic's sp=2 kernel and plain-GDN runs differ")
            rec["attack_kernel_vs_plain"] = {"noise_max_abs": noise, "vi_abs": dvi}
        if model in PAR_ADAPTER_LARGE:
            xl = to_tensor(synthetic_image(h, w, seed=45), "cuda")
            fn = make_attack_fn(codec, adapter_attack_cfg(model, PAR_ADAPTER_LARGE_STEPS))
            for key, deterministic in LARGE_RUNS:
                with cudnn_deterministic(deterministic):
                    ref = adapter_run(fn, xl, PAR_ADAPTER_LARGE_STEPS, host=False,
                                      history=not deterministic)
                rec[key] = held(
                    f"{model} q3 {PAR_ADAPTER_LARGE_STEPS}-step select attack {w}x{h}, cuDNN "
                    f"{'deterministic' if deterministic else 'default heuristics'}",
                    [r[key] for r in a], ref, float("inf"), ADAPTER_VI_ATOL, ADAPTER_FAR_SHARE,
                    PAR_ADAPTER_LARGE_STEPS)
                del ref
            del xl, fn
        records[f"18e sp {model}"] = rec
        if trained:
            for r, out in enumerate(a):
                for key in ("forward", "attack"):
                    if out[key]["launches"] == 0:
                        raise RuntimeError(f"phase 18e: sp=2 {model} {key} launched no GDN kernel")
                    launches[f"18e sp=2 {model} {key} rank {r}"] = out[key]["launches"]
        del codec, want
        free_card()


def par_world_four():
    """Phases 18d and 18f, in each of four ranks: one dp x sp = 2 x 2 RD
    step, and step 1's gradients again in float64; one step with
    ``recompress`` on the --adv inner attack's example, in float32 and in
    float64; phase 21e's ensemble on sp=4, uneven row blocks."""
    import torch
    import torch.distributed as dist

    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import (
        batch_row_sharding, local_part, make_mesh, replicate,
    )

    codec = par_rank_setup()
    mesh = make_mesh(axis_names=("dp", "sp"), shape=(2, 2))
    replicate(mesh, codec)
    record = par_train_record(codec, False, mesh, 1)
    codec = replicate(mesh, wide(par_rank_setup()))
    batch = local_part(mesh, par_batches(1)[0], batch_row_sharding(mesh)).contiguous(
        memory_format=torch.channels_last)
    grads = [g.cpu() for g in par_step1_grads(codec, batch.double(), mesh)]
    record["grads_f64"] = grads if dist.get_rank() == 0 else None
    out = {"train_dpsp": record, "backend": dist.get_backend(),
           "card": torch.cuda.current_device()}
    # 18f: the --adv inner attack and recompression on dp x sp, float32
    # with the kernel, then float64 with the plain GDN
    for key, codec, b in (("adv_recompress", par_rank_setup(), batch),
                          ("adv_recompress_f64", wide(par_rank_setup()), batch.double())):
        (x_adv, logs, params, seconds), m = measured(
            lambda: par_adv_recompress_step(replicate(mesh, codec), b, mesh))
        out[key] = {"x_adv": x_adv, "logs": logs,
                    "params": params if dist.get_rank() == 0 else None,
                    "fingerprint": par_fingerprint(params), "step_s": seconds, **m}
    sp = make_mesh(axis_names=("sp",))
    codec = replicate(sp, par_rank_setup())
    x = to_tensor(synthetic_image(*PAR_UNEVEN_SIZE, seed=0), "cuda")
    out["sp_ensemble_uneven"] = par_sp_uneven(codec, sp, x, "ensemble")
    return out


def par_hold_training(label: str, ranks, ref, steps: int, grads_f64=None) -> dict:
    """Phase 12c's bounds between a sharded run's ranks and the one-process
    run; every rank must hold the same parameters.  With ``grads_f64`` (the
    one-process float64 gradients), step 1's gradients are held in float64
    at PAR_F64_GRAD_REL, and the float32 ones are recorded."""
    from imagecompression_adversarial_tpu_torch.train.step import LR_AUX

    def grad_rel(got, want):
        return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(got, want))

    grads, losses, params, _ = ref
    got = ranks[0]
    rec = {"steps_per_s": [r["steps_per_s"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks], "launches": [r["launches"] for r in ranks]}
    rec["loss_rel"] = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], losses))
    rec["grad_rel"] = grad_rel(got["grads"], grads)
    grad_tol = TRAIN_GRAD_REL
    if grads_f64 is not None:
        rec["grad_rel_f32"] = rec["grad_rel"]
        rec["grad_rel"] = grad_rel(got["grads_f64"], grads_f64)
        grad_tol = PAR_F64_GRAD_REL
    far = total = 0
    rec["param_max_abs"] = 0.0
    for name, a in got["params"].items():
        lr = LR_AUX if name.endswith("quantiles") else TRAIN_LR
        diff = (a - params[name]).abs()
        worst = float(diff.max())
        rec["param_max_abs"] = max(rec["param_max_abs"], worst)
        if worst > 2 * steps * lr:
            raise RuntimeError(f"phase 18 {label}: {name} {worst:.3e} apart after {steps} steps")
        far += int((diff > lr / 10).sum())
        total += diff.numel()
    rec["far_share"] = far / total
    same = all(r["fingerprint"] == got["fingerprint"] for r in ranks)
    log(f"phase 18 {label} vs one process, {steps} step(s): loss max rel {rec['loss_rel']:.3e} "
        f"(tol {TRAIN_LOSS_RTOL}), step-1 gradients max rel {rec['grad_rel']:.3e} (tol "
        f"{grad_tol}{', float64; float32 %.3e' % rec['grad_rel_f32'] if grads_f64 is not None else ''}"
        f"), params max |diff| {rec['param_max_abs']:.3e} (tol 2 x {steps} x lr), "
        f"share > lr/10 {rec['far_share']:.2e} (tol {TRAIN_FAR_SHARE}), ranks equal {same}; "
        f"per rank: steps/s {[round(v, 3) for v in rec['steps_per_s']]}, peak GiB "
        f"{[round(v, 3) for v in rec['peak_gib']]}, GDN launches {rec['launches']}")
    if rec["loss_rel"] > TRAIN_LOSS_RTOL or rec["grad_rel"] > grad_tol or \
            rec["far_share"] > TRAIN_FAR_SHARE or not same:
        raise RuntimeError(f"phase 18 {label}: the sharded run differs beyond the tolerances")
    return rec


def par_hold_adv_recompress(four, records) -> None:
    """Phase 18f: the four ranks' dp x sp step with ``recompress`` on the
    --adv inner attack's example, held to one process: in float32 (the
    kernel) at phase 12c's bounds and in float64 (the plain GDN) at
    PAR_F64_ATOL and PAR_F64_GRAD_REL; every rank must hold the same
    parameters."""
    import torch

    from imagecompression_adversarial_tpu_torch.train.step import LR_AUX

    for key, make, f64 in (("adv_recompress", lambda: load_codec("hyper", 1, CKPT), False),
                           ("adv_recompress_f64", lambda: wide(load_codec("hyper", 1, CKPT)),
                            True)):
        batch = par_batches(1)[0]
        with cudnn_deterministic():
            x_ref, logs_ref, params_ref, s_ref = par_adv_recompress_step(
                make(), batch.double() if f64 else batch)
        ranks = [r[key] for r in four]
        # rank = 2 x (dp index) + (sp index); a rank holds half the rows of
        # half the batch
        x_adv = torch.cat([torch.cat([ranks[2 * d + i]["x_adv"] for i in range(2)], dim=2)
                           for d in range(2)])
        noise = float((x_adv - x_ref).abs().max())
        loss_rel = max(abs(r["logs"][k] / logs_ref[k] - 1.0) for r in ranks
                       for k in ("loss", "recompress_loss"))
        far = total = 0
        worst = 0.0
        for name, a in ranks[0]["params"].items():
            diff = (a - params_ref[name]).abs()
            lr = LR_AUX if name.endswith("quantiles") else TRAIN_LR
            worst = max(worst, float(diff.max()) / (2 * lr))
            far += int((diff > lr / 10).sum())
            total += diff.numel()
        same = all(r["fingerprint"] == ranks[0]["fingerprint"] for r in ranks)
        param_max = max(float((a - params_ref[n]).abs().max())
                        for n, a in ranks[0]["params"].items())
        if f64:
            bounds = f"example tol {PAR_F64_ATOL}, losses tol {PAR_F64_GRAD_REL}, params tol " \
                     f"{PAR_F64_ATOL}"
            ok = noise <= PAR_F64_ATOL and loss_rel <= PAR_F64_GRAD_REL and \
                param_max <= PAR_F64_ATOL
        else:
            bounds = f"example tol {NOISE_ATOL}, losses tol {TRAIN_LOSS_RTOL}, params tol 2 x " \
                     f"lr, share > lr/10 {far / total:.2e} (tol {TRAIN_FAR_SHARE})"
            ok = noise <= NOISE_ATOL and loss_rel <= TRAIN_LOSS_RTOL and worst <= 1.0 and \
                far <= TRAIN_FAR_SHARE * total
        log(f"phase 18f dp x sp = 2 x 2 recompress step on the {PAR_ADV_STEPS}-step --adv example "
            f"({'float64, plain GDN' if f64 else 'float32, the kernel'}) vs one process: example "
            f"max |diff| {noise:.3e}, loss and recompress_loss max rel {loss_rel:.3e}, params max "
            f"|diff| {param_max:.3e} ({bounds}), ranks equal {same}; recompress_loss "
            f"{ranks[0]['logs']['recompress_loss']:.6f}; per rank: s "
            f"{[round(r['step_s'], 3) for r in ranks]} (one process {s_ref:.3f}), peak GiB "
            f"{[round(r['peak_gib'], 3) for r in ranks]}, GDN "
            f"launches {[r['launches'] for r in ranks]}")
        if not ok or not same or (not f64 and any(r["launches"] == 0 for r in ranks)):
            raise RuntimeError(f"phase 18f {key}: the dp x sp step differs from one process")
        records[f"18f dp x sp {key}"] = {
            "example_max_abs": noise, "loss_rel": loss_rel, "param_max_abs": param_max,
            "far_share": far / total, "step_s": [r["step_s"] for r in ranks],
            "one_process_step_s": s_ref, "peak_gib": [r["peak_gib"] for r in ranks],
            "launches": [r["launches"] for r in ranks]}


def phase_parallel(gdn):
    """Phase 18: the parallel layer in spawned ranks, each run held to its
    one-process counterpart; returns the records, the ranks' GDN launches
    and phase 21e's uneven runs (``{"pad": ranks, "ensemble": ranks}``),
    which phase 21 holds."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig
    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn, make_batch_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.parallel import run_spmd

    records, launches = {}, {}
    t0 = time.time()
    one = run_spmd(par_world_nccl, 1, "nccl", timeout=PAR_TIMEOUT_S)[0]
    ok = one["xhat_within"] and one["noise_max_abs"] <= NOISE_ATOL and \
        abs(one["vi"] - one["vi_ref"]) <= VI_ATOL
    log(f"phase 18b one {one['backend']} rank, sp=1 at 768x512: x_hat max |diff| "
        f"{one['xhat_max_abs']:.3e} (tol {GDN_ATOL} + {GDN_RTOL} x |x_hat|), {PAR_SP_STEPS}-step "
        f"attack noise max |diff| {one['noise_max_abs']:.3e} (tol {NOISE_ATOL}), vi "
        f"{one['vi']:.6f} / {one['vi_ref']:.6f} (tol {VI_ATOL}); attack {one['attack']['s']:.2f} s "
        f"sharded / {one['attack_ref']['s']:.2f} s unsharded, peak {one['attack']['peak_gib']:.3f} "
        f"/ {one['attack_ref']['peak_gib']:.3f} GiB, GDN launches {one['forward']['launches']} + "
        f"{one['attack']['launches']}")
    if not ok:
        raise RuntimeError("phase 18b: the sp=1 runs differ from the unsharded ones")
    launches["18b sp=1 nccl forward"] = one["forward"]["launches"]
    launches["18b sp=1 nccl attack"] = one["attack"]["launches"]
    records["18b"] = {k: v for k, v in one.items()}

    two = run_spmd(par_world_two, 2, timeout=PAR_TIMEOUT_S)
    log(f"phase 18a probe, 2 {two[0]['backend']} ranks on cards {[r['card'] for r in two]}, "
        f"cuda tensors: {json.dumps(two[0]['probe'])}")
    if any(two[0]["probe"][k] != "ok" for k in ("all_reduce", "broadcast")):
        raise RuntimeError("phase 18a: all_reduce or broadcast fails on cuda tensors")
    records["18a"] = {"backend": two[0]["backend"], "cards": [r["card"] for r in two],
                      "collectives": two[0]["probe"]}
    codec = load_codec("hyper", 1, CKPT)
    with cudnn_deterministic():
        # 18c: the one-process counterparts
        xs = to_tensor(np.concatenate([synthetic_image(512, 768, seed=30 + i)
                                       for i in range(PAR_CORPUS)]), "cuda")
        ref, m_ref = measured(lambda: make_batch_attack_fn(
            codec, RDAttackConfig(steps=PAR_CORPUS_STEPS, two_phase_impl="select"))(xs))
        c = [r["corpus"] for r in two]
        noise = float((torch.from_numpy(c[0]["im_"]).cuda() - ref["im_"]).abs().max())
        dvi = float(np.abs(c[0]["vi"] - ref["vi"].cpu().numpy()).max())
        same = all(np.array_equal(r["vi"], c[0]["vi"]) for r in c)
        log(f"phase 18c dp=2 corpus attack, {PAR_CORPUS} x 768x512, {PAR_CORPUS_STEPS} steps: "
            f"noise max |diff| {noise:.3e} (tol {NOISE_ATOL}), vi max |diff| {dvi:.3e} (tol "
            f"{VI_ATOL}), vi {np.round(c[0]['vi'], 4).tolist()}, ranks equal {same}; per rank "
            f"images/s {[round(r['images_per_s'], 3) for r in c]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in c]}, GDN launches {[r['launches'] for r in c]}; "
            f"one process {PAR_CORPUS / m_ref['s']:.3f} images/s, {m_ref['peak_gib']:.3f} GiB")
        if noise > NOISE_ATOL or dvi > VI_ATOL or not same:
            raise RuntimeError("phase 18c: the dp corpus attack differs from one process")
        records["18c corpus"] = {"noise_max_abs": noise, "vi_max_abs": dvi,
                                 "images_per_s": [r["images_per_s"] for r in c],
                                 "peak_gib": [r["peak_gib"] for r in c],
                                 "one_process_images_per_s": PAR_CORPUS / m_ref["s"],
                                 "one_process_peak_gib": m_ref["peak_gib"]}

        x = to_tensor(synthetic_image(512, 768, seed=0), "cuda")
        with torch.no_grad():
            want = codec(x, quant_mode="dequantize")["x_hat"]
        got = torch.from_numpy(np.concatenate([r["sp_forward"]["x_hat"] for r in two], axis=2))
        dx = float((got.cuda() - want).abs().max())
        attack = make_attack_fn(codec, RDAttackConfig(steps=PAR_SP_STEPS, two_phase_impl="select"))
        attack(x)
        ref, m_ref = measured(lambda: attack(x))
        a = [r["sp_attack"] for r in two]
        noise = float((torch.from_numpy(np.concatenate([r["im_"] for r in a], axis=2)).cuda()
                       - ref["im_"]).abs().max())
        dvi = max(abs(r["vi"] - float(ref["vi"])) for r in a)
        log(f"phase 18c sp=2 at 768x512: forward x_hat max |diff| {dx:.3e} (tol {PAR_XHAT_ATOL}), "
            f"{PAR_SP_STEPS}-step attack noise max |diff| {noise:.3e} (tol {NOISE_ATOL}), vi "
            f"{a[0]['vi']:.6f} / {float(ref['vi']):.6f} (tol {VI_ATOL}); per rank steps/s "
            f"{[round(r['steps_per_s'], 2) for r in a]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in a]} against {m_ref['peak_gib']:.3f} unsharded, "
            f"GDN launches {[r['launches'] for r in a]} against {m_ref['launches']} unsharded "
            f"(`select`: the codec on every step); one process "
            f"{PAR_SP_STEPS / m_ref['s']:.2f} steps/s")
        if dx > PAR_XHAT_ATOL or noise > NOISE_ATOL or dvi > VI_ATOL:
            raise RuntimeError("phase 18c: the sp=2 runs differ from one process")
        records["18c sp"] = {"xhat_max_abs": dx, "noise_max_abs": noise, "vi_abs": dvi,
                             "steps_per_s": [r["steps_per_s"] for r in a],
                             "peak_gib": [r["peak_gib"] for r in a],
                             "one_process_peak_gib": m_ref["peak_gib"],
                             "one_process_steps_per_s": PAR_SP_STEPS / m_ref["s"]}
        par_hold_slice9(codec, two, records, launches)
        par_hold_defenses(codec, two, records, launches)
        par_hold_adapters(two, records, launches)
        for label, adv in (("train_rd", False), ("train_adv", True)):
            codec = load_codec("hyper", 1, CKPT)
            ref = par_train(codec, par_batches(TRAIN_KVP_STEPS), adv=adv)
            records[f"18c {label}"] = par_hold_training(
                f"18c dp=2 {label}", [r[label] for r in two], ref, TRAIN_KVP_STEPS)
            records[f"18c {label}"]["one_process_steps_per_s"] = TRAIN_KVP_STEPS / ref[3]
    for r, out in enumerate(two):
        launches[f"18c dp=2 corpus rank {r}"] = out["corpus"]["launches"]
        launches[f"18c sp=2 forward rank {r}"] = out["sp_forward"]["launches"]
        launches[f"18c sp=2 attack rank {r}"] = out["sp_attack"]["launches"]
        launches[f"18c dp=2 train_rd rank {r}"] = out["train_rd"]["launches"]
        launches[f"18c dp=2 train_adv rank {r}"] = out["train_adv"]["launches"]

    four = run_spmd(par_world_four, 4, timeout=PAR_TIMEOUT_S)
    log(f"phase 18d: 4 {four[0]['backend']} ranks on cards {[r['card'] for r in four]}")
    records["18d"] = {"backend": four[0]["backend"], "cards": [r["card"] for r in four]}
    with cudnn_deterministic():
        codec = load_codec("hyper", 1, CKPT)
        ref = par_train(codec, par_batches(1))
        exact = [g.cpu() for g in par_step1_grads(wide(load_codec("hyper", 1, CKPT)),
                                                  par_batches(1)[0].double())]
        records["18d train_dpsp"] = par_hold_training(
            "18d dp x sp = 2 x 2 train_rd", [r["train_dpsp"] for r in four], ref, 1, exact)
    par_hold_adv_recompress(four, records)
    for r, out in enumerate(four):
        launches[f"18d dp x sp train_rd rank {r}"] = out["train_dpsp"]["launches"]
        launches[f"18f dp x sp --adv + recompress rank {r}"] = out["adv_recompress"]["launches"]
    if any(n == 0 for n in launches.values()):
        raise RuntimeError(f"phase 18: a rank launched no GDN kernel: {launches}")
    runs = [one["forward"], one["attack"], *[r["train_dpsp"] for r in four]]
    runs += [r["adv_recompress"] for r in four]
    runs += [r[k] for r in two for k in ("corpus", "sp_forward", "sp_attack", "train_rd",
                                          "train_adv", "sp_gmm_forward", "sp_gmm_attack",
                                          "sp_msssim", "sp_split",
                                          *(f"sp_{name}" for name in PAR_DEFENSES))]
    runs += [m[k] for r in two for m in (r[f"sp_{f}"] for f in ADAPTERS) for k in m]
    uneven = {"pad": [r["sp_pad_uneven"] for r in two],
              "ensemble": [r["sp_ensemble_uneven"] for r in four]}
    runs += uneven["pad"] + uneven["ensemble"]
    par_check_shapes(runs)
    log(f"phase 18 GDN (C, rows) of the ranks, each held to the plain GDN in phase 3: "
        f"{sorted({tuple(p) for m in runs for p in m['gdn_shapes']})}")
    log(f"phase 18 done in {time.time() - t0:.1f} s")
    return records, launches, uneven


def mp_attack(codec, steps: int, split: bool):
    from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn

    return make_attack_fn(codec, RDAttackConfig(steps=steps, two_phase_impl="select",
                                                split_eval=split))


def mp_run(label: str, attack, x, steps: int, runs: list) -> tuple:
    """``attack(x)`` measured; logs steps/s (the clean forward and the
    evaluation included), peak and held memory, vi, bpp and GDN launches;
    fails on a non-finite value or no launch.  Returns (result, record)."""
    import torch

    before = torch.cuda.memory_allocated() / 2 ** 30
    res, m = measured(lambda: attack(x))
    runs.append(m)
    vals = {k: float(res[k]) for k in ("vi", "bpp_ori", "bpp")}
    rec = {"size": [x.shape[3], x.shape[2]], "steps": steps, "s": m["s"],
           "steps_per_s": steps / m["s"], "peak_gib": m["peak_gib"],
           "allocated_before_gib": before, "launches": m["launches"],
           "bwd_launches": m["bwd_launches"], **vals}
    log(f"phase {label} {x.shape[3]}x{x.shape[2]}: {steps} steps in {m['s']:.2f} s "
        f"({rec['steps_per_s']:.3f} steps/s, the clean forward and the evaluation included), "
        f"peak {m['peak_gib']:.3f} GiB ({before:.3f} GiB allocated before it), vi "
        f"{vals['vi']:.4f}, bpp_ori {vals['bpp_ori']:.4f}, bpp {vals['bpp']:.4f}, gdn_fwd "
        f"launches {m['launches']}, gdn_bwd launches {m['bwd_launches']}")
    if not all(math.isfinite(v) for v in vals.values()) or m["launches"] == 0:
        raise RuntimeError(f"phase {label}: non-finite result or no GDN launch")
    return res, rec


def expandable_segments(on: bool) -> None:
    """The caching allocator's ``expandable_segments`` setting, for the
    allocations that follow."""
    import torch

    setting = f"expandable_segments:{on}"
    set_ = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (set_ or torch.cuda.memory._set_allocator_settings)(setting)


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_megapixel(gdn):
    """Phase 19: attacks on images of 12.6 MP and more on one card, the
    large-image path (``split_eval``); returns the records, the forward
    kernel's launches of each run, the backward kernel's of 19a's and
    phase-3 records of any row count phase 3 did not hold."""
    import torch

    from imagecompression_adversarial_tpu_torch.cli.attack_rd import main as cli_main
    from imagecompression_adversarial_tpu_torch.io.image import (
        synthetic_image, to_tensor, write_image,
    )

    t0 = time.time()
    records, launches, runs = {}, {}, []
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    h, w = MP_SIZE
    codec = load_codec("hyper", 1, CKPT)
    x = to_tensor(synthetic_image(h, w, seed=40), "cuda")
    with cudnn_deterministic():
        # one step first: the first call at this size meets the libraries' set-up
        mp_attack(codec, 1, False)(x)
        free_card()
        res, rec = mp_run("19a hyper q1 single-program", mp_attack(codec, MP_STEPS, False), x,
                          MP_STEPS, runs)
        single = {"im_": res["im_"], "vi": res["vi"]}
        del res
        free_card()
        split_fn = mp_attack(codec, MP_STEPS, True)
        res, rec_split = mp_run("19a hyper q1 split", split_fn, x, MP_STEPS, runs)
        split = {"im_": res["im_"], "vi": res["vi"]}
        del res
        rec_split.update(hold("hyper q1 4096x3072", split, single,
                              what="split vs single-program", phase="19a"))
        records["19a single"], records["19a split"] = rec, rec_split
        launches["19a single-program 4096x3072"] = rec["launches"]
        launches["19a split 4096x3072"] = rec_split["launches"]
        free_card()
        res, rec_again = mp_run("19b hyper q1 split, again in the same process", split_fn, x,
                                MP_STEPS, runs)
        rec_again["equal_to_first"] = bool(torch.equal(res["im_"], split["im_"]))
        del res, split, single
        free_card()
        rec_again["allocated_after_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        log(f"phase 19b the second split run's noise equals the first's: "
            f"{rec_again['equal_to_first']}; {rec_again['allocated_after_gib']:.3f} GiB allocated "
            f"after both were freed")
        records["19b split again"] = rec_again
        launches["19b split 4096x3072 again"] = rec_again["launches"]
        launches_bwd = {"19a single-program 4096x3072": rec["bwd_launches"],
                        "19a split 4096x3072": rec_split["bwd_launches"]}

        # (g) the same attacks with the plain backward: the peak memory the
        # backward kernel leaves against the plain chain's temporaries
        peaks = {"single": {"kernel": rec["peak_gib"]}, "split": {"kernel": rec_split["peak_gib"]}}
        with plain_gdn_backward():
            for kind, split in (("single", False), ("split", True)):
                free_card()
                res, plain = mp_run(f"19g hyper q1 {kind}, plain GDN backward",
                                    mp_attack(codec, MP_PLAIN_BWD_STEPS, split), x,
                                    MP_PLAIN_BWD_STEPS, runs)
                del res
                if plain["bwd_launches"] != 0:
                    raise RuntimeError("phase 19g: the plain backward launched the kernel")
                peaks[kind]["plain"] = plain["peak_gib"]
        free_card()
        records["19g peaks, kernel and plain backward"] = peaks
        log(f"phase 19g peak GiB with the backward kernel / the plain backward: single-program "
            f"{peaks['single']['kernel']:.3f} / {peaks['single']['plain']:.3f}, split "
            f"{peaks['split']['kernel']:.3f} / {peaks['split']['plain']:.3f} (split over "
            f"single-program {peaks['split']['kernel'] / peaks['single']['kernel']:.3f} / "
            f"{peaks['split']['plain'] / peaks['single']['plain']:.3f}); the previous backward "
            f"kernel's run: " + ", ".join(
                f"{kind} {PREVIOUS_BWD['19a peak GiB'][kind]:.3f} / "
                f"{PREVIOUS_BWD['19g peak GiB'][kind]:.3f}" for kind in ("single", "split")))

        # (c) the split attack above what one program could hold; the
        # allocator maps its blocks into growing segments, or the blocks
        # that 19a-b and the clean forward freed leave no room for the
        # backward's largest tensors (without it, at 9344x7040: 10.5 GiB
        # reserved but unallocated when 7.8 GiB were asked for)
        per_px = rec["peak_gib"] / (h * w)
        hl, wl = MP_LARGE
        expandable_segments(True)
        while True:
            guess = per_px * hl * wl
            log(f"phase 19c {wl}x{hl}: the single-program peak scaled from 4096x3072 would be "
                f"{guess:.1f} GiB, the card holds {card_gib:.1f} GiB")
            try:
                xl = to_tensor(synthetic_image(hl, wl, seed=42), "cuda")
                res, rec = mp_run("19c hyper q1 split", mp_attack(codec, MP_LARGE_STEPS, True), xl,
                                  MP_LARGE_STEPS, runs)
                break
            except torch.cuda.OutOfMemoryError as e:
                log(f"phase 19c {wl}x{hl} does not fit: {str(e).splitlines()[0]}")
            xl = None
            free_card()
            hl, wl = (int(hl * MP_SHRINK) // 64 * 64, int(wl * MP_SHRINK) // 64 * 64)
        rec["single_program_peak_scaled_gib"] = guess
        rec["card_gib"] = card_gib
        records["19c split large"] = rec
        launches[f"19c split {wl}x{hl}"] = rec["launches"]
        del res, xl, codec
        free_card()
        expandable_segments(False)

        gmm = load_codec("cheng2020-gmm", 3, CKPT_GMM)
        mp_attack(gmm, 1, True)(x)  # the libraries' set-up at this model's shapes
        free_card()
        res, rec = mp_run("19d cheng2020-gmm q3 single-program",
                          mp_attack(gmm, MP_GMM_STEPS, False), x, MP_GMM_STEPS, runs)
        single = {"im_": res["im_"], "vi": res["vi"]}
        del res
        free_card()
        res, rec_split = mp_run("19d cheng2020-gmm q3 split", mp_attack(gmm, MP_GMM_STEPS, True),
                                x, MP_GMM_STEPS, runs)
        rec_split.update(hold("cheng2020-gmm q3 4096x3072", res, single, ANCHOR_NOISE_ATOL,
                              ANCHOR_VI_ATOL, what="split vs single-program", phase="19d"))
        records["19d cheng2020-gmm single"], records["19d cheng2020-gmm split"] = rec, rec_split
        launches["19d cheng2020-gmm q3 single-program 4096x3072"] = rec["launches"]
        launches["19d cheng2020-gmm q3 split 4096x3072"] = rec_split["launches"]
        del res, single, gmm
        free_card()

    # (e) the CLI on a PNG, its defaults (`cond`) but for the steps
    with in_temp_dir("chip_smoke_mp_") as tmp:
        src = os.path.join(tmp, "megapixel.png")
        t = time.time()
        write_image(synthetic_image(h, w, seed=43), src)
        t_write = time.time() - t
        gdn.reset_launch_counts()
        _, out, seconds, peak = run_captured(cli_main, [
            "-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-s", src,
            "-steps", str(MP_CLI_STEPS), "--split_eval", "-device", "cuda"])
        n = gdn.launch_counts["gdn_fwd"]
    avg = [ln for ln in out.splitlines() if ln.startswith("AVG: ")]
    vals = dict(zip(*[iter(avg[0].split()[1:])] * 2)) if avg else {}
    records["19e cli --split_eval"] = {"s": seconds, "peak_gib": peak, "launches": n,
                                       "png_write_s": t_write, "avg": avg[0] if avg else None}
    log(f"phase 19e cli.attack_rd --split_eval {w}x{h} PNG, {MP_CLI_STEPS} steps (cond): "
        f"{seconds:.2f} s with the PNG read, peak {peak:.3f} GiB, GDN launches {n}; PNG written "
        f"in {t_write:.2f} s")
    if not avg or not all(math.isfinite(float(vals[k])) for k in ("vi", "bpp_ori", "bpp_adv")) \
            or n == 0:
        raise RuntimeError(f"phase 19e: no finite AVG line or no GDN launch: {avg}")
    launches["19e cli.attack_rd --split_eval 4096x3072"] = n

    # (f) the kernel against the plain GDN on the 12.6 MP split attack
    codec = load_codec("hyper", 1, CKPT)
    (k, lk), (p, _) = kernel_and_plain(gdn, codec, lambda: mp_attack(codec, MP_KVP_STEPS, True)(x))
    diff = (k["im_"] - p["im_"]).abs().flatten()
    far = int((diff > NOISE_ATOL).sum())
    q = torch.quantile(diff[torch.randperm(diff.numel(), device=diff.device)[:1 << 24]],
                       torch.tensor([0.5, 0.99, 0.9999], device=diff.device)).tolist()
    dvi = abs(k["vi"].item() - p["vi"].item())
    records["19f kernel vs plain"] = {
        "noise_max_abs": float(diff.max()), "far": far, "far_share": far / diff.numel(),
        "quantiles_50_99_9999": q, "vi_abs": dvi}
    log(f"phase 19f hyper q1 split {w}x{h} x{MP_KVP_STEPS}, kernel vs plain: max |noise diff| "
        f"{float(diff.max()):.3e}, {far} of {diff.numel()} elements more than {NOISE_ATOL} apart "
        f"(share {far / diff.numel():.2e}, tol {MP_FAR_SHARE}), median {q[0]:.2e}, 99% {q[1]:.2e}, "
        f"99.99% {q[2]:.2e}; vi {k['vi'].item():.6f} / {p['vi'].item():.6f} (tol {VI_ATOL})")
    if far > MP_FAR_SHARE * diff.numel() or dvi > VI_ATOL:
        raise RuntimeError("phase 19f: kernel vs plain differ beyond the tolerances")
    launches[f"19f split {w}x{h} x{MP_KVP_STEPS} kernel run"] = lk
    del k, p, codec, x
    free_card()

    # every (C, rows) the phase's runs gave the kernel, held to the plain GDN
    gen = torch.Generator(device="cuda").manual_seed(19)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    seen = sorted({tuple(p) for m in runs for p in m["gdn_shapes"]})
    shape_records = []
    for c, rows in seen:
        if (c, rows) not in GDN_SHAPES:
            shape_records += gdn_shape_records(gdn, c, rows, gen, flush_buf, phase="19")
    log(f"phase 19 GDN (C, rows): {seen}; held to the plain GDN in phase 3"
        + (f", and here: {[(r['C'], r['rows']) for r in shape_records[::2]]}" if shape_records
           else ""))
    log(f"phase 19 done in {time.time() - t0:.1f} s")
    return records, launches, launches_bwd, shape_records


def phase_orbax_resume(gdn):
    """Phase 20: the resume of the JAX trainer's committed orbax step
    (slice 11): (a) the port's reader, (b) ``cli.train`` with ORBAX_FLAGS
    in a temporary directory holding a copy of the step alone, (c) one
    resumed ``train_step`` with the kernel and with the plain GDN."""
    import copy
    import filecmp

    import torch

    from imagecompression_adversarial_tpu_torch.io import zstd
    from imagecompression_adversarial_tpu_torch.io.image import to_tensor
    from imagecompression_adversarial_tpu_torch.models.layers import GDN
    from imagecompression_adversarial_tpu_torch.train import (
        create_train_state, lambda_for, orbax, rate_distortion_loss, train_step,
    )
    from imagecompression_adversarial_tpu_torch.train.data import synthetic_batches
    from imagecompression_adversarial_tpu_torch.train.step import LR_AUX

    records, launches = {}, {}
    t = time.time()
    tree, nbytes = orbax.read_item(ORBAX_STEP)
    read_s = time.time() - t
    fp = orbax_fingerprint(tree)
    if fp != ORBAX_FINGERPRINT:
        raise RuntimeError(f"phase 20a: fingerprint {fp}, the CPU test pinned {ORBAX_FINGERPRINT}")
    records["20a"] = {"read_s": read_s, "bytes_read": nbytes, "libzstd": zstd.version(),
                      "fingerprint": fp}
    log(f"phase 20a orbax reader (OCDBT + zarr v2 + libzstd {zstd.version()}) on "
        f"{os.path.relpath(ORBAX_STEP, ROOT)}: {read_s:.3f} s, {nbytes} bytes read; every leaf's "
        f"path, shape and dtype and the exact float64 sums of params, mu, nu and count equal "
        f"the CPU test's (JAX's restore)")

    with in_temp_dir("chip_smoke_orbax_") as tmp:
        ckpt_dir = os.path.join(tmp, "ckpts", "adv", os.path.basename(os.path.dirname(ORBAX_STEP)))
        copied = os.path.join(ckpt_dir, str(ORBAX_STEP_NUMBER))
        shutil.copytree(ORBAX_STEP, copied)
        t = time.time()
        s, n, peak, out = train_cli(gdn, ORBAX_FLAGS, base=())
        run_s = time.time() - t
        line = f"resume training from epoch 1 (step {ORBAX_STEP_NUMBER})"
        left = sorted(os.listdir(ckpt_dir))
        want = [str(ORBAX_STEP_NUMBER), str(ORBAX_STEP_NUMBER + 1), "best_loss"]
        if line not in out or s["steps"] != ORBAX_STEP_NUMBER + 1 or left != want or \
                os.path.realpath(s["ckpt_dir"]) != os.path.realpath(ckpt_dir):
            raise RuntimeError(f"phase 20b: resume line printed {line in out}, {s['steps']} steps, "
                               f"{left} left in {s['ckpt_dir']}")
        files = [os.path.relpath(os.path.join(d, f), ORBAX_STEP)
                 for d, _, fs in os.walk(ORBAX_STEP) for f in fs]
        _, changed, missing = filecmp.cmpfiles(ORBAX_STEP, copied, files, shallow=False)
        if changed or missing:
            raise RuntimeError(f"phase 20b: the resumed step's files changed {changed + missing}")
        t = s["timing"]
        rec = {"steps": s["steps"], "run_s": run_s, "step_s": t["first_step_s"],
               "attack_steps_per_s": t["attack_steps"] / t["attack_s"],
               "attack_steps": t["attack_steps"], "eval_s": t["eval_s"],
               "eval_vi": s["best_loss"], "gdn_launches": n, "peak_gib": peak,
               "loss": s["loss"], "left": left}
        records["20b"] = rec
        launches["20 resume hyper q4 --adv"] = n
        log(f"phase 20b cli.train {' '.join(ORBAX_FLAGS)} on a copy of step "
            f"{ORBAX_STEP_NUMBER}: '{line}', the step to {s['steps']} in {t['first_step_s']:.2f} s "
            f"({1 / t['first_step_s']:.3f} steps/s; inner attack {rec['attack_steps_per_s']:.2f} "
            f"steps/s over {t['attack_steps']} steps), the final eval {t['eval_s']:.2f} s (vi "
            f"{s['best_loss']:.4f}), the whole run {run_s:.2f} s, loss {s['loss']:.4f}, gdn_fwd "
            f"launches {n}, peak memory {peak:.2f} GiB; left {left}, step "
            f"{ORBAX_STEP_NUMBER}'s files unchanged")

    codec = load_codec("hyper", 4).requires_grad_(True)
    payload = orbax.train_state_dict(tree, create_train_state(codec, TRAIN_LR), "hyper")
    lr, lmbda = float(tree["extra"]["lr"]), lambda_for("mse", 4)
    batch = to_tensor(next(synthetic_batches(8, 256, seed=0)), "cuda")

    def gdn_grads(model, x):
        """dgamma and dbeta of every GDN for the noise-quantized RD loss."""
        result = model(x, quant_mode="noise",
                       generator=torch.Generator(device="cuda").manual_seed(0))
        loss = rate_distortion_loss(result, x, lmbda, "mse")["loss"]
        params = [p for m in model.modules() if isinstance(m, GDN) for p in (m.gamma, m.beta)]
        return [g.detach() for g in torch.autograd.grad(loss, params)]

    def run():
        state = create_train_state(codec, lr)
        state.load_state_dict(copy.deepcopy(payload))
        grads = gdn_grads(codec, batch)
        gen = torch.Generator(device="cuda").manual_seed(42)
        step_loss = float(train_step(state, batch, gen, lr, lmbda)["loss"])
        return grads, step_loss, {k: v.detach().clone() for k, v in codec.state_dict().items()}

    (k, lk), (p, _) = kernel_and_plain(gdn, codec, run)
    rec = {"kernel_launches": lk, "lr": lr, "loss_rel": abs(k[1] - p[1]) / abs(p[1]),
           "grad_rel": max(float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(k[0], p[0]))}
    far = total = 0
    rec["param_max_abs"] = 0.0
    for name, a in k[2].items():
        step_lr = LR_AUX if name.endswith("quantiles") else lr
        diff = (a - p[2][name]).abs()
        rec["param_max_abs"] = max(rec["param_max_abs"], float(diff.max()))
        if float(diff.max()) > 2 * step_lr:
            raise RuntimeError(f"phase 20c: {name} {float(diff.max()):.3e} apart after one step")
        far += int((diff > step_lr / 10).sum())
        total += diff.numel()
    rec["far_share"] = far / total
    records["20c"] = rec
    log(f"phase 20c kernel vs plain GDN, one resumed step (lr {lr:g}), 8 x 256x256: loss rel "
        f"{rec['loss_rel']:.3e} (tol {TRAIN_LOSS_RTOL}), dgamma/dbeta max rel {rec['grad_rel']:.3e} "
        f"(tol {TRAIN_GRAD_REL}), params "
        f"max |diff| {rec['param_max_abs']:.3e} (tol "
        f"2 x lr), share > lr/10 {rec['far_share']:.2e} (tol {TRAIN_FAR_SHARE}), kernel "
        f"launches {lk}")
    if rec["loss_rel"] > TRAIN_LOSS_RTOL or rec["grad_rel"] > TRAIN_GRAD_REL or \
            rec["far_share"] > TRAIN_FAR_SHARE:
        raise RuntimeError(f"phase 20c: kernel vs plain resumed step differ beyond the tolerances: "
                           f"{json.dumps(rec)}")
    return records, launches


def cli_attack(phase: str, path: str, steps: int, *extra):
    """``cli.attack_rd``'s ``run`` on ``path`` (hyper q1 demo weights,
    ``select``, in the current directory) under ``measured``: (its AVG
    values, the measurement, the attacked image).  Raises on a non-finite
    result or a run that launched neither GDN kernel."""
    from imagecompression_adversarial_tpu_torch.cli import attack_rd as attack_cli
    from imagecompression_adversarial_tpu_torch.config import parse_config

    cfg = parse_config(["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-s", path,
                        "-steps", str(steps), "-two_phase", "select", "-device", "cuda", *extra])
    kept = []
    to_host = attack_cli.to_host

    def keep(res):
        kept.append(to_host(res))
        return kept[-1]

    attack_cli.to_host = keep
    try:
        avg, m = measured(lambda: attack_cli.run(cfg))
    finally:
        attack_cli.to_host = to_host
    if not all(math.isfinite(avg[k]) for k in ("vi", "bpp_ori", "bpp")) or \
            not m["launches"] or not m["bwd_launches"]:
        raise RuntimeError(f"phase {phase} attack on {path} {extra}: non-finite result or no "
                           f"GDN launch ({m['launches']}, {m['bwd_launches']})")
    return avg, m, kept[0]["im_"]


def phase_inputs(gdn, jpeg_build: dict, uneven: dict):
    """Phase 21: the JPEG decoder, a JPEG through the attack CLI and a JPEG
    folder through cli.train, -precision bfloat16 beside highest, and phase
    18's uneven row-sharded runs held to one process.  Returns the records
    and the forward and backward kernels' launches."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.io import jpeg
    from imagecompression_adversarial_tpu_torch.io.image import read_pixels, write_image
    from imagecompression_adversarial_tpu_torch.train.data import image_folder_batches

    records, launches, launches_bwd = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_inputs_")
    cwd = os.getcwd()
    try:
        # 21a: the two decoders on one textured file
        h, w = JPEG_SIZE
        data = jpeg.encode(textured_rgb(h, w, seed=5), JPEG_QUALITY)
        t = time.perf_counter()
        plain = jpeg.decode(data)
        plain_s = time.perf_counter() - t
        native_s = []
        for _ in range(JPEG_DECODE_RUNS):
            t = time.perf_counter()
            native = jpeg.decode_native(data)
            native_s.append(time.perf_counter() - t)
        equal = bool(np.array_equal(native, plain))
        host = host_cpu()
        records["21a"] = {"build": jpeg_build, "bytes": len(data), "equal": equal,
                          "numpy_s": plain_s, "c_s": min(native_s), "c_runs_s": native_s,
                          "host": host}
        log(f"phase 21a JPEG decoder: built in phase 2 ({jpeg_build['s']:.2f} s, "
            f"{jpeg_build['how']}); on the host ({host}), a textured {w}x{h} "
            f"q{JPEG_QUALITY} file of {len(data)} bytes: "
            f"C decoder {min(native_s) * 1e3:.2f} ms (best of {JPEG_DECODE_RUNS}: "
            f"{[round(v * 1e3, 2) for v in native_s]}), numpy plain version {plain_s * 1e3:.1f} "
            f"ms ({plain_s / min(native_s):.1f}x), pixels equal: {equal}")
        if not equal:
            raise RuntimeError("phase 21a: the C and numpy JPEG decoders differ")

        # 21b: the attack CLI on the JPEG and on a PNG of its pixels
        src, png = os.path.join(tmp, "textured.jpg"), os.path.join(tmp, "textured.png")
        with open(src, "wb") as f:
            f.write(data)
        write_image(native[None].astype(np.float32) / 255.0, png)
        if not (np.array_equal(read_pixels(src), native) and np.array_equal(read_pixels(png),
                                                                              native)):
            raise RuntimeError("phase 21b: the readers do not give the decoded pixels")
        os.chdir(tmp)
        try:
            attack = functools.partial(cli_attack, "21")
            with cudnn_deterministic():
                runs = {kind: attack(path, JPEG_ATTACK_STEPS) for kind, path in
                        (("jpeg", src), ("png", png))}
            (aj, mj, ij), (ap, mp_, ip) = runs["jpeg"], runs["png"]
            noise = float(np.abs(ij - ip).max())
            dvi = abs(aj["vi"] - ap["vi"])
            records["21b"] = {"steps_per_s": JPEG_ATTACK_STEPS / aj["t"],
                              "png_steps_per_s": JPEG_ATTACK_STEPS / ap["t"], "vi": aj["vi"],
                              "png_vi": ap["vi"], "noise_max_abs": noise,
                              "launches": mj["launches"], "bwd_launches": mj["bwd_launches"]}
            launches["21b attack_rd -s x.jpg"] = mj["launches"]
            launches_bwd["21b attack_rd -s x.jpg"] = mj["bwd_launches"]
            log(f"phase 21b cli.attack_rd -s textured.jpg, hyper q1, {JPEG_ATTACK_STEPS} steps "
                f"(cuDNN deterministic): {JPEG_ATTACK_STEPS / aj['t']:.2f} steps/s, vi "
                f"{aj['vi']:.6f}, bpp_ori {aj['bpp_ori']:.4f}, bpp {aj['bpp']:.4f}, gdn_fwd "
                f"launches {mj['launches']}, gdn_bwd launches {mj['bwd_launches']}; on a PNG of "
                f"its pixels {JPEG_ATTACK_STEPS / ap['t']:.2f} steps/s, vi {ap['vi']:.6f}: noise "
                f"max |diff| {noise:.3e} (tol {NOISE_ATOL}), vi diff {dvi:.3e} (tol {VI_ATOL})")
            if noise > NOISE_ATOL or dvi > VI_ATOL:
                raise RuntimeError("phase 21b: the JPEG and PNG attacks differ")

            # 21d: -precision bfloat16 (TF32) beside highest, cuDNN's defaults
            for turn, precision in enumerate(PRECISIONS):
                avg, m, _ = attack(png, PRECISION_STEPS, "-precision", precision)
                tf32 = torch.backends.cudnn.allow_tf32
                records[f"21d {turn} {precision}"] = {
                    "steps_per_s": PRECISION_STEPS / avg["t"], "vi": avg["vi"],
                    "bpp_ori": avg["bpp_ori"], "bpp": avg["bpp"], "tf32": tf32,
                    "launches": m["launches"]}
                launches[f"21d {turn} -precision {precision}"] = m["launches"]
                launches_bwd[f"21d {turn} -precision {precision}"] = m["bwd_launches"]
                log(f"phase 21d hyper q1 {w}x{h}, {PRECISION_STEPS} steps, -precision "
                    f"{precision} (TF32 {'on' if tf32 else 'off'}): "
                    f"{PRECISION_STEPS / avg['t']:.2f} steps/s, vi {avg['vi']:.6f}, bpp_ori "
                    f"{avg['bpp_ori']:.4f}, bpp {avg['bpp']:.4f}, gdn_fwd launches "
                    f"{m['launches']}")
                if tf32 != (precision == "bfloat16"):
                    raise RuntimeError(f"phase 21d: -precision {precision} left TF32 {tf32}")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        # 21c: training on a JPEG folder beside the same pixels as PNGs
        folders = {kind: os.path.join(tmp, f"train_{kind}") for kind in ("jpeg", "png")}
        for folder in folders.values():
            os.makedirs(folder)
        th, tw = JPEG_TRAIN_SIZE
        for i in range(JPEG_TRAIN_FILES):
            coded = jpeg.encode(textured_rgb(th, tw, seed=100 + i), JPEG_QUALITY)
            with open(os.path.join(folders["jpeg"], f"{i:03d}.jpg"), "wb") as f:
                f.write(coded)
            write_image(jpeg.decode_native(coded)[None].astype(np.float32) / 255.0,
                        os.path.join(folders["png"], f"{i:03d}.png"))
        decoded, per_batch = {}, {}
        for kind, folder in folders.items():
            it = image_folder_batches(folder, 8, 256, seed=0)
            t = time.perf_counter()
            decoded[kind] = [next(it) for _ in range(JPEG_DECODE_BATCHES)]
            per_batch[kind] = (time.perf_counter() - t) / JPEG_DECODE_BATCHES
            it.close()
        same = all(np.array_equal(a, b) for a, b in zip(decoded["jpeg"], decoded["png"]))
        if not same:
            raise RuntimeError("phase 21c: the JPEG folder's batches differ from the PNG one's")
        for kind, folder in folders.items():
            work = os.path.join(tmp, f"work_{kind}")
            os.makedirs(work)
            os.chdir(work)
            s, n, peak, _ = train_cli(gdn, ["-data", folder, "-max_steps", str(JPEG_TRAIN_STEPS)])
            t = s["timing"]
            records[f"21c {kind}"] = {
                "steps_per_s": t["steady_steps"] / t["steady_s"], "first_step_s":
                t["first_step_s"], "decode_s_per_batch": per_batch[kind], "launches": n,
                "bwd_launches": gdn.launch_counts["gdn_bwd"], "peak_gib": peak,
                "last_loss": s["last"]["loss"]}
            launches[f"21c cli.train -data {kind} x{JPEG_TRAIN_STEPS}"] = n
            launches_bwd[f"21c cli.train -data {kind} x{JPEG_TRAIN_STEPS}"] = \
                gdn.launch_counts["gdn_bwd"]
        rj, rp = records["21c jpeg"], records["21c png"]
        log(f"phase 21c cli.train -data, hyper q1, {JPEG_TRAIN_FILES} files of {tw}x{th}, "
            f"batches of 8 256x256 crops, {JPEG_TRAIN_STEPS} steps: JPEG folder "
            f"{rj['steps_per_s']:.2f} steps/s (steps 2-{JPEG_TRAIN_STEPS}), PNG folder "
            f"{rp['steps_per_s']:.2f}; the host's decode of a batch alone (8 threads, "
            f"{JPEG_DECODE_BATCHES} batches): JPEG {per_batch['jpeg'] * 1e3:.1f} ms, PNG "
            f"{per_batch['png'] * 1e3:.1f} ms, batches equal: {same}; last loss "
            f"{rj['last_loss']:.6f} / {rp['last_loss']:.6f}, gdn_fwd launches "
            f"{rj['launches']} / {rp['launches']}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    records.update(hold_uneven(uneven, launches))
    return records, launches, launches_bwd


def attack_beside_png(phase: str, src: str, tmp: str, records: dict, launches: dict,
                      launches_bwd: dict) -> dict:
    """``cli.attack_rd -s`` on the image file ``src`` and on a PNG of its
    pixels, in ``tmp`` (hyper q1 demo weights, JPEG_ATTACK_STEPS steps,
    cuDNN deterministic): records the rates, vi and noise gap under
    ``phase`` and the file's launches; raises unless the two runs agree
    at NOISE_ATOL and VI_ATOL.  Returns the file's measurement."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io.image import read_pixels, write_image

    name = os.path.basename(src)
    twin = os.path.join(tmp, "twin.png")
    write_image(read_pixels(src)[None].astype(np.float32) / 255.0, twin)
    os.chdir(tmp)
    with cudnn_deterministic():
        (af, mf, i_f), (ap, _, ip) = (cli_attack(phase[:2], path, JPEG_ATTACK_STEPS)
                                      for path in (src, twin))
    noise = float(np.abs(i_f - ip).max())
    dvi = abs(af["vi"] - ap["vi"])
    records[phase] = {"steps_per_s": JPEG_ATTACK_STEPS / af["t"],
                      "png_steps_per_s": JPEG_ATTACK_STEPS / ap["t"], "vi": af["vi"],
                      "png_vi": ap["vi"], "noise_max_abs": noise,
                      "launches": mf["launches"], "bwd_launches": mf["bwd_launches"]}
    label = f"{phase} attack_rd -s {name}"
    launches[label], launches_bwd[label] = mf["launches"], mf["bwd_launches"]
    log(f"phase {phase} cli.attack_rd -s {name}, hyper q1 768x512, {JPEG_ATTACK_STEPS} steps "
        f"(cuDNN deterministic): {JPEG_ATTACK_STEPS / af['t']:.2f} steps/s, vi "
        f"{af['vi']:.6f}, bpp_ori {af['bpp_ori']:.4f}, bpp {af['bpp']:.4f}, gdn_fwd launches "
        f"{mf['launches']}, gdn_bwd launches {mf['bwd_launches']}; on a PNG of its pixels "
        f"{JPEG_ATTACK_STEPS / ap['t']:.2f} steps/s, vi {ap['vi']:.6f}: noise max |diff| "
        f"{noise:.3e} (tol {NOISE_ATOL}), vi diff {dvi:.3e} (tol {VI_ATOL})")
    if noise > NOISE_ATOL or dvi > VI_ATOL:
        raise RuntimeError(f"phase {phase}: the {name} and PNG attacks differ")
    return mf


def load_make_inputs():
    """``tests/data/inputs/make_inputs.py`` as a module (its writers; it
    imports Pillow only inside the functions that write with it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_inputs", os.path.join(INPUTS_DIR, "make_inputs.py"))
    make_inputs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_inputs)
    return make_inputs


def phase_kinds(gdn, png_build: dict):
    """Phase 22: the image kinds of slice 16 (progressive and CMYK JPEGs,
    every PNG kind): both decoders on every committed file against
    Pillow's recorded pixels, a progressive JPEG through the attack CLI
    beside the PNG of its pixels, and cli.train on a folder of every kind.
    Returns the records and the forward and backward kernels' launches."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io import jpeg, png
    from imagecompression_adversarial_tpu_torch.io.image import read_pixels
    from imagecompression_adversarial_tpu_torch.train.data import (
        image_folder_batches, list_image_files)

    make_inputs = load_make_inputs()
    with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
        recorded = json.load(f)
    records, launches, launches_bwd = {}, {}, {}

    # 22a: every PNG and JPEG of slice 16 by both decoders, each held to Pillow's hash
    failed, plain_s = [], {}
    kinds = {name: rec for name, rec in recorded.items()
             if name.endswith((".png", ".jpg")) and not name.startswith(make_inputs.TAIL_FILES)}
    for name, rec in sorted(kinds.items()):
        path = os.path.join(INPUTS_DIR, name)
        with open(path, "rb") as f:
            data = f.read()
        native = read_pixels(path)
        t = time.perf_counter()
        plain = (jpeg if name.endswith(".jpg") else png).decode(data)
        plain_s[name] = time.perf_counter() - t
        plain = np.repeat(plain, 3, axis=2) if plain.shape[2] == 1 else plain
        digest = hashlib.sha256(np.ascontiguousarray(native).tobytes()).hexdigest()
        if digest != rec["sha256"] or not np.array_equal(native, plain):
            failed.append(f"{name} ({rec['mode']}: C {'=' if digest == rec['sha256'] else '!='} "
                          f"Pillow, numpy {'=' if np.array_equal(native, plain) else '!='} C)")
    with open(os.path.join(INPUTS_DIR, KINDS_TEXTURED), "rb") as f:
        textured = f.read()
    _, textured_c = best_of(jpeg.decode_native, textured)
    th, tw = JPEG_TRAIN_SIZE
    png_data = make_inputs.write_png(textured_rgb(th, tw, seed=7), 8, 2)
    png_c_out, png_c = best_of(png.decode_native, png_data)
    t = time.perf_counter()
    png_equal = bool(np.array_equal(png.decode(png_data), png_c_out))
    png_numpy = time.perf_counter() - t
    records["22a"] = {"build": png_build, "files": len(kinds), "failed": failed,
                      "numpy_s": plain_s, "textured_c_s": textured_c,
                      "textured_numpy_s": plain_s[KINDS_TEXTURED], "png_bytes": len(png_data),
                      "png_c_s": png_c, "png_numpy_s": png_numpy, "png_equal": png_equal,
                      "host": host_cpu()}
    log(f"phase 22a PNG decoder: built in phase 2 ({png_build['s']:.2f} s, {png_build['how']}); "
        f"{len(kinds) - len(failed)} of {len(kinds)} PNG and JPEG files of {INPUTS_DIR} decoded by "
        f"the C++ and numpy decoders to Pillow's recorded pixels ({', '.join(sorted({r['mode'] for r in kinds.values()}))}); "
        f"on the host ({records['22a']['host']}): the {KINDS_TEXTURED} (768x512 progressive "
        f"q90, {len(textured)} bytes) C {textured_c * 1e3:.2f} ms (best of {JPEG_DECODE_RUNS}), "
        f"numpy {plain_s[KINDS_TEXTURED] * 1e3:.1f} ms; a {tw}x{th} RGB PNG ({len(png_data)} "
        f"bytes, Paeth rows) C {png_c * 1e3:.2f} ms, numpy {png_numpy * 1e3:.1f} ms "
        f"({png_numpy / png_c:.1f}x), equal: {png_equal}")
    if failed or not png_equal:
        raise RuntimeError(f"phase 22a: decoders differ from Pillow's pixels or each other: "
                           f"{failed}, PNG equal {png_equal}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kinds_")
    cwd = os.getcwd()
    try:
        # 22b: the attack CLI on the progressive file and on a PNG of its pixels
        attack_beside_png("22b", os.path.join(INPUTS_DIR, KINDS_TEXTURED), tmp, records, launches,
                          launches_bwd)

        # 22c: cli.train on a folder of every file
        folder = os.path.join(tmp, "train_kinds")
        os.makedirs(folder)
        for name in recorded:
            shutil.copy(os.path.join(INPUTS_DIR, name), folder)
        it = image_folder_batches(folder, 8, 256, seed=0)
        t = time.perf_counter()
        batch = next(it)
        decode_s = time.perf_counter() - t
        it.close()
        if batch.shape != (8, 256, 256, 3) or not np.isfinite(batch).all():
            raise RuntimeError(f"phase 22c: the folder's batch is {batch.shape}")
        work = os.path.join(tmp, "work")
        os.makedirs(work)
        os.chdir(work)
        s, n, peak, _ = train_cli(gdn, ["-data", folder, "-max_steps", str(KINDS_TRAIN_STEPS)])
        timing = s["timing"]
        records["22c"] = {"steps_per_s": timing["steady_steps"] / timing["steady_s"],
                          "first_step_s": timing["first_step_s"], "decode_s_per_epoch": decode_s,
                          "launches": n, "bwd_launches": gdn.launch_counts["gdn_bwd"],
                          "peak_gib": peak, "last_loss": s["last"]["loss"]}
        label = f"22c cli.train -data kinds x{KINDS_TRAIN_STEPS}"
        launches[label], launches_bwd[label] = n, gdn.launch_counts["gdn_bwd"]
        listed = list_image_files(folder)
        records["22c"]["files"] = len(listed)
        log(f"phase 22c cli.train -data on the {len(listed)} files of every kind the stream lists "
            f"(of {len(recorded)}: {sum(f.endswith('.webp') for f in listed)} WebPs, "
            f"{sum(f.endswith('.bmp') for f in listed)} BMPs, slice 18's "
            f"{sum(os.path.basename(f).startswith(make_inputs.TAIL_FILES) for f in listed)} among "
            f"them; batches of 8 256x256 crops, one a file an epoch), {KINDS_TRAIN_STEPS} steps: "
            f"{records['22c']['steps_per_s']:.2f} steps/s (steps 2-{KINDS_TRAIN_STEPS}), first "
            f"step {timing['first_step_s']:.2f} s; the host's decode of an epoch's batch alone "
            f"{decode_s * 1e3:.1f} ms; last loss {s['last']['loss']:.6f}, gdn_fwd launches {n}, "
            f"gdn_bwd launches {gdn.launch_counts['gdn_bwd']}, peak {peak:.3f} GiB")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def phase_webp(webp_build: dict):
    """Phase 23: the WebP decoder on every committed WebP against Pillow's
    recorded pixels, the two 768x512 files timed, and a WebP through the
    attack CLI beside the PNG of its pixels.  Returns the records and the
    forward and backward kernels' launches."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io import webp

    tail = load_make_inputs().TAIL_FILES
    with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
        recorded = {n: r for n, r in json.load(f).items()
                    if n.endswith(".webp") and not n.startswith(tail)}
    records, launches, launches_bwd = {}, {}, {}

    # 23a: every still WebP held to Pillow's hash and mode; the 768x512 pair timed
    failed, timed, kinds = [], {}, []
    for name, rec in sorted(recorded.items()):
        with open(os.path.join(INPUTS_DIR, name), "rb") as f:
            data = f.read()
        parsed = webp.parse(data)
        pixels = webp.decode_webp_native(parsed)
        digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
        kinds.append(f"{name} ({'VP8L' if parsed.lossless else 'VP8'}, {parsed.mode})")
        if digest != rec["sha256"] or parsed.mode != rec["mode"] or \
                list(pixels.shape) != rec["shape"]:
            failed.append(f"{name} (sha256 {'=' if digest == rec['sha256'] else '!='}, mode "
                          f"{parsed.mode} / {rec['mode']})")
        if name in (WEBP_TEXTURED, WEBP_LOSSLESS):
            times = []
            for _ in range(JPEG_DECODE_RUNS):
                t = time.perf_counter()
                webp.decode_native(data)
                times.append(time.perf_counter() - t)
            timed[name] = {"bytes": len(data), "best_s": min(times), "runs_s": times}
    host = host_cpu()
    records["23a"] = {"build": webp_build, "files": len(recorded), "failed": failed,
                      "timed": timed, "host": host,
                      "libwebp": sorted({r.get("libwebp") for r in recorded.values()})}
    log(f"phase 23a WebP decoder: built in phase 2 ({webp_build['s']:.2f} s, "
        f"{webp_build['how']}); {len(recorded) - len(failed)} of {len(recorded)} WebPs of "
        f"{INPUTS_DIR} decoded to the pixels and mode recorded for Pillow "
        f"{sorted({r['pillow'] for r in recorded.values()})} (libwebp "
        f"{records['23a']['libwebp']}): {', '.join(kinds)}; on the host ({host}), best of "
        f"{JPEG_DECODE_RUNS}: " + ", ".join(
            f"{n} ({t['bytes']} bytes) {t['best_s'] * 1e3:.2f} ms "
            f"{[round(v * 1e3, 2) for v in t['runs_s']]}" for n, t in sorted(timed.items())))
    if failed or len(timed) != 2:
        raise RuntimeError(f"phase 23a: WebPs differ from Pillow's recorded pixels: {failed}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_webp_")
    cwd = os.getcwd()
    try:
        # 23b: the attack CLI on the lossy WebP and on a PNG of its pixels
        attack_beside_png("23b", os.path.join(INPUTS_DIR, WEBP_TEXTURED), tmp, records, launches,
                          launches_bwd)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def best_of(fn, data):
    """(``fn(data)``, its best seconds of JPEG_DECODE_RUNS calls)."""
    times = []
    for _ in range(JPEG_DECODE_RUNS):
        t = time.perf_counter()
        out = fn(data)
        times.append(time.perf_counter() - t)
    return out, min(times)


def tiff_rgb(rgb) -> bytes:
    """An uncompressed little-endian TIFF of (H, W, 3) uint8 pixels: one
    strip, the nine fields a baseline RGB reader needs (a SHORT value sits
    in the low bytes of its 4-byte slot, as a LONG's would)."""
    import struct

    h, w, _ = rgb.shape
    bits_at = 8 + 2 + 12 * 9 + 4  # after the header and the IFD: BitsPerSample's 8, 8, 8
    fields = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, bits_at), (259, 3, 1, 1),
              (262, 3, 1, 2), (273, 4, 1, bits_at + 6), (277, 3, 1, 3), (278, 4, 1, h),
              (279, 4, 1, rgb.size)]
    return (b"II*\0" + struct.pack("<IH", 8, len(fields))
            + b"".join(struct.pack("<HHII", *f) for f in fields) + bytes(4)
            + struct.pack("<HHH", 8, 8, 8) + rgb.tobytes())


def phase_tail(tiff_build: dict, gif_build: dict):
    """Phase 24: the decoders of slice 18 on every slice-18 file against
    Pillow's recorded pixels, the 768x512 TIFFs timed, and a TIFF through
    the attack CLI beside the PNG of its pixels.  Returns the records and
    the forward and backward kernels' launches."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io import bmp, gif, jpeg, tiff, webp

    make_inputs = load_make_inputs()
    with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
        recorded = {n: r for n, r in json.load(f).items() if n.startswith(make_inputs.TAIL_FILES)}
    records, launches, launches_bwd = {}, {}, {}

    def decode(name: str, data: bytes):
        """(pixels, Pillow's mode) by the reader of the file's format."""
        if name.endswith(".tif"):
            t = tiff.parse(data)
            return tiff.decode_tiff_native(t), t.mode
        if name.endswith(".gif"):
            g = gif.parse(data)
            return gif.decode_gif_native(g), g.mode
        if name.endswith(".webp"):
            w = webp.parse(data)
            return webp.decode_webp_native(w), w.mode
        if name.endswith(".bmp"):
            return bmp.decode(data)
        f = jpeg.parse(data)
        return jpeg.decode_frame_native(f), f.mode

    # 24a: every slice-18 file held to Pillow's hash and mode; the 768x512 TIFFs timed
    failed, kinds, numpy_equal = [], [], {}
    for name, rec in sorted(recorded.items()):
        with open(os.path.join(INPUTS_DIR, name), "rb") as f:
            data = f.read()
        pixels, mode = decode(name, data)
        digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
        kinds.append(f"{name} ({mode})")
        if name.endswith(".jpg"):
            numpy_equal[name] = bool(np.array_equal(jpeg.decode(data), pixels))
        if digest != rec["sha256"] or mode != rec["mode"] or list(pixels.shape) != rec["shape"] \
                or not numpy_equal.get(name, True):
            failed.append(f"{name} (sha256 {'=' if digest == rec['sha256'] else '!='}, mode "
                          f"{mode} / {rec['mode']}, numpy {numpy_equal.get(name)})")
    rgb = textured_rgb(*JPEG_SIZE, seed=5)
    raw = tiff_rgb(rgb)
    timed = {}
    with open(os.path.join(INPUTS_DIR, TAIL_TEXTURED), "rb") as f:
        lzw = f.read()
    for label, data in ((TAIL_TEXTURED, lzw), ("textured_raw.tif", raw)):
        out, best = best_of(tiff.decode_native, data)
        timed[label] = {"bytes": len(data), "best_s": best}
        if label == "textured_raw.tif" and not np.array_equal(out, rgb):
            failed.append("textured_raw.tif (not the pixels written)")
    host = host_cpu()
    records["24a"] = {"builds": {"tiff": tiff_build, "gif": gif_build}, "files": len(recorded),
                      "failed": failed, "timed": timed, "jpeg_numpy_equal": numpy_equal,
                      "host": host}
    log(f"phase 24a TIFF and GIF decoders: built in phase 2 (tiff.cc {tiff_build['s']:.2f} s, "
        f"{tiff_build['how']}; gif.cc {gif_build['s']:.2f} s, {gif_build['how']}); "
        f"{len(recorded) - len(failed)} of {len(recorded)} slice-18 files of {INPUTS_DIR} decoded "
        f"to the pixels and mode recorded for Pillow {sorted({r['pillow'] for r in recorded.values()})} "
        f"({sum(numpy_equal.values())} of {len(numpy_equal)} JPEGs equal to the numpy decoder): "
        f"{', '.join(kinds)}; on the host ({host}), best of {JPEG_DECODE_RUNS}: " + ", ".join(
            f"{n} ({t['bytes']} bytes) {t['best_s'] * 1e3:.2f} ms" for n, t in sorted(timed.items())))
    if failed or len(recorded) < 20:
        raise RuntimeError(f"phase 24a: files differ from Pillow's recorded pixels: {failed}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tail_")
    cwd = os.getcwd()
    try:
        # 24b: the attack CLI on the uncompressed TIFF and on a PNG of its pixels
        src = os.path.join(tmp, "textured.tif")
        with open(src, "wb") as f:
            f.write(raw)
        m = attack_beside_png("24b", src, tmp, records, launches, launches_bwd)
        if (m["launches"], m["bwd_launches"]) != TAIL_LAUNCHES:
            raise RuntimeError(f"phase 24b: GDN launches {(m['launches'], m['bwd_launches'])}, "
                               f"not {TAIL_LAUNCHES}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def phase_codecs(tiff_build: dict):
    """Phase 25: the TIFF codecs, colour spaces and sample layouts of slice
    19 on every committed file against Pillow's recorded pixels, the JPEG
    strips against the numpy decoder and the CCITT files against the plain
    fax decoder, two 768x512 TIFFs timed, and the JPEG TIFF through the
    attack CLI beside the PNG of its pixels.  Returns the records and the
    forward and backward kernels' launches."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io import fax, jpeg, tiff

    make_inputs = load_make_inputs()
    with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
        recorded = {n: r for n, r in json.load(f).items() if n.startswith(make_inputs.CODEC_FILES)}
    records, launches, launches_bwd = {}, {}, {}

    # 25a: every file held to Pillow's hash and mode, JPEG strips to numpy,
    # CCITT to the plain fax decoder; the two 768x512 TIFFs timed
    failed, kinds, plain_equal = [], [], {}
    for name, rec in sorted(recorded.items()):
        with open(os.path.join(INPUTS_DIR, name), "rb") as f:
            t = tiff.parse(f.read())
        pixels = tiff.decode_tiff_native(t)
        digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
        kinds.append(f"{name} ({t.mode})")
        if t.compression == 7:
            plain_equal[name] = all(np.array_equal(jpeg.decode_frame_native(fr), jpeg.decode_frame(fr))
                                    for fr in tiff.jpeg_frames(t))
        elif t.compression in (2, 3, 4):
            samples, outcome = tiff.fax_samples(t)
            plain_equal[name] = outcome == fax.OK and np.array_equal(samples, tiff.decode_samples(t))
        if digest != rec["sha256"] or t.mode != rec["mode"] or list(pixels.shape) != rec["shape"] \
                or not plain_equal.get(name, True):
            failed.append(f"{name} (sha256 {'=' if digest == rec['sha256'] else '!='}, mode "
                          f"{t.mode} / {rec['mode']}, plain {plain_equal.get(name)})")
    rgb = textured_rgb(*JPEG_SIZE, seed=5)
    zstd_tiff = make_inputs.write_tiff(rgb.astype(np.int64), 8, 2, compression=50000,
                                       predictor=2, rows_per_strip=16)
    with open(os.path.join(INPUTS_DIR, CODEC_TEXTURED), "rb") as f:
        jpeg_tiff = f.read()
    timed = {}
    for label, data in ((CODEC_TEXTURED, jpeg_tiff), ("textured_zstd.tif", zstd_tiff)):
        out, best = best_of(tiff.decode_native, data)
        timed[label] = {"bytes": len(data), "best_s": best}
        if label == "textured_zstd.tif" and not np.array_equal(out, rgb):
            failed.append("textured_zstd.tif (not the pixels written)")
    host = host_cpu()
    records["25a"] = {"build": tiff_build, "files": len(recorded), "failed": failed,
                      "timed": timed, "plain_equal": plain_equal, "host": host}
    log(f"phase 25a TIFF codecs: decoder built in phase 2 ({tiff_build['s']:.2f} s, "
        f"{tiff_build['how']}); {len(recorded) - len(failed)} of {len(recorded)} files of "
        f"{INPUTS_DIR} decoded to the pixels and mode recorded for Pillow "
        f"{sorted({r['pillow'] for r in recorded.values()})} ({sum(plain_equal.values())} of "
        f"{len(plain_equal)} JPEG and CCITT files equal to the plain decoders): "
        f"{', '.join(kinds)}; on the host ({host}), best of {JPEG_DECODE_RUNS}: " + ", ".join(
            f"{n} ({t['bytes']} bytes) {t['best_s'] * 1e3:.2f} ms" for n, t in sorted(timed.items())))
    if failed or len(recorded) < 21:
        raise RuntimeError(f"phase 25a: files differ from Pillow's recorded pixels: {failed}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_codecs_")
    cwd = os.getcwd()
    try:
        # 25b: the attack CLI on the YCbCr JPEG TIFF and on a PNG of its pixels
        m = attack_beside_png("25b", os.path.join(INPUTS_DIR, CODEC_TEXTURED), tmp, records,
                              launches, launches_bwd)
        if (m["launches"], m["bwd_launches"]) != CODEC_LAUNCHES:
            raise RuntimeError(f"phase 25b: GDN launches {(m['launches'], m['bwd_launches'])}, "
                               f"not {CODEC_LAUNCHES}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def phase_slice20(gdn, jpeg_build: dict, card: str, attack_rate: float):
    """Phase 26: the pieces of slice 20.  (a) The forward-only phase loop
    (``attacks/common.py::make_phase_fwd_scan``) with the GDN kernel, its
    rate beside phase 4's attack rate, and against the plain GDN; (b) the
    demo-checkpoint exporter on the orbax step and on a port-trained
    ``checkpoint.pt``; (c) the Netpbm, lossless and arithmetic-coded JPEG
    files against Pillow's recorded pixels and the numpy decoder; (d) the
    attack CLI on the arithmetic-coded 768x512 JPEG beside the PNG of its
    pixels.  Returns the records and the forward and backward kernels'
    launches."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks.common import make_phase_fwd_scan
    from imagecompression_adversarial_tpu_torch.cli import export_ckpt
    from imagecompression_adversarial_tpu_torch.io import jpeg, netpbm
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint

    records, launches, launches_bwd = {}, {}, {}

    # 26a: the loop, FWD_SCAN_STEPS steps with the kernel, then the kernel and
    # the plain GDN over FWD_SCAN_CHECK_STEPS steps, cuDNN deterministic
    codec = load_codec("hyper", 1, CKPT)
    x = to_tensor(synthetic_image(*JPEG_SIZE, seed=0), "cuda")
    make_phase_fwd_scan(codec, 3)(x)  # cuDNN's algorithm choice and the allocator's pools
    n, m = measured(lambda: make_phase_fwd_scan(codec, FWD_SCAN_STEPS)(x))
    rate = FWD_SCAN_STEPS / m["s"]
    with cudnn_deterministic():
        n_kernel, mk = measured(lambda: make_phase_fwd_scan(codec, FWD_SCAN_CHECK_STEPS)(x))
        use_gdn_kernel(codec, False)
        try:
            n_plain, mp = measured(lambda: make_phase_fwd_scan(codec, FWD_SCAN_CHECK_STEPS)(x))
        finally:
            use_gdn_kernel(codec, True)
    values = {label: float(v.flatten()[0]) for label, v in (("n", n), ("kernel", n_kernel),
                                                            ("plain", n_plain))}
    uniform = all(bool((v == v.flatten()[0]).all()) for v in (n, n_kernel, n_plain))
    gap = abs(values["kernel"] - values["plain"])
    bound = FWD_SCAN_RTOL * abs(values["plain"]) + FWD_SCAN_ATOL
    ratio = attack_rate / rate
    records["26a"] = {"steps": FWD_SCAN_STEPS, "steps_per_s": rate, "s": m["s"],
                      "launches": m["launches"], "peak_gib": m["peak_gib"], "n": values["n"],
                      "check_steps": FWD_SCAN_CHECK_STEPS, "n_kernel": values["kernel"],
                      "n_plain": values["plain"], "gap": gap, "bound": bound,
                      "check_launches": [mk["launches"], mp["launches"]],
                      "attack_steps_per_s": attack_rate, "attack_over_fwd": ratio, "card": card}
    launches[f"26a fwd_scan hyper q1 768x512 x{FWD_SCAN_STEPS}"] = m["launches"]
    launches[f"26a fwd_scan kernel x{FWD_SCAN_CHECK_STEPS}"] = mk["launches"]
    log(f"phase 26a forward-only phase loop (make_phase_fwd_scan), hyper q1 768x512, "
        f"{FWD_SCAN_STEPS} steps: {rate:.2f} steps/s ({m['s']:.3f} s), gdn_fwd launches "
        f"{m['launches']} (expect {GDN_PER_FWD_STEP * FWD_SCAN_STEPS}), gdn_bwd "
        f"{m['bwd_launches']}, peak {m['peak_gib']:.3f} GiB, n {values['n']:.9e}; phase 4's "
        f"attack {attack_rate:.2f} steps/s, {ratio:.4f} of this rate (tol < "
        f"{FWD_SCAN_MAX_RATIO}); {FWD_SCAN_CHECK_STEPS} steps, cuDNN deterministic: kernel n "
        f"{values['kernel']:.9e} ({mk['launches']} launches), plain GDN n {values['plain']:.9e} "
        f"({mp['launches']} launches): |diff| {gap:.3e} (tol {bound:.3e}); on {card}")
    if m["launches"] != GDN_PER_FWD_STEP * FWD_SCAN_STEPS or m["bwd_launches"] or \
            mk["launches"] != GDN_PER_FWD_STEP * FWD_SCAN_CHECK_STEPS or mp["launches"]:
        raise RuntimeError(f"phase 26a: GDN launches {m['launches']}, {m['bwd_launches']}, "
                           f"{mk['launches']}, {mp['launches']}")
    if not uniform or not all(math.isfinite(v) for v in values.values()) or gap > bound or \
            ratio >= FWD_SCAN_MAX_RATIO:
        raise RuntimeError(f"phase 26a: the loop's noise or rate is off: {records['26a']}")
    del codec, x, n, n_kernel, n_plain
    free_card()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice20_")
    cwd = os.getcwd()
    try:
        # 26b: the exporter on the orbax step, and on a 2-step cli.train run
        out = os.path.join(tmp, "step2000.msgpack")
        t = time.time()
        line = export_ckpt.export(ORBAX_STEP, "hyper", 4, out)
        export_s = time.time() - t
        with open(out, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        os.chdir(tmp)
        s, n_train, _, _ = train_cli(gdn, ["-max_steps", str(EXPORT_TRAIN_STEPS)])
        launches[f"26b cli.train x{EXPORT_TRAIN_STEPS}"] = n_train
        launches_bwd[f"26b cli.train x{EXPORT_TRAIN_STEPS}"] = gdn.launch_counts["gdn_bwd"]
        step = os.path.join(s["ckpt_dir"], str(EXPORT_TRAIN_STEPS))
        trained = {k: v.detach() for k, v in s["state"].model.state_dict().items()}
        xs = to_tensor(synthetic_image(*JPEG_SIZE, seed=1), "cuda")

        def x_hat(params):
            c = load_codec("hyper", 1)
            c.load_state_dict(params, strict=True)
            with torch.no_grad(), cudnn_deterministic():
                return c(xs, quant_mode="dequantize")["x_hat"]

        want = x_hat(trained)
        exported = {}
        for fp32 in (True, False):
            path = os.path.join(tmp, f"trained-{'fp32' if fp32 else 'fp16'}.msgpack")
            said = export_ckpt.export(step, "hyper", 1, path, fp32=fp32)
            params = {k: v.to(want.device) for k, v in load_checkpoint(path, "hyper").items()}
            rounded = all(torch.equal(params[k], v if fp32 else v.half().float())
                          for k, v in trained.items())
            diff = float((x_hat(params) - want).abs().max())
            exported["fp32" if fp32 else "fp16"] = {
                "line": said, "bytes": os.path.getsize(path), "params_equal": rounded,
                "x_hat_max_abs": diff}
        records["26b"] = {"step2000": {"line": line, "sha256": digest, "s": export_s},
                          "trained": exported, "train_steps": EXPORT_TRAIN_STEPS}
        log(f"phase 26b cli.export_ckpt: {line} in {export_s:.2f} s, sha256 {digest} (expect "
            f"{EXPORT_SHA256}); a {EXPORT_TRAIN_STEPS}-step cli.train run's checkpoint.pt: "
            + "; ".join(f"{k}: {v['line']}, parameters "
                        f"{'equal' if k == 'fp32' else 'the fp16 rounding'}: {v['params_equal']}, "
                        f"x_hat max |diff| {v['x_hat_max_abs']:.3e}" for k, v in exported.items()))
        if digest != EXPORT_SHA256 or not all(v["params_equal"] for v in exported.values()) or \
                exported["fp32"]["x_hat_max_abs"] != 0.0:
            raise RuntimeError(f"phase 26b: the exports differ: {records['26b']}")
        del want, trained, s
        free_card()

        # 26c: every slice-20 file held to Pillow's hash and mode, the JPEGs to
        # the numpy decoder; the 768x512 arithmetic-coded JPEG timed
        make_inputs = load_make_inputs()
        with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
            recorded = {k: r for k, r in json.load(f).items()
                        if k.startswith(make_inputs.SLICE20_FILES)}
        failed, kinds, numpy_equal = [], [], {}
        for name, rec in sorted(recorded.items()):
            with open(os.path.join(INPUTS_DIR, name), "rb") as f:
                data = f.read()
            if name.endswith(".jpg"):
                fr = jpeg.parse(data)
                pixels, mode = jpeg.decode_frame_native(fr), fr.mode
                numpy_equal[name] = bool(np.array_equal(jpeg.decode_frame(fr), pixels))
                if pixels.shape[2] == 1:
                    pixels = np.repeat(pixels, 3, axis=2)
            else:
                pixels, mode = netpbm.decode(data)
            digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
            kinds.append(f"{name} ({mode})")
            if digest != rec["sha256"] or mode != rec["mode"] or \
                    list(pixels.shape) != rec["shape"] or not numpy_equal.get(name, True):
                failed.append(f"{name} (sha256 {'=' if digest == rec['sha256'] else '!='}, mode "
                              f"{mode} / {rec['mode']}, numpy {numpy_equal.get(name)})")
        with open(os.path.join(INPUTS_DIR, SLICE20_TEXTURED), "rb") as f:
            arith = f.read()
        _, best = best_of(jpeg.decode_native, arith)
        t = time.time()
        jpeg.decode(arith)
        plain_s = time.time() - t
        host = host_cpu()
        records["26c"] = {"files": len(recorded), "failed": failed, "numpy_equal": numpy_equal,
                          "timed": {SLICE20_TEXTURED: {"bytes": len(arith), "best_s": best,
                                                       "numpy_s": plain_s}},
                          "build": jpeg_build, "host": host}
        log(f"phase 26c Netpbm, lossless and arithmetic-coded JPEGs: {len(recorded) - len(failed)} "
            f"of {len(recorded)} files of {INPUTS_DIR} decoded to the pixels and mode recorded for "
            f"Pillow {sorted({r['pillow'] for r in recorded.values()})} "
            f"({sum(numpy_equal.values())} of {len(numpy_equal)} JPEGs equal to the numpy "
            f"decoder): {', '.join(kinds)}; {SLICE20_TEXTURED} ({len(arith)} bytes) on the host "
            f"({host}): C++ {best * 1e3:.2f} ms (best of {JPEG_DECODE_RUNS}; the decoder built in "
            f"phase 2, {jpeg_build['how']}), numpy {plain_s * 1e3:.1f} ms")
        if failed or len(recorded) < 27:
            raise RuntimeError(f"phase 26c: files differ from Pillow's recorded pixels: {failed}")

        # 26d: the attack CLI on the arithmetic-coded JPEG and on a PNG of its pixels
        m = attack_beside_png("26d", os.path.join(INPUTS_DIR, SLICE20_TEXTURED), tmp, records,
                              launches, launches_bwd)
        if (m["launches"], m["bwd_launches"]) != SLICE20_LAUNCHES:
            raise RuntimeError(f"phase 26d: GDN launches {(m['launches'], m['bwd_launches'])}, "
                               f"not {SLICE20_LAUNCHES}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


# the child of phase 27c: the stream read by a slow consumer, then closed
WINDOW_CHILD = """
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
from imagecompression_adversarial_tpu_torch.train.data import image_folder_batches

def status():
    with open("/proc/self/status") as f:
        return {k: int(v.split()[0]) * 1024 for k, v in (ln.split(":", 1) for ln in f if ":" in ln)
                if k in ("VmRSS", "VmHWM")}

# VmRSS sampled every 2 ms while the stream runs: the high-water mark where
# /proc has no VmHWM
peak, done = [0], threading.Event()

def sample():
    while not done.is_set():
        peak[0] = max(peak[0], status()["VmRSS"])
        time.sleep(0.002)

before = status()
sampler = threading.Thread(target=sample)
sampler.start()
stream = image_folder_batches(sys.argv[2], 8, crop=256, seed=0)
t = time.perf_counter()
for _ in range(int(sys.argv[3])):
    next(stream)
    time.sleep(float(sys.argv[4]))
taken = time.perf_counter() - t
t = time.perf_counter()
stream.close()
close_s = time.perf_counter() - t
done.set()
sampler.join()
after = status()
hwm = after.get("VmHWM", peak[0])
print(json.dumps({"rss_before": before["VmRSS"], "hwm_after": max(hwm, peak[0]),
                  "source": "VmHWM" if "VmHWM" in after else "VmRSS every 2 ms",
                  "hwm_before": before.get("VmHWM"), "rss_after": after["VmRSS"],
                  "stream_s": taken, "close_s": close_s}))
"""


def phase_slice21(j2k_build: dict, card: str):
    """Phase 27: the pieces of slice 21.  (a) The JPEG 2000 decoder on every
    committed JPEG 2000 file against Pillow's recorded pixels, the 768x512
    9/7 and 5/3 files timed; (b) the attack CLI on the 9/7 file beside the
    PNG of its pixels; (c) the training stream's decode window on a
    Vimeo-sized folder: a slow consumer's memory and its close, in a child
    without CUDA, and cli.train -data on it in another child.  Returns the
    records and the forward and backward kernels' launches."""
    import numpy as np

    from imagecompression_adversarial_tpu_torch.io import jpeg2000, png

    records, launches, launches_bwd = {}, {}, {}

    # 27a: every JPEG 2000 file held to Pillow's hash and mode; the pair timed
    with open(os.path.join(INPUTS_DIR, "inputs.json")) as f:
        recorded = {n: r for n, r in json.load(f).items() if n.endswith((".jp2", ".j2k"))}
    failed, kinds, timed = [], [], {}
    for name, rec in sorted(recorded.items()):
        with open(os.path.join(INPUTS_DIR, name), "rb") as f:
            data = f.read()
        pixels, mode = jpeg2000.decode_native(data)
        digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
        kinds.append(f"{name} ({mode})")
        if digest != rec["sha256"] or mode != rec["mode"] or list(pixels.shape) != rec["shape"]:
            failed.append(f"{name} (sha256 {'=' if digest == rec['sha256'] else '!='}, mode "
                          f"{mode} / {rec['mode']})")
        if name in (J2K_TEXTURED, J2K_LOSSLESS):
            _, best = best_of(jpeg2000.decode_native, data)
            timed[name] = {"bytes": len(data), "best_s": best}
    cut = open(os.path.join(INPUTS_DIR, J2K_TEXTURED), "rb").read()[:-2]
    try:
        jpeg2000.decode_native(cut)
        cut_raises = False
    except ValueError:
        cut_raises = True
    host = host_cpu()
    records["27a"] = {"build": j2k_build, "files": len(recorded), "failed": failed,
                      "timed": timed, "cut_raises": cut_raises, "host": host, "card": card}
    log(f"phase 27a JPEG 2000 decoder: built in phase 2 ({j2k_build['s']:.2f} s, "
        f"{j2k_build['how']}); {len(recorded) - len(failed)} of {len(recorded)} files of "
        f"{INPUTS_DIR} decoded to the pixels and mode recorded for Pillow "
        f"{sorted({r['pillow'] for r in recorded.values()})}: {', '.join(kinds)}; a codestream "
        f"without its EOC raises: {cut_raises}; on the host ({host}), best of "
        f"{JPEG_DECODE_RUNS}: " + ", ".join(f"{n} ({t['bytes']} bytes) {t['best_s'] * 1e3:.2f} ms"
                                            for n, t in sorted(timed.items())))
    if failed or len(timed) != 2 or len(recorded) < 38 or not cut_raises:
        raise RuntimeError(f"phase 27a: JPEG 2000 files differ from Pillow's: {records['27a']}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice21_")
    cwd = os.getcwd()
    try:
        # 27b: the attack CLI on the 9/7 file and on a PNG of its pixels
        m = attack_beside_png("27b", os.path.join(INPUTS_DIR, J2K_TEXTURED), tmp, records,
                              launches, launches_bwd)
        if (m["launches"], m["bwd_launches"]) != J2K_LAUNCHES:
            raise RuntimeError(f"phase 27b: GDN launches {(m['launches'], m['bwd_launches'])}, "
                               f"not {J2K_LAUNCHES}")

        # 27c: the decode window on a Vimeo-sized folder
        folder = os.path.join(tmp, "vimeo")
        os.makedirs(folder)
        t = time.time()
        firsts = []
        for i in range(WINDOW_FILES):
            path = os.path.join(folder, f"{i:05d}.png")
            if i < WINDOW_DISTINCT:
                with open(path, "wb") as f:
                    f.write(png.encode(textured_rgb(*JPEG_TRAIN_SIZE, seed=100 + i)))
                firsts.append(path)
            else:
                shutil.copyfile(firsts[i % WINDOW_DISTINCT], path)
        write_s = time.time() - t
        folder_bytes = sum(os.path.getsize(os.path.join(folder, n)) for n in os.listdir(folder))
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        t = time.time()
        child = subprocess.run([sys.executable, "-c", WINDOW_CHILD, ROOT, folder,
                                str(WINDOW_BATCHES), str(WINDOW_SLEEP_S)],
                               capture_output=True, text=True, env=env, timeout=300)
        child_s = time.time() - t
        if child.returncode:
            raise RuntimeError(f"phase 27c: the stream's child failed:\n{child.stderr[-3000:]}")
        w = json.loads(child.stdout.strip().splitlines()[-1])
        growth = (w["hwm_after"] - w["rss_before"]) / 2**30  # from w["source"]
        crop_bytes = 256 * 256 * 3 * 4
        window_gib = 2 * 8 * 8 * crop_bytes / 2**30
        folder_gib = WINDOW_FILES * crop_bytes / 2**30
        t = time.time()
        train = subprocess.run(
            [sys.executable, "-m", "imagecompression_adversarial_tpu_torch.cli.train",
             *TRAIN_FLAGS, "-ckpt", CKPT, "-data", folder, "-max_steps", str(WINDOW_TRAIN_STEPS)],
            capture_output=True, text=True, cwd=tmp, env={**os.environ, "PYTHONPATH": ROOT},
            timeout=600)
        train_wall = time.time() - t
        if train.returncode:
            raise RuntimeError(f"phase 27c: cli.train failed:\n{train.stderr[-3000:]}")
        done = next(ln for ln in train.stdout.splitlines() if ln.startswith("TRAIN DONE:"))
        timing = ast.literal_eval(done.split(":", 1)[1].strip())["timing"]
        steady = timing.get("steady_steps", 0) / timing["steady_s"] if timing.get("steady_s") \
            else float("nan")
        records["27c"] = {"files": WINDOW_FILES, "folder_bytes": folder_bytes, "write_s": write_s,
                          "child": w, "child_s": child_s, "growth_gib": growth,
                          "window_gib": window_gib, "folder_gib": folder_gib,
                          "train_steps": WINDOW_TRAIN_STEPS, "train_wall_s": train_wall,
                          "train_timing": timing, "train_steady_steps_per_s": steady,
                          "host": host, "card": card}
        log(f"phase 27c decode window: {WINDOW_FILES} PNGs of {JPEG_TRAIN_SIZE[1]}x"
            f"{JPEG_TRAIN_SIZE[0]} ({folder_bytes / 2**20:.1f} MiB, written in {write_s:.1f} s); "
            f"a child without CUDA took {WINDOW_BATCHES} batches of 8 at {WINDOW_SLEEP_S} s a "
            f"batch in {w['stream_s']:.2f} s: memory grew {growth:.3f} GiB (the high-water mark "
            f"{w['hwm_after'] / 2**30:.3f} GiB less the resident {w['rss_before'] / 2**30:.3f} GiB "
            f"before the stream, by {w['source']}; tol < {WINDOW_MAX_GIB}; the window's crops "
            f"{window_gib:.3f} GiB, the "
            f"folder's {folder_gib:.3f} GiB), close() {w['close_s']:.3f} s (tol < "
            f"{WINDOW_MAX_CLOSE_S}), the child {child_s:.1f} s in all; cli.train -data, "
            f"{WINDOW_TRAIN_STEPS} steps in a child: {train_wall:.1f} s wall, first step "
            f"{timing.get('first_step_s', float('nan')):.2f} s, then {steady:.2f} steps/s; "
            f"host {host}, card {card}")
        if growth >= WINDOW_MAX_GIB or w["close_s"] >= WINDOW_MAX_CLOSE_S:
            raise RuntimeError(f"phase 27c: the window holds too much or closes slowly: "
                               f"{records['27c']}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, launches_bwd


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``, else the platform's name for
    the machine) and its logical CPUs."""
    import platform

    model = platform.processor() or platform.machine() or "unknown CPU"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.lower().startswith("model name")), model)
    return f"{model}, {os.cpu_count()} logical CPUs"


def hold_uneven(uneven: dict, launches: dict) -> dict:
    """Phase 21e: phase 18's uneven row-sharded runs (``par_sp_uneven``)
    held to one process, cuDNN deterministic as the ranks ran, at 18f's
    bounds."""
    import numpy as np
    import torch

    from imagecompression_adversarial_tpu_torch.attacks.rd import make_attack_fn
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor
    from imagecompression_adversarial_tpu_torch.ops.shard import row_blocks

    codec = load_codec("hyper", 1, CKPT)
    records, failed = {}, []
    for kind, (h, w), n in (("pad", (512, 768), 2), ("ensemble", PAR_UNEVEN_SIZE, 4)):
        a = uneven[kind]
        x = to_tensor(synthetic_image(h, w, seed=0), "cuda")
        with cudnn_deterministic():
            ref, m_ref = measured(lambda: make_attack_fn(codec, par_uneven_cfg(kind))(x))
        got = torch.from_numpy(np.concatenate([r["im_"] for r in a], axis=2)).cuda()
        diff = (got - ref["im_"]).abs()
        far = float((diff > NOISE_ATOL).float().mean())
        dvi = max(abs(r["vi"] - float(ref["vi"])) for r in a)
        dbpp = max(abs(r["bpp_ori"] / float(ref["bpp_ori"]) - 1.0) for r in a)
        blocks = row_blocks(h + 2 * PAR_UNEVEN_PAD, n) if kind == "pad" else row_blocks(w, n)
        label = (f"-p {PAR_UNEVEN_PAD} at {w}x{h} on sp={n}, padded rows {blocks}"
                 if kind == "pad" else f"ensemble at {w}x{h} on sp={n}, rotated rows {blocks}")
        log(f"phase 21e {PAR_DEFENSE_STEPS}-step select attack, {label}: noise max |diff| "
            f"{float(diff.max()):.3e}, share > {NOISE_ATOL} {far:.2e} (tol "
            f"{PAR_DEFENSE_FAR_SHARE}), vi {a[0]['vi']:.6f} / {float(ref['vi']):.6f} (tol "
            f"{VI_ATOL}), bpp_ori rel {dbpp:.2e} (tol {PAR_BPP_RTOL}); per rank steps/s "
            f"{[round(r['steps_per_s'], 3) for r in a]}, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in a]} against {m_ref['peak_gib']:.3f} in one "
            f"process, GDN launches {[r['launches'] for r in a]} against {m_ref['launches']}; "
            f"one process {PAR_DEFENSE_STEPS / m_ref['s']:.3f} steps/s")
        if far > PAR_DEFENSE_FAR_SHARE or dvi > VI_ATOL or dbpp > PAR_BPP_RTOL or \
                not math.isfinite(a[0]["vi"]) or not all(r["launches"] for r in a):
            failed.append(label)
        records[f"21e {kind}"] = {
            "blocks": blocks, "noise_max_abs": float(diff.max()), "far_share": far,
            "vi_abs": dvi, "bpp_ori_rel": dbpp, "steps_per_s": [r["steps_per_s"] for r in a],
            "peak_gib": [r["peak_gib"] for r in a], "launches": [r["launches"] for r in a],
            "one_process_steps_per_s": PAR_DEFENSE_STEPS / m_ref["s"],
            "one_process_peak_gib": m_ref["peak_gib"]}
        for r, out in enumerate(a):
            launches[f"21e {kind} sp={n} rank {r}"] = out["launches"]
    if failed:
        raise RuntimeError(f"phase 21e: differs from one process: {failed}")
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from imagecompression_adversarial_tpu_torch.io import zstd
    from imagecompression_adversarial_tpu_torch.kernels import _build, gdn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"phase 1 libzstd for the orbax reader: {ctypes.util.find_library('zstd')}, version "
        f"{zstd.version()}")

    t = time.time()
    cached = _build.library_path().is_file()
    _build.load_library()
    log(f"phase 2 build: {time.time() - t:.2f} s ({'cached' if cached else 'nvcc'}) "
        f"-> {_build.library_path().name}")
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    for line in ptxas:
        log(f"phase 2 ptxas: {line}")
    if not any("registers" in ln for ln in ptxas):
        raise RuntimeError("phase 2: the build log has no ptxas register report")
    spills = [ln for ln in ptxas
              if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
    if spills:
        raise RuntimeError(f"phase 2: ptxas reports register spills: {spills}")
    t = time.time()
    cached = _build.rans_library_path().is_file()
    _build.build_rans()
    log(f"phase 2 build of the rANS coder: {time.time() - t:.2f} s "
        f"({'cached' if cached else 'g++'}) -> {_build.rans_library_path().name}")
    t = time.time()
    cached = _build.jpeg_library_path().is_file()
    _build.build_jpeg()
    jpeg_build = {"s": time.time() - t, "how": "cached" if cached else "g++",
                  "library": _build.jpeg_library_path().name}
    log(f"phase 2 build of the JPEG decoder: {jpeg_build['s']:.2f} s ({jpeg_build['how']}) -> "
        f"{jpeg_build['library']}")
    t = time.time()
    cached = _build.png_library_path().is_file()
    _build.build_png()
    png_build = {"s": time.time() - t, "how": "cached" if cached else "g++",
                 "library": _build.png_library_path().name}
    log(f"phase 2 build of the PNG decoder: {png_build['s']:.2f} s ({png_build['how']}) -> "
        f"{png_build['library']}")
    t = time.time()
    cached = _build.webp_library_path().is_file()
    _build.build_webp()
    webp_build = {"s": time.time() - t, "how": "cached" if cached else "g++",
                  "library": _build.webp_library_path().name}
    log(f"phase 2 build of the WebP decoder: {webp_build['s']:.2f} s ({webp_build['how']}) -> "
        f"{webp_build['library']}")
    host_builds = {}
    for fmt, path, build in (("TIFF", _build.tiff_library_path, _build.build_tiff),
                             ("GIF", _build.gif_library_path, _build.build_gif),
                             ("JPEG 2000", _build.jpeg2000_library_path, _build.build_jpeg2000)):
        t = time.time()
        cached = path().is_file()
        build()
        host_builds[fmt] = {"s": time.time() - t, "how": "cached" if cached else "g++",
                            "library": path().name}
        log(f"phase 2 build of the {fmt} decoder: {host_builds[fmt]['s']:.2f} s "
            f"({host_builds[fmt]['how']}) -> {host_builds[fmt]['library']}")
    import lzma

    probe = bytes(range(256)) * 4
    if lzma.decompress(lzma.compress(probe, format=lzma.FORMAT_XZ)) != probe:
        raise RuntimeError("phase 2: CPython's lzma does not round-trip")
    log(f"phase 2 lzma for the TIFF reader's LZMA strips: CPython's {lzma.__file__}, an xz "
        "round trip of 1024 bytes equal")

    records = phase_kernel_vs_plain(gdn)
    launches, launches_bwd, attack_rate = phase_main_path(gdn)
    phase_attack_kernel_vs_plain(gdn)
    phase_cli_png()
    launches_gmm, launches_gmm_bwd = phase_slice2_path(gdn)
    launches_families = phase_families_kernel_vs_plain(gdn)
    launches_coder = phase_coder(gdn)
    launches_slice4 = phase_slice4_path(gdn)
    launches_engines = phase_engines_kernel_vs_plain(gdn)
    train_records, launches_train, launches_train_bwd = phase_training(gdn)
    train_records["12c"] = phase_train_kernel_vs_plain(gdn)
    print(json.dumps({"phase12": train_records}), flush=True)
    adapter_records, launches_adapters = phase_adapters(gdn)
    print(json.dumps({"phase13": adapter_records}), flush=True)
    launches_adapters.update(phase_adapters_check(gdn))
    cls_records, launches_slice7 = phase_classifier(gdn)
    cls_records["15c"] = phase_gan(gdn)
    print(json.dumps({"phase15": cls_records}), flush=True)
    eval_records, launches_eval = phase_eval_clis(gdn)
    print(json.dumps({"phase16": eval_records}), flush=True)
    launches_slice7.update(launches_eval)
    analysis_records, launches_analysis = phase_analysis_clis(gdn)
    print(json.dumps({"phase17": analysis_records}), flush=True)
    launches_slice7.update(launches_analysis)
    parallel_records, launches_parallel, uneven = phase_parallel(gdn)
    print(json.dumps({"phase18": parallel_records}, default=float), flush=True)
    mp_records, launches_mp, launches_mp_bwd, mp_shapes = phase_megapixel(gdn)
    print(json.dumps({"phase19": mp_records}, default=float), flush=True)
    records += mp_shapes
    orbax_records, launches_orbax = phase_orbax_resume(gdn)
    print(json.dumps({"phase20": orbax_records}, default=float), flush=True)
    input_records, launches_inputs, launches_inputs_bwd = phase_inputs(gdn, jpeg_build, uneven)
    print(json.dumps({"phase21": input_records}, default=float), flush=True)
    kinds_records, launches_kinds, launches_kinds_bwd = phase_kinds(gdn, png_build)
    print(json.dumps({"phase22": kinds_records}, default=float), flush=True)
    webp_records, launches_webp, launches_webp_bwd = phase_webp(webp_build)
    print(json.dumps({"phase23": webp_records}, default=float), flush=True)
    tail_records, launches_tail, launches_tail_bwd = phase_tail(host_builds["TIFF"],
                                                               host_builds["GIF"])
    print(json.dumps({"phase24": tail_records}, default=float), flush=True)
    codec_records, launches_codec, launches_codec_bwd = phase_codecs(host_builds["TIFF"])
    print(json.dumps({"phase25": codec_records}, default=float), flush=True)
    slice20_records, launches_slice20, launches_slice20_bwd = phase_slice20(
        gdn, jpeg_build, smi, attack_rate)
    print(json.dumps({"phase26": slice20_records}, default=float), flush=True)
    slice21_records, launches_slice21, launches_slice21_bwd = phase_slice21(
        host_builds["JPEG 2000"], smi)
    print(json.dumps({"phase27": slice21_records}, default=float), flush=True)

    head = records[0]  # the largest call of the main path: C=128, rows 98,304, GDN
    print(json.dumps({"kernels": [{
        "name": "gdn_fwd",
        "route": "cuda",
        "source": "imagecompression_adversarial_tpu_torch/csrc/gdn.cu",
        "replaces": "scripts/pallas_gdn.py:100",
        "launches": launches,
        "launches_by_phase": {
            "4 hyper q1 768x512": launches,
            "7 cheng2020-gmm q3 768x512": launches_gmm,
            **{f"8 {m} 256x256": n for m, n in launches_families.items()},
            **launches_coder,
            **launches_slice4,
            **launches_engines,
            **launches_train,
            **launches_adapters,
            **launches_slice7,
            **launches_parallel,
            **launches_mp,
            **launches_orbax,
            **launches_inputs,
            **launches_kinds,
            **launches_webp,
            **launches_tail,
            **launches_codec,
            **launches_slice20,
            **launches_slice21,
        },
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "tf32_bound_ms": head["tf32_bound_ms"],
        "shape": {"rows": head["rows"], "C": head["C"], "inverse": head["inverse"]},
        "per_shape": [{k: v for k, v in r.items() if k != "backward"} for r in records],
    }, {
        "name": "gdn_bwd",
        "route": "cuda",
        "source": "imagecompression_adversarial_tpu_torch/csrc/gdn.cu",
        "replaces": "scripts/pallas_gdn.py:125",
        "launches": launches_bwd,
        "launches_by_phase": {
            "4 hyper q1 768x512": launches_bwd,
            "7 cheng2020-gmm q3 768x512": launches_gmm_bwd,
            **launches_train_bwd,
            **launches_mp_bwd,
            **launches_inputs_bwd,
            **launches_kinds_bwd,
            **launches_webp_bwd,
            **launches_tail_bwd,
            **launches_codec_bwd,
            **launches_slice20_bwd,
            **launches_slice21_bwd,
        },
        "max_abs_err": max(r["backward"]["max_abs_err"] for r in records),
        "ms": head["backward"]["ms"],
        "plain_ms": head["backward"]["plain_ms"],
        "bound_ms": head["backward"]["bound_ms"],
        "bound_by": head["backward"]["bound_by"],
        # no one PyTorch call computes the backward; its two cuBLAS products
        # are timed beside it
        "library_ms": None,
        "cublas_ms": {"addmm": head["backward"]["addmm_ms"],
                      "dnorm_gamma": head["backward"]["dnorm_gamma_ms"]},
        "shape": {"rows": head["rows"], "C": head["C"], "inverse": head["inverse"],
                  "mode": "dx"},
        "per_shape": [{"C": r["C"], "rows": r["rows"], "inverse": r["inverse"], **r["backward"]}
                      for r in records],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
