#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. Phases, each of which raises on failure:

1. print the card's name and power limit, build every CUDA kernel of the
   port from the checkout's sources (all in parallel), turn TF32 off, and
   measure the constants of the H100 hardware profile
   (repro_torch.calibrate);
2. hold each kernel against its plain PyTorch version on the card: the
   four-step FFT over the reference's kernel sweep (with every radix
   path: 16, 8, 4, 2, 3, 5, 7, a copy and primes above 7), a Karatsuba
   permuted 128 x 128 case, the main path's shapes, and row counts that
   walk its persistent CTAs (1, 131, 133 and 8193 rows of 128 x 128, 4229
   of (32, 16), in both modes and Karatsuba settings, and from an input
   one float past 16-byte alignment), at atol = 1e-4*scale; the tiled transpose over several dtypes and shapes and every block the main path's moves give it, exactly; the
   complex multiply over a block sweep, a suffix broadcast and the FFT
   convolution's shape, at atol = 1e-5 (the reference's); the four-step
   (permuted, at 1e-4*scale) and the transpose (exactly) at the blocks
   fft_conv hands them on the mixer's path; the fused FFT convolution over
   a factor x batch (odd and even) x block_rows sweep and its own path's
   shape, at atol = 2e-4*max|plain|;
3. run the N-D FFT path at real size through the public entry points with
   the kernel backend (Planner(backends=("hopper",))): rfftn of a 16384^2
   real array and irfftn back, fftn of a 512^3 complex pair and ifftn back,
   held against float64 torch.fft at atol = 2e-4*max|ref|, with the launch
   counts of the kernels read around this phase alone;
4. time the transforms (hopper planner, torch planner, torch.fft) and the
   four-step and transpose kernels alone at their main-path shapes, as
   medians of 10 CUDA-event timed runs after warm-up, then trace one call
   of each transform with torch.profiler (device time by kernel, device
   busy share);
5. free those arrays and run the FFT-convolution paths at real size:
   FFTConvMixer at olmo-1b's width (d_model 2048, rank 16) on a
   (4, 8192, 2048) input through the hopper planner, held against a
   float64 torch.fft convolution and float64 gate and projections, and the
   fused kernel's own entry causally (2x padding) on 8192 rows of 8192,
   held against float64 torch.fft, each with the launch counts of its run;
6. time the mixer and fft_conv (hopper planner, torch planner, a torch.fft
   composition) and the complex-multiply and fused kernels alone at their
   path shapes, then trace one mixer call with torch.profiler;
7. free those arrays and run the paper's shared-memory variants
   (repro_torch.core.variants: every name in VARIANTS, strided, and the
   composed staged_for_loop stages) on a 16384^2 f32 array through the
   hopper planner, each held against float64 torch.fft.rfft2 at
   atol = 2e-4*max|ref| with its kernel launches read around it alone
   (four-step 1; transpose 4 for for_loop, future_sync and the stages, 2
   for future_naive and future_opt, 0 for future_agas and strided), and
   for_loop against repro_torch.rfftn within 1e-6*max|ref|;
8. time them, the card's Fig. 1 and Fig. 2: every variant at 4096^2,
   8192^2 and 16384^2 with its ratio to for_loop, future_naive at 4096^2
   over the reference's task sizes, the four stages at 16384^2 alone
   against for_loop, as medians of CUDA-event timed runs (10, or 3 for the
   chunked variants) after one warm-up run with the wall time beside
   them, then trace for_loop and future_naive (task_size 8) at 4096^2;
9. start NCCL at world size 1 on a loopback TCPStore with a (1,) "fft" and
   a (1, 1) ("mx", "my") mesh (repro_torch.make_mesh) and run the
   distributed layer through the hopper planner with forced
   decompositions, each rank's block in and out (distribute, then collect):
   slab r2c 16384^2 (rfftn/irfftn) with comm collective, pipelined:4, agas
   and measure and with the transposed layout, pencil c2c 512^3
   (fftn/ifftn) and factor1d c2c 2^26, each held against float64
   torch.fft at atol = 2e-4*max|ref| and its round trip at 2e-4*max|x|,
   with the launch counts of each run alone (four-step and transpose in
   every run, complex_multiply in factor1d);
10. time each forward (medians of 10 CUDA-event timed runs) beside the
   local plan of the same shape (rfftn 16384^2, fftn 512^3; for 2^26,
   which no local plan takes, torch.fft.fft), timed before and after, the
   NCCL all_to_all_single call of 1 KiB at world size 1, and trace one
   slab call; then destroy the process group;
12. (still at world size 1 on NCCL) run FFTConvMixer(2048, 16) on
   (4, 8192, 2048) with the sequence sharded over the (1,) mesh
   (seq_axis_sharded=True, fft_conv_seq_sharded) with every comm
   (collective, pipelined:4, agas, auto, measure), each call's launches
   read alone (four-step 4, transpose 14, complex multiply 4), held within
   2e-4*max|ref| of the unsharded mixer on the same weights and of a
   float64 torch.fft mixer, and timed (medians of 10) beside the unsharded
   mixer;
13. the deprecated shims: fft2_slab/ifft2_slab r2c 16384^2 with no legacy
   flag, keep_transposed/from_transposed and permuted_cols, and
   fft3_pencil/ifft3_pencil/rfft3_pencil/irfft3_pencil 512^3 on the (1,)
   and (1, 1) meshes, each forward equal to the plan_nd path on the same
   block (its legacy layout undone), within 2e-4*max|ref| of float64
   torch.fft, its round trip within 2e-4*max|x|, with the launches of
   shim forward and back equal to those of the plan_nd path's;
14. compressed_psum on a payload of the mixer's parameters at olmo-1b
   width (12,617,728 f32) with every gather backend, auto and measure:
   at world size 1 the sum is exactly this rank's dequantized payload and
   the residual what quantization lost; timed (medians of 10); then the
   process group is destroyed;
11. spawn 4 ranks on the one card over gloo (which takes CUDA tensors;
   NCCL refuses two ranks on one GPU) and hold slab r2c 16384^2 on a (4,)
   mesh and pencil c2c 512^3 on a (2, 2) mesh, forward and back, against
   float64 torch.fft in the same way; then, on the same ranks, phases 12-14
   over them: the sharded mixer on (4,) against the unsharded mixer and
   float64 on rank 0, the shims on (4,) and (2, 2) against the gathered
   plan_nd path and float64, and compressed_psum (each rank its own
   payload) against the sum of the dequantized payloads and the exact
   sum; every rank ends and is joined;
15. serve the LM (repro_torch.launch.serve.ServeLoop, batch 4, 32 new
   tokens a request, bfloat16 compute) at olmo-1b's width under
   torch.no_grad(): the FFT-conv LM (olmo-1b with its 16 layers
   fftconv_mlp) through Planner(backends=("hopper",)) on 8 prompts of 8192
   tokens, with the launches of the drained run (32 four-step, 32
   transpose, 16 complex multiply a prefill, none a decode step) and of
   one prefill alone, (a) each prefill's logits against LM.forward over
   the same prompt, within 2e-2*max|ref|, and (b) every served row
   against the same weights served through torch_native (cuFFT), fed the
   same tokens, and both against that run in float32: the hopper run
   within 2x torch_native's error; then olmo-1b as published on 4 prompts
   of 2048 tokens, every served row against LM.forward over the prompt
   and the tokens served before it, in bfloat16 and in float32: the
   served rows within 2x the bfloat16 forward's error; printing prefill
   ms (median of 5; hopper, torch and torch_native for the FFT-conv LM),
   decode ms a step, tokens/s of the drained loop and peak memory, and
   traced prefills and decode steps;
16. serve the other layer kinds the same way (bfloat16 compute, weights
   cast once, 4 prompts of 2048 tokens, batch 4, 16 new tokens each):
   xlstm-1.3b (mLSTM, sLSTM) at full width on 16 of its 48 layers,
   zamba2-7b (Mamba2 and its shared attention block), qwen2-vl-7b
   (M-RoPE), musicgen-large (rope none) in full, and phi3.5-moe at full
   width on 8 of its 32 layers; none launches a kernel
   of the port. Each prefill is held against forward over its prompt
   within 2e-2*max|ref|. The decode path is held in float32: the same
   bfloat16 weights, cast to float32 at each use, served fed the bfloat16
   run's tokens with the decode cache in float32, every row within
   1e-3*max|ref| of forward in float32 over the prompt and those tokens
   (its MoE layers routing each token as the served call routed it, by a
   plain per-expert gather). Controls
   must miss that limit: the first prompt served with its cache never
   merged into its slot and with decode steps that leave the cache as
   they found it, and for phi3.5-moe that forward with every choice kept
   and with the weights not renormalised. The bfloat16 run's drift against
   the float32 one is printed, and each prefill's and decode step's
   dropped MoE choices. qwen2-vl and musicgen also prefill 2048 frontend
   embeddings (qwen2-vl: a 16 x 16 image, then text, on M-RoPE streams)
   against forward, then decode 4 steps on embeddings, in float32 held
   against the float32 forward in the same way. Each prints prefill ms
   (median of 5), decode ms a step, tokens/s, peak memory, and a traced
   decode step (and zamba2's prefill); xlstm the device ops of one sLSTM
   layer traced over 32, 64 and 128 tokens, scaled to its prefill;
17. train at olmo-1b's width: fft_conv's gradient on (2, 8192, 2048)
   float32 through the hopper planner (forward 2 / 2 / 1 four-step /
   transpose / complex-multiply launches, backward 1 / 2 / 2) against the
   autograd of a float64 torch.fft rendering within 2e-4*max|ref|, with
   two controls that must miss (grad_u against K instead of conj K, grad_k
   from the first batch row only); one float32 training step of the
   FFT-conv LM (1 x 8192 tokens, TF32 off) whose loss and every gradient
   are held per tensor within TRAIN_STEP_TOL of the same step with float64
   convolutions, and whose control (the convolution's output detached)
   must miss; then the Trainer (bfloat16 compute, float32 parameters,
   remat, AdamW warmup 1) on the FFT-conv LM under hopper (2 x 8192 a
   step) and on olmo-1b as published (4 x 2048), 6 steps each: finite
   losses, every parameter changed at every step, the launches of every
   step exact (80 / 96 / 64 / 0 and none), the checkpoint of step 3 (the
   only one written: TRAIN_CKPT_STEP) restored bit for bit, a run resumed
   from it within RESUME_TOL of the first run's losses; printing the
   losses, step ms, tokens/s, the peak beside its reckoning and a traced
   step;
18. train on a (data, model) mesh: (a) phase 17's two Trainer runs on a
   (1, 1) mesh at world size 1 on NCCL (FSDP2 over data), the same seed
   and shapes: losses, grad_norms and the parameters after the last step
   within MESH_P1_TOL of phase 17's, every parameter changed at every
   step, the launches of every step exactly phase 17's (FSDP and the mesh
   launch no kernel of the port); step ms, tokens/s, the peak and the busy
   share of a traced step printed beside phase 17's; (b) the sequence-sharded mixer's
   gradient (fft_conv_seq_sharded's backward) at (4, 8192, 2048) on (1,)
   against the unsharded mixer's, every tensor within 2e-4*max, the
   launches of a forward and backward exact (6 / 28 / 9), a control (K for
   conj K) that must miss, and its times beside the forward's; (c), run
   on phase 11's four gloo ranks: a (2, 2) mesh Trainer (tensor
   parallelism over model, FSDP2 over data) at olmo-1b's width on two
   layers (FFT-conv, dense), float32, against the same trainer on one
   rank (losses, grad_norms, the first moment after the first step and
   the parameters after the last), with a control that must miss (gradients averaged over
   the data ranks instead of summed), and the sharded mixer's gradient
   over (4,); (d), on the same ranks in float32, what a rank holds:
   olmo-1b's width on two layers on (1, 4) and (2, 2) and phi3.5-moe on
   one layer on (2, 2), loss_fn and its backward against one device's
   (run on every rank, each holding its own blocks of its gradients:
   loss 1e-5 of |loss|, every gradient 1e-4 of its max), every
   parameter's FSDP2 placement the dim runtime.trainer.fsdp_dims gives
   (phi's experts along moe_d), and, read by a dispatch mode, the widest
   logits block a rank builds (V/tp: the vocab-parallel head and
   cross-entropy) and the peak GiB a rank;
19. serve on a (data, model) mesh: (a) phase 15's two models (the same
   weights) on a (1, 1) mesh at world size 1 on NCCL through ServeLoop's
   mesh (build_cell's decode cell, the serve profile off), 4 of phase
   15's prompts and 8 new tokens each: every logits row equal to phase
   15's, build_cell's prefill_step equal to phase 15's forward, the
   launches exact; (b), run on phase 11's four gloo ranks in float32:
   olmo-1b's width on two layers (FFT-conv, dense) on (1, 4) and (2, 2),
   phi3.5-moe on two layers on (1, 4) (its experts over model) and the
   two-layer model at batch 1 on (4, 1) (each rank caching a quarter of
   the positions), prefill and decode within 1e-4 of max of rank 0's
   one-device model (whose MoE routing the mesh replays), with two
   controls that must miss (the experts not
   summed over model; the flash-decoding partials not rescaled);
20. serve the recurrent kinds, zamba2's shared block and the frontends
   on a (data, model) mesh: (a) zamba2-7b and xlstm-1.3b with phase 16's
   prompts and weights on a (1, 1) mesh at world size 1 on NCCL through
   ServeLoop's mesh: every logits row equal to phase 16's, no launch;
   (b), run on phase 11's four gloo ranks in float32 at full width cut in
   depth (zamba2-7b's first segment pair, xlstm-1.3b's, qwen2-vl-7b and
   musicgen-large on two layers fed synthetic embeddings, qwen2-vl's on
   M-RoPE streams): each on (1, 4), (2, 2) and, at batch 1, (4, 1),
   prefill and decode within 1e-4 of max of rank 0's one-device model,
   no launch on any rank; a (2, 2) Trainer step of zamba2 and xlstm, the
   loss within 1e-4, the gradient norm (and Mamba2's B and C runs' norm)
   within 1e-3 and every gradient within 1e-3 of max of one
   device's; controls that must miss (the norms over the inner width per
   rank, without the all-reduce of the sum of squares; Mamba2's B and C
   gradients not summed over model);
21. train a GPipe pipeline over pod (build_cell(..., pipeline=True)):
   (a) olmo-1b as published on a (1, 1, 1) (pod, data, model) mesh at
   world size 1 on NCCL, 4 x 2048 tokens in 4 microbatches: its float32
   twin's step (loss, grad_norm, every gradient after the pod sum, the
   first moment and the parameters after AdamW) against the same step of
   loss_fn and adamw_update on one device, then three bfloat16 steps
   timed beside phase 17's and traced, no kernel launched; (b), run on
   phase 11's four gloo ranks in float32: olmo-1b's width on four layers
   on (4, 1, 1), (2, 2, 1) and (2, 1, 2), each rank's stage's gradients
   against one device's, on (2, 1, 2) the widest tensor of the step on
   any stage the vocab's block (V/2: the last stage's head and loss hold
   the vocab in blocks), with a control that must miss (the gradients of
   the parameters whole over pod not summed over pod).

Phase 2 also holds the four-step, transpose and complex-multiply kernels
at the blocks the sharded convolution and one prefill of the FFT-conv LM
(bfloat16 activations, one prompt) hand them, whole and a rank's on a
(1, 4) mesh (512 of the 2048 channels); phase 4 prints the
H100 profile's estimate of the four-step pass beside its time and fails
beyond 1.5x; phase 10 prints plan_nd's estimate-mode and measured-mode
verdicts at the chip shapes. The last lines are the kernel table as one
JSON object (each kernel's launches summed over the counted runs of the
paths, and by path), then the card label, then {"ok": true, "device":
{...}}. It
needs one GPU and exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
FP32_PEAK = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores (published)
HBM_PEAK = 3.35e12   # H100 SXM HBM3 bytes/s (published)
# every radix path of the kernels: 16 (128 x 128), 8, 4, 2 (6 x 10), 3, 5,
# 7, a copy (1) and the generic pass of a prime above 7 (11, 13, 127)
FOUR_STEP_SWEEP = [(8, 8), (16, 16), (16, 32), (32, 64), (128, 128), (8, 128),
                   (128, 8), (25, 40), (125, 8), (7, 3), (4, 9), (128, 1),
                   (11, 13), (127, 1), (1, 127), (6, 10)]
# row counts that walk the kernel's persistent CTAs (one an SM): one row,
# fewer and more rows than the card's 132 SMs, the rfftn column pass's
# 8193; at (32, 16) batches of 16 rows, the last of 5; each in both modes
# and both Karatsuba settings, and once from an input one float past
# 16-byte alignment (the 4-byte copies instead of the TMA)
FOUR_STEP_PERSISTENT = {(128, 128): (1, 131, 133, 8193), (32, 16): (4229,)}
# the arrays whose axes the main path moves: the rfftn 16384^2 spectrum
# before its column pass, and the fftn 512^3 cube
MAIN_SPECTRA = ((16384, 8193), (512, 512, 512))
# complex_multiply (a, b) shapes: same shape, the reference's broadcast, a
# suffix broadcast, an odd one, a small b repeated many times; and elements
# per CTA, some not a multiple of 4
CMUL_CASES = [((3, 40, 56), (3, 40, 56)), ((4, 300), (300,)),
              ((2, 3, 64), (3, 64)), ((5, 1001), (1001,)),
              ((4096, 64), (64,))]
CMUL_BLOCKS = (1, 3, 256, 1024, 4096)
FUSED_FACTORS = [(8, 8), (16, 32), (64, 64), (128, 8), (128, 128), (11, 13),
                 (127, 1), (6, 10), (16, 128), (96, 100), (127, 65)]
FUSED_BLOCK_ROWS = (1, 4, 8)
FUSED_BATCHES = (5, 6)     # the kernel pairs rows: an odd batch pads one
# the fused kernel's short-row design timed beside the path's shape: rows
# of 512 (32 x 16), the four-step's short-row shape
FUSED_SHORT = (262144, (32, 16))
# the FFT-conv mixer at olmo-1b's width (src/repro/configs/olmo_1b.py:
# d_model 2048; fftconv_rank 16 is the ArchConfig default) on 4 x 8192
# tokens: nf = 16384, factors (128, 128)
MIXER_D, MIXER_RANK, MIXER_B, MIXER_S = 2048, 16, 4, 8192
CONV_ROWS, CONV_L = 8192, 8192     # the fused kernel's causal path
# the variants: the 2D size class of the paper's shared-memory study (and
# rfftn's shape above), the card's Fig. 1 sizes, the variants in the
# reference's Fig. 1 order, and its task-size sweep (benchmarks/fig1_variants.py)
VARIANT_N = 16384
VARIANT_SIZES = (4096, 8192, 16384)
VARIANT_ORDER = ("for_loop", "future_sync", "future_opt", "future_naive",
                 "future_agas", "strided")
# host-bound (0.6-4.9 s a run on the card's host): one timed run each
CHUNKED = ("future_naive", "future_opt")
TASK_SIZES, TASK_SWEEP_N = (1, 2, 4, 8, 16, 64, 256), 4096
# the distributed layer at world size 1: slab r2c 16384^2 (rfftn's shape)
# over each exchange setting and the transposed layout, pencil c2c 512^3
# (fftn's), factor1d c2c 2^26 (a length no local plan takes)
DIST_SLAB_N, DIST_PENCIL_N, DIST_FACTOR1D_LOG2 = 16384, 512, 26
DIST_SLAB_COMMS = ("collective", "pipelined:4", "agas", "measure")
GLOO_RANKS = 4       # phase 11: ranks on the one card, over gloo
# kernel launches of one forward and inverse of each decomposition, on every
# rank at any p: slab and pencil those of the local rfftn + irfftn and fftn +
# ifftn (no exchange move runs a kernel), factor1d two four-step passes
# forward, six moves each way and one twiddle product each way
DIST_LAUNCHES = {
    "slab": {"four_step_fft": 1, "batched_transpose": 8,
             "complex_multiply": 0, "fftconv_fused": 0},
    "pencil": {"four_step_fft": 3, "batched_transpose": 16,
               "complex_multiply": 0, "fftconv_fused": 0},
    "factor1d": {"four_step_fft": 2, "batched_transpose": 12,
                 "complex_multiply": 2, "fftconv_fused": 0}}
# phase 12: the mixer with its sequence sharded, each exchange setting,
# and the kernel launches of one call at any p: the c2c passes along n1
# and n2 of the activations and of the filters on the four-step kernel;
# the (B, L, D) -> (B, D, L) move and back and, for each n1 pass (the two
# forward ones and the inverse, on torch.matmul), two moves a pair member
# on the transpose kernel; the twiddle of each forward and of the inverse
# and the spectrum product on the complex multiply
SHARDED_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")
SHARDED_LAUNCHES = {"four_step_fft": 4, "batched_transpose": 14,
                    "complex_multiply": 4, "fftconv_fused": 0}
# phase 14: a payload the size of the mixer's parameters at olmo-1b width
# (w_in, w_out, filt, skip)
PSUM_N = MIXER_D * 2 * MIXER_D + MIXER_D * MIXER_D + MIXER_D * MIXER_RANK \
    + MIXER_D
PSUM_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")
# phase 15: the LM serving path at olmo-1b's width (src/repro/configs/
# olmo_1b.py): the FFT-conv LM (every layer fftconv_mlp) serves LM_REQUESTS
# prompts of LM_PROMPT tokens (nf = 16384, factors (128, 128)) and olmo-1b
# as published OLMO_REQUESTS prompts of OLMO_PROMPT, batch SERVE_BATCH,
# SERVE_NEW tokens each. Two bfloat16 computations of the same logits in
# the same order of operations are held to 2e-2 of their max, the
# reference's serving tolerance (tests/test_serving.py). Two orders of
# the same bfloat16 arithmetic (prefill and decode, hopper and cuFFT)
# differ by the rounding noise of 16 layers, which grows with depth and
# width to a few 1e-2 of the max; each is held instead against the same
# weights computed in float32, and must carry at most NOISE_RATIO times
# the error that bfloat16 gives the path it is compared with
LM_PROMPT, LM_REQUESTS, OLMO_PROMPT, OLMO_REQUESTS = 8192, 8, 2048, 4
SERVE_BATCH, SERVE_NEW, SERVE_TOL, NOISE_RATIO = 4, 32, 2e-2, 2.0
# kernel launches of one FFT-conv layer's prefill (fft_conv: the
# activations' and the filters' four-step passes, the move in and out, the
# spectrum product); a decode step launches none
LM_LAYER_LAUNCHES = {"four_step_fft": 2, "batched_transpose": 2,
                     "complex_multiply": 1, "fftconv_fused": 0}
# phase 16: the other layer kinds served at full width, bfloat16 compute
# (src/repro_torch/configs/): each model KIND_REQUESTS prompts of
# KIND_PROMPT tokens, batch SERVE_BATCH, KIND_NEW new tokens each; phi3.5-moe
# at full width cut to 8 of its 32 layers (the whole model's 83.7 GB of
# bf16 weights do not fit the card's 80 GB). The
# embedding-input models also prefill KIND_PROMPT frame or patch
# embeddings (qwen2-vl: a MROPE_GRID^2 image, then text, on M-RoPE streams)
# and decode EMBED_STEPS more. A prefill is held against forward at
# SERVE_TOL (the same computation). The decode path is held in float32:
# the same weights served in float32 with a float32 decode cache, fed the
# bfloat16 run's tokens, against forward in float32 within KIND_F32_TOL of
# the max logit, float32 arithmetic in another order (its MoE routes each
# token as the served call did). A bfloat16 cache would round k/v, and
# decode attention its queries and weights, at every step; float32 noise
# flips some of those roundings, which depth amplifies to a few 1e-3 of
# the max logit (PERF.md). The controls (a cache never merged, decode steps that
# carry no state; for MoE, no capacity or weights not renormalised) must
# miss it. At this depth random bfloat16 weights drift far from float32
# (xlstm, zamba2: about half the max logit; tests/test_torch_lm_drift.py
# holds the port's drift to the reference's), so the drift is printed,
# not held. The sLSTM layers' device ops are traced over SLSTM_TRACED
# tokens
# xlstm-1.3b runs 16 of its 48 layers, two of its six (7 mLSTM + 1
# sLSTM) repeats: its prefill is a per-token sLSTM loop bound by the host
# (6.4 s a request at full depth); the whole script passed 1100 s of its
# 1200 at full depth, and 1085 s at 24 layers on a slower host.
KIND_MODELS = (("xlstm-1.3b", 16), ("zamba2-7b", None),
               ("qwen2-vl-7b", None), ("musicgen-large", None),
               ("phi3.5-moe-42b-a6.6b", 8))
KIND_PROMPT, KIND_REQUESTS, KIND_NEW = 2048, 4, 16
MROPE_GRID, EMBED_STEPS = 16, 4
KIND_F32_TOL, SLSTM_TRACED = 1e-3, (32, 64, 128)
# phase 17: training at olmo-1b's width (bfloat16 compute, float32
# parameters, remat, AdamW with warmup 1): the FFT-conv LM on TRAIN_B x
# TRAIN_S tokens a step (nf = 16384, factors (128, 128)), olmo-1b as
# published on OLMO_TRAIN_B x OLMO_TRAIN_S, TRAIN_STEPS steps each, a
# checkpoint after step TRAIN_CKPT_STEP. fft_conv's gradient is held at
# the port's standing limit, TRAIN_CONV_TOL of max|ref|. One float32 step
# of the FFT-conv LM (1 x TRAIN_S) is held per tensor within TRAIN_STEP_TOL
# of the same step with float64 convolutions: scripts/train_step_noise.py
# measures that comparison on the CPU at smoke width and full depth
# (PERF.md). A run resumed from the checkpoint reaches the first run's
# losses within RESUME_TOL of them: not bit for bit, for kernels that
# accumulate with atomics may run there. A checkpoint of either model is
# 13-14 GB (float32 parameters and AdamW moments), and the script keeps
# its disk writes under 45 GiB, so each run writes only the checkpoint
# under test, that of step TRAIN_CKPT_STEP: the save at the end of a run
# and the resumed run's are skipped (the CPU tests hold them)
TRAIN_B, TRAIN_S, OLMO_TRAIN_B, OLMO_TRAIN_S = 2, 8192, 4, 2048
TRAIN_STEPS, TRAIN_CKPT_STEP = 6, 3
TRAIN_CONV_TOL, TRAIN_STEP_TOL, RESUME_TOL = 2e-4, 1e-3, 1e-3
# kernel launches of one FFT-conv layer in a training step with remat:
# fft_conv's forward twice (the recompute), 2 / 2 / 1 each, and its
# backward 1 / 2 / 2 (the output gradient's transform, its move in and
# grad_u's move out, G conj(K) and conj(U) G)
TRAIN_LAYER_LAUNCHES = {"four_step_fft": 5, "batched_transpose": 6,
                        "complex_multiply": 4, "fftconv_fused": 0}
# phase 18: training on a (data, model) mesh. (a) the Trainer of phase 17
# on a (1, 1) mesh at world size 1 on NCCL (FSDP2 over data, no tensor
# parallelism), both models, the same seed and shapes: every step's loss
# and grad_norm, and each parameter after the last step (gathered, err/max
# per tensor), within MESH_P1_TOL of phase 17's; every parameter changed
# at every step; the launches a step exactly phase 17's. MESH_P1_TOL
# rests on phase 17's resumed run and this run's losses, both equal to
# phase 17's bit for bit on the H100 (PERF.md): at world size 1 FSDP2's
# gather and reduce-scatter copy, so nothing should move. (b) the
# sequence-sharded mixer's gradient (fft_conv_seq_sharded's backward) at
# MIXER_B x MIXER_S x MIXER_D on (1,) against the unsharded mixer's, every
# tensor within SHARDED_GRAD_TOL of its max; a forward and backward
# launches SHARDED_GRAD_LAUNCHES (the forward's 4 / 14 / 4, the backward's
# 2 / 14 / 5: the output gradient's distributed transform and moves, G
# conj K, conj U G and the two inverse twiddles); the control (K for
# conj K) must miss. (c) over the GLOO_RANKS gloo ranks of phase 11, a
# (2, 2) mesh Trainer at olmo-1b's width on MESH_LAYERS (one FFT-conv and
# one dense layer, float32 compute, MESH_B x MESH_S) for MESH_STEPS steps
# against the same trainer on one rank: losses and grad_norms within
# MESH_F32_TOL of them (tests/test_torch_mesh_train.py holds 1e-5 at smoke
# width), the first moment after the first step within MESH_F32_TOL of
# its max per tensor (it is (1 - beta1) times the first gradients), each
# parameter's distance from the one-rank run's after the last step within
# MESH_UPDATE_TOL of the one-rank run's own update (|p - p1| / |p1 - p0|,
# L2 per tensor: Adam's first steps move an element by about lr whatever
# its gradient, so an element whose gradient is within float32 noise of 0
# may move either way, and an element-wise limit would rest on no element
# flipping), every parameter changed at every step; a control that must miss: FSDP2 averaging the
# gradients over the data ranks (divide factor dp) instead of summing
# them, which AdamW's clip makes invisible in the losses and the
# parameters but not in grad_norm; and the sharded mixer's gradient over
# (4,) (batch 1) within SHARDED_GRAD_TOL, then channel-parallel on the
# (2, 2) mesh (the sequence over data, tp over model): every rank's
# gradients of its blocks within SHARDED_GRAD_TOL of the unsharded
# mixer's slices, its launches SHARDED_GRAD_LAUNCHES, and a control that
# must miss (the filter gradient summed over model too)
MESH_P1_TOL, SHARDED_GRAD_TOL, MESH_F32_TOL = 1e-6, 2e-4, 1e-4
MESH_UPDATE_TOL = 5e-2
SHARDED_GRAD_LAUNCHES = {"four_step_fft": 6, "batched_transpose": 28,
                         "complex_multiply": 9, "fftconv_fused": 0}
MESH_LAYERS = (("fftconv_mlp", 1), ("attn_mlp", 1))
MESH_B, MESH_S, MESH_STEPS = 4, 2048, 3
# phase 18 (d): what a rank holds on a (data, model) mesh, over the
# GLOO_RANKS gloo ranks in float32 (TF32 off): olmo-1b's width on
# PLACE_LAYERS layers (PLACE_B x PLACE_S) on (1, 4) and (2, 2) and
# phi3.5-moe on PLACE_PHI_LAYERS layer (PLACE_B x PLACE_PHI_S, 2 MoE
# groups) on (2, 2), each loss_fn + backward against one device (on
# every rank, which keeps its own blocks of those gradients:
# tests/_lm_parity.py's limits, PLACE_LOSS_TOL of |loss|, PLACE_GRAD_TOL
# of each gradient's max), every FSDP2 placement fsdp_dims's, and the
# widest (..., X) tensor an op of the loss or its backward yields: V/tp.
# phi3.5-moe takes one layer: its experts cut along moe_d (FSDP2's
# Shard(1)) are copied out of each all-gather (a layer's 2.5 GB block
# twice over a rank, and its gradient's reduce-scatter input), and with
# two layers the four ranks' backward outgrew the one card's 80 GB
PLACE_LAYERS, PLACE_B, PLACE_S, PLACE_PHI_S = 2, 4, 512, 256
PLACE_PHI_LAYERS = 1
PLACE_LOSS_TOL, PLACE_GRAD_TOL = 1e-5, 1e-4
# phase 19: serving on a (data, model) mesh. (a) phase 15's two models
# (the same seed: the same weights) on a (1, 1) mesh at world size 1 on
# NCCL through ServeLoop's mesh (build_cell's decode cell: its rules, the
# serve profile off, and its serve_step), MESH_SERVE_REQUESTS of phase 15's
# prompts, MESH_SERVE_NEW tokens each from caches of phase 15's length:
# every logits row equal to phase 15's, for every collective at world
# size 1 is a copy; build_cell's prefill_step (forward's last position)
# equal to phase 15's forward over each prompt; the launches phase 15's a
# prefill and none a decode step. (b) over the GLOO_RANKS gloo ranks of
# phase 11, float32 compute (TF32 off): olmo-1b's width on MESH_LAYERS on
# (1, 4) and (2, 2) at batch SERVE_BATCH, phi3.5-moe at full width cut to
# GLOO_PHI_LAYERS layers (bf16 weights cast at each use) on (1, 4), and
# MESH_LAYERS on (4, 1) at batch 1 (the flash-decoding layout: each rank
# caches GLOO_SERVE_S / 4 positions); each prefills GLOO_SERVE_S tokens
# (phi GLOO_PHI_S) and decodes GLOO_SERVE_NEW forced tokens, every logits
# row within GLOO_SERVE_TOL of max of rank 0's one-device model, float32
# arithmetic in another order (the MoE's routing replayed from the
# one-device run: a float32 near-tie at full width flips an expert,
# routes_replayed); the FFT-conv layer's launches exact on
# every rank (its prefill's, none a decode step). Controls that must miss:
# the MoE's experts combined on each rank without the sum over model, and
# the flash-decoding partials merged without the rescale to the global max
MESH_SERVE_REQUESTS, MESH_SERVE_NEW = 4, 8
GLOO_SERVE_S, GLOO_PHI_S, GLOO_SERVE_NEW, GLOO_SERVE_TOL = 2048, 512, 4, 1e-4
GLOO_PHI_LAYERS = 2
# phase 20: the recurrent kinds, zamba2's shared block and the frontends
# on a (data, model) mesh. (a) KIND_MESH_MODELS as published with phase
# 16's traffic (its prompts and weights, KIND_NEW tokens each, bfloat16)
# through ServeLoop on a (1, 1) mesh at world size 1 on NCCL (build_cell's
# decode cell, serve profile off): every logits row equal to phase 16's,
# no kernel launched. (b) over the GLOO_RANKS gloo ranks of phase 11,
# float32 compute (TF32 off), at full width cut in depth (GLOO_KINDS:
# zamba2-7b's first segment pair, 6 mamba2 layers and the shared
# attention block; xlstm-1.3b's, 7 mlstm and 1 slstm; qwen2-vl-7b and
# musicgen-large on 2 layers, fed synthetic embeddings, qwen2-vl's on
# M-RoPE streams of a MROPE_GRID^2 image then text), each on (1, 4) and
# (2, 2) at batch SERVE_BATCH and on (4, 1) at batch 1 (the
# flash-decoding layout): a prefill of GLOO_KINDS_S positions and
# GLOO_SERVE_NEW forced decode steps, every logits row within
# GLOO_SERVE_TOL of max of rank 0's one-device model, no kernel launched
# on any rank; one (2, 2) Trainer step of the two recurrent models on
# KINDS_TRAIN_B x GLOO_KINDS_S tokens against rank 0's one device: the
# loss within KINDS_LOSS_TOL of it, each gradient within KINDS_GRAD_TOL of
# its max (float32 sums in another order), and the gradient norm that
# global_norm reads from the ranks' blocks (the Trainer's groups) within
# KINDS_NORM_TOL of one device's, of the whole tree and of Mamba2's B and
# C runs alone in each in_proj and conv_w (NormShare counts them once).
# Controls that must miss: the norms over the whole inner width on each
# rank's channels alone (no all-reduce of the sum of squares; zamba2 and
# xlstm served on (1, 4)), Mamba2's B and C gradients, whole on every
# rank, not summed over model (zamba2's step), and their norm with the
# NormShare weight dropped (counted on each model rank: sqrt(2) x)
KIND_MESH_MODELS = ("zamba2-7b", "xlstm-1.3b")
GLOO_KINDS = (
    ("zamba2-7b", {"segments": (("mamba2", 6), ("shared_attn", 1)),
                   "num_layers": 7}),
    ("xlstm-1.3b", {"segments": (("mlstm", 7), ("slstm", 1)),
                    "num_layers": 8}),
    ("qwen2-vl-7b", {"num_layers": 2}),
    ("musicgen-large", {"num_layers": 2}))
GLOO_KINDS_S, KINDS_TRAIN_B = 512, 4
KINDS_LOSS_TOL, KINDS_GRAD_TOL, KINDS_NORM_TOL = 1e-4, 1e-3, 1e-3
# phase 21: training a GPipe pipeline over pod (build_cell(...,
# pipeline=True): parallel/pipelined_lm.py). (a) olmo-1b as published
# (16 layers, d 2048) on a (1, 1, 1) (pod, data, model) mesh at world size
# 1 on NCCL, OLMO_TRAIN_B x OLMO_TRAIN_S tokens (4 microbatches of one
# row): its float32 twin's step against the same step on one device
# (loss_fn, adamw_update) from the same weights: the loss within
# PIPE_P1_LOSS_TOL of it, grad_norm within PIPE_P1_NORM_TOL, every
# gradient and the first moment after the step within PIPE_P1_GRAD_TOL of
# its max (the microbatches' weight gradients are summed in another order
# than one batch's), each parameter's distance from the one-device step's
# within MESH_UPDATE_TOL of that step's own update; then PIPE_STEPS bfloat16
# steps of the cell timed beside phase 17's, no kernel launched. (b) over
# the GLOO_RANKS gloo ranks of phase 11, float32: olmo-1b at full width cut
# to GLOO_PIPE_LAYERS layers on each of GLOO_PIPE_MESHES, GLOO_PIPE_B x
# GLOO_PIPE_S tokens, num_microbatches 4 (build_cell's step, its gradients
# after the pod sum), against one device on every rank: the loss within
# GLOO_PIPE_LOSS_TOL, every gradient within GLOO_PIPE_GRAD_TOL of its max,
# and where model > 1 the widest (..., X) tensor of the step exactly V/tp;
# a control that must miss: the whole-over-pod gradients (the tied
# embedding, the final norm) not summed over pod, on (4, 1, 1)
PIPE_P1_LOSS_TOL, PIPE_P1_NORM_TOL, PIPE_P1_GRAD_TOL = 1e-6, 1e-5, 1e-4
PIPE_STEPS = 3
GLOO_PIPE_LAYERS, GLOO_PIPE_B, GLOO_PIPE_S = 4, 4, 512
GLOO_PIPE_MESHES = ((4, 1, 1), (2, 2, 1), (2, 1, 2))
GLOO_PIPE_LOSS_TOL, GLOO_PIPE_GRAD_TOL = 1e-5, 1e-4
# transpose kernel launches of one call; the four-step's is 1 for each
# (future_naive and future_opt scatter their rows with torch's copy, agas
# gathers, strided copies its view inside the four-step op)
VARIANT_TRANSPOSES = {"for_loop": 4, "future_sync": 4, "staged": 4,
                      "future_naive": 2, "future_opt": 2, "future_agas": 0,
                      "strided": 0}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(ops, nbytes):
    """(ms, what bounds it): the larger of operations over the FP32 peak and
    bytes over the HBM peak."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, device="cuda", generator=gen, dtype=dtype)


def four_step_error(x, factors, **modes):
    """(max |kernel - plain|, scale) for one four-step call on the card."""
    from repro_torch.kernels.dft_matmul import fft_four_step, fft_four_step_ref
    k = fft_four_step(x, factors, **modes)
    r = fft_four_step_ref(x, factors, **modes)
    torch.cuda.synchronize()
    scale = r[0].abs().max().item() + 1e-6
    err = max((k[0] - r[0]).abs().max().item(),
              (k[1] - r[1]).abs().max().item())
    return err, scale


def main_move_blocks() -> list:
    """Every (B, n, M) block the main path's moves hand the transpose: each
    axis but the last of MAIN_SPECTRA, moved last and moved back."""
    from repro_torch.core.dfft import move_blocks
    out = []
    for shape in MAIN_SPECTRA:
        for axis in range(len(shape) - 1):
            for block in move_blocks(shape, axis):
                if block not in out:
                    out.append(block)
    return out


def transpose_error(x) -> float:
    """max |kernel - plain| of one transpose on the card; raises unless the
    two are equal."""
    from repro_torch.kernels.transpose import transpose, transpose_ref
    k, r = transpose(x), transpose_ref(x)
    torch.cuda.synchronize()
    check(k.shape == r.shape, f"batched_transpose {tuple(x.shape)} shape")
    err = (k.double() - r.double()).abs().max().item()
    check(err == 0.0 and torch.equal(k, r), f"batched_transpose "
          f"{tuple(x.shape)} {x.dtype} differs from plain by {err}")
    return err


def phase_kernels(gen, main_shapes) -> dict:
    """Every kernel against its plain version; returns the max errors."""
    worst = 0.0           # max err / scale over the sweep (limit 1e-4)
    cases = [((b, f[0] * f[1]), f, {}) for f in FOUR_STEP_SWEEP
             for b in (1, 5, 16)]
    cases += [((4, 1024), (32, 32), dict(karatsuba=k, permuted=p))
              for k in (False, True) for p in (False, True)]
    cases += [((2, 16384), (128, 128), dict(karatsuba=True, permuted=True))]
    cases += [((2, 3, 256), (16, 16), {})]
    cases += [(shape, f, {}) for shape, f in main_shapes.values()]
    cases += [((b, f[0] * f[1]), f, dict(karatsuba=k, permuted=p))
              for f, rows in FOUR_STEP_PERSISTENT.items() for b in rows
              for k in (False, True) for p in (False, True)]
    cases += [((b, f[0] * f[1]), f, dict(offset=1))
              for f, rows in FOUR_STEP_PERSISTENT.items() for b in rows]
    main_err = {}
    for shape, factors, modes in cases:
        modes = dict(modes)
        skip = modes.pop("offset", 0)    # floats before the input
        x = tuple(randn((math.prod(shape) + skip,), gen)[skip:].view(shape)
                  for _ in "ri")
        err, scale = four_step_error(x, factors, **modes)
        check(err <= 1e-4 * scale,
              f"four_step_fft {shape} {factors} {modes} offset {skip}: err "
              f"{err} > 1e-4 * {scale}")
        worst = max(worst, err / scale)
        for name, (s, f) in main_shapes.items():
            if (shape, factors) == (s, f) and not modes and not skip:
                main_err[name] = err
        del x
    transposed = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8,
                  torch.float64):
        for shape in ((3, 40, 56), (96, 160), (8193, 16384)):
            if dtype.is_floating_point:
                x = randn(shape, gen, dtype)
            else:
                x = torch.randint(-100, 100, shape, device="cuda",
                                  generator=gen, dtype=dtype)
            transpose_error(x)
            transposed += 1
            del x
    moves = {}
    for block in main_move_blocks():
        moves[str(block)] = transpose_error(randn(block, gen))
    print(f"checked four_step_fft on {len(cases)} cases (worst err/scale "
          f"{worst:.3e}, limit 1e-4) and batched_transpose on {transposed} "
          f"dtype x shape cases and the main path's f32 blocks {list(moves)} "
          "(exact)")
    return {"four_step_fft": main_err, "four_step_worst_rel": worst,
            "batched_transpose": moves}


def check_two_factor_hopper(planner, n: int) -> None:
    """planner.plan(n, "c2c") must be a two-factor hopper plan, the only
    kind that reaches the kernel."""
    p = planner.plan(n, "c2c")
    check(p.backend == "hopper" and len(p.factors) == 2,
          f"c2c n={n} plan {p} does not reach the four-step kernel")
    print(f"plan c2c n={n}: {p.backend} {p.factors} (estimate, no wisdom)")


def max_err(pair, ref) -> float:
    return max((pair[0].double() - ref.real).abs().max().item(),
               (pair[1].double() - ref.imag).abs().max().item())


def phase_main_path(planner, x, z) -> dict:
    """The public entry points at real size, checked; returns the launch
    counts of this phase alone."""
    import repro_torch
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    spec = repro_torch.rfftn(x, planner=planner)
    back = repro_torch.irfftn(spec, shape=x.shape, planner=planner)
    zf = repro_torch.fftn(z, planner=planner)
    zb = repro_torch.ifftn(zf, planner=planner)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("four_step_fft", "batched_transpose"):
        check(launches[name] > 0, f"the main path never launched {name}")

    ref = torch.fft.rfftn(x.double())
    tol = 2e-4 * ref.abs().max().item()
    err_r = max_err(spec, ref)
    check(err_r <= tol, f"rfftn 16384^2 err {err_r} > {tol}")
    del ref
    x_tol = 2e-4 * x.abs().max().item()
    rt_r = (back - x).abs().max().item()
    check(rt_r <= x_tol, f"irfftn(rfftn) round trip err {rt_r} > {x_tol}")
    ref = torch.fft.fftn(torch.complex(z[0].double(), z[1].double()))
    tol_c = 2e-4 * ref.abs().max().item()
    err_c = max_err(zf, ref)
    check(err_c <= tol_c, f"fftn 512^3 err {err_c} > {tol_c}")
    del ref
    z_tol = 2e-4 * max(z[0].abs().max().item(), z[1].abs().max().item())
    rt_c = max((zb[0] - z[0]).abs().max().item(),
               (zb[1] - z[1]).abs().max().item())
    check(rt_c <= z_tol, f"ifftn(fftn) round trip err {rt_c} > {z_tol}")
    check(tuple(spec[0].shape) == (16384, 8193) and back.shape == x.shape
          and tuple(zf[0].shape) == (512,) * 3, "output shapes")
    check(all(torch.isfinite(t).all().item()
              for t in (*spec, back, *zf, *zb)), "non-finite output")
    print(f"main path: rfftn 16384^2 err {err_r:.4e} (tol {tol:.4e}), "
          f"round trip {rt_r:.3e} (tol {x_tol:.3e}); fftn 512^3 err "
          f"{err_c:.4e} (tol {tol_c:.4e}), round trip {rt_c:.3e} (tol "
          f"{z_tol:.3e}); launches {launches}; {seconds:.3f} s incl. first "
          f"calls; peak {peak / 2 ** 30:.2f} GiB")
    return launches


def phase_times(label, planners, x, z, main_shapes, gen) -> dict:
    import repro_torch
    from repro_torch.calibrate import time_ms
    from repro_torch.kernels.dft_matmul import fft_four_step, fft_four_step_ref
    from repro_torch.kernels.transpose import transpose, transpose_ref
    zc = torch.complex(z[0], z[1])
    rows = [("rfftn 16384^2", lambda p: repro_torch.rfftn(x, planner=p),
             lambda: torch.fft.rfftn(x)),
            ("fftn 512^3", lambda p: repro_torch.fftn(z, planner=p),
             lambda: torch.fft.fftn(zc))]
    for name, run, lib in rows:
        ms = {k: time_ms(lambda p=p: run(p)) for k, p in planners.items()}
        ms["torch.fft"] = time_ms(lib)
        print(f"time {name}: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in ms.items())
              + f" [{label}]")
    del zc

    out = {}
    for name, (shape, f) in main_shapes.items():
        b, n = shape
        xs = (randn(shape, gen), randn(shape, gen))
        xc = torch.complex(xs[0], xs[1])
        ms = time_ms(lambda: fft_four_step(xs, f))
        plain = time_ms(lambda: fft_four_step_ref(xs, f))
        lib = time_ms(lambda: torch.fft.fft(xc))
        # the function is a length-n DFT of each row: 5 n log2(n) float
        # operations and one complex f32 read and write per point
        fft_flops, nbytes = 5.0 * b * n * math.log2(n), 16.0 * b * n
        bound_ms, by = bound(fft_flops, nbytes)
        print(f"time four_step_fft {name} {shape} {f}: kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms, torch.fft.fft {lib:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({by}, {bound_ms / ms:.1%} of it); "
              f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s, "
              f"{fft_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the FFT's "
              f"operations [{label}]")
        # the H100 profile prices the pass as its radix bound over fft_share
        est = planners["hopper"].stage_seconds(n, "c2c", b) * 1e3
        print(f"estimate four_step_fft {name} {shape}: {est:.3f} ms, "
              f"{est / ms:.2f}x the kernel's time [{label}]")
        if name == "rfftn column pass":
            check(1 / 1.5 <= est / ms <= 1.5, f"the estimate of the "
                  f"{name}, {est:.3f} ms, is not within 1.5x of {ms:.3f} ms")
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound_ms, bound_by=by)
        del xs, xc
    for block in main_move_blocks():
        xt = randn(block, gen)
        ms = time_ms(lambda: transpose(xt))
        plain = time_ms(lambda: transpose_ref(xt))
        nbytes = 2.0 * xt.numel() * xt.element_size()
        bound_ms, by = bound(0.0, nbytes)
        print(f"time batched_transpose {block} f32: kernel {ms:.3f} ms, "
              f"plain = library (x.transpose(-1,-2).contiguous()) "
              f"{plain:.3f} ms, bound {bound_ms:.3f} ms "
              f"({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) [{label}]")
        if block == (1,) + MAIN_SPECTRA[0]:     # the rfftn column pass's move
            out["transpose"] = dict(ms=ms, plain_ms=plain, library_ms=plain,
                                    bound_ms=bound_ms, bound_by=by)
        del xt
    return out


def phase_profile(label, calls, top: int = 10) -> list:
    """One traced run of each (name, call): device time by kernel (the
    ``top`` longest), and the device's busy share of the call's wall
    time. Returns (wall ms, busy ms, device ops) of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = []
    for name, run in calls:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        ops = sum(e.count for e in rows)
        print(f"profile {name}: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), {ops} device "
              f"ops [{label}]")
        for e in rows[:top]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                  f"{e.key[:90]}")
        out.append((wall_ms, busy_ms, ops))
    return out


# ---------------------------------------------------------------------------
# the FFT convolution: complex multiply, fused kernel, mixer
# ---------------------------------------------------------------------------


def cmul_error(a, b, block: int = 1024) -> float:
    """max |kernel - plain| of one complex multiply on the card."""
    from repro_torch.kernels.twiddle import (complex_multiply,
                                             complex_multiply_ref)
    k = complex_multiply(a, b, block=block)
    r = complex_multiply_ref(a, b)
    torch.cuda.synchronize()
    check(k[0].shape == r[0].shape == a[0].shape,
          f"complex_multiply {tuple(a[0].shape)} shape")
    return max((k[0] - r[0]).abs().max().item(),
               (k[1] - r[1]).abs().max().item())


def fused_error(x, h, factors, block_rows: int = 8):
    """(max |kernel - plain|, max |plain|) of one fused FFT convolution on
    the card; the plain version runs the kernel's schedule on torch.matmul."""
    from repro_torch.kernels.fftconv import fftconv_fused
    from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                                 filter_spectrum_plain)
    k = fftconv_fused(x, h, factors, block_rows=block_rows)
    r = fftconv_fused_plain(x, filter_spectrum_plain(h, factors), factors)
    torch.cuda.synchronize()
    check(k.shape == r.shape == x.shape, f"fftconv_fused {factors} shape")
    return (k - r).abs().max().item(), r.abs().max().item()


def decaying_filter(n: int, gen) -> torch.Tensor:
    return randn((n,), gen) * torch.exp(
        -torch.arange(n, device="cuda", dtype=torch.float32) / 64)


def conv_blocks(nf: int, b: int = MIXER_B, length: int = MIXER_S,
                d: int = MIXER_D):
    """What fft_conv hands the kernels on a mixer's path of ``d`` channels:
    the four-step (permuted) gets the padded activations (B, D, nf) and
    filters (D, nf); the transpose gets two views, v (B, L, D), the first
    half of x @ w_in (B, L, 2D), and the cropped output (B, D, L) of (B, D,
    nf), given here as (array shape, cropped shape)."""
    return (((b, d, nf), (d, nf)),
            (((b, length, 2 * d), (b, length, d)),
             ((b, d, nf), (b, d, length))))


def phase_conv_kernels(gen, factors, errs) -> dict:
    """The complex-multiply and fused kernels against their plain versions,
    and the four-step and transpose at the mixer path's blocks (added to
    ``errs``' entries for them); returns the max errors at the paths'
    shapes."""
    nf = factors[0] * factors[1]
    four_step_blocks, move_sources = conv_blocks(nf)
    for shape in four_step_blocks:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, factors, permuted=True)
        check(err <= 1e-4 * scale, f"four_step_fft {shape} {factors} "
              f"permuted (fft_conv): err {err} > 1e-4 * {scale}")
        errs["four_step_fft"][f"fft_conv {shape} permuted"] = err
        errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                          err / scale)
        del x
    for full, crop in move_sources:
        x = randn(full, gen)[tuple(slice(0, c) for c in crop)]
        errs["batched_transpose"][f"fft_conv {crop} view of {full}"] = \
            transpose_error(x)
        del x
    print(f"checked four_step_fft permuted at fft_conv's {four_step_blocks} "
          f"{factors} and batched_transpose (exact) at its moves of "
          f"{[crop for _, crop in move_sources]} (views)")
    cmul_cases = 0
    for a_shape, b_shape in CMUL_CASES:
        a = (randn(a_shape, gen), randn(a_shape, gen))
        b = (randn(b_shape, gen), randn(b_shape, gen))
        for block in CMUL_BLOCKS:
            err = cmul_error(a, b, block)
            check(err <= 1e-5, f"complex_multiply {a_shape} x {b_shape} "
                  f"block {block}: err {err} > 1e-5")
            cmul_cases += 1
    # views 4 bytes past a 16-byte boundary take the kernel's scalar path
    bufs = [randn((4 * 1024 + 1,), gen) for _ in range(4)]
    a = (bufs[0][1:].view(4, 1024), bufs[1][1:].view(4, 1024))
    b = (bufs[2][1:1025], bufs[3][1:1025])
    unaligned = cmul_error(a, b)
    check(unaligned <= 1e-5, f"complex_multiply unaligned: err {unaligned}")
    a = tuple(randn((MIXER_B, MIXER_D, nf), gen) for _ in "ri")
    b = tuple(randn((MIXER_D, nf), gen) for _ in "ri")
    cmul_path = cmul_error(a, b)
    check(cmul_path <= 1e-5, f"complex_multiply at the path's shape: err "
          f"{cmul_path} > 1e-5")
    del a, b

    worst = 0.0
    for f in FUSED_FACTORS:
        n = f[0] * f[1]
        for batch in FUSED_BATCHES:
            x, h = randn((batch, n), gen), decaying_filter(n, gen)
            for block_rows in FUSED_BLOCK_ROWS:
                err, scale = fused_error(x, h, f, block_rows)
                check(err <= 2e-4 * scale, f"fftconv_fused {f} batch {batch} "
                      f"block_rows {block_rows}: err {err} > 2e-4 * {scale}")
                worst = max(worst, err / scale)
    # rows one float past 16-byte alignment take the 4-byte copies
    buf, h = randn((7 * nf + 1,), gen), decaying_filter(nf, gen)
    err, scale = fused_error(buf[1:].view(7, nf), h, factors)
    check(err <= 2e-4 * scale, f"fftconv_fused unaligned (7, {nf}): err "
          f"{err} > 2e-4 * {scale}")
    worst = max(worst, err / scale)
    rows, f = FUSED_SHORT
    x, h = randn((rows, f[0] * f[1]), gen), decaying_filter(f[0] * f[1], gen)
    err, scale = fused_error(x, h, f)
    check(err <= 2e-4 * scale, f"fftconv_fused ({rows}, {f[0] * f[1]}): "
          f"err {err} > 2e-4 * {scale}")
    worst = max(worst, err / scale)
    x, h = randn((CONV_ROWS, nf), gen), decaying_filter(nf, gen)
    fused_path, scale = fused_error(x, h, factors)
    check(fused_path <= 2e-4 * scale, f"fftconv_fused ({CONV_ROWS}, {nf}): "
          f"err {fused_path} > 2e-4 * {scale}")
    del x, h, buf
    print(f"checked complex_multiply on {cmul_cases} shape x block cases, "
          f"an unaligned case (err {unaligned:.3e}) and ({MIXER_B}, "
          f"{MIXER_D}, {nf}) x ({MIXER_D}, {nf}) (err {cmul_path:.3e}, "
          f"limit 1e-5); fftconv_fused on {FUSED_FACTORS} x batch "
          f"{FUSED_BATCHES} x block_rows {FUSED_BLOCK_ROWS}, unaligned "
          f"rows and {FUSED_SHORT} (worst err/scale {worst:.3e}, limit "
          f"2e-4) and "
          f"({CONV_ROWS}, {nf}) {factors} (err {fused_path:.3e}, scale "
          f"{scale:.3e})")
    return {"complex_multiply": cmul_path, "fftconv_fused": fused_path,
            "fftconv_fused_worst_rel": worst}


def sharded_conv_blocks(planner):
    """What fft_conv_seq_sharded hands the kernels on the mixer's path at
    world size 1 (nf = 16384 split n1 x n2): the four-step gets the n1
    pass (moved last) and the n2 pass of the activations, (B, D, n2, n1)
    and (B, D, n1, n2), and of the filters, (D, n2, n1) and (D, n1, n2),
    with the planner's factors of n1 and of n2; the complex multiply gets
    the (n1, n2) twiddle against each (the spectrum product is
    fft_conv's); the transpose the n1 moves of each and back."""
    from repro_torch.core.fftconv import factor_split, next_fft_len
    n1, n2 = factor_split(next_fft_len(2 * MIXER_S), 1)
    f1 = planner.plan(n1, "c2c").factors
    f2 = planner.plan(n2, "c2c").factors
    leads = ((MIXER_B, MIXER_D), (MIXER_D,))
    four = [(lead + (n2, n1), f1) for lead in leads] \
        + [(lead + (n1, n2), f2) for lead in leads]
    cmul = [(lead + (n1, n2), (n1, n2)) for lead in leads]
    moves = [(math.prod(lead), a, b) for lead in leads
             for a, b in ((n1, n2), (n2, n1))]
    return four, cmul, moves


def phase_sharded_conv_kernels(gen, planner, errs) -> None:
    """The four-step, complex-multiply and transpose kernels against their
    plain versions at the blocks of the sharded mixer's path, added to
    ``errs``' entries for them."""
    four, cmul, moves = sharded_conv_blocks(planner)
    for shape, f in four:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, f)
        check(err <= 1e-4 * scale, f"four_step_fft {shape} {f} (sharded "
              f"conv): err {err} > 1e-4 * {scale}")
        errs["four_step_fft"][f"sharded conv {shape} {f}"] = err
        errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                          err / scale)
        del x
    for a_shape, b_shape in cmul:
        a = (randn(a_shape, gen), randn(a_shape, gen))
        b = (randn(b_shape, gen), randn(b_shape, gen))
        err = cmul_error(a, b)
        check(err <= 1e-5, f"complex_multiply {a_shape} x {b_shape} "
              f"(sharded conv): err {err} > 1e-5")
        errs["complex_multiply"] = max(errs["complex_multiply"], err)
        del a, b
    for block in moves:
        errs["batched_transpose"][f"sharded conv {block}"] = \
            transpose_error(randn(block, gen))
    print(f"checked four_step_fft at the sharded conv's {four}, "
          f"complex_multiply at its twiddles {cmul} (limit 1e-5) and "
          f"batched_transpose (exact) at its moves {moves}")


def phase_lm_kernels(gen, factors, errs, tp: int = 1) -> None:
    """The four-step, transpose and complex-multiply kernels against their
    plain versions at the blocks one prefill of the FFT-conv LM hands them
    (phase 15: one prompt of LM_PROMPT tokens, bfloat16 activations; with
    ``tp``, a rank's when its channels are cut ``tp`` ways, as on a (1,
    tp) mesh), added to ``errs``' entries for them."""
    nf = factors[0] * factors[1]
    four, moves = conv_blocks(nf, 1, LM_PROMPT, MIXER_D // tp)
    what = "LM prefill" if tp == 1 else f"LM prefill on (1, {tp})"
    for shape in four:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, factors, permuted=True)
        check(err <= 1e-4 * scale, f"four_step_fft {shape} {factors} "
              f"permuted ({what}): err {err} > 1e-4 * {scale}")
        errs["four_step_fft"][f"{what} {shape} permuted"] = err
        errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                          err / scale)
        del x
    # v is bfloat16 (x @ w_in in the compute dtype), the output float32
    for (full, crop), dtype in zip(moves, (torch.bfloat16, torch.float32)):
        x = randn(full, gen, dtype)[tuple(slice(0, c) for c in crop)]
        errs["batched_transpose"][f"{what} {crop} {dtype} view of "
                                  f"{full}"] = transpose_error(x)
        del x
    a = tuple(randn(four[0], gen) for _ in "ri")
    b = tuple(randn(four[1], gen) for _ in "ri")
    err = cmul_error(a, b)
    check(err <= 1e-5, f"complex_multiply {four[0]} x {four[1]} ({what}):"
          f" err {err} > 1e-5")
    errs["complex_multiply"] = max(errs["complex_multiply"], err)
    del a, b
    print(f"checked four_step_fft permuted at the {what}'s {four} "
          f"{factors}, batched_transpose (exact) at its moves of "
          f"{[crop for _, crop in moves]} (bfloat16, float32 views) and "
          f"complex_multiply at {four[0]} x {four[1]} (err {err:.3e}, limit "
          "1e-5)")


def phase_train_kernels(gen, factors, errs) -> None:
    """The four-step, transpose and complex-multiply kernels against their
    plain versions at the blocks a training step of the FFT-conv LM hands
    them (phase 17), added to ``errs``' entries for them: the bfloat16
    runs on TRAIN_B x TRAIN_S tokens and the float32 step on 1 x TRAIN_S.
    fft_conv's backward adds the output gradient's transform (B, D, nf),
    the move of that gradient, a contiguous (B, L, D) in the compute dtype,
    and the same-shape product of G with conj(U) (imaginary part negated)
    to the forward's blocks."""
    nf = factors[0] * factors[1]
    cmul = 0.0
    for batch, dtype in ((TRAIN_B, torch.bfloat16), (1, torch.float32)):
        four, moves = conv_blocks(nf, batch, TRAIN_S)
        for shape in four:
            x = (randn(shape, gen), randn(shape, gen))
            err, scale = four_step_error(x, factors, permuted=True)
            check(err <= 1e-4 * scale, f"four_step_fft {shape} {factors} "
                  f"permuted (training): err {err} > 1e-4 * {scale}")
            errs["four_step_fft"][f"training {shape} permuted"] = err
            errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                              err / scale)
            del x
        # v in the compute dtype, the cropped output and grad_u float32,
        # the output gradient contiguous in the compute dtype
        for (full, crop), dt in zip(moves, (dtype, torch.float32)):
            x = randn(full, gen, dt)[tuple(slice(0, c) for c in crop)]
            errs["batched_transpose"][f"training {crop} {dt} view of "
                                      f"{full}"] = transpose_error(x)
            del x
        g = randn((batch, TRAIN_S, MIXER_D), gen, dtype)
        errs["batched_transpose"][f"training {tuple(g.shape)} {dtype} "
                                  "output gradient"] = transpose_error(g)
        del g
        gf = tuple(randn(four[0], gen) for _ in "ri")
        for b in ((randn(four[1], gen), -randn(four[1], gen)),    # conj K
                  (randn(four[0], gen), -randn(four[0], gen))):   # conj U
            err = cmul_error(gf, b)
            check(err <= 1e-5, f"complex_multiply {four[0]} x "
                  f"{tuple(b[0].shape)} (training): err {err} > 1e-5")
            cmul = max(cmul, err)
            del b
        del gf
    errs["complex_multiply"] = max(errs["complex_multiply"], cmul)
    print(f"checked four_step_fft permuted, batched_transpose (exact) and "
          f"complex_multiply (worst err {cmul:.3e}, limit 1e-5) at the "
          f"training blocks of {TRAIN_B} x {TRAIN_S} (bfloat16) and 1 x "
          f"{TRAIN_S} (float32) tokens, the backward's output gradient "
          "moves and same-shape conj(U) G products included")


def mixer_reference(mixer, x) -> torch.Tensor:
    """The mixer's output in float64, its convolution by torch.fft."""
    v, gate, filt = mixer_parts(mixer, x)
    conv = causal_conv(v.double(), filt.double())
    return ((conv + v.double() * mixer.skip.double())
            * torch.nn.functional.silu(gate.double())) @ mixer.w_out.double()


def causal_conv(u, k) -> torch.Tensor:
    """torch.fft causal convolution of u (B, L, D) with k (D, L): rfft,
    multiply, irfft, in the inputs' precision."""
    length = u.shape[1]
    uf = torch.fft.rfft(u, n=2 * length, dim=1)
    kf = torch.fft.rfft(k, n=2 * length, dim=1).T
    return torch.fft.irfft(uf * kf, n=2 * length, dim=1)[:, :length]


def mixer_parts(mixer, x):
    """v, gate and the filters of one mixer call, as the mixer makes them."""
    from repro_torch.core.fftconv import materialize_filter
    v, gate = (x @ mixer.w_in).chunk(2, dim=-1)
    return v, gate, materialize_filter(mixer.filt, x.shape[1])


def phase_mixer(planner, gen):
    """FFTConvMixer at olmo-1b's width through the hopper planner, checked
    against float64; returns (launch counts of the call, mixer, input)."""
    from repro_torch import kernels
    from repro_torch.core.fftconv import fft_conv, next_fft_len
    from repro_torch.models import FFTConvMixer
    nf = next_fft_len(2 * MIXER_S)
    p = planner.plan(nf, "c2c", permuted=True)
    check(p.backend == "hopper" and p.factors == (128, 128),
          f"fft_conv's plan for nf={nf} is {p}, not hopper (128, 128)")
    print(f"plan c2c permuted n={nf}: {p.backend} {p.factors} (estimate, "
          "no wisdom)")
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED))
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    y = mixer(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"four_step_fft": 2, "batched_transpose": 2,
            "complex_multiply": 1, "fftconv_fused": 0}
    check(launches == want, f"mixer launches {launches}, expected {want}")
    check(y.shape == x.shape and torch.isfinite(y).all().item(),
          "mixer output shape or non-finite values")

    v, gate, filt = mixer_parts(mixer, x)
    conv = causal_conv(v.double(), filt.double())
    conv_ours = fft_conv(v, filt, planner=planner)
    conv_tol = 2e-4 * conv.abs().max().item()
    conv_err = (conv_ours.double() - conv).abs().max().item()
    check(conv_err <= conv_tol, f"fft_conv err {conv_err} > {conv_tol}")
    del conv_ours
    ref = ((conv + v.double() * mixer.skip.double())
           * torch.nn.functional.silu(gate.double())) @ mixer.w_out.double()
    del conv, v, gate
    tol = 2e-4 * ref.abs().max().item()
    err = (y.double() - ref).abs().max().item()
    check(err <= tol, f"mixer err {err} > {tol}")
    del ref, y
    print(f"mixer path: FFTConvMixer({MIXER_D}, {MIXER_RANK}) on "
          f"{tuple(x.shape)}: err {err:.4e} (tol {tol:.4e}); fft_conv err "
          f"{conv_err:.4e} (tol {conv_tol:.4e}); launches {launches}; "
          f"{seconds:.3f} s incl. first call; peak {peak / 2 ** 30:.2f} GiB")
    return launches, mixer, x


def phase_fused_path(gen, mixer, factors) -> dict:
    """The fused kernel's own entry, causal through 2x padding, on CONV_ROWS
    rows of CONV_L with one of the mixer's filters; returns its launches."""
    from repro_torch import kernels
    from repro_torch.core.fftconv import materialize_filter
    from repro_torch.kernels.fftconv import fftconv_fused
    h = materialize_filter(mixer.filt[:1], CONV_L)[0]
    x = randn((CONV_ROWS, CONV_L), gen)
    xp = torch.nn.functional.pad(x, (0, CONV_L))
    hp = torch.nn.functional.pad(h, (0, CONV_L))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = fftconv_fused(xp, hp, factors)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {"four_step_fft": 1, "batched_transpose": 0,
            "complex_multiply": 0, "fftconv_fused": 1}
    check(launches == want, f"fftconv_fused launches {launches}, "
          f"expected {want}")
    ref = torch.fft.irfft(torch.fft.rfft(x.double(), n=2 * CONV_L)
                          * torch.fft.rfft(h.double(), n=2 * CONV_L),
                          n=2 * CONV_L)[:, :CONV_L]
    tol = 2e-4 * ref.abs().max().item()
    err = (y[:, :CONV_L].double() - ref).abs().max().item()
    check(err <= tol and torch.isfinite(y).all().item(),
          f"causal fftconv_fused err {err} > {tol}")
    print(f"fused path: fftconv_fused causal on ({CONV_ROWS}, {CONV_L}) "
          f"padded to {2 * CONV_L}, factors {factors}: err {err:.4e} (tol "
          f"{tol:.4e}); launches {launches} (the four-step one is the "
          "filter's spectrum)")
    return launches


def fused_kernel_call(x, h, factors):
    """A call of the fused kernel's library alone on x (rows, n) with h's
    permuted spectrum made once: the kernel's time without the filter
    spectrum's four-step launch, which ``fftconv_fused`` adds. Not
    counted."""
    from repro_torch.kernels.dft_matmul import ops as dft_ops
    from repro_torch.kernels.fftconv import binding
    from repro_torch.kernels.fftconv.ops import filter_spectrum_permuted
    y = torch.empty_like(x)
    spec = dft_ops.interleaved(filter_spectrum_permuted(h, factors))
    r1, tw, r2 = dft_ops.tables(*factors, x.device)
    lib = binding.lib()

    def call():
        rc = lib.fftconv_fused(x.data_ptr(), spec.data_ptr(), r1.data_ptr(),
                               tw.data_ptr(), r2.data_ptr(), y.data_ptr(),
                               x.shape[0], factors[0], factors[1], 8,
                               torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fftconv_fused library call: code {rc}")
        return y
    return call


def phase_conv_times(label, planners, mixer, x, factors, gen) -> dict:
    from repro_torch.calibrate import time_ms
    from repro_torch.core.fftconv import fft_conv
    from repro_torch.kernels.fftconv import fftconv_fused
    from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                                 filter_spectrum_plain)
    from repro_torch.kernels.twiddle import (complex_multiply,
                                             complex_multiply_ref)
    v, gate, filt = mixer_parts(mixer, x)

    def mixer_lib():
        vv, gg, ff = mixer_parts(mixer, x)
        y = causal_conv(vv, ff) + vv * mixer.skip
        return (y * torch.nn.functional.silu(gg)) @ mixer.w_out

    ms = {}
    for name, p in planners.items():
        mixer.planner = p
        ms[f"mixer {name}"] = time_ms(lambda: mixer(x))
        ms[f"fft_conv {name}"] = time_ms(lambda p=p: fft_conv(v, filt,
                                                              planner=p))
    mixer.planner = planners["hopper"]
    ms["mixer with torch.fft conv"] = time_ms(mixer_lib)
    ms["fft_conv torch.fft (rfft, multiply, irfft)"] = time_ms(
        lambda: causal_conv(v, filt))
    print("time FFT conv at " + str(tuple(x.shape)) + ": " + ", ".join(
        f"{k} {t:.3f} ms" for k, t in ms.items()) + f" [{label}]")
    del v, gate, filt

    out = {}
    b_, d_, nf = MIXER_B, MIXER_D, factors[0] * factors[1]
    a = (randn((b_, d_, nf), gen), randn((b_, d_, nf), gen))
    b = (randn((d_, nf), gen), randn((d_, nf), gen))
    kt = time_ms(lambda: complex_multiply(a, b))
    plain = time_ms(lambda: complex_multiply_ref(a, b))
    ac, bc = torch.complex(*a), torch.complex(*b)
    lib = time_ms(lambda: ac * bc)
    # each input read once, the output written once: a, b and o pairs
    nbytes = 4.0 * (2 * a[0].numel() + 2 * b[0].numel() + 2 * a[0].numel())
    bound_ms, by = bound(6.0 * a[0].numel(), nbytes)
    print(f"time complex_multiply {tuple(a[0].shape)} x {tuple(b[0].shape)}: "
          f"kernel {kt:.3f} ms ({nbytes / (kt * 1e-3) / 1e12:.2f} TB/s), "
          f"plain {plain:.3f} ms, library (complex64 a * b) {lib:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({by}) [{label}]")
    out["complex_multiply"] = dict(ms=kt, plain_ms=plain, library_ms=lib,
                                   bound_ms=bound_ms, bound_by=by)
    del a, b, ac, bc

    for rows, f in ((CONV_ROWS, factors), FUSED_SHORT):
        n = f[0] * f[1]
        xs, h = randn((rows, n), gen), decaying_filter(n, gen)
        alone = fused_kernel_call(xs, h, f)
        kt = time_ms(alone)
        kf = time_ms(lambda: fftconv_fused(xs, h, f))
        plain = time_ms(lambda: fftconv_fused_plain(
            xs, filter_spectrum_plain(h, f), f))
        comp = time_ms(lambda: torch.fft.irfft(
            torch.fft.rfft(xs) * torch.fft.rfft(h), n=n))
        # the function: a length-n FFT and inverse per row and the product,
        # one f32 read and write per point
        fft_flops = (2 * 5.0 * n * math.log2(n) + 6.0 * n) * rows
        nbytes = 8.0 * rows * n
        bound_ms, by = bound(fft_flops, nbytes)
        print(f"time fftconv_fused ({rows}, {n}) {f}: kernel {kt:.3f} ms "
              f"({bound_ms / kt:.1%} of the bound; {kf:.3f} ms with the "
              f"filter spectrum's one-row four-step launch), plain "
              f"{plain:.3f} ms, torch.fft composition (rfft, multiply, "
              f"irfft; no single library call) {comp:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({by}); "
              f"{nbytes / (kt * 1e-3) / 1e12:.2f} TB/s, "
              f"{fft_flops / (kt * 1e-3) / 1e12:.2f} TFLOP/s of the FFT's "
              f"operations [{label}]")
        if rows == CONV_ROWS:       # the path's shape: the kernel's line
            out["fftconv_fused"] = dict(ms=kt, plain_ms=plain,
                                        library_ms=None, bound_ms=bound_ms,
                                        bound_by=by)
        del xs, h, alone
    return out


# ---------------------------------------------------------------------------
# the paper's shared-memory variants (Figs. 1 and 2)
# ---------------------------------------------------------------------------


def variant_runs(planner) -> list:
    """(name, call on x) of every variant, and of the composed stages."""
    from repro_torch.core import variants

    def staged(x):
        val = x
        for _, stage in variants.staged_for_loop(x, planner):
            val = stage(val)
        return val

    return [(name, lambda x, name=name: variants.run_variant(name, x,
                                                             planner))
            for name in VARIANT_ORDER] + [("staged", staged)]


def phase_variants(planner, gen) -> dict:
    """Every variant at VARIANT_N^2 against float64 torch.fft.rfft2, with
    the launches of each call alone; returns them by name."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.variants import shrink_task_size
    n = VARIANT_N
    mh = n // 2 + 1
    rows, cols = shrink_task_size(n, 8), shrink_task_size(mh, 8)
    print(f"variants at {n}^2, task_size 8: {n // rows} row tasks of {rows} "
          f"rows (future_naive, future_opt), {mh // cols} column tasks of "
          f"{cols} columns (future_opt)")
    x = randn((n, n), gen)
    ref = torch.fft.rfft2(x.double())
    scale = ref.abs().max().item()
    tol = 2e-4 * scale
    spec = repro_torch.rfftn(x, planner=planner)
    out = {}
    for name, run in variant_runs(planner):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        y = run(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {"four_step_fft": 1,
                "batched_transpose": VARIANT_TRANSPOSES[name],
                "complex_multiply": 0, "fftconv_fused": 0}
        check(launches == want, f"variant {name} launches {launches}, "
              f"expected {want}")
        check(all(tuple(t.shape) == (n, mh) and t.is_contiguous()
                  and torch.isfinite(t).all().item() for t in y),
              f"variant {name}: output shape, layout or non-finite values")
        err = max_err(y, ref)
        check(err <= tol, f"variant {name} {n}^2 err {err} > {tol}")
        line = f"variant {name} {n}^2: err {err:.4e} (tol {tol:.4e})"
        if name == "for_loop":
            agree = max((y[0] - spec[0]).abs().max().item(),
                        (y[1] - spec[1]).abs().max().item())
            check(agree <= 1e-6 * scale, f"for_loop differs from rfftn by "
                  f"{agree} > 1e-6 * {scale}")
            line += f", from rfftn {agree:.3e} (limit {1e-6 * scale:.3e})"
        print(f"{line}; {seconds:.3f} s, first call")
        out[name] = {k: launches[k] for k in ("four_step_fft",
                                               "batched_transpose")}
        del y
    print("variant launches " + json.dumps(out))
    return out


def time_variant(fn, reps: int):
    """(median CUDA-event ms, median wall ms) of ``reps`` runs of ``fn``
    after one warm-up run; the host waits for each run to end."""
    fn()
    torch.cuda.synchronize()
    device_ms, wall_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    return statistics.median(device_ms), statistics.median(wall_ms)


def phase_variant_times(label, planner, gen) -> None:
    """The card's Fig. 1 (sizes, task sizes) and Fig. 2 (stages), and the
    profiles of for_loop and future_naive at TASK_SWEEP_N^2."""
    from repro_torch.core import variants
    fig1 = {}
    for n in VARIANT_SIZES:
        x = randn((n, n), gen)
        for name in VARIANT_ORDER:
            reps = 1 if name in CHUNKED else 10
            ms, wall = time_variant(
                lambda: variants.run_variant(name, x, planner), reps)
            fig1[name, n] = ms
            print(f"time variant {name} {n}^2: {ms:.3f} ms (wall {wall:.3f} "
                  f"ms; median of {reps}), {ms / fig1['for_loop', n]:.2f}x "
                  f"for_loop [{label}]")
        del x
    n = TASK_SWEEP_N
    x = randn((n, n), gen)
    for ts in TASK_SIZES:
        ms, wall = time_variant(lambda: variants.run_variant(
            "future_naive", x, planner, task_size=ts), 1)
        tasks = n // variants.shrink_task_size(n, ts)
        print(f"time future_naive {n}^2 task_size {ts} ({tasks} tasks): "
              f"{ms:.3f} ms (wall {wall:.3f} ms), "
              f"{ms / fig1['for_loop', n]:.2f}x for_loop [{label}]")
    phase_profile(label, [
        (f"variant for_loop {n}^2",
         lambda: variants.run_variant("for_loop", x, planner)),
        (f"variant future_naive {n}^2 task_size 8",
         lambda: variants.run_variant("future_naive", x, planner))])
    del x
    n = VARIANT_N
    x = randn((n, n), gen)
    val, total = x, 0.0
    for name, stage in variants.staged_for_loop(x, planner):
        ms, wall = time_variant(lambda: stage(val), 10)
        print(f"time stage {name} {n}^2: {ms:.3f} ms (wall {wall:.3f} ms) "
              f"[{label}]")
        total += ms
        val = stage(val)
    del val
    fused, wall = time_variant(
        lambda: variants.run_variant("for_loop", x, planner), 10)
    print(f"time stages {n}^2: sum {total:.3f} ms, for_loop {fused:.3f} ms "
          f"(wall {wall:.3f} ms), stage_sum_over_fused "
          f"{total / fused:.3f} [{label}]")


# ---------------------------------------------------------------------------
# the distributed layer on NCCL at world size 1 (phases 9 and 10)
# ---------------------------------------------------------------------------


def start_nccl():
    """NCCL at world size 1 on a loopback TCPStore (an OS-chosen port), and
    the port's (1,) "fft" and (1, 1) ("mx", "my") meshes on the card."""
    import datetime
    import torch.distributed as dist
    from repro_torch import make_mesh
    timeout = datetime.timedelta(seconds=120)
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=timeout)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timeout)
    return (make_mesh((1,), ("fft",), timeout=timeout),
            make_mesh((1, 1), ("mx", "my"), timeout=timeout), store)


def dist_runs(planner, m1, m11) -> list:
    """(name, plan, mesh) of every run of phases 9 and 10: forced
    decompositions through the hopper planner."""
    from repro_torch import plan_nd
    s = (DIST_SLAB_N,) * 2
    runs = [(f"slab r2c {DIST_SLAB_N}^2 comm={c}",
             plan_nd(s, "r2c", mesh=m1, decomp="slab", comm=c,
                     planner=planner), m1) for c in DIST_SLAB_COMMS]
    runs.append((f"slab r2c {DIST_SLAB_N}^2 transposed",
                 plan_nd(s, "r2c", mesh=m1, decomp="slab",
                         output_layout="transposed", planner=planner), m1))
    runs.append((f"pencil c2c {DIST_PENCIL_N}^3",
                 plan_nd((DIST_PENCIL_N,) * 3, "c2c", mesh=m11,
                         decomp="pencil", planner=planner), m11))
    runs.append((f"factor1d c2c 2^{DIST_FACTOR1D_LOG2}",
                 plan_nd((1 << DIST_FACTOR1D_LOG2,), "c2c", mesh=m1,
                         decomp="factor1d", planner=planner), m1))
    return runs


def dist_input(decomp: str, gen):
    """The full input of a decomposition's run (the same on every rank)."""
    if decomp == "slab":
        return randn((DIST_SLAB_N,) * 2, gen)
    shape = (DIST_PENCIL_N,) * 3 if decomp == "pencil" \
        else (1 << DIST_FACTOR1D_LOG2,)
    return randn(shape, gen), randn(shape, gen)


def dist_reference(nd, data):
    """float64 torch.fft of the whole input."""
    if nd.kind == "r2c":
        return torch.fft.rfftn(data.double())
    zc = torch.complex(data[0].double(), data[1].double())
    return torch.fft.fftn(zc)


def phase_distributed(planner, gen, m1, m11) -> dict:
    """Every distributed run forward and back through the public entry
    points on this rank's block, collected and held against float64
    torch.fft; returns the launch counts of each run alone."""
    from repro_torch import (collect, distribute, fftn, ifftn, irfftn,
                             kernels, rfftn)
    out, inputs, refs = {}, {}, {}
    for name, nd, mesh in dist_runs(planner, m1, m11):
        if nd.decomp not in inputs:
            inputs.clear()
            refs.clear()
            torch.cuda.empty_cache()
            inputs[nd.decomp] = dist_input(nd.decomp, gen)
            refs[nd.decomp] = dist_reference(nd, inputs[nd.decomp])
        data, ref = inputs[nd.decomp], refs[nd.decomp]
        local = distribute(data, nd, mesh)
        forward, inverse = (rfftn, irfftn) if nd.kind == "r2c" \
            else (fftn, ifftn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        spec = forward(local, mesh=mesh, plan=nd, planner=planner)
        back = inverse(spec, mesh=mesh, plan=nd, planner=planner)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = DIST_LAUNCHES[nd.decomp]
        check(launches == want, f"{name}: launches {launches}, expected "
              f"{want}")
        full = collect(spec, nd, mesh)
        check(tuple(full[0].shape) == tuple(ref.shape), f"{name}: shape "
              f"{tuple(full[0].shape)}, want {tuple(ref.shape)}")
        tol = 2e-4 * ref.abs().max().item()
        err = max_err(full, ref)
        check(err <= tol, f"{name}: err {err} > {tol}")
        back = collect(back, nd, mesh, spatial=True)
        if nd.kind == "r2c":
            scale = data.abs().max().item()
            rt = (back - data).abs().max().item()
        else:
            scale = max(d.abs().max().item() for d in data)
            rt = max((b - d).abs().max().item() for b, d in zip(back, data))
        check(rt <= 2e-4 * scale, f"{name}: round trip err {rt} > "
              f"{2e-4 * scale}")
        check(all(torch.isfinite(t).all().item() for t in full),
              f"{name}: non-finite output")
        print(f"dist {name}: comm {nd.comm}, err {err:.4e} (tol {tol:.4e}), "
              f"round trip {rt:.3e} (tol {2e-4 * scale:.3e}); launches "
              f"{launches}; {seconds:.3f} s incl. first calls; peak "
              f"{peak / 2 ** 30:.2f} GiB")
        out[name] = launches
        del local, spec, back, full
    del refs, inputs
    torch.cuda.empty_cache()
    print("dist launches " + json.dumps(out))
    return out


def phase_distributed_times(label, planner, gen, m1, m11) -> dict:
    """Medians of 10 CUDA-event timed forward calls of every distributed
    run beside the local plan of the same shape (before and after them),
    the NCCL call cost at world size 1, and one traced slab call."""
    import repro_torch
    from repro_torch import distribute, fftn, rfftn
    from repro_torch.calibrate import collective_latency
    from repro_torch.core import dfft
    inputs = {d: dist_input(d, gen) for d in ("slab", "pencil", "factor1d")}
    x, z = inputs["slab"], inputs["pencil"]
    zc = torch.complex(*inputs["factor1d"])
    local_runs = {
        "slab": ("local rfftn", lambda: rfftn(x, planner=planner)),
        "pencil": ("local fftn", lambda: fftn(z, planner=planner)),
        "factor1d": ("torch.fft.fft (no local plan: the planner splits n "
                     "into at most three factors of at most 128)",
                     lambda: torch.fft.fft(zc))}
    times, base = {}, {}
    runs = dist_runs(planner, m1, m11)
    for name, nd, mesh in runs:
        if nd.decomp not in base:
            what, fn = local_runs[nd.decomp]
            base[nd.decomp] = [time_variant(fn, 10)[0]]
            print(f"time dist baseline {nd.decomp} {what}: "
                  f"{base[nd.decomp][0]:.3f} ms [{label}]")
        local = distribute(inputs[nd.decomp], nd, mesh)
        forward = rfftn if nd.kind == "r2c" else fftn
        ms, wall = time_variant(lambda: forward(local, mesh=mesh, plan=nd,
                                                planner=planner), 10)
        times[name] = ms
        print(f"time dist {name}: {ms:.3f} ms (wall {wall:.3f} ms), "
              f"{ms - base[nd.decomp][0]:+.3f} ms over the baseline "
              f"[{label}]")
        del local
    for decomp, (what, fn) in local_runs.items():
        again = time_variant(fn, 10)[0]
        base[decomp].append(again)
        print(f"time dist baseline {decomp} again: {again:.3f} ms [{label}]")
    dev = torch.device("cuda", torch.cuda.current_device())
    lat_runs = [collective_latency(dev) for _ in range(5)]
    lat = statistics.median(lat_runs)
    print(f"time nccl all_to_all_single 1 KiB world size 1: "
          f"{lat * 1e6:.2f} us a call (median of 5 runs of 200: "
          f"{', '.join(f'{r * 1e6:.2f}' for r in lat_runs)} us) [{label}]")
    # the factor1d twiddle: one block built alone, and the forward call with
    # both built anew in every call (as before they were cached)
    twiddle = dfft._factor1d_twiddle_block
    f_name, f_nd, f_mesh = runs[-1]
    n1, n2 = f_nd.factors
    tw_ms = time_variant(lambda: twiddle.__wrapped__(
        n1, n2, 0, 1, -1, chunk_axis=1, device=dev), 10)[0]
    f_local = distribute(inputs["factor1d"], f_nd, f_mesh)

    def factor1d_uncached():
        twiddle.cache_clear()
        fftn(f_local, mesh=f_mesh, plan=f_nd, planner=planner)

    uncached = time_variant(factor1d_uncached, 10)[0]
    print(f"time dist factor1d twiddle block ({n1}, {n2}) alone: "
          f"{tw_ms:.3f} ms; {f_name} with the twiddle built in every call: "
          f"{uncached:.3f} ms, cached {times[f_name]:.3f} ms [{label}]")
    name, nd, mesh = runs[0]
    local = distribute(x, nd, mesh)
    phase_profile(label, [
        (f"dist {name}", lambda: repro_torch.rfftn(
            local, mesh=mesh, plan=nd, planner=planner)),
        (f"dist {f_name}", lambda: fftn(f_local, mesh=f_mesh, plan=f_nd,
                                        planner=planner))])
    del inputs, x, z, zc, local, f_local
    twiddle.cache_clear()
    torch.cuda.empty_cache()
    return {"times": times, "baselines": base, "nccl_call_s": lat,
            "twiddle_ms": tw_ms, "factor1d_uncached_ms": uncached}


def plan_verdicts(planner, m1, m11) -> None:
    """plan_nd's free verdicts at the chip shapes on the one card, in
    estimate and in measured mode; raises where they differ."""
    from repro_torch import plan_nd
    for shape, kind, mesh in (((DIST_SLAB_N,) * 2, "r2c", m1),
                              ((DIST_PENCIL_N,) * 3, "c2c", m11),
                              ((1 << DIST_FACTOR1D_LOG2,), "c2c", m1)):
        got = {mode: plan_nd(shape, kind, mesh=mesh, mode=mode,
                             planner=planner)
               for mode in ("estimate", "measured")}
        verdicts = {mode: (nd.decomp, nd.mesh_axes, nd.comm)
                    for mode, nd in got.items()}
        check(verdicts["estimate"] == verdicts["measured"],
              f"plan_nd {shape} {kind}: {verdicts}")
        print(f"plan_nd {shape} {kind} on {mesh.mesh_dim_names}: estimate "
              f"{verdicts['estimate']} ({got['estimate'].est_cost * 1e3:.3f}"
              f" ms est), measured {verdicts['measured']}")


def counted(fn):
    """(fn's value, kernel launches of the call alone, its seconds)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    val = fn()
    torch.cuda.synchronize()
    return val, kernels.launch_counts(), time.perf_counter() - t0


def phase_sharded_mixer(label, planner, gen, m1) -> dict:
    """FFTConvMixer at olmo-1b's width with the sequence sharded over the
    (1,) mesh, every exchange setting, against the unsharded mixer and
    float64, then timed beside the unsharded mixer."""
    from repro_torch.models import FFTConvMixer
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=m1, axis="fft")
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    out = {}
    with torch.no_grad():
        local = mixer(x)
        ref = mixer_reference(mixer, x)
        tol_l = 2e-4 * local.abs().max().item()
        tol_r = 2e-4 * ref.abs().max().item()
        for comm in SHARDED_COMMS:
            mixer.comm = comm
            torch.cuda.reset_peak_memory_stats()
            y, launches, seconds = counted(
                lambda: mixer(x, seq_axis_sharded=True))
            peak = torch.cuda.max_memory_allocated()
            check(launches == SHARDED_LAUNCHES, f"sharded mixer {comm}: "
                  f"launches {launches}, expected {SHARDED_LAUNCHES}")
            err_l = (y - local).abs().max().item()
            err_r = (y.double() - ref).abs().max().item()
            check(err_l <= tol_l and err_r <= tol_r
                  and torch.isfinite(y).all().item(),
                  f"sharded mixer {comm}: err {err_l} (tol {tol_l}) against "
                  f"the unsharded mixer, {err_r} (tol {tol_r}) against "
                  "float64")
            print(f"sharded mixer FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
                  f"{tuple(x.shape)} on (1,) comm={comm}: err {err_l:.4e} "
                  f"against the unsharded mixer (tol {tol_l:.4e}), "
                  f"{err_r:.4e} against float64 (tol {tol_r:.4e}); "
                  f"launches {launches}; {seconds:.3f} s incl. first call; "
                  f"peak {peak / 2 ** 30:.2f} GiB")
            out[comm] = launches
            del y
        del ref
        times = {"unsharded": time_variant(lambda: mixer(x), 10)[0]}
        for comm in SHARDED_COMMS:
            mixer.comm = comm
            times[comm] = time_variant(
                lambda: mixer(x, seq_axis_sharded=True), 10)[0]
        times["unsharded again"] = time_variant(lambda: mixer(x), 10)[0]
        print(f"time sharded mixer {tuple(x.shape)} on (1,): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()) + f" [{label}]")
        mixer.comm = "collective"
        phase_profile(label, [("sharded mixer on (1,) collective",
                               lambda: mixer(x, seq_axis_sharded=True))])
    del mixer, x, local
    torch.cuda.empty_cache()
    return {"launches": out, "times": times}


def fwd_back(forward, inverse):
    spec = forward()
    return spec, inverse(spec)


def phase_shims(label, planner, gen, m1, m11) -> dict:
    """The six deprecated shims at the chip shapes on the one card: each
    forward equal to the plan_nd path on the same block, within
    2e-4*max|ref| of float64 torch.fft, its round trip within 2e-4*max|x|,
    and the launches of shim forward and back those of the plan_nd
    path's."""
    import warnings
    from repro_torch import fftn, ifftn, irfftn, plan_nd, rfftn
    from repro_torch.core import dfft
    out = {}

    def report(name, same, err, tol, rt, x_tol, launches, base, seconds,
               exact=True):
        check(launches == base, f"{name}: launches {launches}, the plan_nd "
              f"path's {base}")
        check(same == 0.0 if exact else same <= tol, f"{name}: differs "
              f"from the plan_nd path by {same}")
        check(err <= tol, f"{name}: err {err} > {tol}")
        check(rt <= x_tol, f"{name}: round trip err {rt} > {x_tol}")
        print(f"shim {name}: err {err:.4e} (tol {tol:.4e}), from the "
              f"plan_nd path {same:.3e}, round trip {rt:.3e} (tol "
              f"{x_tol:.3e}); launches {launches}; {seconds:.3f} s forward "
              f"and back [{label}]")
        out[name] = launches

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = DIST_SLAB_N
        x = randn((n, n), gen)
        nd = plan_nd(x.shape, "r2c", mesh=m1, decomp="slab",
                     comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: rfftn(x, mesh=m1, plan=nd, planner=planner),
            lambda c: irfftn(c, mesh=m1, plan=nd, planner=planner)))
        ref = torch.fft.rfft2(x.double())
        tol, x_tol = 2e-4 * ref.abs().max().item(), \
            2e-4 * x.abs().max().item()
        # row k1*n2 + k2 of permuted columns holds frequency k2*n1 + k1
        n1, n2 = planner.plan(n, "c2c", permuted=True).factors
        perm = torch.arange(n, device="cuda").view(n2, n1).T.reshape(-1)
        for flags in ({}, {"keep_transposed": True},
                      {"permuted_cols": True}):
            kt = flags.get("keep_transposed", False)
            pc = flags.get("permuted_cols", False)
            (spec, back), launches, seconds = counted(lambda: fwd_back(
                lambda: dfft.fft2_slab(x, m1, "fft", planner, **flags),
                lambda c: dfft.ifft2_slab(c, m1, "fft", n, planner,
                                          from_transposed=kt,
                                          permuted_cols=pc)))
            got = tuple(t.T for t in spec) if kt else spec
            expect = tuple(t[perm] for t in want) if pc else want
            same = max((a - b).abs().max().item()
                       for a, b in zip(got, expect))
            err = max_err(got, ref[perm] if pc else ref)
            rt = (back - x).abs().max().item()
            report(f"fft2_slab/ifft2_slab r2c {n}^2 on (1,) "
                   f"{','.join(flags) or 'no flag'}", same, err, tol, rt,
                   x_tol, launches, base, seconds, exact=not pc)
            del spec, back, got, expect
        del x, want, ref
        torch.cuda.empty_cache()

        shape, axes = (DIST_PENCIL_N,) * 3, ("mx", "my")
        z = dist_input("pencil", gen)
        ndc = plan_nd(shape, "c2c", mesh=m11, decomp="pencil",
                      comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: fftn(z, mesh=m11, plan=ndc, planner=planner),
            lambda c: ifftn(c, mesh=m11, plan=ndc, planner=planner)))
        (spec, back), launches, seconds = counted(lambda: fwd_back(
            lambda: dfft.fft3_pencil(z, m11, axes, planner),
            lambda c: dfft.ifft3_pencil(c, m11, axes, planner)))
        ref = torch.fft.fftn(torch.complex(z[0].double(), z[1].double()))
        report(f"fft3_pencil/ifft3_pencil c2c {DIST_PENCIL_N}^3 on (1, 1)",
               max((a - b).abs().max().item() for a, b in zip(spec, want)),
               max_err(spec, ref), 2e-4 * ref.abs().max().item(),
               max((b - a).abs().max().item() for a, b in zip(z, back)),
               2e-4 * max(a.abs().max().item() for a in z), launches, base,
               seconds)
        del z, want, spec, back, ref
        xr = randn(shape, gen)
        ndr = plan_nd(shape, "r2c", mesh=m11, decomp="pencil",
                      comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: rfftn(xr, mesh=m11, plan=ndr, planner=planner),
            lambda c: irfftn(c, mesh=m11, plan=ndr, planner=planner)))
        (spec, back), launches, seconds = counted(lambda: fwd_back(
            lambda: dfft.rfft3_pencil(xr, m11, axes, planner),
            lambda c: dfft.irfft3_pencil(c, m11, axes, DIST_PENCIL_N,
                                         planner)))
        ref = torch.fft.rfftn(xr.double())
        report(f"rfft3_pencil/irfft3_pencil r2c {DIST_PENCIL_N}^3 on (1, 1)",
               max((a - b).abs().max().item() for a, b in zip(spec, want)),
               max_err(spec, ref), 2e-4 * ref.abs().max().item(),
               (back - xr).abs().max().item(), 2e-4 * xr.abs().max().item(),
               launches, base, seconds)
        del xr, want, spec, back, ref
    torch.cuda.empty_cache()
    return out


def phase_psum(label, gen, m1) -> dict:
    """compressed_psum of a PSUM_N payload on the (1,) mesh, every gather
    backend, auto and measure: the sum is this rank's dequantized payload
    and the residual what quantization lost, exactly; then timed."""
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   dequantize_int8, quantize_int8)
    group = m1.get_group("fft")
    x = randn((PSUM_N,), gen)
    q, scale, pad = quantize_int8(x)
    deq = dequantize_int8(q, scale, pad, x.shape)
    out = {}
    for comm in PSUM_COMMS:
        spec = choose_psum_comm(m1, "fft", x.shape, mode=comm)
        total, err = compressed_psum(x, group, comm=spec)
        check(torch.equal(total, deq) and torch.equal(err, x - deq),
              f"compressed_psum {comm}: not the dequantized payload")
        ms = time_variant(lambda: compressed_psum(x, group, comm=spec),
                          10)[0]
        out[comm] = dict(spec=spec, ms=ms)
        print(f"psum compressed_psum {PSUM_N} f32 on (1,) comm={comm} -> "
              f"{spec}: the dequantized payload exactly (quantization "
              f"error {err.abs().max().item():.4e}, half step "
              f"{scale.float().max().item() / 2:.4e}); {ms:.3f} ms (median "
              f"of 10) [{label}]")
    del x, q, scale, deq
    return out


def gather_blocks(t, mesh, axes):
    """Every rank's block of ``t`` concatenated along each (tensor axis,
    mesh axis name) of ``axes`` in turn; every rank of the mesh calls it."""
    from repro_torch.core import comm
    for axis, name in axes:
        work, buf = comm._gather_start(t, mesh.get_group(name),
                                       comm.mesh_sizes(mesh)[name])
        work.wait()
        t = comm._unlead(buf, axis)
    return t


def gloo_sharded_mixer(rank, mesh, planner, gen) -> list:
    """Phase 12 over the gloo ranks: the mixer with its sequence sharded
    over (4,), each rank its block; rank 0 holds the gathered output
    against the unsharded mixer and float64. Returns rank 0's lines."""
    from repro_torch.models import FFTConvMixer
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=mesh, axis="fft")
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)     # the same on every rank
    w = MIXER_S // GLOO_RANKS
    block = x[:, rank * w:(rank + 1) * w].contiguous()
    with torch.no_grad():
        y, launches, seconds = counted(
            lambda: mixer(block, seq_axis_sharded=True))
        check(launches == SHARDED_LAUNCHES, f"gloo rank {rank} sharded "
              f"mixer: launches {launches}, expected {SHARDED_LAUNCHES}")
        ms = time_variant(lambda: mixer(block, seq_axis_sharded=True), 3)[0]
        full = gather_blocks(y, mesh, [(1, "fft")])
        if rank != 0:
            return []
        local = mixer(x)
        ref = mixer_reference(mixer, x)
    tol_l = 2e-4 * local.abs().max().item()
    tol_r = 2e-4 * ref.abs().max().item()
    err_l = (full - local).abs().max().item()
    err_r = (full.double() - ref).abs().max().item()
    check(err_l <= tol_l and err_r <= tol_r, f"gloo sharded mixer: err "
          f"{err_l} (tol {tol_l}) against the unsharded mixer, {err_r} (tol "
          f"{tol_r}) against float64")
    return [f"gloo{GLOO_RANKS} sharded mixer FFTConvMixer({MIXER_D}, "
            f"{MIXER_RANK}) {tuple(x.shape)} on (4,) (block "
            f"{tuple(block.shape)} a rank): err {err_l:.4e} against the "
            f"unsharded mixer (tol {tol_l:.4e}), {err_r:.4e} against float64 "
            f"(tol {tol_r:.4e}); rank 0 launches {launches}; {seconds:.3f} s "
            f"first call, {ms:.3f} ms (median of 3)"]


def gloo_shims(rank, meshes, planner, gen) -> list:
    """Phase 13 over the gloo ranks: fft2_slab/ifft2_slab r2c 16384^2 on
    (4,) with each legacy flag and the pencil shims 512^3 on (2, 2), each
    rank its block; rank 0 holds the gathered forward against the gathered
    plan_nd path and float64, and the gathered round trip against the
    input. Returns rank 0's lines."""
    import warnings
    from repro_torch import collect, distribute, fftn, plan_nd, rfftn
    from repro_torch.core import dfft
    m4, m22 = meshes["(4,)"], meshes["(2, 2)"]
    lines = []

    def report(name, got, want, ref, back, data):
        tol = 2e-4 * ref.abs().max().item()
        pair = isinstance(data, tuple)
        x_tol = 2e-4 * (max(a.abs().max().item() for a in data) if pair
                        else data.abs().max().item())
        same = max((a - b).abs().max().item() for a, b in zip(got, want))
        err = max_err(got, ref)
        rt = (max((a - b).abs().max().item() for a, b in zip(back, data))
              if pair else (back - data).abs().max().item())
        check(same <= tol and err <= tol and rt <= x_tol, f"gloo shim "
              f"{name}: from the plan_nd path {same}, err {err} (tol {tol}),"
              f" round trip {rt} (tol {x_tol})")
        lines.append(f"gloo{GLOO_RANKS} shim {name}: err {err:.4e} (tol "
                     f"{tol:.4e}), from the plan_nd path {same:.3e}, round "
                     f"trip {rt:.3e} (tol {x_tol:.3e})")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = DIST_SLAB_N
        x = randn((n, n), gen)                      # the same on every rank
        nd = plan_nd(x.shape, "r2c", mesh=m4, decomp="slab",
                     comm="collective", planner=planner)
        local = distribute(x, nd, m4)
        want = collect(rfftn(local, mesh=m4, plan=nd, planner=planner), nd,
                       m4)
        n1, n2 = planner.plan(n, "c2c", permuted=True).factors
        perm = torch.arange(n, device="cuda").view(n2, n1).T.reshape(-1)
        ref = torch.fft.rfft2(x.double()) if rank == 0 else None
        for flags in ({}, {"keep_transposed": True},
                      {"permuted_cols": True}):
            kt = flags.get("keep_transposed", False)
            pc = flags.get("permuted_cols", False)
            spec = dfft.fft2_slab(local, m4, "fft", planner, **flags)
            back = dfft.ifft2_slab(spec, m4, "fft", n, planner,
                                   from_transposed=kt, permuted_cols=pc)
            got = tuple(gather_blocks(t, m4, [(1 if kt else 0, "fft")])
                        for t in spec)
            back = gather_blocks(back, m4, [(0, "fft")])
            if rank == 0:
                if kt:      # the folded (w, 4 n) layout back to (n, 4 w)
                    w = got[0].shape[0]
                    got = tuple(t.view(w, GLOO_RANKS, n).permute(2, 1, 0)
                                .reshape(n, GLOO_RANKS * w) for t in got)
                got = tuple(t[:, :n // 2 + 1] for t in got)
                report(f"fft2_slab/ifft2_slab r2c {n}^2 on (4,) "
                       f"{','.join(flags) or 'no flag'}", got,
                       tuple(t[perm] for t in want) if pc else want,
                       ref[perm] if pc else ref, back, x)
            del spec, back, got
        del x, local, want, ref
        torch.cuda.empty_cache()

        shape, axes = (DIST_PENCIL_N,) * 3, ("mx", "my")
        z = dist_input("pencil", gen)
        xr = randn(shape, gen)
        for kind, data in (("c2c", z), ("r2c", xr)):
            nd = plan_nd(shape, kind, mesh=m22, decomp="pencil",
                         comm="collective", planner=planner)
            local = distribute(data, nd, m22)
            run = fftn if kind == "c2c" else rfftn
            want = collect(run(local, mesh=m22, plan=nd, planner=planner),
                           nd, m22)
            if kind == "c2c":
                spec = dfft.fft3_pencil(local, m22, axes, planner)
                back = dfft.ifft3_pencil(spec, m22, axes, planner)
                name = f"fft3_pencil/ifft3_pencil c2c {DIST_PENCIL_N}^3"
            else:
                spec = dfft.rfft3_pencil(local, m22, axes, planner)
                back = dfft.irfft3_pencil(spec, m22, axes, DIST_PENCIL_N,
                                          planner)
                name = f"rfft3_pencil/irfft3_pencil r2c {DIST_PENCIL_N}^3"
            got = collect(spec, nd, m22)
            back = collect(back, nd, m22, spatial=True)
            if rank == 0:
                report(name + " on (2, 2)", got, want,
                       dist_reference(nd, data), back, data)
            del local, want, spec, back, got
        del z, xr
    torch.cuda.empty_cache()
    return lines


def gloo_psum(rank, mesh) -> list:
    """Phase 14 over the gloo ranks: compressed_psum of a PSUM_N payload,
    each rank its own, every gather backend, auto and measure; rank 0
    holds the sum against the sum of the dequantized payloads (1e-6 of
    its max: the float32 order of the sum) and the exact sum (the
    reference's bounds). Returns rank 0's lines."""
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   dequantize_int8, quantize_int8)
    group = mesh.get_group("fft")
    xs = [torch.randn(PSUM_N, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 10 + r)) for r in range(GLOO_RANKS)]
    deq = sum(dequantize_int8(*quantize_int8(x), x.shape).double()
              for x in xs)
    exact = sum(x.double() for x in xs)
    lines = []
    for comm in PSUM_COMMS:
        spec = choose_psum_comm(mesh, "fft", (PSUM_N,), mode=comm)
        total, err = compressed_psum(xs[rank], group, comm=spec)
        ms = time_variant(lambda: compressed_psum(xs[rank], group,
                                                  comm=spec), 3)[0]
        if rank != 0:
            continue
        off = (total.double() - deq).abs().max().item()
        rel = ((total.double() - exact).abs() / (exact.abs() + 1e-3))
        med = rel.median().item()
        worst = err.abs().max().item()
        check(off <= 1e-6 * deq.abs().max().item() and med < 0.02
              and worst < 0.05, f"gloo compressed_psum {comm}: {off} from "
              f"the dequantized sum, median rel {med}, residual {worst}")
        lines.append(f"gloo{GLOO_RANKS} psum compressed_psum {PSUM_N} f32 a "
                     f"rank on (4,) comm={comm} -> {spec}: {off:.3e} from the "
                     f"sum of the dequantized payloads, median rel err "
                     f"{med:.3e} against the exact sum, residual "
                     f"{worst:.3e}; {ms:.3f} ms (median of 3)")
    return lines


def gloo_rank(rank: int, store_path: str, out_path: str) -> None:
    """gloo_rank_body, with any failure's traceback (an exit or a fatal
    signal included) written to ``out_path.rank<r>.err`` for
    phase_gloo_ranks to print."""
    import faulthandler
    import traceback
    err = Path(f"{out_path}.rank{rank}.err")
    with open(f"{err}.fatal", "w") as fatal:
        faulthandler.enable(file=fatal)
        try:
            gloo_rank_body(rank, store_path, out_path)
        except BaseException:
            err.write_text(traceback.format_exc())
            raise
        finally:
            faulthandler.disable()


def gloo_rank_body(rank: int, store_path: str, out_path: str) -> None:
    """One of GLOO_RANKS ranks on the one card, gloo carrying CUDA tensors:
    slab r2c DIST_SLAB_N^2 over (4,) and pencil c2c DIST_PENCIL_N^3 over
    (2, 2), forward and back, collected on every rank and held against
    float64 torch.fft on rank 0, which writes the results to out_path."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import (Planner, collect, distribute, fftn, ifftn,
                             irfftn, kernels, make_mesh, plan_nd, rfftn)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=300)
    dist.init_process_group("gloo", rank=rank, world_size=GLOO_RANKS,
                            store=dist.FileStore(store_path, GLOO_RANKS),
                            timeout=timeout)
    try:
        meshes = {"(4,)": make_mesh((4,), ("fft",), timeout=timeout,
                                    device_type="cuda"),
                  "(2, 2)": make_mesh((2, 2), ("mx", "my"), timeout=timeout,
                                      device_type="cuda")}
        planner = Planner(backends=("hopper",))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        runs = [(f"slab r2c {DIST_SLAB_N}^2", "(4,)", "slab", "r2c",
                 (DIST_SLAB_N,) * 2),
                (f"pencil c2c {DIST_PENCIL_N}^3", "(2, 2)", "pencil", "c2c",
                 (DIST_PENCIL_N,) * 3)]
        out = {}
        for name, mesh_name, decomp, kind, shape in runs:
            mesh = meshes[mesh_name]
            data = dist_input(decomp, gen)          # the same on every rank
            nd = plan_nd(shape, kind, mesh=mesh, decomp=decomp,
                         comm="collective", planner=planner)
            local = distribute(data, nd, mesh)
            forward, inverse = (rfftn, irfftn) if kind == "r2c" \
                else (fftn, ifftn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            spec = forward(local, mesh=mesh, plan=nd, planner=planner)
            back = inverse(spec, mesh=mesh, plan=nd, planner=planner)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = DIST_LAUNCHES[decomp]
            check(launches == want, f"gloo rank {rank} {name}: launches "
                  f"{launches}, expected {want}")
            full = collect(spec, nd, mesh)
            back = collect(back, nd, mesh, spatial=True)
            if rank == 0:
                ref = dist_reference(nd, data)
                tol = 2e-4 * ref.abs().max().item()
                err = max_err(full, ref)
                check(err <= tol, f"gloo {name} on {mesh_name}: err {err} "
                      f"> {tol}")
                del ref
                if kind == "r2c":
                    scale = data.abs().max().item()
                    rt = (back - data).abs().max().item()
                else:
                    scale = max(d.abs().max().item() for d in data)
                    rt = max((b - d).abs().max().item()
                             for b, d in zip(back, data))
                check(rt <= 2e-4 * scale, f"gloo {name} on {mesh_name}: "
                      f"round trip err {rt} > {2e-4 * scale}")
                out[name] = dict(mesh=mesh_name, block=list(local.shape if
                                 kind == "r2c" else local[0].shape),
                                 err=err, tol=tol, round_trip=rt,
                                 round_trip_tol=2e-4 * scale,
                                 seconds=seconds, launches=launches,
                                 peak_gib=peak / 2 ** 30)
            del data, local, spec, back, full
            torch.cuda.empty_cache()
        # phases 12-14 on the same ranks
        t0 = time.perf_counter()
        extra = gloo_sharded_mixer(rank, meshes["(4,)"], planner, gen)
        torch.cuda.empty_cache()
        extra += gloo_shims(rank, meshes, planner, gen)
        extra += gloo_psum(rank, meshes["(4,)"])
        t18 = time.perf_counter()
        torch.cuda.empty_cache()
        # phase 18 (c) and (d) on the same ranks
        extra += gloo_mesh_train(rank, meshes["(4,)"], planner, gen)
        t18d = time.perf_counter()
        torch.cuda.empty_cache()
        extra += gloo_placement(rank)
        t19 = time.perf_counter()
        torch.cuda.empty_cache()
        # phase 19 (b) on the same ranks
        extra += gloo_mesh_serve(rank, planner)
        t20 = time.perf_counter()
        torch.cuda.empty_cache()
        # phase 20 (b) on the same ranks
        extra += gloo_mesh_kinds(rank)
        t21 = time.perf_counter()
        torch.cuda.empty_cache()
        # phase 21 (b) on the same ranks
        extra += gloo_pipeline(rank)
        if rank == 0:
            extra.append(f"gloo{GLOO_RANKS} phases 12-14 took "
                         f"{t18 - t0:.1f} s, phase 18 (c) took "
                         f"{t18d - t18:.1f} s, phase 18 (d) took "
                         f"{t19 - t18d:.1f} s, phase 19 (b) took "
                         f"{t20 - t19:.1f} s, phase 20 (b) took "
                         f"{t21 - t20:.1f} s, phase 21 (b) took "
                         f"{time.perf_counter() - t21:.1f} s")
            Path(out_path).write_text(json.dumps({"runs": out,
                                                  "extra": extra}))
    finally:
        dist.destroy_process_group()


def phase_gloo_ranks() -> dict:
    """GLOO_RANKS processes on the one card over gloo (NCCL refuses two
    ranks on one GPU), started and joined here."""
    import tempfile
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "gloo.json")
        try:
            mp.start_processes(gloo_rank, args=(str(Path(tmp) / "store"),
                                                out_path),
                               nprocs=GLOO_RANKS, start_method="spawn")
        except Exception:
            for err in sorted(Path(tmp).glob("gloo.json.rank*.err*")):
                if err.stat().st_size:
                    print(f"phase 11 {err.name}:\n{err.read_text()}",
                          file=sys.stderr)
            raise
        out = json.loads(Path(out_path).read_text())
    for name, r in out["runs"].items():
        print(f"gloo{GLOO_RANKS} {name} on {r['mesh']} (block "
              f"{tuple(r['block'])} a rank): err {r['err']:.4e} (tol "
              f"{r['tol']:.4e}), round trip {r['round_trip']:.3e} (tol "
              f"{r['round_trip_tol']:.3e}); rank 0 launches {r['launches']},"
              f" peak {r['peak_gib']:.2f} GiB; {r['seconds']:.3f} s forward "
              "and back, first call")
    for line in out["extra"]:
        print(line)
    return out


# ---------------------------------------------------------------------------
# the LM serving path (phase 15)
# ---------------------------------------------------------------------------


def serve(model, cfg, prompts, planner=None, forced=None, new=SERVE_NEW,
          routing=None, control=None, cache32=False, max_len=None,
          mesh=None, batch=SERVE_BATCH) -> dict:
    """Serve ``prompts`` through ServeLoop (a batch of ``batch``, ``new``
    tokens each, caches of the prompt length + ``new``) on ``model``,
    keeping every logits row a request takes a token from. ``forced`` (rid
    -> tokens) feeds each request those tokens instead of its own argmax
    (teacher forcing). ``routing``: the list the MoE layers' routing is
    logged to (``moe_logged``); each request keeps that of the tokens it
    fed: its prompt's at its prefill, its own slot's at each decode step.
    ``control`` breaks the loop on purpose: "unmerged" never merges a
    prefill's cache into its slot (the slot keeps an empty cache),
    "frozen" undoes every decode step's writes to the cache (a recurrent
    state is never carried, a new token's k/v never kept). ``cache32``
    keeps the decode cache in float32 (``float32_cache``). ``max_len``:
    the caches' length (default the prompt's and ``new``); ``mesh``: the
    loop runs on it (``ServeLoop``'s mesh), ``model`` placed by it. Returns the
    rows, routing and tokens by request, the kernel launches of the
    drained run alone, the ms of each step that admitted no request, the
    run's seconds and its peak device memory."""
    from repro_torch import kernels
    from repro_torch.launch.serve import Request, ServeLoop
    rows, routes, decode_ms = {}, {}, []
    n_moe = sum(layer.kind == "attn_moe" for layer in model.layers)

    class Recorded(ServeLoop):
        def next_token(self, req, logits):
            rows.setdefault(req.rid, []).append(logits.clone())
            if routing is not None and n_moe:
                # the prompt's tokens after a prefill, the request's slot
                # after a decode step
                lo, hi = ((0, len(req.prompt)) if not req.out else
                          (self.slots.index(req), self.slots.index(req) + 1))
                routes.setdefault(req.rid, []).append(routing_rows(
                    routing[len(routing) - n_moe:], lo, hi))
            if forced is not None:
                return forced[req.rid][len(req.out)]
            return super().next_token(req, logits)

        def _merge(self, c1, i, true_len):
            if control == "unmerged":
                self.cache["len"][i] = true_len
            else:
                super()._merge(c1, i, true_len)

        def step(self):
            admits = bool(self.queue) and None in self.slots
            t0 = time.perf_counter()
            if control == "frozen":
                self._admit()
                kept = [{k: t.clone() for k, t in layer.items()}
                        for layer in self.cache["layers"]]
            super().step()
            if control == "frozen":
                for layer, old in zip(self.cache["layers"], kept):
                    for k, t in old.items():
                        layer[k].copy_(t)
            torch.cuda.synchronize()
            if not admits:
                decode_ms.append((time.perf_counter() - t0) * 1e3)

    loop = Recorded(cfg, batch, max_len or len(prompts[0]) + new,
                    model=model, planner=planner, mesh=mesh)
    if cache32:
        for layer in loop.cache["layers"]:
            for k, t in layer.items():
                layer[k] = t.float()
    for rid, prompt in enumerate(prompts):
        loop.submit(Request(rid, prompt, new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with float32_cache() if cache32 else contextlib.nullcontext():
        loop.drain()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = {r.rid: r.out for r in loop.done}
    del loop
    torch.cuda.empty_cache()
    check(sorted(tokens) == list(range(len(prompts))) and all(
        len(t) == new and all(0 <= x < cfg.vocab_size for x in t)
        for t in tokens.values()), f"{cfg.name}: served tokens")
    return dict(rows=rows, routes=routes, tokens=tokens, launches=launches,
                decode_ms=decode_ms, seconds=seconds, peak=peak)


def float32_twin(model, cfg, planner=None):
    """(an LM of ``cfg`` in float32 compute holding ``model``'s weights,
    its config): the float32 control of a bfloat16 run."""
    import dataclasses
    from repro_torch.models import LM
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    twin = LM(cfg32, planner=planner, generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    twin.load_state_dict(model.state_dict())
    return twin, cfg32


def rel_err(cfg, ours, ref) -> float:
    """max |ours - ref| / max |ref| over the vocabulary's columns of two
    logits rows; both must hold -1e30 (as bfloat16 holds it, 2^-8 off)
    in the padding columns beyond it."""
    v = cfg.vocab_size
    ours, ref = ours.float(), ref.float()
    for row in (ours, ref):
        check(((row[..., v:] + 1e30).abs() <= 2 ** -8 * 1e30).all().item(),
              f"{cfg.name}: the padding columns are not masked")
    ours, ref = ours[..., :v], ref[..., :v]
    return ((ours - ref).abs().max() / ref.abs().max()).item()


def as_batch(tokens) -> dict:
    return {"tokens": torch.as_tensor(tokens, device="cuda").long()[None]}


def decode_input(model, length: int, max_len: int):
    """A batch cache of SERVE_BATCH sequences of ``length`` tokens and one
    decode step's tokens, for a traced step (each call writes the same
    positions)."""
    cache = model.init_cache(SERVE_BATCH, max_len)
    cache["len"].fill_(length)
    step = {"tokens": torch.zeros((SERVE_BATCH, 1), dtype=torch.long,
                                  device="cuda")}
    return cache, step


def print_serve(label, name, res, prefill, prompt_len) -> None:
    n = sum(len(t) for t in res["tokens"].values())
    print(f"serve {name}: {len(res['tokens'])} requests of {prompt_len} "
          f"tokens, batch {SERVE_BATCH}, "
          f"{len(next(iter(res['tokens'].values())))} new each: prefill "
          + ", ".join(f"{k} {d:.3f} ms (wall {w:.3f})"
                      for k, (d, w) in prefill.items())
          + f" a request (median of 5); decode "
          f"{statistics.median(res['decode_ms']):.3f} ms a step (median of "
          f"{len(res['decode_ms'])} steps that admitted none); "
          f"{n / res['seconds']:.1f} tok/s drained ({n} tokens in "
          f"{res['seconds']:.3f} s, prefills included); peak "
          f"{res['peak'] / 2 ** 30:.2f} GiB; launches {res['launches']} "
          f"[{label}]")


def phase_fftconv_lm(label, olmo, planners) -> dict:
    """The FFT-conv LM at olmo-1b's width served through the hopper
    planner: its launches, (a) each prefill against forward over the same
    prompt, (b) the whole run against the same weights served through
    torch_native (cuFFT) fed the same tokens; then its times and a traced
    prefill. Returns the launches of the served run."""
    import dataclasses
    import numpy as np
    from repro_torch.models import LM
    cfg = dataclasses.replace(olmo, segments=(("fftconv_mlp",
                                               olmo.num_layers),))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    per_prefill = {k: v * cfg.num_layers for k, v in LM_LAYER_LAUNCHES.items()}
    with torch.no_grad():
        model = LM(cfg, planner=planners["hopper"], generator=torch.Generator(
            device="cuda").manual_seed(SEED)).to_compute_dtype()
        res = serve(model, cfg, prompts)
        want = {k: v * LM_REQUESTS for k, v in per_prefill.items()}
        check(res["launches"] == want, f"FFT-conv LM served launches "
              f"{res['launches']}, expected {want} ({per_prefill} a prefill, "
              "none a decode step)")
        err_a = []
        kept = kept_rows(res)
        kept["prompts"] = prompts[:MESH_SERVE_REQUESTS]
        for rid, prompt in enumerate(prompts):
            full, _ = model(as_batch(prompt))
            check(torch.isfinite(full).all().item(), "forward non-finite")
            err_a.append(rel_err(cfg, res["rows"][rid][0], full[0, -1]))
            if rid < MESH_SERVE_REQUESTS:
                kept["forward"].append(full[0, -1].clone())
            del full
        check(max(err_a) <= SERVE_TOL, f"FFT-conv LM prefill against "
              f"forward: err/max {max(err_a)} > {SERVE_TOL}")
        native = serve(model, cfg, prompts, planner=planners["torch_native"],
                       forced=res["tokens"])
        model.planner = planners["hopper"]
        check(native["launches"]["four_step_fft"] == 0, "the torch_native "
              "run launched the four-step kernel")
        twin, cfg32 = float32_twin(model, cfg, planners["torch_native"])
        truth = serve(twin, cfg32, prompts, forced=res["tokens"])
        del twin
        torch.cuda.empty_cache()

        def errs(run, ref):
            return [rel_err(cfg, a, b) for rid in run["rows"]
                    for a, b in zip(run["rows"][rid], ref["rows"][rid])]
        err_b, hopper32, native32 = (errs(res, native), errs(res, truth),
                                     errs(native, truth))
        check(len(err_b) == LM_REQUESTS * SERVE_NEW
              and max(hopper32) <= NOISE_RATIO * max(native32),
              f"FFT-conv LM served through hopper: err/max {max(hopper32)} "
              f"against float32, more than {NOISE_RATIO} x torch_native's "
              f"{max(native32)}")
        print(f"serve FFT-conv LM ({cfg.num_layers} fftconv_mlp layers, d "
              f"{cfg.d_model}, {cfg.compute_dtype}): launches {res['launches']}"
              f" ({per_prefill} a prefill); (a) prefill against forward "
              f"err/max {max(err_a):.3e} (tol {SERVE_TOL}); (b) "
              f"{len(err_b)} teacher-forced rows: hopper against torch_native"
              f" (cuFFT) err/max {max(err_b):.3e} (median "
              f"{statistics.median(err_b):.3e}); against the float32 run "
              f"(torch_native) hopper {max(hopper32):.3e}, torch_native "
              f"{max(native32):.3e} (limit {NOISE_RATIO} x)")
        del native, truth
        batch = as_batch(prompts[0])
        max_len = LM_PROMPT + SERVE_NEW
        _, one, _ = counted(lambda: model.prefill(batch, max_len))
        check(one == per_prefill, f"one prefill launched {one}, expected "
              f"{per_prefill}")
        prefill = {}
        for name, p in planners.items():
            model.planner = p
            prefill[name] = time_variant(lambda: model.prefill(batch, max_len),
                                         5)
        model.planner = planners["hopper"]
        print_serve(label, "FFT-conv LM", res, prefill, LM_PROMPT)
        cache, step = decode_input(model, LM_PROMPT, max_len)
        phase_profile(label, [
            (f"FFT-conv LM prefill {LM_PROMPT} tokens hopper",
             lambda: model.prefill(batch, max_len)),
            (f"FFT-conv LM decode step batch {SERVE_BATCH} at {LM_PROMPT}",
             lambda: model.decode_step(cache, step))], top=25)
        del cache
    kept["launches"] = res["launches"]
    del model, res
    torch.cuda.empty_cache()
    return kept


def kept_rows(res) -> dict:
    """What phase 19 holds the mesh against: the first MESH_SERVE_REQUESTS
    requests' prompts' rows and their first MESH_SERVE_NEW decode rows
    (and the median decode step's ms, printed beside its own)."""
    return {"rows": {rid: [r.clone() for r in res["rows"][rid][
        :1 + MESH_SERVE_NEW]] for rid in range(MESH_SERVE_REQUESTS)},
        "forward": [], "decode_ms": statistics.median(res["decode_ms"])}


def phase_olmo(label, olmo) -> dict:
    """olmo-1b as published, served; each served logits row held against
    forward over the prompt and the tokens served before it. Returns what
    phase 19 holds the mesh against (``kept_rows``, and forward over each
    of those prompts alone)."""
    import numpy as np
    from repro_torch.models import LM
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, olmo.vocab_size, OLMO_PROMPT).astype(np.int32)
               for _ in range(OLMO_REQUESTS)]
    with torch.no_grad():
        model = LM(olmo, generator=torch.Generator(
            device="cuda").manual_seed(SEED)).to_compute_dtype()
        res = serve(model, olmo, prompts)
        check(sum(res["launches"].values()) == 0,
              f"olmo-1b launched {res['launches']}")
        kept = kept_rows(res)
        kept["prompts"] = prompts[:MESH_SERVE_REQUESTS]
        kept["forward"] = [model(as_batch(p))[0][0, -1].clone()
                           for p in kept["prompts"]]
        twin, _ = float32_twin(model, olmo)
        errs, served32, forward32 = [], [], []
        for rid, prompt in enumerate(prompts):
            seq = as_batch(np.concatenate([prompt, res["tokens"][rid][:-1]]))
            rows = model(seq)[0][0, OLMO_PROMPT - 1:]
            rows32 = twin(seq)[0][0, OLMO_PROMPT - 1:]
            check(torch.isfinite(rows).all().item()
                  and len(rows) == len(res["rows"][rid]), "olmo forward")
            for served, fwd, fwd32 in zip(res["rows"][rid], rows, rows32):
                errs.append(rel_err(olmo, served, fwd))
                served32.append(rel_err(olmo, served, fwd32))
                forward32.append(rel_err(olmo, fwd, fwd32))
            del rows, rows32
        del twin
        check(max(served32) <= NOISE_RATIO * max(forward32),
              f"olmo-1b served: err/max {max(served32)} against the float32 "
              f"forward, more than {NOISE_RATIO} x the bfloat16 forward's "
              f"{max(forward32)}")
        print(f"serve olmo-1b ({olmo.num_layers} layers, d {olmo.d_model}, "
              f"{olmo.compute_dtype}): {len(errs)} served rows against "
              f"forward err/max {max(errs):.3e} (median "
              f"{statistics.median(errs):.3e}); against the float32 forward"
              f" served {max(served32):.3e}, forward {max(forward32):.3e} "
              f"(limit {NOISE_RATIO} x)")
        batch = as_batch(prompts[0])
        prefill = {"olmo-1b": time_variant(
            lambda: model.prefill(batch, OLMO_PROMPT + SERVE_NEW), 5)}
        print_serve(label, "olmo-1b", res, prefill, OLMO_PROMPT)
        cache, step = decode_input(model, OLMO_PROMPT,
                                   OLMO_PROMPT + SERVE_NEW)
        phase_profile(label, [
            (f"olmo-1b prefill {OLMO_PROMPT} tokens",
             lambda: model.prefill(batch, OLMO_PROMPT + SERVE_NEW)),
            (f"olmo-1b decode step batch {SERVE_BATCH} at {OLMO_PROMPT}",
             lambda: model.decode_step(cache, step))], top=15)
    del model, res, cache
    torch.cuda.empty_cache()
    return kept


# ---------------------------------------------------------------------------
# the other layer kinds (phase 16)
# ---------------------------------------------------------------------------


def float32_view(model):
    """``model`` computing in float32: a shallow copy that holds the very
    same (bfloat16) parameters, each cast to float32 at its use, so that no
    second copy of the weights is held. Its logits are those of a float32
    LM loaded with the bfloat16 weights; ServeLoop serves it as it is."""
    import copy
    import dataclasses
    twin = copy.copy(model)
    twin.dtype = torch.float32
    twin.cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    return twin


@contextlib.contextmanager
def patched(name, wrap):
    """``repro_torch.models.blocks.<name>`` (the layers look it up at each
    call) replaced by ``wrap(original)`` for the block."""
    from repro_torch.models import blocks
    saved = getattr(blocks, name)
    setattr(blocks, name, wrap(saved))
    try:
        yield
    finally:
        setattr(blocks, name, saved)


@contextlib.contextmanager
def float32_cache():
    """For the block, a prefill's cache keeps the dtype of its k/v (a
    float32 model's: float32) instead of bfloat16 (``lm._pad_seq``); a
    decode step writes its k/v in the cache's dtype and reads them back as
    they are, so a float32 model's decode path then rounds nothing."""
    from repro_torch.models import lm
    saved = lm._pad_seq

    def pad_seq(t, pad):
        return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                         1)
    lm._pad_seq = pad_seq
    try:
        yield
    finally:
        lm._pad_seq = saved


def top_experts(gates, k):
    """Each row's k largest gates' experts, ties to the lower index."""
    return torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]


def plain_route(p, cfg, x):
    """The reference's routing of one MoE call's tokens (x (B, S, d), one
    group), computed here: (experts (T, k), keep (T, k)), each token's
    top_k experts of the float32 router softmax and whether each choice
    finds a slot: the (token, choice) pairs take their experts' slots in
    token-major order, capacity_factor x T x top_k / experts of them, at
    least 4, at most T x top_k."""
    import torch.nn.functional as F
    xt = x.reshape(-1, x.shape[-1]).float()
    t, k, e = xt.shape[0], cfg.top_k, cfg.num_experts
    experts = top_experts(torch.softmax(xt @ p["router"].float(), dim=-1), k)
    flat = experts.reshape(-1)
    hot = F.one_hot(flat, e)
    rank = (hot.cumsum(0) - hot).gather(1, flat[:, None])[:, 0]
    cap = min(max(int(cfg.capacity_factor * t * k / e), 4), t * k)
    return experts, (rank < cap).reshape(t, k)


def moe_logged(log):
    """For ``patched("moe_fwd", ...)``: the MoE, which also appends each
    call's ``plain_route`` to ``log``."""
    def wrap(moe_fwd):
        def logged(p, cfg, x, num_groups=1, tp=None):
            check(num_groups == 1 and tp is None, "a MoE layer routed in "
                  "groups or over ranks")
            log.append(plain_route(p, cfg, x))
            return moe_fwd(p, cfg, x, num_groups, tp)
        return logged
    return wrap


def moe_forced(routes, capacity=True, renormalise=True):
    """For ``patched("moe_fwd", ...)`` around a forward over one request's
    tokens: a plain MoE whose l-th call gives each token the experts and
    the kept choices of ``routes[l]`` ((experts (T', k), keep (T', k)), as
    the served run routed it; a token past T' its own top_k, every choice
    kept), weighted by its router softmax renormalised over them, each
    expert's SwiGLU applied to its tokens by a gather. The controls: every
    choice kept (``capacity`` False), the weights not renormalised."""
    import torch.nn.functional as F
    calls = iter(routes)

    def wrap(_):
        def forced(p, cfg, x, num_groups=1, tp=None):
            check(tp is None, "a forced MoE over ranks")
            experts, keep = next(calls)
            xt = x.reshape(-1, x.shape[-1])
            t, dt = xt.shape[0], x.dtype
            gates = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
            own = top_experts(gates[experts.shape[0]:], cfg.top_k)
            experts = torch.cat([experts, own])
            keep = torch.cat([keep, torch.ones_like(own, dtype=torch.bool)])
            w = gates.gather(1, experts)
            if renormalise:
                w = w / w.sum(-1, keepdim=True)
            if capacity:
                w = w * keep
            out = torch.zeros_like(xt)
            for e in range(cfg.num_experts):
                tok, choice = (experts == e).nonzero(as_tuple=True)
                h = xt[tok]
                y = (F.silu(h @ p["w_gate"][e].to(dt))
                     * (h @ p["w_up"][e].to(dt))) @ p["w_down"][e].to(dt)
                out.index_add_(0, tok, y * w[tok, choice, None].to(dt))
            return out.reshape(x.shape), torch.zeros((), device=x.device)
        return forced
    return wrap


def routes_replayed(log, replay: bool):
    """For ``patched("moe_route", ...)``: the router, which appends each
    call's discrete routing (the experts chosen, their slots, which were
    kept; on the CPU) to ``log``, or (``replay``) takes them from ``log``
    in call order and weights them by this call's own gates renormalised.
    Two orders of float32 arithmetic (one device, a mesh) agree to 1e-6,
    but at full width a router near-tie within that flips an expert
    choice of some token, which moves its row and, through the capacity
    and attention, the rows after it; a run replaying the other's routing
    is held at float32 noise."""
    calls = iter(log)

    def wrap(route):
        def run(p, cfg, xt):
            gates, topv, topi, pos, keep = route(p, cfg, xt)
            if not replay:
                log.append((topi.cpu(), pos.cpu(), keep.cpu()))
                return gates, topv, topi, pos, keep
            topi, pos, keep = (t.to(xt.device) for t in next(calls))
            topv = gates.gather(-1, topi)
            topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
            return gates, topv, topi, pos, keep
        return run
    return wrap


def routing_rows(calls, lo, hi):
    """(experts (T, L, k), kept (T, L, k)) of tokens lo..hi-1 in ``calls``,
    the routing log's entries of one call of the model (one a MoE layer)."""
    return (torch.stack([topi[lo:hi] for topi, _ in calls], 1),
            torch.stack([kept[lo:hi] for _, kept in calls], 1))


def forward_rows(model, batch, lo, hi):
    """Rows lo..hi-1 of ``model``'s logits over ``batch``."""
    rows = model(batch)[0][0, lo:hi]
    check(torch.isfinite(rows).all().item(), f"{model.cfg.name}: forward "
          "non-finite")
    return rows


def drops_by_call(log, n_moe) -> list:
    """Dropped (token, choice) pairs of each call, summed over its MoE
    layers, and the pairs it routed."""
    out = []
    for i in range(0, len(log), n_moe):
        calls = log[i:i + n_moe]
        out.append((sum(int((~kept).sum()) for _, kept in calls),
                    sum(kept.numel() for _, kept in calls)))
    return out


def hold_float32(twin, prompts, tokens) -> dict:
    """The decode path in float32: ``twin`` (``float32_view``) serves
    ``prompts`` fed ``tokens`` with its decode cache in float32, and every
    row it takes a token from is held within KIND_F32_TOL of forward over
    the prompt and the tokens in float32, whose MoE layers route each
    token as the served run did (``moe_forced``). The controls must miss
    that limit:
    the first prompt served with its cache never merged and with decode
    steps that leave the cache as they found it (``serve``'s "unmerged"
    and "frozen"); for MoE, that forward with every choice kept and with
    the weights not renormalised. Returns the served rows, their errors
    and the controls' errors."""
    import numpy as np
    cfg = twin.cfg
    n_moe = sum(layer.kind == "attn_moe" for layer in twin.layers)
    s = len(prompts[0])
    log = []
    with patched("moe_fwd", moe_logged(log)):
        truth = serve(twin, cfg, prompts, forced=tokens, new=KIND_NEW,
                      routing=log, cache32=True)
    del log
    controls = {c: serve(twin, cfg, prompts[:1], forced=tokens, new=KIND_NEW,
                         control=c, cache32=True)["rows"][0]
                for c in ("unmerged", "frozen")}

    def reference(rid, **moe):
        with contextlib.ExitStack() as stack:
            if n_moe:
                experts = torch.cat([e for e, _ in truth["routes"][rid]])
                keep = torch.cat([k for _, k in truth["routes"][rid]])
                stack.enter_context(patched("moe_fwd", moe_forced(
                    [(experts[:, i], keep[:, i]) for i in range(n_moe)],
                    **moe)))
            seq = as_batch(np.concatenate([prompts[rid], tokens[rid]]))
            return forward_rows(twin, seq, s - 1, s - 1 + KIND_NEW)

    def errs(ours, ref):
        return [rel_err(cfg, a, b) for a, b in zip(ours, ref)]
    held, missed = [], {}
    for rid in range(len(prompts)):
        rows = reference(rid)
        held += errs(truth["rows"][rid], rows)
        if rid == 0:
            for c, run in controls.items():
                missed[c] = max(errs(run, rows))
            if n_moe:
                for c, moe in (("every choice kept", dict(capacity=False)),
                               ("weights not renormalised",
                                dict(renormalise=False))):
                    missed[c] = max(errs(truth["rows"][0],
                                         reference(0, **moe)))
        del rows
    check(len(held) == len(prompts) * KIND_NEW
          and max(held) <= KIND_F32_TOL,
          f"{cfg.name} served in float32: err/max {max(held)} against the "
          f"float32 forward over {len(held)} rows, more than {KIND_F32_TOL}")
    check(min(missed.values()) > KIND_F32_TOL,
          f"{cfg.name}: a control is within {KIND_F32_TOL} of the float32 "
          f"forward: {missed}")
    return dict(rows=truth["rows"], errs=held, missed=missed)


def phase_embeds(model, twin, gen) -> str:
    """A prefill of KIND_PROMPT frontend embeddings (qwen2-vl: a
    MROPE_GRID^2 image, then text, on M-RoPE streams) against forward over
    the same embeddings within SERVE_TOL, then EMBED_STEPS decode steps on
    embeddings: in float32 (``twin``, its cache in float32) held within
    KIND_F32_TOL of forward over them all in float32 (the new tokens at
    position len in every stream, as decode gives them), the bfloat16
    steps' drift against it printed."""
    from repro_torch.models import mrope_positions, synth_embeddings
    cfg = model.cfg
    s, n = KIND_PROMPT, EMBED_STEPS
    emb = synth_embeddings(cfg, 1, s + n, gen)
    prompt, whole = {"embeds": emb[:, :s]}, {"embeds": emb}
    if cfg.rope == "mrope":
        pos = mrope_positions(1, s, MROPE_GRID)
        prompt["positions"] = pos
        tail = torch.arange(s, s + n, dtype=pos.dtype, device=pos.device)
        whole["positions"] = torch.cat(
            [pos, tail.expand(3, 1, n)], dim=-1)
    lg, _ = model.prefill(prompt, s + n)
    full = model(prompt)[0]
    err_a = rel_err(cfg, lg[0, 0], full[0, -1])
    del full
    check(err_a <= SERVE_TOL, f"{cfg.name} embeds prefill against forward: "
          f"err/max {err_a} > {SERVE_TOL}")
    rows = []
    for m, keep in ((model, contextlib.nullcontext()),
                    (twin, float32_cache())):
        with keep:
            _, cache = m.prefill(prompt, s + n)
        rows.append([])
        for i in range(n):
            lg, cache = m.decode_step(cache,
                                      {"embeds": emb[:, s + i:][:, :1]})
            rows[-1].append(lg[0, 0])
        del cache
    fwd32 = forward_rows(twin, whole, s, s + n)
    drift = [rel_err(cfg, a, b) for a, b in zip(rows[0], fwd32)]
    dec32 = [rel_err(cfg, a, b) for a, b in zip(rows[1], fwd32)]
    check(max(dec32) <= KIND_F32_TOL, f"{cfg.name} embeds decode in float32: "
          f"err/max {max(dec32)} against the float32 forward, more than "
          f"{KIND_F32_TOL}")
    layout = (f"{MROPE_GRID}x{MROPE_GRID} patches, then text, on M-RoPE "
              "streams" if cfg.rope == "mrope" else "frames")
    return (f"embeds ({layout}): prefill against forward err/max "
            f"{err_a:.3e}; {n} decode steps in float32 against the float32 "
            f"forward {max(dec32):.3e} (limit {KIND_F32_TOL}), bfloat16 "
            f"drift {max(drift):.4f}")


def xlstm_layers(label, name, model, gen, prefill_ms) -> None:
    """Where an xlstm prefill's time goes: the device ops of one sLSTM
    layer, traced over SLSTM_TRACED token counts and scaled to the sLSTM
    layers of a KIND_PROMPT-token prefill (the ops grow by the same count
    a token); the untraced wall of one sLSTM and one mLSTM layer over
    KIND_PROMPT tokens (medians of 3), times their layers."""
    from repro_torch.models.ssm import mlstm_fwd, slstm_fwd
    cfg = model.cfg
    count = {kind: sum(x.kind == kind for x in model.layers)
             for kind in ("slstm", "mlstm")}
    first = {kind: next(x for x in model.layers if x.kind == kind)
             for kind in count}
    ops = []
    for n in SLSTM_TRACED:
        h = torch.randn((1, n, cfg.d_model), generator=gen,
                        device="cuda").to(model.dtype)
        (_, _, o), = phase_profile(label, [(
            f"{name} one sLSTM layer over {n} tokens",
            lambda: slstm_fwd(first["slstm"].mixer, cfg, h))], top=5)
        ops.append(o)
    (n0, n1, n2), (o0, o1, o2) = SLSTM_TRACED, ops
    per_token = (o2 - o1) / (n2 - n1)
    linear = per_token == (o1 - o0) / (n1 - n0)
    total = count["slstm"] * (o1 + per_token * (KIND_PROMPT - n1))
    h = torch.randn((1, KIND_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").to(model.dtype)
    wall = {kind: time_variant(lambda: fwd(first[kind].mixer, cfg, h), 3)
            for kind, fwd in (("slstm", slstm_fwd), ("mlstm", mlstm_fwd))}
    print(f"serve {name} sLSTM: {per_token:.0f} device ops a token a layer "
          f"({ops} traced over {list(SLSTM_TRACED)} tokens, "
          f"{'' if linear else 'not '}linear), so {total:.0f} for the "
          f"{count['slstm']} sLSTM layers of a {KIND_PROMPT}-token prefill. "
          f"One layer over {KIND_PROMPT} tokens, untraced (device ms, wall "
          + ", ".join(f"{kind} {d:.3f}, {w:.3f}"
                      for kind, (d, w) in wall.items())
          + f" ms): the {count['slstm']} sLSTM layers "
          f"{count['slstm'] * wall['slstm'][1]:.1f} ms and the "
          f"{count['mlstm']} mLSTM layers "
          f"{count['mlstm'] * wall['mlstm'][1]:.1f} ms of the prefill's "
          f"{prefill_ms:.1f} ms [{label}]")


def kind_config(name, depth):
    """The config of a KIND_MODELS entry: its first ``depth`` layers (its
    segments cut to them), or all of them when ``depth`` is None."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if depth is None:
        return cfg
    segments = cfg.segments
    if segments:
        cut, left = [], depth
        for kind, count in segments:
            if left > 0:
                cut.append((kind, min(count, left)))
                left -= count
        segments = tuple(cut)
    return dataclasses.replace(cfg, num_layers=depth, segments=segments)


def phase_kind(label, name, depth):
    """Serve one model of the other layer kinds (KIND_MODELS): (a) each
    prefill against forward over its prompt within SERVE_TOL; the decode
    path in float32 (``hold_float32``); the embedding paths
    (``phase_embeds``). Prints the bfloat16 run's drift against the
    float32 one, its times, peak and profiles (xlstm: its layers' device
    ops and times, ``xlstm_layers``); returns the drained run's kernel
    launches, and for KIND_MESH_MODELS what phase 20 (a) holds the mesh
    against (the prompts, every served row, the median decode ms), else
    None."""
    import numpy as np
    from repro_torch.models import LM
    from repro_torch.models.blocks import moe_capacity
    cfg = kind_config(name, depth)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, KIND_PROMPT).astype(np.int32)
               for _ in range(KIND_REQUESTS)]
    max_len = KIND_PROMPT + KIND_NEW
    t0 = time.perf_counter()
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = LM(cfg, generator=gen).to_compute_dtype()
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        n_moe = sum(layer.kind == "attn_moe" for layer in model.layers)
        log = []
        with patched("moe_fwd", moe_logged(log)):
            res = serve(model, cfg, prompts, new=KIND_NEW)
        check(sum(res["launches"].values()) == 0,
              f"{cfg.name} launched {res['launches']}")
        drops = drops_by_call(log, n_moe) if n_moe else []
        del log
        # (a) the same computation as the prefill (a MoE layer's capacity
        # counts the same KIND_PROMPT tokens)
        err_a = [rel_err(cfg, res["rows"][rid][0], forward_rows(
                     model, as_batch(prompt), KIND_PROMPT - 1,
                     KIND_PROMPT)[0])
                 for rid, prompt in enumerate(prompts)]
        check(max(err_a) <= SERVE_TOL, f"{cfg.name} prefill against "
              f"forward: err/max {max(err_a)} > {SERVE_TOL}")
        twin = float32_view(model)
        held = hold_float32(twin, prompts, res["tokens"])
        drift = [rel_err(cfg, a, b) for rid in res["rows"]
                 for a, b in zip(res["rows"][rid], held["rows"][rid])]
        embeds = (phase_embeds(model, twin, gen)
                  if cfg.frontend is not None else "")
        kinds = sorted({layer.kind for layer in model.layers})
        print(f"serve {name} ({len(model.layers)} layers {kinds}, d "
              f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
              f"{cfg.compute_dtype}, built in {built:.1f} s): (a) prefill "
              f"against forward err/max {max(err_a):.3e} (tol {SERVE_TOL}); "
              f"served in float32, {len(held['errs'])} rows against the "
              f"float32 forward err/max {max(held['errs']):.3e} (median "
              f"{statistics.median(held['errs']):.3e}; limit "
              f"{KIND_F32_TOL}); controls, which must miss it: "
              + ", ".join(f"{c} {e:.3e}" for c, e in held["missed"].items())
              + f"; bfloat16 drift, the served rows against the float32 "
              f"served rows, err/max {max(drift):.4f} (median "
              f"{statistics.median(drift):.4f})"
              + (f"; {embeds}" if embeds else ""))
        if n_moe:
            prefills = [d for d in drops if d[1] > SERVE_BATCH * cfg.top_k
                        * n_moe]
            steps = [d for d in drops if d[1] <= SERVE_BATCH * cfg.top_k
                     * n_moe]
            print(f"serve {name} MoE drops (dropped of routed (token, "
                  f"choice) pairs over {n_moe} layers, capacity "
                  f"{moe_capacity(cfg, KIND_PROMPT)} a prefill, "
                  f"{moe_capacity(cfg, SERVE_BATCH)} a decode step): "
                  f"prefills {prefills}; decode steps "
                  f"{[d for d, _ in steps]} of {steps[0][1]} each")
        batch = as_batch(prompts[0])
        prefill = {name: time_variant(lambda: model.prefill(batch, max_len),
                                      5)}
        print_serve(label, name, res, prefill, KIND_PROMPT)
        if "slstm" in kinds:
            xlstm_layers(label, name, model, gen, prefill[name][0])
        cache, step = decode_input(model, KIND_PROMPT, max_len)
        calls = [(f"{name} decode step batch {SERVE_BATCH} at {KIND_PROMPT}",
                  lambda: model.decode_step(cache, step))]
        if name == "zamba2-7b":
            calls.insert(0, (f"{name} prefill {KIND_PROMPT} tokens",
                             lambda: model.prefill(batch, max_len)))
        phase_profile(label, calls, top=15)
        print(f"serve {name}: took {time.perf_counter() - t0:.1f} s")
    launches = res["launches"]
    kept = ({"prompts": prompts, "rows": res["rows"],
             "decode_ms": statistics.median(res["decode_ms"])}
            if name in KIND_MESH_MODELS else None)
    del model, twin, res, held, cache, calls
    gc.collect()
    torch.cuda.empty_cache()
    return launches, kept


# ---------------------------------------------------------------------------
# training (phase 17)
# ---------------------------------------------------------------------------


def conv64(orig):
    """A stand-in for ``fft_conv``: the same causal convolution by float64
    torch.fft (``causal_conv``), differentiable, cast to the input's
    dtype."""
    return lambda v, f, **kw: causal_conv(v.double(), f.double()).to(v.dtype)


def conv_detached(orig):
    """``fft_conv`` with its output cut from the graph (a control)."""
    return lambda v, f, **kw: orig(v, f, **kw).detach()


def step_grads(model, batch) -> tuple:
    """(loss, every parameter's gradient by name) of one ``loss_fn`` step
    on ``model``, whose gradients are cleared after."""
    from repro_torch.models import loss_fn
    loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def step_errors(model, batch) -> dict:
    """One float32 training step of ``model`` held against the same weights
    with every layer's ``fft_conv`` rendered in float64 by torch.fft, and
    the same step with the convolution's output detached (a control):
    {"loss", "grads" (err/max of each gradient, by name), "control"
    (likewise)}, each error against the float64 rendering's."""
    with patched("fft_conv", conv64):
        loss64, want = step_grads(model, batch)
    loss, got = step_grads(model, batch)

    def errs(grads):
        return {n: ((grads[n] - w).abs().max()
                    / w.abs().max().clamp(min=1e-30)).item()
                for n, w in want.items()}
    out = {"loss": abs(loss.item() - loss64.item()) / abs(loss64.item()),
           "grads": errs(got)}
    del got
    with patched("fft_conv", conv_detached):
        _, ctrl = step_grads(model, batch)
    out["control"] = errs(ctrl)
    return out


def train_batch(cfg, batch: int, seq: int, device) -> dict:
    """SyntheticDataset's step-0 training batch of ``batch`` x ``seq`` token
    ids and labels, as int64 tensors on ``device``."""
    from repro_torch.data import SyntheticDataset
    from repro_torch.models.config import ShapeConfig
    data = SyntheticDataset(cfg, ShapeConfig("train", seq, batch, "train"),
                            seed=SEED)
    out = data.batch_at(0)
    return {k: torch.from_numpy(out[k]).long().to(device)
            for k in ("tokens", "labels")}


def phase_conv_grad(label, planner, gen) -> None:
    """fft_conv's gradient at the FFT-conv LM's training shape through the
    hopper planner, against the autograd of a float64 torch.fft rendering;
    two controls (grad_u against K instead of conj K, grad_k from the first
    batch row only) must miss the limit."""
    from repro_torch.core import fftconv as fc
    from repro_torch.kernels.transpose import transpose
    from repro_torch.kernels.twiddle import complex_multiply
    u = randn((TRAIN_B, TRAIN_S, MIXER_D), gen).requires_grad_()
    k = fc.materialize_filter(0.2 * randn((MIXER_D, MIXER_RANK), gen),
                              TRAIN_S).requires_grad_()
    g = randn((TRAIN_B, TRAIN_S, MIXER_D), gen)
    y, fwd, _ = counted(lambda: fc.fft_conv(u, k, planner=planner))
    _, back, seconds = counted(lambda: y.backward(g))
    check(fwd == {"four_step_fft": 2, "batched_transpose": 2,
                  "complex_multiply": 1, "fftconv_fused": 0}
          and back == {"four_step_fft": 1, "batched_transpose": 2,
                       "complex_multiply": 2, "fftconv_fused": 0},
          f"fft_conv launches: forward {fwd}, backward {back}")
    u64 = u.detach().double().requires_grad_()
    k64 = k.detach().double().requires_grad_()
    causal_conv(u64, k64).backward(g.double())
    want_u, want_k = u64.grad, k64.grad
    del u64, k64
    tol_u = TRAIN_CONV_TOL * want_u.abs().max().item()
    tol_k = TRAIN_CONV_TOL * want_k.abs().max().item()
    err_u = (u.grad.double() - want_u).abs().max().item()
    err_k = (k.grad.double() - want_k).abs().max().item()
    with torch.no_grad():
        plan = planner.plan(fc.next_fft_len(2 * TRAIN_S), "c2c",
                            permuted=True)
        gf = fc._spectrum(plan, transpose(g))
        kf = fc._spectrum(plan, k)
        ctrl_u = transpose(fc._real_crop(plan, complex_multiply(gf, kf),
                                         TRAIN_S))
        miss_u = (ctrl_u.double() - want_u).abs().max().item()
        del ctrl_u, kf
        uf = fc._spectrum(plan, transpose(u[:1]))
        ctrl_k = fc._real_crop(plan, complex_multiply(
            (gf[0][:1], gf[1][:1]), fc._conj(uf)), TRAIN_S)[0]
        miss_k = (ctrl_k.double() - want_k).abs().max().item()
        del ctrl_k, uf, gf
    check(err_u <= tol_u and err_k <= tol_k,
          f"fft_conv gradient: grad_u err {err_u} (tol {tol_u}), grad_k "
          f"err {err_k} (tol {tol_k})")
    check(miss_u > tol_u and miss_k > tol_k,
          f"fft_conv gradient controls within the limit: grad_u against K "
          f"{miss_u} (tol {tol_u}), grad_k of row 0 {miss_k} (tol {tol_k})")
    print(f"train fft_conv gradient {tuple(u.shape)} x {tuple(k.shape)} "
          f"hopper: grad_u err {err_u:.4e} (tol {tol_u:.4e}), grad_k err "
          f"{err_k:.4e} (tol {tol_k:.4e}), against float64 torch.fft; "
          f"controls, which must miss: grad_u against K instead of conj K "
          f"{miss_u:.4e}, grad_k of the first batch row only {miss_k:.4e}; "
          f"launches forward {fwd}, backward {back}; backward "
          f"{seconds * 1e3:.1f} ms incl. first call [{label}]")
    del u, k, g, y, want_u, want_k
    torch.cuda.empty_cache()


def phase_train_step32(label, cfg, planner) -> None:
    """One float32 training step of the FFT-conv LM at full width, TRAIN_S
    tokens: loss and every gradient within TRAIN_STEP_TOL of the same step
    with float64 convolutions (``step_errors``); its control must miss.
    The caller turns TF32 off (``main`` does, for the whole run)."""
    from repro_torch.models import LM
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t0 = time.perf_counter()
    model = LM(cfg32, planner=planner, generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    errs = step_errors(model, train_batch(cfg32, 1, TRAIN_S, model.device))
    worst = max(errs["grads"], key=errs["grads"].get)
    missed = max(errs["control"].values())
    check(errs["loss"] <= TRAIN_STEP_TOL
          and errs["grads"][worst] <= TRAIN_STEP_TOL,
          f"float32 step: loss err {errs['loss']}, {worst} gradient err "
          f"{errs['grads'][worst]} > {TRAIN_STEP_TOL}")
    check(missed > TRAIN_STEP_TOL, f"float32 step control (convolution "
          f"detached) within the limit: {missed}")
    print(f"train FFT-conv LM float32 step, 1 x {TRAIN_S} tokens, TF32 off: "
          f"loss err/|ref| {errs['loss']:.3e}, worst gradient err/max "
          f"{errs['grads'][worst]:.3e} ({worst}; median "
          f"{statistics.median(errs['grads'].values()):.3e} over "
          f"{len(errs['grads'])} tensors), limit {TRAIN_STEP_TOL}, against "
          f"float64 convolutions; control (convolution detached) "
          f"{missed:.3e}; {time.perf_counter() - t0:.1f} s [{label}]")
    del model, errs
    gc.collect()
    torch.cuda.empty_cache()


def memory_reckoning(cfg, n_params: int, batch: int, seq: int) -> tuple:
    """(GB reckoned, its terms): float32 parameters, gradients and AdamW
    moments; the bfloat16 logits and the loss's three float32 (B, S, V)
    temporaries; for an FFT-conv layer the spectra one layer saves (U and
    K, float32 pairs)."""
    from repro_torch.core.fftconv import next_fft_len
    from repro_torch.models.lm import padded_vocab
    terms = {"params": 4 * n_params, "grads": 4 * n_params,
             "moments": 8 * n_params,
             "logits": 2 * batch * seq * padded_vocab(cfg),
             "loss temporaries": 12 * batch * seq * padded_vocab(cfg)}
    if any(k == "fftconv_mlp" for k, _ in cfg.resolved_segments()):
        nf = next_fft_len(2 * seq)
        terms["layer spectra"] = 8 * (batch + 1) * cfg.d_model * nf
    return sum(terms.values()) / 1e9, {k: v / 1e9 for k, v in terms.items()}


def phase_training(label, name, cfg, planner, batch: int, seq: int,
                   per_step: dict, ckpt_root) -> dict:
    """Train ``cfg`` (bfloat16 compute, float32 parameters, remat) through
    the Trainer for TRAIN_STEPS steps of ``batch`` x ``seq`` with AdamW
    (warmup 1). Holds: finite losses, every parameter changed at every
    step, the kernel launches of every step equal to ``per_step``, the
    checkpoint of step TRAIN_CKPT_STEP restored bit for bit, a run
    resumed from it within RESUME_TOL of the first run's losses. Prints
    the losses, the median step ms of steps 2-6, tokens/s, the peak
    against the reckoning, and a traced step. Returns the run's launches,
    losses, grad_norms, parameters after the last step (on the host), step
    ms, tokens/s, peak GiB and busy share."""
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    shape = ShapeConfig("train", seq, batch, "train")
    ocfg = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    ckpt_dir = str(ckpt_root / name)
    t0 = time.perf_counter()
    record = dict(restored=None)
    # writes no checkpoint: the resumed run (see TRAIN_CKPT_STEP)
    Resumed = step_recorder()

    class Recorded(Resumed):
        def save(self, step, model, opt_state):
            # the checkpoint under test only (TRAIN_CKPT_STEP)
            if step != TRAIN_CKPT_STEP:
                return
            Trainer.save(self, step, model, opt_state)
            self.ckpt.wait()
            t1 = time.perf_counter()
            live = {"params": dict(model.named_parameters()),
                    "opt": opt_state}
            back, extra = self.ckpt.restore(step, live, device="cpu")
            record["restored"] = (extra == {"data_step": step} and all(
                torch.equal(back["params"][n].to(p.device), p)
                for n, p in live["params"].items()) and all(
                torch.equal(back["opt"][m][n].to(t.device), t)
                for m in ("mu", "nu") for n, t in opt_state[m].items())
                and torch.equal(back["opt"]["step"].to(
                    opt_state["step"].device), opt_state["step"]))
            record["save_s"] = self.ckpt.save_seconds
            record["restore_s"] = time.perf_counter() - t1
            del back

    def trainer(cls):
        model = LM(cfg, planner=planner, generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        return cls(cfg, shape, None, TrainerConfig(
            ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_STEP, keep_n=2),
            ocfg, planner=planner, model=model)

    tr = trainer(Recorded)
    n_params = sum(p.numel() for p in tr._model.parameters())
    model, opt_state, hist = tr.run(TRAIN_STEPS)
    final = {n: p.detach().cpu() for n, p in model.named_parameters()}
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"{name}: losses {losses}")
    check(not any(tr.unchanged), f"{name}: parameters unchanged by "
          f"a step: {[u[:3] for u in tr.unchanged]}")
    check(all(c == per_step for c in tr.launches),
          f"{name}: launches a step {tr.launches}, expected {per_step}")
    ms, launches = tr.ms, tr.launches
    check(record["restored"] is True, f"{name}: the step "
          f"{TRAIN_CKPT_STEP} checkpoint did not restore bit for bit")
    torch.cuda.reset_peak_memory_stats()
    step_batch = tr.batch_at(TRAIN_STEPS)
    # the Trainer's own step, without Recorded's checks around it
    wall, busy, ops = phase_profile(label, [(
        f"{name} training step {batch} x {seq}",
        lambda: Trainer.train_step(tr, model, opt_state, step_batch))],
        top=15)[0]
    peak = torch.cuda.max_memory_allocated()
    reckoned, terms = memory_reckoning(cfg, n_params, batch, seq)
    del model, opt_state, tr, step_batch
    gc.collect()
    torch.cuda.empty_cache()
    # resume from the step TRAIN_CKPT_STEP checkpoint
    resumed = trainer(Resumed)
    _, _, hist2 = resumed.run(TRAIN_STEPS)
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    again = [h["loss"] for h in hist2]
    drift = max(abs(a - b) / abs(b)
                for a, b in zip(again, losses[TRAIN_CKPT_STEP:]))
    check(len(again) == TRAIN_STEPS - TRAIN_CKPT_STEP
          and drift <= RESUME_TOL, f"{name}: resumed losses {again} against"
          f" {losses[TRAIN_CKPT_STEP:]}")
    step_ms = statistics.median(ms[1:])
    print(f"train {name} ({cfg.num_layers} layers "
          f"{sorted({k for k, _ in cfg.resolved_segments()})}, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.compute_dtype} compute, float32 parameters, remat): "
          f"{batch} x {seq} tokens a step, AdamW warmup 1: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {', '.join(f'{x:.1f}' for x in ms)}, "
          f"median of steps 2-{TRAIN_STEPS} {step_ms:.3f} ms, "
          f"{batch * seq / (step_ms / 1e3):.0f} tokens/s; every parameter "
          f"changed at every step; launches a step {per_step} (exact); "
          f"checkpoint of step {TRAIN_CKPT_STEP} restored bit for bit "
          f"(save {record['save_s']:.1f} s host copy, check "
          f"{record['restore_s']:.1f} s incl. the write); resumed from it: "
          f"losses {', '.join(f'{x:.4f}' for x in again)}, err/|loss| "
          f"{drift:.3e} (tol {RESUME_TOL}); peak {peak / 2 ** 30:.2f} GiB "
          f"(traced steps; reckoned {reckoned:.2f} GB: "
          + ", ".join(f"{k} {v:.2f}" for k, v in terms.items())
          + f"); traced step wall {wall:.1f} ms, busy {busy / wall:.1%}, "
          f"{ops} device ops; {time.perf_counter() - t0:.1f} s [{label}]")
    return dict(launches={k: sum(c[k] for c in launches)
                          for k in per_step},
                losses=losses, grad_norms=[h["grad_norm"] for h in hist],
                params=final, step_ms=step_ms,
                tok_s=batch * seq / (step_ms / 1e3), peak_gib=peak / 2 ** 30,
                busy=busy / wall)


# ---------------------------------------------------------------------------
# training on a (data, model) mesh (phase 18)
# ---------------------------------------------------------------------------


def step_recorder():
    """A Trainer that records each step's wall ms, its kernel launches,
    the parameters it left unchanged (this rank's blocks) and, of those,
    the blocks that stalled below float32's resolution (``stalled``: name
    -> its reading, ``below_resolution``), and writes no checkpoint (the
    CPU tests hold the mesh's)."""
    from repro_torch import kernels
    from repro_torch.optim.adamw import local
    from repro_torch.runtime import Trainer

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ms, self.launches, self.unchanged = [], [], []
            self.stalled = []

        def train_step(self, model, opt_state, batch_):
            before = {n: local(p).detach().clone()
                      for n, p in model.named_parameters()}
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            out = super().train_step(model, opt_state, batch_)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t1) * 1e3)
            self.launches.append(kernels.launch_counts())
            same = [n for n, p in model.named_parameters()
                    if torch.equal(local(p), before[n])]
            self.unchanged.append(same)
            readings = {n: below_resolution(self.ocfg, n, before[n], *out[1:])
                        for n in same}
            self.stalled.append({n: r for n, r in readings.items()
                                 if r is not None})
            return out

        def save(self, step, model, opt_state):
            pass
    return Recorded


def below_resolution(ocfg, name: str, x: torch.Tensor, state: dict,
                     metrics: dict):
    """Of a block ``x`` (the float32 parameter before the step) that an
    AdamW step left unchanged: (elements, its largest |x|, its largest
    |lr * u|, the least half spacing of float32 at its values) where
    every element had a gradient (a nonzero first moment) and a step
    |lr * u| no larger than half the spacing of float32 at its value (so
    it rounded back), else None. ``u`` is recomputed from the moments
    after the step as ``optim.adamw.adamw_update`` takes it."""
    step = state["step"].float()
    mu, nu = state["mu"][name], state["nu"][name]
    x = x.float()
    u = ((mu / (1 - ocfg.b1 ** step))
         / (torch.sqrt(nu / (1 - ocfg.b2 ** step)) + ocfg.eps)
         + ocfg.weight_decay * x)
    move = (metrics["lr"] * u).abs()
    half = torch.minimum(
        torch.nextafter(x, torch.full_like(x, math.inf)) - x,
        x - torch.nextafter(x, torch.full_like(x, -math.inf))) / 2
    if not (bool((mu != 0).all()) and bool((move <= half).all())):
        return None
    return (x.numel(), x.abs().max().item(), move.max().item(),
            half.min().item())


def gathered(tr, tree) -> dict:
    """Each tensor of ``tree`` (the Trainer's parameters, or a moment)
    whole, from this rank's blocks on ``tr``'s mesh: a collective, every
    rank calls it."""
    from repro_torch.optim.adamw import local
    return {n: tr.shardings["params"][n].gather(local(t).detach())
            for n, t in tree.items()}


def rel_diffs(got: dict, want: dict) -> dict:
    """Per tensor max|got - want| / max|want| (0 where both are 0)."""
    out = {}
    for n, w in want.items():
        w = w.to(got[n].device)
        scale = w.abs().max().item()
        out[n] = (got[n] - w).abs().max().item() / (scale or 1.0)
    return out


def worst(errs: dict) -> tuple:
    """(name, value) of the largest entry."""
    name = max(errs, key=errs.get)
    return name, errs[name]


def phase_mesh_training(label, name, cfg, planner, batch: int, seq: int,
                        per_step: dict, mesh, single: dict) -> dict:
    """Phase 17's run of ``cfg`` through the Trainer on ``mesh`` (a (1, 1)
    mesh at world size 1: FSDP2 over data): every step's loss and
    grad_norm, and each parameter after the last step, within MESH_P1_TOL
    of phase 17's (``single``); every parameter changed at every step;
    every step's launches exactly ``per_step``; prints step ms, tokens/s,
    the peak of a traced step and its busy share beside phase 17's.
    Returns the run's launches."""
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    t0 = time.perf_counter()
    shape = ShapeConfig("train", seq, batch, "train")
    model = LM(cfg, planner=planner, generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        tr = step_recorder()(
            cfg, shape, mesh, TrainerConfig(ckpt_dir=tmp,
                                            ckpt_every=10 ** 9),
            AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS),
            planner=planner, model=model)
        model, opt_state, hist = tr.run(TRAIN_STEPS)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    drift = max(abs(a - b) / abs(b) for a, b in zip(losses, single["losses"]))
    norm_drift = max(abs(a - b) / abs(b)
                     for a, b in zip(norms, single["grad_norms"]))
    par_name, par_err = worst(rel_diffs(
        gathered(tr, dict(model.named_parameters())), single["params"]))
    check(len(losses) == TRAIN_STEPS and drift <= MESH_P1_TOL,
          f"{name} on the (1, 1) mesh: losses {losses} against phase 17's "
          f"{single['losses']}")
    check(norm_drift <= MESH_P1_TOL, f"{name} on the (1, 1) mesh: "
          f"grad_norms {norms} against phase 17's {single['grad_norms']}")
    check(par_err <= MESH_P1_TOL, f"{name} on the (1, 1) mesh: parameter "
          f"{par_name} after step {TRAIN_STEPS} err/max {par_err} against "
          f"phase 17's")
    check(not any(tr.unchanged), f"{name} on the (1, 1) mesh: parameters "
          f"unchanged by a step: {[u[:3] for u in tr.unchanged]}")
    check(all(c == per_step for c in tr.launches),
          f"{name} on the (1, 1) mesh: launches a step {tr.launches}, "
          f"expected {per_step}")
    torch.cuda.reset_peak_memory_stats()
    step_batch = tr.batch_at(TRAIN_STEPS)
    wall, busy, ops = phase_profile(label, [(
        f"{name} training step on the (1, 1) mesh {batch} x {seq}",
        lambda: Trainer.train_step(tr, model, opt_state, step_batch))],
        top=15)[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(tr.ms[1:])
    tok_s = batch * seq / (step_ms / 1e3)
    print(f"train mesh {name} on a (1, 1) (data, model) mesh, NCCL world "
          f"size 1, FSDP2: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f", err/|loss| against phase 17 {drift:.3e}, grad_norm "
          f"{norm_drift:.3e}, parameters after step {TRAIN_STEPS} err/max "
          f"{par_err:.3e} (worst {par_name}) (tol {MESH_P1_TOL}); every "
          f"parameter changed at every step; launches a step {per_step} "
          f"(exact); step ms {', '.join(f'{x:.1f}' for x in tr.ms)}, "
          f"median of steps 2-{TRAIN_STEPS} {step_ms:.3f} ms "
          f"({single['step_ms']:.3f} without the mesh, "
          f"{step_ms / single['step_ms']:.3f}x), {tok_s:.0f} tokens/s "
          f"({single['tok_s']:.0f}); peak {peak:.2f} GiB "
          f"({single['peak_gib']:.2f}); busy {busy / wall:.1%} "
          f"({single['busy']:.1%}); {ops} device ops; "
          f"{time.perf_counter() - t0:.1f} s [{label}]")
    launches = {k: sum(c[k] for c in tr.launches) for k in per_step}
    del model, opt_state, tr, step_batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mixer_grads(mixer, x, w, sharded: bool) -> dict:
    """The gradients of sum(mixer(x) * w) in x and in every parameter."""
    xr = x.detach().clone().requires_grad_()
    mixer.zero_grad(set_to_none=True)
    (mixer(xr, seq_axis_sharded=sharded) * w).sum().backward()
    out = {"x": xr.grad}
    out.update({n: p.grad.clone() for n, p in mixer.named_parameters()})
    mixer.zero_grad(set_to_none=True)
    return out


def grad_errors(got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).abs().max()
                / want[k].abs().max()).item() for k in want}


def phase_sharded_mixer_grad(label, planner, gen, m1) -> dict:
    """The sequence-sharded mixer's gradient on (1,) at MIXER_B x MIXER_S x
    MIXER_D: every gradient within SHARDED_GRAD_TOL of the unsharded
    mixer's max, the launches of a forward and backward exactly
    SHARDED_GRAD_LAUNCHES, the control (K for conj K in the backward) out
    of the limit; forward and forward + backward timed beside the
    unsharded mixer's. Returns the launches."""
    from repro_torch.core import fftconv
    from repro_torch.models import FFTConvMixer
    t0 = time.perf_counter()
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=m1, axis="fft")
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    w = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    want = mixer_grads(mixer, x, w, False)
    got, launches, seconds = counted(lambda: mixer_grads(mixer, x, w, True))
    errs = grad_errors(got, want)
    check(launches == SHARDED_GRAD_LAUNCHES, f"sharded mixer gradient: "
          f"launches {launches}, expected {SHARDED_GRAD_LAUNCHES}")
    check(max(errs.values()) <= SHARDED_GRAD_TOL, f"sharded mixer "
          f"gradient: err/max {errs} > {SHARDED_GRAD_TOL}")
    del got
    conj = fftconv._conj
    fftconv._conj = lambda z: z             # the control: K for conj K
    try:
        control = grad_errors(mixer_grads(mixer, x, w, True), want)
    finally:
        fftconv._conj = conj
    check(max(control.values()) > SHARDED_GRAD_TOL,
          f"sharded mixer gradient control within the limit: {control}")
    times = {}
    for sharded in (False, True):
        key = "sharded" if sharded else "unsharded"
        with torch.no_grad():
            times[f"{key} forward"] = time_variant(
                lambda: mixer(x, seq_axis_sharded=sharded), 5)[0]
        times[f"{key} forward + backward"] = time_variant(
            lambda: mixer_grads(mixer, x, w, sharded), 5)[0]
    print(f"sharded mixer gradient FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
          f"{tuple(x.shape)} on (1,) NCCL: err/max "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {SHARDED_GRAD_TOL}) against the unsharded mixer; "
          f"control (K for conj K) {max(control.values()):.3e}; launches "
          f"{launches} (exact); {seconds:.3f} s first call; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; {time.perf_counter() - t0:.1f} s [{label}]")
    phase_profile(label, [("sharded mixer forward + backward on (1,)",
                           lambda: mixer_grads(mixer, x, w, True))])
    del mixer, x, w, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mesh_cfg():
    """olmo-1b at its width on MESH_LAYERS, float32 compute."""
    from repro_torch.configs import get_config
    olmo = get_config("olmo-1b")
    return dataclasses.replace(olmo, segments=MESH_LAYERS,
                               num_layers=sum(n for _, n in MESH_LAYERS),
                               compute_dtype="float32")


def gloo_mesh_train(rank, mesh4, planner, gen) -> list:
    """Phase 18 (c) over the gloo ranks: a (2, 2) mesh Trainer of
    ``mesh_cfg`` for MESH_STEPS steps, held on rank 0 against the same
    trainer on one rank (losses, grad_norms, the first moment after the
    first step, the parameters after the last), with its control (gradients averaged
    over the data ranks) one step long; the sharded mixer's gradient over
    (4,) against the unsharded mixer's on rank 0. Returns rank 0's
    lines."""
    import datetime
    import torch.distributed as dist
    from repro_torch import make_mesh
    from repro_torch.models import FFTConvMixer, LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainerConfig
    cfg = mesh_cfg()
    shape = ShapeConfig("train", MESH_S, MESH_B, "train")
    ocfg = AdamWConfig(warmup_steps=1, total_steps=MESH_STEPS)
    mesh = make_mesh((2, 2), ("data", "model"),
                     timeout=datetime.timedelta(seconds=300),
                     device_type="cuda")
    per_step = dict(TRAIN_LAYER_LAUNCHES)

    class Recorded(step_recorder()):
        # the first moment after the first step: (1 - beta1) times its
        # (clipped) gradients, whole
        mu1 = None

        def train_step(self, model, opt_state, batch_):
            out = super().train_step(model, opt_state, batch_)
            if self.mu1 is None:
                mu = out[1]["mu"]
                self.mu1 = (gathered(self, mu) if self.mesh is not None
                            else {n: t.clone() for n, t in mu.items()})
            return out

    class Averaged(Recorded):
        # the control: FSDP2 divides the summed gradients by dp
        def _shard(self, model):
            super()._shard(model)
            for module in model.modules():
                if hasattr(module, "set_gradient_divide_factor"):
                    module.set_gradient_divide_factor(float(mesh.size(0)))

    def run(m, cls=Recorded, steps=MESH_STEPS):
        model = LM(cfg, planner=planner, generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        first = ({n: p.detach().clone() for n, p in
                  model.named_parameters()} if m is None else None)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
            tr = cls(cfg, shape, m, TrainerConfig(ckpt_dir=tmp,
                                                  ckpt_every=10 ** 9),
                     ocfg, planner=planner, model=model)
            model, opt_state, hist = tr.run(steps)
        params = dict(model.named_parameters())
        if m is not None:
            params = gathered(tr, params)
        return dict(losses=[h["loss"] for h in hist], ms=tr.ms,
                    norms=[h["grad_norm"] for h in hist],
                    launches=tr.launches, unchanged=tr.unchanged,
                    first=first, params=params, mu1=tr.mu1)

    t0 = time.perf_counter()
    got = run(mesh)
    check(all(c == per_step for c in got["launches"]), f"gloo rank {rank} "
          f"(2, 2) mesh training: launches a step {got['launches']}, "
          f"expected {per_step}")
    check(not any(got["unchanged"]), f"gloo rank {rank} (2, 2) mesh "
          f"training: parameters unchanged by a step: "
          f"{[u[:3] for u in got['unchanged']]}")
    control = run(mesh, Averaged, 1)["norms"][0]
    if rank:
        del got
    lines = []
    if rank == 0:
        torch.cuda.empty_cache()
        one = run(None)
        drift = max(abs(a - b) / abs(b)
                    for a, b in zip(got["losses"], one["losses"]))
        norm_drift = max(abs(a - b) / abs(b)
                         for a, b in zip(got["norms"], one["norms"]))
        missed = abs(control - one["norms"][0]) / one["norms"][0]
        mu_name, mu_err = worst(rel_diffs(got["mu1"], one["mu1"]))
        moved = {n: ((got["params"][n] - p).norm()
                     / (p - one["first"][n]).norm()).item()
                 for n, p in one["params"].items()}
        par_name, par_err = worst(moved)
        check(drift <= MESH_F32_TOL and norm_drift <= MESH_F32_TOL,
              f"gloo (2, 2) mesh training: losses {got['losses']}, "
              f"grad_norms {got['norms']} against one rank's "
              f"{one['losses']}, {one['norms']}")
        check(mu_err <= MESH_F32_TOL, f"gloo (2, 2) mesh training: first "
              f"moment after step 1 {mu_name} err/max {mu_err} > "
              f"{MESH_F32_TOL}")
        check(par_err <= MESH_UPDATE_TOL, f"gloo (2, 2) mesh training: "
              f"parameter {par_name} |p - p1| / |p1 - p0| {par_err} > "
              f"{MESH_UPDATE_TOL}")
        check(missed > MESH_F32_TOL, f"gloo (2, 2) mesh training control "
              f"(gradients averaged over data): grad_norm {control} within "
              f"{MESH_F32_TOL} of one rank's {one['norms'][0]}")
        lines.append(
            f"gloo{GLOO_RANKS} mesh train olmo-1b width on {MESH_LAYERS} "
            f"(2, 2) (data, model), float32, {MESH_B} x {MESH_S} a step: "
            f"losses " + ", ".join(f"{x:.6f}" for x in got["losses"])
            + ", one rank " + ", ".join(f"{x:.6f}" for x in one["losses"])
            + f", err/|loss| {drift:.3e}, grad_norm {norm_drift:.3e} (tol "
            f"{MESH_F32_TOL}); first moment after step 1 err/max "
            f"{mu_err:.3e} (worst {mu_name}, tol {MESH_F32_TOL}); after "
            f"step {MESH_STEPS} parameters |p - p1| / |p1 - p0| "
            f"{par_err:.3e} (worst "
            f"{par_name}, tol {MESH_UPDATE_TOL}); every parameter changed "
            f"at every step; control (gradients averaged over data) "
            f"grad_norm {control:.6f} against {one['norms'][0]:.6f}, "
            f"{missed:.3e} off; rank 0 launches a step "
            f"{got['launches'][0]} (exact); step ms "
            f"{', '.join(f'{x:.1f}' for x in got['ms'])} (one rank "
            f"{', '.join(f'{x:.1f}' for x in one['ms'])}); "
            f"{time.perf_counter() - t0:.1f} s")
        del one, got
    dist.barrier()
    torch.cuda.empty_cache()
    # the sharded mixer's gradient over (4,), batch 1
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=mesh4, axis="fft")
    x = randn((1, MIXER_S, MIXER_D), gen)           # the same on every rank
    w = randn((1, MIXER_S, MIXER_D), gen)
    width = MIXER_S // GLOO_RANKS
    blk = slice(rank * width, (rank + 1) * width)
    got, launches, seconds = counted(
        lambda: mixer_grads(mixer, x[:, blk], w[:, blk], True))
    check(launches == SHARDED_GRAD_LAUNCHES, f"gloo rank {rank} sharded "
          f"mixer gradient: launches {launches}, expected "
          f"{SHARDED_GRAD_LAUNCHES}")
    got["x"] = gather_blocks(got["x"].contiguous(), mesh4, [(1, "fft")])
    want = mixer_grads(mixer, x, w, False)
    if rank == 0:
        errs = grad_errors(got, want)
        check(max(errs.values()) <= SHARDED_GRAD_TOL, f"gloo sharded mixer "
              f"gradient: err/max {errs} > {SHARDED_GRAD_TOL}")
        lines.append(
            f"gloo{GLOO_RANKS} sharded mixer gradient "
            f"FFTConvMixer({MIXER_D}, {MIXER_RANK}) {tuple(x.shape)} on "
            f"(4,): err/max " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs.items())
            + f" (tol {SHARDED_GRAD_TOL}) against the unsharded mixer; rank"
            f" 0 launches {launches} (exact); {seconds:.3f} s first call")
    del mixer, got
    torch.cuda.empty_cache()
    return lines + gloo_tp_mixer(rank, mesh, planner, x, w, want)


def gloo_tp_mixer(rank, mesh, planner, x, w, want) -> list:
    """Phase 18 (c), channel-parallel: the sequence-sharded mixer on the
    (2, 2) ("data", "model") mesh, the sequence over data and ``tp`` over
    model, on ``x`` and the cotangent ``w`` (batch 1): each rank's
    gradients of its blocks (its positions of x, its columns of w_in and
    rows of w_out, filt and skip whole) within SHARDED_GRAD_TOL of the
    unsharded mixer's ``want`` sliced alike, its launches exactly
    SHARDED_GRAD_LAUNCHES; the control (the filter gradient summed over
    model too, whose ranks hold other channels) must miss. Returns rank
    0's line."""
    import torch.distributed as dist
    from repro_torch.models import FFTConvMixer, blocks
    from repro_torch.models.blocks import Runs, TensorParallel
    t0 = time.perf_counter()
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=mesh, axis="data")
    mixer.tp = TensorParallel(mesh.get_group("model"), mesh.size(1),
                              mesh.get_local_rank("model"))
    layouts = {"w_in": Runs.cut(1, MIXER_D, MIXER_D),
               "w_out": Runs.cut(0, MIXER_D)}
    for name, layout in layouts.items():        # as LM.place cuts them
        param = getattr(mixer, name)
        param.data = mixer.tp.block(param.data, layout).clone()
    width = MIXER_S // mesh.size(0)
    i = mesh.get_local_rank("data")
    blk = slice(i * width, (i + 1) * width)
    got, launches, seconds = counted(
        lambda: mixer_grads(mixer, x[:, blk], w[:, blk], True))
    check(launches == SHARDED_GRAD_LAUNCHES, f"gloo rank {rank} "
          f"channel-parallel sharded mixer gradient: launches {launches}, "
          f"expected {SHARDED_GRAD_LAUNCHES}")
    mine = {k: v[:, blk] if k == "x" else
            mixer.tp.block(v, layouts[k]) if k in layouts else v
            for k, v in want.items()}
    errs = grad_errors(got, mine)
    check(max(errs.values()) <= SHARDED_GRAD_TOL, f"gloo rank {rank} "
          f"channel-parallel sharded mixer gradient: err/max {errs} > "
          f"{SHARDED_GRAD_TOL}")
    del got
    conv = blocks.fft_conv_seq_sharded
    blocks.fft_conv_seq_sharded = \
        lambda *a, channel_axis=None, **kw: conv(*a, **kw)
    try:
        control = grad_errors(
            mixer_grads(mixer, x[:, blk], w[:, blk], True),
            {"filt": want["filt"]})["filt"]
    finally:
        blocks.fft_conv_seq_sharded = conv
    check(control > SHARDED_GRAD_TOL, f"gloo rank {rank} channel-parallel "
          f"sharded mixer control (filter gradient summed over model) "
          f"within the limit: {control}")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (max(errs.values()), control))
    del mixer
    torch.cuda.empty_cache()
    if rank:
        return []
    return [f"gloo{GLOO_RANKS} channel-parallel sharded mixer gradient "
            f"FFTConvMixer({MIXER_D}, {MIXER_RANK}) {tuple(x.shape)} on "
            f"(2, 2) (data: the sequence, model: tp): rank 0 err/max "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + ", every rank's worst " + ", ".join(
                f"{e:.3e}" for e, _ in every)
            + f" (tol {SHARDED_GRAD_TOL}) against the unsharded mixer's "
            "slices; control (filter gradient summed over model too) "
            + ", ".join(f"{c:.3e}" for _, c in every)
            + f"; rank 0 launches {launches} (exact); {seconds:.3f} s "
            f"first call; {time.perf_counter() - t0:.1f} s"]


def widest_block():
    """A dispatch mode whose ``width`` is the largest last dim of the
    (..., S, X) tensors (3 dims or more) its ops yield: the logits' (or
    their block's) on the training path of an LM."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Widest(TorchDispatchMode):
        width = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.dim() >= 3:
                    self.width = max(self.width, t.shape[-1])
            return out
    return Widest()


def place_case(rank, name, cfg, dm, rows, seq) -> str:
    """loss_fn and its backward of ``cfg`` on a (data, model) mesh of
    shape ``dm`` (its LM drawn a parameter at a time, placed, then under
    FSDP2 through the Trainer) against one device's on the same global
    batch: every rank runs the one device first and keeps its own blocks
    of those gradients (``MeshLayout.shard``), so no gradient is gathered.
    Returns rank 0's line."""
    import datetime
    import torch.distributed as dist
    from repro_torch import make_mesh
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import LM, loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import padded_vocab
    from repro_torch.optim.adamw import local
    from repro_torch.parallel import make_rules
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.trainer import fsdp_dims
    t0 = time.perf_counter()
    free_host_cache()
    shape = ShapeConfig("train", seq, rows, "train")
    dp = dm[0]
    single = LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    batch = {k: torch.from_numpy(v).cuda().long() for k, v in
             SyntheticDataset(cfg, shape, SEED).batch_at(0).items()}
    loss = loss_fn(single, batch, dp)[0]
    loss.backward()
    ref_loss = float(loss.detach())
    ref = {n: p.grad for n, p in single.named_parameters()}
    del single, batch, loss
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    mesh = make_mesh(dm, ("data", "model"),
                     timeout=datetime.timedelta(seconds=300),
                     device_type="cuda")
    model = LM(cfg, device="meta")
    model.place(mesh, make_rules(mesh))
    model.draw(torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_place_") as tmp:
        tr = Trainer(cfg, shape, mesh, TrainerConfig(ckpt_dir=tmp,
                                                     seed=SEED),
                     model=model)
        model = tr.init_state()[0]
    # this rank's block of each of one device's gradients, and its max
    want_g = {}
    for n in list(ref):
        g = ref.pop(n)
        want_g[n] = (tr.shardings["params"][n].shard(g).clone(),
                     g.abs().max())
        del g
    torch.cuda.empty_cache()
    want = fsdp_dims(mesh, tr.meta, tr.rules)
    misplaced = [n for n, p in model.named_parameters()
                 if p.placements[0].dim != want[n]]
    check(not misplaced, f"gloo rank {rank} {name} on {dm}: FSDP2 "
          f"placements other than fsdp_dims's: {misplaced[:4]}")
    moved = sorted({n.rsplit(".", 1)[-1] + f" {want[n]}"
                    for n in want if want[n]})
    batch = tr.batch_at(0)
    widest = widest_block()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    with widest:
        loss = loss_fn(model, batch, tr.num_groups)[0]
        free_host_cache()
        loss.backward()
    torch.cuda.synchronize()
    t_cmp = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    block = padded_vocab(cfg) // dm[1]
    check(widest.width == block, f"gloo rank {rank} {name} on {dm}: the "
          f"widest tensor of the loss is {widest.width} wide, not the "
          f"vocab's block {block}")
    errs = {}
    for n, p in model.named_parameters():
        blk, scale = want_g.pop(n)
        g = local(p.grad)
        check(g.shape == blk.shape, f"gloo rank {rank} {name} on {dm}: "
              f"{n}'s gradient block {tuple(g.shape)}, one device's "
              f"{tuple(blk.shape)}")
        errs[n] = ((g - blk).abs().max() / scale.clamp(min=1e-30)).item() \
            if g.numel() else 0.0
    loss = float(loss.detach())
    every = [None] * GLOO_RANKS
    dist.all_gather_object(every, (peak, worst(errs)))
    peaks = [e[0] for e in every]
    worst_name, worst_err = max((e[1] for e in every), key=lambda x: x[1])
    del model, tr, batch, want_g
    free_host_cache()
    dist.barrier()
    if rank:
        return ""
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    check(loss_err <= PLACE_LOSS_TOL and worst_err <= PLACE_GRAD_TOL,
          f"gloo {name} on {dm}: loss {loss} against one device's "
          f"{ref_loss} ({loss_err:.3e}, tol {PLACE_LOSS_TOL}), worst "
          f"gradient {worst_name} err/max {worst_err:.3e} (tol "
          f"{PLACE_GRAD_TOL})")
    return (f"gloo{GLOO_RANKS} place {name} on {dm} (data, model), float32, "
            f"{rows} x {seq}: loss err/|loss| {loss_err:.3e} (tol "
            f"{PLACE_LOSS_TOL}), every gradient against one device err/max "
            f"{worst_err:.3e} (worst {worst_name}, tol {PLACE_GRAD_TOL}); "
            f"every FSDP2 placement fsdp_dims's (non-zero dims: "
            f"{', '.join(moved)}); widest tensor of the loss and its "
            f"backward {widest.width} wide (the vocab's block, "
            f"{padded_vocab(cfg)} / {dm[1]}); peak a rank in the loss and "
            f"its backward " + ", ".join(f"{x:.2f}" for x in peaks)
            + f" GiB; {time.perf_counter() - t0:.1f} s (one device "
            f"{t_ref - t0:.1f}, placing {t_step - t_ref:.1f}, loss and "
            f"backward {t_cmp - t_step:.1f}); host {host_gib():.1f} GiB")


def gloo_placement(rank) -> list:
    """Phase 18 (d) over the gloo ranks (``place_case``). Returns rank
    0's lines."""
    from repro_torch.configs import get_config
    olmo = get_config("olmo-1b")
    olmo = dataclasses.replace(olmo, num_layers=PLACE_LAYERS,
                               segments=(("attn_mlp", PLACE_LAYERS),),
                               compute_dtype="float32")
    phi = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              num_layers=PLACE_PHI_LAYERS,
                              compute_dtype="float32")
    lines = []
    for name, cfg, dm, seq in (
            (f"olmo-1b width on {PLACE_LAYERS} layers", olmo, (1, 4),
             PLACE_S),
            (f"olmo-1b width on {PLACE_LAYERS} layers", olmo, (2, 2),
             PLACE_S),
            (f"phi3.5-moe on {PLACE_PHI_LAYERS} layer", phi, (2, 2),
             PLACE_PHI_S)):
        lines.append(place_case(rank, name, cfg, dm, PLACE_B, seq))
        torch.cuda.empty_cache()
    return [line for line in lines if line]


# ---------------------------------------------------------------------------
# serving on a (data, model) mesh (phase 19)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def serve_profile_off():
    """For the block, build_cell's default (train) rules for serving."""
    import os
    saved = os.environ.pop("REPRO_SERVE_WEIGHT_STATIONARY", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["REPRO_SERVE_WEIGHT_STATIONARY"] = saved


def phase_mesh_serving(label, name, cfg, planner, kept, max_len, mesh,
                       per_prefill) -> dict:
    """Phase 19 (a) for one model: served through ServeLoop on ``mesh``
    against phase 15's ``kept`` rows; build_cell's prefill_step against
    phase 15's forward. Returns the served run's launches."""
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    t0 = time.perf_counter()
    prompts = kept["prompts"]
    with torch.no_grad(), serve_profile_off():
        model = LM(cfg, planner=planner, generator=torch.Generator(
            device="cuda").manual_seed(SEED)).to_compute_dtype()
        res = serve(model, cfg, prompts, new=MESH_SERVE_NEW, max_len=max_len,
                    mesh=mesh)
        want = {k: v * len(prompts) for k, v in per_prefill.items()}
        check(res["launches"] == want, f"{name} served on the (1, 1) mesh: "
              f"launches {res['launches']}, expected {want}")
        diff = max((a - b).abs().max().item() for rid, rows in
                   kept["rows"].items()
                   for a, b in zip(res["rows"][rid], rows))
        check(diff == 0.0, f"{name} served on the (1, 1) mesh: logits "
              f"{diff} off phase 15's")
        cell = build_cell(cfg, ShapeConfig("prefill", len(prompts[0]), 1,
                                           "prefill"), mesh)
        first = max((cell.fn(model, as_batch(p))[0, -1] - f).abs().max()
                    .item() for p, f in zip(prompts, kept["forward"]))
        check(first == 0.0, f"{name} prefill_step on the (1, 1) mesh: "
              f"logits {first} off phase 15's forward")
    rows = sum(len(r) for r in res["rows"].values())
    print(f"serve mesh {name} on a (1, 1) (data, model) mesh (NCCL, world "
          f"size 1, build_cell's decode cell, serve profile off): "
          f"{len(prompts)} requests, {MESH_SERVE_NEW} new each, {rows} "
          f"logits rows equal to phase 15's (max diff {diff}); prefill_step "
          f"equal to phase 15's forward (max diff {first}); launches "
          f"{res['launches']} (exact); decode "
          f"{statistics.median(res['decode_ms']):.3f} ms a step (phase "
          f"15's {kept['decode_ms']:.3f}; no FSDP2 on one data rank); "
          f"{time.perf_counter() - t0:.1f} s [{label}]")
    launches = res["launches"]
    del model, res
    torch.cuda.empty_cache()
    return launches


def gloo_mesh_serve(rank, planner) -> list:
    """Phase 19 (b) over the gloo ranks: each case served on its mesh
    (build_cell's decode cell) against rank 0's one-device model, with the
    controls. Returns rank 0's lines."""
    import datetime
    import torch.distributed as dist
    from repro_torch import kernels, make_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM, blocks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import NamedSharding
    phi = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              num_layers=GLOO_PHI_LAYERS,
                              compute_dtype="float32",
                              param_dtype="bfloat16")
    cases = [("olmo-1b width on MESH_LAYERS", mesh_cfg(), (1, 4),
              SERVE_BATCH, GLOO_SERVE_S),
             ("olmo-1b width on MESH_LAYERS", mesh_cfg(), (2, 2),
              SERVE_BATCH, GLOO_SERVE_S),
             (f"phi3.5-moe on {GLOO_PHI_LAYERS} layers", phi, (1, 4),
              SERVE_BATCH, GLOO_PHI_S),
             ("olmo-1b width on MESH_LAYERS, flash decoding", mesh_cfg(),
              (4, 1), 1, GLOO_SERVE_S)]
    lines = []

    def no_model_sum(moe_fwd):
        from unittest import mock

        def run(*args, **kwargs):
            with mock.patch.object(blocks.TensorParallel, "reduce",
                                   lambda self, y, dtype: y):
                return moe_fwd(*args, **kwargs)
        return run

    def no_rescale(_):
        def combine(m, num, den, seq):
            both = seq.reduce(torch.cat([num, den], -1))
            return both[..., :-1] / both[..., -1:]
        return combine

    for name, cfg, dm, batch, s in cases:
        t0 = time.perf_counter()
        max_len = s + GLOO_SERVE_NEW
        mesh = make_mesh(dm, ("data", "model"),
                         timeout=datetime.timedelta(seconds=300),
                         device_type="cuda")
        with serve_profile_off():
            cell = build_cell(cfg, ShapeConfig("serve", max_len, batch,
                                               "decode"), mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        prompts = torch.randint(0, cfg.vocab_size, (batch, s), generator=gen,
                                device="cuda")
        steps = torch.randint(0, cfg.vocab_size, (GLOO_SERVE_NEW, batch, 1),
                              generator=gen, device="cuda")
        # the cache's layout (LM.seq_split): this rank's rows, or all
        split = not (batch % dm[0] == 0 and batch >= dm[0])
        n = batch // dm[0]
        first = mesh.get_local_rank("data") * n
        rows = slice(None) if split else slice(first, first + n)

        def run(m, step, groups, gather, rows=rows, routes=None):
            # a MoE's routing logged (one device) or replayed (the mesh)
            with torch.no_grad(), float32_cache(), (
                    patched("moe_route", routes) if routes
                    else contextlib.nullcontext()):
                lg, cache = m.prefill({"tokens": prompts[rows]}, max_len,
                                      groups, global_batch=batch)
                out = [gather(lg)]
                for tok in steps:
                    lg, cache = step(cache, {"tokens": tok[rows]})
                    out.append(gather(lg))
            # the vocabulary's columns (the padding ones hold -1e30)
            return torch.cat(out, 1)[..., :cfg.vocab_size]

        def gather(lg):
            if split or dm[0] == 1:
                return lg
            return NamedSharding(mesh, ("data", None, None)).gather(lg)

        # rank 0's one-device model first: its MoE routing, replayed on
        # the mesh (routes_replayed)
        log = [None]
        if rank == 0:
            single = LM(cfg, planner=planner, generator=torch.Generator(
                device="cuda").manual_seed(SEED))
            log[0] = []
            want_rows = run(single, lambda c, t: single.decode_step(
                c, t, dm[0]), dm[0], lambda lg: lg, slice(None),
                routes_replayed(log[0], False))
            del single
            torch.cuda.empty_cache()
        dist.broadcast_object_list(log, src=0)
        log = log[0]

        def replay():
            return routes_replayed(log, True) if cfg.num_experts else None

        model = cell.build(torch.Generator(device="cuda").manual_seed(SEED),
                           planner)
        check(model.seq_split(batch) == split, "the cache's layout")

        def step(cache, tok):
            return cell.fn(model, cache, tok)

        kernels.reset_launch_counts()
        got = run(model, step, dm[0], gather, routes=replay())
        launches = kernels.launch_counts()
        n_conv = sum(c for k, c in cfg.resolved_segments()
                     if k == "fftconv_mlp")
        want = {k: v * n_conv for k, v in LM_LAYER_LAUNCHES.items()}
        check(launches == want, f"gloo rank {rank} serve {name} on {dm}: "
              f"launches {launches}, expected {want}")
        control = None
        if cfg.num_experts:
            with patched("moe_fwd", no_model_sum):
                control = run(model, step, dm[0], gather, routes=replay())
        elif split:
            with patched("lse_combine", no_rescale):
                control = run(model, step, dm[0], gather)
        del model
        torch.cuda.empty_cache()
        if rank == 0:
            scale = want_rows.abs().max().item()
            err = (got - want_rows).abs().max().item() / scale
            check(math.isfinite(err) and err <= GLOO_SERVE_TOL,
                  f"gloo serve {name} on {dm}: err/max {err} > "
                  f"{GLOO_SERVE_TOL}")
            line = (f"gloo{GLOO_RANKS} serve mesh {name} on {dm} (data, "
                    f"model), float32, batch {batch}, {s} + "
                    f"{GLOO_SERVE_NEW} tokens: {got.shape[1]} logits rows "
                    f"a sequence err/max {err:.3e} (tol {GLOO_SERVE_TOL}) "
                    f"against one device; rank 0 launches {launches} "
                    f"(exact)")
            if control is not None:
                missed = (control - want_rows).abs().max().item() / scale
                what = ("experts without the sum over model"
                        if cfg.num_experts else "partials not rescaled")
                check(missed > GLOO_SERVE_TOL, f"gloo serve {name} control "
                      f"({what}) within {GLOO_SERVE_TOL}: {missed}")
                line += f"; control ({what}) {missed:.3e}"
            lines.append(line + f"; {time.perf_counter() - t0:.1f} s")
        del got, control
        torch.cuda.empty_cache()
        dist.barrier()
    return lines


# ---------------------------------------------------------------------------
# the recurrent kinds, zamba2's shared block and the frontends on a mesh
# (phase 20)
# ---------------------------------------------------------------------------


def phase_mesh_kinds(label, name, kept, mesh) -> dict:
    """Phase 20 (a) for one model: served through ServeLoop on ``mesh``
    with phase 16's prompts and weights, every row equal to phase 16's
    (``kept``). Returns the served run's launches (none)."""
    from repro_torch.models import LM
    t0 = time.perf_counter()
    cfg = kind_config(name, dict(KIND_MODELS)[name])
    with torch.no_grad(), serve_profile_off():
        model = LM(cfg, generator=torch.Generator(
            device="cuda").manual_seed(SEED)).to_compute_dtype()
        res = serve(model, cfg, kept["prompts"], new=KIND_NEW, mesh=mesh)
    check(sum(res["launches"].values()) == 0,
          f"{name} served on the (1, 1) mesh launched {res['launches']}")
    diff = max((a - b).abs().max().item() for rid, rows in
               kept["rows"].items()
               for a, b in zip(res["rows"][rid], rows, strict=True))
    check(diff == 0.0, f"{name} served on the (1, 1) mesh: logits {diff} "
          "off phase 16's")
    rows = sum(len(r) for r in res["rows"].values())
    n = sum(len(t) for t in res["tokens"].values())
    print(f"serve mesh {name} on a (1, 1) (data, model) mesh (NCCL, world "
          f"size 1, build_cell's decode cell, serve profile off): "
          f"{len(kept['prompts'])} requests of {KIND_PROMPT} tokens, "
          f"{KIND_NEW} new each, {rows} logits rows equal to phase 16's "
          f"(max diff {diff}); launches {res['launches']} (none); decode "
          f"{statistics.median(res['decode_ms']):.3f} ms a step (phase 16's "
          f"{kept['decode_ms']:.3f}); {n / res['seconds']:.1f} tok/s "
          f"drained; peak {res['peak'] / 2 ** 30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s [{label}]")
    launches = res["launches"]
    del model, res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kinds_cfg(name, changes):
    """``name`` at full width cut as ``changes`` says, float32 compute."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), compute_dtype="float32",
                               **changes)


def kinds_inputs(cfg, batch: int, gen):
    """A prompt of GLOO_KINDS_S positions and GLOO_SERVE_NEW one-position
    steps: tokens, or a frontend's synthetic embeddings (qwen2-vl's prompt
    on M-RoPE streams: a MROPE_GRID^2 image, then text), drawn from
    ``gen`` (the same on every rank)."""
    from repro_torch.models import mrope_positions, synth_embeddings
    s, n = GLOO_KINDS_S, GLOO_SERVE_NEW
    if cfg.frontend:
        x = synth_embeddings(cfg, batch, s + n, gen)
        key = "embeds"
    else:
        x = torch.randint(0, cfg.vocab_size, (batch, s + n), generator=gen,
                          device="cuda")
        key = "tokens"
    prompt = {key: x[:, :s]}
    if cfg.rope == "mrope":
        prompt["positions"] = mrope_positions(batch, s, MROPE_GRID)
    return prompt, [{key: x[:, i:i + 1]} for i in range(s, s + n)]


def rows_of(batch: dict, rows) -> dict:
    """The rows ``rows`` of every entry of ``batch`` (of each M-RoPE
    stream)."""
    return {k: v[:, rows] if k == "positions" else v[rows]
            for k, v in batch.items()}


def per_rank_norm(self, y):
    """The control: a norm over the whole inner width computed on this
    rank's channels alone (their mean square, no all-reduce)."""
    return y.float().square().sum(-1, keepdim=True) * self.size


def gloo_kinds_serve(rank, name, cfg, dm, batch) -> str:
    """Phase 20 (b), one serving case: ``cfg`` on ``dm`` (build_cell's
    decode cell) against rank 0's one-device model. Returns rank 0's
    line."""
    import datetime
    from unittest import mock
    import torch.distributed as dist
    from repro_torch import kernels, make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import LM, blocks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import NamedSharding
    t0 = time.perf_counter()
    max_len = GLOO_KINDS_S + GLOO_SERVE_NEW
    mesh = make_mesh(dm, ("data", "model"),
                     timeout=datetime.timedelta(seconds=300),
                     device_type="cuda")
    with serve_profile_off():
        cell = build_cell(cfg, ShapeConfig("serve", max_len, batch,
                                           "decode"), mesh)
    prompt, steps = kinds_inputs(cfg, batch, torch.Generator(
        device="cuda").manual_seed(SEED + 3))
    split = not (batch % dm[0] == 0 and batch >= dm[0])
    n = batch // dm[0]
    first = mesh.get_local_rank("data") * n
    rows = slice(None) if split else slice(first, first + n)

    def gather(lg):
        if split or dm[0] == 1:
            return lg
        return NamedSharding(mesh, ("data", None, None)).gather(lg)

    def run(m, step, gather, rows=rows):
        with torch.no_grad(), float32_cache():
            lg, cache = m.prefill(rows_of(prompt, rows), max_len,
                                  global_batch=batch)
            out = [gather(lg)]
            for one in steps:
                lg, cache = step(cache, rows_of(one, rows))
                out.append(gather(lg))
        return torch.cat(out, 1)[..., :cfg.vocab_size]

    want = None
    if rank == 0:
        single = LM(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        want = run(single, single.decode_step, lambda lg: lg, slice(None))
        del single
        torch.cuda.empty_cache()
    model = cell.build(torch.Generator(device="cuda").manual_seed(SEED))
    check(model.seq_split(batch) == split, "the cache's layout")

    def step(cache, one):
        return cell.fn(model, cache, one)

    kernels.reset_launch_counts()
    got = run(model, step, gather)
    launches = kernels.launch_counts()
    check(sum(launches.values()) == 0, f"gloo rank {rank} serve {name} on "
          f"{dm}: launches {launches}, expected none")
    control = None
    if dm == (1, GLOO_RANKS) and not cfg.frontend:
        with mock.patch.object(blocks.TensorParallel, "sum_squares",
                               per_rank_norm):
            control = run(model, step, gather)
    del model
    torch.cuda.empty_cache()
    line = None
    if rank == 0:
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / scale
        check(math.isfinite(err) and err <= GLOO_SERVE_TOL,
              f"gloo serve {name} on {dm}: err/max {err} > "
              f"{GLOO_SERVE_TOL}")
        line = (f"gloo{GLOO_RANKS} serve mesh {name} on {dm} (data, model), "
                f"float32, batch {batch}, {GLOO_KINDS_S} + {GLOO_SERVE_NEW} "
                f"positions: {got.shape[1]} logits rows a sequence err/max "
                f"{err:.3e} (tol {GLOO_SERVE_TOL}) against one device; "
                f"rank 0 launches {launches} (none)")
        if control is not None:
            missed = (control - want).abs().max().item() / scale
            check(missed > GLOO_SERVE_TOL, f"gloo serve {name} control "
                  f"(per-rank norm) within {GLOO_SERVE_TOL}: {missed}")
            line += f"; control (per-rank norm) {missed:.3e}"
        line += f"; {time.perf_counter() - t0:.1f} s"
    del got, want, control
    torch.cuda.empty_cache()
    dist.barrier()
    return line


def gloo_kinds_train(rank, name, cfg) -> str:
    """Phase 20 (b), one training step: ``cfg`` through a (2, 2) Trainer
    against rank 0's one device (the loss, every gradient), and the
    control (B and C's gradients each rank's own). Returns rank 0's
    line."""
    import datetime
    from unittest import mock
    import torch.distributed as dist
    from repro_torch import make_mesh
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import LM, blocks, loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    t0 = time.perf_counter()
    dm = (2, GLOO_RANKS // 2)
    shape = ShapeConfig("train", GLOO_KINDS_S, KINDS_TRAIN_B, "train")
    mesh = make_mesh(dm, ("data", "model"),
                     timeout=datetime.timedelta(seconds=300),
                     device_type="cuda")

    def step(names=None):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kinds_") as tmp:
            tr = Trainer(cfg, shape, mesh, TrainerConfig(ckpt_dir=tmp,
                                                         seed=SEED),
                         model=LM(cfg, generator=torch.Generator(
                             device="cuda").manual_seed(SEED)))
            model, _, _ = tr.init_state()
            loss, _ = loss_fn(model, tr.batch_at(0), tr.num_groups)
            loss.backward()
            mine = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                    for n, p in model.named_parameters()}
            grads = {n: tr.shardings["params"][n].gather(g)
                     for n, g in mine.items()
                     if names is None or n.endswith(names)}
            norms = mesh_grad_norms(tr, mine)
        del tr, model, mine
        gc.collect()
        torch.cuda.empty_cache()
        return loss.item(), grads, norms

    loss, grads, (norm, run_norms) = step()
    mamba = ("in_proj", "conv_w")
    with mock.patch.object(blocks.TensorParallel, "sync",
                           lambda self, w, layout: w):
        control = step(mamba)[1] if "mamba2" in {
            k for k, _ in cfg.resolved_segments()} else None
    line = None
    if rank == 0:
        single = LM(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        batch = {k: torch.from_numpy(v).to("cuda").long()
                 if k in ("tokens", "labels") else
                 torch.from_numpy(v).to("cuda")
                 for k, v in SyntheticDataset(cfg, shape, SEED)
                 .batch_at(0).items()}
        want, _ = loss_fn(single, batch, dm[0])
        want.backward()
        ref = {n: p.grad for n, p in single.named_parameters()}
        del single
        loss_err = abs(loss - want.item()) / abs(want.item())
        errs = {n: ((g - ref[n]).abs().max()
                    / ref[n].abs().max().clamp(min=1e-30)).item()
                for n, g in grads.items()}
        bad, err = max(errs.items(), key=lambda kv: kv[1])
        check(loss_err <= KINDS_LOSS_TOL and err <= KINDS_GRAD_TOL,
              f"gloo train {name} on {dm}: loss {loss_err} (tol "
              f"{KINDS_LOSS_TOL}), gradient {bad} {err} (tol "
              f"{KINDS_GRAD_TOL})")
        want = math.sqrt(sum(g.double().square().sum().item()
                             for g in ref.values()))
        norm_err = abs(norm - want) / want
        runs_err, unweighted = {}, {}
        for n, (got, dropped, layout) in run_norms.items():
            keep = torch.cat([torch.full((k,), not cut) for k, cut in
                              layout.runs]).nonzero().squeeze(1)
            w = ref[n].index_select(layout.dim, keep.to(ref[n].device)
                                    ).double().norm().item()
            runs_err[n] = abs(got - w) / w
            unweighted[n] = abs(dropped - w) / w
        check(norm_err <= KINDS_NORM_TOL
              and all(e <= KINDS_NORM_TOL for e in runs_err.values()),
              f"gloo train {name} on {dm}: gradient norm {norm} against "
              f"{want} ({norm_err}), B and C runs {runs_err} (tol "
              f"{KINDS_NORM_TOL})")
        check(all(e > KINDS_NORM_TOL for e in unweighted.values()),
              f"gloo train {name} control (B and C's norm without the "
              f"NormShare weight) within {KINDS_NORM_TOL}: {unweighted}")
        line = (f"gloo{GLOO_RANKS} train mesh {name} on {dm} (data, model), "
                f"float32, {KINDS_TRAIN_B} x {GLOO_KINDS_S} tokens, one "
                f"Trainer step against one device: loss {loss:.6f} err "
                f"{loss_err:.3e} (tol {KINDS_LOSS_TOL}); {len(errs)} "
                f"gradients, worst err/max {err:.3e} ({bad}; tol "
                f"{KINDS_GRAD_TOL}); gradient norm {norm:.6f} err "
                f"{norm_err:.3e} (tol {KINDS_NORM_TOL})")
        if runs_err:
            line += (f"; B and C runs' norm in {len(runs_err)} tensors, "
                     f"worst err {max(runs_err.values()):.3e}, control "
                     f"(NormShare weight dropped) least miss "
                     f"{min(unweighted.values()):.3e}")
        if control is not None:
            missed = max(((g - ref[n]).abs().max() / ref[n].abs().max())
                         .item() for n, g in control.items())
            check(missed > KINDS_GRAD_TOL, f"gloo train {name} control (B "
                  f"and C's gradients not summed) within {KINDS_GRAD_TOL}: "
                  f"{missed}")
            line += (f"; control (B and C's gradients not summed over "
                     f"model) {missed:.3e}")
        line += f"; {time.perf_counter() - t0:.1f} s"
        del ref, want
    del grads, control
    torch.cuda.empty_cache()
    dist.barrier()
    return line


def mesh_grad_norms(tr, grads: dict) -> tuple:
    """(the gradient norm that ``global_norm`` reads from this rank's
    blocks ``grads`` with the Trainer's groups, {name: (the norm of its
    whole runs alone, the same with the ``NormShare`` weight dropped, its
    ``blocks.Runs``)} of every tensor with whole runs inside its block:
    Mamba2's ``in_proj`` and ``conv_w``). Collectives: every rank calls
    it."""
    from repro_torch.optim.adamw import NormShare, global_norm, local
    runs = {}
    for n, share in tr.shard_groups.items():
        if isinstance(share, NormShare):
            whole = local(grads[n]) * (share.weight < 1)
            runs[n] = (global_norm({n: whole}, {n: share}).item(),
                       global_norm({n: whole}, {n: share.groups}).item(),
                       tr.shardings["params"][n].layout)
    return global_norm(grads, tr.shard_groups).item(), runs


def free_host_cache() -> None:
    """Give back the pinned host blocks that gloo's copies of CUDA tensors
    leave in PyTorch's caching host allocator (at full width four ranks'
    cached blocks outgrow the host's memory)."""
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        if hasattr(torch._C, name):
            getattr(torch._C, name)()
            return


def host_gib() -> float:
    """This process's resident host memory, GiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2 ** 20
    return float("nan")


def gloo_mesh_kinds(rank) -> list:
    """Phase 20 (b) over the gloo ranks: GLOO_KINDS served on (1, 4),
    (2, 2) and, at batch 1, (4, 1), and the recurrent two trained a step on
    (2, 2), each against rank 0's one-device model, with the controls.
    Returns rank 0's lines, each with rank 0's resident host memory after
    it."""
    lines = []
    free_host_cache()
    for name, changes in GLOO_KINDS:
        cfg = kinds_cfg(name, changes)
        what = (f"{name} " + ("+".join(f"{n} {k}" for k, n in
                                       cfg.resolved_segments())))
        cases = [functools.partial(gloo_kinds_serve, rank, what, cfg, dm,
                                   batch)
                 for dm, batch in (((1, GLOO_RANKS), SERVE_BATCH),
                                   ((2, GLOO_RANKS // 2), SERVE_BATCH),
                                   ((GLOO_RANKS, 1), 1))]
        if name in KIND_MESH_MODELS:
            cases.append(functools.partial(gloo_kinds_train, rank, what, cfg))
        for case in cases:
            line = case()
            free_host_cache()
            if line is not None:
                lines.append(f"{line}; host {host_gib():.1f} GiB")
    return lines


# ---------------------------------------------------------------------------
# training a GPipe pipeline over pod (phase 21)
# ---------------------------------------------------------------------------


def cell_step(cell, model, opt_state, batch) -> tuple:
    """(metrics, {name: this rank's block of each gradient AdamW was
    handed}) of one step of ``cell``'s ``train_step``: for a pipelined
    cell, the gradients after their sum over pod."""
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import local
    seen = {}
    update = specs.adamw_update

    def spy(ocfg, grads, params, state, groups=None):
        seen.update({n: local(g).detach().clone() for n, g in grads.items()})
        return update(ocfg, grads, params, state, groups)
    specs.adamw_update = spy
    try:
        _, _, metrics = cell.fn(model, opt_state, batch)
    finally:
        specs.adamw_update = update
    return metrics, seen


def one_device_step(cfg, batch, whole: bool = True) -> dict:
    """One float32 step of ``cfg`` on this card alone from SEED's weights:
    ``loss_fn``, its backward and ``adamw_update`` (build_cell's AdamW
    config). Returns the loss, grad_norm and gradients, and where
    ``whole``, the first moment and the parameters before and after."""
    from repro_torch.models import LM, loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    model = LM(cfg, generator=torch.Generator(device="cuda")
               .manual_seed(SEED))
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    state = adamw_init(params)
    _, state, om = adamw_update(AdamWConfig(), grads, params, state)
    out = dict(loss=loss.item(), grad_norm=om["grad_norm"].item(),
               grads={n: g.detach() for n, g in grads.items()})
    if whole:
        out.update(mu=state["mu"], before=before,
                   after={n: p.detach() for n, p in params.items()})
    del model, params, state, before
    return out


def update_errors(got: dict, want: dict, before: dict) -> dict:
    """Per tensor |p - p1| / |p1 - p0| (L2): each parameter's distance
    after a step from the reference step's, over that step's update."""
    return {n: ((got[n] - w).norm() / (w - before[n]).norm()).item()
            for n, w in want.items()}


def phase_pipeline(label, olmo, single_ms: float, mesh) -> dict:
    """Phase 21 (a): build_cell(..., pipeline=True) on the (1, 1, 1) mesh
    ``mesh``. Returns the bfloat16 steps' launches."""
    from repro_torch import kernels
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import local
    t0 = time.perf_counter()
    shape = ShapeConfig("train", OLMO_TRAIN_S, OLMO_TRAIN_B, "train")
    batch = train_batch(olmo, OLMO_TRAIN_B, OLMO_TRAIN_S, "cuda")
    cfg32 = dataclasses.replace(olmo, compute_dtype="float32")
    want = one_device_step(cfg32, batch)
    torch.cuda.empty_cache()
    cell = build_cell(cfg32, shape, mesh, pipeline=True)
    check(cell.pipelined, "phase 21: build_cell(pipeline=True) on (1, 1, 1)"
          " gave no pipelined cell")
    model = cell.build(torch.Generator(device="cuda").manual_seed(SEED))
    opt = adamw_init(dict(model.named_parameters()))
    (metrics, grads), launches, seconds = counted(
        lambda: cell_step(cell, model, opt, batch))
    after = {n: local(p).detach() for n, p in model.named_parameters()}
    loss_err = abs(metrics["loss"].item() - want["loss"]) / want["loss"]
    norm_err = (abs(metrics["grad_norm"].item() - want["grad_norm"])
                / want["grad_norm"])
    g_name, g_err = worst(rel_diffs(grads, want["grads"]))
    m_name, m_err = worst(rel_diffs({n: local(t) for n, t in
                                     opt["mu"].items()}, want["mu"]))
    u_name, u_err = worst(update_errors(after, want["after"],
                                        want["before"]))
    check(launches == dict.fromkeys(launches, 0), f"phase 21: launches "
          f"{launches} in a step of attn_mlp layers")
    check(loss_err <= PIPE_P1_LOSS_TOL and norm_err <= PIPE_P1_NORM_TOL,
          f"phase 21: loss {metrics['loss'].item()}, grad_norm "
          f"{metrics['grad_norm'].item()} against one device's "
          f"{want['loss']}, {want['grad_norm']}")
    check(g_err <= PIPE_P1_GRAD_TOL and m_err <= PIPE_P1_GRAD_TOL,
          f"phase 21: gradient {g_name} err/max {g_err}, first moment "
          f"{m_name} {m_err} > {PIPE_P1_GRAD_TOL}")
    check(u_err <= MESH_UPDATE_TOL, f"phase 21: parameter {u_name} after "
          f"the step |p - p1| / |p1 - p0| {u_err} > {MESH_UPDATE_TOL}")
    del model, opt, grads, after, want, cell
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cell = build_cell(olmo, shape, mesh, pipeline=True)
    model = cell.build(torch.Generator(device="cuda").manual_seed(SEED))
    opt = adamw_init(dict(model.named_parameters()))
    ms, losses, step_launches = [], [], []
    for _ in range(PIPE_STEPS):
        (_, _, m), counts, sec = counted(lambda: cell.fn(model, opt, batch))
        ms.append(sec * 1e3)
        losses.append(m["loss"].item())
        step_launches.append(counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, busy, ops = phase_profile(label, [(
        f"pipelined olmo-1b training step on (1, 1, 1) {OLMO_TRAIN_B} x "
        f"{OLMO_TRAIN_S}", lambda: cell.fn(model, opt, batch))], top=15)[0]
    check(all(map(math.isfinite, losses)), f"phase 21: losses {losses}")
    check(all(c == dict.fromkeys(c, 0) for c in step_launches),
          f"phase 21: launches a step {step_launches}")
    step_ms = statistics.median(ms[1:])
    print(f"train pipeline olmo-1b on a (1, 1, 1) (pod, data, model) mesh, "
          f"NCCL world size 1, {OLMO_TRAIN_B} x {OLMO_TRAIN_S} tokens in "
          f"{OLMO_TRAIN_B} microbatches: float32 twin against one device: "
          f"loss err/|loss| {loss_err:.3e} (tol {PIPE_P1_LOSS_TOL}), "
          f"grad_norm {norm_err:.3e} (tol {PIPE_P1_NORM_TOL}), gradients "
          f"err/max {g_err:.3e} (worst {g_name}), first moment {m_err:.3e} "
          f"(worst {m_name}) (tol {PIPE_P1_GRAD_TOL}), parameters after "
          f"the step |p - p1| / |p1 - p0| {u_err:.3e} (worst {u_name}, tol "
          f"{MESH_UPDATE_TOL}), {seconds:.3f} s; bfloat16 losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)}, median of steps "
          f"2-{PIPE_STEPS} {step_ms:.3f} ms ({single_ms:.3f} in phase 17, "
          f"{step_ms / single_ms:.3f}x), "
          f"{OLMO_TRAIN_B * OLMO_TRAIN_S / (step_ms / 1e3):.0f} tokens/s; "
          f"peak {peak:.2f} GiB; launches 0 a step (exact); traced step "
          f"wall {wall:.1f} ms, busy {busy / wall:.1%}, {ops} device ops; "
          f"{time.perf_counter() - t0:.1f} s [{label}]")
    total = {k: sum(c[k] for c in step_launches) for k in step_launches[0]}
    del model, opt, cell
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    return total


def gloo_pipeline(rank) -> list:
    """Phase 21 (b) over the gloo ranks: olmo-1b at full width on
    GLOO_PIPE_LAYERS layers, float32, build_cell(..., pipeline=True)'s step
    on each of GLOO_PIPE_MESHES, every rank holding its stage's gradients
    against one device's, and the control. Returns rank 0's lines."""
    import datetime
    import torch.distributed as dist
    from repro_torch import kernels, make_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import padded_vocab
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import pipelined_lm
    free_host_cache()
    cfg = dataclasses.replace(get_config("olmo-1b"),
                              num_layers=GLOO_PIPE_LAYERS,
                              compute_dtype="float32")
    shape = ShapeConfig("train", GLOO_PIPE_S, GLOO_PIPE_B, "train")
    batch = train_batch(cfg, GLOO_PIPE_B, GLOO_PIPE_S, "cuda")
    want = one_device_step(cfg, batch, whole=False)
    timeout = datetime.timedelta(seconds=300)
    lines = []

    def run(dm):
        t0 = time.perf_counter()
        mesh = make_mesh(dm, ("pod", "data", "model"), timeout=timeout,
                         device_type="cuda")
        cell = build_cell(cfg, shape, mesh, pipeline=True)
        check(cell.pipelined, f"gloo pipeline {dm}: not pipelined")
        rows = {k: torch.from_numpy(v).long().to("cuda") for k, v in
                SyntheticDataset(cfg, shape, seed=SEED).sharded_batch_at(
                    0, mesh, cell.rules).items()}
        model = cell.build(torch.Generator(device="cuda").manual_seed(SEED))
        opt = adamw_init(dict(model.named_parameters()))
        widest = widest_block()
        with widest:
            (metrics, grads), launches, _ = counted(
                lambda: cell_step(cell, model, opt, rows))
        check(launches == dict.fromkeys(launches, 0), f"gloo rank {rank} "
              f"pipeline {dm}: launches {launches}")
        sh = cell.placed["shardings"]
        errs = {}
        for n, g in grads.items():
            whole = sh[n].gather(g)
            w = want["grads"][model.whole_name(n)]
            errs[model.whole_name(n)] = ((whole - w).abs().max()
                                         / w.abs().max()).item()
        loss_err = abs(metrics["loss"].item() - want["loss"]) / want["loss"]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (loss_err, worst(errs), widest.width))
        del model, opt, grads, cell
        free_host_cache()
        return every, time.perf_counter() - t0

    for dm in GLOO_PIPE_MESHES:
        every, sec = run(dm)
        loss_err = max(e[0] for e in every)
        name, err = max((e[1] for e in every), key=lambda x: x[1])
        check(loss_err <= GLOO_PIPE_LOSS_TOL and err <= GLOO_PIPE_GRAD_TOL,
              f"gloo pipeline {dm}: loss err {loss_err}, gradient {name} "
              f"err/max {err} (tol {GLOO_PIPE_LOSS_TOL}, "
              f"{GLOO_PIPE_GRAD_TOL})")
        # the last stage's head and loss hold the vocab in blocks
        width = max(e[2] for e in every)
        vocab = ""
        if dm[2] > 1:
            block = padded_vocab(cfg) // dm[2]
            check(width == block, f"gloo pipeline {dm}: the widest tensor "
                  f"of the step is {width} wide, not the vocab's block "
                  f"{block}")
            vocab = (f"widest tensor of the step on any stage {width} (the "
                     f"vocab's block, {padded_vocab(cfg)} / {dm[2]}); ")
        lines.append(
            f"gloo{GLOO_RANKS} pipeline olmo-1b width on {GLOO_PIPE_LAYERS} "
            f"layers on {dm} (pod, data, model), float32, {GLOO_PIPE_B} x "
            f"{GLOO_PIPE_S}: loss err/|loss| {loss_err:.3e} (tol "
            f"{GLOO_PIPE_LOSS_TOL}), every gradient against one device "
            f"err/max {err:.3e} (worst {name}, tol {GLOO_PIPE_GRAD_TOL}); "
            f"{vocab}launches 0 on every rank; {sec:.1f} s; rank 0 host "
            f"{host_gib():.1f} GiB")
    sync = pipelined_lm.sync_pod_grads
    pipelined_lm.sync_pod_grads = lambda model, grads, mesh: None
    try:
        every, _ = run((4, 1, 1))
    finally:
        pipelined_lm.sync_pod_grads = sync
    name, err = max((e[1] for e in every), key=lambda x: x[1])
    check(err > GLOO_PIPE_GRAD_TOL, f"gloo pipeline control (no pod sum of "
          f"the whole-over-pod gradients) within the limit: {name} {err}")
    lines.append(f"gloo{GLOO_RANKS} pipeline control (the whole-over-pod "
                 f"gradients not summed over pod) on (4, 1, 1): {name} "
                 f"err/max {err:.3e} (must exceed {GLOO_PIPE_GRAD_TOL})")
    kernels.reset_launch_counts()
    del want
    free_host_cache()
    return lines if rank == 0 else []


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch import Planner
    from repro_torch.calibrate import card_label, measure
    from repro_torch.core.plan import H100
    from repro_torch.kernels import _build

    # phase 1: card, build, TF32 off, calibration
    label = card_label()
    print(label)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cal = measure()
    print(f"calibration: matmul f32 {cal['matmul_f32_flops'] / 1e12:.2f} "
          f"TFLOP/s, copy {cal['copy_bytes_per_s'] / 1e12:.3f} TB/s, "
          f"four-step share of its bound {cal['four_step_share']:.4f} at "
          f"{cal['four_step_ms']:.3f} ms (H100 profile: "
          f"{H100.flops / 1e12:.2f} TFLOP/s, {H100.hbm_bw / 1e12:.3f} TB/s, "
          f"fft_share {H100.fft_share}) [{label}]")

    planner = Planner(backends=("hopper",))
    for n in (16384, 512):
        check_two_factor_hopper(planner, n)
    main_shapes = {"rfftn column pass": ((8193, 16384),
                                         planner.plan(16384, "c2c").factors),
                   "fftn 512^3 pass": ((512 * 512, 512),
                                       planner.plan(512, "c2c").factors)}

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = phase_kernels(gen, main_shapes)
    conv_factors = planner.plan(2 * MIXER_S, "c2c", permuted=True).factors
    errs.update(phase_conv_kernels(gen, conv_factors, errs))
    phase_sharded_conv_kernels(gen, planner, errs)
    phase_lm_kernels(gen, conv_factors, errs)
    phase_lm_kernels(gen, conv_factors, errs, tp=GLOO_RANKS)
    phase_train_kernels(gen, conv_factors, errs)
    print("kernels " + json.dumps(errs))

    # phase 3: the N-D FFT path at real size
    x = randn((16384, 16384), gen)
    z = (randn((512,) * 3, gen), randn((512,) * 3, gen))
    launches = phase_main_path(planner, x, z)

    # phase 4: its times
    planners = {"hopper": planner, "torch": Planner(backends=("torch",))}
    times = phase_times(label, planners, x, z, main_shapes, gen)
    phase_profile(label, [
        ("rfftn 16384^2 hopper",
         lambda: repro_torch.rfftn(x, planner=planner)),
        ("fftn 512^3 hopper", lambda: repro_torch.fftn(z, planner=planner))])
    del x, z
    torch.cuda.empty_cache()

    # phase 5: the FFT-convolution paths at real size, then 6: their times
    with torch.no_grad():
        mixer_launches, mixer, xm = phase_mixer(planner, gen)
        fused_launches = phase_fused_path(gen, mixer, conv_factors)
        times.update(phase_conv_times(label, planners, mixer, xm,
                                      conv_factors, gen))
        phase_profile(label, [(f"FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
                               f"{tuple(xm.shape)} hopper",
                               lambda: mixer(xm))])
    del mixer, xm
    torch.cuda.empty_cache()

    # phase 7: the paper's shared-memory variants at real size, then 8:
    # their times
    t0 = time.perf_counter()
    phase_variants(planner, gen)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    phase_variant_times(label, planner, gen)
    torch.cuda.empty_cache()
    print(f"variant phases: 7 took {t7 - t0:.1f} s, 8 took "
          f"{time.perf_counter() - t7:.1f} s")

    # phase 9: the distributed layer at world size 1 on NCCL, then 10: its
    # times beside the local plans
    import torch.distributed as dist
    t0 = time.perf_counter()
    m1, m11, store = start_nccl()
    try:
        phase_distributed(planner, gen, m1, m11)
        t9 = time.perf_counter()
        phase_distributed_times(label, planner, gen, m1, m11)
        plan_verdicts(planner, m1, m11)
        t10 = time.perf_counter()
        # phases 12-14: the sharded mixer, the shims and the compressed
        # all-reduce, still at world size 1 on NCCL
        phase_sharded_mixer(label, planner, gen, m1)
        t12 = time.perf_counter()
        phase_shims(label, planner, gen, m1, m11)
        t13 = time.perf_counter()
        phase_psum(label, gen, m1)
    finally:
        dist.destroy_process_group()
        del store
    t14 = time.perf_counter()

    # phase 11: four ranks on the one card over gloo (with phases 12-14)
    phase_gloo_ranks()
    print(f"dist phases: 9 took {t9 - t0:.1f} s, 10 took {t10 - t9:.1f} s, "
          f"12 took {t12 - t10:.1f} s, 13 took {t13 - t12:.1f} s, 14 took "
          f"{t14 - t13:.1f} s, 11 took {time.perf_counter() - t14:.1f} s")

    # phase 15: the LM serving path at olmo-1b's width
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    olmo = get_config("olmo-1b")
    kept = {"FFT-conv LM": phase_fftconv_lm(label, olmo, {
        "hopper": planner, "torch": planners["torch"],
        "torch_native": Planner(backends=("torch_native",))})}
    lm_launches = kept["FFT-conv LM"]["launches"]
    kept["olmo-1b"] = phase_olmo(label, olmo)
    print(f"LM phase: 15 took {time.perf_counter() - t0:.1f} s")

    # phase 16: the other layer kinds at full width
    t0 = time.perf_counter()
    kind_launches, kind_kept = {}, {}
    for name, depth in KIND_MODELS:
        counts, kind_kept[name] = phase_kind(label, name, depth)
        for kernel, n in counts.items():
            kind_launches[kernel] = kind_launches.get(kernel, 0) + n
    print(f"LM phase: 16 took {time.perf_counter() - t0:.1f} s")

    # phase 17: training at olmo-1b's width
    t0 = time.perf_counter()
    fftconv_lm = dataclasses.replace(
        olmo, segments=(("fftconv_mlp", olmo.num_layers),))
    phase_conv_grad(label, planner, gen)
    phase_train_step32(label, fftconv_lm, planner)
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    fftconv_step = {k: v * olmo.num_layers
                    for k, v in TRAIN_LAYER_LAUNCHES.items()}
    olmo_step = dict.fromkeys(TRAIN_LAYER_LAUNCHES, 0)
    try:
        single = {"FFT-conv LM": phase_training(
            label, "FFT-conv LM", fftconv_lm, planner, TRAIN_B, TRAIN_S,
            fftconv_step, ckpt_root)}
        single["olmo-1b"] = phase_training(
            label, "olmo-1b", olmo, None, OLMO_TRAIN_B, OLMO_TRAIN_S,
            olmo_step, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    train_launches = {k: sum(r["launches"][k] for r in single.values())
                      for k in fftconv_step}
    print(f"LM phase: 17 took {time.perf_counter() - t0:.1f} s")

    # phase 18: training on a (data, model) mesh at world size 1 on NCCL
    # ((c), over four gloo ranks, ran with phase 11)
    from repro_torch import make_mesh
    t0 = time.perf_counter()
    m1, _, store = start_nccl()
    try:
        m_dm = make_mesh((1, 1), ("data", "model"))
        mesh_launches = phase_mesh_training(
            label, "FFT-conv LM", fftconv_lm, planner, TRAIN_B, TRAIN_S,
            fftconv_step, m_dm, single["FFT-conv LM"])
        for kernel, n in phase_mesh_training(
                label, "olmo-1b", olmo, None, OLMO_TRAIN_B, OLMO_TRAIN_S,
                olmo_step, m_dm, single["olmo-1b"]).items():
            mesh_launches[kernel] += n
        sharded_grad_launches = phase_sharded_mixer_grad(label, planner,
                                                         gen, m1)
    finally:
        dist.destroy_process_group()
        del store
        for res in single.values():
            del res["params"]
    print(f"LM phase: 18 took {time.perf_counter() - t0:.1f} s")

    # phase 19: serving on a (data, model) mesh at world size 1 on NCCL
    # ((b), over four gloo ranks, ran with phase 11)
    t0 = time.perf_counter()
    m1, _, store = start_nccl()
    try:
        m_dm = make_mesh((1, 1), ("data", "model"))
        serve_mesh_launches = phase_mesh_serving(
            label, "FFT-conv LM", fftconv_lm, planner, kept["FFT-conv LM"],
            LM_PROMPT + SERVE_NEW, m_dm,
            {k: v * olmo.num_layers for k, v in LM_LAYER_LAUNCHES.items()})
        for kernel, n in phase_mesh_serving(
                label, "olmo-1b", olmo, None, kept["olmo-1b"],
                OLMO_PROMPT + SERVE_NEW, m_dm,
                dict.fromkeys(LM_LAYER_LAUNCHES, 0)).items():
            serve_mesh_launches[kernel] += n
    finally:
        dist.destroy_process_group()
        del store, kept
    print(f"LM phase: 19 took {time.perf_counter() - t0:.1f} s")

    # phase 20: the recurrent kinds served on a (data, model) mesh at world
    # size 1 on NCCL ((b), over four gloo ranks, ran with phase 11)
    t0 = time.perf_counter()
    m1, _, store = start_nccl()
    kinds_mesh_launches = dict.fromkeys(LM_LAYER_LAUNCHES, 0)
    try:
        m_dm = make_mesh((1, 1), ("data", "model"))
        for name in KIND_MESH_MODELS:
            for kernel, n in phase_mesh_kinds(label, name, kind_kept[name],
                                              m_dm).items():
                kinds_mesh_launches[kernel] += n
    finally:
        dist.destroy_process_group()
        del store, kind_kept
    print(f"LM phase: 20 took {time.perf_counter() - t0:.1f} s")

    # phase 21: the GPipe pipeline over pod at world size 1 on NCCL ((b),
    # over four gloo ranks, ran with phase 11)
    t0 = time.perf_counter()
    m1, _, store = start_nccl()
    try:
        pipeline_launches = phase_pipeline(
            label, olmo, single["olmo-1b"]["step_ms"],
            make_mesh((1, 1, 1), ("pod", "data", "model")))
    finally:
        dist.destroy_process_group()
        del store
    print(f"LM phase: 21 took {time.perf_counter() - t0:.1f} s")

    # each kernel's launches in the counted run of every path: the N-D FFT
    # (phase 3), the mixer (5), the fused kernel's entry (5), LM serving
    # (15), the other layer kinds served (16: none, checked there),
    # training (17: the steps of both runs), training on the (1, 1) mesh
    # (18 (a): the steps of both runs), the sharded mixer's forward and
    # backward (18 (b)), LM serving on the (1, 1) mesh (19 (a)), the
    # recurrent kinds served on it (20 (a): none, checked there), the
    # pipelined training steps (21 (a): none, checked there)
    paths = {"nd_fft": launches, "mixer": mixer_launches,
             "fftconv_fused": fused_launches, "lm_serve": lm_launches,
             "lm_kinds_serve": kind_launches, "lm_train": train_launches,
             "lm_train_mesh": mesh_launches,
             "sharded_conv_grad": sharded_grad_launches,
             "lm_serve_mesh": serve_mesh_launches,
             "lm_kinds_serve_mesh": kinds_mesh_launches,
             "lm_train_pipeline": pipeline_launches}

    def counts(name):
        by_path = {path: c[name] for path, c in paths.items()}
        check(sum(by_path.values()) > 0, f"no path launched {name}")
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    head = times["rfftn column pass"]
    table = {"kernels": [
        dict(name="four_step_fft", route="cuda",
             source="src/repro_torch/kernels/dft_matmul/dft_matmul.cu",
             replaces="src/repro/kernels/dft_matmul/dft_matmul.py:76",
             **counts("four_step_fft"),
             max_abs_err=max(errs["four_step_fft"].values()),
             **head),
        dict(name="batched_transpose", route="cuda",
             source="src/repro_torch/kernels/transpose/transpose.cu",
             replaces="src/repro/kernels/transpose/transpose.py:27",
             **counts("batched_transpose"),
             max_abs_err=max(errs["batched_transpose"].values()),
             **times["transpose"]),
        dict(name="complex_multiply", route="cuda",
             source="src/repro_torch/kernels/twiddle/twiddle.cu",
             replaces="src/repro/kernels/twiddle/twiddle.py:23",
             **counts("complex_multiply"),
             max_abs_err=errs["complex_multiply"],
             **times["complex_multiply"]),
        dict(name="fftconv_fused", route="cuda",
             source="src/repro_torch/kernels/fftconv/fftconv.cu",
             replaces="src/repro/kernels/fftconv/fftconv.py:80",
             **counts("fftconv_fused"),
             max_abs_err=errs["fftconv_fused"],
             **times["fftconv_fused"]),
    ]}
    for k in table["kernels"]:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")),
              f"non-finite time for {k['name']}")
    print(json.dumps(table))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
