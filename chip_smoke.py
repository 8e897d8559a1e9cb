#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py             # on a machine with an H100
    python3 chip_smoke.py --rehearse  # tiny sizes, CPU, plain versions

Phases (any failed check exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), CUDA version;
  2. build: compile every kernel from csrc/ with nvcc, all at once, print
     what ptxas reports (registers, shared memory, spills) and how many of
     K2's thread-block clusters the card holds at once at L = 1024, 2048
     and MAX_LEAF (clusters of 2, 4 and 8 blocks);
  3. kernels against their plain PyTorch versions and torch.fft on the card
     (K1 at n = 256, 512, 1024, 2048, MAX_LEAF with and without the
     epilogue; K2 at L = 256, 1024, 2048, MAX_LEAF, row- and column-major,
     with the epilogue, and its clusters (`cluster_kernel_cases`) at L =
     1024, 2048 and MAX_LEAF in both stores with the global twiddle, in
     slabs of 1, 2, 4, 8 and 1024 columns at non-zero offsets, each K2
     call's launch key its own, the cluster read from it;
     K3 at n = 8, 512, 1024, 4096, 8192 with and without
     the untangle; K4 at every power of two from 2 to MAX_LEAF, every
     split of its groups of stages; K1 and K2 at the shapes phase 6's
     runs give them, K1-K3 at every shape phase 9's runs give them; one
     error formula; K1-K4 equal to
     their plain versions bit for bit), batch invariance (a row alone ==
     the row inside a large batch: K1 at n = 256, 1024, 2048, 4096, K3 at
     512, 1024, 2048, 4096, K4 at 256, 1024, 2048, 4096),
     zero_copy == copy bitwise at 2^16, 2^17, 2^20, 2^22 and 2^24 (K2's
     column passes, in clusters from L = 1024 on and both at L = 4096 at
     2^24, against K1's row passes over transposes), and each variant's
     main-path case, and K1 at its other three-pass lengths (512, 2048,
     MAX_LEAF), timed beside its bound, its plain version and torch.fft
     (a yardstick only); the phase's seconds;
  4. main path: the map-only FFT job (`repro_torch.launch.fft_job`) driven
     pipelined through its CLI entry point, once per K1/K2 variant, once
     past MAX_LEAF**2 (three levels) and twice with --impl stockham (K4
     leaves, and the copy path at 2^20), each with the launch counts
     zeroed just before and read just after: every output block within
     5e-6 of torch.fft.fft of its input block, the kernel launched, the
     plain versions never called;
  5. serial against pipelined: the merged outputs equal bitwise;
  6. out-of-core: `fft_job --out-of-core` through its CLI entry point at
     2^28 points (a 2 GiB operand under a 256 MiB working set; both passes
     through K2), its merged spectrum within 5e-6 of torch.fft.fft of the
     corner-turned input on the card, the measured storage traffic equal
     to the model's, working set <= budget < operand; then 2^22 points
     (K1 at 2048) bitwise equal to the in-memory oracle, and again after
     a scheduled shuffle failure and a resume that redoes only the lost
     pass-1 jobs; then the paper's 2^37 points (1 TiB under 1 GiB)
     factored analytically. Each streamed run has its launch counts
     zeroed just before and read just after: the kernel launched, the
     plain versions never called;
  7. the spectrogram job of examples/spectral_analysis.py through the
     port: a 1 GiB real capture in 64 MiB blocks, a map-only job whose map
     task is `repro_torch.core.spectral.power_spectrogram` on the card, at
     frame 1024 (K3 at m = 512, three passes) and frame 512 (K3 at m =
     256, two passes): every block's
     stft within 5e-6 of torch.fft.rfft of the same windowed frames, the
     three tones found within one bin, the chirp found, K3 launched and
     no plain version run;
  8. `fft_conv` on the card (n = 8192 through K3 and K1; n = 2^21 through
     K2) within 1e-4 of a float64 torch.fft convolution;
  9. N-D: `fft2`/`ifft2` over 8 images of 4096 x 4096 (K1b, K2b at L =
     4096; zero_copy == copy bitwise), `fftn` over a 512^3 volume (K1b,
     K2b twice), `rfft2`/`irfft2` over 8 real images of 4096 x 4096 (K3b
     packed, K2b, K1b) and `fft_conv2d` of a 24-megapixel frame with a
     65 x 65 filter, landscape (4000 x 6000, padded to 4096 x 8192: K3b
     packed at m = 4096) and portrait (6000 x 4000, padded to 8192 x
     4096: the leading axis as two K2a passes between transposes), each
     against torch.fft, the calls the wrappers record (wrapper, shape,
     major) held to those worked out from the shapes; rfft2's N-D
     untangle and re-entangle timed alone;
 10-12. the mesh placements, the pencils and the service on a one-rank
     group (`dist_checks`, `pencil_checks`, `serve_checks`);
 13. the measuring autotuner on the same group (`tuner_checks`):
     `plan(tune=True)` for the block job's spec, the service's paper mix,
     fft2 and the distributed four-step (each tuned plan bitwise equal to
     the default plan, the two timed), `tune_out_of_core`, `fft_job
     --tune` twice (the second run a wisdom hit) and the facade selftest;
 14. benchmarks/bench_pipeline.py's gate (`pipeline_gate`): serial,
     pipelined and the threaded map-only job over a `ThrottledStore` of
     128 MiB (250 MB/s disk model), best of 3, under impl "ref" and
     "matfft": pipelined faster than serial, ``overlap_x`` > 1, the merged
     outputs bitwise equal, "matfft"'s within 5e-6 of "ref"'s, and every
     K1 call held to its plain version in phase 3;
 15. the service over 4 ranks on the one card (`mesh_serve_checks`): this
     process is rank 0 of a gloo group, three `--follower` subprocesses
     the others; phase 12's paper mix under verify "off" (segmented
     launches, each rank its shard) and "abft" (local launches on rank
     0), every request bitwise equal to the one-rank output at its launch
     size, every follower launching the kernels; rank 0's seconds in
     each step of its segmented launches and the clients' submit time
     printed beside ``qps_completed``;
 16. `python -m repro_torch.launch.fft_dryrun` as a subprocess (the
     256-rank mesh; no card, no process group), and its 512-rank records;
 17. LM serving (`lm_checks`): `repro_torch.launch.serve.main` and
     `ServeEngine` at full width in bf16, from seeded random parameters,
     for qwen2-0.5b (batch 8, prompt 512, 64 new tokens), gemma3-1b
     (batch 4, prompt 1024 past its window of 512, 32 new),
     mixtral-8x22b and llama4-scout (2 of their layers, batch 4, prompt
     2048: one MoE group a sequence, 16 new), rwkv6-3b (16 of its 32
     layers, batch 8, prompt 512, 32 new), zamba2-7b (27 of its 81
     layers: 4 periods and the tail, batch 4, prompt 1024, 16 new),
     whisper-base (batch 8, 1500 frames, prompt 64, 64 new) and
     internvl2-2b (batch 4, 256 patches + prompt 512, 32 new): (a) the
     tokens' shape and range; (b) in float32 and float64 twins over the
     same parameters, every decode step's logits within 1e-4 of the
     teacher-forced forward's and the greedy tokens its argmax (for a MoE
     model at the steps where neither the forward nor the prefill
     dropped a token over capacity; the drops are counted); (c) the
     card's prefill within 1e-4 of the port's own run on the host, for
     qwen2 and for one model of each new block kind (rwkv6 at 2 layers,
     zamba2's first period, mixtral at 1 layer, whisper at one encoder
     and one decoder layer), the host model built from those layers
     only; (d) the bf16 first-token logits against the float32 twin
     within a stated bound. At the reference's init every model but
     gemma3 is chaotic at full depth (attention scores in the hundreds),
     so (b) and (c) are held at a cut where a cache or carry fault would
     still show (the first layer; rwkv6's two; zamba2's first period)
     and in the twin the card measured within bounds; every depth is
     printed. Prefill and decode times, tokens/s, peak memory and the
     weight-read bound of a decode step in one `lm serve` line a model;
     no FFT kernel runs;
 18. LM training (`lm_train_checks`): (a) `repro_torch.launch.train.main`
     on qwen2-0.5b at its published widths and depth (494 M parameters,
     bf16 over float32 parameters, remat "full", loss chunk 512), 8 x 512
     tokens a step of the seeded Zipf corpus, AdamW at 3e-4 for 30 steps
     with a checkpoint at 30: every logged loss and grad norm finite, the
     last logged loss below the first, the state on the card, the saved
     checkpoint and the state a new trainer restores from it equal bit
     for bit to the trained state's files, then a relaunch to 40 steps
     that must resume from 30; the steady step time, tokens/s, peak
     memory, checkpoint bytes and seconds and the model FLOP/s (6 x
     parameters x tokens) against the bf16 peak in one `lm train` line;
     (b) the loss and every gradient leaf on the card against the same
     step on the host, gemma3-1b at full width and depth in float32 and
     qwen2-0.5b's first layer in float64, within a bound measured on the
     H100; (c) one SGD `make_train_step` step of each of the ten reduced
     configs on the card and on the host (the MoE pair in float64, the
     chaotic inits conditioned, as the CPU tests hold them): the loss and
     the updated parameters within 1e-5; (d) mixtral-8x22b at 1 of its
     56 layers with adafactor, 4 x 2048 tokens, 3 steps: every logged
     step and the state finite, the dropped choices counted; no FFT
     kernel runs;
 19. LM training on a mesh (`mesh_train_checks`): (a) phase 18 (a)'s
     model, init, batches and trainer config through `Trainer(mesh=)` on
     a world-size-1 NCCL (1, 1) mesh, through the tensor-parallel code
     over a "model" dim of one, its first steps against the one-device
     trainer's: the losses, grad norms and every state leaf bit for bit,
     each trainer's checkpoint restored into the other kind bit for bit;
     the step ms, tokens/s, peak memory and the gather and
     reduce-scatter ms of the whole parameter tree, and each kind's
     memory at every stage of two fresh steps and a save
     (`step_memory`), the model's axis and its split leaves, in one `lm
     mesh train` line; (b) `moe_ep` at mixtral-8x22b's full width on one
     layer's input over the world-size-1 group, float64 twins, card
     against host within `MESH_MOE_TOL`; (d)-(e) `chip_smoke.py
     --mesh-rank` subprocesses, started beside (b), stepping after this
     process ran each config's steps on one device: one gloo group of two
     ranks on the one card, a (1, 2) ("data", "model") mesh, each config
     of `MESH_FAMILIES` in turn split over "model" (every collective an
     all_reduce over gloo on CUDA tensors), 3 steps with no checkpoint:
     (d) (a)'s model, init and batches at full width and depth, against
     (a)'s record; (e) rwkv6-3b at 4 of its 32 layers and zamba2-7b at
     one period (MMMMMS, 6 of 81), each in bf16 and in float32, and
     whisper-base whole (6 + 6), each at its published widths, conditioned
     (`models.conditioning`), split over "model" (the time and channel
     mix, the mamba blocks and the shared attention block, the encoder
     and the cross attention, the vocabulary), 3 AdamW steps of 8 x 512
     seeded tokens (and whisper's 8 x 1500 frames), against the same
     steps on one device (and, for the float32 configs, those steps
     again with the batch as two microbatches: the model's own spread);
     each step's loss and grad norm within the config's
     `MESH_FAMILY_BOUND` (past its held steps, or within
     `MESH_SPREAD_FACTOR` times the model's own spread), the same on both
     ranks, each rank's peak memory below one device's; one `lm mesh
     tp` line a config with
     each rank's peak memory and step ms beside one device's; (f) after
     (e), the same ranks serve each config of `MESH_SERVE` split over
     "model" (`TransformerLM.prefill`, `decode_step`, the caches at each
     rank's heads): qwen2-0.5b (24 layers), gemma3-1b (26, a rotated
     ring past its window of 512), mixtral-8x22b (1 of 56), whisper-base
     (6 + 6, the cross caches), rwkv6-3b (4 of 32), zamba2-7b (one
     period), at published widths, conditioned, in bf16 and in float32,
     against the same model served whole on one device by this process
     before the ranks start: the prefill's last-position logits, each
     decode step's logits teacher-forced with one device's greedy tokens
     (a rank's vocabulary block; for mixtral the (sequence, step)s whose
     routing is a near tie or dropped are left out and counted,
     `MESH_SERVE_MOE_MARGIN`) and each rank's cache block after the last
     step (`cache_split`), all within the config's `MESH_SERVE_BOUND`;
     both ranks take the same tokens (`vocab_argmax`), and in bf16 the
     same `ServeEngine.generate` tokens, whose agreement with one
     device's greedy tokens is printed, not held; one `lm mesh serve`
     line a config with the prefill ms, a decode step's ms (the first
     pass), in bf16 `ServeEngine.generate`'s ms (the second), the cache
     bytes and the peak memory above the process's before the model a
     rank beside one device's, and the heads, kv heads, d_ff and
     vocabulary a rank; no FFT kernel runs;
 20. the LM dryrun (`lm_dryrun_checks`): (a) ``python -m
     repro_torch.launch.sweep --archs qwen2-0.5b`` over both production
     meshes and every shape, and over the one_card cells, one sweep a
     (mesh, shape), all started together: every record ok, long_500k
     skipped with the reference's reason, finite positive FLOPs and bytes,
     every cell computed split over "model" (``model_axis`` "tensor",
     its all_reduce bytes over "model" counted off one card), each cell's
     wall time; (b) qwen2-0.5b decode_32k on one card, whole
     (128 sequences, a 32768-position cache), built on the card by
     `dryrun.card_check`: the tensors' bytes equal the record's, the
     allocator's growth within its rounding, FlopCounterMode around the
     card's step equal to the record's FLOPs, the step's ms (CUDA events)
     beside the record's memory_s and compute_s and its peak memory
     beside the analytic bytes; (c) train_4k's state from
     `Trainer.init_state` on the card: its bytes equal the record's; one
     `lm dryrun` line; the rehearsal runs (a) alone; no FFT kernel runs;
 21. the `kernels` JSON line: phase 3's numbers and the main-path
     launches (phases 4, 6, 7, 9-15, the followers' included), none 0 for
     a K2 entry; each K2 entry gives the blocks of the thread-block
     cluster its timed launches ran (``cluster``, read from their launch
     key; 1 for one block alone).

The last line is {"ok": true, "device": {...}}. Without a CUDA card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 5e-6  # max|got - want| / max|want|, the selftest's bar
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_S = 67e12    # H100 SXM f32 outside the tensor cores
# H100 SXM dense bf16 on the tensor cores (NVIDIA's data sheet, 700 W)
H100_BF16_FLOPS_S = 989.4e12

TOL_CONV = 1e-4  # fft_conv against float64 (tests/test_spectral.py's bar)
TOL_ROUND = 1e-5  # inverse(forward(x)) against x (tests/test_fft2_plan.py)
# LM serving: decode steps against the teacher-forced forward, and the
# card's prefill against the host's, max|d| / max|ref| (the bar
# tests/test_torch_lm_serve.py holds the logits to); the twins' dtypes
LM_TOL = 1e-4
LM_TWINS = ("float32", "float64")
# the served bf16 first-token logits against the float32 twin at full
# depth, measured on the H100 at 1.248 (qwen2), 0.0203 (gemma3) and
# 0.60-1.27 for the other six (PERF.md §6). Only gemma3 has qk-norm:
# the others' are rounding noise at the reference's init (bf16 moves
# scores in the hundreds by units), so their bound says only that both
# are finite and of one scale
LM_SERVED_BOUND = {"qwen2-0.5b": 1.5, "gemma3-1b": 0.05,
                   "mixtral-8x22b": 1.5, "llama4-scout-17b-a16e": 1.5,
                   "rwkv6-3b": 1.5, "zamba2-7b": 1.5, "whisper-base": 1.5,
                   "internvl2-2b": 1.5}
# the twins each model's (b) is held in at its gated depth, and its (c),
# from the H100 (PERF.md §6): where the float32 twin came
# within 2x of LM_TOL (mixtral 1.4e-4, llama4 8.9e-5, zamba2's period
# 2.1e-4 and its card prefill 1.2e-4, whisper 1.1e-4 and internvl2
# 8.9e-5 at 1 layer) the float64 twin is held and the float32 printed
F64 = ("float64",)
LM_GATE_TWINS = {"mixtral-8x22b": F64, "llama4-scout-17b-a16e": F64,
                 "rwkv6-3b": LM_TWINS, "zamba2-7b": F64,
                 "whisper-base": F64, "internvl2-2b": F64}
LM_CPU_GATE_TWINS = {"rwkv6-3b": LM_TWINS, "zamba2-7b": F64,
                     "mixtral-8x22b": LM_TWINS, "whisper-base": LM_TWINS}

# LM training: a reduced config's SGD step on the card against the host's
# (loss and updated parameters, max|d| / max|ref|)
LM_TOL_TRAIN = 1e-5
# moe_ep on the card against the host, float64 twins (phase 19 (b)):
# max|d| / max|host|; the router is float32 in both (the reference's)
MESH_MOE_TOL = 1e-5
# phase 19 (d), the (1, 2) tensor-parallel step against (a)'s one-device
# steps in bf16: |d - a| / |a| of each step's loss and grad norm; set
# before the first card run at 20x the largest of the rehearsal's same
# two-rank step on the CPU in bf16 (9.7e-5 and 8.5e-4), rounded up to one
# digit (PERF.md §6)
MESH_TP_BOUND = {"loss": 2e-3, "grad_norm": 2e-2}
# phase 19 (e): rwkv6 (R), zamba2 (M and its shared S block) and whisper
# (its encoder and cross attention) split over the (1, 2) mesh's "model"
# dim against the same config's one-device steps, the layers each keeps;
# |d - a| / |a| of each step's loss and grad norm. In bf16 (the configs'
# dtype) set before the first card run at 20x the largest of the
# rehearsal's same two-rank steps on the CPU (loss 3.49e-4, 1.58e-4,
# 4.90e-5; grad norm 9.15e-2, 4.38e-2, 1.29e-4), rounded up to one digit
# (PERF.md §6). The rwkv6 and zamba2 bf16 grad norms are rounding-bound,
# in the reference's bf16 step as in the port's (test_torch_train_mixed's
# test_rwkv6_bf16_gradients_follow_the_reference_bf16), and their bounds
# cannot see a gradient summed over the ranks: rwkv6's gate computed
# inside the split region moves the bf16 rehearsal's grad norm by
# 0.76-1.80, zamba2's norm summed forward only by 1.8e-2-9.4e-2. So both
# run in float32 as well, bound at the larger of 1e-5 and 20x the float32
# rehearsal (loss 7.2e-8 and 7.2e-8, grad norm 3.89e-6 and 8.24e-7),
# rounded up to one digit, where those traps move the step-1 grad norm
# by 0.90 and 5.6e-2. held_steps: the steps held at the bound alone; past
# them each metric is within MESH_SPREAD_FACTOR times the model's own
# spread where that is larger ("control": the same steps on one device
# with the batch as two microbatches). At full width rwkv6's float32
# gradient after the first step is chaotic: its one-device steps in that
# other order move its grad norm by 1.1e-2 and 0.46 at steps 2 and 3
# (PERF.md §6)
# (d), "like" "full", is (a)'s model, init, trainer config and first
# batches, held against (a)'s record at MESH_TP_BOUND
MESH_FAMILIES = ({"arch": "qwen2-0.5b", "like": "full"},
                 {"arch": "rwkv6-3b", "layers": 4},
                 {"arch": "rwkv6-3b", "layers": 4, "dtype": "float32",
                  "control": True},
                 {"arch": "zamba2-7b", "layers": 6},
                 {"arch": "zamba2-7b", "layers": 6, "dtype": "float32",
                  "control": True},
                 {"arch": "whisper-base"})
MESH_FAMILY_BOUND = {"qwen2-0.5b": MESH_TP_BOUND,
                     "rwkv6-3b": {"loss": 7e-3, "grad_norm": 2.0},
                     "rwkv6-3b/float32": {"loss": 1e-5, "grad_norm": 8e-5,
                                          "held_steps": 1},
                     "zamba2-7b/float32": {"loss": 1e-5, "grad_norm": 2e-5,
                                           "held_steps": 1},
                     "zamba2-7b": {"loss": 4e-3, "grad_norm": 0.9},
                     "whisper-base": {"loss": 1e-3, "grad_norm": 3e-3}}
MESH_SPREAD_FACTOR = 10
# phase 19 (f): serving split over the (1, 2) mesh's "model" dim, each
# config at its published widths, against the same model served whole on
# one device: batch, prompt and new tokens (whisper's frames), the layers
# each keeps (qwen2-0.5b, gemma3-1b and whisper-base all of theirs; the
# rehearsal keeps as many at the reduced widths)
MESH_SERVE = ({"arch": "qwen2-0.5b", "layers": 24, "batch": 8,
               "prompt": 512, "new": 32},
              {"arch": "gemma3-1b", "layers": 26, "batch": 4, "prompt": 1024,
               "new": 16},
              # its second run float64, as the MoE configs are held
              # elsewhere (`models.conditioning.FLOAT64`): its dispatch
              # rounds each expert's input to bf16 in a float32 model too,
              # and a 1e-7 change flips such a rounding (PERF.md §6)
              {"arch": "mixtral-8x22b", "layers": 1, "batch": 4,
               "prompt": 2048, "new": 16,
               "dtypes": ("bfloat16", "float64")},
              {"arch": "whisper-base", "layers": 6, "encoder_layers": 6,
               "batch": 8, "prompt": 64, "frames": 1500, "new": 32},
              {"arch": "rwkv6-3b", "layers": 4, "batch": 8, "prompt": 512,
               "new": 32},
              {"arch": "zamba2-7b", "layers": 6, "batch": 4, "prompt": 1024,
               "new": 16})
# max|d| / max|one device| of the prefill's last-position logits, each
# teacher-forced decode step's logits (a rank's vocabulary block) and each
# rank's cache block after the last step, a config (bf16) and
# "<config>/<its second dtype>"; set before the first card run at 20x the
# largest of
# the rehearsal's same two-rank check (reduced widths at the card run's
# depths; bf16 0.0130, 0.0391, 0.00581, 0.0112, 0.125, 0.0436; float32
# 6.69e-7, 1.76e-6, (mixtral float64 0), 6.18e-7, 6.45e-6, 4.25e-6 in
# MESH_SERVE's order; PERF.md §6), rounded up to one digit, at least 1e-5
# past bf16. mixtral-8x22b's float32 run missed its 1e-5 on the H100
# (1.77e-5: its bf16 dispatch's flips) and runs in float64 since.
# rwkv6-3b's bf16 bound sees no fault: its one-device bf16 logits are
# themselves 0.05-0.26 from float32 (the reduced config, 4 layers); its
# float32 bound does
MESH_SERVE_BOUND = {"qwen2-0.5b": 0.3, "qwen2-0.5b/float32": 2e-5,
                    "gemma3-1b": 0.8, "gemma3-1b/float32": 4e-5,
                    "mixtral-8x22b": 0.2, "mixtral-8x22b/float64": 1e-5,
                    "whisper-base": 0.3, "whisper-base/float32": 2e-5,
                    "rwkv6-3b": 3.0, "rwkv6-3b/float32": 2e-4,
                    "zamba2-7b": 0.9, "zamba2-7b/float32": 9e-5}
# (f)'s MoE positions held: a (sequence, step) whose token's router margin
# (the k-th minus the (k+1)-th probability, `moe_record`) at some layer is
# below this in either run, or whose choice was dropped over capacity, is
# left out of the logits' check (and counted): the split's rounding of an
# expert's input (2^-8 relative in bf16) may flip such a choice, which
# moves that token's logits by O(1) with nothing wrong
MESH_SERVE_MOE_MARGIN = {"bfloat16": 2e-2, "float32": 1e-4, "float64": 1e-4}
# the card's loss and gradients against the host's (phase 18 (b)), max|d|
# / max|host| a leaf: measured on the H100 at 6.2e-6 (gemma3-1b, float32,
# 26 layers) and 2.58e-5 (qwen2-0.5b's first layer, float64) in the
# phase's first run (PERF.md §6); held at the card-vs-host bar of phase 17,
# 16x and 4x above them: a fault in a backward pass moves a leaf by
# O(1)
LM_TRAIN_GRAD_BOUND = {"gemma3-1b": LM_TOL, "qwen2-0.5b": LM_TOL}
# every gradient leaf of a reduced config's step on the card against the
# host's (phase 18 (c)), max|d| / max|host| a leaf: the larger of 1e-5
# and 4x the worst leaf of two passes on the H100 (equal in both; PERF.md
# §6), rounded up to one digit. The largest readings are rounding, not
# faults: h2o-danube's 2.4e-4 (ln1.scale) at the reference's chaotic init
# (scores ~50), llama4's 6.6e-4 (moe.wi) the bf16 dispatch's flips under
# its float32 norms and router; a fault in a backward pass moves a leaf
# by O(1)
LM_TRAIN_FAMILY_GRAD_BOUND = {
    "qwen3-0.6b": 1e-5, "h2o-danube-1.8b": 1e-3, "qwen2-0.5b": 1e-5,
    "gemma3-1b": 2e-5, "rwkv6-3b": 4e-4, "llama4-scout-17b-a16e": 3e-3,
    "mixtral-8x22b": 2e-4, "whisper-base": 2e-5, "zamba2-7b": 2e-4,
    "internvl2-2b": 1e-5}

# the Pallas sites each kernel variant replaces, and its CUDA source
REPLACES = {
    "matfft/direct": "src/repro/kernels/fft/matfft.py:234",
    "matfft/four_step": "src/repro/kernels/fft/matfft.py:252",
    "matfft_cols/direct": "src/repro/kernels/fft/matfft.py:419",
    "matfft_cols/four_step": "src/repro/kernels/fft/matfft.py:438",
    "rfft/direct": "src/repro/kernels/fft/matfft.py:559",
    "rfft/four_step": "src/repro/kernels/fft/matfft.py:578",
    "stockham": "src/repro/kernels/fft/stockham.py:80",
}
SOURCE = {name: "src/repro_torch/csrc/matfft.cu" for name in REPLACES}
SOURCE["stockham"] = "src/repro_torch/csrc/stockham.cu"

# examples/spectral_analysis.py's capture
SR = 16_000
TONES_HZ = (440.0, 1_250.0, 3_000.0)

# phase 20: qwen2-0.5b's cells on both production meshes, and the one_card
# cells held to the card: decode_32k whole (128 sequences, a 32768-position
# bf16 cache) and train_4k's state
LM_DRYRUN = {"arch": "qwen2-0.5b", "meshes": ("single_pod", "multi_pod"),
             "shapes": ("train_4k", "prefill_32k", "decode_32k",
                        "long_500k"),
             "card_shapes": ("train_4k", "decode_32k"), "reps": 3,
             "cell_timeout_s": 300, "timeout_s": 420}

# main-path runs: (label, kernel it drives, fft_job arguments). Pipelined,
# with 64 MiB (level 0) to 256 MiB (level 2) blocks. A label that names a
# kernel variant gives that variant its launch count in the `kernels` line.
FULL = {
    "runs": [
        ("matfft/four_step", "matfft",
         ["--fft-len", "1024", "--size-mb", "1024",
                              "--segments-per-block", "8192",
                              "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/four_step", "matfft_cols",
         ["--fft-len", "1048576", "--size-mb", "256",
          "--segments-per-block", "16", "--coalesce", "2", "--inflight", "2"]),
        ("matfft/direct", "matfft",
         ["--fft-len", "256", "--size-mb", "256",
          "--segments-per-block", "32768", "--coalesce", "4",
          "--inflight", "2"]),
        ("matfft_cols/direct", "matfft_cols",
         ["--fft-len", "65536", "--size-mb", "256",
          "--segments-per-block", "128", "--coalesce", "4",
          "--inflight", "2"]),
        # past MAX_LEAF**2: three levels, 256 x (512 x 256)
        ("three_levels", "matfft_cols",
         ["--fft-len", str(1 << 25), "--size-mb", "512",
          "--segments-per-block", "1", "--coalesce", "2", "--inflight", "2"]),
        # K4 leaves: the first run's configuration, then the level-1 copy
        # path (transposes around two K4 passes) at 2^20
        ("stockham", "stockham",
         ["--impl", "stockham", "--fft-len", "1024", "--size-mb", "1024",
          "--segments-per-block", "8192", "--coalesce", "4",
          "--inflight", "2"]),
        ("stockham_copy_path", "stockham",
         ["--impl", "stockham", "--fft-len", "1048576", "--size-mb", "256",
          "--segments-per-block", "16", "--coalesce", "2",
          "--inflight", "2"]),
    ],
    # serial vs pipelined: 4 blocks of the first run's configuration
    "serial": ["--fft-len", "1024", "--size-mb", "256",
               "--segments-per-block", "8192", "--coalesce", "4"],
    "points": 1 << 25,      # complex points per kernel check and timing
    "batch_rows": 32768,    # batch of the invariance check
    "layout_rows": 64,      # rows of the zero_copy == copy check
    "layout_ns": (1 << 16, 1 << 17, 1 << 20, 1 << 22, 1 << 24),
    # K2's cluster cases: (rows, L, cols), and the slabs' operand
    "cluster": {"rows": 2, "cols": 64, "slab_shape": (1, 4096, 4096)},
    "reps": 10,
    # K3 (rows, n): n = 8, the frame-512 and frame-1024 spectrogram blocks
    # (2^24 samples), n = 4096 and fft_conv's n = 8192 at 2^25 samples
    "rfft_shapes": [(1 << 22, 8), (65535, 512), (32767, 1024), (8192, 4096),
                    (4096, 8192)],
    # K4 (rows, n) at 2^25 points, n = 2 to 4096: every split of its
    # groups of stages; (32768, 1024) is the main path's batch
    "stockham_shapes": [((1 << 25) >> p, 1 << p) for p in range(1, 13)],
    # the spectrogram job: 1 GiB of float32 samples at 16 kHz, 64 MiB
    # blocks; (variant, frame, hop) per run
    "capture_samples": 1 << 28,
    "block_samples": 1 << 24,
    "spectrograms": [("rfft/four_step", 1024, 512), ("rfft/direct", 512, 256)],
    # fft_conv: (signals, samples, filter taps)
    "conv": [(64, 4000, 100), (16, 1 << 20, 4097)],
    # out-of-core: log2 of the at-scale run's points, its budget in MiB
    # and the size it falls back to on a short disk; log2 of the bitwise
    # and resume runs' points and their budget as a fraction of the
    # operand. 2^28, not 2^29: at 2^29 the phase took 134 s and the
    # script 320 s on the H100 (PERF.md §4)
    "ooc": {"log2_n": 28, "budget_mb": 256, "short_disk_log2_n": 27,
            "bitwise_log2_n": 22, "bitwise_budget_div": 16},
    # N-D: (batch, shape) of the c2c images and volume and of the real
    # images, the fft_conv2d frames and filter, and each run's timed calls
    "nd": {"fft2": ((8,), (4096, 4096)), "fftn": ((), (512, 512, 512)),
           "rfft2": ((8,), (4096, 4096)),
           "conv2d": [((4000, 6000), (65, 65)), ((6000, 4000), (65, 65))],
           "reps": 3},
    # the mesh placements on a world-size-1 group: the 1-D distributed
    # four-step at n (every overlap x fuse_twiddle x layout) and at
    # n_level2 (n1 past one leaf: pass 1 between transposes, unfused), the
    # segmented c2c (segments, length) and r2c (segments, length); the
    # options' checks at the per-rank shapes of a plan over `ranks`
    "dist": {"n": 1 << 24, "n_level2": 1 << 26, "chunks": 4,
             "seg_c2c": (64, 1 << 20), "seg_r2c": (4096, 1 << 16),
             "ranks": 8, "reps": 3},
    # the pencils on the same group: (kind, shape, mesh dims), each under
    # overlap "off" and `chunks`; an 8192-point leading axis runs
    # axis_pass's transpose fallback
    "pencil": {"cases": [("c2c", (8192, 8192), (1,)),
                         ("c2c", (512, 512, 512), (1, 1)),
                         ("r2c", (8192, 8192), (1,)),
                         ("r2c", (512, 512, 512), (1, 1))],
               "chunks": 4, "reps": 3},
    # the service: benchmarks/bench_serve.py's storm (its seed, rate,
    # clients, coalesce, queue depth, inflight and attempts; the default
    # mix), the paper-scale mix (2, 8 and 4 MiB a request) flooded with
    # `paper_requests`, the device loss under `loss_requests`, and the
    # launcher with `cli_requests`
    "serve": {"seed": 1407, "rate": 0.25, "clients": 3, "coalesce": 4,
              "queue_depth": 40, "max_inflight": 2, "max_attempts": 4,
              "storm_requests": 240,
              "paper_mix": [("c2c", 1024, 256), ("c2c", 65536, 16),
                            ("r2c", 4096, 256)],
              "paper_requests": 600, "loss_requests": 300,
              "cli_requests": 400},
    # the tuner: the block job's (rows, fft_len), and the timing calls of
    # the tuned and default plans; the other specs are the service's paper
    # mix, the N-D phase's fft2 and the distributed phase's n
    "tune": {"block": (32768, 1024), "reps": 3},
    # benchmarks/bench_pipeline.py's gate: its store (MiB, fft_len,
    # segments a block), stream settings and best-of count, under the
    # bench's impl "ref" and under "matfft"
    "pipeline": {"size_mb": 128, "fft_len": 1024, "segments_per_block": 512,
                 "coalesce": 4, "inflight": 3, "iters": 3,
                 "impls": ("ref", "matfft")},
    # the service over `ranks` processes on the one card, at phase 12's
    # paper mix and request count
    "mesh_serve": {"ranks": 4},
    # LM serving at full width: each model's batch, prompt and new tokens
    # (and depth, where all its layers would not fit the card), the cuts
    # of its depth the twins also run at (and the twins that fit at full
    # depth), the depth (b) is held at (None: all its layers) and the
    # twins it is held in, and the bound on its served first-token logits
    # against the float32 twin (d). At the reference's init the attention
    # scores reach hundreds (qwen2-0.5b ~700), so a 1e-7 change of a
    # layer's input (the float32 norms and score tiles) moves the logits
    # by 1e-4 (qwen2, 2 layers) to O(1) (24): (b) holds where a cache or
    # carry fault would still show, its first layer (zamba2: its first
    # period), and every depth is printed (PERF.md §6). A MoE model's
    # twins run ``twin_prompt`` tokens, so that the forward over prompt +
    # new - 1 is one group a sequence
    "lm": {"models": [
        {"arch": "qwen2-0.5b", "batch": 8, "prompt": 512, "new": 64,
         "depths": (2, 1), "gate_layers": 1, "gate_twins": ("float64",),
         "served_bound": LM_SERVED_BOUND["qwen2-0.5b"]},
        {"arch": "gemma3-1b", "batch": 4, "prompt": 1024, "new": 32,
         "depths": (), "gate_layers": None,
         "gate_twins": ("float32", "float64"),
         "served_bound": LM_SERVED_BOUND["gemma3-1b"]},
        {"arch": "mixtral-8x22b", "layers": 2, "batch": 4, "prompt": 2048,
         "new": 16, "twin_prompt": 2033, "depths": (1,),
         "full_twins": ("float32",), "gate_layers": 1,
         "gate_twins": LM_GATE_TWINS["mixtral-8x22b"],
         "served_bound": LM_SERVED_BOUND["mixtral-8x22b"]},
        {"arch": "llama4-scout-17b-a16e", "layers": 2, "batch": 4,
         "prompt": 2048, "new": 16, "twin_prompt": 2033, "depths": (1,),
         "full_twins": ("float32",), "forward_rows": 1, "gate_layers": 1,
         "gate_twins": LM_GATE_TWINS["llama4-scout-17b-a16e"],
         "served_bound": LM_SERVED_BOUND["llama4-scout-17b-a16e"]},
        # rwkv6-3b at 16 of its 32 layers and zamba2-7b at 27 of its 81
        # (4 periods and the 3-layer tail), cut to keep the script inside
        # its limit with phase 19 (e) (PERF.md §4)
        {"arch": "rwkv6-3b", "layers": 16, "batch": 8, "prompt": 512,
         "new": 32, "depths": (2, 1), "gate_layers": 2,
         "gate_twins": LM_GATE_TWINS["rwkv6-3b"],
         "served_bound": LM_SERVED_BOUND["rwkv6-3b"]},
        {"arch": "zamba2-7b", "layers": 27, "batch": 4, "prompt": 1024,
         "new": 16, "depths": (6,), "full_twins": ("float32",),
         "gate_layers": 6,
         "gate_twins": LM_GATE_TWINS["zamba2-7b"],
         "served_bound": LM_SERVED_BOUND["zamba2-7b"]},
        {"arch": "whisper-base", "batch": 8, "prompt": 64, "new": 64,
         "frames": 1500, "depths": (1,), "gate_layers": 1,
         "gate_twins": LM_GATE_TWINS["whisper-base"],
         "served_bound": LM_SERVED_BOUND["whisper-base"]},
        {"arch": "internvl2-2b", "batch": 4, "prompt": 512, "new": 32,
         "depths": (2, 1), "gate_layers": 1,
         "gate_twins": LM_GATE_TWINS["internvl2-2b"],
         "served_bound": LM_SERVED_BOUND["internvl2-2b"]}],
        # (c): the model built on the card at ``layers`` (the encoder and
        # the shared block whole), copied to the host, compared at each of
        # ``depths``
        "cpu_checks": [
            {"arch": "qwen2-0.5b", "layers": 24, "batch": 1, "prompt": 32,
             "depths": (24, 2, 1), "gate_layers": 1,
             "gate_twins": ("float64",)},
            {"arch": "rwkv6-3b", "layers": 2, "batch": 1, "prompt": 32,
             "depths": (2, 1), "gate_layers": 2,
             "gate_twins": LM_CPU_GATE_TWINS["rwkv6-3b"]},
            {"arch": "zamba2-7b", "layers": 6, "batch": 1, "prompt": 32,
             "depths": (6,), "gate_layers": 6,
             "gate_twins": LM_CPU_GATE_TWINS["zamba2-7b"]},
            {"arch": "mixtral-8x22b", "layers": 1, "batch": 1, "prompt": 32,
             "depths": (1,), "gate_layers": 1,
             "gate_twins": LM_CPU_GATE_TWINS["mixtral-8x22b"]},
            # whole (printed: its encoder is chaotic on either side), and
            # at one encoder and one decoder layer (held)
            {"arch": "whisper-base", "layers": 6, "batch": 1, "prompt": 32,
             "depths": (6, 1), "gate_layers": 6, "gate_twins": ()},
            {"arch": "whisper-base", "layers": 1, "encoder_layers": 1,
             "batch": 1, "prompt": 32, "depths": (1,), "gate_layers": 1,
             "gate_twins": LM_CPU_GATE_TWINS["whisper-base"]}],
        "reduced": False, "seed": 0, "reps": 3},
    # phase 18: (a) qwen2-0.5b at its published widths and depth, 4096
    # tokens a step, then a relaunch that resumes; (b) card vs host
    # gradients where the init is not chaotic (gemma3's qk-norm) and at
    # qwen2's first layer in float64; (d) mixtral at 1 of its 56 layers
    # with adafactor (AdamW's moments would not fit beside the gradients
    # at 2 layers), one MoE group a sequence
    "lm_train": {
        "full": {"arch": "qwen2-0.5b", "batch": 8, "seq": 512,
                 "optimizer": "adamw", "lr": 3e-4, "steps": 30,
                 "resume_steps": 40, "reduced": False},
        "grads": [
            {"arch": "gemma3-1b", "twin": "float32", "batch": 1, "seq": 32,
             "bound": LM_TRAIN_GRAD_BOUND["gemma3-1b"], "reduced": False},
            {"arch": "qwen2-0.5b", "layers": 1, "twin": "float64",
             "batch": 1, "seq": 32,
             "bound": LM_TRAIN_GRAD_BOUND["qwen2-0.5b"], "reduced": False}],
        "moe": {"arch": "mixtral-8x22b", "layers": 1, "batch": 4,
                "seq": 2048, "steps": 3, "optimizer": "adafactor",
                "lr": 3e-4, "reduced": False},
        "family_tol": LM_TOL_TRAIN,
        "family_grad_tol": LM_TRAIN_FAMILY_GRAD_BOUND, "seed": 0},
    # phase 19: (a) phase 18 (a)'s model, init, batches and trainer config
    # through Trainer(mesh=) on a world-size-1 (1, 1) mesh, its first
    # steps against the one-device trainer's, bit for bit; (b) moe_ep at
    # mixtral's full width on one layer's input, a float64 twin, card vs
    # host; (d)-(e) two gloo ranks on the one card, a (1, 2) mesh: (a)'s
    # first steps and each family's split over "model"
    "mesh_train": {
        "full": {"arch": "qwen2-0.5b", "batch": 8, "seq": 512,
                 "optimizer": "adamw", "lr": 3e-4, "launch_steps": 30,
                 "steps": 6, "reduced": False},
        "moe": {"arch": "mixtral-8x22b", "tokens": 128, "reduced": False},
        # (d) (a)'s first steps and (e) rwkv6-3b at 4 of its 32 layers and
        # zamba2-7b at one period (MMMMMS, 6 of 81 layers), each in bf16
        # and float32, whisper-base whole (6 + 6 layers), each at its
        # published widths, 8 x 512 tokens a step (and whisper's 8 x 1500
        # frames)
        "tp": {"ranks": 2, "steps": 3, "batch": 8, "seq": 512,
               "frames": 1500, "optimizer": "adamw", "lr": 3e-4,
               "launch_steps": 30, "reduced": False,
               "configs": MESH_FAMILIES, "bound": MESH_FAMILY_BOUND},
        # (f) each config of MESH_SERVE split over "model" by the same
        # ranks, after (d)-(e), in bf16 and float32
        "serve": {"configs": MESH_SERVE, "dtypes": ("bfloat16", "float32"),
                  "reduced": False, "bound": MESH_SERVE_BOUND},
        "moe_tol": MESH_MOE_TOL, "seed": 0},
    "lm_dryrun": LM_DRYRUN,
}
REHEARSE = {
    "runs": [
        ("matfft/four_step", "matfft",
         ["--fft-len", "1024", "--size-mb", "1", "--segments-per-block",
          "32", "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/four_step", "matfft_cols",
         ["--fft-len", "16384", "--size-mb", "1", "--segments-per-block",
          "2", "--coalesce", "2", "--inflight", "2"]),
        ("matfft/direct", "matfft",
         ["--fft-len", "256", "--size-mb", "1", "--segments-per-block",
          "128", "--coalesce", "4", "--inflight", "2"]),
        ("matfft_cols/direct", "matfft_cols",
         ["--fft-len", "65536", "--size-mb", "1", "--segments-per-block",
          "1", "--coalesce", "2", "--inflight", "2"]),
        ("stockham", "stockham",
         ["--impl", "stockham", "--fft-len", "1024", "--size-mb", "1",
          "--segments-per-block", "32", "--coalesce", "4", "--inflight", "2"]),
        ("stockham_copy_path", "stockham",
         ["--impl", "stockham", "--fft-len", "16384", "--size-mb", "1",
          "--segments-per-block", "2", "--coalesce", "2", "--inflight", "2"]),
    ],
    "serial": ["--fft-len", "1024", "--size-mb", "1",
               "--segments-per-block", "32", "--coalesce", "4"],
    "points": 1 << 15,
    "batch_rows": 64,
    "layout_rows": 2,
    "layout_ns": (1 << 16, 1 << 17, 1 << 20, 1 << 22),
    "cluster": {"rows": 1, "cols": 16, "slab_shape": (1, 4096, 2048)},
    "reps": 1,
    "rfft_shapes": [(64, 8), (33, 512), (17, 1024), (5, 4096), (3, 8192)],
    "stockham_shapes": [(max(2, (1 << 13) >> p), 1 << p)
                        for p in range(1, 13)],
    "capture_samples": 1 << 18,
    "block_samples": 1 << 16,
    "spectrograms": [("rfft/four_step", 1024, 512), ("rfft/direct", 512, 256)],
    "conv": [(4, 200, 10), (2, 8192, 4097)],
    # 2^18 points: the smallest operand past the launcher's 1 MiB budget
    "ooc": {"log2_n": 18, "budget_mb": 1, "short_disk_log2_n": 16,
            "bitwise_log2_n": 10, "bitwise_budget_div": 8},
    # the frames pad to (32, 8192) and (8192, 32): K3 at m = 4096 and the
    # long leading axis on the CPU too
    "nd": {"fft2": ((2,), (64, 128)), "fftn": ((), (8, 16, 32)),
           "rfft2": ((2,), (64, 128)),
           "conv2d": [((20, 4200), (5, 65)), ((4200, 20), (65, 5))],
           "reps": 1},
    "dist": {"n": 1 << 12, "n_level2": 1 << 14, "chunks": 4,
             "seg_c2c": (8, 1 << 10), "seg_r2c": (16, 1 << 14), "ranks": 8,
             "reps": 1},
    "pencil": {"cases": [("c2c", (8192, 32), (1,)),
                         ("c2c", (8, 16, 32), (1, 1)),
                         ("r2c", (8192, 32), (1,)),
                         ("r2c", (8, 16, 32), (1, 1))],
               "chunks": 4, "reps": 1},
    "serve": {"seed": 1407, "rate": 0.25, "clients": 3, "coalesce": 4,
              "queue_depth": 40, "max_inflight": 2, "max_attempts": 4,
              "storm_requests": 48,
              "paper_mix": [("c2c", 64, 4), ("c2c", 8192, 2),
                            ("r2c", 256, 4)],
              "paper_requests": 24, "loss_requests": 24,
              "cli_requests": 24},
    "tune": {"block": (64, 1024), "reps": 1},
    # 8 blocks of 1 MiB on a disk modeled at 25 MB/s, so that the disk
    # outweighs the plain versions' compute on the CPU as it outweighs
    # the kernels on the card
    "pipeline": {"size_mb": 8, "fft_len": 1024, "segments_per_block": 128,
                 "coalesce": 4, "inflight": 3, "iters": 2, "disk_mb_s": 25,
                 "impls": ("ref", "matfft")},
    "mesh_serve": {"ranks": 4},
    # the reduced configs (float32); prompt 80 passes gemma3's reduced
    # window of 64; qwen2's checks held at 1 of its 2 layers; a MoE
    # model's prompt of 64 is one group (of 64), its twins' 57 + 8 - 1 too
    "lm": {"models": [
        {"arch": "qwen2-0.5b", "batch": 2, "prompt": 80, "new": 8,
         "depths": (1,), "gate_layers": 1, "gate_twins": LM_TWINS,
         "served_bound": LM_TOL},
        {"arch": "gemma3-1b", "batch": 2, "prompt": 80, "new": 8,
         "depths": (), "gate_layers": None, "gate_twins": LM_TWINS,
         "served_bound": LM_TOL},
        {"arch": "mixtral-8x22b", "batch": 2, "prompt": 64, "new": 8,
         "twin_prompt": 57, "depths": (1,), "full_twins": ("float32",),
         "gate_layers": 1, "gate_twins": LM_TWINS, "served_bound": LM_TOL},
        {"arch": "llama4-scout-17b-a16e", "batch": 2, "prompt": 64,
         "new": 8, "twin_prompt": 57, "depths": (1,),
         "full_twins": ("float32",), "forward_rows": 1, "gate_layers": 1,
         "gate_twins": LM_TWINS, "served_bound": LM_TOL},
        {"arch": "rwkv6-3b", "batch": 2, "prompt": 37, "new": 8,
         "depths": (1,), "gate_layers": 1, "gate_twins": LM_TWINS,
         "served_bound": LM_TOL},
        {"arch": "zamba2-7b", "batch": 2, "prompt": 37, "new": 8,
         "depths": (), "full_twins": ("float32",), "gate_layers": None,
         "gate_twins": ("float32",), "served_bound": LM_TOL},
        {"arch": "whisper-base", "batch": 2, "prompt": 24, "new": 8,
         "frames": 16, "depths": (1,), "gate_layers": 1,
         "gate_twins": LM_TWINS, "served_bound": LM_TOL},
        {"arch": "internvl2-2b", "batch": 2, "prompt": 24, "new": 8,
         "depths": (1,), "gate_layers": 1, "gate_twins": LM_TWINS,
         "served_bound": LM_TOL}],
        "cpu_checks": [
            {"arch": "qwen2-0.5b", "layers": 2, "batch": 1, "prompt": 32,
             "depths": (2, 1), "gate_layers": 1, "gate_twins": LM_TWINS},
            {"arch": "rwkv6-3b", "layers": 2, "batch": 1, "prompt": 32,
             "depths": (2, 1), "gate_layers": 2, "gate_twins": LM_TWINS},
            {"arch": "zamba2-7b", "layers": 6, "batch": 1, "prompt": 32,
             "depths": (6,), "gate_layers": 6, "gate_twins": LM_TWINS},
            {"arch": "mixtral-8x22b", "layers": 1, "batch": 1, "prompt": 32,
             "depths": (1,), "gate_layers": 1, "gate_twins": LM_TWINS},
            {"arch": "whisper-base", "layers": 2, "batch": 1, "prompt": 32,
             "depths": (2, 1), "gate_layers": 2, "gate_twins": LM_TWINS},
            {"arch": "whisper-base", "layers": 1, "encoder_layers": 1,
             "batch": 1, "prompt": 32, "depths": (1,), "gate_layers": 1,
             "gate_twins": LM_TWINS}],
        "reduced": True, "seed": 0, "reps": 1},
    # the reduced configs; 20 steps, so that two steps are logged
    "lm_train": {
        "full": {"arch": "qwen2-0.5b", "batch": 4, "seq": 64,
                 "optimizer": "adamw", "lr": 1e-3, "steps": 20,
                 "resume_steps": 25, "reduced": True},
        "grads": [
            {"arch": "gemma3-1b", "twin": "float32", "batch": 1, "seq": 32,
             "bound": LM_TOL_TRAIN, "reduced": True},
            {"arch": "qwen2-0.5b", "layers": 1, "twin": "float64",
             "batch": 1, "seq": 32, "bound": LM_TOL_TRAIN, "reduced": True}],
        "moe": {"arch": "mixtral-8x22b", "layers": 1, "batch": 2, "seq": 64,
                "steps": 2, "optimizer": "adafactor", "lr": 3e-4,
                "reduced": True},
        "family_tol": LM_TOL_TRAIN,
        "family_grad_tol": dict.fromkeys(LM_TRAIN_FAMILY_GRAD_BOUND,
                                         LM_TOL_TRAIN), "seed": 0},
    # in the model's dtype at full width (bf16): (d)'s bound comes from
    # this rehearsal (PERF.md §6)
    "mesh_train": {
        "full": {"arch": "qwen2-0.5b", "batch": 4, "seq": 64,
                 "optimizer": "adamw", "lr": 1e-3, "launch_steps": 20,
                 "steps": 3, "reduced": True, "dtype": "bfloat16"},
        "moe": {"arch": "mixtral-8x22b", "tokens": 64, "reduced": True},
        # (e)'s bounds come from this rehearsal (PERF.md §6)
        "tp": {"ranks": 2, "steps": 3, "batch": 4, "seq": 64,
               "frames": 32, "optimizer": "adamw", "lr": 3e-4,
               "launch_steps": 30, "reduced": True, "dtype": "bfloat16",
               "configs": MESH_FAMILIES, "bound": MESH_FAMILY_BOUND},
        # (f)'s bounds come from this rehearsal (PERF.md §6): the reduced
        # configs, 2 x 96 tokens (past the reduced window of 64; 3 MoE
        # groups of 64), 4 new, whisper's 16 frames
        "serve": {"configs": tuple(
            {**c, "batch": 2, "prompt": 96, "new": 4,
             **({"frames": 16} if "frames" in c else {})}
            for c in MESH_SERVE), "dtypes": ("bfloat16", "float32"),
            "reduced": True, "bound": MESH_SERVE_BOUND},
        "moe_tol": MESH_MOE_TOL, "seed": 0},
    # the sweep runs on meta in both; (b) and (c) need the card
    "lm_dryrun": LM_DRYRUN,
}
# the paper's case, factored only: a 1 TiB operand under a 1 GiB budget
PAPER_OOC = (1 << 37, 1 << 30)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got, want) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int) -> float:
    """Mean time of one call from CUDA events over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions and torch.fft; each
# variant's main-path case is timed beside its bound, plain and torch.fft


def kernel_cases(cfg, max_leaf: int) -> list:
    """(variant, wrapper, shape, options, timed): K1 at n = 256, 512,
    1024, 2048, MAX_LEAF with and without the periodic epilogue, K2 at L =
    256, 1024, MAX_LEAF row- and column-major with the epilogue, K3 at
    ``rfft_shapes`` with and
    without the untangle, K4 at ``stockham_shapes``. ``timed`` marks each
    variant's main-path case: the level-0 batch (coalesce 4 x 8192
    segments of 1024, or 4 x 32768 of 256), the level-1 first pass
    (2^20 points: 2 blocks x 16 segments as (32, 1024, 1024); 2^16: 4 x 128
    as (512, 256, 256)), all at 2^25 points; K3 at a spectrogram block's
    frames (65535 x 512, 32767 x 1024); K4 at the stockham run's batch
    (32768 x 1024). K1 at its other three-pass lengths is timed too,
    under its shape's name (`k1_length_names`), and so is K3's three-pass
    body at its other lengths and at the spectrogram cell's frames
    (`k3_length_names`). Then K2's clusters, and the calls of phases 6 and
    9-15 at their own shapes (`ooc_kernel_cases` and the others)."""
    points = cfg["points"]
    lengths = k1_length_names(cfg, max_leaf)
    k3_lengths = k3_length_names(cfg)
    cases = []
    for n in (256, 512, 1024, 2048, max_leaf):
        variant = "matfft/direct" if n <= 256 else "matfft/four_step"
        for period in (None, 64):
            cases.append((variant, "matfft", (points // n, n),
                          {"period": period},
                          period is None and (n in (256, 1024)
                                              or lengths.get(n, False))))
    for L in (256, 1024, 2048, max_leaf):
        variant = "matfft_cols/direct" if L <= 256 else \
            "matfft_cols/four_step"
        for out_major in ("row", "col"):
            cases.append((variant, "matfft_cols",
                          (max(points // (L * L), 1), L, L),
                          {"out_major": out_major, "with_epilogue": True},
                          out_major == "row" and L in (256, 1024)))
    for rows, n in dict.fromkeys([*cfg["rfft_shapes"], *k3_lengths]):
        variant = "rfft/direct" if n // 2 <= 256 else "rfft/four_step"
        for untangle in (True, False):
            cases.append((variant, "rfft", (rows, n), {"untangle": untangle},
                          untangle and (k3_lengths.get((rows, n))
                                        or n in (512, 1024))))
    for rows, n in cfg["stockham_shapes"]:
        cases.append(("stockham", "stockham", (rows, n), {}, n == 1024))
    return (cases + cluster_kernel_cases(cfg)
            + ooc_kernel_cases(cfg)
            + nd_kernel_cases(cfg) + dist_kernel_cases(cfg)
            + pencil_kernel_cases(cfg) + serve_kernel_cases(cfg)
            + pipeline_kernel_cases(cfg) + mesh_serve_kernel_cases(cfg))


def k1_length_names(cfg, max_leaf: int) -> dict:
    """{n: name}: K1 at the three-pass lengths other than the main path's
    1024, each timed in `kernel_cases` at ``points`` points under its
    shape's name in the `kernels` line, "matfft/four_step (rows, n)"."""
    return {n: f"matfft/four_step {(cfg['points'] // n, n)}"
            for n in (512, 2048, max_leaf)}


def k3_length_names(cfg) -> dict:
    """{(rows, n): name}: K3's three-pass body (`rfft_leaf`) at m = n/2 =
    1024, 2048 and 4096, ``points`` real samples each, beside the main
    path's m = 512, and at the spectrogram cell's frames of 1024 at hop 512
    over ``capture_samples``, each timed in `kernel_cases` under its
    shape's name in the `kernels` line, "rfft/four_step (rows, n)"."""
    frames = (cfg["capture_samples"] - 1024) // 512 + 1
    shapes = [(cfg["points"] // n, n) for n in (2048, 4096, 8192)]
    return {s: f"rfft/four_step {s}" for s in shapes + [(frames, 1024)]}


def cluster_kernel_cases(cfg) -> list:
    """K2's thread-block clusters (`plan.col_cluster`) at a few matrices
    each: L = 1024, 2048 and MAX_LEAF (clusters of 2, 4 and 8) in both
    stores with the global twiddle; slabs of 1, 2, 4, 8 and 1024 columns
    at the last aligned offset of ``slab_shape``, both stores, with the
    twiddle (one block alone below 8 columns, a cluster of 8 from 8 on).
    The options' cases draw their operands on the device, as phase 10's
    do. Untimed."""
    from repro_torch.kernels.fft import plan as kplan
    c = cfg["cluster"]
    B, C = c["rows"], c["cols"]

    def variant(L):
        return ("matfft_cols/direct" if L <= 256
                else "matfft_cols/four_step")

    cases = []
    for L in (1024, 2048, kplan.MAX_LEAF):
        for major in ("row", "col"):
            cases.append((variant(L), "matfft_cols", (B, L, C),
                          {"out_major": major, "with_epilogue": False,
                           "global_twiddle": (1 << 30, 4096),
                           "dist": True}, False))
    B1, L1, C1 = c["slab_shape"]
    for nc in (1, 2, 4, 8, 1024):
        for major in ("row", "col"):
            cases.append((variant(L1), "matfft_cols", (B1, L1, C1),
                          {"out_major": major, "with_epilogue": False,
                           "col_offset": C1 - nc, "ncols": nc,
                           "global_twiddle": (1 << 24, C1 - nc),
                           "dist": True}, False))
    return cases


def ooc_kernel_cases(cfg) -> list:
    """The K1/K2 calls of phase 6's runs (at scale, its short-disk
    fallback, bitwise) at the shapes those runs give them: a pass of t
    rows of length m is one K1 call (t, m) when m is one leaf, else the
    level-1 four-step m = m1 * m2 as two K2 calls, (t, m1, m2) row-major
    with the outer twiddle and (t, m2, m1) column-major without.
    Untimed."""
    from repro_torch.fft import factor_out_of_core
    from repro_torch.kernels.fft import plan as kplan

    c = cfg["ooc"]
    runs = [(c["log2_n"], c["budget_mb"] << 20),
            (c["short_disk_log2_n"], c["budget_mb"] << 20),
            (c["bitwise_log2_n"],
             (8 << c["bitwise_log2_n"]) // c["bitwise_budget_div"])]
    shapes = set()
    for log2_n, budget in runs:
        f = factor_out_of_core(1 << log2_n, budget)
        for t, m in ((f.t2, f.n1), (f.t1, f.n2)):
            p = kplan.make_plan(m)
            check(p.levels <= 2, f"out-of-core pass length {m} is past "
                  f"one four-step; add its kernel shapes")
            if p.levels == 1:
                shapes.add(("matfft", (t, m), None))
            else:
                shapes.add(("matfft_cols", (t, p.n1, p.n2), "row"))
                shapes.add(("matfft_cols", (t, p.n2, p.n1), "col"))
    cases = []
    for kernel, shape, major in sorted(shapes):
        if kernel == "matfft":
            variant = "matfft/direct" if shape[1] <= 256 else \
                "matfft/four_step"
            opts = {"period": None}
        else:
            variant = "matfft_cols/direct" if shape[1] <= 256 else \
                "matfft_cols/four_step"
            opts = {"out_major": major, "with_epilogue": major == "row"}
        cases.append((variant, kernel, shape, {**opts, "out_of_core": True},
                      False))
    return cases


def nd_kernel_cases(cfg) -> list:
    """Every K1/K2/K3 call of phase 9's runs at the shape the run gives
    it, each timed under its own name ("<variant> <shape>[ <major>]");
    drawn on the device from a seeded generator."""
    shapes = set()
    for run in nd_runs(cfg).values():
        shapes.update(key[:3] for key in run["launches"])
    cases = []
    for kernel, shape, major in sorted(shapes):
        leaf = shape[1]
        if kernel == "matfft":
            variant = "matfft/direct" if leaf <= 256 else "matfft/four_step"
            opts = {"period": None}
        elif kernel == "matfft_cols":
            variant = "matfft_cols/direct" if leaf <= 256 else \
                "matfft_cols/four_step"
            opts = {"out_major": major, "with_epilogue": major == "row"}
        else:
            variant = "rfft/direct" if leaf // 2 <= 256 else "rfft/four_step"
            kernel, opts = "rfft", {"untangle": False}
        name = f"{variant} {tuple(shape)}" + (f" {major}" if major else "")
        cases.append((variant, kernel, shape, {**opts, "nd": True}, name))
    return cases


def dist_split(n: int) -> tuple[int, int]:
    """(n1, n2) of the distributed four-step at n with D <= sqrt(n): n1 =
    2^floor(log2(n) / 2) (core/fft/distributed.py:plan_distributed)."""
    p = n.bit_length() - 1
    return 1 << (p // 2), 1 << (p - p // 2)


def option_key(kernel: str, shape, major, opts) -> tuple:
    """A call's `matfft.launch_shapes` key: (wrapper, shape, major), and
    with the global twiddle, a column slab or K2's thread-block cluster
    (`plan.col_cluster`), a fourth entry naming them."""
    from repro_torch.kernels.fft import plan as kplan
    K = (kplan.col_cluster(shape[1], opts.get("ncols") or shape[2])[1]
         if kernel == "matfft_cols" else 1)
    tags = (("twiddle",) if opts.get("global_twiddle") else ()) + (
        ("slab", opts["ncols"]) if opts.get("ncols") else ()) + (
        ("cluster", K) if K > 1 else ())
    return (kernel, tuple(shape), major) + ((tags,) if tags else ())


def key_cluster(key: tuple) -> int:
    """The blocks of K2's thread-block cluster that a `launch_shapes` key
    records: its last option ("cluster", K); 1, one block alone, without
    one."""
    tags = key[3] if len(key) > 3 else ()
    return tags[-1] if tags[-2:-1] == ("cluster",) else 1


def dist_kernel_cases(cfg) -> list:
    """K1 and K2 with the distributed four-step's options: the global
    twiddle and K2's column slab. Timed (under their own names) at the
    shapes phase 10's runs give them on one rank: pass 1 fused (K2 row,
    K1 in the copy layout; a whole pass and a slab of the overlapped
    engine), pass 2's slab; checked only: the options at shapes one rank
    does not reach (the twiddle in a col-major store, a one-column slab)
    and at the per-rank shapes of a plan over ``ranks`` ranks (pass 1
    with each rank's row offset, pass 2's slabs)."""
    c = cfg["dist"]
    n = c["n"]
    n1, n2 = dist_split(n)
    k, d = c["chunks"], c["ranks"]
    n1l, n2l = n1 // d, n2 // d

    def twiddle(off):
        return {"global_twiddle": (n, off)}

    def slab(off, nc):
        return {"col_offset": off, "ncols": nc}

    cases = [  # (kernel, shape, major, options, timed)
        ("matfft_cols", (1, n1, n2), "row", twiddle(0), True),
        ("matfft_cols", (1, n1, n2), "col", twiddle(0), False),
        ("matfft_cols", (1, n1, n2 // k), "row", twiddle(n2 // k), True),
        ("matfft_cols", (1, n2, n1), "col", slab(n1 // k, n1 // k), True),
        ("matfft_cols", (1, n2, n1), "col", slab(n1 - 1, 1), False),
        ("matfft", (n2, n1), None, twiddle(0), True),
        ("matfft", (n2 // k, n1), None, twiddle(3 * n2 // k), True)]
    cases += [("matfft_cols", (1, n1, n2l), "row", twiddle(r * n2l), False)
              for r in range(d)]
    cases += [("matfft_cols", (1, n2, n1l), "col",
               slab(j * n1l // k, n1l // k), False) for j in range(k)]
    calls, names = [], {}
    for kernel, shape, major, opts, timed in cases:
        key = option_key(kernel, shape, major, opts)
        calls.append((key, {**opts, **(
            {"period": None} if kernel == "matfft" else
            {"out_major": major, "with_epilogue": False})}))
        if timed:
            names[key] = dist_case_name(variant_of(key), key)
    # every other call of phase 10's runs, at its own shape and offsets
    calls += [call for run in dist_runs(cfg) for call in dist_calls(*run)]
    calls += [call for kind in ("c2c", "r2c")
              for call in seg_calls(kind, *c[f"seg_{kind}"])]
    return calls_as_cases(calls, names)


def case_key(kernel: str, shape, opts) -> tuple:
    """The `matfft.launch_shapes` key of a phase 3 case's call."""
    if kernel == "rfft":
        kernel = "rfft_leaf" if opts["untangle"] else "rfft_pack_leaf"
    return option_key(kernel, shape, opts.get("out_major"), opts)


def dist_case_name(variant: str, key: tuple) -> str:
    """A timed option case's name in the `kernels` line: "<variant>
    <shape>[ <major>] twiddle|slab <ncols>"."""
    words = [variant, str(key[1])] + ([key[2]] if key[2] else [])
    tags = key[3]
    if "twiddle" in tags:
        words.append("twiddle")
    if "slab" in tags:
        words.append(f"slab {tags[tags.index('slab') + 1]}")
    return " ".join(words)


def case_work(km, ks, kplan, kernel: str, shape, opts, epi, dev):
    """(bytes, flops) of one call: each input read once (the tables too),
    each output written once; 5 n log2 n flops a complex row, 6 a point
    for an epilogue's complex product and 12 for the global twiddle's (the
    two tables' product, then the output's), and for K3 the reference
    planner's count, 5 m log2 m + 10 m a row (m = n/2)."""
    def table_bytes(tables):
        return sum(t.numel() * 4 for t in tables)

    if kernel in ("matfft", "matfft_cols"):
        if kernel == "matfft":
            rows, n = shape
        else:
            B, n, C = shape
            rows = B * (opts.get("ncols") or C)
        gt = opts.get("global_twiddle")
        nbytes = (rows * kplan.fft_hbm_bytes(n)
                  + table_bytes(km.leaf_tables(n, dev))
                  + (table_bytes(epi) if epi is not None else 0)
                  + (table_bytes(km.global_twiddle_tables(gt[0], dev))
                     if gt else 0))
        flops = rows * (5.0 * n * math.log2(n)
                        + (6.0 * n if epi is not None else 0.0)
                        + (12.0 * n if gt else 0.0))
    elif kernel == "rfft":
        rows, n = shape
        m = n // 2
        width = m + 1 if opts["untangle"] else m
        nbytes = (rows * (4 * n + 8 * width)
                  + table_bytes(km.leaf_tables(m, dev))
                  + table_bytes(km.rfft_twiddle(n, dev)))
        flops = rows * (5.0 * m * math.log2(m) + 10.0 * m)
    else:
        rows, n = shape
        nbytes = rows * 16 * n + table_bytes(ks.stockham_table(n, dev))
        flops = rows * 5.0 * n * math.log2(n)
    return nbytes, flops


def run_cases(torch, dev, cfg, gpu: bool, cases,
              seed: int = 0) -> tuple[list, dict]:
    """Each case's kernel against its plain version (bitwise on the card)
    and torch.fft; the timed ones timed beside their bound, plain version
    and torch.fft. Returns (checks, timing by name)."""
    from collections import Counter

    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import plan as kplan
    from repro_torch.kernels.fft import stockham as ks

    # every operand drawn on the device from ``gen`` (a host draw of the
    # largest shapes costs seconds a case)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = cfg["reps"]

    def real(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def planes(shape):
        return real(shape), real(shape)

    def unit_table(shape):
        ang = (2 * torch.rand(shape, generator=gen, device=dev,
                              dtype=torch.float64) - 1) * math.pi
        return ang.cos().float(), ang.sin().float()

    def times(epi, er, ei):  # (rows, n) planes times per-row table rows
        return er * epi[0] - ei * epi[1], er * epi[1] + ei * epi[0]

    def global_twiddle(rows, n, gt):
        """W_N^((row_off + r) * o mod N), (rows, n), complex128."""
        n_global, off = gt
        r = torch.arange(off, off + rows, device=dev)
        m = (r[:, None] * torch.arange(n, device=dev)) % n_global
        return torch.exp((-2j * math.pi / n_global) * m.double())

    def launched(fn, want: tuple):
        """fn's result, and the blocks of K2's cluster that its launches
        ran: read from the one `launch_shapes` key they added (in the
        rehearsal, `plain_shapes`), which must be the case's own
        (``want``)."""
        shapes = km.launch_shapes if gpu else km.plain_shapes
        before = Counter(shapes)
        out = fn()
        keys = set(shapes - before)
        check(keys == {want}, f"{variant}: launched {keys}, not {want}")
        [key] = keys
        return out, key_cluster(key)

    checks, timing = [], {}
    for variant, kernel, shape, opts, timed in cases:
        epi = None
        cluster = None  # K2: the blocks of the cluster its launches ran
        # phases 9 and 10's shapes (up to 2^27 points) drawn on the device
        nd = opts.get("nd", False) or opts.get("dist", False)
        lib_time = None
        # the distributed four-step's options (dist_kernel_cases)
        kw = {k: opts[k] for k in ("global_twiddle", "col_offset", "ncols")
              if opts.get(k) is not None}
        gt = opts.get("global_twiddle")
        if kernel == "matfft":
            xr, xi = planes(shape)
            xc = torch.complex(xr, xi)
            rows, n = shape
            epi = (unit_table((opts["period"], n)) if opts["period"]
                   else None)
            run = lambda: km.matfft(  # noqa: E731
                xr, xi, epilogue=epi, **kw)
            plain = lambda: km.matfft_plain(  # noqa: E731
                xr, xi, epilogue=epi, **kw)
            lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
            y = lib()
            if gt:
                y = y * global_twiddle(rows, n, gt)
            want = (y.real, y.imag)
            if epi is not None:
                idx = torch.arange(rows, device=dev) % opts["period"]
                want = times((epi[0][idx], epi[1][idx]), *want)
        elif kernel == "matfft_cols":
            xr, xi = planes(shape)
            B, n, C = shape
            off, nc = opts.get("col_offset", 0), opts.get("ncols") or C
            xc = torch.complex(xr, xi)[:, :, off:off + nc]
            rows = B * nc
            epi = unit_table((C, n)) if opts["with_epilogue"] else None
            major = opts["out_major"]
            run = lambda: km.matfft_cols(  # noqa: E731
                xr, xi, out_major=major, epilogue=epi, **kw)
            plain = lambda: km.matfft_cols_plain(  # noqa: E731
                xr, xi, out_major=major, epilogue=epi, **kw)
            lib = lambda: torch.fft.fft(xc, dim=1)  # noqa: E731
            y = lib().transpose(1, 2).reshape(rows, n)
            if gt:
                y = y * global_twiddle(rows, n, gt)
            want = (y.real, y.imag)
            if epi is not None:
                want = times((epi[0].repeat(B, 1), epi[1].repeat(B, 1)),
                             *want)
            if major == "col":
                want = tuple(t.reshape(B, nc, n).transpose(1, 2)
                             for t in want)
        elif kernel == "rfft":
            x = real(shape)
            if opts["untangle"]:
                run = lambda: km.rfft_leaf(x)  # noqa: E731
                plain = lambda: km.rfft_leaf_plain(x)  # noqa: E731
                lib = lambda: torch.fft.rfft(x, dim=-1)  # noqa: E731
            else:  # the packed half spectrum: the DFT of x[0::2] + i x[1::2]
                xc = torch.complex(x[:, 0::2], x[:, 1::2])
                run = lambda: km.rfft_pack_leaf(x)  # noqa: E731
                plain = lambda: km.rfft_pack_leaf_plain(x)  # noqa: E731
                lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
                # timed: the one-sided transform of the same real rows
                lib_time = lambda: torch.fft.rfft(x, dim=-1)  # noqa: E731
            y = lib()
            want = (y.real, y.imag)
        else:
            xr, xi = planes(shape)
            xc = torch.complex(xr, xi)
            run = lambda: ks.stockham_fft(xr, xi)  # noqa: E731
            plain = lambda: ks.stockham_fft_plain(xr, xi)  # noqa: E731
            lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
            y = lib()
            want = (y.real, y.imag)
        if kernel == "matfft_cols":  # the CPU wrapper calls plain()
            key = case_key(kernel, shape, opts)
            got, cluster = launched(run, key)
        else:
            got = run() if gpu else plain()
        ref = plain()
        got_c = torch.complex(*got)
        max_abs = float((got_c - torch.complex(*ref)).abs().max())
        c = {"variant": variant, "shape": list(shape),
             **{k: v for k, v in opts.items() if k != "global_twiddle"},
             "global_twiddle": list(gt) if gt else None,
             "epilogue": list(epi[0].shape) if epi is not None else None,
             "max_abs_err": max_abs, "bitwise_plain": max_abs == 0.0,
             "rel_err_plain": max_abs / float(torch.complex(*ref).abs().max()),
             "rel_err_torch_fft": rel_err(got_c, torch.complex(*want)),
             **({"cluster": cluster} if cluster is not None else {})}
        print("check " + json.dumps(c))
        checks.append(c)
        check(c["rel_err_plain"] < TOL and c["rel_err_torch_fft"] < TOL,
              f"kernel disagrees: {c}")
        if gpu:  # every kernel rounds as its plain version
            check(c["bitwise_plain"], f"kernel differs from its plain "
                  f"version: {c}")
        del got, ref, got_c, want, y
        if kernel == "rfft" and not opts["untangle"]:
            del xc
        if gpu and timed:
            # plain, kernel, kernel, plain: one card, one call
            t_plain = [timed_ms(torch, plain, reps)]
            if cluster is not None:  # the cluster the timed launches ran
                t_kernel, cluster = launched(lambda: [
                    timed_ms(torch, run, reps) for _ in range(2)], key)
            else:
                t_kernel = [timed_ms(torch, run, reps),
                            timed_ms(torch, run, reps)]
            t_plain.append(timed_ms(torch, plain, reps))
            nbytes, flops = case_work(km, ks, kplan, kernel, shape, opts, epi,
                                      dev)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_flops = flops / F32_FLOPS_S * 1e3
            timing[timed if isinstance(timed, str) else variant] = {
                "case": c, "bytes": nbytes, "flops": flops,
                "max_abs_err": max_abs, "max_rel_err": c["rel_err_plain"],
                "bitwise_plain": c["bitwise_plain"],
                "ms": min(t_kernel), "ms_runs": t_kernel,
                "plain_ms": min(t_plain), "plain_ms_runs": t_plain,
                "library_ms": timed_ms(torch, lib_time or lib, reps),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                **({"cluster": cluster} if cluster is not None else {})}
        del run, plain, lib, lib_time
        if (nd or opts.get("dist")) and gpu:
            torch.cuda.empty_cache()
    return checks, timing


def kernel_checks(torch, dev, cfg, gpu: bool) -> tuple[list, dict, dict]:
    """Phase 3: `kernel_cases` through `run_cases`, then batch invariance
    and zero_copy == copy, their operands drawn on the device."""
    from repro_torch.fft import executors
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import plan as kplan
    from repro_torch.kernels.fft import stockham as ks

    checks, timing = run_cases(torch, dev, cfg, gpu,
                               kernel_cases(cfg, kplan.MAX_LEAF))
    gen = torch.Generator(device=dev).manual_seed(1)

    def real(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def planes(shape):
        return real(shape), real(shape)

    # batch invariance: row 0 alone == row 0 inside the big batch, bitwise;
    # K1, K3 and K4 at lengths of two and of three passes or groups (K3 at
    # n = 512 runs m = 256)
    invariance = {}
    for name, fn, lengths, real_rows in (
            ("matfft", km.matfft if gpu else km.matfft_plain,
             (256, 1024, 2048, 4096), False),
            ("rfft_leaf", km.rfft_leaf if gpu else km.rfft_leaf_plain,
             (512, 1024, 2048, 4096), True),
            ("rfft_pack_leaf",
             km.rfft_pack_leaf if gpu else km.rfft_pack_leaf_plain,
             (512, 1024, 2048, 4096), True),
            ("stockham_fft", ks.stockham_fft if gpu else ks.stockham_fft_plain,
             (256, 1024, 2048, 4096), False)):
        for n in lengths:
            args = (real((cfg["batch_rows"], n)),) if real_rows else planes(
                (cfg["batch_rows"], n))
            alone = fn(*(a[:1].contiguous() for a in args))
            batch = fn(*args)
            key = f"{name}/{n}"
            invariance[key] = (torch.equal(alone[0][0], batch[0][0])
                               and torch.equal(alone[1][0], batch[1][0]))
            print(f"batch invariance of {name} (1 row vs {cfg['batch_rows']} "
                  f"rows, n={n}): "
                  f"{'bitwise equal' if invariance[key] else 'DIFFERENT'}")
            if gpu:  # the plain versions' matmuls need not be batch invariant
                check(invariance[key],
                      f"{name}: row 0 alone differs from row 0 in the batch "
                      f"at n={n}")

    # zero_copy == copy: K2's column passes (L = 256, 512, 1024 and, in
    # clusters, 2048 and 4096: both passes at 2^24) against K1's row
    # passes over materialized transposes, bitwise; at most 2^26 points
    for n in cfg["layout_ns"]:
        xr, xi = planes((min(cfg["layout_rows"], (1 << 26) // n), n))
        zc = executors.fft(xr, xi, layout="zero_copy")
        cp = executors.fft(xr, xi, layout="copy")
        same = torch.equal(zc[0], cp[0]) and torch.equal(zc[1], cp[1])
        invariance[f"zero_copy==copy/{n}"] = same
        print(f"zero_copy vs copy ({xr.shape[0]} rows, n={n}): "
              f"{'bitwise equal' if same else 'DIFFERENT'}")
        if gpu:
            check(same, f"zero_copy and copy differ at n={n}")
        del zc, cp
    return checks, invariance, timing


def kernel_line(timing: dict, launches: dict) -> list:
    """The `kernels` entries: measured numbers, the main path's launch
    counts and the bound; each variant's shape, bytes and flops stay in
    chiprun_out/chip_smoke.json."""
    return [{"name": name, "route": "cuda",
             "source": SOURCE[t["case"]["variant"]],
             "replaces": REPLACES[t["case"]["variant"]],
             "launches": launches[name],
             **({"cluster": t["cluster"]} if "cluster" in t else {}),
             **{k: t[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                  "bitwise_plain", "ms_runs", "plain_ms",
                                  "plain_ms_runs",
                                  "library_ms", "bound_ms", "bound_by")}}
            for name, t in timing.items()]


# ---------------------------------------------------------------------------
# phases 4-5: the main path through fft_job


def run_job(argv: list) -> dict:
    from repro_torch.launch import fft_job
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = fft_job.main(argv)
    return report


def check_job_output(torch, dev, work: Path, fft_len: int) -> float:
    """Every output block within TOL of torch.fft.fft of its input block;
    returns the worst block's error."""
    import numpy as np

    from repro_torch.core.pipeline import BlockStore, segments_of_block

    store = BlockStore.open(work / "in")
    worst = 0.0
    for i, info in enumerate(store.blocks):
        re, im = segments_of_block(store.read_block(i), fft_len)
        out_file = work / "out" / info.name()
        yr, yi = segments_of_block(out_file.read_bytes(), fft_len)
        x = torch.complex(torch.from_numpy(re).to(dev),
                          torch.from_numpy(im).to(dev))
        want = torch.fft.fft(x, dim=-1)
        got = torch.complex(torch.from_numpy(yr).to(dev),
                            torch.from_numpy(yi).to(dev))
        check(bool(torch.isfinite(got).all()), f"block {i}: non-finite")
        e = rel_err(got, want)
        check(e < TOL, f"block {i}: {e} vs torch.fft.fft")
        worst = max(worst, e)
        del x, want, got
    check(np.isfinite(worst), "no blocks checked")
    return worst


def reset_counts() -> None:
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import stockham as ks
    km.reset_counts()
    ks.reset_counts()


def read_counts() -> dict:
    """Launches of every kernel wrapper, and the plain versions' calls in
    all, since the last `reset_counts`."""
    from repro_torch.kernels.fft import matfft as km
    from repro_torch.kernels.fft import stockham as ks
    return {"matfft": km.matfft.launches,
            "matfft_cols": km.matfft_cols.launches,
            "rfft_leaf": km.rfft_leaf.launches,
            "rfft_pack_leaf": km.rfft_pack_leaf.launches,
            "stockham": ks.stockham_fft.launches,
            "plain": (km.matfft_plain.calls + km.matfft_cols_plain.calls
                      + km.rfft_leaf_plain.calls
                      + km.rfft_pack_leaf_plain.calls
                      + ks.stockham_fft_plain.calls)}


def read_shapes(gpu: bool):
    """Counter of (wrapper, shape, out_major) over the kernel launches since
    the last `reset_counts`; in the rehearsal, over the calls the wrappers
    gave to their plain versions."""
    from collections import Counter
    from repro_torch.kernels.fft import matfft as km
    return Counter(km.launch_shapes if gpu else km.plain_shapes)


def check_main_path(gpu: bool, name: str, counts: dict, kernel: str) -> None:
    if gpu:
        check(counts[kernel] > 0, f"{name}: {kernel} never launched")
        check(counts["plain"] == 0,
              f"{name}: a plain version ran on the main path")
    else:
        check(counts["plain"] > 0, f"rehearsal {name}: plain path not run")


# ---------------------------------------------------------------------------
# phase 6: the out-of-core transform


def ooc_check(torch, dev, merged: Path, n: int, seed: int, factors) -> float:
    """The merged spectrum against torch.fft.fft on the card: the input
    regenerated from the seed, compared in transposed order,
    out == T(fft(T(s))) with T(v) = v.reshape(n2, n1).T. Returns the
    error."""
    import numpy as np

    from repro_torch.launch.fft_job import operand_chunks

    def corner_turn(v):
        return v.reshape(factors.n2, factors.n1).T.contiguous().reshape(-1)

    s = torch.empty(n, dtype=torch.complex64, device=dev)
    start = 0
    for chunk in operand_chunks(n, seed):
        s[start:start + len(chunk)] = torch.view_as_complex(
            torch.from_numpy(chunk).to(dev))
        start += len(chunk)
    want = corner_turn(torch.fft.fft(corner_turn(s)))
    del s
    got = torch.view_as_complex(torch.from_numpy(
        np.fromfile(merged, np.float32).reshape(n, 2)).to(dev))
    check(bool(torch.isfinite(got).all()), "out-of-core: non-finite output")
    e = rel_err(got, want)
    del got, want
    return e


def ooc_encode_s(factors, panels: int = 3) -> dict:
    """Host seconds of pass 1's encode for one (t2, n1) panel, alone on an
    idle host: the twiddle (`_apply_twiddle`) and the interleave
    (`block_of_segments`), mean over ``panels`` job indices spread over
    the pass."""
    import numpy as np

    from repro_torch.core.fft.outofcore import _apply_twiddle
    from repro_torch.core.pipeline.records import block_of_segments

    f = factors
    rng = np.random.default_rng(2)
    yr, yi = rng.standard_normal((2, f.t2, f.n1), dtype=np.float32)
    twiddle = interleave = 0.0
    jobs = [c * (f.pass1_jobs - 1) // max(panels - 1, 1)
            for c in range(panels)]
    for c in jobs:
        t0 = time.perf_counter()
        tr, ti = _apply_twiddle(yr, yi, c * f.t2, f.n)
        t1 = time.perf_counter()
        block_of_segments(tr, ti)
        twiddle += t1 - t0
        interleave += time.perf_counter() - t1
    return {"twiddle_s": twiddle / len(jobs),
            "interleave_s": interleave / len(jobs), "panels": jobs}


def ooc_at_scale(torch, dev, gpu: bool, cfg: dict, work: Path,
                 device_arg: list) -> dict:
    """`fft_job --out-of-core` through its CLI at the configured size (or
    the short-disk size), checked on the card."""
    log2_n = cfg["log2_n"]
    need = 4 * 8 << log2_n  # input, tiles, output and merged file at once
    work.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(work.parent).free
    print(f"out-of-core: {free} bytes free under {work.parent}, "
          f"{need} needed at 2^{log2_n}")
    if free < need + (need >> 3):
        log2_n = cfg["short_disk_log2_n"]
        print(f"out-of-core: disk short, cut to 2^{log2_n} points")
    argv = ["--out-of-core", "--log2-n", str(log2_n), "--budget-mb",
            str(cfg["budget_mb"]), *device_arg, "--work-dir", str(work)]
    reset_counts()
    report = run_job(argv)
    counts = read_counts()
    f = report["factors"]
    stats = report["stats"]
    attempts = stats["pass1_attempts"] + stats["pass2_attempts"]
    check(stats["io"]["total"] == f["io_bytes"],
          f"out-of-core: measured I/O {stats['io']} != model {f['io_bytes']}")
    check(f["working_set_bytes"] <= f["budget_bytes"] < f["operand_bytes"],
          f"out-of-core: working set {f['working_set_bytes']}, budget "
          f"{f['budget_bytes']}, operand {f['operand_bytes']}")
    check(attempts == f["pass1_jobs"] + f["pass2_jobs"],
          f"out-of-core: {attempts} attempts for "
          f"{f['pass1_jobs'] + f['pass2_jobs']} jobs")
    # both passes run the level-1 four-step: two K2 launches a job
    kernel = "matfft_cols" if min(f["n1"], f["n2"]) > 4096 else "matfft"
    check_main_path(gpu, "out-of-core", counts, kernel)
    if gpu and kernel == "matfft_cols":
        check(counts["matfft_cols"] == 2 * attempts,
              f"out-of-core: {counts['matfft_cols']} K2 launches for "
              f"{attempts} jobs")
    from repro_torch.fft import factor_out_of_core
    factors = factor_out_of_core(f["n"], f["budget_bytes"])
    t0 = time.monotonic()
    err = ooc_check(torch, dev, work / "merged.bin", f["n"], 0, factors)
    check(err < TOL, f"out-of-core: {err} vs torch.fft.fft")
    summary = {"run": "out_of_core", "factors": f,
               "block_bytes": report["block_bytes"],
               "copy_in_s": report["copy_in_s"], "job_s": report["job_s"],
               "merge_s": report["merge_s"],
               "stage_s": {p: stats[p]["stage_s"] for p in ("pass1",
                                                             "pass2")},
               "wall_s": {p: stats[p]["wall_s"] for p in ("pass1", "pass2")},
               "attempts": {"pass1": stats["pass1_attempts"],
                            "pass2": stats["pass2_attempts"]},
               "io": stats["io"], "launches": counts,
               "max_rel_err": err, "check_s": time.monotonic() - t0,
               "encode_one_panel": ooc_encode_s(factors)}
    print("out_of_core " + json.dumps(summary))
    return summary


def ooc_bitwise_and_resume(torch, dev, gpu: bool, cfg: dict,
                           work: Path) -> dict:
    """The streamed output bitwise equal to the in-memory oracle on the
    card, then again after a shuffle failure that exhausts one pass-1
    job's retries and a resume over the same work directory."""
    import numpy as np

    from repro_torch.core.fft.outofcore import reference_out_of_core
    from repro_torch.core.pipeline import BlockStore, JobConfig
    from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                             FaultRule)
    from repro_torch.fft import factor_out_of_core, plan
    from repro_torch.launch.fft_job import operand_chunks

    n = 1 << cfg["bitwise_log2_n"]
    budget = 8 * n // cfg["bitwise_budget_div"]
    f = factor_out_of_core(n, budget)
    sig = np.concatenate(list(operand_chunks(n, 1)))
    store = BlockStore(work / "in", block_bytes=f.pass1_panel_bytes)
    store.put_bytes(sig)

    def streamed(name, config=None):
        p = plan(kind="c2c", n=n, placement="out_of_core", store=store,
                 work_dir=work / name, budget_bytes=budget, impl="matfft",
                 job_config=config, device=dev)
        reset_counts()
        try:
            stats = p.execute()
        finally:
            counts = read_counts()
        check_main_path(gpu, f"out-of-core {name}", counts, "matfft")
        return p, stats, counts

    def merged(p):
        p.merge(p.work_dir / "merged.bin")
        return (p.work_dir / "merged.bin").read_bytes()

    p, stats, counts = streamed("bitwise")
    launches = counts["matfft"]
    oracle = reference_out_of_core(sig, f, impl="matfft", device=dev)
    equal = merged(p) == oracle
    print(f"out-of-core 2^{cfg['bitwise_log2_n']} streamed vs oracle: "
          f"{'bitwise equal' if equal else 'DIFFERENT'}")
    check(equal, "out-of-core streamed output differs from the oracle")

    victim = f.pass1_jobs // 2
    killer = FaultInjector(FaultPlan((FaultRule(
        site="ooc.shuffle", index=victim * f.pass1_jobs + victim,
        calls=(1, 2, 3, 4)),)))
    crash_cfg = JobConfig(readers=2, writers=2, inflight=2,
                          speculation=False, max_retries=3, injector=killer)
    try:
        streamed("resume", crash_cfg)
        crashed = False
    except RuntimeError as e:
        crashed = "failed" in str(e)
        crash_counts = read_counts()
    check(crashed, "out-of-core: the scheduled shuffle failure did not "
          "stop the run")
    p, stats, counts = streamed("resume")
    launches += crash_counts["matfft"] + counts["matfft"]
    check(0 < stats.pass1_attempts < f.pass1_jobs,
          f"out-of-core resume: {stats.pass1_attempts} pass-1 attempts of "
          f"{f.pass1_jobs} jobs")
    equal_resumed = merged(p) == oracle
    print(f"out-of-core resume: {stats.pass1_attempts} of {f.pass1_jobs} "
          f"pass-1 jobs redone, output "
          f"{'bitwise equal' if equal_resumed else 'DIFFERENT'}")
    check(equal_resumed, "out-of-core resumed output differs from the "
          "oracle")
    return {"run": "out_of_core_bitwise", "factors": f.as_dict(),
            "bitwise": equal, "resumed_bitwise": equal_resumed,
            "resume_pass1_attempts": stats.pass1_attempts,
            "launches": launches}


def ooc_paper_size() -> dict:
    """The paper's >1 TB case, factored only: no time is claimed."""
    from repro_torch.fft import factor_out_of_core
    f = factor_out_of_core(*PAPER_OOC).as_dict()
    print("out_of_core_paper " + json.dumps(f))
    check(f["working_set_bytes"] <= f["budget_bytes"],
          f"paper size: working set over budget {f}")
    return f


# ---------------------------------------------------------------------------
# phase 7: the spectrogram job of examples/spectral_analysis.py


def synth_capture(torch, dev, samples: int, seed: int = 0):
    """The example's capture at ``samples`` samples: three tones, a 0.5 s
    chirp in the middle, Gaussian noise from numpy's generator; tones and
    chirp computed on ``dev`` in float64, 2^24 samples at a time. Returns
    float32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.empty(samples, np.float32)
    mid = samples // 2
    w = torch.arange(SR // 2, dtype=torch.float64, device=dev) / SR
    chirp = 2.0 * torch.sin(2 * math.pi * (2000 + 6000 * w) * w * SR)
    step = 1 << 24
    for s in range(0, samples, step):
        e = min(samples, s + step)
        t = torch.arange(s, e, dtype=torch.float64, device=dev) / SR
        x = 0.05 * torch.from_numpy(rng.standard_normal(e - s)).to(dev)
        for hz in TONES_HZ:
            x += torch.sin(2 * math.pi * hz * t)
        lo, hi = max(s, mid), min(e, mid + SR // 2)
        if lo < hi:
            x[lo - s:hi - s] += chirp[lo - mid:hi - mid]
        out[s:e] = x.float().cpu().numpy()
    return out


def spectrogram_run(torch, dev, gpu: bool, store, work: Path, variant: str,
                    frame: int, hop: int) -> dict:
    """One map-only spectrogram job over ``store`` (the example's steps 2
    and 3), its launch counts read just after the job, then its checks."""
    import numpy as np

    from repro_torch.core.pipeline import JobConfig, MapOnlyJob
    from repro_torch.core.spectral import power_spectrogram, stft

    def map_fn(data, idx):
        x = torch.from_numpy(np.frombuffer(data, np.float32).copy())
        ps = power_spectrogram(x, frame, hop, device=dev)
        return ps.cpu().numpy().tobytes()

    job = MapOnlyJob(store, work / "out", map_fn, JobConfig(workers=4))
    reset_counts()
    t0 = time.monotonic()
    stats = job.run()
    job_s = time.monotonic() - t0
    counts = read_counts()
    check_main_path(gpu, variant, counts, "rfft_leaf")

    # every block's stft against torch.fft.rfft of the same windowed frames
    window = torch.from_numpy((0.5 - 0.5 * np.cos(
        2 * math.pi * np.arange(frame) / frame)).astype(np.float32)).to(dev)
    worst = 0.0
    for i in range(len(store.blocks)):
        x = torch.from_numpy(
            np.frombuffer(store.read_block(i), np.float32).copy()).to(dev)
        got = torch.complex(*stft(x, frame, hop, device=dev))
        want = torch.fft.rfft(x.unfold(-1, frame, hop) * window, dim=-1)
        check(bool(torch.isfinite(got).all()), f"{variant} block {i}: "
              f"non-finite stft")
        e = rel_err(got, want)
        check(e < TOL, f"{variant} block {i}: stft {e} vs torch.fft.rfft")
        worst = max(worst, e)
        del x, got, want

    # step 3: the merged power spectrogram finds the tones and the chirp
    nbytes = job.merge(work / "spectrogram.bin")
    n_bins = frame // 2 + 1
    spec = np.fromfile(work / "spectrogram.bin", np.float32).reshape(-1,
                                                                     n_bins)
    found = np.sort(np.argsort(spec.mean(axis=0))[-3:]) * SR / frame
    for f, hz in zip(found, sorted(TONES_HZ)):
        check(abs(f - hz) < SR / frame + 1,
              f"{variant}: tone {hz} Hz found at {f} Hz")
    per_block = spec.shape[0] // len(store.blocks)
    peak = int(spec[:, n_bins // 2:].sum(axis=1).argmax())
    block_samples = store.block_bytes // 4
    chirp_s = ((peak // per_block) * block_samples
               + (peak % per_block) * hop) / SR
    expected_s = store.total_bytes // 4 // 2 / SR
    check(abs(chirp_s - expected_s) < 1.0,
          f"{variant}: chirp at {chirp_s} s, expected {expected_s} s")
    summary = {"run": variant, "frame": frame, "hop": hop,
               "blocks": len(store.blocks), "job_s": job_s,
               "gb_per_s": store.total_bytes / job_s / 1e9,
               "merged_bytes": nbytes, "retries": stats.retries,
               "speculative": stats.speculative_launches,
               "launches": counts, "worst_block_rel_err": worst,
               "tones_hz": [float(f) for f in found], "chirp_s": chirp_s}
    print("spectrogram " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# phase 8: fft_conv against a float64 torch.fft convolution


def conv_checks(torch, dev, gpu: bool, cases) -> list:
    import numpy as np

    from repro_torch.core.spectral import fft_conv
    from repro_torch.kernels.fft import plan as kplan

    rng = np.random.default_rng(1)
    out = []
    for batch, t, tk in cases:
        x = torch.from_numpy(rng.standard_normal((batch, t),
                                                 dtype=np.float32)).to(dev)
        k = torch.from_numpy(rng.standard_normal(tk,
                                                 dtype=np.float32)).to(dev)
        reset_counts()
        got = fft_conv(x, k, device=dev)
        counts = read_counts()
        n = 1 << max(1, (t + tk - 1).bit_length())
        want = torch.fft.irfft(torch.fft.rfft(x.double(), n)
                               * torch.fft.rfft(k.double(), n), n)[..., :t]
        e = float((got.double() - want).abs().max() / want.abs().max())
        c = {"shape": [batch, t], "taps": tk, "n": n, "rel_err": e,
             "launches": counts}
        print("fft_conv " + json.dumps(c))
        check(e < TOL_CONV, f"fft_conv {c}")
        check(bool(torch.isfinite(got).all()), f"fft_conv {c}: non-finite")
        kernel = "rfft_leaf" if n // 2 <= kplan.MAX_LEAF else "matfft_cols"
        check_main_path(gpu, f"fft_conv n={n}", counts, kernel)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# phase 9: the N-D transforms


def nd_pass_launches(rows: int, n: int) -> list:
    """Kernel calls of a zero-copy matfft transform of (rows, n) rows:
    (wrapper, shape, major) per launch."""
    from repro_torch.kernels.fft import plan as kplan
    p = kplan.make_plan(n)
    check(p.levels <= 2, f"N-D pass length {n} is past one four-step")
    if p.levels == 1:
        return [("matfft", (rows, n), None)]
    return [option_key("matfft_cols", (rows, p.n1, p.n2), "row", {}),
            option_key("matfft_cols", (rows, p.n2, p.n1), "col", {})]


def nd_leading_launches(rows: int, shape, width) -> list:
    """Kernel calls of the earlier axes' passes over (rows, *width): one
    column-major K2 pass an axis up to MAX_LEAF, a transform of its
    columns as rows (between two transposes) above."""
    from repro_torch.kernels.fft import plan as kplan
    out = []
    for k in range(len(shape) - 2, -1, -1):
        b, L = rows * math.prod(shape[:k]), shape[k]
        c = math.prod(width[k + 1:])
        if L <= kplan.MAX_LEAF:
            out.append(option_key("matfft_cols", (b, L, c), "col", {}))
        else:
            out += nd_pass_launches(b * c, L)
    return out


def nd_launches(kind: str, batch, shape, inverse: bool = False) -> list:
    """Every kernel call of one N-D plan call, worked out from the shapes
    (the executors' structure, written out independently)."""
    rows = math.prod(batch)
    lead = rows * math.prod(shape[:-1])
    if kind == "c2c":
        return (nd_pass_launches(lead, shape[-1])
                + nd_leading_launches(rows, shape, shape))
    m = shape[-1] // 2
    half = (*shape[:-1], m)
    if inverse:
        return (nd_leading_launches(rows, shape, half)
                + nd_pass_launches(lead, m))
    from repro_torch.kernels.fft import plan as kplan
    first = ([("rfft_pack_leaf", (lead, shape[-1]), None)]
             if kplan.make_plan(m).levels == 1 else nd_pass_launches(lead, m))
    return first + nd_leading_launches(rows, shape, half)


def conv2d_pad(image, filt) -> tuple:
    """fft_conv2d's padded shape: the next powers of two >= h + kh and
    w + kw."""
    return tuple(1 << max(1, (a + b - 1).bit_length())
                 for a, b in zip(image, filt))


def conv2d_name(image) -> str:
    return f"fft_conv2d {image[0]}x{image[1]}"


def nd_runs(cfg) -> dict:
    """Phase 9's runs and the kernel calls each makes, forward and
    inverse: {run: {"launches": Counter((wrapper, shape, major))}}."""
    from collections import Counter
    c = cfg["nd"]
    (b2, s2), (b3, s3), (br, sr) = c["fft2"], c["fftn"], c["rfft2"]
    runs = {
        "fft2": nd_launches("c2c", b2, s2) * 2,  # forward and inverse
        "fftn": nd_launches("c2c", b3, s3),
        "rfft2": (nd_launches("r2c", br, sr)
                  + nd_launches("r2c", br, sr, inverse=True)),
    }
    for image, filt in c["conv2d"]:
        pad = conv2d_pad(image, filt)
        # the image's and the filter's forward, the product's inverse
        runs[conv2d_name(image)] = (nd_launches("r2c", (), pad) * 2
                                    + nd_launches("r2c", (), pad,
                                                  inverse=True))
    return {name: {"launches": Counter(calls)}
            for name, calls in runs.items()}


def nd_check_counts(gpu: bool, name: str, counts: dict, shapes,
                    want) -> None:
    """The calls the wrappers recorded, by shape, equal the expected calls;
    on the card every one launched its kernel and no plain version ran, in
    the rehearsal every one ran its plain version."""
    check(shapes == want, f"{name}: calls {sorted(shapes.items())}, "
          f"expected {sorted(want.items())}")
    if gpu:
        check(counts["plain"] == 0, f"{name}: a plain version ran")
    else:
        check(counts["plain"] == sum(want.values()),
              f"rehearsal {name}: {counts['plain']} plain calls, expected "
              f"{sum(want.values())}")


def nd_checks(torch, dev, gpu: bool, cfg) -> tuple[dict, dict]:
    """Phase 9: each N-D run once with the counts zeroed just before and
    read just after, checked against torch.fft, then its forward timed
    beside torch.fft's (CUDA events, ``reps`` calls); rfft2's untangle
    and re-entangle timed alone. Returns the summaries and each run's
    measured calls, {run: Counter((wrapper, shape, out_major))}."""
    import repro_torch.fft as tfft
    from repro_torch.core.spectral import fft_conv2d
    from repro_torch.fft import executors

    c = cfg["nd"]
    reps = c["reps"]
    expected = nd_runs(cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    out, measured = {}, {}

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def run_counted(name, fn):
        reset_counts()
        t0 = time.monotonic()
        y = fn()
        if gpu:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, shapes = read_counts(), read_shapes(gpu)
        measured[name] = shapes
        nd_check_counts(gpu, name, counts, shapes,
                        expected[name]["launches"])
        return y, counts, wall

    def times(fwd, lib):
        if not gpu:
            return {}
        return {"ms": timed_ms(torch, fwd, reps),
                "library_ms": timed_ms(torch, lib, reps)}

    def record(name, summary):
        summary["launched"] = [[key[0], list(key[1]), *key[2:], k]
                               for key, k in sorted(measured[name].items())]
        print(f"nd {name} " + json.dumps(summary))
        out[name] = summary

    # c2c fft2 and ifft2 over a batch of images; the copy layout bitwise
    batch, shape = c["fft2"]
    xr, xi = randn((*batch, *shape)), randn((*batch, *shape))
    p = tfft.plan(kind="c2c", shape=shape, batch_shape=batch, device=dev)

    def fft2_both():
        y = tfft.fft2(xr, xi, device=dev)
        return y, tfft.ifft2(*y, device=dev)

    (y, back), counts, wall = run_counted("fft2", fft2_both)
    xc = torch.complex(xr, xi)
    want = torch.fft.fft2(xc)
    err = rel_err(torch.complex(*y), want)
    err_back = rel_err(torch.complex(*back), xc)
    del want, back
    check(err < TOL, f"fft2: {err} vs torch.fft.fft2")
    check(err_back < TOL_ROUND, f"ifft2: {err_back} vs the input")
    reset_counts()
    cp = tfft.fft2(xr, xi, device=dev, layout="copy")
    copy_counts = read_counts()
    same = torch.equal(cp[0], y[0]) and torch.equal(cp[1], y[1])
    print(f"fft2 zero_copy vs copy: {'bitwise equal' if same else 'DIFFERENT'}")
    check(same, "fft2: zero_copy and copy differ")
    if gpu:  # the copy layout: K1 over the materialized transpose too
        check(copy_counts["matfft"] == 2 and copy_counts["matfft_cols"] == 0,
              f"fft2 copy layout: {copy_counts}")
    del cp, y
    record("fft2", {"batch": list(batch), "shape": list(shape),
                    "rel_err": err, "roundtrip_rel_err": err_back,
                    "copy_bitwise": same, "copy_launches": copy_counts,
                    "launches": counts,
                    "wall_s": wall, "hbm_bytes": p.hbm_bytes,
                    **times(lambda: p.execute(xr, xi),
                            lambda: torch.fft.fft2(xc))})
    del xr, xi, xc

    # c2c fftn over a volume
    batch, shape = c["fftn"]
    xr, xi = randn((*batch, *shape)), randn((*batch, *shape))
    p = tfft.plan(kind="c2c", shape=shape, batch_shape=batch, device=dev)
    y, counts, wall = run_counted("fftn", lambda: p.execute(xr, xi))
    xc = torch.complex(xr, xi)
    err = rel_err(torch.complex(*y), torch.fft.fftn(xc, dim=(-3, -2, -1)))
    check(err < TOL, f"fftn: {err} vs torch.fft.fftn")
    del y
    record("fftn", {"batch": list(batch), "shape": list(shape),
                    "rel_err": err, "launches": counts, "wall_s": wall,
                    "hbm_bytes": p.hbm_bytes,
                    **times(lambda: p.execute(xr, xi),
                            lambda: torch.fft.fftn(xc, dim=(-3, -2, -1)))})
    del xr, xi, xc

    # r2c rfft2 and irfft2 over real images
    batch, shape = c["rfft2"]
    x = randn((*batch, *shape))
    p = tfft.plan(kind="r2c", shape=shape, batch_shape=batch, device=dev)

    def rfft2_both():
        y = tfft.rfft2(x, device=dev)
        return y, tfft.irfft2(*y, device=dev)

    (y, back), counts, wall = run_counted("rfft2", rfft2_both)
    err = rel_err(torch.complex(*y), torch.fft.rfft2(x))
    err_back = rel_err(back, x)
    check(err < TOL, f"rfft2: {err} vs torch.fft.rfft2")
    check(bool(torch.isfinite(back).all()), "irfft2: non-finite")
    check(err_back < TOL_ROUND, f"irfft2: {err_back} vs the input")
    del back
    summary = {"batch": list(batch), "shape": list(shape), "rel_err": err,
               "roundtrip_rel_err": err_back, "launches": counts,
               "wall_s": wall, "hbm_bytes": p.hbm_bytes,
               **times(lambda: p.execute_real(x),
                       lambda: torch.fft.rfft2(x))}
    if gpu:  # the N-D untangle (forward) and re-entangle (inverse) alone
        n_last, nd_ = shape[-1], len(shape)
        zr, zi = randn(y[0].shape[:-1] + (n_last // 2,)), randn(
            y[0].shape[:-1] + (n_last // 2,))
        vr, vi = executors.rfft_twiddle(n_last, dev)
        summary["untangle_ms"] = timed_ms(
            torch, lambda: executors._untangle_nd(zr, zi, vr, vi, nd_), reps)
        summary["entangle_ms"] = timed_ms(
            torch, lambda: executors._entangle_nd(*y, n_last, nd_), reps)
        del zr, zi
    del y
    record("rfft2", summary)
    del x

    # fft_conv2d of a frame with a filter, against float64 torch.fft
    for image, filt in c["conv2d"]:
        name = conv2d_name(image)
        pad = conv2d_pad(image, filt)
        img, k = randn(image), randn(filt)
        got, counts, wall = run_counted(
            name, lambda: fft_conv2d(img, k, device=dev))
        want = torch.fft.irfft2(torch.fft.rfft2(img.double(), s=pad)
                                * torch.fft.rfft2(k.double(), s=pad),
                                s=pad)[:image[0], :image[1]]
        check(tuple(got.shape) == tuple(image), f"{name}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        err = float((got.double() - want).abs().max() / want.abs().max())
        check(err < TOL_CONV, f"{name}: {err} vs float64 torch.fft")
        del got, want
        record(name, {"image": list(image), "filter": list(filt),
                      "padded": list(pad), "rel_err": err,
                      "launches": counts, "wall_s": wall,
                      **times(lambda: fft_conv2d(img, k, device=dev),
                              lambda: torch.fft.irfft2(
                                  torch.fft.rfft2(img, s=pad)
                                  * torch.fft.rfft2(k, s=pad), s=pad))})
        del img, k
    if gpu:
        torch.cuda.empty_cache()
    return out, measured


# ---------------------------------------------------------------------------
# phase 10: the segmented and 1-D distributed placements on one rank


def pass_opts(key: tuple) -> dict:
    """Phase 3's options for a call of a zero-copy transform: K2's
    row-major pass of a four-step carries the outer twiddle, its
    column-major pass nothing; K1 no epilogue; K3 with the untangle."""
    kernel, _, major = key[:3]
    if kernel == "matfft":
        return {"period": None}
    if kernel == "matfft_cols":
        return {"out_major": major, "with_epilogue": major == "row"}
    return {"untangle": True}


def dist_runs(cfg) -> list:
    """Phase 10's distributed runs, (n, chunks, fuse_twiddle, layout):
    every overlap x fuse_twiddle x layout at ``n``, both overlaps unfused
    and zero-copy at ``n_level2``."""
    c = cfg["dist"]
    k = c["chunks"]
    return ([(c["n"], o, f, lay) for o in (None, k) for f in (False, True)
             for lay in ("zero_copy", "copy")]
            + [(c["n_level2"], o, False, "zero_copy") for o in (None, k)])


def dist_calls(n: int, chunks, fuse: bool, layout: str) -> list:
    """Every kernel call of one distributed forward on one rank, worked
    out from the plan (n = n1 * n2, k = chunks or 1), as (launch_shapes
    key, phase 3's options): pass 1 over k slabs of (n1, n2/k) columns,
    slab c's first row at c * n2/k, as K2 with a row-major store, or in
    the copy layout K1 over the transposed slab, the global twiddle in the
    store when fused and n1 is one leaf; past one leaf (zero_copy only)
    the level-1 transform of the slab's columns as rows. Pass 2 over (n2,
    n1): K2 col-major, whole or in k slabs of n1/k columns read in place;
    in the copy layout or past one leaf the slab's columns as rows."""
    from repro_torch.kernels.fft import plan as kplan
    n1, n2 = dist_split(n)
    k = chunks or 1
    leaf1 = kplan.make_plan(n1).levels == 1
    check(leaf1 or layout == "zero_copy",
          f"dist_calls: the copy layout past one leaf (n1={n1})")
    out = []
    for c in range(k):
        tw = {"global_twiddle": (n, c * n2 // k)} if fuse and leaf1 else {}
        if leaf1 and layout == "zero_copy":
            out.append((("matfft_cols", (1, n1, n2 // k), "row"),
                        {"out_major": "row", "with_epilogue": False, **tw}))
        elif leaf1:
            out.append((("matfft", (n2 // k, n1), None),
                        {"period": None, **tw}))
        else:
            out += [(key, pass_opts(key))
                    for key in nd_pass_launches(n2 // k, n1)]
    for j in range(k):
        if kplan.make_plan(n2).levels == 1 and layout == "zero_copy":
            opts = {"out_major": "col", "with_epilogue": False}
            if chunks:
                opts.update(col_offset=j * n1 // k, ncols=n1 // k)
            out.append((("matfft_cols", (1, n2, n1), "col"), opts))
        else:
            out += [(key, pass_opts(key))
                    for key in nd_pass_launches(n1 // k, n2)]
    return [(option_key(key[0], key[1], key[2], opts), opts)
            for key, opts in out]


def seg_calls(kind: str, segs: int, length: int) -> list:
    """The kernel calls of one segmented forward on one rank, as
    `dist_calls` gives them: the local plan's over this rank's rows."""
    from repro_torch.kernels.fft import plan as kplan
    if kind == "c2c":
        keys = nd_pass_launches(segs, length)
    elif kplan.make_plan(length // 2).levels == 1:
        keys = [("rfft_leaf", (segs, length), None)]
    else:
        keys = nd_pass_launches(segs, length // 2)
    return [(key, pass_opts(key)) for key in keys]


def dist_checks(torch, dev, gpu: bool, cfg) -> tuple[dict, dict]:
    """Phase 10: on the world-size-1 group of `one_rank_group`, a one-rank
    ("data",) mesh. The 1-D distributed
    four-step at ``n`` under every overlap x fuse_twiddle x layout and at
    ``n_level2`` under both overlaps; the segmented c2c and r2c batches.
    Each run once with the counts zeroed just before and read just after,
    its calls held to those worked out from the plan, its output within
    5e-6 of torch.fft; overlap == off, zero_copy == copy and segmented ==
    the local plan, bitwise; then each timed beside torch.fft (CUDA
    events, ``reps`` calls). Returns the summary and each run's measured
    calls."""
    from collections import Counter

    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.kernels.fft import matfft as km

    c = cfg["dist"]
    reps = c["reps"]
    gen = torch.Generator(device=dev).manual_seed(4)
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
    runs, measured = [], {}

    def counted(name, fn, want):
        reset_counts()
        y = fn()
        if gpu:
            torch.cuda.synchronize()
        counts, shapes = read_counts(), read_shapes(gpu)
        measured[name] = shapes
        nd_check_counts(gpu, name, counts, shapes, Counter(want))
        return y, counts

    def timed(fn, lib):
        if not gpu:
            return {}
        return {"ms": timed_ms(torch, fn, reps),
                "library_ms": timed_ms(torch, lib, reps)}

    try:
        for n in (c["n"], c["n_level2"]):
            matrix = [run[1:] for run in dist_runs(cfg) if run[0] == n]
            xr = torch.randn(n, generator=gen, device=dev)
            xi = torch.randn(n, generator=gen, device=dev)
            xc = torch.complex(xr, xi)
            want = torch.fft.fft(xc)
            outs = {}
            for chunks, fuse, layout in matrix:
                overlap = chunks or "off"
                name = f"distributed n={n} overlap={overlap} " \
                       f"fuse={fuse} {layout}"
                p = tfft.plan(kind="c2c", n=n, mesh=mesh,
                              placement="distributed", overlap=overlap,
                              fuse_twiddle=fuse, layout=layout)
                shard = (tfft.local_shard(xr, mesh),
                         tfft.local_shard(xi, mesh))
                y, counts = counted(name, lambda: p.execute(*shard),
                                    [key for key, _ in dist_calls(
                                        n, chunks, fuse, layout)])
                err = rel_err(torch.complex(*y), want)
                check(bool(torch.isfinite(y[0]).all()), f"{name}: "
                      f"non-finite")
                check(err < TOL, f"{name}: {err} vs torch.fft.fft")
                outs[chunks, fuse, layout] = y
                run = {"run": name, "n": n, "dist": [p.dist.n1, p.dist.n2,
                                                     p.dist.chunks],
                       "rel_err": err, "launches": counts,
                       "collective_bytes": p.collective_bytes,
                       "exposed_collective_bytes":
                           p.exposed_collective_bytes,
                       "hbm_bytes": p.hbm_bytes,
                       **timed(lambda: p.execute(*shard),
                               lambda: torch.fft.fft(xc))}
                if chunks is None and not fuse and layout == "zero_copy":
                    back = p.execute_inverse(*y)
                    run["roundtrip_rel_err"] = rel_err(torch.complex(*back),
                                                       xc)
                    check(run["roundtrip_rel_err"] < TOL_ROUND,
                          f"{name}: inverse {run['roundtrip_rel_err']}")
                    del back
                runs.append(run)
            # bitwise: overlap == off, zero_copy == copy
            same = {}
            for (chunks, fuse, layout), y in outs.items():
                for other in ((None, fuse, layout), (chunks, fuse,
                                                     "zero_copy")):
                    if other != (chunks, fuse, layout) and other in outs:
                        z = outs[other]
                        key = f"n={n} {(chunks, fuse, layout)} == {other}"
                        same[key] = (torch.equal(y[0], z[0])
                                     and torch.equal(y[1], z[1]))
                        check(same[key], f"distributed {key}: bits differ")
            print(f"distributed n={n}: {len(same)} bitwise pairs equal")
            runs.append({"run": f"bitwise n={n}", "pairs": same})
            del outs, want, xc, xr, xi

        # segmented: the batch split, each rank's rows by the local plan
        for kind, (segs, length) in (("c2c", c["seg_c2c"]),
                                     ("r2c", c["seg_r2c"])):
            name = f"segmented {kind} {segs} x {length}"
            p = tfft.plan(kind=kind, n=length, batch_shape=(segs,),
                          mesh=mesh, placement="segmented")
            local = tfft.plan(kind=kind, n=length, batch_shape=(segs,),
                              device=dev)
            if kind == "c2c":
                x = (torch.randn((segs, length), generator=gen, device=dev),
                     torch.randn((segs, length), generator=gen, device=dev))
                lib = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
                xc = torch.complex(*x)
                shard = tuple(tfft.local_shard(a, mesh) for a in x)
                fwd, fwd_local = p.execute, local.execute
            else:
                x = torch.randn((segs, length), generator=gen, device=dev)
                lib = lambda: torch.fft.rfft(x, dim=-1)  # noqa: E731
                shard = (tfft.local_shard(x, mesh),)
                fwd, fwd_local = p.execute_real, local.execute_real
            y, counts = counted(name, lambda: fwd(*shard),
                                [key for key, _ in seg_calls(kind, segs,
                                                             length)])
            err = rel_err(torch.complex(*y), lib())
            check(err < TOL, f"{name}: {err} vs torch.fft")
            z = fwd_local(*shard)
            same = torch.equal(y[0], z[0]) and torch.equal(y[1], z[1])
            check(same, f"{name}: differs from the local plan")
            runs.append({"run": name, "placement": p.placement,
                         "rel_err": err, "launches": counts,
                         "local_bitwise": same, "hbm_bytes": p.hbm_bytes,
                         **timed(lambda: fwd(*shard), lib)})
            del x, y, z, shard

        # the unfused pass 1's twiddle alone (torch ops), on the (n2, n1)
        # output of pass 1 at n
        n1, n2 = dist_split(c["n"])
        br, bi = (torch.randn((n2, n1), generator=gen, device=dev)
                  for _ in range(2))
        twiddle = {"shape": [n2, n1], "n_global": c["n"]}
        if gpu:
            twiddle["ms"] = timed_ms(
                torch, lambda: km.apply_global_twiddle(br, bi, c["n"], 0),
                reps)
        runs.append({"run": "unfused twiddle", **twiddle})
        del br, bi
    finally:
        tfft.invalidate_mesh(mesh)  # its plans hold the group
    if gpu:
        torch.cuda.empty_cache()
    return {"runs": runs}, measured


def variant_of(key: tuple) -> str:
    """The kernel variant a `launch_shapes` key's call ran."""
    wrapper, shape = key[0], key[1]
    if wrapper == "stockham":
        return "stockham"
    if wrapper in ("rfft_leaf", "rfft_pack_leaf"):
        return "rfft/direct" if shape[1] // 2 <= 256 else "rfft/four_step"
    return wrapper + ("/direct" if shape[1] <= 256 else "/four_step")


# ---------------------------------------------------------------------------
# phase 11: the 2-D/3-D pencils and fallback="degrade" on one rank


def calls_as_cases(calls, names: dict) -> list:
    """Phase 3 cases for kernel calls given as (`launch_shapes` key,
    options), each once, drawn on the device; a key in ``names`` timed
    under its name there."""
    out, seen = [], set()
    for key, opts in calls:
        wrapper, shape = key[0], key[1]
        kernel = "rfft" if wrapper.startswith("rfft") else wrapper
        frozen = (kernel, tuple(shape), tuple(sorted(opts.items())))
        if frozen in seen:
            continue
        seen.add(frozen)
        out.append((variant_of(key), kernel, shape, {**opts, "dist": True},
                    names.get(key, False)))
    return out


def shape_case_name(key: tuple) -> str:
    """A timed shape's name in the `kernels` line: "<variant> <shape>[
    <major>]", as phase 9 names its shapes."""
    return f"{variant_of(key)} {tuple(key[1])}" + (
        f" {key[2]}" if key[2] else "")


def pencil_calls(kind: str, shape, chunks) -> list:
    """Every kernel call of one pencil forward on one rank, worked out from
    the shape (the executors' structure, written out independently), as
    (`launch_shapes` key, phase 3's options): the contiguous pass (c2c:
    the batched 1-D transform; r2c: K3's packed leaf, or the c2c path at
    the half length past one leaf), then axis k = nd-2 .. 0 of the (half
    width) volume: one column-major K2 pass up to MAX_LEAF, the transform
    of its columns as rows above; with ``chunks``, k slabs of the axis's
    columns each, a K2 slab read in place or the slab's columns sliced."""
    from repro_torch.kernels.fft import plan as kplan
    lead = math.prod(shape[:-1])
    if kind == "c2c":
        width = tuple(shape)
        first = nd_pass_launches(lead, shape[-1])
    else:
        m = shape[-1] // 2
        width = (*shape[:-1], m)
        first = ([("rfft_pack_leaf", (lead, shape[-1]), None)]
                 if kplan.make_plan(m).levels == 1
                 else nd_pass_launches(lead, m))
    out = [(key, {"untangle": False} if key[0] == "rfft_pack_leaf"
            else pass_opts(key)) for key in first]
    k = chunks or 1
    for a in range(len(shape) - 2, -1, -1):
        B, L = math.prod(width[:a]), width[a]
        C = math.prod(width[a + 1:])
        nc = C // k
        for c in range(k):
            if L <= kplan.MAX_LEAF:
                opts = {"out_major": "col", "with_epilogue": False}
                if chunks:
                    opts.update(col_offset=c * nc, ncols=nc)
                out.append((("matfft_cols", (B, L, C), "col"), opts))
            else:
                out += [(key, pass_opts(key))
                        for key in nd_pass_launches(B * nc, L)]
    return [(option_key(key[0], key[1], key[2], opts), opts)
            for key, opts in out]


def pencil_runs(cfg) -> list:
    """Phase 11's runs: (kind, shape, mesh dims, chunks or None)."""
    c = cfg["pencil"]
    return [(kind, shape, dims, chunks) for kind, shape, dims in c["cases"]
            for chunks in (None, c["chunks"])]


def pencil_timed(cfg) -> frozenset:
    """The pencils' whole-pass kernel shapes that phase 9 does not time."""
    nd = {key for run in nd_runs(cfg).values() for key in run["launches"]}
    return frozenset(key for kind, shape, _, chunks in pencil_runs(cfg)
                     if chunks is None
                     for key, _ in pencil_calls(kind, shape, None)
                     if key not in nd)


def pencil_kernel_cases(cfg) -> list:
    calls = [call for kind, shape, _, chunks in pencil_runs(cfg)
             for call in pencil_calls(kind, shape, chunks)]
    return calls_as_cases(calls, {key: shape_case_name(key)
                                  for key in pencil_timed(cfg)})


def one_rank_group(torch, gpu: bool):
    """A world-size-1 group (NCCL on the card, gloo in the rehearsal)
    from a FileStore under build/; returns the store's path."""
    import datetime

    import torch.distributed as dist
    store = ROOT / "build" / "dist_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl" if gpu else "gloo",
                            store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    return store


def pencil_checks(torch, dev, gpu: bool, cfg) -> tuple[dict, dict]:
    """Phase 11, on phase 10's world-size-1 group: each pencil over a
    (1,) ("data",) mesh (2-D) or a (1, 1) ("data", "model") mesh (3-D),
    under overlap "off" and `chunks`, once with the counts zeroed just
    before and read just after, its calls held to `pencil_calls`; bitwise
    equal to the local plan (fftn/rfftn) at the same shape, within 5e-6
    of torch.fft.fftn/rfftn, timed beside it. Then one rank lost:
    ``fallback="degrade"`` returns the local plan, with one
    plan_downgrade, the mesh's plans dropped and the same bits; without a
    loss it logs none. Returns the summary and each run's calls."""
    from collections import Counter

    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.core.fft.distributed import pencil_shard
    from repro_torch.core.resilience import (clear_events, events,
                                             meshstate)
    from repro_torch.fft import planner

    c = cfg["pencil"]
    reps = c["reps"]
    gen = torch.Generator(device=dev).manual_seed(5)
    meshes = {(1,): init_device_mesh(dev.type, (1,),
                                     mesh_dim_names=("data",)),
              (1, 1): init_device_mesh(dev.type, (1, 1),
                                       mesh_dim_names=("data", "model"))}
    runs, measured = [], {}
    try:
        for kind, shape, dims in c["cases"]:
            mesh = meshes[dims]
            if kind == "c2c":
                x = (torch.randn(shape, generator=gen, device=dev),
                     torch.randn(shape, generator=gen, device=dev))
                xc = torch.complex(*x)
                lib = lambda: torch.fft.fftn(xc)  # noqa: E731
            else:
                x = (torch.randn(shape, generator=gen, device=dev),)
                lib = lambda: torch.fft.rfftn(x[0])  # noqa: E731
            local = tfft.plan(kind=kind, shape=shape, device=dev)
            fwd_local = local.execute if kind == "c2c" else local.execute_real
            want = fwd_local(*x)
            y_lib = lib()
            outs = {}
            for chunks in (None, c["chunks"]):
                overlap = chunks or "off"
                name = f"pencil {kind} {shape} overlap={overlap}"
                p = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                              placement="distributed", overlap=overlap)
                shard = tuple(pencil_shard(a, mesh) for a in x)
                fwd = p.execute if kind == "c2c" else p.execute_real
                reset_counts()
                y = fwd(*shard)
                if gpu:
                    torch.cuda.synchronize()
                counts, shapes = read_counts(), read_shapes(gpu)
                measured[name] = shapes
                nd_check_counts(gpu, name, counts, shapes, Counter(
                    key for key, _ in pencil_calls(kind, shape, chunks)))
                check(bool(torch.isfinite(y[0]).all()), f"{name}: "
                      f"non-finite")
                err = rel_err(torch.complex(*y), y_lib)
                check(err < TOL, f"{name}: {err} vs torch.fft")
                same = torch.equal(y[0], want[0]) and torch.equal(y[1],
                                                                  want[1])
                check(same, f"{name}: differs from the local plan")
                outs[chunks] = y
                run = {"run": name, "grid": list(p.dist.grid),
                       "chunks": p.dist.chunks,
                       "fast_r2c_pencil": p._fast_r2c_pencil,
                       "rel_err": err, "local_bitwise": same,
                       "launches": counts,
                       "collective_bytes": p.collective_bytes,
                       "per_leg_collective_bytes":
                           list(p.per_leg_collective_bytes),
                       "hbm_bytes": p.hbm_bytes}
                if gpu:
                    run.update(ms=timed_ms(torch, lambda: fwd(*shard), reps),
                               library_ms=timed_ms(torch, lib, reps),
                               local_ms=timed_ms(torch,
                                                 lambda: fwd_local(*x),
                                                 reps))
                print("pencil " + json.dumps(run))
                runs.append(run)
            del outs, want, y_lib, x, y
            if kind == "c2c":
                del xc
            if gpu:
                torch.cuda.empty_cache()

        # degrade: one rank lost, then none
        kind, shape, dims = c["cases"][0]
        mesh = meshes[dims]
        x = (torch.randn(shape, generator=gen, device=dev),
             torch.randn(shape, generator=gen, device=dev))
        p = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                      placement="distributed", overlap="off")
        y = p.execute(*x)
        clear_events()
        q = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                      placement="distributed", overlap="off",
                      fallback="degrade")
        check(q is p and not events("plan_downgrade"),
              "degrade without a loss changed the plan")
        cached = sum(1 for k in planner._PLAN_CACHE if k[1] == mesh)
        meshstate.lose_devices([0])
        try:
            d = tfft.plan(kind=kind, shape=shape, mesh=mesh,
                          placement="distributed", overlap="off",
                          fallback="degrade")
        finally:
            meshstate.restore_devices()
        ev = events("plan_downgrade")
        left = sum(1 for k in planner._PLAN_CACHE if k[1] == mesh)
        z = d.execute(*x)
        same = torch.equal(y[0], z[0]) and torch.equal(y[1], z[1])
        degrade = {"run": "degrade", "placement": d.placement,
                   "events": [{k: e[k] for k in (
                       "reason", "requested_placement", "resolved_placement",
                       "from_devices", "to_devices", "plans_invalidated")}
                       for e in ev],
                   "cached_before": cached, "cached_after": left,
                   "bitwise": same}
        print("pencil " + json.dumps(degrade))
        check(d.placement == "local" and d.mesh is None,
              f"degrade: {d.placement}")
        check(len(ev) == 1 and ev[0]["reason"] == "mesh_degraded",
              f"degrade: events {ev}")
        check(cached >= 1 and left == 0 and ev[0]["plans_invalidated"]
              == cached, f"degrade: {cached} cached, {left} left")
        check(same, "degrade: the local plan differs from the pencil")
        runs.append(degrade)
        del x, y, z
    finally:
        for mesh in meshes.values():
            tfft.invalidate_mesh(mesh)  # its plans hold the group
    if gpu:
        torch.cuda.empty_cache()
    return {"runs": runs}, measured


# ---------------------------------------------------------------------------
# phase 12: the service


def serve_mixes(cfg) -> dict:
    """The request mixes of phase 12: (impls, verify modes, shapes)."""
    from repro_torch.serve import loadgen
    c = cfg["serve"]
    paper = tuple(loadgen.RequestShape(*r) for r in c["paper_mix"])
    return {"storm": (("matfft", "stockham"), ("off",), loadgen.DEFAULT_MIX),
            "paper": (("matfft",), ("off", "abft"), paper)}


def serve_calls(cfg) -> list:
    """Every kernel call the service can launch in phase 12, as
    (`launch_shapes` key, phase 3's options): for each request shape, the
    two launch sizes of the 2-plan trick (its own rows, and coalesce x
    rows), each with the checksum row under verify "abft"."""
    from repro_torch.kernels.fft import plan as kplan
    calls = []
    for impls, modes, mix in serve_mixes(cfg).values():
        for impl in impls:
            for shape in mix:
                for total in {shape.rows, cfg["serve"]["coalesce"]
                              * shape.rows}:
                    for extra in {0 if m == "off" else 1 for m in modes}:
                        rows = total + extra
                        if impl == "stockham":
                            check(shape.n <= kplan.MAX_LEAF, "serve_calls: "
                                  "stockham past one leaf")
                            calls.append((("stockham", (rows, shape.n),
                                           None), {}))
                        elif shape.kind == "c2c":
                            calls += [(key, pass_opts(key)) for key in
                                      nd_pass_launches(rows, shape.n)]
                        elif kplan.make_plan(shape.n // 2).levels == 1:
                            key = ("rfft_leaf", (rows, shape.n), None)
                            calls.append((key, pass_opts(key)))
                        else:
                            calls += [(key, pass_opts(key)) for key in
                                      nd_pass_launches(rows, shape.n // 2)]
    return calls


def serve_timed(cfg) -> frozenset:
    """The paper mix's full batches, timed in phase 3."""
    c = cfg["serve"]
    _, _, paper = serve_mixes(cfg)["paper"]
    keys = set()
    for shape in paper:
        rows = c["coalesce"] * shape.rows
        if shape.kind == "c2c":
            keys.update(nd_pass_launches(rows, shape.n))
        else:
            keys.add(("rfft_leaf", (rows, shape.n), None))
    return frozenset(keys)


def serve_kernel_cases(cfg) -> list:
    return calls_as_cases(serve_calls(cfg), {key: shape_case_name(key)
                                             for key in serve_timed(cfg)})


def serve_checks(torch, dev, gpu: bool, cfg) -> tuple[dict, dict]:
    """Phase 12: the service (`repro_torch.serve`) on the card.

    1. The JAX package's serve gate (benchmarks/bench_serve.py's storm):
       an open-loop flood through a seeded 25 % fault storm over the
       three serve sites, impl "matfft" and again "stockham": every
       request ``ok`` and bitwise equal to `loadgen.oracle` at its launch
       size, or a classified structured error; drained to idle.
    2. Paper-scale traffic, no faults, verify "off" and "abft": every
       request ``ok``, bitwise equal to the oracle and within 5e-6 of
       torch.fft; qps, latency percentiles, batches, padded rows, plan
       cache entries; no spec key on more than 2 plans (4 with abft).
    3. Device loss under load, on a one-rank mesh of phase 10's group:
       ``lose_devices([0])`` mid-run, at least one service_degrade with
       action "replan_fallback_degrade", every request ``ok`` and
       bitwise equal to the oracle.
    4. `python -m repro_torch.launch.fft_serve` under a 25 % storm as a
       subprocess: exit 0, drained, no silent drop.

    Each in-process run with the counts zeroed just before and read just
    after: a fault-free run fails on any outcome but ``ok`` (the retry
    path would turn a kernel failure into classified errors), and no
    plain version may run on the card. Returns the summary and each
    run's calls."""
    import os
    import threading
    from collections import Counter

    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                             RetryPolicy, clear_events,
                                             events, meshstate)
    from repro_torch.serve import FftService, loadgen

    c = cfg["serve"]
    device = "cuda" if gpu else "cpu"
    mixes = serve_mixes(cfg)
    out, measured = [], {}
    sites = ("serve.admit", "serve.batch", "serve.execute")
    classified = {"ok", "queue_full", "rate_limit", "inflight_cap",
                  "admit_fault", "closed", "shed", "deadline", "failed"}

    def counted(name, fn):
        reset_counts()
        t0 = time.monotonic()
        result = fn()
        wall = time.monotonic() - t0
        counts, shapes = read_counts(), read_shapes(gpu)
        measured[name] = shapes
        if gpu:
            check(counts["plain"] == 0, f"{name}: a plain version ran")
        return result, counts, wall

    def oracle_check(name, seed, records, outcomes, impl, lib_check):
        """Every ``ok`` bitwise equal to the oracle at its launch size
        (and within TOL of torch.fft where ``lib_check``)."""
        worst = 0.0
        for rec in records:
            if outcomes[rec.rid] != "ok":
                continue
            ops = loadgen.request_operands(seed, rec.rid, rec.shape)
            want = loadgen.oracle(rec.shape, ops, impl=impl,
                                  batch_rows=rec.ticket.batch_rows,
                                  device=device)
            check(loadgen.bitwise_equal(rec.ticket.value, want),
                  f"{name}: request {rec.rid} differs from its oracle")
            if lib_check:
                got = torch.complex(*(torch.from_numpy(a).to(dev)
                                      for a in rec.ticket.value))
                x = [torch.from_numpy(a).to(dev) for a in ops]
                lib = (torch.fft.fft(torch.complex(*x), dim=-1)
                       if rec.shape.kind == "c2c"
                       else torch.fft.rfft(x[0], dim=-1))
                worst = max(worst, rel_err(got, lib))
        check(worst < TOL, f"{name}: {worst} vs torch.fft")
        return worst

    def buckets_of(counts: dict) -> dict:
        """Outcome counts, the ok bucket as "ok_requests": the last line
        alone may say "ok" (tests/test_torch_pipeline.py)."""
        return {("ok_requests" if k == "ok" else k): v
                for k, v in sorted(counts.items())}

    def summary(name, service, records, outcomes, wall, counts, extra):
        buckets = Counter(outcomes.values())
        stats = service.stats.snapshot()
        doc = {"run": name, "requests": len(records), "wall_s": wall,
               "qps_completed": buckets.get("ok", 0) / wall,
               "outcomes": buckets_of(buckets),
               "drained_idle": service.idle(),
               "latency": stats["latency"], "batches": stats["batches"],
               "padded_rows": stats["padded_rows"],
               "retries": stats["retries"],
               "mean_requests_per_launch":
                   stats.get("mean_requests_per_launch"),
               "plan_cache": tfft.cache_info(), "launches": counts, **extra}
        print("serve " + json.dumps(doc))
        out.append(doc)
        return doc

    # 1. the serve gate
    impls, _, mix = mixes["storm"]
    n_req = c["storm_requests"]
    for impl in impls:
        name = f"storm impl={impl}"
        tfft.clear_plan_cache()
        clear_events()
        injector = FaultInjector(FaultPlan.random(c["seed"], n_req,
                                                  sites=sites,
                                                  rate=c["rate"]))
        service = FftService(
            impl=impl, device=device, coalesce=c["coalesce"],
            queue_depth=c["queue_depth"], max_inflight=c["max_inflight"],
            injector=injector,
            retry=RetryPolicy(max_attempts=c["max_attempts"],
                              base_delay_s=0.0))

        def storm():
            records = loadgen.drive(service, num_requests=n_req,
                                    clients=c["clients"], seed=c["seed"],
                                    mix=mix)
            outcomes = {r.rid: loadgen.classify(r) for r in records}
            service.close(drain=True)
            return records, outcomes

        (records, outcomes), counts, wall = counted(name, storm)
        bad = sorted(set(outcomes.values()) - classified)
        check(not bad, f"{name}: unclassified outcomes {bad}")
        check(len(records) == n_req and service.idle(),
              f"{name}: not drained")
        check("ok" in outcomes.values(), f"{name}: nothing ok")
        oracle_check(name, c["seed"], records, outcomes, impl, False)
        summary(name, service, records, outcomes, wall, counts,
                {"faults": injector.summary()["fired_by_site"],
                 "degrade_events": len(events("service_degrade"))})

    # 2. paper-scale traffic, fault-free
    impls, modes, mix = mixes["paper"]
    n_req = c["paper_requests"]
    for verify in modes:
        name = f"paper verify={verify}"
        tfft.clear_plan_cache()
        service = FftService(impl="matfft", device=device,
                             coalesce=c["coalesce"],
                             queue_depth=max(n_req, 1),
                             verify=verify)

        def flood():
            t0 = time.monotonic()
            records = loadgen.drive(service, num_requests=n_req,
                                    clients=c["clients"], seed=c["seed"],
                                    mix=mix)
            submit_s = time.monotonic() - t0
            outcomes = {r.rid: loadgen.classify(r) for r in records}
            service.close(drain=True)
            return records, outcomes, submit_s

        (records, outcomes, submit_s), counts, wall = counted(name, flood)
        check(set(outcomes.values()) == {"ok"},
              f"{name}: outcomes {Counter(outcomes.values())}")
        entries = tfft.cache_info()["entries"]
        worst = oracle_check(name, c["seed"], records, outcomes, "matfft",
                             True)
        check(entries <= len(mix) * (2 if verify == "off" else 4),
              f"{name}: {entries} plans for {len(mix)} keys")
        summary(name, service, records, outcomes, wall, counts,
                {"verify": verify, "plans": entries, "submit_s": submit_s,
                 "rel_err_torch_fft": worst,
                 "mib_per_request": [4 * 2 * r.rows * r.n / 2 ** 20 if
                                     r.kind == "c2c" else
                                     4 * r.rows * r.n / 2 ** 20
                                     for r in mix]})

    # 3. device loss under load, on a one-rank mesh
    name = "device loss"
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
    tfft.clear_plan_cache()
    clear_events()
    n_req = c["loss_requests"]
    _, _, mix = mixes["storm"]
    service = FftService(impl="matfft", device=device, mesh=mesh,
                         placement="auto", coalesce=c["coalesce"],
                         queue_depth=max(n_req, 1))
    lost_at = {}

    def lose_mid_run():
        while service.stats.submitted < n_req // 3:
            time.sleep(0.001)
        lost_at["t"] = time.monotonic()
        meshstate.lose_devices([0])

    def under_loss():
        killer = threading.Thread(target=lose_mid_run, daemon=True)
        killer.start()
        records = loadgen.drive(service, num_requests=n_req,
                                clients=c["clients"], seed=c["seed"] + 1,
                                mix=mix, qps=2000.0)
        killer.join()
        outcomes = {r.rid: loadgen.classify(r) for r in records}
        service.close(drain=True)
        return records, outcomes

    try:
        (records, outcomes), counts, wall = counted(name, under_loss)
    finally:
        meshstate.restore_devices()
        tfft.invalidate_mesh(mesh)
    check(set(outcomes.values()) == {"ok"},
          f"{name}: outcomes {Counter(outcomes.values())}")
    ev = [e for e in events("service_degrade")
          if e["reason"] == "device_loss"]
    check(any(e["action"] == "replan_fallback_degrade" for e in ev),
          f"{name}: no service_degrade event")
    after = sum(1 for r in records if r.t_submit > lost_at["t"])
    check(after > 0, f"{name}: no request after the loss")
    oracle_check(name, c["seed"] + 1, records, outcomes, "matfft", False)
    summary(name, service, records, outcomes, wall, counts,
            {"requests_after_loss": after, "service_degrade": ev[:1],
             "plan_downgrades": len(events("plan_downgrade"))})

    # 4. the launcher, as a user runs it
    name = "fft_serve"
    spec = f"seed=7,rate={c['rate']},sites=" + "+".join(sites)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fft_serve", "--impl",
         "matfft", "--requests", str(c["cli_requests"]), "--faults", spec,
         "--device", device],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t0
    check(proc.returncode == 0, f"{name}: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    check(report["drained_idle"], f"{name}: not drained")
    check(set(report["outcomes"]) <= classified,
          f"{name}: outcomes {report['outcomes']}")
    doc = {"run": name, "wall_s": wall, "requests": report["requests"],
           "outcomes": buckets_of(report["outcomes"]),
           "qps_completed": report["qps_completed"],
           "latency": report["service"]["latency"],
           "drained_idle": report["drained_idle"]}
    print("serve " + json.dumps(doc))
    out.append(doc)
    return {"runs": out}, measured

# ---------------------------------------------------------------------------
# phase 13: the measuring autotuner


def tune_specs(cfg) -> list:
    """(name, plan arguments) of the tuner phase: the block job's spec, the
    service's paper mix, fft2 over the N-D phase's images, and on the
    one-rank mesh ("mesh": True) the 1-D distributed four-step, the
    segmented c2c batch of phase 10 and the first pencil of phase 11."""
    rows, n = cfg["tune"]["block"]
    specs = [("block_job", dict(kind="c2c", n=n, batch_shape=(rows,)))]
    specs += [(f"serve {kind} {n} x {rows}",
               dict(kind=kind, n=n, batch_shape=(rows,)))
              for kind, n, rows in cfg["serve"]["paper_mix"]]
    batch, shape = cfg["nd"]["fft2"]
    specs.append(("fft2", dict(kind="c2c", shape=shape, batch_shape=batch)))
    specs.append(("distributed", dict(kind="c2c", n=cfg["dist"]["n"],
                                      placement="distributed", mesh=True)))
    segs, length = cfg["dist"]["seg_c2c"]
    specs.append(("segmented", dict(kind="c2c", n=length,
                                    batch_shape=(segs,),
                                    placement="segmented", mesh=True)))
    kind, shape, _ = cfg["pencil"]["cases"][0]
    specs.append(("pencil", dict(kind=kind, shape=shape,
                                 placement="distributed", mesh=True)))
    return specs


def key_opts(key: tuple) -> dict:
    """Phase 3's options for a recorded call with no global twiddle
    (`pass_opts`; K3 packed or not by its wrapper), with its column slab
    (at offset 0: the same kernel at the same shape)."""
    opts = pass_opts(key)
    if key[0] == "rfft_pack_leaf":
        opts = {"untangle": False}
    tags = key[3] if len(key) > 3 else ()
    check("twiddle" not in tags, f"key_opts: a twiddle call {key}")
    if "slab" in tags:
        opts.update(col_offset=0, ncols=tags[tags.index("slab") + 1])
    return opts


def fft_want(torch, kind: str, shape, ops):
    """torch.fft of a plan's operand: the trailing ``len(shape)`` axes."""
    dims = tuple(range(-len(shape), 0))
    if kind == "r2c":
        return torch.fft.rfftn(ops[0], dim=dims)
    return torch.fft.fftn(torch.complex(*ops), dim=dims)


def tuner_checks(torch, dev, gpu: bool, cfg, work: Path):
    """Phase 13, on phase 10's world-size-1 group.

    1. ``plan(tune=True, wisdom_path=...)`` for each of `tune_specs`: the
       candidates (measured and modeled ms), the winner and any
       disagreement printed; the same call again a wisdom hit with no
       measurement (the same plan); at the full shape the tuned plan's
       output bitwise equal to the default plan's and within 5e-6 of
       torch.fft, its launches read (a kernel launched, no plain version),
       and the tuned and default plans timed in turns (default, tuned,
       tuned, default).
    2. ``tune_out_of_core`` at phase 6's at-scale size and budget.
    3. ``fft_job --tune --wisdom-path`` twice as subprocesses (the serial
       job of phase 5's configuration): the first measures, the second
       measures nothing and hits the wisdom, with the same merged bytes,
       each block within 5e-6 of torch.fft.
    4. ``python -m repro_torch.fft.selftest`` as a subprocess: exit 0.

    Every call the tuned plans made at a shape phase 3 did not check is
    checked here (`run_cases`). Returns (summary, launches by run, the
    keys checked here, timing).
    """
    import os

    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.fft as tfft
    from repro_torch.fft import tuner
    from repro_torch.kernels.fft import plan as kplan

    device = "cuda" if gpu else "cpu"
    work.mkdir(parents=True, exist_ok=True)
    mesh = init_device_mesh(device, (1,), mesh_dim_names=("data",))
    wp = str(work / "wisdom.json")
    gen = torch.Generator(device=dev).manual_seed(6)
    reps = cfg["tune"]["reps"]
    covered = {case_key(k, s, o) for _, k, s, o, _
               in kernel_cases(cfg, kplan.MAX_LEAF)}
    runs, measured, calls = [], {}, []

    def sync():
        if gpu:
            torch.cuda.synchronize()

    for name, kw in tune_specs(cfg):
        kw = dict(kw)
        if kw.pop("mesh", False):
            kw["mesh"] = mesh
        else:
            kw["device"] = device
        tuner.reset_tune_stats()
        t0 = time.monotonic()
        tuned = tfft.plan(**kw, tune=True, wisdom_path=wp)
        tune_s = time.monotonic() - t0
        first = tuner.tune_stats()
        check(first["measurements"] >= 1 and first["wisdom_hits"] == 0,
              f"tune {name}: {first}")
        again = tfft.plan(**kw, tune=True, wisdom_path=wp)
        second = tuner.tune_stats()
        check(again is tuned and second["wisdom_hits"] == 1
              and second["measurements"] == first["measurements"],
              f"tune {name}: the second plan measured: {second}")
        entry = tuner.WisdomStore.get(wp).lookup(
            tuner.wisdom_key(tuned.spec, kw.get("mesh")))
        default = tfft.plan(**kw)
        s = tuned.spec
        ops = tuple(torch.randn(tuned.operand_shape, generator=gen,
                                device=dev)
                    for _ in range(1 if s.kind == "r2c" else 2))
        fn = "execute_real" if s.kind == "r2c" else "execute"
        reset_counts()
        y = getattr(tuned, fn)(*ops)
        sync()
        counts = read_counts()
        shapes = read_shapes(gpu)
        if gpu:
            check(sum(v for k, v in counts.items() if k != "plain") > 0,
                  f"tune {name}: no kernel launched")
            check(counts["plain"] == 0,
                  f"tune {name}: a plain version ran")
        y0 = getattr(default, fn)(*ops)
        bitwise = all(torch.equal(a, b) for a, b in zip(y, y0))
        check(bitwise, f"tune {name}: tuned and default plans differ")
        want = fft_want(torch, s.kind, s.shape, ops)
        err = rel_err(torch.complex(*y), want)
        check(err < TOL, f"tune {name}: {err} vs torch.fft")
        del y, y0, want
        t_default, t_tuned = [float("nan")], [float("nan")]
        if gpu:  # default, tuned, tuned, default: one card, one call
            t_default = [timed_ms(
                torch, lambda: getattr(default, fn)(*ops), reps)]
            t_tuned = [timed_ms(torch, lambda: getattr(tuned, fn)(*ops),
                                reps) for _ in range(2)]
            t_default.append(timed_ms(
                torch, lambda: getattr(default, fn)(*ops), reps))
        del ops
        winner = {"layout": s.layout, "overlap": s.overlap}
        doc = {"run": name, "shape": list(s.shape),
               "batch_shape": list(s.batch_shape), "winner": winner,
               "disagreement": entry["disagreement"],
               "meas_shape": entry["meas_shape"],
               "meas_batch": entry["meas_batch"],
               "candidates": [
                   {**c["knobs"], "measured_ms": c["measured_s"] * 1e3,
                    "modeled_ms": c["modeled_s"] * 1e3}
                   for c in entry["candidates"]],
               "tune_s": tune_s, "measurements": first["measurements"],
               "bitwise_default": bitwise, "rel_err_torch_fft": err,
               "tuned_ms": min(t_tuned), "tuned_ms_runs": t_tuned,
               "default_ms": min(t_default), "default_ms_runs": t_default,
               "launches": {repr(k): v for k, v in shapes.items()}}
        print("tune " + json.dumps(doc))
        runs.append(doc)
        measured[f"tune {name}"] = shapes
        if s.placement == "distributed" and s.ndim == 1:
            run_calls = dist_calls(s.n, None if s.overlap == "off"
                                   else s.overlap, s.fuse_twiddle, s.layout)
        else:
            run_calls = [(key, key_opts(key)) for key in shapes]
        calls += [(key, opts) for key, opts in run_calls
                  if key not in covered]
        if gpu:
            torch.cuda.empty_cache()

    # 2. the out-of-core panel height at phase 6's at-scale size
    c = cfg["ooc"]
    n, budget = 1 << c["log2_n"], c["budget_mb"] << 20
    block_bytes = min(tfft.factor_out_of_core(n, budget).pass1_panel_bytes,
                      1 << 22)
    scale, rep = tuner.tune_out_of_core(n, budget, impl="matfft",
                                        block_bytes=block_bytes,
                                        wisdom_path=wp, device=device)
    again, rep2 = tuner.tune_out_of_core(n, budget, impl="matfft",
                                         block_bytes=block_bytes,
                                         wisdom_path=wp, device=device)
    check(scale in tuner.OOC_PANEL_SCALES and again == scale
          and rep2.wisdom_hit and rep2.measurements == 0,
          f"tune_out_of_core: {scale}, {again}, {rep2}")
    doc = {"run": "out_of_core", "n": n, "budget_bytes": budget,
           "block_bytes": block_bytes, "winner": rep.winner,
           "disagreement": rep.disagreement,
           "candidates": [{**c["knobs"], "measured_s": c["measured_s"],
                           "modeled_s": c["modeled_s"]}
                          for c in rep.candidates]}
    print("tune " + json.dumps(doc))
    runs.append(doc)

    # 3. fft_job --tune, twice, as a user runs it
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    job_wp = str(work / "wisdom_job.json")
    jobs = []
    for i in range(2):
        job_work = work / f"job{i}"
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fft_job",
             *cfg["serial"], "--tune", "--wisdom-path", job_wp, "--device",
             device, "--work-dir", str(job_work)], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"fft_job --tune run {i}: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        report = json.loads(proc.stdout)
        jobs.append({"wall_s": time.monotonic() - t0,
                     "job_s": report["job_s"], "tuner": report["tuner"],
                     "plan_cache": report["plan_cache"],
                     "merged_bytes": report["merged_bytes"]})
    first, second = (j["tuner"] for j in jobs)
    check(first["measurements"] > 0, f"fft_job --tune: {first}")
    check(second["measurements"] == 0 and second["wisdom_hits"] >= 1,
          f"fft_job --tune again: {second}")
    merged = [(work / f"job{i}" / "merged.bin").read_bytes()
              for i in range(2)]
    check(merged[0] == merged[1], "fft_job --tune: the runs' outputs differ")
    fft_len = int(cfg["serial"][cfg["serial"].index("--fft-len") + 1])
    worst = check_job_output(torch, dev, work / "job1", fft_len)
    doc = {"run": "fft_job --tune", "args": cfg["serial"], "jobs": jobs,
           "same_merged_bytes": True, "worst_block_rel_err": worst}
    print("tune " + json.dumps(doc))
    runs.append(doc)
    del merged

    # 4. the facade selftest
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.fft.selftest", "--device",
         device], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    print(proc.stdout.strip())
    check(proc.returncode == 0, f"selftest: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    runs.append({"run": "selftest", "wall_s": time.monotonic() - t0,
                 "cases": sum(1 for ln in proc.stdout.splitlines()
                              if " OK " in ln)})

    # the one exchange a card has: all_to_all_single of 256 MiB on the
    # one-rank group (a copy on the card), for the model's ici rate
    a2a_bps = float("nan")
    if gpu:
        import torch.distributed as dist
        send = torch.empty(64 << 20, device=dev)
        recv = torch.empty_like(send)
        a2a_bps = send.nbytes / (timed_ms(
            torch, lambda: dist.all_to_all_single(recv, send), reps) * 1e-3)
        del send, recv
    runs.append({"run": "all_to_all_single 256 MiB", "bytes_s": a2a_bps})

    # every call the tuned plans made that phase 3 did not check
    cases = calls_as_cases(calls, {})
    checks, timing = run_cases(torch, dev, cfg, gpu, cases, seed=7)
    checked = {case_key(k, s, o) for _, k, s, o, _ in cases}
    return ({"runs": runs, "checks": checks, "a2a_bytes_s": a2a_bps},
            measured, checked, timing)


# ---------------------------------------------------------------------------
# phase 14: benchmarks/bench_pipeline.py's gate


def pipeline_stores(cfg) -> list:
    """(segments, segments a block) of phase 14's two stores: the warm-up
    store of one full batch (``coalesce`` blocks) and the timed one of
    ``size_mb``."""
    c = cfg["pipeline"]
    per_block = c["segments_per_block"]
    n_seg = c["size_mb"] * (1 << 20) // (8 * c["fft_len"])
    return [(c["coalesce"] * per_block, per_block),
            (n_seg, min(per_block, n_seg))]


def pipeline_calls(cfg) -> list:
    """Every kernel call phase 14's impl "matfft" can launch, as
    (`launch_shapes` key, phase 3's options): a batch of one to
    ``coalesce`` full blocks of either store (the stream launches a short
    group when its queue runs dry; serial and threaded jobs one block),
    or its one short last block."""
    c = cfg["pipeline"]
    rows = set()
    for n_seg, per_block in pipeline_stores(cfg):
        rows.update(k * per_block for k in range(1, c["coalesce"] + 1))
        if n_seg % per_block:
            rows.add(n_seg % per_block)
    return [(key, pass_opts(key)) for r in sorted(rows)
            for key in nd_pass_launches(r, c["fft_len"])]


def pipeline_kernel_cases(cfg) -> list:
    return calls_as_cases(pipeline_calls(cfg), {})


def pipeline_gate(torch, dev, gpu: bool, cfg, work: Path) -> tuple[dict,
                                                                    dict]:
    """bench_pipeline's three modes over one `ThrottledStore` (every block
    read and write sleeps bytes / ``disk_mb_s``, the bench's `DISK_MB_S`
    unless the configuration says), best of ``iters`` each after a
    warm-up on a store of one full batch, under each impl: pipelined
    faster than serial, its stages overlapping (``overlap_x`` > 1) and the
    three merged outputs bitwise equal; impl "matfft"'s within 5e-6 of
    impl "ref"'s. Each impl's warm-up and timed runs have the counts
    zeroed just before and read just after; on the card impl "matfft"
    launches K1 and no plain version runs. Returns the summary and, for
    each impl, its calls (`read_shapes`)."""
    import numpy as np

    import repro_torch.fft as tfft
    from repro_torch.core.pipeline import BlockStore, JobConfig
    from repro_torch.core.pipeline.records import segment_block_bytes
    from repro_torch.core.pipeline.testing import DISK_MB_S, ThrottledStore
    from repro_torch.launch.fft_job import run_job as run_fft_job

    c = cfg["pipeline"]
    device = "cuda" if gpu else "cpu"
    modes = {
        "serial": (False, JobConfig(workers=1, speculation=False)),
        "pipelined": (True, JobConfig(readers=4, writers=4,
                                      coalesce=c["coalesce"],
                                      inflight=c["inflight"],
                                      speculation=False,
                                      poll_interval_s=0.005)),
        "maponly_threaded": (False, JobConfig(workers=4, speculation=False)),
    }

    disk_mb_s = c.get("disk_mb_s", DISK_MB_S)

    def make_store(root: Path, n_seg: int, per_block: int):
        sig = np.random.default_rng(0).standard_normal(
            (n_seg, c["fft_len"], 2)).astype(np.float32)
        store = BlockStore(root, block_bytes=segment_block_bytes(
            c["fft_len"], per_block))
        store.put_bytes(sig.tobytes())
        store = ThrottledStore.open(root)
        store.disk_mb_s = disk_mb_s
        return store

    def run_mode(store, out: Path, mode: str, impl: str) -> dict:
        shutil.rmtree(out / f"out_{mode}", ignore_errors=True)
        pipelined, job_cfg = modes[mode]
        t0 = time.monotonic()
        job, stats, stage_s = run_fft_job(
            store, out / f"out_{mode}", fft_len=c["fft_len"], impl=impl,
            cfg=job_cfg, pipelined=pipelined, device=device)
        wall = time.monotonic() - t0
        merged = out / f"merged_{mode}.bin"
        job.merge(merged)
        total = sum(stage_s.values())
        return {"wall_s": wall,
                "throughput_mb_s": store.total_bytes / (1 << 20) / wall,
                "stage_s": stage_s, "overlap_x": total / wall,
                "overlap_efficiency": max(stage_s.values()) / wall,
                "batches": stats.batches, "blocks": stats.blocks_done,
                "merged": merged}

    (warm_seg, warm_block), (n_seg, per_block) = pipeline_stores(cfg)
    warm = make_store(work / "warm_in", warm_seg, warm_block)
    store = make_store(work / "in", n_seg, per_block)
    out, measured = {"disk_sim_mb_s": disk_mb_s, "config": dict(c)}, {}
    ref = None
    for impl in c["impls"]:
        tfft.clear_plan_cache()
        reset_counts()
        for mode in modes:
            run_mode(warm, work / "warm", mode, impl)
        results = {}
        for mode in modes:
            for _ in range(c["iters"]):
                r = run_mode(store, work, mode, impl)
                best = results.get(mode)
                if best is None or r["wall_s"] < best["wall_s"]:
                    results[mode] = r
        counts = read_counts()
        measured[f"pipeline impl={impl}"] = read_shapes(gpu)
        merged = {m: r.pop("merged").read_bytes() for m, r in results.items()}
        ser, pipe = results["serial"], results["pipelined"]
        checks = {
            "pipelined_throughput_gt_serial":
                pipe["throughput_mb_s"] > ser["throughput_mb_s"],
            "pipelined_stages_overlap": pipe["overlap_x"] > 1.0,
            "outputs_bitwise_identical":
                all(v == merged["serial"] for v in merged.values())}
        got = np.frombuffer(merged["serial"], dtype=np.float32)
        if impl == "ref":
            ref = got
        else:
            err = float(np.abs(got - ref).max()) / (
                float(np.abs(ref).max()) or 1.0)
            checks["within_tol_of_ref"] = err < TOL
        doc = {"impl": impl, **results,
               "speedup_vs_serial_x": (pipe["throughput_mb_s"]
                                       / ser["throughput_mb_s"]),
               "checks": checks, "launches": counts}
        if impl != "ref":
            doc["rel_err_vs_ref"] = err
        print("pipeline " + json.dumps(doc))
        out[impl] = doc
        for name, ok in checks.items():
            check(ok, f"pipeline gate impl={impl}: {name}")
        if impl == "matfft":
            check_main_path(gpu, "pipeline gate impl=matfft", counts,
                            "matfft")
        elif gpu:
            check(counts["plain"] == 0, "pipeline gate: a plain version ran")
    return out, measured


# ---------------------------------------------------------------------------
# phase 15: the service over several ranks on the one card


def mesh_serve_calls(cfg) -> list:
    """The kernel calls of phase 15 past those of phase 12: each rank's
    shard of a segmented launch of the paper mix (verify "off"; with
    "abft" the checksum row leaves the batch indivisible and rank 0 runs
    phase 12's launch alone), as (`launch_shapes` key, phase 3's
    options)."""
    from repro_torch.kernels.fft import plan as kplan
    ranks = cfg["mesh_serve"]["ranks"]
    _, _, paper = serve_mixes(cfg)["paper"]
    calls = []
    for shape in paper:
        for total in {shape.rows, cfg["serve"]["coalesce"] * shape.rows}:
            if total % ranks:
                continue
            rows = total // ranks
            if shape.kind == "c2c":
                keys = nd_pass_launches(rows, shape.n)
            elif kplan.make_plan(shape.n // 2).levels == 1:
                keys = [("rfft_leaf", (rows, shape.n), None)]
            else:
                keys = nd_pass_launches(rows, shape.n // 2)
            calls += [(key, pass_opts(key)) for key in keys]
    return calls


def mesh_serve_kernel_cases(cfg) -> list:
    return calls_as_cases(mesh_serve_calls(cfg), {})


def mesh_serve_service(cfg, gpu: bool, mesh, verify: str):
    """The service every rank of phase 15 constructs, the same on each."""
    from repro_torch.serve import FftService
    c = cfg["serve"]
    return FftService(impl="matfft", device="cuda" if gpu else "cpu",
                      mesh=mesh, coalesce=c["coalesce"],
                      queue_depth=max(c["paper_requests"], 1), verify=verify)


def mesh_serve_group(torch, gpu: bool, cfg, store: Path, rank: int):
    """Join phase 15's gloo group of ``ranks`` processes (every one on the
    one card) and return its 1-D ("data",) mesh."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    ranks = cfg["mesh_serve"]["ranks"]
    dist.init_process_group("gloo", store=dist.FileStore(str(store), ranks),
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=120))
    return init_device_mesh("cuda" if gpu else "cpu", (ranks,),
                            mesh_dim_names=("data",))


def mesh_serve_follower(rank: int, store: str, out: str, gpu: bool) -> int:
    """A follower of phase 15 (``chip_smoke.py --follower``): construct each
    run's service, obey rank 0 until its stop, and write the kernel calls
    this process launched (the plain versions' in the rehearsal)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    cfg = FULL if gpu else REHEARSE
    mesh = mesh_serve_group(torch, gpu, cfg, Path(store), rank)
    runs = []
    try:
        for verify in serve_mixes(cfg)["paper"][1]:
            reset_counts()
            service = mesh_serve_service(cfg, gpu, mesh, verify)
            service.close()
            runs.append({"verify": verify,
                         "shard_launches": service.stats.batches,
                         "counts": read_counts(),
                         "shapes": [[list(k), v] for k, v in
                                    read_shapes(gpu).items()]})
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps({
        "rank": rank, "runs": runs,
        "device": torch.cuda.get_device_name(0) if gpu else "cpu"}))
    return 0


def mesh_serve_checks(torch, dev, gpu: bool, cfg, work: Path,
                      one_rank: list) -> tuple[dict, dict, dict]:
    """Phase 15: the service over ``ranks`` processes on the one card, one
    gloo group (NCCL takes no two ranks on one card; the service's plans
    here are segmented and local, which run no collective, and its control
    channel is gloo on CPU tensors). This process is rank 0 and submits;
    the followers are ``chip_smoke.py --follower`` subprocesses. Phase
    12's paper mix under verify "off" and "abft", each run with the counts
    zeroed just before and read just after: every request ``ok``, bitwise
    equal to `loadgen.oracle` at its launch size (the one-rank service's
    output at the same launch rows: the kernels are batch invariant and
    segmented == local), within 5e-6 of torch.fft; with "off" every
    follower launched the kernels. ``qps_completed``, the latency
    percentiles and the clients' ``submit_s`` beside phase 12's one-rank
    runs, with rank 0's seconds in each launch step
    (`FftService.mesh_seconds`). Returns the summary,
    rank 0's calls, and the followers' launches by `launch_shapes` key."""
    import os
    from collections import Counter

    import torch.distributed as dist

    from repro_torch.serve import loadgen

    c = cfg["serve"]
    ranks = cfg["mesh_serve"]["ranks"]
    device = "cuda" if gpu else "cpu"
    _, modes, mix = serve_mixes(cfg)["paper"]
    n_req = c["paper_requests"]
    store = work / "store"
    work.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for r in range(1, ranks):
        log = open(work / f"rank{r}.log", "w")
        procs.append((r, log, subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--follower",
             str(r), "--store", str(store), "--out",
             str(work / f"rank{r}.json"), *([] if gpu else ["--rehearse"])],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)))
    out, measured = {"ranks": ranks, "runs": []}, {}
    try:
        mesh = mesh_serve_group(torch, gpu, cfg, store, 0)
        try:
            for verify in modes:
                name = f"mesh serve verify={verify}"
                service = mesh_serve_service(cfg, gpu, mesh, verify)
                launches = Counter()
                plan_for = service._plan_for

                def recorded(kind, shape, total, plan_for=plan_for,
                             launches=launches):
                    p = plan_for(kind, shape, total)
                    launches[p.placement] += 1
                    return p

                service._plan_for = recorded
                reset_counts()
                t0 = time.monotonic()
                records = loadgen.drive(service, num_requests=n_req,
                                        clients=c["clients"], seed=c["seed"],
                                        mix=mix)
                submit_s = time.monotonic() - t0
                outcomes = {q.rid: loadgen.classify(q) for q in records}
                service.close(drain=True)
                wall = time.monotonic() - t0
                counts, shapes = read_counts(), read_shapes(gpu)
                measured[name] = shapes
                if gpu:
                    check(counts["plain"] == 0, f"{name}: a plain version ran")
                check(set(outcomes.values()) == {"ok"},
                      f"{name}: outcomes {Counter(outcomes.values())}")
                worst = 0.0
                for q in records:
                    ops = loadgen.request_operands(c["seed"], q.rid, q.shape)
                    want = loadgen.oracle(q.shape, ops, impl="matfft",
                                          batch_rows=q.ticket.batch_rows,
                                          device=device)
                    check(loadgen.bitwise_equal(q.ticket.value, want),
                          f"{name}: request {q.rid} differs from the "
                          f"one-rank output at its launch size")
                    got = torch.complex(*(torch.from_numpy(a).to(dev)
                                          for a in q.ticket.value))
                    x = [torch.from_numpy(a).to(dev) for a in ops]
                    lib = (torch.fft.fft(torch.complex(*x), dim=-1)
                           if q.shape.kind == "c2c"
                           else torch.fft.rfft(x[0], dim=-1))
                    worst = max(worst, rel_err(got, lib))
                check(worst < TOL, f"{name}: {worst} vs torch.fft")
                stats = service.stats.snapshot()
                one = next(d for d in one_rank
                           if d["run"] == f"paper verify={verify}")
                doc = {"run": name, "ranks": ranks, "requests": len(records),
                       "wall_s": wall, "qps_completed": len(records) / wall,
                       "submit_s": submit_s,
                       "rank0_mesh_s": service.mesh_seconds(),
                       "latency": stats["latency"],
                       "batches": stats["batches"],
                       "placements": dict(launches),
                       "one_rank_qps_completed": one["qps_completed"],
                       "one_rank_submit_s": one["submit_s"],
                       "one_rank_latency": one["latency"],
                       "rel_err_torch_fft": worst, "launches": counts}
                print("mesh serve " + json.dumps(doc))
                out["runs"].append(doc)
        finally:
            dist.destroy_process_group()
        followers = {}
        for r, log, proc in procs:
            rc = proc.wait(timeout=300)
            log.close()
            check(rc == 0, f"follower {r}: exit {rc}: "
                  f"{(work / f'rank{r}.log').read_text()[-2000:]}")
            followers[r] = json.loads((work / f"rank{r}.json").read_text())
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    follower_calls = Counter()
    for r, doc in followers.items():
        for run in doc["runs"]:
            calls = Counter({(k[0], tuple(k[1]), k[2]) + tuple(
                tuple(t) for t in k[3:]): v for k, v in run["shapes"]})
            follower_calls.update(calls)
            if run["verify"] == "off":
                check(run["shard_launches"] > 0 and sum(calls.values()) > 0,
                      f"follower {r}: no kernel launched")
            if gpu:
                check(run["counts"]["plain"] == 0,
                      f"follower {r}: a plain version ran")
        out[f"follower_{r}"] = [
            {k: run[k] for k in ("verify", "shard_launches", "counts")}
            for run in doc["runs"]]
    print("mesh serve followers " + json.dumps(
        {r: out[f"follower_{r}"] for r in followers}))
    return out, measured, follower_calls


# ---------------------------------------------------------------------------
# phase 16: fft_dryrun's analytic records


def dryrun_records() -> dict:
    """`python -m repro_torch.launch.fft_dryrun` as a user runs it (the
    256-rank mesh; no process group, no card), then the 512-rank mesh's
    records in this process."""
    import os

    from repro_torch.launch import fft_dryrun
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fft_dryrun"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"fft_dryrun: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out = {"single_pod": {
        "seconds": time.monotonic() - t0,
        "records": [json.loads(line) for line in proc.stdout.splitlines()]}}
    with contextlib.redirect_stdout(io.StringIO()):
        out["multi_pod"] = {"records": fft_dryrun.main(["--mesh",
                                                        "multi_pod"])}
    for mesh, doc in out.items():
        check(len(doc["records"]) == 8,
              f"fft_dryrun --mesh {mesh}: {len(doc['records'])} records")
    return out


# ---------------------------------------------------------------------------
# phase 17: LM serving


def lm_twin(model, dtype: str, layers: int | None = None):
    """``model`` computing in ``dtype`` over the same parameter tensors;
    with ``layers``, only its first ``layers`` layers (views of the
    stacked blocks; the shared block and the encoder whole)."""
    import dataclasses

    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(model.cfg, dtype=dtype, cache_dtype=dtype,
                              num_layers=layers or model.cfg.num_layers)
    state = model.state_dict()
    if layers:
        period = len(cfg.layer_pattern)
        check(layers <= model.cfg.pattern_groups()[0] * period,
              f"a cut to {layers} layers reaches the tail")
        full, tail = cfg.pattern_groups()
        cut = {}
        for name, t in state.items():
            if name.startswith("tail."):
                continue
            if name.startswith("blocks."):
                _, j, rest = name.split(".", 2)
                if int(j) < tail:
                    cut[f"tail.{j}.{rest}"] = t[full]
                if not full:
                    continue
                t = t[:full]
            cut[name] = t
        state = cut
    twin = TransformerLM(cfg, device="meta")
    twin.load_state_dict(state, assign=True)
    return twin


def lm_batch(torch, cfg, seed: int, batch: int, prompt: int, frames: int,
             dev) -> dict:
    """Tokens from numpy's generator, then, as the launcher draws its stub
    inputs, ``frames`` frames for the encoder-decoder and the VLM's
    patches (float32), on ``dev``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (batch, prompt))}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch, frames, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeds:
        out["patches"] = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def lm_generate(torch, model, batch: dict, new: int):
    """`ServeEngine.generate`'s prefill and greedy decode, keeping each
    step's logits: tokens (B, new) and logits (B, new, V)."""
    with torch.inference_mode():
        tokens = batch["tokens"]
        s = model.cfg.num_prefix_embeds + tokens.shape[1]
        logits, caches = model.prefill(batch, cache_len=s + new)
        steps = [logits[:, -1]]
        out = [torch.argmax(steps[-1], dim=-1)[:, None].to(tokens.dtype)]
        for t in range(new - 1):
            logits, caches = model.decode_step(caches, out[-1], s + t)
            steps.append(logits[:, -1])
            out.append(torch.argmax(steps[-1],
                                    dim=-1)[:, None].to(tokens.dtype))
        return torch.cat(out, dim=1), torch.stack(steps, dim=1)


def lm_teacher_forced(torch, model, batch: dict, out, rows=None):
    """`forward`'s logits over prompt + generated tokens at the positions
    whose next token each decode step chose: (B, new, V). ``rows``
    sequences a call (all when None): llama4-scout's (B, S, 202048)
    logits do not fit beside its float64 twin, and its MoE groups are one
    sequence each either way."""
    with torch.inference_mode():
        tokens = batch["tokens"]
        at = model.cfg.num_prefix_embeds + tokens.shape[1] - 1
        full = {**batch, "tokens": torch.cat([tokens, out[:, :-1]], dim=1)}
        b = tokens.shape[0]
        rows = rows or b
        return torch.cat([
            model.forward({k: v[i:i + rows] for k, v in full.items()})[:, at:]
            for i in range(0, b, rows)])


def step_rel_errs(got, want):
    """max_V |got - want| / max_{B,V} |want| for each (sequence, step) of
    (B, steps, V): (B, steps)."""
    return ((got - want).abs().amax(dim=2)
            / want.abs().amax(dim=(0, 2))[None])


@contextlib.contextmanager
def moe_record(torch):
    """Record every MoE dispatch run inside the block, in call order (one
    call a layer a forward): each token's choices dropped over capacity,
    and its router margin (the k-th minus the (k+1)-th probability; a
    margin near 0 is a near-tie that a rounding can flip)."""
    from repro_torch.models import moe
    route, dispatch = moe._route, moe._dispatch_tensors
    rec = {"dropped": [], "margin": []}

    def recording_route(cfg, p, x):
        k = cfg.num_experts_per_tok
        probs = torch.softmax(torch.matmul(x.float(), p["router"].float()),
                              dim=-1).sort(dim=-1, descending=True).values
        rec["margin"].append(
            (probs[..., k - 1] - probs[..., k]).detach().cpu())
        return route(cfg, p, x)

    def recording_dispatch(cfg, weights, idx, n_tokens):
        d, c = dispatch(cfg, weights, idx, n_tokens)
        rec["dropped"].append(
            (cfg.num_experts_per_tok - d.float().sum(dim=(-2, -1))).cpu())
        return d, c

    moe._route, moe._dispatch_tensors = recording_route, recording_dispatch
    try:
        yield rec
    finally:
        moe._route, moe._dispatch_tensors = route, dispatch


def moe_clean(torch, prefill: list, forward: list, layers: int,
              prompt: int, new: int):
    """(B, new) mask of the decode steps whose logits must equal the
    teacher-forced forward's: a step's logits at position q depend on
    the last layer's experts at q and every earlier layer's at positions
    <= q, so a step is clean when neither the forward nor the prefill
    dropped a choice there (decode's groups of one token never drop).
    ``prefill``: one record a layer, each (B, prompt); ``forward``: one a
    layer for each forward call, each (sequences of the call, S) (a
    group is one sequence)."""
    pre = [d > 0 for d in prefill]
    fwd = [torch.cat(forward[layer::layers]) > 0 for layer in range(layers)]
    b = pre[0].shape[0]
    mask = torch.ones((b, new), dtype=torch.bool)
    for i in range(b):
        tainted = any(bool(d[i].any()) for d in pre[:-1])
        for t in range(new):
            q = prompt - 1 + t
            dirty = tainted or bool(fwd[-1][i, q]) or any(
                bool(d[i, :q + 1].any()) for d in fwd[:-1])
            if t == 0:
                dirty = dirty or bool(pre[-1][i, q])
            mask[i, t] = not dirty
    return mask


def lm_timed_ms(torch, gpu: bool, fn, reps: int) -> float:
    """Mean ms of one call: CUDA events on the card, the host clock in the
    rehearsal (a CPU number, never written as a device time)."""
    if gpu:
        return timed_ms(torch, fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def lm_free(torch, gpu: bool) -> None:
    import gc
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()


def lm_config(cfg: dict, spec: dict):
    """The model config ``spec`` serves: reduced in the rehearsal, cut to
    ``spec["layers"]`` (and ``spec["encoder_layers"]``) where it says."""
    import dataclasses

    from repro_torch.configs import get_config
    mcfg = get_config(spec["arch"])
    if cfg["reduced"]:
        mcfg = mcfg.reduced()
    if spec.get("layers"):
        mcfg = dataclasses.replace(mcfg, num_layers=spec["layers"])
    if spec.get("encoder_layers"):
        mcfg = dataclasses.replace(mcfg,
                                   encoder_layers=spec["encoder_layers"])
    if spec.get("dtype"):
        mcfg = dataclasses.replace(mcfg, dtype=spec["dtype"])
    return mcfg


def lm_twin_checks(torch, params, batch: dict, new: int, layers, dtype: str,
                   moe: bool, rows=None) -> dict:
    """(b) for one twin of ``params`` at one depth: decode steps against the
    teacher-forced forward (at the steps neither dropped a token, for a
    MoE model), the engine's tokens against its own steps'."""
    from repro_torch.serve import ServeEngine
    twin = lm_twin(params, dtype, layers)
    with moe_record(torch) as rec:
        out, steps = lm_generate(torch, twin, batch, new)
        n_prefill = len(rec["dropped"])
        want = lm_teacher_forced(torch, twin, batch, out, rows)
    check(torch.equal(out, ServeEngine(twin).generate(batch, new)),
          f"lm {twin.cfg.name} {dtype}: the engine's tokens differ from its "
          f"own steps'")
    errs = step_rel_errs(steps, want).cpu()
    argmax_equal = (out == want.argmax(dim=-1).to(out.dtype)).cpu()
    at = {}
    if moe:
        n_layers = twin.cfg.num_layers
        prefill = rec["dropped"][:n_layers]
        forward = rec["dropped"][n_prefill:]
        clean = moe_clean(torch, prefill, forward, n_layers,
                          batch["tokens"].shape[1], new)
        at.update(
            clean_steps=int(clean.sum()), steps=clean.numel(),
            forward_dropped=int(sum(float(d.sum()) for d in forward)),
            prefill_dropped=int(sum(float(d.sum()) for d in prefill)),
            decode_vs_forward_all=float(errs.max()),
            min_router_margin=float(min(m.min() for m in rec["margin"])))
    else:
        clean = torch.ones_like(errs, dtype=torch.bool)
    held = errs[clean]
    at.update(
        decode_vs_forward=float(held.max()) if held.numel() else None,
        worst_step=int(errs.masked_fill(~clean, -1).amax(dim=0).argmax()),
        tokens_equal_forward_argmax=bool(argmax_equal[clean].all()),
        first=steps[:, 0])
    return at


def lm_model_checks(torch, dev, gpu: bool, cfg: dict, spec: dict) -> dict:
    """Phase 17 for one model of ``cfg["models"]``: the launcher, then the
    engine's tokens (a), the decode steps against the teacher-forced
    forward in the twins (b), the served dtype's first-token logits
    against the float32 twin (d), and the times."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve import ServeEngine

    seed, reps = cfg["seed"], cfg["reps"]
    arch, batch, prompt, new = (spec[k] for k in ("arch", "batch", "prompt",
                                                  "new"))
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--new-tokens", str(new), "--seed", str(seed),
            "--device", dev.type] + (["--reduced"] if cfg["reduced"] else [])
    if spec.get("layers"):
        argv += ["--num-layers", str(spec["layers"])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = serve_cli.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"lm launch [{arch}] {line}")
    launch_tokens = report.pop("tokens").cpu()
    lm_free(torch, gpu)

    mcfg = lm_config(cfg, spec)
    model = TransformerLM(mcfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
    # the launcher's 64 stub frames; the encoder-decoder's cell runs more
    frames = spec.get("frames", 64)
    inputs = lm_batch(torch, mcfg, seed, batch, prompt, frames, dev)
    tokens = inputs["tokens"]
    engine = ServeEngine(model)

    # (a) and the steady-state generate, after a warm-up call
    engine.generate(inputs, new)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gen_ms = lm_timed_ms(torch, gpu, lambda: engine.generate(inputs, new), 1)
    out = engine.generate(inputs, new)
    peak = torch.cuda.max_memory_allocated() if gpu else None
    check(tuple(out.shape) == (batch, new) and out.dtype == tokens.dtype,
          f"lm {arch}: tokens {tuple(out.shape)} {out.dtype}")
    check(bool(((out >= 0) & (out < mcfg.vocab_size)).all()),
          f"lm {arch}: a token out of range")

    # prefill and decode times
    s = mcfg.num_prefix_embeds + prompt

    @torch.inference_mode()
    def prefill():
        return model.prefill(inputs, cache_len=s + new)

    prefill_ms = lm_timed_ms(torch, gpu, prefill, reps)

    @torch.inference_mode()
    def decode_all():
        _, caches = prefill()
        for t in range(new - 1):
            model.decode_step(caches, out[:, t:t + 1], s + t)

    decode_ms = (lm_timed_ms(torch, gpu, decode_all, reps)
                 - prefill_ms) / (new - 1)
    weights = model.weights()

    def leaves(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(weights))
    kv_bytes = sum(t.numel() * t.element_size() for t in leaves(
        model.init_cache(batch, s + new)))
    del weights

    # the twins' batch: a MoE model's forward over prompt + new - 1 tokens
    # must be whole groups, so its twins run the first ``twin_prompt``
    # tokens (the forward then one group a sequence)
    twin_prompt = spec.get("twin_prompt", prompt)
    twin_inputs = {**inputs, "tokens": tokens[:, :twin_prompt]}
    with torch.inference_mode():
        first = model.prefill(twin_inputs)[0][:, -1]

    summary = {
        "arch": arch, "layers": mcfg.num_layers, "batch": batch,
        "prompt": prompt, "new_tokens": new,
        "params": sum(p.numel() for p in model.parameters()),
        "dtype": mcfg.dtype, "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_ms, "generate_ms": gen_ms,
        "tok_s": batch * new / (gen_ms * 1e-3),
        "launcher_first_s": report["first_s"],
        "launcher_steady_s": report["steady_s"],
        "launcher_tok_s": report["tok_s"],
        # the launcher draws 64 stub frames: equal only at that count
        "tokens_equal_launcher": (bool(torch.equal(out.cpu(), launch_tokens))
                                  if frames == 64 else None),
        "peak_bytes": peak, "weight_bytes": weight_bytes,
        "kv_bytes": kv_bytes,
        "decode_bound_ms": weight_bytes / HBM_BYTES_S * 1e3,
        "twin_prompt": twin_prompt, "twins": {}}
    if "frames" in spec:
        summary["frames"] = frames
    summary["decode_x_bound"] = decode_ms / summary["decode_bound_ms"]
    # the twins share the parameters; dropping the served model frees its
    # cast copy of them
    params = lm_twin(model, "float32")
    del model, engine, inputs
    lm_free(torch, gpu)

    # (b) and (d): each twin over the same parameters, at full depth (where
    # its copy fits) and at each cut of ``spec["depths"]``
    moe = bool(mcfg.num_experts)
    for layers in [None, *spec["depths"]]:
        twins = spec.get("full_twins", LM_TWINS) if layers is None \
            else LM_TWINS
        at = {}
        for dtype in twins:
            at[dtype] = lm_twin_checks(torch, params, twin_inputs, new,
                                       layers, dtype, moe,
                                       spec.get("forward_rows"))
            lm_free(torch, gpu)
        if layers:
            with torch.inference_mode():
                served = lm_twin(params, mcfg.dtype, layers).prefill(
                    twin_inputs)[0][:, -1]
        else:
            served = first
        for dtype, d in at.items():
            d["served_first_token"] = rel_err(served.float(), d["first"])
        if len(at) == 2:
            at["float32_vs_float64_first_token"] = rel_err(
                at["float32"]["first"], at["float64"]["first"])
        for d in at.values():
            if isinstance(d, dict):
                d.pop("first")
        summary["twins"][str(layers or mcfg.num_layers)] = at
        del served
        lm_free(torch, gpu)

    # the gates: (b) at the depth it is held at, (d) at full depth
    held = summary["twins"][str(spec["gate_layers"] or mcfg.num_layers)]
    served = summary["twins"][str(mcfg.num_layers)]["float32"][
        "served_first_token"]
    for dtype in spec["gate_twins"]:
        err = held[dtype]["decode_vs_forward"]
        check(err is not None, f"lm {arch} {dtype}: no decode step without "
              f"a dropped token to hold")
        check(err < LM_TOL, f"lm {arch} {dtype}: decode steps {err} from "
              f"the forward")
        check(held[dtype]["tokens_equal_forward_argmax"],
              f"lm {arch} {dtype}: greedy tokens differ from the forward's "
              f"argmax")
    check(served < spec["served_bound"], f"lm {arch}: {mcfg.dtype} "
          f"first-token logits {served} from the float32 twin")
    del params
    lm_free(torch, gpu)
    return summary


def lm_cpu_check(torch, dev, cfg: dict, spec: dict) -> dict:
    """(c): the card's twin prefill logits against the port's own CPU run on
    the same parameters: ``spec``'s model built on the card at
    ``spec["layers"]`` (and ``spec["encoder_layers"]`` where it says; the
    shared block whole), copied to the host, and compared at each of
    ``spec["depths"]`` in each twin; held at ``spec["gate_layers"]`` in
    its gated twins. For a MoE model a failure prints the router margins
    of the last token."""
    import dataclasses

    from repro_torch.models.transformer import TransformerLM

    arch, batch, prompt = spec["arch"], spec["batch"], spec["prompt"]
    mcfg = lm_config(cfg, {"arch": arch})
    mcfg = dataclasses.replace(
        mcfg, num_layers=spec["layers"],
        encoder_layers=spec.get("encoder_layers", mcfg.encoder_layers))
    model = TransformerLM(mcfg, device=dev, generator=torch.Generator(
        dev).manual_seed(cfg["seed"]))
    inputs = lm_batch(torch, mcfg, cfg["seed"], batch, prompt,
                      spec.get("frames", 64), torch.device("cpu"))
    host = host_copy(torch, model)
    out = {"arch": arch, "batch": batch, "prompt": prompt}
    if mcfg.encoder_layers:
        out["encoder_layers"] = mcfg.encoder_layers
    margins = {}
    for layers in spec["depths"]:
        at = out[str(layers)] = {}
        for dtype in LM_TWINS:
            with torch.inference_mode():
                card = lm_twin(model, dtype, layers).prefill(
                    {k: v.to(dev) for k, v in inputs.items()})[0].cpu()
                with moe_record(torch) as rec:
                    cpu = lm_twin(host, dtype, layers).prefill(inputs)[0]
            at[dtype] = rel_err(card, cpu)
            if rec["margin"]:
                margins[(layers, dtype)] = [float(m[..., -1].min())
                                            for m in rec["margin"]]
            lm_free(torch, dev.type == "cuda")
    if margins:
        out["last_token_router_margin"] = {
            f"{layers} {dtype}": m for (layers, dtype), m in margins.items()}
    held = out[str(spec["gate_layers"])]
    for dtype in spec["gate_twins"]:
        check(held[dtype] < LM_TOL,
              f"lm {arch} {dtype}: card prefill {held[dtype]} from the "
              f"host's; last token's router margin a layer: "
              f"{margins.get((spec['gate_layers'], dtype))}")
    del model, host
    lm_free(torch, dev.type == "cuda")
    return out


def lm_checks(torch, dev, gpu: bool, cfg: dict) -> dict:
    """Phase 17: LM serving through `repro_torch.launch.serve` and
    `ServeEngine` for each model of ``cfg["models"]``, and (c) for each of
    ``cfg["cpu_checks"]``. No FFT kernel runs."""
    reset_counts()
    runs, cpu = [], []
    for spec in cfg["models"]:
        t0 = time.monotonic()
        summary = lm_model_checks(torch, dev, gpu, cfg, spec)
        summary["seconds"] = time.monotonic() - t0
        print("lm serve " + json.dumps(summary))
        runs.append(summary)
    for spec in cfg["cpu_checks"]:
        t0 = time.monotonic()
        summary = lm_cpu_check(torch, dev, cfg, spec)
        summary["seconds"] = time.monotonic() - t0
        print("lm card vs cpu " + json.dumps(summary))
        cpu.append(summary)
    counts = read_counts()
    check(not any(counts.values()), f"LM serving ran an FFT kernel: {counts}")
    return {"runs": runs, "card_vs_cpu": cpu}


# ---------------------------------------------------------------------------
# phase 18: LM training


def train_launch(argv: list, label: str) -> dict:
    """`repro_torch.launch.train.main` with ``argv``; its JSON lines
    printed under ``label``."""
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = train_cli.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"lm train launch [{label}] {line}")
    return report


def train_history_checks(report: dict, label: str) -> None:
    """Every logged loss and grad norm finite."""
    hist = report["history"]
    check(hist, f"lm train {label}: no logged step")
    for m in hist:
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"lm train {label}: step {m['step']}: loss {m['loss']}, grad "
              f"norm {m['grad_norm']}")


def state_equals_files(torch, state, ckpt: Path, step: int, dev) -> bool:
    """Every leaf of ``state`` (flatten order) equal bit for bit to the
    checkpoint's ``leaf_<i>.npy`` of ``step``, compared on ``dev``."""
    import numpy as np

    from repro_torch.tree import tree_leaves
    d = ckpt / f"step_{step:08d}"
    leaves = tree_leaves(state)
    if len(leaves) != len(list(d.glob("leaf_*.npy"))):
        return False
    for i, leaf in enumerate(leaves):
        want = torch.from_numpy(np.load(d / f"leaf_{i:05d}.npy")).to(dev)
        if leaf.dtype != want.dtype or not torch.equal(leaf.detach(), want):
            return False
    return True


def lm_train_full(torch, dev, gpu: bool, spec: dict, work: Path) -> dict:
    """(a): the launcher at ``spec``'s size for ``steps``, the state that a
    new trainer restores from its checkpoint held bit for bit to the
    files, then a relaunch to ``resume_steps`` that must resume."""
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    ckpt, data = work / "ckpt", work / "corpus"
    argv = ["--arch", spec["arch"], "--batch", str(spec["batch"]),
            "--seq", str(spec["seq"]), "--optimizer", spec["optimizer"],
            "--lr", str(spec["lr"]), "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(spec["steps"]), "--data-dir", str(data),
            "--seed", "0", "--device", dev.type, "--qk-fan-in"] + (
                ["--reduced"] if spec["reduced"] else [])
    first = train_launch(argv + ["--steps", str(spec["steps"])],
                         spec["arch"])
    train_history_checks(first, spec["arch"])
    hist = first["history"]
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"lm train {spec['arch']}: loss {hist[0]['loss']} at step "
          f"{hist[0]['step']}, {hist[-1]['loss']} at step {hist[-1]['step']}")
    state = first.pop("state")
    check(all(t.device.type == dev.type for t in tree_leaves(state)),
          f"lm train {spec['arch']}: a state leaf is not on {dev.type}")
    live_equal = state_equals_files(torch, state, ckpt, spec["steps"], dev)
    check(live_equal, f"lm train {spec['arch']}: the checkpoint of step "
          f"{spec['steps']} differs from the trained state")
    del state
    lm_free(torch, gpu)

    # a new trainer restores the checkpoint onto the device
    mcfg = lm_config({"reduced": spec["reduced"]}, spec)
    model = TransformerLM(mcfg, device=dev)
    trainer = Trainer(model, TrainerConfig(optimizer=spec["optimizer"],
                                           ckpt_dir=str(ckpt)))
    restored = trainer.restore_or_init()
    check(int(restored["step"]) == spec["steps"],
          f"lm train {spec['arch']}: restored step {int(restored['step'])}")
    check(model.embed.device.type == dev.type,
          f"lm train {spec['arch']}: restored parameters on "
          f"{model.embed.device}")
    restored_equal = state_equals_files(torch, restored, ckpt,
                                        spec["steps"], dev)
    check(restored_equal, f"lm train {spec['arch']}: the restored state "
          f"differs from the checkpoint's files")
    breakdown = lm_train_breakdown(torch, gpu, trainer, restored,
                                   spec["batch"], spec["seq"])
    del model, trainer, restored
    lm_free(torch, gpu)

    again = train_launch(argv + ["--steps", str(spec["resume_steps"])],
                         f"{spec['arch']} relaunch")
    train_history_checks(again, f"{spec['arch']} relaunch")
    check(again["resumed_from"] == spec["steps"],
          f"lm train {spec['arch']}: resumed from {again['resumed_from']}")
    again.pop("state")
    lm_free(torch, gpu)
    shutil.rmtree(work, ignore_errors=True)

    tokens = first["tokens_per_step"]
    flops = 6 * first["params"] * tokens  # model FLOPs of a step
    steady_s = first["steady_step_ms"] * 1e-3
    saves = first["checkpoints"] + again["checkpoints"]
    out = {
        "arch": spec["arch"], "layers": mcfg.num_layers,
        "d_model": mcfg.d_model, "vocab": mcfg.vocab_size,
        "params": first["params"], "dtype": mcfg.dtype, "remat": mcfg.remat,
        "loss_chunk": mcfg.loss_chunk, "batch": spec["batch"],
        "seq": spec["seq"], "optimizer": spec["optimizer"],
        "lr": spec["lr"], "steps": spec["steps"],
        "history": hist, "relaunch_history": again["history"],
        "resumed_from": again["resumed_from"],
        "restored_equal_files": restored_equal,
        "saved_equal_state": live_equal,
        "step_ms": first["step_ms"], "steady_step_ms": first["steady_step_ms"],
        "relaunch_steady_step_ms": again["steady_step_ms"],
        "tokens_per_step": tokens, "tok_s": first["tok_s"],
        "wall_s": first["wall_s"], "peak_bytes": first["peak_bytes"],
        "relaunch_peak_bytes": again["peak_bytes"],
        "checkpoints": saves,
        "ckpt_bytes": saves[0]["bytes"] if saves else None,
        "ckpt_save_s": [s["snapshot_s"] + s["write_s"] for s in saves],
        "model_flops_per_step": flops, "breakdown": breakdown}
    if gpu:
        out["model_flops_s"] = flops / steady_s
        # the dense bf16 peak of the H100 SXM data sheet
        out["model_flops_share"] = flops / steady_s / H100_BF16_FLOPS_S
    return out


def lm_train_breakdown(torch, gpu: bool, trainer, state, batch: int,
                       seq: int, reps: int = 3) -> dict:
    """Where a training step's time goes, on the restored state: the loss
    with its backward pass, `clip_by_global_norm` and the optimizer's
    update, each timed alone (CUDA events on the card, the mean of
    ``reps`` after a warm-up), then one whole step under
    ``torch.profiler``: the kernels' device time against the step's wall
    time (the device's busy share) and the ten kernels that took the
    most."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim.optimizers import clip_by_global_norm
    from repro_torch.train.trainer import _value_and_grad
    model, tc = trainer.model, trainer.tc
    dev = model.device
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab_size,
                                           (batch, seq))).to(dev)
    params = state["params"]
    out = {"loss_backward_ms": lm_timed_ms(
        torch, gpu, lambda: _value_and_grad(model, params,
                                            {"tokens": tokens}), reps)}
    _, grads = _value_and_grad(model, params, {"tokens": tokens})
    out["clip_ms"] = lm_timed_ms(
        torch, gpu, lambda: clip_by_global_norm(grads, tc.grad_clip), reps)
    lr = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    out["optimizer_ms"] = lm_timed_ms(
        torch, gpu, lambda: trainer.opt.update(grads, state["opt_state"],
                                               params, lr), reps)
    del grads
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if gpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer._step_fn(state, {"tokens": tokens})
        if gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels' own entries (an operator's entry also carries the
    # device time of the kernels it launched: summing both counts twice)
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return e.self_device_time_total
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    out.update(profiled_step_ms=wall_ms, device_busy_ms=busy_ms,
               device_busy_share=busy_ms / wall_ms if gpu else None,
               kernel_launches=sum(e.count for e in kernels),
               top_kernels=[[e.key[:90], device_us(e) / 1e3, e.count]
                            for e in sorted(kernels, key=device_us,
                                            reverse=True)[:10]])
    return out


def lm_grads(model, batch: dict) -> tuple:
    """(loss, every parameter's gradient in flatten order) of one
    `TransformerLM.loss`, as the trainer takes them."""
    from repro_torch.train.trainer import _value_and_grad
    from repro_torch.tree import tree_leaves
    loss, grads = _value_and_grad(model, model.param_tree(), batch)
    return loss, tree_leaves(grads)


def host_copy(torch, model, cfg=None):
    """``model`` (or its ``cfg`` twin) over host copies of its
    parameters (copies in the rehearsal too, where ``model`` is on the
    host already)."""
    from repro_torch.models.transformer import TransformerLM
    host = TransformerLM(cfg or model.cfg, device="meta")
    host.load_state_dict({k: v.to("cpu", copy=True)
                          for k, v in model.state_dict().items()},
                         assign=True)
    return host


def lm_train_grad_check(torch, dev, gpu: bool, spec: dict, seed: int) -> dict:
    """(b): one model's loss and every gradient leaf on the card against the
    same computation on the host, in ``spec["twin"]``: max |card - host| /
    max |host| a leaf."""
    import numpy as np

    from repro_torch.models.transformer import TransformerLM
    from repro_torch.tree import tree_flatten
    mcfg = lm_config({"reduced": spec["reduced"]}, spec)
    model = TransformerLM(mcfg, device=dev, generator=torch.Generator(
        dev).manual_seed(seed))
    twin = lm_twin(model, spec["twin"])
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, mcfg.vocab_size, (spec["batch"], spec["seq"]))
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = lm_grads(twin, {k: v.to(dev) for k, v in batch.items()})
    grads = [g.cpu() for g in grads]
    loss = loss.cpu()
    host = host_copy(torch, model, twin.cfg)
    del model, twin
    lm_free(torch, gpu)
    host_loss, host_grads = lm_grads(host, batch)
    # sorted dotted names are the flatten order (keys are [0-9a-z_])
    names = sorted(dict(host.named_parameters()))
    errs = {n: rel_err(g, h) for n, g, h in zip(names, grads, host_grads)}
    worst = max(errs, key=errs.get)
    out = {"arch": spec["arch"], "layers": mcfg.num_layers,
           "twin": spec["twin"], "batch": spec["batch"], "seq": spec["seq"],
           "loss": float(host_loss),
           "loss_rel_err": abs(float(loss) - float(host_loss))
           / abs(float(host_loss)),
           "worst_leaf": worst, "worst_grad_rel_err": errs[worst],
           "finite": all(bool(torch.isfinite(g).all()) for g in grads),
           "grad_rel_err": errs}
    del host, host_grads, grads
    lm_free(torch, gpu)
    check(out["finite"], f"lm train {spec['arch']}: a card gradient is not "
          f"finite")
    check(out["loss_rel_err"] < spec["bound"] and
          out["worst_grad_rel_err"] < spec["bound"],
          f"lm train {spec['arch']} {spec['twin']}: card vs host loss "
          f"{out['loss_rel_err']}, gradient {out['worst_grad_rel_err']} at "
          f"{worst} (bound {spec['bound']})")
    return out


def lm_train_family_checks(torch, dev, gpu: bool, cfg: dict) -> list:
    """(c): one SGD `make_train_step` step of every reduced config on the
    card and on the host from the same parameters and batch: the loss and
    every updated parameter within ``cfg["family_tol"]``, and every
    gradient leaf of the step's loss within the config's bound in
    ``cfg["family_grad_tol"]`` (max |card - host| / max |host| a leaf;
    the step's lr 1e-2 and clip to norm 1 shrink a gradient's error ~50x
    in the parameters). A top-1
    router's gradient is 0 in arithmetic (the renormalized weight is
    p / p), so each side's is rounding noise: it is held below 1e-6 of
    the largest gradient on both sides, as tests/test_torch_train.py
    holds it."""
    import numpy as np

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.conditioning import (FLOAT64, GRAD_CONDITIONED,
                                                 condition)
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import TrainerConfig, make_train_step
    from repro_torch.tree import tree_leaves
    out = []
    tc = TrainerConfig(optimizer="sgd", base_lr=1e-2, warmup_steps=0,
                       total_steps=10)
    for arch in ARCHS:
        cut = ({"dtype": "float64", "cache_dtype": "float64"}
               if arch in FLOAT64 else {})
        mcfg = get_config(arch).reduced(**cut)
        model = TransformerLM(mcfg, device=dev, generator=torch.Generator(
            dev).manual_seed(cfg["seed"]))
        condition(model, cfg["seed"] + 1, arch in GRAD_CONDITIONED)
        host = host_copy(torch, model)
        rng = np.random.default_rng(cfg["seed"])
        batch = {"tokens": rng.integers(1, mcfg.vocab_size, (2, 40))}
        if mcfg.encoder_layers:
            batch["frames"] = rng.standard_normal(
                (2, 16, mcfg.d_model)).astype(np.float32)
        if mcfg.num_prefix_embeds:
            batch["patches"] = rng.standard_normal(
                (2, mcfg.num_prefix_embeds, mcfg.d_model)).astype(np.float32)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        results = []
        for m, b in ((model, {k: v.to(dev) for k, v in batch.items()}),
                     (host, batch)):
            _, grads = lm_grads(m, b)
            opt, step = make_train_step(m, tc)
            params = m.param_tree()
            state = {"params": params, "opt_state": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=m.device)}
            state, metrics = step(state, b)
            results.append((metrics, [g.cpu() for g in grads],
                            tree_leaves(state["params"])))
        (card_m, card_g, card_p), (host_m, host_g, host_p) = results
        # sorted dotted names are the flatten order (keys are [0-9a-z_])
        names = sorted(dict(host.named_parameters()))
        scale = max(float(g.abs().max()) for g in host_g)
        noise, grad_errs = {}, {}
        for n, g, h in zip(names, card_g, host_g):
            if mcfg.num_experts_per_tok == 1 and n.endswith("router"):
                noise[n] = max(float(g.abs().max()),
                               float(h.abs().max())) / scale
            else:
                grad_errs[n] = rel_err(g, h)
        worst = max(grad_errs, key=grad_errs.get)
        bound = cfg["family_grad_tol"][arch]
        summary = {
            "arch": arch, "dtype": mcfg.dtype,
            "conditioned": arch in GRAD_CONDITIONED,
            "loss": float(host_m["loss"]),
            "loss_rel_err": abs(float(card_m["loss"]) - float(host_m["loss"]))
            / abs(float(host_m["loss"])),
            "grad_norm_rel_err": abs(float(card_m["grad_norm"])
                                     - float(host_m["grad_norm"]))
            / float(host_m["grad_norm"]),
            "params_rel_err": max(rel_err(a.detach().cpu(), b.detach())
                                  for a, b in zip(card_p, host_p)),
            "worst_leaf": worst, "worst_grad_rel_err": grad_errs[worst],
            "grad_bound": bound,
            "router_noise": max(noise.values(), default=None)}
        out.append(summary)
        del model, host, results, card_g, host_g
        lm_free(torch, gpu)
        check(summary["loss_rel_err"] < cfg["family_tol"]
              and summary["params_rel_err"] < cfg["family_tol"]
              and summary["worst_grad_rel_err"] < bound
              and all(v < 1e-6 for v in noise.values()),
              f"lm train {arch}: card step vs host: loss "
              f"{summary['loss_rel_err']}, parameters "
              f"{summary['params_rel_err']}, gradient "
              f"{summary['worst_grad_rel_err']} at {worst} (bound {bound}), "
              f"top-1 router noise {noise}")
    return out


def lm_train_moe(torch, dev, gpu: bool, spec: dict, work: Path) -> dict:
    """(d): the launcher on a MoE config at its published widths, cut in
    depth, with adafactor: every logged step finite; the choices dropped
    over capacity counted (each dispatch call: the forward's, and with
    remat the backward's recomputation)."""
    argv = ["--arch", spec["arch"], "--num-layers", str(spec["layers"]),
            "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
            "--steps", str(spec["steps"]), "--optimizer", spec["optimizer"],
            "--lr", str(spec["lr"]), "--data-dir", str(work / "corpus"),
            "--seed", "0", "--device", dev.type] + (
                ["--reduced"] if spec["reduced"] else [])
    with moe_record(torch) as rec:
        report = train_launch(argv, spec["arch"])
    train_history_checks(report, spec["arch"])
    state = report.pop("state")
    from repro_torch.tree import tree_leaves
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)
              if t.is_floating_point()),
          f"lm train {spec['arch']}: a state leaf is not finite")
    del state
    lm_free(torch, gpu)
    shutil.rmtree(work, ignore_errors=True)
    k = lm_config({"reduced": spec["reduced"]}, spec).num_experts_per_tok
    steady_ms = sum(report["step_ms"][1:]) / len(report["step_ms"][1:])
    dropped = sum(float(d.sum()) for d in rec["dropped"])
    tokens = sum(d.numel() for d in rec["dropped"])
    return {"arch": spec["arch"], "layers": spec["layers"],
            "params": report["params"], "batch": spec["batch"],
            "seq": spec["seq"], "optimizer": spec["optimizer"],
            "history": report["history"], "step_ms": report["step_ms"],
            # steps 2 on: the first pays the warm-up
            "steady_step_ms": steady_ms,
            "tok_s": spec["batch"] * spec["seq"] / (steady_ms * 1e-3),
            "peak_bytes": report["peak_bytes"],
            "dispatch_calls": len(rec["dropped"]), "dropped_choices": dropped,
            "tokens_dispatched": tokens,
            "dropped_share": dropped / (tokens * k) if tokens else None,
            "min_router_margin": float(min(m.min() for m in rec["margin"]))}


def lm_train_checks(torch, dev, gpu: bool, cfg: dict, work: Path) -> dict:
    """Phase 18: LM training through `repro_torch.launch.train` and the
    trainer, (a)-(d). No FFT kernel runs."""
    reset_counts()
    out = {}
    t0 = time.monotonic()
    out["full"] = lm_train_full(torch, dev, gpu, cfg["full"], work / "full")
    out["full"]["seconds"] = time.monotonic() - t0
    print("lm train " + json.dumps({k: v for k, v in out["full"].items()
                                    if k not in ("step_ms", "checkpoints")}))
    out["grads"] = []
    for spec in cfg["grads"]:
        t0 = time.monotonic()
        summary = lm_train_grad_check(torch, dev, gpu, spec, cfg["seed"])
        summary["seconds"] = time.monotonic() - t0
        print("lm train card vs cpu " + json.dumps(
            {k: v for k, v in summary.items() if k != "grad_rel_err"}))
        out["grads"].append(summary)
    t0 = time.monotonic()
    out["families"] = lm_train_family_checks(torch, dev, gpu, cfg)
    for summary in out["families"]:
        print("lm train family " + json.dumps(summary))
    print(f"lm train families: {time.monotonic() - t0:.3f} s")
    t0 = time.monotonic()
    out["moe"] = lm_train_moe(torch, dev, gpu, cfg["moe"], work / "moe")
    out["moe"]["seconds"] = time.monotonic() - t0
    print("lm train moe " + json.dumps({k: v for k, v in out["moe"].items()
                                        if k != "step_ms"}))
    counts = read_counts()
    check(not any(counts.values()),
          f"LM training ran an FFT kernel: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 19: LM training on a mesh


def mesh_lm(torch, dev, spec: dict, seed: int):
    """``spec``'s model, drawn from a ``torch.Generator`` seeded with
    ``seed`` and wq, wk rescaled to their true fan-in (`launch/train.py
    --qk-fan-in`)."""
    from repro_torch.models.transformer import TransformerLM
    cfg = lm_config(spec, spec)
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(seed))
    model.rescale_qk_to_fan_in()
    return model


def mesh_trainer_config(spec: dict, ckpt: Path | None):
    """`launch/train.py`'s TrainerConfig for ``launch_steps`` steps, saving
    at ``steps`` into ``ckpt`` (None: no checkpoint), every step
    logged."""
    from repro_torch.train import TrainerConfig
    return TrainerConfig(optimizer=spec["optimizer"], base_lr=spec["lr"],
                         warmup_steps=max(spec["launch_steps"] // 10, 1),
                         total_steps=spec["launch_steps"],
                         ckpt_dir=ckpt and str(ckpt),
                         ckpt_every=spec["steps"], log_every=1)


def full_leaves(state) -> list:
    """Every state leaf whole (a DTensor gathered), in flatten order."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    return [x.full_tensor() if isinstance(x, DTensor) else x.detach()
            for x in tree_leaves(state)]


def leaves_equal(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def mesh_collective_ms(torch, gpu: bool, mesh, trainer, state) -> dict:
    """The mesh step's two collectives over the whole parameter tree, each
    timed alone on ``state``: the gather of every parameter leaf
    (``full_tensor``) and the reduction of float32 gradients of their
    shapes from ``Partial`` onto the parameters' placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.tree import tree_leaves
    params = tree_leaves(state["params"])
    shardings = tree_leaves(trainer.state_shardings(state)["params"])
    grads = [torch.ones(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    batch = trainer.rules.mesh_axes("batch")
    batch = (batch,) if isinstance(batch, str) else tuple(batch or ())
    pl = [Partial() if n in batch else Replicate()
          for n in mesh.mesh_dim_names]

    def gather():
        return [p.full_tensor() for p in params]

    def reduce():
        return [DTensor.from_local(g, mesh, pl).redistribute(
            mesh, sh.placements) for g, sh in zip(grads, shardings)]
    out = {"gather_ms": lm_timed_ms(torch, gpu, gather, 3),
           "reduce_scatter_ms": lm_timed_ms(torch, gpu, reduce, 3),
           "param_bytes": sum(p.numel() * p.element_size() for p in params)}
    del grads
    return out


def step_memory(torch, dev, gpu: bool, trainer, state, batches,
                base: int) -> list:
    """Each of ``batches`` as one step of ``trainer``, then a checkpoint
    save of the state (waited for), with the card's memory read at the end
    of each stage: [[step, stage, peak bytes within the stage, bytes
    allocated at its end], ...], each less ``base`` (the bytes allocated
    before the trainer was made, when the peak was reset), the first row
    the making of the trainer and its state. The
    stages are the step's calls in order: ``gather`` (the mesh's
    `_DataParallel.enter`), ``forward_backward`` (`_value_and_grad`),
    ``reduce_scatter`` (`_DataParallel.reduce`), ``clip``
    (`clip_by_global_norm`), ``optimizer`` (up to `place`, or the step's
    end on one device) and ``place``; then ``checkpoint``. Zeros on the
    CPU."""
    import repro_torch.train.trainer as tm
    rows, step = [], [0]

    def mark(stage):
        if gpu:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
            now = torch.cuda.memory_allocated(dev) - base
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            peak = now = 0
        rows.append([step[0], stage, peak, now])

    def staged(owner, name, stage, before=None):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            if before:
                mark(before)
            out = fn(*a, **k)
            mark(stage)
            return out
        return owner, name, fn, wrapped
    patches = [staged(tm, "_value_and_grad", "forward_backward"),
               staged(tm, "clip_by_global_norm", "clip"),
               staged(tm, "place", "place", before="optimizer"),
               staged(tm._DataParallel, "enter", "gather"),
               staged(tm._DataParallel, "reduce", "reduce_scatter")]
    for owner, name, _, wrapped in patches:
        setattr(owner, name, wrapped)
    try:
        mark("start")
        for i, batch in enumerate(batches, 1):
            step[0] = i
            state, _ = trainer._step_fn(state, batch)
            if trainer.mesh is None:
                mark("optimizer")
        trainer.ckpt.save_async(len(batches), state)
        trainer.ckpt.wait()
        mark("checkpoint")
    finally:
        for owner, name, fn, _ in patches:
            setattr(owner, name, fn)
    return rows


def mesh_train_full(torch, dev, gpu: bool, spec: dict, seed: int, mesh,
                    work: Path, tp_batches: Path) -> dict:
    """(a): phase 18 (a)'s first ``steps`` steps through the one-device
    trainer and through `Trainer(mesh=)` on ``mesh``: the logged losses
    and grad norms and every state leaf bit for bit; each trainer's
    checkpoint restored into the other kind bit for bit; the mesh run's
    step ms, tokens/s and its collectives' ms; each kind's peak memory
    and its memory at each stage (`step_memory`), from a trainer of its
    own alone on the card before the runs; the mesh model's "model" axis
    and the leaves it holds split (over a "model" dim of one here). The
    run's batches are written to ``tp_batches`` for (d)."""
    import numpy as np

    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.launch.train import _StepClock
    from repro_torch.train import Trainer

    arch, steps = spec["arch"], spec["steps"]
    vocab = lm_config(spec, spec).vocab_size
    store = synthetic_corpus(
        work / "corpus", vocab_size=vocab,
        n_tokens=max(4_000_000, spec["batch"] * (spec["seq"] + 1) * 50),
        seed=seed)

    # the run's batches, for (d): its steps and one more, which the loop
    # takes to end
    it = iter(TokenPipeline(store, batch=spec["batch"], seq=spec["seq"]))
    tp_batches.parent.mkdir(parents=True, exist_ok=True)
    np.savez(tp_batches, **{f"{k}_{i}": v for i in range(steps + 1)
                            for k, v in next(it).items()})

    # where each kind's memory goes: two steps of a fresh trainer, then a
    # save, nothing else of this phase on the card
    it = iter(TokenPipeline(store, batch=spec["batch"], seq=spec["seq"]))
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in next(it).items()}
               for _ in range(2)]
    memory = {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        lm_free(torch, gpu)
        base = 0
        if gpu:  # the peak from here: earlier phases' peaks are not its
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(mesh_lm(torch, dev, spec, seed),
                          mesh_trainer_config(spec, work / f"mem_{name}"),
                          mesh=m)
        memory[name] = step_memory(torch, dev, gpu, trainer,
                                   trainer.init_state(), batches, base)
        del trainer
    del batches, it
    lm_free(torch, gpu)

    runs = {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        trainer = Trainer(mesh_lm(torch, dev, spec, seed),
                          mesh_trainer_config(spec, work / f"ckpt_{name}"),
                          mesh=m)
        clock = _StepClock(iter(TokenPipeline(store, batch=spec["batch"],
                                              seq=spec["seq"])), dev)
        t0 = time.monotonic()
        state, hist = trainer.run(trainer.init_state(), iter(clock),
                                  steps=steps)
        wall_s = time.monotonic() - t0
        runs[name] = {"trainer": trainer, "state": state, "hist": hist,
                      "step_ms": clock.step_ms(steps), "wall_s": wall_s,
                      "saves": trainer.ckpt.saves,
                      "split": trainer.model.split_plan,
                      "model_axis": ("tensor" if trainer.model.tp
                                     else "replicated")}
        del trainer, state
    one, on_mesh = runs["one_device"], runs["mesh"]
    metrics = [[h["loss"], h["grad_norm"]] for h in one["hist"]]
    metrics_equal = metrics == [[h["loss"], h["grad_norm"]]
                                for h in on_mesh["hist"]]
    check(metrics_equal, f"lm mesh train {arch}: the (1, 1) mesh's losses "
          f"and grad norms differ from one device's: {metrics}, "
          f"{[[h['loss'], h['grad_norm']] for h in on_mesh['hist']]}")
    want = full_leaves(one["state"])
    got = full_leaves(on_mesh["state"])
    state_equal = leaves_equal(torch, want, got)
    check(state_equal, f"lm mesh train {arch}: the (1, 1) mesh's state "
          f"differs from one device's")
    del got
    collectives = mesh_collective_ms(torch, gpu, mesh, on_mesh["trainer"],
                                     on_mesh["state"])
    mesh_leaves = full_leaves(on_mesh["state"])
    for r in runs.values():
        del r["trainer"], r["state"]
    lm_free(torch, gpu)

    # each checkpoint into the other kind of trainer
    crossed = {}
    for name, m, ckpt, ref in (
            ("mesh_into_one_device", None, "ckpt_mesh", mesh_leaves),
            ("one_device_into_mesh", mesh, "ckpt_one_device", want)):
        trainer = Trainer(mesh_lm(torch, dev, spec, seed + 1),
                          mesh_trainer_config(spec, work / ckpt), mesh=m)
        restored = trainer.restore_or_init()
        crossed[name] = (int(restored["step"]) == steps and leaves_equal(
            torch, full_leaves(restored), ref))
        check(crossed[name], f"lm mesh train {arch}: {name}: the restored "
              f"state differs from the saved one")
        del trainer, restored
        lm_free(torch, gpu)
    del want, mesh_leaves, ref
    lm_free(torch, gpu)

    def steady_ms(run):
        # from the second step on, without the last, which ends in the
        # checkpoint's device->host snapshot
        steady = run["step_ms"][1:-1] or run["step_ms"]
        return sum(steady) / len(steady)
    step_ms = steady_ms(on_mesh)
    tokens = spec["batch"] * spec["seq"]
    from repro_torch.tree import tree_leaves
    return {"arch": arch, "batch": spec["batch"], "seq": spec["seq"],
            "optimizer": spec["optimizer"], "steps": steps,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "model_axis": on_mesh["model_axis"],
            "split_leaves": sum(isinstance(h, int)
                                for h in tree_leaves(on_mesh["split"])),
            "losses": [m[0] for m in metrics],
            "grad_norms": [m[1] for m in metrics],
            "metrics_equal": metrics_equal, "state_equal": state_equal,
            "crossed_equal": crossed,
            "step_ms": on_mesh["step_ms"],
            "one_device_step_ms": one["step_ms"],
            "steady_step_ms": step_ms, "tok_s": tokens / (step_ms * 1e-3),
            "one_device_steady_step_ms": steady_ms(one),
            "peak_bytes": max(r[2] for r in memory["mesh"]),
            "one_device_peak_bytes": max(r[2] for r in memory["one_device"]),
            "ckpt_snapshot_s": [s["snapshot_s"] for s in on_mesh["saves"]],
            "ckpt_write_s": [s.get("write_s") for s in on_mesh["saves"]],
            "step_memory": memory, **collectives}


def mesh_moe_check(torch, dev, gpu: bool, spec: dict, seed: int,
                   tol: float) -> dict:
    """(b): `moe_ep` at ``spec``'s width on a random input of one layer
    (``tokens`` tokens) over the world-size-1 default group on the card,
    against the same call on the host over a gloo group of one, both in
    float64 (the weights float32, as the model keeps them); the card's
    float32 call timed."""
    import torch.distributed as dist

    from repro_torch.models.moe import moe_ep, moe_specs
    from repro_torch.sharding.rules import init_params
    cfg = lm_config(spec, spec)
    gen = torch.Generator(dev).manual_seed(seed)
    p = init_params(moe_specs(cfg), gen, dev)
    x = torch.randn((1, spec["tokens"], cfg.d_model), generator=gen,
                    dtype=torch.float64, device=dev)
    y = moe_ep(cfg, p, x, group=dist.group.WORLD)
    host_group = dist.new_group(backend="gloo")
    want = moe_ep(cfg, {k: v.cpu() for k, v in p.items()}, x.cpu(),
                  group=host_group)
    err = rel_err(y.cpu(), want)
    del y, want
    x32 = x.float()
    ms = lm_timed_ms(torch, gpu, lambda: moe_ep(cfg, p, x32,
                                                group=dist.group.WORLD), 3)
    dist.destroy_process_group(host_group)
    out = {"arch": cfg.name, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
           "tokens": spec["tokens"], "rel_err": err, "tol": tol,
           "float32_ms": ms}
    del p, x, x32
    lm_free(torch, gpu)
    check(err <= tol, f"lm mesh moe_ep {cfg.name}: card vs host {err}")
    return out


def mesh_ranks_start(ranks: int, gpu: bool, work: Path) -> list:
    """Phase 19 (d)-(f)'s ranks (``chip_smoke.py --mesh-rank r``); logs and
    reports under ``work``; they step once ``work / "go"`` exists
    (`wait_for_go`)."""
    store = work / "store"
    store.unlink(missing_ok=True)
    (work / "go").unlink(missing_ok=True)
    procs = []
    for r in range(ranks):
        with open(work / f"rank_{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), "--store", str(store), "--out",
                 str(work / f"rank_{r}.json")]
                + ([] if gpu else ["--rehearse"]),
                stdout=f, stderr=subprocess.STDOUT))
    return procs


def wait_for_go(out: str, seconds: float, what: str) -> None:
    """A rank's wait for the ``go`` file beside its report ``out``."""
    go = Path(out).parent / "go"
    deadline = time.monotonic() + seconds
    while not go.exists():
        check(time.monotonic() < deadline, f"{what}: no go")
        time.sleep(0.05)


def family_name(fam: dict) -> str:
    """A config of MESH_FAMILIES by name: its arch, and its dtype where it
    sets one."""
    return fam["arch"] + (f"/{fam['dtype']}" if fam.get("dtype") else "")


def family_batches(spec: dict, mcfg, seed: int) -> list:
    """(e)'s batches of one family, from a numpy seed: ``steps`` + 1 of
    ``batch`` x ``seq`` tokens (the loop takes one past the last step),
    and whisper's ``batch`` x ``frames`` frame embeddings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(spec["steps"] + 1):
        b = {"tokens": rng.integers(0, mcfg.vocab_size,
                                    (spec["batch"], spec["seq"]))}
        if mcfg.encoder_layers:
            b["frames"] = rng.standard_normal(
                (spec["batch"], spec["frames"], mcfg.d_model)).astype(
                    np.float32)
        out.append(b)
    return out


def family_run(torch, dev, gpu: bool, cfg: dict, fam: dict, work: Path,
               mesh=None, accum: int = 1) -> dict:
    """One config of phase 19's ``tp`` on ``dev``, split over ``mesh``'s
    "model" dim when given, ``tp["steps"]`` steps of `Trainer`. (d), ``fam``
    ``like`` "full": (a)'s model (`mesh_lm`), trainer config and first
    batches (``work / "batches.npz"``). (e), the others: ``fam``'s config
    at ``tp``'s size, drawn from a generator on ``dev`` seeded with the
    phase's seed, conditioned as the tests hold the families (its zeros
    and ones leaves redrawn around their values and its queries and keys
    at their true fan-in, `models.conditioning.condition`), AdamW on
    `family_batches`. ``accum`` > 1: each batch as that many microbatches
    (the same step, summed in another order). The losses, grad norms,
    step ms (CUDA events at each batch) and the peak memory from the
    model's making to the last step."""
    import dataclasses

    import numpy as np

    from repro_torch.launch.train import _StepClock
    from repro_torch.models.conditioning import condition
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves
    tp, seed = cfg["tp"], cfg["seed"]
    steps = tp["steps"]
    if fam.get("like"):
        spec = cfg[fam["like"]]
        data = np.load(work / "batches.npz")
        batches = [{"tokens": torch.as_tensor(data[f"tokens_{i}"]).to(dev)}
                   for i in range(steps + 1)]
    else:
        spec = tp
        mcfg = lm_config(spec, {"dtype": spec.get("dtype"), **fam})
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in family_batches(spec, mcfg, seed)]
    if accum > 1:
        batches = [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                    for k, v in b.items()} for b in batches]
    lm_free(torch, gpu)
    base = 0
    if gpu:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if fam.get("like"):
        model = mesh_lm(torch, dev, spec, seed)
    else:
        model = TransformerLM(mcfg, device=dev, generator=torch.Generator(
            dev).manual_seed(seed))
        condition(model, seed + 1, True)
    mcfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, dataclasses.replace(
        mesh_trainer_config(spec, None), grad_accum=accum), mesh=mesh)
    clock = _StepClock(iter(batches), dev)
    t0 = time.monotonic()
    _, hist = trainer.run(trainer.init_state(), iter(clock), steps=steps)
    out = {"name": family_name(fam), "arch": mcfg.name,
           "layers": mcfg.num_layers, "encoder_layers": mcfg.encoder_layers,
           "params": n_params, "dtype": mcfg.dtype,
           "tokens": spec["batch"] * spec["seq"],
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": clock.step_ms(steps),
           "wall_s": time.monotonic() - t0,
           "model_axis": "tensor" if trainer.model.tp else "replicated",
           "split_leaves": sum(isinstance(h, int) for h in
                               tree_leaves(trainer.model.split_plan or {})),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) - base
                          if gpu else 0)}
    del trainer, model, batches, clock
    lm_free(torch, gpu)
    return out


def full_as_one_device(full: dict, fam: dict, steps: int) -> dict:
    """(d)'s one-device steps: (a)'s record (``full``), its first
    ``steps``, in `family_run`'s keys."""
    return {"name": family_name(fam), "arch": full["arch"],
            "layers": None, "encoder_layers": 0, "params": None,
            "dtype": None, "tokens": full["batch"] * full["seq"],
            "losses": full["losses"][:steps],
            "grad_norms": full["grad_norms"][:steps],
            "step_ms": full["one_device_step_ms"][:steps],
            "peak_bytes": full["one_device_peak_bytes"], "wall_s": None}


def serve_dtypes(cfg: dict, spec: dict) -> tuple:
    """(f)'s dtypes of a config: the served bf16 first, then its own
    second dtype where it names one, else the phase's."""
    return spec.get("dtypes", cfg["serve"]["dtypes"])


def serve_runs(cfg: dict) -> list:
    """(f)'s runs in order: (config index, config, dtype)."""
    return [(i, spec, dtype)
            for i, spec in enumerate(cfg["serve"]["configs"])
            for dtype in serve_dtypes(cfg, spec)]


def serve_model(torch, dev, cfg: dict, spec: dict, dtype: str, mesh=None):
    """(f)'s model of ``spec`` computing in ``dtype`` (its caches too),
    drawn from a generator on ``dev`` seeded with the phase's seed and
    conditioned (`models.conditioning.condition`), split over ``mesh``'s
    "model" dim when given (the default rules)."""
    import dataclasses

    from repro_torch.models.conditioning import condition
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.rules import ShardingRules
    mcfg = dataclasses.replace(lm_config(cfg["serve"], spec), dtype=dtype,
                               cache_dtype=dtype)
    model = TransformerLM(mcfg, device=dev, generator=torch.Generator(
        dev).manual_seed(cfg["seed"]))
    condition(model, cfg["seed"] + 1, True)
    if mesh is not None:
        model.split_over_model(mesh, ShardingRules.default())
    return model


def serve_split_sizes(model) -> dict:
    """The heads, kv heads, d_ff (d_inner for mamba2) and vocabulary rows
    the model holds: a rank's where it is split."""
    out = {}
    for name, p in model.named_parameters():
        for key, suffix, dim in (("heads", "attn.wq", -2),
                                 ("kv_heads", "attn.wk", -2),
                                 ("heads", "tmix.wr", -2),
                                 ("d_ff", ".wi", -1),
                                 ("d_inner", "mamba.wz", -1),
                                 ("vocab", "embed", 0)):
            if name.endswith(suffix) and key not in out:
                out[key] = p.shape[dim]
    return out


def lm_mark(torch, gpu: bool):
    """A point in time: a recorded CUDA event on the card, the host clock in
    the rehearsal (`lm_ms` between two)."""
    if gpu:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def lm_ms(gpu: bool, a, b) -> float:
    """The ms from `lm_mark` ``a`` to ``b`` (waits for ``b`` on the card)."""
    if gpu:
        b.synchronize()
        return a.elapsed_time(b)
    return (b - a) * 1e3


def serve_engine(torch, gpu: bool, model, batch: dict, new: int) -> tuple:
    """`ServeEngine.generate`'s tokens (a list) and its ms, as a user calls
    it."""
    from repro_torch.serve import ServeEngine
    t0 = lm_mark(torch, gpu)
    tokens = ServeEngine(model).generate(batch, new)
    return tokens.cpu().tolist(), lm_ms(gpu, t0, lm_mark(torch, gpu))


def serve_pass(torch, gpu: bool, model, batch: dict, new: int,
               forced=None, base: int = 0) -> dict:
    """Prefill with decode headroom and ``new`` - 1 decode steps, each
    step fed the greedy token (`vocab_argmax`) or, teacher-forced, the
    column of ``forced`` (B, new): the logits of the last position and of
    each step (B, new, V; a rank's block), the greedy tokens, the caches,
    the prefill's and a decode step's ms (CUDA events on the card, the
    host clock in the rehearsal) and the peak memory above ``base`` (the
    bytes allocated before the model was made); for a MoE model ``clean``
    (B, new), the (sequence, step)s
    whose token no layer dropped and routed with a margin of at least
    `MESH_SERVE_MOE_MARGIN` (`moe_record`)."""
    from repro_torch.sharding.tensor_parallel import vocab_argmax
    moe = model.cfg.num_experts > 0
    vocab = model.cfg.vocab_size
    tokens = batch["tokens"]
    s = model.cfg.num_prefix_embeds + tokens.shape[1]
    with torch.inference_mode(), (moe_record(torch) if moe
                                  else contextlib.nullcontext()) as rec:
        model.weights()  # the cast weights, before the peak is reset
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = lm_mark(torch, gpu)
        logits, caches = model.prefill(batch, cache_len=s + new)
        t1 = lm_mark(torch, gpu)
        steps = [logits[:, -1]]
        out = [vocab_argmax(model.tp, steps[-1], vocab)[:, None]]
        for t in range(new - 1):
            tok = out[-1] if forced is None else forced[:, t:t + 1]
            logits, caches = model.decode_step(caches, tok.to(tokens.dtype),
                                               s + t)
            steps.append(logits[:, -1])
            out.append(vocab_argmax(model.tp, steps[-1], vocab)[:, None])
        t2 = lm_mark(torch, gpu)
    b = tokens.shape[0]
    clean = torch.ones((b, new), dtype=torch.bool)
    if moe:  # one record a MoE layer a call: prefill's, then each step's
        layers = len(rec["margin"]) // new
        floor = MESH_SERVE_MOE_MARGIN[model.cfg.dtype]
        for c in range(new):
            for i in range(c * layers, (c + 1) * layers):
                margin = rec["margin"][i].reshape(b, -1)[:, -1]
                dropped = rec["dropped"][i].reshape(b, -1)[:, -1]
                clean[:, c] &= (margin >= floor) & (dropped == 0)
    return {"logits": torch.stack(steps, dim=1), "tokens": torch.cat(out, 1),
            "caches": caches, "prefill_ms": lm_ms(gpu, t0, t1),
            "decode_ms": lm_ms(gpu, t1, t2) / max(new - 1, 1),
            "clean": clean, "peak_bytes": (torch.cuda.max_memory_allocated()
                                           - base if gpu else 0)}


def serve_one_device(torch, dev, gpu: bool, cfg: dict, work: Path) -> list:
    """(f)'s one-device runs: each config of ``serve`` in each dtype served
    whole (`serve_pass`, greedy), its logits, tokens and caches written to
    ``work`` for the ranks, and in bf16 `ServeEngine.generate` timed;
    returns a record a run."""
    from repro_torch.tree import tree_leaves, tree_map
    out = []
    for i, spec, dtype in serve_runs(cfg):
        lm_free(torch, gpu)
        base = torch.cuda.memory_allocated() if gpu else 0
        model = serve_model(torch, dev, cfg, spec, dtype)
        batch = lm_batch(torch, model.cfg, cfg["seed"], spec["batch"],
                         spec["prompt"], spec.get("frames", 0), dev)
        run = serve_pass(torch, gpu, model, batch, spec["new"], base=base)
        torch.save({"logits": run["logits"].cpu(),
                    "tokens": run["tokens"].cpu(), "clean": run["clean"],
                    "caches": tree_map(lambda x: x.cpu(),
                                       run["caches"])},
                   work / f"serve_{i}_{dtype}.pt")
        out.append({"arch": spec["arch"], "dtype": dtype,
                    "layers": model.cfg.num_layers,
                    "tokens": run["tokens"].cpu().tolist(),
                    "prefill_ms": run["prefill_ms"],
                    "decode_ms": run["decode_ms"],
                    "peak_bytes": run["peak_bytes"],
                    "cache_bytes": sum(
                        x.numel() * x.element_size()
                        for x in tree_leaves(run["caches"])),
                    "sizes": serve_split_sizes(model)})
        if dtype == serve_dtypes(cfg, spec)[0]:
            _, out[-1]["generate_ms"] = serve_engine(torch, gpu, model,
                                                     batch, spec["new"])
        del model, run, batch
    lm_free(torch, gpu)
    return out


def serve_run(torch, dev, gpu: bool, cfg: dict, i: int, dtype: str,
              work: Path, mesh) -> dict:
    """(f) on a rank: config ``i`` of ``serve`` in ``dtype`` split over
    ``mesh``'s "model" dim, teacher-forced with one device's greedy tokens
    (``work / serve_<i>_<dtype>.pt``): max|d| / max|one device| of the
    prefill's logits, of each decode step's (the rank's vocabulary block)
    and of each cache leaf's block after the last step (`cache_split`);
    the tokens `vocab_argmax` took; in bf16, `ServeEngine.generate`'s
    tokens and ms; the times, cache bytes and peak memory (one device's
    file is held on the host, outside the peak)."""
    from repro_torch.models.transformer import cache_block
    from repro_torch.tree import flatten_up_to, tree_flatten
    spec = cfg["serve"]["configs"][i]
    lm_free(torch, gpu)
    base = torch.cuda.memory_allocated() if gpu else 0
    model = serve_model(torch, dev, cfg, spec, dtype, mesh)
    batch = lm_batch(torch, model.cfg, cfg["seed"], spec["batch"],
                     spec["prompt"], spec.get("frames", 0), dev)
    one = torch.load(work / f"serve_{i}_{dtype}.pt", map_location="cpu")
    run = serve_pass(torch, gpu, model, batch, spec["new"],
                     one["tokens"].to(dev), base)
    v = run["logits"].shape[-1]  # the rank's block, or the whole vocabulary
    rank = model.tp.rank if model.tp else 0
    want = one["logits"][..., rank * v:(rank + 1) * v] if (
        v < model.cfg.vocab_size) else one["logits"]

    def err(got, ref, rows=None):
        d = (got.double() - ref.to(got.device).double()).abs()
        if rows is not None:  # the sequences held
            d = d[rows.to(d.device)]
        return float(d.max() / (ref.double().abs().max() or 1.0)
                     if d.numel() else 0.0)
    clean = one["clean"].cpu() & run["clean"]
    ones, tdef = tree_flatten(one["caches"])
    hows = flatten_up_to(tdef, model.cache_split())
    mine, _ = tree_flatten(run["caches"])
    rec = {"arch": spec["arch"], "dtype": dtype,
           "prefill_err": err(run["logits"][:, 0], want[:, 0], clean[:, 0]),
           "decode_err": max(err(run["logits"][:, t], want[:, t],
                                 clean[:, t])
                             for t in range(1, spec["new"])),
           "moe_left_out": int((~clean).sum()),
           "cache_err": max(err(m, cache_block(o, h))
                            for m, o, h in zip(mine, ones, hows)),
           "tokens": run["tokens"].cpu().tolist(),
           "prefill_ms": run["prefill_ms"], "decode_ms": run["decode_ms"],
           "peak_bytes": run["peak_bytes"],
           "cache_bytes": sum(x.numel() * x.element_size() for x in mine),
           "split_caches": sum(h is not None for h in hows),
           "sizes": serve_split_sizes(model),
           "model_axis": "tensor" if model.tp else "replicated"}
    del run, one, ones, mine
    if dtype == serve_dtypes(cfg, spec)[0]:
        rec["engine_tokens"], rec["generate_ms"] = serve_engine(
            torch, gpu, model, batch, spec["new"])
    del model
    lm_free(torch, gpu)
    return rec


def mesh_serve_finish(work: Path, ranks: int, one: list, cfg: dict,
                      device: str) -> list:
    """(f)'s checks on the ranks' reports in ``work`` (after
    `mesh_tp_finish`), a config in both its dtypes: the model split over
    "model" on every rank; every error within the config's
    `MESH_SERVE_BOUND`; the ranks' tokens equal at every step
    (teacher-forced and the engine's); the engine's agreement with one
    device's greedy tokens, printed, not held. One `lm mesh serve` line
    and record a config, every line printed before the checks."""
    ranks = [json.loads((work / f"rank_{r}.json").read_text())["serve"]
             for r in range(ranks)]
    out, held = [], []
    runs = serve_runs(cfg)
    for i, spec in enumerate(cfg["serve"]["configs"]):
        rec = {"arch": spec["arch"], "batch": spec["batch"],
               "prompt": spec["prompt"], "new": spec["new"],
               "frames": spec.get("frames"), "ranks": len(ranks),
               "device": device, "runs": {}}
        for k, (_, _, dtype) in enumerate(runs):
            if runs[k][0] != i:
                continue
            got, want = [r[k] for r in ranks], one[k]
            name = spec["arch"] + ("" if dtype == "bfloat16"
                                   else f"/{dtype}")
            bound = cfg["serve"]["bound"].get(name)
            errs = {e: max(g[e] for g in got)
                    for e in ("prefill_err", "decode_err", "cache_err")}
            run = {"bound": bound, **errs, "layers": want["layers"],
                   "moe_left_out": [g["moe_left_out"] for g in got],
                   "prefill_ms": [g["prefill_ms"] for g in got],
                   "one_device_prefill_ms": want["prefill_ms"],
                   "decode_ms": [g["decode_ms"] for g in got],
                   "one_device_decode_ms": want["decode_ms"],
                   "cache_bytes": [g["cache_bytes"] for g in got],
                   "one_device_cache_bytes": want["cache_bytes"],
                   "peak_bytes": [g["peak_bytes"] for g in got],
                   "one_device_peak_bytes": want["peak_bytes"],
                   "split_caches": got[0]["split_caches"],
                   "sizes": got[0]["sizes"],
                   "one_device_sizes": want["sizes"]}
            if "engine_tokens" in got[0]:
                pairs = [(a, b) for ra, rb in zip(got[0]["engine_tokens"],
                                                  want["tokens"])
                         for a, b in zip(ra, rb)]
                run["engine_agreement"] = sum(a == b for a, b in
                                              pairs) / len(pairs)
                run["generate_ms"] = [g["generate_ms"] for g in got]
                run["one_device_generate_ms"] = want["generate_ms"]
            rec["runs"][dtype] = run
            held.append((name, got, errs, bound))
        out.append(rec)
        print("lm mesh serve " + json.dumps(rec))
    for name, got, errs, bound in held:
        check(all(g["model_axis"] == "tensor" for g in got)
              and got[0]["split_caches"] > 0,
              f"lm mesh serve {name}: not split over 'model'")
        check(all(g["tokens"] == got[0]["tokens"]
                  and g.get("engine_tokens") == got[0].get("engine_tokens")
                  for g in got),
              f"lm mesh serve {name}: the ranks' tokens differ")
        check(bound is not None and all(e <= bound for e in errs.values()),
              f"lm mesh serve {name}: split against one device {errs}, "
              f"bound {bound}")
    return out


def mesh_tp_rank(rank: int, store: str, out: str, gpu: bool) -> int:
    """A rank of phase 19 (d)-(f) (``chip_smoke.py --mesh-rank``), one of
    a gloo group of ``tp["ranks"]`` processes on the one card, a (1,
    ranks) ("data", "model") mesh: each config of ``tp`` split over
    "model" (`family_run`; no checkpoint: a save would gather), then each
    config of ``serve`` (`serve_run`), once a ``go`` file beside ``out``
    says the card is free (the ranks start beside (b) and wait through it
    and the one-device runs). Writes each config's record."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    cfg = (FULL if gpu else REHEARSE)["mesh_train"]
    dev = torch.device("cuda", 0) if gpu else torch.device("cpu")
    if gpu:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = cfg["tp"]["ranks"]
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh(dev.type, (1, n),
                                mesh_dim_names=("data", "model"))
        wait_for_go(out, 900, "lm mesh tp")
        work = Path(out).parent
        report = {"rank": rank, "ranks": n, "runs": [
            family_run(torch, dev, gpu, cfg, fam, work, mesh)
            for fam in cfg["tp"]["configs"]]}
        report["serve"] = [serve_run(torch, dev, gpu, cfg, i, dtype, work,
                                     mesh)
                           for i, _, dtype in serve_runs(cfg)]
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(report))
    return 0


def mesh_tp_finish(procs: list, work: Path, bound_s: float, one: list,
                   cfg: dict) -> list:
    """Waits for (d)-(e)'s ranks up to ``bound_s`` (a rank that outlives it
    is stopped) and holds each config: every rank exits 0 with the same
    losses and grad norms, each step within the config's bound of its
    one-device steps (``one``), the model split over "model" and each
    rank's peak memory below one device's. Returns a record a config."""
    deadline = time.monotonic() + bound_s
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    exits = [p.returncode for p in procs]
    logs = [(work / f"rank_{r}.log").read_text()[-1500:]
            for r in range(len(procs))]
    check(not any(exits), f"lm mesh tp: a rank failed, exits {exits}: "
          f"{logs}")
    ranks = [json.loads((work / f"rank_{r}.json").read_text())["runs"]
             for r in range(len(procs))]

    def steady(ms):
        return sum(ms[1:]) / max(len(ms) - 1, 1)
    out = []
    for i, want in enumerate(one):
        got = [r[i] for r in ranks]
        name, bound = want["name"], cfg["tp"]["bound"][want["name"]]
        err = {k: [abs(g - w) / abs(w) for g, w in zip(got[0][k], want[k])]
               for k in ("losses", "grad_norms")}
        # each metric's limit a step: the bound, and past the bound's
        # held_steps the model's own spread times MESH_SPREAD_FACTOR where
        # that is larger
        held = bound.get("held_steps", len(err["losses"]))
        spread = want.get("own_spread")
        limits = {k: [bound[m] if j < held else max(
            bound[m], MESH_SPREAD_FACTOR * spread[k][j])
            for j in range(len(err[k]))]
            for k, m in (("losses", "loss"), ("grad_norms", "grad_norm"))}
        rec = {"name": name, "arch": want["arch"], "ranks": len(got),
               "exits": exits, "layers": got[0]["layers"],
               "encoder_layers": got[0]["encoder_layers"],
               "params": got[0]["params"], "dtype": got[0]["dtype"],
               "tokens": want["tokens"], "model_axis": got[0]["model_axis"],
               "split_leaves": got[0]["split_leaves"],
               "losses": got[0]["losses"], "grad_norms": got[0]["grad_norms"],
               "one_device_losses": want["losses"],
               "one_device_grad_norms": want["grad_norms"],
               "loss_rel_err": err["losses"],
               "grad_norm_rel_err": err["grad_norms"], "bound": bound,
               "limits": limits, "own_spread": spread,
               "step_ms": [g["step_ms"] for g in got],
               "steady_step_ms": steady(got[0]["step_ms"]),
               "one_device_step_ms": want["step_ms"],
               "one_device_steady_step_ms": steady(want["step_ms"]),
               "peak_bytes": [g["peak_bytes"] for g in got],
               "one_device_peak_bytes": want["peak_bytes"],
               "wall_s": [g["wall_s"] for g in got],
               "one_device_wall_s": want["wall_s"],
               "control": want.get("control")}
        out.append(rec)
        check(all(g["losses"] == got[0]["losses"]
                  and g["grad_norms"] == got[0]["grad_norms"] for g in got),
              f"lm mesh tp {name}: the ranks' metrics differ: {got}")
        check(got[0]["model_axis"] == "tensor" and got[0]["split_leaves"] > 0,
              f"lm mesh tp {name}: the model is not split over 'model'")
        check(len(got[0]["losses"]) == len(want["losses"])
              and all(e <= m for k in err
                      for e, m in zip(err[k], limits[k])),
              f"lm mesh tp {name}: the (1, {len(got)}) step against one "
              f"device's: {err}, limits {limits}")
        check(all(g["peak_bytes"] < want["peak_bytes"] for g in got)
              or not want["peak_bytes"],
              f"lm mesh tp {name}: a rank's peak memory is not below one "
              f"device's: {[g['peak_bytes'] for g in got]}, "
              f"{want['peak_bytes']}")
    return out


def mesh_train_checks(torch, dev, gpu: bool, cfg: dict, work: Path) -> dict:
    """Phase 19: LM training on a mesh, (a), (b), and (d)-(e), whose ranks
    start beside (b) and step alone on the card after this process's
    one-device runs, then serve (f) against this process's one-device
    serving. No FFT kernel runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    reset_counts()
    card = device_line() if gpu else "cpu (rehearsal)"
    ranks = work / "ranks"
    shutil.rmtree(ranks, ignore_errors=True)
    ranks.mkdir(parents=True)
    out, procs = {}, []
    try:
        store = one_rank_group(torch, gpu)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            t0 = time.monotonic()
            out["full"] = mesh_train_full(torch, dev, gpu, cfg["full"],
                                          cfg["seed"], mesh, work / "full",
                                          ranks / "batches.npz")
            out["full"].update(seconds=time.monotonic() - t0, device=card)
            print("lm mesh train " + json.dumps(out["full"]))
            t0 = time.monotonic()
            procs = mesh_ranks_start(cfg["tp"]["ranks"], gpu, ranks)
            out["moe"] = mesh_moe_check(torch, dev, gpu, cfg["moe"],
                                        cfg["seed"], cfg["moe_tol"])
            out["moe"].update(seconds=time.monotonic() - t0, device=card)
            print("lm mesh moe_ep " + json.dumps(out["moe"]))
        finally:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)
        lm_free(torch, gpu)
        # (d)-(e): each config's one-device steps, then its split steps
        t0 = time.monotonic()
        steps = cfg["tp"]["steps"]
        one = []
        for fam in cfg["tp"]["configs"]:
            if fam.get("like"):
                one.append(full_as_one_device(out["full"], fam, steps))
                continue
            one.append(family_run(torch, dev, gpu, cfg, fam, ranks))
            if fam.get("control"):  # the model's own spread: the same
                # steps on one device, the batch as two microbatches
                ctl = family_run(torch, dev, gpu, cfg, fam, ranks, accum=2)
                one[-1]["own_spread"] = {
                    k: [abs(c - w) / abs(w) for c, w in zip(ctl[k],
                                                            one[-1][k])]
                    for k in ("losses", "grad_norms")}
                one[-1]["control"] = {k: ctl[k] for k in (
                    "losses", "grad_norms", "step_ms")}
        # (f): each config served whole on one device, in each dtype
        t1 = time.monotonic()
        serve_one = serve_one_device(torch, dev, gpu, cfg, ranks)
        out["serve_one_device_seconds"] = time.monotonic() - t1
        (ranks / "go").write_text("go")
        out["tp"] = mesh_tp_finish(procs, ranks, 900, one, cfg)
        for rec in out["tp"]:
            rec["device"] = card
            print("lm mesh tp " + json.dumps(rec))
        out["serve"] = mesh_serve_finish(ranks, len(procs), serve_one, cfg,
                                         card)
        out["tp_seconds"] = time.monotonic() - t0
    finally:
        for p in procs:  # stopped where (a) or (b) failed
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work / "full", ignore_errors=True)
    counts = read_counts()
    check(not any(counts.values()),
          f"LM training on a mesh ran an FFT kernel: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the LM dryrun


def lm_dryrun_sweeps(cfg: dict, out: Path) -> tuple[dict, list]:
    """(a): ``python -m repro_torch.launch.sweep --archs <arch>`` as a user
    runs it, over both production meshes and every shape, and over the
    one_card cells (b) and (c) read; one sweep a (mesh, shape), all
    started together (each cell's step runs on meta in one Python
    thread). Returns ({(mesh, shape): record}, the sweeps' status
    lines)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    jobs = [(m, s) for m in cfg["meshes"] for s in cfg["shapes"]]
    jobs += [("one_card", s) for s in cfg["card_shapes"]]
    procs = []
    try:
        for mesh, shape in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.sweep",
                 "--archs", cfg["arch"], "--meshes", mesh, "--shapes",
                 shape, "--out", str(out), "--timeout",
                 str(cfg["cell_timeout_s"])],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + cfg["timeout_s"]
        lines = []
        for (mesh, shape), proc in zip(jobs, procs):
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            check(proc.returncode == 0, f"sweep {mesh} {shape}: exit "
                  f"{proc.returncode}: {stdout[-2000:]}{stderr[-2000:]}")
            lines += [ln for ln in stdout.splitlines() if ln.startswith("[")]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    recs = {(m, s): json.loads(
        (out / f"{cfg['arch']}__{s}__{m}.json").read_text())
        for m, s in jobs}
    return recs, lines


def lm_dryrun_checks(torch, dev, gpu: bool, cfg: dict, work: Path) -> dict:
    """Phase 20: the LM dryrun. (a) the sweep (`lm_dryrun_sweeps`): every
    cell ok, long_500k skipped with the reference's reason for a pure
    attention arch, finite positive FLOPs and bytes; (b) the one_card
    decode cell built whole on the card (`dryrun.card_check`): its
    tensors' bytes equal the record's, the allocator's growth within its
    rounding, the step's FLOPs under FlopCounterMode equal the record's,
    its ms beside the record's terms; (c) the one_card train cell's state
    from ``Trainer.init_state`` on the card: bytes equal the record's. No
    FFT kernel runs. Every cell records ``"model_axis": "tensor"``, with
    all_reduce bytes over "model" off one card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import cell_runnable
    reset_counts()
    t0 = time.monotonic()
    recs, lines = lm_dryrun_sweeps(cfg, work)
    out = {"device": device_line() if gpu else "cpu (rehearsal)",
           "sweep_s": time.monotonic() - t0, "status": lines, "cells": []}
    runnable = {s: cell_runnable(get_config(cfg["arch"]), s)
                for s in cfg["shapes"]}
    for (mesh, shape), rec in recs.items():
        ok, reason = runnable[shape]
        if not ok:
            check(rec.get("skipped") and rec["reason"] == reason,
                  f"{mesh} {shape}: not skipped with the reference's reason")
            out["cells"].append({"mesh": mesh, "shape": shape,
                                 "skipped": True})
            continue
        check(rec["ok"] and not rec.get("skipped"),
              f"{mesh} {shape}: {rec.get('error')}")
        cost, mem = rec["cost"], rec["memory"]
        for k in ("flops", "bytes_accessed"):
            check(math.isfinite(cost[k]) and cost[k] > 0,
                  f"{mesh} {shape}: {k} {cost[k]}")
        check(mem["total_bytes"] > 0, f"{mesh} {shape}: no bytes")
        # qwen2-0.5b's cells compute split over "model" (its d_ff and
        # vocabulary; its 14 heads and 2 kv heads stay whole at 16)
        check(cost["model_axis"] == "tensor"
              and (cost["model_all_reduce_bytes"] > 0) == (
                  mesh != "one_card"),
              f"{mesh} {shape}: model_axis {cost['model_axis']}, "
              f"{cost['model_all_reduce_bytes']} bytes all-reduced")
        out["cells"].append({
            "mesh": mesh, "shape": shape, "model_axis": cost["model_axis"],
            "model_all_reduce_bytes": cost["model_all_reduce_bytes"],
            "port_caches_bytes": mem.get("port_caches_bytes"),
            "build_s": rec["build_s"],
            "cost_s": rec["cost_s"], "rows_per_device":
            cost["rows_per_device"], "flops": cost["flops"],
            "model_flops": cost["model_flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "collective_bytes": cost["collective_bytes"],
            "total_bytes": mem["total_bytes"], "bound": cost["bound"],
            **{k: cost[k] for k in ("compute_s", "memory_s",
                                    "collective_s")}})
    if gpu:
        lm_free(torch, gpu)
        out["card_decode"] = lm_dryrun_card(
            torch, dev, recs["one_card", "decode_32k"], cfg["reps"])
        lm_free(torch, gpu)
        out["card_train_state"] = lm_dryrun_card(
            torch, dev, recs["one_card", "train_4k"], cfg["reps"])
        lm_free(torch, gpu)
    counts = read_counts()
    check(not any(counts.values()),
          f"the LM dryrun ran an FFT kernel: {counts}")
    out["seconds"] = time.monotonic() - t0
    return out


def lm_dryrun_card(torch, dev, rec: dict, reps: int) -> dict:
    """(b) or (c): ``dryrun.card_check`` of a one_card record, held to it."""
    from repro_torch.launch import dryrun
    got = dryrun.card_check(rec, device=dev, reps=reps)
    mem, what = rec["memory"], f"{rec['shape']} on the card"
    # train: the state, without the step's inputs
    kinds = (["params", "opt_state", "step"] if rec["mode"] == "train"
             else ["params", "caches", "inputs"])
    for k in kinds:
        k = f"{k}_bytes"
        check(got[k] == mem[k], f"{what}: {k} {got[k]} != {mem[k]}")
    check(got["tensor_bytes"] == sum(mem[f"{k}_bytes"] for k in kinds),
          f"{what}: {got['tensor_bytes']} bytes of tensors")
    slack = got["allocated_bytes"] - got["tensor_bytes"]
    check(0 <= slack <= got["rounding_bytes"],
          f"{what}: allocated {got['allocated_bytes']} for "
          f"{got['tensor_bytes']} bytes of tensors (rounding at most "
          f"{got['rounding_bytes']})")
    got["allocator_slack_bytes"] = slack
    if "flops" in got:
        cost = rec["cost"]
        check(got["flops"] == cost["flops"],
              f"{what}: {got['flops']} FLOPs, the record {cost['flops']}")
        got.update(memory_ms=cost["memory_s"] * 1e3,
                   compute_ms=cost["compute_s"] * 1e3,
                   read_once_ms=mem["total_bytes"] / HBM_BYTES_S * 1e3,
                   analytic_bytes=mem["total_bytes"])
    return got


def model_rates(timing: dict, ooc_run: dict, a2a_bps: float) -> dict:
    """The tuner model's CUDA rates as this run measures them
    (fft/tuner.py MODEL_RATES): K1b's main-path case's flops and bytes over
    its time; the one-rank all_to_all_single's bytes over its time; the
    at-scale out-of-core run's storage traffic over its read and write
    thread-seconds, and its other stage thread-seconds over its jobs."""
    k1 = timing["matfft/four_step"]
    sec = k1["ms"] * 1e-3
    stages = ooc_run["stage_s"].values()
    io_s = sum(st["read"] + st["write"] for st in stages)
    other_s = sum(v for st in stages for k, v in st.items()
                  if k not in ("read", "write"))
    return {"peak_flops": k1["flops"] / sec, "hbm_bps": k1["bytes"] / sec,
            "ici_bps": a2a_bps, "disk_bps": ooc_run["io"]["total"] / io_s,
            "job_overhead_s": other_s / sum(ooc_run["attempts"].values())}



def shape_kernel_launches(cases, measured: dict) -> dict:
    """Measured launches of each timed case of ``cases`` over the runs in
    ``measured``, under its name in the `kernels` line."""
    launches = {}
    for _, kernel, shape, opts, name in cases:
        if name:
            key = case_key(kernel, shape, opts)
            launches[name] = sum(run[key] for run in measured.values())
    return launches



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU through the plain versions "
                         "(checks control flow; prints no result line)")
    ap.add_argument("--follower", type=int, default=None,
                    help="run as this rank of phase 15's service (started "
                         "by phase 15 itself, with --store and --out)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help="run as this rank of phase 19 (d)-(f)'s gloo "
                         "group (started by phase 19 itself, with --store "
                         "and --out)")
    ap.add_argument("--store", help="phase 15's or 19's FileStore")
    ap.add_argument("--out", help="a follower's or rank's report")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    gpu = not args.rehearse
    if gpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.follower is not None:
        return mesh_serve_follower(args.follower, args.store, args.out, gpu)
    if args.mesh_rank is not None:
        return mesh_tp_rank(args.mesh_rank, args.store, args.out, gpu)
    cfg = FULL if gpu else REHEARSE
    dev = torch.device("cuda", 0) if gpu else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    from repro_torch.core.pipeline import BlockStore
    from repro_torch.kernels import build
    from repro_torch.kernels.fft import plan as kplan

    # phase 1: device
    smi = device_line() if gpu else "cpu (rehearsal)"
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    if gpu:
        t0 = time.monotonic()
        reports = build.build_all()
        print(f"build: {time.monotonic() - t0:.3f} s")
        for name, log in reports.items():
            for line in log.splitlines():
                if any(k in line for k in ("registers", "Compiling entry",
                                           "spill", "smem")):
                    print(f"ptxas[{name}] {line.strip()}")
        from repro_torch.kernels.fft import matfft as km
        for L in (1024, 2048, kplan.MAX_LEAF):
            K, n = km.cols_clusters_resident(L)
            print(f"K2 clusters resident at L={L}: {n} of {K} blocks "
                  f"(cudaOccupancyMaxActiveClusters)")

    # phase 3: kernels against plain and torch.fft, timed
    t0 = time.monotonic()
    checks, inv, timing = kernel_checks(torch, dev, cfg, gpu)
    print(f"kernel phase: {time.monotonic() - t0:.3f} s")

    # phases 4-5: the main path, one run per K1/K2 variant, one past
    # MAX_LEAF**2 and two through K4
    work_root = ROOT / "build" / "smoke"
    shutil.rmtree(work_root, ignore_errors=True)
    device_arg = ["--device", "cuda" if gpu else "cpu"]
    launches, runs, spectrograms, ooc = {}, [], [], {}
    try:
        for name, kernel, job_args in cfg["runs"]:
            work = work_root / name.replace("/", "_")
            reset_counts()
            report = run_job([*job_args, "--pipelined", *device_arg,
                              "--work-dir", str(work)])
            counts = read_counts()
            fft_len = int(job_args[job_args.index("--fft-len") + 1])
            worst = check_job_output(torch, dev, work, fft_len)
            summary = {"run": name, "args": job_args,
                       "job_s": report["job_s"],
                       "overlap_x": report["overlap_x"],
                       "gb_per_s": report["gb_per_s"],
                       "stage_s": report["stage_s"],
                       "batches": report["batches"],
                       "blocks": report["blocks"], "launches": counts,
                       "worst_block_rel_err": worst}
            print("main path " + json.dumps(summary))
            runs.append(summary)
            check_main_path(gpu, name, counts, kernel)
            launches[name] = counts[kernel]
            shutil.rmtree(work, ignore_errors=True)

        # serial against pipelined, bitwise
        merged = {}
        for mode in ("serial", "pipelined"):
            work = work_root / f"bitwise_{mode}"
            extra = ["--pipelined"] if mode == "pipelined" else []
            report = run_job([*cfg["serial"], *extra, *device_arg,
                              "--work-dir", str(work)])
            merged[mode] = (work / "merged.bin").read_bytes()
            print(f"bitwise {mode}: job_s {report['job_s']}, "
                  f"batches {report['batches']}, blocks {report['blocks']}")
        equal = merged["serial"] == merged["pipelined"]
        print(f"serial vs pipelined merged outputs: "
              f"{'bitwise equal' if equal else 'DIFFERENT'} "
              f"({len(merged['serial'])} bytes)")
        check(equal, "serial and pipelined outputs differ")
        del merged

        # phase 6: out of core, at scale through the CLI, then bitwise and
        # after a resume, then the paper's size analytically
        t0 = time.monotonic()
        ooc = {"at_scale": ooc_at_scale(torch, dev, gpu, cfg["ooc"],
                                        work_root / "ooc", device_arg)}
        launches["matfft_cols/direct"] += ooc["at_scale"]["launches"][
            "matfft_cols"]
        shutil.rmtree(work_root / "ooc", ignore_errors=True)
        ooc["bitwise"] = ooc_bitwise_and_resume(torch, dev, gpu, cfg["ooc"],
                                                work_root / "ooc_bitwise")
        launches["matfft/four_step"] += ooc["bitwise"]["launches"]
        shutil.rmtree(work_root / "ooc_bitwise", ignore_errors=True)
        ooc["paper"] = ooc_paper_size()
        ooc["seconds"] = time.monotonic() - t0
        print(f"out-of-core phase: {ooc['seconds']:.3f} s")

        # phase 7: the spectrogram job over a real capture, once per frame
        t0 = time.monotonic()
        capture = synth_capture(torch, dev, cfg["capture_samples"])
        store = BlockStore(work_root / "capture",
                           block_bytes=4 * cfg["block_samples"])
        store.put_bytes(capture)
        del capture
        print(f"capture: {cfg['capture_samples']} samples at {SR} Hz in "
              f"{len(store.blocks)} blocks, set up in "
              f"{time.monotonic() - t0:.3f} s")
        for variant, frame, hop in cfg["spectrograms"]:
            work = work_root / f"spectrogram_{frame}"
            summary = spectrogram_run(torch, dev, gpu, store, work, variant,
                                      frame, hop)
            spectrograms.append(summary)
            launches[variant] = summary["launches"]["rfft_leaf"]
            shutil.rmtree(work, ignore_errors=True)
    finally:
        shutil.rmtree(work_root, ignore_errors=True)

    # phase 8: fft_conv
    conv = conv_checks(torch, dev, gpu, cfg["conv"])

    # phase 9: N-D transforms
    t0 = time.monotonic()
    nd, nd_measured = nd_checks(torch, dev, gpu, cfg)
    nd["seconds"] = time.monotonic() - t0
    print(f"N-D phase: {nd['seconds']:.3f} s")

    # phases 10-12 on one world-size-1 group (NCCL on the card)
    import torch.distributed as dist
    store = one_rank_group(torch, gpu)
    try:
        # phase 10: the segmented and 1-D distributed placements
        t0 = time.monotonic()
        dist_summary, dist_measured = dist_checks(torch, dev, gpu, cfg)
        dist_summary["seconds"] = time.monotonic() - t0
        print("dist " + json.dumps(dist_summary))
        print(f"distributed phase: {dist_summary['seconds']:.3f} s")

        # phase 11: the 2-D/3-D pencils and fallback="degrade"
        t0 = time.monotonic()
        pencil, pencil_measured = pencil_checks(torch, dev, gpu, cfg)
        pencil["seconds"] = time.monotonic() - t0
        print(f"pencil phase: {pencil['seconds']:.3f} s")

        # phase 12: the service
        t0 = time.monotonic()
        serve, serve_measured = serve_checks(torch, dev, gpu, cfg)
        serve["seconds"] = time.monotonic() - t0
        print(f"service phase: {serve['seconds']:.3f} s")

        # phase 13: the measuring autotuner
        t0 = time.monotonic()
        try:
            tune, tune_measured, tune_checked, tune_timing = tuner_checks(
                torch, dev, gpu, cfg, work_root / "tune")
        finally:
            shutil.rmtree(work_root / "tune", ignore_errors=True)
        tune["seconds"] = time.monotonic() - t0
        print(f"tuner phase: {tune['seconds']:.3f} s")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    # phase 14: bench_pipeline's gate on the throttled disk
    t0 = time.monotonic()
    try:
        pipeline, pipeline_measured = pipeline_gate(
            torch, dev, gpu, cfg, work_root / "pipeline")
    finally:
        shutil.rmtree(work_root / "pipeline", ignore_errors=True)
    pipeline["seconds"] = time.monotonic() - t0
    print(f"pipeline phase: {pipeline['seconds']:.3f} s")

    # phase 15: the service over several ranks on the one card
    t0 = time.monotonic()
    try:
        mesh_serve, mesh_measured, follower_calls = mesh_serve_checks(
            torch, dev, gpu, cfg, work_root / "mesh_serve", serve["runs"])
    finally:
        shutil.rmtree(work_root / "mesh_serve", ignore_errors=True)
    mesh_serve["seconds"] = time.monotonic() - t0
    print(f"mesh service phase: {mesh_serve['seconds']:.3f} s")

    # phase 16: fft_dryrun's analytic records
    dryrun = dryrun_records()
    for mesh, doc in dryrun.items():
        print(f"dryrun {mesh} " + json.dumps(doc))

    # phase 17: LM serving
    t0 = time.monotonic()
    lm = lm_checks(torch, dev, gpu, cfg["lm"])
    lm["seconds"] = time.monotonic() - t0
    print(f"LM serving phase: {lm['seconds']:.3f} s")

    # phase 18: LM training
    t0 = time.monotonic()
    try:
        lm_train = lm_train_checks(torch, dev, gpu, cfg["lm_train"],
                                   work_root / "train")
    finally:
        shutil.rmtree(work_root / "train", ignore_errors=True)
    lm_train["seconds"] = time.monotonic() - t0
    print(f"LM training phase: {lm_train['seconds']:.3f} s")

    # phase 19: LM training on a mesh
    t0 = time.monotonic()
    try:
        mesh_train = mesh_train_checks(torch, dev, gpu, cfg["mesh_train"],
                                       work_root / "mesh_train")
    finally:
        shutil.rmtree(work_root / "mesh_train", ignore_errors=True)
    mesh_train["seconds"] = time.monotonic() - t0
    print(f"LM mesh training phase: {mesh_train['seconds']:.3f} s")

    # phase 20: the LM dryrun
    try:
        lm_dryrun = lm_dryrun_checks(torch, dev, gpu, cfg["lm_dryrun"],
                                     work_root / "lm_dryrun")
    finally:
        shutil.rmtree(work_root / "lm_dryrun", ignore_errors=True)
    print("lm dryrun " + json.dumps(lm_dryrun))
    print(f"LM dryrun phase: {lm_dryrun['seconds']:.3f} s")

    # the launches of phases 9-15: by variant, and by timed shape
    measured = {**nd_measured, **dist_measured, **pencil_measured,
                **serve_measured, **tune_measured, **pipeline_measured,
                **mesh_measured, "mesh serve followers": follower_calls}
    for run in measured.values():
        for key, k in run.items():
            variant = variant_of(key)
            launches[variant] = launches.get(variant, 0) + k
    launches.update(shape_kernel_launches(nd_kernel_cases(cfg), measured))
    launches.update(shape_kernel_launches(dist_kernel_cases(cfg),
                                          dist_measured))
    launches.update(shape_kernel_launches(pencil_kernel_cases(cfg),
                                          pencil_measured))
    launches.update(shape_kernel_launches(serve_kernel_cases(cfg),
                                          serve_measured))
    for n, name in k1_length_names(cfg, kplan.MAX_LEAF).items():
        key = ("matfft", (cfg["points"] // n, n), None)
        launches[name] = sum(run.get(key, 0) for run in measured.values())
    for shape, name in k3_length_names(cfg).items():
        key = ("rfft_leaf", shape, None)
        launches[name] = sum(run.get(key, 0) for run in measured.values())
    timing.update(tune_timing)
    # every call of phases 9-15 was held to its plain version in phase 3
    # (the tuner's other calls in phase 13) at its own shape
    covered = {case_key(kernel, shape, opts) for _, kernel, shape, opts, _
               in kernel_cases(cfg, kplan.MAX_LEAF)} | tune_checked
    for name, run in measured.items():
        missing = sorted(set(run) - covered)
        check(not missing, f"{name}: calls with no phase 3 case: {missing}")

    if not gpu:
        print(f"rehearsal passed in {time.monotonic() - t_start:.1f} s")
        return 0

    rates = model_rates(timing, ooc["at_scale"], tune["a2a_bytes_s"])
    print("model rates " + json.dumps(rates))

    # phase 21: the kernels line; every K2 row launched on the main path
    for name, t in timing.items():
        if "cluster" in t:
            check(launches.get(name, 0) > 0,
                  f"kernels line: {name} never launched on the main path")
    kernels = kernel_line(timing, launches)
    result = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks": checks,
              "batch_invariance": inv, "main_path": runs,
              "out_of_core": ooc, "spectrograms": spectrograms,
              "fft_conv": conv, "nd": nd, "dist": dist_summary,
              "pencil": pencil, "serve": serve, "tune": tune,
              "pipeline": pipeline, "mesh_serve": mesh_serve,
              "dryrun": dryrun, "lm": lm, "lm_train": lm_train,
              "mesh_train": mesh_train, "lm_dryrun": lm_dryrun,
              "model_rates": rates,
              "kernels": kernels, "timing": timing,
              "seconds": time.monotonic() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(f"seconds: {result['seconds']:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
