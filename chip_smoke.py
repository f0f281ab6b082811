#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`viditq_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every CUDA kernel from `viditq_tpu_torch/csrc` (one
     nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version at the
     main-path shapes of both slices (STDiT-XL/2 16x512x512 video and
     PixArt-Σ 1024x1024, CFG batch 2), with code mismatch, max code
     difference, relative error, the median time of both from CUDA
     events, the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time (for the
     int8 GEMMs also torch._int_mm on a row-major weight and cuBLAS bf16
     at the same shape, and K2's emission split into its GEMM and its
     group quantize, and its emission after either zero-point epilogue,
     asym acts and sym acts x asym weights, identical to its plain
     version; K1, K4, K3's seg mode and K7a also back to back);
     then K3 and K6 at the edge cases of their shared core (`EDGE_CASES`: ragged q
     and kv tiles, a kv block masked whole, head dim 16) and of K3's two
     seg kernels (seg 2 to 16 with ragged last tiles and asym emission on
     the tiled kernel; seg 48 and 1088, int8 PV past 1040 kv rows and
     both emissions, on the row kernel), and K2 and K7b at theirs (`GEMM_EDGE_CASES`: ragged M
     and N, K tails, a gw_x group boundary inside a k-tile, the byte-wise
     kernel), every K2 and K7b case identical to its plain version;
     The asymmetric modes (K1/K4 asym with row sums, K4's GELU, K2's
     zero-point epilogues, K5 asym, K3's and K6's asym emission) run at
     the fused reference plan's main-path shapes; then K1 and K4 at the
     edge cases of their row layouts (`ROW_EDGE_CASES`: f32 input, ragged
     and unaligned rows, K5's 240 rows, the GELU on 19 rows, rows of
     zeros, rows read in passes, C = 64, a batch boundary inside a block),
     each with the main cases' tolerance; K5 in every mode identical to
     the K4 -> K2 route composed in the same run, timed beside it and
     cuBLAS bf16, also at `K5_EDGE_CASES` (ragged tiles, narrow and
     unaligned K, f32 input, zero rows, wide K and N % 16 != 0), and at
     fc2's [32768, 4608] x [4608, 1152] (`k5_wide_cases`); the
     column-scale modes of channel balancing (CB) at the `cb` arms'
     shapes (`cb_cases`: K4 and K5 identical, K5 to the K4 -> K2 route,
     K3's emission at the three sites, K2's emission identical, K6's
     emission through K4 and K5 at the patch embed and final linear of the
     Σ `cb` arm), each
     timed back to back beside the same call without the column scale;
     the residual (+ gate) epilogue of K2 (every mode it composes with)
     and K5 (identical to K4 -> K2 with it) at the sm8_epi arm's shapes,
     and the attn8 arm's K8 (identical) and K3 with int8_qk at its three
     sites; K3's float32 mode (`csrc/attention_f32.cu`, AdaRound's float32
     block; full and kv-masked on the float32 core, `csrc/
     attn_f32_core.cuh`, seg on its own kernel) at the reconstruction's
     three sites (spatial [32, 1024, 16, 72], temporal seg 16 [2, 16384,
     16, 72], cross to 120 prompt tokens with 20 padded) and its edge cases
     (kv tiles masked whole, ragged tiles), to `F32_REL_ERR`, timed one
     call and back to back beside SDPA in float32, each case's share of its
     bound beside its time in an earlier run (`F32_EARLIER_MS`), and its
     gradient (JAX's custom_vjp: the plain f32 attention's recompute)
     equal to the plain attention's autograd gradient, the forward and the
     backward timed apart; K3's bf16 modes under autograd at the train
     path's three sites (`bf16_grad_cases`: the forward within REL_ERR of
     its plain version, dq/dk/dv equal to the plain attention's
     gradients); K6's float32 mode
     (`csrc/attention_stream_f32.cu`, the same core at kv lengths above
     the one-shot range) at PixArt-Σ 1024's self-attention [2, 4096, 16,
     72], full and kv-masked, and at M = 2304 edge cases, the same way, and
     its refusal of int8 PV and emission; K8 -> K6 with int8_qk at Σ's
     self-attention, bf16 and int8 PV, emitting through K4; the other
     backbones' shapes (`backbone_cases`): K3 full at Latte-XL/2's temporal
     [512, 16, 16, 72] and spatial [32, 256, 16, 72] blocks (bf16 beside
     SDPA, and the cb arm's asym emission with the proj's 1/cs), K6 at
     DiT-XL/2's [2, 4096, 16, 72] (bf16, and sm8's emission through K4),
     K1 at MMDiT's image stream [2, 4096, 1152];
  4. reference: tiny STDiT (sm8, sm8_epi, attn8, the fused reference
     W8A8, the reference W8A8 on the native backend and the W4A8 CB
     recipe, asym and sym) and
     tiny PixArt-Σ models (sm8 and its W4A8 CB plan), tiny DiT (sm8),
     Latte (W4A8 CB) and MMDiT (its W4A8 plan, 3-step rectified flow) on
     the card (kernels) against the same models on the CPU (plain
     versions); the reference
     plans as written (STDiT under viditq_w8a8 and viditq_w6a6 on the
     simulate backend, w8a8_naive with static acts, simulate and under
     impl 'fused' (K2 on static codes), the hybrid plan; PixArt-Σ under
     its w8a8_naive), each static-act model calibrated by `run_ptq` on the
     CPU first; a tiny PixArtMS with the micro-condition, qk_norm and the
     'ave' KV sampling under sm8; then the t20 MP sampler retiled onto 2
     steps over the tiny
     CB STDiT (the gather path) and over a tiny native W4A8 STDiT without
     CB (the segmented path); one train step of the tiny STDiT with
     gradient checkpointing (loss and gradients within TINY_REL_ERR);
  5. slice: full-width STDiT-XL/2 (28 blocks, C=1152, random weights from
     a seed), bf16, W8A8-sm8, `sm8_epi` (the sm8 plan with the model's
     `fuse_epilogue`: the block's residual adds in K2's epilogue), `attn8`
     (`w8a8_tpu_fused_attn8.yaml`: K8's int8 q/k and int8 PV at every
     attention site), reference W8A8 (`w8a8_dynamic.yaml` on the
     native backend: K7a/K7b), the fused reference W8A8
     (`w8a8_tpu_fused.yaml`: K1-K5 asym), fused sym W8A8
     (`w8a8_tpu_fused_sym.yaml`), `fc1_asym` (the sym plan with fc1's
     dynamic acts asym, `Fc1AsymPlan`: fc1's int8 emission after K2's
     zero-point epilogue, launches as sym's) and ViDiT-Q's W4A8 recipe with
     timestep-aware channel balancing on the fused kernels (`cb`:
     `w4a8_timestep_aware_cb.yaml`, `qkv_share_cs`, calibrated by one
     sq_stat forward in each of its two timeranges; `cb_sym`: the same
     with sym weights and acts; `cb_mp`: the cb arm's model sampled
     through the gather MP sampler with the t20 timestep-wise mixed
     precision, `t20_{weight_4,act_8}_mp.yaml`: its union spans, bits by
     layer kind, CFG forwards per span (each span's steps exactly), and
     launches equal to cb's), `w4a8_fused` (`w4a8_tpu_fused.yaml`: 4-bit
     sym codes on the fused kernels, two batch-1 forwards a step) and
     `hybrid_sym` arms; `hybrid` (`w8a8_tpu_hybrid.yaml`: the MLPs K7a ->
     K7b, the attention linears weight-only int8);
  5a. stdit_plans, alpha, sigma_plans: the simulate-backend plans at
     `PLAN_DEPTH` blocks of full width (`plan_cfg`; each slice with its
     bf16 arm at that depth): ViDiT-Q's reference plans as
     written: `sim_w8a8` and `sim_w6a6` (`viditq_w{8a8,6a6}.yaml`, the
     simulate backend: fake quant in plain PyTorch, per token position,
     K3 alone), `naive` (`w8a8_naive.yaml`: static per-tensor acts, its
     tables from `run_ptq`'s a_calib pass over 10 of the 20 steps of the
     trajectory `get_calib_data` captures from the model's fp sampling of
     the slice's inputs), `naive_fused` (naive's tables on the native
     backend under impl 'fused': codes made in plain PyTorch, K2 at every
     quantized linear), the CB and smooth-quant plans
     (`w{4a8,6a6}_naive_cb.yaml`, `w{4a8,6a6,8a8}_smooth_quant.yaml`) and
     the PTQD pair (`w{6a6,8a8}_ptqd.yaml`, then `calibrate-ptqd-k`
     through `cli.main` on the fp and quantized outputs along the fp
     trajectory, `ptqd_k_check`); PixArt-α 512's `w8a8_sq_static` (a
     static slot a calibration step), `w8a8_q_diffusion` (fc2's and the
     cross proj's channel split, `SplitPlan`), `w4a8` and `w8a8_naive`;
     PixArt-Σ's `w8a8` and `w4a8_naive`; all over the whole
     20-step CFG schedule (a plan arm with its plan's
     `cfg_split` key, `AS_WRITTEN`: sim_w8a8, hybrid and w4a8_fused two
     batch-1 forwards a step; the earlier arms one batch-2 CFG forward),
     with ms/step, peak memory, quantized-vs-bf16 error (`LOW_BIT_ARMS`:
     none), the
     fused arm's distance to the native one, the CB arms' steps in each
     timerange and the launch count of every kernel (the fused-kernel
     STDiT arms held to their per-block counts), sm8_epi against sm8 and
     cb_mp against cb;
  6. slice_sigma: full-width PixArt-Σ 1024 (28 blocks, C=1152, KV
     compression x2 on blocks 14-27, caption 300x4096), bf16, sm8 and cb
     (its W4A8 plan, `configs/pixart_sigma/w4a8.yaml`, on the fused
     kernels with `qkv_share_cs`, calibrated by one sq_stat forward at t =
     500) and naive (`configs/pixart_sigma/w8a8_naive.yaml`, static acts
     with running statistics, calibrated as STDiT's naive) arms over the
     whole 20-step DPM-Solver++ CFG schedule, built through
     `utils/workload`, with the same readings;
  6b. latte, dit, dit_l, mmdit: the other backbones at full width (random
     weights x 0.02, seed 0; `LATTE_CFG`, `DIT_CFG`, `MMDIT_CFG`, the JAX
     bench's `arm_latte` and `arm_mmdit`): Latte-XL/2 16x256x256 (caption
     pooled to one token) bf16, `cb` (the W4A8 CB recipe, sq_stat at t =
     250 and 750) and `cb_mp` (its four-range MP, `latte_mp_weight`:
     attention 8/4/4/8 bits, MLP 8, through the gather path); DiT-XL/2
     16x256x256 on a class label (`ClassEncoder`) bf16 and sm8 (K6 over
     4096 tokens); DiT-L/2 (`DIT_L_CFG`: the registry's `DiT` at 24
     blocks of 1024, 16 heads of 64) the same way (K6 at D = 64, K5 at K =
     1024, K2 at fc2's K = 4096); MMDiT 1024 (24 blocks, 77 caption tokens) bf16 and
     w4a8 (`configs/mmdit/w4a8_tpu_fused.yaml`) through `RectifiedFlow`
     (`models/mmdit.rectified_flow_sample`, 20 steps, CFG 4.0), each arm
     with the readings of phase slice and its launches held to
     `BLOCK_LAUNCHES`;
  7. cli: the port's command line (`viditq_tpu_torch.cli.main`, in this
     process) on STDiT-XL/2 16x512x512 (a copy of
     `configs/workload/opensora_16x512x512.py` at 20 steps, in a temporary
     directory), `--num_samples 1`: the seeded weights
     (`utils/workload.random_init_`, seed 0, x 0.02) written as a
     reference-layout `.pth` (fused qkv, Linear weights [out, in]) and
     converted by `split-ckpt` (every tensor equal to the drawn one);
     `inference` and `get-calib-data`; `ptq` and `quant-generate` under the
     sm8 plan as written (its `cfg_split`: two batch-1 forwards a step; the
     launches exactly `SM8_BLOCK` x 28 x 20 x 2, the samples equal to the
     in-process `quant_sample` within `CLI_SAME_REL`); `ptq` under
     `w8a8_naive.yaml` on the CLI's own `calib_data.npz` and its
     `quant-generate` (the file loaded into a fresh model: every table
     equal to an in-process `run_ptq`'s on the same data, the act slot map
     round trip; the samples equal to that model's `quant_sample` within
     `CLI_SAME_REL`); both within `SLICE_REL_ERR` of `inference`'s
     samples; `quant-generate-mp` with the t20 MP configs under
     `viditq_w4a8.yaml` as written (simulate, weight tables from the
     parameters) and under `w8a8_naive.yaml` on the naive checkpoint
     (static act tables, its slot map), each within `CLI_SAME_REL` of the
     in-process segmented sampler and `SLICE_REL_ERR` of `inference`; then `get-sensitivity --backend native` (K7a, K7b, K3; each
     score as a relative error against the fp samples' mean square,
     within `SLICE_REL_ERR`), `sweep-alpha` and `smooth-quant-list` at
     full width cut to 4 blocks and 4 steps. Each command's seconds, peak
     memory, launches and files;
  8. recon: AdaRound in the same directory, on phase cli's weights,
     calib_data.npz and fp samples: `ptq` under a copy of
     `w4a8_adaround.yaml` with `RECON_ITERS` iterations a block (block
     granularity, asym: each block's input re-captured through the
     reconstructed blocks before it; the float32 block's forward on K3's
     float32 mode, 3 launches a block forward), with the ms per iteration
     per block, the 28 re-capture forwards' seconds, the peak memory and
     the extrapolation to the plan's 2000 iterations x 28 blocks; then
     `quant-generate` from its checkpoint on the simulate backend and with
     `--backend native` (K7a/K7b on slabs packed with the learned rounding),
     and the same plan with nearest rounding: each sample's rel err against
     the fp samples and against nearest rounding, the two backends within
     `RECON_BACKEND_REL`; then layer granularity and
     `mlp_block_reconstruction` at full width on `RECON_LAYER_DEPTH` blocks
     (JAX's layer granularity holds every layer's I/O at once);
  9. recon_sigma: AdaRound through the CLI on PixArt-Σ 1024 at full depth
     and width (a copy of `configs/workload/pixart_alpha_512.py` changed to
     `SIGMA_CFG`'s values; the Σ slice's seeded weights in a `--ckpt_path`
     file): `inference`, `get-calib-data`, `ptq` under a copy of
     `w4a8_adaround.yaml` with `sr` added to its fp list and `RECON_ITERS`
     iterations a block (the float32 blocks' self-attention on K6's
     float32 mode in blocks 0-13 at N = M = 4096, `sdpa` in the
     KV-compressed blocks 14-27, cross attention on K3's float32 mode: the
     launches held to `SIGMA_RECON_LAUNCHES` exactly), with the ms per
     iteration per block (all, blocks 0-13, blocks 14-27), the re-capture
     seconds, the peak memory and the extrapolation to the plan's 2000
     iterations x 28 blocks; then `quant-generate` from its checkpoint on
     the simulate and the native backend and the plan with nearest
     rounding, each against the fp samples, native against simulate
     within `RECON_BACKEND_REL`;
  10. samplers (run between phases recon and recon_sigma; its STDiT part
     inside phase cli, after the sm8 commands, on their weights and
     checkpoint): `inference` and `quant-generate --sampler_type iddpm`
     (IDDPM's ancestral loop, learned-range variance) on STDiT-XL/2
     16x512x512 at 20 steps, sm8 launches as DDIM's, within
     `SLICE_REL_ERR` of bf16 and further than `SAMPLER_DIFF` from the DDIM
     sample; then PixArt-α 512 at full width (`PIXART_WORKLOAD`: 28
     blocks, C = 1152, 1024 tokens, 120 caption tokens; the CLI's seeded
     weights): `get-calib-data` (the config's multistep DPM-Solver++) and
     `ptq` under `configs/pixart/w8a8.yaml` on the native backend, then
     `inference` and `quant-generate` with --sampler_type dpms, sa-solver,
     lcm, edm and a copy of the config whose DPM-Solver is singlestep of
     order 3 with thresholding and denoise_to_zero, each at 20 steps: K3
     launched exactly `SAMPLER_FORWARDS` forwards' worth, ms/step and ms
     a forward, w8a8 within `SLICE_REL_ERR` of bf16, each bf16 sample
     further than `SAMPLER_DIFF` from the multistep one; then each new
     loop shape on the tiny sm8 STDiT, card against CPU, nonzero and
     within `TINY_REL_ERR`;
  11. train (after recon_sigma, its own temporary directory): the `train`
     command at full width on STDiT-XL/2 16x512x512 with gradient
     checkpointing (a copy of the CLI's workload config with the model's
     `grad_checkpoint`), synthetic batches of 2: `--num_steps 4
     --ckpt_every 2 --grad_clip 1.0`, the same resumed from its step-2
     checkpoint (every parameter and EMA tensor equal to the uninterrupted
     run's, bitwise), one `--grad_accum 2` step; in process, 6 steps at lr
     1e-4 on one batch and one noise draw (the loss falls) and 2 QAT steps
     (JAX's QAT spec: W8 per-channel and A8 dynamic per-token, 'nearest_ste',
     five layers fp; finite losses, the fake-quantized weights move). Each
     with its seconds, ms per step after the first (the checkpoint writes
     apart), peak memory, losses and K3 launches, exactly 168 a
     micro-step (28 blocks x 3 sites, forward and recompute). The models
     of `train` and of the in-process steps start from JAX's
     initialisers (`utils/workload.jax_init_`, ROADMAP C20);
  12. parallel (last; `phase_parallel`): two ranks spawned on the one
     card (`parallel_rank`, `torch.multiprocessing` spawn) in a gloo group
     (`init_method` a file; every collective staged through the host,
     `parallel/comm.py`: NCCL refuses two ranks on one device), the
     parent's models freed first: sequence parallelism at sp = 2 on
     STDiT-XL/2 16x512x512 at `PAR_SP_DEPTH` blocks of full width, one
     batch-2 forward a run, Ulysses in bf16
     and under the sm8 plan, each against the same computation in one
     process (the same linears, K3 over all 16 heads, `whole_attention`;
     K3 at 8 heads `2 * PAR_SP_DEPTH` launches a rank, `ulysses_heads`),
     and
     ring in bf16 against Ulysses; the GPipe pipeline at pp = 2 with
     `PAR_N_MB` microbatches on STDiT-XL/2 (bf16, sm8) and PixArt-α 512
     (bf16), against the forward at stage 'all'; one train step at dp = 2
     (ZeRO moments) and at tp = 2 (`PAR_TRAIN_DEPTH` blocks) through
     `pipelines/train.train_loop`
     (STDiT-XL/2 with gradient checkpointing, batch 2, JAX's initialisers),
     the loss, the update and the first moments against the one-process
     step rank 0 runs first, each rank's peak memory; then NCCL at world
     size 1 in this process: a pp forward and a train step
     (`PAR_TRAIN_DEPTH` blocks) through the same code against the same work
     without a mesh. The ranks' ms are not scaling numbers
     (they share the card and the host's loopback);
  13. data (after parallel; `phase_data`, its own temporary directory; no
     Pillow: the clips are .y4m, numpy-decoded, already at the target
     size): `DATA_CLIPS` clips of 16x512x512 read by `DatasetFromCSV`; the
     16x512x512 workload's `VideoAutoencoderKL` at full width (128/256/
     512/512, JAX's initialisers, float32, TF32 off) encodes [2, 3, 16,
     512, 512] to [2, 4, 16, 64, 64] and decodes it, each timed (CUDA
     events after a warm-up) with its peak memory, the same weights
     against the CPU on [1, 3, 2, 64, 64] within `VAE_REL_ERR`; one
     decode of `VideoAutoencoderKLTemporalDecoder` at 16 frames;
     `extract-features` over two clips through `cli.main` (its latents
     the in-process encode's within `VAE_REL_ERR`); `train --data_path`
     on STDiT-XL/2 16x512x512 with grad_checkpoint, 2 steps at batch 2,
     the VAE encoding each batch inside the loop, and `--no_vae` over
     .npz latents (a config copy at the latent size), each with ms per
     step, peak memory and K3 at 168 a micro-step.
Each arm and each CLI command resets the launch counts just before its run
and reads them just after; one that launches a kernel outside its list,
or none of one in it, fails; the arms held to per-block counts
(`BLOCK_LAUNCHES`) must hit them exactly. The third-to-last line is the
card's name and power limit, the second-to-last a JSON object with one
entry per kernel (launches summed over all arms of both slices and the
CLI's, recon's, samplers', recon_sigma's and train's commands, both
ranks of phase parallel and phase data's commands), the last
{"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SM8_PLAN = ROOT / "configs/opensora/w8a8_tpu_fused_sm8.yaml"
# the sm8 plan plus the reference's per-token int8 q/k quantizers and the
# int8 PV at every attention site (K8 before each K3)
ATTN8_PLAN = ROOT / "configs/opensora/w8a8_tpu_fused_attn8.yaml"
# the reference ViDiT-Q W8A8 (asym weights and acts), native backend
W8A8_PLAN = ROOT / "configs/opensora/w8a8_dynamic.yaml"
# the same semantics through the fused int8 dataflow, and its sym ablation
FUSED_PLAN = ROOT / "configs/opensora/w8a8_tpu_fused.yaml"
SYM_PLAN = ROOT / "configs/opensora/w8a8_tpu_fused_sym.yaml"
# ViDiT-Q's W4A8 recipe: asym per-channel 4-bit weights, asym dynamic
# per-token int8 acts, momentum channel balancing over two timeranges
# (alpha 0.11); the `cb` arms run it on the fused kernels
CB_PLAN = ROOT / "configs/opensora/w4a8_timestep_aware_cb.yaml"
# the CB statistic forwards: the midpoints of its timeranges
# (benchmarks/bench_configs.py:200-219)
CB_STAT_T = (250, 750)
CB_ALPHA = 0.11
# ViDiT-Q's timestep-wise mixed precision (t20 MP) over the CB recipe: per
# range of 5 sampler steps, the attention linears W4 and fc1/fc2 W8, every
# act 8-bit; the `cb_mp` arm samples the `cb` arm's model through the
# gather MP sampler (the JAX package's full-recipe arm, `arm_w4a8`,
# bench_configs.py:109-273)
MP_WEIGHT = ROOT / "configs/opensora/mixed_precision/t20_weight_4_mp.yaml"
MP_ACT = ROOT / "configs/opensora/mixed_precision/t20_act_8_mp.yaml"
# PixArt-Σ's W4A8 plan (W6 per-channel asym weights, asym dynamic A8,
# momentum CB with alpha 0.3 over one timerange, no fp list: the patch
# embed and the final linear are quantized too); the Σ `cb` arm runs it on
# the fused kernels with the q/k/v scale pooled, as the JAX package's
# `sigma1024` arm (bench_configs.py:359-425)
SIGMA_CB_PLAN = ROOT / "configs/pixart_sigma/w4a8.yaml"
SIGMA_CB_ALPHA = 0.3
# the CB statistic forwards of each slice: Σ's at t = 500
# (bench_configs.py:408-425)
STAT_T = {"stdit": CB_STAT_T, "sigma": (500,), "latte": CB_STAT_T,
          "dit": (), "dit_l": (), "mmdit": (), "stdit_h6": (),
          "dit_l_h4": (),
          "stdit_plans": CB_STAT_T, "alpha": (500,), "sigma_plans": (500,)}
# ViDiT-Q's reference plans as written (no `backend:` key: the simulate
# backend, fake quant as the reference runs it): W8A8 and W6A6 with asym
# per-channel weights and asym dynamic per-token acts, the naive W8A8 with
# static per-tensor acts (calibrated by `run_ptq`'s a_calib pass), and the
# hybrid plan (the MLPs native K7a -> K7b, the attention linears
# weight-only int8); PixArt-Σ's naive W8A8 (static acts, running stats)
SIM_W8A8_PLAN = ROOT / "configs/opensora/viditq_w8a8.yaml"
SIM_W6A6_PLAN = ROOT / "configs/opensora/viditq_w6a6.yaml"
NAIVE_PLAN = ROOT / "configs/opensora/w8a8_naive.yaml"
HYBRID_PLAN = ROOT / "configs/opensora/w8a8_tpu_hybrid.yaml"
SIGMA_NAIVE_PLAN = ROOT / "configs/pixart_sigma/w8a8_naive.yaml"
# the rest of the shipped plans: STDiT's W4A8 on the fused kernels
# (4-bit sym codes in the int8 range, sym dynamic A8, int8 PV at temporal
# and cross, cfg_split), the hybrid plan's sym variant, the CB and smooth-
# quant plans on simulate, the PTQD pair (static per-tensor asym acts,
# mixed_precision [4, 6, 8], meant for `calibrate-ptqd-k`); PixArt-alpha's
# static plans (timestep-wise slots; the q-diffusion split), its W4A8 (W6
# as written) and naive W8A8; PixArt-Sigma's W8A8 (dynamic + smooth quant)
# and W4A8 naive (static tensor acts, running_stat)
W4A8_FUSED_PLAN = ROOT / "configs/opensora/w4a8_tpu_fused.yaml"
HYBRID_SYM_PLAN = ROOT / "configs/opensora/w8a8_tpu_hybrid_sym.yaml"
NAIVE_CB_W4A8_PLAN = ROOT / "configs/opensora/w4a8_naive_cb.yaml"
NAIVE_CB_W6A6_PLAN = ROOT / "configs/opensora/w6a6_naive_cb.yaml"
SQ_PLANS = {b: ROOT / f"configs/opensora/{b}_smooth_quant.yaml"
            for b in ("w4a8", "w6a6", "w8a8")}
PTQD_PLANS = {b: ROOT / f"configs/opensora/{b}_ptqd.yaml"
              for b in ("w6a6", "w8a8")}
ALPHA_SQ_STATIC_PLAN = ROOT / "configs/pixart/w8a8_sq_static.yaml"
ALPHA_Q_DIFFUSION_PLAN = ROOT / "configs/pixart/w8a8_q_diffusion.yaml"
ALPHA_W4A8_PLAN = ROOT / "configs/pixart/w4a8.yaml"
ALPHA_NAIVE_PLAN = ROOT / "configs/pixart/w8a8_naive.yaml"
SIGMA_W8A8_PLAN = ROOT / "configs/pixart_sigma/w8a8.yaml"
SIGMA_W4A8_NAIVE_PLAN = ROOT / "configs/pixart_sigma/w4a8_naive.yaml"
# the q-diffusion plan's channel split (its reference applies it through
# command-line flags; `SplitPlan`): every block's fc2 and cross proj
# quantize their input's first and second parts apart, at 3/8 of K as the
# tiny-model test does
Q_DIFFUSION_SPLIT = 3 / 8
STEPS = 20  # sampler steps per arm (bench.py's n_steps): the whole schedule
# blocks of the simulate-backend plan arms at full width: their time is
# per-block fake-quant glue (0.68-0.85 s a step at 28 blocks), so fewer
# blocks check the same per-block dataflow; each such slice runs its own
# bf16 arm at the same depth
PLAN_DEPTH = 4
# PixArt-Σ 1024 as benchmarks/bench_configs.py:388-391 builds it; the
# sampler of the t2i workloads (configs/workload/pixart_alpha_512.py)
SIGMA_CFG = {
    "model": dict(type="PixArtMS-XL/2", caption_channels=4096,
                  model_max_length=300, kv_compress_sampling="conv",
                  kv_compress_scale=2,
                  kv_compress_layers=tuple(range(14, 28))),
    "image_size": 1024,
    "scheduler": dict(type="dpm-solver", num_sampling_steps=STEPS,
                      cfg_scale=4.5),
    "dtype": "bf16",
}

# the other backbones at full width (the JAX bench's `arm_latte` and
# `arm_mmdit`, benchmarks/bench_configs.py:456-653): Latte-XL/2 and DiT-XL/2
# at 16x256x256 (latent 16x32x32: T = 16 frames of S = 256 tokens), Latte
# on a caption of 4096 channels pooled to one token, DiT on ImageNet's 1000
# labels (`ClassEncoder`, the null label the CFG's unconditional row), both
# 20-step DDIM at CFG 4.0; MMDiT at 1024x1024 (latent 4x128x128, patch 2:
# 4096 image tokens), 24 blocks, 77 caption tokens of 4096, an all-ones
# mask, 20-step rectified flow at CFG 4.0
LATTE_CFG = {"model": dict(type="Latte-XL/2", condition="text",
                           caption_channels=4096),
             "num_frames": 16, "image_size": (256, 256),
             "scheduler": dict(type="iddpm", num_sampling_steps=STEPS,
                               cfg_scale=4.0),
             "dtype": "bf16"}
DIT_CLASSES = 1000
DIT_CFG = {**LATTE_CFG, "model": dict(type="DiT-XL/2",
                                      condition=f"label_{DIT_CLASSES}")}
# DiT-L/2 (Peebles & Xie, "Scalable Diffusion Models with Transformers",
# Table 1: 24 blocks, hidden 1024, 16 heads of 64), the registry's `DiT` at
# the paper's widths on DiT-XL/2's 16x32x32 latent: its attention runs K6
# at D = 64 over 4096 tokens, its linears K5 (K = 1024) and K2 (fc2 K = 4096)
DIT_L_CFG = {**LATTE_CFG, "model": dict(
    type="DiT", depth=24, hidden_size=1024, patch_size=(1, 2, 2),
    num_heads=16, condition=f"label_{DIT_CLASSES}")}
# heads wider than 128 inside a real model: no public model of the repo's
# families has them, so DiT-L/2 with its head split changed and nothing
# else (4 heads of 256; the weight shapes are DiT-L/2's): K6 at D = 256
DIT_L_H4_CFG = {**DIT_L_CFG, "model": dict(DIT_L_CFG["model"], num_heads=4)}
# PixArt-alpha 512 as `configs/workload/pixart_alpha_512.py` builds it (1024
# tokens, 120 caption tokens of 4096, 20-step DPM-Solver++ at CFG 4.5)
ALPHA_CFG = {"model": dict(type="PixArt-XL/2", caption_channels=4096,
                           model_max_length=120),
             "image_size": 512,
             "scheduler": dict(type="dpm-solver", num_sampling_steps=STEPS,
                               cfg_scale=4.5),
             "dtype": "bf16"}


def plan_cfg(cfg, depth=PLAN_DEPTH):
    """A slice's config cut to `depth` blocks of its XL/2 widths (the
    registry's generic `STDiT` / `PixArt`); PixArt-Sigma keeps KV
    compression on the later half of the blocks, as at 28 (14-27)."""
    model = dict(cfg["model"])
    kind = model.pop("type")
    base = {"STDiT-XL/2": "STDiT", "PixArt-XL/2": "PixArt",
            "PixArtMS-XL/2": "PixArt"}[kind]
    if kind == "PixArtMS-XL/2":
        model.setdefault("micro_condition", False)
    if "kv_compress_layers" in model:
        model["kv_compress_layers"] = tuple(range(depth // 2, depth))
    model.update(type=base, depth=depth, hidden_size=1152, num_heads=16,
                 patch_size=(1, 2, 2) if base == "STDiT" else 2)
    return {**cfg, "model": model}


MMDIT_CFG = {"model": dict(type="MMDiT", input_size=128, patch_size=2,
                           in_channels=4, hidden_size=1152, depth=24,
                           num_heads=16, caption_channels=4096,
                           model_max_length=77),
             "image_size": 1024, "dtype": "bf16"}
MMDIT_PLAN = ROOT / "configs/mmdit/w4a8_tpu_fused.yaml"
MMDIT_CFG_SCALE = 4.0
# Latte's four-range timestep MP (bench_configs.py:529-535): each block's
# attention linears at 8/4/4/8 bits over the step ranges 19-15 / 14-10 /
# 9-5 / 4-0 (by module prefix, `blocks.N.attn`), its MLP at 8
LATTE_ATTN_BITS = (("19-15", 8), ("14-10", 4), ("9-5", 4), ("4-0", 8))


def latte_mp_weight(depth: int = 28) -> dict:
    cfg = {"fp_layers": []}
    for rng, bits in LATTE_ATTN_BITS:
        cfg[rng] = {**{f"blocks.{i}.attn": bits for i in range(depth)},
                    **{f"blocks.{i}.mlp": 8 for i in range(depth)}}
    return cfg


# ViDiT-Q's W4A8 plan as written (the simulate backend, CB), which phase
# cli runs through `quant-generate-mp` with the t20 MP configs
VIDITQ_W4A8_PLAN = ROOT / "configs/opensora/viditq_w4a8.yaml"

# published peaks of one H100 SXM (dense; NVIDIA's data sheet) for the
# bound: the larger of bytes / HBM rate and the sum over operation types
# of operations / peak rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
                  "f32": 67e12}

# tolerances (acceptance criteria of the port): int8 codes differ by at
# most 1 at no more than 0.1% of entries (a float reduction precedes every
# rounding, in another order than the plain version's); float outputs agree
# to a relative error of 1e-2 (bf16 outputs round at 2^-8)
CODE_MAX_DIFF = 1
CODE_MISMATCH_FRAC = 1e-3
REL_ERR = 1e-2
# K3's and K6's float32 modes against their plain versions: f32 outputs of
# the same bf16 q.k and f32 softmax, summed in another order, the PV as
# three TF32 products (about 2^-21 of each product dropped; the CPU
# emulation, tests/test_torch_f32_split.py, reads 2e-7 to 4e-7 against
# JAX's f32 attention, one TF32 product 2.8e-4; the card's readings: rel
# 9e-8 to 8.2e-7 on unit-normal inputs)
F32_REL_ERR = 1e-5
# the float32 cases' kernel ms before the float32 core, with the PV on the
# CUDA cores (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), printed beside
# this run's
F32_EARLIER_MS = {
    "spatial [32,1024,16,72]": 8.563,
    "temporal seg 16 [2,16384,16,72]": 0.715,
    "cross [2,16384,16,72] kv 120 masked": 1.188,
    "Σ cross [2,4096,16,72] kv 300 masked": 0.753,
    "Σ self [2,4096,16,72]": 3.355,
    "Σ self [2,4096,16,72] kv masked": 3.305,
}
# asym row quantizers (codes, scale, zp, rowsum), every row compared by
# `compare_asym_rows`: per producer, the largest relative error of a row's
# scale and the largest share of rows whose scale or zero point differ at
# all from the plain version's. K4 (bf16 in: its row min and max are exact)
# is held identical instead.
ASYM_TOL = {
    # K1: the LN mean and variance summed in another order (readings:
    # 3.3e-7, 0.37 of the rows)
    "ln": (1e-6, 0.5),
    # K3: the f32 attention output, its bf16 probabilities rounded at
    # another point (readings: spatial 3.6e-4 with nearly every row's scale
    # moved, temporal's 16 keys 1.4e-3); the scale limit is the check
    "attn": (2.0 ** -8, 1.0),
    # K6 -> K4: K4 on K6's bf16 output, whose rounding can move a row's max
    # and min by one bf16 step each, at most 2^-7 of the range (readings:
    # 3.7e-3, 0.35% of the rows)
    "stream": (2.0 ** -7, 0.01),
}
# and every asym case's dequantized rows, (q - zp) * scale, to 2e-3
# relative (readings: 3.0e-5 at K1 to 6.0e-4 at K6 -> K4): a shift of the
# whole output that moves each scale by less than its limit shows here
ASYM_DEQ_REL = 2e-3
# C12: draws of the temporal int8-PV emission held to `int8_pv_slack`
C12_DRAWS = 64
SLICE_REL_ERR = 0.1        # int8 vs bf16 final latent: 8-bit sanity bound
# tiny sm8 model, card vs CPU: bf16 activations in both, summed in another
# order by cuBLAS and the CPU; this model's bf16 output is 1e-2 away from
# its own float32 output (measured on the CPU), so 3e-2 bounds the
# rounding and flags any kernel that computes something else (O(1))
TINY_REL_ERR = 3e-2

# K3 / K6 cases the main path does not reach (phase kernels, after the
# main-path cases): (kernel, case, shape and mode). `masked` zeroes kv rows
# [lo, hi) of the last batch row.
EDGE_CASES = (
    ("attention_bnhd", "full N=M=1000 bf16 (ragged q and kv tiles)",
     dict(B=2, N=1000, M=1000, H=16, D=72, int8_pv=False, emit=False)),
    ("attention_bnhd", "full N=M=1000 int8_pv emit",
     dict(B=2, N=1000, M=1000, H=16, D=72, int8_pv=True, emit=True)),
    ("attention_bnhd_stream",
     "N=M=2304 bkv 256 bf16, kv block 1 masked whole",
     dict(B=2, N=2304, M=2304, H=16, D=72, bkv=256, masked=(256, 512),
          int8_pv=False, emit=False)),
    ("attention_bnhd_stream",
     "N=M=2304 bkv 256 int8_pv emit, kv block 1 masked whole",
     dict(B=2, N=2304, M=2304, H=16, D=72, bkv=256, masked=(256, 512),
          int8_pv=True, emit=True)),
    ("attention_bnhd", "D=16 N=200 M=72 masked bf16",
     dict(B=2, N=200, M=72, H=4, D=16, masked=(50, 72), int8_pv=False,
          emit=False)),
    ("attention_bnhd", "D=16 N=200 M=72 masked int8_pv emit",
     dict(B=2, N=200, M=72, H=4, D=16, masked=(50, 72), int8_pv=True,
          emit=True)),
    ("attention_bnhd_stream", "D=16 N=M=2304 bkv 256 int8_pv",
     dict(B=2, N=2304, M=2304, H=4, D=16, bkv=256, int8_pv=True,
          emit=False)),
    # K6's emission through K4 in the asym mode (emit_sym=False, row sums)
    ("attention_bnhd_stream", "N=M=2304 bkv 256 bf16 asym emit (K6->K4)",
     dict(B=2, N=2304, M=2304, H=16, D=72, bkv=256, int8_pv=False,
          emit=True, emit_sym=False)),
    # C11: the one-shot int8 PV above 1040 kv rows (its s8 wgmma sums in
    # int32), at the one-shot kernel's largest kv length
    ("attention_bnhd", "full N=M=2048 int8_pv emit (C11)",
     dict(B=2, N=2048, M=2048, H=16, D=72, int8_pv=True, emit=True)),
    # seg mode's tiled kernel (a block per 16-row tile, all heads): the tiny
    # STDiT's temporal shape (seg 2, D = 16), a ragged last tile with v
    # groups of 200 rows straddling tiles, asym emission with row sums on a
    # ragged tile, seg 16 over an odd tile count, D = 16 at seg 16
    ("attention_bnhd", "seg 2 N=256 H=4 D=16 int8_pv emit (tiny STDiT)",
     dict(B=2, N=256, M=256, H=4, D=16, seg=2, int8_pv=True, emit=True)),
    ("attention_bnhd", "seg 8 N=1000 int8_pv emit (ragged last tile)",
     dict(B=2, N=1000, M=1000, H=16, D=72, seg=8, int8_pv=True, emit=True)),
    ("attention_bnhd", "seg 4 N=1000 asym emit rowsum (ragged last tile)",
     dict(B=2, N=1000, M=1000, H=16, D=72, seg=4, int8_pv=False, emit=True,
          emit_sym=False)),
    ("attention_bnhd", "seg 16 N=16016 int8_pv emit (1001 tiles)",
     dict(B=2, N=16016, M=16016, H=16, D=72, seg=16, int8_pv=True,
          emit=True)),
    ("attention_bnhd", "seg 16 N=4096 H=4 D=16 bf16",
     dict(B=2, N=4096, M=4096, H=4, D=16, seg=16, int8_pv=False,
          emit=False)),
    # seg mode's row kernel (seg not dividing 16): int8 PV over a kv range
    # above 1040 rows, summed in int32, with its two-launch emission; bf16
    # PV, and the asym emission with row sums
    ("attention_bnhd",
     "seg 1088 N=2176 int8_pv v_block 1088 emit (row kernel)",
     dict(B=2, N=2176, M=2176, H=16, D=72, seg=1088, v_block=1088,
          int8_pv=True, emit=True)),
    ("attention_bnhd", "seg 48 N=2304 bf16 (row kernel)",
     dict(B=2, N=2304, M=2304, H=16, D=72, seg=48, int8_pv=False,
          emit=False)),
    ("attention_bnhd", "seg 48 N=2304 asym emit rowsum (row kernel)",
     dict(B=2, N=2304, M=2304, H=16, D=72, seg=48, int8_pv=False,
          emit=True, emit_sym=False)),
)

# K2 / K7b cases the main path does not reach (phase kernels): (kernel,
# case, shape). Every one is held identical to its plain version.
GEMM_EDGE_CASES = (
    ("int8_consumer_matmul", "M=240 (ragged M tile)",
     dict(M=240, K=1152, N=2304)),
    ("int8_consumer_matmul", "N=1040 (ragged N tile), f32 out",
     dict(M=1000, K=1152, N=1040, out="f32")),
    ("int8_consumer_matmul", "K=576 (k tail of 64 bytes)",
     dict(M=1000, K=576, N=1152)),
    ("int8_consumer_matmul", "gw_x G=3, K=576 (group boundary inside a "
     "k-tile)", dict(M=1000, K=576, N=1152, G=3)),
    ("int8_matmul", "M=19 K=72 N=40 (byte-wise kernel)",
     dict(M=19, K=72, N=40)),
    ("int8_matmul", "N=1004 (ragged N tile, unaligned output rows)",
     dict(M=1000, K=1152, N=1004)),
    ("int8_matmul", "K=1168 (k tail of 16 bytes), f32 out",
     dict(M=1000, K=1168, N=1152, out="f32")),
    ("int8_matmul", "A at an odd address (byte-wise kernel)",
     dict(M=300, K=256, N=192, offset=1)),
)
# K1 / K4 cases the main path does not reach (phase kernels, after the
# asym cases), held to the main cases' tolerances: (kernel, case, shape and
# mode). bf16 unless "f32"; `zero_rows` zeroes those rows (the 1e-6 scale
# floor); K > 12288 (K4) and C > 1152 (K1) read a row in passes; K4 rows
# that are not 16-byte aligned and K1 rows of any width but 1152 are read
# element by element
ROW_EDGE_CASES = (
    ("quantize_rows", "f32 asym [8192,1152]",
     dict(M=8192, K=1152, sym=False, f32=True)),
    ("quantize_rows", "sym [8192,1152] (Σ K6 emission)",
     dict(M=8192, K=1152, sym=True)),
    ("quantize_rows", "asym [1000,72] (ragged K)", dict(M=1000, K=72,
                                                        sym=False)),
    ("quantize_rows", "asym [1000,1000] (ragged K)",
     dict(M=1000, K=1000, sym=False)),
    ("quantize_rows", "asym [64,1001] (unaligned rows)",
     dict(M=64, K=1001, sym=False)),
    ("quantize_rows", "asym [240,1152] (K5 kv_linear)",
     dict(M=240, K=1152, sym=False)),
    ("quantize_rows", "sym + rowsum [240,1152] (K5 kv_linear)",
     dict(M=240, K=1152, sym=True, rowsum=True)),
    ("quantize_rows", "gelu sym [19,4608]", dict(M=19, K=4608, sym=True,
                                                 gelu=True)),
    ("quantize_rows", "gelu asym [19,4608]", dict(M=19, K=4608, sym=False,
                                                  gelu=True)),
    ("quantize_rows", "asym [256,1152], zero rows",
     dict(M=256, K=1152, sym=False, zero_rows=(0, 5, 255))),
    ("quantize_rows", "sym [256,1152], zero rows",
     dict(M=256, K=1152, sym=True, zero_rows=(0, 5, 255))),
    ("quantize_rows", "gelu asym [64,16384] (rows in passes)",
     dict(M=64, K=16384, sym=False, gelu=True)),
    ("ln_modulate_quantize", "f32 [2,4096,1152]",
     dict(B=2, N=4096, C=1152, sym=True, f32=True)),
    ("ln_modulate_quantize", "asym [2,256,64] (C = 64)",
     dict(B=2, N=256, C=64, sym=False)),
    ("ln_modulate_quantize", "sym + rowsum [2,19,1152] (batch boundary "
     "inside a block)", dict(B=2, N=19, C=1152, sym=True, rowsum=True)),
    ("ln_modulate_quantize", "sym [2,64,70] (C % 4 != 0)",
     dict(B=2, N=64, C=70, sym=True)),
    ("ln_modulate_quantize", "asym [2,512,4096] (rows in passes)",
     dict(B=2, N=512, C=4096, sym=False)),
)
# K5 cases the main path does not reach (phase kernels, after the row edge
# cases), each identical to the K4 -> K2 route and held to the main cases'
# tolerance against the plain version: (case, shape and mode). mode "sym":
# sym x sym; "symx": sym acts x asym weights; "asym": asym x asym. bf16 x
# unless "f32". The kernel's codes of one 128-row tile stay in shared
# memory, so K <= 1152, and it reads x in 16-byte aligned rows: the next
# wider K and an unaligned row must be refused.
K5_EDGE_CASES = (
    ("M=19 sym [19,1152]x[1152,1152]", dict(M=19, K=1152, N=1152)),
    ("M=240 symx (ragged M tile)", dict(M=240, K=1152, N=2304,
                                        mode="symx")),
    ("M=300 asym (three M tiles, the last ragged)",
     dict(M=300, K=1152, N=1152, mode="asym")),
    ("N=1008 asym f32 out (ragged N tile)",
     dict(M=1000, K=1152, N=1008, mode="asym", f32_out=True)),
    ("K=72 sym (K % 16 != 0: W^T loaded byte-wise)",
     dict(M=300, K=72, N=192)),
    ("K=64 asym (one k-tile, the tiny models' width)",
     dict(M=256, K=64, N=192, mode="asym")),
    ("f32 x asym [1000,1152]", dict(M=1000, K=1152, N=1152, mode="asym",
                                    f32=True)),
    ("asym [256,1152], zero rows", dict(M=256, K=1152, N=1152, mode="asym",
                                        zero_rows=(0, 5, 255))),
    ("sym [256,1152], zero rows", dict(M=256, K=1152, N=1152,
                                       zero_rows=(0, 5, 255))),
    ("K=1152 symx (the widest K whose codes stay resident)",
     dict(M=500, K=1152, N=576, mode="symx")),
    ("K=1168 sym (the wide schedule: 10 k-tiles, the last ragged)",
     dict(M=300, K=1168, N=192)),
    ("K=2304 symx, ragged M tile (wide)", dict(M=240, K=2304, N=2304,
                                               mode="symx")),
    ("K=4608 f32 x asym, zero rows (wide)",
     dict(M=300, K=4608, N=576, mode="asym", f32=True, zero_rows=(0, 5))),
    ("K=1004 sym (rows not 16 bytes: padded, W^T byte-wise)",
     dict(M=64, K=1004, N=192)),
    ("N=1000 asym f32 out (N padded to 1008)",
     dict(M=1000, K=1152, N=1000, mode="asym", f32_out=True)),
)
INT_MM_NOTE = (" (torch._int_mm on the K-major weight: int32 product only, "
               "no epilogue)")

# file:line of the TPU kernel each port kernel replaces
REPLACES = {
    "ln_modulate_quantize": "viditq_tpu/kernels/fused_matmul.py:673",
    "int8_consumer_matmul": "viditq_tpu/kernels/fused_matmul.py:394",
    "attention_bnhd": "viditq_tpu/kernels/attention.py:599",
    # the same TPU kernel's float32 inputs (AdaRound's float32 block)
    "attention_bnhd_f32": "viditq_tpu/kernels/attention.py:599",
    "quantize_rows": "viditq_tpu/kernels/fused_matmul.py:606",
    "fused_dynq_int8_matmul": "viditq_tpu/kernels/fused_matmul.py:209",
    "attention_bnhd_stream": "viditq_tpu/kernels/attention.py:236",
    # the same TPU kernel's float32 inputs (AdaRound's float32 block at kv
    # lengths above the one-shot range)
    "attention_bnhd_stream_f32": "viditq_tpu/kernels/attention.py:236",
    "dynamic_quant_rows": "viditq_tpu/kernels/int_matmul.py:72",
    "int8_matmul": "viditq_tpu/kernels/int_matmul.py:142",
    # an XLA pass outside any pallas_call (`_fake_quant_tokens_headwise`)
    "qk_headwise_quant": "viditq_tpu/kernels/attention.py:481",
}
SOURCES = {
    "ln_modulate_quantize": "viditq_tpu_torch/csrc/ln_mod_quant.cu",
    "int8_consumer_matmul": "viditq_tpu_torch/csrc/int8_gemm.cu",
    "attention_bnhd": "viditq_tpu_torch/csrc/attention.cu",
    "attention_bnhd_f32": "viditq_tpu_torch/csrc/attention_f32.cu",
    "quantize_rows": "viditq_tpu_torch/csrc/quant_rows.cu",
    "fused_dynq_int8_matmul": "viditq_tpu_torch/csrc/dynq_gemm.cu",
    "attention_bnhd_stream": "viditq_tpu_torch/csrc/attention_stream.cu",
    "attention_bnhd_stream_f32":
        "viditq_tpu_torch/csrc/attention_stream_f32.cu",
    "dynamic_quant_rows": "viditq_tpu_torch/csrc/int_matmul.cu",
    "int8_matmul": "viditq_tpu_torch/csrc/int_matmul.cu",
    "qk_headwise_quant": "viditq_tpu_torch/csrc/qk_quant.cu",
}
# kernels each slice's main path launches, per arm (and no other)
FUSED_KERNELS = ("ln_modulate_quantize", "int8_consumer_matmul",
                 "attention_bnhd", "quantize_rows", "fused_dynq_int8_matmul")
DIT_BLOCK_KERNELS = ("int8_consumer_matmul", "quantize_rows",
                     "fused_dynq_int8_matmul")
SLICE_KERNELS = {
    "stdit": {"bf16": ("attention_bnhd",),
              "sm8": FUSED_KERNELS,
              "sm8_epi": FUSED_KERNELS,
              "attn8": FUSED_KERNELS + ("qk_headwise_quant",),
              "w8a8": ("dynamic_quant_rows", "int8_matmul",
                       "attention_bnhd"),
              "fused": FUSED_KERNELS,
              "sym": FUSED_KERNELS,
              # the sym plan with fc1's acts asym: fc1's emission after
              # K2's zero-point epilogue
              "fc1_asym": FUSED_KERNELS,
              "cb": FUSED_KERNELS,
              # after cb: it samples the cb arm's model
              "cb_mp": FUSED_KERNELS,
              "cb_sym": FUSED_KERNELS,
              "hybrid": ("dynamic_quant_rows", "int8_matmul",
                         "attention_bnhd"),
              # the W4A8 plan on the fused kernels, the hybrid plan's sym
              # variant
              "w4a8_fused": FUSED_KERNELS,
              "hybrid_sym": ("dynamic_quant_rows", "int8_matmul",
                             "attention_bnhd")},
    # the simulate-backend plans at PLAN_DEPTH blocks (`plan_cfg`): the
    # fake quant is plain PyTorch (as JAX's is XLA), so they run K3 alone;
    # naive_fused runs naive's tables on the native backend (K2 on static
    # codes)
    "stdit_plans": {"bf16": ("attention_bnhd",),
                    "sim_w8a8": ("attention_bnhd",),
                    "sim_w6a6": ("attention_bnhd",),
                    "naive": ("attention_bnhd",),
                    "naive_fused": ("int8_consumer_matmul",
                                    "attention_bnhd"),
                    "naive_cb_w4a8": ("attention_bnhd",),
                    "naive_cb_w6a6": ("attention_bnhd",),
                    "sq_w4a8": ("attention_bnhd",),
                    "sq_w6a6": ("attention_bnhd",),
                    "sq_w8a8": ("attention_bnhd",),
                    "ptqd_w6a6": ("attention_bnhd",),
                    "ptqd_w8a8": ("attention_bnhd",)},
    # PixArt-alpha 512 (1024 tokens: self and cross attention on K3)
    "alpha": {"bf16": ("attention_bnhd",),
              "sq_static": ("attention_bnhd",),
              "q_diffusion": ("attention_bnhd",),
              "alpha_w4a8": ("attention_bnhd",),
              "alpha_naive": ("attention_bnhd",)},
    # PixArt-Sigma 1024 at PLAN_DEPTH: K6 in the uncompressed blocks, K3
    # at cross attention (the compressed blocks' self-attention is SDPA)
    "sigma_plans": {"bf16": ("attention_bnhd", "attention_bnhd_stream"),
                    "sigma_w8a8": ("attention_bnhd",
                                   "attention_bnhd_stream"),
                    "sigma_w4a8_naive": ("attention_bnhd",
                                         "attention_bnhd_stream")},
    "sigma": {"bf16": ("attention_bnhd", "attention_bnhd_stream"),
              "sm8": FUSED_KERNELS + ("attention_bnhd_stream",),
              "cb": FUSED_KERNELS + ("attention_bnhd_stream",),
              "naive": ("attention_bnhd", "attention_bnhd_stream")},
    # no producer in a DiT block: q/k/v share one K4 pass, fc1 runs K5
    # (no K1); Latte's spatial and temporal blocks both on K3 full
    "latte": {"bf16": ("attention_bnhd",),
              "cb": DIT_BLOCK_KERNELS + ("attention_bnhd",),
              "cb_mp": DIT_BLOCK_KERNELS + ("attention_bnhd",)},
    # DiT attends over T*S = 4096 tokens: K6 (its emission through K4)
    "dit": {"bf16": ("attention_bnhd_stream",),
            "sm8": DIT_BLOCK_KERNELS + ("attention_bnhd_stream",)},
    # DiT-L/2: the same kernels at head dim 64 (K6), K = 1024 / 4096
    "dit_l": {"bf16": ("attention_bnhd_stream",),
              "sm8": DIT_BLOCK_KERNELS + ("attention_bnhd_stream",)},
    # the wide heads: STDiT-XL/2 in 6 heads of 192 (K3 full, seg on the
    # tiled kernel, masked), DiT-L/2 in 4 heads of 256 (K6)
    "stdit_h6": {"bf16": ("attention_bnhd",), "sm8": FUSED_KERNELS},
    "dit_l_h4": {"bf16": ("attention_bnhd_stream",),
                 "sm8": DIT_BLOCK_KERNELS + ("attention_bnhd_stream",)},
    # MMDiT's joint attention is `sdpa` (PyTorch's fused attention) and its
    # text stream fp: no port kernel in bf16; under W4A8 the image stream's
    # K1 -> K2 (q/k/v), K5 (proj), K1 -> K2 emission -> K2 (the MLP)
    "mmdit": {"bf16": (),
              "w4a8": ("ln_modulate_quantize", "int8_consumer_matmul",
                       "fused_dynq_int8_matmul")},
}
# the plan of each quantized arm by (slice, arm) (the bf16 arm runs the
# sm8 arm's model in fp mode)
ARM_PLANS = {("stdit", "sm8"): SM8_PLAN, ("stdit", "w8a8"): W8A8_PLAN,
             ("stdit", "fused"): FUSED_PLAN, ("stdit", "sym"): SYM_PLAN,
             ("stdit", "fc1_asym"): SYM_PLAN,
             ("stdit", "cb"): CB_PLAN, ("stdit", "cb_sym"): CB_PLAN,
             ("stdit", "cb_mp"): CB_PLAN, ("stdit", "attn8"): ATTN8_PLAN,
             ("stdit", "hybrid"): HYBRID_PLAN,
             ("stdit", "w4a8_fused"): W4A8_FUSED_PLAN,
             ("stdit", "hybrid_sym"): HYBRID_SYM_PLAN,
             ("stdit_plans", "sim_w8a8"): SIM_W8A8_PLAN,
             ("stdit_plans", "sim_w6a6"): SIM_W6A6_PLAN,
             ("stdit_plans", "naive"): NAIVE_PLAN,
             ("stdit_plans", "naive_fused"): NAIVE_PLAN,
             ("stdit_plans", "naive_cb_w4a8"): NAIVE_CB_W4A8_PLAN,
             ("stdit_plans", "naive_cb_w6a6"): NAIVE_CB_W6A6_PLAN,
             **{("stdit_plans", f"sq_{b}"): p for b, p in SQ_PLANS.items()},
             **{("stdit_plans", f"ptqd_{b}"): p
                for b, p in PTQD_PLANS.items()},
             ("alpha", "sq_static"): ALPHA_SQ_STATIC_PLAN,
             ("alpha", "q_diffusion"): ALPHA_Q_DIFFUSION_PLAN,
             ("alpha", "alpha_w4a8"): ALPHA_W4A8_PLAN,
             ("alpha", "alpha_naive"): ALPHA_NAIVE_PLAN,
             ("sigma_plans", "sigma_w8a8"): SIGMA_W8A8_PLAN,
             ("sigma_plans", "sigma_w4a8_naive"): SIGMA_W4A8_NAIVE_PLAN,
             ("sigma", "sm8"): SM8_PLAN, ("sigma", "cb"): SIGMA_CB_PLAN,
             ("sigma", "naive"): SIGMA_NAIVE_PLAN,
             ("latte", "bf16"): CB_PLAN, ("latte", "cb"): CB_PLAN,
             ("dit", "sm8"): SM8_PLAN, ("dit_l", "sm8"): SM8_PLAN,
             ("mmdit", "bf16"): MMDIT_PLAN, ("mmdit", "w4a8"): MMDIT_PLAN}
# model arguments an arm sets in its workload config's `model` dict: the
# sm8 plan with the block's residual adds in the linears' epilogues
ARM_MODEL = {("stdit", "sm8_epi"): {"fuse_epilogue": True}}
# how an arm changes its loaded plan (`quant_plan`): the native backend, or
# the CB recipe on the fused kernels with the q/k/v scale pooled
# (bench_configs.py:153-166, :376-381), asym or with sym weights and acts
# (:173-182)
PLAN_RECIPES = {("stdit", "w8a8"): "native", ("stdit", "cb"): "cb",
                ("stdit", "fc1_asym"): "fc1_asym",
                ("stdit", "cb_sym"): "cb_sym", ("stdit", "cb_mp"): "cb",
                ("stdit_plans", "naive_fused"): "fused",
                ("alpha", "sq_static"): "timestep_wise",
                ("alpha", "q_diffusion"): "q_diffusion",
                ("sigma", "cb"): "cb",
                ("latte", "bf16"): "cb", ("latte", "cb"): "cb"}
# a static-act arm that takes another arm's act tables (and weight tables)
# instead of calibrating its own: naive_fused runs naive's on the card's
# int8 kernels
TABLES_FROM = {("stdit_plans", "naive_fused"): "naive"}
# the arms that run their plan as written, the sampler's `cfg_split` key
# included (the JAX CLI applies it, viditq_tpu/cli.py:95); the earlier
# arms sample the joint CFG batch, as the JAX bench does
AS_WRITTEN = {("stdit", "hybrid"), ("sigma", "naive"),
              ("stdit", "w4a8_fused"), ("stdit", "hybrid_sym"),
              *(("stdit_plans", a) for a in SLICE_KERNELS["stdit_plans"]
                if a != "bf16"),
              *(("alpha", a) for a in SLICE_KERNELS["alpha"] if a != "bf16"),
              *(("sigma_plans", a) for a in SLICE_KERNELS["sigma_plans"]
                if a != "bf16")}
# the 4- and 6-bit arms above SLICE_REL_ERR on random weights, each held
# to be finite and farther from bf16 than its 8-bit sibling instead: none
# (sim_w6a6 took it at 28 blocks; at PLAN_DEPTH it and every 4- and 6-bit
# plan arm read 0.02-0.09 on an H100, PERF.md)
LOW_BIT_ARMS = {}
# the PTQD arms: after sampling, the fp and quantized model outputs along
# the fp trajectory go through `calibrate-ptqd-k` (`ptqd_k_check`)
PTQD_ARMS = {("stdit_plans", "ptqd_w6a6"), ("stdit_plans", "ptqd_w8a8")}
# launches per model forward of the arms whose blocks differ: PixArt-Sigma
# at PLAN_DEPTH runs K6 in its uncompressed half and K3 at every block's
# cross attention (the compressed blocks' self-attention is SDPA)
FORWARD_LAUNCHES = {("sigma_plans", a): {
    "attention_bnhd": PLAN_DEPTH, "attention_bnhd_stream": PLAN_DEPTH // 2}
    for a in SLICE_KERNELS["sigma_plans"] if a != "bf16"}
# arms that sample their plan's model through the timestep-wise MP sampler:
# (the arm whose model they take and whose launches they must equal, the
# weight and act bitwidth configs)
MP_ARMS = {("stdit", "cb_mp"): ("cb", MP_WEIGHT, MP_ACT),
           ("latte", "cb_mp"): ("cb", latte_mp_weight(), None)}
# an MP arm's weight bits by layer kind and MP range (ascending in t, the
# order of `_mp_tspans`), which its union model must pack in every span
MP_BITS = {("stdit", "cb_mp"): lambda kind, r: 8 if ".mlp." in kind else 4,
           ("latte", "cb_mp"): lambda kind, r: (
               8 if ".mlp." in kind
               else [b for _, b in LATTE_ATTN_BITS][::-1][r])}
# launches per block and model forward of an arm held to its exact count
# (a step of a `cfg_split` arm makes two forwards):
# the fused reference plan's (K1 at norm1 and norm2; K2 at the 9 linears
# on a prequant (q/k/v twice, the three projs, fc2) and fc1; K3 at the
# three sites; K4 for the temporal q/k/v and at the GELU handoff; K5, one
# launch of its own, at cross q_linear and kv_linear): the CPU audit in
# tests/test_torch_fused.py counts the plain calls, where the plain K5
# still calls K4's and K2's plain versions (13 and 4)
# The CB arms add no launch: every 1/cs folds into a producer (K1's adaLN
# vectors, K4, the attention emission, K2's emission, K5's quantize), so
# `cb` holds the fused arm's counts and `cb_sym` the sym arm's (fc1's
# emission replaces the GELU handoff's K4)
# sm8 (and sym, cb_sym) launch K4 once (temporal q/k/v): fc1's emission
# replaces the GELU handoff's; sm8_epi's epilogues add no launch, and attn8
# adds K8 at the three attention sites (84 a forward)
FUSED_BLOCK = {"ln_modulate_quantize": 2, "int8_consumer_matmul": 11,
               "attention_bnhd": 3, "quantize_rows": 2,
               "fused_dynq_int8_matmul": 2}
SM8_BLOCK = {**FUSED_BLOCK, "quantize_rows": 1}
# the reference plans: K3 at the three sites in every arm; naive_fused K2
# at each of the 13 quantized linears (q/k/v/proj twice, q_linear,
# kv_linear and the cross proj, fc1, fc2); hybrid K7a -> K7b at fc1 and fc2
SIM_BLOCK = {"attention_bnhd": 3}
LATTE_BLOCK = {"quantize_rows": 2, "int8_consumer_matmul": 5,
               "attention_bnhd": 1, "fused_dynq_int8_matmul": 1}
DIT_SM8_BLOCK = {"quantize_rows": 3, "int8_consumer_matmul": 5,
                 "attention_bnhd_stream": 1, "fused_dynq_int8_matmul": 1}
HYBRID_BLOCK = {"dynamic_quant_rows": 2, "int8_matmul": 2,
                "attention_bnhd": 3}
BLOCK_LAUNCHES = {**{("stdit_plans", a): SIM_BLOCK
                     for a in SLICE_KERNELS["stdit_plans"]
                     if a not in ("bf16", "naive_fused")},
                  ("stdit_plans", "naive_fused"): {
                      "int8_consumer_matmul": 13, "attention_bnhd": 3},
                  # PixArt: self and cross attention a block
                  **{("alpha", a): {"attention_bnhd": 2}
                     for a in SLICE_KERNELS["alpha"] if a != "bf16"},
                  ("stdit", "hybrid"): HYBRID_BLOCK,
                  ("stdit", "hybrid_sym"): HYBRID_BLOCK,
                  # as sm8: K4 once (temporal q/k/v), fc1's emission
                  ("stdit", "w4a8_fused"): SM8_BLOCK,
                  ("stdit", "sm8"): SM8_BLOCK,
                  ("stdit", "sm8_epi"): SM8_BLOCK,
                  ("stdit", "attn8"): {**SM8_BLOCK, "qk_headwise_quant": 3},
                  ("stdit", "fused"): FUSED_BLOCK,
                  # as sym: K1 at norm2 makes fc1's asym codes, K2 emits
                  ("stdit", "fc1_asym"): SM8_BLOCK,
                  ("stdit", "cb"): FUSED_BLOCK,
                  ("stdit", "cb_sym"): SM8_BLOCK,
                  ("stdit", "cb_mp"): FUSED_BLOCK,
                  # DiT blocks: K4 for q/k/v, K2 at q/k/v and at the proj
                  # on the attention's emission, K5 at fc1, K4's GELU
                  # handoff, K2 at fc2; DiT's K6 emits through a third K4
                  ("latte", "cb"): LATTE_BLOCK,
                  ("latte", "cb_mp"): LATTE_BLOCK,
                  ("dit", "sm8"): DIT_SM8_BLOCK,
                  ("dit_l", "sm8"): DIT_SM8_BLOCK,
                  # the wide heads: the same launches as 16 heads
                  ("stdit_h6", "sm8"): SM8_BLOCK,
                  ("dit_l_h4", "sm8"): DIT_SM8_BLOCK,
                  # the image stream: K1 twice, K2 at q/k/v, fc1 (emission)
                  # and fc2, K5 at the proj
                  ("mmdit", "w4a8"): {"ln_modulate_quantize": 2,
                                      "int8_consumer_matmul": 5,
                                      "fused_dynq_int8_matmul": 1}}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median time of fn() in ms from CUDA events, after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_back_to_back(fn, n: int = 20) -> float:
    """ms per call of n calls enqueued back to back between two CUDA events:
    the device's time where it exceeds the caller's host time per call."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def compare(got, want, is_codes: bool):
    """(max abs diff, mismatch fraction, relative error)."""
    import torch
    g = got.float()
    w = want.float()
    diff = (g - w).abs()
    rel = float((g - w).norm() / max(float(w.norm()), 1e-30))
    frac = float((diff > 0).float().mean()) if is_codes else 0.0
    if not torch.isfinite(g).all():
        fail("non-finite kernel output")
    return float(diff.max()), frac, rel


def bound(nbytes: float, ops: dict):
    """(least ms on the card, what bounds it) for a function that moves
    nbytes (each input read once, each output written once) and does
    ops[type] operations of each tensor-core type. Elementwise arithmetic
    (a few f32 flops per element at 67 TFLOP/s) is far below the byte
    time of the kernels here and is not counted."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bound(B, N, H, D, kv_rows, int8_pv, emit, kv_total):
    """Bound of one attention call: q/k/v in bf16 (k/v over kv_total rows,
    the mask as int32), the output in bf16 or as codes + scales, and
    2*N*D multiply-adds per head for QK^T and for PV over the kv rows a
    query needs (kv_rows: per batch row, after masking)."""
    C = H * D
    nbytes = 2 * B * N * C + 2 * 2 * B * kv_total * C
    nbytes += B * N * (C + 4) if emit else 2 * B * N * C
    qk = 2 * H * N * D * sum(kv_rows)
    ops = {"bf16": qk, "int8": qk} if int8_pv else {"bf16": 2 * qk}
    return nbytes, ops


def compare_asym_rows(got, want):
    """An asym row quantizer's outputs (codes, scale, zp, rowsum) against
    its plain version's, every row compared. A zero point one off shifts
    the whole row's codes with it, so codes are compared unshifted, q - zp
    (= round(x / scale), which moves only where x / scale lies near a
    half); the zero points to one; the kernel's row sums must equal the
    sums of its own codes exactly. Returns (max abs diff of q - zp, its
    mismatch fraction, the dequantized rel err, the share of rows whose
    scale or zero point differ, the largest relative error of a scale)."""
    import torch
    (q, s, z, r), (jq, js, jz, _) = got, want
    rows = q.reshape(-1, q.shape[-1]).float()
    jrows = jq.reshape(-1, jq.shape[-1]).float()
    s, js, z, jz = (t.reshape(-1, 1) for t in (s, js, z, jz))
    if float((z - jz).abs().max()) > 1:
        fail("zero points differ by more than one")
    own = q.reshape(rows.shape).to(torch.int32).sum(-1).float()
    if r is not None and not torch.equal(r.reshape(-1), own):
        fail("row sums differ from the sums of the kernel's own codes")
    diff = ((rows - z) - (jrows - jz)).abs()
    deq, jdeq = (rows - z) * s, (jrows - jz) * js
    rel = float((deq - jdeq).norm() / max(float(jdeq.norm()), 1e-30))
    other = float(((s != js) | (z != jz)).float().mean())
    srel = float(((s - js).abs() / js).max())
    return (float(diff.max()), float((diff > 0).float().mean()), rel, other,
            srel)


def int8_pv_slack(q, k, v, sc, seg_len, kv_mask, v_block, scales):
    """Per emitted entry [B*N, C] of an int8-PV attention: how many codes
    one softmax code flipped at its rounding tie moves it (C12). The code
    round(e * 127) moves by one, so the output moves by vs_c * |vq| /
    (127^2 * r) <= vs_c / (127 * r), and its code by that over the row's
    emission scale: vs_c / (127 * r * scale). r: the plain version's
    softmax denominator of the entry's head (>= 1); vs_c: v's channel scale
    in the entry's token group."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    B, N, H, D = q.shape
    M, C = k.shape[1], H * D
    qf = (q.float() * (sc * A.LOG2E)).to(torch.bfloat16).float()
    kf = k.float()
    if seg_len:
        G = N // seg_len
        s = torch.einsum("bgnhd,bgmhd->bgnhm",
                         qf.reshape(B, G, seg_len, H, D),
                         kf.reshape(B, G, seg_len, H, D)).reshape(
                             B, N, H, seg_len)
    else:
        s = torch.einsum("bnhd,bmhd->bnhm", qf, kf)
        if kv_mask is not None:
            s = s + torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                                float("-inf"))
    r = torch.exp2(s - s.amax(dim=-1, keepdim=True)).sum(dim=-1)
    del s
    vb = v_block if seg_len else M
    _, vs = A._v_quant(v.reshape(B, M, C), vb)
    vs_rows = (vs.repeat_interleave(vb, dim=1) if seg_len
               else vs.expand(B, N, C))
    return (vs_rows / (127.0 * r.repeat_interleave(D, dim=-1)
                       * scales.reshape(B, N, 1))).reshape(B * N, C)


def check_case(name, case, kernel_fn, plain_fn, records, cost=None,
               library_fn=None, library_note="", exact=False, asym=None,
               slack_fn=None, b2b=False, rel_err=REL_ERR):
    """Run kernel and plain version on the same inputs, compare every
    output (float outputs to rel_err; identical with exact; asym =
    ASYM_TOL[producer]: the outputs
    of an asym row quantizer by `compare_asym_rows`, its row sums
    unshifted; slack_fn(plain outputs): per-entry codes an int8-PV
    emission may differ beyond one, `int8_pv_slack`), time both and the
    library call (b2b: the kernel also back to back, its device time);
    append the result with its bound (cost = (bytes, ops))."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    max_abs, worst_frac, worst_rel = 0.0, 0.0, 0.0
    parts = []
    if len(got) != len(want) or [g is None for g in got] != [
            w is None for w in want]:
        fail(f"{name}/{case}: outputs {len(got)} (None at "
             f"{[g is None for g in got]}) != plain {len(want)} (None at "
             f"{[w is None for w in want]})")
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:  # an output this mode does not write
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}/{case}: output {i} {tuple(g.shape)} {g.dtype} != "
                 f"plain {tuple(w.shape)} {w.dtype}")
        is_codes = g.dtype == torch.int8
        if asym and i == 3:  # row sums of the unshifted codes, sum(q - zp)
            C = got[0].shape[-1]
            g, w = g - C * got[2], w - C * want[2]
        mx, frac, rel = compare(g, w, is_codes)
        if asym and i == 0:
            mx, frac, rel, other, srel = compare_asym_rows(got, want)
            parts.append(f"rows with another scale or zp {other:.3g} (limit "
                         f"{asym[1]:.3g}), scale rel err {srel:.3g} (limit "
                         f"{asym[0]:.3g}), q - zp")
            if rel > ASYM_DEQ_REL:
                fail(f"{name}/{case}: dequantized rel err {rel} > "
                     f"{ASYM_DEQ_REL}")
            if srel > asym[0] or other > asym[1]:
                fail(f"{name}/{case}: scale rel err {srel}, rows with "
                     f"another scale or zp {other}: limits {asym}")
        slack = slack_fn(want) if slack_fn is not None and i == 0 else None
        parts.append(f"out{i}: max_abs {mx:.3g} mismatch {frac:.3g} "
                     f"rel {rel:.3g}")
        if exact and not torch.equal(g, w):
            fail(f"{name}/{case}: output {i} differs (max abs {mx})")
        if is_codes:
            if slack is not None:  # beyond one code: by one softmax flip
                d = (g.float() - w.float()).abs().reshape(slack.shape)
                over = d > CODE_MAX_DIFF
                excess = float((d - CODE_MAX_DIFF - slack)[over].max()) if (
                    over.any()) else 0.0
                parts.append(f"{int(over.sum())} beyond {CODE_MAX_DIFF} "
                             f"(slack there {float(slack[over].max()) if over.any() else 0.0:.3g}, "
                             f"largest slack {float(slack.max()):.3g}, "
                             f"largest excess over the slack "
                             f"{excess if over.any() else 'none'})")
                if excess > 0 or frac > CODE_MISMATCH_FRAC:
                    fail(f"{name}/{case}: codes differ beyond one softmax "
                         f"flip (by {excess}) or too often ({frac})")
            elif mx > CODE_MAX_DIFF or frac > CODE_MISMATCH_FRAC:
                fail(f"{name}/{case}: codes differ (max {mx}, frac {frac})")
            max_abs = max(max_abs, mx)
        else:
            if rel > rel_err:
                fail(f"{name}/{case}: relative error {rel} > {rel_err}")
            max_abs = max(max_abs, mx)
        worst_frac = max(worst_frac, frac)
        worst_rel = max(worst_rel, rel)
    ms = cuda_ms(kernel_fn)
    b2b_ms = cuda_ms_back_to_back(kernel_fn) if b2b else None
    plain_ms = cuda_ms(plain_fn, reps=3)
    bound_ms, bound_by = bound(*cost)
    library_ms = None
    if library_fn is not None:
        library_ms = cuda_ms(library_fn)
    lib = ("" if library_ms is None
           else f" library {library_ms:.3f} ms{library_note}")
    b2b_note = "" if b2b_ms is None else f" (back to back {b2b_ms:.4f})"
    print(f"  {name:24s} {case:34s} kernel {ms:9.3f} ms{b2b_note}  plain "
          f"{plain_ms:9.3f} ms  bound {bound_ms:.4f} ms ({bound_by}){lib}"
          f"  | {'; '.join(parts)}", flush=True)
    records.setdefault(name, []).append(
        {"case": case, "max_abs_err": max_abs, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": library_ms})


def phase_kernels(records):
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    from viditq_tpu_torch.kernels import int_matmul as IM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def randi8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def rands(*shape, lo=1e-3, hi=2e-2):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def randw(k, n):
        """int8 weight [k, n], K-major (a view of [n, k] storage)"""
        return randi8(n, k).t()

    B, T, S, C, H, D, P = 2, 16, 1024, 1152, 16, 72, 120
    M = B * T * S
    print("phase kernels (main-path shapes)", flush=True)

    # K1: norm1 -> q/k/v and norm2 -> fc1
    x = randn(B, T * S, C)
    sh, sc = randn(B, 1, C, scale=0.1), randn(B, 1, C, scale=0.1)
    check_case("ln_modulate_quantize", "[2,16384,1152]",
               lambda: FM.ln_modulate_quantize(x, sh, sc),
               lambda: FM.ln_modulate_quantize_plain(x, sh, sc), records,
               cost=(2 * M * C + 2 * 2 * B * C + M * C + 4 * M, {}),
               b2b=True)
    # K4: the shared attn_temp q/k/v prequant
    x2 = x.reshape(M, C)
    check_case("quantize_rows", "[32768,1152]",
               lambda: FM.quantize_rows(x2),
               lambda: FM.quantize_rows_plain(x2), records,
               cost=(2 * M * C + M * C + 4 * M, {}), b2b=True)

    # K2: q/k/v/proj, fc1 emit (G=3), fc2 gw_x; every output identical to
    # the plain version (exact int32 sums, the same f32 operation order).
    # Weights K-major, as QuantLinear holds them.
    xq, xs = randi8(M, C), rands(M, 1)
    w, ws, b = randw(C, C), rands(1, C, lo=1e-4, hi=1e-3), randn(
        C, dtype=torch.float32, scale=0.1)

    def k2_cost(m, k, n, x_scales, out_bytes):
        return (m * k + k * n + 4 * m * x_scales + 8 * n + out_bytes,
                {"int8": 2 * m * n * k})
    check_case("int8_consumer_matmul", "plain [32768,1152]x[1152,1152]",
               lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b),
               lambda: FM.int8_consumer_matmul_plain(xq, xs, w, ws, b),
               records, cost=k2_cost(M, C, C, 1, 2 * M * C),
               library_fn=lambda: torch._int_mm(xq, w),
               library_note=INT_MM_NOTE, exact=True)
    yardsticks("int8_consumer_matmul plain", xq, w,
               lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b))
    w1, ws1 = randw(C, 4 * C), rands(1, 4 * C, lo=1e-4, hi=1e-3)
    b1 = randn(4 * C, dtype=torch.float32, scale=0.1)
    emit = {"gelu": True}
    check_case("int8_consumer_matmul", "emit [32768,1152]x[1152,4608]",
               lambda: FM.int8_consumer_matmul(xq, xs, w1, ws1, b1, emit=emit),
               lambda: FM.int8_consumer_matmul_plain(xq, xs, w1, ws1, b1,
                                                     emit=emit), records,
               cost=k2_cost(M, C, 4 * C, 1, M * 4 * C + 4 * M * 3),
               exact=True)
    # the emission's two passes apart: GEMM + GELU into the f32 scratch,
    # then the group quantize (scratch written and read: 2 x 604 MB)
    gemm_ms = cuda_ms(lambda: FM.k2_gemm(xq, xs, w1, ws1, b1, False, 2))
    scratch = FM.k2_gemm(xq, xs, w1, ws1, b1, False, 2)
    bn = FM.emit_groups(4 * C, C)
    gq_ms = cuda_ms(lambda: FM.group_quant(scratch, bn))
    print(f"  emission split: GEMM + GELU to f32 scratch {gemm_ms:.3f} ms, "
          f"group_quant {gq_ms:.3f} ms (scratch bound "
          f"{2 * 4 * M * 4 * C / HBM_BYTES_PER_S * 1e3:.3f} ms)", flush=True)
    del scratch
    yardsticks("int8_consumer_matmul emit", xq, w1,
               lambda: FM.int8_consumer_matmul(xq, xs, w1, ws1, b1, emit=emit))
    # the emission after a zero-point epilogue (fc1 with asym acts feeding
    # a sym x sym fc2; sym acts x asym weights too): identical to its plain
    # version, as the sym emission is
    for case, sym in (("emit asym acts [32768,1152]x[1152,4608]", False),
                      ("emit sym x asym-weight [32768,1152]x[1152,4608]",
                       True)):
        zq, zs, zz, zr = FM.quantize_rows(randn(M, C) + 0.2, sym=sym,
                                          need_rowsum=True)
        wz = (None if not sym else torch.randint(
            -20, 20, (1, 4 * C), generator=g, device=dev).float())
        kw = dict(x_zp=zz, x_rowsum=zr, w_zp=wz,
                  w_colsum=w1.float().sum(dim=0, keepdim=True))
        check_case("int8_consumer_matmul", case,
                   lambda: FM.int8_consumer_matmul(zq, zs, w1, ws1, b1,
                                                   emit=emit, **kw),
                   lambda: FM.int8_consumer_matmul_plain(zq, zs, w1, ws1, b1,
                                                         emit=emit, **kw),
                   records, cost=k2_cost(M, C, 4 * C, 3, M * 4 * C
                                         + 4 * M * 3), exact=True, b2b=True)
        zgemm_ms = cuda_ms(lambda: FM.k2_gemm_zp(zq, zs, w1, ws1, b1, 2,
                                                 zz, zr, wz,
                                                 kw["w_colsum"]))
        print(f"  emission with zero points split: GEMM + zero-point "
              f"epilogue + GELU to the f32 scratch {zgemm_ms:.3f} ms, then "
              f"the group quantize above", flush=True)
        del zq, zs, zz, zr
    xq2, xs2 = randi8(M, 4 * C), rands(M, 3)
    w2, ws2 = randw(4 * C, C), rands(1, C, lo=1e-5, hi=1e-4)
    check_case("int8_consumer_matmul", "gw_x [32768,4608]x[4608,1152]",
               lambda: FM.int8_consumer_matmul(xq2, xs2, w2, ws2, b,
                                               group_scales=True),
               lambda: FM.int8_consumer_matmul_plain(xq2, xs2, w2, ws2, b,
                                                     group_scales=True),
               records, cost=k2_cost(M, 4 * C, C, 3, 2 * M * C), exact=True)
    yardsticks("int8_consumer_matmul gw_x", xq2, w2,
               lambda: FM.int8_consumer_matmul(xq2, xs2, w2, ws2, b,
                                               group_scales=True))

    def sdpa_call(q, k, v, seg, m):
        """One PyTorch call computing the bf16-PV attention on [B,H,N,D]
        copies made here (the transposes are not timed)."""
        if seg:
            n_b, n = q.shape[0] * q.shape[1] // seg, seg
            qh, kh, vh = (t.reshape(n_b, n, H, D).transpose(1, 2).contiguous()
                          for t in (q, k, v))
        else:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = None if m is None else (m != 0)[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=am, scale=D ** -0.5)

    def kv_rows(m, n_b, kv):
        return ([kv] * n_b if m is None
                else [int(r) for r in (m != 0).sum(dim=1).tolist()])

    # K3: spatial / temporal / cross, in the bf16 arm's and sm8's modes
    sc_attn = D ** -0.5
    sites = {
        "spatial": (randn(B * T, S, H, D), randn(B * T, S, H, D),
                    randn(B * T, S, H, D), 0, None, False),
        "temporal": (randn(B, T * S, H, D), randn(B, T * S, H, D),
                     randn(B, T * S, H, D), T, None, True),
    }
    mask = torch.ones((B, P), dtype=torch.int32, device=dev)
    mask[1, 100:] = 0  # one padded prompt
    sites["cross"] = (randn(B, T * S, H, D), randn(B, P, H, D),
                      randn(B, P, H, D), 0, mask, True)
    # PixArt-Σ 1024 cross-attention: 4096 queries, 300 prompt tokens
    mask_s = torch.ones((B, 300), dtype=torch.int32, device=dev)
    mask_s[1, 200:] = 0
    sites["Σ cross"] = (randn(B, 4096, H, D), randn(B, 300, H, D),
                        randn(B, 300, H, D), 0, mask_s, True)
    for site, (q, k, v, seg, m, sm8_int8) in sites.items():
        nb, nq, kv = q.shape[0], q.shape[1], k.shape[1]
        for arm, int8_pv, emit_out in (("bf16", False, False),
                                       ("sm8", sm8_int8, True)):
            kw = dict(seg_len=seg, kv_mask=m, int8_pv=int8_pv, emit=emit_out)
            vb = A.seg_v_block(q.shape[1], seg) if (seg and int8_pv) else None
            cost = attn_bound(nb, nq, H, D,
                              [seg] * nb if seg else kv_rows(m, nb, kv),
                              int8_pv, emit_out, kv)
            if m is not None:
                cost = (cost[0] + 4 * nb * kv, cost[1])
            check_case(
                "attention_bnhd",
                f"{site} {arm}{' int8_pv' if int8_pv else ''}"
                f"{' emit' if emit_out else ''}",
                lambda: A.attention_bnhd(q, k, v, sc_attn, v_block=vb, **kw),
                lambda: A.attention_bnhd_plain(q, k, v, sc_attn, v_block=vb,
                                               **kw), records, cost=cost,
                library_fn=None if int8_pv or emit_out
                else sdpa_call(q, k, v, seg, m),
                library_note=" (scaled_dot_product_attention)",
                slack_fn=(lambda want, q=q, k=k, v=v, seg=seg, m=m, vb=vb:
                          int8_pv_slack(q, k, v, sc_attn, seg, m, vb,
                                        want[1]))
                if int8_pv and emit_out else None)

    # K3's seg mode at the temporal site back to back (its device time), the
    # v-quantize pass of its int8 PV alone, and SDPA on the same work
    q, k, v = sites["temporal"][:3]
    vb = A.seg_v_block(T * S, T)
    v3 = v.reshape(B, T * S, C)
    parts = []
    for label, fn in (
            ("bf16", lambda: A.attention_bnhd(q, k, v, sc_attn, seg_len=T)),
            ("sm8 int8_pv emit", lambda: A.attention_bnhd(
                q, k, v, sc_attn, seg_len=T, int8_pv=True, v_block=vb,
                emit=True)),
            ("its v quantize alone", lambda: A.seg_v_codes_cuda(v3, vb, True)),
            ("SDPA", sdpa_call(q, k, v, T, None))):
        parts.append(f"{label} {cuda_ms_back_to_back(fn):.4f} ms")
    print(f"  attention_bnhd temporal seg {T} back to back: "
          f"{'; '.join(parts)}", flush=True)
    del v3

    # K6: Σ-1024 self-attention, N = M = 4096, kv blocks of 1024
    Ns = 4096
    bkv = A.stream_kv_block(Ns, Ns, C)
    q, k, v = randn(B, Ns, H, D), randn(B, Ns, H, D), randn(B, Ns, H, D)
    smask = torch.ones((B, Ns), dtype=torch.int32, device=dev)
    smask[1, 1500:] = 0  # later kv blocks fully masked in one batch row
    for case, m, int8_pv, emit_out in (("bf16_pv", None, False, False),
                                       ("bf16_pv emit (K6->K4)", None, False,
                                        True),
                                       ("int8_pv", None, True, False),
                                       ("bf16_pv masked", smask, False,
                                        False)):
        def plain(m=m, int8_pv=int8_pv, emit_out=emit_out):
            o = A.attention_bnhd_stream_plain(q, k, v, sc_attn, bkv, m,
                                              int8_pv)
            if not emit_out:
                return o
            return A._bn1(B, Ns, *FM.quantize_rows_plain(
                o.reshape(B * Ns, C)))
        cost = attn_bound(B, Ns, H, D, kv_rows(m, B, Ns), int8_pv, emit_out,
                          Ns)
        if m is not None:
            cost = (cost[0] + 4 * B * Ns, cost[1])
        check_case(
            "attention_bnhd_stream", f"[2,4096,16,72] bkv {bkv} {case}",
            lambda m=m, int8_pv=int8_pv, emit_out=emit_out:
                A.attention_bnhd_stream(q, k, v, sc_attn, m, int8_pv,
                                        emit_out),
            plain, records, cost=cost,
            library_fn=None if int8_pv or emit_out
            else sdpa_call(q, k, v, 0, m),
            library_note=" (scaled_dot_product_attention)")

    attention_edge_cases(records, randn)
    f32_attention_cases(records)
    bf16_grad_cases()

    # K5 (one launch of csrc/dynq_gemm.cu): cross_attn.kv_linear and
    # cross_attn.q_linear, sym x sym (the sm8 and sym arms, Σ sm8)
    for case, (m_rows, n) in (
            ("kv_linear [240,1152]x[1152,2304]", (B * P, 2 * C)),
            ("q_linear [32768,1152]x[1152,1152]", (M, C))):
        xa = randn(m_rows, C)
        wa, wsa = randw(C, n), rands(1, n, lo=1e-4, hi=1e-3)
        ba = randn(n, dtype=torch.float32, scale=0.1)
        check_k5(records, case, xa, wa, wsa, ba)
        del xa

    # K7a (the native backend's act quantize): every step is exact or
    # correctly rounded, so codes, scales, zp and rowsum are identical. A
    # warp per row: rows up to 9 chunks of 16 a lane (bf16 K <= 4608, f32
    # K <= 2560) are read once, longer rows twice (the f32 K = 4608 and
    # bf16 K = 16384 rows, above the former 16 KB row limit)
    for case, (m_rows, k, sym, dt) in (
            ("asym [32768,1152]", (M, C, False, torch.bfloat16)),
            ("asym [32768,4608] (fc2 input)", (M, 4 * C, False,
                                               torch.bfloat16)),
            ("sym [32768,1152]", (M, C, True, torch.bfloat16)),
            ("asym [19,72] (ragged row)", (19, 72, False, torch.bfloat16)),
            ("asym [32768,4608] f32 (18 KB rows)", (M, 4 * C, False,
                                                    torch.float32)),
            ("sym [4096,16384] (32 KB rows)", (4096, 16384, True,
                                               torch.bfloat16)),
            # PixArt-Σ 1024's native rows (phase recon_sigma's
            # quant-generate): 2 x 4096 tokens, 2 x 300 prompt tokens
            ("Σ asym [8192,1152]", (B * 4096, C, False, torch.bfloat16)),
            ("Σ asym [8192,4608] (fc2 input)", (B * 4096, 4 * C, False,
                                                torch.bfloat16)),
            ("Σ asym [600,1152] (kv_linear input)", (B * 300, C, False,
                                                     torch.bfloat16))):
        xa = randn(m_rows, k, dtype=dt) + 0.2
        esize = torch.empty((), dtype=dt).element_size()
        check_case("dynamic_quant_rows", case,
                   lambda: IM.dynamic_quant_rows(xa, sym),
                   lambda: IM.dynamic_quant_rows_plain(xa, sym), records,
                   cost=((esize + 1) * m_rows * k + 12 * m_rows, {}),
                   exact=True, b2b=case == "asym [32768,1152]")
        del xa

    # K7b at the w8a8 arm's four shapes and at PixArt-Σ 1024's (phase
    # recon_sigma's native quant-generate: 8192 token rows, 600 prompt
    # rows), asym x asym, bf16 out, bias, identical to the plain version
    def k7b_inputs(m_rows, k, n):
        xq_, xs_, xz_, xr_ = IM.dynamic_quant_rows(randn(m_rows, k))
        wq_ = randw(k, n)
        return (xq_, wq_, xs_, xz_, xr_,
                rands(1, n, lo=1e-4, hi=1e-3),
                torch.randint(-20, 20, (1, n), generator=g,
                              device=dev).float(),
                wq_.float().sum(dim=0, keepdim=True),
                randn(n, dtype=torch.float32, scale=0.1))
    for i, (case, (m_rows, k, n)) in enumerate((
            ("q/k/v/proj [32768,1152]x[1152,1152]", (M, C, C)),
            ("fc1 [32768,1152]x[1152,4608]", (M, C, 4 * C)),
            ("fc2 [32768,4608]x[4608,1152]", (M, 4 * C, C)),
            ("kv_linear [240,1152]x[1152,2304]", (B * P, C, 2 * C)),
            ("Σ q/k/v/proj [8192,1152]x[1152,1152]", (B * 4096, C, C)),
            ("Σ fc1 [8192,1152]x[1152,4608]", (B * 4096, C, 4 * C)),
            ("Σ fc2 [8192,4608]x[4608,1152]", (B * 4096, 4 * C, C)),
            ("Σ kv_linear [600,1152]x[1152,2304]", (B * 300, C, 2 * C)))):
        *tabs, bb = k7b_inputs(m_rows, k, n)
        xq_, wq_ = tabs[0], tabs[1]
        check_case("int8_matmul", case,
                   lambda: IM.int8_matmul(*tabs, bias=bb),
                   lambda: IM.int8_matmul_plain(*tabs, bias=bb), records,
                   cost=k7b_cost(m_rows, k, n, 2),
                   library_fn=(lambda: torch._int_mm(xq_, wq_)) if i == 0
                   else None, library_note=INT_MM_NOTE, exact=True)
        if not case.startswith("Σ"):
            yardsticks(f"int8_matmul {case.split()[0]}", xq_, wq_,
                       lambda: IM.int8_matmul(*tabs, bias=bb))

    gemm_edge_cases(records, randn, randi8, rands)
    asym_cases(records)
    cb_cases(records)
    epilogue_cases(records)
    attn8_cases(records)
    row_edge_cases(records)
    k5_edge_cases(records)
    k5_wide_cases(records)
    head_dim_cases(records)
    dit_l_cases(records)
    wide_path_cases(records)
    backbone_cases(records)
    int8_pv_draws()


def epilogue_cases(records):
    """The residual (+ gate) epilogue (`o = res + gate * out` in f32 after
    the bias) at the `sm8_epi` arm's shapes, on draws of their own
    generator: K2 in every mode it composes with (sym x sym at the spatial
    proj with the adaLN gate of each batch row, G = 2; fc2's gw_x on three
    k-groups; both zero-point epilogues; the residual alone, as the cross
    proj takes it; a gate of 4 rows of 250 straddling the 128-row tiles;
    a last M tile whose second warpgroup's rows all lie past M),
    each identical to its plain version and timed back to back beside the
    same call without it; K5 in its three act x weight modes with residual
    and gate, identical to the K4 -> K2 + residual route in the same run
    (`check_k5`), and at a ragged M tile with 3 gate rows of 100."""
    import torch
    from viditq_tpu_torch.kernels import fused_matmul as FM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def rands(*shape, lo=1e-4, hi=1e-3):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def randw(k, n):
        """int8 weight [k, n], K-major, with zero points and column sums"""
        w = torch.randint(-128, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8).t()
        wz = torch.randint(-20, 20, (1, n), generator=g, device=dev).float()
        return w, wz, w.float().sum(dim=0, keepdim=True)

    B, T, S, C = 2, 16, 1024, 1152
    M = B * T * S
    print("phase kernels: residual (+ gate) epilogue (sm8_epi shapes)",
          flush=True)
    res = randn(M, C)
    gate = randn(B, C, scale=0.5)
    for case, (k, G, mode, with_gate) in (
            ("sym proj +res+gate [32768,1152]x[1152,1152] G=2",
             (C, 1, "sym", True)),
            ("gw_x fc2 +res+gate [32768,4608]x[4608,1152] 3 groups",
             (4 * C, 3, "sym", True)),
            ("asym zp +res+gate [32768,1152]x[1152,1152]",
             (C, 1, "asym", True)),
            ("sym x asym-weight zp +res+gate [32768,1152]x[1152,1152]",
             (C, 1, "symx", True)),
            ("sym cross proj +res [32768,1152]x[1152,1152]",
             (C, 1, "sym", False))):
        w, wz, wc = randw(k, C)
        ws, b = rands(1, C), randn(C, dtype=torch.float32, scale=0.1)
        if mode == "sym":
            xq = torch.randint(-127, 128, (M, k), generator=g, device=dev,
                               dtype=torch.int8)
            kw = dict(group_scales=G > 1)
            xs = rands(M, G, lo=1e-3, hi=2e-2)
        else:
            xq, xs, xz, xr = FM.quantize_rows(randn(M, k) + 0.2,
                                              sym=mode == "symx",
                                              need_rowsum=True)
            kw = dict(x_zp=xz, x_rowsum=xr, w_zp=wz, w_colsum=wc)
        epi = dict(residual=res, gate=gate if with_gate else None)
        check_case("int8_consumer_matmul", case,
                   lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b, **kw,
                                                   **epi),
                   lambda: FM.int8_consumer_matmul_plain(xq, xs, w, ws, b,
                                                         **kw, **epi),
                   records, cost=(M * k + k * C + 4 * M * G + 16 * C
                                  + 2 * M * C + 2 * M * C
                                  + 2 * B * C * with_gate,
                                  {"int8": 2 * M * C * k}), exact=True)
        with_and_without("int8_consumer_matmul", case,
                         lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b,
                                                         **kw, **epi),
                         lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b,
                                                         **kw),
                         what="residual")
        del xq, xs
    # a gate whose rows straddle the 128-row tiles (4 gates of 250 rows),
    # and a last M tile whose second warpgroup's 64 rows all lie past M
    # (its residual box wholly outside the tensor, zero-filled by TMA)
    for m, G, sym in ((1000, 4, False), (300, 3, True)):
        xq, xs, xz, xr = FM.quantize_rows(randn(m, C) + 0.2, sym=sym,
                                          need_rowsum=True)
        w, wz, wc = randw(C, C)
        ws, b = rands(1, C), randn(C, dtype=torch.float32, scale=0.1)
        kw = dict(residual=randn(m, C), gate=randn(G, C))
        if not sym:
            kw.update(x_zp=xz, x_rowsum=xr, w_zp=wz, w_colsum=wc)
        check_case("int8_consumer_matmul",
                   f"edge {'sym' if sym else 'asym'} +res+gate M={m} G={G} "
                   f"({'rows past M' if sym else 'gate rows straddle tiles'})",
                   lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b, **kw),
                   lambda: FM.int8_consumer_matmul_plain(xq, xs, w, ws, b,
                                                         **kw),
                   records, cost=(k7b_cost(m, C, C, 2)[0] + 2 * m * C,
                                  {"int8": 2 * m * C * C}), exact=True)

    # K5 with residual and gate: q_linear-shaped, each act x weight mode
    x = randn(M, C)
    for case, (sym, sym_w) in (
            ("sym +res+gate [32768,1152]x[1152,1152] G=2", (True, True)),
            ("sym x asym-weight +res+gate [32768,1152]x[1152,1152] G=2",
             (True, False)),
            ("asym +res+gate [32768,1152]x[1152,1152] G=2", (False, False))):
        w, wz, wc = randw(C, C)
        ws, b = rands(1, C), randn(C, dtype=torch.float32, scale=0.1)
        check_k5(records, case, x, w, ws, b, sym=sym, sym_w=sym_w, w_zp=wz,
                 w_colsum=wc, residual=res, gate=gate)
        with_and_without("fused_dynq_int8_matmul", case,
                         lambda: FM.fused_dynq_int8_matmul(
                             x, w, ws, b, sym=sym, sym_w=sym_w, w_zp=wz,
                             w_colsum=wc, residual=res, gate=gate),
                         lambda: FM.fused_dynq_int8_matmul(
                             x, w, ws, b, sym=sym, sym_w=sym_w, w_zp=wz,
                             w_colsum=wc), what="residual")
    del x
    m = 300
    w, wz, wc = randw(C, C)
    check_k5(records, "edge asym +res+gate M=300 G=3 (ragged M tile)",
             randn(m, C), w, rands(1, C), randn(C, dtype=torch.float32),
             timed=False, sym=False, sym_w=False, w_zp=wz, w_colsum=wc,
             residual=randn(m, C), gate=randn(3, C))


def attn8_cases(records):
    """The attn8 plan's attention quantizers at its main-path shapes, on
    draws of their own generator: K8 (one launch for q and k) at the
    spatial, temporal and cross sites, identical to its plain version; K3
    with int8_qk (K8, then int8 PV and the emission, as the attn8 arm runs
    every site) at the three sites against the plain versions, codes to
    the code tolerance, past one code by `int8_pv_slack` (C12) of the
    quantized q and k, the largest excess over that slack printed; then K8
    -> K6 with int8_qk at PixArt-Σ's self-attention, bf16 and int8 PV, its
    emission through K4."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    B, T, S, H, D, P = 2, 16, 1024, 16, 72, 120
    sc = D ** -0.5
    print("phase kernels: attn8 (K8, K3 and K6 int8_qk)", flush=True)
    mask = torch.ones((B, P), dtype=torch.int32, device=dev)
    mask[1, 100:] = 0
    sites = {"spatial": (B * T, S, S, 0, None),
             "temporal": (B, T * S, T * S, T, None),
             "cross": (B, T * S, P, 0, mask)}
    for site, (nb, nq, kv, seg, m) in sites.items():
        q, k, v = randn(nb, nq, H, D), randn(nb, kv, H, D), randn(nb, kv, H, D)
        qk_bytes = 4 * (q.numel() + k.numel())
        check_case("qk_headwise_quant",
                   f"{site} q {list(q.shape)} k {list(k.shape)}",
                   lambda: A.qk_headwise_quant(q, k),
                   lambda: A.qk_headwise_quant_plain(q, k), records,
                   cost=(qk_bytes, {}), exact=True, b2b=True)
        vb = A.seg_v_block(nq, seg) if seg else None
        kw = dict(seg_len=seg, kv_mask=m, int8_qk=True, int8_pv=True,
                  v_block=vb, emit=True)
        rows = ([seg] * nb if seg else [kv] * nb if m is None
                else [int(r) for r in (m != 0).sum(dim=1).tolist()])
        nbytes, ops = attn_bound(nb, nq, H, D, rows, True, True, kv)
        nbytes += qk_bytes + (0 if m is None else 4 * nb * kv)
        qd, kd = A.qk_headwise_quant_plain(q, k)
        check_case("attention_bnhd", f"{site} attn8 int8_qk int8_pv emit",
                   lambda: A.attention_bnhd(q, k, v, sc, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, **kw),
                   records, cost=(nbytes, ops),
                   slack_fn=lambda want, qd=qd, kd=kd, v=v, seg=seg, m=m,
                   vb=vb: int8_pv_slack(qd, kd, v, sc, seg, m, vb, want[1]))
        del q, k, v, qd, kd
    # K8 -> K6 with int8_qk at PixArt-Σ 1024's self-attention (no Σ arm
    # runs the attn8 plan), with the bf16 PV and with the int8 PV, each
    # emitting through K4: codes to the code tolerance, past one code (int8
    # PV) by `int8_pv_slack` of the quantized q and k
    Ns, C = 4096, H * D
    bkv = A.stream_kv_block(Ns, Ns, C)
    q, k, v = randn(B, Ns, H, D), randn(B, Ns, H, D), randn(B, Ns, H, D)
    qd, kd = A.qk_headwise_quant_plain(q, k)
    for int8_pv in (False, True):
        def plain(int8_pv=int8_pv):
            qq, kk = A.qk_headwise_quant_plain(q, k)
            o = A.attention_bnhd_stream_plain(qq, kk, v, sc, bkv, None,
                                              int8_pv)
            return A._bn1(B, Ns, *FM.quantize_rows_plain(
                o.reshape(B * Ns, C)))
        nbytes, ops = attn_bound(B, Ns, H, D, [Ns] * B, int8_pv, True, Ns)
        check_case("attention_bnhd_stream",
                   f"Σ [2,4096,16,72] int8_qk {'int8' if int8_pv else 'bf16'}"
                   f"_pv emit (K8->K6->K4)",
                   lambda int8_pv=int8_pv: A.attention_bnhd(
                       q, k, v, sc, int8_qk=True, int8_pv=int8_pv,
                       emit=True), plain, records,
                   cost=(nbytes + 4 * (q.numel() + k.numel()), ops),
                   slack_fn=(lambda want: int8_pv_slack(
                       qd, kd, v, sc, 0, None, None, want[1]))
                   if int8_pv else None)
    del q, k, v, qd, kd


def k5_route(x, w, ws, b, out_dtype=None, sym=True, sym_w=True, w_zp=None,
             w_colsum=None, col_scale=None, residual=None, gate=None):
    """K5's function as the port served it before its own kernel: K4's row
    quantize (with the column scale), then K2 on the codes (two launches).
    K2 takes K % 64 == 0: a narrower sym K runs on codes and weights padded
    with zero codes, which add nothing to the int32 sums (asym acts would
    change K's term)."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import fused_matmul as FM
    from viditq_tpu_torch.kernels._common import k_major
    q, s, zp, rs = FM.quantize_rows(x, sym, need_rowsum=not (sym and sym_w),
                                    col_scale=col_scale)
    K = x.shape[1]
    N = w.shape[1]
    if K % 64:
        if not sym:
            fail("the K4 -> K2 route takes asym acts at K % 64 == 0 only")
        pad = -K % 64
        q = F.pad(q, (0, pad))
        w = k_major(F.pad(w, (0, 0, 0, pad)))
    pn = -N % 16  # K2 takes N % 16 == 0: zero weight columns, sliced off
    if pn:
        w = k_major(F.pad(w, (0, pn)))
        ws, w_zp, w_colsum, b, residual, gate = (
            None if t is None else F.pad(t, (0, pn))
            for t in (ws, w_zp, w_colsum, b, residual, gate))
    out = FM.int8_consumer_matmul(
        q, s, w, ws, b, out_dtype or torch.bfloat16, x_zp=zp, x_rowsum=rs,
        w_zp=None if sym_w else w_zp, w_colsum=w_colsum, residual=residual,
        gate=gate)
    return out[:, :N].contiguous() if pn else out


def check_k5(records, case, x, w, ws, b, timed=True, **kw):
    """K5 at one shape and mode, three ways: (a) identical to the K4 -> K2
    route (`k5_route`) on the same inputs in this run; (b) against its plain
    version by `check_case` (float outputs to REL_ERR: the plain sym row
    quantize divides by 127 as a reciprocal multiply on the card); (c) timed
    one call and back to back beside the route back to back and cuBLAS bf16
    x @ W of the same shape (unquantized; the library time)."""
    import torch
    from viditq_tpu_torch.kernels import _counters
    from viditq_tpu_torch.kernels import fused_matmul as FM
    name = "fused_dynq_int8_matmul"
    counts = {k: _counters.COUNTERS[k].launches
              for k in ("quantize_rows", "int8_consumer_matmul", name)}
    got = FM.fused_dynq_int8_matmul(x, w, ws, b, **kw)
    moved = {k: _counters.COUNTERS[k].launches - n
             for k, n in counts.items()}
    if moved != {"quantize_rows": 0, "int8_consumer_matmul": 0, name: 1}:
        fail(f"{name}/{case}: one call launched {moved}")
    want = k5_route(x, w, ws, b, **kw)
    if not torch.equal(got, want):
        d = (got.float() - want.float()).abs()
        fail(f"{name}/{case}: differs from the K4 -> K2 route at "
             f"{int((d > 0).sum())} entries (max abs {float(d.max())})")
    m, k = x.shape
    n = w.shape[1]
    out_bytes = 4 if kw.get("out_dtype") == torch.float32 else 2
    tables = 2 + (not kw.get("sym_w", True)) + (not kw.get("sym", True))
    res, gate = kw.get("residual"), kw.get("gate")
    cost = (x.element_size() * m * k + k * n + 4 * tables * n
            + 4 * k * (kw.get("col_scale") is not None)
            + (0 if res is None else 2 * m * n)
            + (0 if gate is None else 2 * gate.numel())
            + out_bytes * m * n, {"int8": 2 * m * n * k})
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    check_case(name, case, lambda: FM.fused_dynq_int8_matmul(x, w, ws, b, **kw),
               lambda: FM.fused_dynq_int8_matmul_plain(x, w, ws, b, **kw),
               records, cost=cost, library_fn=lambda: xb @ wb,
               library_note=" (cuBLAS bf16 x @ W, unquantized)", b2b=timed)
    if timed:
        route = cuda_ms_back_to_back(lambda: k5_route(x, w, ws, b, **kw))
        lib = cuda_ms_back_to_back(lambda: xb @ wb)
        print(f"  yardsticks {name} {case}: identical to the K4 -> K2 route; "
              f"route back to back {route:.4f} ms; cuBLAS bf16 x @ W back "
              f"to back {lib:.4f} ms", flush=True)


def k5_wide_cases(records):
    """K5 at fc2's shape, [32768, 4608] x [4608, 1152], wider than its
    resident codes (the wide schedule): each act x weight mode, with and
    without the residual (+ gate) epilogue, identical to the K4 -> K2 route
    and timed beside it and cuBLAS bf16 (`check_k5`). No shipped plan
    sends fc2 to K5 (JAX's MLP hands fc2 its codes, `emit1`), so these are
    kernel cases."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(23)
    M, K, N = 32768, 4608, 1152
    print("phase kernels: K5 wide K (fc2's shape)", flush=True)
    x = (torch.randn((M, K), generator=g, device="cuda") * 2.0
         + 0.2).to(torch.bfloat16)
    w = torch.randint(-128, 128, (N, K), generator=g, device="cuda",
                      dtype=torch.int8).t()
    ws = 1e-4 + 9e-4 * torch.rand((1, N), generator=g, device="cuda")
    b = torch.randn(N, generator=g, device="cuda") * 0.1
    wz = torch.randint(-20, 20, (1, N), generator=g, device="cuda").float()
    wc = w.float().sum(dim=0, keepdim=True)
    res = torch.randn((M, N), generator=g, device="cuda").to(torch.bfloat16)
    gate = (torch.randn((2, N), generator=g, device="cuda")
            * 0.5).to(torch.bfloat16)
    for mode in ("sym", "symx", "asym"):
        kw = dict(sym=mode != "asym", sym_w=mode == "sym")
        if mode != "sym":
            kw.update(w_zp=wz, w_colsum=wc)
        for epi in (False, True):
            extra = dict(residual=res, gate=gate) if epi else {}
            check_k5(records, f"fc2 {mode}{' +res+gate' if epi else ''} "
                     f"[32768,4608]x[4608,1152]", x, w, ws, b, **kw, **extra)


def k5_edge_cases(records):
    """K5 at the shapes K5_EDGE_CASES lists, on draws of their own
    generator, each identical to the K4 -> K2 route and within tolerance of
    its plain version (`check_k5`): ragged tiles, narrow, wide and
    unaligned K, N % 16 != 0, f32 input, zero rows."""
    import torch
    from viditq_tpu_torch.kernels import fused_matmul as FM
    g = torch.Generator(device="cuda").manual_seed(3)
    if not any(p["K"] > FM.K5_MAX_K for _, p in K5_EDGE_CASES):
        fail("K5_EDGE_CASES lost its wide-K cases")
    print("phase kernels: K5 edge cases", flush=True)
    for case, p in K5_EDGE_CASES:
        m, k, n, mode = p["M"], p["K"], p["N"], p.get("mode", "sym")
        dt = torch.float32 if p.get("f32") else torch.bfloat16
        x = (torch.randn((m, k), generator=g, device="cuda") * 2.0
             + 0.2).to(dt)
        for r in p.get("zero_rows", ()):
            x[r] = 0
        w = torch.randint(-128, 128, (n, k), generator=g, device="cuda",
                          dtype=torch.int8).t()
        ws = 1e-4 + 9e-4 * torch.rand((1, n), generator=g, device="cuda")
        b = torch.randn(n, generator=g, device="cuda") * 0.1
        kw = dict(sym=mode != "asym", sym_w=mode == "sym")
        if mode != "sym":
            kw.update(w_zp=torch.randint(-20, 20, (1, n), generator=g,
                                         device="cuda").float(),
                      w_colsum=w.float().sum(dim=0, keepdim=True))
        if p.get("f32_out"):
            kw["out_dtype"] = torch.float32
        check_k5(records, f"edge {case}", x, w, ws, b, timed=False, **kw)


def asym_cases(records):
    """The asymmetric modes at the fused reference plan's main-path shapes
    (`w8a8_tpu_fused.yaml`), on draws of their own generator: K1 asym with
    zero points and row sums, K4 asym and its GELU handoff and K2's
    zero-point epilogues (each identical to its plain version), K5 asym at
    kv_linear and K3's asym emission with row sums at STDiT's three sites
    (bf16 PV)."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def rands(*shape, lo=1e-4, hi=1e-3):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def randw(k, n):
        """int8 weight [k, n], K-major, with zero points and column sums"""
        w = torch.randint(-128, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8).t()
        wz = torch.randint(-20, 20, (1, n), generator=g, device=dev).float()
        return w, wz, w.float().sum(dim=0, keepdim=True)

    B, T, S, C, H, D, P = 2, 16, 1024, 1152, 16, 72, 120
    M = B * T * S
    print("phase kernels: asymmetric modes (w8a8_tpu_fused.yaml shapes)",
          flush=True)
    x = randn(B, T * S, C) + 0.2
    sh, sc = randn(B, 1, C, scale=0.1), randn(B, 1, C, scale=0.1)
    check_case("ln_modulate_quantize", "asym [2,16384,1152]",
               lambda: FM.ln_modulate_quantize(x, sh, sc, sym=False),
               lambda: FM.ln_modulate_quantize_plain(x, sh, sc, sym=False),
               records, cost=(2 * M * C + 2 * 2 * B * C + M * C + 12 * M, {}),
               asym=ASYM_TOL["ln"], b2b=True)
    x2 = x.reshape(M, C)
    check_case("quantize_rows", "asym [32768,1152]",
               lambda: FM.quantize_rows(x2, sym=False),
               lambda: FM.quantize_rows_plain(x2, sym=False), records,
               cost=(2 * M * C + M * C + 12 * M, {}), exact=True, b2b=True)
    h = randn(M, 4 * C)
    check_case("quantize_rows", "gelu asym [32768,4608] (fc1 -> fc2)",
               lambda: FM.quantize_rows(h, sym=False, gelu=True),
               lambda: FM.quantize_rows_plain(h, sym=False, gelu=True),
               records, cost=(2 * M * 4 * C + M * 4 * C + 12 * M, {}),
               exact=True, b2b=True)
    del h

    # K2: asym acts x asym weights at q/k/v/proj, fc1 (bf16 out) and fc2
    # (on K4's GELU codes), sym acts x asym weights at q/k/v; bf16 out
    # with bias, each identical to its plain version
    for case, (k, n, sym) in (
            ("asym q/k/v/proj [32768,1152]x[1152,1152]", (C, C, False)),
            ("asym fc1 [32768,1152]x[1152,4608]", (C, 4 * C, False)),
            ("asym fc2 [32768,4608]x[4608,1152]", (4 * C, C, False)),
            ("sym x asym-weight [32768,1152]x[1152,1152]", (C, C, True))):
        xq, xs, xz, xr = FM.quantize_rows(randn(M, k) + 0.2, sym=sym,
                                          need_rowsum=True)
        w, wz, wc = randw(k, n)
        ws, b = rands(1, n), randn(n, dtype=torch.float32, scale=0.1)
        kw = dict(x_zp=xz, x_rowsum=xr, w_zp=wz, w_colsum=wc)
        check_case("int8_consumer_matmul", case,
                   lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b, **kw),
                   lambda: FM.int8_consumer_matmul_plain(xq, xs, w, ws, b,
                                                         **kw),
                   records, cost=k7b_cost(M, k, n, 2), exact=True)
        if not sym:
            yardsticks(f"int8_consumer_matmul {case.split()[1]}", xq, w,
                       lambda: FM.int8_consumer_matmul(xq, xs, w, ws, b,
                                                       **kw))
        del xq, xs, xz, xr

    # K5 (one launch): cross_attn.kv_linear and q_linear, asym acts x asym
    # weights (the fused arm), and kv_linear with sym acts x asym weights
    for case, (m_rows, n, sym) in (
            ("asym kv_linear [240,1152]x[1152,2304]", (B * P, 2 * C, False)),
            ("asym q_linear [32768,1152]x[1152,1152]", (M, C, False)),
            ("sym x asym-weight kv_linear [240,1152]x[1152,2304]",
             (B * P, 2 * C, True))):
        xa = randn(m_rows, C)
        wa, wza, wca = randw(C, n)
        wsa, ba = rands(1, n), randn(n, dtype=torch.float32, scale=0.1)
        check_k5(records, case, xa, wa, wsa, ba, sym=sym, sym_w=False,
                 w_zp=wza, w_colsum=wca)
        del xa

    # K3: asym emission with row sums, bf16 PV, at the three STDiT sites
    mask = torch.ones((B, P), dtype=torch.int32, device=dev)
    mask[1, 100:] = 0
    for site, (nb, nq, kv, seg, m) in (
            ("spatial", (B * T, S, S, 0, None)),
            ("temporal", (B, T * S, T * S, T, None)),
            ("cross", (B, T * S, P, 0, mask))):
        q, k, v = randn(nb, nq, H, D), randn(nb, kv, H, D), randn(nb, kv, H, D)
        kw = dict(seg_len=seg, kv_mask=m, emit=True, emit_sym=False,
                  need_rowsum=True)
        rows = ([seg] * nb if seg else [kv] * nb if m is None
                else [int(r) for r in (m != 0).sum(dim=1).tolist()])
        nbytes, ops = attn_bound(nb, nq, H, D, rows, False, True, kv)
        nbytes += 8 * nb * nq + (0 if m is None else 4 * nb * kv)
        check_case("attention_bnhd", f"{site} fused asym emit",
                   lambda: A.attention_bnhd(q, k, v, D ** -0.5, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, D ** -0.5, **kw),
                   records, cost=(nbytes, ops), asym=ASYM_TOL["attn"])
        del q, k, v


def cb_col_scales(g, k, edge=False, alpha=CB_ALPHA):
    """1/cs as a CB model folds it, f32 [k] on the card: cs =
    smooth_quant_scale of random act maxima (0.01 to 8) and weight maxima
    (1e-3 to 0.1) at the recipe's alpha; edge: cs log-uniform over 1e-3 to
    1e3 with every 7th channel exactly 1."""
    import torch
    from viditq_tpu_torch.quant.core import smooth_quant_scale
    u = torch.rand((2, k), generator=g, device="cuda")
    if edge:
        cs = torch.exp((u[0] * 2 - 1) * float(np.log(1e3)))
        cs[::7] = 1.0
    else:
        cs = smooth_quant_scale(0.01 + 7.99 * u[0], 1e-3 + 0.099 * u[1],
                                alpha)
    return torch.full_like(cs, 1.0) / cs


def with_and_without(name, case, fn, fn_without, what="col_scale"):
    """One line: the call back to back with its column scale (or `what`)
    and without it, on the same inputs (device time per call)."""
    print(f"  back to back {name} {case}: with {what} "
          f"{cuda_ms_back_to_back(fn):.4f} ms, without "
          f"{cuda_ms_back_to_back(fn_without):.4f} ms", flush=True)


def cb_cases(records):
    """The column-scale modes of channel balancing at the shapes of the
    `cb` and `cb_sym` arms (STDiT-XL/2, W4A8 CB recipe), on draws of their
    own generator, each timed back to back beside the same call without
    its column scale: K4 sym and asym (attn_temp's shared q/k/v prequant)
    and its GELU handoff (fc2's 1/cs after the GELU), asym identical to
    the plain version, sym to the code tolerance; K5 at q_linear and kv_linear on W4 codes, identical to
    K4(col_scale) -> K2 in this run (`check_k5`); K3's emission with the
    proj's 1/cs at the spatial, temporal and cross sites (bf16 PV), asym
    by `compare_asym_rows`, sym by the code tolerance; K2's GELU emission
    with fc2's 1/cs (cb_sym's fc1), identical; K6's asym emission through
    K4 with the proj's 1/cs at the Σ `cb` arm's self-attention shape (N =
    M = 4096, alpha 0.3), by `compare_asym_rows`; K5 at the Σ `cb` arm's
    patch embed (K = 16) and final linear (N = 32), asym W6 with +cs. One
    edge column scale (1e-3 to 1e3, ones) in K4 and K5."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def rands(*shape, lo=1e-3, hi=1e-2):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def randw4(k, n, sym):
        """W4 codes as the CB slabs hold them, [k, n] K-major: sym in
        [-8, 7]; asym shifted by 8 into [-8, 7] with zero points in
        [-8, 7] and column sums"""
        w = torch.randint(-8, 8, (n, k), generator=g, device=dev,
                          dtype=torch.int8).t()
        if sym:
            return w, None, None
        wz = torch.randint(-8, 8, (1, n), generator=g, device=dev).float()
        return w, wz, w.float().sum(dim=0, keepdim=True)

    B, T, S, C, H, D, P = 2, 16, 1024, 1152, 16, 72, 120
    M = B * T * S
    print("phase kernels: channel-balancing column scales (cb, cb_sym "
          "shapes)", flush=True)
    ics = cb_col_scales(g, C)
    edge = cb_col_scales(g, C, edge=True)
    x2 = randn(M, C) + 0.2
    for case, sym, cs in (("cb_sym col_scale sym [32768,1152]", True, ics),
                          ("cb col_scale asym [32768,1152]", False, ics),
                          ("cb col_scale asym [32768,1152] edge scales",
                           False, edge)):
        # asym identical; sym by the code tolerance, as the main K4 case:
        # the plain sym scale's `absmax / 127` is a reciprocal multiply on
        # the card
        check_case("quantize_rows", case,
                   lambda: FM.quantize_rows(x2, sym, col_scale=cs),
                   lambda: FM.quantize_rows_plain(x2, sym, col_scale=cs),
                   records, cost=(2 * M * C + M * C + 12 * M + 4 * C, {}),
                   exact=not sym)
        if cs is ics:
            with_and_without("quantize_rows", case,
                             lambda: FM.quantize_rows(x2, sym, col_scale=cs),
                             lambda: FM.quantize_rows(x2, sym))
    ics4 = cb_col_scales(g, 4 * C)
    h = randn(M, 4 * C)
    case = "cb col_scale gelu asym [32768,4608] (fc1 -> fc2)"
    check_case("quantize_rows", case,
               lambda: FM.quantize_rows(h, sym=False, gelu=True,
                                        col_scale=ics4),
               lambda: FM.quantize_rows_plain(h, sym=False, gelu=True,
                                              col_scale=ics4),
               records, cost=(2 * M * 4 * C + M * 4 * C + 12 * M + 16 * C,
                              {}), exact=True)
    with_and_without("quantize_rows", case,
                     lambda: FM.quantize_rows(h, sym=False, gelu=True,
                                              col_scale=ics4),
                     lambda: FM.quantize_rows(h, sym=False, gelu=True))
    del h

    # K5: cross_attn.q_linear and kv_linear with their own 1/cs folded
    # into the quantize (asym acts x asym W4 in cb, sym x sym in cb_sym)
    for case, (m_rows, n, sym, cs) in (
            ("cb col_scale asym q_linear [32768,1152]x[1152,1152] W4",
             (M, C, False, ics)),
            ("cb col_scale asym kv_linear [240,1152]x[1152,2304] W4",
             (B * P, 2 * C, False, ics)),
            ("cb_sym col_scale sym kv_linear [240,1152]x[1152,2304] W4",
             (B * P, 2 * C, True, ics)),
            ("cb col_scale asym kv_linear W4 edge scales",
             (B * P, 2 * C, False, edge))):
        xa = randn(m_rows, C)
        wa, wza, wca = randw4(C, n, sym)
        wsa, ba = rands(1, n), randn(n, dtype=torch.float32, scale=0.1)
        kw = dict(sym=sym, sym_w=sym, w_zp=wza, w_colsum=wca)
        check_k5(records, case, xa, wa, wsa, ba, timed=cs is ics,
                 col_scale=cs, **kw)
        if cs is ics:
            with_and_without(
                "fused_dynq_int8_matmul", case,
                lambda: FM.fused_dynq_int8_matmul(xa, wa, wsa, ba,
                                                  col_scale=cs, **kw),
                lambda: FM.fused_dynq_int8_matmul(xa, wa, wsa, ba, **kw))
        del xa

    # K3: the emission with the proj's 1/cs at the three sites, bf16 PV:
    # asym with row sums (cb), sym (cb_sym)
    mask = torch.ones((B, P), dtype=torch.int32, device=dev)
    mask[1, 100:] = 0
    for site, (nb, nq, kv, seg, m) in (
            ("spatial", (B * T, S, S, 0, None)),
            ("temporal", (B, T * S, T * S, T, None)),
            ("cross", (B, T * S, P, 0, mask))):
        q, k, v = randn(nb, nq, H, D), randn(nb, kv, H, D), randn(nb, kv, H, D)
        rows = ([seg] * nb if seg else [kv] * nb if m is None
                else [int(r) for r in (m != 0).sum(dim=1).tolist()])
        for arm, emit_sym in (("cb", False), ("cb_sym", True)):
            kw = dict(seg_len=seg, kv_mask=m, emit=True, emit_sym=emit_sym,
                      need_rowsum=not emit_sym)
            nbytes, ops = attn_bound(nb, nq, H, D, rows, False, True, kv)
            nbytes += (4 if emit_sym else 8) * nb * nq + 4 * C + (
                0 if m is None else 4 * nb * kv)
            case = (f"{site} {arm} col_scale "
                    f"{'sym' if emit_sym else 'asym'} emit")
            check_case("attention_bnhd", case,
                       lambda: A.attention_bnhd(q, k, v, D ** -0.5,
                                                col_scale=ics, **kw),
                       lambda: A.attention_bnhd_plain(q, k, v, D ** -0.5,
                                                      col_scale=ics, **kw),
                       records, cost=(nbytes, ops),
                       asym=None if emit_sym else ASYM_TOL["attn"])
            with_and_without("attention_bnhd", case,
                             lambda: A.attention_bnhd(q, k, v, D ** -0.5,
                                                      col_scale=ics, **kw),
                             lambda: A.attention_bnhd(q, k, v, D ** -0.5,
                                                      **kw))
        del q, k, v

    # K6: Σ-1024's self-attention (blocks 0-13) under the Σ cb plan, its
    # asym emission through K4 with the proj's 1/cs
    Ns = 4096
    bkv = A.stream_kv_block(Ns, Ns, C)
    q, k, v = randn(B, Ns, H, D), randn(B, Ns, H, D), randn(B, Ns, H, D)
    ics_s = cb_col_scales(g, C, alpha=SIGMA_CB_ALPHA)
    kw = dict(emit=True, emit_sym=False, need_rowsum=True)

    def k6_plain():
        o = A.attention_bnhd_stream_plain(q, k, v, D ** -0.5, bkv)
        return A._bn1(B, Ns, *FM.quantize_rows_plain(
            o.reshape(B * Ns, C), sym=False, need_rowsum=True,
            col_scale=ics_s))
    nbytes, ops = attn_bound(B, Ns, H, D, [Ns] * B, False, True, Ns)
    case = "Σ cb [2,4096,16,72] col_scale asym emit (K6->K4)"
    check_case("attention_bnhd_stream", case,
               lambda: A.attention_bnhd_stream(q, k, v, D ** -0.5,
                                               col_scale=ics_s, **kw),
               k6_plain, records, cost=(nbytes + 8 * B * Ns + 4 * C, ops),
               asym=ASYM_TOL["stream"])
    with_and_without("attention_bnhd_stream", case,
                     lambda: A.attention_bnhd_stream(q, k, v, D ** -0.5,
                                                     col_scale=ics_s, **kw),
                     lambda: A.attention_bnhd_stream(q, k, v, D ** -0.5,
                                                     **kw))
    del q, k, v

    # K5 at the Σ cb plan's layers without a producer: the patch embed (K =
    # 16, one short k-tile) and the final linear (N = 32), asym acts x asym
    # W6 codes, the layer's 1/cs folded into the quantize; the K4 -> K2
    # route takes no K % 64 != 0 asym, so K = 16 is held to the plain
    # version alone
    for case, (k, n) in (("Σ cb x_embedder [8192,16]x[16,1152] W6", (16, C)),
                         ("Σ cb final_layer [8192,1152]x[1152,32] W6",
                          (C, 32))):
        xa = randn(B * Ns, k)
        wa = torch.randint(-32, 32, (n, k), generator=g, device=dev,
                           dtype=torch.int8).t()
        kw = dict(sym=False, sym_w=False, w_zp=torch.randint(
            -32, 32, (1, n), generator=g, device=dev).float(),
                  w_colsum=wa.float().sum(dim=0, keepdim=True),
                  col_scale=cb_col_scales(g, k, alpha=SIGMA_CB_ALPHA))
        wsa, ba = rands(1, n), randn(n, dtype=torch.float32, scale=0.1)
        if k % 64 == 0:
            check_k5(records, case, xa, wa, wsa, ba, timed=False, **kw)
        else:
            check_case(
                "fused_dynq_int8_matmul", case,
                lambda: FM.fused_dynq_int8_matmul(xa, wa, wsa, ba, **kw),
                lambda: FM.fused_dynq_int8_matmul_plain(xa, wa, wsa, ba,
                                                        **kw),
                records, cost=(2 * B * Ns * k + k * n + 16 * n + 4 * k
                               + 2 * B * Ns * n,
                               {"int8": 2 * B * Ns * n * k}))
        del xa

    # K2: fc1's GELU emission with fc2's 1/cs (cb_sym), on W4 codes
    xq = torch.randint(-127, 128, (M, C), generator=g, device=dev,
                       dtype=torch.int8)
    xs = rands(M, 1)
    w1 = randw4(C, 4 * C, True)[0]
    ws1 = rands(1, 4 * C, lo=1e-3, hi=1e-2)
    b1 = randn(4 * C, dtype=torch.float32, scale=0.1)
    emit = {"gelu": True, "col_scale": ics4}
    case = "cb_sym col_scale emit [32768,1152]x[1152,4608] W4"
    check_case("int8_consumer_matmul", case,
               lambda: FM.int8_consumer_matmul(xq, xs, w1, ws1, b1,
                                               emit=emit),
               lambda: FM.int8_consumer_matmul_plain(xq, xs, w1, ws1, b1,
                                                     emit=emit),
               records, cost=(M * C + C * 4 * C + 4 * M + 8 * 4 * C
                              + 16 * C + M * 4 * C + 4 * M * 3,
                              {"int8": 2 * M * 4 * C * C}), exact=True)
    with_and_without("int8_consumer_matmul", case,
                     lambda: FM.int8_consumer_matmul(xq, xs, w1, ws1, b1,
                                                     emit=emit),
                     lambda: FM.int8_consumer_matmul(xq, xs, w1, ws1, b1,
                                                     emit={"gelu": True}))


def backbone_cases(records):
    """The kernels of the other backbones at the shapes no earlier path
    gives them, each mode its arm runs: K3 full at Latte-XL/2's temporal
    blocks ([2 x 256 sequences, 16 frames, 16, 72]: one 16-row tile of a
    taller q tile, C19) and spatial blocks ([2 x 16, 256, 16, 72]), bf16 PV
    (the bf16 arm, beside SDPA) and the `cb` arm's asym emission with the
    proj's 1/cs (`compare_asym_rows`); K6 at DiT-XL/2's full attention
    ([2, 4096, 16, 72], kv blocks as Σ's self-attention), bf16 PV and the
    sm8 arm's sym emission through K4; K1 at MMDiT's image stream ([2,
    4096, 1152], sym, no row sums: the W4A8 plan's sym weights)."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    H, D, C, T, S, B = 16, 72, 1152, 16, 256, 2
    sc = D ** -0.5
    ics = cb_col_scales(g, C)
    print("phase kernels: the other backbones' shapes (Latte, DiT, MMDiT)",
          flush=True)
    for site, nb, n in (("Latte temporal", B * S, T),
                        ("Latte spatial", B * T, S)):
        q, k, v = randn(nb, n, H, D), randn(nb, n, H, D), randn(nb, n, H, D)
        shape = f"[{nb},{n},{H},{D}]"
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        check_case("attention_bnhd", f"{site} {shape} bf16",
                   lambda: A.attention_bnhd(q, k, v, sc),
                   lambda: A.attention_bnhd_plain(q, k, v, sc), records,
                   cost=attn_bound(nb, n, H, D, [n] * nb, False, False, n),
                   library_fn=lambda: F.scaled_dot_product_attention(
                       qh, kh, vh, scale=sc),
                   library_note=" (scaled_dot_product_attention)", b2b=True)
        kw = dict(emit=True, emit_sym=False, need_rowsum=True,
                  col_scale=ics)
        nbytes, ops = attn_bound(nb, n, H, D, [n] * nb, False, True, n)
        check_case("attention_bnhd", f"{site} {shape} cb col_scale asym emit",
                   lambda: A.attention_bnhd(q, k, v, sc, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, **kw),
                   records, cost=(nbytes + 8 * nb * n + 4 * C, ops),
                   asym=ASYM_TOL["attn"], b2b=True)
        del q, k, v, qh, kh, vh
    N = T * S
    q, k, v = randn(B, N, H, D), randn(B, N, H, D), randn(B, N, H, D)
    bkv = A.stream_kv_block(N, N, C)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    check_case("attention_bnhd_stream", f"DiT [2,{N},16,72] bkv {bkv} bf16",
               lambda: A.attention_bnhd_stream(q, k, v, sc),
               lambda: A.attention_bnhd_stream_plain(q, k, v, sc, bkv),
               records, cost=attn_bound(B, N, H, D, [N] * B, False, False, N),
               library_fn=lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, scale=sc),
               library_note=" (scaled_dot_product_attention)")

    def k6_emit_plain():
        o = A.attention_bnhd_stream_plain(q, k, v, sc, bkv)
        return A._bn1(B, N, *FM.quantize_rows_plain(o.reshape(B * N, C)))
    check_case("attention_bnhd_stream",
               f"DiT [2,{N},16,72] sm8 emit (K6->K4)",
               lambda: A.attention_bnhd_stream(q, k, v, sc, emit=True),
               k6_emit_plain, records,
               cost=attn_bound(B, N, H, D, [N] * B, False, True, N))
    del q, k, v, qh, kh, vh
    x = randn(B, N, C)
    sh, scl = randn(B, 1, C, scale=0.1), randn(B, 1, C, scale=0.1)
    check_case("ln_modulate_quantize", f"MMDiT img [2,{N},1152] sym",
               lambda: FM.ln_modulate_quantize(x, sh, scl),
               lambda: FM.ln_modulate_quantize_plain(x, sh, scl), records,
               cost=(2 * B * N * C + 2 * 2 * B * C + B * N * C + 4 * B * N,
                     {}), b2b=True)


# head dims K3, K6, K8 and the float32 modes take beside 16 and 72, as
# (D, H) at H * D <= 2048 (JAX's gate): DiT-L/2's 64, 32 and 128 at 16
# heads; the wide instantiations 192 at 6 heads and 256 at 8; 40, 136 and
# 200 padded to 64, 192 and 256 by the wrappers
HEAD_DIM_CASES = ((32, 16), (40, 16), (64, 16), (128, 16), (192, 6),
                  (256, 8), (136, 6), (200, 8))


def head_dim_cases(records):
    """K3 full (bf16 PV beside SDPA, int8 PV, the asym emission with the
    proj's 1/cs and row sums), K3 masked (the cross site: kv 120 with a
    padded prompt, int8 PV and the sym emission), K3 seg 16 on the tiled
    kernel (bf16 and int8 PV, the asym emission, the int8-PV sym emission
    within `int8_pv_slack`) and seg 32 on the row kernel (bf16, the asym
    emission with row sums, the int8-PV sym emission), K6 (bf16 beside
    SDPA, int8 PV, the emission through K4), K8 (identical) and the
    float32 modes (K3 full, masked and seg, K6, to F32_REL_ERR) at each
    (D, H) of HEAD_DIM_CASES, against their plain versions at the true D:
    a D the kernels do not instantiate runs the wrappers' zero-channel
    padding, which every row statistic and row sum must not see."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    g = torch.Generator(device="cuda").manual_seed(23)
    B = 2
    print("phase kernels: head dims "
          f"{', '.join(f'{d} x {h}' for d, h in HEAD_DIM_CASES)} (K3, K6, "
          "K8, float32)", flush=True)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def sdpa(q, k, v, sc, m=None):
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = None if m is None else (m != 0)[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=am, scale=sc)

    for D, H in HEAD_DIM_CASES:
        C, sc = H * D, D ** -0.5
        Dp = next(w for w in A.KERNEL_HEAD_DIMS if w >= D)
        tag = f"D={D}{f' (padded to {Dp})' if Dp != D else ''}"
        ics = cb_col_scales(g, C)
        # K3 full, N = M = 1024
        N = 1024
        q, k, v = randn(B, N, H, D), randn(B, N, H, D), randn(B, N, H, D)
        full = attn_bound(B, N, H, D, [N] * B, False, False, N)
        check_case("attention_bnhd", f"{tag} full [2,{N},{H},{D}] bf16",
                   lambda: A.attention_bnhd(q, k, v, sc),
                   lambda: A.attention_bnhd_plain(q, k, v, sc), records,
                   cost=full, library_fn=sdpa(q, k, v, sc),
                   library_note=" (scaled_dot_product_attention)", b2b=True)
        check_case("attention_bnhd", f"{tag} full int8 PV",
                   lambda: A.attention_bnhd(q, k, v, sc, int8_pv=True),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, int8_pv=True),
                   records,
                   cost=attn_bound(B, N, H, D, [N] * B, True, False, N))
        kw = dict(emit=True, emit_sym=False, need_rowsum=True,
                  col_scale=ics)
        nbytes, ops = attn_bound(B, N, H, D, [N] * B, False, True, N)
        check_case("attention_bnhd", f"{tag} full asym emit +cs rowsum",
                   lambda: A.attention_bnhd(q, k, v, sc, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, **kw),
                   records, cost=(nbytes + 8 * B * N + 4 * C, ops),
                   asym=ASYM_TOL["attn"])
        qd, kd = A.qk_headwise_quant(q, k)
        check_case("qk_headwise_quant", f"{tag} q, k [2,{N},{H},{D}]",
                   lambda: A.qk_headwise_quant(q, k),
                   lambda: A.qk_headwise_quant_plain(q, k), records,
                   cost=(4 * 2 * B * N * C, {}), exact=True)
        del qd, kd
        # K3 masked: the cross site, 1024 queries over a prompt of 120
        # (the second one padded from 100), int8 PV and the sym emission
        P = 120
        kc, vc = randn(B, P, H, D), randn(B, P, H, D)
        pm = torch.ones((B, P), dtype=torch.int32, device="cuda")
        pm[1, 100:] = 0
        kw = dict(kv_mask=pm, int8_pv=True, emit=True)
        nbytes, ops = attn_bound(B, N, H, D, [P, 100], True, True, P)
        check_case("attention_bnhd", f"{tag} masked kv {P} int8 PV emit",
                   lambda: A.attention_bnhd(q, kc, vc, sc, **kw),
                   lambda: A.attention_bnhd_plain(q, kc, vc, sc, **kw),
                   records, cost=(nbytes + 4 * B * P, ops),
                   slack_fn=lambda want: int8_pv_slack(
                       q, kc, vc, sc, 0, pm, None, want[1]))
        check_case("attention_bnhd", f"{tag} masked kv {P} bf16",
                   lambda: A.attention_bnhd(q, kc, vc, sc, kv_mask=pm),
                   lambda: A.attention_bnhd_plain(q, kc, vc, sc,
                                                  kv_mask=pm), records,
                   cost=attn_bound(B, N, H, D, [P, 100], False, False, P),
                   library_fn=sdpa(q, kc, vc, sc, pm),
                   library_note=" (scaled_dot_product_attention)")
        # K3 seg 16 (the temporal site's segments), N = 2048: the tiled
        # kernel where `seg_tiled` takes the shape
        N = 2048
        q, k, v = randn(B, N, H, D), randn(B, N, H, D), randn(B, N, H, D)
        seg = attn_bound(B, N, H, D, [16] * B, False, False, N)
        vb16 = A.seg_v_block(N, 16)
        kern = ("tiled" if A.seg_tiled(H, 16, True, vb16, Dp)
                else "row kernel")
        for label, kw in (("bf16", {}), ("int8 PV", dict(
                int8_pv=True, v_block=vb16))):
            check_case("attention_bnhd", f"{tag} seg 16 [2,{N},{H},{D}] "
                       f"{label} ({kern})",
                       lambda kw=kw: A.attention_bnhd(q, k, v, sc, seg_len=16,
                                                      **kw),
                       lambda kw=kw: A.attention_bnhd_plain(
                           q, k, v, sc, seg_len=16, **kw), records, cost=seg,
                       b2b=not kw)
        kw = dict(emit=True, emit_sym=False, need_rowsum=True)
        check_case("attention_bnhd", f"{tag} seg 16 asym emit rowsum",
                   lambda: A.attention_bnhd(q, k, v, sc, seg_len=16, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, seg_len=16,
                                                  **kw),
                   records, cost=(seg[0] + 8 * B * N, seg[1]),
                   asym=ASYM_TOL["attn"])
        kw = dict(int8_pv=True, v_block=vb16, emit=True)
        check_case("attention_bnhd", f"{tag} seg 16 int8 PV emit",
                   lambda: A.attention_bnhd(q, k, v, sc, seg_len=16, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, seg_len=16,
                                                  **kw),
                   records,
                   cost=attn_bound(B, N, H, D, [16] * B, True, True, N),
                   slack_fn=lambda want: int8_pv_slack(
                       q, k, v, sc, 16, None, vb16, want[1]))
        # seg 32: the row kernel (the tiled one takes segs dividing 16):
        # bf16 PV, its asym emission with row sums (two launches), and the
        # int8 PV's sym emission within `int8_pv_slack` (C12: a softmax code
        # flipped at its rounding tie moves an output, and can move a row's
        # asym scale past ASYM_TOL, which holds the bf16-PV emission)
        seg32 = attn_bound(B, N, H, D, [32] * B, False, False, N)
        vb32 = A.seg_v_block(N, 32)
        check_case("attention_bnhd", f"{tag} seg 32 bf16 (row kernel)",
                   lambda: A.attention_bnhd(q, k, v, sc, seg_len=32),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, seg_len=32),
                   records, cost=seg32)
        kw = dict(emit=True, emit_sym=False, need_rowsum=True)
        check_case("attention_bnhd", f"{tag} seg 32 asym emit rowsum (row "
                   "kernel)",
                   lambda: A.attention_bnhd(q, k, v, sc, seg_len=32, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, seg_len=32,
                                                  **kw),
                   records, cost=(seg32[0] + 8 * B * N, seg32[1]),
                   asym=ASYM_TOL["attn"])
        kw = dict(int8_pv=True, v_block=vb32, emit=True)
        check_case("attention_bnhd", f"{tag} seg 32 int8 PV emit (row "
                   "kernel)",
                   lambda: A.attention_bnhd(q, k, v, sc, seg_len=32, **kw),
                   lambda: A.attention_bnhd_plain(q, k, v, sc, seg_len=32,
                                                  **kw), records,
                   cost=attn_bound(B, N, H, D, [32] * B, True, True, N),
                   slack_fn=lambda want: int8_pv_slack(
                       q, k, v, sc, 32, None, vb32, want[1]))
        # K6, N = M = 2304 (kv blocks of 256)
        N = 2304
        q, k, v = randn(B, N, H, D), randn(B, N, H, D), randn(B, N, H, D)
        bkv = A.stream_kv_block(N, N, C)
        check_case("attention_bnhd_stream",
                   f"{tag} [2,{N},{H},{D}] bkv {bkv} bf16",
                   lambda: A.attention_bnhd_stream(q, k, v, sc),
                   lambda: A.attention_bnhd_stream_plain(q, k, v, sc, bkv),
                   records,
                   cost=attn_bound(B, N, H, D, [N] * B, False, False, N),
                   library_fn=sdpa(q, k, v, sc),
                   library_note=" (scaled_dot_product_attention)", b2b=True)
        bkv8 = A.stream_kv_block(N, N, C, v_int8_in=True)
        check_case("attention_bnhd_stream",
                   f"{tag} [2,{N},{H},{D}] int8 PV",
                   lambda: A.attention_bnhd_stream(q, k, v, sc,
                                                   int8_pv=True),
                   lambda: A.attention_bnhd_stream_plain(q, k, v, sc, bkv8,
                                                         None, True),
                   records,
                   cost=attn_bound(B, N, H, D, [N] * B, True, False, N))

        def k6_emit_plain(q=q, k=k, v=v, bkv=bkv, C=C):
            o = A.attention_bnhd_stream_plain(q, k, v, sc, bkv)
            return A._bn1(B, N, *FM.quantize_rows_plain(o.reshape(B * N, C)))
        check_case("attention_bnhd_stream",
                   f"{tag} [2,{N},{H},{D}] sym emit (K6->K4)",
                   lambda: A.attention_bnhd_stream(q, k, v, sc, emit=True),
                   k6_emit_plain, records,
                   cost=attn_bound(B, N, H, D, [N] * B, False, True, N))
        del q, k, v
        # the float32 modes: K3 full N = M = 1024, masked over kv 120 and
        # seg 16 at 2048, K6 at N = M = 2304
        for name, (N, segl, kvl) in (("attention_bnhd_f32", (1024, 0, 1024)),
                                     ("attention_bnhd_f32", (1024, 0, P)),
                                     ("attention_bnhd_f32", (2048, 16, 2048)),
                                     ("attention_bnhd_stream_f32",
                                      (2304, 0, 2304))):
            q = randn(B, N, H, D, dtype=torch.float32)
            k, v = (randn(B, kvl, H, D, dtype=torch.float32)
                    for _ in range(2))
            m = pm if kvl == P else None
            prods = 2 * H * N * D * (segl or kvl) * B
            check_case(name, f"{tag} f32 {'seg 16 ' if segl else ''}"
                       f"{f'masked kv {P} ' if m is not None else ''}"
                       f"[2,{N},{H},{D}]",
                       lambda: A.attention_bnhd(q, k, v, sc, seg_len=segl,
                                                kv_mask=m),
                       lambda: (A.attention_bnhd_plain(q, k, v, sc,
                                                       seg_len=segl,
                                                       kv_mask=m)
                                if name == "attention_bnhd_f32" else
                                A.attention_bnhd_stream_plain(
                                    q, k, v, sc, A.stream_kv_block(N, N, C))),
                       records, cost=(4 * B * (2 * N + 2 * kvl) * C,
                                      {"bf16": prods, "tf32": 3 * prods}),
                       rel_err=F32_REL_ERR)
            del q, k, v


def dit_l_cases(records):
    """The DiT-L/2 path's attention at its own shape (16 heads of 64 over
    T*S = 4096 tokens: K6), bf16 beside SDPA and sm8's sym emission through
    K4, each back to back."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    g = torch.Generator(device="cuda").manual_seed(24)
    B, N, H, D = 2, 4096, 16, 64
    C, sc = H * D, D ** -0.5
    q, k, v = (torch.randn((B, N, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    bkv = A.stream_kv_block(N, N, C)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    check_case("attention_bnhd_stream", f"DiT-L/2 [2,{N},16,64] bkv {bkv} "
               "bf16", lambda: A.attention_bnhd_stream(q, k, v, sc),
               lambda: A.attention_bnhd_stream_plain(q, k, v, sc, bkv),
               records, cost=attn_bound(B, N, H, D, [N] * B, False, False, N),
               library_fn=lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, scale=sc),
               library_note=" (scaled_dot_product_attention)", b2b=True)

    def k6_emit_plain():
        o = A.attention_bnhd_stream_plain(q, k, v, sc, bkv)
        return A._bn1(B, N, *FM.quantize_rows_plain(o.reshape(B * N, C)))
    check_case("attention_bnhd_stream",
               f"DiT-L/2 [2,{N},16,64] sm8 emit (K6->K4)",
               lambda: A.attention_bnhd_stream(q, k, v, sc, emit=True),
               k6_emit_plain, records,
               cost=attn_bound(B, N, H, D, [N] * B, False, True, N),
               b2b=True)


def wide_path_cases(records):
    """The wide-head slices' attention at their own shapes, each back to
    back: `stdit_h6` (STDiT-XL/2 in 6 heads of 192): spatial [32, 1024]
    full in bf16 (beside SDPA) and sm8's sym emission, temporal [2, 16384]
    seg 16 in bf16 (beside SDPA) and sm8's int8 PV with the emission, cross
    [2, 16384] over the 120-token prompt (the second padded from 100) in
    bf16 and sm8's int8 PV with the emission; `dit_l_h4` (DiT-L/2 in 4
    heads of 256): K6 over [2, 4096] in bf16 (beside SDPA) and sm8's
    emission through K4."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    g = torch.Generator(device="cuda").manual_seed(25)

    def randn(*shape):
        return torch.randn(shape, generator=g,
                           device="cuda").to(torch.bfloat16)

    def sdpa(q, k, v, sc, seg=0, m=None):
        if seg:
            n_b = q.shape[0] * q.shape[1] // seg
            q, k, v = (t.reshape(n_b, seg, *t.shape[2:]) for t in (q, k, v))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = None if m is None else (m != 0)[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=am, scale=sc)

    B, T, S, H, D, P = 2, 16, 1024, 6, 192, 120
    C, sc = H * D, D ** -0.5
    print(f"phase kernels: stdit_h6 and dit_l_h4 attention shapes "
          f"(D = {D}, 256)", flush=True)
    mask = torch.ones((B, P), dtype=torch.int32, device="cuda")
    mask[1, 100:] = 0
    sites = {
        "spatial": (randn(B * T, S, H, D), randn(B * T, S, H, D),
                    randn(B * T, S, H, D), 0, None, False),
        "temporal": (randn(B, T * S, H, D), randn(B, T * S, H, D),
                     randn(B, T * S, H, D), T, None, True),
        "cross": (randn(B, T * S, H, D), randn(B, P, H, D),
                  randn(B, P, H, D), 0, mask, True)}
    for site, (q, k, v, seg, m, sm8_int8) in sites.items():
        nb, nq, kv = q.shape[0], q.shape[1], k.shape[1]
        kv_rows = ([seg] * nb if seg else [kv] * nb if m is None
                   else [int(r) for r in (m != 0).sum(dim=1).tolist()])
        for arm, int8_pv, emit in (("bf16", False, False),
                                   ("sm8", sm8_int8, True)):
            vb = A.seg_v_block(nq, seg) if (seg and int8_pv) else None
            kw = dict(seg_len=seg, kv_mask=m, int8_pv=int8_pv, emit=emit,
                      v_block=vb)
            nbytes, ops = attn_bound(nb, nq, H, D, kv_rows, int8_pv, emit, kv)
            if m is not None:
                nbytes += 4 * nb * kv
            check_case(
                "attention_bnhd",
                f"stdit_h6 {site} [{nb},{nq},{H},{D}] {arm}"
                f"{' int8_pv' if int8_pv else ''}{' emit' if emit else ''}",
                lambda kw=kw, q=q, k=k, v=v: A.attention_bnhd(q, k, v, sc,
                                                              **kw),
                lambda kw=kw, q=q, k=k, v=v: A.attention_bnhd_plain(
                    q, k, v, sc, **kw), records, cost=(nbytes, ops),
                library_fn=None if int8_pv or emit else sdpa(q, k, v, sc,
                                                             seg, m),
                library_note=" (scaled_dot_product_attention)",
                slack_fn=(lambda want, q=q, k=k, v=v, seg=seg, m=m, vb=vb:
                          int8_pv_slack(q, k, v, sc, seg, m, vb, want[1]))
                if int8_pv and emit else None, b2b=True)
    del sites
    B, N, H, D = 2, 4096, 4, 256
    C, sc = H * D, D ** -0.5
    q, k, v = randn(B, N, H, D), randn(B, N, H, D), randn(B, N, H, D)
    bkv = A.stream_kv_block(N, N, C)
    check_case("attention_bnhd_stream", f"dit_l_h4 [2,{N},{H},{D}] bkv "
               f"{bkv} bf16", lambda: A.attention_bnhd_stream(q, k, v, sc),
               lambda: A.attention_bnhd_stream_plain(q, k, v, sc, bkv),
               records, cost=attn_bound(B, N, H, D, [N] * B, False, False, N),
               library_fn=sdpa(q, k, v, sc),
               library_note=" (scaled_dot_product_attention)", b2b=True)

    def k6_emit_plain():
        o = A.attention_bnhd_stream_plain(q, k, v, sc, bkv)
        return A._bn1(B, N, *FM.quantize_rows_plain(o.reshape(B * N, C)))
    check_case("attention_bnhd_stream",
               f"dit_l_h4 [2,{N},{H},{D}] sm8 emit (K6->K4)",
               lambda: A.attention_bnhd_stream(q, k, v, sc, emit=True),
               k6_emit_plain, records,
               cost=attn_bound(B, N, H, D, [N] * B, False, True, N),
               b2b=True)


def int8_pv_draws():
    """C12: K3's seg-mode int8-PV emission at the temporal sm8 site on
    C12_DRAWS draws of its own generator, each held to the per-entry
    tolerance of `int8_pv_slack` (and the mismatch fraction). For the first
    entry more than one code off, `flip_witness` shows its cause."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    g = torch.Generator(device="cuda").manual_seed(2)
    B, N, H, D, seg = 2, 16 * 1024, 16, 72, 16
    C, vb, sc = H * D, A.seg_v_block(16 * 1024, 16), 72 ** -0.5
    kw = dict(seg_len=seg, int8_pv=True, v_block=vb, emit=True)
    n_over, worst_frac, ratio, witness = 0, 0.0, 0.0, None
    for draw in range(C12_DRAWS):
        q, k, v = (torch.randn((B, N, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        got = A.attention_bnhd(q, k, v, sc, **kw)
        want = A.attention_bnhd_plain(q, k, v, sc, **kw)
        d = (got[0].float() - want[0].float()).abs().reshape(B * N, C)
        slack = int8_pv_slack(q, k, v, sc, seg, None, vb, want[1])
        over = d > CODE_MAX_DIFF
        frac = float((d > 0).float().mean())
        worst_frac = max(worst_frac, frac)
        if over.any():
            n_over += int(over.sum())
            ratio = max(ratio, float(((d - CODE_MAX_DIFF) / slack)[over]
                                     .max()))
            if witness is None:
                row, c = divmod(int(torch.nonzero(over.reshape(-1))[0]), C)
                witness = f"draw {draw}: " + flip_witness(
                    q, k, v, sc, seg, vb, row, c, got[0], want[0])
        if ratio > 1 or frac > CODE_MISMATCH_FRAC:
            fail(f"C12 draw {draw}: codes beyond one softmax flip (excess "
                 f"over slack x{ratio:.3g}) or mismatch {frac}")
    print(f"phase kernels: C12, temporal int8_pv emit over {C12_DRAWS} "
          f"draws: {n_over} entries beyond {CODE_MAX_DIFF} code, the largest "
          f"at {ratio:.3g} of its slack; mismatch at most {worst_frac:.3g}",
          flush=True)
    print(f"  C12 witness: {witness or 'no entry beyond one code'}",
          flush=True)


def flip_row(q, k, v, sc, seg, vb, row, h):
    """The plain version's emitted sym int8-PV row (seg mode) recomputed by
    its formulas for one query `row`, then again with the one softmax code
    of head h nearest its rounding tie moved to its other rounding.
    Returns (codes, codes with the flip [1, C], the flipped kv index,
    its e * 127, the head's softmax denominator r)."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels._common import rdiv
    B, N, H, D = q.shape
    C, b, n = H * D, row // N, row % N
    g0, v0 = n - n % seg, n - n % vb
    qf = (q[b:b + 1, n:n + 1].float() * (sc * A.LOG2E)).to(
        torch.bfloat16).float()
    kf = k[b:b + 1, g0:g0 + seg].float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf)[0, :, 0]      # [H, seg]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    r = e.sum(dim=-1, keepdim=True)
    vq, vs = A._v_quant(v[b:b + 1, v0:v0 + vb].reshape(1, vb, C), vb)
    vq = vq[0, g0 - v0:g0 - v0 + seg].reshape(seg, H, D).double()
    t = rdiv(1.0 / (127.0 * 127.0), r)

    def row_codes(pq):
        acc = torch.einsum("hm,mhd->hd", pq, vq).float()
        o = ((acc * t) * vs.reshape(H, D)).reshape(1, C)
        smax = torch.clamp(o.abs().amax(dim=-1, keepdim=True), min=1e-6)
        return torch.clamp(torch.round(o * rdiv(127.0, smax)), -128, 127)
    e127 = e[h] * 127.0
    j = int((e127 - torch.floor(e127) - 0.5).abs().argmin())
    pq = torch.round(e * 127.0).double()
    base = row_codes(pq)
    lo = float(torch.floor(e127[j]))
    pq[h, j] = lo + 1.0 if float(pq[h, j]) == lo else lo
    return base, row_codes(pq), j, float(e127[j]), float(r[h])


def flip_witness(q, k, v, sc, seg, vb, row, c, codes, plain_codes) -> str:
    """`flip_row` at entry (row, c): the recomputed row against the plain
    version's codes, the flipped one against the kernel's."""
    C = codes.shape[-1]
    h = c // (C // q.shape[2])
    base, flipped, j, e127, r = flip_row(q, k, v, sc, seg, vb, row, h)
    kern = codes.reshape(-1, C)[row].float()
    plain = plain_codes.reshape(-1, C)[row].float()

    def agree(a, x):
        return (f"{int((a[0] == x).sum())}/{C} equal, max diff "
                f"{float((a[0] - x).abs().max()):.0f}")
    return (f"row {row} channel {c} (head {h}): kernel {kern[c]:.0f}, plain "
            f"{plain[c]:.0f}; the softmax code nearest its tie is kv {j}, "
            f"e*127 = {e127:.7f} ({abs(e127 % 1.0 - 0.5):.2e} from it, "
            f"r = {r:.4g}); recomputed row vs plain: {agree(base, plain)}; "
            f"with that code on its other rounding, vs kernel: "
            f"{agree(flipped, kern)}")


def k7b_cost(m, k, n, out_bytes):
    return (m * k + k * n + 12 * m + 16 * n + out_bytes * m * n,
            {"int8": 2 * m * n * k})


def yardsticks(name, xq, w, kernel_fn):
    """The kernel's time per call back to back (its device time: the host's
    time per call is smaller at these shapes), and the PyTorch calls that
    compute this GEMM's product: torch._int_mm on the K-major weight (the
    port's layout) and on a row-major copy (int32 product only, no
    epilogue), and cuBLAS bf16 torch.matmul at the same shape. Printed only;
    none of them is used by the port."""
    import torch
    w_rm = w.contiguous()
    xb, wb = xq.to(torch.bfloat16), w.to(torch.bfloat16)
    parts = [f"kernel back to back {cuda_ms_back_to_back(kernel_fn):.3f} ms"]
    for label, fn in (("_int_mm K-major", lambda: torch._int_mm(xq, w)),
                      ("_int_mm row-major", lambda: torch._int_mm(xq, w_rm)),
                      ("bf16 matmul", lambda: torch.matmul(xb, wb))):
        try:
            parts.append(f"{label} {cuda_ms(fn):.3f} ms (back to back "
                         f"{cuda_ms_back_to_back(fn):.3f})")
        except RuntimeError as e:  # a layout cuBLASLt refuses
            parts.append(f"{label} refused ({str(e).splitlines()[0][:80]})")
    print(f"  yardsticks {name} {list(xq.shape)}x{list(w.shape)}: "
          f"{'; '.join(parts)}", flush=True)


def gemm_edge_cases(records, randn, randi8, rands):
    """K2 and K7b at the shapes GEMM_EDGE_CASES lists, each identical to its
    plain version: ragged M, the byte-wise kernel, N past the last whole
    N-tile, a K tail inside a 128-byte k-tile, gw_x with a group boundary
    inside a k-tile, an unaligned base."""
    import torch
    from viditq_tpu_torch.kernels import fused_matmul as FM
    from viditq_tpu_torch.kernels import int_matmul as IM
    dev = "cuda"
    for name, case, p in GEMM_EDGE_CASES:
        m, k, n = p["M"], p["K"], p["N"]
        w = randi8(n, k).t()
        out_dtype = torch.float32 if p.get("out") == "f32" else torch.bfloat16
        if name == "int8_consumer_matmul":
            G = p.get("G", 1)
            xq, xs = randi8(m, k), rands(m, G)
            ws = rands(1, n, lo=1e-4, hi=1e-3)
            b = randn(n, dtype=torch.float32, scale=0.1)
            kw = dict(group_scales=G > 1, out_dtype=out_dtype)
            kernel = (lambda xq=xq, xs=xs, w=w, ws=ws, b=b, kw=kw:
                      FM.int8_consumer_matmul(xq, xs, w, ws, b, **kw))
            plain = (lambda xq=xq, xs=xs, w=w, ws=ws, b=b, kw=kw:
                     FM.int8_consumer_matmul_plain(xq, xs, w, ws, b, **kw))
            out_bytes = torch.empty((), dtype=out_dtype).element_size()
            cost = (m * k + k * n + 4 * m * G + 8 * n + out_bytes * m * n,
                    {"int8": 2 * m * n * k})
        else:
            x = randn(m, k)
            if p.get("offset"):
                # codes at an odd address: the byte-wise kernel
                buf = torch.empty(m * k + p["offset"], dtype=torch.int8,
                                  device=dev)
                xq = buf[p["offset"]:].view(m, k)
                q, xs, xz, xr = IM.dynamic_quant_rows(x)
                xq.copy_(q)
            else:
                xq, xs, xz, xr = IM.dynamic_quant_rows(x)
            tabs = (xq, w, xs, xz, xr, rands(1, n, lo=1e-4, hi=1e-3),
                    torch.randint(-20, 20, (1, n), device=dev).float(),
                    w.float().sum(dim=0, keepdim=True))
            b = randn(n, dtype=torch.float32, scale=0.1)
            kernel = (lambda tabs=tabs, b=b, o=out_dtype:
                      IM.int8_matmul(*tabs, out_dtype=o, bias=b))
            plain = (lambda tabs=tabs, b=b, o=out_dtype:
                     IM.int8_matmul_plain(*tabs, out_dtype=o, bias=b))
            cost = k7b_cost(m, k, n,
                            torch.empty((), dtype=out_dtype).element_size())
        check_case(name, f"edge {case}", kernel, plain, records, cost=cost,
                   exact=True)


def row_edge_cases(records):
    """K1 and K4 at the shapes ROW_EDGE_CASES lists, on draws of their own
    generator, with the main cases' tolerances (K4 asym identical to its
    plain version, sym codes by the code tolerance, K1 asym rows by
    ASYM_TOL["ln"]), each timed one call and back to back."""
    import torch
    from viditq_tpu_torch.kernels import fused_matmul as FM
    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    for name, case, p in ROW_EDGE_CASES:
        dt = torch.float32 if p.get("f32") else torch.bfloat16
        esize = torch.empty((), dtype=dt).element_size()
        sym, need_rowsum = p["sym"], p.get("rowsum", False)
        # scale, zero point (asym) and row sum (asym or asked for) a row
        row_floats = 4 * (1 + (not sym) + (not sym or need_rowsum))
        if name == "quantize_rows":
            M, K = p["M"], p["K"]
            x = randn(M, K, dtype=dt, scale=2.0) + 0.2
            for r in p.get("zero_rows", ()):
                x[r] = 0
            kw = dict(sym=sym, gelu=p.get("gelu", False),
                      need_rowsum=need_rowsum)
            check_case(name, f"edge {case}",
                       lambda x=x, kw=kw: FM.quantize_rows(x, **kw),
                       lambda x=x, kw=kw: FM.quantize_rows_plain(x, **kw),
                       records, cost=((esize + 1) * M * K + row_floats * M,
                                      {}), exact=not sym, b2b=True)
        else:
            B, N, C = p["B"], p["N"], p["C"]
            x = randn(B, N, C, dtype=dt) + 0.2
            sh, sc = (randn(B, 1, C, dtype=dt, scale=0.1) for _ in range(2))
            kw = dict(sym=sym, need_rowsum=need_rowsum)
            check_case(name, f"edge {case}",
                       lambda x=x, sh=sh, sc=sc, kw=kw:
                       FM.ln_modulate_quantize(x, sh, sc, **kw),
                       lambda x=x, sh=sh, sc=sc, kw=kw:
                       FM.ln_modulate_quantize_plain(x, sh, sc, **kw),
                       records, cost=((esize + 1) * B * N * C
                                      + 2 * esize * B * C
                                      + row_floats * B * N, {}),
                       asym=None if sym else ASYM_TOL["ln"], b2b=True)


def attention_edge_cases(records, randn):
    """K3 and K6 at shapes the main path does not reach (EDGE_CASES), with
    the main cases' tolerances: ragged q and kv tiles of the attention core,
    a kv block masked whole, the tiny models' head dim; K3's seg mode in
    both its kernels (the tiled one at seg 2, 4, 8 and 16 with ragged last
    tiles and asym emission, the row kernel at seg 48 and 1088)."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.kernels import fused_matmul as FM
    for name, case, p in EDGE_CASES:
        B, N, M, H, D = p["B"], p["N"], p["M"], p["H"], p["D"]
        q, k, v = randn(B, N, H, D), randn(B, M, H, D), randn(B, M, H, D)
        m = None
        if "masked" in p:
            lo, hi = p["masked"]
            m = torch.ones((B, M), dtype=torch.int32, device=q.device)
            m[B - 1, lo:hi] = 0
        int8_pv, emit, sc = p["int8_pv"], p["emit"], D ** -0.5
        emit_sym = p.get("emit_sym", True)
        seg = p.get("seg", 0)
        vb = p.get("v_block", A.seg_v_block(N, seg)) if (
            seg and int8_pv) else None
        rows = ([seg] * B if seg else [M] * B if m is None
                else [int(r) for r in (m != 0).sum(1)])
        cost = attn_bound(B, N, H, D, rows, int8_pv, emit, M)
        if m is not None:
            cost = (cost[0] + 4 * B * M, cost[1])
        if not emit_sym:  # zero points and row sums
            cost = (cost[0] + 8 * B * N, cost[1])
        slack_fn = None
        if name == "attention_bnhd":
            kw = dict(kv_mask=m, int8_pv=int8_pv, emit=emit, seg_len=seg,
                      v_block=vb, emit_sym=emit_sym,
                      need_rowsum=not emit_sym)
            kernel = (lambda q=q, k=k, v=v, kw=kw:
                      A.attention_bnhd(q, k, v, sc, **kw))
            plain = (lambda q=q, k=k, v=v, kw=kw:
                     A.attention_bnhd_plain(q, k, v, sc, **kw))
            if int8_pv and emit:
                slack_fn = (lambda want, q=q, k=k, v=v, m=m, sc=sc, seg=seg,
                            vb=vb: int8_pv_slack(q, k, v, sc, seg, m, vb,
                                                 want[1]))
        else:
            bkv = p["bkv"]

            def kernel(q=q, k=k, v=v, m=m, int8_pv=int8_pv, emit=emit,
                       bkv=bkv, emit_sym=emit_sym):
                return A.attention_bnhd_stream(
                    q, k, v, sc, m, int8_pv, emit, bkv=bkv,
                    emit_sym=emit_sym, need_rowsum=not emit_sym)

            def plain(q=q, k=k, v=v, m=m, int8_pv=int8_pv, emit=emit,
                      bkv=bkv, B=B, N=N, C=H * D, emit_sym=emit_sym):
                o = A.attention_bnhd_stream_plain(q, k, v, sc, bkv, m,
                                                  int8_pv)
                if not emit:
                    return o
                return A._bn1(B, N, *FM.quantize_rows_plain(
                    o.reshape(B * N, C), sym=emit_sym,
                    need_rowsum=not emit_sym))
        check_case(name, f"edge {case}", kernel, plain, records, cost=cost,
                   asym=None if emit_sym else ASYM_TOL[
                       "attn" if name == "attention_bnhd" else "stream"],
                   slack_fn=slack_fn)


def f32_attention_cases(records):
    """K3's float32 mode (csrc/attention_f32.cu), the forward of
    reconstruction's float32 block, at its three STDiT sites with the CFG
    pair of one minibatch (2 rows): spatial full attention [32, 1024, 16,
    72], temporal seg 16 [2, 16384, 16, 72] and cross attention to 120
    prompt tokens, the last 20 of one row padded; at PixArt-Σ 1024's cross
    attention (4096 queries, 300 prompt tokens, the last 100 of one row
    padded: phase recon_sigma's float32 blocks); then its edge cases (head
    dim 16 with ragged q and kv tiles, kv tiles 4-7 of one row masked whole
    at N = M = 1000, a ragged last kv tile unmasked, seg 5 with a ragged
    last tile, seg 48 over several tiles). Each against its plain version
    to F32_REL_ERR, timed one call and back to back, beside SDPA in float32
    (TF32 off). Its bound: q/k/v read and the output written in f32 (the
    mask as int32), q.k as bf16 operations (its operands are rounded to
    bf16) and the PV as three TF32 products (the float32 core's split,
    csrc/attn_f32_core.cuh). Then K6's float32 mode
    (csrc/attention_stream_f32.cu, the same core) the same way at
    PixArt-Σ's self-attention (full, kv-masked) and at M = 2304 (ragged q
    tiles and a kv block masked whole; head dim 16), and its refusal of the
    int8 PV and of emission. Each main-path case prints its share of the
    bound, its time in an earlier run (F32_EARLIER_MS) and whether it is
    no slower than SDPA. Then the autograd cases, K3's four sites and K6's
    two: the wrapped kernel's gradient against the plain f32 attention's,
    both backwards the same plain code, the kernel forward and the plain
    recompute backward timed apart."""
    import torch
    import torch.nn.functional as F
    from viditq_tpu_torch.kernels import attention as A
    g = torch.Generator(device="cuda").manual_seed(15)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def run(name, cases, plain_of):
        for case, (B, N, M, h, d), seg, m in cases:
            q, k, v = randn(B, N, h, d), randn(B, M, h, d), randn(B, M, h, d)
            sc = d ** -0.5
            rows = ([seg] * B if seg else [M] * B if m is None
                    else [int(r) for r in (m != 0).sum(1)])
            prods = 2 * h * N * d * sum(rows)
            nbytes = 4 * (2 * B * N * h * d + 2 * B * M * h * d)
            if m is not None:
                nbytes += 4 * B * M
            edge = case.startswith("edge")
            lib = None
            if not edge:
                if seg:
                    qh, kh, vh = (x.reshape(B * N // seg, seg, h, d)
                                  .transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    am = None
                else:
                    qh, kh, vh = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    am = None if m is None else (m != 0)[:, None, None, :]
                lib = (lambda qh=qh, kh=kh, vh=vh, am=am, sc=sc:
                       F.scaled_dot_product_attention(
                           qh, kh, vh, attn_mask=am, scale=sc))
            check_case(
                name, case,
                lambda q=q, k=k, v=v, seg=seg, m=m, sc=sc:
                    A.attention_bnhd(q, k, v, sc, seg_len=seg, kv_mask=m),
                lambda q=q, k=k, v=v, seg=seg, m=m, sc=sc:
                    plain_of(q, k, v, sc, seg, m),
                records, cost=(nbytes, {"bf16": prods, "tf32": 3 * prods}),
                library_fn=lib, library_note=" (SDPA float32)",
                rel_err=F32_REL_ERR, b2b=not edge)
            if not edge:
                rec = records[name][-1]
                share = rec["bound_ms"] / rec["ms"]
                faster = rec["ms"] <= rec["library_ms"]
                print(f"  {name:24s} {case:34s} {share:.3f} of the bound "
                      f"{rec['bound_ms']:.4f} ms; earlier "
                      f"{F32_EARLIER_MS[case]:.3f} ms, now {rec['ms']:.3f}; "
                      "no slower than SDPA float32: "
                      f"{'yes' if faster else 'NO'}", flush=True)
            del q, k, v, lib

    H, D = 16, 72
    mask = torch.ones((2, 120), dtype=torch.int32, device="cuda")
    mask[1, 100:] = 0
    mask300 = torch.ones((2, 300), dtype=torch.int32, device="cuda")
    mask300[1, 200:] = 0
    mask16 = torch.ones((3, 50), dtype=torch.int32, device="cuda")
    mask16[2, 43:] = 0
    mask1000 = torch.ones((2, 1000), dtype=torch.int32, device="cuda")
    mask1000[1, 256:512] = 0
    run("attention_bnhd_f32", (
        ("spatial [32,1024,16,72]", (32, 1024, 1024, H, D), 0, None),
        ("temporal seg 16 [2,16384,16,72]", (2, 16384, 16384, H, D), 16,
         None),
        ("cross [2,16384,16,72] kv 120 masked", (2, 16384, 120, H, D), 0,
         mask),
        ("Σ cross [2,4096,16,72] kv 300 masked", (2, 4096, 300, H, D), 0,
         mask300),
        ("edge D=16 [3,77,4,16] kv 50 masked", (3, 77, 50, 4, 16), 0,
         mask16),
        ("edge N=M=1000, kv tiles 4-7 of one row masked whole",
         (2, 1000, 1000, H, D), 0, mask1000),
        ("edge N=200 M=1000, a ragged last kv tile", (2, 200, 1000, H, D),
         0, None),
        ("edge seg 5 [2,80,4,16]", (2, 80, 80, 4, 16), 5, None),
        ("edge seg 48 [1,192,2,72]", (1, 192, 192, 2, 72), 48, None)),
        lambda q, k, v, sc, seg, m: A.attention_bnhd_plain(
            q, k, v, sc, seg_len=seg, kv_mask=m))
    # K6's float32 mode (csrc/attention_stream_f32.cu): PixArt-Σ 1024's
    # self-attention in the float32 block, full and kv-masked (the later kv
    # rows of one batch row), then at M = 2304 with ragged q tiles and a kv
    # block masked whole, head dim 16, and a ragged last kv tile (M = 2100:
    # 52 rows, partly masked); the plain version's kv block is the numerics
    # rule's where one divides the lengths, else the one given
    smask = torch.ones((2, 4096), dtype=torch.int32, device="cuda")
    smask[1, 1500:] = 0
    emask = torch.ones((2, 2304), dtype=torch.int32, device="cuda")
    emask[1, 256:512] = 0
    emask16 = torch.ones((3, 2304), dtype=torch.int32, device="cuda")
    emask16[2, 43:] = 0
    rmask = torch.ones((2, 2100), dtype=torch.int32, device="cuda")
    rmask[1, 2070:] = 0
    stream_bkv = {2304: 256, 2100: 300}

    def stream_plain(q, k, v, sc, seg, m):
        N, M = q.shape[1], k.shape[1]
        bkv = stream_bkv.get(M) or A.stream_kv_block(
            N, M, q.shape[2] * q.shape[3])
        return A.attention_bnhd_stream_plain(q, k, v, sc, bkv, m)
    run("attention_bnhd_stream_f32", (
        ("Σ self [2,4096,16,72]", (2, 4096, 4096, H, D), 0, None),
        ("Σ self [2,4096,16,72] kv masked", (2, 4096, 4096, H, D), 0,
         smask),
        ("edge N=1000 M=2304, kv block 1 masked whole",
         (2, 1000, 2304, H, D), 0, emask),
        ("edge D=16 [3,77,4,16] M=2304 masked", (3, 77, 2304, 4, 16), 0,
         emask16),
        ("edge N=200 M=2100, a ragged last kv tile, masked",
         (2, 200, 2100, H, D), 0, rmask)), stream_plain)
    # the float32 modes take the float PV and no emission, as K3's
    q, k, v = randn(1, 128, H, D), randn(1, 2304, H, D), randn(1, 2304, H, D)
    for kw in (dict(int8_pv=True), dict(emit=True)):
        try:
            A.attention_bnhd_stream(q, k, v, D ** -0.5, **kw)
        except ValueError:
            continue
        fail(f"attention_bnhd_stream_f32 took {kw}")
    print("  attention_bnhd_stream_f32 refuses int8_pv and emit", flush=True)
    # autograd: the same backward (JAX's custom_vjp: a recompute through
    # the plain f32 attention) on the same inputs gives the same gradient;
    # after one untimed pass, the kernel forward and the plain backward
    # timed apart (CUDA events)
    for case, (B, N, M), seg, m in (
            ("spatial", (32, 1024, 1024), 0, None),
            ("temporal seg 16", (2, 16384, 16384), 16, None),
            ("cross masked", (2, 16384, 120), 0, mask),
            ("Σ cross masked", (2, 4096, 300), 0, mask300),
            ("Σ self (K6)", (2, 4096, 4096), 0, None),
            ("Σ self kv masked (K6)", (2, 4096, 4096), 0, smask)):
        q, k, v = (randn(B, n, H, D).requires_grad_() for n in (N, M, M))
        gout = randn(B, N, H, D)
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = A.attention_bnhd(q, k, v, D ** -0.5, seg_len=seg, kv_mask=m)
            ev[1].record()
            got = torch.autograd.grad(out, (q, k, v), gout)
            ev[2].record()
            ev[2].synchronize()
        fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(A.attention_bnhd_xla(
            *qkv, D ** -0.5, seg, m), qkv, gout)
        diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
        name = ("attention_bnhd_stream_f32"
                if seg == 0 and M > A.ONESHOT_MAX_M else "attention_bnhd_f32")
        print(f"  {name} grad {case:18s} forward (kernel) {fwd_ms:.3f} ms, "
              f"backward (plain f32 recompute) {bwd_ms:.3f} ms; max |d grad| "
              f"vs the plain attention's autograd {diff:.3g} (limit 0)",
              flush=True)
        if diff != 0 or not all(torch.isfinite(a).all() for a in got):
            fail(f"{name} {case}: the wrapped kernel's gradient "
                 f"differs from the plain attention's by {diff}")
        del q, k, v, out, got, want, qkv


def bf16_grad_cases():
    """K3's bf16 modes under autograd at the train path's three sites
    (phase train: STDiT-XL/2 16x512x512 at batch 2): spatial [32, 1024,
    16, 72], temporal seg 16 [2, 16384, 16, 72] and cross to 120 prompt
    tokens, the last 20 of one row padded. The forward (the kernel) against
    its plain version within REL_ERR; dq, dk and dv (JAX's custom_vjp: a
    recompute through the plain f32-softmax attention) equal to the plain
    attention's autograd gradients on the same inputs; after one untimed
    pass the kernel forward and the plain backward timed apart."""
    import torch
    from viditq_tpu_torch.kernels import attention as A
    g = torch.Generator(device="cuda").manual_seed(20)
    H, D = 16, 72
    mask = torch.ones((2, 120), dtype=torch.int32, device="cuda")
    mask[1, 100:] = 0
    for case, (B, N, M), seg, m in (
            ("spatial [32,1024,16,72]", (32, 1024, 1024), 0, None),
            ("temporal seg 16 [2,16384,16,72]", (2, 16384, 16384), 16,
             None),
            ("cross [2,16384,16,72] kv 120 masked", (2, 16384, 120), 0,
             mask)):
        q, k, v = (torch.randn((B, n, H, D), generator=g, device="cuda")
                   .bfloat16().requires_grad_() for n in (N, M, M))
        gout = torch.randn((B, N, H, D), generator=g,
                           device="cuda").bfloat16()
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = A.attention_bnhd(q, k, v, D ** -0.5, seg_len=seg, kv_mask=m)
            ev[1].record()
            got = torch.autograd.grad(out, (q, k, v), gout)
            ev[2].record()
            ev[2].synchronize()
        fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        plain = A.attention_bnhd_plain(q.detach(), k.detach(), v.detach(),
                                       D ** -0.5, seg_len=seg, kv_mask=m)
        _, _, rel = compare(out.detach(), plain, False)
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(A.attention_bnhd_xla(
            *qkv, D ** -0.5, seg, m), qkv, gout)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
        print(f"  attention_bnhd bf16 grad {case:36s} forward (kernel) "
              f"{fwd_ms:.3f} ms, rel err vs plain {rel:.3g} (limit "
              f"{REL_ERR}); backward (plain recompute) {bwd_ms:.3f} ms; max "
              f"|d grad| vs the plain attention's autograd {diff:.3g} "
              f"(limit 0)", flush=True)
        if rel > REL_ERR:
            fail(f"attention_bnhd bf16 grad {case}: forward rel err {rel}")
        if diff != 0 or not all(torch.isfinite(a).all() for a in got):
            fail(f"attention_bnhd bf16 grad {case}: the wrapped kernel's "
                 f"gradient differs from the plain attention's by {diff}")
        del q, k, v, out, got, want, qkv, plain


STDIT_CFG = {"model": dict(type="STDiT-XL/2"), "num_frames": 16,
             "image_size": (512, 512), "scheduler": dict(
                 type="iddpm", num_sampling_steps=STEPS, cfg_scale=4.0),
             "dtype": "bf16"}
# STDiT-XL/2 with its head split changed and nothing else (6 heads of 192;
# 28 blocks at C = 1152, its weight shapes): K3 full, seg and masked at
# D = 192 inside a real model
STDIT_H6_CFG = {**STDIT_CFG, "model": dict(
    type="STDiT", depth=28, hidden_size=1152, patch_size=(1, 2, 2),
    num_heads=6)}
TINY = dict(hidden_size=64, depth=2, num_heads=4, caption_channels=32,
            model_max_length=8)
TINY_STDIT_CFG = {"model": dict(type="STDiT", **TINY), "num_frames": 2,
                  "image_size": (128, 256), "dtype": "bf16"}
TINY_STDIT_EPI_CFG = {**TINY_STDIT_CFG, "model": dict(
    type="STDiT", fuse_epilogue=True, **TINY)}
# 96x96 latent: 2304 tokens, so block 0 streams its kv (9 blocks of 256)
TINY_SIGMA_CFG = {"model": dict(type="PixArt", kv_compress_sampling="conv",
                                kv_compress_scale=2, kv_compress_layers=(1,),
                                **TINY),
                  "image_size": 768, "dtype": "bf16"}
# the tiny Σ with PixArtMS's options: the micro-condition (C = 192 in 12
# heads of 16: its three embeddings of C // 3 channels fill C, and K2
# takes K % 64 == 0), qk_norm and the 'ave' sampling on block 1
TINY_SIGMA_MS_CFG = {"model": dict(
    type="PixArt", micro_condition=True, qk_norm=True,
    kv_compress_sampling="ave", kv_compress_scale=2, kv_compress_layers=(1,),
    **{**TINY, "hidden_size": 192, "num_heads": 12}),
    "image_size": 768, "dtype": "bf16"}
TINY_DATA_INFO = {"img_hw": [[768.0, 768.0]], "aspect_ratio": [[1.0]]}
# the other backbones, tiny: DiT at a 2x16x16 latent (128 tokens) on
# labels of TINY_DIT_CLASSES classes, as the full-width DiT, Latte at
# 2x32x32 (spatial blocks over 256 tokens, temporal over 2), MMDiT at 32x32
# (256 image tokens, 8 caption tokens)
TINY_DIT_CLASSES = 10
TINY_DIT_CFG = {"model": dict(type="DiT",
                              condition=f"label_{TINY_DIT_CLASSES}", **TINY),
                "num_frames": 2, "image_size": (128, 128), "dtype": "bf16"}
TINY_LATTE_CFG = {"model": dict(type="Latte", **TINY), "num_frames": 2,
                  "image_size": (256, 256), "dtype": "bf16"}
TINY_MMDIT_CFG = {"model": dict(type="MMDiT", pooled_channels=32, **TINY),
                  "image_size": 256, "dtype": "bf16"}
# its weights at 0.1 x sqrt(64 / C): the activations, and so the bf16
# noise floor TINY_REL_ERR is set for, of the C = 64 tiny models (on the
# CPU, this model's bf16 against its float32: forward 9.4e-3, 3-step
# denoise 2.6e-2 at this scale, 2.1e-2 and 6.4e-2 at 0.1; the C = 64 tiny
# Σ's 9.2e-3 and 2.3e-2)
TINY_MS_SCALE = 0.1 * (64 / 192) ** 0.5


class Fc1AsymPlan:
    """A plan whose MLP fc1 layers take asymmetric dynamic acts, every
    other layer the plan's default: with a sym x sym fc2, fc1 emits its
    int8 codes after K2's zero-point epilogue. Everything but the
    resolver is the plan's."""

    def __init__(self, plan):
        import dataclasses
        d = plan.default_layer
        self.plan = plan
        self.fc1 = dataclasses.replace(d, act=dataclasses.replace(d.act,
                                                                  sym=False))

    def __getattr__(self, name):
        return getattr(self.plan, name)

    def resolver(self):
        return self.plan.resolver({"mlp.fc1": self.fc1})


class SplitPlan:
    """A plan whose resolver splits every block's fc2 and cross proj input
    at Q_DIFFUSION_SPLIT of its channels (the q-diffusion plan's channel
    split: the two parts quantized apart); everything else the plan's."""

    SITES = {"mlp.fc2": 4 * 1152, "cross_attn.proj": 1152}

    def __init__(self, plan):
        self.plan = plan

    def __getattr__(self, name):
        return getattr(self.plan, name)

    def resolver(self):
        import dataclasses
        d = self.plan.default_layer
        return self.plan.resolver({
            site: dataclasses.replace(d, split=int(k * Q_DIFFUSION_SPLIT))
            for site, k in self.SITES.items()})


def ptqd_k_check(name, arm, model, sampler, z, y, mask, slot_map):
    """The flow the PTQD plans exist for, at the arm's model: the fp
    trajectory of one DDIM run (`get_calib_data`), the fp and quantized
    model outputs at each of its steps recorded by a forward hook
    (`recording`) as [n_steps, ...] arrays under `outs`, then
    `calibrate-ptqd-k` through `cli.main`. The k_t must be finite, one a
    step, and equal to `calibrate_ptqd_k` on the same arrays."""
    import tempfile
    import torch
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.pipelines.analysis import calibrate_ptqd_k
    from viditq_tpu_torch.pipelines.inference import get_calib_data
    t0 = time.time()
    cal = get_calib_data(model, sampler, z, y, mask)
    with torch.no_grad(), recording(model) as outs:
        for x, t in zip(cal["xs"], cal["ts"]):
            model(x, t.float(), cal["y"], cal["mask"])
            model(x, t.float(), cal["y"], cal["mask"],
                  qctx=qctx_for(arm, int(t[0]), slot_map))
    fp, qt = (torch.stack(outs[i::2]).numpy() for i in (0, 1))
    with tempfile.TemporaryDirectory() as tmp:
        for tag, arr in (("fp", fp), ("q", qt)):
            np.savez(f"{tmp}/{tag}.npz", outs=arr)
        out = cli.main(["calibrate-ptqd-k", "--fp_trajectory",
                        f"{tmp}/fp.npz", "--quant_trajectory",
                        f"{tmp}/q.npz", "--save_dir", f"{tmp}/k"])
        k = np.load(out["out"])
    n = len(cal["ts"])
    print(f"  {arm}: calibrate-ptqd-k through cli.main on [{n}, "
          f"{', '.join(map(str, fp.shape[1:]))}] fp and quantized outputs "
          f"along the fp trajectory: k_t {np.array2string(k, precision=4)} "
          f"({time.time() - t0:.1f} s)", flush=True)
    if k.shape != (n,) or not np.isfinite(k).all():
        fail(f"{name} {arm}: k_t {k} is not one finite value a step")
    if not np.array_equal(k, calibrate_ptqd_k(fp, qt)):
        fail(f"{name} {arm}: the command's k_t differ from "
             "calibrate_ptqd_k on the same arrays")


def quant_plan(plan=SM8_PLAN, recipe=None):
    """A plan YAML as an arm runs it (`PLAN_RECIPES`): as it is, on the
    native backend or with impl 'fused' ('fused'), on the native backend
    ('native_nocb': without its channel balancing, the
    segmented MP sampler's case), the CB recipe on the fused kernels
    with the q/k/v balancing scale pooled (`qkv_share_cs`), sym weights
    and acts for 'cb_sym', with fc1's acts asym ('fc1_asym',
    `Fc1AsymPlan`), with a static act slot a calibration step
    ('timestep_wise', the CLI's --timestep_wise) or with the q-diffusion
    channel split ('q_diffusion', `SplitPlan`)."""
    import dataclasses
    from viditq_tpu_torch.utils.config import load_quant_config
    qplan = load_quant_config(str(plan))
    if recipe == "fc1_asym":
        return Fc1AsymPlan(qplan)
    if recipe == "timestep_wise":  # a static slot a calibration step
        return load_quant_config(str(plan), timestep_wise=True)
    if recipe == "q_diffusion":
        return SplitPlan(qplan)
    if recipe in ("native", "fused"):
        return qplan.with_backend(recipe)
    if recipe == "native_nocb":
        qplan = qplan.with_backend("native")
        d = qplan.default_layer
        return dataclasses.replace(qplan, default_layer=dataclasses.replace(
            d, smooth_quant=type(d.smooth_quant)()))
    if recipe in ("cb", "cb_sym"):
        qplan = qplan.with_backend("fused")
        d = qplan.default_layer
        d = dataclasses.replace(d, smooth_quant=dataclasses.replace(
            d.smooth_quant, qkv_share_cs=True))
        if recipe == "cb_sym":
            d = dataclasses.replace(
                d, weight=dataclasses.replace(d.weight, sym=True),
                act=dataclasses.replace(d.act, sym=True))
        return dataclasses.replace(qplan, default_layer=d)
    return qplan


def arm_build(name, arm):
    """(plan, recipe, model arguments) of a slice's arm's model: the bf16
    arm runs the sm8 arm's model in fp mode; an MP arm (`MP_ARMS`) builds
    the model of the arm it takes."""
    arm = MP_ARMS[(name, arm)][0] if (name, arm) in MP_ARMS else arm
    key = (name, arm)
    return (ARM_PLANS.get(key, SM8_PLAN), PLAN_RECIPES.get(key),
            tuple(sorted(ARM_MODEL.get(key, {}).items())))


def build_model(cfg, device, scale=0.02, plan=SM8_PLAN, recipe=None,
                calib=None, model_kw=(), stat_t=CB_STAT_T):
    """The workload's model through `utils/workload.build_model` under a
    plan (`quant_plan(plan, recipe)`), with the model arguments model_kw
    ((name, value) pairs) in the config's `model` dict, random weights
    (normal x scale, seed 0: the same fp weights under every plan), min-max
    tables, packed int8 slabs. A CB plan is calibrated in the PTQ phase
    order first: one sq_stat forward on calib = (x, y, mask) at each of
    stat_t (the slice's `STAT_T`)."""
    from viditq_tpu_torch.quant.calibrate import (calibrate_weight_tables,
                                                  smooth_quant_stats)
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.utils.workload import build_model as wl_build
    from viditq_tpu_torch.utils.workload import random_init_
    qplan = quant_plan(plan, recipe)
    cfg = {**cfg, "model": {**cfg["model"], **dict(model_kw)}}
    model = wl_build(cfg, qplan.resolver(), device=device)
    random_init_(model, 0, scale)
    if qplan.default_layer.smooth_quant.enable:
        if calib is None:
            fail("a channel-balancing plan needs calibration inputs")
        smooth_quant_stats(model, *calib, stat_t)
    calibrate_weight_tables(model)
    pack_native_weights(model)
    return model.eval()


def static_acts(qplan) -> bool:
    """Whether a plan's layers quantize their acts statically (act tables
    from an a_calib pass)."""
    d = qplan.default_layer
    return d.act is not None and d.act_quant and not d.act.dynamic


# the calibrated tables a static-act arm hands another (`TABLES_FROM`)
STATIC_TABLES = ("a_delta", "a_zp", "a_min", "a_max", "a_init", "w_delta",
                 "w_zp")


def calibrate_static(model, qplan, sampler, z, y, mask, tables=None):
    """A static-act model's tables: `tables` (another model's, on the same
    weights) where given, else `run_ptq` (sq_stat where CB, weight tables,
    the a_calib pass over `calib_data.n_steps` steps subsampled from the
    trajectory `get_calib_data` captures from the model's own fp sampling
    of (z, y, mask)), then the packed slabs. Returns (act slot map, the
    calibrated timesteps or None, seconds)."""
    import torch
    from viditq_tpu_torch.pipelines.inference import get_calib_data
    from viditq_tpu_torch.pipelines.ptq import run_ptq
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    t0 = time.time()
    if tables is not None:
        model.load_state_dict(tables["state"], strict=False)
        slot_map, calib_ts = tables["slot_map"], None
    else:
        res = run_ptq(model, get_calib_data(model, sampler, z, y, mask),
                      qplan)
        slot_map, calib_ts = res.act_slot_map, res.calib_ts
    pack_native_weights(model)
    if z.is_cuda:
        torch.cuda.synchronize()
    return slot_map, calib_ts, time.time() - t0


def static_tables(model, slot_map) -> dict:
    """A calibrated static-act model's tables, for `calibrate_static`."""
    return {"slot_map": slot_map, "state": {
        k: v.clone() for k, v in model.state_dict().items()
        if k.rpartition(".")[2] in STATIC_TABLES}}


class RectifiedFlow:
    """MMDiT's sampler (`models/mmdit.rectified_flow_sample`) behind the
    samplers' `sample(model, z, y, mask, qctx_factory)`, so
    `pipelines/inference.fp_sample` and `quant_sample` drive it: joint
    CFG batch, `num_steps` Euler steps from t = 1 to 0."""

    cfg_split = False

    def __init__(self, num_steps: int, cfg_scale: float):
        self.num_steps = num_steps
        self.cfg_scale = cfg_scale

    def sample(self, model, z, y, mask=None, qctx_factory=None):
        from viditq_tpu_torch.models.mmdit import rectified_flow_sample
        return rectified_flow_sample(model, z, y, mask,
                                     num_steps=self.num_steps,
                                     cfg_scale=self.cfg_scale,
                                     qctx_factory=qctx_factory)


def arm_sampler(name, arm, cfg):
    """A slice's arm's sampler (`utils/workload.build_sampler`; MMDiT's
    rectified flow): an arm of `AS_WRITTEN` takes its plan's `cfg_split`,
    every other arm samples the joint CFG batch."""
    from viditq_tpu_torch.utils.workload import build_sampler
    if name == "mmdit":
        return RectifiedFlow(STEPS, MMDIT_CFG_SCALE)
    split = ((name, arm) in AS_WRITTEN
             and quant_plan(*arm_build(name, arm)[:2]).cfg_split)
    return build_sampler(cfg, cfg_split=split)


def arm_static_setup(name, arm, model, sampler, z, y, mask, tables):
    """The static act tables of an arm's freshly built model
    (`calibrate_static`: those of the arm `TABLES_FROM` names, from
    `tables`, else `run_ptq`'s on the arm's sampler), recorded in `tables`
    under the arm for the arms after it. Returns (act slot map, calibrated
    timesteps, seconds); (None, None, 0.0) for a plan with dynamic acts."""
    qplan = quant_plan(*arm_build(name, arm)[:2])
    if not static_acts(qplan):
        return None, None, 0.0
    src = TABLES_FROM.get((name, arm))
    slot_map, calib_ts, secs = calibrate_static(
        model, qplan, sampler, z, y, mask, tables=tables.get(src))
    tables[arm] = static_tables(model, slot_map)
    return slot_map, calib_ts, secs


def qctx_for(arm, t: int, slot_map):
    """The context of an arm's forward at timestep t: none for bf16, else
    'quant' with, under static acts, t's act-table slot."""
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    if arm == "bf16":
        return None
    return QuantCtx(t_id=t, mode="quant",
                    act_slot=0 if slot_map is None else int(slot_map[t]))


def mp_sampler(cfg, device, qplan, sampler, weight_cfg, act_cfg=None,
               act_slot_map=None):
    """The timestep-wise MP sampler of a plan over the workload's models on
    `device` (`pipelines/mixed_precision.build_mp_sampler`), from the
    bitwidth-config YAMLs or dicts; act_slot_map: static act tables'
    slots."""
    from viditq_tpu_torch.pipelines.mixed_precision import build_mp_sampler
    from viditq_tpu_torch.utils.config import load_bitwidth_config
    from viditq_tpu_torch.utils.workload import build_model as wl_build

    def load(c):
        return load_bitwidth_config(str(c)) if isinstance(c, Path) else c
    return build_mp_sampler(lambda r: wl_build(cfg, r, device=device),
                            sampler, qplan, load(weight_cfg), load(act_cfg),
                            act_slot_map=act_slot_map)


def retile(weight_cfg, steps: int):
    """A bitwidth config's first `steps` ranges (in the file's order) onto
    a `steps`-step sampler, one range a step, as the JAX package's tiny
    bench does (bench_configs.py:231-234)."""
    from viditq_tpu_torch.utils.config import load_bitwidth_config
    vals = [v for k, v in load_bitwidth_config(str(weight_cfg)).items()
            if k != "fp_layers"]
    return {f"{i}-{i}": vals[steps - 1 - i] for i in range(steps)}


def check_k_major(model) -> int:
    """Every native QuantLinear's packed weight is K-major on the card (the
    layout the int8 GEMM kernels take); returns how many there are."""
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    native = [m for m in model.modules()
              if isinstance(m, QuantLinear) and m.native]
    bad = [m for m in native
           if not (m.w_int.is_cuda and m.w_int[0].t().is_contiguous())]
    if bad:
        fail(f"{len(bad)} of {len(native)} packed weights are not K-major "
             f"on the card")
    return len(native)


def tiny_inputs(cfg):
    """x [2, 4, *latent], t = 700, y [2, 1, 8, 32] (bf16) and a mask with
    one padded prompt, on the CPU, from seed 1."""
    import torch
    from viditq_tpu_torch.utils.workload import latent_size
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 4, *latent_size(cfg)))
                     ).bfloat16()
    t = torch.tensor([700, 700])
    y = torch.tensor(rng.standard_normal((2, 1, 8, 32))).bfloat16()
    mask = torch.ones((2, 8), dtype=torch.int32)
    mask[1, 6:] = 0
    return x, t, y, mask


def tiny_pair(x, t, y, mask, cpu_fwd, gpu_fwd, sample, slot_map=None):
    """(forward, denoise) relative errors of the card against the CPU: the
    two models' forward at t = 700 (CB's second timerange; with a static
    act slot map, its slot) and sample(model, z, y, mask) from the first
    latent."""
    import torch
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    q = QuantCtx(t_id=700, mode="quant",
                 act_slot=0 if slot_map is None else int(slot_map[700]))
    cuda = (lambda v: None if v is None else v.cuda())  # noqa: E731
    with torch.no_grad():
        want = cpu_fwd(x, t, y, mask, qctx=q)
        got = gpu_fwd(x.cuda(), t.cuda(), y.cuda(), cuda(mask),
                      qctx=q).cpu()
    rel_fwd = float((got - want).norm() / want.norm())
    mask1 = None if mask is None else mask[:1]
    want = sample("cpu", x[:1], y, mask1).float()
    got = sample("cuda", x[:1].cuda(), y.cuda(), cuda(mask1)).float().cpu()
    return rel_fwd, float((got - want).norm() / want.norm())


@contextlib.contextmanager
def recording(model):
    """The model's outputs (float32, on the CPU) of every forward made
    inside the block, in order."""
    outs = []
    hook = model.register_forward_hook(
        lambda mod, args, out: outs.append(out.detach().float().cpu()))
    try:
        yield outs
    finally:
        hook.remove()


def tiny_verdict(name, latent, steps, rel_fwd, rel_dn):
    print(f"phase reference: tiny {name} {tuple(latent)}, card vs "
          f"CPU plain versions: forward rel err {rel_fwd:.3g}, {steps}-step "
          f"CFG denoise rel err {rel_dn:.3g} (limit {TINY_REL_ERR})",
          flush=True)
    for rel in (rel_fwd, rel_dn):
        if not np.isfinite(rel) or rel > TINY_REL_ERR:
            fail(f"tiny {name} disagrees with its CPU reference: {rel}")


def phase_reference():
    """Tiny models (STDiT under sm8, with `fuse_epilogue`, under attn8,
    the fused reference W8A8, the native W8A8 and the W4A8 CB recipe asym
    and sym, PixArt-Σ under sm8 and under its W4A8 CB plan; then the
    reference plans as written: STDiT under viditq_w8a8 and viditq_w6a6
    (simulate), w8a8_naive (static acts, simulate; and on the native
    backend under impl 'fused', K2 on static codes) and the hybrid plan,
    PixArt-Σ under its w8a8_naive, each static-act model calibrated by
    `run_ptq` on the CPU model's fp trajectory first; a PixArtMS with the
    micro-condition, qk_norm and the 'ave' KV sampling under sm8): the
    card's kernels against the CPU's plain versions on the same weights and
    inputs (a CB model calibrated on the CPU first), for one forward
    (float32 output; t = 700, CB's second timerange) and a 3-step CFG
    denoise (DDIM for STDiT, through both CB timeranges, with cond and
    null apart where the plan sets `cfg_split`; DPM-Solver++ for
    PixArt-Σ); then the t20 MP sampler, its ranges retiled onto a 2-step
    DDIM, over the tiny CB model (`cb_mp`, the gather path: the union
    model's forward and the denoise) and over the tiny W4A8 model without
    CB on the native backend (the segmented path, K7a -> K7b: the base
    model's forward and the denoise); then tiny DiT (sm8, on a label),
    Latte (W4A8 CB) and MMDiT (its W4A8 plan, a 3-step rectified flow),
    whose model outputs at every step of the denoise are held as well.
    Weights are drawn at 0.1 so activations are O(1)."""
    import copy

    import torch
    from viditq_tpu_torch.models.text_encoder import ClassEncoder
    from viditq_tpu_torch.pipelines.inference import quant_sample
    from viditq_tpu_torch.pipelines.mixed_precision import GatherMPSampler
    from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    from viditq_tpu_torch.utils.workload import latent_size
    ddim = IDDPM(num_sampling_steps=3, cfg_scale=4.0)
    # the reference plans that set `cfg_split` sample with it (AS_WRITTEN)
    ddim_split = IDDPM(num_sampling_steps=3, cfg_scale=4.0, cfg_split=True)
    dpm = DPMSolverSampler(num_sampling_steps=3, cfg_scale=4.5)
    for name, sl, cfg, sampler, plan, recipe in (
            ("sm8 STDiT", "stdit", TINY_STDIT_CFG, ddim, SM8_PLAN, None),
            ("sm8_epi STDiT (fuse_epilogue)", "stdit", TINY_STDIT_EPI_CFG,
             ddim, SM8_PLAN, None),
            ("attn8 STDiT", "stdit", TINY_STDIT_CFG, ddim, ATTN8_PLAN, None),
            ("fused asym STDiT", "stdit", TINY_STDIT_CFG, ddim, FUSED_PLAN,
             None),
            ("w8a8 STDiT", "stdit", TINY_STDIT_CFG, ddim, W8A8_PLAN,
             "native"),
            ("cb STDiT (W4A8 CB)", "stdit", TINY_STDIT_CFG, ddim, CB_PLAN,
             "cb"),
            ("cb_sym STDiT", "stdit", TINY_STDIT_CFG, ddim, CB_PLAN,
             "cb_sym"),
            ("sm8 PixArt-Σ", "sigma", TINY_SIGMA_CFG, dpm, SM8_PLAN, None),
            ("cb PixArt-Σ (W4A8 CB)", "sigma", TINY_SIGMA_CFG, dpm,
             SIGMA_CB_PLAN, "cb"),
            ("sim_w8a8 STDiT (viditq_w8a8, simulate, cfg_split)", "stdit",
             TINY_STDIT_CFG, ddim_split, SIM_W8A8_PLAN, None),
            ("sim_w6a6 STDiT (viditq_w6a6, simulate)", "stdit",
             TINY_STDIT_CFG, ddim, SIM_W6A6_PLAN, None),
            ("naive STDiT (w8a8_naive, static acts, simulate)", "stdit",
             TINY_STDIT_CFG, ddim, NAIVE_PLAN, None),
            ("naive_fused STDiT (K2 on static codes)", "stdit",
             TINY_STDIT_CFG, ddim, NAIVE_PLAN, "fused"),
            ("hybrid STDiT (K7a -> K7b MLP, weight-only attention, "
             "cfg_split)", "stdit", TINY_STDIT_CFG, ddim_split, HYBRID_PLAN,
             None),
            ("naive PixArt-Σ (w8a8_naive, static acts, running stats)",
             "sigma", TINY_SIGMA_CFG, dpm, SIGMA_NAIVE_PLAN, None)):
        x, t, y, mask = tiny_inputs(cfg)
        cpu = build_model(cfg, "cpu", scale=0.1, plan=plan, recipe=recipe,
                          calib=(x, y, mask), stat_t=STAT_T[sl])
        slot_map = None
        qplan = quant_plan(plan, recipe)
        if static_acts(qplan):  # calibrated on the CPU, as a CB model is
            slot_map = calibrate_static(cpu, qplan, sampler, x[:1], y,
                                        mask[:1])[0]
        gpu = copy.deepcopy(cpu).to("cuda")
        check_k_major(gpu)
        models = {"cpu": cpu, "cuda": gpu}
        tiny_verdict(name, latent_size(cfg), 3, *tiny_pair(
            x, t, y, mask, cpu, gpu,
            lambda dev, *a: quant_sample(models[dev], sampler, *a,
                                         act_slot_map=slot_map),
            slot_map=slot_map))
    # PixArtMS's options (micro-condition, qk_norm, 'ave'): the model takes
    # data_info, so the samplers get the model with it bound
    cfg = TINY_SIGMA_MS_CFG
    x, t, y, mask = tiny_inputs(cfg)
    cpu = build_model(cfg, "cpu", scale=TINY_MS_SCALE)
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    check_k_major(models["cuda"])

    def with_info(model):
        def fwd(x, t, y, mask=None, qctx=None):
            return model(x, t, y, mask, qctx=qctx, data_info={
                k: torch.tensor(v, device=x.device)
                for k, v in TINY_DATA_INFO.items()})
        return fwd
    tiny_verdict("sm8 PixArtMS (micro_condition, qk_norm, 'ave')",
                 latent_size(cfg), 3, *tiny_pair(
                     x, t, y, mask, with_info(cpu), with_info(models["cuda"]),
                     lambda dev, *a: quant_sample(with_info(models[dev]), dpm,
                                                  *a)))
    ddim2 = IDDPM(num_sampling_steps=2, cfg_scale=4.0)
    for name, recipe in (("cb_mp STDiT (W4A8 CB + t20 MP, gather)", "cb"),
                         ("segmented MP STDiT (W4A8 native, no CB)",
                          "native_nocb")):
        cfg = TINY_STDIT_CFG
        x, t, y, mask = tiny_inputs(cfg)
        cpu = build_model(cfg, "cpu", scale=0.1, plan=CB_PLAN, recipe=recipe,
                          calib=(x, y, mask))
        models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
        qplan = quant_plan(CB_PLAN, recipe)
        runs = {dev: mp_sampler(cfg, dev, qplan, ddim2, retile(MP_WEIGHT, 2))
                for dev in models}
        if isinstance(runs["cpu"], GatherMPSampler) != (recipe == "cb"):
            fail(f"tiny {name}: the MP sampler took the other path")
        fwd = {dev: (run.prepare(models[dev])
                     if isinstance(run, GatherMPSampler) else models[dev])
               for dev, run in runs.items()}
        check_k_major(fwd["cuda"])
        tiny_verdict(name, latent_size(cfg), 2, *tiny_pair(
            x, t, y, mask, fwd["cpu"], fwd["cuda"],
            lambda dev, *a: runs[dev](models[dev], *a)))
        mp_sees_the_model(name, runs["cuda"], models["cuda"], ddim2,
                          x[:1].cuda(), y.cuda(), mask[:1].cuda())
    # the other backbones: DiT under sm8 on a label (K4, K2, K5, K3), Latte
    # under the W4A8 CB recipe (its temporal blocks' K3 at N = M = 2), MMDiT
    # under its W4A8 plan (K1, K2 with fc1's emission, K5), 3-step samplers.
    # DDIM from t = 999 leaves a latent of ~200 z, whose bf16 rounding can
    # hide what the model adds (the tiny DiT's latents read equal), so the
    # model's outputs at every step of the denoise are held too: card
    # against CPU, nonzero and within TINY_REL_ERR
    rf = RectifiedFlow(3, MMDIT_CFG_SCALE)
    for name, sl, cfg, sampler, plan, recipe in (
            ("sm8 DiT (label)", "dit", TINY_DIT_CFG, ddim, SM8_PLAN, None),
            ("cb Latte (W4A8 CB)", "latte", TINY_LATTE_CFG, ddim, CB_PLAN,
             "cb"),
            ("w4a8 MMDiT", "mmdit", TINY_MMDIT_CFG, rf, MMDIT_PLAN, None)):
        x, t, y, mask = tiny_inputs(cfg)
        if sl == "dit":  # a label and the CFG's null label (`ClassEncoder`)
            enc = ClassEncoder(TINY_DIT_CLASSES)
            y, mask = torch.cat([enc.encode([3])["y"], enc.null(1)]), None
        if sl == "mmdit":
            x = x.float()  # its Euler update runs in float32
        cpu = build_model(cfg, "cpu", scale=0.1, plan=plan, recipe=recipe,
                          calib=(x, y, mask), stat_t=STAT_T[sl])
        models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
        check_k_major(models["cuda"])
        outs = {}

        def sample(dev, *a, _s=sampler, _m=models, _o=outs):
            with recording(_m[dev]) as _o[dev]:
                return quant_sample(_m[dev], _s, *a)
        rels = tiny_pair(x, t, y, mask, cpu, models["cuda"], sample)
        tiny_verdict(name, latent_size(cfg), 3, *rels)
        want, got = (torch.cat([o.flatten() for o in outs[d]])
                     for d in ("cpu", "cuda"))
        rel = (float((got - want).norm() / want.norm())
               if got.shape == want.shape else float("nan"))
        print(f"phase reference: tiny {name}: the model's outputs at the "
              f"{len(outs['cuda'])} forwards of the denoise, card vs CPU, "
              f"rel err {rel:.3g} (must be nonzero and within "
              f"{TINY_REL_ERR})", flush=True)
        if not 0 < rel <= TINY_REL_ERR:
            fail(f"tiny {name}: the denoise's model outputs read {rel}")
    tiny_train_step()


def tiny_train_step():
    """One train step's loss and gradients of the tiny STDiT (bf16 compute,
    float32 parameters, gradient checkpointing on) on the card against the
    same step on the CPU, on one batch and noise draw: the loss and the
    concatenated gradient within TINY_REL_ERR; the card's K3 launches
    exactly 3 a block, twice (forward and recompute)."""
    import copy

    import torch
    from viditq_tpu_torch.kernels import _counters
    from viditq_tpu_torch.samplers.gaussian_diffusion import (
        make_schedule, training_losses)
    from viditq_tpu_torch.utils.workload import build_model as wl_build
    from viditq_tpu_torch.utils.workload import random_init_
    cfg = {**TINY_STDIT_CFG, "model": {**TINY_STDIT_CFG["model"],
                                       "grad_checkpoint": True}}
    x, _, y, mask = tiny_inputs(cfg)
    cpu = random_init_(wl_build(cfg, device="cpu"), 0, 0.1)
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    sched = make_schedule(timestep_respacing=[1000])
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([10, 900])
    res = {}
    for dev, model in models.items():
        xd, td, yd, md, nd = (a.to(dev) for a in (x.float(), t, y.float(),
                                                  mask, noise))
        _counters.reset()
        loss = training_losses(lambda xt, tt: model(xt, tt, yd, md), xd, td,
                               nd, sched, 4)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    materialize_grads=True)
        launched = _counters.snapshot()["attention_bnhd"]["launches"]
        res[dev] = (float(loss.detach()), torch.cat(
            [a.float().flatten().cpu() for a in grads]), launched)
    rel_loss = abs(res["cuda"][0] / res["cpu"][0] - 1)
    gc, gg = res["cpu"][1], res["cuda"][1]
    rel_grad = float((gg - gc).norm() / gc.norm())
    want = 3 * 2 * len(models["cuda"].blocks)
    print(f"phase reference: tiny STDiT train step (grad_checkpoint), card "
          f"vs CPU: loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f}, rel "
          f"err {rel_loss:.3g}; gradient rel err {rel_grad:.3g} (limit "
          f"{TINY_REL_ERR}); K3 launches {res['cuda'][2]} (want {want})",
          flush=True)
    if not (rel_loss <= TINY_REL_ERR and rel_grad <= TINY_REL_ERR
            and torch.isfinite(gg).all()):
        fail(f"tiny train step: loss {rel_loss}, gradient {rel_grad}")
    if res["cuda"][2] != want:
        fail(f"tiny train step: K3 launched {res['cuda'][2]}, want {want}")


def mp_sees_the_model(name, run, model, sampler, z, y, mask):
    """The card's MP trajectory is the ranges' own: its latent moves away
    from z and away from the base model's run at the plan's bits (every
    layer W4), as the CPU tests hold the same samplers (tests/
    test_torch_mp.py); a check that compared two runs of one wrong model
    would pass the card-vs-CPU verdict."""
    import torch
    from viditq_tpu_torch.pipelines.inference import quant_sample
    with torch.no_grad():
        got = run(model, z, y, mask).float()
        base = quant_sample(model, sampler, z, y, mask).float()
    off_z = float((got - z.float()).norm() / z.float().norm())
    off_base = float((got - base).norm() / base.norm())
    print(f"phase reference: tiny {name} on the card: latent vs z rel "
          f"{off_z:.4g} (must exceed 0.01), vs the all-W4 base model's "
          f"run {off_base:.4g} (must exceed 1e-4)", flush=True)
    if not (off_z > 0.01 and off_base > 1e-4):
        fail(f"tiny {name}: the MP sampler's latent does not show its "
             f"ranges' bits")


def mp_report(name, arm, cfg, qplan, sampler, model):
    """An MP arm's sampler and union model over its base model (built,
    adapted and packed on the card; the seconds are printed): the union
    spans, each span's weight bits by layer kind (fail unless every kind
    runs `MP_BITS`' bits of its span's MP range: STDiT's t20 the attention
    linears W4 and fc1/fc2 W8 in every span, Latte's attention 8/4/4/8),
    the K-major int8 weights and their slabs. Fails unless the sampler
    takes the gather path. Returns (sampler, union model)."""
    import torch
    from viditq_tpu_torch.pipelines.mixed_precision import GatherMPSampler
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    _, w_cfg, a_cfg = MP_ARMS[(name, arm)]
    t0 = time.time()
    run = mp_sampler(cfg, "cuda", qplan, sampler, w_cfg, a_cfg)
    if not isinstance(run, GatherMPSampler):
        fail(f"{name} {arm}: the MP sampler did not take the gather path")
    union = run.prepare(model)
    torch.cuda.synchronize()
    secs = time.time() - t0
    kinds = {}
    for n, m in union.named_modules():
        if isinstance(m, QuantLinear) and m.native:
            kind = ".".join(p for p in n.split(".") if not p.isdigit())
            kinds.setdefault(kind, set()).add(
                m.lspec.weight.mp_bits or (m.lspec.weight.n_bits,))
    slabs = sum(m.w_int.shape[0] for m in union.modules()
                if isinstance(m, QuantLinear) and m.native)
    print(f"  {arm}: the gather path (`GatherMPSampler`, one union "
          f"model); {STEPS}-step union spans {list(run.spans)} (MP range "
          f"{list(run.mp_idx)}, CB timerange {list(run.cb_idx)}); bits by "
          f"span and layer kind "
          f"{ {k: sorted(v) for k, v in sorted(kinds.items())} }; union "
          f"model built + adapted + calibrated + packed in {secs:.1f} s, "
          f"{check_k_major(union)} K-major int8 weights in {slabs} slabs",
          flush=True)
    for kind, bits in kinds.items():
        want = tuple(MP_BITS[(name, arm)](kind, r) for r in run.mp_idx)
        if len(want) != run.n_ranges or bits != {want}:
            fail(f"{name} {arm}: {kind} runs bits {bits} by span, not "
                 f"{want}")
    return run, union


def slice_inputs(name, cfg, z_scale, n_prompt, rng):
    """A slice's sampling inputs on the card from `rng`: z [1, 4, *latent]
    (x z_scale; bf16, float32 for MMDiT, whose Euler update runs in
    float32), the CFG's [cond; null] condition y and the prompt mask: for
    the text slices y [2, 1, n_prompt, 4096] x 0.1 and an all-ones mask
    [1, n_prompt]; for DiT one ImageNet label and the null label
    (`ClassEncoder`), no mask."""
    import torch
    from viditq_tpu_torch.models.text_encoder import ClassEncoder
    from viditq_tpu_torch.utils.workload import latent_size
    z = torch.tensor(rng.standard_normal((1, 4, *latent_size(cfg))) * z_scale,
                     dtype=torch.float32 if name == "mmdit"
                     else torch.bfloat16, device="cuda")
    if name in ("dit", "dit_l", "dit_l_h4"):
        enc = ClassEncoder(DIT_CLASSES)
        y = torch.cat([enc.encode([int(rng.integers(DIT_CLASSES))])["y"],
                       enc.null(1)]).cuda()
        return z, y, None
    y = torch.tensor(rng.standard_normal((2, 1, n_prompt, 4096)) * 0.1,
                     dtype=torch.bfloat16, device="cuda")
    return z, y, torch.ones((1, n_prompt), dtype=torch.int32, device="cuda")


def run_slice(name, cfg, z_scale, n_prompt):
    """Every arm of one slice over the whole schedule: ms/step, peak
    memory, launches, plain calls on CUDA (must be 0), each quantized arm's
    error against bf16; for a CB arm, the steps run in each timerange (each
    slab must serve some). The bf16 and sm8 arms share the sm8 plan's
    model; another plan's arm gets its own model, built from the same seed
    (a CB model calibrated on this run's z, y and mask; a static-act
    model by `arm_static_setup`, its act slot map passed to
    `quant_sample`). An arm samples with `arm_sampler`. An MP arm
    (`MP_ARMS`) samples the model of the arm it takes through the MP
    sampler (`mp_report`): each union span that holds sampler steps must
    serve exactly those, and its launches must equal that arm's. Returns
    each kernel's launches summed over the arms."""
    import torch
    from viditq_tpu_torch.kernels import _counters
    from viditq_tpu_torch.pipelines.inference import fp_sample, quant_sample
    from viditq_tpu_torch.quant.qlinear import QuantLinear, timerange_of
    from viditq_tpu_torch.utils.workload import latent_size
    latent = latent_size(cfg)
    rng = np.random.default_rng(0)
    z, y, mask = slice_inputs(name, cfg, z_scale, n_prompt, rng)
    # the latent moved by 1e-3 relative: one bf16 step in some entries
    z_moved = (z.float() * (1.0 + 1e-3 * torch.tensor(
        rng.standard_normal(z.shape), dtype=torch.float32,
        device="cuda"))).to(torch.bfloat16)
    arms = tuple(SLICE_KERNELS[name])
    counts, outs, ms = {}, {}, {}
    # the fused and native asym arms and bf16 along the schedule: after
    # the warm-up CFG forward, after 1 and 5 steps; and that forward on the
    # moved latent (runs not counted)
    traced = ("bf16", "w8a8", "fused")
    along, moved = {}, {}
    model, model_plan = None, None
    # the static-act arms' tables, for the arm `TABLES_FROM` hands them
    tables = {}
    for arm in arms:
        plan = arm_build(name, arm)
        sampler = arm_sampler(name, arm, cfg)
        if plan != model_plan:
            model = None
            torch.cuda.empty_cache()
            t0 = time.time()
            model = build_model(cfg, "cuda", plan=plan[0], recipe=plan[1],
                                calib=(torch.cat([z, z]), y, mask),
                                model_kw=plan[2], stat_t=STAT_T[name])
            torch.cuda.synchronize()
            model_plan = plan
            print(f"phase slice {name}: {cfg['model']['type']} at latent "
                  f"{latent}, CFG batch 2, plan {plan[0].name}"
                  f"{f' ({plan[1]})' if plan[1] else ''}"
                  f"{f' {dict(plan[2])}' if plan[2] else ''}, built + "
                  f"calibrated + packed in {time.time() - t0:.1f} s, "
                  f"{check_k_major(model)} K-major int8 weights", flush=True)
            slot_map, calib_ts, secs = arm_static_setup(
                name, arm, model, sampler, z, y, mask, tables)
            if slot_map is not None:
                src = TABLES_FROM.get((name, arm))
                print(f"  {arm}: static act tables "
                      + (f"of {src}" if src else
                         f"from run_ptq's a_calib pass over "
                         f"{len(calib_ts)} of the {STEPS} steps of "
                         f"this model's fp trajectory (timesteps "
                         f"{sorted(int(c) for c in calib_ts)})")
                      + f", packed, in {secs:.1f} s", flush=True)
        # the model the arm's forwards run: an MP arm's union model
        runner, mp_run = model, None
        if (name, arm) in MP_ARMS:
            mp_run, runner = mp_report(name, arm, cfg, quant_plan(*plan[:2]),
                                       sampler, model)
        # the warm-up forward's context names its timestep (t = 999: a CB
        # model's second timerange) and, under static acts, its slot
        qctx = qctx_for(arm, 999, slot_map)
        # warm-up: one CFG forward
        with torch.no_grad():
            fwd = runner(torch.cat([z, z]), torch.tensor([999.0, 999.0],
                                                          device="cuda"),
                         y, mask, qctx=qctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        smooth = next((m.smooth for m in runner.modules()
                       if isinstance(m, QuantLinear)
                       and m.smooth is not None), None)
        tr_steps, hook = None, None
        if arm != "bf16" and smooth is not None:
            # the CFG forwards of the run in each CB timerange (an MP
            # arm's: each union span)
            tr_steps = [0] * smooth.n_timerange

            def count(_mod, args, kwargs):
                qc = kwargs.get("qctx", args[4] if len(args) > 4 else None)
                tr_steps[timerange_of(smooth, qc.t_id)] += 1
            hook = runner.register_forward_pre_hook(count, with_kwargs=True)
        _counters.reset()
        t0 = time.time()
        if mp_run is not None:
            out = mp_run(model, z, y, mask)
        elif arm == "bf16":
            out = fp_sample(model, sampler, z, y, mask)
        else:
            out = quant_sample(model, sampler, z, y, mask,
                               act_slot_map=slot_map)
        torch.cuda.synchronize()
        ms[arm] = (time.time() - t0) * 1e3 / STEPS
        counts[arm] = _counters.snapshot()
        if hook is not None:
            hook.remove()
            print(f"  {arm}: CFG forwards in each "
                  f"{'union span' if mp_run else 'CB timerange'} "
                  f"{dict(zip(smooth.timerange, tr_steps))}", flush=True)
            if mp_run is not None:
                tmap = [int(tt) for tt in sampler.schedule.timestep_map]
                want = [sum(lo <= tt <= hi for tt in tmap)
                        for lo, hi in smooth.timerange]
                if tr_steps != want:
                    fail(f"{name} {arm}: CFG forwards by union span "
                         f"{tr_steps} != the sampler's steps there {want}")
            elif min(tr_steps) == 0:
                fail(f"{name} {arm}: a timerange's slabs served no step "
                     f"({tr_steps})")
        outs[arm] = out.float()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  {arm}: {STEPS} steps, {ms[arm]:.1f} ms/step, peak memory "
              f"{peak:.2f} GiB, launches "
              f"{ {k: v['launches'] for k, v in counts[arm].items()} }, "
              f"plain calls on CUDA "
              f"{ {k: v['plain_cuda'] for k, v in counts[arm].items()} }",
              flush=True)
        if tuple(out.shape) != (1, 4, *latent):
            fail(f"{name} {arm} output shape {tuple(out.shape)}")
        if not torch.isfinite(outs[arm]).all():
            fail(f"{name} {arm} output is not finite")
        if any(v["plain_cuda"] for v in counts[arm].values()):
            fail(f"{name} {arm}: a plain version ran on CUDA tensors")
        for k, v in counts[arm].items():
            if (v["launches"] > 0) != (k in SLICE_KERNELS[name][arm]):
                fail(f"{name} {arm} arm launched {k} {v['launches']} times")
        per_fwd = FORWARD_LAUNCHES.get((name, arm)) or {
            k: n * len(model.blocks)
            for k, n in BLOCK_LAUNCHES.get((name, arm), {}).items()}
        fwd_a_step = 2 if sampler.cfg_split else 1
        want = {k: n * STEPS * fwd_a_step for k, n in per_fwd.items()}
        got = {k: counts[arm][k]["launches"] for k in want}
        if got != want:
            fail(f"{name} {arm} launches {got} != {want}")
        if mp_run is not None:
            base_arm = MP_ARMS[(name, arm)][0]
            got, want = ({k: v["launches"] for k, v in counts[a].items()}
                         for a in (arm, base_arm))
            if got != want:
                fail(f"{name} {arm} launches {got} != {base_arm}'s {want}")
        if (name, arm) in PTQD_ARMS:
            ptqd_k_check(name, arm, model, sampler, z, y, mask, slot_map)
        if all(a in arms for a in traced) and arm in traced:
            sample = fp_sample if arm == "bf16" else quant_sample
            along[arm] = [fwd.float()] + [
                sample(model, sampler, z, y, mask, step_indices=range(
                    STEPS - 1, STEPS - 1 - n, -1)).float() for n in (1, 5)]
            along[arm].append(outs[arm])
            with torch.no_grad():
                fwd_m = model(torch.cat([z_moved, z_moved]), torch.tensor(
                    [999.0, 999.0], device="cuda"), y, mask, qctx=qctx)
            moved[arm] = float((fwd_m.float() - fwd.float()).norm()
                               / fwd.float().norm())
            del fwd_m
        del fwd
        if mp_run is not None:  # the union model's slabs go with it
            runner = mp_run = None
            torch.cuda.empty_cache()
    model = None
    torch.cuda.empty_cache()
    if along:
        # the same asym semantics through the fused and native dataflows
        def rel(a, b, i):
            return float((along[a][i] - along[b][i]).norm()
                         / along[b][i].norm())
        for i, label in enumerate(("one CFG forward (t=999, model output)",
                                   "1 step", "5 steps", f"{STEPS} steps")):
            print(f"  {name}: after {label}: fused vs w8a8 rel err "
                  f"{rel('fused', 'w8a8', i):.4g}; vs bf16: fused "
                  f"{rel('fused', 'bf16', i):.4g}, w8a8 "
                  f"{rel('w8a8', 'bf16', i):.4g}", flush=True)
        dz = float((z_moved.float() - z.float()).norm() / z.float().norm())
        print(f"  {name}: one CFG forward on the latent moved by {dz:.3g} "
              f"(one bf16 step in some entries) moves the output by: "
              f"{'; '.join(f'{a} {r:.4g}' for a, r in moved.items())}",
              flush=True)
    if "sm8_epi" in outs:
        # the same plan and weights, the residual adds in the epilogues
        # (rounded once in f32, not twice in bf16)
        print(f"  {name}: sm8_epi {ms['sm8_epi']:.1f} ms/step against sm8 "
              f"{ms['sm8']:.1f}; final latents apart by rel "
              f"{float((outs['sm8_epi'] - outs['sm8']).norm() / outs['sm8'].norm()):.4g}",
              flush=True)
    for arm in arms:
        if (name, arm) in MP_ARMS:
            base_arm = MP_ARMS[(name, arm)][0]
            print(f"  {name}: {arm} {ms[arm]:.1f} ms/step against "
                  f"{base_arm} {ms[base_arm]:.1f}; final latents apart by "
                  f"rel {float((outs[arm] - outs[base_arm]).norm() / outs[base_arm].norm()):.4g}",
                  flush=True)
    rels = {}
    for arm in arms[1:]:
        rel = float((outs[arm] - outs["bf16"]).norm() / outs["bf16"].norm())
        rels[arm] = rel
        sib = LOW_BIT_ARMS.get((name, arm))
        print(f"  {name}: {STEPS} steps; bf16 {ms['bf16']:.1f} ms/step, "
              f"{arm} {ms[arm]:.1f} ms/step; {arm} vs bf16 final-latent rel "
              f"err {rel:.4g} ("
              + (f"finite and above {sib}'s" if sib
                 else f"limit {SLICE_REL_ERR}") + ")", flush=True)
        if sib is None and rel > SLICE_REL_ERR:
            fail(f"{name}: {arm} vs bf16 relative error {rel}")
    for (sl, arm), sib in LOW_BIT_ARMS.items():
        if sl == name and not (np.isfinite(rels[arm])
                               and rels[arm] > rels[sib]):
            fail(f"{name}: {arm} vs bf16 relative error {rels[arm]} is not "
                 f"finite and above {sib}'s {rels[sib]}")
    return {k: sum(counts[arm][k]["launches"] for arm in arms)
            for k in counts[arms[0]]}


# the CLI phase: STDiT-XL/2 16x512x512 through `viditq_tpu_torch.cli`
CLI_WORKLOAD = ROOT / "configs/workload/opensora_16x512x512.py"
CLI_STEPS = 20
# the analysis commands at full width with the depth and steps cut (one
# sweep of every quantized layer's alphas at every block otherwise)
CLI_ANALYSIS_DEPTH, CLI_ANALYSIS_STEPS = 4, 4
# a command's kernels: the STDiT arm (`STDIT_ARM_KERNELS`: the slices
# stdit and stdit_plans) it runs as
STDIT_ARM_KERNELS = {**SLICE_KERNELS["stdit_plans"], **SLICE_KERNELS["stdit"]}
CLI_KERNELS = {"inference": "bf16", "get-calib-data": "bf16",
               "ptq sm8": None, "quant-generate sm8": "sm8",
               "ptq naive": "naive", "quant-generate naive": "naive",
               # the segmented MP sampler on the simulate backend: K3 alone
               "quant-generate-mp viditq_w4a8": "sim_w8a8",
               "quant-generate-mp naive": "naive",
               "get-sensitivity": "w8a8",
               "inference (analysis cut)": "bf16", "sweep-alpha": "bf16",
               "smooth-quant-list": "bf16",
               # phase recon: the capture forwards in bf16 (K3), the
               # float32 block's forwards (K3's float32 mode); sampling
               # on the simulate backend (K3) and the native one (K7a,
               # K7b, K3); layer granularity captures in bf16 only
               "ptq adaround": ("attention_bnhd", "attention_bnhd_f32"),
               "quant-generate adaround": "sim_w8a8",
               "quant-generate adaround native": "w8a8",
               "quant-generate nearest": "sim_w8a8",
               "ptq adaround layer": ("attention_bnhd",),
               # phase recon_sigma: PixArt-Σ 1024 (blocks 0-13 stream their
               # kv: K6; blocks 14-27 compress it and run `sdpa`); its
               # float32 blocks' forwards on K6's and K3's float32 modes
               "inference sigma": ("attention_bnhd", "attention_bnhd_stream"),
               "get-calib-data sigma": ("attention_bnhd",
                                        "attention_bnhd_stream"),
               "ptq adaround sigma": ("attention_bnhd",
                                      "attention_bnhd_stream",
                                      "attention_bnhd_f32",
                                      "attention_bnhd_stream_f32"),
               "quant-generate adaround sigma": ("attention_bnhd",
                                                 "attention_bnhd_stream"),
               "quant-generate adaround native sigma": (
                   "dynamic_quant_rows", "int8_matmul", "attention_bnhd",
                   "attention_bnhd_stream"),
               "quant-generate nearest sigma": ("attention_bnhd",
                                                "attention_bnhd_stream"),
               # phase samplers: STDiT's ancestral loop in phase cli's
               # directory; PixArt-α 512 (1024 tokens: K3 alone in bf16)
               # under `configs/pixart/w8a8.yaml` on the native backend
               # (K7a -> K7b), each sampler's inference and quant-generate
               "inference iddpm": "bf16",
               "quant-generate sm8 iddpm": "sm8",
               "get-calib-data pixart": ("attention_bnhd",),
               "ptq pixart": ("attention_bnhd",),
               **{f"{cmd} pixart {name}": kernels
                  for name in ("dpms", "sa-solver", "lcm", "edm",
                               "singlestep")
                  for cmd, kernels in (
                      ("inference", ("attention_bnhd",)),
                      ("quant-generate", ("dynamic_quant_rows",
                                          "int8_matmul",
                                          "attention_bnhd")))},
               # phase train: the fp STDiT under autograd, K3's bf16
               # modes at its three sites (the backward is the plain
               # recompute, no kernel)
               "train": ("attention_bnhd",),
               "train resume": ("attention_bnhd",),
               "train grad_accum 2": ("attention_bnhd",),
               # phase data: the VAE runs no port kernel (cuDNN
               # convolutions, where the JAX package runs XLA's)
               "extract-features": (), "train data": ("attention_bnhd",),
               "train data no_vae": ("attention_bnhd",)}
CLI_SAME_REL = 1e-3  # CLI samples against the in-process path
# phase samplers: PixArt-α 512 (`configs/workload/pixart_alpha_512.py`:
# PixArt-XL/2, 28 blocks, C = 1152, 1024 tokens, 120 caption tokens;
# DPM-Solver++ multistep, 20 steps, CFG 4.5) and its W8A8 plan on the native
# backend, calibrated on PIXART_CALIB_SAMPLES samples
PIXART_WORKLOAD = ROOT / "configs/workload/pixart_alpha_512.py"
PIXART_PLAN = ROOT / "configs/pixart/w8a8.yaml"
PIXART_DEPTH = 28
PIXART_CALIB_SAMPLES = 2
# each sampler's model evaluations in its 20 steps (a CFG forward at batch
# 2 each; LCM's the cond prompt's alone): multistep and SA-Solver
# (few_steps, PEC) one a step; EDM's Heun two a step but the last;
# singlestep order 3 one an order (20) and denoise_to_zero's one
SAMPLER_FORWARDS = {"dpms": 20, "sa-solver": 20, "lcm": 20, "edm": 39,
                    "singlestep": 21}
# a sampler's bf16 sample must sit further than this from the DDIM (STDiT)
# or multistep (PixArt-α) one of the same seed: no quiet fallback
SAMPLER_DIFF = 1e-2
# phase recon: AdaRound (`w4a8_adaround.yaml`) through `ptq` at full width,
# its iterations cut from the plan's 2000 a block to RECON_ITERS (a copy of
# the YAML in the phase's temporary directory); layer granularity and the
# MLP pair at full width on RECON_LAYER_DEPTH blocks (JAX's layer
# granularity holds every layer's captured I/O at once: ~1.5 GB a block
# here, ~42 GB at 28)
ADAROUND_PLAN = ROOT / "configs/opensora/w4a8_adaround.yaml"
RECON_ITERS = 2
RECON_LAYER_ITERS = 20
RECON_LAYER_DEPTH = 2
RECON_DEPTH = 28  # STDiT-XL/2's blocks, each reconstructed
# the simulate and the native backend's samples of the same checkpoint:
# the native acts are quantized per row (K7a), the simulate acts per token
# position over the batch (ROADMAP C10), and the W4 weights dequantize in
# bf16 on one and in the int32 epilogue on the other, over 20 steps
RECON_BACKEND_REL = 5e-2


# phase recon_sigma: PixArt-Σ 1024 through the CLI, its workload config a
# copy of the 512 t2i one changed to SIGMA_CFG's values, its AdaRound plan
# `w4a8_adaround.yaml` with `sr` added to the fp list (the KV-compress conv
# quantizes its weight with no alpha: an AdaRound plan that reaches it
# raises, tests/test_torch_recon_sigma.py)
SIGMA_WORKLOAD = ROOT / "configs/workload/pixart_alpha_512.py"
SIGMA_FP_EXTRA = ("sr",)
# launches of the float32 block's attention per iteration, one forward an
# iteration (quant/reconstruction.py `block_reconstruction`): K6's float32
# mode at the self-attention of blocks 0-13 (N = M = 4096), K3's at the
# cross attention of every block (300 prompt tokens, kv-masked); blocks
# 14-27's KV-compressed self-attention runs `sdpa` (layers.py
# `KVCompressSelfAttention`, as the JAX package's runs its stock flash
# kernel), no kernel of the port
SIGMA_RECON_LAUNCHES = {"attention_bnhd_stream_f32": 14,
                        "attention_bnhd_f32": 28}


def sigma_workload(tmp: Path) -> str:
    """A copy of the 512 t2i workload config changed to SIGMA_CFG's values
    (PixArtMS-XL/2 at 1024, 300 caption tokens, conv KV compression x2 on
    blocks 14-27; DPM-Solver++, 20 steps, CFG 4.5) in tmp."""
    src = SIGMA_WORKLOAD.read_text()
    m = SIGMA_CFG["model"]
    for old, new in (
            ("image_size = 512", f"image_size = {SIGMA_CFG['image_size']}"),
            ('type="PixArt-XL/2",\n    model_max_length=120,',
             f'type="{m["type"]}",\n    model_max_length='
             f'{m["model_max_length"]},\n    kv_compress_sampling='
             f'"{m["kv_compress_sampling"]}",\n    kv_compress_scale='
             f'{m["kv_compress_scale"]},\n    kv_compress_layers='
             f'{tuple(m["kv_compress_layers"])},'),
            ('type="t5", model_max_length=120',
             f'type="t5", model_max_length={m["model_max_length"]}')):
        if old not in src:
            fail(f"{SIGMA_WORKLOAD}: no '{old}' to change")
        src = src.replace(old, new)
    path = tmp / "pixart_sigma_1024.py"
    path.write_text(src)
    from viditq_tpu_torch.utils import workload
    cfg = workload.load_py_config(str(path))
    sched = SIGMA_CFG["scheduler"]
    if (cfg["scheduler"]["type"] != sched["type"]
            or cfg["scheduler"]["num_sampling_steps"] != STEPS
            or cfg["scheduler"]["cfg_scale"] != sched["cfg_scale"]
            or cfg["dtype"] != SIGMA_CFG["dtype"]):
        fail(f"{SIGMA_WORKLOAD}: its sampler or dtype is not SIGMA_CFG's")
    return str(path)


def cli_workload(tmp: Path, steps: int, depth=None) -> str:
    """A copy of the 16x512x512 workload config with `steps` sampler steps
    (and the full-width STDiT at `depth` blocks) in tmp."""
    src = CLI_WORKLOAD.read_text()
    want = "num_sampling_steps=100"
    if want not in src:
        fail(f"{CLI_WORKLOAD}: no '{want}' to cut")
    src = src.replace(want, f"num_sampling_steps={steps}")
    name = f"stdit_{steps}steps"
    if depth is not None:
        old = 'type="STDiT-XL/2",'
        if old not in src:
            fail(f"{CLI_WORKLOAD}: no '{old}' to cut")
        src = src.replace(old, f'type="STDiT", depth={depth}, '
                          'hidden_size=1152, num_heads=16, '
                          'patch_size=(1, 2, 2),')
        name += f"_{depth}blocks"
    path = tmp / f"{name}.py"
    path.write_text(src)
    return str(path)


def run_cli(label, argv, counts):
    """One CLI command in this process: seconds, peak memory and the
    launches of its kernels (reset just before, read just after; a kernel
    outside its `CLI_KERNELS` arm or kernel list, or none of one in it,
    fails). Returns what the command returned."""
    import torch
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.kernels import _counters
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counters.reset()
    t0 = time.time()
    out = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    snap = _counters.snapshot()
    launched = {k: v["launches"] for k, v in snap.items() if v["launches"]}
    arm = CLI_KERNELS[label]
    want = (set(STDIT_ARM_KERNELS[arm]) if isinstance(arm, str)
            else set(arm or ()))
    if set(launched) != want:
        fail(f"cli {label}: launched {launched}, want every one of "
             f"{sorted(want)} and no other")
    if any(v["plain_cuda"] for v in snap.values()):
        fail(f"cli {label}: a plain version ran on CUDA tensors")
    for k, n in launched.items():
        counts[k] = counts.get(k, 0) + n
    print(f"  cli {label}: {secs:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
          f"{launched}", flush=True)
    return out, launched


def file_mib(path) -> str:
    return f"{Path(path).stat().st_size / 2 ** 20:.1f} MiB"


def phase_cli():
    """The port's CLI at STDiT-XL/2's full width (module header, phase 7).
    Returns each kernel's launches summed over the commands."""
    import tempfile

    import torch
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.pipelines.inference import quant_sample
    from viditq_tpu_torch.pipelines.mixed_precision import SegmentedMPSampler
    from viditq_tpu_torch.pipelines.ptq import run_ptq
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    from viditq_tpu_torch.utils import ckpt, workload
    from viditq_tpu_torch.utils.config import load_quant_config

    counts = {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="viditq_cli_") as tmpd:
        tmp = Path(tmpd)
        config = cli_workload(tmp, CLI_STEPS)
        cfg = workload.load_py_config(config)
        # 1. a reference-layout .pth of the seeded weights, then split-ckpt
        t0 = time.time()
        model = workload.build_model(cfg, device="cuda")
        workload.random_init_(model, cli.INIT_SEED, cli.INIT_SCALE)
        drawn = {k: p.detach().cpu().clone()
                 for k, p in model.named_parameters()}
        ref = ckpt.reference_state_dict(drawn, ckpt.patch_of(model))
        model = None
        pth, params = tmp / "stdit_xl2.pth", tmp / "params.pt"
        torch.save({"state_dict": ref}, pth)
        t_write = time.time() - t0
        t0 = time.time()
        cli.main(["split-ckpt", "--src", str(pth), "--dst", str(params)])
        t_split = time.time() - t0
        got = ckpt.load_params(str(params))
        if got.keys() != drawn.keys():
            fail(f"cli split-ckpt: keys {sorted(set(got) ^ set(drawn))[:5]}")
        bad = [k for k, v in drawn.items() if not torch.equal(got[k], v)]
        if bad:
            fail(f"cli split-ckpt: {len(bad)} tensors differ, e.g. {bad[:3]}")
        print(f"  cli split-ckpt: reference .pth ({len(ref)} tensors, "
              f"{file_mib(pth)}) drawn and written in {t_write:.1f} s, "
              f"converted in {t_split:.1f} s to {file_mib(params)}; "
              f"{len(drawn)} tensors equal the drawn weights", flush=True)
        del ref, got
        pth.unlink()
        base = ["--config", config, "--ckpt_path", str(params)]
        common = base + ["--num_samples", "1"]
        # 2. fp samples and the calibration trajectory
        out, _ = run_cli("inference", ["inference", "--save_dir",
                                       str(tmp / "fp"), *common], counts)
        fp = torch.from_numpy(np.load(out["out"])["samples"]).float()
        print(f"  cli inference: {out['sample_seconds'] * 1e3 / CLI_STEPS:.1f}"
              f" ms/step, fp_samples.npz {file_mib(out['out'])}", flush=True)
        out, _ = run_cli("get-calib-data", ["get-calib-data", "--save_dir",
                                            str(tmp / "cal"), *common],
                         counts)
        calib = out["out"]
        print(f"  cli get-calib-data: calib_data.npz {file_mib(calib)}",
              flush=True)

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        # 3. sm8: ptq, quant-generate; against the in-process path
        sm8 = ["--ptq_config", str(SM8_PLAN)]
        out, _ = run_cli("ptq sm8", ["ptq", "--save_dir", str(tmp / "sm8"),
                                     "--calib_data", calib, *base, *sm8],
                         counts)
        qck = out["out"]
        out = None
        out, launched = run_cli(
            "quant-generate sm8", ["quant-generate", "--save_dir",
                                   str(tmp / "sm8"), "--quant_ckpt", qck,
                                   *common, *sm8], counts)
        q_sm8 = torch.from_numpy(np.load(out["out"])["samples"]).float()
        ms_sm8 = out["sample_seconds"] * 1e3 / CLI_STEPS
        plan = load_quant_config(str(SM8_PLAN))
        sampler = workload.build_sampler(cfg, cfg_split=plan.cfg_split)
        fwd_a_step = 2 if sampler.cfg_split else 1
        model = workload.build_model(cfg, plan.resolver(), device="cuda")
        want = {k: n * len(model.blocks) * CLI_STEPS * fwd_a_step
                for k, n in BLOCK_LAUNCHES[("stdit", "sm8")].items()}
        if launched != want:
            fail(f"cli quant-generate sm8: launches {launched} != {want}")
        ckpt.load_params_into(model, str(params))
        calibrate_weight_tables(model)
        pack_native_weights(model)
        args = cli.build_parser().parse_args(["quant-generate", *common, *sm8])
        y, mask = cli._load_embeds(args, cfg, 1)
        z = cli.noise((1, 4, *workload.latent_size(cfg)), args.seed, "cuda")
        want_s = quant_sample(model, sampler, z, y, mask).float().cpu()
        model = None
        same = rel(q_sm8, want_s)
        r_sm8 = rel(q_sm8, fp)
        print(f"  cli quant-generate sm8: {ms_sm8:.1f} ms/step ({fwd_a_step} "
              f"forwards a step: the plan's cfg_split), quant_samples.npz "
              f"{file_mib(out['out'])}, quant_ckpt.npz {file_mib(qck)}; "
              f"against the in-process path max |diff| "
              f"{float((q_sm8 - want_s).abs().max()):.3g}, rel {same:.3g} "
              f"(limit {CLI_SAME_REL}); vs inference rel err {r_sm8:.4g} "
              f"(limit {SLICE_REL_ERR})", flush=True)
        if same > CLI_SAME_REL:
            fail(f"cli sm8 samples differ from the in-process path: {same}")
        if not (r_sm8 <= SLICE_REL_ERR):
            fail(f"cli sm8 vs inference relative error {r_sm8}")
        samplers_stdit(tmp, common, sm8, qck, fp, want, counts)
        # 4. naive: static tables from the CLI's own calib data; the file
        # loaded into a fresh model against an in-process run_ptq
        naive = ["--ptq_config", str(NAIVE_PLAN)]
        out, _ = run_cli("ptq naive", ["ptq", "--save_dir",
                                       str(tmp / "naive"), "--calib_data",
                                       calib, *base, *naive], counts)
        qck = out["out"]
        out, _ = run_cli("quant-generate naive",
                         ["quant-generate", "--save_dir", str(tmp / "naive"),
                          "--quant_ckpt", qck, *common, *naive], counts)
        q_naive = torch.from_numpy(np.load(out["out"])["samples"]).float()
        ms_naive = out["sample_seconds"] * 1e3 / CLI_STEPS
        plan = load_quant_config(str(NAIVE_PLAN))

        def naive_model():
            m = workload.build_model(cfg, plan.resolver(), device="cuda")
            return ckpt.load_params_into(m, str(params))
        model = naive_model()
        res = run_ptq(model, cli.load_calib_data(calib, "cuda"), plan)
        loaded = naive_model()
        meta = ckpt.load_quant_ckpt(qck, loaded)
        if not np.array_equal(meta["act_slot_map"], res.act_slot_map):
            fail("cli ptq naive: the act slot map did not round trip")

        def tables(m):
            return {(name, tab): getattr(mod, tab)
                    for name, mod in m.named_modules()
                    if isinstance(mod, QuantLinear)
                    for tab in ckpt.QUANT_TABLES if hasattr(mod, tab)}
        want_t, got_t = tables(model), tables(loaded)
        if want_t.keys() != got_t.keys():
            fail(f"cli ptq naive: loaded tables "
                 f"{sorted(set(want_t) ^ set(got_t))[:5]} differ in name")
        bad = [k for k, v in want_t.items() if not torch.equal(got_t[k], v)]
        if bad:
            fail(f"cli ptq naive: {len(bad)} loaded tables differ from an "
                 f"in-process run_ptq's, e.g. {bad[:3]}")
        loaded = got_t = None
        if plan.uses_native():
            pack_native_weights(model)
        sampler = workload.build_sampler(cfg, cfg_split=plan.cfg_split)
        want_s = quant_sample(model, sampler, z, y, mask,
                              act_slot_map=res.act_slot_map).float().cpu()
        model = None
        same = rel(q_naive, want_s)
        r_naive = rel(q_naive, fp)
        print(f"  cli ptq naive: quant_ckpt.npz {file_mib(qck)}, loaded into "
              f"a fresh model: {len(want_t)} tables equal an in-process "
              f"run_ptq's, slot map of {len(meta['calib_ts'])} calibrated "
              f"timesteps", flush=True)
        print(f"  cli quant-generate naive: {ms_naive:.1f} ms/step; against "
              f"the in-process path max |diff| "
              f"{float((q_naive - want_s).abs().max()):.3g}, rel {same:.3g} "
              f"(limit {CLI_SAME_REL}); vs inference rel err {r_naive:.4g} "
              f"(limit {SLICE_REL_ERR})", flush=True)
        if same > CLI_SAME_REL:
            fail(f"cli naive samples differ from the in-process path: {same}")
        if not (r_naive <= SLICE_REL_ERR):
            fail(f"cli naive vs inference relative error {r_naive}")
        res = want_t = None
        # 5. mixed precision through quant-generate-mp with the t20 configs:
        # ViDiT-Q's W4A8 plan as written (the simulate backend, its
        # cfg_split; weight tables from the parameters), and the naive plan
        # on step 4's checkpoint (its static act tables and slot map); each
        # against the in-process segmented sampler on the same model
        mp = ["--time_mp_config_weight", str(MP_WEIGHT),
              "--time_mp_config_act", str(MP_ACT)]
        for label, plan_path, ckpt_file in (
                ("quant-generate-mp viditq_w4a8", VIDITQ_W4A8_PLAN, None),
                ("quant-generate-mp naive", NAIVE_PLAN, qck)):
            extra = ["--quant_ckpt", ckpt_file] if ckpt_file else []
            out, _ = run_cli(label, ["quant-generate-mp", "--save_dir",
                                     str(tmp / f"mp_{label.split()[-1]}"),
                                     "--ptq_config", str(plan_path), *mp,
                                     *extra, *common], counts)
            got_s = torch.from_numpy(np.load(out["out"])["samples"]).float()
            ms_mp = out["sample_seconds"] * 1e3 / CLI_STEPS
            plan = load_quant_config(str(plan_path))
            model = workload.build_model(cfg, plan.resolver(), device="cuda")
            ckpt.load_params_into(model, str(params))
            slot_map = None
            if ckpt_file:
                slot_map = ckpt.load_quant_ckpt(ckpt_file, model)[
                    "act_slot_map"]
            else:
                calibrate_weight_tables(model)
            sampler = workload.build_sampler(cfg, cfg_split=plan.cfg_split)
            run = mp_sampler(cfg, "cuda", plan, sampler, MP_WEIGHT, MP_ACT,
                             act_slot_map=slot_map)
            if not isinstance(run, SegmentedMPSampler) or run.native_repack:
                fail(f"cli {label}: not the segmented simulate path")
            want_s = run(model, z, y, mask).float().cpu()
            n_ranges = len(run.segments)
            model = run = None
            same, r_mp = rel(got_s, want_s), rel(got_s, fp)
            acts = ("dynamic acts" if slot_map is None else
                    f"static acts, the slot map of "
                    f"{len(set(slot_map.tolist()))} calibrated steps onto "
                    f"{plan.default_layer.act.n_timestep} table slot(s)")
            print(f"  cli {label}: {ms_mp:.1f} ms/step (the segmented path, "
                  f"{n_ranges} ranges, {acts}, cfg_split "
                  f"{sampler.cfg_split}); against the in-process path rel "
                  f"{same:.3g} (limit {CLI_SAME_REL}); vs inference rel err "
                  f"{r_mp:.4g} (limit {SLICE_REL_ERR})", flush=True)
            if same > CLI_SAME_REL:
                fail(f"cli {label} samples differ from the in-process path: "
                     f"{same}")
            if not (r_mp <= SLICE_REL_ERR):
                fail(f"cli {label} vs inference relative error {r_mp}")
        # 6. the analysis commands, depth and steps cut
        cut = cli_workload(tmp, CLI_ANALYSIS_STEPS, CLI_ANALYSIS_DEPTH)
        an = ["--config", cut, "--num_samples", "1", "--ptq_config",
              str(W8A8_PLAN)]
        out, _ = run_cli("get-sensitivity",
                         ["get-sensitivity", "--save_dir", str(tmp / "sens"),
                          "--targets", "attn,mlp", "--backend", "native",
                          *an], counts)
        sc = out["scores"]
        # each score (the mean square of the move from the fp generation)
        # as a relative error against the fp samples' mean square
        out, _ = run_cli("inference (analysis cut)",
                         ["inference", "--save_dir", str(tmp / "fp_cut"),
                          "--config", cut, "--num_samples", "1"], counts)
        ms_fp = float((torch.from_numpy(np.load(out["out"])["samples"])
                       .double() ** 2).mean())
        sens_rel = {k: float(np.sqrt(v / ms_fp)) for k, v in sc.items()}
        print(f"  cli get-sensitivity: scores {sc}, fp mean square "
              f"{ms_fp:.6g}: rel err {sens_rel} (limit {SLICE_REL_ERR})",
              flush=True)
        if set(sc) != {"attn", "mlp"} or not all(
                0 < r <= SLICE_REL_ERR for r in sens_rel.values()):
            fail(f"cli get-sensitivity scores {sc}: rel err {sens_rel}")
        out, _ = run_cli("sweep-alpha", ["sweep-alpha", "--save_dir",
                                         str(tmp / "sweep"), *an], counts)
        best = out["best"]
        if len(best) < 13 * CLI_ANALYSIS_DEPTH or not all(
                0.47 <= a <= 0.9 for a in best.values()):
            fail(f"cli sweep-alpha: {len(best)} layers, {best}")
        out, _ = run_cli("smooth-quant-list",
                         ["smooth-quant-list", "--save_dir",
                          str(tmp / "sq"), *an], counts)
        print(f"  cli analysis ({CLI_ANALYSIS_DEPTH} blocks, "
              f"{CLI_ANALYSIS_STEPS} steps): sensitivity rel err {sens_rel}; "
              f"best alpha of "
              f"{len(best)} layers in [{min(best.values())}, "
              f"{max(best.values())}]; {len(out['picks'])} CB candidates",
              flush=True)
        print(f"phase cli: {time.time() - t_phase:.1f} s", flush=True)
        phase_recon(tmp, config, str(params), calib, fp, counts)
    return counts


def samplers_stdit(tmp: Path, common, sm8, qck, fp, sm8_launches, counts):
    """Phase samplers on STDiT-XL/2 16x512x512 (in phase cli's directory,
    on its weights and sm8 checkpoint, module header, phase 10):
    `inference` and `quant-generate` with `--sampler_type iddpm`, IDDPM's
    ancestral loop over the same 20 steps; the sm8 launches as DDIM's."""
    import torch
    t0 = time.time()
    anc = ["--sampler_type", "iddpm"]
    out, _ = run_cli("inference iddpm", ["inference", "--save_dir",
                                         str(tmp / "fp_iddpm"), *common,
                                         *anc], counts)
    fp_anc = torch.from_numpy(np.load(out["out"])["samples"]).float()
    ms_fp = out["sample_seconds"] * 1e3 / CLI_STEPS
    out, launched = run_cli(
        "quant-generate sm8 iddpm", ["quant-generate", "--save_dir",
                                     str(tmp / "sm8_iddpm"), "--quant_ckpt",
                                     qck, *common, *sm8, *anc], counts)
    q_anc = torch.from_numpy(np.load(out["out"])["samples"]).float()
    ms_q = out["sample_seconds"] * 1e3 / CLI_STEPS
    if launched != sm8_launches:
        fail(f"samplers iddpm sm8: launches {launched} != {sm8_launches}")
    r = float((q_anc - fp_anc).norm() / fp_anc.norm())
    d = float((fp_anc - fp).norm() / fp.norm())
    print(f"phase samplers: STDiT-XL/2 16x512x512 ancestral (iddpm, "
          f"{CLI_STEPS} steps): bf16 {ms_fp:.1f} ms/step, sm8 {ms_q:.1f} "
          f"ms/step; sm8 vs bf16 rel err {r:.4g} (limit {SLICE_REL_ERR}); "
          f"bf16 ancestral vs bf16 DDIM rel {d:.4g} (must exceed "
          f"{SAMPLER_DIFF}); {time.time() - t0:.1f} s", flush=True)
    if not r <= SLICE_REL_ERR:
        fail(f"samplers iddpm sm8 vs bf16 relative error {r}")
    if not d > SAMPLER_DIFF:
        fail(f"samplers iddpm: the ancestral sample is DDIM's ({d})")


def pixart_workloads(tmp: Path):
    """(the PixArt-α 512 config, a copy of it whose DPM-Solver is
    singlestep of order 3 with dynamic thresholding and denoise_to_zero),
    both in tmp."""
    from viditq_tpu_torch.utils import workload
    src = PIXART_WORKLOAD.read_text()
    old = 'type="dpm-solver",'
    if old not in src:
        fail(f"{PIXART_WORKLOAD}: no '{old}' to change")
    cfg = workload.load_py_config(str(PIXART_WORKLOAD))
    if (cfg["scheduler"]["num_sampling_steps"] != CLI_STEPS
            or cfg["model"]["type"] != "PixArt-XL/2"):
        fail(f"{PIXART_WORKLOAD}: not PixArt-XL/2 at {CLI_STEPS} steps")
    single = tmp / "pixart_alpha_512_singlestep.py"
    single.write_text(src.replace(old, old + (
        '\n    method="singlestep",\n    order=3,\n    thresholding=True,'
        '\n    denoise_to_zero=True,')))
    return str(PIXART_WORKLOAD), str(single)


def phase_samplers():
    """Phase samplers on PixArt-α 512 at full width through the CLI, and
    the tiny models card against CPU (module header, phase 10). Returns
    each kernel's launches summed over the commands."""
    import copy
    import tempfile

    import torch
    from viditq_tpu_torch.pipelines.inference import quant_sample
    from viditq_tpu_torch.samplers import (IDDPM, DPMSolverSampler,
                                           EDMSampler, LCMScheduler,
                                           SASolverSampler)
    from viditq_tpu_torch.utils.workload import latent_size

    counts = {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="viditq_samplers_") as tmpd:
        tmp = Path(tmpd)
        config, single = pixart_workloads(tmp)
        out, _ = run_cli("get-calib-data pixart", [
            "get-calib-data", "--save_dir", str(tmp / "cal"), "--config",
            config, "--num_samples", str(PIXART_CALIB_SAMPLES)], counts)
        plan = ["--ptq_config", str(PIXART_PLAN), "--backend", "native"]
        out, _ = run_cli("ptq pixart", [
            "ptq", "--save_dir", str(tmp / "ptq"), "--calib_data",
            out["out"], "--config", config, *plan], counts)
        qck = out["out"]
        multistep = None
        for name, cfg_path, st in (("dpms", config, "dpms"),
                                   ("sa-solver", config, "sa-solver"),
                                   ("lcm", config, "lcm"),
                                   ("edm", config, "edm"),
                                   ("singlestep", single, "dpms")):
            common = ["--config", cfg_path, "--num_samples", "1",
                      "--sampler_type", st]
            runs = {}
            for arm, cmd, extra in (
                    ("bf16", "inference", []),
                    ("w8a8", "quant-generate", ["--quant_ckpt", qck, *plan])):
                out, launched = run_cli(f"{cmd} pixart {name}", [
                    cmd, "--save_dir", str(tmp / f"{arm}_{name}"), *common,
                    *extra], counts)
                want = SAMPLER_FORWARDS[name] * 2 * PIXART_DEPTH
                if launched["attention_bnhd"] != want:
                    fail(f"samplers pixart {name} {arm}: "
                         f"{launched['attention_bnhd']} K3 launches, want "
                         f"{want} ({SAMPLER_FORWARDS[name]} forwards)")
                runs[arm] = (torch.from_numpy(
                    np.load(out["out"])["samples"]).float(),
                    out["sample_seconds"] * 1e3 / out["steps"])
            (fp, ms_fp), (q, ms_q) = runs["bf16"], runs["w8a8"]
            multistep = fp if multistep is None else multistep
            r = float((q - fp).norm() / fp.norm())
            d = float((fp - multistep).norm() / multistep.norm())
            per_fwd = CLI_STEPS / SAMPLER_FORWARDS[name]
            print(f"phase samplers: PixArt-α 512 {name} ({CLI_STEPS} steps, "
                  f"{SAMPLER_FORWARDS[name]} forwards): bf16 {ms_fp:.1f} "
                  f"ms/step ({ms_fp * per_fwd:.1f} ms a forward), w8a8 "
                  f"{ms_q:.1f} ms/step ({ms_q * per_fwd:.1f}); w8a8 vs bf16 "
                  f"rel err {r:.4g} (limit {SLICE_REL_ERR}); bf16 vs "
                  f"multistep rel {d:.4g}"
                  + ("" if name == "dpms" else
                     f" (must exceed {SAMPLER_DIFF})"), flush=True)
            if not r <= SLICE_REL_ERR:
                fail(f"samplers pixart {name}: w8a8 vs bf16 rel err {r}")
            if name != "dpms" and not d > SAMPLER_DIFF:
                fail(f"samplers pixart {name}: the multistep sample ({d})")
    # each new loop shape on the tiny STDiT (sm8), card against CPU; the
    # latent in float32, the draws from one CPU generator for both runs.
    # EDM's last step and denoise_to_zero return the denoiser's CFG mix
    # itself, where the scale multiplies the kernels' rounding (at s = 4:
    # EDM 0.0963, singlestep 0.0264 in an exploratory chip run, the
    # forward 0.00268): those two run unguided, s = 1
    cfg = TINY_STDIT_CFG
    x, t, y, mask = tiny_inputs(cfg)
    cpu = build_model(cfg, "cpu", scale=0.1, plan=SM8_PLAN)
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    check_k_major(models["cuda"])
    for name, sampler, st in (
            ("ancestral (iddpm)", IDDPM(3), "iddpm"),
            ("DPM-Solver singlestep order 3, thresholding, denoise_to_zero"
             ", CFG 1", DPMSolverSampler(3, cfg_scale=1.0,
                                         method="singlestep", order=3,
                                         thresholding=True,
                                         denoise_to_zero=True), "ddim"),
            ("SA-Solver (eta 1)", SASolverSampler(3, eta=1.0), "ddim"),
            ("LCM", LCMScheduler(3), "ddim"),
            ("EDM, CFG 1", EDMSampler(3, cfg_scale=1.0), "ddim")):
        def sample(dev, z, yy, m, _s=sampler, _st=st):
            return quant_sample(models[dev], _s, z.float(), yy, m,
                                sampler_type=_st,
                                generator=torch.Generator().manual_seed(0))
        rels = tiny_pair(x, t, y, mask, cpu, models["cuda"], sample)
        tiny_verdict(f"sm8 STDiT, {name}", latent_size(cfg), 3, *rels)
        if not all(r > 0 for r in rels):
            fail(f"tiny {name}: a card-vs-CPU reading is 0: {rels}")
    print(f"phase samplers: {time.time() - t_phase:.1f} s", flush=True)
    return counts


def adaround_plan_copy(tmp: Path, name: str, fp_extra=(), **change) -> str:
    """A copy of `w4a8_adaround.yaml` in tmp: `iters` and `granularity`
    set in its optimisation section, or `nearest=True`: nearest rounding
    and no optimisation section (the same plan without AdaRound);
    fp_extra: patterns its fp list takes beside remain_fp.txt's (a file in
    tmp)."""
    import yaml
    y = yaml.safe_load(ADAROUND_PLAN.read_text())
    fp = ROOT / "configs/opensora/remain_fp.txt"
    if fp_extra:
        lines = [ln.strip() for ln in fp.read_text().splitlines()
                 if ln.strip()]
        fp = tmp / f"{Path(name).stem}_fp.txt"
        fp.write_text("\n".join(lines + list(fp_extra)) + "\n")
    y["part_fp_list"] = str(fp)
    w = y["quant"]["weight"]
    if change.pop("nearest", False):
        w["optimization"] = None
        w["quantizer"]["round_mode"] = "nearest"
    if w["optimization"] is not None:
        w["optimization"].update(change)
    path = tmp / name
    path.write_text(yaml.safe_dump(y, sort_keys=False))
    return str(path)


def recon_samples(phase: str, tmp: Path, common, plan: str, near: str,
                  qck: str, fp, counts: dict, suffix: str = "") -> None:
    """`quant-generate` from an AdaRound checkpoint on the simulate and the
    native backend and under the same plan with nearest rounding (CLI
    labels "quant-generate adaround", "... adaround native", "...
    nearest", each with suffix): each sample's ms/step and rel err against
    the fp samples and against nearest rounding; the two backends within
    RECON_BACKEND_REL, and the learned rounding reaching both."""
    import torch
    samples = []
    for label, extra in (
            ("adaround", ["--ptq_config", plan, "--quant_ckpt", qck]),
            ("adaround native", ["--ptq_config", plan, "--quant_ckpt", qck,
                                 "--backend", "native"]),
            ("nearest", ["--ptq_config", near])):
        label = f"quant-generate {label}{suffix}"
        out, _ = run_cli(label, ["quant-generate", "--save_dir",
                                 str(tmp / label.replace(" ", "_")),
                                 *common, *extra], counts)
        smp = torch.from_numpy(np.load(out["out"])["samples"]).float()
        if smp.shape != fp.shape or not torch.isfinite(smp).all():
            fail(f"{phase} {label}: samples {tuple(smp.shape)}, finite and "
                 "of the fp samples' shape wanted")
        samples.append(smp)
        print(f"  {phase} {label}: "
              f"{out['sample_seconds'] * 1e3 / out['steps']:.1f} ms/step",
              flush=True)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    sim, nat, nrst = samples
    r_back = rel(nat, sim)
    print(f"  {phase} samples rel err: simulate vs fp {rel(sim, fp):.4g}, "
          f"native vs fp {rel(nat, fp):.4g}, nearest rounding vs fp "
          f"{rel(nrst, fp):.4g}; AdaRound vs nearest rounding: simulate "
          f"{rel(sim, nrst):.4g}, native {rel(nat, nrst):.4g}; native vs "
          f"simulate {r_back:.4g} (limit {RECON_BACKEND_REL})", flush=True)
    if not r_back <= RECON_BACKEND_REL:
        fail(f"{phase}: the native and simulate samples of the AdaRound "
             f"checkpoint differ by {r_back}")
    if not (rel(sim, nrst) > 0 and rel(nat, nrst) > 0):
        fail(f"{phase}: the learned rounding did not reach the samples")


def phase_recon(tmp: Path, config: str, params: str, calib: str, fp,
                counts: dict):
    """AdaRound through the port's CLI at STDiT-XL/2's full width (module
    header, phase 8), in phase cli's directory, on its weights, its
    calib_data.npz and its fp samples: `ptq` under `w4a8_adaround.yaml`
    (block granularity, asym, RECON_ITERS iterations a block), then
    `quant-generate` from its checkpoint on the simulate and the native
    backend, and the same plan with nearest rounding; layer granularity
    and `mlp_block_reconstruction` on RECON_LAYER_DEPTH blocks. Adds each
    command's launches to counts."""
    import torch
    from viditq_tpu_torch.quant import reconstruction as recon
    from viditq_tpu_torch.utils import workload
    from viditq_tpu_torch.utils.config import load_quant_config

    t_phase = time.time()
    plan = adaround_plan_copy(tmp, "w4a8_adaround_cut.yaml",
                              iters=RECON_ITERS)
    near = adaround_plan_copy(tmp, "w4a8_nearest.yaml", nearest=True)
    base = ["--config", config, "--ckpt_path", params]
    out, launched = run_cli("ptq adaround",
                            ["ptq", "--save_dir", str(tmp / "ada"),
                             "--calib_data", calib, "--ptq_config", plan,
                             *base], counts)
    qck, tim = out["out"], out["recon_timings"]
    block_s, capture_s = tim["block_s"], tim["capture_s"]
    n_blocks = len(block_s)
    if n_blocks != RECON_DEPTH or len(capture_s) != RECON_DEPTH:
        fail(f"recon: {n_blocks} blocks reconstructed, {len(capture_s)} "
             f"captures, want {RECON_DEPTH} each")
    ms_iter = [1e3 * b / RECON_ITERS for b in block_s]
    full_iters = load_quant_config(str(ADAROUND_PLAN)).weight_opt.iters
    med = float(np.median(ms_iter))
    est_h = (full_iters * med / 1e3 * RECON_DEPTH + sum(capture_s)) / 3600
    n_f32 = launched["attention_bnhd_f32"]
    cap_ms = float(np.median(capture_s)) * 1e3
    print(f"  recon: {RECON_ITERS} iterations x {RECON_DEPTH} blocks (the "
          f"f32 block's forward + backward on the 2 CFG rows): ms per "
          f"iteration per block median {med:.1f}, min {min(ms_iter):.1f}, "
          f"max {max(ms_iter):.1f} (block 0 {ms_iter[0]:.1f}); the "
          f"{RECON_DEPTH} asym re-capture forwards {sum(capture_s):.2f} s "
          f"({cap_ms:.0f} ms each); the whole reconstruction "
          f"{out['recon_seconds']:.1f} s; K3 float32 launches {n_f32} "
          f"({n_f32 // (RECON_DEPTH * RECON_ITERS)} a block forward); the "
          f"plan's {full_iters} iterations x {RECON_DEPTH} blocks "
          f"extrapolate to {est_h:.2f} h on this card", flush=True)
    if launched["attention_bnhd_f32"] != 3 * RECON_DEPTH * RECON_ITERS:
        fail(f"recon: {launched['attention_bnhd_f32']} float32 K3 launches, "
             f"want 3 sites x {RECON_DEPTH} blocks x {RECON_ITERS} "
             "iterations")
    recon_samples("recon", tmp, base + ["--num_samples", "1"], plan, near,
                  qck, fp, counts)
    # layer granularity and the MLP pair, the depth cut
    cut = cli_workload(tmp, CLI_STEPS, RECON_LAYER_DEPTH)
    lplan = adaround_plan_copy(tmp, "w4a8_adaround_layer.yaml",
                               iters=RECON_LAYER_ITERS, granularity="layer")
    out, _ = run_cli("ptq adaround layer",
                     ["ptq", "--save_dir", str(tmp / "ada_layer"),
                      "--calib_data", calib, "--ptq_config", lplan,
                      "--config", cut], counts)
    print(f"  recon layer granularity ({RECON_LAYER_DEPTH} blocks, "
          f"{RECON_LAYER_ITERS} iterations a layer): "
          f"{out['recon_seconds']:.1f} s", flush=True)
    qplan = load_quant_config(lplan)
    model = workload.build_model(workload.load_py_config(cut),
                                 qplan.resolver(), device="cuda")
    workload.random_init_(model, 0, 0.02)
    from viditq_tpu_torch.cli import load_calib_data
    cal = load_calib_data(calib, "cuda")
    io = recon.capture_layer_io(model, (cal["xs"][0], cal["ts"][0].float(),
                                        cal["y"], cal["mask"]))
    mlp = model.blocks[0].mlp
    x1, y2 = io["blocks.0.mlp.fc1"][0], io["blocks.0.mlp.fc2"][1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = recon.mlp_block_reconstruction(
        mlp.fc1.kernel, mlp.fc1.bias, mlp.fc2.kernel, mlp.fc2.bias, x1, y2,
        mlp.fc1.lspec, recon.ReconConfig(
            iters=RECON_LAYER_ITERS, batch_size=qplan.calib_batch_size,
            lr_alpha=qplan.weight_opt.alpha_lr,
            lambda_coeff=qplan.weight_opt.lambda_coeff,
            warmup=qplan.weight_opt.warmup))
    torch.cuda.synchronize()
    losses = res["recon_losses"]
    if not torch.isfinite(losses).all() or not all(
            torch.isfinite(res[n]["w_alpha"]).all() for n in ("fc1", "fc2")):
        fail("recon: mlp_block_reconstruction gave non-finite values")
    print(f"  recon mlp_block_reconstruction (block 0 fc1 -> fc2, "
          f"{x1.shape[0] * x1.shape[1]} captured rows, "
          f"{RECON_LAYER_ITERS} iterations): {time.time() - t0:.2f} s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"loss {float(losses[0]):.4g} -> {float(losses[-1]):.4g}",
          flush=True)
    del model, io, res, cal
    print(f"phase recon: {time.time() - t_phase:.1f} s", flush=True)


def phase_recon_sigma() -> dict:
    """AdaRound through the port's CLI on PixArt-Σ 1024 at full depth and
    width (module header, phase 9), in a temporary directory: the Σ slice's
    weights (normal x 0.02, seed 0) in a `--ckpt_path` file; `inference`
    (the fp samples) and `get-calib-data`; `ptq` under a copy of
    `w4a8_adaround.yaml` with `sr` fp-listed and RECON_ITERS iterations a
    block (block granularity, asym, the 2 CFG rows of one sample), its
    float32 blocks' attention launches held to SIGMA_RECON_LAUNCHES
    exactly; `quant-generate` from its checkpoint on the simulate and the
    native backend, and the plan with nearest rounding. Returns each
    kernel's launches summed over the commands."""
    import tempfile

    import torch
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.utils import ckpt, workload
    from viditq_tpu_torch.utils.config import load_quant_config

    counts = {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="viditq_recon_sigma_") as tmpd:
        tmp = Path(tmpd)
        config = sigma_workload(tmp)
        cfg = workload.load_py_config(config)
        model = workload.build_model(cfg, device="cuda")
        workload.random_init_(model, 0, 0.02)
        params = tmp / "sigma_params.pt"
        ckpt.save_params(str(params), dict(model.named_parameters()))
        depth = len(model.blocks)
        stream = sum(not b.kv_compress for b in model.blocks)
        model = None
        if (stream, depth) != (
                SIGMA_RECON_LAUNCHES["attention_bnhd_stream_f32"],
                SIGMA_RECON_LAUNCHES["attention_bnhd_f32"]) or (
                    depth != RECON_DEPTH):
            fail(f"recon_sigma: {depth} blocks, {stream} without KV "
                 f"compression; want {SIGMA_RECON_LAUNCHES}")
        base = ["--config", config, "--ckpt_path", str(params)]
        common = base + ["--num_samples", "1"]
        out, _ = run_cli("inference sigma", ["inference", "--save_dir",
                                             str(tmp / "fp"), *common],
                         counts)
        fp = torch.from_numpy(np.load(out["out"])["samples"]).float()
        print(f"  recon_sigma inference: "
              f"{out['sample_seconds'] * 1e3 / STEPS:.1f} ms/step", flush=True)
        out, _ = run_cli("get-calib-data sigma",
                         ["get-calib-data", "--save_dir", str(tmp / "cal"),
                          *common], counts)
        calib = out["out"]
        plan = adaround_plan_copy(tmp, "sigma_adaround_cut.yaml",
                                  fp_extra=SIGMA_FP_EXTRA, iters=RECON_ITERS)
        near = adaround_plan_copy(tmp, "sigma_nearest.yaml",
                                  fp_extra=SIGMA_FP_EXTRA, nearest=True)
        out, launched = run_cli("ptq adaround sigma",
                                ["ptq", "--save_dir", str(tmp / "ada"),
                                 "--calib_data", calib, "--ptq_config", plan,
                                 *base], counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        qck, tim = out["out"], out["recon_timings"]
        block_s, capture_s = tim["block_s"], tim["capture_s"]
        if len(block_s) != RECON_DEPTH or len(capture_s) != RECON_DEPTH:
            fail(f"recon_sigma: {len(block_s)} blocks reconstructed, "
                 f"{len(capture_s)} captures, want {RECON_DEPTH} each")
        want = {k: n * RECON_ITERS for k, n in SIGMA_RECON_LAUNCHES.items()}
        got = {k: launched.get(k, 0) for k in want}
        if got != want:
            fail(f"recon_sigma: float32 attention launches {got}, want "
                 f"{want}")
        ms_iter = [1e3 * b / RECON_ITERS for b in block_s]
        full_iters = load_quant_config(str(ADAROUND_PLAN)).weight_opt.iters
        est_h = (full_iters * sum(ms_iter) / 1e3 + sum(capture_s)) / 3600
        print(f"  recon_sigma: {RECON_ITERS} iterations x {RECON_DEPTH} "
              f"blocks (the f32 block's forward + backward on the 2 CFG "
              f"rows): ms per iteration per block median "
              f"{float(np.median(ms_iter)):.1f} (blocks 0-{stream - 1}, K6 "
              f"float32: {float(np.median(ms_iter[:stream])):.1f}; blocks "
              f"{stream}-{depth - 1}, KV compressed: "
              f"{float(np.median(ms_iter[stream:])):.1f}; block 0 "
              f"{ms_iter[0]:.1f}); the {RECON_DEPTH} asym re-capture "
              f"forwards {sum(capture_s):.2f} s "
              f"({float(np.median(capture_s)) * 1e3:.0f} ms each); the whole "
              f"reconstruction {out['recon_seconds']:.1f} s; peak memory "
              f"{peak:.2f} GiB; float32 launches {got} (exactly "
              f"{SIGMA_RECON_LAUNCHES} x {RECON_ITERS}); the plan's "
              f"{full_iters} iterations x {RECON_DEPTH} blocks extrapolate "
              f"to {est_h:.2f} h on this card", flush=True)
        recon_samples("recon_sigma", tmp, common, plan, near, qck, fp,
                      counts, suffix=" sigma")
    print(f"phase recon_sigma: {time.time() - t_phase:.1f} s", flush=True)
    return counts


# phase train: the `train` command at full width on STDiT-XL/2 16x512x512
# with gradient checkpointing (a copy of the CLI's workload config with
# model grad_checkpoint=True), synthetic batches of 2 (x 2 under
# --grad_accum 2); K3 runs at each block's three sites in the forward and
# again in the recompute: 28 x 3 x 2 launches a micro-step
TRAIN_STEPS = 4
TRAIN_CKPT_EVERY = 2
TRAIN_K3_PER_MICRO_STEP = 168
TRAIN_FIXED_STEPS, TRAIN_FIXED_LR = 6, 1e-4
QAT_STEPS = 2
# JAX's QAT test spec (tests/test_parallel.py:77-122): W8 per-channel and
# A8 dynamic per-token, both rounding 'nearest_ste', five layers fp (the
# shipped w8a8_dynamic.yaml rounds weights 'nearest', whose gradient is 0)
QAT_FP = ("x_embedder", "t_block", "t_embedder", "y_embedder",
          "final_layer")


def train_workload(tmp: Path) -> str:
    """A copy of the 16x512x512 workload config with the model's
    grad_checkpoint on, in tmp."""
    src = CLI_WORKLOAD.read_text()
    old = 'type="STDiT-XL/2",'
    if old not in src:
        fail(f"{CLI_WORKLOAD}: no '{old}' to change")
    path = tmp / "stdit_train.py"
    path.write_text(src.replace(old, old + " grad_checkpoint=True,"))
    return str(path)


def qat_resolver():
    from viditq_tpu_torch.quant.naming import resolve_layer_spec
    from viditq_tpu_torch.quant.spec import LayerQuantSpec, QuantSpec
    spec = LayerQuantSpec(
        weight=QuantSpec(n_bits=8, granularity="channel", channel_axis=-1,
                         round_mode="nearest_ste"),
        act=QuantSpec(n_bits=8, granularity="token",
                      round_mode="nearest_ste", dynamic=True))
    return lambda name: resolve_layer_spec(name, spec, QAT_FP)


def train_report(label, out, launched, micro_steps):
    """A train command's readings; its K3 launches held to
    TRAIN_K3_PER_MICRO_STEP a micro-step exactly."""
    import torch
    want = {"attention_bnhd": TRAIN_K3_PER_MICRO_STEP * micro_steps}
    losses = out["losses"]
    ms = out["ms_per_step"]
    print(f"  train {label}: {len(losses)} steps in {out['seconds']:.2f} s, "
          f"ms per step after the first "
          f"{'n/a' if ms is None else f'{ms:.1f}'}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, losses "
          f"{[round(v, 5) for v in losses]}, launches {launched} (want "
          f"{want})", flush=True)
    if launched != want:
        fail(f"train {label}: launches {launched}, want {want}")
    if not np.isfinite(losses).all():
        fail(f"train {label}: losses {losses}")


def in_process_steps(label, model, step_fn, batch, n, counts):
    """n steps of step_fn(ema, opt_state, batch) on one batch, the launches
    counted (reset just before, read just after) and held to
    TRAIN_K3_PER_MICRO_STEP a step; returns the losses."""
    import torch
    from viditq_tpu_torch.kernels import _counters
    from viditq_tpu_torch.parallel import training as tr
    params = tr.trainable(model)
    opt = tr.make_optimizer(lr=TRAIN_FIXED_LR)
    state, ema = opt.init(params), tr.init_ema(params)
    step = step_fn(opt)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _counters.reset()
    t0 = time.time()
    losses = [step(ema, state, batch) for _ in range(n)]
    torch.cuda.synchronize()
    secs = time.time() - t0
    snap = _counters.snapshot()
    launched = {k: v["launches"] for k, v in snap.items() if v["launches"]}
    want = {"attention_bnhd": TRAIN_K3_PER_MICRO_STEP * n}
    losses = [float(v) for v in losses]
    print(f"  train {label}: {n} steps in {secs:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, losses "
          f"{[round(v, 5) for v in losses]}, launches {launched}",
          flush=True)
    if launched != want or any(v["plain_cuda"] for v in snap.values()):
        fail(f"train {label}: launches {launched}, want {want}")
    if not np.isfinite(losses).all():
        fail(f"train {label}: losses {losses}")
    for k, v in launched.items():
        counts[k] = counts.get(k, 0) + v
    return losses


def phase_train() -> dict:
    """Training at full width (module header, phase 11): through the CLI,
    `train` TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY and
    clipping at 1.0, the same resumed from its step-2 checkpoint (every
    parameter and the EMA equal to the uninterrupted run's, bitwise), one
    `--grad_accum 2` step; in process, TRAIN_FIXED_STEPS steps at lr 1e-4
    on one batch and one noise draw (the loss falls: the gradients train)
    and QAT_STEPS QAT steps under JAX's QAT spec (finite losses, the
    fake-quantized weights move). Returns each kernel's launches."""
    import tempfile

    import torch
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.pipelines.train import synthetic_batch
    from viditq_tpu_torch.quant import core
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
    from viditq_tpu_torch.utils import workload

    counts = {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="viditq_train_") as tmpd:
        tmp = Path(tmpd)
        config = train_workload(tmp)
        common = ["--config", config, "--grad_clip", "1.0"]
        full, launched = run_cli("train", [
            "train", "--num_steps", str(TRAIN_STEPS), "--ckpt_every",
            str(TRAIN_CKPT_EVERY), "--save_dir", str(tmp / "a"), *common],
            counts)
        train_report("4 steps, a checkpoint every 2", full, launched,
                     TRAIN_STEPS)
        ckpt2 = tmp / "a" / f"train_state_{TRAIN_CKPT_EVERY}.pt"
        print(f"  train checkpoint {ckpt2.name}: {file_mib(ckpt2)}",
              flush=True)
        res, launched = run_cli("train resume", [
            "train", "--num_steps", str(TRAIN_STEPS), "--resume_from",
            str(ckpt2), "--save_dir", str(tmp / "b"), *common], counts)
        train_report("resumed at step 2", res, launched,
                     TRAIN_STEPS - TRAIN_CKPT_EVERY)
        diffs = {k: max(float((v.detach() - res[k][n].detach()).abs().max())
                        for n, v in full[k].items())
                 for k in ("params", "ema")}
        same = all(torch.equal(v, res[k][n]) for k in ("params", "ema")
                   for n, v in full[k].items())
        print(f"  train resume against the uninterrupted run: every "
              f"parameter and EMA tensor equal: {same} (max |diff| "
              f"{diffs}); losses {res['losses']} against "
              f"{full['losses'][TRAIN_CKPT_EVERY:]}", flush=True)
        if not same or res["losses"] != full["losses"][TRAIN_CKPT_EVERY:]:
            fail("train: the resumed run differs from the uninterrupted one")
        full = res = None
        acc, launched = run_cli("train grad_accum 2", [
            "train", "--num_steps", "1", "--grad_accum", "2", "--save_dir",
            str(tmp / "c"), *common], counts)
        train_report("--grad_accum 2, one step", acc, launched, 2)
        acc = None
        torch.cuda.empty_cache()
        # in process: one batch and one noise draw, repeated
        cfg = workload.load_py_config(config)
        sched = make_schedule(timestep_respacing=[1000])
        latent = (4, *workload.latent_size(cfg))
        cap = (1, cfg["model"].get("model_max_length", 120),
               cfg["model"].get("caption_channels", 4096))
        batch = synthetic_batch(0, 0, 2, latent, cap, sched.n_steps, "cuda")
        noise = torch.randn((2, *latent), generator=torch.Generator(
            "cuda").manual_seed(1), device="cuda")
        model = workload.build_model(cfg, device="cuda")
        workload.jax_init_(model, 0)  # the train command's draw (C20)
        fp_losses = in_process_steps(
            f"one batch, lr {TRAIN_FIXED_LR}", model,
            lambda opt: tr.make_train_step(
                model, sched, opt, noise_fn=lambda shape, i: noise),
            batch, TRAIN_FIXED_STEPS, counts)
        if not fp_losses[-1] < fp_losses[0]:
            fail(f"train: the loss on one batch does not fall: {fp_losses}")
        model = workload.build_model(cfg, qat_resolver(), device="cuda")
        workload.jax_init_(model, 0)
        calibrate_weight_tables(model)
        fc1 = model.blocks[0].mlp.fc1
        spec = fc1.lspec.weight

        def fake_w():
            return core.fake_quant(fc1.kernel.detach().float(),
                                   fc1.w_delta[spec.bit_idx, 0],
                                   fc1.w_zp[spec.bit_idx, 0], spec)
        w0 = fake_w()
        qat_losses = in_process_steps(
            "QAT (W8A8 nearest_ste, simulate)", model,
            lambda opt: tr.make_qat_step(
                model, sched, opt, QuantCtx(mode="quant", t_id=500),
                noise_fn=lambda shape, i: noise),
            batch, QAT_STEPS, counts)
        moved = float((fake_w() != w0).float().mean())
        print(f"  train QAT: blocks.0.mlp.fc1's fake-quantized weights "
              f"moved: {moved:.4%} of them; the first loss {qat_losses[0]!r} "
              f"against the fp model's {fp_losses[0]!r} on the same weights",
              flush=True)
        if moved == 0 or qat_losses[0] == fp_losses[0]:
            fail("train QAT: the fake quantizers or the weights did not "
                 "move")
        model = None
    print(f"phase train: {time.time() - t_phase:.1f} s", flush=True)
    return counts


# ---------------- phase parallel ----------------

PAR_WORLD = 2              # ranks sharing the one card over gloo
PAR_TIMEOUT_S = 900        # the parent's wait for the ranks
PAR_REL_ERR = 1e-2         # an arm against its one-process reference
# ring attention (float32 softmax, JAX's jnp) against Ulysses (K3: q and k
# rounded to bf16) in a bf16 model: the bf16 noise floor of TINY_REL_ERR
PAR_RING_REL = 3e-2
PAR_LOSS_REL = 1e-3
# one AdamW step (lr 1e-4): the update against the one-process step's, in
# norm and direction. The first update is ~lr * sign(g) an element, so a
# gradient within bf16 noise of 0 (tp sums two bf16 partial products of a
# row-parallel layer) flips its element's step: 0.1 in norm is ~0.25% of
# the elements flipped (the CPU rehearsal's tiny bf16 model: 0.064, cosine
# 0.998)
PAR_UPDATE_REL, PAR_UPDATE_COS = 1e-1, 0.99
# the train arms clip at a norm no step reaches: the norm is still taken
# over the mesh, and the first moments, (1 - b1) times the gradient, keep
# its scale (a clipped gradient's is 1 - b1 whatever its scale)
PAR_CLIP = 1e6
# the first moments against the one-process step's: the whole in norm,
# and each tensor's norm (those above PAR_MU_FLOOR of the largest) within
# PAR_MU_REL of its reference's, so a gradient summed twice over tp or
# not averaged over dp (a factor 2) fails
PAR_MU_REL, PAR_MU_FLOOR = 5e-2, 1e-3
PAR_N_MB = 2               # pipeline microbatches (batch 2: one a stage)
# the train arms' blocks (dp, tp, NCCL), at full width: under tp every
# row-parallel output and every column-parallel input gradient is a
# host-staged all-reduce of a [2, 16384, 1152] activation (16 a block a
# step under checkpointing; 72.6 s at 28 blocks on an H100 80GB HBM3 at
# 700 W), and the whole script nears its time limit at 28 (1038 s), so
# they run a seventh of the stack (half until phase data came: 1071.7 s
# at 14 with it, dp 28.5 s and tp 49.4 s a step there; a quarter until
# the wide-head slices came: 1073 s at 7 with them on a slow host, dp
# 19.8 s and tp 23.2 s a step there); each one-process reference the same
# depth
PAR_TRAIN_DEPTH = 4
# the sp arms' blocks at full width: each Ulysses attention moves ~230 MB
# a rank through the host (its all-to-alls and the output's all-gather:
# ~0.55 s each, 31 s a 28-block forward on an H100 80GB HBM3 at 700 W),
# so they run a seventh of the stack (a quarter until the wide-head
# slices came); each rank's K3 launches a forward are its spatial and
# temporal attention at 8 of the 16 heads and its cross attention at 16
PAR_SP_DEPTH = 4


def caption_shape(cfg) -> tuple:
    m = cfg["model"]
    return (1, m.get("model_max_length", 120),
            m.get("caption_channels", 4096))


def par_inputs(cfg, scale: float):
    """(x, t, y, mask) of one batch-2 CFG forward on the card, seed 0: x
    the workload's latent x scale, t 500, y x 0.1, an all-ones mask."""
    import torch
    from viditq_tpu_torch.utils.workload import latent_size
    rng = np.random.default_rng(0)
    _, n_prompt, cap = caption_shape(cfg)
    x = torch.tensor(rng.standard_normal((2, 4, *latent_size(cfg))) * scale,
                     dtype=torch.bfloat16, device="cuda")
    y = torch.tensor(rng.standard_normal((2, 1, n_prompt, cap)) * 0.1,
                     dtype=torch.bfloat16, device="cuda")
    t = torch.full((2,), 500.0, device="cuda")
    mask = torch.ones((2, n_prompt), dtype=torch.int32, device="cuda")
    return x, t, y, mask


@contextlib.contextmanager
def whole_attention():
    """The sp branch computed in one process: Ulysses' and ring's
    attention as `attention_bnhd` over all heads (K3 bf16), no
    collectives."""
    from viditq_tpu_torch.kernels.attention import attention_bnhd
    from viditq_tpu_torch.parallel import ring, ulysses

    def local(q, k, v, mesh, scale=None):
        return attention_bnhd(q, k, v, scale=scale)
    saved = ulysses.ulysses_attention, ring.ring_attention
    ulysses.ulysses_attention = ring.ring_attention = local
    try:
        yield
    finally:
        ulysses.ulysses_attention, ring.ring_attention = saved


@contextlib.contextmanager
def ulysses_heads(seen: dict):
    """Counts Ulysses' local attention calls by their head count."""
    from viditq_tpu_torch.parallel import ulysses
    real = ulysses.attention_bnhd

    def spy(q, k, v, **kw):
        seen[q.shape[2]] = seen.get(q.shape[2], 0) + 1
        return real(q, k, v, **kw)
    ulysses.attention_bnhd = spy
    try:
        yield
    finally:
        ulysses.attention_bnhd = real


def _par_compare(label, got, want, tol, report):
    import torch
    g, w = got.float(), want.float()
    rel = float((g - w).norm() / w.norm())
    err = float((g - w).abs().max())
    report["lines"].append(f"  parallel {label}: max |diff| {err!r}, rel "
                           f"err {rel!r} (limit {tol})")
    if not (torch.isfinite(g).all() and rel <= tol):
        raise RuntimeError(f"parallel {label}: rel err {rel} > {tol}")
    return rel


SP_SM8_KERNELS = ("int8_consumer_matmul", "attention_bnhd",
                  "quantize_rows", "fused_dynq_int8_matmul")


def _par_run(label, fn, report, counts, kernels):
    """fn() on every rank between barriers, its launches counted (reset
    just before, read just after) and held to exactly `kernels`, and its
    seconds, on this rank."""
    import torch
    import torch.distributed as dist
    from viditq_tpu_torch.kernels import _counters
    dist.barrier()
    torch.cuda.synchronize()
    _counters.reset()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    secs = time.time() - t0
    snap = _counters.snapshot()
    launched = {k: v["launches"] for k, v in snap.items() if v["launches"]}
    if any(v["plain_cuda"] for v in snap.values()):
        raise RuntimeError(f"parallel {label}: a plain version ran on CUDA")
    if set(launched) != set(kernels):
        raise RuntimeError(f"parallel {label}: launches {launched}, want "
                           f"each of {kernels} and no other")
    for k, v in launched.items():
        counts[k] = counts.get(k, 0) + v
    report["lines"].append(f"  parallel {label}: {secs:.2f} s on rank 0 "
                           f"(two ranks share the card over gloo: not a "
                           f"scaling number), launches {launched}")
    dist.barrier()
    return out, launched


def _par_sp(report, counts):
    """Ulysses (bf16, sm8) and ring (bf16) at sp = 2 on STDiT-XL/2."""
    import torch
    import torch.distributed as dist
    from viditq_tpu_torch.parallel.mesh import make_mesh
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    lead = dist.get_rank() == 0
    mesh = make_mesh(sp=PAR_WORLD)
    cfg = xl_cfg(PAR_SP_DEPTH)
    x, t, y, mask = par_inputs(cfg, 0.5)
    ulysses_bf16 = None
    for mode in ("ulysses", "ring"):
        model = build_model(cfg, "cuda", model_kw=(
            ("sp_mesh", mesh), ("sp_mode", mode if mode == "ring"
                                else "auto")))
        arms = (("bf16", None), ("sm8", QuantCtx(mode="quant", t_id=500)))
        for arm, qctx in arms if mode == "ulysses" else arms[:1]:
            with torch.no_grad():
                ref = None
                if lead and mode == "ulysses":
                    with whole_attention():
                        ref = model(x, t, y, mask, qctx)
                seen = {}
                with ulysses_heads(seen):
                    got, launched = _par_run(
                        f"sp {mode} {arm}, {PAR_SP_DEPTH} blocks",
                        lambda: model(x, t, y, mask, qctx),
                        report, counts, SP_SM8_KERNELS if qctx is not None
                        else ("attention_bnhd",))
            want8 = 2 * PAR_SP_DEPTH if mode == "ulysses" else 0
            k3 = 3 * PAR_SP_DEPTH if mode == "ulysses" else PAR_SP_DEPTH
            report["lines"].append(
                f"  parallel sp {mode} {arm}: Ulysses' attention calls by "
                f"head count {seen} (want {{8: {want8}}}), K3 "
                f"{launched.get('attention_bnhd', 0)} (want {k3})")
            if seen.get(8, 0) != want8 or launched.get(
                    "attention_bnhd", 0) != k3:
                raise RuntimeError(f"sp {mode} {arm}: K3 launches")
            if lead and mode == "ulysses":
                _par_compare(f"sp ulysses {arm} against one process (the "
                             f"same linears, K3 over 16 heads)", got, ref,
                             PAR_REL_ERR, report)
            if lead and arm == "bf16":
                if mode == "ulysses":
                    ulysses_bf16 = got
                else:
                    _par_compare("sp ring bf16 against sp ulysses bf16", got,
                                 ulysses_bf16, PAR_RING_REL, report)
        model = None
        torch.cuda.empty_cache()


def _par_pp(report, counts):
    """pp = 2: STDiT-XL/2 bf16 and sm8, PixArt-α 512 bf16."""
    import torch
    import torch.distributed as dist
    from viditq_tpu_torch.parallel.mesh import make_mesh
    from viditq_tpu_torch.parallel.pipeline import PipelinedModel
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    from viditq_tpu_torch.utils import workload
    lead = dist.get_rank() == 0
    mesh = make_mesh(pp=PAR_WORLD)
    for kind, cfg, scale in (
            ("stdit", STDIT_CFG, 0.5),
            ("pixart", workload.load_py_config(str(PIXART_WORKLOAD)), 1.0)):
        model = build_model(cfg, "cuda")
        x, t, y, mask = par_inputs(cfg, scale)
        arms = [("bf16", None)]
        if kind == "stdit":
            arms.append(("sm8", QuantCtx(mode="quant", t_id=500)))
        for arm, qctx in arms:
            with torch.no_grad():
                ref = model(x, t, y, mask, qctx) if lead else None
                pm = PipelinedModel(model, mesh, PAR_N_MB)
                got, _ = _par_run(f"pp {kind} {arm}",
                                  lambda: pm(x, t, y, mask, qctx), report,
                                  counts, FUSED_KERNELS if qctx is not None
                                  else ("attention_bnhd",))
            if lead:
                _par_compare(f"pp {kind} {arm} ({PAR_N_MB} microbatches) "
                             f"against one process at stage 'all'", got,
                             ref, PAR_REL_ERR, report)
        model = None
        torch.cuda.empty_cache()


def _update_agreement(got, want, init):
    """(relative distance, cosine) of two parameter updates."""
    import torch
    dot = nw = ng = dd = 0.0
    for n, w0 in init.items():
        a = (got[n].double() - w0.double())
        b = (want[n].double() - w0.double())
        dot += float((a * b).sum())
        ng += float((a * a).sum())
        nw += float((b * b).sum())
        dd += float(((a - b) ** 2).sum())
    return (dd / nw) ** 0.5, dot / (ng * nw) ** 0.5


def xl_cfg(depth, **model_kw) -> dict:
    """STDIT_CFG with model_kw in its model dict, cut to `depth` blocks of
    STDiT-XL/2's width."""
    model = {**STDIT_CFG["model"], **model_kw}
    model.update(type="STDiT", depth=depth, hidden_size=1152, num_heads=16,
                 patch_size=(1, 2, 2))
    return {**STDIT_CFG, "model": model}


def _train_once(mesh, tmp, depth):
    """One train_loop step of STDiT-XL/2 16x512x512 (`xl_cfg(depth)`, with
    gradient checkpointing) on synthetic batch 2 from JAX's initialisers
    (seed 0), clipped at PAR_CLIP: (loss, whole parameters on the host,
    initial ones, whole first moments on the host)."""
    from viditq_tpu_torch.parallel.training import gather_state, trainable
    from viditq_tpu_torch.pipelines.train import train_loop
    from viditq_tpu_torch.utils import workload
    cfg = xl_cfg(depth, grad_checkpoint=True)
    model = workload.jax_init_(workload.build_model(cfg, device="cuda"), 0)
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in trainable(model).items()}
    out = train_loop(model, None, latent_shape=(4, *workload.latent_size(
        cfg)), caption_shape=caption_shape(cfg), num_steps=1,
        lr=TRAIN_FIXED_LR, grad_clip=PAR_CLIP, save_dir=str(tmp),
        log_every=0, mesh=mesh)
    params, st = out["params"], out["opt_state"]
    if mesh is not None:  # the tp shards and ZeRO slices joined (of
        # the first moments alone: each tensor crosses the host)
        params, _, st = gather_state(params, {}, {
            "count": st["count"], "mu": st["mu"], "nu": {}}, mesh)
    return (float(out["step_losses"][0]),
            {n: p.detach().cpu() for n, p in params.items()}, init,
            {n: m.cpu() for n, m in st["mu"].items()})


def _moment_agreement(got, want):
    """(relative distance of the whole first moments, the worst |norm /
    reference norm - 1| of a tensor above PAR_MU_FLOOR of the largest)."""
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    top = max(norms.values())
    dd = sum(float((got[n].double() - w.double()).square().sum())
             for n, w in want.items())
    worst = max(abs(float(got[n].double().norm()) / v - 1)
                for n, v in norms.items() if v > PAR_MU_FLOOR * top)
    return (dd / sum(v * v for v in norms.values())) ** 0.5, worst


def _par_train(report, counts, tmp):
    """One step at dp = 2 (ZeRO moments) and at tp = 2 through
    pipelines/train.train_loop, each against the one-process step on the
    same batch and noise (run first by rank 0 alone)."""
    import torch
    import torch.distributed as dist
    from viditq_tpu_torch.parallel.mesh import make_mesh
    lead = dist.get_rank() == 0
    depth = PAR_TRAIN_DEPTH
    for axes in ({"dp": PAR_WORLD}, {"tp": PAR_WORLD}):
        label = "train " + " ".join(f"{k}={v}" for k, v in axes.items())
        label += f", {depth} blocks"
        mesh = make_mesh(**axes)
        ref = None
        if lead:
            torch.cuda.reset_peak_memory_stats()
            ref = _train_once(None, tmp, depth)
            report["lines"].append(
                f"  parallel {label}: the one-process step's loss "
                f"{ref[0]!r}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got, _ = _par_run(label, lambda: _train_once(mesh, tmp, depth),
                          report, counts, ("attention_bnhd",))
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 2 ** 30])
        peaks = [torch.zeros(1) for _ in range(PAR_WORLD)]
        dist.all_gather(peaks, peak)
        torch.cuda.empty_cache()
        if not lead:
            continue
        loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
        rel, cos = _update_agreement(got[1], ref[1], ref[2])
        mu_rel, mu_norm = _moment_agreement(got[3], ref[3])
        report["lines"].append(
            f"  parallel {label}: loss {got[0]!r} against {ref[0]!r} (rel "
            f"{loss_rel!r}, limit {PAR_LOSS_REL}); the update against the "
            f"one-process step's: rel {rel!r} (limit {PAR_UPDATE_REL}), "
            f"cosine {cos!r} (limit {PAR_UPDATE_COS}); the first moments: "
            f"rel {mu_rel!r}, worst tensor norm off by {mu_norm!r} (limits "
            f"{PAR_MU_REL}); peak memory by rank "
            f"{[round(float(p), 2) for p in peaks]} GiB")
        if not (loss_rel <= PAR_LOSS_REL and rel <= PAR_UPDATE_REL
                and cos >= PAR_UPDATE_COS and mu_rel <= PAR_MU_REL
                and mu_norm <= PAR_MU_REL):
            raise RuntimeError(f"parallel {label} differs from one process: "
                               f"{report['lines'][-1]}")
        ref = got = None


def parallel_rank(rank: int, world: int, init_file: str, results) -> None:
    """One rank of phase parallel (spawned): gloo over `init_file`, the
    arms in turn; puts (rank, 'ok', report) or (rank, 'error', traceback)
    on results."""
    import tempfile
    import traceback
    import torch
    import torch.distributed as dist
    try:
        sys.path.insert(0, str(ROOT))
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from viditq_tpu_torch.parallel.mesh import init_distributed
        init_distributed("gloo", device="cuda",
                         init_method=f"file://{init_file}", rank=rank,
                         world_size=world)
        report, counts = {"lines": []}, {}
        _par_sp(report, counts)
        _par_pp(report, counts)
        with tempfile.TemporaryDirectory(prefix="viditq_par_") as tmp:
            _par_train(report, counts, tmp)
        report["counts"] = counts
        dist.destroy_process_group()
        results.put((rank, "ok", report))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _par_nccl(counts) -> None:
    """World size 1 on NCCL (`init_distributed` picks it for the card):
    one pp forward and one train step through the code of the gloo arms,
    the collectives degenerate; each against the same work without a
    mesh."""
    import tempfile
    import torch
    import torch.distributed as dist
    from viditq_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from viditq_tpu_torch.parallel.pipeline import PipelinedModel
    with tempfile.TemporaryDirectory(prefix="viditq_nccl_") as tmp:
        init_distributed(device="cuda", init_method=f"file://{tmp}/pg",
                         rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            if backend != "nccl":
                fail(f"parallel nccl: the default group runs {backend}")
            model = build_model(STDIT_CFG, "cuda")
            x, t, y, mask = par_inputs(STDIT_CFG, 0.5)
            with torch.no_grad():
                ref = model(x, t, y, mask)
                pm = PipelinedModel(model, make_mesh(pp=1), PAR_N_MB)
                torch.cuda.synchronize()
                _counters_reset()
                got = pm(x, t, y, mask)
                torch.cuda.synchronize()
                _counts_into(counts)
            model = None
            torch.cuda.empty_cache()
            rel = float((got - ref).norm() / ref.norm())
            print(f"  parallel nccl world 1 (backend {backend}): pp forward "
                  f"against stage 'all': rel err {rel!r} (limit "
                  f"{PAR_REL_ERR})", flush=True)
            if not rel <= PAR_REL_ERR:
                fail(f"parallel nccl pp: rel err {rel}")
            one = _train_once(None, tmp, PAR_TRAIN_DEPTH)
            torch.cuda.empty_cache()
            _counters_reset()
            got = _train_once(make_mesh(dp=1), tmp, PAR_TRAIN_DEPTH)
            _counts_into(counts)
            rel, cos = _update_agreement(got[1], one[1], one[2])
            mu_rel, mu_norm = _moment_agreement(got[3], one[3])
            print(f"  parallel nccl world 1: train step loss {got[0]!r} "
                  f"against {one[0]!r} without a mesh; update rel {rel!r}, "
                  f"cosine {cos!r}; first moments rel {mu_rel!r}, worst "
                  f"tensor norm off by {mu_norm!r}", flush=True)
            if not (abs(got[0] - one[0]) <= PAR_LOSS_REL * abs(one[0])
                    and rel <= PAR_UPDATE_REL and cos >= PAR_UPDATE_COS
                    and mu_rel <= PAR_MU_REL and mu_norm <= PAR_MU_REL):
                fail("parallel nccl: the train step differs")
        finally:
            dist.destroy_process_group()


def _counters_reset() -> None:
    from viditq_tpu_torch.kernels import _counters
    _counters.reset()


def _counts_into(counts) -> None:
    from viditq_tpu_torch.kernels import _counters
    for k, v in _counters.snapshot().items():
        if v["plain_cuda"]:
            fail(f"parallel: the plain version of {k} ran on CUDA")
        counts[k] = counts.get(k, 0) + v["launches"]


def phase_parallel() -> dict:
    """Parallelism on the card (module header, phase 12): PAR_WORLD ranks
    spawned over gloo on the one card (`parallel_rank`), then NCCL at world
    size 1 in this process. Returns each kernel's launches (both ranks')."""
    import gc
    import tempfile
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()  # the parent's models are gone
    t_phase = time.time()
    counts = {}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="viditq_pg_") as tmp:
        procs = [ctx.Process(target=parallel_rank,
                             args=(r, PAR_WORLD, f"{tmp}/pg", results))
                 for r in range(PAR_WORLD)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(PAR_WORLD):
                rank, status, val = results.get(timeout=PAR_TIMEOUT_S)
                if status != "ok":
                    fail(f"parallel rank {rank}:\n{val}")
                got[rank] = val
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
        if any(p.exitcode != 0 for p in procs):
            fail(f"parallel: rank exit codes {[p.exitcode for p in procs]}")
    for line in got[0]["lines"]:
        print(line, flush=True)
    for r in range(PAR_WORLD):
        for k, v in got[r]["counts"].items():
            counts[k] = counts.get(k, 0) + v
    _par_nccl(counts)
    print(f"phase parallel: {time.time() - t_phase:.1f} s", flush=True)
    return counts


# ---------------- phase data ----------------

DATA_FRAMES, DATA_SIZE = 16, 512   # the 16x512x512 workload's clips
DATA_CLIPS = 4                     # train --data_path: 2 steps at batch 2
DATA_BATCH = 2
# the card's VAE against the same weights on the CPU (float32, TF32 off:
# the convolutions' and group norms' sums in another order)
VAE_REL_ERR = 1e-3


def write_y4m(path, frames) -> None:
    """frames uint8 [T, H, W, 3] -> a YUV4MPEG2 4:2:0 file (BT.601 limited
    range, the chroma averaged over 2x2), numpy only."""
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    T, H, W = frames.shape[:3]

    def sub(c):
        return c.reshape(T, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    planes = [np.clip(np.rint(c), 0, 255).astype(np.uint8)
              for c in (y, sub(u), sub(v))]
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{W} H{H} F8:1 Ip A1:1 C420\n".encode())
        for t in range(T):
            fh.write(b"FRAME\n")
            for pl in planes:
                fh.write(pl[t].tobytes())


def data_clips(tmp: Path, n: int, rng) -> str:
    """n clips of DATA_FRAMES x DATA_SIZE^2 (smooth random content: a
    coarse draw upsampled, so the VAE sees structure) as .y4m files and
    their CSV (rows `path,text`)."""
    rows = []
    s = DATA_SIZE // 16
    for i in range(n):
        base = rng.integers(0, 256, (DATA_FRAMES, s, s, 3), dtype=np.uint8)
        frames = np.repeat(np.repeat(base, 16, axis=1), 16, axis=2)
        path = tmp / f"clip{i}.y4m"
        write_y4m(path, frames)
        rows.append(f"{path},clip {i}")
    csv = tmp / f"clips{n}.csv"
    csv.write_text("\n".join(rows))
    return str(csv)


def latent_clips(tmp: Path, n: int, rng) -> tuple:
    """--no_vae's data: n .npz items whose 'video' is [DATA_FRAMES, h, w,
    4] uint8 at the latent size (normalized by the dataset to [-1, 1],
    the x0 as it is), their CSV, and a copy of the train config whose
    image_size is that size with the model's input_size given."""
    h = DATA_SIZE // 8
    rows = []
    for i in range(n):
        path = tmp / f"latent{i}.npz"
        np.savez(path, video=rng.integers(0, 256, (DATA_FRAMES, h, h, 4),
                                          dtype=np.uint8))
        rows.append(f"{path},latent {i}")
    csv = tmp / "latents.csv"
    csv.write_text("\n".join(rows))
    src = Path(train_workload(tmp)).read_text()
    for old, new in ((f"image_size = ({DATA_SIZE}, {DATA_SIZE})",
                      f"image_size = ({h}, {h})"),
                     ("grad_checkpoint=True,", "grad_checkpoint=True, "
                      f"input_size=({DATA_FRAMES}, {h}, {h}),")):
        if old not in src:
            fail(f"train config: no '{old}' to change")
        src = src.replace(old, new)
    config = tmp / "stdit_train_latents.py"
    config.write_text(src)
    return str(csv), str(config)


def timed_vae(label, fn, reps: int = 1):
    """fn()'s output, its ms (CUDA events, after one warm-up call) and the
    peak memory of a call."""
    import torch
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        b.synchronize()
    ms = a.elapsed_time(b) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {label}: {ms:.1f} ms, peak memory {peak:.2f} GiB, out "
          f"{list(out.shape)}", flush=True)
    if not torch.isfinite(out).all():
        fail(f"data {label}: the output is not finite")
    return out, ms


def phase_data() -> dict:
    """Data, the VAE and the two commands that use them (module header,
    phase 13). Imports no Pillow: the clips are .y4m at the target size.
    Returns each kernel's launches."""
    import tempfile

    import torch
    from viditq_tpu_torch.data.datasets import DatasetFromCSV
    from viditq_tpu_torch.models.vae import VideoAutoencoderKLTemporalDecoder
    from viditq_tpu_torch.utils import workload

    counts = {}
    t_phase = time.time()
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory(prefix="viditq_data_") as tmpd:
        tmp = Path(tmpd)
        t0 = time.time()
        csv = data_clips(tmp, DATA_CLIPS, rng)
        ds = DatasetFromCSV(csv, num_frames=DATA_FRAMES,
                            image_size=(DATA_SIZE, DATA_SIZE))
        items = [ds[i] for i in range(DATA_BATCH)]
        x = torch.from_numpy(np.stack([it["video"] for it in items])).cuda()
        print(f"phase data: {DATA_CLIPS} .y4m clips of {DATA_FRAMES}x"
              f"{DATA_SIZE}x{DATA_SIZE} written and {DATA_BATCH} read "
              f"(DatasetFromCSV) in {time.time() - t0:.1f} s: pixels "
              f"{list(x.shape)} in [{float(x.min()):.3f}, "
              f"{float(x.max()):.3f}]; Pillow imported: "
              f"{'PIL' in sys.modules}", flush=True)
        # the full-width VAE of the 16x512x512 workload (micro-batches of
        # 128 frames: one here), JAX's initialisers, float32
        cfg = workload.load_py_config(str(CLI_WORKLOAD))
        vae = workload.build_vae(cfg, device="cuda")
        workload.jax_init_(vae, 0)
        z, enc_ms = timed_vae(f"VideoAutoencoderKL encode [{DATA_BATCH}, 3, "
                              f"{DATA_FRAMES}, {DATA_SIZE}, {DATA_SIZE}]",
                              lambda: vae.encode(x))
        want = [DATA_BATCH, 4, DATA_FRAMES, DATA_SIZE // 8, DATA_SIZE // 8]
        if list(z.shape) != want:
            fail(f"data: latent {list(z.shape)}, want {want}")
        rec, _ = timed_vae("VideoAutoencoderKL decode", lambda: vae.decode(z))
        if tuple(rec.shape) != tuple(x.shape):
            fail(f"data: decoded {list(rec.shape)}, want {list(x.shape)}")
        del rec
        # the same weights on the CPU on a small input (2 frames of 64^2)
        small = x[:1, :, :2, :64, :64]
        cpu = workload.build_vae(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
        with torch.no_grad():
            zc, zg = cpu.encode(small.cpu()), vae.encode(small).cpu()
            dc, dg = cpu.decode(zc), vae.decode(zc.cuda()).cpu()
        rels = [float((g - c).norm() / c.norm()) for g, c in ((zg, zc),
                                                                (dg, dc))]
        print(f"  VAE card vs CPU on [1, 3, 2, 64, 64]: encode rel err "
              f"{rels[0]:.3g}, decode {rels[1]:.3g} (limit {VAE_REL_ERR})",
              flush=True)
        if max(rels) > VAE_REL_ERR:
            fail(f"data: the VAE on the card differs from the CPU: {rels}")
        cpu = None
        vae.module.decoder = None
        torch.cuda.empty_cache()
        temporal = VideoAutoencoderKLTemporalDecoder(
            num_frames=DATA_FRAMES).cuda().eval()
        workload.jax_init_(temporal, 0)
        timed_vae(f"VideoAutoencoderKLTemporalDecoder decode [1, 4, "
                  f"{DATA_FRAMES}, {DATA_SIZE // 8}, {DATA_SIZE // 8}]",
                  lambda: temporal.decode(z[:1]))
        temporal = None
        torch.cuda.empty_cache()
        # extract-features over two clips: the encoder drawn as above
        # (jax_init_ seed 0 draws the encoder first), so its latents are
        # this encode's
        two = tmp / "two.csv"
        two.write_text("\n".join(Path(csv).read_text().splitlines()[:2]))
        feat, _ = run_cli("extract-features", [
            "extract-features", "--csv", str(two), "--num_frames",
            str(DATA_FRAMES), "--image_size", str(DATA_SIZE), "--batch_size",
            str(DATA_BATCH), "--save_dir", str(tmp / "feat")], counts)
        lat = torch.from_numpy(np.load(feat["out"], allow_pickle=True)[
            "latents"])
        rel = float((lat - z.cpu()).norm() / z.cpu().norm())
        print(f"  extract-features: {feat['seconds']:.2f} s encoding "
              f"{feat['n']} clips ({DATA_BATCH} a batch), latents "
              f"{list(lat.shape)}, rel err to the in-process encode "
              f"{rel:.3g} (limit {VAE_REL_ERR})", flush=True)
        if rel > VAE_REL_ERR:
            fail(f"data: extract-features latents differ by {rel}")
        vae = z = x = None
        torch.cuda.empty_cache()
        # train --data_path on STDiT-XL/2 16x512x512 (grad_checkpoint):
        # one epoch over DATA_CLIPS clips at batch 2, each batch's pixels
        # encoded inside the loop; then --no_vae over latents
        config = train_workload(tmp)
        steps = DATA_CLIPS // DATA_BATCH
        out, launched = run_cli("train data", [
            "train", "--config", config, "--data_path", csv, "--batch_size",
            str(DATA_BATCH), "--save_dir", str(tmp / "train")], counts)
        train_report(f"--data_path, {steps} steps with the VAE encode",
                     out, launched, steps)
        lcsv, lconfig = latent_clips(tmp, DATA_CLIPS, rng)
        out_nv, launched = run_cli("train data no_vae", [
            "train", "--config", lconfig, "--data_path", lcsv, "--no_vae",
            "--batch_size", str(DATA_BATCH), "--save_dir",
            str(tmp / "train_nv")], counts)
        train_report(f"--data_path --no_vae, {steps} steps over latents",
                     out_nv, launched, steps)
        print(f"  train --data_path: {out['ms_per_step']:.1f} ms a step with "
              f"the encode, {out_nv['ms_per_step']:.1f} without (--no_vae); "
              f"the encode alone {enc_ms:.1f} ms", flush=True)
        out = out_nv = None
    torch.cuda.empty_cache()
    print(f"phase data: {time.time() - t_phase:.1f} s", flush=True)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from viditq_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"phase device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.time()
    _build.lib()
    print(f"phase build: {time.time() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)

    t_start = time.time()
    records = {}
    phase_kernels(records)
    phase_reference()
    launches = run_slice("stdit", STDIT_CFG, 0.5, 120)
    for name, cfg, z_scale, n_prompt in (
            ("sigma", SIGMA_CFG, 1.0, 300),
            ("stdit_plans", plan_cfg(STDIT_CFG), 0.5, 120),
            ("alpha", plan_cfg(ALPHA_CFG), 1.0, 120),
            ("sigma_plans", plan_cfg(SIGMA_CFG), 1.0, 300)):
        for k, n in run_slice(name, cfg, z_scale, n_prompt).items():
            launches[k] += n
    for name, cfg, n_prompt in (("latte", LATTE_CFG, 1),
                                ("dit", DIT_CFG, None),
                                ("dit_l", DIT_L_CFG, None),
                                ("mmdit", MMDIT_CFG, 77),
                                ("stdit_h6", STDIT_H6_CFG, 120),
                                ("dit_l_h4", DIT_L_H4_CFG, None)):
        for k, n in run_slice(name, cfg, 0.5, n_prompt).items():
            launches[k] += n
    for k, n in phase_cli().items():
        launches[k] += n
    for k, n in phase_samplers().items():
        launches[k] += n
    for k, n in phase_recon_sigma().items():
        launches[k] += n
    for k, n in phase_train().items():
        launches[k] += n
    for k, n in phase_parallel().items():
        launches[k] += n
    for k, n in phase_data().items():
        launches[k] += n

    kernels = []
    for name, recs in records.items():
        head = recs[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    print(f"chip_smoke: the phases after the build in "
          f"{time.time() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
