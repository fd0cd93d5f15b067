"""Smoke run of the PyTorch port on one NVIDIA GPU: Decision Diffuser (DD)
planning and Diffuser planning at the shipped widths, through the
hand-written Hopper kernels, and the DQL, IDQL and EDP diffusion policies
(MLPs, no kernel) through their CLIs; the CLIs of the D4RL antmaze and
kitchen suites, AdaptDiffuser's, and Diffusion Veteran's and DiffuserLite's
(plain blocks, no kernel); SfBC's, QGPO's and SynthER's CLIs and the
staged consistency policy (MLPs, no kernel).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device    - a CUDA device must be present (there is no CPU path); prints
               the `nvidia-smi` name and power limit.
2. build     - builds the CUDA kernels (csrc/dit_block.cu, csrc/film_resblock.cu)
               with nvcc from the sources in this checkout, one nvcc each, in
               parallel; prints the seconds and the compiler's register /
               shared-memory report; counts the tensor-core instructions
               (HMMA / HGMMA) in the SASS of both and fails if either has
               none, and the BF16 ones (HMMA.16816.F32.BF16) of K1's BF16
               route, failing if there are none; compiles the Triton
               solver-update kernel.
3. dit_block - K1 against its plain PyTorch version at the DD plan's shape
               (B=100, H=32, D=320, 10 heads, f32), at the 3200-trajectory
               candidate batch and at the antmaze horizon H=64 (a cluster of
               two thread blocks per trajectory): error, both times, TFLOP/s
               (flops from the shape) and the kernel's share of its bound.
   dit_block BF16 - K1's BF16 route (BF16 weights and biases) against its
               plain version (which promotes as jnp does) at (100, 32, 320)
               mixed (f32 x and mod) and all-BF16, (3200, 32, 320) mixed,
               (100, 64, 320) mixed on the cluster, and (64, 32, 320)
               all-BF16 (the forward of a `bf16_training` step): error
               within 5e-2 (and the share of that limit read), the route's
               time beside the f32 route's and the plain version's in one
               call, TFLOP/s and the share of the BF16 bound.
4. film_resblock - K3 against its plain version at every distinct block
               shape of the shipped Diffuser U-Net (B=3200 candidate
               trajectories, K=5, 8 groups, eps 1e-6): error, both times
               and both TFLOP/s per shape (flops from the shape), and their
               sums over the 16 blocks of one U-Net call. Then the same at
               the antmaze suite's U-Net (model_dim 64: channels 64 to 512,
               H = 64 at the top; 951 GFLOP per call at B = 3200), with each
               shape's thread-block plan and shared memory against the
               device's limit and the share of the 3xTF32 bound.
5. solver_update - K2 against its plain version at the plan's state shape
               (3200, 32, 23) with a real ddpm step's coefficients: exact
               without noise, N(0, 1) moments of the in-kernel noise over
               2.4 M draws, seeded; both times.
6. DD slice  - builds DDPipeline on the GPU from configs/dd/mujoco (task
               halfcheetah-medium-v2), loads seeded non-zero weights through
               the JAX-layout converter, serves 5 `act` requests for 50 envs,
               checks the actions, the inpainted first state and K1's launch
               count (40 per request: 20 steps x 2 blocks; the BF16 route's
               0), and holds one plan
               through K1 against the same plan through the plain version,
               with the same explicit noise. Then the same for one request
               at the antmaze configs' horizon of 64 (antmaze-medium-play-v2).
   DD slice, bf16_sampling - the same config with `bf16_sampling=true`
               through `setup_mesh`: 5 requests (the BF16 route 40 launches
               per request, the f32 route none), their latency beside the
               f32 latency of the same requests, and one plan in bf16
               against the f32 plan with the same explicit noise (max and
               mean |diff| within 0.02 and 0.005 of the plan's scale, the
               JAX package's bounds; the gap with the Fourier frequencies at
               their N(0, 16^2) init scale is printed beside it); then one
               antmaze request (H = 64), its gap printed.
7. Diffuser slice - builds DiffuserPipeline on the GPU from
               configs/diffuser/mujoco (halfcheetah-medium-v2) with the fused
               block on, loads seeded non-zero weights (U-Net, classifier and
               both EMAs), serves 5 `act` requests for 50 envs x 64
               candidates with classifier guidance, checks the actions, the
               inpainted first state and K3's launch count (5 x 20 steps x 16
               blocks), holds one plan through K3 against the same plan
               through the plain block (every candidate and its log p; the
               chosen index wherever the top two are apart; the actions),
               and serves one request with the fused solver update (20 K2
               launches).
8. dit_block autograd - K1 through its autograd Function at DD's training
               shape (B=64, H=32, D=320): the forward against the plain
               version, the gradients (its backward is autograd through the
               plain version, as the JAX custom VJP's), and forward and
               forward + backward times against plain, with TFLOP/s and the
               forward's share of its bound; then the same at DD antmaze's
               training shape (64, 64, 320), on 2-block clusters.
9. DD training - DDPipeline from configs/dd/mujoco at full width (batch 64)
               with the fused block on and seeded weights: the first step's
               gradients through K1 against the plain block, 20 `train_step`s
               with K1's launch count (2 per step), finite losses and grad
               norms and the inverse-dynamics loss, the same 20 steps through
               the plain block with the same batches and explicit noise
               (per-step losses within LOSS_RTOL, grad norms within
               GRAD_NORM_RTOL; the params' final drift printed), ms per step on both paths (median of 12, CUDA
               events, in turns), then one `act` from the trained EMA.
   DD training, bf16_training - the same config with `bf16_training=true`
               through `setup_mesh`: 10 `train_step`s (the BF16 route 2
               launches per step, the f32 route none) against the same steps
               in f32 with the same batches and noise (per-step losses within
               5 %, the JAX package's bound); params, Adam state and EMA
               stay f32; ms per step on both.
10. Diffuser training - first K3 through its autograd Function at every
               distinct U-Net block shape at the training batch 64: forward
               and the gradients of every input against the plain version.
               Then DiffuserPipeline from configs/diffuser/mujoco at full
               width (batch 64) with the block on: 10 `train_step`s
               (diffusion and classifier updates) with K3's launch count (16
               per step), against the plain block as for DD, ms per step.
11. checkpoint - DD saved after 10 steps and loaded into a fresh pipeline:
               step 11 on both agrees within CKPT_ATOL.
12. Goal2D score - the hermetic DD of tests/test_hermetic_parity.py:139-148
               (d_model 128, 4 heads, depth 2, horizon 8) with the fused
               block, on the port's D4RLMuJoCoDataset over the Goal2D
               behavior data (1000 episodes, seed 0) on the card: 3000
               `train_step`s through K1 on batches of 64 from the device
               sampler, then 64 episodes of the torch env planned from the
               EMA in f32 and with `bf16_sampling`: both normalized scores
               must reach 0.85 (the JAX package's bar); K1's launches on
               each route printed.
13. DD CLI   - `cli.dd_d4rl_mujoco.pipeline(args)` in-process, as a user runs
               it, on configs/dd/mujoco (halfcheetah-medium-v2, shipped
               width, the synthetic data) with `mode=train
               diffusion_gradient_steps=500 invdyn_gradient_steps=250
               log_interval=125 save_interval=250`, in results/chip_smoke_cli:
               four windows (`make_train_scan`) with finite means and
               `invdyn_loss` 0 in the last two, K1's f32 route 2 x 500
               launches (BF16 0), ckpt_250, ckpt_500 and ckpt_latest; the
               same config off the window grid for 250 steps (per-step
               path), its steps/s beside the windows'; then ckpt_latest in
               a fresh pipeline serving 5 `act` requests for 50 envs as
               `mode=inference` makes them (normalised first states of the
               dataset's episodes stand in for the envs' observations:
               the card's machine has no gymnasium, so the env stepping of
               `d4rl_eval_loop` is not run): actions finite, in [-1, 1],
               (50, 6), 40 K1 launches per request.
14. Diffuser CLI - the same for `cli.diffuser_d4rl_mujoco` on
               configs/diffuser/mujoco with `diffusion_gradient_steps=200
               classifier_gradient_steps=100 log_interval=50
               save_interval=100`: K3 16 x 200 launches, K2 0,
               `classifier_loss` 0 in the last two windows, the three
               checkpoints, and 2 requests at 50 envs x 64 candidates from
               ckpt_latest (320 K3 launches each).
15. RL CLIs  - `cli.dql_d4rl_mujoco`, `cli.idql_d4rl_mujoco` and
               `cli.edp_d4rl_mujoco` in-process on configs/{dql,idql,edp}/mujoco
               (halfcheetah-medium-v2: obs 17, act 6; critics 256 wide, the
               IDQLMlp 256 wide with 3 blocks; batch 256; the synthetic data)
               with `mode=train gradient_steps=1250 log_interval=250
               save_interval=250`: five finite window means, ckpt_250 to
               ckpt_1250 and ckpt_latest (step 1250); DQL and EDP: the actor EMA in
               ckpt_1000 equals the initial weights bit for bit (the EMA gate
               opens at step 1000) and in ckpt_latest it does not; IDQL: the
               Q and V optimizers' counts in ckpt_latest are 625 (the critic
               moves on even steps). Then 200 steps off the window grid
               (the per-step path), its steps/s beside the windows'; then
               ckpt_latest in a fresh pipeline serving 5 `act` requests at
               50 envs with the config's candidates (DQL 2,500 rows x 5
               steps, IDQL 12,800 x 5, EDP 2,500 x 15), normalised dataset
               observations standing in for the envs': actions finite, in
               [-1, 1], (50, 6), the median latency. No kernel launches in
               these phases (all four counts read 0).
16. DQL Goal2D - the hermetic DQL of tests/test_hermetic_parity.py:101-108
               (emb 32, critic 128, discount 0.95) trained 3000 steps at
               batch 128 on the Goal2D behavior data on the card, with grad
               through the 5-step sampler; 128 episodes with 50 candidates
               per env: the normalized score must reach 0.85.
17. suite CLIs - `cli.dd_d4rl_{antmaze,kitchen}` (200 steps in two windows,
               K1 2 launches per step, at H = 64 on clusters for antmaze; 2
               requests at 50 envs, 40 launches each; one plan through K1
               against the plain block) and `cli.diffuser_d4rl_{antmaze,
               kitchen}` (40 steps, K3 16 per step; 2 requests at 50 x 64,
               320 launches each, the U-Net's block shapes read on the way
               in; one plan against the plain block, every candidate and
               log p; K3 under autograd at batch 64 at each block shape, the
               forward and every gradient against the plain block), on the
               shipped configs and synthetic data.
18. AdaptDiffuser - `cli.adaptdiffuser_d4rl_{mujoco,antmaze}`: 20 steps of
               `mode=train`; from its ckpt_latest, one generation round of
               2000 dataset start states with explicit noise (K3's launches
               read just after it: 320; the U-Net's batch read by hooks:
               2000), held against the same round through the plain block
               (every trajectory and log p within PLAN_ATOL), the kept share
               at the shipped metric_value, then 20 `finetune_step`s at
               batch 32 (16 launches each, read on their own) and K3 under
               autograd at batch 32 at each block shape; then `mode=finetune`
               with one round and 20 fine-tuning steps, at the task's
               metric_value, or, if that keeps nothing on the synthetic
               data, again keeping all: the round's seconds and kept share;
               `ckpt_finetuned_latest` served for one request at 50 x 64.
19. suite RL CLIs - `cli.{dql,idql,edp}_d4rl_{antmaze,kitchen}`: one window
               of 100 steps, then 2 requests from ckpt_latest at 50 envs
               with the config's candidates; no kernel launch.
20. Veteran CLIs - `cli.veteran_d4rl_{mujoco,maze2d,antmaze,kitchen}` on
               configs/veteran/* (the plain DiT blocks, as the reference
               builds them): `mode=train` (MuJoCo: 200 steps in two windows
               at d_model 320, batch 64; the others 20 steps), then
               `mode=train_expected_value` with its step count patched down
               (200 / 20 TD steps), checkpoints on the save grid; then
               `veteran_latest.pkl` served at the config's envs x
               candidates (MuJoCo 5 requests at 50 x 32 = 1,600
               trajectories; the others 2 requests), each request's
               latency, one request profiled (device busy, idle share, the
               planner's, scorer's and policy's profiler ranges; MuJoCo
               also the plain DiT block at (1600, 32, 320) graph-timed for
               its share), and one request held against the same request
               on the port's CPU path with the same explicit noise (10 envs
               on MuJoCo, 2 on the others): the whole candidate batch, its
               scores before the argmax and the chosen plans within
               PLAN_ATOL, the picks equal where the scores are apart.
21. DiffuserLite CLIs - `cli.diffuserlite_d4rl_mujoco` on
               configs/diffuserlite/mujoco (three levels of DiT d_model
               256, horizons 5/5/9): `mode=training` (200 steps in two
               windows, the inverse dynamics in the first),
               `mode=prepare_dataset` (two batches of the config's 5000
               pairs per level), `mode=reflow` (100 steps), then 5 R1
               requests from ckpt_latest and 5 R2 from reflow_ckpt_latest
               at 50 envs, one of each profiled (each level's range) and
               held against the CPU (plans and actions within PLAN_ATOL);
               `cli.diffuserlite_d4rl_{antmaze,kitchen}`: `mode=iql_training`
               (100 steps), `mode=training` (20), 2 R1 requests at 50 x 64
               candidates ranked by IQL's V through the CLI's act function,
               one request against the CPU at 2 envs. No kernel launch in
               phases 20-21 (every count reads 0).
22. SfBC CLI - `cli.sfbc_d4rl_mujoco` on configs/sfbc/mujoco
               (SfBCUNet (512, 256, 128), critic 256): `mode=bc_training`
               (500 steps in windows of 125 at 32 x 32 rows; the save grid),
               `mode=critic_training` (2 iterations of 200 steps: one
               Monte-Carlo re-evaluation of every path of the data, 16
               samples per cell, timed), then `ckpt_critic` served at 50
               envs x 32 candidates (top-4 mean), one request profiled and
               one at 10 envs held against the CPU (candidates and critic
               scores within PLAN_ATOL, the same top-4 where apart).
23. QGPO CLI - `cli.qgpo_d4rl_mujoco` on configs/qgpo/mujoco: every stage:
               500 BC steps, the support of all 100,000 next states in
               batches of 5,000 states (80,000 rows x 10 ddpm steps, timed),
               500 Q and 500 CEP steps in windows on the shared store, then
               guided requests (the task's `w_cg`, final log p) at 50 envs,
               one profiled and one held against the CPU.
24. SynthER CLIs - `cli.synther_d4rl_{mujoco,antmaze,kitchen}`: every
               mode: `train_diffusion` (MuJoCo 500 steps, the others 100),
               `transition_generation` (MuJoCo one 100,000-row batch of 128
               ddpm steps: its seconds and TFLOP/s; the others 10,000),
               `train_td3bc` (1,000 / 200 steps; the actor's and targets'
               updates read against `policy_freq`), then TD3+BC requests at
               50 envs held against the CPU, and an 8-row generation chunk
               held to a float64 run of it (the card's error within
               GEN_ERR_FACTOR of the CPU's float32 error).
25. consistency policy - `cli.sp_consistency_policy` (the tutorial's
               sizes), then the hermetic gate of
               tests/test_hermetic_parity.py:160 on the card (IQL 2000, EDM
               3000 and distillation 2000 steps at batch 128; the EDM
               teacher at 5 Euler steps >= 0.85, the 2-NFE student >= 0.80
               over 128 episodes with 32 candidates), then 5 requests at 50
               envs x 32 candidates with the CD model at 2 NFE and the EDM
               at 5 Euler and 5 Heun steps, each profiled and held against
               the CPU. No kernel launch in phases 22-25.

The CLI phases generate each task's synthetic data once (`cache_cli_data`).
The script prints its total seconds before the kernels' line.

Each slice resets every launch count just before its requests (or training
steps) and reads the counts just after. The line before the last is a JSON
object with one record per kernel: its launches in the planning requests
(`launches`), in the training steps (`train_launches`) and in the CLI
phases by CLI and part (`cli_launches`: the Veteran, DiffuserLite, SfBC,
QGPO, SynthER and consistency-policy phases' read 0), error and times
at the plan's shape, and its bound there: the larger of its bytes over 3.35
TB/s and its operations over the H100 SXM's peak for their type. K1 and K3
do each multiply-add of a product as three TF32 MMAs (3xTF32), so their
operations are 3x the flops at the 495 TFLOP/s TF32 peak; K1's BF16 route
does its four weight products at the 989 TFLOP/s BF16 peak and attention
in 3xTF32; K2's are f32 at 67 TFLOP/s. The last line is {"ok": true,
"device": {...}}. TF32 is off for every comparison (matmul and cuDNN), so
both sides compute in full float32. Every device time (`cuda_ms`) replays
one CUDA graph of the timed calls, so it is the device's alone: launched
one by one from this host, the plain blocks' and the backward passes' many
small launches leave the device waiting.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from cleandiffuser_tpu_torch.cli import (  # noqa: E402
    adaptdiffuser_d4rl_antmaze,
    adaptdiffuser_d4rl_mujoco,
    dd_d4rl_antmaze,
    dd_d4rl_kitchen,
    dd_d4rl_mujoco,
    diffuser_d4rl_antmaze,
    diffuser_d4rl_kitchen,
    diffuser_d4rl_mujoco,
    diffuserlite_d4rl_antmaze,
    diffuserlite_d4rl_kitchen,
    diffuserlite_d4rl_mujoco,
    dql_d4rl_antmaze,
    dql_d4rl_kitchen,
    dql_d4rl_mujoco,
    edp_d4rl_antmaze,
    edp_d4rl_kitchen,
    edp_d4rl_mujoco,
    idql_d4rl_antmaze,
    idql_d4rl_kitchen,
    idql_d4rl_mujoco,
    qgpo_d4rl_mujoco,
    sfbc_d4rl_mujoco,
    sp_consistency_policy,
    synther_d4rl_antmaze,
    synther_d4rl_kitchen,
    synther_d4rl_mujoco,
    veteran_d4rl_antmaze,
    veteran_d4rl_kitchen,
    veteran_d4rl_maze2d,
    veteran_d4rl_mujoco,
)
from cleandiffuser_tpu_torch.dataset import D4RLMuJoCoDataset, D4RLMuJoCoTDDataset  # noqa: E402
from cleandiffuser_tpu_torch.dataset.hermetic import (  # noqa: E402
    goal2d_qlearning_dataset,
    goal2d_sequence_dataset,
)
from cleandiffuser_tpu_torch.diffusion.basic import DiffusionModel  # noqa: E402
from cleandiffuser_tpu_torch.diffusion.vp_solvers import ddpm_coefficients  # noqa: E402
from cleandiffuser_tpu_torch.env.goal2d import evaluate_policy, normalized_score_fn  # noqa: E402
from cleandiffuser_tpu_torch.ops import build  # noqa: E402
from cleandiffuser_tpu_torch.ops.dit_block import (  # noqa: E402
    dit_block_op,
    dit_block_reference,
    fused_dit_block,
    fused_dit_block_bf16,
    load_dit_block_library,
)
from cleandiffuser_tpu_torch.ops.film_resblock import (  # noqa: E402
    film_resblock_op,
    film_resblock_reference,
    fused_film_resblock,
    load_film_resblock_library,
)
from cleandiffuser_tpu_torch.ops.solver_update import (  # noqa: E402
    fused_solver_update,
    solver_update_reference,
)
from cleandiffuser_tpu_torch.parallel import setup_mesh  # noqa: E402
from cleandiffuser_tpu_torch.pipelines import (  # noqa: E402
    ConsistencyPolicyPipeline,
    DDPipeline,
    DiffuserPipeline,
    DQLPipeline,
    SfBCPipeline,
    SynthERPipeline,
    goal2d_gate,
)
from cleandiffuser_tpu_torch.pipelines.diffuserlite_value import (  # noqa: E402
    build_candidate_plan_fn,
)
from cleandiffuser_tpu_torch.utils.config import load_config  # noqa: E402
from cleandiffuser_tpu_torch.utils.jax_params import agent_params_of, jax_params_of  # noqa: E402
from cleandiffuser_tpu_torch.utils.train_state import read_jax_pickle  # noqa: E402

SEED = 0
N_REQUESTS = 5
# Kernel vs plain version, one block, f32 on both sides: they differ only in
# the order of f32 sums (K up to 4*D = 1280 terms) and in expf/tanhf/rsqrtf
# against PyTorch's versions, a few 1e-6 relative; 1e-4 leaves margin.
BLOCK_ATOL = BLOCK_RTOL = 1e-4
# One 20-step plan, kernel vs plain with the same noise: the per-block
# differences above pass through 20 x 2 (DD) or 20 x 16 (Diffuser) blocks,
# the classifier's guidance and the sampler.
PLAN_ATOL = 1e-3
# K2 without noise: c_xt*xt + c_eps*eps on both sides, at most an FMA's
# rounding apart; with noise, the N(0, 1) moments over >= 2 M draws (the
# standard error of the mean is 7e-4, of the std 5e-4).
SOLVER_ATOL = 1e-6
MOMENT_TOL = 5e-3
# Training, kernel path against plain with the same batches and noise: each
# step's forward differs by the blocks' ~1e-5 relative; Adam then moves every
# param by ~lr whatever its gradient's size, so the two runs' params drift
# apart by up to ~lr per step where a gradient is rounding noise (the DiT's
# key bias, which the loss does not see). The loss sees those params only
# through rounding: on the H100 the per-step losses of 20 DD and 10 Diffuser
# steps differed by at most 3.8e-7 relative (invdyn 0, DD 9.4e-8, Diffuser
# 3.6e-7, its classifier 3.8e-7), the grad norms by at most 1.8e-6, which
# sum every squared gradient, the drifting ones too. Limits ~25x and ~50x
# over those readings.
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
# The port's own checkpoint: the resumed step runs the same kernels on the
# same inputs as the uninterrupted one
CKPT_ATOL = 1e-6
DD_TRAIN_STEPS, DIFFUSER_TRAIN_STEPS, TIMED_STEPS = 20, 10, 12
# K1's BF16 route against its plain version: the JAX package's bound for its
# bf16 kernel (tests/test_pallas_ops.py:136). The route rounds each product's
# activations to bf16, which the mixed plain version does not.
BF16_ATOL = BF16_RTOL = 5e-2
# bf16 against f32 with the same weights and noise: plans (max and mean |diff|
# over the plan's scale) and losses, the JAX package's bounds
# (tests/test_bf16_sampling.py:67-70, :105)
BF16_PLAN_MAX, BF16_PLAN_MEAN, BF16_LOSS_RTOL = 0.02, 0.005, 0.05
BF16_TRAIN_STEPS = 10
# the hermetic DD gate (tests/test_hermetic_parity.py:132-157)
GOAL2D_STEPS, GOAL2D_BAR = 3000, 0.85
# the CLI phases: the shipped configs trained through the CLIs' `pipeline(args)`
# with these overrides, in CLI_DIR (under the gitignored results/). The DD
# run's depth was cut from 1000 to 500 steps when the RL phases came, to keep
# the script near half of its time limit.
DD_CLI_TRAIN = ("mode=train", "diffusion_gradient_steps=500", "invdyn_gradient_steps=250",
                "log_interval=125", "save_interval=250")
# the same config with save_interval off the log grid: the per-step path, no
# save in its 250 steps, the inverse dynamics on in both of its windows as in
# the windowed run's first two
DD_CLI_PER_STEP = ("mode=train", "diffusion_gradient_steps=250", "invdyn_gradient_steps=250",
                   "log_interval=125", "save_interval=300")
DIFFUSER_CLI_TRAIN = ("mode=train", "diffusion_gradient_steps=200",
                      "classifier_gradient_steps=100", "log_interval=50", "save_interval=100")
DD_CLI_REQUESTS, DIFFUSER_CLI_REQUESTS = 5, 2
CLI_DIR = ROOT / "results" / "chip_smoke_cli"
# the RL CLI phases: 5 windows of 250, a save after each, so that ckpt_1000
# holds the last step before the actor EMA's gate opens and ckpt_latest the
# 1250th (the loop saves on the save grid only: with save_interval=500 the
# last save would be step 1000); then 200 steps with the save interval off
# the log grid (the per-step path; no save, so ckpt_latest stays)
RL_CLI_TRAIN = ("mode=train", "gradient_steps=1250", "log_interval=250", "save_interval=250")
RL_CLI_PER_STEP = ("mode=train", "gradient_steps=200", "log_interval=100", "save_interval=250")
RL_CLI_REQUESTS = 5
# the hermetic DQL gate (tests/test_hermetic_parity.py:101-108)
DQL_GOAL2D_STEPS, DQL_GOAL2D_BATCH = 3000, 128
# (H, Cin, Cout) of the 16 residual blocks of the shipped Diffuser U-Net
# (obs 17 + act 6 = 23 channels in, model_dim 32, dim_mult (1, 2, 2, 2),
# horizon 32), in the order the net runs them
UNET_BLOCKS = [(32, 23, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64), (8, 64, 128),
               (8, 128, 128), (4, 128, 256), (4, 256, 256), (4, 256, 256), (4, 256, 256),
               (4, 512, 128), (4, 128, 128), (8, 256, 64), (8, 64, 64), (16, 128, 32),
               (16, 32, 32)]
# the same for the antmaze suite's Diffuser and AdaptDiffuser U-Net (obs 29 +
# act 8 = 37 channels in, model_dim 64, dim_mult (1, 2, 2, 2), horizon 64):
# channels 64 to 512, 8x the MuJoCo net's work
ANTMAZE_UNET_BLOCKS = [(64, 37, 64), (64, 64, 64), (32, 64, 128), (32, 128, 128), (16, 128, 256),
                       (16, 256, 256), (8, 256, 512), (8, 512, 512), (8, 512, 512),
                       (8, 512, 512), (8, 1024, 256), (8, 256, 256), (16, 512, 128),
                       (16, 128, 128), (32, 256, 64), (32, 64, 64)]
# the antmaze and kitchen CLI phases, sized by their cost: DD 200 steps in
# two windows (the inverse dynamics in the first), Diffuser 40 in two; 2
# requests each (the first one cold); the RL CLIs one window of 100 steps
SUITE_DD_CLI_TRAIN = ("mode=train", "diffusion_gradient_steps=200", "invdyn_gradient_steps=100",
                      "log_interval=100", "save_interval=200")
SUITE_DIFFUSER_CLI_TRAIN = ("mode=train", "diffusion_gradient_steps=40",
                            "classifier_gradient_steps=20", "log_interval=20",
                            "save_interval=40")
SUITE_CLI_REQUESTS = 2
SUITE_RL_CLI_TRAIN = ("mode=train", "gradient_steps=100", "log_interval=100", "save_interval=100")
# AdaptDiffuser: 20 training steps, then one generation round (2000
# trajectories) and 20 fine-tuning steps at batch 32, saved once; a
# metric_value below every log p for the case where the shipped one keeps
# nothing on the synthetic data
ADAPT_CLI_TRAIN = ("mode=train", "diffusion_gradient_steps=20", "classifier_gradient_steps=20",
                   "log_interval=10", "save_interval=20")
ADAPT_CLI_FINETUNE = ("mode=finetune", "ft_max_rounds=1", "ft_target=500",
                      "ft_gradient_steps=20", "log_interval=10", "save_interval=20")
ADAPT_KEEP_ALL = -1e9
# Diffusion Veteran (configs/veteran/*) and DiffuserLite (configs/diffuserlite/*)
# through their CLIs, with no kernel on their path (the reference builds both
# planners on the plain blocks). MuJoCo at full width: Veteran 200 planner
# steps in two windows and 200 EV steps (its module constant patched down
# from the reference's 1,000,000), then 5 requests at 50 envs x 32
# candidates; DiffuserLite 200 steps in two windows (the inverse dynamics in
# the first), 2 batches of the config's 5000 reflow pairs, 100 reflow steps,
# then 5 R1 and 5 R2 requests at 50 envs. The other suites: 20 steps in two
# windows and a save, 2 requests. A request is held against the same
# request on the port's CPU path with the same explicit noise, at
# LITE_COMPARE_ENVS / VETERAN_COMPARE_ENVS envs (the CPU runs the whole
# candidate batch of each env).
VETERAN_CLI_TRAIN = ("mode=train", "planner_diffusion_gradient_steps=200", "log_interval=100",
                     "save_interval=100")
VETERAN_EV_STEPS = 200
VETERAN_EV_TRAIN = ("mode=train_expected_value", "log_interval=100", "save_interval=100")
SUITE_VETERAN_CLI_TRAIN = ("mode=train", "planner_diffusion_gradient_steps=20",
                           "log_interval=10", "save_interval=20")
SUITE_VETERAN_EV_STEPS = 20
SUITE_VETERAN_EV_TRAIN = ("mode=train_expected_value", "log_interval=10", "save_interval=20")
VETERAN_COMPARE_ENVS, SUITE_COMPARE_ENVS = 10, 2
LITE_CLI_TRAIN = ("mode=training", "diffusion_gradient_steps=200", "invdyn_gradient_steps=100",
                  "log_interval=100", "save_interval=200")
LITE_CLI_PREPARE = ("mode=prepare_dataset", "cond_dataset_size=10000")
LITE_CLI_REFLOW = ("mode=reflow", "reflow_gradient_steps=100", "log_interval=50",
                   "save_interval=100")
SUITE_LITE_IQL = ("mode=iql_training", "iql_gradient_steps=100", "log_interval=50",
                  "save_interval=100")
SUITE_LITE_TRAIN = ("mode=training", "diffusion_gradient_steps=20", "invdyn_gradient_steps=10",
                    "log_interval=10", "save_interval=20")
LITE_COMPARE_ENVS = 50
# SfBC, QGPO and SynthER (configs/{sfbc,qgpo,synther}/*) and the consistency
# policy through their entry points, no kernel on their path (MLPs). SfBC:
# 500 BC steps in 4 windows at 32 x 32 rows, then two in-sample-planning
# iterations of 200 critic steps (one Monte-Carlo re-evaluation of every
# path); QGPO: 500 BC steps, the support of every next state (batches of
# 5,000 states x K 16), 500 Q and 500 CEP steps in windows; SynthER MuJoCo:
# 500 diffusion steps, one 100,000-row generation batch of 128 ddpm steps,
# 1,000 TD3+BC steps; SynthER antmaze and kitchen: 100 steps, one 10,000-row
# batch, 200 TD3+BC steps, 2 requests. A request is held against the same
# request on the port's CPU path with the same explicit noise at the
# served 50 envs (SynthER's also one generation chunk of
# SYNTHER_COMPARE_ROWS rows).
SFBC_CLI_BC = ("mode=bc_training", "bc_gradient_steps=500", "log_interval=125",
               "save_interval=250")
SFBC_CLI_CRITIC = ("mode=critic_training", "q_training_iters=2", "critic_gradient_steps=200",
                   "log_interval=100")
QGPO_CLI_BC = ("mode=bc_training", "bc_gradient_steps=500", "log_interval=125",
               "save_interval=250")
QGPO_CLI_STAGE = ("q_gradient_steps=500", "cep_gradient_steps=500", "log_interval=125")
SYNTHER_CLI = {"mujoco": (("diffusion_gradient_steps=500", "log_interval=125",
                           "save_interval=250"), 100_000,
                          ("td3bc_gradient_steps=1000", "log_interval=250",
                           "save_interval=1000"), N_REQUESTS),
               "suite": (("diffusion_gradient_steps=100", "log_interval=50",
                          "save_interval=100"), 10_000,
                         ("td3bc_gradient_steps=200", "log_interval=100",
                          "save_interval=200"), SUITE_CLI_REQUESTS)}
SYNTHER_COMPARE_ROWS = 16
# SynthER's generation runs 128 ddpm steps of a 1024-wide net with no
# clipping, and at the chain's sample scale (|x| up to 1e4-1e5 after 500
# training steps; the JAX package's chain reaches the same scale on the
# same weights and draws, tests/test_torch_synther.py) float32 rounding
# alone is above 1e-3 (the card's and the CPU's float32 runs of a 16-row
# chunk differed by 4.2e-3 on the H100). So the chunk is held to a float64
# run of it: the card's error within this factor of the CPU's own float32
# error
GEN_ERR_FACTOR = 4.0
# the hermetic consistency-policy gate (tests/test_hermetic_parity.py:160):
# IQL, EDM and distillation steps at batch 128, the teacher's and the 2-NFE
# student's bars; then requests at 50 envs x 32 candidates
CP_STEPS, CP_BATCH, CP_TEACHER_BAR, CP_STUDENT_BAR = (2000, 3000, 2000), 128, 0.85, 0.80
CP_REQUESTS = (("cd", 2), ("edm", 5), ("edm_heun", 5))
# cuda_ms's first spin, ~50 ms at the H100's boost clock, and how many
# times it may grow 4x before a timing fails
SPIN_CYCLES, SPIN_TRIES = 100_000_000, 4
KERNELS = (fused_dit_block, fused_dit_block_bf16, fused_film_resblock, fused_solver_update)
# NVIDIA H100 SXM peaks (data sheet, dense): f32 outside the tensor cores,
# TF32 and BF16 on them, and HBM3 bandwidth
F32_TFLOPS, TF32_TFLOPS, BF16_TFLOPS, HBM_TBPS = 67.0, 495.0, 989.0, 3.35
# K1 and K3 compute each f32 product as three TF32 MMAs: their peak for it
TF32X3_TFLOPS = TF32_TFLOPS / 3


def phase(name):
    print(f"[chip_smoke] --- {name}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, the device
    alone. The host of a one-card machine is shared and slow: launched one
    by one, the plain blocks' ~25 launches per call (and the autograd
    passes' more) leave the device waiting on the host, and a spin before
    them does not help, as the launch queue lets the host run only so far
    ahead. So the calls are captured in one CUDA graph (after a warm-up
    call on a side stream, as capture asks) and the device runs them back
    to back from one launch. The graph is replayed once, then timed behind
    a device spin that must outlast the host's three enqueues (the device
    has not reached the start event when the host is done), else the spin
    is lengthened 4x, a few times, and then the timing fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        torch.cuda._sleep(spin)
        start.record()
        graph.replay()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cuda_ms.longer_spins += 1
        spin *= 4
    raise AssertionError(f"the device reached the start event before the host had enqueued "
                         f"the graph, {SPIN_TRIES} times: the time would include the host's")


cuda_ms.longer_spins = 0  # timings repeated with a longer spin, over the run


def seeded_tree(tree: dict, rng: np.random.Generator) -> dict:
    """Same structure, every leaf refilled with seeded normals: dense and
    conv kernels (flax layout, fan-in first) at std 1/sqrt(fan_in), norm
    scales at 1 + 0.1 N, other vectors at 0.1 N. Fresh adaLN-Zero weights
    are zero, which would make every block the identity and the net output 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
            continue
        z = rng.standard_normal(v.shape)
        if v.ndim >= 2:
            z = z / np.sqrt(np.prod(v.shape[:-1]))
        else:
            z = z * 0.1 + (1.0 if k == "scale" else 0.0)
        out[k] = z.astype(np.float32)
    return out


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def time_in_turns(fns: dict, iters: int, rounds: int = 1):
    """Device ms of each fn of `fns` (name -> callable), the median of 2 x
    `rounds` runs of `iters` calls, in turns: the dict's order, then the
    reverse (plain, kernel, kernel, plain), after a warm-up. Returns the
    medians and the runs, by name."""
    for f in fns.values():
        cuda_ms(f, 3)
    times = {name: [] for name in fns}
    for name in (list(fns) + list(fns)[::-1]) * rounds:
        times[name].append(cuda_ms(fns[name], iters))
    return {name: statistics.median(v) for name, v in times.items()}, times


def time_pair(kern, plain, iters: int, rounds: int = 1):
    """`time_in_turns` of a kernel and its plain version: (kernel ms, plain
    ms, runs)."""
    med, times = time_in_turns({"plain": plain, "kernel": kern}, iters, rounds)
    return med["kernel"], med["plain"], times


def errors(out, ref):
    err = (out - ref).abs()
    return err.max().item(), (err / ref.abs().clamp_min(1e-3)).max().item()


def check_device() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def build_kernels(dev):
    phase("build")
    seconds = build.build_libraries(["dit_block", "film_resblock"])
    load_dit_block_library()
    load_film_resblock_library()
    for name in ("dit_block", "film_resblock"):
        print(f"{name}.cu built in {seconds[name]:.2f} s (nvcc processes run in parallel)")
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print("  ptxas:", line.strip())
    for name in ("dit_block", "film_resblock"):
        mma = [ln for ln in build.sass(name).splitlines() if "HMMA" in ln or "HGMMA" in ln]
        print(f"{name} SASS: {len(mma)} tensor-core instructions (HMMA/HGMMA), e.g. "
              f"{mma[0].split(';')[0].split('*/')[-1].strip() if mma else '-'}")
        if not mma:
            raise AssertionError(f"{name}'s SASS has no tensor-core instruction")
    bf16 = [ln for ln in build.sass("dit_block").splitlines() if "HMMA.16816.F32.BF16" in ln]
    print(f"dit_block SASS: {len(bf16)} BF16 MMAs (HMMA.16816.F32.BF16, the BF16 route)")
    if not bf16:
        raise AssertionError("dit_block's SASS has no BF16 MMA: the BF16 route is not built")
    x = torch.zeros(1024, device=dev)
    for c_noise in (0.0, 1.0):  # two specialisations: with and without noise
        t0 = time.perf_counter()
        fused_solver_update(x, x, (1.0, 0.0, c_noise), 0)
        torch.cuda.synchronize()
        print(f"solver_update Triton kernel (noise={c_noise != 0}) compiled and run in "
              f"{time.perf_counter() - t0:.2f} s")


def bound(ops_ms: float, gbytes: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and `ops_ms`, the operations' time at the peak of the route
    that does them (ms)."""
    bytes_ms = gbytes / HBM_TBPS
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def dit_gflop(B, H, D) -> float:
    """Flops of one block: the four weight products (24 D^2 per row) and
    attention's two products (4 H D per row)."""
    return B * H * (24 * D * D + 4 * H * D) / 1e9


def dit_gbytes(B, H, D, x_bytes: int = 4, w_bytes: int = 4) -> float:
    """x and mod read, out written, the weights and biases read, once each;
    x, mod and out of `x_bytes`, weights and biases of `w_bytes` each."""
    return (x_bytes * (2 * B * H * D + 6 * B * D) + w_bytes * (12 * D * D + 9 * D)) / 1e9


def dit_bf16_ops_ms(B, H, D) -> float:
    """The BF16 route's operations at their peaks: the four weight products
    in BF16, attention's two in 3xTF32."""
    return B * H * 24 * D * D / 1e9 / BF16_TFLOPS + B * H * 4 * H * D / 1e9 / TF32X3_TFLOPS


def block_inputs(rng, dev, B, H, D, requires_grad=False):
    """Seeded f32 inputs of one DiT block: x, mod and the 8 weights and biases."""
    def t(*shape, std):
        z = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)
        return z.requires_grad_(requires_grad)

    x, mod = t(B, H, D, std=1.0), t(B, 6 * D, std=0.5)
    ws = [t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.1), t(D, D, std=D ** -0.5),
          t(D, std=0.1), t(D, 4 * D, std=D ** -0.5), t(4 * D, std=0.1),
          t(4 * D, D, std=(4 * D) ** -0.5), t(D, std=0.1)]
    return x, mod, ws


def check_kernel(dev) -> dict:
    phase("dit_block vs plain version")
    D, NH = 320, 10
    rng = np.random.default_rng(SEED)
    record = None
    # the DD plan's CFG batch; candidate evaluation; the antmaze configs' horizon
    for B, H, iters in ((100, 32, 50), (3200, 32, 5), (100, 64, 25)):
        x, mod, ws = block_inputs(rng, dev, B, H, D)
        out = fused_dit_block(x, mod, *ws, n_heads=NH)
        ref = dit_block_reference(x, mod, *ws, n_heads=NH)
        torch.cuda.synchronize()
        max_abs, max_rel = errors(out, ref)
        print(f"shape (B={B}, H={H}, D={D}, heads={NH}) f32: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f})", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)

        ms, plain_ms, times = time_pair(lambda: fused_dit_block(x, mod, *ws, n_heads=NH),
                                        lambda: dit_block_reference(x, mod, *ws, n_heads=NH),
                                        iters)
        gf, gb = dit_gflop(B, H, D), dit_gbytes(B, H, D)
        b = bound(gf / TF32X3_TFLOPS, gb)
        print(f"  device time per block (weights hot in L2): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({gf:.3f} GFLOP, {gb * 1e3:.2f} MB: kernel {gf / ms:.2f}, plain "
              f"{gf / plain_ms:.2f} TFLOP/s); bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"(3xTF32 at {TF32X3_TFLOPS:.0f} TFLOP/s): kernel at {b['bound_ms'] / ms:.1%} of "
              f"it (for reference, the flops' time at the f32 FFMA peak is "
              f"{gf / F32_TFLOPS / ms:.1%} of the kernel's, at the TF32 peak "
              f"{gf / TF32_TFLOPS / ms:.1%}) (runs {times['kernel']} / {times['plain']})",
              flush=True)
        if record is None:
            record = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b}
    return record


def check_kernel_bf16(dev) -> dict:
    """K1's BF16 route against its plain version; its time beside the f32
    route's (on the f32 weights) and the plain version's, in turns."""
    phase("dit_block BF16 route vs plain version")
    D, NH = 320, 10
    rng = np.random.default_rng(SEED + 10)
    record = None
    # the bf16 DD plan's call (f32 x and mod), all-BF16, candidate
    # evaluation, the antmaze horizon on the cluster, and the forward of a
    # `bf16_training` step (batch 64: x and mod BF16, cast by the engine)
    for B, H, route, iters in ((100, 32, "mixed", 50), (100, 32, "bf16", 50),
                               (3200, 32, "mixed", 5), (100, 64, "mixed", 25),
                               (64, 32, "bf16", 50)):
        x, mod, ws = block_inputs(rng, dev, B, H, D)
        wb = [w.to(torch.bfloat16) for w in ws]
        xb, modb = (x.to(torch.bfloat16), mod.to(torch.bfloat16)) if route == "bf16" else (x, mod)
        out = fused_dit_block_bf16(xb, modb, *wb, n_heads=NH)
        ref = dit_block_reference(xb, modb, *wb, n_heads=NH)
        torch.cuda.synchronize()
        if out.dtype != xb.dtype:
            raise AssertionError(f"the BF16 route returned {out.dtype} for {xb.dtype} x")
        out, ref = out.float(), ref.float()
        max_abs, max_rel = errors(out, ref)
        # the share of the limit used: |d| / (atol + rtol |ref|), as assert_close reads it
        used = ((out - ref).abs() / (BF16_ATOL + BF16_RTOL * ref.abs())).max().item()
        print(f"shape (B={B}, H={H}, D={D}, heads={NH}) {route}: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f}); "
              f"{used:.1%} of the limit ({BF16_ATOL} abs + {BF16_RTOL} rel)", flush=True)
        torch.testing.assert_close(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL)

        med, times = time_in_turns(
            {"plain": lambda: dit_block_reference(xb, modb, *wb, n_heads=NH),
             "bf16": lambda: fused_dit_block_bf16(xb, modb, *wb, n_heads=NH),
             "f32": lambda: fused_dit_block(x, mod, *ws, n_heads=NH)}, iters)
        gf = dit_gflop(B, H, D)
        gb = dit_gbytes(B, H, D, x_bytes=2 if route == "bf16" else 4, w_bytes=2)
        b = bound(dit_bf16_ops_ms(B, H, D), gb)
        print(f"  device time per block: BF16 route {med['bf16']:.4f} ms, f32 route "
              f"{med['f32']:.4f} ms, plain {med['plain']:.4f} ms ({gf:.3f} GFLOP, "
              f"{gb * 1e3:.2f} MB: {gf / med['bf16']:.2f} / {gf / med['f32']:.2f} / "
              f"{gf / med['plain']:.2f} TFLOP/s); BF16 bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} (products at {BF16_TFLOPS:.0f}, attention at "
              f"{TF32X3_TFLOPS:.0f} TFLOP/s): BF16 route at {b['bound_ms'] / med['bf16']:.1%} "
              f"of it (runs {times})", flush=True)
        if record is None:
            record = {"max_abs_err": max_abs, "ms": med["bf16"], "plain_ms": med["plain"], **b}
    return record


def film_gflop(B, H, Cin, Cout, K) -> float:
    """Multiply-adds x 2 of one block: conv1, conv2 and the 1x1 skip conv."""
    skip = Cin if Cin != Cout else 0
    return 2 * B * H * Cout * (K * Cin + K * Cout + skip) / 1e9


def film_args(rng, dev, B, H, Cin, Cout, K, requires_grad=False) -> list:
    """Seeded inputs of one U-Net block: x, emb, the two convs and norms,
    and the skip conv where Cin != Cout."""
    def t(*shape, std=1.0, mean=0.0):
        z = mean + rng.standard_normal(shape) * std
        return torch.from_numpy(z.astype(np.float32)).to(dev).requires_grad_(requires_grad)

    args = [t(B, H, Cin), t(B, Cout, std=0.5),
            t(K, Cin, Cout, std=(K * Cin) ** -0.5), t(Cout, std=0.1),
            t(Cout, std=0.1, mean=1.0), t(Cout, std=0.1),
            t(K, Cout, Cout, std=(K * Cout) ** -0.5), t(Cout, std=0.1),
            t(Cout, std=0.1, mean=1.0), t(Cout, std=0.1)]
    if Cin != Cout:
        args += [t(Cin, Cout, std=Cin ** -0.5), t(Cout, std=0.1)]
    return args


def check_film_kernel(dev, blocks=UNET_BLOCKS, net: str = "mujoco") -> dict:
    """K3 against its plain version at every distinct block shape of a
    U-Net (`blocks`, in the order the net runs them) at B = 3200: error,
    both times, TFLOP/s and the share of the 3xTF32 bound per shape, the
    thread-block plan (rows, samples, shared memory against the device's
    limit), and the sums over the net's blocks. Returns the record at the
    most frequent shape."""
    phase(f"film_resblock vs plain version ({net} U-Net)")
    B, K, G = 3200, 5, 8
    lib = load_film_resblock_library()
    smem_limit = lib.film_resblock_max_smem_optin(dev.index or 0)
    rng = np.random.default_rng(SEED + 2)
    worst, timed = 0.0, {}
    shapes = list(dict.fromkeys(blocks))
    most_frequent = max(shapes, key=blocks.count)
    for H, Cin, Cout in shapes:
        args = film_args(rng, dev, B, H, Cin, Cout, K)
        kw = dict(K=K, groups=G, eps=1e-6)
        out = fused_film_resblock(*args, **kw)
        ref = film_resblock_reference(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = errors(out, ref)
        worst = max(worst, max_abs)
        rows, smem = lib.film_resblock_block_rows(Cout), lib.film_resblock_smem_bytes(
            B, H, Cin, Cout, K, G)
        print(f"(B={B}, H={H}, Cin={Cin}, Cout={Cout}{', skip' if Cin != Cout else ''}) "
              f"x{blocks.count((H, Cin, Cout))}: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (max |ref| {ref.abs().max().item():.3f}); plan: "
              f"{rows}-row thread blocks of {rows // H} sample(s), {-(-B * H // rows)} blocks, "
              f"{smem} B of shared memory (device limit {smem_limit})", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
        if not 0 < smem <= smem_limit:
            raise AssertionError(f"film_resblock_smem_bytes {smem} outside (0, {smem_limit}]")
        ms, plain_ms, times = timed[(H, Cin, Cout)] = time_pair(
            lambda: fused_film_resblock(*args, **kw),
            lambda: film_resblock_reference(*args, **kw), 20)
        gf = film_gflop(B, H, Cin, Cout, K)
        print(f"  device time per block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({gf:.3f} GFLOP: kernel {gf / ms:.2f}, plain {gf / plain_ms:.2f} TFLOP/s; kernel "
              f"at {gf / TF32X3_TFLOPS / ms:.1%} of the 3xTF32 bound) (runs {times['kernel']} / "
              f"{times['plain']})", flush=True)
    total = {k: sum(timed[s][i] for s in blocks) for i, k in enumerate(("kernel", "plain"))}
    gf = sum(film_gflop(B, *s, K) for s in blocks)
    print(f"sum over the {len(blocks)} blocks of one U-Net call ({gf:.2f} GFLOP; 3xTF32 bound "
          f"{gf / TF32X3_TFLOPS:.4f} ms): kernel {total['kernel']:.4f} ms "
          f"({gf / total['kernel']:.2f} TFLOP/s, {gf / TF32X3_TFLOPS / total['kernel']:.1%} of "
          f"the bound), plain {total['plain']:.4f} ms ({gf / total['plain']:.2f} TFLOP/s); most "
          f"frequent shape {most_frequent}", flush=True)
    ms, plain_ms, _ = timed[most_frequent]
    H, Cin, Cout = most_frequent
    gbytes = 4 * (B * H * Cin + B * Cout + K * Cin * Cout + K * Cout * Cout
                  + (Cin + 1) * Cout * (Cin != Cout) + 6 * Cout + B * H * Cout) / 1e9
    record = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
              **bound(film_gflop(B, H, Cin, Cout, K) / TF32X3_TFLOPS, gbytes)}
    return record


def check_solver_kernel(dev) -> dict:
    phase("solver_update vs plain version")
    shape = (3200, 32, 23)
    rng = np.random.default_rng(SEED + 3)
    xt, eps = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
               for _ in range(2))
    # a real step: level 10 of 20 of the shipped Diffuser's ddpm sampler
    probe = DiffuserPipeline(17, 6, device="cpu")
    _, alphas, sigmas = probe.agent._sample_tables("uniform", 20)
    stds = torch.cat([torch.zeros(1), sigmas[:-1] / sigmas[1:]
                      * torch.sqrt(1 - (alphas[1:] / alphas[:-1]) ** 2)])
    coefs = ddpm_coefficients(10, alphas, sigmas, stds)
    print(f"coefficients (c_xt, c_eps, c_noise) = {coefs}")

    quiet = (coefs[0], coefs[1], 0.0)
    max_abs, _ = errors(fused_solver_update(xt, eps, quiet, 1),
                        solver_update_reference(xt, eps, quiet))
    print(f"c_noise = 0: max_abs_err {max_abs:.3e} (limit {SOLVER_ATOL})")
    if not max_abs <= SOLVER_ATOL:
        raise AssertionError("solver_update without noise disagrees with its plain version")

    out = fused_solver_update(xt, eps, coefs, 7)
    z = (out.double() - coefs[0] * xt.double() - coefs[1] * eps.double()) / coefs[2]
    mean, std = z.mean().item(), z.std().item()
    print(f"noise over {z.numel()} draws: mean {mean:.3e}, std {std:.6f} (limit {MOMENT_TOL})")
    if not (abs(mean) < MOMENT_TOL and abs(std - 1) < MOMENT_TOL):
        raise AssertionError("solver_update noise is not standard normal")
    same = torch.equal(out, fused_solver_update(xt, eps, coefs, 7))
    other = not torch.equal(out, fused_solver_update(xt, eps, coefs, 8))
    print(f"same seed, same output: {same}; another seed, another output: {other}")
    if not (same and other):
        raise AssertionError("solver_update noise is not a function of the seed")

    # the plain version draws from the default generator: a CUDA graph
    # (cuda_ms) captures only that one
    ms, plain_ms, times = time_pair(lambda: fused_solver_update(xt, eps, coefs, 7),
                                    lambda: solver_update_reference(xt, eps, coefs), 200)
    print(f"device time per step at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(runs {times['kernel']} / {times['plain']})")
    # xt and eps read, out written; ~6 flops per element besides the noise
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(6 * xt.numel() / 1e9 / F32_TFLOPS, 3 * 4 * xt.numel() / 1e9)}


def build_pipeline(args, dev, use_kernel: bool, weights: dict) -> DDPipeline:
    pipe = DDPipeline(
        obs_dim=args.task.obs_dim, act_dim=args.task.act_dim, horizon=args.task.horizon,
        emb_dim=args.emb_dim, d_model=args.d_model, n_heads=args.n_heads,
        depth=args.depth, label_dropout=args.label_dropout,
        predict_noise=args.predict_noise, next_obs_loss_weight=args.next_obs_loss_weight,
        ema_rate=args.ema_rate, diffusion_gradient_steps=args.diffusion_gradient_steps,
        invdyn_gradient_steps=args.invdyn_gradient_steps,
        solver=args.solver, sampling_steps=args.sampling_steps,
        w_cfg=args.task.w_cfg, target_return=args.task.target_return,
        temperature=args.temperature, use_pallas_block=use_kernel, rng=args.seed,
        device=dev,
    )
    pipe.load_jax_params(weights["params"], weights["ema_params"], weights["invdyn"])
    return pipe


def serve(pipe: DDPipeline, obs_batches, generator) -> list:
    """Serve one `act` request per batch; returns per-request ms."""
    lat = []
    for obs in obs_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act, info = pipe.act(obs, generator=generator)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        traj = info["traj"]
        if tuple(act.shape) != (obs.shape[0], pipe.act_dim):
            raise AssertionError(f"actions {tuple(act.shape)}")
        if not (torch.isfinite(act).all() and torch.isfinite(traj).all()):
            raise AssertionError("non-finite actions or plan")
        if act.abs().max().item() > 1.0:
            raise AssertionError("actions outside [-1, 1]")
        if not torch.equal(traj[:, 0], obs):
            raise AssertionError("plan's first state is not the observation")
    return lat


def dd_weights(args, rng, fourier_scale=None) -> dict:
    """Seeded weights in the JAX package's layout (shapes taken from a CPU
    build of the same config), for the converter to carry in. With
    `fourier_scale`, the Fourier frequencies of params and EMA are drawn at
    N(0, fourier_scale^2), as the init draws them."""
    probe = DDPipeline(obs_dim=args.task.obs_dim, act_dim=args.task.act_dim,
                       horizon=args.task.horizon, emb_dim=args.emb_dim, d_model=args.d_model,
                       n_heads=args.n_heads, depth=args.depth, device="cpu")
    weights = {
        "params": seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "invdyn": {"params": seeded_tree(jax_params_of(probe.invdyn.net), rng)},
    }
    if fourier_scale is not None:
        for k in ("params", "ema_params"):
            fourier = weights[k]["diffusion"]["params"]["FourierEmbedding_0"]
            fourier["freqs"] = (rng.standard_normal(fourier["freqs"].shape)
                                * fourier_scale).astype(np.float32)
    return weights


def plan_gap(traj, ref) -> tuple:
    """max and mean |traj - ref| over the plan's scale (max |ref|, at
    least 1), as tests/test_bf16_sampling.py reads it."""
    scale = max(ref.abs().max().item(), 1.0)
    d = (traj - ref).abs()
    return d.max().item() / scale, d.mean().item() / scale, scale


def use_kernels(pipe, on: bool) -> int:
    """Switch every fused block of a planner (the DiT blocks, the U-Net's
    residual blocks, in params and EMA) to its kernel or to its plain
    version; returns how many blocks were switched."""
    blocks = [m for net in (pipe.agent.params, pipe.agent.ema_params) for m in net.modules()
              if hasattr(m, "use_kernel")]
    for m in blocks:
        m.use_kernel = on
    return len(blocks)


def compare_dd_plan(pipe: DDPipeline, obs, dev):
    """One DD plan through K1 against the same plan through the plain block
    (the pipeline's blocks switched), the same explicit noise: the plan and
    the actions within PLAN_ATOL."""
    E, H, O = obs.shape[0], pipe.horizon, pipe.obs_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = (torch.randn((E, H, O), generator=gen, device=dev),
             torch.randn((pipe.sampling_steps, E, H, O), generator=gen, device=dev))
    act_k, info_k = pipe.act(obs, noise=noise)
    use_kernels(pipe, False)
    act_p, info_p = pipe.act(obs, noise=noise)
    use_kernels(pipe, True)
    d_traj = (info_k["traj"] - info_p["traj"]).abs().max().item()
    d_act = (act_k - act_p).abs().max().item()
    # seeded weights can take a plan far out of the data's range (antmaze's
    # ddim plan reaches |x| ~ 600, where an f32 ulp is 6e-5): beyond 100 the
    # plan is held to 1e-5 of its scale
    scale = info_p["traj"].abs().max().item()
    tol = PLAN_ATOL * max(1.0, scale / 100)
    print(f"plan kernel vs plain: max |traj diff| {d_traj:.3e}, max |act diff| {d_act:.3e} "
          f"(max |traj| {scale:.3f}; atol {tol:.3g})", flush=True)
    if not (d_traj <= tol and d_act <= PLAN_ATOL):
        raise AssertionError("plan through the kernel disagrees with the plain version")


def compare_diffuser_plan(pipe, obs, K: int, dev):
    """One Diffuser plan through K3 against the same plan through the plain
    block, the same explicit noise: every candidate and its log p within
    PLAN_ATOL, the chosen index wherever the top two are apart, the actions
    where it is the same."""
    E, D = obs.shape[0], pipe.obs_dim + pipe.act_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (K * E, pipe.horizon, D)
    noise = (torch.randn(shape, generator=gen, device=dev),
             torch.randn((pipe.sampling_steps,) + shape, generator=gen, device=dev))
    t0 = time.perf_counter()
    act_k, info_k = pipe.act(obs, num_candidates=K, noise=noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    use_kernels(pipe, False)
    act_p, info_p = pipe.act(obs, num_candidates=K, noise=noise)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    use_kernels(pipe, True)
    d_traj = (info_k["candidates"] - info_p["candidates"]).abs().max().item()
    d_logp = (info_k["candidate_logp"] - info_p["candidate_logp"]).abs().max().item()
    top2 = info_p["candidate_logp"].topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > PLAN_ATOL
    same_idx = info_k["idx"] == info_p["idx"]
    d_act = (act_k - act_p).abs()[same_idx].max().item() if same_idx.any() else 0.0
    print(f"plan kernel vs plain ({1e3 * (t1 - t0):.1f} / {1e3 * (t2 - t1):.1f} ms): max "
          f"|candidate diff| {d_traj:.3e}, max |logp diff| {d_logp:.3e}, chosen index equal in "
          f"{int(same_idx.sum())}/{E} envs ({int(clear.sum())} with a top-two gap > "
          f"{PLAN_ATOL}), max |act diff| where equal {d_act:.3e} (max |traj| "
          f"{info_p['candidates'].abs().max().item():.3f}; atol {PLAN_ATOL})", flush=True)
    if not (d_traj <= PLAN_ATOL and d_logp <= PLAN_ATOL and d_act <= PLAN_ATOL
            and bool(same_idx[clear].all())):
        raise AssertionError("plan through the kernel disagrees with the plain version")


def check_slice(dev, bench: str = "mujoco", n_requests: int = N_REQUESTS) -> int:
    phase(f"slice: DD planning ({bench})")
    args = load_config(ROOT / "configs/dd" / bench, bench)
    E, H, O = args.num_envs, args.task.horizon, args.task.obs_dim
    rng = np.random.default_rng(SEED + 1)
    weights = dd_weights(args, rng)
    pipe = build_pipeline(args, dev, args.use_pallas_block, weights)
    plain = build_pipeline(args, dev, False, weights)
    print(f"config: obs {O} act {args.task.act_dim} horizon {H} d_model {args.d_model} "
          f"heads {args.n_heads} depth {args.depth} {args.solver} x {args.sampling_steps} "
          f"w_cfg {args.task.w_cfg} target_return {args.task.target_return} envs {E} "
          f"(CFG batch {2 * E}) use_pallas_block {args.use_pallas_block}")
    if not args.use_pallas_block:
        raise AssertionError("the shipped config must turn the fused block on")

    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(n_requests + 1)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cold = serve(pipe, obs[:1], gen)  # first request: allocator and library warm-up

    reset_counts()
    lat = serve(pipe, obs[1:], gen)
    launches, bf16_launches = fused_dit_block.launches, fused_dit_block_bf16.launches
    expected = n_requests * args.sampling_steps * args.depth
    print(f"{n_requests} requests x {E} envs: latency ms {[round(v, 3) for v in lat]} "
          f"(median {statistics.median(lat):.3f}; cold first request {cold[0]:.3f}); "
          f"dit_block launches {launches} (expected {expected}), BF16 route {bf16_launches}")
    if launches != expected or bf16_launches:
        raise AssertionError(f"dit_block launched {launches} times, expected {expected} "
                             f"(BF16 route {bf16_launches}, expected 0)")

    plain_lat = serve(plain, obs[1:], gen)
    print(f"same requests through the plain block: latency ms "
          f"{[round(v, 3) for v in plain_lat]} (median {statistics.median(plain_lat):.3f})")

    compare_dd_plan(pipe, obs[1], dev)
    return launches


def check_slice_bf16(dev, bench: str = "mujoco", n_requests: int = N_REQUESTS) -> int:
    """DD planning with `bf16_sampling=true` from the config, through
    `setup_mesh`: the BF16 route's launches, latency beside f32, and the
    bf16 plan against the f32 plan (held to the JAX package's bounds on the
    mujoco config; read on antmaze, whose seeded ddim plans reach |x| of
    hundreds). Returns the BF16 route's launches."""
    phase(f"slice: DD planning with bf16_sampling ({bench})")
    args = load_config(ROOT / "configs/dd" / bench, bench, overrides=["bf16_sampling=true"])
    try:
        setup_mesh(args)
        if not DiffusionModel.bf16_sampling:
            raise AssertionError("bf16_sampling=true did not reach the engines")
        E, H, O = args.num_envs, args.task.horizon, args.task.obs_dim
        rng = np.random.default_rng(SEED + 11)
        pipe = build_pipeline(args, dev, args.use_pallas_block, dd_weights(args, rng))
        obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
               for _ in range(n_requests + 1)]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cold = serve(pipe, obs[:1], gen)

        reset_counts()
        lat = serve(pipe, obs[1:], gen)
        launches, f32_launches = fused_dit_block_bf16.launches, fused_dit_block.launches
        expected = n_requests * args.sampling_steps * args.depth
        # the same requests in f32: the instance flag hides the class's
        pipe.agent.bf16_sampling = False
        f32_lat = serve(pipe, obs[1:], gen)
        print(f"{n_requests} requests x {E} envs (horizon {H}) in bf16: latency ms "
              f"{[round(v, 3) for v in lat]} (median {statistics.median(lat):.3f}; cold first "
              f"request {cold[0]:.3f}); the same requests in f32: "
              f"{[round(v, 3) for v in f32_lat]} (median {statistics.median(f32_lat):.3f}); "
              f"BF16 route launches {launches} (expected {expected}), f32 route {f32_launches}",
              flush=True)
        if launches != expected or f32_launches:
            raise AssertionError(f"bf16 planning launched the BF16 route {launches} times "
                                 f"(expected {expected}) and the f32 route {f32_launches} times")

        # one plan, bf16 against f32, same weights and explicit noise
        shape = (E, H, O)
        noise = (torch.randn(shape, generator=gen, device=dev),
                 torch.randn((args.sampling_steps,) + shape, generator=gen, device=dev))
        act32, info32 = pipe.act(obs[1], noise=noise)
        del pipe.agent.bf16_sampling
        act16, info16 = pipe.act(obs[1], noise=noise)
        d_max, d_mean, scale = plan_gap(info16["traj"], info32["traj"])
        print(f"plan bf16 against f32: max |diff| / scale {d_max:.3e}, mean {d_mean:.3e} (scale "
              f"{scale:.3f}; limits {BF16_PLAN_MAX}, {BF16_PLAN_MEAN}{', read only' if bench != 'mujoco' else ''}); "
              f"max |act diff| {(act16 - act32).abs().max().item():.3e}", flush=True)
        if bench == "mujoco" and not (d_max < BF16_PLAN_MAX and d_mean < BF16_PLAN_MEAN):
            raise AssertionError("the bf16 plan is not within bf16 bounds of the f32 plan")
        if bench != "mujoco":
            return launches
        # read only: the same plan with the Fourier frequencies at their init
        # scale, where bf16 rounds 2 pi freqs (up to ~300) by up to 1
        wide = build_pipeline(args, dev, True, dd_weights(args, np.random.default_rng(SEED + 11),
                                                          16.0))
        wide.agent.bf16_sampling = False
        _, w32 = wide.act(obs[1], noise=noise)
        del wide.agent.bf16_sampling
        _, w16 = wide.act(obs[1], noise=noise)
        g_max, g_mean, g_scale = plan_gap(w16["traj"], w32["traj"])
        print(f"read only, Fourier frequencies at N(0, 16^2): plan bf16 against f32 max |diff| / "
              f"scale {g_max:.3e}, mean {g_mean:.3e} (scale {g_scale:.3f})", flush=True)
        return launches
    finally:
        DiffusionModel.bf16_sampling = False


def serve_diffuser(pipe: DiffuserPipeline, obs_batches, K: int, generator) -> list:
    """Serve one Diffuser `act` request per batch (K candidates per env);
    returns per-request ms."""
    lat = []
    for obs in obs_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act, info = pipe.act(obs, num_candidates=K, generator=generator)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if tuple(act.shape) != (obs.shape[0], pipe.act_dim):
            raise AssertionError(f"actions {tuple(act.shape)}")
        if not (torch.isfinite(act).all() and torch.isfinite(info["candidates"]).all()
                and torch.isfinite(info["candidate_logp"]).all()):
            raise AssertionError("non-finite actions, plans or log p")
        if act.abs().max().item() > 1.0:
            raise AssertionError("actions outside [-1, 1]")
        if not torch.equal(info["traj"][:, 0, :pipe.obs_dim], obs):
            raise AssertionError("plan's first state is not the observation")
    return lat


def diffuser_setup(args, rng):
    """The Diffuser pipeline's keyword arguments from its config, and seeded
    weights in the JAX package's layout (shapes taken from a CPU build of
    the same config), for the converter to carry in."""
    kw = dict(obs_dim=args.task.obs_dim, act_dim=args.task.act_dim, horizon=args.task.horizon,
              model_dim=args.model_dim, dim_mult=tuple(args.task.dim_mult),
              diffusion_steps=args.diffusion_steps, sampling_steps=args.sampling_steps,
              solver=args.solver, predict_noise=args.predict_noise,
              action_loss_weight=args.action_loss_weight, discount=args.discount,
              ema_rate=args.ema_rate, diffusion_gradient_steps=args.diffusion_gradient_steps,
              classifier_gradient_steps=args.classifier_gradient_steps,
              w_cg=args.task.w_cg, temperature=args.temperature, rng=args.seed)
    if "terminal_penalty" in args:  # the MuJoCo configs' (stored, read by nothing)
        kw["terminal_penalty"] = args.terminal_penalty
    probe = DiffuserPipeline(**kw, device="cpu")
    weights = {
        "params": seeded_tree(agent_params_of(probe.agent.params), rng),
        "ema_params": seeded_tree(agent_params_of(probe.agent.ema_params), rng),
        "cls_params": {"params": seeded_tree(jax_params_of(probe.classifier.params), rng)},
        "cls_ema_params": {"params": seeded_tree(jax_params_of(probe.classifier.ema_params),
                                                 rng)},
    }
    return kw, weights


def check_diffuser_slice(dev):
    """Returns (K3 launches in the 5 served requests, K2 launches in the
    fused-update request)."""
    phase("slice: Diffuser planning")
    args = load_config(ROOT / "configs/diffuser/mujoco", "mujoco")
    E, K, O, A = args.num_envs, args.num_candidates, args.task.obs_dim, args.task.act_dim
    rng = np.random.default_rng(SEED + 4)
    kw, weights = diffuser_setup(args, rng)
    pipe = DiffuserPipeline(**kw, use_pallas_block=True, device=dev)
    plain = DiffuserPipeline(**kw, use_pallas_block=False, device=dev)
    for p in (pipe, plain):
        p.load_jax_params(**weights)
    print(f"config: obs {O} act {A} horizon {args.task.horizon} model_dim {args.model_dim} "
          f"dim_mult {tuple(args.task.dim_mult)} {args.solver} x {args.sampling_steps} "
          f"(T={args.diffusion_steps}) predict_noise {args.predict_noise} w_cg {args.task.w_cg} "
          f"temperature {args.temperature} envs {E} x candidates {K} = {E * K} trajectories")

    # the block shapes the main path gives K3, seen on the way in
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape[1:]) + (
        m.conv1.kernel.shape[-1],))) for b in pipe.agent.ema_params["diffusion"].blocks]
    obs = [torch.from_numpy(rng.standard_normal((E, O)).astype(np.float32)).to(dev)
           for _ in range(N_REQUESTS + 1)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cold = serve_diffuser(pipe, obs[:1], K, gen)  # first request: warm-up
    for h in hooks:
        h.remove()
    if seen[:len(UNET_BLOCKS)] != UNET_BLOCKS:
        raise AssertionError(f"U-Net block shapes {seen[:16]} are not {UNET_BLOCKS}")

    reset_counts()
    lat = serve_diffuser(pipe, obs[1:], K, gen)
    k3 = fused_film_resblock.launches
    expected = N_REQUESTS * args.sampling_steps * len(UNET_BLOCKS)
    print(f"{N_REQUESTS} requests x {E} envs x {K} candidates: latency ms "
          f"{[round(v, 3) for v in lat]} (median {statistics.median(lat):.3f}; cold first "
          f"request {cold[0]:.3f}); film_resblock launches {k3} (expected {expected})")
    if k3 != expected:
        raise AssertionError(f"film_resblock launched {k3} times, expected {expected}")

    plain_lat = serve_diffuser(plain, obs[1:], K, gen)
    print(f"same requests through the plain block: latency ms "
          f"{[round(v, 3) for v in plain_lat]} (median {statistics.median(plain_lat):.3f})")

    compare_diffuser_plan(pipe, obs[1], K, dev)

    # one request through the fused solver update too
    pipe.fused_update = True
    reset_counts()
    fused_lat = serve_diffuser(pipe, obs[1:2], K, gen)
    k2 = fused_solver_update.launches
    print(f"1 request with fused_update: latency {fused_lat[0]:.3f} ms (first, includes plan "
          f"setup); solver_update launches {k2} (expected {args.sampling_steps}), "
          f"film_resblock launches {fused_film_resblock.launches}")
    if k2 != args.sampling_steps:
        raise AssertionError(f"solver_update launched {k2} times, expected {args.sampling_steps}")
    return k3, k2


def check_kernel_autograd(dev, H: int = 32, config: str = "mujoco") -> dict:
    """K1 through its autograd Function at DD's training shape (batch 64,
    the `config`'s horizon H; H = 64 runs on 2-block clusters): forward
    against the plain version, gradients, and times."""
    phase(f"dit_block under autograd at DD's training shape ({config}: H = {H})")
    B, D, NH = 64, 320, 10
    rng = np.random.default_rng(SEED + 5)
    x, mod, ws = block_inputs(rng, dev, B, H, D, requires_grad=True)
    inputs = [x, mod, *ws]
    g = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(dev)
    out = dit_block_op(*inputs, n_heads=NH)
    ref = dit_block_reference(*inputs, n_heads=NH)
    grads = torch.autograd.grad(out, inputs, g)
    ref_grads = torch.autograd.grad(ref, inputs, g)
    torch.cuda.synchronize()
    max_abs, max_rel = errors(out.detach(), ref.detach())
    g_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(grads, ref_grads))
    print(f"(B={B}, H={H}, D={D}, heads={NH}) forward through the Function: max_abs_err "
          f"{max_abs:.3e} max_rel_err {max_rel:.3e}; gradients of all 10 inputs against the "
          f"plain version's: max error {g_err:.3e} of max |grad| (the backward recomputes the "
          f"plain version from the same inputs)", flush=True)
    torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    if g_err > BLOCK_RTOL:
        raise AssertionError("the Function's gradients disagree with the plain version's")
    # the graphs of `out` and `ref` hold the inputs' gradient accumulators on
    # this stream; the timed backward passes are captured on another (cuda_ms)
    del out, ref

    with torch.no_grad():
        ms, plain_ms, times = time_pair(lambda: fused_dit_block(x, mod, *ws, n_heads=NH),
                                        lambda: dit_block_reference(x, mod, *ws, n_heads=NH),
                                        50, rounds=3)
    fb_ms, fb_plain_ms, fb_times = time_pair(
        lambda: torch.autograd.grad(dit_block_op(*inputs, n_heads=NH), inputs, g),
        lambda: torch.autograd.grad(dit_block_reference(*inputs, n_heads=NH), inputs, g), 20,
        rounds=3)
    gf, gb = dit_gflop(B, H, D), dit_gbytes(B, H, D)
    b = bound(gf / TF32X3_TFLOPS, gb)
    print(f"  forward ({gf:.3f} GFLOP, {gb * 1e3:.2f} MB): kernel {ms:.4f} ms ({gf / ms:.2f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms ({gf / plain_ms:.2f}); bound {b['bound_ms']:.4f} ms "
          f"by {b['bound_by']} (3xTF32): kernel at {b['bound_ms'] / ms:.1%} of it (runs "
          f"{times['kernel']} / {times['plain']})", flush=True)
    print(f"  forward + backward (the backward ~2x the forward's {gf:.3f} GFLOP, plain f32; the "
          f"kernel path recomputes the forward in it): kernel path {fb_ms:.4f} ms, plain "
          f"{fb_plain_ms:.4f} ms (runs {fb_times['kernel']} / {fb_times['plain']})", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "fb_ms": fb_ms,
            "fb_plain_ms": fb_plain_ms, **b}


def check_film_autograd(dev, B: int, blocks=UNET_BLOCKS):
    """K3 through its autograd Function at every distinct block shape of a
    U-Net (`blocks`) at the training batch B: the forward against the plain
    version (BLOCK_ATOL / BLOCK_RTOL) and the gradients of every input."""
    rng = np.random.default_rng(SEED + 9)
    kw = dict(K=5, groups=8, eps=1e-6)
    worst = worst_g = 0.0
    for H, Cin, Cout in dict.fromkeys(blocks):
        inputs = film_args(rng, dev, B, H, Cin, Cout, kw["K"], requires_grad=True)
        g = torch.from_numpy(rng.standard_normal((B, H, Cout)).astype(np.float32)).to(dev)
        out = film_resblock_op(*inputs, **kw)
        ref = film_resblock_reference(*inputs, **kw)
        grads = torch.autograd.grad(out, inputs, g)
        ref_grads = torch.autograd.grad(ref, inputs, g)
        max_abs, max_rel = errors(out.detach(), ref.detach())
        g_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(grads, ref_grads))
        print(f"  film_resblock_op (B={B}, H={H}, Cin={Cin}, Cout={Cout}): forward max_abs_err "
              f"{max_abs:.3e} max_rel_err {max_rel:.3e}; gradients of all {len(inputs)} inputs: "
              f"max error {g_err:.3e} of max |grad|", flush=True)
        torch.testing.assert_close(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
        if g_err > BLOCK_RTOL:
            raise AssertionError("K3's Function's gradients disagree with the plain version's")
        worst, worst_g = max(worst, max_abs), max(worst_g, g_err)
    print(f"K3 under autograd at B={B}, all {len(set(blocks))} shapes: forward max_abs_err "
          f"{worst:.3e}, gradients {worst_g:.3e} (limit {BLOCK_RTOL})", flush=True)


def train_batches(rng, n: int, B: int, H: int, O: int, A: int, dev, val_scale: float) -> list:
    """n seeded synthetic batches on the device: states N(0, 1), actions
    U(-1, 1), values U(0, val_scale) (DD) or N(0, 1) (Diffuser, val_scale 0)."""
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return [{"obs": {"state": f(rng.standard_normal((B, H, O)))},
             "act": f(rng.uniform(-1, 1, (B, H, A))),
             "val": f(rng.uniform(0, val_scale, (B, 1)) if val_scale
                      else rng.standard_normal((B, 1)))} for _ in range(n)]


def step_ms(pipes: dict, batches: list) -> dict:
    """Per-step time of `train_step` (CUDA events around each step, host
    enqueue included), TIMED_STEPS per path in turns: the dict's order, then
    the reverse (kernel, plain, plain, kernel), after one warm-up step each;
    draws from the engines' generators."""
    for p in pipes.values():
        p.train_step(batches[0])
    times = {k: [] for k in pipes}
    n = TIMED_STEPS // 2
    for k in list(pipes) + list(pipes)[::-1]:
        for i in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            pipes[k].train_step(batches[i % len(batches)])
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return times


def compare_training(logs_k: list, logs_p: list, keys):
    """Per-step logs, kernel path against plain: finite, losses within
    LOSS_RTOL and grad norms within GRAD_NORM_RTOL."""
    for k in keys:
        a = torch.stack([lg[k] for lg in logs_k])
        b = torch.stack([lg[k] for lg in logs_p])
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite {k} in training")
        rel = ((a - b).abs() / b.abs()).max().item()
        limit = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        print(f"  {k}: kernel path {[round(v, 5) for v in a.tolist()]}; max relative "
              f"difference to plain {rel:.3e} (limit {limit})", flush=True)
        if rel > limit:
            raise AssertionError(f"training through the kernel disagrees with the plain "
                                 f"version in {k}")


def max_drift(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a.parameters(), b.parameters()))


def check_dd_training(dev):
    """Returns (K1 and K2 launches in the 20 training steps, ms per step by
    path)."""
    phase("DD training")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    H, O, A, B = args.task.horizon, args.task.obs_dim, args.task.act_dim, args.batch_size
    rng = np.random.default_rng(SEED + 6)
    weights = dd_weights(args, rng)
    pipes = {"kernel": build_pipeline(args, dev, True, weights),
             "plain": build_pipeline(args, dev, False, weights)}
    pipe, plain = pipes["kernel"], pipes["plain"]
    n = DD_TRAIN_STEPS
    batches = train_batches(rng, n, B, H, O, A, dev, pipe.return_scale)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lo, hi = pipe.agent.t_diffusion
    noise = [(torch.rand(B, generator=gen, device=dev) * (hi - lo) + lo,
              torch.randn((B, H, O), generator=gen, device=dev),
              (torch.rand(B, generator=gen, device=dev) > args.label_dropout).float())
             for _ in range(n)]
    print(f"config: obs {O} act {A} horizon {H} d_model {args.d_model} heads {args.n_heads} "
          f"depth {args.depth} batch {B} (B*H = {B * H} tokens) ema_rate {args.ema_rate} "
          f"cosine over {args.diffusion_gradient_steps} steps; {n} steps per path")

    # the first step's gradients, through K1 and through the plain block
    grads = []
    for p in (pipe, plain):
        val = batches[0]["val"] / p.return_scale + p.val_shift
        p.agent.loss_fn(p.agent.params, batches[0]["obs"]["state"], val,
                        noise=noise[0]).backward()
        grads.append([q.grad.clone() for q in p.agent.params.parameters() if q.grad is not None])
        p.agent.params.zero_grad(set_to_none=True)
    scale = max(g.abs().max().item() for g in grads[1])
    g_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"first step's gradients, kernel path against plain: max |diff| {g_err:.3e} (max "
          f"|grad| {scale:.3f})", flush=True)

    reset_counts()
    logs_k = [pipe.train_step(b, noise=z) for b, z in zip(batches, noise)]
    torch.cuda.synchronize()
    k1, k2 = fused_dit_block.launches, fused_solver_update.launches
    expected = n * args.depth
    print(f"{n} train_steps through K1: dit_block launches {k1} (expected {expected}), "
          f"solver_update launches {k2} (expected 0: a sampler step)", flush=True)
    if k1 != expected:
        raise AssertionError(f"dit_block launched {k1} times in training, expected {expected}")
    if k2:
        raise AssertionError(f"solver_update launched {k2} times in training, expected 0")
    if any("invdyn_loss" not in lg for lg in logs_k):
        raise AssertionError("train_step logged no invdyn_loss")
    logs_p = [plain.train_step(b, noise=z) for b, z in zip(batches, noise)]
    compare_training(logs_k, logs_p, ("loss", "grad_norm", "invdyn_loss"))
    print(f"  params' final drift, kernel path against plain: max |diff| "
          f"{max_drift(pipe.agent.params, plain.agent.params):.3e} (EMA "
          f"{max_drift(pipe.agent.ema_params, plain.agent.ema_params):.3e}; lr "
          f"{args.get('lr', 2e-4)} per Adam step)", flush=True)

    times = step_ms(pipes, batches)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"ms per train_step (median of {TIMED_STEPS}): kernel {med['kernel']:.3f}, plain "
          f"{med['plain']:.3f} (runs {[round(v, 3) for v in times['kernel']]} / "
          f"{[round(v, 3) for v in times['plain']]})", flush=True)

    # the trained EMA plans
    obs = torch.from_numpy(rng.standard_normal((args.num_envs, O)).astype(np.float32)).to(dev)
    lat = serve(pipe, [obs], gen)
    print(f"one act from the trained EMA ({args.num_envs} envs): {lat[0]:.3f} ms", flush=True)
    return k1, k2, med


def check_dd_training_bf16(dev):
    """DD training with `bf16_training=true` from the config, through
    `setup_mesh`, against the same steps in f32. Returns (BF16 route
    launches in the steps, ms per step by path)."""
    phase("DD training with bf16_training")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco", overrides=["bf16_training=true"])
    try:
        setup_mesh(args)
        if not DiffusionModel.bf16_training:
            raise AssertionError("bf16_training=true did not reach the engines")
        H, O, A, B = args.task.horizon, args.task.obs_dim, args.task.act_dim, args.batch_size
        rng = np.random.default_rng(SEED + 12)
        weights = dd_weights(args, rng, 16.0)
        pipes = {"bf16": build_pipeline(args, dev, True, weights),
                 "f32": build_pipeline(args, dev, True, weights)}
        pipes["f32"].agent.bf16_training = False  # the instance flag hides the class's
        n = BF16_TRAIN_STEPS
        batches = train_batches(rng, n, B, H, O, A, dev, pipes["bf16"].return_scale)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        lo, hi = pipes["bf16"].agent.t_diffusion
        noise = [(torch.rand(B, generator=gen, device=dev) * (hi - lo) + lo,
                  torch.randn((B, H, O), generator=gen, device=dev),
                  (torch.rand(B, generator=gen, device=dev) > args.label_dropout).float())
                 for _ in range(n)]

        reset_counts()
        logs16 = [pipes["bf16"].train_step(b, noise=z) for b, z in zip(batches, noise)]
        torch.cuda.synchronize()
        launches, f32_launches = fused_dit_block_bf16.launches, fused_dit_block.launches
        print(f"{n} train_steps with bf16_training: BF16 route launches {launches} (expected "
              f"{n * args.depth}), f32 route {f32_launches}", flush=True)
        if launches != n * args.depth or f32_launches:
            raise AssertionError(f"bf16 training launched the BF16 route {launches} times and "
                                 f"the f32 route {f32_launches} times")
        logs32 = [pipes["f32"].train_step(b, noise=z) for b, z in zip(batches, noise)]
        for k in ("loss", "grad_norm", "invdyn_loss"):
            a = torch.stack([lg[k] for lg in logs16])
            b = torch.stack([lg[k] for lg in logs32])
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"non-finite {k} in bf16 training")
            rel = ((a - b).abs() / b.abs()).max().item()
            print(f"  {k}: bf16 {[round(v, 5) for v in a.tolist()]}; max relative difference "
                  f"to f32 {rel:.3e}{f' (limit {BF16_LOSS_RTOL})' if k == 'loss' else ''}",
                  flush=True)
            if k == "loss" and rel > BF16_LOSS_RTOL:
                raise AssertionError("bf16 training losses are not within 5 % of f32's")
        agent = pipes["bf16"].agent
        state = [v for st in agent.optimizer.optimizer.state.values() for v in st.values()
                 if torch.is_tensor(v) and v.is_floating_point()]
        kinds = {str(t.dtype) for t in (*agent.params.parameters(),
                                         *agent.ema_params.parameters(), *state)}
        print(f"  params, EMA and Adam state after bf16 training: {sorted(kinds)}; drift "
              f"from the f32 run {max_drift(agent.params, pipes['f32'].agent.params):.3e}",
              flush=True)
        if kinds != {"torch.float32"}:
            raise AssertionError("bf16 training left params, EMA or optimizer state not f32")

        times = step_ms(pipes, batches)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"ms per train_step (median of {TIMED_STEPS}): bf16 {med['bf16']:.3f}, f32 "
              f"{med['f32']:.3f} (runs {[round(v, 3) for v in times['bf16']]} / "
              f"{[round(v, 3) for v in times['f32']]})", flush=True)
        return launches, med
    finally:
        DiffusionModel.bf16_training = False


def check_goal2d(dev) -> dict:
    """The hermetic DD gate on the card: train on the Goal2D behavior data
    through K1, then score f32 and bf16 planning from the same EMA."""
    phase("Goal2D score: hermetic DD trained on the card")
    ds = D4RLMuJoCoDataset(goal2d_sequence_dataset(n_episodes=1000, seed=0),
                           terminal_penalty=0.0, horizon=8, max_path_length=40, discount=0.99,
                           device=dev)
    pipe = DDPipeline(obs_dim=2, act_dim=2, horizon=8, emb_dim=64, d_model=128, n_heads=4,
                      depth=2, return_scale=40.0, val_shift=1.0, sampling_steps=10, w_cfg=1.2,
                      target_return=1.0, temperature=0.5, diffusion_gradient_steps=GOAL2D_STEPS,
                      invdyn_gradient_steps=GOAL2D_STEPS, use_pallas_block=True, rng=0,
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(GOAL2D_STEPS):
        log = pipe.train_step(ds.sample_batch(gen, 64))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k_train = fused_dit_block.launches
    print(f"{GOAL2D_STEPS} train_steps (batch 64 from the device sampler, {len(ds)} windows): "
          f"{train_s:.1f} s, last loss {log['loss'].item():.4f}; dit_block launches {k_train} "
          f"(expected {2 * GOAL2D_STEPS}), BF16 route {fused_dit_block_bf16.launches}",
          flush=True)
    if k_train != 2 * GOAL2D_STEPS or fused_dit_block_bf16.launches:
        raise AssertionError("the Goal2D training did not run through K1's f32 route")

    norm = ds.get_normalizer()
    score = normalized_score_fn(device=dev)
    result = {}
    for name in ("f32", "bf16"):
        pipe.agent.bf16_sampling = name == "bf16"
        reset_counts()
        t0 = time.perf_counter()
        ret = evaluate_policy(lambda g, obs: pipe.act(norm.normalize(obs), generator=g)[0],
                              num_envs=64, seed=1, device=dev)
        result[name] = score(ret)
        print(f"{name} planning: normalized score {result[name]:.4f} (return {ret:.4f}; anchors "
              f"{score.anchors}); 40 plans in {time.perf_counter() - t0:.2f} s; dit_block "
              f"launches f32 {fused_dit_block.launches}, BF16 {fused_dit_block_bf16.launches}",
              flush=True)
        want = 40 * 10 * 2
        if (fused_dit_block_bf16.launches, fused_dit_block.launches) != (
                (want, 0) if name == "bf16" else (0, want)):
            raise AssertionError(f"{name} planning did not launch K1's {name} route {want} times")
    del pipe.agent.bf16_sampling
    if not min(result.values()) >= GOAL2D_BAR:
        raise AssertionError(f"Goal2D score {result} below {GOAL2D_BAR}")
    return result


def check_diffuser_training(dev):
    """Returns (K3 and K2 launches in the 10 training steps, ms per step by
    path)."""
    phase("Diffuser training")
    args = load_config(ROOT / "configs/diffuser/mujoco", "mujoco")
    H, O, A, B = args.task.horizon, args.task.obs_dim, args.task.act_dim, args.batch_size
    rng = np.random.default_rng(SEED + 7)
    kw, weights = diffuser_setup(args, rng)
    pipes = {k: DiffuserPipeline(**kw, use_pallas_block=k == "kernel", device=dev)
             for k in ("kernel", "plain")}
    for p in pipes.values():
        p.load_jax_params(**weights)
    pipe, plain = pipes["kernel"], pipes["plain"]
    n = DIFFUSER_TRAIN_STEPS
    batches = train_batches(rng, n, B, H, O, A, dev, 0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    T, shape = args.diffusion_steps, (B, H, O + A)
    draw = lambda: (torch.randint(T, (B,), generator=gen, device=dev),
                    torch.randn(shape, generator=gen, device=dev))
    noise = [((*draw(), None), draw()) for _ in range(n)]
    print(f"config: obs {O} act {A} horizon {H} model_dim {args.model_dim} dim_mult "
          f"{tuple(args.task.dim_mult)} T {T} batch {B}; {n} steps per path (diffusion and "
          f"classifier updates)")
    check_film_autograd(dev, B)

    reset_counts()
    logs_k = [pipe.train_step(b, noise=z, classifier_noise=c) for b, (z, c) in zip(batches, noise)]
    torch.cuda.synchronize()
    k3, k2 = fused_film_resblock.launches, fused_solver_update.launches
    expected = n * len(UNET_BLOCKS)
    print(f"{n} train_steps through K3: film_resblock launches {k3} (expected {expected}), "
          f"solver_update launches {k2} (expected 0: a sampler step)", flush=True)
    if k3 != expected:
        raise AssertionError(f"film_resblock launched {k3} times in training, expected {expected}")
    if k2:
        raise AssertionError(f"solver_update launched {k2} times in training, expected 0")
    logs_p = [plain.train_step(b, noise=z, classifier_noise=c)
              for b, (z, c) in zip(batches, noise)]
    compare_training(logs_k, logs_p, ("loss", "grad_norm", "classifier_loss"))
    print(f"  params' final drift, kernel path against plain: U-Net "
          f"{max_drift(pipe.agent.params, plain.agent.params):.3e}, classifier "
          f"{max_drift(pipe.classifier.params, plain.classifier.params):.3e}", flush=True)

    times = step_ms(pipes, batches)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"ms per train_step (median of {TIMED_STEPS}): kernel {med['kernel']:.3f}, plain "
          f"{med['plain']:.3f} (runs {[round(v, 3) for v in times['kernel']]} / "
          f"{[round(v, 3) for v in times['plain']]})", flush=True)
    return k3, k2, med


def check_checkpoint(dev):
    """DD saved after 10 steps and loaded into a fresh pipeline: step 11 on
    both agrees within CKPT_ATOL."""
    phase("checkpoint round trip")
    args = load_config(ROOT / "configs/dd/mujoco", "mujoco")
    rng = np.random.default_rng(SEED + 8)
    weights = dd_weights(args, rng)
    batches = train_batches(rng, 11, args.batch_size, args.task.horizon, args.task.obs_dim,
                            args.task.act_dim, dev, 1000.0)
    first = build_pipeline(args, dev, True, weights)
    for b in batches[:10]:
        first.train_step(b)
    with tempfile.TemporaryDirectory() as tmp:
        first.save(str(Path(tmp) / "dd"))
        second = build_pipeline(args, dev, True, dd_weights(args, np.random.default_rng(1)))
        second.load(str(Path(tmp) / "dd"))
    la, lb = first.train_step(batches[10]), second.train_step(batches[10])
    diffs = {k: (la[k] - lb[k]).abs().item() for k in la}
    for name in ("params", "ema_params"):
        diffs[name] = max_drift(getattr(first.agent, name), getattr(second.agent, name))
    diffs["invdyn"] = max_drift(first.invdyn.net, second.invdyn.net)
    print(f"step 11 after save / load, max |diff|: {diffs} (limit {CKPT_ATOL})", flush=True)
    if max(diffs.values()) > CKPT_ATOL:
        raise AssertionError("a resumed DD run disagrees with the uninterrupted one")


def read_jsonl(path: Path) -> list:
    return [json.loads(s) for s in path.read_text().splitlines()] if path.exists() else []


def run_cli(cli, overrides, save_dir=None) -> tuple:
    """`cli.pipeline(args)` of the shipped config with `overrides`, run in
    CLI_DIR (the CLI writes its results/torch/<save_dir>/<env>/ tree there;
    `save_dir(args)` names it, the pipeline's name by default). Returns
    (args, the run's directory, the train.jsonl lines this run wrote,
    seconds)."""
    args = load_config(cli.CONFIG_DIR, cli.CONFIG_DIR.name, list(overrides))
    name = save_dir(args) if save_dir is not None else args.pipeline_name
    run = CLI_DIR / "results/torch" / name / args.task.env_name
    before = len(read_jsonl(run / "train.jsonl"))
    cwd = os.getcwd()
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    os.chdir(CLI_DIR)
    try:
        t0 = time.perf_counter()
        cli.pipeline(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return args, run, read_jsonl(run / "train.jsonl")[before:], seconds


def check_windows(logs: list, steps: int, log_interval: int, second: str, budget: int):
    """The CLI's log windows: one per `log_interval` steps, finite means,
    the budget-gated `second` loss above 0 in the windows within its budget
    and 0 after."""
    if [lg["gradient_steps"] for lg in logs] != list(range(log_interval, steps + 1,
                                                           log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    for lg in logs:
        if not all(np.isfinite(lg[k]) for k in ("loss", "grad_norm", second)):
            raise AssertionError(f"non-finite window means {lg}")
        if (lg[second] > 0) != (lg["gradient_steps"] <= budget):
            raise AssertionError(f"{second} {lg[second]} at step {lg['gradient_steps']} with a "
                                 f"budget of {budget}")


def check_checkpoints(run: Path, args, steps: int, parts) -> list:
    tags = [str(s) for s in range(args.save_interval, steps + 1, args.save_interval)] + ["latest"]
    missing = [f"ckpt_{t}.{p}" for t in tags for p in parts if not (run / f"ckpt_{t}.{p}").exists()]
    if missing:
        raise AssertionError(f"missing checkpoints {missing} in {run}")
    return tags


def cli_requests(pipe, obs: np.ndarray, n: int, **kw) -> list:
    """n `pipe.act` requests as the CLIs' evaluation makes them, each
    checked (`act_requests`); per-request ms."""
    return act_requests(lambda o: pipe.act(o, **kw), obs, n, pipe.act_dim)


def act_requests(act, obs: np.ndarray, n: int, act_dim: int) -> list:
    """n requests of an act function (normalised numpy observations in,
    actions out: the planners' `act` returns (actions, info), the policies'
    the actions), each checked; per-request ms."""
    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = act(obs)
        a = (out[0] if isinstance(out, tuple) else out).cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1e3)
        if a.shape != (obs.shape[0], act_dim):
            raise AssertionError(f"actions {a.shape}")
        if not (np.isfinite(a).all() and np.abs(a).max() <= 1.0):
            raise AssertionError("actions non-finite or outside [-1, 1]")
    return lat


def check_dd_cli(dev) -> dict:
    """The DD CLI as users run it, `mode=train` at the shipped width through
    K1's f32 route, window by window, beside the per-step path; then its
    `ckpt_latest` served as `mode=inference` serves it. Returns K1's
    launches by route and part."""
    phase("DD CLI: cli.dd_d4rl_mujoco mode=train (windows), then act from ckpt_latest")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    reset_counts()
    args, run, logs, seconds = run_cli(dd_d4rl_mujoco, DD_CLI_TRAIN)
    k1, k1_bf16 = fused_dit_block.launches, fused_dit_block_bf16.launches
    steps = args.diffusion_gradient_steps
    print(f"{steps} steps in {len(logs)} windows of {args.log_interval} at d_model "
          f"{args.d_model}, batch {args.batch_size}: {seconds:.1f} s with set-up and saves",
          flush=True)
    print(f"dit_block launches {k1} (expected {args.depth * steps}), BF16 route {k1_bf16}",
          flush=True)
    if k1 != args.depth * steps or k1_bf16:
        raise AssertionError(f"the DD CLI's training launched K1 {k1} times (BF16 {k1_bf16})")
    check_windows(logs, steps, args.log_interval, "invdyn_loss", args.invdyn_gradient_steps)
    tags = check_checkpoints(run, args, steps, ("diffusion", "invdyn"))
    print(f"checkpoints {['ckpt_' + t for t in tags]} in {run}", flush=True)

    # the same training per step (planner_window_fn says why), in turn
    _, _, per_step, _ = run_cli(dd_d4rl_mujoco, DD_CLI_PER_STEP)
    win = [lg["steps_per_sec"] for lg in logs]
    one = [lg["steps_per_sec"] for lg in per_step]
    print(f"steps/s per window of {args.log_interval}: windowed {win}, per-step {one}; the "
          f"second window (steps {args.log_interval + 1}-{2 * args.log_interval}, both with the "
          f"inverse dynamics): windowed {1e3 / win[1]:.3f} ms per step, per-step "
          f"{1e3 / one[1]:.3f} ms per step", flush=True)

    # mode=inference: ckpt_latest in a fresh pipeline, requests as
    # d4rl_eval_loop makes them; the env stepping itself (gymnasium's MuJoCo
    # envs) does not run here: the card's machine has no gymnasium
    dataset, pipe = dd_d4rl_mujoco.build(args, dev)
    pipe.load(str(run / "ckpt_latest"))
    if pipe.agent.step != steps:
        raise AssertionError(f"ckpt_latest holds step {pipe.agent.step}, not {steps}")
    obs = dataset.seq_obs[:args.num_envs, 0]  # normalised first states of 50 episodes
    cold = cli_requests(pipe, obs, 1)
    reset_counts()
    lat = cli_requests(pipe, obs, DD_CLI_REQUESTS)
    serve, serve_bf16 = fused_dit_block.launches, fused_dit_block_bf16.launches
    want = DD_CLI_REQUESTS * args.sampling_steps * args.depth
    print(f"{DD_CLI_REQUESTS} requests x {args.num_envs} envs from ckpt_latest: latency ms "
          f"{[round(v, 3) for v in lat]} (median {statistics.median(lat):.3f}; cold "
          f"{cold[0]:.3f}); dit_block launches {serve} (expected {want}), BF16 {serve_bf16}",
          flush=True)
    if serve != want or serve_bf16:
        raise AssertionError(f"serving ckpt_latest launched K1 {serve} times (BF16 {serve_bf16})")
    return {"dit_block": {"dd_train": k1, "dd_serve": serve},
            "dit_block_bf16": {"dd_train": k1_bf16, "dd_serve": serve_bf16}}


def check_diffuser_cli(dev) -> dict:
    """The Diffuser CLI, `mode=train` at the shipped width through K3,
    window by window; then its `ckpt_latest` served at 50 envs x 64
    candidates. Returns K3's and K2's launches by part."""
    phase("Diffuser CLI: cli.diffuser_d4rl_mujoco mode=train (windows), then act from "
          "ckpt_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(diffuser_d4rl_mujoco, DIFFUSER_CLI_TRAIN)
    k3, k2 = fused_film_resblock.launches, fused_solver_update.launches
    steps = args.diffusion_gradient_steps
    dataset, pipe = diffuser_d4rl_mujoco.build(args, dev)
    n_blocks = len(pipe.agent.params["diffusion"].blocks)
    print(f"{steps} steps in {len(logs)} windows of {args.log_interval} at model_dim "
          f"{args.model_dim}, batch {args.batch_size}: {seconds:.1f} s with set-up and saves; "
          f"steps/s per window {[lg['steps_per_sec'] for lg in logs]}", flush=True)
    print(f"film_resblock launches {k3} (expected {n_blocks} x {steps}), solver_update {k2}",
          flush=True)
    if k3 != n_blocks * steps or k2:
        raise AssertionError(f"the Diffuser CLI's training launched K3 {k3} times, K2 {k2}")
    check_windows(logs, steps, args.log_interval, "classifier_loss",
                  args.classifier_gradient_steps)
    tags = check_checkpoints(run, args, steps, ("diffusion", "classifier"))
    print(f"checkpoints {['ckpt_' + t for t in tags]} in {run}", flush=True)

    pipe.load(str(run / "ckpt_latest"))
    obs = dataset.seq_obs[:args.num_envs, 0]
    reset_counts()
    lat = cli_requests(pipe, obs, DIFFUSER_CLI_REQUESTS, num_candidates=args.num_candidates)
    serve, serve_k2 = fused_film_resblock.launches, fused_solver_update.launches
    want = DIFFUSER_CLI_REQUESTS * args.sampling_steps * n_blocks
    print(f"{DIFFUSER_CLI_REQUESTS} requests x {args.num_envs} envs x {args.num_candidates} "
          f"candidates from ckpt_latest: latency ms {[round(v, 3) for v in lat]} (the first "
          f"one cold); film_resblock launches {serve} (expected {want}), solver_update "
          f"{serve_k2}", flush=True)
    if serve != want or serve_k2:
        raise AssertionError(f"serving ckpt_latest launched K3 {serve} times, K2 {serve_k2}")
    return {"film_resblock": {"diffuser_train": k3, "diffuser_serve": serve},
            "solver_update": {"diffuser_train": k2, "diffuser_serve": serve_k2}}


def check_rl_cli(dev, family: str) -> dict:
    """One RL CLI as users run it: `mode=train` at the shipped width window
    by window, the checkpoints and their gates, the per-step path beside
    it, then `ckpt_latest` served as `mode=inference` serves it. Returns
    the kernels' launches in the phase (all 0: the path has no kernel)."""
    cli = {"dql": dql_d4rl_mujoco, "idql": idql_d4rl_mujoco, "edp": edp_d4rl_mujoco}[family]
    phase(f"{family.upper()} CLI: cli.{family}_d4rl_mujoco mode=train (windows), then act from "
          "ckpt_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, RL_CLI_TRAIN)
    steps = args.gradient_steps
    # a fresh pipeline holds the CLI's initial weights (a seeded init); it
    # then serves ckpt_latest
    dataset, pipe = cli.build(args, dev)
    keys = pipe.LOG_KEYS
    width = (f"actor {args.actor_hidden_dim} x {args.actor_n_blocks} blocks, critic "
             f"{args.critic_hidden_dim}" if family == "idql" else f"critic {args.hidden_dim}")
    print(f"{steps} steps in {len(logs)} windows of {args.log_interval} (obs {pipe.obs_dim}, "
          f"act {pipe.act_dim}, {width}, batch {args.batch_size}, T {args.diffusion_steps}, "
          f"{args.sampling_steps} sampling steps): {seconds:.1f} s with set-up and saves",
          flush=True)
    if [lg["gradient_steps"] for lg in logs] != list(range(args.log_interval, steps + 1,
                                                           args.log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    for lg in logs:
        if not all(np.isfinite(lg[k]) for k in keys):
            raise AssertionError(f"non-finite window means {lg}")
    print("window means: " + "; ".join(
        ", ".join(f"{k} {lg[k]:.4g}" for k in keys) for lg in logs), flush=True)
    tags = [str(t) for t in range(args.save_interval, steps + 1, args.save_interval)] + ["latest"]
    missing = [t for t in tags if not (run / f"ckpt_{t}.pt").exists()]
    if missing or "1000" not in tags:
        raise AssertionError(f"checkpoints {tags}: missing {missing} in {run}")
    load = lambda tag: torch.load(run / f"ckpt_{tag}.pt", map_location="cpu", weights_only=True)
    latest = load("latest")
    if latest["actor"]["step"] != steps:
        raise AssertionError(f"ckpt_latest holds step {latest['actor']['step']}, not {steps}")
    if family == "idql":
        counts = {name: (latest["critic"][name]["count"],
                         {int(s["step"]) for s in latest["critic"][name]["optimizer"]["state"]
                          .values()}) for name in ("q_opt_state", "v_opt_state")}
        print(f"ckpt_latest: critic optimizers' (schedule count, Adam steps) {counts} "
              f"(expected {steps // 2}: the critic moves on even steps)", flush=True)
        if any(c != (steps // 2, {steps // 2}) for c in counts.values()):
            raise AssertionError(f"IDQL's critic optimizers took {counts} steps")
    else:
        init = {k: v.cpu() for k, v in pipe.actor.params.state_dict().items()}
        same = lambda ema: all(torch.equal(ema[k], init[k]) for k in init)
        at_1000, at_latest = same(load("1000")["actor"]["ema_params"]), same(
            latest["actor"]["ema_params"])
        print(f"actor EMA equal to the initial weights bit for bit: ckpt_1000 {at_1000}, "
              f"ckpt_latest {at_latest} (expected True, False: the gate opens at step 1000)",
              flush=True)
        if not at_1000 or at_latest:
            raise AssertionError("the actor EMA's gate did not hold at step 1000")
    print(f"checkpoints {['ckpt_' + t for t in tags]} in {run}", flush=True)

    per_args, _, per_step, _ = run_cli(cli, RL_CLI_PER_STEP)
    win = [lg["steps_per_sec"] for lg in logs]
    one = [lg["steps_per_sec"] for lg in per_step]
    print(f"steps/s: windowed {win} (windows of {args.log_interval}), per-step {one} (windows "
          f"of {per_args.log_interval}); ms per step, the last window of each: windowed "
          f"{1e3 / win[-1]:.3f}, per-step {1e3 / one[-1]:.3f}", flush=True)

    # mode=inference: ckpt_latest in the fresh pipeline, requests as the
    # CLI's evaluation makes them. Normalised dataset observations stand in
    # for the envs': the card's machine has no gymnasium, so the env
    # stepping does not run here.
    pipe.load(str(run / "ckpt_latest.pt"))
    wt = args.weight_temperature if family == "idql" else args.task.weight_temperature
    kw = dict(num_candidates=args.num_candidates, weight_temperature=wt,
              use_ema=args.use_ema, temperature=args.temperature)
    obs = dataset.obs[:args.num_envs]
    cold = cli_requests(pipe, obs, 1, **kw)
    lat = cli_requests(pipe, obs, RL_CLI_REQUESTS, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    print(f"{RL_CLI_REQUESTS} requests x {args.num_envs} envs x {args.num_candidates} candidates "
          f"({args.num_envs * args.num_candidates} rows x {args.sampling_steps} steps) from "
          f"ckpt_latest: latency ms {[round(v, 3) for v in lat]} (median "
          f"{statistics.median(lat):.3f}; cold {cold[0]:.3f}); kernel launches in the phase "
          f"{counts}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"the {family} CLI phase launched a kernel: {counts}")
    return counts


def cache_cli_data():
    """Every CLI module's data loader, made once per env name for the run
    (each call returns copies): the synthetic 100k-step data is the same
    from one CLI phase to the next, and generating it takes seconds."""
    memo = {}

    def cached(fn):
        def load(env_name):
            if (fn, env_name) not in memo:
                memo[(fn, env_name)] = fn(env_name)
            return {k: v.copy() for k, v in memo[(fn, env_name)].items()}
        return load

    wrapped = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("cleandiffuser_tpu_torch.cli."):
            for attr in ("load_d4rl_dataset", "load_d4rl_qlearning_dataset"):
                fn = getattr(mod, attr, None)
                if fn is not None:
                    setattr(mod, attr, wrapped.setdefault(fn, cached(fn)))


def check_dd_suite_cli(dev, suite: str) -> dict:
    """The DD CLI of the antmaze or kitchen suite as users run it:
    `mode=train` at the shipped width through K1 (H = 64 on 2-block
    clusters for antmaze), window by window, then `ckpt_latest` served at 50
    envs, and one plan through K1 against the same plan through the plain
    block with the same explicit noise. Returns K1's launches by part."""
    cli = {"antmaze": dd_d4rl_antmaze, "kitchen": dd_d4rl_kitchen}[suite]
    phase(f"DD CLI ({suite}): cli.dd_d4rl_{suite} mode=train (windows), then act from "
          "ckpt_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, SUITE_DD_CLI_TRAIN)
    k1, k1_bf16 = fused_dit_block.launches, fused_dit_block_bf16.launches
    steps = args.diffusion_gradient_steps
    print(f"{steps} steps in {len(logs)} windows of {args.log_interval} (obs {args.task.obs_dim}, "
          f"horizon {args.task.horizon}, d_model {args.d_model}, {args.solver}, predict_noise "
          f"{args.predict_noise}, batch {args.batch_size}): {seconds:.1f} s with set-up and saves; "
          f"steps/s per window {[lg['steps_per_sec'] for lg in logs]}; dit_block launches {k1} "
          f"(expected {args.depth * steps}), BF16 route {k1_bf16}", flush=True)
    if not args.use_pallas_block:
        raise AssertionError("the shipped config must turn the fused block on")
    if k1 != args.depth * steps or k1_bf16:
        raise AssertionError(f"the DD {suite} CLI's training launched K1 {k1} times (BF16 "
                             f"{k1_bf16})")
    check_windows(logs, steps, args.log_interval, "invdyn_loss", args.invdyn_gradient_steps)
    tags = check_checkpoints(run, args, steps, ("diffusion", "invdyn"))
    print(f"checkpoints {['ckpt_' + t for t in tags]} in {run}", flush=True)

    dataset, pipe = cli.build(args, dev)
    pipe.load(str(run / "ckpt_latest"))
    if pipe.agent.step != steps:
        raise AssertionError(f"ckpt_latest holds step {pipe.agent.step}, not {steps}")
    print(f"return scale {pipe.return_scale}, value shift {pipe.val_shift}", flush=True)
    obs = dataset.seq_obs[:args.num_envs, 0]  # normalised first states of 50 episodes
    reset_counts()
    lat = cli_requests(pipe, obs, SUITE_CLI_REQUESTS)
    serve, serve_bf16 = fused_dit_block.launches, fused_dit_block_bf16.launches
    want = SUITE_CLI_REQUESTS * args.sampling_steps * args.depth
    print(f"{SUITE_CLI_REQUESTS} requests x {args.num_envs} envs (CFG batch "
          f"{2 * args.num_envs} x horizon {args.task.horizon}) from ckpt_latest: latency ms "
          f"{[round(v, 3) for v in lat]} (the first one cold); dit_block launches {serve} "
          f"(expected {want}), BF16 {serve_bf16}", flush=True)
    if serve != want or serve_bf16:
        raise AssertionError(f"serving ckpt_latest launched K1 {serve} times (BF16 {serve_bf16})")

    compare_dd_plan(pipe, torch.as_tensor(obs, device=dev), dev)
    return {f"dd_{suite}_train": k1, f"dd_{suite}_serve": serve}


def check_diffuser_suite_cli(dev, suite: str) -> dict:
    """The Diffuser CLI of the antmaze or kitchen suite: `mode=train` at the
    shipped width (model_dim 64: channels 64 to 512) through K3, window by
    window; then `ckpt_latest` served at 50 envs x 64 candidates, the U-Net's
    block shapes read on the way in, one plan through K3 against the plain
    block, and K3 under autograd at the training batch at each of those
    shapes. Returns K3's and K2's launches by part."""
    cli = {"antmaze": diffuser_d4rl_antmaze, "kitchen": diffuser_d4rl_kitchen}[suite]
    phase(f"Diffuser CLI ({suite}): cli.diffuser_d4rl_{suite} mode=train (windows), then act "
          "from ckpt_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, SUITE_DIFFUSER_CLI_TRAIN)
    k3, k2 = fused_film_resblock.launches, fused_solver_update.launches
    steps = args.diffusion_gradient_steps
    dataset, pipe = cli.build(args, dev)
    n_blocks = len(pipe.agent.params["diffusion"].blocks)
    print(f"{steps} steps in {len(logs)} windows of {args.log_interval} (obs {args.task.obs_dim}, "
          f"act {args.task.act_dim}, horizon {args.task.horizon}, model_dim {args.model_dim}, "
          f"dim_mult {tuple(args.task.dim_mult)}, batch {args.batch_size}): {seconds:.1f} s with "
          f"set-up and saves; steps/s per window {[lg['steps_per_sec'] for lg in logs]}; "
          f"film_resblock launches {k3} (expected {n_blocks} x {steps}), solver_update {k2}",
          flush=True)
    if k3 != n_blocks * steps or k2:
        raise AssertionError(f"the Diffuser {suite} CLI's training launched K3 {k3} times, K2 {k2}")
    check_windows(logs, steps, args.log_interval, "classifier_loss",
                  args.classifier_gradient_steps)
    tags = check_checkpoints(run, args, steps, ("diffusion", "classifier"))
    print(f"checkpoints {['ckpt_' + t for t in tags]} in {run}", flush=True)

    pipe.load(str(run / "ckpt_latest"))
    obs = dataset.seq_obs[:args.num_envs, 0]
    seen, unhook = seen_blocks(pipe)
    reset_counts()
    lat = cli_requests(pipe, obs, SUITE_CLI_REQUESTS, num_candidates=args.num_candidates)
    serve, serve_k2 = fused_film_resblock.launches, fused_solver_update.launches
    unhook()
    shapes = block_shapes(pipe, seen)
    want = SUITE_CLI_REQUESTS * args.sampling_steps * n_blocks
    print(f"{SUITE_CLI_REQUESTS} requests x {args.num_envs} envs x {args.num_candidates} "
          f"candidates from ckpt_latest: latency ms {[round(v, 3) for v in lat]} (the first one "
          f"cold); film_resblock launches {serve} (expected {want}), solver_update {serve_k2}; "
          f"the U-Net's (H, Cin, Cout) per block: {shapes}", flush=True)
    if serve != want or serve_k2:
        raise AssertionError(f"serving ckpt_latest launched K3 {serve} times, K2 {serve_k2}")
    if suite == "antmaze" and shapes != ANTMAZE_UNET_BLOCKS:
        raise AssertionError(f"the antmaze U-Net's blocks are {shapes}, not {ANTMAZE_UNET_BLOCKS}")
    compare_diffuser_plan(pipe, torch.as_tensor(obs, device=dev), args.num_candidates, dev)
    check_film_autograd(dev, args.batch_size, shapes)  # the training steps' regime
    return {f"diffuser_{suite}_train": k3, f"diffuser_{suite}_serve": serve}, {
        f"diffuser_{suite}_train": k2, f"diffuser_{suite}_serve": serve_k2}


def seen_blocks(pipe) -> tuple:
    """Forward pre-hooks on the EMA U-Net's residual blocks (the sampler's):
    a list that collects the (B, H, Cin) of every block call, and a
    function that removes the hooks."""
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape)))
             for b in pipe.agent.ema_params["diffusion"].blocks]
    return seen, lambda: [h.remove() for h in hooks]


def block_shapes(pipe, seen: list) -> list:
    """(H, Cin, Cout) of each U-Net block from the first call's inputs."""
    blocks = pipe.agent.params["diffusion"].blocks
    return [(H, Cin, blocks[i].conv1.kernel.shape[-1])
            for i, (_, H, Cin) in enumerate(seen[:len(blocks)])]


def check_generation_round(pipe, dataset, args, dev) -> tuple:
    """One generation round as `mode=finetune` runs it, from the loaded
    checkpoint: GENERATION_BATCH dataset start states, explicit noise,
    through K3 (its launches read just after the call, the batch that
    reached the U-Net read by hooks) and again through the plain block:
    every trajectory and log p within PLAN_ATOL. The threshold is below
    every log p, so the filter keeps all rows and the shipped
    `metric_value`'s share is read from them. Returns (K3 launches, the
    U-Net's block shapes, the trajectories)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = adaptdiffuser_d4rl_mujoco.GENERATION_BATCH
    start_obs = dataset.sample_batch(gen, n)["obs"]["state"][:, 0]
    shape = (n, pipe.horizon, pipe.obs_dim + pipe.act_dim)
    noise = (torch.randn(shape, generator=gen, device=dev),
             torch.randn((pipe.sampling_steps,) + shape, generator=gen, device=dev))
    seen, unhook = seen_blocks(pipe)
    reset_counts()
    t0 = time.perf_counter()
    traj_k, logp_k = pipe.generate_and_filter(start_obs, ADAPT_KEEP_ALL, noise=noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = fused_film_resblock.launches
    unhook()
    use_kernels(pipe, False)
    traj_p, logp_p = pipe.generate_and_filter(start_obs, ADAPT_KEEP_ALL, noise=noise)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    use_kernels(pipe, True)
    n_blocks = len(pipe.agent.params["diffusion"].blocks)
    batches = sorted({b for b, _, _ in seen})
    shapes = block_shapes(pipe, seen)
    kept = (logp_k[:, 0] > float(args.task.metric_value)).float().mean().item()
    want = n_blocks * pipe.sampling_steps
    print(f"one generation round from ckpt_latest: {len(start_obs)} start states, U-Net batch "
          f"{batches}, {traj_k.shape[0]} rows out at metric_value {ADAPT_KEEP_ALL}: kernel "
          f"{t1 - t0:.3f} s, plain {t2 - t1:.3f} s; film_resblock launches {launches} (expected "
          f"{n_blocks} x {pipe.sampling_steps} = {want}); kept share at the shipped metric_value "
          f"{args.task.metric_value}: {kept:.1%} (log p in [{logp_k.min().item():.3f}, "
          f"{logp_k.max().item():.3f}])", flush=True)
    if launches != want or batches != [n] or len(seen) != want:
        raise AssertionError(f"the round launched K3 {launches} times at U-Net batches {batches}")
    if not (traj_k.shape[0] == traj_p.shape[0] == n and torch.isfinite(traj_k).all()):
        raise AssertionError(f"the round kept {traj_k.shape[0]} / {traj_p.shape[0]} of {n} rows")
    d_traj = (traj_k - traj_p).abs().max().item()
    d_logp = (logp_k - logp_p).abs().max().item()
    print(f"round kernel vs plain: max |traj diff| {d_traj:.3e}, max |logp diff| {d_logp:.3e} "
          f"(max |traj| {traj_p.abs().max().item():.3f}; atol {PLAN_ATOL})", flush=True)
    if not (d_traj <= PLAN_ATOL and d_logp <= PLAN_ATOL):
        raise AssertionError("the generation round through K3 disagrees with the plain version")
    return launches, shapes, traj_k


def check_adaptdiffuser_cli(dev, suite: str) -> dict:
    """An AdaptDiffuser CLI as users run it: a short `mode=train` through K3;
    then, from its ckpt_latest, one generation round at B = 2000 held
    against the plain block (`check_generation_round`) and fine-tuning
    steps at batch 32, each part's K3 launches read on its own, and K3
    under autograd at that batch at every block shape; then `mode=finetune`
    for one round and a few steps, first at the task's shipped
    `metric_value` and, where that keeps nothing on the synthetic data (the
    CLI raises), again at ADAPT_KEEP_ALL, below every log p; then
    `ckpt_finetuned_latest` loaded and served for one request at 50 x 64.
    Returns K3's launches by part."""
    cli = {"mujoco": adaptdiffuser_d4rl_mujoco, "antmaze": adaptdiffuser_d4rl_antmaze}[suite]
    phase(f"AdaptDiffuser CLI ({suite}): cli.adaptdiffuser_d4rl_{suite} mode=train, "
          "mode=finetune, then act from ckpt_finetuned_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, ADAPT_CLI_TRAIN)
    k3_train = fused_film_resblock.launches
    steps = args.diffusion_gradient_steps
    dataset, pipe = cli.build(args, dev)
    n_blocks = len(pipe.agent.params["diffusion"].blocks)
    print(f"mode=train: {steps} steps in {len(logs)} windows (horizon {args.task.horizon}, "
          f"model_dim {args.model_dim}): {seconds:.1f} s; film_resblock launches {k3_train} "
          f"(expected {n_blocks * steps})", flush=True)
    if k3_train != n_blocks * steps:
        raise AssertionError(f"AdaptDiffuser's training launched K3 {k3_train} times")
    check_checkpoints(run, args, steps, ("diffusion", "classifier"))

    pipe.load(str(run / "ckpt_latest"))
    generate, shapes, traj = check_generation_round(pipe, dataset, args, dev)
    ft_steps = int(dict(a.split("=", 1) for a in ADAPT_CLI_FINETUNE)["ft_gradient_steps"])
    B = adaptdiffuser_d4rl_mujoco.FINETUNE_BATCH
    rng = np.random.default_rng(SEED)
    reset_counts()
    losses = [pipe.finetune_step(traj[torch.as_tensor(rng.integers(0, len(traj), B),
                                                      device=dev)])["loss"]
              for _ in range(ft_steps)]
    torch.cuda.synchronize()
    tuned = fused_film_resblock.launches
    print(f"{ft_steps} finetune_steps at batch {B} on the round's trajectories: film_resblock "
          f"launches {tuned} (expected {n_blocks} x {ft_steps}); loss {losses[0].item():.4f} "
          f"-> {losses[-1].item():.4f}", flush=True)
    if tuned != n_blocks * ft_steps or not all(torch.isfinite(v) for v in losses):
        raise AssertionError(f"the finetune steps launched K3 {tuned} times, losses {losses}")
    check_film_autograd(dev, B, shapes)

    def finetune(*extra) -> tuple:
        """`mode=finetune` with `extra` overrides: (K3 launches in the run;
        whether anything was kept)."""
        log_path = run / "finetune.jsonl"
        before = len(read_jsonl(log_path))
        reset_counts()
        t0 = time.perf_counter()
        try:
            run_cli(cli, (*ADAPT_CLI_FINETUNE, *extra))
            failed = None
        except RuntimeError as e:
            if "zero trajectories" not in str(e):
                raise
            failed = str(e)
        seconds = time.perf_counter() - t0
        k3 = fused_film_resblock.launches
        logs = read_jsonl(log_path)[before:]
        rounds = [lg for lg in logs if "round" in lg]
        steps_done = 0 if failed else ft_steps
        threshold = extra[0].split("=")[1] if extra else args.task.metric_value
        print(f"mode=finetune at metric_value {threshold}: rounds "
              f"{[(lg['generated'], lg['kept'], round(lg['seconds'], 3)) for lg in rounds]} "
              f"(generated, kept, seconds); kept share "
              f"{sum(lg['kept'] for lg in rounds) / sum(lg['generated'] for lg in rounds):.1%}; "
              f"fine-tuning logs "
              f"{[(lg['gradient_steps'], round(lg['loss'], 4)) for lg in logs if 'loss' in lg]}; "
              f"{seconds:.1f} s with set-up; film_resblock launches {k3} (the round's "
              f"{generate} + {steps_done} steps x {tuned // ft_steps}, as measured above)"
              + (f"; the CLI raised: {failed}" if failed else ""), flush=True)
        if len(rounds) != 1 or k3 != generate + tuned // ft_steps * steps_done:
            raise AssertionError(f"the finetune ran {len(rounds)} rounds with {k3} K3 launches")
        return k3, failed is None

    finetune_cli, kept = finetune()
    if not kept:  # the shipped threshold kept nothing: again, keeping all
        k3, kept = finetune(f"task.metric_value={ADAPT_KEEP_ALL}")
        finetune_cli += k3
        if not kept:
            raise AssertionError(f"the finetune kept nothing at metric_value {ADAPT_KEEP_ALL}")
    if not (run / "ckpt_finetuned_latest.diffusion").exists():
        raise AssertionError(f"no ckpt_finetuned_latest in {run}")

    pipe.load(str(run / "ckpt_finetuned_latest"))
    if pipe.agent.step != steps + ft_steps:
        raise AssertionError(f"ckpt_finetuned_latest holds step {pipe.agent.step}")
    obs = dataset.seq_obs[:args.num_envs, 0]
    reset_counts()
    lat = cli_requests(pipe, obs, 1, num_candidates=args.num_candidates)
    serve = fused_film_resblock.launches
    want = args.sampling_steps * n_blocks
    print(f"1 request x {args.num_envs} envs x {args.num_candidates} candidates from "
          f"ckpt_finetuned_latest (step {pipe.agent.step}): {lat[0]:.3f} ms (cold); "
          f"film_resblock launches {serve} (expected {want})", flush=True)
    if serve != want:
        raise AssertionError(f"serving ckpt_finetuned_latest launched K3 {serve} times")
    return {f"adaptdiffuser_{suite}_train": k3_train, f"adaptdiffuser_{suite}_generate": generate,
            f"adaptdiffuser_{suite}_finetune": tuned,
            f"adaptdiffuser_{suite}_finetune_cli": finetune_cli,
            f"adaptdiffuser_{suite}_serve": serve}


def check_rl_suite_cli(dev, family: str, suite: str) -> dict:
    """A DQL, IDQL or EDP CLI of the antmaze or kitchen suite: `mode=train`
    for one window at the shipped width, then `ckpt_latest` served at 50
    envs with the config's candidates. Returns the kernels' launches in the
    phase (all 0: MLPs)."""
    cli = {("dql", "antmaze"): dql_d4rl_antmaze, ("dql", "kitchen"): dql_d4rl_kitchen,
           ("idql", "antmaze"): idql_d4rl_antmaze, ("idql", "kitchen"): idql_d4rl_kitchen,
           ("edp", "antmaze"): edp_d4rl_antmaze, ("edp", "kitchen"): edp_d4rl_kitchen}[
               (family, suite)]
    phase(f"{family.upper()} CLI ({suite}): cli.{family}_d4rl_{suite} mode=train, then act "
          "from ckpt_latest")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, SUITE_RL_CLI_TRAIN)
    steps = args.gradient_steps
    dataset, pipe = cli.build(args, dev)
    keys = pipe.LOG_KEYS
    if [lg["gradient_steps"] for lg in logs] != list(range(args.log_interval, steps + 1,
                                                           args.log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    if not all(np.isfinite(lg[k]) for lg in logs for k in keys):
        raise AssertionError(f"non-finite window means {logs}")
    print(f"{steps} steps (obs {pipe.obs_dim}, act {pipe.act_dim}, batch {args.batch_size}, "
          f"{args.solver} x {args.sampling_steps}, max_q_backup "
          f"{getattr(pipe, 'max_q_backup', '-')}): {seconds:.1f} s with set-up and a save; "
          f"{logs[-1]['steps_per_sec']} steps/s; window means "
          f"{ {k: round(logs[-1][k], 4) for k in keys} }", flush=True)
    pipe.load(str(run / "ckpt_latest.pt"))
    if pipe.actor.step != steps:
        raise AssertionError(f"ckpt_latest holds step {pipe.actor.step}, not {steps}")
    kw = dict(num_candidates=args.num_candidates, weight_temperature=args.task.weight_temperature,
              use_ema=args.use_ema, temperature=args.temperature)
    lat = cli_requests(pipe, dataset.obs[:args.num_envs], 2, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    print(f"2 requests x {args.num_envs} envs x {args.num_candidates} candidates from "
          f"ckpt_latest: latency ms {[round(v, 3) for v in lat]} (the first one cold); kernel "
          f"launches in the phase {counts}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"the {family} {suite} CLI phase launched a kernel: {counts}")
    return counts


def check_dql_goal2d(dev) -> float:
    """The hermetic DQL gate on the card: backprop through the 5-step
    sampler at every step, then 128 episodes with 50 candidates per env."""
    phase("Goal2D score: hermetic DQL trained on the card")
    ds = D4RLMuJoCoTDDataset(goal2d_qlearning_dataset(n_episodes=1000, seed=0), device=dev)
    pipe = DQLPipeline(obs_dim=2, act_dim=2, emb_dim=32, hidden_dim=128,
                       gradient_steps=DQL_GOAL2D_STEPS, discount=0.95, eta=1.0, rng=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    for _ in range(DQL_GOAL2D_STEPS):
        log = pipe.train_step(ds.sample_batch(gen, DQL_GOAL2D_BATCH))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"{DQL_GOAL2D_STEPS} train_steps (batch {DQL_GOAL2D_BATCH}, {len(ds)} transitions): "
          f"{train_s:.1f} s ({1e3 * train_s / DQL_GOAL2D_STEPS:.3f} ms per step); last "
          f"{ {k: round(v.item(), 4) for k, v in log.items()} }", flush=True)
    norm = ds.get_normalizer()
    score = normalized_score_fn(device=dev)
    t0 = time.perf_counter()
    ret = evaluate_policy(lambda g, obs: pipe.act(norm.normalize(obs), num_candidates=50,
                                                  generator=g),
                          num_envs=128, seed=1, device=dev)
    s = score(ret)
    print(f"normalized score {s:.4f} (return {ret:.4f}; anchors {score.anchors}; bar "
          f"{GOAL2D_BAR}); 40 requests at 128 x 50 in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if not s >= GOAL2D_BAR:
        raise AssertionError(f"DQL Goal2D score {s:.4f} below {GOAL2D_BAR}")
    return s


# ---------------------------------------------------------------------------
# Diffusion Veteran and DiffuserLite: the CLIs, no kernel on the path
VETERAN_CLIS = {"mujoco": veteran_d4rl_mujoco, "maze2d": veteran_d4rl_maze2d,
                "antmaze": veteran_d4rl_antmaze, "kitchen": veteran_d4rl_kitchen}
LITE_SUITE_CLIS = {"antmaze": (diffuserlite_d4rl_antmaze, "antmaze_act_fn", 1),
                   "kitchen": (diffuserlite_d4rl_kitchen, "kitchen_act_fn", -1)}


def kernel_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def no_kernel_launched(label: str) -> dict:
    """The four kernels' launches since the last reset, which must all be 0
    on these planners' path."""
    counts = kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{label} launched a kernel: {counts}")
    return counts


def profile_request(fn, median_ms: float, ranges) -> dict:
    """One call of `fn` under `torch.profiler`: the device's busy ms (every
    device event's self time; one stream, so they do not overlap), the idle
    share against the unprofiled median latency, and the device ms inside
    each of the profiler `ranges` (the pipeline's `record_function`
    spans)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, parts = 0.0, {r: 0.0 for r in ranges}
    for e in prof.key_averages():
        dev_total = getattr(e, "device_time_total", None)
        if dev_total is None:
            dev_total = e.cuda_time_total
        if e.key in parts:
            parts[e.key] = max(parts[e.key], dev_total / 1e3)
            continue
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            self_us = getattr(e, "self_device_time_total", None)
            busy += (e.self_cuda_time_total if self_us is None else self_us) / 1e3
    out = {"median_latency_ms": median_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / median_ms if busy else None,
           "range_device_ms": parts}
    if not busy:
        print("profiler: no device time recorded (device busy and idle share not measured)",
              flush=True)
    return out


def rows_of(seq_obs: np.ndarray, n: int) -> np.ndarray:
    """The normalised first states of n episodes (cycled if there are
    fewer): the observations a request of n envs is served."""
    return seq_obs[np.arange(n) % seq_obs.shape[0], 0]


def to_device(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def card_against_cpu(label: str, card: tuple, cpu: tuple, keys) -> dict:
    """A request on the card against the same request on the CPU with the
    same noise: each of `keys` of the info (the whole candidate batch and
    its scores before the argmax, or the plan) within PLAN_ATOL; where a
    request ranks candidates, the picks equal wherever the CPU's top two
    scores are more than 2 PLAN_ATOL apart, and the actions of the envs
    whose picks agree within PLAN_ATOL. Returns the gaps."""
    (act_c, info_c), (act_p, info_p) = card, cpu
    gaps = {k: (info_c[k].cpu() - info_p[k]).abs().max().item() for k in keys}
    agree = torch.ones(act_p.shape[0], dtype=torch.bool)
    if "scores" in info_p:
        top2 = info_p["scores"].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * PLAN_ATOL
        agree = info_c["idx"].cpu() == info_p["idx"]
        if not agree[clear].all():
            raise AssertionError(f"{label}: the card picked other candidates than the CPU where "
                                 "the scores are apart")
        gaps["picks_agree"] = f"{int(agree.sum())}/{agree.numel()}"
    gaps["act"] = (act_c.cpu()[agree] - act_p[agree]).abs().max().item() if agree.any() else 0.0
    print(f"{label}: card against CPU, same noise (TF32 off): max |diff| "
          f"{ {k: (round(v, 9) if isinstance(v, float) else v) for k, v in gaps.items()} } "
          f"(limit {PLAN_ATOL})", flush=True)
    bad = {k: v for k, v in gaps.items() if isinstance(v, float) and not v <= PLAN_ATOL}
    if bad:
        raise AssertionError(f"{label}: card and CPU differ: {bad}")
    return gaps


def veteran_noise(pipe, E: int, K: int, gen: torch.Generator) -> dict:
    """Explicit draws of one Veteran request: the planner's (initial,
    per-step) of the E*K prior's shape and the policy's."""
    shape = (E * K, pipe.planner_horizon, pipe.planner_dim)
    pol = (E, pipe.act_dim)
    return {"plan": (torch.randn(shape, generator=gen),
                     torch.randn((pipe.planner_sampling_steps, *shape), generator=gen)),
            "policy": (torch.randn(pol, generator=gen),
                       torch.randn((pipe.policy_sampling_steps, *pol), generator=gen))}


def check_veteran_cli(dev, suite: str) -> dict:
    """A Diffusion Veteran CLI as users run it: `mode=train` (planner,
    critic head, DVInvMlp policy) window by window, then
    `mode=train_expected_value` from its checkpoint, then
    `veteran_latest.pkl` served at the config's envs x candidates (MuJoCo:
    50 x 32 = 1,600 trajectories of 20 ddpm steps through the plain DiT),
    one request profiled, and one held against the CPU. Returns the
    kernels' launches in the phase (all 0)."""
    cli = VETERAN_CLIS[suite]
    full = suite == "mujoco"
    train, ev_steps, ev_train = ((VETERAN_CLI_TRAIN, VETERAN_EV_STEPS, VETERAN_EV_TRAIN) if full
                                 else (SUITE_VETERAN_CLI_TRAIN, SUITE_VETERAN_EV_STEPS,
                                       SUITE_VETERAN_EV_TRAIN))
    save_dir = ((lambda a: f"{a.pipeline_name}_{a.guidance_type}") if full else None)
    phase(f"Veteran CLI ({suite}): cli.veteran_d4rl_{suite} mode=train, "
          "mode=train_expected_value, then act from veteran_latest.pkl")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, train, save_dir)
    steps = args.planner_diffusion_gradient_steps
    keys = ("planner_loss", "val_loss", "val_pred", "policy_bc_loss")
    if [lg["gradient_steps"] for lg in logs] != list(range(args.log_interval, steps + 1,
                                                           args.log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    if not all(np.isfinite(lg[k]) for lg in logs for k in keys):
        raise AssertionError(f"non-finite window means {logs}")
    tags = [str(t) for t in range(args.save_interval, steps + 1, args.save_interval)]
    missing = [t for t in tags + ["latest"] if not (run / f"veteran_{t}.pkl").exists()]
    if missing:
        raise AssertionError(f"missing checkpoints veteran_{missing}.pkl in {run}")
    print(f"{steps} steps (obs {args.task.obs_dim}, horizon {args.task.planner_horizon} stride "
          f"{args.task.stride}, DiT d_model {args.planner_d_model} depth {args.planner_depth}, "
          f"{args.guidance_type} {args.pipeline_type}, batch {args.batch_size}): {seconds:.1f} s "
          f"with set-up and saves; steps/s per window {[lg['steps_per_sec'] for lg in logs]}; "
          f"last window { {k: round(logs[-1][k], 4) for k in keys} }; checkpoints "
          f"{['veteran_' + t + '.pkl' for t in tags]} and veteran_latest.pkl", flush=True)

    old = veteran_d4rl_mujoco.EV_GRADIENT_STEPS
    veteran_d4rl_mujoco.EV_GRADIENT_STEPS = ev_steps
    try:
        ev_args, _, ev_logs, ev_seconds = run_cli(cli, ev_train, save_dir)
    finally:
        veteran_d4rl_mujoco.EV_GRADIENT_STEPS = old
    if [lg["gradient_steps"] for lg in ev_logs] != list(range(ev_args.log_interval,
                                                              ev_steps + 1,
                                                              ev_args.log_interval)):
        raise AssertionError(f"EV windows at {[lg['gradient_steps'] for lg in ev_logs]}")
    if not all(np.isfinite(lg[k]) for lg in ev_logs for k in ("loss_v", "v_mean")):
        raise AssertionError(f"non-finite EV window means {ev_logs}")
    print(f"EV stage: {ev_steps} TD steps at batch {veteran_d4rl_mujoco.EV_BATCH} from "
          f"veteran_latest.pkl: {ev_seconds:.1f} s; steps/s per window "
          f"{[lg['steps_per_sec'] for lg in ev_logs]}; last window "
          f"loss_v {ev_logs[-1]['loss_v']:.4f} v_mean {ev_logs[-1]['v_mean']:.4f}", flush=True)

    dataset, pipe = cli.build(args, dev)
    pipe.load(str(run / "veteran_latest.pkl"))
    if pipe.planner.step != steps:
        raise AssertionError(f"veteran_latest.pkl holds step {pipe.planner.step}, not {steps}")
    E, K = args.num_envs, args.planner_num_candidates
    obs = rows_of(dataset.seq_obs, E)
    n = N_REQUESTS if full else SUITE_CLI_REQUESTS
    lat = cli_requests(pipe, obs, n, num_candidates=K)
    counts = no_kernel_launched(f"the Veteran {suite} CLI phase")
    median = statistics.median(lat[1:]) if len(lat) > 2 else lat[-1]
    prof = profile_request(lambda: pipe.act(obs, num_candidates=K), median,
                           ("veteran.plan", "veteran.score", "veteran.policy"))
    print(f"{n} requests x {E} envs x {K} candidates ({E * K} trajectories, "
          f"{args.planner_solver} x {args.planner_sampling_steps}, policy "
          f"{args.policy_solver} x {args.policy_sampling_steps}) from veteran_latest.pkl: "
          f"plan latency ms {[round(v, 3) for v in lat]} (the first one cold); one profiled "
          f"request: {json.dumps(prof)}; kernel launches in the phase {counts}", flush=True)
    if full and args.planner_net == "transformer":
        # the plain DiT block at the request's shape, graph-timed, for its
        # share of the request's device time (K1's shape: the plain version)
        D = args.planner_d_model
        x, mod, ws = block_inputs(np.random.default_rng(SEED), dev, E * K,
                                  args.task.planner_horizon, D)
        with torch.no_grad():
            block = cuda_ms(lambda: dit_block_reference(x, mod, *ws, n_heads=D // 32), 3)
        calls = args.planner_sampling_steps * args.planner_depth
        print(f"plain DiT block at ({E * K}, {args.task.planner_horizon}, {D}): {block:.4f} ms; "
              f"x {calls} calls = {calls * block:.2f} ms, "
              f"{calls * block / prof['device_busy_ms']:.1%} of the request's device busy "
              "time" if prof["device_busy_ms"] else "", flush=True)
        del x, mod, ws

    n_cmp = VETERAN_COMPARE_ENVS if full else SUITE_COMPARE_ENVS
    gen = torch.Generator().manual_seed(SEED)
    noise = veteran_noise(pipe, n_cmp, K, gen)
    card = pipe.act(obs[:n_cmp], num_candidates=K, noise=to_device(noise, dev))
    _, cpu_pipe = cli.build(args, torch.device("cpu"), dataset)
    cpu_pipe.load(str(run / "veteran_latest.pkl"))
    t0 = time.perf_counter()
    cpu = cpu_pipe.act(obs[:n_cmp], num_candidates=K, noise=noise)
    print(f"the CPU request ({n_cmp} envs x {K} candidates): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card_against_cpu(f"Veteran {suite} ({n_cmp} envs x {K})", card, cpu,
                     ("candidates", "scores", "traj"))
    return counts


def lite_noise(pipe, E: int, gen: torch.Generator, K: int = 1) -> list:
    """Each level's explicit initial draw of one DiffuserLite request (level
    0's for E*K rows)."""
    return [torch.randn(((E * K) if i == 0 else E, h, pipe.obs_dim), generator=gen)
            for i, h in enumerate(pipe.planning_horizons)]


def check_diffuserlite_cli(dev) -> dict:
    """DiffuserLite's MuJoCo CLI as users run it: `mode=training` window by
    window, `mode=prepare_dataset` (two batches of the config's 5000 pairs
    per level), `mode=reflow`, then `ckpt_latest` served as R1 (3 Euler steps
    per level) and `reflow_ckpt_latest` as R2 (1 step), 5 requests each at
    50 envs, one of each profiled and held against the CPU. Returns the
    kernels' launches in the phase (all 0)."""
    cli = diffuserlite_d4rl_mujoco
    phase("DiffuserLite CLI (mujoco): cli.diffuserlite_d4rl_mujoco mode=training, "
          "prepare_dataset, reflow, then R1 and R2 requests")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, LITE_CLI_TRAIN)
    steps, budget = args.diffusion_gradient_steps, args.invdyn_gradient_steps
    levels = len(args.task.planning_horizons)
    if [lg["gradient_steps"] for lg in logs] != list(range(args.log_interval, steps + 1,
                                                           args.log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    for lg in logs:
        if not all(np.isfinite(lg[f"loss{i}"]) for i in range(levels)):
            raise AssertionError(f"non-finite window means {lg}")
        if (lg["invdyn_loss"] > 0) != (lg["gradient_steps"] <= budget):
            raise AssertionError(f"invdyn_loss {lg['invdyn_loss']} at step "
                                 f"{lg['gradient_steps']} with a budget of {budget}")
    parts = [f"diffusion{i}" for i in range(levels)] + ["invdyn"]
    check_checkpoints(run, args, steps, parts)
    print(f"{steps} steps (levels {list(args.task.planning_horizons)}, DiT d_model "
          f"{args.d_model} x {args.n_heads} heads x depth {args.depth}, batch {args.batch_size}): "
          f"{seconds:.1f} s with set-up and saves; steps/s per window "
          f"{[lg['steps_per_sec'] for lg in logs]}; last window "
          f"{ {k: round(v, 4) for k, v in logs[-1].items() if k.startswith('loss')} }",
          flush=True)

    pargs, _, _, p_seconds = run_cli(cli, LITE_CLI_PREPARE)
    pairs = read_jax_pickle(run / "reflow_pairs.pkl")
    n_pairs = max(pargs.cond_dataset_size // pargs.dataset_prepare_batch_size, 1) * \
        pargs.dataset_prepare_batch_size
    for i, (p, h) in enumerate(zip(pairs, args.task.planning_horizons)):
        if p["x0"].shape != (n_pairs, h, args.task.obs_dim) or set(p) != {"x0", "x1",
                                                                         "condition"}:
            raise AssertionError(f"reflow pairs of level {i}: {p['x0'].shape}, {set(p)}")
        if not all(np.isfinite(v).all() for v in p.values()):
            raise AssertionError(f"non-finite reflow pairs at level {i}")
    print(f"prepare_dataset: {n_pairs} pairs per level in batches of "
          f"{pargs.dataset_prepare_batch_size} ({pargs.dataset_prepare_sampling_steps} Euler "
          f"steps): {p_seconds:.1f} s", flush=True)
    rargs, _, _, r_seconds = run_cli(cli, LITE_CLI_REFLOW)
    reflow_logs = read_jsonl(run / "reflow.jsonl")[-(rargs.reflow_gradient_steps
                                                     // rargs.log_interval):]
    if [lg["gradient_steps"] for lg in reflow_logs] != list(range(
            rargs.log_interval, rargs.reflow_gradient_steps + 1, rargs.log_interval)):
        raise AssertionError(f"reflow windows {reflow_logs}")
    if not (run / "reflow_ckpt_latest.invdyn").exists():
        raise AssertionError("no reflow_ckpt_latest")
    print(f"reflow: {rargs.reflow_gradient_steps} steps at batch {rargs.batch_size}: "
          f"{r_seconds:.1f} s; last window "
          f"{ {k: round(v, 6) for k, v in reflow_logs[-1].items() if k.startswith('loss')} }",
          flush=True)

    dataset, pipe = cli.build(args, dev)
    _, cpu_pipe = cli.build(args, torch.device("cpu"), dataset)
    E = args.num_envs
    obs = rows_of(dataset.seq_obs, E)
    for model, prefix, sample_steps in (("R1", "ckpt", 3), ("R2", "reflow_ckpt", 1)):
        pipe.load(str(run / f"{prefix}_latest"))
        lat = cli_requests(pipe, obs, N_REQUESTS, sample_steps=sample_steps)
        prof = profile_request(lambda: pipe.act(obs, sample_steps=sample_steps),
                               statistics.median(lat[1:]),
                               [f"diffuserlite.level{i}" for i in range(levels)]
                               + ["diffuserlite.invdyn"])
        print(f"{model}: {N_REQUESTS} requests x {E} envs (CFG batch {2 * E}, {sample_steps} "
              f"Euler step(s) per level) from {prefix}_latest: plan latency ms "
              f"{[round(v, 3) for v in lat]} (the first one cold); one profiled request: "
              f"{json.dumps(prof)}", flush=True)
        noise = lite_noise(pipe, LITE_COMPARE_ENVS, torch.Generator().manual_seed(SEED))
        card = pipe.act(obs[:LITE_COMPARE_ENVS], sample_steps=sample_steps,
                        noise=to_device(noise, dev))
        cpu_pipe.load(str(run / f"{prefix}_latest"))
        cpu = cpu_pipe.act(obs[:LITE_COMPARE_ENVS], sample_steps=sample_steps, noise=noise)
        card_against_cpu(f"DiffuserLite mujoco {model}", card, cpu, ("traj",))
    return no_kernel_launched("the DiffuserLite mujoco CLI phase")


def check_diffuserlite_suite_cli(dev, suite: str) -> dict:
    """DiffuserLite's antmaze or kitchen CLI: `mode=iql_training`, then
    `mode=training` window by window, then 2 R1 requests (5 Euler steps per
    level) at 50 envs x the config's candidates, ranked by IQL's V, as the
    CLI's act function makes them; one held against the CPU. Returns the
    kernels' launches in the phase (all 0)."""
    cli, act_fn_name, select_t = LITE_SUITE_CLIS[suite]
    phase(f"DiffuserLite CLI ({suite}): cli.diffuserlite_d4rl_{suite} mode=iql_training, "
          "training, then R1 requests")
    reset_counts()
    _, run, _, iql_seconds = run_cli(cli, SUITE_LITE_IQL)
    if not (run / "iql_ckpt_latest.pkl").exists():
        raise AssertionError("no iql_ckpt_latest.pkl")
    args, run, logs, seconds = run_cli(cli, SUITE_LITE_TRAIN)
    steps, levels = args.diffusion_gradient_steps, len(args.task.planning_horizons)
    if [lg["gradient_steps"] for lg in logs] != list(range(args.log_interval, steps + 1,
                                                           args.log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    if not all(np.isfinite(lg[f"loss{i}"]) for lg in logs for i in range(levels)):
        raise AssertionError(f"non-finite window means {logs}")
    check_checkpoints(run, args, steps, [f"diffusion{i}" for i in range(levels)] + ["invdyn"])
    print(f"IQL {SUITE_LITE_IQL[1]}: {iql_seconds:.1f} s; {steps} DiffuserLite steps (DiT "
          f"d_model {args.d_model} x depth {args.depth}, batch {args.batch_size}): {seconds:.1f} "
          f"s; last window {logs[-1]}", flush=True)

    base, pipe = cli.build(args, dev)
    pipe.load(str(run / "ckpt_latest"))
    iql = diffuserlite_d4rl_antmaze.build_iql(args, base, dev)
    iql.load(str(run / "iql_ckpt_latest.pkl"))
    E, K, w_cfgs = args.num_envs, args.num_candidates, cli.W_CFGS
    norm = base.get_normalizer()
    plan_fn = build_candidate_plan_fn(pipe, iql, E, K, 5, w_cfgs, select_t)
    act_fn = getattr(cli, act_fn_name)(args, plan_fn, norm,
                                       torch.Generator(device=dev).manual_seed(SEED))
    obs = rows_of(base.seq_obs, E)
    lat = []
    for _ in range(SUITE_CLI_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = act_fn(obs)
        lat.append((time.perf_counter() - t0) * 1e3)
        if act.shape != (E, pipe.act_dim) or not (np.isfinite(act).all()
                                                   and np.abs(act).max() <= 1.0):
            raise AssertionError(f"actions {act.shape} non-finite or outside [-1, 1]")
    counts = no_kernel_launched(f"the DiffuserLite {suite} CLI phase")
    print(f"{SUITE_CLI_REQUESTS} R1 requests x {E} envs x {K} candidates: plan latency ms "
          f"{[round(v, 3) for v in lat]} (the first one cold)", flush=True)

    n = SUITE_COMPARE_ENVS
    tgt = np.full((n, 1), 0.5, np.float32)
    noise = lite_noise(pipe, n, torch.Generator().manual_seed(SEED), K)
    card = build_candidate_plan_fn(pipe, iql, n, K, 5, w_cfgs, select_t)(
        None, obs[:n], tgt, noise=to_device(noise, dev))
    _, cpu_pipe = cli.build(args, torch.device("cpu"), base)
    cpu_pipe.load(str(run / "ckpt_latest"))
    cpu_iql = diffuserlite_d4rl_antmaze.build_iql(args, base, torch.device("cpu"))
    cpu_iql.load(str(run / "iql_ckpt_latest.pkl"))
    cpu = build_candidate_plan_fn(cpu_pipe, cpu_iql, n, K, 5, w_cfgs, select_t)(
        None, obs[:n], tgt, noise=noise)
    card_against_cpu(f"DiffuserLite {suite} ({n} envs x {K})", card, cpu,
                     ("candidates", "scores", "traj"))
    return counts


# ---------------------------------------------------------------------------
# SfBC, QGPO, SynthER and the consistency policy: the entry points, no kernel
class timed_calls:
    """Patch the method `owner.name` for the block so that each call is
    timed (seconds, the device synchronised around it) and kept with its
    arguments (self first) and return: the phases read what a CLI's
    pipeline did inside `pipeline(args)`."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.orig = fn = self.owner.__dict__[self.name]

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0, a, out))
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def check_window_logs(logs: list, steps: int, log_interval: int, keys) -> None:
    if [lg["gradient_steps"] for lg in logs] != list(range(log_interval, steps + 1,
                                                           log_interval)):
        raise AssertionError(f"log windows at {[lg['gradient_steps'] for lg in logs]}")
    if not all(np.isfinite(lg[k]) for lg in logs for k in keys):
        raise AssertionError(f"non-finite window means {logs}")


def served(act, obs, n: int, label: str, act_dim: int, reps: int = 1) -> dict:
    """One cold request, then `n` timed; each checked; then `reps` more
    profiled together (a request of under a millisecond is profiled 20 at
    a time), device busy per request. Returns the latencies, their median
    and the profile."""
    cold = act_requests(act, obs, 1, act_dim)
    lat = act_requests(act, obs, n, act_dim)
    median = statistics.median(lat)
    prof = profile_request(lambda: [act(obs) for _ in range(reps)], median * reps, ())
    prof["device_busy_ms"] /= reps
    prof["median_latency_ms"] = median
    print(f"{label}: {n} requests x {obs.shape[0]} envs: latency ms "
          f"{[round(v, 3) for v in lat]} (median {median:.3f}; cold {cold[0]:.3f}); one "
          f"profiled request: {json.dumps(prof)}", flush=True)
    return {"latency_ms": lat, "median_ms": median, "profile": prof}


def sampler_noise(rows: int, dim: int, steps: int, gen: torch.Generator) -> tuple:
    """An SDE sampler's explicit draws for `rows` x `dim`: (initial,
    per_step)."""
    return (torch.randn((rows, dim), generator=gen),
            torch.randn((steps, rows, dim), generator=gen))


def check_sfbc_cli(dev) -> dict:
    """SfBC's CLI as users run it: `mode=bc_training` window by window,
    `mode=critic_training` (two in-sample-planning iterations: one
    Monte-Carlo re-evaluation of every path of the data), then
    `ckpt_critic` served at 50 envs x 32 candidates, one request profiled and
    one held against the CPU. Returns the kernels' launches (all 0)."""
    cli = sfbc_d4rl_mujoco
    phase("SfBC CLI: cli.sfbc_d4rl_mujoco mode=bc_training, critic_training, then act")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, SFBC_CLI_BC)
    steps = args.bc_gradient_steps
    check_window_logs(logs, steps, args.log_interval, ("loss", "grad_norm"))
    check_checkpoints(run, args, steps, ("actor", "critic"))
    print(f"bc_training: {steps} steps in {len(logs)} windows at batch {args.batch_size} x "
          f"horizon 32 = {args.batch_size * 32} rows (SfBCUNet (512, 256, 128), emb 64): "
          f"{seconds:.1f} s with set-up and saves; steps/s per window "
          f"{[lg['steps_per_sec'] for lg in logs]}; last loss {logs[-1]['loss']:.4f}", flush=True)
    with timed_calls(SfBCPipeline, "monte_carlo_reevaluate") as mc:
        cargs, _, _, c_seconds = run_cli(cli, SFBC_CLI_CRITIC)
    crit = read_jsonl(run / "critic_training.jsonl")[-2 * (cargs.critic_gradient_steps
                                                             // cargs.log_interval):]
    if [(lg["iter"], lg["gradient_steps"]) for lg in crit] != [
            (i, s) for i in range(cargs.q_training_iters)
            for s in range(cargs.log_interval, cargs.critic_gradient_steps + 1,
                           cargs.log_interval)] or not all(np.isfinite(lg["critic_loss"])
                                                           for lg in crit):
        raise AssertionError(f"critic windows {crit}")
    if len(mc.calls) != cargs.q_training_iters - 1 or not (run / "ckpt_critic.critic").exists():
        raise AssertionError(f"{len(mc.calls)} re-evaluations; ckpt_critic missing?")
    mc_s, (_, seq_obs, *_), (target, _) = mc.calls[0]
    rows = seq_obs.shape[0] * seq_obs.shape[1] * cargs.monte_carlo_samples
    if target.shape != (seq_obs.shape[0], seq_obs.shape[1], 1) or not np.isfinite(target).all():
        raise AssertionError(f"re-evaluated targets {target.shape} non-finite?")
    print(f"critic_training: {cargs.q_training_iters} iterations x "
          f"{cargs.critic_gradient_steps} steps: {c_seconds:.1f} s; the re-evaluation of "
          f"{seq_obs.shape[0]} paths x {seq_obs.shape[1]} steps x {cargs.monte_carlo_samples} "
          f"samples ({rows} rows, {cargs.eval_actor_sampling_steps} ddpm steps, 8 paths per "
          f"call): {mc_s:.2f} s; critic loss per window "
          f"{[round(lg['critic_loss'], 4) for lg in crit]}", flush=True)

    dataset, pipe = cli.build(args, dev)
    pipe.load(str(run / "ckpt_critic"))
    obs = rows_of(dataset.seq_obs, args.num_envs)
    serve = served(cli.act_fn(pipe, args), obs, N_REQUESTS,
                   f"SfBC ({args.num_candidates} candidates, top {args.top_k_average}, "
                   f"{args.sampling_steps} ddpm steps)", pipe.act_dim)
    counts = no_kernel_launched("the SfBC CLI phase")

    n, K, k = args.num_envs, args.num_candidates, args.top_k_average
    noise = sampler_noise(n * K, pipe.act_dim, args.sampling_steps,
                          torch.Generator().manual_seed(SEED))
    kw = dict(num_candidates=K, top_k_average=k, sampling_steps=args.sampling_steps,
              temperature=args.temperature, return_info=True)
    act_c, info_c = pipe.act(obs[:n], noise=to_device(noise, dev), **kw)
    _, cpu_pipe = cli.build(args, torch.device("cpu"), dataset)
    cpu_pipe.load(str(run / "ckpt_critic"))
    act_p, info_p = cpu_pipe.act(obs[:n], noise=noise, **kw)
    gaps = {key: (info_c[key].cpu() - info_p[key]).abs().max().item()
            for key in ("candidates", "scores")}
    # the top-k set is the same wherever the k-th and the (k+1)-th scores are apart
    srt = info_p["scores"].sort(dim=-1, descending=True).values
    clear = (srt[:, k - 1] - srt[:, k]) > 2 * PLAN_ATOL
    same = (info_c["idx"].cpu().sort(-1).values == info_p["idx"].sort(-1).values).all(-1)
    if not same[clear].all():
        raise AssertionError("SfBC: the card's top-k differs from the CPU's where apart")
    gaps["act"] = (act_c.cpu()[same] - act_p[same]).abs().max().item()
    print(f"SfBC ({n} envs x {K}): card against CPU, same noise (TF32 off): max |diff| "
          f"{gaps} (limit {PLAN_ATOL}); top-k sets equal {int(same.sum())}/{n}", flush=True)
    if not all(v <= PLAN_ATOL for v in gaps.values()):
        raise AssertionError(f"SfBC: card and CPU differ: {gaps}")
    return counts


def check_qgpo_cli(dev) -> dict:
    """QGPO's CLI, every stage: `bc_training` window by window, the support
    of every next state (5,000 states x K per sampler call), the Q and CEP
    stages in windows on the shared store, then guided requests at 50 envs
    (`w_cg` from the task), one profiled and one held against the CPU.
    Returns the kernels' launches (all 0)."""
    cli = qgpo_d4rl_mujoco
    phase("QGPO CLI: cli.qgpo_d4rl_mujoco bc_training, supported_action_collecting, "
          "q_training, cep_training, then act")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, QGPO_CLI_BC)
    steps = args.bc_gradient_steps
    check_window_logs(logs, steps, args.log_interval, ("loss", "grad_norm"))
    if not (run / "diffusion_ckpt_latest").exists():
        raise AssertionError("no diffusion_ckpt_latest")
    print(f"bc_training: {steps} steps at batch {cli.BATCH}: {seconds:.1f} s; steps/s per "
          f"window {[lg['steps_per_sec'] for lg in logs]}", flush=True)
    with timed_calls(qgpo_d4rl_mujoco.QGPOPipeline, "collect_supported_actions") as col:
        _, _, _, s_seconds = run_cli(cli, ("mode=supported_action_collecting",))
    sup = np.load(run / "supported_act.npy")
    N = sup.shape[0]
    if sup.shape != (N, args.K, 6) or not (np.isfinite(sup).all() and np.abs(sup).max() <= 1):
        raise AssertionError(f"support {sup.shape} non-finite or outside [-1, 1]")
    batches = -(-N // cli.COLLECT_BATCH)
    print(f"supported_action_collecting: {N} states x K {args.K} in {batches} batches of "
          f"{cli.COLLECT_BATCH} states ({cli.COLLECT_BATCH * args.K} rows x 10 ddpm steps each): "
          f"{col.calls[0][0]:.2f} s ({s_seconds:.1f} s with set-up)", flush=True)
    for stage, keys in (("q_training", ("q_loss",)),
                        ("cep_training", ("loss", "f_max", "f_mean", "f_min"))):
        sargs, _, _, st_seconds = run_cli(cli, (f"mode={stage}", *QGPO_CLI_STAGE))
        n_steps = sargs.q_gradient_steps if stage == "q_training" else sargs.cep_gradient_steps
        st_logs = read_jsonl(run / f"{stage}.jsonl")[-(n_steps // sargs.log_interval):]
        check_window_logs(st_logs, n_steps, sargs.log_interval, keys)
        print(f"{stage}: {n_steps} steps at batch {cli.BATCH} in windows of "
              f"{sargs.log_interval}: {st_seconds:.1f} s; steps/s per window "
              f"{[lg['steps_per_sec'] for lg in st_logs]}; last window "
              f"{ {k: round(st_logs[-1][k], 4) for k in keys} }", flush=True)
    if not ((run / "q_state.pt").exists() and (run / "clf_ckpt_latest").exists()):
        raise AssertionError("q_state.pt or clf_ckpt_latest missing")

    dataset, pipe = cli.build(args, dev)
    pipe.actor.load(str(run / "diffusion_ckpt_latest"))
    pipe.classifier.load(str(run / "clf_ckpt_latest"))
    obs = dataset.obs[:args.num_envs]
    served(cli.act_fn(pipe, args), obs, N_REQUESTS,
           f"QGPO (w_cg {args.task.w_cg}, {args.sampling_steps} ddpm steps, final log p)",
           pipe.act_dim)
    counts = no_kernel_launched("the QGPO CLI phase")

    n = args.num_envs
    gen = torch.Generator().manual_seed(SEED)
    noise = (sampler_noise(n, pipe.act_dim, args.sampling_steps, gen),
             -torch.log(-torch.log(torch.rand((n, 1), generator=gen))))
    kw = dict(w_cg=args.task.w_cg, sampling_steps=args.sampling_steps, return_info=True)
    act_c, info_c = pipe.act(obs[:n], noise=to_device(noise, dev), **kw)
    _, cpu_pipe = cli.build(args, torch.device("cpu"), dataset)
    cpu_pipe.actor.load(str(run / "diffusion_ckpt_latest"))
    cpu_pipe.classifier.load(str(run / "clf_ckpt_latest"))
    act_p, info_p = cpu_pipe.act(obs[:n], noise=noise, **kw)
    drop = lambda info: {k: info[k] for k in ("candidates", "log_p")}  # one candidate per env
    card_against_cpu(f"QGPO ({n} envs)", (act_c, drop(info_c)), (act_p, drop(info_p)),
                     ("candidates", "log_p"))
    return counts


def check_synther_cli(dev, suite: str) -> dict:
    """SynthER's CLI of a suite, every mode: `train_diffusion` window by
    window, `transition_generation` (MuJoCo: one 100,000-row batch of 128
    ddpm steps, its seconds and TFLOP/s), `train_td3bc` on the real and
    synthetic mix (the actor's and targets' updates against `policy_freq`),
    then TD3+BC requests at 50 envs; a request and a generation chunk
    held against the CPU. Returns the kernels' launches (all 0)."""
    cli = {"mujoco": synther_d4rl_mujoco, "antmaze": synther_d4rl_antmaze,
           "kitchen": synther_d4rl_kitchen}[suite]
    train, n_trans, td3, n_req = SYNTHER_CLI["mujoco" if suite == "mujoco" else "suite"]
    phase(f"SynthER CLI ({suite}): cli.synther_d4rl_{suite} train_diffusion, "
          "transition_generation, train_td3bc, then act")
    reset_counts()
    args, run, logs, seconds = run_cli(cli, ("mode=train_diffusion", *train))
    steps = args.diffusion_gradient_steps
    check_window_logs(logs, steps, args.log_interval, ("loss", "grad_norm"))
    tags = [str(t) for t in range(args.save_interval, steps + 1, args.save_interval)]
    missing = [t for t in tags + ["latest"] if not (run / f"diff_ckpt_{t}").exists()]
    if missing:
        raise AssertionError(f"missing diff_ckpt_{missing} in {run}")
    print(f"train_diffusion: {steps} steps at batch {args.batch_size} (IDQLMlp "
          f"{args.get('hidden_dim', 1024)} x {args.get('n_blocks', 6)} blocks, "
          f"{args.diffusion_steps} diffusion steps): {seconds:.1f} s with set-up and "
          f"saves; steps/s per window {[lg['steps_per_sec'] for lg in logs]}", flush=True)
    with timed_calls(SynthERPipeline, "generate_transitions") as gen_calls:
        _, _, _, g_seconds = run_cli(cli, ("mode=transition_generation",
                                           f"num_transitions={n_trans}"))
    extra = np.load(run / "extra_transitions.npy")
    g_s, (synther, *_), _ = gen_calls.calls[0]
    if extra.shape != (n_trans, synther.x_dim) or not np.isfinite(extra).all():
        raise AssertionError(f"synthetic transitions {extra.shape} non-finite?")
    net = synther.diffusion.params["diffusion"]
    macs = sum(m.weight.numel() for m in net.modules() if isinstance(m, torch.nn.Linear))
    tflop = 2 * macs * n_trans * 128 / 1e12
    print(f"transition_generation: {n_trans} rows x 128 ddpm steps in one sampler call: "
          f"{g_s:.2f} s ({g_seconds:.1f} s with set-up), {tflop:.1f} TFLOP of f32 products "
          f"({macs} multiply-adds per row per step), {tflop / g_s:.2f} TFLOP/s", flush=True)
    targs, _, t_logs, t_seconds = run_cli(cli, ("mode=train_td3bc", *td3))
    t_steps = targs.td3bc_gradient_steps
    check_window_logs(t_logs, t_steps, targs.log_interval,
                      ("critic_loss", "policy_loss", "bc_loss", "policy_q"))
    state = torch.load(run / "td3bc.pt", map_location="cpu", weights_only=True)
    freq = 2  # TD3BC's policy_freq
    if (state["step"], state["actor_updates"], state["actor_optimizer"]["count"],
            state["critic_optimizer"]["count"]) != (t_steps, -(-t_steps // freq),
                                                     -(-t_steps // freq), t_steps):
        raise AssertionError(f"TD3+BC counts {state['step']}, {state['actor_updates']}, "
                             f"{state['actor_optimizer']['count']}")
    print(f"train_td3bc: {t_steps} steps at batch {targs.batch_size} on the real transitions "
          f"and {extra.shape[0]} synthetic ones: "
          f"{t_seconds:.1f} s; actor and target updates {state['actor_updates']} (policy_freq "
          f"{freq}); steps/s per window {[lg['steps_per_sec'] for lg in t_logs]}", flush=True)

    _, dataset, _ = cli.build(args, dev)
    agent = synther_d4rl_mujoco.build_agent(args, dataset, dev)
    agent.load(str(run / "td3bc.pt"))
    obs = dataset.obs[:args.num_envs]
    served(agent.act, obs, n_req, f"SynthER {suite} TD3+BC actor", agent.act_dim, reps=20)
    counts = no_kernel_launched(f"the SynthER {suite} CLI phase")

    cpu_agent = synther_d4rl_mujoco.build_agent(args, dataset, torch.device("cpu"))
    cpu_agent.load(str(run / "td3bc.pt"))
    n = args.num_envs
    gaps = {"act": (agent.act(obs[:n]).cpu() - cpu_agent.act(obs[:n])).abs().max().item()}
    print(f"SynthER {suite} TD3+BC ({n} envs): card against CPU: max |diff| {gaps} (limit "
          f"{PLAN_ATOL})", flush=True)
    if not gaps["act"] <= PLAN_ATOL:
        raise AssertionError(f"SynthER {suite}: card and CPU differ: {gaps}")
    # a generation chunk (128 ddpm steps, no clipping) against a float64
    # run of it on the CPU, beside the CPU's own float32 run
    _, _, cpu_syn = cli.build(args, torch.device("cpu"))
    cpu_syn.diffusion.load(str(run / "diff_ckpt_latest"))
    rows = SYNTHER_COMPARE_ROWS
    noise = [sampler_noise(rows, synther.x_dim, 128, torch.Generator().manual_seed(SEED))]
    card_x = synther.generate_transitions(rows, sampling_steps=128, noise=to_device(noise, dev))
    cpu_x = cpu_syn.generate_transitions(rows, sampling_steps=128, noise=noise)
    cpu_syn.diffusion.ema_params.double()
    cpu_syn._gen_fns.clear()
    ref = cpu_syn.generate_transitions(rows, sampling_steps=128,
                                       noise=[tuple(t.double() for t in noise[0])])
    err = {"card": float(np.abs(card_x - ref).max()), "cpu_f32": float(np.abs(cpu_x - ref).max()),
           "card_vs_cpu": float(np.abs(card_x - cpu_x).max()), "scale": float(np.abs(ref).max())}
    print(f"SynthER {suite} generation ({rows} rows x 128 steps): max |diff| against float64 "
          f"{err} (limit: the card's within {GEN_ERR_FACTOR}x the CPU float32's)", flush=True)
    if not err["card"] <= GEN_ERR_FACTOR * max(err["cpu_f32"], 1e-6):
        raise AssertionError(f"SynthER {suite}: the card's generation is further from float64 "
                             f"than {GEN_ERR_FACTOR}x the CPU's: {err}")
    return counts


def cp_noise(pipe, model: str, E: int, K: int, steps: int, gen: torch.Generator) -> tuple:
    """Explicit draws of one consistency-policy request: the sampler's (the
    EDM's initial draw; the consistency sampler's initial and per-step) and
    the pick's Gumbel noise (E, K)."""
    shape = (E * K, pipe.act_dim)
    if model.startswith("edm"):
        sample = torch.randn(shape, generator=gen)
    else:
        sample = (torch.randn(shape, generator=gen),
                  torch.randn((max(steps - 1, 1), *shape), generator=gen))
    return sample, -torch.log(-torch.log(torch.rand((E, K), generator=gen)))


def check_consistency_policy(dev) -> dict:
    """`cli/sp_consistency_policy.py` at the tutorial's sizes, then the
    hermetic gate on the card (IQL, EDM, distillation at batch 128 on the
    Goal2D behavior data; the EDM teacher at 5 Euler steps and the 2-NFE
    student over 128 episodes with 32 candidates per env), then requests
    at 50 envs x 32 candidates with each actor, one of each profiled and
    held against the CPU. Returns the kernels' launches (all 0)."""
    phase("consistency policy: cli.sp_consistency_policy, then the Goal2D gate and requests")
    reset_counts()
    t0 = time.perf_counter()
    res = sp_consistency_policy.main([])
    torch.cuda.synchronize()
    a = res["actions"]
    if a.shape != (sp_consistency_policy.NUM_ENVS, res["dataset"].a_dim) or not (
            torch.isfinite(a).all() and a.abs().max() <= 1.0):
        raise AssertionError(f"the entry point's actions {a.shape} non-finite or outside")
    if not all(np.isfinite(v) for log in res["logs"].values() for v in log.values()):
        raise AssertionError(f"non-finite stage logs {res['logs']}")
    print(f"cli.sp_consistency_policy (the tutorial's sizes): {time.perf_counter() - t0:.1f} s;"
          f" last logs {res['logs']}", flush=True)

    gate = goal2d_gate(dev, CP_STEPS, CP_BATCH, SEED)
    pipe, ds, teacher, student = gate["pipe"], gate["dataset"], gate["teacher"], gate["student"]
    print(f"Goal2D: IQL, EDM, distillation {CP_STEPS} steps at batch {CP_BATCH} (ms per step "
          f"{ {k: round(v, 3) for k, v in gate['ms'].items()} }; last CD loss "
          f"{gate['cd_loss']:.5f}); normalized score teacher (EDM, 5 Euler) {teacher:.4f} "
          f"(bar {CP_TEACHER_BAR}), student (CD, 2 NFE) {student:.4f} (bar {CP_STUDENT_BAR})",
          flush=True)
    if not (teacher >= CP_TEACHER_BAR and student >= CP_STUDENT_BAR):
        raise AssertionError(f"consistency policy Goal2D scores {teacher:.4f} / {student:.4f}")

    E, K = 50, 32
    obs = ds.obs[:E]  # normalised dataset observations
    ckpt = CLI_DIR / "consistency_policy" / "goal2d"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    pipe.save(str(ckpt))
    cpu_pipe = ConsistencyPolicyPipeline(obs_dim=2, act_dim=2, emb_dim=32, hidden_dim=128,
                                         curriculum_cycle=2000, s0=10, s1=160, rng=0,
                                         device="cpu")
    cpu_pipe.load(str(ckpt))
    for model, steps in CP_REQUESTS:
        act = lambda o: pipe.act(o, model=model, num_candidates=K, sampling_steps=steps)
        served(act, obs, N_REQUESTS, f"consistency policy {model} ({K} candidates, {steps} "
               "steps)", 2)
        noise = cp_noise(pipe, model, E, K, steps, torch.Generator().manual_seed(SEED))
        kw = dict(model=model, num_candidates=K, sampling_steps=steps, return_info=True)
        card = pipe.act(obs, noise=to_device(noise, dev), **kw)
        cpu = cpu_pipe.act(obs, noise=noise, **kw)
        card_against_cpu(f"consistency policy {model} ({E} envs x {K})", card, cpu,
                         ("candidates", "adv"))
    return no_kernel_launched("the consistency-policy phase")


def main() -> int:
    t_start = time.perf_counter()
    kind = check_device()
    dev = torch.device("cuda", 0)
    build_kernels(dev)
    k1 = check_kernel(dev)
    k1_bf16 = check_kernel_bf16(dev)
    k3 = check_film_kernel(dev)
    check_film_kernel(dev, ANTMAZE_UNET_BLOCKS, "antmaze")
    k2 = check_solver_kernel(dev)
    k1_launches = check_slice(dev)
    check_slice(dev, "antmaze", 1)  # horizon 64: K1 on clusters of two thread blocks
    k1_bf16_launches = check_slice_bf16(dev)
    check_slice_bf16(dev, "antmaze", 1)
    k3_launches, k2_launches = check_diffuser_slice(dev)
    check_kernel_autograd(dev)
    check_kernel_autograd(dev, 64, "antmaze")  # DD antmaze's training forward, on clusters
    k1_train, k2_dd_train, _ = check_dd_training(dev)
    k1_bf16_train, _ = check_dd_training_bf16(dev)
    k3_train, k2_diffuser_train, _ = check_diffuser_training(dev)
    check_checkpoint(dev)
    check_goal2d(dev)
    cache_cli_data()
    cli = {**check_dd_cli(dev), **check_diffuser_cli(dev)}
    for suite in ("antmaze", "kitchen"):
        cli["dit_block"].update(check_dd_suite_cli(dev, suite))
    for suite in ("antmaze", "kitchen"):
        k3_cli, k2_cli = check_diffuser_suite_cli(dev, suite)
        cli["film_resblock"].update(k3_cli)
        cli["solver_update"].update(k2_cli)
    for suite in ("mujoco", "antmaze"):
        cli["film_resblock"].update(check_adaptdiffuser_cli(dev, suite))
    # the RL policies' path (MLPs) launches none of the kernels
    rl = {family: check_rl_cli(dev, family) for family in ("dql", "idql", "edp")}
    rl.update({f"{family}_{suite}": check_rl_suite_cli(dev, family, suite)
               for suite in ("antmaze", "kitchen") for family in ("dql", "idql", "edp")})
    check_dql_goal2d(dev)
    # Diffusion Veteran and DiffuserLite (plain blocks, as the reference
    # builds them): no kernel launch in these phases
    planners = {f"veteran_{suite}": check_veteran_cli(dev, suite) for suite in VETERAN_CLIS}
    planners["diffuserlite_mujoco"] = check_diffuserlite_cli(dev)
    planners.update({f"diffuserlite_{suite}": check_diffuserlite_suite_cli(dev, suite)
                     for suite in LITE_SUITE_CLIS})
    # SfBC, QGPO, SynthER and the consistency policy (MLPs): no kernel launch
    # in these phases
    rl2 = {"sfbc_mujoco": check_sfbc_cli(dev), "qgpo_mujoco": check_qgpo_cli(dev)}
    rl2.update({f"synther_{suite}": check_synther_cli(dev, suite)
                for suite in ("mujoco", "antmaze", "kitchen")})
    rl2["consistency_policy"] = check_consistency_policy(dev)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s ({cuda_ms.longer_spins} "
          "timings repeated with a longer spin)", flush=True)
    record = lambda name, route, source, replaces, launches, train_launches, k: {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches, "train_launches": train_launches,
        # the CLI phases: training through the CLI and serving its checkpoint
        "cli_launches": {**cli[name], **{f"{f}_cli": c[f"fused_{name}"] for f, c in rl.items()},
                         **{f"{p}_cli": c[f"fused_{name}"] for p, c in planners.items()},
                         **{f"{p}_cli": c[f"fused_{name}"] for p, c in rl2.items()}},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        # no single PyTorch call computes any of these blocks or steps
        "library_ms": None}
    print(json.dumps({"kernels": [
        record("dit_block", "cuda", "cleandiffuser_tpu_torch/csrc/dit_block.cu",
               "cleandiffuser_tpu/ops/dit_block.py:125", k1_launches, k1_train, k1),
        # the same TPU kernel with bf16 weights: its plan and training launches
        # are those of the bf16_sampling and bf16_training phases
        record("dit_block_bf16", "cuda", "cleandiffuser_tpu_torch/csrc/dit_block.cu",
               "cleandiffuser_tpu/ops/dit_block.py:125", k1_bf16_launches, k1_bf16_train,
               k1_bf16),
        record("film_resblock", "cuda", "cleandiffuser_tpu_torch/csrc/film_resblock.cu",
               "cleandiffuser_tpu/ops/film_resblock.py:159", k3_launches, k3_train, k3),
        # a sampler step: the training steps read 0 (and fail otherwise)
        record("solver_update", "triton", "cleandiffuser_tpu_torch/ops/solver_update.py",
               "cleandiffuser_tpu/ops/solver_update.py:75", k2_launches,
               k2_dd_train + k2_diffuser_train, k2),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
