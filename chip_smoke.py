"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python chip_smoke.py

Drives ``gymrl_tpu_torch``'s main path, PPO on LunarLander, and every
ported family (off-policy, DQN, recurrent, mHC, tabular, pixels) on the card,
then the distributed layer, the profiling hooks and the hand-written lander
and PPO-update kernels against their plain versions, and checks what comes
out. Every phase raises on failure; the script exits 0
only if all of them pass.

  0. Device: a CUDA device must be present; prints ``nvidia-smi``'s name
     and power limit for the card.
  1. Physics: B=8192 lander states, made by rolling the port on the CPU
     with random actions until about 40% of them touch the ground, are
     stepped once on the card (the ``lander_step`` kernel, which this first
     lander step on the card builds with nvcc; ``build_s`` is printed after
     phase 2, whose first grad step builds ``ppo.cu``) and once on the CPU (the plain path) with the same actions
     and dispersion draws. Kinematics and rewards must agree to 1e-4; at
     most 8 of the 8192 envs may differ more, or in their contact and
     termination flags (a contact test that ties within float32 rounding
     on one side only).
  2. Bench config (``bench_config``: B=8192, T=64, 4 epochs of
     minibatch 16384, flat optimizer, bf16 SGD): two warm-up ``train_iter``s
     and three timed ones. Prints env-steps/s, each phase's time from CUDA
     events (rollout; next-value forward plus GAE; SGD) and the peak device
     memory, and checks the step count, finite metrics, moved params and
     Adam's step count. The rollout and the SGD sweep are the graph path's
     (phase 20): the first warm-up eager, the second a capture and its
     replay, the timed ones replays; each graph's captures and replays are
     printed and checked.
  3. Entry point: the CLI's ``ppo_lunarlander`` workload through
     ``TrainLoop`` for three iterations with its checkpoint in a temporary
     directory, then ``TrainLoop.test`` (five deterministic episodes), then
     a restore of the saved checkpoint into a fresh state; its rollout and
     sweep graphs' one capture and two replays each printed and checked.
  4. Classic envs: B=8192 CartPole, Pendulum and continuous-lander states,
     made on the CPU from a fixed seed, stepped once on the card and once
     on the CPU with the same actions and draws. Each state field and the
     reward must agree to 1e-5 (1e-4 for the lander, as in phase 1); at
     most 8 envs may differ more, or in a flag.
  5. Off-policy updates: one update of DQN, DDPG, TD3, SAC and discrete SAC
     at the CLI configs' widths, on the card and on the CPU from the same
     params, the same sampled batch and the same draws (made on the CPU).
     Losses agree to rtol 1e-5 (the actor and α losses read the critic the
     same update stepped and tanh-saturated log-probs, so they get an atol
     of 1e-4 besides); params to 1e-5, except the entries whose step
     float32 agreement does not fix, held to 2·lr: a gradient below
     1e-6·max|g| of its tensor or below 1e-6 (Adam's eps 1e-8 turns its
     rounding into a sign), or a ReLU whose pre-activation for a sample
     lies within 1e-5 of zero (its row and column).
  6. Off-policy workloads: each of the CLI's dqn_cartpole, ppo_cartpole,
     sac_pendulum, sac_cartpole, td3_pendulum and ddpg_pendulum through
     ``TrainLoop`` for one warm-up iteration, then two timed iterations
     (env-steps/s, updates/s, per-phase CUDA-event times summed over the
     iteration, peak memory), ``TrainLoop.test`` (five episodes), and a
     checkpoint restore into a fresh state. Checks the env-step, replay and
     learn-step counts, finite metrics, that every online net moved and
     stayed on the card, each Adam step count against its cadence (TD3's
     actor on learn steps 0, 2, 4, ...; DQN's target syncs = episodes // 4)
     and that the restore brings back every field but the replay as it
     was saved, with the fresh, empty replay of the example it restores
     into, as the JAX package's restore does (no checkpoint holds a replay).
  7. PER and FlappyBird: B=8192 FlappyBird states, made on the CPU by a
     fixed-seed random-action rollout with autoreset, stepped once on the
     card and once on the CPU with the same actions and respawn draws
     (fields and reward to 1e-5, at most 8 envs may differ more or in a
     flag). The PER sum-tree at ddqn_per's capacity 65,536 (batch 64) and
     rainbow's 32,768 (batch 256): pushes that wrap the ring and priority
     updates with duplicate indices, the same inputs on both devices; then
     the tree (every node to rtol 1e-5 of the CPU's, plus 1e-6 of the
     total: the card's atomics add a level's deltas in any order),
     ``tree[1]`` against a float64 sum of the leaves (printed, and held to
     rtol 1e-3: the tree carries the rounding of every past delta, as the
     JAX package's does bit for bit on the CPU; a push of many equal
     priorities rounds every delta the same way at the root, so the drift
     adds up, 4.4e-4 after these pushes on the CPU), and from the same
     uniforms the sampled leaf indices (exact, except where the two paths
     part at a level whose target lay within 1e-5 of the total of the left
     sum the CPU's descent compared it with; those are counted and printed)
     and the IS weights (rtol 1e-5).
  8. DQN-family updates: one update of each of the five family presets at
     its CLI width, on the card and on the CPU from the same params, the
     same replay contents, sampled draws and NoisyNet ε (made on the CPU).
     Losses and β agree to rtol 1e-5, the written-back sum-tree to rtol
     1e-5 plus 1e-6 of the total, params to 1e-5 under phase 5's rules, the
     tie rule extended to PReLU's kink and to the net's wiring
     (``QNet.activation_edges``).
  9. DQN-family workloads: the CLI's ddqn_per_cartpole,
     ddqn_per_duel_cartpole, noisy_dqn_cartpole, rainbow_dqn_cartpole and
     noisy_dqn_flappybird as in phase 6, checking besides the PER fill,
     ``tree[1] > 0`` and finite, β for its mode (+0.001 per sample capped
     at 1, or the progress anneal), the target syncs for their mode
     (episodes // 4, learn steps // freq, or a soft target that moved),
     and the n-step warm gate: rainbow's replay size and PER ``pos`` equal
     pushes from the n-th vector step on only (1472 after three
     iterations, where a push from the first step would give 1536).
 10. The recurrent pieces, card vs CPU, from inputs made on the CPU:
     ``episode_buffer_pack`` of a [128, 32] rollout whose dones put up to
     ~25 episodes in a column (R=8 rows each), with every field and both
     dropped counts exact; the hoisted ``_seq_forward`` of the
     ``ppo_rnn_flappybird`` (512) and ``ppo_rnn_lunarlander`` (256) nets on
     [64, 128] rows (half from a carried hidden, half from zero): logits,
     values and the last hidden on the card against the CPU and against
     the card's own step-by-step forward, to ``SEQ_ATOL``; one phase-1
     step of both recurrent-PPO presets and one auxiliary step of PPG per
     clone target on the same packed whole-episode minibatch: the loss to
     rtol 1e-5, params under phase 5's rules with phase 8's tie rule along
     ``activation_edges`` (Adam's eps is 1e-5 and lr 1e-3 here).
 11. The recurrent CLI workloads, ppo_rnn_lunarlander, ppo_rnn_flappybird
     and ppg_rnn_lunarlander, at full width (32 envs × 128 steps, 10
     epochs of 4 minibatches of 64 episode rows), as in phase 6: one
     warm-up iteration through ``TrainLoop``, two timed ones (env-steps/s,
     rollout / next values + GAE / SGD / auxiliary phase times from CUDA
     events, peak memory, the dropped-episode metrics), ``TrainLoop.test``
     (five episodes, hidden carried) and a checkpoint restore. PPG starts at
     six iterations' worth of env steps, so the first timed iteration
     (index 7) runs the auxiliary phase and the second skips it. Checks the
     env-step and obs-statistics counts, that the hidden is zero exactly in
     the envs whose last step ended an episode, finite metrics, Adam's step
     count (40 per iteration, 24 more on PPG's auxiliary iteration), the
     auxiliary metrics nonzero exactly where the phase ran, that every
     parameter moved and the state stayed on the card, and the restore.
 12. The mHC family's pieces, card vs CPU, from inputs made on the CPU:
     ``sinkhorn_knopp`` on 4096 [2, 2] blocks (P, u, v to rtol 1e-5);
     ``MHCBackbone(256, 2, 2, 10)`` with nonzero ``w`` on 4096 rows, its
     output to ``SEQ_ATOL`` and its stop-gradient gradients to rtol 1e-5
     plus 1e-5 of each tensor's largest entry; ``URNNCell`` gru(512) and
     lstm(512) unrolled over [128, 8], against the CPU and against the
     card's own stepwise forward, to ``SEQ_ATOL``; one grad step each of
     the ``ppo_full`` preset, the same with ``clip_cov_ratio`` 0.2 on the
     same uniforms, and the ``ppo_lstm`` preset, on the same minibatch
     (1024 rows; 128 sequences × 8 steps) from the same params (the actor
     head ×500 and ``w`` nonzero, so ERC and clip-cov act): the loss to
     rtol 1e-5, params under phase 5's rules with phase 10's tie rule on
     every PReLU unit, the RND pair's included. ERC's tie rule: a sample
     whose entropy ratio the devices put on different sides of 1 ± 0.06
     must lie within ``ERC_TIE`` of the edge, and the CPU's step then takes
     the card's side; clip-cov's masks must be equal, unless a covariance
     lies within ``COV_TIE`` of a band edge on different sides (the CPU then
     takes the card's mask). The RND target must stay equal to the bit.
 13. The mHC-family CLI workloads, ppo_full_lunarlander and
     ppo_lstm_lunarlander, at full width (64 envs × 64 steps, 4 epochs of
     4 minibatches of 1024 rows / 128 sequences of 8 steps), as in phase
     11: one warm-up iteration through ``TrainLoop``, two timed ones
     (env-steps/s, rollout / next values + GAE / SGD times from CUDA
     events, peak memory), ``TrainLoop.test`` (five episodes, the hidden
     carried for ppo_lstm) and a checkpoint restore. Checks the env-step
     count, Adam's step count (16 per iteration), that lr and the entropy
     coefficient follow the anneal, that the hidden is zero exactly at the
     last dones, finite metrics, that every parameter moved except the RND
     target (equal to the bit), that the state stayed on the card, and the
     restore.
 14. The tabular workloads: B=8192 FrozenLake, CliffWalking and MountainCar
     states, made on the CPU by random-action steps with autoreset, stepped
     once on the card and once on the CPU with the same actions and draws
     (the grids exact, no env may differ; MountainCar to 1e-6, at most 8
     envs off). ``torch.argmax`` on the card picks the first maximum (a zero
     table gives action 0; a table full of ties picks what the CPU picks).
     One Q-learning vector step (ε-greedy act, env step, the segment-mean
     scatter) of each preset at its CLI width and at 8192 envs, card vs
     CPU, from the same table (learned by 3 CPU iterations and rounded to
     1/8, so that ties are common), env batch and draws: actions and the
     env batch exact (greedy ties counted), the scatter's counts exact, the
     table to rtol 1e-6 plus 1e-6 of its largest entry (the card adds the
     TDs of duplicate pairs in another order). Then qlearning_frozenlake
     and qlearning_cliffwalking through ``TrainLoop`` as in phase 6
     (warm-up, two timed iterations with act / env / update CUDA-event
     times, test, restore), and mountaincar_baseline through its CLI entry
     and its 10-episode eval, which must reach the flag every time.
 15. Pixels and rendering: B=4096 CartPolePixels states stepped card vs CPU
     as in phase 4 (frames and the nested CartPole state to 1e-5: pixel
     coordinates near 48 carry float32 ulps of 3.8e-6; at most 8 envs off);
     the ``ConvEncoder`` trunk on a [32, 48, 48, 4] batch card vs CPU to
     ``SEQ_ATOL``, with both TF32 flags printed and required off; one
     ``dqn_cartpole_pixels`` update card vs CPU under phase 8's rules, on
     uint8 frames of a CPU rollout; the ``dqn_cartpole_pixels`` workload as
     in phase 9, its replay's frame stores uint8; and ``render_episode``'s
     rollout (``TrainLoop.episode_frames``, no GIF: the card's machine has
     no PIL) of a lander and a FrozenLake episode from card states, every
     frame uint8 of the renderer's shape.
 16. The distributed layer (``gymrl_tpu_torch/distributed``), every world
     in child processes (``distributed/launch.py``) with a deadline. (a) A
     world of one on NCCL on ``cuda:0``: ``dryrun_multichip(1)`` (PPO,
     Rainbow, SAC and PPO-LSTM at the JAX dry run's sizes), then one
     bench-config iteration unsharded and one under ``make_mesh(1, 1)``,
     which must be equal to the bit (every state tensor, the metrics, the
     episodes). (b) Two ranks sharing the card over gloo with CUDA tensors
     (NCCL refuses two ranks on one device), one world for all cases: the
     bench config on two data ranks; ``ppo_lunarlander``'s preset with its
     trunk split over two model ranks (hidden 256); ``rainbow_dqn_cartpole``,
     ``sac_pendulum`` and ``ppo_lstm_lunarlander`` on two data ranks, the
     two off-policy presets' iterations cut to end with their first env
     step that updates (16 updates). Uncut, neither can be held: Rainbow's
     unsharded iteration (208 updates) does not repeat itself on the card
     (its PER write-back is an ``index_add_``, atomic adds whose order
     varies; SAC, which has none, repeats to the bit), and SAC's sharded
     iteration (400 updates) drifts to 7.1e-2 in the params and 3.9e-2 in
     the env states, as Adam's eps turns rounding into ±lr steps and the
     changed actions into other transitions (``PERF.md``). Each sharded
     iteration is held against the unsharded one on the card under
     ``_dist_check``'s rules (the env batch, episodes, noise stream and
     replay transitions exact, the replay, which no checkpoint holds, read
     from rank 0's state; every param entry to 1e-5, the bf16 bench
     config's to 2·lr·steps·2^-8; the metrics to rtol 1e-5, the bench
     config's to 2^-8). (c) The checkpoint saved under (b)'s
     trunk split holds whole tensors and restores into a fresh state of the
     same mesh, equal to the bit. Prints the backends, the world, each
     mesh, each case's largest errors beside their bounds and the sharded
     and unsharded wall times (the card's own, not a claim).
 17. Profile: one bench-config and one ``ppo_lunarlander`` iteration under
     ``utils.profiling.trace`` (a Chrome trace on disk), after a warm-up
     and the iteration that captures the sweep, so the traced one replays
     it: CUDA kernel launches per iteration, summed kernel time and the
     busy share (the union of kernel intervals over the iteration's wall
     time, traced and untraced). (b) The program's spans
     (``utils.profiling.span``) on ``ppo_lunarlander``, the benchmark's
     cell, ``phase_spans``: the set-up's spans; the mean host time of the
     ``rollout.replay`` span (and of ``policy`` and ``env.step``, which run
     only where the rollout is eager) over 30 iterations, in which nothing
     is captured or compiled again; and 3 iterations under
     ``torch.profiler`` read by ``utils.profiling.span_trace``: every
     kernel put down to the span of its launch call (or counted as having
     none in the trace, which only the hand-written kernels may lack), every
     ``lander_step`` inside ``rollout.replay`` and every ``clip_adam``
     inside ``sgd``, launch calls per rollout step, kernels per rollout
     replay and per grad step, the idle share inside ``rollout`` and the
     idle time by span. (c) The same on ``ppo_lstm_lunarlander`` (its
     rollout and sweep replayed), over 5 window iterations,
     with at least 99% of its kernels put down to a span; both cases give
     the mean host time of an ``sgd.replay`` span and the kernels a replay
     of the sweep puts down to it, and
     the kernels, device ms and launch calls an iteration under each of
     ``mhc``, ``mhc.sinkhorn``, ``rnd``, ``rnn.unroll``, ``policy``,
     ``env.step``, ``rollout``, ``gae`` and ``sgd``.
 18. The lander kernels (``gymrl_tpu_torch/kernels/lunarlander.cu``)
     against the plain path on the card, from the same inputs, at every
     batch the main path gives them (32, 64 and 8192 envs: the lander CLI
     workloads' and the bench config's, ``kernel_envs``): (a)
     ``lander_reset`` against ``reset_from_plain``, wind off and on, and
     from draws that lie off 16 bytes at 5 envs fewer than the widest batch
     (a ragged last block); (b)
     ``lander_step`` against ``step_from_plain`` from every state of a
     200-step random-action ``VecEnv`` rollout on the kernels (discrete and
     continuous, each without and with wind; by step
     ~90 about 40% of the landers touch the ground, and crashes, landings
     and autoresets follow). Every float field, the obs and the reward must
     agree to 1e-6 and at most 8 envs may differ more or in a flag (phase 1's
     tie rule); the card reads 0 everywhere. (c) ms per call of each kernel
     and of its plain version (CUDA events over 100 calls after a warm-up),
     at those batches and at one env (the latency of one env's chain), the
     step on a fresh reset's states (every lander in the air) and on those
     of a 90-step random-action rollout (some on the ground, as on the main
     path; the kernels line takes these), the
     device's time per kernel and kernels per call (traces; a trace that
     does not hold one kernel a call is refused and taken again, at most
     five times, after which the device time is not measured), and the
     bound: the bytes the function must read and write (without wind the
     step reads no wind index and no leg contact) over 3.35 TB/s or the
     operations over 67 TFLOP/s, the larger. (d) The CUDA launches of one lander
     ``VecEnv.step`` at 8192 envs under ``utils.profiling.trace``: at most 60.
     (e) With nvcc missing, and with an nvcc that refuses the source (a
     stand-in script), a lander step on the card raises and launches
     nothing: no fallback to the plain path. (f) The kernels' own sin and
     cos (``lib_sincosf``: the library's algorithm with its Payne-Hanek
     words in registers, so ``lander_step`` keeps no stack) against the CUDA
     library's ``sinf`` and ``cosf`` on every one of the 2^32 float32
     inputs: equal to the bit (two NaNs agree).
  Phases 2, 3, 11 and 13 run with the kernels' launch counts set to 0 just
  before them, and fail unless both lander kernels launched in them; phases
  2 and 3 (``PPOTrainer``) also unless each of PPO's four update kernels
  launched once per grad step (128 per bench iteration, 320 per
  ``ppo_lunarlander`` iteration; a replay of the sweep's graph counts the
  launches its capture recorded). ``phase_kernels_each_card`` (not in
  ``main``, which needs one card) runs 18 (a)-(b) and 19 (a)-(b) on every
  other card of a machine with more, and fails unless PyTorch's current
  device stays on the first.
 19. PPO's update kernels (``gymrl_tpu_torch/kernels/ppo.cu``) against
     their plain versions on the card. (a) The loss head: ``PPOHeadLoss``
     (``ppo_loss_fwd`` and ``ppo_loss_bwd``) against ``ppo_head_loss_plain``
     and autograd on every minibatch of an epoch, at the bench config's
     shape (16,384 rows, logits from ``forward_bf16``) and
     ``ppo_lunarlander``'s (64 rows, f32); the rows are a real rollout's,
     logp_old from the seed's params, and the params those of a later
     iteration once the ratios lie on both sides of the clip band and under
     the dual clip (``_covering_rows``; the bench config trains with its lr
     anneal off, which would stop it at its second iteration). The loss and
     the metrics within 1e-6 relative of their exact means (float64 means of
     the plain path's own float32 row terms; the plain path's float32 mean of
     the policy objective, whose terms cancel, is itself ~1e-5 off and is
     printed), ``clip_frac`` equal to the plain one, dlogits and dvalues within
     1e-6 of each tensor's largest entry; rows within 1e-6 of 1 ± clip_eps
     or of ``min_surr == 3 * adv`` are counted and left out of dlogits. The
     same bounds, but for covering the band, on the first 1, 64, 16,383 and
     16,384 rows of the bench's first minibatch (one block; 64 blocks, with
     and without a ragged last block), on all of them with the
     columns spread apart (the strided loads; the minibatch's own take one
     float4 a row), and on ``ppo_cartpole``'s rows (A = 2: every 64-row
     minibatch of an epoch, and the same shapes from its rows repeated to
     16,384). Two ``ppo_loss_fwd`` launches on the same inputs must give the
     same bits; dlogits and dvalues must equal autograd's bits (the tie rows
     left out of dlogits), and ``ppo_loss_bwd`` must give the same bits on a
     rerun and from a copy of the logits off 16 bytes (its scalar rows).
     (b) The squares: ``grad_sq_norms`` on a minibatch's real gradients,
     as they come and with each tensor scaled by its own power of 2, on a
     40-tensor table (two launches), and on views of one buffer
     off 16 bytes or with a ``numel % 4`` tail, each square within 1e-6 of
     its float64 sum relative to itself, and within 1e-6 of the largest
     plain square (``torch._foreach_norm``, squared) against the plain one,
     at both shapes; two launches give the same bits. The clip with Adam:
     ``clip_adam_`` against ``clip_adam_plain_`` for
     10 steps from copies of the trained net and Adam (the bench's with
     ``foreach``, the CLI's without), fed the same real gradients scaled to a
     global norm of 5 (the clip at 0.5 acts) and 0.05 (it does not): params
     within 1e-6, ``exp_avg`` and ``exp_avg_sq`` within 1e-6 of each tensor's
     largest entry, the norm within 1e-6 relative; whether equal to the bit
     is printed. The same at ``ppo_lstm_lunarlander``'s net (77 tensors,
     three launches of each kernel a step, each reading all 77 squares) on
     drawn gradients, with ``foreach`` and without, and its grad step's
     route (``clip_adam_plain_norm_``: the plain clip, then ``clip_adam``
     with its clip off) equal to the bit to the plain. (c) One bench-config
     and one ``ppo_lunarlander`` iteration on the kernels against one with
     the plain versions patched into ``algos.ppo``, from the same init and
     noise, under phase 16's rules (``_dist_check``). (d) ms per call of
     each kernel, its plain version
     and, for ``grad_sq_norms`` and ``clip_adam``, the library call
     (``torch._foreach_norm``; the clip and ``torch.optim.Adam(fused=True)``)
     at both shapes and at ``ppo_cartpole``'s (64 rows, A = 2), and of
     ``grad_sq_norms`` and ``clip_adam`` at ``ppo_lstm_lunarlander``'s net,
     the device times from traces (refused and taken again, at most five
     times, until the trace holds exactly one kernel a call, three at the
     recurrent net), and the bound;
     each kernel's registers, stack and spills from ``nvcc -Xptxas -v`` on
     both sources, none of either for ``ppo_loss_fwd`` and ``ppo_loss_bwd``
     (every instantiation), ``grad_sq_norms``, ``clip_adam``,
     ``lander_step`` (all four instantiations) and ``lander_reset`` (both),
     and the lander
     kernels' local loads and stores in their SASS (``cuobjdump -sass``,
     where the toolkit has it). (e) The
     CUDA launches of one grad step (``PPOTrainer._minibatch_step``) on the
     kernels and on the plain versions, at both shapes, and the host time of
     its parts (forward, head, backward, clip with Adam) by the host clock,
     from timing shims patched around the step's head and update.
 20. The rollout and the SGD sweep as CUDA graphs (``algos.base.RolloutGraph``,
     ``SweepGraph``) against the eager ones. (a) One ``clip_adam`` launch
     of the ctypes library (its own CUDA runtime, linked statically)
     captured on a side stream with its step terms on the card
     (``kernels.ppo.device_terms``) and replayed twice: the capture runs
     nothing, the replays equal two eager launches to the bit. (b) The
     bench config, ``ppo_lunarlander``, ``ppo_cartpole`` and the recurrent
     ``ppo_lstm_lunarlander`` (its sweep through its ``_sgd``, Adam on
     ``clip_adam`` after the plain clip, no other update kernel), 4
     iterations each from ``init(0)`` with
     ``graphs`` off and on (the warm-up, the captures with their replays,
     two replays): the rows each iteration hands to its update (``_sgd``)
     equal to the bit, and every state entry (params,
     ``exp_avg``, ``exp_avg_sq``, the step counts, the env batch, the
     noise's generator) and every metric equal to the bit, else params and
     moments within ``ADAM_TOL`` and metrics within ``HEAD_RTOL`` with all
     else equal (whether equal to the bit is printed); each update kernel
     once per grad step (the recurrent trainer's ``clip_adam`` once per
     piece of ``MAX_TENSORS`` tensors, its 77 in three) and each lander
     kernel once per env step on both
     paths, counted per replay on the graph; one capture and three replays
     of each graph the trainer has. Each path's rollout and SGD ms (CUDA
     events), env-steps/s, launch calls and kernels per rollout step (one
     rollout traced), launches per grad step (one update traced), the
     ``rollout.capture`` and ``sgd.capture`` spans' seconds and peak
     memory.
     (c) On ``ppo_lunarlander``, ``ppo_cartpole`` and
     ``ppo_lstm_lunarlander`` both paths also save a
     checkpoint after iteration 2 and, after iteration 4, restore it into
     ``init(1)`` and run one more iteration: both graphs capture anew (two
     captures and four replays each) and the two paths still agree under
     (b)'s rule.
  ``phase_solve`` (not in ``main``) trains ``ppo_lunarlander`` on the graph
  path through ``TrainLoop.train(..., seed=s)`` for seeds 0-2 to avg100 ≥
  200 and prints the env steps each took.

The line before the last is the kernel list: each kernel's launches in
phase 2 (the bench config), its largest error against the plain path in
phases 18 and 19, and its times and bound at the bench config's shapes. The
last line of output is one JSON object naming the device.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import tempfile
import time

import torch

PHYS_ENVS = 8192
PHYS_WARM_STEPS = 90  # random-action steps until ~40% of landers touch the ground
PHYS_ATOL = 1e-4
PHYS_MAX_TIES = 8
BENCH_TIMED_ITERS = 3
BENCH_WARM_ITERS = 2  # the warm-up and the graphs' capture
ENTRY_ITERS = 3
CLASSIC_ENVS = 8192
CLASSIC_WARM_STEPS = 40
CLASSIC_ATOL = 1e-5
UPDATE_RTOL = 1e-5
UPDATE_LOSS_ATOL = 1e-4  # actor and α losses (see the module docstring)
PARAM_ATOL = 1e-5
TINY_GRAD = 1e-6
RELU_TIE = 1e-5
WORKLOADS = ("dqn_cartpole", "ppo_cartpole", "sac_pendulum", "sac_cartpole", "td3_pendulum",
             "ddpg_pendulum")
WORKLOAD_TIMED_ITERS = 2
FLAPPY_WARM_STEPS = 120  # random flaps: every bird has died and pipes have respawned
PER_ROUNDS = 10
PER_TREE_RTOL = 1e-5
PER_ROOT_RTOL = 1e-3  # the reference's own drift (module docstring)
PER_WEIGHT_RTOL = 1e-5
PACK_STEPS, PACK_ENVS, PACK_ROWS = 128, 32, 8  # the recurrent presets' rollout and R
SEQ_ROWS = 64  # rows of a recurrent minibatch
SEQ_ATOL = 1e-5  # the re-unroll's tolerance (module docstring)
MHC_ROWS = 4096  # Sinkhorn blocks and backbone rows of phase 12
URNN_SHAPE = (128, 8)  # ppo_lstm's minibatch: sequences × steps
ERC_TIE = 1e-5  # an entropy ratio this close to ERC's band edge may fall on either side
COV_TIE = 1e-5  # a covariance this close to clip-cov's band edge may fall on either side


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_config():
    """The bench config, the JAX package's ``bench.py`` config: B=8192 envs ×
    T=64 steps, 4 epochs × minibatch 16384 (128 grad steps per 524,288-step
    rollout), flat optimizer, bf16 SGD, unroll 8 (a no-op in the port). At
    its ``max_train_steps`` the lr anneals to 0 from the third iteration."""
    from gymrl_tpu_torch.algos.ppo import PPOConfig

    return PPOConfig(env_name="LunarLander-v3", num_envs=8192, rollout_steps=64,
                     minibatch_size=16384, num_epochs=4, flat_optimizer=True, sgd_bf16=True,
                     sgd_unroll=8, rollout_unroll=8)


def phase_physics(device: torch.device, num: int = PHYS_ENVS,
                  warm_steps: int = PHYS_WARM_STEPS) -> dict:
    """One lander step on ``device`` against the same step on the CPU."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.rollout import VecEnv

    env = LunarLander()
    params = env.default_params()
    venv = VecEnv(env, params, num)
    noise = Noise("cpu", 0)
    actions_gen = torch.Generator().manual_seed(1)

    def random_actions():
        return torch.randint(0, env.n_actions, (num,), generator=actions_gen, dtype=torch.int32)

    vs = venv.reset(noise)
    for _ in range(warm_steps):
        vs, _ = venv.step(vs, random_actions(), noise)
    state, actions, disp = vs.env_state, random_actions(), env.step_draws(noise, num)

    cpu = env.step_from(params, state, actions, disp)
    on_dev = env.step_from(
        params, type(state)(*(x.to(device) for x in state)), actions.to(device), disp.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()

    err = torch.zeros(num, dtype=torch.float64)
    max_err = {}
    for name, got, want in (
        ("pos", on_dev.state.pos, cpu.state.pos), ("vel", on_dev.state.vel, cpu.state.vel),
        ("angle", on_dev.state.angle, cpu.state.angle), ("omega", on_dev.state.omega, cpu.state.omega),
        ("reward", on_dev.reward, cpu.reward),
    ):
        e = (got.cpu().double() - want.double()).abs().reshape(num, -1).amax(dim=1)
        max_err[name] = float(e.max())
        err = torch.maximum(err, e)
    flags_differ = torch.zeros(num, dtype=torch.bool)
    flag_counts = {}
    for name, got, want in (
        ("terminated", on_dev.terminated, cpu.terminated),
        ("leg_contact", on_dev.state.leg_contact, cpu.state.leg_contact),
    ):
        d = (got.cpu() != want).reshape(num, -1).any(dim=1)
        flag_counts[name] = int(d.sum())
        flags_differ |= d
    ties = flags_differ | (err > PHYS_ATOL)
    result = {
        "envs": num,
        "in_contact": int(cpu.state.leg_contact.any(dim=1).sum()),
        "terminated": int(cpu.terminated.sum()),
        "max_abs_err": max_err,
        "max_abs_err_outside_ties": float(err[~ties].max()),
        "flags_differ": flag_counts,
        "ties": int(ties.sum()),
    }
    log("phase 1 physics: " + json.dumps(result))
    if result["ties"] > PHYS_MAX_TIES:
        raise AssertionError(f"{result['ties']} envs disagree (allowed {PHYS_MAX_TIES})")
    if not result["max_abs_err_outside_ties"] < PHYS_ATOL:
        raise AssertionError(f"physics differs by {result['max_abs_err_outside_ties']}")
    return result


class PhaseClock:
    """Phase times of ``train_iter`` from CUDA events on a GPU (host clock
    on the CPU, for rehearsals); ``mark`` is the trainer's phase hook."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list[tuple[str, object]] = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def mark(self, phase: str) -> None:
        self.marks.append((phase, self._now()))

    def phase_ms(self) -> dict[str, float]:
        """Milliseconds of each phase since the previous mark, summed over
        the marks that share a name; call after a synchronize."""
        out: dict[str, float] = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + (a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


def phase_bench(device: torch.device, cfg=None, timed_iters: int = BENCH_TIMED_ITERS) -> dict:
    """The bench config's train_iter on ``device``: throughput and phases."""
    from gymrl_tpu_torch.algos.ppo import PPOTrainer

    cfg = cfg or bench_config()
    cuda = device.type == "cuda"
    trainer = PPOTrainer(cfg, device=device)
    ts = trainer.init(0)
    initial = {k: v.detach().clone() for k, v in ts.params.state_dict().items()}

    for _ in range(BENCH_WARM_ITERS):
        ts, _ = trainer.train_iter(ts)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated(device) if cuda else None

    clock = PhaseClock(device)
    phases, walls = [], []
    for _ in range(timed_iters):
        t0 = time.perf_counter()
        clock.start()
        ts, out = trainer.train_iter(ts, timer=clock.mark)
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(clock.phase_ms())

    result = {
        "config": {k: getattr(cfg, k) for k in ("num_envs", "rollout_steps", "num_epochs",
                                                "minibatch_size", "flat_optimizer", "sgd_bf16")},
        "env_steps_per_s": timed_iters * cfg.batch_total / sum(walls),
        "iter_wall_ms": [w * 1e3 for w in walls],
        "phase_ms": {p: [ph[p] for ph in phases] for p in ("rollout", "gae", "sgd")},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "base_bytes": base_bytes,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(device) if cuda else None,
        "metrics": {k: float(v) for k, v in out.metrics.items()},
        "graphs": _graph_counts("phase 2", trainer, timed_iters + BENCH_WARM_ITERS),
    }
    log("phase 2 bench config: " + json.dumps(result))

    iters = timed_iters + BENCH_WARM_ITERS
    if ts.env_steps != iters * cfg.batch_total:
        raise AssertionError(f"env_steps {ts.env_steps} != {iters} x {cfg.batch_total}")
    if not all(math.isfinite(v) for v in result["metrics"].values()):
        raise AssertionError(f"non-finite metrics {result['metrics']}")
    state = ts.params.state_dict()
    if not all(v.device.type == device.type for v in state.values()):
        raise AssertionError("params left the device")
    if not all(not torch.equal(state[k], v) for k, v in initial.items()):
        raise AssertionError("some parameter did not move")
    steps = {int(s["step"]) for s in ts.opt_state.state.values()}
    if steps != {iters * cfg.num_epochs * cfg.num_minibatches}:
        raise AssertionError(f"Adam step counts {steps}")
    return result


def phase_entry(device: torch.device, iters: int = ENTRY_ITERS, episodes: int = 5) -> dict:
    """The CLI's ppo_lunarlander workload through TrainLoop, its test and a
    checkpoint restore."""
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint

    trainer, algo, solve = cli.WORKLOADS["ppo_lunarlander"](str(device))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the loop saves to ./checkpoints
        try:
            loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
        finally:
            os.chdir(cwd)
        t0 = time.perf_counter()
        ts, stats = loop.train(iters * trainer.cfg.batch_total, solve_threshold=solve)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean_reward = loop.test(ts, episodes=episodes)
        test_s = time.perf_counter() - t0
        restored = restore_checkpoint(loop.ckpt_path, trainer.init(1))

    if stats["env_steps"] != iters * trainer.cfg.batch_total:
        raise AssertionError(f"trained {stats['env_steps']} env steps")
    if not math.isfinite(mean_reward):
        raise AssertionError(f"test reward {mean_reward}")
    want = ts.params.state_dict()
    got = restored.params.state_dict()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("restored params differ from the trained ones")
    if restored.env_steps != ts.env_steps:
        raise AssertionError("restored env_steps differ")
    result = {"env_steps": stats["env_steps"], "train_s": train_s, "test_episodes": episodes,
              "test_mean_reward": mean_reward, "test_s": test_s, "checkpoint_restored": True,
              "graphs": _graph_counts("phase 3", trainer, iters)}
    log("phase 3 entry point: " + json.dumps(result))
    return result


# -- phase 4: classic envs, card vs CPU ------------------------------------------
def _random_actions(env, num: int, gen: torch.Generator) -> torch.Tensor:
    if env.discrete:
        return torch.randint(0, env.n_actions, (num,), generator=gen, dtype=torch.int32)
    # continuous: 1.5 × the bound, so the engine's own clip acts too
    return (torch.rand((num, env.act_dim), generator=gen) * 3.0 - 1.5) * env.action_bound


def _to(x, device: torch.device):
    """A tensor, or a (nested) NamedTuple or list of them, on ``device``."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return type(x)(*(_to(v, device) for v in x))


def _leaves(state, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of a (nested) NamedTuple."""
    out = []
    for f, x in zip(state._fields, state):
        out += _leaves(x, f"{prefix}{f}.") if isinstance(x, tuple) else [(prefix + f, x)]
    return out


def compare_env_step(env, device: torch.device, num: int, warm_steps: int, atol: float,
                     max_ties: int = PHYS_MAX_TIES) -> dict:
    """One step of ``env`` on ``device`` against the same step on the CPU, from
    states reached by ``warm_steps`` random-action steps with autoreset."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.rollout import VecEnv

    params = env.default_params()
    venv = VecEnv(env, params, num)
    noise = Noise("cpu", 0)
    gen = torch.Generator().manual_seed(1)
    vs = venv.reset(noise)
    for _ in range(warm_steps):
        vs, _ = venv.step(vs, _random_actions(env, num, gen), noise)
    state, actions = vs.env_state, _random_actions(env, num, gen)
    draws = env.step_draws(noise, num)
    cpu = env.step_from(params, state, actions, draws)
    on_dev = env.step_from(params, _to(state, device), actions.to(device), _to(draws, device))
    if device.type == "cuda":
        torch.cuda.synchronize()

    fields = [(name, got.cpu(), want) for (name, got), (_, want)
              in zip(_leaves(on_dev.state), _leaves(cpu.state))]
    fields += [("reward", on_dev.reward.cpu(), cpu.reward),
               ("terminated", on_dev.terminated.cpu(), cpu.terminated),
               ("truncated", on_dev.truncated.cpu(), cpu.truncated)]
    name = env.name + (" (continuous)" if getattr(env, "continuous", False) else "")
    return {"env": name, "envs": num, "atol": atol,
            **_field_diff(fields, num, atol, max_ties, label=f"{name} step")}


def _field_diff(pairs, num: int, atol: float, max_ties: int = PHYS_MAX_TIES,
                label: str = "") -> dict:
    """Two batches field by field, from (name, got, want) tensors on one device:
    each float field's largest error, each exact field's count of envs apart,
    and the ties (envs apart in a flag or by more than ``atol``). Raises when
    more than ``max_ties`` envs tie or an env outside them is off by more."""
    err = torch.zeros(num, dtype=torch.float64, device=pairs[0][1].device)
    flags_differ = torch.zeros(num, dtype=torch.bool, device=err.device)
    max_err, flag_counts = {}, {}
    for name, got, want in pairs:
        want = want.expand_as(got)
        if want.is_floating_point():
            e = (got.double() - want.double()).abs().reshape(num, -1).amax(dim=1)
            max_err[name] = float(e.max())
            err = torch.maximum(err, e)
        else:
            d = (got != want).reshape(num, -1).any(dim=1)
            flag_counts[name] = int(d.sum())
            flags_differ |= d
    ties = flags_differ | (err > atol)
    outside = float(err[~ties].max()) if bool((~ties).any()) else 0.0
    result = {"max_abs_err": max_err, "max_abs_err_outside_ties": outside,
              "flags_differ": flag_counts, "ties": int(ties.sum())}
    if result["ties"] > max_ties or not outside <= atol:
        raise AssertionError(f"{label}: {result}")
    return result


def phase_classic(device: torch.device, num: int = CLASSIC_ENVS) -> list[dict]:
    from gymrl_tpu_torch.envs.cartpole import CartPole
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.pendulum import Pendulum

    results = [
        compare_env_step(CartPole(), device, num, CLASSIC_WARM_STEPS, CLASSIC_ATOL),
        compare_env_step(Pendulum(), device, num, CLASSIC_WARM_STEPS, CLASSIC_ATOL),
        compare_env_step(LunarLander(continuous=True), device, num, PHYS_WARM_STEPS, PHYS_ATOL),
    ]
    for r in results:
        log("phase 4 classic envs: " + json.dumps(r))
    return results


# -- phase 5: off-policy updates, card vs CPU ---------------------------------------
class FixedDraws:
    """The draws of one update, made on the CPU and handed out on any device."""

    def __init__(self, device: torch.device, indices: torch.Tensor, normals: torch.Tensor):
        self.device = device
        self.indices, self.normals = indices, normals

    def replay_indices(self, batch_size, high):
        return self.indices[:batch_size].to(self.device)

    def target_noise(self, shape):
        return self.normals[0].reshape(shape).to(self.device)

    def sac_update_noise(self, shape):
        return self.normals[0].reshape(shape).to(self.device), self.normals[1].reshape(shape).to(self.device)


def _stepped(trainer, ts) -> list[tuple[str, object, float]]:
    """(name, module or bare parameter, lr) of each network an update steps."""
    cfg = trainer.cfg
    if hasattr(ts, "nets"):
        lrs = {"actor": cfg.lr_actor, "critic": cfg.lr_critic, "critic1": cfg.lr_critic,
               "critic2": cfg.lr_critic, "log_alpha": cfg.lr_alpha}
        return [(k, v, lrs[k]) for k, v in ts.nets.items()]
    return [("q", ts.params, cfg.lr)]


def _named_tensors(stepped) -> dict[str, torch.Tensor]:
    out = {}
    for name, net, _ in stepped:
        if isinstance(net, torch.nn.Module):
            out.update({f"{name}.{k}": v.detach() for k, v in net.named_parameters()})
        else:
            out[name] = net.detach()
    return out


def _watch_relu_ties(stepped) -> tuple[list, list]:
    """Forward hooks recording, in grad-enabled forwards, the outputs of each
    Linear layer that feeds a ReLU (one with a later sibling reading its
    width). Returns (records, hook handles)."""
    records, handles = [], []
    for name, net, _ in stepped:
        if not isinstance(net, torch.nn.Module):
            continue
        for parent_name, parent in net.named_modules():
            layers = [(n, m) for n, m in parent.named_children() if isinstance(m, torch.nn.Linear)]
            for i, (lname, layer) in enumerate(layers):
                consumers = [f"{name}.{parent_name}.{n}".replace("..", ".") for n, m in layers[i + 1:]
                             if m.in_features == layer.out_features]
                if not consumers:
                    continue
                full = f"{name}.{parent_name}.{lname}".replace("..", ".")

                def hook(mod, args, out, full=full, consumers=consumers):
                    if torch.is_grad_enabled() and mod.weight.requires_grad:
                        records.append((full, consumers, out.detach().reshape(-1, out.shape[-1])))

                handles.append(layer.register_forward_hook(hook))
    return records, handles


def _exempt(stepped, records) -> dict[str, torch.Tensor]:
    """Entries whose step float32 agreement does not fix (module docstring)."""
    masks = {}
    for name, net, _ in stepped:
        params = (list(net.named_parameters()) if isinstance(net, torch.nn.Module) else [("", net)])
        for k, p in params:
            a = p.grad.abs()
            masks[f"{name}.{k}".rstrip(".")] = a < torch.clamp(TINY_GRAD * a.max(), min=TINY_GRAD)
    for layer, consumers, out in records:
        units = (out.abs() < RELU_TIE).any(dim=0)
        masks[f"{layer}.weight"] |= units[:, None]
        masks[f"{layer}.bias"] |= units
        for c in consumers:
            masks[f"{c}.weight"] |= units[None, :]
    return masks


def _update_case(name: str, device: torch.device):
    """A trainer at the CLI config of ``name`` on ``device`` and its fresh state."""
    from gymrl_tpu_torch.run import cli

    trainer, _, _ = cli.WORKLOADS[name](str(device))
    return trainer, trainer.init(0)


def _one_update(trainer, ts, batch_cpu, draws):
    """One update on ``trainer``'s device; returns the losses by name."""
    from gymrl_tpu_torch.replay.uniform import replay_init, replay_push_batch

    dev = trainer.device
    batch = type(batch_cpu)(*(x.to(dev) for x in batch_cpu))
    if hasattr(ts, "nets"):  # the off-policy update takes its sampled batch
        idx = draws.replay_indices(trainer.cfg.batch_size, batch[0].shape[0])
        batch = type(batch)(*(x[idx] for x in batch))
        return dict(zip(trainer.metric_names, trainer._update(ts, batch, 0, draws)))
    replay = replay_push_batch(replay_init(type(batch)(*(x[0] for x in batch)), batch[0].shape[0], dev),
                               batch)
    loss = trainer._update(ts.params, ts.target_params, ts.opt_state, list(ts.params.parameters()),
                           replay, draws)
    return {"loss": loss}


def _random_batch(trainer, n: int, gen: torch.Generator):
    obs_dim = trainer.venv.env.obs_dim
    env = trainer.venv.env
    obs = torch.randn((n, obs_dim), generator=gen)
    if env.discrete:
        action = torch.randint(0, env.n_actions, (n,), generator=gen, dtype=torch.int32)
    else:
        action = (torch.rand((n, env.act_dim), generator=gen) * 2 - 1) * env.action_bound
    reward = -torch.rand(n, generator=gen) * (16.0 if not env.discrete else 1.0)
    next_obs = obs + 0.1 * torch.randn((n, obs_dim), generator=gen)
    done = (torch.rand(n, generator=gen) < 0.1).float()
    return sys.modules[type(trainer).__module__].Transition(obs, action, reward, next_obs, done)


def phase_updates(device: torch.device) -> list[dict]:
    cases = (("dqn", "dqn_cartpole"), ("ddpg", "ddpg_pendulum"), ("td3", "td3_pendulum"),
             ("sac", "sac_pendulum"), ("sacd", "sac_cartpole"))
    results = []
    for algo, workload in cases:
        cpu_tr, cpu_ts = _update_case(workload, torch.device("cpu"))
        dev_tr, dev_ts = _update_case(workload, device)
        gen = torch.Generator().manual_seed(7)
        n = 4 * cpu_tr.cfg.batch_size
        batch = _random_batch(cpu_tr, n, gen)
        draws_shape = (2, cpu_tr.cfg.batch_size) + tuple(batch.action.shape[1:])
        indices = torch.randint(0, n, (cpu_tr.cfg.batch_size,), generator=gen)
        normals = torch.randn(draws_shape, generator=gen)
        cpu_stepped, dev_stepped = _stepped(cpu_tr, cpu_ts), _stepped(dev_tr, dev_ts)
        records, handles = _watch_relu_ties(cpu_stepped)
        cpu_losses = _one_update(cpu_tr, cpu_ts, batch, FixedDraws(torch.device("cpu"), indices, normals))
        for h in handles:
            h.remove()
        dev_losses = _one_update(dev_tr, dev_ts, batch, FixedDraws(device, indices, normals))
        if device.type == "cuda":
            torch.cuda.synchronize()

        exempt = _exempt(cpu_stepped, records)
        want, got = _named_tensors(cpu_stepped), _named_tensors(dev_stepped)
        lr_of = {}
        for name, net, lr in cpu_stepped:
            for k in want:
                if k == name or k.startswith(name + "."):
                    lr_of[k] = lr
        worst, worst_exempt, n_exempt = 0.0, 0.0, 0
        for k, w in want.items():
            e = (got[k].cpu().double() - w.double()).abs()
            ok = (e <= PARAM_ATOL) | (exempt[k] & (e <= 2.0 * lr_of[k]))
            if not bool(ok.all()):
                raise AssertionError(f"{algo}: {k} differs by {float(e.max())} on the card")
            worst = max(worst, float(e[~exempt[k]].max()) if bool((~exempt[k]).any()) else 0.0)
            worst_exempt = max(worst_exempt, float(e[exempt[k]].max()) if bool(exempt[k].any()) else 0.0)
            n_exempt += int(exempt[k].sum())
        loss_err = {}
        for k, w in cpu_losses.items():
            g, w = float(dev_losses[k]), float(w)
            atol = UPDATE_LOSS_ATOL if k in ("actor_loss", "alpha_loss") else 0.0
            loss_err[k] = abs(g - w)
            if abs(g - w) > UPDATE_RTOL * abs(w) + atol:
                raise AssertionError(f"{algo}: {k} {g} on the card, {w} on the CPU")
        result = {"algo": algo, "config": workload, "batch": cpu_tr.cfg.batch_size,
                  "losses_cpu": {k: float(v) for k, v in cpu_losses.items()},
                  "loss_abs_err": loss_err, "param_max_abs_err": worst,
                  "exempt_entries": n_exempt, "exempt_max_abs_err": worst_exempt}
        log("phase 5 update: " + json.dumps(result))
        results.append(result)
    return results


# -- phase 6: off-policy workloads on the card -----------------------------------------
def _replay_sizes(cfg, iters: int) -> list[int]:
    """The replay's fill after each env step of ``iters`` off-policy
    iterations from a fresh state: a push per env step, except in the
    first n−1 steps of an n-step window."""
    warm = getattr(cfg, "n_steps", 1) - 1
    return [min(max(t + 1 - warm, 0) * cfg.num_envs, cfg.memory_capacity)
            for t in range(iters * cfg.steps_per_iter)]


def _expected_updates(cfg, iters: int) -> int:
    """Updates of ``iters`` off-policy iterations from a fresh state: n_updates
    per env step once the replay holds a batch."""
    return sum(cfg.n_updates for size in _replay_sizes(cfg, iters) if size >= cfg.batch_size)


def _check_family(name: str, cfg, ts, ts0, iters: int) -> dict:
    """Phase 9's checks of a DQN-family state after ``iters`` iterations."""
    import numpy as np

    from gymrl_tpu_torch.core.schedules import per_beta_anneal

    sizes = _replay_sizes(cfg, iters)
    pushes = sum(1 for t in range(len(sizes)) if t >= getattr(cfg, "n_steps", 1) - 1)
    updates = _expected_updates(cfg, iters)
    out = {"replay_size": ts.replay.size, "learn_steps": ts.learn_steps,
           "episodes": int(ts.episodes), "target_syncs": int(ts.target_syncs),
           "beta": float(ts.beta)}
    # Also the n-step warm gate: ``sizes`` counts no push in the first n−1
    # vector steps, and the replay has not filled.
    if ts.replay.size != sizes[-1]:
        raise AssertionError(f"{name}: replay size {ts.replay.size} != {sizes[-1]}")
    if ts.learn_steps != updates:
        raise AssertionError(f"{name}: learn_steps {ts.learn_steps} != {updates}")
    if _adam_counts(ts.opt_state) != {updates}:
        raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {updates}")
    if cfg.use_per:
        total = float(ts.replay.tree[1])
        out.update(pos=ts.replay.pos, tree_total=total, max_priority=float(ts.replay.max_priority))
        if ts.replay.pos != pushes * cfg.num_envs % cfg.memory_capacity:
            raise AssertionError(f"{name}: PER pos {ts.replay.pos}")
        if not (math.isfinite(total) and total > 0):
            raise AssertionError(f"{name}: tree[1] = {total}")
        if cfg.per_beta_increment > 0:
            want = np.float32(cfg.per_beta0)
            for _ in range(updates):  # the trainer's own float32 steps
                want = min(np.float32(1.0), np.float32(want + np.float32(cfg.per_beta_increment)))
        else:
            last = ts.env_steps - cfg.num_envs
            want = float(per_beta_anneal(last, cfg.max_train_steps, cfg.per_beta0))
    else:
        want = cfg.per_beta0
    if abs(float(ts.beta) - float(want)) > 1e-6 * float(want):
        raise AssertionError(f"{name}: beta {float(ts.beta)} != {float(want)}")
    if cfg.target_mode == "soft":
        target = ts.target_params.state_dict()
        start = ts0.target_params.state_dict()
        if all(torch.equal(target[k], start[k]) for k in target):
            raise AssertionError(f"{name}: the soft target did not move")
    else:
        counter = int(ts.episodes) if cfg.target_mode == "hard_episode" else ts.learn_steps
        if int(ts.target_syncs) != counter // cfg.target_update_freq:
            raise AssertionError(f"{name}: {int(ts.target_syncs)} target syncs at {counter}")
    return out


def _state_tensors(ts) -> dict[str, torch.Tensor]:
    """Every tensor of a train state that training moves, by path."""
    from gymrl_tpu_torch.utils.checkpoint import _to_tree

    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")

    walk(_to_tree(ts), "ts")
    return out


def _nets(ts) -> dict[str, torch.nn.Module]:
    if hasattr(ts, "nets"):
        return {k: v for k, v in ts.nets.items() if isinstance(v, torch.nn.Module)}
    return {"params": ts.params}


def _adam_counts(opt) -> set[int]:
    return {int(s["step"]) for s in opt.state.values()}


def _check_restored(name: str, ts, restored, example, path: str) -> dict:
    """A checkpoint restore as the JAX package makes one: every tensor of
    the state but the replay equal to the saved state's, the replay the
    fresh example's (empty) and none in the file."""
    got, want = _state_tensors(restored), _state_tensors(ts)
    got, want = ({k: v for k, v in d.items() if not k.startswith("ts.replay")}
                 for d in (got, want))
    if set(got) != set(want) or not all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want):
        raise AssertionError(f"{name}: the restored state differs from the trained one")
    if restored.env_steps != ts.env_steps:
        raise AssertionError(f"{name}: restored env_steps differ")
    if not hasattr(ts, "replay"):
        return {"checkpoint_restored": True}
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if saved["replay"] is not None or restored.replay is not example.replay \
            or restored.replay.size != 0 or ts.replay.size == 0:
        raise AssertionError(f"{name}: the restore did not keep the fresh replay "
                             f"(saved {ts.replay.size} rows, restored {restored.replay.size})")
    return {"checkpoint_restored": True, "replay_rows_saved": ts.replay.size,
            "replay_rows_restored": restored.replay.size}


def phase_workloads(device: torch.device, names=WORKLOADS,
                    timed_iters: int = WORKLOAD_TIMED_ITERS, episodes: int = 5,
                    label: str = "phase 6 workload") -> list[dict]:
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cuda = device.type == "cuda"
    results = []
    for name in names:
        trainer, algo, solve = cli.WORKLOADS[name](str(device))
        cfg = trainer.cfg
        ppo = not hasattr(cfg, "steps_per_iter")
        per_iter = cfg.batch_total if ppo else cfg.steps_per_iter * cfg.num_envs
        ts0 = trainer.init(0)
        initial = {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
                   for k, m in _nets(ts0).items()}
        if hasattr(ts0, "targets"):
            initial_targets = {k: {n: v.clone() for n, v in m.state_dict().items()}
                               for k, m in ts0.targets.items()}
        if hasattr(ts0, "target_params"):
            ts_start = ts0._replace(target_params=copy.deepcopy(ts0.target_params))
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # the loop saves to ./checkpoints
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
            finally:
                os.chdir(cwd)
            t0 = time.perf_counter()
            ts, _ = loop.train(per_iter, solve_threshold=solve, ts=ts0)  # warm-up iteration
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            warm_s = time.perf_counter() - t0
            learn0 = ts.learn_steps if hasattr(ts, "learn_steps") else None
            clock = PhaseClock(device)
            walls, phases = [], []
            for _ in range(timed_iters):
                t0 = time.perf_counter()
                clock.start()
                ts, out = trainer.train_iter(ts, timer=clock.mark)
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(clock.phase_ms())
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            t0 = time.perf_counter()
            mean_reward = loop.test(ts, episodes=episodes)
            test_s = time.perf_counter() - t0
            path = save_checkpoint(loop.ckpt_path, ts)
            example = trainer.init(1)
            restored = restore_checkpoint(path, example)
            restore = _check_restored(name, ts, restored, example, path)

        iters = timed_iters + 1
        if ppo:
            timed_updates = timed_iters * cfg.num_epochs * cfg.num_minibatches
        elif hasattr(ts, "learn_steps"):
            timed_updates = ts.learn_steps - learn0
        else:
            timed_updates = timed_iters * cfg.steps_per_iter * cfg.n_updates
        metrics = {k: float(v) for k, v in out.metrics.items()}
        result = {
            "workload": name, "env_steps": ts.env_steps, "warmup_iter_s": warm_s,
            "env_steps_per_s": timed_iters * per_iter / sum(walls),
            "updates_per_s": timed_updates / sum(walls),
            "ms_per_update": (sum(ph.get("update", ph.get("sgd", 0.0)) for ph in phases)
                              / max(timed_updates, 1)),
            "iter_wall_ms": [w * 1e3 for w in walls],
            "phase_ms": {p: [ph[p] for ph in phases] for p in phases[0]},
            "peak_memory_bytes": peak, "metrics": metrics,
            "test_episodes": episodes, "test_mean_reward": mean_reward, "test_s": test_s,
        }

        # counts
        if ts.env_steps != iters * per_iter:
            raise AssertionError(f"{name}: env_steps {ts.env_steps} != {iters} x {per_iter}")
        if not all(math.isfinite(v) for v in metrics.values()) or not math.isfinite(mean_reward):
            raise AssertionError(f"{name}: non-finite metrics {metrics} / test {mean_reward}")
        for k, m in _nets(ts).items():
            state = m.state_dict()
            if not all(v.device.type == device.type for v in state.values()):
                raise AssertionError(f"{name}: {k} left the device")
            if not all(not torch.equal(state[n], v) for n, v in initial[k].items()):
                raise AssertionError(f"{name}: some parameter of {k} did not move")
        if ppo:
            want = iters * cfg.num_epochs * cfg.num_minibatches
            if _adam_counts(ts.opt_state) != {want}:
                raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {want}")
        elif hasattr(ts, "beta"):  # the DQN family
            result.update(_check_family(name, cfg, ts, ts_start, iters),
                          replay_obs_dtype=str(ts.replay.data.obs.dtype))
        else:
            updates = _expected_updates(cfg, iters)
            if ts.replay.size != min(iters * per_iter, cfg.memory_capacity):
                raise AssertionError(f"{name}: replay size {ts.replay.size}")
            result["replay_size"] = ts.replay.size
            if hasattr(ts, "learn_steps"):
                if ts.learn_steps != updates:
                    raise AssertionError(f"{name}: learn_steps {ts.learn_steps} != {updates}")
                result["learn_steps"] = ts.learn_steps
                for k, opt in ts.opts.items():
                    want = (updates + 1) // 2 if (name == "td3_pendulum" and k == "actor") else updates
                    if _adam_counts(opt) != {want}:
                        raise AssertionError(f"{name}: {k} Adam counts {_adam_counts(opt)} != {want}")
                for k, m in ts.targets.items():
                    if all(torch.equal(m.state_dict()[n], v) for n, v in initial_targets[k].items()):
                        raise AssertionError(f"{name}: target {k} did not move")
            else:  # DQN
                if _adam_counts(ts.opt_state) != {updates}:
                    raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {updates}")
                episodes_done, syncs = int(ts.episodes), int(ts.target_syncs)
                if syncs != episodes_done // cfg.target_update_freq:
                    raise AssertionError(f"{name}: {syncs} target syncs after {episodes_done} episodes")
                result.update(episodes=episodes_done, target_syncs=syncs, updates=updates)
        result.update(restore)
        log(f"{label}: " + json.dumps(result))
        results.append(result)
    return results


# -- phase 7: PER and FlappyBird, card vs CPU ----------------------------------------------
def phase_flappy(device: torch.device, num: int = CLASSIC_ENVS) -> dict:
    from gymrl_tpu_torch.envs.flappybird import FlappyBird

    result = compare_env_step(FlappyBird(), device, num, FLAPPY_WARM_STEPS, CLASSIC_ATOL)
    log("phase 7 flappybird: " + json.dumps(result))
    return result


def _per_descent_margins(tree: torch.Tensor, u: torch.Tensor,
                         batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``per_sample``'s descent on a CPU float32 tree, in its own arithmetic:
    the leaf indices and ``|target - left sum|`` at every level ([levels, B],
    level 0 at the root)."""
    capacity = tree.shape[0] // 2
    target = (torch.arange(batch, dtype=torch.float32) + u) * (tree[1] / batch)
    node = torch.ones(batch, dtype=torch.int64)
    margins = []
    for _ in range(capacity.bit_length() - 1):
        left = 2 * node
        left_sum = tree[left]
        margins.append((target.double() - left_sum.double()).abs())
        go_left = target < left_sum
        node = torch.where(go_left, left, left + 1)
        target = torch.where(go_left, target, target - left_sum)
    return node - capacity, torch.stack(margins)


def _per_case(device: torch.device, capacity: int, batch: int, rounds: int = PER_ROUNDS) -> dict:
    """The same pushes, priority updates and sample on the CPU and ``device``."""
    from collections import namedtuple

    from gymrl_tpu_torch.replay.per import (
        per_init, per_push_batch, per_sample, per_update_priorities,
    )

    Item = namedtuple("Item", "obs action")
    gen = torch.Generator().manual_seed(capacity)
    devices = (torch.device("cpu"), device)
    example = Item(torch.zeros(4), torch.zeros((), dtype=torch.int32))
    states = [per_init(example, capacity, d) for d in devices]
    chunk = capacity // 8
    for r in range(rounds):  # 10 chunks of capacity/8: the ring wraps
        items = Item(torch.randn((chunk, 4), generator=gen),
                     torch.randint(0, 2, (chunk,), generator=gen, dtype=torch.int32))
        idx = torch.randint(0, min((r + 1) * chunk, capacity), (batch,), generator=gen)
        idx[batch // 2:batch // 2 + 8] = idx[0]  # duplicates: the first occurrence wins
        pri = (torch.rand(batch, generator=gen) * 1.5 + 1e-4) ** 0.6
        for i, d in enumerate(devices):
            st = per_push_batch(states[i], Item(*(x.to(d) for x in items)))
            states[i] = per_update_priorities(st, idx.to(d), pri.to(d))

    class Uniforms:
        def __init__(self, u, d):
            self.u, self.d = u, d

        def per_uniforms(self, n):
            return self.u[:n].to(self.d)

    u = torch.rand(batch, generator=gen)
    samples = [per_sample(st, Uniforms(u, d), batch, 0.4) for st, d in zip(states, devices)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    cpu, dev = states[0], states[1]
    tree_cpu, tree_dev = cpu.tree.double(), dev.tree.cpu().double()
    total = float(tree_cpu[1])
    tree_err = (tree_dev - tree_cpu).abs()
    tree_ok = tree_err <= PER_TREE_RTOL * tree_cpu.abs() + 1e-6 * total
    leaves = cpu.tree[capacity:].double()
    root_rel = abs(total - float(leaves.sum())) / float(leaves.sum())
    (_, idx_cpu, w_cpu), (_, idx_dev, w_dev) = samples
    idx_dev, w_dev = idx_dev.cpu(), w_dev.cpu()
    differ = idx_cpu != idx_dev
    # a differing index is a boundary tie if, at the level where the two leaves'
    # paths part, the CPU's descent held a target within 1e-5 of the total of
    # the left sum it compared it with. The descent compares against the tree's
    # internal nodes, which drift from the leaves' prefix sums (the root by
    # ``root_vs_float64_leaf_sum_rel``), so the margin is read from a replay of
    # the descent on the CPU's tree, which must reproduce the CPU's indices.
    idx_replay, margins = _per_descent_margins(cpu.tree, u, batch)
    if not torch.equal(idx_replay, idx_cpu):
        raise AssertionError("the replayed descent does not give the CPU's indices")
    split_bit = torch.zeros_like(idx_cpu)
    x = idx_cpu ^ idx_dev
    while bool((x > 0).any()):
        split_bit += (x > 0).long()
        x = x // 2
    level = margins.shape[0] - split_bit  # the level whose choice is bit split_bit - 1
    margin = margins[level.clamp(max=margins.shape[0] - 1), torch.arange(batch)][differ]
    boundary = margin <= 1e-5 * total
    same = ~differ
    w_err = float(((w_dev[same] - w_cpu[same]).abs() / w_cpu[same].abs()).max())
    result = {
        "capacity": capacity, "batch": batch, "size": cpu.size, "pos": cpu.pos,
        "total": total, "tree_max_abs_err": float(tree_err.max()),
        "tree_max_rel_err": float((tree_err / tree_cpu.abs().clamp(min=1e-30)).max()),
        "root_vs_float64_leaf_sum_rel": root_rel,
        "max_priority": [float(cpu.max_priority), float(dev.max_priority)],
        "indices_differ": int(differ.sum()), "boundary_ties": int(boundary.sum()),
        "tie_max_margin_rel": float(margin.max()) / total if bool(differ.any()) else 0.0,
        "weights_max_rel_err": w_err,
    }
    log("phase 7 per: " + json.dumps(result))
    if not bool(tree_ok.all()):
        raise AssertionError(f"PER tree differs on the card: {result}")
    if root_rel > PER_ROOT_RTOL:
        raise AssertionError(f"tree[1] drifted from the leaf sum: {result}")
    if cpu.max_priority.item() != dev.max_priority.item():
        raise AssertionError(f"max priority differs: {result}")
    if not bool(boundary.all()):
        raise AssertionError(f"sampled indices differ away from a boundary: {result}")
    if not w_err <= PER_WEIGHT_RTOL:
        raise AssertionError(f"IS weights differ: {result}")
    return result


def phase_per(device: torch.device, cases=((65536, 64), (32768, 256))) -> list[dict]:
    return [_per_case(device, cap, batch) for cap, batch in cases]


# -- phase 8: DQN-family updates, card vs CPU ------------------------------------------------
FAMILY = ("ddqn_per_cartpole", "ddqn_per_duel_cartpole", "noisy_dqn_cartpole",
          "rainbow_dqn_cartpole", "noisy_dqn_flappybird")


class FamilyDraws:
    """The draws of one family update, made on the CPU and handed out on any
    device: the sample's uniforms or indices and the NoisyNet ε."""

    def __init__(self, device, u, idx, eps):
        self.device, self.u, self.idx, self.eps = device, u, idx, eps

    def per_uniforms(self, batch_size):
        return self.u.to(self.device)

    def replay_indices(self, batch_size, high):
        return self.idx.to(self.device)

    def noisy_update(self, layers, count):
        return [[(a.to(self.device), b.to(self.device)) for a, b in draw]
                for draw in self.eps[:count]]


def _watch_family_ties(net, producers=None) -> tuple[list, list]:
    """Forward hooks on the net's activation producers (by default those of
    its ``activation_edges``) recording their outputs in grad-enabled
    forwards. Returns (records, hook handles)."""
    records, handles = [], []
    modules = dict(net.named_modules())
    for name in producers or {e[0] for e in net.activation_edges()}:
        def hook(mod, args, out, name=name):
            if torch.is_grad_enabled():
                records.append((name, out.detach().reshape(-1, out.shape[-1])))
        handles.append(modules[name].register_forward_hook(hook))
    return records, handles


def _near_kink(out: torch.Tensor) -> torch.Tensor:
    """Units with a pre-activation within RELU_TIE of the kink for some row."""
    return (out.abs() < RELU_TIE).any(dim=0)


def _family_exempt(net, records, tied=_near_kink) -> dict[str, torch.Tensor]:
    """Phase 5's rules for a family net: tiny gradients, and for each unit
    that ``tied`` flags in a recorded output (by default a pre-activation
    within RELU_TIE of a ReLU/PReLU kink), the unit's output column and the
    consumers' input rows (``NoisyDense`` kernels are ``[in, out]``,
    ``Dense`` weights ``[out, in]``)."""
    from gymrl_tpu_torch.nn.layers import NoisyDense

    masks = {}
    for k, p in net.named_parameters():
        a = p.grad.abs()
        masks[k] = a < torch.clamp(TINY_GRAD * a.max(), min=TINY_GRAD)
    modules = dict(net.named_modules())

    def mark(layer, index, out_side):
        noisy = isinstance(modules[layer], NoisyDense)
        kernels = ("kernel_mu", "kernel_sigma") if noisy else ("weight",)
        for k in kernels:
            m = masks[f"{layer}.{k}"]
            if noisy == out_side:  # a column of [in, out] or a column of [out, in]
                m[:, index] = True
            else:
                m[index, :] = True
        if out_side:
            for k in (("bias_mu", "bias_sigma") if noisy else ("bias",)):
                masks[f"{layer}.{k}"][index] = True

    edges = net.activation_edges()
    for producer, out in records:
        units = tied(out).cpu()
        if not bool(units.any()):
            continue
        mark(producer, units.nonzero().flatten(), True)
        for p, consumer, lo, hi, offset in edges:
            if p == producer:
                u = units[lo:hi].nonzero().flatten() + lo
                if len(u):
                    mark(consumer, u + offset, False)
    return masks


def _family_update_case(name: str, device: torch.device, gen: torch.Generator):
    """A trainer at the CLI config of ``name`` on ``device``, its fresh state
    and a replay filled with 4·batch random transitions (and, with PER, random
    priorities)."""
    from gymrl_tpu_torch.algos.dqn_variants import Transition
    from gymrl_tpu_torch.replay.per import per_push_batch, per_update_priorities
    from gymrl_tpu_torch.replay.uniform import replay_push_batch
    from gymrl_tpu_torch.run import cli

    trainer, _, _ = cli.WORKLOADS[name](str(device))
    ts = trainer.init(0)
    cfg, d = trainer.cfg, trainer.obs_dim
    n = 4 * cfg.batch_size
    if cfg.trunk == "conv":  # uint8 frames of a CPU rollout, as the replay holds them
        batch = _pixel_transitions(trainer, n, gen)
    else:
        obs = torch.randn((n, d), generator=gen)
        done = (torch.rand(n, generator=gen) < 0.1).float()
        batch = Transition(obs, torch.randint(0, trainer.n_actions, (n,), generator=gen,
                                              dtype=torch.int32),
                           torch.randn(n, generator=gen),
                           obs + 0.1 * torch.randn((n, d), generator=gen),
                           done * (torch.rand(n, generator=gen) < 0.7).float(), done)
    batch = Transition(*(x.to(device) for x in batch))
    if cfg.use_per:
        replay = per_push_batch(ts.replay, batch)
        pri = (torch.rand(n, generator=gen) + 0.01) ** cfg.per_alpha
        replay = per_update_priorities(replay, torch.arange(n, device=device), pri.to(device))
    else:
        replay = replay_push_batch(ts.replay, batch)
    return trainer, ts._replace(replay=replay)


def _pixel_transitions(trainer, n: int, gen: torch.Generator):
    """``n`` transitions of a random-action rollout of ``trainer``'s pixel env
    on the CPU, frames quantized to uint8."""
    from gymrl_tpu_torch.algos.dqn_variants import Transition, quantize_frames
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.rollout import VecEnv

    env, b = trainer.venv.env, trainer.cfg.num_envs
    venv = VecEnv(env, env.default_params(), b)
    noise = Noise("cpu", int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    vs, parts = venv.reset(noise), []
    for _ in range(-(-n // b)):
        action = torch.randint(0, env.n_actions, (b,), generator=gen, dtype=torch.int32)
        obs = vs.obs
        vs, tr = venv.step(vs, action, noise)
        parts.append(Transition(quantize_frames(obs), action, tr.reward,
                                quantize_frames(tr.next_obs), tr.terminated.float(),
                                tr.done.float()))
    return Transition(*(torch.cat(f)[:n] for f in zip(*parts)))


def phase_family_updates(device: torch.device, names=FAMILY,
                         label: str = "phase 8 family update") -> list[dict]:
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.nn.layers import noisy_layers
    from gymrl_tpu_torch.replay.per import PERState

    results = []
    cpu = torch.device("cpu")
    for name in names:
        (cpu_tr, cpu_ts), (dev_tr, dev_ts) = (
            _family_update_case(name, d, torch.Generator().manual_seed(11)) for d in (cpu, device))
        cfg = cpu_tr.cfg
        layers = noisy_layers(cpu_ts.params)
        gen = torch.Generator().manual_seed(13)
        u = torch.rand(cfg.batch_size, generator=gen)
        idx = torch.randint(0, cpu_ts.replay.size, (cfg.batch_size,), generator=gen)
        eps = Noise(cpu, 17).noisy_update(layers, 2) if cfg.noisy else []
        records, handles = _watch_family_ties(cpu_ts.params)
        out = {}
        for key, tr, ts, d in (("cpu", cpu_tr, cpu_ts, cpu), ("dev", dev_tr, dev_ts, device)):
            ts = ts._replace(noise=FamilyDraws(d, u, idx, eps))
            out[key] = tr._update(ts, ts.replay, ts.beta, layers)
            if key == "cpu":
                for h in handles:
                    h.remove()
        if device.type == "cuda":
            torch.cuda.synchronize()
        exempt = _family_exempt(cpu_ts.params, records)
        want = dict(cpu_ts.params.named_parameters())
        got = dict(dev_ts.params.named_parameters())
        worst = worst_exempt = 0.0
        n_exempt = 0
        for k, w in want.items():
            e = (got[k].detach().cpu().double() - w.detach().double()).abs()
            ok = (e <= PARAM_ATOL) | (exempt[k] & (e <= 2.0 * cfg.lr))
            if not bool(ok.all()):
                raise AssertionError(f"{name}: {k} differs by {float(e.max())} on the card")
            if bool((~exempt[k]).any()):
                worst = max(worst, float(e[~exempt[k]].max()))
            if bool(exempt[k].any()):
                worst_exempt = max(worst_exempt, float(e[exempt[k]].max()))
            n_exempt += int(exempt[k].sum())
        (rep_c, beta_c, loss_c), (rep_d, beta_d, loss_d) = out["cpu"], out["dev"]
        loss_c, loss_d = float(loss_c), float(loss_d)
        result = {"workload": name, "batch": cfg.batch_size, "loss_cpu": loss_c,
                  "loss_rel_err": abs(loss_d - loss_c) / abs(loss_c),
                  "param_max_abs_err": worst, "exempt_entries": n_exempt,
                  "exempt_max_abs_err": worst_exempt,
                  "beta": [float(beta_c), float(beta_d)]}
        if isinstance(rep_c, PERState):
            t_c, t_d = rep_c.tree.double(), rep_d.tree.cpu().double()
            result["tree_max_rel_err"] = float(((t_d - t_c).abs()
                                                / t_c.abs().clamp(min=1e-30)).max())
            result["max_priority"] = [float(rep_c.max_priority), float(rep_d.max_priority)]
            if not bool(((t_d - t_c).abs() <= UPDATE_RTOL * t_c.abs() + 1e-6 * float(t_c[1])).all()):
                raise AssertionError(f"{name}: written-back priorities differ: {result}")
            mp = result["max_priority"]
            if abs(mp[1] - mp[0]) > UPDATE_RTOL * mp[0]:
                raise AssertionError(f"{name}: max priority differs: {result}")
        log(f"{label}: " + json.dumps(result))
        if result["loss_rel_err"] > UPDATE_RTOL:
            raise AssertionError(f"{name}: loss {loss_d} on the card, {loss_c} on the CPU")
        if abs(result["beta"][1] - result["beta"][0]) > UPDATE_RTOL * result["beta"][0]:
            raise AssertionError(f"{name}: beta differs: {result}")
        results.append(result)
    return results


# -- phase 10: the recurrent pieces, card vs CPU ---------------------------------------------
RECURRENT = ("ppo_rnn_lunarlander", "ppo_rnn_flappybird", "ppg_rnn_lunarlander")


def phase_pack(device: torch.device, steps: int = PACK_STEPS, envs: int = PACK_ENVS) -> dict:
    """``episode_buffer_pack`` of a ``[T, B]`` rollout on the card and on the
    CPU: done rates rise across the columns to ~25 episodes per column, so
    the last columns overflow R=8. Everything must be equal."""
    from gymrl_tpu_torch.replay.episode import episode_buffer_pack

    gen = torch.Generator().manual_seed(21)
    done = (torch.rand((steps, envs), generator=gen) < torch.linspace(0.0, 0.2, envs)).float()
    data = {"obs": torch.randn((steps, envs, 8), generator=gen),
            "action": torch.randint(0, 4, (steps, envs), generator=gen, dtype=torch.int32),
            "h_pre": torch.randn((steps, envs, 64), generator=gen)}
    cpu = episode_buffer_pack(data, done, PACK_ROWS)
    dev = episode_buffer_pack({k: v.to(device) for k, v in data.items()}, done.to(device),
                              PACK_ROWS)
    fields = {**{f"data.{k}": (dev.data[k], cpu.data[k]) for k in data},
              **{f: (getattr(dev, f), getattr(cpu, f))
                 for f in ("active", "lengths", "dropped_steps", "dropped_episodes")}}
    differ = [k for k, (d, c) in fields.items() if not torch.equal(d.cpu(), c)]
    segments = 1 + done[:-1].sum(dim=0)
    result = {"steps": steps, "envs": envs, "rows_per_env": PACK_ROWS,
              "most_episodes_in_a_column": int(segments.max()),
              "columns_over_rows": int((segments > PACK_ROWS).sum()),
              "dropped_steps": int(cpu.dropped_steps),
              "dropped_episodes": int(cpu.dropped_episodes), "fields_differ": differ}
    log("phase 10 episode pack: " + json.dumps(result))
    if differ:
        raise AssertionError(f"the packed rollout differs on the card: {differ}")
    if not result["columns_over_rows"] or not result["dropped_episodes"]:
        raise AssertionError("the rollout should overflow some columns")
    return result


def phase_seq_forward(device: torch.device, names=RECURRENT[1::-1], rows: int = SEQ_ROWS,
                      steps: int = PACK_STEPS) -> list[dict]:
    """The hoisted re-unroll (``_seq_forward``: trunk and heads batched, the
    GRU's hidden side a loop of ``steps``) of each preset's net on the card
    against the CPU, and against the card's own step-by-step forward."""
    from gymrl_tpu_torch.run import cli

    results = []
    for name in names:
        trainers = {r: cli.WORKLOADS[name](d)[0] for r, d in (("cpu", "cpu"),
                                                                 ("dev", str(device)))}
        cpu_tr, dev_tr = trainers["cpu"], trainers["dev"]
        nets = {r: tr.make_net(torch.Generator().manual_seed(0)).to(tr.device)
                for r, tr in trainers.items()}
        rnn = nets["cpu"].rnn_size
        gen = torch.Generator().manual_seed(5)
        obs = torch.randn((rows, steps, cpu_tr.obs_dim), generator=gen)
        h0 = torch.tanh(torch.randn((rows, rnn), generator=gen))
        h0[rows // 2:] = 0.0  # fresh episodes start from zero
        out = {}
        with torch.no_grad():
            for r, tr in trainers.items():
                args = (nets[r], h0.to(tr.device), obs.to(tr.device))
                out[r] = (*tr._seq_forward(*args), nets[r].unroll(*args[1:])[:, -1, -rnn:])
            h, step_logits, step_values = h0.to(device), [], []
            for t in range(steps):
                h, lg, v = dev_tr._apply_cell(nets["dev"], h, obs[:, t].to(device))
                step_logits.append(lg)
                step_values.append(v)
        stepwise = (torch.stack(step_logits, 1), torch.stack(step_values, 1), h)
        if device.type == "cuda":
            torch.cuda.synchronize()

        def err(a, b):
            return [float((x.cpu().double() - y.cpu().double()).abs().max()) for x, y in zip(a, b)]

        names3 = ("logits", "values", "last_hidden")
        result = {"workload": name, "rows": rows, "steps": steps, "atol": SEQ_ATOL,
                  "card_vs_cpu": dict(zip(names3, err(out["dev"], out["cpu"]))),
                  "hoisted_vs_stepwise": dict(zip(names3, err(out["dev"], stepwise)))}
        log("phase 10 seq forward: " + json.dumps(result))
        worst = max(*result["card_vs_cpu"].values(), *result["hoisted_vs_stepwise"].values())
        if not worst <= SEQ_ATOL:
            raise AssertionError(f"{name}: sequence forward differs by {worst}")
        results.append(result)
    return results


def _rnn_minibatch(trainer, net, rows: int, gen: torch.Generator) -> dict:
    """A packed-row minibatch as whole-episode BPTT makes it: the first row
    of each column group a continuation (carried hidden), the others fresh
    (zero); each row active for a prefix, zero-padded after it; behaviour
    log-probs near the net's own, advantages of both signs, an anchor
    distribution near the current one."""
    cfg = trainer.cfg
    steps, rnn = cfg.rollout_steps, net.rnn_size
    obs = torch.randn((rows, steps, trainer.obs_dim), generator=gen)
    h0 = torch.tanh(torch.randn((rows, rnn), generator=gen))
    h0[torch.arange(rows) % cfg.episode_rows_per_env != 0] = 0.0
    lengths = torch.randint(1, steps + 1, (rows,), generator=gen)
    mask = (torch.arange(steps)[None, :] < lengths[:, None]).float()
    obs = obs * mask[..., None]
    with torch.no_grad():
        logits, _ = trainer._seq_forward(net, h0, obs)
    logp_all = torch.log_softmax(logits, -1)
    action = torch.randint(0, trainer.n_actions, (rows, steps), generator=gen, dtype=torch.int32)
    taken = logp_all.gather(-1, action.long()[..., None])[..., 0]
    return {
        "obs": obs, "h0": h0, "mask": mask, "action": action,
        "logp": taken + 0.3 * torch.randn((rows, steps), generator=gen),
        "adv": 2.0 * torch.randn((rows, steps), generator=gen),
        "v_target": 3.0 * torch.randn((rows, steps), generator=gen),
        "anchor_logp_all": torch.log_softmax(
            logits + 0.5 * torch.randn(logits.shape, generator=gen), -1),
    }


def phase_rnn_updates(device: torch.device, rows: int = SEQ_ROWS, overrides=None) -> list[dict]:
    """One phase-1 step of recurrent PPO (both presets) and one auxiliary
    step of PPG in each clone target, on the card and on the CPU from the
    same params and packed minibatch. Losses to rtol 1e-5; params under
    phase 5's rules, the tie rule along ``activation_edges``."""
    import dataclasses

    from gymrl_tpu_torch.algos.base import pack_fields, unpack_fields
    from gymrl_tpu_torch.run import cli

    cases = (("ppo_rnn_lunarlander", None), ("ppo_rnn_flappybird", None),
             ("ppg_rnn_lunarlander", "current"), ("ppg_rnn_lunarlander", "behavior"))
    results = []
    for name, clone in cases:
        trainers = {}
        for role, d in (("cpu", "cpu"), ("dev", str(device))):
            tr = cli.WORKLOADS[name](d)[0]
            cfg = dataclasses.replace(tr.cfg, **(overrides or {}),
                                      **({"clone_target": clone} if clone else {}))
            trainers[role] = type(tr)(cfg, device=d)
        cpu_tr = trainers["cpu"]
        states = {role: tr.init(0) for role, tr in trainers.items()}
        cpu_ts, dev_ts = states["cpu"], states["dev"]
        mb = _rnn_minibatch(cpu_tr, cpu_ts.params, rows, torch.Generator().manual_seed(9))
        if clone != "current":
            mb.pop("anchor_logp_all")
        packed, spec = pack_fields(mb)
        loss_name = "_aux_loss" if clone else "_loss"
        losses, metrics, records = {}, {}, {}
        for role, tr in trainers.items():
            ts, rows_d = states[role], packed.to(tr.device)
            loss_fn = getattr(tr, loss_name)
            with torch.no_grad():
                losses[role] = float(loss_fn(ts.params, unpack_fields(rows_d, spec))[0])
            records[role], handles = _watch_family_ties(ts.params)
            step_metrics = tr._grad_step(ts, rows_d, spec, loss_fn)
            metrics[role] = {k: float(v) for k, v in step_metrics.items()}
            for h in handles:
                h.remove()
        if device.type == "cuda":
            torch.cuda.synchronize()
        # A minibatch of 8192 steps puts some pre-activation within RELU_TIE of
        # a kink in almost every unit, so here the tie rule marks only the
        # units where the two devices put some step on different sides.
        pairs = [(name_c, (a, b)) for (name_c, a), (_, b) in zip(records["cpu"], records["dev"])]
        exempt = _family_exempt(cpu_ts.params, pairs,
                                lambda ab: ((ab[0] >= 0) != (ab[1].cpu() >= 0)).any(dim=0))
        want = dict(cpu_ts.params.named_parameters())
        got = dict(dev_ts.params.named_parameters())
        lr = cpu_tr.cfg.lr
        worst = worst_exempt = 0.0
        n_exempt = 0
        for k, w in want.items():
            e = (got[k].detach().cpu().double() - w.detach().double()).abs()
            ok = (e <= PARAM_ATOL) | (exempt[k] & (e <= 2.0 * lr))
            if not bool(ok.all()):
                raise AssertionError(f"{name} {clone}: {k} differs by {float(e.max())} on the card")
            if bool((~exempt[k]).any()):
                worst = max(worst, float(e[~exempt[k]].max()))
            if bool(exempt[k].any()):
                worst_exempt = max(worst_exempt, float(e[exempt[k]].max()))
            n_exempt += int(exempt[k].sum())
        loss_rel = abs(losses["dev"] - losses["cpu"]) / abs(losses["cpu"])
        result = {"workload": name, "step": f"aux ({clone})" if clone else "phase 1",
                  "rows": rows, "steps": cpu_tr.cfg.rollout_steps, "loss_cpu": losses["cpu"],
                  "loss_rel_err": loss_rel,
                  "metric_abs_err": {k: abs(metrics["dev"][k] - v)
                                     for k, v in metrics["cpu"].items()},
                  "param_max_abs_err": worst, "exempt_entries": n_exempt,
                  "exempt_max_abs_err": worst_exempt}
        log("phase 10 rnn update: " + json.dumps(result))
        if loss_rel > UPDATE_RTOL:
            raise AssertionError(f"{name} {clone}: loss {losses['dev']} on the card, "
                                 f"{losses['cpu']} on the CPU")
        results.append(result)
    return results


# -- phase 11: the recurrent workloads on the card ---------------------------------------------
def phase_rnn_workloads(device: torch.device, names=RECURRENT,
                        timed_iters: int = WORKLOAD_TIMED_ITERS, episodes: int = 5,
                        overrides=None) -> list[dict]:
    """Each recurrent CLI workload through TrainLoop: a warm-up iteration,
    ``timed_iters`` timed ones, the test, a checkpoint restore. PPG starts at
    six iterations' worth of env steps, so its first timed iteration (index
    7) runs the auxiliary phase and the next skips it."""
    import dataclasses

    from gymrl_tpu_torch.algos.ppg import PPGTrainer
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cuda = device.type == "cuda"
    results = []
    for name in names:
        trainer, algo, solve = cli.WORKLOADS[name](str(device))
        if overrides:
            cfg = dataclasses.replace(trainer.cfg, **{k: v for k, v in overrides.items()
                                                      if hasattr(trainer.cfg, k)})
            trainer = type(trainer)(cfg, device=device)
        cfg = trainer.cfg
        per_iter = cfg.batch_total
        ppg = isinstance(trainer, PPGTrainer)
        ts0 = trainer.init(0)
        if ppg:
            ts0 = ts0._replace(env_steps=6 * per_iter)
        start = ts0.env_steps
        initial = {n: v.detach().clone() for n, v in ts0.params.state_dict().items()}
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # the loop saves to ./checkpoints
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
            finally:
                os.chdir(cwd)
            warm_outs = []

            def capture(ts, timer=None, _train_iter=trainer.train_iter):
                ts, out = _train_iter(ts, timer)
                warm_outs.append(out)
                return ts, out

            trainer.train_iter = capture  # the warm-up's metrics, read below
            t0 = time.perf_counter()
            ts, _ = loop.train(start + per_iter, solve_threshold=solve, ts=ts0)  # warm-up
            del trainer.train_iter
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            warm_s = time.perf_counter() - t0
            clock = PhaseClock(device)
            walls, phases, outs, aux_ran = [], [], [], []
            for _ in range(timed_iters):
                aux_ran.append(ppg and trainer.aux_runs(ts.env_steps))
                t0 = time.perf_counter()
                clock.start()
                ts, out = trainer.train_iter(ts, timer=clock.mark)
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(clock.phase_ms())
                outs.append({k: float(v) for k, v in out.metrics.items()})
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            t0 = time.perf_counter()
            mean_reward = loop.test(ts, episodes=episodes)
            test_s = time.perf_counter() - t0
            path = save_checkpoint(loop.ckpt_path, ts)
            example = trainer.init(1)
            restored = restore_checkpoint(path, example)
            restore = _check_restored(name, ts, restored, example, path)

        iters = timed_iters + 1
        last_done = out.ep_done[-1]
        result = {
            "workload": name, "env_steps": ts.env_steps, "warmup_iter_s": warm_s,
            # a fresh batch's first scaled rewards are huge (the scaler's
            # first std is 1e-8, as in the reference): its value loss shows it
            "warmup_metrics": {k: float(v) for k, v in warm_outs[0].metrics.items()},
            "env_steps_per_s": timed_iters * per_iter / sum(walls),
            "iter_wall_ms": [w * 1e3 for w in walls],
            "phase_ms": {p: [ph[p] for ph in phases] for p in phases[0]},
            "peak_memory_bytes": peak, "metrics": outs, "aux_ran": aux_ran,
            "test_episodes": episodes, "test_mean_reward": mean_reward, "test_s": test_s,
            "envs_done_at_last_step": int(last_done.sum()),
        }
        # counts, hidden, metrics, moves, restore
        if ts.env_steps != start + iters * per_iter:
            raise AssertionError(f"{name}: env_steps {ts.env_steps}")
        if float(ts.obs_rms.count) != iters * per_iter:
            raise AssertionError(f"{name}: obs_rms count {float(ts.obs_rms.count)}")
        hidden = ts.hidden.abs().sum(dim=-1)
        if bool((hidden[last_done] != 0).any()) or not bool((hidden[~last_done] > 0).all()):
            raise AssertionError(f"{name}: the hidden is not zero exactly at the last dones")
        if not all(math.isfinite(v) for m in outs for v in m.values()) \
                or not math.isfinite(mean_reward):
            raise AssertionError(f"{name}: non-finite metrics {outs} / test {mean_reward}")
        grad_steps = cfg.num_epochs * cfg.num_minibatches
        aux_steps = cfg.aux_epochs * cfg.num_minibatches if ppg else 0
        if ppg and aux_ran != [i == 0 for i in range(timed_iters)]:
            raise AssertionError(f"{name}: the auxiliary phase ran at {aux_ran}")
        for m, ran in zip(outs, aux_ran):
            if ppg and (m["aux_value_loss"] != 0.0) != ran:
                raise AssertionError(f"{name}: aux metrics {m} with the phase run={ran}")
        want_steps = iters * grad_steps + aux_steps * sum(aux_ran)
        if _adam_counts(ts.opt_state) != {want_steps}:
            raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {want_steps}")
        state = ts.params.state_dict()
        if not all(v.device.type == device.type for v in state.values()) \
                or ts.hidden.device.type != device.type:
            raise AssertionError(f"{name}: the state left the device")
        moved = [n for n, v in initial.items() if not torch.equal(state[n], v)]
        if len(moved) != len(initial):
            raise AssertionError(f"{name}: {sorted(set(initial) - set(moved))} did not move")
        result.update(adam_steps=want_steps, **restore)
        log("phase 11 recurrent workload: " + json.dumps(result))
        results.append(result)
    return results


# -- phase 12: the mHC family's pieces, card vs CPU ---------------------------------------------
MHC = ("ppo_full_lunarlander", "ppo_lstm_lunarlander")


def _max_err(got: torch.Tensor, want: torch.Tensor, rel: bool = False) -> float:
    e = (got.detach().cpu().double() - want.detach().cpu().double()).abs()
    if rel:
        e = e / want.detach().cpu().double().abs().clamp(min=1e-30)
    return float(e.max())


def _grads_ok(got: dict, want: dict) -> tuple[float, bool]:
    """The largest gradient difference relative to its tensor's largest
    entry, and whether every entry is within rtol 1e-5 plus 1e-5 of it."""
    worst, ok = 0.0, True
    for k, w in want.items():
        w, g = w.double(), got[k].detach().cpu().double()
        scale = float(w.abs().max()) or 1e-30
        e = (g - w).abs()
        worst = max(worst, float(e.max()) / scale)
        ok &= bool((e <= UPDATE_RTOL * w.abs() + 1e-5 * scale).all())
    return worst, ok


def phase_mhc_pieces(device: torch.device, rows: int = MHC_ROWS,
                     seqs: tuple[int, int] = URNN_SHAPE) -> dict:
    """Sinkhorn on ``rows`` [2, 2] blocks, the ``MHCBackbone(256, 2, 2, 10)``
    forward and its stop-gradient gradients on ``rows`` observations (nonzero
    ``w``), and the URNN cells (gru and lstm, hidden 512) unrolled over
    ``seqs`` on the card, against the CPU; the cells also against the
    card's own stepwise forward."""
    from gymrl_tpu_torch.nn.mhc import MHCBackbone, sinkhorn_knopp
    from gymrl_tpu_torch.nn.recurrent import URNNCell

    gen = torch.Generator().manual_seed(31)
    A = torch.exp(2.0 * torch.randn((rows, 2, 2), generator=gen))
    cpu_out = sinkhorn_knopp(A, 10)
    dev_out = sinkhorn_knopp(A.to(device), 10)
    result = {"sinkhorn": {"blocks": rows, "iters": 10, "form": "elementwise",
                           "max_rel_err": {n: _max_err(d, c, rel=True)
                                           for n, d, c in zip("Puv", dev_out, cpu_out)}}}

    nets = {"cpu": MHCBackbone(8, 256, 2, 2, 10, generator=torch.Generator().manual_seed(0))}
    with torch.no_grad():
        for name, p in nets["cpu"].named_parameters():
            if name.endswith(".w"):  # nonzero w: the maps then read the state
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    nets["dev"] = copy.deepcopy(nets["cpu"]).to(device)
    obs = 2.0 * torch.randn((rows, 8), generator=gen)
    w_out = torch.randn((rows, 256), generator=gen)
    outs, grads = {}, {}
    for role, net in nets.items():
        d = next(net.parameters()).device
        outs[role] = net(obs.to(d))
        (outs[role] * w_out.to(d)).sum().backward()
        grads[role] = {k: p.grad for k, p in net.named_parameters()}
    worst_grad, grads_ok = _grads_ok(grads["dev"], grads["cpu"])
    result["mhc_backbone"] = {"rows": rows, "dim": 256, "rate": 2, "layers": 2,
                              "out_max_abs_err": _max_err(outs["dev"], outs["cpu"]),
                              "grad_max_err_over_tensor_max": worst_grad}

    cells = {}
    B, L = seqs
    for kind in ("gru", "lstm"):
        cell = URNNCell(256, 512, kind, generator=torch.Generator().manual_seed(1))
        cell_dev = copy.deepcopy(cell).to(device)
        h0 = torch.tanh(torch.randn((B, cell.packed_size), generator=gen))
        xs = torch.randn((B, L, 256), generator=gen)
        with torch.no_grad():
            cpu_seq = cell.unroll(h0, xs)
            dev_seq = cell_dev.unroll(h0.to(device), xs.to(device))
            h, steps = h0.to(device), []
            for t in range(L):
                h, out = cell_dev(h, xs[:, t].to(device))
                steps.append(out)
        cells[kind] = {
            "card_vs_cpu": {"outs": _max_err(dev_seq[0], cpu_seq[0]),
                            "last_hidden": _max_err(dev_seq[1], cpu_seq[1])},
            "unroll_vs_stepwise": {"outs": _max_err(dev_seq[0], torch.stack(steps, 1)),
                                   "last_hidden": _max_err(dev_seq[1], h)}}
    result["urnn"] = {"rows": B, "steps": L, "hidden": 512, "atol": SEQ_ATOL, **cells}
    log("phase 12 mhc pieces: " + json.dumps(result))
    if max(result["sinkhorn"]["max_rel_err"].values()) > UPDATE_RTOL:
        raise AssertionError(f"Sinkhorn differs on the card: {result['sinkhorn']}")
    if result["mhc_backbone"]["out_max_abs_err"] > SEQ_ATOL or not grads_ok:
        raise AssertionError(f"the mHC backbone differs on the card: {result['mhc_backbone']}")
    worst = max(v for c in cells.values() for part in c.values() for v in part.values())
    if worst > SEQ_ATOL:
        raise AssertionError(f"the URNN unroll differs by {worst}")
    return result


def _prelu_producers(net) -> list[str]:
    """Every layer whose output passes a PReLU (each MLP's ``layer_i`` with
    an ``act_i``), the RND pair's last blocks included."""
    from gymrl_tpu_torch.nn.layers import MLP

    return [f"{name}.layer_{i}" for name, m in net.named_modules() if isinstance(m, MLP)
            for i in range(m.n) if hasattr(m, f"act_{i}")]


def _mhc_minibatch(trainer, net, gen: torch.Generator) -> dict:
    """One minibatch at the preset's size (1024 rows for ppo_full; 128
    sequences of 8 steps for ppo_lstm): behaviour log-probs near the net's
    own, old entropies ×U(0.9, 1.1) of the current ones (so ERC masks some),
    advantages of both signs, old values near the returns."""
    cfg = trainer.cfg
    lstm = hasattr(cfg, "seq_len")
    lead = (cfg.seqs_per_rollout // cfg.num_minibatches, cfg.seq_len) if lstm else \
        (cfg.batch_total // cfg.num_minibatches,)
    obs = 2.0 * torch.randn(lead + (trainer.obs_dim,), generator=gen)
    mb = {"obs": obs}
    if lstm:
        mb["h0"] = torch.tanh(torch.randn((lead[0], net.packed_hidden), generator=gen))
    with torch.no_grad():
        logits = (trainer._seq_forward(net, mb["h0"], obs)[0] if lstm else net(obs)[0])
    logp_all = torch.log_softmax(logits, -1)
    action = torch.randint(0, trainer.n_actions, lead, generator=gen, dtype=torch.int32)
    entropy = -(logp_all.exp() * logp_all).sum(-1)
    ret = 3.0 * torch.randn(lead, generator=gen)
    mb.update(action=action,
              logp=logp_all.gather(-1, action.long()[..., None])[..., 0]
              + 0.3 * torch.randn(lead, generator=gen),
              old_entropy=entropy * (0.9 + 0.2 * torch.rand(lead, generator=gen)),
              adv=2.0 * torch.randn(lead, generator=gen), ret=ret)
    if lstm:
        mb["old_value"] = ret + 0.4 * torch.randn(lead, generator=gen)
    return mb


def _erc_ratio(trainer, net, mb) -> torch.Tensor:
    """ERC's entropy ratio of each sample of ``mb`` under ``net``, on the CPU."""
    with torch.no_grad():
        logits = (trainer._seq_forward(net, mb["h0"], mb["obs"])[0] if "h0" in mb
                  else net(mb["obs"])[0])
        logp_all = torch.log_softmax(logits, -1)
        return (-(logp_all.exp() * logp_all).sum(-1) / (mb["old_entropy"] + 1e-8)).cpu()


def phase_mhc_updates(device: torch.device, overrides=None) -> list[dict]:
    """One grad step of the ppo_full preset, of the same with clip-cov on
    (``clip_cov_ratio`` 0.2, the same uniforms on both devices), and of the
    ppo_lstm preset, on the card and on the CPU from the same params (the
    actor head ×500 and the mHC's ``w`` made nonzero, so clip-cov and ERC
    act) and the same minibatch. Loss to rtol 1e-5; params under phase 5's
    rules, the tie rule on every PReLU unit (the RND pair's too) where the
    two devices put some row on different sides of its kink; the ERC tie
    rule: a sample whose entropy ratio the devices put on different sides
    of ``1 ± 0.06`` must lie within ERC_TIE of the edge, and the CPU's step
    then takes the card's side (its old entropy moved by 2·ERC_TIE); the
    clip-cov masks equal, or a covariance on different sides of a band
    edge (the CPU then takes the card's mask). The RND target stays equal
    to the bit on both."""
    import dataclasses

    from gymrl_tpu_torch.algos.base import pack_fields
    from gymrl_tpu_torch.run import cli

    cases = (("ppo_full_lunarlander", {}), ("ppo_full_lunarlander", {"clip_cov_ratio": 0.2}),
             ("ppo_lstm_lunarlander", {}))
    results = []
    for name, extra in cases:
        trainers = {}
        for role, d in (("cpu", "cpu"), ("dev", str(device))):
            tr = cli.WORKLOADS[name](d)[0]
            trainers[role] = type(tr)(dataclasses.replace(tr.cfg, **(overrides or {}), **extra),
                                      device=d)
        cpu_tr, dev_tr = trainers["cpu"], trainers["dev"]
        cfg = cpu_tr.cfg
        lstm = hasattr(cfg, "seq_len")
        gen = torch.Generator().manual_seed(41)
        cpu_ts = cpu_tr.init(0)
        with torch.no_grad():
            for k, p in cpu_ts.params.named_parameters():
                if k.endswith(".w"):
                    p.add_(0.05 * torch.randn(p.shape, generator=gen))
                elif k.startswith("actor.fc1."):
                    p.mul_(500.0)
        dev_ts = dev_tr.init(0)
        dev_ts.params.load_state_dict(cpu_ts.params.state_dict())
        states = {"cpu": cpu_ts, "dev": dev_ts}
        mb = _mhc_minibatch(cpu_tr, cpu_ts.params, gen)
        mbs = {"cpu": dict(mb), "dev": {k: v.to(device) for k, v in mb.items()}}
        # ERC: give the CPU the card's side where the devices differ at an edge
        lo, hi = 1.0 - cfg.erc_beta_low, 1.0 + cfg.erc_beta_high
        ratio = {r: _erc_ratio(trainers[r], states[r].params, mbs[r]) for r in states}
        inside = {r: (x > lo) & (x < hi) for r, x in ratio.items()}
        differ = inside["cpu"] != inside["dev"]
        edge = torch.minimum((ratio["dev"] - lo).abs(), (ratio["dev"] - hi).abs())
        if bool((edge[differ] >= ERC_TIE).any()):
            raise AssertionError(f"{name}: ERC masks differ off the band edges")
        # the CPU's ratio must grow (its old entropy shrink) to reach the card's side
        grow = torch.where(inside["dev"], ratio["dev"] < 1.0, ratio["dev"] >= 1.0)
        old = mbs["cpu"]["old_entropy"]
        mbs["cpu"]["old_entropy"] = torch.where(
            differ, old * torch.where(grow, 1.0 - 2 * ERC_TIE, 1.0 + 2 * ERC_TIE), old)
        lr, ent_coef = cfg.lr, cfg.entropy_coef
        cov = {}
        if not lstm:
            from gymrl_tpu_torch.algos.ppo_full import cov_drop_mask

            u = torch.rand(mb["obs"].shape[0], generator=gen)
            if cfg.clip_cov_ratio > 0:
                covs = {r: tr._covs(states[r].params, mbs[r]).cpu() for r, tr in trainers.items()}
                for r, tr in trainers.items():
                    cov[r] = cov_drop_mask(u.to(tr.device), covs[r].to(tr.device),
                                           cfg.clip_cov_ratio, cfg.clip_cov_min,
                                           cfg.clip_cov_max).cpu()
                band = {r: (c > cfg.clip_cov_min) & (c < cfg.clip_cov_max)
                        for r, c in covs.items()}
                if not torch.equal(band["cpu"], band["dev"]):
                    edge = (band["cpu"] != band["dev"])
                    near = torch.minimum((covs["dev"] - cfg.clip_cov_min).abs(),
                                         (covs["dev"] - cfg.clip_cov_max).abs())
                    if bool((near[edge] >= COV_TIE).any()):
                        raise AssertionError(f"{name}: clip-cov bands differ off the edges")
                    cov["cpu"] = cov["dev"]  # the CPU takes the card's mask
                elif not torch.equal(cov["cpu"], cov["dev"]):
                    raise AssertionError(f"{name}: clip-cov masks differ from the same uniforms")
            for r in states:
                mbs[r]["cov_keep"] = cov[r].to(trainers[r].device) if cov else \
                    torch.ones_like(mbs[r]["adv"])
        targets = {r: {k: v.clone() for k, v in states[r].params.state_dict().items()
                       if k.startswith("rnd.target.")} for r in states}
        losses, metrics, records = {}, {}, {}
        for role, tr in trainers.items():
            ts = states[role]
            with torch.no_grad():
                losses[role] = float(tr._loss(ts.params, mbs[role], ent_coef)[0])
            records[role], handles = _watch_family_ties(ts.params, _prelu_producers(ts.params))
            if lstm:
                rows, spec = pack_fields(mbs[role])
                step = tr._grad_step(ts, rows, spec, lambda net, m, tr=tr: tr._loss(net, m, ent_coef))
            else:
                step = tr._grad_step(ts, mbs[role], ent_coef)
            metrics[role] = {k: float(v) for k, v in step.items()}
            for h in handles:
                h.remove()
        if device.type == "cuda":
            torch.cuda.synchronize()
        pairs = [(n, (a, b)) for (n, a), (_, b) in zip(records["cpu"], records["dev"])]
        exempt = _family_exempt(cpu_ts.params, pairs,
                                lambda ab: ((ab[0] >= 0) != (ab[1].cpu() >= 0)).any(dim=0))
        want = dict(cpu_ts.params.named_parameters())
        got = dict(dev_ts.params.named_parameters())
        worst = worst_exempt = 0.0
        n_exempt = 0
        for k, w in want.items():
            e = (got[k].detach().cpu().double() - w.detach().double()).abs()
            ok = (e <= PARAM_ATOL) | (exempt[k] & (e <= 2.0 * lr))
            if not bool(ok.all()):
                raise AssertionError(f"{name} {extra}: {k} differs by {float(e.max())} on the card")
            if bool((~exempt[k]).any()):
                worst = max(worst, float(e[~exempt[k]].max()))
            if bool(exempt[k].any()):
                worst_exempt = max(worst_exempt, float(e[exempt[k]].max()))
            n_exempt += int(exempt[k].sum())
        for r in states:
            now = states[r].params.state_dict()
            if not all(torch.equal(now[k], v) for k, v in targets[r].items()):
                raise AssertionError(f"{name}: the RND target moved on {r}")
        loss_rel = abs(losses["dev"] - losses["cpu"]) / abs(losses["cpu"])
        result = {"workload": name, "overrides": extra, "rows": list(mb["adv"].shape),
                  "loss_cpu": losses["cpu"], "loss_rel_err": loss_rel,
                  "erc_masked": int((~inside["dev"]).sum()), "erc_ties": int(differ.sum()),
                  "cov_dropped": int((cov["cpu"] == 0).sum()) if cov else 0,
                  "metric_abs_err": {k: abs(metrics["dev"][k] - v)
                                     for k, v in metrics["cpu"].items()},
                  "param_max_abs_err": worst, "exempt_entries": n_exempt,
                  "exempt_max_abs_err": worst_exempt,
                  "rnd_target_equal": True if targets["cpu"] else None}
        log("phase 12 mhc update: " + json.dumps(result))
        if loss_rel > UPDATE_RTOL:
            raise AssertionError(f"{name} {extra}: loss {losses['dev']} on the card, "
                                 f"{losses['cpu']} on the CPU")
        results.append(result)
    return results


# -- phase 13: the mHC family's workloads on the card ---------------------------------------
def phase_mhc_workloads(device: torch.device, names=MHC,
                        timed_iters: int = WORKLOAD_TIMED_ITERS, episodes: int = 5,
                        overrides=None) -> list[dict]:
    """Each mHC-family CLI workload through TrainLoop: a warm-up iteration,
    ``timed_iters`` timed ones, the test (the hidden carried for ppo_lstm), a
    checkpoint restore."""
    import dataclasses

    from gymrl_tpu_torch.algos.ppo_full import annealed
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cuda = device.type == "cuda"
    results = []
    for name in names:
        trainer, algo, solve = cli.WORKLOADS[name](str(device))
        if overrides:
            cfg = dataclasses.replace(trainer.cfg, **{k: v for k, v in overrides.items()
                                                      if hasattr(trainer.cfg, k)})
            trainer = type(trainer)(cfg, device=device)
        cfg = trainer.cfg
        per_iter = cfg.batch_total
        ts0 = trainer.init(0)
        initial = {n: v.detach().clone() for n, v in ts0.params.state_dict().items()}
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # the loop saves to ./checkpoints
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
            finally:
                os.chdir(cwd)
            t0 = time.perf_counter()
            ts, _ = loop.train(per_iter, solve_threshold=solve, ts=ts0)  # warm-up
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            warm_s = time.perf_counter() - t0
            clock = PhaseClock(device)
            walls, phases, outs, anneal = [], [], [], []
            for _ in range(timed_iters):
                anneal.append(annealed(cfg, ts.env_steps))
                t0 = time.perf_counter()
                clock.start()
                ts, out = trainer.train_iter(ts, timer=clock.mark)
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(clock.phase_ms())
                outs.append({k: float(v) for k, v in out.metrics.items()})
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            t0 = time.perf_counter()
            mean_reward = loop.test(ts, episodes=episodes)
            test_s = time.perf_counter() - t0
            path = save_checkpoint(loop.ckpt_path, ts)
            example = trainer.init(1)
            restored = restore_checkpoint(path, example)
            restore = _check_restored(name, ts, restored, example, path)

        iters = timed_iters + 1
        result = {
            "workload": name, "env_steps": ts.env_steps, "warmup_iter_s": warm_s,
            "env_steps_per_s": timed_iters * per_iter / sum(walls),
            "iter_wall_ms": [w * 1e3 for w in walls],
            "phase_ms": {p: [ph[p] for ph in phases] for p in phases[0]},
            "peak_memory_bytes": peak, "metrics": outs,
            "test_episodes": episodes, "test_mean_reward": mean_reward, "test_s": test_s,
        }
        if ts.env_steps != iters * per_iter:
            raise AssertionError(f"{name}: env_steps {ts.env_steps}")
        if [(m["lr"], m["ent_coef"]) for m in outs] != anneal:
            raise AssertionError(f"{name}: lr / ent_coef {outs} do not follow the anneal {anneal}")
        if not all(math.isfinite(v) for m in outs for v in m.values()) \
                or not math.isfinite(mean_reward):
            raise AssertionError(f"{name}: non-finite metrics {outs} / test {mean_reward}")
        want_steps = iters * cfg.num_epochs * cfg.num_minibatches
        if _adam_counts(ts.opt_state) != {want_steps}:
            raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {want_steps}")
        state = ts.params.state_dict()
        on_card = [v.device.type == device.type for v in state.values()]
        if hasattr(ts, "hidden"):
            last_done = out.ep_done[-1]
            hidden = ts.hidden.abs().sum(dim=-1)
            result["envs_done_at_last_step"] = int(last_done.sum())
            if bool((hidden[last_done] != 0).any()) or not bool((hidden[~last_done] > 0).all()):
                raise AssertionError(f"{name}: the hidden is not zero exactly at the last dones")
            on_card.append(ts.hidden.device.type == device.type)
        if not all(on_card):
            raise AssertionError(f"{name}: the state left the device")
        frozen = [n for n in initial if n.startswith("rnd.target.")]
        if not all(torch.equal(state[n], initial[n]) for n in frozen):
            raise AssertionError(f"{name}: the RND target moved")
        still = [n for n, v in initial.items() if n not in frozen and torch.equal(state[n], v)]
        if still:
            raise AssertionError(f"{name}: {still} did not move")
        result.update(adam_steps=want_steps, rnd_target_tensors_equal=len(frozen), **restore)
        log("phase 13 mhc workload: " + json.dumps(result))
        results.append(result)
    return results


# -- phase 14: the tabular workloads ------------------------------------------------------------
TABULAR = ("qlearning_frozenlake", "qlearning_cliffwalking")
GRID_WARM_STEPS = 30
MC_WARM_STEPS = 100
MC_ATOL = 1e-6
Q_TIE = 1e-6  # Q-values this close may be ordered either way by the two devices
Q_RTOL = 1e-6


def phase_tabular_envs(device: torch.device, num: int = CLASSIC_ENVS) -> list[dict]:
    from gymrl_tpu_torch.envs.cliffwalking import CliffWalking
    from gymrl_tpu_torch.envs.frozenlake import FrozenLake
    from gymrl_tpu_torch.envs.mountaincar import MountainCar

    results = [
        compare_env_step(FrozenLake(), device, num, GRID_WARM_STEPS, 0.0, max_ties=0),
        compare_env_step(CliffWalking(), device, num, GRID_WARM_STEPS, 0.0, max_ties=0),
        compare_env_step(MountainCar(), device, num, MC_WARM_STEPS, MC_ATOL),
    ]
    for r in results:
        log("phase 14 tabular env: " + json.dumps(r))
    return results


class StepDraws:
    """One Q-learning vector step's draws, made on the CPU and handed out on
    any device: the ε-greedy pair, the env step's and the reset's."""

    def __init__(self, device, explore, step, reset):
        self.device, self.pair, self.step, self.reset = device, explore, step, reset

    def explore(self, num, n_actions):
        return tuple(x.to(self.device) for x in self.pair)

    def env_step(self, env, num):
        return _to(self.step, self.device)

    def env_reset(self, env, num):
        return _to(self.reset, self.device)


def _qlearning_step_case(name: str, device: torch.device, num: int) -> dict:
    """One vector step of ``num`` envs on the card against the CPU from the
    same table, env batch and draws: a table learned by 3 CPU iterations,
    with every entry rounded to 1/8 so that ties are common."""
    import dataclasses

    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.run import cli

    base = cli.WORKLOADS[name]("cpu")[0]
    cfg = dataclasses.replace(base.cfg, num_envs=num)
    cpu_tr, dev_tr = type(base)(cfg, device="cpu"), type(base)(cfg, device=device)
    ts = cpu_tr.init(0)
    for _ in range(3):
        ts, _ = cpu_tr.train_iter(ts)
    q = torch.round(ts.q_table * 8.0) / 8.0
    env, noise = cpu_tr.venv.env, Noise("cpu", 1)
    draws = (noise.explore(num, cpu_tr.n_actions), env.step_draws(noise, num),
             env.reset_draws(noise, num))
    out = {}
    for key, tr, d in (("cpu", cpu_tr, torch.device("cpu")), ("dev", dev_tr, device)):
        out[key] = tr.vector_step(_to(q, d), _to(ts.vec_state, d), StepDraws(d, *draws),
                                  ts.sample_count)
    if device.type == "cuda":
        torch.cuda.synchronize()
    (q_c, vs_c, tr_c, a_c, eps_c), (q_d, vs_d, tr_d, a_d, eps_d) = out["cpu"], out["dev"]
    # Actions: exact. Rows whose greedy pick ties within Q_TIE are counted;
    # from the same table a tie can break apart only if argmax stops taking
    # the first maximum, so a differing action fails there too.
    top2 = q[ts.vec_state.obs.long()].topk(2, dim=-1).values
    tied = (top2[:, 0] - top2[:, 1]) <= Q_TIE
    differ = a_d.cpu() != a_c
    if bool(differ.any()):
        raise AssertionError(f"{name}: {int(differ.sum())} actions differ, "
                             f"{int((differ & tied).sum())} of them at a tie")
    for f in ("obs", "ep_return", "ep_length"):
        if not torch.equal(getattr(vs_d, f).cpu(), getattr(vs_c, f)):
            raise AssertionError(f"{name}: the env batch's {f} differs")
    index = (ts.vec_state.obs.long(), a_c.long())
    cnt = {k: torch.zeros_like(_to(q, d)).index_put_(tuple(_to(i, d) for i in index),
                                                     torch.ones(num, device=d), accumulate=True)
           for k, d in (("cpu", torch.device("cpu")), ("dev", device))}
    if not torch.equal(cnt["dev"].cpu(), cnt["cpu"]):
        raise AssertionError(f"{name}: the scatter's counts differ")
    err = (q_d.cpu().double() - q_c.double()).abs()
    bound = Q_RTOL * q_c.double().abs() + Q_RTOL * float(q_c.abs().max())
    result = {"workload": name, "envs": num, "epsilon": [eps_c, eps_d],
              "greedy_ties": int(tied.sum()), "actions_differ": int(differ.sum()),
              "pairs_updated": int((cnt["cpu"] > 0).sum()), "max_count": int(cnt["cpu"].max()),
              "q_max_abs_err": float(err.max()),
              "q_max_rel_err": float((err / q_c.double().abs().clamp(min=1e-30)).max())}
    if eps_c != eps_d or not bool((err <= bound).all()):
        raise AssertionError(f"{name}: the Q-table or ε differs: {result}")
    return result


def phase_tabular_steps(device: torch.device, num: int = CLASSIC_ENVS) -> list[dict]:
    """The Q-learning vector step card vs CPU, at the CLI width and at ``num``
    envs; ``torch.argmax`` picks the first maximum on the card too."""
    zero = torch.argmax(torch.zeros(num, 4, device=device), dim=-1)
    ties = torch.randint(0, 3, (num, 4), generator=torch.Generator().manual_seed(2)).float()
    first_max = bool((zero == 0).all()) and torch.equal(
        torch.argmax(ties.to(device), dim=-1).cpu(), torch.argmax(ties, dim=-1))
    if not first_max:
        raise AssertionError("torch.argmax does not pick the first maximum on the card")
    from gymrl_tpu_torch.run import cli

    results = []
    for name in TABULAR:
        for b in (cli.WORKLOADS[name]("cpu")[0].cfg.num_envs, num):
            r = _qlearning_step_case(name, device, b)
            r["argmax_first_max"] = first_max
            log("phase 14 q-learning step: " + json.dumps(r))
            results.append(r)
    return results


def phase_tabular_workloads(device: torch.device, names=TABULAR,
                            timed_iters: int = WORKLOAD_TIMED_ITERS, episodes: int = 5) -> list[dict]:
    """The tabular CLI workloads as in phase 6 (warm-up, timed iterations
    with act / env / update CUDA-event times, test, restore), then the
    MountainCar baseline through its CLI entry and its 10-episode eval."""
    from gymrl_tpu_torch.algos.tabular import MountainCarBaseline
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cuda = device.type == "cuda"
    results = []
    for name in names:
        trainer, algo, solve = cli.WORKLOADS[name](str(device))
        cfg = trainer.cfg
        per_iter = cfg.steps_per_iter * cfg.num_envs
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
            finally:
                os.chdir(cwd)
            t0 = time.perf_counter()
            ts, _ = loop.train(per_iter, solve_threshold=solve)
            if cuda:
                torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            clock = PhaseClock(device)
            walls, phases = [], []
            for _ in range(timed_iters):
                t0 = time.perf_counter()
                clock.start()
                ts, out = trainer.train_iter(ts, timer=clock.mark)
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(clock.phase_ms())
            t0 = time.perf_counter()
            mean_reward = loop.test(ts, episodes=episodes)
            test_s = time.perf_counter() - t0
            restored = restore_checkpoint(save_checkpoint(loop.ckpt_path, ts), trainer.init(1))
        iters = timed_iters + 1
        metrics = {k: float(v) for k, v in out.metrics.items()}
        result = {
            "workload": name, "env_steps": ts.env_steps, "warmup_iter_s": warm_s,
            "env_steps_per_s": timed_iters * per_iter / sum(walls),
            "iter_wall_ms": [w * 1e3 for w in walls],
            "phase_ms": {p: [ph[p] for ph in phases] for p in phases[0]},
            "metrics": metrics, "test_episodes": episodes, "test_mean_reward": mean_reward,
            "test_s": test_s,
        }
        if ts.env_steps != iters * per_iter or ts.sample_count != iters * per_iter:
            raise AssertionError(f"{name}: {ts.env_steps} env steps, {ts.sample_count} samples")
        if not all(math.isfinite(v) for v in metrics.values()) or not math.isfinite(mean_reward):
            raise AssertionError(f"{name}: non-finite metrics {metrics} / test {mean_reward}")
        if ts.q_table.device.type != device.type or not bool(ts.q_table.ne(0).any()):
            raise AssertionError(f"{name}: the Q-table left the card or did not move")
        if not (torch.equal(restored.q_table, ts.q_table)
                and restored.sample_count == ts.sample_count):
            raise AssertionError(f"{name}: the restored state differs from the trained one")
        result["checkpoint_restored"] = True
        log("phase 14 tabular workload: " + json.dumps(result))
        results.append(result)

    if cli.main(["mountaincar_baseline", "--device", str(device)]) != 0:
        raise AssertionError("mountaincar_baseline did not return 0")
    agent = MountainCarBaseline(device=device)
    t0 = time.perf_counter()
    returns, lengths = agent.eval_episodes(agent.init(0), Noise(device, 1), 10)
    result = {"workload": "mountaincar_baseline", "episodes": 10,
              "mean_return": float(returns.mean()), "std_return": float(returns.std(correction=0)),
              "lengths": lengths.tolist(), "eval_s": time.perf_counter() - t0}
    log("phase 14 tabular workload: " + json.dumps(result))
    if not (result["mean_return"] > -200.0 and max(result["lengths"]) < 200):
        raise AssertionError(f"the rule policy did not reach the flag: {result}")
    results.append(result)
    return results


# -- phase 15: pixels and rendering ------------------------------------------------------------
PIXEL_ENVS = 4096
PIXEL_WARM_STEPS = 25
FRAME_ATOL = 1e-5  # pixel coordinates near 48 carry float32 ulps of 3.8e-6


def phase_pixels(device: torch.device, num: int = PIXEL_ENVS) -> dict:
    """CartPolePixels card vs CPU, the conv trunk card vs CPU, the TF32 flags."""
    from gymrl_tpu_torch.envs.pixels import CartPolePixels
    from gymrl_tpu_torch.nn.layers import ConvEncoder

    env_result = compare_env_step(CartPolePixels(), device, num, PIXEL_WARM_STEPS, FRAME_ATOL)
    log("phase 15 pixel env: " + json.dumps(env_result))
    gen = torch.Generator().manual_seed(4)
    net = ConvEncoder((48, 48, 4), 256, generator=gen)
    x = torch.rand((32, 48, 48, 4), generator=gen)
    with torch.no_grad():
        want = net(x)
        got = copy.deepcopy(net).to(device)(x.to(device)).cpu()
    flags = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    result = {"env": env_result, "conv_encoder_max_abs_err": _max_err(got, want),
              "conv_encoder_max_out": float(want.abs().max()), "tf32": flags}
    log("phase 15 conv trunk: " + json.dumps({k: v for k, v in result.items() if k != "env"}))
    if any(flags.values()) and device.type == "cuda":
        raise AssertionError(f"TF32 is on: {flags}")
    if not result["conv_encoder_max_abs_err"] <= SEQ_ATOL:
        raise AssertionError(f"the conv trunk differs on the card: {result}")
    return result


def phase_render(device: torch.device, max_frames: int = 60) -> list[dict]:
    """``render_episode``'s rollout (``episode_frames``) from card states for
    the lander and FrozenLake; no GIF is written."""
    import numpy as np

    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop

    results = []
    for name, shape in (("ppo_lunarlander", (400, 600, 3)), ("qlearning_frozenlake", (192, 192, 3))):
        trainer, algo, _ = cli.WORKLOADS[name](str(device))
        t0 = time.perf_counter()
        frames = TrainLoop(trainer, algo, log_metrics=False).episode_frames(
            trainer.init(0), max_frames=max_frames)
        result = {"workload": name, "frames": len(frames), "shape": list(frames[0].shape),
                  "dtype": str(frames[0].dtype), "s": time.perf_counter() - t0}
        log("phase 15 render: " + json.dumps(result))
        if not (len(frames) >= 2 and all(f.shape == shape and f.dtype == np.uint8 for f in frames)):
            raise AssertionError(f"{name}: frames {result}")
        results.append(result)
    return results


# -- phase 16: the distributed layer ---------------------------------------------
# (case, n_data, n_model): the bench config on two data ranks; ppo_lunarlander's
# preset with its trunk split over two model ranks; three presets on two data
# ranks. All of them in one world of two processes sharing the card.
DIST_CASES = (("bench", 2, 1), ("ppo_lunarlander", 1, 2), ("rainbow_dqn_cartpole", 2, 1),
              ("sac_pendulum", 2, 1), ("ppo_lstm_lunarlander", 2, 1))
DIST_TIMEOUT_S = 600.0


def _dist_trainer(name: str, device, mesh=None, first_update: bool = False):
    """Phase 16's case ``name``: the bench config or a CLI workload's preset.
    ``first_update`` cuts an off-policy preset's iteration to end with its
    first env step that updates (all widths and the cadence unchanged)."""
    import dataclasses

    if name == "bench":
        from gymrl_tpu_torch.algos.ppo import PPOTrainer
        return PPOTrainer(bench_config(), device=device, mesh=mesh)
    from gymrl_tpu_torch.run import cli
    proto = cli.WORKLOADS[name]("cpu")[0]
    cfg = proto.cfg
    if first_update and hasattr(cfg, "steps_per_iter"):
        # the replay reaches a batch after ceil(batch / envs) pushes, which
        # start once the n-step window is warm
        pushes = -(-cfg.batch_size // cfg.num_envs)
        cfg = dataclasses.replace(cfg, steps_per_iter=pushes + getattr(cfg, "n_steps", 1) - 1)
    return type(proto)(cfg, device=device, mesh=mesh)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_iter(trainer, ts, barrier=None):
    """One ``train_iter`` and its wall time in s (the card synchronized)."""
    _sync(trainer.device)
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    ts, out = trainer.train_iter(ts)
    _sync(trainer.device)
    return ts, out, time.perf_counter() - t0


def _cpu_flat(ts) -> dict:
    from gymrl_tpu_torch.utils.checkpoint import flat_state, state_tree
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flat_state(state_tree(ts)).items()}


def _nccl_world_of_one(rank: int, world: int, case: str = "bench", device=None) -> dict:
    """Phase 16 (a), rank 0 of a world of one on NCCL: the dry run, then one
    bench-config iteration unsharded and one under ``make_mesh(1, 1)``.
    The unsharded state is also phase 16 (b)'s reference for the case."""
    import torch.distributed as dist
    from gymrl_tpu_torch.distributed.dryrun import dryrun_multichip
    from gymrl_tpu_torch.distributed.mesh import make_mesh

    dry = dryrun_multichip(1, device)
    mesh = make_mesh(1, 1, device)
    plain = _dist_trainer(case, mesh.device)
    a, out_a, wall_a = _timed_iter(plain, plain.init(0))
    ref = _reference(plain, a, out_a, wall_a)
    del plain, a
    meshed = _dist_trainer(case, mesh.device, mesh)
    b, out_b, wall_b = _timed_iter(meshed, meshed.init(0))
    fa, fb = ref["state"], _cpu_flat(b)
    differ = [k for k in fa if not (torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
                                    else fa[k] == fb[k])]
    metrics = {k: (ref["metrics"][k], float(out_b.metrics[k])) for k in ref["metrics"]}
    return {"backend": dist.get_backend(), "world": world, "mesh": dict(mesh.shape),
            "dryrun": dry, "state_entries": len(fa), "differ": differ,
            "metrics_equal": all(x == y for x, y in metrics.values()),
            "ep_equal": torch.equal(ref["ep_return"], out_b.ep_return.cpu())
            and torch.equal(ref["ep_done"], out_b.ep_done.cpu()),
            "wall_s": {"unsharded": wall_a, "mesh_1x1": wall_b}, "reference": ref}


def _reference(trainer, ts, out, wall: float) -> dict:
    """What phase 16 holds a sharded run against: the unsharded state on
    the CPU, metrics, episodes, wall time, the Adam steps taken and the
    largest learning rate of the config."""
    cfg = trainer.cfg
    lr = max(v for k, v in vars(cfg).items() if k.startswith("lr") and type(v) is float)
    state = _cpu_flat(ts)
    steps = max(int(v) for k, v in state.items() if k.endswith(".step"))
    return {"state": state, "metrics": {k: float(v) for k, v in out.metrics.items()},
            "ep_return": out.ep_return.cpu(), "ep_done": out.ep_done.cpu(), "wall_s": wall,
            "lr": lr, "adam_steps": steps, "bf16": bool(getattr(cfg, "sgd_bf16", False))}


def _shared_card_world(rank: int, world: int, workdir: str, cases=DIST_CASES,
                       device=None) -> dict:
    """Phase 16 (b)-(c), one rank of the world: one iteration
    of each case under its mesh, the whole state saved (``save_checkpoint``
    gathers it); under the trunk split, the save restored into a fresh
    state of the same mesh."""
    import torch.distributed as dist
    from gymrl_tpu_torch.distributed.mesh import make_mesh
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    out = {"backend": dist.get_backend(), "world": world, "cases": {}}
    for name, n_data, n_model in cases:
        mesh = make_mesh(n_data, n_model, device)
        trainer = _dist_trainer(name, mesh.device, mesh, first_update=True)
        ts, o, wall = _timed_iter(trainer, trainer.init(0), mesh.barrier)
        path = os.path.join(workdir, f"{name}.pt")
        save_checkpoint(path, ts, mesh)
        case = {"mesh": dict(mesh.shape), "device": str(mesh.device), "wall_s": wall,
                "env_steps": ts.env_steps,
                "metrics": {k: float(v) for k, v in o.metrics.items()},
                "ep_return": o.ep_return.cpu(), "ep_done": o.ep_done.cpu()}
        if rank == 0 and hasattr(ts, "replay"):  # replicated, and not in the checkpoint
            case["replay"] = {k: v for k, v in _cpu_flat(ts).items() if k.startswith("ts.replay")}
        if n_model > 1:  # (c): a checkpoint under the trunk split, restored
            fresh = _dist_trainer(name, mesh.device, mesh)
            restored = restore_checkpoint(path, fresh.init(1), mesh)
            got, want = _cpu_flat(restored), _cpu_flat(ts)
            case["restore_differ"] = [
                k for k in want if not (torch.equal(got[k], want[k])
                                        if isinstance(want[k], torch.Tensor) else got[k] == want[k])]
            case["split_shape"] = list(ts.params.shared_0.weight.shape)
            case["saved_shape"] = list(torch.load(path, map_location="cpu", weights_only=True)
                                       ["params"]["shared_0.weight"].shape)
        out["cases"][name] = case
        mesh.barrier()
    return out


# Phase 16's rules for a sharded iteration against the unsharded one on the card:
#   * exact: the env batch (so every action), the n-step window, the episodes,
#     the noise stream (every draw), obs statistics, reward scaler, counters and
#     the replay's transitions;
#   * every entry of the params (and target nets): |Δ| ≤ DIST_PARAM_ATOL
#     (float32: the shares' means and the all-reduce add in another order, a
#     few ulps per Adam step). The bench config computes its loss in bf16: a
#     rank's bf16 mean over half a minibatch rounds differently from the whole
#     one's at 2^-8 relative, which moves an Adam step by at most 2·lr·2^-8,
#     so its atol is 2·lr·steps·2^-8 (3.0e-4 for 128 steps at lr 3e-4);
#   * the metrics: rtol 1e-5 and atol DIST_PARAM_ATOL (the CPU tests' rule);
#     the bench config's bf16 losses rtol and atol 2^-8 (one bf16 rounding of
#     a mean of O(1) terms: standardized advantages, ratios near 1);
#   * the recurrent hidden: SEQ_ATOL (the cell's rows at B/2 and at B go
#     through different matmul kernels);
#   * the PER sum-tree (priorities from the shares' TD errors): phase 7's
#     rule, rtol PER_TREE_RTOL plus 1e-6 of the largest node;
#   * optimizer moments are printed, not held.
DIST_PARAM_ATOL = 1e-5
DIST_METRIC_RTOL = 1e-5
DIST_EXACT = ("vec_state", "window", "episodes", "target_syncs", "env_steps", "learn_steps",
              "noise", "obs_rms", "reward_scaler", "beta")
DIST_PARAMS = ("params", "nets", "targets", "target_params")


def _dist_check(name: str, got: dict, metrics: dict, ref: dict) -> dict:
    """Phase 16's rules for case ``name``: the saved state ``got`` and the
    metrics against the unsharded ``ref``. Returns, per part of the state
    and per metric, the largest error and its bound; raises, after checking
    everything, on every break."""
    want = ref["state"]
    steps, lr = ref["adam_steps"], ref["lr"]
    atol = 2 * lr * steps * 2.0 ** -8 if ref["bf16"] else DIST_PARAM_ATOL
    report: dict = {}
    breaks: list[str] = []
    for k, w in want.items():
        part = k.split(".")[1].split("[")[0]
        g = got[k]
        if not isinstance(w, torch.Tensor):
            if g != w:
                breaks.append(f"{k} is {g}, unsharded {w}")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            breaks.append(f"{k} {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
            continue
        if not w.is_floating_point() or w.numel() == 0:
            if not torch.equal(g, w):
                breaks.append(f"{k} differs")
            continue
        err = (g.double() - w.double()).abs().max().item()
        rec = report.setdefault(part, {"max_abs_err": 0.0, "bound": None})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if part in DIST_EXACT or (part == "replay" and not k.endswith(("tree", "max_priority"))):
            bound = 0.0
        elif part in DIST_PARAMS:
            bound = atol
        elif part == "hidden":
            bound = SEQ_ATOL
        elif part == "replay":
            bound = (PER_TREE_RTOL + 1e-6) * w.double().abs().max().item()
        else:
            continue  # moments: printed only
        rec["bound"] = max(rec["bound"] or 0.0, bound)
        if err > bound:
            breaks.append(f"{k} off by {err} > {bound}")
    m_tol = 2.0 ** -8 if ref["bf16"] else DIST_METRIC_RTOL
    m_atol = 2.0 ** -8 if ref["bf16"] else DIST_PARAM_ATOL
    report["metrics"] = {"max_abs_err": 0.0, "rtol": m_tol, "atol": m_atol}
    for k, w in ref["metrics"].items():
        err = abs(metrics[k] - w)
        report["metrics"]["max_abs_err"] = max(report["metrics"]["max_abs_err"], err)
        if not err <= m_atol + m_tol * abs(w):
            breaks.append(f"metric {k} is {metrics[k]}, unsharded {w}")
    if breaks:
        raise AssertionError(f"{name}: " + "; ".join(breaks) + f"\n{json.dumps(report)}")
    return report


def phase_distributed(device: torch.device, cases=DIST_CASES, one_case: str = "bench",
                      world: int = 2, backend: str = "gloo") -> dict:
    """Phase 16: the NCCL world of one, then ``world`` ranks (two sharing the
    card over gloo; on a machine with more cards, one per card over NCCL).
    Each case keeps its ``model`` axis and gives ``data`` the other ranks.
    (A CPU rehearsal passes ``device`` cpu: gloo then runs both worlds.)"""
    from gymrl_tpu_torch.distributed.launch import run_world
    from gymrl_tpu_torch.utils.checkpoint import flat_state

    cases = tuple((name, world // n_model, n_model) for name, _, n_model in cases)

    cuda = device.type == "cuda"
    rank_device = None if cuda else "cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        one = run_world("chip_smoke:_nccl_world_of_one", 1,
                        {"case": one_case, "device": rank_device},
                        workdir=os.path.join(tmp, "a"), backend="nccl" if cuda else "gloo",
                        timeout_s=DIST_TIMEOUT_S, extra_path=(root,))[0]
        log("phase 16a world of one: " + json.dumps(
            {k: v for k, v in one.items() if k not in ("dryrun", "reference")}
            | {"dryrun_families": list(one["dryrun"])}))
        if one["differ"] or not one["metrics_equal"] or not one["ep_equal"]:
            raise AssertionError(f"the mesh of one is not the unsharded run: {one['differ']}")
        refs = {one_case: one["reference"]}
        for name, _, _ in cases:  # the unsharded runs, alone on the card
            if name not in refs:
                trainer = _dist_trainer(name, device, first_update=True)
                ts, out, wall = _timed_iter(trainer, trainer.init(0))
                refs[name] = _reference(trainer, ts, out, wall)
                del trainer, ts, out
        two = run_world("chip_smoke:_shared_card_world", world,
                        {"workdir": tmp, "cases": cases, "device": rank_device},
                        workdir=os.path.join(tmp, "b"), backend=backend if cuda else "gloo",
                        timeout_s=DIST_TIMEOUT_S, extra_path=(root,))
        results = {}
        for name, n_data, n_model in cases:
            ref, case = refs[name], two[0]["cases"][name]
            got = flat_state(torch.load(os.path.join(tmp, f"{name}.pt"), map_location="cpu",
                                        weights_only=True)) | case.get("replay", {})
            result = {
                "mesh": case["mesh"], "device": case["device"], "adam_steps": ref["adam_steps"],
                "wall_s": {"unsharded": ref["wall_s"],
                           "sharded": [r["cases"][name]["wall_s"] for r in two]},
                "state": _dist_check(name, got, case["metrics"], ref),
            }
            for key in ("restore_differ", "split_shape", "saved_shape"):
                if key in case:
                    result[key] = case[key]
            log(f"phase 16b {name}: " + json.dumps(result))
            if not (torch.equal(case["ep_return"], ref["ep_return"])
                    and torch.equal(case["ep_done"], ref["ep_done"])):
                raise AssertionError(f"{name}: the sharded episodes differ")
            if not all(r["cases"][name]["metrics"] == case["metrics"] for r in two):
                raise AssertionError(f"{name}: the ranks report different metrics")
            if n_model > 1 and (case["restore_differ"]
                                or case["saved_shape"][0] != n_model * case["split_shape"][0]):
                raise AssertionError(f"{name}: the checkpoint under the split: {case}")
            results[name] = result
    summary = {"nccl": {k: one[k] for k in ("backend", "world", "mesh")},
               "ranks": {"backend": two[0]["backend"], "world": two[0]["world"]}}
    log("phase 16 distributed: " + json.dumps(summary))
    return {"one": one, "two": results}


# -- phase 17: profile ------------------------------------------------------------
PROFILE_CASES = ("bench", "ppo_lunarlander")
SPAN_CASE = "ppo_lunarlander"  # the benchmark's cell: gymRL's preset, 32 envs x T 64
SPAN_SETUP_ITERS = 3  # the eager warm-up, the captures and their replays, a replay
SPAN_WINDOW_ITERS = 30
SPAN_PROFILED_ITERS = 3
# The hand-written kernels by their names in a trace, with their keys in kernels.LAUNCHES.
HAND_WRITTEN = {"lander_step": "lunarlander_step", "lander_reset": "lunarlander_reset",
                "ppo_loss_fwd": "ppo_loss_fwd", "ppo_loss_bwd": "ppo_loss_bwd",
                "grad_sq_norms": "grad_sq_norms", "clip_adam": "clip_adam"}
# The span each must be in, on the graph path (``env.step`` where the rollout is eager).
SPAN_OF_KERNEL = {"lander_step": "rollout.replay", "clip_adam": "sgd"}
SPAN_LSTM_CASE = "ppo_lstm_lunarlander"  # its rollout and sweep replayed (mHC, GRU, RND)
SPAN_LSTM_WINDOW_ITERS = 5
SPAN_MIN_SHARE = 0.99  # of the traced kernels put down to a span
# The spans whose kernels, device time and launch calls an iteration phase 17 reports.
SPAN_READ = ("mhc", "mhc.sinkhorn", "rnd", "rnn.unroll", "policy", "env.step", "rollout", "gae",
             "sgd")


def phase_profile(device: torch.device, cases=PROFILE_CASES) -> list[dict]:
    """Phase 17 (a): one ``train_iter`` per case under ``trace`` (kernel
    launches, kernel time, busy share of the iteration), then an untraced
    one, whose wall time the busy share is also read against."""
    from gymrl_tpu_torch.utils.profiling import kernel_stats, trace

    results = []
    for name in cases:
        trainer = _dist_trainer(name, device)
        ts, _, _ = _timed_iter(trainer, trainer.init(0))  # warm-up
        ts, _, _ = _timed_iter(trainer, ts)  # the sweep's capture, so the trace holds a replay
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with trace(tmp, device) as prof:
                ts, _, traced = _timed_iter(trainer, ts)
            export_s = time.perf_counter() - t0 - traced
            trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
        t0 = time.perf_counter()
        stats = kernel_stats(prof)
        stats_s = time.perf_counter() - t0
        del prof
        ts, _, untraced = _timed_iter(trainer, ts)
        result = {"case": name, "env_steps_per_iter": trainer.cfg.batch_total,
                  "launches_per_iter": stats["kernels"], "kernel_ms": stats["kernel_ms"],
                  "busy_ms": stats["busy_ms"], "traced_wall_ms": traced * 1e3,
                  "busy_share_traced": stats["busy_ms"] / (traced * 1e3),
                  "untraced_wall_ms": untraced * 1e3,
                  "busy_share_untraced": stats["busy_ms"] / (untraced * 1e3),
                  "trace_bytes": trace_bytes, "stop_and_export_s": export_s,
                  "kernel_stats_s": stats_s}
        result["graphs"] = _graph_counts(f"phase 17 {name}", trainer, 4)
        log("phase 17 profile: " + json.dumps(result))
        if stats["kernels"] == 0 or trace_bytes == 0:
            raise AssertionError(f"{name}: the trace holds no kernel")
        results.append(result)
        del trainer, ts
    return results


def _fetch_iter(trainer, ts):
    """One ``train_iter`` and the host fetch of its episode statistics, as
    ``TrainLoop.train`` makes after every iteration."""
    ts, out = trainer.train_iter(ts)
    out.ep_done.cpu(), out.ep_return.cpu()
    return ts


def _mean_us(totals: dict, name: str) -> float | None:
    """Mean host time of a span in µs (None: no such span)."""
    n, total = totals.get(name, (0, 0.0))
    return total / n * 1e6 if n else None


def _span_totals(spans) -> dict:
    """Count and total seconds of the closed spans by name (and note)."""
    out: dict = {}
    for s in spans:
        key = f"{s.name} [{s.note}]" if s.note else s.name
        n, total = out.get(key, (0, 0.0))
        out[key] = (n + 1, total + (s.end_ns - s.start_ns) / 1e9)
    return out


def phase_spans(device: torch.device, case: str = SPAN_CASE, window: int = SPAN_WINDOW_ITERS,
                profiled: int = SPAN_PROFILED_ITERS) -> dict:
    """Phase 17 (b): the program's spans (``utils.profiling.span``) on the
    benchmark's cell. Tracing on, a fresh trainer's set-up (``init`` and the
    iterations that warm up and capture the sweep): each span's count and
    seconds. Then ``window`` iterations, each with its host fetch: the mean
    host time of a ``rollout.replay`` span (and of a ``policy`` and an
    ``env.step`` span, None under a replay, which opens neither), and no
    ``rollout.capture``, ``sgd.capture`` or compiling ``kernels.load``
    among them. Then
    ``profiled`` iterations under ``torch.profiler``, read by ``span_trace``:
    the kernels put down to spans, to no span, and with no launch call in
    the trace (these three must sum to the kernels traced; those with no
    launch call must be, if any, exactly the hand-written kernels the
    program counted, ``kernels.LAUNCHES``); every ``lander_step`` inside a
    ``rollout.replay`` span and every ``clip_adam`` inside an ``sgd`` span
    unless their launch calls are missing; the host launch calls inside
    ``rollout`` spans per env step; the kernels inside ``rollout.replay``
    spans per iteration and inside ``sgd`` spans per grad step; the idle
    share of the device inside ``rollout`` spans, over the profiled wall
    time; and the idle time by innermost span, the longest ten."""
    from collections import Counter

    from gymrl_tpu_torch import kernels
    from gymrl_tpu_torch.utils import profiling

    profiling.clear()
    profiling.enable()
    try:
        trainer = _dist_trainer(case, device)
        ts = trainer.init(0)
        for _ in range(SPAN_SETUP_ITERS):
            ts = _fetch_iter(trainer, ts)
        _sync(device)
        setup = _span_totals(s for s in profiling.spans() if s.iteration == -1
                             or s.name.startswith(("rollout.", "sgd.", "kernels.")))
        log(f"phase 17 spans {case} set-up: " + json.dumps(setup))

        profiling.clear()
        for _ in range(window):
            ts = _fetch_iter(trainer, ts)
        _sync(device)
        spans = profiling.spans()
        totals = _span_totals(spans)
        rebuilt = [f"{s.name} [{s.note}]" for s in spans
                   if s.name in ("rollout.capture", "sgd.capture") or "compiled" in s.note]

        profiling.clear()
        before = dict(kernels.LAUNCHES)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        for _ in range(profiled):
            ts = _fetch_iter(trainer, ts)
        _sync(device)
        prof.stop()
        launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
        got = profiling.span_trace(prof)
        calls = Counter(name for name, _, _ in got.launches)
        del prof
    finally:
        profiling.disable()
        profiling.clear()

    cfg = trainer.cfg
    replayed = getattr(trainer, "rollout_graph", None) is not None
    span_of_kernel = {**SPAN_OF_KERNEL,
                      "lander_step": "rollout.replay" if replayed else "env.step"}
    ends = [b for _, _, b, _ in got.spans] + [b for _, _, b, _ in got.kernels]
    t0, t1 = min(a for _, a, _, _ in got.spans), max(ends)
    by_span = got.kernels_by_span()
    lost = Counter(n for n, _, _, p in got.kernels if p is None)
    own = {k: sum(n for name, n in lost.items() if k in name) for k in HAND_WRITTEN}
    inside = {k: sum(k in n and p is not None and where in p for n, _, _, p in got.kernels)
              for k, where in span_of_kernel.items()}
    under = {name: {"kernels": sum(p is not None and name in p for *_, p in got.kernels)
                    / profiled,
                    "device_ms": sum(b - a for _, a, b, p in got.kernels
                                     if p is not None and name in p) / 1e6 / profiled,
                    "launch_calls": sum(name in p for *_, p in got.launches) / profiled}
             for name in SPAN_READ}
    result = {
        "case": case,
        "rollout_replay_us": _mean_us(totals, "rollout.replay"),
        "sgd_replay_us": _mean_us(totals, "sgd.replay"),
        "policy_us": _mean_us(totals, "policy"), "env_step_us": _mean_us(totals, "env.step"),
        "window_spans": totals, "rebuilt_in_window": rebuilt,
        "kernels_traced": len(got.kernels),
        "kernels_in_spans": sum(n for p, n in by_span.items() if p),
        "kernels_outside_spans": by_span.get((), 0),
        "kernels_without_launch_call": sum(lost.values()),
        "kernels_without_launch_call_by_name": dict(lost.most_common(10)),
        "kernels_by_span": {str(p): n for p, n in by_span.most_common()},
        "per_iteration_under": under,
        "launch_calls": dict(calls),
        "launched_by_counter": launched, "inside_their_span": inside,
        "rollout_launches_per_step": sum("rollout" in p for *_, p in got.launches)
        / (profiled * cfg.rollout_steps),
        "kernels_per_rollout_replay": sum(p is not None and "rollout.replay" in p
                                          for *_, p in got.kernels) / profiled,
        "sgd_kernels_per_grad_step": sum(p is not None and "sgd" in p for *_, p in got.kernels)
        / (profiled * cfg.num_epochs * cfg.num_minibatches),
        "kernels_per_sgd_replay": sum(p is not None and "sgd.replay" in p
                                      for *_, p in got.kernels) / profiled,
        "idle_in_rollout": got.idle_ns(t0, t1, inside="rollout") / (t1 - t0),
        "idle_share": got.idle_ns(t0, t1) / (t1 - t0),
        "idle_by_span_s": [[n, ns / 1e9] for n, ns in got.idle_by_span(t0, t1).most_common(10)],
        "profiled_wall_s": (t1 - t0) / 1e9,
    }
    log(f"phase 17 spans {case}: " + json.dumps(result))
    if rebuilt:
        raise AssertionError(f"{case}: built again in the window: {rebuilt}")
    if (result["kernels_in_spans"] + result["kernels_outside_spans"]
            + result["kernels_without_launch_call"] != result["kernels_traced"]):
        raise AssertionError(f"{case}: the kernels put down do not sum to those traced")
    if result["kernels_in_spans"] < SPAN_MIN_SHARE * result["kernels_traced"]:
        raise AssertionError(f"{case}: {result['kernels_in_spans']} of "
                             f"{result['kernels_traced']} kernels put down to a span")
    if sum(own.values()) != result["kernels_without_launch_call"]:
        raise AssertionError(f"{case}: kernels with no launch call in the trace that the "
                             f"program did not write: {dict(lost)}")
    for k, where in span_of_kernel.items():
        want = launched[HAND_WRITTEN[k]]
        if inside[k] + own[k] != want or own[k] not in (0, want):
            raise AssertionError(f"{case}: {want} {k} launched, {inside[k]} inside {where} "
                                 f"spans, {own[k]} with no launch call in the trace")
    del trainer, ts
    return result


# -- phase 18: the lander kernels against the plain path on the card ---------------
KERNEL_STEPS = 200
KERNEL_ATOL = 1e-6
KERNEL_TIMED_CALLS = 100
KERNEL_LATENCY_ENVS = 1  # one env: the lander kernels' time is its chain's latency
TRACE_TRIES = 5  # traces taken until one holds exactly one kernel a call
VECENV_STEP_MAX_LAUNCHES = 60
# Float32 operations per env, counted in lunarlander.cu (discrete, no wind; each add,
# multiply, compare, select, division, square root and sin/cos/tanh as one): the
# 10-sweep x 4-point contact solve is 1,960 of the step's; wind adds ~30 to each.
STEP_OPS_PER_ENV = 2580
RESET_OPS_PER_ENV = 95
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def _step_pairs(k, p) -> list:
    pairs = [(f, getattr(k.state, f), getattr(p.state, f)) for f in k.state._fields]
    return pairs + [("obs", k.obs, p.obs), ("reward", k.reward, p.reward),
                    ("terminated", k.terminated, p.terminated),
                    ("truncated", k.truncated, p.truncated)]


def _merge_diff(acc: dict, r: dict) -> None:
    for key in ("max_abs_err", "flags_differ"):
        for f, v in r[key].items():
            acc[key][f] = max(acc[key].get(f, v), v)
    acc["max_abs_err_outside_ties"] = max(acc["max_abs_err_outside_ties"],
                                          r["max_abs_err_outside_ties"])
    acc["max_ties"] = max(acc["max_ties"], r["ties"])


def _per_call_ms(device: torch.device, fn, calls: int = KERNEL_TIMED_CALLS) -> float:
    """Milliseconds per call over ``calls`` back-to-back calls after a warm-up:
    CUDA events on the card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _traced_kernels(device: torch.device, fn, calls: int) -> tuple[float, float]:
    """(CUDA kernels the trace holds per call, their device ms per kernel)."""
    from gymrl_tpu_torch.utils.profiling import kernel_stats, trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device) as prof:
            for _ in range(calls):
                fn()
    stats = kernel_stats(prof)
    return stats["kernels"] / calls, stats["kernel_ms"] / max(stats["kernels"], 1)


def _clean_trace(device: torch.device, fn, calls: int, what: str,
                 launches_per_call: int = 1) -> tuple[float, float | None]:
    """``_traced_kernels`` of a call of ``launches_per_call`` kernels, taken
    again until the trace holds exactly that many a call: a trace that
    drops events reads a device time that no kernel took, so it is refused.
    After ``TRACE_TRIES`` refused traces the device time is None (not
    measured)."""
    seen = []
    for _ in range(TRACE_TRIES):
        launches, per_kernel = _traced_kernels(device, fn, calls)
        if launches == launches_per_call:
            return launches, per_kernel
        seen.append(launches)
    log(f"{what}: no clean trace in {TRACE_TRIES} (kernels a call {seen}): device time not "
        f"measured")
    return seen[-1], None


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def kernel_envs() -> tuple[int, ...]:
    """The lander batches the main path gives the kernels: the bench config
    (phase 2) and the five lander CLI workloads (phases 3, 11 and 13)."""
    from gymrl_tpu_torch.algos.ppg import ppg_rnn_lunarlander_config
    from gymrl_tpu_torch.algos.ppo import PPOConfig
    from gymrl_tpu_torch.algos.ppo_full import PPOFullConfig
    from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig
    from gymrl_tpu_torch.algos.ppo_rnn import ppo_rnn_lunarlander_config

    cfgs = (bench_config(), PPOConfig(), ppo_rnn_lunarlander_config(),
            ppg_rnn_lunarlander_config(), PPOFullConfig(), PPOLSTMConfig())
    return tuple(sorted({c.num_envs for c in cfgs}))


def _offset_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element into a buffer of its own: off
    the 16 bytes (and, for 4-byte elements, the 8) its allocation lies on."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def _check_kernels(device: torch.device, envs, steps: int = KERNEL_STEPS) -> dict:
    """Phase 18 (a)-(b): each kernel against its plain version on ``device``,
    from the same inputs, at each batch of ``envs``."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.rollout import VecEnv
    from gymrl_tpu_torch.kernels.lunarlander import lander_reset, lander_step

    out = {"reset": [], "step": []}
    # (a) the reset, wind off and on
    for num in envs:
        for wind in (False, True):
            env = LunarLander(enable_wind=wind)
            params = env.default_params()
            draws = env.reset_draws(Noise(device, 3), num)
            (ks, ko), (ps, po) = lander_reset(params, draws), env.reset_from_plain(params, draws)
            pairs = [(f, getattr(ks, f), getattr(ps, f)) for f in ks._fields] + [("obs", ko, po)]
            r = _field_diff(pairs, num, KERNEL_ATOL, label=f"reset {num} wind={wind}")
            r.update(envs=num, wind=wind)
            log("phase 18 reset: " + json.dumps(r))
            out["reset"].append(r)
    # the same from draws that lie off 16 and 8 bytes (each a view one element into its
    # buffer), at a batch whose last block is ragged: the kernel's edge floats and single loads
    num = envs[-1] - 5
    for wind in (False, True):
        env = LunarLander(enable_wind=wind)
        params = env.default_params()
        draws = type(draws)(*map(_offset_copy, env.reset_draws(Noise(device, 4), num)))
        (ks, ko), (ps, po) = lander_reset(params, draws), env.reset_from_plain(params, draws)
        pairs = [(f, getattr(ks, f), getattr(ps, f)) for f in ks._fields] + [("obs", ko, po)]
        r = _field_diff(pairs, num, KERNEL_ATOL, label=f"reset {num} wind={wind} offset draws")
        r.update(envs=num, wind=wind, draws_offset_bytes=[x.data_ptr() % 16 for x in draws])
        log("phase 18 reset: " + json.dumps(r))
        out["reset"].append(r)

    # (b) the step, from every state of a random-action rollout on the kernels
    for num in envs:
        for continuous, wind in ((False, False), (False, True), (True, False), (True, True)):
            env = LunarLander(continuous=continuous, enable_wind=wind)
            params = env.default_params()
            venv = VecEnv(env, params, num)
            noise = Noise(device, 0)
            gen = torch.Generator().manual_seed(1)
            vs = venv.reset(noise)
            acc = {"max_abs_err": {}, "flags_differ": {}, "max_abs_err_outside_ties": 0.0,
                   "max_ties": 0}
            in_contact, terminated, truncated = [], 0, 0
            for i in range(steps):
                a = _random_actions(env, num, gen).to(device)
                disp = env.step_draws(noise, num)
                k = lander_step(params, vs.env_state, a, disp, continuous=continuous)
                p = env.step_from_plain(params, vs.env_state, a, disp)
                _merge_diff(acc, _field_diff(_step_pairs(k, p), num, KERNEL_ATOL,
                                             label=f"step {i} of {num} continuous={continuous}"))
                in_contact.append(int(p.state.leg_contact.any(dim=1).sum()))
                terminated += int(p.terminated.sum())
                truncated += int(p.truncated.sum())
                vs, _ = venv.step(vs, a, noise)
            acc.update(envs=num, continuous=continuous, wind=wind, steps=steps,
                       in_contact_max=max(in_contact), in_contact_last=in_contact[-1],
                       terminated=terminated, truncated=truncated)
            log("phase 18 step: " + json.dumps(acc))
            out["step"].append(acc)
    return out


def phase_kernels(device: torch.device, envs=None, steps: int = KERNEL_STEPS,
                  timed_calls: int = KERNEL_TIMED_CALLS) -> dict:
    """Phase 18: ``lander_reset`` / ``lander_step`` against ``reset_from_plain``
    / ``step_from_plain`` on the same device and inputs; their times; the
    launches of one lander ``VecEnv.step``; no fallback when nvcc fails."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.rollout import VecEnv
    from gymrl_tpu_torch.kernels.lunarlander import lander_reset, lander_step

    envs = envs or kernel_envs()
    out = {**_check_kernels(device, envs, steps), "time": [], "vecenv_step": None,
           "no_fallback": None}
    # (c) times: per call (CUDA events), and the device's kernel time per call (trace); the
    # step on a fresh reset's states (every lander in the air) and on those a random-action
    # rollout reaches (some on the ground, as on the main path: the solve's work differs)
    for num in (KERNEL_LATENCY_ENVS, *envs):
        env = LunarLander()
        params = env.default_params()
        noise = Noise(device, 5)
        draws = env.reset_draws(noise, num)
        state, _ = lander_reset(params, draws)
        venv = VecEnv(env, params, num)
        vs = venv.reset(noise)
        gen = torch.Generator().manual_seed(2)
        for _ in range(PHYS_WARM_STEPS):
            vs, _ = venv.step(vs, _random_actions(env, num, gen).to(device), noise)
        states = {"reset": state, "rollout": vs.env_state}
        a = torch.randint(0, 4, (num,), dtype=torch.int32, device=device)
        disp = env.step_draws(noise, num)
        k = lander_step(params, state, a, disp)
        # without wind the step reads no wind index and no leg contact, and passes
        # the wind indices through; terrain is read and passed through
        unread = () if params.enable_wind else ("wind_idx", "torque_idx", "leg_contact")
        passed = ("terrain",) + (() if params.enable_wind else ("wind_idx", "torque_idx"))
        step_bytes = _nbytes(*(x for f, x in zip(state._fields, state) if f not in unread),
                             a, disp,
                             *(x for f, x in zip(k.state._fields, k.state) if f not in passed),
                             k.obs, k.reward, k.terminated, k.truncated)
        ks, ko = lander_reset(params, draws)
        reset_bytes = _nbytes(*draws, *ks, ko)
        cases = [("lunarlander_step", label, lambda s=s: lander_step(params, s, a, disp),
                  lambda s=s: env.step_from_plain(params, s, a, disp), step_bytes,
                  STEP_OPS_PER_ENV * num, float(s.leg_contact.any(dim=1).float().mean()))
                 for label, s in states.items()]
        cases.append(("lunarlander_reset", "draws", lambda: lander_reset(params, draws),
                      lambda: env.reset_from_plain(params, draws), reset_bytes,
                      RESET_OPS_PER_ENV * num, 0.0))
        for name, label, kernel, plain, nbytes, ops, touching in cases:
            bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
            r = {"kernel": name, "envs": num, "state": label, "touching": touching,
                 "ms": _per_call_ms(device, kernel, timed_calls),
                 "plain_ms": _per_call_ms(device, plain, timed_calls),
                 "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            if device.type == "cuda":  # the device's own time, from traces
                launches, per_kernel = _clean_trace(device, kernel, timed_calls, name)
                plain_launches, plain_per_kernel = _traced_kernels(device, plain, 5)
                r.update(device_ms=per_kernel, traced_launches_per_call=launches,
                         plain_device_ms=plain_per_kernel * plain_launches,
                         plain_launches_per_call=plain_launches)
            log("phase 18 time: " + json.dumps(r))
            out["time"].append(r)

    # (d) CUDA launches of one lander VecEnv.step at the bench config's batch
    if device.type == "cuda":
        from gymrl_tpu_torch.utils.profiling import kernel_stats, trace

        num = envs[-1]
        env = LunarLander()
        venv = VecEnv(env, env.default_params(), num)
        noise = Noise(device, 7)
        vs = venv.reset(noise)
        a = torch.randint(0, 4, (num,), dtype=torch.int32, device=device)
        vs, _ = venv.step(vs, a, noise)  # warm-up
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp, device) as prof:
                vs, _ = venv.step(vs, a, noise)
        launches = kernel_stats(prof)["kernels"]
        out["vecenv_step"] = {"envs": num, "launches": launches}
        log("phase 18 VecEnv.step: " + json.dumps(out["vecenv_step"]))
        if launches > VECENV_STEP_MAX_LAUNCHES:
            raise AssertionError(f"one lander VecEnv.step launched {launches} kernels")
        out["no_fallback"] = _no_fallback(device)
        log("phase 18 compiler failing: " + json.dumps(out["no_fallback"]))
        out["trig"] = _trig_check(device)
    return out


def _trig_check(device: torch.device) -> dict:
    """Phase 18 (f): the kernels' own sin and cos (``lib_sincosf``, which
    keep Payne-Hanek's words in registers) against the CUDA math library's
    ``sinf`` and ``cosf`` on all 2^32 float32 inputs: not one may differ."""
    from gymrl_tpu_torch.kernels.lunarlander import trig_mismatches

    t0 = time.perf_counter()
    sin_bad, cos_bad = trig_mismatches(device)
    r = {"inputs": 2 ** 32, "sin_differ": sin_bad, "cos_differ": cos_bad,
         "s": time.perf_counter() - t0}
    log("phase 18 sin and cos against the library: " + json.dumps(r))
    if sin_bad or cos_bad:
        raise AssertionError(f"the kernels' sin / cos differ from sinf / cosf: {r}")
    return r


def _no_fallback(device: torch.device) -> dict:
    """Phase 18 (e): with nvcc missing, and with an nvcc that refuses the
    source, a lander step on the card raises ``KernelCompileError`` and
    launches nothing: there is no plain fallback."""
    from gymrl_tpu_torch import kernels
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.kernels import build
    from gymrl_tpu_torch.kernels import lunarlander as kl

    env = LunarLander()
    params = env.default_params()
    noise = Noise(device, 9)
    state, _ = env.reset_from(params, env.reset_draws(noise, 64))
    action = torch.zeros(64, dtype=torch.int32, device=device)
    disp = env.step_draws(noise, 64)
    env_saved = {k: os.environ.get(k) for k in ("PATH", "CUDA_HOME")}
    saved = (build.BUILD_DIR, dict(build._LOADED), kl._LIB)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fake = os.path.join(tmp, "refusing", "bin", "nvcc")
        os.makedirs(os.path.dirname(fake))
        with open(fake, "w") as f:
            f.write('#!/bin/sh\n[ "$1" = --version ] && { echo fake; exit 0; }\n'
                    'echo "error: refused" >&2\nexit 1\n')
        os.chmod(fake, 0o755)
        try:
            os.environ["PATH"] = ""
            build.BUILD_DIR = os.path.join(tmp, "_build")
            for case in ("missing", "refusing"):
                os.environ["CUDA_HOME"] = os.path.join(tmp, case)
                build._LOADED.clear()
                kl._LIB = None
                launches = dict(kernels.LAUNCHES)
                try:
                    env.step_from(params, state, action, disp)
                except build.KernelCompileError as e:
                    out[case] = str(e).strip().splitlines()[-1][:160]
                else:
                    raise AssertionError(f"nvcc {case}: the lander step returned a result")
                if kernels.LAUNCHES != launches:
                    raise AssertionError(f"nvcc {case}: a kernel launched")
        finally:
            for k, v in env_saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            build.BUILD_DIR, loaded, kl._LIB = saved
            build._LOADED.clear()
            build._LOADED.update(loaded)
    return out


def phase_kernels_each_card(steps: int = KERNEL_STEPS) -> list[dict]:
    """Phase 18 (a)-(b) and phase 19 (a)-(b) on every card but the first,
    at the main path's smallest batch for the lander kernels and at both of
    phase 19's shapes for the update kernels, with PyTorch's current device
    left on the first: each launch must reach the card that holds its
    tensors. For a machine with more than one card; ``main`` needs one."""
    from gymrl_tpu_torch import kernels

    results = []
    for index in range(1, torch.cuda.device_count()):
        device = torch.device("cuda", index)
        kernels.reset_launches()
        r = _check_kernels(device, kernel_envs()[:1], steps)
        r["update"] = _update_checks(device)
        r.update(device=str(device), current_device=torch.cuda.current_device(),
                 launches=dict(kernels.LAUNCHES))
        if not all(r["launches"].values()):
            raise AssertionError(f"{device}: a kernel did not launch: {r['launches']}")
        if r["current_device"] != 0:
            raise AssertionError(f"{device}: the current device moved to {r['current_device']}")
        log("phases 18-19 on another card: " + json.dumps(
            {k: r[k] for k in ("device", "current_device", "launches")}))
        results.append(r)
    if not results:
        raise AssertionError("one card: phase_kernels_each_card needs more")
    return results


LANDER_KERNELS = ("lunarlander_step", "lunarlander_reset")
UPDATE_KERNELS = ("ppo_loss_fwd", "ppo_loss_bwd", "grad_sq_norms", "clip_adam")


def _on_kernels(label: str, fn, *args, names=LANDER_KERNELS, **kw):
    """Runs a phase that drives lander workloads, the launch counts set to 0
    just before it; fails unless each kernel of ``names`` ran in it."""
    from gymrl_tpu_torch import kernels

    kernels.reset_launches()
    result = fn(*args, **kw)
    counts = dict(kernels.LAUNCHES)
    log(f"{label} kernel launches: " + json.dumps(counts))
    if not all(counts[name] for name in names):
        raise AssertionError(f"{label} did not go through every kernel of {names}: {counts}")
    return result, counts


def _check_update_launches(label: str, counts: dict, grad_steps: int,
                           per_step: dict | None = None) -> None:
    """Each update kernel launched ``per_step[name]`` times per grad step:
    by default once each, as ``PPOTrainer``'s (``_update_per_step``)."""
    per_step = per_step or dict.fromkeys(UPDATE_KERNELS, 1)
    wrong = {n: counts[n] for n in UPDATE_KERNELS if counts[n] != grad_steps * per_step[n]}
    if wrong:
        raise AssertionError(f"{label}: {grad_steps} grad steps of {per_step} launches, but "
                             f"update launches {wrong}")


def _update_per_step(trainer, params: int) -> dict:
    """Each update kernel's launches a grad step of ``trainer``, whose net
    has ``params`` tensors: ``PPOTrainer``'s four once each (its table fits
    one launch); a recurrent trainer's ``grad_step``
    (``clip_adam_plain_norm_``) ``clip_adam`` alone, once per piece of
    ``MAX_TENSORS`` tensors."""
    from gymrl_tpu_torch.algos.ppo import PPOTrainer
    from gymrl_tpu_torch.kernels import ppo as kp

    if isinstance(trainer, PPOTrainer):
        return dict.fromkeys(UPDATE_KERNELS, 1)
    return {"ppo_loss_fwd": 0, "ppo_loss_bwd": 0, "grad_sq_norms": 0,
            "clip_adam": -(-params // kp.MAX_TENSORS)}


# -- phase 19: PPO's update kernels against their plain versions on the card ---------
HEAD_RTOL = 1e-6  # the loss and its metrics, relative
HEAD_GRAD_TOL = 1e-6  # dlogits and dvalues, of each tensor's largest entry
HEAD_TIE = 1e-6  # a ratio this close to 1 ± clip_eps, or min_surr this close to 3·adv
HEAD_MAX_ITERS = 16  # iterations after which the first one's rows must cover band and dual clip
ADAM_STEPS = 10
ADAM_TOL = 1e-6  # params absolute; moments of each tensor's largest entry; the norm relative
ADAM_NORMS = {"active": 5.0, "inactive": 0.05}  # the gradients' global norm; the clip is 0.5
# each tensor's square against its float64 sum, relative to itself (the kernel sums in
# float64 and rounds once), and against the plain square, of the table's largest
SQ_NORMS_TOL = 1e-6
# a table past one launch's MAX_TENSORS: sizes around the kernel's CHUNK of 2048, and one
SQ_NORMS_TABLE = (1, 3, 2047, 2048, 2049, 4096, 6000, 65536, 17, 256) * 4
# (storage offset, numel) of views into one buffer: off 16 bytes (offsets 1-3), so they take
# the kernel's scalar loads, or on it with a numel % 4 tail; the value head's bias is 1 float
SQ_NORMS_VIEWS = ((1, 4099), (2, 2050), (3, 7), (0, 4097), (1, 65537), (0, 1), (2, 2048),
                  (3, 6001), (0, 65539), (1, 1))
# rows of the loss head beside the minibatches: one block (1, 64), 64 blocks with a ragged
# last block (16,383) and without (16,384)
HEAD_ROWS = (1, 64, 16383, 16384)
# The recurrent full-tricks PPO, whose grad step (``base.grad_step``) runs the clip and Adam
# alone: its net's 77 tensors take three launches of each.
RECURRENT_UPDATE_CASE = "ppo_lstm_lunarlander"
# the cases phase 19 (d) times: the bench's 16,384 rows, the CLI's 64 (A = 4 and A = 2), the
# recurrent net's clip and Adam
UPDATE_TIMED = ("bench", "ppo_lunarlander", "ppo_cartpole", RECURRENT_UPDATE_CASE)
# Float32 operations counted in ppo.cu for a row of A = 4 logits (each add, multiply,
# compare, select, exp and log as one), and per parameter for the multi-tensor kernels.
LOSS_FWD_OPS_PER_ROW = 64
LOSS_BWD_OPS_PER_ROW = 112
SQ_NORMS_OPS_PER_PARAM = 2
CLIP_ADAM_OPS_PER_PARAM = 14


def _rows_of(trainer):
    """``trainer``'s state after one iteration from seed 0, and the packed
    rows and epoch permutations that iteration trained on."""
    from unittest import mock

    seen, sgd = [], trainer._sgd
    with mock.patch.object(trainer, "_sgd", lambda t, packed, perms: seen.append(
            (packed, perms)) or sgd(t, packed, perms)):
        ts, _ = trainer.train_iter(trainer.init(0))
    packed, perms = seen[0]
    return ts, packed, perms


def _minibatches(trainer, packed, perms, count: int) -> list[torch.Tensor]:
    cfg = trainer.cfg
    mbs = packed[perms[0]].reshape(cfg.num_minibatches, cfg.minibatch_size, packed.shape[1])
    return list(mbs[:count])


def _columns(trainer, mb):
    d = trainer.obs_dim
    return mb[:, d], mb[:, d + 1], mb[:, d + 2], mb[:, d + 3]  # views at stride d + 4


def _net_outputs(trainer, net, mb):
    from gymrl_tpu_torch.algos.ppo import forward_bf16

    obs = mb[:, :trainer.obs_dim]
    with torch.no_grad():
        return forward_bf16(net, obs) if trainer.cfg.sgd_bf16 else net(obs)


def _plain_rows(cfg, logits, values, action, logp_old, adv, returns) -> dict:
    """Each row's terms of the plain head's means (float32, the plain path's
    ops and so its bits), its ratio and min_surr."""
    import numpy as np

    lo, hi = float(np.float32(1.0 - cfg.clip_eps)), float(np.float32(1.0 + cfg.clip_eps))
    with torch.no_grad():
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, action.long()[:, None]).squeeze(-1)
        ratio = torch.exp(logp - logp_old)
        min_surr = torch.minimum(ratio * adv, torch.clamp(ratio, lo, hi) * adv)
        dual = cfg.dual_clip * adv
        return {
            "obj": torch.where(adv < 0.0, torch.maximum(min_surr, dual), min_surr),
            "sq": torch.square(values - returns),
            "entropy": -(torch.exp(logp_all) * logp_all).sum(-1),
            "clipped": ((ratio < lo) | (ratio > hi)).float(),
            "kl": logp_old - logp,
            "ratio": ratio, "min_surr": min_surr, "dual": dual, "lo": lo, "hi": hi,
        }


def _bands(rows: dict, adv: torch.Tensor) -> dict:
    """Each row's place against the clip band and the dual clip, and the tie
    rows whose side float32 rounding may decide."""
    ratio, lo, hi = rows["ratio"], rows["lo"], rows["hi"]
    tie = (((ratio - lo).abs() <= HEAD_TIE) | ((ratio - hi).abs() <= HEAD_TIE)
           | ((adv < 0) & ((rows["min_surr"] - rows["dual"]).abs() <= HEAD_TIE)))
    return {"below": int((ratio < lo).sum()), "inside": int(((ratio >= lo) & (ratio <= hi)).sum()),
            "above": int((ratio > hi).sum()),
            "dual_clipped": int(((adv < 0) & (rows["min_surr"] < rows["dual"])).sum()),
            "ties": tie}


def _exact_head(cfg, rows: dict) -> list[float]:
    """The loss and ``METRICS`` as float64 means of the plain path's own
    float32 row terms: what a mean would give without rounding."""
    m = {k: float(rows[k].double().mean()) for k in ("obj", "sq", "entropy", "clipped", "kl")}
    policy_loss, value_loss = -m["obj"], cfg.value_coef * m["sq"]
    return [policy_loss + value_loss - cfg.entropy_coef * m["entropy"], policy_loss, value_loss,
            m["entropy"], m["clipped"], m["kl"]]


def _spread(cols):
    """The four columns copied into rows of 8 floats at 0, 2, 4 and 6: not
    side by side, so the loss kernels read them at their strides."""
    rows = torch.zeros(cols[0].shape[0], 8, device=cols[0].device)
    for j, c in enumerate(cols):
        rows[:, 2 * j] = c
    return rows[:, 0], rows[:, 2], rows[:, 4], rows[:, 6]


def _head_case(trainer, net, mb, spread: bool = False) -> dict:
    """Phase 19 (a) on one minibatch: ``PPOHeadLoss`` (both kernels) against
    ``ppo_head_loss_plain`` and autograd, from the same logits and values;
    the loss and metrics also against their exact means; and whether two
    ``ppo_loss_fwd`` launches give the same bits. The columns are the
    minibatch's own (side by side: the float4 loads), or ``_spread``."""
    from gymrl_tpu_torch.algos.ppo import ppo_head_loss_plain
    from gymrl_tpu_torch.kernels.ppo import (METRICS, PPOHeadLoss, columns_packed, ppo_loss_bwd,
                                             ppo_loss_fwd)

    cfg = trainer.cfg
    cols = _columns(trainer, mb)
    if spread:
        cols = _spread(cols)
    packed = columns_packed(*cols)
    if packed == spread:
        raise AssertionError(f"the columns take the {'packed' if packed else 'strided'} loads")
    logits, values = _net_outputs(trainer, net, mb)
    out = {}
    for route, head in (("kernel", PPOHeadLoss.apply), ("plain", ppo_head_loss_plain)):
        lg, v = logits.clone().requires_grad_(True), values.clone().requires_grad_(True)
        loss, metrics = head(lg, v, *cols, cfg)
        loss.backward()
        out[route] = ([float(loss.detach())] + metrics.tolist(), lg.grad, v.grad)
    (vk, dlk, dvk), (vp, dlp, dvp) = out["kernel"], out["plain"]
    rows = _plain_rows(cfg, logits, values, *cols)
    bands = _bands(rows, cols[2])
    ties = bands.pop("ties")
    exact = _exact_head(cfg, rows)
    names = ("loss",) + METRICS
    rel = {route: {k: abs(x - e) / abs(e) if e else abs(x) for k, x, e in zip(names, vals, exact)
                   if k != "clip_frac"} for route, vals in (("kernel", vk), ("plain", vp))}
    twice = [torch.cat([x.reshape(-1) for x in ppo_loss_fwd(logits, values, *cols, cfg)])
             for _ in range(2)]
    # the backward twice, and from logits off 16 bytes (its scalar row loads and stores)
    grad_out = torch.ones((), device=logits.device)
    bwd = [torch.cat([x.reshape(-1) for x in ppo_loss_bwd(lg, values, *cols, grad_out, cfg)])
           for lg in (logits, logits, _offset_copy(logits))]
    keep = ~ties
    dl_err = float((dlk - dlp)[keep].abs().max()) if keep.any() else 0.0
    dv_err = float((dvk - dvp).abs().max())
    return {
        "rows": mb.shape[0], "packed": packed, **bands, "tie_rows": int(ties.sum()),
        "rel_err": rel["kernel"], "plain_rel_err": rel["plain"],
        "kernel_vs_plain_rel": {k: abs(a - b) / abs(b) if b else abs(a)
                                for k, a, b in zip(names, vk, vp) if k != "clip_frac"},
        "same_bits": bool(torch.equal(*twice)),
        "bwd_same_bits": bool(torch.equal(bwd[0], bwd[1]) and torch.equal(bwd[0], bwd[2])),
        "grad_bits_equal": bool(torch.equal(dlk[keep], dlp[keep]) and torch.equal(dvk, dvp)),
        "clip_frac_rows_apart": abs(vk[4] - vp[4]) * mb.shape[0],
        "dlogits_err": dl_err, "dlogits_scale": float(dlp.abs().max()),
        "dvalues_err": dv_err, "dvalues_scale": float(dvp.abs().max()),
        "max_abs_err": {"forward": max(abs(a - b) for a, b in zip(vk, vp)),
                        "backward": max(dl_err, dv_err)},
    }


def _merge_head(cases: list[dict]) -> dict:
    out = {"rows": sum(c["rows"] for c in cases), "minibatches": len(cases),
           "packed": sorted({c["packed"] for c in cases}),
           "same_bits": all(c["same_bits"] for c in cases),
           "bwd_same_bits": all(c["bwd_same_bits"] for c in cases),
           "grad_bits_equal": all(c["grad_bits_equal"] for c in cases)}
    for k in ("below", "inside", "above", "dual_clipped", "tie_rows"):
        out[k] = sum(c[k] for c in cases)
    for key in ("rel_err", "plain_rel_err", "kernel_vs_plain_rel"):
        out[key] = {k: max(c[key][k] for c in cases) for k in cases[0][key]}
    for k in ("dlogits", "dvalues"):
        out[f"{k}_of_scale"] = max(c[f"{k}_err"] / c[f"{k}_scale"] for c in cases)
    out["clip_frac_rows_apart"] = max(c["clip_frac_rows_apart"] for c in cases)
    out["max_abs_err"] = {k: max(c["max_abs_err"][k] for c in cases)
                          for k in ("forward", "backward")}
    return out


def _covered(r: dict) -> bool:
    """Whether the rows lie inside the band, beyond both its bounds, and
    under the dual clip."""
    return all(r[k] for k in ("below", "inside", "above", "dual_clipped"))


def _check_head(label: str, r: dict, tie_rows_per_case: list[int], cover: bool = True) -> None:
    breaks = [f"{k} {v} > {HEAD_RTOL}" for k, v in r["rel_err"].items() if not v <= HEAD_RTOL]
    if not r["same_bits"]:
        breaks.append("two ppo_loss_fwd launches on the same inputs gave other bits")
    if not r["bwd_same_bits"]:
        breaks.append("ppo_loss_bwd gave other bits on a rerun or from logits off 16 bytes")
    if not r["grad_bits_equal"]:
        breaks.append("dlogits or dvalues differ from autograd's bits")
    breaks += [f"{k} {r[f'{k}_of_scale']} > {HEAD_GRAD_TOL}" for k in ("dlogits", "dvalues")
               if not r[f"{k}_of_scale"] <= HEAD_GRAD_TOL]
    # clip_frac exact, but for the rows that tie at the band's edges
    if r["clip_frac_rows_apart"] > max(tie_rows_per_case):
        breaks.append(f"clip_frac {r['clip_frac_rows_apart']} rows apart")
    if cover and not _covered(r):
        breaks.append(f"the rows do not cover the band and the dual clip: {r}")
    if breaks:
        raise AssertionError(f"{label}: " + "; ".join(breaks))


def _covering_rows(name: str, device: torch.device):
    """A trainer of phase 16's case ``name`` from seed 0, trained on until
    the packed rows of its first iteration (logp_old from the seed's params)
    lie, under its params, on both sides of the clip band and under the dual
    clip; and those rows and how many iterations old they are. The bench
    config's lr anneals to 0 at 1M env steps (its second iteration), so here
    it trains with ``anneal_lr`` off; its shapes are unchanged."""
    import dataclasses

    trainer = _dist_trainer(name, device)
    if name == "bench":
        trainer = type(trainer)(dataclasses.replace(trainer.cfg, anneal_lr=False), device=device)
    ts, packed, perms = _rows_of(trainer)
    mb = packed[perms[0]]
    cols = _columns(trainer, mb)
    for older in range(1, HEAD_MAX_ITERS + 1):
        if older >= 2:
            logits, values = _net_outputs(trainer, ts.params, mb)
            if _covered(_bands(_plain_rows(trainer.cfg, logits, values, *cols), cols[2])):
                return trainer, ts, packed, perms, older
        ts, _ = trainer.train_iter(ts)
    raise AssertionError(f"{name}: the first iteration's rows do not cover the clip band and "
                         f"the dual clip after {HEAD_MAX_ITERS} iterations")


def _head_shapes(label: str, trainer, net, mb, rows=HEAD_ROWS) -> dict:
    """Phase 19 (a) beyond the minibatches: the first ``k`` rows of ``mb``
    for each ``k`` of ``rows`` (the kernel's one-block and many-block grids),
    and all of them with their columns ``_spread`` (the strided loads); each
    held to the minibatches' bounds but for covering the band."""
    cases = [_head_case(trainer, net, mb[:k]) for k in rows if k <= mb.shape[0]]
    cases.append(_head_case(trainer, net, mb, spread=True))
    for c in cases:
        _check_head(f"phase 19a {label} {c['rows']} rows packed={c['packed']}",
                    _merge_head([c]), [c["tie_rows"]], cover=False)
    r = _merge_head(cases)
    r.update(case=label, row_counts=[c["rows"] for c in cases])
    log("phase 19a loss shapes: " + json.dumps(r))
    return r


def _head_phase(device: torch.device) -> dict:
    """Phase 19 (a): every minibatch of the first epoch of an iteration, of
    the bench config (32 of 16,384 rows, logits from ``forward_bf16``) and of
    ``ppo_lunarlander`` (32 of 64 rows, f32), logp_old from that iteration's
    rollout and the params some iterations later (``_covering_rows``); then
    ``_head_shapes`` on the bench's first minibatch (A = 4) and on
    ``ppo_cartpole``'s rows (A = 2: its first epoch's 64-row minibatches, and
    its 2,048 rows repeated to 16,384) after one iteration."""
    results = {}
    for name in ("bench", "ppo_lunarlander"):
        trainer, ts, packed, perms, older = _covering_rows(name, device)
        mbs = _minibatches(trainer, packed, perms, trainer.cfg.num_minibatches)
        cases = [_head_case(trainer, ts.params, mb) for mb in mbs]
        r = _merge_head(cases)
        r.update(case=name, iterations_older=older)
        log("phase 19a loss: " + json.dumps(r))
        _check_head(f"phase 19a {name}", r, [c["tie_rows"] for c in cases])
        results[name] = r
        if name == "bench":
            results["bench shapes"] = _head_shapes("bench", trainer, ts.params, mbs[0])
        del trainer, ts, packed, mbs
    trainer = _dist_trainer("ppo_cartpole", device)
    ts, packed, perms = _rows_of(trainer)
    mbs = _minibatches(trainer, packed, perms, trainer.cfg.num_minibatches)
    cases = [_head_case(trainer, ts.params, mb) for mb in mbs]
    r = _merge_head(cases)
    r.update(case="ppo_cartpole")
    log("phase 19a loss: " + json.dumps(r))
    _check_head("phase 19a ppo_cartpole", r, [c["tie_rows"] for c in cases], cover=False)
    results["ppo_cartpole"] = r
    tiled = packed[perms[0]].repeat(-(-HEAD_ROWS[-1] // packed.shape[0]), 1)
    results["ppo_cartpole shapes"] = _head_shapes("ppo_cartpole", trainer, ts.params, tiled)
    return results


def _real_grads(trainer, net, packed, perms, steps: int, norm: float) -> list[list[torch.Tensor]]:
    """The plain loss's gradients of ``steps`` minibatches at ``net``, each
    scaled to the global norm ``norm``."""
    from gymrl_tpu_torch.algos.ppo import ppo_head_loss_plain

    out = []
    for mb in _minibatches(trainer, packed, perms, steps):
        net.zero_grad(set_to_none=True)
        obs = mb[:, :trainer.obs_dim]
        logits, values = net(obs)
        loss, _ = ppo_head_loss_plain(logits, values, *_columns(trainer, mb), trainer.cfg)
        loss.backward()
        g = [p.grad.detach().clone() for p in net.parameters()]
        total = torch.linalg.vector_norm(torch.stack([x.double().norm() for x in g]))
        out.append([(x.double() * (norm / total)).float() for x in g])
    net.zero_grad(set_to_none=True)
    return out


def _drawn_grads(net, steps: int, norm: float) -> list[list[torch.Tensor]]:
    """``steps`` sets of normal draws of the shapes of ``net``'s parameters,
    each scaled to the global norm ``norm``, on their device."""
    gen = torch.Generator().manual_seed(7)
    params = list(net.parameters())
    out = []
    for _ in range(steps):
        g = [torch.randn(p.shape, generator=gen) for p in params]
        total = torch.linalg.vector_norm(torch.stack([x.double().norm() for x in g]))
        out.append([(x.double() * (norm / total)).float().to(p.device) for x, p in zip(g, params)])
    return out


def _adam_case(trainer, ts, grads: list[list[torch.Tensor]], norm: float,
               foreach: bool | None = None, kernel_route: str = "clip_adam_") -> dict:
    """Phase 19 (b), one case: ``kernel_route`` of ``algos.base``
    (``clip_adam_``, or ``clip_adam_plain_norm_``, the plain norm's clip
    before ``clip_adam``) and ``clip_adam_plain_`` each take ``len(grads)``
    steps from copies of the trainer's net and Adam (its moments and step
    count; ``foreach`` the trainer's setting unless given), fed the same
    gradients, of global norm ``norm``."""
    from gymrl_tpu_torch.algos import base
    from gymrl_tpu_torch.algos.base import adam, clip_adam_plain_
    from gymrl_tpu_torch.kernels.ppo import MAX_TENSORS, grad_sq_norms

    cfg = trainer.cfg
    foreach = cfg.flat_optimizer if foreach is None else foreach
    runs, norms = {}, {"kernel": [], "plain": []}
    for route, step in (("kernel", getattr(base, kernel_route)), ("plain", clip_adam_plain_)):
        net = copy.deepcopy(ts.params)
        opt = adam(list(net.parameters()), cfg.lr, cfg.adam_eps, foreach=foreach)
        opt.load_state_dict(copy.deepcopy(ts.opt_state.state_dict()))
        for g in grads:
            for p, x in zip(net.parameters(), g):
                p.grad = x.clone()
            gs = [p.grad for p in net.parameters()]
            if route == "kernel" and kernel_route == "clip_adam_":
                norms[route].append(float(grad_sq_norms(gs).double().sum().sqrt()))
            else:
                norms[route].append(float(torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(gs)))))
            step(opt, gs, cfg.max_grad_norm)
        runs[route] = (net, opt)
    (nk, ok), (np_, op) = runs["kernel"], runs["plain"]
    err = {"params": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0}
    equal = True
    for pk, pp in zip(nk.parameters(), np_.parameters()):
        err["params"] = max(err["params"], float((pk - pp).detach().abs().max()))
        equal &= torch.equal(pk, pp)
        sk, sp = ok.state[pk], op.state[pp]
        for k in ("exp_avg", "exp_avg_sq"):
            scale = float(sp[k].abs().max()) or 1.0
            err[k] = max(err[k], float((sk[k] - sp[k]).abs().max()) / scale)
            equal &= torch.equal(sk[k], sp[k])
        if float(sk["step"]) != float(sp["step"]):
            raise AssertionError(f"Adam's step {float(sk['step'])} vs {float(sp['step'])}")
    norm_rel = max(abs(a - b) / b for a, b in zip(norms["kernel"], norms["plain"]))
    tensors = len(list(nk.parameters()))
    return {"route": kernel_route, "foreach": bool(foreach), "grad_norm": norm,
            "steps": len(grads),
            "tensors": tensors, "pieces": -(-tensors // MAX_TENSORS),
            "adam_step": float(ok.state[next(iter(nk.parameters()))]["step"]),
            "params_abs_err": err["params"], "exp_avg_of_scale": err["exp_avg"],
            "exp_avg_sq_of_scale": err["exp_avg_sq"], "norm_rel_err": norm_rel,
            # each route's norm against the float64 one the gradients were scaled to
            "norm_f64_rel_err": {r: max(abs(a - norm) / norm for a in v) for r, v in norms.items()},
            "equal_to_the_bit": bool(equal)}


def _views(offsets_sizes, gen: torch.Generator, device: torch.device) -> list[torch.Tensor]:
    """Views of one new buffer of normals, view ``i`` ``offset`` floats past
    a multiple of 4 floats (16 bytes) for each ``(offset, numel)``."""
    starts = [4 * sum(-(-(o + n) // 4) for o, n in offsets_sizes[:i]) + offset
              for i, (offset, n) in enumerate(offsets_sizes)]
    buffer = torch.randn(starts[-1] + offsets_sizes[-1][1], generator=gen, device=device)
    return [buffer[s:s + n] for s, (_, n) in zip(starts, offsets_sizes)]


def _adam_views_case(device: torch.device, foreach: bool, norm: float) -> dict:
    """Phase 19 (b), the misaligned table: ``clip_adam_`` against
    ``clip_adam_plain_`` for ``ADAM_STEPS`` steps on parameters, gradients
    and both moments that are views of four buffers at the offsets of
    ``SQ_NORMS_VIEWS`` (off 16 bytes, so the kernel takes them one float at
    a time, or on it with a ``numel % 4`` tail), the gradients scaled to the
    global norm ``norm``."""
    from gymrl_tpu_torch.algos.base import adam, clip_adam_, clip_adam_plain_
    from gymrl_tpu_torch.kernels.ppo import aligned_flags

    gen = torch.Generator(device=device).manual_seed(23)
    p0 = _views(SQ_NORMS_VIEWS, gen, device)
    grads = []
    for _ in range(ADAM_STEPS):
        g = _views(SQ_NORMS_VIEWS, gen, device)
        total = torch.linalg.vector_norm(torch.stack([x.double().norm() for x in g]))
        grads.append([(x.double() * (norm / total)).float() for x in g])
    runs = {}
    for route, step in (("kernel", clip_adam_), ("plain", clip_adam_plain_)):
        params = [torch.nn.Parameter(v) for v in _views(SQ_NORMS_VIEWS, gen, device)]
        with torch.no_grad():
            for p, x in zip(params, p0):
                p.copy_(x)
        opt = adam(params, 3e-4, 1e-5, foreach=foreach)
        m, v = _views(SQ_NORMS_VIEWS, gen, device), _views(SQ_NORMS_VIEWS, gen, device)
        for p, a, b in zip(params, m, v):
            opt.state[p]["exp_avg"] = a.zero_()
            opt.state[p]["exp_avg_sq"] = b.zero_()
        for g in grads:
            gs = _views(SQ_NORMS_VIEWS, gen, device)
            for p, x, y in zip(params, gs, g):
                p.grad = x.copy_(y)
            step(opt, gs, 0.5)
        runs[route] = (params, opt, m, v, gs)
    (pk, ok, mk, vk, gk), (pp, _, mp, vp, _) = runs["kernel"], runs["plain"]
    flags = aligned_flags(pk, gk, mk, vk)
    err = {"params": max(float((a - b).detach().abs().max()) for a, b in zip(pk, pp))}
    for label, a, b in (("exp_avg", mk, mp), ("exp_avg_sq", vk, vp)):
        err[label] = max(float((x - y).abs().max()) / (float(y.abs().max()) or 1.0)
                         for x, y in zip(a, b))
    equal = all(torch.equal(a, b) for a, b in zip(pk + mk + vk, pp + mp + vp))
    return {"case": "views", "foreach": foreach, "grad_norm": norm, "steps": ADAM_STEPS,
            "aligned": flags, "params_abs_err": err["params"],
            "exp_avg_of_scale": err["exp_avg"], "exp_avg_sq_of_scale": err["exp_avg_sq"],
            "norm_rel_err": 0.0, "equal_to_the_bit": bool(equal)}


def _sq_rel_errs(got: torch.Tensor, grads: list[torch.Tensor]) -> dict:
    """Each tensor's square from ``grad_sq_norms`` (``got``) against its
    float64 sum, relative to itself, and against the plain square of
    ``torch._foreach_norm``, absolute and of the largest plain square (the
    plain float32 sums are themselves up to ~1e-6 off their exact values);
    and the plain squares' own error."""
    plain = torch.square(torch.stack(torch._foreach_norm(grads))).double()
    exact = torch.stack([g.double().square().sum() for g in grads])
    got = got.double()
    return {"tensors": len(grads),
            "rel_err_exact": float(((got - exact).abs() / exact).max()),
            "plain_rel_err_exact": float(((plain - exact).abs() / exact).max()),
            "max_abs_err": float((got - plain).abs().max()),
            "err_of_largest": float((got - plain).abs().max() / plain.max())}


def _sq_norms_case(trainer, ts, packed, perms, name: str) -> dict:
    """Phase 19 (b), the squares: ``grad_sq_norms`` on a minibatch's real
    gradients, as they come and with tensor ``i`` scaled by
    ``2^(3·(i mod 7) − 9)`` (exact), so that tensors' squares lie 2^-18 to
    2^18 apart and a partial given to the wrong tensor shows; then on a
    table of ``len(SQ_NORMS_TABLE)`` tensors, more than one launch holds,
    and on views of one buffer (``SQ_NORMS_VIEWS``) off 16 bytes or with a
    ``numel % 4`` tail. Each square is held to ``SQ_NORMS_TOL`` of its own
    exact size, and to ``SQ_NORMS_TOL`` of the largest plain square against
    the plain one; two launches on each table must give the same bits."""
    from gymrl_tpu_torch.kernels.ppo import grad_sq_norms

    device = trainer.device
    real = _real_grads(trainer, ts.params, packed, perms, 1, 1.0)[0]
    scaled = [g * 2.0 ** (3 * (i % 7) - 9) for i, g in enumerate(real)]
    gen = torch.Generator(device=device).manual_seed(19)
    table = [torch.randn(n, generator=gen, device=device) * 2.0 ** (3 * (i % 7) - 9)
             for i, n in enumerate(SQ_NORMS_TABLE)]
    views = [v.mul_(2.0 ** (3 * (i % 7) - 9))
             for i, v in enumerate(_views(SQ_NORMS_VIEWS, gen, device))]
    r = {"case": name, "views_off_16_bytes": sum(v.data_ptr() % 16 != 0 for v in views)}
    if r["views_off_16_bytes"] != sum(o != 0 for o, _ in SQ_NORMS_VIEWS):
        raise AssertionError(f"phase 19b: {r['views_off_16_bytes']} views off 16 bytes")
    labels = ("real", "scaled", "table", "views")
    for label, grads in zip(labels, (real, scaled, table, views)):
        first, second = grad_sq_norms(grads), grad_sq_norms(grads)
        r[label] = {**_sq_rel_errs(first, grads), "same_bits": bool(torch.equal(first, second))}
    log("phase 19b squares: " + json.dumps(r))
    bad = {f"{label} {k}": r[label][k] for label in labels
           for k in ("rel_err_exact", "err_of_largest") if not r[label][k] <= SQ_NORMS_TOL}
    bad.update({f"{label} same_bits": False for label in labels if not r[label]["same_bits"]})
    if bad:
        raise AssertionError(f"phase 19b {name} squares: {bad} (bound {SQ_NORMS_TOL})")
    return r


def _whole_iterations(device: torch.device) -> dict:
    """Phase 19 (c): one iteration of the bench config and of ppo_lunarlander
    on the kernels, and one with the plain versions patched into
    ``algos.ppo``, from the same init and noise, under phase 16's rules."""
    from unittest import mock

    from gymrl_tpu_torch import kernels
    from gymrl_tpu_torch.algos import ppo as ppo_mod
    from gymrl_tpu_torch.algos.base import clip_adam_plain_

    out = {}
    for name in ("bench", "ppo_lunarlander"):
        trainer = _dist_trainer(name, device)
        ts, o, wall = _timed_iter(trainer, trainer.init(0))
        plain = _dist_trainer(name, device)
        before = dict(kernels.LAUNCHES)
        with mock.patch.object(ppo_mod, "ppo_head_loss", ppo_mod.ppo_head_loss_plain), \
                mock.patch.object(ppo_mod, "clip_adam_", clip_adam_plain_):
            ts_p, o_p, wall_p = _timed_iter(plain, plain.init(0))
        if any(kernels.LAUNCHES[k] != before[k] for k in UPDATE_KERNELS):
            raise AssertionError(f"{name}: the plain iteration launched an update kernel")
        ref = _reference(plain, ts_p, o_p, wall_p)
        report = _dist_check(name, _cpu_flat(ts), {k: float(v) for k, v in o.metrics.items()},
                             ref)
        out[name] = {"adam_steps": ref["adam_steps"], "bf16": ref["bf16"],
                     "wall_s": {"kernels": wall, "plain": wall_p}, "state": report}
        log("phase 19c iteration: " + json.dumps({"case": name, **out[name]}))
        del trainer, ts, plain, ts_p
    return out


def _update_times(device: torch.device, name: str, calls: int) -> list[dict]:
    """Phase 19 (d) at one case's shape: ms per call and device time of each
    update kernel, its plain version and the library call, and the bound.
    A PPO case times its loss head on a minibatch and the clip and Adam on
    that minibatch's gradients; a recurrent case the two multi-tensor
    kernels alone, on drawn gradients, each once per piece of
    ``MAX_TENSORS`` tensors. The gradients' global norm is 5, over the
    clip."""
    from gymrl_tpu_torch.algos.base import clip_adam_plain_, clip_grads_by_global_norm_
    from gymrl_tpu_torch.algos.ppo import PPOTrainer, ppo_head_loss_plain
    from gymrl_tpu_torch.kernels import ppo as kp

    trainer = _dist_trainer(name, device)
    cfg, cases, n = trainer.cfg, [], None
    if isinstance(trainer, PPOTrainer):
        ts, packed, perms = _rows_of(trainer)
        mb = _minibatches(trainer, packed, perms, 1)[0]
        cols = _columns(trainer, mb)
        logits, values = _net_outputs(trainer, ts.params, mb)
        lg, v = logits.clone().requires_grad_(True), values.clone().requires_grad_(True)
        plain_loss, _ = ppo_head_loss_plain(lg, v, *cols, cfg)
        grad_out = torch.ones((), device=device)
        grads = _real_grads(trainer, ts.params, packed, perms, 1, 5.0)[0]
        n = mb.shape[0]
        col_bytes = 4 * n * 4
        loss_bytes = _nbytes(logits, values) + col_bytes
        cases = [
            ("ppo_loss_fwd", lambda: kp.ppo_loss_fwd(logits, values, *cols, cfg),
             lambda: ppo_head_loss_plain(logits, values, *cols, cfg), None,
             loss_bytes + 4 * (1 + len(kp.METRICS)), LOSS_FWD_OPS_PER_ROW * n),
            ("ppo_loss_bwd", lambda: kp.ppo_loss_bwd(logits, values, *cols, grad_out, cfg),
             lambda: torch.autograd.grad(plain_loss, (lg, v), retain_graph=True), None,
             2 * loss_bytes - col_bytes + 4, LOSS_BWD_OPS_PER_ROW * n)]
    else:
        ts = trainer.init(0)
        grads = _drawn_grads(ts.params, 1, 5.0)[0]
    net = ts.params
    for p, g in zip(net.parameters(), grads):
        p.grad = g  # the plain Adam's and the library's step read them
    params = list(net.parameters())
    pieces = -(-len(params) // kp.MAX_TENSORS)
    per_call = {"ppo_loss_fwd": 1, "ppo_loss_bwd": 1, "grad_sq_norms": pieces, "clip_adam": pieces}
    opt = ts.opt_state
    sq = kp.grad_sq_norms(grads)
    fused = torch.optim.Adam(params, lr=cfg.lr, eps=cfg.adam_eps, fused=True)
    n_params = sum(p.numel() for p in params)
    cases += [
        ("grad_sq_norms", lambda: kp.grad_sq_norms(grads),
         lambda: torch.square(torch.stack(torch._foreach_norm(grads))),
         lambda: torch._foreach_norm(grads), 4 * n_params + 4 * len(grads),
         SQ_NORMS_OPS_PER_PARAM * n_params),
        ("clip_adam", lambda: kp.clip_adam(opt, grads, sq, cfg.max_grad_norm),
         lambda: clip_adam_plain_(opt, grads, cfg.max_grad_norm),
         lambda: (clip_grads_by_global_norm_(grads, cfg.max_grad_norm), fused.step()),
         28 * n_params + 4 * len(grads), CLIP_ADAM_OPS_PER_PARAM * n_params)]
    out = []
    for kernel, fn, plain, library, nbytes, ops in cases:
        bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
        launches, per_kernel = _clean_trace(device, fn, calls, f"{kernel} at {name}",
                                            per_call[kernel])
        plain_launches, plain_per_kernel = _traced_kernels(device, plain, 5)
        r = {"kernel": kernel, "case": name, "rows": n, "tensors": len(params),
             "params": n_params, "ms": _per_call_ms(device, fn, calls),
             "plain_ms": _per_call_ms(device, plain, calls),
             "device_ms": None if per_kernel is None else per_kernel * per_call[kernel],
             "launches_per_call": per_call[kernel], "traced_launches_per_call": launches,
             "plain_device_ms": plain_per_kernel * plain_launches,
             "plain_launches_per_call": plain_launches, "library_ms": None,
             "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if library is not None:
            lib_launches, lib_per_kernel = _traced_kernels(device, library, 5)
            r.update(library_ms=_per_call_ms(device, library, calls),
                     library_device_ms=lib_per_kernel * lib_launches,
                     library_launches_per_call=lib_launches)
        log("phase 19d time: " + json.dumps(r))
        out.append(r)
    return out


def _step_host_ms(trainer, ts, mb, head, update, steps: int) -> dict:
    """Host milliseconds of each part of ``trainer._minibatch_step``,
    averaged over ``steps`` steps, with ``head`` and ``update`` as its loss
    head and its clip + Adam: timing shims around those two mark where the
    forward, the head, the backward (with ``zero_grad``) and the update end
    on the host clock, the card left to run behind; the whole step ends in a
    synchronize, which ``step`` includes."""
    from unittest import mock

    from gymrl_tpu_torch.algos import ppo as ppo_mod

    marks = {}

    def shim(fn, start, end):
        def timed(*args, **kw):
            marks[start] = time.perf_counter()
            out = fn(*args, **kw)
            marks[end] = time.perf_counter()
            return out
        return timed

    parts = dict.fromkeys(("forward", "head", "backward", "clip_adam", "step"), 0.0)
    with mock.patch.object(ppo_mod, "ppo_head_loss", shim(head, "head", "backward")), \
            mock.patch.object(ppo_mod, "clip_adam_", shim(update, "clip_adam", "sync")):
        for _ in range(steps):
            _sync(trainer.device)
            t0 = time.perf_counter()
            trainer._minibatch_step(ts, mb)
            _sync(trainer.device)
            t = {"forward": t0, **marks, "end": time.perf_counter()}
            for k, a, b in (("forward", "forward", "head"), ("head", "head", "backward"),
                            ("backward", "backward", "clip_adam"),
                            ("clip_adam", "clip_adam", "sync"), ("step", "forward", "end")):
                parts[k] += (t[b] - t[a]) * 1e3 / steps
    return parts


def _step_launches(device: torch.device, name: str, steps: int = 20) -> dict:
    """Phase 19 (e): CUDA kernels one grad step launches (``_minibatch_step``
    under ``utils.profiling.trace``) and the host time of its parts, on the
    kernels and with the plain versions patched in."""
    from unittest import mock

    from gymrl_tpu_torch.algos import base
    from gymrl_tpu_torch.algos import ppo as ppo_mod
    from gymrl_tpu_torch.utils.profiling import kernel_stats, trace

    trainer = _dist_trainer(name, device)
    ts, packed, perms = _rows_of(trainer)
    mb = _minibatches(trainer, packed, perms, 1)[0]
    out = {"case": name, "rows": mb.shape[0]}
    routes = {"kernels": (ppo_mod.ppo_head_loss, base.clip_adam_),
              "plain": (ppo_mod.ppo_head_loss_plain, base.clip_adam_plain_)}
    for route, (head, update) in routes.items():
        with mock.patch.object(ppo_mod, "ppo_head_loss", head), \
                mock.patch.object(ppo_mod, "clip_adam_", update):
            trainer._minibatch_step(ts, mb)  # warm-up
            with tempfile.TemporaryDirectory() as tmp:
                with trace(tmp, device) as prof:
                    trainer._minibatch_step(ts, mb)
        host = _step_host_ms(trainer, ts, mb, head, update, steps)
        stats = kernel_stats(prof)
        out[route] = {"launches": stats["kernels"], "kernel_ms": stats["kernel_ms"],
                      "host_ms": host}
    log("phase 19e grad step: " + json.dumps(out))
    return out


def _update_checks(device: torch.device) -> dict:
    """Phase 19 (a)-(b) on ``device``: the loss head; the squares and clip +
    Adam, at the bench config's shape (foreach), ``ppo_lunarlander``'s (per
    tensor) and the recurrent net's (``RECURRENT_UPDATE_CASE``, both)."""
    out = {"head": _head_phase(device), "adam": [], "sq_norms": []}

    def check(name, trainer, ts, grads, norm, label, foreach=None, route="clip_adam_"):
        r = _adam_case(trainer, ts, grads, norm, foreach, route)
        r.update(case=name, clip=label)
        log("phase 19b clip + Adam: " + json.dumps(r))
        out["adam"].append(r)
        bad = {k: r[k] for k in ("params_abs_err", "exp_avg_of_scale", "exp_avg_sq_of_scale",
                                 "norm_rel_err") if not r[k] <= ADAM_TOL}
        if bad or (route == "clip_adam_plain_norm_" and not r["equal_to_the_bit"]):
            raise AssertionError(f"phase 19b {name} {label} {route} foreach={r['foreach']}: "
                                 f"{bad} > {ADAM_TOL}, equal to the bit {r['equal_to_the_bit']}")

    for name in ("bench", "ppo_lunarlander"):
        trainer = _dist_trainer(name, device)
        ts, packed, perms = _rows_of(trainer)
        out["sq_norms"].append(_sq_norms_case(trainer, ts, packed, perms, name))
        for label, norm in ADAM_NORMS.items():
            check(name, trainer, ts, _real_grads(trainer, ts.params, packed, perms, ADAM_STEPS,
                                                 norm), norm, label)
        del trainer, ts
    # the recurrent net's table, past one launch: drawn gradients, both of Adam's modes, the
    # kernels' clip and the grad step's (the plain norm, then the kernel: equal to the bit)
    trainer = _dist_trainer(RECURRENT_UPDATE_CASE, device)
    ts = trainer.init(0)
    for label, norm in ADAM_NORMS.items():
        grads = _drawn_grads(ts.params, ADAM_STEPS, norm)
        for foreach in (True, False):
            for route in ("clip_adam_", "clip_adam_plain_norm_"):
                check(RECURRENT_UPDATE_CASE, trainer, ts, grads, norm, label, foreach, route)
    del trainer, ts
    for foreach in (True, False):  # the misaligned table, both of Adam's modes
        for label, norm in ADAM_NORMS.items():
            r = _adam_views_case(device, foreach, norm)
            r.update(clip=label)
            log("phase 19b clip + Adam: " + json.dumps(r))
            out["adam"].append(r)
            bad = {k: r[k] for k in ("params_abs_err", "exp_avg_of_scale", "exp_avg_sq_of_scale")
                   if not r[k] <= ADAM_TOL}
            if bad or r["aligned"] != [int(o == 0) for o, _ in SQ_NORMS_VIEWS]:
                raise AssertionError(f"phase 19b views {label} foreach={foreach}: {bad} > "
                                     f"{ADAM_TOL}, aligned {r['aligned']}")
    return out


# Each source's kernels as ptxas names them (mangled), and how the report names them.
PTXAS_NAMES = {
    "ppo": ((r"ppo_loss_fwdILi(\d+)ELb([01])E", "ppo_loss_fwd<{}, {}>"),
            (r"ppo_loss_bwdILi(\d+)ELb([01])ELb([01])E", "ppo_loss_bwd<{}, {}, {}>"),
            (r"grad_sq_norms", "grad_sq_norms"),
            (r"clip_adam", "clip_adam")),
    "lunarlander": ((r"lander_stepILb([01])ELb([01])E", "lander_step<{}, {}>"),
                    (r"lander_resetILb([01])E", "lander_reset<{}>")),
}
# Kernels that must keep to registers (no stack frame, no spills), by the report's prefix,
# and how many instantiations each has.
PTXAS_HELD = {"ppo_loss_fwd": 12, "ppo_loss_bwd": 22, "grad_sq_norms": 1, "clip_adam": 1,
              "lander_step": 4, "lander_reset": 2}


def _kernel_name(mangled: str, patterns) -> str | None:
    import re

    for pat, fmt in patterns:
        m = re.search(pat, mangled)
        if m:
            return fmt.format(*m.groups())
    return None


def _ptxas(source: str, defines: dict, patterns, sass: bool = False) -> dict:
    """``nvcc -Xptxas -v`` on ``source`` under the build's flags and
    ``defines``: each kernel's registers, stack frame and spill bytes; with
    ``sass``, also its SASS instructions and local loads and stores
    (``cuobjdump -sass``, where the toolkit has it)."""
    import re
    import subprocess

    from gymrl_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "kernels.so")
        done = subprocess.run([nvcc, *build.FLAGS, *build.define_flags(defines), "-Xptxas", "-v",
                               "-o", lib, source], capture_output=True, text=True)
        if done.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v failed on {source}:\n{done.stderr}")
        dump = None
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        if sass and os.access(cuobjdump, os.X_OK):
            dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True)
    report, name = {}, None
    for line in done.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = _kernel_name(m.group(1), patterns)
            if name is not None:
                report.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m[1])
    if dump is not None and dump.returncode == 0:
        name = None
        for line in dump.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = _kernel_name(m.group(1), patterns)
                if name in report:
                    report[name].update(sass_instructions=0, sass_ldl=0, sass_stl=0)
                continue
            if name in report and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
                rec = report[name]
                rec["sass_instructions"] += 1
                rec["sass_ldl"] += bool(re.search(r"\bLDL\b", line))
                rec["sass_stl"] += bool(re.search(r"\bSTL\b", line))
    return report


def _ptxas_report() -> dict:
    """Phase 19 (d): every kernel of ``ppo.cu`` and ``lunarlander.cu`` as
    ``nvcc -Xptxas -v`` reports it under the build's flags and defines
    (``_ptxas``). Fails unless every kernel of ``PTXAS_HELD`` keeps to
    registers (no stack, no spills)."""
    from gymrl_tpu_torch.kernels import lunarlander as kl
    from gymrl_tpu_torch.kernels import ppo as kp

    report = {**_ptxas(kp.SOURCE, kp.defines(), PTXAS_NAMES["ppo"]),
              **_ptxas(kl.SOURCE, kl.defines(), PTXAS_NAMES["lunarlander"], sass=True)}
    log("phase 19d ptxas: " + json.dumps(report))
    for prefix, count in PTXAS_HELD.items():
        held = [k for k in report if k.split("<")[0] == prefix]
        if len(held) != count:
            raise AssertionError(f"ptxas reported {held} for {prefix}")
    bad = {k: report[k] for k in report if k.split("<")[0] in PTXAS_HELD
           and (report[k].get("stack", 1) or report[k].get("spill_stores", 1)
                or report[k].get("spill_loads", 1))}
    if bad:
        raise AssertionError(f"phase 19d: stack or spills in {bad}")
    return report


def phase_update_kernels(device: torch.device, calls: int = KERNEL_TIMED_CALLS) -> dict:
    """Phase 19: PPO's update kernels against their plain versions on the
    card: (a) the loss head, (b) the squares and the clip with Adam, (c)
    whole iterations, (d) times, (e) launches of one grad step."""
    out = _update_checks(device)
    out["iterations"] = _whole_iterations(device)
    out["time"] = [r for name in UPDATE_TIMED for r in _update_times(device, name, calls)]
    if device.type == "cuda":
        out["ptxas"] = _ptxas_report()
        out["grad_step"] = [_step_launches(device, name) for name in ("bench", "ppo_lunarlander")]
    return out


# -- phase 20: the captured rollout and sweep against the eager ones ---------------------
GRAPH_CASES = ("bench", "ppo_lunarlander", "ppo_cartpole", "ppo_lstm_lunarlander")
GRAPH_ITERS = 4  # the warm-up, the captures with their replays, two more replays
# saved after iteration 2, restored into a fresh state after GRAPH_ITERS
GRAPH_RESTORE_CASES = ("ppo_lunarlander", "ppo_cartpole", "ppo_lstm_lunarlander")
GRAPH_HOLDERS = ("rollout_graph", "sweep_graph")


def _holder_counts(holder) -> dict:
    return {"captures": holder.captures if holder else 0,
            "replays": holder.replays if holder else 0}


def _holders(trainer) -> dict:
    """Each graph holder's counts; a holder the trainer lacks counts none."""
    return {h: _holder_counts(getattr(trainer, h, None)) for h in GRAPH_HOLDERS}


def _graph_counts(label: str, trainer, iters: int) -> dict:
    """The captures and replays of ``trainer``'s rollout and SGD sweep
    graphs, logged; on the graph path, ``iters`` iterations from a fresh
    trainer must be, for each holder it has, the warm-up, one capture and
    ``iters - 1`` replays (none for a holder it lacks)."""
    counts = {h.split("_")[0]: c for h, c in _holders(trainer).items()}
    log(f"{label} graphs: " + json.dumps(counts))
    want = {h.split("_")[0]: ({"captures": 1, "replays": iters - 1} if hasattr(trainer, h)
                              else _holder_counts(None)) for h in GRAPH_HOLDERS}
    if trainer._graphed() and counts != want:
        raise AssertionError(f"{label}: {iters} iterations, but the graphs {counts}")
    return counts


def _graph_probe(device: torch.device) -> dict:
    """Phase 20 (a): one ``clip_adam`` launch of the ctypes library, whose
    CUDA runtime is its own (linked statically), captured into a
    ``torch.cuda.CUDAGraph`` on a side stream and replayed twice, against two
    eager launches from copies of the same params and Adam state. The
    capture must run nothing (the params untouched until the first replay)
    and the replays must give the eager launches' bits."""
    from gymrl_tpu_torch.algos.base import adam
    from gymrl_tpu_torch.kernels import ppo as kp

    gen = torch.Generator().manual_seed(0)
    sizes = (4099, 256, 7, 65536)
    init = [torch.randn(n, generator=gen) for n in sizes]
    grads = [torch.randn(n, generator=gen).to(device) for n in sizes]

    def fresh():
        ps = [torch.nn.Parameter(x.to(device)) for x in init]
        return ps, adam(ps, 3e-4, 1e-5, foreach=True)

    eager_ps, eager_opt = fresh()
    graph_ps, graph_opt = fresh()
    sq = kp.grad_sq_norms(grads)
    for _ in range(2):
        kp.clip_adam(eager_opt, grads, sq, 0.5)
    terms = torch.empty((1, 2), dtype=torch.float32, device=device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), kp.device_terms(terms) as run:
        graph.capture_begin()
        try:
            kp.clip_adam(graph_opt, grads, sq, 0.5)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    untouched = all(torch.equal(p.detach().cpu(), x) for p, x in zip(graph_ps, init))
    for _ in range(2):
        pairs, count = kp.adam_run_terms(graph_opt, 1)
        terms.copy_(torch.from_numpy(pairs))
        graph.replay()
        for state in graph_opt.state.values():
            state["step"].fill_(count)
    torch.cuda.synchronize(device)
    equal = {name: all(torch.equal(a, b) for a, b in zip(
        *(([p.detach() for p in ps] if name == "params" else [opt.state[p][name] for p in ps])
          for ps, opt in ((eager_ps, eager_opt), (graph_ps, graph_opt)))))
        for name in ("params", "exp_avg", "exp_avg_sq")}
    steps = sorted({float(s["step"]) for s in graph_opt.state.values()})
    result = {"capture_ran_nothing": untouched, "pairs_taken": run.taken, "equal": equal,
              "steps": steps}
    log("phase 20a capture probe: " + json.dumps(result))
    if not untouched or not all(equal.values()) or steps != [2.0] or run.taken != 1:
        raise AssertionError(f"phase 20a: the captured clip_adam launch {result}")
    return result


def _launch_calls(prof) -> int:
    """Host calls of a finished trace that launch device work (a kernel, or
    a CUDA graph's kernels)."""
    from gymrl_tpu_torch.utils.profiling import LAUNCH_CALL

    cpu = torch.autograd.DeviceType.CPU
    return sum(ev.device_type() == cpu and bool(LAUNCH_CALL.match(ev.name()))
               for ev in prof.profiler.kineto_results.events())


def _graph_run(device: torch.device, name: str, graphs: bool, iters: int,
               restore: bool) -> dict:
    """``iters`` iterations of case ``name`` from ``init(0)`` with
    ``trainer.graphs = graphs``: each iteration's wall time, rollout and SGD
    ms (CUDA events), metrics, launches and the rows it hands to its update
    (its ``_sgd``; on the CPU), the
    peak memory, the seconds of the graphs' captures (spans), the state on
    the CPU; then one rollout and one update under ``trace`` (launch calls
    and kernels per env step, kernels per grad step). With ``restore``, the
    state is saved after iteration 2 and, after the iterations, restored
    into ``init(1)`` for one more iteration."""
    from unittest import mock

    from gymrl_tpu_torch import kernels
    from gymrl_tpu_torch.utils import profiling
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from gymrl_tpu_torch.utils.profiling import kernel_stats, trace

    cuda = device.type == "cuda"
    trainer = _dist_trainer(name, device)
    trainer.graphs = graphs
    cfg = trainer.cfg
    grad_steps = cfg.num_epochs * cfg.num_minibatches
    ts = trainer.init(0)
    seen, sgd = [], trainer._sgd
    clock = PhaseClock(device)
    lander_steps = cfg.rollout_steps if cfg.env_name.startswith("LunarLander") else 0
    out = {"case": name, "graphs": graphs, "grad_steps": grad_steps, "lander_steps": lander_steps,
           "update_per_step": _update_per_step(trainer, len(list(ts.params.parameters()))),
           "wall_ms": [], "rollout_ms": [], "sgd_ms": [], "launches": [], "metrics": [],
           "rows": []}
    _sync(device)
    if cuda:
        torch.cuda.empty_cache()  # the reserved peak then counts this run's segments
        torch.cuda.reset_peak_memory_stats(device)
    out["base_bytes"] = torch.cuda.memory_allocated(device) if cuda else None
    profiling.clear()
    profiling.enable()
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(
            trainer, "_sgd", lambda t, packed, *rest: seen.append((packed, rest))
            or sgd(t, packed, *rest)):
        path = os.path.join(tmp, "ckpt.pt")
        for it in range(iters + int(restore)):
            if restore and it == iters:
                ts = restore_checkpoint(path, trainer.init(1))
            seen.clear()
            kernels.reset_launches()
            t0 = time.perf_counter()
            clock.start()
            ts, result = trainer.train_iter(ts, timer=clock.mark)
            _sync(device)
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            phase_ms = clock.phase_ms()
            out["rollout_ms"].append(phase_ms["rollout"])
            out["sgd_ms"].append(phase_ms["sgd"])
            out["launches"].append(dict(kernels.LAUNCHES))
            out["metrics"].append({k: float(v) for k, v in result.metrics.items()})
            out["rows"].append(seen[-1][0].cpu())
            if restore and it == 1:
                save_checkpoint(path, ts)
            if it == iters - 1:
                out["state"] = _cpu_flat(ts)
        profiling.disable()
        out["capture_s"] = {k: sum(s.end_ns - s.start_ns for s in profiling.spans()
                                   if s.name == k) / 1e9
                            for k in ("rollout.capture", "sgd.capture")}
        profiling.clear()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
        # the caching allocator's segments, the graphs' private pools among them
        out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(device) if cuda else None
        out["env_steps_per_s"] = cfg.batch_total / out["wall_ms"][iters - 1] * 1e3
        if restore:
            out["restored_state"] = _cpu_flat(ts)
        out.update(_holders(trainer))
        out["holders"] = [h for h in GRAPH_HOLDERS if hasattr(trainer, h)]
        packed, rest = seen[-1]
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device) as prof:
            trainer._collect(ts)
            _sync(device)
    out["launch_calls_per_env_step"] = _launch_calls(prof) / cfg.rollout_steps
    out["kernels_per_env_step"] = kernel_stats(prof)["kernels"] / cfg.rollout_steps
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device) as prof:
            trainer._sgd(ts, packed, *rest)
            _sync(device)
    out["launches_per_grad_step"] = kernel_stats(prof)["kernels"] / grad_steps
    del prof, trainer, ts, seen, packed, rest
    if cuda:
        torch.cuda.empty_cache()
    return out


def _graph_diff(eager: dict, graph: dict) -> dict:
    """The graph path's state against the eager path's: the entries that
    differ, and for params, ``exp_avg`` and ``exp_avg_sq`` the largest
    difference (params absolute, moments of each tensor's largest entry),
    as phase 19 (b) bounds them."""
    differ = [k for k in eager if not (torch.equal(eager[k], graph[k])
                                       if isinstance(eager[k], torch.Tensor)
                                       else eager[k] == graph[k])]
    errs = {"params": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0}
    for k in differ:
        kind = ("params" if k.startswith("ts.params.") else
                k.rsplit(".", 1)[-1] if k.endswith((".exp_avg", ".exp_avg_sq")) else None)
        if kind is None:
            continue
        a, b = eager[k].double(), graph[k].double()
        err = float((a - b).abs().max())
        errs[kind] = max(errs[kind], err if kind == "params" else
                         err / max(float(a.abs().max()), 1e-30))
    return {"differ": differ, "max_err": errs}


def phase_graph(device: torch.device, cases=GRAPH_CASES, iters: int = GRAPH_ITERS,
                restore_cases=GRAPH_RESTORE_CASES) -> dict:
    """Phase 20: (a) the capture probe; (b) per case, ``iters`` iterations
    with the eager rollout and sweep and with the captured ones from the
    same init and noise (the graph path's warm-up, captures with their
    replays, replays): the rows handed to ``_sgd`` at every iteration equal
    to the bit; every state entry, the metrics and Adam's step counts equal
    to the bit, or params and moments within phase 19 (b)'s ``ADAM_TOL``
    and metrics within ``HEAD_RTOL`` with all else equal (the env batch and
    the noise's generator always to the bit); one launch of each update
    kernel per grad step and of each lander kernel per env step on both
    paths, per replay on the graph; each path's rollout and SGD ms,
    env-steps/s, launch calls and kernels per env step (profiler),
    launches per grad step and peak memory; (c) on ``restore_cases``, a
    checkpoint saved mid-run restored into a fresh state captures both
    graphs anew and still matches the eager path restored the same way."""
    cuda = device.type == "cuda"
    result = {"probe": _graph_probe(device) if cuda else None, "cases": []}
    for name in cases:
        restore = name in restore_cases
        eager = _graph_run(device, name, False, iters, restore)
        graph = _graph_run(device, name, True, iters, restore)
        checks = {"iterations": _graph_diff(eager.pop("state"), graph.pop("state"))}
        if restore:
            checks["restored"] = _graph_diff(eager.pop("restored_state"),
                                             graph.pop("restored_state"))
        rows = [torch.equal(a, b) for a, b in zip(eager.pop("rows"), graph.pop("rows"))]
        metric_err = max(abs(a - b) / max(abs(a), 1e-30) for ea, ga in
                         zip(eager["metrics"], graph["metrics"]) for a, b in
                         ((ea[k], ga[k]) for k in ea))
        row = {"case": name, "checks": checks, "rows_equal": rows,
               "metrics_rel_err": metric_err,
               "bit_equal": metric_err == 0.0 and all(rows)
               and not any(c["differ"] for c in checks.values()),
               **{path: {k: r[k] for k in ("wall_ms", "rollout_ms", "sgd_ms", "env_steps_per_s",
                                           "launch_calls_per_env_step", "kernels_per_env_step",
                                           "launches_per_grad_step", "update_per_step",
                                           "peak_memory_bytes",
                                           "peak_reserved_bytes", "base_bytes", "capture_s",
                                           *GRAPH_HOLDERS, "launches")}
                  for path, r in (("eager", eager), ("graph", graph))}}
        log("phase 20b graphs: " + json.dumps(row))
        for path, r in (("eager", eager), ("graph", graph)):
            for counts in r["launches"] if cuda else ():
                _check_update_launches(f"phase 20 {name} {path}", counts, r["grad_steps"],
                                       r["update_per_step"])
                if any(counts[k] != r["lander_steps"] for k in LANDER_KERNELS):
                    raise AssertionError(f"phase 20 {name} {path}: {r['lander_steps']} lander "
                                         f"env steps, but launches {counts}")
        none = _holder_counts(None)
        engaged = ({"captures": 2 if restore else 1, "replays": iters - 1 + int(restore)}
                   if cuda else none)  # the CPU (a rehearsal) runs eagerly
        for holder in GRAPH_HOLDERS:
            # a holder the trainer lacks counts none
            want = engaged if holder in graph["holders"] else none
            if graph[holder] != want or eager[holder] != none:
                raise AssertionError(f"phase 20 {name}: {holder} {graph[holder]} (want {want}), "
                                     f"eager {eager[holder]}")
        if not all(rows):
            raise AssertionError(f"phase 20 {name}: the rows handed to the update differ at "
                                 f"iterations {[i for i, ok in enumerate(rows) if not ok]}")
        for label, c in checks.items():
            exact = [k for k in c["differ"] if not k.startswith("ts.params.")
                     and not k.endswith((".exp_avg", ".exp_avg_sq"))]
            if exact or max(c["max_err"].values()) > ADAM_TOL or metric_err > HEAD_RTOL:
                raise AssertionError(f"phase 20 {name} {label}: the graph path differs: "
                                     f"{exact[:8]}, {c['max_err']}, metrics {metric_err}")
        result["cases"].append(row)
    return result


def phase_solve(device: torch.device | None = None, seeds=(0, 1, 2),
                max_env_steps: int = 600_000) -> list[dict]:
    """The main path's solve check (not in ``main``): ``ppo_lunarlander``'s
    CLI config through ``TrainLoop.train(..., seed=s)`` on the card, the
    sweep as a CUDA graph, until avg100 >= 200 or ``max_env_steps``; the
    env steps it took per seed."""
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop

    device = device or torch.device("cuda")
    out = []
    cwd = os.getcwd()
    for seed in seeds:
        trainer, algo, solve = cli.WORKLOADS["ppo_lunarlander"](str(device))
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=10 ** 9)
                t0 = time.perf_counter()
                _, stats = loop.train(max_env_steps, solve_threshold=solve, seed=seed)
            finally:
                os.chdir(cwd)
        r = {"seed": seed, "solved": stats["solved"], "env_steps": stats["env_steps"],
             "avg100": stats["avg100"], "episodes": stats["episodes"],
             "wall_s": time.perf_counter() - t0,
             "graphs": {"rollout": _holder_counts(trainer.rollout_graph),
                        "sweep": _holder_counts(trainer.sweep_graph)}}
        log("solve: " + json.dumps(r))
        out.append(r)
    return out


def kernel_line(counts: dict, phase18: dict, phase19: dict) -> dict:
    """The kernels line: each kernel's launches on the main path (the bench
    config), its largest error against the plain path, and its times and
    bound at the bench config's shapes."""
    widest = max(r["envs"] for r in phase18["time"])
    times = {r["kernel"]: r for r in phase18["time"]
             if r["envs"] == widest and r["state"] != "reset"}
    times.update({r["kernel"]: r for r in phase19["time"] if r["case"] == "bench"})
    head = phase19["head"].values()
    errs = {
        "lunarlander_step": max(max(r["max_abs_err"].values()) for r in phase18["step"]),
        "lunarlander_reset": max(max(r["max_abs_err"].values()) for r in phase18["reset"]),
        "ppo_loss_fwd": max(r["max_abs_err"]["forward"] for r in head),
        "ppo_loss_bwd": max(r["max_abs_err"]["backward"] for r in head),
        "grad_sq_norms": next(r["real"]["max_abs_err"] for r in phase19["sq_norms"]
                              if r["case"] == "bench"),
        "clip_adam": max(r["params_abs_err"] for r in phase19["adam"]),
    }
    sources = dict.fromkeys(LANDER_KERNELS, "gymrl_tpu_torch/kernels/lunarlander.cu")
    sources.update(dict.fromkeys(UPDATE_KERNELS, "gymrl_tpu_torch/kernels/ppo.cu"))
    replaces = {"lunarlander_step": "gymrl_tpu/envs/lunarlander.py:308",
                "lunarlander_reset": "gymrl_tpu/envs/lunarlander.py:263",
                "ppo_loss_fwd": "gymrl_tpu/algos/ppo.py:335",
                "ppo_loss_bwd": "gymrl_tpu/algos/ppo.py:449",
                "grad_sq_norms": "gymrl_tpu/algos/ppo.py:206",
                "clip_adam": "gymrl_tpu/algos/ppo.py:205"}
    return {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms")}
        for name in LANDER_KERNELS + UPDATE_KERNELS]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import gymrl_tpu_torch  # noqa: F401 — fails here when run outside the repo
    from gymrl_tpu_torch.utils.device import gpu_name_and_power_limit, resolve_device

    device = resolve_device("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(gpu_name_and_power_limit())  # nvidia-smi's "name, power.limit" line

    phase_s: dict[str, float] = {}

    def timed(number: int, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[str(number)] = phase_s.get(str(number), 0.0) + time.perf_counter() - t0
        return out

    from gymrl_tpu_torch.kernels import build

    from gymrl_tpu_torch.run import cli

    timed(1, phase_physics, device)  # the first lander step on the card builds the kernels
    _, main_path = timed(2, _on_kernels, "phase 2", phase_bench, device,
                         names=LANDER_KERNELS + UPDATE_KERNELS)  # its first grad step builds ppo.cu
    log("build_s: " + json.dumps(build.BUILD_SECONDS))
    bench = bench_config()
    bench_steps = bench.num_epochs * bench.num_minibatches
    _check_update_launches("phase 2", main_path,
                           (BENCH_TIMED_ITERS + BENCH_WARM_ITERS) * bench_steps)
    _, entry = timed(3, _on_kernels, "phase 3", phase_entry, device,
                     names=LANDER_KERNELS + UPDATE_KERNELS)
    cli_cfg = cli.WORKLOADS["ppo_lunarlander"]("cpu")[0].cfg
    _check_update_launches("phase 3", entry, ENTRY_ITERS * cli_cfg.num_epochs
                           * cli_cfg.num_minibatches)
    timed(4, phase_classic, device)
    timed(5, phase_updates, device)
    timed(6, phase_workloads, device)
    timed(7, phase_flappy, device)
    timed(7, phase_per, device)
    timed(8, phase_family_updates, device)
    timed(9, phase_workloads, device, FAMILY, label="phase 9 family workload")
    timed(10, phase_pack, device)
    timed(10, phase_seq_forward, device)
    timed(10, phase_rnn_updates, device)
    timed(11, _on_kernels, "phase 11", phase_rnn_workloads, device)
    timed(12, phase_mhc_pieces, device)
    timed(12, phase_mhc_updates, device)
    timed(13, _on_kernels, "phase 13", phase_mhc_workloads, device)
    timed(14, phase_tabular_envs, device)
    timed(14, phase_tabular_steps, device)
    timed(14, phase_tabular_workloads, device)
    timed(15, phase_pixels, device)
    timed(15, phase_family_updates, device, ("dqn_cartpole_pixels",),
          label="phase 15 pixel update")
    pixel = timed(15, phase_workloads, device, ("dqn_cartpole_pixels",),
                  label="phase 15 pixel workload")
    if pixel[0]["replay_obs_dtype"] != "torch.uint8":
        raise AssertionError(f"the pixel replay holds {pixel[0]['replay_obs_dtype']} frames")
    timed(15, phase_render, device)
    timed(16, phase_distributed, device)
    timed(17, phase_profile, device)
    timed(17, phase_spans, device)
    timed(17, phase_spans, device, SPAN_LSTM_CASE, SPAN_LSTM_WINDOW_ITERS)
    phase18 = timed(18, phase_kernels, device)
    phase19 = timed(19, phase_update_kernels, device)
    timed(20, phase_graph, device)
    log("phase_s: " + json.dumps(phase_s))
    log(f"total_s: {time.perf_counter() - t_start:.1f}")
    log(json.dumps(kernel_line(main_path, phase18, phase19)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
