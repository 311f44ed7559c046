#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``oatomobile_torch``).

    python3 chip_smoke.py [--prev-splat PATH ...] [--probe-rounds N]
                          [--dim-plan] [--group-norm] [--depthwise]

Needs one CUDA card and the CUDA toolkit (nvcc).  It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the main path from the sources in this
     checkout (the BEV splat, csrc/bev_splat.cu; the DIM planner,
     csrc/dim_plan.cu; the encoder's GroupNorm, csrc/group_norm.cu, and
     depthwise convolutions, csrc/depthwise_conv.cu) and prints the build
     time, what ptxas reports and
     the loops of each kernel's SASS (cuobjdump);
  3. holds each kernel against its plain PyTorch version on the card: on
     the inputs the main path gives it (Town01, 16 NPCs, after 20 autopilot
     steps) and on inputs that stress its culling
     (``bev_cuda.stress_inputs``), at 64 and 1024 scenes; no pixel may
     differ;
  4. captures one splat in a CUDA graph, replays it on new inputs copied
     into the captured buffers and holds the result against the eager call;
  5. runs a small rollout on the card and on the CPU and holds the episode
     stats against each other; then the closed-loop ``sim.rollout(...,
     policy=)`` with the autopilot at CLOSED_LOOP_TARGET_SPEED under a
     CLOSED_LOOP_LIMIT speed limit on every waypoint (Town02,
     CLOSED_LOOP_SCENES scenes, CLOSED_LOOP_STEPS steps) on each: every
     step's integer and flag fields equal, the hero's position within
     CLOSED_LOOP_XY_ATOL (no splat: the world model synthesises no LIDAR);
  6. drives the main path: ``BatchedEnv("Town01", 1024, num_vehicles=16,
     route_capacity=1024, seed=0).rollout(256, compute=("lidar",))`` once
     to warm up (two eager steps, then the step's capture into a CUDA
     graph: its seconds are printed) and once timed (graph replays), with
     every kernel's launch count set to 0 just before the timed run and
     read just after;
  7. times each kernel (CUDA events around back-to-back calls, median
     of 21 runs) beside its plain version and its bound, and a fill of a
     tensor the size of the splat's output (what the card's memory gives a
     write of those bytes);
  8. holds the learned DIM agent on the card against the CPU (Town02, 4
     scenes, 8 NPCs, weights from one seeded generator): one policy call
     on the same state (plan and actions within 1e-3), then a 10-step
     rollout on each (episodes and collisions equal, distance within
     1e-2 m); and its bfloat16 encoder against the float32 one;
  9. drives the DIM path: ``BatchedEnv("Town01", 1024, num_vehicles=16,
     route_capacity=1024, seed=0).rollout(DIM_STEPS, policy=DIM)`` with
     ``make_dim_policy(ImitativeModel((4, 2), (100, 100)),
     num_plan_steps=20)``, float32 encoder, ``compute=()``: a short warm-up
     rollout, then a timed one with the kernels' launch counts set to 0
     just before it and read just after (one splat, one planner, 52
     GroupNorm and 17 depthwise launches a step), and the stages of one
     policy call (observe, encoder, planner, bridge) on CUDA events; then
     the DIM planner kernel on that
     path's inputs (``check_dim_plan``): its plan equal to the autograd
     path's bit for bit and against the plain version (at most
     DIM_PLAN_APART scenes apart),
     its graph replay against the eager call, and its time beside its
     bound, the plain version and the autograd plan eager and replayed
     from a graph; then the DIM entry (``oatomobile_torch.entry``): its
     loss on the card against the CPU on the same seeded params (rtol
     ENTRY_RTOL) and its ``capture`` replays against the eager call, bit
     for bit, over ENTRY_CALLS calls on new inputs; then the encoder's
     GroupNorm kernel (``check_group_norm``, as ``--group-norm`` below)
     and its depthwise kernel (``check_depthwise``, as ``--depthwise``),
     and each one's launches on the DIM, RIP, CIL and training paths;
 10. holds the batched evaluator on the card against the CPU: two CoRL2017
     Town02 tasks at their configured 100 NPCs, 2 episodes each, through
     ``evaluate_batched`` with the autopilot for 30 steps (per episode
     steps, collisions, lane invasions and success equal, distance within
     1e-3 m) and with a K = 2 RIP-WCM ensemble at 2 plan steps for 10
     steps (steps, collisions and success equal, distance within 1e-2 m);
 11. checks the route-graph cache on the host (``check_route_cache``: a
     Town04 TownMap built at a freed Town02 one's address gets Town04's
     graph, and each CARNOVEL town group's routes equal those planned over
     a CSR built anew from its town), then
     evaluates the whole CARNOVEL suite (27 tasks, configured traffic, one
     episode each) with ``evaluate_batched`` per town group (the scenes
     one call over the suite builds): with the autopilot over the full
     1500-step horizon, then with the RIP-WCM ensemble of K = 4
     ``ImitativeModel((4, 2), (100, 100))`` members (flax-like initial
     weights seeded 0..3, ``make_rip_policy``'s 10 plan steps) over a
     horizon cut to 32 steps; the splat's launches are set to 0 before
     the RIP run and read after (one a step per town group);
 12. runs the single-scene API: ``carnovel.load`` of a Town03 task with
     the default sensors (lidar included), the ``AutopilotAgent`` through
     ``EnvironmentLoop`` for 100 steps (one splat launch at reset and one
     a step); then the learned single-scene agents, whose act runs as a
     captured step (the ``DIMAgent``, a K = 4 ``RIPAgent`` with WCM and
     the ``CILAgent``, published widths, seeded weights): each for
     DIM_AGENT_STEPS steps on the card and on the CPU (actions and
     ego-frame plans within DIM_AGENT_ATOL), then for AGENT_STEPS steps
     on the card eager (``_EagerStep``) and captured in turn from the same
     seed (observations, plans and actions bit for bit; one splat at
     reset and one a step), with the steps/s of both and the agent's and
     the env step's host ms a step;
 13. holds packed collection on the card against the CPU:
     ``collect_packed("Town02", ..., num_episodes=2, num_steps=120,
     num_frame_skips=10, seed=21)`` on each (device packing), with the
     splat's launches counted on the card (one a step); equal sample
     counts, uint8 LIDAR within 1 count (pixels beyond it under 1e-4),
     trajectories and locations within 1e-3;
 14. holds one update of the DIM, CIL and K = 2 RIP trainers on the card
     against the CPU: the same seeded weights, batch of 8 (dense 64x64
     LIDAR, models at 32x32) and threefry key, TF32 off: the loss within
     1e-4 relative, the gradients within 1e-3 of each tensor's largest,
     the card's Adam step within rtol 1e-4 / atol 1e-5 of the CPU Adam
     applied to the card's gradients, and the updated parameters within
     rtol 1e-4 / atol 1e-5 of the CPU's but where Adam's first step takes
     the sign of a gradient below 1e-3 of its tensor's largest (at most
     5e-4 of the elements);
 15. drives the training path at full width: ``collect_packed("Town01",
     ..., num_episodes=64, num_steps=400, num_vehicles=16, noise=0.2,
     seed=0)`` (24-scene chunks, 3 x 400 splat launches) and a breakdown
     of one chunk (set-up; a step with the collected sensors, with the
     LIDAR alone, with none, with none and no noise, each with the
     host's ms a step to enqueue its replays, and the device's busy ms
     and idle share over 16 more steps; the device packing),
     then with the pack resident on the card DIM for 2 epochs (the last
     epoch's mean NLL below the first's), CIL for 1 and RIP with K = 4 for
     1, each at batch 512 and lr 1e-3, with the updates, the median ms of
     an update on CUDA events and its split (forward, forward and
     backward, the encoders' forward and backward), samples/s, the peak
     memory, the epochs' losses, the val loss and the checkpoint; then
     loads ``model-best.pt`` through ``benchmarks.run``'s loader into a
     ``DIMAgent`` and takes one single-scene step on the card;
15b. runs the experiments (``oatomobile_torch.experiments``) over
     the training path's pack and its CIL and K = 4 RIP checkpoints
     (linked into the run's directory: nothing is collected or trained
     twice): ``pipeline.evaluate`` of EXPERIMENT_POLICIES (the autopilot,
     RIP-WCM, DIM from member 0, CIL) over the whole CARNOVEL (27 tasks)
     and CoRL2017 (150 tasks) suites, one episode a task, the horizon cut
     to EXPERIMENT_HORIZON, row by row with each row's seconds, env
     steps/s and splat launches (each learned row one a step per town
     group, the autopilot's none); ``publish`` renders RESULTS.md (its
     table rows printed); ``round2.evaluate`` of ROUND2_POLICY over
     CARNOVEL at ROUND2_HORIZON steps (the flat agents_summary.json, one
     splat a step per town group); ``publish_r3`` and ``publish_r4`` over
     the same tables, each RESULTS.md checked as it is written; then one
     ``train_in_the_loop.run_round`` at LOOP_ROUND's size (collect, train
     DIM, the Town01 rollout and CARNOVEL, one splat a step of each);
15c. runs the studies and the diagnostics over the same pack and
     checkpoints: ``profile_flow`` at PROFILE_FLOW_BATCH scenes (the
     encoder, the flow's inverse, log_prob, the 20-step plan eager and as
     a graph replay, the plan's share, the replays' busy ms and idle
     share); ``rip_sweep`` of STUDY_VARIANTS over CARNOVEL at
     STUDY_HORIZON steps; ``study_dim50`` (DIM at 50x50, one epoch at
     batch 512, then the STUDY_FAMILY tasks at STUDY_HORIZON steps); the
     diagnostics ``hero_stops``, ``stalls`` and ``town02`` on Town02,
     ``busytown`` and ``hills`` (one episode a task), ``learned_failures``
     with RIP-WCM on CoRL2017 Town01 and the data half of ``hills_viz``,
     each DIAG_HORIZON steps; each part's seconds and splat launches (one
     a step per town group on a learned path, none on the autopilot's);
     then holds ``hero_stops`` captured against its eager loop bit for bit
     and ``learned_failures``' counters on the card against the CPU over
     DIAG_CHECK_STEPS steps of DIAG_CHECK_TASKS tasks (integers and flags
     equal, floats within DIAG_FLOAT_ATOL);
 16. holds the compiled rollout against the private eager loop it
     replaced on four paths: the autopilot bench configuration (1024
     scenes), one 24-scene collection chunk of the training path (noise
     0.2, its nine sensors collected), the CARNOVEL Town04 group with the
     autopilot, and the 1024-scene DIM path.  On each, eager and graph
     runs from the same initial state alternate, GRAPH_PAIRS pairs at
     GRAPH_STEPS steps (cut from the paths' own lengths to fit the
     script's time): every run must equal the first bit for bit (stats,
     metrics, collected observations) and every graph run must launch the
     splat once a step where the path splats.  Prints per path each run's
     ms a step and env steps/s (``utils.profiling.timed``), then those of
     the graph's replays alone, the captures' seconds and reserved bytes,
     and for the replays (GRAPH_PROFILE_MODES) the device's busy ms,
     kernels and idle share a step (``utils.profiling.device_busy`` over
     GRAPH_PROFILE_STEPS more steps, against the replays' step), and the
     phase's seconds by part (set-up, runs in turn, replays alone,
     profiler passes);
 17. drives the cameras, the game-state masks and the human render: holds
     the four camera class images and the 64 m game state of 24 Town01
     scenes (16 NPCs, 8 pedestrians, after 20 autopilot steps) and the
     whole-town game state of one Town02 scene on the card against the
     CPU (at most CAMERA_PIXEL_FRACTION of the pixels may differ); runs
     ``BatchedEnv("Town01", 1024, num_vehicles=16, route_capacity=1024,
     seed=0).rollout(CAMERA_STEPS, compute=("front_camera_rgb", "lidar"))``
     once to capture and once timed (one splat launch a step; capture
     seconds and bytes, peak memory, the device's busy ms and idle share),
     and times one ``cameras.camera_classes`` call at 1024 scenes beside
     its bound; collects 24 Town01 scenes x 120 steps with the front
     camera and the game state (``collect_packed``, 100x100 images, one
     splat a step); and drives a CARNOVEL task with the cameras and the
     game state among its sensors through the AutopilotAgent with
     ``render("human")`` after the reset and every step (uint8 276x720x3
     frames, two splats a step: the sensor's and the render's);
 18. drives the device mesh (``parallel.mesh``): (a) with NCCL at world
     size 1 on the card, ``BatchedEnv(mesh=make_mesh())``'s 1024-scene
     autopilot rollout with the LIDAR (MESH_STEPS steps, one splat launch
     a step) against the mesh-less rollout, and one DIM update at
     published widths with ``mesh=`` against one without, each bit for
     bit, then ``entry.dryrun`` in the same process group (rollout ->
     packed windows -> one ensemble step on the 1x1 mesh: its four lines,
     DRYRUN's numbers, a finite loss, DRYRUN_STEPS splat launches); (b)
     MESH_RANKS ranks spawned on the one card over gloo (each
     under MESH_RANK_SECONDS, a failed or hung rank fails the script): the
     sharded 64-scene rollout with the LIDAR, gathered, against the single
     process (hero_xy, stats and the final LIDAR bit for bit, the same
     global values on every rank), and a dp = 2 DIM update against the
     unsharded one (loss and gradients within MESH_UPDATE_RTOL, the
     parameters as phase 14 holds them);
 19. holds the captured single scene (the step, the warm-up and the
     AutopilotAgent's policy replayed as CUDA graphs) against the same
     simulator with every step eager, from the same seed: every step's
     observations bit for bit over SINGLE_SCENE_STEPS steps, and with the
     front camera, the game state and ``render("human")`` after the reset
     and every step (frames too) over CAMERA_SINGLE_SCENE_STEPS; prints
     the steps/s of both and the splat's launches;
 20. measures the eager DIM update's device busy time and idle share at
     batch 512 (published widths, the batch on the card) with
     ``utils.profiling.device_busy``;
 21. prints the seconds of each phase and the total (the script must
     stay well inside its time limit), one JSON line of the kernels and,
     last, the ok/device line.

``--prev-splat PATH`` (may be given more than once) names another design
of the splat, a bev_splat.cu with the same C entry point
``bev_splat_launch``: it is built the same way, checked against the plain
version on the main path's inputs, and timed in turn with this one (old,
new, new, old) at the main path's final inputs; the first one's time is
the kernels line's ``prev_ms``.

``--dim-plan`` builds the kernels, then runs only the DIM planner
kernel's check and timing, the DIM path (its launches: one a step), the
single-scene learned agents captured against eager (one launch an act for
the DIMAgent, none for RIP and CIL) and the RIP-WCM CARNOVEL row (no
launch), and prints the kernel's JSON line.

``--group-norm`` builds the kernels, then runs only the encoder's
GroupNorm kernel (``check_group_norm``): at each of the encoder's 52
GroupNorm shapes at 1024 scenes and at 1 (100 x 100 input), and at 1024
scenes on 32 x 32 and 128 x 128 inputs, its output, mean and rstd
against PyTorch's (``F.group_norm`` then ``F.relu6`` or the residual add;
``torch.native_group_norm``) bit for bit, one graph replay against the
eager call, the encoder's z against the plain path's on the DIM path's
inputs, the time of the 52 launches of one forward beside their bound,
the plain version and PyTorch's ``F.group_norm`` + ``F.relu6``; then the
DIM path as in phase 9 (its launches counted from 0 over the timed
rollout), and the kernel's launches on the RIP path at 1024 scenes, a CIL
forward and the training update and loss (``encoder_launch_counts``);
it prints the kernel's JSON line.

``--depthwise`` builds the kernels, then runs only the encoder's depthwise
kernel (``check_depthwise``): at each of the encoder's 17 depthwise
shapes at 1024 scenes and at 1 (100 x 100 input), and at 1024 scenes on
32 x 32 and 128 x 128 inputs, its output against the program's PyTorch
path (``perception.same_conv``: ``F.pad`` where uneven, ``F.conv2d``) and
against the plain version bit for bit, a whole encoder forward at 1024
scenes against the same forward on PyTorch's path (and the ``F.pad``
calls of each: the stem's alone with the kernel), one graph replay
against the eager call, the time of the 17 launches of one forward
(graph replays) by map size beside their bound, the plain version and
PyTorch's path; then the DIM path and the kernel's launches as for
``--group-norm``, and it prints the kernel's JSON line.

``--probe-rounds N`` builds the kernel, then runs only phases 10 and 11
above (the evaluator's check, the route check and the CARNOVEL runs) N
times, each round on towns built anew, and stops without the last line.

Any failure exits non-zero before the last line.  Without a CUDA device,
or outside a checkout of the repository, it exits 1 and prints no result.
"""

import argparse
import contextlib
import ctypes
import faulthandler
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

STEPS = 256
BATCH = 1024
TOWN = "Town01"
VEHICLES = 16
# Steps of the timed DIM rollout (as the bench's) and of its warm-up.
DIM_STEPS = 256
DIM_WARMUP_STEPS = 4
# DIM on the card against the CPU: plan and actions of one call, and the
# distance of a 10-step rollout (metres).
DIM_CALL_ATOL = 1e-3
DIM_DISTANCE_ATOL = 1e-2
# The DIM planner kernel at the DIM path's inputs (BATCH scenes, the
# policy's 20 Adam steps): its plan equal to the autograd path's bit for
# bit (best iterates too), and within reach of the plain version, which
# sums in other orders, so a scene whose first Adam step (lr * sign(g)) or
# best iterate sits on a rounding may part: at most DIM_PLAN_APART scenes
# further than DIM_PLAN_ATOL metres or on another best iterate; its graph
# replay equal to the eager call.
DIM_PLAN = dict(num_steps=20, lr=5e-2, epsilon=1.0, horizon=4)
DIM_PLAN_ATOL, DIM_PLAN_APART = 1e-4, 3
# The benchmark's frozen count of the plan's products as the autograd path
# does them (the DIM step's FLOPs less the encoder's: ~7.7 GFLOP at 1024
# scenes): the planner's bound by that count.
DIM_PLAN_FROZEN_FLOP = 7.7e9
# The encoder's GroupNorm and depthwise kernels: launches of one
# MobileNetV2 forward, and the steps of the RIP rollout that counts them.
GROUP_NORM_PER_FORWARD = 52
DEPTHWISE_PER_FORWARD = 17
ENCODER_COUNT_STEPS = 6

# The evaluator on the card against the CPU: two CoRL2017 Town02 tasks,
# 2 episodes each; the autopilot's and RIP's horizons and distance limits
# (metres, as the rollout checks above).
EVAL_CHECK_TASKS = ("Town02_Straight0-v0", "Town02_Turn0-v0")
EVAL_CHECK_STEPS, EVAL_DISTANCE_ATOL = 30, 1e-3
EVAL_RIP_CHECK_STEPS, EVAL_RIP_DISTANCE_ATOL = 10, 1e-2
# The route-graph cache check: tries to land a TownMap on a freed one's
# address (CPython's allocator hands the freed block back at once).
REUSE_TRIES = 50
# CARNOVEL through the batched evaluator: the autopilot over the suite's
# 1500-step horizon; the K = 4 RIP ensemble over a horizon cut to 32 steps
# for the time limit.
CARNOVEL_AUTOPILOT_HORIZON = 1500
CARNOVEL_RIP_HORIZON = 32
RIP_MEMBERS = 4
# The single-scene API: a Town03 CARNOVEL task, the autopilot for 100
# steps, then the DIM agent for 5 steps on the card and on the CPU.
SINGLE_SCENE_TASK = "AbnormalTurns0-v0"
SINGLE_SCENE_STEPS = 100
DIM_AGENT_STEPS, DIM_AGENT_ATOL = 5, 1e-3
# The learned single-scene agents (DIM, RIP-WCM with K = RIP_MEMBERS, CIL),
# captured against eager on the card over AGENT_STEPS steps.
AGENT_STEPS = 20

# Collection on the card against the CPU (the JAX package's
# tests/test_datasets_extra.py size) and its limits: uint8 counts, the
# share of LIDAR values beyond one count, and metres.
COLLECT_CHECK = dict(num_episodes=2, num_steps=120, num_frame_skips=10,
                     seed=21)
COLLECT_COUNT_ATOL, COLLECT_BEYOND_FRACTION, COLLECT_ATOL = 1, 1e-4, 1e-3
# One trainer update on the card against the CPU: dense 64x64 LIDAR, the
# models at 32x32 (well-conditioned GroupNorm groups), a batch of 8.
UPDATE_SIZE, UPDATE_INPUT, UPDATE_BATCH = 64, (32, 32), 8
UPDATE_LOSS_RTOL, UPDATE_RTOL, UPDATE_ATOL = 1e-4, 1e-4, 1e-5
UPDATE_GRAD_SCALED, UPDATE_UNRESOLVED, UPDATE_UNRESOLVED_FRACTION = (
    1e-3, 1e-3, 5e-4)
# The training path at full width: the collection, then the trainers at
# batch 512 with the pack resident on the card; updates timed for the
# median ms of one.
TRAIN_TOWN = "Town01"
TRAIN_COLLECT = dict(num_episodes=64, num_steps=400, num_vehicles=16,
                     noise=0.2, seed=0)
TRAIN_BATCH, DIM_EPOCHS, TIMED_UPDATES = 512, 2, 7
# The experiments over the training path's pack and checkpoints:
# the pipeline's evaluation of four policies over the whole CARNOVEL and
# CoRL2017 suites, one episode a task, the horizon cut for the time limit
# (the full 1500-step autopilot run is the CARNOVEL phase's); one
# train-in-the-loop round at a cut scale (at 120 steps a 24-episode round
# would hold fewer samples than a batch of 256: no update).
EXPERIMENT_HORIZON = 32
EXPERIMENT_POLICIES = ("autopilot", "rip_wcm", "dim", "cil")
# Round 2's evaluation of RIP-BCM (10 plan steps) over CARNOVEL at
# RUN_HORIZON ROUND2_HORIZON (1500), then the round-3 and round-4
# publishers over the same tables.
ROUND2_POLICY, ROUND2_HORIZON = "rip_bcm", 32
LOOP_ROUND = dict(episodes=24, num_steps=400, chunk_episodes=24, epochs=1,
                  batch_size=256, rollout_scenes=128, rollout_steps=64)
# The studies and diagnostics over the same pack and checkpoints: the
# flow profile at the DIM bench's width; the sweep's and the 50x50
# study's CARNOVEL runs at a horizon cut to STUDY_HORIZON (1500), the
# study on one family; the diagnostics at DIAG_SCENES scenes (hero_stops,
# stalls) and DIAG_HORIZON steps (1500); learned_failures on the card
# against the CPU over DIAG_CHECK_STEPS steps of its first
# DIAG_CHECK_TASKS tasks.
PROFILE_FLOW_BATCH, PROFILE_FLOW_ITERS = 1024, 5
STUDY_VARIANTS = [["dim", 10], ["rip_wcm", 20]]
STUDY_HORIZON, STUDY_FAMILY = 32, "Hills"
DIAG_SCENES, DIAG_HORIZON = 32, 64
DIAG_CHECK_TASKS, DIAG_CHECK_STEPS, DIAG_FLOAT_ATOL = 4, 8, 1e-4
# Steps of each rollout of the collection's breakdown (past 20 + future 80
# + 20: packing finds windows in them).
COLLECT_BREAKDOWN_STEPS = 120
# The compiled rollout against the eager loop: pairs of runs in turn, the
# steps of each run per path (the eager side is the slow one: 50 ms an
# autopilot step, up to 0.6 s a DIM step on the slower hosts), and the
# steps each mode runs under the profiler.
GRAPH_PAIRS = 1
GRAPH_STEPS = {"autopilot": 64, "collection": 32, "carnovel": 64,
               "dim": 8}
GRAPH_PROFILE_STEPS = {"autopilot": 8, "collection": 8, "carnovel": 8,
                       "dim": 2}
# The modes profiled: the replays only (the eager loop leaves the card
# idle most of a step, and its passes cost the script's time).
GRAPH_PROFILE_MODES = ("graph",)
# Seconds of phase 16 by part (set-up, the runs in turn, the replays
# alone, the profiler passes), summed over its paths.
GRAPH_SPLIT = {}
CARNOVEL_GRAPH_TOWN = "Town04"
# The cameras and the game-state masks: the card against the CPU on 24
# Town01 scenes (16 NPCs, 8 pedestrians) after 20 autopilot steps, where
# only the last ulps of the card's cos/sin may move a pixel; the camera
# rollout at full width; the collection with the cameras; the single
# scene with the human render.
CAMERA_CHECK = dict(batch_size=24, num_vehicles=16, num_pedestrians=8,
                    seed=0)
CAMERA_PIXEL_FRACTION = 1e-4
CAMERA_STEPS = 32
CAMERA_COLLECT = dict(num_episodes=24, num_steps=120, num_vehicles=16,
                      noise=0.2, seed=0, image_size=(100, 100))
CAMERA_SINGLE_SCENE_STEPS = 20
# FP32 operations of one camera call as the port computes it: per column
# and wall/vehicle/pedestrian slot the slab test (the ray rotated into
# the rect's frame, four slab distances, their min/max, hit and select);
# per pixel the ground point, the road test against 6 rects and the depth
# resolve of 3 surfaces.
CAMERA_OPS_PER_SLAB = 31
CAMERA_OPS_PER_PIXEL = 4 + 6 * 14 + 3 * 10 + 2

# The device mesh: (a) NCCL at world size 1 on the card, the mesh's
# 1024-scene autopilot rollout with the LIDAR against the mesh-less one and
# one DIM update with and without the mesh (bit for bit); (b) two ranks on
# the one card over gloo, spawned, each under MESH_RANK_SECONDS: the
# sharded rollout gathered against the single process, and a dp = 2 DIM
# update against the unsharded one (loss and gradients within
# MESH_UPDATE_RTOL; the parameters as the card-vs-CPU update check holds
# them).  The updates: published widths, a dense 200x200 LIDAR batch.
MESH_STEPS = 64
MESH_RANKS, MESH_RANK_SCENES, MESH_RANK_STEPS = 2, 64, 32
MESH_RANK_SECONDS = 240
MESH_TIMEOUT_SECONDS = 60
MESH_UPDATE_BATCH, MESH_UPDATE_RTOL = 64, 1e-5
# (c) The single scene captured against eager (every step's observations
# bit for bit), with the autopilot over SINGLE_SCENE_STEPS steps and with
# render("human") after the reset and every step over
# CAMERA_SINGLE_SCENE_STEPS.  (d) The eager DIM update's device idle
# share at the trainers' batch, over IDLE_UPDATES profiled updates.
IDLE_BATCH, IDLE_UPDATES = 512, 3

# The DIM entry: its loss on the card against the CPU (relative), and its
# captured step against the eager call over ENTRY_CALLS calls on new
# inputs, bit for bit.  The dry run at world size 1: 2 scenes, 115 steps
# (one splat launch a step), 3 window centres a scene, 2 members.
ENTRY_RTOL, ENTRY_CALLS = 1e-5, 5
DRYRUN = dict(scenes=2, mesh=(1, 1), windows=6, batch=6,
              lidar_shape=(3, 2, 100, 100, 2), lidar_dtype="uint8",
              ensemble=2)
DRYRUN_STEPS = 115

# The closed-loop rollout on the card against the CPU: the autopilot at
# 40 km/h under a 50 km/h limit (Town02's own limits are 30 km/h, where
# target_speed changes nothing), every step's integer and flag fields
# equal and the hero's position within 1e-3 m, as phase 5's rollout holds
# its distance.
CLOSED_LOOP_SCENES, CLOSED_LOOP_STEPS, CLOSED_LOOP_VEHICLES = 4, 32, 8
CLOSED_LOOP_TARGET_SPEED, CLOSED_LOOP_LIMIT = 40.0 / 3.6, 50.0 / 3.6
CLOSED_LOOP_XY_ATOL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# FP32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per pixel-slot test of the splat: u and v are two
# products and two sums each, then two compares (|x| <= h, the abs being
# an operand modifier).
OPS_PER_TEST = 10
# Kernel against plain version: no pixel may differ.  The kernel rounds
# every product and sum as the plain version does (no FMA), and its
# culling boxes are conservative, so the two are equal bit for bit.


def fail(message: str) -> None:
  print("chip_smoke: FAILED: " + message, file=sys.stderr)
  sys.exit(1)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True,
      timeout=60)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int, reps: int = 21) -> float:
  """Milliseconds per call of ``fn()`` on the device: CUDA events around
  ``calls`` back-to-back calls, so the host's launch work overlaps the
  previous call's device work; the median over ``reps`` such runs."""
  import torch  # pylint: disable=import-outside-toplevel
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / calls)
  return statistics.median(times)


def splat_bound_ms(hero, walls, roads, boxes):
  """Least time of the splat on an H100: bytes (inputs read once, output
  written once) over the memory rate, or the operations of the pixel-slot
  tests these inputs need (empty slots are skipped) over the FP32 rate."""
  B = hero.shape[0]
  tables = (200 + 2 * 200 * 200) * 4
  in_bytes = sum(x.numel() * 4 for x in (hero, walls, roads, boxes)) + tables
  out_bytes = B * 200 * 200 * 2 * 4
  live_slots = int(sum((x[..., 2] > 0).sum().item()
                       for x in (walls, roads, boxes)))
  ops = 200 * 200 * live_slots * OPS_PER_TEST
  bytes_ms = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES_PER_S
  ops_ms = 1e3 * ops / PEAK_FP32_PER_S
  return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                 else "operations"), live_slots / B


def prev_splat(source: str, bev_cuda):
  """(name, library, launcher) of another design of the splat kernel built
  from ``source``, the launcher called like ``splat_lidar_batch``."""
  import torch  # pylint: disable=import-outside-toplevel
  name = os.path.splitext(os.path.basename(source))[0]
  library = os.path.join(os.path.dirname(bev_cuda.KERNEL.path),
                         "libprev_{}.so".format(name))
  lib = bev_cuda.declare(ctypes.CDLL(bev_cuda.KERNEL.build(source, library)))

  def launch(hero, walls, roads, boxes):
    centers, counts, ground = bev_cuda._tables(hero.device)  # pylint: disable=protected-access
    out = torch.empty((hero.shape[0], 200, 200, 2), dtype=torch.float32,
                      device=hero.device)
    err = lib.bev_splat_launch(
        hero.data_ptr(), walls.data_ptr(), walls.shape[1], roads.data_ptr(),
        roads.shape[1], boxes.data_ptr(), boxes.shape[1], centers.data_ptr(),
        counts.data_ptr(), ground.data_ptr(), out.data_ptr(), hero.shape[0],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
      fail("{} failed to launch: CUDA error {}".format(source, err))
    return out

  return name, library, launch


def print_build(name: str, kernel, library: str) -> None:
  """What ptxas said in ``kernel``'s last build (a ``native.nvcc.Kernel``),
  and the loops of the SASS."""
  from oatomobile_torch import sass  # pylint: disable=import-outside-toplevel
  for line in kernel.build_log.splitlines():
    if "registers" in line or "bytes stack" in line:
      print("ptxas {}: {}".format(name, line.strip()))
  try:
    lines = sass.report(library)
  except (RuntimeError, OSError, subprocess.CalledProcessError) as exc:
    lines = ["sass: not available ({})".format(exc)]
  for line in lines:
    print("{} {}".format(name, line))


def count_differing(out, ref) -> int:
  """Pixels of [B, 200, 200, 2] images where either channel differs (NaN
  differs from everything)."""
  return int((out != ref).any(-1).sum())


def check_closed_loop() -> None:
  """``sim.rollout(policy=)`` with the autopilot at a raised target speed,
  on the card against the CPU."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import sim  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.maps import load_town  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sim.types import scene_state_to_numpy  # pylint: disable=import-outside-toplevel

  def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
      if isinstance(value, dict):
        out.update(flat(value, prefix + key + "."))
      else:
        out[prefix + key] = value
    return out

  def policy(params, state):
    return sim.autopilot_policy(params, state,
                                target_speed=CLOSED_LOOP_TARGET_SPEED)

  t0 = time.perf_counter()
  town = load_town("Town02")
  trajs = {}
  for device in ("cpu", "cuda"):
    params = sim.make_params(town, device=device)
    limit = torch.full_like(params.map["wp_speed_limit"], CLOSED_LOOP_LIMIT)
    params = params.replace(map={**params.map, "wp_speed_limit": limit})
    state = sim.init_scene_batch(town, CLOSED_LOOP_SCENES,
                                 num_vehicles=CLOSED_LOOP_VEHICLES, seed=7,
                                 device=device)
    actions = torch.zeros(CLOSED_LOOP_STEPS, CLOSED_LOOP_SCENES, 3,
                          device=device)
    _, traj = sim.rollout(params, state, actions, policy=policy)
    trajs[device] = flat(scene_state_to_numpy(traj))
  cpu, card = trajs["cpu"], trajs["cuda"]
  discrete = [k for k, v in cpu.items() if v.dtype.kind != "f"]
  equal = all((cpu[k] == card[k]).all() for k in discrete)
  xy_err = float(abs(cpu["hero_xy"] - card["hero_xy"]).max())
  speed = float(card["hero_speed"][-1].mean())
  print("check closed loop cuda vs cpu (Town02, {} scenes, {} NPCs, {} "
        "steps, sim.rollout(policy=autopilot at {:.0f} km/h) under a {:.0f} "
        "km/h limit): discrete fields equal={} ({} fields) "
        "hero_xy_max_abs_diff={} "
        "(limit {}) final hero speed mean {:.2f} m/s; {:.2f}s".format(
            CLOSED_LOOP_SCENES, CLOSED_LOOP_VEHICLES, CLOSED_LOOP_STEPS,
            CLOSED_LOOP_TARGET_SPEED * 3.6, CLOSED_LOOP_LIMIT * 3.6, equal,
            len(discrete), xy_err, CLOSED_LOOP_XY_ATOL, speed,
            time.perf_counter() - t0))
  if not equal or not xy_err <= CLOSED_LOOP_XY_ATOL:
    fail("the closed-loop rollout on the card disagrees with the CPU")


def check_dim_card_against_cpu() -> None:
  """One DIM policy call on the same Town02 state on the CPU and on the
  card, then a 10-step DIM rollout on each; fails beyond the limits."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import (  # pylint: disable=import-outside-toplevel
      encode, encoder_copy, make_dim_policy)
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel

  def model(device):
    return ImitativeModel((4, 2), (100, 100),
                          generator=torch.Generator().manual_seed(0),
                          device=device)

  env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device="cpu")
  env.rollout(5)
  out = {}
  for device in ("cpu", "cuda"):
    params, state = env.params.to(device), env.state.to(device)
    policy = make_dim_policy(model(device))
    obs = policy.observe(params, state)
    z = policy.encode(obs)
    plan = policy.plan(z, obs)
    actions, _ = policy.act(params, state, plan, obs)
    z16 = encode(encoder_copy(policy.model, "bfloat16"), obs.context)
    out[device] = [x.cpu() for x in (z, plan, actions, z16)]
  (z_c, plan_c, act_c, _), (z_g, plan_g, act_g, z16_g) = out["cpu"], out["cuda"]
  errs = {name: float((a - b).abs().max()) for name, a, b in (
      ("z", z_c, z_g), ("plan", plan_c, plan_g), ("actions", act_c, act_g))}
  bf16_err = float((z16_g - z_g).abs().max())
  bf16_bound = 0.05 * max(float(z_g.abs().max()), 1.0)
  print("check dim policy call cuda vs cpu (Town02, 4 scenes, 8 NPCs): "
        "z_max_abs_diff={} plan_max_abs_diff={} actions_max_abs_diff={} "
        "(limit {}); bf16 encoder on the card: z_max_abs_diff={} (bound "
        "{})".format(errs["z"], errs["plan"], errs["actions"], DIM_CALL_ATOL,
                     bf16_err, bf16_bound))
  if errs["plan"] > DIM_CALL_ATOL or errs["actions"] > DIM_CALL_ATOL:
    fail("the DIM policy on the card disagrees with the CPU")
  if not bf16_err < bf16_bound:
    fail("the bfloat16 encoder strays from the float32 one")

  stats = {}
  for device in ("cpu", "cuda"):
    env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=device)
    _, _, s = env.rollout(10, policy=make_dim_policy(model(device)))
    stats[device] = {k: v.cpu() for k, v in s.items()}
  same = all(torch.equal(stats["cpu"][k], stats["cuda"][k])
             for k in ("episodes", "collisions"))
  dist_err = float((stats["cpu"]["distance"] -
                    stats["cuda"]["distance"]).abs().max())
  print("check dim rollout cuda vs cpu (Town02, 4 scenes, 8 NPCs, 10 "
        "steps): episodes/collisions equal={} distance_max_abs_diff={} "
        "(limit {}) distance_mean={:.3f}m".format(
            same, dist_err, DIM_DISTANCE_ATOL,
            float(stats["cpu"]["distance"].mean())))
  if not same or dist_err > DIM_DISTANCE_ATOL:
    fail("the DIM rollout on the card disagrees with the rollout on the CPU")


def entry_inputs(call: int, device) -> tuple:
  """Seeded inputs of ``entry``'s shapes (NHWC visual features)."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  rs = np.random.RandomState(call)
  arrays = (rs.uniform(-5, 5, (2, 4, 2)), rs.uniform(size=(2, 100, 100, 2)),
            rs.uniform(-3, 3, (2, 3)), rs.randint(0, 2, (2, 1)),
            rs.randint(0, 3, (2, 1)))
  return tuple(torch.tensor(a, dtype=torch.float32, device=device)
               for a in arrays)


def check_entry() -> None:
  """(a) ``entry``: the DIM loss on the card against the CPU on the same
  seeded params (the zero example and seeded inputs), then ``capture``'s
  replays against the eager call on the card over ENTRY_CALLS calls on
  new inputs and params, bit for bit."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import entry, graphs  # pylint: disable=import-outside-toplevel
  t0 = time.perf_counter()
  fn_cpu, example = entry.entry("cpu")
  fn, _ = entry.entry("cuda")
  params = {k: v.to("cuda") for k, v in example[0].items()}
  errs = []
  for inputs in (example[1:], entry_inputs(0, "cpu")):
    want = float(fn_cpu(example[0], *inputs))
    got = float(fn(params, *(x.to("cuda") for x in inputs)))
    errs.append(abs(got - want) / max(abs(want), 1e-30))
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    run = entry.capture(fn, (params,) + tuple(x.to("cuda")
                                              for x in example[1:]))
    captures = graphs.captures
    equal = []
    for call in range(ENTRY_CALLS):
      args = ({k: v + 0.01 * call for k, v in params.items()},) + \
          entry_inputs(call, "cuda")
      equal.append(torch.equal(run(*args), fn(*args)))
    captured = graphs.captures - captures
  finally:
    torch.backends.cudnn.deterministic = deterministic
  print("entry: DIM loss card against CPU rel diff (zero example, seeded "
        "inputs) {} (limit {}); captured against eager over {} calls ({} "
        "warm-up, {} capture): bit-equal {}; {:.3f}s".format(
            errs, ENTRY_RTOL, ENTRY_CALLS, graphs.WARMUP_STEPS, captured,
            equal, time.perf_counter() - t0))
  if max(errs) > ENTRY_RTOL:
    fail("the entry's loss on the card disagrees with the CPU")
  if not all(equal) or captured != 1:
    fail("the captured entry differs from the eager call or was not "
         "captured once")


def drive_dim_path() -> dict:
  """The DIM closed loop at full width; returns each kernel's launches in
  the timed rollout, by name (one splat and one plan a step, and the
  encoder's GroupNorm and depthwise kernels once a layer a step)."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import bench  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.native import nvcc  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  policy = bench.dim_policy(100, "float32", device="cuda")
  graphs.capture_seconds, graphs.capture_bytes = 0.0, 0
  t0 = time.perf_counter()
  _, _, s = env.rollout(DIM_WARMUP_STEPS, policy=policy)
  float(s["distance"].sum())
  warmup = time.perf_counter() - t0
  print("dim path: the step captured in {:.3f}s, {} bytes reserved for its "
        "graph's pool (memory_reserved after the capture less before)".format(
            graphs.capture_seconds, graphs.capture_bytes))
  for kernel in nvcc.KERNELS:
    kernel.launches = 0
  profiling.reset()
  t0 = time.perf_counter()
  _, _, s = env.rollout(DIM_STEPS, policy=policy)
  float(s["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0
  launches = {kernel.name: kernel.launches for kernel in nvcc.KERNELS}
  s = {k: v.cpu() for k, v in s.items()}
  finite = all(bool(torch.isfinite(v.float()).all()) for v in s.values())
  print("dim path: {} x {} steps in {:.3f}s = {:.1f} env steps/s ({:.2f} "
        "ms a step of graph replays; warm-up {} steps {:.1f}s, the capture "
        "included); launches {} for {} steps; stats finite={} "
        "distance_mean={:.2f}m episodes={} collisions={}".format(
            BATCH, DIM_STEPS, elapsed, BATCH * DIM_STEPS / elapsed,
            1e3 * elapsed / DIM_STEPS, DIM_WARMUP_STEPS, warmup, launches,
            DIM_STEPS, finite, float(s["distance"].mean()),
            int(s["episodes"].sum()), int(s["collisions"].sum())))
  want = {"bev_splat": DIM_STEPS, "dim_plan": DIM_STEPS,
          "group_norm": GROUP_NORM_PER_FORWARD * DIM_STEPS,
          "depthwise_conv": DEPTHWISE_PER_FORWARD * DIM_STEPS}
  if launches != want:
    fail("the kernels launched {} times in {} DIM steps, not {}".format(
        launches, DIM_STEPS, want))
  if not finite or not bool((s["distance"] > 0).any()):
    fail("DIM path stats are not finite or no scene moved")
  stages = {k: v for k, v in bench.mark_medians(profiling.snapshot()).items()
            if k.startswith("dim.")}
  print("dim policy stages B={} (device marks of the timed rollout's last "
        "replayed step): {}".format(
            BATCH, ", ".join("{} {:.3f} ms".format(k, v)
                             for k, v in stages.items())))
  return launches


def dim_plan_flop(batch: int, horizon: int, num_steps: int) -> float:
  """FP32 operations of the planner kernel's products (two a
  multiply-add): every Adam step runs, each cell of the horizon, the GRU's
  W_hh [192, 64] and W_ih [192, 2] and the head's [32, 64] and [4, 32]
  forward, and their transposes backward, but for the first cell's W_hh
  and W_ih (h_{-1} = z and y_{-1} = 0 take no gradient).  The elementwise
  work is left out."""
  h, d, head = 64, 2, 32
  gru, head_macs = 3 * h * (h + d), head * h + 2 * d * head
  forward = horizon * (gru + head_macs)
  backward = (horizon - 1) * gru + horizon * head_macs
  return 2.0 * batch * num_steps * (forward + backward)


def check_dim_plan() -> dict:
  """The planner kernel on the DIM path's inputs (BATCH Town01 scenes after
  20 autopilot steps, the bench's seeded DIM policy): its plan against the
  plain version and the autograd path, one graph replay against the eager
  call, then its time (CUDA events around 20 back-to-back calls, median of
  21 runs) beside its bounds, the plain version and the autograd plan,
  eager and replayed from a CUDA graph.  Returns its line of the kernels
  JSON."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import bench  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import dim  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  env.rollout(20)
  policy = bench.dim_policy(100, "float32", device="cuda")
  obs = policy.observe(env.params, env.state)
  model, z, goal = policy.model, policy.encode(obs), obs.goal
  weights = dim_plan_cuda.flow_weights(model.decoder)
  steps, lr, epsilon = (DIM_PLAN[k] for k in ("num_steps", "lr", "epsilon"))

  def kernel(z_in=z, goal_in=goal):
    return dim_plan_cuda.plan(weights, z_in, goal_in, **DIM_PLAN)

  def plain():
    return dim_plan_cuda.plan_reference(weights, z, goal, **DIM_PLAN)

  def autograd(z_in=z, goal_in=goal):
    return dim.autograd_plan(model, z_in, steps, goal_in, lr, epsilon)

  out, best = kernel()
  others = {"plain": plain(), "autograd": autograd()}
  torch.cuda.synchronize()
  gaps, apart, best_apart = {}, {}, {}
  for name, (other, other_best) in others.items():
    scene_gap = (out - other).abs().amax((1, 2))
    gaps[name] = float(scene_gap.max())
    best_apart[name] = int((best != other_best).sum())
    apart[name] = int(((scene_gap > DIM_PLAN_ATOL) |
                       (best != other_best)).sum())
  # One capture of the kernel, replayed on the same inputs.
  z_static, goal_static = z.clone(), goal.clone()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured, _ = kernel(z_static, goal_static)
  graph.replay()
  torch.cuda.synchronize()
  replay_equal = torch.equal(captured, out)
  finite = bool(torch.isfinite(out).all())
  auto_equal = (torch.equal(out, others["autograd"][0]) and
                torch.equal(best, others["autograd"][1]))
  print("check dim_plan B={} ({} steps): equal to the autograd path bit for "
        "bit {}; plan max_abs_diff against the plain version {} / the "
        "autograd path {}; scenes further than {} m or on another best "
        "iterate {} / {} (best iterate alone {} / {}; limit {} for the plain "
        "version); graph replay bit-equal {}; finite {}".format(
            BATCH, steps, auto_equal, gaps["plain"], gaps["autograd"],
            DIM_PLAN_ATOL, apart["plain"], apart["autograd"],
            best_apart["plain"], best_apart["autograd"], DIM_PLAN_APART,
            replay_equal, finite))
  if (not auto_equal or apart["plain"] > DIM_PLAN_APART or
      not replay_equal or not finite):
    fail("the dim_plan kernel disagrees with its plain version, the "
         "autograd path or its own graph replay")

  ms = cuda_ms(kernel, calls=20)
  plain_ms = cuda_ms(plain, calls=2)
  autograd_ms = cuda_ms(autograd, calls=2)
  # The autograd plan captured (two warm-up calls on a side stream).
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):
    for _ in range(2):
      autograd(z_static, goal_static)
  torch.cuda.current_stream().wait_stream(stream)
  auto_graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(auto_graph):
    autograd(z_static, goal_static)
  autograd_graph_ms = cuda_ms(auto_graph.replay, calls=5)
  del auto_graph, graph
  flop = dim_plan_flop(BATCH, DIM_PLAN["horizon"], steps)
  bound_ms = 1e3 * flop / PEAK_FP32_PER_S
  frozen_ms = 1e3 * DIM_PLAN_FROZEN_FLOP / PEAK_FP32_PER_S
  print("timing dim_plan B={}: kernel {:.4f} ms, plain {:.3f} ms, autograd "
        "eager {:.3f} ms, autograd replayed from a graph {:.3f} ms; bound "
        "{:.4f} ms ({:.2f} GFLOP of the kernel's products at the FP32 peak; "
        "{:.3f} ms by the benchmark's frozen ~7.7 GFLOP); {:.1f}% of its "
        "bound".format(BATCH, ms, plain_ms, autograd_ms, autograd_graph_ms,
                       bound_ms, flop / 1e9, frozen_ms, 100 * bound_ms / ms))
  return {"name": "dim_plan", "status": "new (replaces no Pallas kernel)",
          "route": "cuda", "source": "oatomobile_torch/csrc/dim_plan.cu",
          "replaces": None, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": "operations",
          "frozen_bound_ms": frozen_ms, "library_ms": None,
          "autograd_ms": autograd_ms, "autograd_graph_ms": autograd_graph_ms,
          "max_abs_err_plain": gaps["plain"],
          "max_abs_err_autograd": gaps["autograd"],
          "equal_to_autograd": auto_equal}


def encoder_norms(size: int = 100) -> list:
  """(C, H, W, epilogue) of the encoder's GroupNorms in order, on a size x
  size input: one forward of a MobileNetV2 at batch 1 on the CPU records
  what ``perception._normalise`` is called with."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import perception  # pylint: disable=import-outside-toplevel
  calls = []
  normalise = perception._normalise  # pylint: disable=protected-access

  def record(norm, h, *, relu6=False, residual=None):
    calls.append((h.shape[1], h.shape[2], h.shape[3], "relu6" if relu6 else
                  "none" if residual is None else "residual"))
    return normalise(norm, h, relu6=relu6, residual=residual)

  perception._normalise = record  # pylint: disable=protected-access
  try:
    with torch.no_grad():
      perception.MobileNetV2(device="cpu")(torch.zeros(1, 2, size, size))
  finally:
    perception._normalise = normalise  # pylint: disable=protected-access
  return calls


def group_norm_case(batch: int, shape: tuple, seed: int) -> tuple:
  """(x, weight, bias, relu6, residual) on the card for one of the
  encoder's GroupNorms: per-channel offsets and spreads, so that some
  groups' means lie far from 0."""
  import torch  # pylint: disable=import-outside-toplevel
  c, h, w, epilogue = shape
  g = torch.Generator(device="cuda").manual_seed(seed)

  def normal(*size):
    return torch.randn(*size, generator=g, device="cuda")

  offset, spread = normal(1, c, 1, 1) * 4, normal(1, c, 1, 1).abs() * 2
  x = normal(batch, c, h, w) * (spread + 0.1) + offset
  weight, bias = 1 + 0.5 * normal(c), normal(c)
  residual = normal(batch, c, h, w) if epilogue == "residual" else None
  return x, weight, bias, epilogue == "relu6", residual


def group_norm_bytes(batch: int, shapes: list) -> int:
  """Bytes the kernel must move for ``shapes`` at ``batch``: x read once,
  y written once, the residual read once (the 8-float parameters left
  out)."""
  return sum(4 * batch * c * h * w * (3 if epilogue == "residual" else 2)
             for c, h, w, epilogue in shapes)


def check_group_norm() -> dict:
  """The encoder's GroupNorm kernel against PyTorch on the card: at each
  of the encoder's GroupNorm shapes at BATCH scenes and at 1 (and at BATCH
  on 32 x 32 and 128 x 128 inputs), its output,
  mean and rstd bit for bit against ``F.group_norm`` (then ``F.relu6`` or
  the residual add) and ``torch.native_group_norm``; one graph replay
  against the eager call; the DIM encoder's z through the kernel against
  the plain path on the DIM path's inputs; then the time of one forward's
  launches (CUDA events around 20 back-to-back passes, median of 21) beside
  their bound, the plain version and ``F.group_norm`` + ``F.relu6``.
  Returns its line of the kernels JSON."""
  import torch  # pylint: disable=import-outside-toplevel
  import torch.nn.functional as F  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import bench  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models.perception import GROUP_NORM_EPS  # pylint: disable=import-outside-toplevel
  shapes = encoder_norms()
  # The 32 x 32 input of the tests and the trainers' checks reaches 1 x 1
  # (GroupNorm1dForward's apply), a 128 x 128 input rows past what the
  # kernel holds in registers: checked too, not timed.
  small, large = encoder_norms(32), encoder_norms(128)
  if len(shapes) != GROUP_NORM_PER_FORWARD:
    fail("the encoder has {} GroupNorms, not {}".format(
        len(shapes), GROUP_NORM_PER_FORWARD))
  lib = gn.KERNEL.library()
  stream = torch.cuda.current_stream().cuda_stream
  verdicts = {}
  for batch, size, checked in ((BATCH, 100, shapes), (1, 100, shapes),
                               (BATCH, 32, small), (BATCH, 128, large)):
    apart = []
    for i, shape in enumerate(checked):
      x, weight, bias, relu6, residual = group_norm_case(batch, shape, i)
      c, h, w, epilogue = shape
      y, mean, rstd = gn.launch(lib, x, weight, bias, GROUP_NORM_EPS,
                                relu6=relu6, residual=residual,
                                stream=stream, stats=True)
      want = gn.group_norm_reference(x, weight, bias, GROUP_NORM_EPS,
                                     relu6=relu6, residual=residual)
      _, want_mean, want_rstd = torch.native_group_norm(
          x, weight, bias, batch, c, h * w, c // gn.GROUP, GROUP_NORM_EPS)
      torch.cuda.synchronize()
      got = (int((y != want).sum()), int((mean != want_mean).sum()),
             int((rstd != want_rstd).sum()))
      if any(got):
        apart.append("{}x{}x{} {}: y {} (max {}), mean {}, rstd {}".format(
            c, h, w, epilogue, got[0], float((y - want).abs().max()),
            got[1], got[2]))
    key = "B={} input {}".format(batch, size)
    verdicts[key] = len(checked) - len(apart)
    print("check group_norm {}: output, mean and rstd equal to PyTorch's "
          "bit for bit at {} of {} shapes (rows of {} to {} floats){}".format(
              key, verdicts[key], len(checked),
              min(8 * h * w for _, h, w, _ in checked),
              max(8 * h * w for _, h, w, _ in checked),
              "; differing elements: " + "; ".join(apart) if apart else ""))
  # One launch captured in a CUDA graph, replayed on new inputs.
  static = list(group_norm_case(64, shapes[3], 100))
  gn.group_norm(static[0], static[1], static[2], GROUP_NORM_EPS,
                relu6=static[3], residual=static[4])
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = gn.group_norm(static[0], static[1], static[2], GROUP_NORM_EPS,
                             relu6=static[3], residual=static[4])
  fresh = group_norm_case(64, shapes[3], 101)
  static[0].copy_(fresh[0])
  graph.replay()
  eager = gn.group_norm(fresh[0], static[1], static[2], GROUP_NORM_EPS,
                        relu6=static[3], residual=static[4])
  torch.cuda.synchronize()
  replay_equal = torch.equal(captured, eager)
  del graph
  # The DIM encoder's z through the kernel against the plain path.
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  env.rollout(20)
  policy = bench.dim_policy(100, "float32", device="cuda")
  obs = policy.observe(env.params, env.state)
  gn.KERNEL.launches = 0
  z = policy.encode(obs)
  launched = gn.KERNEL.launches
  with torch.enable_grad():  # frozen weights: no graph, the plain path
    z_plain = policy.model.params_z(**obs.context)
  torch.cuda.synchronize()
  z_equal = torch.equal(z, z_plain)
  print("check group_norm: graph replay equal to the eager call {}; DIM "
        "encoder z at B={} through the kernel ({} launches) equal to the "
        "plain path's bit for bit {} (max abs diff {})".format(
            replay_equal, BATCH, launched, z_equal,
            float((z - z_plain).abs().max())))
  if (sum(verdicts.values()) != 3 * len(shapes) + len(large) or
      not replay_equal or not z_equal or
      launched != GROUP_NORM_PER_FORWARD):
    fail("the group_norm kernel disagrees with PyTorch's GroupNorm")
  del env, policy, obs, z, z_plain

  cases = [group_norm_case(BATCH, shape, i) for i, shape in enumerate(shapes)]

  def kernel_pass():
    for x, weight, bias, relu6, residual in cases:
      gn.group_norm(x, weight, bias, GROUP_NORM_EPS, relu6=relu6,
                    residual=residual)

  def plain_pass():
    for x, weight, bias, relu6, residual in cases:
      gn.group_norm_reference(x, weight, bias, GROUP_NORM_EPS, relu6=relu6,
                              residual=residual)

  def library_pass():
    for x, weight, bias, relu6, _ in cases:
      y = F.group_norm(x, x.shape[1] // gn.GROUP, weight, bias,
                       GROUP_NORM_EPS)
      if relu6:
        F.relu6(y)

  before = gn.KERNEL.launches
  ms = cuda_ms(kernel_pass, calls=20)
  gn.KERNEL.launches = before
  plain_ms = cuda_ms(plain_pass, calls=20)
  library_ms = cuda_ms(library_pass, calls=20)
  nbytes = group_norm_bytes(BATCH, shapes)
  bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
  regimes = {}
  for (c, h, w, _), case in zip(shapes, cases):
    regime = "one warp a row" if 8 * h * w < 512 else "512 threads a row"
    regimes.setdefault(regime, []).append(case)
  split = {}
  for regime, sub in regimes.items():
    def sub_pass(sub=sub):
      for x, weight, bias, relu6, residual in sub:
        gn.group_norm(x, weight, bias, GROUP_NORM_EPS, relu6=relu6,
                      residual=residual)
    split[regime] = cuda_ms(sub_pass, calls=20)
  gn.KERNEL.launches = before
  print("timing group_norm B={} (the encoder's {} GroupNorms, one forward): "
        "kernel {:.4f} ms ({}), plain version {:.4f} ms, F.group_norm + "
        "F.relu6 {:.4f} ms; bound {:.4f} ms ({:.3f} GB at 3.35 TB/s); "
        "{:.1f}% of its bound".format(
            BATCH, len(shapes), ms, ", ".join(
                "{} {:.4f} ms".format(k, v) for k, v in split.items()),
            plain_ms, library_ms, bound_ms, nbytes / 1e9,
            100 * bound_ms / ms))
  return {"name": "group_norm", "status": "new (replaces no Pallas kernel)",
          "route": "cuda", "source": "oatomobile_torch/csrc/group_norm.cu",
          "replaces": None, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "library_ms": library_ms, "ms_by_regime": split,
          "shapes_equal": verdicts, "replay_equal": replay_equal,
          "z_equal": z_equal}


def encoder_depthwise(size: int = 100) -> list:
  """(C, H, W, stride, padding) of the encoder's depthwise convolutions in
  order, on a size x size input: one forward of a MobileNetV2 at batch 1
  on the CPU records each one's input (padding: top, bottom, left,
  right)."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import perception  # pylint: disable=import-outside-toplevel
  model = perception.MobileNetV2(device="cpu")
  calls = []

  def record(conv, args):
    x, = args
    calls.append((x.shape[1], x.shape[2], x.shape[3], conv.stride[0],
                  conv.same_padding(x)))

  hooks = [block.depthwise.register_forward_pre_hook(record)
           for block in model.modules()
           if isinstance(block, perception.InvertedResidual)]
  with torch.no_grad():
    model(torch.zeros(1, 2, size, size))
  for hook in hooks:
    hook.remove()
  return calls


def depthwise_case(batch: int, shape: tuple, seed: int) -> tuple:
  """(x, weight) on the card for one of the encoder's depthwise layers,
  with per-channel spreads."""
  import torch  # pylint: disable=import-outside-toplevel
  c, h, w, _, _ = shape
  g = torch.Generator(device="cuda").manual_seed(seed)
  spread = 0.1 + 3 * torch.rand(1, c, 1, 1, generator=g, device="cuda")
  x = torch.randn(batch, c, h, w, generator=g, device="cuda") * spread
  weight = 0.5 * torch.randn(c, 1, 3, 3, generator=g, device="cuda")
  return x, weight


def depthwise_bytes(batch: int, shapes: list) -> int:
  """Bytes the kernel must move for ``shapes`` at ``batch``: x read once,
  y written once (the nine weights a channel left out)."""
  from oatomobile_torch.ops import depthwise_cuda  # pylint: disable=import-outside-toplevel
  total = 0
  for c, h, w, stride, (top, bottom, left, right) in shapes:
    ho = depthwise_cuda.output_size(h, stride, top, bottom)
    wo = depthwise_cuda.output_size(w, stride, left, right)
    total += 4 * batch * c * (h * w + ho * wo)
  return total


def replay_of(fn):
  """``fn`` (after one eager call) captured in a CUDA graph; returns the
  graph's replay, so that timing it reads device time alone."""
  import torch  # pylint: disable=import-outside-toplevel
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    fn()
  return graph.replay


def check_depthwise() -> dict:
  """The encoder's depthwise kernel against PyTorch on the card: at each
  of the encoder's depthwise shapes at BATCH scenes and at 1 (and at BATCH
  on 32 x 32 and 128 x 128 inputs), its output bit for bit against the
  program's PyTorch path (``perception.same_conv``: ``F.pad`` where the
  padding is uneven, then ``F.conv2d``) and against the plain version; a
  whole MobileNetV2 forward at BATCH with the kernel against the same
  forward with the depthwise layers on PyTorch's path (and the ``F.pad``
  calls of each); one graph replay against the eager call; then the time
  of one forward's 17 launches (CUDA events around 20 back-to-back replays
  of a graph of them, median of 21), split by map size, beside their
  bound, the plain version and PyTorch's path.  Returns its line of the
  kernels JSON."""
  import torch  # pylint: disable=import-outside-toplevel
  import torch.nn.functional as F  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import perception  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  shapes = encoder_depthwise()
  small, large = encoder_depthwise(32), encoder_depthwise(128)
  if len(shapes) != DEPTHWISE_PER_FORWARD:
    fail("the encoder has {} depthwise layers, not {}".format(
        len(shapes), DEPTHWISE_PER_FORWARD))
  lib = dw.KERNEL.library()
  stream = torch.cuda.current_stream().cuda_stream
  verdicts = {}
  for batch, size, checked in ((BATCH, 100, shapes), (1, 100, shapes),
                               (BATCH, 32, small), (BATCH, 128, large)):
    apart = []
    for i, shape in enumerate(checked):
      x, weight = depthwise_case(batch, shape, i)
      c, h, w, stride, padding = shape
      y = dw.launch(lib, x, weight, stride, padding, stream)
      want = perception.same_conv(x, weight, stride, padding, groups=c)
      plain = dw.depthwise_reference(x, weight, stride, padding)
      torch.cuda.synchronize()
      got = (int((y != want).sum()), int((y != plain).sum()))
      if any(got):
        apart.append("{}x{}x{} s{} {}: {} differ from PyTorch's (max {}), {} "
                     "from the plain version".format(
                         c, h, w, stride, padding, got[0],
                         float((y - want).abs().max()), got[1]))
      del x, weight, y, want, plain
    key = "B={} input {}".format(batch, size)
    verdicts[key] = len(checked) - len(apart)
    print("check depthwise {}: output equal to PyTorch's (F.pad where "
          "uneven, F.conv2d) and to the plain version bit for bit at {} of "
          "{} shapes (maps {} to {}){}".format(
              key, verdicts[key], len(checked),
              min(h for _, h, _, _, _ in checked),
              max(h for _, h, _, _, _ in checked),
              "; " + "; ".join(apart) if apart else ""))
  # A whole encoder forward, the kernel against PyTorch's path, and the
  # F.pad calls of each (the stem's alone with the kernel).
  g = torch.Generator(device="cuda").manual_seed(7)
  model = perception.MobileNetV2(device="cuda").requires_grad_(False)
  for m in model.modules():
    if isinstance(m, torch.nn.GroupNorm):
      m.weight.copy_(1 + 0.5 * torch.randn(m.weight.shape, generator=g,
                                           device="cuda"))
      m.bias.copy_(torch.randn(m.bias.shape, generator=g, device="cuda"))
  images = torch.rand(BATCH, 2, 100, 100, generator=g, device="cuda")
  pad, engages = F.pad, dw.engages
  pads = []

  def counting_pad(*args, **kwargs):
    pads.append(args[1])
    return pad(*args, **kwargs)

  F.pad = counting_pad
  try:
    before = dw.KERNEL.launches
    with torch.no_grad():
      z = model(images)
    launched = dw.KERNEL.launches - before
    pads_kernel, pads[:] = list(pads), []
    dw.engages = lambda x: False
    with torch.no_grad():
      z_plain = model(images)
    pads_plain = list(pads)
  finally:
    F.pad, dw.engages = pad, engages
  torch.cuda.synchronize()
  forward_equal = torch.equal(z, z_plain)
  # One launch captured in a CUDA graph, replayed on new inputs.
  shape = shapes[1]
  static = list(depthwise_case(64, shape, 100))
  graph = torch.cuda.CUDAGraph()
  dw.depthwise(*static, shape[3], shape[4])
  torch.cuda.synchronize()
  with torch.cuda.graph(graph):
    captured = dw.depthwise(*static, shape[3], shape[4])
  fresh = depthwise_case(64, shape, 101)
  static[0].copy_(fresh[0])
  graph.replay()
  eager = dw.depthwise(fresh[0], static[1], shape[3], shape[4])
  torch.cuda.synchronize()
  replay_equal = torch.equal(captured, eager)
  del graph, model, images, z, z_plain
  print("check depthwise: encoder forward at B={} through the kernel ({} "
        "launches) equal to PyTorch's path bit for bit {}; F.pad calls "
        "with the kernel {}, on PyTorch's path {}; graph replay equal to "
        "the eager call {}".format(BATCH, launched, forward_equal,
                                   pads_kernel, pads_plain, replay_equal))
  if (sum(verdicts.values()) != 2 * len(shapes) + len(small) + len(large)
      or not forward_equal or not replay_equal or
      launched != DEPTHWISE_PER_FORWARD or len(pads_kernel) != 1 or
      len(pads_plain) != 2):
    fail("the depthwise kernel disagrees with PyTorch's convolution")

  cases = [(depthwise_case(BATCH, shape, i), shape)
           for i, shape in enumerate(shapes)]

  def kernel_pass(sub=cases):
    for (x, weight), (_, _, _, stride, padding) in sub:
      dw.depthwise(x, weight, stride, padding)

  def plain_pass():
    for (x, weight), (_, _, _, stride, padding) in cases:
      dw.depthwise_reference(x, weight, stride, padding)

  def library_pass():
    for (x, weight), (c, _, _, stride, padding) in cases:
      perception.same_conv(x, weight, stride, padding, groups=c)

  before = dw.KERNEL.launches
  ms = cuda_ms(replay_of(kernel_pass), calls=20)
  eager_ms = cuda_ms(kernel_pass, calls=20)
  library_ms = cuda_ms(replay_of(library_pass), calls=20)
  plain_ms = cuda_ms(plain_pass, calls=1, reps=3)
  by_size = {}
  for case in cases:
    by_size.setdefault("{0}x{0}".format(case[1][1]), []).append(case)
  split = {size: cuda_ms(replay_of(lambda sub=sub: kernel_pass(sub)),
                         calls=20) for size, sub in by_size.items()}
  split_bound = {size: 1e3 * depthwise_bytes(BATCH, [s for _, s in sub]) /
                 PEAK_BYTES_PER_S for size, sub in by_size.items()}
  dw.KERNEL.launches = before
  nbytes = depthwise_bytes(BATCH, shapes)
  bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
  print("timing depthwise B={} (the encoder's {} depthwise layers, one "
        "forward, graph replays): kernel {:.4f} ms (eager calls {:.4f}; by "
        "input map {}), plain version {:.4f} ms, PyTorch's F.pad + F.conv2d "
        "{:.4f} ms; bound {:.4f} ms ({:.3f} GB at 3.35 TB/s); {:.1f}% of its "
        "bound".format(
            BATCH, len(shapes), ms, eager_ms, ", ".join(
                "{} {:.4f} ms ({:.0f}% of {:.4f})".format(
                    k, v, 100 * split_bound[k] / v, split_bound[k])
                for k, v in split.items()),
            plain_ms, library_ms, bound_ms, nbytes / 1e9,
            100 * bound_ms / ms))
  return {"name": "depthwise_conv",
          "status": "new (replaces no Pallas kernel)", "route": "cuda",
          "source": "oatomobile_torch/csrc/depthwise_conv.cu",
          "replaces": None, "ms": ms, "eager_ms": eager_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
          "library_ms": library_ms, "ms_by_map": split,
          "shapes_equal": verdicts, "forward_equal": forward_equal,
          "replay_equal": replay_equal}


def encoder_launch_counts(kernel, per_forward: int,
                          dim_launches: int) -> dict:
  """An encoder kernel's launches a step or a call: the DIM policy's
  captured step (``dim_launches``, those of ``drive_dim_path``'s timed
  rollout), the RIP-WCM policy's (ENCODER_COUNT_STEPS steps at BATCH
  Town01 scenes, after a warm-up that captures the step), a CIL model's
  forward under no_grad, one DIM training update (autograd on: none) and
  the trainer's no-grad evaluation loss, each counted from 0; fails where
  they are not ``per_forward`` a forward."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import BehaviouralModel, ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  counts = {"dim_step": dim_launches / DIM_STEPS}
  policy = make_rip_policy(rip_ensemble(), algorithm="WCM")
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  env.rollout(DIM_WARMUP_STEPS, policy=policy)
  kernel.launches = 0
  _, _, s = env.rollout(ENCODER_COUNT_STEPS, policy=policy)
  float(s["distance"].sum())
  counts["rip_step"] = kernel.launches / ENCODER_COUNT_STEPS
  del env, policy
  cil = BehaviouralModel((40, 2), (100, 100), device="cuda")
  context = {"visual_features": torch.rand(2, 2, 100, 100, device="cuda"),
             **{k: torch.zeros(2, n, device="cuda") for k, n in (
                 ("velocity", 3), ("is_at_traffic_light", 1),
                 ("traffic_light_state", 1), ("mode", 1))}}
  kernel.launches = 0
  with torch.no_grad():
    cil(**context)
  counts["cil_forward"] = kernel.launches
  model = ImitativeModel((4, 2), UPDATE_INPUT, device="cuda")
  loss_fn = dim_train.make_loss_fn()
  state = dp.TrainState.create(model, dp.adam(model, 1e-3),
                               rng_lib.PRNGKey(7, "cuda"))
  batch = update_batch(8)
  kernel.launches = 0
  dp.make_update_fn(loss_fn)(state, batch)
  counts["train_update"] = kernel.launches
  kernel.launches = 0
  dim_train.eval_loss(loss_fn, model, batch)
  counts["train_eval_loss"] = kernel.launches
  torch.cuda.synchronize()
  want = {"dim_step": per_forward, "rip_step": RIP_MEMBERS * per_forward,
          "cil_forward": per_forward, "train_update": 0,
          "train_eval_loss": per_forward}
  print("{} launches: {} (want {})".format(kernel.name, counts, want))
  if counts != want:
    fail("the {} kernel launched {} times, not {}".format(kernel.name,
                                                          counts, want))
  return counts


def _episodes(results) -> list:
  """(task_id, episode index, episode row) of evaluate_batched results."""
  return [(task_id, e, ep) for task_id, row in sorted(results.items())
          for e, ep in enumerate(row.get("episodes", [row]))]


def check_eval_card_against_cpu(device="cuda") -> None:
  """Two CoRL2017 Town02 tasks through evaluate_batched on the CPU and on
  ``device``: with the autopilot, then with a K = 2 RIP-WCM ensemble;
  fails beyond the limits."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel

  tasks = {t: _TASKS[t] for t in EVAL_CHECK_TASKS}

  def rip(dev):
    return make_rip_policy(
        [ImitativeModel((4, 2), (100, 100),
                        generator=torch.Generator().manual_seed(k),
                        device=dev) for k in range(2)],
        algorithm="WCM", num_plan_steps=2)

  for name, horizon, policy_of, keys, atol in (
      ("autopilot", EVAL_CHECK_STEPS, lambda dev: None,
       ("steps", "collisions", "lane_invasions", "success"),
       EVAL_DISTANCE_ATOL),
      ("rip-wcm K=2, 2 plan steps", EVAL_RIP_CHECK_STEPS, rip,
       ("steps", "collisions", "success"), EVAL_RIP_DISTANCE_ATOL)):
    runs = [evaluate_batched(tasks, policy_fn=policy_of(dev),
                             horizon=horizon, num_episodes=2, seed=0,
                             device=dev) for dev in ("cpu", device)]
    cpu, card = (_episodes(r) for r in runs)
    same = [c[:2] == g[:2] and all(c[2][k] == g[2][k] for k in keys)
            for c, g in zip(cpu, card)]
    dist_err = max(abs(c[2]["distance"] - g[2]["distance"])
                   for c, g in zip(cpu, card))
    print("check evaluate_batched {} card vs cpu ({} x 2 episodes, 100 "
          "NPCs, {} steps): {} equal={} distance_max_abs_diff={} (limit "
          "{}) distance_mean={:.3f}m".format(
              name, ", ".join(EVAL_CHECK_TASKS), horizon, "/".join(keys),
              all(same) and len(cpu) == len(card) == 4, dist_err, atol,
              sum(ep["distance"] for _, _, ep in cpu) / len(cpu)))
    if not all(same) or len(cpu) != len(card) or dist_err > atol:
      fail("evaluate_batched with the {} disagrees between the card and "
           "the CPU".format(name))


def drive_carnovel(name: str, policy, horizon: int, device="cuda") -> dict:
  """The 27 CARNOVEL tasks through evaluate_batched, one call per town
  group (each group's scenes are those one call over the suite builds),
  after a 2-step warm-up on the first group; prints per-group seconds,
  env steps/s and the summary's rates; fails if the DIM planner kernel
  launches.  Returns the splat's launches in each group's run."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.batched_eval import (evaluate_batched,  # pylint: disable=import-outside-toplevel
                                                        summarize)
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.maps import load_town  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda, dim_plan_cuda  # pylint: disable=import-outside-toplevel

  groups = {}
  for task_id, config in sorted(_TASKS.items()):
    groups.setdefault(config["town"], {})[task_id] = config
  for town in groups:
    load_town(town)  # builds the town's cache outside the timed runs
  evaluate_batched(next(iter(groups.values())), policy_fn=policy, horizon=2,
                   device=device)
  results, seconds, launches = {}, {}, {}
  plan_launches = dim_plan_cuda.KERNEL.launches
  for town, tasks in groups.items():
    bev_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    results.update(evaluate_batched(tasks, policy_fn=policy,
                                    horizon=horizon, device=device))
    seconds[town] = time.perf_counter() - t0
    launches[town] = bev_cuda.KERNEL.launches
  plan_launches = dim_plan_cuda.KERNEL.launches - plan_launches
  total = sum(seconds.values())
  summary = summarize(results)
  finite = all(torch.isfinite(torch.tensor(float(r["distance"])))
               for r in results.values())
  print("carnovel {}: {} tasks x {} steps in {:.3f}s = {:.1f} env steps/s; "
        "per town group: {}; bev_splat launches per group: {}; dim_plan "
        "launches {}; success_rate"
        "={:.4f} collision_rate={:.4f} timeout_rate={:.4f} mean_distance="
        "{:.2f}m".format(
            name, len(results), horizon, total, len(results) * horizon /
            total, ", ".join("{} {} tasks {:.3f}s ({:.1f} env steps/s)".format(
                town, len(groups[town]), seconds[town],
                len(groups[town]) * horizon / seconds[town])
                             for town in groups),
            launches, plan_launches, summary["success_rate"],
            summary["collision_rate"], summary["timeout_rate"],
            summary["mean_distance"]))
  if plan_launches:
    fail("the {} launched the DIM planner kernel".format(name))
  if len(results) != 27 or summary["episodes"] != 27 or not finite:
    fail("the CARNOVEL evaluation with the {} did not give 27 finite "
         "episodes".format(name))
  if not any(r["distance"] > 0 for r in results.values()):
    fail("no hero moved in the CARNOVEL evaluation with the " + name)
  return launches


def check_route_cache() -> None:
  """Host-side check of the route-graph cache before the CARNOVEL run.

  Forces the address reuse that once handed the native planner another
  town's graph: a TownMap of Town02's arrays takes its graph and dies,
  and one of Town04's arrays is built at the freed address (retried until
  it lands there); ``graph_csr`` must give Town04's node count.  Then
  each CARNOVEL town group's routes, as ``town_group_scenes`` plans them,
  must equal routes planned over a CSR built anew from the town's arrays,
  outside the cache.  Loads the towns first (phase 10 needs them) and
  times the checks alone."""
  import dataclasses  # pylint: disable=import-outside-toplevel
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import native  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.batched_eval import (ROUTE_CAPACITY,  # pylint: disable=import-outside-toplevel
                                                        town_group_scenes)
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.maps import TownMap, graph_csr, load_town  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.maps.routing import build_graph_csr  # pylint: disable=import-outside-toplevel

  groups = {}
  for _, config in sorted(_TASKS.items()):
    groups.setdefault(config["town"], []).append(config)
  t0 = time.perf_counter()
  towns = {name: load_town(name) for name in ("Town02", *groups)}
  t_load = time.perf_counter() - t0
  t0 = time.perf_counter()
  fields = {name: {f.name: getattr(towns[name], f.name)
                   for f in dataclasses.fields(TownMap)}
            for name in ("Town02", "Town04")}
  for tries in range(1, REUSE_TRIES + 1):
    old = TownMap(**fields["Town02"])
    graph_csr(old)
    address = id(old)
    del old
    town = TownMap(**fields["Town04"])
    if id(town) == address:
      break
  else:
    fail("no TownMap landed on a freed one's address in {} tries".format(
        REUSE_TRIES))
  nodes = len(graph_csr(town)[0]) - 1
  del town
  routes_equal = {}
  for name, configs in groups.items():
    _, states = town_group_scenes(name, configs, device="cpu")
    S = towns[name].num_spawn_points
    origins, dests = (
        towns[name].spawn_wp[np.asarray([c[k] for c in configs]) % S]
        for k in ("origin", "destination"))
    want = native.plan_routes_native(*build_graph_csr(towns[name]), origins,
                                     dests, ROUTE_CAPACITY)
    if want is None:
      fail("the native route planner did not build")
    routes_equal[name] = (
        np.array_equal(states.route.numpy(), want[0]) and
        np.array_equal(states.route_len.numpy(), want[1]))
  print("route check: Town04 at a freed Town02 address after {} tries: "
        "graph_csr nodes={} (Town04 has {}); CARNOVEL routes equal a fresh "
        "CSR's: {}; {:.3f}s (towns loaded in {:.3f}s)".format(
            tries, nodes, towns["Town04"].num_waypoints,
            ", ".join("{} {}".format(n, e) for n, e in routes_equal.items()),
            time.perf_counter() - t0, t_load))
  if nodes != towns["Town04"].num_waypoints:
    fail("graph_csr gave a graph of {} nodes for Town04".format(nodes))
  if not all(routes_equal.values()):
    fail("a CARNOVEL town group's routes are not its own graph's")


def run_carnovel() -> dict:
  """The route check, then the CARNOVEL suite with the autopilot
  over 1500 steps and with the K = RIP_MEMBERS RIP-WCM ensemble over
  CARNOVEL_RIP_HORIZON steps.  Returns the splat's launches per town
  group of the RIP run (one a step)."""
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy  # pylint: disable=import-outside-toplevel
  check_route_cache()
  drive_carnovel("autopilot", None, CARNOVEL_AUTOPILOT_HORIZON)
  print("carnovel rip-wcm: horizon cut to {} steps of the suite's 1500 for "
        "the time limit".format(CARNOVEL_RIP_HORIZON))
  rip_launches = drive_carnovel(
      "rip-wcm K={} published widths, 10 plan steps".format(RIP_MEMBERS),
      make_rip_policy(rip_ensemble(), algorithm="WCM"),
      CARNOVEL_RIP_HORIZON)
  if any(n != CARNOVEL_RIP_HORIZON for n in rip_launches.values()):
    fail("bev_splat launched {} times per town group in {} RIP steps".format(
        rip_launches, CARNOVEL_RIP_HORIZON))
  return rip_launches


def probe_carnovel(rounds: int) -> None:
  """``--probe-rounds``: the evaluator's check, the route check and the
  CARNOVEL runs ``rounds`` times in one process.
  Each round first drops the towns, from ``load_town``'s cache and from
  the disk, so every round builds Town02-Town04 anew: the intermediate
  towns of ``maps.towns._build`` die as they did when a run's first
  CARNOVEL phase built them."""
  import shutil  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.maps import towns  # pylint: disable=import-outside-toplevel
  for r in range(rounds):
    t0 = time.perf_counter()
    towns.load_town.cache_clear()
    shutil.rmtree(towns._CACHE_DIR, ignore_errors=True)  # pylint: disable=protected-access
    check_eval_card_against_cpu()
    run_carnovel()
    print("probe round {} of {}: {:.1f}s".format(
        r + 1, rounds, time.perf_counter() - t0), flush=True)


def rip_ensemble(device="cuda"):
  """K = RIP_MEMBERS ImitativeModel((4, 2), (100, 100)) members at the
  published widths, flax-like initial weights seeded 0..K-1."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  return [ImitativeModel((4, 2), (100, 100),
                         generator=torch.Generator().manual_seed(k),
                         device=device) for k in range(RIP_MEMBERS)]


def drive_single_scene(device="cuda", steps: int = SINGLE_SCENE_STEPS) -> int:
  """The single-scene API on ``device``: a CARNOVEL task with the default
  sensors, the AutopilotAgent through EnvironmentLoop; returns the
  splat's launches in the loop (reset included)."""
  from oatomobile_torch import EnvironmentLoop, StepsMetric  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.rulebased import AutopilotAgent  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs import (CollisionsMetric, DistanceMetric,  # pylint: disable=import-outside-toplevel
                                     LaneInvasionsMetric)
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel

  env = CARNOVEL(device=device).load(SINGLE_SCENE_TASK,
                                     max_episode_steps=steps)
  env.seed(0)
  sensors = sorted(env.simulator.sensor_suite.sensors)
  metrics = [StepsMetric(), CollisionsMetric(), LaneInvasionsMetric(),
             DistanceMetric()]
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  results = EnvironmentLoop(AutopilotAgent, env, metrics=metrics).run()
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  print("single scene {} (Town03, 100 NPCs, sensors {}): AutopilotAgent "
        "through EnvironmentLoop, {} steps in {:.3f}s = {:.1f} steps/s "
        "(reset and its 50 warm-up steps included); bev_splat launches={}; "
        "metrics {}".format(SINGLE_SCENE_TASK, ",".join(sensors),
                            results["steps"], elapsed,
                            results["steps"] / elapsed, launches, results))
  if "lidar" not in sensors or results["distance"] <= 0:
    fail("the single-scene episode has no lidar or did not move")
  if device != "cpu" and launches != results["steps"] + 1:
    fail("bev_splat launched {} times in a {}-step single-scene episode "
         "(one at reset and one a step expected)".format(launches,
                                                          results["steps"]))
  return launches


def learned_agents(device="cuda") -> dict:
  """name -> ``make(env)`` of the learned single-scene agents at published
  widths, weights seeded 0 (RIP's K = RIP_MEMBERS members 0..K-1), on
  ``device``: each records the ego-frame plans it tracks in ``plans``."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned import (CILAgent, DIMAgent,  # pylint: disable=import-outside-toplevel
                                                  RIPAgent)
  from oatomobile_torch.models import BehaviouralModel, ImitativeModel  # pylint: disable=import-outside-toplevel

  def recording(cls, **kwargs):
    class Recording(cls):  # pylint: disable=too-few-public-methods

      def __call__(self, observation, **call_kwargs):
        plan = super().__call__(observation, **call_kwargs)
        self.plans.append(plan)
        return plan

    def make(env):
      agent = Recording(env, **kwargs)
      agent.plans = []
      return agent
    return make

  def seeded(cls, shape):
    return cls(shape, (100, 100), generator=torch.Generator().manual_seed(0),
               device=device)

  return {
      "DIMAgent": recording(DIMAgent,
                            model=seeded(ImitativeModel, (4, 2))),
      "RIPAgent WCM K={}".format(RIP_MEMBERS): recording(
          RIPAgent, algorithm="WCM", models=rip_ensemble(device)),
      "CILAgent": recording(CILAgent,
                            model=seeded(BehaviouralModel, (40, 2))),
  }


def check_agents_card_against_cpu(device="cuda") -> None:
  """Each learned single-scene agent (captured on the card) for
  DIM_AGENT_STEPS steps on ``device`` and on the CPU, each on its own env
  of the same task and seed; fails when an action or a plan differs by
  more than DIM_AGENT_ATOL."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel

  makers = {dev: learned_agents(dev) for dev in ("cpu", device)}
  for name in makers[device]:
    actions, plans = {}, {}
    for dev in ("cpu", device):
      env = CARNOVEL(device=dev).load(SINGLE_SCENE_TASK)
      env.seed(0)
      obs = env.reset()
      agent = makers[dev][name](env)
      actions[dev] = []
      for _ in range(DIM_AGENT_STEPS):
        action = agent.act(obs)
        actions[dev].append(action.as_array())
        obs, _, _, _ = env.step(action)
      plans[dev] = agent.plans
      env.close()
    err = float(np.abs(np.asarray(actions["cpu"]) -
                       np.asarray(actions[device])).max())
    plan_err = float(np.abs(np.asarray(plans["cpu"]) -
                            np.asarray(plans[device])).max())
    print("check {} single scene card (captured) vs cpu ({}, {} steps): "
          "actions_max_abs_diff={} plan_max_abs_diff={}m (limit {}) actions "
          "{}".format(name, SINGLE_SCENE_TASK, DIM_AGENT_STEPS, err, plan_err,
                      DIM_AGENT_ATOL,
                      np.round(np.asarray(actions[device]), 4).tolist()))
    if err > DIM_AGENT_ATOL or plan_err > DIM_AGENT_ATOL:
      fail("the {} on the card disagrees with the CPU".format(name))


def agent_run(make, eager: bool, steps: int) -> dict:
  """``make(env)``'s agent on SINGLE_SCENE_TASK on the card for ``steps``
  steps, every step eager (``_EagerStep``) or captured: every step's
  observations, plans and actions on the host, the seconds with and
  without the reset, the agent's and the env step's host ms a step, the
  splat's and the DIM planner's launches."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda, dim_plan_cuda  # pylint: disable=import-outside-toplevel
  captured_step = graphs.CapturedStep
  if eager:
    graphs.CapturedStep = _EagerStep
  try:
    env = CARNOVEL(device="cuda").load(SINGLE_SCENE_TASK)
    env.seed(0)
    bev_cuda.KERNEL.launches = dim_plan_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    obs = env.reset()
    trace = [{k: np.array(v) for k, v in obs.items()}]
    t1 = time.perf_counter()
    agent = make(env)
    split = {"agent": [], "env step": []}
    actions = []
    for _ in range(steps):
      ta = time.perf_counter()
      action = agent.act(obs)
      tb = time.perf_counter()
      obs, _, done, _ = env.step(action)
      split["agent"].append(tb - ta)
      split["env step"].append(time.perf_counter() - tb)
      actions.append(action.as_array())
      trace.append({k: np.array(v) for k, v in obs.items()})
      if done:
        break
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = bev_cuda.KERNEL.launches
    plan_launches = dim_plan_cuda.KERNEL.launches
    env.close()
  finally:
    graphs.CapturedStep = captured_step
  n = len(actions)
  # From the step after the capture on, every act and env step is one
  # replay (captured) or the same eager calls (eager).
  skip = graphs.WARMUP_STEPS + 1
  replay_s = sum(a + e for a, e in zip(split["agent"][skip:],
                                       split["env step"][skip:]))
  return {"trace": trace, "plans": agent.plans, "actions": actions,
          "seconds": t2 - t0, "step_seconds": t2 - t1, "steps": n,
          "launches": launches, "plan_launches": plan_launches,
          "split_ms": {k: round(1e3 * sum(v) / n, 3)
                       for k, v in split.items()},
          "replay_split_ms": {k: round(1e3 * sum(v[skip:]) / (n - skip), 3)
                              for k, v in split.items()},
          "replay_steps_per_s": (n - skip) / replay_s}


def compare_captured_agents() -> tuple:
  """The learned single-scene agents, captured against eager from the same
  seed on the card (observations, plans and actions bit for bit), with
  their steps/s; returns the captured runs' splat launches and the DIM
  planner's launches by agent (one an act for the DIMAgent, none for the
  others)."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  total, plan_launches = 0, {}
  for name, make in learned_agents("cuda").items():
    runs = {mode: agent_run(make, mode == "eager", AGENT_STEPS)
            for mode in ("eager", "captured")}
    eager, captured = runs["eager"], runs["captured"]
    differing = sorted({k for a, b in zip(eager["trace"], captured["trace"])
                        for k in b if not np.array_equal(a[k], b[k])})
    same = (eager["steps"] == captured["steps"] and not differing and
            all(np.array_equal(a, b) for a, b in
                zip(eager["plans"], captured["plans"])) and
            np.array_equal(eager["actions"], captured["actions"]))
    print("single scene {} ({}, default sensors): captured {} steps in "
          "{:.3f}s = {:.1f} steps/s ({:.1f} without the reset and its "
          "warm-up, {:.1f} over the steps after the capture), eager {:.3f}s "
          "= {:.1f} steps/s ({:.1f} without the reset, {:.1f} over the same "
          "steps); host ms a step captured {} / eager {}, over the steps "
          "after the capture {} / {}; bev_splat launches captured {} / "
          "eager {}; dim_plan launches captured {} / eager {}; "
          "observations, plans and actions bit-equal over every "
          "step: {}{}".format(
              name, SINGLE_SCENE_TASK, captured["steps"],
              captured["seconds"], captured["steps"] / captured["seconds"],
              captured["steps"] / captured["step_seconds"],
              captured["replay_steps_per_s"], eager["seconds"],
              eager["steps"] / eager["seconds"],
              eager["steps"] / eager["step_seconds"],
              eager["replay_steps_per_s"], captured["split_ms"],
              eager["split_ms"], captured["replay_split_ms"],
              eager["replay_split_ms"], captured["launches"],
              eager["launches"], captured["plan_launches"],
              eager["plan_launches"], same,
              " (differing: {})".format(differing) if differing else ""))
    if not same:
      fail("the captured {} differs from the eager one".format(name))
    if not np.isfinite(captured["actions"]).all():
      fail("the {}'s actions are not finite".format(name))
    if captured["launches"] != captured["steps"] + 1:
      fail("bev_splat launched {} times in a captured {}-step single scene "
           "of the {}".format(captured["launches"], captured["steps"], name))
    want = captured["steps"] if name == "DIMAgent" else 0
    if captured["plan_launches"] != want or eager["plan_launches"] != want:
      fail("dim_plan launched {} / {} times (captured / eager) in a {}-step "
           "single scene of the {}".format(
               captured["plan_launches"], eager["plan_launches"],
               captured["steps"], name))
    total += captured["launches"]
    plan_launches[name] = captured["plan_launches"]
  return total, plan_launches


def check_collect_card_against_cpu(workdir: str) -> None:
  """Packed collection of COLLECT_CHECK on the CPU and on the card (device
  packing); fails beyond the limits or when the card's collection did not
  launch the splat once a step."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets.carla import CARLADataset  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  dirs, counts = {}, {}
  for dev in ("cpu", "cuda"):
    dirs[dev] = os.path.join(workdir, "collect_check_" + dev)
    bev_cuda.KERNEL.launches = 0
    counts[dev] = CARLADataset.collect_packed("Town02", dirs[dev],
                                              device=dev, device_pack=True,
                                              **COLLECT_CHECK)
  launches = bev_cuda.KERNEL.launches  # the card's collection ran last
  load = lambda dev, key: np.load(os.path.join(dirs[dev], key + ".npy"))  # pylint: disable=unnecessary-lambda-assignment
  lidar = np.abs(load("cpu", "lidar").astype(int) -
                 load("cuda", "lidar").astype(int))
  beyond = float((lidar > COLLECT_COUNT_ATOL).mean())
  errs = {key: float(np.abs(load("cpu", key) - load("cuda", key)).max())
          for key in ("player_past", "player_future", "location")}
  print("check collect_packed card vs cpu (Town02, {}): samples {} / {}; "
        "lidar max count diff {} (share beyond {}: {}, limit {}); {} (limit "
        "{} m); bev_splat launches on the card {} for {} steps".format(
            COLLECT_CHECK, counts["cpu"], counts["cuda"], int(lidar.max()),
            COLLECT_COUNT_ATOL, beyond, COLLECT_BEYOND_FRACTION,
            " ".join("{}_max_abs_diff={}".format(k, v)
                     for k, v in errs.items()), COLLECT_ATOL, launches,
            COLLECT_CHECK["num_steps"]))
  if counts["cpu"] != counts["cuda"] or not counts["cpu"]:
    fail("the card's collection gave {} samples, the CPU's {}".format(
        counts["cuda"], counts["cpu"]))
  if beyond >= COLLECT_BEYOND_FRACTION or max(errs.values()) > COLLECT_ATOL:
    fail("the card's packed collection disagrees with the CPU's")
  if launches != COLLECT_CHECK["num_steps"]:
    fail("bev_splat launched {} times in a {}-step collection".format(
        launches, COLLECT_CHECK["num_steps"]))


def update_batch(b: int = UPDATE_BATCH, size: int = UPDATE_SIZE,
                 seed: int = 1):
  """A packed-format batch of ``b``: dense uint8 ``size`` x ``size``
  LIDAR, forward-moving futures, some stopped scenes."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  rs = np.random.RandomState(seed)
  speed = rs.uniform(0, 8, (b, 1)) * (rs.uniform(size=(b, 1)) < 0.8)
  steps = np.cumsum(rs.uniform(0.5, 1.5, (b, 80, 3)) * [0.1, 0.02, 0],
                    axis=1) * np.maximum(speed, 0.05)[:, :, None]
  return dict(
      lidar=rs.randint(0, 256, (b, size, size, 2)).astype(np.uint8),
      is_at_traffic_light=rs.randint(0, 2, (b, 1)).astype(np.float32),
      traffic_light_state=rs.randint(0, 3, (b, 1)).astype(np.float32),
      velocity=np.concatenate([speed, rs.normal(0, 0.3, (b, 1)),
                               np.zeros((b, 1))], -1).astype(np.float32),
      player_future=steps.astype(np.float32))


def check_updates_card_against_cpu() -> None:
  """One update of each trainer's loss on the CPU and on the card from the
  same weights, batch and key; fails beyond the limits."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.cil import train as cil_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.rip import train as rip_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import BehaviouralModel, ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel

  def gen(k=0):
    return torch.Generator().manual_seed(k)

  trainers = {
      "dim": (lambda dev: ImitativeModel((4, 2), UPDATE_INPUT, generator=gen(),
                                         device=dev),
              dim_train.make_loss_fn()),
      "cil": (lambda dev: BehaviouralModel((40, 2), UPDATE_INPUT,
                                           generator=gen(), device=dev),
              cil_train.make_loss_fn()),
      "rip K=2": (lambda dev: torch.nn.ModuleList([
          ImitativeModel((4, 2), UPDATE_INPUT, generator=gen(k), device=dev)
          for k in range(2)]), rip_train.make_loss_fn(2)),
  }
  batch = update_batch()
  for name, (make, loss_fn) in trainers.items():
    out = {}
    for dev in ("cpu", "cuda"):
      key = rng_lib.fold_in(rng_lib.PRNGKey(42, dev), 1)
      probe = make(dev)
      loss_fn(probe, batch, rng_lib.split(key)[1]).backward()
      grads = {k: p.grad.cpu() for k, p in probe.named_parameters()}
      model = make(dev)
      state = dp.TrainState.create(model, dp.adam(model, 1e-3), key)
      state, loss = dp.make_update_fn(loss_fn)(state, batch)
      out[dev] = (float(loss), grads,
                  {k: v.cpu() for k, v in model.state_dict().items()})
    # The CPU's Adam on the card's gradients, from the same weights.
    ref = make("cpu")
    ref_opt = dp.adam(ref, 1e-3)
    for k, p in ref.named_parameters():
      p.grad = out["cuda"][1][k].clone()
    ref_opt.step()
    ref_sd = ref.state_dict()
    (loss_c, g_c, sd_c), (loss_g, g_g, sd_g) = out["cpu"], out["cuda"]
    grad_err = max(float((g_g[k] - g_c[k]).abs().max() /
                         g_c[k].abs().max().clamp_min(1e-30)) for k in g_c)
    step_ok = all(torch.allclose(sd_g[k], ref_sd[k], rtol=UPDATE_RTOL,
                                 atol=UPDATE_ATOL) for k in sd_g)
    excluded = total = 0
    resolved_ok = True
    for k in g_c:
      off = ~torch.isclose(sd_g[k], sd_c[k], rtol=UPDATE_RTOL,
                           atol=UPDATE_ATOL)
      unresolved = g_c[k].abs() < UPDATE_UNRESOLVED * g_c[k].abs().max()
      resolved_ok &= not bool((off & ~unresolved).any())
      excluded += int(off.sum())
      total += off.numel()
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print("check {} update card vs cpu (batch {}, {}x{} LIDAR, input {}): "
          "loss {} / {} rel diff {} (limit {}); grads max scaled diff {} "
          "(limit {}); card step vs CPU Adam on its grads within rtol {} / "
          "atol {}: {}; updated params beyond rtol {} / atol {}: {} of {} "
          "elements, all with |g| below {} of their tensor's largest: {} "
          "(limit {} of the elements)".format(
              name, UPDATE_BATCH, UPDATE_SIZE, UPDATE_SIZE, UPDATE_INPUT,
              loss_c, loss_g, loss_err, UPDATE_LOSS_RTOL, grad_err,
              UPDATE_GRAD_SCALED, UPDATE_RTOL, UPDATE_ATOL, step_ok,
              UPDATE_RTOL, UPDATE_ATOL, excluded, total, UPDATE_UNRESOLVED,
              resolved_ok, UPDATE_UNRESOLVED_FRACTION))
    if (loss_err > UPDATE_LOSS_RTOL or grad_err > UPDATE_GRAD_SCALED or
        not step_ok or not resolved_ok or
        excluded > UPDATE_UNRESOLVED_FRACTION * total):
      fail("one {} update on the card disagrees with the CPU".format(name))


def read_log(path: str) -> list:
  with open(path) as fp:
    return [json.loads(line) for line in fp]


def event_ms(fn) -> float:
  """Median ms of one call of ``fn()`` on CUDA events over TIMED_UPDATES
  calls (after one untimed)."""
  import torch  # pylint: disable=import-outside-toplevel
  fn()
  times = []
  for _ in range(TIMED_UPDATES):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def update_split_ms(loss_fn, model, batch) -> dict:
  """Median ms (``event_ms``) of one whole update of ``model`` on
  ``batch``, of the loss's forward alone, of its forward and backward, and
  of the forward and backward of the MobileNetV2 encoders alone (one, or
  one per member of an ensemble) on the batch's resized LIDAR."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  members = model if isinstance(model, torch.nn.ModuleList) else [model]
  state = dp.TrainState.create(model, dp.adam(model, 1e-3),
                               rng_lib.PRNGKey(7, "cuda"))
  update = dp.make_update_fn(loss_fn)
  key = rng_lib.PRNGKey(0, "cuda")
  params = [p for p in model.parameters() if p.requires_grad]
  images = members[0].transform(dim_train.as_device_batch(
      batch, "cuda"))["visual_features"]
  encoder_params = [p for m in members for p in m.encoder.parameters()]

  def encoders_backward():
    out = sum(m.encoder(images).sum() for m in members)
    return torch.autograd.grad(out, encoder_params)

  return {
      "update": event_ms(lambda: update(state, batch)),
      "forward": event_ms(lambda: loss_fn(model, batch, key)),
      "forward_backward": event_ms(lambda: torch.autograd.grad(
          loss_fn(model, batch, key), params)),
      "encoder_forward_backward": event_ms(encoders_backward),
  }


def collect_sensors() -> tuple:
  """The sensors ``collect_packed`` collects with its default modalities."""
  import inspect  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets import carla  # pylint: disable=import-outside-toplevel
  modalities = inspect.signature(
      carla.CARLADataset.collect_packed).parameters["modalities"].default
  return tuple(sorted(set(modalities) | {"location", "rotation",
                                         "collision"}))


def collect_breakdown() -> None:
  """Where a chunk of the full-width collection spends its time: one
  24-scene chunk of TRAIN_COLLECT's town, traffic and noise, set up, then
  COLLECT_BREAKDOWN_STEPS steps collecting ``collect_packed``'s sensors,
  as many computing the LIDAR alone, as many with no sensor and as many
  with no sensor and a noiseless autopilot (host wall time of graph
  replays after a first rollout that captures, each ended by a fetch),
  then the device packing of the collected steps with their fetch."""
  import inspect  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets import carla  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sim import autopilot_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  modalities = inspect.signature(
      carla.CARLADataset.collect_packed).parameters["modalities"].default
  sensors = collect_sensors()
  t0 = time.perf_counter()
  env = BatchedEnv(TRAIN_TOWN, 24, sensors=sensors,
                   num_vehicles=TRAIN_COLLECT["num_vehicles"], seed=0,
                   auto_reset=False, device="cuda")
  torch.cuda.synchronize()
  setup_s = time.perf_counter() - t0

  def policy(params, states):
    return autopilot_policy(params, states, noise=TRAIN_COLLECT["noise"])

  busy = []

  def step_ms(**kwargs):
    """ms a step of a rollout of replays (the first, untimed, captures the
    step), and the device's busy ms and idle share a step over 16 more."""
    env.rollout(COLLECT_BREAKDOWN_STEPS, **kwargs)
    t0 = time.perf_counter()
    _, out, stats = env.rollout(COLLECT_BREAKDOWN_STEPS, **kwargs)
    enqueued = time.perf_counter()
    float(stats["distance"].sum())
    ms = 1e3 * (time.perf_counter() - t0) / COLLECT_BREAKDOWN_STEPS
    d = profiling.device_busy(lambda: env.rollout(16, **kwargs), 16, ms)
    busy.append("{:.3f} ms busy, idle {:.4f}, host enqueue {:.3f} ms".format(
        d["device_busy_ms_per_step"], d["idle_share"],
        1e3 * (enqueued - t0) / COLLECT_BREAKDOWN_STEPS))
    return ms, out

  collect_ms, collected = step_ms(policy=policy, collect=sensors)
  lidar_ms, _ = step_ms(policy=policy, compute=("lidar",))
  bare_ms, _ = step_ms(policy=policy)
  noiseless_ms, _ = step_ms()
  t0 = time.perf_counter()
  packed = carla._device_pack_windows(collected, modalities, 20, 80, 5)  # pylint: disable=protected-access
  {k: v.cpu() for k, v in packed.items()}  # pylint: disable=expression-not-assigned
  pack_ms = 1e3 * (time.perf_counter() - t0)
  print("training path collection breakdown (one 24-scene chunk, {} "
        "NPCs, noise {}): set-up {:.3f}s; a step {:.3f} ms collecting {} "
        "sensors, {:.3f} ms with the LIDAR alone, {:.3f} ms with none, "
        "{:.3f} ms with none and the autopilot's noise at 0 (host wall time "
        "of graph replays over {} steps each; the device over 16 more "
        "steps each, torch.profiler: {}); device packing of {} steps and "
        "its fetch {:.3f} ms".format(
            TRAIN_COLLECT["num_vehicles"], TRAIN_COLLECT["noise"], setup_s,
            collect_ms, len(sensors), lidar_ms, bare_ms, noiseless_ms,
            COLLECT_BREAKDOWN_STEPS, "; ".join(busy),
            COLLECT_BREAKDOWN_STEPS, pack_ms))


def drive_training_path(workdir: str) -> int:
  """Collection and the three trainers at full width on the card; returns
  the splat's launches in the collection."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned import DIMAgent  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.cil import train as cil_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.rip import train as rip_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks import run as run_cli  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets.carla import CARLADataset  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel

  pack = os.path.join(workdir, "pack")
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  samples = CARLADataset.collect_packed(TRAIN_TOWN, pack, device="cuda",
                                        **TRAIN_COLLECT)
  seconds = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  nbytes = sum(os.path.getsize(os.path.join(pack, f))
               for f in os.listdir(pack))
  env_steps = TRAIN_COLLECT["num_episodes"] * TRAIN_COLLECT["num_steps"]
  chunks = -(-TRAIN_COLLECT["num_episodes"] // 24)
  print("training path collect_packed {} {}: {} samples in {:.3f}s = "
        "{:.1f} env steps/s; bev_splat launches={} ({} chunks x {} steps); "
        "pack {} bytes".format(TRAIN_TOWN, TRAIN_COLLECT, samples, seconds,
                               env_steps / seconds, launches, chunks,
                               TRAIN_COLLECT["num_steps"], nbytes))
  if launches != chunks * TRAIN_COLLECT["num_steps"]:
    fail("bev_splat launched {} times in {} chunks of {} steps".format(
        launches, chunks, TRAIN_COLLECT["num_steps"]))
  if samples < TRAIN_BATCH:
    fail("the collection gave {} samples, fewer than a batch".format(samples))
  collect_breakdown()

  resident, _ = CARLADataset.load_packed_to_device(
      pack, dim_train.MODALITIES, device="cuda")
  batch = {k: v[:TRAIN_BATCH] for k, v in resident.items()}
  runs = (
      # plot_every=0: the card's machine has no matplotlib.
      ("dim", lambda out: dim_train.train(
          pack, out, batch_size=TRAIN_BATCH, num_epochs=DIM_EPOCHS,
          plot_every=0, device="cuda"), "dim_train", "model-best.pt",
       dim_train.make_loss_fn()),
      ("cil", lambda out: cil_train.train(
          pack, out, batch_size=TRAIN_BATCH, num_epochs=1, device="cuda"),
       "cil_train", "model-best.pt", cil_train.make_loss_fn()),
      ("rip K={}".format(RIP_MEMBERS), lambda out: rip_train.train(
          pack, out, num_models=RIP_MEMBERS, batch_size=TRAIN_BATCH,
          num_epochs=1, device="cuda"), "rip_train", "ensemble-best.pt",
       rip_train.make_loss_fn(RIP_MEMBERS)),
  )
  for name, run, log, best, loss_fn in runs:
    out = os.path.join(workdir, name.split()[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained = run(out)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    records = read_log(os.path.join(out, "logs", log + ".jsonl"))
    model = trained.model if isinstance(trained, dp.TrainState) else trained
    split = update_split_ms(loss_fn, model, batch)
    ms = split["update"]
    losses = [r["loss"] for r in records]
    ckpt = os.path.join(out, "ckpts", best)
    print("training path {}: {} epochs, {} updates at batch {} in {:.3f}s "
          "(val included); update median {:.3f} ms on CUDA events ({} "
          "timed) = {:.1f} samples/s; max_memory_allocated {} bytes; epoch "
          "losses {}; val loss {}; checkpoint {} ({} bytes)".format(
              name, len(records), records[-1]["steps"], TRAIN_BATCH, seconds,
              ms, TIMED_UPDATES, 1e3 * TRAIN_BATCH / ms, peak, losses,
              records[-1].get("val_loss"), os.path.relpath(ckpt, workdir),
              os.path.getsize(ckpt) if os.path.exists(ckpt) else None))
    print("training path {} update split at batch {} (CUDA events, median "
          "of {}): forward {:.3f} ms, forward and backward {:.3f} ms, the "
          "optimiser and the rest {:.3f} ms; the encoders' forward and "
          "backward alone {:.3f} ms".format(
              name, TRAIN_BATCH, TIMED_UPDATES, split["forward"],
              split["forward_backward"], ms - split["forward_backward"],
              split["encoder_forward_backward"]))
    if not np.isfinite(losses).all() or not os.path.exists(ckpt):
      fail("the {} trainer's losses are not finite or it wrote no "
           "best checkpoint".format(name))
    if name == "dim" and not losses[-1] < losses[0]:
      fail("DIM's mean NLL did not fall over {} epochs: {}".format(
          DIM_EPOCHS, losses))
  del resident, batch

  args = argparse.Namespace(agent="dim", ckpt=os.path.join(
      workdir, "dim", "ckpts", "model-best.pt"), device="cuda", cpu=False)
  agent_fn = run_cli.make_agent_fn(args)
  env = CARNOVEL(device="cuda").load(SINGLE_SCENE_TASK)
  env.seed(0)
  obs = env.reset()
  agent = agent_fn(env)
  action = agent.act(obs)
  obs, _, _, _ = env.step(action)
  env.close()
  values = action.as_array()
  print("training path: model-best.pt through benchmarks.run's loader into "
        "a DIMAgent, one single-scene step of {} on the card: action "
        "{}".format(SINGLE_SCENE_TASK, np.round(values, 4).tolist()))
  if not np.isfinite(values).all():
    fail("the trained DIM agent's action is not finite")
  return launches


def drive_experiments(workdir: str) -> dict:
  """The experiments on the card over the training path's pack and
  its CIL and K = RIP_MEMBERS RIP checkpoints (linked into the run's
  directory, so nothing is collected or trained again): the pipeline's
  evaluation of EXPERIMENT_POLICIES over the whole CARNOVEL and CoRL2017
  suites, one episode a task at EXPERIMENT_HORIZON steps, row by row;
  the rendered RESULTS.md; one train-in-the-loop round at LOOP_ROUND's
  size.  Returns the splat's launches by row."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.experiments import (pipeline, publish,  # pylint: disable=import-outside-toplevel
                                            train_in_the_loop)
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel

  out = os.path.join(workdir, "experiments")
  os.makedirs(out)
  for name, target in (("packed", "pack"), ("cil", "cil"), ("rip", "rip")):
    os.symlink(os.path.join(workdir, target), os.path.join(out, name))
  suites = pipeline.suites()
  groups = {suite: len({c["town"] for c in tasks.values()})
            for suite, tasks in suites.items()}
  launches = {}
  for suite in ("carnovel", "corl2017"):
    for name in EXPERIMENT_POLICIES:
      bev_cuda.KERNEL.launches = 0
      t0 = time.perf_counter()
      pipeline.evaluate(
          out=out, carnovel_policies=[name] if suite == "carnovel" else [],
          corl_policies=[name] if suite == "corl2017" else [], episodes=1,
          corl_episodes=1, num_models=RIP_MEMBERS,
          horizon=EXPERIMENT_HORIZON, device="cuda")
      seconds = time.perf_counter() - t0
      row = "{}_{}".format(suite, name)
      launches[row] = bev_cuda.KERNEL.launches
      env_steps = len(suites[suite]) * EXPERIMENT_HORIZON
      print("experiments {}: {} tasks x {} steps in {:.3f}s (scene set-up "
            "and captures included) = {:.1f} env steps/s; bev_splat "
            "launches={} ({} town groups)".format(
                row, len(suites[suite]), EXPERIMENT_HORIZON, seconds,
                env_steps / seconds, launches[row], groups[suite]))
      # The autopilot reads privileged state: its rollout synthesises no
      # LIDAR.  Every learned policy splats once a step per town group.
      want = 0 if name == "autopilot" else groups[suite] * EXPERIMENT_HORIZON
      if launches[row] != want:
        fail("bev_splat launched {} times in the {} row ({} expected)"
             .format(launches[row], row, want))
  with open(os.path.join(out, "tables.json")) as fp:
    tables = json.load(fp)
  for suite in ("carnovel", "corl2017"):
    for name in EXPERIMENT_POLICIES:
      summary = tables.get(suite, {}).get(name)
      if summary is None:
        fail("the {} table has no {} row".format(suite, name))
      rates = [summary[k] for k in ("success_rate", "collision_rate",
                                    "timeout_rate")]
      if not all(0.0 <= r <= 1.0 for r in rates):
        fail("the {} {} row has a rate outside [0, 1]: {}".format(
            suite, name, rates))
  path = publish.publish(out, horizon=EXPERIMENT_HORIZON)
  with open(path) as fp:
    rows = [line for line in fp.read().splitlines()
            if line.startswith("| ") and not line.startswith("| Agent")
            and not line.startswith("| Family")]
  print("experiments RESULTS.md ({} table rows): {}".format(
      len(rows), " ".join(rows)))
  launches_round2 = drive_round2_and_publishers(out, groups["carnovel"])

  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  result = train_in_the_loop.run_round(
      0, out=os.path.join(workdir, "loop"), carnovel_episodes=1,
      carnovel_horizon=EXPERIMENT_HORIZON, device="cuda", **LOOP_ROUND)
  seconds = time.perf_counter() - t0
  launches["loop_round"] = bev_cuda.KERNEL.launches
  want = (LOOP_ROUND["num_steps"] + LOOP_ROUND["rollout_steps"] +
          groups["carnovel"] * EXPERIMENT_HORIZON)
  print("experiments train-in-the-loop round 0 ({}; CARNOVEL at {} steps): "
        "{:.3f}s; bev_splat launches={} ({} expected: the collection, the "
        "Town01 rollout and CARNOVEL, one a step); history {}".format(
            LOOP_ROUND, EXPERIMENT_HORIZON, seconds, launches["loop_round"],
            want, result))
  if launches["loop_round"] != want:
    fail("bev_splat launched {} times in the train-in-the-loop round"
         .format(launches["loop_round"]))
  if not (np.isfinite(result["town01_mean_distance_m"]) and
          result["samples"] >= LOOP_ROUND["batch_size"]):
    fail("the train-in-the-loop round's history is not finite or it had "
         "fewer samples than a batch: {}".format(result))
  return launches, launches_round2


def _table_agents(text: str) -> list:
  """The agents of each agent table of a RESULTS.md, in its order."""
  tables, rows = [], None
  for line in text.splitlines():
    if line.startswith("| Agent "):
      rows = []
      tables.append(rows)
    elif line.startswith("| ") and rows is not None and "---" not in line:
      rows.append(line.split(" | ")[0][2:])
    elif not line.startswith("|"):
      rows = None
  return tables


def drive_round2_and_publishers(out: str, groups: int) -> int:
  """(c) ``round2.evaluate`` of ROUND2_POLICY over CARNOVEL at
  ROUND2_HORIZON steps on the experiments' ensemble: its flat
  ``agents_summary.json`` and one splat a step per town group; (d) the
  round-3 and round-4 publishers over the experiments' tables, each
  RESULTS.md checked as it is written (round 3's rows in the order the
  evaluation wrote them, round 4's in ``publish.ORDER``).  Returns the
  round-2 row's splat launches."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.experiments import (publish, publish_r3,
                                            publish_r4, round2)
  from oatomobile_torch.ops import bev_cuda

  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  table = round2.evaluate(out=out, policies=[ROUND2_POLICY],
                          horizon=ROUND2_HORIZON, device="cuda")
  seconds = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  with open(os.path.join(out, "agents_summary.json")) as fp:
    written = json.load(fp)
  summary = written.get(ROUND2_POLICY, {})
  print("round2 {} over CARNOVEL ({} tasks x {} steps, 10 plan steps): "
        "{:.3f}s (scene set-up and captures included); bev_splat launches="
        "{} ({} town groups); agents_summary.json {}".format(
            ROUND2_POLICY, summary.get("episodes"), ROUND2_HORIZON, seconds,
            launches, groups, {k: summary.get(k) for k in (
                "success_rate", "collision_rate", "timeout_rate",
                "mean_distance")}))
  if written != table or list(written) != [ROUND2_POLICY]:
    fail("round2's agents_summary.json holds {}".format(list(written)))
  if not all(0.0 <= summary[k] <= 1.0 for k in (
      "success_rate", "collision_rate", "timeout_rate")):
    fail("the round-2 row has a rate outside [0, 1]: {}".format(summary))
  if launches != groups * ROUND2_HORIZON:
    fail("bev_splat launched {} times in the round-2 row ({} expected)"
         .format(launches, groups * ROUND2_HORIZON))

  with open(os.path.join(out, "tables.json")) as fp:
    tables = json.load(fp)
  labels = lambda names: [publish.POLICY_LABELS[n] for n in names]  # pylint: disable=unnecessary-lambda-assignment
  for name, fn, title, order in (
      ("publish_r3", publish_r3.publish_r3, "# Round-3 agent results\n",
       lambda rows: list(rows)),
      ("publish_r4", publish_r4.publish_r4, "# Round-4 agent results\n",
       lambda rows: [n for n in publish.ORDER if n in rows])):
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
      path = fn(out)
    seconds = time.perf_counter() - t0
    with open(path) as fp:
      text = fp.read()
    want = [labels(order(tables[suite])) for suite in ("carnovel",
                                                       "corl2017")]
    got = _table_agents(text)
    print("{}: {} in {:.3f}s, agent tables {}".format(
        name, os.path.relpath(path, out), seconds, got))
    if not text.startswith(title) or got != want:
      fail("{} wrote {} (tables {} expected)".format(name, got, want))
  return launches


def drive_studies(workdir: str) -> dict:
  """The studies and diagnostics on the card over the experiments'
  directory (phase 15b's links to the training path's pack and
  checkpoints), part by part with each part's seconds and splat
  launches; then the captured diagnostic against its eager loop and the
  learned taxonomy on the card against the CPU.  Returns the splat's
  launches by part."""
  # pylint: disable=import-outside-toplevel
  import numpy as np
  import torch
  from oatomobile_torch.experiments import (pipeline, profile_flow,
                                            rip_sweep, study_dim50)
  from oatomobile_torch.experiments.diag import (busytown, hero_stops, hills,
                                                 hills_viz, learned_failures,
                                                 stalls, town02)
  from oatomobile_torch.ops import bev_cuda

  out = os.path.join(workdir, "experiments")
  carnovel = pipeline.suites()["carnovel"]
  groups = len({c["town"] for c in carnovel.values()})
  family = {t: c for t, c in carnovel.items() if t.startswith(STUDY_FAMILY)}
  seconds, launches = {}, {}

  def part(name, fn, want):
    bev_cuda.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    launches[name] = bev_cuda.KERNEL.launches
    if launches[name] != want:
      fail("bev_splat launched {} times in the {} part ({} expected)".format(
          launches[name], name, want))
    return result

  flow = part("profile_flow", lambda: profile_flow.run(
      PROFILE_FLOW_BATCH, PROFILE_FLOW_ITERS, "cuda", profile=True), 0)
  print("studies profile_flow (best of {}, CUDA events): {}".format(
      PROFILE_FLOW_ITERS, profile_flow.line(flow)))
  if not all(np.isfinite(v) and v > 0 for k, v in flow.items()
             if k.endswith("_ms")):
    fail("profile_flow's times are not finite and positive: {}".format(flow))

  sweep = part("rip_sweep", lambda: rip_sweep.run(
      out=out, variants=STUDY_VARIANTS, num_models=RIP_MEMBERS,
      horizon=STUDY_HORIZON, device="cuda"),
               len(STUDY_VARIANTS) * groups * STUDY_HORIZON)
  dim50 = part("study_dim50", lambda: study_dim50.run(
      out=out, epochs=1, episodes=1, horizon=STUDY_HORIZON, tasks=family,
      batch=TRAIN_BATCH, device="cuda"), STUDY_HORIZON)
  print("studies rip_sweep over CARNOVEL ({} tasks x {} steps): {}".format(
      len(carnovel), STUDY_HORIZON, {k: {m: v[m] for m in (
          "success_rate", "collision_rate", "mean_distance")}
                                     for k, v in sweep.items()}))
  print("studies study_dim50 (1 epoch at batch {}; {} x {} steps): "
        "{}".format(TRAIN_BATCH, STUDY_FAMILY, STUDY_HORIZON, dim50))
  if sorted(sweep) != sorted("{}_{}steps".format(n, k)
                             for n, k in STUDY_VARIANTS):
    fail("rip_sweep.json holds {}".format(sorted(sweep)))
  if not np.isfinite(dim50["best_val_nll"]):
    fail("the 50x50 DIM's best val NLL is not finite")

  diags = (
      ("hero_stops", lambda: hero_stops.run("Town02", DIAG_SCENES,
                                            DIAG_HORIZON, "cuda"),
       hero_stops.report, 0),
      ("stalls", lambda: stalls.run("Town02", DIAG_SCENES, DIAG_HORIZON,
                                    "cuda"), stalls.report, 0),
      ("town02", lambda: town02.run("Town02", 1, DIAG_HORIZON, "cuda"),
       town02.report, 0),
      ("busytown", lambda: busytown.run(1, DIAG_HORIZON, device="cuda"),
       lambda r: busytown.report(r).splitlines()[:9], 0),
      ("hills", lambda: hills.run(1, DIAG_HORIZON, device="cuda"),
       lambda r: hills.report(r).splitlines()[:3], 0),
      ("learned_failures", lambda: learned_failures.run(
          "rip_wcm", "corl2017", "Town01", 1, DIAG_HORIZON, ckpt_root=out,
          device="cuda"), learned_failures.report, DIAG_HORIZON),
      ("hills_viz", lambda: hills_viz.run(1, DIAG_HORIZON, device="cuda"),
       lambda r: ["crash snapshots of {} scenes".format(
           int(r["m"]["collided"].sum()))], 0),
  )
  results = {}
  for name, run, report, want in diags:
    results[name] = part(name, run, want)
    print("diag {} ({} steps, {:.3f}s, bev_splat launches={}): {}".format(
        name, DIAG_HORIZON, seconds[name], launches[name],
        " | ".join(line.strip() for line in report(results[name]) if line)))

  # The captured diagnostic step against its eager loop, bit for bit.
  t0 = time.perf_counter()
  eager = hero_stops.run("Town02", DIAG_SCENES, DIAG_HORIZON, "cuda",
                         eager=True)
  seconds["hero_stops eager"] = time.perf_counter() - t0
  got = results["hero_stops"]["m"]
  differing = [k for k in got if not np.array_equal(got[k], eager["m"][k])]
  print("diag hero_stops captured against eager ({} scenes x {} steps): "
        "bit-equal {} ({:.3f}s captured, {:.3f}s eager)".format(
            DIAG_SCENES, DIAG_HORIZON, not differing, seconds["hero_stops"],
            seconds["hero_stops eager"]))
  if differing:
    fail("the captured hero_stops differs from its eager loop in {}".format(
        differing))

  # The learned taxonomy on the card against the CPU.
  tasks = learned_failures.suite_tasks("corl2017", "Town01", DIAG_CHECK_TASKS)
  bridge = json.loads(pipeline.BRIDGE)
  m = {}
  for device in ("cpu", "cuda"):
    policy = learned_failures.build_policy("rip_wcm", out, bridge, device)
    m[device] = learned_failures.rollout(policy, "Town01",
                                         list(tasks.values()), 1,
                                         DIAG_CHECK_STEPS, device)
  exact = [k for k in m["cpu"] if m["cpu"][k].dtype.kind != "f"]
  floats = [k for k in m["cpu"] if m["cpu"][k].dtype.kind == "f"]
  differing = [k for k in exact if not np.array_equal(m["cpu"][k],
                                                      m["cuda"][k])]
  float_err = max(float(np.abs(m["cpu"][k] - m["cuda"][k]).max())
                  for k in floats)
  print("diag learned_failures rip_wcm card against CPU ({} tasks x {} "
        "steps): integers and flags equal {}, floats max_abs_diff {} "
        "(bit-equal {})".format(DIAG_CHECK_TASKS, DIAG_CHECK_STEPS,
                                not differing, float_err, float_err == 0))
  if differing or float_err > DIAG_FLOAT_ATOL:
    fail("learned_failures on the card differs from the CPU: {} {}".format(
        differing, float_err))
  print("studies and diagnostics seconds: {}; bev_splat launches: {}".format(
      ", ".join("{} {:.3f}".format(k, v) for k, v in seconds.items()),
      launches))
  return launches


def _max_diff(a, b) -> float:
  """Largest |a - b| (float tensors) or count of differing elements."""
  if a.shape != b.shape:
    return float("inf")
  if a.dtype.is_floating_point:
    return float((a - b).abs().max()) if a.numel() else 0.0
  return float((a != b).sum())


def compare_eager_and_graph(name: str, scenes: int, steps: int,
                            profile_steps: int, run, profile,
                            splats: bool) -> None:
  """Eager and graph runs of one path in turn, GRAPH_PAIRS pairs of
  ``steps`` steps: ``run(mode, steps)`` runs the path from its initial
  state and returns a dict of tensors; ``profile(mode, steps)`` runs
  ``steps`` more steps for the profiler (the graph already captured).
  Fails unless every run equals the first bit for bit, and, where the
  path ``splats``, every graph run launched the splat once a step."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  graphs.captures, graphs.capture_seconds, graphs.capture_bytes = 0, 0.0, 0
  ms = {"eager": [], "graph": []}
  launches, diffs, first = [], {}, None
  t0 = time.perf_counter()
  for _ in range(GRAPH_PAIRS):
    for mode in ms:
      bev_cuda.KERNEL.launches = 0
      result, seconds = profiling.timed(run, mode, steps)
      ms[mode].append(1e3 * seconds / steps)
      if mode == "graph":
        launches.append(bev_cuda.KERNEL.launches)
      if first is None:
        first = result
        continue
      for key, value in result.items():
        diff = _max_diff(value, first[key])
        if diff:
          diffs[key] = max(diffs.get(key, 0.0), diff)
  t1 = time.perf_counter()
  # The graph's replays alone: a run that captures holds the capture too.
  _, seconds = profiling.timed(profile, "graph", steps)
  t2 = time.perf_counter()
  step_ms = {"eager": statistics.median(ms["eager"]),
             "graph": 1e3 * seconds / steps}
  device = {}
  for mode in GRAPH_PROFILE_MODES:
    device[mode] = profiling.device_busy(
        lambda m=mode: profile(m, profile_steps), profile_steps,
        step_ms[mode])
    source = "torch.profiler kernel records"
    if device[mode]["kernels_per_step"] == 0:
      # The profiler saw no kernel: the span of a run on CUDA events.
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      profile(mode, profile_steps)
      end.record()
      end.synchronize()
      busy = start.elapsed_time(end) / profile_steps
      device[mode].update(device_busy_ms_per_step=busy, idle_share=1.0 - busy /
                          device[mode]["step_ms"])
      source = "CUDA events around the steps (the profiler saw no kernel)"
    device[mode]["source"] = source
  for part, seconds in (("runs in turn", t1 - t0), ("replays alone", t2 - t1),
                        ("profiler passes", time.perf_counter() - t2)):
    GRAPH_SPLIT[part] = GRAPH_SPLIT.get(part, 0.0) + seconds
  print("compiled rollout, {} ({} scenes, {} steps a run, {} pairs in turn, "
        "eager then graph): ms a step eager {} / graph {} (a graph run that "
        "captures holds {} eager warm-up steps and the capture); env steps/s "
        "eager {} / graph {}; then {} steps of replays alone {:.3f} ms a "
        "step = {:.1f} env steps/s; {} captures in {:.3f}s, {} bytes "
        "reserved; bit-equal over the {} runs: {}{}; splat launches per "
        "graph run {}"
        .format(name, scenes, steps, GRAPH_PAIRS,
                [round(t, 3) for t in ms["eager"]],
                [round(t, 3) for t in ms["graph"]], graphs.WARMUP_STEPS,
                [round(1e3 * scenes / t, 1) for t in ms["eager"]],
                [round(1e3 * scenes / t, 1) for t in ms["graph"]], steps,
                step_ms["graph"], 1e3 * scenes / step_ms["graph"],
                graphs.captures, graphs.capture_seconds, graphs.capture_bytes,
                2 * GRAPH_PAIRS, not diffs,
                " (max differences {})".format(diffs) if diffs else "",
                launches))
  for mode, d in device.items():
    print("compiled rollout, {} device over {} {} steps ({}): busy {:.4f} ms "
          "a step, {:.1f} kernels a step, idle share {:.4f} of a {:.3f} ms "
          "step (eager: the runs' median; graph: the replays alone)".format(name, profile_steps, mode, d["source"],
                                  d["device_busy_ms_per_step"],
                                  d["kernels_per_step"], d["idle_share"],
                                  d["step_ms"]))
  if diffs:
    fail("the graph replays of the {} path differ from the eager loop: "
         "{}".format(name, diffs))
  if splats and launches != [steps] * GRAPH_PAIRS:
    fail("bev_splat launched {} times in graph runs of {} {} steps".format(
        launches, steps, name))


def drive_compiled_paths() -> None:
  """The compiled rollout against the eager loop on the autopilot bench,
  a collection chunk, the CARNOVEL Town04 group and the DIM path."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import bench  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks import batched_eval  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sim import autopilot_policy  # pylint: disable=import-outside-toplevel
  GRAPH_SPLIT.clear()
  t_start = time.perf_counter()

  def env_paths(env, **kwargs):
    def rollout(mode, steps):
      fn = env.rollout if mode == "graph" else env._rollout_eager  # pylint: disable=protected-access
      return fn(steps, **kwargs)

    def run(mode, steps):
      env.reset()
      # reset() synthesises the env's sensors (the LIDAR among them for
      # the collection): count the rollout's launches only.
      bev_cuda.KERNEL.launches = 0
      _, collected, stats = rollout(mode, steps)
      return {**(collected or {}), **{"stats_" + k: v
                                      for k, v in stats.items()}}

    return run, rollout

  def noisy(params, states):
    return autopilot_policy(params, states, noise=TRAIN_COLLECT["noise"])

  def autopilot(params, states):
    return autopilot_policy(params, states, noise=0.0)

  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  compare_eager_and_graph(
      "autopilot bench (Town01, 16 NPCs, compute=lidar)", BATCH,
      GRAPH_STEPS["autopilot"], GRAPH_PROFILE_STEPS["autopilot"],
      *env_paths(env, compute=("lidar",)), splats=True)

  sensors = collect_sensors()
  env = BatchedEnv(TRAIN_TOWN, 24, sensors=sensors,
                   num_vehicles=TRAIN_COLLECT["num_vehicles"], seed=0,
                   auto_reset=False, device="cuda")
  compare_eager_and_graph(
      "collection chunk (Town01, 16 NPCs, noise {}, {} sensors "
      "collected)".format(TRAIN_COLLECT["noise"], len(sensors)), 24,
      GRAPH_STEPS["collection"], GRAPH_PROFILE_STEPS["collection"],
      *env_paths(env, policy=noisy, collect=sensors), splats=True)
  del env

  configs = [c for _, c in sorted(_TASKS.items())
             if c["town"] == CARNOVEL_GRAPH_TOWN]
  params, states = batched_eval.town_group_scenes(CARNOVEL_GRAPH_TOWN,
                                                  configs, device="cuda")
  last = {}

  def run_eval(mode, steps):
    with torch.no_grad():
      if mode == "eager":
        return batched_eval._episode_metrics_rollout_eager(  # pylint: disable=protected-access
            params, states, autopilot, steps)[1]
      last["rollout"] = batched_eval._MetricsRollout(  # pylint: disable=protected-access
          params, states, autopilot)
      last["rollout"].run(steps)
      return {k: v.clone() for k, v in last["rollout"].metrics.items()}

  def profile_eval(mode, steps):
    """The metrics after ``steps`` more steps (``timed`` fetches them)."""
    with torch.no_grad():
      if mode == "eager":
        return batched_eval._episode_metrics_rollout_eager(  # pylint: disable=protected-access
            params, states, autopilot, steps)[1]
      last["rollout"].run(steps)
      return last["rollout"].metrics

  compare_eager_and_graph(
      "CARNOVEL {} group ({} tasks, configured traffic, autopilot)".format(
          CARNOVEL_GRAPH_TOWN, len(configs)), len(configs),
      GRAPH_STEPS["carnovel"], GRAPH_PROFILE_STEPS["carnovel"], run_eval,
      profile_eval, splats=False)
  del last, params, states

  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  compare_eager_and_graph(
      "DIM path (Town01, 16 NPCs, 20 plan steps)", BATCH, GRAPH_STEPS["dim"],
      GRAPH_PROFILE_STEPS["dim"],
      *env_paths(env, policy=bench.dim_policy(100, "float32", device="cuda")),
      splats=True)
  del env
  torch.cuda.empty_cache()
  GRAPH_SPLIT["set-up"] = time.perf_counter() - t_start - sum(
      GRAPH_SPLIT.values())
  print("compiled rollout, seconds by part over the four paths: {}".format(
      ", ".join("{} {:.1f}".format(k, v) for k, v in GRAPH_SPLIT.items())))


def check_cameras_card_against_cpu() -> None:
  """The four camera class images and the 64 m game state of
  CAMERA_CHECK's Town01 scenes, and the whole-town game state of one
  Town02 scene, on the card and on the CPU from the same state; fails
  where more than CAMERA_PIXEL_FRACTION of the pixels differ."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sensors import cameras, synth  # pylint: disable=import-outside-toplevel

  check = dict(CAMERA_CHECK)
  env = BatchedEnv(TOWN, check.pop("batch_size"), device="cpu", **check)
  env.rollout(20)
  town02 = BatchedEnv("Town02", 1, num_vehicles=8, num_pedestrians=4,
                      seed=0, device="cpu")
  town02.rollout(20)
  images = {
      **{"camera yaw {:g}".format(yaw): (
          env, lambda p, s, yaw=yaw: cameras.camera_classes(p, s, yaw))
         for yaw in synth.CAMERA_YAW_OFFSETS.values()},
      "game_state": (env, synth.game_state),
      "full_town_game_state Town02": (town02, synth.full_town_game_state),
  }
  fractions = {}
  for name, (source, fn) in images.items():
    out = [fn(source.params.to(dev), source.state.to(dev)).cpu()
           for dev in ("cpu", "cuda")]
    differ = out[0] != out[1]
    if differ.dim() == 4:  # masks: a pixel differs where any channel does
      differ = differ.any(-1)
    fractions[name] = float(differ.float().mean())
    if not torch.isin(out[0], out[1]).all():
      fractions[name] = float("inf")  # a class missing on the card
  print("check cameras and game state card vs cpu (Town01, {} scenes, {} "
        "NPCs, {} pedestrians, after 20 autopilot steps; the whole town on "
        "one Town02 scene): differing pixel fractions {} (limit {})".format(
            CAMERA_CHECK["batch_size"], CAMERA_CHECK["num_vehicles"],
            CAMERA_CHECK["num_pedestrians"], fractions,
            CAMERA_PIXEL_FRACTION))
  if max(fractions.values()) > CAMERA_PIXEL_FRACTION:
    fail("the cameras or the game state on the card disagree with the CPU")


def camera_bound_ms(state, walls: int, per_pixel: bool = False) -> tuple:
  """Least time of one ``camera_classes`` call on an H100: the class
  image's bytes written once (the state's few bytes aside) over the memory
  rate, or the operations over the FP32 rate: the slab tests against the
  wall, vehicle and pedestrian slots, once per column as the port does
  them (or once per pixel, ``per_pixel``, as the JAX module writes them),
  and the per-pixel ground and depth work."""
  from oatomobile_torch.sensors import cameras  # pylint: disable=import-outside-toplevel
  B, H, W = state.batch_size, cameras.IMAGE_H, cameras.IMAGE_W
  slots = (walls + min(cameras.MAX_CAMERA_VEHICLES, state.num_npcs) +
           min(cameras.MAX_CAMERA_PEDS, state.num_pedestrians))
  rays = B * W * (H if per_pixel else 1)
  ops = rays * slots * CAMERA_OPS_PER_SLAB + B * H * W * CAMERA_OPS_PER_PIXEL
  bytes_ms = 1e3 * B * H * W * 4 / PEAK_BYTES_PER_S
  ops_ms = 1e3 * ops / PEAK_FP32_PER_S
  return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                 else "operations")


def drive_camera_rollout() -> int:
  """The 1024-scene autopilot rollout with the front camera and the LIDAR
  computed every step: a capturing warm-up, a timed run of replays, the
  device's busy time; then one camera call timed beside its bound.
  Returns the splat's launches in the timed run."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sensors import cameras  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel

  compute = ("front_camera_rgb", "lidar")
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  graphs.capture_seconds, graphs.capture_bytes = 0.0, 0
  _, _, s = env.rollout(CAMERA_STEPS, compute=compute)
  float(s["distance"].sum())
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  _, _, s = env.rollout(CAMERA_STEPS, compute=compute)
  float(s["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  peak = torch.cuda.max_memory_allocated()
  step_ms = 1e3 * elapsed / CAMERA_STEPS
  d = profiling.device_busy(lambda: env.rollout(8, compute=compute), 8,
                            step_ms)
  s = {k: v.cpu() for k, v in s.items()}
  finite = all(bool(torch.isfinite(v.float()).all()) for v in s.values())
  print("camera rollout: {} x {} steps (Town01, {} NPCs, compute={}) in "
        "{:.3f}s = {:.3f} ms a step = {:.1f} env steps/s (graph replays); "
        "the step captured in {:.3f}s, {} bytes reserved for its pool; "
        "max_memory_allocated {} bytes; bev_splat launches={}; device over "
        "8 more steps (torch.profiler): busy {:.4f} ms a step, {:.1f} "
        "kernels a step, idle share {:.4f}; stats finite={} checksum_min="
        "{:.1f}".format(
            BATCH, CAMERA_STEPS, VEHICLES, compute, elapsed, step_ms,
            BATCH * CAMERA_STEPS / elapsed, graphs.capture_seconds,
            graphs.capture_bytes, peak, launches,
            d["device_busy_ms_per_step"], d["kernels_per_step"],
            d["idle_share"], finite, float(s["obs_checksum"].min())))
  if launches != CAMERA_STEPS:
    fail("bev_splat launched {} times in {} camera rollout steps".format(
        launches, CAMERA_STEPS))
  if not finite or not bool((s["obs_checksum"] > 0).all()):
    fail("the camera rollout's stats are not finite or a checksum is 0")

  params, state = env.params, env.state
  walls = min(cameras.MAX_CAMERA_WALLS, params.map["wall_rects"].shape[0])
  ms = cuda_ms(lambda: cameras.camera_classes(params, state, 0.0), calls=2)
  bound_ms, bound_by = camera_bound_ms(state, walls)
  pixel_ms, pixel_by = camera_bound_ms(state, walls, per_pixel=True)
  print("timing camera_classes B={} (CUDA events, 2 calls a run, median of "
        "21): {:.4f} ms; bound {:.4f} ms ({}) for the port's work (slab "
        "tests per column), {:.4f} ms ({}) with the slab tests per pixel "
        "as the JAX module writes them; {:.2%} of the camera rollout's "
        "{:.3f} ms step".format(BATCH, ms, bound_ms, bound_by, pixel_ms,
                                pixel_by, ms / step_ms, step_ms))
  del env, params, state
  torch.cuda.empty_cache()
  return launches


def drive_camera_collection(workdir: str) -> int:
  """collect_packed with the front camera and the game state among its
  modalities; returns the splat's launches."""
  import inspect  # pylint: disable=import-outside-toplevel
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets import carla  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel

  modalities = inspect.signature(
      carla.CARLADataset.collect_packed).parameters["modalities"].default
  modalities = tuple(modalities) + ("front_camera_rgb", "game_state")
  out = os.path.join(workdir, "camera_pack")
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  samples = carla.CARLADataset.collect_packed(
      TOWN, out, modalities=modalities, device="cuda", **CAMERA_COLLECT)
  seconds = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  shapes = {key: np.load(os.path.join(out, key + ".npy"), mmap_mode="r")
            for key in ("front_camera_rgb", "game_state")}
  env_steps = CAMERA_COLLECT["num_episodes"] * CAMERA_COLLECT["num_steps"]
  print("camera collection collect_packed {} {} modalities {}: {} samples "
        "in {:.3f}s = {:.1f} env steps/s; bev_splat launches={}; {}".format(
            TOWN, CAMERA_COLLECT, modalities, samples, seconds,
            env_steps / seconds, launches, ", ".join(
                "{} {} {}".format(k, tuple(v.shape), v.dtype)
                for k, v in shapes.items())))
  if launches != CAMERA_COLLECT["num_steps"]:
    fail("bev_splat launched {} times in a {}-step collection".format(
        launches, CAMERA_COLLECT["num_steps"]))
  if not samples or any(v.shape[0] != samples or v.dtype != np.uint8
                        for v in shapes.values()):
    fail("the camera collection wrote no samples or malformed images")
  return launches


def drive_camera_single_scene() -> int:
  """A CARNOVEL task with the front camera and the game state among its
  sensors, the AutopilotAgent for CAMERA_SINGLE_SCENE_STEPS steps and
  ``render("human")`` after the reset and every step; returns the
  splat's launches."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.rulebased import AutopilotAgent  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.simulators.cuda import defaults  # pylint: disable=import-outside-toplevel

  sensors = tuple(defaults.CARLA_SENSORS) + ("front_camera_rgb",
                                             "game_state")
  env = CARNOVEL(device="cuda").load(SINGLE_SCENE_TASK, sensors=sensors)
  env.seed(0)
  bev_cuda.KERNEL.launches = 0
  bad = []
  t0 = time.perf_counter()
  obs = env.reset()
  frames = [env.render(mode="human")]
  agent = AutopilotAgent(env)
  for _ in range(CAMERA_SINGLE_SCENE_STEPS):
    obs, _, _, _ = env.step(agent.act(obs))
    frames.append(env.render(mode="human"))
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  env.close()
  for i, frame in enumerate(frames):
    if (frame.dtype != np.uint8 or frame.shape != (276, 720, 3) or
        not frame[:240].any()):
      bad.append(i)
  print("camera single scene {} (sensors {}): AutopilotAgent {} steps with "
        "render('human') after the reset and each step in {:.3f}s = {:.1f} "
        "steps/s (reset and its warm-up included); bev_splat launches={}; "
        "frames {} x {} {}, empty or malformed: {}; last front_camera_rgb "
        "{} game_state {} (channel sums {})".format(
            SINGLE_SCENE_TASK, ",".join(sensors), CAMERA_SINGLE_SCENE_STEPS,
            elapsed, CAMERA_SINGLE_SCENE_STEPS / elapsed, launches,
            len(frames), frames[0].shape, frames[0].dtype, bad,
            obs["front_camera_rgb"].shape, obs["game_state"].shape,
            obs["game_state"].sum((0, 1)).tolist()))
  if bad:
    fail("render('human') gave empty or malformed frames {}".format(bad))
  if launches != 2 * (CAMERA_SINGLE_SCENE_STEPS + 1):
    fail("bev_splat launched {} times in a {}-step single scene with the "
         "human render (two a step and two at reset expected)".format(
             launches, CAMERA_SINGLE_SCENE_STEPS))
  return launches


def mesh_dim_update(mesh, batch) -> tuple:
  """One DIM update at published widths (weights from generator 0, the
  trainer's first key) over ``mesh`` (None: unsharded): (loss, the global
  gradients, the updated parameters), on the CPU."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import mesh as mesh_lib  # pylint: disable=import-outside-toplevel
  device = "cuda" if mesh is None else mesh.device
  model = ImitativeModel((4, 2), (100, 100),
                         generator=torch.Generator().manual_seed(0),
                         device=device)
  loss_fn = dim_train.make_loss_fn()
  key = rng_lib.fold_in(rng_lib.PRNGKey(42, device), 1)
  # The global gradient, as the update takes it.
  params = list(model.parameters())
  step_key = rng_lib.split(key)[1]
  if mesh is None:
    loss = loss_fn(model, batch, step_key)
  else:
    total = len(batch["lidar"])
    with mesh_lib.global_rows(*mesh_lib.batch_rows(mesh, total), total):
      loss = loss_fn(model, mesh_lib.shard_batch(mesh, batch), step_key)
  grads = list(torch.autograd.grad(loss, params))
  if mesh is not None:
    dp._all_reduce_mean_(mesh, grads)  # pylint: disable=protected-access
  grads = {n: g.cpu() for (n, _), g in zip(model.named_parameters(), grads)}
  state = dp.replicate_state(mesh, dp.TrainState.create(
      model, dp.adam(model, 1e-3), key))
  state, loss = dp.make_update_fn(loss_fn, mesh=mesh)(state, batch)
  return float(loss), grads, {k: v.cpu() for k, v in
                              model.state_dict().items()}


def compare_updates(got: tuple, want: tuple) -> tuple:
  """(loss rel diff, grads' largest scaled diff, parameters beyond
  UPDATE_RTOL / UPDATE_ATOL, of them with a resolved gradient, elements)
  of two ``mesh_dim_update`` results."""
  import torch  # pylint: disable=import-outside-toplevel
  (loss_a, g_a, sd_a), (loss_b, g_b, sd_b) = got, want
  grad_err = max(float((g_a[k] - g_b[k]).abs().max() /
                       g_b[k].abs().max().clamp_min(1e-30)) for k in g_b)
  off = resolved_off = total = 0
  for k in g_b:
    bad = ~torch.isclose(sd_a[k], sd_b[k], rtol=UPDATE_RTOL,
                         atol=UPDATE_ATOL)
    resolved = g_b[k].abs() >= UPDATE_UNRESOLVED * g_b[k].abs().max()
    off += int(bad.sum())
    resolved_off += int((bad & resolved).sum())
    total += bad.numel()
  return abs(loss_a - loss_b) / abs(loss_b), grad_err, off, resolved_off, \
      total


def _state_summary(env, final, stats) -> dict:
  """The rollout's returns a mesh must gather, and the final LIDAR, on
  the CPU (the LIDAR of this rank's scenes, gathered under a mesh)."""
  from oatomobile_torch.parallel import mesh as mesh_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sensors import synth  # pylint: disable=import-outside-toplevel
  lidar = synth.lidar(env.params, env._state)  # pylint: disable=protected-access
  if env.mesh is not None:
    lidar = mesh_lib.gather_batch(env.mesh, lidar)
  out = {"hero_xy": final.hero_xy, "npc_xy": final.npc_xy, "rng": final.rng,
         "lidar": lidar, **{"stats_" + k: v for k, v in stats.items()}}
  return {k: v.cpu() for k, v in out.items()}


def drive_mesh_world_one() -> tuple:
  """(a) NCCL at world size 1 on the card: ``BatchedEnv(mesh=make_mesh())``
  against the mesh-less env (the 1024-scene autopilot path with the LIDAR,
  MESH_STEPS steps), and one DIM update with ``mesh=`` against one
  without, bit for bit; then ``entry.dryrun`` in the same process group
  (its four lines, the 1x1 mesh's numbers, a finite loss, one splat a
  rollout step).  Returns the splat's launches in the mesh rollout and in
  the dry run."""
  import datetime  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  import torch.distributed as dist  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import entry  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import mesh as mesh_lib  # pylint: disable=import-outside-toplevel
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as store:
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(store, "store"),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_SECONDS))
    try:
      mesh = mesh_lib.make_mesh()
      runs, seconds = {}, {}
      for name, m in (("mesh", mesh), ("plain", None)):
        env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES,
                         route_capacity=1024, seed=0, mesh=m, device="cuda")
        bev_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        final, _, stats = env.rollout(MESH_STEPS, compute=("lidar",))
        float(stats["distance"].sum())
        seconds[name] = time.perf_counter() - t0
        if name == "mesh":
          launches = bev_cuda.KERNEL.launches
        runs[name] = _state_summary(env, final, stats)
        del env, final, stats
      diffs = {k: _max_diff(runs["mesh"][k], runs["plain"][k])
               for k in runs["plain"]}
      # The update on the card is deterministic with cuDNN's deterministic
      # algorithms, so the two must be equal bit for bit.
      deterministic = torch.backends.cudnn.deterministic
      torch.backends.cudnn.deterministic = True
      try:
        batch = update_batch(MESH_UPDATE_BATCH, 200, seed=2)
        with_mesh = mesh_dim_update(mesh, batch)
        without = mesh_dim_update(None, batch)
      finally:
        torch.backends.cudnn.deterministic = deterministic
      update_equal = (with_mesh[0] == without[0] and all(
          torch.equal(a, b) for i in (1, 2)
          for a, b in zip(with_mesh[i].values(), without[i].values())))
      backend = dist.get_backend()
      # The dry run over the same group (its mesh from the world: 1x1).
      printed = io.StringIO()
      bev_cuda.KERNEL.launches = 0
      t0 = time.perf_counter()
      with contextlib.redirect_stdout(printed):
        dry = entry.dryrun(device="cuda")
      dry_seconds = time.perf_counter() - t0
      dry_launches = bev_cuda.KERNEL.launches
    finally:
      dist.destroy_process_group()
  print("mesh (a) {} at world size 1, mesh {}: {} scenes x {} steps with "
        "the LIDAR (first rollout: capture included) {:.3f}s with the mesh, "
        "{:.3f}s without; bev_splat launches with the mesh={}; bit-equal "
        "(final state, stats, final LIDAR): {}{}; one DIM update (batch {}, "
        "published widths) with mesh= and without bit-equal: {} (loss {})"
        .format(backend, mesh.shape, BATCH, MESH_STEPS, seconds["mesh"],
                seconds["plain"], launches, not any(diffs.values()),
                "" if not any(diffs.values()) else " (max differences "
                "{})".format(diffs), MESH_UPDATE_BATCH, update_equal,
                with_mesh[0]))
  if any(diffs.values()) or not update_equal:
    fail("the world-size-1 mesh disagrees with the mesh-less run")
  if launches != MESH_STEPS:
    fail("bev_splat launched {} times in {} mesh steps".format(launches,
                                                               MESH_STEPS))
  lines = printed.getvalue().splitlines()
  for line in lines:
    print("mesh (a) dryrun | " + line)
  print("mesh (a) dryrun over {} at world size 1 in the same group: {} in "
        "{:.3f}s (capture included); bev_splat launches={} ({} rollout "
        "steps)".format(backend, {k: v for k, v in dry.items()},
                        dry_seconds, dry_launches, DRYRUN_STEPS))
  heads = [line.split(":")[0] for line in lines]
  if heads != ["rollout", "collect", "train", "dryrun_multichip OK"]:
    fail("the dry run printed {}".format(lines))
  if any(dry[k] != v for k, v in DRYRUN.items()):
    fail("the dry run's numbers {} are not the 1x1 mesh's {}".format(
        dry, DRYRUN))
  if not (dry["loss"] == dry["loss"] and abs(dry["loss"]) < float("inf")):
    fail("the dry run's loss is not finite")
  if dry_launches != DRYRUN_STEPS:
    fail("bev_splat launched {} times in the dry run's {} steps".format(
        dry_launches, DRYRUN_STEPS))
  return launches, dry_launches


def mesh_rank(rank: int, world: int, store: str, out: str) -> None:
  """One spawned rank of (b): gloo on ``cuda:0``; the sharded rollout's
  gathered returns and a dp DIM update, saved to ``out/rank{rank}.pt``."""
  import datetime  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  import torch.distributed as dist  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import mesh as mesh_lib  # pylint: disable=import-outside-toplevel
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dist.init_process_group(
      "gloo", init_method=store, rank=rank, world_size=world,
      timeout=datetime.timedelta(seconds=MESH_TIMEOUT_SECONDS))
  mesh = mesh_lib.make_mesh(device="cuda:0")
  env = BatchedEnv(TOWN, MESH_RANK_SCENES, num_vehicles=VEHICLES,
                   route_capacity=1024, seed=0, mesh=mesh)
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  final, _, stats = env.rollout(MESH_RANK_STEPS, compute=("lidar",))
  seconds = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  result = {"rollout": _state_summary(env, final, stats),
            "launches": launches, "seconds": seconds,
            "shape": mesh.shape, "backend": dist.get_backend(),
            "update": mesh_dim_update(mesh, update_batch(
                MESH_UPDATE_BATCH, 200, seed=2))}
  torch.save(result, os.path.join(out, "rank{}.pt".format(rank)))
  dist.barrier()
  dist.destroy_process_group()


def drive_mesh_two_ranks() -> int:
  """(b) MESH_RANKS spawned ranks on the one card over gloo: the sharded
  autopilot rollout, gathered, against the single process (bit for bit),
  and the dp DIM update against the unsharded one; returns rank 0's
  splat launches."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out:
    store = "file://" + os.path.join(out, "store")
    code = ("import sys; sys.path.insert(0, {!r}); import chip_smoke; "
            "chip_smoke.mesh_rank({{}}, {}, {!r}, {!r})".format(
                root, MESH_RANKS, store, out))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(MESH_RANKS)]
    logs = []
    try:
      for proc in procs:
        logs.append(proc.communicate(
            timeout=max(1.0, MESH_RANK_SECONDS -
                        (time.perf_counter() - t0)))[0].decode())
    except subprocess.TimeoutExpired:
      logs = ["(timed out after {} s)".format(MESH_RANK_SECONDS)]
    finally:
      for proc in procs:
        if proc.poll() is None:
          proc.kill()
          proc.wait()
    spawned = time.perf_counter() - t0
    codes = [proc.returncode for proc in procs]
    if any(codes):
      fail("a mesh rank failed ({}): {}".format(
          codes, "\n".join(log[-3000:] for log in logs)))
    ranks = [torch.load(os.path.join(out, "rank{}.pt".format(r)),
                        weights_only=False) for r in range(MESH_RANKS)]
  env = BatchedEnv(TOWN, MESH_RANK_SCENES, num_vehicles=VEHICLES,
                   route_capacity=1024, seed=0, device="cuda")
  final, _, stats = env.rollout(MESH_RANK_STEPS, compute=("lidar",))
  want = _state_summary(env, final, stats)
  del env, final, stats
  got = ranks[0]["rollout"]
  diffs = {k: _max_diff(got[k], want[k]) for k in want}
  same_on_ranks = all(torch.equal(r["rollout"][k], got[k])
                      for r in ranks[1:] for k in got)
  hero_diff = float((got["hero_xy"] - want["hero_xy"]).abs().max())
  lidar_pixels = int((got["lidar"] != want["lidar"]).any(-1).sum())
  batch = update_batch(MESH_UPDATE_BATCH, 200, seed=2)
  loss_err, grad_err, off, resolved_off, total = compare_updates(
      ranks[0]["update"], mesh_dim_update(None, batch))
  launches = ranks[0]["launches"]
  print("mesh (b) {} ranks on one card over {}, mesh {} each, spawned and "
        "joined in {:.1f}s; {} scenes x {} steps with the LIDAR ({:.3f}s on "
        "rank 0, capture included): gathered against one process: hero_xy "
        "max abs diff {}, final LIDAR differing pixels {}, all returns "
        "bit-equal {}{}; the ranks hold the same global values: {}; "
        "bev_splat launches on rank 0={}".format(
            MESH_RANKS, ranks[0]["backend"], ranks[0]["shape"], spawned,
            MESH_RANK_SCENES, MESH_RANK_STEPS, ranks[0]["seconds"],
            hero_diff, lidar_pixels, not any(diffs.values()),
            "" if not any(diffs.values()) else " (max differences "
            "{})".format(diffs), same_on_ranks, launches))
  print("mesh (b) dp={} DIM update (batch {}, published widths) against "
        "the unsharded one: loss rel diff {} (limit {}); global gradients "
        "max scaled diff {} (limit {}); updated params beyond rtol {} / "
        "atol {}: {} of {} elements, {} of them with |g| at or above {} of "
        "their tensor's largest (limit 0; the rest at most {} of the "
        "elements)".format(MESH_RANKS, MESH_UPDATE_BATCH, loss_err,
                           MESH_UPDATE_RTOL, grad_err, MESH_UPDATE_RTOL,
                           UPDATE_RTOL, UPDATE_ATOL, off, total,
                           resolved_off, UPDATE_UNRESOLVED,
                           UPDATE_UNRESOLVED_FRACTION))
  if any(diffs.values()) or not same_on_ranks:
    fail("the two-rank rollout disagrees with the single process")
  if launches != MESH_RANK_STEPS:
    fail("bev_splat launched {} times in {} steps on rank 0".format(
        launches, MESH_RANK_STEPS))
  if (loss_err > MESH_UPDATE_RTOL or grad_err > MESH_UPDATE_RTOL or
      resolved_off or off > UPDATE_UNRESOLVED_FRACTION * total):
    fail("the dp DIM update disagrees with the unsharded update")
  return launches


class _EagerStep:
  """``graphs.CapturedStep``'s interface, every call eager: the single
  scene's yardstick."""

  def __init__(self, fn, device, pool=None) -> None:
    del device, pool
    self._fn = fn

  def __call__(self):
    return self._fn()


def single_scene_run(eager: bool, steps: int, render: bool) -> dict:
  """The single-scene API on the card: SINGLE_SCENE_TASK with the default
  sensors (and the front camera and the game state with ``render``), the
  AutopilotAgent for ``steps`` steps, ``render("human")`` after the reset
  and every step with ``render``; every step's observations on the host,
  the seconds with and without the reset and the steps' split (each
  part ends in a copy to the host, so the host's clock times it), the
  splat's launches."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.rulebased import AutopilotAgent  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.simulators.cuda import defaults  # pylint: disable=import-outside-toplevel
  sensors = tuple(defaults.CARLA_SENSORS) + (
      ("front_camera_rgb", "game_state") if render else ())
  captured_step = graphs.CapturedStep
  if eager:
    graphs.CapturedStep = _EagerStep
  try:
    env = CARNOVEL(device="cuda").load(SINGLE_SCENE_TASK, sensors=sensors)
    env.seed(0)
    bev_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    obs = env.reset()
    trace = [{k: np.array(v) for k, v in obs.items()}]
    if render:
      trace[-1]["frame"] = env.render(mode="human")
    t1 = time.perf_counter()
    agent = AutopilotAgent(env)
    split = {"agent": 0.0, "env step": 0.0, "render": 0.0}
    for _ in range(steps):
      ta = time.perf_counter()
      action = agent.act(obs)
      tb = time.perf_counter()
      obs, _, done, _ = env.step(action)
      tc = time.perf_counter()
      split["agent"] += tb - ta
      split["env step"] += tc - tb
      trace.append({k: np.array(v) for k, v in obs.items()})
      if render:
        trace[-1]["frame"] = env.render(mode="human")
        split["render"] += time.perf_counter() - tc
      if done:
        break
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = bev_cuda.KERNEL.launches
    env.close()
  finally:
    graphs.CapturedStep = captured_step
  n = len(trace) - 1
  return {"trace": trace, "seconds": t2 - t0, "step_seconds": t2 - t1,
          "steps": n, "launches": launches,
          "split_ms": {k: round(1e3 * v / n, 3) for k, v in split.items()
                       if v}}


def compare_single_scene() -> int:
  """(c) The captured single scene against the eager one from the same
  seed, without and with the human render: every step's observations
  (and frames) bit for bit, the steps/s of each; returns the captured
  run's splat launches (autopilot, no render)."""
  import numpy as np  # pylint: disable=import-outside-toplevel
  launches = None
  for render, steps in ((False, SINGLE_SCENE_STEPS),
                        (True, CAMERA_SINGLE_SCENE_STEPS)):
    runs = {mode: single_scene_run(mode == "eager", steps, render)
            for mode in ("eager", "captured")}
    eager, captured = runs["eager"], runs["captured"]
    differing = sorted({k for a, b in zip(eager["trace"], captured["trace"])
                        for k in b if not np.array_equal(a[k], b[k])})
    same = eager["steps"] == captured["steps"] and not differing
    print("single scene {} (sensors: default{}), AutopilotAgent{}: "
          "captured {} steps in {:.3f}s = {:.1f} steps/s ({:.1f} without "
          "the reset and its warm-up), eager {:.3f}s = {:.1f} steps/s "
          "({:.1f} without the reset); ms a step captured {} / eager {}; "
          "bev_splat launches captured {} / "
          "eager {}; observations{} bit-equal over every step: {}{}".format(
              SINGLE_SCENE_TASK, " + front camera, game state" if render
              else "", " with render('human') after the reset and every step"
              if render else "", captured["steps"], captured["seconds"],
              captured["steps"] / captured["seconds"],
              captured["steps"] / captured["step_seconds"],
              eager["seconds"], eager["steps"] / eager["seconds"],
              eager["steps"] / eager["step_seconds"], captured["split_ms"],
              eager["split_ms"], captured["launches"],
              eager["launches"], " and frames" if render else "", same,
              " (differing: {})".format(differing) if differing else ""))
    if not same:
      fail("the captured single scene differs from the eager one")
    per_step = 2 if render else 1
    if captured["launches"] != per_step * (captured["steps"] + 1):
      fail("bev_splat launched {} times in a captured {}-step single scene"
           .format(captured["launches"], captured["steps"]))
    if launches is None:
      launches = captured["launches"]
  return launches


def update_idle_share() -> None:
  """(d) The eager DIM update's device busy time and idle share at the
  trainers' batch (published widths, the batch resident on the card):
  ``utils.profiling.device_busy`` over IDLE_UPDATES updates against the
  median ms of one unprofiled update on CUDA events."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  model = ImitativeModel((4, 2), (100, 100),
                         generator=torch.Generator().manual_seed(0),
                         device="cuda")
  state = dp.TrainState.create(model, dp.adam(model, 1e-3),
                               rng_lib.PRNGKey(42, "cuda"))
  update = dp.make_update_fn(dim_train.make_loss_fn())
  batch = {k: torch.as_tensor(v, device="cuda")
           for k, v in update_batch(IDLE_BATCH, 200, seed=3).items()}
  step_ms = event_ms(lambda: update(state, batch))

  def run():
    for _ in range(IDLE_UPDATES):
      update(state, batch)

  busy = profiling.device_busy(run, IDLE_UPDATES, step_ms)
  print("DIM update idle share (batch {}, published widths, eager, batch "
        "resident on the card): {:.3f} ms an update (median of {} on CUDA "
        "events); over {} profiled updates the device busy {:.3f} ms and "
        "{:.1f} kernels an update, idle share {:.4f}".format(
            IDLE_BATCH, step_ms, TIMED_UPDATES, IDLE_UPDATES,
            busy["device_busy_ms_per_step"], busy["kernels_per_step"],
            busy["idle_share"]))
  if busy["kernels_per_step"] == 0:
    fail("the profiler saw no kernel of the DIM update")


def main() -> None:
  # A fatal signal (a fault in native code) prints every thread's Python
  # stack before the process dies.
  faulthandler.enable()
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--prev-splat", action="append", default=[],
                      help="another design's bev_splat.cu to check and time "
                      "beside this one")
  parser.add_argument("--probe-rounds", type=int, default=0,
                      help="run only the evaluator check and CARNOVEL this "
                      "many times, each round on towns built anew, and stop")
  parser.add_argument("--dim-plan", action="store_true",
                      help="run only the DIM planner kernel's check and "
                      "timing and its launches on the DIM path, the "
                      "single-scene learned agents and a RIP row, and stop")
  parser.add_argument("--group-norm", action="store_true",
                      help="run only the encoder's GroupNorm kernel's check "
                      "and timing and its launches on the DIM, RIP, CIL and "
                      "training paths, and stop")
  parser.add_argument("--depthwise", action="store_true",
                      help="run only the encoder's depthwise kernel's check "
                      "and timing and its launches on the DIM, RIP, CIL and "
                      "training paths, and stop")
  args = parser.parse_args()
  try:
    import torch  # pylint: disable=import-outside-toplevel
  except ImportError:
    fail("torch is not installed")
  if not torch.cuda.is_available():
    fail("no CUDA device (torch.cuda.is_available() is False)")
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  try:
    from oatomobile_torch import graphs  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.native import nvcc  # pylint: disable=import-outside-toplevel
    # Each kernel's wrapper makes its Kernel, built below in this order.
    from oatomobile_torch.ops import bev, bev_cuda, depthwise_cuda, dim_plan_cuda, group_norm_cuda  # pylint: disable=import-outside-toplevel,unused-import
  except ImportError as exc:
    fail("oatomobile_torch not found next to this script ({})".format(exc))
  if "jax" in sys.modules or "oatomobile_tpu" in sys.modules:
    fail("the port imported jax or oatomobile_tpu")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  t_start = time.perf_counter()
  marks = [("start", t_start)]  # (phase, when it ended), for the time limit

  def lap(phase: str) -> None:
    marks.append((phase, time.perf_counter()))

  card = card_line()
  print("card: " + card)

  # -- 1. Build ------------------------------------------------------------
  for kernel in nvcc.KERNELS:
    t0 = time.perf_counter()
    kernel.build()
    print("build: {} {:.1f}s (nvcc {:.1f}s)".format(
        kernel.name, time.perf_counter() - t0, kernel.build_seconds))
    print_build(kernel.name, kernel, kernel.path)
  prevs = {}
  for source in args.prev_splat:
    name, library, launch = prev_splat(source, bev_cuda)
    prevs[name] = launch
    print("build: {} from {} (nvcc {:.1f}s)".format(
        name, source, bev_cuda.KERNEL.build_seconds))
    print_build(name, bev_cuda.KERNEL, library)
  if args.dim_plan:
    kernel = check_dim_plan()
    kernel["launches_dim"] = drive_dim_path()["dim_plan"]
    kernel["launches_captured_agents"] = compare_captured_agents()[1]
    from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy  # pylint: disable=import-outside-toplevel
    drive_carnovel("rip-wcm K={}".format(RIP_MEMBERS),
                   make_rip_policy(rip_ensemble(), algorithm="WCM"),
                   CARNOVEL_RIP_HORIZON)
    kernel["launches_eval_rip"] = 0
    print("total: {:.1f}s".format(time.perf_counter() - t_start))
    print(json.dumps({"kernels": [kernel]}))
    return
  if args.group_norm:
    kernel = check_group_norm()
    kernel["launches"] = encoder_launch_counts(
        group_norm_cuda.KERNEL, GROUP_NORM_PER_FORWARD,
        drive_dim_path()["group_norm"])
    print("total: {:.1f}s".format(time.perf_counter() - t_start))
    print(json.dumps({"kernels": [kernel]}))
    return
  if args.depthwise:
    kernel = check_depthwise()
    kernel["launches"] = encoder_launch_counts(
        depthwise_cuda.KERNEL, DEPTHWISE_PER_FORWARD,
        drive_dim_path()["depthwise_conv"])
    print("total: {:.1f}s".format(time.perf_counter() - t_start))
    print(json.dumps({"kernels": [kernel]}))
    return
  if args.probe_rounds:
    probe_carnovel(args.probe_rounds)
    print("probe: {} rounds of the evaluator check, the route check and "
          "CARNOVEL passed in {:.1f}s".format(
        args.probe_rounds, time.perf_counter() - t_start))
    return

  # -- 2. Kernel against its plain version on the card -----------------------
  max_abs_err = 0.0
  for batch in (64, BATCH):
    env = BatchedEnv(TOWN, batch, num_vehicles=VEHICLES, route_capacity=1024,
                     seed=0, device="cuda")
    env.rollout(20, compute=())
    cases = {"main": bev.gather_inputs(env.params, env.state),
             "stress": bev_cuda.stress_inputs(batch, batch, "cuda")}
    for case, inputs in cases.items():
      ref = bev_cuda.splat_lidar_batch_reference(*inputs)
      out = bev_cuda.splat_lidar_batch(*inputs)
      torch.cuda.synchronize()
      differing = count_differing(out, ref)
      err = float((out - ref).abs().max())
      print("check bev_splat {} B={}: max_abs_diff={} differing_pixels={} "
            "occupied_fraction={:.4f}".format(
                case, batch, err, differing,
                float((ref[..., 1] > 0).float().mean())))
      if differing:
        fail("bev_splat disagrees with its plain version on the {} inputs "
             "at B={}".format(case, batch))
      max_abs_err = max(max_abs_err, err)
      for name, launch in prevs.items():
        if case == "main":
          print("check {} {} B={}: differing_pixels={}".format(
              name, case, batch, count_differing(launch(*inputs), ref)))
    del env, cases, inputs, out, ref

  # -- 3. One splat captured in a CUDA graph, replayed on new inputs ---------
  static = [x.clone() for x in bev_cuda.stress_inputs(64, 1, "cuda")]
  bev_cuda.splat_lidar_batch(*static)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = bev_cuda.splat_lidar_batch(*static)
  fresh = bev_cuda.stress_inputs(64, 2, "cuda")
  for dst, src in zip(static, fresh):
    dst.copy_(src)
  graph.replay()
  eager = bev_cuda.splat_lidar_batch(*fresh)
  torch.cuda.synchronize()
  differing = count_differing(captured, eager)
  print("check bev_splat graph replay on new inputs: differing_pixels={} "
        "(against the plain version: {})".format(
            differing, count_differing(
                captured, bev_cuda.splat_lidar_batch_reference(*fresh))))
  if differing:
    fail("the graph-captured splat disagrees with the eager call")
  del graph, captured, eager, static, fresh

  lap("build and splat checks")

  # -- 4. A small rollout on the card against the CPU ------------------------
  stats = {}
  for device in ("cpu", "cuda"):
    env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=device)
    _, _, s = env.rollout(30, compute=("lidar",))
    stats[device] = {k: v.cpu() for k, v in s.items()}
  same = all(torch.equal(stats["cpu"][k], stats["cuda"][k])
             for k in ("episodes", "collisions"))
  dist_err = float((stats["cpu"]["distance"] -
                    stats["cuda"]["distance"]).abs().max())
  sum_err = float(((stats["cpu"]["obs_checksum"] -
                    stats["cuda"]["obs_checksum"]).abs() /
                   stats["cpu"]["obs_checksum"].abs()).max())
  print("check rollout cuda vs cpu (Town02, 4 scenes, 8 NPCs, 30 steps): "
        "episodes/collisions equal={} distance_max_abs_diff={} "
        "checksum_max_rel_diff={}".format(same, dist_err, sum_err))
  if not same or dist_err > 1e-3 or sum_err > 1e-3:
    fail("the rollout on the card disagrees with the rollout on the CPU")
  check_closed_loop()

  # -- 5. Main path ------------------------------------------------------------
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  graphs.capture_seconds = 0.0
  _, _, s = env.rollout(STEPS, compute=("lidar",))
  float(s["distance"].sum())
  print("main path: the step captured in {:.3f}s".format(
      graphs.capture_seconds))
  bev_cuda.KERNEL.launches = 0
  t0 = time.perf_counter()
  final, _, s = env.rollout(STEPS, compute=("lidar",))
  float(s["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.KERNEL.launches
  s = {k: v.cpu() for k, v in s.items()}
  finite = all(bool(torch.isfinite(v.float()).all()) for v in s.values())
  print("main path: {} x {} steps in {:.3f}s = {:.1f} env steps/s (graph "
        "replays); "
        "bev_splat launches={} (lidar syntheses={}); stats finite={} "
        "checksum_min={:.1f} distance_mean={:.2f}m episodes={} "
        "collisions={}".format(
            BATCH, STEPS, elapsed, BATCH * STEPS / elapsed, launches, STEPS,
            finite, float(s["obs_checksum"].min()),
            float(s["distance"].mean()), int(s["episodes"].sum()),
            int(s["collisions"].sum())))
  if launches != STEPS:
    fail("bev_splat launched {} times for {} lidar syntheses".format(
        launches, STEPS))
  if not finite or not bool((s["obs_checksum"] != 0).all()):
    fail("main path stats are not finite or a checksum is zero")

  # -- 6. Kernel timing at the main path's inputs ------------------------------
  inputs = bev.gather_inputs(env.params, final)
  designs = {"bev_splat": bev_cuda.splat_lidar_batch, **prevs}
  order = [*prevs, "bev_splat", "bev_splat", *reversed(list(prevs))]
  times = {name: [] for name in designs}
  for name in order:
    times[name].append(cuda_ms(lambda f=designs[name]: f(*inputs), calls=20))
  ms_of = {name: statistics.mean(t) for name, t in times.items()}
  ms = ms_of["bev_splat"]
  plain_ms = cuda_ms(lambda: bev_cuda.splat_lidar_batch_reference(*inputs),
                     calls=2)
  bound_ms, bound_by, slots = splat_bound_ms(*inputs)
  # Yardstick of what the card's memory gives a write of the same bytes.
  image = torch.empty((BATCH, 200, 200, 2), device="cuda")
  fill_ms = cuda_ms(lambda: image.fill_(0.0), calls=20)
  del image
  step_ms = 1e3 * elapsed / STEPS
  print("timing B={} in turn ({}): {}".format(
      BATCH, ", ".join(order), "; ".join(
          "{} {} ms".format(name, " ".join("{:.4f}".format(t) for t in ts))
          for name, ts in times.items())))
  print("timing bev_splat B={}: kernel {:.4f} ms, plain {:.4f} ms, bound "
        "{:.4f} ms ({}; {:.1f} live slots per scene), a fill of the same "
        "output {:.4f} ms, library none; {:.2%} of the main path's {:.3f} "
        "ms step".format(BATCH, ms, plain_ms, bound_ms, bound_by, slots,
                         fill_ms, ms / step_ms, step_ms))

  lap("rollout check, main path, splat timing")

  # -- 7. DIM on the card against the CPU ---------------------------------------
  check_dim_card_against_cpu()

  # -- 8. The DIM path ------------------------------------------------------------
  dim_launches = drive_dim_path()

  lap("DIM check and path")

  # -- 8a. The DIM planner kernel against its plain version and autograd ------
  dim_plan_kernel = check_dim_plan()
  lap("DIM planner kernel")

  # -- 8c. The encoder's GroupNorm kernel against PyTorch ----------------------
  group_norm_kernel = check_group_norm()
  group_norm_kernel["launches"] = encoder_launch_counts(
      group_norm_cuda.KERNEL, GROUP_NORM_PER_FORWARD,
      dim_launches["group_norm"])
  lap("GroupNorm kernel")

  # -- 8d. The encoder's depthwise kernel against PyTorch -----------------------
  depthwise_kernel = check_depthwise()
  depthwise_kernel["launches"] = encoder_launch_counts(
      depthwise_cuda.KERNEL, DEPTHWISE_PER_FORWARD,
      dim_launches["depthwise_conv"])
  lap("depthwise kernel")

  # -- 8b. The DIM entry, card against CPU and captured against eager ---------
  check_entry()
  lap("entry")

  # -- 9. The batched evaluator on the card against the CPU --------------------
  check_eval_card_against_cpu()

  # -- 10. CARNOVEL through the batched evaluator ------------------------------
  rip_launches = run_carnovel()

  lap("evaluator check and CARNOVEL")

  # -- 11. The single-scene API --------------------------------------------------
  launches_single = drive_single_scene()
  lap("single scene")
  check_agents_card_against_cpu()
  launches_agents, plan_launches_agents = compare_captured_agents()
  lap("learned agents captured")

  # -- 12. Collection and trainer updates on the card against the CPU ---------
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
    check_collect_card_against_cpu(workdir)
    check_updates_card_against_cpu()

    # -- 13. The training path at full width -----------------------------------
    launches_collect = drive_training_path(workdir)
    lap("collection and update checks, training path")

    # -- 13b. The experiments over the training path's artifacts --------------
    launches_experiments, launches_round2 = drive_experiments(workdir)
    lap("experiments, round 2 and the publishers")

    # -- 13c. The studies and diagnostics over the same artifacts -------------
    launches_studies = drive_studies(workdir)
  lap("studies and diagnostics")

  # -- 14. The compiled rollout against the eager loop ---------------------------
  drive_compiled_paths()
  lap("compiled rollout against eager")

  # -- 15. Cameras, game-state masks and the human render -------------------------
  check_cameras_card_against_cpu()
  lap("camera check")
  launches_camera = drive_camera_rollout()
  lap("camera rollout")
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
    launches_camera_collect = drive_camera_collection(workdir)
  lap("camera collection")
  launches_camera_single = drive_camera_single_scene()
  lap("camera single scene")

  # -- 16. The device mesh ----------------------------------------------------------
  launches_mesh, launches_entry = drive_mesh_world_one()
  lap("mesh at world size 1 (NCCL) and the dry run")
  launches_mesh_ranks = drive_mesh_two_ranks()
  lap("mesh over two ranks (gloo)")

  # -- 17. The captured single scene against the eager one ---------------------------
  launches_single_captured = compare_single_scene()
  lap("single scene captured against eager")

  # -- 18. The eager DIM update's idle share -------------------------------------------
  update_idle_share()
  lap("DIM update idle share")

  kernels = [{
      "name": "bev_splat",
      "status": "ported",
      "route": "cuda",
      "source": "oatomobile_torch/csrc/bev_splat.cu",
      "replaces": "oatomobile_tpu/ops/bev_pallas.py:54",
      "launches": launches,
      "launches_dim": dim_launches["bev_splat"],
      "launches_eval_rip": sum(rip_launches.values()),
      "launches_single_scene": launches_single,
      "launches_collect": launches_collect,
      "launches_camera_rollout": launches_camera,
      "launches_camera_collect": launches_camera_collect,
      "launches_camera_single_scene": launches_camera_single,
      "launches_mesh_rollout": launches_mesh,
      "launches_mesh_rollout_rank0": launches_mesh_ranks,
      "launches_single_scene_captured": launches_single_captured,
      "launches_captured_agents": launches_agents,
      "launches_experiments": sum(launches_experiments.values()),
      "launches_studies": sum(launches_studies.values()),
      "launches_entry": launches_entry,
      "launches_round2": launches_round2,
      "max_abs_err": max_abs_err,
      "ms": ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": bound_by,
      "library_ms": None,
      "prev_ms": ms_of[next(iter(prevs))] if prevs else None,
      "fill_ms": fill_ms,
  }, dict(dim_plan_kernel, launches_dim=dim_launches["dim_plan"],
          launches_captured_agents=plan_launches_agents,
          launches_eval_rip=0), group_norm_kernel, depthwise_kernel]
  print("phase seconds: {}".format(", ".join(
      "{} {:.1f}".format(phase, end - start)
      for (_, start), (phase, end) in zip(marks, marks[1:]))))
  print("total: {:.1f}s".format(time.perf_counter() - t_start))
  print(json.dumps({"kernels": kernels}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
