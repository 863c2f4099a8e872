#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raft_stereo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from raft_stereo_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all at once (the wall seconds, and each
   source's), and print the loop kernels' (the resident kernel, gru16+32,
   the serial GRU and motion launches), the pass engine's and the q8 exits'
   registers and spills (ptxas -v), the pass engine's dynamic shared memory
   at each output width and the loop engine's block (loop_conv_sm90.cuh:
   shared memory, threads, blocks an SM) in the resident kernel and in both
   gru16+32 instantiations;
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (KITTI 375x1242 padded to 384x1248: features at
   96x312, B=1, bf16): max |error| against a stated tolerance; device ms per
   call of the kernel and of the plain version (torch.profiler, ``ms`` and
   ``plain_ms``), the kernel's calls back to back between CUDA events
   (``events_ms``: where it and ``ms`` differ by more than EVENTS_TOL, ``ms``
   is taken again over four times the calls and the first reading printed
   as ``ms_first``), and the
   same calls' wall ms with the Python wrapper around them (CUDA events,
   ``wrapper_ms`` and ``plain_wall_ms``); and the analytic bound. The alt
   kernel and the lookup are also timed on a frame-like coordinate field
   (``ms_frame_coords``); the lookup also at the Middlebury-F features
   (504x744, beside the paths), with the 32-byte sectors its windows reach
   (``sector_floor_ms``) beside its bound of useful bytes. The gru16+32
   and resident kernels must also equal, bit for bit, the serial CUDA
   chain they replace (``serial_ms``: its device
   ms; ``kernel_ms``: the hand-written kernels' own share of ``ms``);
   gru16+32 and its chain also at the Middlebury-F shapes (252x372 and
   126x186, 5 calls after 1), in bf16 and on int8 czrq. The
   encoder kernels (stem, 3x3 pass, point3, point2) are held in
   bf16 ulps of the plain version, their statistics against its fp64 sums,
   and run twice for equal bits, in both norm variants at the shapes of
   both main paths (the KITTI frames: 384x1248x64, 192x624x96, 96x312x128;
   the Middlebury-F frame: 2016x2976x64, 1008x1488x96, 504x744x128), with
   ``kernel_ms`` the hand-written kernels' own share of ``ms``; the two
   launches that one library call also computes (the stem and the head
   conv, ``F.conv2d``) carry its time (``library_ms``), and every other
   pass the time of its conv alone, without the transform, the statistics
   or the quantization (``library_note`` says which); the context net's
   fused stem + layer1, one streamed residual block and the feature net's
   fused stem + layer1 (at both frame sizes) are held as chains, kernel
   route against plain route. The int8 context lanes (RAFT_LANE_PACK8):
   the three GRU kernels on int8 czrq (``bf16_ms``: the bf16 mode's ms in
   this call; gru16+32 and resident bit for bit their serial lane8 chains),
   the quantize-on-exit pass at the zqr convs' shapes (128 -> 384: KITTI
   96x312, 48x156, 24x78, Middlebury-F 504x744; ``library_ms`` the
   F.conv2d of the same conv, without the quantization) and point2 q8 at
   96x312x128 and 504x744x128, both norms, each bit for bit the host
   quantization of the same kernel's bf16 output (point2 q8 in one launch
   a call, ``launches_per_call``, counted by the profiler); the point2 q8
   exit, on
   no model path, runs in four stream_resblock_q8 chains (context and
   feature net layer3[1] at both sizes), whose launches are its row's; the
   realtime model's shapes (``REALTIME``, KITTI at 1/8): the head-less gru16
   step at 24x78 with one x input, and the resident kernel at 48x156 with
   its 24x78 gru16 state upsampled; and writes past a kernel's outputs
   (``check_overruns``): one KITTI frame of 2 iterations on each of the
   default path (stem, pass, point3, point2, gru16+32, resident), the serial
   loop (lookup, the three GRU steps, motion) and ``alt_cuda`` (alt,
   gru16+32, motion, gru08+head), with every output and scratch map their
   wrappers allocate inside a larger buffer of sentinel bytes
   (``guarded_allocations``), whose margins must come out unchanged
   (compute-sanitizer refuses this card);
4. the main path at full width: the default model (hidden 128x3, 3 GRU
   levels, 4 corr levels, radius 4, bf16, reg_cuda) with weights from a
   seed, through the demo's inference function at 32 iterations, with the
   launch counts set to 0 before each path and read after it:
   - the default path, three random 375x1242 pairs: 32 fused_iter and 32
     gru1632 launches a frame, none of the serial kernels, and the context
     net's encoder kernels (1 stem, 14 passes, 1 point3, 4 point2; the
     feature net runs its two images as one batch here and stays plain);
   - the serial loop (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0) on the first
     pair again: 32 lookup, 32 motion and 32 GRU launches at each of the
     three levels, and a disparity equal bit for bit to the default loop's;
   - RAFT_STREAM_TAIL=0 on the first pair: 1 stem, 4 passes, 1 point3;
   - RAFT_FUSED_ENCODERS=0 on the first pair: no encoder kernel, and a
     disparity within a stated band of the default path's (mean within
     twice a sound tree's reading, every pixel within 1 px, after 32
     iterations: ``_disparity_band``);
   - one random Middlebury-F pair (2016x2976, the JAX package's headline
     geometry) through the default path (the feature net one image at a
     time there, so 3 stems, 30 passes, 3 point3, 8 point2), and again with
     RAFT_FUSED_ENCODERS=0;
   - the other correlation routes (``phase_corr_paths``): alt_cuda on the
     first KITTI pair (32 alt, 32 gru1632, 32 motion, 32 gru08+head
     launches, no lookup, no resident iteration) and on the Middlebury-F
     pair, each within a stated band (CORR_BANDS) of reg_cuda's disparity;
     RAFT_CORR_PACK8=1 on the KITTI pair (32 resident launches on the int8
     levels), again with RAFT_FUSE_ITER=0 (32 int8 lookups, equal bits), in
     a stated band of the bf16 frame;
   - RAFT_LANE_PACK8=1 (``phase_lane_paths``): the KITTI pair (32 gru16+32
     and 32 resident launches, all on int8 czrq, and one q8 pass per zqr
     level), again on the serial loop (32 lane8 GRU launches a level, equal
     bits), and the Middlebury-F pair with the prepare step's and the
     loop's peaks apart; both in LANE_BANDS of the bf16 frames;
   - the prepare step twice on one pair: equal bits (no atomics);
   - the slow-fast loop (``phase_slow_fast``): the realtime model on the
     first KITTI pair at 7 iterations (14 gru16 steps, 7 resident launches,
     no gru16+32, no lookup, no stem; the two finest context heads' 6
     passes and 2 point2) and on its serial loop (equal bits); the default model with ``slow_fast_gru`` on the same
     pair at 32 iterations (32 gru32 steps, 64 gru16+32, 32 resident) and
     on its serial loop (equal bits);
   per-frame ms and peak memory for each;
5. the serving session (``phase_session``), its programs CUDA graphs: a
   KITTI session (32 iterations, 4 segments, the 375x1242 bucket warmed
   with its segmented and half-resolution programs, the parity canary on)
   serves 4 random pairs, each bit for bit the eager forward on the card
   (the first pair's whole padded flow too), with no breaker trip; a
   deadline that fits all 4 segments gives the full request's bits, one of
   about half the full program's time a reduced_iters:k label (0 < k <
   32); the full program must have captured the default path's launches a
   frame and a profiled replay show the same kernels; the realtime model
   (7 iterations) and one Middlebury-F request the same way. Each line
   (``"phase": "session"``) carries the card's name and power limit, frames
   from a host pair to a host flow in turns (eager, graph, graph, eager;
   ``eager_ms``, ``graph_ms``), the graph frame's copy in, replay and copy
   out apart, both back to back on the card, one replay's device busy ms,
   and each program's capture seconds, pool bytes and peak device bytes;
6. the same seeded model at 128x256 and 8 iterations on the card and on the
   CPU (plain versions), with reg_cuda and with alt_cuda, and the realtime
   model at 7 iterations with reg_cuda, disparities held to a stated band;
7. the bench entry point, ``python -m raft_stereo_tpu_torch.bench``, in a
   subprocess: the headline default (Middlebury-F, 32 iterations, 3 timed
   frames) and the realtime model at 384x1248 (7 iterations, 8 frames);
   each must exit 0 with one JSON line, a positive frame rate, finite
   checksums inside their committed pins
   (``raft_stereo_tpu_torch/bench_checksum_ref.json``), ``device_s`` and
   ``flops`` present and ``mfu`` in (0, 1]; each line is printed again
   with ``"phase": "bench"``;
8. the server (``phase_server``): the same tempered model at KITTI size
   (eight seeded 375x1242 uint8 pairs, so the padder pads them; 32
   iterations in 4 segments; the 375x1242 bucket warmed). Each pair through
   a ``max_batch=1`` StereoService one at a time gives the reference
   responses; the same pairs from eight client threads through a
   ``max_batch=4`` service (buckets 1, 2, 4, batched programs captured as
   CUDA graphs), then two more, each held to its reference by
   CROSS_WIDTH_PIN (set from the card's reading: bit for bit), with ticks
   at b=2 and b=4 asserted from the scheduler's counters; within one width
   four rows by hand at b=4 against each row beside replicas of itself, bit
   for bit; each batched program's captured launches (prepare at b: b
   stems, 14b passes, b point3, 4b point2; advance over one segment: a
   fused_iter and a gru1632 an iteration, no serial kernel; epilogue none)
   and a profiled advance replay's kernels; each batched program's device
   ms by kernel, the carry's copy in and out of the advance graph at b=1
   and b=4, frames/s and p50/p95 request ms from 8 closed-loop clients (32
   requests) at max_batch 1 and 4 in turns (1, 4, 4, 1), one profiled
   round of each with the card's idle share, the graphs' pool bytes and
   ``max_memory_allocated`` (``"phase": "server"``). Then ``python -m
   raft_stereo_tpu_torch.serve_stereo --http_port 0 --max_batch 4`` in a
   subprocess on loopback (the same weights through a .pth, ``--ready_fd``):
   /healthz, four multipart PNG requests equal byte for byte to in-process
   submits of the same decoded arrays, /metrics, a truncated body
   ``bad_multipart``, SIGTERM draining to exit 0 (``"phase":
   "server_cli"``; without Pillow the PNG requests are left out and the
   line says so).
9. streams, the response cache and the fleet (``phase_streams``): the
   tempered model at KITTI size, 32 iterations in 4 segments. (a) A stream
   of 8 frames (one seeded uint8 375x1242 pair, its right image shifted by
   0-7 px: a slowly panning rig) through a ``StreamRunner`` at the default
   tolerance and at 1e9 (every warm frame leaves at its first segment
   boundary, ``converged:8``): frame 1 bit for bit its stateless response,
   every frame bit for bit the eager prepare[_warm] → advance → epilogue
   composition on the card, every warm frame within WARM_ROUTE_BAND of the
   forward with the same ``flow_init`` (frame 1 gives the route's baseline
   with a zero seed), with ``dnorm`` by segment, iterations, request ms and
   label by frame; ``prepare_warm`` captured the cold prepare's launches
   (1 stem, 14 passes, 1 point3, 4 point2), ``advance`` 8 resident + 8
   gru16+32; frames/s of the stream against the same frames served cold,
   in turns (STREAM_ROUNDS). Then two streams through a ``max_batch=4``
   service among cold requests (B at 1e9 from its first warm frame): frame
   1 of each bit for bit its stateless twin in the same tick, each warm
   frame held to its eager composition by CROSS_WIDTH_PIN; a warm row at
   b=4 with the same bits beside two and three cold rows. (b) The cache:
   an exact repeat ``cache:exact``, bit for bit, with no program call, no
   device second and no launch (its ms printed); a near repeat
   ``warm:cache:8``; an entry evicted to a ``cache_dir`` served again,
   bit for bit, after the service restarts. ``demo --video``'s frames in
   process over 3 PNG frames (``demo.disparities``; the card's machine has
   no matplotlib for the PNG save): frame 1 bit for bit the single-pair
   output. (c)
   ``python -m raft_stereo_tpu_torch.fleet_stereo`` with 2 instances at
   ``max_batch 1`` and a shared ``--cache_dir``: both handshakes, a stream
   pinned to one instance and its frame 1 bit for bit in process, two cold
   pairs straight to that instance (its one-entry budget spills the
   first), ``kill -9`` of it with 4 stream frames in flight (each answered:
   200 from the survivor, to which the fleet retries once, or a structured
   502/503), the stream then served by the survivor cold and then warm,
   the replacement in the same slot serving the spilled pair
   ``cache:exact`` bit for bit; the seconds from the kill to the first
   response served by the survivor and to the replacement's readiness,
   then SIGTERM, exit 0 (``"phase": "streams"``, ``"demo_video"``,
   ``"fleet"`` and ``"streams_seconds"`` lines).
10. training (``phase_train``): a synthetic FlyingThings3D tree
   (TRAIN_TREE) under ``build/phase_train``. ``python -m
   raft_stereo_tpu_torch.train_stereo`` in a subprocess with the
   reference's published flags and ``reg_cuda`` (TRAIN_FLAGS, cuDNN's TF32
   at torch's default): exit 0, every loss finite, the final bundle
   written; steps/s as wall time over steps 3-12, and the median wait for
   a batch. The same run in process (TF32 off, as in the rest of this
   script), a bundle and a validation every TRAIN_RESUME_AT steps: a
   step's launches exactly 2 x TRAIN_ITERS lookups (the forward and the
   checkpointed recompute) and no loop kernel; the final bundle and a
   save/load round trip bit for bit; the bundles past TRAIN_RESUME_AT
   removed and the run relaunched from the directory, the later steps'
   losses within RESUME_BAND. The kernel routes' gradients (``reg_cuda``
   and ``alt_cuda`` at B=2, ``fused_train``, B=1) against a CPU copy's
   plain route within GRAD_BAND_MAT and GRAD_BAND_VEC, each route's
   kernels launched. The loss falls over 8 steps on one batch; at B=8,
   with cuDNN's TF32 off and then on, three steps timed and one profiled:
   device ms by kernel group and the largest ungrouped kernels, the
   profiled step's idle share and its busy seconds over the timed steps'
   median wall; ``fused_train`` against the default in turns (1, f, f, 1) with
   TF32 on (``"phase": "train"``).
11. two ranks sharing the card (``phase_parallel``): this script relaunched
   twice (``--parallel-rank``) as a 2-process pod over gloo
   (``COORDINATOR_ADDRESS``, ``PROCESS_ID``, ``NUM_PROCESSES``; NCCL takes
   one rank a card and is not exercised), loading the kernels phase 2
   built. ``--spatial_shard 2`` at full width: the KITTI pair through the
   default model at 32 iterations on a 2-way space row, each rank's
   launches exactly PARALLEL_LAUNCHES a frame (the spatial conv_gru at all
   three levels, motion and the lookup, 32 each; no resident iteration,
   gru16+32 or encoder kernel), the gathered disparity in the canary band
   (``serve/guard.py``) of the one-process forward with the encoders plain
   and in the route band of the default forward; each spatial entry
   against its plain version on the rank's shard; one data-parallel (2, 1)
   and one height-sharded (1, 2) train step (GRAD_SHAPE, B=2,
   ``fused_train``) in phase 10's gradient bands of the one-process step
   on the same batch. Each rank's frame ms, peak bytes and step launches
   (``"phase": "parallel"``); the kernels line gives the conv_gru, motion
   and lookup rows their launches there (``spatial_shard_2_launches``).
12. pod serving (``phase_mesh``): a session whose data mesh lists
   ``cuda:0`` twice (``mesh_devices``; buckets 2 and 4, every batched
   program two shard graphs of half the rows), the tempered model at
   KITTI size, 32 iterations in 4 segments, ``max_batch`` 4, the counts set
   to 0 before it is built and read after its first served requests (every
   encoder and default-loop kernel launched). Four seeded uint8 pairs
   through the bucket-4 programs by hand: each row bit for bit a
   one-device session's at bucket 2, and in the CROSS_WIDTH_PIN band of its
   bucket-4 rows; through the scheduler the same bits; each shard program's
   captured launches those of a one-device program of its rows; both
   chips probed healthy (``probe_s``). Then ``quarantine_chip(1)`` (the
   mesh one chip wide, a new epoch), served; ``heal_mesh`` after
   RAFT_HEAL_BACKOFF_MS (MESH_BACKOFF_MS): chip 1 re-admitted, the new
   epoch's graphs captured before it returns, and the requests served
   again bit for bit as the first time with no capture.
   Capture s a shard; frames/s at mesh 2 and on one device (bucket 4, 8
   clients) in turns (``"phase": "mesh"``); the kernels line gives the
   encoder and default-loop rows their launches in each shard of each mesh
   program (``mesh_shard_launches``: ``"advance@b4": [8, 8]``).
13. the analysis suites (``phase_analysis``): graftlint over the port
   (``python -m raft_stereo_tpu_torch.analysis``, GL001-GL006: exit 0
   required), then graftverify's headline registry recorded on the card
   (``analysis/trace/registry.py``: the six serving programs, the eval
   forward and the train step, the nine ladder programs, each the b=1
   full frame and the b=2 advance from the armed base, and the base and
   six flips of the knob probes), zero unsuppressed findings. One
   ``"phase": "analysis"`` line: the programs recorded, each ladder
   program's kernel launches by kernel and by variant (pairwise distinct),
   each knob flip's verdict beside its cache-key change, the suppressions
   with their reasons, the seconds. The concurrency stage runs first
   beside the AST stage (``--concurrency``: GC201-GC206 against the
   port's ``raft_stereo_tpu_torch/LOCK_ORDER.md``), and the ladder walks
   nine programs, the last (``fused_update`` tripped too) launching no
   hand-written kernel.
14. the lock witness (``phase_lock_witness``): in a child process
   (``--lock-witness DIR``), graftlock's runtime witness
   (``analysis/concurrency/witness.py``) is armed before the serving
   modules are imported and adopts the module-level locks; the child
   builds the card's serving stack (a session on cuda:0 with CUDA-graph
   programs, KITTI, bf16, reg_cuda, the default switches, under a fake
   clock; the service with its scheduler, stream manager and response
   cache; the HTTP frontend on localhost; a supervisor) and drives a storm
   from WITNESS_CLIENTS client threads: ordinary pairs, a stream of warm
   frames, an exact cache hit, malformed requests, requests over HTTP;
   then an injected build failure that trips ``fuse_iter`` (the serial
   loop kernels run after it), then an injected hang that the
   supervisor's watchdog bounces. Every observed nested acquisition must
   be an edge of the static lock-order graph (zero unexplained edges),
   at least WITNESS_MIN_MAPPED of them mapped to declarations; the
   parent serves the child's first request on a session built without
   the witness, bit for bit the same disparity. One ``"phase":
   "lock_witness"`` line: the requests, the trips, the edges observed,
   mapped and unexplained, the locks adopted, the seconds.

Phase 3 also checks reads past a kernel's inputs (``check_overreads``):
one KITTI frame of 2 iterations on each of OVERRUN_ROUTES, each route in a
child process (``--overread-route NAME``), every tensor a kernel wrapper
takes placed with CUDA's virtual memory API so that its end, plus the
kernel's declared slack (OVERREAD_SLACK: the lookup's 16-byte unit), meets
a page that is never mapped; a read past it faults and fails the route by
name.

The seeded model's flow-head output conv is scaled by 1/50 (``seeded_model``): at
random init it moves the coordinates ~35 px an iteration, which sends the
lookups off the pyramid rows and makes the loop chaotic, so bf16 rounding
differences grow into pixels (the JAX package's own bf16 kernel and XLA
paths then differ that much too). Scaled, an iteration moves under a pixel
or so, as a trained model's does.

The encoder kernels' launches are also counted by variant (the norm, the
pass kind, the channels) and every path asserts them exactly, so the
context net's launches are told from the feature net's.

The line before the last is {"kernels": [...]}, each kernel's launches
counted on the path that runs it at the row's shape (named in ``path``; an
encoder row's are its variant's: the folded-BatchNorm rows at the KITTI
shapes from the default path, all rows at the Middlebury-F shapes from that
frame, where alone the instance-norm variants run); the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints neither.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

KITTI = (375, 1242)
FEAT = (96, 312)  # 1/4 of the padded 384x1248
MIDDLEBURY_F = (2016, 2976)
ALT_HEADLINE_FEAT = (504, 744)  # 1/4 of MIDDLEBURY_F
ITERS = 32
N_FRAMES = 3
# The reference's realtime model (its README): shared backbone, 1/8
# resolution, 2 GRU levels, slow-fast GRUs, 7 iterations.
REALTIME = dict(shared_backbone=True, n_downsample=3, n_gru_layers=2, slow_fast_gru=True)
RT_ITERS = 7
RT_FEAT = (FEAT[0] // 2, FEAT[1] // 2)  # 1/8 of the padded 384x1248
SWITCHES = ("RAFT_FUSE_ITER", "RAFT_FUSE_GRU1632")
ENCODER_SWITCHES = ("RAFT_FUSED_ENCODERS", "RAFT_STREAM_TAIL")
# Encoder launches a frame, by variant (kernels.variants). KITTI: the context
# net only (4 trunk passes, 2 each for layer2[1] and layer3[1], 3 for each of
# the two finest heads), frozen BatchNorm folded ("bn"); its head convs are
# raw1 passes at 128 channels. Middlebury-F: the context net, and the feature
# net (instance norm) once per image.
VAR_CNET = {"enc_stem:bn": 1, "enc_pass:mid1/bn/64": 3, "enc_pass:mid2/bn/64": 1,
            "enc_point3:bn/64": 1, "enc_pass:raw1/bn/96": 1, "enc_pass:mid1/bn/96": 1,
            "enc_point2:bn/96": 1, "enc_pass:raw1/bn/128": 5, "enc_pass:mid1/bn/128": 3,
            "enc_point2:bn/128": 3}
VAR_TRUNK_ONLY = {k: VAR_CNET[k] for k in ("enc_stem:bn", "enc_pass:mid1/bn/64",
                                           "enc_pass:mid2/bn/64", "enc_point3:bn/64")}
VAR_FNET = {"enc_stem:instance": 1, "enc_pass:mid1/instance/64": 3,
            "enc_pass:mid2/instance/64": 1, "enc_point3:instance/64": 1,
            "enc_pass:raw1/instance/96": 1, "enc_pass:mid1/instance/96": 1,
            "enc_point2:instance/96": 1, "enc_pass:raw1/instance/128": 1,
            "enc_pass:mid1/instance/128": 1, "enc_point2:instance/128": 1}
VAR_MIDDLEBURY = {**VAR_CNET, **{k: 2 * n for k, n in VAR_FNET.items()}}


def _by_kernel(variants: dict) -> dict:
    out: dict = {}
    for key, n in variants.items():
        out[key.split(":")[0]] = out.get(key.split(":")[0], 0) + n
    return out


ENC_KITTI = _by_kernel(VAR_CNET)            # 1 stem, 14 passes, 1 point3, 4 point2
ENC_TRUNK_ONLY = _by_kernel(VAR_TRUNK_ONLY)  # 1 stem, 4 passes, 1 point3
ENC_MIDDLEBURY = _by_kernel(VAR_MIDDLEBURY)  # 3 stems, 30 passes, 3 point3, 8 point2
# The realtime model: the shared backbone's trunk takes both images as one
# batch and stays plain; its two finest context heads take the first image
# alone (B=1 after the split, as in the JAX package) and stream, a residual
# block (raw1, mid1, point2) and a head conv (raw1) each.
VAR_RT = {"enc_pass:raw1/bn/128": 4, "enc_pass:mid1/bn/128": 2, "enc_point2:bn/128": 2}
ENC_RT = _by_kernel(VAR_RT)  # 6 passes, 2 point2
# A frame's launches on the default path: the headline frame (the feature
# net fuses there) and the realtime model (2 gru16 steps and 1 resident
# iteration an iteration, no gru16+32).
LOOP = {"fused_iter": ITERS, "gru1632": ITERS}
MIDDLEBURY_LAUNCHES = {**LOOP, **ENC_MIDDLEBURY}
RT_LAUNCHES = {"conv_gru:gru16": 2 * RT_ITERS, "fused_iter": RT_ITERS, **ENC_RT}
# Encoder maps on the two main paths: (H, W) of the padded frame, of layer2
# and of layer3 and the finest heads.
SHAPES = {"default": ((384, 1248), (192, 624), (96, 312)),
          "headline": ((2016, 2976), (1008, 1488), (504, 744))}
PASS_ULPS = 1.0   # one conv pass or exit against its plain version
CHAIN_ULPS = 8.0  # a chain of passes against the plain route


def _wall_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn``, CUDA events around the
    Python call: the wrapper's checks and allocations are inside, so for a
    short kernel this is host time, not the kernel's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20, warmup: int = 3, own: tuple = ()):
    """Device milliseconds of one call of ``fn``: the summed durations of
    the kernels, copies and fills it puts on the card (torch.profiler) over
    ``reps`` calls, divided by ``reps``. Host time between them is left out.
    With ``own`` (parts of kernel names) a pair: that, and the share of it
    spent in the kernels so named."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    # A profile can come back without device events (seen on a process's
    # first ones, over a window under a millisecond: three in a row once,
    # phase_kernels' first check): try again before giving up.
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(us for _, us in events)
        if total_us > 0 and not own:
            return total_us / 1e3 / reps
        own_us = sum(us for name, us in events if any(part in name for part in own))
        if own_us > 0:
            return total_us / 1e3 / reps, own_us / 1e3 / reps
    raise SystemExit(f"the profiler recorded no device time (kernels named {own})" if own
                     else "the profiler recorded no device time")


def _events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds a call of ``reps`` back-to-back calls of ``fn`` between
    two CUDA events. The loop is queued behind a sleep on the card that
    outlasts its host time, so the card runs the calls without waiting for
    the host: their device time with the gaps between launches, a
    cross-check of the profiler's sum (``_device_ms``), which now and then
    loses events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0  # a call's host and device time, at least its host time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * one, 1.0) * 2e9))  # cycles, at most 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The profiler's and the events' readings of a kernel, apart, past which the
# profiler's is taken again: one call's events lost from a window of 5 calls
# (the Middlebury-F shapes) read 20% low.
EVENTS_TOL = 0.15


def _checked_ms(kernel, reps: int = 20, warmup: int = 3, own: tuple = ()) -> dict:
    """``ms``: the kernel's device time; ``kernel_ms`` (with ``own``): of that,
    the hand-written kernels' own, without the torch kernels that lay out
    the weights. ``events_ms``: the same calls back to back between CUDA
    events; where it and ``ms`` differ by more than EVENTS_TOL of the larger,
    ``ms`` is taken again over four times the calls and the first reading
    kept as ``ms_first``."""
    out = {"events_ms": _events_ms(kernel, reps, warmup)}
    for n in (reps, 4 * reps):
        if own:
            ms, out["kernel_ms"] = _device_ms(kernel, n, warmup, own)
        else:
            ms = _device_ms(kernel, n, warmup)
        if n > reps or abs(ms - out["events_ms"]) <= EVENTS_TOL * max(ms, out["events_ms"]):
            break
        out["ms_first"] = ms
    out["ms"] = ms
    return out


def _timings(kernel, plain, reps: int = 20, warmup: int = 3, own: tuple = ()) -> dict:
    """The kernel's ``_checked_ms``, and the wall ms of the wrapper and of
    the plain version and the plain version's device ms."""
    return {"wrapper_ms": _wall_ms(kernel, reps, warmup),
            "plain_ms": _device_ms(plain, reps, warmup),
            "plain_wall_ms": _wall_ms(plain, reps, warmup),
            **_checked_ms(kernel, reps, warmup, own)}


def _max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi}


def _ptxas_usage(log: str) -> list:
    """Each kernel's registers and spill bytes from ptxas's -v lines."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def phase_build() -> float:
    from raft_stereo_tpu_torch import kernels
    by_source = kernels.build()
    seconds = max(by_source.values(), default=0.0)
    print(json.dumps({"phase": "build", "seconds": seconds,
                      "sources": list(kernels.SOURCES), "seconds_by_source": by_source}))
    # The loop kernels' and the q8 exits' instantiations (resident_kernel<T,
    # Q>: T the level type, Q czrq's; "a" is int8, "13__nv_bfloat16" bf16).
    for name in ("resident", "gru1632", "conv_gru", "motion", "enc_pass", "enc_point", "corr_alt",
                 "enc_stem"):
        print(json.dumps({"phase": "ptxas", "source": name,
                          "kernels": _ptxas_usage(kernels.build_log(name))}))
    # The pass engine's dynamic shared memory at each pass the main paths
    # run (pass_sm90_kernel<N>: N the columns a block computes).
    from raft_stereo_tpu_torch.ops.encoder import pass_plan
    plans = [(kind, cin, cout, *pass_plan(kind, 96, 312, cin, cout)[1:])
             for kind, cin, cout in (("mid1", 64, 64), ("mid2", 64, 64), ("raw1", 96, 96),
                                     ("mid1", 128, 128), ("raw1", 128, 384))]
    print(json.dumps({"phase": "smem", "source": "enc_pass",
                      "passes": [{"kind": k, "cin": ci, "cout": co, "block_columns": n,
                                  "dynamic_smem_bytes": b, "blocks_per_sm": nb}
                                 for k, ci, co, n, b, nb in plans]}))
    # The loop engine's (csrc/loop_conv_sm90.cuh: the resident kernel and the
    # serial motion and gru08 + head launches) block.
    from raft_stereo_tpu_torch.ops.resident import loop_plan
    print(json.dumps({"phase": "smem", "source": "resident", **loop_plan()}))
    import ctypes
    for lane8 in (0, 1):  # gru1632_kernel<bf16>, <int8_t>
        plan = (ctypes.c_int * 3)()
        kernels.check("gru1632_plan", kernels.entry("gru1632_plan")(lane8, plan))
        print(json.dumps({"phase": "smem", "source": "gru1632", "lane8": bool(lane8),
                          "dynamic_smem_bytes": plan[0], "threads": plan[1],
                          "blocks_per_sm": plan[2]}))
    return seconds


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _lookup_sector_bytes(ops, coords) -> int:
    """Bytes of the 32-byte sectors of the levels that this run's windows
    reach: a (pixel, level)'s taps inside its row, from max(pos, 0) to
    min(pos + 2r + 1, w - 1), at the level tensor's own addresses."""
    x = coords.reshape(-1).float()
    r = ops.radius
    rows = ops.levels8 if ops.pack8 else ops.levels
    p = torch.arange(x.numel(), device=x.device, dtype=torch.int64)
    sectors = 0
    for l, (lvl, w) in enumerate(zip(rows, ops.widths)):
        cl = x * (1.0 / (1 << l))
        pos = torch.clamp(torch.floor(cl), -r - 2, w + r + 1).long() - r
        lo, hi = pos.clamp_min(0), (pos + 2 * r + 1).clamp_max(w - 1)
        first = lvl.data_ptr() + (p * w + lo) * lvl.element_size()
        last = lvl.data_ptr() + (p * w + hi + 1) * lvl.element_size() - 1
        sectors += int(torch.where(lo <= hi, last // 32 - first // 32 + 1, 0).sum())
    return 32 * sectors


def check_lookup(pack8: bool = False, headline: bool = False) -> dict:
    """Kernel 1 at the main path's shapes: bf16 pyramid of a 96x312 frame,
    coords spread past both ends of the row; with ``pack8`` its int8 levels
    (RAFT_CORR_PACK8=1); with ``headline`` at the Middlebury-F features,
    504x744, which no path of phase 4 looks up (a check beside the paths).
    Also on a frame-like field (frame_coords; ``ms_frame_coords``).
    Tolerance 0: the kernel and the plain version do the same fp32
    operations in the same order. ``bound_ms`` counts the useful bytes;
    ``sector_floor_ms`` the 32-byte sectors this run's windows reach instead
    of their taps' bytes, with the coords and the outputs."""
    from raft_stereo_tpu_torch.corr import reg_cuda
    g = _gen(1)
    h, w = ALT_HEADLINE_FEAT if headline else FEAT
    f1 = _randn((1, h, w, 256), g)
    f2 = _randn((1, h, w, 256), g)
    ops = _with_env({"RAFT_CORR_PACK8": "1" if pack8 else "0"},
                    lambda: reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4))
    del f1, f2
    if ops.pack8 != pack8:
        raise SystemExit(f"RAFT_CORR_PACK8={int(pack8)} built pack8={ops.pack8} operands")
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    fcoords = frame_coords(g, h, w)
    err = max(_max_err(reg_cuda.lookup(ops, c), reg_cuda.lookup_plain(ops, c))
              for c in (coords, fcoords))
    torch.cuda.synchronize()
    npix = h * w
    k = 9
    # coords; the 2r+2 taps of 4 levels (bf16, or int8 and the scales); out.
    tap_bytes = 1 if pack8 else 2
    scale_bytes = 16 if pack8 else 0
    nbytes = npix * (4 + 4 * (k + 1) * tap_bytes + 4 * k * 2) + scale_bytes
    flops = npix * 4 * k * 3 + (npix * 4 * (k + 1) if pack8 else 0)
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_FP32)
    floor = {}
    for suffix, c in (("", coords), ("_frame_coords", fcoords)):
        floor_bytes = _lookup_sector_bytes(ops, c) + npix * (4 + 4 * k * 2) + scale_bytes
        floor[f"sector_floor_bytes{suffix}"] = floor_bytes
        floor[f"sector_floor_ms{suffix}"] = floor_bytes / PEAK_BYTES * 1e3
    frame = _checked_ms(lambda: reg_cuda.lookup(ops, fcoords))
    out = {"name": "corr_lookup:pack8" if pack8 else "corr_lookup", "counter": "corr_lookup",
           "tol": 0.0, "max_abs_err": err,
           **_timings(lambda: reg_cuda.lookup(ops, coords),
                      lambda: reg_cuda.lookup_plain(ops, coords)),
           "ms_frame_coords": frame["ms"], "events_ms_frame_coords": frame["events_ms"],
           "bound_ms": bound_ms, "bound_by": bound_by, **floor,
           "shape": f"1x{h}x{w}, 4 levels, r=4, {'int8' if pack8 else 'bf16'}"}
    if pack8:
        out.update(variant="corr_lookup:pack8", on_path="pack8_serial",
                   replaces="raft_stereo_tpu/corr/pallas_reg.py:745")
    if headline:
        out.update(name=f"{out['name']} {h}x{w}", on_path=None)
    return out


def frame_coords(g: torch.Generator, h: int, w: int) -> torch.Tensor:
    """A frame-like (1, h, w) x field for the alt kernel: each pixel's own
    column less a smooth disparity between 0 and W/8, plus up to 2 px of
    noise either way, as the refinement loop's coordinates are (a tile of
    consecutive pixels then reaches a window of about its own width)."""
    yy = torch.linspace(0.0, 1.0, h, device="cuda")[:, None]
    xx = torch.linspace(0.0, 1.0, w, device="cuda")[None, :]
    disp = (w / 8) * 0.5 * (1.0 + torch.sin(2 * math.pi * (1.3 * xx + 0.7 * yy)))
    noise = torch.rand((h, w), generator=g, device="cuda") * 4 - 2
    return (torch.arange(w, device="cuda")[None, :] - disp + noise)[None].float()


def check_alt(path: str, h: int, w: int) -> dict:
    """The alt kernel at a main path's feature shape (D=256, bf16, 4 levels,
    radius 4), coords spread past both ends of the row: the correctness
    case, and its worst, where a tile's window is the whole row. Tolerance:
    1 bf16 ulp of the plain version, whose fp32 row product sums each dot in
    another order, so the one downcast may land on the other side. Also
    timed, and held to the same tolerance, on a frame-like field
    (``frame_coords``: ``ms_frame_coords``). The bound counts what the taps
    need (the 2r+2 dots a level, in bf16 on the tensor cores);
    ``full_row_gflop`` is what the TPU kernel computes, every entry of every
    row's correlation block."""
    from raft_stereo_tpu_torch.corr import alt_cuda
    g = _gen(2)
    d, levels, k = 256, 4, 9
    f1, f2 = _randn((1, h, w, d), g), _randn((1, h, w, d), g)
    ops = alt_cuda.build_alt_operands(f1, f2, num_levels=levels, radius=4)
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    frame = frame_coords(g, h, w)
    got = alt_cuda.lookup(ops, coords)
    ref = alt_cuda.lookup_plain(ops, coords)
    again = alt_cuda.lookup(ops, coords)
    ulps_frame = _ulp_err(alt_cuda.lookup(ops, frame), alt_cuda.lookup_plain(ops, frame))[0]
    torch.cuda.synchronize()
    ulps, share = _ulp_err(got, ref)
    npix, wsum = h * w, sum(ops.widths)
    nbytes = npix * d * 2 + h * wsum * d * 2 + npix * 4 + npix * levels * k * 2
    flops = npix * levels * (k + 1) * 2 * d
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16)
    reps, warmup = (20, 3) if npix <= FEAT[0] * FEAT[1] else (5, 1)
    return {"name": f"corr_alt {h}x{w}", "counter": "corr_alt", "on_path": path,
            "tol": PASS_ULPS, "tol_unit": "bf16 ulps", "max_ulps": ulps,
            "share_differing": share, "max_abs_err": _max_err(got, ref),
            "max_ulps_frame_coords": ulps_frame,
            "ok": ulps <= PASS_ULPS and ulps_frame <= PASS_ULPS and torch.equal(got, again),
            "deterministic": torch.equal(got, again),
            **_timings(lambda: alt_cuda.lookup(ops, coords),
                       lambda: alt_cuda.lookup_plain(ops, coords), reps, warmup),
            **{f"{k}_frame_coords": v for k, v in _checked_ms(
                lambda: alt_cuda.lookup(ops, frame), reps, warmup).items()},
            "bound_ms": bound_ms, "bound_by": bound_by,
            "full_row_gflop": 2.0 * npix * wsum * d / 1e9,
            "shape": f"1x{h}x{w}x{d}, 4 levels, r=4, bf16"}


def _gru_case(g, level, h, w, ch, parts, head: bool):
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import stream
    gru = ConvGRU(ch, sum(parts))
    fh = FlowHead(ch, 256, 2)
    init_weights(gru, torch.Generator().manual_seed(2))
    init_weights(fh, torch.Generator().manual_seed(3))
    gru, fh = gru.cuda(), fh.cuda()
    hst = _randn((1, h, w, ch), g, 0.5)
    xs = [_randn((1, h, w, c), g) for c in parts]
    ctx = [_randn((1, h, w, ch), g, 0.3) for _ in range(3)]
    with torch.no_grad():
        wts = stream.gru_weights(gru, torch.bfloat16, level)
        hw = stream.head_weights(fh, torch.bfloat16) if head else None
        czrq = stream.prepare_gru_context(gru, ctx, torch.bfloat16)
    return wts, hw, hst, czrq, xs


def _lane8(t):
    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    return quantize_feature8(t)


def _lane8_row(out: dict, variant: str, on_path: str, replaces: str, bf16_kernel,
              reps: int = 20, warmup: int = 3) -> dict:
    """A lane8 mode's row: its variant, the path that runs it, the TPU
    kernel it replaces and the bf16 mode's device ms in this call."""
    out.update(name=f"{out['name']}:lane8", variant=variant, on_path=on_path,
               replaces=replaces, bf16_ms=_device_ms(bf16_kernel, reps, warmup))
    return out


def check_gru(level: str, lane8: bool = False, realtime: bool = False) -> dict:
    """Kernel 2 at one GRU level's main-path shapes. Tolerance: the kernel
    sums in another order than cuDNN's fp32 conv, so a bf16 rounding of
    z, r, q (or f1) can land one ulp apart and carry into h' (and dx):
    |err| <= 2^-5 (8 bf16 ulps at 1.0) for h' in [-1, 1], and 2^-5 of the
    RMS of dx for dx. A wrong tap, halo or border moves dx by about its RMS,
    32x that bound; the measured error sits several times under it (PERF.md).
    With ``lane8`` on the int8 container of the same czrq (RAFT_LANE_PACK8),
    the same tolerances, and the bf16 mode's ms beside it. With
    ``realtime`` gru16 at the realtime model's shape: 24x78, one x input
    (two GRU levels: gru08's state pooled)."""
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(4)
    ch = 128
    h, w = {"gru08": FEAT, "gru16": (FEAT[0] // 2, FEAT[1] // 2),
            "gru32": (FEAT[0] // 4, FEAT[1] // 4)}[level]
    parts = {"gru08": (128, 128), "gru16": (128, 128), "gru32": (128,)}[level]
    if realtime:
        (h, w), parts = (RT_FEAT[0] // 2, RT_FEAT[1] // 2), (128,)
    head = level == "gru08"
    wts, hw, hst, czrq_bf16, xs = _gru_case(g, level, h, w, ch, parts, head)
    czrq = _lane8(czrq_bf16) if lane8 else czrq_bf16
    with torch.no_grad():
        got_h, got_dx = stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)
        ref_h, ref_dx = stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err = _max_err(got_h, ref_h)
    detail = {"max_abs_err_h": err}
    ok = err <= tol
    if head:
        dx_rms = float(ref_dx.square().mean().sqrt())
        dx_err = _max_err(got_dx, ref_dx)
        detail.update(max_abs_err_dx=dx_err, tol_dx=tol * dx_rms, dx_rms=dx_rms)
        ok = ok and dx_err <= tol * dx_rms
        err = max(err, dx_err)
    npix = h * w
    cx = sum(parts)
    macs = _gru_macs(ch, cx)
    wbytes = 9 * (ch + cx) * 3 * ch * 2 + 9 * ch * ch * 2
    nbytes = npix * (2 * (ch + cx + ch) + 3 * ch * (1 if lane8 else 2))
    if head:
        macs += 9 * (ch * 256 + 256)
        wbytes += 9 * ch * 256 * 2 + 9 * 256 * 2
        nbytes += npix * 4
    bound_ms, bound_by = _bound(nbytes + wbytes, 2.0 * macs * npix, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)

    def plain():
        with torch.no_grad():
            stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)

    out = {"name": f"conv_gru:{level}{'+head' if head else ''}"
                   + (f" {h}x{w}" if realtime else ""),
           "counter": f"conv_gru:{level}", "tol": tol, "ok": ok, "max_abs_err": err,
           **detail, **_timings(kernel, plain, own=OWN_KERNELS["conv_gru"]),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "shape": f"1x{h}x{w}x{ch}, x parts {list(parts)}, bf16"
                    f"{', czrq int8' if lane8 else ''}"}
    if realtime:
        out["on_path"] = "realtime"
    if not lane8:
        return out

    def bf16_kernel():
        with torch.no_grad():
            stream.fused_conv_gru(wts, hst, czrq_bf16, *xs, head=hw)

    return _lane8_row(out, f"conv_gru:{level}:lane8", "lane8_serial",
                      "raft_stereo_tpu/ops/pallas_stream.py:238", bf16_kernel)


def check_motion() -> dict:
    """Kernel 3 at the main path's shapes. Tolerance as for the GRU: a
    bf16 rounding one ulp apart in c1/f1/c2/f2 carries into the fused
    channels, |err| <= 2^-5 of max(1, max|fused|), the scale taken over the
    fused channels only. The two flow channels the kernel copies must equal
    the flow bit for bit."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(5)
    h, w = FEAT
    enc = BasicMotionEncoder(36)
    init_weights(enc, torch.Generator().manual_seed(6))
    enc = enc.cuda()
    corr = _randn((1, h, w, 36), g)
    flow = torch.cat([_randn((1, h, w, 1), g, 4.0),
                      torch.zeros((1, h, w, 1), device="cuda", dtype=torch.bfloat16)], -1)
    with torch.no_grad():
        wts = stream.motion_weights(enc, torch.bfloat16)
        got = stream.fused_motion(wts, flow, corr)
        ref = stream.motion_plain(wts, flow, corr)
    torch.cuda.synchronize()
    cf = wts.cf
    scale = max(1.0, float(ref[..., :cf].float().abs().max()))
    err = _max_err(got, ref)
    tol = 2.0 ** -5 * scale
    flow_exact = torch.equal(got[..., cf:], flow)
    npix = h * w
    macs = 36 * 64 + 49 * 64 + 2 * 9 * 64 * 64 + 9 * 128 * 126
    nbytes = npix * (36 * 2 + 2 * 2 + 128 * 2) + 2 * (36 * 64 + 49 * 64 + 9 * 128 * 254)
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs * npix, PEAK_BF16)
    return {"name": "motion", "counter": "motion", "tol": tol,
            "ok": err <= tol and flow_exact, "max_abs_err": err,
            "flow_channels_exact": flow_exact,
            **_timings(lambda: stream.fused_motion(wts, flow, corr),
                       lambda: stream.motion_plain(wts, flow, corr), own=OWN_KERNELS["motion"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"1x{h}x{w}, corr 36, bf16"}


def _serial_gru1632(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p):
    """The serial CUDA route the gru16+32 kernel replaces."""
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    h32n, _ = stream.fused_conv_gru(w32, h32, czrq32, x1p)
    h16n, _ = stream.fused_conv_gru(w16, h16, czrq16, x0p,
                                    interp_align_corners(h32n, tuple(h16.shape[1:3])))
    return h16n, h32n


def _gru_macs(ch: int, cx: int) -> int:
    """MACs a pixel of one ConvGRU step: gates over [h; x], q over r*h."""
    return 9 * (cx * 3 * ch + ch * 2 * ch + ch * ch)


def check_gru1632(lane8: bool = False, headline: bool = False) -> dict:
    """Kernel 4 at the main path's shapes (gru16 48x156, gru32 24x78, 128
    channels; with ``headline`` the Middlebury-F frame's, 252x372 and
    126x186, timed over 5 calls after 1). Tolerance as for the GRU kernel,
    2^-5 on both states; and bit for bit the serial CUDA chain (two GRU
    launches and the resize). With ``lane8`` on int8 czrq containers,
    against the serial lane8 chain."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import ConvGRU
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(11)
    ch, bf = 128, torch.bfloat16
    fh, fw = ALT_HEADLINE_FEAT if headline else FEAT
    (h16, w16), (h32, w32) = (fh // 2, fw // 2), (fh // 4, fw // 4)
    reps, warmup = (5, 1) if headline else (20, 3)
    g16, g32 = ConvGRU(ch, 2 * ch), ConvGRU(ch, ch)
    init_weights(g16, torch.Generator().manual_seed(12))
    init_weights(g32, torch.Generator().manual_seed(13))
    g16, g32 = g16.cuda(), g32.cuda()
    with torch.no_grad():
        args = (stream.gru_weights(g16, bf, "gru16"), stream.gru_weights(g32, bf, "gru32"),
                _randn((1, h16, w16, ch), g, 0.5), _randn((1, h32, w32, ch), g, 0.5),
                stream.prepare_gru_context(g16, [_randn((1, h16, w16, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                stream.prepare_gru_context(g32, [_randn((1, h32, w32, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                _randn((1, h16, w16, ch), g), _randn((1, h32, w32, ch), g))
        bf16_args = args
        if lane8:
            args = (*args[:4], _lane8(args[4]), _lane8(args[5]), *args[6:])
        got = stream.fused_gru1632(*args)
        ref = stream.gru1632_plain(*args)
        serial = _serial_gru1632(*args)
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err = max(_max_err(a, b) for a, b in zip(got, ref))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, serial))
    n16, n32 = h16 * w16, h32 * w32
    macs = n32 * _gru_macs(ch, ch) + n16 * _gru_macs(ch, 2 * ch)
    wbytes = 2 * (9 * (2 * ch) * 3 * ch + 9 * (3 * ch) * 3 * ch + 2 * 9 * ch * ch)
    nbytes = (n16 + n32) * (2 * (ch + ch + ch) + 3 * ch * (1 if lane8 else 2)) + wbytes
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            stream.fused_gru1632(*args)

    def plain():
        with torch.no_grad():
            stream.gru1632_plain(*args)

    def chain():
        with torch.no_grad():
            _serial_gru1632(*args)

    out = {"name": f"gru1632 {h16}x{w16}" if headline else "gru1632", "counter": "gru1632",
           "tol": tol, "ok": err <= tol and bitwise,
           "max_abs_err": err, "bitwise_equal_serial": bitwise,
           **_timings(kernel, plain, reps, warmup, own=OWN_KERNELS["gru1632"]),
           "serial_ms": _device_ms(chain, reps, warmup), "bound_ms": bound_ms,
           "bound_by": bound_by,
           "shape": f"gru16 1x{h16}x{w16}, gru32 1x{h32}x{w32}, {ch} ch, bf16"
                    f"{', czrq int8' if lane8 else ''}"}
    if headline:
        out["on_path"] = "headline"
    if not lane8:
        return out

    def bf16_kernel():
        with torch.no_grad():
            stream.fused_gru1632(*bf16_args)

    return _lane8_row(out, "gru1632:lane8", "lane8_headline" if headline else "lane8",
                      "raft_stereo_tpu/ops/pallas_stream.py:814", bf16_kernel, reps, warmup)


def check_resident(pack8: bool = False, lane8: bool = False, realtime: bool = False) -> dict:
    """Kernel 6 at the main path's shapes (96x312, 128 channels, the pyramid
    of 256-channel feature maps, x2 the upsampled gru16 state); with
    ``pack8`` on its int8 levels, with ``lane8`` on an int8 czrq container;
    with ``realtime`` at the realtime model's 48x156, x2 its 24x78 gru16
    state upsampled.
    Tolerances as for the GRU kernel with the head: 2^-5 for h', 2^-5 of
    the RMS of dx for dx; and bit for bit the serial CUDA chain (lookup,
    motion, GRU with the head) on the same levels and czrq."""
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import resident, stream
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    g = _gen(14)
    ch, bf = 128, torch.bfloat16
    h, w = RT_FEAT if realtime else FEAT
    enc, gru, fh = BasicMotionEncoder(36), ConvGRU(ch, 2 * ch), FlowHead(ch, 256, 2)
    for i, m in enumerate((enc, gru, fh)):
        init_weights(m, torch.Generator().manual_seed(15 + i))
    enc, gru, fh = enc.cuda(), gru.cuda(), fh.cuda()
    fmaps = (_randn((1, h, w, 256), g), _randn((1, h, w, 256), g))
    ops = _with_env({"RAFT_CORR_PACK8": "1" if pack8 else "0"},
                    lambda: reg_cuda.build_corr_operands(*fmaps, num_levels=4, radius=4))
    if ops.pack8 != pack8:
        raise SystemExit(f"RAFT_CORR_PACK8={int(pack8)} built pack8={ops.pack8} operands")
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    flow = torch.cat([_randn((1, h, w, 1), g, 4.0),
                      torch.zeros((1, h, w, 1), device="cuda", dtype=bf)], -1)
    with torch.no_grad():
        args = (stream.motion_weights(enc, bf), stream.gru_weights(gru, bf, "gru08"),
                stream.head_weights(fh, bf), ops, _randn((1, h, w, ch), g, 0.5),
                stream.prepare_gru_context(gru, [_randn((1, h, w, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                coords, flow,
                interp_align_corners(_randn((1, h // 2, w // 2, ch), g), (h, w)) if realtime
                else _randn((1, h, w, ch), g))
        bf16_args = args
        if lane8:
            args = (*args[:5], _lane8(args[5]), *args[6:])
        got = _with_env({"RAFT_LANE_PACK8": "1"} if lane8 else {},
                        lambda: resident.fused_iter(*args))
        ref = resident.fused_iter_plain(*args)

        def chain():
            corr = reg_cuda.lookup(ops, coords)
            motion = stream.fused_motion(args[0], flow, corr)
            return stream.fused_conv_gru(args[1], args[4], args[5], motion, args[8],
                                         head=args[2])

        serial = chain()
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err_h = _max_err(got[0], ref[0])
    dx_rms = float(ref[1].square().mean().sqrt())
    err_dx = _max_err(got[1], ref[1])
    bitwise = all(torch.equal(a, b) for a, b in zip(got, serial))
    npix, k = h * w, 9
    motion_macs = 36 * 64 + 49 * 64 + 2 * 9 * 64 * 64 + 9 * 128 * 126
    macs = npix * (motion_macs + _gru_macs(ch, 2 * ch) + 9 * (ch * 256 + 256))
    wbytes = 2 * (36 * 64 + 49 * 64 + 9 * 128 * 128 + 9 * 128 * 126 + 9 * 3 * ch * 3 * ch
                  + 9 * ch * ch + 9 * ch * 256 + 9 * 256)
    # coords, the 2r+2 taps of 4 levels, flow; h, czrq, x2; h' and dx out.
    tap_bytes = 1 if pack8 else 2
    nbytes = npix * (4 + 4 * (k + 1) * tap_bytes + 2 * 2 + 2 * (ch + ch) + 2 * ch + 4
                     + 3 * ch * (1 if lane8 else 2)) + wbytes
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            resident.fused_iter(*args)

    def plain():
        with torch.no_grad():
            resident.fused_iter_plain(*args)

    def serial_run():
        with torch.no_grad():
            chain()

    timings = _with_env({"RAFT_LANE_PACK8": "1"} if lane8 else {},
                        lambda: {**_timings(kernel, plain, own=OWN_KERNELS["fused_iter"]),
                                 "serial_ms": _device_ms(serial_run)})
    out = {"name": "fused_iter:pack8" if pack8 else "fused_iter", "counter": "fused_iter",
           "tol": tol, "ok": err_h <= tol and err_dx <= tol * dx_rms and bitwise,
           "max_abs_err": max(err_h, err_dx), "max_abs_err_h": err_h, "max_abs_err_dx": err_dx,
           "tol_dx": tol * dx_rms, "dx_rms": dx_rms, "bitwise_equal_serial": bitwise,
           **timings, "bound_ms": bound_ms, "bound_by": bound_by,
           "shape": f"1x{h}x{w}x{ch}, 4 levels r=4 {'int8' if pack8 else 'bf16'}, x2 {ch}, bf16"
                    f"{', czrq int8' if lane8 else ''}"}
    if pack8:
        out.update(variant="fused_iter:pack8", on_path="pack8",
                   replaces="raft_stereo_tpu/ops/pallas_resident.py:97")
    if realtime:
        out.update(name=f"fused_iter {h}x{w}", on_path="realtime")
    if not lane8:
        return out

    def bf16_kernel():
        with torch.no_grad():
            resident.fused_iter(*bf16_args)

    return _lane8_row(out, "fused_iter:lane8", "lane8",
                      "raft_stereo_tpu/ops/pallas_resident.py:250", bf16_kernel)


def _ulp_err(got, ref) -> tuple:
    """(max |got - ref| in bf16 ulps of the reference, share of elements
    that differ at all). An element's magnitude is floored at the map's
    RMS, so values near zero are held to the map's scale."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(r.abs(), r.square().mean().sqrt().clamp_min(1e-6))
    d = (g - r).abs()
    ulps = d / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(ulps.max()), float((d > 0).float().mean())


def _stats_err(got, ref, n: int) -> float:
    """The kernel's statistics against the plain version's fp64 sums: the
    sums relative to sqrt(n * sum of squares) (their bound, so a mean near
    zero is held to the channel's scale), the sums of squares relative to
    themselves; the largest over the channels."""
    sq = ref[1].double()
    e_sum = ((got[0].double() - ref[0].double()).abs() / (n * sq).sqrt()).max()
    e_sq = ((got[1].double() - sq).abs() / sq).max()
    return float(torch.maximum(e_sum, e_sq))


# A thread's fp32 running sums (a pass: the 32 values of its tile; the stem:
# all its block's tiles, ~2,800 values at Middlebury-F), fp64 across blocks.
# Readings on an H100: at most 2.3e-6.
STATS_TOL = 1e-5


def _enc_weights(cin: int, cout: int, k: int, seed: int):
    """A conv's (w, b) as the encoder chains hand them over: OIHW fp32."""
    from raft_stereo_tpu_torch.models.layers import Conv2d, init_weights
    conv = Conv2d(cin, cout, k, padding=k // 2)
    init_weights(conv, torch.Generator().manual_seed(seed))
    return conv.weight.detach().cuda(), conv.bias.detach().cuda()


def _enc_triple(g, shape, stats: bool):
    """A raw conv output with, under instance norm, a mean and inverse
    deviation per channel."""
    raw = _randn(shape, g)
    if not stats:
        return raw, None, None
    c = shape[-1]
    return (raw, torch.randn(c, generator=g, device="cuda") * 0.3,
            torch.rand(c, generator=g, device="cuda") * 1.5 + 0.5)


OWN_KERNELS = {"conv_gru": ("loop_conv_kernel",),
               "motion": ("motion_stage1_kernel", "loop_conv_kernel"),
               "gru1632": ("gru1632_kernel",), "fused_iter": ("resident_kernel",),
               "enc_stem": ("stem_sm90_kernel", "stats_reduce_kernel"),
               "enc_pass": ("pass_sm90_kernel", "stats_reduce_kernel"),
               "enc_point3": ("point3_kernel",), "enc_point2": ("point2_kernel",)}


def _enc_result(variant, path, hw, shape, got, ref, st, st_ref, again, nbytes, flops,
                peak, kernel, plain, library=None, library_note=None) -> dict:
    """The record of one encoder kernel check: outputs in ulps, statistics,
    run-to-run equality, timings and the bound. ``variant`` is the key the
    wrapper counts its launches under, ``path`` the main path that gives the
    kernel this shape ("default": the KITTI frames, "headline": the
    Middlebury-F frame, None: neither; a check beside the paths)."""
    torch.cuda.synchronize()
    h, w = hw
    counter = variant.split(":")[0]
    ulps, share = _ulp_err(got, ref)
    tol = PASS_ULPS
    ok = ulps <= tol and torch.equal(got, again[0])
    out = {"name": f"{variant} {h}x{w}", "counter": counter, "variant": variant,
           "on_path": path, "tol": tol, "tol_unit": "bf16 ulps",
           "max_ulps": ulps, "share_differing": share, "max_abs_err": _max_err(got, ref),
           "deterministic": torch.equal(got, again[0])}
    if st is not None:
        err = _stats_err(st, st_ref, h * w)
        same = torch.equal(st, again[1])
        out.update(stats_rel_err=err, stats_tol=STATS_TOL, stats_deterministic=same)
        ok = ok and err <= STATS_TOL and same
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    # The Middlebury-F maps are 12.5x the KITTI ones: fewer calls a timing.
    reps, warmup = (20, 3) if h * w <= 384 * 1248 else (5, 1)
    out.update(ok=ok, **_timings(kernel, plain, reps, warmup, OWN_KERNELS[counter]),
               bound_ms=bound_ms, bound_by=bound_by, shape=shape)
    if library is not None:
        out["library_ms"] = _device_ms(library, reps, warmup)
        out["library_note"] = library_note
    else:
        out["library_note"] = ("no single PyTorch call computes this function (the input "
                               "transform, the statistics or the exit take further calls)")
    return out


def _norm_name(instance: bool) -> str:
    return "instance" if instance else "bn"


def check_stem(path, h: int, w: int, stats: bool) -> dict:
    """The stem at one frame size, without statistics (the context net) and
    with (the feature net). Tolerance: 1 bf16 ulp of the plain version (the
    kernel's fp32 sum runs in another order than cuDNN's, so its one
    rounding may land on the other side), statistics within STATS_TOL of
    the plain version's fp64 sums, two runs bit for bit. Without statistics
    the function is one F.conv2d with bias (bf16, channels-last):
    ``library_ms``."""
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(20)
    x = (torch.rand((1, h, w, 3), generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
    wt, b = _enc_weights(3, 64, 7, 21)
    cw = enc.ConvWeights(wt, b)  # prepared once, as the chains' module_weights are
    got, st = enc.stem(x, cw, None, stats=stats)
    ref, st_ref = enc.stem_plain(x, wt, b, stats=stats)
    again = enc.stem(x, cw, None, stats=stats)
    npix = h * w
    library = note = None
    if not stats:
        xl = x.permute(0, 3, 1, 2)
        wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bl = b.to(torch.bfloat16)
        library = lambda: F.conv2d(xl, wl, bl, 1, 3)  # noqa: E731
        note = "F.conv2d 7x7 pad 3 with bias, bf16, channels-last"
    return _enc_result(
        f"enc_stem:{_norm_name(stats)}", path, (h, w), f"1x{h}x{w}x3 -> 64, bf16",
        got, ref, st, st_ref, again, npix * (3 + 64) * 2 + 147 * 64 * 2,
        2.0 * 147 * 64 * npix, PEAK_BF16, lambda: enc.stem(x, cw, None, stats=stats),
        lambda: enc.stem_plain(x, wt, b, stats=stats), library, note)


def check_pass(path, h: int, w: int, ch: int, kind: str, stats: bool) -> dict:
    """One 3x3 pass at a main-path shape. Tolerances as for the stem.
    ``library_ms``: one F.conv2d with bias of the same conv over the raw
    input, which for the raw1 pass without statistics (the finest heads'
    conv) is the whole function, and for the others the conv only, without
    the input transform and the statistics."""
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(22)
    n_in = 2 if kind == "mid2" else 1
    inputs = [_enc_triple(g, (1, h, w, ch), stats and kind != "raw1") for _ in range(n_in)]
    wt, b = _enc_weights(ch, ch, 3, 23)
    cw = enc.ConvWeights(wt, b)  # prepared once, as the chains' module_weights are
    got, st = enc.conv_pass(kind, inputs, cw, None, stats=stats)
    ref, st_ref = enc.conv_pass_plain(kind, inputs, wt, b, stats=stats)
    again = enc.conv_pass(kind, inputs, cw, None, stats=stats)
    npix = h * w
    xl = inputs[0][0].permute(0, 3, 1, 2)
    wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = b.to(torch.bfloat16)
    note = "F.conv2d 3x3 pad 1 with bias, bf16, channels-last"
    if kind != "raw1" or stats:
        note += (": the conv only, over the raw input, without the input transform"
                 if kind != "raw1" else ": the conv only") + \
                (" and the statistics" if stats else "")
    library = lambda: F.conv2d(xl, wl, bl, 1, 1)  # noqa: E731
    return _enc_result(
        f"enc_pass:{kind}/{_norm_name(stats)}/{ch}", path, (h, w), f"1x{h}x{w}x{ch}, bf16",
        got, ref, st, st_ref, again,
        npix * (n_in + 1) * ch * 2 + 9 * ch * ch * 2, 2.0 * 9 * ch * ch * npix, PEAK_BF16,
        lambda: enc.conv_pass(kind, inputs, cw, None, stats=stats),
        lambda: enc.conv_pass_plain(kind, inputs, wt, b, stats=stats), library, note)


def check_point(path, which: int, h: int, w: int, ch: int, norm: bool) -> dict:
    """point3 (layer1's exit) or point2 (a block's exit). Tolerance 1 bf16
    ulp: the kernel and the plain version do the same fp32 operations, but
    the library's fused elementwise kernels may contract or reorder them."""
    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(24)
    shape = (1, h, w, ch)
    if which == 3:
        args = tuple(_enc_triple(g, shape, True) for _ in range(3))
        kernel, plain = enc.point3, enc.point3_plain
    else:
        args = (_randn(shape, g), _enc_triple(g, shape, True))
        kernel, plain = enc.point2, enc.point2_plain
    got, ref, again = kernel(*args, norm=norm), plain(*args, norm=norm), kernel(*args, norm=norm)
    npix = h * w
    return _enc_result(
        f"enc_point{which}:{_norm_name(norm)}/{ch}", path, (h, w), f"1x{h}x{w}x{ch}, bf16",
        got, ref, None, None, (again,),
        npix * ch * 2 * (which + 1), 4.0 * which * npix * ch, PEAK_FP32,
        lambda: kernel(*args, norm=norm), lambda: plain(*args, norm=norm))


Q8_PASS = "enc_pass:raw1/bn/128/q8"  # a zqr context conv under RAFT_LANE_PACK8
Q8_STEPS = 2.0  # quantization steps: one from a bf16 ulp of the value, one of the amax


def _q8_steps(lane, ref) -> float:
    """max |difference| of two int8 containers' values, in quantization
    steps of the larger scale."""
    d = (lane.q.float() * lane.scale - ref.q.float() * ref.scale).abs().max()
    return float(d / torch.maximum(lane.scale, ref.scale))


def _launches_per_call(fn, reps: int = 5, windows: int = 3) -> tuple[int, list[int]]:
    """Kernels, fills and copies one call of ``fn`` puts on the card
    (torch.profiler over ``reps`` calls, rounded: a lost event does not
    change the count), and the events each profiler window read. A window
    that reads under one launch a call has lost events (every call
    launches), as the profiler was seen to do once in a whole run: it is
    taken again, up to ``windows`` times, and every window's count is
    returned so that a repeat shows in the record."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts: list[int] = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
        if round(counts[-1] / reps):
            break
    return round(counts[-1] / reps), counts


def _q8_result(variant, path, hw, shape, lane, again, host, ref, nbytes, flops, peak, kernel,
               plain, bf16_kernel, own, library=None, library_note=None,
               launches_per_call=None) -> dict:
    """The record of a quantize-on-exit check: bit for bit the host
    quantization of the same kernel's bf16 output, equal over two runs, and
    within Q8_STEPS of the plain version's container; ``bf16_ms`` the bf16
    mode's device ms in this call; ``launches_per_call`` what one call puts
    on the card, beside ``own``, the names of the kernels it launches, and
    held to ``launches_per_call`` where that is given."""
    torch.cuda.synchronize()
    h, w = hw
    bitwise = torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
    same = torch.equal(lane.q, again.q) and torch.equal(lane.scale, again.scale)
    steps = _q8_steps(lane, ref)
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    reps, warmup = (20, 3) if h * w <= FEAT[0] * FEAT[1] else (5, 1)
    launches, windows = _launches_per_call(kernel)
    out = {"name": f"{variant} {h}x{w}", "counter": variant.split(":")[0], "variant": variant,
           "on_path": path, "tol": Q8_STEPS, "tol_unit": "quantization steps",
           "max_steps": steps, "max_abs_err": steps * float(lane.scale),
           "bitwise_equal_host_quantization": bitwise, "deterministic": same,
           "scale": float(lane.scale), "own": list(own), "launches_per_call": launches,
           "profiler_windows": windows,
           "ok": bitwise and same and steps <= Q8_STEPS
           and launches_per_call in (None, launches),
           **_timings(kernel, plain, reps, warmup, own),
           "bf16_ms": _device_ms(bf16_kernel, reps, warmup),
           "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape,
           "library_ms": None if library is None else _device_ms(library, reps, warmup),
           "library_note": library_note or "no single PyTorch call computes this function"}
    return out


def check_pass_q8(path, h: int, w: int) -> dict:
    """A zqr context conv (128 -> 384, 3x3, bias, over a relu'd map) as the
    quantize-on-exit pass (RAFT_LANE_PACK8) at a main path's shape. The one
    F.conv2d of the same conv is ``library_ms``: the conv only, without the
    quantization."""
    import torch.nn.functional as F

    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(26)
    inputs = [(torch.relu(_randn((1, h, w, 128), g)), None, None)]
    wt, b = _enc_weights(128, 384, 3, 27)
    cw = enc.ConvWeights(wt, b)  # prepared once, as the chains' module_weights are

    def kernel():
        return enc.conv_pass("raw1", inputs, cw, None, stats=False, quant=True)[0]

    def plain():
        return enc.conv_pass_plain("raw1", inputs, wt, b, stats=False, quant=True)[0]

    def bf16_kernel():
        return enc.conv_pass("raw1", inputs, cw, None, stats=False)[0]

    xl = inputs[0][0].permute(0, 3, 1, 2)
    wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = b.to(torch.bfloat16)
    npix = h * w
    return _q8_result(
        Q8_PASS, path, (h, w), f"1x{h}x{w}x128 -> 384, bf16 -> int8", kernel(), kernel(),
        quantize_feature8(bf16_kernel()), plain(),
        npix * (128 * 2 + 384) + 9 * 128 * 384 * 2, 2.0 * 9 * 128 * 384 * npix, PEAK_BF16,
        kernel, plain, bf16_kernel, ("pass_sm90_kernel", "quant_map_kernel"),
        lambda: F.conv2d(xl, wl, bl, 1, 1),
        "F.conv2d 3x3 pad 1, 128 -> 384, with bias, bf16, channels-last: the conv only, "
        "without the quantization")


def check_point2_q8(path, h: int, w: int, norm: bool) -> dict:
    """point2 with the quantize-on-exit epilogue (``_point2_q8_kernel``):
    one cooperative launch a call, no fill before it."""
    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(29)
    shape = (1, h, w, 128)
    x, y = _randn(shape, g), _enc_triple(g, shape, True)

    def kernel():
        return enc.point2(x, y, norm=norm, quant=True)

    def plain():
        return enc.point2_plain(x, y, norm=norm, quant=True)

    def bf16_kernel():
        return enc.point2(x, y, norm=norm)

    npix = h * w
    return _q8_result(
        f"enc_point2:{_norm_name(norm)}/128/q8", path, (h, w), f"1x{h}x{w}x128, bf16 -> int8",
        kernel(), kernel(), quantize_feature8(bf16_kernel()), plain(), npix * 128 * 5,
        8.0 * npix * 128, PEAK_FP32, kernel, plain, bf16_kernel, ("point2_q8_kernel",),
        launches_per_call=1)


def check_resblock_q8_chains(model) -> dict:
    """``stream_resblock_q8``, the only caller of the point2 q8 exit (no
    model path runs it), on the main paths' resblock shapes: layer3[1] of
    the context net (folded BatchNorm) and of the feature net (instance
    norm) over a 96x312x128 and a 504x744x128 map. The launch counts are
    set to 0 before the four chains and read after: the point2 q8 rows'
    path. Each chain's container must equal, bit for bit, the host
    quantization of the kernel route's bf16 chain, and stay within
    Q8_STEPS, plus the bf16 chains' own difference, of the plain route's."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    from raft_stereo_tpu_torch.ops import encoder as enc
    g = _gen(28)
    cases = []
    for size, (h, w) in (("KITTI", FEAT), ("Middlebury-F", ALT_HEADLINE_FEAT)):
        x = torch.relu(_randn((1, h, w, 128), g))
        for norm_fn, block in (("batch", model.cnet.layer3[1]), ("instance", model.fnet.layer3[1])):
            cases.append((f"stream_resblock_q8 {norm_fn}, {size}", block, x, norm_fn))
    failed = []
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launches()
        lanes = [enc.stream_resblock_q8(block, x, nf) for _, block, x, nf in cases]
        torch.cuda.synchronize()
        run = {"path": "stream_resblock_q8 chains", "frames": 1,
               "launches": dict(kernels.launches), "variants": dict(kernels.variants)}
        run.update(launches_per_frame=[run["launches"]], variants_per_frame=[run["variants"]])
        for (name, block, x, nf), lane in zip(cases, lanes):
            bf = enc.stream_resblock(block, x, nf)
            host = quantize_feature8(bf)
            with _plain_encoder_route():
                ref_bf = enc.stream_resblock(block, x, nf)
                ref = enc.stream_resblock_q8(block, x, nf)
            torch.cuda.synchronize()
            bitwise = torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
            ulps, _ = _ulp_err(bf, ref_bf)
            dv = _max_err(bf, ref_bf) / float(torch.maximum(lane.scale, ref.scale))
            steps = _q8_steps(lane, ref)
            ok = bitwise and ulps <= CHAIN_ULPS and steps <= dv + Q8_STEPS
            print(json.dumps({"phase": "chain", "name": name, "ok": ok,
                              "bitwise_equal_host_quantization": bitwise,
                              "bf16_max_ulps": ulps, "tol_ulps": CHAIN_ULPS,
                              "max_steps": steps, "tol_steps": dv + Q8_STEPS}))
            if not ok:
                failed.append(name)
    run["variants_expected"] = {"enc_point2:bn/128/q8": 2, "enc_point2:instance/128/q8": 2}
    if {k: n for k, n in run["variants"].items() if k.startswith("enc_point2")} != \
            run["variants_expected"]:
        raise SystemExit(f"stream_resblock_q8 chains launched {run['variants']}")
    if failed:
        raise SystemExit(f"stream_resblock_q8 chains disagree: {failed}")
    return run


class _plain_encoder_route:
    """Inside, the encoder chains run the plain versions on the card too."""

    NAMES = ("stem", "conv_pass", "point3", "point2")

    def __enter__(self):
        from raft_stereo_tpu_torch.ops import encoder as enc
        self.saved = {n: getattr(enc, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(enc, n, getattr(enc, f"{n}_plain"))

    def __exit__(self, *exc):
        from raft_stereo_tpu_torch.ops import encoder as enc
        for n, fn in self.saved.items():
            setattr(enc, n, fn)


def check_chains() -> dict:
    """The context net's fused stem + layer1 at the KITTI frame, one
    streamed residual block (layer3[1], 96x312x128) and the feature net's
    fused stem + layer1 at the KITTI and the Middlebury-F frame, of the
    seeded model, kernel route against plain route on the card. A rounding
    that flips in one pass is carried through the later convolutions and
    exits, so the chains are held to CHAIN_ULPS bf16 ulps; the share of
    elements that differ at all is printed. Then the quantize-on-exit
    resblocks (check_resblock_q8_chains), whose launch record it returns."""
    from raft_stereo_tpu_torch.ops import encoder as enc
    model = seeded_model("cuda")
    g = _gen(25)
    image = (torch.rand((1, 384, 1248, 3), generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
    feat = torch.relu(_randn((1, 96, 312, 128), g))
    big = (torch.rand((1, *MIDDLEBURY_F, 3), generator=g, device="cuda") * 2 - 1
           ).to(torch.bfloat16)
    cases = {"fused_stem_layer1": lambda: enc.fused_stem_layer1(model.cnet, image),
             "stream_resblock": lambda: enc.stream_resblock(model.cnet.layer3[1], feat, "batch"),
             "fused_in_stem_layer1": lambda: enc.fused_in_stem_layer1(model.fnet, image),
             "fused_in_stem_layer1, Middlebury-F":
                 lambda: enc.fused_in_stem_layer1(model.fnet, big)}
    failed = []
    with torch.no_grad():
        for name, fn in cases.items():
            got = fn()
            with _plain_encoder_route():
                ref = fn()
            torch.cuda.synchronize()
            ulps, share = _ulp_err(got, ref)
            ok = ulps <= CHAIN_ULPS
            print(json.dumps({"phase": "chain", "name": name, "ok": ok, "max_ulps": ulps,
                              "tol_ulps": CHAIN_ULPS, "share_differing": share,
                              "max_abs_err": _max_err(got, ref)}))
            if not ok:
                failed.append(name)
            del got, ref
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"encoder chains disagree with their plain route: {failed}")
    return check_resblock_q8_chains(model)


def encoder_checks() -> list:
    """Every encoder kernel, in both norm variants, at the shapes of both
    main paths. The KITTI frames give the kernels the context net's
    (folded BatchNorm) launches only, so at those shapes the instance-norm
    variants are checks beside the paths (``on_path`` None, left out of the
    kernels line); the Middlebury-F frame runs both variants."""
    results = []
    for path, (full, half, quarter) in SHAPES.items():
        for stats in (False, True):
            on = path if path == "headline" or not stats else None
            results.append(check_stem(on, *full, stats))
            for kind in ("mid1", "mid2"):
                results.append(check_pass(on, *full, 64, kind, stats))
            for (h, w), ch in ((half, 96), (quarter, 128)):
                for kind in ("raw1", "mid1"):
                    results.append(check_pass(on, h, w, ch, kind, stats))
                results.append(check_point(on, 2, h, w, ch, stats))
            results.append(check_point(on, 3, *full, 64, stats))
        torch.cuda.empty_cache()
    return results


def lane8_checks() -> list:
    """The RAFT_LANE_PACK8 modes at the main paths' shapes: the three GRU
    kernels on int8 czrq (the serial GRU at each KITTI level, gru16+32 and
    the resident iteration, the last two bit for bit their serial lane8
    chains), the quantize-on-exit pass at the zqr convs' shapes (KITTI
    96x312, 48x156, 24x78; Middlebury-F 504x744) and point2 q8 at the
    resblock shapes, both norms."""
    (h, w), (hh, wh) = FEAT, ALT_HEADLINE_FEAT
    out = [check_gru(level, lane8=True) for level in ("gru08", "gru16", "gru32")]
    out += [check_gru1632(lane8=True), check_gru1632(lane8=True, headline=True),
            check_resident(lane8=True)]
    out += [check_pass_q8("lane8", h // k, w // k) for k in (1, 2, 4)]
    out.append(check_pass_q8("lane8_headline", hh, wh))
    out += [check_point2_q8("resblock_q8", *hw, norm) for hw in (FEAT, ALT_HEADLINE_FEAT)
            for norm in (False, True)]
    torch.cuda.empty_cache()
    return out


# Writes past a kernel's outputs (compute-sanitizer refuses this card): every
# buffer a wrapper allocates (torch.empty / torch.empty_like: outputs and
# scratch maps) is placed inside a larger one, OVERRUN_MARGIN bytes of
# OVERRUN_SENTINEL on each side, and the margins must come out unchanged.
OVERRUN_MARGIN = 1 << 20
OVERRUN_SENTINEL = 0xA5
# The frames the check runs: (switches, correlation, the kernels each must
# launch). Every hand-written kernel of a model path is in one of them.
OVERRUN_ROUTES = {
    "default": ({}, "reg_cuda", ("enc_stem", "enc_pass", "enc_point3", "enc_point2",
                                 "gru1632", "fused_iter")),
    "serial": ({"RAFT_FUSE_ITER": "0", "RAFT_FUSE_GRU1632": "0"}, "reg_cuda",
               ("corr_lookup", "conv_gru:gru08", "conv_gru:gru16", "conv_gru:gru32",
                "motion")),
    "alt_cuda": ({}, "alt_cuda", ("corr_alt", "gru1632", "motion", "conv_gru:gru08")),
}


class guarded_allocations:
    """While open, ``torch.empty`` and ``torch.empty_like`` on the card
    return views into sentinel-filled buffers with margins on both sides
    (the view's start keeps the allocator's alignment); ``intact()`` checks
    the margins after a synchronize. The buffers are held until the
    check, so no later allocation reuses a margin."""

    def __init__(self):
        self.buffers = []

    def _alloc(self, shape, dtype):
        n = math.prod(shape) * self._empty((), dtype=dtype).element_size()
        buf = self._empty(2 * OVERRUN_MARGIN + n, dtype=torch.uint8, device="cuda")
        buf.fill_(OVERRUN_SENTINEL)
        self.buffers.append((buf, n))
        return buf[OVERRUN_MARGIN:OVERRUN_MARGIN + n].view(dtype).view(shape)

    def __enter__(self):
        self._empty, self._empty_like = torch.empty, torch.empty_like

        def empty(*size, dtype=None, device=None, **kw):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
            if torch.device(device or "cpu").type != "cuda" or kw:
                return self._empty(*size, dtype=dtype, device=device, **kw)
            return self._alloc(shape, dtype or torch.get_default_dtype())

        def empty_like(t, dtype=None, device=None, **kw):
            if t.device.type != "cuda" or device is not None or kw:
                return self._empty_like(t, dtype=dtype, device=device, **kw)
            return self._alloc(tuple(t.shape), dtype or t.dtype)
        torch.empty, torch.empty_like = empty, empty_like
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like = self._empty, self._empty_like

    def intact(self) -> list:
        """The (buffer bytes, bad margin bytes) of every buffer whose
        margins changed; empty when none did."""
        torch.cuda.synchronize()
        bad = []
        for buf, n in self.buffers:
            head, tail = buf[:OVERRUN_MARGIN], buf[OVERRUN_MARGIN + n:]
            wrong = int((head != OVERRUN_SENTINEL).sum()) + int((tail != OVERRUN_SENTINEL).sum())
            if wrong:
                bad.append((n, wrong))
        return bad


def check_overruns(model, pair, iters: int = 2) -> dict:
    """Every kernel of the model paths at the pair's shapes, through one
    frame of ``iters`` iterations on each of OVERRUN_ROUTES, with every
    output and scratch map a wrapper allocates inside a guarded buffer: no
    margin may change, and each route must launch each of its kernels."""
    import dataclasses

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.serve.session import _view
    routes = {}
    for name, (env, corr, want) in OVERRUN_ROUTES.items():
        view = _view(model, dataclasses.replace(model.cfg, corr_implementation=corr))

        def frame(view=view):
            infer_pair(view, *pair, iters=iters)  # weight layouts cached outside the guard
            torch.cuda.synchronize()
            before = dict(kernels.launches)
            with guarded_allocations() as guard:
                infer_pair(view, *pair, iters=iters)
            bad = guard.intact()
            launched = {k: kernels.launches.get(k, 0) - before.get(k, 0) for k in want}
            return {"ok": not bad and all(launched.values()), "buffers": len(guard.buffers),
                    "launches": launched, "bad_buffers": bad}
        routes[name] = _with_env(env, frame)
    result = {"phase": "overrun", "ok": all(r["ok"] for r in routes.values()),
              "input": "x".join(map(str, pair[0].shape[1:3])), "iters": iters,
              "margin_bytes": OVERRUN_MARGIN, "routes": routes}
    print(json.dumps(result))
    if not result["ok"]:
        raise SystemExit(f"writes past a kernel's outputs, or a kernel not run: {result}")
    return result


# Reads past a kernel's inputs (compute-sanitizer refuses this card): in a
# child process a route, every tensor a kernel wrapper takes as input is
# copied into memory placed with CUDA's virtual memory API so that its last
# byte, plus the slack the kernel declares, meets a page that is reserved
# and never mapped. A read past it faults; a fault kills the CUDA context,
# so each route runs in a process of its own, and a fault names the route.
# OVERREAD_SLACK: the bytes past an input a kernel may read by design. The
# lookup loads its taps as aligned 16-byte units, and reads a unit that is
# not wholly inside its level a byte at a time: its slack is one unit.
OVERREAD_SLACK = {"corr_lookup": 16}
OVERREAD_WAIT_S = 300
# The wrappers that pass tensors to a kernel, by module, and the kernel each
# one launches (the slack's key).
OVERREAD_WRAPPERS = (
    ("raft_stereo_tpu_torch.corr.reg_cuda", "lookup_launch", "corr_lookup"),
    ("raft_stereo_tpu_torch.corr.alt_cuda", "lookup_launch", "corr_alt"),
    ("raft_stereo_tpu_torch.ops.stream", "conv_gru_launch", "conv_gru"),
    ("raft_stereo_tpu_torch.ops.stream", "motion_launch", "motion"),
    ("raft_stereo_tpu_torch.ops.stream", "gru1632_launch", "gru1632"),
    ("raft_stereo_tpu_torch.ops.resident", "fused_iter", "fused_iter"),
    ("raft_stereo_tpu_torch.ops.encoder", "stem", "enc_stem"),
    ("raft_stereo_tpu_torch.ops.encoder", "conv_pass", "enc_pass"),
    ("raft_stereo_tpu_torch.ops.encoder", "_launch_point", "enc_point"),
)


class _CuLocation(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _CuAllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte), ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _CuAllocProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _CuLocation), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _CuAllocFlags)]


class _CuAccessDesc(ctypes.Structure):
    _fields_ = [("location", _CuLocation), ("flags", ctypes.c_int)]


class _DeviceBytes:
    """``nbytes`` bytes at ``ptr`` on the card, for torch.as_tensor."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


class guarded_reads:
    """Places tensors so that each one's end, plus a slack, meets an
    unmapped page (``place``); ``release`` unmaps everything after a
    synchronize. libcuda calls through ctypes, in the context
    torch made current."""

    def __init__(self, device: int = 0):
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.device = device
        self.prop = _CuAllocProp(type=1, requestedHandleTypes=0,  # pinned, no export
                                 location=_CuLocation(type=1, id=device))  # on the device
        gran = ctypes.c_size_t()
        self._call("cuMemGetAllocationGranularity", ctypes.byref(gran),
                   ctypes.byref(self.prop), 0)
        self.gran = gran.value
        self.maps = []  # (va, reserved bytes, mapped bytes, handle)
        self.placed = 0
        self.max_gap = 0  # bytes between an input's end + slack and the page

    def _call(self, name: str, *args) -> None:
        err = getattr(self.cu, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    def place(self, t: torch.Tensor, slack: int) -> torch.Tensor:
        if t.numel() == 0:
            return t
        span = (sum((s - 1) * st for s, st in zip(t.shape, t.stride())) + 1) * t.element_size()
        mapped = -(-(span + slack) // self.gran) * self.gran
        va = ctypes.c_uint64()
        self._call("cuMemAddressReserve", ctypes.byref(va), ctypes.c_size_t(mapped + self.gran),
                   ctypes.c_size_t(self.gran), ctypes.c_uint64(0), ctypes.c_ulonglong(0))
        handle = ctypes.c_ulonglong()
        self._call("cuMemCreate", ctypes.byref(handle), ctypes.c_size_t(mapped),
                   ctypes.byref(self.prop), ctypes.c_ulonglong(0))
        self._call("cuMemMap", va, ctypes.c_size_t(mapped), ctypes.c_size_t(0), handle,
                   ctypes.c_ulonglong(0))
        desc = _CuAccessDesc(location=_CuLocation(type=1, id=self.device), flags=3)  # RW
        self._call("cuMemSetAccess", va, ctypes.c_size_t(mapped), ctypes.byref(desc),
                   ctypes.c_size_t(1))
        self.maps.append((va.value, mapped + self.gran, mapped, handle.value))
        end = va.value + mapped - slack  # the page that is never mapped follows va + mapped
        start = (end - span) // 16 * 16  # the kernels take 16-byte aligned tensors
        self.max_gap = max(self.max_gap, end - (start + span))
        raw = torch.as_tensor(_DeviceBytes(start, end - start), device=f"cuda:{self.device}")
        out = raw[:span].view(t.dtype).as_strided(t.shape, t.stride())
        out.copy_(t)
        self.placed += 1
        return out

    def release(self) -> None:
        torch.cuda.synchronize()
        for va, reserved, mapped, handle in self.maps:
            self._call("cuMemUnmap", ctypes.c_uint64(va), ctypes.c_size_t(mapped))
            self._call("cuMemRelease", ctypes.c_ulonglong(handle))
            self._call("cuMemAddressFree", ctypes.c_uint64(va), ctypes.c_size_t(reserved))
        self.maps = []


def _guarded_args(obj, guard: guarded_reads, slack: int):
    """``obj`` with every CUDA tensor in it (in tuples, lists, dicts and
    dataclasses) replaced by a placed copy; a dataclass field that is not an
    init argument (a cache of what was built from the old tensors) goes
    back to its default."""
    import copy
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return guard.place(obj, slack) if obj.is_cuda else obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)._make(_guarded_args(v, guard, slack) for v in obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_guarded_args(v, guard, slack) for v in obj)
    if isinstance(obj, dict):
        return {k: _guarded_args(v, guard, slack) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        new = copy.copy(obj)
        for f in dataclasses.fields(obj):
            value = (f.default if not f.init else
                     _guarded_args(getattr(obj, f.name), guard, slack))
            object.__setattr__(new, f.name, value)
        return new
    return obj


def _overread_route(name: str) -> int:
    """One route of ``check_overreads`` (``chip_smoke.py --overread-route
    NAME``): a KITTI frame of 2 iterations with every kernel wrapper's
    inputs placed by ``guarded_reads``; prints one JSON line."""
    import dataclasses
    import importlib

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.serve.session import _view
    env, corr, want = OVERRUN_ROUTES[name]
    for k, v in env.items():
        os.environ[k] = v
    model = seeded_model("cuda")
    pair = random_pairs(1, KITTI, seed=7)[0]
    view = _view(model, dataclasses.replace(model.cfg, corr_implementation=corr))
    infer_pair(view, *pair, iters=2)  # builds and caches outside the guard
    torch.cuda.synchronize()
    guard = guarded_reads()
    calls = {}
    originals = []
    for mod_name, fn_name, kernel in OVERREAD_WRAPPERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        slack = OVERREAD_SLACK.get(kernel, 0)

        def wrapper(*a, _fn=fn, _slack=slack, _kernel=kernel, **kw):
            calls[_kernel] = calls.get(_kernel, 0) + 1
            return _fn(*_guarded_args(a, guard, _slack), **_guarded_args(kw, guard, _slack))
        # Every module that holds the wrapper under a name calls the guarded one.
        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").startswith("raft_stereo_tpu_torch"):
                for attr, val in list(vars(m).items()):
                    if val is fn:
                        originals.append((m, attr, val))
                        setattr(m, attr, wrapper)
    before = dict(kernels.launches)
    try:
        infer_pair(view, *pair, iters=2)
        torch.cuda.synchronize()
    finally:
        for m, attr, val in originals:
            setattr(m, attr, val)
    launched = {k: kernels.launches.get(k, 0) - before.get(k, 0) for k in want}
    line = {"route": name, "placed": guard.placed, "calls": calls, "launches": launched,
            "granularity": guard.gran, "max_gap_bytes": guard.max_gap,
            "slack": {k: OVERREAD_SLACK.get(k, 0) for k in calls}}
    guard.release()
    line["ok"] = all(launched.values()) and guard.placed > 0
    print(json.dumps(line))
    return 0 if line["ok"] else 1


def check_overreads() -> dict:
    """Every kernel of the model paths through one KITTI frame of 2
    iterations on each of OVERRUN_ROUTES, each route in a child process,
    with every kernel input's end (plus its slack) on an unmapped page: a
    read past an input faults and fails its route by name."""
    routes = {}
    for name in OVERRUN_ROUTES:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--overread-route", name], capture_output=True, text=True,
                              timeout=OVERREAD_WAIT_S)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        routes[name] = json.loads(lines[-1]) if lines else {}
        routes[name]["exit"] = proc.returncode
        if proc.returncode != 0:
            routes[name]["ok"] = False
            routes[name]["log_tail"] = (proc.stdout + proc.stderr)[-1500:]
    result = {"phase": "overread", "ok": all(r.get("ok") for r in routes.values()),
              "input": "x".join(map(str, KITTI)), "iters": 2, "routes": routes}
    print(json.dumps(result))
    if not result["ok"]:
        bad = [n for n, r in routes.items() if not r.get("ok")]
        raise SystemExit(f"reads past a kernel's inputs, or a kernel not run, on route(s) "
                         f"{bad}: {result}")
    return result


def phase_kernels() -> tuple:
    from raft_stereo_tpu_torch.corr import alt_cuda, reg_cuda
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops import resident
    from raft_stereo_tpu_torch.ops import encoder as enc
    # The process's first profiles, on a matmul of a few ms, before any
    # timing depends on one (the first ones have come back empty).
    x = torch.randn(2048, 2048, device="cuda")
    _device_ms(lambda: x @ x, reps=2, warmup=1)
    del x
    results = [check_lookup(), check_gru("gru08"), check_gru("gru16"),
               check_gru("gru32"), check_motion(), check_gru1632(),
               check_gru1632(headline=True), check_resident(),
               *encoder_checks(), check_alt("alt", *FEAT),
               check_alt("alt_headline", *ALT_HEADLINE_FEAT), check_lookup(pack8=True),
               check_lookup(headline=True), check_lookup(pack8=True, headline=True),
               check_resident(pack8=True), *lane8_checks(),
               check_gru("gru16", realtime=True), check_resident(realtime=True)]
    sources = {"corr_lookup": ("raft_stereo_tpu_torch/csrc/corr_lookup.cu",
                               "raft_stereo_tpu/corr/pallas_reg.py:730", reg_cuda.lookup),
               "corr_alt": ("raft_stereo_tpu_torch/csrc/corr_alt.cu",
                            "raft_stereo_tpu/corr/pallas_alt.py:75", alt_cuda.lookup),
               "conv_gru": ("raft_stereo_tpu_torch/csrc/conv_gru.cu",
                            "raft_stereo_tpu/ops/pallas_stream.py:145",
                            stream.fused_conv_gru),
               "motion": ("raft_stereo_tpu_torch/csrc/motion.cu",
                          "raft_stereo_tpu/ops/pallas_stream.py:1218", stream.fused_motion),
               "gru1632": ("raft_stereo_tpu_torch/csrc/gru1632.cu",
                           "raft_stereo_tpu/ops/pallas_stream.py:686", stream.fused_gru1632),
               "fused_iter": ("raft_stereo_tpu_torch/csrc/resident.cu",
                              "raft_stereo_tpu/ops/pallas_resident.py:116",
                              resident.fused_iter),
               "enc_stem": ("raft_stereo_tpu_torch/csrc/enc_stem.cu",
                            "raft_stereo_tpu/ops/pallas_encoder.py:202", enc.stem),
               "enc_pass": ("raft_stereo_tpu_torch/csrc/enc_pass.cu",
                            "raft_stereo_tpu/ops/pallas_encoder.py:292", enc.conv_pass),
               "enc_point3": ("raft_stereo_tpu_torch/csrc/enc_point.cu",
                              "raft_stereo_tpu/ops/pallas_encoder.py:448", enc.point3),
               "enc_point2": ("raft_stereo_tpu_torch/csrc/enc_point.cu",
                              "raft_stereo_tpu/ops/pallas_encoder.py:467", enc.point2)}
    q8_replaces = {Q8_PASS: "raft_stereo_tpu/ops/pallas_encoder.py:440",
                   "enc_point2:bn/128/q8": "raft_stereo_tpu/ops/pallas_encoder.py:496",
                   "enc_point2:instance/128/q8": "raft_stereo_tpu/ops/pallas_encoder.py:496"}
    failed = []
    for r in results:
        kernel = r["counter"].split(":")[0]
        r["route"] = "cuda"
        r["source"] = sources[kernel][0]
        r.setdefault("replaces", q8_replaces.get(r.get("variant"), sources[kernel][1]))
        r.setdefault("library_ms", None)
        r.setdefault("library_note", "no single PyTorch call computes this function")
        ok = r.pop("ok", r["max_abs_err"] <= r["tol"])
        print(json.dumps({"phase": "kernel", "ok": ok, **r}))
        if not ok:
            failed.append(r["name"])
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")
    check_overruns(seeded_model("cuda"), random_pairs(1, KITTI, seed=7)[0])
    check_overreads()
    return results, check_chains()


def random_pairs(n: int, shape, seed: int):
    g = _gen(seed)
    return [(torch.rand((1, *shape, 3), generator=g, device="cuda") * 255,
             torch.rand((1, *shape, 3), generator=g, device="cuda") * 255)
            for _ in range(n)]


def seeded_model(device: str, corr: str = "reg_cuda", **arch):
    """The default full-width model, weights from seed 0, flow head tempered;
    ``corr`` only picks the correlation (the weights do not depend on it);
    ``arch``: architecture flags (REALTIME)."""
    from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
    cfg = RAFTStereoConfig(corr_implementation=corr, mixed_precision=True, **arch)
    model = init_raft_stereo(cfg, seed=0, device=device)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
        model.update_block.flow_head.conv2.bias.mul_(0.02)
    return model


def _drive(model, pairs, want: dict, path: str, want_variants: dict,
           iters: int = ITERS) -> tuple:
    """The demo's inference over ``pairs`` at full width, ``iters``
    iterations, counts set to 0 just before and read just after; each frame
    must launch exactly ``want``, the encoder kernels exactly
    ``want_variants`` by variant."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.demo import infer_pair
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    kernels.reset_launches()
    frame_ms, per_frame, per_frame_var, disps = [], [], [], []
    for left, right in pairs:
        before, before_var = dict(kernels.launches), dict(kernels.variants)
        t0 = time.perf_counter()
        disp = infer_pair(model, left, right, iters=iters)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
                  if n != before.get(k, 0)}
        per_frame.append(counts)
        by_variant = {k: n - before_var.get(k, 0) for k, n in kernels.variants.items()
                      if n != before_var.get(k, 0)}
        per_frame_var.append(by_variant)
        shape = tuple(left.shape[1:3])
        if tuple(disp.shape) != shape or not bool(torch.isfinite(disp).all()):
            raise SystemExit(f"{path}: bad disparity: shape {tuple(disp.shape)}, "
                             f"finite {bool(torch.isfinite(disp).all())}")
        if counts != want:
            raise SystemExit(f"{path}: launches per frame {counts}, expected {want}")
        if by_variant != want_variants:
            raise SystemExit(f"{path}: encoder launches per frame {by_variant}, "
                             f"expected {want_variants}")
        disps.append(disp)
    result = {"phase": "main_path", "path": path, "frames": len(pairs), "iters": iters,
              "input": "x".join(map(str, pairs[0][0].shape[1:3])), "frame_ms": frame_ms,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "memory_allocated_at_start": at_start,
              "launches": dict(kernels.launches), "launches_per_frame": per_frame,
              "variants": dict(kernels.variants), "variants_per_frame": per_frame_var,
              "disparity_mean_last": float(disps[-1].mean())}
    print(json.dumps(result))
    return result, disps


def _with_env(values: dict, fn):
    """``fn()`` with the given switches set, and unset again after."""
    try:
        os.environ.update(values)
        return fn()
    finally:
        for knob in values:
            os.environ.pop(knob, None)


# Mean |difference| in px allowed between two encoder routes after ITERS
# iterations: twice the largest reading of a sound tree on an H100 (KITTI
# pair: 0.048 trunk only, 0.059 plain encoders; Middlebury-F pair: 0.111).
ROUTE_MEAN_TOL = {"KITTI": 0.12, "Middlebury-F": 0.22}
ROUTE_MAX_TOL = 1.0  # px, every pixel: the D1 threshold (readings 0.275, 0.379, 0.816)
# The correlation routes against reg_cuda's bf16 frame, set the same way.
# alt_cuda keeps the volume in fp32 where reg_cuda rounds it to bf16; pack8
# moves each tap by up to half a quantization step (amax / 254).
# Readings on an H100, mean and max px: alt_cuda 0.042 and 0.251 (KITTI),
# 0.042 and 0.337 (Middlebury-F); pack8 0.066 and 0.446.
CORR_BANDS = {("alt_cuda", "KITTI"): (0.09, ROUTE_MAX_TOL),
              ("alt_cuda", "Middlebury-F"): (0.09, ROUTE_MAX_TOL),
              ("pack8", "KITTI"): (0.14, ROUTE_MAX_TOL)}


def _disparity_band(name: str, size: str, got, ref, band=None) -> dict:
    """Two encoder routes' disparities on one pair after ITERS iterations.
    The routes round at other places (the folded BatchNorm, the statistics,
    the conv outputs), so they are not bitwise equal, and the seeded model's
    loop does not contract: it keeps moving ~0.7 px an iteration, so a
    rounding-sized difference in the context and features grows with the
    iterations, and phase_cross_check's band for 8 iterations (mean 0.05,
    maximum 0.25 px) does not hold after 32. The band is set from what a
    sound tree reads: the mean within ROUTE_MEAN_TOL, twice the reading at
    this frame size, and every pixel within ROUTE_MAX_TOL; ``band`` (mean,
    max px) gives another pair of routes theirs (CORR_BANDS)."""
    d = (got.float() - ref.float()).abs()
    mean_tol, max_tol = band or (ROUTE_MEAN_TOL[size], ROUTE_MAX_TOL)
    ok = float(d.mean()) <= mean_tol and float(d.max()) <= max_tol
    result = {"phase": "route_band", "name": f"{name}, {size}", "ok": ok,
              "mean_abs_diff": float(d.mean()), "mean_tol": mean_tol,
              "max_abs_diff": float(d.max()), "max_tol": max_tol,
              "disparity_abs_mean": float(ref.float().abs().mean())}
    print(json.dumps(result))
    if not ok:
        raise SystemExit(f"{name}, {size}: disparities disagree beyond the band")
    return result


def _prepare_twice(model, pair) -> None:
    """The encoders twice on one pair: equal bits. The instance-norm
    statistics are summed in a fixed order, without atomics."""
    from raft_stereo_tpu_torch import raft_stereo_prepare
    from raft_stereo_tpu_torch.ops.padder import InputPadder
    padder = InputPadder(pair[0].shape, divis_by=32)
    left, right = padder.pad(*pair)
    first, second = (raft_stereo_prepare(model, left, right) for _ in range(2))
    torch.cuda.synchronize()
    same = (torch.equal(first["fmap1"], second["fmap1"])
            and torch.equal(first["fmap2"], second["fmap2"])
            and all(torch.equal(a, b) for a, b in zip(first["net"], second["net"]))
            and all(torch.equal(a, b) for la, lb in zip(first["inp"], second["inp"])
                    for a, b in zip(la, lb)))
    print(json.dumps({"phase": "prepare_twice", "input": "x".join(map(str, left.shape[1:3])),
                      "bitwise_equal": same}))
    if not same:
        raise SystemExit("two prepares of one pair differ")


def phase_main_path() -> dict:
    """The demo's inference at full width: the default path, the serial
    loop, the trunk-only and the plain encoders on the first pair again,
    and one headline-size frame with the fused and with the plain encoders.
    Every kernel of a path must carry it; the two loops must agree bit for
    bit and the encoder routes within a band."""
    model = seeded_model("cuda")
    pairs = random_pairs(N_FRAMES, KITTI, seed=7)
    loop = LOOP
    serial = {"corr_lookup": ITERS, "motion": ITERS, "conv_gru:gru08": ITERS,
              "conv_gru:gru16": ITERS, "conv_gru:gru32": ITERS}
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    run_default, disp_default = _drive(model, pairs, {**loop, **ENC_KITTI}, "default", VAR_CNET)
    run_serial, disp_serial = _with_env(
        dict.fromkeys(SWITCHES, "0"),
        lambda: _drive(model, pairs[:1], {**serial, **ENC_KITTI},
                       "serial (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0)", VAR_CNET))
    _same_bits("default_vs_serial", disp_default[0], disp_serial[0])
    _, disp_trunk = _with_env(
        {"RAFT_STREAM_TAIL": "0"},
        lambda: _drive(model, pairs[:1], {**loop, **ENC_TRUNK_ONLY},
                       "trunk only (RAFT_STREAM_TAIL=0)", VAR_TRUNK_ONLY))
    _disparity_band("trunk only vs default", "KITTI", disp_trunk[0], disp_default[0])
    run_plain, disp_plain = _with_env(
        {"RAFT_FUSED_ENCODERS": "0"},
        lambda: _drive(model, pairs[:1], loop, "plain encoders (RAFT_FUSED_ENCODERS=0)", {}))
    _disparity_band("plain encoders vs default", "KITTI", disp_plain[0], disp_default[0])
    big = random_pairs(1, MIDDLEBURY_F, seed=12)
    headline, disp_big = _drive(model, big, MIDDLEBURY_LAUNCHES, "default, Middlebury-F",
                                VAR_MIDDLEBURY)
    headline_plain, disp_big_plain = _with_env(
        {"RAFT_FUSED_ENCODERS": "0"},
        lambda: _drive(model, big, loop,
                       "plain encoders (RAFT_FUSED_ENCODERS=0), Middlebury-F", {}))
    _disparity_band("plain encoders vs default", "Middlebury-F", disp_big_plain[0], disp_big[0])
    del disp_big_plain
    runs = phase_corr_paths(model, pairs[0], big[0], disp_default[0], disp_big[0])
    runs.update(phase_lane_paths(model, pairs[0], big[0], disp_default[0], disp_big[0],
                                 runs["alt_headline"]["peaks"]["reg_cuda"]))
    runs.update(phase_slow_fast(pairs[0]))
    del disp_big
    _prepare_twice(model, pairs[0])
    _prepare_twice(model, big[0])
    return {"default": run_default, "serial": run_serial, "headline": headline,
            "plain_encoders": run_plain, "headline_plain_encoders": headline_plain, **runs}


def _same_bits(name: str, a, b) -> None:
    """A default loop's disparity against its serial loop's: equal bits."""
    same = torch.equal(a, b)
    print(json.dumps({"phase": name, "bitwise_equal": same, "max_abs_diff": _max_err(a, b)}))
    if not same:
        raise SystemExit(f"{name}: the default and serial loops give different disparities")


def phase_slow_fast(pair) -> dict:
    """The slow-fast loop (``slow_fast_gru``) through the demo's inference:
    - the realtime model (REALTIME) on the KITTI pair at RT_ITERS: a frame
      launches 2 gru16 steps (one x input, 24x78) and 1 resident iteration
      (48x156) an iteration, no gru16+32 and no lookup, and the encoder
      kernels of the two finest context heads only (VAR_RT); again with
      RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0, equal bits;
    - the default model with ``slow_fast_gru`` on the same pair at ITERS: 1
      gru32 step, 2 gru16+32 and 1 resident launch an iteration and the
      context net's encoder kernels; again on the serial loop, equal bits."""
    rt_model = seeded_model("cuda", **REALTIME)
    rt = RT_LAUNCHES
    rt_serial = {"corr_lookup": RT_ITERS, "motion": RT_ITERS, "conv_gru:gru08": RT_ITERS,
                 "conv_gru:gru16": 2 * RT_ITERS, **ENC_RT}
    run_rt, disp_rt = _drive(rt_model, [pair], rt, "realtime", VAR_RT, RT_ITERS)
    run_rt_serial, disp_rt_serial = _with_env(
        dict.fromkeys(SWITCHES, "0"),
        lambda: _drive(rt_model, [pair], rt_serial,
                       "realtime serial (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0)", VAR_RT,
                       RT_ITERS))
    _same_bits("realtime_default_vs_serial", disp_rt[0], disp_rt_serial[0])
    del rt_model
    sf_model = seeded_model("cuda", slow_fast_gru=True)
    sf = {"conv_gru:gru32": ITERS, "gru1632": 2 * ITERS, "fused_iter": ITERS, **ENC_KITTI}
    sf_serial = {"corr_lookup": ITERS, "motion": ITERS, "conv_gru:gru08": ITERS,
                 "conv_gru:gru16": 2 * ITERS, "conv_gru:gru32": 3 * ITERS, **ENC_KITTI}
    run_sf, disp_sf = _drive(sf_model, [pair], sf, "slow-fast", VAR_CNET)
    run_sf_serial, disp_sf_serial = _with_env(
        dict.fromkeys(SWITCHES, "0"),
        lambda: _drive(sf_model, [pair], sf_serial,
                       "slow-fast serial (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0)", VAR_CNET))
    _same_bits("slow_fast_default_vs_serial", disp_sf[0], disp_sf_serial[0])
    del sf_model
    torch.cuda.empty_cache()
    return {"realtime": run_rt, "realtime_serial": run_rt_serial, "slow_fast": run_sf,
            "slow_fast_serial": run_sf_serial}


def _peak_split(model, pair, path: str) -> dict:
    """Peak device memory of the prepare step and of the loop (a segment
    of ITERS iterations and the epilogue) apart, each in bytes over what was
    allocated just before it: which of the two sets the frame's peak."""
    from raft_stereo_tpu_torch import raft_stereo_prepare, raft_stereo_segment
    from raft_stereo_tpu_torch.ops.padder import InputPadder
    left, right = InputPadder(pair[0].shape, divis_by=32).pad(*pair)
    out = {"phase": "peak_split", "path": path}
    torch.cuda.synchronize()
    for step in ("prepare", "loop"):
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        if step == "prepare":
            state = raft_stereo_prepare(model, left, right)
        else:
            raft_stereo_segment(model, state, iters=ITERS)
        torch.cuda.synchronize()
        out[f"{step}_start"] = start
        out[f"{step}_peak_over_start"] = torch.cuda.max_memory_allocated() - start
    print(json.dumps(out))
    return out


def phase_corr_paths(model, pair, big, disp_reg, disp_reg_big) -> dict:
    """The other correlation routes through the demo's inference, each
    against reg_cuda's bf16 frame of the same pair (``disp_reg``,
    ``disp_reg_big``; ``model`` is reg_cuda's):
    - ``alt_cuda`` on the KITTI pair: 32 alt, 32 gru16+32, 32 motion and 32
      gru08+head launches, no lookup and no resident iteration (there is no
      pyramid to gather from), and a disparity within CORR_BANDS;
    - ``alt_cuda`` on the Middlebury-F pair, its ms and peak beside
      reg_cuda's, and for both the prepare step's and the loop's peaks
      apart;
    - RAFT_CORR_PACK8=1 on the KITTI pair: 32 resident launches on the int8
      levels, and again with RAFT_FUSE_ITER=0, 32 int8 lookups and equal
      bits; a disparity within CORR_BANDS of the bf16 frame's."""
    loop = {"gru1632": ITERS}
    alt = {**loop, "corr_alt": ITERS, "motion": ITERS, "conv_gru:gru08": ITERS}
    alt_model = seeded_model("cuda", "alt_cuda")
    run_alt, disp_alt = _drive(alt_model, [pair], {**alt, **ENC_KITTI}, "alt_cuda", VAR_CNET)
    _disparity_band("alt_cuda vs reg_cuda", "KITTI", disp_alt[0], disp_reg,
                    CORR_BANDS["alt_cuda", "KITTI"])
    run_alt_big, disp_alt_big = _drive(alt_model, [big], {**alt, **ENC_MIDDLEBURY},
                                       "alt_cuda, Middlebury-F", VAR_MIDDLEBURY)
    _disparity_band("alt_cuda vs reg_cuda", "Middlebury-F", disp_alt_big[0], disp_reg_big,
                    CORR_BANDS["alt_cuda", "Middlebury-F"])
    del disp_alt_big
    torch.cuda.empty_cache()
    peaks = {"reg_cuda": _peak_split(model, big, "reg_cuda, Middlebury-F"),
             "alt_cuda": _peak_split(alt_model, big, "alt_cuda, Middlebury-F")}
    del alt_model
    torch.cuda.empty_cache()
    run_pack8, disp_pack8 = _with_env(
        {"RAFT_CORR_PACK8": "1"},
        lambda: _drive(model, [pair], {**loop, "fused_iter": ITERS, **ENC_KITTI},
                       "pack8 (RAFT_CORR_PACK8=1)",
                       {**VAR_CNET, "fused_iter:pack8": ITERS}))
    run_pack8_serial, disp_pack8_serial = _with_env(
        {"RAFT_CORR_PACK8": "1", "RAFT_FUSE_ITER": "0"},
        lambda: _drive(model, [pair], {**loop, "corr_lookup": ITERS, "motion": ITERS,
                                       "conv_gru:gru08": ITERS, **ENC_KITTI},
                       "pack8 serial (RAFT_CORR_PACK8=1 RAFT_FUSE_ITER=0)",
                       {**VAR_CNET, "corr_lookup:pack8": ITERS}))
    _same_bits("pack8_default_vs_serial", disp_pack8[0], disp_pack8_serial[0])
    _disparity_band("pack8 vs bf16", "KITTI", disp_pack8[0], disp_reg,
                    CORR_BANDS["pack8", "KITTI"])
    return {"alt": run_alt, "alt_headline": {**run_alt_big, "peaks": peaks},
            "pack8": run_pack8, "pack8_serial": run_pack8_serial}


# The lane8 frames against the bf16 frame of the same pair after ITERS
# iterations, set as CORR_BANDS are: the mean to about twice a sound tree's
# reading, every pixel within ROUTE_MAX_TOL. Readings on an H100, mean and
# max px: 0.063 and 0.380 (KITTI), 0.065 and 0.568 (Middlebury-F).
LANE_BANDS = {"KITTI": (0.13, ROUTE_MAX_TOL), "Middlebury-F": (0.13, ROUTE_MAX_TOL)}


def phase_lane_paths(model, pair, big, disp_reg, disp_reg_big, peak_reg_big) -> dict:
    """RAFT_LANE_PACK8=1 through the demo's inference, against reg_cuda's
    bf16 frames of the same pairs (``disp_reg``, ``disp_reg_big``):
    - the KITTI pair, default loop: 32 gru1632 and 32 resident launches,
      every one on int8 czrq (``gru1632:lane8``, ``fused_iter:lane8``), the
      context net's encoder launches and one quantize-on-exit pass per zqr
      level, and no other variant;
    - the same with RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0: 32 lane8 GRU
      launches at each level, and a disparity equal bit for bit to the
      default lane8 loop's;
    - the Middlebury-F pair: its frame ms and peak, and the prepare step's
      and the loop's peaks apart beside reg_cuda's bf16 ones
      (``peak_reg_big``);
    - each frame within LANE_BANDS of the bf16 frame."""
    lane = {"RAFT_LANE_PACK8": "1"}
    q8 = {Q8_PASS: model.cfg.n_gru_layers}
    enc_k = {**ENC_KITTI, "enc_pass": ENC_KITTI["enc_pass"] + q8[Q8_PASS]}
    enc_m = {**ENC_MIDDLEBURY, "enc_pass": ENC_MIDDLEBURY["enc_pass"] + q8[Q8_PASS]}
    loop = {"fused_iter": ITERS, "gru1632": ITERS}
    loop_var = {"fused_iter:lane8": ITERS, "gru1632:lane8": ITERS}
    levels = ("gru08", "gru16", "gru32")
    serial = {"corr_lookup": ITERS, "motion": ITERS, **{f"conv_gru:{lv}": ITERS for lv in levels}}
    serial_var = {f"conv_gru:{lv}:lane8": ITERS for lv in levels}
    run, disp = _with_env(lane, lambda: _drive(
        model, [pair], {**loop, **enc_k}, "lane8 (RAFT_LANE_PACK8=1)",
        {**VAR_CNET, **q8, **loop_var}))
    run_serial, disp_serial = _with_env({**lane, **dict.fromkeys(SWITCHES, "0")}, lambda: _drive(
        model, [pair], {**serial, **enc_k},
        "lane8 serial (RAFT_LANE_PACK8=1 RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0)",
        {**VAR_CNET, **q8, **serial_var}))
    _same_bits("lane8_default_vs_serial", disp[0], disp_serial[0])
    _disparity_band("lane8 vs bf16", "KITTI", disp[0], disp_reg, LANE_BANDS["KITTI"])
    run_big, disp_big = _with_env(lane, lambda: _drive(
        model, [big], {**loop, **enc_m}, "lane8, Middlebury-F",
        {**VAR_MIDDLEBURY, **q8, **loop_var}))
    _disparity_band("lane8 vs bf16", "Middlebury-F", disp_big[0], disp_reg_big,
                    LANE_BANDS["Middlebury-F"])
    del disp_big
    torch.cuda.empty_cache()
    peak = _with_env(lane, lambda: _peak_split(model, big, "lane8, Middlebury-F"))
    return {"lane8": run, "lane8_serial": run_serial,
            "lane8_headline": {**run_big, "peaks": {"lane8": peak, "reg_cuda": peak_reg_big}}}


# The serving session (raft_stereo_tpu_torch/serve/session.py) on the card:
# its programs are CUDA graphs. The default path's launches a KITTI frame,
# which the KITTI session's full program must capture.
SESSION_KITTI_LAUNCHES = {**LOOP, **ENC_KITTI}
# The kernels a graph replay shows under torch.profiler, by counter: each
# wrapper's own kernel (OWN_KERNELS' first name; stats_reduce_kernel runs
# only under instance norm, which the KITTI context net does not take). A
# graph replays the fixed set of kernels it captured, so a replay that
# shows fewer lost events to the profiler, not launches: it is profiled
# again, up to PROFILE_TRIES times, and every try's counts are printed.
REPLAY_KERNELS = {k: OWN_KERNELS[k][0] for k in ("conv_gru", "fused_iter", "gru1632",
                                                 "enc_stem", "enc_pass", "enc_point3",
                                                 "enc_point2")}
SESSION_ROUNDS = {"KITTI": 4, "realtime": 4, "Middlebury-F": 1}
PROFILE_TRIES = 3


# Loop-engine kernels (loop_conv_kernel) one conv_gru call launches: the
# gate and the update stage, and at gru08 the flow head's two convs besides
# (csrc/conv_gru.cu:launch_chain).
CONV_GRU_STAGES = {"gru08": 4, "gru16": 2, "gru32": 2}


def _replay_want(captured: dict) -> dict:
    """The kernels a replay of a program must show, by REPLAY_KERNELS'
    counter, from the launches its capture counted."""
    want = dict.fromkeys(REPLAY_KERNELS, 0)
    for counter, n in captured.items():
        kernel, _, level = counter.partition(":")
        if kernel in want:
            want[kernel] += n * (CONV_GRU_STAGES[level] if kernel == "conv_gru" else 1)
    return want


def _np_pairs(n: int, shape, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 255, (1, *shape, 3)).astype(np.float32) for _ in range(2))
            for _ in range(n)]


def _eager_flow(model, lp, rp, iters: int) -> torch.Tensor:
    """The port's eager forward on the card on a padded host pair: the
    padded flow (1, H, W, 1), on the card. Its launches are not counted:
    it is the session's reference."""
    from raft_stereo_tpu_torch import kernels, raft_stereo_forward
    launches, variants = kernels.launches.copy(), kernels.variants.copy()
    left, right = (torch.from_numpy(x).cuda() for x in (lp, rp))
    flow = raft_stereo_forward(model, left, right, iters=iters)[1]
    kernels.launches.clear()
    kernels.launches.update(launches)
    kernels.variants.clear()
    kernels.variants.update(variants)
    return flow


def _served_bitwise(sess, model, pairs, iters: int, name: str) -> list:
    """Each pair through ``sess.infer`` and through the eager forward on
    the card: the disparities equal bit for bit (the first pair's whole
    padded flow too). Returns the results."""
    results = []
    for i, (left, right) in enumerate(pairs):
        res = sess.infer(left, right)
        padder = sess.padder_for(left.shape)
        lp, rp = padder.pad_np(left, right)
        eager = _eager_flow(model, lp, rp, iters)
        ref = -padder.unpad(eager)[0, ..., 0].cpu()
        same = res.quality == "full" and torch.equal(torch.from_numpy(res.disparity), ref)
        if i == 0:
            graph = torch.from_numpy(sess._run_full(padder, left, right))
            same = same and torch.equal(graph, eager.cpu())
        if not same or not bool(torch.isfinite(ref).all()):
            raise SystemExit(f"session {name}: request {i} differs from the eager forward "
                             f"(quality {res.quality}, max |d| "
                             f"{_max_err(torch.from_numpy(res.disparity), ref)})")
        results.append(res)
    return results


def _frame_times(sess, model, pair, iters: int, rounds: int) -> dict:
    """Frames of the full program from a host pair to a host flow, eager and
    graph in turns (eager, graph, graph, eager), each synchronized; the
    graph frame's copy in, replay and copy out apart; each kind back to back
    on the card (no copies, one synchronize for 4 frames); one replay's
    device busy ms and the kernels it shows under torch.profiler."""
    from raft_stereo_tpu_torch.obs.profiler import device_seconds
    padder = sess.padder_for(pair[0].shape)
    lp, rp = padder.pad_np(*pair)
    ph, pw = padder.padded_shape
    prog = sess.get_program("full", ph, pw, iters)
    left, right = (torch.from_numpy(x).cuda() for x in (lp, rp))

    def eager():
        _eager_flow(model, lp, rp, iters).cpu()

    def graph():
        prog.copy_in((lp, rp))
        prog.replay()
        prog.copy_out()

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    eager_ms, graph_ms, parts = [], [], {"copy_in_ms": [], "replay_ms": [], "copy_out_ms": []}
    for _ in range(rounds):
        eager_ms.append(timed(eager))
        graph_ms += [timed(graph), timed(graph)]
        eager_ms.append(timed(eager))
        parts["copy_in_ms"].append(timed(lambda: prog.copy_in((lp, rp))))
        parts["replay_ms"].append(timed(prog.replay))
        parts["copy_out_ms"].append(timed(prog.copy_out))
    n = 4

    def back_to_back(fn) -> float:
        return timed(lambda: [fn() for _ in range(n)]) / n
    from raft_stereo_tpu_torch import raft_stereo_forward
    b2b_graph = back_to_back(prog.replay)
    b2b_eager = back_to_back(lambda: raft_stereo_forward(model, left, right, iters=iters))
    # A profile has been seen to lose the first events of its window (a
    # stem and a pass of a Middlebury-F replay): see REPLAY_KERNELS.
    tries, prof, n_events = _replay_profile(prog)
    kernels_seen = tries[-1]
    busy = device_seconds(prof)
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "eager_ms_median": statistics.median(eager_ms),
            "graph_ms_median": statistics.median(graph_ms),
            **{k: statistics.median(v) for k, v in parts.items()},
            "eager_back_to_back_ms": b2b_eager, "graph_back_to_back_ms": b2b_graph,
            "replay_device_busy_ms": None if busy is None else busy * 1e3,
            "replay_kernels": kernels_seen, "replay_device_events": n_events,
            "replay_tries": tries}


def _replay_matches(name: str, captured: dict, times: dict) -> None:
    """A profiled replay shows each wrapper's own kernel as many times as
    the capture counted its launches."""
    want = _replay_want(captured)
    if times["replay_kernels"] != want:
        raise SystemExit(f"session {name}: a replay shows {times['replay_kernels']}, "
                         f"the capture counted {want}")


def _program_rows(sess) -> list:
    """Each cached program's capture seconds, pool bytes and peak device
    bytes (its ledger row: warm-up and capture)."""
    rows = {r.id: r for r in sess.ledger.rows()}
    out = []
    for p in sess.programs():
        row = rows.get(p["id"])
        out.append({"program": p["id"], "capture_s": p["capture_s"],
                    "graph_pool_bytes": p["pool_bytes"],
                    "peak_hbm_bytes": None if row is None else row.peak_hbm_bytes,
                    "launches": p["launches"]})
    return out


def _captured_is(name: str, captured: dict, want: dict) -> None:
    """The full program captured a frame's launches of the default path,
    as phase 4 counted them."""
    if captured != want:
        raise SystemExit(f"session {name}: the full program captured {captured}, "
                         f"expected {want}")


def _session_line(name: str, sess, smi: str, **more) -> dict:
    st = sess.status()
    line = {"phase": "session", "name": name, "card": smi,
            "trips": st["breaker"]["trip_count"],
            "kernels_only": st["breaker"]["kernels_only"], "canary": st["canary"],
            "counts": st["counts"], "programs": _program_rows(sess), **more}
    print(json.dumps(line))
    if line["trips"] or not line["kernels_only"]:
        raise SystemExit(f"session {name}: breaker trips on a clean path, or a breaker "
                         f"that may leave the kernels: {st['breaker']}")
    return line


def phase_session(smi: str) -> dict:
    """The serving session on the card, its programs CUDA graphs: a KITTI
    session (4 requests bit for bit the eager forward, the canary, a
    deadline that fits all segments bit for bit, one that fits about half),
    the realtime model, one Middlebury-F request; the full program's
    captured launches and a profiled replay's kernels; frame times in turns,
    eager against graph."""
    import gc

    import numpy as np

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    torch.cuda.empty_cache()
    out = {}
    # 1-2. KITTI: warm-up (full, prepare/segment and the half bucket's) and
    # the canary at construction; launches counted from 0 around it all.
    model = seeded_model("cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    sess = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=4, warmup_shapes=(KITTI,), warmup_segmented=True,
        canary=True))
    setup_s = time.perf_counter() - t0
    pairs = _np_pairs(4, KITTI, seed=21)
    results = _served_bitwise(sess, model, pairs, ITERS, "KITTI")
    launches = dict(kernels.launches)
    ph, pw = results[0].padded_shape
    captured = sess.program_launches("full", ph, pw, ITERS)
    _captured_is("KITTI", captured, SESSION_KITTI_LAUNCHES)
    if sess.status()["canary"]["passed"] is not True:
        raise SystemExit(f"session KITTI: canary {sess.status()['canary']}")
    fits = sess.infer(*pairs[0], budget_s=60.0)
    same = fits.disparity.tobytes() == results[0].disparity.tobytes()
    if fits.quality != "full" or not same:
        raise SystemExit(f"session KITTI: a deadline that fits all segments gave "
                         f"{fits.quality}, bitwise {same}")
    full_s = sess.estimate(sess.cache_key("full", ph, pw, ITERS))
    half = sess.infer(*pairs[1], budget_s=full_s / 2, allow_half_res=False)
    k = int(half.quality.split(":")[1]) if half.quality.startswith("reduced_iters:") else -1
    if not (0 < k < ITERS) or not bool(np.isfinite(half.disparity).all()):
        raise SystemExit(f"session KITTI: a half budget gave {half.quality}")
    times = _frame_times(sess, model, pairs[0], ITERS, SESSION_ROUNDS["KITTI"])
    _replay_matches("KITTI", captured, times)
    out["KITTI"] = _session_line(
        "KITTI", sess, smi, setup_s=setup_s, launches=launches, full_launches=captured,
        deadline_fits={"quality": fits.quality, "bitwise": True},
        deadline_half={"budget_s": full_s / 2, "quality": half.quality,
                       "deadline_missed": half.deadline_missed},
        full_estimate_s=full_s, **times)
    del sess, results
    # 3. The realtime model.
    rt = seeded_model("cuda", **REALTIME)
    kernels.reset_launches()
    sess = InferenceSession(rt, rt.cfg, SessionConfig(valid_iters=RT_ITERS, segments=1))
    _served_bitwise(sess, rt, pairs, RT_ITERS, "realtime")
    launches = dict(kernels.launches)
    rt_captured = sess.program_launches("full", ph, pw, RT_ITERS)
    _captured_is("realtime", rt_captured, RT_LAUNCHES)
    rt_times = _frame_times(sess, rt, pairs[0], RT_ITERS, SESSION_ROUNDS["realtime"])
    _replay_matches("realtime", rt_captured, rt_times)
    out["realtime"] = _session_line("realtime", sess, smi, launches=launches,
                                    full_launches=rt_captured, **rt_times)
    del sess, rt
    gc.collect()
    torch.cuda.empty_cache()
    # 4. One Middlebury-F request.
    kernels.reset_launches()
    sess = InferenceSession(model, model.cfg, SessionConfig(valid_iters=ITERS, segments=4))
    big = _np_pairs(1, MIDDLEBURY_F, seed=22)
    _served_bitwise(sess, model, big, ITERS, "Middlebury-F")
    launches = dict(kernels.launches)
    big_captured = sess.program_launches("full", *MIDDLEBURY_F, ITERS)
    _captured_is("Middlebury-F", big_captured, MIDDLEBURY_LAUNCHES)
    big_times = _frame_times(sess, model, big[0], ITERS, SESSION_ROUNDS["Middlebury-F"])
    _replay_matches("Middlebury-F", big_captured, big_times)
    out["Middlebury-F"] = _session_line("Middlebury-F", sess, smi, launches=launches,
                                        full_launches=big_captured, **big_times)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 8: the server. KITTI pairs (seeded uint8, 375x1242: the padder pads
# them) through StereoService at max_batch 1 (the reference responses) and
# at max_batch 4 (buckets 1, 2, 4) on batched CUDA-graph programs, then the
# CLI over HTTP.
SERVER_PAIRS = 8
SERVER_SEGMENTS = 4
SERVER_ITERS_PER_TICK = ITERS // SERVER_SEGMENTS
SERVER_BUCKETS = (1, 2, 4)
SERVER_CLIENTS = 8
SERVER_RATE_REQUESTS = 32
SERVER_ROUNDS = (1, 4, 4, 1)
# A row's disparity at B=2 or B=4 against the same pair at B=1: "bitwise", or
# "band" (the canary band, serve/guard.py) where an op picks its summation
# order by batch. Read on the H100: the prepare (row by row) and the advance
# are bit for bit across widths at 384x1248 and 128x256, and so is every
# KITTI row this phase serves; at 128x256 the epilogue's convex upsample (an
# fp32 einsum, a cuBLAS batched matmul) sums in another order at B=4, up to
# 4.8e-7 px (ROADMAP Queue C). Within one batch width a row is always bit
# for bit the same whatever its batchmates or pad rows.
CROSS_WIDTH_PIN = "band"
CLI_WAIT_S = 300
# The CLI's device and extra flags (a rehearsal on the CPU sets them).
CLI_DEVICE = "cuda"
CLI_ARCH: tuple = ()


def _server_pairs(n: int, seed: int) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, (1, *KITTI, 3), dtype=np.uint8) for _ in range(2))
            for _ in range(n)]


def _request(i, pair) -> dict:
    import numpy as np
    return {"id": i, "left": pair[0].astype(np.float32), "right": pair[1].astype(np.float32)}


def _served(svc, pairs, clients: int) -> list:
    """Every pair through ``svc.submit`` from ``clients`` threads at once;
    the responses in pair order, each required ok and full."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=clients) as ex:
        resps = list(ex.map(lambda ip: svc.submit(_request(*ip)).result(timeout=600),
                            enumerate(pairs)))
    for i, r in enumerate(resps):
        if r["status"] != "ok" or r["quality"] != "full":
            raise SystemExit(f"server: request {i} gave {r.get('status')} "
                             f"{r.get('code') or r.get('quality')}: {r.get('message')}")
    return resps


def _rate(svc, pairs) -> dict:
    """SERVER_RATE_REQUESTS requests from SERVER_CLIENTS closed-loop client
    threads: frames/s over the wall seconds, and each request's ms from
    submit to its response."""
    import threading
    lat, lock = [], threading.Lock()
    per_client = SERVER_RATE_REQUESTS // SERVER_CLIENTS

    def client(k: int) -> None:
        for j in range(per_client):
            i = k * per_client + j
            t0 = time.perf_counter()
            r = svc.submit(_request(i, pairs[i % len(pairs)])).result(timeout=600)
            ms = (time.perf_counter() - t0) * 1e3
            if r["status"] != "ok":
                raise SystemExit(f"server rate: request {i} gave {r.get('code')}")
            with lock:
                lat.append(ms)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVER_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if len(lat) != SERVER_RATE_REQUESTS:
        raise SystemExit(f"server rate: {len(lat)} of {SERVER_RATE_REQUESTS} requests served")
    lat.sort()
    return {"frames_per_s": SERVER_RATE_REQUESTS / wall, "wall_s": wall,
            "p50_ms": statistics.median(lat),
            "p95_ms": lat[math.ceil(0.95 * len(lat)) - 1]}


def _replay_profile(prog) -> tuple:
    """A profiled replay of ``prog``: the kernels it shows by
    REPLAY_KERNELS' counter, tried up to PROFILE_TRIES times until they are
    the capture's (a shorter list lost events), every try kept; and the
    last try's profile."""
    from torch.profiler import ProfilerActivity, profile
    tries = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prog.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(own in name for name in names) for k, own in REPLAY_KERNELS.items()}
        tries.append(seen)
        if seen == _replay_want(prog.launches):
            break
    return tries, prof, len(names)


def _replay_breakdown(prog, reps: int = 5) -> dict:
    """Device ms of one replay of ``prog`` (``reps`` replays after one,
    torch.profiler): the sum of its device events, and that sum by
    REPLAY_KERNELS' kernel (the rest "other": cuBLAS, cuDNN, torch)."""
    from torch.profiler import ProfilerActivity, profile
    prog.replay()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                prog.replay()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    total = sum(us for _, us in events) / 1e3 / reps
    by = {k: sum(us for name, us in events if own in name) / 1e3 / reps
          for k, own in REPLAY_KERNELS.items()}
    by = {k: v for k, v in by.items() if v}
    by["other"] = total - sum(by.values())
    return {"device_ms": total, "by_kernel_ms": by}


# Device events of a profiled rate round by kind: the first group whose
# name part a kernel's name holds.
EVENT_GROUPS = (("memcpy_htod", ("Memcpy HtoD",)), ("memcpy_dtoh", ("Memcpy DtoH",)),
                ("memcpy_dtod", ("Memcpy DtoD",)), ("memset", ("Memset",)),
                *((k, (own,)) for k, own in REPLAY_KERNELS.items()),
                ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
                ("conv", ("conv", "cudnn", "implicit", "winograd")))


def _busy_share(svc, pairs) -> dict:
    """One more rate round under torch.profiler: the card's busy seconds
    (the union of its device intervals) over the round's wall seconds, and
    the device ms a frame by EVENT_GROUPS (the rest "other": torch's
    elementwise, reduction, index and cat kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.obs.profiler import device_seconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rate = _rate(svc, pairs)
        torch.cuda.synchronize()
    busy = device_seconds(prof)
    by = dict.fromkeys([g for g, _ in EVENT_GROUPS] + ["other"], 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g, parts in EVENT_GROUPS if any(p in e.name for p in parts)),
                     "other")
        by[group] += (e.time_range.end - e.time_range.start) / 1e3 / SERVER_RATE_REQUESTS
    return {"wall_s": rate["wall_s"], "busy_s": busy,
            "idle_share": None if busy is None else 1.0 - busy / rate["wall_s"],
            "device_ms_per_frame": {k: v for k, v in by.items() if v}}


def _carry_copy(sess, ph: int, pw: int, b: int) -> dict:
    """The advance program at batch ``b``: the carry's bytes, and the ms of
    its copy into the graph's static buffers and of the clone out (each
    synchronized, median of 5)."""
    import numpy as np

    from raft_stereo_tpu_torch.serve.session import _nbytes
    z = np.zeros((b, ph, pw, 3), np.float32)
    (state,) = sess.invoke(sess.get_program("prepare", ph, pw, 0, b=b), z, z)
    prog = sess.get_program("advance", ph, pw, SERVER_ITERS_PER_TICK, b=b)
    with prog.lock, sess.device_ops():
        def timed(fn) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        copy_in = [timed(lambda: prog.copy_in((state,))) for _ in range(5)]
        copy_out = [timed(prog.copy_out) for _ in range(5)]
    return {"b": b, "carry_bytes": _nbytes(state),
            "copy_in_ms": statistics.median(copy_in), "copy_out_ms": statistics.median(copy_out)}


def _by_hand(sess, pairs, ph: int, pw: int) -> list:
    """Four pairs through the session's b=4 programs by hand (prepare, the
    segments' advances, epilogue): the padded flows of the four rows."""
    import numpy as np
    padder = sess.padder_for(pairs[0][0].shape)
    lp, rp = (np.concatenate(x) for x in zip(*(padder.pad_np(
        p[0].astype(np.float32), p[1].astype(np.float32)) for p in pairs)))
    (state,) = sess.invoke(sess.get_program("prepare", ph, pw, 0, b=4), lp, rp)
    adv = sess.get_program("advance", ph, pw, SERVER_ITERS_PER_TICK, b=4)
    for _ in range(SERVER_SEGMENTS):
        state, _, _ = sess.invoke(adv, state)
    flow_up, _ = sess.invoke(sess.get_program("epilogue", ph, pw, 0, b=4), state)
    return [-padder.unpad_np(flow_up[i:i + 1])[0, ..., 0] for i in range(4)]


def _program_launches_checked(sess, ph: int, pw: int) -> dict:
    """Each batched program's captured launches, held to a frame's: prepare
    at b has b stems, 14b passes, b point3, 4b point2 (ENC_KITTI a row);
    advance at b, one segment, a fused_iter and a gru1632 an iteration and
    none of the serial kernels; epilogue none."""
    out = {}
    for b in SERVER_BUCKETS:
        got = {kind: sess.program_launches(kind, ph, pw, it, b=b)
               for kind, it in (("prepare", 0), ("advance", SERVER_ITERS_PER_TICK),
                                ("epilogue", 0))}
        want = {"prepare": {k: b * n for k, n in ENC_KITTI.items()},
                "advance": {"fused_iter": SERVER_ITERS_PER_TICK,
                            "gru1632": SERVER_ITERS_PER_TICK},
                "epilogue": {}}
        if got != want:
            raise SystemExit(f"server: batched programs at b={b} captured {got}, "
                             f"expected {want}")
        out[str(b)] = got
    return out


def _http(port: int, path: str, body: bytes = None, ct: str = None) -> tuple:
    """(status, body bytes) of one request to the CLI on loopback."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET",
                                 headers={"Content-Type": ct} if ct else {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _read_handshake(fd: int, proc) -> int:
    import select
    deadline = time.monotonic() + CLI_WAIT_S
    data = b""
    while not data.endswith(b"\n"):
        if proc.poll() is not None:
            raise SystemExit(f"server CLI: exited {proc.returncode} before its handshake")
        left = deadline - time.monotonic()
        if left <= 0:
            raise SystemExit("server CLI: no handshake within CLI_WAIT_S")
        ready, _, _ = select.select([fd], [], [], min(left, 1.0))
        if ready:
            chunk = os.read(fd, 64)
            if not chunk:
                raise SystemExit("server CLI: handshake pipe closed empty")
            data += chunk
    key, _, port = data.decode().strip().partition("=")
    if key != "RAFT_HTTP_PORT":
        raise SystemExit(f"server CLI: handshake {data!r}")
    return int(port)


def phase_cli(model, pairs, refs) -> dict:
    """``python -m raft_stereo_tpu_torch.serve_stereo --http_port`` in a
    subprocess on loopback (the same tempered weights through a .pth, the
    same session config as the in-process service, ``--ready_fd``):
    /healthz 200, four multipart PNG requests whose disparities equal
    ``refs`` (in-process submits of the same decoded arrays) byte for byte,
    /metrics with the request counters, a truncated multipart body
    ``bad_multipart`` 400, and SIGTERM draining to exit 0. Without Pillow
    on the machine the PNG requests are left out, and the line says so."""
    import importlib.util
    import signal

    import numpy as np

    from raft_stereo_tpu_torch.serve import wire
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "chip_smoke_server"
    out_dir.mkdir(parents=True, exist_ok=True)
    pth = out_dir / "model.pth"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, pth)
    pillow = importlib.util.find_spec("PIL") is not None
    if not pillow:
        print(json.dumps({"phase": "server_cli", "note": "no Pillow on this machine: the "
                          "PNG requests are left out"}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAFT_") and
           k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    r_fd, w_fd = os.pipe()
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.serve_stereo", "--restore_ckpt",
           str(pth), "--corr_implementation", "reg_cuda", "--mixed_precision", "--bucket", "32",
           "--http_port", "0", "--ready_fd", str(w_fd), "--max_batch", "4",
           "--warmup", f"{KITTI[0]}x{KITTI[1]}", "--valid_iters", str(ITERS),
           "--segments", str(SERVER_SEGMENTS), "--device", CLI_DEVICE, *CLI_ARCH]
    t0 = time.perf_counter()
    with open(out_dir / "stdout.txt", "w") as so, open(out_dir / "stderr.txt", "w") as se:
        proc = subprocess.Popen(cmd, cwd=root, env=env, pass_fds=(w_fd,), stdout=so,
                                stderr=se, text=True)
    os.close(w_fd)
    result = {"phase": "server_cli", "pillow": pillow}
    try:
        port = _read_handshake(r_fd, proc)
        result["ready_s"] = time.perf_counter() - t0
        status, body = _http(port, "/healthz")
        health = json.loads(body)
        if status != 200 or not isinstance(health.get("fingerprint_id"), str):
            raise SystemExit(f"server CLI: /healthz {status}")
        same = []
        if pillow:
            for i, (left, right) in enumerate(pairs[:4]):
                ct, payload = wire.build_multipart({
                    "left": wire.encode_image_png(left[0]),
                    "right": wire.encode_image_png(right[0]), "id": f"http-{i}".encode()})
                status, body = _http(port, "/v1/stereo", payload, ct)
                resp = wire.decode_response(body)
                if status != 200 or resp["status"] != "ok":
                    raise SystemExit(f"server CLI: POST {i} gave {status} {resp.get('code')}")
                got = np.asarray(resp["disparity"], np.float32)
                same.append(got.tobytes() == np.asarray(refs[i], np.float32).tobytes())
                if not same[-1]:
                    raise SystemExit(f"server CLI: POST {i} differs from the in-process "
                                     f"response, max |d| {np.abs(got - refs[i]).max()}")
        ct, payload = wire.build_multipart({"left": b"L" * 64, "right": b"R" * 64})
        status, body = _http(port, "/v1/stereo", payload[:len(payload) // 2], ct)
        bad = json.loads(body)
        if status != 400 or bad.get("code") != "bad_multipart":
            raise SystemExit(f"server CLI: a truncated body gave {status} {bad}")
        status, body = _http(port, "/metrics")
        metrics = body.decode()
        if status != 200 or "raft_requests_total" not in metrics or \
                "raft_http_responses_total" not in metrics:
            raise SystemExit(f"server CLI: /metrics {status} lacks the request counters")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CLI_WAIT_S)
    finally:
        os.close(r_fd)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    events = [json.loads(line) for line in (out_dir / "stdout.txt").read_text().splitlines()
              if line.startswith('{"event"')]
    drained = [e for e in events if e.get("event") == "drained"]
    if rc != 0 or not drained or not drained[0]["clean"]:
        raise SystemExit(f"server CLI: exit {rc}, events {events}\n"
                         f"{(out_dir / 'stderr.txt').read_text()[-3000:]}")
    result.update(posts_bitwise=same, truncated={"status": 400, "code": "bad_multipart"},
                  exit_code=rc, events=[e["event"] for e in events],
                  health_requests=health.get("requests"))
    print(json.dumps(result))
    return result


def phase_server(smi: str) -> dict:
    """The server (see the module docstring, phase 8)."""
    import gc

    import numpy as np

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                             StereoService)
    from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = seeded_model("cuda")
    pairs = _server_pairs(SERVER_PAIRS, seed=31)
    t0 = time.perf_counter()
    sess1 = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=SERVER_SEGMENTS, warmup_shapes=(KITTI,)))
    kernels.reset_launches()
    sess4 = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=SERVER_SEGMENTS, max_batch=4, warmup_shapes=(KITTI,)))
    setup_s = time.perf_counter() - t0
    if tuple(sess4.batch_buckets) != SERVER_BUCKETS:
        raise SystemExit(f"server: batch buckets {sess4.batch_buckets}")
    ph, pw = sess4.padder_for(pairs[0][0].shape).padded_shape
    svc1 = StereoService(sess1, ServiceConfig(max_queue=2 * SERVER_CLIENTS)).start()
    svc4 = StereoService(sess4, ServiceConfig(max_queue=2 * SERVER_CLIENTS)).start()
    try:
        # 1. Alone: the reference responses, one request at a time.
        alone = _served(svc1, pairs, clients=1)
        # 2. Batched: eight clients at once, then two (a tick at b=2).
        batched = _served(svc4, pairs, clients=SERVER_CLIENTS)
        batched += _served(svc4, pairs[:2], clients=2)
        refs = [r["disparity"] for r in alone] + [alone[0]["disparity"], alone[1]["disparity"]]
        rows = []
        for r, ref in zip(batched, refs):
            d = float(np.abs(r["disparity"] - ref).max())
            rows.append({"bitwise": r["disparity"].tobytes() == ref.tobytes(),
                         "max_abs_diff": d,
                         "in_band": bool(np.allclose(r["disparity"], ref, rtol=CANARY_RTOL,
                                                     atol=CANARY_ATOL))})
        ticks = svc4.status()["batching"]["ticks_by_bucket"]
        # Within one width: four rows by hand at b=4, distinct batchmates
        # and each against replicas of itself (pad rows).
        mates = _by_hand(sess4, pairs[:4], ph, pw)
        within = [mates[i].tobytes() == _by_hand(sess4, [pairs[i]] * 4, ph, pw)[0].tobytes()
                  for i in range(4)]
        launches = _program_launches_checked(sess4, ph, pw)
        adv = sess4.get_program("advance", ph, pw, SERVER_ITERS_PER_TICK, b=4)
        tries, prof, events = _replay_profile(adv)
        from raft_stereo_tpu_torch.obs.profiler import device_seconds
        busy = device_seconds(prof)
        copies = [_carry_copy(sess4, ph, pw, b) for b in (1, 4)]
        device = {f"{kind}@b{b}": _replay_breakdown(sess4.get_program(kind, ph, pw, it, b=b))
                  for kind, it in (("prepare", 0), ("advance", SERVER_ITERS_PER_TICK),
                                   ("epilogue", 0)) for b in SERVER_BUCKETS}
        # 3. Rate and latency, max_batch 1 and 4 in turns.
        rounds = [{"max_batch": mb, **_rate(svc1 if mb == 1 else svc4, pairs)}
                  for mb in SERVER_ROUNDS]
        profiled = {mb: _busy_share(svc1 if mb == 1 else svc4, pairs) for mb in (1, 4)}
        pools = {name: sum(p["pool_bytes"] or 0.0 for p in s.programs())
                 for name, s in (("max_batch_1", sess1), ("max_batch_4", sess4))}
        peak = torch.cuda.max_memory_allocated()
        # The in-process references of the CLI's requests: the same decoded
        # arrays (PNG is lossless) one at a time through max_batch 4.
        cli_refs = [svc4.submit(_request(f"ref-{i}", p)).result(timeout=600)["disparity"]
                    for i, p in enumerate(pairs[:4])]
        line = {"phase": "server", "card": smi, "setup_s": setup_s,
                "padded": [ph, pw], "buckets": list(sess4.batch_buckets),
                "ticks_by_bucket": ticks, "rows": rows,
                "bitwise_across_widths": all(r["bitwise"] for r in rows),
                "max_abs_diff_across_widths": max(r["max_abs_diff"] for r in rows),
                "cross_width_pin": CROSS_WIDTH_PIN, "within_width_bitwise": within,
                "program_launches": launches, "advance_replay_tries": tries,
                "advance_replay_device_events": events,
                "advance_b4_replay_busy_ms": None if busy is None else busy * 1e3,
                "carry_copy": copies, "program_device_ms": device, "rate": rounds,
                "rate_ratio": (statistics.median(r["frames_per_s"] for r in rounds
                                                 if r["max_batch"] == 4)
                               / statistics.median(r["frames_per_s"] for r in rounds
                                                   if r["max_batch"] == 1)),
                "profiled_rounds": profiled, "graph_pool_bytes": pools,
                "max_memory_allocated": peak,
                "batching": svc4.status()["batching"],
                "trips": [s.breaker.trip_count for s in (sess1, sess4)],
                "kernels_only": [s.breaker.kernels_only for s in (sess1, sess4)]}
        print(json.dumps(line))
    finally:
        svc1.stop()
        svc4.stop()
    if not ("2" in ticks and "4" in ticks):
        raise SystemExit(f"server: no tick at b=2 and at b=4: {ticks}")
    if not all(within):
        raise SystemExit(f"server: rows at b=4 depend on their batchmates: {within}")
    pin_ok = all(r["bitwise"] if CROSS_WIDTH_PIN == "bitwise" else r["in_band"] for r in rows)
    if not pin_ok:
        raise SystemExit(f"server: rows across widths break the {CROSS_WIDTH_PIN} pin: {rows}")
    if tries[-1] != _replay_want(adv.launches):
        raise SystemExit(f"server: an advance replay shows {tries}, the capture counted "
                         f"{_replay_want(adv.launches)}")
    if any(line["trips"]) or not all(line["kernels_only"]):
        raise SystemExit(f"server: breaker trips on a clean path: {line['trips']}")
    del sess1, svc1
    del sess4, svc4
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_cli(model, pairs, cli_refs)
    return {"server": line, "cli": cli}


# -- phase 9: streams, the response cache and the fleet ------------------------------

STREAM_FRAMES = 8
STREAM_SEGMENTS = 4
STREAM_ITERS_PER_SEGMENT = ITERS // STREAM_SEGMENTS
FORCED_TOL = 1e9  # every warm frame exits at its first segment boundary
STREAM_ROUNDS = (("cold", None), ("stream", None), ("stream", FORCED_TOL), ("cold", None),
                 ("stream", FORCED_TOL), ("stream", None))
CACHE_NEAR_TOL = 8.0  # gray levels; the frames of a stream share their left image


def _spill_budget() -> int:
    """A cache budget that holds one KITTI entry (the fp32 disparity,
    1.86e6 bytes, its signature and seed) and not two: a second deposit
    spills the first."""
    return int(1.5 * KITTI[0] * KITTI[1] * 4)

FLEET_INSTANCES = 2
FLEET_WAIT_S = 300
FLEET_INFLIGHT = 4
# The fleet's stdout, and the in-process checks' files, live here.
STREAMS_DIR = ("build", "chip_smoke_streams")


def _stream_frames(n: int, seed: int) -> list:
    """One random uint8 KITTI pair, its right image shifted by 0..n-1 px:
    the frames of a slowly panning rig."""
    import numpy as np
    rng = np.random.default_rng(seed)
    left, right = (rng.integers(0, 256, (1, *KITTI, 3), dtype=np.uint8) for _ in range(2))
    return [(left, np.ascontiguousarray(np.roll(right, k, axis=2))) for k in range(n)]


def _f32(pair) -> tuple:
    import numpy as np
    return tuple(np.ascontiguousarray(x.astype(np.float32)) for x in pair)


def _eager_stream(model, sess, pair, seed, segments: int):
    """The eager composition on the card of one stream frame, as the
    session's b=1 programs compose it: prepare (or prepare_warm with
    ``seed``), ``segments`` advance segments, the epilogue. Returns the
    served disparity."""
    from raft_stereo_tpu_torch.serve.session import build_program
    left, right = _f32(pair)
    padder = sess.padder_for(left.shape)
    lp, rp = padder.pad_np(left, right)
    dev = sess.device
    with torch.no_grad():
        t1, t2 = torch.from_numpy(lp).to(dev), torch.from_numpy(rp).to(dev)
        if seed is None:
            (state,) = build_program("prepare", model, 0)(t1, t2)
        else:
            (state,) = build_program("prepare_warm", model, 0)(
                t1, t2, torch.from_numpy(seed).to(dev))
        adv = build_program("advance", model, STREAM_ITERS_PER_SEGMENT)
        for _ in range(segments):
            state, _, _ = adv(state)
        up, _ = build_program("epilogue", model, 0)(state)
    return (-padder.unpad(up)[0, ..., 0]).cpu().numpy()


def _flow_init_forward(model, sess, pair, seed, iters: int):
    """The model's forward with ``flow_init`` (the seed, y = 0) on the card:
    its warm-start mode, the serial chain with the torch motion encoder."""
    from raft_stereo_tpu_torch import raft_stereo_forward
    left, right = _f32(pair)
    padder = sess.padder_for(left.shape)
    lp, rp = padder.pad_np(left, right)
    dev = sess.device
    with torch.no_grad():
        fx = torch.from_numpy(seed).to(dev)
        _, up = raft_stereo_forward(model, torch.from_numpy(lp).to(dev),
                                    torch.from_numpy(rp).to(dev), iters=iters,
                                    flow_init=torch.cat([fx, torch.zeros_like(fx)], dim=-1))
    return (-padder.unpad(up)[0, ..., 0]).cpu().numpy()


# A warm frame against the model's forward with the same flow_init: the
# warm chain keeps the loop kernels (the resident kernel's motion encoder,
# legal since the seed's y channel is zero), the forward takes the serial
# chain with the torch motion encoder, so the two round apart, and the
# seeded model's loop, which does not contract, grows the difference with
# the iterations (as _disparity_band's routes do) and with the disparity
# the frames accumulate (25.7 px mean at frame 1, 137 at frame 8). Not the
# canary band (0.05 px + 0.5%): read on an H100, mean 0.026-0.112 px and
# max 0.15-0.93 px over both runs' frames (the zero-seed baseline of frame 1
# 0.112 and 0.398); the band is twice the largest reading. (mean, max) px.
WARM_ROUTE_BAND = (0.25, 2.0)


def _warm_route_band(got, ref, baseline: bool = False) -> dict:
    import numpy as np
    d = np.abs(got - ref)
    mean_tol, max_tol = WARM_ROUTE_BAND
    return {"flow_init_forward_mean_abs_diff": float(d.mean()),
            "flow_init_forward_max_abs_diff": float(d.max()),
            "disparity_abs_mean": float(np.abs(ref).mean()),
            "flow_init_forward_in_band": bool(d.mean() <= mean_tol and d.max() <= max_tol),
            "zero_seed_baseline": baseline}


def _in_band(a, b) -> bool:
    import numpy as np

    from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
    return bool(np.allclose(a, b, rtol=CANARY_RTOL, atol=CANARY_ATOL))


def _stream_run(sess, model, frames, tol) -> list:
    """The frames through a StreamRunner at tolerance ``tol`` (None: the
    default, RAFT_CONVERGE_TOL or 0.01), each held to the eager composition
    bit for bit, frame 1 to the stateless response, every warm frame to the
    flow_init forward within the canary band. One row a frame."""
    import numpy as np

    from raft_stereo_tpu_torch.serve import StreamRunner
    runner = StreamRunner(sess, converge_tol=tol)
    rows = []
    for k, pair in enumerate(frames):
        seed = None if runner.last is None else runner.last.flow_low
        t0 = time.perf_counter()
        res = runner.infer(*_f32(pair))
        ms = (time.perf_counter() - t0) * 1e3
        out = runner.last
        segs = res.iters // STREAM_ITERS_PER_SEGMENT
        eager = _eager_stream(model, sess, pair, seed, segs)
        row = {"frame": k + 1, "label": res.quality, "iters": res.iters, "warm": out.warm,
               "dnorm_by_segment": list(out.dnorms), "request_ms": ms,
               "eager_bitwise": res.disparity.tobytes() == eager.tobytes()}
        if seed is None:
            ref = sess.infer(*_f32(pair)).disparity
            row["stateless_bitwise"] = res.disparity.tobytes() == ref.tobytes()
            # The route's own difference, with no seed: the forward in its
            # warm-start mode (a zero flow_init) against the cold frame.
            zero = np.zeros_like(out.flow_low)
            row.update(_warm_route_band(res.disparity, _flow_init_forward(
                model, sess, pair, zero, res.iters), baseline=True))
        else:
            row.update(_warm_route_band(res.disparity, _flow_init_forward(
                model, sess, pair, seed, res.iters)))
        rows.append(row)
    bad = [r for r in rows if not (r["eager_bitwise"] and r.get("stateless_bitwise", True)
                                   and r["flow_init_forward_in_band"])]
    if bad or rows[0]["warm"] or not all(r["warm"] for r in rows[1:]):
        raise SystemExit(f"streams: a frame breaks its pins: {bad or rows}")
    if tol == FORCED_TOL and any(r["label"] != f"converged:{STREAM_ITERS_PER_SEGMENT}"
                                 for r in rows[1:]):
        raise SystemExit(f"streams: tolerance {tol} did not exit at the first boundary: "
                         f"{[r['label'] for r in rows]}")
    return rows


def _stream_rounds(sess, frames) -> list:
    """Frames/s of the stream against the same frames served cold, in turns
    (STREAM_ROUNDS), at the default tolerance and at FORCED_TOL."""
    from raft_stereo_tpu_torch.serve import StreamRunner
    pairs = [_f32(p) for p in frames]
    out = []
    for kind, tol in STREAM_ROUNDS:
        runner = StreamRunner(sess, converge_tol=tol) if kind == "stream" else None
        iters = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for left, right in pairs:
            res = runner.infer(left, right) if runner else sess.infer(left, right)
            iters.append(res.iters)
        dt = time.perf_counter() - t0
        out.append({"kind": kind, "tol": tol, "frames_per_s": len(pairs) / dt,
                    "iters": iters})
    return out


def _service_streams(sess4, model, frames_a, frames_b) -> dict:
    """Two streams at max_batch 4 (A at the default tolerance, B at
    FORCED_TOL), frame by frame, each frame submitted with a cold request
    of its pair, all at once; frame 1 of each beside its stateless twin.
    Frame 1 must be bit for bit its stateless response; each warm frame
    holds to the eager b=1 composition by CROSS_WIDTH_PIN."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from raft_stereo_tpu_torch.serve import ServiceConfig, StereoService
    svc = StereoService(sess4, ServiceConfig(max_queue=16)).start()
    rows = []
    try:
        seeds = {"A": None, "B": None}
        for k in range(STREAM_FRAMES):
            reqs = []
            for sid, frames in (("A", frames_a), ("B", frames_b)):
                req = {"id": f"{sid}{k}", "left": _f32(frames[k])[0],
                       "right": _f32(frames[k])[1], "stream": sid}
                if sid == "B" and k:
                    # From its first warm frame on (a tolerance on a cold
                    # frame would exit it too).
                    req["converge_tol"] = FORCED_TOL
                reqs.append(req)
            reqs.append({"id": f"cold-A{k}", "left": reqs[0]["left"], "right": reqs[0]["right"]})
            if k == 0:
                reqs.append({"id": "cold-B0", "left": reqs[1]["left"],
                             "right": reqs[1]["right"]})
            with ThreadPoolExecutor(max_workers=len(reqs)) as ex:
                resps = {r["id"]: r for r in ex.map(
                    lambda q: svc.submit(q).result(timeout=600), reqs)}
            for sid, frames in (("A", frames_a), ("B", frames_b)):
                r = resps[f"{sid}{k}"]
                if r["status"] != "ok":
                    raise SystemExit(f"streams: service frame {sid}{k}: {r}")
                row = {"stream": sid, "frame": k + 1, "label": r["quality"], "iters": r["iters"],
                       "request_ms": r["elapsed_ms"]}
                if k == 0:
                    row["stateless_bitwise"] = (r["disparity"].tobytes()
                                                == resps[f"cold-{sid}0"]["disparity"].tobytes())
                else:
                    eager = _eager_stream(model, sess4, frames[k], seeds[sid],
                                          r["iters"] // STREAM_ITERS_PER_SEGMENT)
                    row["eager_bitwise"] = r["disparity"].tobytes() == eager.tobytes()
                    row["eager_max_abs_diff"] = float(np.abs(r["disparity"] - eager).max())
                    row["eager_in_band"] = _in_band(r["disparity"], eager)
                rows.append(row)
            # The seeds the service's next frames get, for the eager twins:
            # each stream's flow as its session holds it.
            with svc.stream._lock:
                for sid in ("A", "B"):
                    seeds[sid] = svc.stream._table[("default", sid)].flow
        status = svc.status()["stream"]
    finally:
        svc.stop()
    pin = CROSS_WIDTH_PIN == "bitwise"
    bad = [r for r in rows if not r.get("stateless_bitwise", True)
           or not (r.get("eager_bitwise", True) if pin else r.get("eager_in_band", True))]
    if bad:
        raise SystemExit(f"streams: service frames break their pins: {bad}")
    if any(r["label"] != f"converged:{STREAM_ITERS_PER_SEGMENT}"
           for r in rows if r["stream"] == "B" and r["frame"] > 1):
        raise SystemExit(f"streams: stream B did not exit at the first boundary: {rows}")
    if status["warm_joins"] != 2 * (STREAM_FRAMES - 1):
        raise SystemExit(f"streams: warm joins {status}")
    return {"rows": rows, "stream_status": status}


def _warm_row_compositions(sess4, pair) -> dict:
    """A warm row at batch bucket 4 beside two cold rows, then beside
    three: the same bits."""
    import numpy as np

    from raft_stereo_tpu_torch.serve import BatchScheduler
    from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
    left, right = validate_pair(*_f32(pair), AdmissionConfig())
    ph, pw = sess4.padder_for(left.shape).padded_shape
    f = sess4._run_cfg.downsample_factor
    seed = np.random.default_rng(41).uniform(-2, 2, (1, ph // f, pw // f, 1)).astype(np.float32)

    def run(n_cold):
        out = {}
        sched = BatchScheduler(sess4, resolve=lambda rq, rs: out.__setitem__(rq["id"], rs))
        sched.submit({"id": "w", "left": left, "right": right, "_flow_init": seed.copy()})
        for i in range(n_cold):
            sched.submit({"id": f"c{i}", "left": left, "right": right})
        for bucket in sched._buckets.values():
            for row in list(bucket.pending):
                if not row.uploaded.wait(timeout=120):
                    raise SystemExit("streams: an upload never finished")
        spins = 0
        while len(out) < n_cold + 1:
            if not sched.run_tick():
                time.sleep(0.002)
            spins += 1
            if spins > 20000:
                raise SystemExit("streams: the scheduler made no progress")
        sched.shutdown()
        return out

    a, b = run(2), run(3)
    same = a["w"]["disparity"].tobytes() == b["w"]["disparity"].tobytes()
    if not same or a["w"]["status"] != "ok":
        raise SystemExit(f"streams: a warm row at b=4 changes with its batchmates "
                         f"(max |d| {float(np.abs(a['w']['disparity'] - b['w']['disparity']).max())})")
    return {"bitwise": same, "labels": [a["w"]["quality"], b["w"]["quality"]]}


def _counters(sess) -> dict:
    from raft_stereo_tpu_torch import kernels
    return {"calls": sum(v for _, v in sess.registry.series("raft_program_calls_total")),
            "device_s": sum(v for _, v in sess.registry.series(
                "raft_program_device_seconds_total")),
            "launches": dict(kernels.launches)}


def _cache_checks(sess, frames, spill: Path) -> dict:
    """The response cache on the card (see the module docstring, phase 9)."""
    import shutil

    from raft_stereo_tpu_torch.serve import ServiceConfig, StereoService
    f0, f1, f2 = (_f32(frames[i]) for i in (0, 1, 2))
    svc = StereoService(sess, ServiceConfig(cache_bytes=256 << 20,
                                            cache_near_tol=CACHE_NEAR_TOL))
    cold = svc.handle({"id": "cold", "left": f0[0], "right": f0[1]})
    before = _counters(sess)
    t0 = time.perf_counter()
    hit = svc.handle({"id": "hit", "left": f0[0], "right": f0[1]})
    hit_ms = (time.perf_counter() - t0) * 1e3
    after = _counters(sess)
    near = svc.handle({"id": "near", "left": f1[0], "right": f1[1],
                       "converge_tol": FORCED_TOL})
    exact = {"label": hit["quality"], "bitwise": hit["disparity"].tobytes()
             == cold["disparity"].tobytes(), "hit_ms": hit_ms, "cold_ms": cold["elapsed_ms"],
             "program_calls": after["calls"] - before["calls"],
             "device_s": after["device_s"] - before["device_s"],
             "launches_moved": after["launches"] != before["launches"]}
    near_row = {"label": near["quality"], "iters": near["iters"],
                "near_hits": svc.cache.status()["near_hits"]}
    svc.stop()
    # The disk spill across a restart: a budget of one entry, two deposits.
    shutil.rmtree(spill, ignore_errors=True)
    cfg = ServiceConfig(cache_bytes=_spill_budget(), cache_dir=str(spill))
    svc = StereoService(sess, cfg)
    first = svc.handle({"id": "p", "left": f0[0], "right": f0[1]})
    svc.handle({"id": "q", "left": f2[0], "right": f2[1]})
    spills = svc.cache.status()["disk"]["spills"]
    svc.stop()
    svc = StereoService(sess, cfg)  # the restart: RAM empty, the spill kept
    again = svc.handle({"id": "p-again", "left": f0[0], "right": f0[1]})
    disk = svc.cache.status()["disk"]
    svc.stop()
    restart = {"spills": spills, "label": again["quality"], "disk_hits": disk["hits"],
               "bitwise": again["disparity"].tobytes() == first["disparity"].tobytes()}
    result = {"exact": exact, "near": near_row, "restart": restart}
    if not (exact["label"] == "cache:exact" and exact["bitwise"] and exact["program_calls"] == 0
            and exact["device_s"] == 0 and not exact["launches_moved"]):
        raise SystemExit(f"streams: the exact tier: {exact}")
    if near_row["label"] != f"warm:cache:{STREAM_ITERS_PER_SEGMENT}":
        raise SystemExit(f"streams: the near tier: {near_row}")
    if not (spills >= 1 and restart["label"] == "cache:exact" and restart["bitwise"]
            and restart["disk_hits"] == 1):
        raise SystemExit(f"streams: the spill across a restart: {restart}")
    return result


def _fleet_http(port: int, path: str, body: bytes = None, headers: dict = None,
                timeout: float = 300) -> tuple:
    """(status, body bytes) of one request on loopback; a connection error
    is (None, its text): the caller decides."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError as e:
        return None, str(e).encode()


def _png_request(pair, rid: str) -> tuple:
    from raft_stereo_tpu_torch.serve import wire
    return wire.build_multipart({"left": wire.encode_image_png(pair[0][0]),
                                 "right": wire.encode_image_png(pair[1][0]),
                                 "id": rid.encode()})


def _fleet_doc(port: int) -> dict:
    status, body = _fleet_http(port, "/fleet/healthz", timeout=30)
    if status != 200:
        raise SystemExit(f"fleet: /fleet/healthz {status} {body[:200]!r}")
    return json.loads(body)


def _fleet_post(port, pair, rid, session=None, tol=None, timeout=300) -> tuple:
    from raft_stereo_tpu_torch.serve import wire
    ct, payload = _png_request(pair, rid)
    headers = {"Content-Type": ct}
    if session is not None:
        headers["X-Raft-Session"] = session
    if tol is not None:
        headers["X-Raft-Converge-Tol"] = repr(tol)
    t0 = time.perf_counter()
    status, body = _fleet_http(port, "/v1/stereo", payload, headers, timeout=timeout)
    t1 = time.perf_counter()
    if status is None:
        return None, {"status": "hung_or_reset", "message": body.decode()}, t1
    if status == 200:
        return status, wire.decode_response(body), t1
    return status, json.loads(body), t1


def _answered(doc: dict) -> dict:
    return {uid: b["answered"] for uid, b in doc["books"].items()}


DEMO_FRAMES = 3


def _demo_video(pth: Path, frames) -> dict:
    """``python -m raft_stereo_tpu_torch.demo --video``'s frames in process
    (``demo.disparities``, all of the CLI but its matplotlib PNG save) over
    DEMO_FRAMES PNG frames of the stream, and the same glob without
    ``--video``: frame 1 of the video bit for bit the single-pair output,
    the warm frames ``converged:8`` at 1e9."""
    from raft_stereo_tpu_torch import demo
    from raft_stereo_tpu_torch.serve import wire
    root = pth.parent / "demo"
    for k in range(DEMO_FRAMES):
        d = root / "frames" / f"f{k}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "im0.png").write_bytes(wire.encode_image_png(frames[k][0][0]))
        (d / "im1.png").write_bytes(wire.encode_image_png(frames[k][1][0]))
    args = ["--restore_ckpt", str(pth), "--corr_implementation", "reg_cuda",
            "--mixed_precision", "--valid_iters", str(ITERS), "--device", CLI_DEVICE,
            *CLI_ARCH, "-l", str(root / "frames" / "f*" / "im0.png"),
            "-r", str(root / "frames" / "f*" / "im1.png"),
            "--output_directory", str(root / "out")]
    parser = demo.build_parser()
    t0 = time.perf_counter()
    video = list(demo.disparities(parser.parse_args(
        [*args, "--video", "--segments", str(STREAM_SEGMENTS),
         "--converge_tol", repr(FORCED_TOL)])))
    video_s = time.perf_counter() - t0
    single = list(demo.disparities(parser.parse_args(args)))
    same = [v[1].tobytes() == s1[1].tobytes() for v, s1 in zip(video, single)]
    labels = [v[2] for v in video]
    result = {"frames": len(video), "labels": labels, "video_s": video_s,
              "frame1_bitwise_single_pair": same[0], "warm_frames_differ": not any(same[1:])}
    if len(video) != DEMO_FRAMES or not same[0] or any(same[1:]) or labels[1:] != [
            f"converged:{STREAM_ITERS_PER_SEGMENT}"] * (DEMO_FRAMES - 1):
        raise SystemExit(f"streams: demo --video against single pairs: {result}")
    return result


def phase_fleet(model, frames, refs: dict) -> dict:
    """``python -m raft_stereo_tpu_torch.fleet_stereo`` (see the module
    docstring, phase 9)."""
    import shutil
    import signal

    import numpy as np
    root = Path(__file__).resolve().parent
    out_dir = root.joinpath(*STREAMS_DIR)
    cache_dir = out_dir / "fleet_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    pth = out_dir / "model.pth"
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAFT_") and
           k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.fleet_stereo",
           "--instances", str(FLEET_INSTANCES), "--cache_dir", str(cache_dir),
           "--probe_ms", "200", "--warmup_timeout_ms", str(FLEET_WAIT_S * 1e3),
           "--drain_grace_ms", "20000", "--",
           "--restore_ckpt", str(pth), "--corr_implementation", "reg_cuda", "--mixed_precision",
           "--bucket", "32", "--max_batch", "1", "--warmup", f"{KITTI[0]}x{KITTI[1]}",
           "--valid_iters", str(ITERS), "--segments", str(STREAM_SEGMENTS),
           "--cache_bytes", str(_spill_budget()), "--no_canary", "--device", CLI_DEVICE,
           *CLI_ARCH]
    t0 = time.perf_counter()
    so_path = out_dir / "fleet_stdout.txt"
    with open(so_path, "w") as so, open(out_dir / "fleet_stderr.txt", "w") as se:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=so, stderr=se, text=True)
    pids = set()
    result = {"phase": "fleet"}
    try:
        port = None
        while port is None:
            if proc.poll() is not None:
                raise SystemExit(f"fleet: exited {proc.returncode} before listening\n"
                                 f"{(out_dir / 'fleet_stderr.txt').read_text()[-3000:]}")
            if time.perf_counter() - t0 > 2 * FLEET_WAIT_S:
                raise SystemExit("fleet: not listening in time")
            for line in so_path.read_text().splitlines():
                if line.startswith('{"event": "fleet_listening"'):
                    port = json.loads(line)["port"]
            time.sleep(0.2)
        result["ready_s"] = time.perf_counter() - t0
        doc = _fleet_doc(port)
        rows = {r["uid"]: r for r in doc["by_instance"]}
        pids |= {r["pid"] for r in rows.values()}
        if doc["states"].get("ready") != FLEET_INSTANCES:
            raise SystemExit(f"fleet: handshakes {doc['states']}")
        # Frame 1 of the stream "rig": pinned, and bit for bit in process.
        before = _answered(doc)
        status, r1, _ = _fleet_post(port, frames[0], "rig-1", session="rig")
        doc = _fleet_doc(port)
        moved = [u for u, n in _answered(doc).items() if n != before.get(u, 0)]
        if status != 200 or r1["status"] != "ok" or len(moved) != 1:
            raise SystemExit(f"fleet: frame 1 gave {status} {r1.get('code')}, books {moved}")
        doomed = rows[moved[0]]
        status, r2, _ = _fleet_post(port, frames[1], "rig-2", session="rig")
        doc = _fleet_doc(port)
        pinned = _answered(doc)[doomed["uid"]] == before.get(doomed["uid"], 0) + 2
        frame1_bitwise = np.asarray(r1["disparity"]).tobytes() == refs["frame1"].tobytes()
        # Two cold pairs straight to the pinned instance: its one-entry
        # budget spills the first to the shared cache_dir.
        p_status, p_resp, _ = _fleet_post(doomed["port"], frames[2], "p")
        _fleet_post(doomed["port"], frames[3], "q")
        spilled = sorted(cache_dir.glob("*.npz"))
        if p_status != 200 or not spilled:
            raise SystemExit(f"fleet: no spill in {cache_dir} ({p_status})")
        # The survivor's books and stream counters before the kill.
        survivor = next(u for u in rows if u != doomed["uid"])
        answered0 = _answered(_fleet_doc(port))
        st, health0 = _fleet_http(rows[survivor]["port"], "/healthz", timeout=30)
        warm0 = json.loads(health0)["stream"]["warm_joins"]
        # kill -9 with frames of the stream in flight on that instance. They
        # carry FORCED_TOL, so wherever they are served they exit early and
        # are never deposited: the survivor shares the cache_dir, and its
        # own evictions would prune the spill this phase reads back.
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=FLEET_INFLIGHT) as ex:
            futs = [ex.submit(_fleet_post, port, frames[4 + i], f"rig-{5 + i}", "rig",
                              FORCED_TOL, 120) for i in range(FLEET_INFLIGHT)]
            time.sleep(0.05)
            t_kill = time.perf_counter()
            os.kill(doomed["pid"], signal.SIGKILL)
            inflight = [f.result(timeout=180) for f in futs]
        structured = [s == 200 and r.get("status") == "ok"
                      or s in (502, 503) and isinstance(r.get("code"), str)
                      for s, r, _ in inflight]
        # The stream after the kill: re-pinned to the survivor, cold there
        # first (it never held the seed), warm after.
        survivor = next(u for u in rows if u != doomed["uid"])
        surv_port = rows[survivor]["port"]
        # A frame no instance has seen (an exact hit would say nothing).
        fresh = (frames[0][0], np.ascontiguousarray(np.roll(frames[0][1], 11, axis=2)))
        status, r_next, t_next = _fleet_post(port, fresh, "rig-after", session="rig",
                                             tol=FORCED_TOL)
        st, health1 = _fleet_http(surv_port, "/healthz", timeout=30)
        stream1 = json.loads(health1)["stream"]
        surv_answered = _answered(_fleet_doc(port))[survivor] - answered0[survivor]
        served_200 = [t for s, r, t in inflight if s == 200] + [t_next]
        first_after_kill_s = min(served_200) - t_kill
        # The replacement: the same slot, a new uid, ready.
        replacement = None
        while replacement is None:
            if time.perf_counter() - t_kill > FLEET_WAIT_S:
                raise SystemExit("fleet: no replacement in time")
            doc = _fleet_doc(port)
            for r in doc["by_instance"]:
                if r["slot"] == doomed["slot"] and r["uid"] not in (None, doomed["uid"]) \
                        and r["state"] == "ready":
                    replacement = r
            time.sleep(0.1)
        replaced_s = time.perf_counter() - t_kill
        pids.add(replacement["pid"])
        status, p_again, _ = _fleet_post(replacement["port"], frames[2], "p-again")
        result.update(
            instances_ready=doc["states"].get("ready"), pinned=pinned,
            frame1_label=r1["quality"], frame1_bitwise_in_process=frame1_bitwise,
            frame2_label=r2["quality"], spilled_files=len(spilled),
            inflight=[{"status": s, "label": r.get("quality") or r.get("code")}
                      for s, r, _ in inflight],
            inflight_structured=all(structured),
            after_kill={"status": status, "label": r_next.get("quality"),
                        "survivor_answered": surv_answered,
                        "survivor_warm_joins": [warm0, stream1["warm_joins"]],
                        "survivor_sessions": stream1["sessions"]},
            kill_to_first_survivor_response_s=first_after_kill_s,
            kill_to_replacement_ready_s=replaced_s,
            replacement_slot=replacement["slot"],
            spill_from_replacement={"status": status, "label": p_again.get("quality"),
                                    "bitwise": np.asarray(p_again.get("disparity")).tobytes()
                                    == np.asarray(p_resp["disparity"]).tobytes()},
            counters=doc["counters"], books=doc["books"])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=FLEET_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in pids:  # every instance this phase saw, whatever the fleet did
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, TypeError):
                pass
    result["exit_code"] = rc
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps(result, default=str))
    after = result["after_kill"]
    checks = {"handshakes": result["instances_ready"] == FLEET_INSTANCES,
              "pinned": result["pinned"], "frame1_bitwise": frame1_bitwise,
              "inflight_structured": result["inflight_structured"],
              "survivor_cold_then_warm": (
                  after["status"] == 200
                  and after["label"] == f"converged:{STREAM_ITERS_PER_SEGMENT}"
                  and after["survivor_warm_joins"][1] > after["survivor_warm_joins"][0]
                  and after["survivor_answered"]
                  > after["survivor_warm_joins"][1] - after["survivor_warm_joins"][0]),
              "replacement_same_slot": result["replacement_slot"] == doomed["slot"],
              "spill_served": (result["spill_from_replacement"]["label"] == "cache:exact"
                               and result["spill_from_replacement"]["bitwise"]),
              "exit_0": rc == 0}
    if not all(checks.values()):
        raise SystemExit(f"fleet: failed {[k for k, v in checks.items() if not v]}\n"
                         f"{(out_dir / 'fleet_stderr.txt').read_text()[-3000:]}")
    return result


def phase_streams(smi: str) -> dict:
    """Streams, the response cache and the fleet (see the module docstring,
    phase 9)."""
    import gc

    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    t_phase = time.perf_counter()
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    for knob in ("RAFT_CONVERGE_TOL", "RAFT_CACHE_DIR", "RAFT_CACHE_BYTES"):
        os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
    model = seeded_model("cuda")
    frames = _stream_frames(STREAM_FRAMES, seed=51)
    frames_b = _stream_frames(STREAM_FRAMES, seed=52)
    sess1 = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=STREAM_SEGMENTS, warmup_shapes=(KITTI,)))
    ph, pw = sess1.padder_for(frames[0][0].shape).padded_shape
    # (a) The stream through the StreamRunner, at the default tolerance and
    # at FORCED_TOL, every frame checked; then the rounds in turns.
    runs = {"default": _stream_run(sess1, model, frames, None),
            "forced": _stream_run(sess1, model, frames, FORCED_TOL)}
    launches = {kind: sess1.program_launches(kind, ph, pw, it)
                for kind, it in (("prepare", 0), ("prepare_warm", 0),
                                 ("advance", STREAM_ITERS_PER_SEGMENT), ("epilogue", 0))}
    rounds = _stream_rounds(sess1, frames)
    refs = {"frame1": sess1.infer(*_f32(frames[0])).disparity}
    # (b) The cache.
    cache = _cache_checks(sess1, frames, Path(__file__).resolve().parent.joinpath(
        *STREAMS_DIR, "spill"))
    # The service at max_batch 4: two streams among cold requests, and one
    # warm row in two batch compositions.
    sess4 = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=STREAM_SEGMENTS, max_batch=4, warmup_shapes=(KITTI,)))
    service = _service_streams(sess4, model, frames, frames_b)
    compositions = _warm_row_compositions(sess4, frames[3])
    launches_b4 = {kind: sess4.program_launches(kind, ph, pw, it, b=4)
                   for kind, it in (("prepare_warm", 0), ("advance", STREAM_ITERS_PER_SEGMENT))}
    fps = {k: statistics.median(r["frames_per_s"] for r in rounds
                                if (r["kind"], r["tol"]) == k)
           for k in (("cold", None), ("stream", None), ("stream", FORCED_TOL))}
    line = {"phase": "streams", "card": smi, "padded": [ph, pw],
            "frames": STREAM_FRAMES, "iters": ITERS, "segments": STREAM_SEGMENTS,
            "stream_default_tol": runs["default"], "stream_forced_tol": runs["forced"],
            "program_launches": launches, "program_launches_b4": launches_b4,
            "rounds": rounds,
            "frames_per_s": {"cold": fps[("cold", None)], "stream_default_tol":
                             fps[("stream", None)], "stream_forced_tol":
                             fps[("stream", FORCED_TOL)]},
            "service": service, "warm_row_b4": compositions, "cache": cache,
            "trips": [s.breaker.trip_count for s in (sess1, sess4)],
            "kernels_only": [s.breaker.kernels_only for s in (sess1, sess4)]}
    print(json.dumps(line, default=str))
    want_adv = {"fused_iter": STREAM_ITERS_PER_SEGMENT, "gru1632": STREAM_ITERS_PER_SEGMENT}
    if launches["prepare_warm"] != ENC_KITTI or launches["prepare"] != ENC_KITTI \
            or launches["advance"] != want_adv:
        raise SystemExit(f"streams: captured launches {launches}")
    if launches_b4["prepare_warm"] != {k: 4 * n for k, n in ENC_KITTI.items()} \
            or launches_b4["advance"] != want_adv:
        raise SystemExit(f"streams: captured launches at b=4 {launches_b4}")
    if any(line["trips"]) or not all(line["kernels_only"]):
        raise SystemExit(f"streams: breaker trips on a clean path: {line['trips']}")
    del sess1, sess4
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent.joinpath(*STREAMS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    pth = out_dir / "model.pth"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, pth)
    video = _demo_video(pth, frames)
    print(json.dumps({"phase": "demo_video", "card": smi, **video}))
    gc.collect()
    torch.cuda.empty_cache()
    # (c) The fleet, its instances beside nothing else of this process's on
    # the card but the model.
    fleet = phase_fleet(model, frames, refs)
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"phase": "streams_seconds", "seconds": seconds,
                      "fleet_seconds": fleet["seconds"]}))
    return {"streams": line, "demo_video": video, "fleet": fleet, "seconds": seconds}


def phase_cross_check() -> list:
    """The same seeded model at 128x256, 8 iterations, on the card and on
    the CPU (plain versions), with reg_cuda and with alt_cuda, and the
    realtime model (REALTIME) at RT_ITERS with reg_cuda. Band: mean |delta| within the serving canary's
    absolute floor, 0.05 px, and every pixel within 0.25 px. The canary
    band itself (rtol 5e-3, atol 5e-2 per pixel) is printed but not held:
    it was set for trained weights, whose updates shrink as the loop
    converges, while the seeded model keeps moving ~0.7 px an iteration, so
    one-ulp bf16 differences (cuDNN against oneDNN convs, the kernels
    against their plain versions) add up over the 8 iterations at a few
    pixels. 0.25 px stays 4x under the 1 px D1 threshold, the tightest
    metric the evaluators use."""
    import numpy as np

    from raft_stereo_tpu_torch.demo import infer_pair
    (left, right), = random_pairs(1, (128, 256), seed=8)
    results = []
    for corr, arch, iters in (("reg_cuda", {}, 8), ("alt_cuda", {}, 8),
                              ("reg_cuda", REALTIME, RT_ITERS)):
        out = {}
        for dev in ("cuda", "cpu"):
            model = seeded_model(dev, corr, **arch)
            out[dev] = infer_pair(model, left.to(dev), right.to(dev), iters=iters).float().cpu()
        d = (out["cuda"] - out["cpu"]).abs()
        in_canary = np.isclose(out["cuda"].numpy(), out["cpu"].numpy(), rtol=5e-3, atol=5e-2)
        mean_tol, max_tol = 0.05, 0.25
        ok = float(d.mean()) <= mean_tol and float(d.max()) <= max_tol
        result = {"phase": "cross_check", "corr": corr, "ok": ok,
                  "model": "realtime" if arch else "default", "iters": iters,
                  "mean_abs_diff": float(d.mean()), "max_abs_diff": float(d.max()),
                  "mean_tol": mean_tol, "max_tol": max_tol,
                  "canary_fraction": float(in_canary.mean()),
                  "disparity_abs_mean": float(out["cpu"].abs().mean())}
        print(json.dumps(result))
        if not ok:
            raise SystemExit(f"{corr}, {result['model']}: card and CPU disparities disagree "
                             "beyond the band")
        results.append(result)
    return results


# Phase 10, training. The reference's published command (its README):
# --batch_size 8 --train_iters 22 --spatial_scale -0.2 0.4 --saturation_range
# 0 1.4 --n_downsample 2 --mixed_precision, with reg_cuda, on 320x720 crops
# of a synthetic FlyingThings3D tree (540x960, 16 TRAIN and 2 TEST pairs,
# disparities 0-64 px) at full width.
TRAIN_TREE = dict(n_train=16, n_test=2, h=540, w=960, max_disp=64.0, seed=0)
TRAIN_CROP = (320, 720)
TRAIN_BATCH = 8
TRAIN_STEPS = 12
TRAIN_ITERS = 22
TRAIN_FLAGS = ["--batch_size", str(TRAIN_BATCH), "--train_iters", str(TRAIN_ITERS),
               "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0", "1.4",
               "--n_downsample", "2", "--mixed_precision", "--corr_implementation", "reg_cuda",
               "--image_size", *map(str, TRAIN_CROP), "--num_steps", str(TRAIN_STEPS),
               "--num_workers", "6"]
TRAIN_RESUME_AT = 6
# Resumed steps 7-12 against the uninterrupted run's: relative loss
# difference (the card's convolutions' backward is not bit-reproducible;
# the first card run read 2.1e-3).
RESUME_BAND = 1e-2
# Card kernel route against the CPU copy's plain route, per-leaf relative L2,
# the denominator floored at 1e-2 of the largest leaf's gradient norm
# (tests/test_torch_train.py's floor and bands: conv weights, 1-D leaves).
GRAD_BAND_MAT = 0.59
GRAD_BAND_VEC = 0.021
GRAD_SHAPE = (128, 256)
GRAD_ITERS = 4
TURN_STEPS = 2  # steps a turn, default against fused_train (1, f, f, 1)
# Device time of the profiled step by kernel group, first match wins (the
# rest "other": torch's elementwise, reduction, copy and index kernels).
TRAIN_GROUPS = (("convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "xmma",
                                 "sm90_xmma", "fprop", "bprop")),
                ("matmul", ("gemm", "Gemm", "cutlass")),
                ("corr_lookup", ("lookup",)),
                ("optimizer", ("adam", "Adam", "multi_tensor", "foreach")))
TRAIN_ARCH: dict = {}  # architecture overrides (a CPU rehearsal's tiny model)


def _sync() -> None:
    if CLI_DEVICE == "cuda":
        torch.cuda.synchronize()


def _train_batch(ds, b: int, seed: int, device) -> dict:
    """``b`` samples of the dataset, collated on ``device``."""
    import numpy as np

    from raft_stereo_tpu_torch.data.loader import collate
    rng = np.random.default_rng(seed)
    samples = [ds.__getitem__(i, rng=rng) for i in range(b)]
    return {k: torch.from_numpy(v).to(device) for k, v in collate(samples).items()}


def _train_dataset(tree: Path):
    from raft_stereo_tpu_torch import TrainConfig
    from raft_stereo_tpu_torch.data.datasets import fetch_dataset
    tcfg = TrainConfig(image_size=TRAIN_CROP, spatial_scale=(-0.2, 0.4),
                       saturation_range=(0.0, 1.4))
    return fetch_dataset(tcfg, root=str(tree))


def _grads_by_route(corr: str, b: int, fused_train: bool) -> dict:
    """The tempered seeded model's gradients at GRAD_SHAPE, GRAD_ITERS
    iterations, on the card (kernels) and on a CPU copy (plain versions),
    bf16, with the card's launches by kernel over the backward pass."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.engine.loss import sequence_loss
    g = torch.Generator().manual_seed(11)
    h, w = GRAD_SHAPE
    data = {"image1": torch.rand((b, h, w, 3), generator=g) * 255,
            "image2": torch.rand((b, h, w, 3), generator=g) * 255,
            "flow": -torch.rand((b, h, w, 1), generator=g) * 8,
            "valid": torch.ones((b, h, w))}
    out, launches = {}, None
    for key, dev in (("card", CLI_DEVICE), ("cpu", "cpu")):
        model = seeded_model(dev, corr)
        model.cfg.fused_train = fused_train
        model.train()
        kernels.reset_launches()
        preds = model(data["image1"].to(dev), data["image2"].to(dev), iters=GRAD_ITERS,
                      test_mode=False)
        loss, _ = sequence_loss(preds, data["flow"].to(dev), data["valid"].to(dev))
        loss.backward()
        _sync()
        if launches is None:
            launches = dict(kernels.launches)
        out[key] = {
            n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    floor = 1e-2 * max(float(t.norm()) for t in out["cpu"].values())
    rel = {n: float((out["card"][n] - ref).norm()) / max(float(ref.norm()), floor)
           for n, ref in out["cpu"].items()}
    mat = sorted((v, n) for n, v in rel.items() if out["cpu"][n].ndim > 1)[-3:]
    vec = sorted((v, n) for n, v in rel.items() if out["cpu"][n].ndim == 1)[-3:]
    zero = [n for n, t in out["card"].items() if not float(t.abs().max()) > 0]
    return {"corr": corr, "b": b, "fused_train": fused_train, "launches": launches,
            "worst_weights": mat, "worst_vectors": vec, "zero_leaves": zero}


def _steps_per_s(model, optimizer, batch: dict, steps: int) -> float:
    from raft_stereo_tpu_torch.engine.steps import make_train_step
    step = make_train_step(model, optimizer, TRAIN_ITERS)
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch)
    _sync()
    return steps / (time.perf_counter() - t0)


def _profile_step(step, batch: dict) -> dict:
    """One step warmed, three timed, one profiled: the profiled step's idle
    share of its own wall (the profiler's host cost included), its busy
    seconds over the timed steps' median wall, device ms by TRAIN_GROUPS
    and the "other" group's largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.obs.profiler import device_seconds
    step(batch)
    _sync()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(batch)
        _sync()
        walls.append(time.perf_counter() - t0)
    wall_plain = statistics.median(walls)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch)
        _sync()
    wall = time.perf_counter() - t0
    busy = device_seconds(prof)
    by_group = dict.fromkeys([g for g, _ in TRAIN_GROUPS] + ["other"], 0.0)
    other: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        group = next((g for g, parts in TRAIN_GROUPS if any(p in e.name for p in parts)),
                     "other")
        by_group[group] += ms
        if group == "other":
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + ms
    return {"wall_s": wall, "busy_s": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "unprofiled_wall_s": wall_plain, "unprofiled_walls_s": walls,
            "busy_over_unprofiled_wall": None if busy is None else busy / wall_plain,
            "device_ms_by_group": by_group,
            "other_top": sorted(other.items(), key=lambda kv: -kv[1])[:8]}


def _read_steps(log_dir: Path) -> list:
    return [json.loads(line) for line in (log_dir / "steps.jsonl").read_text().splitlines()]


def phase_train(smi: str) -> dict:
    """Training on the card (the module docstring, phase 10)."""
    import shutil

    from raft_stereo_tpu_torch import RAFTStereoConfig, TrainConfig, kernels
    from raft_stereo_tpu_torch.data.synthetic import write_things_tree
    from raft_stereo_tpu_torch.engine import checkpoint as ckpt
    from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
    from raft_stereo_tpu_torch.engine.steps import make_train_step
    from raft_stereo_tpu_torch.engine.train import train
    t_phase = time.perf_counter()
    for knob in SWITCHES + ENCODER_SWITCHES + ("RAFT_CORR_PACK8", "RAFT_LANE_PACK8"):
        os.environ.pop(knob, None)
    root = Path(__file__).resolve().parent / "build" / "phase_train"
    shutil.rmtree(root, ignore_errors=True)
    tree = Path(write_things_tree(str(root / "data"), **TRAIN_TREE))
    t_data = time.perf_counter() - t_phase

    # (1) The CLI with the published flags, in a subprocess.
    cli_dir = root / "cli"
    cli_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "raft_stereo_tpu_torch.train_stereo", *TRAIN_FLAGS,
         "--dataset_root", str(tree), "--device", CLI_DEVICE, *CLI_ARCH], cwd=cli_dir, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)), timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        raise SystemExit(f"train_stereo exited {proc.returncode}")
    cli_steps = _read_steps(cli_dir / "runs")
    cli_losses = [r["loss"] for r in cli_steps]
    # Wall time over steps 3-12 (the CLI's own step loop, cuDNN's TF32 at
    # torch's default, on), and its median wait for a batch.
    cli_wall = [r["wall_s"] for r in cli_steps]
    cli_rate = (len(cli_wall) - 2) / (cli_wall[-1] - cli_wall[1])
    cli_data_ms = statistics.median(r["data_ms"] for r in cli_steps[2:])
    if len(cli_losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in cli_losses):
        raise SystemExit(f"train_stereo's losses: {cli_losses}")
    if not (cli_dir / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}").exists():
        raise SystemExit("train_stereo wrote no final checkpoint")
    cli_ledger = json.loads((cli_dir / "runs" / "ledger.json").read_text())

    # (2) The same run in process, a bundle every 6 steps, validation there.
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda", mixed_precision=True, **TRAIN_ARCH)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, train_iters=TRAIN_ITERS,
                       spatial_scale=(-0.2, 0.4), saturation_range=(0.0, 1.4),
                       image_size=TRAIN_CROP,
                       num_steps=TRAIN_STEPS, ckpt_every=TRAIN_RESUME_AT, num_workers=6,
                       valid_iters=32, keep_ckpts=0)
    run_a = root / "run_a"
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_a = train(cfg, tcfg, data_root=str(tree), device=CLI_DEVICE, timing=True,
                  log_dir=str(run_a / "runs"), ckpt_dir=str(run_a / "checkpoints"))
    train_s = time.perf_counter() - t0
    launches_a = dict(kernels.launches)
    steps_a = _read_steps(run_a / "runs")
    ledger = json.loads((run_a / "runs" / "ledger.json").read_text())
    per_step = ledger["train_step_launches"]
    want = {"corr_lookup": 2 * TRAIN_ITERS}  # forward, and the checkpointed recompute
    if per_step != want:
        raise SystemExit(f"a train step's launches {per_step}, expected {want}")
    if any(launches_a.get(k, 0) for k in ("fused_iter", "gru1632", "motion")):
        raise SystemExit(f"loop kernels launched outside fused_train: {launches_a}")
    losses_a = [r["loss"] for r in steps_a]
    if not all(math.isfinite(v) for v in losses_a):
        raise SystemExit(f"non-finite losses: {losses_a}")
    row = ledger["rows"][0]
    peak = (row["argument_bytes"] + row["temp_bytes"]) if row["temp_bytes"] is not None else None
    times = steps_a[2:]
    # Wall time over steps 3-6 and 8-12: step 7 waits for the bundle and
    # the validation at step 6.
    ends = [r["wall_s"] for r in steps_a]
    k = TRAIN_RESUME_AT
    wall_rate = ((k - 2) + (TRAIN_STEPS - k - 1)) / ((ends[k - 1] - ends[1])
                                                     + (ends[-1] - ends[k]))
    fwd_bwd = statistics.median(r["fwd_bwd_ms"] for r in times)
    opt_ms = statistics.median(r["optimizer_ms"] for r in times)
    data_ms = statistics.median(r["data_ms"] for r in times)

    # (3) The final bundle against the periodic one of the same step, and a
    # save/load round trip of its state on the card, bit for bit.
    final = run_a / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}"
    periodic = run_a / "checkpoints" / f"{TRAIN_STEPS}_raft-stereo{ckpt.CKPT_SUFFIX}"
    fm, fo, fstep = ckpt.load_checkpoint(str(final))
    pm, po, pstep = ckpt.load_checkpoint(str(periodic))
    same = fstep == pstep == TRAIN_STEPS and all(torch.equal(fm[k], pm[k]) for k in fm)
    model = seeded_model(CLI_DEVICE)
    opt = make_optimizer(model, tcfg.lr, tcfg.num_steps, tcfg.wdecay,
                         skip_nonfinite=tcfg.max_bad_steps)
    ckpt.load_checkpoint(str(final), model, opt)
    again = root / f"again{ckpt.CKPT_SUFFIX}"
    ckpt.save_checkpoint(str(again), model, opt, fstep)
    am, ao, _ = ckpt.load_checkpoint(str(again))
    same = same and all(torch.equal(am[k], fm[k]) for k in fm) and (
        json.dumps(ao["schedule"], sort_keys=True) == json.dumps(fo["schedule"], sort_keys=True))
    if not same:
        raise SystemExit("the final bundle is not bit for bit the state that was saved")

    # (4) Resume: the bundles past step 6 removed, relaunched from the
    # directory; steps 7-12 against the uninterrupted run's.
    run_b = root / "run_b"
    shutil.copytree(run_a / "checkpoints", run_b / "checkpoints")
    for f in (run_b / "checkpoints").iterdir():
        if ckpt.bundle_step(str(f)) > TRAIN_RESUME_AT:
            f.unlink()
    res_b = train(cfg, TrainConfig(**{**tcfg.__dict__, "restore_ckpt": str(run_b / "checkpoints")}),
                  data_root=str(tree), device=CLI_DEVICE, validate=False,
                  log_dir=str(run_b / "runs"), ckpt_dir=str(run_b / "checkpoints"))
    steps_b = _read_steps(run_b / "runs")
    if [r["step"] for r in steps_b] != list(range(TRAIN_RESUME_AT, TRAIN_STEPS)):
        raise SystemExit(f"the relaunch ran steps {[r['step'] for r in steps_b]}")
    resume_rel = max(abs(b["loss"] - a["loss"]) / abs(a["loss"])
                     for a, b in zip(steps_a[TRAIN_RESUME_AT:], steps_b))
    if resume_rel > RESUME_BAND:
        raise SystemExit(f"resumed losses {resume_rel} (relative) from the uninterrupted run's")

    # (5) Gradients: the kernel routes on the card against the CPU copy.
    grads = [_grads_by_route("reg_cuda", 2, False), _grads_by_route("alt_cuda", 2, False),
             _grads_by_route("reg_cuda", 2, True), _grads_by_route("reg_cuda", 1, False)]
    for r in grads:
        ok = (r["worst_weights"][-1][0] <= GRAD_BAND_MAT
              and r["worst_vectors"][-1][0] <= GRAD_BAND_VEC and not r["zero_leaves"])
        route = "corr_alt" if r["corr"] == "alt_cuda" else "corr_lookup"
        need = [route] + (["conv_gru:gru08", "conv_gru:gru32", "gru1632", "motion"]
                          if r["fused_train"] else [])
        need += ["enc_stem", "enc_pass", "enc_point3", "enc_point2"] if r["b"] == 1 else []
        if "conv_gru:gru32" in need:
            need.remove("conv_gru:gru32")  # gru32 runs inside gru16+32
        if not ok or any(not r["launches"].get(k) for k in need) or r["launches"].get(
                "fused_iter"):
            print(json.dumps({"phase": "train_grads", **r}))
            raise SystemExit(f"gradients of {r['corr']} B={r['b']} fused_train="
                             f"{r['fused_train']}: out of band or a kernel not launched")

    # (6) The loss falls on one repeated batch; (7) a profiled step with
    # cuDNN's TF32 off and on; (8) fused_train against the default in turns.
    ds = _train_dataset(tree)
    batch = _train_batch(ds, 2, 5, CLI_DEVICE)
    batch["image1"], batch["image2"] = batch["image1"].bfloat16(), batch["image2"].bfloat16()
    model = seeded_model(CLI_DEVICE)
    model.train()
    opt = make_optimizer(model, 2e-4, 100)
    step = make_train_step(model, opt, TRAIN_ITERS)
    fall = [step(batch)["loss"] for _ in range(8)]
    if not statistics.mean(fall[-3:]) < fall[0]:
        raise SystemExit(f"the loss does not fall on a repeated batch: {fall}")
    big = _train_batch(ds, TRAIN_BATCH, 6, CLI_DEVICE)
    big["image1"], big["image2"] = big["image1"].bfloat16(), big["image2"].bfloat16()
    step8 = make_train_step(model, opt, TRAIN_ITERS)
    tf32 = torch.backends.cudnn.allow_tf32
    profiled = {}
    try:
        for key, on in (("tf32_off", False), ("tf32_on", True)):
            torch.backends.cudnn.allow_tf32 = on
            profiled[key] = _profile_step(step8, big)
        # The turns at the CLI's setting (cuDNN's TF32 on, torch's default).
        turns = []
        for fused in (False, True, True, False):
            model.cfg.fused_train = fused
            turns.append(("fused_train" if fused else "default",
                          _steps_per_s(model, opt, big, TURN_STEPS)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        model.cfg.fused_train = False
    line = {"phase": "train", "nvidia_smi": smi, "data_s": t_data,
            "cli": {"flags": TRAIN_FLAGS, "seconds": cli_s, "losses": cli_losses,
                    "step_launches": cli_ledger["train_step_launches"],
                    "steps_per_s_wall": cli_rate, "data_wait_ms": cli_data_ms},
            "in_process_s": train_s, "losses": losses_a,
            "in_process_tf32": torch.backends.cudnn.allow_tf32,
            "steps_per_s_wall": wall_rate,
            "steps_per_s_events": 1e3 / statistics.median(
                r["fwd_bwd_ms"] + r["optimizer_ms"] + r["data_ms"] for r in times),
            "step_ms": {"data_wait": data_ms, "forward_backward": fwd_bwd,
                        "optimizer": opt_ms},
            "peak_device_bytes": peak, "step_launches": per_step,
            "run_launches": launches_a, "validation": {k: v for k, v in res_a.items()
                                                       if k.startswith("things")},
            "resume": {"at": TRAIN_RESUME_AT, "max_rel_loss_diff": resume_rel,
                       "band": RESUME_BAND, "steps": res_b["step"]},
            "grads": [{k: r[k] for k in ("corr", "b", "fused_train", "worst_weights",
                                         "worst_vectors", "launches")} for r in grads],
            "loss_falls": fall,
            "profiled_steps": profiled,
            "steps_per_s_turns": turns, "seconds": time.perf_counter() - t_phase}
    print(json.dumps(line))
    return line


# The bench's runs: the headline default (Middlebury-F, 32 iterations) and the
# realtime model at the KITTI size.
BENCH_RUNS = {"headline": {"RAFT_BENCH_FRAMES": "3"},
              "realtime": {"RAFT_BENCH_H": "384", "RAFT_BENCH_W": "1248",
                           "RAFT_BENCH_ITERS": str(RT_ITERS), "RAFT_BENCH_FRAMES": "8",
                           "RAFT_BENCH_SHARED": "1", "RAFT_BENCH_DOWNSAMPLE": "3",
                           "RAFT_BENCH_GRU_LAYERS": "2", "RAFT_BENCH_SLOW_FAST": "1"}}


def _bench_pin(env: dict, doc: dict) -> dict:
    """The committed pin of a bench run's configuration, and whether both
    checksums of ``doc`` lie in its band (the bench's own rule)."""
    from raft_stereo_tpu_torch import RAFTStereoConfig, bench
    cfg = RAFTStereoConfig(
        corr_implementation="reg_cuda", mixed_precision=True,
        shared_backbone=env.get("RAFT_BENCH_SHARED") == "1",
        n_downsample=int(env.get("RAFT_BENCH_DOWNSAMPLE", "2")),
        n_gru_layers=int(env.get("RAFT_BENCH_GRU_LAYERS", "3")),
        slow_fast_gru=env.get("RAFT_BENCH_SLOW_FAST") == "1")
    key = bench.pin_key(cfg, int(env.get("RAFT_BENCH_H", "2016")),
                        int(env.get("RAFT_BENCH_W", "2976")),
                        int(env.get("RAFT_BENCH_ITERS", "32")), 1, "cuda")
    ref = json.loads(bench.PIN_PATH.read_text()).get(key)
    if ref is None:
        return {"pin": key, "pinned": False, "in_band": False}
    in_band = all(abs(doc[s] - ref[s]) <= max(abs(ref[s]) * ref["rtol"], ref["atol"])
                  for s in ("checksum", "sum_abs"))
    return {"pin": key, "pinned": True, "in_band": in_band}


def phase_bench() -> list:
    """``python -m raft_stereo_tpu_torch.bench`` in a subprocess, for each of
    BENCH_RUNS: it must exit 0 and print exactly one JSON line, with
    ``value`` > 0, finite checksums inside their committed pins (a bare run
    does not pin), ``device_s`` and ``flops`` present and ``mfu`` in (0, 1].
    Each line is printed again with ``"phase": "bench"``."""
    root = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    results = []
    for name, run in BENCH_RUNS.items():
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("RAFT_") and k != "PYTHONPATH"}
        env.update(run, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch.bench"],
                              cwd=root, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
        if proc.returncode != 0 or len(lines) != 1:
            raise SystemExit(f"bench {name}: exit {proc.returncode}, {len(lines)} JSON lines\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        doc = json.loads(lines[0])
        pin = _bench_pin(run, doc)
        checks = {"value": doc["value"] > 0,
                  "checksums_finite": all(math.isfinite(doc[s]) for s in ("checksum", "sum_abs")),
                  "checksums_pinned": pin["in_band"],
                  "device_s": bool(doc["device_s"]), "flops": bool(doc["flops"]),
                  "mfu": doc["mfu"] is not None and 0 < doc["mfu"] <= 1}
        ok = all(checks.values())
        print(json.dumps({"phase": "bench", "run": name, "ok": ok, "seconds": seconds,
                          "env": run, **pin, "checks": checks, "line": doc}))
        if not ok:
            raise SystemExit(f"bench {name} failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
        results.append(doc)
    return results


# -- phase 11: two ranks sharing the card (--spatial_shard 2) ---------------------

PARALLEL_DIR = ("build", "chip_smoke_parallel")
PARALLEL_WAIT_S = 400
PARALLEL_SEED = 41
PARALLEL_BACKEND = "gloo"  # two ranks on one card: NCCL takes one rank a card
# A KITTI frame's launches on each rank of a 2-way space row: every GRU
# level's shard (48, 24 and 12 rows of 96, 48 and 24) reaches the spatial
# entries' halo of 8 rows, so each level runs its serial kernel over its
# extended rows; the lookup on the rank's rows; no resident iteration, no
# gru16+32 and no encoder kernel (the encoders run whole and plain).
PARALLEL_LAUNCHES = {"conv_gru:gru08": ITERS, "conv_gru:gru16": ITERS,
                     "conv_gru:gru32": ITERS, "motion": ITERS, "corr_lookup": ITERS}


def _parallel_batch():
    """GRAD_SHAPE, B=2; the top half of the height holds more valid
    pixels than the bottom, so the two height shards' counts differ."""
    g = torch.Generator().manual_seed(13)
    b, (h, w) = 2, GRAD_SHAPE
    u = torch.rand((b, h, w), generator=g)
    top = torch.arange(h)[None, :, None] < h // 2
    return {"image1": torch.rand((b, h, w, 3), generator=g) * 255,
            "image2": torch.rand((b, h, w, 3), generator=g) * 255,
            "flow": -torch.rand((b, h, w, 1), generator=g) * 8,
            "valid": torch.where(top, u > 0.1, u > 0.6).float()}


def _train_model():
    model = seeded_model("cuda")
    model.cfg.fused_train = True
    return model.train()


def _step_grads(step, model, batch: dict) -> tuple:
    """One train step: its host metrics and the gradients it took,
    unclipped, on the CPU."""
    host = step(batch)
    scale = 1.0 / max(host["grad_norm"], 1.0)
    return host, {n: p.grad.detach().float().cpu() / scale
                  for n, p in model.named_parameters() if p.grad is not None}


def _grad_bands(name: str, got: dict, ref: dict) -> dict:
    """Per-leaf relative L2 of ``got`` against ``ref`` in phase_train's
    bands (GRAD_BAND_MAT for weights, GRAD_BAND_VEC for vectors)."""
    floor = 1e-2 * max(float(t.norm()) for t in ref.values())
    if set(got) != set(ref):
        raise SystemExit(f"{name}: gradient leaves differ: {sorted(set(got) ^ set(ref))}")
    rel = {n: float((got[n] - r).norm()) / max(float(r.norm()), floor) for n, r in ref.items()}
    mat = max((v, n) for n, v in rel.items() if ref[n].ndim > 1)
    vec = max((v, n) for n, v in rel.items() if ref[n].ndim == 1)
    ok = mat[0] <= GRAD_BAND_MAT and vec[0] <= GRAD_BAND_VEC
    if not ok:
        raise SystemExit(f"{name}: gradients outside the bands: {mat}, {vec}")
    return {"worst_weight": mat, "worst_vector": vec}


def _spatial_entry_checks(space) -> list:
    """Each spatial entry on this rank's shard of the KITTI shapes against
    its plain version over the same extended rows (check_gru's and
    check_motion's tolerances); both ranks run them in the same order."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops.halo import HALO, extend_rows
    rows = []
    for level in ("gru08", "gru16", "gru32"):
        h, w = {"gru08": FEAT, "gru16": (FEAT[0] // 2, FEAT[1] // 2),
                "gru32": (FEAT[0] // 4, FEAT[1] // 4)}[level]
        parts = (128,) if level == "gru32" else (128, 128)
        head = level == "gru08"
        wts, hw, hst, _, xs = _gru_case(_gen(4), level, h, w, 128, parts, head)
        g = _gen(7)
        ctx = [_randn((1, h, w, 128), g, 0.3) for _ in range(3)]
        sl = space.rows(h)
        hst, xs, ctx = hst[:, sl], [x[:, sl] for x in xs], [c[:, sl] for c in ctx]
        gru = ConvGRU(128, sum(parts))  # _gru_case's weights (seed 2), for the bias fold
        init_weights(gru, torch.Generator().manual_seed(2))
        gru = gru.cuda()
        with torch.no_grad():
            czrq = stream.spatial_prepare_gru_context(space, gru, ctx, torch.bfloat16)
            got_h, got_dx = stream.fused_conv_gru_spatial(space, wts, hst, czrq, *xs, head=hw)
            he, top = extend_rows(hst, HALO, space)
            ref_h, ref_dx = stream.conv_gru_plain(
                wts, he, czrq, *[extend_rows(x, HALO, space)[0] for x in xs], head=hw)
        hl = hst.shape[1]
        ref_h = ref_h[:, top:top + hl]
        tol = 2.0 ** -5
        row = {"name": f"conv_gru_spatial:{level}{'+head' if head else ''}",
               "shard": f"1x{hl}x{w}x128 of {h} rows", "max_abs_err": _max_err(got_h, ref_h),
               "tol": tol}
        row["ok"] = row["max_abs_err"] <= tol
        if head:
            ref_dx = ref_dx[:, top:top + hl]
            dx_rms = float(ref_dx.square().mean().sqrt())
            row.update(max_abs_err_dx=_max_err(got_dx, ref_dx), tol_dx=tol * dx_rms)
            row["ok"] = row["ok"] and row["max_abs_err_dx"] <= row["tol_dx"]
        rows.append(row)
    h, w = FEAT
    enc = BasicMotionEncoder(36)
    init_weights(enc, torch.Generator().manual_seed(6))
    enc = enc.cuda()
    g = _gen(5)
    corr = _randn((1, h, w, 36), g)
    flow_x = _randn((1, h, w, 1), g, 4.0)
    flow = torch.cat([flow_x, torch.zeros_like(flow_x)], -1)
    sl = space.rows(h)
    corr, flow = corr[:, sl], flow[:, sl]
    with torch.no_grad():
        wts = stream.motion_weights(enc, torch.bfloat16)
        got = stream.fused_motion_spatial(space, wts, flow, corr)
        fe, top = extend_rows(flow, HALO, space)
        ref = stream.motion_plain(wts, fe, extend_rows(corr, HALO, space)[0])
    ref = ref[:, top:top + corr.shape[1]]
    scale = max(1.0, float(ref[..., :wts.cf].float().abs().max()))
    err = _max_err(got, ref)
    rows.append({"name": "motion_spatial", "shard": f"1x{corr.shape[1]}x{w} of {h} rows",
                 "max_abs_err": err, "tol": 2.0 ** -5 * scale,
                 "ok": err <= 2.0 ** -5 * scale and torch.equal(got[..., wts.cf:], flow)})
    torch.cuda.synchronize()
    return rows


def _parallel_rank(d: Path) -> int:
    """One rank of phase_parallel (``chip_smoke.py --parallel-rank DIR``,
    launched by it): the KITTI frame on a 2-way space row, its launches
    counted; the spatial entries against their plain versions; one
    data-parallel and one height-sharded train step. Writes
    ``DIR/rank<r>.pt``."""
    import torch.distributed as dist

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
    from raft_stereo_tpu_torch.engine.steps import make_eval_step, make_train_step
    from raft_stereo_tpu_torch.ops.padder import InputPadder
    from raft_stereo_tpu_torch.parallel import make_mesh, maybe_distributed_init, shard_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_distributed_init(backend=PARALLEL_BACKEND, device="cuda")
    rank = dist.get_rank()
    inp = torch.load(d / "inputs.pt", weights_only=True)
    space = make_mesh(1, 2)
    model = seeded_model("cuda")
    left, right = (t.cuda() for t in inp["pair"])
    padder = InputPadder(left.shape, divis_by=32)
    left, right = padder.pad(left, right)
    step = make_eval_step(model, ITERS, space)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(torch.cuda.current_device())}
    frame_ms, launches = [], []
    for _ in range(2):  # the first frame loads the kernels; both counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, up = step(left, right)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(kernels.launches))
    out.update(frame_ms=frame_ms, frame_launches=launches,
               frame_peak_bytes=torch.cuda.max_memory_allocated(),
               disparity=(-padder.unpad(up)[0, ..., 0]).float().cpu())
    # A third frame, profiled: this rank's device busy seconds, and its
    # halo exchanges' count and wall seconds (each starts with a copy to
    # host memory, which waits for the kernels queued before it).
    from raft_stereo_tpu_torch.obs.profiler import profile_device_seconds
    from raft_stereo_tpu_torch.parallel import comm
    exch = {"calls": 0, "s": 0.0}
    swap = comm.swap_with_neighbours

    def timed_swap(*a, **k):
        t = time.perf_counter()
        try:
            return swap(*a, **k)
        finally:
            exch["calls"] += 1
            exch["s"] += time.perf_counter() - t

    comm.swap_with_neighbours = timed_swap
    t0 = time.perf_counter()
    with torch.no_grad():
        busy = profile_device_seconds(lambda: step(left, right))
    comm.swap_with_neighbours = swap
    out["profiled_frame"] = {"wall_s": time.perf_counter() - t0, "busy_s": busy,
                             "exchanges": exch["calls"], "exchange_wall_s": exch["s"]}
    out["entries"] = _spatial_entry_checks(space)
    batch = {k: v.cuda() for k, v in inp["batch"].items()}
    for tag, grid in (("data", make_mesh(2, 1)), ("space", space)):
        model = _train_model()
        opt = make_optimizer(model, 2e-4, 100, 1e-5, skip_nonfinite=3)
        tstep = make_train_step(model, opt, GRAD_ITERS, grid=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        host, grads = _step_grads(tstep, model, shard_batch(batch, grid))
        torch.cuda.synchronize()
        out[f"step_{tag}"] = {"host": host, "launches": dict(kernels.launches),
                              "s": time.perf_counter() - t0,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "grads": grads if rank == 0 else None}
    torch.save(out, d / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel(smi: str) -> dict:
    """Two ranks sharing the card over gloo, ``--spatial_shard 2`` at full
    width (the default architecture, reg_cuda, bf16, the KITTI pair): the
    gathered disparity in the canary band (serve/guard.py) of the one-process
    forward with the encoders plain (the route a space row takes: they run
    whole and plain on every rank) and within the route band of the default
    forward; each rank's launches, exactly PARALLEL_LAUNCHES a frame; each
    spatial entry against its plain version on the same shard; one
    data-parallel (2, 1) and one height-sharded (1, 2) train step, each
    within phase_train's gradient bands of the one-process step on the same
    global batch (GRAD_SHAPE, B=2, fused_train). NCCL is not exercised: it
    takes one rank a card, and this machine has one."""
    import socket

    from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
    from raft_stereo_tpu_torch.engine.steps import make_train_step
    from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
    t_phase = time.perf_counter()
    d = Path(__file__).resolve().parent.joinpath(*PARALLEL_DIR)
    d.mkdir(parents=True, exist_ok=True)
    for stale in d.glob("rank*.pt"):
        stale.unlink()
    pair = random_pairs(1, KITTI, PARALLEL_SEED)[0]
    batch = _parallel_batch()
    torch.save({"pair": [t.cpu() for t in pair], "batch": batch}, d / "inputs.pt")
    # The one-process references, before the ranks start (their times are
    # then their own).
    from raft_stereo_tpu_torch.demo import infer_pair
    model = seeded_model("cuda")
    disp_default = infer_pair(model, *pair, iters=ITERS)
    disp_plain = _with_env({"RAFT_FUSED_ENCODERS": "0"},
                           lambda: infer_pair(model, *pair, iters=ITERS))
    model = _train_model()
    one = make_train_step(model, make_optimizer(model, 2e-4, 100, 1e-5, skip_nonfinite=3),
                          GRAD_ITERS)
    host_one, grads_one = _step_grads(one, model, {k: v.cuda() for k, v in batch.items()})
    del model, one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}", PROCESS_ID=str(rank),
                   NUM_PROCESSES="2")
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--parallel-rank", str(d)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    t_ranks = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PARALLEL_WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t_ranks
    for rank, (p, log) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"parallel rank {rank} exited {p.returncode}:\n{log[-4000:]}")
    res = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r in res:
        if r["backend"] != PARALLEL_BACKEND:
            raise SystemExit(f"rank {r['rank']} ran {r['backend']}, not {PARALLEL_BACKEND}")
        for i, counts in enumerate(r["frame_launches"]):
            if counts != PARALLEL_LAUNCHES:
                raise SystemExit(f"rank {r['rank']} frame {i}: launches {counts}, "
                                 f"expected {PARALLEL_LAUNCHES}")
        bad = [e for e in r["entries"] if not e["ok"]]
        if bad:
            raise SystemExit(f"rank {r['rank']}: spatial entries off their plain versions: "
                             f"{bad}")
        for tag in ("data", "space"):
            step = r[f"step_{tag}"]
            if not (step["host"]["applied"] == 1.0 and step["host"]["finite"] == 1.0):
                raise SystemExit(f"rank {r['rank']} {tag} step: {step['host']}")
            if tag == "space" and not all(step["launches"].get(k, 0) > 0 for k in (
                    "conv_gru:gru08", "conv_gru:gru16", "motion", "corr_lookup")):
                raise SystemExit(f"rank {r['rank']} space step launches: {step['launches']}")
    disp = res[0]["disparity"]
    if not torch.equal(disp, res[1]["disparity"]):
        raise SystemExit("the two ranks gathered different disparities")
    ref = disp_plain.float().cpu()
    d_abs = (disp - ref).abs()
    in_band = bool((d_abs <= CANARY_ATOL + CANARY_RTOL * ref.abs()).all())
    band = {"max_abs_diff": float(d_abs.max()), "mean_abs_diff": float(d_abs.mean()),
            "in_canary_band": in_band}
    if not in_band:
        raise SystemExit(f"sharded KITTI disparity outside the canary band of the "
                         f"one-process forward: {band}")
    default_band = _disparity_band("spatial_shard 2 vs default", "KITTI", disp,
                                   disp_default.float().cpu())
    steps = {tag: {"loss": res[0][f"step_{tag}"]["host"]["loss"],
                   "grad_norm": res[0][f"step_{tag}"]["host"]["grad_norm"],
                   **_grad_bands(f"{tag} step", res[0][f"step_{tag}"]["grads"], grads_one),
                   "launches": res[0][f"step_{tag}"]["launches"],
                   "s": [r[f"step_{tag}"]["s"] for r in res],
                   "peak_bytes": [r[f"step_{tag}"]["peak_bytes"] for r in res]}
             for tag in ("data", "space")}
    result = {"phase": "parallel", "nvidia_smi": smi, "backend": PARALLEL_BACKEND,
              "ranks": 2, "cards": torch.cuda.device_count(),
              "nccl": "not exercised: NCCL takes one rank a card, this machine has one",
              "kitti": "x".join(map(str, KITTI)), "iters": ITERS,
              "frame_ms": [r["frame_ms"] for r in res],
              "frame_launches_per_rank": res[0]["frame_launches"][-1],
              "frame_peak_bytes": [r["frame_peak_bytes"] for r in res],
              "profiled_frame": [r["profiled_frame"] for r in res],
              "vs_plain_encoders": band, "vs_default": default_band,
              "entries": res[0]["entries"] + res[1]["entries"],
              "one_process_step": {"loss": host_one["loss"], "grad_norm": host_one["grad_norm"]},
              "steps": steps, "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase}
    print(json.dumps(result, default=str))
    return result


# -- phase 12: pod serving -----------------------------------------------------------

# The mesh's devices: one card listed twice (the machine has one), so the two
# shards share its SMs and its stream.
MESH_DEVICES = ("cuda:0", "cuda:0")
MESH_BUCKETS = (2, 4)
MESH_PAIRS = 4
MESH_BACKOFF_MS = 50.0
MESH_ROUNDS = ("mesh", "one", "one", "mesh")  # rate rounds, in turns


def _rows_by_hand(sess, pairs, b: int, ph: int, pw: int) -> list:
    """``pairs`` through the session's b-row programs by hand (prepare, the
    segments' advances, epilogue), ``b`` at a time: the padded-off flows."""
    import numpy as np
    padder = sess.padder_for(pairs[0][0].shape)
    out = []
    for i in range(0, len(pairs), b):
        lp, rp = (np.ascontiguousarray(np.concatenate(x)) for x in zip(*(padder.pad_np(
            p[0].astype(np.float32), p[1].astype(np.float32)) for p in pairs[i:i + b])))
        (state,) = sess.invoke(sess.get_program("prepare", ph, pw, 0, b=b), lp, rp)
        adv = sess.get_program("advance", ph, pw, SERVER_ITERS_PER_TICK, b=b)
        for _ in range(SERVER_SEGMENTS):
            state, _, _ = sess.invoke(adv, state)
        flow_up, _ = sess.invoke(sess.get_program("epilogue", ph, pw, 0, b=b), state)
        out += [-padder.unpad_np(flow_up[j:j + 1])[0, ..., 0] for j in range(b)]
    return out


def _scheduled(sess, pairs) -> list:
    """``pairs`` through a continuous-batching scheduler driven on this
    thread, every pair uploaded before the first tick (so all join one
    batch): the disparities in pair order, each required ok and full."""
    from raft_stereo_tpu_torch.serve import BatchScheduler
    out = {}
    sched = BatchScheduler(sess, resolve=lambda rq, rs: out.__setitem__(rq["id"], rs))
    try:
        for i, p in enumerate(pairs):
            sched.submit(_request(i, p))
        for bucket in sched._buckets.values():
            for row in list(bucket.pending):
                row.uploaded.wait(timeout=600)
        while len(out) < len(pairs):
            if not sched.run_tick():
                time.sleep(0.001)
    finally:
        sched.shutdown()
    for i in range(len(pairs)):
        if out[i]["status"] != "ok" or out[i]["quality"] != "full":
            raise SystemExit(f"mesh: request {i} gave {out[i].get('status')} "
                             f"{out[i].get('code') or out[i].get('quality')}")
    return [out[i]["disparity"] for i in range(len(pairs))]


def _mesh_shards_checked(sess, ph: int, pw: int) -> dict:
    """Each mesh program's shards: a shard of k rows captured the launches of
    a one-device program of k rows (ENC_KITTI a row for the prepares; a
    fused_iter and a gru1632 an iteration for the advance; none for the
    epilogue)."""
    out = {}
    for b in MESH_BUCKETS:
        k = b // len(MESH_DEVICES)
        want = {"prepare": {n: k * c for n, c in ENC_KITTI.items()},
                "prepare_warm": {n: k * c for n, c in ENC_KITTI.items()},
                "advance": {"fused_iter": SERVER_ITERS_PER_TICK,
                            "gru1632": SERVER_ITERS_PER_TICK},
                "epilogue": {}}
        for kind, it in (("prepare", 0), ("prepare_warm", 0),
                         ("advance", SERVER_ITERS_PER_TICK), ("epilogue", 0)):
            shards = sess.program_shards(kind, ph, pw, it, b=b)
            if len(shards) != len(MESH_DEVICES) or any(s["launches"] != want[kind]
                                                       for s in shards):
                raise SystemExit(f"mesh: {kind} at b={b} shards captured {shards}, "
                                 f"expected {len(MESH_DEVICES)} x {want[kind]}")
            out[f"{kind}@b{b}"] = shards
    return out


def phase_mesh(smi: str) -> dict:
    """Pod serving (see the module docstring, phase 12)."""
    import gc

    import numpy as np

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                             StereoService)
    from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
    t_phase = time.perf_counter()
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
    model = seeded_model("cuda")
    pairs = _server_pairs(MESH_PAIRS, seed=43)
    os.environ["RAFT_HEAL_BACKOFF_MS"] = str(MESH_BACKOFF_MS)
    scfg = dict(valid_iters=ITERS, segments=SERVER_SEGMENTS, max_batch=4,
                warmup_shapes=(KITTI,))
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        mesh = InferenceSession(model, model.cfg, SessionConfig(mesh_data=2, **scfg),
                                mesh_devices=MESH_DEVICES)
        mesh_setup_s = time.perf_counter() - t0
        if tuple(mesh.batch_buckets) != MESH_BUCKETS or mesh.mesh_chips != 2:
            raise SystemExit(f"mesh: buckets {mesh.batch_buckets}, chips {mesh.mesh_chips}")
        ph, pw = mesh.padder_for(pairs[0][0].shape).padded_shape
        served = _scheduled(mesh, pairs)
        torch.cuda.synchronize()
        launches, variants = dict(kernels.launches), dict(kernels.variants)
        missing = [k for k in (*ENC_KITTI, "fused_iter", "gru1632") if not launches.get(k)]
        if missing:
            raise SystemExit(f"mesh: kernels never launched on the mesh path: {missing}")
        hand = _rows_by_hand(mesh, pairs, 4, ph, pw)
        shards = _mesh_shards_checked(mesh, ph, pw)
        t0 = time.perf_counter()
        hung = mesh.probe_chips()
        probe_s = time.perf_counter() - t0
        if hung:
            raise SystemExit(f"mesh: probes read healthy chips {list(hung)} as hung")
        t0 = time.perf_counter()
        one = InferenceSession(model, model.cfg, SessionConfig(batch_buckets=MESH_BUCKETS,
                                                               **scfg))
        one_setup_s = time.perf_counter() - t0
        one_b2 = _rows_by_hand(one, pairs, 2, ph, pw)
        one_b4 = _rows_by_hand(one, pairs, 4, ph, pw)
        rows = [{"bitwise_b2": torch.equal(torch.from_numpy(h), torch.from_numpy(r2)),
                 "served_bitwise": torch.equal(torch.from_numpy(sv), torch.from_numpy(h)),
                 "max_abs_diff_b4": float(np.abs(h - r4).max()),
                 "bitwise_b4": h.tobytes() == r4.tobytes(),
                 "in_band_b4": bool(np.allclose(h, r4, rtol=CANARY_RTOL, atol=CANARY_ATOL))}
                for h, r2, r4, sv in zip(hand, one_b2, one_b4, served)]
        # Quarantine chip 1: one chip wide under a new epoch, served.
        if not mesh.quarantine_chip(1) or mesh.mesh_chips != 1:
            raise SystemExit(f"mesh: quarantine left {mesh.mesh_status()}")
        t0 = time.perf_counter()
        shrunk = _scheduled(mesh, pairs)
        shrunk_s = time.perf_counter() - t0
        shrunk_rows = [{"bitwise_b4": s_.tobytes() == r4.tobytes(),
                        "in_band_b4": bool(np.allclose(s_, r4, rtol=CANARY_RTOL,
                                                       atol=CANARY_ATOL))}
                       for s_, r4 in zip(shrunk, one_b4)]
        time.sleep(2 * MESH_BACKOFF_MS / 1e3)
        t0 = time.perf_counter()
        healed = mesh.heal_mesh()
        heal_s = time.perf_counter() - t0
        compiles, warm = mesh.metrics()["compiles"], mesh.deck.status()["warm_records"]
        regrown = _scheduled(mesh, pairs)
        regrow = {"heal": healed, "heal_s": heal_s, "status": mesh.mesh_status(),
                  "bitwise_first": [a.tobytes() == b.tobytes()
                                    for a, b in zip(regrown, served)],
                  "new_compiles": mesh.metrics()["compiles"] - compiles,
                  "new_warm_records": mesh.deck.status()["warm_records"] - warm}
        svc = StereoService(mesh, ServiceConfig(max_queue=2 * SERVER_CLIENTS)).start()
        svc_one = StereoService(one, ServiceConfig(max_queue=2 * SERVER_CLIENTS)).start()
        try:
            rounds = [{"session": name, **_rate(svc if name == "mesh" else svc_one, pairs)}
                      for name in MESH_ROUNDS]
        finally:
            svc.stop()
            svc_one.stop()
        capture_s = [s_["capture_s"] for rows_ in _mesh_shards_checked(mesh, ph, pw).values()
                     for s_ in rows_]
        line = {"phase": "mesh", "card": smi, "devices": list(MESH_DEVICES),
                "buckets": list(mesh.batch_buckets), "padded": [ph, pw],
                "setup_s": {"mesh": mesh_setup_s, "one_device": one_setup_s},
                "launches": launches, "variants": variants, "rows": rows,
                "cross_width_pin": CROSS_WIDTH_PIN, "shard_launches": shards,
                "shard_capture_s": {"min": min(capture_s), "median":
                                    statistics.median(capture_s), "max": max(capture_s),
                                    "n": len(capture_s)},
                "probe_s": probe_s,
                "quarantine": {"rows": shrunk_rows, "served_s": shrunk_s},
                "regrow": regrow, "rate": rounds,
                "rate_ratio": (statistics.median(r["frames_per_s"] for r in rounds
                                                 if r["session"] == "mesh")
                               / statistics.median(r["frames_per_s"] for r in rounds
                                                   if r["session"] == "one")),
                "graph_pool_bytes": {name: sum(p["pool_bytes"] or 0.0 for p in s_.programs())
                                     for name, s_ in (("mesh", mesh), ("one", one))},
                "trips": [s_.breaker.trip_count for s_ in (mesh, one)],
                "seconds": time.perf_counter() - t_phase}
        print(json.dumps(line, default=str))
    finally:
        os.environ.pop("RAFT_HEAL_BACKOFF_MS", None)
    if not all(r["bitwise_b2"] and r["served_bitwise"] for r in rows):
        raise SystemExit(f"mesh: rows not bit for bit a one-device session's at b=2: {rows}")
    if not all(r["bitwise_b4"] if CROSS_WIDTH_PIN == "bitwise" else r["in_band_b4"]
               for r in rows + shrunk_rows):
        raise SystemExit(f"mesh: rows against b=4 break the {CROSS_WIDTH_PIN} pin: "
                         f"{rows} {shrunk_rows}")
    if healed["readmitted"] != [1] or regrow["status"]["n_data"] != 2:
        raise SystemExit(f"mesh: chip 1 not re-admitted: {regrow}")
    if not all(regrow["bitwise_first"]) or regrow["new_compiles"] or \
            regrow["new_warm_records"]:
        raise SystemExit(f"mesh: the re-grown mesh is not the first one: {regrow}")
    if any(line["trips"]):
        raise SystemExit(f"mesh: breaker trips on a clean path: {line['trips']}")
    del mesh, one, svc, svc_one
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_analysis(smi: str) -> dict:
    """Phase 13: the analysis suites on the card. The AST and concurrency
    stages over the port (exit 0 required: no finding, the port's
    LOCK_ORDER.md as the tree gives it), then the headline trace registry:
    every entry, the nine ladder programs and the six knob flips recorded on
    the card, with zero unsuppressed findings; the ladder's programs
    pairwise distinct by kernel and variant, the last (every rung tripped,
    fused_update too) launching no hand-written kernel. Prints one
    ``"phase": "analysis"`` line: the entries recorded, each ladder
    program's kernel launches by kernel, each knob flip's verdict, the
    suppressions and their reasons, the seconds."""
    from raft_stereo_tpu_torch.analysis.cli import main as analysis_main
    from raft_stereo_tpu_torch.analysis.trace import (TraceContext, default_registry,
                                                      run_trace_analysis)
    from raft_stereo_tpu_torch.analysis.trace.registry import GEOMETRIES
    t0 = time.perf_counter()
    rc = analysis_main(["--concurrency"])
    ast_s = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"analysis: the AST and concurrency stages over the port exited "
                         f"{rc}")
    t1 = time.perf_counter()
    registry = default_registry("headline")
    ctx = TraceContext(registry)
    report = run_trace_analysis(registry, context=ctx)
    trace_s = time.perf_counter() - t1
    ladder = [{"rung": label, "program": e.name,
               "launches": ctx.recording(e).launches() if ctx.recording(e) else None,
               "by_variant": ctx.recording(e).launches(variants=True)
               if ctx.recording(e) else None}
              for label, e in registry.ladder_variants]
    launch_sets = [tuple(sorted((r["by_variant"] or {}).items())) for r in ladder]
    knobs = [{"knob": kf.knob, "flip": kf.flip_value,
              "program_changed": ctx.text(kf.base) != ctx.text(kf.flipped),
              "key_changed": kf.base_key != kf.flipped_key} for kf in registry.knob_flips]
    for k in knobs:
        k["verdict"] = "changed" if k["program_changed"] else "unchanged"
    line = {"phase": "analysis", "nvidia_smi": smi, "geometry": registry.geometry,
            "probe_iters": GEOMETRIES["headline"]["probe_iters"], "ast_exit": rc,
            "ast_s": ast_s,
            "entries": sorted(ctx.recorded()), "entries_recorded": ctx.entries_traced,
            "entries_declared": len(registry.all_entries()),
            "ladder": ladder, "ladder_pairwise_distinct_launches":
                len(set(launch_sets)) == len(launch_sets),
            "knobs": knobs,
            "findings": [f.render() for f in report.findings],
            "suppressed": [{"code": f.code, "context": f.path, "reason": f.suppress_reason}
                           for f in report.suppressed],
            "table": [{"code": c, "context": k, "reason": r}
                      for (c, k), r in sorted(registry.suppressions.items())],
            "trace_s": trace_s, "seconds": time.perf_counter() - t0}
    print(json.dumps(line))
    if report.findings or ctx.entries_traced != len(registry.all_entries()):
        raise SystemExit(f"analysis: {len(report.findings)} unsuppressed finding(s) at "
                         f"headline: {line['findings']}")
    if len(ladder) != 9 or len(knobs) != 6:
        raise SystemExit(f"analysis: {len(ladder)} ladder programs, {len(knobs)} knob flips")
    if len(set(launch_sets)) != len(launch_sets) or launch_sets[-1] != ():
        raise SystemExit(f"analysis: the ladder's programs are not pairwise distinct, or the "
                         f"fully tripped one launches kernels: {launch_sets}")
    del registry, ctx
    torch.cuda.empty_cache()
    return line



# -- phase 14: the lock witness -----------------------------------------------

WITNESS_DEVICE = "cuda:0"
WITNESS_PAIRS = 16  # ordinary KITTI pairs, the first served alone
WITNESS_CLIENTS = 4
WITNESS_STREAM_FRAMES = 4
WITNESS_HTTP = 3
WITNESS_TRIP_SHAPE = (352, 1216)  # a second padded shape: its first build fails
WITNESS_AFTER_TRIP = 2  # KITTI requests served on the serial loop kernels
WITNESS_WAIT_S = 600
#: The least number of distinct observed lock edges phase 14 must map to
#: declarations, so that an empty witness cannot pass: its first reading on
#: an H100 was 33 (PERF.md), less a margin for the interleavings.
WITNESS_MIN_MAPPED = 28


def _witness_stack(model, device):
    """Phase 14's serving stack: a session (batch buckets 1 and 2, KITTI
    warm-up, a fake clock, an empty fault plan the phase swaps), the
    service above it with the response cache, no monitor thread (the phase
    sweeps the supervisor itself)."""
    from raft_stereo_tpu_torch.faults import ChaosPlan, FakeClock
    from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                             StereoService)
    sess = InferenceSession(model, model.cfg, SessionConfig(
        valid_iters=ITERS, segments=SERVER_SEGMENTS, max_batch=2, warmup_shapes=(KITTI,)),
        device=device, fault_plan=ChaosPlan(), clock=FakeClock())
    svc = StereoService(sess, ServiceConfig(max_queue=64, supervise=False, retry_budget=2,
                                            cache_bytes=256 << 20)).start()
    return sess, svc


def _ok(name: str, r: dict) -> dict:
    if r.get("status") != "ok":
        raise SystemExit(f"lock witness: {name} gave {r.get('status')} "
                         f"{r.get('code')}: {r.get('message')}")
    return r


def _witness_storm(sess, svc, port: int) -> dict:
    """The storm of phase 14 on a built stack (see the module docstring);
    returns the first response, the requests made, the trips and the
    serial loop's launches after the trip."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.faults import ChaosPlan, malformed_pairs
    from raft_stereo_tpu_torch.serve import Supervisor, wire
    pairs = _server_pairs(WITNESS_PAIRS, seed=41)
    frames = _stream_frames(WITNESS_STREAM_FRAMES, seed=43)
    first = _ok("first", svc.submit(_request("first", pairs[0])).result(timeout=600))
    made = 1

    def call(req):
        return req["id"], svc.submit(req).result(timeout=600)

    def stream():
        out = []
        for k, f in enumerate(frames):
            left, right = _f32(f)
            out.append(call({"id": f"stream-{k}", "left": left, "right": right,
                             "stream": "S"}))
        return out

    def http(i):
        ct, payload = _png_request(pairs[i], f"http-{i}")
        status, body = _fleet_http(port, "/v1/stereo", payload, {"Content-Type": ct})
        if status != 200:
            return f"http-{i}", {"status": "http", "code": status, "message": body[:200]}
        return f"http-{i}", wire.decode_response(body)

    bad = malformed_pairs(h=KITTI[0], w=KITTI[1])
    jobs = [lambda i=i: call(_request(f"pair-{i}", pairs[i])) for i in range(1, WITNESS_PAIRS)]
    jobs += [lambda: call(_request("hit", pairs[0]))]
    jobs += [lambda n=n: call({"id": f"bad-{n}", "left": bad[n][0], "right": bad[n][1]})
             for n in ("nan_pixels", "five_channel", "zero_area", "mismatched_shapes")]
    jobs += [lambda i=i: http(i) for i in range(1, 1 + WITNESS_HTTP)]
    with ThreadPoolExecutor(max_workers=WITNESS_CLIENTS) as ex:
        warm = ex.submit(stream)
        resps = dict(ex.map(lambda job: job(), jobs))
        resps.update(warm.result())
    made += len(resps)
    health = _fleet_http(port, "/healthz")[0]
    for rid, r in resps.items():
        if r.get("status") not in ("ok", "rejected", "error"):
            raise SystemExit(f"lock witness: {rid} unstructured: {r}")
        if not rid.startswith("bad-"):
            _ok(rid, r)
    if any(resps[f"bad-{n}"]["status"] != "rejected" for n in
           ("nan_pixels", "five_channel", "zero_area", "mismatched_shapes")):
        raise SystemExit(f"lock witness: a malformed request was served: "
                         f"{ {k: v['status'] for k, v in resps.items() if k.startswith('bad-')} }")
    if resps["hit"]["quality"] != "cache:exact" or \
            resps["hit"]["disparity"].tobytes() != first["disparity"].tobytes():
        raise SystemExit(f"lock witness: the repeat of the first pair: {resps['hit']['quality']}")
    # An injected build failure at the next build (a new padded shape's
    # first program) that the breaker attributes to fuse_iter.
    sess.faults.plan = ChaosPlan(compile_errors={sess.faults.builds: "mosaic:fuse_iter"})
    rng = np.random.default_rng(47)
    trip_pair = tuple(rng.uniform(0, 255, (*WITNESS_TRIP_SHAPE, 3)).astype(np.float32)
                      for _ in range(2))
    kernels.reset_launches()
    tripped = _ok("trip", svc.submit({"id": "trip", "left": trip_pair[0],
                                      "right": trip_pair[1]}).result(timeout=600))
    after = [_ok(f"after-{i}", svc.submit(_request(f"after-{i}", pairs[i])).result(timeout=600))
             for i in range(WITNESS_AFTER_TRIP)]
    serial = dict(kernels.launches)
    made += 1 + len(after)
    # An injected hang at the next invocation: the supervisor's sweep sees
    # it overdue on the fake clock and bounces the generation; the request
    # re-admits and is served.
    sess.faults.plan = ChaosPlan(hang_invokes={sess.faults.invokes: 500.0}, hang_cap_s=120.0)
    victim = svc.submit(_request("hang", pairs[-1]))
    if not sess.faults.wait_hang_entered(1, timeout=300):
        raise SystemExit("lock witness: the injected hang never parked")
    bounced = [t.kind for t in Supervisor(svc, watchdog_s=5.0).check_now()]
    hung = _ok("hang", victim.result(timeout=600))
    made += 1
    return {"first": first, "requests": made, "health": health,
            "tripped": list(sess.breaker.tripped_names), "trip_quality": tripped["quality"],
            "serial_launches": serial, "bounced": bounced, "hang_retries": hung.get("retries"),
            "supervision": svc.supervision_status()}


def _lock_witness_child(d: Path) -> int:
    """Phase 14's child (``chip_smoke.py --lock-witness DIR``): the witness
    armed before the serving modules load, the storm under it; writes
    ``result.json`` and the first response's disparity (``first.npy``)."""
    import numpy as np

    from raft_stereo_tpu_torch.analysis.concurrency.witness import (LockWitness,
                                                                    package_model,
                                                                    unexplained_edges)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    static = package_model()
    with LockWitness() as witness:
        adopted = witness.adopt_module_locks(static)
        from raft_stereo_tpu_torch.serve.http import HttpConfig, HttpFrontend
        model = seeded_model(WITNESS_DEVICE)
        sess, svc = _witness_stack(model, WITNESS_DEVICE)
        front = HttpFrontend(svc, HttpConfig(port=0)).start()
        build_s = time.perf_counter() - t0
        try:
            storm = _witness_storm(sess, svc, front.port)
        finally:
            front.stop()
            svc.stop()
        module_locks = witness.module_locks_seen(static)
    mapped = sorted({(a.key, b.key) for a, b in ((static.decl_at(*s_), static.decl_at(*d_))
                                                 for s_, d_ in witness.edges)
                     if a is not None and b is not None and a.key != b.key})
    np.save(d / "first.npy", storm.pop("first")["disparity"])
    result = {**storm, "edges_observed": len(witness.edges), "edges_mapped": len(mapped),
              "mapped": mapped, "unexplained": unexplained_edges(witness, static),
              "adopted": adopted, "module_locks_seen": module_locks, "build_s": build_s,
              "seconds": time.perf_counter() - t0}
    (d / "result.json").write_text(json.dumps(result))
    return 0


def phase_lock_witness(smi: str) -> dict:
    """Phase 14 (see the module docstring): the child's storm under the
    witness, then its first request again on a session built without it."""
    import gc
    import shutil

    import numpy as np
    d = Path(__file__).resolve().parent / "build" / "phase_lock_witness"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for knob in SWITCHES + ENCODER_SWITCHES:
        os.environ.pop(knob, None)
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lock-witness",
                            str(d)], capture_output=True, text=True, timeout=WITNESS_WAIT_S)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise SystemExit(f"lock witness: the child exited {child.returncode}:\n"
                         f"{child.stdout[-3000:]}\n{child.stderr[-6000:]}")
    res = json.loads((d / "result.json").read_text())
    gc.collect()
    torch.cuda.empty_cache()
    model = seeded_model(WITNESS_DEVICE)
    sess, svc = _witness_stack(model, WITNESS_DEVICE)
    try:
        plain = _ok("first", svc.submit(_request("first", _server_pairs(1, seed=41)[0]))
                    .result(timeout=600))
    finally:
        svc.stop()
    first = np.load(d / "first.npy")
    line = {"phase": "lock_witness", "card": smi, "requests": res["requests"],
            "clients": WITNESS_CLIENTS, "trips": res["tripped"],
            "trip_quality": res["trip_quality"], "bounced": res["bounced"],
            "hang_retries": res["hang_retries"],
            "serial_launches": {k: v for k, v in res["serial_launches"].items()
                                if k in ("corr_lookup", "motion", "fused_iter")
                                or k.startswith("conv_gru")},
            "edges_observed": res["edges_observed"], "edges_mapped": res["edges_mapped"],
            "unexplained": res["unexplained"], "min_mapped": WITNESS_MIN_MAPPED,
            "adopted": res["adopted"], "module_locks_seen": res["module_locks_seen"],
            "mapped": res["mapped"],
            "first_bitwise_without_witness": plain["disparity"].tobytes() == first.tobytes(),
            "child_build_s": res["build_s"], "child_s": res["seconds"],
            "child_wall_s": child_s, "seconds": time.perf_counter() - t0}
    print(json.dumps(line))
    if res["unexplained"]:
        raise SystemExit(f"lock witness: edges outside the static graph: {res['unexplained']}")
    if res["edges_mapped"] < WITNESS_MIN_MAPPED:
        raise SystemExit(f"lock witness: {res['edges_mapped']} mapped edges, fewer than "
                         f"{WITNESS_MIN_MAPPED}")
    if not line["first_bitwise_without_witness"]:
        raise SystemExit("lock witness: the first response differs from the same request "
                         "served without the witness")
    if res["tripped"] != ["fuse_iter"] or res["bounced"] != ["device_hang"] or \
            res["supervision"]["restarts"] != {"device_hang": 1}:
        raise SystemExit(f"lock witness: trips {res['tripped']}, bounces {res['bounced']}, "
                         f"restarts {res['supervision']['restarts']}")
    launched = res["serial_launches"]
    if not (launched.get("corr_lookup") and launched.get("motion")
            and launched.get("conv_gru:gru08")) or launched.get("fused_iter"):
        raise SystemExit(f"lock witness: after the trip the serial loop kernels did not run "
                         f"alone: {launched}")
    if not all(res["module_locks_seen"].values()):
        raise SystemExit(f"lock witness: module locks unseen: {res['module_locks_seen']}")
    if res["health"] != 200:
        raise SystemExit(f"lock witness: /healthz gave {res['health']}")
    del sess, svc, model
    gc.collect()
    torch.cuda.empty_cache()
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import raft_stereo_tpu_torch  # noqa: F401  (fails when run without the repo)
    if sys.argv[1:2] == ["--parallel-rank"]:
        return _parallel_rank(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--overread-route"]:
        return _overread_route(sys.argv[2])
    if sys.argv[1:2] == ["--lock-witness"]:
        return _lock_witness_child(Path(sys.argv[2]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()["nvidia_smi"]
    phase_build()
    results, chain_run = phase_kernels()
    main_path = {**phase_main_path(), "resblock_q8": chain_run}
    phase_session(smi)
    phase_cross_check()
    phase_bench()
    phase_server(smi)
    phase_streams(smi)
    phase_train(smi)
    parallel = phase_parallel(smi)
    mesh = phase_mesh(smi)
    phase_analysis(smi)
    phase_lock_witness(smi)
    line = []
    for r in results:
        if "on_path" in r and r["on_path"] is None:
            continue  # an encoder check at a shape no path gives the kernel
        if "variant" in r:
            # Its launches in this variant on the path that gives it this
            # shape.
            run, key, counter = main_path[r["on_path"]], "variants", r["variant"]
        else:
            path = r.get("on_path") or (
                "default" if r["counter"] in main_path["default"]["launches"] else "serial")
            run, key, counter = main_path[path], "launches", r["counter"]
        line.append({"name": r["name"], "route": r["route"], "source": r["source"],
                     "replaces": r["replaces"], "path": run["path"], "frames": run["frames"],
                     "launches": run[key].get(counter, 0),
                     "launches_per_frame": run[f"{key}_per_frame"][0].get(counter, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "kernel_ms": r.get("kernel_ms"),
                     "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
                     "serial_ms": r.get("serial_ms"), "bf16_ms": r.get("bf16_ms"),
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "library_note": r["library_note"]})
        if "profiler_windows" in r:
            # Phase 3's launches a call, one count a profiler window taken.
            line[-1]["profiler_windows"] = r["profiler_windows"]
        if line[-1]["launches"] == 0:
            raise SystemExit(f"kernel {r['name']} was launched no time on its path")
        if "variant" not in r and "on_path" not in r:
            # Its launches on each rank of phase 11's 2-way space row: a
            # KITTI frame and a train step.
            line[-1]["spatial_shard_2_launches"] = {
                "frame": parallel["frame_launches_per_rank"].get(r["counter"], 0),
                "step": parallel["steps"]["space"]["launches"].get(r["counter"], 0)}
        # Its launches in each shard of phase 12's mesh programs, by
        # program and bucket (captured: a replay of the shard's graph makes
        # the same launches), by variant for an encoder row; only rows at
        # the default path's KITTI shapes.
        if r.get("on_path") in (None, "default"):
            key, name = (("variants", r["variant"]) if "variant" in r
                         else ("launches", r["counter"]))
            per_shard = {prog: [s_[key].get(name, 0) for s_ in shards_]
                         for prog, shards_ in mesh["shard_launches"].items()
                         if any(s_[key].get(name, 0) for s_ in shards_)}
            if per_shard:
                line[-1]["mesh_shard_launches"] = per_shard
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
