#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases; any failure exits non-zero:

1. build — compile every kernel of ``ray_tpu_torch/csrc`` with nvcc (one
   process per source, all at once); print the build seconds, the ptxas
   register/spill lines and warnings (a two-consumer forward, dq or dk/dv
   instantiation must have 168 registers, the budget its setmaxnreg split
   redistributes; a dq or dk/dv instantiation must not spill), the counts
   of TMA loads (UTMALDG), wgmma (HGMMA), mbarrier operations (SYNCS) and
   mma.sync (HMMA) in the SASS of each forward, dq and dk/dv
   instantiation (``cuobjdump``; each must have the first three and no
   HMMA), and the card's name and power limit;
1b. sm90 — the Hopper primitives of ``csrc/sm90.cuh`` against torch
   (``csrc/sm90_check.cu``), at D = 32, 64 and 128: a TMA tile load of a
   strided bshd view with rows past S, an SS and an RS wgmma; exact;
2. kernels — the flash-attention forward kernel against its plain version
   (``_reference_attention``) on the card in bf16, both layouts, causal on
   and off, at GPT-2 small shapes (B in {1, 4}, H=12, D=64, S in {128,
   1000, 1024}), at D=128 (H=32, S=2048), at D=32, at the training
   shape (B=16, S=1024, bshd), at GPT-2 XL's (B=16, H=25, S=1024, bshd)
   and at Llama-2's full context (B=1, H=32, S=4096, D=128, bshd); max abs
   errors beside their tolerances,
   each case's plan (q rows a block, ring slots), kernel / plain /
   library times (CUDA events after warm-up) and the kernel's bound; the
   host time of a launch's tensor-map encodes;
2b. backward kernels — the dq and dk/dv kernels against the plain
   backward (``_reference_attention_bwd``) on the same (o, lse, do), in
   bf16, both layouts, causal on and off, at the training shape (B=16,
   H=12, S=1024, D=64), GPT-2 XL's (B=16, H=25, S=1024, D=64), S=1000
   (ragged), D=128 (H=32, S=2048) and D=32 (H=4, S=100); the dq and dk/dv
   plans of each case (rows a block, ring
   slots), the largest |err| / tolerance per gradient, each kernel's
   time, their bound, the plain time and the library's
   (``scaled_dot_product_attention``'s backward, timed only: the whole
   backward, its gradient with respect to q alone and to k and v);
3. serve — GPT-2 124M (``GPT2_SMALL``, random weights from ``--seed``) in
   the port's ``Replica`` hosting ``Generator``: 4 requests through
   ``handle_request`` (prompts of 16, 127, 500 and 1000 tokens, 8 new
   tokens each) and one through ``handle_request_stream``; the kernel's
   launch count must equal ``n_layer`` x forwards; the first forward's
   logits with the kernel must match ``attention="dense"`` (plain);
4. train — GPT-2 124M with f32 master weights from ``--seed`` and
   ``torch.optim.AdamW(lr=3e-4, weight_decay=0.1)``, as ``bench.py``
   drives the JAX model: first the loss and gradients of every leaf at
   B=4, S=1024 with the kernels against ``attention="dense"``; then one
   warm-up step and 10 timed steps at B=16, S=1024 on one batch, whose
   losses must be finite and fall, with exactly ``n_layer`` launches of
   each kernel per step; ms per step, tokens/s, MFU and peak memory;
5. llama — Llama-2 7B (``LLAMA_7B``: 32 layers, E=4096, 32 heads of
   D=128, vocab 32000, max_seq 4096; random weights from ``--seed``, cast
   once by ``serving_params``) in the port's ``Replica`` hosting
   ``LlamaServer``: the logits of the uncached forward (the kernel,
   ``n_layer`` launches, each layer's output held against the plain
   version on the same q, k, v) against the dense cached branch of the
   same module at S=2048; greedy requests with prompts of 128 and 2000 tokens
   (32 new tokens each) and a seeded one at temperature 0.8, all through
   ``generate``, which must launch no kernel (its attention is the dense
   cached branch, as in the reference); per request the prefill ms (a
   one-token request), ms per decoded token and tokens/s, beside the
   decode step's memory bound; the uncached forward at S=2048 and 4096
   and a decode step, as issued and as device work (the decode step's
   from a profiler trace); peak memory;
6. moe — GPT-2 124M widths with 8 experts, top-2, capacity factor 1.5
   (``replace(GPT2_SMALL, moe_experts=8)``, random from ``--seed``): served
   through ``Replica`` hosting ``Generator`` (phase 3's four requests;
   ``n_layer`` launches a forward); loss and every leaf's gradient at B=4
   with the kernels against dense attention, the kernels' run repeated
   (bit for bit or not) and the share of token-choices routed otherwise
   in the dense run; 10 AdamW steps at B=16, S=1024 after a warm-up, with
   ``n_layer`` launches of each kernel per step and falling losses: ms
   per step, tokens/s, peak memory, each step's aux loss and share of
   token-choices dropped at capacity;
7. xl — GPT-2 XL (``GPT2_XL``: 48 layers, E=1600, 25 heads, 1.56B
   parameters, random from ``--seed``) with ``remat=True``: at B=1 the
   loss and every leaf's gradient against the same without remat, and
   with ``xent_chunks=8`` against the dense head; 3 timed AdamW steps at
   B=16, S=1024 after a warm-up with the dense head, then 3 with
   ``xent_chunks=8`` (launches 2 x 48 of the forward and 48 of each
   backward kernel per step; falling losses; peak memory below the
   card's): ms per step, tokens/s, MFU, peak memory; then one step at B=4
   without remat and its peak memory;
8. sp — sequence parallelism over ranks that share the card: each ring
   step's kernels on the chunks of q, k, v (B=16, H=12, S=1024, D=64,
   bf16, from ``--seed``) at sp = 2 and 4 against their plain versions
   (the diagonal step causal, an earlier one full, the backward with the
   whole attention's lse, o and delta); then, for 2 and then 4 ranks
   (``RankPool``: spawned processes on cuda:0 in one gloo group, since
   NCCL refuses two ranks on one card), ring and Ulysses attention,
   causal and not, on the ranks' chunks of those inputs, gathered and
   held against the single-rank kernels and the plain versions; at sp = 2
   GPT-2 124M's logits (B=4, S=1024) against the single-rank kernels'
   with phase 3's gate and its loss and every leaf's gradient with phase
   4's tolerances, for ring and Ulysses; and AdamW steps at B=16, S=1024
   (a warm-up, then 5 timed) for ring at sp = 2 and 4 and Ulysses at
   sp = 2: falling losses, the ranks' parameters equal bit for bit, the
   launches summed over the ranks (ring: n(n+1)/2 x n_layer of each
   kernel a step, the future chunks skipped; Ulysses: n x n_layer), ms
   per step, tokens/s, each rank's peak memory and its step split into
   device work and the transport's calls (CUDA events), with the host
   time blocked in them.  A rank that fails fails the phase.  Phases 2
   and 2b also run the ring's chunk shapes (S = 512, 256) and Ulysses'
   head groups (H = 6, 3) in the bhsd layout;
9. pp — pipeline parallelism over ranks that share the card (``RankPool``
   on cuda:0, one gloo group), each rank a stage of
   ``to_pipeline_params``'s tree cut by ``shard_params``: at pp = 2 (M = 4)
   and pp = 4 (M = 2, the replicated output) GPT-2 124M's logits (B=8,
   S=1024; each rank's rows, bit for bit or not), loss and every leaf's
   gradient (summed as the train step sums them; stage slices against
   their layers) against the single-rank kernels on the same rank; the MoE
   model (8 experts) at pp = 2, M = 4 against the single-rank model run
   microbatch by microbatch (the aux averaged over microbatches), with its
   routes replayed only where they part (the share printed); then AdamW
   steps at B=16, S=1024 (a warm-up, then 5 timed) at pp=2 M=4, pp=4 M=8,
   dp=2 x pp=2 M=4 and the MoE model at pp=2 M=4: losses finite, falling
   and the same on every rank, the stage leaves equal bit for bit across
   dp replicas and the others on every rank, the launches summed over the
   ranks (2 x n_layer x M of the forward a step and replica, the stage
   recomputed in the backward, and n_layer x M of each backward kernel),
   ms per step, tokens/s, each rank's peak memory beside the single-rank
   step's, its split into time with a transport call in flight by kind
   and without, hops and host-staged MB a step, and the schedule's bubble
   fraction.  Phases 2 and 2b also run the microbatch shapes (B = 4 and 2,
   bshd);
10. tp — tensor parallelism over ranks that share the card (``RankPool``
   on cuda:0, one gloo group), each rank its ``shard_params`` shard (its
   6 of 12 heads, FFN columns and vocabulary rows): at tp = 2 GPT-2 124M's
   logits (B=4, S=1024, gathered over tp) against the single-rank kernels'
   with phase 3's gate, its loss and every leaf's gradient (gathered over
   tp) with phase 4's tolerances; the MoE model (8 experts, the experts'
   hidden dim on tp) with phase 6's gates, the share of token-choices that
   differ between the tp ranks (must be 0) and against the single-rank
   run (replayed where routes part); then AdamW steps at B=16, S=1024 (a
   warm-up, then 5 timed) at tp=2, MoE tp=2, dp=2 x tp=2, tp=2 x sp=2
   (ring) and pp=2 x tp=2 M=4: losses finite, falling and the same on
   every rank, every leaf equal bit for bit on the ranks that hold it, the
   launches summed over the ranks (2 x n_layer of each kernel a step at
   tp=2), ms per step, tokens/s, each rank's peak memory beside the
   single-rank step's, its split into time with a transport call in
   flight by kind and without, and the MB it hands the transport a step
   by kind.  Phases 2 and 2b also run a tp rank's heads (H = 6 at B = 16,
   8, 4, bshd strided views of a (B, S, 1152) qkv buffer) and the tp x sp
   ring chunk (B=16, H=6, S=512, bhsd);
11. ep — the MoE (8 experts) across ranks that share the card
   (``RankPool`` on cuda:0, one gloo group), each rank its
   ``shard_params`` shard (on ep its 4 experts): at ep = 2, dp = 2, ring
   sp = 2 and ep = 2 x tp = 2 (B=4, S=1024) each rank's logits against
   the single-rank kernels' on the same global batch with phase 3's gate,
   the choices dropped at capacity in each layer summed over the ranks
   (must equal the single-rank run's: the capacity and slot positions
   count the global batch) and the share of token-choices that differ
   between the ranks that hold the same tokens (must be 0), the
   single-rank run replaying the ranks' choices where they part; at ep =
   2 and ep = 2 x tp = 2 also the loss and every leaf's gradient (gathered
   over ep and tp) with phase 6's gates; then AdamW steps (a warm-up, then
   5 timed) at B=16, S=1024 for ep = 2, dp = 2, ring sp = 2, ep = 2 x tp =
   2 and pp = 2 x ep = 2 (M = 4), and at B=8 for dp = 2 x ep = 2 (four
   such ranks at B=16 do not fit on the card), printed and held as phase
   10's.  Phases 2 and 2b also run a dp = 2 rank's shape (B=8, H=12,
   S=1024, bshd);
12. fsdp — every leaf's "embed" dim cut over ranks that share the card
   (``RankPool`` on cuda:0, one gloo group), gathered whole for its use
   and its cotangent reduce-scattered: at fsdp = 2 (B=4, S=1024) GPT-2
   124M's logits (each rank's rows) against the single-rank kernels' with
   phase 3's gate, its loss and every leaf's gradient (gathered over fsdp)
   with phase 4's tolerances, and the MoE's logits, dropped choices per
   layer (summed over the ranks; must equal the single-rank run's) and
   routes as phase 11 holds them; then AdamW steps at B=16, S=1024 (a
   warm-up, then the timed steps): GPT-2 XL with remat at fsdp = 2 (lr
   1e-4, 3 steps; each rank's peak must stay below phase 7's single-rank
   peak, and its MFU is printed), 124M and the MoE at fsdp = 2, and 124M at
   dp = 2 x fsdp = 2, fsdp = 2 x tp = 2 and pp = 2 x fsdp = 2 (M = 4), 5
   steps each, printed and held as phase 10's.  Phases 2 and 2b also run an
   XL fsdp = 2 rank's shape (B=8, H=25, S=1024, bshd);
13. moe pp — the MoE (8 experts, 12 layers) under pipeline parallelism with
   dp and with fsdp over four ranks that share the card (``RankPool`` on
   cuda:0, one gloo group), each rank its block of every global
   microbatch's rows as the reference groups them: at pp = 2 x dp = 2 and
   pp = 2 x fsdp = 2 (B=8, S=1024, M = 4) each rank's logits against the
   single-rank kernels run on each global microbatch alone with phase 3's
   gate, the choices dropped in each (microbatch, layer) summed over the
   ranks (must equal that run's) and the ranks' routes (that run replays
   them where they part); then AdamW steps at B=16, S=1024, M = 4 (a
   warm-up, then 5 timed) in both layouts, printed and held as phase 10's,
   with the schedule's bubble fraction;
14. rl — the RL learners and the MNIST CNN (``ray_tpu_torch/rllib``,
   ``models/mnist.py``) at the JAX package's widths on synthetic
   rollouts from ``--seed``: IMPALA with the Nature-CNN (32/64/64
   channels, dense 512, 84x84x4 uint8 frames, 6 actions, RMSprop at eps
   0.1) on a rollout of T = 64 x B = 32, PPO (MLP 64, 64; 512 rows,
   minibatch 512, 4 epochs), DQN (double Q, 64), SAC (256, 256 at
   HalfCheetah's 17 observation and 6 action dims, 256), BC (256) and the
   MNIST step (Adam 1e-3, B = 64 and 1024): each update on the card held
   against the port's CPU path on the same state, batch and noise (metrics
   and every leaf), then 5 timed updates after the two a profiler traces
   (the second counted): ms per update (IMPALA also frames/s and its f32 bound), device ms
   and kernel launches per update, peak memory, each loss finite and, for
   IMPALA, PPO, BC and MNIST, lower after the updates on the fixed batch;
   ``sample_action``'s frequencies over 10^5 draws within a chi-square
   bound of the softmax, ``sample_squashed``'s actions in [-1, 1] with
   logp the tanh-Gaussian density recomputed from the draws.  No flash
   kernel runs on this path;
15. runtime — the port's core runtime (``ray_tpu_torch.init``) on one
   node, the card as its chip resource (``"TPU"``, asked for with
   ``num_gpus=1``): ``cluster_resources()`` must count the card; a CPU
   task's worker must not see it (``CUDA_VISIBLE_DEVICES=""``); a GPU task
   returns a 67.1 MB bf16 CUDA tensor drawn from ``--seed``, twice (the
   first starts a worker), which ``get`` must return as a CPU tensor bit-equal
   to the same draw in the driver (get ms once ready, submit to value);
   ``put`` of a 67.1 MB f32 CUDA tensor, read by a GPU task, must give the
   driver's f64 sum; a GPU actor builds GPT-2 124M from phase 3's seed, its
   first forward's logits (S=500) must match phase 3's within phase 3's
   gate and its tokens for phase 3's four prompts must equal phase 3's
   ``Replica``'s, with ``n_layer`` forward-kernel launches a forward counted
   in its own process; after ``shutdown()`` no
   ``ray_tpu_torch.core.*_main`` process and no ``rtt_store`` segment may
   remain;
16. serve run — Serve on the port's runtime (``ray_tpu_torch.serve``:
   controller, router, HTTP proxy), under a session root of its own:
   ``serve.start()``, then ``serve.run`` of ``Generator`` (GPT-2 124M from
   ``--seed``, deployed by reference from this script's module, its
   replica on the card with ``ray_actor_options={"num_tpus": 1}``): the
   first request's logits (S=500) bit-equal to phase 3's, phase 3's four
   prompts through a ``DeploymentHandle`` and over HTTP with phase 3's
   tokens, one HTTP stream (``?stream=1``) yielding phase 3's new tokens
   in order, ms per request beside phase 3's, and ``n_layer`` launches a
   forward read in the replica's process; then, that deployment deleted,
   ``LlamaServer`` (Llama-2 7B) the same way: the uncached forward at
   phase 5's S=2048 tokens (last logits and every argmax bit-equal to
   phase 5's, ``n_layer`` launches), phase 5's greedy request at prompt
   128 (32 new tokens) through the handle and over HTTP with phase 5's
   tokens, prefill and per-token ms beside phase 5's; after
   ``serve.shutdown()`` and ``shutdown()`` nothing may remain, as in
   phase 15;
17. cluster — two nodes of the port's runtime
   (``ray_tpu_torch.cluster_utils.Cluster``: a GCS and a raylet per node
   as processes), under a session root of its own: a CPU head (2 CPUs)
   and a node with the card (``num_tpus=1``, the cluster's ``env`` naming
   the card; without it the cluster's processes keep it hidden); a GPU
   task on that node makes phase 15's 67.1 MB bf16 tensor, a CPU task
   pinned to the head (``NodeAffinitySchedulingStrategy``) pulls it across
   the nodes and returns its checksum, twice (the second read from the
   head's store): both checksums and the driver's ``get`` bit-equal to the
   draw, the pull's ms printed beside phase 15's same-node ``get``; after
   ``shutdown()`` nothing may remain, as in phase 15;
18. train run — Train on the port's runtime: GPT-2 124M at full width and
   depth trained by ``TorchTrainer`` with ``ScalingConfig(num_workers=1,
   use_tpu=True)``; the worker (``train_run_loop``, taking phase 4's
   ``train_setup``, seed and AdamW by reference from ``chip_smoke``) gets
   each step's batch of phase 4's token rows (B=16, S=1024) through a
   port ``Dataset`` (``from_numpy``), ``session.get_dataset_shard`` and
   ``iter_torch_batches`` staged onto the card, and reports each of 10
   steps (loss, the step's ms from CUDA events, the launches of each
   kernel counted in the worker, peak memory), with a checkpoint of the
   parameters and AdamW's state at step 5 (``Checkpoint.from_dict``: on
   the host, no card tensor): losses bit-equal to phase 4's first 10,
   finite and falling, ``n_layer`` launches of each kernel a step; a
   second ``fit`` resumed from that checkpoint in a new worker gives steps
   6-10's losses equal to the uninterrupted run's; two workers sharing the
   card (``{"CPU": 1, "TPU": 0.5}`` each, gloo) train dp = 2 at B = 8 each
   for 3 steps: the ranks' parameters bit-equal and the losses within
   ``TRAIN_LOSS_TOL`` of one worker's at B = 16; the worker's ms a step
   and peak memory printed beside phase 4's; after ``shutdown()`` nothing
   may remain, no results outside the temp dir included;
19. tune — Tune on the port's runtime (``ray_tpu_torch.tune``), in one
   ``init()`` with phase 20 under a session root of its own: a ``Tuner``
   sweeps a function trainable (``tune_trial``: phase 4's GPT-2 124M setup,
   seed and batch, B=16, S=1024, bf16 flash, AdamW) over a
   ``grid_search`` of 3 learning rates, phase 4's among them, each trial in an
   actor holding the card (``resources_per_trial={"CPU": 1, "TPU": 1}``,
   so one at a time) under ``ASHAScheduler(metric="loss", mode="min",
   max_t=4, grace_period=2, reduction_factor=2)``: the trial at phase 4's
   rate reports phase 4's losses bit for bit, each trial launched
   ``n_layer`` x its steps of each kernel, ASHA stopped at least one trial
   at its grace rung, ``get_best_result()`` is the lowest final loss of
   the trials that ran to ``max_t``, no trial errored; each trial's
   seconds to its first report and median ms a step (CUDA events) beside
   phase 4's; then ``Tuner(TorchTrainer(train_run_loop, ...))`` through
   ``as_trainable``, one worker on the card, one trial of 2 steps: its
   loss phase 4's step-2 loss bit for bit, 2 x ``n_layer`` launches of
   each kernel in the worker;
20. rllib — IMPALA's ``Algorithm`` in a Tune trial (``SmokeImpala``, a
   subclass of the port's ``Impala``, ``resources_per_trial={"CPU": 1,
   "TPU": 1}``, ``stop={"training_iteration": 3}``), its Nature-CNN
   learner on the card at phase 14's widths (T=64 x B=32 frames of
   84x84x4, 6 actions, RMSprop at eps 0.1), one rollout actor
   (``SmokeRunner``: ``EnvRunner.sample()``'s dict drawn from a numpy
   generator by call index, since the card's machine has no
   ``gymnasium``): every metric finite, ``num_env_steps_sampled`` = 3 x T
   x B, the trial's final weights from its checkpoint against the port's
   CPU learner replayed from the same initial weights over the same
   rollouts (phase 14's tolerances), the first update's metrics too, the
   flash kernels' launch counts unmoved; ms per iteration, the update's
   ms (CUDA events) and frames/s beside phase 14's update; after
   ``shutdown()`` nothing may remain, as in phase 18;
21. workflow, job — a port ``Cluster`` of one node with 2 CPUs and the card,
   under a session root of its own: a workflow (``ray_tpu_torch.workflow``)
   whose first step, a GPU task (``card_forward``, ``num_tpus=1``), builds
   GPT-2 124M from ``--seed`` and returns phase 3's first logits (S=500)
   with its launch count, and whose second step, on the CPU
   (``fail_first``), fails on its first attempt: the run fails with step
   1's checkpoint a CPU tensor bit-equal to phase 3's logits, and
   ``workflow.resume`` returns those logits bit-equal without running step
   1 again (its launch log gains nothing: 0 launches on resume); then a
   job submitted with ``JobSubmissionClient`` whose entrypoint
   (``job_main``) prints the cards it sees (0: its supervisor is a CPU
   worker, ``CUDA_VISIBLE_DEVICES=""``) and runs the same forward in a
   ``num_tpus=1`` task: the job must reach ``SUCCEEDED`` and its logs carry
   a digest equal to phase 3's; nothing may remain after ``shutdown()``;
22. autoscaler — an ``AutoscalingCluster`` under a session root of its own
   (a ``{"CPU": 1}`` head, one worker type ``{"CPU": 1, "TPU": 1}``,
   ``max_workers=1``, ``idle_timeout_s`` ``AUTOSCALE_IDLE_S``): a pending
   ``num_tpus=1`` task (``card_forward``) brings up the node, the
   dashboard's ``/api/cluster_resources`` and ``python -m
   ray_tpu_torch.scripts status`` both show ``"TPU": 1.0`` while it is up,
   the task's logits are phase 3's bit for bit with ``n_layer`` launches
   on that node, and the node is removed once idle for the timeout;
   scale-up and scale-down seconds; nothing may remain after
   ``shutdown()``.

Every timed run of phases 8-13 over two or four ranks trains
``FOUR_RANK_DEPTH`` (4) layers of GPT-2 124M's widths (or its MoE's),
GPT-2 XL at fsdp = 2 its 48 (its memory gate holds the whole model): ring
and Ulysses sp = 2, ring sp = 4, pp = 2 and 4, dp x pp, tp = 2, dp x tp,
tp x sp, pp x tp, fsdp = 2, dp x fsdp, fsdp x tp and pp x fsdp; the MoE
at pp = 2, tp = 2, ep = 2, dp = 2, ring sp = 2, fsdp = 2, dp x ep, ep x
tp, pp x ep, pp x dp and pp x fsdp.  Their batches, sequences, widths and
timed steps are as written above, and every check keeps its depth (the
12-layer checks' first four layers drop few choices or none at
``--seed`` 0: at 4 layers the drop gates would hold little).  Phases 8-13
share one pool of 2 ranks and one of 4 (``CardPool``), started once
("8-13 ranks up"); each rank releases its cached device memory after
every task.  Each phase's seconds are printed after it.

The forward kernel's launches are listed by path, the runtime's actor
(``runtime_actor``) and the Serve replicas (``serve_run_gpt2``,
``serve_run_llama``) among them; each kernel's also the Train workers'
(``train_run``, ``train_run_resumed``, ``train_run_dp2``) and Tune's
(``tune_trials``, summed over the trials, and ``tune_trainer``); the
forward's also phase 21's workflow step and job task (``workflow``,
``job``) and phase 22's autoscaled node (``autoscaler``).  The last two lines are a JSON object of
per-kernel numbers and the result line ``{"ok": true, "device":
{...}}``.  ``--profile`` adds ``torch.profiler`` tables of device time
by kernel for a forward at S=1024, a train step, a Llama forward at
S=2048, a Llama decode step, an MoE forward at S=1000 and train step, and
an XL train step with each head, each with the device's idle share over
the traced calls, and times the runtime put's copy to the host and its
serialize alone.

Precision: TF32 is off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), and bf16 GEMMs may not
reduce in reduced precision, so f32 matmuls (the plain attention, the lm
head) run in full f32 and bf16 GEMMs accumulate in f32, as the JAX model's
``preferred_element_type=f32`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch import collective
from ray_tpu_torch.collective import c10d
from ray_tpu_torch.models import gpt2, llama, mnist
from ray_tpu_torch.native import build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import ring_attention as ra
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.launch import RankPool
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.pipeline import schedule_info
from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                             gather_params, param_shardings,
                                             seq_shard, shard_params)
from ray_tpu_torch.rllib import bc, dqn, impala, optim, ppo, sac
from ray_tpu_torch.rllib import models as rl_models
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, DONES,
                                              LOGPS, NEXT_OBS, OBS, REWARDS,
                                              TARGETS, VALUES)
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.serve.replica import Replica

# H100 SXM, dense, at the full 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain, both on the card in bf16.  o: both round o to bf16
# (<= 2^-8 |o| apart), and the kernel rounds p to bf16 before p@v, which
# moves o by <= 2^-9 P@|v| (P@|v|, the plain attention over |v|, exceeds
# |o| where a row's terms cancel); each is held with 2x room, per element:
# |o - o_plain| <= O_RTOL |o_plain| + O_PTOL P@|v|.
O_RTOL = 1e-2
O_PTOL = 2.0 ** -8
# lse: both compute it in f32 from exact bf16 products; only the order of
# the sums and exp2 vs exp differ (~1e-6 relative on |lse| <= ~10).
LSE_TOL = 1e-3
# logits of the 124M model, kernel vs dense attention, bf16 activations:
# the two attention outputs differ by ~1 bf16 ulp per layer and the
# difference passes through 12 bf16 layers and a 768-wide head; logits
# have std ~0.5 at this init, so 0.1 is ~3% of the largest logits.
LOGITS_TOL = 0.1
# backward kernels vs the plain backward, both on the card, per element:
# |g - g_plain| <= G_RTOL |g_plain| + G_PTOL * M_g.  Both round g to bf16
# (<= 2^-8 |g| each, so 2^-7 apart; G_RTOL gives ~1.3x room).  The kernels
# round p to bf16 (<= 2^-8 relative) before p^T do, so dv moves by
# <= 2^-8 M_dv with M_dv = P^T |dO|; they round p and then ds to bf16
# (<= 2^-7 relative on ds) before ds k and ds^T q, so dq and dk move by
# <= 2^-7 M with M_dq = scale |dS| |K| and M_dk = scale |dS|^T |Q|, where
# |dS| = |P (dP - delta)| of the plain backward.  Each held with 2x room.
# dP and delta are f32 sums of D bf16 products in another order on each
# side (<= D 2^-24 of their sums of |terms| apart, 2^-17 at D = 128); where
# dP - delta vanishes (a causal first row: one key, dP = delta) that noise
# is all of ds, so |dS| also carries 2^-10 P (|dO| |V|^T + rowsum|dO o|),
# 2^-16 of it after G_PTOL.
G_RTOL = 1e-2
G_PTOL = {"dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 2.0 ** -7}
# full-width GPT-2 gradients, kernels vs dense attention (bf16 compute):
# the two attention forwards differ by ~1 bf16 ulp per layer and the
# kernels round p and ds to bf16 where the dense backward stays f32.  The
# first run on the card measured a loss difference of 4.8e-5 and a
# largest per-leaf gradient difference of 1.33e-2 (median 9.5e-3); each
# is held with ~4x room or more.
TRAIN_LOSS_TOL = 1e-3        # absolute, on a loss of ~11
TRAIN_GRAD_REL_TOL = 5e-2    # ||g - g_dense|| / ||g_dense|| per leaf
# GPT-2 124M with 8 experts, kernels vs dense attention at B=4 (bf16).  A
# token whose top-2 router probabilities lie within the two attentions'
# rounding of each other routes to another expert in one run, and that
# token's residual then differs by a whole expert's output, which moves
# further routes downstream: on the card 0.16% of token-choices in layer 0
# and 9.6% in layer 11 routed otherwise, and gradients parted by up to
# 0.49 per leaf (phase 6 prints the share).  So the dense run replays the
# kernels' run's expert choices (``pinned_routes``; the choices carry no
# gradient) and the two are held as phase 4 holds the dense FFN.
MOE_LOSS_TOL = TRAIN_LOSS_TOL
MOE_GRAD_REL_TOL = TRAIN_GRAD_REL_TOL
# GPT-2 XL with remat against without, both through the kernels: the
# forward is the same arithmetic and the backward recomputes each block on
# the same inputs, so both agree to the last bit where every kernel of the
# step is deterministic; held to 1e-3 per leaf.
REMAT_LOSS_TOL = 1e-6
REMAT_GRAD_REL_TOL = 1e-3
# GPT-2 XL, xent_chunks=8 against the dense head (both with remat): the
# head's f32 products over 128-row chunks sum in another order, and a
# gradient rounded to bf16 otherwise at one element moves on through 48
# bf16 layers; held as the kernels-vs-dense gradients are.
CHUNK_LOSS_TOL = 1e-4
CHUNK_GRAD_REL_TOL = 5e-2
# Llama-2 7B logits at S=2048, the kernel (uncached forward) vs the dense
# cached branch.  32 bf16 layers amplify any change in how attention
# rounds: on the card the plain attention in f32, uncached, parts from the
# dense cached branch by ||diff|| / ||logits|| 4.0e-2 and max |diff| 0.31
# (this phase prints it), the kernel, which also rounds p to bf16, by
# 5.3e-2 and 0.43.  Held with ~2x room.  The kernel's own error is held per
# layer, on the model's q, k, v, against the plain version with phase 2's
# o tolerance.
LLAMA_LOGITS_REL_TOL = 0.1
LLAMA_LOGITS_TOL = 1.0


def set_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Generator:
    """Greedy next-token generator over GPT-2 with no KV cache — port of
    the deployment in ``examples/serve_llm.py``: each token is one full
    ``forward`` over the sequence so far; ``moe_experts > 0`` serves the
    mixture-of-experts model of the same widths."""

    def __init__(self, cfg_name: str = "small", device: str = "cuda",
                 seed: int = 0, moe_experts: int = 0):
        if torch.device(device).type == "cuda":
            set_precision()
        self.cfg = replace(getattr(gpt2, f"GPT2_{cfg_name.upper()}"),
                           moe_experts=moe_experts)
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = gpt2.init_params(gen, self.cfg, device=device)
        self.forwards = 0

    @torch.inference_mode()
    def _next_token(self, tokens):
        x = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits = gpt2.forward(self.params, x, self.cfg)
        self.forwards += 1
        return int(logits[0, -1].argmax())

    def __call__(self, request):
        if (request or {}).get("stream"):
            return self.stream(request)  # what HTTP's ?stream=1 calls
        tokens = list((request or {}).get("prompt", [1]))
        for _ in range(int((request or {}).get("max_tokens", 8))):
            tokens.append(self._next_token(tokens))
        return {"tokens": tokens}

    @torch.inference_mode()
    def logits(self, request):
        """The logits of one forward over ``request["prompt"]``, on the
        device (the runtime takes them to the host)."""
        x = torch.tensor([request["prompt"]], dtype=torch.long,
                         device=self.device)
        self.forwards += 1
        return gpt2.forward(self.params, x, self.cfg)

    def stream(self, request):
        tokens = list((request or {}).get("prompt", [1]))
        for _ in range(int((request or {}).get("max_tokens", 8))):
            tokens.append(self._next_token(tokens))
            yield {"token": tokens[-1]}

    def launches(self, reset=False):
        """(the forward kernel's launches in this process, forwards); with
        ``reset``, the launch count is set to 0 after it is read.  A Serve
        replica reports its own process's count through this method."""
        out = (fa.KERNEL_LAUNCHES, self.forwards)
        if reset:
            fa.KERNEL_LAUNCHES = 0
        return out


class LlamaServer:
    """Llama generation behind a Serve replica — port of the deployment
    in ``tests/test_serve.py`` (``test_llama_generate_deployment``).  A
    request ``{"prompt_tokens": [...], "max_new_tokens": n,
    "temperature": t, "seed": s}`` returns ``{"tokens": prompt + n new
    tokens}`` from ``llama.generate`` (static KV cache, B=1); a request at
    ``temperature > 0`` samples with a generator seeded from ``seed``.
    Weights are random from ``seed`` and cast once by
    ``serving_params``."""

    def __init__(self, cfg_name: str = "7b", device: str = "cuda",
                 seed: int = 0):
        if torch.device(device).type == "cuda":
            set_precision()
        self.cfg = getattr(llama, f"LLAMA_{cfg_name.upper()}")
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = llama.serving_params(
            llama.init_params(gen, self.cfg, device=device), self.cfg)

    def __call__(self, request):
        prompt = torch.tensor([request["prompt_tokens"]], dtype=torch.long,
                              device=self.device)
        temperature = float(request.get("temperature", 0.0))
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(
                int(request.get("seed", 0)))
        toks = llama.generate(
            self.params, prompt, self.cfg,
            max_new_tokens=int(request.get("max_new_tokens", 4)),
            temperature=temperature, generator=gen)
        return {"tokens": toks[0].tolist()}

    @torch.inference_mode()
    def last_logits(self, request):
        """The uncached forward (the flash kernel in every layer) over
        ``request["tokens"]``: the last position's logits and every
        position's argmax, on the device."""
        x = torch.tensor([request["tokens"]], dtype=torch.long,
                         device=self.device)
        logits, _ = llama.forward(self.params, x, self.cfg)
        return {"last": logits[0, -1], "argmax": logits[0].argmax(-1)}

    def launches(self, reset=False):
        """The forward kernel's launches in this process; with ``reset``,
        the count is set to 0 after it is read."""
        out = fa.KERNEL_LAUNCHES
        if reset:
            fa.KERNEL_LAUNCHES = 0
        return out


def script_class(name):
    """The class ``name`` of this script's module ``chip_smoke``, which the
    vendored cloudpickle ships by reference (a replica's process imports
    the module).  By value it would have to pickle the
    ``torch.backends.cudnn`` module object that ``set_precision`` touches,
    and it cannot."""
    import chip_smoke

    return getattr(chip_smoke, name)


def script_replica(name, init_args, init_kwargs=None):
    """A ``Replica`` in this process hosting this script's class ``name``,
    given as the runtime gives it: cloudpickle bytes and positional
    ``init_args, init_kwargs``."""
    return Replica(cloudpickle.dumps(script_class(name)), init_args,
                   init_kwargs or {})


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3, hold_ms=25):
    """Mean time of fn() over iters calls (CUDA events).  With hold_ms > 0,
    a spin kernel of about that length, queued first, holds the stream
    while the host enqueues the calls, so the events time the device and
    not the host's launch rate; hold_ms=0 times what a caller waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 2e6))  # cycles, at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, H, S, D, causal, products=2, tensors=4, rows=1):
    """(least ms on an H100 SXM, "bytes" or "operations") for attention
    work of ``products`` (S, S, D) products, 2*B*H*S^2*D operations each
    (halved when causal), at the bf16 peak, against ``tensors`` bf16
    (B, S, H, D) tensors and ``rows`` f32 (B, H, S) rows moved once at the
    memory rate.  The forward: 2 products, q, k, v, o and lse."""
    flops = products * 2 * B * H * S * S * D / (2 if causal else 1)
    nbytes = tensors * B * S * H * D * 2 + rows * B * H * S * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (products, bf16 tensors, f32 rows) of each backward kernel's work, and of
# the whole backward: dq recomputes s and dp and forms ds k (q, k, v, do,
# dq; lse, delta); dk/dv recomputes s and dp and forms p^T do and ds^T q
# (q, k, v, do, dk, dv; lse, delta); the backward as one function needs
# five products and q, k, v, do, dq, dk, dv.
BWD_WORK = {"dq": (3, 5, 2), "dkv": (4, 6, 2), "pair": (5, 7, 2)}

#: (B, H, S, D) of a GPT-2 124M train step at B=16, S=1024
TRAIN_SHAPE = (16, 12, 1024, 64)
#: (B, H, S, D) of a GPT-2 XL train step at B=16, S=1024
XL_SHAPE = (16, 25, 1024, 64)
#: (B, H, S, D) of a Llama-2 7B forward at its full context
LLAMA_SHAPE = (1, 32, 4096, 128)
#: phase 8's kernel shapes (bhsd), by label: a ring step's chunks of the
#: training shape at sp = 2 and 4, and Ulysses' head groups at sp = 2, 4
SP_SHAPES = {(16, 12, 512, 64): "sp ring chunk (sp=2)",
             (16, 12, 256, 64): "sp ring chunk (sp=4)",
             (16, 6, 1024, 64): "sp ulysses heads (sp=2)",
             (16, 3, 1024, 64): "sp ulysses heads (sp=4)"}
SP_LABELS = set(SP_SHAPES.values())
#: phase 9's microbatch shapes (bshd): 4 rows (M = 4 of 16 rows at pp = 2,
#: of 8 at the pp = 4 check) and 2 rows (M = 8 of 16 at pp = 4, M = 4 of a
#: dp replica's 8, M = 4 of the pp = 2 check's 8)
PP_SHAPES = {(4, 12, 1024, 64): "pp microbatch (B=4)",
             (2, 12, 1024, 64): "pp microbatch (B=2)"}
#: phase 10's kernel shapes (bshd, as strided views of one (B, S, 3 x 384)
#: qkv buffer): a tp = 2 rank's 6 heads at 16 rows (tp = 2, MoE tp = 2),
#: 8 (dp = 2 x tp = 2) and 4 (the microbatches of pp = 2 x tp = 2, M = 4)
TP_SHAPES = {(16, 6, 1024, 64): "tp rank heads (tp=2, B=16)",
             (8, 6, 1024, 64): "tp rank heads (dp=2 x tp=2, B=8)",
             (4, 6, 1024, 64): "tp rank heads (pp=2 x tp=2, B=4)"}
#: and the ring chunks of tp = 2 x sp = 2 (bhsd)
TP_SP_SHAPES = {(16, 6, 512, 64): "tp x sp ring chunk (tp=2, sp=2)"}
#: phase 11's new kernel shape (bshd): a dp = 2 rank's 8 rows of 12 heads
#: (MoE dp = 2 and dp = 2 x ep = 2)
EP_SHAPES = {(8, 12, 1024, 64): "dp rank (dp=2, B=8)"}
#: phase 12's new kernel shape (bshd): a GPT-2 XL fsdp = 2 rank's 8 rows
#: of 25 heads
FSDP_SHAPES = {(8, 25, 1024, 64): "xl fsdp rank (fsdp=2, B=8)"}
SP_LABELS |= set(TP_SP_SHAPES.values())
#: ms per step and peak GB of the single-rank train steps (phases 4, 6 and
#: 7's dense head), by model, printed beside phases 9-12's
SINGLE_RANK_STEPS = {}
#: what phases 17 and 18 are held to or printed beside: phase 4's losses
#: ("train_losses"), phase 15's same-node get ("runtime_get_ms")
PHASE_REF = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_name(mangled):
    """``flash_fwd_kernel<64,128,3>`` from a mangled template name."""
    m = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(-?[0-9]+)E', m.group(2)))}>"


def sass_counts(lib, pattern):
    """{kernel: {opcode: count}} of the TMA loads (UTMALDG), wgmma
    (HGMMA), mbarrier operations (SYNCS) and mma.sync (HMMA) in the SASS
    of each kernel of ``lib`` whose name holds ``pattern`` (``cuobjdump
    --dump-sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1)) if pattern in m.group(1) else None
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                counts[name][op] += 1
    return counts


SASS_OPS = ("UTMALDG", "HGMMA", "SYNCS", "HMMA")


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(sorted(libs)), flush=True)
    regs, spills = {}, {}
    for name, log in sorted(build.BUILD_LOG.items()):
        entry = name
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = kernel_name(m.group(1))
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower()):
                print(f"[build] {entry}: {line.split(':', 1)[-1].strip()}")
                n = re.search(r"Used (\d+) registers", line)
                if n:
                    regs[entry] = int(n.group(1))
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if n:
                    spills[entry] = int(n.group(1)) + int(n.group(2))
    # a block of two consumer warpgroups (384 threads) must be built at 168
    # registers a thread, the budget its setmaxnreg split redistributes
    # (24 + 2 x 240 in the forward's 128-row and the dq kernel's
    # two-consumer instantiations, 40 + 2 x 232 in the dk/dv kernel's)
    short = {k: n for k, n in regs.items()
             if re.match(r"flash_fwd_kernel<\d+,128,|"
                         r"flash_bwd_(dq|dkv)_kernel<\d+,2,", k)
             and n != 168}
    if short:
        fail(f"two-consumer kernels not built at 168 registers: {short}")
    bwd_spills = {k: n for k, n in spills.items()
                  if k.startswith("flash_bwd_") and n}
    if bwd_spills:
        fail(f"backward kernels spill (bytes): {bwd_spills}")
    for lib in ("flash_fwd", "flash_bwd"):
        for kernel, ops in sorted(sass_counts(libs[lib], lib).items()):
            print(f"[build] SASS {kernel}: "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()),
                  flush=True)
            if ops["HMMA"] or not all(ops[op] for op in SASS_OPS[:3]):
                fail(f"{kernel} is not the TMA/mbarrier/wgmma design: {ops}")
    print(f"[build] card: {card_line()}", flush=True)


def phase_sm90_checks(seed):
    """csrc/sm90_check.cu against torch: a TMA tile load of a strided bshd
    view with rows past S, an SS wgmma (q k^T's form) and an RS wgmma with
    an MN-major B (p v's form), at D = 32, 64 and 128.  Entries are small
    integers, so every product and sum is exact in f32 and the results
    must be equal, not close."""
    lib = build.load("sm90_check")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sm90_check_tma.argtypes = [P, P, I, I, I, I, P, I, I, I, P]
    lib.sm90_check_ss.argtypes = [P, P, P, I, P]
    lib.sm90_check_rs.argtypes = [P, P, P, I, P]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        rc = getattr(lib, fn)(*args, stream)
        if rc:
            fail(f"{fn} returned {rc}")

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.bfloat16)

    for D in (32, 64, 128):
        B, S, H, row0, h, b = 2, 1000, 12, 960, 5, 1
        _, view, _ = _qkv(B, H, S, D, "bshd", gen)  # k of a fused qkv
        tile = torch.empty((64, D), dtype=torch.bfloat16, device="cuda")
        st = (ctypes.c_int64 * 3)(*view.stride()[:3])
        call("sm90_check_tma", view.data_ptr(), tile.data_ptr(), B, S, H, D,
             st, row0, h, b)
        want = torch.zeros_like(tile)
        want[:S - row0] = view[b, row0:, h]
        a, bt = ints(64, D), ints(64, D)
        s = torch.empty((64, 64), device="cuda")
        call("sm90_check_ss", a.data_ptr(), bt.data_ptr(), s.data_ptr(), D)
        p, v = ints(64, 64), ints(64, D)
        o = torch.empty((64, D), device="cuda")
        call("sm90_check_rs", p.data_ptr(), v.data_ptr(), o.data_ptr(), D)
        torch.cuda.synchronize()
        res = {"tma": torch.equal(tile, want),
               "ss": torch.equal(s, a.float() @ bt.float().T),
               "rs": torch.equal(o, p.float() @ v.float())}
        print(f"[sm90] D={D}: TMA tile of a strided bshd view, rows "
              f"{row0}..{row0 + 63} of S={S} ({row0 + 64 - S} past S read "
              f"as zeros): "
              f"{'equal' if res['tma'] else 'DIFFERS'}; wgmma SS 64x64x{D} "
              f"vs torch.matmul f32: {'equal' if res['ss'] else 'DIFFERS'}; "
              f"wgmma RS 64x{D}x64, B MN-major: "
              f"{'equal' if res['rs'] else 'DIFFERS'} (exact: integer "
              f"entries)", flush=True)
        if not all(res.values()):
            fail(f"sm90 primitives disagree with torch at D={D}: {res}")


def _qkv(B, H, S, D, layout, gen):
    """bf16 q, k, v on the card; bshd ones are strided views of one fused
    (B, S, 3*H*D) tensor, as the model's qkv projection gives them."""
    if layout == "bhsd":
        return tuple(torch.randn((B, H, S, D), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(3))
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return tuple(t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))


def phase_kernels(seed):
    """Kernel vs plain on the card; returns the served-shape record."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(B, 12, S, 64, layout) for B in (1, 4) for S in (128, 1000, 1024)
             for layout in ("bshd", "bhsd")]
    cases += [(1, 32, 2048, 128, layout) for layout in ("bshd", "bhsd")]
    cases += [(2, 4, 100, 32, layout) for layout in ("bshd", "bhsd")]
    cases += [TRAIN_SHAPE + ("bshd",), XL_SHAPE + ("bshd",),
              LLAMA_SHAPE + ("bshd",)]
    cases += [shape + ("bhsd",) for shape in SP_SHAPES]
    cases += [shape + ("bshd",) for shape in PP_SHAPES
              if shape[0] not in (1, 4)]  # B = 4 is in the grid above
    cases += [shape + ("bshd",) for shape in TP_SHAPES]
    cases += [shape + ("bhsd",) for shape in TP_SP_SHAPES]
    cases += [shape + ("bshd",) for shape in {**EP_SHAPES, **FSDP_SHAPES}]
    served = None
    worst = 0.0
    for B, H, S, D, layout in cases:
        for causal in (True, False):
            q, k, v = _qkv(B, H, S, D, layout, gen)
            if layout == "bhsd":
                run = lambda: fa._flash_fwd(  # noqa: E731
                    q, k, v, causal, None, None, None)
                qh, kh, vh = q, k, v
            else:
                run = lambda: fa._flash_fwd_bshd(  # noqa: E731
                    q, k, v, causal, None, None, None)
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            scale = D ** -0.5
            plain = lambda: fa._reference_attention(  # noqa: E731
                qh, kh, vh, scale, causal)
            o, (_, _, _, _, lse) = run()
            o_ref, lse_ref = plain()
            o_mag, _ = fa._reference_attention(qh, kh, vh.abs(), scale,
                                               causal)
            if layout == "bshd":
                o_ref, o_mag = (t.transpose(1, 2) for t in (o_ref, o_mag))
            torch.cuda.synchronize()
            diff = (o.float() - o_ref.float()).abs()
            o_tol = O_RTOL * o_ref.float().abs() + O_PTOL * o_mag.float()
            o_err = diff.max().item()
            o_ratio = (diff / o_tol).max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = o_ratio <= 1 and lse_err <= LSE_TOL
            worst = max(worst, o_err)
            ms = time_ms(run)
            plain_ms = time_ms(plain, iters=5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal))
            bound, bound_by = attention_bound(B, H, S, D, causal)
            plan = fa._fwd_plan(B, H, S, D, fa._sm_count(q.device))
            print(f"[kernel] B={B} H={H} S={S} D={D} {layout} "
                  f"causal={int(causal)} plan={plan.block_m} rows x "
                  f"{plan.stages} slots: o_err={o_err:.3e} "
                  f"max o_err/tol={o_ratio:.3f} (tol {O_RTOL}*|o| + "
                  f"2^-8*P@|v|, must be <= 1) "
                  f"lse_err={lse_err:.3e} "
                  f"(tol {LSE_TOL}) kernel_ms={ms:.4f} "
                  f"bound_us={bound * 1e3:.3f} ({bound_by}) "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
                  f"{'' if ok else '  <-- OUT OF TOLERANCE'}",
                  flush=True)
            if not ok:
                fail(f"kernel disagrees with plain at B={B} H={H} "
                     f"S={S} D={D} {layout} causal={causal}")
            if (B, H, S, D, layout, causal) == (1, 12, 1024, 64, "bshd",
                                                True):
                served = {"ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": lib_ms}
                print(f"[kernel] served shape: kernel_ms={ms:.4f} "
                      f"library_ms={lib_ms:.4f} bound_ms={bound:.5f} "
                      f"({bound_by}); tensor-map encode "
                      f"{encode_us(q, k, v, layout):.3f} us of host "
                      f"time per launch (3 maps)", flush=True)
            label = {TRAIN_SHAPE: "training", XL_SHAPE: "xl",
                     LLAMA_SHAPE: "llama", **SP_SHAPES,
                     **TP_SP_SHAPES}.get((B, H, S, D))
            if layout == "bshd":
                label = {**PP_SHAPES, **TP_SHAPES, **EP_SHAPES,
                         **FSDP_SHAPES}.get((B, H, S, D), label)
            if label:
                print(f"[kernel] {label} shape, causal={int(causal)}: "
                      f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={bound:.5f} ({bound_by})", flush=True)
    served["max_abs_err"] = worst
    return served


def encode_us(q, k, v, layout, iters=10000):
    """Host microseconds of the three cuTensorMapEncodeTiled calls that
    each forward launch makes (``flash_fwd_encode_us``)."""
    lib = fa._kernel("flash_fwd")
    fn = lib.flash_fwd_encode_us
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_double
    B, H, S, D, dims = fa._geometry(q, layout)
    q, k, v = (fa._kernel_ready(x) for x in (q, k, v))
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, S, D,
            fa._strides(dims, q, k, v, q), iters)
    if us < 0:
        fail("a tensor map was refused")
    return us


def bwd_magnitudes(q, k, v, o, lse, do, scale, causal):
    """(M_dq, M_dk, M_dv) of the G_PTOL bounds, (B, H, S, D) f32."""
    p = torch.exp(fa._scores(q, k, scale, causal, torch.float32)
                  - lse[..., None])
    do, v = do.float(), v.float()
    dp = do @ v.transpose(-1, -2)
    delta = (do * o.float()).sum(-1)[..., None]
    f32_sums = do.abs() @ v.abs().transpose(-1, -2) + (
        do * o.float()).abs().sum(-1)[..., None]
    ads = (p * ((dp - delta).abs() + 2.0 ** -10 * f32_sums)) * scale
    del dp, f32_sums
    m_dq = ads @ k.float().abs()
    m_dk = ads.transpose(-1, -2) @ q.float().abs()
    m_dv = p.transpose(-1, -2) @ do.float().abs()
    return m_dq, m_dk, m_dv


def phase_bwd_kernels(seed):
    """Backward kernels vs the plain backward on the card; returns the
    training-shape records of the dq and dk/dv kernels."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    train_shape = TRAIN_SHAPE
    cases = [(shape, ("bshd", "bhsd")) for shape in (
        train_shape, XL_SHAPE, (1, 12, 1000, 64), (1, 32, 2048, 128),
        (1, 4, 100, 32))]
    cases += [(shape, ("bhsd",)) for shape in SP_SHAPES]
    cases += [(shape, ("bshd",)) for shape in PP_SHAPES]
    cases += [(shape, ("bshd",)) for shape in TP_SHAPES]
    cases += [(shape, ("bhsd",)) for shape in TP_SP_SHAPES]
    cases += [(shape, ("bshd",)) for shape in {**EP_SHAPES, **FSDP_SHAPES}]
    worst = {"dq": 0.0, "dkv": 0.0}
    rec = {}
    for (B, H, S, D), layouts in cases:
        for layout in layouts:
            for causal in (True, False):
                q, k, v = _qkv(B, H, S, D, layout, gen)
                scale = D ** -0.5
                fwd = fa._flash_fwd if layout == "bhsd" else fa._flash_fwd_bshd
                o, res = fwd(q, k, v, causal, None, None, None)
                do = torch.randn(o.shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
                tr = (lambda t: t) if layout == "bhsd" else (  # noqa: E731
                    lambda t: t.transpose(1, 2))
                lse = res[4]
                ops = fa._bwd_operands(q, k, v, o, lse, do, layout)
                dq = fa._launch_bwd_dq(ops, causal, scale, layout)
                dk, dv = fa._launch_bwd_dkv(ops, causal, scale, layout)
                plan = fa._bwd_plan(B, H, S, D, fa._sm_count(q.device))
                dq_plan = fa._dq_plan(B, H, S, D, fa._sm_count(q.device))
                qh, kh, vh, oh, doh = (tr(t) for t in (q, k, v, o, do))
                plain = lambda: fa._reference_attention_bwd(  # noqa: E731
                    qh, kh, vh, oh, lse, doh, scale, causal)
                ref = plain()
                mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, causal)
                torch.cuda.synchronize()
                ratios, errs = {}, {}
                for name, g, r, m in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         ref, mags):
                    diff = (tr(g).float() - r.float()).abs()
                    tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
                    errs[name] = diff.max().item()
                    ratios[name] = (diff / tol).max().item()
                del mags
                worst["dq"] = max(worst["dq"], errs["dq"])
                worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
                ok = all(r <= 1 for r in ratios.values())
                dq_ms = time_ms(lambda: fa._launch_bwd_dq(
                    ops, causal, scale, layout))
                dkv_ms = time_ms(lambda: fa._launch_bwd_dkv(
                    ops, causal, scale, layout))
                plain_ms = time_ms(plain, iters=3)
                ql, kl, vl = (t.detach().requires_grad_(True)
                              for t in (qh, kh, vh))
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    is_causal=causal)
                lib = {name: time_ms(lambda wrt=wrt: torch.autograd.grad(
                    ol, wrt, doh, retain_graph=True))
                    for name, wrt in (("all", (ql, kl, vl)), ("dq", (ql,)),
                                      ("dkv", (kl, vl)))}
                del ol
                bounds = {n: attention_bound(B, H, S, D, causal, *w)
                          for n, w in BWD_WORK.items()}
                print(f"[bwd] B={B} H={H} S={S} D={D} {layout} "
                      f"causal={int(causal)} dq plan={dq_plan.block_m} rows "
                      f"x {dq_plan.stages} slots, dk/dv plan={plan.block_n} "
                      f"rows x {plan.stages} slots: max err/tol dq="
                      f"{ratios['dq']:.3f} dk={ratios['dk']:.3f} "
                      f"dv={ratios['dv']:.3f} (must be <= 1; max |err| dq="
                      f"{errs['dq']:.3e} dk={errs['dk']:.3e} "
                      f"dv={errs['dv']:.3e}) dq_ms={dq_ms:.4f} "
                      f"dkv_ms={dkv_ms:.4f} sum_ms={dq_ms + dkv_ms:.4f} "
                      f"bound_ms dq={bounds['dq'][0]:.4f} "
                      f"dkv={bounds['dkv'][0]:.4f} "
                      f"pair={bounds['pair'][0]:.4f} "
                      f"({bounds['pair'][1]}) plain_ms={plain_ms:.3f} "
                      f"library_ms={lib['all']:.4f} (dq only "
                      f"{lib['dq']:.4f}, dk/dv only {lib['dkv']:.4f})"
                      f"{'' if ok else '  <-- OUT OF TOLERANCE'}",
                      flush=True)
                if not ok:
                    fail(f"backward kernels disagree with plain at B={B} "
                         f"H={H} S={S} D={D} {layout} causal={causal}")
                label = {train_shape: "training", XL_SHAPE: "xl",
                         **SP_SHAPES, **TP_SP_SHAPES,
                         **PP_SHAPES}.get((B, H, S, D))
                if layout == "bshd":
                    label = {**TP_SHAPES, **EP_SHAPES, **FSDP_SHAPES}.get(
                        (B, H, S, D), label)
                if label in SP_LABELS or (label and layout == "bshd"
                                          and causal):
                    if label == "training":
                        for n, t in (("dq", dq_ms), ("dkv", dkv_ms)):
                            rec[n] = {"ms": t, "plain_ms": plain_ms,
                                      "bound_ms": bounds[n][0],
                                      "bound_by": bounds[n][1],
                                      "library_ms": lib[n]}
                    print(f"[bwd] {label} shape, causal={int(causal)}: dq "
                          f"{dq_ms:.4f} ms, bound "
                          f"{bounds['dq'][0]:.4f} ms ({bounds['dq'][1]}), "
                          f"dk/dv {dkv_ms:.4f} ms, bound "
                          f"{bounds['dkv'][0]:.4f} ms "
                          f"({bounds['dkv'][1]}); library grad wrt q "
                          f"{lib['dq']:.4f} ms, wrt k, v {lib['dkv']:.4f} ms",
                          flush=True)
    for n in rec:
        rec[n]["max_abs_err"] = worst[n]
    return rec


def greedy(params, cfg, prompt, n):
    tokens = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            x = torch.tensor([tokens], dtype=torch.long, device="cuda")
            tokens.append(int(gpt2.forward(params, x, cfg)[0, -1].argmax()))
    return tokens


def phase_serve(seed, profile):
    t0 = time.perf_counter()
    replica = script_replica("Generator", ("small", "cuda", seed))
    gen_obj = replica._callable
    cfg = gen_obj.cfg
    torch.cuda.synchronize()
    print(f"[serve] GPT2_SMALL: {gpt2.num_params(gen_obj.params)} params, "
          f"replica up in {time.perf_counter() - t0:.2f} s", flush=True)

    rng, prompts = serve_prompts(seed)
    vocab = 50257

    # first forward: kernel vs plain (dense) attention
    x = torch.tensor([prompts[500]], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        lk = gpt2.forward(gen_obj.params, x, cfg)
        ld = gpt2.forward(gen_obj.params, x, replace(cfg, attention="dense"))
    torch.cuda.synchronize()
    if lk.shape != (1, 500, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail(f"logits malformed: {tuple(lk.shape)}")
    l_err = (lk - ld).abs().max().item()
    print(f"[serve] first forward S=500: logits kernel vs dense max abs "
          f"err {l_err:.4e} (tol {LOGITS_TOL}), |logits| max "
          f"{ld.abs().max().item():.3f}", flush=True)
    if l_err > LOGITS_TOL:
        fail("logits with the kernel disagree with dense attention")

    f0, results, request_ms = serve_requests(replica, gen_obj, prompts,
                                             "serve")
    t = time.perf_counter()
    items = list(replica.handle_request_stream(
        {"prompt": prompts[64], "max_tokens": 8}, method="stream"))
    dt = time.perf_counter() - t
    if len(items) != 8 or not all(0 <= i["token"] < cfg.vocab_size
                                  for i in items):
        fail(f"stream returned {items}")
    print(f"[serve] stream, prompt 64: 8 tokens in {dt * 1e3:.1f} ms = "
          f"{8 / dt:.1f} tokens/s", flush=True)
    launches = fa.KERNEL_LAUNCHES
    forwards = gen_obj.forwards - f0
    print(f"[serve] kernel launches {launches} = n_layer {cfg.n_layer} x "
          f"forwards {forwards}: {launches == cfg.n_layer * forwards}; "
          f"replica stats {replica.stats()}", flush=True)
    if forwards != 40 or launches != cfg.n_layer * forwards:
        fail("the served path did not run the kernel once per layer "
             "per forward")

    dense = greedy(gen_obj.params, replace(cfg, attention="dense"),
                   prompts[127], 8)
    print(f"[serve] greedy tokens, prompt 127, kernel vs dense: "
          f"{'agree' if dense == results[127] else 'differ'} "
          f"(kernel {results[127][127:]}, dense {dense[127:]})", flush=True)

    x = torch.randint(0, vocab, (1, 1024), generator=rng).to("cuda")
    with torch.inference_mode():
        fwd = lambda: gpt2.forward(gen_obj.params, x, cfg)  # noqa: E731
        wall_ms = time_ms(fwd, iters=10, hold_ms=0)
        dev_ms = time_ms(fwd, iters=10, hold_ms=250)
    print(f"[serve] forward at S=1024, B=1: {wall_ms:.3f} ms as issued, "
          f"{dev_ms:.3f} ms of device work (CUDA events); device idle "
          f"{1 - dev_ms / wall_ms:.1%} of the issued time", flush=True)
    if profile:
        profile_forward(gen_obj.params, x, cfg)
    return launches, {"prompts": prompts, "tokens": results,
                      "logits": lk.cpu(), "ms": request_ms}


def serve_prompts(seed):
    """Phase 3's prompts of 16, 127, 500, 1000 (and 64) tokens."""
    rng = torch.Generator().manual_seed(seed)
    vocab = 50257  # GPT-2's real vocabulary; the padded rows stay reachable
    return rng, {L: torch.randint(0, vocab, (L,), generator=rng).tolist()
                 for L in (16, 127, 500, 1000, 64)}


def serve_requests(replica, gen_obj, prompts, tag):
    """A warm-up request, then one of 8 new tokens at each prompt of 16,
    127, 500 and 1000 tokens through ``handle_request``, each checked and
    printed with its tokens/s; the launch counts are set to 0 after the
    warm-up.  Returns (forwards before the four, tokens by prompt, ms by
    prompt)."""
    cfg = gen_obj.cfg
    replica.handle_request({"prompt": prompts[16], "max_tokens": 2})  # warm
    reset_launches()
    f0 = gen_obj.forwards
    results, ms = {}, {}
    for L in (16, 127, 500, 1000):
        t = time.perf_counter()
        out = replica.handle_request({"prompt": prompts[L], "max_tokens": 8})
        dt = time.perf_counter() - t
        toks = out["tokens"]
        if (len(toks) != L + 8 or toks[:L] != prompts[L]
                or not all(0 <= x < cfg.vocab_size for x in toks[L:])):
            fail(f"request with a {L}-token prompt returned {toks[L:]}")
        results[L], ms[L] = toks, dt * 1e3
        print(f"[{tag}] prompt {L}: 8 tokens in {dt * 1e3:.1f} ms = "
              f"{8 / dt:.1f} tokens/s, {dt / 8 * 1e3:.3f} ms per forward "
              f"(S={L}..{L + 7}); new tokens {toks[L:]}", flush=True)
    return f0, results, ms


def profile_forward(params, x, cfg):
    with torch.inference_mode():
        for _ in range(2):
            gpt2.forward(params, x, cfg)
        torch.cuda.synchronize()
        print_profile(lambda: gpt2.forward(params, x, cfg), 15,
                      "forward S=1024 B=1", calls=3)


def device_idle_share(events):
    """1 - (time some device activity runs) / (first start to last end) of
    the traced device events: the gaps on the card's timeline."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return 1 - busy / (max(b for _, b in spans) - spans[0][0])


def print_profile(fn, rows, label, calls=1):
    """Device time by kernel of ``calls`` back-to-back calls of fn
    (torch.profiler's CUDA events), per call, and the device's idle share
    over them; returns the device ms per call.  The calls traced are the
    schedule's second cycle, as in ``count_launches``: the trace of a
    first cycle can miss its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1,
                                    repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # CUDA events, less the ranges that annotations (Optimizer.step, ...)
    # mark on the device timeline over kernels already counted
    def on_device(e):
        return (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    kernels = sorted(filter(on_device, prof.key_averages()),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / calls
    idle = device_idle_share(list(filter(on_device, prof.events())))
    print(f"[profile] {label}: {total:.0f} us of device time per call in "
          f"{sum(e.count for e in kernels) // calls} kernel launches; "
          f"device idle {idle:.2%} of the trace from the first kernel of "
          f"{calls} back-to-back calls to the last; by kernel, per call:")
    for e in kernels[:rows]:
        t = e.self_device_time_total / calls
        print(f"[profile] {t:10.0f} us {100 * t / total:5.1f}% "
              f"{e.count // calls:5d} x  {e.key[:100]}")
    return total / 1e3


def reset_launches():
    fa.KERNEL_LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0


def read_launches():
    return {"flash_fwd": fa.KERNEL_LAUNCHES,
            "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES}


def loss_and_grads(params, batch, cfg, xent_chunks=0):
    """(loss, gradient of every leaf) of ``loss_fn`` through the cast."""
    leaves = gpt2.param_leaves(params)
    loss = gpt2.loss_fn(gpt2._cast_weights(params, cfg.compute_dtype), batch,
                        cfg, xent_chunks=xent_chunks)
    return loss.item(), torch.autograd.grad(loss, leaves)


def compare_grads(tag, what, names, a, b, loss_tol=None, rel_tol=None):
    """Hold two (loss, gradients) against each other: |loss diff| <=
    loss_tol and, per leaf, ||g_a - g_b|| / ||g_b|| <= rel_tol; without
    tolerances, print the distance only."""
    (la, ga), (lb, gb) = a, b
    rel = [((x - y).norm() / y.norm()).item() for x, y in zip(ga, gb)]
    i = max(range(len(rel)), key=rel.__getitem__)
    print(f"[{tag}] {what}: loss {la:.6f} vs {lb:.6f} |diff| "
          f"{abs(la - lb):.3e} (tol {loss_tol}); largest ||g - g_ref|| / "
          f"||g_ref|| {rel[i]:.3e} at {names[i]} (tol {rel_tol}); median "
          f"{sorted(rel)[len(rel) // 2]:.3e}; bit for bit: "
          f"{all(torch.equal(x, y) for x, y in zip(ga, gb))}", flush=True)
    if not (math.isfinite(la) and math.isfinite(lb)):
        fail(f"{tag}: loss not finite")
    if loss_tol is not None and (abs(la - lb) > loss_tol
                                 or rel[i] > rel_tol):
        fail(f"{tag}: {what} disagree")


def train_tokens(seed, B, S):
    """A (B, S+1) batch of tokens of GPT-2's vocabulary, on the host."""
    rng = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, 50257, (B, S + 1), generator=rng)


def train_setup(cfg, seed, B, S):
    """f32 master parameters from ``seed`` (every leaf requiring grad) and
    a (B, S+1) batch of tokens of GPT-2's vocabulary."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = gpt2.init_params(gen, cfg, device="cuda")
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    return params, train_tokens(seed, B, S).to("cuda")


def adamw(params, lr=3e-4):
    """``bench.py``'s optimizer (lr 3e-4, weight decay 0.1), for torch."""
    return torch.optim.AdamW(gpt2.param_leaves(params), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)


def timed_steps(step, params, batch, steps):
    """A warm-up step, then ``steps`` steps between CUDA events with the
    launch counts set to 0 first: (losses with the warm-up's first, ms per
    step, launches of the timed steps, the warm-up's seconds)."""
    t0 = time.perf_counter()
    first = step(params, batch)["loss"].item()
    warm_s = time.perf_counter() - t0
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = [step(params, batch)["loss"] for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    return ([first] + [x.item() for x in out],
            start.elapsed_time(end) / steps, read_launches(), warm_s)


def phase_train(seed, profile):
    """GPT-2 124M train steps at B=16, S=1024; returns the launches of the
    10 timed steps."""
    cfg = gpt2.GPT2_SMALL
    B, S, steps = 16, 1024, 10
    params, tokens = train_setup(cfg, seed, B, S)
    batch = {"tokens": tokens}

    # loss and every leaf's gradient, kernels vs dense attention
    small = {"tokens": tokens[:4]}
    compare_grads("train", f"gradient check B=4 S={S}, kernels vs dense",
                  [n for n, _ in gpt2.named_leaves(params)],
                  loss_and_grads(params, small, cfg),
                  loss_and_grads(params, small,
                                 replace(cfg, attention="dense")),
                  TRAIN_LOSS_TOL, TRAIN_GRAD_REL_TOL)

    step = gpt2.make_train_step(cfg, adamw(params))
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, warm_s = timed_steps(step, params, batch, steps)
    print(f"[train] warm-up step: loss {losses[0]:.4f} in {warm_s:.2f} s",
          flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tok_s = B * S / (ms / 1e3)
    mfu = tok_s * gpt2.count_flops_per_token(cfg, S) / PEAK_BF16_FLOPS
    print(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"[train] GPT2_SMALL B={B} S={S}: {ms:.3f} ms per step (CUDA "
          f"events over {steps} steps), {tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak "
          f"memory {peak_gb:.2f} GB; card {card_line()}", flush=True)
    SINGLE_RANK_STEPS["gpt2"] = (ms, peak_gb)
    PHASE_REF["train_losses"] = losses
    print(f"[train] launches in {steps} steps: {launches} (n_layer "
          f"{cfg.n_layer} x {steps} each)", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train losses not finite or not falling: {losses}")
    if any(n != cfg.n_layer * steps for n in launches.values()):
        fail("a train step did not launch each kernel once per layer")

    if profile:
        print_profile(lambda: step(params, batch), 30,
                      f"train step B={B} S={S}", calls=3)
    return launches


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def decode_bound(params, cfg):
    """(least ms of one decode step at B=1, the same with the reference's
    f32 copy of the cache): every weight read once but the embedding
    table, of which one row; the whole bf16 k/v cache read once, as the
    dense branch attends over every slot; the reference's arithmetic also
    writes and reads an f32 copy of the cache."""
    emb = params["embed_tokens"]["embedding"]
    weights = (tree_bytes(params) - emb.numel() * emb.element_size()
               + emb.shape[1] * emb.element_size())
    cache = 2 * cfg.n_layer * cfg.max_seq * cfg.n_kv_head * cfg.head_dim * 2
    t = (weights + cache) / PEAK_BYTES_PER_S * 1e3
    return t, t + 2 * (2 * cache) / PEAK_BYTES_PER_S * 1e3


def llama_forward_flops(cfg, n_params, S):
    """Operations of one uncached forward over S tokens: 2 per matmul
    weight and token (the embedding is a gather) and the causal attention
    products (2 x 2 S^2 E / 2 a layer)."""
    matmul = n_params - cfg.vocab_size * cfg.n_embd
    return 2 * matmul * S + 2 * cfg.n_layer * S * S * cfg.n_embd


def plain_bshd(q, k, v, causal):
    """The kernel's plain version over (B, S, H, D)."""
    tr, scale = fa._tr, q.shape[-1] ** -0.5
    return tr(fa._reference_attention(tr(q), tr(k), tr(v), scale,
                                      causal)[0])


@contextlib.contextmanager
def llama_attention(fn):
    """Llama's uncached branch calls ``fn`` in place of
    ``flash_attention_bshd`` inside the block; yields the kernel's
    wrapper."""
    kernel = llama.flash_attention_bshd
    llama.flash_attention_bshd = fn
    try:
        yield kernel
    finally:
        llama.flash_attention_bshd = kernel


def llama_forward_checked(params, tokens, cfg):
    """An uncached forward (the kernel in every layer) whose every
    attention output is also held against the plain version on the same
    q, k, v with phase 2's o tolerance: (logits, largest err / tol)."""
    worst = 0.0

    def checked(q, k, v, causal):
        nonlocal worst
        o = kernel(q, k, v, causal)
        ref = plain_bshd(q, k, v, causal)
        mag = plain_bshd(q, k, v.abs(), causal)
        tol = O_RTOL * ref.float().abs() + O_PTOL * mag.float()
        worst = max(worst, ((o.float() - ref.float()).abs() / tol).max()
                    .item())
        return o

    with llama_attention(checked) as kernel:
        logits, _ = llama.forward(params, tokens, cfg)
    return logits, worst


def logits_distance(a, b):
    """(max |a - b|, ||a - b|| / ||b||, share of positions whose argmax
    agrees)."""
    return ((a - b).abs().max().item(), ((a - b).norm() / b.norm()).item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def free_memory(tag):
    """Release what earlier phases left cached, print what stays in use
    and set the peak to 0."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] device memory in use before the model: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()


def phase_llama(seed, profile):
    """Llama-2 7B in Replica; returns the forward kernel's launches in the
    phase's main path (the kernel check's uncached forward, the cached
    forward and the requests) and what phase 16 is held to: the S=2048
    tokens with the uncached forward's last logits and argmax, and the
    greedy request at prompt 128 (prompt, tokens, prefill and per-token
    ms)."""
    free_memory("llama")
    cfg = llama.LLAMA_7B
    t0 = time.perf_counter()
    replica = script_replica("LlamaServer", ("7b", "cuda", seed))
    srv = replica._callable
    params = srv.params
    torch.cuda.synchronize()
    n = llama.num_params(params)
    print(f"[llama] LLAMA_7B: {n} params, {tree_bytes(params) / 1e9:.2f} GB "
          f"as served (bf16, lm head f32), replica up in "
          f"{time.perf_counter() - t0:.2f} s; memory in use "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the f32 tree "
          f"before the cast)", flush=True)

    rng = torch.Generator().manual_seed(seed + 4)
    V, S = cfg.vocab_size, 2048
    tokens = torch.randint(0, V, (1, S), generator=rng).to("cuda")
    prompts = {L: torch.randint(0, V, (L,), generator=rng).tolist()
               for L in (16, 128, 2000)}

    # the kernel (uncached forward, each layer's attention held against
    # the plain version) against the dense cached branch, and the plain
    # attention's own distance from that branch
    reset_launches()
    with torch.inference_mode():
        lk, o_ratio = llama_forward_checked(params, tokens, cfg)
        uncached = fa.KERNEL_LAUNCHES
        caches = llama.init_cache(cfg, 1)
        cache_gb = 2 * sum(c[0].numel() * 2 for c in caches) / 1e9
        ld, _ = llama.forward(params, tokens, cfg, caches, 0)
        cached = fa.KERNEL_LAUNCHES - uncached
        del caches
        with llama_attention(plain_bshd):
            lp, _ = llama.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    if (lk.shape != (1, S, V) or not torch.isfinite(lk).all()
            or not torch.isfinite(ld).all()):
        fail(f"llama logits malformed: {tuple(lk.shape)}")
    ref = {"tokens": tokens[0].tolist(), "last": lk[0, -1].cpu(),
           "argmax": lk[0].argmax(-1).cpu(), "prompt": prompts[128]}
    err, rel, agree = logits_distance(lk, ld)
    p_err, p_rel, p_agree = logits_distance(lp, ld)
    print(f"[llama] forward S={S}: the kernel's output in each of the "
          f"{cfg.n_layer} layers vs the plain version on the same q, k, v: "
          f"max o_err/tol {o_ratio:.3f} (tol {O_RTOL}*|o| + 2^-8*P@|v|, "
          f"must be <= 1)", flush=True)
    print(f"[llama] forward S={S}: logits kernel (uncached) vs dense cached "
          f"branch ({cache_gb:.2f} GB bf16 cache): max abs err {err:.4e} "
          f"(tol {LLAMA_LOGITS_TOL}), ||diff|| / ||logits|| {rel:.4e} (tol "
          f"{LLAMA_LOGITS_REL_TOL}), argmax agrees at {agree:.2%} of "
          f"positions; plain f32 attention (uncached) vs the same: "
          f"{p_err:.4e}, {p_rel:.4e}, {p_agree:.2%}; |logits| max "
          f"{ld.abs().max().item():.3f} std {ld.std().item():.3f}; kernel "
          f"launches: uncached {uncached} (n_layer {cfg.n_layer}), cached "
          f"{cached}", flush=True)
    del lk, ld, lp
    if o_ratio > 1:
        fail("the kernel disagrees with the plain version inside the model")
    if err > LLAMA_LOGITS_TOL or rel > LLAMA_LOGITS_REL_TOL:
        fail("llama logits with the kernel disagree with the dense branch")
    if uncached != cfg.n_layer or cached:
        fail("the uncached forward did not launch the kernel once per "
             "layer, or the cached one launched it")

    # serving through Replica + generate (dense cached attention)
    replica.handle_request({"prompt_tokens": prompts[16],
                            "max_new_tokens": 2})          # warm-up
    before = fa.KERNEL_LAUNCHES

    def request(L, n_new, extra):
        t = time.perf_counter()
        out = replica.handle_request({"prompt_tokens": prompts[L],
                                      "max_new_tokens": n_new, **extra})
        dt = time.perf_counter() - t
        toks = out["tokens"]
        if (len(toks) != L + n_new or toks[:L] != prompts[L]
                or not all(0 <= x < V for x in toks[L:])):
            fail(f"llama request with a {L}-token prompt returned "
                 f"{toks[L:]}")
        return toks, dt

    bound, bound_f32 = decode_bound(params, cfg)
    sampled = {"temperature": 0.8, "seed": seed}
    for label, L, extra in (("greedy", 128, {}), ("greedy", 2000, {}),
                            ("temperature 0.8", 128, sampled)):
        _, prefill = request(L, 1, extra)
        toks, dt = request(L, 32, extra)
        per_token = (dt - prefill) / 31
        print(f"[llama] {label}, prompt {L}: prefill {prefill * 1e3:.1f} ms "
              f"(a one-token request), 32 tokens in {dt * 1e3:.1f} ms = "
              f"{32 / dt:.2f} tokens/s, {per_token * 1e3:.2f} ms per decoded "
              f"token (memory bound {bound:.2f} ms; {bound_f32:.2f} ms with "
              f"the reference's f32 copy of the cache); new tokens "
              f"{toks[L:L + 8]}...", flush=True)
        if label == "greedy" and L == 128:
            ref.update(generated=toks, prefill_ms=prefill * 1e3,
                       per_token_ms=per_token * 1e3)
        if extra:
            again, _ = request(L, 32, extra)
            print(f"[llama] temperature 0.8, seed {seed}: the same tokens "
                  f"again: {again == toks}", flush=True)
            if again != toks:
                fail("sampled generate is not reproducible under one seed")
    launches = fa.KERNEL_LAUNCHES
    print(f"[llama] kernel launches in generate: {launches - before} (must "
          f"be 0: dense cached attention); in the phase's main path: "
          f"{launches}; replica stats {replica.stats()}", flush=True)
    if launches != before:
        fail("generate launched the flash kernel")

    # the uncached forward and a decode step, as issued and as device work
    with torch.inference_mode():
        for S in (2048, 4096):
            x = torch.randint(0, V, (1, S), generator=rng).to("cuda")
            fwd = lambda: llama.forward(params, x, cfg)  # noqa: E731
            wall_ms = time_ms(fwd, iters=5, warmup=2, hold_ms=0)
            dev_ms = time_ms(fwd, iters=5, warmup=1, hold_ms=250)
            tflops = llama_forward_flops(cfg, n, S) / dev_ms / 1e9
            print(f"[llama] uncached forward S={S}, B=1: {wall_ms:.3f} ms as "
                  f"issued, {dev_ms:.3f} ms of device work (CUDA events); "
                  f"device idle {1 - dev_ms / wall_ms:.1%} of the issued "
                  f"time; {tflops:.1f} TFLOP/s", flush=True)
        caches = llama.init_cache(cfg, 1)
        tok = torch.randint(0, V, (1, 1), generator=rng).to("cuda")
        pos = torch.full((1, 1), 2000, device="cuda")

        def step():
            return llama.forward(params, tok, cfg, caches, 2000, pos)

        wall_ms = time_ms(step, iters=10, hold_ms=0)
        # ~2,500 launches a step outrun a held stream: device time from
        # the profiler's trace instead
        dev_ms = print_profile(step, 15 if profile else 0,
                               "llama decode step B=1", calls=3)
        print(f"[llama] decode step (S=1 at position 2000, B=1): "
              f"{wall_ms:.3f} ms as issued (CUDA events), {dev_ms:.3f} ms of "
              f"device work (profiler); memory bound {bound:.3f} ms "
              f"({bound_f32:.3f} with the f32 cache copy)", flush=True)
        if profile:
            print_profile(lambda: llama.forward(params, x[:, :2048], cfg),
                          15, "llama forward S=2048 B=1", calls=2)
        del caches
    print(f"[llama] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; card {card_line()}", flush=True)
    return launches, ref


@contextlib.contextmanager
def moe_probe():
    """Records each MoE FFN call's aux loss, expert choices (T, k), share
    of token-choices kept within capacity and count of those dropped, as
    device tensors."""
    rec = {"aux": [], "idx": [], "kept": [], "dropped": []}
    route, mlp = gpt2._routes, gpt2._moe_mlp

    def route_spy(*args):
        out = route(*args)
        rec["idx"].append(out.idx)
        rec["kept"].append((out.pos < out.capacity).float().mean())
        rec["dropped"].append((out.pos >= out.capacity).sum())
        return out

    def mlp_spy(x, p, cfg):
        y, aux = mlp(x, p, cfg)
        rec["aux"].append(aux.detach())
        return y, aux

    gpt2._routes, gpt2._moe_mlp = route_spy, mlp_spy
    try:
        yield rec
    finally:
        gpt2._routes, gpt2._moe_mlp = route, mlp


@contextlib.contextmanager
def pinned_routes(choices):
    """Each MoE FFN call takes the next of ``choices`` (a list of (T, k)
    expert indices, one per call of an earlier run) in place of its own
    top-k: gate values, capacity and the aux loss follow from them."""
    top_k = gpt2._top_k
    replay = iter(choices)
    gpt2._top_k = lambda probs, k: next(replay)
    try:
        yield
    finally:
        gpt2._top_k = top_k


def phase_moe(seed, profile):
    """GPT-2 124M widths with 8 experts: served in Replica, then trained;
    returns the launches of the requests and of the 10 timed steps."""
    free_memory("moe")
    replica = script_replica("Generator", ("small", "cuda", seed),
                             {"moe_experts": 8})
    gen_obj = replica._callable
    cfg = gen_obj.cfg
    print(f"[moe] GPT2_SMALL with {cfg.moe_experts} experts, top-"
          f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity_factor}: "
          f"{gpt2.num_params(gen_obj.params)} params", flush=True)
    _, prompts = serve_prompts(seed)
    f0, _, _ = serve_requests(replica, gen_obj, prompts, "moe")
    serve_launches = fa.KERNEL_LAUNCHES
    forwards = gen_obj.forwards - f0
    print(f"[moe] kernel launches {serve_launches} = n_layer {cfg.n_layer} "
          f"x forwards {forwards}: "
          f"{serve_launches == cfg.n_layer * forwards}", flush=True)
    if forwards != 32 or serve_launches != cfg.n_layer * forwards:
        fail("the MoE model's requests did not run the kernel once per "
             "layer per forward")
    if profile:
        x = torch.tensor([prompts[1000]], device="cuda")
        with torch.inference_mode():
            print_profile(lambda: gpt2.forward(gen_obj.params, x, cfg), 15,
                          "moe forward S=1000 B=1", calls=3)
    del replica, gen_obj

    B, S, steps = 16, 1024, 10
    params, tokens = train_setup(cfg, seed, B, S)
    names = [n for n, _ in gpt2.named_leaves(params)]
    small = {"tokens": tokens[:4]}
    dense_cfg = replace(cfg, attention="dense")
    with moe_probe() as kernel_rec:
        kernels = loss_and_grads(params, small, cfg)
    with torch.no_grad(), moe_probe() as dense_rec:
        gpt2.loss_fn(gpt2._cast_weights(params, cfg.compute_dtype), small,
                     dense_cfg)
    moved = torch.stack([(a != b).float().mean() for a, b in
                         zip(kernel_rec["idx"], dense_rec["idx"])])
    print(f"[moe] token-choices routed to another expert with dense "
          f"attention, per layer: "
          f"{' '.join(f'{x:.4f}' for x in moved.tolist())}", flush=True)
    compare_grads("moe", f"determinism, B=4 S={S}: kernels vs the same "
                  "again", names, kernels, loss_and_grads(params, small, cfg))
    with pinned_routes(kernel_rec["idx"]):
        dense = loss_and_grads(params, small, dense_cfg)
    compare_grads("moe", f"gradient check B=4 S={S}, kernels vs dense with "
                  "the kernels' expert choices", names, kernels, dense,
                  MOE_LOSS_TOL, MOE_GRAD_REL_TOL)
    del kernels, dense

    step = gpt2.make_train_step(cfg, adamw(params))
    torch.cuda.reset_peak_memory_stats()
    with moe_probe() as rec:
        losses, ms, launches, _ = timed_steps(step, params,
                                              {"tokens": tokens}, steps)
    L = cfg.n_layer
    aux = torch.stack(rec["aux"]).view(steps + 1, L).mean(1).tolist()
    dropped = (1 - torch.stack(rec["kept"]).view(steps + 1, L).mean(1)
               ).tolist()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tok_s = B * S / (ms / 1e3)
    SINGLE_RANK_STEPS["moe"] = (ms, peak_gb)
    print(f"[moe] losses {' '.join(f'{x:.4f}' for x in losses)}; aux loss "
          f"(mean over layers) {' '.join(f'{x:.4f}' for x in aux)}; "
          f"token-choices dropped at capacity "
          f"{' '.join(f'{x:.4f}' for x in dropped)}", flush=True)
    print(f"[moe] B={B} S={S}: {ms:.3f} ms per step (CUDA events over "
          f"{steps} steps), {tok_s:.1f} tokens/s, peak memory {peak_gb:.2f} "
          f"GB; launches {launches} (n_layer {L} x {steps} each); card "
          f"{card_line()}", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"MoE train losses not finite or not falling: {losses}")
    if any(n != L * steps for n in launches.values()):
        fail("an MoE train step did not launch each kernel once per layer")
    if profile:
        print_profile(lambda: step(params, {"tokens": tokens}), 30,
                      f"moe train step B={B} S={S}", calls=2)
    return serve_launches, launches


def phase_xl(seed, profile):
    """GPT-2 XL with remat: its gates at B=1, then timed steps at B=16,
    S=1024 with the dense head and with 8 chunks, then one step at B=4
    without remat; returns the launches of the timed steps."""
    free_memory("xl")
    cfg = replace(gpt2.GPT2_XL, remat=True)
    B, S, steps = 16, 1024, 3
    params, tokens = train_setup(cfg, seed, B, S)
    names = [n for n, _ in gpt2.named_leaves(params)]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"[xl] GPT2_XL: {gpt2.num_params(params)} params, remat on; "
          f"memory in use {torch.cuda.memory_allocated() / 1e9:.2f} GB of "
          f"{total_gb:.2f}", flush=True)
    one = {"tokens": tokens[:1]}
    remat = loss_and_grads(params, one, cfg)
    compare_grads("xl", f"B=1 S={S}, remat vs no remat", names, remat,
                  loss_and_grads(params, one, replace(cfg, remat=False)),
                  REMAT_LOSS_TOL, REMAT_GRAD_REL_TOL)
    compare_grads("xl", f"B=1 S={S}, xent_chunks=8 vs the dense head",
                  names, loss_and_grads(params, one, cfg, 8), remat,
                  CHUNK_LOSS_TOL, CHUNK_GRAD_REL_TOL)
    del remat

    # a fresh AdamW moves every weight by ~lr a step, without warm-up; the
    # 124M step at 3e-4 already rises once in its first 4 steps (phase 4),
    # and GPT-3 trained its 1.3B model at 2e-4: XL takes 1e-4
    opt = adamw(params, lr=1e-4)
    L, launches = cfg.n_layer, {}
    flops = gpt2.count_flops_per_token(cfg, S)
    for chunks in (0, 8):
        step = gpt2.make_train_step(cfg, opt, xent_chunks=chunks)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, run, warm_s = timed_steps(step, params,
                                              {"tokens": tokens}, steps)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tok_s = B * S / (ms / 1e3)
        head = f"xent_chunks={chunks}" if chunks else "dense head"
        print(f"[xl] {head}: losses {' '.join(f'{x:.4f}' for x in losses)} "
              f"(warm-up {warm_s:.2f} s); B={B} S={S}: {ms:.3f} ms per step "
              f"(CUDA events over {steps} steps), {tok_s:.1f} tokens/s, MFU "
              f"{tok_s * flops / PEAK_BF16_FLOPS:.4f}, peak memory "
              f"{peak_gb:.2f} GB; launches {run}; card {card_line()}",
              flush=True)
        if not all(math.isfinite(x) for x in losses) \
                or losses[-1] >= losses[0]:
            fail(f"XL losses not finite or not falling: {losses}")
        if run != {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                   "flash_bwd_dkv": L * steps}:
            fail("an XL step under remat did not launch the forward twice "
                 "and each backward kernel once per layer")
        if peak_gb >= total_gb:
            fail("XL peak memory is not below the card's")
        if not chunks:
            SINGLE_RANK_STEPS["xl"] = (ms, peak_gb)
        launches = {k: launches.get(k, 0) + n for k, n in run.items()}
        if profile:
            print_profile(lambda: step(params, {"tokens": tokens}), 30,
                          f"xl train step, {head}, B={B} S={S}")

    step = gpt2.make_train_step(replace(cfg, remat=False), opt)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    try:
        loss = f"{step(params, {'tokens': tokens[:4]})['loss'].item():.4f}"
    except torch.cuda.OutOfMemoryError:
        loss = "out of memory"
    print(f"[xl] one step without remat at B=4 S={S}: loss {loss}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{held_gb:.2f} GB of it held between steps (f32 weights and "
          f"AdamW moments)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: sequence parallelism
# ---------------------------------------------------------------------------

#: n_layer of every timed run of GPT-2 124M's widths (or its MoE's) over
#: two or four ranks in phases 8-13; the checks keep GPT-2 124M's 12, and
#: GPT-2 XL at fsdp = 2 its 48 for its memory gate.  The script's phases
#: took 664-667 s of its 1200 s limit on an H100 80GB HBM3 (700.00 W) with
#: every run at 12, and 572.8-670.5 s with the two-rank runs at 12 and the
#: Train phases; width, batch, sequence and the 5 timed steps stay
FOUR_RANK_DEPTH = 4


def _then_free(fn, args):
    """A rank's task, then its cached device memory released: the idle
    pool's ranks must not hold the card's memory while the other pool's
    run."""
    try:
        return fn(*args)
    finally:
        gc.collect()
        torch.cuda.empty_cache()


class CardPool(RankPool):
    """A ``RankPool`` of ranks on cuda:0 in one gloo group (NCCL refuses
    two ranks on one card) whose every task releases its cached device
    memory after it (``_then_free``).  Phases 8-13 share one pool of 2
    ranks and one of 4: a pool takes ~8 s to come up."""

    def __init__(self, n, rendezvous):
        super().__init__(n, f"file://{rendezvous}", backend="gloo",
                         device="cuda:0", timeout_s=600.0)

    def run(self, fn, *args, timeout_s=None):
        return super().run(_then_free, fn, args, timeout_s=timeout_s)


def start_pools(tmp):
    """Phases 8-13's pools, {2: CardPool, 4: CardPool}, rendezvous in
    ``tmp``."""
    pools = {}
    for n in (2, 4):
        t0 = time.perf_counter()
        pools[n] = CardPool(n, f"{tmp}/rendezvous{n}")
        print(f"[ranks] {n} ranks on cuda:0 up in "
              f"{time.perf_counter() - t0:.2f} s; one gloo group; the pool "
              f"serves phases 8-13", flush=True)
    return pools


#: ranks of phase 8's process groups, all on cuda:0
SP_WORLDS = (2, 4)
#: timed train steps a configuration of phase 8 takes after its warm-up
SP_STEPS = 5
#: (B, S) of phase 8's GPT-2 gradient check and of its training
SP_CHECK_BATCH = (4, 1024)
SP_TRAIN_BATCH = (16, 1024)
def sp_mesh():
    """The ranks' mesh: one sp axis over every rank of the group."""
    return ShardingConfig(sp=dist.get_world_size()).build_mesh()


def sp_inputs(seed):
    """Phase 8's global q, k, v and do: (B, H, S, D) of TRAIN_SHAPE, bf16
    on the card, from ``seed`` (the same on every rank)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    return [torch.randn(TRAIN_SHAPE, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(4)]


def hop_counts():
    return (collective.HOPS, collective.HOST_STAGED_HOPS,
            collective.HOST_STAGED_BYTES)


def sp_attention_rank(seed, variant, causal):
    """A rank's o, dq, dk, dv of ring or Ulysses attention on its chunks
    of ``sp_inputs`` (on the host), with its launches and hops."""
    set_precision()
    mesh = sp_mesh()
    q, k, v, do = (seq_shard(t, mesh, dim=2) for t in sp_inputs(seed))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    reset_launches()
    h0 = hop_counts()
    o = ra.ring_attention_sharded(q, k, v, mesh, causal, variant=variant)
    o.backward(do)
    torch.cuda.synchronize()
    return {"out": [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)],
            "launches": read_launches(),
            "hops": [b - a for a, b in zip(h0, hop_counts())]}


def sp_attention_errors(inputs, causal, got):
    """Largest err/tol of ring or Ulysses attention's o, dq, dk, dv
    (``got``, gathered over the ranks) on ``inputs`` (q, k, v, do):
    (against the plain versions, against the single-rank kernels, equal to
    the kernels bit for bit), each a list over o, dq, dk, dv.  o is held
    against the plain forward, dq, dk, dv against the plain backward on
    the same o (as phase 2b holds the kernels on their own o: delta =
    rowsum(do * o) moves with o's rounding), with phases 2 and 2b's
    tolerances; against the kernels within the sum of both sides'
    tolerances and, for the gradients, the plain backward's own change
    between the two o."""
    q, k, v, do = inputs
    scale = q.shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal)
    o.backward(do)
    kernel = [o.detach()] + [t.grad for t in leaves]
    o_p, lse_p = fa._reference_attention(q, k, v, scale, causal)
    o_mag, _ = fa._reference_attention(q, k, v.abs(), scale, causal)
    o_p, o_mag = o_p.float(), o_mag.float()
    tol = O_RTOL * o_p.abs() + O_PTOL * o_mag
    vs_plain = [((got[0].float() - o_p).abs() / tol).max().item()]
    vs_kernel = [((got[0].float() - kernel[0].float()).abs()
                  / (2 * tol)).max().item()]

    def plain_bwd(o):
        return (fa._reference_attention_bwd(q, k, v, o, lse_p, do, scale,
                                            causal),
                bwd_magnitudes(q, k, v, o, lse_p, do, scale, causal))

    (gp, mags), (gpk, mags_k) = plain_bwd(got[0]), plain_bwd(kernel[0])
    for i, name in enumerate(("dq", "dk", "dv")):
        g, gk = got[i + 1].float(), kernel[i + 1].float()
        tol = G_RTOL * gp[i].float().abs() + G_PTOL[name] * mags[i]
        tol_k = G_RTOL * gpk[i].float().abs() + G_PTOL[name] * mags_k[i]
        shift = (gp[i].float() - gpk[i].float()).abs()
        vs_plain.append(((g - gp[i].float()).abs() / tol).max().item())
        vs_kernel.append(((g - gk).abs() / (tol + tol_k + shift)).max()
                         .item())
    return vs_plain, vs_kernel, [torch.equal(x, y) for x, y in zip(got,
                                                                   kernel)]


def sp_check_attention(pool, n, seed, variant, causal):
    """Ring or Ulysses attention over n ranks, gathered, against the plain
    versions and the single-rank kernels (``sp_attention_errors``)."""
    res = pool.run(sp_attention_rank, seed, variant, causal)
    got = [torch.cat([r["out"][i] for r in res], dim=2).cuda()
           for i in range(4)]
    vs_plain, vs_kernel, same = sp_attention_errors(sp_inputs(seed), causal,
                                                    got)
    names = ("o", "dq", "dk", "dv")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}
    hops = [sum(r["hops"][i] for r in res) for i in range(3)]
    ok = max(vs_plain + vs_kernel) <= 1
    print(f"[sp] {variant} sp={n} causal={int(causal)} B,H,S,D="
          f"{TRAIN_SHAPE}: max err/tol vs plain "
          + " ".join(f"{a}={b:.3f}" for a, b in zip(names, vs_plain))
          + " vs the single-rank kernels "
          + " ".join(f"{a}={b:.3f}" for a, b in zip(names, vs_kernel))
          + " (must be <= 1; tol phases 2 and 2b's"
          "; vs the kernels: the sum of both tolerances and of the plain "
          "backward's change between the two o); equal to the single-rank "
          f"kernels bit for bit: {dict(zip(names, same))}; launches over "
          f"the ranks {launches}; hops {hops[0]} ({hops[1]} host-staged, "
          f"{hops[2] / 1e6:.1f} MB)"
          f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
    if not ok:
        fail(f"{variant} attention at sp={n} causal={causal} disagrees")


def sp_chunk_checks(seed):
    """Each ring step's kernels on the chunks of ``sp_inputs`` at sp = 2
    and 4 against their plain versions: the diagonal (causal) step and an
    off-diagonal (non-causal) one of the last chunk, forward, and backward
    with the global lse, o and delta of the whole attention."""
    q, k, v, do = sp_inputs(seed)
    scale = q.shape[-1] ** -0.5
    o, (_, _, _, _, lse) = fa._flash_fwd(q, k, v, True, None, None, None)
    delta = (do.float() * o.float()).sum(-1)
    S = q.shape[2]
    for n in SP_WORLDS:
        c = S // n

        def chunk(t, j):
            return t.narrow(2, j * c, c)

        qr, orr, dor, lser, deltar = (chunk(t, n - 1)
                                      for t in (q, o, do, lse, delta))
        for label, j, diag in (("diagonal, causal", n - 1, True),
                               ("off-diagonal, full", 0, False)):
            ks, vs = chunk(k, j), chunk(v, j)
            o_i, lse_i = ra._chunk_fwd(qr, ks, vs, scale, diag)
            o_ref, lse_ref = fa._reference_attention(qr, ks, vs, scale, diag)
            o_mag, _ = fa._reference_attention(qr, ks, vs.abs(), scale, diag)
            grads = ra._chunk_bwd(qr, ks, vs, orr, lser, dor, scale, diag,
                                  deltar)
            ref = fa._reference_attention_bwd(qr, ks, vs, orr, lser, dor,
                                              scale, diag, deltar)
            mags = bwd_magnitudes(qr, ks, vs, orr, lser, dor, scale, diag)
            torch.cuda.synchronize()
            o_tol = O_RTOL * o_ref.float().abs() + O_PTOL * o_mag.float()
            ratios = {"o": ((o_i - o_ref.float()).abs() / o_tol).max().item()}
            for name, g, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
                tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
                ratios[name] = ((g.float() - r.float()).abs()
                                / tol).max().item()
            lse_err = (lse_i - lse_ref).abs().max().item()
            ok = max(ratios.values()) <= 1 and lse_err <= LSE_TOL
            print(f"[sp] ring step kernels, sp={n} chunk (B,H,S,D)="
                  f"{tuple(qr.shape)}, {label}, backward with the global "
                  f"lse and delta: max err/tol "
                  + " ".join(f"{a}={b:.3f}" for a, b in ratios.items())
                  + f" lse_err={lse_err:.3e} (phases 2 and 2b's "
                  f"tolerances){'' if ok else '  <-- OUT OF TOLERANCE'}",
                  flush=True)
            if not ok:
                fail(f"a ring step's kernels disagree with plain at sp={n}, "
                     f"{label}")


def sp_gpt2_rank(seed, variant):
    """GPT-2 124M at SP_CHECK_BATCH with ``variant`` over the ranks against
    the single-rank kernels on the same rank: the logits of its chunk, and
    the loss and every leaf's gradient summed over the ranks."""
    set_precision()
    mesh = sp_mesh()
    cfg = replace(gpt2.GPT2_SMALL, attention=variant)
    params, tokens = train_setup(cfg, seed, *SP_CHECK_BATCH)
    with torch.no_grad():
        with use_mesh(mesh):
            logits = gpt2.forward(params, seq_shard(tokens[:, :-1], mesh),
                                  cfg)
        ref = seq_shard(gpt2.forward(params, tokens[:, :-1],
                                     gpt2.GPT2_SMALL), mesh)
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item()}
    del logits, ref
    with use_mesh(mesh):
        loss, grads = loss_and_grads(
            params, {"tokens": seq_shard(tokens, mesh, overlap=1)}, cfg)
        flat = c10d.allreduce(torch.cat([g.reshape(-1) for g in grads]), "sp")
    grads = flat.split([g.numel() for g in grads])
    ref_loss, ref_grads = loss_and_grads(params, {"tokens": tokens},
                                         gpt2.GPT2_SMALL)
    out.update(loss=loss, ref_loss=ref_loss,
               rel=[((g.view_as(r) - r).norm() / r.norm()).item()
                    for g, r in zip(grads, ref_grads)],
               names=[n for n, _ in gpt2.named_leaves(params)])
    return out


def sp_check_gpt2(pool, n, seed, variant):
    res = pool.run(sp_gpt2_rank, seed, variant)
    err = max(r["logits_err"] for r in res)
    r0 = res[0]
    B, S = SP_CHECK_BATCH
    shape = (B, S // n, gpt2.GPT2_SMALL.vocab_size)
    print(f"[sp] GPT2_SMALL {variant} sp={n} B={B} S={S}: each rank's logits "
          f"{r0['shape']} vs the single-rank kernels' on its positions: max "
          f"abs err {err:.4e} (tol {LOGITS_TOL})", flush=True)
    if any(r["shape"] != shape or not r["finite"] for r in res) \
            or err > LOGITS_TOL:
        fail(f"GPT-2 logits with {variant} at sp={n} malformed or apart")
    rel = r0["rel"]
    i = max(range(len(rel)), key=rel.__getitem__)
    d = abs(r0["loss"] - r0["ref_loss"])
    print(f"[sp] GPT2_SMALL {variant} sp={n} B={B} S={S}: loss {r0['loss']:.6f}"
          f" vs single-rank kernels {r0['ref_loss']:.6f} |diff| {d:.3e} (tol "
          f"{TRAIN_LOSS_TOL}); largest ||g - g_ref|| / ||g_ref|| over the "
          f"{len(rel)} leaves (gradients summed over the ranks) "
          f"{rel[i]:.3e} at {r0['names'][i]} (tol {TRAIN_GRAD_REL_TOL}); "
          f"median {sorted(rel)[len(rel) // 2]:.3e}", flush=True)
    if d > TRAIN_LOSS_TOL or rel[i] > TRAIN_GRAD_REL_TOL:
        fail(f"GPT-2 loss or gradients with {variant} at sp={n} disagree")


def params_digest(params) -> str:
    """sha256 of every leaf's bytes, in ``named_leaves`` order."""
    h = hashlib.sha256()
    for leaf in gpt2.param_leaves(params):
        h.update(leaf.detach().float().contiguous().cpu().numpy())
    return h.hexdigest()


def sp_train_rank(seed, variant, steps, n_layer):
    """A warm-up and ``steps`` timed AdamW steps of GPT-2 124M's widths at
    ``n_layer`` layers at SP_TRAIN_BATCH over the ranks (each its (B, S/n +
    1) chunk of one batch): losses, ms per step (CUDA events), the
    transport's share of it, peak memory, launches, hops and a digest of
    the parameters after them."""
    set_precision()
    mesh = sp_mesh()
    cfg = replace(gpt2.GPT2_SMALL, attention=variant, n_layer=n_layer)
    params, tokens = train_setup(cfg, seed, *SP_TRAIN_BATCH)
    batch = {"tokens": seq_shard(tokens, mesh, overlap=1)}
    step = gpt2.make_train_step(cfg, adamw(params))
    with use_mesh(mesh):
        t0 = time.perf_counter()
        first = step(params, batch)["loss"].item()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launches()
        h0 = hop_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with collective.timing() as comm:
            start.record()
            out = [step(params, batch)["loss"] for _ in range(steps)]
            end.record()
            split = {k: (a / steps, b / steps)
                     for k, (a, b) in comm.split_ms().items()}
        launches = read_launches()
        hops = [b - a for a, b in zip(h0, hop_counts())]
    return {"losses": [first] + [x.item() for x in out], "warm_s": warm_s,
            "ms": start.elapsed_time(end) / steps, "split": split,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "hops": hops,
            "digest": params_digest(params)}


def sp_train(pool, n, seed, variant):
    """Phase 8's training in one configuration; returns the launches of
    the timed steps summed over the ranks."""
    L = FOUR_RANK_DEPTH
    res = pool.run(sp_train_rank, seed, variant, SP_STEPS, L)
    r0 = res[0]
    B, S = SP_TRAIN_BATCH
    launches = {k: sum(r["launches"][k] for r in res)
                for k in r0["launches"]}
    want = (n * (n + 1) // 2 if variant == "ring" else n) * L * SP_STEPS
    print(f"[sp] train {variant} sp={n} B={B} S={S} n_layer={L}: losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])} (warm-up "
          f"{r0['warm_s']:.2f} s); rank 0 {r0['ms']:.3f} ms per step (CUDA "
          f"events over {SP_STEPS} steps), {B * S / (r0['ms'] / 1e3):.1f} "
          f"tokens/s over the ranks; card {card_line()}", flush=True)
    for rank, r in enumerate(res):
        comm, blocked = r["split"]["all"]
        kinds = ", ".join(f"{k} {a:.3f} ({b:.3f} blocked)"
                          for k, (a, b) in r["split"].items() if k != "all")
        print(f"[sp]   rank {rank}: {r['ms']:.3f} ms per step = "
              f"{r['ms'] - comm:.3f} with no transport call in flight "
              f"(host dispatch and idle gaps included) + {comm:.3f} with "
              f"one in flight (the "
              f"union of the CUDA-event spans of the transport's calls, "
              f"kernels hidden behind them included), during which the host "
              f"was blocked on gloo or a peer {blocked:.3f}; by kind: {kinds}"
              f"; {r['hops'][0] / SP_STEPS:.0f} hops a step "
              f"({r['hops'][1] / SP_STEPS:.0f} host-staged, "
              f"{r['hops'][2] / SP_STEPS / 1e6:.1f} MB); peak memory "
              f"{r['peak_gb']:.2f} GB", flush=True)
    print(f"[sp] train {variant} sp={n}: launches over the ranks in "
          f"{SP_STEPS} steps {launches} (want {want} of each: "
          + ("n(n+1)/2" if variant == "ring" else "n")
          + f" x n_layer {L} a step); parameters equal bit for bit on every "
          f"rank: {len({r['digest'] for r in res}) == 1}", flush=True)
    losses = r0["losses"]
    if any(r["losses"] != losses for r in res):
        fail(f"sp={n} {variant}: the ranks' losses differ")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"sp={n} {variant} train losses not finite or not falling")
    if any(x != want for x in launches.values()):
        fail(f"sp={n} {variant}: launches {launches}, want {want} of each")
    if len({r["digest"] for r in res}) != 1:
        fail(f"sp={n} {variant}: the ranks' parameters differ")
    return launches


def phase_sp(seed, pools):
    """Sequence parallelism: ring and Ulysses attention, GPT-2 124M's
    logits and gradients and its training over 2 and 4 ranks that share
    the card (``pools``: one gloo group each; each rank a spawned process
    on cuda:0).  Returns the launches of the training runs, by
    configuration."""
    free_memory("sp")
    sp_chunk_checks(seed)
    launches = {}
    for n in SP_WORLDS:
        pool = pools[n]
        print(f"[sp] {n} ranks: all-reduce and all-to-all pass CUDA tensors "
              "to gloo, which stages them through host memory itself; the "
              "ring's hops (send/recv, which gloo cannot take from the card) "
              "are staged through pinned host buffers by "
              "ray_tpu_torch.collective._host_staged_buffers", flush=True)
        for variant in ("ring", "ulysses"):
            for causal in (True, False):
                sp_check_attention(pool, n, seed, variant, causal)
        if n == 2:
            for variant in ("ring", "ulysses"):
                sp_check_gpt2(pool, n, seed, variant)
        for variant in ("ring", "ulysses") if n == 2 else ("ring",):
            launches[f"sp_{variant}{n}"] = sp_train(pool, n, seed, variant)
    return launches


# ---------------------------------------------------------------------------
# phase 9: pipeline parallelism (with data parallelism)
# ---------------------------------------------------------------------------

#: (B, S) of phase 9's checks and of its training
PP_CHECK_BATCH = (8, 1024)
PP_TRAIN_BATCH = (16, 1024)
#: timed train steps a configuration of phase 9 takes after its warm-up
PP_STEPS = 5


def pp_setup(cfg, seed, batch, dp=1):
    """The ranks' (dp, pp) mesh, the f32 master parameters from ``seed``
    (the same on every rank) and the rank's stage of their pipeline tree
    (every leaf requiring grad), and the (B, S+1) tokens."""
    n = dist.get_world_size()
    config = ShardingConfig(dp=dp, pp=n // dp)
    mesh = config.build_mesh()
    params, tokens = train_setup(cfg, seed, *batch)
    with torch.no_grad():
        stage = shard_params(gpt2.to_pipeline_params(params, cfg), config,
                             mesh)
    for leaf in gpt2.param_leaves(stage):
        leaf.requires_grad_(True)
    return mesh, params, stage, tokens


def pp_stage_refs(mesh, ref, cfg):
    """{name: reference} of every leaf of a stage's tree from the
    sequential tree's {name: tensor}: a stacked leaf is the rank's layers'
    entries stacked."""
    n = mesh_axis_size(mesh, "pp")
    c = cfg.n_layer // n
    first = mesh.get_local_rank("pp") * c
    out = {k: v for k, v in ref.items() if not k.startswith("h_")}
    for name in {k.split("/", 1)[1] for k in ref if k.startswith("h_")}:
        out[f"blocks/{name}"] = torch.stack(
            [ref[f"h_{first + i}/{name}"] for i in range(c)])
    return out


def pp_grad_errors(stage, mesh, names, ref_grads, cfg):
    """||g - g_ref|| / ||g_ref|| of every leaf of the stage (gradients in
    ``.grad``, summed as the train step sums them) against the single-rank
    gradients of the same leaves."""
    refs = pp_stage_refs(mesh, dict(zip(names, ref_grads)), cfg)
    return {name: ((t.grad - refs[name]).norm() / refs[name].norm()).item()
            for name, t in gpt2.named_leaves(stage)}


def pp_check_rank(seed, M):
    """GPT-2 124M at PP_CHECK_BATCH through the pipeline over the ranks
    against the single-rank kernels on the same rank: the rank's rows of
    logits, the loss and every leaf's gradient."""
    set_precision()
    cfg = gpt2.GPT2_SMALL
    mesh, params, stage, tokens = pp_setup(cfg, seed, PP_CHECK_BATCH)
    names = [n for n, _ in gpt2.named_leaves(params)]
    n = mesh_axis_size(mesh, "pp")
    inputs = tokens[:, :-1]
    with torch.no_grad():
        ref = gpt2.forward(params, inputs, cfg)
        with use_mesh(mesh):
            logits = gpt2.forward(stage, inputs, cfg, None, M)
    if M % n == 0:
        ref = ref.view(n, -1, *ref.shape[1:])[mesh.get_local_rank("pp")]
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item(),
           "bitwise": torch.equal(logits, ref)}
    del logits, ref
    ref_loss, ref_grads = loss_and_grads(params, {"tokens": tokens}, cfg)
    with use_mesh(mesh):
        loss = gpt2.loss_fn(gpt2._cast_weights(stage, cfg.compute_dtype),
                            {"tokens": tokens}, cfg, M)
        loss.backward()
        gpt2._sum_grads(stage, cfg)
    out.update(loss=loss.item(), ref_loss=ref_loss,
               rel=pp_grad_errors(stage, mesh, names, ref_grads, cfg))
    return out


def pp_check_gpt2(pool, n, seed, M):
    res = pool.run(pp_check_rank, seed, M)
    B, S = PP_CHECK_BATCH
    rows = B // n if M % n == 0 else B
    shape = (rows, S, gpt2.GPT2_SMALL.vocab_size)
    err = max(r["logits_err"] for r in res)
    print(f"[pp] GPT2_SMALL pp={n} M={M} B={B} S={S}: each rank's logits "
          f"{res[0]['shape']} ({'its rows' if M % n == 0 else 'every row'})"
          f" vs the single-rank kernels': max abs err {err:.4e} (tol "
          f"{LOGITS_TOL}); equal bit for bit on every rank: "
          f"{all(r['bitwise'] for r in res)}", flush=True)
    if any(r["shape"] != shape or not r["finite"] for r in res) \
            or err > LOGITS_TOL:
        fail(f"GPT-2 logits at pp={n} M={M} malformed or apart")
    pp_hold_grads(res, f"GPT2_SMALL pp={n} M={M} B={B} S={S}",
                  "single-rank kernels")


def pp_hold_grads(res, what, against, tag="pp",
                  leaves="stage slices vs their layers; the others summed "
                  "over pp as the step sums them"):
    """Print and hold every rank's loss and per-leaf gradient errors."""
    d = max(abs(r["loss"] - r["ref_loss"]) for r in res)
    rel = {f"rank {i} {k}": v for i, r in enumerate(res)
           for k, v in r["rel"].items()}
    worst = max(rel, key=rel.get)
    print(f"[{tag}] {what}: loss {res[0]['loss']:.6f} vs {against} "
          f"{res[0]['ref_loss']:.6f}, largest |diff| over the ranks "
          f"{d:.3e} (tol {TRAIN_LOSS_TOL}); largest ||g - g_ref|| / "
          f"||g_ref|| over the ranks' {len(rel)} leaves ({leaves}) "
          f"{rel[worst]:.3e} at {worst} (tol {TRAIN_GRAD_REL_TOL}); "
          f"median {sorted(rel.values())[len(rel) // 2]:.3e}", flush=True)
    if any(r["loss"] != res[0]["loss"] for r in res):
        fail(f"{what}: the ranks' losses differ")
    if d > TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL_TOL:
        fail(f"{what}: loss or gradients disagree with the {against}")


def pp_moe_reference(params, tokens, cfg, M, routes=None):
    """The single-rank MoE model run microbatch by microbatch (JAX's
    function under pp: each microbatch routes with its own capacity, the
    aux averaged over microbatches): (loss, gradients, the expert choices
    of each (microbatch, layer)); ``routes`` replays given choices."""
    cast = gpt2._cast_weights(params, cfg.compute_dtype)
    pin = pinned_routes(routes) if routes is not None \
        else contextlib.nullcontext()
    with pin, moe_probe() as rec:
        loss = sum(gpt2.loss_fn(cast, {"tokens": t}, cfg)
                   for t in tokens.chunk(M)) / M
    grads = torch.autograd.grad(loss, gpt2.param_leaves(params))
    return loss.item(), grads, rec["idx"]


def pp_moe_rank(seed, M):
    """The MoE model at PP_CHECK_BATCH through the pipeline against the
    single-rank model run microbatch by microbatch, with the pipeline's
    routes replayed there if any part."""
    set_precision()
    cfg = replace(gpt2.GPT2_SMALL, moe_experts=8)
    mesh, params, stage, tokens = pp_setup(cfg, seed, PP_CHECK_BATCH)
    names = [n for n, _ in gpt2.named_leaves(params)]
    with use_mesh(mesh), moe_probe() as rec:
        loss = gpt2.loss_fn(gpt2._cast_weights(stage, cfg.compute_dtype),
                            {"tokens": tokens}, cfg, M)
        loss.backward()
        gpt2._sum_grads(stage, cfg)
        # the forward's choices, (M, stage layers) in order; every stage's
        # gathered into (M, n_layer)
        c = stage["blocks"]["ln_1"]["scale"].shape[0]
        mine = torch.stack(rec["idx"][:M * c]).view(M, c, *rec["idx"][0]
                                                    .shape)
        every = c10d.allgather(mine, "pp", axis=1)
    routes = list(every.flatten(0, 1))
    ref_loss, ref_grads, ref_idx = pp_moe_reference(params, tokens, cfg, M)
    parted = (torch.stack(ref_idx) != every.flatten(0, 1)).float().mean()
    parted = parted.item()
    if parted:
        ref_loss, ref_grads, _ = pp_moe_reference(params, tokens, cfg, M,
                                                  routes)
    return {"loss": loss.item(), "ref_loss": ref_loss, "parted": parted,
            "rel": pp_grad_errors(stage, mesh, names, ref_grads, cfg)}


def pp_check_moe(pool, n, seed, M):
    res = pool.run(pp_moe_rank, seed, M)
    B, S = PP_CHECK_BATCH
    parted = res[0]["parted"]
    print(f"[pp] MoE (8 experts) pp={n} M={M} B={B} S={S}: share of "
          f"token-choices routed otherwise by the single-rank model run "
          f"microbatch by microbatch {parted:.6f}"
          + (" (replayed: the reference takes the pipeline's choices)"
             if parted else " (no replay)"), flush=True)
    pp_hold_grads(res, f"MoE pp={n} M={M} B={B} S={S}",
                  "single-rank model by microbatch")


def pp_digests(stage):
    """sha256 digests of (the stacked blocks, every other leaf)."""
    out = []
    for keep in (True, False):
        h = hashlib.sha256()
        for name, leaf in gpt2.named_leaves(stage):
            if name.startswith("blocks/") == keep:
                h.update(leaf.detach().float().contiguous().cpu().numpy())
        out.append(h.hexdigest())
    return out


def pp_train_rank(seed, dp, M, moe, steps, n_layer):
    """A warm-up and ``steps`` timed AdamW steps of GPT-2 124M's widths (or
    its MoE's) at ``n_layer`` layers at PP_TRAIN_BATCH over a (dp, pp) mesh
    of the ranks: losses, ms per step (CUDA events), the transport's share
    of it, peak memory, launches, hops and digests of the parameters after
    them."""
    set_precision()
    cfg = replace(gpt2.GPT2_SMALL, moe_experts=8 if moe else 0,
                  n_layer=n_layer)
    mesh, params, stage, tokens = pp_setup(cfg, seed, PP_TRAIN_BATCH, dp)
    del params
    batch = {"tokens": batch_shard(tokens, mesh)}
    step = gpt2.make_train_step(cfg, adamw(stage), M)
    gc.collect()
    torch.cuda.empty_cache()
    with use_mesh(mesh):
        t0 = time.perf_counter()
        first = step(stage, batch)["loss"].item()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launches()
        h0 = hop_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with collective.timing() as comm:
            start.record()
            out = [step(stage, batch)["loss"] for _ in range(steps)]
            end.record()
            split = {k: (a / steps, b / steps)
                     for k, (a, b) in comm.split_ms().items()}
        launches = read_launches()
        hops = [b - a for a, b in zip(h0, hop_counts())]
    return {"losses": [first] + [x.item() for x in out], "warm_s": warm_s,
            "ms": start.elapsed_time(end) / steps, "split": split,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "hops": hops, "digests": pp_digests(stage),
            "pp": mesh.get_local_rank("pp")}


def pp_train(pool, seed, dp, M, moe=False):
    """Phase 9's training in one layout; returns the launches of the timed
    steps summed over the ranks."""
    n = pool.world_size
    L = FOUR_RANK_DEPTH
    res = pool.run(pp_train_rank, seed, dp, M, moe, PP_STEPS, L)
    r0 = res[0]
    pp = n // dp
    B, S = PP_TRAIN_BATCH
    tag = ("MoE " if moe else "") + (f"dp={dp} x " if dp > 1 else "") \
        + f"pp={pp} M={M}" + (f" n_layer={L}" if L != gpt2.GPT2_SMALL.n_layer
                              else "")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in r0["launches"]}
    want = {"flash_fwd": 2 * L * M * dp * PP_STEPS,
            "flash_bwd_dq": L * M * dp * PP_STEPS,
            "flash_bwd_dkv": L * M * dp * PP_STEPS}
    single_ms, single_gb = SINGLE_RANK_STEPS["moe" if moe else "gpt2"]
    bubble = schedule_info(M, pp)["bubble_fraction"]
    print(f"[pp] train {tag} B={B} S={S}: losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])} (warm-up "
          f"{r0['warm_s']:.2f} s); rank 0 {r0['ms']:.3f} ms per step (CUDA "
          f"events over {PP_STEPS} steps), {B * S / (r0['ms'] / 1e3):.1f} "
          f"tokens/s over the ranks (single-rank step, phase "
          f"{6 if moe else 4}: {single_ms:.3f} ms, peak {single_gb:.2f} GB); "
          f"the schedule's bubble fraction {bubble:.4f} "
          f"(schedule_info({M}, {pp})); {n} ranks share one card and hop "
          f"through host memory: these times measure correctness and the "
          f"kernels' work at microbatch shapes, not pipeline speed; card "
          f"{card_line()}", flush=True)
    for rank, r in enumerate(res):
        comm, blocked = r["split"]["all"]
        kinds = ", ".join(f"{k} {a:.3f} ({b:.3f} blocked)"
                          for k, (a, b) in r["split"].items() if k != "all")
        print(f"[pp]   rank {rank} (stage {r['pp']}): {r['ms']:.3f} ms per "
              f"step = {r['ms'] - comm:.3f} with no transport call in "
              f"flight (host dispatch and idle gaps included) + "
              f"{comm:.3f} with one in flight (the union of the CUDA-event "
              f"spans of the transport's calls), during which the host was "
              f"blocked on gloo or a peer {blocked:.3f}; by kind: {kinds}; "
              f"{r['hops'][0] / PP_STEPS:.0f} hops a step "
              f"({r['hops'][1] / PP_STEPS:.0f} host-staged, "
              f"{r['hops'][2] / PP_STEPS / 1e6:.1f} MB sent); peak memory "
              f"{r['peak_gb']:.2f} GB", flush=True)
    stages = {}
    for r in res:
        stages.setdefault(r["pp"], set()).add(r["digests"][0])
    stage_equal = all(len(d) == 1 for d in stages.values())
    rest_equal = len({r["digests"][1] for r in res}) == 1
    print(f"[pp] train {tag}: launches over the ranks in {PP_STEPS} steps "
          f"{launches} (want {want}: 2 x n_layer {L} x M {M} of the forward "
          f"a step and replica, the stage recomputed in the backward, and "
          f"n_layer x M of each backward kernel); stage leaves equal bit for "
          f"bit across dp replicas: {stage_equal}; wte, wpe, ln_f equal bit "
          f"for bit on every rank: {rest_equal}", flush=True)
    losses = r0["losses"]
    if any(r["losses"] != losses for r in res):
        fail(f"{tag}: the ranks' losses differ")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{tag} train losses not finite or not falling")
    if launches != want:
        fail(f"{tag}: launches {launches}, want {want}")
    if not (stage_equal and rest_equal):
        fail(f"{tag}: the ranks' parameters differ")
    return launches


def phase_pp(seed, pools):
    """Pipeline parallelism (with data parallelism): GPT-2 124M's and its
    MoE's logits, loss and gradients and their training over 2 and 4
    ranks that share the card (``pools``).  Returns the launches of the
    training runs, by layout."""
    free_memory("pp")
    print("[pp] the stage hops staged through pinned host buffers, the "
          "reduce-scatter, all-gather and all-reduces passed to gloo",
          flush=True)
    pool = pools[2]
    pp_check_gpt2(pool, 2, seed, 4)
    pp_check_moe(pool, 2, seed, 4)
    launches = {"pp2_m4": pp_train(pool, seed, 1, 4),
                "moe_pp2_m4": pp_train(pool, seed, 1, 4, True)}
    pool = pools[4]
    pp_check_gpt2(pool, 4, seed, 2)
    launches["pp4_m8"] = pp_train(pool, seed, 1, 8)
    launches["dp2_pp2_m4"] = pp_train(pool, seed, 2, 4)
    return launches


# ---------------------------------------------------------------------------
# phase 10: tensor parallelism (alone and with dp, sp, pp)
# ---------------------------------------------------------------------------

#: (B, S) of phase 10's checks and of its training
TP_CHECK_BATCH = (4, 1024)
TP_TRAIN_BATCH = (16, 1024)
#: timed train steps a configuration of phase 10 takes after its warm-up
TP_STEPS = 5


def tp_setup(cfg, seed, batch, axes):
    """The ranks' mesh of ``axes`` and its config, the f32 master
    parameters from ``seed`` (the same on every rank), the rank's shard of
    them (of their pipeline tree under pp; every leaf requiring grad) and
    the (B, S+1) tokens."""
    config = ShardingConfig(**axes)
    mesh = config.build_mesh()
    params, tokens = train_setup(cfg, seed, *batch)
    with torch.no_grad():
        tree = (gpt2.to_pipeline_params(params, cfg) if "pp" in axes
                else params)
        local = shard_params(tree, config, mesh)
    for leaf in gpt2.param_leaves(local):
        leaf.requires_grad_(True)
    return config, mesh, params, local, tokens


def grad_tree(params):
    if isinstance(params, dict):
        return {k: grad_tree(v) for k, v in params.items()}
    return params.grad


def tp_rel(config, mesh, local, names, ref_grads):
    """{name: ||g - g_ref|| / ||g_ref||} of every leaf, the rank's
    gradients (summed as the train step sums them) gathered whole over tp,
    against the single-rank gradients."""
    grads = gpt2.named_leaves(gather_params(grad_tree(local), config, mesh))
    return {name: ((g - r).norm() / r.norm()).item()
            for (name, g), r in zip(grads, ref_grads)}


def tp_check_rank(seed):
    """GPT-2 124M at TP_CHECK_BATCH over tp = 2 against the single-rank
    kernels on the same rank: the logits (gathered over tp), the loss and
    every leaf's gradient (gathered)."""
    set_precision()
    cfg = gpt2.GPT2_SMALL
    config, mesh, params, local, tokens = tp_setup(cfg, seed, TP_CHECK_BATCH,
                                                   {"tp": 2})
    names = [n for n, _ in gpt2.named_leaves(params)]
    inputs = tokens[:, :-1]
    with torch.no_grad():
        ref = gpt2.forward(params, inputs, cfg)
        with use_mesh(mesh):
            logits = gpt2.forward(local, inputs, cfg)
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item(),
           "bitwise": torch.equal(logits, ref)}
    del logits, ref
    ref_loss, ref_grads = loss_and_grads(params, {"tokens": tokens}, cfg)
    with use_mesh(mesh):
        loss = gpt2.loss_fn(gpt2._cast_weights(local, cfg.compute_dtype),
                            {"tokens": tokens}, cfg)
        loss.backward()
        gpt2._sum_grads(local, cfg)
        rel = tp_rel(config, mesh, local, names, ref_grads)
    out.update(loss=loss.item(), ref_loss=ref_loss, rel=rel)
    return out


def tp_check_gpt2(pool, seed):
    res = pool.run(tp_check_rank, seed)
    B, S = TP_CHECK_BATCH
    shape = (B, S, gpt2.GPT2_SMALL.vocab_size)
    err = max(r["logits_err"] for r in res)
    print(f"[tp] GPT2_SMALL tp=2 B={B} S={S}: each rank's logits "
          f"{res[0]['shape']} (its vocabulary block gathered over tp) vs the "
          f"single-rank kernels': max abs err {err:.4e} (tol {LOGITS_TOL}); "
          f"equal bit for bit on every rank: "
          f"{all(r['bitwise'] for r in res)}", flush=True)
    if any(r["shape"] != shape or not r["finite"] for r in res) \
            or err > LOGITS_TOL:
        fail("GPT-2 logits at tp=2 malformed or apart")
    pp_hold_grads(res, f"GPT2_SMALL tp=2 B={B} S={S}", "single-rank kernels",
                  "tp", "gathered over tp; c_attn and c_fc biases summed "
                  "over tp as the step sums them")


def tp_moe_rank(seed):
    """The MoE model at TP_CHECK_BATCH over tp = 2 against the single-rank
    model (its routes replayed there if any part), and the share of
    token-choices that differ between the tp ranks."""
    set_precision()
    cfg = replace(gpt2.GPT2_SMALL, moe_experts=8)
    config, mesh, params, local, tokens = tp_setup(cfg, seed, TP_CHECK_BATCH,
                                                   {"tp": 2})
    names = [n for n, _ in gpt2.named_leaves(params)]
    batch = {"tokens": tokens}
    with use_mesh(mesh), moe_probe() as rec:
        loss = gpt2.loss_fn(gpt2._cast_weights(local, cfg.compute_dtype),
                            batch, cfg)
        loss.backward()
        gpt2._sum_grads(local, cfg)
        mine = torch.stack(rec["idx"])                       # (L, T, k)
        every = c10d.allgather(mine, "tp", tiled=False)      # (tp, L, T, k)
    between = (every != mine).float().mean().item()
    with moe_probe() as ref_rec:
        ref_loss, ref_grads = loss_and_grads(params, batch, cfg)
    parted = (torch.stack(ref_rec["idx"]) != mine).float().mean().item()
    if parted:
        with pinned_routes(list(mine)):
            ref_loss, ref_grads = loss_and_grads(params, batch, cfg)
    with use_mesh(mesh):
        rel = tp_rel(config, mesh, local, names, ref_grads)
    return {"loss": loss.item(), "ref_loss": ref_loss, "between": between,
            "parted": parted, "rel": rel}


def tp_check_moe(pool, seed):
    res = pool.run(tp_moe_rank, seed)
    B, S = TP_CHECK_BATCH
    between = max(r["between"] for r in res)
    parted = res[0]["parted"]
    print(f"[tp] MoE (8 experts) tp=2 B={B} S={S}: share of token-choices "
          f"that differ between the tp ranks {between:.6f} (must be 0); "
          f"routed otherwise by the single-rank model {parted:.6f}"
          + (" (replayed: the reference takes the tp ranks' choices)"
             if parted else " (no replay)"), flush=True)
    if between:
        fail("the tp ranks routed the MoE's tokens differently")
    pp_hold_grads(res, f"MoE tp=2 B={B} S={S}", "single-rank model", "tp",
                  "gathered over tp")


def mesh_digests(config, mesh, local):
    """sha256 digests of the rank's leaves cut on fsdp, tp or ep, of its
    stacked blocks' whole leaves and of every other whole leaf."""
    digests = {k: hashlib.sha256() for k in ("cut", "blocks", "rest")}

    def walk(tree, spec, name):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], spec[k], f"{name}/{k}" if name else k)
            return
        kind = ("cut" if {"fsdp", "tp", "ep"} & set(spec) else "blocks"
                if name.startswith("blocks/") else "rest")
        digests[kind].update(tree.detach().float().contiguous().cpu().numpy())

    walk(local, param_shardings(local, config, mesh), "")
    return [digests[k].hexdigest() for k in ("cut", "blocks", "rest")]


def transport_counts():
    return (dict(collective.SENT_BYTES),) + hop_counts()


def mesh_want(axes, M, L, remat=False):
    """Launches of each kernel a step summed over the ranks: each tp, ep,
    dp and fsdp replica runs the model's layers once (a causal ring over
    sp: n(n+1)/2 chunk steps a layer), under pp in M microbatches with each
    stage recomputed in the backward, under remat each layer's forward
    twice."""
    reps = math.prod(axes.get(a, 1) for a in ("tp", "ep", "dp", "fsdp"))
    n = axes.get("sp", 1)
    per = reps * L * n * (n + 1) // 2
    if "pp" in axes:
        per *= M
    return {"flash_fwd": (2 if remat or "pp" in axes else 1) * per,
            "flash_bwd_dq": per, "flash_bwd_dkv": per}


#: the models of the timed runs over ranks: (config, AdamW's lr, the
#: runs' tag, the phase of the single-rank step); XL trains with remat and
#: phase 7's lr
MESH_MODELS = {"gpt2": (gpt2.GPT2_SMALL, 3e-4, "", 4),
               "moe": (replace(gpt2.GPT2_SMALL, moe_experts=8), 3e-4, "MoE ",
                       6),
               "xl": (replace(gpt2.GPT2_XL, remat=True), 1e-4, "XL remat ",
                      7)}


def mesh_train_rank(seed, axes, M, model, steps, batch_shape, n_layer):
    """A warm-up and ``steps`` timed AdamW steps of ``model`` (a key of
    MESH_MODELS) at ``n_layer`` layers and ``batch_shape`` (B, S) over a
    mesh of ``axes``: losses, ms per step (CUDA events), the transport's
    share of it and its bytes by kind, peak memory, launches, hops and
    digests of the parameters after them."""
    set_precision()
    cfg, lr, _, _ = MESH_MODELS[model]
    cfg = replace(cfg, attention="ring" if "sp" in axes else "flash",
                  n_layer=n_layer)
    config, mesh, params, local, tokens = tp_setup(cfg, seed, batch_shape,
                                                   axes)
    del params
    batch = batch_shard(tokens, mesh)
    if "sp" in axes:
        batch = seq_shard(batch, mesh, overlap=1)
    step = gpt2.make_train_step(cfg, adamw(local, lr), M)
    gc.collect()
    torch.cuda.empty_cache()
    with use_mesh(mesh):
        t0 = time.perf_counter()
        first = step(local, {"tokens": batch})["loss"].item()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_launches()
        c0 = transport_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with collective.timing() as comm:
            start.record()
            out = [step(local, {"tokens": batch})["loss"]
                   for _ in range(steps)]
            end.record()
            split = {k: (a / steps, b / steps)
                     for k, (a, b) in comm.split_ms().items()}
        launches = read_launches()
        c1 = transport_counts()
        digests = mesh_digests(config, mesh, local)
    sent = {k: (v - c0[0].get(k, 0)) / steps for k, v in c1[0].items()
            if v != c0[0].get(k, 0)}
    return {"losses": [first] + [x.item() for x in out], "warm_s": warm_s,
            "ms": start.elapsed_time(end) / steps, "split": split,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "sent": sent,
            "hops": [(b - a) / steps for a, b in zip(c0[1:], c1[1:])],
            "digests": digests,
            "where": {a: mesh.get_local_rank(a) for a in axes}}


def mesh_train(pool, seed, axes, M=1, model="gpt2", phase="tp",
               batch_shape=TP_TRAIN_BATCH, steps=TP_STEPS):
    """Phases 10's to 13's training in one layout, at FOUR_RANK_DEPTH
    layers (XL at its own 48); returns the launches of the timed steps
    summed over the ranks."""
    cfg, _, tag, single_phase = MESH_MODELS[model]
    (B, S) = batch_shape
    L = cfg.n_layer if model == "xl" else FOUR_RANK_DEPTH
    res = pool.run(mesh_train_rank, seed, axes, M, model, steps, batch_shape,
                   L)
    r0 = res[0]
    tag += " x ".join(
        f"{a}={n}" for a, n in axes.items()) + (" ring" if "sp" in axes
                                                else "") \
        + (f" M={M}" if "pp" in axes else "") \
        + (f" n_layer={L}" if L != cfg.n_layer else "")
    bubble = (f"; the schedule's bubble fraction "
              f"{schedule_info(M, axes['pp'])['bubble_fraction']:.4f} "
              f"(schedule_info({M}, {axes['pp']}))" if "pp" in axes else "")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in r0["launches"]}
    want = {k: v * steps for k, v in mesh_want(axes, M, L,
                                                cfg.remat).items()}
    single_ms, single_gb = SINGLE_RANK_STEPS[model]
    tok_s = B * S / (r0["ms"] / 1e3)
    flops = gpt2.count_flops_per_token(cfg, S)
    mfu = (f", MFU {tok_s * flops / PEAK_BF16_FLOPS:.4f}" if model == "xl"
           else "")
    print(f"[{phase}] train {tag} B={B} S={S}: losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])} (warm-up "
          f"{r0['warm_s']:.2f} s); rank 0 {r0['ms']:.3f} ms per step (CUDA "
          f"events over {steps} steps), {tok_s:.1f} tokens/s over the "
          f"ranks{mfu} (single-rank step at B=16, phase {single_phase}: "
          f"{single_ms:.3f} ms, peak {single_gb:.2f} GB){bubble}; "
          f"{len(res)} ranks share one card over gloo: these times measure "
          f"correctness and the kernels' work at the ranks' shapes, not "
          f"the speed of {phase}; card {card_line()}", flush=True)
    for rank, r in enumerate(res):
        comm, blocked = r["split"]["all"]
        kinds = ", ".join(f"{k} {a:.3f} ({b:.3f} blocked)"
                          for k, (a, b) in r["split"].items() if k != "all")
        sent = ", ".join(f"{k} {v / 1e6:.1f}" for k, v in
                         sorted(r["sent"].items()))
        print(f"[{phase}]   rank {rank} {r['where']}: {r['ms']:.3f} ms per "
              f"step "
              f"= {r['ms'] - comm:.3f} with no transport call in flight "
              f"(host dispatch and idle gaps included) + {comm:.3f} with "
              f"one in flight (the union of the CUDA-event spans of the "
              f"transport's calls), during which the host was blocked on "
              f"gloo or a peer {blocked:.3f}; by kind: {kinds}; MB handed to "
              f"the transport a step: {sent}; {r['hops'][0]:.0f} hops a "
              f"step ({r['hops'][1]:.0f} host-staged); peak memory "
              f"{r['peak_gb']:.2f} GB", flush=True)

    def equal(kind, key):
        groups = {}
        for r in res:
            groups.setdefault(key(r["where"]), set()).add(
                r["digests"][kind])
        return all(len(d) == 1 for d in groups.values())

    cut_equal = equal(0, lambda w: (w.get("pp"), w.get("fsdp"), w.get("tp"),
                                    w.get("ep")))
    blocks_equal = equal(1, lambda w: w.get("pp"))
    rest_equal = equal(2, lambda w: None)
    print(f"[{phase}] train {tag}: launches over the ranks in {steps} steps "
          f"{launches} (want {want}); leaves cut on fsdp, tp or ep equal bit "
          f"for bit across the replicas that hold them: {cut_equal}; "
          f"replicated leaves equal bit for bit on every rank (stacked "
          f"blocks: on every rank of a stage): {rest_equal and blocks_equal}",
          flush=True)
    losses = r0["losses"]
    if any(r["losses"] != losses for r in res):
        fail(f"{tag}: the ranks' losses differ")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{tag} train losses not finite or not falling")
    if launches != want:
        fail(f"{tag}: launches {launches}, want {want}")
    if not (cut_equal and blocks_equal and rest_equal):
        fail(f"{tag}: the ranks' parameters differ")
    peak = max(r["peak_gb"] for r in res)
    if model == "xl" and single_gb and peak >= single_gb:
        fail(f"{tag}: peak {peak:.2f} GB a rank is not below the single-rank "
             f"step's {single_gb:.2f} GB")
    return launches


def phase_tp(seed, pools):
    """Tensor parallelism: GPT-2 124M's and its MoE's logits, loss and
    gradients at tp = 2 and their training at tp = 2, MoE tp = 2, dp = 2 x
    tp = 2, tp = 2 x sp = 2 (ring) and pp = 2 x tp = 2 (M = 4), over ranks
    that share the card (``pools``).  Returns the launches of the training
    runs, by layout."""
    free_memory("tp")
    print("[tp] the row-parallel sums, the embedding's sum and the "
          "column-parallel inputs' gradient sums are all-reduces of CUDA "
          "tensors passed to gloo", flush=True)
    pool = pools[2]
    tp_check_gpt2(pool, seed)
    tp_check_moe(pool, seed)
    launches = {"tp2": mesh_train(pool, seed, {"tp": 2}),
                "moe_tp2": mesh_train(pool, seed, {"tp": 2}, model="moe")}
    for key, axes, M in (("dp2_tp2", {"dp": 2, "tp": 2}, 1),
                         ("tp2_sp2_ring", {"sp": 2, "tp": 2}, 1),
                         ("pp2_tp2_m4", {"pp": 2, "tp": 2}, 4)):
        launches[key] = mesh_train(pools[4], seed, axes, M)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the MoE across ranks (experts on ep; the global capacity under
# dp and sp)
# ---------------------------------------------------------------------------

#: (B, S) of phase 11's checks and of its training
EP_CHECK_BATCH = (4, 1024)
EP_TRAIN_BATCH = (16, 1024)
#: dp = 2 x ep = 2 trains at B = 8: at B = 16 its four ranks (8 rows and
#: 4 experts each) stopped answering on an H100 80GB HBM3 (700.00 W), and
#: a rank of dp = 2 at B = 16 peaks at 27.29 GB, one of ep = 2 at 31.74
#: GB: four ranks of about 20 GB leave the card no room
EP_DP_TRAIN_BATCH = (8, 1024)
#: timed train steps a configuration of phase 11 takes after its warm-up
EP_STEPS = 5


def global_routes(mesh, mine, rows):
    """The (L, T, k) expert choices of the global batch in its token order
    (t = b S + s) from each rank's (L, T_rank, k) choices of its ``rows``
    rows and positions: gathered over sp (the chunks of each row side by
    side), then fsdp and dp (the ranks' rows one after another, dp
    major)."""
    L, _, k = mine.shape
    every = mine.view(L, rows, -1, k)
    if mesh_axis_size(mesh, "sp") > 1:
        every = c10d.allgather(every, "sp", axis=2)
    for axis in ("fsdp", "dp"):
        if mesh_axis_size(mesh, axis) > 1:
            every = c10d.allgather(every, axis, axis=1)
    return every.reshape(L, -1, k)


def ep_check_rank(seed, axes, grads):
    """The MoE (8 experts) at EP_CHECK_BATCH over ``axes`` against the
    single-rank model on the same global batch, with the ranks' routes
    replayed there if any part: the rank's logits (its rows and
    positions), the dropped choices of each layer summed over the ranks
    that hold other tokens, the share of token-choices that differ between
    the ranks that hold the same tokens (ep, tp) and, with ``grads``, the
    loss and every leaf's gradient (gathered over ep and tp; the reference's
    on rank 0 only, where the card has room for one)."""
    set_precision()
    cfg = replace(gpt2.GPT2_SMALL, moe_experts=8,
                  attention="ring" if "sp" in axes else "flash")
    config, mesh, params, local, tokens = tp_setup(cfg, seed, EP_CHECK_BATCH,
                                                   axes)
    names = [n for n, _ in gpt2.named_leaves(params)]
    batch = batch_shard(tokens, mesh)
    if "sp" in axes:
        batch = seq_shard(batch, mesh, overlap=1)
    L, rows = cfg.n_layer, batch.shape[0]
    with use_mesh(mesh):
        with torch.no_grad(), moe_probe() as rec:
            logits = gpt2.forward(local, batch[:, :-1], cfg)
        mine = torch.stack(rec["idx"])                          # (L, T, k)
        dropped = torch.stack(rec["dropped"])
        for axis, _ in gpt2._token_axes(cfg):
            dropped = c10d.allreduce(dropped, axis)
        between = 0.0
        for axis in ("ep", "tp"):
            if axis in axes:
                every = c10d.allgather(mine, axis, tiled=False)
                between = max(between, (every != mine).float().mean().item())
        routes = global_routes(mesh, mine, rows)
        if grads:
            with moe_probe() as loss_rec:
                loss = gpt2.loss_fn(gpt2._cast_weights(local,
                                                       cfg.compute_dtype),
                                    {"tokens": batch}, cfg)
            # the loss's own choices: of the weights cast to bf16
            loss_routes = global_routes(mesh, torch.stack(loss_rec["idx"]),
                                        rows)
            loss.backward()
            gpt2._sum_grads(local, cfg)
            whole = gpt2.named_leaves(gather_params(grad_tree(local), config,
                                                    mesh))
    ref_cfg = replace(cfg, attention="flash")
    with torch.no_grad(), moe_probe() as ref_rec:
        ref = gpt2.forward(params, tokens[:, :-1], ref_cfg)
    parted = (torch.stack(ref_rec["idx"]) != routes).float().mean().item()
    if parted:
        with torch.no_grad(), pinned_routes(list(routes)), \
                moe_probe() as ref_rec:
            ref = gpt2.forward(params, tokens[:, :-1], ref_cfg)
    ref_dropped = torch.stack(ref_rec["dropped"])
    ref = batch_shard(ref, mesh)
    if "sp" in axes:
        ref = seq_shard(ref, mesh)
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item(),
           "between": between, "parted": parted,
           "dropped": dropped.tolist(), "ref_dropped": ref_dropped.tolist()}
    del logits, ref
    if grads:
        out["loss"] = loss.item()
        h = hashlib.sha256()
        for _, g in whole:
            h.update(g.float().contiguous().cpu().numpy())
        out["grad_digest"] = h.hexdigest()
        if dist.get_rank() == 0:
            with moe_probe() as ref_rec:
                out["ref_loss"], ref_grads = loss_and_grads(
                    params, {"tokens": tokens}, ref_cfg)
            out["loss_parted"] = (torch.stack(ref_rec["idx"]) != loss_routes
                                  ).float().mean().item()
            if out["loss_parted"]:
                with pinned_routes(list(loss_routes)):
                    out["ref_loss"], ref_grads = loss_and_grads(
                        params, {"tokens": tokens}, ref_cfg)
            out["rel"] = {name: ((g - r).norm() / r.norm()).item()
                          for (name, g), r in zip(whole, ref_grads)}
    return out


def ep_check(pool, seed, axes, grads=False, phase="ep"):
    """Phase 11's check of one layout (``ep_check_rank``), printed and
    held: logits with phase 3's gate, dropped choices equal to the
    single-rank run's, no route parting between the ranks that hold the
    same tokens, and with ``grads`` the loss and gradients with phase 6's
    gates."""
    res = pool.run(ep_check_rank, seed, axes, grads)
    B, S = EP_CHECK_BATCH
    tag = " x ".join(f"{a}={n}" for a, n in axes.items()) + (
        " ring" if "sp" in axes else "")
    rows = B // axes.get("dp", 1) // axes.get("fsdp", 1)
    err = max(r["logits_err"] for r in res)
    between = max(r["between"] for r in res)
    r0 = res[0]
    print(f"[{phase}] MoE (8 experts) {tag} B={B} S={S}: logits "
          f"{r0['shape']} a rank vs the single-rank kernels' on the same "
          f"global batch: max abs err {err:.4e} over the ranks (tol "
          f"{LOGITS_TOL}); routed otherwise by the single-rank model "
          f"{r0['parted']:.6f}"
          + (" (replayed: the reference takes the ranks' choices)"
             if r0["parted"] else " (no replay)")
          + f"; share of token-choices that differ between the ranks holding "
          f"the same tokens {between:.6f} (must be 0)", flush=True)
    print(f"[{phase}] MoE {tag}: choices dropped at capacity per layer, "
          f"summed over the ranks: {r0['dropped']}; single-rank run on the "
          f"same global batch: {r0['ref_dropped']} (must be equal; a capacity "
          f"over each rank's own tokens would drop others)", flush=True)
    if any(r["shape"][:2] != (rows, S // axes.get("sp", 1))
           or not r["finite"] for r in res) or err > LOGITS_TOL:
        fail(f"MoE logits at {tag} malformed or apart")
    if between:
        fail(f"MoE {tag}: ranks that hold the same tokens routed them "
             f"differently")
    if any(r["dropped"] != r["ref_dropped"] for r in res):
        fail(f"MoE {tag}: the dropped choices differ from the single-rank "
             f"run's")
    if not grads:
        return
    ref = res[0]  # the rank that ran the single-rank reference
    d = abs(ref["loss"] - ref["ref_loss"])
    worst = max(ref["rel"], key=ref["rel"].get)
    same = len({r["grad_digest"] for r in res}) == 1
    print(f"[{phase}] MoE {tag} B={B} S={S}: the loss's token-choices routed "
          f"otherwise by the single-rank model {ref['loss_parted']:.6f}"
          + (" (replayed)" if ref["loss_parted"] else " (no replay)")
          + f"; loss {ref['loss']:.6f} vs the "
          f"single-rank model {ref['ref_loss']:.6f}, |diff| {d:.3e} (tol "
          f"{MOE_LOSS_TOL}); largest ||g - g_ref|| / ||g_ref|| over the "
          f"{len(ref['rel'])} leaves (gathered over ep and tp, summed over dp "
          f"and sp as the step sums them) {ref['rel'][worst]:.3e} at {worst} "
          f"(tol {MOE_GRAD_REL_TOL}); median "
          f"{sorted(ref['rel'].values())[len(ref['rel']) // 2]:.3e}; every "
          f"rank's whole gradients equal bit for bit: {same}", flush=True)
    if any(r["loss"] != ref["loss"] for r in res):
        fail(f"MoE {tag}: the ranks' losses differ")
    if d > MOE_LOSS_TOL or ref["rel"][worst] > MOE_GRAD_REL_TOL:
        fail(f"MoE {tag}: loss or gradients disagree with the single-rank "
             f"model")
    if not same:
        fail(f"MoE {tag}: the ranks' gathered gradients differ")


def phase_ep(seed, pools):
    """The MoE across ranks: its
    logits, dropped choices, loss and gradients at ep = 2, dp = 2, ring
    sp = 2 and ep = 2 x tp = 2 against the single-rank model, then its
    training at ep = 2, dp = 2, ring sp = 2, dp = 2 x ep = 2 (at B = 8),
    ep = 2 x tp = 2 and pp = 2 x ep = 2 (M = 4), over ranks that share
    the card (``pools``).  Returns the launches of the training runs, by
    layout."""
    free_memory("ep")
    print("[ep] the expert outputs' all-gather over ep, the tokens' gradient "
          "sums over ep, and the routing counts' all-gathers and the aux's "
          "all-reduce over dp and sp", flush=True)
    launches = {}
    pool = pools[2]
    ep_check(pool, seed, {"ep": 2}, grads=True)
    ep_check(pool, seed, {"dp": 2})
    ep_check(pool, seed, {"sp": 2})
    for key, axes in (("moe_ep2", {"ep": 2}), ("moe_dp2", {"dp": 2}),
                      ("moe_sp2_ring", {"sp": 2})):
        launches[key] = mesh_train(pool, seed, axes, model="moe", phase="ep",
                                   batch_shape=EP_TRAIN_BATCH, steps=EP_STEPS)
    pool = pools[4]
    ep_check(pool, seed, {"ep": 2, "tp": 2}, grads=True)
    for key, axes, M, shape in (
            ("moe_dp2_ep2", {"dp": 2, "ep": 2}, 1, EP_DP_TRAIN_BATCH),
            ("moe_ep2_tp2", {"ep": 2, "tp": 2}, 1, EP_TRAIN_BATCH),
            ("moe_pp2_ep2_m4", {"pp": 2, "ep": 2}, 4, EP_TRAIN_BATCH)):
        launches[key] = mesh_train(pool, seed, axes, M, model="moe",
                                   phase="ep", batch_shape=shape,
                                   steps=EP_STEPS)
    return launches


# ---------------------------------------------------------------------------
# phase 12: fsdp (alone and with dp, tp, pp; GPT-2 XL at fsdp = 2)
# ---------------------------------------------------------------------------

#: (B, S) of phase 12's checks and of its training
FSDP_CHECK_BATCH = (4, 1024)
FSDP_TRAIN_BATCH = (16, 1024)
#: timed train steps of phase 12's 124M and MoE runs, and of XL's (phase 7
#: takes 3 on one rank)
FSDP_STEPS = 5
FSDP_XL_STEPS = 3


def fsdp_check_rank(seed):
    """GPT-2 124M at FSDP_CHECK_BATCH over fsdp = 2 against the single-rank
    kernels on the same rank: the rank's rows of logits, the loss and every
    leaf's gradient (gathered over fsdp)."""
    set_precision()
    cfg = gpt2.GPT2_SMALL
    config, mesh, params, local, tokens = tp_setup(cfg, seed,
                                                   FSDP_CHECK_BATCH,
                                                   {"fsdp": 2})
    names = [n for n, _ in gpt2.named_leaves(params)]
    batch = batch_shard(tokens, mesh)
    with torch.no_grad():
        ref = batch_shard(gpt2.forward(params, tokens[:, :-1], cfg), mesh)
        with use_mesh(mesh):
            logits = gpt2.forward(local, batch[:, :-1], cfg)
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item(),
           "bitwise": torch.equal(logits, ref)}
    del logits, ref
    ref_loss, ref_grads = loss_and_grads(params, {"tokens": tokens}, cfg)
    with use_mesh(mesh):
        loss = gpt2.loss_fn(gpt2._cast_weights(local, cfg.compute_dtype),
                            {"tokens": batch}, cfg)
        loss.backward()
        gpt2._sum_grads(local, cfg)
        rel = tp_rel(config, mesh, local, names, ref_grads)
    out.update(loss=loss.item(), ref_loss=ref_loss, rel=rel)
    return out


def fsdp_check_gpt2(pool, seed):
    res = pool.run(fsdp_check_rank, seed)
    B, S = FSDP_CHECK_BATCH
    shape = (B // 2, S, gpt2.GPT2_SMALL.vocab_size)
    err = max(r["logits_err"] for r in res)
    print(f"[fsdp] GPT2_SMALL fsdp=2 B={B} S={S}: each rank's logits "
          f"{res[0]['shape']} (its rows; every leaf's embed dim gathered "
          f"over fsdp for its use) vs the single-rank kernels': max abs err "
          f"{err:.4e} (tol {LOGITS_TOL}); equal bit for bit on every rank: "
          f"{all(r['bitwise'] for r in res)}", flush=True)
    if any(r["shape"] != shape or not r["finite"] for r in res) \
            or err > LOGITS_TOL:
        fail("GPT-2 logits at fsdp=2 malformed or apart")
    pp_hold_grads(res, f"GPT2_SMALL fsdp=2 B={B} S={S}",
                  "single-rank kernels", "fsdp",
                  "gathered over fsdp: the cut leaves' reduce-scattered "
                  "blocks, the others summed over fsdp as the step sums them")


def phase_fsdp(seed, pools):
    """fsdp: GPT-2 124M's logits, loss and gradients and the MoE's routes
    and drops at fsdp = 2 against the single-rank model, then training: GPT-2
    XL with remat, 124M and the MoE at fsdp = 2, and 124M at dp = 2 x fsdp =
    2, fsdp = 2 x tp = 2 and pp = 2 x fsdp = 2 (M = 4), over ranks that
    share the card (one gloo group).  Returns the launches of the training
    runs, by layout."""
    free_memory("fsdp")
    print("[fsdp] each leaf's all-gather over fsdp (bf16 in training) and "
          "its cotangent's reduce-scatter are CUDA tensors passed to gloo",
          flush=True)
    launches = {}
    pool = pools[2]
    fsdp_check_gpt2(pool, seed)
    ep_check(pool, seed, {"fsdp": 2}, phase="fsdp")
    for key, model, steps in (("xl_fsdp2", "xl", FSDP_XL_STEPS),
                              ("fsdp2", "gpt2", FSDP_STEPS),
                              ("moe_fsdp2", "moe", FSDP_STEPS)):
        launches[key] = mesh_train(pool, seed, {"fsdp": 2}, model=model,
                                   phase="fsdp", batch_shape=FSDP_TRAIN_BATCH,
                                   steps=steps)
    for key, axes, M in (("dp2_fsdp2", {"dp": 2, "fsdp": 2}, 1),
                         ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, 1),
                         ("pp2_fsdp2_m4", {"fsdp": 2, "pp": 2}, 4)):
        launches[key] = mesh_train(pools[4], seed, axes, M, phase="fsdp",
                                   batch_shape=FSDP_TRAIN_BATCH,
                                   steps=FSDP_STEPS)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the MoE under pipeline parallelism with dp and fsdp
# ---------------------------------------------------------------------------

#: (B, S) of phase 13's checks and of its training, and its microbatches
MOE_PP_CHECK_BATCH = (8, 1024)
MOE_PP_TRAIN_BATCH = (16, 1024)
MOE_PP_M = 4
#: timed train steps a layout of phase 13 takes after its warm-up
MOE_PP_STEPS = 5
#: phase 13's layouts, four ranks each
MOE_PP_LAYOUTS = {"moe_pp2_dp2_m4": {"dp": 2, "pp": 2},
                  "moe_pp2_fsdp2_m4": {"fsdp": 2, "pp": 2}}


def moe_pp_check_rank(seed, axes):
    """The MoE (8 experts, 12 layers) at MOE_PP_CHECK_BATCH through the
    pipeline over ``axes`` (pp with dp or fsdp, MOE_PP_M microbatches)
    against the single-rank model run on each global microbatch alone (the
    reference's function: each microbatch routed with its own capacity),
    with the ranks' choices replayed there if any part: the rank's logits
    (its rows, its stage's part) and the choices dropped in each
    (microbatch, layer) summed over the ranks.  No two ranks route the same
    tokens of a layer in these layouts (no ep, no tp): the ranks' routes
    are held against that run's, whose share parted is printed."""
    set_precision()
    cfg = replace(gpt2.GPT2_SMALL, moe_experts=8)
    M, L, k = MOE_PP_M, cfg.n_layer, cfg.moe_top_k
    config, mesh, params, local, tokens = tp_setup(
        cfg, seed, MOE_PP_CHECK_BATCH, axes)
    batch = batch_shard(tokens, mesh)
    pp = mesh_axis_size(mesh, "pp")
    with use_mesh(mesh):
        with torch.no_grad(), moe_probe() as rec:
            logits = gpt2.forward(local, batch[:, :-1], cfg, None, M)
        # the rank's choices of its block of each global microbatch, (M,
        # stage layers, tokens, k): gathered into each microbatch's token
        # order over fsdp and dp (block d n_fsdp + f), then over the stages
        mine = torch.stack(rec["idx"]).view(M, L // pp, -1, k)
        dropped = torch.stack(rec["dropped"]).view(M, L // pp)
        for axis, _ in gpt2._token_axes(cfg):
            dropped = c10d.allreduce(dropped, axis)
        every = mine
        for axis in ("fsdp", "dp"):
            if axis in axes:
                every = c10d.allgather(every, axis, axis=2)
        every = c10d.allgather(every, "pp", axis=1)
        dropped = c10d.allgather(dropped, "pp", axis=1)
    chunks = tokens[:, :-1].chunk(M)
    with torch.no_grad(), moe_probe() as ref_rec:
        ref = torch.cat([gpt2.forward(params, t, cfg) for t in chunks])
    parted = (torch.stack(ref_rec["idx"]).view_as(every) != every
              ).float().mean().item()
    if parted:
        with torch.no_grad(), pinned_routes(list(every.flatten(0, 1))), \
                moe_probe() as ref_rec:
            ref = torch.cat([gpt2.forward(params, t, cfg) for t in chunks])
    ref_dropped = torch.stack(ref_rec["dropped"]).view(M, L)
    ref = batch_shard(ref, mesh)
    ref = ref.view(pp, -1, *ref.shape[1:])[mesh.get_local_rank("pp")]
    out = {"shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_err": (logits - ref).abs().max().item(),
           "bitwise": torch.equal(logits, ref), "parted": parted,
           "dropped": dropped.tolist(),
           "ref_dropped": ref_dropped.tolist()}
    del logits, ref
    return out


def moe_pp_check(pool, seed, axes):
    """Phase 13's check of one layout (``moe_pp_check_rank``), printed and
    held: logits with phase 3's gate, the dropped choices of each
    (microbatch, layer) equal to the single-rank run's."""
    res = pool.run(moe_pp_check_rank, seed, axes)
    (B, S), M = MOE_PP_CHECK_BATCH, MOE_PP_M
    tag = " x ".join(f"{a}={n}" for a, n in axes.items()) + f" M={M}"
    rows = B // math.prod(axes.values())
    err = max(r["logits_err"] for r in res)
    r0 = res[0]
    print(f"[moe pp] MoE (8 experts) {tag} B={B} S={S}: each rank's logits "
          f"{r0['shape']} (its rows, its stage's part) vs the single-rank "
          f"kernels' on each global microbatch alone: max abs err "
          f"{err:.4e} over the ranks (tol {LOGITS_TOL}); equal bit for bit on "
          f"every rank: {all(r['bitwise'] for r in res)}; routed otherwise by "
          f"the single-rank model {r0['parted']:.6f}"
          + (" (replayed: the reference takes the ranks' choices)"
             if r0["parted"] else " (no replay)")
          + "; each token's layer is routed on one rank only", flush=True)
    print(f"[moe pp] MoE {tag}: choices dropped at capacity per (microbatch, "
          f"layer), summed over the ranks: {r0['dropped']}; single-rank run "
          f"by microbatch: {r0['ref_dropped']} (must be equal: each global "
          f"microbatch routed with the capacity of its own B/M S tokens)",
          flush=True)
    if any(r["shape"] != (rows, S, gpt2.GPT2_SMALL.vocab_size)
           or not r["finite"] for r in res) or err > LOGITS_TOL:
        fail(f"MoE logits at {tag} malformed or apart")
    if any(r["dropped"] != r["ref_dropped"] for r in res):
        fail(f"MoE {tag}: the dropped choices differ from the single-rank "
             f"run's")


def phase_moe_pp(seed, pools):
    """The MoE under pipeline parallelism with dp and with fsdp over four
    ranks that share the card (``pools``): its logits and dropped
    choices at pp = 2 x dp = 2 and pp = 2 x fsdp = 2 against the
    single-rank model by microbatch, then its training in both layouts.
    Returns the launches of the training runs, by layout."""
    free_memory("moe pp")
    print("[moe pp] each rank's tokens all-gathered over dp or fsdp into its "
          "block of every global microbatch, the routing counts' all-gathers "
          "and the aux's all-reduce inside the pipeline's ticks, the stage "
          "hops staged through pinned host buffers", flush=True)
    pool = pools[4]
    for axes in MOE_PP_LAYOUTS.values():
        moe_pp_check(pool, seed, axes)
    return {key: mesh_train(pool, seed, axes, MOE_PP_M, model="moe",
                            phase="moe pp", batch_shape=MOE_PP_TRAIN_BATCH,
                            steps=MOE_PP_STEPS)
            for key, axes in MOE_PP_LAYOUTS.items()}


# ---------------------------------------------------------------------------
# phase 14: the RL learners and the MNIST CNN
# ---------------------------------------------------------------------------

#: the Nature-CNN's Atari frames (84 x 84 x 4 uint8) and actions
ATARI_OBS, ATARI_ACTIONS = (84, 84, 4), 6
#: CartPole's observation dim and actions, for the MLP learners (64, 64)
CARTPOLE_OBS, CARTPOLE_ACTIONS = 4, 2
#: MuJoCo HalfCheetah's observation and action dims, for SAC (256, 256)
HALFCHEETAH_OBS, HALFCHEETAH_ACT = 17, 6
#: batch sizes: IMPALA's (T, B) is the default rollout_length 64 x 32
#: environments; PPO's rows are 2 runners x 4 envs x 64 steps; DQN's, SAC's
#: and BC's are their configs' train_batch_size
RL_SIZES = {"impala": (64, 32), "ppo": 2 * 4 * 64, "dqn": 64, "sac": 256,
            "bc": 256, "mnist": 64, "mnist_large": 1024}
#: timed updates of each learner, after the held one and the two profiled
RL_STEPS = 5
#: card against the CPU path after one update from the same parameters,
#: batch and noise, both in f32 (TF32 off): metrics |a - b| <= RL_RTOL |b| +
#: RL_ATOL; each leaf ||p - p_cpu|| <= RL_MOVE_RTOL ||p_cpu - p_0|| +
#: RL_ULP ||p_cpu|| (the distance apart against the distance moved, as the
#: CPU tests hold the port against JAX; the second term covers the polyak
#: targets, which move 0.005 of the way)
RL_RTOL, RL_ATOL = 1e-4, 1e-5
RL_MOVE_RTOL, RL_ULP = 1e-3, 1e-6
#: learners whose loss on a fixed batch must fall over the updates
RL_FALLING = ("impala", "ppo", "bc", "mnist", "mnist_large")
#: chi-square at p = 1e-3 for 5 degrees of freedom (6 actions)
CHI2_5_P001 = 20.515
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 without tensor cores


def to_device(x, device):
    """A copy of a tree (dicts, tuples) of tensors on ``device``; leaves
    that require grad stay leaves that do."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True).requires_grad_(
            x.requires_grad)
    return x


def rl_batch(name, gen, sizes):
    """A synthetic batch of learner ``name`` from ``gen`` on its device,
    with the noise its update takes (PPO's minibatch rows, SAC's normal
    draws)."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    def coin(p, *shape):
        return (torch.rand(shape, generator=gen, device=dev) < p).float()

    if name == "impala":
        T, B = sizes["impala"]
        return {OBS: randint(256, T, B, *ATARI_OBS).to(torch.uint8),
                ACTIONS: randint(ATARI_ACTIONS, T, B),
                LOGPS: torch.log_softmax(normal(T, B, ATARI_ACTIONS), -1)
                .gather(-1, randint(ATARI_ACTIONS, T, B)[..., None])[..., 0],
                REWARDS: normal(T, B), DONES: coin(0.01, T, B),
                "bootstrap": normal(B)}
    if name == "ppo":
        T, B = 64, sizes["ppo"] // 64
        rewards, values, dones = normal(T, B), normal(T, B), coin(0.05, T, B)
        adv, targets = ppo.compute_gae(
            rewards.cpu().numpy(), values.cpu().numpy(),
            dones.cpu().numpy(), normal(B).cpu().numpy(), 0.99, 0.95)
        n = T * B
        return {OBS: normal(n, CARTPOLE_OBS),
                ACTIONS: randint(CARTPOLE_ACTIONS, n),
                LOGPS: math.log(0.5) + 0.1 * normal(n),
                VALUES: values.reshape(n),
                ADVANTAGES: torch.tensor(adv.reshape(n), device=dev),
                TARGETS: torch.tensor(targets.reshape(n), device=dev),
                "idx": ppo.minibatch_indices(n, ppo.PPOConfig(), gen)}
    if name == "dqn":
        n = sizes["dqn"]
        return {OBS: normal(n, CARTPOLE_OBS),
                ACTIONS: randint(CARTPOLE_ACTIONS, n), REWARDS: normal(n),
                NEXT_OBS: normal(n, CARTPOLE_OBS), DONES: coin(0.1, n),
                "weights": 0.5 + 0.5 * torch.rand(n, generator=gen,
                                                  device=dev)}
    if name == "sac":
        n = sizes["sac"]
        return {OBS: normal(n, HALFCHEETAH_OBS),
                ACTIONS: 2 * torch.rand((n, HALFCHEETAH_ACT), generator=gen,
                                        device=dev) - 1,
                REWARDS: normal(n), NEXT_OBS: normal(n, HALFCHEETAH_OBS),
                DONES: coin(0.01, n),
                "noise": sac.sac_noise(n, HALFCHEETAH_ACT, gen)}
    if name == "bc":
        n = sizes["bc"]
        return {OBS: normal(n, CARTPOLE_OBS),
                ACTIONS: randint(CARTPOLE_ACTIONS, n)}
    return mnist.synthetic_batch(gen, sizes[name], device=dev)


def rl_state(name, gen):
    """What learner ``name`` updates (from ``gen``, on its device)."""
    dev = gen.device
    if name == "impala":
        return {"params": rl_models.init_cnn_policy(
            gen, ATARI_OBS, ATARI_ACTIONS, device=dev)}
    if name in ("ppo", "bc"):
        return {"params": rl_models.init_mlp_policy(
            gen, CARTPOLE_OBS, CARTPOLE_ACTIONS, device=dev)}
    if name == "dqn":
        params = rl_models.init_mlp_policy(gen, CARTPOLE_OBS,
                                           CARTPOLE_ACTIONS, device=dev)
        # the target net apart from the online one, as after a few syncs
        target = optim.tree_map(lambda p: (0.9 * p).detach(), params)
        return {"params": params, "target": target}
    if name == "sac":
        params = sac.init_sac_nets(gen, HALFCHEETAH_OBS, HALFCHEETAH_ACT,
                                   device=dev)
        return {"params": params,
                "target": optim.tree_map(lambda p: p.detach().clone(),
                                         {"q1": params["q1"],
                                          "q2": params["q2"]}),
                "log_alpha": torch.zeros((), device=dev, requires_grad=True)}
    return {"params": mnist.init_params(gen, device=dev)}


def rl_updater(name, state):
    """``update(batch) -> metrics`` of learner ``name`` over ``state``
    (in place), with fresh optimizers: IMPALA's RMSprop (eps 0.1), Adam
    for the others (MNIST's at 1e-3, as the Train layer's loop)."""
    params = state["params"]
    if name == "impala":
        cfg = impala.ImpalaConfig()
        cfg.cnn = True
        upd = impala._make_update_fn(cfg, impala.make_optimizer(cfg, params))
        return lambda b: upd(params, b)
    if name == "ppo":
        cfg = ppo.PPOConfig()
        upd = ppo._make_update_fn(cfg, optim.adam(params, cfg.lr))
        return lambda b: upd(params, {k: v for k, v in b.items()
                                      if k != "idx"}, idx=b["idx"])
    if name == "dqn":
        cfg = dqn.DQNConfig()
        opt = optim.adam(params, cfg.lr)

        def dqn_step(b):
            loss, td = dqn.dqn_update(cfg, params, state["target"], opt, b)
            return {"loss": loss, "td": td}
        return dqn_step
    if name == "sac":
        cfg = sac.SACConfig()
        opt = optim.adam(params, cfg.lr)
        alpha_opt = optim.adam(state["log_alpha"], cfg.alpha_lr)
        dev = state["log_alpha"].device
        low = torch.full((HALFCHEETAH_ACT,), -1.0, device=dev)
        return lambda b: sac.sac_update(
            cfg, params, state["target"], state["log_alpha"], opt,
            alpha_opt, {k: v for k, v in b.items() if k != "noise"},
            b["noise"], low, -low)
    if name == "bc":
        opt = optim.adam(params, bc.BCConfig().lr)
        return lambda b: {"loss": bc.bc_update(params, opt, b[OBS],
                                               b[ACTIONS])}
    opt = optim.adam(params, 1e-3)

    def mnist_step(b):
        loss, acc = mnist.loss_fn(params, b)
        optim.apply_gradients(opt, params, optim.grads_of(loss, params))
        return {"loss": loss.detach(), "acc": acc}
    return mnist_step


def rl_loss(name, m):
    """The loss a learner's update minimises, from its metrics (the
    value before the update's step)."""
    if name == "impala":
        return m["pg_loss"] + 0.5 * m["vf_loss"] - 0.01 * m["entropy"]
    if name == "ppo":
        return m["policy_loss"] + 0.5 * m["vf_loss"] - 0.01 * m["entropy"]
    if name == "sac":
        return m["critic_loss"] + m["actor_loss"]
    return m["loss"]


def rl_hold(name, seed, sizes=RL_SIZES):
    """Learner ``name``'s update on the card against the port's CPU path
    on the same state, batch and noise: (worst metric error over its
    tolerance, worst leaf distance over its tolerance, the card's state,
    batch, update and first metrics).  Fails when either exceeds 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, batch = rl_state(name, gen), rl_batch(name, gen, sizes)
    state0, cpu_state = to_device(state, "cpu"), to_device(state, "cpu")
    update = rl_updater(name, state)
    m_card = update(batch)
    m_cpu = rl_updater(name, cpu_state)(to_device(batch, "cpu"))
    m_err = max(float(((a.cpu() - b).abs() / (RL_RTOL * b.abs() + RL_ATOL))
                      .max()) for a, b in ((m_card[k], m_cpu[k])
                                           for k in m_cpu))
    leaf_err = 0.0
    for a, b, p0 in zip(optim.tree_leaves(state), optim.tree_leaves(
            cpu_state), optim.tree_leaves(state0)):
        a, b, p0 = a.detach().cpu(), b.detach(), p0.detach()
        apart = float((a - b).norm())
        tol = float(RL_MOVE_RTOL * (b - p0).norm() + RL_ULP * b.norm())
        leaf_err = max(leaf_err, apart / tol if apart else 0.0)
    finite = all(torch.isfinite(v).all() for v in m_card.values())
    if not finite or m_err > 1 or leaf_err > 1:
        fail(f"rl {name}: the card's update against the CPU path: metrics "
             f"{m_err:.3f}, leaves {leaf_err:.3f} of their tolerances; "
             f"finite {finite}")
    return m_err, leaf_err, state, batch, update, m_card


def count_launches(fn, top=4):
    """(kernel launches, device ms, the ``top`` kernels by device time as
    (name, ms, launches)) of one call of fn, from a profiler trace of its
    second call: the trace of a first call in a window can miss its first
    kernels (39 of them, in a process that had traced before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1,
                                    repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    kernels = [e for e in events if not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset")]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return len(kernels), busy, [(k, ms, n) for k, (ms, n) in ranked]


def nature_cnn_update_flops(frames):
    """Operations of one Nature-CNN update (forward, and the backward
    without the first conv's input gradient) on ``frames`` 84x84x4
    frames: 2 x MACs by layer, from the shapes."""
    convs = [(20 * 20, 32, 8 * 8 * 4), (9 * 9, 64, 4 * 4 * 32),
             (7 * 7, 64, 3 * 3 * 64)]
    macs = [hw * cout * k for hw, cout, k in convs]
    macs += [3136 * 512, 512 * (ATARI_ACTIONS + 1)]
    fwd = 2 * sum(macs)
    return frames * (3 * fwd - 2 * macs[0])


def rl_sampling_checks(seed):
    """``sample_action``'s frequencies over 10^5 draws against the softmax
    (chi-square), and ``sample_squashed``'s actions in [-1, 1] with logp
    the tanh-Gaussian density recomputed in f64 from the draws."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        sample_action_check(gen)
        sample_squashed_check(gen)


def sample_action_check(gen):
    params = rl_models.init_mlp_policy(gen, CARTPOLE_OBS, ATARI_ACTIONS,
                                       device="cuda")
    params["pi"]["b"].copy_(torch.linspace(-1.0, 1.5, ATARI_ACTIONS))
    n = 100_000
    obs = torch.randn(1, CARTPOLE_OBS, generator=gen,
                      device="cuda").expand(n, -1)
    a, logp, _ = rl_models.sample_action(params, obs, gen)
    probs = torch.softmax(rl_models.mlp_forward(params, obs[:1])[0][0],
                          -1).double()
    counts = torch.bincount(a, minlength=ATARI_ACTIONS).double()
    chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
    logp_err = float((logp.double() - probs.log()[a]).abs().max())
    print(f"[rl] sample_action: {n} Gumbel-max draws over {ATARI_ACTIONS} "
          f"actions, counts {counts.long().tolist()} against "
          f"{[round(x, 1) for x in (n * probs).tolist()]}: chi-square "
          f"{chi2:.3f} (bound {CHI2_5_P001}, p = 1e-3, 5 dof); logp max "
          f"err {logp_err:.2e}", flush=True)
    if chi2 > CHI2_5_P001 or logp_err > 1e-5:
        fail("sample_action's draws do not follow the softmax")


def sample_squashed_check(gen):
    n = 100_000
    nets = sac.init_sac_nets(gen, HALFCHEETAH_OBS, HALFCHEETAH_ACT,
                             device="cuda")
    nets["actor"]["out"]["w"].mul_(10.0)  # spread mean and log_std
    obs = torch.randn(n, HALFCHEETAH_OBS, generator=gen, device="cuda")
    noise = torch.randn(n, HALFCHEETAH_ACT, generator=gen, device="cuda")
    act, logp = sac.sample_squashed(nets["actor"], obs, noise=noise)
    mean, log_std = (x.double() for x in sac.actor_dist(nets["actor"], obs))
    z = mean + torch.exp(log_std) * noise.double()
    ref = (-0.5 * noise.double() ** 2 - log_std - 0.5 * math.log(2 * math.pi)
           + 2 * torch.log(torch.cosh(z))).sum(-1)
    err = float((logp.double() - ref).abs().max())
    print(f"[rl] sample_squashed: {n} draws of {HALFCHEETAH_ACT} dims: "
          f"actions in [{float(act.min()):.6f}, {float(act.max()):.6f}], "
          f"|z| up to {float(z.abs().max()):.1f}; logp against the density "
          f"recomputed in f64 (log sech^2): max err {err:.2e} (tol 5e-4)",
          flush=True)
    if act.abs().max() > 1 or err > 5e-4:
        fail("sample_squashed's actions or logp are off")


def phase_rl(seed):
    """The RL learners' updates and the MNIST step on the card, each held
    against the port's CPU path, then timed; the samplers' draws."""
    free_memory("rl")
    reset_launches()
    for name in RL_SIZES:
        m_err, leaf_err, state, batch, update, m0 = rl_hold(name, seed)
        n_launch, busy_ms, ranked = count_launches(lambda: update(batch))
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        runs = [update(batch) for _ in range(RL_STEPS)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / RL_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        first = float(rl_loss(name, m0))
        last = float(rl_loss(name, runs[-1]))
        size = RL_SIZES[name]
        extra = ""
        if name == "impala":
            PHASE_REF["impala_ms"] = ms
            frames = size[0] * size[1]
            flops = nature_cnn_update_flops(frames)
            extra = (f"; {frames * 1e3 / ms:.1f} frames/s; {flops / 1e9:.1f} "
                     f"GFLOP, bound {flops / PEAK_F32_FLOPS * 1e3:.3f} ms "
                     f"(operations, f32 at 67 TFLOP/s)")
        print(f"[rl] {name} (batch {size}): card vs CPU path after one "
              f"update: metrics {m_err:.3f}, leaves {leaf_err:.3f} of their "
              f"tolerances; {ms:.3f} ms per update over {RL_STEPS} (CUDA "
              f"events, as a caller waits), {busy_ms:.3f} ms of device work "
              f"in {n_launch} kernel launches per update (profiler), so the "
              f"device idles {1 - busy_ms / ms:.1%} of an update; peak "
              f"{peak:.3f} GB{extra}; loss "
              f"{first:.6f} -> {last:.6f} over {RL_STEPS + 3} updates on one "
              f"batch", flush=True)
        print(f"[rl] {name}: top kernels by device time per update: "
              + "; ".join(f"{k_ms:.3f} ms in {n} x {k[:70]}"
                          for k, k_ms, n in ranked), flush=True)
        if not (math.isfinite(first) and math.isfinite(last)):
            fail(f"rl {name}: loss not finite")
        if name in RL_FALLING and not last < first:
            fail(f"rl {name}: loss did not fall on a fixed batch")
        del state, batch, update
        free_memory("rl")
    rl_sampling_checks(seed)
    if any(read_launches().values()):
        fail(f"the RL path launched a flash kernel: {read_launches()}")


# ---------------------------------------------------------------------------
# phase 15: the core runtime on the card
# ---------------------------------------------------------------------------

# a bf16 tensor of 2^25 elements: 67.1 MB
RUNTIME_DRAW_SHAPE = (8192, 4096)
# an f32 tensor of 2^24 elements: 67.1 MB
RUNTIME_PUT_SHAPE = (4096, 4096)


def runtime_draw(seed):
    """The GPU task's value, drawn on the card: the same bits wherever it
    is drawn from the same seed on this card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.randn(RUNTIME_DRAW_SHAPE, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return out


def card_seen():
    """What a task's worker sees of the card."""
    return [torch.cuda.is_available(),
            os.environ.get("CUDA_VISIBLE_DEVICES")]


def sum_on_card(t):
    """An f64 sum of a tensor the runtime handed over, taken on the card;
    the device the tensor arrived on."""
    return [float(t.to("cuda").double().sum()), t.device.type]


class RuntimeGenerator:
    """Phase 3's ``Generator`` in a GPU actor: GPT-2 124M from the seed,
    greedy requests of 8 new tokens; the forward kernel's launches are
    counted in the actor's own process from its start."""

    def __init__(self, seed):
        # Generator by reference, from the script's module: by value,
        # cloudpickle would have to pickle the torch.backends.cudnn module
        # object that set_precision touches, and it cannot
        import chip_smoke

        fa.KERNEL_LAUNCHES = 0
        self.gen = chip_smoke.Generator("small", "cuda", seed)

    def first_forward(self, prompt):
        """Logits of one forward over ``prompt``, on the card: the runtime
        takes them to the host."""
        return self.gen.logits({"prompt": prompt})

    def generate(self, prompt, max_tokens=8):
        """(tokens, ms inside the actor) of one request."""
        t = time.perf_counter()
        tokens = self.gen({"prompt": prompt,
                           "max_tokens": max_tokens})["tokens"]
        return tokens, (time.perf_counter() - t) * 1e3

    def launches(self):
        """(forward kernel launches, forwards) in this process."""
        return self.gen.launches()


@contextlib.contextmanager
def port_session(tag):
    """A session root of its own for a phase's cluster, and the card named
    in its processes' environment (they keep it hidden otherwise): yields
    that environment; after the block nothing of the runtime may remain
    (``chaos.assert_clean_host``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.session_root import new_session_root
    from ray_tpu_torch.util import chaos

    free_memory(tag)
    root = new_session_root()
    rt.config.temp_dir = root
    baseline = chaos.snapshot_host()
    yield {"RAY_TPU_TEMP_DIR": root,
           "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES")
           or "0"}
    try:
        chaos.assert_clean_host(baseline)
    except chaos.HostLeakError as e:
        fail(f"{tag} shutdown left {e}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[{tag}] shutdown: no ray_tpu_torch.core.*_main process and no "
          f"rtt_store segment left", flush=True)


@contextlib.contextmanager
def results_in_temp(tag):
    """A temp directory for a phase's run results, removed after the
    block; ``~/ray_tpu_torch_results`` must then be as it was before."""
    storage = tempfile.mkdtemp(prefix="rtt_results_")
    home = os.path.expanduser("~/ray_tpu_torch_results")
    home_before = os.path.exists(home)
    yield storage
    shutil.rmtree(storage)
    if os.path.exists(home) != home_before:
        fail(f"the runs left {home}")
    print(f"[{tag}] no results outside the temp dir ({home} exists: "
          f"{home_before}, as before)", flush=True)


def phase_runtime(seed, serve_ref, profile):
    """Phase 15: the port's core runtime on one node, with the card as the
    chip resource; ``serve_ref`` is phase 3's tokens, first logits and ms
    per request.  ``profile`` also times the put's copy to the host and
    its serialize alone."""
    import ray_tpu_torch as rt

    with port_session("runtime"):
        t = time.perf_counter()
        rt.init()
        try:
            launches = runtime_checks(rt, seed, serve_ref, profile,
                                      time.perf_counter() - t)
        finally:
            rt.shutdown()
    return launches


def runtime_checks(rt, seed, serve_ref, profile, init_s):
    resources = rt.cluster_resources()
    print(f"[runtime] init in {init_s:.2f} s; cluster_resources "
          f"{resources}; card {torch.cuda.get_device_name(0)} "
          f"({card_line()})", flush=True)
    if resources.get("TPU") != float(torch.cuda.device_count()):
        fail(f"the runtime counts {resources.get('TPU')} chips, torch "
             f"{torch.cuda.device_count()} cards")

    available, visible = rt.get(rt.remote(card_seen).remote(), timeout=120)
    print(f"[runtime] CPU task: torch.cuda.is_available() {available} in "
          f"its worker (CUDA_VISIBLE_DEVICES={visible!r})", flush=True)
    if available or visible != "":
        fail("a CPU task's worker can see the card")

    want = runtime_draw(seed).cpu()
    mb = want.numel() * want.element_size() / 1e6
    draw = rt.remote(num_gpus=1)(runtime_draw)
    for label in ("first: a worker starts and opens the card", "again"):
        t = time.perf_counter()
        ref = draw.remote(seed)
        ready, _ = rt.wait([ref], timeout=300)
        t_ready = time.perf_counter()
        got = rt.get(ready[0])
        t_get = time.perf_counter()
        same = (type(got) is torch.Tensor and got.device.type == "cpu"
                and got.dtype == torch.bfloat16 and got.shape == want.shape
                and torch.equal(got.view(torch.int16),
                                want.view(torch.int16)))
        print(f"[runtime] GPU task -> {mb:.1f} MB bf16 CUDA tensor "
              f"({label}): get {(t_get - t_ready) * 1e3:.3f} ms once ready "
              f"({mb / 1e3 / (t_get - t_ready):.2f} GB/s); submit to value "
              f"{(t_get - t) * 1e3:.1f} ms (the draw, the copy to the host "
              f"and into the store, and get); a CPU bf16 tensor bit-equal "
              f"to the driver's draw: {same}", flush=True)
        if not same:
            fail("the GPU task's tensor did not come back bit-equal")
        PHASE_REF["runtime_get_ms"] = (t_get - t_ready) * 1e3
    del got, want

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(RUNTIME_PUT_SHAPE, generator=gen, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    x_ref = rt.put(x)
    put_ms = (time.perf_counter() - t) * 1e3
    task_sum, device = rt.get(
        rt.remote(num_gpus=1)(sum_on_card).remote(x_ref), timeout=120)
    driver_sum = float(x.double().sum())
    print(f"[runtime] put of a {x.numel() * 4 / 1e6:.1f} MB f32 CUDA tensor "
          f"from the driver: {put_ms:.1f} ms; a GPU task got it on the "
          f"{device} and summed it on the card in f64: {task_sum!r}, the "
          f"driver's {driver_sum!r}", flush=True)
    if device != "cpu" or not math.isclose(task_sum, driver_sum,
                                           rel_tol=1e-12):
        fail("the sums of the put tensor disagree")
    if profile:
        from ray_tpu_torch.core import serialization

        t = time.perf_counter()
        x.cpu()
        host_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        serialization.serialize(x)
        print(f"[profile] runtime put's parts alone: the copy to the host "
              f"{host_ms:.1f} ms, serialize with that copy "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
    del x, x_ref

    t = time.perf_counter()
    actor = rt.remote(num_gpus=1)(RuntimeGenerator).remote(seed)
    logits = rt.get(actor.first_forward.remote(serve_ref["prompts"][500]),
                    timeout=300)
    err = (logits.float() - serve_ref["logits"].float()).abs().max().item()
    print(f"[runtime] GPU actor up and its first forward (S=500) back in "
          f"{time.perf_counter() - t:.2f} s: a {logits.device.type} "
          f"{logits.dtype} tensor {tuple(logits.shape)}; max abs diff from "
          f"phase 3's {err:.4e} (tol {LOGITS_TOL}), bit-equal "
          f"{torch.equal(logits, serve_ref['logits'])}", flush=True)
    if logits.shape != serve_ref["logits"].shape or not err <= LOGITS_TOL:
        fail("the actor's first logits disagree with phase 3's")
    # phase 3's warm-up request, so that the four are timed alike
    rt.get(actor.generate.remote(serve_ref["prompts"][16], 2), timeout=300)
    for L in (16, 127, 500, 1000):
        t = time.perf_counter()
        tokens, inside_ms = rt.get(
            actor.generate.remote(serve_ref["prompts"][L]), timeout=300)
        ms = (time.perf_counter() - t) * 1e3
        same = tokens == serve_ref["tokens"][L]
        print(f"[runtime] actor, prompt {L}: 8 tokens in {ms:.1f} ms as the "
              f"driver waits (host clock), {inside_ms:.1f} ms of it inside "
              f"the actor; phase 3's replica {serve_ref['ms'][L]:.1f} ms; "
              f"tokens equal phase 3's: {same}", flush=True)
        if not same:
            fail(f"the actor's tokens for prompt {L} differ from phase 3's: "
                 f"{tokens[L:]} against {serve_ref['tokens'][L][L:]}")
    launches, forwards = rt.get(actor.launches.remote(), timeout=60)
    n_layer = gpt2.GPT2_SMALL.n_layer
    print(f"[runtime] actor's flash_fwd launches, read in its process: "
          f"{launches} = n_layer {n_layer} x forwards {forwards}: "
          f"{launches == n_layer * forwards}", flush=True)
    if forwards != 1 + 2 + 4 * 8 or launches != n_layer * forwards:
        fail("the actor did not run the forward kernel once per layer per "
             "forward")
    rt.kill(actor)
    return launches


# ---------------------------------------------------------------------------
# phase 16: Serve on the port's runtime
# ---------------------------------------------------------------------------

def http_json(port, path, body, stream=False):
    """POST ``body`` to the Serve HTTP proxy: (status, the JSON reply, or
    the streamed NDJSON items in order)."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}{'?stream=1' if stream else ''}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if stream:
            return resp.status, [json.loads(line) for line in resp]
        return resp.status, json.loads(resp.read())


def phase_serve_run(seed, serve_ref, llama_ref):
    """Phase 16: GPT-2 124M and then Llama-2 7B deployed by
    ``serve.run`` on the port's runtime, each replica on the card, held to
    phases 3 and 5; returns the forward kernel's launches by path, read in
    the replicas' processes."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    with port_session("serve run"):
        rt.init()
        try:
            serve.start()
            launches = {"serve_run_gpt2": serve_run_gpt2(
                rt, serve, seed, serve_ref)}
            launches["serve_run_llama"] = serve_run_llama(
                rt, serve, seed, llama_ref)
        finally:
            serve.shutdown()
            rt.shutdown()
    return launches


def deploy_on_card(serve, name, cls, args, route):
    """``serve.run`` of this script's class ``cls`` (by reference) on the
    card: Serve's controller asks a replica's chip with ``num_tpus`` (the
    key ``"TPU"``, one card; as in the reference it reads no
    ``num_gpus``).  Returns (handle, seconds until ready)."""
    dep = serve.deployment(name=name, ray_actor_options={"num_tpus": 1})(
        script_class(cls))
    t = time.perf_counter()
    try:
        handle = serve.run(dep.bind(*args), name=name, route_prefix=route,
                           timeout=600)
    except (RuntimeError, TimeoutError) as e:  # unhealthy, or not ready
        fail(f"serve.run of {name} failed: {e}")
    return handle, time.perf_counter() - t


def serve_run_gpt2(rt, serve, seed, ref):
    port = serve.http_port()
    h, up_s = deploy_on_card(serve, "gpt2", "Generator",
                             ("small", "cuda", seed), "/gpt2")
    t = time.perf_counter()
    logits = rt.get(h.method.logits.remote({"prompt": ref["prompts"][500]}),
                    timeout=300)
    first_ms = (time.perf_counter() - t) * 1e3
    same = torch.equal(logits, ref["logits"])
    err = (logits.float() - ref["logits"].float()).abs().max().item()
    print(f"[serve run] gpt2 up through serve.run in {up_s:.2f} s (HTTP "
          f"port {port}); first request, logits S=500: a "
          f"{logits.device.type} {logits.dtype} tensor "
          f"{tuple(logits.shape)} in {first_ms:.1f} ms, max abs diff from "
          f"phase 3's {err:.4e}, bit-equal {same}", flush=True)
    if not same:
        fail("the served first logits are not bit-equal to phase 3's")
    # phase 3's warm-up request, then the counts are set to 0
    rt.get(h.remote({"prompt": ref["prompts"][16], "max_tokens": 2}),
           timeout=300)
    _, f0 = rt.get(h.method.launches.remote(True), timeout=60)
    for L in (16, 127, 500, 1000):
        request = {"prompt": ref["prompts"][L], "max_tokens": 8}
        t = time.perf_counter()
        tokens = rt.get(h.remote(request), timeout=300)["tokens"]
        handle_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        status, reply = http_json(port, "/gpt2", request)
        http_ms = (time.perf_counter() - t) * 1e3
        print(f"[serve run] gpt2 prompt {L}: 8 tokens in {handle_ms:.1f} ms "
              f"through the handle, {http_ms:.1f} ms over HTTP (status "
              f"{status}); phase 3's replica {ref['ms'][L]:.1f} ms (host "
              f"clock); tokens equal phase 3's: handle "
              f"{tokens == ref['tokens'][L]}, HTTP "
              f"{reply['tokens'] == ref['tokens'][L]}", flush=True)
        if (tokens != ref["tokens"][L] or status != 200
                or reply["tokens"] != ref["tokens"][L]):
            fail(f"served tokens for prompt {L} differ from phase 3's")
    prompt = ref["prompts"][127]
    want = ref["tokens"][127][len(prompt):]
    t = time.perf_counter()
    status, items = http_json(port, "/gpt2", {
        "prompt": prompt, "max_tokens": 8, "stream": True}, stream=True)
    stream_ms = (time.perf_counter() - t) * 1e3
    streamed = [i.get("token") for i in items]
    print(f"[serve run] gpt2 HTTP stream, prompt 127: {len(items)} items in "
          f"{stream_ms:.1f} ms (status {status}), tokens in order equal "
          f"phase 3's new tokens: {streamed == want}", flush=True)
    if status != 200 or streamed != want:
        fail(f"the HTTP stream yielded {items}")
    launches, forwards = rt.get(h.method.launches.remote(False), timeout=60)
    n_layer = gpt2.GPT2_SMALL.n_layer
    print(f"[serve run] gpt2 replica's flash_fwd launches, read in its "
          f"process: {launches} = n_layer {n_layer} x forwards "
          f"{forwards - f0}: {launches == n_layer * (forwards - f0)}",
          flush=True)
    if forwards - f0 != 9 * 8 or launches != n_layer * (forwards - f0):
        fail("the gpt2 replica did not run the forward kernel once per "
             "layer per forward")
    serve.delete("gpt2")
    return launches


def serve_run_llama(rt, serve, seed, ref):
    port = serve.http_port()
    h, up_s = deploy_on_card(serve, "llama", "LlamaServer",
                             ("7b", "cuda", seed), "/llama")
    print(f"[serve run] llama up through serve.run in {up_s:.2f} s (the "
          f"gpt2 replica gone, its card taken)", flush=True)
    prompt, want = ref["prompt"], ref["generated"]
    request = {"prompt_tokens": prompt, "max_new_tokens": 32}
    # phase 5's warm-up request, then the counts are set to 0
    rt.get(h.remote({"prompt_tokens": prompt[:16], "max_new_tokens": 2}),
           timeout=300)
    rt.get(h.method.launches.remote(True), timeout=60)
    t = time.perf_counter()
    out = rt.get(h.method.last_logits.remote({"tokens": ref["tokens"]}),
                 timeout=300)
    logits_ms = (time.perf_counter() - t) * 1e3
    same = (torch.equal(out["last"], ref["last"])
            and torch.equal(out["argmax"], ref["argmax"]))
    print(f"[serve run] llama uncached forward S={len(ref['tokens'])} "
          f"(the kernel) in the replica: {logits_ms:.1f} ms as the driver "
          f"waits; last logits and every argmax bit-equal to phase 5's: "
          f"{same}", flush=True)
    if not same:
        fail("the served llama logits differ from phase 5's")
    t = time.perf_counter()
    rt.get(h.remote(dict(request, max_new_tokens=1)), timeout=300)
    prefill = time.perf_counter() - t
    t = time.perf_counter()
    tokens = rt.get(h.remote(request), timeout=300)["tokens"]
    dt = time.perf_counter() - t
    status, reply = http_json(port, "/llama", request)
    per_token = (dt - prefill) / 31
    print(f"[serve run] llama greedy, prompt {len(prompt)}: prefill "
          f"{prefill * 1e3:.1f} ms (phase 5 {ref['prefill_ms']:.1f}), 32 "
          f"tokens in {dt * 1e3:.1f} ms, {per_token * 1e3:.2f} ms per "
          f"decoded token (phase 5 {ref['per_token_ms']:.2f}); tokens equal "
          f"phase 5's: handle {tokens == want}, HTTP "
          f"{reply['tokens'] == want} (status {status})", flush=True)
    if tokens != want or status != 200 or reply["tokens"] != want:
        fail("served llama tokens differ from phase 5's")
    launches = rt.get(h.method.launches.remote(False), timeout=60)
    n_layer = llama.LLAMA_7B.n_layer
    print(f"[serve run] llama replica's flash_fwd launches, read in its "
          f"process: {launches} (n_layer {n_layer}: the uncached forward; "
          f"generate's cached attention launches none)", flush=True)
    if launches != n_layer:
        fail("the llama replica did not launch the forward kernel once per "
             "layer")
    serve.delete("llama")
    return launches


# ---------------------------------------------------------------------------
# phase 17: two nodes of the port's runtime (cluster_utils)
# ---------------------------------------------------------------------------

def tensor_checksum(t):
    """(sha256 of a tensor's bytes, the node that read it, the device it
    arrived on, whether that worker sees a card)."""
    data = t.contiguous().view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.contiguous()
    return [hashlib.sha256(data.numpy().tobytes()).hexdigest(),
            os.environ.get("RAY_TPU_NODE_ID"), t.device.type,
            torch.cuda.is_available()]


def phase_cluster(seed):
    """Phase 17: a port ``Cluster`` of a CPU head and a node with the card;
    a GPU task on that node makes phase 15's tensor, a CPU task pinned to
    the head pulls it across the nodes; nothing may remain after
    ``shutdown()``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    with port_session("cluster") as env:
        t = time.perf_counter()
        c = Cluster(initialize_head=True, head_resources={"num_cpus": 2},
                    env=env)
        try:
            card_node = c.add_node(num_cpus=1, num_tpus=1)
            c.wait_for_nodes(2)
            c.connect()
            cluster_checks(rt, c, card_node, seed, time.perf_counter() - t)
        finally:
            c.shutdown()


def cluster_checks(rt, c, card_node, seed, up_s):
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    head = c.head_node.node_id
    resources = rt.cluster_resources()
    alive = [n["NodeID"] for n in rt.nodes() if n["Alive"]]
    print(f"[cluster] GCS and 2 raylets up in {up_s:.2f} s: nodes "
          f"{sorted(alive)}; cluster_resources {resources}; card "
          f"{card_line()}", flush=True)
    if sorted(alive) != sorted([head, card_node.node_id]) \
            or resources.get("TPU") != 1.0:
        fail("the cluster does not hold a head and one node with the card")
    want = runtime_draw(seed).cpu()
    want_sum = tensor_checksum(want)[0]
    mb = want.numel() * want.element_size() / 1e6
    t = time.perf_counter()
    ref = rt.remote(num_gpus=1)(runtime_draw).remote(seed)
    ready, _ = rt.wait([ref], timeout=300)
    if not ready:
        fail("the GPU task on the card's node did not finish")
    made_s = time.perf_counter() - t
    on_head = NodeAffinitySchedulingStrategy(head, soft=False)
    # a CPU worker on the head first, so that the reads time no start
    t = time.perf_counter()
    seen = rt.get(rt.remote(num_cpus=1)(card_seen).options(
        scheduling_strategy=on_head).remote(), timeout=300)
    warm_s = time.perf_counter() - t
    read = rt.remote(num_cpus=1)(tensor_checksum).options(
        scheduling_strategy=on_head)
    reads = []
    for _ in range(2):  # the first pulls across the nodes
        t = time.perf_counter()
        reads.append(rt.get(read.remote(ref), timeout=300)
                     + [(time.perf_counter() - t) * 1e3])
    t = time.perf_counter()
    got = rt.get(ref, timeout=300)
    get_ms = (time.perf_counter() - t) * 1e3
    same = (type(got) is torch.Tensor and got.dtype == torch.bfloat16
            and got.shape == want.shape
            and torch.equal(got.view(torch.int16), want.view(torch.int16)))
    (h1, n1, d1, cuda1, ms1), (h2, n2, d2, cuda2, ms2) = reads
    print(f"[cluster] GPU task on the card's node -> {mb:.1f} MB bf16 CUDA "
          f"tensor, ready in {made_s:.2f} s (a worker starts and opens the "
          f"card); a CPU worker on the head up in {warm_s:.2f} s "
          f"(torch.cuda.is_available() {seen[0]}, CUDA_VISIBLE_DEVICES="
          f"{seen[1]!r}); a CPU task pinned to the head read it as a {d1} "
          f"tensor: submit to checksum "
          f"{ms1:.1f} ms with the pull across the nodes, {ms2:.1f} ms again "
          f"from the head's store (the pull ~{ms1 - ms2:.1f} ms, "
          f"{mb / max(ms1 - ms2, 1e-3):.2f} GB/s); checksums equal the "
          f"driver's draw: {h1 == want_sum and h2 == want_sum}; the "
          f"driver's get {get_ms:.3f} ms (phase 15's same-node get "
          f"{PHASE_REF.get('runtime_get_ms', float('nan')):.3f} ms), a CPU "
          f"bf16 tensor bit-equal to the draw: {same}", flush=True)
    if n1 != head or n2 != head or d1 != "cpu" or cuda1 or cuda2 \
            or seen != [False, ""]:
        fail("the CPU task did not run on the head, or saw the card")
    if h1 != want_sum or h2 != want_sum or not same:
        fail("the tensor pulled across the nodes is not bit-equal")


# ---------------------------------------------------------------------------
# phase 18: Train on the port's runtime
# ---------------------------------------------------------------------------

# phase 18's worker runs phase 4's steps on phase 4's setup and batch in
# another process: the kernels are deterministic and the GEMM shapes the
# same, so its losses are held to phase 4's bit for bit
TRAIN_RUN_LOSS_TOL = 0.0
# the store of phase 18's runtime: the step-5 checkpoint (124M f32
# parameters and AdamW's two moments, ~1.5 GB) travels through it
TRAIN_RUN_STORE_BYTES = 4 << 30
TRAIN_RUN_BATCH = (16, 1024)
TRAIN_RUN_STEPS = 10
TRAIN_RUN_CKPT_STEP = 5
TRAIN_RUN_DP_STEPS = 3


def train_run_loop(config):
    """A ``TorchTrainer`` worker: GPT-2 124M from phase 4's setup and
    AdamW, its batch from the dataset shard staged onto the card, one report
    a step (loss, the step's ms from CUDA events, the launches of each
    kernel in this process since the first step, peak memory), a checkpoint
    of the parameters and the optimizer's state at ``ckpt_step``; resumes
    from the session's checkpoint.  Everything comes by reference from
    ``chip_smoke``, so cloudpickle ships this function by value alone."""
    import time

    loop_t0 = time.time()
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.torch import get_device

    cs.set_precision()
    device = get_device()
    params, _ = cs.train_setup(cs.gpt2.GPT2_SMALL, config["seed"], 1, 1)
    opt = cs.adamw(params)
    step_fn = cs.gpt2.make_train_step(cs.gpt2.GPT2_SMALL, opt)
    start = 0
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        t = time.perf_counter()
        state = ckpt.to_dict()
        with torch.no_grad():
            for leaf, saved in zip(cs.gpt2.param_leaves(params),
                                   state["params"]):
                leaf.copy_(saved)
        opt.load_state_dict(state["opt"])
        start = state["step"]
        load_s = time.perf_counter() - t
    shard = session.get_dataset_shard("train")
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    for step in range(start, config["steps"]):
        t = time.perf_counter()
        (batch,) = list(shard.iter_torch_batches(
            batch_size=config["batch"]))
        data_ms = (time.perf_counter() - t) * 1e3
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        loss = step_fn(params, {"tokens": batch["value"]})["loss"]
        end.record()
        loss = loss.item()
        report = {"step": step + 1, "loss": loss,
                  "ms": begin.elapsed_time(end), "data_ms": data_ms,
                  "batch_device": str(batch["value"].device),
                  "device": str(device), "launches": cs.read_launches(),
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "loop_t0": loop_t0, "t": time.time()}
        if ckpt is not None and step == start:
            report["load_s"] = load_s
        saved = None
        if step + 1 == config.get("ckpt_step"):
            t = time.perf_counter()
            saved = Checkpoint.from_dict({
                "params": cs.gpt2.param_leaves(params),
                "opt": opt.state_dict(), "step": step + 1})
            report["to_host_s"] = time.perf_counter() - t
            report["ckpt_on_card"] = any(
                x.is_cuda for x in saved.to_dict()["params"])
        session.report(report, checkpoint=saved)


def train_run_dp_loop(config):
    """Two ``TorchTrainer`` workers sharing the card (gloo): each its half
    of phase 4's batch on a dp = 2 mesh; one report a step (the loss, the
    launches summed over both ranks), then whether the ranks' parameters
    are bit-equal."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from ray_tpu_torch.parallel.context import use_mesh
    from ray_tpu_torch.parallel.sharding import ShardingConfig, batch_shard
    from ray_tpu_torch.train import session

    cs.set_precision()
    params, tokens = cs.train_setup(cs.gpt2.GPT2_SMALL, config["seed"],
                                    *config["batch"])
    mesh = ShardingConfig(dp=2).build_mesh()
    batch = {"tokens": batch_shard(tokens, mesh)}
    step_fn = cs.gpt2.make_train_step(cs.gpt2.GPT2_SMALL, cs.adamw(params))
    cs.reset_launches()
    with use_mesh(mesh):
        for step in range(config["steps"]):
            loss = step_fn(params, batch)["loss"].item()
            counts = torch.tensor(list(cs.read_launches().values()))
            dist.all_reduce(counts)
            session.report({"step": step + 1, "loss": loss,
                            "rows": batch["tokens"].shape[0],
                            "backend": dist.get_backend(),
                            "launches": dict(zip(cs.read_launches(),
                                                 counts.tolist())),
                            "peak_gb": torch.cuda.max_memory_allocated()
                            / 1e9})
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, cs.params_digest(params))
    session.report({"step": config["steps"], "same": len(set(digests)) == 1,
                    "launches": None})


def phase_train_run(seed):
    """Phase 18: GPT-2 124M trained through ``TorchTrainer`` on the port's
    runtime, held to phase 4; returns the launches of each kernel counted
    in the workers, by run."""
    import ray_tpu_torch as rt

    with port_session("train run"), results_in_temp("train run") as storage:
        rt.init(object_store_memory=TRAIN_RUN_STORE_BYTES)
        try:
            launches = train_run_checks(rt, seed, storage)
        finally:
            rt.shutdown()
    return launches


def train_run_fit(name, storage, loop, config, scaling, datasets=None,
                  resume=None):
    """``TorchTrainer(...).fit()``: (result, seconds, the wall clock at
    its start)."""
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    began = time.time()
    t = time.perf_counter()
    result = TorchTrainer(
        loop, train_loop_config=config, scaling_config=scaling,
        run_config=RunConfig(name=name, storage_path=storage),
        datasets=datasets, resume_from_checkpoint=resume).fit()
    secs = time.perf_counter() - t
    if result.error is not None:
        fail(f"train run {name}: {result.error!r}")
    return result, secs, began


def train_run_timeline(tag, hist, secs, began):
    """Where a fit's seconds went, from its reports' wall clocks."""
    print(f"[train run] {tag}: fit {secs:.2f} s; the worker's loop began "
          f"{hist[0]['loop_t0'] - began:.2f} s in (the worker group and "
          f"its process group up); reports at "
          f"{' '.join(f'{m['t'] - began:.2f}' for m in hist)} s; the step "
          f"(ms, CUDA events) "
          f"{' '.join(f'{m['ms']:.1f}' for m in hist)}; the batch from "
          f"the shard (ms) {' '.join(f'{m['data_ms']:.1f}' for m in hist)}"
          f"; peak GB after each step "
          f"{' '.join(f'{m['peak_gb']:.2f}' for m in hist)}", flush=True)


def train_run_checks(rt, seed, storage):
    from ray_tpu_torch import data
    from ray_tpu_torch.train import ScalingConfig

    B, S = TRAIN_RUN_BATCH
    ref = PHASE_REF["train_losses"][:TRAIN_RUN_STEPS]
    ref_ms, ref_peak = SINGLE_RANK_STEPS["gpt2"]
    n_layer = gpt2.GPT2_SMALL.n_layer
    ds = data.from_numpy(train_tokens(seed, B, S).numpy(), parallelism=1)
    one = ScalingConfig(num_workers=1, use_tpu=True)
    config = {"seed": seed, "steps": TRAIN_RUN_STEPS, "batch": B,
              "ckpt_step": TRAIN_RUN_CKPT_STEP}

    result, secs, began = train_run_fit("gpt2", storage, train_run_loop,
                                        config, one, {"train": ds})
    hist = result.metrics_history
    train_run_timeline("uninterrupted", hist, secs, began)
    losses = [m["loss"] for m in hist]
    last = hist[-1]
    ms = sorted(m["ms"] for m in hist[1:])
    print(f"[train run] TorchTrainer, 1 worker with the card "
          f"(ScalingConfig(use_tpu=True)), GPT2_SMALL B={B} S={S}: fit "
          f"{secs:.2f} s for {len(hist)} steps (a worker starts, imports "
          f"chip_smoke, draws the weights); worker device "
          f"{last['device']}, batches staged onto {last['batch_device']} "
          f"from the dataset shard in {hist[1]['data_ms']:.1f}-"
          f"{max(m['data_ms'] for m in hist[1:]):.1f} ms a step",
          flush=True)
    print(f"[train run] losses {' '.join(f'{x:.4f}' for x in losses)}; "
          f"phase 4's {' '.join(f'{x:.4f}' for x in ref)}; bit-equal "
          f"{losses == ref}, largest |diff| "
          f"{max(abs(a - b) for a, b in zip(losses, ref)):.3e} (tol "
          f"{TRAIN_RUN_LOSS_TOL})", flush=True)
    print(f"[train run] the worker's step: first {hist[0]['ms']:.3f} ms, "
          f"then median {ms[len(ms) // 2]:.3f} ms (range {ms[0]:.3f}-"
          f"{ms[-1]:.3f}; CUDA events around each step, synced by the "
          f"report's loss) against phase 4's {ref_ms:.3f} ms (10 steps "
          f"between two events); peak memory {last['peak_gb']:.2f} GB "
          f"(phase 4 {ref_peak:.2f}); launches in the worker "
          f"{last['launches']} (want {n_layer * TRAIN_RUN_STEPS} of each); "
          f"checkpoint at step {TRAIN_RUN_CKPT_STEP}: to the host in "
          f"{hist[TRAIN_RUN_CKPT_STEP - 1]['to_host_s']:.2f} s, holds no "
          f"card tensor: {not hist[TRAIN_RUN_CKPT_STEP - 1]['ckpt_on_card']}"
          f"; card {card_line()}", flush=True)
    if last["device"] != "cuda:0" or last["batch_device"] != "cuda:0":
        fail("the Train worker did not train on the card")
    if any(abs(a - b) > TRAIN_RUN_LOSS_TOL for a, b in zip(losses, ref)) \
            or len(losses) != len(ref):
        fail("the Train worker's losses disagree with phase 4's")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train run losses not finite or not falling: {losses}")
    if any(n != n_layer * TRAIN_RUN_STEPS for n in last["launches"].values()):
        fail("the Train worker did not launch each kernel once per layer "
             "per step")
    if hist[TRAIN_RUN_CKPT_STEP - 1]["ckpt_on_card"]:
        fail("the checkpoint holds tensors on the card")
    launches = {"train_run": last["launches"]}

    resumed, secs, began = train_run_fit(
        "gpt2_resumed", storage, train_run_loop, config, one, {"train": ds},
        resume=result.checkpoint)
    train_run_timeline("resumed", resumed.metrics_history, secs, began)
    r_losses = [m["loss"] for m in resumed.metrics_history]
    r_last = resumed.metrics_history[-1]
    want = losses[TRAIN_RUN_CKPT_STEP:]
    print(f"[train run] resumed from the step-{TRAIN_RUN_CKPT_STEP} "
          f"checkpoint ({result.checkpoint!r}) in a new worker: fit "
          f"{secs:.2f} s, the checkpoint loaded in "
          f"{resumed.metrics_history[0]['load_s']:.2f} s; steps "
          f"{[m['step'] for m in resumed.metrics_history]} losses "
          f"{' '.join(f'{x:.4f}' for x in r_losses)} equal the "
          f"uninterrupted run's: {r_losses == want}; launches "
          f"{r_last['launches']}", flush=True)
    if r_losses != want:
        fail("the resumed run's losses differ from the uninterrupted run's")
    steps_left = TRAIN_RUN_STEPS - TRAIN_RUN_CKPT_STEP
    if any(n != n_layer * steps_left for n in r_last["launches"].values()):
        fail("the resumed worker's launches are off")
    launches["train_run_resumed"] = r_last["launches"]

    shared = ScalingConfig(num_workers=2,
                           resources_per_worker={"CPU": 1, "TPU": 0.5})
    dp, secs, _ = train_run_fit(
        "gpt2_dp2", storage, train_run_dp_loop,
        {"seed": seed, "steps": TRAIN_RUN_DP_STEPS, "batch": (B, S)}, shared)
    hist = dp.metrics_history
    dp_losses = [m["loss"] for m in hist[:TRAIN_RUN_DP_STEPS]]
    d = max(abs(a - b) for a, b in zip(dp_losses, losses))
    dp_launches = hist[TRAIN_RUN_DP_STEPS - 1]["launches"]
    want_dp = 2 * n_layer * TRAIN_RUN_DP_STEPS
    print(f"[train run] 2 workers sharing the card ({{'CPU': 1, 'TPU': "
          f"0.5}} each, backend {hist[0]['backend']}), dp=2 at B="
          f"{hist[0]['rows']} each: fit {secs:.2f} s; losses "
          f"{' '.join(f'{x:.4f}' for x in dp_losses)} against one worker at "
          f"B={B}: |diff| {d:.3e} (tol {TRAIN_LOSS_TOL}); parameters "
          f"bit-equal across the ranks: {hist[-1]['same']}; launches over "
          f"the ranks {dp_launches} (want {want_dp} of each); rank 0's peak "
          f"{hist[TRAIN_RUN_DP_STEPS - 1]['peak_gb']:.2f} GB", flush=True)
    if hist[0]["backend"] != "gloo" or hist[0]["rows"] != B // 2:
        fail("the shared-card workers did not run dp=2 over gloo")
    if d > TRAIN_LOSS_TOL or not hist[-1]["same"]:
        fail("the shared-card dp=2 run disagrees with one worker")
    if any(n != want_dp for n in dp_launches.values()):
        fail("the shared-card workers' launches are off")
    launches["train_run_dp2"] = dp_launches
    return launches


# ---------------------------------------------------------------------------
# phases 19-20: Tune, and RLlib's Algorithm in a Tune trial
# ---------------------------------------------------------------------------

#: phase 19's grid of AdamW learning rates, phase 4's among them.  The
#: trials run one at a time in this order, so the first reaches every rung
#: unopposed; phase 4's rate spikes at step 4 (10.9812 after 10.4700 on an
#: H100 80GB HBM3, 700.00 W), so a slower rate runs first and should end
#: lowest, and 1e-7, which barely moves the loss, must stop at the rung
TUNE_LRS = (1e-4, 3e-4, 1e-7)
#: the entry of TUNE_LRS that is phase 4's (``adamw``'s default)
TUNE_PHASE4_LR = 3e-4
#: ASHA's max_t (reports of a trial) and grace period (its one rung)
TUNE_MAX_T, TUNE_GRACE = 4, 2
#: steps of the TorchTrainer trial
TUNE_TRAINER_STEPS = 2
#: phase 20's training iterations (one rollout and one update each)
RLLIB_ITERS = 3


def tune_trial(config):
    """A Tune function trainable in an actor holding the card: GPT-2 124M
    from phase 4's setup, seed and batch, AdamW at ``config["lr"]``, one
    report a step with the history so far (losses, each step's ms from
    CUDA events, wall clocks), the launches of each kernel in this process
    and its peak memory.  Everything comes from ``chip_smoke`` by
    reference, so cloudpickle ships this function by value alone."""
    import time

    loop_t0 = time.time()
    import torch

    import chip_smoke as cs
    from ray_tpu_torch import tune

    cs.set_precision()
    params, tokens = cs.train_setup(cs.gpt2.GPT2_SMALL, config["seed"],
                                    *config["batch"])
    step_fn = cs.gpt2.make_train_step(cs.gpt2.GPT2_SMALL,
                                      cs.adamw(params, config["lr"]))
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    hist = {"loss": [], "ms": [], "t": []}
    for _ in range(config["steps"]):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        loss = step_fn(params, {"tokens": tokens})["loss"]
        end.record()
        hist["loss"].append(loss.item())
        hist["ms"].append(begin.elapsed_time(end))
        hist["t"].append(time.time())
        tune.report({"loss": hist["loss"][-1], "history": hist,
                     "launches": cs.read_launches(), "loop_t0": loop_t0,
                     "device": str(tokens.device),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})


class SmokeAtariEnv:
    """What ``Impala.build_learner`` reads of an environment: phase 14's
    Atari frame shape and action count (the card's machine has no
    ``gymnasium``)."""

    class _Box:
        shape = ATARI_OBS

    class _Discrete:
        n = ATARI_ACTIONS

    observation_space, action_space = _Box(), _Discrete()

    def close(self):
        pass


def smoke_rollout(seed, index, T, B):
    """The stub runner's rollout ``index``: ``EnvRunner.sample()``'s dict
    (a ``SampleBatch`` of T x B uint8 frames, actions, behaviour logps,
    values, rewards and dones; bootstrap values; one finished episode)
    drawn from a numpy generator seeded with (seed, index)."""
    import numpy as np

    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    rng = np.random.default_rng([seed, index])
    n = T * B
    logits = rng.standard_normal((n, ATARI_ACTIONS))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    actions = rng.integers(0, ATARI_ACTIONS, n)
    batch = SampleBatch({
        OBS: rng.integers(0, 256, (n, *ATARI_OBS), dtype=np.uint8),
        ACTIONS: actions,
        LOGPS: logp[np.arange(n), actions].astype(np.float32),
        VALUES: rng.standard_normal(n).astype(np.float32),
        REWARDS: rng.standard_normal(n).astype(np.float32),
        DONES: (rng.random(n) < 0.01).astype(np.float32)})
    return {"batch": batch, "t_shape": (T, B),
            "last_values": rng.standard_normal(B).astype(np.float32),
            "metrics": {"episodes": [(float(rng.normal(20.0, 5.0)), 100)],
                        "env_steps": n}}


class SmokeRunner:
    """The rollout actor of phase 20: ``EnvRunner``'s interface, its
    samples ``smoke_rollout``'s by call index, whatever weights it holds."""

    def __init__(self, env_creator, num_envs, rollout_length, policy_init,
                 seed=0, **kwargs):
        self.B, self.T, self.seed, self.calls = (num_envs, rollout_length,
                                                 seed, 0)

    def set_weights(self, weights):
        return True

    def sample(self):
        self.calls += 1
        return smoke_rollout(self.seed, self.calls - 1, self.T, self.B)


class SmokeImpala(impala.Impala):
    """The port's ``Impala`` with ``SmokeRunner`` as its rollout actor, TF32
    off in its process, and each iteration's ms, its update's ms (CUDA
    events), the flash kernels' launches in its process and the device its
    parameters are on added to its result."""

    def setup(self, config):
        set_precision()
        reset_launches()
        super().setup(config)

    def runner_class(self):
        return SmokeRunner

    def build_learner(self):
        super().build_learner()
        update, self.update_ms = self._update, []

        def timed(params, batch):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            metrics = update(params, batch)
            end.record()
            end.synchronize()
            self.update_ms.append(begin.elapsed_time(end))
            return metrics

        self._update = timed

    def training_step(self):
        t = time.perf_counter()
        out = super().training_step()
        self.first_update = getattr(self, "first_update", None) or {
            k: out[k] for k in ("pg_loss", "vf_loss", "entropy")}
        out.update(iter_ms=(time.perf_counter() - t) * 1e3,
                   update_ms=self.update_ms[-1], launches=read_launches(),
                   device=str(optim.tree_leaves(self._params)[0].device),
                   first_update=self.first_update)
        return out


def phase_tune_rllib(seed):
    """Phases 19 and 20 in one ``init()`` under a session root of their
    own; returns the launches of each kernel in the Tune trials and in
    the trainer's worker."""
    import ray_tpu_torch as rt

    with port_session("tune"), results_in_temp("rllib") as storage:
        rt.init(object_store_memory=TRAIN_RUN_STORE_BYTES)
        try:
            t0 = time.perf_counter()
            launches = tune_checks(seed, storage)
            print(f"[tune] phase 19: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            rllib_checks(seed, storage)
            print(f"[rllib] phase 20: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        finally:
            rt.shutdown()
    return launches


def tune_checks(seed, storage):
    from ray_tpu_torch import data, tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    B, S = TRAIN_RUN_BATCH
    ref = PHASE_REF["train_losses"]
    ref_ms, ref_peak = SINGLE_RANK_STEPS["gpt2"]
    n_layer = gpt2.GPT2_SMALL.n_layer
    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=TUNE_MAX_T,
                               grace_period=TUNE_GRACE, reduction_factor=2)
    began = time.time()
    grid = tune.Tuner(
        tune_trial,
        param_space={"lr": tune.grid_search(list(TUNE_LRS)), "seed": seed,
                     "batch": (B, S), "steps": TUNE_MAX_T},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", scheduler=sched,
            resources_per_trial={"CPU": 1, "TPU": 1}),
        run_config=tune.RunConfig(name="gpt2_asha",
                                  storage_path=storage)).fit()
    secs = time.time() - began
    if grid.errors:
        fail(f"tune: trials errored: {grid.errors}")
    trials, stopped, launches = [], [], {}
    prev_end = began
    for r in sorted(grid, key=lambda r: r.metrics["history"]["t"][0]):
        m, h = r.metrics, r.metrics["history"]
        n = len(h["loss"])
        ms = sorted(h["ms"][1:])
        print(f"[tune] trial lr={r.config['lr']:g} on {m['device']}: "
              f"{n} steps, losses {' '.join(f'{x:.4f}' for x in h['loss'])}"
              f"; first report {h['t'][0] - prev_end:.2f} s after the "
              f"previous trial's last ({h['t'][0] - m['loop_t0']:.2f} s "
              f"after its loop began: import chip_smoke, the weights, the "
              f"first step); step (ms, CUDA events) first {h['ms'][0]:.1f}, "
              f"then median {ms[len(ms) // 2]:.3f} (range {ms[0]:.3f}-"
              f"{ms[-1]:.3f}) against phase 4's {ref_ms:.3f}; peak "
              f"{m['peak_gb']:.2f} GB (phase 4 {ref_peak:.2f}); launches "
              f"{m['launches']}", flush=True)
        prev_end = h["t"][-1]
        if m["device"] != "cuda:0":
            fail(f"tune: trial lr={r.config['lr']} did not train on the "
                 f"card")
        if any(v != n_layer * n for v in m["launches"].values()):
            fail(f"tune: trial lr={r.config['lr']} launched "
                 f"{m['launches']}, want {n_layer * n} of each")
        if not all(math.isfinite(x) for x in h["loss"]):
            fail(f"tune: trial lr={r.config['lr']}'s losses not finite")
        for k, v in m["launches"].items():
            launches[k] = launches.get(k, 0) + v
        (stopped if n < TUNE_MAX_T else trials).append(r)
    mine = [r for r in grid if r.config["lr"] == TUNE_PHASE4_LR]
    got = mine[0].metrics["history"]["loss"]
    print(f"[tune] the trial at phase 4's lr {TUNE_PHASE4_LR:g}: losses bit-"
          f"equal to phase 4's first {len(got)}: {got == ref[:len(got)]} "
          f"(tol {TRAIN_RUN_LOSS_TOL})", flush=True)
    if any(abs(a - b) > TRAIN_RUN_LOSS_TOL for a, b in zip(got, ref)):
        fail("tune: the trial at phase 4's lr disagrees with phase 4")
    best = grid.get_best_result()
    want = min(trials, key=lambda r: r.metrics["loss"]) if trials else None
    print(f"[tune] ASHA (max_t {TUNE_MAX_T}, grace {TUNE_GRACE}, "
          f"reduction 2) stopped {len(stopped)} of {len(TUNE_LRS)} trials "
          f"at their grace rung: lr "
          f"{[r.config['lr'] for r in stopped]}; best lr "
          f"{best.config['lr']:g} at loss {best.metrics['loss']:.4f}; "
          f"the sweep {secs:.2f} s; card {card_line()}", flush=True)
    if not stopped or any(len(r.metrics["history"]["loss"]) != TUNE_GRACE
                          for r in stopped):
        fail("tune: ASHA stopped no trial at its grace rung")
    if want is None or best.config["lr"] != want.config["lr"]:
        fail("tune: the best result is not the lowest final loss of the "
             "trials that ran to max_t")

    ds = data.from_numpy(train_tokens(seed, B, S).numpy(), parallelism=1)
    trainer = TorchTrainer(
        train_run_loop,
        train_loop_config={"seed": seed, "steps": TUNE_TRAINER_STEPS,
                           "batch": B},
        scaling_config=ScalingConfig(num_workers=1, use_tpu=True),
        run_config=RunConfig(name="gpt2_trainer", storage_path=storage),
        datasets={"train": ds})
    t = time.perf_counter()
    grid = tune.Tuner(trainer, tune_config=tune.TuneConfig(
        metric="loss", mode="min"), run_config=tune.RunConfig(
        name="tune_trainer", storage_path=storage)).fit()
    secs = time.perf_counter() - t
    m = grid[0].metrics
    print(f"[tune] Tuner(TorchTrainer(train_run_loop)) through as_trainable, "
          f"1 trial, 1 worker on {m and m.get('device')}: {secs:.2f} s; step "
          f"{m and m.get('step')} loss {m and m.get('loss')} against phase "
          f"4's step {TUNE_TRAINER_STEPS} {ref[TUNE_TRAINER_STEPS - 1]} "
          f"(tol {TRAIN_RUN_LOSS_TOL}); launches in the worker "
          f"{m and m.get('launches')} (want "
          f"{n_layer * TUNE_TRAINER_STEPS} of each); errors {grid.errors}",
          flush=True)
    if grid.errors or not m or m["device"] != "cuda:0":
        fail("tune: the TorchTrainer trial failed or left the card")
    if m["step"] != TUNE_TRAINER_STEPS or abs(
            m["loss"] - ref[TUNE_TRAINER_STEPS - 1]) > TRAIN_RUN_LOSS_TOL:
        fail("tune: the TorchTrainer trial's loss disagrees with phase 4")
    if any(v != n_layer * TUNE_TRAINER_STEPS
           for v in m["launches"].values()):
        fail("tune: the TorchTrainer trial's launches are off")
    return {"tune_trials": launches, "tune_trainer": m["launches"]}


def rllib_checks(seed, storage):
    import numpy as np

    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib.algorithm import to_learner

    T, B = RL_SIZES["impala"]
    before = read_launches()
    grid = tune.Tuner(
        script_class("SmokeImpala"),
        param_space={"env_creator": script_class("SmokeAtariEnv"),
                     "cnn": True, "num_env_runners": 1,
                     "num_envs_per_runner": B, "rollout_length": T,
                     "seed": seed},
        tune_config=tune.TuneConfig(
            resources_per_trial={"CPU": 1, "TPU": 1},
            stop={"training_iteration": RLLIB_ITERS}),
        run_config=tune.RunConfig(name="impala", storage_path=storage)).fit()
    if grid.errors:
        fail(f"rllib: the trial errored: {grid.errors}")
    m = grid[0].metrics
    ckpt = grid[0].checkpoint.to_dict()
    numeric = {k: v for k, v in m.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    frames = T * B
    print(f"[rllib] IMPALA's Algorithm in a Tune trial, learner on "
          f"{m['device']}, 1 rollout actor, T={T} x B={B} frames of "
          f"{ATARI_OBS}: {m['training_iteration']} iterations, "
          f"{m['num_env_steps_sampled']} env steps; last iteration "
          f"{m['iter_ms']:.1f} ms ({frames * 1e3 / m['iter_ms']:.1f} "
          f"frames/s, the rollout's transfer and conversion included), its "
          f"update {m['update_ms']:.3f} ms ({frames * 1e3 / m['update_ms']:.1f}"
          f" frames/s; phase 14's update "
          f"{PHASE_REF.get('impala_ms', float('nan')):.3f} ms); "
          f"env_steps_per_sec {m['env_steps_per_sec']:.1f}; metrics "
          f"{ {k: round(v, 6) for k, v in numeric.items()} }; flash "
          f"launches in the trial {m['launches']}; card {card_line()}",
          flush=True)
    if m["device"] != "cuda:0":
        fail("rllib: the learner was not on the card")
    if not all(math.isfinite(v) for v in numeric.values()):
        fail(f"rllib: a metric is not finite: {numeric}")
    if m["num_env_steps_sampled"] != RLLIB_ITERS * frames or \
            ckpt["total_env_steps"] != RLLIB_ITERS * frames:
        fail("rllib: env steps sampled are off")
    if any(m["launches"].values()) or read_launches() != before:
        fail("rllib: the RL path launched a flash kernel")

    # the CPU learner from the card's initial weights over the same rollouts
    cfg = impala.ImpalaConfig()
    cfg.cnn, cfg.seed = True, seed
    params, _ = impala._init_params_and_opt(cfg, ATARI_OBS, ATARI_ACTIONS,
                                            device="cuda")
    params = to_device(params, "cpu")
    p0 = rl_models.params_to_numpy(params)
    update = impala._make_update_fn(cfg, impala.make_optimizer(cfg, params))
    t = time.perf_counter()
    first = None
    for i in range(RLLIB_ITERS):
        out = update(params, to_learner(
            impala.time_major(smoke_rollout(seed, i, T, B)), "cpu"))
        first = first or {k: float(v) for k, v in out.items()}
    replay_s = time.perf_counter() - t
    cpu = rl_models.params_to_numpy(params)
    leaf_err = 0.0
    for a, b, w0 in zip(optim.tree_leaves(ckpt["weights"]),
                        optim.tree_leaves(cpu), optim.tree_leaves(p0)):
        apart = float(np.linalg.norm(a - b))
        tol = float(RL_MOVE_RTOL * np.linalg.norm(b - w0)
                    + RL_ULP * np.linalg.norm(b))
        leaf_err = max(leaf_err, apart / tol if apart else 0.0)
    m_err = max(abs(m["first_update"][k] - v) / (RL_RTOL * abs(v) + RL_ATOL)
                for k, v in first.items())
    print(f"[rllib] the CPU learner replayed {RLLIB_ITERS} updates from the "
          f"same initial weights over the same rollouts in {replay_s:.2f} s:"
          f" the trial's final weights (its checkpoint) {leaf_err:.3f} of "
          f"their tolerance (||p - p_cpu|| <= {RL_MOVE_RTOL} ||p_cpu - p_0|| "
          f"+ {RL_ULP} ||p_cpu||); the first update's metrics, card "
          f"{m['first_update']} against CPU {first}: {m_err:.3f} of their "
          f"tolerance (|a - b| <= {RL_RTOL} |b| + {RL_ATOL})", flush=True)
    if leaf_err > 1 or m_err > 1:
        fail("rllib: the card's learner disagrees with the CPU replay")


# ---------------------------------------------------------------------------
# phases 21 and 22: workflows, job submission, the autoscaler, the
# dashboard and the CLI on the port's runtime
# ---------------------------------------------------------------------------

# phase 22's card node is removed once it has been idle this long
AUTOSCALE_IDLE_S = 8.0


def card_forward(seed, prompt, log_path=None):
    """Phase 3's first forward in a GPU task: GPT-2 124M from ``seed``, one
    forward over ``prompt``, with the forward kernel's launches counted in
    this process from 0; appended to ``log_path`` where given, so a caller
    sees every run of the task.  The runtime takes the logits to the host.
    Shipped by reference from the module ``chip_smoke``."""
    fa.KERNEL_LAUNCHES = 0
    gen = Generator("small", "cuda", seed)
    logits = gen.logits({"prompt": prompt})
    torch.cuda.synchronize()
    launches = fa.KERNEL_LAUNCHES
    if log_path:
        with open(log_path, "a") as f:
            f.write(f"{launches}\n")
    return {"logits": logits, "launches": launches,
            "node": os.environ.get("RAY_TPU_NODE_ID")}


def fail_first(value, flag_path):
    """A CPU step that fails on its first attempt (it leaves ``flag_path``
    behind) and passes ``value`` on after that."""
    if not os.path.exists(flag_path):
        open(flag_path, "w").close()
        raise RuntimeError("the second step fails on its first attempt")
    return {**value, "gate_sees_card": torch.cuda.is_available()}


def job_main(seed):
    """A submitted job's entrypoint (``python3 -c "import chip_smoke as c;
    c.job_main(seed)"``): it counts the cards it sees, attaches to the
    cluster (``RAY_TPU_ADDRESS``) and runs phase 3's first forward in a
    task with ``num_tpus=1``; one ``JOB {json}`` line."""
    import ray_tpu_torch as rt

    cards = torch.cuda.device_count()
    print(f"JOB-CARDS {cards} CUDA_VISIBLE_DEVICES="
          f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}", flush=True)
    rt.init()
    prompt = serve_prompts(seed)[1][500]
    out = rt.get(rt.remote(num_tpus=1)(card_forward).remote(seed, prompt),
                 timeout=600)
    print("JOB " + json.dumps({
        "cards": cards, "digest": tensor_checksum(out["logits"])[0],
        "launches": out["launches"], "dtype": str(out["logits"].dtype),
        "device": out["logits"].device.type}), flush=True)
    rt.shutdown()


def phase_workflow_job(seed, serve_ref):
    """Phase 21: a port ``Cluster`` of one node with the card, under a
    session root of its own: a workflow whose first step runs phase 3's
    first forward on the card and whose second step fails once, resumed;
    then a submitted job whose task runs the same forward.  Returns the
    forward kernel's launches by path."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    with port_session("workflow") as env:
        c = Cluster(initialize_head=True,
                    head_resources={"num_cpus": 2, "num_tpus": 1}, env=env)
        try:
            c.wait_for_nodes(1)
            c.connect()
            launches = {
                "workflow": workflow_checks(rt, seed, serve_ref,
                                            env["RAY_TPU_TEMP_DIR"]),
                "job": job_checks(c, seed, serve_ref)}
            rt.shutdown()
        finally:
            c.shutdown()
    return launches


def workflow_checks(rt, seed, serve_ref, root):
    import pickle

    from ray_tpu_torch import workflow

    store = os.path.join(root, "workflows")
    workflow.init_storage(store)
    log = os.path.join(root, "card_forward.log")
    flag = os.path.join(root, "fail_first.flag")
    forward = rt.remote(num_tpus=1)(script_class("card_forward"))
    gate = rt.remote(num_cpus=1, max_retries=0)(script_class("fail_first"))
    dag = gate.bind(forward.bind(seed, serve_ref["prompts"][500], log), flag)
    t = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="phase21")
    except Exception as e:  # noqa: BLE001 - the second step's failure
        first_error = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    else:
        fail("workflow: the second step did not fail on its first attempt")
    run_s = time.perf_counter() - t
    status = workflow.get_status("phase21")
    step = os.path.join(store, "phase21", "000_card_forward.pkl")
    with open(step, "rb") as f:
        ckpt = pickle.load(f)["logits"]
    runs = open(log).read().split()
    print(f"[workflow] run: {run_s:.2f} s, status {status} ({first_error}); "
          f"step 1 ran {len(runs)} time(s) on the card with {runs} flash_fwd "
          f"launches; its checkpoint holds a {ckpt.device.type} "
          f"{ckpt.dtype} tensor {tuple(ckpt.shape)}, bit-equal to phase "
          f"3's first logits: {torch.equal(ckpt, serve_ref['logits'])}",
          flush=True)
    if status != "FAILED" or runs != [str(gpt2.GPT2_SMALL.n_layer)]:
        fail("workflow: the first run did not fail after step 1 ran once")
    if ckpt.device.type != "cpu" or not torch.equal(ckpt,
                                                    serve_ref["logits"]):
        fail("workflow: step 1's checkpoint is not phase 3's logits on the "
             "host")
    t = time.perf_counter()
    out = workflow.resume("phase21")
    resume_s = time.perf_counter() - t
    again = open(log).read().split()[len(runs):]
    resumed_launches = sum(int(x) for x in again)
    same = torch.equal(out["logits"], serve_ref["logits"])
    print(f"[workflow] resume: {resume_s:.2f} s, status "
          f"{workflow.get_status('phase21')}; step 1 ran {len(again)} more "
          f"time(s), flash_fwd launches on resume {resumed_launches}; the "
          f"output's logits ({out['logits'].device.type} "
          f"{out['logits'].dtype}) bit-equal to phase 3's: {same}; the CPU "
          f"step sees the card: {out['gate_sees_card']}", flush=True)
    if again or resumed_launches or not same or out["gate_sees_card"] \
            or workflow.get_status("phase21") != "SUCCESSFUL":
        fail("workflow: resume did not return step 1's logits from its "
             "checkpoint")
    return out["launches"]


def job_checks(c, seed, serve_ref):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    want = tensor_checksum(serve_ref["logits"])[0]
    client = JobSubmissionClient(c.address)
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    t = time.perf_counter()
    job = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import chip_smoke as c; "
        f"c.job_main({seed})\"",
        runtime_env={"env_vars": {"PYTHONPATH": path}})
    status = client.wait_until_finished(job, timeout=600)
    job_s = time.perf_counter() - t
    logs = client.get_job_logs(job)
    lines = [json.loads(l[len("JOB "):]) for l in logs.splitlines()
             if l.startswith("JOB ")]
    cards = [l for l in logs.splitlines() if l.startswith("JOB-CARDS")]
    print(f"[job] submitted job: {status} in {job_s:.2f} s; the "
          f"entrypoint printed {cards}; its task's result "
          f"{lines[-1] if lines else None}; digest equals phase 3's: "
          f"{bool(lines) and lines[-1]['digest'] == want}", flush=True)
    if status != JobStatus.SUCCEEDED or not lines:
        fail(f"job: {status}; its logs:\n{logs[-3000:]}")
    res = lines[-1]
    if res["cards"] != 0 or res["digest"] != want or res["device"] != "cpu" \
            or res["launches"] != gpt2.GPT2_SMALL.n_layer:
        fail("job: the entrypoint saw a card, or its task's logits are not "
             "phase 3's, or its task did not launch the forward kernel once "
             "a layer")
    return res["launches"]


def phase_autoscale(seed, serve_ref):
    """Phase 22: an ``AutoscalingCluster`` (a CPU head, one worker type
    with the card) scales a node up for a pending ``num_tpus=1`` task and
    removes it once idle; the dashboard and the CLI show the card while the
    node is up.  Returns the forward kernel's launches on that node."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import AutoscalingCluster

    with port_session("autoscaler") as env:
        c = AutoscalingCluster(
            head_resources={"CPU": 1.0},
            worker_node_types={"card": {
                "resources": {"CPU": 1.0, "TPU": 1.0}, "min_workers": 0,
                "max_workers": 1, "object_store_mb": 256}},
            max_workers=1, idle_timeout_s=AUTOSCALE_IDLE_S,
            update_interval_s=0.2, env=env)
        try:
            c.connect()
            launches = autoscale_checks(rt, c, seed, serve_ref)
        finally:
            c.shutdown()
    return launches


def wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"autoscaler: {what} within {timeout} s")
        time.sleep(0.05)


def autoscale_checks(rt, c, seed, serve_ref):
    import urllib.request

    from ray_tpu_torch.dashboard import DashboardHead

    resources = rt.cluster_resources()
    if resources.get("TPU") or c.worker_node_ids():
        fail(f"autoscaler: the cluster starts with {resources}")
    t = time.perf_counter()
    ref = rt.remote(num_tpus=1)(script_class("card_forward")).remote(
        seed, serve_ref["prompts"][500])
    wait_until(lambda: rt.cluster_resources().get("TPU") == 1.0, 120,
               "no node with the card came up")
    up_s = time.perf_counter() - t
    node = c.worker_node_ids()
    d = DashboardHead(c.address)
    try:
        with urllib.request.urlopen(d.url + "/api/cluster_resources",
                                    timeout=30) as resp:
            dash = json.loads(resp.read())["total"]
    finally:
        d.shutdown()
    cli = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "status",
         "--address", c.address], capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=120)
    cli_total = json.loads(cli.stdout.split("resources:", 1)[1]
                           .splitlines()[0]) if "resources:" in cli.stdout \
        else {}
    print(f"[autoscaler] a pending num_tpus=1 task brought up a node with "
          f"the card in {up_s:.2f} s ({node}); the dashboard's "
          f"/api/cluster_resources total {dash}; `python -m "
          f"ray_tpu_torch.scripts status` resources {cli_total}", flush=True)
    if len(node) != 1 or dash.get("TPU") != 1.0 \
            or cli_total.get("TPU") != 1.0:
        fail(f"autoscaler: the dashboard or the CLI does not show the card:"
             f" {cli.stdout}{cli.stderr}")
    out = rt.get(ref, timeout=600)
    task_s = time.perf_counter() - t
    same = torch.equal(out["logits"], serve_ref["logits"])
    print(f"[autoscaler] the task ran on {out['node']} in {task_s:.2f} s "
          f"from submit: flash_fwd launches {out['launches']}, logits "
          f"bit-equal to phase 3's: {same}", flush=True)
    launches = out["launches"]
    if out["node"] != node[0] or not same \
            or launches != gpt2.GPT2_SMALL.n_layer:
        fail("autoscaler: the task on the new node disagrees with phase 3")
    del out, ref
    t = time.perf_counter()
    wait_until(lambda: not c.worker_node_ids(), AUTOSCALE_IDLE_S + 60,
               "the idle node was not removed")
    down_s = time.perf_counter() - t
    wait_until(lambda: not rt.cluster_resources().get("TPU"), 30,
               "the removed node's card is still counted")
    print(f"[autoscaler] scale-up {up_s:.2f} s, scale-down {down_s:.2f} s "
          f"after the task's result (idle_timeout_s {AUTOSCALE_IDLE_S}); "
          f"terminations {c.autoscaler.num_terminations}, launches "
          f"{c.autoscaler.num_launches}", flush=True)
    if down_s < AUTOSCALE_IDLE_S - 1.0 or c.autoscaler.num_launches != 1:
        fail("autoscaler: the node went before its idle timeout, or more "
             "than one was launched")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    set_precision()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    seconds = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"[time] phase {name}: {seconds[name]} s", flush=True)
        return out

    run("1 build", phase_build)
    run("1b sm90", phase_sm90_checks, args.seed)
    kern = run("2 kernels", phase_kernels, args.seed)
    bwd = run("2b backward kernels", phase_bwd_kernels, args.seed)
    serve_launches, serve_ref = run("3 serve", phase_serve, args.seed,
                                    args.profile)
    train = run("4 train", phase_train, args.seed, args.profile)
    llama_launches, llama_ref = run("5 llama", phase_llama, args.seed,
                                    args.profile)
    moe_serve, moe_train = run("6 moe", phase_moe, args.seed, args.profile)
    xl_train = run("7 xl", phase_xl, args.seed, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        pools = run("8-13 ranks up", start_pools, tmp)
        try:
            sp_runs = run("8 sp", phase_sp, args.seed, pools)
            pp_runs = run("9 pp", phase_pp, args.seed, pools)
            tp_runs = run("10 tp", phase_tp, args.seed, pools)
            ep_runs = run("11 ep", phase_ep, args.seed, pools)
            fsdp_runs = run("12 fsdp", phase_fsdp, args.seed, pools)
            moe_pp_runs = run("13 moe pp", phase_moe_pp, args.seed, pools)
        finally:
            for pool in pools.values():
                pool.close()
    run("14 rl", phase_rl, args.seed)
    runtime_launches = run("15 runtime", phase_runtime, args.seed, serve_ref,
                           args.profile)
    serve_run_launches = run("16 serve run", phase_serve_run, args.seed,
                             serve_ref, llama_ref)
    run("17 cluster", phase_cluster, args.seed)
    train_run = run("18 train run", phase_train_run, args.seed)
    tune_runs = run("19-20 tune, rllib", phase_tune_rllib, args.seed)
    tools_launches = run("21 workflow, job", phase_workflow_job, args.seed,
                         serve_ref)
    tools_launches["autoscaler"] = run("22 autoscaler", phase_autoscale,
                                       args.seed, serve_ref)
    print(f"[time] phases: {seconds}; all {sum(seconds.values()):.1f} s",
          flush=True)
    print(card_line())
    src = "ray_tpu/ops/flash_attention.py"
    trained = {"train": train, "moe_train": moe_train, "xl_train": xl_train,
               **sp_runs, **pp_runs, **tp_runs, **ep_runs, **fsdp_runs,
               **moe_pp_runs, **train_run, **tune_runs}
    paths = {
        "flash_fwd": {"serve": serve_launches, "llama": llama_launches,
                      "moe_serve": moe_serve,
                      "runtime_actor": runtime_launches,
                      **serve_run_launches, **tools_launches},
        "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, by_path in paths.items():
        by_path.update({path: run[name] for path, run in trained.items()})
    rows = [
        ("flash_fwd", "flash_fwd.cu", f"{src}:443", [f"{src}:192"], kern),
        ("flash_bwd_dq", "flash_bwd.cu", f"{src}:213",
         [f"{src}:203", f"{src}:463"], bwd["dq"]),
        ("flash_bwd_dkv", "flash_bwd.cu", f"{src}:268",
         [f"{src}:203", f"{src}:463"], bwd["dkv"]),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"ray_tpu_torch/csrc/{source}", "replaces": replaces,
        "also_replaces": also, "launches": sum(paths[name].values()),
        "launches_by_path": paths[name], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, source, replaces, also, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
