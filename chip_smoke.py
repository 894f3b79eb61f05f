#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines, each failing the run on any error:

  1. the card (``nvidia-smi`` name and power limit), the torch, CUDA and
     nvcc versions; the kernels built from ``src/repro_torch/csrc`` (one
     nvcc per source, all started together).
  2. each of the six GNN kernels against its plain PyTorch version on
     the same inputs, at the shapes its path gives it (the two scan
     kernels: path K3):
       * the serving kernels at collab-like F=496 -> H=64 and 64 -> 16,
         S=8, 372,475 destination rows with some zero-degree rows, on
         ideal, default bit-accurate and 12-bit-ADC/64-row numerics and
         both ``relu`` values; the quant layer also on ReRAM-noisy codes
         (its two-digit int8 path), at a ragged 67 -> 64 and, on 3,000
         rows, at the F of cora (1433), citeseer (3703) and 3704 -> 64,
         where its shared memory holds fewer columns a block; aggregation,
         zmax and the ideal layer also at F=67, with an x off 16-byte
         alignment (the scalar variants) and on rows whose only live slot
         is slot 5; the ideal layer also, on 3,000 rows, at 496 -> 130
         (ragged column tiles) and 1433, 3703 and 3704 -> 64 (K in
         chunks). Aggregation, zmax and the quant layer must be equal bit
         for bit; the ideal layer agrees within rtol 1e-5, atol 1e-5 *
         max|ref| (its 3xTF32 product sums in another order).
       * the wide and deep cases of the bit-accurate kernels, bit for bit
         on 3,000 rows, clean and noisy: the quant layer with K in chunks
         at tile-padded depths 4,960 (F 3,703 at rows_per_xbar 48), 3,712
         (F 3,703 at 64) and 4,800 (F 4,769 at 512, and at 4,096 rows: a
         tile deeper than a chunk, also with two passes), with 16-bit DAC
         codes at F 3,703 (64 and 48 rows: two passes), with 13-bit
         conductance codes at F 4,769 and 256 rows (three digits) and with
         both at F 3,703 and 64 rows; both the quant layer and the
         crossbar with 12-, 16- and 30-bit DAC codes (default and 64-row
         numerics) and 12- and 16-bit conductance codes at 64 rows.
       * the four serving kernels at the shapes a bucket of the bucketed
         layout gives them: Nd = 8 and 40 rows over a table of Nd + 16,
         S = 1, 2 and 4 with padding slots, F = 16 and 496.
       * ``cam_search`` at one k-NN launch of the recsys scenario at 20,000
         nodes (Q = 104 tagged query ids against E = 160,000 entries), at
         a ragged Q = 7, E = 160,001, with negative queries, and at
         Q = 600,000, E = 64 (past the grid's query limit): exact.
       * ``crossbar_matmul_quantized`` at 32 x 216 x 64 (the variation
         bounds), 372,475 x 496 x 64 (layer 1 of the centralized collab
         path) and, on 3,000 rows, at K = 1,100 (ragged crossbar tiles)
         and K = 5,000 (K in chunks of the staged depth), through the
         conductance-code and the programmed-weights entry points,
         default and 12-bit-ADC/64-row numerics, clean and noisy
         conductance codes: exact; and ``crossbar_matmul_signed`` on the
         kernel equal to ``crossbar_matmul_signed_ref`` bit for bit.
  3. the paths, each driven through its entry points with the launch
     counters set to 0 just before and read just after; every kernel a
     path runs must have launched:
       * serving: ``GNNServer`` with GNNConfig(in_dim=496, hidden_dims=(64,),
         out_dim=16, sample=8), centralized on collab at scale 1.0,
         decentralized on 8 clusters in both exchange modes and semi on
         4 heads x 4 spokes at scale 0.1, each refreshed and answering 64
         batches of 16 lookups on ``fused`` and ``pallas`` with ideal and
         bit-accurate numerics, against ``jnp`` on the card at rtol and
         atol 1e-4 * max|ref|.
       * path A, CAM-built k-NN serving: the recsys and anomaly graphs at
         20,000 nodes (F=32, 8 bands x 8 bits, k=8) built on the
         ``cam-pallas``, ``cam`` and ``topk`` paths must be equal bit for
         bit, ``cam_search`` launched ceil(N / 13) times per build; a
         centralized plan on that graph served as above (in_dim=32); and
         the CLI driven once with ``--dataset recsys --neighbor-mode
         cam-pallas --setting centralized --scale 0.1``.
       * path B, conductance-variation bounds: ``mvm_error_bounds`` for the
         four technologies, ``pallas`` (18 crossbar launches each) equal
         to ``jnp`` field for field; ``noisy_forward`` with ReRAM noise on
         collab at scale 0.1, 4 trials, on ``fused`` and ``pallas`` against
         ``jnp`` at 1e-4 * max|ref|; ``accuracy_bounds`` for the same
         configuration, printed.
       * path C, the capacity-bucketed layout: C1, collab at scale 0.1
         (F 496 -> 64 -> 16, S 8) decentralized on 16 edge-balanced
         clusters and semi 4 x 4, ``buckets="auto"``, on every backend
         with ideal and bit-accurate numerics, in both halo schedules
         (``overlap`` on a side stream, ``serial``): overlap equal to
         serial bit for bit, the embeddings equal to the dense plan's on
         the same partition bit for bit (the ``jnp``/``pallas`` ideal
         layer's ``torch.matmul``: within 1e-4 * max|ref|); C2, the
         million-node configuration of ``benchmarks/scale_serve.py``
         (random graph, 1,000,000 nodes, 4,000,000 edges, F 16, hidden 16,
         out 8, 64 clusters) on ``fused`` and ``pallas`` against the
         bucketed ``jnp`` backend within 1e-4 * max|ref|, with the padding
         gate (bucketed waste at most half the dense layout's, priced by
         ``layout_stats``). Each prints its layout, host set-up, the warm
         refresh of each schedule (median of 3, taking turns) and the
         launches of one refresh.
       * path D, streaming serving through ``StreamingGNNServer``, the
         launch counters set to 0 before each part: D1, centralized collab
         1.0 on ``fused``, ideal numerics, policy ``eager``, the
         ``cam-pallas`` frontier: a cold refresh and 6 ticks of feature
         churn at 0.001 of the nodes (372 rows a tick), each printing its
         commit seconds, recompute fraction, ``cam_search`` calls and the
         split of the commit between ``apply_deltas``, the frontier and
         the dirty-row steps (from the telemetry's spans); the served
         embeddings against a fresh ``make_forward`` of the shared plan on
         ``fused`` and ``jnp`` (rtol 1e-4, atol 1e-4 * max|ref|); one
         tick's frontier in ``numpy``, ``cam`` and ``cam-pallas`` mode,
         equal bit for bit; one bit-accurate commit, which must fall back
         to a full refresh equal bit for bit to a ``GNNServer`` refresh.
         D2, collab 0.1: decentralized on 8 clusters in both exchange
         modes, semi 4 x 4 and C1's bucketed plan, on ``fused`` and
         ``pallas``, policy ``interval`` (2), 4 ticks of feature churn at
         0.01 with 16 added and 4 removed edges: the embeddings against a
         centralized ``jnp`` forward of the mutated graph within 1e-4 *
         max|ref|, the summed incremental traffic at most the full
         exchange's bytes times the commits. Over path D
         ``fused_ideal_layer``, ``csr_aggregate``, ``cam_search``,
         ``fused_zmax`` and ``fused_quant_layer`` must each launch.
       * the traced refresh: one warm ``GNNServer`` refresh of
         centralized collab 1.0 on ``fused``, ideal and bit-accurate, with
         the port's telemetry on (``[trace]`` lines: ``server.refresh``,
         ``plan.forward`` closed by its device sync, and the rest, the
         scatter and its copy to the host), then under ``torch.profiler``
         with the spans mirrored into ``record_function``: the device-busy
         share of the ``server.refresh`` window (the chrome traces go to
         ``chiprun_out/``).
       * path E, the kernels' launch choices, tuning and calibration:
         E1 runs every tuning candidate (``tuning.candidates``) of every
         kernel at collab 1.0's layer 1 and layer 2, at the largest
         bucket of C1's bucketed plan, at the repaired deep shapes (F
         3,703 at 48 and 64 rows, 8- and 16-bit DAC codes, clean and
         noisy, and 13-bit conductance codes: the quant layer and the
         crossbar, whose carried sums a chunk depth must keep) and at the
         CAM's k-NN and frontier launches, each equal to the default
         launch with ``torch.equal``, and prints its CUDA-event ms; E2
         runs ``ExecutionPlan.tune_kernels`` on centralized collab 1.0
         (``fused`` ideal and bit-accurate, ``pallas``) and C1's bucketed
         plan on ``fused`` into a temporary ``TuneCache``: each winner no
         slower than the default, a second tune answered from the cache
         with no measurement and no launch, a tuned ``GNNServer`` refresh
         equal to the untuned one bit for bit; E3 calibrates the cost
         model's per-pass primitives on the card (``devices.calibrate``),
         loads them back strictly under the card's platform tag and prices
         the plan with them; E4 runs ``python -m repro_torch.launch.gnn
         --setting centralized --dataset collab --scale 0.1 --tune
         --tune-cache <tmp> --mapping --tech reram`` and holds its
         cost-model and mapper lines equal to the same plan's in this
         process. E2 and E3 must launch every kernel.
       * path F, the planner (``repro_torch.planner``), host code whose
         plans are served on the kernels: F1 runs ``plan`` model-only on
         the statistics of taxi and the four Table-2 datasets under the
         three objectives, static and mixed (churn 0.01, 64 lookups a
         tick), each recommendation the exhaustive argmin of
         ``score_candidate`` (taxi mixed must recommend semi), then the
         CLI's measured phase on collab 1.0 (shortlist 2), the ranking
         unchanged by it; F2, the load loops of ``benchmarks/load_serve.py
         --auto`` at collab 0.1 on ``fused`` with the ``cam-pallas``
         frontier, for centralized, decentralized 8, semi 4 x 4 (``eager``)
         and the planner's recommendation with a ``ReplanMonitor``
         attached: a closed loop, then an open loop of Poisson arrivals at
         0.8 of the closed loop's capacity, each 64 requests of 16 lookups
         with a tick of 1 % churn every 4 requests; every lookup served,
         percentiles monotone, a commit in the loops, the final embeddings
         equal to a centralized ``jnp`` forward of the mutated graph within
         1e-4 * max|ref|; F3, a pinned decentralized 8 ``pallas`` plan
         under a ``ReplanMonitor(window=2, tol=2.0, cooldown=1)``: 4
         ticks of 1 % churn, then ticks of 90 % until drift re-plans and
         swaps the plan on the card (measured above tol x reference,
         measured churn above 4x the assumed, a new configuration); F3b,
         a drift fed through ``observe`` with samples of the mixed
         workload swaps a pinned centralized server to the bucketed
         recommendation; after each swap the parameters are the same
         tensors, the first commit is a full refresh the ledger skips,
         the new backend's kernel launches and the lookups equal a fresh
         ``jnp`` forward of the live graph; F4 runs ``python -m
         repro_torch.launch.gnn --plan auto --dataset collab --scale 0.1``
         and the same with ``--stream 8 --neighbor-mode cam-pallas`` (at
         once), each one's summary equal to the same ``plan(...)`` made in
         this process. Over path F ``fused_ideal_layer`` and
         ``cam_search`` must launch.
       * path G, training (``gnn.grad_fn``, ``repro_torch.optim``,
         ``repro_torch.checkpoint``) and the paper's §4.2 taxi case study
         (``core.taxi``), on the plain PyTorch ops, as the reference trains
         on its ``jnp`` backend: G1, 8 AdamW steps of the GNN at collab
         1.0 (F 496 -> 64 -> 16, ideal numerics) on labels a linear map of
         the features predicts (argmax X·R), the loss finite and falling;
         ``grad_fn`` on the card against the host at collab 0.1 at the
         initial weights (every leaf within rtol 1e-4, atol 1e-4 *
         max|g_host|), and at the trained weights, which vary from run to
         run, printed with the count of layer-1 ReLU masks that flip
         between card and host; one bit-accurate
         ``grad_fn`` at collab 1.0 with finite, non-zero gradients; the
         trained weights saved by ``save_checkpoint``, restored onto the
         card equal (``torch.equal``) and served by ``GNNServer`` on
         ``fused`` and ``pallas`` within 1e-4 * max|ref| of ``jnp``. G2,
         the forecaster at the paper's size (``TaxiConfig()``, 10,000
         nodes, the example's three random edge types): 150 AdamW steps
         (lr 3e-3, warm-up 10), the loss finite and lower at the end,
         whether it halved (the example's LEARNED) printed; ``taxi.grad_fn``
         on the card against the host (loss rtol 1e-5, every leaf atol
         1e-4 * max|g_host|). Then the ms of a training step of G1 and G2
         (host clock between device syncs, median after the first) beside
         the card line. G3 runs ``python -m
         repro_torch.examples.taxi_forecast --nodes 10000 --steps 150``,
         its Table-1 lines equal to the cost model's in this process. Over
         path G ``fused_ideal_layer`` and ``csr_aggregate`` must launch.
         On the card ``adamw_update`` updates its tree in place, so the
         profiled steps and G1's training get clones of what is read
         afterwards.
       * path H, the SPMD runtime (``launch.mesh``, the SPMD forwards of
         ``distributed.halo``), on the collab 0.1 plans before path D
         mutates them: H1 a world of one rank on NCCL, a decentralized
         plan of one cluster through ``make_forward(mesh=...)`` on
         ``fused`` and ``pallas``, ideal and bit-accurate, both modes,
         equal to the emulated forward (``torch.equal``), and
         ``compressed_psum`` of a 64 x 496 gradient; H2 8 (decentralized
         8) and 4 (semi 4 x 4) gloo ranks sharing cuda:0 (NCCL refuses two
         ranks on one card), spawned with their own plan rows, each
         serving every case through ``GNNServer(mesh=...)`` (a refresh
         and 16 batches of 16 lookups): every rank's embeddings equal the
         emulated forward's on the card, every rank launched its
         backend's serving kernels; refresh ms (median of 3 after one
         warm-up), the collectives' share of a traced refresh, and the
         bytes a rank sent a layer beside ``measured_traffic``'s tier-1
         bytes; H3 the CLI under ``torch.distributed.run`` on 8 gloo
         ranks, its refresh line printed once, by rank 0.
       * path I, the LM stack (``repro_torch.models``, ``launch.train``,
         ``launch.serve``), which launches none of the six GNN kernels
         (their counts must stay 0; I3's recurrent smoke configs must reach
         the two scan kernels): I1 ``train()`` on internlm2-1.8b at its full
         published size (24 layers, d_model 2,048, 1.89 B parameters,
         bf16), batch 4 x seq 512, 6 AdamW steps, the loss finite and
         lower at the end; ms a step (host clock between device syncs,
         median after the first), tokens/s, model FLOPs over the bf16
         peak, peak device memory, and one step under ``torch.profiler``
         (busy share, top kernels); I2 ``Server`` at the same size, 4
         slots, capacity 128, the CLI's 8 requests of 16 new tokens: ms a
         batched decode step, tokens/s, every request's greedy tokens
         against a direct one-sequence decode chain teacher-forced on
         them (equal where every step's gap to the chain's top logit is 0;
         any gap within 0.05 * max|logit|), ``prefill`` against the
         teacher-forced chain (rtol, atol 0.15), a 4 x 128 prefill's ms,
         and ``python -m repro_torch.launch.serve --full`` as a
         subprocess; I3 the ten architectures' smoke configs, weights
         drawn on the host and carried to the card: at float32 the loss
         (rtol 1e-5), every gradient leaf (atol 1e-4 * max|g_host|) and
         three decode steps' logits (1e-4 * max|ref|), at bf16 the loss
         and logits within 0.05; and ``python -m
         repro_torch.examples.lm_train --steps 20`` (its fault and resume
         line); I4 one ``moe_ffn`` layer at grok-1's widths (d_model
         6,144, 8 experts of d_ff 32,768, top-2; 4.83 B parameters) on a
         [2, 128, 6144] batch against a dense f32 oracle on the card at
         capacity factor 8 (no drops; 0.05 * max|ref| + 1e-3), and at
         1.25 its dropped fraction and ms.
       * path J, the LM stack on a mesh (``distributed.sharding``,
         ``launch.train --mesh``, ``launch.elastic``, ``launch.dryrun``),
         which launches none of the six kernels: J1 ``train(mesh="1x1")``
         on a world of one NCCL rank at I1's size, seed and batches (the
         DTensor path; AdamW's kernels on its blocks, every step a
         ``dtensor`` call of ``update_paths()``), its losses within 1e-5 relative and every
         parameter within 1e-4 of its leaf's max|ref| of I1's, ms a step
         beside I1's and peak memory; J2 F7's probe (two ranks sharing
         cuda:0: gloo's plain all-gather and the functional one through
         the port's route must run), the DTensor redistributions on two
         gloo ranks sharing cuda:0 (all-reduce, reduce-scatter, all-to-all
         and the all-gather, each required), the smoke internlm2 on 1x2
         (TP) and 2x1 (ZeRO-1) meshes of gloo ranks sharing cuda:0 against
         one rank on the card (1e-5 / 1e-4), then the smoke configs of
         internlm2, grok-1 (3 experts: expert-inner TP) and deepseek-v3
         (EP) on a 2x2 mesh of gloo CPU ranks on the host, against one
         rank (1e-5 / 1e-4); J3 the elastic reshard of a 2x1 train()
         checkpoint onto 1x2 and one rank, continuing on the uninterrupted
         losses, on the card's shared ranks; J4 the dry run's seven cells
         at full published size (rwkv6-3b's ``train_4k`` runs the scans'
         backward op on meta tensors), each in its own process, all
         started together (per device bytes, FLOPs, collectives, the
         roofline modeled from the H100 data sheet, each within a
         deadline), and J1's own cell, its live bytes within 0.90-1.10 of
         J1's measured peak.
       * path K, the two sequence-scan kernels (``kernels.recurrence``:
         ``rglru_scan``, ``wkv6_scan``) on the recurrent architectures at
         full published widths: K3 first, each kernel forward and
         backward against its plain loop on the card at K2's RG-LRU layer
         (1 x 4,096 x 4,096), K1's RWKV layer (4 x 512, 40 heads of 64),
         the smoke shapes, Dh 32, a one-step decode, lengths that end in
         part of a tile or chunk and ragged RG-LRU widths, from a zero and
         a nonzero initial state (``rglru_scan``'s states and
         ``wkv6_scan``'s final state ``torch.equal``, y within rtol 1e-5 +
         1e-5 * max|y|, every gradient within 1e-4 * max|g_ref|, two
         launches of each kernel, forward and backward, equal), then
         ``wkv6_scan`` with S0 and its backward with dS at a 4-byte offset
         (views ``flat[1:]``), equal bit for bit to the launches on the
         aligned states, the
         card's residency of the ``wkv6_scan`` launches, and each kernel
         timed (CUDA events), forward and backward apart, beside its
         plain loop and its bound; K1
         ``train()`` on rwkv6-3b (the published Finch block: 32 layers,
         d_model 2,560, 3.10 B parameters, bf16) at I1's batch, 6 AdamW steps, finite losses,
         the mean loss on the six batches trained on lower at the final
         weights than at the initial ones (a step's loss on a fresh batch
         moves with the batch more than six warm-up steps move it), ms a
         step (each step's, with the caching allocator's counts over it),
         tokens/s, peak memory, train() again with each step profiled
         (kernel ms, the device's idle ms, the host's longest CUDA calls),
         one step of ``make_train_step`` alone profiled with the scans'
         share, and one layer's forward and
         backward with the kernel and with the plain loop (ms, peak
         bytes); K2 recurrentgemma-9b's prefill (38 layers, 10 B
         parameters, bf16) of 1 x 4,096 tokens under no_grad, its logits
         equal bit for bit to the same prefill with the plain loops, then
         8 decode steps through ``Server`` at 4 slots; and the gnn_serve
         demos ``--stream 12``, ``--buckets auto`` and ``--tech`` as
         subprocesses. K1 and K2 must launch both scans.
       * path L, four more architectures at full published widths and
         depth (bf16, weights drawn from a seed on the card), which
         launch none of the eight kernels: L1-L3 h2o-danube-3-4b,
         minicpm3-4b and qwen2-vl-2b through ``Server`` on I2's request
         mix, each checked as I2 is (a tied head's prefill against the
         decode chain on the same weights in float32, its bf16 gap
         printed), with its decode step profiled, a 4 x 128 prefill timed
         and its peak memory; L3 also a prefill whose M-RoPE positions
         differ by axis (an image of 4 x 8 patches inside 64 text tokens:
         finite, two runs equal) and ``python -m repro_torch.launch.serve
         --arch qwen2-vl-2b --full``; L4 whisper-base's encoder over 4 x
         1,500 frames and 16 greedy tokens through
         ``make_serve_step(with_enc=True)``, twice with equal tokens, the
         prefill against the decode chain (0.15 + 0.15 |ref|); L5 one
         layer each of h2o-danube-3-4b (window 4,096), recurrentgemma-9b
         (local window 2,048) and minicpm3-4b (MLA) decoded from an empty
         cache 256 / 256 / 128 steps past the window or the 1,024-token
         ``attn_chunk``, every output within 0.02 * (its position's
         max|ref| + |ref|) of the cacheless forward, the forward without
         the window outside that tolerance, the cache ending on the last
         positions.
       * path N (after path M), the AdamW kernels (``csrc/adamw.cu``,
         ``kernels.optim``) through ``optim.adamw_update``: the leaves of
         internlm2-1.8b and rwkv6-3b at full size (with their own
         gradient dtypes, and internlm2's with float32 gradients, the
         accumulation path's), leaves of 1, 7, 32,795 and 734,003,200
         elements and one off 16-byte alignment for each (parameter,
         gradient) dtype pair, and 100 leaves (more than a launch takes):
         the tensors handed back are those handed in, p, m and v equal
         bit for bit to the plain version's (``kernels.optim.ref``) given
         the kernel's clip scale, the norm within 1e-6 of a float64 sum
         and equal on a second run; the kernels timed (CUDA events) beside
         their bound and the plain version; then ``train()`` at I1's size
         for 3 steps: one ``kernel`` call of ``adamw_update`` and 2 + 2
         launches a step.
  4. each kernel's time (CUDA events) beside its plain version's, its
     bound on an H100 SXM and, for aggregation, ``torch.sparse.mm`` of the
     CSR sample matrix as the library yardstick: the serving kernels at
     layer 1 and layer 2 of the centralized path (the quant layer with
     the programming of its weights, as every serving call runs it, and
     per numerics and codes also its launch alone; zmax and the ideal
     layer also by the device time of the launch alone and beside their
     composed yardstick: aggregation then the row max and min, and the
     ``pallas`` backend's aggregation, matmul, bias and relu),
     ``cam_search`` at Q = 104, E = 160,000 (with the k-NN build's
     shares: its CAM calls and its bitmap folds) and
     ``crossbar_matmul_quantized`` at 372,475 x 496 x 64 (both numerics,
     clean and noisy codes), 372,475 x 64 x 16 and 32 x 216 x 64. These
     two are timed per wrapper call and by the device time of the launch
     alone (the profiler's kernel time). The wide and deep cases are timed by
     their launch at layer 1 (12-, 16- and 30-bit DAC codes, 12- and
     16-bit conductance codes) and on 3,000 rows at the deep cases. The
     build lines give each kernel's
     registers and spills.

The last lines are the card line, one JSON object with a record per
kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository around it, the script fails and prints no result.

``python3 chip_smoke.py --f7-probe`` runs only F7's probe, with the two
all-gather entry points that end gloo ranks holding CUDA tensors (the
process group's coalesced all-gather and the functional op without the
port's route) reported, not raised.

``python3 chip_smoke.py --k1`` runs only path K1 (rwkv6-3b's training
steps, each timed with the allocator's counts and profiled), on the
package beside the script: copied into another checkout, it compares
that checkout's K1 with this one's on the same card.

``python3 chip_smoke.py --adamw`` runs only path N.

``python3 chip_smoke.py --f6-loop ROUNDS`` runs none of that: it loops
path H1's eight cases ROUNDS times with CUDA_LAUNCH_BLOCKING=1 and a
device sync after every kernel launch, naming the launch before a fault,
then (unless ``--no-sanitizer``) one round under compute-sanitizer's
memcheck where the toolkit has it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import devices, neighbors  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.core import dataset_like, gnn, random_graph  # noqa: E402
from repro_torch.core.graph import TABLE2_DATASETS, TAXI_STATS  # noqa: E402
from repro_torch.core.partition import plan_execution  # noqa: E402
from repro_torch.kernels import (_build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.models.attention import (  # noqa: E402
    attention_paths, reset_attention_paths)
from repro_torch.kernels import crossbar_mvm as xb  # noqa: E402
from repro_torch.kernels.cam_match import (  # noqa: E402
    cam_search, cam_search_ref)
from repro_torch.kernels.crossbar_mvm import CrossbarNumerics  # noqa: E402
from repro_torch.kernels.csr_aggregate.ops import csr_aggregate  # noqa: E402
from repro_torch.kernels.csr_aggregate.ref import (  # noqa: E402
    csr_aggregate_ref)
from repro_torch.kernels.fused_layer import ops as fl  # noqa: E402
from repro_torch.launch import gnn as cli  # noqa: E402
from repro_torch.launch.gnn import GNNServer  # noqa: E402
from repro_torch.neighbors import knn  # noqa: E402
from repro_torch.planner import (OBJECTIVES, Candidate,  # noqa: E402
                                 CommitSample, PlanContext,
                                 ReplanMonitor, WorkloadProfile,
                                 candidate_space, plan,
                                 score_candidate)
from repro_torch.streaming import (StreamingGNNServer,  # noqa: E402
                                   expand_frontier)
from repro_torch import tuning  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core import taxi  # noqa: E402
from repro_torch.examples import taxi_forecast  # noqa: E402
from repro_torch.kernels import optim as kopt  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, compressed_psum, int8_compress,
                               int8_decompress, reset_update_paths,
                               update_paths)
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.tuning import (AggregateGeometry, CamGeometry,  # noqa: E402
                                CrossbarGeometry, FusedGeometry, TuneCache,
                                candidates, default_config, plan_geometries,
                                registry)
from repro_torch.analysis.roofline import H100, model_flops  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch import models as lm_models  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import common as lm_common  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.tuning.autotune import plan_tables  # noqa: E402
from repro_torch.tuning.measure import measurer, time_callable  # noqa: E402

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 flop/s on the CUDA
# cores, int8 op/s on the tensor cores.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TF32_OPS = 494.7e12     # dense, on the tensor cores
INT8_OPS = 1979e12

HIDDEN, OUT, SAMPLE = 64, 16, 8
QUANT = dict(in_bits=8, w_bits=8, adc_bits=12, rows_per_xbar=64)
SCENARIO_NODES = 20_000        # the CLI's --scale 0.1 (200,000 * 0.1)
TECHS = ("sot-mram", "reram", "sram", "fefet")

KERNELS = {   # name -> (source, TPU kernel it replaces): the GNN kernels
    "fused_ideal_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:142"),
    "fused_zmax": ("src/repro_torch/csrc/fused_layer.cu",
                   "src/repro/kernels/fused_layer/fused_layer.py:176"),
    "fused_quant_layer": ("src/repro_torch/csrc/fused_layer.cu",
                          "src/repro/kernels/fused_layer/fused_layer.py:202"),
    "csr_aggregate": ("src/repro_torch/csrc/csr_aggregate.cu",
                      "src/repro/kernels/csr_aggregate/csr_aggregate.py:39"),
    "crossbar_matmul_quantized": (
        "src/repro_torch/csrc/crossbar_mvm.cu",
        "src/repro/kernels/crossbar_mvm/crossbar_mvm.py:59"),
    "cam_search": ("src/repro_torch/csrc/cam_match.cu",
                   "src/repro/kernels/cam_match/cam_match.py:34"),
}


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def profiled_ms(fn, kernel: str, calls: int, tries: int = 3) -> tuple:
    """(mean device ms of one launch of the kernel whose name holds
    ``kernel``, how it was timed) over ``calls`` calls of ``fn``.

    The time is the kernel's own device time from ``torch.profiler``. The
    profiler's CUDA trace now and then comes back without the kernel; after
    ``tries`` such traces the launch is timed with CUDA events around
    ``calls`` back-to-back calls instead, and the text says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total += evt.device_time_total
                count += evt.count
        if count and total > 0:
            return total / count / 1e3, f"profiler, {count} launches"
    print(f"[time] the profiler showed no device time for {kernel} in "
          f"{tries} traces: timed with CUDA events", flush=True)
    return cuda_ms(fn, calls), f"CUDA events, {calls} calls"


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after two
    warm-up calls, from CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 2


def record(err: dict, name, got, ref, exact, label) -> None:
    """Hold one kernel output to its plain version's; fold the error into
    ``err[name]``."""
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == ref.dtype
            and bool(torch.isfinite(got).all()),
            f"{name} {label}: shape, type or non-finite values")
    diff = (got.double() - ref.double()).abs()
    e = float(diff.max()) if diff.numel() else 0.0
    err[name] = max(err[name], e)
    if exact:
        ok = torch.equal(got, ref)
        tol = "exact"
    else:
        scale = float(ref.abs().max()) or 1.0
        ok = bool((diff <= 1e-5 * scale + 1e-5 * ref.abs()).all())
        tol = f"rtol 1e-5 atol {1e-5 * scale:.3e}"
    print(f"[kernels] {name:18s} {label:34s} max|err| {e:.3e} ({tol}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} {label} disagrees with its plain version")


def kernel_checks(x1, x2, nbr, wts, params, device, err: dict) -> None:
    """The serving kernels against their plain versions on the same
    inputs; aggregation, zmax and the quant layer bit for bit. Beside the
    serving shapes: a ragged F = 67 and an x that is not 16-byte aligned
    (the scalar variants), and rows whose only live slot is slot 5."""
    gen = torch.Generator(device=device).manual_seed(7)
    x67 = x1[:, :67].contiguous()
    x_off = x1.reshape(-1)[1:1 + x1.numel() - x1.shape[1]].view(
        -1, x1.shape[1])            # N - 1 rows of F = 496, 4 bytes off 16
    nbr_off = torch.clamp_max(nbr, x_off.shape[0] - 1)
    wts_late = wts.clone()
    wts_late[1::5] = 0.0
    wts_late[1::5, 5] = 0.5         # only slot 5 live
    for x, nb, w_, tag in ((x1, nbr, wts, "F=496"), (x2, nbr, wts, "F=64"),
                           (x67, nbr, wts, "F=67 (scalar variant)"),
                           (x1, nbr, wts_late, "F=496 only slot 5 live"),
                           (x_off, nbr_off, wts, "F=496 x 4 B off 16 "
                                                 "(scalar variant)")):
        record(err, "csr_aggregate", csr_aggregate(x, nb, w_),
               csr_aggregate_ref(x, nb, w_), True, tag)
    w1, w67 = params[0]["w"], params[0]["w"][:67].contiguous()
    for x, nb, w_, w, tag in (
            (x1, nbr, wts, w1, "F=496 (496->64)"),
            (x2, nbr, wts, params[1]["w"], "F=64 (64->16)"),
            (x67, nbr, wts, w67, "F=67 (67->64, scalar variant)"),
            (x1, nbr, wts_late, w1, "F=496 only slot 5 live"),
            (x_off, nbr_off, wts, w1, "F=496 x 4 B off 16 (scalar "
                                      "variant)")):
        record(err, "fused_zmax", fl.fused_zmax(x, nb, w_),
               fl.fused_zmax_plain(x, nb, w_), True, tag)
        ideal_check(err, x, nb, w_, w, gen, tag)
    numerics = {"default": CrossbarNumerics(), "QUANT": CrossbarNumerics(
        **QUANT)}
    for x, w, tag in ((x1, w1, "496->64"), (x2, params[1]["w"], "64->16"),
                      (x67, w67, "67->64 (scalar variant)")):
        b = 0.1 * torch.randn(w.shape[1], generator=gen, device=device)
        for relu in (True, False):
            for nname, cfg in numerics.items():
                for noisy in (False, True):
                    nz = torch.from_numpy(devices.sample_conductance_noise(
                        3, tuple(w.shape), "reram", cfg)).to(device) \
                        if noisy else None
                    quant_check(err, x, nbr, wts, w, b, cfg, nz, relu,
                                f"{tag} {nname} noisy={noisy} relu={relu}")
    src = 4000                      # rows of x for the wide-F checks
    nbr_w = torch.remainder(nbr[:3000], src)
    wts_w = wts[:3000].contiguous()
    x = torch.randn((src, x1.shape[1]), generator=gen, device=device)
    ideal_check(err, x, nbr_w, wts_w,
                0.05 * torch.randn((x1.shape[1], 130), generator=gen,
                                   device=device), gen,
                "3000 rows 496->130 (ragged column tiles)")
    for f in (1433, 3703, 3704):
        x = torch.randn((src, f), generator=gen, device=device)
        w = 0.05 * torch.randn((f, HIDDEN), generator=gen, device=device)
        ideal_check(err, x, nbr_w, wts_w, w, gen,
                    f"3000 rows {f}->64 (K in chunks)")
        b = 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
        for nname, cfg in numerics.items():
            for noisy in (False, True):
                nz = torch.from_numpy(devices.sample_conductance_noise(
                    f, (f, HIDDEN), "reram", cfg)).to(device) \
                    if noisy else None
                quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                            f"3000 rows {f}->64 {nname} noisy={noisy}")


# the numerics of the wide cases: DAC codes of two bytes (in_bits 12,
# 16) and of four (30, the widest the kernels take) and conductance codes
# of two or three int8 digits (w_bits 12, 16)
WIDE = {"in_bits=12": dict(in_bits=12),
        "in_bits=12 64-row": dict(in_bits=12, adc_bits=12, rows_per_xbar=64),
        "in_bits=16": dict(in_bits=16),
        "in_bits=16 64-row": dict(in_bits=16, adc_bits=12, rows_per_xbar=64),
        "in_bits=30": dict(in_bits=30),
        "w_bits=12 64-row": dict(w_bits=12, rows_per_xbar=64),
        "w_bits=16 64-row": dict(w_bits=16, rows_per_xbar=64)}

# the deep cases of the quant layer, (F, numerics): depths whose digits do
# not fit a block's shared memory beside a row tile's codes, so K goes in
# chunks, with one pass and one or two digits (citeseer's F = 3,703 at
# rows_per_xbar 48, depth 4,960, and at 64, depth 3,712; F = 4,769 at 512,
# depth 4,800), with two passes of bit planes (in_bits 16 at 64 and 48
# rows), with three digits (w_bits 13 at 256 rows) and with both; and
# crossbar tiles of 4,096 rows, deeper than a chunk, whose sums are
# carried across chunks (one pass, and two with the chunks staged again)
DEEP = ((3703, dict(rows_per_xbar=48)), (3703, dict(rows_per_xbar=64)),
        (4769, dict(rows_per_xbar=512)),
        (4769, dict(rows_per_xbar=4096)),
        (4769, dict(in_bits=16, rows_per_xbar=4096)),
        (3703, dict(in_bits=16, rows_per_xbar=64)),
        (3703, dict(in_bits=16, rows_per_xbar=48)),
        (4769, dict(w_bits=13, rows_per_xbar=256)),
        (3703, dict(in_bits=16, w_bits=13, rows_per_xbar=64)))


def deep_inputs(device, seed: int) -> dict:
    """F -> (x [4000, F], w [F, 64], b [64]) of the deep cases."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for f in sorted({f for f, _ in DEEP}):
        out[f] = (torch.randn((4000, f), generator=gen, device=device),
                  0.05 * torch.randn((f, HIDDEN), generator=gen,
                                     device=device),
                  0.1 * torch.randn(HIDDEN, generator=gen, device=device))
    return out


def numerics_tag(numerics: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in numerics.items())


def wide_deep_checks(x1, nbr, wts, device, err: dict) -> None:
    """The wide and deep cases of the bit-accurate kernels, against their
    plain versions bit for bit on 3,000 rows, clean and ReRAM-noisy: the
    quant layer at the DEEP depths (K in chunks, with passes and three
    digits), and both kernels at F = 496 with the WIDE numerics."""
    gen = torch.Generator(device=device).manual_seed(11)
    src = 4000
    nbr_w = torch.remainder(nbr[:3000], src)
    wts_w = wts[:3000].contiguous()
    deep = deep_inputs(device, 11)
    for f, numerics in DEEP:
        x, w, b = deep[f]
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                f, (f, HIDDEN), "reram", cfg)).to(device) if noisy else None
            quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                        f"3000 rows {f}->64 {numerics_tag(numerics)} depth "
                        f"{fl.tile_depth(f, cfg.rows_per_xbar)} "
                        f"noisy={noisy}")
    x = x1[:src].contiguous()
    w = 0.05 * torch.randn((x.shape[1], HIDDEN), generator=gen,
                           device=device)
    b = 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
    z = csr_aggregate_ref(x, nbr_w, wts_w)
    for name, numerics in WIDE.items():
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                5, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            quant_check(err, x, nbr_w, wts_w, w, b, cfg, nz, True,
                        f"3000 rows 496->64 {name} noisy={noisy}")
            xq, _ = xb.quantize_inputs(torch.clamp_min(z, 0.0), cfg)
            codes = xb.program_conductances(w, cfg, nz)
            ref = xb.crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_quantized(xq, codes.wq, cfg), ref,
                   True, f"3000x496x64 {name} noisy={noisy} codes")
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_programmed(xq, codes, cfg), ref, True,
                   f"3000x496x64 {name} noisy={noisy} programmed")


def small_shape_checks(device, err: dict) -> None:
    """The four serving kernels at the shapes a bucket of the bucketed
    layout gives them, against their plain versions: Nd = 8 and 40 owned
    rows over a table of Nd + 16 halo rows, neighbor widths S = 1, 2 and
    4 (some slots padding), F = 16 and 496; aggregation, zmax and the
    quant layer bit for bit, the ideal layer within rtol 1e-5."""
    gen = torch.Generator(device=device).manual_seed(13)
    for nd in (8, 40):
        for s in (1, 2, 4):
            for f, h in ((16, 8), (496, 64)):
                n = nd + 16
                x = torch.randn((n, f), generator=gen, device=device)
                nbr = torch.randint(0, n, (nd, s), generator=gen,
                                    device=device, dtype=torch.int32)
                wts = torch.rand((nd, s), generator=gen, device=device)
                wts[1::3, -1] = 0.0          # padding slots
                w = 0.1 * torch.randn((f, h), generator=gen, device=device)
                b = 0.1 * torch.randn(h, generator=gen, device=device)
                tag = f"Nd={nd} S={s} F={f}->{h}"
                record(err, "csr_aggregate", csr_aggregate(x, nbr, wts),
                       csr_aggregate_ref(x, nbr, wts), True, tag)
                record(err, "fused_zmax", fl.fused_zmax(x, nbr, wts),
                       fl.fused_zmax_plain(x, nbr, wts), True, tag)
                ideal_check(err, x, nbr, wts, w, gen, tag)
                for nname, cfg in (("default", CrossbarNumerics()),
                                   ("QUANT", CrossbarNumerics(**QUANT))):
                    quant_check(err, x, nbr, wts, w, b, cfg, None, True,
                                f"{tag} {nname}")


def ideal_check(err, x, nbr, wts, w, gen, label) -> None:
    """The ideal layer against its plain version, with both ``relu``
    values, within rtol 1e-5, atol 1e-5 * max|ref|."""
    b = 0.1 * torch.randn(w.shape[1], generator=gen, device=x.device)
    for relu in (True, False):
        record(err, "fused_ideal_layer",
               fl.fused_ideal_layer(x, nbr, wts, w, b, relu=relu),
               fl.fused_ideal_layer_plain(x, nbr, wts, w, b, relu=relu),
               False, f"{label} relu={relu}")


def quant_check(err, x, nbr, wts, w, b, cfg, nz, relu, label) -> None:
    """The quant layer on programmed codes against its plain version, bit
    for bit."""
    codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nbr, wts), w,
                                      cfg, nz)
    record(err, "fused_quant_layer",
           fl.fused_quant_layer(x, nbr, wts, codes, b, scales, cfg,
                                relu=relu),
           fl.fused_quant_layer_plain(x, nbr, wts, codes.wq, b, scales, cfg,
                                      relu=relu),
           True, label)


def cam_inputs(device) -> tuple:
    """(entries [E], queries [Q]) of one k-NN launch of the recsys scenario
    at SCENARIO_NODES nodes: every node's tagged band signatures, and the
    tagged signatures of the first query chunk."""
    x, _ = neighbors.scenario_features("recsys", n_nodes=SCENARIO_NODES,
                                       feature_len=32)
    sigs = neighbors.lsh_signatures(x)
    n, b = sigs.shape
    chunk = knn._BITMAP_BUDGET // (n * b * b)
    entries = torch.from_numpy(neighbors.tag_bands(sigs)).to(device)
    return entries, entries[:chunk * b].clone()


def mvm_inputs(device) -> tuple:
    """(x, w) of ``mvm_error_bounds`` at its default 32 x 216 x 64."""
    rng = np.random.default_rng(0x0DA7A)
    x = torch.from_numpy(rng.standard_normal((32, 216)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((216, 64)) * 0.1)
                         .astype(np.float32))
    return x.to(device), w.to(device)


def crossbar_codes(x, w, cfg, noisy: bool) -> tuple:
    """(xq, codes) the kernel gets from ``crossbar_matmul`` on (x, w): DAC
    codes of max(x, 0) and the weights programmed with a ReRAM noise draw
    (``codes.wq`` the conductance codes, ``codes.digits`` their int8
    digits)."""
    xq, _ = xb.quantize_inputs(torch.clamp_min(x, 0.0), cfg)
    nz = torch.from_numpy(devices.sample_conductance_noise(
        1, tuple(w.shape), "reram", cfg)).to(w.device) if noisy else None
    return xq, xb.program_conductances(w, cfg, nz)


def crossbar_check(err, x, w, tag) -> None:
    """The crossbar kernel through both entry points (conductance codes and
    programmed weights) against its plain version, bit for bit, in both
    numerics on clean and noisy codes."""
    for nname, cfg in (("default", CrossbarNumerics()),
                       ("QUANT", CrossbarNumerics(**QUANT))):
        for noisy in (False, True):
            xq, codes = crossbar_codes(x, w, cfg, noisy)
            ref = xb.crossbar_matmul_quantized_plain(xq, codes.wq, cfg)
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_quantized(xq, codes.wq, cfg), ref,
                   True, f"{tag} {nname} noisy={noisy} codes")
            record(err, "crossbar_matmul_quantized",
                   xb.crossbar_matmul_programmed(xq, codes, cfg), ref, True,
                   f"{tag} {nname} noisy={noisy} programmed")


def new_kernel_checks(z1, w1, device, err: dict) -> None:
    """``cam_search`` and ``crossbar_matmul_quantized`` against their
    plain versions, exactly, at their paths' shapes; the CAM also past the
    grid's query limit, the crossbar also at a ragged K of three 512-row
    crossbar tiles and at a K that goes in chunks."""
    entries, queries = cam_inputs(device)
    ragged_e = torch.cat([entries, entries[:1]])
    negative = queries.clone()
    negative[::5] = -1
    negative[1::7] = -(1 << 20)
    gen = torch.Generator(device=device).manual_seed(3)
    few = entries[:64].clone()
    many = few[torch.randint(0, 64, (600_000,), generator=gen,
                             device=device)]
    many[::9] = -1
    for ci, q, tag in ((entries, queries, "Q=104 E=160000"),
                       (ragged_e, queries[:7].clone(), "Q=7 E=160001"),
                       (entries, negative, "Q=104 negative queries"),
                       (few, many, "Q=600000 E=64 (group loop)")):
        match, counts = cam_search(ci, q)
        ref_match, ref_counts = cam_search_ref(ci, q)
        record(err, "cam_search", match, ref_match, True, f"{tag} bitmap")
        record(err, "cam_search", counts, ref_counts, True, f"{tag} counts")
    x_small, w_small = mvm_inputs(device)
    crossbar_check(err, x_small, w_small, "32x216x64")
    crossbar_check(err, z1, w1, "372475x496x64")
    for k in (1100, 5000):
        x = torch.randn((3000, k), generator=gen, device=device)
        w = 0.05 * torch.randn((k, HIDDEN), generator=gen, device=device)
        crossbar_check(err, x, w, f"3000x{k}x64")
    for nname, cfg in (("default", CrossbarNumerics()),
                       ("QUANT", CrossbarNumerics(**QUANT))):
        nz = torch.from_numpy(devices.sample_conductance_noise(
            2, (216, 64), "reram", cfg)).to(device)
        got = xb.crossbar_matmul_signed(x_small, w_small, cfg, w_noise=nz)
        ref = xb.crossbar_matmul_signed_ref(x_small, w_small, cfg,
                                            w_noise=nz)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref)
        print(f"[kernels] crossbar_matmul_signed 32x216x64 {nname} noisy: "
              f"equal to crossbar_matmul_signed_ref: {ok}", flush=True)
        require(ok, "crossbar_matmul_signed differs from its oracle")


# ------------------------------------------------------------------ phase 3

EXPECTED = {("fused", True): ("fused_ideal_layer",),
            ("fused", False): ("fused_zmax", "fused_quant_layer"),
            ("pallas", True): ("csr_aggregate",),
            ("pallas", False): ("csr_aggregate",)}


def serve_cases(plan, cfg, modes, device, counted: bool, totals: dict,
                batches: int = 64, batch: int = 16) -> None:
    """Serve ``plan`` on fused and pallas with ideal and bit-accurate
    numerics, against the jnp backend on the same device."""
    n = plan.graph.n_nodes
    for mode in modes:
        for ideal in (True, False):
            c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                ideal=ideal))
            ref_srv = GNNServer(dataclasses.replace(plan, backend="jnp"), c,
                                mode=mode, device=device)
            t_ref = ref_srv.refresh()
            ref = ref_srv.embeddings
            del ref_srv
            scale = float(np.abs(ref).max()) or 1.0
            for backend in ("fused", "pallas"):
                srv = GNNServer(dataclasses.replace(plan, backend=backend),
                                c, mode=mode, device=device)
                reset_launch_counts()
                rng = np.random.default_rng(0)
                t0 = time.perf_counter()
                for _ in range(batches):
                    ids = rng.integers(0, n, batch)
                    out = srv.query(ids)
                    require(out.shape == (batch, cfg.out_dim)
                            and np.isfinite(out).all(),
                            "query returned a wrong shape or non-finite "
                            "values")
                t_cold = time.perf_counter() - t0
                counts = launch_counts()
                t_warm = srv.refresh()
                got = srv.embeddings
                require(got.shape == (n, cfg.out_dim), "embedding shape")
                diff = np.abs(got - ref)
                ok = bool((diff <= 1e-4 * scale + 1e-4 * np.abs(ref)).all())
                label = (f"{plan.setting:13s} {mode:9s} {backend:6s} "
                         f"{'ideal' if ideal else 'bit-accurate':12s}")
                print(f"[serve] {label} refresh+{batches}x{batch} lookups "
                      f"{t_cold * 1e3:.1f} ms, warm refresh "
                      f"{t_warm * 1e3:.1f} ms (jnp {t_ref * 1e3:.1f} ms); "
                      f"max|err| {float(diff.max()):.3e} vs jnp "
                      f"(tol {1e-4 * scale:.3e}) {'ok' if ok else 'FAIL'}; "
                      f"launches {json.dumps(counts)}", flush=True)
                require(ok, f"{label} disagrees with the jnp backend")
                require(srv.refreshes == 2, "the server refreshed more than "
                        "once for one version")
                if counted:
                    for k in EXPECTED[(backend, ideal)]:
                        require(counts[k] > 0, f"{label}: {k} never "
                                f"launched on its path")
                for k, v in counts.items():
                    totals[k] += v
                del srv


def counted(what: str, fn, expect: dict, totals: dict):
    """Run ``fn`` with every launch counter at 0 and read the counters
    after it: ``expect`` maps a kernel to its exact launch count, or to
    None for "at least once". Adds the counts to ``totals``; returns what
    ``fn`` returns."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[launches] {what}: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    for k, n in expect.items():
        require(counts[k] > 0 if n is None else counts[k] == n,
                f"{what}: {k} launched {counts[k]} times, want "
                f"{'> 0' if n is None else n}")
    for k, v in counts.items():
        totals[k] += v
    return out


def path_a(device, totals: dict) -> dict:
    """CAM-built k-NN serving: both scenarios' graphs on the three paths,
    a centralized plan served on them, and the CLI. Returns each
    scenario's build seconds on ``cam-pallas`` (host clock)."""
    n = SCENARIO_NODES
    per_launch = knn._BITMAP_BUDGET // (n * 64)        # query nodes
    launches = -(-n // per_launch)
    cfg = gnn.GNNConfig(in_dim=32, hidden_dims=(HIDDEN,), out_dim=OUT,
                        sample=SAMPLE)
    builds = {}
    for name in neighbors.SCENARIOS:
        graphs = {}
        for mode, backend in (("cam", "pallas"), ("cam", "jnp"),
                              ("topk", "jnp")):
            t0 = time.perf_counter()
            graphs[mode, backend] = counted(
                f"{name} k-NN {mode}/{backend}",
                lambda mode=mode, backend=backend: neighbors.scenario_graph(
                    name, n_nodes=n, feature_len=32, k=SAMPLE,
                    neighbor_mode=mode, backend=backend, device=device),
                {"cam_search": launches if backend == "pallas" else 0},
                totals)
            secs = time.perf_counter() - t0
            if backend == "pallas":
                builds[name] = secs
            g = graphs[mode, backend]
            print(f"[pathA] {name} {mode}/{backend}: {g.n_nodes} nodes, "
                  f"{g.n_edges} edges, built in {secs:.3f} s (host clock)",
                  flush=True)
        ref = graphs["cam", "pallas"]
        for (mode, backend), g in graphs.items():
            require(all(np.array_equal(getattr(g, a), getattr(ref, a))
                        for a in ("indptr", "indices", "edge_weight")),
                    f"{name}: the {mode}/{backend} graph differs from "
                    f"cam/pallas")
        print(f"[pathA] {name}: cam-pallas, cam and topk graphs equal bit "
              f"for bit ({launches} cam_search launches per build)",
              flush=True)
        plan = plan_execution(ref.gcn_normalize(), "centralized",
                              sample=SAMPLE)
        serve_cases(plan, cfg, ("alltoall",), device, True, totals)
    counted("CLI --dataset recsys --neighbor-mode cam-pallas",
            lambda: cli.main(["--dataset", "recsys", "--neighbor-mode",
                              "cam-pallas", "--setting", "centralized",
                              "--scale", "0.1"]),
            {"cam_search": launches, "fused_ideal_layer": None}, totals)
    return builds


def path_b(device, g, totals: dict) -> None:
    """Conductance-variation bounds: MVM bounds of the four technologies
    on both crossbar backends, noisy forwards on the three GNN backends,
    and the end-to-end bounds."""
    for tech in TECHS:
        plain = counted(
            f"mvm_error_bounds {tech} jnp",
            lambda tech=tech: devices.mvm_error_bounds(
                tech, backend="jnp", device=device),
            {"crossbar_matmul_quantized": 0}, totals)
        kernel = counted(
            f"mvm_error_bounds {tech} pallas",
            lambda tech=tech: devices.mvm_error_bounds(
                tech, backend="pallas", device=device),
            {"crossbar_matmul_quantized": 18}, totals)
        print(f"[pathB] mvm_error_bounds {tech}: pallas == jnp field for "
              f"field: {kernel == plain}; {kernel}", flush=True)
        require(kernel == plain, f"mvm_error_bounds {tech}: the backends "
                f"differ")
    numerics = CrossbarNumerics()
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE, numerics=numerics)
    params = gnn.init_params(cfg, seed=0, device=device)
    nb, wt = g.neighbor_sample(SAMPLE)
    xs = tuple(torch.from_numpy(a).to(device) for a in (g.features, nb, wt))
    noise = [devices.layer_noise([0, t], params, "reram", numerics)
             for t in range(4)]

    def trials(backend):
        c = dataclasses.replace(cfg, backend=backend)
        return [devices.noisy_forward(params, *xs, c, nz).cpu().numpy()
                for nz in noise]
    ref = trials("jnp")
    for backend, expect in (("fused", {"fused_zmax": None,
                                       "fused_quant_layer": None}),
                            ("pallas", {"csr_aggregate": None})):
        t0 = time.perf_counter()
        outs = counted(f"noisy_forward reram {backend}",
                       lambda backend=backend: trials(backend), expect,
                       totals)
        dt = time.perf_counter() - t0
        for t, (got, r) in enumerate(zip(outs, ref)):
            scale = float(np.abs(r).max()) or 1.0
            diff = np.abs(got - r)
            ok = bool((diff <= 1e-4 * scale + 1e-4 * np.abs(r)).all()
                      and got.shape == (g.n_nodes, OUT))
            print(f"[pathB] noisy_forward reram collab 0.1 {backend:6s} "
                  f"trial {t}: max|err| {float(diff.max()):.3e} vs jnp "
                  f"(tol {1e-4 * scale:.3e}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"noisy_forward {backend} trial {t} disagrees "
                    f"with jnp")
        print(f"[pathB] noisy_forward {backend}: 4 trials in {dt:.2f} s "
              f"(host clock)", flush=True)
    acc = counted(
        "accuracy_bounds reram collab 0.1 fused",
        lambda: devices.accuracy_bounds(
            "reram", dataset="collab", scale=0.1, trials=4,
            backend="fused", hidden=HIDDEN, out_dim=OUT, sample=SAMPLE,
            device=device),
        {"fused_zmax": None, "fused_quant_layer": None}, totals)
    require(np.isfinite([acc.mean_err, acc.p99_err, acc.ci95,
                         acc.flip_rate]).all(), "accuracy_bounds not finite")
    print(f"[pathB] accuracy_bounds reram collab 0.1 (hidden 64, out 16, "
          f"S=8, 4 trials): {acc}", flush=True)


def bucketed_case(label, bplan, cfg, params, backend, ideal, device,
                  totals, ref=None, ref_exact=True, reps: int = 3) -> dict:
    """Refresh ``bplan`` (bucketed) on ``backend`` with both halo
    schedules, as ``GNNServer.refresh`` does (``make_forward`` once, then
    ``scatter`` of the forward's per-bucket outputs, which ends in the copy
    to the host); the overlapped embeddings must equal the serial ones bit
    for bit, and ``ref`` (global node order) exactly where ``ref_exact``,
    else within the serving tolerance. The launch counts are those of the
    first warm refresh; the times are the median of ``reps`` warm
    refreshes a mode, the two modes taking turns. Returns {mode: (warm
    refresh s, embeddings, counts)}."""
    c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
    plan = dataclasses.replace(bplan, backend=backend)
    n = plan.graph.n_nodes
    forwards = {mode: plan.make_forward(c, overlap=mode, device=device)
                for mode in ("overlap", "serial")}
    for forward in forwards.values():
        plan.scatter(forward(params))               # cold
    times = {mode: [] for mode in forwards}
    runs = {}
    for rep in range(reps):
        for mode, forward in forwards.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            emb = plan.scatter(forward(params))
            times[mode].append(time.perf_counter() - t0)
            counts = launch_counts()
            if rep:
                continue
            require(emb.shape == (n, cfg.out_dim)
                    and np.isfinite(emb).all(),
                    f"{label}: embedding shape or non-finite values")
            for k in EXPECTED.get((backend, ideal), ()):
                require(counts[k] > 0, f"{label} {mode}: {k} never "
                        f"launched on its path")
            for k, v in counts.items():
                totals[k] += v
            runs[mode] = [0.0, emb, counts]
    for mode in forwards:
        runs[mode][0] = float(np.median(times[mode]))
    del forwards
    same = np.array_equal(runs["overlap"][1], runs["serial"][1])
    require(same, f"{label}: overlap and serial schedules differ")
    got = runs["overlap"][1]
    text = ""
    if ref is not None:
        scale = float(np.abs(ref).max()) or 1.0
        diff = np.abs(got - ref)
        exact = bool(np.array_equal(got, ref))
        ok = exact if ref_exact else bool(
            (diff <= 1e-4 * scale + 1e-4 * np.abs(ref)).all())
        text = (f"; max|err| {float(diff.max()):.3e} "
                f"({'exact' if ref_exact else f'tol {1e-4 * scale:.3e}'}"
                f", equal bit for bit: {exact}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: the bucketed embeddings differ from the "
                f"reference")
    t_o, t_s = runs["overlap"][0], runs["serial"][0]
    print(f"[pathC] {label}: warm refresh (median of {reps}) overlap "
          f"{t_o * 1e3:.2f} ms, serial {t_s * 1e3:.2f} ms (overlap/serial "
          f"{t_o / t_s:.3f}); "
          f"overlap == serial bit for bit{text}; launches "
          f"{json.dumps({k: v for k, v in runs['overlap'][2].items() if v})}",
          flush=True)
    return runs


def layout_line(tag, plan, cfg, secs) -> dict:
    ls = plan.layout_stats(cfg)
    bp = plan.bucketed
    print(f"[pathC] {tag}: {plan.graph.n_nodes} nodes, {plan.n_clusters} "
          f"clusters in {bp.n_buckets} buckets, n_caps {bp.n_caps}, h_caps "
          f"{bp.h_caps}, s_caps {bp.s_caps}, clusters per bucket "
          f"{[len(cl) for cl in bp.clusters]}; host set-up {secs:.2f} s; "
          f"layout_stats {json.dumps(ls)}", flush=True)
    return ls


def path_c1(g01, device, totals: dict) -> None:
    """The bucketed layout at full width on collab at scale 0.1 (F 496 ->
    64 -> 16, S 8): decentralized on 16 edge-balanced clusters and semi on
    4 heads x 4 spokes, ``buckets="auto"``; every backend, ideal and
    bit-accurate, both halo schedules, against the dense plan on the same
    partition and backend (bit for bit, but the ``torch.matmul`` of the
    ``jnp``/``pallas`` ideal layer: serving tolerance)."""
    cfg = gnn.GNNConfig(in_dim=g01.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    params = gnn.init_params(cfg, seed=0, device=device)
    for setting, kw in (("decentralized", dict(n_clusters=16,
                                               partition_method="edge")),
                        ("semi", dict(n_clusters=4, spokes_per_head=4))):
        t0 = time.perf_counter()
        bplan = plan_execution(g01, setting, sample=SAMPLE, buckets="auto",
                               **kw)
        secs = time.perf_counter() - t0
        dense = plan_execution(g01, setting, sample=SAMPLE, **kw)
        layout_line(f"C1 collab 0.1 {setting}", bplan, cfg, secs)
        for backend in ("jnp", "pallas", "fused"):
            for ideal in (True, False):
                c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                    ideal=ideal))
                srv = GNNServer(dataclasses.replace(dense, backend=backend),
                                c, params=params, device=device)
                srv.refresh()
                t_dense = srv.refresh()
                ref = srv.embeddings
                del srv
                runs = bucketed_case(
                    f"C1 {setting:13s} {backend:6s} "
                    f"{'ideal' if ideal else 'bit-accurate':12s}", bplan,
                    cfg, params, backend, ideal, device, totals, ref=ref,
                    ref_exact=not (ideal and backend != "fused"))
                print(f"[pathC] C1 {setting} {backend} "
                      f"{'ideal' if ideal else 'bit-accurate'}: dense plan "
                      f"warm refresh {t_dense * 1e3:.2f} ms, bucketed "
                      f"{runs['overlap'][0] * 1e3:.2f} ms (overlap)",
                      flush=True)


# the million-node configuration of benchmarks/scale_serve.py's defaults
C2_NODES, C2_EDGES, C2_FEATURES = 1_000_000, 4_000_000, 16
C2_HIDDEN, C2_OUT, C2_CLUSTERS = 16, 8, 64


def path_c2(device, totals: dict) -> None:
    """The million-node configuration of ``benchmarks/scale_serve.py``
    (random_graph(1,000,000, 4,000,000, 16, seed=0), hidden 16, out 8, S 8,
    64 edge-balanced clusters, ``buckets="auto"``): ``fused`` and
    ``pallas``, ideal and bit-accurate, both halo schedules, against the
    bucketed ``jnp`` backend within the serving tolerance. The dense
    layout is priced by ``layout_stats`` only; the bucketed waste must be
    at most half of the dense waste."""
    t0 = time.perf_counter()
    g = random_graph(C2_NODES, C2_EDGES, C2_FEATURES,
                     seed=0).gcn_normalize()
    bplan = plan_execution(g, "decentralized", sample=SAMPLE,
                           n_clusters=C2_CLUSTERS, buckets="auto",
                           partition_method="edge")
    secs = time.perf_counter() - t0
    cfg = gnn.GNNConfig(in_dim=C2_FEATURES, hidden_dims=(C2_HIDDEN,),
                        out_dim=C2_OUT, sample=SAMPLE)
    ls = layout_line("C2 random 1M scale_serve", bplan, cfg, secs)
    waste, dense_waste = ls["padding_ratio"] - 1, ls["dense_padding_ratio"] - 1
    print(f"[pathC] C2 padding gate: bucketed waste {waste:.4f} <= 0.5 x "
          f"dense waste {dense_waste:.4f}: {waste <= 0.5 * dense_waste}",
          flush=True)
    require(waste <= 0.5 * dense_waste, "C2: bucketed padding waste above "
            "half of the dense layout's")
    params = gnn.init_params(cfg, seed=0, device=device)
    for ideal in (True, False):
        ref_runs = bucketed_case(
            f"C2 jnp    {'ideal' if ideal else 'bit-accurate':12s}", bplan,
            cfg, params, "jnp", ideal, device, totals)
        ref = ref_runs["overlap"][1]
        for backend in ("pallas", "fused"):
            bucketed_case(
                f"C2 {backend:6s} {'ideal' if ideal else 'bit-accurate':12s}",
                bplan, cfg, params, backend, ideal, device, totals, ref=ref,
                ref_exact=False)


# the streaming path: D1 at collab 1.0, D2 at collab 0.1
D1_TICKS, D1_CHURN = 6, 0.001
D2_TICKS, D2_CHURN, D2_ADD, D2_REMOVE = 4, 0.01, 16, 4
PATH_D = ("fused_ideal_layer", "csr_aggregate", "cam_search", "fused_zmax",
          "fused_quant_layer")
D_SPANS = ("engine.apply_deltas", "engine.frontier", "engine.dirty_rows")


def own_feats(plan):
    """``plan`` with copies of its feature tables: the streaming engine
    writes the mutated rows into the plan it serves, in place."""
    feats = (tuple(f.copy() for f in plan.feats)
             if isinstance(plan.feats, tuple) else plan.feats.copy())
    return dataclasses.replace(plan, feats=feats)


def churn_rows(rng, g, frac):
    n = max(int(g.n_nodes * frac), 1)
    return (rng.choice(g.n_nodes, n, replace=False),
            rng.normal(size=(n, g.feature_len)).astype(np.float32))


def close(got, ref, rtol: float) -> tuple:
    """(ok, max|err|, tolerance at max|ref|) at atol 1e-4 * max|ref|."""
    scale = float(np.abs(ref).max()) or 1.0
    diff = np.abs(got - ref)
    ok = bool(got.shape == ref.shape and np.isfinite(got).all()
              and (diff <= 1e-4 * scale + rtol * np.abs(ref)).all())
    return ok, float(diff.max()), 1e-4 * scale


def path_d1(plan_c, cfg, params, device, d_totals: dict) -> None:
    """The streaming path at full width: centralized collab 1.0 on
    ``fused``, ideal numerics, policy ``eager``, the ``cam-pallas``
    frontier; a cold refresh and D1_TICKS ticks of feature churn, then the
    checks against a fresh forward of the shared plan, the frontier modes
    against each other, and one bit-accurate commit against a
    ``GNNServer`` refresh."""
    g = plan_c.graph
    nbytes = g.features.nbytes
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        g.features.copy()
        copies.append(time.perf_counter() - t0)
    print(f"[pathD] D1 host copy of the feature table ({nbytes / 1e6:.1f} "
          f"MB, what apply_deltas and the server's live view copy each "
          f"commit): median of 3 {np.median(copies) * 1e3:.1f} ms",
          flush=True)
    plan = own_feats(dataclasses.replace(plan_c, backend="fused"))
    last = {}

    def stream():
        t0 = time.perf_counter()
        srv = StreamingGNNServer(plan, cfg, params=params, policy="eager",
                                 frontier_mode="cam-pallas", device=device)
        t_set = time.perf_counter() - t0
        t_cold = srv.refresh()
        print(f"[pathD] D1 collab 1.0 centralized fused ideal eager "
              f"cam-pallas: server set-up {t_set:.2f} s (host), cold full "
              f"refresh {t_cold * 1e3:.1f} ms", flush=True)
        rng = np.random.default_rng(17)
        tel.enable()
        try:
            for tick in range(D1_TICKS):
                nodes, rows = churn_rows(rng, g, D1_CHURN)
                tel.reset()
                cam0 = launch_counts()["cam_search"]
                upd = srv.ingest(nodes=nodes, rows=rows)
                cams = launch_counts()["cam_search"] - cam0
                spans = tel.snapshot()["spans"]
                require(upd is not None and not upd.full,
                        "D1: an eager tick did not commit incrementally")
                parts = {k: spans[k]["total_s"] for k in D_SPANS}
                commit = spans["server.commit"]["total_s"]
                rest = commit - sum(parts.values())
                last["dirty"] = upd.frontier.masks[0]
                print(f"[pathD] D1 tick {tick}: {len(nodes)} rows, commit "
                      f"{upd.seconds * 1e3:.1f} ms (engine), server.commit "
                      f"{commit * 1e3:.1f} ms = "
                      + ", ".join(f"{k.split('.')[1]} {v * 1e3:.1f}"
                                  for k, v in parts.items())
                      + f", rest (live-view copy, scatter) "
                      f"{rest * 1e3:.1f} ms; recompute fraction "
                      f"{upd.recompute_fraction:.5f}, dirty rows by level "
                      f"{upd.frontier.counts().tolist()}; cam_search calls "
                      f"{cams}", flush=True)
        finally:
            tel.disable()
            tel.reset()
        return srv

    srv = counted("D1 streaming ticks", stream,
                  {"fused_ideal_layer": None, "cam_search": None}, d_totals)
    served = srv.embeddings
    require(served.shape == (g.n_nodes, cfg.out_dim)
            and np.isfinite(served).all(), "D1: embeddings")
    require(plan.graph is srv.engine.graph, "D1: the plan does not track "
            "the live graph")
    for backend in ("fused", "jnp"):
        fresh = dataclasses.replace(plan, backend=backend)
        ref = fresh.scatter(fresh.make_forward(cfg, device=device)(params))
        ok, err, tol = close(served, ref, 1e-4)
        print(f"[pathD] D1 served after {D1_TICKS} ticks vs a fresh "
              f"make_forward of the shared plan on {backend}: max|err| "
              f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}; equal "
              f"bit for bit: {np.array_equal(served, ref)}", flush=True)
        require(ok, f"D1: incremental embeddings differ from {backend}")
    fd = last["dirty"]
    nbr, wts = srv.engine._gnbr, srv.engine._gwts
    fronts = {}
    for mode in ("numpy", "cam", "cam-pallas"):
        t0 = time.perf_counter()
        fronts[mode] = expand_frontier(nbr, wts, fd, np.zeros_like(fd), 2,
                                       mode=mode, device=device).masks
        print(f"[pathD] D1 frontier of tick {D1_TICKS - 1} on {mode}: "
              f"{time.perf_counter() - t0:.3f} s (host clock), counts "
              f"{fronts[mode].sum(axis=1).tolist()}", flush=True)
    same = all(np.array_equal(m, fronts["numpy"]) for m in fronts.values())
    print(f"[pathD] D1 frontier masks of numpy, cam and cam-pallas equal "
          f"bit for bit: {same}", flush=True)
    require(same, "D1: the frontier modes differ")
    del srv

    c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=False))

    def bit_accurate():
        srv = StreamingGNNServer(plan, c, params=params, policy="eager",
                                 frontier_mode="cam-pallas", device=device)
        srv.refresh()
        nodes, rows = churn_rows(np.random.default_rng(18), g, D1_CHURN)
        return srv, srv.ingest(nodes=nodes, rows=rows)
    srv, upd = counted("D1 bit-accurate commit", bit_accurate,
                       {"fused_zmax": None, "fused_quant_layer": None,
                        "cam_search": None}, d_totals)
    ref_srv = GNNServer(plan, c, params=params, device=device)
    ref_srv.refresh()
    exact = np.array_equal(srv.embeddings, ref_srv.embeddings)
    print(f"[pathD] D1 bit-accurate commit: full={upd.full}, "
          f"{upd.seconds * 1e3:.1f} ms; equal bit for bit to a GNNServer "
          f"refresh of the same plan: {exact}", flush=True)
    require(upd.full, "D1: a bit-accurate commit did not fall back to a "
            "full refresh")
    require(exact, "D1: the bit-accurate commit differs from GNNServer")


def d2_tick(srv, rng):
    """One D2 tick: feature churn at D2_CHURN, D2_ADD random edges added
    and D2_REMOVE edges of the live graph removed."""
    live = srv.engine.graph
    nodes, rows = churn_rows(rng, live, D2_CHURN)
    gone = rng.choice(live.n_edges, D2_REMOVE, replace=False)
    dst = np.searchsorted(live.indptr, gone, side="right") - 1
    return srv.ingest(nodes=nodes, rows=rows,
                      add_edges=(rng.integers(0, live.n_nodes, D2_ADD),
                                 rng.integers(0, live.n_nodes, D2_ADD)),
                      remove_edges=(dst, live.indices[gone]))


def path_d2(plans: dict, g01, cfg, params, device, d_totals: dict) -> None:
    """The exchange settings at collab 0.1 through ``StreamingGNNServer``
    on ``fused`` and ``pallas``, ideal numerics, policy ``interval``
    (every 2 ticks), D2_TICKS ticks of feature churn plus D2_ADD added and
    D2_REMOVE removed edges (so the plan's structure is rebuilt): the
    final embeddings against a centralized ``jnp`` forward of the mutated
    graph, the summed incremental traffic against the full exchange's
    bytes times the commits."""
    for (label, mode), base in plans.items():
        for backend in ("fused", "pallas"):
            plan = own_feats(dataclasses.replace(base, backend=backend))
            tag = f"D2 {label} {mode} {backend}"
            split = []

            def stream():
                srv = StreamingGNNServer(plan, cfg, params=params, mode=mode,
                                         policy="interval", interval=2,
                                         device=device)
                srv.refresh()
                rng = np.random.default_rng(23)
                tel.reset()
                tel.enable()
                try:
                    ups = [d2_tick(srv, rng) for _ in range(D2_TICKS)]
                    split[:] = [tel.snapshot()["spans"][k]["total_s"]
                                for k in ("server.commit", *D_SPANS)]
                finally:
                    tel.disable()
                    tel.reset()
                return srv, [u for u in ups if u is not None]
            t0 = time.perf_counter()
            srv, ups = counted(tag, stream, {
                "fused_ideal_layer" if backend == "fused"
                else "csr_aggregate": None}, d_totals)
            secs = time.perf_counter() - t0
            require(len(ups) == D2_TICKS // 2 and not any(u.full
                                                          for u in ups),
                    f"{tag}: not one incremental commit every 2 ticks")
            g = srv.engine.graph
            cent = plan_execution(g, "centralized", backend="jnp",
                                  sample=SAMPLE)
            ref = cent.scatter(cent.make_forward(cfg, device=device)(params))
            ok, err, tol = close(srv.embeddings, ref, 0.0)
            inc = sum(u.traffic.total_bytes() for u in ups)
            full = plan.measured_traffic(srv.cfg, mode=mode).total_bytes()
            print(f"[pathD] {tag}: {len(ups)} commits in {secs:.2f} s (host, "
                  f"set-up included), commit "
                  + "/".join(f"{u.seconds * 1e3:.1f}" for u in ups)
                  + " ms (engine; server.commit "
                  + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in zip(
                      ("total", "apply_deltas with the structure rebuild",
                       "frontier", "dirty_rows"), split))
                  + " ms over both), recompute fraction "
                  + "/".join(f"{u.recompute_fraction:.4f}" for u in ups)
                  + f"; vs centralized jnp of the mutated graph ({g.n_edges} "
                  f"edges) max|err| {err:.3e} (tol {tol:.3e}) "
                  f"{'ok' if ok else 'FAIL'}; incremental traffic {inc:,} B "
                  f"<= full {full:,} B x {len(ups)} commits: "
                  f"{inc <= full * len(ups)}", flush=True)
            require(ok, f"{tag}: embeddings differ from the centralized "
                    f"forward")
            require(inc <= full * len(ups), f"{tag}: incremental traffic "
                    f"above the full exchange's")


def refresh_window(trace_path: str, span) -> tuple | None:
    """(window us, kernel us, copy us) of the ``server.refresh`` span in a
    ``torch.profiler`` chrome trace: the span's times on the trace's clock
    (``Span.wall_ns`` less the trace's ``baseTimeNanoseconds``), and the
    device time of the kernels and memory copies that start inside it,
    clipped to it; None where the trace holds no kernel."""
    with open(trace_path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    base = trace["baseTimeNanoseconds"]
    lo = (span.wall_ns(span.t_start) - base) / 1e3
    hi = (span.wall_ns(span.t_end) - base) / 1e3
    busy = {"kernel": 0.0, "gpu_memcpy": 0.0}
    for e in events:
        cat = e.get("cat")
        if cat in busy and lo <= float(e["ts"]) <= hi:
            busy[cat] += min(float(e["ts"]) + float(e["dur"]), hi) \
                - float(e["ts"])
    if not busy["kernel"]:
        return None
    return hi - lo, busy["kernel"], busy["gpu_memcpy"]


def trace_refresh(plan_c, cfg, params, device) -> None:
    """One warm ``GNNServer`` refresh of centralized collab 1.0 on
    ``fused``, ideal and bit-accurate, with the port's telemetry on: the
    span split (``server.refresh``; ``plan.forward`` closed by its device
    sync; the rest, ``scatter`` and its copy to the host), then the same
    refresh under ``torch.profiler``, the span put on the trace's clock:
    the device-busy share of the ``server.refresh`` window (kernel time
    over the window's length)."""
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for ideal in (True, False):
        name = "ideal" if ideal else "bit-accurate"
        c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
        srv = GNNServer(dataclasses.replace(plan_c, backend="fused"), c,
                        params=params, device=device)
        srv.refresh()
        t_off = srv.refresh()
        tel.reset()
        tel.enable()
        try:
            t = srv.refresh()
            spans = tel.snapshot()["spans"]
        finally:
            tel.disable()
        r = spans["server.refresh"]["total_s"]
        f = spans["plan.forward"]["total_s"]
        sync = spans["plan.forward.sync"]["total_s"]
        print(f"[trace] centralized collab 1.0 fused {name} warm refresh "
              f"{t * 1e3:.3f} ms (telemetry off just before: "
              f"{t_off * 1e3:.3f} ms): server.refresh {r * 1e3:.3f} ms = "
              f"plan.forward {f * 1e3:.3f} ms (launches {(f - sync) * 1e3:.3f}"
              f" ms on the host, then its device sync {sync * 1e3:.3f} ms) "
              f"+ scatter and copy to the host {(r - f) * 1e3:.3f} ms",
              flush=True)
        path = os.path.join(out_dir, f"refresh_trace_{name}.json")
        window = None
        for attempt in range(3):
            tel.reset()
            tel.enable()
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    srv.refresh()
            finally:
                tel.disable()
            prof.export_chrome_trace(path)
            refresh = [r for r in tel.get_tracer().roots
                       if r.name == "server.refresh"]
            window = refresh_window(path, refresh[-1])
            if window is not None:
                break
        if window is None:
            print(f"[trace] {name}: device-busy share not measured (the "
                  f"profiler's trace held no kernel in the window, 3 tries)",
                  flush=True)
            continue
        span, kern, copy = window
        print(f"[trace] {name} under torch.profiler: server.refresh window "
              f"{span / 1e3:.3f} ms, kernels {kern / 1e3:.3f} ms "
              f"(device-busy share {kern / span:.3f}), device-to-host copy "
              f"{copy / 1e3:.3f} ms ({copy / span:.3f}); trace "
              f"chiprun_out/{os.path.basename(path)}", flush=True)
        del srv
    tel.reset()


# ------------------------------------------------------------------ path E


def event_ms(fn) -> float:
    """The tuner's protocol: min CUDA-event ms of 3 calls after one."""
    return 1e3 * time_callable(fn, iters=3, warmup=1)


def candidate_sweep(label: str, geom, run, card: str) -> int:
    """E1: every candidate of ``geom``, run by ``run(config)``, equal to
    the default launch (candidate #0) with ``torch.equal``; prints each
    candidate's CUDA-event ms."""
    cands = candidates(geom)
    ref = run(cands[0])
    ref = ref if isinstance(ref, tuple) else (ref,)
    times = []
    for c in cands:
        out = run(c)
        out = out if isinstance(out, tuple) else (out,)
        require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                f"E1 {label}: candidate {c} differs from the default launch")
        times.append(f"{tuple(c.as_dict().values())} "
                     f"{event_ms(lambda: run(c)):.4f}")
    print(f"[pathE] E1 {label}: {len(cands)} candidates equal to the "
          f"default launch bit for bit; ms (candidate #0 first): "
          f"{'; '.join(times)} ({card})", flush=True)
    return len(cands)


def layer_sweeps(tag, x, nbr, wts, w, b, card, numerics=None,
                 noise=None) -> int:
    """E1 at one layer's shape: the ideal layer, the quant layer (its launch
    alone, on the numerics' programmed codes), the aggregation and the
    crossbar (on the DAC codes of Z); ``numerics`` set: only the two
    bit-accurate kernels."""
    nd, s = nbr.shape
    n, f = x.shape
    h = w.shape[1]
    swept = 0
    if numerics is None:
        swept += candidate_sweep(
            f"{tag} fused_ideal_layer", FusedGeometry(nd, n, f, h, s, True),
            lambda c: fl.fused_ideal_layer(x, nbr, wts, w, b, relu=True,
                                           config=c), card)
        swept += candidate_sweep(
            f"{tag} csr_aggregate", AggregateGeometry(nd, n, f, s),
            lambda c: csr_aggregate(x, nbr, wts, config=c), card)
    cfg = CrossbarNumerics(**(numerics or {}))
    zmax = fl.fused_zmax(x, nbr, wts)
    codes, scales = fl.quant_operands(zmax, w, cfg, noise)
    swept += candidate_sweep(
        f"{tag} fused_quant_layer",
        FusedGeometry(nd, n, f, h, s, False, cfg.rows_per_xbar),
        lambda c: fl.fused_quant_layer(x, nbr, wts, codes, b, scales, cfg,
                                       relu=True, config=c), card)
    xq, _ = xb.quantize_inputs(torch.clamp_min(
        csr_aggregate_ref(x, nbr, wts), 0.0), cfg)
    swept += candidate_sweep(
        f"{tag} crossbar_matmul_quantized",
        CrossbarGeometry(nd, f, h, cfg.rows_per_xbar, cfg.in_bits),
        lambda c: xb.crossbar_matmul_programmed(xq, codes, cfg, config=c),
        card)
    return swept


def path_e1(x1, x2, nbr, wts, params, plan_b, device, card) -> None:
    """E1: every tuning candidate of every kernel equals the default launch
    at collab 1.0's layers 1 and 2, at C1's largest bucket, at the repaired
    deep shapes (F 3,703 at 48 and 64 rows, 8- and 16-bit DAC codes, clean
    and ReRAM-noisy; 13-bit conductance codes) and at the CAM's k-NN and
    frontier launches."""
    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(device)
    for name, want in (("shared_memory_per_block_optin", H100.smem_bytes),
                       ("shared_memory_per_multiprocessor",
                        H100.sm_smem_bytes)):
        got = getattr(props, name, None)
        require(got in (None, want), f"E1: the card's {name} is {got}, "
                f"the launch plans assume {want}")
        print(f"[pathE] E1 the launch plans' {name} {want}, the card's "
              f"{'not reported' if got is None else got}", flush=True)
    gen = torch.Generator(device=device).manual_seed(17)
    swept = 0
    for tag, x, layer in (("layer1 496->64", x1, params[0]),
                          ("layer2 64->16", x2, params[1])):
        swept += layer_sweeps(tag, x, nbr, wts, layer["w"], layer["b"], card)
    bp = plan_b.bucketed
    big = max(range(bp.n_buckets), key=lambda i: bp.n_caps[i])
    nd, n, s = bp.n_caps[big], bp.n_caps[big] + bp.h_caps[big], \
        bp.s_caps[big]
    for f, layer in ((x1.shape[1], params[0]), (x2.shape[1], params[1])):
        xb_ = torch.randn((n, f), generator=gen, device=device)
        nb = torch.randint(0, n, (nd, s), generator=gen, device=device,
                           dtype=torch.int32)
        wb = torch.rand((nd, s), generator=gen, device=device)
        wb[:, s // 2:] = 0.0                   # padding slots
        swept += layer_sweeps(f"C1 bucket {nd}x{s} of {n} rows F={f}", xb_,
                              nb, wb, layer["w"], layer["b"], card)
    deep = deep_inputs(device, 11)
    nbr_w = torch.remainder(nbr[:3000], 4000)
    wts_w = wts[:3000].contiguous()
    x, w, b = deep[3703]
    for numerics in (dict(rows_per_xbar=48), dict(rows_per_xbar=64),
                     dict(in_bits=16, rows_per_xbar=48),
                     dict(in_bits=16, rows_per_xbar=64),
                     dict(in_bits=16, w_bits=13, rows_per_xbar=64)):
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            swept += layer_sweeps(
                f"3000 rows 3703->64 {numerics_tag(numerics)} "
                f"noisy={noisy}", x, nbr_w, wts_w, w, b, card,
                numerics=numerics, noise=nz)
    entries, queries = cam_inputs(device)
    swept += candidate_sweep(
        f"cam_search k-NN Q={queries.shape[0]} E={entries.shape[0]}",
        CamGeometry(entries.shape[0], queries.shape[0]),
        lambda c: cam_search(entries, queries, config=c), card)
    ci = torch.randint(0, 400, (525,), generator=gen, device=device,
                       dtype=torch.int32)
    qs = torch.randint(-1, 400, (45_100,), generator=gen, device=device,
                       dtype=torch.int32)
    swept += candidate_sweep("cam_search frontier Q=45100 E=525",
                             CamGeometry(525, 45_100),
                             lambda c: cam_search(ci, qs, config=c), card)
    print(f"[pathE] E1: {swept} candidate launches, all equal to their "
          f"default launch; {time.perf_counter() - t0:.1f} s", flush=True)


def _refuse_measure(geom, config):
    raise RuntimeError(f"E2: a cached geometry was measured again: {geom}")


def confirm_winner(label, geom, winner, tables, device, card) -> None:
    """E2: a winner that took the default's place, timed again beside the
    default on the same tables in turns (default, winner, winner,
    default), is no slower than the default within this run's spread: its
    fastest timing is at most the default's slowest."""
    default = default_config(geom)
    fn = measurer(seed=1, iters=3, warmup=1, device=device, tables=tables)
    t = {default: [], winner: []}
    for c in (default, winner, winner, default):
        t[c].append(1e3 * fn(geom, c))
    require(min(t[winner]) <= max(t[default]),
            f"E2 {label}: winner {winner} slower than the default "
            f"({t[winner]} against {t[default]} ms)")
    print(f"[pathE] E2 {label} {geom.key()[1:]}: retimed in turns, default "
          f"{' / '.join(f'{v:.4f}' for v in t[default])} ms, winner "
          f"{' / '.join(f'{v:.4f}' for v in t[winner])} ms ({card})",
          flush=True)


def path_e2(plan_c, plan_b, cfg, params, device, card) -> None:
    """E2: ``tune_kernels`` on the card for centralized collab 1.0 on
    ``fused`` (ideal and bit-accurate) and ``pallas``, and C1's bucketed
    plan on ``fused``, into one ``TuneCache`` in a temporary file, each
    geometry timed on the plan's own tables; each winner that took the
    default's place retimed beside it in turns and no slower within the
    run's spread; a second ``tune_kernels`` answered from the cache with no
    measurement and no launch; a ``GNNServer`` refresh with the tuned plan
    equal to the untuned refresh bit for bit."""
    t0 = time.perf_counter()
    platform = tuning.current_platform(device)
    quant = dataclasses.replace(cfg, numerics=CrossbarNumerics())
    cases = (("centralized collab 1.0 fused ideal", plan_c, "fused", cfg),
             ("centralized collab 1.0 fused bit-accurate", plan_c, "fused",
              quant),
             ("centralized collab 1.0 pallas ideal", plan_c, "pallas", cfg),
             ("C1 bucketed 16 fused ideal", plan_b, "fused", cfg))
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuneCache(os.path.join(tmp, "tuned_configs_torch.json"))
        for label, base, backend, c in cases:
            plan = dataclasses.replace(base, backend=backend, tuned=None,
                                       mapping=None)
            registry.clear()
            untuned = GNNServer(plan, c, params=params, device=device)
            untuned.refresh()
            t1 = time.perf_counter()
            tuned = plan.tune_kernels(c, cache=cache, device=device,
                                      iters=3, warmup=1)
            t_tune = time.perf_counter() - t1
            geoms = plan_geometries(plan, plan.gnn_config(c))
            require(len(tuned) == len({g.key() for g in geoms}) > 0,
                    f"E2 {label}: {len(tuned)} tuned geometries")
            tables = plan_tables(plan)
            for geom in dict.fromkeys(geoms):
                rec = cache.entries["|".join(
                    str(v) for v in (*geom.key(), platform))]
                winner = tuned.lookup(geom.key())
                print(f"[pathE] E2 {label} {geom.kernel} {geom.key()[1:]}: "
                      f"default {rec['default_s'] * 1e3:.4f} ms, fastest "
                      f"of {rec['n_measured']} "
                      f"{tuple(rec['fastest'].values())} lead "
                      f"{rec['lead_s'] * 1e3:.4f} ms, spread "
                      f"{rec['spread_s'] * 1e3:.4f} ms: winner "
                      f"{tuple(rec['config'].values())} "
                      f"{rec['measured_s'] * 1e3:.4f} ms ({card})",
                      flush=True)
                if winner != default_config(geom):
                    confirm_winner(label, geom, winner,
                                   tables[(geom.nd, geom.n, geom.sample)],
                                   device, card)
            before = launch_counts()
            again = plan.tune_kernels(c, cache=cache, device=device,
                                      measure_fn=_refuse_measure)
            require(again == tuned and launch_counts() == before,
                    f"E2 {label}: the rerun did not answer from the cache")
            served = GNNServer(plan, c, params=params, device=device)
            served.refresh()
            require(np.array_equal(served.embeddings, untuned.embeddings),
                    f"E2 {label}: the tuned refresh differs from the "
                    f"untuned one")
            print(f"[pathE] E2 {label}: {len(tuned)} geometries tuned in "
                  f"{t_tune:.1f} s on the plan's tables; rerun from the "
                  f"cache, no measurement; tuned refresh equal to the "
                  f"untuned one bit for bit", flush=True)
        print(f"[pathE] E2: cache of {len(cache)} entries; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    registry.clear()


def path_e3(plan_c, cfg, device, card) -> None:
    """E3: ``devices.calibrate`` on the card into a temporary file, loaded
    back strictly, and the derived cost model and the mapper on it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "host_calibration_torch.json")
        cal = devices.calibrate(path, device=device)
        require(cal.platform == "cuda:" + torch.cuda.get_device_name(0)
                and "H100" in cal.platform,
                f"E3: calibration platform {cal.platform!r}")
        require(devices.load_calibration(path, device=device) == cal,
                "E3: the calibration did not load back")
    m = plan_c.predicted_metrics(mode="derived", calibration=cal)
    mapping = plan_c.compile_mapping(cfg, calibration=cal)
    require(all(np.isfinite(v) and v > 0 for v in (
        m.t_compute, m.t_communicate, mapping.t_compute, mapping.energy_j)),
        "E3: derived prediction not finite")
    print(f"[pathE] E3 calibration {cal.platform}: t_cam "
          f"{cal.t_cam * 1e3:.4f} ms, t_agg {cal.t_agg * 1e3:.4f} ms, t_fx "
          f"{cal.t_fx * 1e3:.4f} ms ({card}); derived on it: T_compute "
          f"{m.t_compute:.3e} s (modeled device), mapper "
          f"{mapping.t_compute:.3e} s", flush=True)


def path_e4(device) -> None:
    """E4: the CLI with --tune --mapping --tech reram on centralized collab
    0.1; its cost-model and mapper lines equal what the same plan prints in
    this process."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--setting", "centralized", "--dataset", "collab",
                "--scale", "0.1", "--tune", "--tune-cache",
                os.path.join(tmp, "tuned.json"), "--mapping", "--tech",
                "reram"]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.gnn",
                              *argv], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=600)
        require(out.returncode == 0, f"E4: the CLI failed:\n{out.stderr}")
    lines = out.stdout.splitlines()
    g = dataset_like("collab", scale=0.1, seed=0).gcn_normalize()
    plan = plan_execution(g, "centralized", backend="fused", sample=SAMPLE)
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    args = argparse.Namespace(setting="centralized", tech="reram",
                              mapping=True, dataset="collab")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.print_cost_model(args, g, plan, cfg, "reram")
    want = buf.getvalue().splitlines()
    require(lines[-len(want):] == want,
            "E4: the CLI's cost-model lines differ from the in-process ones")
    tuned_line = [ln for ln in lines if ln.startswith("tuned ")]
    require(len(tuned_line) == 1, "E4: no tuning line")
    print(f"[pathE] E4 CLI --tune --mapping --tech reram: exit 0, "
          f"{tuned_line[0]}; {want[0]}; {want[1]}; guideline line equal; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------------ path F

# the load loops of benchmarks/load_serve.py --auto: 64 requests of 16
# lookups a loop, a churn tick of 1 % of the rows every 4 requests; the
# planner's mixed workload prices the same 64 lookups a tick
F_REQUESTS, F_BATCH, F_TICK_EVERY, F_CHURN = 64, 16, 4, 0.01
F_MIXED = dict(churn=F_CHURN, queries_per_tick=F_BATCH * F_TICK_EVERY)
# F3: the drift set-up of tests/test_planner.py at collab 0.1
F3_QUIET, F3_SPIKE, F3_MAX_SPIKES = 4, 0.9, 8
PATH_F = ("fused_ideal_layer", "cam_search")
# the kernel each backend the planner can pick launches (the default
# candidate space offers ``fused`` only; ``jnp`` launches none)
BACKEND_KERNEL = {"fused": "fused_ideal_layer", "pallas": "csr_aggregate"}


def path_f1(g) -> None:
    """F1: ``plan`` model-only on the paper's statistics under the three
    objectives and a static and a mixed workload, each recommendation the
    exhaustive argmin of ``score_candidate``; then the CLI's measured
    phase on the concrete collab 1.0 graph."""
    t0 = time.perf_counter()
    n_plans = 0
    for name, st in {"taxi": TAXI_STATS, **TABLE2_DATASETS}.items():
        for wl_name, wl in (("static", WorkloadProfile()),
                            ("mixed", WorkloadProfile(**F_MIXED))):
            recs = []
            for objective in OBJECTIVES:
                r = plan(st, objective, wl, shortlist=0)
                ctx = PlanContext(st, wl)
                best = min((score_candidate(c, ctx, objective)
                            for c in candidate_space(st, workload=wl)),
                           key=lambda s: s.sort_key)
                require(best.candidate == r.recommended.candidate
                        and best.score == r.recommended.score,
                        f"F1 {name} {wl_name} {objective}: the "
                        f"recommendation is not the exhaustive argmin")
                recs.append(f"{objective} {r.recommended.candidate.key}")
                n_plans += 1
                if (name, wl_name, objective) == ("taxi", "mixed",
                                                  "throughput"):
                    require(r.recommended.candidate.setting == "semi",
                            "F1: the taxi mixed workload does not "
                            "recommend semi")
            print(f"[pathF] F1 {name} {wl_name}: {len(r.scored)} "
                  f"candidates; " + "; ".join(recs), flush=True)
    print(f"[pathF] F1 {n_plans} model-only plans, each the exhaustive "
          f"argmin of score_candidate: {time.perf_counter() - t0:.2f} s "
          f"(host)", flush=True)
    wl = WorkloadProfile(**F_MIXED, sample=SAMPLE)
    t0 = time.perf_counter()
    model = plan(g, "throughput", wl, shortlist=0)
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    measured = plan(g, "throughput", wl, shortlist=2)
    t_measured = time.perf_counter() - t0
    rec = measured.recommended
    require([s.candidate.key for s in model.scored]
            == [s.candidate.key for s in measured.scored]
            and "bytes_full_refresh" in rec.metrics,
            "F1: the measured phase did not run or changed the ranking")
    m = rec.metrics
    print(f"[pathF] F1 collab 1.0 ({g.n_nodes} nodes), throughput, churn "
          f"{F_CHURN}, {wl.queries_per_tick:.0f} lookups a tick: "
          f"recommended {rec.candidate.key}, {len(measured.frontier)} of "
          f"{len(measured.scored)} on the frontier; model phase "
          f"{t_model:.2f} s, with the measured phase over a shortlist of 2 "
          f"{t_measured:.2f} s (host); measured bytes a full refresh "
          f"{m['bytes_full_refresh']:,.0f}, a tick "
          f"{m.get('bytes_per_tick', 0.0):,.0f}, padding ratio "
          f"{m['padding_ratio']:.3f}, peak device bytes (layout) "
          f"{m['peak_device_bytes']:,.0f}", flush=True)


def f_tick(srv, rng, frac: float = F_CHURN):
    nodes, rows = churn_rows(rng, srv.engine.graph, frac)
    return srv.ingest(nodes=nodes, rows=rows)


def closed_loop(srv, rng, monitor=None) -> dict:
    """One client, batches back to back: latency is service time."""
    lats, served = [], 0
    t0 = time.perf_counter()
    for i in range(F_REQUESTS):
        if i % F_TICK_EVERY == 0:
            f_tick(srv, rng)
        ids = rng.integers(0, srv.engine.graph.n_nodes, F_BATCH)
        t = time.perf_counter()
        served += len(srv.query(ids))
        lats.append(time.perf_counter() - t)
        if monitor is not None:
            monitor.note_queries(F_BATCH)
    wall = time.perf_counter() - t0
    return dict(lats=lats, served=served, wall=wall, qps=served / wall)


def open_loop(srv, rng, rate: float, monitor=None) -> dict:
    """Poisson arrivals at ``rate`` batches a second on a virtual clock:
    a request starts when it arrives or when the server is free, and its
    latency includes the wait (commits block the serving thread)."""
    arrivals = np.cumsum(rng.exponential(1.0 / rate, F_REQUESTS))
    free, lats, served = 0.0, [], 0
    for i, arr in enumerate(arrivals):
        if i % F_TICK_EVERY == 0:
            t = time.perf_counter()
            f_tick(srv, rng)
            free = max(free, arr) + (time.perf_counter() - t)
        ids = rng.integers(0, srv.engine.graph.n_nodes, F_BATCH)
        start = max(arr, free)
        t = time.perf_counter()
        served += len(srv.query(ids))
        free = start + (time.perf_counter() - t)
        lats.append(free - arr)
        if monitor is not None:
            monitor.note_queries(F_BATCH)
    return dict(lats=lats, served=served)


def percentiles(lats) -> tuple:
    return tuple(float(v) for v in np.percentile(
        np.asarray(lats, np.float64) * 1e3, [50, 95, 99]))


def fresh_jnp(srv, cfg, params, device) -> np.ndarray:
    """A centralized ``jnp`` forward of the server's live graph."""
    cent = plan_execution(srv.engine.graph, "centralized", backend="jnp",
                          sample=SAMPLE)
    return cent.scatter(cent.make_forward(cfg, device=device)(params))


def f2_config(label, plan_, policy, cfg, params, device, f_totals,
              result=None) -> None:
    """One configuration under the closed and then the open loop on the
    ``cam-pallas`` frontier; with ``result``, a ``ReplanMonitor`` of it
    attached."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box = {}

    def serve():
        srv = StreamingGNNServer(plan_, cfg, params=params, policy=policy,
                                 frontier_mode="cam-pallas", device=device)
        mon = (ReplanMonitor(result).attach(srv) if result is not None
               else None)
        box["cold"] = srv.refresh()
        rng = np.random.default_rng(29)
        box["closed"] = closed_loop(srv, rng, mon)
        box["rate"] = 0.8 * F_REQUESTS / box["closed"]["wall"]
        box["open"] = open_loop(srv, rng, box["rate"], mon)
        box["loop_commits"] = srv.commits - 1
        srv.flush()
        return srv, mon
    srv, mon = counted(f"F2 {label}", serve, {k: None for k in PATH_F},
                       f_totals)
    peak = torch.cuda.max_memory_allocated()
    closed, opened = box["closed"], box["open"]
    cp, op = percentiles(closed["lats"]), percentiles(opened["lats"])
    ref = fresh_jnp(srv, cfg, params, device)
    ok, err, tol = close(srv.embeddings, ref, 0.0)
    ls = srv.plan.layout_stats()
    served = closed["served"] + opened["served"]
    print(f"[pathF] F2 {label}: cold refresh {box['cold'] * 1e3:.1f} ms; "
          f"closed {closed['qps']:.0f} lookups/s, p50/p95/p99 "
          + "/".join(f"{v:.3f}" for v in cp) + " ms; open at "
          f"{box['rate']:.1f} requests/s p50/p95/p99 "
          + "/".join(f"{v:.3f}" for v in op) + f" ms; {served} lookups, "
          f"{srv.commits} commits ({box['loop_commits']} in the loops, "
          f"{srv.full_refreshes} full), "
          f"{len(mon.events) if mon is not None else 0} re-plans; padding "
          f"ratio {ls['padding_ratio']:.3f}, peak device bytes "
          f"{ls['peak_device_bytes']:,} (layout), "
          f"{peak / 1e6:.1f} MB allocated at most on the card; vs jnp of "
          f"the mutated graph max|err| {err:.3e} (tol {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(served == 2 * F_REQUESTS * F_BATCH,
            f"F2 {label}: {served} lookups served")
    require(cp[0] <= cp[1] <= cp[2] and op[0] <= op[1] <= op[2],
            f"F2 {label}: percentiles not monotone")
    require(box["loop_commits"] >= 1, f"F2 {label}: no commit in the loops")
    require(ok, f"F2 {label}: embeddings differ from the fresh forward")


def path_f2(g01, plan_d, plan_s, cfg, params, device, f_totals) -> None:
    """F2: the load loops on ``fused`` for centralized, decentralized 8
    and semi 4 x 4 at collab 0.1, then the planner's recommendation with
    a ``ReplanMonitor`` attached."""
    for label, base in (
            ("centralized", plan_execution(g01, "centralized",
                                           sample=SAMPLE)),
            ("decentralized 8", plan_d), ("semi 4x4", plan_s)):
        f2_config(f"{label} fused eager",
                  own_feats(dataclasses.replace(base, backend="fused")),
                  "eager", cfg, params, device, f_totals)
    t0 = time.perf_counter()
    result = plan(g01, "throughput", WorkloadProfile(**F_MIXED,
                                                     sample=SAMPLE),
                  shortlist=2)
    rec = result.recommended.candidate
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_auto = own_feats(result.build_plan(g01))
    print(f"[pathF] F2 planner at collab 0.1: {rec.key} (plan {t_plan:.2f} "
          f"s, build {time.perf_counter() - t0:.2f} s, host)", flush=True)
    f2_config(f"planner {rec.key}", plan_auto, rec.policy, cfg, params,
              device, f_totals, result=result)


def param_tensors(srv) -> list:
    return [t for layer in srv.params for t in layer.values()]


def check_swap(tag, srv, mon, params, tensors, cfg, device, f_totals,
               backend_kernel: str) -> None:
    """After a swap: the server's and the new engine's parameters are the
    same tensors on the card; the first commit is a full refresh the
    ledger skips; the new backend's kernel launches; lookups equal a
    fresh ``jnp`` forward of the live graph."""
    require(srv.params is params and srv.engine.params is params
            and param_tensors(srv) == tensors
            and all(t.device.type == device.type for t in tensors),
            f"{tag}: the swap did not keep the parameter tensors")
    skipped = mon.ledger.full_skipped

    def after():
        rng = np.random.default_rng(37)
        for _ in range(2):
            f_tick(srv, rng)
        return srv.flush()
    first = counted(f"{tag} after the swap", after, {backend_kernel: None},
                    f_totals)
    require(first is not None and first.full
            and mon.ledger.full_skipped == skipped + 1,
            f"{tag}: the first commit after the swap is not a skipped full "
            f"refresh")
    ids = np.arange(srv.engine.graph.n_nodes)
    ok, err, tol = close(srv.query(ids), fresh_jnp(srv, cfg, params,
                                                   device), 0.0)
    print(f"[pathF] {tag}: serving {srv.plan.setting}/{srv.plan.backend} "
          f"on {srv.plan.n_clusters} clusters"
          + (f", bucketed ({srv.plan.bucketed.n_buckets} buckets)"
             if srv.plan.bucketed is not None else "")
          + f", policy {srv.policy}; parameters the same tensors on the "
          f"card; first commit after the swap full, {first.seconds * 1e3:.1f}"
          f" ms, skipped by the ledger; lookups vs jnp of the live graph "
          f"max|err| {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"{tag}: swapped embeddings differ from the fresh forward")


def timed_swaps(srv) -> list:
    """Record the host seconds of each ``srv.update_plan`` call."""
    secs, update = [], srv.update_plan

    def timed(plan_, cfg_=None):
        t0 = time.perf_counter()
        update(plan_, cfg_)
        secs.append(time.perf_counter() - t0)
    srv.update_plan = timed
    return secs


def path_f3(g01, cfg, params, device, f_totals) -> None:
    """F3: a pinned decentralized ``pallas`` plan under ``eager``, a
    ``ReplanMonitor(window=2, tol=2.0, cooldown=1, shortlist=0)``, quiet
    ticks then churn spikes until drift re-plans and swaps the plan on the
    card; then F3b, a drift fed through ``observe`` with samples of the
    mixed workload, which swaps a pinned centralized server to the
    planner's bucketed recommendation."""
    wl = WorkloadProfile(churn=F_CHURN, queries_per_tick=0, sample=SAMPLE)
    pinned = plan(g01.stats("collab 0.1"), "throughput", workload=wl,
                  space=[Candidate("decentralized", "pallas", 8)])
    srv = StreamingGNNServer(pinned.build_plan(g01), cfg, params=params,
                             policy="eager", device=device)
    tensors = param_tensors(srv)
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    swaps, observed = timed_swaps(srv), []

    def observer(server, update):
        t0 = time.perf_counter()
        mon(server, update)
        observed.append(time.perf_counter() - t0)
    srv.add_observer(observer)
    rng = np.random.default_rng(31)

    def drive():
        srv.refresh()
        for _ in range(F3_QUIET):
            f_tick(srv, rng)
        require(not mon.events, "F3: drift during the quiet ticks")
        spikes = 0
        while not mon.events and spikes < F3_MAX_SPIKES:
            f_tick(srv, rng, F3_SPIKE)
            spikes += 1
        return spikes
    spikes = counted("F3 pinned decentralized 8 pallas", drive,
                     {"csr_aggregate": None}, f_totals)
    require(mon.events, f"F3: no drift after {spikes} ticks of "
            f"{F3_SPIKE} churn")
    ev = mon.events[0]
    new = mon.result
    print(f"[pathF] F3 event at commit {ev.tick} after {spikes} spike "
          f"ticks: {ev.reason} measured {ev.measured:.6g} vs reference "
          f"{ev.reference:.6g} (tol {mon.tol}); measured churn "
          f"{ev.workload.churn:.4f}; {ev.old.key} -> {ev.new.key} "
          f"(score {new.recommended.score:.3e} s modeled, best "
          f"decentralized {new.best('decentralized').score:.3e} s), "
          f"swapped {ev.swapped}; host seconds: observer "
          f"{observed[-1]:.3f} (re-plan, the new plan's build, the swap), "
          f"swap (update_plan) {swaps[-1] if swaps else 0.0:.3f}",
          flush=True)
    require(ev.measured > ev.reference * mon.tol, "F3: event in band")
    require(ev.workload.churn > 4 * wl.churn,
            "F3: the measured churn is not above 4x the assumed")
    require((ev.new.setting, ev.new.n_clusters, ev.new.backend)
            != (ev.old.setting, ev.old.n_clusters, ev.old.backend),
            "F3: the re-plan kept the pinned configuration")
    require(ev.swapped and srv.plan.setting == ev.new.setting,
            "F3: the plan was not swapped")
    check_swap("F3", srv, mon, params, tensors, cfg, device, f_totals,
               BACKEND_KERNEL[ev.new.backend])
    del srv

    pinned = plan(g01.stats("collab 0.1"), "throughput",
                  workload=WorkloadProfile(**F_MIXED, sample=SAMPLE),
                  space=[Candidate("centralized", "fused", 1)])
    srv = StreamingGNNServer(own_feats(pinned.build_plan(g01)), cfg,
                             params=params, policy="eager", device=device)
    tensors = param_tensors(srv)
    swaps = timed_swaps(srv)
    mon = ReplanMonitor(pinned, window=2, tol=2.0, cooldown=1, shortlist=0)
    srv.refresh()
    t0 = time.perf_counter()
    for seconds in (0.01, 0.01, 0.05, 0.05):
        ev = mon.observe(CommitSample(seconds, 0.0, F_CHURN, queries=64,
                                      policy="eager"), server=srv)
    t_obs = time.perf_counter() - t0
    require(ev is not None and ev.swapped
            and ev.new.layout == "bucketed" and srv.plan.bucketed is not None,
            f"F3b: no swap to a bucketed plan ({ev})")
    print(f"[pathF] F3b injected drift: {ev.reason} {ev.measured:.3g} vs "
          f"{ev.reference:.3g}; {ev.old.key} -> {ev.new.key}; host seconds: "
          f"observe {t_obs:.3f} (re-plan, build, swap), swap "
          f"(update_plan) {swaps[-1]:.3f}", flush=True)
    srv.add_observer(mon)
    check_swap("F3b", srv, mon, params, tensors, cfg, device, f_totals,
               BACKEND_KERNEL[ev.new.backend])


def path_f4(g01) -> None:
    """F4: ``python -m repro_torch.launch.gnn --plan auto`` on collab 0.1,
    static and with ``--stream 8 --neighbor-mode cam-pallas`` (both at
    once); each one's ``planner[...]`` summary equals ``summary()`` of the
    same ``plan(...)`` call made here."""
    t0 = time.perf_counter()
    runs = {"static": ([], "latency", 0.0),
            "stream": (["--stream", "8", "--neighbor-mode", "cam-pallas"],
                       "throughput", 0.05)}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    try:
        for k, (extra, _, _) in runs.items():
            procs[k] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.gnn", "--plan",
                 "auto", "--dataset", "collab", "--scale", "0.1", *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
        want = {k: plan(g01, objective, WorkloadProfile(
                    churn=churn, queries_per_tick=16.0, sample=SAMPLE),
                    shortlist=2).summary().splitlines()
                for k, (_, objective, churn) in runs.items()}
        for k, p in procs.items():
            out, err = p.communicate(timeout=600)
            require(p.returncode == 0, f"F4 {k}: the CLI failed:\n{err}")
            lines = out.splitlines()
            require(lines[:len(want[k])] == want[k],
                    f"F4 {k}: the CLI's summary differs from the "
                    f"in-process one:\n{out}")
            served = [ln for ln in lines if ln.startswith(("served",
                                                           "plan:"))]
            print(f"[pathF] F4 CLI --plan auto {k}: exit 0; "
                  f"{want[k][1].strip()}; summary ({len(want[k])} lines) equal in-process; "
                  + "; ".join(served), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[pathF] F4 {time.perf_counter() - t0:.1f} s (both CLIs at once)",
          flush=True)


# ------------------------------------------------------------------ path G

# G1: AdamW steps of GNN training at collab 1.0 (jnp backend, ideal)
G1_STEPS = 8
G1_OPT = AdamWConfig(lr=1e-2, weight_decay=0.0, warmup=1)
# G2: the example's training of the taxi forecaster at the paper's size
G2_STEPS = 150
G2_OPT = AdamWConfig(lr=3e-3, weight_decay=0.0, warmup=10)
PATH_G = ("fused_ideal_layer", "csr_aggregate")


def learnable_labels(x: torch.Tensor, n_classes: int, seed: int):
    """[N] int32 classes a linear map of the features predicts: the argmax
    of X·R for a seeded R [F, n_classes]."""
    gen = torch.Generator().manual_seed(seed)
    r = torch.randn((x.shape[1], n_classes), generator=gen).to(x.device)
    return torch.argmax(x @ r, dim=-1).to(torch.int32)


def clones(tree):
    """A copy of every leaf: ``adamw_update`` on the card writes over the
    tree it is handed."""
    return _tree.tree_map(torch.clone, tree)


def train(grad, params, opt_cfg: AdamWConfig, steps: int) -> tuple:
    """(params, losses, ms per step): ``steps`` AdamW steps of
    ``grad(params, step) -> (loss, grads)``, each on the host clock
    between two device syncs; ``params`` is updated in place."""
    opt = adamw_init(params)
    losses, times = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = grad(params, step)
        params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    require(all(np.isfinite(losses)), f"a training loss is not finite: "
            f"{losses}")
    require(losses[-1] < losses[0], f"training did not lower the loss: "
            f"{losses[0]} -> {losses[-1]}")
    require(not any(t.requires_grad for t in _tree.leaves(params)),
            "trained parameters hold a graph")
    return params, losses, times


def leaf_errors(got, ref, rtol: float) -> tuple:
    """(every leaf of ``got`` (card) within rtol and atol 1e-4 * max|ref
    leaf| of ``ref`` (host), the largest error over its leaf's max|ref|)."""
    ok, worst = True, 0.0
    for a, b in zip(_tree.leaves(got), _tree.leaves(ref)):
        scale = float(b.abs().max()) or 1.0
        diff = (a.cpu() - b).abs()
        ok = ok and bool((diff <= 1e-4 * scale + rtol * b.abs()).all())
        worst = max(worst, float(diff.max()) / scale)
    return ok, worst


def g1_card_vs_host(tag: str, params, host: tuple, device, cfg) -> bool:
    """``gnn.grad_fn`` on the card against the host on the same weights
    and graph: prints the losses, the largest leaf error and how many
    layer-1 pre-activations have another sign on the card than on the
    host (there the ReLU's mask flips, and layer 1's gradients differ by
    that element's whole contribution). Returns whether the losses agree
    within rtol 1e-4 and every leaf within rtol 1e-4, atol 1e-4 *
    max|g_host|."""
    p_host = _tree.tree_map(lambda t: t.cpu(), params)
    on_card = tuple(t.to(device) for t in host)
    loss_d, g_d = gnn.grad_fn(params, *on_card, cfg)
    loss_h, g_h = gnn.grad_fn(p_host, *host, cfg)
    with torch.no_grad():
        pre_d = gnn.layer_step(*on_card[:3], params[0], cfg, act=False)
        pre_h = gnn.layer_step(*host[:3], p_host[0], cfg, act=False)
    flips = int(((pre_d > 0).cpu() != (pre_h > 0)).sum())
    ok, worst = leaf_errors(g_d, g_h, rtol=1e-4)
    ok = ok and abs(float(loss_d) - float(loss_h)) <= 1e-4 * abs(
        float(loss_h))
    print(f"[pathG] G1 grad_fn at collab 0.1 ({host[0].shape[0]} nodes), "
          f"{tag}, card vs host: loss {float(loss_d):.6f} / "
          f"{float(loss_h):.6f}, largest leaf error {worst:.3e} of max|g| "
          f"(tol 1e-4), {flips} of {pre_h.numel()} layer-1 ReLU masks "
          f"flipped", flush=True)
    return ok


def median_ms(times: list) -> float:
    return float(np.median(times[1:]))


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


GEMM_KERNELS = ("nvjet", "gemm", "xmma", "cutlass")


def phase_ms(events: list) -> str:
    """The kernel ms of a profiled step by what launched them: the main
    thread before the autograd thread's first launch (the forward), the
    autograd thread (the backward), the main thread after its last launch
    (for a training step the optimizer); and the GEMMs' ms. Kernels are
    matched to their launch by the trace's correlation ids."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    by_tid: dict = {}
    for e in kernels:
        src = launch.get(e["args"].get("correlation"))
        if src is not None:
            by_tid.setdefault(src["tid"], []).append((src["ts"], e))
    gemm = sum(e["dur"] for e in kernels
               if any(g in e["name"] for g in GEMM_KERNELS)) / 1e3
    text = f"GEMMs {gemm:.3f} ms"
    if len(by_tid) < 2:
        return text
    main = min(by_tid, key=lambda t: min(ts for ts, _ in by_tid[t]))
    auto = [(ts, e) for t, pairs in by_tid.items() if t != main
            for ts, e in pairs]
    lo, hi = min(ts for ts, _ in auto), max(ts for ts, _ in auto)
    ms = lambda pairs: sum(e["dur"] for _, e in pairs) / 1e3
    fwd = [(ts, e) for ts, e in by_tid[main] if ts < lo]
    after = [(ts, e) for ts, e in by_tid[main] if ts > hi]
    return (f"forward {ms(fwd):.3f} ms ({len(fwd)} kernels), backward "
            f"{ms(auto):.3f} ms ({len(auto)}), after the backward "
            f"{ms(after):.3f} ms ({len(after)}); {text}")


def step_profile(tag: str, fn, prefix: str = "[pathG]",
                 card: str = "", share: tuple = (), keep: bool = True) -> None:
    """One call of ``fn`` (a training or decode step) under
    ``torch.profiler``: its host ms (profiler on), the kernels' summed
    device ms over it (the device-busy share), the three kernels that
    take most and the split of ``phase_ms``, from its chrome trace
    (``chiprun_out/step_<tag>.json``, or a temporary file without
    ``keep``); with ``share``, the kernels whose names start with one of
    those prefixes: their ms, launches and share of the kernel time."""
    from torch.profiler import ProfilerActivity, profile
    if keep:
        path = os.path.join(ROOT, "chiprun_out", f"step_{tag}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
    else:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        if not keep:
            os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    else:
        print(f"{prefix} {tag}: the step's kernel time not measured (the "
              f"profiler's trace held no kernel, 3 tries)", flush=True)
        return
    by_name: dict = {}
    for e in kernels:
        k = kernel_name(e["name"])
        by_name[k] = by_name.get(k, 0.0) + float(e["dur"]) / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    mine = [e for e in kernels if kernel_name(e["name"]).startswith(share)] \
        if share else []
    mine_ms = sum(float(e["dur"]) for e in mine) / 1e3
    print(f"{prefix} {tag} one step under torch.profiler: "
          f"{wall_ms:.3f} ms on the host clock, {len(kernels)} kernels, "
          f"{busy:.3f} ms of kernel time (device-busy share "
          f"{busy / wall_ms:.3f}); most: "
          + "; ".join(f"{k} {ms:.3f} ms ({ms / busy:.2f})" for k, ms in top)
          + f"; {phase_ms(events)}"
          + (f"; {'/'.join(share)}* kernels {len(mine)} launches, "
             f"{mine_ms:.3f} ms ({mine_ms / busy:.3f} of the kernel time)"
             if share else "")
          + (f"; trace chiprun_out/{os.path.basename(path)}" if keep else "")
          + (f"; {card}" if card else ""), flush=True)


def path_g1(plan_c, x1, nbr, wts, g01, device) -> float:
    """GNN training at full width: AdamW steps at collab 1.0, the card's
    gradients against the host's at collab 0.1, one bit-accurate gradient,
    a checkpoint round trip of the trained weights and their serving on
    the hand-written kernels. Returns ms per training step."""
    cfg = gnn.GNNConfig(in_dim=x1.shape[1], hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    labels = learnable_labels(x1, OUT, seed=0)
    initial = gnn.init_params(cfg, seed=1, device=device)
    params, losses, times = train(
        lambda p, _: gnn.grad_fn(p, x1, nbr, wts, labels, cfg),
        clones(initial), G1_OPT, G1_STEPS)
    print(f"[pathG] G1 collab 1.0 ({x1.shape[0]} nodes, {cfg.dims}): "
          f"{G1_STEPS} AdamW steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    step_profile("G1", lambda: adamw_update(
        clones(params), gnn.grad_fn(params, x1, nbr, wts, labels, cfg)[1],
        adamw_init(params), G1_OPT))

    # the card's gradients against the host's at collab 0.1: held at the
    # initial weights, the same in every run; the trained ones differ from
    # run to run (index_add_ sums the gather gradients with atomics), and
    # where a layer-1 pre-activation of theirs lies within rounding of 0
    # its ReLU mask flips between card and host: reported
    nb01, wt01 = g01.neighbor_sample(SAMPLE)
    host = (torch.from_numpy(g01.features), torch.from_numpy(nb01),
            torch.from_numpy(wt01))
    host = (*host, learnable_labels(host[0], OUT, seed=0))
    require(g1_card_vs_host("initial weights", initial, host, device, cfg),
            "G1: the card's gradients at collab 0.1 are off the host's")
    g1_card_vs_host("trained weights (reported)", params, host, device, cfg)

    # the bit-accurate gradient flows through the DAC and weight scales
    cfg_q = dataclasses.replace(cfg, numerics=CrossbarNumerics())
    loss_q, g_q = gnn.grad_fn(params, x1, nbr, wts, labels, cfg_q)
    peaks = [float(t.abs().max()) for t in _tree.leaves(g_q)]
    require(np.isfinite(float(loss_q))
            and all(bool(torch.isfinite(t).all()) for t in _tree.leaves(g_q))
            and all(m > 0 for m in peaks),
            f"G1: bit-accurate gradients not finite and non-zero: {peaks}")
    print(f"[pathG] G1 bit-accurate grad_fn at collab 1.0: loss "
          f"{float(loss_q):.4f}, max|g| per leaf "
          f"{', '.join(f'{m:.3g}' for m in peaks)}", flush=True)

    # a checkpoint round trip onto the card, then serving on the kernels
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, G1_STEPS, params)
        restored, step = restore_checkpoint(
            d, _tree.tree_map(torch.zeros_like, params))
    require(step == G1_STEPS and all(
        torch.equal(a, b) and b.device == a.device
        for a, b in zip(_tree.leaves(params), _tree.leaves(restored))),
        "G1: the restored checkpoint differs from the trained weights")
    ref = GNNServer(dataclasses.replace(plan_c, backend="jnp"), cfg,
                    params=restored, device=device)
    ref.refresh()
    scale = float(np.abs(ref.embeddings).max())
    for backend in ("fused", "pallas"):
        srv = GNNServer(dataclasses.replace(plan_c, backend=backend), cfg,
                        params=restored, device=device)
        t = srv.refresh()
        diff = np.abs(srv.embeddings - ref.embeddings)
        ok = bool((diff <= 1e-4 * scale
                   + 1e-4 * np.abs(ref.embeddings)).all())
        print(f"[pathG] G1 trained weights served on {backend}: refresh "
              f"{t * 1e3:.1f} ms, max|err| {float(diff.max()):.3e} vs jnp "
              f"(tol {1e-4 * scale:.3e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"G1: the trained weights served on {backend} "
                f"disagree with jnp")
    return median_ms(times)


def taxi_graphs(n: int, cfg, device) -> tuple:
    """The example's three edge types, ``random_graph(n, 6 n, 1, seed=r)``,
    as [R, n, S] neighbor and weight tables on ``device``."""
    tables = [random_graph(n, n * 6, 1, seed=r).gcn_normalize()
              .neighbor_sample(cfg.sample) for r in range(cfg.n_edge_types)]
    return tuple(torch.from_numpy(np.stack(t)).to(device)
                 for t in zip(*tables))


def path_g2(device) -> float:
    """The taxi forecaster at the paper's size: the example's AdamW
    training on the card, then the card's gradients against the host's.
    Returns ms per training step."""
    cfg = taxi.TaxiConfig()
    n = TAXI_STATS.n_nodes
    nbr, wts = taxi_graphs(n, cfg, device)
    stream = taxi.synthetic_stream(0, n, G2_STEPS + cfg.p_hist
                                   + cfg.q_future, cfg, device=device)

    def batch(step: int) -> tuple:
        x_hist = stream[step:step + cfg.p_hist]
        target = stream[step + cfg.p_hist:step + cfg.p_hist + cfg.q_future]
        return x_hist, target.permute(1, 0, 2).reshape(
            n, cfg.q_future, cfg.m, cfg.n)

    def grad(p, step):
        x_hist, target = batch(step)
        return taxi.grad_fn(p, x_hist, nbr, wts, target, cfg)

    params = taxi.init_params(cfg, seed=1, device=device)
    params, losses, times = train(grad, params, G2_OPT, G2_STEPS)
    step_profile("G2", lambda: adamw_update(
        clones(params), grad(params, 0)[1], adamw_init(params), G2_OPT))
    learned = losses[-1] < 0.5 * losses[0]
    print(f"[pathG] G2 taxi {n} nodes ({cfg}): {G2_STEPS} AdamW steps, mse "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'LEARNED' if learned else 'no improvement'})", flush=True)

    x_hist, target = batch(0)
    loss_d, g_d = taxi.grad_fn(params, x_hist, nbr, wts, target, cfg)
    loss_h, g_h = taxi.grad_fn(
        _tree.tree_map(lambda t: t.cpu(), params), x_hist.cpu(), nbr.cpu(),
        wts.cpu(), target.cpu(), cfg)
    ok, worst = leaf_errors(g_d, g_h, rtol=0.0)
    require(ok and abs(float(loss_d) - float(loss_h))
            <= 1e-5 * abs(float(loss_h)),
            f"G2: the card's loss or gradients are off the host's: mse "
            f"{float(loss_d)} / {float(loss_h)}, leaf error {worst:.3e}")
    print(f"[pathG] G2 grad_fn card vs host: mse {float(loss_d):.6f} / "
          f"{float(loss_h):.6f}, largest leaf error {worst:.3e} of max|g| "
          f"(tol 1e-4)", flush=True)
    return median_ms(times)


def path_g3() -> None:
    """G3: ``python -m repro_torch.examples.taxi_forecast --nodes 10000
    --steps 150``; its Table-1 lines equal the cost model's here."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.taxi_forecast",
         "--nodes", str(TAXI_STATS.n_nodes), "--steps", str(G2_STEPS)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    require(out.returncode == 0, f"G3: the example failed:\n{out.stderr}")
    lines = out.stdout.splitlines()
    want = taxi_forecast.table1_lines()
    require(lines[-len(want):] == want, f"G3: the example's Table-1 lines "
            f"differ from the cost model's here:\n{out.stdout}")
    said = [ln for ln in lines if ln.startswith(("trained", "device"))]
    print(f"[pathG] G3 taxi_forecast example: exit 0; {'; '.join(said)}; "
          f"Table-1 lines equal in-process; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------------ path H

# the SPMD runtime (launch.mesh, distributed.halo's SPMD forwards): H1 a
# world of one rank on NCCL; H2 K ranks sharing cuda:0 over gloo (NCCL
# refuses two ranks on one card), decentralized 8 and semi 4 x 4 at collab
# 0.1 as D2 and F2 serve them; H3 the CLI under torch.distributed.run
PATH_H = ("fused_ideal_layer", "fused_zmax", "fused_quant_layer",
          "csr_aggregate")
H_MODES = ("allgather", "alltoall")
H_BATCHES, H_BATCH = 16, 16
H_TIMEOUT = 120.0          # every collective's timeout, s
H_RANK_DEVICE = "cuda:0"   # every rank's device
H1_BACKEND = "nccl"
H_DEADLINE = 300.0         # a spawn's or the CLI's deadline, s


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def h_cases():
    for mode in H_MODES:
        for backend in ("fused", "pallas"):
            for ideal in (True, False):
                yield mode, backend, ideal


def h_label(mode, backend, ideal) -> str:
    return f"{mode:9s} {backend:6s} {'ideal' if ideal else 'bit-accurate'}"


def path_h1(g01, cfg, params, device, h_totals: dict) -> None:
    """H1: a world of one rank on NCCL. A decentralized plan of one
    cluster at collab 0.1 through ``make_forward(mesh=...)`` on every
    case, equal to the emulated forward with ``torch.equal``;
    ``compressed_psum`` of a 64 x 496 gradient equal to int8 compress
    then decompress (one rank: the sum is its own codes, the max its own
    scale)."""
    t0 = time.perf_counter()
    plan1 = plan_execution(g01, "decentralized", sample=SAMPLE,
                           n_clusters=1)
    mesh = make_mesh((1,), ("data",), backend=H1_BACKEND,
                     device=H_RANK_DEVICE,
                     init_method=f"tcp://localhost:{free_port()}", rank=0,
                     timeout=H_TIMEOUT)
    try:
        for mode, backend, ideal in h_cases():
            c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                ideal=ideal))
            p = dataclasses.replace(plan1, backend=backend)
            emu = p.make_forward(c, mode=mode, device=device)(params)
            reset_launch_counts()
            got = p.make_forward(c, mesh=mesh, mode=mode,
                                 device=device)(params)
            if got.is_cuda:
                torch.cuda.synchronize()
            counts = launch_counts()
            label = h_label(mode, backend, ideal)
            require(got.shape == emu.shape and torch.equal(got, emu),
                    f"H1 {label}: the SPMD forward differs from the "
                    f"emulated one")
            for k in EXPECTED[(backend, ideal)]:
                require(counts[k] > 0, f"H1 {label}: {k} never launched")
            for k, v in counts.items():
                h_totals[k] += v
        gen = torch.Generator().manual_seed(0)
        grad = torch.randn(64, 496, generator=gen).to(device)
        zero = torch.zeros_like(grad)
        mean, resid = compressed_psum(grad, zero, mesh)
        q, scale, resid1 = int8_compress(grad, zero)
        require(torch.equal(mean, int8_decompress(q, scale))
                and torch.equal(resid, resid1),
                "H1: compressed_psum on one rank differs from int8 "
                "compress / decompress")
    finally:
        dist.destroy_process_group()
    print(f"[pathH] H1 {H1_BACKEND} world of 1: decentralized 1-cluster "
          f"plan at "
          f"collab 0.1 ({plan1.part.n_max} rows), 8 cases equal to the "
          f"emulated forward (torch.equal); compressed_psum 64x496 equal; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def write_shards(plan, d: str) -> None:
    """The plan's skeleton (without its feature and neighbor tables or the
    graph's edges and features) and each rank's own rows of those tables,
    as files under ``d``. The ranks read them there: a spawned process
    reads its pickled arguments only after importing the main module, so
    large arguments would start the ranks one after another."""
    import pickle
    g = plan.graph
    light = dataclasses.replace(g, indices=g.indices[:0], edge_weight=None,
                                features=g.features[:0], self_loop=None)
    with open(os.path.join(d, "skeleton.pkl"), "wb") as f:
        pickle.dump(dataclasses.replace(plan, graph=light, sub=None,
                                        feats=None, neighbors=None,
                                        weights=None), f)
    for r in range(plan.n_clusters):
        np.savez(os.path.join(d, f"shard{r}.npz"), feats=plan.feats[r],
                 nbr=plan.neighbors[r], wts=plan.weights[r])


def read_shard(d: str, rank: int):
    """The rank's plan: its own rows in place, the others zero (pages
    never touched, so never allocated)."""
    import pickle
    with open(os.path.join(d, "skeleton.pkl"), "rb") as f:
        skeleton = pickle.load(f)

    def rows(a):
        full = np.zeros((skeleton.n_clusters,) + a.shape, a.dtype)
        full[rank] = a
        return full
    with np.load(os.path.join(d, f"shard{rank}.npz")) as z:
        return dataclasses.replace(skeleton, feats=rows(z["feats"]),
                                   neighbors=rows(z["nbr"]),
                                   weights=rows(z["wts"]))


def h2_rank(rank, world, d, cfg, dev) -> dict:
    """One rank of H2: a ``GNNServer`` on the mesh per case, a refresh and
    16 lookup batches of 16 ids with the launch counters at 0 before,
    then the refresh's time (median of 3 after one warm-up) and one
    traced refresh for the collectives' share and bytes."""
    import hashlib
    stamps = [time.time()]
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((world,), ("data",), backend="gloo", device=dev,
                     init_method=f"file://{os.path.join(d, 'rendezvous')}",
                     rank=rank, timeout=H_TIMEOUT)
    torch.zeros(1, device=mesh.device)      # the context, made here
    stamps.append(time.time())
    plan = read_shard(d, rank)
    params = gnn.init_params(cfg, seed=0, device=mesh.device)
    n = plan.graph.n_nodes
    out = {}
    for mode, backend, ideal in h_cases():
        c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
        srv = GNNServer(dataclasses.replace(plan, backend=backend), c,
                        params=params, mesh=mesh, mode=mode,
                        device=mesh.device)
        reset_launch_counts()
        rng = np.random.default_rng(0)
        for _ in range(H_BATCHES):
            got = srv.query(rng.integers(0, n, H_BATCH))
            require(got.shape == (H_BATCH, cfg.out_dim)
                    and np.isfinite(got).all(),
                    "H2: a lookup has a wrong shape or non-finite values")
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        emb = srv.embeddings
        srv.refresh()
        secs = sorted(srv.refresh() for _ in range(3))
        require(np.array_equal(srv.embeddings, emb),
                "H2: a warm refresh changed the embeddings")
        tel.reset()
        tel.enable()
        traced = srv.refresh()
        coll, gather, shipped = 0.0, 0.0, {}
        for root in tel.get_tracer().roots:
            for sp in root.walk():
                if sp.name == "halo.collective":
                    coll += sp.duration_s
                    layer = sp.attrs["layer"]
                    shipped[layer] = shipped.get(layer, 0) \
                        + sp.attrs["bytes"]
                elif sp.name == "halo.output_gather":
                    gather += sp.duration_s
                    shipped["out"] = shipped.get("out", 0) \
                        + sp.attrs["bytes"]
        tel.disable()
        tel.reset()
        out[(mode, backend, ideal)] = dict(
            digest=hashlib.sha256(emb.tobytes()).hexdigest(),
            emb=emb if rank == 0 else None, counts=counts,
            ms=secs[1] * 1e3, traced_ms=traced * 1e3,
            coll_ms=coll * 1e3, gather_ms=gather * 1e3, shipped=shipped)
        del srv
    stamps.append(time.time())
    dist.destroy_process_group()
    stamps.append(time.time())
    out["stamps"] = stamps
    return out


def path_h2(label: str, plan, cfg, params, device, h_totals: dict,
            card: str) -> None:
    """H2: ``plan.n_clusters`` gloo ranks sharing cuda:0 serve ``plan``
    through ``GNNServer(mesh=...)`` on every case; every rank's gathered
    embeddings equal the emulated forward's on the card, and every rank
    launched its backend's serving kernels."""
    import hashlib
    t0 = time.perf_counter()
    refs, emu_ms = {}, {}
    for key in h_cases():
        mode, backend, ideal = key
        c = dataclasses.replace(cfg, numerics=CrossbarNumerics(ideal=ideal))
        srv = GNNServer(dataclasses.replace(plan, backend=backend), c,
                        params=params, mode=mode, device=device)
        srv.refresh()
        refs[key] = srv.embeddings
        emu_ms[key] = sorted(srv.refresh() for _ in range(3))[1] * 1e3
        del srv
    traffic = {m: plan.measured_traffic(cfg, mode=m).tier1_bytes()
               for m in H_MODES}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        write_shards(plan, d)
        t1 = time.perf_counter()
        w1 = time.time()
        res = spawn(h2_rank, plan.n_clusters, (d, cfg, H_RANK_DEVICE),
                    deadline=H_DEADLINE)
        t_ranks = time.perf_counter() - t1
    # where the ranks' time went (wall clock, latest rank): started,
    # mesh and CUDA context made, cases served, group destroyed, exited
    st = np.array([r["stamps"] for r in res]) - w1
    phases = (f"ranks in their function {st[:, 0].min():.1f}-"
              f"{st[:, 0].max():.1f} s after the spawn, mesh and context "
              f"{(st[:, 1] - st[:, 0]).max():.1f} "
              f"s, cases {(st[:, 2] - st[:, 1]).max():.1f} s, group "
              f"destroyed {(st[:, 3] - st[:, 2]).max():.1f} s, exit "
              f"{t_ranks - st[:, 3].max():.1f} s")
    for key in h_cases():
        mode, backend, ideal = key
        tag = f"H2 {label} {h_label(*key)}"
        ref = refs[key]
        want = hashlib.sha256(ref.tobytes()).hexdigest()
        equal = all(r[key]["digest"] == want for r in res)
        if equal:
            verdict = "every rank equal to the emulated forward (bit for bit)"
        else:
            # not bit-equal: the serving gate, 1e-4 max|ref| of jnp
            err = float(np.abs(res[0][key]["emb"] - ref).max())
            tol = 1e-4 * (float(np.abs(ref).max()) or 1.0)
            require(len({r[key]["digest"] for r in res}) == 1
                    and err <= tol, f"{tag}: the SPMD embeddings differ "
                    f"from the emulated forward: max|err| {err:.3e} "
                    f"(tol {tol:.3e})")
            verdict = (f"NOT bit-equal to the emulated forward: max|err| "
                       f"{err:.3e} within the gate {tol:.3e}")
        for rank, r in enumerate(res):
            for k in EXPECTED[(backend, ideal)]:
                require(r[key]["counts"][k] > 0,
                        f"{tag}: {k} never launched on rank {rank}")
            for k, v in r[key]["counts"].items():
                h_totals[k] += v
        ms = [r[key]["ms"] for r in res]
        r0 = res[0][key]
        share = (r0["coll_ms"] + r0["gather_ms"]) / r0["traced_ms"]
        shipped = ", ".join(
            f"layer {l} {r0['shipped'][l] / 1e6:.2f} MB (measured_traffic "
            f"tier-1 {traffic[mode][l].max() / 1e6:.2f} MB)"
            for l in range(len(cfg.dims) - 1))
        print(f"[pathH] {tag}: refresh {r0['ms']:.1f} ms (rank 0; ranks "
              f"{min(ms):.1f}-{max(ms):.1f}; median of 3 after a warm-up, "
              f"host clock, device synced; the emulated forward in one "
              f"process {emu_ms[key]:.1f} ms); traced refresh "
              f"{r0['traced_ms']:.1f} ms, "
              f"collectives {r0['coll_ms']:.1f} ms + output gather "
              f"{r0['gather_ms']:.1f} ms = {share:.3f} of it; sent a rank "
              f"a layer: {shipped}; output gather "
              f"{r0['shipped']['out'] / 1e6:.2f} MB; {verdict}; launches "
              f"rank 0 {json.dumps(r0['counts'])}; {card}", flush=True)
    print(f"[pathH] H2 {label}: {plan.n_clusters} gloo ranks on "
          f"{H_RANK_DEVICE}, spawn to exit {t_ranks:.1f} s ({phases}); "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)


def path_h(g01, plan_d, plan_s, cfg, params, device, h_totals: dict,
           card: str) -> None:
    path_h1(g01, cfg, params, device, h_totals)
    path_h2("decentralized 8", plan_d, cfg, params, device, h_totals, card)
    path_h2("semi 4x4", plan_s, cfg, params, device, h_totals, card)
    path_h3()


def path_h3() -> None:
    """H3: ``python -m torch.distributed.run --standalone --nproc-per-node
    8 -m repro_torch.launch.gnn --setting decentralized --clusters 8
    --dist-backend gloo --requests 8``: exit 0, the refresh line printed
    once, by rank 0, on 8 gloo ranks."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.gnn",
         "--setting", "decentralized", "--clusters", "8",
         "--dist-backend", "gloo", "--requests", "8"],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=H_DEADLINE)
    require(out.returncode == 0, f"H3: the CLI under torch.distributed.run "
            f"failed (exit {out.returncode}):\n{out.stdout}\n{out.stderr}")
    lines = [ln for ln in out.stdout.splitlines()
             if "embedding refresh" in ln]
    require(len(lines) == 1 and "8 clusters on 8 gloo ranks" in lines[0],
            f"H3: want one refresh line from rank 0 on 8 gloo ranks, "
            f"got:\n{out.stdout}")
    print(f"[pathH] H3 torch.distributed.run, 8 gloo ranks: exit 0; "
          f"{lines[0].strip()}; {time.perf_counter() - t0:.1f} s",
          flush=True)


# ------------------------------------------------------------------ path I

# the LM stack (repro_torch.models; launch.train, launch.serve): I1 training
# and I2 serving at internlm2-1.8b's full size, I3 the ten architectures'
# smoke configs on the card against the host, I4 one MoE layer at grok-1's
# widths. No kernel of the six runs on it.
I_ARCH = "internlm2-1.8b"
I1_BATCH, I1_SEQ, I1_STEPS, I1_LR = 4, 512, 6, 1e-2
I2_SLOTS, I2_CAPACITY, I2_REQUESTS, I2_NEW = 4, 128, 8, 16
I3_B, I3_S, I3_DECODE = 2, 16, 3
I4_ARCH, I4_B, I4_S = "grok-1-314b", 2, 128


def path_i1(device, card: str) -> dict:
    """I1: ``launch.train.train`` at internlm2-1.8b's full size: AdamW
    steps (host clock between device syncs, median after the first), peak
    device memory, model FLOPs over the bf16 peak; then one step profiled
    as path G profiles its steps. Returns the run (losses, final
    parameters, ms a step, peak GiB) for J1."""
    mcfg = lm_configs.get_config(I_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps, losses, final = [], [], {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(metrics["loss"]))

    t0 = time.perf_counter()
    out = lm_train.train(lm_train.TrainConfig(
        arch=I_ARCH, smoke=False, steps=I1_STEPS, batch=I1_BATCH,
        seq=I1_SEQ, lr=I1_LR, log_every=I1_STEPS, device=str(device)),
        hooks={"on_step": on_step,
               "on_end": lambda p, o: final.update(params=p)})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(out["last_step"] == I1_STEPS - 1 and all(np.isfinite(losses)),
            f"I1: training did not run its steps with finite losses: "
            f"{losses}")
    require(losses[-1] < losses[0], f"I1: the loss did not fall: {losses}")
    ms = float(np.median(np.diff(stamps) * 1e3))
    tokens = I1_BATCH * I1_SEQ
    share = model_flops(mcfg, tokens, "train") / (ms / 1e3) \
        / H100.peak("bf16")
    print(f"[pathI] I1 train {I_ARCH} full size ({mcfg.param_count():,} "
          f"params, batch {I1_BATCH} x seq {I1_SEQ}, bf16): "
          f"{I1_STEPS} AdamW steps, loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {ms:.3f} ms a step (host clock between syncs, median after "
          f"the first), {tokens / (ms / 1e3):,.0f} tokens/s, model FLOPs "
          f"{model_flops(mcfg, tokens, 'train') / 1e12:.2f} TFLOP a step = "
          f"{share:.4f} of the bf16 peak; peak memory {peak:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)

    model = lm_models.build(mcfg)
    params = model.init(1, device=device)
    opt = adamw_init(params)
    step = lm_steps.make_train_step(model, AdamWConfig(lr=I1_LR))
    batch = _tree.tree_map(lambda x: x.to(device), TokenStream(
        mcfg.vocab, I1_BATCH, I1_SEQ).batch_at(0))
    step(params, opt, batch)
    step_profile("I1", lambda: step(params, opt, batch), prefix="[pathI]",
                 card=card)
    return {"losses": losses, "params": _tree.leaves(final["params"]),
            "ms": ms, "peak": peak}


def direct_chain(model, params, req, forced: list, device):
    """The reference's direct one-sequence decode of ``req`` (batch 1),
    teacher-forced on ``forced`` (the server's new tokens). Returns (its
    greedy tokens, the largest gap between its top logit and the forced
    token's, max|logits|); a zero gap everywhere means its free-running
    greedy chain is ``forced``."""
    caches = model.init_caches(1, I2_CAPACITY, device=device)
    with torch.no_grad():
        for p, t in enumerate(req.prompt):
            logits, caches = model.decode_step(
                params, torch.tensor([[t]], device=device), caches, p)
        greedy, gap, peak = [], 0.0, 0.0
        for n, t in enumerate(forced):
            row = logits[0, 0].float()
            greedy.append(int(torch.argmax(row)))
            gap = max(gap, float(row.max() - row[t]))
            peak = max(peak, float(row.abs().max()))
            if n < len(forced) - 1:
                logits, caches = model.decode_step(
                    params, torch.tensor([[t]], device=device), caches,
                    len(req.prompt) + n)
    return greedy, gap, peak


def text_positions(cfg, b: int, s: int, device) -> dict:
    """The prefill batch's M-RoPE positions of a text-only input (equal on
    the three axes), for a config with M-RoPE sections; else none."""
    if not cfg.mrope_sections:
        return {}
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return {"mrope_pos": pos[None, None].expand(3, b, s)}


def prefill_vs_chain(model, params, prompt) -> tuple:
    """``make_prefill_step``'s last logits over ``prompt`` [1, S] against
    the teacher-forced decode chain's: (max|diff|, max|ref|, how many
    logits lie outside 0.15 + 0.15 |ref|)."""
    ref = lm_steps.make_prefill_step(model)(params, {
        "tokens": prompt, **text_positions(model.cfg, 1, prompt.shape[1],
                                           prompt.device)}).float()
    caches = model.init_caches(1, I2_CAPACITY, device=prompt.device)
    with torch.no_grad():
        for i in range(prompt.shape[1]):
            logits, caches = model.decode_step(
                params, prompt[:, i:i + 1], caches, i)
    diff = (logits.float() - ref).abs()
    return (float(diff.max()), float(ref.abs().max()),
            int((diff > 0.15 + 0.15 * ref.abs()).sum()))


def serve_full(arch: str, tag: str, prefix: str, device, card: str,
               cli: bool = True, keep_trace: bool = False,
               extra=None) -> None:
    """``launch.serve.Server`` at ``arch``'s full size on the CLI's
    request mix (I2's); every request's greedy output against a direct
    one-sequence decode chain, ``prefill`` against the teacher-forced
    chain; one batched decode step profiled; a 4 x 128 prefill timed; the
    peak device memory; ``extra(srv)``, if given, adds its line; then,
    with ``cli``, the CLI ``--full`` as a subprocess. The server is freed
    before the CLI runs."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    srv = lm_serve.Server(arch, smoke=False, slots=I2_SLOTS,
                          capacity=I2_CAPACITY, device=device)
    n_params = sum(t.numel() for t in _tree.leaves(srv.params))
    warm = lm_serve.requests(srv.cfg.vocab, 2, 2, seed=1)
    for r in warm:
        srv.submit(r)
    srv.run()
    reqs = lm_serve.requests(srv.cfg.vocab, I2_REQUESTS, I2_NEW)
    for r in reqs:
        srv.submit(r)
    srv.steps_run = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total = srv.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    step_ms = secs * 1e3 / srv.steps_run
    require(total == I2_REQUESTS * I2_NEW and all(r.done for r in reqs),
            f"{tag}: served {total} tokens, want {I2_REQUESTS * I2_NEW}")

    equal, worst = 0, 0.0
    for r in reqs:
        greedy, gap, peak = direct_chain(srv.model, srv.params, r, r.out,
                                         device)
        equal += greedy == r.out
        worst = max(worst, gap / peak)
        require(gap <= 0.05 * peak, f"{tag}: request {r.rid}'s server tokens "
                f"{r.out} leave the direct chain's greedy {greedy} by a "
                f"logit gap {gap:.4f} (tol 0.05 * {peak:.3f})")
        if greedy != r.out:
            print(f"{prefix} {tag} request {r.rid}: server {r.out} vs direct "
                  f"chain {greedy}, a near-tie (largest gap {gap:.4f} of "
                  f"max|logit| {peak:.3f})", flush=True)

    # one batched decode step, profiled
    caches = srv.model.init_caches(I2_SLOTS, I2_CAPACITY, device=device)
    tok = torch.zeros((I2_SLOTS, 1), dtype=torch.long, device=device)
    srv._step(srv.params, caches, tok, 0)
    step_profile(tag, lambda: srv._step(srv.params, caches, tok, 1),
                 prefix=prefix, card=card, keep=keep_trace)
    del caches

    # prefill's last logits against the teacher-forced decode chain
    prompt = torch.tensor(reqs[0].prompt * 4, device=device)[None]
    diff, top, over = prefill_vs_chain(srv.model, srv.params, prompt)
    pf = lm_steps.make_prefill_step(srv.model)
    batch = {"tokens": torch.randint(0, srv.cfg.vocab, (I2_SLOTS,
                                                         I2_CAPACITY),
                                     device=device),
             **text_positions(srv.cfg, I2_SLOTS, I2_CAPACITY, device)}
    prefill = []
    for _ in range(4):
        torch.cuda.synchronize()
        tp = time.perf_counter()
        pf(srv.params, batch)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - tp) * 1e3)
    said = extra(srv) if extra is not None else ""
    peak = torch.cuda.max_memory_allocated() / 2 ** 30   # before the copy
    consistency = (f"prefill vs the decode chain max|diff| {diff:.4f} (tol "
                   f"0.15 + 0.15 |ref|)")
    if srv.cfg.tie_embeddings:
        # a head tied to the token table (drawn at scale 1) puts the
        # logits near sqrt(d_model) times an untied head's: through the
        # depth the bf16 prefill's and chain's roundings part by more than
        # 0.15 + 0.15 |ref| there, as the reference's own do
        # (tests/test_torch_lm_windows.py); the tolerance is held on the
        # same weights in float32
        f32 = lm_models.build(dataclasses.replace(srv.cfg, dtype="float32"))
        up = _tree.tree_map(lambda t: t.float(), srv.params)
        diff32, _, over32 = prefill_vs_chain(f32, up, prompt)
        del f32, up
        torch.cuda.empty_cache()
        require(not over32, f"{tag}: float32 prefill vs the decode chain "
                f"off by {diff32}")
        consistency = (f"prefill vs the decode chain, the same weights in "
                       f"float32: max|diff| {diff32:.4f} (tol 0.15 + 0.15 "
                       f"|ref|); in bf16 (tied head, max|logit| {top:.1f}) "
                       f"{diff:.4f}, outside 0.15 + 0.15 |ref| on {over} of "
                       f"{srv.cfg.vocab} logits")
    else:
        require(not over, f"{tag}: prefill vs the decode chain off by {diff}")
    print(f"{prefix} {tag} serve {arch} full size ({srv.cfg.n_layers} layers, "
          f"d_model {srv.cfg.d_model}, vocab {srv.cfg.vocab}; {n_params:,} "
          f"parameters, bf16): {I2_REQUESTS} requests "
          f"(prompts {sorted({len(r.prompt) for r in reqs})}, {I2_NEW} new "
          f"tokens each) on {I2_SLOTS} slots, {srv.steps_run} batched "
          f"decode steps in {secs * 1e3:.1f} ms: {step_ms:.3f} ms a step, "
          f"{total / secs:.1f} tokens/s; greedy outputs equal to the direct "
          f"one-sequence chain for {equal} of {len(reqs)} (largest logit "
          f"gap {worst:.2e} of max|logit|, tol 0.05); {consistency}; "
          f"prefill of {I2_SLOTS} x {I2_CAPACITY} tokens "
          f"{median_ms(prefill):.3f} ms (median of 3 after one); {said}"
          f"peak device memory {peak:.2f} GiB serving ({before:.2f} GiB "
          f"allocated before the server); {time.perf_counter() - t0:.1f} s; "
          f"{card}",
          flush=True)
    del srv, pf
    torch.cuda.empty_cache()
    if not cli:
        return

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--full"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    require(out.returncode == 0 and "served 8 requests, 128 tokens"
            in out.stdout, f"{tag}: the serve CLI failed:\n{out.stdout}\n"
            f"{out.stderr}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("served")]
    print(f"{prefix} {tag} python -m repro_torch.launch.serve --arch {arch} "
          f"--full: exit 0; {line[0]}; {time.perf_counter() - t0:.1f} s; "
          f"{card}", flush=True)


def i3_batch(cfg, device) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (I3_B, I3_S)),
             "labels": rng.integers(0, cfg.vocab, (I3_B, I3_S))}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(I3_B, cfg.encoder.n_frames,
                                           cfg.d_model))
    out = {k: torch.from_numpy(v).to(device, torch.int32 if v.dtype.kind
                                     == "i" else lm_common.dtype_of(
                                         cfg.dtype))
           for k, v in batch.items()}
    if cfg.mrope_sections:
        out["mrope_pos"] = torch.arange(I3_S, dtype=torch.int32, device=
                                        device)[None, None].expand(
                                            3, I3_B, I3_S)
    return out


def i3_decode(model, params, batch) -> list:
    """Three decode steps' logits from empty caches."""
    device = batch["tokens"].device
    caches = model.init_caches(I3_B, 8, device=device)
    enc = None
    out = []
    with torch.no_grad():
        if model.cfg.is_encdec:
            enc = model._cross_kvs(params, model.encode(params,
                                                        batch["frames"]))
        for i in range(I3_DECODE):
            logits, caches = model.decode_step(
                params, batch["tokens"][:, i:i + 1], caches, i, enc_kvs=enc)
            out.append(logits.float().cpu())
    return out


def path_i3(device, card: str) -> None:
    """I3: every architecture's smoke config, one weight set drawn on the
    host and carried to the card: at float32 the loss (rtol 1e-5), every
    gradient leaf (atol 1e-4 * max|g_host|) and three decode steps' logits
    (1e-4 * max|ref|) on the card against the host; at the configs' bf16
    the loss and logits finite and within 0.05 * max|ref|. Then the
    ``lm_train`` example as a subprocess, its resume line printed."""
    t0 = time.perf_counter()
    for arch in lm_configs.ARCHS:
        line = []
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 0.05)):
            cfg = dataclasses.replace(lm_configs.get_config(arch, smoke=True),
                                      dtype=dtype)
            model = lm_models.build(cfg)
            host = model.init(0, device="cpu")
            on_card = _tree.tree_map(lambda t: t.to(device), host)
            hb, cb = i3_batch(cfg, "cpu"), i3_batch(cfg, device)
            if dtype == "float32":
                (lh, _), gh = _tree.value_and_grad(model.loss, host, hb,
                                                   has_aux=True)
                (lc, _), gc = _tree.value_and_grad(model.loss, on_card, cb,
                                                   has_aux=True)
                ok, g_err = leaf_errors(gc, gh, rtol=0.0)
                rel = abs(float(lc) - float(lh)) / abs(float(lh))
                require(ok and rel <= 1e-5, f"I3 {arch} f32: loss "
                        f"{float(lc)} / {float(lh)}, leaf error {g_err:.3e}")
            else:
                with torch.no_grad():
                    lh, _ = model.loss(host, hb)
                    lc, _ = model.loss(on_card, cb)
                rel = abs(float(lc) - float(lh)) / abs(float(lh))
                g_err = None
                require(np.isfinite(float(lc)) and rel <= tol,
                        f"I3 {arch} bf16: loss {float(lc)} / {float(lh)}")
            worst = 0.0
            for got, ref in zip(i3_decode(model, on_card, cb),
                                i3_decode(model, host, hb)):
                scale = float(ref.abs().max()) or 1.0
                require(bool(torch.isfinite(got).all()), f"I3 {arch} "
                        f"{dtype}: decode logits not finite")
                worst = max(worst, float((got - ref).abs().max()) / scale)
            require(worst <= tol, f"I3 {arch} {dtype}: decode logits off by "
                    f"{worst:.3e} of max|ref| (tol {tol})")
            line.append(f"{dtype} loss rel {rel:.2e}"
                        + (f", grads {g_err:.2e}" if g_err is not None
                           else "") + f", logits {worst:.2e}")
        print(f"[pathI] I3 {arch} smoke, card vs host: " + "; ".join(line)
              + " (tol f32 1e-5 loss, 1e-4 grads and logits; bf16 0.05)",
              flush=True)
    print(f"[pathI] I3 ten architectures within tolerance; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.lm_train", "--steps",
         "20"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    said = [ln for ln in out.stdout.splitlines()
            if ln.startswith(("final", "fault injected"))]
    require(out.returncode == 0 and len(said) == 2 and "resumed" in said[1],
            f"I3: the lm_train example failed or printed no resume line:\n"
            f"{out.stdout}\n{out.stderr}")
    print(f"[pathI] I3 python -m repro_torch.examples.lm_train --steps 20: "
          f"exit 0; {'; '.join(said)}; {time.perf_counter() - t0:.1f} s; "
          f"{card}", flush=True)


def moe_oracle(params, x2d, ids, gates, cfg) -> torch.Tensor:
    """Every token's swiglu through each expert it routes to, in f32,
    combined by its gates."""
    f = cfg.moe.d_ff_expert
    xf = x2d.float()
    out = torch.zeros_like(xf)
    for e in range(cfg.moe.n_experts):
        w = torch.where(ids == e, gates, 0.0).sum(-1)       # [T]
        h = xf @ params["wi"][e].float()
        h = torch.nn.functional.silu(h[:, :f]) * h[:, f:]
        out += w[:, None] * (h @ params["wo"][e].float())
    return out


def path_i4(device, card: str) -> None:
    """I4: one ``moe_ffn`` layer at grok-1's widths on a [2, 128, 6144]
    batch against the dense oracle on the card: at capacity factor 8 (no
    drops) within 0.05 * max|ref| + 1e-3 (the reference's tolerance); at
    the config's 1.25 the dropped fraction and the layer's ms."""
    t0 = time.perf_counter()
    cfg = lm_configs.get_config(I4_ARCH)
    params = lm_moe.init_moe(lm_common.InitKey.from_seed(0, device), cfg)
    n = sum(t.numel() for t in _tree.leaves(params))
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((I4_B, I4_S, cfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    with torch.no_grad():
        out, aux = lm_moe.moe_ffn(params, x, wide)
        x2d = x.reshape(-1, cfg.d_model)
        ids, gates = lm_moe._route(params, x2d, cfg)
        ref = moe_oracle(params, x2d, ids, gates, cfg)
    err = float((out.reshape(-1, cfg.d_model).float() - ref).abs().max())
    tol = 0.05 * float(ref.abs().max()) + 1e-3
    require(float(aux["dropped_frac"]) == 0.0 and err <= tol,
            f"I4: moe_ffn off the dense oracle by {err} (tol {tol}), "
            f"dropped {float(aux['dropped_frac'])}")
    with torch.no_grad():
        _, aux125 = lm_moe.moe_ffn(params, x, cfg)
        ms = cuda_ms(lambda: lm_moe.moe_ffn(params, x, cfg), 10)
    print(f"[pathI] I4 moe_ffn at {I4_ARCH}'s widths (d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts of d_ff "
          f"{cfg.moe.d_ff_expert}, top-{cfg.moe.top_k}, {cfg.moe.router} "
          f"router; {n:,} parameters, bf16) on [{I4_B}, {I4_S}, "
          f"{cfg.d_model}]: capacity factor 8 no drops, max|err| {err:.4e} "
          f"vs the dense f32 oracle (tol {tol:.4e}); capacity factor "
          f"{cfg.moe.capacity_factor}: dropped_frac "
          f"{float(aux125['dropped_frac']):.4f}, {ms:.3f} ms a layer (CUDA "
          f"events, mean of 10 after 2); {time.perf_counter() - t0:.1f} s; "
          f"{card}", flush=True)
    del params
    torch.cuda.empty_cache()


def path_i(device, card: str) -> dict:
    t0 = time.perf_counter()
    reset_launch_counts()
    reset_attention_paths()
    i1 = path_i1(device, card)
    # I2: Server at internlm2-1.8b's full size, its decode step's trace kept
    serve_full(I_ARCH, "I2", "[pathI]", device, card, keep_trace=True)
    paths = attention_paths()
    path_i3(device, card)
    path_i4(device, card)
    counts = launch_counts()
    print(f"[pathI] launches over path I {json.dumps(counts)}; I1 and I2's "
          f"attention calls by path {json.dumps(paths)}; "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)
    require(not any(counts[k] for k in KERNELS),
            "path I launched a GNN kernel")
    require(paths["kernel"] > 0 and not paths["composed"],
            f"path I: internlm2's attention left the kernel: {paths}")
    require(counts["rglru_scan"] > 0 and counts["wkv6_scan"] > 0,
            "path I's recurrent smoke configs did not reach the scans")
    return i1


# ------------------------------------------------------------------ path J

# the LM stack on a (data, model) mesh (distributed.sharding, launch.train
# --mesh, launch.elastic) and the dry run (launch.dryrun, analysis.opcount).
# No kernel of the six runs on it.
J2_STEPS, J2_CKPT = 6, 3
# eps 1e-3 keeps AdamW's first steps a smooth function of the gradient
# (the tests' setting): at 1e-8 an element within rounding of 0 moves by
# up to 2 * lr between two summation orders
J_OPT = dict(lr=1e-2, warmup=1, eps=1e-3)
J2_SMOKE = ("internlm2-1.8b", "grok-1-314b", "deepseek-v3-671b")
J2_SMOKE_B, J2_SMOKE_S, J2_SMOKE_STEPS = 4, 16, 3
J_DEADLINE = 900.0         # a spawn's deadline, s
J_TIMEOUT = 300.0          # every collective's timeout, s
J4_CELLS = (("internlm2-1.8b", "train_4k", False),
            ("internlm2-1.8b", "prefill_32k", False),
            ("internlm2-1.8b", "decode_32k", False),
            ("grok-1-314b", "train_4k", False),
            ("rwkv6-3b", "long_500k", False),
            ("rwkv6-3b", "train_4k", False),
            ("deepseek-v3-671b", "decode_32k", True))
J4_DEADLINE = 420.0        # a dry-run cell's deadline, s
# the dry run's live bytes of J1's cell over J1's own measured peak
J4_LIVE_BAND = (0.90, 1.10)


def leaf_errs(got: list, want: list) -> float:
    """The largest max|got - want| / max|want| over the leaves."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float().to(g.device)
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def j_check(tag: str, losses, ref_losses, err: float) -> str:
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    require(len(losses) == len(ref_losses) and rel <= 1e-5,
            f"{tag}: losses {losses} against {ref_losses} (rel {rel:.3e})")
    require(err <= 1e-4, f"{tag}: parameters off by {err:.3e} of a leaf's "
            f"max|ref|")
    return (f"losses within {rel:.2e} relative, parameters within "
            f"{err:.2e} of each leaf's max|ref|")


def path_j1(device, card: str, i1: dict) -> float:
    """J1: ``train()`` with ``mesh="1x1"`` on a world of one NCCL rank (the
    DTensor path) at I1's size, seed and batches, against I1's run."""
    from repro_torch.distributed.sharding import full
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the script holds already, I1's final parameters among it
        held = torch.cuda.memory_allocated()
        stamps, losses, final = [], [], {}

        def on_step(step, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses.append(float(metrics["loss"]))

        t0 = time.perf_counter()
        reset_update_paths()
        lm_train.train(lm_train.TrainConfig(
            arch=I_ARCH, smoke=False, steps=I1_STEPS, batch=I1_BATCH,
            seq=I1_SEQ, lr=I1_LR, log_every=I1_STEPS, device=str(device),
            mesh="1x1", dist_backend="nccl"),
            hooks={"on_step": on_step,
                   "on_end": lambda p, o: final.update(params=p)})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        own = peak - held / 2 ** 30
        require(update_paths() == {"kernel": 0, "plain": 0,
                                   "dtensor": I1_STEPS},
                f"J1: adamw_update by path {update_paths()}")
        got = [full(x) for x in _tree.leaves(final.pop("params"))]
        verdict = j_check("J1", losses, i1["losses"],
                          leaf_errs(got, i1["params"]))
        del got
        ms = float(np.median(np.diff(stamps) * 1e3))
        print(f"[pathJ] J1 train(mesh='1x1') {I_ARCH} full size, a world of "
              f"one NCCL rank, DTensor parameters: loss "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; against I1 (same seed and batches): {verdict}; "
              f"{ms:.3f} ms a step (I1 {i1['ms']:.3f} ms; ratio "
              f"{ms / i1['ms']:.3f}; host clock between syncs, median "
              f"after the first), peak memory {peak:.2f} GiB, of which "
              f"{held / 2 ** 30:.2f} GiB allocated before the run (I1's "
              f"final parameters, held for the comparison, among it): the "
              f"run's own {own:.2f} GiB (I1 "
              f"{i1['peak']:.2f}); {time.perf_counter() - t0:.1f} s; {card}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return own


def j_smoke_config(arch: str):
    """The smoke config at f32; grok-1's MoE with 3 experts, which a model
    axis of 2 does not divide (its expert-inner TP; deepseek-v3: EP)."""
    cfg = dataclasses.replace(lm_configs.get_config(arch, smoke=True),
                              dtype="float32")
    if arch == "grok-1-314b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    return cfg


J2_REDISTRIBUTIONS = ("all_reduce", "reduce_scatter", "all_to_all",
                      "all_gather")
# F7's probe: gloo's all-gather entry points on CUDA tensors, two ranks
# sharing cuda:0. "plain" is dist.all_gather_into_tensor (_allgather_base);
# "routed" the functional op DTensor calls, through the port's
# route_gloo_cuda_all_gather. "coalesced" (the process group's
# allgather_into_tensor_coalesced) and "functional" (the functional op
# without the route) end both ranks with SIGSEGV under torch 2.11: they run
# only under ``--f7-probe``.
J2_PROBE = ("plain", "routed")
J2_PROBE_FAULTS = ("coalesced", "functional")


def j2_probe_rank(rank, world, d, cases: tuple):
    """One rank of F7's probe: each case's all-gather of a [2, 4] CUDA
    tensor over one gloo group of two ranks sharing cuda:0, in turn."""
    from repro_torch.launch.mesh import route_gloo_cuda_all_gather
    dist.init_process_group("gloo", init_method=f"file://"
                            f"{os.path.join(d, cases[0])}", rank=rank,
                            world_size=world)
    torch.cuda.set_device(0)
    x = torch.arange(8, dtype=torch.float32, device="cuda").reshape(2, 4) \
        + 100 * rank
    fn = torch.ops._c10d_functional
    res = {}
    for case in cases:
        out = torch.empty((4, 4), device="cuda")
        if case == "plain":
            dist.all_gather_into_tensor(out, x)
        elif case == "coalesced":
            dist.group.WORLD.allgather_into_tensor_coalesced([out],
                                                             [x]).wait()
        else:
            if case == "routed":
                route_gloo_cuda_all_gather()
            out = fn.wait_tensor(fn.all_gather_into_tensor(
                x, world, dist.group.WORLD.group_name))
        torch.cuda.synchronize()
        res[case] = out.cpu().tolist()
    dist.destroy_process_group()
    return res


def j2_probe(card: str, faults: bool = False) -> None:
    """F7's probe: the cases that run on one pair of ranks; with
    ``faults`` also each case that kills its ranks, on a pair of its own,
    reported and not raised."""
    whole = [[float(c + 4 * i + 100 * r) for c in range(4)]
             for r in range(2) for i in range(2)]
    out = []
    runs = [J2_PROBE] + ([(c,) for c in J2_PROBE_FAULTS] if faults else [])
    with tempfile.TemporaryDirectory() as d:
        for cases in runs:
            try:
                res = spawn(j2_probe_rank, 2, (d, cases), deadline=120.0)
            except RuntimeError as e:
                require(faults and cases[0] in J2_PROBE_FAULTS,
                        f"J2 probe: the {cases} all-gathers on CUDA "
                        f"tensors failed: {e}")
                out.append(f"{cases[0]} FAILS ({e})")
                continue
            for case in cases:
                require(all(r[case] == whole for r in res), f"J2 probe: "
                        f"the {case} all-gather gave {res}")
                out.append(f"{case} runs")
    print(f"[pathJ] J2 probe, gloo all-gather of CUDA tensors on two ranks "
          f"sharing cuda:0, torch {torch.__version__}: " + "; ".join(out)
          + f"; {card}", flush=True)


def j2_collective(rank, world, d):
    """One rank of J2's check: a DTensor on a 1x2 mesh of gloo ranks
    sharing cuda:0, redistributed as each of J2_REDISTRIBUTIONS needs
    (Partial -> Replicate, Partial -> Shard, Shard(0) -> Shard(1), Shard
    -> Replicate)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.mesh import make_lm_mesh
    mesh = make_lm_mesh((1, 2), ("data", "model"), backend="gloo",
                        device="cuda:0", init_method=f"file://"
                        f"{os.path.join(d, 'redistribute')}", rank=rank,
                        timeout=J_TIMEOUT)
    x = torch.arange(16, dtype=torch.float32, device="cuda").reshape(4, 4) \
        + 100 * rank
    out = {}
    for kind in J2_REDISTRIBUTIONS:
        src, dst = {"all_reduce": (Partial(), Replicate()),
                    "reduce_scatter": (Partial(), Shard(0)),
                    "all_to_all": (Shard(0), Shard(1)),
                    "all_gather": (Shard(0), Replicate())}[kind]
        got = DTensor.from_local(x, mesh, [Replicate(), src],
                                 run_check=False).redistribute(
            mesh, [Replicate(), dst]).to_local()
        torch.cuda.synchronize()
        out[kind] = got.cpu().tolist()  # by value: a tensor travels by fd
    dist.destroy_process_group()
    return out


def path_j2_collectives(card: str) -> None:
    """J2 on the card: F7's probe, then every DTensor redistribution of
    the training meshes (all-reduce, reduce-scatter, all-to-all and the
    all-gather, which runs through ``route_gloo_cuda_all_gather``) on gloo
    ranks sharing cuda:0, each required to run and give the whole
    tensor's blocks."""
    j2_probe(card)
    x = [torch.arange(16, dtype=torch.float32).reshape(4, 4) + 100 * r
         for r in range(2)]
    whole = torch.cat(x, 0)                 # the Shard(0) tensor
    want = {"all_reduce": [x[0] + x[1]] * 2,
            "reduce_scatter": list(torch.chunk(x[0] + x[1], 2, 0)),
            "all_to_all": list(torch.chunk(whole, 2, 1)),
            "all_gather": [whole] * 2}
    with tempfile.TemporaryDirectory() as d:
        res = spawn(j2_collective, 2, (d,), deadline=120.0)
    for kind in J2_REDISTRIBUTIONS:
        require(all(torch.equal(torch.tensor(r[kind]), w)
                    for r, w in zip(res, want[kind])),
                f"J2: gloo's {kind} on CUDA tensors gave "
                f"{[r[kind] for r in res]}")
    print(f"[pathJ] J2 DTensor redistributions on gloo ranks sharing cuda:0, "
          f"torch {torch.__version__}: "
          + "; ".join(f"{k} runs" for k in J2_REDISTRIBUTIONS)
          + f" (the all-gather through the port's route); {card}",
          flush=True)


def j_steps(cfg, mesh, params, batches):
    """AdamW steps (J_OPT) of ``cfg`` on DTensors placed by the rules over
    ``mesh``, from the full ``params`` over ``batches`` (both moved to the
    mesh's device): (losses, final parameters gathered)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import PartitionSpec, set_mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    params = _tree.tree_map(lambda t: t.to(dev), params)
    batches = [_tree.tree_map(lambda t: t.to(dev), b) for b in batches]
    model = lm_models.build(cfg)
    p_spec = S.param_shardings(params, cfg, mesh)
    m_spec = S.optimizer_shardings(p_spec, params, mesh)
    o_spec = {"m": m_spec, "v": m_spec, "step": PartitionSpec()}
    b_spec = S.batch_shardings(mesh, "train", batches[0])
    step = lm_steps.make_train_step(model, AdamWConfig(**J_OPT),
                                    S.activation_rules(cfg, mesh),
                                    shardings=(mesh, p_spec, m_spec))
    opt = S.distribute(adamw_init(params), o_spec, mesh)
    params = S.distribute(params, p_spec, mesh)
    losses = []
    with set_mesh(mesh):
        for b in batches:
            params, opt, m = step(params, opt, S.distribute(b, b_spec, mesh))
            losses.append(float(m["loss"]))
    return losses, [S.full(x) for x in _tree.leaves(params)]


def j_plain_steps(cfg, params, batches):
    """The same steps on one rank, no mesh: (losses, final params)."""
    step = lm_steps.make_train_step(lm_models.build(cfg),
                                    AdamWConfig(**J_OPT))
    opt, losses = adamw_init(params), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, _tree.leaves(params)


def j_batches(cfg) -> list:
    stream = TokenStream(cfg.vocab, J2_SMOKE_B, J2_SMOKE_S)
    return [stream.batch_at(i) for i in range(J2_SMOKE_STEPS)]


def j2_host_rank(rank, world, d, shape, device: str, archs: tuple,
                 j3: bool) -> dict:
    """One gloo rank of J2's training cases: the smoke configs ``archs``
    on ``shape``, on the host (``device`` "cpu") or on cuda:0 shared by
    the ranks, rank 0 holding the final parameters against the one-rank
    run's; with ``j3`` on 2x1 also J3 (train() saved at step J2_CKPT,
    resharded onto 1x2 and onto one rank, continued to J2_STEPS)."""
    from repro_torch.launch.mesh import make_lm_mesh
    join = lambda sh: make_lm_mesh(
        sh, ("data", "model"), backend="gloo",
        device="cpu" if device == "cpu" else "cuda:0",
        init_method=f"file://{os.path.join(d, 'rendezvous')}", rank=rank,
        timeout=J_TIMEOUT)
    mesh = join(shape)
    out = {}
    for arch in archs:
        cfg = j_smoke_config(arch)
        params = lm_models.build(cfg).init(0, device="cpu")
        t0 = time.perf_counter()
        losses, got = j_steps(cfg, mesh, params, j_batches(cfg))
        err = None
        if rank == 0:
            err = leaf_errs(got, torch.load(os.path.join(d, f"{arch}.pt")))
        out[arch] = dict(losses=losses, err=err,
                         s=time.perf_counter() - t0)
    if j3 and shape == (2, 1):
        out["j3"] = j3_runs(rank, d, join, device)
    dist.destroy_process_group()
    return out


def j3_runs(rank, d, join, device: str = "cpu") -> dict:
    """J3: train() on 2x1 saving at step J2_CKPT; ``launch.elastic.
    reshard`` of that checkpoint onto 1x2, and train() continuing from it
    on 1x2 and on one rank without a mesh (rank 0) to step J2_STEPS; the
    uninterrupted 2x1 run's losses. ``device``: "cpu", or "cuda" (the
    ranks share cuda:0)."""
    from repro_torch.launch.elastic import reshard
    cfg = j_smoke_config(I_ARCH)
    runs = {}

    def run(name, **kw):
        losses = runs.setdefault(name, [])
        lm_train.train(lm_train.TrainConfig(**(dict(
            arch=I_ARCH, batch=J2_SMOKE_B, seq=J2_SMOKE_S,
            log_every=10 ** 6, dist_backend="gloo", device=device) | kw)),
            model_cfg=cfg, hooks={"on_step": lambda s, m: losses.append(
                (s, float(m["loss"])))})

    ck = os.path.join(d, "ckpt")
    run("first", mesh="2x1", steps=J2_CKPT + 1, ckpt_dir=ck,
        ckpt_every=J2_CKPT)
    run("full", mesh="2x1", steps=J2_STEPS)
    dist.barrier()
    if rank == 0:
        shutil.copytree(ck, ck + "_one")
    mesh = join((1, 2))
    params, _, step = reshard(ck, I_ARCH, mesh, model_cfg=cfg)
    tok = params["embed"]["tok"]
    runs["resharded"] = (step, tuple(tok.to_local().shape),
                         str(tok.placements))
    run("grown", mesh="1x2", steps=J2_STEPS, ckpt_dir=ck, ckpt_every=10 ** 6)
    if rank == 0:
        run("single", mesh="", steps=J2_STEPS, ckpt_dir=ck + "_one",
            ckpt_every=10 ** 6)
    dist.barrier()
    return runs


def j3_check(j3: dict, where_tag: str) -> None:
    full = dict(j3["full"])
    for name, where in (("grown", "1x2"), ("single", "one rank")):
        got = dict(j3[name])
        require(sorted(got) == list(range(J2_CKPT + 1, J2_STEPS)),
                f"J3 {where_tag} {where}: resumed at steps {sorted(got)}")
        rel = max(abs(got[s] - full[s]) / abs(full[s]) for s in got)
        require(rel <= 1e-5, f"J3 {where_tag} {where}: losses {got} against "
                f"the uninterrupted {full} (rel {rel:.3e})")
        print(f"[pathJ] J3 {where_tag} {I_ARCH} smoke f32: the 2x1 train() "
              f"run's step-{J2_CKPT} checkpoint resharded onto {where} (tok "
              f"{j3['resharded'][1]} {j3['resharded'][2]} a rank on 1x2) "
              f"continues at steps {sorted(got)} with losses "
              + " ".join(f"{got[s]:.6f}" for s in sorted(got))
              + f", within {rel:.2e} relative of the uninterrupted run's",
              flush=True)


def path_j2_card(card: str) -> None:
    """J2 and J3 on the card: smoke internlm2 training on 1x2 (TP) and
    2x1 (ZeRO-1) meshes of gloo ranks sharing cuda:0 against one rank on
    the card, and the elastic reshard there (what F7 kept out before)."""
    t0 = time.perf_counter()
    cfg = j_smoke_config(I_ARCH)
    with tempfile.TemporaryDirectory() as d:
        params = _tree.tree_map(lambda t: t.cuda(), lm_models.build(
            cfg).init(0, device="cpu"))
        batches = [_tree.tree_map(lambda t: t.cuda(), b)
                   for b in j_batches(cfg)]
        ref, ref_p = j_plain_steps(cfg, params, batches)
        torch.save([x.cpu() for x in ref_p], os.path.join(d, f"{I_ARCH}.pt"))
        del params, batches, ref_p
        res = {}
        for shape in ((1, 2), (2, 1)):
            res[shape] = spawn(j2_host_rank, 2, (d, shape, "cuda",
                                                 (I_ARCH,), True),
                               deadline=J_DEADLINE)
            os.remove(os.path.join(d, "rendezvous"))
    kinds = {(1, 2): "TP", (2, 1): "ZeRO-1"}
    for shape, r in res.items():
        r0 = r[0][I_ARCH]
        verdict = j_check(f"J2 card {shape} {I_ARCH}", r0["losses"], ref,
                          r0["err"])
        require(all(x[I_ARCH]["losses"] == r0["losses"] for x in r),
                f"J2 card {shape}: the ranks' losses differ")
        print(f"[pathJ] J2 card mesh {shape[0]}x{shape[1]} ({kinds[shape]}), "
              f"2 gloo ranks sharing cuda:0, {I_ARCH} smoke f32, "
              f"{J2_SMOKE_STEPS} AdamW steps (eps 1e-3): against one rank "
              f"on the card: {verdict}; {r0['s']:.1f} s", flush=True)
    j3_check(res[(2, 1)][0]["j3"], "card (2 gloo ranks sharing cuda:0)")
    print(f"[pathJ] J2 and J3 on the card {time.perf_counter() - t0:.1f} s "
          f"in all; {card}", flush=True)


# J2 on the host's gloo CPU ranks: smoke internlm2 on 1x2 and 2x1 and
# J3 run on the card's shared ranks (path_j2_card), so the host keeps the
# 2x2 mesh, whose TP and data axes hold every config's rules that 1x2 and
# 2x1 hold one at a time
J2_HOST = {(2, 2): J2_SMOKE}


def path_j2_host(card: str) -> None:
    """J2 on gloo CPU ranks of the card's host (the card's torch): the
    smoke configs of internlm2 (dense), grok-1 (expert-inner TP) and
    deepseek-v3 (EP) on 2x2, against one rank."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        refs = {}
        for arch in J2_SMOKE:
            cfg = j_smoke_config(arch)
            refs[arch], ref_p = j_plain_steps(
                cfg, lm_models.build(cfg).init(0, device="cpu"),
                j_batches(cfg))
            torch.save(ref_p, os.path.join(d, f"{arch}.pt"))
        res = {}
        for shape, archs in J2_HOST.items():
            res[shape] = spawn(j2_host_rank, shape[0] * shape[1],
                               (d, shape, "cpu", archs, False),
                               deadline=J_DEADLINE)
            os.remove(os.path.join(d, "rendezvous"))
    kinds = {"internlm2-1.8b": "dense", "grok-1-314b":
             "expert-inner TP, 3 experts", "deepseek-v3-671b": "EP"}
    for shape, r in res.items():
        for arch in J2_HOST[shape]:
            r0 = r[0][arch]
            verdict = j_check(f"J2 host {shape} {arch}", r0["losses"],
                              refs[arch], r0["err"])
            require(all(x[arch]["losses"] == r0["losses"] for x in r),
                    f"J2 host {shape} {arch}: the ranks' losses differ")
            print(f"[pathJ] J2 host mesh {shape[0]}x{shape[1]}, "
                  f"{shape[0] * shape[1]} gloo CPU ranks, {arch} smoke f32 "
                  f"({kinds[arch]}), {J2_SMOKE_STEPS} AdamW steps (eps "
                  f"1e-3): against one rank: {verdict}; {r0['s']:.1f} s",
                  flush=True)
    print(f"[pathJ] J2 on the host's gloo CPU ranks "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)


_J4_OWN_CELL = r"""
import json, sys, time
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(sys.argv[1], "j1", multi_pod=False, mesh=mesh,
                      spec=ShapeSpec("j1", int(sys.argv[3]),
                                     int(sys.argv[2]), "train"))
print(json.dumps(rec))
"""


def path_j4(card: str, j1_peak: float) -> None:
    """J4: the dry run's cells at full published sizes (16 x 16, and
    2 x 16 x 16 for deepseek-v3's decode), each in a process of its own
    (a fake group is its process's default group), all started together;
    then the dry run of J1's own cell on a fake 1 x 1 mesh, its live bytes
    held to J1's measured peak (``j1_peak``, GiB) within J4_LIVE_BAND.
    Needs no card."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for i, (arch, shape, mp) in enumerate(J4_CELLS):
            out = os.path.join(d, f"{i}.jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--multi-pod",
                   "on" if mp else "off", "--out", out]
            procs.append((arch, shape, out, time.perf_counter(),
                          subprocess.Popen(cmd, env=env, cwd=ROOT,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
        own = subprocess.Popen(
            [sys.executable, "-c", _J4_OWN_CELL, I_ARCH, str(I1_BATCH),
             str(I1_SEQ)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for arch, shape, out, t_start, p in procs:
            try:
                stdout, stderr = p.communicate(
                    timeout=max(J4_DEADLINE - (time.perf_counter() - t_start),
                                1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                require(False, f"J4 {arch} x {shape}: past its "
                        f"{J4_DEADLINE:.0f} s deadline")
            require(p.returncode == 0 and os.path.exists(out),
                    f"J4 {arch} x {shape}: the dry run failed: "
                    f"{stderr[-2000:]}")
            with open(out) as f:
                rec = json.loads(f.readlines()[-1])
            require(rec.get("ok") and not rec.get("skipped"),
                    f"J4 {arch} x {shape}: {rec}")
            m, r = rec["memory"], rec["roofline"]
            coll = ", ".join(f"{k} {v / 2 ** 20:.1f} MiB" for k, v in
                             sorted(rec["collective_bytes_by_kind"].items()))
            print(f"[pathJ] J4 dry run {arch} x {shape} on {rec['mesh']} "
                  f"({rec['n_devices']} fake ranks): per device arguments "
                  f"{m['argument_bytes'] / 2 ** 30:.3f} GiB, live "
                  f"{m['live_bytes'] / 2 ** 30:.3f} GiB, product FLOPs "
                  f"{r['flops']:.4e} ({rec['precision']}), useful_ratio "
                  f"{r['useful_ratio']:.4f} (model FLOPs "
                  f"{r['model_flops']:.4e}), collective link bytes "
                  f"{coll or 'none'}"
                  f" ({json.dumps(rec['collective_counts'])}); roofline "
                  f"modeled from the H100 SXM data sheet: compute "
                  f"{r['compute_s'] * 1e3:.3f} ms, memory "
                  f"{r['memory_s'] * 1e3:.3f} ms, collective "
                  f"{r['collective_s'] * 1e3:.3f} ms, {r['dominant']}-bound;"
                  f" the cell {rec['lower_s'] + rec['compile_s']:.1f} s in "
                  f"its process on the host's CPU (deadline "
                  f"{J4_DEADLINE:.0f} s)", flush=True)
        stdout, stderr = own.communicate(timeout=J4_DEADLINE)
        require(own.returncode == 0, f"J4 J1's cell: {stderr[-2000:]}")
        rec = json.loads(stdout.strip().splitlines()[-1])
        m = rec["memory"]
        ratio = m["live_bytes"] / 2 ** 30 / j1_peak
        print(f"[pathJ] J4 dry run of J1's cell ({I_ARCH}, batch {I1_BATCH} "
              f"x {I1_SEQ}, 1x1): live {m['live_bytes'] / 2 ** 30:.2f} GiB "
              f"estimated (arguments {m['argument_bytes'] / 2 ** 30:.2f}, "
              f"temp {m['temp_bytes'] / 2 ** 30:.2f}, alias "
              f"{m['alias_bytes'] / 2 ** 30:.2f}) against J1's measured peak "
              f"{j1_peak:.2f} GiB (torch.cuda.max_memory_allocated, what "
              f"was allocated before J1 taken out; ratio {ratio:.3f}, band "
              f"{J4_LIVE_BAND[0]:.2f}-{J4_LIVE_BAND[1]:.2f}); {card}",
              flush=True)
        require(J4_LIVE_BAND[0] <= ratio <= J4_LIVE_BAND[1],
                f"J4: J1's cell estimated at {ratio:.3f} of J1's measured "
                f"peak, outside {J4_LIVE_BAND}")
    print(f"[pathJ] J4 {time.perf_counter() - t0:.1f} s in all", flush=True)


def path_j(device, card: str, i1: dict) -> None:
    t0 = time.perf_counter()
    reset_launch_counts()
    j1_peak = path_j1(device, card, i1)
    i1.clear()
    torch.cuda.empty_cache()
    path_j2_collectives(card)
    path_j2_card(card)
    counts = launch_counts()
    path_j2_host(card)
    path_j4(card, j1_peak)
    print(f"[pathJ] launches over path J {json.dumps(counts)} (no GNN "
          f"kernel; flash attention takes J1's bf16 attention, AdamW's "
          f"kernels the DTensor steps' blocks); "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)
    require(not any(counts[k] for k in KERNELS),
            "path J launched a GNN kernel")
    require(all(counts[k] for k in ADAMW_KERNELS),
            "path J's DTensor steps launched no AdamW kernel")


# ------------------------------------------------------------------ path K

# the two sequence-scan kernels (kernels.recurrence) on the recurrent
# architectures at full published widths: K1 train() on rwkv6-3b (I1's
# batch), K2 recurrentgemma-9b's prefill of 4,096 tokens and Server
# decode, K3 each scan, forward and backward, against its plain version;
# then the reference's last gnn_serve demos as subprocesses.
SCAN_KERNELS = {   # name -> (source, the reference's scan it replaces)
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                   "src/repro/models/recurrent.py:91"),
    "wkv6_scan": ("src/repro_torch/csrc/wkv6_scan.cu",
                  "src/repro/models/recurrent.py:151"),
}
FLASH_KERNELS = ("flash_attention_forward", "flash_attention_backward")
ADAMW_KERNELS = ("adamw_norm", "adamw_update")
ALL_KERNELS = (*KERNELS, *SCAN_KERNELS, *FLASH_KERNELS, *ADAMW_KERNELS)
K1_ARCH, K2_ARCH = "rwkv6-3b", "recurrentgemma-9b"
K1_BATCH, K1_SEQ, K1_STEPS, K1_LR = I1_BATCH, I1_SEQ, 6, I1_LR
K2_SEQ, K2_SLOTS, K2_CAPACITY, K2_NEW = 4096, 4, 64, 8
# K3's shapes: (B, S, W) and (B, S, H, Dh); the first of each is the main
# path's (K2's RG-LRU layer, K1's RWKV layer), the others the smoke
# configs' (I3), a one-step decode from a state, and lengths that end in
# a part of a tile (RG-LRU: 16 steps) or of a chunk and its 4-step piece
# (RWKV: 16 steps, pieces of 4); the RG-LRU also on ragged widths, one a
# multiple of 4 and one not (padded to one by the wrapper)
K3_RGLRU = ((1, K2_SEQ, 4096), (2, 16, 64), (4, 1, 4096), (3, 37, 100),
            (2, 19, 70))
K3_WKV6 = ((K1_BATCH, K1_SEQ, 40, 64), (2, 16, 4, 16), (2, 40, 4, 32),
           (K1_BATCH, 1, 40, 64), (2, 23, 4, 64))
GDN_DEMOS = (("--stream", "12"), ("--buckets", "auto"), ("--tech",))


def scan_bound(nbytes: int, flops: float) -> tuple:
    """(bound ms, what bounds it): bytes over 3.35 TB/s against f32
    operations over 67 TFLOP/s (H100 SXM data sheet), the larger."""
    t_b, t_f = nbytes / HBM_BPS, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def k3_inputs(kind: str, shape: tuple, nonzero: bool, seed: int) -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    if kind == "rglru":
        b, s, w = shape
        a = torch.rand((b, s, w), generator=gen, device="cuda")
        h0 = rnd(b, w) if nonzero else torch.zeros((b, w), device="cuda")
        return a, rnd(b, s, w), h0
    b, s, h, d = shape
    w = torch.exp(-torch.exp(rnd(b, s, h, d) - 2.0))
    s0 = rnd(b, h, d, d) if nonzero else torch.zeros((b, h, d, d),
                                                     device="cuda")
    return rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d), w, \
        rnd(h, d) * 0.5, s0


def grad_errs(kernel, plain, xs: tuple, seed: int) -> list:
    """max|g - g_ref| / max|g_ref| of every input's gradient: the kernel's
    backward against autograd through the plain loop on the card, under
    random cotangents of every output."""
    outs, grads = [], []
    for fn in (kernel, plain):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        out = fn(*leaves)
        out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        loss = sum((o * torch.randn(o.shape, generator=gen, device="cuda")
                    ).sum() for o in out)
        grads.append(torch.autograd.grad(loss, leaves))
        outs.append(out)
    return [float((g - r).abs().max()) / (float(r.abs().max()) or 1.0)
            for g, r in zip(*grads)]


def k3_backward(kind: str, xs: tuple, seed: int) -> tuple:
    """The backward op's inputs at ``xs`` (the forward run with its
    checkpoints) and a call of it: (fn, the forward's outputs)."""
    from repro_torch.kernels.recurrence import ops as rec_ops
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "rglru":
        a, g, h0 = xs
        with torch.no_grad():
            h = torch.ops.repro_torch.rglru_scan(a, g, h0)
        dy = torch.randn(h.shape, generator=gen, device="cuda")
        return (lambda: torch.ops.repro_torch.rglru_scan_backward(
            a, h, h0, dy)), (h,)
    with torch.no_grad():
        out = torch.ops.repro_torch.wkv6_scan(*xs, rec_ops.CHUNK)
    r, k, v, w, u, _ = xs
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    ds = torch.randn(out[1].shape, generator=gen, device="cuda")
    return (lambda: torch.ops.repro_torch.wkv6_scan_backward(
        r, k, v, w, u, out[2], dy, ds, rec_ops.CHUNK)), out


def same_twice(fn) -> bool:
    """Two launches of ``fn`` give equal outputs (``torch.equal``)."""
    one, two = fn(), fn()
    one = (one,) if isinstance(one, torch.Tensor) else tuple(one)
    two = (two,) if isinstance(two, torch.Tensor) else tuple(two)
    return all(torch.equal(x, y) for x, y in zip(one, two))


def off_by_4_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous view ``flat[1:]`` of a flat buffer: its base
    sits 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].view(t.shape)
    require(view.data_ptr() % 16 == 4, "K3: the offset view is aligned")
    return view


def k3_offset_states() -> float:
    """F8: ``wkv6_scan`` with S0, and its backward with dS, at a 4-byte
    offset (the kernels read both with float4 loads; the wrappers hand
    them an aligned copy). The forward's final state equal to the plain
    loop's and y within K3's tolerance; both launches' outputs equal bit
    for bit to the same launches on aligned states, the gradients within
    1e-4 of the plain backward loop's max|g|. Returns y's max|err|."""
    from repro_torch.kernels.recurrence import (wkv6_scan_backward_ref,
                                                wkv6_scan_ref)
    from repro_torch.kernels.recurrence import ops as rec_ops
    shape = K3_WKV6[4]
    r, k, v, w, u, s0 = k3_inputs("wkv6", shape, True, 8)
    gen = torch.Generator(device="cuda").manual_seed(9)
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    ds = torch.randn(s0.shape, generator=gen, device="cuda")
    scan = lambda s: torch.ops.repro_torch.wkv6_scan(r, k, v, w, u, s,
                                                     rec_ops.CHUNK)
    with torch.no_grad():
        (y, st, ck), aligned = scan(off_by_4_bytes(s0)), scan(s0)
        yr, sr, _ = wkv6_scan_ref(r, k, v, w, u, s0, rec_ops.CHUNK)
        back = lambda d: torch.ops.repro_torch.wkv6_scan_backward(
            r, k, v, w, u, aligned[2], dy, d, rec_ops.CHUNK)
        grads, grads_aligned = back(off_by_4_bytes(ds)), back(ds)
        plain = wkv6_scan_backward_ref(r, k, v, w, u, s0, dy, ds)
    y_err = float((y - yr).abs().max())
    require(torch.equal(st, sr) and all(torch.equal(a, b) for a, b in zip(
        (y, st, ck), aligned)), f"K3 wkv6_scan {shape}, S0 at a 4-byte "
        f"offset: final state off the plain loop by "
        f"{float((st - sr).abs().max())}, or the outputs differ from the "
        f"aligned launch's")
    require(bool(((y - yr).abs() <= 1e-5 * yr.abs() + 1e-5 * float(
        yr.abs().max())).all()), f"K3 wkv6_scan {shape}, S0 at a 4-byte "
        f"offset: y off by {y_err}")
    g = [float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
         for a, b in zip(grads, plain)]
    require(all(torch.equal(a, b) for a, b in zip(grads, grads_aligned))
            and max(g) <= 1e-4, f"K3 wkv6_scan backward {shape}, dS at a "
            f"4-byte offset: gradients off the aligned launch's, or off the "
            f"plain loop by {g} of max|g|")
    print(f"[pathK] K3 wkv6_scan {shape}, S0 at a 4-byte offset (F8): final "
          f"state equal to the plain loop bit for bit, y within {y_err:.3e}, "
          f"y, state and checkpoints equal bit for bit to the launch on the "
          f"aligned S0; backward with dS at a 4-byte offset: (dr, dk, dv, "
          f"dw, du, dS0) equal bit for bit to the launch on the aligned dS, "
          f"within " + ", ".join(f"{e:.2e}" for e in g) + " of the plain "
          f"loop's max|g| (tol 1e-4)", flush=True)
    return y_err


def path_k3(card: str) -> dict:
    """K3: each scan kernel against its plain version (``kernels.
    recurrence.ref``) on the card: ``rglru_scan``'s states and
    ``wkv6_scan``'s final state ``torch.equal``, ``wkv6_scan``'s y within
    rtol 1e-5 and atol 1e-5 * max|ref|, every gradient within 1e-4 of its
    max|g_ref|, from a zero and a nonzero initial state, at K3's shapes;
    two launches of each kernel, forward and backward, equal; then each
    kernel timed at the main path's shape (CUDA events), forward and
    backward apart, beside its plain version and its bound. Returns
    {kernel: its record}."""
    from repro_torch.kernels.recurrence import (rglru_scan, rglru_scan_ref,
                                                wkv6_scan, wkv6_scan_ref)
    from repro_torch.kernels.recurrence import ops as rec_ops
    t0 = time.perf_counter()
    plain_wkv6 = lambda *x: wkv6_scan_ref(*x)[:2]
    errs = {"rglru_scan": 0.0, "wkv6_scan": 0.0}
    for shape in K3_RGLRU:
        for nonzero in (False, True):
            xs = k3_inputs("rglru", shape, nonzero, 1)
            with torch.no_grad():
                got, ref = rglru_scan(*xs), rglru_scan_ref(*xs)
            require(torch.equal(got, ref), f"K3 rglru_scan {shape} h0 "
                    f"{'nonzero' if nonzero else 'zero'}: off the plain loop "
                    f"by {float((got - ref).abs().max())}")
            g = grad_errs(rglru_scan, rglru_scan_ref, xs, 2)
            require(max(g) <= 1e-4, f"K3 rglru_scan {shape}: gradients off "
                    f"by {g} of max|g_ref|")
            bwd, _ = k3_backward("rglru", xs, 6)
            with torch.no_grad():
                twice = same_twice(lambda: rglru_scan(*xs)) and same_twice(bwd)
            require(twice, f"K3 rglru_scan {shape}: two launches differ")
            print(f"[pathK] K3 rglru_scan {shape} h0 "
                  f"{'nonzero' if nonzero else 'zero'}: states equal to the "
                  f"plain loop bit for bit; gradients (a, g, h0) within "
                  + ", ".join(f"{e:.2e}" for e in g)
                  + " of max|g_ref| (tol 1e-4); two launches equal, forward "
                  "and backward", flush=True)
    for shape in K3_WKV6:
        for nonzero in (False, True):
            xs = k3_inputs("wkv6", shape, nonzero, 3)
            with torch.no_grad():
                (y, st), (yr, sr, _) = wkv6_scan(*xs), wkv6_scan_ref(*xs)
            top = float(yr.abs().max())
            y_err = float((y - yr).abs().max())
            require(torch.equal(st, sr), f"K3 wkv6_scan {shape}: final state "
                    f"off the plain loop by {float((st - sr).abs().max())}")
            require(bool(((y - yr).abs() <= 1e-5 * yr.abs() + 1e-5 * top)
                         .all()), f"K3 wkv6_scan {shape}: y off by {y_err}")
            errs["wkv6_scan"] = max(errs["wkv6_scan"], y_err)
            g = grad_errs(wkv6_scan, plain_wkv6, xs, 4)
            require(max(g) <= 1e-4, f"K3 wkv6_scan {shape}: gradients off "
                    f"by {g} of max|g_ref|")
            bwd, _ = k3_backward("wkv6", xs, 6)
            with torch.no_grad():
                twice = (same_twice(lambda: torch.ops.repro_torch.wkv6_scan(
                    *xs, rec_ops.CHUNK)) and same_twice(bwd))
            require(twice, f"K3 wkv6_scan {shape}: two launches differ")
            print(f"[pathK] K3 wkv6_scan {shape} S0 "
                  f"{'nonzero' if nonzero else 'zero'}: final state equal to "
                  f"the plain loop bit for bit, y within {y_err:.3e} (max|y| "
                  f"{top:.3e}; tol rtol 1e-5 + 1e-5 max|y|); gradients (r, "
                  f"k, v, w, u, S0) within " + ", ".join(f"{e:.2e}" for e in g)
                  + " of max|g_ref| (tol 1e-4); two launches equal, forward "
                  "and backward", flush=True)
    errs["wkv6_scan"] = max(errs["wkv6_scan"], k3_offset_states())
    b, _, h, d = K3_WKV6[0]
    res = rec_ops.wkv6_residency(b, h, d)
    print(f"[pathK] K3 wkv6_scan at B {b}, H {h}, Dh {d}: {res['blocks']} "
          f"blocks; the card holds {res['forward_blocks_per_sm']} forward "
          f"and {res['backward_blocks_per_sm']} backward blocks an SM "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs), {res['backward_clusters_at_once']} backward clusters of "
          f"{res['cluster_size']} at once ({res['clusters']} in a launch)",
          flush=True)

    # times at the main path's shapes: the forward alone (no checkpoints),
    # the backward op alone, and the two under autograd
    rec = {}
    for name, kind, shape, kern, plain in (
            ("rglru_scan", "rglru", K3_RGLRU[0], rglru_scan, rglru_scan_ref),
            ("wkv6_scan", "wkv6", K3_WKV6[0], wkv6_scan, plain_wkv6)):
        xs = k3_inputs(kind, shape, False, 5)
        with torch.no_grad():
            ms = cuda_ms(lambda: kern(*xs), 20)
            plain_ms = cuda_ms(lambda: plain(*xs), 2)
            bwd, _ = k3_backward(kind, xs, 7)
            ms_bwd = cuda_ms(bwd, 20)
            # the forward as a gradient runs it: with its checkpoints
            ms_saving = ms if kind == "rglru" else cuda_ms(
                lambda: torch.ops.repro_torch.wkv6_scan(*xs, rec_ops.CHUNK),
                20)
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]

        def train_call(fn):
            out = fn(*leaves)
            out = out if isinstance(out, torch.Tensor) else out[0]
            out.sum().backward()
        ms_train = cuda_ms(lambda: train_call(kern), 5)
        plain_train = cuda_ms(lambda: train_call(plain), 1)
        n = math.prod(shape)
        if kind == "rglru":
            b, s, w = shape
            nbytes = 4 * (3 * n + b * w)           # a, g, h0 in; h out
            flops = 2.0 * n                        # a multiply, an add
            bwd_bytes = 4 * (5 * n + 2 * b * w)    # a, h, h0, dy; da, dg, dh0
            bwd_flops = 3.0 * n
            ckpt_bytes = 0
        else:
            b, s, h, d = shape
            # r, k, v, w, u, S0 in; y, S out. Per state element a step:
            # r^T S (2) and w S + k v (3); per key element a step the
            # bonus v sum(r u k): r u k (2), its sum (1), v times it and
            # the add to y (2)
            nbytes = 4 * (5 * n + h * d + 2 * b * h * d * d)
            flops = 5.0 * n * d + 5.0 * n
            # the states the forward saves every CHUNK steps for the
            # backward: this design's traffic, written by the forward and
            # read by the backward, printed apart and not in the bounds,
            # which count what the function needs
            ckpt_bytes = 4 * b * h * (-(-s // rec_ops.CHUNK)) * d * d
            # r, k, v, w, u, S0, dy, dS in; dr, dk, dv, dw, du, dS0 out.
            # Per state element a step: the recomputed state w S + k v
            # (3), S dy, G v, G^T k and rowsum(G S) (2 each), G's update
            # w G + r dy^T (3); per key element a step the bonus terms:
            # v . dy (2), dr's u k (v . dy) (3), dk's u r (v . dy) (3),
            # dv's sum(r u k) and dy times it (5), du's r k (v . dy) (3)
            bwd_bytes = 4 * (9 * n + 2 * h * d + 3 * b * h * d * d)
            bwd_flops = 14.0 * n * d + 16.0 * n
        bound_ms, bound_by = scan_bound(nbytes, flops)
        bwd_bound, bwd_by = scan_bound(bwd_bytes, bwd_flops)
        train_bound, train_by = scan_bound(nbytes + bwd_bytes,
                                           flops + bwd_flops)
        ckpt = (f"; the design's checkpoints (every {rec_ops.CHUNK} steps) "
                f"{ckpt_bytes / 1e6:.1f} MB, written by the forward and "
                f"read by the backward, {2e3 * ckpt_bytes / HBM_BPS:.4f} ms "
                f"at the memory rate, not in the bounds" if ckpt_bytes
                else "")
        rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        print(f"[pathK] K3 {name} at {shape}: forward {ms:.4f} ms a launch "
              f"(CUDA events, mean of 20), plain loop {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP); backward {ms_bwd:.4f} ms a launch "
              f"(mean of 20), bound {bwd_bound:.4f} ms ({bwd_by}: "
              f"{bwd_bytes / 1e6:.1f} MB, {bwd_flops / 1e9:.3f} GFLOP); "
              f"forward with its checkpoints + backward {ms_saving:.4f} + "
              f"{ms_bwd:.4f} = {ms_saving + ms_bwd:.4f} ms of kernel time "
              f"(bound {train_bound:.4f} ms, {train_by}){ckpt}; under "
              f"autograd, "
              f"the host's dispatch included, {ms_train:.4f} ms (mean of 5; "
              f"the plain loop under autograd {plain_train:.3f} ms); no "
              f"single library call computes it; {card}", flush=True)
    for name, e in errs.items():
        rec[name]["max_abs_err"] = e
    print(f"[pathK] K3 {time.perf_counter() - t0:.1f} s in all", flush=True)
    return rec


@contextlib.contextmanager
def plain_scans():
    """The models' scans swapped for their plain versions (the loops on
    the card), for K's one-to-one comparisons; the package has no switch
    for it."""
    from repro_torch.kernels.recurrence import rglru_scan_ref, wkv6_scan_ref
    from repro_torch.models import recurrent as rec
    saved = rec.rglru_scan, rec.wkv6_scan
    rec.rglru_scan = lambda a, g, h0=None: rglru_scan_ref(
        a, g, torch.zeros_like(a[:, 0]) if h0 is None else h0)
    rec.wkv6_scan = lambda *x: wkv6_scan_ref(*x)[:2]
    try:
        yield
    finally:
        rec.rglru_scan, rec.wkv6_scan = saved


def k1_layer(device, card: str) -> None:
    """One rwkv_mixer layer of rwkv6-3b at K1's batch, forward and
    backward, with the kernel and with the plain loop (the "before"): ms
    (median of 3 after one) and the peak bytes above what was held."""
    from repro_torch.models import recurrent as rec
    cfg = lm_configs.get_config(K1_ARCH)
    params = rec.init_rwkv(lm_common.InitKey.from_seed(0, device), cfg)
    for p in params.values():
        p.requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((K1_BATCH, K1_SEQ, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16).requires_grad_(True)

    def step():
        rec.rwkv_mixer(params, x, cfg).float().sum().backward()

    out = []
    for label, ctx in (("kernel", contextlib.nullcontext), ("plain loop",
                                                          plain_scans)):
        with ctx():
            step()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - held
        out.append(f"{label} {median_ms(times):.3f} ms, peak "
                   f"{peak / 2 ** 30:.3f} GiB")
    print(f"[pathK] K1 one rwkv_mixer layer of {K1_ARCH} (d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}) on [{K1_BATCH}, {K1_SEQ}], forward and "
          f"backward (host clock between syncs, median of 3 after one; peak "
          f"above what was held): " + "; ".join(out) + f"; {card}",
          flush=True)
    del params, x
    torch.cuda.empty_cache()


# the caching allocator's counts read around each K1 step: retries after
# a refused cudaMalloc (each frees the cached blocks and synchronizes),
# device allocations and frees, and syncs of all streams
K1_ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free",
            "num_sync_all_streams")


def alloc_counts() -> np.ndarray:
    stats = torch.cuda.memory_stats()
    return np.array([int(stats.get(k, 0)) for k in K1_ALLOC])


def k1_config(device) -> "lm_train.TrainConfig":
    return lm_train.TrainConfig(
        arch=K1_ARCH, smoke=False, steps=K1_STEPS, batch=K1_BATCH,
        seq=K1_SEQ, lr=K1_LR, log_every=K1_STEPS, device=str(device))


def k1_step_trace(events: list) -> dict | None:
    """A profiled K1 step's chrome-trace events: its kernels and their ms,
    the ``wkv6_*`` kernels' ms, the device's idle ms between its first and
    last kernel, and the CUDA API calls that held the host longest (None
    when the trace holds no kernel)."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    if not kernels:
        return None
    idle, end = 0.0, kernels[0]["ts"]
    for e in kernels:
        idle += max(0.0, e["ts"] - end)
        end = max(end, e["ts"] + e["dur"])
    api: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            api[e["name"]] = api.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    scans = [float(e["dur"]) for e in kernels
             if kernel_name(e["name"]).startswith("wkv6_")]
    return dict(kernels=len(kernels),
                busy=sum(float(e["dur"]) for e in kernels) / 1e3,
                scans=len(scans), scans_ms=sum(scans) / 1e3,
                idle=idle / 1e3,
                api=sorted(api.items(), key=lambda kv: -kv[1])[:3])


def k1_profiled(device, card: str) -> None:
    """``train()`` at K1 again, each step after the first under a
    torch.profiler of its own, started after the previous step's sync:
    its host ms (profiler on), kernel ms, the device's idle ms between
    kernels, the scans' ms and the CUDA API calls that held the host
    longest. The median step's chrome trace is kept as
    ``chiprun_out/step_K1_train.json``."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "chiprun_out", "step_K1_train.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows, live = [], {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        if step > 0:
            wall = (time.perf_counter() - live["t0"]) * 1e3
            live["prof"].stop()
            part = f"{path}.{step}"
            live["prof"].export_chrome_trace(part)
            with open(part) as fh:
                row = k1_step_trace(json.load(fh)["traceEvents"])
            rows.append((step, wall, row, part))
        if step < K1_STEPS - 1:
            live["prof"] = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
            live["prof"].start()
            live["t0"] = time.perf_counter()

    t0 = time.perf_counter()
    lm_train.train(k1_config(device), hooks={"on_step": on_step})
    torch.cuda.empty_cache()
    traced = sorted((r for r in rows if r[2] is not None),
                    key=lambda r: r[1])
    if traced:
        os.replace(traced[len(traced) // 2][3], path)
    for r in rows:
        if os.path.exists(r[3]):
            os.remove(r[3])
    text = []
    for step, wall, row, _ in rows:
        if row is None:
            text.append(f"step {step} {wall:.1f} ms, kernel time not "
                        f"measured (no kernel in its trace)")
            continue
        text.append(
            f"step {step} {wall:.1f} ms: {row['kernels']} kernels "
            f"{row['busy']:.1f} ms, device idle between kernels "
            f"{row['idle']:.1f} ms, wkv6_* {row['scans']} launches "
            f"{row['scans_ms']:.2f} ms; host in "
            + ", ".join(f"{k} {v:.1f}" for k, v in row["api"]))
    print(f"[pathK] K1 train() again, steps 1-{K1_STEPS - 1} each under "
          f"torch.profiler (host clock from the profiler's start to the "
          f"step's sync): " + "; ".join(text)
          + (f"; trace of the median step chiprun_out/"
             f"{os.path.basename(path)}" if traced else "")
          + f"; {time.perf_counter() - t0:.1f} s; {card}", flush=True)


def path_k1(device, card: str) -> dict:
    """K1: ``launch.train.train`` on rwkv6-3b at its full published size
    and I1's batch and lr: AdamW steps with finite losses, the
    loss on the batches trained on lower at the final weights than at the
    initial ones, ms a step (each step's and their median after the
    first) and the allocator's counts over each step, tokens/s, peak
    memory; train() again with each step profiled (``k1_profiled``) and
    one step of ``make_train_step`` alone profiled (the scans' share of
    the kernel time); then one layer with the kernel and with the plain
    loop. Returns the scans' launches in the first train()."""
    mcfg = lm_configs.get_config(K1_ARCH)
    torch.cuda.reset_peak_memory_stats()
    stamps, losses, allocs = [], [], []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        allocs.append(alloc_counts())
        losses.append(float(metrics["loss"]))

    t0 = time.perf_counter()
    final = {}
    reset_launch_counts()
    reset_update_paths()
    out = lm_train.train(k1_config(device), hooks={
        "on_step": on_step, "on_end": lambda p, o: final.update(params=p)})
    torch.cuda.synchronize()
    counts = launch_counts()
    require(update_paths() == {"kernel": K1_STEPS, "plain": 0, "dtensor": 0},
            f"K1: adamw_update by path {update_paths()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(out["last_step"] == K1_STEPS - 1 and all(np.isfinite(losses)),
            f"K1: training did not run its steps with finite losses: "
            f"{losses}")
    require(counts["wkv6_scan"] > 0, "K1: wkv6_scan never launched")
    # the stream's next token is a lookup over the 65,536-token vocabulary,
    # so a step's loss on a fresh batch moves with the batch (0.07 across
    # batches 0-5 at the initial weights) more than six warm-up steps move
    # it: the losses are held on the six batches trained on, at the
    # initial and at the final weights
    model = lm_models.build(mcfg)
    stream = TokenStream(mcfg.vocab, K1_BATCH, K1_SEQ)
    batches = [_tree.tree_map(lambda x: x.to(device), stream.batch_at(i))
               for i in range(K1_STEPS)]
    n_params = sum(t.numel() for t in _tree.leaves(final["params"]))
    with torch.no_grad():
        after = [float(model.loss(final["params"], b)[0]) for b in batches]
        final.clear()
        start = model.init(0, device=device)
        before = [float(model.loss(start, b)[0]) for b in batches]
        del start
    require(np.mean(after) < np.mean(before), f"K1: the loss on the "
            f"batches trained on did not fall: {before} -> {after}")
    ms = float(np.median(np.diff(stamps) * 1e3))
    tokens = K1_BATCH * K1_SEQ
    share = model_flops(mcfg, tokens, "train") / (ms / 1e3) \
        / H100.peak("bf16")
    print(f"[pathK] K1 train {K1_ARCH} full size ({mcfg.n_layers} layers, "
          f"d_model {mcfg.d_model}, {mcfg.d_model // mcfg.rwkv_head_dim} "
          f"heads of {mcfg.rwkv_head_dim}, d_ff {mcfg.d_ff}, vocab "
          f"{mcfg.vocab}; {n_params:,} parameters, bf16; batch "
          f"{K1_BATCH} x seq {K1_SEQ}): {K1_STEPS} AdamW steps, loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; on the six batches trained on, the mean loss "
          f"{np.mean(before):.4f} at the initial weights -> "
          f"{np.mean(after):.4f} at the final (per batch "
          + " ".join(f"{a:.4f}->{b:.4f}" for a, b in zip(before, after))
          + f"); {ms:.3f} ms a step (host clock between syncs, median after "
          f"the first), {tokens / (ms / 1e3):,.0f} tokens/s, model FLOPs "
          f"{share:.4f} of the bf16 peak; peak memory {peak:.2f} GiB; "
          f"launches {json.dumps({k: counts[k] for k in SCAN_KERNELS})}, "
          f"{json.dumps({k: counts[k] for k in ADAMW_KERNELS})} (adamw_update "
          f"by path {json.dumps(update_paths())}); "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    steps = np.diff(stamps) * 1e3
    per_step = np.diff(np.stack(allocs), axis=0)
    print(f"[pathK] K1 train() each step after the first (host clock "
          f"between syncs) and the caching allocator's counts over it "
          f"({', '.join(K1_ALLOC)}): "
          + "; ".join(f"step {i + 1} {ms:.1f} ms {tuple(int(x) for x in c)}"
                      for i, (ms, c) in enumerate(zip(steps, per_step)))
          + f"; {card}", flush=True)
    del out, batches
    torch.cuda.empty_cache()
    k1_profiled(device, card)

    params = model.init(1, device=device)
    opt = adamw_init(params)
    step = lm_steps.make_train_step(model, AdamWConfig(lr=K1_LR))
    batch = _tree.tree_map(lambda x: x.to(device), TokenStream(
        mcfg.vocab, K1_BATCH, K1_SEQ).batch_at(0))
    step(params, opt, batch)
    step_profile("K1", lambda: step(params, opt, batch), prefix="[pathK]",
                 card=card, share=("wkv6_",))
    del model, params, opt, step, batch
    torch.cuda.empty_cache()
    k1_layer(device, card)
    return {k: counts[k] for k in SCAN_KERNELS}


def path_k2(device, card: str) -> dict:
    """K2: recurrentgemma-9b's ``make_prefill_step`` at its full published
    size on 1 x 4,096 tokens (past the 2,048-token local window), under
    no_grad: the logits against the same prefill with the plain loops on
    the card, bit for bit; then 8 decode steps through ``Server`` at 4
    slots. Returns the scans' launches in the prefills."""
    mcfg = lm_configs.get_config(K2_ARCH)
    t0 = time.perf_counter()
    model = lm_models.build(mcfg)
    params = model.init(0, device=device)
    n_params = sum(t.numel() for t in _tree.leaves(params))
    gen = torch.Generator(device=device).manual_seed(2)
    batch = {"tokens": torch.randint(0, mcfg.vocab, (1, K2_SEQ),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    pf = lm_steps.make_prefill_step(model)
    reset_launch_counts()
    reset_attention_paths()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        tp = time.perf_counter()
        logits = pf(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - tp) * 1e3)
    counts = launch_counts()
    paths = attention_paths()
    require(counts["rglru_scan"] > 0, "K2: rglru_scan never launched")
    require(paths["composed"] > 0 and not paths["kernel"],
            f"K2: the local layers (head width {mcfg.dh}) reached the "
            f"flash-attention kernel: {paths}")
    require(logits.shape[0] == 1 and bool(torch.isfinite(
        logits.float()).all()), f"K2: logits {tuple(logits.shape)} not "
        f"finite")
    with plain_scans():
        torch.cuda.synchronize()
        tp = time.perf_counter()
        ref = pf(params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp) * 1e3
    if torch.equal(logits, ref):
        verdict = "equal to the plain-loop prefill bit for bit"
    else:
        again = pf(params, batch)
        require(not torch.equal(again, logits), f"K2: the prefill's logits "
                f"differ from the plain-loop prefill's by "
                f"{float((logits.float() - ref.float()).abs().max())}, and "
                f"the kernel path is deterministic")
        gap = float((logits.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        require(gap <= 1e-5 * top, f"K2: logits off the plain loops by {gap}")
        verdict = (f"within {gap:.3e} of the plain-loop prefill (max|ref| "
                   f"{top:.3e}; two kernel-path runs differ: a library op "
                   f"is not deterministic)")
    n_rglru = sum(1 for i in range(mcfg.n_layers)
                  if mcfg.pattern[i % len(mcfg.pattern)] == "rglru")
    print(f"[pathK] K2 prefill {K2_ARCH} full size ({mcfg.n_layers} layers, "
          f"{n_rglru} RG-LRU of width {mcfg.rglru_width or mcfg.d_model}, "
          f"d_model {mcfg.d_model}, vocab {mcfg.vocab}, local window "
          f"{mcfg.local_window}; {n_params:,} parameters, bf16) on 1 x "
          f"{K2_SEQ} tokens, no_grad: logits {tuple(logits.shape)} "
          f"{verdict}; {median_ms(times):.3f} ms a prefill (median of 3 "
          f"after one) against {plain_ms:.1f} ms with the plain loops; "
          f"launches {json.dumps({k: counts[k] for k in SCAN_KERNELS})}; "
          f"local attention calls by path {json.dumps(paths)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    del model, params, logits, ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    srv = lm_serve.Server(K2_ARCH, smoke=False, slots=K2_SLOTS,
                          capacity=K2_CAPACITY, device=device)
    warm = lm_serve.requests(srv.cfg.vocab, 1, 2, seed=1)
    for r in warm:
        srv.submit(r)
    srv.run()
    reqs = lm_serve.requests(srv.cfg.vocab, K2_SLOTS, K2_NEW)
    for r in reqs:
        srv.submit(r)
    srv.steps_run = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total = srv.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    require(total == K2_SLOTS * K2_NEW and all(r.done for r in reqs),
            f"K2: served {total} tokens, want {K2_SLOTS * K2_NEW}")
    print(f"[pathK] K2 serve {K2_ARCH} full size: {K2_SLOTS} requests "
          f"(prompts {sorted({len(r.prompt) for r in reqs})}, {K2_NEW} new "
          f"tokens each) on {K2_SLOTS} slots, {srv.steps_run} batched decode "
          f"steps in {secs * 1e3:.1f} ms: {secs * 1e3 / srv.steps_run:.3f} "
          f"ms a step, {total / secs:.1f} tokens/s; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    del srv
    torch.cuda.empty_cache()
    return {k: counts[k] for k in SCAN_KERNELS}


def path_k_demos(card: str) -> None:
    """The reference's last gnn_serve demos, ported: each as a
    subprocess on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    want = {"--stream": "commits (", "--buckets": "overlap == serial: True",
            "--tech": "recommended plan"}
    for args in GDN_DEMOS:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.gnn_serve", *args],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        said = [ln.strip() for ln in out.stdout.splitlines()
                if want[args[0]] in ln or "overlap == serial" in ln
                or "tier" in ln or ln.startswith(("bucketed", "streaming"))]
        require(out.returncode == 0 and any(want[args[0]] in ln
                                            for ln in said),
                f"K: gnn_serve {' '.join(args)} failed:\n{out.stdout}\n"
                f"{out.stderr}")
        if args[0] == "--buckets":
            # the jnp layer's torch.matmul may round a bucket's rows and
            # the dense plan's apart on the card (path C1's tolerance)
            gap = re.search(r"max\|diff\| (\S+) of max\|dense\| (\S+)\)",
                            out.stdout)
            require(gap is not None and float(gap[1]) <= 1e-4 * float(
                gap[2]), f"K: the bucketed demo's embeddings leave the "
                f"dense plan's: {said}")
        print(f"[pathK] python -m repro_torch.examples.gnn_serve "
              f"{' '.join(args)}: exit 0; " + " | ".join(said)
              + f"; {time.perf_counter() - t0:.1f} s; {card}", flush=True)


def path_k(device, card: str) -> dict:
    """Path K; returns the scans' records for the kernels line (launches
    are K1's and K2's)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rec = path_k3(card)
    torch.cuda.empty_cache()
    k1 = path_k1(device, card)
    k2 = path_k2(device, card)
    for name in SCAN_KERNELS:
        rec[name]["launches"] = k1[name] + k2[name]
    path_k_demos(card)
    print(f"[pathK] launches over K1 and K2 "
          f"{json.dumps({k: rec[k]['launches'] for k in SCAN_KERNELS})}; "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)
    return rec


# ------------------------------------------------------------------ path L

# four more architectures at their full published widths and depth, bf16,
# weights drawn from a seed on the card: L1-L3 served through
# launch.serve.Server as I2 serves internlm2-1.8b, L4 whisper-base's
# encoder and cross-attention decode through the step builders, L5 one
# layer each of the sliding-window, local-window and latent-cache decode
# held past the point where its cache or its forward changes layout. None
# of the eight kernels runs on it.
L_SERVED = ("h2o-danube-3-4b", "minicpm3-4b", "qwen2-vl-2b")
L_CLI_ARCH = "qwen2-vl-2b"          # the smallest: one CLI run
L_MROPE = (32, 4, 8, 32)            # text, an image's rows x cols, text
L4_ARCH, L4_REQUESTS, L4_PROMPT, L4_NEW, L4_CAPACITY = \
    "whisper-base", 4, 3, 16, 32
# (arch, mixer kind, steps decoded past the window, or past one
# attn_chunk where the layer has no window: MLA)
L5_LAYERS = (("h2o-danube-3-4b", "attn", 256),
             ("recurrentgemma-9b", "local", 256),
             ("minicpm3-4b", "attn", 128))
# |decode - forward| <= L5_TOL * (the position's max|ref| + |ref|)
L5_TOL = 0.02


def mrope_image_positions(before: int, rows: int, cols: int,
                          after: int) -> torch.Tensor:
    """Qwen2-VL's M-RoPE positions [3, S] of ``before`` text tokens, an
    image of ``rows`` x ``cols`` patches and ``after`` text tokens: text
    equal on the three axes; the image at one temporal position, its
    height and width axes walking its rows and columns; the text after it
    from one past the image's largest position."""
    text = torch.arange(before)
    img_t = torch.full((rows * cols,), before)
    img_h = before + torch.arange(rows).repeat_interleave(cols)
    img_w = before + torch.arange(cols).repeat(rows)
    tail = before + max(rows, cols) + torch.arange(after)
    return torch.stack([torch.cat([text, a, tail])
                        for a in (img_t, img_h, img_w)]).to(torch.int32)


def l_mrope_prefill(srv) -> str:
    """qwen2-vl-2b's prefill with an image block's M-RoPE positions: the
    logits finite and equal across two runs; printed beside how far the
    text-only positions move them."""
    pos = mrope_image_positions(*L_MROPE).to(srv.device)
    gen = torch.Generator(device=srv.device).manual_seed(7)
    tokens = torch.randint(0, srv.cfg.vocab, (1, pos.shape[1]),
                           generator=gen, device=srv.device)
    pf = lm_steps.make_prefill_step(srv.model)
    one, two = (pf(srv.params, {"tokens": tokens, "mrope_pos": pos[:, None]})
                for _ in range(2))
    text = pf(srv.params, {"tokens": tokens, **text_positions(
        srv.cfg, 1, pos.shape[1], srv.device)})
    require(bool(torch.isfinite(one.float()).all()) and torch.equal(one, two),
            "L3: the M-RoPE image prefill's logits are not finite, or two "
            "runs differ")
    moved = float((one.float() - text.float()).abs().max())
    return (f"M-RoPE prefill of {pos.shape[1]} tokens ({L_MROPE[0]} text, "
            f"a {L_MROPE[1]} x {L_MROPE[2]} image, {L_MROPE[3]} text; the "
            f"three axes differ on the image and after it): logits finite, "
            f"two runs equal, {moved:.4f} from the text-only positions' "
            f"(max|logit| {float(one.float().abs().max()):.3f}); ")


def path_l4(device, card: str) -> None:
    """L4: whisper-base at its full size through ``make_prefill_step`` and
    ``make_serve_step(with_enc=True)``: 4 requests on 1,500 frames drawn
    from a seed, the encoder and the cross-attention keys and values built
    once, then a prompt of 3 tokens and 16 greedy tokens decoded; the
    whole loop twice, its tokens equal; the prefill's last logits over the
    decoded sequence against the decode chain's (the same cross keys and
    values), within 0.15 + 0.15 |ref|."""
    t0 = time.perf_counter()
    cfg = lm_configs.get_config(L4_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    model = lm_models.build(cfg)
    params = model.init(0, device=device)
    n_params = sum(t.numel() for t in _tree.leaves(params))
    gen = torch.Generator(device=device).manual_seed(4)
    frames = torch.randn((L4_REQUESTS, cfg.encoder.n_frames, cfg.d_model),
                         generator=gen, device=device).to(
                             lm_common.dtype_of(cfg.dtype))
    prompts = torch.randint(0, cfg.vocab, (L4_REQUESTS, L4_PROMPT),
                            generator=gen, device=device)
    step = lm_steps.make_serve_step(model, with_enc=True)

    def transcribe():
        torch.cuda.synchronize()
        ta = time.perf_counter()
        with torch.no_grad():
            enc = model._cross_kvs(params, model.encode(params, frames))
        torch.cuda.synchronize()
        tb = time.perf_counter()
        caches = model.init_caches(L4_REQUESTS, L4_CAPACITY, device=device)
        for p in range(L4_PROMPT):
            logits, caches = step(params, caches, prompts[:, p:p + 1], p,
                                  enc)
        out = [torch.argmax(logits, dim=-1)]
        for n in range(L4_NEW - 1):
            logits, caches = step(params, caches, out[-1], L4_PROMPT + n,
                                  enc)
            out.append(torch.argmax(logits, dim=-1))
        torch.cuda.synchronize()
        steps = L4_PROMPT + L4_NEW - 1
        return (torch.cat(out, dim=1), logits, (tb - ta) * 1e3,
                (time.perf_counter() - tb) * 1e3 / steps)

    first = transcribe()
    tokens, logits, enc_ms, step_ms = transcribe()
    require(torch.equal(first[0], tokens) and bool(torch.isfinite(
        logits.float()).all()), f"L4: two runs decoded other tokens, or "
        f"the logits are not finite:\n{first[0].tolist()}\n"
        f"{tokens.tolist()}")
    # the prefill over what the chain read: the prompt and all but the
    # last greedy token; its last logits are the chain's last
    seq = torch.cat([prompts, tokens[:, :-1]], dim=1)
    pf = lm_steps.make_prefill_step(model)
    ref = pf(params, {"tokens": seq, "frames": frames}).float()
    diff = (logits.float() - ref).abs()
    require(bool((diff <= 0.15 + 0.15 * ref.abs()).all()),
            f"L4: prefill vs the decode chain off by {float(diff.max())}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[pathL] L4 {L4_ARCH} full size ({cfg.encoder.n_layers} encoder "
          f"and {cfg.n_layers} decoder layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}; {n_params:,} parameters, bf16): {L4_REQUESTS} "
          f"requests on {cfg.encoder.n_frames} frames, the encoder and the "
          f"cross keys and values {enc_ms:.3f} ms; a prompt of {L4_PROMPT} "
          f"tokens and {L4_NEW} greedy tokens through make_serve_step("
          f"with_enc=True): {step_ms:.3f} ms a decode step; two runs' tokens "
          f"equal; prefill vs the decode chain max|diff| "
          f"{float(diff.max()):.4f} (tol 0.15 + 0.15 |ref|); peak device "
          f"memory {peak:.2f} GiB ({before:.2f} GiB allocated before); "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    del model, params, frames, step, pf
    torch.cuda.empty_cache()


def l5_layer(cfg, kind: str, extra: int, device) -> dict:
    """One attention layer of ``cfg`` (bf16 parameters, batch 1) decoded
    from an empty cache over ``extra`` steps past its window (the ring
    wraps) or, with no window, past one ``attn_chunk``; each step's output
    against the same layer's cacheless forward over the whole sequence
    (``chunked_attention`` at the config's ``attn_chunk``), within
    ``L5_TOL * (the position's max|ref| + |ref|)``; the cache's positions
    at the end the last ``capacity`` positions, its fill counter the
    length. Returns the layer's figures."""
    from repro_torch.models import attention as lm_attn
    window = cfg.window if kind == "attn" else cfg.local_window
    edge = window or cfg.attn_chunk
    s = edge + extra
    key = lm_common.InitKey.from_seed(5, device)
    params = (lm_attn.init_mla(key, cfg) if cfg.mla
              else lm_attn.init_gqa(key, cfg))
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=device).to(
        lm_common.dtype_of(cfg.dtype))
    pos = torch.arange(s, dtype=torch.int32, device=device)[None]

    def layer(xs, ps, cache=None, win=window):
        if cfg.mla:
            return lm_attn.mla_attention(params, xs, ps, cfg, cache=cache)
        return lm_attn.gqa_attention(params, xs, ps, cfg, window=win,
                                     cache=cache)

    with torch.no_grad():
        ref = layer(x, pos).float()
        # each position's outputs against their own scale (a late one
        # averages thousands of values and is small), and never looser
        # than I2's 0.15 + 0.15 |ref|
        tol = torch.minimum(
            L5_TOL * (ref.abs().amax(-1, keepdim=True) + ref.abs()),
            0.15 + 0.15 * ref.abs())
        # the same forward without the window, past it: the check must
        # tell it from the windowed one (none for MLA)
        unwindowed = None
        if window:
            off = (layer(x, pos, win=0).float() - ref).abs()[:, edge:]
            unwindowed = (float(off.max()), float(
                (off > tol[:, edge:]).float().mean()))
        cache = (lm_attn.init_mla_cache(cfg, 1, s, device) if cfg.mla else
                 lm_attn.init_gqa_cache(cfg, 1, s, window, device))
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(s):
            y, cache = layer(x[:, t:t + 1], pos[:, t:t + 1], cache)
            outs.append(y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / s
    got = torch.cat(outs, dim=1).float()
    top = float(ref.abs().max())
    err = (got - ref).abs()
    cap = cache["pos"].shape[1]
    ring = torch.sort(cache["pos"][0]).values
    require(torch.equal(ring, pos[0, s - cap:]) and int(cache["idx"]) == s,
            f"L5 {cfg.name} {kind}: after {s} steps the cache holds "
            f"positions {ring[:3].tolist()}..{ring[-3:].tolist()} and "
            f"counter {int(cache['idx'])}")
    return dict(name=cfg.name, kind=kind, window=window, s=s, cap=cap,
                edge=edge, err=float(err.max()), past=float(err[:, edge:]
                                                           .max()),
                rel=float((err / tol).max()), top=top,
                ok=bool((err <= tol).all()), ms=ms, unwindowed=unwindowed)


def path_l5(device, card: str) -> None:
    t0 = time.perf_counter()
    for arch, kind, extra in L5_LAYERS:
        cfg = lm_configs.get_config(arch)
        r = l5_layer(cfg, kind, extra, device)
        where = (f"window {r['window']}, a ring of {r['cap']} slots that "
                 f"wraps at step {r['edge']}" if r["window"] else
                 f"the latent cache ({cfg.mla.kv_lora} + {cfg.mla.rope_dim} "
                 f"a position), attn_chunk {cfg.attn_chunk}")
        control = ""
        if r["unwindowed"] is not None:
            far, share = r["unwindowed"]
            require(share > 0, f"L5 {arch} {kind}: the check cannot tell "
                    f"the forward without the window (max|diff| {far:.4e} "
                    f"past it) from the windowed one")
            control = (f"; the forward without the window is {far:.4f} "
                       f"away past it, outside the tolerance on {share:.3f} "
                       f"of those outputs")
        require(r["ok"], f"L5 {arch} {kind}: decode off the cacheless "
                f"forward by {r['err']:.4e}, {r['rel']:.3f} of the "
                f"tolerance")
        heads = (f"{cfg.n_heads} heads, MLA" if cfg.mla else
                 f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV, dh {cfg.dh}")
        print(f"[pathL] L5 {arch} one {kind} layer (d_model {cfg.d_model}, "
              f"{heads}; {where}), bf16, batch 1: {r['s']} decode steps "
              f"from an empty cache against the cacheless forward over "
              f"{r['s']} positions: max|diff| {r['err']:.4e}, "
              f"{r['past']:.4e} past step {r['edge']}, at most "
              f"{r['rel']:.3f} of the tolerance ({L5_TOL} * (the "
              f"position's max|ref| + |ref|), at most 0.15 + 0.15 |ref|; "
              f"max|ref| {r['top']:.4f}){control}; the cache "
              f"ends on the last {r['cap']} positions; {r['ms']:.3f} ms a "
              f"decode step; {card}", flush=True)
    print(f"[pathL] L5 {time.perf_counter() - t0:.1f} s in all", flush=True)


def path_l(device, card: str) -> None:
    """Path L: L1-L3 served at full size (L3 with the M-RoPE image prefill
    and the serve CLI), L4 whisper-base, L5 the three layers decoded past
    their window or chunk. Only qwen2-vl's prefills (head width 128)
    launch a kernel, flash attention; danube (120), minicpm3's latent
    attention and whisper (64) keep the composed path."""
    t0 = time.perf_counter()
    reset_launch_counts()
    by_arch = {}
    for i, arch in enumerate(L_SERVED):
        reset_attention_paths()
        serve_full(arch, f"L{i + 1}", "[pathL]", device, card,
                   cli=arch == L_CLI_ARCH,
                   extra=l_mrope_prefill if arch == "qwen2-vl-2b" else None)
        by_arch[arch] = attention_paths()
    reset_attention_paths()
    path_l4(device, card)
    by_arch["whisper-base"] = attention_paths()
    path_l5(device, card)
    counts = launch_counts()
    print(f"[pathL] launches over path L {json.dumps(counts)}; attention "
          f"calls by path {json.dumps(by_arch)}; "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)
    require(not any(v for k, v in counts.items()
                    if not k.startswith("flash_attention")),
            "path L launched a kernel other than flash attention")
    # qwen2-vl's bf16 prefills take the kernel; its float32 consistency
    # prefill (the tied head's check) is float32, so composed
    require(by_arch["qwen2-vl-2b"]["kernel"] > 0,
            f"path L: qwen2-vl's attention never reached the kernel: "
            f"{by_arch}")
    for arch in ("h2o-danube-3-4b", "minicpm3-4b", "whisper-base"):
        require(not by_arch[arch]["kernel"] and by_arch[arch]["composed"],
                f"path L: {arch} reached the kernel: {by_arch}")


# ------------------------------------------------------------------ path M

# flash attention (csrc/flash_attention.cu, kernels/attention/): the kernel
# pair against the composed chunked_attention (autograd, float32 inputs
# holding the same bf16 values) at the LM cells' layer shapes, a window
# and G = 6 at a length that is no multiple of a tile; the control that
# rounds P and dS to bf16; timings; the host's cost a call under autograd.
M_SHAPES = (   # (label, B, S, H, KV, window)
    ("1x4096", 1, 4096, 16, 8, 0),
    ("4x512", 4, 512, 16, 8, 0),
    ("1x4096 window 1000", 1, 4096, 16, 8, 1000),
    ("G6 2x1000", 2, 1000, 12, 2, 0),
)
M_TIMED = ("1x4096", "4x512")
M_PRODUCTS = 15    # the least for float32 scores and P.V: 1 + 3 forward,
                   # 1 + 1 + 3 + 3 + 3 backward (the kernels do 17)
BF16_PEAK = 989.4e12
M_PAIR_MS = 2.5    # forward plus backward at the 1x4096 layer shape, at most
M_HOST_MS = 0.2    # the host's ms a kernel call under autograd, under


def m_inputs(b: int, s: int, h: int, kv: int, seed: int) -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    return draw(b, s, h, 128), draw(b, s, kv, 128), draw(b, s, kv, 128), \
        draw(b, s, h, 128)


def m_positions(q) -> torch.Tensor:
    return torch.arange(q.shape[1], device=q.device)[None].expand(
        q.shape[0], -1)


def m_composed(q, k, v, dout, window: int) -> tuple:
    """(O, dq, dk, dv) in float32 from the composed path on float32 copies
    of the bf16 inputs (the kernel takes no float32 call)."""
    from repro_torch.models import attention as lm_attn
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    pos = m_positions(q)
    o = lm_attn.chunked_attention(qf, kf, vf, pos, pos, causal=True,
                                  window=window, chunk=1024, canonical=True)
    o.backward(dout.float())
    return o.detach(), qf.grad, kf.grad, vf.grad


def m_exact(q, k, v, dout, window: int) -> tuple:
    """(O, dq, dk, dv) in float64: softmax over the whole masked score
    matrix and autograd, the arbiter of the float32 paths."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    i = torch.arange(s, device=q.device)
    rel = i[:, None] - i[None, :]
    ok = (rel >= 0) & ((rel < window) if window else True)
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(g, 2))
    p = torch.softmax(torch.where(ok, sc * d ** -0.5, -math.inf), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vd.repeat_interleave(g, 2))
    o.backward(dout.double())
    return o.detach(), qd.grad, kd.grad, vd.grad


def m_lse(q, k, window: int) -> torch.Tensor:
    """logsumexp of the masked scores in float64, [B, S, H], a head at a
    time."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    i = torch.arange(s, device=q.device)
    rel = i[:, None] - i[None, :]
    ok = (rel >= 0) & ((rel < window) if window else True)
    out = torch.empty((b, s, h), dtype=torch.float64, device=q.device)
    for hh in range(h):
        sc = torch.einsum("bqd,bkd->bqk", q[:, :, hh].double(),
                          k[:, :, hh // g].double()) * (d ** -0.5)
        out[:, :, hh] = torch.logsumexp(torch.where(ok, sc, -1e30), -1)
    return out


def rel_err(got, ref) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max())


def bf16_ulps(got, ref) -> tuple:
    """(largest distance in bf16 steps between ``got`` (bf16) and the bf16
    rounding of ``ref``, the same over the elements with |ref| at least
    1/64 of max|ref|)."""
    def ordered(t):
        x = t.contiguous().view(torch.int16).int()
        return torch.where(x < 0, -(x & 0x7FFF), x)
    dist = (ordered(got) - ordered(ref.to(torch.bfloat16))).abs()
    big = ref.abs() >= ref.abs().max() / 64
    return int(dist.max()), int(dist[big].max())


def causal_pairs(s: int, window: int) -> int:
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


def m_check(label, b, s, h, kv, window, seed: int) -> dict:
    from repro_torch.kernels import attention as fa
    q, k, v, dout = m_inputs(b, s, h, kv, seed)
    res = {}
    for terms in (3, 1):
        out, o32, lse = fa.flash_attention_forward(q, k, v, window=window,
                                                   terms=terms)
        grads = fa.flash_attention_backward(q, k, v, o32, lse, dout,
                                            window=window, terms=terms,
                                            f32=True)
        res[terms] = (out, o32, lse) + tuple(grads)
    torch.cuda.synchronize()
    ref = m_exact(q, k, v, dout, window)
    ref32 = m_composed(q, k, v, dout, window)
    lse_ref = m_lse(q, k, window)
    out, o32, lse, dq, dk, dv, dq32, dk32, dv32 = res[3]
    row = {"shape": label,
           "out_is_O_rounded": bool(torch.equal(out, o32.to(torch.bfloat16)))}
    for j, (name, got) in enumerate((("out", out), ("dq", dq), ("dk", dk),
                                     ("dv", dv))):
        row[f"{name}_ulps"], row[f"{name}_ulps_big"] = bf16_ulps(got, ref[j])
        row[f"{name}_ulps_composed_big"] = bf16_ulps(got, ref32[j])[1]
    row["lse_rel"] = float((lse - lse_ref).abs().max()
                           / lse_ref.abs().max())
    for name, i, j in (("O", 1, 0), ("dq", 6, 1), ("dk", 7, 2),
                       ("dv", 8, 3)):
        row[f"{name}32"] = rel_err(res[3][i], ref[j])
        row[f"{name}32_composed"] = rel_err(ref32[j], ref[j])
        row[f"{name}32_control"] = rel_err(res[1][i], ref[j])
    same = fa.flash_attention_backward(q, k, v, o32, lse, dout,
                                       window=window)
    row["backward_repeats"] = all(torch.equal(x, y)
                                  for x, y in zip(same, (dq, dk, dv)))
    del res, ref
    torch.cuda.empty_cache()
    return row


def m_require(row: dict) -> None:
    """The card test's limits (``tests/test_torch_flash_attention.py``):
    bf16 out, dq, dk, dv within one bf16 step of the float64 result and
    of the composed path where |ref| >= max|ref| / 64; L within 1e-6 of
    max|L|; the float32 accumulators within 1e-4 of max|ref|, the
    control's more than 20x farther off; out the rounding of the float32
    O; the backward the same bit for bit twice."""
    where = f"path M {row['shape']}"
    for name in ("out", "dq", "dk", "dv"):
        require(row[f"{name}_ulps_big"] <= 1
                and row[f"{name}_ulps_composed_big"] <= 1,
                f"{where}: {name} more than one bf16 step off: {row}")
    require(row["lse_rel"] < 1e-6, f"{where}: L off by {row['lse_rel']}")
    for name in ("O", "dq", "dk", "dv"):
        split, control = row[f"{name}32"], row[f"{name}32_control"]
        require(split < 1e-4, f"{where}: float32 {name} off by {split}")
        require(control > 20 * split,
                f"{where}: the control's {name} ({control}) is not 20x "
                f"farther off than the split's ({split})")
    require(row["out_is_O_rounded"],
            f"{where}: out is not the bf16 rounding of the float32 O")
    require(row["backward_repeats"], f"{where}: the backward did not repeat")


def m_timing(label, b, s, h, kv, window, card: str) -> dict:
    from repro_torch.kernels import attention as fa
    from repro_torch.models import attention as lm_attn
    q, k, v, dout = m_inputs(b, s, h, kv, 7)
    out, o32, lse = fa.flash_attention_forward(q, k, v, window=window)

    def fwd():
        fa.flash_attention_forward(q, k, v, window=window)

    def bwd():
        fa.flash_attention_backward(q, k, v, o32, lse, dout, window=window)

    row = {"shape": label,
           "fwd_ms": cuda_ms(fwd, 20), "bwd_ms": cuda_ms(bwd, 20)}
    row["pair_ms"] = row["fwd_ms"] + row["bwd_ms"]
    for kern in ("fwd_kernel", "dq_kernel", "dkv_kernel"):
        row[kern], _ = profiled_ms(fwd if kern == "fwd_kernel" else bwd,
                                   kern, 10)
    flops = 2.0 * b * h * 128 * causal_pairs(s, window)
    row["bound_ms"] = M_PRODUCTS * flops / BF16_PEAK * 1e3
    row["tflops_17"] = 17 * flops / (row["pair_ms"] * 1e-3) / 1e12
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    pos = m_positions(q)

    def composed():
        o = lm_attn.chunked_attention(qg, kg, vg, pos, pos, causal=True,
                                      window=window, chunk=1024,
                                      canonical=True)
        o.backward(dout)

    taken = lm_attn.kernel_takes
    lm_attn.kernel_takes = lambda *a, **kw: False
    try:
        row["composed_ms"] = cuda_ms(composed, 5)
    finally:
        lm_attn.kernel_takes = taken

    def plain():
        o_, o32_, l_ = fa.flash_attention_forward_ref(q, k, v, window=window)
        fa.flash_attention_backward_ref(q, k, v, o32_, l_, dout,
                                        window=window)
    row["plain_ms"] = cuda_ms(plain, 2)
    print(f"[pathM] {label}: {json.dumps(row)}; {card}", flush=True)
    return row


def m_host_cost(card: str) -> dict:
    """Host ms a call under autograd, forward and backward, over a chain
    of 24 calls (a step's layers) at a shape whose device time is small
    (B 1, S 128), so the host paces the loop; beside it the same chain of
    the composed path."""
    from repro_torch.kernels import attention as fa
    from repro_torch.models import attention as lm_attn
    q, k, v, dout = m_inputs(1, 128, 16, 8, 3)
    k, v = (t.requires_grad_() for t in (k, v))
    pos = m_positions(q)

    def kernel(x):
        return fa.flash_attention(x, k, v)

    def composed(x):
        return lm_attn.chunked_attention(x, k, v, pos, pos, causal=True,
                                         window=0, chunk=1024,
                                         canonical=True)

    def chain(fn) -> tuple:
        x = q.detach().requires_grad_()
        t0 = time.perf_counter()
        y = x
        for _ in range(24):
            y = fn(y)
        t1 = time.perf_counter()
        y.backward(dout)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / 24 * 1e3, (t2 - t1) / 24 * 1e3

    row = {}
    taken = lm_attn.kernel_takes
    for name, fn in (("kernel", kernel), ("composed", composed)):
        if name == "composed":
            lm_attn.kernel_takes = lambda *a, **kw: False
        try:
            for _ in range(3):
                chain(fn)
            runs = [chain(fn) for _ in range(10)]
        finally:
            lm_attn.kernel_takes = taken
        row[f"{name}_forward_ms"] = sorted(r[0] for r in runs)[5]
        row[f"{name}_backward_ms"] = sorted(r[1] for r in runs)[5]
    print(f"[pathM] host ms a call under autograd (median of 10 chains of "
          f"24): {json.dumps(row)}; {card}", flush=True)
    return row


def flash_paths() -> None:
    """``--flash``: path M, then the LM runs whose attention the kernel
    takes (I1's training and I2's prefills on internlm2-1.8b, L3's
    qwen2-vl-2b) or leaves to the composed path (L1 danube, L2 minicpm3,
    L4 whisper-base, K2's local layers), each held to its own checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all(("flash_attention", "adamw", *SCAN_KERNELS))
    print(f"[build] {len(logs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    path_m(card)
    path_i(device, card)
    path_l(device, card)
    path_k2(device, card)
    print(f"[done] --flash: {json.dumps(attention_paths())} since K2's "
          f"reset; {card}", flush=True)


def path_m(card: str) -> dict:
    t0 = time.perf_counter()
    reset_launch_counts()
    reset_attention_paths()
    rows = []
    for i, (label, b, s, h, kv, window) in enumerate(M_SHAPES):
        row = m_check(label, b, s, h, kv, window, 100 + i)
        print(f"[pathM] check {json.dumps(row)}", flush=True)
        m_require(row)
        rows.append(row)
    timings = [m_timing(*shape, card) for shape in M_SHAPES
               if shape[0] in M_TIMED]
    host = m_host_cost(card)
    counts = launch_counts()
    print(f"[pathM] launches over path M {json.dumps(counts)}; paths "
          f"{json.dumps(attention_paths())}; "
          f"{time.perf_counter() - t0:.1f} s in all; {card}", flush=True)
    require(counts["flash_attention_forward"] > 0
            and counts["flash_attention_backward"] > 0,
            "path M: a flash-attention kernel never launched")
    pair = next(t["pair_ms"] for t in timings if t["shape"] == "1x4096")
    require(pair <= M_PAIR_MS, f"path M: the pair took {pair:.3f} ms at the "
            f"1x4096 layer shape, more than {M_PAIR_MS} ms")
    slow = {k: v for k, v in host.items()
            if k.startswith("kernel") and v >= M_HOST_MS}
    require(not slow, f"path M: the host's ms a kernel call under autograd "
            f"reached {M_HOST_MS}: {slow}")
    return {"checks": rows, "timings": timings, "host": host}


# ------------------------------------------------------------------ path N

# The AdamW kernels at the benchmark's leaves (the cells' optimizer,
# perfbench/traffic, at step N_STEP), at ragged sizes (the last rwkv6-3b's
# largest leaf) for each (parameter, gradient) dtype pair, and past one
# launch's leaves; then train() at I1's size for N_TRAIN_STEPS steps.
N_ARCHS = ("internlm2-1.8b", "rwkv6-3b")
N_OPT = AdamWConfig(lr=3e-4, warmup=1)
N_STEP = 3
N_RAGGED = (1, 7, 8 * 4099 + 3, 734_003_200)
N_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
           (torch.bfloat16, torch.float32))
N_MANY = 100
N_TRAIN_STEPS = 3


def n_leaf(spec, seed: int) -> tuple:
    """(p, g, m, v) of one leaf on the card, the same for the same seed:
    p ~ N(0, 0.02), g ~ N(0, 1e-3) in their dtypes, m ~ N(0, 1e-4) and
    v = N(0, 1e-3)^2 in float32. ``spec`` (shape, p dtype, g dtype,
    offset): p is a view ``offset`` elements into its storage."""
    shape, p_dtype, g_dtype, offset = spec
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draw = lambda s, n=0: torch.randn(
        (math.prod(shape) + n,), generator=gen, device="cuda") * s
    p = draw(0.02, offset).to(p_dtype)[offset:].view(shape)
    g = draw(1e-3).to(g_dtype).view(shape)
    return p, g, draw(1e-4).view(shape), draw(1e-3).square_().view(shape)


def n_bytes(specs) -> tuple:
    """(the update's bytes, the norm's): p, g, m, v read and p, m, v
    written once; g read once more."""
    size = lambda d: torch.empty((), dtype=d).element_size()
    n = [math.prod(s) for s, *_ in specs]
    return (sum(k * (2 * size(p) + size(g) + 16)
                for k, (_, p, g, _o) in zip(n, specs)),
            sum(k * size(g) for k, (_, _p, g, _o) in zip(n, specs)))


def n_schedule(step):
    """``adamw_update``'s lr and bias corrections at ``step``, op for op."""
    warmup = torch.full((), float(max(N_OPT.warmup, 1)), device=step.device)
    return (N_OPT.lr * torch.clamp_max(step.float() / warmup, 1.0),
            1.0 - N_OPT.b1 ** step.float(), 1.0 - N_OPT.b2 ** step.float())


def n_plain(p, g, m, v) -> None:
    """One step of the plain version over the leaves, its results
    dropped leaf by leaf (the composed path's work)."""
    scale, _ = kopt.clip_scale(g, N_OPT.clip_norm)
    lr, b1c, b2c = n_schedule(torch.full((), N_STEP, device="cuda"))
    for leaf in zip(p, g, m, v):
        kopt.adamw_leaf(*leaf, scale, lr, b1c, b2c, N_OPT)


def n_case(label: str, specs: list, timed: bool, card: str) -> dict:
    """One tree of leaves ``specs`` through ``optim.adamw_update`` on the
    card: the tensors it hands back are those it was handed; p, m and v
    equal bit for bit to the plain version's on the same draws given the
    kernel's clip scale; the kernel's norm equal on two runs and within
    1e-6 of a float64 sum. With ``timed``, the kernels and the plain
    version timed (CUDA events) beside the bound."""
    t0 = time.perf_counter()
    p, g, m, v = (list(x) for x in zip(*(n_leaf(s, 1000 + i)
                                          for i, s in enumerate(specs))))
    scale, gn = kopt.adamw_norm(g, N_OPT.clip_norm)
    scale2, gn2 = kopt.adamw_norm(g, N_OPT.clip_norm)
    want_gn = math.sqrt(sum(float(t.double().square_().sum()) for t in g))
    rel = abs(float(gn) - want_gn) / want_gn
    require(torch.equal(gn, gn2) and torch.equal(scale, scale2),
            f"N {label}: two runs of the norm differ: {float(gn)!r}, "
            f"{float(gn2)!r}")
    require(rel <= 1e-6, f"N {label}: the norm {float(gn)!r} is {rel:.3e} "
            f"off the float64 sum {want_gn!r}")
    state = {"m": m, "v": v, "step": torch.tensor(N_STEP - 1,
                                                   dtype=torch.int32,
                                                   device="cuda")}
    ptrs = [t.data_ptr() for t in p + m + v]
    reset_update_paths()
    got_p, got_s, got_gn = adamw_update(p, g, state, N_OPT)
    torch.cuda.synchronize()
    require(update_paths() == {"kernel": 1, "plain": 0, "dtensor": 0},
            f"N {label}: adamw_update by path {update_paths()}")
    require(got_p is p and got_s["m"] is m and got_s["v"] is v
            and [t.data_ptr() for t in p + m + v] == ptrs
            and torch.equal(got_gn, gn), f"N {label}: adamw_update did not "
            f"hand back the tensors it was handed, or another norm")
    lr, b1c, b2c = n_schedule(got_s["step"])
    bad = []
    for i, spec in enumerate(specs):
        want = kopt.adamw_leaf(*n_leaf(spec, 1000 + i), scale, lr, b1c, b2c,
                               N_OPT)
        for name, got, w in zip("pmv", (p[i], m[i], v[i]), want):
            if not torch.equal(got, w):
                bad.append(f"leaf {i} {spec[0]} {name}: "
                           f"{int((got != w).sum())} elements differ")
        del want
    require(not bad, f"N {label}: the kernel is off the plain version: "
            + "; ".join(bad[:6]))
    pairs = sorted({(str(s[1]).split(".")[1], str(s[2]).split(".")[1])
                    for s in specs})
    row = dict(case=label, leaves=len(specs),
               elements=sum(math.prod(s[0]) for s in specs),
               pairs=["/".join(x) for x in pairs], norm_rel=rel,
               equal="bit for bit")
    if timed:
        upd_b, norm_b = n_bytes(specs)
        row["norm_ms"] = cuda_ms(lambda: kopt.adamw_norm(g, N_OPT.clip_norm),
                                 5)
        row["update_ms"] = cuda_ms(lambda: kopt.adamw_update(
            p, g, m, v, scale, lr, b1c, b2c, N_OPT), 5)
        row["kernel_ms"] = row["norm_ms"] + row["update_ms"]
        row["bound_ms"] = (upd_b + norm_b) / HBM_BPS * 1e3
        row["roofline"] = row["bound_ms"] / row["kernel_ms"]
        row["plain_ms"] = cuda_ms(lambda: n_plain(p, g, m, v), 2)
    row["s"] = round(time.perf_counter() - t0, 1)
    print(f"[pathN] {json.dumps(row)}; {card}", flush=True)
    del p, g, m, v, state, got_p, got_s
    torch.cuda.empty_cache()
    return row


def n_train(card: str) -> dict:
    """``train()`` at I1's size for N_TRAIN_STEPS steps: ``adamw_update``
    takes the kernels every step, 2 norm launches a step and one update
    launch a dtype pair (internlm2-1.8b: bf16 and float32 leaves)."""
    reset_update_paths()
    reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm_train.train(lm_train.TrainConfig(
        arch=I_ARCH, smoke=False, steps=N_TRAIN_STEPS, batch=I1_BATCH,
        seq=I1_SEQ, lr=I1_LR, log_every=N_TRAIN_STEPS, device="cuda"))
    torch.cuda.synchronize()
    paths, counts = update_paths(), launch_counts()
    row = dict(arch=I_ARCH, steps=N_TRAIN_STEPS, paths=paths,
               launches={k: counts[k] for k in ADAMW_KERNELS},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               s=round(time.perf_counter() - t0, 1))
    print(f"[pathN] train() {json.dumps(row)}; {card}", flush=True)
    require(paths == {"kernel": N_TRAIN_STEPS, "plain": 0, "dtensor": 0}
            and row["launches"] == {"adamw_norm": 2 * N_TRAIN_STEPS,
                                    "adamw_update": 2 * N_TRAIN_STEPS},
            f"N train(): adamw_update by path {paths}, launches "
            f"{row['launches']}")
    return row


def path_n(card: str) -> dict:
    """Path N; returns the record of the kernels line."""
    t0 = time.perf_counter()
    _build.build_all(("adamw",))
    reset_launch_counts()
    rows = []
    for arch in N_ARCHS:
        leaves = _tree.leaves(lm_models.build(lm_configs.get_config(
            arch)).init(lm_common.InitKey.abstract()))
        rows.append(n_case(arch, [(tuple(t.shape), t.dtype, t.dtype, 0)
                                  for t in leaves], True, card))
        if arch == I_ARCH:
            rows.append(n_case(f"{arch}, float32 gradients",
                               [(tuple(t.shape), t.dtype, torch.float32, 0)
                                for t in leaves], True, card))
    for p_dtype, g_dtype in N_PAIRS:
        specs = [((n,), p_dtype, g_dtype, 0) for n in N_RAGGED]
        rows.append(n_case(f"ragged {p_dtype} / {g_dtype}",
                           specs + [((1000,), p_dtype, g_dtype, 1)], False,
                           card))
    # 50 leaves of a pair: two update launches each, three norm launches
    rows.append(n_case(f"{N_MANY} leaves", [
        ((97 * i + 1,), *N_PAIRS[i // 50], i % 2) for i in range(N_MANY)],
        False, card))
    counts = launch_counts()
    print(f"[pathN] launches over the cases {json.dumps(counts)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    train_row = n_train(card)
    print(f"[pathN] {time.perf_counter() - t0:.1f} s in all; {card}",
          flush=True)
    return {"checks": rows, "train": train_row}


# ------------------------------------------------------------------ phase 4


def live_counts(nbr, wts) -> tuple:
    """(slots with a non-zero weight, distinct rows they read)."""
    live = wts != 0
    return int(live.sum()), int(torch.unique(nbr[live]).numel())


def bound(nbytes: int, t_ops: float) -> tuple:
    """(least ms, what bounds it): ``nbytes`` over the HBM rate against
    ``t_ops`` seconds of operations at their peak rate."""
    t_mem = nbytes / HBM_BPS
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def bounds(x, nbr, wts, h: int, in_bits: int) -> dict:
    """Least device ms on an H100 SXM for each kernel at these inputs:
    each input read once, each output written once, against the ops of
    the slots with a non-zero weight (the ideal layer's product as the
    three TF32 products of its 3xTF32 split). Returns {kernel: (ms,
    bound_by)}."""
    nd, s = nbr.shape
    f = x.shape[1]
    nnz, rows = live_counts(nbr, wts)
    read = rows * f * 4 + nd * s * 8          # gathered rows + tables
    gather_flops = 2 * nnz * f
    return {
        "csr_aggregate": bound(read + nd * f * 4, gather_flops / F32_FLOPS),
        "fused_zmax": bound(read + nd * 8,
                            (gather_flops + 2 * nd * f) / F32_FLOPS),
        "fused_ideal_layer": bound(     # 3xTF32: three TF32 products
            read + f * h * 4 + h * 4 + nd * h * 4,
            gather_flops / F32_FLOPS + 3 * 2 * nd * f * h / TF32_OPS),
        "fused_quant_layer": bound(
            read + f * h * 4 + h * 4 + 12 + nd * h * 4,
            gather_flops / F32_FLOPS
            + 2 * in_bits * 2 * nd * f * h / INT8_OPS),
    }


def zmax_composed(x, nbr, wts):
    """zmax composed of stock calls: the aggregation kernel, then the row
    max and min of Z."""
    z = csr_aggregate(x, nbr, wts)
    return torch.stack([torch.clamp_min(z.amax(dim=1), 0.0),
                        torch.clamp_min(-z.amin(dim=1), 0.0)], dim=1)


def ideal_composed(x, nbr, wts, w, b):
    """The ``pallas`` backend's ideal layer: the aggregation kernel, then
    one f32 matmul, the bias and the relu."""
    return torch.clamp_min(csr_aggregate(x, nbr, wts) @ w + b, 0.0)


def timings(x, nbr, wts, layer, tag: str, iters: int) -> dict:
    """Kernel, plain and library times at one layer's shapes; zmax and the
    ideal layer also by the device time of their launch alone (the
    profiler's kernel time) and beside their composed yardstick, which
    fusion has to beat (several calls, so no library call)."""
    cfg = CrossbarNumerics()
    w, b = layer["w"], layer["b"]
    codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nbr, wts), w,
                                      cfg)
    runs = {
        "csr_aggregate": (lambda: csr_aggregate(x, nbr, wts),
                          lambda: csr_aggregate_ref(x, nbr, wts)),
        "fused_zmax": (lambda: fl.fused_zmax(x, nbr, wts),
                       lambda: fl.fused_zmax_plain(x, nbr, wts)),
        "fused_ideal_layer": (
            lambda: fl.fused_ideal_layer(x, nbr, wts, w, b, relu=True),
            lambda: fl.fused_ideal_layer_plain(x, nbr, wts, w, b,
                                               relu=True)),
        "fused_quant_layer": (      # with the programming of the weights
            lambda: fl.fused_quant_layer(
                x, nbr, wts, fl.program_conductances(w, cfg), b, scales, cfg,
                relu=True),
            lambda: fl.fused_quant_layer_plain(x, nbr, wts, codes.wq, b,
                                               scales, cfg, relu=True)),
    }
    composed = {"fused_zmax": lambda: zmax_composed(x, nbr, wts),
                "fused_ideal_layer": lambda: ideal_composed(x, nbr, wts, w,
                                                            b)}
    kernel_names = {"fused_zmax": "fused_zmax_kernel",
                    "fused_ideal_layer": "fused_ideal_kernel"}
    torch.cuda.synchronize()
    require(torch.equal(zmax_composed(x, nbr, wts),
                        fl.fused_zmax_plain(x, nbr, wts)),
            "the composed zmax differs from the plain version")
    nd, s = nbr.shape
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(   # columns unsorted: no invariants
            torch.arange(0, nd * s + 1, s, device=x.device),
            nbr.reshape(-1).long(), wts.reshape(-1), size=(nd, x.shape[0]),
            check_invariants=False)
    lib = torch.sparse.mm(csr, x)
    lib_err = float((lib - csr_aggregate_ref(x, nbr, wts)).abs().max())
    bnd = bounds(x, nbr, wts, w.shape[1], cfg.in_bits)
    nnz, rows = live_counts(nbr, wts)
    print(f"[time] {tag}: Nd={nd} S={s} F={x.shape[1]} H={w.shape[1]}, "
          f"{nnz} slots with a non-zero weight reading {rows} distinct rows",
          flush=True)
    rec = {}
    for name, (kernel, plain) in runs.items():
        rec[name] = dict(
            ms=cuda_ms(kernel, iters), plain_ms=cuda_ms(plain, 3),
            bound_ms=bnd[name][0], bound_by=bnd[name][1],
            library_ms=(cuda_ms(lambda: torch.sparse.mm(csr, x), iters)
                        if name == "csr_aggregate" else None))
        r = rec[name]
        lib_txt = (f", torch.sparse.mm {r['library_ms']:.3f} ms "
                   f"(max|diff| {lib_err:.2e})"
                   if r["library_ms"] is not None else "")
        if name in composed:
            r["launch_ms"], how = profiled_ms(kernel, kernel_names[name],
                                              iters)
            r["composed_ms"] = cuda_ms(composed[name], iters)
            lib_txt += (f", launch alone {r['launch_ms']:.4f} ms ({how}), "
                        f"composed "
                        f"{r['composed_ms']:.3f} ms")
        what = ("kernel with the programming of the weights"
                if name == "fused_quant_layer" else "kernel")
        print(f"[time] {tag} {name:18s} {what} {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}){lib_txt}", flush=True)
    for nname, qcfg in (("default", cfg), ("QUANT", CrossbarNumerics(
            **QUANT))):
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", qcfg)).to(x.device) \
                if noisy else None
            codes, scales = fl.quant_operands(
                fl.fused_zmax_plain(x, nbr, wts), w, qcfg, nz)
            ms = cuda_ms(lambda: fl.fused_quant_layer(
                x, nbr, wts, codes, b, scales, qcfg, relu=True), iters)
            ms_prog = cuda_ms(lambda: fl.fused_quant_layer(
                x, nbr, wts, fl.program_conductances(w, qcfg, nz), b, scales,
                qcfg, relu=True), iters)
            d = codes.digits.shape[0]
            print(f"[time] {tag} fused_quant_layer {nname} numerics, "
                  f"{'noisy' if noisy else 'clean'} codes ({d} int8 digit"
                  f"{'s' if d > 1 else ''}): with the programming of the "
                  f"weights {ms_prog:.3f} ms, launch alone {ms:.3f} ms",
                  flush=True)
    return rec


def wide_deep_timings(x1, nbr, wts, layer, z1, device) -> None:
    """Times of the wide and deep cases (CUDA events, launch alone on
    programmed codes): at layer 1 of the centralized collab path the quant
    layer and the crossbar with 12- and 16-bit DAC codes and with 12- and
    16-bit conductance codes (clean and noisy) beside the default
    numerics' launch; and the quant layer at the DEEP cases on 3,000
    rows (K in chunks)."""
    w, b = layer["w"], layer["b"]
    zmax = fl.fused_zmax_plain(x1, nbr, wts)
    for name, numerics in (("default", {}), *WIDE.items()):
        cfg = CrossbarNumerics(**numerics)
        for noisy in (False, True):
            nz = torch.from_numpy(devices.sample_conductance_noise(
                3, tuple(w.shape), "reram", cfg)).to(device) \
                if noisy else None
            codes, scales = fl.quant_operands(zmax, w, cfg, nz)
            q_ms = cuda_ms(lambda: fl.fused_quant_layer(
                x1, nbr, wts, codes, b, scales, cfg, relu=True), 5)
            xq, _ = xb.quantize_inputs(torch.clamp_min(z1, 0.0), cfg)
            x_ms = cuda_ms(lambda: xb.crossbar_matmul_programmed(
                xq, codes, cfg), 5)
            d = codes.digits.shape[0]
            print(f"[time] wide codes layer1 {name} "
                  f"{'noisy' if noisy else 'clean'} ({d} int8 digit"
                  f"{'s' if d > 1 else ''}, {-(-cfg.in_bits // 8)} pass"
                  f"{'es' if cfg.in_bits > 8 else ''}): fused_quant_layer "
                  f"launch {q_ms:.3f} ms, crossbar_matmul_quantized "
                  f"launch {x_ms:.3f} ms", flush=True)
    nb = torch.remainder(nbr[:3000], 4000)
    wt = wts[:3000].contiguous()
    deep = deep_inputs(device, 17)
    for f, numerics in DEEP:
        x, w, _ = deep[f]
        cfg = CrossbarNumerics(**numerics)
        codes, scales = fl.quant_operands(fl.fused_zmax_plain(x, nb, wt), w,
                                          cfg)
        ms = cuda_ms(lambda: fl.fused_quant_layer(
            x, nb, wt, codes, b, scales, cfg, relu=True), 20)
        d = codes.digits.shape[0]
        print(f"[time] deep F 3000 rows {f}->64 {numerics_tag(numerics)} "
              f"(depth {fl.tile_depth(f, cfg.rows_per_xbar)}, {d} int8 "
              f"digit{'s' if d > 1 else ''}, {-(-cfg.in_bits // 8)} pass"
              f"{'es' if cfg.in_bits > 8 else ''}): fused_quant_layer launch "
              f"{ms:.3f} ms", flush=True)


def new_timings(z1, w1, z2, w2, device, builds: dict) -> dict:
    """Kernel, plain and bound times of ``cam_search`` at one k-NN launch
    and of ``crossbar_matmul_quantized`` at layer 1 of the centralized
    collab path (the kernels line's record); the crossbar also with
    12-bit-ADC/64-row numerics, on clean codes, at layer 2 (64 -> 16) and
    at the variation bounds' 32 x 216 x 64. Each is timed two ways: per
    wrapper call (``ms``: CUDA events around back-to-back calls, so the
    host's work counts where it is the slower) and the device time of its
    launch alone (``launch_ms``: the profiler's time of the kernel, or
    CUDA events' where the profiler shows none). The crossbar's wrapper reads its codes back (one host sync) and builds
    their digits; its launch alone takes programmed weights. Neither kernel
    has one PyTorch call that computes the same function."""
    rec = {}
    entries, queries = cam_inputs(device)
    e, q = entries.numel(), queries.numel()
    ms, by = bound(4 * e + 4 * q + q * e + 4 * q, q * e / F32_FLOPS)

    def call():
        return cam_search(entries, queries)
    prof, how = profiled_ms(call, "cam_search_kernel", 50)
    rec["cam_search"] = dict(
        ms=cuda_ms(call, 200), launch_ms=prof,
        plain_ms=cuda_ms(lambda: cam_search_ref(entries, queries), 20),
        bound_ms=ms, bound_by=by, library_ms=None)
    r = rec["cam_search"]
    print(f"[time] cam_search Q={q} E={e}: per wrapper call {r['ms']:.4f} "
          f"ms, launch alone {prof:.4f} ms ({how}), "
          f"plain {r['plain_ms']:.4f} ms, "
          f"bound {ms:.4f} ms ({by}; bitmap {q * e} B written)", flush=True)
    b = knn.DEFAULT_BANDS
    qc, n = q // b, e // b
    match, _ = call()
    out = torch.empty((qc, n), dtype=torch.int32, device=device)

    def fold():
        out[:qc] = match.view(qc, b, n, b).sum(dim=(1, 3), dtype=torch.int32)
    fold_ms = cuda_ms(fold, 200)
    launches = -(-SCENARIO_NODES // qc)
    for name, secs in builds.items():
        print(f"[time] k-NN build {name} cam-pallas {secs * 1e3:.1f} ms "
              f"(host clock, phase 3): {launches} cam_search calls "
              f"{launches * r['ms']:.1f} ms "
              f"({launches * r['ms'] / secs / 10:.1f} %), {launches} folds "
              f"{launches * fold_ms:.1f} ms "
              f"({launches * fold_ms / secs / 10:.1f} %); per fold "
              f"{fold_ms:.4f} ms", flush=True)
    x_small, w_small = mvm_inputs(device)
    default, quant = CrossbarNumerics(), CrossbarNumerics(**QUANT)
    for x, w, nname, cfg, noisy, iters in (
            (z1, w1, "default", default, True, 5),
            (z1, w1, "default", default, False, 5),
            (z1, w1, "QUANT", quant, True, 5),
            (z1, w1, "QUANT", quant, False, 5),
            (z2, w2, "default", default, True, 20),
            (x_small, w_small, "default", default, True, 200),
            (x_small, w_small, "default", default, False, 200)):
        xq, codes = crossbar_codes(x, w, cfg, noisy)
        m, k = xq.shape
        n = codes.wq.shape[1]
        ms, by = bound(4 * m * k + 4 * k * n + 4 * m * n,
                       2 * cfg.in_bits * m * k * n / INT8_OPS)

        def launch():
            return xb.crossbar_matmul_programmed(xq, codes, cfg)
        prof, how = profiled_ms(launch, "crossbar_mma_kernel",
                                min(iters, 20))
        r = dict(
            ms=cuda_ms(lambda: xb.crossbar_matmul_quantized(xq, codes.wq,
                                                            cfg), iters),
            launch_ms=prof,
            plain_ms=cuda_ms(
                lambda: xb.crossbar_matmul_quantized_plain(xq, codes.wq,
                                                           cfg),
                min(iters, 3)),
            bound_ms=ms, bound_by=by, library_ms=None)
        d = codes.digits.shape[0]
        print(f"[time] crossbar_matmul_quantized {m}x{k}x{n} {nname} "
              f"numerics, {'noisy' if noisy else 'clean'} codes ({d} int8 "
              f"digit{'s' if d > 1 else ''}): per wrapper call "
              f"{r['ms']:.4f} ms, launch alone {prof:.4f} ms ({how}), plain "
              f"{r['plain_ms']:.4f} ms, bound {ms:.4f} ms ({by})",
              flush=True)
        rec.setdefault("crossbar_matmul_quantized", r)
    return rec


# ------------------------------------------------------------------ F6 loop

# ``--f6-loop ROUNDS``, not part of the normal run: ROUNDS rounds of path
# H1's eight cases (the one-cluster collab 0.1 plan, an NCCL world of one,
# the emulated and the SPMD forward of each case) with CUDA_LAUNCH_BLOCKING=1
# and a device sync after every kernel launch, hunting the one illegal
# memory access of PR 21's call 25; then, where the toolkit has
# compute-sanitizer, one round under its memcheck tool.
F6_SANITIZER_TIMEOUT = 600.0


def f6_loop(rounds: int, sanitize: bool) -> None:
    last = {"launch": None}
    check = _build.check

    def synced_check(code: int, what: str) -> None:
        last["launch"] = what
        check(code, what)
        torch.cuda.synchronize()

    _build.check = synced_check
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    g01 = dataset_like("collab", scale=0.1, seed=0).gcn_normalize()
    plan1 = plan_execution(g01, "decentralized", sample=SAMPLE, n_clusters=1)
    cfg = gnn.GNNConfig(in_dim=g01.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    params = gnn.init_params(cfg, seed=0, device=device)
    print(f"[f6] CUDA_LAUNCH_BLOCKING={os.environ.get('CUDA_LAUNCH_BLOCKING')}"
          f", a sync after every launch; one-cluster plan {plan1.part.n_max} "
          f"rows, h_max {plan1.part.h_max}, halo_src "
          f"{plan1.part.halo_src.tolist()}; set-up {time.perf_counter() - t0:.1f} s", flush=True)
    mesh = make_mesh((1,), ("data",), backend=H1_BACKEND,
                     device=H_RANK_DEVICE,
                     init_method=f"tcp://localhost:{free_port()}", rank=0,
                     timeout=H_TIMEOUT)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        for r in range(rounds):
            for mode, backend, ideal in h_cases():
                c = dataclasses.replace(cfg, numerics=CrossbarNumerics(
                    ideal=ideal))
                p = dataclasses.replace(plan1, backend=backend)
                emu = p.make_forward(c, mode=mode, device=device)(params)
                got = p.make_forward(c, mesh=mesh, mode=mode,
                                     device=device)(params)
                torch.cuda.synchronize()
                require(torch.equal(got, emu), f"F6 round {r} "
                        f"{h_label(mode, backend, ideal)}: SPMD != emulated")
    except RuntimeError as e:
        print(f"[f6] FAULT after launch {last['launch']!r}: {e}", flush=True)
        raise
    finally:
        dist.destroy_process_group()
    print(f"[f6] {rounds} rounds x 8 cases (emulated + SPMD forward each), "
          f"no fault; launches {json.dumps(launch_counts())}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not sanitize:
        return
    tool = shutil.which("compute-sanitizer") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "compute-sanitizer")
    if not os.path.exists(tool):
        print(f"[f6] compute-sanitizer: not in the toolkit ({tool})",
              flush=True)
        return
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [tool, "--tool", "memcheck", sys.executable,
             os.path.abspath(__file__), "--f6-loop", "1", "--no-sanitizer"],
            capture_output=True, text=True, cwd=ROOT,
            timeout=F6_SANITIZER_TIMEOUT)
        tail = (out.stdout + out.stderr).strip().splitlines()[-6:]
        print(f"[f6] compute-sanitizer memcheck, 1 round: exit "
              f"{out.returncode}; {time.perf_counter() - t0:.1f} s; last "
              f"lines: " + " | ".join(tail), flush=True)
    except subprocess.TimeoutExpired:
        print(f"[f6] compute-sanitizer memcheck, 1 round: cut at "
              f"{F6_SANITIZER_TIMEOUT:.0f} s", flush=True)


# ------------------------------------------------------------------ main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f6-loop", type=int, default=0, metavar="ROUNDS",
                    help="only loop path H1's cases ROUNDS times with "
                         "CUDA_LAUNCH_BLOCKING=1 and a sync after every "
                         "launch (no result line)")
    ap.add_argument("--no-sanitizer", action="store_true",
                    help="with --f6-loop: skip the compute-sanitizer round")
    ap.add_argument("--f7-probe", action="store_true",
                    help="only run F7's probe, the two all-gather entry "
                         "points that end gloo ranks on CUDA tensors "
                         "included (no result line)")
    ap.add_argument("--k1", action="store_true",
                    help="only run path K1, rwkv6-3b's training steps "
                         "timed and profiled, on the package beside this "
                         "script (no result line)")
    ap.add_argument("--adamw", action="store_true",
                    help="only run path N, the AdamW kernels at the "
                         "benchmark's leaves and ragged sizes, and "
                         "train() at I1's size (no result line)")
    ap.add_argument("--flash", action="store_true",
                    help="only run path M (the flash-attention kernels) "
                         "and the LM runs whose attention it takes or "
                         "leaves: I1, I2, L1-L4 and K2 (no result line)")
    args = ap.parse_args()
    if args.f6_loop:
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"   # before CUDA starts
    require(torch.cuda.is_available(),
            "no CUDA device: nothing to check, no result")
    if args.f6_loop:
        torch.backends.cuda.matmul.allow_tf32 = False
        f6_loop(args.f6_loop, sanitize=not args.no_sanitizer)
        return
    if args.f7_probe:
        j2_probe(card_line(), faults=True)
        return
    if args.k1:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        _build.build_all((*SCAN_KERNELS, "adamw"))
        path_k1(torch.device("cuda"), card)
        return
    if args.flash:
        flash_paths()
        return
    if args.adamw:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(f"[card] {card}; torch {torch.__version__}", flush=True)
        path_n(card)
        return

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls on")
    device = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc.stdout.strip().splitlines()[-1]}; "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")

    # ---- the centralized collab path: host tables, then the card
    t0 = time.perf_counter()
    g = dataset_like("collab", scale=1.0, seed=0).gcn_normalize()
    plan_c = plan_execution(g, "centralized", sample=SAMPLE)
    print(f"[host] collab scale 1.0: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"F={g.feature_len}; host set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = gnn.GNNConfig(in_dim=g.feature_len, hidden_dims=(HIDDEN,),
                        out_dim=OUT, sample=SAMPLE)
    params = gnn.init_params(cfg, seed=0, device=device)
    x1 = torch.from_numpy(plan_c.feats[0]).to(device)
    nbr = torch.from_numpy(plan_c.neighbors[0]).to(device)
    wts = torch.from_numpy(plan_c.weights[0]).to(device)
    z1 = csr_aggregate_ref(x1, nbr, wts)    # layer 1's Z
    x2 = torch.clamp_min(z1 @ params[0]["w"], 0.0)   # layer 2's input
    wts_zero = wts.clone()
    wts_zero[::97] = 0.0                    # zero-degree rows
    errs = {k: 0.0 for k in KERNELS}
    kernel_checks(x1, x2, nbr, wts_zero, params, device, errs)
    new_kernel_checks(z1, params[0]["w"], device, errs)
    wide_deep_checks(x1, nbr, wts_zero, device, errs)
    small_shape_checks(device, errs)

    # ---- the paths, counted
    totals = {k: 0 for k in ALL_KERNELS}
    serve_cases(plan_c, cfg, ("alltoall",), device, True, totals)
    t0 = time.perf_counter()
    g01 = dataset_like("collab", scale=0.1, seed=0).gcn_normalize()
    plan_d = plan_execution(g01, "decentralized", sample=SAMPLE,
                            n_clusters=8)
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_s = plan_execution(g01, "semi", sample=SAMPLE, n_clusters=4,
                            spokes_per_head=4)
    print(f"[host] collab scale 0.1: {g01.n_nodes} nodes; decentralized "
          f"8-cluster plan {t_d:.1f} s, semi 4x4 plan "
          f"{time.perf_counter() - t0:.1f} s (host set-up)", flush=True)
    serve_cases(plan_d, cfg, ("allgather", "alltoall"), device, True, totals)
    serve_cases(plan_s, cfg, ("alltoall",), device, True, totals)
    builds = path_a(device, totals)
    path_b(device, g01, totals)
    path_c1(g01, device, totals)
    path_c2(device, totals)

    # ---- path H: the SPMD runtime, on the pristine collab 0.1 plans
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    h_totals = {k: 0 for k in ALL_KERNELS}
    path_h(g01, plan_d, plan_s, cfg, params, device, h_totals, card)
    print(f"[pathH] launches over path H {json.dumps(h_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(h_totals[k] > 0 for k in PATH_H),
            "a kernel of path H never launched")
    for k, v in h_totals.items():
        totals[k] += v

    # ---- path D: streaming serving, then the traced refresh
    t0 = time.perf_counter()
    d_totals = {k: 0 for k in ALL_KERNELS}
    path_d1(plan_c, cfg, params, device, d_totals)
    plan_b = plan_execution(g01, "decentralized", sample=SAMPLE,
                            n_clusters=16, partition_method="edge",
                            buckets="auto")
    path_d2({("decentralized 8", "allgather"): plan_d,
             ("decentralized 8", "alltoall"): plan_d,
             ("semi 4x4", "alltoall"): plan_s,
             ("C1 bucketed 16", "alltoall"): plan_b},
            g01, cfg, params, device, d_totals)
    print(f"[pathD] launches over path D {json.dumps(d_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(d_totals[k] > 0 for k in PATH_D),
            "a kernel of path D never launched")
    for k, v in d_totals.items():
        totals[k] += v
    trace_refresh(plan_c, cfg, params, device)

    # ---- path E: launch choices, tuning, calibration, the CLI's report
    path_e1(x1, x2, nbr, wts, params, plan_b, device, card)
    reset_launch_counts()
    path_e2(plan_c, plan_b, cfg, params, device, card)
    path_e3(plan_c, cfg, device, card)
    e_totals = launch_counts()
    print(f"[pathE] launches over E2 and E3 {json.dumps(e_totals)}",
          flush=True)
    require(all(e_totals[k] > 0 for k in KERNELS),
            "a kernel of path E never launched")
    for k, v in e_totals.items():
        totals[k] += v
    path_e4(device)

    # ---- path F: the planner, the load loops with its monitor, re-plans
    t0 = time.perf_counter()
    f_totals = {k: 0 for k in ALL_KERNELS}
    path_f1(g)
    path_f2(g01, plan_d, plan_s, cfg, params, device, f_totals)
    path_f3(g01, cfg, params, device, f_totals)
    path_f4(g01)
    print(f"[pathF] launches over path F {json.dumps(f_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(f_totals[k] > 0 for k in PATH_F),
            "a kernel of path F never launched")
    for k, v in f_totals.items():
        totals[k] += v

    # ---- path G: training, checkpoints, the taxi case study
    t0 = time.perf_counter()
    reset_launch_counts()
    ms_g1 = path_g1(plan_c, x1, nbr, wts, g01, device)
    ms_g2 = path_g2(device)
    g_totals = launch_counts()
    print(f"[pathG] ms per training step (host clock between device syncs, "
          f"median after the first): G1 collab 1.0 {ms_g1:.3f}, G2 taxi "
          f"{TAXI_STATS.n_nodes} nodes {ms_g2:.3f}; {card}", flush=True)
    path_g3()
    print(f"[pathG] launches over path G {json.dumps(g_totals)}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    require(all(g_totals[k] > 0 for k in PATH_G),
            "a kernel of path G never launched")
    for k, v in g_totals.items():
        totals[k] += v
    print(f"[paths] launches over all path runs {json.dumps(totals)}",
          flush=True)
    require(all(totals[k] > 0 for k in KERNELS),
            "a kernel of the paths never launched")

    # ---- path I: the LM stack, which launches none of the six kernels
    torch.cuda.empty_cache()
    i1 = path_i(device, card)

    # ---- path J: the LM stack on a mesh, and the dry run; none of the six
    path_j(device, card, i1)
    del i1

    # ---- path K: the scan kernels on the recurrent architectures
    k_rec = path_k(device, card)

    # ---- path L: four more architectures served at full size, and the
    # windows and the latent cache decoded past their edge
    path_l(device, card)

    # ---- path M: the flash-attention kernels
    m_rec = path_m(card)

    # ---- path N: the AdamW kernels
    n_rec = path_n(card)

    # ---- times at layer 1 and layer 2 of the centralized path
    rec1 = timings(x1, nbr, wts, params[0], "layer1 496->64", iters=10)
    timings(x2, nbr, wts, params[1], "layer2 64->16", iters=20)
    wide_deep_timings(x1, nbr, wts, params[0], z1, device)
    rec1.update(new_timings(z1, params[0]["w"],
                            csr_aggregate_ref(x2, nbr, wts), params[1]["w"],
                            device, builds))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=totals[name],
                            max_abs_err=errs[name], **rec1[name]))
    for name, (source, replaces) in SCAN_KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **k_rec[name]))
    kernels.append(dict(name="flash_attention", route="cuda",
                        source="src/repro_torch/csrc/flash_attention.cu",
                        replaces="src/repro/models/attention.py "
                                 "chunked_attention (no Pallas kernel)",
                        timings=m_rec["timings"], host=m_rec["host"]))
    kernels.append(dict(name="adamw", route="cuda",
                        source="src/repro_torch/csrc/adamw.cu",
                        replaces="src/repro/optim/adamw.py adamw_update "
                                 "(no Pallas kernel)", **n_rec))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
