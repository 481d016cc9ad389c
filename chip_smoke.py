#!/usr/bin/env python3
"""Drive the PyTorch port's GCN serving, GCN training, the paper's
partitioner comparison, Proteins training, LM serving, the sync and stale
training modes, the traced, checkpointed and profiled main path, the
serving commands (``replay``, ``serve``, ``client``), the kernel
autotuner, the compiled steps (CUDA graphs) and
``repro_torch.launch.train`` (the GNN workload and LM training, qwen3_4b
at full width), the MoE family (qwen2_moe_a2p7b served at full width,
trained reduced), the SSM and hybrid families (xlstm_125m and
zamba2_1p2b served and trained at full width), deepseek_v2_236b (MLA,
a leading dense layer, 160 routed experts: served at full width and cut
depth, its experts placed by Leiden-Fusion, trained reduced) and the
enc-dec and VLM families (seamless_m4t_large_v2 and phi3_vision_4p2b
served at full width and depth, trained reduced; kernel D at D 96) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and register use, and
   the tensor-core (HMMA) instructions in kernel D's SASS (``cuobjdump``;
   there must be some);
3. serving main path at ogbn-arxiv scale (169,343 nodes, 128 features, 40
   classes): Leiden-Fusion with k = 8 (repli), a 3-layer 128-wide GCN and a
   256-wide classifier with seeded weights, pooled table, bundle export and
   load, ``warmup()``, then 2,000 Zipf queries with 10% unseen nodes. Every
   known-node answer must equal the offline key, and kernels A and B must
   have launched during this run. The serving buckets run as captured CUDA
   graphs: warmup compiles 2 a bucket (classify, inductive), 14, and the
   replay none (``steady_state_recompiles`` 0). The partition goes
   through an artifact cache that phases 5 and 14 hit;
4. checks: the inductive logits of one batch against the plain path on the
   same batch; the inference pipeline on karate on the card against the
   plain CPU path;
5. training main path, same configuration, through ``run_training``: 8 GCN
   replicas trained locally for 60 epochs (dropout 0.3, lr 5e-3), the
   classifier for 150, the trained bundle served with the same replay and
   exact-match gate. The stacked step runs as one captured CUDA graph (one
   compile), and the launch counts are the replays'. Kernels A (backward)
   and B (forward) must have launched during training, and the trained
   test accuracy must beat both chance and the seeded run's;
6. training on the card against the CPU path from the same initial
   parameters with dropout 0, k = 4: karate GCN for 60 epochs; arxiv-like
   at 2,000 nodes for 20 epochs with GCN, SAGE, GCN ``low_memory``, GCN
   ``integrate`` model_avg and ensemble; proteins-like at 2,000 nodes
   (multilabel) for 20 epochs with GCN and SAGE; arxiv-like at 2,000
   nodes in sync and in stale(2) mode, GCN, 20 epochs. Through
   ``repro_torch.tools.training_parity.compare_training``: per-epoch
   losses within 1e-4 over the whole run (SAGE on arxiv-like: over the
   first 2 epochs) and the pooled table after 2 epochs within 1e-3 (abs +
   rel). Sums run in another order on the card, and the difference
   compounds through every AdamW step: after 20 epochs the table moves by
   75-81x that tolerance under any legitimate change of rounding (an f64
   product, a reversed-chunk f32 product), and SAGE's losses on arxiv-like
   by 2.0-2.4x at epochs 6-7, so those are printed, not held (ROADMAP
   C.1). Kernels A and B (and, in sync and stale, the exchange's backward)
   must launch in every card run;
7. gradients at the main path's largest partition: both kernels'
   ``autograd.Function``s against autograd of the plain forward, and one
   backward of the whole GCN with arc-weight gradients, the path of its
   own that launches kernel C (main-path training keeps the arc weights
   fixed, so its ``edge_dot`` launches are 0; the ``kernels`` line gives
   this phase's count as ``launches_arc_weight_backward_phase``);
8. each kernel against its plain version at the main path's shapes, with
   its time (CUDA events, median of 30), the plain version's time, a
   PyTorch library call's time where one computes the same function, and
   the bound: the larger of bytes moved over 3.35 TB/s and operations over
   67 TFLOP/s (H100 SXM f32 without tensor cores, published peaks at
   700 W). Kernels B (``need_agg``) and A over the
   reversed arcs also run on each of the 8 partitions, whose weight-0
   padding arcs (6 to a third of the arcs) sit in one row: error, two
   calls bitwise equal, time, bound, and for A ``torch.sparse.mm``; their
   ``kernels`` rows give the partition with the most padding arcs and the
   launch-weighted mean beside the light partition. Kernel C runs on the
   largest partition and on the one with the most padding arcs: error,
   two calls bitwise equal, device time per call (``torch.profiler``) and
   one device launch a call, beside its CUDA-event time. Then a profile of two
   eager training epochs (device time by kernel and by launch, device busy
   share, and each kernel's device launches per wrapper call, counted
   there) and of one AdamW step (its launches);
9. LM serving main path: ``repro_torch.launch.serve.serve`` on full-width
   ``qwen3_4b`` (36 layers, bf16, weights seeded on the card), 8 requests,
   prompts of 64-1024 tokens in pow2 buckets, 32 new tokens. Logits must
   be finite and kernel D must have launched 36 x 32 x (buckets) times,
   from one captured decode graph a bucket (``decode_compiles``).
   Then one decode step of a seeded prefill of the largest bucket, once
   through kernel D and once through its plain version, and a profile of
   4 decode steps (device ms: kernel D, cuBLAS, the rest; idle share; one
   kernel D device launch per wrapper call);
10. long-cache decode: the same model, 4 sequences in a 32,768-slot cache
   of seeded noise at lengths 0, 4,095, 20,000 and 32,760, 8 decode steps
   (the last writes slot 32,767 and attends to the full cache); the first
   step's logits, kernel against plain;
11. kernel D against its plain version, timed, at the serving run's
   largest bucket (its 1-3 rows at their first decode step, cache 1,056:
   where phase 9's launches are), at the decode_32k layer shape (B 128, S
   32,768, H 32, Hkv 8, D 128) in bf16 and (B 16) in f32, and at
   long_500k's sliding ring (B 1, S 8,192). Each case also gives the
   device time per call (``torch.profiler``) beside the CUDA-event time,
   and must show one device launch per call, two calls bitwise equal and
   one allocation per call (its output);
12. the paper's partitioner comparison: arxiv-like at 40,000 nodes (128
   features, 40 classes), k = 8, repli, for random, lpa, metis, lpa+f,
   metis+f and leiden_fusion in turn: the partition on the host through
   the artifact cache (wall seconds), its report (cut, components,
   isolated nodes, balance, replication), the 3 x 128 GCN trained for 60
   epochs on the card (dropout 0.3, lr 5e-3) and the classifier for 150;
   one row per method, and the phase's wall seconds. Every run's losses
   must be finite and kernels A and B must launch in it; lpa+f, metis+f
   and leiden_fusion must give one component and no isolated node in
   every part (the paper's guarantee on a connected graph). On the random
   and LPA partitions (isolated nodes, many halo rows, another e_pad)
   kernels B and A are held against their plain versions on every
   partition, as in phase 8, and timed beside their bound, their plain
   version and ``torch.sparse.mm``;
13. proteins-like at its default (6,000 nodes, 112 binary tasks, average
   degree 80), k = 8, GCN and SAGE for 60 epochs: the test mean ROC-AUC
   must beat 0.5 and the seeded, untrained run's;
14. the paper's communication-vs-accuracy frontier at the main path's
   configuration (phase 5's partition, from the cache, which gains the
   halo plan): sync (the halo exchange before every layer of every step)
   and stale(4) (every 4th epoch), 60 epochs and the classifier, beside
   phase 5's local run, each step a captured graph (sync 1 compile,
   stale(4) 2: "exchange" and "stale"). Per mode: exchange epochs, the reference's
   collective bytes a step and an epoch beside the schedule's count, the
   live exchange MB a layer, ms per epoch, test accuracy. Gates: finite
   losses; kernels A, B and the exchange's backward (kernel A) launched in
   every run; the exchange on all 60 epochs in sync and on stale(4)'s 15
   only; bytes sync > stale(4) > local = 0; sync's test accuracy above
   chance and the seeded run's; two sync steps from one state bitwise
   equal; the exchange's forward equal to plain indexing and its backward
   within 3e-5 of autograd's (against the sum of absolute terms), timed
   beside its bound, its plain version and ``index_add_``;
15. the traced main path: phase 5's configuration (its partition from the
   cache) run again with ``repro_torch.obs`` tracing on and a checkpoint
   directory, then 2 epochs at the same width under ``torch.profiler``,
   then ``repro_torch.tools.obs_overhead``. Gates: the exported trace
   passes ``validate_trace`` with the dataset, partition, train and
   classifier stages; 60 ``train.epoch`` spans and ``train.epochs`` 60;
   every stage timing equal to its span's duration; CUDA peak memory above
   0; tracing changes no output (the pooled table and the losses bitwise
   equal to phase 5's untraced run, the accuracy equal); the checkpoint
   (``step_00000060``, one ``arr_*.npy`` per leaf) restored into freshly
   seeded parameters on the card gives the table bitwise; the profile
   names kernel B's product and kernel A's gather and fix-up; the
   projected disabled-mode overhead is under 1% of the untraced wall.
   Prints ms per epoch untraced and traced, the sum of the epoch spans,
   the 10 hottest spans, the checkpoint's bytes and save and restore
   seconds, and the projected overhead;
16. serving's command surface, through ``repro_torch.serving.cli.main``
   at the main path's configuration (phase 5's partition, from the
   cache): ``replay`` into an empty bundle dir (a miss: it trains and
   exports), then the same command (a hit), 10,000 Zipf queries at 2%
   unseen each, with ``--bench-json``; ``replay --method metis --bundle``;
   ``make_server`` on port 0 in a thread, the port's ``client`` over 8
   connections (2,000 queries), 512 known and 16 inductive queries over 8
   connections; kernel A at the buckets the hit replay used, with its
   device us per call (``torch.profiler``); then the hit's 10,000 queries
   replayed on the bundle eagerly and captured, in turns (eager,
   captured, captured, eager): qps, p50, p99, equal answers. Gates: the miss exports and
   launches kernels A and B, the hit launches no kernel B and kernel A
   exactly warmup's 7 plus one per inductive flush; 0 mismatches and 1
   degraded answer per replay; every row's ``warm_compiles`` 14 and
   ``steady_state_recompiles`` 0; 2 bench rows carrying the card's name and
   power limit; the bundle under ``metis``'s fingerprint raises
   ``StaleServingArtifact``; every TCP label equal to the offline key,
   the no-neighbour query degraded; more than one query per flush over
   the server's life (batching across connections); the server thread
   joined within 10 s. Prints ms and qps of each step;
17. the kernel autotuner (``repro_torch.kernels.autotune``) at the main
   path's bucket, ``n131072_e524288_f128`` (phase 5's partition, from the
   cache): (a) each of its 20 candidates (kernel B at row tiles 32, 64 and
   128, kernel A then cuBLAS, each at items 0, 16, 32, 64, 128) against
   the plain version, the forward and the gradients in (h, W, b) at 3e-5
   on the largest and the heaviest-padded partitions, and the row-tile
   variants bitwise equal; (b) ``autotune`` on the 8 partitions' own
   arcs: every candidate's ms (a layer's forward + backward over the 8,
   device clock, median of 10) and spread, the winner (the fallback unless
   a candidate beats it by more than the larger spread) and the
   fallback's ms;
   (c) a second call is a cache hit, and a subprocess resolves the same
   winner from the cache file; (d) ``run_training`` at phase 5's
   configuration with ``kernel_autotune``: its stage is a cache hit, its
   report names the winner, the winner's kernels launch (kernel B for
   ``cuda_fused``; kernel A and no kernel B for ``cuda``), test accuracy
   within 0.01 of phase 5's, ms per epoch beside phase 5's (not gated);
   (e) its bundle replayed (2,000 queries, 10% unseen) with 0 mismatches;
   (f) kernel B at each row tile and kernel A over the reversed arcs at
   each ``items`` on the 8 partitions: CUDA-event ms, device ms, bound;
18. compiled steps against the eager loop (``capture=False``): (a) 3
   epochs of phase 5's configuration (dropout 0.3) and 3 of stale(4), each
   captured and eager from one initialisation: losses, parameters, table,
   exchanges and kernel launches bitwise equal; (b) the local, sync and
   stale steps timed in turns (eager, captured, captured, eager; host
   clock, 10 steps each, synchronized) and profiled (3 steps each): ms an
   epoch, device idle share, device kernels and host launches a step
   (``cudaLaunchKernel``, ``cudaGraphLaunch``, copies and sets, from the
   profile's runtime records); (c) phase 9's LM (re-seeded): 32 decode
   steps of its largest bucket captured and eager from copies of one
   prefill (every token and the caches equal), tokens/s over the steps
   after the capture, a 4-step profile of each, and ``serve`` of phase 9's
   requests eagerly beside phase 9's captured report. In (b) and (c) the
   device records of kernels A, B and D that 2 steps of each path add
   (a profile of 3 steps less one of 1) must equal what the launch
   counters moved (on a captured step, the deltas
   its replays add: so the replay-aware counts that phases 3, 5, 9, 14
   and 16 gate are measured here), with both paths' counts equal and
   kernel D 36 a decode step;
19. ``python -m repro_torch.launch.train``, on both workloads
   (every earlier model and graph pool released first): (a) ``--workload
   gnn`` at the reference launcher's defaults (arxiv-like at 8,000 nodes,
   leiden_fusion, k 8, repli, GCN 3 x 128, 60 epochs, the classifier for
   150): one component and no isolated node in every part, kernels A and
   B launched (counters reset before the run, read after), test accuracy
   above chance; (b) ``--workload lm --reduced`` (qwen3_4b, f32, 2
   layers), 4 steps on the card against the same run on the CPU from the
   same weights: losses within 1e-4 relative (no TF32), and falling; 3
   captured steps of ``make_train_step`` bitwise equal to 3 eager ones
   (losses, parameters, moments), remat off and on (its recomputation
   runs inside the graph); (c) ``--workload lm --arch qwen3_4b`` at full
   width and depth (36 layers, bf16, 4.411 B seeded parameters), batch 4,
   seq 128, 10 captured steps: every loss finite, peak device memory
   below 80 GB, one graph. Prints the losses, the steady step's ms (host
   clock ending in a synchronize) and tokens/s, the step's bound (its
   products at the bf16 dense rate plus AdamW's bytes at the memory
   rate, ``lm_train_bound``) and the share of it reached, a profile of 2
   replays (cuBLAS and the rest; idle share; host launches) and one
   eager step's device ms: its gradient by the op that launched each
   kernel (cuBLAS dense products, attention, the rest), then AdamW in a
   window of its own. Each line names the card and its power limit;
20. the MoE family, ``qwen2_moe_a2p7b`` (every earlier model released
   first; the allocated GB printed at the start): (a)
   ``launch.serve.serve`` at full width (24 layers, d_model 2048, 16/16
   heads, 60 experts top-4 + 4 shared of d_ff 1408, bf16, 14.3 B seeded
   parameters) on phase 9's requests: logits finite, one decode graph a
   bucket, kernel D 24 x 32 x (buckets) launches (counters reset before,
   read after); prefill s, peak GB, and the largest bucket's ms a decode
   step and tokens/s beside the step's bound (``moe_decode_bound``: the
   bytes it must move, the routed experts its rows chose counted once,
   over 3.35 TB/s); (b) one step of that bucket through kernel D against
   the plain attention on the plain path's expert choices, at phase 9's
   bf16 tolerance, and on its own choices (printed: a bf16 rounding can
   swap a row's k-th expert); (c) that bucket's
   32 decode steps captured and eager from one prefill, tokens and caches
   bitwise equal; a 4-step profile of the captured step by kernel (kernel
   D, the experts' gather, the router's softmax and top-k, cuBLAS, the
   rest) and one eager step by op (routed ``bmm``, dense ``mm``); (d) the
   reduced family (f32, 2 layers, 4 experts top-2, 1 shared), the card
   against the CPU from the same weights: ``train_loss`` and its gradient
   at 1e-4, prefill then decode against the train forward at capacity
   factor 8 (no drops) at 1e-4; ``launch.train --workload lm --arch
   qwen2_moe_a2p7b --reduced`` on both, 4 captured steps (finite, aux
   loss > 0, one graph; the card's losses beside the CPU's, printed), and
   3 captured train steps bitwise equal to 3 eager ones; (e) kernel D at
   the MoE serving shape, G = H / Hkv = 1 (H 16, D 128, bf16), against
   its plain version, timed beside its bound and
   ``scaled_dot_product_attention``;
21. the SSM and hybrid families, ``xlstm_125m`` (12 layers alternating
   mLSTM and sLSTM, d_model 768, 4 heads, tied embeddings) and
   ``zamba2_1p2b`` (32 Mamba2 layers and one shared attention+FFN block
   applied at 6 of 38 layers, d_model 2048, H = Hkv 32, head_dim 64),
   both at full width and depth, bf16, seeded (every earlier model
   released first; the allocated GB printed at the start): (a)
   ``launch.serve.serve`` on phase 9's requests: logits finite, one
   decode graph a bucket, kernel D 6 x 32 x (buckets) launches for
   zamba2 and none for xlstm; prefill s, peak GB, and the largest
   bucket's ms a decode step and tokens/s beside the step's bound
   (``ssm_decode_bound``: each layer application's weights, the shared
   block once per application, the head, the K/V cache and each state
   read and written, over 3.35 TB/s); (b) zamba2's step through kernel D
   against the plain attention, each from a fresh copy of the prefill's
   cache, at phase 9's bf16 tolerance; (c) 32 decode steps of that bucket
   captured and eager from one prefill, tokens, every step's logits and
   every cache leaf (K/V and each recurrent state) bitwise equal, and a
   4-step profile of the captured step by kernel (kernel D, cuBLAS,
   copies, reductions, elementwise, the rest; idle share, kernels a
   step); (d) the reduced families (f32; zamba2 at 6 layers, so that one
   ``shared_attn`` is present), the card against the CPU from the same
   weights: ``train_loss`` and its gradient at batch 4 x 160, prefill
   then decode against the train forward, at 1e-4; (e) ``launch.train
   --workload lm`` at full width, batch 4 x 256 (two 128-token chunks),
   3 captured steps (finite, one graph, peak under 80 GB), the same 3
   steps eager bitwise equal, the step's ms, tokens/s and bound
   (``ssm_train_bound``), and the last eager step's device split
   (cuBLAS, the chunked scan, the sLSTM loop, AdamW, the rest; backward
   kernels given to the forward op's part by autograd sequence number,
   ``ssm_step_split``); (f) kernel D
   at zamba2's serving shape, D 64, G 1 (H = Hkv 32, bf16), against its
   plain version, timed beside its bound and
   ``scaled_dot_product_attention``;
22. deepseek-v2 and expert placement, ``deepseek_v2_236b`` at its
   published width (d_model 5,120, 128 heads, q/kv LoRA 1,536/512,
   nope/rope/v 128/64/128, 160 routed experts top-6 + 2 shared of d_ff
   1,536, a dense layer 0 of d_ff 12,288, vocab 102,400, bf16, seeded),
   its depth cut from 60 to ``DEEPSEEK_LAYERS`` (one card holds no more
   beside prefill; every earlier model released first): (a)
   ``launch.serve.serve`` on phase 9's requests: logits finite, one
   decode graph a bucket, no prefill graph, kernel D 0 launches (MLA
   decode is plain products, as in the reference); peak GB and the
   latent cache's bytes a token a layer beside the expanded K/V's; the
   largest bucket's decode step bound (``mla_decode_bound``); (c) that
   bucket's 32 decode steps captured and eager from one prefill, tokens
   and every ckv/krope leaf bitwise equal, ms a step and a profile of
   each by kernel (cuBLAS, gather, the rest); (d) MoE layer 1's top-6
   choices for every prompt token of that bucket
   (``expert_placement.router_top_k``), 160 experts placed on 8 shards
   by ``lf_expert_placement`` (20 a shard), its cost beside the
   contiguous placement's and its wall seconds; every MoE layer permuted
   by it, one decode step: the same argmax tokens, logits within
   ``LM_BF16_TOL`` of the unpermuted model's; (e) ``launch.train
   --workload lm --arch deepseek_v2_236b --reduced``, 4 steps: one
   captured graph, the loss finite and falling; (b) last, on a 2-layer
   copy (layer 0 dense, layer 1 MoE) at full width: one decode step of
   the largest bucket with bf16 weights, on the f32 step's expert
   choices, against the same step with the weights in f32 at
   ``LM_BF16_TOL`` (on its own choices printed), and MLA's absorbed
   decode against the expanded form over each layer's cache in f32
   within ``MLA_RTOL`` of the largest output;
23. the enc-dec and VLM families at published width and depth, bf16,
   seeded: (a) ``seamless_m4t_large_v2`` (24 encoder and 24 decoder
   layers, d_model 1,024, 16 heads, d_ff 8,192, GELU with biases,
   LayerNorm, vocab 256,206) through ``launch.serve.serve`` on phase 9's
   requests, the stub frames drawn after each bucket's tokens: logits
   finite, one decode graph a bucket, no prefill graph, kernel D 24
   launches a step; peak GB; at the largest bucket kernel D against the
   plain attention (``kernel_vs_plain_step``) and the step's bound
   (``frontend_decode_bound``); (c) that bucket's 32 decode steps
   captured and eager from one prefill, tokens, logits and every cache
   leaf (``memory`` too) bitwise equal, ms a step, the captured step's
   profile by kernel (cuBLAS, kernel D, the rest) and the eager step's
   device time with the cross-attention's kernels apart (a profiler range
   around each call, ``eager_cross_split``); the same for
   ``phi3_vision_4p2b`` (32 layers, d_model 3,072, 32 = 32 heads of D 96,
   SwiGLU d_ff 8,192, 576 patch tokens) on 4 requests of 577-1,024
   tokens, all in the 1,024 bucket (a shorter bucket fails in the
   reference), kernel D 32 launches a step; (b) a 128-token
   phi-3-vision prompt raises ``ValueError`` (``num_patch_tokens``); (d)
   kernel D alone at phi-3-vision's decode shape (D 96, bf16), at D 96
   in f32 (B 16, S 32,768, decode_32k's heads) and at seamless's decode
   shape (D 64, G 1), each against its plain version, bitwise
   repeatable, timed beside its bound and
   ``scaled_dot_product_attention``; (e) both families ``launch.train
   --reduced``, 4 steps: one captured graph, the loss finite and falling;
   and the reduced model (f32) on the card against the CPU (``train_loss``
   and its gradient, prefill then a decode step against the train
   forward) within ``FRONTEND_TOL``.

The script points ``REPRO_TORCH_AUTOTUNE_CACHE`` at a file in a temporary
directory of its own, so no user cache reaches a phase: phases 1-16
resolve the fallback (phase 5's report must name ``cuda_fused``, row tile
64, items 0) and keep their launches.

Kernels are held against their plain versions at 3e-5 (abs + rel). Where
an output is a sum whose terms cancel (dot products, transposed sums, the
gradients), "rel" is taken against the same sum of absolute terms, the
scale of f32 rounding error, rather than against the result.

Kernel D is held at the reference's bf16 tolerance, 2e-2 (abs + rel), in
bf16, and at 3e-5 against its sum of absolute terms in f32. The LM's
logits, kernel path against plain path, are held in bf16 to 0.1 of the
largest logit (max difference) and 0.1 of the logits' rms (rms
difference): the two attention outputs differ by a bf16 rounding here and
there, and 36 bf16 layers carry that on. Each comparison also prints the
floor, the plain path against itself with the scale applied in the
reference kernel's order (the same function, other roundings); on the
card the floor was 3.5% (max) and 2.8% (rms), kernel against plain 3.8%
and 3.9%. The same step on an f32 copy of the weights is held at 1e-4
(abs + rel), as the CPU parity tests hold f32 logits. Matmuls run with
``allow_tf32`` and ``allow_bf16_reduced_precision_reduction`` off, so the
paths differ only in attention.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without a GPU, or without
the rest of the repository beside it, it exits non-zero before any result.
"""
import argparse
import contextlib
import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = dict(rtol=3e-5, atol=3e-5)
ARXIV_SCALE = 169343 / 40000
QUERIES = 2000
MAX_NEIGHBORS = 32
BF16_TOL = 2e-2        # kernel D in bf16, abs + rel
LM_BF16_TOL = 0.1      # LM logits kernel vs plain, bf16: max and rms
LM_F32_TOL = 1e-4      # the same in f32, abs + rel
LM_ARCH = "qwen3_4b"
LM_TRAIN_RTOL = 1e-4   # the reduced LM's losses, card against CPU, f32
BF16_OPS_PER_S = 989e12
GEMM_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "sm90")
MOE_ARCH = "qwen2_moe_a2p7b"
MOE_TOL = 1e-4         # the reduced MoE, card against CPU, f32 (abs + rel
                       # for logits; of each leaf's largest for gradients)
SSM_ARCHS = ("xlstm_125m", "zamba2_1p2b")
SSM_TOL = 1e-4         # the reduced SSM/hybrid, card against CPU, f32 (as
                       # MOE_TOL)
# device kernels of an SSM/hybrid decode step by name, first match wins
SSM_KERNELS = (("kernel D", ("flash_decode",)),
               ("cuBLAS products", GEMM_NAMES + ("gemv", "splitk")),
               ("copies (state writes, concatenation)", ("copy", "cat")),
               ("reductions (norms, sums)", ("reduce",)),
               ("elementwise (gates, state updates, casts)",
                ("elementwise",)))
# device kernels of an MoE decode step by name, first match wins
MOE_KERNELS = (("kernel D", ("flash_decode",)),
               ("router softmax / top-k", ("softmax", "topk", "radix",
                                           "sort", "kth")),
               ("gather (expert weights, embedding rows)",
                ("indexselect", "index_elementwise", "gather")),
               ("cuBLAS products", GEMM_NAMES + ("gemv",)))
DEEPSEEK_ARCH = "deepseek_v2_236b"
# 60 layers cut to this depth: 8 full-width layers hold 29.19 B
# parameters, 58.4 GB in bf16, and leave room for prefill on one 80 GB card
DEEPSEEK_LAYERS = 8
PLACEMENT_SHARDS = 8
MLA_RTOL = 1e-4        # absorbed MLA decode against the expanded form, f32,
                       # of the largest output
# device kernels of an MLA/MoE decode step by name, first match wins
MLA_KERNELS = (("cuBLAS products", GEMM_NAMES + ("gemv", "splitk")),
               ("gather (expert weights, embedding rows, cache rows)",
                ("index", "gather", "scatter")))
ENCDEC_ARCH = "seamless_m4t_large_v2"
VLM_ARCH = "phi3_vision_4p2b"
FRONTEND_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
FRONTEND_TOL = 1e-4    # the reduced enc-dec / VLM, card against CPU, f32
                       # (as MOE_TOL)
# device kernels of an enc-dec / VLM decode step by name, first match wins
FRONTEND_KERNELS = (("kernel D", ("flash_decode",)),
                    ("cuBLAS products", GEMM_NAMES + ("gemv", "splitk")))
# the profiler range around each cross-attention call (phase 23)
CROSS_RANGE = "phase23.cross_attention"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def time_ms(fn, iters=30, warmup=3):
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, name, calls=20):
    """(device us per launch, device launches per call) of the kernels
    whose name holds ``name``, over ``calls`` calls under
    ``torch.profiler`` (``repro_torch.tools.kernel_turns.device_us``):
    the kernel's own time, without the wrapper's host work that CUDA
    events around a call also hold. A window on the card has lost records
    (its first, sometimes more, once all of three windows in a row); the
    helper opens each window with a kernel of its own and keeps the best
    of up to eight, and the launches a call are a lower bound: this fails
    on none, or on more records than calls (more than one launch a call).
    Phase 9's decode profile counts kernel D's launches exactly."""
    from repro_torch.tools.kernel_turns import device_us as profiled
    us, per_call = profiled(fn, (name,), calls)
    check(0 < per_call <= 1, f"{per_call} {name} launches a call over "
                             f"{calls} calls (one expected)")
    return us, per_call


def repeatable(fn, what):
    """Fails unless two calls give bitwise-equal outputs."""
    import torch
    first, second = fn(), fn()
    check(torch.equal(first, second), f"{what}: two calls differ")
    return True


def tensor_core_instructions(lib):
    """HMMA instructions in a library's SASS by the toolkit's
    ``cuobjdump``; None where it is not found."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def bound_ms(nbytes, ops):
    """(bound in ms, what bounds it) for the given bytes and f32 ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def layer_bound(nn, f, fo, e, e_live, need_agg):
    """Kernel B's bound: h, the arcs, row_ptr, inv, W, b read once, out
    (and agg) written once; the live arcs' FMAs, the scale, the product
    and the epilogue at the f32 rate (the product stays off the tensor
    cores: see csrc/fused_layer.cu)."""
    nbytes = 4 * (nn * f + 2 * e + (nn + 1) + nn + f * fo + fo + nn * fo
                  + (nn * f if need_agg else 0))
    return bound_ms(nbytes,
                    2 * e_live * f + nn * f + 2 * nn * f * fo + nn * fo)


def transpose_bound(nn, f, e, rev_live):
    """Kernel A over the reversed arcs: g, the arcs and row_ptr read once,
    dh written once; the live arcs' FMAs at the f32 rate."""
    return bound_ms(4 * (nn * f + 2 * e + (nn + 1) + nn * f),
                    2 * rev_live * f)


def max_err(out, ref, scale=None, what="kernel"):
    """Max abs error; fails unless |out - ref| <= atol + rtol*scale, with
    ``scale`` = |ref| unless a sum of absolute terms is given."""
    import torch
    check(bool(torch.isfinite(out).all()), f"non-finite {what} output")
    diff = (out - ref).abs()
    scale = ref.abs() if scale is None else scale
    check(bool((diff <= TOL["atol"] + TOL["rtol"] * scale).all()),
          f"{what} disagrees with its plain version: max abs err "
          f"{float(diff.max())}")
    return float(diff.max())


def replay_trained_bundle(result, cfg, dev, label):
    """Load the run's bundle, replay the Zipf workload, gate exact match.
    Returns (replay row, batcher, workload, store)."""
    import torch
    from repro_torch.pipeline.datasets import graph_fingerprint
    from repro_torch.serving.batcher import ContinuousBatcher
    from repro_torch.serving.cache import LruNodeCache
    from repro_torch.serving.replay import make_zipf_workload, run_replay
    from repro_torch.serving.store import EmbeddingStore, classify
    store = EmbeddingStore.load(
        result.serving_path, device=dev,
        expect_fingerprint=result.spec.fingerprint(),
        expect_graph=graph_fingerprint(result.dataset.graph))
    batcher = ContinuousBatcher(store, cache=LruNodeCache(512),
                                max_batch=64, max_wait_ms=2.0,
                                max_neighbors=MAX_NEIGHBORS)
    workload = make_zipf_workload(store.n, num_queries=QUERIES,
                                  unseen_frac=0.1,
                                  max_neighbors=MAX_NEIGHBORS, seed=0)
    row = run_replay(batcher, workload, verify=False)
    torch.cuda.synchronize()
    print(f"{label} replay: {json.dumps(row, sort_keys=True)}")
    if row["label_mismatches"]:
        ids = torch.as_tensor(row["mismatched_nodes"], device=dev)
        top2 = classify(store.classifier,
                        result.embeddings[ids]).topk(2).values
        print(f"mismatched nodes {row['mismatched_nodes']}: offline logit "
              f"margins {(top2[:, 0] - top2[:, 1]).tolist()}")
    check(row["label_mismatches"] == 0,
          f"{label}: {row['label_mismatches']} of {row['known_queries']} "
          f"known-node answers differ from the offline key")
    check(row["served_by_source"].get("degraded") == 1,
          f"{label}: the zero-neighbour query did not degrade")
    compiles_gate(row, label)
    return row, batcher, workload, store


def compiles_gate(row, label, max_batch=64):
    """The replay's compiles: warmup captures classify and the inductive
    program at every bucket, the steady state none."""
    from repro_torch.serving.batcher import bucket_sizes
    want = 2 * len(bucket_sizes(max_batch))
    check(row["warm_compiles"] == want
          and row["steady_state_recompiles"] == 0,
          f"{label}: warm_compiles {row['warm_compiles']} (expected {want}),"
          f" steady_state_recompiles {row['steady_state_recompiles']}")


def star_graph_case(inductive, unseen, b, launches_per_call=None):
    """Kernel A on the inductive fallback's bucket-``b`` star graph (the
    first ``b`` of the ``unseen`` neighbour lists): error against its plain
    version, CUDA-event ms of it, the plain version and ``torch.sparse.mm``,
    the bound. Given its device ``launches_per_call`` (phase 8's profile
    counts them exactly), also its device us per call: the mean device us
    of a launch over 20 calls (``torch.profiler``) times that count, since
    a window may lose records; more records than launches fail."""
    import torch
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import ops
    dev = inductive.store.device
    emb_dim, m = inductive.store.embed_dim, inductive.max_neighbors
    nb_emb, nb_mask, _ = inductive.prepare(unseen[:b], b)
    src, dst, row_ptr = inductive.star(b)
    hs = torch.cat([torch.zeros((b, emb_dim), device=dev),
                    nb_emb.reshape(b * m, emb_dim)])
    ws = nb_mask.reshape(-1).contiguous()
    invs = ops.inv_degree(torch.cat([nb_mask.sum(dim=1),
                                     torch.ones(b * m, device=dev)]))
    rows, arcs = b * (1 + m), b * m
    out = kernel_a.launch(hs, src, row_ptr, ws, invs)
    err = max_err(out, kernel_a.plain(hs, src, dst, ws, rows, invs))
    sp = torch.sparse_csr_tensor(row_ptr, src, ws * invs[dst.long()],
                                 size=(rows, rows), check_invariants=True)
    live = int((ws > 0).sum())
    bound, by = bound_ms(
        4 * (rows * emb_dim + 2 * arcs + (rows + 1) + rows + rows * emb_dim),
        2 * live * emb_dim + rows * emb_dim)
    case = dict(
        ms=time_ms(lambda: kernel_a.launch(hs, src, row_ptr, ws, invs)),
        plain_ms=time_ms(lambda: kernel_a.plain(hs, src, dst, ws, rows,
                                                invs)),
        library_ms=time_ms(lambda: torch.sparse.mm(sp, hs)),
        live=live)
    if launches_per_call:
        from repro_torch.tools.kernel_turns import device_us as profiled
        us, per_call = profiled(
            lambda: kernel_a.launch(hs, src, row_ptr, ws, invs),
            ("csr_aggregate",))
        check(0 < per_call <= launches_per_call,
              f"{per_call} kernel A launches a call profiled at bucket {b} "
              f"({launches_per_call} expected)")
        case.update(device_us_per_launch=us,
                    profiled_launches_per_call=per_call,
                    device_us=us * launches_per_call)
    print(f"csr_aggregate bucket {b}: {json.dumps(case)}")
    case.update(err=err, bound_ms=bound, bound_by=by,
                shape={"bucket": b, "N": rows, "F": emb_dim, "E": arcs,
                       "E_live": live})
    return case


def key_accuracy(result):
    ds = result.dataset
    return float((result.predictions[ds.test_mask]
                  == ds.labels[ds.test_mask]).mean())


# phase 6: (label, dataset, dataset kwargs, epochs, PipelineConfig fields,
# whether the losses of every epoch are held). GraphSAGE on arxiv-like
# leaves the loss tolerance at epochs 6-7 under legitimate rounding (an f64
# or reversed-chunk product on the CPU: 2.0-2.4x), so its losses are held
# over the table's 2 epochs and the rest is printed
# (repro_torch.tools.training_parity).
PARITY_RUNS = (
    ("karate gcn", "karate", {}, 60, {}, True),
    ("arxiv-like 2k gcn", "arxiv-like", {"n": 2000}, 20, {}, True),
    ("arxiv-like 2k sage", "arxiv-like", {"n": 2000}, 20, {"model": "sage"},
     False),
    ("arxiv-like 2k gcn low-memory", "arxiv-like", {"n": 2000}, 20,
     {"low_memory": True}, True),
    ("arxiv-like 2k gcn model_avg", "arxiv-like", {"n": 2000}, 20,
     {"integrate": "model_avg"}, True),
    ("arxiv-like 2k gcn ensemble", "arxiv-like", {"n": 2000}, 20,
     {"integrate": "ensemble"}, True),
    ("proteins-like 2k gcn multilabel", "proteins-like", {"n": 2000}, 20, {},
     True),
    ("proteins-like 2k sage multilabel", "proteins-like", {"n": 2000}, 20,
     {"model": "sage"}, True),
    ("arxiv-like 2k gcn sync", "arxiv-like", {"n": 2000}, 20,
     {"mode": "sync"}, True),
    ("arxiv-like 2k gcn stale(2)", "arxiv-like", {"n": 2000}, 20,
     {"mode": "stale", "sync_period": 2}, True),
)


def train_on_card_vs_cpu(dev):
    """Phase 6: the training pipeline on the card against the CPU path,
    through ``repro_torch.tools.training_parity.compare_training``: the
    per-epoch losses within 1e-4 (of the full run, or of the first 2
    epochs where ``PARITY_RUNS`` says so) and the pooled table after 2
    epochs within 1e-3 (abs + rel); the rest is printed, not held."""
    from repro_torch.kernels import ops
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    from repro_torch.tools.training_parity import (TABLE_EPOCHS,
                                                   compare_training)
    rows = {}
    for label, name, kwargs, epochs, fields, all_losses in PARITY_RUNS:
        cfg = PipelineConfig(dataset=name, k=4, dropout=0.0, epochs=epochs,
                             classifier_epochs=0, dataset_kwargs=kwargs,
                             **fields)
        ops.reset_launch_counts()
        row = compare_training(cfg, lambda c: run_training(c, device=dev),
                               lambda c: run_training(c, device="cpu"),
                               None if all_losses else TABLE_EPOCHS)
        launches = ops.launch_counts()
        path = ("fused_gcn_layer_need_agg", "csr_aggregate") + (
            ("exchange_backward",) if cfg.mode != "local" else ())
        row["launches"] = {k: launches[k] for k in path}
        print(f"train card vs cpu [{label}, k=4]: {json.dumps(row)}")
        check(all(row["launches"].values()),
              f"{label}: a kernel of the path did not launch: {launches}")
        check(row["loss_ratio"] <= 1.0,
              f"{label}: per-epoch losses of the first {row['loss_epochs']} "
              f"epochs on the card disagree with the CPU "
              f"({row['loss_ratio']:.2f}x the tolerance)")
        check(row["table_ratio"] <= 1.0,
              f"{label}: the table after {row['table_epochs']} epochs on the "
              f"card disagrees with the CPU ({row['table_ratio']:.2f}x)")
        rows[label] = row
    return rows


def gradients_against_plain(tens, params, dev):
    """Phase 7: both Functions' gradients and one whole-GCN backward with
    arc-weight gradients, against autograd of the plain forward."""
    import torch
    from repro_torch.gnn.infer import partition_params
    from repro_torch.gnn.model import GNNConfig, gnn_forward
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.tree import tree_map

    p = int(torch.argmax((tens.edge_weight > 0).sum(dim=1)))
    csr = tens.csrs[p]
    n = csr.num_nodes
    inv = ops.inv_degree(tens.in_degree[p])
    h = tens.features[p]
    lp = partition_params(params["body"]["layers"][1], p)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((n, lp["w"].shape[1]), generator=gen, device=dev)

    def grads_pair(fn_mine, fn_plain, inputs, cot):
        """(mine, plain, bound): gradients of <fn(inputs), cot>; the bound
        is the plain gradient at |inputs| with |cot|, the sum of absolute
        terms of every gradient entry."""
        def run(fn, xs, c):
            leaves = [x.detach().clone().requires_grad_() for x in xs]
            return torch.autograd.grad((fn(*leaves) * c).sum(), leaves)
        return (run(fn_mine, inputs, cot), run(fn_plain, inputs, cot),
                run(fn_plain, [x.abs() for x in inputs], cot.abs()))

    errs, kinks = {}, {}
    names = ("dh", "dw", "dW", "db")
    inputs = [h, csr.weight, lp["w"], lp["b"]]
    for activate in (True, False):
        def mine_fn(hh, ww, wm, bb):
            return ops.fused_gcn_layer(hh, csr._replace(weight=ww), inv, wm,
                                       bb, activate=activate)
        # relu's derivative jumps at 0: where two forwards round a z next
        # to 0 to opposite signs, both gradients are right and differ by a
        # whole term. The plain path's index_add_ sums in no fixed order on
        # the card, so its signs there can change from call to call; it
        # takes the relu decisions of the kernel's own forward instead (the
        # launch the Function makes, with need_agg)
        on = (mine_fn(*[x.detach().requires_grad_() for x in inputs]) > 0
              ).detach() if activate else None

        def plain_fn(hh, ww, wm, bb):
            z = plain.fused_gcn_reference(hh, csr.src, csr.dst, ww, inv, wm,
                                          bb, activate=False)
            return z * on if activate else z
        if activate:
            with torch.no_grad():
                kinks["plain relu sign != kernel's"] = int(
                    ((plain.fused_gcn_reference(h, csr.src, csr.dst,
                                                csr.weight, inv, lp["w"],
                                                lp["b"]) > 0) != on).sum())
        mine, ref, bound = grads_pair(mine_fn, plain_fn, inputs, g)
        for name, a, r, s in zip(names, mine, ref, bound):
            errs[f"fused {name} activate={activate}"] = max_err(
                a, r, s, f"fused layer {name}")
    gh = torch.randn(h.shape, generator=gen, device=dev)
    mine, ref, bound = grads_pair(
        lambda hh, ww: ops.csr_aggregate(hh, csr._replace(weight=ww), inv),
        lambda hh, ww: plain.csr_aggregate_ref(hh, csr.src, csr.dst, ww, n,
                                               inv),
        [h, csr.weight], gh)
    for name, a, r, s in zip(names, mine, ref, bound):
        errs[f"aggregate {name}"] = max_err(a, r, s, f"aggregate {name}")
    print("gradients vs plain (max abs err): " + json.dumps(errs)
          + f"; relu outputs straddling 0: {json.dumps(kinks)}")

    # the path that launches kernel C: a whole GCN backward that asks for
    # the arc weights' gradient (main-path training keeps them fixed)
    cfg = GNNConfig(feature_dim=h.shape[1], hidden_dim=lp["w"].shape[1],
                    embed_dim=params["body"]["layers"][-1]["w"].shape[-1],
                    num_layers=len(params["body"]["layers"]))
    body = partition_params(params["body"], p)
    weight = csr.weight.detach().clone().requires_grad_()
    cot = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
    ops.reset_launch_counts()
    emb = gnn_forward(body, cfg, h, csr._replace(weight=weight),
                      tens.in_degree[p], node_mask=tens.node_mask[p])
    (dw,) = torch.autograd.grad(emb, weight, cot)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # the plain path takes its relu decisions from the kernels' forward
    # (the same launches gnn_forward made), so a z rounded to opposite
    # signs next to 0 does not pick another subgradient; run once as it is
    # and once on absolute values, whose gradient is each entry's sum of
    # absolute terms
    mask = tens.node_mask[p][:, None]
    h_k = h * mask
    relu = []
    with torch.no_grad():
        for i, layer in enumerate(body["layers"]):
            h_k = ops.fused_gcn_layer(h_k, csr, inv, layer["w"], layer["b"],
                                      activate=i < cfg.num_layers - 1) * mask
            relu.append(h_k > 0)

    def plain_dw(hh, ww, layers, c):
        ww = ww.detach().clone().requires_grad_()
        x = hh * mask
        for i, layer in enumerate(layers):
            z = plain.fused_gcn_reference(x, csr.src, csr.dst, ww, inv,
                                          layer["w"], layer["b"],
                                          activate=False)
            x = (z if i == cfg.num_layers - 1 else z * relu[i]) * mask
        return torch.autograd.grad(x, ww, c)[0]
    dw_ref = plain_dw(h, csr.weight, body["layers"], cot)
    scale = plain_dw(h.abs(), csr.weight.abs(),
                     [tree_map(torch.abs, layer) for layer in body["layers"]],
                     cot.abs())
    err = max_err(dw, dw_ref, scale, "arc-weight gradient")
    print(f"arc-weight gradient of a {cfg.num_layers}-layer GCN: max abs "
          f"err {err:.3e} (largest entry {float(dw_ref.abs().max()):.3e}); "
          f"launches {json.dumps(launches)}")
    check(launches["edge_dot"] > 0 and launches["csr_aggregate"] > 0,
          f"the arc-weight backward did not launch kernels A and C: "
          f"{launches}")
    return launches["edge_dot"], p


def edge_dot_case(h, g, csr, inv, what):
    """Kernel C on one partition: error against its plain version (3e-5
    against the sum of absolute terms), two calls bitwise equal, device
    time by the profiler, CUDA-event time, plain time, bound and
    ``torch.sparse.sampled_addmm``'s time."""
    import torch
    from repro_torch.kernels import edge_dot as kernel_c
    nn, f = h.shape
    e = csr.src.shape[0]
    e_live = int((csr.weight > 0).sum())

    def call():
        return kernel_c.launch(h, g, csr.src, csr.dst, inv)
    err = max_err(call(), kernel_c.plain(h, g, csr.src, csr.dst, inv),
                  kernel_c.plain(h.abs(), g.abs(), csr.src, csr.dst, inv),
                  f"edge dot ({what})")
    sp_c = library_csr(csr.dst, csr.src, csr.weight, nn)
    g_scaled = g * inv[:, None]
    h_t = h.t()
    lib = torch.sparse.sampled_addmm(sp_c, g_scaled, h_t, beta=0.0)
    lib_dst = torch.repeat_interleave(
        torch.arange(nn, device=h.device), sp_c.crow_indices().diff())
    check(torch.allclose(lib.values(), kernel_c.plain(
        h, g, sp_c.col_indices(), lib_dst, inv), rtol=1e-3, atol=1e-3),
          "sampled_addmm does not compute the edge dot")
    bound, by = bound_ms(4 * (2 * nn * f + 3 * e + nn), 2 * e * f)
    us, per_call = device_us(call, "edge_dot_kernel")
    row = {"max_abs_err": err,
           "bitwise_repeatable": repeatable(call, f"kernel C ({what})"),
           "device_ms": us / 1e3, "profiled_launches_per_call": per_call,
           "ms": time_ms(call),
           "plain_ms": time_ms(lambda: kernel_c.plain(h, g, csr.src,
                                                      csr.dst, inv)),
           "bound_ms": bound, "bound_by": by,
           "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
               sp_c, g_scaled, h_t, beta=0.0)),
           "shape": {"N": nn, "F": f, "E": e, "E_live": e_live,
                     "pad_arcs": e - e_live}}
    print(f"kernel C {what}: {json.dumps(row)}")
    return row


def kernels_per_partition(tens, w0, b0, dev):
    """Kernel B (``need_agg``, the training forward) and kernel A over the
    reversed arcs (the backward's ``dh``) on each of the main path's
    partitions: error against the plain version, two calls bitwise equal,
    time (CUDA events, median of 10), bound, and the library call for
    kernel A (``torch.sparse.mm`` over the same reversed CSR's live arcs).
    Each partition's weight-0 padding arcs sit in one row (the assembly
    parks them at row n_pad-1, source 0)."""
    import torch
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import fused_layer as kernel_b
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for q in range(tens.k):
        c = tens.csrs[q]
        h = tens.features[q].contiguous()
        inv = ops.inv_degree(tens.in_degree[q])
        nn, f = h.shape
        fo, e = w0.shape[1], c.src.shape[0]
        e_live = int((c.weight > 0).sum())
        g = torch.randn((nn, f), generator=gen, device=dev)
        rev_w = (c.weight * inv[c.dst.long()])[c.rev_perm].contiguous()
        rev_dst = c.src[c.rev_perm].contiguous()

        def fused():
            return kernel_b.launch(h, c.src, c.row_ptr, c.weight, inv, w0, b0,
                                   need_agg=True)

        def transpose():
            return kernel_a.launch(g, c.rev_src, c.rev_row_ptr, rev_w)
        (out, agg), again = fused(), fused()
        check(torch.equal(out, again[0]) and torch.equal(agg, again[1]),
              f"kernel B: two calls differ (partition {q})")
        agg_ref = plain.csr_aggregate_ref(h, c.src, c.dst, c.weight, nn, inv)
        err_b = max(
            max_err(out, plain.gcn_epilogue(agg_ref, w0, b0, True),
                    what=f"kernel B (partition {q})"),
            max_err(agg, agg_ref, plain.csr_aggregate_ref(
                h.abs(), c.src, c.dst, c.weight, nn, inv),
                f"kernel B agg (partition {q})"))
        dh = transpose()
        check(torch.equal(dh, transpose()),
              f"kernel A: two calls differ (partition {q})")
        err_a = max_err(dh, kernel_a.plain(g, c.rev_src, rev_dst, rev_w, nn),
                        kernel_a.plain(g.abs(), c.rev_src, rev_dst, rev_w,
                                       nn),
                        f"kernel A transposed (partition {q})")
        sp = library_csr(rev_dst, c.rev_src, rev_w, nn)
        check(torch.allclose(torch.sparse.mm(sp, g), dh, rtol=1e-3,
                             atol=1e-3),
              "torch.sparse.mm does not compute the transposed aggregation")
        b_bound, b_by = layer_bound(nn, f, fo, e, e_live, need_agg=True)
        a_bound, a_by = transpose_bound(nn, f, e, int((rev_w > 0).sum()))
        row = {"p": q, "pad_arcs": int((c.weight == 0).sum()),
               "e_live": e_live, "row_max": int(c.row_ptr.diff().max()),
               "rev_row_max": int(c.rev_row_ptr.diff().max()),
               "fused_err": err_b, "fused_bound_ms": b_bound,
               "fused_bound_by": b_by,
               "transpose_err": err_a, "transpose_bound_ms": a_bound,
               "transpose_bound_by": a_by,
               "transpose_library_ms": time_ms(
                   lambda: torch.sparse.mm(sp, g), iters=10),
               "fused_ms": time_ms(fused, iters=10),
               "transpose_ms": time_ms(transpose, iters=10),
               "fused_plain_ms": time_ms(lambda: plain.gcn_epilogue(
                   plain.csr_aggregate_ref(h, c.src, c.dst, c.weight, nn,
                                           inv), w0, b0, True), iters=10),
               "transpose_plain_ms": time_ms(lambda: kernel_a.plain(
                   g, c.rev_src, rev_dst, rev_w, nn), iters=10)}
        rows.append(row)
        print(f"partition {q}: {json.dumps(row)}")
    return rows


def profile_training(result, dev):
    """Device time by kernel over two training epochs, and the launches of
    one stacked AdamW step (``torch.profiler``, CUPTI). Returns the device
    launches per wrapper call of kernels B and A in those epochs,
    ``{"B": ..., "A": ...}``, counted from the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.gnn.train import stacked_train_step
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_map
    tens, cfg = result.tensors, result.gnn
    gens = [torch.Generator(device=dev).manual_seed(p)
            for p in range(tens.k)]
    params, opt = result.params, adamw_init(result.params, stacked=True)

    def epoch():
        return stacked_train_step(params, opt, tens, cfg, False, 5e-3, gens)
    params, opt, _ = epoch()                 # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, opt, _ = epoch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = ops.launch_counts()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    # Kernel B's wrapper runs kernel A's gather and fix-up into its
    # aggregate, then its product, back to back on one stream: kernel A's
    # launches that the next launch, a product, follows are kernel B's.
    group_b, group_a = "fused_gcn (fwd, B)", "csr_aggregate (bwd transpose, A)"
    gemm, other = "gemm (bwd dW, da; head)", "other (elementwise, reductions)"
    edge = "edge_dot (C)"
    split = {k: 0.0 for k in (group_b, group_a, edge, gemm, other)}
    parts, count = {}, {"B": 0, "A": 0}

    def take(owner, evs):
        for ev in evs:
            name = next(n for n in ("csr_aggregate_gather",
                                    "csr_aggregate_fixup",
                                    "fused_gcn_product") if n in ev.name)
            us = ev.time_range.elapsed_us()
            split[group_b if owner == "B" else group_a] += us
            parts[f"{owner}: {name}"] = parts.get(f"{owner}: {name}", 0.0) + us
            count[owner] += 1
    pending = []
    for e in kernels:
        if "csr_aggregate_" in e.name:
            pending.append(e)
            continue
        if "fused_gcn_product" in e.name:
            take("B", pending + [e])
        else:
            take("A", pending)
            key = edge if "edge_dot_kernel" in e.name else gemm if any(
                s in e.name.lower() for s in ("gemm", "cutlass", "xmma")) \
                else other
            split[key] += e.time_range.elapsed_us()
        pending = []
    take("A", pending)
    per_call = {"B": count["B"] / max(calls["fused_gcn_layer"], 1),
                "A": count["A"] / max(calls["csr_aggregate"], 1)}
    busy = sum(split.values())
    print(f"profile, 2 epochs x {tens.k} partitions: wall "
          f"{wall_us / 2e3:.3f} ms/epoch (profiler on), device busy "
          f"{busy / 2e3:.3f} ms/epoch, idle share "
          f"{1 - busy / wall_us:.3f}, {len(kernels) // 2} kernels/epoch")
    print("profile device ms/epoch by kernel: " + json.dumps(
        {k: round(v / 2e3, 4) for k, v in split.items()}))
    print("profile device ms/epoch by launch of kernels A and B: "
          + json.dumps({k: round(v / 2e3, 4) for k, v in parts.items()}))
    print(f"profile: device launches per wrapper call {json.dumps(per_call)}"
          f" (calls: B {calls['fused_gcn_layer']}, A "
          f"{calls['csr_aggregate']})")
    check(len(kernels) > 0 and calls["fused_gcn_layer"] > 0
          and calls["csr_aggregate"] > 0 and count["B"] > 0
          and count["A"] > 0, "the profile saw no launch of kernel A or B")

    grads = tree_map(lambda x: torch.full_like(x, 1e-3), params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        adamw_update(grads, opt, params, 5e-3)
        torch.cuda.synchronize()
    n_adamw = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile: one stacked AdamW step = {n_adamw} kernel launches")
    return per_call


def library_csr(rows, cols, vals, n):
    """The live arcs (``vals != 0``) as a sorted, duplicate-free sparse CSR
    matrix for a library call (weight-0 padding arcs are no-ops)."""
    import torch
    live = vals != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[live].long(), cols[live].long()]), vals[live],
        (n, n)).coalesce()
    return coo.to_sparse_csr()


@contextlib.contextmanager
def decode_attention(fn):
    """Route the LM's decode attention through ``fn`` (a plain version, on
    the card) for a comparison; its launches are not counted."""
    from repro_torch.models import attention
    saved = attention.flash_decode
    attention.flash_decode = fn
    try:
        yield
    finally:
        attention.flash_decode = saved


def plain_q_scaled(q, k, v, lengths):
    """Kernel D's plain version with the scale applied to q before the
    product, the order of the reference's kernel (the reference's plain
    decode path, like ``flash_decode_ref``, scales the logits): the same
    function with other f32 roundings."""
    import torch
    b, s, hkv, d = k.shape
    h = q.shape[1]
    qg = (q.float() * d ** -0.5).reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    valid = torch.arange(s, device=k.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=k.device))
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(logits, dim=-1),
                       v.float())
    return out.reshape(b, h, d).to(q.dtype)


def logits_diff(got, ref):
    """Max and rms of ``got - ref``, each over the same of ``ref``."""
    d = (got - ref).float()
    r = ref.float()
    return (float(d.abs().max() / r.abs().max()),
            float(d.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()))


def kernel_vs_plain_step(params, cfg, cache, tokens, lengths, what,
                         fresh=None):
    """One decode step from the same cache through the plain version,
    through the plain version in the reference kernel's order (the floor:
    what bf16 roundings alone move), and through kernel D. Each layer
    writes its new row before it attends, so each step overwrites what the
    one before wrote: all three see one cache. A cache with recurrent
    states (which a step advances) is made anew for each step by
    ``fresh()``."""
    import torch
    from repro_torch.kernels import flash_decode as kernel_d
    from repro_torch.models.lm import serve_step
    new = fresh or (lambda: cache)
    with torch.no_grad():
        with decode_attention(kernel_d.plain):
            ref, _ = serve_step(params, cfg, tokens, new(), lengths)
        with decode_attention(plain_q_scaled):
            floor, _ = serve_step(params, cfg, tokens, new(), lengths)
        got, _ = serve_step(params, cfg, tokens, new(), lengths)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all()),
          f"non-finite {what} logits")
    err, floor_err = logits_diff(got, ref), logits_diff(floor, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    row = {"max_err_over_max": err[0], "rms_err_over_rms": err[1],
           "floor_max_over_max": floor_err[0],
           "floor_rms_over_rms": floor_err[1],
           "largest_logit": float(ref.abs().max()), "greedy_agree": agree,
           "dtype": cfg.dtype}
    print(f"{what}: kernel D vs plain logits {json.dumps(row)}")
    tol = LM_BF16_TOL if cfg.dtype == "bfloat16" else LM_F32_TOL
    if cfg.dtype == "bfloat16":
        ok = err[0] <= tol and err[1] <= tol
    else:
        ok = bool(((got - ref).abs() <= tol + tol * ref.abs()).all())
    check(ok, f"{what}: logits through kernel D disagree with the plain "
              f"path: {row}")
    return got, row


def profile_decode(params, cfg, cache, tokens, lengths, steps=4):
    """Device ms per decode step by kernel (kernel D, cuBLAS, the rest) and
    the device idle share, over ``steps`` steps (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import serve_step
    with torch.no_grad():
        serve_step(params, cfg, tokens, cache, lengths)       # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                serve_step(params, cfg, tokens, cache, lengths + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    split = {"flash_decode (D)": 0.0, "cublas gemm": 0.0, "other": 0.0}
    n = n_d = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        name = e.name.lower()
        n_d += "flash_decode" in name
        key = ("flash_decode (D)" if "flash_decode" in name else
               "cublas gemm" if any(w in name for w in
                                    ("gemm", "cutlass", "xmma", "gemv",
                                     "nvjet", "sm90")) else "other")
        split[key] += e.time_range.elapsed_us()
    busy = sum(split.values())
    row = {"wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3,
           "idle_share": 1 - busy / wall_us,
           "kernels_per_step": n / steps,
           "kernel_d_device_launches_per_call": n_d / (steps
                                                       * cfg.num_layers),
           "device_ms_per_step": {k: v / steps / 1e3
                                  for k, v in split.items()}}
    print(f"LM decode profile ({steps} steps, B={tokens.shape[0]}, profiler "
          f"on): {json.dumps(row)}")
    check(busy > 0 and split["flash_decode (D)"] > 0,
          "the profiler saw no kernel D launches in the decode steps")
    check(n_d == steps * cfg.num_layers,
          f"{n_d} kernel D device launches in {steps} steps of "
          f"{cfg.num_layers} layers: not one a call")
    return row


def lm_serving(dev):
    """Phase 9: the LM serving main path, then kernel against plain and a
    profile on a seeded prefill of its largest bucket."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_bucket, serve
    from repro_torch.models.lm import grow_cache, init_model, prefill_step
    cfg = get_config(LM_ARCH)
    args = argparse.Namespace(arch=LM_ARCH, reduced=False, requests=8,
                              min_prompt=64, max_prompt=1024, max_new=32,
                              seed=0, device="cuda")
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=args.seed)
    torch.cuda.synchronize()
    print(f"LM {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
          f"{cfg.head_dim}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f} B "
          f"parameters seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    report = serve(args, params=params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    n_buckets = len(report["prefill_buckets"])
    print("LM serve report: " + json.dumps(report))
    print(f"LM serve: prefill_s={report['prefill_s']:.4f} "
          f"decode_s={report['decode_s']:.4f} "
          f"decode_tok_per_s={report['decode_tok_per_s']:.2f} "
          f"({args.requests} requests x {args.max_new} tokens, "
          f"{n_buckets} buckets); kernel D launches {launches}")
    check(report["finite"], "non-finite LM logits")
    check(report["decode_compiles"] == n_buckets
          and report["prefill_compiles"] == 0,
          f"decode graphs {report['decode_compiles']} for {n_buckets} "
          f"buckets, prefill graphs {report['prefill_compiles']}")
    check(launches == cfg.num_layers * args.max_new * n_buckets,
          f"kernel D launched {launches} times, not {cfg.num_layers} x "
          f"{args.max_new} x {n_buckets}")

    # a seeded prefill of the largest bucket, rows at their own lengths
    rng = np.random.default_rng(1)
    lengths = np.array(report["prompt_lengths"])
    s_b = max(int(k) for k in report["prefill_buckets"])
    rows = lengths[[prefill_bucket(int(x)) == s_b for x in lengths]]
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (rows.size, s_b)),
                             dtype=torch.int32, device=dev)
    cur = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    errs = {}
    # the main path's bf16 weights, then an f32 copy of the same seeded
    # draws (the generator draws f32 and casts)
    for c in (cfg, dataclasses.replace(cfg, dtype="float32")):
        p = params if c is cfg else init_model(c, dev, seed=args.seed)
        with torch.no_grad():
            logits, cache, _ = prefill_step(p, c, {"tokens": tokens})
            cache = grow_cache(cache, s_b + args.max_new)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        _, errs[c.dtype] = kernel_vs_plain_step(
            p, c, cache, nxt, cur,
            f"LM serve step ({c.dtype}, bucket {s_b}, {rows.size} rows)")
        if c is cfg:
            prof = profile_decode(p, c, cache, nxt, cur)
        del p, cache
    serving = (s_b + args.max_new, [int(x) + 1 for x in rows])
    return params, cfg, report, launches, errs, prof, serving, args


def lm_long_cache(params, cfg, dev, steps=8):
    """Phase 10: 4 sequences in a 32,768-slot cache of seeded noise."""
    import torch
    from repro_torch.models.lm import init_cache, serve_step
    s = 32768
    lengths0 = (0, 4095, 20000, 32760)
    cache = init_cache(cfg, len(lengths0), s, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for t in cache["layers"].values():
        t.normal_(0.0, 0.1, generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (len(lengths0), 1),
                           generator=gen, device=dev, dtype=torch.int32)
    lengths = torch.tensor(lengths0, dtype=torch.int32, device=dev)
    logits, err = kernel_vs_plain_step(params, cfg, cache, tokens, lengths,
                                       "LM long-cache step 1")
    times = []
    with torch.no_grad():
        for _ in range(steps - 1):
            tokens = logits.argmax(-1).to(torch.int32)[:, None]
            lengths = lengths + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = serve_step(params, cfg, tokens, cache, lengths)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()),
                  "non-finite long-cache logits")
    last = int(lengths[-1])
    print(f"LM long-cache decode: {steps} steps, last step wrote slot {last} "
          f"of {s} and attended to {last + 1}; step ms (host clock, "
          f"synchronized) {json.dumps([round(1e3 * t, 3) for t in times])}")
    check(last == s - 1, f"the last step wrote slot {last}, not {s - 1}")
    del cache
    return err, statistics.median(times)


def kernel_d_case(q, k, v, filled, plain_rows, what):
    """Kernel D against its plain version and the library call at one
    shape. The plain version and the library call run over ``plain_rows``
    rows at a time (the library's math path repeats K/V per query head,
    which at B 128 would not fit beside the inputs). Returns the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as kernel_d
    b, s, hkv, d = k.shape

    def plain_all():
        return torch.cat([kernel_d.plain(q[i:i + plain_rows],
                                         k[i:i + plain_rows],
                                         v[i:i + plain_rows],
                                         filled[i:i + plain_rows])
                          for i in range(0, b, plain_rows)])

    out = kernel_d.launch(q, k, v, filled)
    ref = plain_all()
    if k.dtype == torch.float32:
        scale = torch.cat([kernel_d.plain(q[i:i + plain_rows],
                                          k[i:i + plain_rows],
                                          v[i:i + plain_rows].abs(),
                                          filled[i:i + plain_rows])
                           for i in range(0, b, plain_rows)])
        err = max_err(out, ref, scale, f"kernel D {what}")
    else:
        o, r = out.float(), ref.float()
        check(bool(torch.isfinite(o).all()), f"non-finite kernel D {what}")
        diff = (o - r).abs()
        check(bool((diff <= BF16_TOL + BF16_TOL * r.abs()).all()),
              f"kernel D {what} disagrees with its plain version: max abs "
              f"err {float(diff.max())}")
        err = float(diff.max())
    rows = int(filled.clamp(0, s).sum())
    nbytes = (2 * rows * hkv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b)
    bound, by = bound_ms(nbytes, 4 * rows * q.shape[1] * d)
    # the library call, on K/V already in its [B, Hkv, S, D] layout
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=k.device)[None, :]
            < filled[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return torch.cat([F.scaled_dot_product_attention(
            q4[i:i + plain_rows], kt[i:i + plain_rows], vt[i:i + plain_rows],
            attn_mask=mask[i:i + plain_rows], enable_gqa=True)
            for i in range(0, b, plain_rows)])
    lib_err = float((library()[:, :, 0].float() - ref.float()).abs().max())
    check(lib_err < 5e-2, f"scaled_dot_product_attention does not compute "
                          f"kernel D's function ({lib_err})")

    def call():
        return kernel_d.launch(q, k, v, filled)
    us, per_call = device_us(call, "flash_decode")
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    call()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    check(allocs == 1, f"kernel D {what}: a call made {allocs} allocations, "
                       f"not 1 (its output)")
    row = {"shape": {"B": b, "S": s, "H": q.shape[1], "Hkv": hkv, "D": d,
                     "dtype": str(k.dtype).split(".")[-1],
                     "filled_sum": rows, "plain_rows_per_call": plain_rows},
           "plan": dict(zip(("splits", "chunk"), kernel_d.plan_of(q, k))),
           "max_abs_err": err,
           "bitwise_repeatable": repeatable(call, f"kernel D {what}"),
           "allocations_per_call": allocs,
           "device_ms": us / 1e3, "profiled_launches_per_call": per_call,
           "ms": time_ms(call),
           "plain_ms": time_ms(plain_all, iters=10),
           "bound_ms": bound, "bound_by": by,
           "library_ms": time_ms(library, iters=10),
           "library_max_abs_diff": lib_err}
    del kt, vt
    print(f"kernel D {what}: {json.dumps(row)}")
    return row


def kernel_d_against_plain(dev, serving):
    """Phase 11: kernel D at the serving run's largest bucket (``serving``:
    its cache length and its rows' first-step lengths), at decode_32k's
    layer shape (bf16, and f32 at B 16) and at long_500k's sliding ring."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    s, h, hkv, d = 32768, 32, 8, 128

    def qkv(b, s, dtype):
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev,
                        dtype=dtype)
        return q, k, v
    filled = rng.integers(1, s + 1, 128)
    filled[:5] = (1, 511, 512, 513, s)
    f = torch.as_tensor(filled, dtype=torch.int32, device=dev)
    rows = {}
    s_serve, lengths = serving
    q, k, v = qkv(len(lengths), s_serve, torch.bfloat16)
    rows["serving"] = kernel_d_case(
        q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device=dev),
        len(lengths), f"serving bucket (B {len(lengths)}, S {s_serve})")
    q, k, v = qkv(128, s, torch.bfloat16)
    rows["decode_32k"] = kernel_d_case(q, k, v, f, 32, "decode_32k bf16")
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(16, s, torch.float32)
    rows["decode_32k_f32"] = kernel_d_case(q, k, v, f[:16].contiguous(), 8,
                                           "decode_32k f32 (B 16)")
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(1, 8192, torch.bfloat16)
    rows["long_500k_ring"] = kernel_d_case(
        q, k, v, torch.full((1,), 8192, dtype=torch.int32, device=dev), 1,
        "long_500k ring (B 1, S 8,192)")
    return rows


COMPARISON_METHODS = ("random", "lpa", "metis", "lpa+f", "metis+f",
                      "leiden_fusion")
CONNECTED_METHODS = ("lpa+f", "metis+f", "leiden_fusion")


def per_partition_summary(per_part):
    """Means over the partitions (each launches kernels A and B equally
    often) of ``kernels_per_partition``'s rows, and the worst error."""
    keys = ("fused_ms", "fused_plain_ms", "fused_bound_ms", "transpose_ms",
            "transpose_plain_ms", "transpose_bound_ms",
            "transpose_library_ms")
    row = {f"{k}_mean": statistics.mean(r[k] for r in per_part)
           for k in keys}
    row.update(fused_err=max(r["fused_err"] for r in per_part),
               transpose_err=max(r["transpose_err"] for r in per_part),
               pad_arcs=[r["pad_arcs"] for r in per_part],
               e_live=[r["e_live"] for r in per_part],
               fused_bound_by=per_part[0]["fused_bound_by"],
               transpose_bound_by=per_part[0]["transpose_bound_by"])
    return row


def partitioner_comparison(dev, cache_dir):
    """Phase 12: the paper's comparison on the card. Arxiv-like at 40,000
    nodes, k = 8, repli; for each method the partition on the host (through
    the artifact cache), its report, 60 epochs of the 3 x 128 GCN (dropout
    0.3, lr 5e-3) and 150 of the classifier. Gates: finite losses, kernels
    A and B launched in every run, one component and no isolated node in
    every part of the connected methods; kernels A and B against their
    plain versions on every partition of the random and LPA runs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.pipeline.datasets import get_dataset
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    t0 = time.perf_counter()
    ds = get_dataset("arxiv-like")
    rows, kernel_rows = {}, {}
    for method in COMPARISON_METHODS:
        cfg = PipelineConfig(dataset="arxiv-like", method=method, k=8,
                             scheme="repli", cache_dir=cache_dir)
        ops.reset_launch_counts()
        result = run_training(cfg, device=dev, ds=ds)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        p, t = result.partition, result.timings
        row = {"cut_pct": p["edge_cut_pct"],
               "components": p["total_components"],
               "max_components": p["max_components"],
               "isolated": p["total_isolated"],
               "node_balance": p["node_balance"],
               "replication": p["replication_factor"],
               "partition_s": t["partition"],
               "cache_hit": result.bundle.labels_hit,
               "n_pad": result.batch.n_pad, "e_pad": result.batch.e_pad,
               "ms_per_epoch": 1e3 * t["train_epochs"] / cfg.epochs,
               "classifier_s": t["classifier"],
               "accuracy": result.accuracy,
               "loss_first": float(result.losses[0].mean()),
               "loss_last": float(result.losses[-1].mean()),
               "launches": {k: launches[k] for k in (
                   "fused_gcn_layer_need_agg", "csr_aggregate")}}
        print(f"comparison [{method}]: {json.dumps(row)}", flush=True)
        check(bool(np.isfinite(result.losses).all()),
              f"{method}: non-finite training loss")
        check(all(row["launches"].values()),
              f"{method}: kernels A and B did not both launch: {launches}")
        if method in CONNECTED_METHODS:
            check(row["max_components"] == 1 and row["isolated"] == 0,
                  f"{method}: a part is disconnected or has an isolated "
                  f"node: {p}")
        if method in ("random", "lpa"):
            params = result.params["body"]["layers"][0]
            kernel_rows[method] = {
                "launches": row["launches"],
                **per_partition_summary(kernels_per_partition(
                    result.tensors, params["w"][0], params["b"][0], dev))}
            print(f"comparison kernels [{method}]: "
                  f"{json.dumps(kernel_rows[method])}")
        rows[method] = row
        del result
    print("comparison table (arxiv-like 40,000 nodes, k=8, repli, GCN 3x128, "
          "60 epochs):")
    print(f"  {'method':14s} {'cut%':>6s} {'comps':>6s} {'isol':>6s} "
          f"{'bal':>5s} {'repl':>5s} {'part_s':>7s} {'ms/ep':>7s} "
          f"{'test':>6s}")
    for method, r in rows.items():
        print(f"  {method:14s} {r['cut_pct']:6.2f} {r['components']:6d} "
              f"{r['isolated']:6d} {r['node_balance']:5.2f} "
              f"{r['replication']:5.2f} {r['partition_s']:7.2f} "
              f"{r['ms_per_epoch']:7.2f} {r['accuracy']['test']:6.4f}")
    print(f"comparison phase: {time.perf_counter() - t0:.1f} s wall")
    return rows, kernel_rows


def proteins_on_card(dev):
    """Phase 13: proteins-like at its default (6,000 nodes, 112 tasks,
    average degree 80), k = 8, GCN and SAGE for 60 epochs: the test mean
    ROC-AUC must beat 0.5 and the seeded, untrained run's."""
    import numpy as np
    import torch
    from repro_torch.gnn.train import mean_rocauc
    from repro_torch.kernels import ops
    from repro_torch.pipeline.datasets import get_dataset
    from repro_torch.kernels import autotune as at
    from repro_torch.pipeline.pipeline import (PipelineConfig,
                                               PipelineReport, run_inference,
                                               run_training)
    from repro_torch.serving.store import classify
    ds = get_dataset("proteins-like")
    test = torch.as_tensor(ds.test_mask)
    rows = {}
    for model in ("gcn", "sage"):
        cfg = PipelineConfig(dataset="proteins-like", k=8, model=model)
        seeded = run_inference(cfg, device=dev, ds=ds)
        seeded_auc = float(mean_rocauc(
            ds.labels[ds.test_mask],
            classify(seeded.classifier, seeded.embeddings)[test.to(dev)]
            .cpu().numpy()))
        del seeded
        ops.reset_launch_counts()
        trained = run_training(cfg, device=dev, ds=ds)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        t = trained.timings
        row = {"auc": trained.accuracy, "seeded_test_auc": seeded_auc,
               "ms_per_epoch": 1e3 * t["train_epochs"] / cfg.epochs,
               "n_pad": trained.batch.n_pad, "e_pad": trained.batch.e_pad,
               "loss_first": float(trained.losses[0].mean()),
               "loss_last": float(trained.losses[-1].mean()),
               "launches": {k: launches[k] for k in (
                   "fused_gcn_layer_need_agg", "csr_aggregate")}}
        print(f"proteins-like [{model}, k=8, 60 epochs]: {json.dumps(row)}")
        auc = trained.accuracy["test"]
        check(bool(np.isfinite(trained.losses).all()),
              f"proteins {model}: non-finite training loss")
        check(all(row["launches"].values()),
              f"proteins {model}: kernels A and B did not both launch")
        check(auc > 0.5 and auc > seeded_auc,
              f"proteins {model}: test ROC-AUC {auc} does not beat 0.5 and "
              f"the seeded run's {seeded_auc}")
        rows[model] = row
        del trained
    return rows


def schedule_bytes(k, h_pad, widths):
    """The reference's collective bytes of a sync step, from the schedule
    (counted here, apart from the port's ``exchange_collective_bytes``):
    an all-gather of ``[k, k, H_pad, F_i]`` f32 before each layer, a
    reduce-scatter of ``[1, k, H_pad, F_i]`` for each layer but the
    first."""
    return (sum(k * k * h_pad * f * 4 for f in widths)
            + sum(k * h_pad * f * 4 for f in widths[1:]))


# the runtime calls that put work on a stream: a profile's CPU-side records
# of them count a step's host launches (a graph replay is one
# cudaGraphLaunch)
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_step(step, what, steps=2):
    """Device time by kernel over ``steps`` calls of ``step`` (a training
    step, inputs bound), the device busy and idle share and the kernels a
    step (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    split = {"kernel A (gather, fix-up)": 0.0, "kernel B product": 0.0,
             "cublas gemm": 0.0, "copy and index (exchange, stack)": 0.0,
             "other": 0.0}
    n = host = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host += any(w in e.name for w in HOST_LAUNCHES)
            continue
        n += 1
        name = e.name.lower()
        key = ("kernel A (gather, fix-up)" if "csr_aggregate_" in name else
               "kernel B product" if "fused_gcn_product" in name else
               "cublas gemm" if any(w in name for w in (
                   "gemm", "cutlass", "xmma", "nvjet", "sm90")) else
               "copy and index (exchange, stack)" if any(w in name for w in (
                   "index", "copy", "cat", "gather", "scatter")) else
               "other")
        split[key] += e.time_range.elapsed_us()
    busy = sum(split.values())
    row = {"wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3,
           "idle_share": 1 - busy / wall_us, "kernels_per_step": n / steps,
           "host_launches_per_step": host / steps,
           "device_ms_per_step": {k: v / steps / 1e3
                                  for k, v in split.items()}}
    print(f"profile, {what} ({steps} steps, profiler on): {json.dumps(row)}")
    check(busy > 0, f"the profile of {what} saw no kernel")
    return row


def kernel_records(step, what, steps=2, tries=4):
    """Kernels A, B and D counted on the device over ``steps`` calls of
    ``step``, against what the launch counters moved over the same calls
    (on a captured step, the deltas its replays add). A kernel A call is
    one gather and one fix-up; kernel B fills its aggregate through kernel
    A's entry point, then adds one product; kernel D is one launch a
    call. So ``steps`` calls must add gather = fix-up = A + B, product =
    B and kernel D = D device records. A ``torch.profiler`` window on the
    card misses records near its start (one of each of these kernels in
    every window of a 2-step run), so each try takes two windows, each
    opened by a synchronized kernel of its own: one of 1 call and one of
    1 + ``steps`` calls; the records the second holds beyond the first
    are the ``steps`` calls' own. Up to ``tries`` tries: one must match
    exactly, and no window may hold more records than its counters
    moved. Returns the counts matched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    names = {"kernel A gather": "csr_aggregate_gather",
             "kernel A fix-up": "csr_aggregate_fixup",
             "kernel B product": "fused_gcn_product",
             "kernel D": "flash_decode"}

    def window(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=torch.cuda.current_device()).add_(1)
            torch.cuda.synchronize()
            before = ops.launch_counts()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            after = ops.launch_counts()
        a, b, d = (after[k] - before[k] for k in (
            "csr_aggregate", "fused_gcn_layer", "flash_decode"))
        moved = {"kernel A gather": a + b, "kernel A fix-up": a + b,
                 "kernel B product": b, "kernel D": d}
        seen = dict.fromkeys(names, 0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for key, name in names.items():
                    seen[key] += name in e.name
        return seen, moved

    tries_seen = []
    for _ in range(tries):
        (s1, m1), (s2, m2) = window(1), window(1 + steps)
        added = {k: s2[k] - s1[k] for k in names}
        expect = {k: m2[k] - m1[k] for k in names}
        tries_seen.append({"records": [s1, s2], "counters": [m1, m2],
                           "added": added, "expected": expect})
        check(all(s[k] <= m[k] for s, m in ((s1, m1), (s2, m2))
                  for k in names),
              f"{what}: more kernel records than the counters moved: "
              f"{tries_seen[-1]}")
        if added == expect:
            break
    print(f"kernel records, {what} (windows of 1 and {1 + steps} calls): "
          f"{json.dumps(tries_seen)}", flush=True)
    check(added == expect,
          f"{what}: in none of {tries} tries do {steps} calls add the "
          f"kernel records the counters moved")
    return expect


def exchange_against_plain(result, dev):
    """The exchange Function on the main path's plan against autograd of
    plain indexing (3e-5 against the sum of absolute terms), two backward
    calls bitwise equal, and kernel A as its backward, timed: CUDA events,
    device time (profiler), the plain version, ``index_add_``, the bound.
    Returns the record."""
    import torch
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import exchange
    from repro_torch.tools.kernel_turns import device_us as profiled
    batch = result.batch
    pl = exchange.plan(result.bundle.halo, batch.n_pad, dev)
    f = result.gnn.hidden_dim
    gen = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn((batch.k, batch.n_pad, f), generator=gen, device=dev)
    g = torch.randn(h.shape, generator=gen, device=dev)

    def grads(fn, cot):
        x = h.clone().requires_grad_()
        out = fn(x, pl)
        (out * cot).sum().backward()
        return out.detach(), x.grad
    out, dh = grads(exchange.exchange, g)
    out_ref, dh_ref = grads(exchange.plain, g)
    _, scale = grads(exchange.plain, g.abs())
    check(torch.equal(out, out_ref),
          "the exchange's forward differs from plain indexing")
    err = max_err(dh, dh_ref, scale, "exchange backward (kernel A)")
    check(torch.equal(dh, grads(exchange.exchange, g)[1]),
          "the exchange's backward: two calls differ")
    del dh_ref, scale, out_ref
    csr = pl.csr
    rows, e = csr.num_nodes, int(csr.src.shape[0])
    flat = g.reshape(rows, f)
    keep = ~pl.received.reshape(rows, 1)

    def call():
        return exchange.backward_sum(g, pl)

    def library():
        return torch.index_add(flat * keep, 0, pl.send,
                               flat.index_select(0, pl.recv))
    check(torch.allclose(library(), call().reshape(rows, f), rtol=1e-5,
                         atol=1e-5), "index_add_ does not compute the "
                                     "exchange's backward")
    us, per_call = profiled(call, ("csr_aggregate_gather",
                                   "csr_aggregate_fixup"))
    # g read once (every row: kept rows by their self arc, received rows
    # by the arc of the slot they fill), the arcs and row offsets, the
    # output written once; one multiply-add per arc and feature
    bound, by = bound_ms(4 * (2 * rows * f + 2 * e + rows + 1), 2 * e * f)
    row = {"max_abs_err": err, "bitwise_repeatable": True,
           "device_ms": us * round(per_call) / 1e3,
           "profiled_launches_per_call": per_call,
           "ms": time_ms(call),
           "plain_ms": time_ms(lambda: kernel_a.plain(
               flat, csr.src, csr.dst, csr.weight, rows)),
           "bound_ms": bound, "bound_by": by, "library_ms": time_ms(library),
           "forward_ms": time_ms(lambda: exchange.exchange(h, pl)),
           "shape": {"rows": rows, "F": f, "arcs": e, "pairs": pl.pairs,
                     "k": batch.k, "N_pad": batch.n_pad,
                     "h_pad": int(result.bundle.halo.h_pad)}}
    print(f"exchange backward (kernel A), main path: {json.dumps(row)}")
    return row


def frontier_on_card(dev, ds, cache_dir, local, seeded_acc):
    """Phase 14: the paper's communication-vs-accuracy frontier at the main
    path's width: sync and stale(4) beside phase 5's local run (``local``:
    its row). Gates: finite losses, kernels A and B (and the exchange's
    backward) launched in every run, the exchange on all 60 epochs in sync
    and on the 15 of stale(4)'s schedule only, the bytes order sync >
    stale(4) > local = 0, sync's test accuracy above chance and the seeded
    run's, two sync steps bitwise equal, the exchange against its plain
    version. Returns (rows, the exchange's ``kernels`` row)."""
    import numpy as np
    import torch
    from repro_torch.gnn.halo import make_sync_train_step
    from repro_torch.gnn.train import dropout_generators
    from repro_torch.kernels import exchange, ops
    from repro_torch.optim import adamw_init
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    rows = {"local": local}
    for mode in ("sync", "stale"):
        cfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                             mode=mode, sync_period=4, cache_dir=cache_dir,
                             dataset_kwargs={"scale": ARXIV_SCALE})
        ops.reset_launch_counts()
        result = run_training(cfg, device=dev, ds=ds)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        halo, batch, col = result.bundle.halo, result.batch, result.collectives
        widths = [result.gnn.feature_dim] + [result.gnn.hidden_dim] * (
            result.gnn.num_layers - 1)
        on = [e for e in range(cfg.epochs) if mode == "sync" or e % 4 == 0]
        step_bytes = schedule_bytes(batch.k, halo.h_pad, widths)
        pairs = int((halo.recv_rows >= 0).sum())
        label = "sync" if mode == "sync" else "stale(4)"
        row = {"exchange_epochs": int((result.exchanges > 0).sum()),
               "collectives_total": col["total"],
               "schedule_total": step_bytes,
               "per_epoch_avg": col["per_epoch_avg"],
               "schedule_per_epoch_avg": int(round(
                   step_bytes * len(on) / cfg.epochs)),
               "live_exchange_mb_per_layer": pairs * widths[-1] * 4 / 1e6,
               "padded_gather_mb_per_layer":
                   batch.k * batch.k * halo.h_pad * widths[-1] * 4 / 1e6,
               "pairs": pairs, "h_pad": int(halo.h_pad),
               "ms_per_epoch": 1e3 * result.timings["train_epochs"]
               / cfg.epochs,
               "accuracy": result.accuracy,
               "loss_first": float(result.losses[0].mean()),
               "loss_last": float(result.losses[-1].mean()),
               "batch_cache_hit": result.bundle.batch_hit,
               "timings": result.timings,
               "launches": {k: launches[k] for k in (
                   "fused_gcn_layer_need_agg", "csr_aggregate",
                   "exchange_backward")}}
        print(f"frontier [{label}]: {json.dumps(row)}", flush=True)
        check(bool(np.isfinite(result.losses).all()),
              f"{label}: non-finite training loss")
        check(all(row["launches"][k] > 0 for k in (
            "fused_gcn_layer_need_agg", "csr_aggregate",
            "exchange_backward")),
              f"{label}: a kernel of the path did not launch: {launches}")
        expect = [result.gnn.num_layers if e in on else 0
                  for e in range(cfg.epochs)]
        check(result.exchanges.tolist() == expect,
              f"{label}: exchanges by epoch {result.exchanges.tolist()}, "
              f"expected {expect}")
        graphs = {"exchange": 1, "stale": int(mode == "stale"), "frozen": 0}
        row["compiles"] = result.compiles
        check(result.compiles == graphs,
              f"{label}: captured graphs {result.compiles}, expected "
              f"{graphs}")
        check(col["total"] == step_bytes
              and col["per_epoch_avg"] == row["schedule_per_epoch_avg"],
              f"{label}: the collective report {col} disagrees with the "
              f"schedule ({step_bytes} a step)")
        rows[label] = row
        if mode == "sync":
            sync_launches = launches["exchange_backward"]
            acc = result.accuracy["test"]
            check(acc > 1 / 40 and acc > seeded_acc,
                  f"sync: test accuracy {acc} does not beat chance and the "
                  f"seeded run's {seeded_acc}")
            # two sync steps from the trained state, bitwise
            step = make_sync_train_step(
                result.gnn, exchange.plan(halo, batch.n_pad, dev), False,
                cfg.lr)
            twice = [step(result.params,
                          adamw_init(result.params, stacked=True),
                          result.tensors, dropout_generators(0, batch.k, dev))
                     for _ in range(2)]
            check(all(torch.equal(a, b) for a, b in zip(
                tree_leaves(twice[0][0]), tree_leaves(twice[1][0])))
                  and torch.equal(twice[0][2], twice[1][2]),
                  "two sync steps from one state differ on the card")
            del twice
            opt, gens = (adamw_init(result.params, stacked=True),
                         dropout_generators(0, batch.k, dev))
            row["profile"] = profile_step(
                lambda: step(result.params, opt, result.tensors, gens),
                "sync steps at the main path")
            kernel_row = exchange_against_plain(result, dev)
            inputs = (batch, halo, result.gnn, cfg.lr)
        del result
        torch.cuda.empty_cache()
    check(rows["sync"]["per_epoch_avg"] > rows["stale(4)"]["per_epoch_avg"]
          > local["per_epoch_avg"] == 0,
          "bytes per epoch are not ordered sync > stale(4) > local = 0")
    print("frontier table (arxiv-like 169,343 nodes, k=8, repli, GCN 3x128, "
          "60 epochs):")
    print(f"  {'mode':9s} {'exch':>5s} {'bytes/step':>14s} "
          f"{'bytes/epoch':>14s} {'ms/ep':>7s} {'test':>6s}")
    for label, r in rows.items():
        print(f"  {label:9s} {r['exchange_epochs']:5d} "
              f"{r['collectives_total']:14d} {r['per_epoch_avg']:14d} "
              f"{r['ms_per_epoch']:7.2f} {r['accuracy']['test']:6.4f}")
    print(f"frontier phase: {time.perf_counter() - t0:.1f} s wall")
    kernel = {
        "name": "csr_aggregate_exchange_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_aggregate.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:148",
        "launches": sync_launches, **kernel_row}
    return rows, kernel, inputs


# timing keys of a training run that no span times (the partitioner's and
# the assembly's own seconds, the epoch loop's and the embedding pass's);
# every other key is its stage span's duration when the run is traced
UNSPANNED = ("partition", "assemble", "train_epochs", "train_embed")
SPAN_OF_KEY = {"partition_stage": "pipeline.partition",
               "export": "pipeline.serving_export"}
PROFILE_KERNELS = ("fused_gcn_product",        # kernel B's product
                   "csr_aggregate_gather",     # kernel A (and B's gather)
                   "csr_aggregate_fixup")


def traced_main_path(dev, ds, cache_dir, phase5):
    """Phase 15: the training main path of phase 5 (its partition from the
    cache) with ``repro_torch.obs`` tracing on and a checkpoint directory,
    then 2 epochs at the same width under ``torch.profiler``, then the
    disabled-mode overhead gate (``repro_torch.tools.obs_overhead``).
    ``phase5``: phase 5's untraced table, losses, accuracy and ms/epoch.
    Gates: the trace valid with the pipeline's stages, 60 ``train.epoch``
    spans and ``train.epochs`` 60, every stage timing equal to its span's
    duration, CUDA peak memory > 0, tracing changing no output (table and
    losses bitwise, accuracy equal), the checkpoint's leaves restored into
    freshly seeded parameters giving the table bitwise, kernels A and B
    named in the profile, the projected disabled overhead under 1%."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.gnn.infer import (compute_embeddings,
                                       init_partition_models,
                                       pool_embeddings)
    from repro_torch.obs.summarize import (format_summary, load_trace,
                                           validate_trace)
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    from repro_torch.tools import obs_overhead
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    base = dict(dataset="arxiv-like", k=8, scheme="repli",
                cache_dir=cache_dir, dataset_kwargs={"scale": ARXIV_SCALE})
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-obs-",
                                     dir=ROOT) as work:
        cfg = PipelineConfig(checkpoint_dir=os.path.join(work, "ckpt"),
                             **base)
        obs.reset()
        obs.enable()
        try:
            traced = run_training(cfg, device=dev, ds=ds)
        finally:
            obs.disable()
        t = traced.timings
        doc = load_trace(obs.export_trace(os.path.join(work, "trace.json")))
        problems = validate_trace(doc, require=["dataset", "partition",
                                                "train", "classifier"])
        check(problems == [], f"the trace is not valid: {problems}")
        spans = obs.tracer().spans()
        by_name = {}
        for sp in spans:
            by_name.setdefault(sp.name, []).append(sp.duration)
        n_epochs = len(by_name.get("train.epoch", []))
        counted = obs.counter("train.epochs").value
        check(n_epochs == cfg.epochs and counted == cfg.epochs,
              f"{n_epochs} train.epoch spans and train.epochs {counted}, "
              f"expected {cfg.epochs}")
        off = {}
        for key, value in t.items():
            if key in UNSPANNED:
                continue
            durations = by_name.get(SPAN_OF_KEY.get(key, f"pipeline.{key}"))
            if durations is None or len(durations) != 1 \
                    or durations[0] != value:
                off[key] = (value, durations)
        check(not off, f"timings that are not their span's duration: {off}")
        peak = obs.gauge("cuda.device.peak_bytes_in_use").value
        check(peak is not None and peak > 0,
              f"cuda.device.peak_bytes_in_use is {peak}")
        same_table = torch.equal(traced.embeddings.cpu(), phase5["table"])
        same_losses = bool(np.array_equal(traced.losses, phase5["losses"]))
        check(same_table and same_losses
              and traced.accuracy == phase5["accuracy"],
              f"tracing changed the output: table equal {same_table}, "
              f"losses equal {same_losses}, accuracy {traced.accuracy} "
              f"against phase 5's {phase5['accuracy']}")
        epoch_sum = sum(by_name["train.epoch"])
        out.update(
            untraced_ms_per_epoch=phase5["ms_per_epoch"],
            traced_ms_per_epoch=1e3 * t["train_epochs"] / cfg.epochs,
            epoch_spans_sum_s=epoch_sum, spans=len(spans),
            peak_device_bytes=peak,
            trace_bytes=os.path.getsize(os.path.join(work, "trace.json")))
        print(f"traced main path: untraced {out['untraced_ms_per_epoch']:.2f}"
              f" ms/epoch (phase 5), traced "
              f"{out['traced_ms_per_epoch']:.2f} ms/epoch, {n_epochs} "
              f"train.epoch spans summing to {epoch_sum:.4f} s (loop "
              f"{t['train_epochs']:.4f} s), {len(spans)} spans, trace "
              f"{out['trace_bytes']} bytes; output bitwise equal to phase 5",
              flush=True)
        print("traced main path, 10 hottest spans:")
        print(format_summary(doc, top=10))

        # the checkpoint round trip, on the card
        step_dir = traced.checkpoint_path
        files = os.listdir(step_dir)
        arrs = [f for f in files if f.startswith("arr_")]
        n_leaves = len(tree_leaves(traced.params))
        check(os.path.basename(step_dir) == f"step_{cfg.epochs:08d}"
              and len(arrs) == n_leaves and "manifest.msgpack" in files,
              f"checkpoint {step_dir} holds {sorted(files)}, expected "
              f"{n_leaves} leaves")
        fresh = init_partition_models(traced.gnn, ds.num_classes, cfg.k,
                                      torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = restore_checkpoint(cfg.checkpoint_dir, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        with torch.no_grad():
            table = pool_embeddings(
                compute_embeddings(restored, traced.gnn, traced.tensors),
                traced.tensors, ds.graph.n)
        check(torch.equal(table, traced.embeddings),
              "the table from the restored checkpoint differs from the run's")
        out.update(checkpoint_bytes=sum(os.path.getsize(
                       os.path.join(step_dir, f)) for f in files),
                   checkpoint_leaves=n_leaves,
                   checkpoint_save_s=t["checkpoint"],
                   checkpoint_restore_s=restore_s)
        print(f"checkpoint: {n_leaves} leaves, {out['checkpoint_bytes']} "
              f"bytes, save {t['checkpoint']:.4f} s, restore "
              f"{restore_s:.4f} s; restored table bitwise equal", flush=True)
        del traced, restored, table, fresh
        torch.cuda.empty_cache()

        # 2 epochs under torch.profiler: kernels A and B in its trace
        obs.reset()
        pcfg = PipelineConfig(epochs=2, classifier_epochs=0,
                              torch_profile_dir=os.path.join(work, "prof"),
                              **base)
        profiled = run_training(pcfg, device=dev, ds=ds)
        path = profiled.profile_path
        check(path is not None and os.path.exists(path),
              f"no torch.profiler trace was written ({path}; "
              f"torch.profiler.failed "
              f"{obs.counter('torch.profiler.failed').value})")
        with open(path) as f:
            pdoc = json.load(f)
        kernels = [e["name"] for e in pdoc.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        found = {n: sum(n in k for k in kernels) for n in PROFILE_KERNELS}
        out.update(profile_bytes=os.path.getsize(path),
                   profile_kernel_events=len(kernels),
                   profile_kernels=found,
                   profile_train_s=profiled.timings["train"])
        print(f"torch.profiler, 2 epochs: {len(kernels)} kernel events, "
              f"{out['profile_bytes']} bytes, train stage "
              f"{profiled.timings['train']:.3f} s; kernel events by name "
              f"{json.dumps(found)}", flush=True)
        check(all(found.values()),
              f"kernels missing from the profile: {found}")
        del profiled

    m = obs_overhead.measure(dev)
    out["obs_overhead"] = m
    print(f"obs overhead (karate pipeline on the card): "
          f"{m['span_ns']:.0f} ns a disabled span, {m['metric_op_ns']:.0f} "
          f"ns a metric op; {m['spans']} spans, {m['traced_metric_ops']} "
          f"metric ops traced; untraced wall {m['wall_s']:.4f} s; projected "
          f"disabled overhead {m['projected_ms']:.4f} ms = "
          f"{100 * m['share']:.5f}%", flush=True)
    check(m["share"] < obs_overhead.OVERHEAD_BUDGET,
          f"projected disabled-mode obs overhead {100 * m['share']:.4f}% "
          f"is over 1%")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"traced main path phase: {out['phase_s']:.1f} s wall")
    return out


def inductive_bucket_counts():
    """``serving.bucket.inductive.<b>`` counters (always on): the
    inductive flushes of each bucket so far."""
    from repro_torch import obs
    pre = "serving.bucket.inductive."
    return {int(k[len(pre):]): v["value"] for k, v in
            obs.registry().snapshot(("counter",)).items()
            if k.startswith(pre)}


def run_cli(argv):
    """(exit code, the JSON object it printed, wall s) of one
    ``python -m repro_torch.serving`` command, run in this process."""
    import io
    from repro_torch.serving import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue()), time.perf_counter() - t0


def serving_surface(dev, cache_dir, phase5, a_launches_per_call):
    """Phase 16: serving's command surface on the card, through the
    user's entry point (``repro_torch.serving.cli.main``) at the main
    path's configuration (phase 5's partition, from the cache).

    - ``replay`` with a bundle dir that has no bundle: a miss, which
      trains and exports (kernels B and A launch), then the 10,000-query
      replay; the same command again: a hit (no kernel B launch). Both
      append a bench row to one file, which must then hold 2 rows with the
      card's name and power limit; both give 0 mismatches and 1 degraded
      answer; the hit's kernel A launches are exactly warmup's 7 and one
      per inductive flush;
    - the bundle under ``metis``'s fingerprint raises
      ``StaleServingArtifact``, and ``replay --method metis --bundle``
      serves it (an explicit path skips the key);
    - ``make_server`` on port 0 in a thread: the port's ``client`` (8
      connections, 2,000 queries), then 512 known-node queries over 8
      connections of the phase's own (every label equal to the offline
      key) and 16 inductive ones (the one with no neighbour degraded);
      ``stats`` must show more than one query a flush (batching across
      connections); the server thread joins within 10 s;
    - kernel A at the buckets the hit replay used: error against plain,
      CUDA-event ms, device us a call (``torch.profiler``; its device
      launches a call, ``a_launches_per_call``, from phase 8's profile),
      bound, plain and ``torch.sparse.mm``.

    Returns (summary, the ``kernels`` row)."""
    import threading
    import numpy as np
    from repro_torch.core import PartitionerSpec
    from repro_torch.kernels import ops
    from repro_torch.serving import cli
    from repro_torch.serving.replay import make_zipf_workload
    from repro_torch.serving.store import (EmbeddingStore,
                                           StaleServingArtifact)
    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke-serving-", dir=ROOT)
    bundle_dir = os.path.join(tmp.name, "bundles")
    rows_path = os.path.join(tmp.name, "rows.json")
    bundle = os.path.join(
        bundle_dir,
        f"serving-{PartitionerSpec.parse('leiden_fusion').fingerprint()}.npz")
    argv = ["replay", "--dataset", "arxiv-like", "--nodes", "169343",
            "--k", "8", "--hidden-dim", "128", "--embed-dim", "128",
            "--epochs", "60", "--classifier-epochs", "150",
            "--cache-dir", cache_dir, "--bundle-dir", bundle_dir,
            "--bench-json", rows_path, "--json"]

    def replay_gates(row, label):
        print(f"phase 16 {label}: {json.dumps(row, sort_keys=True)}")
        check(row["label_mismatches"] == 0,
              f"{label}: {row['label_mismatches']} answers differ from the "
              f"offline key")
        check(row["served_by_source"].get("degraded") == 1,
              f"{label}: the zero-neighbour query did not degrade")
        check(row["queries"] == 10_000 and row["device"].startswith("cuda")
              and row["use_kernel"], f"{label}: not the card's replay")
        compiles_gate(row, label)

    # -- replay: a miss (train + export), then a hit ----------------------
    check(not os.path.exists(bundle), "the bundle dir is not empty")
    ops.reset_launch_counts()
    rc, row, wall = run_cli(argv)
    miss_launches = ops.launch_counts()
    check(rc == 0 and os.path.exists(bundle), "replay did not export")
    replay_gates(row, "replay miss")
    print(f"phase 16 replay miss: {wall:.3f} s wall (dataset, training, "
          f"export, replay), launches {json.dumps(miss_launches)}")
    check(miss_launches["fused_gcn_layer_need_agg"] > 0
          and miss_launches["csr_aggregate"] > 0,
          f"the miss did not train on kernels A and B: {miss_launches}")
    with np.load(bundle) as z:
        same = bool(np.array_equal(z["embeddings"], phase5["table"].numpy()))
    print(f"phase 16: the exported table is bitwise phase 5's: {same}")
    out["miss"] = {"wall_s": wall, "row": row, "launches": miss_launches,
                   "table_equals_phase5": same}

    ops.reset_launch_counts()
    before = inductive_bucket_counts()
    rc, row, wall = run_cli(argv)
    hit_launches = ops.launch_counts()
    after = inductive_bucket_counts()
    buckets = {b: after[b] - before.get(b, 0) for b in after
               if after[b] - before.get(b, 0)}
    replay_gates(row, "replay hit")
    print(f"phase 16 replay hit: {wall:.3f} s wall, qps "
          f"{row['throughput_qps']} p50 {row['p50_ms']} ms p99 "
          f"{row['p99_ms']} ms, inductive flushes by bucket {buckets}, "
          f"launches {json.dumps(hit_launches)}")
    check(rc == 0 and hit_launches["fused_gcn_layer"] == 0
          and hit_launches["fused_gcn_layer_need_agg"] == 0,
          f"the hit trained or embedded again: {hit_launches}")
    n_buckets = row["warm_compiles"] // 2      # one inductive graph a bucket
    check(hit_launches["csr_aggregate"]
          == n_buckets + sum(buckets.values()) > n_buckets,
          f"kernel A launches {hit_launches['csr_aggregate']} are not "
          f"warmup's {n_buckets} and one per inductive flush ({buckets})")
    with open(rows_path) as f:
        rows = json.load(f)
    check(len(rows) == 2 and all(r["gpu_name"] and r["power_limit_w"]
                                 for r in rows),
          f"{rows_path}: {len(rows)} rows, card fields "
          f"{[(r.get('gpu_name'), r.get('power_limit_w')) for r in rows]}")
    print(f"phase 16 bench rows: 2, {rows[1]['gpu_name']}, "
          f"{rows[1]['power_limit_w']} W")
    out["hit"] = {"wall_s": wall, "row": row, "launches": hit_launches,
                  "inductive_flushes": buckets}

    # -- stale: another spec's fingerprint is a hard error -----------------
    metis = PartitionerSpec.parse("metis").fingerprint()
    try:
        EmbeddingStore.load(bundle, device=dev, expect_fingerprint=metis)
        stale = False
    except StaleServingArtifact as e:
        stale = True
        print(f"phase 16 stale: {e}")
    check(stale, "a bundle under another spec loaded")
    rc, row, wall = run_cli(["replay", "--method", "metis", "--bundle",
                             bundle, "--json"])
    replay_gates(row, "replay --method metis --bundle")
    out["explicit_bundle"] = {"wall_s": wall, "row": row}

    # -- serve and client across connections -------------------------------
    args = cli.build_parser().parse_args(["serve", "--port", "0",
                                          "--bundle", bundle])
    t0 = time.perf_counter()
    srv, state = cli.make_server(args)
    start_s = time.perf_counter() - t0
    host, port = srv.server_address[:2]
    thread = threading.Thread(target=srv.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    store = state.store
    try:
        rc, client, wall = run_cli(["client", "--host", host, "--port",
                                    str(port), "--concurrency", "8",
                                    "--queries", "2000", "--json"])
        print(f"phase 16 client: {json.dumps(client, sort_keys=True)}")
        check(rc == 0 and client["queries"] == 2000
              and "?" not in client["served_by_source"],
              f"the client's run failed: {client}")
        rng = np.random.default_rng(16)
        nodes = rng.integers(0, store.n, size=512)
        known = [{"op": "query", "id": i, "node": int(v)}
                 for i, v in enumerate(nodes)]
        replies, lats, kwall = cli.send_queries(host, port, known, 8)
        labels = np.asarray([r["label"] for r in replies])
        check([r["node"] for r in replies] == nodes.tolist()
              and bool((labels == store.predictions[nodes]).all()),
              f"{int((labels != store.predictions[nodes]).sum())} of 512 "
              f"TCP answers differ from the offline key")
        print(f"phase 16 tcp known: 512 queries on 8 connections in "
              f"{kwall:.3f} s ({512 / kwall:.1f} qps), p50 "
              f"{np.percentile(lats, 50):.3f} ms p99 "
              f"{np.percentile(lats, 99):.3f} ms; labels equal the key")
        nbs = [nb for node, nb in make_zipf_workload(
            store.n, 2000, unseen_frac=0.1, seed=16) if node >= store.n]
        ind = [{"op": "query", "node": store.n + j,
                "neighbors": [int(x) for x in nbs[j]]} for j in range(16)]
        ind[0]["neighbors"] = []
        replies, _, iwall = cli.send_queries(host, port, ind, 8)
        sources = [r["source"] for r in replies]
        check(sources == ["degraded"] + ["inductive"] * 15,
              f"inductive answers' sources {sources}")
        (stats,), _, _ = cli.send_queries(host, port, [{"op": "stats"}], 1)
        mean_batch = stats["queries_served"] / max(stats["flushes"], 1)
        print(f"phase 16 tcp inductive: 16 in {iwall:.3f} s; server stats "
              f"{stats['queries_served']} queries in {stats['flushes']} "
              f"flushes (mean batch {mean_batch:.2f}), reasons "
              f"{stats['flush_reasons']}")
        check(mean_batch > 1, f"no batching across connections: mean "
                              f"batch {mean_batch}")
        check(state.warm_compiles == 2 * n_buckets
              and stats["steady_state_recompiles"] == 0,
              f"the server's warmup compiled {state.warm_compiles}, then "
              f"{stats['steady_state_recompiles']} in the steady state")
    finally:
        srv.shutdown()
        srv.server_close()
        state.close(10)
        thread.join(10)
    check(not thread.is_alive() and not state.pump_thread.is_alive(),
          "the server did not stop within 10 s")
    out["serve"] = {"start_s": start_s, "client": client,
                    "known_qps": 512 / kwall,
                    "known_p50_ms": float(np.percentile(lats, 50)),
                    "known_p99_ms": float(np.percentile(lats, 99)),
                    "queries_served": stats["queries_served"],
                    "flushes": stats["flushes"], "mean_batch": mean_batch}

    # -- the hit's queries, eager and captured in turns ---------------------
    from repro_torch.serving.replay import run_replay
    rargs = cli.build_parser().parse_args(argv)
    turns_store = EmbeddingStore.load(bundle, device=dev)
    workload = make_zipf_workload(
        turns_store.n, num_queries=rargs.queries, alpha=rargs.alpha,
        unseen_frac=rargs.unseen_frac, max_neighbors=rargs.max_neighbors,
        seed=rargs.seed)
    turns = []
    for capture in (False, True, True, False):
        batcher = cli.make_batcher(turns_store, rargs, capture=capture)
        trow = run_replay(batcher, workload, verify=True)
        label = "captured" if capture else "eager"
        check(trow["served_by_source"].get("degraded") == 1,
              f"{label} replay: the zero-neighbour query did not degrade")
        compiles_gate(trow, f"{label} replay")
        turns.append({"path": label, **{k: trow[k] for k in (
            "throughput_qps", "p50_ms", "p99_ms", "wall_s", "flushes",
            "warm_compiles")}})
        print(f"phase 16 {label} replay: {json.dumps(turns[-1])}")
    out["turns"] = turns
    del turns_store

    # -- kernel A at the buckets the hit replay used -----------------------
    unseen = [nb for node, nb in make_zipf_workload(
        store.n, 10_000, unseen_frac=0.02, seed=0) if node >= store.n]
    cases = {b: star_graph_case(state.batcher.inductive, unseen, b,
                                a_launches_per_call)
             for b in sorted(buckets)}
    top = max(buckets, key=lambda k: (buckets[k], k))
    c = cases[top]
    krow = {
        "name": "csr_aggregate_serving_replay", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_aggregate.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:148",
        "launches": hit_launches["csr_aggregate"],
        "max_abs_err": max(x["err"] for x in cases.values()),
        "ms": c["ms"], "device_ms": c["device_us"] / 1e3,
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "shape": c["shape"], "inductive_flushes": buckets,
        "buckets": {b: {k: x[k] for k in (
            "ms", "device_us", "profiled_launches_per_call", "plain_ms",
            "library_ms", "bound_ms", "live")} for b, x in cases.items()}}
    del state, store, srv
    tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving surface phase: {out['phase_s']:.1f} s wall")
    return out, krow


def tuned_grads(cfg, h, csr, inv, wm, b, g):
    """Forward of one layer (no relu) under ``cfg`` and its gradients in
    (h, W, b) for the cotangent ``g``."""
    import torch
    from repro_torch.kernels import ops
    leaves = [x.detach().clone().requires_grad_() for x in (h, wm, b)]
    out = ops.fused_gcn_layer(leaves[0], csr, inv, leaves[1], leaves[2],
                              activate=False, config=cfg)
    return [out.detach(), *torch.autograd.grad((out * g).sum(), leaves)]


def candidates_against_plain(tens, cands, parts, dev):
    """Phase 17 (a): every candidate, on each partition of ``parts``,
    against the plain version: the forward and the gradients in (h, W, b)
    at 3e-5 (abs + rel, "rel" against the same sums of absolute terms);
    the row-tile variants of ``cuda_fused`` bitwise equal to the 64-row
    one at each ``items``. Returns {candidate: max abs err}."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    gen = torch.Generator(device=dev).manual_seed(17)
    errs = {at.cand_key(c): 0.0 for c in cands}
    names = ("out", "dh", "dW", "db")
    for q in parts:
        csr = tens.csrs[q]
        h = tens.features[q].contiguous()
        inv = ops.inv_degree(tens.in_degree[q])
        nn, f = h.shape
        wm = torch.randn((f, f), generator=gen, device=dev) * 0.1
        b = torch.randn((f,), generator=gen, device=dev) * 0.1
        g = torch.randn((nn, f), generator=gen, device=dev)

        def plain_run(xs, cot):
            leaves = [x.detach().clone().requires_grad_() for x in xs]
            out = plain.fused_gcn_reference(leaves[0], csr.src, csr.dst,
                                            csr.weight, inv, leaves[1],
                                            leaves[2], activate=False)
            return [out.detach(),
                    *torch.autograd.grad((out * cot).sum(), leaves)]
        expect = plain_run((h, wm, b), g)
        scale = plain_run((h.abs(), wm.abs(), b.abs()), g.abs())
        fused64 = {}
        for cfg in cands:
            got = tuned_grads(cfg, h, csr, inv, wm, b, g)
            key = at.cand_key(cfg)
            for name, a, r, s in zip(names, got, expect, scale):
                errs[key] = max(errs[key], max_err(
                    a, r, s, f"candidate {key} {name} (partition {q})"))
            if cfg.strategy == "cuda_fused":
                first = fused64.setdefault(cfg.items, got)
                check(all(torch.equal(x, y) for x, y in zip(first, got)),
                      f"candidate {key} is not bitwise the 64-row tile's "
                      f"result (partition {q})")
        del expect, scale
    return errs


def tuned_kernel_rows(tens, dev, winner, launches):
    """Phase 17 (f): kernel B (``need_agg``, the training forward) at each
    row tile and kernel A over the reversed arcs (the backward's ``dh``)
    at each ``items`` on the 8 main-path partitions: CUDA-event ms (median
    of 10) by partition and their launch-weighted mean, device ms a call
    on the largest partition (``torch.profiler``), the bound. Returns the
    two ``kernels`` rows at the winner's knobs and the sweep."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import fused_layer as kernel_b
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.tools.kernel_turns import device_us as profiled
    gen = torch.Generator(device=dev).manual_seed(1)
    p = int(torch.argmax((tens.edge_weight > 0).sum(dim=1)))
    f = tens.features.shape[-1]
    w0 = torch.randn((f, f), generator=gen, device=dev) * 0.1
    b0 = torch.randn((f,), generator=gen, device=dev) * 0.1
    parts = []
    for q in range(tens.k):
        c = tens.csrs[q]
        inv = ops.inv_degree(tens.in_degree[q])
        rev_w = (c.weight * inv[c.dst.long()])[c.rev_perm].contiguous()
        parts.append(dict(
            c=c, h=tens.features[q].contiguous(), inv=inv, rev_w=rev_w,
            rev_dst=c.src[c.rev_perm].contiguous(),
            g=torch.randn(tens.features[q].shape, generator=gen, device=dev),
            e_live=int((c.weight > 0).sum()),
            rev_live=int((rev_w > 0).sum())))

    def fused(d, nt, items):
        c = d["c"]
        return kernel_b.launch(d["h"], c.src, c.row_ptr, c.weight, d["inv"],
                               w0, b0, need_agg=True, node_tile=nt,
                               items=items)

    def transpose(d, items):
        c = d["c"]
        return kernel_a.launch(d["g"], c.rev_src, c.rev_row_ptr, d["rev_w"],
                               items=items)

    def row_of(kind, knob, call, names, bound_fn, err_fn):
        times = [time_ms(lambda d=d: call(d), iters=10) for d in parts]
        us, n = profiled(lambda: call(parts[p]), names)
        check(n > 0, f"{kind} {knob}: the profiler saw no launch")
        bounds = [bound_fn(d) for d in parts]
        return {"knob": knob, "launch_weighted_mean_ms":
                statistics.mean(times), "per_partition_ms": times,
                "device_ms": us * round(n) / 1e3,
                "profiled_launches_per_call": n,
                "bound_ms": statistics.mean(b for b, _ in bounds),
                "bound_by": bounds[p][1], "max_abs_err": err_fn()}
    nn = tens.features.shape[1]
    e = tens.csrs[0].src.shape[0]
    sweep = {"fused_gcn_layer_need_agg": {}, "csr_aggregate_transpose": {}}
    d = parts[p]
    c = d["c"]
    agg_ref = plain.csr_aggregate_ref(d["h"], c.src, c.dst, c.weight, nn,
                                      d["inv"])
    out_ref = plain.gcn_epilogue(agg_ref, w0, b0, True)
    out_abs = plain.gcn_epilogue(plain.csr_aggregate_ref(
        d["h"].abs(), c.src, c.dst, c.weight, nn, d["inv"]), w0.abs(),
        b0.abs(), False)
    a_ref = kernel_a.plain(d["g"], c.rev_src, d["rev_dst"], d["rev_w"], nn)
    a_abs = kernel_a.plain(d["g"].abs(), c.rev_src, d["rev_dst"],
                           d["rev_w"], nn)
    for nt in kernel_b.NODE_TILES:
        sweep["fused_gcn_layer_need_agg"][nt] = row_of(
            "kernel B", f"node_tile={nt}",
            lambda d, nt=nt: fused(d, nt, winner.items),
            ("fused_gcn_product", "csr_aggregate"),
            lambda d: layer_bound(nn, f, f, e, d["e_live"], need_agg=True),
            lambda nt=nt: max_err(fused(parts[p], nt, winner.items)[0],
                                  out_ref, out_abs,
                                  f"kernel B node_tile {nt}"))
    for items in (0,) + at.ITEMS:
        sweep["csr_aggregate_transpose"][items] = row_of(
            "kernel A", f"items={items}", lambda d, k=items: transpose(d, k),
            ("csr_aggregate",),
            lambda d: transpose_bound(nn, f, e, d["rev_live"]),
            lambda k=items: max_err(transpose(parts[p], k), a_ref, a_abs,
                                    f"kernel A items {k}"))
    for name, rows in sweep.items():
        for knob, row in rows.items():
            print(f"phase 17 {name} {row['knob']}: "
                  f"{json.dumps({k: v for k, v in row.items() if k != 'knob'})}")
    b_row = sweep["fused_gcn_layer_need_agg"][winner.node_tile]
    a_row = sweep["csr_aggregate_transpose"][winner.items]
    d = parts[p]
    rows = []
    for name, src, replaces, row, plain_fn, n_launch in (
            ("fused_gcn_layer_tuned", "src/repro_torch/csrc/fused_layer.cu",
             "src/repro/kernels/fused_layer.py:79", b_row,
             lambda: plain.gcn_epilogue(plain.csr_aggregate_ref(
                 d["h"], c.src, c.dst, c.weight, nn, d["inv"]), w0, b0,
                 True), launches["fused_gcn_layer_need_agg"]),
            ("csr_aggregate_transpose_tuned",
             "src/repro_torch/csrc/csr_aggregate.cu",
             "src/repro/kernels/csr_aggregate.py:148", a_row,
             lambda: kernel_a.plain(d["g"], c.rev_src, d["rev_dst"],
                                    d["rev_w"], nn),
             launches["csr_aggregate"])):
        rows.append({"name": name, "route": "cuda",
                     "source": src, "replaces": replaces,
                     "config": winner.as_dict(), "launches": n_launch,
                     "max_abs_err": row["max_abs_err"],
                     "ms": row["launch_weighted_mean_ms"],
                     "device_ms": row["device_ms"],
                     "per_partition_ms": row["per_partition_ms"],
                     "plain_ms": time_ms(plain_fn, iters=10),
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None,
                     "shape": {"N": nn, "F": f, "E": e, "partitions":
                               tens.k, "profiled_partition": p}})
    library = library_csr(d["rev_dst"], c.rev_src, d["rev_w"], nn)
    rows[1]["library_ms"] = time_ms(lambda: torch.sparse.mm(library,
                                                            d["g"]),
                                    iters=10)
    return rows, sweep


def autotune_on_card(dev, ds, cache_dir, phase5):
    """Phase 17: the autotuner on the card at the main path's bucket
    (phase 5's partition, from the artifact cache): (a) every candidate
    against the plain version on the largest and the heaviest-padded
    partitions; (b) ``autotune`` at the bucket on the partitions' own
    arcs, every candidate's ms and spread, the winner beside the fallback; (c) a second call is a cache hit (``{}``
    and one more ``autotune.cache_hits``), and a subprocess resolves the
    same winner from the cache file; (d) ``run_training`` at phase 5's
    configuration with ``kernel_autotune``: its stage is a cache hit, its
    report names the winner, the winner's kernels launch, and its test
    accuracy is within 0.01 of phase 5's; (e) its bundle replayed with 0
    mismatches; (f) kernels B and A at each knob on the 8 partitions.
    Returns (summary, kernels rows)."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import PartitionerSpec
    from repro_torch.gnn.infer import gather_partition_tensors
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.pipeline.artifacts import PartitionArtifactStore
    from repro_torch.pipeline.pipeline import (PipelineConfig,
                                               PipelineReport, run_training)
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-tuned-",
                                     dir=ROOT) as tmp:
        tcfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                              serving_dir=tmp, cache_dir=cache_dir,
                              kernel_autotune=True,
                              dataset_kwargs={"scale": ARXIV_SCALE})
        bundle = PartitionArtifactStore(cache_dir).load_or_compute(
            ds.graph, PartitionerSpec.parse(tcfg.method), tcfg.k, tcfg.seed,
            tcfg.scheme)
        check(bundle.labels_hit and bundle.batch_hit,
              "phase 17: phase 5's partition is not in the artifact cache")
        tens = gather_partition_tensors(ds, bundle.batch, dev)
        n_pad, e_pad = bundle.batch.n_pad, bundle.batch.e_pad
        f = int(ds.features.shape[1])
        backend = at.backend_key(dev)
        bucket = at.shape_bucket(n_pad, e_pad, f)
        cands = at.candidate_space(bucket, backend)
        print(f"phase 17: backend {backend}, bucket {bucket.key} (n_pad "
              f"{n_pad}, e_pad {e_pad}, f {f}), {len(cands)} candidates",
              flush=True)
        check(bucket.key == "n131072_e524288_f128",
              f"phase 17: the main path's bucket is {bucket.key}")
        check(cands[0] == at.FALLBACK and 16 <= len(cands) <= 20,
              f"phase 17: candidate space {cands}")
        check(at.get_config(n_pad, e_pad, f, backend) == at.FALLBACK,
              "phase 17: the bucket resolves a config before tuning")

        # (a) correctness first
        light = int(torch.argmax((tens.edge_weight > 0).sum(dim=1)))
        heavy = int(torch.argmax((tens.edge_weight == 0).sum(dim=1)))
        t0 = time.perf_counter()
        errs = candidates_against_plain(tens, cands, sorted({light, heavy}),
                                        dev)
        out["correctness_s"] = time.perf_counter() - t0
        out["max_abs_err"] = errs
        print(f"phase 17 (a): every candidate within 3e-5 of the plain "
              f"version on partitions {sorted({light, heavy})} "
              f"(max abs err {max(errs.values()):.3e}), node tiles bitwise "
              f"equal; {out['correctness_s']:.2f} s", flush=True)

        # (b) tuning
        hits = obs.counter("autotune.cache_hits")
        measured_before = obs.counter("autotune.candidates_measured").value
        t0 = time.perf_counter()
        winner, measured = at.autotune(
            n_pad, e_pad, f, backend, repeats=10,
            graphs=zip(tens.csrs, tens.in_degree))
        out["tune_s"] = time.perf_counter() - t0
        with open(os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]) as fh:
            entry = json.load(fh)["configs"][backend][bucket.key]
        spread = entry["spread_ms"]
        check(list(measured) == [at.cand_key(c) for c in cands]
              and obs.counter("autotune.candidates_measured").value
              - measured_before == len(cands),
              f"phase 17: {len(measured)} of {len(cands)} candidates "
              f"measured")
        for key, ms in measured.items():
            print(f"phase 17 (b) candidate {key}: {ms:.4f} ms (spread "
                  f"{spread[key]:.4f})")
        base = at.cand_key(at.FALLBACK)
        fallback_ms = measured[base]
        out.update(winner=winner.as_dict(), winner_ms=measured[
            at.cand_key(winner)], fallback_ms=fallback_ms,
            candidates=len(cands), measured_ms=measured, spread_ms=spread,
            probe=entry["probe"])
        print(f"phase 17 (b): winner {at.cand_key(winner)} "
              f"{out['winner_ms']:.4f} ms, fallback {base} "
              f"{fallback_ms:.4f} ms (spread {spread[base]:.4f}), "
              f"{len(cands)} candidates in {out['tune_s']:.2f} s (fwd+bwd "
              f"of the layer over the {tens.k} partitions, median of 10, "
              f"device clock, launched ahead)", flush=True)
        clear = {k: ms for k, ms in measured.items()
                 if ms < fallback_ms - max(spread[base], spread[k])}
        expect = min(clear, key=clear.get) if clear else base
        check(entry["probe"] == "own graphs"
              and at.cand_key(winner) == expect,
              f"phase 17: the winner {at.cand_key(winner)} is not the "
              f"fallback or the fastest clear win ({expect})")

        # (c) the cache
        before = hits.value
        again, remeasured = at.autotune(n_pad, e_pad, f, backend)
        check(again == winner and remeasured == {}
              and hits.value == before + 1,
              f"phase 17: the second call is not a cache hit ({again}, "
              f"{len(remeasured)} measured, hits {before} -> {hits.value})")
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
                "from repro_torch.kernels.autotune import get_config; "
                "print(json.dumps(get_config(*map(int, sys.argv[2:]))"
                ".as_dict()))")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", code, os.path.join(ROOT, "src"),
             str(n_pad), str(e_pad), str(f)], capture_output=True,
            text=True, timeout=300, check=True, env=dict(os.environ))
        resolved = json.loads(child.stdout.strip().splitlines()[-1])
        print(f"phase 17 (c): second call a cache hit; a subprocess "
              f"resolves {resolved} from "
              f"{os.environ['REPRO_TORCH_AUTOTUNE_CACHE']} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(resolved == winner.as_dict(),
              f"phase 17: the subprocess resolved {resolved}, not the "
              f"winner {winner.as_dict()}")

        # (d) training with the tuned config
        before = hits.value
        ops.reset_launch_counts()
        tuned = run_training(tcfg, device=dev, ds=ds)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        report = PipelineReport.of(tcfg, tuned)
        tt = tuned.timings
        acc = tuned.accuracy
        out.update(
            ms_per_epoch=1e3 * tt["train_epochs"] / tcfg.epochs,
            phase5_ms_per_epoch=phase5["ms_per_epoch"],
            stage_s=tt.get("kernel_autotune"), accuracy=acc,
            phase5_accuracy=phase5["accuracy"], launches=launches,
            report_kernel=report.kernel)
        print(f"phase 17 (d): {report.summary().splitlines()[5].strip()}; "
              f"kernel_autotune stage {tt.get('kernel_autotune', 0):.4f} s; "
              f"ms_per_epoch {out['ms_per_epoch']:.2f} (phase 5 "
              f"{phase5['ms_per_epoch']:.2f}); test acc {acc['test']:.4f} "
              f"(phase 5 {phase5['accuracy']['test']:.4f}); launches "
              f"{json.dumps(launches)}", flush=True)
        check("kernel_autotune" in tt and hits.value == before + 1,
              f"phase 17: the training run's autotune stage was not one "
              f"cache hit (hits {before} -> {hits.value})")
        check(report.kernel == {f"f{f}": winner.as_dict()},
              f"phase 17: report.kernel {report.kernel} does not name the "
              f"winner")
        if winner.strategy == "cuda_fused":
            check(launches["fused_gcn_layer_need_agg"] > 0,
                  f"phase 17: kernel B did not launch: {launches}")
        else:
            check(launches["fused_gcn_layer"] == 0
                  and launches["csr_aggregate"] > 0,
                  f"phase 17: the 'cuda' strategy's launches {launches}")
        check(bool(np.isfinite(tuned.losses).all())
              and abs(acc["test"] - phase5["accuracy"]["test"]) <= 0.01,
              f"phase 17: tuned test accuracy {acc['test']} is not within "
              f"0.01 of phase 5's {phase5['accuracy']['test']}")

        # (e) serving the tuned bundle
        row, _, _, _ = replay_trained_bundle(tuned, tcfg, dev, "phase 17")
        out["replay"] = {k: row[k] for k in (
            "label_mismatches", "known_queries", "throughput_qps",
            "p50_ms", "p99_ms")}

    # (f) kernels B and A at each knob
    rows, sweep = tuned_kernel_rows(tens, dev, winner, launches)
    out["sweep"] = {name: {str(k): {"ms": r["launch_weighted_mean_ms"],
                                    "device_ms": r["device_ms"],
                                    "bound_ms": r["bound_ms"]}
                           for k, r in v.items()}
                    for name, v in sweep.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {out['phase_s']:.1f} s wall", flush=True)
    return out, rows


def compiled_against_eager(dev, ds, inputs, lm_args, lm_report):
    """Phase 18: the compiled steps (one CUDA graph a signature) against
    the eager loop (``capture=False``) on one card. ``inputs``: phase 14's
    batch, halo plan, GNN config and lr (phase 5's partition); ``lm_args``
    and ``lm_report``: phase 9's serve arguments and captured report.
    Returns the phase's rows."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.gnn.halo import (capture_steps, make_stale_train_steps,
                                      train_stale)
    from repro_torch.gnn.infer import (gather_partition_tensors,
                                       init_partition_models)
    from repro_torch.gnn.train import (dropout_generators, make_stacked_step,
                                       train_local)
    from repro_torch.kernels import exchange, ops
    from repro_torch.launch.serve import make_decode, prefill_bucket, serve
    from repro_torch.models.lm import grow_cache, init_model, prefill_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    batch, halo, gnn, lr = inputs
    out = {"dropout": gnn.dropout}
    tensors = gather_partition_tensors(ds, batch, dev)

    def init():
        return init_partition_models(gnn, ds.num_classes, batch.k,
                                     torch.Generator().manual_seed(0), dev)

    # (a) 3 epochs captured and eager from one initialisation
    for mode in ("local", "stale(4)"):
        runs = []
        for capture in (True, False):
            ops.reset_launch_counts()
            kw = dict(epochs=3, lr=lr, seed=0, device=dev, params=init(),
                      tensors=tensors, capture=capture)
            run = (train_local(ds, batch, gnn, **kw) if mode == "local"
                   else train_stale(ds, batch, halo, gnn, sync_period=4,
                                    **kw))
            torch.cuda.synchronize()
            runs.append((run, ops.launch_counts()))
        (cap, cap_launches), (eager, eager_launches) = runs
        same = {"losses": bool(np.array_equal(cap.losses, eager.losses)),
                "params": all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(cap.params), tree_leaves(eager.params))),
                "table": bool(torch.equal(cap.embeddings, eager.embeddings)),
                "launches": cap_launches == eager_launches}
        if mode != "local":
            same["exchanges"] = bool(np.array_equal(cap.exchanges,
                                                    eager.exchanges))
        graphs = ({"local": 1} if mode == "local" else
                  {"exchange": 1, "stale": 1, "frozen": 0})
        print(f"phase 18 (a) {mode}, 3 epochs, dropout {gnn.dropout}: "
              f"bitwise {json.dumps(same)}; graphs {cap.compiles}; mean "
              f"losses {cap.losses.mean(axis=1).tolist()}; launches "
              f"{json.dumps(cap_launches)}", flush=True)
        check(all(same.values()),
              f"phase 18: {mode} captured differs from eager: {same}")
        check(cap.compiles == graphs,
              f"phase 18: {mode} graphs {cap.compiles}, expected {graphs}")
        out[f"equal_{mode}"] = same
        del runs, cap, eager

    # (b) each step, timed in turns and profiled
    plan = exchange.plan(halo, batch.n_pad, dev)

    def stepper(kind, capture):
        """A call of one step that carries its own state on."""
        params = init()
        state = [params, adamw_init(params, stacked=True)]
        gens = dropout_generators(0, batch.k, dev)
        if kind == "local":
            step = make_stacked_step(tensors, gnn, False, lr, dev, capture)

            def call():
                state[0], state[1], _ = step(state[0], state[1], gens)
            return call
        steps = make_stale_train_steps(gnn, plan, False, lr)
        if capture:
            steps = capture_steps(steps, dev)
        if kind == "sync":
            def call():
                state[0], state[1], _, _ = steps["exchange"](
                    state[0], state[1], tensors, gens)
            return call
        caches = steps["exchange"](state[0], state[1], tensors, gens)[3]

        def call():
            state[0], state[1], _ = steps["stale"](state[0], state[1],
                                                   tensors, gens, caches)
        return call

    timing = {}
    for kind in ("local", "sync", "stale"):
        calls = {False: stepper(kind, False), True: stepper(kind, True)}
        for call in calls.values():
            call()              # the captured step captures here
            call()
        torch.cuda.synchronize()
        ms = {False: [], True: []}
        for capture in (False, True, True, False):
            t0 = time.perf_counter()
            for _ in range(10):
                calls[capture]()
            torch.cuda.synchronize()
            ms[capture].append(1e3 * (time.perf_counter() - t0) / 10)
        prof = {c: profile_step(calls[c], f"phase 18 {kind} step, "
                                f"{'captured' if c else 'eager'}", steps=3)
                for c in (False, True)}
        records = {c: kernel_records(calls[c], f"phase 18 {kind} step, "
                                     f"{'captured' if c else 'eager'}")
                   for c in (False, True)}
        check(records[True] == records[False]
              and records[True]["kernel A gather"] > 0
              and records[True]["kernel B product"] > 0,
              f"phase 18: the {kind} step's kernel records differ between "
              f"the captured and eager paths, or hold no kernel A or B: "
              f"{records}")
        timing[kind] = {
            "eager_ms_per_epoch": ms[False], "captured_ms_per_epoch": ms[True],
            **{f"{path}_{k}": prof[c][k] for c, path in ((False, "eager"),
                                                          (True, "captured"))
               for k in ("idle_share", "kernels_per_step",
                         "host_launches_per_step",
                         "device_busy_ms_per_step")},
            "kernel_records_per_2_steps": records[True]}
        print(f"phase 18 (b) {kind} step: {json.dumps(timing[kind])}",
              flush=True)
        del calls
        torch.cuda.empty_cache()
    out["steps"] = timing
    del tensors, plan
    torch.cuda.empty_cache()

    # (c) phase 9's LM: 32 decode steps of its largest bucket, both ways
    cfg = get_config(LM_ARCH)
    params = init_model(cfg, dev, seed=lm_args.seed)
    lengths = np.array(lm_report["prompt_lengths"])
    s_b = max(int(k) for k in lm_report["prefill_buckets"])
    rows = lengths[[prefill_bucket(int(x)) == s_b for x in lengths]]
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (rows.size, s_b)),
                             dtype=torch.int32, device=dev)
    n_steps = lm_args.max_new
    decoded, lm = {}, {}
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, {"tokens": prompt})
        first = logits.argmax(-1).to(torch.int32)[:, None]
        for capture in (True, False):
            path = "captured" if capture else "eager"
            decode = make_decode(params, cfg, dev, capture)
            grown = grow_cache(cache, s_b + n_steps + 24)
            tok = first
            lens = torch.as_tensor(rows, dtype=torch.int32, device=dev)
            toks = torch.empty((rows.size, n_steps), dtype=torch.int32,
                               device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lens, _ = decode(tok, lens, grown)
            toks[:, :1] = tok
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(1, n_steps):
                tok, lens, _ = decode(tok, lens, grown)
                toks[:, i:i + 1] = tok
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoded[capture] = (toks.clone(), grown["layers"]["k"].clone(),
                                grown["layers"]["v"].clone())

            def more():
                nonlocal tok, lens
                tok, lens, _ = decode(tok, lens, grown)
            prof = profile_step(more, f"phase 18 LM decode step, {path}",
                                steps=3)
            records = kernel_records(more, f"phase 18 LM decode step, "
                                     f"{path}")
            check(records["kernel D"] == 2 * cfg.num_layers,
                  f"phase 18: {records['kernel D']} kernel D "
                  f"records in 2 {path} decode steps of {cfg.num_layers} "
                  f"layers")
            lm[path] = {
                "first_step_ms": 1e3 * (t1 - t0),
                "ms_per_step": 1e3 * (t2 - t1) / (n_steps - 1),
                "tok_per_s": rows.size * (n_steps - 1) / (t2 - t1),
                **{k: prof[k] for k in (
                    "idle_share", "kernels_per_step",
                    "host_launches_per_step", "device_busy_ms_per_step")},
                "kernel_records_per_2_steps": records}
            print(f"phase 18 (c) LM {path}, bucket {s_b}, {rows.size} rows:"
                  f" {json.dumps(lm[path])}", flush=True)
            del decode, grown
    same = [bool(torch.equal(a, b)) for a, b in zip(decoded[True],
                                                      decoded[False])]
    print(f"phase 18 (c): {n_steps} tokens of {rows.size} rows, captured "
          f"equal to eager (tokens, k, v): {same}")
    check(all(same), "phase 18: the captured decode's tokens or cache "
                     "differ from the eager decode's")
    del decoded, cache
    reports = {}
    for capture in (False, True):
        rep = serve(lm_args, params=params, capture=capture)
        reports["captured" if capture else "eager"] = {
            k: rep[k] for k in ("decode_tok_per_s", "decode_s", "prefill_s",
                                "decode_compiles", "sample_generation")}
    print(f"phase 18 (c) serve, phase 9's requests: {json.dumps(reports)}; "
          f"phase 9's captured run {lm_report['decode_tok_per_s']:.2f} "
          f"tokens/s")
    check(reports["eager"]["sample_generation"]
          == reports["captured"]["sample_generation"]
          == lm_report["sample_generation"],
          "phase 18: serve's tokens differ between the eager and captured "
          "decodes")
    lm["serve"] = reports
    out["lm"] = lm
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['phase_s']:.1f} s wall", flush=True)
    return out


def lm_train_bound(cfg, batch, seq):
    """The least time one train step of ``cfg`` could take on the card:
    its products at the dense bf16 rate plus AdamW's bytes at the memory
    rate (AdamW waits for every gradient: the clip needs their global
    norm). Products: every layer matmul and the head at 2 flops a
    parameter a token a pass, over the forward, remat's second forward
    (the layers with ``cfg.remat``; the head always: the CE chunk is
    checkpointed) and the backward's two; attention's QK^T and PV over
    the full S x S each sequence (the chunked attention masks, it does not
    skip). AdamW: the parameters read and written, the gradients read, mu
    and nu read and written in f32. Returns a dict of the terms."""
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    ffn = (3 if cfg.ffn_activation == "swiglu" else 2) * d * cfg.d_ff
    layer = d * h * dh + 2 * d * hkv * dh + h * dh * d + ffn
    head = d * cfg.vocab_size
    passes = 4 if cfg.remat else 3
    tokens = batch * seq
    flops = (2 * passes * tokens * cfg.num_layers * layer
             + 2 * 4 * tokens * head
             + passes * 4 * batch * seq * seq * h * dh * cfg.num_layers)
    p_bytes = 2 if cfg.dtype == "bfloat16" else 4
    adamw_bytes = cfg.param_count() * (3 * p_bytes + 16)
    products_ms = 1e3 * flops / (BF16_OPS_PER_S if p_bytes == 2
                                 else F32_OPS_PER_S)
    adamw_ms = 1e3 * adamw_bytes / HBM_BYTES_PER_S
    return {"products_tflop": flops / 1e12, "products_ms": products_ms,
            "adamw_gb": adamw_bytes / 1e9, "adamw_ms": adamw_ms,
            "bound_ms": products_ms + adamw_ms,
            "bound_tokens_per_s": tokens / (products_ms + adamw_ms) * 1e3}


def lm_train_split(cfg, params, opt, batch, lr):
    """One eager train step's device ms in two profiled windows, each
    ended by a synchronize (``torch.profiler``): the gradient (forward,
    remat's recomputation, backward), split by the op that launched each
    kernel into cuBLAS's dense products (``aten::mm``), attention (its
    batched products ``aten::bmm`` and softmax, forward and backward) and
    the rest; then AdamW (``adamw_update_`` as ``make_train_step`` calls
    it), whole. The step's parameters and moments are updated once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import train_loss
    from repro_torch.optim import adamw_update_
    from repro_torch.tree import value_and_grad

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        by_op, kernels, gemm_named = {}, 0.0, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU:
                by_op[e.name] = by_op.get(e.name, 0.0) + \
                    e.self_device_time_total
            else:
                kernels += e.time_range.elapsed_us()
                gemm_named += e.time_range.elapsed_us() * any(
                    w in e.name.lower() for w in GEMM_NAMES)
        return result, by_op, kernels / 1e3, gemm_named / 1e3

    def grads():
        return value_and_grad(lambda p: train_loss(p, cfg, batch), params)
    grads()                                 # warm
    (loss, g), by_op, grad_ms, gemm_ms = window(grads)
    _, _, adamw_ms, _ = window(lambda: adamw_update_(
        g, opt, params, lr, weight_decay=0.01))
    dense = (by_op.get("aten::mm", 0.0) + by_op.get("aten::addmm", 0.0)) / 1e3
    attention = sum(by_op.get(k, 0.0) for k in (
        "aten::bmm", "aten::_softmax", "aten::_softmax_backward_data")) / 1e3
    split = {"cublas dense products": dense,
             "attention (bmm, softmax)": attention,
             "rest of the gradient": grad_ms - dense - attention,
             "adamw": adamw_ms}
    check(dense > 0 and adamw_ms > 0 and bool(torch.isfinite(loss)),
          f"the eager LM train step's profile names no products or no "
          f"AdamW, or its loss is not finite: {split}")
    return {"device_ms": grad_ms + adamw_ms,
            "gemm_named_kernels_ms": gemm_ms, "device_ms_by_part": split}


def launch_train_on_card(dev, smi):
    """Phase 19: ``repro_torch.launch.train`` on both workloads. Returns
    the phase's rows."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.lm import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi,
           "allocated_gb_at_start": torch.cuda.memory_allocated(dev) / 1e9,
           "reserved_gb_at_start": torch.cuda.memory_reserved(dev) / 1e9}
    print(f"phase 19 [{smi}]: {out['allocated_gb_at_start']:.3f} GB "
          f"allocated, {out['reserved_gb_at_start']:.3f} GB reserved at "
          f"the start", flush=True)

    # (a) the paper's workload at the reference launcher's defaults
    args = launcher.parser().parse_args(["--workload", "gnn"])
    ops.reset_launch_counts()
    gnn = launcher.train_gnn(args)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    quality = gnn["partition_quality"]
    out["gnn"] = {**{k: gnn[k] for k in (
        "dataset", "partitioner", "k", "scheme", "model", "partition_time_s",
        "train_time_s", "results", "total_s", "partition_quality")},
        "nodes": args.nodes, "epochs": args.epochs,
        "launches": {k: launches[k] for k in (
            "fused_gcn_layer_need_agg", "fused_gcn_layer", "csr_aggregate")}}
    print(f"phase 19 (a) [{smi}] launch.train --workload gnn at the "
          f"reference's defaults: {json.dumps(out['gnn'])}", flush=True)
    check(quality["total_isolated"] == 0 and quality["max_components"] == 1,
          f"phase 19 (a): a part is not one component or has isolated "
          f"nodes: {quality}")
    check(launches["fused_gcn_layer_need_agg"] > 0
          and launches["csr_aggregate"] > 0,
          f"phase 19 (a): kernels A and B did not both launch: {launches}")
    check(np.isfinite(gnn["results"]["test"])
          and gnn["results"]["test"] > 1 / 40,
          f"phase 19 (a): test accuracy {gnn['results']['test']} does not "
          f"beat chance")

    # (b) the reduced LM: the card against the CPU, captured against eager
    reduced = ["--workload", "lm", "--arch", LM_ARCH, "--reduced",
               "--steps", "4"]
    lr = launcher.parser().parse_args(reduced).lr
    cfg = get_config(LM_ARCH).reduced()
    seeded = init_model(cfg, "cpu", seed=0)
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        rep, _ = launcher.run_lm(
            launcher.parser().parse_args(reduced + ["--device", device.type]),
            params=tree_map(lambda x: x.to(device, copy=True), seeded))
        runs[name] = rep["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    bitwise = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        got = {}
        for capture in (True, False):
            params = init_model(c, dev, seed=0)
            opt = adamw_init(params)
            batch = make_batch(c, 4, 128, seed=0, device=dev)
            step = make_train_step(c, lr=lr, device=dev, capture=capture)
            losses = torch.stack([step(params, opt, batch)[2].clone()
                                  for _ in range(3)])
            got[capture] = [losses] + tree_leaves(
                (params, opt.mu, opt.nu, opt.step))
        bitwise[f"remat={remat}"] = all(
            torch.equal(a, b) for a, b in zip(got[True], got[False]))
        del got, params, opt, step
    out["reduced"] = {"losses_card": runs["card"], "losses_cpu": runs["cpu"],
                      "max_rel_diff": rel, "rtol": LM_TRAIN_RTOL,
                      "captured_equals_eager_3_steps": bitwise}
    print(f"phase 19 (b) [{smi}] reduced {LM_ARCH} (f32, 2 layers), 4 steps "
          f"on the card against the CPU from the same weights, and 3 "
          f"captured steps against 3 eager ones: {json.dumps(out['reduced'])}",
          flush=True)
    check(rel <= LM_TRAIN_RTOL, f"phase 19 (b): the card's losses differ "
                                f"from the CPU's by {rel} (relative)")
    check(runs["card"][-1] < runs["card"][0],
          f"phase 19 (b): the loss did not fall: {runs['card']}")
    check(all(bitwise.values()), f"phase 19 (b): captured steps differ "
                                 f"from eager ones: {bitwise}")

    # (c) qwen3_4b at full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    full = launcher.parser().parse_args(["--workload", "lm", "--arch", LM_ARCH,
                                       "--steps", "10"])
    rep, state = launcher.run_lm(full)
    cfg, params, opt, batch = (state[k] for k in ("cfg", "params", "opt",
                                                  "batch"))
    tokens = full.batch * full.seq
    step_ms = 1e3 * tokens / rep["steady_tokens_per_s"]
    bound = lm_train_bound(cfg, full.batch, full.seq)
    row = {"arch": rep["arch"], "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "params_b": cfg.param_count() / 1e9, "batch": full.batch,
           "seq": full.seq, "lr": full.lr, "losses": rep["losses"],
           "first_loss": rep["first_loss"], "last_loss": rep["last_loss"],
           "tokens_per_s": rep["tokens_per_s"],
           "steady_tokens_per_s": rep["steady_tokens_per_s"],
           "step_ms": step_ms, "first_step_s": rep["first_step_s"],
           "compiles": state["step"].compiles,
           "peak_memory_gb": rep["peak_memory_bytes"] / 1e9,
           "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9,
           "bound": bound, "bound_share": bound["bound_ms"] / step_ms}
    print(f"phase 19 (c) [{smi}] launch.train --workload lm --arch {LM_ARCH}"
          f" (full width): {json.dumps(row)}", flush=True)
    check(all(np.isfinite(rep["losses"])),
          f"phase 19 (c): a loss is not finite: {rep['losses']}")
    check(rep["peak_memory_bytes"] < 80e9,
          f"phase 19 (c): peak device memory {row['peak_memory_gb']:.2f} GB")
    check(state["step"].compiles == 1,
          f"phase 19 (c): {state['step'].compiles} graphs for one shape")
    captured = state["step"]
    row["profile_captured"] = profile_step(
        lambda: captured(params, opt, batch),
        f"phase 19 (c) [{smi}] {LM_ARCH} train step, captured")
    del captured
    state["step"] = None
    gc.collect()
    torch.cuda.empty_cache()
    row["profile_eager"] = lm_train_split(cfg, params, opt, batch, full.lr)
    print(f"phase 19 (c) [{smi}] one eager step's device split: "
          f"{json.dumps(row['profile_eager'])}; bound "
          f"{bound['bound_ms']:.2f} ms ({bound['products_ms']:.2f} products "
          f"+ {bound['adamw_ms']:.2f} AdamW), step {step_ms:.2f} ms: "
          f"{row['bound_share']:.3f} of it", flush=True)
    out["full"] = row
    del state, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['phase_s']:.1f} s wall", flush=True)
    return out



@contextlib.contextmanager
def moe_routing(record=None, replay=None, inputs=None):
    """Record each MoE layer's expert choice (``record``: a list to append
    ``[B, K]`` indices to, in call order) or replay recorded ones
    (``replay``: the gates are this call's own probabilities at the
    replayed experts, renormalised as the router does); ``inputs``: a list
    to append each router call's hidden states to."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod._route
    chosen = iter(replay or ())

    def routed(p, c, x):
        if inputs is not None:
            inputs.append(x)
        probs, gate, idx = route(p, c, x)
        if replay is not None:
            idx = next(chosen)
            gate = probs.gather(-1, idx)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        if record is not None:
            record.append(idx)
        return probs, gate, idx
    moe_mod._route = routed
    try:
        yield
    finally:
        moe_mod._route = route


def moe_kernel_vs_plain_step(params, cfg, cache, tokens, lengths, what):
    """``kernel_vs_plain_step`` for an MoE model. A bf16 rounding in
    attention can swap a row's k-th expert for the next one, which moves
    that row's logits by far more than the rounding: so kernel D and the
    floor (the plain version in the reference kernel's order) run on the
    plain path's expert choices, and are held at ``LM_BF16_TOL`` as
    qwen3_4b's step is; kernel D on its own choices is printed beside
    them, with the (layer, row) choices that differ."""
    import torch
    from repro_torch.kernels import flash_decode as kernel_d
    from repro_torch.models.lm import serve_step
    plain_routes, own_routes = [], []
    with torch.no_grad():
        with decode_attention(kernel_d.plain), moe_routing(plain_routes):
            ref, _ = serve_step(params, cfg, tokens, cache, lengths)
        with decode_attention(plain_q_scaled), moe_routing(
                replay=plain_routes):
            floor, _ = serve_step(params, cfg, tokens, cache, lengths)
        with moe_routing(replay=plain_routes):
            got, _ = serve_step(params, cfg, tokens, cache, lengths)
        with moe_routing(own_routes):
            free, _ = serve_step(params, cfg, tokens, cache, lengths)
    check(all(bool(torch.isfinite(t).all()) for t in (ref, got, free)),
          f"non-finite {what} logits")
    err, floor_err = logits_diff(got, ref), logits_diff(floor, ref)
    free_err = logits_diff(free, ref)
    swapped = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                      .sum()) for a, b in zip(plain_routes, own_routes,
                                              strict=True))
    row = {"max_err_over_max": err[0], "rms_err_over_rms": err[1],
           "floor_max_over_max": floor_err[0],
           "floor_rms_over_rms": floor_err[1],
           "own_routing_max_over_max": free_err[0],
           "own_routing_rms_over_rms": free_err[1],
           "own_routing_swapped_layer_rows": swapped,
           "layer_rows": cfg.num_layers * tokens.shape[0],
           "largest_logit": float(ref.abs().max()),
           "greedy_agree": float((got.argmax(-1) == ref.argmax(-1))
                                 .float().mean()),
           "own_routing_greedy_agree": float(
               (free.argmax(-1) == ref.argmax(-1)).float().mean()),
           "dtype": cfg.dtype, "tol": LM_BF16_TOL}
    print(f"{what}: kernel D vs plain logits {json.dumps(row)}", flush=True)
    check(err[0] <= LM_BF16_TOL and err[1] <= LM_BF16_TOL,
          f"{what}: logits through kernel D disagree with the plain path "
          f"on the same expert choices: {row}")
    return row


def moe_decode_bound(params, cfg, tokens, cache, lengths):
    """The least time one MoE decode step could take on the card, from this
    step's own routing: the bytes it must read (every layer's attention,
    norms, router and shared experts, the routed experts its rows chose,
    the cache up to each row's length with the new row, the head and the
    tokens' embedding rows) and write (the logits), over 3.35 TB/s, or
    its products at the bf16 dense rate, the larger. The routing is read
    off one eager step (it writes the cache row the next step writes
    again). Returns the terms."""
    import torch
    from repro_torch.models.lm import serve_step
    from repro_torch.tree import tree_leaves
    chosen = []
    with torch.no_grad(), moe_routing(chosen):
        serve_step(params, cfg, tokens, cache, lengths)
    torch.cuda.synchronize()

    def size(t):
        return t.numel() * t.element_size()
    rows = tokens.shape[0]
    routed = ("w_gate", "w_up", "w_out")
    touched = [int(torch.unique(i).numel()) for i in chosen]
    weights = active = 0
    for lp, n in zip(params["layers"], touched, strict=True):
        ffn = lp["ffn"]
        dense = sum(size(t) for t in tree_leaves(
            {k: v for k, v in lp.items() if k != "ffn"}))
        dense += sum(size(t) for t in tree_leaves(
            {k: v for k, v in ffn.items() if k not in routed}))
        expert = sum(size(ffn[k][0]) for k in routed)
        weights += dense + n * expert
        active += dense + cfg.top_k * expert
    ck = cache["layers"]["k"]
    filled = int((lengths + 1).sum())
    kv = 2 * cfg.num_layers * filled * ck.shape[3] * ck.shape[4] \
        * ck.element_size()
    head = size(params["head"]) + rows * cfg.d_model \
        * params["embed"].element_size()
    logits = rows * cfg.vocab_size * 4
    nbytes = weights + kv + head + logits
    # 2 flops a weight element a row, attention's two products over the
    # filled rows
    ops = 2 * rows * (active + size(params["head"])) \
        / params["head"].element_size() + 4 * filled * cfg.num_heads \
        * cfg.head_dim * cfg.num_layers
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes_gb": nbytes / 1e9, "weights_gb": weights / 1e9,
            "kv_gb": kv / 1e9, "head_gb": head / 1e9,
            "experts_touched_per_layer": touched,
            "gflop": ops / 1e9, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile_by_kernel(step, table, rest, steps=4):
    """Device ms per call of ``step`` by kernel name (``table``: (label,
    words) pairs, first match wins; ``rest`` labels the others) over
    ``steps`` calls (``torch.profiler``), the idle share, kernels and host
    launches a call, kernel D's records a call and the 8 kernels that
    took longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    split = {name: 0.0 for name, _ in table}
    split[rest] = 0.0
    n = host = n_d = 0
    top = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host += any(w in e.name for w in HOST_LAUNCHES)
            continue
        n += 1
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        key = next((k for k, words in table
                    if any(w in name for w in words)), rest)
        split[key] += us
        n_d += "flash_decode" in name
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + us
    busy = sum(split.values())
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels_per_step": n / steps,
            "host_launches_per_step": host / steps,
            "kernel_d_records_per_step": n_d / steps,
            "device_ms_per_step": {k: v / steps / 1e3
                                   for k, v in split.items()},
            "top_kernels_ms_per_step": {
                k: v / steps / 1e3 for k, v in sorted(
                    top.items(), key=lambda kv: -kv[1])[:8]}}


def profile_moe_decode(step, steps=4):
    """``profile_by_kernel`` of an MoE decode step (``MOE_KERNELS``)."""
    row = profile_by_kernel(step, MOE_KERNELS,
                            "the rest (elementwise, norms, RoPE, copies)",
                            steps)
    check(row["device_busy_ms_per_step"] > 0
          and row["device_ms_per_step"]["kernel D"] > 0,
          "phase 20: the profile of the captured MoE decode step saw no "
          "kernel D")
    return row


def moe_eager_split(step):
    """One eager decode step's device ms by the op that launched each
    kernel (``torch.profiler``): the routed experts' batched products
    (``aten::bmm``), the dense products (``aten::mm``/``addmm``:
    attention's projections, the router, the shared experts, the head),
    the gather (``aten::index``: the chosen experts' weights, the tokens'
    embedding rows), the router's softmax and top-k,
    kernel D (by name: its wrapper is no aten op) and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_op, total, d = {}, 0.0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            by_op[e.name] = by_op.get(e.name, 0.0) + e.self_device_time_total
        else:
            total += e.time_range.elapsed_us()
            d += e.time_range.elapsed_us() * ("flash_decode" in e.name)

    def ops(*names):
        return sum(by_op.get(k, 0.0) for k in names) / 1e3
    split = {"routed expert products (bmm)": ops("aten::bmm"),
             "dense products (mm, addmm)": ops("aten::mm", "aten::addmm"),
             "gather (expert weights, embedding rows)": ops(
                 "aten::index", "aten::index_select"),
             "router softmax / top-k": ops("aten::_softmax", "aten::topk"),
             "kernel D": d / 1e3}
    split["the rest"] = total / 1e3 - sum(split.values())
    return {"device_ms": total / 1e3, "device_ms_by_op": split}


def moe_family(dev, smi):
    """Phase 20: the MoE family, ``qwen2_moe_a2p7b``. Returns the phase's
    rows, kernel D's G 1 row among them."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.launch.serve import make_decode, prefill_bucket, serve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.lm import (_head_weight, grow_cache, init_model,
                                       model_hidden_train, prefill_step,
                                       serve_step, train_loss)
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi,
           "allocated_gb_at_start": torch.cuda.memory_allocated(dev) / 1e9}
    print(f"phase 20 [{smi}]: {out['allocated_gb_at_start']:.3f} GB "
          f"allocated at the start", flush=True)

    # (a) launch.serve at full width, phase 9's requests
    cfg = get_config(MOE_ARCH)
    args = argparse.Namespace(arch=MOE_ARCH, reduced=False, requests=8,
                              min_prompt=64, max_prompt=1024, max_new=32,
                              seed=0, device="cuda")
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=args.seed)
    torch.cuda.synchronize()
    print(f"phase 20 (a) {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"head_dim {cfg.head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.top_k} + {cfg.num_shared_experts} shared of d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{cfg.param_count() / 1e9:.3f} B parameters "
          f"({cfg.active_param_count() / 1e9:.3f} B active) seeded on the "
          f"card in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = serve(args, params=params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    n_buckets = len(report["prefill_buckets"])
    out["serve"] = {**{k: report[k] for k in (
        "prefill_buckets", "prefill_s", "decode_s", "decode_tok_per_s",
        "decode_compiles", "prefill_compiles", "finite",
        "sample_generation")},
        "kernel_d_launches": launches,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(f"phase 20 (a) [{smi}] launch.serve --arch {MOE_ARCH}: "
          f"{json.dumps(out['serve'])}", flush=True)
    check(report["finite"], "phase 20 (a): non-finite MoE logits")
    check(report["decode_compiles"] == n_buckets
          and report["prefill_compiles"] == 0,
          f"phase 20 (a): decode graphs {report['decode_compiles']} for "
          f"{n_buckets} buckets, prefill graphs "
          f"{report['prefill_compiles']}")
    check(launches == cfg.num_layers * args.max_new * n_buckets,
          f"phase 20 (a): kernel D launched {launches} times, not "
          f"{cfg.num_layers} x {args.max_new} x {n_buckets}")

    # (b) one step through kernel D against the plain attention, and the
    # step's bound, on a seeded prefill of the largest bucket
    rng = np.random.default_rng(1)
    lengths = np.array(report["prompt_lengths"])
    s_b = max(int(k) for k in report["prefill_buckets"])
    rows = lengths[[prefill_bucket(int(x)) == s_b for x in lengths]]
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (rows.size, s_b)),
                             dtype=torch.int32, device=dev)
    cur = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    n_steps = args.max_new
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, {"tokens": prompt})
        first = logits.argmax(-1).to(torch.int32)[:, None]
        grown = grow_cache(cache, s_b + n_steps)
    out["kernel_vs_plain"] = moe_kernel_vs_plain_step(
        params, cfg, grown, first, cur,
        f"phase 20 (b) MoE serve step (bucket {s_b}, {rows.size} rows)")
    bound = moe_decode_bound(params, cfg, first, grown, cur)
    out["bound"] = bound
    print(f"phase 20 (b) [{smi}] decode step bound at the bucket's first "
          f"step: {json.dumps(bound)}", flush=True)
    del grown

    # (c) the largest bucket's decode, captured and eager, from one prefill
    decoded, runs = {}, {}
    with torch.no_grad():
        for capture in (True, False):
            path = "captured" if capture else "eager"
            decode = make_decode(params, cfg, dev, capture)
            grown = grow_cache(cache, s_b + n_steps + 8)
            tok = first
            lens = cur.clone()
            toks = torch.empty((rows.size, n_steps), dtype=torch.int32,
                               device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lens, _ = decode(tok, lens, grown)
            toks[:, :1] = tok
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(1, n_steps):
                tok, lens, _ = decode(tok, lens, grown)
                toks[:, i:i + 1] = tok
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoded[capture] = (toks.clone(), grown["layers"]["k"].clone(),
                                grown["layers"]["v"].clone())

            def more():
                nonlocal tok, lens
                tok, lens, _ = decode(tok, lens, grown)
            ms = 1e3 * (t2 - t1) / (n_steps - 1)
            runs[path] = {"first_step_ms": 1e3 * (t1 - t0),
                          "ms_per_step": ms,
                          "tok_per_s": rows.size * 1e3 / ms,
                          "bound_share": bound["bound_ms"] / ms}
            if capture:
                runs[path]["profile"] = profile_moe_decode(more)
            else:
                runs[path]["profile"] = moe_eager_split(more)
            print(f"phase 20 (c) [{smi}] MoE decode {path}, bucket {s_b}, "
                  f"{rows.size} rows: {json.dumps(runs[path])}", flush=True)
            del decode, grown
    same = [bool(torch.equal(a, b)) for a, b in zip(decoded[True],
                                                      decoded[False])]
    out["decode"] = {**runs, "captured_equals_eager": same,
                     "bucket": s_b, "rows": int(rows.size)}
    print(f"phase 20 (a) [{smi}] largest bucket ({s_b}, {rows.size} rows): "
          f"{runs['captured']['ms_per_step']:.3f} ms a decode step "
          f"captured, {runs['captured']['tok_per_s']:.1f} tokens/s, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
          f"{runs['captured']['bound_share']:.3f} of it); serve "
          f"{report['decode_tok_per_s']:.1f} tokens/s, prefill "
          f"{report['prefill_s']:.3f} s, peak {out['serve']['peak_gb']:.2f} "
          f"GB", flush=True)
    print(f"phase 20 (c): {n_steps} tokens of {rows.size} rows, captured "
          f"equal to eager (tokens, k, v): {same}")
    check(all(same), "phase 20 (c): the captured MoE decode's tokens or "
                     "cache differ from the eager decode's")
    del decoded, cache, params, prompt, logits, first
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the reduced family: the card against the CPU, then launch.train
    rcfg = get_config(MOE_ARCH).reduced()
    seeded = init_model(rcfg, "cpu", seed=0)
    grads, losses = {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda x: x.to(device, copy=True), seeded)
        batch = make_batch(rcfg, 4, 64, seed=0, device=device)
        loss, g = value_and_grad(lambda q: train_loss(q, rcfg, batch), p)
        losses[name], grads[name] = float(loss), tree_leaves(g)
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    grad_rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"], strict=True))
    c8 = dataclasses.replace(rcfg, capacity_factor=8.0)
    s = 33
    forward = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda x: x.to(device, copy=True), seeded)
        tokens = make_batch(c8, 2, s + 1, seed=3, device=device)["tokens"]
        with torch.no_grad():
            h, _ = model_hidden_train(p, c8, tokens[:, :s])
            want = (h[:, -1] @ _head_weight(p)).float()
            _, cache, lens = prefill_step(p, c8, {"tokens": tokens[:, :s - 1]})
            cache = grow_cache(cache, s + 8)
            got, _ = serve_step(p, c8, tokens[:, s - 1:s], cache, lens)
        forward[name] = (got.cpu(), want.cpu())
    dec_vs_fwd = float((forward["card"][0] - forward["card"][1]).abs().max())
    card_vs_cpu = float((forward["card"][0] - forward["cpu"][0]).abs().max())
    reduced = ["--workload", "lm", "--arch", MOE_ARCH, "--reduced",
               "--steps", "4"]
    lr = launcher.parser().parse_args(reduced).lr
    trained = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        rep, state = launcher.run_lm(
            launcher.parser().parse_args(reduced + ["--device", device.type]),
            params=tree_map(lambda x: x.to(device, copy=True), seeded))
        with torch.no_grad():
            _, aux = model_hidden_train(state["params"], rcfg,
                                        state["batch"]["tokens"])
        trained[name] = {"losses": rep["losses"], "aux": float(aux),
                         "compiles": state["step"].compiles}
    got = {}
    for capture in (True, False):
        p = tree_map(lambda x: x.to(dev, copy=True), seeded)
        opt = adamw_init(p)
        batch = make_batch(rcfg, 4, 128, seed=0, device=dev)
        step = make_train_step(rcfg, lr=lr, device=dev, capture=capture)
        ls = torch.stack([step(p, opt, batch)[2].clone() for _ in range(3)])
        got[capture] = [ls] + tree_leaves((p, opt.mu, opt.nu, opt.step))
    bitwise = all(torch.equal(a, b) for a, b in zip(got[True], got[False],
                                                   strict=True))
    out["reduced"] = {
        "loss_card": losses["card"], "loss_cpu": losses["cpu"],
        "loss_rel_diff": loss_rel, "grad_diff_over_max": grad_rel,
        "decode_vs_forward_max_abs": dec_vs_fwd,
        "decode_card_vs_cpu_max_abs": card_vs_cpu,
        "logit_scale": float(forward["cpu"][1].abs().max()),
        "tol": MOE_TOL, "launch_train": trained,
        "launch_train_rel_diff": [abs(a - b) / abs(b) for a, b in zip(
            trained["card"]["losses"], trained["cpu"]["losses"])],
        "captured_equals_eager_3_steps": bitwise}
    print(f"phase 20 (d) [{smi}] reduced {MOE_ARCH} (f32, 2 layers, 4 "
          f"experts top-2, 1 shared): {json.dumps(out['reduced'])}",
          flush=True)
    check(loss_rel <= MOE_TOL and grad_rel <= MOE_TOL,
          f"phase 20 (d): train_loss or its gradient differ between the "
          f"card and the CPU ({loss_rel}, {grad_rel})")
    scale = out["reduced"]["logit_scale"]
    check(dec_vs_fwd <= MOE_TOL * (1 + scale)
          and card_vs_cpu <= MOE_TOL * (1 + scale),
          f"phase 20 (d): prefill then decode differs from the train "
          f"forward or from the CPU ({dec_vs_fwd}, {card_vs_cpu})")
    card = trained["card"]
    check(all(np.isfinite(card["losses"])) and card["aux"] > 0
          and card["compiles"] == 1,
          f"phase 20 (d): launch.train on the card: {card}")
    check(bitwise, "phase 20 (d): 3 captured MoE train steps differ from "
                   "3 eager ones")
    del got, seeded, grads
    gc.collect()
    torch.cuda.empty_cache()

    # (e) kernel D at the MoE serving shape: G = H / Hkv = 1
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s_cache = int(rows.size), s_b + n_steps
    q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s_cache, cfg.num_kv_heads, cfg.head_dim),
                        generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    out["kernel_d"] = kernel_d_case(
        q, k, v, torch.as_tensor(rows + 1, dtype=torch.int32, device=dev),
        b, f"phase 20 (e) MoE serving bucket, G 1 (B {b}, S {s_cache}, "
           f"H {cfg.num_heads}, Hkv {cfg.num_kv_heads})")
    del q, k, v
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['phase_s']:.1f} s wall", flush=True)
    return out


def ssm_decode_bound(params, cfg, tokens, cache, lengths):
    """The least time one decode step of a block-pattern model could take
    on the card: the bytes it must read (every layer application's
    weights, so the shared block once per application; the head, or the
    tied embedding; the tokens' embedding rows; the K/V cache up to each
    row's length with the new row; each recurrent state) and write (each
    state, the K/V rows, the logits), over 3.35 TB/s, or its operations
    (2 a weight element a row, attention's two products over the filled
    rows, 4 an f32 state element) at the bf16 dense rate, the larger.
    Returns the terms."""
    from repro_torch.models.lm import _head_weight
    from repro_torch.tree import tree_leaves

    def size(t):
        return t.numel() * t.element_size()
    rows = tokens.shape[0]
    weights = elems = 0
    n_attn = state = state_elems = 0
    filled = int((lengths + 1).sum())
    kv = 0
    for i, kind in enumerate(cfg.blocks):
        lp = params["shared_attn"] if kind == "shared_attn" \
            else params["layers"][i]
        leaves = tree_leaves(lp)
        weights += sum(size(t) for t in leaves)
        elems += sum(t.numel() for t in leaves)
        c = cache["layers"][i]
        if "k" in c:
            n_attn += 1
            kv += 2 * filled * c["k"].shape[2] * c["k"].shape[3] \
                * c["k"].element_size()
        else:
            state += 2 * sum(size(t) for t in c.values())
            state_elems += sum(t.numel() for t in c.values())
    head_w = _head_weight(params)
    head = size(head_w) + rows * cfg.d_model * params["embed"].element_size()
    logits = rows * cfg.vocab_size * 4
    nbytes = weights + kv + state + head + logits
    ops = 2 * rows * (elems + head_w.numel()) \
        + 4 * filled * cfg.num_heads * cfg.head_dim * n_attn \
        + 4 * state_elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes_gb": nbytes / 1e9, "weights_gb": weights / 1e9,
            "kv_gb": kv / 1e9, "state_read_written_gb": state / 1e9,
            "head_gb": head / 1e9, "attention_applications": n_attn,
            "gflop": ops / 1e9, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def captured_and_eager(params, cfg, dev, cache, first, cur, length, steps,
                       bound, table, what, bucket, eager_split=None):
    """``steps`` greedy decode steps of one bucket from ``first`` at the
    rows' lengths ``cur``, captured (``launch.serve.make_decode``) and
    eager, each over its own ``grow_cache(cache, length)``: ms a step
    (host clock, after the first), tokens/s and the share of ``bound``,
    the captured step's ``profile_by_kernel`` over ``table`` and, given
    ``eager_split``, its reading of an eager step. Returns the runs and,
    leaf by leaf (tokens, logits, every cache leaf), whether the two
    paths are bitwise equal."""
    import torch
    from repro_torch.launch.serve import make_decode
    from repro_torch.models.lm import grow_cache
    from repro_torch.tree import tree_leaves
    rows = first.shape[0]
    decoded, runs = {}, {}
    with torch.no_grad():
        for capture in (True, False):
            path = "captured" if capture else "eager"
            decode = make_decode(params, cfg, dev, capture)
            grown = grow_cache(cache, length)
            tok, lens = first, cur.clone()
            toks = torch.empty((rows, steps), dtype=torch.int32, device=dev)
            every = torch.empty((steps, rows, cfg.vocab_size), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                tok, lens, lg = decode(tok, lens, grown)
                toks[:, i:i + 1] = tok
                every[i] = lg
                if i == 0:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoded[capture] = [toks.clone(), every] + [
                t.clone() for t in tree_leaves(grown)]

            def more():
                nonlocal tok, lens
                tok, lens, _ = decode(tok, lens, grown)
            ms = 1e3 * (t2 - t1) / (steps - 1)
            runs[path] = {"first_step_ms": 1e3 * (t1 - t0),
                          "ms_per_step": ms,
                          "tok_per_s": rows * 1e3 / ms,
                          "bound_share": bound["bound_ms"] / ms}
            if capture:
                runs[path]["profile"] = profile_by_kernel(more, table,
                                                          "the rest")
            elif eager_split is not None:
                runs[path]["split"] = eager_split(more)
            print(f"{what} {path}, bucket {bucket}, {rows} rows: "
                  f"{json.dumps(runs[path])}", flush=True)
            del decode, grown
    same = [bool(torch.equal(a, b)) for a, b in zip(
        decoded[True], decoded[False], strict=True)]
    return runs, same


def ssm_serving(dev, smi, arch, steps=32):
    """Phase 21 (a)-(c) for one arch: ``launch.serve`` at full width, then
    at the largest bucket kernel D against the plain attention (where the
    arch attends), the step's bound, and 32 steps captured against 32
    eager. Returns the rows and the bucket (for (f))."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_bucket, serve
    from repro_torch.models.lm import grow_cache, init_model, prefill_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    args = argparse.Namespace(arch=arch, reduced=False, requests=8,
                              min_prompt=64, max_prompt=1024, max_new=steps,
                              seed=0, device="cuda")
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=args.seed)
    torch.cuda.synchronize()
    kinds = {k: cfg.blocks.count(k) for k in dict.fromkeys(cfg.blocks)}
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"phase 21 (a) {cfg.name}: {cfg.num_layers} layers {kinds}, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, ssm_state "
          f"{cfg.ssm_state_dim}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, {cfg.dtype}; {n_params / 1e9:.4f} B "
          f"distinct parameters seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = serve(args, params=params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    n_buckets = len(report["prefill_buckets"])
    n_attn = sum(k in ("attn", "shared_attn") for k in cfg.blocks)
    out = {"params_b": n_params / 1e9, "kinds": kinds, "serve": {
        **{k: report[k] for k in (
            "prefill_buckets", "prefill_s", "decode_s", "decode_tok_per_s",
            "decode_compiles", "prefill_compiles", "finite",
            "sample_generation")},
        "kernel_d_launches": launches,
        "kernel_d_launches_per_step": n_attn,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
    print(f"phase 21 (a) [{smi}] launch.serve --arch {arch}: "
          f"{json.dumps(out['serve'])}", flush=True)
    check(report["finite"], f"phase 21 (a): non-finite {arch} logits")
    check(report["decode_compiles"] == n_buckets
          and report["prefill_compiles"] == 0,
          f"phase 21 (a): {arch}: decode graphs {report['decode_compiles']} "
          f"for {n_buckets} buckets, prefill graphs "
          f"{report['prefill_compiles']}")
    check(launches == n_attn * steps * n_buckets,
          f"phase 21 (a): {arch}: kernel D launched {launches} times, not "
          f"{n_attn} x {steps} x {n_buckets}")

    # the largest bucket: a seeded prefill, its rows at their own lengths
    rng = np.random.default_rng(1)
    lengths = np.array(report["prompt_lengths"])
    s_b = max(int(k) for k in report["prefill_buckets"])
    rows = lengths[[prefill_bucket(int(x)) == s_b for x in lengths]]
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (rows.size, s_b)),
                             dtype=torch.int32, device=dev)
    cur = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, {"tokens": prompt})
    first = logits.argmax(-1).to(torch.int32)[:, None]
    target = s_b + steps
    if n_attn:
        # (b) kernel D against the plain attention, each from a fresh copy
        # of the prefill's cache (a step advances the Mamba2 states)
        _, out["kernel_vs_plain"] = kernel_vs_plain_step(
            params, cfg, None, first, cur,
            f"phase 21 (b) [{smi}] {arch} serve step (bucket {s_b}, "
            f"{rows.size} rows)", fresh=lambda: grow_cache(cache, target))
    bound = ssm_decode_bound(params, cfg, first, grow_cache(cache, target),
                             cur)
    out["bound"] = bound
    print(f"phase 21 (a) [{smi}] {arch} decode step bound at the bucket's "
          f"first step: {json.dumps(bound)}", flush=True)

    # (c) the bucket's decode captured and eager, from one prefill
    runs, same = captured_and_eager(
        params, cfg, dev, cache, first, cur, target + 8, steps, bound,
        SSM_KERNELS, f"phase 21 (c) [{smi}] {arch} decode", s_b)
    out["decode"] = {**runs, "bucket": s_b, "rows": int(rows.size),
                     "leaves_compared": len(same),
                     "captured_equals_eager": all(same)}
    prof = runs["captured"]["profile"]
    print(f"phase 21 (a) [{smi}] {arch} largest bucket ({s_b}, {rows.size} "
          f"rows): {runs['captured']['ms_per_step']:.3f} ms a decode step "
          f"captured, {runs['captured']['tok_per_s']:.1f} tokens/s, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
          f"{runs['captured']['bound_share']:.3f} of it); serve "
          f"{report['decode_tok_per_s']:.1f} tokens/s, prefill "
          f"{report['prefill_s']:.3f} s, peak {out['serve']['peak_gb']:.2f} "
          f"GB, kernel D {launches} launches", flush=True)
    print(f"phase 21 (c): {steps} tokens of {rows.size} rows, captured "
          f"equal to eager bit for bit in tokens, logits and "
          f"{len(same) - 2} cache leaves: {same}", flush=True)
    check(all(same), f"phase 21 (c): {arch}: the captured decode's tokens, "
                     f"logits or cache differ from the eager decode's")
    check(prof["device_busy_ms_per_step"] > 0
          and (prof["device_ms_per_step"]["kernel D"] > 0) == (n_attn > 0),
          f"phase 21 (c): {arch}: the profile of the captured decode step "
          f"saw no kernel, or kernel D where it should not (or not where it "
          f"should): {prof['device_ms_per_step']}")
    del cache, params, prompt, logits, first
    return out, (s_b + steps, rows)


def ssm_reduced_card_vs_cpu(dev, smi):
    """Phase 21 (d): the reduced families (f32; xlstm's 2 layers, zamba2
    at 6 layers, so that one ``shared_attn`` is present), the card
    against the CPU from the same weights: ``train_loss`` and its
    gradient at batch 4 x 160 (a 128-token chunk and a padded one), and
    prefill of 149 tokens then one decode step against the train forward
    at position 149."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.lm import (_head_weight, grow_cache, init_model,
                                       model_hidden_train, prefill_step,
                                       serve_step, train_loss)
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    out = {}
    for arch in SSM_ARCHS:
        rcfg = get_config(arch).reduced()
        if "shared_attn" in get_config(arch).blocks:
            rcfg = dataclasses.replace(rcfg, num_layers=6)
        seeded = init_model(rcfg, "cpu", seed=0)
        grads, losses, forward = {}, {}, {}
        s = 150
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            p = tree_map(lambda x: x.to(device, copy=True), seeded)
            batch = make_batch(rcfg, 4, 160, seed=0, device=device)
            loss, g = value_and_grad(lambda q: train_loss(q, rcfg, batch), p)
            losses[name], grads[name] = float(loss), tree_leaves(g)
            tokens = make_batch(rcfg, 2, s, seed=3, device=device)["tokens"]
            with torch.no_grad():
                h, _ = model_hidden_train(p, rcfg, tokens)
                want = (h[:, -1] @ _head_weight(p)).float()
                _, cache, lens = prefill_step(p, rcfg,
                                              {"tokens": tokens[:, :s - 1]})
                cache = grow_cache(cache, s + 8)
                got, _ = serve_step(p, rcfg, tokens[:, s - 1:s], cache, lens)
            forward[name] = (got.cpu(), want.cpu())
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        grad_rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                       for a, b in zip(grads["card"], grads["cpu"],
                                       strict=True))
        row = {"blocks": list(rcfg.blocks),
               "loss_card": losses["card"], "loss_cpu": losses["cpu"],
               "loss_rel_diff": loss_rel, "grad_diff_over_max": grad_rel,
               "decode_vs_forward_max_abs": float(
                   (forward["card"][0] - forward["card"][1]).abs().max()),
               "decode_card_vs_cpu_max_abs": float(
                   (forward["card"][0] - forward["cpu"][0]).abs().max()),
               "logit_scale": float(forward["cpu"][1].abs().max()),
               "tol": SSM_TOL}
        out[arch] = row
        print(f"phase 21 (d) [{smi}] reduced {arch} (f32, {rcfg.num_layers} "
              f"layers), the card against the CPU: {json.dumps(row)}",
              flush=True)
        scale = row["logit_scale"]
        check(loss_rel <= SSM_TOL and grad_rel <= SSM_TOL,
              f"phase 21 (d): {arch}: train_loss or its gradient differ "
              f"between the card and the CPU ({loss_rel}, {grad_rel})")
        check(row["decode_vs_forward_max_abs"] <= SSM_TOL * (1 + scale)
              and row["decode_card_vs_cpu_max_abs"] <= SSM_TOL * (1 + scale),
              f"phase 21 (d): {arch}: prefill then decode differs from the "
              f"train forward or from the CPU: {row}")
        del seeded, grads, forward
    return out


def ssm_train_bound(cfg, params, batch, seq):
    """The least time one train step could take on the card: its products
    at the dense bf16 rate (every layer application's weights and the head
    at 2 flops a weight element a token a pass, over the forward, remat's
    second forward and the backward's two; the shared attention's QK^T
    and PV over S x S; the chunked scan's intra-chunk and state products)
    plus AdamW's bytes at the memory rate (as ``lm_train_bound``)."""
    from repro_torch.models.lm import _head_weight
    from repro_torch.models.ssm import MAMBA_HEAD_DIM
    from repro_torch.tree import tree_leaves
    tokens = batch * seq
    passes = 4 if cfg.remat else 3
    layer_elems = scan = attn = 0
    c = min(cfg.chunk_size, seq)
    nc = -(-seq // c)
    for i, kind in enumerate(cfg.blocks):
        lp = params["shared_attn"] if kind == "shared_attn" \
            else params["layers"][i]
        layer_elems += sum(t.numel() for t in tree_leaves(lp))
        if kind in ("attn", "shared_attn"):
            attn += 4 * batch * seq * seq * cfg.num_heads * cfg.head_dim
        elif kind in ("mamba", "mlstm"):
            if kind == "mamba":
                h, dk, dv = (2 * cfg.d_model // MAMBA_HEAD_DIM,
                             cfg.ssm_state_dim, MAMBA_HEAD_DIM)
            else:
                h = cfg.num_heads
                dk = dv = cfg.d_model // h
            # per chunk: q k^T and its product with v, the state read and
            # the state update
            scan += 2 * batch * nc * h * (c * c * (dk + dv) + 2 * c * dk * dv)
    flops = (passes * (2 * tokens * layer_elems + attn + scan)
             + 2 * 4 * tokens * _head_weight(params).numel())
    n = sum(t.numel() for t in tree_leaves(params))
    p_bytes = 2 if cfg.dtype == "bfloat16" else 4
    adamw_bytes = n * (3 * p_bytes + 16)
    products_ms = 1e3 * flops / BF16_OPS_PER_S
    adamw_ms = 1e3 * adamw_bytes / HBM_BYTES_PER_S
    return {"products_tflop": flops / 1e12, "products_ms": products_ms,
            "adamw_gb": adamw_bytes / 1e9, "adamw_ms": adamw_ms,
            "bound_ms": products_ms + adamw_ms}


# the profiler ranges ``ssm_ranges`` opens, and the part of a train step
# each names
SSM_RANGES = {"phase21.chunked_scan": "chunked scan",
              "phase21.slstm_loop": "sLSTM loop", "phase21.adamw": "adamw"}


@contextlib.contextmanager
def ssm_ranges():
    """Open a ``torch.profiler`` range around each call of the chunked
    scan (``ssm.chunked_linear_attention``), of each sLSTM cell and of the
    train step's AdamW, so a profile can give their forward kernels (and,
    by sequence number, their backward ones) to them."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import ssm
    saved = (ssm.chunked_linear_attention, ssm._slstm_cell,
             steps.adamw_update_)

    def ranged(fn, label):
        def call(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return call
    ssm.chunked_linear_attention = ranged(saved[0], "phase21.chunked_scan")
    ssm._slstm_cell = ranged(saved[1], "phase21.slstm_loop")
    steps.adamw_update_ = ranged(saved[2], "phase21.adamw")
    try:
        yield
    finally:
        (ssm.chunked_linear_attention, ssm._slstm_cell,
         steps.adamw_update_) = saved


def ranged_ops(raw, ranges):
    """The CPU ops of a raw profile (``kineto_results.events()``) placed
    in ``ranges`` (profiler range name -> part): by correlation id, each
    op's ``(part, backward node)`` (the range it ran inside, from its
    ancestors, and the backward node it ran under as its forward thread
    and sequence number), and by ``(thread, sequence number)`` the part
    of each forward op inside a range. Each thread's ops nest by their
    time spans."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e for e in raw if e.device_type() != cuda),
                 key=lambda e: (e.start_thread_id(), e.start_ns(),
                                -e.duration_ns()))
    info, forward, stack = {}, {}, []
    for e in ops:
        tid, t0 = e.start_thread_id(), e.start_ns()
        while stack and (stack[-1][0] != tid or stack[-1][1] <= t0):
            stack.pop()
        part, bwd = stack[-1][2] if stack else (None, None)
        name = e.name()
        part = ranges.get(name, part)
        if name.startswith("autograd::engine::evaluate_function"):
            bwd = (e.fwd_thread_id(), e.sequence_nr())
        if part is not None and e.sequence_nr() >= 0 and bwd is None:
            forward[(tid, e.sequence_nr())] = part
        info[e.correlation_id()] = (part, bwd)
        stack.append((tid, t0 + e.duration_ns(), (part, bwd)))
    return info, forward


def ssm_step_split(step):
    """``step()`` (one eager train step) under ``torch.profiler``; returns
    its result and its device ms by part: each kernel goes to the chunked
    scan, the sLSTM loop or AdamW when the op that launched it ran inside
    one of ``ssm_ranges`` (the forward, remat's recomputation, AdamW) or
    is the backward of an op that did (linked by the forward thread and
    autograd sequence number), else to cuBLAS's dense products by kernel
    name, else to the rest. The window holds ~10^5 ops for xlstm, so it
    reads the profiler's raw events (``FunctionEvent`` trees of that
    many take minutes to build) and nests each thread's ops by their
    time spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with ssm_ranges(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        out = step()
        torch.cuda.synchronize()
    raw = list(prof.profiler.kineto_results.events())
    info, forward = ranged_ops(raw, SSM_RANGES)
    split = {"cublas dense products": 0.0, "chunked scan": 0.0,
             "sLSTM loop": 0.0, "adamw": 0.0, "the rest": 0.0}
    for k in raw:
        # the ranges also show on the device's timeline: not kernels
        if k.device_type() != cuda or k.name() in SSM_RANGES:
            continue
        part, bwd = info.get(k.linked_correlation_id(), (None, None))
        part = part or forward.get(bwd)
        if part is None:
            part = ("cublas dense products" if any(
                w in k.name().lower() for w in GEMM_NAMES) else "the rest")
        split[part] += k.duration_ns() / 1e6
    check(sum(split.values()) > 0 and split["adamw"] > 0,
          f"phase 21 (e): the eager train step's profile names no kernel "
          f"or no AdamW: {split}")
    return out, {"device_ms": sum(split.values()),
                 "device_ms_by_part": split}


def ssm_training(dev, smi, arch, seq=256):
    """Phase 21 (e) for one arch: ``launch.train --workload lm`` at full
    width, batch 4 x ``seq`` (two chunks of 128), 3 captured steps; the
    same 3 steps eager from the same seeded weights, bitwise equal, the
    last one profiled for its device split."""
    import gc
    import numpy as np
    import torch
    from repro_torch.launch import train as launcher
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = launcher.parser().parse_args(
        ["--workload", "lm", "--arch", arch, "--steps", "3", "--batch", "4",
         "--seq", str(seq)])
    rep, state = launcher.run_lm(full)
    cfg, batch = state["cfg"], state["batch"]
    tokens = full.batch * full.seq
    step_ms = 1e3 * tokens / rep["steady_tokens_per_s"]
    bound = ssm_train_bound(cfg, state["params"], full.batch, full.seq)
    row = {"arch": rep["arch"], "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "params_b": sum(t.numel() for t in tree_leaves(state["params"]))
           / 1e9, "batch": full.batch, "seq": full.seq, "lr": full.lr,
           "losses": rep["losses"], "step_ms": step_ms,
           "steady_tokens_per_s": rep["steady_tokens_per_s"],
           "first_step_s": rep["first_step_s"],
           "compiles": state["step"].compiles,
           "peak_memory_gb": rep["peak_memory_bytes"] / 1e9,
           "bound": bound, "bound_share": bound["bound_ms"] / step_ms,
           "launch_train_s": time.perf_counter() - t0}
    print(f"phase 21 (e) [{smi}] launch.train --workload lm --arch {arch} "
          f"(full width): {json.dumps(row)}", flush=True)
    check(all(np.isfinite(rep["losses"])),
          f"phase 21 (e): {arch}: a loss is not finite: {rep['losses']}")
    check(state["step"].compiles == 1,
          f"phase 21 (e): {arch}: {state['step'].compiles} graphs for one "
          f"shape")
    check(rep["peak_memory_bytes"] < 80e9,
          f"phase 21 (e): {arch}: peak device memory "
          f"{row['peak_memory_gb']:.2f} GB")
    captured = [t.clone() for t in tree_leaves(
        (state["params"], state["opt"].mu, state["opt"].nu,
         state["opt"].step))]
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps eager, from the same seeded weights; the last one
    # profiled (the profiler changes no result)
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=full.seed)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=full.lr, device=dev, capture=False)
    losses = [float(step(params, opt, batch)[2])
              for _ in range(full.steps - 1)]
    (_, _, loss), row["profile_eager"] = ssm_step_split(
        lambda: step(params, opt, batch))
    losses.append(float(loss))
    same = losses == rep["losses"] and all(
        torch.equal(a, b) for a, b in zip(
            captured, tree_leaves((params, opt.mu, opt.nu, opt.step)),
            strict=True))
    row["captured_equals_eager"] = same
    row["eager_steps_s"] = time.perf_counter() - t0
    print(f"phase 21 (e) [{smi}] {arch}: launch.train's {full.steps} "
          f"captured steps against {full.steps} eager ones at full width "
          f"(losses, parameters, moments) bitwise equal: {same}; the last "
          f"eager step's device split: {json.dumps(row['profile_eager'])}; "
          f"bound {bound['bound_ms']:.2f} ms, step {step_ms:.2f} ms "
          f"captured: {row['bound_share']:.3f} of it", flush=True)
    check(same, f"phase 21 (e): {arch}: captured train steps differ from "
                f"eager ones")
    del captured, params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return row


def ssm_families(dev, smi):
    """Phase 21: the SSM and hybrid families, ``xlstm_125m`` and
    ``zamba2_1p2b``. Returns the phase's rows, kernel D's D 64, G 1 row
    among them."""
    import gc
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi,
           "allocated_gb_at_start": torch.cuda.memory_allocated(dev) / 1e9}
    print(f"phase 21 [{smi}]: {out['allocated_gb_at_start']:.3f} GB "
          f"allocated at the start", flush=True)
    buckets, wall = {}, {}
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        out[arch], buckets[arch] = ssm_serving(dev, smi, arch)
        gc.collect()
        torch.cuda.empty_cache()
        wall[f"serve {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["reduced"] = ssm_reduced_card_vs_cpu(dev, smi)
    wall["reduced"] = time.perf_counter() - t0
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        out[arch]["train"] = ssm_training(dev, smi, arch)
        wall[f"train {arch}"] = time.perf_counter() - t0
    out["wall_s"] = wall

    # (f) kernel D at zamba2's serving shape: D 64, G = H / Hkv = 1
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_1p2b")
    s_cache, rows = buckets["zamba2_1p2b"]
    gen = torch.Generator(device=dev).manual_seed(5)
    b = int(rows.size)
    q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s_cache, cfg.num_kv_heads, cfg.head_dim),
                        generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    out["kernel_d"] = kernel_d_case(
        q, k, v, torch.as_tensor(rows + 1, dtype=torch.int32, device=dev),
        b, f"phase 21 (f) zamba2 serving bucket, D {cfg.head_dim}, G 1 "
           f"(B {b}, S {s_cache}, H {cfg.num_heads}, Hkv "
           f"{cfg.num_kv_heads})")
    out["kernel_d"]["launches_zamba2_serve"] = \
        out["zamba2_1p2b"]["serve"]["kernel_d_launches"]
    del q, k, v
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 21: {out['phase_s']:.1f} s wall "
          f"({json.dumps(wall)})", flush=True)
    return out


def serve_prompts(args, cfg, dev):
    """The prompts ``launch.serve.serve`` draws for ``args``: its lengths,
    then each bucket's batch in bucket order (its tokens and the
    frontends' inputs, ``launch.serve.bucket_batch``), from the same numpy
    seed (``{bucket: (request ids, batch on dev)}``, the lengths)."""
    import numpy as np
    from repro_torch.launch.serve import bucket_batch, prefill_bucket
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(args.min_prompt, args.max_prompt + 1,
                           args.requests)
    buckets = np.array([prefill_bucket(int(s)) for s in lengths])
    out = {}
    for s_b in sorted(set(buckets.tolist())):
        idx = np.where(buckets == s_b)[0]
        out[s_b] = (idx, bucket_batch(rng, cfg, idx.size, s_b, dev))
    return out, lengths


def mla_decode_bound(params, cfg, tokens, cache, lengths):
    """``moe_decode_bound`` extended to MLA and the leading dense layers:
    the bytes one decode step must read (every layer's attention and
    norms, the dense layers' FFNs, each MoE layer's router and shared
    experts, the routed experts its rows chose counted once, the latent
    cache up to each row's length with the new row, the head and the
    tokens' embedding rows) and write (the logits), over 3.35 TB/s, or its
    products at the bf16 dense rate, the larger."""
    import torch
    from repro_torch.models.lm import serve_step
    from repro_torch.tree import tree_leaves
    chosen = []
    with torch.no_grad(), moe_routing(chosen):
        serve_step(params, cfg, tokens, cache, lengths)
    torch.cuda.synchronize()

    def size(t):
        return t.numel() * t.element_size()
    rows = tokens.shape[0]
    routed = ("w_gate", "w_up", "w_out")
    touched = [int(torch.unique(i).numel()) for i in chosen]
    weights = active = 0
    for lp in params["first_dense"]:
        weights += sum(size(t) for t in tree_leaves(lp))
    active = weights
    for lp, n in zip(params["layers"], touched, strict=True):
        ffn = lp["ffn"]
        dense = sum(size(t) for t in tree_leaves(
            {k: v for k, v in lp.items() if k != "ffn"}))
        dense += sum(size(t) for t in tree_leaves(
            {k: v for k, v in ffn.items() if k not in routed}))
        expert = sum(size(ffn[k][0]) for k in routed)
        weights += dense + n * expert
        active += dense + cfg.top_k * expert
    filled = int((lengths + 1).sum())
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    elem = params["embed"].element_size()
    latent = cfg.num_layers * filled * width * elem
    head = size(params["head"]) + rows * cfg.d_model * elem
    logits = rows * cfg.vocab_size * 4
    nbytes = weights + latent + head + logits
    h, dn, dv, kvr = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    # 2 flops a weight element a row; absorbed attention: W_uk into the
    # query and W_uv out of the context a row, the logits and the context
    # over the filled rows
    attn = cfg.num_layers * (2 * rows * h * kvr * (dn + dv)
                             + 2 * filled * h * (width + kvr))
    ops = 2 * rows * (active + size(params["head"])) / elem + attn
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes_gb": nbytes / 1e9, "weights_gb": weights / 1e9,
            "latent_cache_gb": latent / 1e9, "head_gb": head / 1e9,
            "experts_touched_per_layer": touched,
            "gflop": ops / 1e9, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def mla_expanded_decode(p, cfg, x, ckv, krope, length):
    """MLA decode in the expanded form over a latent cache that already
    holds this token's row: per-head ``K = [ckv W_uk, krope]`` and
    ``V = ckv W_uv``, then the softmax over the rows up to ``length``
    (f32 throughout)."""
    import torch
    from repro_torch.models.attention import _mla_qkv
    b, s = ckv.shape[:2]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, _, _ = _mla_qkv(p, cfg, x, length[:, None])
    q = torch.cat([q_nope, q_rope], dim=-1)[:, 0]            # [B, H, Dn+Dr]
    k = torch.cat([(ckv @ p["w_uk"]).reshape(b, s, h, dn),
                   krope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    v = (ckv @ p["w_uv"]).reshape(b, s, h, dv)
    logits = torch.einsum("bhd,bshd->bhs", q, k) * (dn + dr) ** -0.5
    valid = torch.arange(s, device=x.device)[None, :] <= length[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full((), -1e30, device=x.device))
    out = torch.einsum("bhs,bshd->bhd", torch.softmax(logits, dim=-1), v)
    return out.reshape(b, 1, h * dv) @ p["wo"]


def deepseek_family(dev, smi):
    """Phase 22: deepseek-v2 (MLA, a leading dense layer, 160 routed
    experts) served at full width and cut depth, its expert placement, and
    its reduced training. Returns the phase's rows."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.expert_placement import (
        apply_placement_to_params, contiguous_placement,
        lf_expert_placement, placement_cost, router_top_k)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.launch.serve import make_decode, serve
    from repro_torch.models.attention import mla_decode
    from repro_torch.models.lm import (grow_cache, init_model, prefill_step,
                                       serve_step)
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi,
           "allocated_gb_at_start": torch.cuda.memory_allocated(dev) / 1e9}
    print(f"phase 22 [{smi}]: {out['allocated_gb_at_start']:.3f} GB "
          f"allocated at the start", flush=True)

    # (a) launch.serve at full width, depth cut, phase 9's requests
    full = get_config(DEEPSEEK_ARCH)
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    args = argparse.Namespace(arch=DEEPSEEK_ARCH, reduced=False, requests=8,
                              min_prompt=64, max_prompt=1024, max_new=32,
                              seed=0, device="cuda")
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=args.seed)
    torch.cuda.synchronize()
    out["cut"] = {"num_layers": cfg.num_layers,
                  "published_num_layers": full.num_layers,
                  "params_b": cfg.param_count() / 1e9,
                  "published_params_b": full.param_count() / 1e9,
                  "weights_gb": sum(t.numel() * t.element_size()
                                    for t in tree_leaves(params)) / 1e9}
    print(f"phase 22 (a) {cfg.name}: d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, q/kv LoRA {cfg.q_lora_rank}/"
          f"{cfg.kv_lora_rank}, nope/rope/v {cfg.qk_nope_head_dim}/"
          f"{cfg.qk_rope_head_dim}/{cfg.v_head_dim}, {cfg.num_experts} "
          f"experts top-{cfg.top_k} + {cfg.num_shared_experts} shared of "
          f"d_ff {cfg.moe_d_ff}, {cfg.first_k_dense} dense layer of d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; depth cut from "
          f"{full.num_layers} to {cfg.num_layers} layers (one card): "
          f"{out['cut']['params_b']:.3f} B parameters "
          f"({out['cut']['weights_gb']:.2f} GB; the published depth holds "
          f"{out['cut']['published_params_b']:.1f} B) seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = serve(args, params=params, cfg=cfg)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    n_buckets = len(report["prefill_buckets"])
    out["serve"] = {**{k: report[k] for k in (
        "prefill_buckets", "prefill_s", "decode_s", "decode_tok_per_s",
        "decode_compiles", "prefill_compiles", "finite",
        "sample_generation")},
        "kernel_d_launches": launches,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(f"phase 22 (a) [{smi}] launch.serve --arch {DEEPSEEK_ARCH} "
          f"({cfg.num_layers} layers): {json.dumps(out['serve'])}",
          flush=True)
    check(report["finite"], "phase 22 (a): non-finite deepseek logits")
    check(report["decode_compiles"] == n_buckets
          and report["prefill_compiles"] == 0,
          f"phase 22 (a): decode graphs {report['decode_compiles']} for "
          f"{n_buckets} buckets, prefill graphs "
          f"{report['prefill_compiles']}")
    check(launches == 0,
          f"phase 22 (a): kernel D launched {launches} times; MLA decode "
          f"launches none, as in the reference")

    # the largest bucket's own prompts, rows at their own lengths
    prompts, lengths = serve_prompts(args, cfg, dev)
    s_b = max(prompts)
    idx, batch = prompts[s_b]
    rows = lengths[idx]
    prompt = batch["tokens"]
    cur = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    n_steps = args.max_new
    hidden = []
    with torch.no_grad(), moe_routing(inputs=hidden):
        logits, cache, _ = prefill_step(params, cfg, {"tokens": prompt})
    first = logits.argmax(-1).to(torch.int32)[:, None]
    layer1_h = hidden[0]                 # MoE layer 1's FFN input
    del hidden
    n_cached = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    per_token_layer = n_cached / (rows.size * s_b * cfg.num_layers)
    expanded = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                                + cfg.v_head_dim) * 2
    out["cache_bytes_per_token_layer"] = {"latent": per_token_layer,
                                          "expanded_kv": expanded}
    print(f"phase 22 (a) [{smi}] peak {out['serve']['peak_gb']:.2f} GB; "
          f"cache {per_token_layer:.0f} B a token a layer (ckv + krope, "
          f"bf16), against {expanded} B for the expanded per-head K/V",
          flush=True)

    # the step's bound at the largest bucket's first step
    grown = grow_cache(cache, s_b + n_steps)
    bound = mla_decode_bound(params, cfg, first, grown, cur)
    out["bound"] = bound
    print(f"phase 22 (b) [{smi}] decode step bound at the bucket's first "
          f"step: {json.dumps(bound)}", flush=True)
    del grown

    # (c) the largest bucket's decode, captured and eager, from one prefill
    decoded, runs = {}, {}
    with torch.no_grad():
        for capture in (True, False):
            path = "captured" if capture else "eager"
            decode = make_decode(params, cfg, dev, capture)
            grown = grow_cache(cache, s_b + n_steps + 8)
            tok, lens = first, cur.clone()
            steps = torch.empty((rows.size, n_steps), dtype=torch.int32,
                                device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lens, _ = decode(tok, lens, grown)
            steps[:, :1] = tok
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(1, n_steps):
                tok, lens, _ = decode(tok, lens, grown)
                steps[:, i:i + 1] = tok
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoded[capture] = [steps.clone()] + [
                t.clone() for t in tree_leaves(grown)]

            def more():
                nonlocal tok, lens
                tok, lens, _ = decode(tok, lens, grown)
            ms = 1e3 * (t2 - t1) / (n_steps - 1)
            runs[path] = {"first_step_ms": 1e3 * (t1 - t0),
                          "ms_per_step": ms,
                          "tok_per_s": rows.size * 1e3 / ms,
                          "bound_share": bound["bound_ms"] / ms,
                          "profile": profile_by_kernel(
                              more, MLA_KERNELS, "the rest")}
            print(f"phase 22 (c) [{smi}] deepseek decode {path}, bucket "
                  f"{s_b}, {rows.size} rows: {json.dumps(runs[path])}",
                  flush=True)
            del decode, grown
    same = [bool(torch.equal(a, b)) for a, b in zip(
        decoded[True], decoded[False], strict=True)]
    out["decode"] = {**runs, "captured_equals_eager": same,
                     "bucket": s_b, "rows": int(rows.size)}
    print(f"phase 22 (c) [{smi}] largest bucket ({s_b}, {rows.size} rows): "
          f"{runs['captured']['ms_per_step']:.3f} ms a decode step "
          f"captured ({runs['eager']['ms_per_step']:.3f} eager), "
          f"{runs['captured']['tok_per_s']:.1f} tokens/s, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
          f"{runs['captured']['bound_share']:.3f} of it); {n_steps} tokens "
          f"and every ckv/krope leaf captured equal to eager: {same}",
          flush=True)
    check(all(same), "phase 22 (c): the captured deepseek decode's tokens "
                     "or latent cache differ from the eager decode's")
    del decoded

    # (d) expert placement from MoE layer 1's router trace
    moe1 = params["layers"][0]["ffn"]
    t0 = time.perf_counter()
    trace = router_top_k(moe1, cfg, layer1_h)
    placement = lf_expert_placement(trace, cfg.num_experts, PLACEMENT_SHARDS)
    place_s = time.perf_counter() - t0
    sizes = np.bincount(placement, minlength=PLACEMENT_SHARDS).tolist()
    naive = contiguous_placement(cfg.num_experts, PLACEMENT_SHARDS)
    costs = {"leiden_fusion": placement_cost(trace, placement),
             "contiguous": placement_cost(trace, naive)}
    # each layer writes its new row before it attends, so both steps see
    # one cache (kernel_vs_plain_step)
    grown = grow_cache(cache, s_b + n_steps)
    with torch.no_grad():
        want, _ = serve_step(params, cfg, first, grown, cur)
        for lp in params["layers"]:
            lp["ffn"] = apply_placement_to_params(lp["ffn"], placement)[0]
        got, _ = serve_step(params, cfg, first, grown, cur)
    err = logits_diff(got, want)
    same_tokens = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    out["placement"] = {
        "trace_tokens": int(trace.shape[0]), "top_k": int(trace.shape[1]),
        "shards": PLACEMENT_SHARDS, "shard_sizes": sizes,
        "cost": costs, "placement_s": place_s,
        "permuted_max_abs_diff": float((got - want).abs().max()),
        "permuted_max_over_max": err[0], "permuted_rms_over_rms": err[1],
        "same_argmax_tokens": same_tokens, "tol": LM_BF16_TOL}
    print(f"phase 22 (d) [{smi}] placement of {cfg.num_experts} experts on "
          f"{PLACEMENT_SHARDS} shards from MoE layer 1's trace "
          f"({trace.shape[0]} tokens x top-{trace.shape[1]}): "
          f"{json.dumps(out['placement'])}", flush=True)
    check(sizes == [cfg.num_experts // PLACEMENT_SHARDS] * PLACEMENT_SHARDS,
          f"phase 22 (d): shard sizes {sizes}")
    check(same_tokens and err[0] <= LM_BF16_TOL and err[1] <= LM_BF16_TOL,
          f"phase 22 (d): the permuted model's decode step differs: "
          f"{out['placement']}")
    del params, cache, grown, prompt, logits, first, layer1_h, moe1, got, \
        want
    gc.collect()
    torch.cuda.empty_cache()

    # (e) launch.train --arch deepseek_v2_236b --reduced on the card
    reduced = ["--workload", "lm", "--arch", DEEPSEEK_ARCH, "--reduced",
               "--steps", "4", "--device", "cuda"]
    rep, state = launcher.run_lm(launcher.parser().parse_args(reduced))
    out["train_reduced"] = {"losses": rep["losses"],
                            "compiles": state["step"].compiles}
    print(f"phase 22 (e) [{smi}] launch.train {' '.join(reduced)}: "
          f"{json.dumps(out['train_reduced'])}", flush=True)
    check(all(np.isfinite(rep["losses"])) and state["step"].compiles == 1
          and rep["losses"][-1] < rep["losses"][0],
          f"phase 22 (e): reduced deepseek training: {out['train_reduced']}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one decode step, bf16 against f32 weights, at full width on 2
    # layers (the dense layer 0 and one MoE layer); then MLA's absorbed
    # decode against the expanded form, f32, over each layer's cache
    two = dataclasses.replace(cfg, num_layers=2)
    c32 = dataclasses.replace(two, dtype="float32")
    prompt = batch["tokens"]
    routes = []
    with torch.no_grad():
        p32 = init_model(c32, dev, seed=args.seed)
        logits, cache32, _ = prefill_step(p32, c32, {"tokens": prompt})
        cache32 = grow_cache(cache32, s_b + n_steps)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        with moe_routing(routes):
            want, _ = serve_step(p32, c32, nxt, cache32, cur)
        p16 = init_model(two, dev, seed=args.seed)
        _, cache16, _ = prefill_step(p16, two, {"tokens": prompt})
        cache16 = grow_cache(cache16, s_b + n_steps)
        with moe_routing(replay=routes):
            got, _ = serve_step(p16, two, nxt, cache16, cur)
        free, _ = serve_step(p16, two, nxt, cache16, cur)
        del p16, cache16
    err, own = logits_diff(got, want), logits_diff(free, want)
    gen = torch.Generator(device=dev).manual_seed(7)
    mla = {}
    with torch.no_grad():
        entries = (("first_dense 0", p32["first_dense"][0],
                    cache32["first_dense"][0]),
                   ("layer 1 (MoE)", p32["layers"][0],
                    {n: t[0] for n, t in cache32["layers"].items()}))
        for name, lp, entry in entries:
            x = torch.randn((rows.size, 1, c32.d_model), generator=gen,
                            device=dev)
            ckv, krope = entry["ckv"].clone(), entry["krope"].clone()
            absorbed, ckv, krope = mla_decode(lp["attn"], c32, x, ckv, krope,
                                              cur)
            expanded_out = mla_expanded_decode(lp["attn"], c32, x, ckv,
                                               krope, cur)
            mla[name] = float((absorbed - expanded_out).abs().max()
                              / expanded_out.abs().max())
    out["bf16_vs_f32"] = {
        "layers": 2, "max_over_max": err[0], "rms_over_rms": err[1],
        "own_routing_max_over_max": own[0],
        "own_routing_rms_over_rms": own[1],
        "greedy_agree": float((got.argmax(-1) == want.argmax(-1))
                              .float().mean()),
        "tol": LM_BF16_TOL, "absorbed_vs_expanded_f32": mla,
        "absorbed_tol": MLA_RTOL}
    print(f"phase 22 (b) [{smi}] one decode step (bucket {s_b}, "
          f"{rows.size} rows, full width, 2 layers), bf16 weights on the f32 "
          f"step's expert choices against f32: "
          f"{json.dumps(out['bf16_vs_f32'])}", flush=True)
    check(err[0] <= LM_BF16_TOL and err[1] <= LM_BF16_TOL,
          f"phase 22 (b): the bf16 step differs from the f32 step: "
          f"{out['bf16_vs_f32']}")
    check(all(v <= MLA_RTOL for v in mla.values()),
          f"phase 22 (b): absorbed MLA decode differs from the expanded "
          f"form: {mla}")
    del p32, cache32, prompt, got, want, free
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 22: {out['phase_s']:.1f} s wall", flush=True)
    return out


def frontend_decode_bound(params, cfg, tokens, cache, lengths):
    """The least time one decode step of an enc-dec or VLM model could take
    on the card: the bytes it must read (every decoder layer's weights,
    cross-attention's included; the head; the tokens' embedding rows; the
    K/V cache up to each row's length with the new row; the encoder's
    memory once) and write (the logits), over 3.35 TB/s, or its
    operations (2 a weight element a row, the cross K/V projections over
    every memory row, attention's two products over the filled rows and,
    across, over the memory) at the bf16 dense rate, the larger. Returns
    the terms."""
    from repro_torch.models.lm import _head_weight
    from repro_torch.tree import tree_leaves

    def size(t):
        return t.numel() * t.element_size()
    rows = tokens.shape[0]
    layers = params["layers"]
    weights = sum(size(t) for lp in layers for t in tree_leaves(lp))
    elems = sum(t.numel() for lp in layers for t in tree_leaves(lp))
    cross_kv = sum(lp["cross"][n].numel() for lp in layers if "cross" in lp
                   for n in ("wk", "wv"))
    n_cross = sum("cross" in lp for lp in layers)
    filled = int((lengths + 1).sum())
    k = cache["layers"]["k"]
    kv = 2 * filled * k.shape[3] * k.shape[4] * k.element_size() \
        * k.shape[0]
    memory = cache.get("memory")
    se = memory.shape[1] if memory is not None else 0
    mem = size(memory) if memory is not None else 0
    head_w = _head_weight(params)
    head = size(head_w) + rows * cfg.d_model * params["embed"].element_size()
    logits = rows * cfg.vocab_size * 4
    nbytes = weights + kv + mem + head + logits
    hd = cfg.num_heads * cfg.head_dim
    ops = 2 * rows * (elems - cross_kv + head_w.numel()) \
        + 2 * rows * se * cross_kv + 4 * filled * hd * len(layers) \
        + 4 * rows * se * hd * n_cross
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bytes_gb": nbytes / 1e9, "weights_gb": weights / 1e9,
            "kv_gb": kv / 1e9, "memory_gb": mem / 1e9, "head_gb": head / 1e9,
            "memory_rows": int(se), "gflop": ops / 1e9,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def cross_attention_range():
    """Open a ``torch.profiler`` range (``CROSS_RANGE``) around each call
    of the LM's cross-attention (``lm.cross_attention_train``), so a
    profile can give the kernels it launches to it."""
    import torch
    from repro_torch.models import lm
    saved = lm.cross_attention_train

    def ranged(*a, **k):
        with torch.profiler.record_function(CROSS_RANGE):
            return saved(*a, **k)
    lm.cross_attention_train = ranged
    try:
        yield
    finally:
        lm.cross_attention_train = saved


def eager_cross_split(step):
    """Device ms of one eager call of ``step`` by part: each kernel whose
    launching op ran inside ``cross_attention_range`` goes to the
    cross-attention (its K/V recompute over the memory, its products,
    softmax and casts; ``ranged_ops``), the others by name
    (``FRONTEND_KERNELS``), else to the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    step()                                  # warm
    torch.cuda.synchronize()
    with cross_attention_range(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    raw = list(prof.profiler.kineto_results.events())
    info, _ = ranged_ops(raw, {CROSS_RANGE: "cross-attention"})
    split = {name: 0.0 for name, _ in FRONTEND_KERNELS}
    split.update({"cross-attention": 0.0, "the rest": 0.0})
    for k in raw:
        if k.device_type() != cuda or k.name() == CROSS_RANGE:
            continue
        name = k.name().lower()
        part = info.get(k.linked_correlation_id(), (None, None))[0] or next(
            (p for p, words in FRONTEND_KERNELS
             if any(w in name for w in words)), "the rest")
        split[part] += k.duration_ns() / 1e6
    check(split["cross-attention"] > 0,
          f"phase 23: the eager decode step's profile gives no kernel to "
          f"the cross-attention: {split}")
    return {"device_ms": sum(split.values()), "device_ms_by_part": split}


def frontend_serving(dev, smi, arch, args, steps=32):
    """Phase 23 (a)-(c) for one family: ``launch.serve`` at full width and
    depth on ``args``'s requests (gates: finite, one decode graph a
    bucket, no prefill graph, kernel D a layer a step), then at the
    largest bucket kernel D against the plain attention, the step's
    bound, and ``steps`` steps captured against eager, bitwise, each
    profiled by kernel (and the eager step's cross-attention by range).
    Returns the rows and the bucket's cache length and rows (for (d))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import grow_cache, init_model, prefill_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_model(cfg, dev, seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_enc = sum(t.numel() for t in tree_leaves(params.get("encoder", {})))
    print(f"phase 23 (a) {cfg.name}: {cfg.num_layers} decoder layers, "
          f"{cfg.encoder_layers} encoder layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff} ({cfg.ffn_activation}, bias {cfg.ffn_bias}), "
          f"{cfg.norm}, vocab {cfg.vocab_size}, patch tokens "
          f"{cfg.num_patch_tokens}, {cfg.dtype}; {n_params / 1e9:.4f} B "
          f"parameters ({n_enc / 1e9:.4f} B of encoder) seeded on the card "
          f"in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = serve(args, params=params)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    n_buckets = len(report["prefill_buckets"])
    out = {"params_b": n_params / 1e9, "encoder_params_b": n_enc / 1e9,
           "serve": {**{k: report[k] for k in (
               "prompt_lengths", "prefill_buckets", "prefill_s", "decode_s",
               "decode_tok_per_s", "decode_compiles", "prefill_compiles",
               "finite", "sample_generation")},
               "kernel_d_launches": launches,
               "kernel_d_launches_per_step": cfg.num_layers,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
    print(f"phase 23 (a) [{smi}] launch.serve --arch {arch} "
          f"({args.requests} requests of {args.min_prompt}-"
          f"{args.max_prompt} tokens): {json.dumps(out['serve'])}",
          flush=True)
    check(report["finite"], f"phase 23 (a): non-finite {arch} logits")
    check(report["decode_compiles"] == n_buckets
          and report["prefill_compiles"] == 0,
          f"phase 23 (a): {arch}: decode graphs {report['decode_compiles']} "
          f"for {n_buckets} buckets, prefill graphs "
          f"{report['prefill_compiles']}")
    check(launches == cfg.num_layers * args.max_new * n_buckets,
          f"phase 23 (a): {arch}: kernel D launched {launches} times, not "
          f"{cfg.num_layers} x {args.max_new} x {n_buckets}")

    # the largest bucket's own prompts and frontend inputs
    prompts, lengths = serve_prompts(args, cfg, dev)
    s_b = max(prompts)
    idx, batch = prompts[s_b]
    rows = lengths[idx]
    cur = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, batch)
    first = logits.argmax(-1).to(torch.int32)[:, None]
    target = s_b + steps
    grown = grow_cache(cache, target)
    _, out["kernel_vs_plain"] = kernel_vs_plain_step(
        params, cfg, grown, first, cur,
        f"phase 23 (b) [{smi}] {arch} serve step (bucket {s_b}, "
        f"{rows.size} rows)")
    bound = frontend_decode_bound(params, cfg, first, grown, cur)
    out["bound"] = bound
    print(f"phase 23 (a) [{smi}] {arch} decode step bound at the bucket's "
          f"first step: {json.dumps(bound)}", flush=True)
    del grown

    # (c) the bucket's decode captured and eager, from one prefill
    runs, same = captured_and_eager(
        params, cfg, dev, cache, first, cur, target + 8, steps, bound,
        FRONTEND_KERNELS, f"phase 23 (c) [{smi}] {arch} decode", s_b,
        eager_split=eager_cross_split if cfg.encoder_layers else None)
    out["decode"] = {**runs, "bucket": s_b, "rows": int(rows.size),
                     "leaves_compared": len(same),
                     "captured_equals_eager": all(same)}
    prof = runs["captured"]["profile"]
    print(f"phase 23 (a) [{smi}] {arch} largest bucket ({s_b}, {rows.size} "
          f"rows): {runs['captured']['ms_per_step']:.3f} ms a decode step "
          f"captured ({runs['eager']['ms_per_step']:.3f} eager), "
          f"{runs['captured']['tok_per_s']:.1f} tokens/s, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
          f"{runs['captured']['bound_share']:.3f} of it), idle "
          f"{prof['idle_share']:.3f}; serve {report['decode_tok_per_s']:.1f} "
          f"tokens/s, prefill {report['prefill_s']:.3f} s, peak "
          f"{out['serve']['peak_gb']:.2f} GB, kernel D {launches} launches",
          flush=True)
    print(f"phase 23 (c): {steps} tokens of {rows.size} rows, captured "
          f"equal to eager bit for bit in tokens, logits and "
          f"{len(same) - 2} cache leaves: {same}", flush=True)
    check(all(same), f"phase 23 (c): {arch}: the captured decode's tokens, "
                     f"logits or cache differ from the eager decode's")
    check(prof["device_busy_ms_per_step"] > 0
          and prof["device_ms_per_step"]["kernel D"] > 0
          and prof["kernel_d_records_per_step"] <= cfg.num_layers,
          f"phase 23 (c): {arch}: the profile of the captured decode step "
          f"saw no kernel D: {prof['device_ms_per_step']}")
    del cache, params, batch, prompts, logits, first
    return out, (target, rows)


def frontend_reduced(dev, smi):
    """Phase 23 (e): each family at ``--reduced`` through ``launch.train``
    on the card (4 steps: one captured graph, the loss finite and
    falling), then the reduced model (f32) on the card against the CPU
    from the same weights: ``train_loss`` and its gradient at batch 4 x
    160 (the frames or patches included), and prefill of 149 tokens (with
    the same frames or patches) then one decode step against the train
    forward at position 149."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.lm import (_head_weight, grow_cache, init_model,
                                       model_hidden_train, prefill_step,
                                       serve_step, train_loss)
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    out = {}
    for arch in FRONTEND_ARCHS:
        argv = ["--workload", "lm", "--arch", arch, "--reduced", "--steps",
                "4", "--device", dev.type]
        rep, state = launcher.run_lm(launcher.parser().parse_args(argv))
        row = {"train": {"losses": rep["losses"],
                         "compiles": state["step"].compiles,
                         "batch": {k: list(v.shape)
                                   for k, v in state["batch"].items()}}}
        del state
        print(f"phase 23 (e) [{smi}] launch.train {' '.join(argv)}: "
              f"{json.dumps(row['train'])}", flush=True)
        check(all(np.isfinite(rep["losses"])) and row["train"]["compiles"] == 1
              and rep["losses"][-1] < rep["losses"][0],
              f"phase 23 (e): reduced {arch} training: {row['train']}")
        rcfg = get_config(arch).reduced()
        seeded = init_model(rcfg, "cpu", seed=0)
        grads, losses, forward = {}, {}, {}
        s = 150
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            p = tree_map(lambda x: x.to(device, copy=True), seeded)
            batch = make_batch(rcfg, 4, 160, seed=0, device=device)
            loss, g = value_and_grad(lambda q: train_loss(q, rcfg, batch), p)
            losses[name], grads[name] = float(loss), tree_leaves(g)
            full = make_batch(rcfg, 2, s, seed=3, device=device)
            extra = {k: v for k, v in full.items()
                     if k in ("patch_embeds", "frames")}
            tokens = full["tokens"]
            with torch.no_grad():
                h, _ = model_hidden_train(p, rcfg, tokens, **extra)
                want = (h[:, -1] @ _head_weight(p)).float()
                _, cache, lens = prefill_step(
                    p, rcfg, {"tokens": tokens[:, :s - 1], **extra})
                cache = grow_cache(cache, s + 8)
                got, _ = serve_step(p, rcfg, tokens[:, s - 1:s], cache, lens)
            forward[name] = (got.cpu(), want.cpu())
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        grad_rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                       for a, b in zip(grads["card"], grads["cpu"],
                                       strict=True))
        row.update({
            "loss_card": losses["card"], "loss_cpu": losses["cpu"],
            "loss_rel_diff": loss_rel, "grad_diff_over_max": grad_rel,
            "decode_vs_forward_max_abs": float(
                (forward["card"][0] - forward["card"][1]).abs().max()),
            "decode_card_vs_cpu_max_abs": float(
                (forward["card"][0] - forward["cpu"][0]).abs().max()),
            "logit_scale": float(forward["cpu"][1].abs().max()),
            "tol": FRONTEND_TOL})
        out[arch] = row
        print(f"phase 23 (e) [{smi}] reduced {arch} (f32, "
              f"{rcfg.num_layers} layers), the card against the CPU: "
              f"{json.dumps({k: v for k, v in row.items() if k != 'train'})}",
              flush=True)
        scale = row["logit_scale"]
        check(loss_rel <= FRONTEND_TOL and grad_rel <= FRONTEND_TOL,
              f"phase 23 (e): {arch}: train_loss or its gradient differ "
              f"between the card and the CPU ({loss_rel}, {grad_rel})")
        check(row["decode_vs_forward_max_abs"] <= FRONTEND_TOL * (1 + scale)
              and row["decode_card_vs_cpu_max_abs"]
              <= FRONTEND_TOL * (1 + scale),
              f"phase 23 (e): {arch}: prefill then decode differs from the "
              f"train forward or from the CPU: {row}")
        del seeded, grads, forward
    return out


def frontend_families(dev, smi):
    """Phase 23: the enc-dec (``seamless_m4t_large_v2``) and VLM
    (``phi3_vision_4p2b``) families at full width and depth, kernel D at
    D 96 and at seamless's shape, and both families trained reduced.
    Returns the phase's rows, kernel D's among them."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi,
           "allocated_gb_at_start": torch.cuda.memory_allocated(dev) / 1e9}
    print(f"phase 23 [{smi}]: {out['allocated_gb_at_start']:.3f} GB "
          f"allocated at the start", flush=True)
    wall, buckets = {}, {}
    requests = {ENCDEC_ARCH: (8, 64, 1024), VLM_ARCH: (4, 577, 1024)}
    for arch in FRONTEND_ARCHS:
        n, lo, hi = requests[arch]
        args = argparse.Namespace(arch=arch, reduced=False, requests=n,
                                  min_prompt=lo, max_prompt=hi, max_new=32,
                                  seed=0, device="cuda")
        t0 = time.perf_counter()
        out[arch], buckets[arch] = frontend_serving(dev, smi, arch, args)
        gc.collect()
        torch.cuda.empty_cache()
        wall[f"serve {arch}"] = time.perf_counter() - t0

    # (b) a 128-token prompt is shorter than phi-3-vision's 576 patches:
    # the port refuses it (the reference fails on a broadcast there)
    cfg = get_config(VLM_ARCH)
    short = argparse.Namespace(arch=VLM_ARCH, reduced=False, requests=1,
                               min_prompt=128, max_prompt=128, max_new=2,
                               seed=0, device="cuda")
    small = dataclasses.replace(cfg, num_layers=1)
    try:
        serve(short, cfg=small)
        refused = None
    except ValueError as e:
        refused = str(e)
    out["short_prompt_refused"] = refused
    print(f"phase 23 (b) [{smi}] {VLM_ARCH}: a 128-token prompt against "
          f"{cfg.num_patch_tokens} patch tokens: ValueError {refused!r}",
          flush=True)
    check(refused is not None and "num_patch_tokens" in refused,
          f"phase 23 (b): a 128-token phi-3-vision prompt was not refused: "
          f"{refused}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) kernel D alone: phi-3-vision's decode shape (D 96), D 96 in f32
    # at decode_32k's length, seamless's decode shape (D 64, G 1)
    gen = torch.Generator(device=dev).manual_seed(23)
    rows_d = {}
    for name, arch, h, hkv, d, b, s, dtype, plain_rows in (
            ("phi3v_serving_d96", VLM_ARCH, 32, 32, 96, None, None,
             torch.bfloat16, None),
            ("d96_f32_decode_32k", None, 32, 8, 96, 16, 32768,
             torch.float32, 8),
            ("seamless_serving_d64_g1", ENCDEC_ARCH, 16, 16, 64, None, None,
             torch.bfloat16, None)):
        if arch:
            s, served = buckets[arch]
            b = plain_rows = int(served.size)
            filled = torch.as_tensor(served + 1, dtype=torch.int32,
                                     device=dev)
        else:
            filled = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)
            filled[:3] = torch.tensor([1, s // 2 + 1, s])
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        rows_d[name] = kernel_d_case(
            q, k, v, filled, plain_rows,
            f"phase 23 (d) {name} (B {b}, S {s}, H {h}, Hkv {hkv}, D {d}, "
            f"{str(dtype).split('.')[-1]})")
        check(rows_d[name]["bitwise_repeatable"],
              f"phase 23 (d): kernel D at {name}: two calls differ")
        del q, k, v
        torch.cuda.empty_cache()
    out["kernel_d"] = rows_d

    t0 = time.perf_counter()
    out["reduced"] = frontend_reduced(dev, smi)
    wall["reduced"] = time.perf_counter() - t0
    out["wall_s"] = wall
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 23: {out['phase_s']:.1f} s wall ({json.dumps(wall)})",
          flush=True)
    return out


# phase 24: the main path's launches, one process per partition
DIST_RANKS = 8
DIST_EPOCHS = {"local": 60, "sync": 5, "stale": 8}
DIST_PERIOD = 4
# distributed against one process: sync's and stale's losses, local's
# table (bitwise on the H100 since the stacked clip norm reduces each
# partition alone; 1.3e-2 after 60 epochs while it reduced the stack's rows)
DIST_LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
DIST_TABLE_TOL = dict(rtol=1e-4, atol=1e-4)
DIST_ACC_TOL = 0.01
DIST_TIMEOUT_S = 300


def torchrun(args, log_dir, env):
    """``python -m torch.distributed.run`` on :data:`DIST_RANKS` ranks of
    this card, each rank's stdout and stderr in its own file under
    ``log_dir``; returns (exit code, seconds, {rank: (stdout, stderr)}).
    The launcher and its ranks are one process group, killed on a
    timeout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DIST_RANKS), "--log-dir", log_dir,
           "--redirects", "3", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    logs = {}
    for r in range(DIST_RANKS):
        got = []
        for stream in ("stdout", "stderr"):
            paths = sorted(glob.glob(os.path.join(log_dir, "*", "attempt_*",
                                                  str(r), f"{stream}.log")))
            got.append(open(paths[-1]).read() if paths else "")
        logs[r] = tuple(got)
    if proc.returncode != 0:
        print(f"torchrun {' '.join(args[:4])}: exit {proc.returncode}; "
              f"launcher: {out[-2000:]}")
        for r, (o, e) in logs.items():
            print(f"  rank {r} stderr: {e[-1500:]}")
    return proc.returncode, wall, logs


def rank_summaries(logs, what):
    """Every rank's ``rank summary:`` line, by rank; fails on a missing
    one."""
    out = {}
    for r, (_, err) in logs.items():
        lines = [x for x in err.splitlines() if x.startswith("rank summary: ")]
        check(len(lines) == 1, f"{what}: rank {r} printed "
                               f"{len(lines)} summaries")
        out[r] = json.loads(lines[0].split(": ", 1)[1])
    return out


def sync_steps_rank(argv):
    """One rank of phase 24's repeatability launch (``chip_smoke.py
    --sync-steps-rank run <the sync launch's flags>``): the partition from
    the run's cache, this rank's partition on its device, and one sync
    step from the seeded state taken twice; prints a ``rank summary:``
    line (bitwise equal, counted bytes, launches, seconds)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import PartitionerSpec
    from repro_torch.device import synchronize
    from repro_torch.gnn import distributed
    from repro_torch.gnn.halo import make_sync_train_step
    from repro_torch.gnn.infer import (gather_partition_tensors,
                                       init_partition_models)
    from repro_torch.gnn.model import GNNConfig
    from repro_torch.gnn.train import dropout_generators
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (init_process_group_from_env,
                                         make_local_mesh)
    from repro_torch.optim import adamw_init
    from repro_torch.pipeline import cli
    from repro_torch.pipeline.artifacts import PartitionArtifactStore
    from repro_torch.pipeline.datasets import get_dataset
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    args = cli.build_parser().parse_args(argv)
    pc = cli.config_from_args(args)
    dev, backend = init_process_group_from_env(args.device)
    try:
        ds = get_dataset(pc.dataset, **pc.dataset_kwargs)
        bundle = PartitionArtifactStore(pc.cache_dir).load_or_compute(
            ds.graph, PartitionerSpec.parse(pc.method), pc.k, pc.seed,
            pc.scheme, with_halo=True)
        batch = bundle.batch
        cfg = GNNConfig(kind=pc.model, feature_dim=int(ds.features.shape[1]),
                        hidden_dim=pc.hidden_dim, embed_dim=pc.embed_dim,
                        num_layers=pc.num_layers, dropout=pc.dropout)
        sh = distributed.shard(make_local_mesh(), batch.k, dev)
        tensors = gather_partition_tensors(ds, batch, dev,
                                           only=slice(sh.lo, sh.hi))
        params = distributed.slice_params(init_partition_models(
            cfg, ds.num_classes, batch.k,
            torch.Generator().manual_seed(pc.seed), dev), sh)
        step = make_sync_train_step(cfg, distributed.HaloAllGather(
            bundle.halo, sh, batch.n_pad, dev), ds.multilabel, pc.lr)
        counter = distributed.StepCounter(sh)
        runs, secs = [], []
        for _ in range(2):
            gens = dropout_generators(pc.seed, batch.k, dev)[sh.lo:sh.hi]
            opt = adamw_init(params, stacked=True)
            synchronize(dev)
            t0 = time.perf_counter()
            runs.append(counter.step(lambda: step(params, opt, tensors,
                                                  gens)))
            synchronize(dev)
            secs.append(time.perf_counter() - t0)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs[0]), tree_leaves(runs[1])))
        counted = counter.summary()
        print("rank summary: " + json.dumps({
            "rank": dist.get_rank(), "backend": backend, "bitwise": same,
            "step_bytes": [x["total"] for x in counted["steps"]],
            "seconds": counted["seconds"]["training steps"],
            "step_s": secs, "launches": ops.launch_counts(),
            "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None)}),
            file=sys.stderr, flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def rank_backward_row(dev, halo, n_pad, f):
    """Kernel A as a rank's exchange backward at the main path (the rank
    whose sent rows gather the most slots): against its plain version
    (3e-5 of the sum of absolute terms), twice bitwise, timed (CUDA
    events, device time from the profiler) beside its bound, the plain
    version and ``index_add_``."""
    import torch
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import exchange
    from repro_torch.tools.kernel_turns import device_us as profiled
    rank = max(range(DIST_RANKS),
               key=lambda r: int((halo.recv_rows[:, r, :] >= 0).sum()))
    pl = exchange.rank_plan(halo, rank, n_pad, dev)
    csr = pl.csr
    rows, e = csr.num_nodes, int(csr.src.shape[0])
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn((rows, f), generator=gen, device=dev)

    def call():
        return exchange.rank_backward_sum(g, pl)

    def plain(x):
        return kernel_a.plain(x, csr.src, csr.dst, csr.weight, n_pad)
    out = call()
    err = max_err(out, plain(g), plain(g.abs()), "rank exchange backward")
    check(torch.equal(out, call()), "the rank backward: two calls differ")
    # index_add_: the kept rows, then each slot added into the row it fed
    keep = ~pl.received
    slot_rows = csr.dst.long()[csr.src.long() >= n_pad]
    slots = csr.src.long()[csr.src.long() >= n_pad]

    def library():
        return (g[:n_pad] * keep).index_add_(0, slot_rows,
                                             g.index_select(0, slots))
    check(torch.allclose(library(), out, rtol=1e-5, atol=1e-5),
          "index_add_ does not compute the rank backward")
    us, per_call = profiled(call, ("csr_aggregate_gather",
                                   "csr_aggregate_fixup"))
    # each arc's source row of g read once (the rows received are read by
    # no arc), the arcs and the n_pad + 1 row offsets, the n_pad output
    # rows written once; one multiply-add per arc and feature
    bound, by = bound_ms(4 * (e * f + 2 * e + n_pad + 1 + n_pad * f),
                         2 * e * f)
    row = {"max_abs_err": err, "bitwise_repeatable": True,
           "device_ms": us * round(per_call) / 1e3,
           "profiled_launches_per_call": per_call,
           "ms": time_ms(call), "plain_ms": time_ms(lambda: plain(g)),
           "bound_ms": bound, "bound_by": by, "library_ms": time_ms(library),
           "shape": {"rank": rank, "rows": rows, "n_pad": n_pad, "F": f,
                     "arcs": e, "slot_arcs": int(slots.shape[0]),
                     "h_pad": int(halo.h_pad), "k": DIST_RANKS}}
    print(f"phase 24 rank backward (kernel A): {json.dumps(row)}",
          flush=True)
    return row


def distributed_on_card(dev, smi, ds, cache_dir, phase5):
    """Phase 24: the paper's training with one process per partition on
    the card: ``python -m torch.distributed.run --nproc-per-node 8 -m
    repro_torch.pipeline run`` at phase 5's configuration (its partition
    and halo plan from the cache) in local (60 epochs), sync (5) and
    stale(4) (8 epochs: exchanges at 0 and 4); the 8 ranks share the card
    through gloo, which is not a cluster of 8 cards. Then a fourth launch
    takes one sync step from the seeded state twice on every rank. Gates:
    every rank exits 0; each rank's counted bytes a training step are
    exactly ``exchange_collective_bytes`` (a sync step 1,368,260,608),
    local's steps and stale's between-exchange steps 0; kernels A and B
    (and in sync and stale, the rank backward) launch on every rank;
    local's table within ``DIST_TABLE_TOL`` of phase 5's and its test
    accuracy within 0.01; sync's and stale's losses within
    ``DIST_LOSS_TOL`` of a one-process run of the same epochs; the two
    sync steps bitwise equal on every rank. Printed, not gated: whether
    each comparison is bitwise, ms an epoch beside the one-process figure,
    collective and staging seconds a step, each rank's peak device GB.
    Returns (rows, the kernel row)."""
    import numpy as np
    import torch
    from repro_torch.gnn.halo import exchange_collective_bytes
    from repro_torch.kernels import autotune
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    t0 = time.perf_counter()
    rows = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dist-",
                                     dir=ROOT) as tmp:
        env["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "at.json")
        # the one-process runs below resolve what the ranks resolve: phase
        # 17 may have tuned this process's cache at the main path's bucket
        own_cache = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = env[
            "REPRO_TORCH_AUTOTUNE_CACHE"]
        autotune.clear_memory_cache()
        flags = ["--dataset", "arxiv-like", "--dataset-scale",
                 repr(ARXIV_SCALE), "--k", str(DIST_RANKS), "--sync-period",
                 str(DIST_PERIOD), "--cache-dir", cache_dir]
        for mode, epochs in DIST_EPOCHS.items():
            bundle_dir = os.path.join(tmp, "bundle")
            args = ["-m", "repro_torch.pipeline", "run", *flags, "--mode",
                    mode, "--epochs", str(epochs), "--json"]
            args += (["--serving-dir", bundle_dir] if mode == "local"
                     else ["--classifier-epochs", "0"])
            rc, wall, logs = torchrun(args, os.path.join(tmp, f"log-{mode}"),
                                      env)
            check(rc == 0, f"phase 24 {mode}: torch.distributed.run exited "
                           f"{rc}")
            summ = rank_summaries(logs, f"phase 24 {mode}")
            out0 = logs[0][0]
            report = json.loads(out0[out0.index("{"):])
            on = (list(range(epochs)) if mode == "sync" else
                  [e for e in range(epochs) if e % DIST_PERIOD == 0]
                  if mode == "stale" else [])
            step_total = report["collectives"]["total"] if on else 0
            for r, s in summ.items():
                want = [step_total if e in on else 0 for e in range(epochs)]
                check(s["step_bytes"] == want,
                      f"phase 24 {mode}: rank {r} counted {s['step_bytes']}"
                      f" bytes a step, the schedule {want}")
                need = ["fused_gcn_layer_need_agg", "csr_aggregate"] + (
                    ["exchange_rank_backward"] if on else [])
                check(all(s["launches"][k] > 0 for k in need),
                      f"phase 24 {mode}: rank {r} launched "
                      f"{s['launches']}")
            ep_s = [s["train_epochs_s"] for s in summ.values()]
            sec = [s["seconds"]["training steps"] for s in summ.values()]
            row = {"wall_s": wall, "ranks": len(summ),
                   "step_bytes": step_total,
                   "collectives": report["collectives"],
                   "ms_per_epoch_max_rank": 1e3 * max(ep_s) / epochs,
                   "collective_s_per_step_max_rank": max(
                       x["collective_s"] for x in sec) / epochs,
                   "staging_s_per_step_max_rank": max(
                       x["staging_s"] for x in sec) / epochs,
                   "phases_bytes_rank0": summ[0]["phases"],
                   "peak_device_gb": [summ[r]["peak_device_gb"]
                                      for r in sorted(summ)],
                   "launches_summed": {k: sum(s["launches"][k]
                                              for s in summ.values())
                                       for k in summ[0]["launches"]},
                   "timings_rank0": report["timings"]}
            losses = np.array([summ[r]["losses"] for r in sorted(summ)])
            losses = losses[:, :, 0].T                  # [epochs, k]
            if mode == "local":
                check(bool(np.isfinite(losses).all()),
                      "phase 24 local: non-finite loss")
                path = glob.glob(os.path.join(bundle_dir, "*.npz"))
                check(len(path) == 1, f"phase 24 local: bundles {path}")
                with np.load(path[0]) as z:
                    table = torch.as_tensor(z["embeddings"])
                err = float((table - phase5["table"]).abs().max())
                acc, acc5 = (report["accuracy"]["test"],
                             phase5["accuracy"]["test"])
                diff = np.abs(losses - phase5["losses"])
                differs = np.nonzero(diff.max(1))[0]
                row.update(loss_max_abs_err=float(diff.max()),
                           losses_first_diff_epoch=int(differs[0])
                           if differs.size else None,
                           table_max_abs=float(phase5["table"].abs().max()),
                           table_max_abs_err=err,
                           table_bitwise=bool(torch.equal(table,
                                                          phase5["table"])),
                           accuracy=report["accuracy"],
                           phase5_accuracy=phase5["accuracy"],
                           one_process_ms_per_epoch=phase5["ms_per_epoch"])
                check(torch.allclose(table, phase5["table"],
                                     **DIST_TABLE_TOL),
                      f"phase 24 local: the table differs from phase 5's "
                      f"by {err}")
                check(abs(acc - acc5) <= DIST_ACC_TOL,
                      f"phase 24 local: test accuracy {acc} against phase "
                      f"5's {acc5}")
            else:
                cfg = PipelineConfig(dataset="arxiv-like", k=DIST_RANKS,
                                     scheme="repli", mode=mode,
                                     sync_period=DIST_PERIOD, epochs=epochs,
                                     classifier_epochs=0,
                                     cache_dir=cache_dir,
                                     dataset_kwargs={"scale": ARXIV_SCALE})
                one = run_training(cfg, device=dev, ds=ds)
                torch.cuda.synchronize()
                expect = exchange_collective_bytes(
                    one.gnn, one.bundle.halo, DIST_RANKS, "sync")["total"]
                check(step_total == expect,
                      f"phase 24 {mode}: a step's bytes {step_total}, "
                      f"exchange_collective_bytes {expect}")
                diff = np.abs(losses - one.losses)
                row.update(
                    loss_max_abs_err=float(diff.max()),
                    losses_bitwise=bool(np.array_equal(losses, one.losses)),
                    one_process_ms_per_epoch=1e3
                    * one.timings["train_epochs"] / epochs,
                    h_pad=int(one.bundle.halo.h_pad))
                check(bool(np.allclose(losses, one.losses,
                                       **DIST_LOSS_TOL)),
                      f"phase 24 {mode}: losses differ from the one-process "
                      f"run by {float(diff.max())}")
                if mode == "sync":
                    kernel_row = rank_backward_row(
                        dev, one.bundle.halo, one.batch.n_pad,
                        one.gnn.hidden_dim)
                    kernel_row["launches"] = row["launches_summed"][
                        "exchange_rank_backward"]
                del one
                torch.cuda.empty_cache()
            print(f"phase 24 {mode} [{smi}]: {json.dumps(row)}", flush=True)
            rows[mode] = row
        rc, wall, logs = torchrun(
            [os.path.join(ROOT, "chip_smoke.py"), "--sync-steps-rank", "run",
             *flags, "--mode", "sync"], os.path.join(tmp, "log-steps"), env)
        check(rc == 0, f"phase 24 repeat: torch.distributed.run exited {rc}")
        summ = rank_summaries(logs, "phase 24 repeat")
        step_total = rows["sync"]["step_bytes"]
        for r, s in summ.items():
            check(s["bitwise"], f"phase 24: rank {r}'s two sync steps from "
                                f"one state differ")
            check(s["step_bytes"] == [step_total] * 2,
                  f"phase 24 repeat: rank {r} counted {s['step_bytes']}")
        rows["sync_repeat"] = {
            "wall_s": wall, "bitwise": True,
            "step_s_max_rank": max(max(s["step_s"]) for s in summ.values()),
            "collective_s_per_step_max_rank": max(
                s["seconds"]["collective_s"] for s in summ.values()) / 2,
            "staging_s_per_step_max_rank": max(
                s["seconds"]["staging_s"] for s in summ.values()) / 2}
        print(f"phase 24 sync repeat [{smi}]: "
              f"{json.dumps(rows['sync_repeat'])}", flush=True)
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = own_cache
        autotune.clear_memory_cache()
    rows["phase_s"] = time.perf_counter() - t0
    print(f"phase 24: {rows['phase_s']:.1f} s wall (8 ranks sharing one "
          f"card through gloo, not a cluster of 8 cards) [{smi}]",
          flush=True)
    kernel = {"name": "csr_aggregate_rank_exchange_backward",
              "route": "cuda",
              "source": "src/repro_torch/csrc/csr_aggregate.cu",
              "replaces": "src/repro/kernels/csr_aggregate.py:148",
              **kernel_row}
    return rows, kernel


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import fused_layer as kernel_b
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import autotune as at
    from repro_torch.pipeline.pipeline import (PipelineConfig,
                                               PipelineReport, run_inference,
                                               run_training)
    from repro_torch.serving.inductive import aggregate_and_head

    # f32 products stay f32 (the reference's parity); the defaults, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in full precision (phases 9-10 compare the LM's
    # kernel path with its plain path; only attention may differ)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    # every phase reads and writes this run's own autotune cache: no user
    # cache on the machine reaches a phase, and phases 1-16 resolve the
    # fallback (kernel B at its 64-row tile, kernel A's shape rule)
    tune_dir = tempfile.TemporaryDirectory(prefix="chip_smoke-autotune-",
                                           dir=ROOT)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tune_dir.name, "autotune_cache.json")

    # -- 1. the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check(all(_build.library_path(n).exists() for n in _build.SOURCES),
          "a kernel library is missing after the build")
    hmma = tensor_core_instructions(_build.library_path("flash_decode"))
    print(f"  flash_decode: {hmma} HMMA (tensor-core) instructions in its "
          f"SASS (cuobjdump)")
    check(hmma is None or hmma > 0,
          "kernel D's library has no tensor-core instruction")

    # phases 3, 5 and 14 share one partition through the artifact cache
    main_cache = tempfile.TemporaryDirectory(prefix="chip_smoke-main-cache-",
                                             dir=ROOT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-", dir=ROOT) as tmp:
        # -- 3. the serving main path, seeded weights ---------------------
        cfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                             serving_dir=os.path.join(tmp, "seeded"),
                             cache_dir=main_cache.name,
                             dataset_kwargs={"scale": ARXIV_SCALE})
        ops.reset_launch_counts()
        result = run_inference(cfg, device=dev)
        row, batcher, workload, store = replay_trained_bundle(
            result, cfg, dev, "seeded")
        launches = ops.launch_counts()

        t = result.timings
        n, emb_dim = result.embeddings.shape
        seeded_acc = key_accuracy(result)
        print(f"main path: n={n} k={result.batch.k} "
              f"n_pad={result.batch.n_pad} e_pad={result.batch.e_pad} "
              f"E={emb_dim}")
        print("timings_s: " + " ".join(f"{k}={v:.3f}" for k, v in t.items()))
        print(f"partition_s={t['partition']:.3f} embed_s={t['embed']:.4f} "
              f"qps={row['throughput_qps']:.1f} p50_ms={row['p50_ms']:.3f} "
              f"p99_ms={row['p99_ms']:.3f} seeded_test_acc={seeded_acc:.4f}")
        print(f"launches: {json.dumps(launches)}")
        check((n, emb_dim) == (169343, 128), f"table shape {(n, emb_dim)}")
        check(bool(torch.isfinite(result.embeddings).all()),
              "non-finite embeddings")
        check(launches["fused_gcn_layer"] > 0
              and launches["csr_aggregate"] > 0,
              f"a kernel of the serving path never launched: {launches}")

        # -- 4. checks against the plain path -----------------------------
        unseen = [nb for node, nb in workload if node >= store.n][:64]
        nb_emb, nb_mask, pids = batcher.inductive.prepare(unseen, 64)
        pid_t = torch.as_tensor(pids, device=dev)
        head_w, head_b = store.head_w[pid_t], store.head_b[pid_t]
        agg, logits = aggregate_and_head(nb_emb, nb_mask, head_w, head_b)
        p_agg, p_logits = aggregate_and_head(nb_emb.cpu(), nb_mask.cpu(),
                                             head_w.cpu(), head_b.cpu())
        err = (logits.cpu() - p_logits).abs().max().item()
        print(f"inductive check: max abs logit err {err:.3e} "
              f"(tol 1e-5 + 1e-5*|ref|)")
        check(torch.allclose(logits.cpu(), p_logits, rtol=1e-5, atol=1e-5)
              and torch.allclose(agg.cpu(), p_agg, rtol=1e-5, atol=1e-5),
              f"inductive path disagrees with the plain path ({err})")
        small = PipelineConfig(dataset="karate", k=4, hidden_dim=16,
                               embed_dim=16, classifier_hidden=32)
        on_card = run_inference(small, device=dev)
        on_cpu = run_inference(small, device="cpu")
        err = (on_card.embeddings.cpu() - on_cpu.embeddings).abs().max()
        print(f"karate check: max abs table err {float(err):.3e} "
              f"(tol 1e-4 + 1e-4*|ref|), answer keys equal: "
              f"{bool((on_card.predictions == on_cpu.predictions).all())}")
        check(torch.allclose(on_card.embeddings.cpu(), on_cpu.embeddings,
                             rtol=1e-4, atol=1e-4)
              and (on_card.predictions == on_cpu.predictions).all(),
              "karate pipeline on the card disagrees with the CPU path")

        # -- 5. the training main path ------------------------------------
        tcfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                              serving_dir=os.path.join(tmp, "trained"),
                              cache_dir=main_cache.name,
                              dataset_kwargs={"scale": ARXIV_SCALE})
        ops.reset_launch_counts()
        trained = run_training(tcfg, device=dev, ds=result.dataset)
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()
        trow, _, _, _ = replay_trained_bundle(trained, tcfg, dev, "trained")
        tt = trained.timings
        acc = trained.accuracy
        print("train timings_s: " + " ".join(f"{k}={v:.3f}"
                                              for k, v in tt.items()))
        print(f"train: ms_per_epoch={1e3 * tt['train_epochs'] / tcfg.epochs:.2f}"
              f" (all {tcfg.k} partitions, {tcfg.epochs} epochs) "
              f"classifier_s={tt['classifier']:.3f} "
              f"accuracy train={acc['train']:.4f} val={acc['val']:.4f} "
              f"test={acc['test']:.4f} (seeded run: {seeded_acc:.4f}, "
              f"chance {1 / 40:.4f}); key test acc "
              f"{key_accuracy(trained):.4f}")
        print(f"train loss (mean over partitions): epoch 0 "
              f"{trained.losses[0].mean():.4f}, last "
              f"{trained.losses[-1].mean():.4f}")
        print(f"train launches: {json.dumps(train_launches)}; captured "
              f"graphs {json.dumps(trained.compiles)}")
        check(trained.compiles == {"local": 1},
              f"the stacked step was not one captured graph: "
              f"{trained.compiles}")
        check(train_launches["fused_gcn_layer_need_agg"] > 0
              and train_launches["csr_aggregate"] > 0,
              f"a kernel of the training path never launched: "
              f"{train_launches}")
        check(bool(np.isfinite(trained.losses).all())
              and bool(torch.isfinite(trained.embeddings).all()),
              "non-finite training loss or embeddings")
        resolved = PipelineReport.of(tcfg, trained).kernel
        print(f"train kernel configs: {json.dumps(resolved)}")
        check(resolved and all(v == at.FALLBACK.as_dict()
                               for v in resolved.values())
              and result.kernel == resolved,
              f"phases 3 and 5 do not resolve the fallback "
              f"{at.FALLBACK.as_dict()}: {resolved}, {result.kernel}")
        check(np.isfinite(acc["test"]) and acc["test"] > 1 / 40
              and acc["test"] > seeded_acc,
              f"trained test accuracy {acc['test']} does not beat chance "
              f"and the seeded run ({seeded_acc})")
        # phase 15 holds its traced run to this untraced one
        phase5 = {"table": trained.embeddings.cpu(),
                  "losses": trained.losses.copy(), "accuracy": dict(acc),
                  "ms_per_epoch": 1e3 * tt["train_epochs"] / tcfg.epochs}
        # local mode's row of phase 14's frontier
        local_row = {"exchange_epochs": 0,
                     "collectives_total": trained.collectives["total"],
                     "schedule_total": 0,
                     "per_epoch_avg": trained.collectives["per_epoch_avg"],
                     "schedule_per_epoch_avg": 0,
                     "live_exchange_mb_per_layer": 0.0,
                     "ms_per_epoch": 1e3 * tt["train_epochs"] / tcfg.epochs,
                     "accuracy": acc,
                     "loss_first": float(trained.losses[0].mean()),
                     "loss_last": float(trained.losses[-1].mean()),
                     "launches": {k: train_launches[k] for k in (
                         "fused_gcn_layer_need_agg", "csr_aggregate",
                         "exchange_backward")}}
        main_ds = result.dataset

    # -- 6. training on the card against the CPU path -------------------
    parity = train_on_card_vs_cpu(dev)

    # -- 7. gradients at the main path's largest partition ---------------
    edge_launches, p = gradients_against_plain(trained.tensors,
                                               trained.params, dev)

    # -- 8. kernels against their plain versions, timed ------------------
    kernels = []
    tens, params = trained.tensors, trained.params
    csr = tens.csrs[p]
    h = tens.features[p].contiguous()
    inv = ops.inv_degree(tens.in_degree[p])
    w0 = params["body"]["layers"][0]["w"][p]
    b0 = params["body"]["layers"][0]["b"][p]
    nn, f = h.shape
    fo, e = w0.shape[1], csr.src.shape[0]
    e_live = int((csr.weight > 0).sum())
    per_part = kernels_per_partition(tens, w0, b0, dev)
    errs = []
    for activate in (True, False):
        out, _ = kernel_b.launch(h, csr.src, csr.row_ptr, csr.weight, inv,
                                 w0, b0, activate=activate)
        ref = kernel_b.plain(h, csr.src, csr.dst, csr.weight, inv, w0, b0,
                             activate=activate)
        errs.append(max_err(out, ref))
    bound, by = layer_bound(nn, f, fo, e, e_live, need_agg=False)
    shape = {"N": nn, "F": f, "FO": fo, "E": e, "E_live": e_live,
             "partition": p}
    kernels.append({
        "name": "fused_gcn_layer", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:79",
        "launches": launches["fused_gcn_layer"],
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: kernel_b.launch(
            h, csr.src, csr.row_ptr, csr.weight, inv, w0, b0)),
        "plain_ms": time_ms(lambda: kernel_b.plain(
            h, csr.src, csr.dst, csr.weight, inv, w0, b0)),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": shape})

    # kernel B with need_agg (the training forward): agg against plain
    def plain_need_agg():
        a = plain.csr_aggregate_ref(h, csr.src, csr.dst, csr.weight, nn, inv)
        return plain.gcn_epilogue(a, w0, b0, True), a
    out, agg = kernel_b.launch(h, csr.src, csr.row_ptr, csr.weight, inv, w0,
                               b0, need_agg=True)
    agg_ref = plain.csr_aggregate_ref(h, csr.src, csr.dst, csr.weight, nn,
                                      inv)
    err = max(max_err(out, kernel_b.plain(h, csr.src, csr.dst, csr.weight,
                                          inv, w0, b0)),
              max_err(agg, agg_ref, plain.csr_aggregate_ref(
                  h.abs(), csr.src, csr.dst, csr.weight, nn, inv),
                  "fused layer agg"))
    bound, by = layer_bound(nn, f, fo, e, e_live, need_agg=True)
    # every partition launches kernels B and A equally often (3 and 2 per
    # epoch), so the launch-weighted mean is the mean over partitions
    heavy = max(per_part, key=lambda r: r["pad_arcs"])

    def spread(key):
        times = [r[f"{key}_ms"] for r in per_part]
        row = {"heavy_partition": {k: heavy[k] for k in (
                   "p", "pad_arcs", f"{key}_ms", f"{key}_err",
                   f"{key}_bound_ms")},
               "launch_weighted_mean_ms": statistics.mean(times),
               "per_partition_ms": times,
               "worst_over_best": max(times) / min(times)}
        return row
    kernels.append({
        "name": "fused_gcn_layer_need_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:79",
        "launches": train_launches["fused_gcn_layer_need_agg"],
        "max_abs_err": max([err] + [r["fused_err"] for r in per_part]),
        **spread("fused"),
        "ms": time_ms(lambda: kernel_b.launch(
            h, csr.src, csr.row_ptr, csr.weight, inv, w0, b0,
            need_agg=True)),
        "plain_ms": time_ms(plain_need_agg),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": shape})

    # kernel A over the reversed arcs (the backward's dh)
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((nn, f), generator=gen, device=dev)
    rev_w = (csr.weight * inv[csr.dst.long()])[csr.rev_perm].contiguous()
    rev_dst = csr.src[csr.rev_perm].contiguous()
    out = kernel_a.launch(g, csr.rev_src, csr.rev_row_ptr, rev_w)
    err = max_err(out, kernel_a.plain(g, csr.rev_src, rev_dst, rev_w, nn),
                  kernel_a.plain(g.abs(), csr.rev_src, rev_dst, rev_w, nn),
                  "transposed aggregation")
    rev_live = int((rev_w > 0).sum())
    sp = library_csr(rev_dst, csr.rev_src, rev_w, nn)
    check(torch.allclose(torch.sparse.mm(sp, g), out, rtol=1e-3, atol=1e-3),
          "torch.sparse.mm does not compute the transposed aggregation")
    bound, by = transpose_bound(nn, f, e, rev_live)
    kernels.append({
        "name": "csr_aggregate_transpose", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_aggregate.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:148",
        "launches": train_launches["csr_aggregate"],
        "max_abs_err": max([err] + [r["transpose_err"] for r in per_part]),
        **spread("transpose"),
        "ms": time_ms(lambda: kernel_a.launch(g, csr.rev_src,
                                              csr.rev_row_ptr, rev_w)),
        "plain_ms": time_ms(lambda: kernel_a.plain(g, csr.rev_src, rev_dst,
                                                   rev_w, nn)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: torch.sparse.mm(sp, g)),
        "shape": {**shape, "rev_row_max": int(
            (csr.rev_row_ptr[1:] - csr.rev_row_ptr[:-1]).max())}})

    # kernel C: the arc-weight gradient, at the largest partition and at
    # the one with the most padding arcs (one row of ~10^5 arcs)
    c_row = edge_dot_case(h, g, csr, inv, "largest partition")
    hp = heavy["p"]
    c_heavy = edge_dot_case(
        tens.features[hp].contiguous(),
        torch.randn((nn, f), generator=gen, device=dev), tens.csrs[hp],
        ops.inv_degree(tens.in_degree[hp]), "heavy partition")
    kernels.append({
        "name": "edge_dot", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_dot.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:190",
        "launches": train_launches["edge_dot"],
        "launches_arc_weight_backward_phase": edge_launches,
        **c_row, "max_abs_err": max(c_row["max_abs_err"],
                                    c_heavy["max_abs_err"]),
        "shape": {**c_row["shape"], "partition": p},
        "heavy_partition": {**c_heavy, "partition": hp}})

    # kernel A at the serving path's inductive buckets
    buckets = row["inductive_buckets"]
    times = {b: star_graph_case(batcher.inductive, unseen, b)
             for b in (1, 2, 4, 8, 16, 32, 64)}
    b = max(buckets, key=lambda k: (buckets[k], k)) if buckets else 64
    b = int(b)
    kernels.append({
        "name": "csr_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_aggregate.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:148",
        "launches": launches["csr_aggregate"],
        "max_abs_err": max(t["err"] for t in times.values()),
        "ms": times[b]["ms"], "plain_ms": times[b]["plain_ms"],
        "bound_ms": times[b]["bound_ms"], "bound_by": times[b]["bound_by"],
        "library_ms": times[b]["library_ms"],
        "shape": times[b]["shape"]})

    per_call = profile_training(trained, dev)
    for k in kernels:           # the rows of kernels A and B so far
        owner = "B" if k["name"].startswith("fused_gcn") else "A"
        if k["name"] != "edge_dot":
            k["device_launches_per_call"] = per_call[owner]
    del trained, result, batcher, store, on_card, tens, params, csr, h, \
        inv, w0, b0, g, gen, rev_w, rev_dst, sp, out, agg, agg_ref, ref, \
        nb_emb, nb_mask, pid_t, head_w, head_b, logits, p_agg, p_logits
    torch.cuda.empty_cache()

    # -- 9. the LM serving main path ---------------------------------------
    lm_params, lm_cfg, lm_report, d_launches, serve_err, lm_prof, \
        serving, lm_args = lm_serving(dev)

    # -- 10. long-cache decode ---------------------------------------------
    long_err, long_step_s = lm_long_cache(lm_params, lm_cfg, dev)
    del lm_params
    torch.cuda.empty_cache()

    # -- 11. kernel D against its plain version, timed ---------------------
    d_rows = kernel_d_against_plain(dev, serving)
    top = d_rows["serving"]         # where the serving run's launches are
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:26",
        "launches": d_launches,
        "max_abs_err": max(r["max_abs_err"] for r in d_rows.values()),
        "bitwise_repeatable": top["bitwise_repeatable"],
        "device_ms": top["device_ms"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "shapes": {k: v for k, v in d_rows.items() if k != "serving"},
        "lm_logits_err": {"serve_step": serve_err,
                          "long_cache_step": long_err},
        "lm_decode_profile": lm_prof,
        "lm_long_cache_step_ms": 1e3 * long_step_s,
        "lm_serve": {k: lm_report[k] for k in (
            "prefill_s", "decode_s", "decode_tok_per_s",
            "prefill_buckets")}})

    # -- 12. the partitioner comparison on the card ------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-cache-",
                                     dir=ROOT) as cache_dir:
        comparison, comparison_kernels = partitioner_comparison(dev,
                                                                cache_dir)
    for k in kernels:
        if k["name"] in ("fused_gcn_layer_need_agg",
                         "csr_aggregate_transpose"):
            k["comparison_partitions"] = comparison_kernels

    # -- 13. proteins-like on the card ---------------------------------------
    proteins = proteins_on_card(dev)

    # -- 14. the frontier: sync and stale(4) beside local ---------------------
    torch.cuda.empty_cache()
    frontier, exchange_kernel, halo_inputs = frontier_on_card(
        dev, main_ds, main_cache.name, local_row, seeded_acc)

    # -- 15. the traced main path, its checkpoint and profile -------------
    torch.cuda.empty_cache()
    traced = traced_main_path(dev, main_ds, main_cache.name, phase5)

    # -- 16. serving's command surface: replay, serve, client ---------------
    torch.cuda.empty_cache()
    surface, surface_kernel = serving_surface(dev, main_cache.name, phase5,
                                              round(per_call["A"]))

    # -- 17. the autotuner on the card ---------------------------------------
    torch.cuda.empty_cache()
    tuned, tuned_kernels = autotune_on_card(dev, main_ds, main_cache.name,
                                            phase5)

    # -- 18. compiled steps against the eager loop ---------------------------
    torch.cuda.empty_cache()
    compiled = compiled_against_eager(dev, main_ds, halo_inputs, lm_args,
                                      lm_report)
    tune_dir.cleanup()

    # -- 19. launch.train, both workloads ------------------------------------
    torch.cuda.empty_cache()
    training = launch_train_on_card(dev, smi)
    for k in kernels:
        if k["name"] in ("fused_gcn_layer_need_agg",
                         "csr_aggregate_transpose"):
            k["launches_phase19_gnn"] = training["gnn"]["launches"][
                "fused_gcn_layer_need_agg" if k["name"].startswith("fused")
                else "csr_aggregate"]

    # -- 20. the MoE family -------------------------------------------------
    torch.cuda.empty_cache()
    moe = moe_family(dev, smi)
    for k in kernels:
        if k["name"] == "flash_decode":
            k["shapes"]["moe_serving_g1"] = moe["kernel_d"]
            k["launches_phase20_moe"] = moe["serve"]["kernel_d_launches"]

    # -- 21. the SSM and hybrid families --------------------------------------
    torch.cuda.empty_cache()
    ssm = ssm_families(dev, smi)
    for k in kernels:
        if k["name"] == "flash_decode":
            k["shapes"]["zamba2_serving_d64_g1"] = ssm["kernel_d"]
            k["launches_phase21_zamba2"] = ssm["kernel_d"][
                "launches_zamba2_serve"]

    # -- 22. deepseek-v2 and expert placement -----------------------------
    torch.cuda.empty_cache()
    deepseek = deepseek_family(dev, smi)
    for k in kernels:
        if k["name"] == "flash_decode":
            k["launches_phase22_deepseek"] = deepseek["serve"][
                "kernel_d_launches"]

    # -- 23. the enc-dec and VLM families, kernel D at D 96 ----------------
    torch.cuda.empty_cache()
    frontends = frontend_families(dev, smi)
    for k in kernels:
        if k["name"] == "flash_decode":
            k["shapes"].update(frontends["kernel_d"])
            k["launches_phase23_seamless"] = frontends[ENCDEC_ARCH][
                "serve"]["kernel_d_launches"]
            k["launches_phase23_phi3v"] = frontends[VLM_ARCH]["serve"][
                "kernel_d_launches"]

    # -- 24. one process per partition: local, sync and stale(4) -------------
    torch.cuda.empty_cache()
    dist_rows, dist_kernel = distributed_on_card(dev, smi, main_ds,
                                                 main_cache.name, phase5)
    main_cache.cleanup()
    for k in kernels:
        if k["name"] in ("fused_gcn_layer_need_agg",
                         "csr_aggregate_transpose"):
            k["launches_phase24_local_ranks"] = dist_rows["local"][
                "launches_summed"]["fused_gcn_layer_need_agg"
                                   if k["name"].startswith("fused")
                                   else "csr_aggregate"]
    kernels.append(exchange_kernel)
    kernels.append(dist_kernel)
    kernels.append(surface_kernel)
    kernels.extend(tuned_kernels)
    print("summary: " + json.dumps({
        "phase6": {k: {f: v[f] for f in ("loss_ratio", "table_ratio",
                                         "table_ratio_full")}
                   for k, v in parity.items()},
        "comparison_test_acc": {m: r["accuracy"]["test"]
                                for m, r in comparison.items()},
        "proteins_test_auc": {m: r["auc"]["test"]
                              for m, r in proteins.items()},
        "frontier": {m: {"test_acc": r["accuracy"]["test"],
                         "bytes_per_epoch": r["per_epoch_avg"],
                         "ms_per_epoch": r["ms_per_epoch"]}
                     for m, r in frontier.items()},
        "phase15": traced,
        "phase16": {k: v for k, v in surface.items()
                    if k in ("serve", "turns", "phase_s")},
        "phase17": {k: v for k, v in tuned.items() if k in (
            "winner", "winner_ms", "fallback_ms", "candidates", "tune_s",
            "stage_s", "ms_per_epoch", "phase5_ms_per_epoch", "accuracy",
            "phase5_accuracy", "replay", "sweep", "phase_s")},
        "phase18": compiled,
        "phase19": {k: v for k, v in training.items() if k != "full"},
        "phase19_full": {k: v for k, v in training["full"].items()
                         if k != "losses"},
        "phase20": {k: v for k, v in moe.items() if k != "kernel_d"},
        "phase21": {k: v for k, v in ssm.items() if k != "kernel_d"},
        "phase22": deepseek,
        "phase23": {k: v for k, v in frontends.items() if k != "kernel_d"},
        "phase24": dist_rows}))

    print(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sync-steps-rank"]:
        sys.exit(sync_steps_rank(sys.argv[2:]))
    sys.exit(main())
